"""The port's TensorFlow adapter (``bluefog_tpu_torch.interop.tf_adapter``)
against the JAX package's (``bluefog_tpu.interop.tf_adapter``): JAX's
15 tests of ``tests/test_tf_interop.py``, each putting the same seeded
inputs through both adapters (JAX's after ``bluefog_tpu.init()``, the
port's after ``bluefog_tpu_torch.init(size=8, device="cpu")``).  Outputs
and gradients agree within 1e-6 of the largest entry in f32 and 1e-12 in
f64; each test also keeps JAX's own assertion on the port's result.
They cover eager and graph mode, both optimizer modes, the tape and
``minimize``, and the compiled Keras fit (the same loss curve)."""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import bluefog_tpu as jbf  # noqa: E402
import bluefog_tpu_torch as tbf  # noqa: E402
from bluefog_tpu.interop import tf_adapter as J  # noqa: E402
from bluefog_tpu_torch.interop import tf_adapter as T  # noqa: E402

N = 8
TOL = {tf.float32: 1e-6, tf.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # TF's pools are sized once, before its first op in this process
        tf.config.threading.set_intra_op_parallelism_threads(1)
        tf.config.threading.set_inter_op_parallelism_threads(1)
    except RuntimeError:
        pass
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ctx():
    """Both packages' contexts over 8 ranks (the port's on the CPU)."""
    jbf.init()
    tbf.init(size=N, device="cpu")
    yield
    tbf.shutdown()
    jbf.shutdown()


def _agree(port, ref, dtype=tf.float32):
    """``port`` within TOL[dtype] of ``ref``'s largest entry."""
    p = port.numpy() if tf.is_tensor(port) else np.asarray(port)
    r = ref.numpy() if tf.is_tensor(ref) else np.asarray(ref)
    assert p.shape == r.shape and p.dtype == r.dtype
    scale = max(float(np.abs(r).max()), 1.0) if r.size else 1.0
    np.testing.assert_allclose(p, r, rtol=0, atol=TOL[dtype] * scale)


def test_tf_torch_and_jax_import_together():
    import jax

    assert tf.__version__ and torch.__version__ and jax.__version__
    assert T.tf is tf


def test_allreduce(ctx):
    x = tf.reshape(tf.range(N * 3, dtype=tf.float32), (N, 3))
    out = T.allreduce(x, average=True)
    assert tf.is_tensor(out)
    _agree(out, J.allreduce(x, average=True))
    expected = x.numpy().mean(axis=0)
    for r in range(N):
        np.testing.assert_allclose(out[r].numpy(), expected, rtol=1e-6)


def test_broadcast(ctx):
    x = tf.reshape(tf.range(N * 2, dtype=tf.float64), (N, 2))
    out = T.broadcast(x, root_rank=2)
    _agree(out, J.broadcast(x, root_rank=2), tf.float64)
    for r in range(N):
        np.testing.assert_array_equal(out[r].numpy(), x[2].numpy())


def test_allgather(ctx):
    x = tf.reshape(tf.range(N * 2, dtype=tf.float32), (N, 1, 2))
    out = T.allgather(x)
    assert out.shape == (N, N, 2)
    _agree(out, J.allgather(x))
    for r in range(N):
        np.testing.assert_array_equal(out[r].numpy(),
                                      x.numpy().reshape(N, 2))


def test_neighbor_allreduce_consensus(ctx):
    x = tf.constant([[float(r)] * 4 for r in range(N)])
    xj = x
    for _ in range(30):
        x = T.neighbor_allreduce(x)
        xj = J.neighbor_allreduce(xj)
        _agree(x, xj)
    np.testing.assert_allclose(x.numpy(), (N - 1) / 2, atol=1e-6)


def _allreduce_grad(adapter):
    x = tf.Variable(np.arange(N * 2, dtype=np.float32).reshape(N, 2))
    with tf.GradientTape() as tape:
        y = adapter.allreduce(x, average=True)
        loss = tf.reduce_sum(y * y)
    return x, tape.gradient(loss, x)


def test_allreduce_gradient_registered(ctx):
    x, g = _allreduce_grad(T)
    _agree(g, _allreduce_grad(J)[1])
    expected = 2.0 * np.tile(x.numpy().mean(axis=0), (N, 1))
    np.testing.assert_allclose(g.numpy(), expected, rtol=1e-5)


def _allgather_grad(adapter):
    x = tf.Variable(np.ones((N, 2), np.float32))
    with tf.GradientTape() as tape:
        y = adapter.allgather(x)
        loss = tf.reduce_sum(y)
    return tape.gradient(loss, x)


def test_allgather_gradient(ctx):
    g = _allgather_grad(T)
    _agree(g, _allgather_grad(J))
    np.testing.assert_allclose(g.numpy(), float(N))


def _broadcast_vars(adapter):
    p = tf.Variable(np.arange(N * 2, dtype=np.float32).reshape(N, 2))
    q = tf.Variable(np.ones((N, 3), np.float32)
                    * np.arange(N, dtype=np.float32)[:, None])
    adapter.broadcast_variables([p, q], root_rank=1)
    return p, q


def test_broadcast_variables_in_place(ctx):
    p, q = _broadcast_vars(T)
    pj, qj = _broadcast_vars(J)
    _agree(p.value(), pj.value())
    _agree(q.value(), qj.value())
    for r in range(N):
        np.testing.assert_array_equal(p[r].numpy(), [2.0, 3.0])
        np.testing.assert_array_equal(q[r].numpy(), [1.0, 1.0, 1.0])


def test_type_error_float64_without_x64_is_ok_in_tests(ctx):
    # JAX's gate needs jax_enable_x64 (on in the test env); torch keeps
    # f64 with no gate, and both sum the same
    import jax

    assert jax.config.jax_enable_x64
    x = tf.ones((N, 2), tf.float64)
    out = T.allreduce(x, average=False)
    assert out.dtype == tf.float64
    _agree(out, J.allreduce(x, average=False), tf.float64)
    np.testing.assert_allclose(out.numpy(), float(N))


def _train(adapter, communication):
    rng = np.random.RandomState(0)
    target = rng.randn(4).astype(np.float32)
    A = tf.constant(rng.randn(N, 16, 4).astype(np.float32))
    b = tf.einsum("rsd,d->rs", A, tf.constant(target))
    w = tf.Variable(np.zeros((N, 4), np.float32))
    opt = adapter.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.05),
        communication=communication)
    for _ in range(150):
        with tf.GradientTape() as tape:
            pred = tf.einsum("rsd,rd->rs", A, w)
            loss = tf.reduce_sum(
                tf.reduce_mean(tf.square(pred - b), axis=1))
        grads = tape.gradient(loss, [w])
        opt.apply_gradients(zip(grads, [w]))
    return target, w.numpy()


@pytest.mark.parametrize("communication",
                         ["allreduce", "neighbor_allreduce"])
def test_distributed_optimizer_trains_tf_model(ctx, communication):
    target, final = _train(T, communication)
    _agree(final, _train(J, communication)[1])
    assert np.abs(final - target).max() < 0.1
    assert np.abs(final - final.mean(axis=0)).max() < 1e-2


def _tape(adapter):
    x = tf.Variable(np.arange(N * 2, dtype=np.float32).reshape(N, 2))
    with adapter.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_sum(x * x, axis=1)
    return x, tape.gradient(loss, [x])[0]


def test_distributed_gradient_tape(ctx):
    x, g = _tape(T)
    _agree(g, _tape(J)[1])
    expected = np.tile((2.0 * x.numpy()).mean(axis=0), (N, 1))
    np.testing.assert_allclose(g.numpy(), expected, rtol=1e-5)


def _minimize(adapter):
    w = tf.Variable(np.arange(N * 2, dtype=np.float32).reshape(N, 2))
    opt = adapter.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=1.0))
    c = tf.constant(np.arange(N, dtype=np.float32)[:, None] + 1.0)
    before = w.numpy().copy()
    opt.minimize(lambda: tf.reduce_sum(w * c), [w])
    return c, before - w.numpy()


def test_distributed_optimizer_minimize_communicates(ctx):
    c, delta = _minimize(T)
    _agree(delta, _minimize(J)[1])
    expected = np.tile(c.numpy().mean(axis=0), (N, 2))
    np.testing.assert_allclose(delta, expected, rtol=1e-6)


def _graph_allreduce(adapter):
    @tf.function
    def traced(x):
        with tf.GradientTape() as tape:
            tape.watch(x)
            y = adapter.allreduce(x, average=True)
            loss = tf.reduce_sum(y * y)
        return y, tape.gradient(loss, x)

    x = tf.reshape(tf.range(N * 3, dtype=tf.float32), (N, 3))
    return (x,) + tuple(traced(x))


def test_graph_mode_allreduce_and_gradient(ctx):
    x, y, g = _graph_allreduce(T)
    _, yj, gj = _graph_allreduce(J)
    _agree(y, yj)
    _agree(g, gj)
    expected = np.tile(x.numpy().mean(axis=0), (N, 1))
    np.testing.assert_allclose(y.numpy(), expected, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), 2 * expected, rtol=1e-6)


def _graph_ops(adapter, x):
    @tf.function
    def traced(t):
        return (adapter.broadcast(t, 1), adapter.allgather(t),
                adapter.neighbor_allreduce(t))

    return traced(x)


def test_graph_mode_ops_match_eager(ctx):
    from bluefog_tpu.topology import ExponentialTwoGraph as JExp2
    from bluefog_tpu_torch.topology import ExponentialTwoGraph as TExp2

    jbf.set_topology(JExp2(N))
    tbf.set_topology(TExp2(N))
    x = tf.reshape(tf.range(N * 2, dtype=tf.float32), (N, 2))
    b_g, ag_g, na_g = _graph_ops(T, x)
    for got, want in zip((b_g, ag_g, na_g), _graph_ops(J, x)):
        _agree(got, want)
    assert ag_g.shape == (N, N * 2)
    np.testing.assert_allclose(b_g.numpy(), T.broadcast(x, 1).numpy())
    np.testing.assert_allclose(ag_g.numpy(), T.allgather(x).numpy())
    np.testing.assert_allclose(na_g.numpy(),
                               T.neighbor_allreduce(x).numpy(), rtol=1e-6)


class _LossCurve(tf.keras.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, batch, logs=None):
        self.losses.append(float(logs["loss"]))


def _keras_fit(adapter):
    rng = np.random.RandomState(0)
    target = rng.randn(4).astype(np.float32)
    A = rng.randn(N, 16, 4).astype(np.float32)
    b = np.einsum("rsd,d->rs", A, target)
    opt = adapter.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.05))

    class RankModel(tf.keras.Model):
        def __init__(self):
            super().__init__()
            self.w = self.add_weight(shape=(N, 4), initializer="zeros",
                                     trainable=True, name="w")
            self.trace_eagerness = []

        def call(self, a):
            return tf.einsum("bnsd,nd->bns", a, self.w)

        def train_step(self, data):
            # python side effects run at trace time: False here proves
            # the step compiled
            self.trace_eagerness.append(tf.executing_eagerly())
            a, y = data
            with tf.GradientTape() as tape:
                pred = self(a)
                loss = tf.reduce_sum(
                    tf.reduce_mean(tf.square(pred - y), axis=(0, 2)))
            grads = tape.gradient(loss, self.trainable_variables)
            opt.apply(grads, self.trainable_variables)
            return {"loss": loss}

    model = RankModel()
    model.compile()
    assert not model.run_eagerly
    curve = _LossCurve()
    # JAX's 150 epochs of one batch as one epoch of the batch 150 times:
    # the same 150 SGD steps without Keras's per-epoch overhead
    model.fit(np.repeat(A[None], 150, 0), np.repeat(b[None], 150, 0),
              batch_size=1, epochs=1, shuffle=False, verbose=0,
              callbacks=[curve])
    assert len(curve.losses) == 150
    return target, model, np.asarray(curve.losses, np.float32)


def test_compiled_keras_fit_converges(ctx):
    target, model, losses = _keras_fit(T)
    _, jmodel, jlosses = _keras_fit(J)
    _agree(losses, jlosses)
    _agree(model.w.numpy(), jmodel.w.numpy())
    assert model.trace_eagerness and not any(model.trace_eagerness)
    final = model.w.numpy()
    assert np.abs(final - target).max() < 0.1
    assert np.abs(final - final.mean(axis=0)).max() < 1e-2


def test_distributed_optimizer_rejects_unknown_mode(ctx):
    for adapter in (T, J):
        with pytest.raises(ValueError, match="communication"):
            adapter.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                         communication="gossip")
