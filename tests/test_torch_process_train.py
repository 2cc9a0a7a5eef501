"""``build_train_step`` over a ``ProcessBackend``: the tiny f32 Bottleneck
ResNet of ``tests/test_torch_train_step.py`` (``pallas_conv1x1=True``,
train-mode batch norm, SGD(0.1, momentum 0.9)) trained 3 steps by a bfrun
job of 2 processes x 2 ranks (gloo on the CPU), under atc, bucketed cta,
the hierarchical exchange (a machine per process), push-sum and the skip
guard (rank 2's images hold a NaN); then the eager ATC, CTA,
gradient-allreduce, win-put and push-sum wrappers over the job's
context.  Params, batch statistics, losses and
skip flags must equal ``StackedBackend(4)``'s bit for bit, and match the
JAX package's ``build_train_step`` on a 4-device mesh within
``test_torch_train_step.py``'s tolerance (5e-4 of each leaf's largest
entry plus 5e-7, losses 1e-5: the f32 convolutions sum in another
order)."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import topology as JT
from bluefog_tpu.models import resnet as JR
from bluefog_tpu.optim import functional as JF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, HW, STEPS = 4, 2, 16, 3

MODES = {
    "atc": ("atc", {"topology": "exp2"}),
    "cta_bucketed": ("cta", {"topology": "exp2", "overlap": "bucketed",
                             "overlap_buckets": 3}),
    "hierarchical": ("atc", {"topology": "machines",
                             "hierarchical_local_size": 2}),
    "push_sum": ("push_sum", {"topology": "exp2"}),
    "guard": ("atc", {"topology": "exp2", "guard": True}),
}

# Run by each process of the job and, in the test process, over
# StackedBackend(4): ``run(backend, setup)`` -> {mode: results of this
# process's ranks}.
RUN = r'''
import numpy as np
import torch
import torch.nn.functional as F

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import resnet_params_from_flax
from bluefog_tpu_torch.models import resnet as TR


def _kw(kw):
    out = dict(kw)
    if out.get("topology") == "exp2":
        out["topology"] = TT.uniform_topology_spec(TT.ExponentialTwoGraph(4))
    if out.get("topology") == "machines":
        out["topology"] = TT.uniform_topology_spec(TT.ExponentialTwoGraph(2))
    if out.pop("guard", False):
        out["guard"] = bt.GuardConfig()
    return out


def run(backend, setup, modes):
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    tm = bt.ResNet(stage_sizes=(1,), block_cls=TR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=torch.float32,
                   pallas_conv1x1=True, device="cpu")
    results = {}
    for mode, (comm_mode, kw) in modes.items():
        kw = _kw(kw)
        p0, a0 = resnet_params_from_flax(setup["v"], tm, device="cpu")
        params = bt.rank_major(p0, backend)
        aux = bt.rank_major(a0, backend)
        opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

        def loss_fn(p, a, batch):
            images, labels = batch
            logits, new = tm.apply(p, a, images, train=True)
            return F.cross_entropy(logits, labels), new

        step = bt.build_train_step(loss_fn, opt, backend,
                                   comm_mode=comm_mode, has_aux=True, **kw)
        opt_state = (opt if comm_mode != "push_sum"
                     else (opt, bt.push_sum_weights(backend)))
        x = setup["x_nan"] if "guard" in kw else setup["x"]
        batch = (torch.from_numpy(x[lo:hi]),
                 torch.from_numpy(setup["y"][lo:hi]).long())
        losses, skipped = [], []
        for s in range(3):
            args = (params, aux, opt_state, batch, s)
            if "guard" in kw:
                args = args + (step.default_comm_weights,)
            out = step(*args)
            params, aux, opt_state, loss = out[:4]
            assert loss.shape == (hi - lo,)
            losses.append(loss.numpy().copy())
            if "guard" in kw:
                skipped.append(out[4].numpy().copy())
        res = {f"param.{k}": v.detach().numpy().copy()
               for k, v in params.items()}
        res.update({f"stat.{k}": v.numpy().copy() for k, v in aux.items()})
        res["loss"] = np.stack(losses, axis=1)
        if skipped:
            res["skipped"] = np.stack(skipped, axis=1)
        if comm_mode == "push_sum":
            res["ps"] = opt_state[1].numpy().copy()
        results[mode] = res
    return results


WRAPPERS = ("DistributedAdaptThenCombineOptimizer",
            "DistributedAdaptWithCombineOptimizer",
            "DistributedGradientAllreduceOptimizer",
            "DistributedWinPutOptimizer", "DistributedPushSumOptimizer")


def run_wrappers():
    """The eager wrappers, 2 steps each on a tanh MLP whose ranks start
    apart and are made equal by broadcast_parameters from rank 3, over
    the initialized context (its ranks: this process's rows)."""
    from bluefog_tpu_torch.context import get_context

    ctx = get_context()
    ranks = ctx.backend.ranks
    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 5, 3).astype(np.float32)
    xs = rng.randn(2, 4, 6, 5).astype(np.float32)
    ys = rng.randn(2, 4, 6, 3).astype(np.float32)
    out = {}
    for name in WRAPPERS:
        params = {"w": bt.from_rank_values(list(w0)).clone(),
                  "b": bt.from_rank_values(
                      [np.full(3, float(r), np.float32)
                       for r in range(4)]).clone()}
        bt.broadcast_parameters(params, root_rank=3)
        base = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
        bt.broadcast_optimizer_state(base, root_rank=3)
        opt = getattr(bt, name)(base, params)
        for s in range(2):
            for i, r in enumerate(ranks):
                p = {k: v[i].detach().requires_grad_(True)
                     for k, v in params.items()}
                x = torch.from_numpy(xs[s, r])
                loss = ((torch.tanh(x @ p["w"]) + p["b"]
                         - torch.from_numpy(ys[s, r])) ** 2).mean()
                gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
                if params["w"].grad is None:
                    params["w"].grad = torch.zeros_like(params["w"])
                    params["b"].grad = torch.zeros_like(params["b"])
                params["w"].grad[i] = gw
                params["b"].grad[i] = gb
            opt.step()
        out[name] = {k: v.detach().numpy().copy() for k, v in params.items()}
        if hasattr(opt, "unregister_windows"):
            opt.unregister_windows()
    return out
'''

WORKER = RUN + r'''

if __name__ == "__main__":
    import pickle
    import sys

    from bluefog_tpu_torch.context import get_context

    bt.init()
    backend = get_context().backend
    assert type(backend).__name__ == "ProcessBackend"
    assert backend.n_local == 2 and backend.size == 4
    with open(sys.argv[1], "rb") as f:
        setup, modes = pickle.load(f)
    got = run(backend, setup, modes)
    got["wrappers"] = run_wrappers()
    with open(f"{sys.argv[2]}/p{backend.process_index}.pkl", "wb") as f:
        pickle.dump(got, f)
    bt.shutdown()
    print("train OK")
'''


def _setup():
    jm = JR.ResNet(stage_sizes=(1,), block_cls=JR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=jnp.float32,
                   pallas_conv1x1=True)
    rng = np.random.RandomState(0)
    x = rng.randn(N, B, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, 10, (N, B)).astype(np.int32)
    v = jax.tree.map(np.asarray,
                     jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    x_nan = x.copy()
    x_nan[2, 0, 0, 0, 0] = np.nan
    return jm, dict(x=x, y=y, x_nan=x_nan, v=v)


def _run_jax(jm, setup, comm_mode, kw):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    kw = dict(kw)
    if kw.get("topology") == "exp2":
        kw["topology"] = JT.uniform_topology_spec(JT.ExponentialTwoGraph(N))
    if kw.get("topology") == "machines":
        kw["topology"] = JT.uniform_topology_spec(JT.ExponentialTwoGraph(2))
    guarded = kw.pop("guard", False)
    if guarded:
        kw["guard"] = JF.GuardConfig()

    def loss_fn(params, aux, batch):
        images, labels = batch
        logits, upd = jm.apply({"params": params, "batch_stats": aux},
                               images, train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.mean(ce), upd["batch_stats"]

    opt = optax.sgd(0.1, momentum=0.9)
    step = JF.build_train_step(loss_fn, opt, mesh, comm_mode=comm_mode,
                               has_aux=True, donate=False, **kw)
    v = setup["v"]
    params = JF.rank_major(v["params"], mesh)
    aux = JF.rank_major(v["batch_stats"], mesh)
    opt_state = JF.rank_major(opt.init(v["params"]), mesh)
    if comm_mode == "push_sum":
        opt_state = (opt_state, JF.push_sum_weights(mesh))
    sh = NamedSharding(mesh, P("bf"))
    x = setup["x_nan"] if guarded else setup["x"]
    batch = (jax.device_put(jnp.asarray(x), sh),
             jax.device_put(jnp.asarray(setup["y"]), sh))
    losses, skipped = [], []
    for s in range(STEPS):
        args = (params, aux, opt_state, batch, jnp.int32(s))
        if guarded:
            args = args + (step.default_comm_weights,)
        out = step(*args)
        params, aux, opt_state, loss = out[:4]
        losses.append(np.asarray(loss))
        if guarded:
            skipped.append(np.asarray(out[4]))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, aux),
            np.stack(losses, axis=1),
            np.stack(skipped, axis=1) if guarded else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bfrun job (every mode), StackedBackend(4) and JAX."""
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    jm, setup = _setup()
    d = tmp_path_factory.mktemp("process_train")
    with open(d / "setup.pkl", "wb") as f:
        pickle.dump((setup, MODES), f)
    (d / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--force-cpu-devices", "2", "--coordinator",
         f"file://{d / 'store'}", sys.executable, str(d / "worker.py"),
         str(d / "setup.pkl"), str(d)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("train OK") == 2, out.stdout
    parts = []
    for p in range(2):
        with open(d / f"p{p}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    process = {mode: {k: np.concatenate([p[mode][k] for p in parts])
                      for k in parts[0][mode]} for mode in MODES}
    process["wrappers"] = {
        w: {k: np.concatenate([p["wrappers"][w][k] for p in parts])
            for k in parts[0]["wrappers"][w]} for w in parts[0]["wrappers"]}
    ns: dict = {}
    exec(RUN, ns)
    stacked = ns["run"](StackedBackend(N, device="cpu"), setup, MODES)
    import bluefog_tpu_torch as bt
    bt.init(size=N, device="cpu")
    try:
        stacked["wrappers"] = ns["run_wrappers"]()
    finally:
        bt.shutdown()
    return jm, setup, process, stacked


WRAPPER_NAMES = ("DistributedAdaptThenCombineOptimizer",
                 "DistributedAdaptWithCombineOptimizer",
                 "DistributedGradientAllreduceOptimizer",
                 "DistributedWinPutOptimizer", "DistributedPushSumOptimizer")


@pytest.mark.parametrize("wrapper", WRAPPER_NAMES)
def test_eager_wrappers_across_processes_bit_equal_stacked(runs, wrapper):
    """The eager wrappers (with broadcast_parameters and
    broadcast_optimizer_state from rank 3, which process 1 holds) per
    process give the stacked context's bits."""
    _, _, process, stacked = runs
    got, want = process["wrappers"][wrapper], stacked["wrappers"][wrapper]
    for k in want:
        assert np.array_equal(got[k], want[k]), (
            f"{wrapper} {k}: max |diff| {np.abs(got[k] - want[k]).max()}")
    assert sorted(stacked["wrappers"]) == sorted(WRAPPER_NAMES)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_process_job_bit_equals_stacked(runs, mode):
    _, _, process, stacked = runs
    got, want = process[mode], stacked[mode]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), (
            f"{mode} {k}: max |diff| {np.nanmax(np.abs(got[k] - want[k]))}")
    if mode == "guard":   # rank 2's NaN images: it skips every step
        np.testing.assert_array_equal(got["skipped"][:, 0], [0, 0, 1, 0])
    if mode == "push_sum":
        assert abs(float(got["ps"].sum()) - N) < 1e-5


@pytest.mark.parametrize("mode", sorted(MODES))
def test_process_job_matches_jax(runs, mode):
    from bluefog_tpu_torch.interop import resnet_params_from_flax
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models import resnet as TR

    jm, setup, process, _ = runs
    comm_mode, kw = MODES[mode]
    jp, ja, jl, js = _run_jax(jm, setup, comm_mode, kw)
    got = process[mode]
    np.testing.assert_allclose(got["loss"], jl, rtol=0, atol=1e-5)
    if js is not None:
        np.testing.assert_array_equal(got["skipped"], js)
    tm = bt.ResNet(stage_sizes=(1,), block_cls=TR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=torch.float32,
                   pallas_conv1x1=True, device="cpu")
    for r in range(N):
        pick = lambda t: jax.tree.map(lambda a: a[r], t)  # noqa: E731
        wp, wa = resnet_params_from_flax(
            {"params": pick(jp), "batch_stats": pick(ja)}, tm, device="cpu")
        for prefix, want in (("param", wp), ("stat", wa)):
            for k, w in want.items():
                w = w.numpy()
                scale = max(float(np.abs(w).max()), 1e-6)
                np.testing.assert_allclose(
                    got[f"{prefix}.{k}"][r], w, rtol=0,
                    atol=5e-4 * scale + 5e-7,
                    err_msg=f"{mode} rank {r} {prefix} {k}")
