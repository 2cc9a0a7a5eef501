"""The port's pipeline schedules (``bluefog_tpu_torch/parallel/
pipeline.py``) against the JAX package's (``bluefog_tpu/parallel/
pipeline.py``) on a trivial stage function, the same numpy-seeded
inputs:

* ``gpipe`` (4 stages, 3 microbatches) and ``gpipe_circular`` (2 stages
  x 2 loops over 4 microbatches, a FIFO of depth 2; 2 stages x 3 loops
  over 2 microbatches, no FIFO), with and without ``with_aux``: the last
  stage's outputs, each stage's aux sum over its valid ticks, and the
  gradients of a scalar of both with respect to every stage's params and
  the microbatches (the backward pipeline: the reversed hops), against
  JAX's under ``shard_map`` on a ("pp",) CPU mesh;
* ``circular_layer_permutation`` equal to JAX's, and its errors;
* the circular schedule's ``n_micro < n_stages`` error, and an axis of
  the wrong size.

Tolerance: 1e-5 (f32; ``tanh`` chains of at most 6 stages)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.parallel import pipeline as jpipe
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.parallel import pipeline as tpipe

D, BM = 8, 2
# (schedule, stages, microbatches, loops)
CASES = {"gpipe": ("gpipe", 4, 3, 1),
         "circular_fifo": ("circular", 2, 4, 2),
         "circular_no_fifo": ("circular", 2, 2, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n_stages, n_micro, n_loops):
    rng = np.random.RandomState(n_stages * 10 + n_micro)
    lead = (n_stages,) if n_loops == 1 else (n_stages, n_loops)
    w = rng.uniform(0.5, 1.5, lead + (D,)).astype(np.float32)
    b = rng.normal(size=lead + (D,)).astype(np.float32)
    x = rng.normal(size=(n_micro, BM, D)).astype(np.float32)
    c = rng.normal(size=(n_micro, BM, D)).astype(np.float32)
    return {"w": w, "b": b}, x, c


def _jax_stage(p, x, with_aux):
    y = jnp.tanh(x * p["w"] + p["b"])
    return (y, jnp.sum(y * y)) if with_aux else y


_REF = {}


def _ref(case):
    """JAX's outputs, aux and gradients for both ``with_aux`` settings,
    one program per case, shared by the module's tests."""
    if case in _REF:
        return _REF[case]
    kind, n_stages, n_micro, n_loops = CASES[case]
    params, x, c = _inputs(n_stages, n_micro, n_loops)
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("pp",))

    def objective(with_aux, params, x):
        def shard(p, x):
            p = jax.tree.map(lambda a: a[0], p)
            stage_fn = functools.partial(_jax_stage, with_aux=with_aux)
            if kind == "gpipe":
                got = jpipe.gpipe(stage_fn, p, x, "pp", n_stages,
                                  with_aux=with_aux)
            else:
                got = jpipe.gpipe_circular(stage_fn, p, x, "pp", n_stages,
                                           n_loops, with_aux=with_aux)
            out, aux = got if with_aux else (got, jnp.float32(0))
            last = jax.lax.axis_index("pp") == n_stages - 1
            obj = jnp.where(last, jnp.sum(out * c), 0.0) + aux
            return jax.lax.psum(obj, "pp"), out[None], aux[None]

        obj, outs, aux = jax.shard_map(
            shard, mesh=mesh, in_specs=(P("pp"), P()),
            out_specs=(P(), P("pp"), P("pp")), check_vma=False)(params, x)
        return obj, (outs[-1], aux)

    out = {}
    for with_aux in (False, True):
        (_, (last, aux)), grads = jax.jit(jax.value_and_grad(
            functools.partial(objective, with_aux), argnums=(0, 1),
            has_aux=True))(params, x)
        out[with_aux] = dict(out=np.asarray(last), aux=np.asarray(aux),
                             grads=jax.tree.map(np.asarray, grads))
    _REF[case] = (params, x, c, out)
    return _REF[case]


def _port_stage(p, x, with_aux):
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (D,)
    y = torch.tanh(x * p["w"].reshape(shape) + p["b"].reshape(shape))
    return (y, (y * y).flatten(1).sum(1)) if with_aux else y


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedules_equal_jax(case, with_aux):
    """The last stage's outputs, each stage's valid-tick aux and the
    gradients through the reversed hops equal JAX's."""
    kind, n_stages, n_micro, n_loops = CASES[case]
    params, x, c, ref = _ref(case)
    ref = ref[with_aux]
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    stage_fn = functools.partial(_port_stage, with_aux=with_aux)
    with bt.bind_axis(bt.MeshAxis("pp", n_stages)):
        if kind == "gpipe":
            got = tpipe.gpipe(stage_fn, p, xt, "pp", n_stages,
                              with_aux=with_aux)
        else:
            got = tpipe.gpipe_circular(stage_fn, p, xt, "pp", n_stages,
                                       n_loops, with_aux=with_aux)
    out, aux = got if with_aux else (got, torch.zeros(n_stages))
    obj = (out * torch.from_numpy(c)).sum() + aux.sum()
    grads = torch.autograd.grad(obj, [p["w"], p["b"], xt])
    np.testing.assert_allclose(out.detach().numpy(), ref["out"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.detach().numpy(), ref["aux"],
                               rtol=1e-5, atol=1e-5)
    want = (ref["grads"][0]["w"], ref["grads"][0]["b"], ref["grads"][1])
    for what, g, w in zip(("w", "b", "x"), grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=what)


def test_circular_layer_permutation_equals_jax():
    for n_layers, n_stages, n_loops in ((4, 2, 2), (8, 2, 2), (12, 3, 2),
                                        (8, 4, 1), (6, 1, 3)):
        np.testing.assert_array_equal(
            tpipe.circular_layer_permutation(n_layers, n_stages, n_loops),
            jpipe.circular_layer_permutation(n_layers, n_stages, n_loops))
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError, match="divide"):
            mod.circular_layer_permutation(6, 4, 1)


def test_circular_requires_enough_microbatches_and_the_axis():
    """JAX's ``n_micro < n_stages`` error; an axis of another size than
    ``n_stages`` and an unbound name are refused."""
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="n_micro"):
        tpipe.gpipe_circular(lambda p, v: v, {"w": torch.zeros(4, 2, 1)},
                             x, "pp", 4, 2)
    with pytest.raises(NameError, match="unbound axis name"):
        tpipe.gpipe(lambda p, v: v, {"w": torch.zeros(2, 1)}, x, "pp", 2)
    with bt.bind_axis(bt.MeshAxis("pp", 3)):
        with pytest.raises(ValueError, match="n_stages=2"):
            tpipe.gpipe(lambda p, v: v, {"w": torch.zeros(2, 1)}, x,
                        "pp", 2)
