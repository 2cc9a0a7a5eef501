"""Ulysses attention (``bluefog_tpu_torch/parallel/ulysses.py``) against
the JAX package's ``ulysses_attention`` under ``shard_map``, on the same
numpy inputs: forward, causal and not, GQA 4/2, ``impl="xla"``
(``full_attention``) and ``impl="flash"`` (JAX: the Pallas kernel in
interpret mode; the port: the kernels' plain versions on CPU tensors);
the gradients of both; the refusal of heads the axis does not divide;
and the wire pattern (all-to-alls only, no ring hop).

The port takes the shards stacked shard-major over a ``SeqAxis``.
Tolerance: 1e-4 forward, 2e-4 gradients (the JAX package's
``tests/test_ring_attention.py:52,169``; its Ulysses tests hold 1e-5
and 1e-4, which the xla impl meets too)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.parallel import ulysses as jul
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.parallel import ulysses as tul

N = 2   # the tiny Llama's 2 kv heads cap Ulysses at 2 shards
TOL = dict(rtol=1e-4, atol=1e-4)
GTOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, b, t, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32))


def _shards(x, n, grad=False):
    b, t = x.shape[:2]
    y = torch.from_numpy(x).reshape(b, n, t // n, *x.shape[2:])
    y = y.movedim(1, 0).contiguous()
    return y.requires_grad_(True) if grad else y


def _whole(x):
    n, b, t = x.shape[:3]
    return x.detach().movedim(0, 1).reshape(b, n * t, *x.shape[3:]).numpy()


def _jax_sharded(fn, n=N, n_in=3, n_out=1):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp")
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=spec if n_out == 1 else (spec,) * n_out,
        check_vma=False))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,hkv", [(True, 2), (False, 4)])
def test_ulysses_forward_matches_jax(impl, causal, hkv):
    q, k, v = _qkv(1, 2, 16 * N, 4, hkv, 16)
    want = _jax_sharded(lambda q, k, v: jul.ulysses_attention(
        q, k, v, "sp", causal=causal, impl=impl))(q, k, v)
    with bt.bind_axis(bt.SeqAxis("sp", N)):
        got = tul.ulysses_attention(_shards(q, N), _shards(k, N),
                                    _shards(v, N), "sp", causal=causal,
                                    impl=impl)
    assert got.shape == (N, 2, 16, 4, 16)
    np.testing.assert_allclose(_whole(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ulysses_gradients_match_jax(impl):
    """d(sum(out * g))/d(q, k, v), causal GQA: JAX's autodiff through the
    all-to-all transposes (and the Pallas VJP under flash) against the
    port's autograd through ``SeqAxis.all_to_all``."""
    b, t, h, hkv, d = 1, 8 * N, 4, 2, 16
    q, k, v = _qkv(2, b, t, h, hkv, d)
    g = np.random.RandomState(8).randn(b, t, h, d).astype(np.float32)

    def shard_grads(q, k, v, g):
        return jax.grad(lambda q, k, v: jnp.sum(jul.ulysses_attention(
            q, k, v, "sp", causal=True, impl=impl) * g),
            argnums=(0, 1, 2))(q, k, v)

    want = _jax_sharded(shard_grads, n_in=4, n_out=3)(q, k, v, g)
    tq, tk, tv = (_shards(x, N, grad=True) for x in (q, k, v))
    out = tul.ulysses_attention(tq, tk, tv, bt.SeqAxis("sp", N), impl=impl)
    got = torch.autograd.grad((out * _shards(g, N)).sum(), (tq, tk, tv))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_whole(a), np.asarray(w), **GTOL,
                                   err_msg=f"d{name}")


def test_ulysses_rejects_indivisible_heads():
    q, k, v = (_shards(x, N) for x in _qkv(3, 1, 8 * N, 3, 3, 8))
    with pytest.raises(ValueError, match="divide"):
        tul.ulysses_attention(q, k, v, bt.SeqAxis("sp", N))
    q, k, v = (_shards(x, 4) for x in _qkv(3, 1, 16, 4, 2, 8))
    with pytest.raises(ValueError, match=r"n_kv_heads \(2\)"):
        tul.ulysses_attention(q, k, v, bt.SeqAxis("sp", 4))


def test_ulysses_wire_is_all_to_all_only(monkeypatch):
    """The wire pattern is the point (``tests/test_ulysses.py:85-95``):
    four all-to-alls a call (q, k and v in, out back), no ring hop, and
    under flash one attention call for every shard (the head groups
    folded into the batch)."""
    from bluefog_tpu_torch.parallel import collectives as C

    seen = []
    for name in ("all_to_all", "shift", "permute"):
        fn = getattr(C.SeqAxis, name)
        monkeypatch.setattr(C.SeqAxis, name, lambda self, *a, _n=name,
                            _f=fn: seen.append(_n) or _f(self, *a))
    flash = []
    monkeypatch.setattr(tul, "flash_attention", lambda q, *a, _f=(
        tul.flash_attention), **kw: flash.append(q.shape) or _f(q, *a, **kw))
    q, k, v = (_shards(x, N) for x in _qkv(4, 2, 8 * N, 4, 2, 8))
    tul.ulysses_attention(q, k, v, bt.SeqAxis("sp", N), impl="flash")
    assert seen == ["all_to_all"] * 4
    assert flash == [(N * 2, 8 * N, 4 // N, 8)]
