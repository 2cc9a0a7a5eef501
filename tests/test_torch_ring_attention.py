"""Ring attention (``bluefog_tpu_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention`` under ``shard_map``, on the
same numpy inputs: forward, causal and not, GQA 4/2, ``impl="xla"`` (the
online-softmax merge) and ``impl="flash"`` (JAX: the Pallas kernels in
interpret mode; the port: the kernels' plain versions on CPU tensors);
the gradients of both; and the causal ring at sp = 4, whose 6 wholly
masked (shard, block) pairs the port skips while JAX computes every
pair.

The port takes the shards stacked shard-major ([S, B, T/S, H, D]) over a
``SeqAxis``.  Tolerance: 1e-4 forward, 2e-4 gradients (the JAX package's
own ``tests/test_ring_attention.py:52,169``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.parallel import ring_attention as jra
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.parallel import ring_attention as tra

TOL = dict(rtol=1e-4, atol=1e-4)
GTOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, b, t, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32))


def _shards(x, n, grad=False):
    """[B, T, ...] numpy -> the port's [n, B, T/n, ...] shards."""
    b, t = x.shape[:2]
    y = torch.from_numpy(x).reshape(b, n, t // n, *x.shape[2:])
    y = y.movedim(1, 0).contiguous()
    return y.requires_grad_(True) if grad else y


def _whole(x):
    """The port's [n, B, T/n, ...] -> [B, T, ...] numpy."""
    n, b, t = x.shape[:3]
    return x.detach().movedim(0, 1).reshape(b, n * t, *x.shape[3:]).numpy()


def _jax_sharded(fn, n, n_in=3, n_out=1):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp")
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=spec if n_out == 1 else (spec,) * n_out,
        check_vma=False))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,hkv", [(True, 2), (False, 4)])
def test_ring_forward_matches_jax(impl, causal, hkv):
    n = 4
    q, k, v = _qkv(1, 2, 8 * n, 4, hkv, 16)
    want = _jax_sharded(lambda q, k, v: jra.ring_attention(
        q, k, v, "sp", causal=causal, impl=impl), n)(q, k, v)
    with bt.bind_axis(bt.SeqAxis("sp", n)):
        got = tra.ring_attention(_shards(q, n), _shards(k, n),
                                 _shards(v, n), "sp", causal=causal,
                                 impl=impl)
    assert got.shape == (n, 2, 8, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(_whole(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_gradients_match_jax(impl):
    """d(sum(out * g))/d(q, k, v) of the causal GQA ring: JAX's autodiff
    through ppermute (xla) or its ring-level custom VJP (flash), against
    the port's autograd through the axis's shift (xla) or its
    ``autograd.Function`` around the whole ring (flash)."""
    n, b, t, h, hkv, d = 4, 2, 32, 4, 2, 16
    q, k, v = _qkv(0, b, t, h, hkv, d)
    g = np.random.RandomState(9).randn(b, t, h, d).astype(np.float32)

    def shard_grads(q, k, v, g):
        # the per-shard loss: reverse mode routes the cross-shard dK/dV
        # cotangents through the ppermute transposes
        return jax.grad(lambda q, k, v: jnp.sum(jra.ring_attention(
            q, k, v, "sp", causal=True, impl=impl) * g),
            argnums=(0, 1, 2))(q, k, v)

    want = _jax_sharded(shard_grads, n, n_in=4, n_out=3)(q, k, v, g)
    tq, tk, tv = (_shards(x, n, grad=True) for x in (q, k, v))
    out = tra.ring_attention(tq, tk, tv, bt.SeqAxis("sp", n), impl=impl)
    loss = (out * _shards(g, n)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_whole(a), np.asarray(w), **GTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,live", [(True, 10), (False, 16)])
def test_ring_skips_wholly_masked_pairs(monkeypatch, causal, live):
    """At sp = 4 the causal ring runs K2, K3a and K3b on the 10 live
    (shard, block) pairs of 16 (the other 6 blocks come from later
    shards); JAX's ring computes all 16, and the results agree; the
    non-causal ring runs all 16.  Every block's offsets are the global
    ones of its shard."""
    n = 4
    calls = {"fwd": [], "dq": [], "dkv": []}

    def spy(key, fn):
        def wrapped(*a):
            calls[key].append(a[-2:])
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tra, "flash_forward",
                        spy("fwd", tra.flash_forward))
    monkeypatch.setattr(tra, "flash_backward_dq",
                        spy("dq", tra.flash_backward_dq))
    monkeypatch.setattr(tra, "flash_backward_dkv",
                        spy("dkv", tra.flash_backward_dkv))
    q, k, v = _qkv(3, 1, 16 * n, 4, 2, 16)
    want = _jax_sharded(lambda q, k, v: jra.ring_attention(
        q, k, v, "sp", causal=causal, impl="flash"), n)(q, k, v)
    tq, tk, tv = (_shards(x, n, grad=True) for x in (q, k, v))
    out = tra.ring_attention(tq, tk, tv, bt.SeqAxis("sp", n),
                             causal=causal, impl="flash")
    np.testing.assert_allclose(_whole(out), np.asarray(want), **TOL)
    out.sum().backward()
    assert [len(c) for c in calls.values()] == [live] * 3
    pairs = sorted(set(calls["fwd"]))
    assert len(pairs) == live and sorted(calls["dq"]) == sorted(
        calls["fwd"]) == sorted(calls["dkv"])
    for q_off, kv_off in pairs:
        assert q_off % 16 == 0 and kv_off % 16 == 0
        assert tra.ring_live(causal, q_off, kv_off, 16)


def test_ring_needs_a_bound_axis():
    """A name no ``bind_axis`` holds raises, as ``lax.axis_index`` outside
    ``shard_map``; a shard count other than the axis size is refused."""
    q, k, v = (_shards(x, 2) for x in _qkv(4, 1, 8, 2, 2, 16))
    with pytest.raises(NameError, match="unbound axis name"):
        tra.ring_attention(q, k, v, "sp")
    with pytest.raises(ValueError, match="shards"):
        tra.ring_attention(q, k, v, bt.SeqAxis("sp", 4))
    ax = bt.SeqAxis("sp", 2)
    with bt.bind_axis(ax):
        with bt.bind_axis(bt.SeqAxis("sp", 4)):
            pass
        assert tra.ring_attention(q, k, v, "sp").shape == q.shape
    with pytest.raises(NameError):
        tra.ring_attention(q, k, v, "sp")


def test_seq_axis_collectives_are_jax_collectives():
    """``SeqAxis.shift`` is ``lax.ppermute`` over the ring and
    ``all_to_all`` is ``lax.all_to_all(tiled=True)``, on the same data."""
    n = 4
    x = np.random.RandomState(5).randn(2, 4 * n, 8, 3).astype(np.float32)
    shift = _jax_sharded(lambda x: jax.lax.ppermute(
        x, "sp", [(i, (i + 1) % n) for i in range(n)]), n, n_in=1)(x)
    to_heads = jax.jit(jax.shard_map(
        lambda x: jax.lax.all_to_all(x, "sp", 2, 1, tiled=True),
        mesh=Mesh(np.array(jax.devices()[:n]), ("sp",)),
        in_specs=P(None, "sp"), out_specs=P(None, None, "sp"),
        check_vma=False))(x)
    ax = bt.SeqAxis("sp", n)
    np.testing.assert_array_equal(_whole(ax.shift(_shards(x, n))),
                                  np.asarray(shift))
    got = ax.all_to_all(_shards(x, n), 2, 1)      # [n, 2, 16, 2, 3]
    np.testing.assert_array_equal(
        got.movedim(0, 2).reshape(2, 4 * n, 8, 3).numpy(),
        np.asarray(to_heads))
    back = ax.all_to_all(got, 1, 2)
    assert torch.equal(back, _shards(x, n))
    np.testing.assert_array_equal(ax.index().numpy(), np.arange(n))


def test_ring_parts_match_autograd_and_reject_a_planted_pair():
    """``ring_flash_parts`` is the autograd ring's forward and backward
    outside autograd (here the kernels' plain versions on CPU tensors,
    or ``PLAIN_KERNELS``), bit for bit; ``flash_check.drop_pair`` leaves
    exactly one pair out: at offsets no pair has it changes no bit, and
    the ring without pair (3, 0) (``flash_check.ring_planted_fault``) is
    rejected by ``flash_check.mismatch`` in each of out, dQ, dK and dV,
    and leaves the other shards' rows as they were."""
    from bluefog_tpu_torch.parallel import flash_check

    n, t = 4, 16
    q, k, v = (_shards(x, n) for x in _qkv(6, 1, n * t, 4, 2, 16))
    do = _shards(_qkv(7, 1, n * t, 4, 2, 16)[0], n)
    axis = bt.SeqAxis("sp", n)
    parts = tra.ring_flash_parts(q, k, v, do, axis)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tra.ring_attention(*leaves, axis, impl="flash")
    grads = torch.autograd.grad(out, leaves, do)
    assert torch.equal(out, parts["out"])
    for g, key in zip(grads, ("dq", "dk", "dv")):
        assert torch.equal(g, parts[key]), key
    want = tra.ring_flash_parts(q, k, v, do, axis,
                                kernels=tra.PLAIN_KERNELS)
    same = tra.ring_flash_parts(
        q, k, v, do, axis,
        kernels=flash_check.drop_pair(tra.PLAIN_KERNELS, n * t, 0))
    for key in want:
        assert torch.equal(parts[key], want[key]), key
        assert torch.equal(same[key], want[key]), key
    bad = flash_check.ring_planted_fault(q, k, v, do, axis)
    for key in ("out", "dq", "dk", "dv"):
        assert flash_check.mismatch(bad[key], want[key]) > 1, key
    # shards 0-2 never meet block 0 from shard 3's side: their rows hold
    for key in ("out", "dq", "lse"):
        assert torch.equal(bad[key][:3], want[key][:3]), key
