"""The port's window ops (``bluefog_tpu_torch.windows`` through the flat
API) against the JAX package's, test for test as ``tests/test_win_ops.py``
and the single-process parts of ``tests/test_async_gossip.py``: the same
seeded numpy inputs through ``bluefog_tpu`` (8 virtual CPU devices) and
the port (``bf.init(size=8, device="cpu")``); mailboxes, versions,
associated p (sum of p == size), ``win_update_then_collect``.

Tolerance: 1e-6 of the largest entry (both sides scale and combine
window payloads in float32, as the JAX kernels do); versions exact; p
within 1e-12 of the JAX value.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import api as japi
from bluefog_tpu import topology as JT
from bluefog_tpu_torch import api as tapi
from bluefog_tpu_torch import topology as TT

SIZE = 8
SIDES = ((jbf, JT, japi), (tbf, TT, tapi))


@pytest.fixture
def both():
    jbf.init()
    tbf.init(size=SIZE, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=1e-6):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _run(fn):
    return [fn(bf, T, api) for bf, T, api in SIDES]


def rank_tensor(bf, shape, seed=None, dtype=np.float64):
    if seed is None:
        return bf.from_rank_values(lambda r: np.full(shape, r, dtype=dtype))
    vals = np.random.default_rng(seed).normal(size=(SIZE,) + shape)
    return bf.from_rank_values(list(vals.astype(dtype)))


def _win(api, name):
    return api._wm().window(name)


# ------------------------------------------------------------------ #
# lifecycle
# ------------------------------------------------------------------ #
def test_win_create_free(both):
    def fn(bf, T, api):
        x = rank_tensor(bf, (4,))
        out = [bf.win_create(x, "w_life"), bf.win_create(x, "w_life"),
               bf.get_current_created_window_names(), bf.win_free("w_life"),
               bf.win_free("w_life"), bf.get_current_created_window_names()]
        return out
    want, got = _run(fn)
    assert got == want == [True, False, ["w_life"], True, False, []]


def test_win_free_all(both):
    def fn(bf, T, api):
        x = rank_tensor(bf, (2,))
        bf.win_create(x, "w_a")
        bf.win_create(x, "w_b")
        return bf.win_free(), bf.get_current_created_window_names()
    want, got = _run(fn)
    assert got == want == (True, [])


# ------------------------------------------------------------------ #
# win_update semantics
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("zero_init", [False, True])
def test_win_update_initial(both, zero_init):
    """Buffers init to the creator's value (or zeros), so the first update
    without puts averages self with the initial neighbor values."""
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        bf.win_create(rank_tensor(bf, (3,), seed=1), "w_upd",
                      zero_init=zero_init)
        mb = _np(_win(api, "w_upd").mailbox).copy()
        return bf.win_update("w_upd"), mb
    (want, wmb), (got, gmb) = _run(fn)
    _close(got, want)
    np.testing.assert_array_equal(gmb, wmb)


def test_win_put_then_update(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (4,), seed=2)
        bf.win_create(x, "w_put", zero_init=True)
        assert bf.win_put(x, "w_put")
        return bf.win_update("w_put")
    want, got = _run(fn)
    _close(got, want)


def test_win_put_partial_destinations(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,), seed=3)
        bf.win_create(x, "w_part", zero_init=True)
        assert bf.win_put(x, "w_part",
                          dst_weights=[{(r + 1) % SIZE: 2.0}
                                       for r in range(SIZE)])
        return bf.win_update("w_part", self_weight=0.5,
                             neighbor_weights=[{(r - 1) % SIZE: 0.5}
                                               for r in range(SIZE)])
    want, got = _run(fn)
    _close(got, want)


@pytest.mark.parametrize("fence", [False, True])
def test_win_put_self_weight_scales_local(both, fence):
    """win_put's self_weight multiplies the local window tensor; after a
    fence the scaled value is observable."""
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,), seed=4)
        bf.win_create(x, "w_selfw", zero_init=True)
        bf.win_put(x, "w_selfw", self_weight=0.5)
        if fence:
            bf.win_fence("w_selfw")
        return _win(api, "w_selfw").value
    want, got = _run(fn)
    _close(got, want)


def test_win_accumulate(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,), seed=5)
        bf.win_create(x, "w_acc", zero_init=True)
        assert bf.win_accumulate(x, "w_acc")
        assert bf.win_accumulate(x, "w_acc")
        mb = _np(_win(api, "w_acc").mailbox).copy()
        out = bf.win_update("w_acc", self_weight=1.0, neighbor_weights=[
            {(r - 1) % SIZE: 1.0, (r + 1) % SIZE: 1.0} for r in range(SIZE)])
        return out, mb
    (want, wmb), (got, gmb) = _run(fn)
    _close(got, want)
    _close(gmb, wmb)


def test_win_get(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,), seed=6)
        bf.win_create(x, "w_get", zero_init=True)
        assert bf.win_get("w_get", src_weights=[
            {(r - 1) % SIZE: 0.5, (r + 1) % SIZE: 0.25}
            for r in range(SIZE)])
        mb = _np(_win(api, "w_get").mailbox).copy()
        return bf.win_update("w_get"), mb
    (want, wmb), (got, gmb) = _run(fn)
    _close(got, want)
    _close(gmb, wmb)


def test_win_update_then_collect(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,), seed=7)
        bf.win_create(x, "w_col", zero_init=True)
        bf.win_put(x, "w_col")
        out = _np(bf.win_update_then_collect("w_col")).copy()
        out2 = bf.win_update_then_collect("w_col")
        return out, out2, _np(_win(api, "w_col").mailbox).copy()
    (w1, w2, wmb), (g1, g2, gmb) = _run(fn)
    _close(g1, w1)
    _close(g2, w2)
    _close(g2, g1)  # buffers were reset: the second collect is self only
    assert not gmb.any() and not wmb.any()


def test_win_versions(both):
    def fn(bf, T, api):
        bf.set_topology(T.RingGraph(SIZE))
        x = rank_tensor(bf, (2,))
        bf.win_create(x, "w_ver", zero_init=True)
        seen = [bf.get_win_version("w_ver", rank=0)]
        bf.win_put(x, "w_ver")
        seen.append(bf.get_win_version("w_ver", rank=0))
        bf.win_put(x, "w_ver")
        bf.win_get("w_ver")
        seen.append(bf.get_win_version("w_ver", rank=3))
        bf.win_update("w_ver")
        seen.append(bf.get_win_version("w_ver", rank=0))
        seen.append(_np(_win(api, "w_ver").versions).tolist())
        return seen
    want, got = _run(fn)
    assert got == want
    assert got[:2] == [{1: 0, 7: 0}, {1: 1, 7: 1}] and got[2] == {2: 3, 4: 3}


def test_win_mutex_and_lock_contexts(both):
    for bf, T, api in SIDES:
        bf.win_create(rank_tensor(bf, (2,)), "w_mutex")
        with bf.win_mutex("w_mutex"):
            bf.win_update("w_mutex")
        with bf.win_lock("w_mutex"):
            pass
        bf.win_unlock("w_mutex")
        bf.win_fence("w_mutex")
        bf.win_free("w_mutex")


def test_win_nonblocking_handles(both):
    for bf, T, api in SIDES:
        x = rank_tensor(bf, (2,))
        bf.win_create(x, "w_nb", zero_init=True)
        h = bf.win_put_nonblocking(x, "w_nb")
        assert bf.win_poll(h) in (True, False)
        assert bf.win_wait(h)
        assert not bf.win_wait(h)  # already cleared
        bf.win_free("w_nb")


# ------------------------------------------------------------------ #
# associated-P (push-sum) invariant
# ------------------------------------------------------------------ #
def _push_sum_rounds(bf, T, name, x0, rounds):
    bf.set_topology(T.ExponentialTwoGraph(SIZE))
    bf.turn_on_win_ops_with_associated_p()
    try:
        bf.win_create(x0, name, zero_init=True)
        graph = bf.load_topology()
        out_nbrs = {r: sorted(d for d in graph.successors(r) if d != r)
                    for r in range(SIZE)}
        alpha = {r: 1.0 / (len(out_nbrs[r]) + 1) for r in range(SIZE)}
        value = x0
        ps_sums = []
        for _ in range(rounds):
            bf.win_accumulate(value, name, self_weight=[alpha[r] for r in
                                                        range(SIZE)],
                              dst_weights=[{d: alpha[r] for d in out_nbrs[r]}
                                           for r in range(SIZE)])
            value = bf.win_update_then_collect(name)
            ps_sums.append(sum(bf.win_associated_p(name, rank=r)
                               for r in range(SIZE)))
        ps = np.array([bf.win_associated_p(name, rank=r)
                       for r in range(SIZE)])
        return _np(value), ps, ps_sums
    finally:
        bf.turn_off_win_ops_with_associated_p()


def test_associated_p_sum_invariant(both):
    (wv, wp, wsums), (gv, gp, gsums) = _run(lambda bf, T, api: _push_sum_rounds(
        bf, T, "w_ps", rank_tensor(bf, (4,), seed=8), 5))
    np.testing.assert_allclose(gsums, SIZE, rtol=1e-10)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-12)
    _close(gv, wv)


def test_push_sum_converges_to_average(both):
    x0 = np.array([[float(r), 2.0 * r] for r in range(SIZE)])
    (wv, wp, _), (gv, gp, _) = _run(lambda bf, T, api: _push_sum_rounds(
        bf, T, "w_psavg", bf.rank_sharded(x0), 60))
    debiased = gv / gp[:, None]
    np.testing.assert_allclose(debiased, np.tile(x0.mean(0), (SIZE, 1)),
                               rtol=1e-6)
    _close(debiased, wv / wp[:, None])


def test_varying_gossip_weights_do_not_recompile(both):
    """New put/update weights every step: one cached entry per op kind on
    both sides, and the same values."""
    from bluefog_tpu.context import get_context as jctx
    from bluefog_tpu_torch.context import get_context as tctx

    def fn(bf, T, api, ctx):
        bf.set_topology(T.ExponentialTwoGraph(SIZE))
        x = rank_tensor(bf, (3,), seed=9)
        bf.win_create(x, "w_retrace")
        graph = bf.load_topology()
        out_nbrs = {r: sorted(d for d in graph.successors(r) if d != r)
                    for r in range(SIZE)}
        in_nbrs = {r: sorted(s for s in graph.predecessors(r) if s != r)
                   for r in range(SIZE)}
        sizes, outs = [], []
        for step in range(6):
            scale = 1.0 / (2.0 + step)
            self_w = [1.0 - scale * len(out_nbrs[r]) for r in range(SIZE)]
            bf.win_put(x, "w_retrace", self_weight=self_w,
                       dst_weights=[{d: scale for d in out_nbrs[r]}
                                    for r in range(SIZE)])
            x = bf.win_update("w_retrace", self_weight=self_w,
                              neighbor_weights=[{s: scale for s in in_nbrs[r]}
                                                for r in range(SIZE)])
            outs.append(_np(x).copy())
            sizes.append(len(ctx()._op_cache))
        assert sizes[-1] == sizes[0], sizes
        return np.stack(outs)
    want = fn(jbf, JT, japi, jctx)
    got = fn(tbf, TT, tapi, tctx)
    _close(got, want)


def test_put_weight_variation_changes_values_not_programs(both):
    for bf, T, api in SIDES:
        bf.set_topology(T.RingGraph(SIZE))
        x = bf.from_rank_values(lambda r: np.full((2,), float(r)))
        bf.win_create(x, "w_wval")
        for w in (0.5, 0.25):
            bf.win_put(x, "w_wval", self_weight=1.0,
                       dst_weights=[{(r + 1) % SIZE: w} for r in range(SIZE)])
            win = _win(api, "w_wval")
            mb = _np(win.mailbox)
            for r in range(SIZE):
                src = (r - 1) % SIZE
                np.testing.assert_allclose(
                    mb[r, win.in_lists[r].index(src)], w * src, rtol=1e-6)
        bf.win_free("w_wval")


# ------------------------------------------------------------------ #
# single-process parts of tests/test_async_gossip.py
# ------------------------------------------------------------------ #
def test_dispatch_ahead_gossip_converges(both):
    """Puts and updates enqueued back to back with no wait (dispatch
    ahead); the final read sees the lockstep result, the exact mean on
    both sides (the exp2 one-peer sweep)."""
    def fn(bf, T, api):
        bf.set_topology(T.ExponentialTwoGraph(SIZE))
        x = rank_tensor(bf, (64,))
        bf.win_create(x, "g")
        for i in range(24):
            s = 2 ** (i % 3)
            bf.win_put_nonblocking(
                x, "g", dst_weights=[[(r + s) % SIZE] for r in range(SIZE)])
            x = bf.win_update("g", self_weight=0.5, neighbor_weights=[
                {(r - s) % SIZE: 0.5} for r in range(SIZE)])
        return _np(x)
    want, got = _run(fn)
    np.testing.assert_allclose(got, (SIZE - 1) / 2, atol=1e-5)
    _close(got, want)


def test_uneven_local_cadence(both):
    """Ranks run different numbers of local steps between exchanges
    (rank-dependent local work, one collective exchange); the exchanged
    state still contracts to consensus, identically on both sides."""
    def fn(bf, T, api):
        k_local = np.array([2 if r % 2 == 0 else 1 for r in range(SIZE)])
        local = np.array([10.0 * (r + 1) for r in range(SIZE)])
        for _ in range(10):
            for r in range(SIZE):
                for _ in range(k_local[r]):
                    local[r] = local[r] * 0.9 + 1.0
            x = bf.neighbor_allreduce(bf.rank_sharded(
                np.repeat(local[:, None], 4, axis=1)))
            local = _np(x)[:, 0].copy()
        return local
    want, got = _run(fn)
    assert np.ptp(got) < 1.0
    _close(got, want, tol=1e-12)
