"""The port's bucket planner (bluefog_tpu_torch/optim/fusion.py), its
error-feedback top-k mixing (``parallel/collectives.py``:
``mix_compress_exchange``, ``mix_wire_bytes``, ``mix_mirror_slots``;
``compressor.py``: the top-k kernel) and the stochastic-rounding int8
wire, against the JAX package on a 4-device CPU mesh.

Inputs come from numpy seeds.  The top-k inputs are drawn without exact
ties between nonzero magnitudes: ``lax.top_k`` breaks ties by the lowest
index and ``torch.topk`` promises no order (ROADMAP.md Queue 3).
Tolerances: 1e-5 relative plus 1e-6 absolute for f32 results; wire
bytes, plans, masks and counts exactly.  The int8_sr wire draws other
bits than JAX's generator, so it is held to its contract instead:
unbiased over draws, every code within 1 of round-to-nearest's, the same
draw for the same (step, bucket), and a consensus floor below the
round-to-nearest wire's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import compressor as JCmp
from bluefog_tpu import topology as JT
from bluefog_tpu.models import resnet as JR
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.optim import fusion as JFu
from bluefog_tpu.parallel import collectives as JC
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import compressor as TCmp
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import fusion as TFu
from bluefog_tpu_torch.parallel import collectives as TC

N = 4
RTOL, ATOL = 1e-5, 1e-6


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("bf",))


@pytest.fixture(scope="module")
def resnet50_leaves():
    """ResNet-50's param leaves, JAX's (shapes from ``eval_shape``) and
    the port's (its params sorted into the JAX tree's order by name)."""
    shp = jax.eval_shape(JR.ResNet50(num_classes=1000).init,
                         jax.random.PRNGKey(0),
                         jnp.zeros((1, 224, 224, 3), jnp.float32))
    flat = jax.tree_util.tree_flatten_with_path(shp["params"])[0]
    jnames = [".".join(k.key for k in path) for path, _ in flat]
    params, _ = bt.ResNet50(num_classes=1000, device="cpu").state()
    tnames = sorted(params, key=lambda k: k.split("."))
    assert tnames == jnames
    return [leaf for _, leaf in flat], [params[k] for k in tnames]


@pytest.mark.parametrize("n_buckets", [1, 2, 4, 8, 64])
def test_resnet50_bucket_plan_matches_jax(resnet50_leaves, n_buckets):
    """plan_groups over ResNet-50's leaf list: the port's bucket
    boundaries (and the EpiloguePlan's buckets, bytes and dtypes) are the
    JAX planner's."""
    jl, tl = resnet50_leaves
    rows_j, rows_t = JFu.bucket_signature(jl), TFu.bucket_signature(tl)
    assert rows_t == rows_j
    thr = TFu.size_balanced_threshold(rows_t, n_buckets)
    assert thr == JFu.size_balanced_threshold(rows_j, n_buckets)
    assert TFu.plan_groups(rows_t, thr) == JFu.plan_groups(rows_j, thr)
    jp = JFu.EpiloguePlan.for_leaves(jl, n_buckets, compress="int8",
                                     guard=True)
    tp = TFu.EpiloguePlan.for_leaves(tl, n_buckets, compress="int8",
                                     guard=True)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)


def test_rank_major_plan_and_fusion_plan_match_jax(resnet50_leaves):
    """The rank-major plan (per-rank bytes of [n, ...] leaves, the train
    step's) equals JAX's per-shard plan, and FusionPlan groups, packs and
    unpacks as the JAX one does."""
    jl, tl = resnet50_leaves
    stacked = [t.unsqueeze(0).expand((2,) + tuple(t.shape)) for t in tl]
    tp = TFu.EpiloguePlan.for_leaves(stacked, 4, skip_leading_axis=True)
    assert dataclasses.astuple(tp) == dataclasses.astuple(
        JFu.EpiloguePlan.for_leaves(jl, 4))
    rng = np.random.RandomState(0)
    mixed = [rng.randn(N, *s).astype(d) for s, d in
             (((3, 2), np.float32), ((5,), np.float32), ((4,), np.float64),
              ((2, 2), np.float32), ((7,), np.float32))]
    jf = JFu.FusionPlan.for_leaves([jnp.asarray(a) for a in mixed], 48)
    tf = TFu.FusionPlan.for_leaves([torch.from_numpy(a) for a in mixed], 48)
    assert tf.groups == jf.groups == [[0, 1], [2], [3, 4]]
    packed_t = tf.pack([torch.from_numpy(a) for a in mixed])
    packed_j = jf.pack([jnp.asarray(a) for a in mixed])
    for a, b in zip(packed_t, packed_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tf.unpack(packed_t), mixed):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("kw", [
    {}, {"compress": "int8"}, {"guard": True, "health": True},
    {"health": True, "consensus": True, "mix": True},
    {"compress": "bf16", "guard": True, "mix": True}])
def test_epilogue_stages_match_jax(kw):
    assert TFu.epilogue_stages(**kw) == JFu.epilogue_stages(**kw)


@pytest.mark.parametrize("numel,k,values", [
    (1000, 250, "int8"), (1001, 1, "int8_sr"), (17, 17, "none"),
    (8, 2, "none")])
def test_mix_wire_bytes_matches_jax(numel, k, values):
    assert TC.mix_wire_bytes(numel, k, values) == \
        JC.mix_wire_bytes(numel, k, values)


@pytest.mark.parametrize("spec", ["exp2", "one_peer_0", "ring", "empty"])
def test_mix_mirror_slots_matches_jax(spec):
    def make(mod):
        if spec == "exp2":
            return mod.uniform_topology_spec(mod.ExponentialTwoGraph(8))
        if spec == "one_peer_0":
            return mod.one_peer_dynamic_schedule(8)[0]
        if spec == "ring":
            return mod.uniform_topology_spec(mod.RingGraph(8))
        return mod.DynamicTopology.from_edges(8, {})

    assert TC.mix_mirror_slots(make(TT)) == JC.mix_mirror_slots(make(JT))


def _no_tie_rows(rng, n, numel):
    """Rows of distinct magnitudes (a random permutation of a spread)."""
    mags = np.linspace(0.05, 2.0, numel)
    rows = [rng.permutation(mags) * rng.choice([-1.0, 1.0], numel)
            for _ in range(n)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("k_live", [None, [6, 1, 3, 6]])
def test_topk_mask_encode_decode_matches_jax(k_live):
    rng = np.random.RandomState(2)
    flat = _no_tie_rows(rng, N, 23)
    k = 6
    t_mask, t_vals = TCmp.topk_mask_encode(
        torch.from_numpy(flat), k,
        None if k_live is None else torch.tensor(k_live))
    for r in range(N):
        j_mask, j_vals = JCmp.topk_mask_encode(
            jnp.asarray(flat[r]), k,
            None if k_live is None else jnp.int32(k_live[r]))
        np.testing.assert_array_equal(t_mask[r].numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(t_vals[r].numpy(), np.asarray(j_vals))
        np.testing.assert_array_equal(
            TCmp.topk_mask_decode(t_mask, t_vals)[r].numpy(),
            np.asarray(JCmp.topk_mask_decode(j_mask, j_vals)))


@pytest.mark.parametrize("numel", [1, 1023, 1024, 1025, 5000])
def test_decode_row_scan_equals_cumsum(numel):
    """The decode's two-level row scan (blocks of 1024, then the block
    totals) equals torch.cumsum exactly, across block edges."""
    mask = torch.from_numpy(np.random.RandomState(numel).rand(N, numel)
                            < 0.3).to(torch.int32)
    assert torch.equal(TCmp._row_cumsum(mask),
                       torch.cumsum(mask, dim=1, dtype=torch.int32))


def _exchange_jax(x, spec, ref, mir, err, ratio, k, values, ef, L):
    mesh = _mesh()

    def body(x, ref, mir, err, ratio):
        out, nr, nm, ne = JC.mix_compress_exchange(
            x[0], spec, "bf", ref_row=ref[0], mirrors=mir[0], err=err[0],
            ratio=ratio[0], k=k, values=values, error_feedback=ef,
            hierarchical_local_size=L)
        return out[None], nr[None], nm[None], ne[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("bf"),) * 5,
                               out_specs=(P("bf"),) * 4, check_vma=False))
    return [np.asarray(a) for a in fn(*[jnp.asarray(a) for a in
                                        (x, ref, mir, err, ratio)])]


EXCHANGES = {
    "exp2_int8": ("exp2", "int8", True, None),
    "exp2_none": ("exp2", "none", True, None),
    "one_peer_int8": ("one_peer", "int8", True, None),
    "one_peer_none_no_ef": ("one_peer", "none", False, None),
    "hier_int8": ("machine_pair", "int8", True, 2),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_mix_compress_exchange_matches_jax(case):
    """One round of the EF top-k exchange: the combined output and the
    advanced ref, mirrors and error rows against JAX (int8 or f32 kept
    values; a two-class graph with one mirror row per class, a fused
    one-peer round, and the machine-level exchange of 2 x 2 ranks)."""
    name, values, ef, L = EXCHANGES[case]

    def spec(mod):
        if name == "exp2":
            return mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))
        if name == "one_peer":
            return mod.one_peer_dynamic_schedule(N)[1]
        return mod.uniform_topology_spec(mod.ExponentialTwoGraph(2))

    slots = TC.mix_mirror_slots(spec(TT))
    assert slots == JC.mix_mirror_slots(spec(JT))
    rng = np.random.RandomState(4)
    numel, k = 24, 7
    x = _no_tie_rows(rng, N, numel).reshape(N, 4, 6)
    ref = (x.reshape(N, -1) + rng.randn(N, numel).astype(np.float32) * 0.3)
    if L:   # state at machine-mean granularity, equal within a machine
        ref = np.repeat(ref[::L], L, axis=0)
    mir = np.stack([ref] * slots, 1) + np.float32(0.01)
    err = (rng.randn(N, numel) * 0.01).astype(np.float32)
    if L:
        err = np.repeat(err[::L], L, axis=0)
    ratio = np.full(N, 0.25, np.float32)
    want = _exchange_jax(x, spec(JT), ref, mir, err, ratio, k, values, ef, L)
    got = TC.mix_compress_exchange(
        torch.from_numpy(x), spec(TT), ref_row=torch.from_numpy(ref),
        mirrors=torch.from_numpy(mir), err=torch.from_numpy(err),
        ratio=torch.from_numpy(ratio), k=k, values=values,
        error_feedback=ef, hierarchical_local_size=L)
    for g, w, what in zip(got, want, ("out", "ref", "mirrors", "err")):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    assert TC.mix_wire_bytes(numel, k, values) == (
        k + 3 + 4 if values == "int8" else 4 * k + 3)


def _mlp():
    rng = np.random.RandomState(0)
    base = {"b1": (rng.randn(5) * 0.1).astype(np.float32),
            "b2": (rng.randn(3) * 0.1).astype(np.float32),
            "w1": (rng.randn(6, 5) * 0.5).astype(np.float32),
            "w2": (rng.randn(5, 3) * 0.5).astype(np.float32)}
    rng = np.random.RandomState(1)
    x = rng.randn(3, N, 3, 6).astype(np.float32)
    y = rng.randn(3, N, 3, 3).astype(np.float32)
    return base, x, y


def _jloss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] + p["b2"] - y) ** 2).mean()


def _topk_jax(comm_mode, kw, cfg):
    base, x, y = _mlp()
    mesh = _mesh()
    opt = optax.sgd(0.1, momentum=0.9)
    step = JF.build_train_step(_jloss, opt, mesh, comm_mode=comm_mode,
                               donate=False, compress=cfg, **kw(JT))
    params = JF.rank_major({k: jnp.asarray(v) for k, v in base.items()},
                           mesh)
    opt_state = (JF.rank_major(opt.init(base), mesh),
                 step.init_mix_state(params))
    sh = NamedSharding(mesh, P("bf"))
    losses = []
    for s in range(3):
        batch = (jax.device_put(jnp.asarray(x[s]), sh),
                 jax.device_put(jnp.asarray(y[s]), sh))
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(s))
        losses.append(np.asarray(loss))
    return step, params, opt_state, np.stack(losses)


def _topk_port(comm_mode, kw, cfg, ratio_at=None):
    base, x, y = _mlp()
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({k: torch.from_numpy(v) for k, v in base.items()},
                           backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    step = bt.build_train_step(_tloss, opt, backend, comm_mode=comm_mode,
                               compress=cfg, **kw(TT))
    opt_state = (opt, step.init_mix_state(params)) if step.mix_config \
        else opt
    losses = []
    for s in range(3):
        if ratio_at is not None and s == ratio_at[0]:
            opt_state = step.set_mix_ratio(opt_state, ratio_at[1])
        batch = (torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        params, opt_state, loss = step(params, opt_state, batch, s)
        losses.append(loss.numpy().copy())
    return step, params, opt_state, np.stack(losses)


TOPK_STEPS = {
    "atc_int8": ("atc", "exp2", ("int8", None)),
    "cta_none": ("cta", "exp2", ("none", None)),
    "atc_one_peer_int8": ("atc", "one_peer", ("int8", None)),
    "atc_bucketed_int8": ("atc", "exp2", ("int8", "bucketed")),
}


@pytest.mark.parametrize("case", sorted(TOPK_STEPS))
def test_topk_step_matches_jax(case):
    """compress=MixCompressConfig(0.5, values), 3 steps: params, losses
    and every MixState buffer (err, ref, mirror per bucket) against
    JAX, and mix_wire_layout equal to JAX's."""
    comm_mode, topo, (values, overlap) = TOPK_STEPS[case]

    def kw(mod):
        out = ({"schedule": mod.one_peer_dynamic_schedule(N)}
               if topo == "one_peer" else
               {"topology": mod.uniform_topology_spec(
                   mod.ExponentialTwoGraph(N))})
        if overlap:
            out.update(overlap=overlap, overlap_buckets=2)
        return out

    js, jp, jo, jl = _topk_jax(comm_mode, kw,
                               JF.MixCompressConfig(0.5, values))
    ts, tp, to, tl = _topk_port(comm_mode, kw,
                                bt.MixCompressConfig(0.5, values))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    jm, tm = jo[1], to[1]
    np.testing.assert_array_equal(tm.ratio.numpy(), np.asarray(jm.ratio))
    for field in ("err", "ref", "mirror"):
        jf, tf = getattr(jm, field), getattr(tm, field)
        assert len(tf) == len(jf)
        for i, (a, b) in enumerate(zip(tf, jf)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{field}[{i}]")
    layout = ts.mix_wire_layout(tp)
    assert layout == js.mix_wire_layout(jp)
    assert ts.epilogue_stages == js.epilogue_stages


def test_set_mix_ratio_tightens_k_live():
    """A live ratio of 0.1 after step 0 sends at most
    clip(floor(0.1 * numel), 1, k) entries per bucket a step: each ref
    row moves in no more entries than that, where the build ratio (0.5)
    moved more."""
    def kw(mod):
        return {"topology": mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(N))}

    cfg = bt.MixCompressConfig(0.5, "none")
    step, params, opt_state, _ = _topk_port("atc", kw, cfg)
    loose = [(r[:, 0] != 0).sum(1) for r in opt_state[1].ref]
    base, x, y = _mlp()
    ms0 = step.init_mix_state(params)
    refs0 = [r.clone() for r in ms0.ref]
    tight = step.set_mix_ratio((opt_state[0], ms0), 0.1)
    assert torch.equal(tight[1].ratio, torch.full((N,), 0.1))
    assert torch.equal(ms0.ratio, torch.full((N,), 0.5))
    batch = (torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    params, tight, _ = step(params, tight, batch, 3)
    for r0, r1, row in zip(refs0, tight[1].ref,
                           step.mix_wire_layout(params)):
        k_live = min(max(int(np.floor(0.1 * row["numel"])), 1), row["k"])
        moved = (r1[:, 0] != r0[:, 0]).sum(1)
        assert (moved <= k_live).all() and (moved >= 1).all()
    assert any((lo > 1).any() for lo in loose)


@pytest.mark.parametrize("how", ["config", "env"])
def test_ratio_one_builds_the_dense_exchange(how, monkeypatch):
    """A ratio >= 1 keeps everything: the ordinary exchange (no MixState),
    bit-equal to compress=None; BLUEFOG_MIX_COMPRESS=topk with
    BLUEFOG_MIX_COMPRESS_RATIO=1.0 does the same."""
    def kw(mod):
        return {"topology": mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(N))}

    if how == "env":
        monkeypatch.setenv("BLUEFOG_MIX_COMPRESS", "topk")
        monkeypatch.setenv("BLUEFOG_MIX_COMPRESS_RATIO", "1.0")
        cfg = None
    else:
        cfg = bt.MixCompressConfig(1.0)
    step, p1, _, l1 = _topk_port("atc", kw, cfg)
    assert step.mix_config is None
    monkeypatch.delenv("BLUEFOG_MIX_COMPRESS", raising=False)
    _, p2, _, l2 = _topk_port("atc", kw, None)
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    np.testing.assert_array_equal(l1, l2)


def test_int8_sr_is_unbiased_over_draws():
    """The mean of 2000 stochastic-rounding draws dequantizes to the
    input within 5 standard errors of one draw's spread (a code is
    floor(y) or floor(y) + 1, so the per-entry standard deviation is at
    most half a grid step)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(N, 64).astype(np.float32))
    draws = 2000
    acc = torch.zeros_like(x, dtype=torch.float64)
    for s in range(draws):
        q, scale = TC._wire_quantize_int8(x, TC.wire_generator("cpu", s, 0))
        acc += q.double() * scale.double()[:, None]
    grid = (x.abs().amax(1) / 127.0).double()[:, None]
    err = (acc / draws - x.double()).abs()
    assert (err <= 5 * 0.5 * grid / np.sqrt(draws)).all()
    q_rn, _ = TC._wire_quantize_int8(x)
    assert (acc / draws - (q_rn.double() * grid)).abs().max() > 0


def test_int8_sr_codes_within_one_of_nearest():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(N, 3, 50).astype(np.float32))
    q_rn, s_rn = TC._wire_quantize_int8(x)
    y = x / s_rn[:, None, None]
    for s in range(20):
        q, scale = TC._wire_quantize_int8(x, TC.wire_generator("cpu", s, 3))
        assert torch.equal(scale, s_rn)
        assert (q.int() - q_rn.int()).abs().max() <= 1
        fl = torch.floor(y)
        assert ((q.float() == fl) | (q.float() == fl + 1)).all()


def test_int8_sr_deterministic_per_step_and_bucket():
    """One draw per (step, bucket): the same pair gives the same codes;
    another step or bucket gives others.  Through the combine too."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(N, 200).astype(np.float32))
    q = lambda s, b: TC._wire_quantize_int8(  # noqa: E731
        x, TC.wire_generator("cpu", s, b))[0]
    assert torch.equal(q(3, 1), q(3, 1))
    assert not torch.equal(q(3, 1), q(3, 2))
    assert not torch.equal(q(3, 1), q(4, 1))
    spec = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N))
    bufs = [x[:, :120], x[:, 120:]]
    a = TC.neighbor_allreduce_buckets(bufs, spec, compress="int8",
                                      wire_step=5)
    b = TC.neighbor_allreduce_buckets(bufs, spec, compress="int8",
                                      wire_step=5)
    c = TC.neighbor_allreduce_buckets(bufs, spec, compress="int8",
                                      wire_step=6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="int8"):
        TC.neighbor_allreduce(x, spec, compress="bf16",
                              generator=TC.wire_generator("cpu", 0))


def test_int8_sr_consensus_floor_below_round_to_nearest():
    """Pure averaging of 16 ranks x 64 values over the static
    ExponentialTwoGraph(16) for 150 rounds through the int8 wire: the
    consensus floor (median of max |x - mean| over the last 30 rounds)
    under stochastic rounding sits below round-to-nearest's, whose snaps
    repeat round after round."""
    n = 16
    spec = TT.uniform_topology_spec(TT.ExponentialTwoGraph(n))
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 64)).astype(np.float32))
    floors = {}
    for mode in ("int8", "int8_sr"):
        x, errs = x0.clone(), []
        for i in range(150):
            gen = TC.wire_generator("cpu", i, 0) if mode == "int8_sr" \
                else None
            x = TC.neighbor_allreduce(x, spec, compress="int8",
                                      generator=gen)
            errs.append(float((x - x.mean(0)).abs().max()))
        floors[mode] = float(np.median(errs[-30:]))
    grid = float(x0.abs().max() / 127)
    assert floors["int8_sr"] < floors["int8"] < 8 * grid, floors


def test_int8_sr_step_matches_int8_within_a_grid_step():
    """compress="int8_sr" in the step: 3 atc steps land within a few int8
    grid steps of the round-to-nearest wire's (both unbiased averaging of
    the same updates) and repeat bit for bit from the same seed."""
    def kw(mod):
        return {"topology": mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(N))}

    _, p_sr, _, _ = _topk_port("atc", kw, "int8_sr")
    _, p_sr2, _, _ = _topk_port("atc", kw, "int8_sr")
    _, p_rn, _, _ = _topk_port("atc", kw, "int8")
    for k in p_sr:
        assert torch.equal(p_sr[k], p_sr2[k])
        grid = float(p_rn[k].abs().max() / 127)
        assert (p_sr[k] - p_rn[k]).abs().max() <= 6 * grid, k
