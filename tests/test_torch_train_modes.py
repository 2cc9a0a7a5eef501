"""The port's train-step modes (bluefog_tpu_torch/optim/functional.py on
the stacked backend) against the JAX package's ``build_train_step`` on a
4-device CPU mesh: the non-finite skip guard, the HealthVector, the
bucketed overlap, ``BLUEFOG_FUSE_EPILOGUES=0`` and the
``bf_train_steps_total`` counter.

The model is a two-layer tanh MLP (6 → 5 → 3, f32) with a mean-squared
loss; every rank draws its own batch of 3 per step from a numpy seed,
and the same initial params and batches go to both packages.  The
port's params dict is in the JAX tree's (sorted) key order, so both
plan the same buckets.  A NaN planted in one rank's batch poisons that
rank's loss and gradients at one step.

Tolerances: params, optimizer state, losses, grad norms and consensus
distances after 3 steps to 1e-5 relative plus 1e-6 absolute (f32 sums in
another order on the two sides).  The update norm: the port measures
the update as new minus old params, which rounds each entry to the ulp
of the new param, so it adds 2^-23 of the new params' norm to that.
Skip flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import topology as JT
from bluefog_tpu.optim import functional as JF
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import observe as TO
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import fusion as TFu

N, B, STEPS = 4, 3, 3
D_IN, HID, D_OUT = 6, 5, 3
RTOL, ATOL = 1e-5, 1e-6


def _base():
    rng = np.random.RandomState(0)
    return {"b1": (rng.randn(HID) * 0.1).astype(np.float32),
            "b2": (rng.randn(D_OUT) * 0.1).astype(np.float32),
            "w1": (rng.randn(D_IN, HID) * 0.5).astype(np.float32),
            "w2": (rng.randn(HID, D_OUT) * 0.5).astype(np.float32)}


def _data(nan=None, steps=STEPS):
    """Per-step, per-rank batches; ``nan=(step, rank)`` poisons one."""
    rng = np.random.RandomState(1)
    x = rng.randn(steps, N, B, D_IN).astype(np.float32)
    y = rng.randn(steps, N, B, D_OUT).astype(np.float32)
    if nan is not None:
        x[nan[0], nan[1], 0, 0] = np.nan
    return x, y


def _jloss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] + p["b2"] - y) ** 2).mean()


def _spec(mod, name):
    if name == "exp2":
        return mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))
    if name == "one_peer":
        return mod.one_peer_dynamic_schedule(N)
    raise ValueError(name)


def _kw(mod, kw):
    out = dict(kw)
    for key in ("topology", "schedule"):
        if isinstance(out.get(key), str):
            out[key] = _spec(mod, out[key])
    return out


def _jopt(opt):
    return (optax.sgd(0.1, momentum=0.9) if opt == "sgd"
            else optax.adamw(0.01, weight_decay=0.1))


def _topt(opt, params):
    if opt == "sgd":
        return torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    return torch.optim.AdamW(params.values(), lr=0.01, weight_decay=0.1)


def _unpack(out, guarded, health):
    """(params, opt_state, loss, skipped, hv) from a step's outputs."""
    params, opt_state, loss = out[:3]
    rest = list(out[3:])
    skipped = rest.pop(0) if guarded else None
    hv = rest.pop(0) if health else None
    return params, opt_state, loss, skipped, hv


def run_jax(comm_mode, kw, opt="sgd", nan=None, steps=STEPS, env=None,
            monkeypatch=None):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    optj = _jopt(opt)
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    try:
        step = JF.build_train_step(_jloss, optj, mesh, comm_mode=comm_mode,
                                   donate=False, **_kw(JT, kw))
    finally:
        for k in env or ():
            monkeypatch.delenv(k)
    base = _base()
    params = JF.rank_major({k: jnp.asarray(v) for k, v in base.items()},
                           mesh)
    opt_state = JF.rank_major(optj.init(base), mesh)
    if comm_mode == "push_sum":
        opt_state = (opt_state, JF.push_sum_weights(mesh))
    guarded, health = "guard" in kw, "health" in kw
    x, y = _data(nan, steps)
    sh = NamedSharding(mesh, P("bf"))
    res = dict(loss=[], skipped=[], hv=[])
    for s in range(steps):
        batch = (jax.device_put(jnp.asarray(x[s]), sh),
                 jax.device_put(jnp.asarray(y[s]), sh))
        args = (params, opt_state, batch, jnp.int32(s))
        if guarded:
            args = args + (step.default_comm_weights,)
        params, opt_state, loss, skipped, hv = _unpack(step(*args), guarded,
                                                       health)
        res["loss"].append(np.asarray(loss))
        if guarded:
            res["skipped"].append(np.asarray(skipped))
        if health:
            res["hv"].append({f: np.asarray(v)
                              for f, v in hv._asdict().items()})
    res["params"] = {k: np.asarray(v) for k, v in params.items()}
    res["opt_state"] = opt_state
    return res


def run_port(comm_mode, kw, opt="sgd", nan=None, steps=STEPS):
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({k: torch.from_numpy(v)
                            for k, v in _base().items()}, backend)
    topt = _topt(opt, params)
    step = bt.build_train_step(_tloss, topt, backend, comm_mode=comm_mode,
                               **_kw(TT, kw))
    opt_state = topt
    if comm_mode == "push_sum":
        opt_state = (topt, bt.push_sum_weights(backend))
    guarded, health = "guard" in kw, "health" in kw
    x, y = _data(nan, steps)
    res = dict(loss=[], skipped=[], hv=[], step=step, after=[])
    for s in range(steps):
        batch = (torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        args = (params, opt_state, batch, s)
        if guarded:
            args = args + (step.default_comm_weights,)
        params, opt_state, loss, skipped, hv = _unpack(step(*args), guarded,
                                                       health)
        res["loss"].append(loss.numpy().copy())
        if guarded:
            assert skipped.dtype == torch.int32 and skipped.shape == (N,)
            res["skipped"].append(skipped.numpy().copy())
        if health:
            assert all(v.shape == (N,) and v.dtype == torch.float32
                       for v in hv)
            res["hv"].append({f: v.numpy().copy()
                              for f, v in hv._asdict().items()})
            res["after"].append({k: v.numpy().copy()
                                   for k, v in params.items()})
    res["params"] = {k: v.numpy().copy() for k, v in params.items()}
    res["opt"] = topt
    res["tensors"] = params
    res["opt_state"] = opt_state
    return res


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what, equal_nan=True)


def _check_params(tp, jp):
    for k in jp["params"]:
        _close(tp["params"][k], jp["params"][k], f"param {k}")


def _check_health(tp, jp):
    for s, (th, jh) in enumerate(zip(tp["hv"], jp["hv"])):
        for f in ("loss", "grad_norm", "skipped", "consensus"):
            _close(th[f], jh[f], f"step {s} {f}")
        # new - old rounds each entry to the ulp of the new param
        p_norm = np.sqrt(sum((v.astype(np.float64) ** 2).reshape(N, -1)
                             .sum(1) for v in tp["after"][s].values()))
        _close(th["update_norm"], jh["update_norm"], f"step {s} update_norm",
               atol=ATOL + 2.0 ** -23 * float(p_norm.max()))
        np.testing.assert_array_equal(th["skipped"], jh["skipped"])


def _sgd_momentum(tp):
    return {k: tp["opt"].state[p]["momentum_buffer"].numpy()
            for k, p in tp["tensors"].items()}


GUARD_MODES = {
    "atc": ("atc", {"topology": "exp2"}),
    "cta": ("cta", {"topology": "exp2"}),
    "gradient_allreduce": ("gradient_allreduce", {}),
}


@pytest.mark.parametrize("mode", sorted(GUARD_MODES))
def test_guard_skips_nan_rank_like_jax(mode):
    """A NaN in rank 2's batch at step 1: the skip flags, params, momentum
    and losses of 3 guarded SGD-momentum steps against JAX.  Under
    gradient_allreduce the NaN reaches every rank and all skip."""
    comm_mode, kw = GUARD_MODES[mode]
    kw = dict(kw, guard=JF.GuardConfig())
    jp = run_jax(comm_mode, kw, nan=(1, 2))
    tp = run_port(comm_mode, dict(kw, guard=bt.GuardConfig()), nan=(1, 2))
    want = np.zeros((STEPS, N), np.int32)
    want[1] = 1 if comm_mode == "gradient_allreduce" else [0, 0, 1, 0]
    np.testing.assert_array_equal(np.stack(jp["skipped"]), want)
    np.testing.assert_array_equal(np.stack(tp["skipped"]), want)
    _close(np.stack(tp["loss"]), np.stack(jp["loss"]), "losses")
    _check_params(tp, jp)
    trace = jp["opt_state"][0].trace
    for k, v in _sgd_momentum(tp).items():
        _close(v, np.asarray(trace[k]), f"momentum {k}")
    assert all(np.isfinite(v).all() for v in tp["params"].values())


def test_guard_adamw_per_rank_count_matches_optax():
    """AdamW under atc with rank 2's step 1 skipped: rank 2's Adam count
    falls one behind, as optax's per-rank count does, and the params and
    moments agree with optax's."""
    kw = {"topology": "exp2"}
    jp = run_jax("atc", dict(kw, guard=JF.GuardConfig()), opt="adamw",
                 nan=(1, 2))
    tp = run_port("atc", dict(kw, guard=bt.GuardConfig()), opt="adamw",
                  nan=(1, 2))
    adam = jp["opt_state"][0]
    np.testing.assert_array_equal(np.asarray(adam.count), [3, 3, 2, 3])
    for k, p in tp["tensors"].items():
        st = tp["opt"].state[p]
        np.testing.assert_array_equal(st["step"].numpy(), [3, 3, 2, 3])
        _close(st["exp_avg"].numpy(), np.asarray(adam.mu[k]), f"mu {k}")
        _close(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), f"nu {k}",
               atol=1e-9)
    _check_params(tp, jp)


@pytest.mark.parametrize("opt,mode", [("sgd", "atc"), ("sgd", "cta"),
                                      ("adamw", "atc"),
                                      ("sgd", "gradient_allreduce")])
def test_guarded_healthy_step_is_bit_identical(opt, mode):
    """With no fault, the guarded step's params, optimizer state and
    losses equal the unguarded port step's bit for bit."""
    comm_mode, kw = GUARD_MODES[mode]
    plain = run_port(comm_mode, kw, opt=opt)
    guarded = run_port(comm_mode, dict(kw, guard=bt.GuardConfig()), opt=opt)
    assert not np.stack(guarded["skipped"]).any()
    for k in plain["params"]:
        np.testing.assert_array_equal(guarded["params"][k],
                                      plain["params"][k])
        sa = plain["opt"].state[plain["tensors"][k]]
        sb = guarded["opt"].state[guarded["tensors"][k]]
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (k, name)
    np.testing.assert_array_equal(np.stack(guarded["loss"]),
                                  np.stack(plain["loss"]))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_skipped_rank_keeps_params_stats_and_state_bitwise(opt):
    """A tiny batch-normed ResNet, comm_mode none (no combine after the
    select): the rank whose images hold a NaN keeps its params, batch
    statistics and optimizer state (Adam's count included) bit for bit;
    the other ranks move."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.models import BottleneckBlock

    model = bt.ResNet((1,), BottleneckBlock, num_classes=4, num_filters=4,
                      dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    backend = bt.StackedBackend(N, device="cpu")
    p0, s0 = model.state()
    params, stats = bt.rank_major(p0, backend), bt.rank_major(s0, backend)
    topt = _topt(opt, params)

    def loss_fn(p, s, b):
        logits, new = model.apply(p, s, b[0], train=True)
        return F.cross_entropy(logits, b[1]), new

    step = bt.build_train_step(loss_fn, topt, backend, comm_mode="none",
                               has_aux=True, guard=bt.GuardConfig())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(N, 2, 8, 8, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (N, 2)))
    params, stats, topt, loss, skipped = step(params, stats, topt, (x, y), 0,
                                              ())
    before = ({k: v.clone() for k, v in params.items()},
              {k: v.clone() for k, v in stats.items()},
              {k: {n: t.clone() for n, t in topt.state[p].items()}
               for k, p in params.items()})
    x[2, 0, 0, 0, 0] = float("nan")
    params, stats, topt, loss, skipped = step(params, stats, topt, (x, y), 1,
                                              ())
    assert skipped.tolist() == [0, 0, 1, 0]
    assert torch.isnan(loss[2]) and torch.isfinite(loss[[0, 1, 3]]).all()
    moved = False
    for k, v in params.items():
        assert torch.equal(v[2], before[0][k][2]), k
        for n, t in topt.state[v].items():
            assert torch.equal(t[2], before[2][k][n][2]), (k, n)
        moved |= not torch.equal(v[0], before[0][k][0])
    for k, v in stats.items():
        assert torch.equal(v[2], before[1][k][2]), k
    assert moved
    if opt == "adamw":
        assert topt.state[params["Dense_0.kernel"]]["step"].tolist() == \
            [2, 2, 1, 2]


HEALTH_MODES = {
    "atc": ("atc", {"topology": "exp2"}, None),
    "cta_one_peer": ("cta", {"schedule": "one_peer"}, None),
    "gradient_allreduce": ("gradient_allreduce", {}, None),
    "atc_guard_nan": ("atc", {"topology": "exp2", "guard": True}, (1, 2)),
    "cta_every_2": ("cta", {"topology": "exp2",
                            "num_steps_per_communication": 2}, None),
    "atc_no_consensus": ("atc", {"topology": "exp2", "consensus": False},
                         None),
}


@pytest.mark.parametrize("mode", sorted(HEALTH_MODES))
def test_health_vector_matches_jax(mode):
    """Every HealthVector field of 3 steps against JAX.  Off-cycle steps
    (num_steps_per_communication=2: step 1) and modes without a neighbor
    exchange read a zero consensus; without a guard ``skipped`` is the
    would-skip bit."""
    comm_mode, kw, nan = HEALTH_MODES[mode]
    kw = dict(kw)
    cons = kw.pop("consensus", True)
    guard = kw.pop("guard", False)
    jkw = dict(kw, health=JF.HealthConfig(consensus=cons))
    tkw = dict(kw, health=bt.HealthConfig(consensus=cons))
    if guard:
        jkw["guard"], tkw["guard"] = JF.GuardConfig(), bt.GuardConfig()
    jp = run_jax(comm_mode, jkw, nan=nan)
    tp = run_port(comm_mode, tkw, nan=nan)
    _check_health(tp, jp)
    _check_params(tp, jp)
    cons_steps = np.stack([h["consensus"] for h in tp["hv"]])
    if comm_mode == "cta":
        # every rank starts at the same params: the combine moves them by
        # the f32 rounding of weights that sum to 1 only in exact math
        assert (cons_steps[0] < 1e-6).all()
        cons_steps = cons_steps[1:]
    if comm_mode not in ("cta", "atc") or not cons:
        assert not cons_steps.any()
    elif kw.get("num_steps_per_communication") == 2:
        assert not cons_steps[0].any() and cons_steps[1].all()
    else:
        assert cons_steps.all()


BUCKET_MODES = {
    f"{mode}_{wire}": (mode, dict(
        {"schedule": "one_peer"} if wire == "schedule"
        else {"topology": "exp2"},
        **({"compress": "int8"} if wire == "int8" else {})))
    for mode in ("cta", "atc") for wire in ("plain", "int8", "schedule")
}


@pytest.mark.parametrize("mode", sorted(BUCKET_MODES))
def test_bucketed_matches_jax(mode):
    """overlap="bucketed" (2 size-balanced buckets over the 4 leaves,
    int8's absmax scale per bucket) with health, 3 steps against JAX."""
    comm_mode, kw = BUCKET_MODES[mode]
    kw = dict(kw, overlap="bucketed", overlap_buckets=2)
    jp = run_jax(comm_mode, dict(kw, health=JF.HealthConfig()))
    tp = run_port(comm_mode, dict(kw, health=bt.HealthConfig()))
    _close(np.stack(tp["loss"]), np.stack(jp["loss"]), "losses")
    _check_params(tp, jp)
    _check_health(tp, jp)
    plan = TFu.EpiloguePlan.for_leaves(list(tp["tensors"].values()), 2,
                                       skip_leading_axis=True)
    leaves = [jnp.asarray(v) for _, v in sorted(_base().items())]
    assert plan.groups == JF._bucket_groups(leaves, 2) == [[0, 1], [2], [3]]


@pytest.mark.parametrize("comm_mode", ["cta", "atc"])
def test_bucketed_is_bit_equal_to_plain(comm_mode):
    """Without wire compression, bucketed and plain give the same bits
    (the combine is elementwise; the buckets only regroup it)."""
    kw = {"topology": "exp2"}
    plain = run_port(comm_mode, kw)
    bucketed = run_port(comm_mode, dict(kw, overlap="bucketed",
                                        overlap_buckets=3))
    for k in plain["params"]:
        np.testing.assert_array_equal(bucketed["params"][k],
                                      plain["params"][k])


UNFUSED_MODES = {
    "atc_health": ("atc", {"topology": "exp2",
                           "health": True}),
    "cta_guard_bucketed": ("cta", {"topology": "exp2", "guard": True,
                                   "health": True, "overlap": "bucketed",
                                   "overlap_buckets": 2}),
    "atc_bucketed_int8": ("atc", {"schedule": "one_peer", "health": True,
                                  "overlap": "bucketed", "overlap_buckets": 2,
                                  "compress": "int8"}),
    "push_sum_health": ("push_sum", {"topology": "exp2", "health": True}),
}


@pytest.mark.parametrize("mode", sorted(UNFUSED_MODES))
def test_unfused_epilogues_match_jax(mode, monkeypatch):
    """BLUEFOG_FUSE_EPILOGUES=0 against the JAX package's pre-fusion
    builders: the health reductions walk the whole tree per leaf after
    the exchange."""
    comm_mode, kw = UNFUSED_MODES[mode]
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("health", False):
        jkw["health"], tkw["health"] = JF.HealthConfig(), bt.HealthConfig()
    if kw.pop("guard", False):
        jkw["guard"], tkw["guard"] = JF.GuardConfig(), bt.GuardConfig()
    jp = run_jax(comm_mode, jkw, nan=None, env={"BLUEFOG_FUSE_EPILOGUES": "0"},
                 monkeypatch=monkeypatch)
    monkeypatch.setenv("BLUEFOG_FUSE_EPILOGUES", "0")
    tp = run_port(comm_mode, tkw)
    _check_params(tp, jp)
    _check_health(tp, jp)


@pytest.mark.parametrize("observe", ["1", "0"])
def test_train_steps_total_counter(observe, monkeypatch):
    """Each call counts in bf_train_steps_total{comm_mode, overlap,
    guarded} inside a train_step span; BLUEFOG_OBSERVE=0 records
    nothing and leaves the results unchanged."""
    monkeypatch.setenv("BLUEFOG_OBSERVE", observe)
    reg, tr = TO.get_registry(), TO.get_tracer()
    labels = dict(comm_mode="atc", overlap="bucketed", guarded="true")
    before = reg.counter("bf_train_steps_total", **labels).value
    n_events = len(tr.events())
    tp = run_port("atc", {"topology": "exp2", "overlap": "bucketed",
                          "guard": bt.GuardConfig()}, steps=2)
    after = reg.counter("bf_train_steps_total", **labels).value
    events = [e[:3] for e in tr.events()[n_events:] if e[2] == "train"]
    if observe == "1":
        assert after - before == 2
        assert events == [("B", "train_step", "train"), ("E", "", "train")] * 2
    else:
        assert after == before and not events
    ref = run_port("atc", {"topology": "exp2", "overlap": "bucketed",
                           "guard": bt.GuardConfig()}, steps=2)
    for k in ref["params"]:
        np.testing.assert_array_equal(tp["params"][k], ref["params"][k])
