"""The port's ``verify_collective_contract`` (``benchutil``; a step's
``StepProfile`` in place of HLO text) against the JAX package's, which
reads the compiled step's HLO, on the same configurations:

* the tiny f32 Llama at dp 4 x tp 2 under ``MixCompressConfig(0.25,
  "int8")`` over one round of ``one_peer_dynamic_schedule(4)`` (one
  fused permute a bucket), its prediction built from
  ``mix_wire_layout`` as ``benchmarks/llama_8b_overlap.py`` builds it;
  and under the int8 wire (a permute of each device's codes and one of
  its scale per bucket);
* a one-leaf MLP on 4 ranks under the hierarchical exchange of
  ``compile_topology(PodSpec(2, 2), hierarchical=True)``, each machine
  round held to its ``per_round`` entry (one grouped all-reduce over
  the machines' ranks, the machine permutes).

Both return ``[]`` on the sound predictions, and both flag the same
planted mismatches: a permute too many, a payload that is not
admissible (the layout planned over whole-rank buckets, the port's
layout before per-device buckets), totals off by a byte, a prediction
whose per-round sum disagrees with its totals, and a machine
decomposition that is not the exchange's.  The profiled step also bills
``bf_edge_bytes_total`` what one device sends: its buckets' bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import benchutil as JB
from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import llama_param_specs as j_specs
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import one_peer_dynamic_schedule as j_one_peer
from bluefog_tpu.topology.compiler import (PodSpec as JPod,
                                           compile_topology as j_compile)
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import benchutil as TB
from bluefog_tpu_torch import observe
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import llama_loss_fn, llama_param_specs
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import fusion as TFu
from bluefog_tpu_torch.parallel import collectives as TC
from bluefog_tpu_torch.topology.compiler import PodSpec, compile_topology

N_BF, N_TP, B, T, LR = 4, 2, 2, 16, 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_name(path) -> str:
    keys = [str(getattr(k, "key", k)) for k in path]
    name = ".".join(keys[1:] if keys[0] == "params" else keys)
    for i in range(64):
        name = name.replace(f"layer_{i}.", f"layers.{i}.")
    return name


def _tp_case(compress):
    """JAX's compiled dp 4 x tp 2 step under ``compress`` (HLO text) and
    the port's profiled step: (hlo, profile, jax step, port step, port
    params, JAX params)."""
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    raw = np.random.RandomState(0).randint(0, 256, (N_BF, B, T + 1))
    inp, tgt = raw[..., :-1].astype(np.int32), raw[..., 1:].astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(N_BF, N_TP),
                ("bf", "tp"))
    m2 = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, tp_axis="tp",
                                      tp_size=N_TP))

    def loss_fn(params, batch):
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            m2.apply(params, batch[0]), batch[1]))

    opt = optax.sgd(LR)
    specs = j_specs(v)
    ospecs = JF.optax_state_specs(opt, v, specs)
    jstep = JF.build_train_step(
        loss_fn, opt, mesh, comm_mode="cta",
        topology=j_one_peer(N_BF)[0], param_specs=specs,
        opt_state_specs=ospecs, donate=False, compress=compress(JF))
    jparams = JF.rank_major(v, mesh, specs=specs)
    jopt = JF.rank_major(opt.init(v), mesh, specs=ospecs)
    if jstep.mix_config is not None:
        jopt = (jopt, jstep.init_mix_state(jparams))
    sh = NamedSharding(mesh, P("bf"))
    jbatch = (jax.device_put(inp, sh), jax.device_put(tgt, sh))
    hlo = jstep.lower(jparams, jopt, jbatch, jnp.int32(0)).compile() \
        .as_text()

    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                               tp_size=N_TP)
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(v, tcfg, device="cpu"))
    state = model.state(release=True)
    order = [_port_name(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(v)[0]]
    state = {k: state[k] for k in order}
    backend = bt.StackedBackend(N_BF, device="cpu")
    tspecs = llama_param_specs(state)
    params = bt.rank_major(state, backend, specs=tspecs)
    topt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        llama_loss_fn(model), topt, backend, comm_mode="cta",
        topology=TT.one_peer_dynamic_schedule(N_BF)[0],
        mesh_axes=(bt.MeshAxis("tp", N_TP),), param_specs=tspecs,
        opt_state_specs=TF.optax_state_specs(topt, state, tspecs),
        compress=compress(bt))
    ostate = ((topt, step.init_mix_state(params))
              if step.mix_config is not None else topt)
    batch = (torch.from_numpy(inp), torch.from_numpy(tgt))
    before = _edge_bytes()
    prof = observe.profile_step(step, params, ostate, batch, 0,
                                publish=False)
    edges = {k: v - before.get(k, 0.0) for k, v in _edge_bytes().items()
             if v != before.get(k, 0.0)}
    return dict(hlo=hlo, prof=prof, jstep=jstep, step=step, params=params,
                jparams=jparams, edges=edges)


def _edge_bytes():
    return {tuple(sorted(lbl.items())): m.value
            for n, _k, _h, lbl, m in observe.get_registry().collect()
            if n == "bf_edge_bytes_total"}


def _both(case, predicted, payloads, **kw):
    """(JAX's problems on its HLO, the port's on its profile)."""
    return (JB.verify_collective_contract(case["hlo"], predicted, payloads,
                                          **kw),
            TB.verify_collective_contract(case["prof"], predicted, payloads,
                                          **kw))


def _layout_prediction(rows):
    return ({"permutes_per_period": len(rows),
             "bytes_per_period": float(sum(r["wire_bytes"] for r in rows))},
            sorted({r["wire_bytes"] for r in rows}))


_CASES = {}


@pytest.fixture(scope="module")
def mix_case():
    if "mix" not in _CASES:
        _CASES["mix"] = _tp_case(lambda F: F.MixCompressConfig(0.25,
                                                               "int8"))
    return _CASES["mix"]


def test_mix_tp_contract_holds_and_flags_what_jax_flags(mix_case):
    """Top-k(0.25) mixing with int8 values at dp 4 x tp 2: the layout's
    prediction holds on both sides (one permute of one device's wire a
    bucket); a permute too many, the whole-rank layout's payloads, totals
    a byte off and an inconsistent per-round sum are flagged by both."""
    case = mix_case
    layout = case["step"].mix_wire_layout(case["params"])
    assert layout == case["jstep"].mix_wire_layout(case["jparams"])
    pred, payloads = _layout_prediction(layout)
    assert _both(case, pred, payloads) == ([], [])
    assert case["prof"].collective_payloads["collective-permute"] == [
        r["wire_bytes"] for r in layout]
    # the port's layout before per-device buckets: each bucket a rank's
    # whole leaf (every tp shard under one selection and one scale)
    whole = []
    for b, name in enumerate(case["params"]):
        numel = case["params"][name][0].numel()
        k = max(int(0.25 * numel), 1)
        whole.append(dict(bucket=b, numel=numel, k=k,
                          wire_bytes=TC.mix_wire_bytes(numel, k, "int8")))
    assert whole != layout
    planted = {
        "permute count": (dict(pred, permutes_per_period=len(layout) + 1),
                          payloads),
        "whole-rank buckets": _layout_prediction(whole),
        "totals": (dict(pred, bytes_per_period=pred["bytes_per_period"]
                        + 1), payloads),
        "per-round sum": (dict(pred, per_round=[
            {"permutes": len(layout), "bytes_per_permute": 1.0}]),
            payloads),
    }
    for what, (p, pl) in planted.items():
        j, t = _both(case, p, pl)
        assert j and t, what
        assert len(j) == len(t), (what, j, t)
    # one device's logical bytes billed per edge and step: its buckets'
    # f32 values (each leaf's slice, a replicated leaf whole)
    assert len(case["edges"]) == len(TT.one_peer_dynamic_schedule(N_BF)[0]
                                     .edges)
    assert set(case["edges"].values()) == {
        2.0 * 4 * sum(r["numel"] for r in layout)}


def test_int8_tp_contract_holds_and_flags_what_jax_flags():
    """The int8 wire at dp 4 x tp 2, one bucket a leaf: each bucket moves
    a permute of one device's int8 codes and one of its f32 scale; the
    prediction from each device's leaf sizes holds on both sides, the
    whole-rank leaf sizes' is flagged by both."""
    case = _tp_case(lambda F: "int8")
    step, params = case["step"], case["params"]
    specs = llama_param_specs({k: v[0] for k, v in params.items()})
    layout = TFu.DeviceLayout.for_leaves(
        list(params), list(params.values()), specs, [("tp", N_TP)])
    sizes = [int(np.prod(v.shape)) for v in layout.views]
    whole = [params[k][0].numel() for k in params]

    def pred(s):
        return ({"permutes_per_period": 2 * len(s),
                 "bytes_per_period": float(sum(s) + 4 * len(s))},
                sorted(set(s) | {4}))

    assert _both(case, *pred(sizes)) == ([], [])
    j, t = _both(case, *pred(whole))
    assert j and t and len(j) == len(t), (j, t)
    assert sorted(case["prof"].collective_payloads["collective-permute"]) \
        == sorted(sizes + [4] * len(sizes))


def _mlp_hier(rnd, local):
    """A one-leaf linear model on 4 ranks under the hierarchical exchange
    of machine round ``rnd`` (static): JAX's compiled HLO and the port's
    profile."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 3).astype(np.float32)
    x = rng.randn(4, 5, 6).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:4]), ("bf",))
    opt = optax.sgd(0.1)

    def jloss(p, batch):
        return jnp.mean((batch @ p["w"]) ** 2)

    jstep = JF.build_train_step(jloss, opt, mesh, comm_mode="atc",
                                topology=rnd[0], hierarchical=local,
                                donate=False)
    jp = JF.rank_major({"w": w0}, mesh)
    jo = JF.rank_major(opt.init({"w": w0}), mesh)
    xb = jax.device_put(x, NamedSharding(mesh, P("bf")))
    hlo = jstep.lower(jp, jo, xb, jnp.int32(0)).compile().as_text()
    backend = bt.StackedBackend(4, device="cpu")
    params = bt.rank_major({"w": torch.from_numpy(w0)}, backend)
    topt = torch.optim.SGD(params.values(), lr=0.1)
    step = bt.build_train_step(
        lambda p, b: ((b @ p["w"]) ** 2).mean(), topt, backend,
        comm_mode="atc", topology=rnd[1], hierarchical=local)
    prof = observe.profile_step(step, params, topt, torch.from_numpy(x), 0,
                                publish=False)
    return dict(hlo=hlo, prof=prof)


def test_hierarchical_contract_holds_and_flags_what_jax_flags():
    """Each machine round of the compiled hierarchical topology of
    PodSpec(2, 2): one grouped all-reduce over each machine's ranks and
    the machine permutes, each carrying the rank's payload; a
    decomposition into one machine of 4 is flagged by both, as is a
    missing all-reduce."""
    jc = j_compile(JPod(2, 2), hierarchical=True)
    tc = compile_topology(PodSpec(2, 2), hierarchical=True)
    assert tc.local_size == jc.local_size == 2
    payload = 6 * 3 * 4
    pred = tc.predicted_collectives(payload)
    assert pred == jc.predicted_collectives(payload)
    for i, (jr, tr) in enumerate(zip(jc.machine_schedule,
                                     tc.machine_schedule)):
        case = _mlp_hier((jr, tr), 2)
        assert _both(case, pred, payload, round_index=i) == ([], [])
        assert case["prof"].collective_groups["all-reduce"] == [
            [[0, 1], [2, 3]]]
        wrong = dict(pred, all_reduce_groups=1, all_reduce_group_size=4)
        j, t = _both(case, wrong, payload, round_index=i)
        assert j and t and len(j) == len(t), (j, t)
        more = dict(pred, per_round=[dict(r, all_reduces=2)
                                     for r in pred["per_round"]])
        j, t = _both(case, more, payload, round_index=i)
        assert j and t and len(j) == len(t), (j, t)


def test_contract_reads_a_profile_not_hlo_text():
    """The port has no HLO: text is refused; a tally dict is read as a
    profile is."""
    with pytest.raises(TypeError, match="StepProfile"):
        TB.verify_collective_contract("HloModule m", {}, 4)
    tally = {"collective-permute": {"count": 2, "bytes": 8,
                                    "payloads": [4, 4]}}
    pred = {"permutes_per_period": 2, "bytes_per_period": 8.0}
    assert TB.verify_collective_contract(tally, pred, 4) == []
    assert TB.verify_collective_contract(tally, pred, 8)
