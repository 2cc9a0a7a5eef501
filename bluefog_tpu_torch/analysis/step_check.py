"""Step check: the semantic half of the analyzer, by running programs.

Port of ``bluefog_tpu/analysis/jaxpr_check.py``.  The JAX pass walks the
traced jaxprs of the real programs; a torch program has no jaxpr, so this
pass RUNS the real programs and reads what they did.  It checks the same
contracts under the same rule names, on the same matrix of programs:

**weights-as-data** (:func:`check_step`)
    The comm-weight tables (``comm_weight_inputs(specs)``: one
    ``(class_weights, self_weights)`` pair per round) must reach the step
    as data that it reads at every call.  A guarded step takes its table
    as the ``comm_weights`` argument; an unguarded one reads the tensors
    of ``step.default_comm_weights``, which the check writes in place
    (that is the port's default operand, and what a CUDA graph's captured
    buffers need) and restores afterwards.  The step runs from clones of
    one state under three tables:

    * ``missing-weight-operand`` -- the step of a neighbor mode has no
      ``default_comm_weights``, or its shapes are not
      ``comm_weight_inputs(step.comm_specs)``'s;
    * ``dead-weight-operand`` -- the result under the identity table
      (self weight 1, class weights 0) is bit-equal to the result under
      the default table: the combine did not read the table it was
      given.  Writing the default table back must then reproduce the
      first run bit for bit (symbol ``restore``);
    * ``baked-weight-const`` -- under a third row-stochastic table
      ``W3`` the new params differ from what the combine under ``W3``
      predicts by more than ``BAKED_ULPS`` f32 (the leaf's dtype's) eps
      times ``max|x|`` (plus the wire's grid step for a quantized wire).
      The prediction is plain float64 arithmetic on the identity run's
      output: ``W3 x_I`` under atc, ``x_I + (W3 x - x)`` under cta
      (``W3`` over the machine means under a hierarchical exchange).
      The rule applies to atc and cta; the top-k mixing epilogue, whose
      combine mixes its reference copies, gets the first two rules.

    The state must differ across ranks: a row-stochastic combine of
    equal rows is the identity, whatever the table.

**collective contract** (:func:`check_collective_contracts`)
    The scheduled exchanges (the flat ``PodSpec(1, 8)`` schedule's period
    and each of its rounds, the compiled MoE all-to-all, the
    hierarchical ``PodSpec(4, 2)`` rounds) run under the exchange tally
    and are held to ``predicted_collectives`` through
    :func:`bluefog_tpu_torch.benchutil.verify_collective_contract`.

**serving residents** (:func:`check_serving_residents`)
    Each resident program of a plain and a speculative
    ``ServingEngine`` runs, then a second seeded model's weights are
    written into the engine's model in place and the program runs
    again: its output must equal, bit for bit, that of a fresh engine
    built on the second weights.  Otherwise the program read a copy of
    the weights made at build time: ``baked-weight-const``.

JAX's ``divergent-cond`` has no counterpart (an eager step has no traced
``cond``; the lint's ``python-if-on-tensor`` covers the branch).
:func:`run_sweep` runs everything; the CLI and the tests call it.  The
mutants the tests and ``chip_smoke.py`` plant are
:func:`baked_table_step`, :func:`copied_weights_engine` and
:func:`drop_one_permute`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.analysis import Finding

__all__ = ["check_step", "check_collective_contracts",
           "check_serving_residents", "sweep_cases", "case_id",
           "run_sweep", "baked_table_step", "copied_weights_engine",
           "drop_one_permute", "N_RANKS", "BAKED_ULPS"]

N_RANKS = 8        # the sweep's rank count (JAX's 8-device CPU mesh)
BAKED_ULPS = 16    # baked-weight-const's bound: this many eps of the
                   # leaf's dtype times max|x| (a combine of k classes
                   # rounds ~1.5 k + 2 times, the cta update once more)
_SPREAD = 0.1      # the per-rank spread the sweep's state is given


# --------------------------------------------------------------------- #
# state plumbing: every tensor a step reads or writes, cloned and put back
# --------------------------------------------------------------------- #

def _tensors(obj, out: list, seen: set) -> list:
    """Every tensor reachable from ``obj`` (dicts, sequences, named
    tuples, dataclasses) in a fixed order; an optimizer is left out (its
    state is kept apart, by param)."""
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for k in obj:
            _tensors(obj[k], out, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out, seen)
    return out


def _optimizers(state: tuple) -> list:
    """The optimizers in a step's state (``opt_state`` is the optimizer,
    or a pair of it and its MixState or push-sum weights)."""
    return [o for obj in state
            for o in (obj if isinstance(obj, tuple) else (obj,))
            if isinstance(o, torch.optim.Optimizer)]


def _copy(v):
    return v.detach().clone() if isinstance(v, torch.Tensor) \
        else copy.deepcopy(v)


class _Snapshot:
    """Clones of a step's state (params, aux, the optimizer's state and
    what rides beside it: a MixState, push-sum weights), put back in
    place before each run."""

    def __init__(self, state: tuple) -> None:
        self.items = [(t, t.detach().clone())
                      for t in _tensors(state, [], set())]
        self.opts = [(o, {p: {k: _copy(v) for k, v in st.items()}
                          for p, st in o.state.items()})
                     for o in _optimizers(state)]

    def restore(self) -> None:
        with torch.no_grad():
            for opt, saved in self.opts:
                opt.state.clear()
                for p, st in saved.items():
                    opt.state[p] = {k: _copy(v) for k, v in st.items()}
            for t, saved in self.items:
                t.copy_(saved)


def _result(out) -> List[torch.Tensor]:
    """Clones of every tensor a step returned (its params, aux, loss,
    skipped, health, and the MixState beside the optimizer)."""
    return [t.detach().clone() for t in _tensors(out, [], set())]


def _bit_equal(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a, b))


def _gap(a: List[torch.Tensor], b: List[torch.Tensor]) -> float:
    """max |a - b| over every float tensor (inf on a shape mismatch)."""
    if len(a) != len(b):
        return float("inf")
    gap = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return float("inf")
        if x.is_floating_point():
            gap = max(gap, float((x.double() - y.double()).abs().max())
                      if x.numel() else 0.0)
        elif not torch.equal(x, y):
            gap = max(gap, 1.0)
    return gap


def _identity_table(table) -> tuple:
    return tuple((torch.zeros_like(cw), torch.ones_like(sw))
                 for cw, sw in table)


def _random_table(table, seed: int = 3) -> tuple:
    """A row-stochastic table on the default table's edges: positive
    draws where a class weight is live, normalized per receiving rank
    with its self weight."""
    rng = np.random.RandomState(seed)
    out = []
    for cw, sw in table:
        live = cw.double().cpu().numpy() != 0.0
        c = np.where(live, rng.uniform(0.5, 1.5, live.shape), 0.0)
        s = rng.uniform(0.5, 1.5, tuple(sw.shape))
        total = s + c.sum(axis=0)
        out.append((torch.tensor(c / total, dtype=cw.dtype),
                    torch.tensor(s / total, dtype=sw.dtype)))
    return tuple(out)


def _write_table(dst, src) -> None:
    with torch.no_grad():
        for (cw, sw), (c2, s2) in zip(dst, src):
            cw.copy_(c2)
            sw.copy_(s2)


def _clone_table(table) -> tuple:
    return tuple((cw.clone(), sw.clone()) for cw, sw in table)


def _mix_matrix(spec, cw, sw) -> np.ndarray:
    """The dense [n, n] combine ``out[d] = sum_s M[d, s] x[s]`` of one
    round: self weights on the diagonal, class ``c``'s weight of ``d`` at
    its sender (the class order of ``class_recv_weights``)."""
    from bluefog_tpu_torch.parallel import collectives as C
    from bluefog_tpu_torch.topology.spec import Topology

    structure = spec if isinstance(spec, Topology) \
        else C.edge_structure(spec)
    cw = cw.double().cpu().numpy()
    M = np.diag(sw.double().cpu().numpy())
    for c, cls in enumerate(structure.shift_classes):
        for src, dst in cls.perm:
            M[dst, src] += cw[c, dst]
    return M


def _apply(M: np.ndarray, x: np.ndarray, local: int) -> np.ndarray:
    """``M`` over rank-major ``x`` (machine-level ``M`` over the machine
    means, broadcast back, with ``local`` ranks a machine)."""
    n = x.shape[0]
    rows = x.reshape(n, -1)
    if local > 1:
        rows = rows.reshape(n // local, local, -1).mean(axis=1)
    out = M @ rows
    if local > 1:
        out = np.repeat(out, local, axis=0)
    return out.reshape(x.shape)


def _machine_mean(x: np.ndarray, local: int) -> np.ndarray:
    if local <= 1:
        return x
    n = x.shape[0]
    m = x.reshape(n // local, local, -1).mean(axis=1)
    return np.repeat(m, local, axis=0).reshape(x.shape)


def _wire_step(compress) -> float:
    """The wire's grid step relative to max|x| (0 for an exact wire)."""
    if compress in ("int8", "int8_sr"):
        return 1.0 / 127.0
    if compress == "bf16":
        return 2.0 ** -8
    return 0.0


def check_step(step, args: Tuple, *, name: str,
               readings: Optional[dict] = None) -> List[Finding]:
    """Contract-check one built train step against its public call
    ``step(*args)`` (``args`` as the step takes them; a guarded step's
    last argument is its table).  The state in ``args`` is put back as
    it was.  ``readings``, when given, receives each rule's reading:
    ``dead_gap`` (max |identity run - default run|, > 0 when live),
    ``restore_gap`` (0 when the default table reproduces its run) and
    ``baked_ratio`` (the largest deviation from the W3 prediction over
    its bound, <= 1 when sound)."""
    from bluefog_tpu_torch.optim import functional as F

    findings: List[Finding] = []
    mode = getattr(step, "comm_mode", None)
    specs = tuple(getattr(step, "comm_specs", ()))
    default = getattr(step, "default_comm_weights", None)
    if not (mode in ("cta", "atc") and specs):
        return findings        # no neighbor weights to hold (JAX: n_w 0)
    if default is None:
        return [Finding("missing-weight-operand", name, 0, "comm_weights",
                        "the step has no default_comm_weights: its "
                        "combine weights are not runtime data")]
    want = F.comm_weight_inputs(specs)
    shapes = [(tuple(cw.shape), tuple(sw.shape)) for cw, sw in default]
    if shapes != [(tuple(cw.shape), tuple(sw.shape)) for cw, sw in want]:
        return [Finding(
            "missing-weight-operand", name, 0, "comm_weights",
            f"default_comm_weights shapes {shapes} are not "
            "comm_weight_inputs(specs)'s (weights not carried as "
            "comm_weight_inputs data)")]

    has_aux = bool(getattr(step, "has_aux", False))
    guarded = getattr(step, "guard_config", None) is not None
    params = args[0]
    state = tuple(args[:3 if has_aux else 2])
    moe = getattr(step, "moe_config", None)
    names = list(params)
    mixed = (F._moe_shared_mask(names, moe) if moe is not None
             else [True] * len(names))
    if all(bool((params[k] == params[k][:1]).all())
           for k, m in zip(names, mixed) if m):
        raise ValueError(
            f"{name}: every mixed leaf is equal across ranks, so any "
            "row-stochastic combine is the identity; give the ranks "
            "different state")
    r = int(args[4 if has_aux else 3]) % len(specs)
    x0 = {k: params[k].detach().double().cpu().numpy() for k in names}
    snap = _Snapshot(state)
    kept = _clone_table(default)

    def run(table):
        snap.restore()
        if guarded:
            out = step(*args[:-1], table)
        else:
            _write_table(default, table)
            out = step(*args)
        return _result(out), {k: out[0][k].detach().double().cpu().numpy()
                              for k in names}

    w3 = _random_table(kept)
    try:
        base, _ = run(_clone_table(kept))
        ident, x_i = run(_identity_table(kept))
        again, _ = run(_clone_table(kept))
        _, x_3 = run(w3)
    finally:
        if not guarded:
            _write_table(default, kept)
        snap.restore()

    dead_gap = _gap(base, ident)
    restore_gap = _gap(base, again)
    if _bit_equal(base, ident):
        findings.append(Finding(
            "dead-weight-operand", name, 0, "comm_weights",
            "the result under the identity table is bit-equal to the "
            "result under the default table: the combine is not reading "
            "the table it is given"))
    elif not _bit_equal(base, again):
        findings.append(Finding(
            "dead-weight-operand", name, 0, "restore",
            f"the default table written back does not reproduce its "
            f"first run (max gap {restore_gap:.3e}): the step kept a "
            "table from an earlier call"))

    ratio = 0.0
    compress = getattr(step, "compress", None)
    if getattr(step, "mix_config", None) is None:
        local = int(getattr(step, "hierarchical_local_size", None) or 1)
        M3 = _mix_matrix(specs[r], *w3[r])
        big = max(float(np.abs(x0[k]).max()) for k, m in zip(names, mixed)
                  if m)
        worst = None
        for k, m in zip(names, mixed):
            if mode == "atc":
                pred = _apply(M3, x_i[k], local) if m else x_i[k]
            else:
                pred = (x_i[k] + _apply(M3, x0[k], local)
                        - _machine_mean(x0[k], local)) if m else x_i[k]
            eps = float(torch.finfo(params[k].dtype).eps)
            scale = max(float(np.abs(x0[k]).max()),
                        float(np.abs(x_i[k]).max()),
                        float(np.abs(pred).max()))
            bound = BAKED_ULPS * eps * scale + _wire_step(compress) * big
            dev = float(np.abs(x_3[k] - pred).max()) if pred.size else 0.0
            q = dev / bound if bound > 0 else (0.0 if dev == 0 else np.inf)
            if q > ratio:
                ratio, worst = q, (k, dev, bound)
        if ratio > 1.0:
            k, dev, bound = worst
            findings.append(Finding(
                "baked-weight-const", name, 0, "comm_weights",
                f"under a third table, leaf {k!r} is {dev:.3e} from the "
                f"combine that table predicts (bound {bound:.3e}): the "
                "step combined with another table than the one it was "
                "given"))
    if readings is not None:
        readings.update(dead_gap=dead_gap, restore_gap=restore_gap,
                        baked_ratio=ratio)
    return findings


def baked_table_step(step) -> Callable:
    """A mutant of ``step`` that always combines with a copy of its
    build-time table, whatever table it is given (the bug the check
    exists for).  It keeps the step's attributes; an unguarded mutant's
    ``default_comm_weights`` are new tensors that its step never reads."""
    frozen = _clone_table(step.default_comm_weights)
    guarded = getattr(step, "guard_config", None) is not None

    def mutant(*args):
        if guarded:
            args = args[:-1] + (frozen,)
        return step(*args)

    mutant.__dict__.update(step.__dict__)
    if not guarded:
        mutant.default_comm_weights = _clone_table(frozen)
    return mutant


# --------------------------------------------------------------------- #
# the sweep: every program the port ships
# --------------------------------------------------------------------- #

def _problem(device="cpu"):
    base = {"w1": torch.tensor(np.random.RandomState(7).randn(4, 4) * .3,
                               dtype=torch.float32, device=device),
            "b1": torch.zeros(4, device=device),
            "w2": torch.tensor(np.random.RandomState(8).randn(4, 2) * .3,
                               dtype=torch.float32, device=device),
            "b2": torch.zeros(2, device=device)}

    def loss_fn(params, batch):
        h = torch.tanh(batch @ params["w1"] + params["b1"])
        return torch.mean((h @ params["w2"] + params["b2"]) ** 2)

    return base, loss_fn


def _weighted_ring():
    from bluefog_tpu_torch.topology.spec import Topology

    W = np.zeros((N_RANKS, N_RANKS))
    for r in range(N_RANKS):
        W[(r - 1) % N_RANKS, r] = 0.3
        W[(r + 1) % N_RANKS, r] = 0.1
        W[r, r] = 0.6
    return Topology.from_weight_matrix(W)


def _machine_ring():
    from bluefog_tpu_torch.topology.spec import Topology

    m = N_RANKS // 2
    W = np.zeros((m, m))
    for r in range(m):
        W[(r - 1) % m, r] = 0.3
        W[(r + 1) % m, r] = 0.1
        W[r, r] = 0.6
    return Topology.from_weight_matrix(W)


def _weighted_schedule():
    from bluefog_tpu_torch.topology.dynamic import one_peer_dynamic_schedule
    from bluefog_tpu_torch.topology.spec import DynamicTopology

    out = []
    for s in one_peer_dynamic_schedule(N_RANKS):
        out.append(DynamicTopology.from_edges(
            s.size, {e: 0.3 for e in s.edges}, [0.7] * s.size))
    return out


def sweep_cases() -> List[dict]:
    """The build_train_step configurations the sweep runs: JAX's matrix
    (``jaxpr_check.sweep_cases``) case for case -- guard x health x
    compress x comm_mode x overlap on the weighted static ring, the int8
    wire, push_sum, one-peer schedules, expert-parallel MoE and the
    hierarchical two-level exchange."""
    ring = _weighted_ring()
    cases: List[dict] = []
    for comm_mode in ("cta", "atc"):
        for overlap in ("none", "bucketed"):
            for guard in (False, True):
                for health in (False, True):
                    cases.append(dict(
                        comm_mode=comm_mode, overlap=overlap,
                        guard=guard, health=health, compress=None,
                        topology=ring))
        for guard in (False, True):
            cases.append(dict(comm_mode=comm_mode, overlap="bucketed",
                              guard=guard, health=True, compress="int8",
                              topology=ring))
    cases.append(dict(comm_mode="atc", overlap="none", guard=True,
                      health=True, compress="int8", topology=ring))
    cases.append(dict(comm_mode="cta", overlap="none", guard=False,
                      health=False, compress="topk", topology=ring))
    cases.append(dict(comm_mode="atc", overlap="bucketed", guard=True,
                      health=True, compress="topk", topology=ring))
    for overlap in ("none", "bucketed"):
        for health in (False, True):
            cases.append(dict(comm_mode="push_sum", overlap=overlap,
                              guard=False, health=health, compress=None,
                              topology=ring))
    cases.append(dict(comm_mode="atc", overlap="none", guard=False,
                      health=False, compress=None, schedule="one_peer"))
    cases.append(dict(comm_mode="atc", overlap="bucketed", guard=True,
                      health=True, compress=None, schedule="one_peer"))
    cases.append(dict(comm_mode="cta", overlap="none", guard=False,
                      health=False, compress=None, topology=ring,
                      moe=True))
    cases.append(dict(comm_mode="atc", overlap="none", guard=True,
                      health=True, compress=None, topology=ring,
                      moe=True))
    mring = _machine_ring()
    for comm_mode, overlap, guard, health, compress in (
            ("cta", "none", False, False, None),
            ("cta", "bucketed", True, True, None),
            ("atc", "none", True, False, None),
            ("atc", "bucketed", False, True, None),
            ("cta", "bucketed", True, True, "int8"),
            ("atc", "none", True, True, "int8"),
            ("cta", "none", False, False, "topk")):
        cases.append(dict(comm_mode=comm_mode, overlap=overlap,
                          guard=guard, health=health, compress=compress,
                          topology=mring, hierarchical=2))
    return cases


def case_id(c: dict) -> str:
    return "-".join([
        c["comm_mode"], c["overlap"],
        "guard" if c["guard"] else "noguard",
        "health" if c["health"] else "nohealth",
        c["compress"] or "fp",
        "hier" if "hierarchical" in c
        else ("sched" if "schedule" in c else "static")]
        + (["moe"] if c.get("moe") else []))


def _spread(tree: Dict[str, torch.Tensor], seed: int) -> None:
    """Give each rank its own state (seeded): a combine of equal rows
    reads no weight."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k in sorted(tree):
            v = tree[k]
            v.add_(torch.tensor(rng.randn(*v.shape) * _SPREAD,
                                dtype=v.dtype, device=v.device))


def _build(case: dict, backend):
    """(step, args) of one sweep case on ``backend``, the state
    rank-diverse."""
    from bluefog_tpu_torch.optim import functional as F

    dev = backend.device
    base, loss_fn = _problem(dev)
    c = dict(case)
    guarded = c.pop("guard")
    health = c.pop("health")
    push_sum = c["comm_mode"] == "push_sum"
    moe = c.pop("moe", False)
    rng = np.random.RandomState(11)
    if moe:
        from bluefog_tpu_torch.moe import (capacity_mask_of,
                                           default_route_table,
                                           dispatch_plan, init_moe_params,
                                           make_moe_loss)
        from bluefog_tpu_torch.topology.compiler import (PodSpec,
                                                         compile_all_to_all)

        plan = dispatch_plan(
            compile_all_to_all(PodSpec(4, N_RANKS // 4)).schedule)
        gen = torch.Generator(dev).manual_seed(0)
        params = init_moe_params(gen, 4, 4, 4, n_ranks=N_RANKS,
                                 device=dev)
        loss_fn = make_moe_loss(plan, backend, 2)
        c["moe"] = F.MoEConfig(n_experts=4, capacity=2)
        batch = (torch.tensor(rng.randn(N_RANKS, 3, 4), dtype=torch.float32,
                              device=dev),
                 torch.tensor(np.asarray(default_route_table(N_RANKS, 4)),
                              device=dev),
                 torch.tensor(np.broadcast_to(
                     capacity_mask_of(np.zeros(N_RANKS))[None],
                     (N_RANKS, N_RANKS)).copy(), device=dev))
    else:
        params = F.rank_major(base, backend)
        batch = torch.tensor(rng.randn(N_RANKS, 3, 4), dtype=torch.float32,
                             device=dev)
    _spread(params, 9)
    kwargs = dict(c)
    if kwargs.pop("overlap") != "none":
        kwargs.update(overlap="bucketed", overlap_buckets=3)
    if kwargs.get("compress") is None:
        kwargs.pop("compress")
    if kwargs.get("schedule") == "one_peer":
        kwargs["schedule"] = _weighted_schedule()
    if guarded:
        kwargs["guard"] = F.GuardConfig()
    if health:
        kwargs["health"] = F.HealthConfig()
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = F.build_train_step(loss_fn, opt, backend, **kwargs)
    ostate = opt
    if push_sum:
        ostate = (opt, F.push_sum_weights(backend))
    if getattr(step, "mix_config", None) is not None:
        ostate = (opt, step.init_mix_state(params))
    args = (params, ostate, batch, 0)
    if guarded:
        args = args + (step.default_comm_weights,)
    return step, args


def _build_and_check(case: dict, backend) -> List[Finding]:
    step, args = _build(case, backend)
    return check_step(step, args, name=f"step[{case_id(case)}]")


@contextlib.contextmanager
def _tally():
    """The exchange tally of what runs inside (``{kind: {"count",
    "bytes", "payloads", "groups"}}``), as ``profile_step`` keeps it."""
    from bluefog_tpu_torch.parallel import collectives as C

    C._exchange_tally = tally = {}
    try:
        yield tally
    finally:
        C._exchange_tally = None


def drop_one_permute(pred: dict) -> dict:
    """A tampered prediction (the mutant the contract must reject): one
    permute fewer in the period and in round 0."""
    out = dict(pred)
    out["permutes_per_period"] = pred["permutes_per_period"] - 1
    out["per_round"] = [dict(r) for r in pred["per_round"]]
    out["per_round"][0]["permutes"] -= 1
    out["bytes_per_period"] = float(sum(
        r["permutes"] * r["bytes_per_permute"] for r in out["per_round"]))
    return out


def check_collective_contracts(*, device="cuda",
                               tamper: Optional[Callable] = None
                               ) -> List[Finding]:
    """Run the topology compiler's scheduled programs under the exchange
    tally and hold them to ``predicted_collectives`` via
    ``verify_collective_contract``: the flat ``PodSpec(1, 8)`` schedule
    (its whole period, as ``build_train_step`` cycles it, and each
    round), the compiled MoE all-to-all of ``PodSpec(4, 2)`` (period and
    rounds) and the hierarchical ``PodSpec(4, 2)`` machine rounds.
    ``tamper`` (a prediction -> prediction function) is the planted
    fault's hook.  Runs on the card unless ``device="cpu"``."""
    from bluefog_tpu_torch import benchutil
    from bluefog_tpu_torch.moe import all_to_all_dispatch, dispatch_plan
    from bluefog_tpu_torch.parallel.collectives import StackedBackend
    from bluefog_tpu_torch.topology.compiler import (PodSpec,
                                                     compile_all_to_all,
                                                     compile_topology)

    device = resolve_device(device)
    tamper = tamper or (lambda p: p)
    backend = StackedBackend(N_RANKS, device=device)
    findings: List[Finding] = []

    def hold(tally, pred, payload, where, sym, round_index=None):
        for msg in benchutil.verify_collective_contract(
                tally, tamper(pred), payload, round_index=round_index):
            findings.append(Finding("collective-contract", where, 0, sym,
                                    msg))

    payload = 64 * 4
    x = torch.zeros((N_RANKS, 64), dtype=torch.float32, device=device)
    compiled = compile_topology(PodSpec(1, 8))
    pred = compiled.predicted_collectives(payload)
    with torch.no_grad():
        with _tally() as t:
            for rnd in compiled.schedule:
                backend.neighbor_allreduce(x, rnd)
        hold(t, pred, payload, "schedule[pod_1x8]", "period")
        for i, rnd in enumerate(compiled.schedule):
            with _tally() as t:
                backend.neighbor_allreduce(x, rnd)
            hold(t, pred, payload, "schedule[pod_1x8]", f"round_{i}", i)

        a2a = compile_all_to_all(PodSpec(4, 2))
        shard = torch.zeros((N_RANKS, N_RANKS, 16), dtype=torch.float32,
                            device=device)
        a2a_payload = 16 * 4
        apred = a2a.predicted_collectives(a2a_payload)
        with _tally() as t:
            all_to_all_dispatch(shard, dispatch_plan(a2a.schedule), backend)
        hold(t, apred, a2a_payload, "a2a[pod_4x2]", "period")
        for i, rnd in enumerate(a2a.schedule):
            with _tally() as t:
                all_to_all_dispatch(shard, dispatch_plan([rnd]), backend)
            hold(t, apred, a2a_payload, "a2a[pod_4x2]", f"round_{i}", i)

        hier = compile_topology(PodSpec(4, 2), hierarchical=True)
        hpred = hier.predicted_collectives(payload)
        for i, rnd in enumerate(hier.machine_schedule):
            with _tally() as t:
                backend.hierarchical_neighbor_allreduce(x, rnd,
                                                        hier.local_size)
            hold(t, hpred, payload, "hier[pod_4x2]", f"round_{i}", i)
    return findings


# --------------------------------------------------------------------- #
# serving residents
# --------------------------------------------------------------------- #

def copied_weights_engine(engine):
    """A mutant of ``engine`` whose decode program (the draft/verify step
    of a speculative engine) reads a copy of the weights taken now, at
    build, whatever is written into ``engine.model`` later."""
    frozen = copy.deepcopy(engine.model)
    name = "_decode_tokens" if engine._spec is None else "_spec_tokens"
    program = getattr(engine, name)

    def baked(*args):
        live = engine.model
        engine.model = frozen
        try:
            return program(*args)
        finally:
            engine.model = live

    setattr(engine, name, baked)
    return engine


def _run_program(fn, thunk) -> List[torch.Tensor]:
    """Run one resident program on fresh scratch state: every tensor it
    returned or wrote into its arguments."""
    with torch.no_grad():
        args = thunk()
        out = fn(*args)
    return _result((out,) + tuple(a for a in args
                                  if not isinstance(a, torch.nn.Module)))


def check_serving_residents(*, device="cuda", cfg=None, capacity: int = 2,
                            max_len: int = 48, prefill_chunk: int = 4,
                            lookahead: int = 2, seed: int = 1,
                            wrap: Optional[Callable] = None
                            ) -> List[Finding]:
    """Hold every resident program of a plain and a speculative
    (self-draft) ``ServingEngine`` to the weights-as-data contract: run
    it, write a second seeded model's weights into the engine's model in
    place, run it again, and require the output of a fresh engine built
    on the second weights bit for bit.  ``cfg`` defaults to JAX's
    ``LlamaConfig.tiny`` in f32; ``wrap`` (engine -> engine) is the
    planted fault's hook, applied to the engine under check only.  Runs
    on the card unless ``device="cpu"``."""
    from bluefog_tpu_torch.models.llama import Llama, LlamaConfig
    from bluefog_tpu_torch.serving.engine import (ServingEngine,
                                                  SpeculativeConfig)

    device = resolve_device(device)
    if cfg is None:
        cfg = LlamaConfig.tiny(dtype=torch.float32)
    pdt = torch.float32 if cfg.dtype == torch.float32 else None

    def model(s):
        kw = {} if pdt is None else dict(param_dtype=pdt)
        return Llama(cfg, device=device,
                     generator=torch.Generator(device).manual_seed(s), **kw)

    def engine(kind, m):
        spec = (SpeculativeConfig(variables=m, cfg=cfg, lookahead=lookahead)
                if kind == "spec_serving" else None)
        return ServingEngine(m, cfg, capacity=capacity, max_len=max_len,
                             prefill_chunk=prefill_chunk, speculative=spec,
                             device=device)

    findings: List[Finding] = []
    second = model(seed + 1)
    for kind in ("serving", "spec_serving"):
        eng = engine(kind, model(seed))
        if wrap is not None:
            eng = wrap(eng)
        progs = eng._resident()
        for fn, thunk in progs.values():
            _run_program(fn, thunk)
        with torch.no_grad():
            want = second.state_dict()
            for k, t in eng.model.state_dict().items():
                t.copy_(want[k])
        fresh = engine(kind, second)._resident()
        for prog, (fn, thunk) in progs.items():
            got = _run_program(fn, thunk)
            ref = _run_program(*fresh[prog])
            if not _bit_equal(got, ref):
                findings.append(Finding(
                    "baked-weight-const", f"{kind}[{prog}]", 0, "weights",
                    f"after new weights were written into the engine's "
                    f"model, the program's output is {_gap(got, ref):.3e} "
                    "from a fresh engine's on those weights: it read a "
                    "copy of the weights made at build"))
        del eng, fresh
    return findings


def run_sweep(*, include_serving: bool = True,
              include_collectives: bool = True,
              cases: Optional[Iterable[dict]] = None,
              device="cuda") -> List[Finding]:
    """The full step sweep: every train-step matrix point, the scheduled
    exchanges' collective contracts and the serving residents, on
    ``device`` (the card unless ``device="cpu"``).  Returns all findings
    (empty = every contract holds)."""
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    device = resolve_device(device)
    backend = StackedBackend(N_RANKS, device=device)
    findings: List[Finding] = []
    for case in (sweep_cases() if cases is None else cases):
        findings += _build_and_check(case, backend)
    if include_collectives:
        findings += check_collective_contracts(device=device)
    if include_serving:
        findings += check_serving_residents(device=device)
    return findings
