"""AST lint: the port's own rules, which no generic linter knows.

Port of ``bluefog_tpu/analysis/lint.py``.  The rules that read Python
source are the JAX package's, re-keyed from ``bluefog_tpu/`` to
``bluefog_tpu_torch/``:

``env-read-outside-config``
    ``os.environ`` / ``os.getenv`` anywhere in ``bluefog_tpu_torch/``
    outside ``config.py``.  Every knob goes through one audited accessor
    module, so one environment configures both packages and tests can
    monkeypatch one seam.
``host-sync-in-step``
    (JAX's ``host-sync-in-jit``.)  A torch program has no trace, so the
    rule means a host sync inside a body that runs on the device path:
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float`` /
    ``int`` / ``bool`` of a non-constant, ``np.asarray`` / ``np.array``
    and ``torch.cuda.synchronize()`` inside a function passed to
    ``torch.utils.checkpoint.checkpoint`` (JAX's ``remat``), to a
    ``torch.func`` transform, ``torch.compile`` or
    ``make_graphed_callables``, the body of a ``torch.cuda.graph``
    capture, or the ``forward`` / ``backward`` of a
    ``torch.autograd.Function`` (JAX's ``custom_vjp``), and their nested
    defs.  Each stalls the host on the device's queue; under a CUDA
    graph it cannot be captured at all.
``python-if-on-tensor``
    (JAX's ``python-if-on-traced``.)  An ``if`` in such a body whose
    test reads a parameter annotated ``torch.Tensor``, or calls one of
    the syncs above, or ``.any()`` / ``.all()``: a branch on a tensor's
    value is a host sync, and a captured graph keeps one branch.  Plain
    config arguments (``if causal:``) are not flagged.  JAX's
    ``divergent-cond`` has no rule of its own here: in an eager step a
    branch on a per-rank tensor is exactly this host sync.
``weight-matrix-bypass``
    Assigning a ``*comm_weights``-style name from a raw ndarray
    constructor outside the modules that own weight construction
    (marked ``_WEIGHT_AUTHORITY = True``).  Hand-rolled weight tables
    skip the row-stochastic normalization and shape contract of the
    shared helpers (``topology.spec`` / ``resilience.healing``).
``weight-swap-outside-boundary``
    In-place mutation of a live weight operand (``comm_weights[i] =
    ...``, ``class_weights += ...``) outside the sanctioned step-boundary
    swap helper (``topology.control.swap_comm_weights``) and outside
    ``_WEIGHT_AUTHORITY`` modules.  Topology changes arrive as whole
    replacement ``(class_weights, self_weights)`` pairs at a step
    boundary.
``unseeded-randomness``
    Legacy global-state ``np.random.*`` draws in the port's measuring
    script (``chip_smoke.py``; the port has no ``benchmarks/``): its
    numbers must replay from ``--seed``.
``unregistered-pytest-marker``
    ``pytest.mark.<name>`` in ``tests/`` not declared in
    ``pyproject.toml``: a typo'd marker silently deselects tests.
``sleep-without-backoff``
    ``time.sleep`` inside a loop under ``bluefog_tpu_torch/serving/``.
    Every serving retry loop sleeps through the seeded-backoff helper
    (``serving.resilience.backoff_sleep``).
``decision-outside-recorder``
    A control plane's state-transition method (``_DECISION_PLANE_METHODS``)
    that never emits through the decision flight recorder
    (``observe.blackbox.record_decision`` or a ``_decide`` wrapper).
``wallclock-in-sim``
    ``time.time()`` / ``time.monotonic()`` / ``time.perf_counter()``
    (and their ``_ns`` variants, however imported) under
    ``bluefog_tpu_torch/sim/``: every timestamp of the simulator comes
    from the injected ``VirtualClock`` (or an injected ``timer``).

Pure-syntactic: no imports of the scanned modules.  The semantic
complement, which runs the programs, is
:mod:`bluefog_tpu_torch.analysis.step_check`.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Set

from bluefog_tpu_torch.analysis import Finding

__all__ = ["run_lint", "lint_file", "registered_markers",
           "BUILTIN_MARKERS", "WEIGHT_NAME_RE", "WEIGHT_HELPERS"]

# --------------------------------------------------------------------- #
# shared vocabulary
# --------------------------------------------------------------------- #

# entry points whose function operands run on the device path as one
# body: the checkpointed function (JAX's remat/checkpoint), the
# torch.func transforms, torch.compile and make_graphed_callables.  A
# call counts when its dotted name ends with one of these (so
# torch.autograd.grad, which differentiates a tensor and takes no
# function, and re.compile stay out)
_TRACING_CALLS = {
    "checkpoint", "torch.compile", "make_graphed_callables",
    "func.vmap", "func.grad", "func.grad_and_value", "func.vjp",
    "func.jvp", "func.jacrev", "func.jacfwd", "func.hessian",
    "func.functionalize", "func.linearize", "torch.vmap",
}
# a `with` whose context call ends so captures its body (torch.cuda.graph)
_CAPTURE_CONTEXTS = {"cuda.graph"}
# the methods of a torch.autograd.Function subclass that run on the
# device path
_FUNCTION_METHODS = {"forward", "backward", "jvp", "vjp"}

# calls that sync the host with the device: methods, builtins of a
# non-constant, numpy constructors, and the dotted sync calls
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_BUILTINS = {"float", "int", "bool"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
_HOST_SYNC_NP_FNS = {"asarray", "array"}
_HOST_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
# reductions whose truth value, read by an `if`, syncs the host
_TRUTH_REDUCTIONS = {"any", "all"}

# legacy global-state numpy.random entry points (everything that is not
# an explicit generator/seed-container constructor draws from the
# shared hidden RandomState)
_SEEDED_RANDOM_OK = {
    "default_rng", "RandomState", "SeedSequence", "Generator",
    "PCG64", "Philox", "MT19937", "BitGenerator",
}

# markers pytest itself defines — always registered
BUILTIN_MARKERS = {
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings", "tryfirst", "trylast",
}

# a binding whose last path component matches this is "a comm-weight
# table" for the bypass rule.  MoE route tables and capacity masks are
# the same kind of communication-authority data (they steer the expert
# all-to-all the way comm weights steer the mixing wire), so they
# answer to the same rule.
WEIGHT_NAME_RE = re.compile(
    r"(^|_)((comm|class|self|recv|mix)_weights?"
    r"|route_tables?|capacity_masks?)$")

# sanctioned constructors: any call to one of these anywhere in the RHS
# means the value came through the shared row-stochastic machinery
WEIGHT_HELPERS = {
    "comm_weight_inputs", "default_comm_weights", "weights_for_round",
    "healed_comm_weights", "healed_hierarchical_comm_weights",
    "class_recv_weights", "self_weight_vector", "self_weights_of",
    "push_sum_weights", "grow_comm_weights", "row_stochastic",
    "neighbor_weights", "hierarchical_comm_weights",
    "default_route_table", "heal_route_table", "capacity_mask_of",
}

# the one sanctioned seam for replacing live weight operands mid-run:
# the step-boundary swap helper (topology.control).  Functions with
# these names may touch weight tables element-wise.
_SWAP_BOUNDARY_HELPERS = {"swap_comm_weights"}

# control-plane state-transition methods that must emit a decision
# record (the decision-outside-recorder rule): repo-relative module ->
# method/function names.  This is the sanctioned-callsite registry —
# adding a plane transition means adding it here AND wiring it through
# observe.blackbox.
_DECISION_PLANE_METHODS = {
    "bluefog_tpu_torch/topology/control.py": frozenset(
        {"on_step", "_synthesize", "force_candidate",
         "_mix_ladder_step", "plan_all_to_all"}),
    "bluefog_tpu_torch/elastic/membership.py": frozenset(
        {"admit", "promote", "kick", "mark_dead"}),
    "bluefog_tpu_torch/serving/fleet.py": frozenset({"poll", "submit"}),
    "bluefog_tpu_torch/serving/engine.py": frozenset({"drain"}),
    "bluefog_tpu_torch/serving/resilience.py": frozenset(
        {"failover_stranded"}),
    "bluefog_tpu_torch/resilience/healing.py": frozenset(
        {"healed_comm_weights"}),
    "bluefog_tpu_torch/moe/dispatch.py": frozenset({"heal_route_table"}),
    "bluefog_tpu_torch/sim/serving.py": frozenset({"_kill"}),
}

# a call with one of these terminal names counts as "emitted through
# the recorder": the blackbox API itself, or a plane's _decide wrapper
_DECISION_EMITTERS = {"record_decision", "_decide"}

# raw ndarray constructors that build a table from scratch
_RAW_CONSTRUCTORS = {
    "array", "asarray", "ones", "zeros", "full", "eye", "stack",
    "concatenate", "tile", "repeat", "ones_like", "zeros_like",
    "full_like",
}


def _last_attr(node: ast.expr) -> Optional[str]:
    """Terminal identifier of a Name / dotted Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted path ("torch.cuda.synchronize") for a Name/Attribute
    chain; "" when the chain includes calls/subscripts."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _ScopeTracker(ast.NodeVisitor):
    """Base visitor that maintains the enclosing-definition qualname,
    so findings carry a stable ``symbol``."""

    def __init__(self) -> None:
        self.scope: List[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _visit_scoped(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_scoped
    visit_AsyncFunctionDef = _visit_scoped
    visit_ClassDef = _visit_scoped


# --------------------------------------------------------------------- #
# rule: env-read-outside-config
# --------------------------------------------------------------------- #

class _EnvReadVisitor(_ScopeTracker):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: List[Finding] = []

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr == "environ" and _dotted(node) == "os.environ":
            self.findings.append(Finding(
                "env-read-outside-config", self.path, node.lineno,
                self.symbol,
                "os.environ accessed directly; route through a "
                "bluefog_tpu_torch.config accessor (or "
                "config.environ_passthrough for whole-env reads)"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if _dotted(node.func) in ("os.getenv", "os.environb"):
            self.findings.append(Finding(
                "env-read-outside-config", self.path, node.lineno,
                self.symbol,
                "os.getenv bypasses bluefog_tpu_torch.config; add an "
                "accessor there instead"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rules: host-sync-in-step + python-if-on-tensor
# --------------------------------------------------------------------- #

def _is_tracing_call(func: ast.expr) -> bool:
    name = _dotted(func)
    return bool(name) and any(name == t or name.endswith("." + t)
                              for t in _TRACING_CALLS)


def _collect_traced_names(tree: ast.AST) -> Set[str]:
    """Names of functions handed by reference to a device-path entry
    point: ``checkpoint(run, x)``, ``torch.func.vmap(f)``,
    ``torch.compile(step)``, ``make_graphed_callables(fn, args)``."""
    traced: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            if _is_tracing_call(node.func):
                operands: List[ast.expr] = list(node.args)
                for kw in node.keywords:
                    if kw.arg in ("function", "func", "model", "callables"):
                        operands.append(kw.value)
                for arg in operands:
                    if isinstance(arg, ast.Name):
                        traced.add(arg.id)
                    elif isinstance(arg, (ast.List, ast.Tuple)):
                        for el in arg.elts:
                            if isinstance(el, ast.Name):
                                traced.add(el.id)
            self.generic_visit(node)

    V().visit(tree)
    return traced


def _has_tracing_decorator(node) -> bool:
    for dec in node.decorator_list:
        target = dec
        # @partial(torch.func.vmap, ...) / @functools.partial(...)
        if isinstance(dec, ast.Call) and _last_attr(dec.func) == "partial" \
                and dec.args:
            target = dec.args[0]
        if isinstance(target, ast.Call):  # @torch.compile(mode=...)
            target = target.func
        if _is_tracing_call(target):
            return True
    return False


def _is_autograd_function(node: ast.ClassDef) -> bool:
    """A ``torch.autograd.Function`` subclass (``Function`` however
    imported)."""
    return any(_dotted(b) in ("torch.autograd.Function",
                              "autograd.Function", "Function")
               for b in node.bases)


def _tensor_params(args: ast.arguments) -> Set[str]:
    """Parameters annotated ``torch.Tensor`` (or ``Tensor``, or an
    ``Optional[...]`` of it)."""
    out: Set[str] = set()
    every = args.posonlyargs + args.args + args.kwonlyargs
    for a in every:
        ann = a.annotation
        if ann is None:
            continue
        for n in ast.walk(ann):
            if _dotted(n) in ("torch.Tensor", "Tensor"):
                out.add(a.arg)
                break
    return out


def _sync_call(node: ast.Call) -> Optional[str]:
    """What the call syncs, as the finding names it, or None."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in _HOST_SYNC_BUILTINS \
            and node.args and not isinstance(node.args[0], ast.Constant):
        return f"{f.id}()"
    if isinstance(f, ast.Attribute):
        if f.attr in _HOST_SYNC_METHODS and not node.args:
            return f".{f.attr}()"
        if f.attr in _HOST_SYNC_NP_FNS and isinstance(f.value, ast.Name) \
                and f.value.id in _NUMPY_ALIASES:
            return f"np.{f.attr}()"
    name = _dotted(f)
    if name and any(name == s or name.endswith("." + s)
                    for s in _HOST_SYNC_CALLS):
        return f"{name}()"
    return None


class _TracedBodyVisitor(_ScopeTracker):
    """Walks device-path bodies flagging host syncs and Python ``if``
    over tensors.  ``traced_depth`` > 0 while inside such a body (nested
    defs inherit it: they run inside it)."""

    def __init__(self, path: str, traced_names: Set[str]) -> None:
        super().__init__()
        self.path = path
        self.traced_names = traced_names
        self.traced_depth = 0
        self.function_class = 0   # inside an autograd.Function's body
        self.param_stack: List[Set[str]] = []
        self.findings: List[Finding] = []

    # -- scope management ------------------------------------------- #

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        fn = _is_autograd_function(node)
        self.function_class += fn
        self._visit_scoped(node)
        self.function_class -= fn

    def _function(self, node) -> None:
        own = (self.function_class > 0 and len(self.scope) > 0
               and node.name in _FUNCTION_METHODS)
        is_traced = (self.traced_depth > 0
                     or node.name in self.traced_names
                     or _has_tracing_decorator(node) or own)
        self.scope.append(node.name)
        if is_traced:
            self.traced_depth += 1
            self.param_stack.append(_tensor_params(node.args))
        outer, self.function_class = self.function_class, 0
        self.generic_visit(node)
        self.function_class = outer
        if is_traced:
            self.traced_depth -= 1
            self.param_stack.pop()
        self.scope.pop()

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    def visit_With(self, node: ast.With) -> None:
        capture = any(
            isinstance(item.context_expr, ast.Call)
            and any(_dotted(item.context_expr.func).endswith(c)
                    for c in _CAPTURE_CONTEXTS)
            for item in node.items)
        self.traced_depth += capture
        if capture:
            self.param_stack.append(set())
        self.generic_visit(node)
        if capture:
            self.param_stack.pop()
        self.traced_depth -= capture

    # -- host syncs -------------------------------------------------- #

    def visit_Call(self, node: ast.Call) -> None:
        if self.traced_depth > 0:
            what = _sync_call(node)
            if what:
                self.findings.append(Finding(
                    "host-sync-in-step", self.path, node.lineno,
                    self.symbol,
                    f"{what} inside a body on the device path waits for "
                    "the device (and cannot be captured in a CUDA "
                    "graph); keep the value a tensor"))
        self.generic_visit(node)

    # -- Python if over tensors -------------------------------------- #

    def visit_If(self, node: ast.If) -> None:
        if self.traced_depth > 0 and self.param_stack:
            params = self.param_stack[-1]
            why = None
            for n in ast.walk(node.test):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                        and n.id in params:
                    why = f"tensor parameter '{n.id}'"
                    break
                if isinstance(n, ast.Call):
                    if isinstance(n.func, ast.Attribute) \
                            and n.func.attr in _TRUTH_REDUCTIONS:
                        why = f".{n.func.attr}()"
                        break
                    sync = _sync_call(n)
                    if sync:
                        why = sync
                        break
            if why:
                self.findings.append(Finding(
                    "python-if-on-tensor", self.path, node.lineno,
                    self.symbol,
                    f"Python `if` on {why} inside a body on the device "
                    "path: the branch syncs the host (a captured graph "
                    "keeps one branch); select with torch.where, or "
                    "hoist the decision out of the step"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: weight-matrix-bypass
# --------------------------------------------------------------------- #

def _module_is_weight_authority(tree: ast.Module) -> bool:
    """True when the module declares ``_WEIGHT_AUTHORITY = True`` at
    top level — the opt-in marker for "this module is where weight
    tables are legitimately constructed from scratch"."""
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == "_WEIGHT_AUTHORITY":
                    return isinstance(stmt.value, ast.Constant) \
                        and stmt.value.value is True
    return False


class _WeightBypassVisitor(_ScopeTracker):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: List[Finding] = []

    def _check(self, targets: Iterable[ast.expr], value: ast.expr,
               lineno: int) -> None:
        names = [_last_attr(t) for t in targets]
        if not any(n and WEIGHT_NAME_RE.search(n) for n in names):
            return
        raw = sanctioned = False
        for node in ast.walk(value):
            if isinstance(node, ast.Call):
                tail = _last_attr(node.func)
                if tail in WEIGHT_HELPERS:
                    sanctioned = True
                elif tail in _RAW_CONSTRUCTORS:
                    raw = True
        if raw and not sanctioned:
            bound = next(n for n in names if n and WEIGHT_NAME_RE.search(n))
            self.findings.append(Finding(
                "weight-matrix-bypass", self.path, lineno, self.symbol,
                f"'{bound}' built from a raw ndarray constructor; use "
                "the shared row-stochastic helpers (topology.spec / "
                "resilience.healing) or mark the module "
                "_WEIGHT_AUTHORITY"))

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check(node.targets, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check([node.target], node.value, node.lineno)
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: weight-swap-outside-boundary
# --------------------------------------------------------------------- #

class _WeightSwapVisitor(_ScopeTracker):
    """Element-wise mutation of a live weight operand outside the
    sanctioned step-boundary swap helper.  Whole-name rebinding
    (``comm_weights = healed_comm_weights(...)``) is the delivery
    pattern and stays legal; ``comm_weights[0] = ...`` and
    ``class_weights += ...`` are not — they edit the operand the
    compiled step is already closed over, skipping projection/healing
    and risking rank desync mid-step."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: List[Finding] = []

    def _in_boundary(self) -> bool:
        return any(s in _SWAP_BOUNDARY_HELPERS for s in self.scope)

    def _weight_base(self, target: ast.expr) -> Optional[str]:
        base = target.value if isinstance(target, ast.Subscript) \
            else target
        name = _last_attr(base)
        if name and WEIGHT_NAME_RE.search(name):
            return name
        return None

    def _flag(self, name: str, lineno: int) -> None:
        self.findings.append(Finding(
            "weight-swap-outside-boundary", self.path, lineno,
            self.symbol,
            f"'{name}' mutated element-wise outside the step-boundary "
            "swap helper; live (class_weights, self_weights) operands "
            "must be replaced wholesale via "
            "topology.control.swap_comm_weights"))

    def visit_Assign(self, node: ast.Assign) -> None:
        if not self._in_boundary():
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = self._weight_base(t)
                    if name:
                        self._flag(name, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if not self._in_boundary():
            name = self._weight_base(node.target)
            if name:
                self._flag(name, node.lineno)
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: unseeded-randomness (chip_smoke.py)
# --------------------------------------------------------------------- #

class _UnseededRandomVisitor(_ScopeTracker):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) \
                and f.attr not in _SEEDED_RANDOM_OK:
            owner = _dotted(f.value)
            if owner in ("np.random", "numpy.random", "onp.random"):
                self.findings.append(Finding(
                    "unseeded-randomness", self.path, node.lineno,
                    self.symbol,
                    f"np.random.{f.attr} draws from hidden global "
                    "state; the measuring script must use an explicit "
                    "default_rng(seed) / RandomState(seed)"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: sleep-without-backoff (bluefog_tpu_torch/serving/)
# --------------------------------------------------------------------- #

class _SleepInLoopVisitor(_ScopeTracker):
    """``time.sleep`` inside a ``for``/``while`` under the serving
    package is a hand-rolled retry loop: it must go through
    ``serving.resilience.backoff_sleep`` (seeded, jittered,
    deterministic).  Injected sleeps (``self._sleep``, a ``sleep=``
    parameter) are fine — determinism is the caller's choice there."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.loop_depth = 0
        self.findings: List[Finding] = []

    def _loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _loop
    visit_AsyncFor = _loop
    visit_While = _loop

    def visit_Call(self, node: ast.Call) -> None:
        if self.loop_depth > 0 and _dotted(node.func) == "time.sleep":
            self.findings.append(Finding(
                "sleep-without-backoff", self.path, node.lineno,
                self.symbol,
                "time.sleep in a serving retry loop; use "
                "serving.resilience.backoff_sleep (seeded exponential "
                "backoff) so delays are deterministic and de-synced"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: wallclock-in-sim (bluefog_tpu_torch/sim/)
# --------------------------------------------------------------------- #

# time-module entry points that read the host clock
_WALLCLOCK_FNS = {
    "time", "monotonic", "perf_counter", "process_time",
    "time_ns", "monotonic_ns", "perf_counter_ns", "process_time_ns",
}


class _WallClockVisitor(_ScopeTracker):
    """Any host-clock read under the simulator package breaks the
    same-seed ⇒ byte-equal-event-log contract.  Both spellings are
    caught: ``time.perf_counter()`` and a bare ``perf_counter()``
    bound by ``from time import perf_counter [as alias]``.  Injected
    timers (a ``timer=`` parameter the caller passes from outside the
    package) are the sanctioned calibration seam."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.from_imports: Set[str] = set()
        self.findings: List[Finding] = []

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time":
            for alias in node.names:
                if alias.name in _WALLCLOCK_FNS:
                    self.from_imports.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        name = None
        if isinstance(f, ast.Attribute) and f.attr in _WALLCLOCK_FNS \
                and _dotted(f) == f"time.{f.attr}":
            name = _dotted(f)
        elif isinstance(f, ast.Name) and f.id in self.from_imports:
            name = f.id
        if name:
            self.findings.append(Finding(
                "wallclock-in-sim", self.path, node.lineno, self.symbol,
                f"{name}() reads the host clock inside the simulator; "
                "virtual time must come from the injected VirtualClock "
                "(or an injected timer= for calibration) so same-seed "
                "runs replay byte-equal"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# rule: decision-outside-recorder (control-plane modules)
# --------------------------------------------------------------------- #

def _decision_findings(tree: ast.Module, rel: str,
                       methods: Set[str]) -> List[Finding]:
    """Flag every function/method in ``methods`` whose body (nested
    defs included) never calls a ``_DECISION_EMITTERS`` name.  The
    check is name-anchored, not class-anchored, so fixtures and
    refactors keep working; a method that delegates to a ``_decide``
    wrapper passes (the wrapper is the plane's sanctioned seam)."""
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        if node.name not in methods:
            continue
        emits = any(
            isinstance(n, ast.Call)
            and _last_attr(n.func) in _DECISION_EMITTERS
            for n in ast.walk(node))
        if not emits:
            findings.append(Finding(
                "decision-outside-recorder", rel, node.lineno,
                node.name,
                f"control-plane transition '{node.name}' never emits "
                "through the decision flight recorder; record it via "
                "observe.blackbox.record_decision (or the plane's "
                "_decide wrapper) so the transition stays auditable"))
    return findings


# --------------------------------------------------------------------- #
# rule: unregistered-pytest-marker (tests/)
# --------------------------------------------------------------------- #

def registered_markers(root: str) -> Set[str]:
    """Markers declared in ``[tool.pytest.ini_options] markers`` of the
    repo's pyproject.toml, parsed textually (python 3.10: no tomllib;
    the markers block is a simple list of ``"name: description"``
    strings)."""
    path = os.path.join(root, "pyproject.toml")
    if not os.path.exists(path):
        return set()
    text = open(path).read()
    m = re.search(r"^markers\s*=\s*\[(.*?)\]", text,
                  re.MULTILINE | re.DOTALL)
    if not m:
        return set()
    body = m.group(1)
    # TOML strings; try double-quoted first (apostrophes inside
    # descriptions must not act as delimiters), else single-quoted
    entries = re.findall(r'"([^"]*)"', body) \
        or re.findall(r"'([^']*)'", body)
    return {entry.split(":", 1)[0].strip() for entry in entries}


class _MarkerVisitor(_ScopeTracker):
    def __init__(self, path: str, known: Set[str]) -> None:
        super().__init__()
        self.path = path
        self.known = known | BUILTIN_MARKERS
        self.findings: List[Finding] = []

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # pytest.mark.<name>, possibly called: pytest.mark.foo(...)
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "mark" \
                and _dotted(v) == "pytest.mark" \
                and node.attr not in self.known:
            self.findings.append(Finding(
                "unregistered-pytest-marker", self.path, node.lineno,
                self.symbol,
                f"marker '{node.attr}' is not declared in "
                "pyproject.toml [tool.pytest.ini_options] markers"))
        self.generic_visit(node)


# --------------------------------------------------------------------- #
# drivers
# --------------------------------------------------------------------- #

def lint_file(path: str, rel: str, *, markers: Set[str],
              in_package: bool, in_benchmarks: bool,
              in_tests: bool,
              in_serving: Optional[bool] = None,
              in_sim: Optional[bool] = None,
              plane_methods: Optional[Set[str]] = None) -> List[Finding]:
    """All findings for one file.  ``rel`` is the repo-relative posix
    path recorded on the findings; the ``in_*`` flags select which rule
    families apply (set by :func:`run_lint` from the file's location).
    ``in_serving`` / ``in_sim`` default from ``rel`` (files under
    ``bluefog_tpu_torch/serving/`` / ``bluefog_tpu_torch/sim/``); pass them
    explicitly to force the rule on a fixture.  ``plane_methods``
    defaults from ``_DECISION_PLANE_METHODS[rel]`` (empty elsewhere);
    pass a method-name set explicitly to force the
    decision-outside-recorder rule on a fixture."""
    try:
        tree = ast.parse(open(path).read(), filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", rel, e.lineno or 0, "<module>",
                        f"file does not parse: {e.msg}")]
    if in_serving is None:
        in_serving = rel.startswith("bluefog_tpu_torch/serving/")
    if in_sim is None:
        in_sim = rel.startswith("bluefog_tpu_torch/sim/")
    if plane_methods is None:
        plane_methods = _DECISION_PLANE_METHODS.get(rel, frozenset())
    findings: List[Finding] = []
    if plane_methods:
        findings += _decision_findings(tree, rel, plane_methods)
    if in_package:
        if os.path.basename(path) != "config.py":
            v = _EnvReadVisitor(rel)
            v.visit(tree)
            findings += v.findings
        tv = _TracedBodyVisitor(rel, _collect_traced_names(tree))
        tv.visit(tree)
        findings += tv.findings
        if not _module_is_weight_authority(tree):
            wv = _WeightBypassVisitor(rel)
            wv.visit(tree)
            findings += wv.findings
            ws = _WeightSwapVisitor(rel)
            ws.visit(tree)
            findings += ws.findings
    if in_serving:
        sv = _SleepInLoopVisitor(rel)
        sv.visit(tree)
        findings += sv.findings
    if in_sim:
        cv = _WallClockVisitor(rel)
        cv.visit(tree)
        findings += cv.findings
    if in_benchmarks:
        rv = _UnseededRandomVisitor(rel)
        rv.visit(tree)
        findings += rv.findings
    if in_tests:
        mv = _MarkerVisitor(rel, markers)
        mv.visit(tree)
        findings += mv.findings
    return findings


def _py_files(base: str):
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def run_lint(root: str) -> List[Finding]:
    """Lint the checkout at ``root``: ``bluefog_tpu_torch/`` (package
    rules), ``tests/`` (marker rule) and ``chip_smoke.py`` (randomness
    rule).  What is missing is skipped, so the lint also works on an
    installed package tree."""
    markers = registered_markers(root)
    findings: List[Finding] = []
    scans = [("bluefog_tpu_torch", dict(in_package=True,
                                        in_benchmarks=False,
                                        in_tests=False)),
             ("tests", dict(in_package=False, in_benchmarks=False,
                            in_tests=True)),
             ("chip_smoke.py", dict(in_package=False, in_benchmarks=True,
                                    in_tests=False))]
    for sub, flags in scans:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            paths = [base]
        elif os.path.isdir(base):
            paths = list(_py_files(base))
        else:
            continue
        for path in paths:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            findings += lint_file(path, rel, markers=markers, **flags)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
