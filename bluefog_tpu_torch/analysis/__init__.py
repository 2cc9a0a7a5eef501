"""The port's contract checker: a lint of the port's source and a step
check that runs the port's programs.

Port of ``bluefog_tpu/analysis``.  The JAX package checks two framework
contracts before anything executes; the port checks the same two, and
adds none:

* **weights-as-data** -- comm weights, dead/membership masks and health
  tables reach a built step as runtime data that the step reads at every
  call, never as a copy taken at build time.  In the port this is what
  ``run_resilient`` and ``swap_comm_weights`` rely on when they deliver
  a new table to one step object (``topology/control.py``), and what a
  CUDA graph's captured buffers need.
* **collective contract** -- the exchanges a program runs are exactly
  the ones its schedule predicts (``predicted_collectives``).

Two passes:

* :mod:`bluefog_tpu_torch.analysis.step_check` -- JAX's
  ``jaxpr_check``.  A torch program has no jaxpr, so the check runs the
  programs: the ``build_train_step`` matrix from clones of one state
  under three weight tables, the scheduled exchanges under the exchange
  tally, and the serving engine's resident programs after an in-place
  weight swap.
* :mod:`bluefog_tpu_torch.analysis.lint` -- an AST lint over
  ``bluefog_tpu_torch/``, ``tests/`` and ``chip_smoke.py``.

JAX's rules and the port's:

=============================  ==========================================
JAX rule                       port rule
=============================  ==========================================
``env-read-outside-config``    the same, over ``bluefog_tpu_torch/``
``weight-matrix-bypass``       the same
``weight-swap-outside-         the same
boundary``
``sleep-without-backoff``      the same, over ``bluefog_tpu_torch/serving/``
``wallclock-in-sim``           the same, over ``bluefog_tpu_torch/sim/``
``decision-outside-recorder``  the same, its registry keyed to the port's
                               paths
``unregistered-pytest-marker`` the same, over all of ``tests/``
``unseeded-randomness``        the same, over ``chip_smoke.py`` (the port
                               has no ``benchmarks/``)
``host-sync-in-jit``           ``host-sync-in-step``: a host sync inside a
                               body on the device path (checkpointed,
                               ``torch.func``-transformed, compiled or
                               graph-captured functions and the
                               ``forward``/``backward`` of an
                               ``autograd.Function``)
``python-if-on-traced``        ``python-if-on-tensor``: an ``if`` in such
                               a body that reads a ``torch.Tensor``
                               parameter or syncs
``missing-weight-operand``     the same, in ``step_check``: the step's
                               ``default_comm_weights`` absent or of
                               other shapes than ``comm_weight_inputs``
``dead-weight-operand``        the same: the step's result under the
                               identity table is its result under the
                               default table
``baked-weight-const``         the same: the result under a third table
                               is not the combine that table predicts; a
                               serving program that reads a copy of the
                               weights made at build
``collective-contract``        the same, over the exchange tally
``divergent-cond``             none: an eager step has no traced
                               ``cond``; its branch on a per-rank tensor
                               is the host sync ``python-if-on-tensor``
                               flags
=============================  ==========================================

Vetted exceptions live in the committed ``baseline.txt`` next to this
file, keyed on ``rule path::symbol`` (no line numbers), each with the
comment that says why.

CLI: ``python -m bluefog_tpu_torch.analysis`` runs both passes and
exits 1 on any finding the baseline does not suppress.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Sequence, Tuple

__all__ = ["Finding", "baseline_path", "load_baseline",
           "split_suppressed", "format_findings", "default_root"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``key()`` deliberately omits the line number: a baseline entry must
    keep suppressing the same (rule, file, symbol) finding across
    unrelated edits, and must NOT silently absorb a second finding of
    the same rule elsewhere in the file.
    """

    rule: str      # e.g. "env-read-outside-config"
    path: str      # repo-relative posix path, or the program name for
                   # step-check findings (e.g. "step[atc-none-guard-health-fp-static]")
    line: int      # 1-based; 0 when not tied to source text
    symbol: str    # enclosing function/class qualname, or the checked
                   # sub-contract for step-check findings
    message: str

    def key(self) -> str:
        return f"{self.rule} {self.path}::{self.symbol}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.symbol}: {self.message}"


def baseline_path() -> str:
    """The committed baseline-suppression file shipped with the
    package."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def load_baseline(path: str = None) -> List[str]:
    """Suppression keys from a baseline file: one ``rule path::symbol``
    per line; blank lines and ``#`` comments (full-line or trailing)
    ignored.  Missing file = empty baseline."""
    if path is None:
        path = baseline_path()
    keys: List[str] = []
    if not os.path.exists(path):
        return keys
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                keys.append(line)
    return keys


def split_suppressed(
        findings: Iterable[Finding],
        baseline: Sequence[str]) -> Tuple[List[Finding], List[Finding]]:
    """``(active, suppressed)`` — a finding is suppressed iff its
    ``key()`` appears verbatim in the baseline."""
    allowed = set(baseline)
    active, suppressed = [], []
    for f in findings:
        (suppressed if f.key() in allowed else active).append(f)
    return active, suppressed


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def default_root() -> str:
    """Repo root to scan: the cwd when it holds a ``pyproject.toml``
    (the normal checkout invocation), else the tree this package was
    imported from."""
    if os.path.exists(os.path.join(os.getcwd(), "pyproject.toml")):
        return os.getcwd()
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
