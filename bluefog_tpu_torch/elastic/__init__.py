"""Elastic fleet membership: ranks that join, not just die.

Port of ``bluefog_tpu.elastic``, exporting what the JAX package's does.
The resilience stack (``bluefog_tpu_torch.resilience``) excises dead
ranks by re-planning mixing weights; this package closes the loop with
the growth direction — the full LIVE -> DEAD -> JOINING -> LIVE
lifecycle, all of it delivered as weight DATA into one guarded step
built at max fleet size:

* :mod:`~bluefog_tpu_torch.elastic.membership` — the
  :class:`MembershipController` state machine, and
  :func:`grow_weights`: the exact inverse of ``healing.heal_weights``
  (re-planned from the pristine spec, so ``heal -> grow`` round-trips
  byte-equal and stays row-stochastic at every step);
* :mod:`~bluefog_tpu_torch.elastic.bootstrap` — a joiner syncs params/opt
  state by pulled neighbor averaging only: its self-weight anneals
  0 -> w over a few quarantined mixing rounds, no global broadcast;
* the runner integration —
  ``run_resilient(elastic=ElasticConfig(...))`` admits joiners between
  steps, quarantines them until bootstrap disagreement clears the
  threshold, and emits ``bf_elastic_*`` events/gauges.
"""

from bluefog_tpu_torch.elastic.membership import (  # noqa: F401
    DEAD,
    JOINING,
    LIVE,
    ElasticConfig,
    MembershipController,
    grow_spec,
    grow_weights,
    grown_comm_weights,
)
from bluefog_tpu_torch.elastic.bootstrap import (  # noqa: F401
    anneal_fraction,
    bootstrap_comm_weights,
    bootstrap_weights,
    disagreement,
    sanitize_rank_rows,
    zero_rank_rows,
)

__all__ = [
    "LIVE",
    "DEAD",
    "JOINING",
    "ElasticConfig",
    "MembershipController",
    "grow_spec",
    "grow_weights",
    "grown_comm_weights",
    "anneal_fraction",
    "bootstrap_comm_weights",
    "bootstrap_weights",
    "disagreement",
    "sanitize_rank_rows",
    "zero_rank_rows",
]
