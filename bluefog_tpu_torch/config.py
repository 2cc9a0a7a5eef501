"""Environment-variable configuration of the port.

Port of ``bluefog_tpu/config.py``, cut to the knobs the port reads
(the serving engine's slot pool and prefix cache, the fleet router's
staleness guard, retries and cooldown, the straggler detector's
threshold, the observe switch, the decision flight recorder, the
timeline writers, the elastic membership policy, the knobs
``build_train_step`` reads, the MoE capacity factor, and the eager op
layer's: logging, the timeline path, fusion, the stall watchdog, the op
timeout, ``BLUEFOG_OPS_ON_CPU``, and the launcher's job: the process
identity, ranks per process and the group's timeout; and the topology
control plane's re-plan knobs; ``ibfrun``'s engine token and state
directory, and ``benchutil``'s card-figure overrides).  The
environment-variable names and defaults are the JAX package's, so one
environment configures both packages.  Every environment read of the
port lives in this module.
"""

from __future__ import annotations

import os

__all__ = [
    "log_level",
    "log_hide_time",
    "log_format",
    "timeline_path",
    "fusion_threshold",
    "skip_negotiate_default",
    "stall_warning_time",
    "op_timeout",
    "ops_on_cpu",
    "coordinator",
    "num_processes",
    "process_id",
    "local_process_id",
    "ranks_per_process",
    "process_group_timeout",
    "environ_passthrough",
    "observe",
    "observe_raw",
    "timeline_flush_every",
    "timeline_queue_capacity",
    "timeline_native",
    "kv_zero_on_free",
    "prefix_cache_mb",
    "replica_stale_s",
    "router_retries",
    "router_retry_base_s",
    "router_cooldown_s",
    "straggler_z_threshold",
    "blackbox_enabled",
    "blackbox_capacity",
    "blackbox_dump_dir",
    "fuse_epilogues",
    "hier_local_size",
    "mix_compress",
    "mix_compress_ratio",
    "moe_capacity_factor",
    "elastic_bootstrap_rounds",
    "elastic_quarantine_threshold",
    "topology_replan_window",
    "topology_replan_patience",
    "topology_replan_degrade_ratio",
    "topology_replan_margin",
    "topology_replan_cooldown",
    "topology_replan_probation",
    "engine_token",
    "state_dir",
    "chip_peak_tflops_override",
    "chip_hbm_gbps_override",
]


def _env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def log_level() -> str:
    """BLUEFOG_LOG_LEVEL: trace|debug|info|warn|error|fatal (reference
    logging.h:75, docs/env_variable.rst:9-16)."""
    return _env("BLUEFOG_LOG_LEVEL", "warn").lower()


def log_hide_time() -> bool:
    """BLUEFOG_LOG_HIDE_TIME (reference logging.h:76)."""
    return _env("BLUEFOG_LOG_HIDE_TIME", "0") in ("1", "true", "True")


def log_format() -> str:
    """BLUEFOG_LOG_FORMAT: ``text`` (default, human-readable) or
    ``json`` — one JSON object per line with rank/timestamp/level, the
    shape log aggregators ingest without a parse rule."""
    return _env("BLUEFOG_LOG_FORMAT", "text").lower()


def timeline_path() -> str:
    """BLUEFOG_TIMELINE: path prefix for per-process Chrome-trace files
    (reference operations.cc:464-473); ``bf.init`` starts the timeline
    when it is set."""
    return _env("BLUEFOG_TIMELINE", "")


def fusion_threshold() -> int:
    """BLUEFOG_FUSION_THRESHOLD: max bytes of per-rank payload packed into
    one flat fusion buffer by the eager optimizers' communication
    (reference operations.cc:42-44 default 8 MB + tensor_queue.h:75-124).
    0 disables fusion (one collective per parameter leaf)."""
    return int(_env("BLUEFOG_FUSION_THRESHOLD", str(8 * 1024 * 1024)))


def skip_negotiate_default() -> bool:
    """BLUEFOG_SKIP_NEGOTIATE_STAGE — there is no negotiation stage on
    the stacked backend; the flag is kept so scripts that set it keep
    working (reference operations.cc:1149-1183)."""
    return _env("BLUEFOG_SKIP_NEGOTIATE_STAGE", "0") in ("1", "true", "True")


def stall_warning_time() -> float:
    """BLUEFOG_STALL_WARNING_TIME (seconds, default 60; <=0 disables) — how
    long a blocking wait may run before the stall watchdog logs a warning
    (reference STALL_WARNING_TIME operations.cc:47, watchdog :388-433)."""
    try:
        return float(_env("BLUEFOG_STALL_WARNING_TIME", "60"))
    except ValueError:
        return 60.0


def op_timeout() -> float:
    """BLUEFOG_OP_TIMEOUT (seconds, default 0; <=0 disables) — hard ceiling
    on any blocking wait (synchronize/barrier/win_wait/win_fence).  Where
    the stall watchdog only *warns* (BLUEFOG_STALL_WARNING_TIME), this
    RAISES ``BluefogError`` naming the stalled op, so a wedged wait fails
    fast instead of hanging the job forever."""
    try:
        return float(_env("BLUEFOG_OP_TIMEOUT", "0"))
    except ValueError:
        return 0.0


def ops_on_cpu() -> bool:
    """BLUEFOG_OPS_ON_CPU — run the eager ops on the host CPU instead of
    the card (reference torch/mpi_ops.cc:48-50).  An explicit request for
    ``device="cpu"``, never a fallback: ``bf.init`` reads it only when the
    caller passed no ``device=``."""
    return _env("BLUEFOG_OPS_ON_CPU", "0") in ("1", "true", "True")


def coordinator() -> str:
    """BLUEFOG_TPU_COORDINATOR: ``host:port`` of the multi-process job
    ``bfrun`` launched; empty when not launched by bfrun (one process)."""
    return _env("BLUEFOG_TPU_COORDINATOR", "")


def num_processes() -> int:
    """BLUEFOG_TPU_NUM_PROCESSES (default 1): job size bfrun exported."""
    try:
        return int(_env("BLUEFOG_TPU_NUM_PROCESSES", "1"))
    except ValueError:
        return 1


def process_id():
    """BLUEFOG_TPU_PROCESS_ID as an int, or ``None`` when unset (or
    unparsable); the log formatter falls back to rank 0."""
    raw = _env("BLUEFOG_TPU_PROCESS_ID", "")
    try:
        return int(raw)
    except ValueError:
        return None


def local_process_id() -> int:
    """BLUEFOG_TPU_LOCAL_PROCESS_ID: this process's index among the
    processes bfrun started on its host (its card is ``cuda:<index>``);
    defaults to BLUEFOG_TPU_PROCESS_ID, then 0."""
    raw = _env("BLUEFOG_TPU_LOCAL_PROCESS_ID", "")
    try:
        return int(raw)
    except ValueError:
        return process_id() or 0


def ranks_per_process() -> int:
    """BLUEFOG_TPU_RANKS_PER_PROCESS (default 1): the ranks each process
    of a bfrun job stacks on its device (``bfrun --force-cpu-devices K``
    sets K)."""
    try:
        return max(1, int(_env("BLUEFOG_TPU_RANKS_PER_PROCESS", "1")))
    except ValueError:
        return 1


def process_group_timeout() -> float:
    """BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT seconds (default 600): how long
    joining a job and every collective of its ``torch.distributed`` group
    may wait before raising."""
    try:
        return float(_env("BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT", "600"))
    except ValueError:
        return 600.0


def environ_passthrough(base=None) -> dict:
    """Snapshot of the process environment (or ``base`` when given) for
    the launcher's pass-through forwarding: bfrun filters it by
    ``PASS_PREFIXES`` when it builds a child's or a remote host's
    environment.  The one whole-environment read outside the named
    accessors, kept here so the environment surface stays auditable."""
    return dict(os.environ if base is None else base)


def observe() -> bool:
    """BLUEFOG_OBSERVE (default on): whether the built-in publishers
    write into the observability registry/tracer
    (:mod:`bluefog_tpu_torch.observe`).  ``0`` opts out."""
    return observe_raw()


def observe_raw() -> bool:
    """The raw BLUEFOG_OBSERVE read.
    :func:`bluefog_tpu_torch.observe.registry.enabled` is the public gate
    the publishers call; it delegates here so the environment access
    itself lives in this module."""
    return _env("BLUEFOG_OBSERVE", "1") not in ("0", "false", "False")


def timeline_flush_every() -> int:
    """BLUEFOG_TIMELINE_FLUSH_EVERY (default 1024): every this many
    events drained by the Python timeline writer, the accumulated drop
    count flushes to the ``bf_timeline_dropped_events`` gauge."""
    try:
        return max(1, int(_env("BLUEFOG_TIMELINE_FLUSH_EVERY", "1024")))
    except ValueError:
        return 1024


def timeline_queue_capacity() -> int:
    """BLUEFOG_TIMELINE_QUEUE_CAPACITY (default 65536): bound of the
    Python timeline writer's event queue.  A full queue drops the event
    and counts it."""
    try:
        return max(1, int(_env("BLUEFOG_TIMELINE_QUEUE_CAPACITY",
                               "65536")))
    except ValueError:
        return 65536


def timeline_native() -> bool:
    """BLUEFOG_TIMELINE_NATIVE (default on): prefer the C++ lock-free
    ring writer (:mod:`bluefog_tpu_torch.native`) when it builds; ``0``
    forces the Python queue backend."""
    return _env("BLUEFOG_TIMELINE_NATIVE", "1") != "0"


def kv_zero_on_free() -> bool:
    """BLUEFOG_KV_ZERO_ON_FREE (default OFF): whether
    :meth:`bluefog_tpu_torch.serving.SlotPool.free` zeroes a freed
    slot's whole K/V cache.  Off, only the slot's cache index resets,
    which is all reuse needs for exactness (everything above the index
    is masked and overwritten as the next request writes)."""
    return _env("BLUEFOG_KV_ZERO_ON_FREE", "0") in ("1", "true", "True")


def prefix_cache_mb() -> int:
    """BLUEFOG_PREFIX_CACHE_MB (default 64): host-side byte budget of the
    serving prefix cache (:mod:`bluefog_tpu_torch.serving.prefix_cache`),
    in MiB.  K/V chunks of prompts are retained up to this bound (LRU) so
    requests sharing a prompt prefix admit by copying cached chunks
    instead of re-running prefill.  0 disables retention."""
    try:
        return int(_env("BLUEFOG_PREFIX_CACHE_MB", "64"))
    except ValueError:
        return 64


def replica_stale_s() -> float:
    """BLUEFOG_REPLICA_STALE_S (seconds, default 0 = disabled): serving
    fleet staleness guard.  A replica that has not published a step
    heartbeat (``bf_serving_last_step_ts``) within this window is marked
    *suspect* by :class:`bluefog_tpu_torch.serving.FleetRouter` — its
    gossip row is masked out and its score pinned to +inf, exactly like
    the explicit dead-mask path — until it steps again.  Replicas that
    have never stepped are exempt (cold replicas must stay routable)."""
    try:
        return float(_env("BLUEFOG_REPLICA_STALE_S", "0"))
    except ValueError:
        return 0.0


def router_retries() -> int:
    """BLUEFOG_ROUTER_RETRIES (default 0): extra full-fleet walks
    :meth:`FleetRouter.submit` makes after the first walk exhausts every
    live replica, separated by seeded exponential backoff
    (:func:`bluefog_tpu_torch.serving.resilience.backoff_sleep`).  0
    keeps the single-walk behavior: one pass, then ``FleetSaturated``."""
    try:
        return max(0, int(_env("BLUEFOG_ROUTER_RETRIES", "0")))
    except ValueError:
        return 0


def router_retry_base_s() -> float:
    """BLUEFOG_ROUTER_RETRY_BASE_S (seconds, default 0.05): base delay of
    the router's seeded exponential backoff between submit retry walks
    (attempt k sleeps ~ base * 2**k, jittered deterministically from the
    router seed and request id)."""
    try:
        return float(_env("BLUEFOG_ROUTER_RETRY_BASE_S", "0.05"))
    except ValueError:
        return 0.05


def router_cooldown_s() -> float:
    """BLUEFOG_ROUTER_COOLDOWN_S (seconds, default 0 = disabled): after a
    replica rejects repeated submits, the router demotes it to the back
    of the candidate walk for this long.  Cooldown only re-orders the
    walk — a cooling replica is still tried last, so cooldown can never
    manufacture a ``FleetSaturated`` on its own."""
    try:
        return float(_env("BLUEFOG_ROUTER_COOLDOWN_S", "0"))
    except ValueError:
        return 0.0


def straggler_z_threshold() -> float:
    """BLUEFOG_STRAGGLER_Z (default 4.0): robust step-time z-score above
    which :class:`~bluefog_tpu_torch.observe.fleet.StragglerDetector`
    counts a rank as slow (flagged after ``patience`` consecutive
    observations)."""
    try:
        return float(_env("BLUEFOG_STRAGGLER_Z", "4.0"))
    except ValueError:
        return 4.0


def blackbox_enabled() -> bool:
    """BLUEFOG_BLACKBOX (default on): whether the control planes record
    into the process-global decision flight recorder
    (:mod:`bluefog_tpu_torch.observe.blackbox`).  ``0`` opts out; the
    recorder is host-side only, so results are the same either way."""
    return _env("BLUEFOG_BLACKBOX", "1") not in ("0", "false", "False")


def blackbox_capacity() -> int:
    """BLUEFOG_BLACKBOX_CAPACITY (default 4096): bound of the decision
    flight recorder's event ring.  At capacity the oldest event is
    evicted and counted (``bf_blackbox_dropped_events``); the streaming
    chain digest is unaffected by eviction."""
    try:
        return max(1, int(_env("BLUEFOG_BLACKBOX_CAPACITY", "4096")))
    except ValueError:
        return 4096


def blackbox_dump_dir() -> str:
    """BLUEFOG_BLACKBOX_DUMP: directory the recorder dumps its ring into
    (one JSONL file per anomaly kind) when an anomaly is recorded.  Empty
    (the default) disables the file dump."""
    return _env("BLUEFOG_BLACKBOX_DUMP", "")


def fuse_epilogues() -> bool:
    """BLUEFOG_FUSE_EPILOGUES (default on): whether
    :func:`bluefog_tpu_torch.optim.functional.build_train_step` builds
    the fused per-bucket epilogue pipeline (the guard's isfinite reduce,
    the health norms and the consensus distance taken per bucket from the
    exchange's own buffers).  ``0`` selects the JAX package's pre-fusion
    arithmetic order (the health reductions walk the whole param tree
    after the exchange) and refuses what only the fused pipeline has
    (compressed mixing, bucketed push-sum)."""
    return _env("BLUEFOG_FUSE_EPILOGUES", "1") not in ("0", "false",
                                                       "False")


def hier_local_size():
    """BLUEFOG_HIER_LOCAL_SIZE (default unset): default intra-machine
    group width of the hierarchical neighbor exchange for cta/atc steps
    that did not pass ``hierarchical=`` / ``hierarchical_local_size=``.
    Unset/0 keeps the flat rank-level exchange."""
    raw = _env("BLUEFOG_HIER_LOCAL_SIZE", "")
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v >= 1 else None


def mix_compress():
    """BLUEFOG_MIX_COMPRESS (default unset): default wire compression of
    the cta/atc combine when ``compress=`` was not passed: ``int8``,
    ``int8_sr``, ``bf16`` or ``topk`` (error-feedback compressed mixing;
    pair with :func:`mix_compress_ratio`).  Unset or unrecognized keeps
    the full-precision wire; explicit builder arguments win."""
    raw = _env("BLUEFOG_MIX_COMPRESS", "").strip().lower()
    return raw if raw in ("int8", "int8_sr", "bf16", "topk") else None


def mix_compress_ratio():
    """BLUEFOG_MIX_COMPRESS_RATIO (default unset -> builder default): kept
    fraction of each bucket's elements for the error-feedback compressed
    mixing wire (``BLUEFOG_MIX_COMPRESS=topk`` or ``compress="topk"``).
    Values >= 1.0 mean "keep everything" and build the uncompressed
    exchange; unparsable or non-positive values are ignored (``None``)."""
    raw = _env("BLUEFOG_MIX_COMPRESS_RATIO", "")
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def moe_capacity_factor() -> float:
    """BLUEFOG_MOE_CAPACITY_FACTOR (default 1.25): the capacity factor of
    :func:`bluefog_tpu_torch.moe.layer.default_capacity`: each
    destination rank accepts ``ceil(factor * tokens / n)`` tokens per
    source shard, and the overflow in batch order rides the residual
    path.  An explicit ``capacity=`` or ``factor=`` wins; unparsable or
    non-positive values give the default."""
    try:
        v = float(_env("BLUEFOG_MOE_CAPACITY_FACTOR", "1.25"))
    except ValueError:
        return 1.25
    return v if v > 0 else 1.25


def elastic_bootstrap_rounds() -> int:
    """BLUEFOG_ELASTIC_BOOTSTRAP_ROUNDS (default 8): quarantined mixing
    rounds a joining rank's self-weight anneals over (0 -> its pristine
    weight) while bootstrapping by pulled neighbor averaging
    (:mod:`bluefog_tpu_torch.elastic.bootstrap`).  More rounds = gentler
    re-entry; the first round is always a pure pull regardless."""
    try:
        return max(1, int(_env("BLUEFOG_ELASTIC_BOOTSTRAP_ROUNDS", "8")))
    except ValueError:
        return 8


def elastic_quarantine_threshold() -> float:
    """BLUEFOG_ELASTIC_QUARANTINE_THRESHOLD (default 1.0): max
    normalized bootstrap disagreement (joiner's L2 distance from the
    live mean, in units of the live ranks' own max deviation — see
    :func:`bluefog_tpu_torch.elastic.bootstrap.disagreement`) for
    promotion to LIVE.  <= 1.0 means the joiner sits inside the live
    consensus cloud.  Until it clears, live receivers keep zero weight on
    the joiner — a half-synced value never leaks into the fleet."""
    try:
        return float(_env("BLUEFOG_ELASTIC_QUARANTINE_THRESHOLD", "1.0"))
    except ValueError:
        return 1.0


def topology_replan_window() -> int:
    """BLUEFOG_TOPOLOGY_REPLAN_WINDOW (steps, default 8): how often the
    topology control plane (:class:`bluefog_tpu_torch.topology.control.
    TopologyControlPlane`) takes a telemetry window — per-edge
    byte/second DELTAS, straggler z snapshot, live-set — and re-scores
    the incumbent schedule against it.  Larger windows smooth noise;
    smaller ones react faster."""
    try:
        return max(1, int(_env("BLUEFOG_TOPOLOGY_REPLAN_WINDOW", "8")))
    except ValueError:
        return 8


def topology_replan_patience() -> int:
    """BLUEFOG_TOPOLOGY_REPLAN_PATIENCE (windows, default 2): consecutive
    DEGRADED telemetry windows before the control plane triggers a
    background re-synthesis — the debounce half of the hysteresis pair
    (one noisy window never re-plans).  A live-set transition (death,
    promotion) bypasses patience: membership is structural, not
    noise."""
    try:
        return max(1, int(_env("BLUEFOG_TOPOLOGY_REPLAN_PATIENCE", "2")))
    except ValueError:
        return 2


def topology_replan_degrade_ratio() -> float:
    """BLUEFOG_TOPOLOGY_REPLAN_DEGRADE (default 1.3): a telemetry window
    counts as degraded when some active edge's measured
    seconds-per-activation (normalized by its nominal link cost)
    exceeds the fleet-wide median by this factor — a RELATIVE test, so
    uniform load (every link equally busy) never trips it and the units
    of the seconds counters cancel out."""
    try:
        return float(_env("BLUEFOG_TOPOLOGY_REPLAN_DEGRADE", "1.3"))
    except ValueError:
        return 1.3


def topology_replan_margin() -> float:
    """BLUEFOG_TOPOLOGY_REPLAN_MARGIN (default 0.05): fractional
    cost-to-consensus improvement a synthesized candidate must show
    over the RE-SCORED incumbent to be accepted for a hot swap — the
    anti-flap half of the hysteresis pair (a candidate that merely
    ties the incumbent is noise, and swapping on noise would oscillate
    between near-equal plans)."""
    try:
        return float(_env("BLUEFOG_TOPOLOGY_REPLAN_MARGIN", "0.05"))
    except ValueError:
        return 0.05


def topology_replan_cooldown() -> int:
    """BLUEFOG_TOPOLOGY_REPLAN_COOLDOWN (steps, default 16): minimum
    steps between topology swaps (and after a rollback, before the
    next trigger may fire).  Bounds the worst-case swap rate no matter
    how noisy telemetry gets."""
    try:
        return max(0, int(_env("BLUEFOG_TOPOLOGY_REPLAN_COOLDOWN", "16")))
    except ValueError:
        return 16


def topology_replan_probation() -> int:
    """BLUEFOG_TOPOLOGY_REPLAN_PROBATION (steps, default 8): how long a
    freshly swapped-in schedule is on probation — the control plane
    watches the consensus-distance health signal and rolls back to the
    incumbent if it worsens past the pre-swap baseline; after this
    many clean steps the candidate is committed as the new
    incumbent."""
    try:
        return max(1, int(_env("BLUEFOG_TOPOLOGY_REPLAN_PROBATION", "8")))
    except ValueError:
        return 8


def engine_token() -> str:
    """BLUEFOG_TPU_ENGINE_TOKEN: shared secret the interactive-run
    engine processes require on every control connection
    (:mod:`bluefog_tpu_torch.run.engines`); empty disables nothing: an
    empty token still HMACs, it is just guessable."""
    return _env("BLUEFOG_TPU_ENGINE_TOKEN", "")


def state_dir() -> str:
    """BLUEFOG_TPU_STATE_DIR (default ``~/.bluefog_tpu``), expanded:
    where ``ibfrun`` keeps its per-profile engine state files."""
    return os.path.expanduser(_env("BLUEFOG_TPU_STATE_DIR",
                                   "~/.bluefog_tpu"))


def chip_peak_tflops_override():
    """BLUEFOG_CHIP_PEAK_TFLOPS: per-card peak bf16 TFLOP/s override for
    :func:`bluefog_tpu_torch.benchutil.chip_peak_flops` (a card the
    table does not list, or auditing a card from a host).  ``None`` when
    unset or empty."""
    raw = _env("BLUEFOG_CHIP_PEAK_TFLOPS", "")
    return float(raw) if raw else None


def chip_hbm_gbps_override():
    """BLUEFOG_CHIP_HBM_GBPS: per-card memory GB/s override for
    :func:`bluefog_tpu_torch.benchutil.chip_hbm_bandwidth`; the same
    convention as :func:`chip_peak_tflops_override`."""
    raw = _env("BLUEFOG_CHIP_HBM_GBPS", "")
    return float(raw) if raw else None
