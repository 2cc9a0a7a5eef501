"""Environment-variable configuration of the port.

Port of ``bluefog_tpu/config.py``, cut to the knobs the port reads
(the serving engine's slot pool, the observe switch, the Python
timeline writer, the knobs ``build_train_step`` reads, and the eager
op layer's: logging, the timeline path, fusion, the stall watchdog,
the op timeout, ``BLUEFOG_OPS_ON_CPU`` and the launcher's process
identity).  The
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
    "observe_raw",
    "timeline_flush_every",
    "timeline_queue_capacity",
    "kv_zero_on_free",
    "fuse_epilogues",
    "hier_local_size",
    "mix_compress",
    "mix_compress_ratio",
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


def observe_raw() -> bool:
    """BLUEFOG_OBSERVE (default on): whether the built-in publishers
    write into the observability registry/tracer; ``0`` opts out.  Read
    through :func:`bluefog_tpu_torch.observe.registry.enabled`."""
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


def kv_zero_on_free() -> bool:
    """BLUEFOG_KV_ZERO_ON_FREE (default OFF): whether
    :meth:`bluefog_tpu_torch.serving.SlotPool.free` zeroes a freed
    slot's whole K/V cache.  Off, only the slot's cache index resets,
    which is all reuse needs for exactness (everything above the index
    is masked and overwritten as the next request writes)."""
    return _env("BLUEFOG_KV_ZERO_ON_FREE", "0") in ("1", "true", "True")


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
