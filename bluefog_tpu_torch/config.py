"""Environment-variable configuration of the port.

Port of ``bluefog_tpu/config.py``, cut to the knobs this slice reads
(the serving engine's slot pool, the observe switch, the Python
timeline writer, and the knobs ``build_train_step`` reads).  The
environment-variable names and defaults are the JAX package's, so one
environment configures both packages.  Every environment read of the
port lives in this module.
"""

from __future__ import annotations

import os

__all__ = [
    "observe_raw",
    "timeline_flush_every",
    "timeline_queue_capacity",
    "kv_zero_on_free",
    "fuse_epilogues",
    "hier_local_size",
    "mix_compress",
]


def _env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


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
    the fused per-bucket epilogue pipeline.  The port has that pipeline
    only (its combine weights are runtime tensors, as the JAX package's
    fused builder passes them); ``0`` selects the JAX package's
    pre-fusion builders, which the port does not have, and the builder
    raises."""
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
    ``int8_sr``, ``bf16`` or ``topk``.  Unset or unrecognized keeps the
    full-precision wire; explicit builder arguments win.  The ``topk``
    wire's ratio knob (``BLUEFOG_MIX_COMPRESS_RATIO``) comes with that
    wire (ROADMAP.md Queue 1, item 5): the JAX package reads it only
    under ``topk``, which the port's builder refuses."""
    raw = _env("BLUEFOG_MIX_COMPRESS", "").strip().lower()
    return raw if raw in ("int8", "int8_sr", "bf16", "topk") else None
