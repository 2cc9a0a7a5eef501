"""Continuous-batching inference engine.

Port of ``bluefog_tpu/serving/engine.py`` (``Request``,
``ServingEngine.submit/step/run/cancel``): every request owns a slot of
the fixed-capacity K/V pool (:class:`~bluefog_tpu_torch.serving.kv_pool
.SlotPool`); each :meth:`ServingEngine.step` sheds expired and cancelled
requests, admits queued ones and runs up to ``prefill_budget``
fixed-shape prefill chunks, then advances EVERY active slot
``decode_horizon`` tokens; slots retire on EOS / token budget / deadline
/ cancellation.  Behaviours kept from the JAX engine:

* chunks cover ``prompt[:-1]``; the last prompt token goes through the
  decode step, whose logits give the first generated token;
* a padded chunk advances the slot's cache index by the whole chunk, and
  the engine corrects it to ``old + valid_len``: the pad tail's K/V sits
  above the index, masked, until real tokens overwrite it;
* inactive slots still compute in the decode step; only their cache
  index is frozen (their stray K/V write lands at that index, masked);
* a greedy request's output is token-exact with its one-shot
  ``llama_generate(prompt[None], n, max_len=pool_max_len)``.

Deviations:

* The JAX engine ran jitted programs and ``vmap``-ed one-slot steps.
  Here the decode step runs all ``capacity`` slots as one batch with a
  per-slot position tensor (``cache.index [capacity]``), eagerly, with
  in-place cache writes; every single-token step of every layer is one
  launch of the decode-attention kernel on the card.
* Sampling folds ``(request seed, token index)`` into a per-request
  ``torch.Generator`` (Gumbel-max over the logits / temperature), so a
  sampled stream depends on its seed alone, not on what it is
  co-batched with.  The bits differ from ``jax.random``'s.
* ``decode_attn`` is taken for signature compatibility (``"auto"``
  means the kernel; on a CUDA device any value but ``"pallas"``/
  ``"auto"`` is refused).
* ``speculative=``, ``prefix_cache=``, ``drain`` and ``profile`` wait for
  a later slice and raise ``NotImplementedError``; so does
  ``weight_quant != "none"``.
* The engine counts logit rows of active slots that were not finite
  (:meth:`ServingEngine.nonfinite_logit_rows`).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.generate import (build_model,
                                               check_decode_attn,
                                               decode_config,
                                               decode_token_step,
                                               prefill_cache)
from bluefog_tpu_torch.models.llama import LlamaConfig
from bluefog_tpu_torch.serving.kv_pool import SlotPool
from bluefog_tpu_torch.serving.metrics import ServingMetrics
from bluefog_tpu_torch.serving.scheduler import (FifoScheduler,
                                                 RequestRejected)

__all__ = ["ServingEngine", "Request", "RequestRejected"]

_rid_counter = itertools.count()

# terminal / live request states
QUEUED, PREFILL, DECODE = "queued", "prefill", "decode"
COMPLETED, CANCELLED, REJECTED = "completed", "cancelled", "rejected"


@dataclasses.dataclass(eq=False)  # identity semantics: the scheduler
# removes by object (a generated __eq__ would compare prompt arrays)
class Request:
    """One generation request (the JAX engine's ``Request``).

    ``deadline`` is in absolute engine-clock seconds: a request that has
    not RETIRED by its deadline is cancelled — queued ones are shed
    without touching the device.  ``temperature``/``seed`` drive
    per-request sampling (greedy at 0.0)."""
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    deadline: Optional[float] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    # engine-owned state
    state: str = dataclasses.field(default=QUEUED, init=False)
    tokens: List[int] = dataclasses.field(default_factory=list, init=False)
    slot: Optional[int] = dataclasses.field(default=None, init=False)
    _prefill_pos: int = dataclasses.field(default=0, init=False)
    _cancel: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens ({self.max_new_tokens}) must be >= 1")

    @property
    def done(self) -> bool:
        return self.state in (COMPLETED, CANCELLED, REJECTED)

    def output(self) -> np.ndarray:
        """prompt ‖ generated tokens (EOS included when it fired)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


def _fold_seed(seed: int, count: int) -> int:
    """The generator seed of a request's ``count``-th token: a hash of
    ``(seed, count)``, so neighbouring seeds and counts give unrelated
    streams."""
    ss = np.random.SeedSequence([seed % 2 ** 64, count])
    return int(ss.generate_state(1, np.uint64)[0])


class ServingEngine:
    """Continuous-batching serving loop over a :class:`SlotPool`.

    Args:
      variables: a port state dict (``interop.llama_params_from_flax``,
        ``Llama.state_dict()``) or a :class:`~bluefog_tpu_torch.models
        .Llama` built from ``cfg`` on ``device`` (used without a copy).
      cfg: model config (training layout fine; normalized through
        ``decode_config``).
      capacity: resident request slots (= decode batch).
      max_len: per-slot cache length; every request needs
        ``len(prompt) + max_new_tokens <= max_len``.
      prefill_chunk: fixed prompt-chunk length; must divide ``max_len``.
      decode_horizon: tokens every active slot advances per step; the
        emitted streams are the same for every horizon.
      prefill_budget: max prefill chunks one step may run.
      kv_quant: "none" | "int8" cache layout.
      max_queue: backpressure bound — submits beyond it raise
        :class:`RequestRejected`.
      clock: injectable monotonic clock (default ``time.monotonic``).
      registry: explicit metrics registry (default: the global one).
      zero_on_free: passed to :class:`SlotPool`.
      device: where the model and caches live (default ``"cuda"``).
    """

    def __init__(self, variables, cfg: LlamaConfig, *, capacity: int,
                 max_len: int, prefill_chunk: int = 32,
                 decode_horizon: int = 1, prefill_budget: int = 1,
                 kv_quant: str = "none", weight_quant: str = "none",
                 max_queue: int = 64,
                 clock: Optional[Callable[[], float]] = None,
                 decode_attn: str = "auto", registry=None,
                 zero_on_free: Optional[bool] = None,
                 prefix_cache=False, speculative=None,
                 device: Union[str, torch.device] = "cuda"):
        if speculative is not None:
            raise NotImplementedError(
                "speculative decoding waits for a later serving slice of "
                "bluefog_tpu_torch")
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache waits for a later serving slice of "
                "bluefog_tpu_torch")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk ({prefill_chunk}) must be "
                             ">= 1")
        if max_len % prefill_chunk != 0:
            # chunk writes land at multiples of prefill_chunk, so no
            # chunk's fixed-size window crosses max_len (a window that
            # did would be clamped and overwrite earlier positions)
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must divide max_len "
                f"({max_len}) so no chunk window crosses the cache end")
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon ({decode_horizon}) must be "
                             ">= 1")
        if prefill_budget < 1:
            raise ValueError(f"prefill_budget ({prefill_budget}) must be "
                             ">= 1")
        self.device = resolve_device(device)
        self.cfg = decode_config(cfg, max_len, kv_quant=kv_quant,
                                 weight_quant=weight_quant,
                                 decode_attn=decode_attn)
        check_decode_attn(self.cfg, self.device)
        self.model = build_model(variables, cfg, self.device)
        self.pool = SlotPool(cfg, capacity, max_len, kv_quant=kv_quant,
                             zero_on_free=zero_on_free, device=self.device)
        self.scheduler = FifoScheduler(max_queue=max_queue)
        self.metrics = ServingMetrics(registry=registry)
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = decode_horizon
        self.prefill_budget = prefill_budget
        self.clock = clock or time.monotonic
        self._running: Dict[int, Request] = {}   # slot -> request
        self._admitting: Optional[Request] = None  # mid-prefill request
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)

    # -- submission ---------------------------------------------------- #
    def submit(self, request: Request) -> Request:
        """Enqueue a request.  Raises :class:`RequestRejected` under
        backpressure (queue at ``max_queue``) and ``ValueError`` when the
        request cannot fit a slot at all."""
        total = request.prompt.size + request.max_new_tokens
        if total > self.pool.max_len:
            # a request the engine will never run is terminal and counted
            request.state = REJECTED
            self.metrics.on_reject(request.rid, self.clock())
            raise ValueError(
                f"request needs {total} cache positions but slots hold "
                f"{self.pool.max_len} (prompt {request.prompt.size} + "
                f"max_new_tokens {request.max_new_tokens})")
        now = self.clock()
        try:
            self.scheduler.submit(request)
        except RequestRejected:
            request.state = REJECTED
            self.metrics.on_reject(request.rid, now)
            raise
        request.state = QUEUED
        self.metrics.on_submit(request.rid, now)
        return request

    def cancel(self, request: Request) -> bool:
        """Cancel a queued or running request (idempotent; False once the
        request already retired)."""
        if request.done:
            return False
        if self.scheduler.cancel(request):
            request.state = CANCELLED
            self.metrics.on_retire(request.rid, self.clock(), CANCELLED)
            return True
        request._cancel = True  # picked up at the next step boundary
        return True

    # -- the serving loop --------------------------------------------- #
    def step(self) -> bool:
        """One engine iteration: shed/cancel, admit + prefill chunks, one
        decode step over all active slots.  Returns True while there is
        live work (queued, prefilling, or decoding)."""
        t_step = time.perf_counter()
        now = self.clock()
        # 1. deadline shedding in the queue (zero device cost)
        for req in self.scheduler.expire(now):
            req.state = CANCELLED
            self.metrics.on_retire(req.rid, now, CANCELLED)
        # 2. running cancellations (explicit or deadline), including a
        #    request still mid-prefill
        live = list(self._running.values())
        if self._admitting is not None:
            live.append(self._admitting)
        for req in live:
            if req._cancel or (req.deadline is not None
                               and now >= req.deadline):
                self._retire(req, CANCELLED, now)
        # 3+4. admission + chunked prefill, bounded by the chunk budget
        chunks = 0
        while chunks < self.prefill_budget:
            if self._admitting is None:
                if self.pool.n_free == 0:
                    break
                req = self.scheduler.admit(now)
                if req is None:
                    break
                req.slot = self.pool.alloc()
                self.metrics.on_admit(req.rid, now)
                if req.prompt.size > 1:
                    req.state = PREFILL
                    self._admitting = req
                else:  # single-token prompt: the decode step consumes it
                    req.state = DECODE
                    self._running[req.slot] = req
                    continue
            self._prefill_one_chunk(self._admitting)
            chunks += 1
        # 5. decode tokens for every active slot
        decoding = {s: r for s, r in self._running.items()
                    if r.state == DECODE}
        if decoding:
            self._decode_step(decoding)
        self.metrics.on_step(self.pool.occupancy(),
                             self.scheduler.queue_depth,
                             time.perf_counter() - t_step, now=now)
        return bool(self._running or self._admitting
                    or self.scheduler.queue_depth)

    def run(self, max_steps: int = 100_000) -> None:
        """Drive :meth:`step` until idle."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    def drain(self, *args, **kwargs):
        raise NotImplementedError(
            "drain waits for the serving-resilience slice of "
            "bluefog_tpu_torch")

    def profile(self, **kw):
        raise NotImplementedError(
            "profile (HLO step profiles in JAX) waits for the observe "
            "slice of bluefog_tpu_torch")

    def nonfinite_logit_rows(self) -> int:
        """How many (decode step, active slot) logit rows held a NaN or
        an infinity so far (reads the device counter)."""
        return int(self._nonfinite.item())

    # -- internals ----------------------------------------------------- #
    def _prefill_one_chunk(self, req: Request) -> None:
        # chunks cover prompt[:-1]; the final prompt token goes through
        # the decode step, whose logits yield the first generated token
        c = self.prefill_chunk
        pos = req._prefill_pos
        n_prefill = req.prompt.size - 1
        valid = min(c, n_prefill - pos)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :valid] = req.prompt[pos:pos + valid]
        view = self.pool.cache.rows(req.slot, req.slot + 1)
        prefill_cache(self.model, view,
                      torch.from_numpy(chunk).to(self.device))
        # the model advanced the index by the padded chunk; the request
        # wrote only `valid` real tokens
        view.index.sub_(c - valid)
        self.metrics.on_prefill_chunk()
        req._prefill_pos = pos + valid
        if req._prefill_pos < n_prefill:
            return  # more chunks to go; decodes keep running meanwhile
        self._admitting = None
        self._running[req.slot] = req
        req.state = DECODE

    def _sample(self, logits: torch.Tensor, decoding: Dict[int, Request],
                j: int) -> torch.Tensor:
        """Greedy argmax for every row; rows of sampling requests draw
        Gumbel noise from their own ``(seed, token index)`` generator."""
        out = logits.argmax(dim=-1).to(torch.int32)
        for slot, req in decoding.items():
            if req.temperature > 0.0:
                g = torch.Generator(self.device).manual_seed(
                    _fold_seed(req.seed, len(req.tokens) + j))
                u = torch.rand(logits.shape[-1], generator=g,
                               device=self.device)
                gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
                out[slot] = (logits[slot] / req.temperature
                             + gumbel).argmax()
        return out

    def _decode_step(self, decoding: Dict[int, Request]) -> None:
        t0 = time.perf_counter()
        cap = self.pool.capacity
        toks = np.zeros((cap,), np.int32)
        active = np.zeros((cap,), bool)
        for slot, req in decoding.items():
            # first step after prefill consumes the LAST prompt token;
            # afterwards the request's own stream feeds back
            toks[slot] = req.tokens[-1] if req.tokens else req.prompt[-1]
            active[slot] = True
        cache = self.pool.cache
        tok = torch.from_numpy(toks).to(self.device)
        act = torch.from_numpy(active).to(self.device)
        hist = []
        for j in range(self.decode_horizon):
            old_index = cache.index.clone()
            last, cache = decode_token_step(self.model, cache, tok[:, None])
            self._nonfinite += ((~torch.isfinite(last)).any(dim=-1)
                                & act).sum()
            tok = torch.where(act, self._sample(last, decoding, j), tok)
            # inactive slots computed too; only their index is frozen
            cache.index.copy_(torch.where(act, cache.index, old_index))
            hist.append(tok)
        hist = torch.stack(hist).cpu().numpy()  # the per-step host sync
        now = self.clock()
        self.metrics.on_decode_step(self.decode_horizon,
                                    time.perf_counter() - t0)
        for slot, req in decoding.items():
            for j in range(self.decode_horizon):
                first = not req.tokens
                req.tokens.append(int(hist[j, slot]))
                if first:
                    self.metrics.on_first_token(req.rid, now)
                else:
                    self.metrics.on_token(req.rid, now)
                if self._maybe_finish(req):
                    break  # surplus horizon tokens of a retired slot are
                    # discarded (its index resets on free)

    def _maybe_finish(self, req: Request) -> bool:
        hit_eos = (req.eos_id is not None
                   and req.tokens[-1] == req.eos_id)
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self._retire(req, COMPLETED, self.clock())
            return True
        return False

    def _retire(self, req: Request, outcome: str, now: float) -> None:
        if req is self._admitting:
            self._admitting = None
        if req.slot is not None:
            self._running.pop(req.slot, None)
            self.pool.free(req.slot)
            req.slot = None
        req.state = outcome
        self.metrics.on_retire(req.rid, now, outcome)
