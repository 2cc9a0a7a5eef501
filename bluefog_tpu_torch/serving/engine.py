"""Continuous-batching inference engine.

Port of ``bluefog_tpu/serving/engine.py`` (``Request``,
``SpeculativeConfig``, ``ServingEngine.submit/step/run/cancel/drain``):
every request owns a slot of the fixed-capacity K/V pool
(:class:`~bluefog_tpu_torch.serving.kv_pool.SlotPool`); each
:meth:`ServingEngine.step` sheds expired and cancelled requests, admits
queued ones (restoring cached prompt chunks from a
:class:`~bluefog_tpu_torch.serving.prefix_cache.PrefixCache` when there
is one) and runs up to ``prefill_budget`` fixed-shape prefill chunks,
then advances EVERY active slot ``decode_horizon`` tokens (or, with a
:class:`SpeculativeConfig`, one draft/verify step of 1 to
``lookahead + 1`` tokens); slots retire on EOS / token budget / deadline
/ cancellation.  :meth:`ServingEngine.drain` retires the replica, handing
its requests off with their emitted tokens.  Behaviours kept from the
JAX engine:

* chunks cover ``(prompt ‖ tokens)[:-1]`` (the tokens of a request that
  failed over from another replica included); the last token goes
  through the decode step, whose logits give the next generated token;
* a padded chunk advances the slot's cache index by the whole chunk, and
  the engine corrects it to ``old + valid_len``: the pad tail's K/V sits
  above the index, masked, until real tokens overwrite it;
* inactive slots still compute in the decode step; only their cache
  index is frozen (their stray K/V write lands at that index, masked);
* a greedy request's output is token-exact with its one-shot
  ``llama_generate(prompt[None], n, max_len=pool_max_len)``, with or
  without the prefix cache and speculation (on the CPU, where every
  path runs plain arithmetic; see the deviations for the card).

Deviations:

* The JAX engine ran jitted programs and ``vmap``-ed one-slot steps.
  Here the decode step runs all ``capacity`` slots as one batch with a
  per-slot position tensor (``cache.index [capacity]``), eagerly, with
  in-place cache writes; every single-token step of every layer (the
  draft's included) is one launch of the decode-attention kernel on the
  card.  There are no compiled programs, so nothing can recompile.
* Sampling folds ``(request seed, token index)`` into a per-request
  ``torch.Generator`` (Gumbel-max over the logits / temperature), so a
  sampled stream depends on its seed alone, not on what it is
  co-batched with, and a request resumed elsewhere continues it.  The
  speculative step salts its three uses (draft proposals 1, acceptance
  draws 2, the correction 3), as the JAX engine's ``fold_in`` does.  The
  bits differ from ``jax.random``'s.
* On the card the plain decode step's logits come from K4 and the
  speculative verify's (and a resumed request's re-prefill) from the
  multi-token path through cuBLAS at another M.  They can differ in the
  last bits, so a greedy argmax may flip at a near-tie there
  (``chip_smoke.py`` phase 19 counts and explains such flips).
* ``decode_attn`` is taken for signature compatibility (``"auto"``
  means the kernel; on a CUDA device any value but ``"pallas"``/
  ``"auto"`` is refused).
* :meth:`ServingEngine.profile` executes each resident program (the
  JAX engine's profile compiles and executes nothing) on scratch caches
  the engine's pool never sees, through
  :func:`~bluefog_tpu_torch.observe.profile_step` on ``torch.profiler``.
* The engine counts logit rows of active slots that were not finite
  (:meth:`ServingEngine.nonfinite_logit_rows`).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.generate import (build_model,
                                               check_decode_attn,
                                               decode_config,
                                               decode_token_step, init_cache,
                                               prefill_cache, verify_window)
from bluefog_tpu_torch.models.llama import LlamaConfig
from bluefog_tpu_torch.models.quant import is_quantized_params
from bluefog_tpu_torch.serving.kv_pool import SlotPool
from bluefog_tpu_torch.serving.metrics import ServingMetrics
from bluefog_tpu_torch.serving.prefix_cache import PrefixCache
from bluefog_tpu_torch.serving.scheduler import (FifoScheduler,
                                                 RequestRejected)

__all__ = ["ServingEngine", "Request", "RequestRejected",
           "SpeculativeConfig", "EXPIRED", "FAILOVER"]

_rid_counter = itertools.count()

# terminal / live request states
QUEUED, PREFILL, DECODE = "queued", "prefill", "decode"
COMPLETED, CANCELLED, REJECTED = "completed", "cancelled", "rejected"
# EXPIRED: terminal — the deadline passed while the request was stranded
# on a dead or draining replica (queue shedding stays CANCELLED).
# FAILOVER: transitional retire outcome — the slot is released here but
# the request resets to QUEUED for resubmission elsewhere, so ``done``
# stays False.
EXPIRED, FAILOVER = "expired", "failover"


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
    _prefix_keys: Optional[List[str]] = dataclasses.field(default=None,
                                                          init=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens ({self.max_new_tokens}) must be >= 1")

    @property
    def done(self) -> bool:
        return self.state in (COMPLETED, CANCELLED, REJECTED, EXPIRED)

    def output(self) -> np.ndarray:
        """prompt ‖ generated tokens (EOS included when it fired)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def reset_for_resume(self) -> "Request":
        """Return the request to the submittable QUEUED state while
        KEEPING its emitted tokens — the failover/drain primitive.  The
        next engine re-prefills ``prompt ‖ tokens`` (cached chunks by
        chain hash, a cold tail otherwise) and its sampling continues the
        per-request seed chain at ``len(tokens)``."""
        self.state = QUEUED
        self.slot = None
        self._prefill_pos = 0
        self._cancel = False
        self._prefix_keys = None
        return self


def _fold_seed(seed: int, count: int, salt: int = 0) -> int:
    """The generator seed of a request's ``count``-th draw: a hash of
    ``(seed, count)`` (of ``(seed, salt, count)`` for a salted use), so
    neighbouring seeds, counts and salts give unrelated streams."""
    entropy = [seed % 2 ** 64, count] if not salt else \
        [seed % 2 ** 64, salt, count]
    ss = np.random.SeedSequence(entropy)
    return int(ss.generate_state(1, np.uint64)[0])


_draw_generators = threading.local()


def _generator(device: torch.device) -> torch.Generator:
    """This thread's generator on ``device``, reused for every draw:
    ``manual_seed`` resets its whole state, so a draw gives the bits of a
    fresh generator with the draw's seed."""
    cache = getattr(_draw_generators, "by_device", None)
    if cache is None:
        cache = _draw_generators.by_device = {}
    g = cache.get(device)
    if g is None:
        g = cache[device] = torch.Generator(device)
    return g


def _uniform(req: Request, count: int, salt: int, n: int,
             device: torch.device) -> torch.Tensor:
    g = _generator(device).manual_seed(_fold_seed(req.seed, count, salt))
    return torch.rand(n, generator=g, device=device)


def _gumbel(req: Request, count: int, salt: int, n: int,
            device: torch.device) -> torch.Tensor:
    u = _uniform(req, count, salt, n, device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Draft model spec for speculative decoding (the JAX package's).

    ``variables``/``cfg`` are the DRAFT model (a port state dict or a
    :class:`~bluefog_tpu_torch.models.Llama`; same vocabulary as the
    target, typically much smaller).  Each engine step the draft proposes
    ``lookahead`` tokens through single-token steps (K4 on the card), the
    target scores the whole window in ONE multi-token forward
    (:func:`~bluefog_tpu_torch.models.generate.verify_window`), and
    rejection sampling accepts a prefix of the proposals plus one
    correction or bonus token: 1 to ``lookahead + 1`` tokens a step with
    the TARGET's distribution (its greedy argmax at temperature 0).  The
    engine reserves ``lookahead`` cache positions of headroom per slot
    (checked at submit)."""

    variables: object
    cfg: LlamaConfig
    lookahead: int = 4
    weight_quant: str = "none"


class ServingEngine:
    """Continuous-batching serving loop over a :class:`SlotPool`.

    Args:
      variables: a port state dict (``interop.llama_params_from_flax``,
        ``Llama.state_dict()``, or with ``weight_quant`` set the
        :func:`~bluefog_tpu_torch.models.quant.quantize_llama_params`
        layout) or a :class:`~bluefog_tpu_torch.models.Llama` built for
        ``cfg`` on ``device`` (used without a copy).
      cfg: model config (training layout fine; normalized through
        ``decode_config``).
      capacity: resident request slots (= decode batch).
      max_len: per-slot cache length; every request needs
        ``len(prompt) + max_new_tokens <= max_len`` (plus ``lookahead``
        under speculation).
      prefill_chunk: fixed prompt-chunk length; must divide ``max_len``.
      decode_horizon: tokens every active slot advances per step; the
        emitted streams are the same for every horizon.
      prefill_budget: max prefill chunks one step may run.
      kv_quant: "none" | "int8" cache layout.
      weight_quant: "none" | "int8" | "w8a8" (``QuantDense`` layers).
      max_queue: backpressure bound — submits beyond it raise
        :class:`RequestRejected`.
      clock: injectable monotonic clock (default ``time.monotonic``).
      registry: explicit metrics registry (default: the global one).
      zero_on_free: passed to :class:`SlotPool`.
      prefix_cache: ``True`` builds a :class:`PrefixCache` of
        ``prefix_cache_bytes`` (default ``BLUEFOG_PREFIX_CACHE_MB``), or
        pass an instance to share it between engines.  Admission then
        restores chain-hash-matched prompt chunks by copy and prefills
        only the novel tail.
      speculative: a :class:`SpeculativeConfig` — each decode step
        becomes a draft/verify step.  Requires ``decode_horizon=1``.
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
                 prefix_cache=False,
                 prefix_cache_bytes: Optional[int] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
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
        if speculative is not None:
            if not isinstance(speculative, SpeculativeConfig):
                raise TypeError("speculative= takes a SpeculativeConfig, "
                                f"not {type(speculative).__name__}")
            if decode_horizon != 1:
                raise ValueError(
                    "speculative decoding requires decode_horizon=1 (a "
                    "speculative step already advances up to lookahead+1 "
                    f"tokens); got decode_horizon={decode_horizon}")
            if speculative.lookahead < 1:
                raise ValueError(
                    f"lookahead ({speculative.lookahead}) must be >= 1")
            if speculative.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({speculative.cfg.vocab_size}) != "
                    f"target vocab ({cfg.vocab_size}) — speculative "
                    "decoding needs one tokenizer")
            if ((speculative.weight_quant != "none")
                    != is_quantized_params(speculative.variables)):
                raise ValueError(
                    "SpeculativeConfig.weight_quant does not match the "
                    "draft param tree (quantize_llama_params contract)")
        self.device = resolve_device(device)
        self.cfg = decode_config(cfg, max_len, kv_quant=kv_quant,
                                 weight_quant=weight_quant,
                                 decode_attn=decode_attn)
        check_decode_attn(self.cfg, self.device)
        self.model = build_model(variables, self.cfg, self.device)
        prefix = None
        # NB: isinstance first — an EMPTY PrefixCache is falsy (__len__)
        if isinstance(prefix_cache, PrefixCache) or prefix_cache:
            prefix = (prefix_cache if isinstance(prefix_cache, PrefixCache)
                      else PrefixCache(prefill_chunk, prefix_cache_bytes))
            if prefix.chunk != prefill_chunk:
                raise ValueError(
                    f"prefix cache chunk ({prefix.chunk}) != prefill_chunk"
                    f" ({prefill_chunk}) — hashes must match the chunk "
                    "grid prefill writes")
        self.pool = SlotPool(cfg, capacity, max_len, kv_quant=kv_quant,
                             zero_on_free=zero_on_free, device=self.device,
                             prefix=prefix)
        self._spec = speculative
        self._draft_pool: Optional[SlotPool] = None
        self.draft = None
        self.draft_cfg: Optional[LlamaConfig] = None
        if speculative is not None:
            self.draft_cfg = decode_config(
                speculative.cfg, max_len, kv_quant=kv_quant,
                weight_quant=speculative.weight_quant,
                decode_attn=decode_attn)
            self.draft = build_model(speculative.variables, self.draft_cfg,
                                     self.device)
            # the draft pool mirrors the target pool's alloc/free order,
            # so slot i means the same request in both
            dprefix = (PrefixCache(prefill_chunk, prefix_cache_bytes)
                       if prefix is not None else None)
            self._draft_pool = SlotPool(speculative.cfg, capacity, max_len,
                                        kv_quant=kv_quant,
                                        zero_on_free=zero_on_free,
                                        device=self.device, prefix=dprefix)
        self.scheduler = FifoScheduler(max_queue=max_queue)
        self.metrics = ServingMetrics(registry=registry)
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = decode_horizon
        self.prefill_budget = prefill_budget
        self.clock = clock or time.monotonic
        self._running: Dict[int, Request] = {}   # slot -> request
        self._admitting: Optional[Request] = None  # mid-prefill request
        self._draining = False     # drain(): admission permanently off
        self._drain_flushed = 0    # K/V chunks flushed to the prefix
        # cache on behalf of migrating or completing drain residents
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)

    # -- submission ---------------------------------------------------- #
    def submit(self, request: Request) -> Request:
        """Enqueue a request.  Raises :class:`RequestRejected` under
        backpressure (queue at ``max_queue``) or while draining, and
        ``ValueError`` when the request cannot fit a slot at all."""
        total = request.prompt.size + request.max_new_tokens
        if self._spec is not None:
            # a speculative step may write lookahead draft positions past
            # the final emitted token: reserve that headroom so every
            # window stays inside the slot
            total += self._spec.lookahead
        if total > self.pool.max_len:
            # a request the engine will never run is terminal and counted
            request.state = REJECTED
            self.metrics.on_reject(request.rid, self.clock())
            raise ValueError(
                f"request needs {total} cache positions but slots hold "
                f"{self.pool.max_len} (prompt {request.prompt.size} + "
                f"max_new_tokens {request.max_new_tokens}"
                + (f" + speculative headroom {self._spec.lookahead}"
                   if self._spec is not None else "") + ")")
        now = self.clock()
        if self._draining:
            request.state = REJECTED
            self.metrics.on_reject(request.rid, now)
            raise RequestRejected("engine draining",
                                  queue_depth=self.scheduler.queue_depth,
                                  max_queue=self.scheduler.max_queue)
        try:
            self.scheduler.submit(request)
        except RequestRejected:
            request.state = REJECTED
            self.metrics.on_reject(request.rid, now)
            raise
        # a request one replica refused may be accepted by the next one:
        # acceptance supersedes the earlier REJECTED
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
                if self._draining:
                    break  # drain(): the current prefill finishes, but
                    # nothing new leaves the queue
                if self.pool.n_free == 0:
                    break
                req = self.scheduler.admit(now)
                if req is None:
                    break
                req.slot = self.pool.alloc()
                if self._draft_pool is not None:
                    dslot = self._draft_pool.alloc()
                    assert dslot == req.slot, (dslot, req.slot)
                self.metrics.on_admit(req.rid, now)
                # a failed-over request resumes with emitted tokens: its
                # prefill region is (prompt ‖ tokens)[:-1], on the chunk
                # grid the original prefill stashed
                n_ctx = req.prompt.size + len(req.tokens)
                if n_ctx > 1:
                    self._restore_prefix(req)  # no-op without the cache
                    if req._prefill_pos >= n_ctx - 1:
                        # the whole prefill region came out of the prefix
                        # cache: straight to decode
                        req.state = DECODE
                        self._running[req.slot] = req
                        continue
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
            if self._spec is not None:
                self._spec_decode_step(decoding)
            else:
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

    def drain(self, handoff: Optional[Callable[[Request], object]] = None,
              max_steps: int = 100_000) -> Dict[str, int]:
        """Retire this replica cleanly.

        Admission stops permanently (later :meth:`submit` calls raise
        :class:`RequestRejected`).  Then:

        * with a ``handoff`` callable (e.g. another engine's ``submit``):
          every resident flushes its written K/V chunks to the prefix
          cache, retires here with outcome ``failover``, resets to QUEUED
          **keeping its emitted tokens**, and is handed off; the target
          re-prefills ``prompt ‖ tokens`` (restored chunks + novel tail)
          and continues.  Queued requests hand off as they are.
        * without one: queued requests are REJECTED, residents run to
          completion in place, flushing their chunks as they retire.

        Returns a summary dict (``handed_off`` / ``completed`` /
        ``rejected_queue`` / ``cancelled_queue`` / ``flushed_chunks``)."""
        now = self.clock()
        self._draining = True
        summary = {"handed_off": 0, "completed": 0, "rejected_queue": 0,
                   "cancelled_queue": 0, "flushed_chunks": 0}
        # queue: deadline-expired requests shed exactly as step() would
        for req in self.scheduler.expire(now):
            req.state = CANCELLED
            self.metrics.on_retire(req.rid, now, CANCELLED)
            summary["cancelled_queue"] += 1
        queued = self.scheduler.drain()
        if handoff is None:
            for req in queued:
                req.state = REJECTED
                self.metrics.on_reject(req.rid, now)
                self.metrics.on_retire(req.rid, now, REJECTED)
                summary["rejected_queue"] += 1
            residents = {r.rid: r for r in self._running.values()}
            if self._admitting is not None:
                residents[self._admitting.rid] = self._admitting
            for _ in range(max_steps):
                if not self.step():
                    break
            else:
                raise RuntimeError(
                    f"drain still busy after {max_steps} steps")
            summary["completed"] = sum(
                1 for r in residents.values() if r.state == COMPLETED)
        else:
            residents = sorted(self._running.values(),
                               key=lambda r: r.slot)
            if self._admitting is not None:
                residents = sorted(residents + [self._admitting],
                                   key=lambda r: r.slot)
            for req in residents + queued:
                # _retire flushes the written chunks (draining is set)
                # and releases the slot; reset_for_resume keeps tokens
                self._retire(req, FAILOVER, now)
                self.metrics.on_failover(req.rid, now)
                req.reset_for_resume()
                handoff(req)
                summary["handed_off"] += 1
        summary["flushed_chunks"] = self._drain_flushed
        from bluefog_tpu_torch.observe.blackbox import record_decision

        record_decision(
            "serving", "drain", step=-1,
            telemetry={k: int(v) for k, v in sorted(summary.items())},
            winner="handoff" if handoff is not None else "complete")
        return summary

    def _resident(self) -> Dict[str, tuple]:
        """The engine's device programs: ``{name: (fn, args_thunk)}``, a
        prefill chunk and the decode step for a plain engine; the prefill
        chunk, the draft's prefill chunk and the draft/verify step for a
        speculative one (the JAX engine's resident set).  Each thunk
        builds scratch state the engine's pool never sees: a one-row
        cache for a prefill chunk, and for a decode program a cache of
        ``capacity`` rows (the batch the engine's decode step runs) at
        the pool's current positions, no row active, so the program
        leaves its indices as it found them and samples nothing."""
        cap, dev = self.pool.capacity, self.device
        max_len, kv = self.pool.max_len, self.pool.kv_quant

        def scratch(cfg, rows):
            return init_cache(cfg, rows, max_len, kv_quant=kv, device=dev)

        def prefill(model, cfg):
            def args():
                return (model, scratch(cfg, 1),
                        torch.zeros((1, self.prefill_chunk),
                                    dtype=torch.int32, device=dev))
            return self._prefill_program, args

        def step_args(*pools):
            caches = [scratch(c, cap) for c, _ in pools]
            for cache, (_, pool) in zip(caches, pools):
                cache.index.copy_(pool.cache.index)
            return (*caches, torch.zeros(cap, dtype=torch.int32, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev), {},
                    torch.zeros((), dtype=torch.int64, device=dev))

        progs = {"prefill_chunk": prefill(self.model, self.cfg)}
        if self._spec is None:
            progs["decode_step"] = (
                self._decode_tokens,
                lambda: step_args((self.cfg, self.pool)))
        else:
            progs["draft_prefill_chunk"] = prefill(self.draft,
                                                   self.draft_cfg)
            progs["spec_step"] = (
                self._spec_tokens,
                lambda: step_args((self.cfg, self.pool),
                                  (self.draft_cfg, self._draft_pool)))
        return progs

    def profile(self, **kw) -> Dict[str, "object"]:
        """:class:`~bluefog_tpu_torch.observe.StepProfile` of EVERY
        resident device program (``prefill_chunk`` + ``decode_step`` for
        a plain engine; ``prefill_chunk`` + ``draft_prefill_chunk`` +
        ``spec_step`` for a speculative one), via
        :func:`bluefog_tpu_torch.observe.profile_step`.  Each program
        runs twice on its own scratch state (see :meth:`_resident`), so a
        live engine's slots, pool, prefix cache, metrics and sampling
        streams are left as they were.  Keyword args (``step_seconds``,
        card figures, ``publish``, ...) pass through."""
        from bluefog_tpu_torch.observe import profile_step

        out = {}
        with torch.no_grad():
            for name, (fn, args) in self._resident().items():
                out[name] = profile_step(fn, *args(), name=f"serving.{name}",
                                         device=self.device, **kw)
        return out

    def nonfinite_logit_rows(self) -> int:
        """How many (decode step, active slot) logit rows held a NaN or
        an infinity so far (reads the device counter)."""
        return int(self._nonfinite.item())

    # -- internals ----------------------------------------------------- #
    @staticmethod
    def _context(req: Request) -> np.ndarray:
        """The request's prefill context: the prompt, plus any tokens
        already emitted on a previous replica (failover resume)."""
        if not req.tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])

    def _restore_prefix(self, req: Request) -> int:
        """Admission-time prefix reuse: chain-hash the context's full
        chunks and copy the longest cached run into the slot (both pools
        under speculation, the MINIMUM of the two matches).  Advances
        ``_prefill_pos`` past the restored region; restores take no
        prefill budget."""
        if self.pool.prefix is None:
            return 0
        keys = self.pool.prefix.chunk_keys(self._context(req))
        req._prefix_keys = keys
        if not keys:
            return 0
        matched = self.pool.prefix.match(keys)
        if self._draft_pool is not None:
            matched = min(matched, self._draft_pool.prefix.match(keys))
        if matched:
            self.pool.restore_prefix(req.slot, keys, matched)
            if self._draft_pool is not None:
                self._draft_pool.restore_prefix(req.slot, keys, matched)
            req._prefill_pos = matched * self.prefill_chunk
            self.metrics.on_prefix_restore(
                req.rid, matched, matched * self.prefill_chunk)
        return matched

    def _prefill_one_chunk(self, req: Request) -> None:
        # chunks cover context[:-1]; the final context token goes through
        # the decode step, whose logits yield the next generated token
        c = self.prefill_chunk
        pos = req._prefill_pos
        ctx = self._context(req)
        n_prefill = ctx.size - 1
        valid = min(c, n_prefill - pos)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :valid] = ctx[pos:pos + valid]
        chunk = torch.from_numpy(chunk).to(self.device)
        pools = [(self.model, self.pool)]
        if self._draft_pool is not None:
            # the draft needs the same context in its own cache; its
            # chunk rides the target's budget slot
            pools.append((self.draft, self._draft_pool))
        for model, pool in pools:
            self._prefill_program(model, pool.cache.rows(req.slot,
                                                         req.slot + 1),
                                  chunk, valid)
        self.metrics.on_prefill_chunk()
        if (valid == c and req._prefix_keys
                and pos // c < len(req._prefix_keys)):
            # a FULL cold chunk just landed on the chunk grid: stash its
            # K/V while it provably matches the chain hash
            key = req._prefix_keys[pos // c]
            for _, pool in pools:
                pool.stash_chunk(req.slot, key, pos)
        req._prefill_pos = pos + valid
        if req._prefill_pos < n_prefill:
            return  # more chunks to go; decodes keep running meanwhile
        self._admitting = None
        self._running[req.slot] = req
        req.state = DECODE

    def _prefill_program(self, model, view, chunk: torch.Tensor,
                         valid: int = 0) -> None:
        """The prefill chunk's device program: write ``chunk``'s K/V into
        the one-row ``view`` at its index, which the model advances by
        the padded chunk; the request wrote only ``valid`` real tokens,
        so the index moves back by the rest."""
        prefill_cache(model, view, chunk)
        view.index.sub_(chunk.shape[1] - valid)

    def _sample(self, logits: torch.Tensor, decoding: Dict[int, Request],
                j: int, salt: int = 0) -> torch.Tensor:
        """Greedy argmax for every row; rows of sampling requests draw
        Gumbel noise from their own ``(seed, token index + j)``
        generator (salted for the speculative step's draft)."""
        out = logits.argmax(dim=-1).to(torch.int32)
        for slot, req in decoding.items():
            if req.temperature > 0.0:
                noise = _gumbel(req, len(req.tokens) + j, salt,
                                logits.shape[-1], self.device)
                out[slot] = (logits[slot] / req.temperature
                             + noise).argmax()
        return out

    def _step_inputs(self, decoding: Dict[int, Request]):
        cap = self.pool.capacity
        toks = np.zeros((cap,), np.int32)
        active = np.zeros((cap,), bool)
        for slot, req in decoding.items():
            # first step after prefill consumes the LAST context token;
            # afterwards the request's own stream feeds back
            toks[slot] = req.tokens[-1] if req.tokens else req.prompt[-1]
            active[slot] = True
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(active).to(self.device))

    def _decode_tokens(self, cache, tok: torch.Tensor, act: torch.Tensor,
                       decoding: Dict[int, Request],
                       nonfinite: torch.Tensor) -> torch.Tensor:
        """The decode step's device program: ``decode_horizon`` single-
        token steps over every row of ``cache``; returns the tokens
        ``[horizon, rows]``, counting active rows' non-finite logits into
        ``nonfinite``."""
        hist = []
        for j in range(self.decode_horizon):
            old_index = cache.index.clone()
            last, cache = decode_token_step(self.model, cache, tok[:, None])
            nonfinite += ((~torch.isfinite(last)).any(dim=-1) & act).sum()
            tok = torch.where(act, self._sample(last, decoding, j), tok)
            # inactive slots computed too; only their index is frozen
            cache.index.copy_(torch.where(act, cache.index, old_index))
            hist.append(tok)
        return torch.stack(hist)

    def _decode_step(self, decoding: Dict[int, Request]) -> None:
        t0 = time.perf_counter()
        tok, act = self._step_inputs(decoding)
        hist = self._decode_tokens(self.pool.cache, tok, act, decoding,
                                   self._nonfinite)
        hist = hist.cpu().numpy()  # the per-step host sync
        now = self.clock()
        self.metrics.on_decode_step(self.decode_horizon,
                                    time.perf_counter() - t0)
        for slot, req in decoding.items():
            for j in range(self.decode_horizon):
                if self._emit(req, int(hist[j, slot]), now):
                    break  # surplus horizon tokens of a retired slot are
                    # discarded (its index resets on free)

    def _spec_decode_step(self, decoding: Dict[int, Request]) -> None:
        """One draft/verify step for every slot: ``k + 1`` draft
        single-token steps (the extra one writes the last proposal's K/V,
        so the draft cache stays position-aligned whatever is accepted),
        one multi-token target forward over the window, acceptance (the
        leading run where draft == target argmax, or rejection sampling at
        temperature > 0), and the correction token.  Each slot emits
        ``n_acc + 1`` tokens and both cache indices move to ``old +
        n_emit`` (0 for inactive slots), so rejected drafts sit above the
        index, masked until real tokens overwrite them."""
        t0 = time.perf_counter()
        cur, act = self._step_inputs(decoding)
        out = self._spec_tokens(self.pool.cache, self._draft_pool.cache, cur,
                                act, decoding, self._nonfinite).cpu().numpy()
        now = self.clock()
        self.metrics.on_decode_step(1, time.perf_counter() - t0)
        emitted_n = 0
        for slot, req in decoding.items():
            for j in range(int(out[slot, -1])):
                emitted_n += 1
                if self._emit(req, int(out[slot, j]), now):
                    break  # surplus accepted tokens of a retired slot are
                    # discarded (index reset on free)
        self.metrics.on_spec_step(len(decoding), emitted_n)

    def _spec_tokens(self, cache_t, cache_d, cur: torch.Tensor,
                     act: torch.Tensor, decoding: Dict[int, Request],
                     nonfinite: torch.Tensor) -> torch.Tensor:
        """The draft/verify step's device program over every row of the
        target and draft caches: returns ``[rows, lookahead + 2]``, each
        row's emitted tokens then their count (0 for inactive rows, whose
        indices stay where they were)."""
        k = self._spec.lookahead
        old_t, old_d = cache_t.index.clone(), cache_d.index.clone()
        window, props, dlg = [], [], []
        for i in range(k + 1):
            last, _ = decode_token_step(self.draft, cache_d, cur[:, None])
            nxt = self._sample(last, decoding, i, salt=1)
            window.append(cur)
            props.append(nxt)
            dlg.append(last)
            cur = nxt
        # window = [cur, d_1..d_k] (the tokens whose K/V lands in the
        # caches); props = [d_1..d_{k+1}] (d_{k+1} is only drafted so that
        # d_k's K/V is written); dlg[i] proposed props[i]
        window = torch.stack(window, dim=1)
        props = torch.stack(props, dim=1)
        vlogits, _ = verify_window(self.model, cache_t, window)
        nonfinite += ((~torch.isfinite(vlogits)).any(dim=-1).any(dim=-1)
                      & act).sum()
        tgt = vlogits.argmax(dim=-1).to(torch.int32)        # [cap, k+1]
        # greedy acceptance: the leading run where draft == target argmax
        n_acc = (props[:, :k] == tgt[:, :k]).to(torch.int32).cumprod(
            dim=1).sum(dim=1)
        corr = tgt.gather(1, n_acc[:, None].long())[:, 0]
        sampled = {s: r for s, r in decoding.items() if r.temperature > 0.0}
        if sampled:
            dlg = torch.stack(dlg, dim=1)                   # [cap, k+1, V]
            for slot, req in sampled.items():
                n_acc[slot], corr[slot] = self._spec_sampled(
                    req, vlogits[slot], dlg[slot], props[slot], k)
        n_emit = torch.where(act, n_acc + 1, 0).to(torch.int32)
        emitted = torch.where(
            torch.arange(k + 1, device=self.device)[None] < n_acc[:, None],
            props, corr[:, None])
        cache_t.index.copy_(old_t + n_emit)
        cache_d.index.copy_(old_d + n_emit)
        return torch.cat([emitted, n_emit[:, None]], dim=1)

    def _spec_sampled(self, req: Request, vlogits: torch.Tensor,
                      dlg: torch.Tensor, props: torch.Tensor, k: int):
        """Rejection sampling for one slot at temperature > 0 (Leviathan
        et al.): accept ``d_i`` with probability ``min(1, p_i / q_i)``
        (uniform draws of salt 2), then draw the correction from the
        residual ``max(0, p - q)`` after a rejection, or from ``p`` after
        k acceptances (salt 3).  Every position's correction is drawn, so
        the choice by ``n_acc`` stays on the device.  Returns ``(n_acc,
        corr)`` as device scalars."""
        count = len(req.tokens)
        temp = req.temperature
        p = torch.softmax(vlogits / temp, dim=-1)             # [k+1, V]
        q = torch.softmax(dlg / temp, dim=-1)                 # [k+1, V]
        idx = torch.arange(k, device=self.device)
        prop = props[:k].long()
        ratio = p[idx, prop] / torch.clamp_min(q[idx, prop], 1e-30)
        u = torch.cat([_uniform(req, count + i, 2, 1, self.device)
                       for i in range(k)])
        n_acc = (u < torch.clamp_max(ratio, 1.0)).to(torch.int32).cumprod(
            0).sum()
        q_res = torch.cat([q[:k], torch.zeros_like(q[:1])])
        resid = torch.clamp_min(p - q_res, 0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 1e-30,
                            resid / torch.clamp_min(rsum, 1e-30), p)
        noise = torch.stack([_gumbel(req, count + j, 3, p.shape[-1],
                                     self.device) for j in range(k + 1)])
        corr_all = (torch.log(torch.clamp_min(resid, 1e-38))
                    + noise).argmax(dim=-1).to(torch.int32)
        return n_acc, corr_all[n_acc]

    def _emit(self, req: Request, token: int, now: float) -> bool:
        """Append one token to ``req``'s stream; True once it retired."""
        first = not req.tokens
        req.tokens.append(token)
        if first:
            self.metrics.on_first_token(req.rid, now)
        else:
            self.metrics.on_token(req.rid, now)
        return self._maybe_finish(req)

    def _maybe_finish(self, req: Request) -> bool:
        hit_eos = (req.eos_id is not None
                   and req.tokens[-1] == req.eos_id)
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self._retire(req, COMPLETED, self.clock())
            return True
        return False

    def _flush_resident(self, req: Request) -> int:
        """Flush a resident request's WRITTEN full K/V chunks into the
        prefix cache (the drain migration path), so the replica that
        inherits the request restores instead of recomputing.  A PREFILL
        resident has written ``_prefill_pos`` positions, a DECODE one
        ``context - 1`` (the last token's K/V lands with its next decode
        step, which will not run here)."""
        if self.pool.prefix is None or req.slot is None:
            return 0
        c = self.prefill_chunk
        ctx = self._context(req)
        keys = self.pool.prefix.chunk_keys(ctx)
        written = (req._prefill_pos if req.state == PREFILL
                   else ctx.size - 1)
        flushed = 0
        for i in range(min(len(keys), written // c)):
            if keys[i] not in self.pool.prefix:
                self.pool.stash_chunk(req.slot, keys[i], i * c)
                flushed += 1
            if (self._draft_pool is not None
                    and keys[i] not in self._draft_pool.prefix):
                self._draft_pool.stash_chunk(req.slot, keys[i], i * c)
        return flushed

    def _retire(self, req: Request, outcome: str, now: float) -> None:
        if req is self._admitting:
            self._admitting = None
        if self._draining and outcome in (COMPLETED, FAILOVER):
            self._drain_flushed += self._flush_resident(req)
        if req.slot is not None:
            self._running.pop(req.slot, None)
            self.pool.free(req.slot)
            if self._draft_pool is not None:
                self._draft_pool.free(req.slot)
            req.slot = None
        req.state = outcome
        self.metrics.on_retire(req.rid, now, outcome)
