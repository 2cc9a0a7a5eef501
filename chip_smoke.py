#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bluefog_tpu_torch) on one NVIDIA
card: the quickest proof that the port starts, builds its kernels, serves
and trains on the GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero, printing no result):

1. Device: the card's name and power limit (nvidia-smi), its compute
   capability; build every kernel from the sources in the checkout into
   build/torch_kernels/ (one nvcc per source, all started together).
2. Kernels against plain (CUDA events, median of 25 runs, each after a
   write of 128 MB that evicts the 50 MB L2 and a ~0.1 ms device spin
   that hides the host's launch time; the bound is the larger of the
   bytes the call must move over the card's memory rate and its
   operations over the peak rate of its input type):
   a. K4 split-KV decode attention, bf16 and int8 cache, at the serving
      shapes of Llama-3.1-8B (B=8, KV=8, rep=4, D=128, S 2048 and 8192,
      positions drawn per row from --seed with rows at 0 and S-1, and a
      second set with rows either side of the split boundaries, checked
      only) and one small odd f32 shape, bit-equal across two runs, SDPA
      beside it on the drawn positions (at S=2048 also timed without the
      spin, the host's launch gap included); at S=2048 the tolerance
      rejects a planted merge that drops each row's last live split;
   b. K1 1x1-conv backward at the 7 distinct ResNet-50 shapes of batch
      128 in bf16 (the fused wgmma kernel at stage 1, two wgmma GEMMs
      elsewhere) and two small f32 shapes: max |err| of dx and dw, dx
      and dw bit-equal across two runs, kernel, plain and bound ms, the
      two cuBLAS products dy @ w.T and x.T @ dy as the library
      yardstick, each shape's launches per rank-step, and the sums of
      kernel, bound and cuBLAS ms over a rank-step's 20 launches.
   c. K2, K3a, K3b flash attention forward, dQ and dK/dV at the Llama
      training shape (B=4, T=2048, H=32, KV=8, D=128, causal, bf16), the
      ViT-B/16 shape (B=128, T=200, H=12, D=64, non-causal, bf16), the
      Llama-1B shape (D=64) and at small odd shapes (f32; D 16 and 64; T
      100 and 1000; rep 1, 2, 4; non-causal; every row masked by
      kv_offset=64; q_offset=128): max |err| per output, every output
      bit-equal across two runs; K2 (the wgmma kernel in bf16 at D 64 and
      128) and SDPA's forward timed at every shape; at the three model
      shapes K3a's and K3b's (wgmma) kernel, plain, bound and library ms
      (SDPA's backward for K3a + K3b together), K2's at the training
      shape (SDPA's forward), and there three planted faults in K3a's
      key tiles.
   d. K5, splash attention's fused one-pass backward, at the Llama-1B
      training shape (B=4, T=2048, H=32, KV=8, D=64, causal, bf16), at
      8B width (D=128) and at small odd shapes (f32 D 16 and 64, bf16
      D 32; T 100, 128, 1000; rep 1, 2, 4): each dQ/dK/dV entry within
      its bound, bit-equal across two runs; at the 1B shape the bound
      rejects K5's planted faults at the kernel's own dQ span and query
      step (256 keys and 64 rows for the wgmma kernel); at both training
      shapes K5 (its main kernel and dQ sum apart, with the partials'
      count and bytes), K3a + K3b, plain, SDPA's backward and bound ms.
3. Serving: Llama-3.1-8B at full width (32 layers, random bf16 weights
   from --seed at flax's initializer scales) through ServingEngine
   (capacity 8, max_len 2048, prefill chunk 256): 16 requests, prompt
   lengths 16-1500, 32-128 new tokens, half greedy and half at
   temperature 0.8; then 4 requests with the int8 K/V cache.  Every
   request must complete its budget with finite logits, and the kernel's
   launch count in the run must equal n_layers x decode steps.  A
   torch.profiler window of 10 decode steps gives the device-busy share
   and K4's ms per step.
4. Reference (serving): the tiny f32 config served on the card (kernel)
   and on the CPU (plain version) emits the same greedy tokens, both
   cache layouts.
5. Train, 1 rank: ResNet-50 (pallas_conv1x1=True, bf16 compute, f32
   params, train-mode batch norm) through build_train_step,
   comm_mode="none", SGD(0.1, momentum 0.9), synthetic ImageNet batches
   of 128 x 224 x 224 x 3 from --seed; bench.py's protocol: 5 warm-up
   steps, 3 windows of 10 steps, the median window.  img/s per card,
   step ms, peak memory; finite losses; K1 launched 20 x steps times.
   Then torch.profiler over 3 steps: device-busy share, top kernels and
   K1's share of the device time.
6. Train, 4 ranks stacked on the card: atc over
   uniform_topology_spec(ExponentialTwoGraph(4)), batch 128 per rank, 2
   warm-up and 5 timed steps; img/s per card, the combine's ms per step
   (CUDA events); K1 launched 20 x 4 x steps times; and after 3 steps
   from one state on the same per-rank data (batch 16), the consensus
   distance under atc is below that of comm_mode="none".
6b. Train-step modes, 4 ranks stacked, ResNet-50 at full width, batch
   128 per rank, each mode its own build (2 warm-up, 3 timed steps, then
   one step under torch.profiler for the device-busy ms), plain atc
   first as the yardstick, then: atc with guard= and health= (a NaN in rank 2's images at step 3: skipped
   [0, 0, 1, 0], rank 2's momentum and batch statistics kept bit for bit,
   params finite, HealthVector finite but for the planted rank's loss,
   grad and update norms), cta with overlap="bucketed" (4 buckets;
   bit-equal to plain cta after 2 steps from one state), atc with
   compress="int8_sr", atc with MixCompressConfig(0.25, "int8"), atc
   with hierarchical_local_size=2 over ExponentialTwoGraph(2), and
   push_sum (ps weights sum to 4).  img/s per card, step ms, peak
   memory, the combine's ms where the step exposes it, MixState bytes;
   K1 launched 20 x 4 x steps times and no other kernel; the host syncs
   of one steady step (torch.cuda.set_sync_debug_mode) no more than plain
   atc's; under int8_sr and top-k, phase 6's consensus check.
7. Reference (training): a tiny f32 ResNet trained 3 atc steps over 4
   ranks on the card (kernel) and on the CPU (plain version) gives the
   same params, batch statistics and losses within f32 tolerance.
7b. Reference (train-step modes): the tiny f32 ResNet of phase 7, 3
   steps over 4 ranks, card against host, for the guard with health,
   bucketed cta, top-k mixing, the hierarchical exchange and push-sum:
   params, statistics, losses, skip flags and HealthVector within phase
   7's tolerance; int8_sr on the card only, finite and bit-equal across
   two runs from one seed.
8. Llama train, 1 rank: Llama-3.1-8B's width (dim 4096, 32 heads, 8 kv
   heads, ffn 14336, vocab 128256, llama3 rope) cut to 4 layers,
   attn_impl="flash", f32 master params and bf16 compute, SGD(1e-3,
   momentum 0.9), comm_mode="none", batch 4 x 2048 synthetic tokens
   from --seed (examples/llama_benchmark.py's protocol: 3 warm-up and
   10 timed steps).  tokens/s per card, step ms, MFU over 989 TFLOP/s,
   peak memory, losses finite near ln(vocab); K2, K3a and K3b launched
   n_layers x steps times each.  torch.profiler over 2 steps: device
   busy share, top kernels, the attention kernels' and the f32 head's
   shares.  Then one window of 10 steps with logits_dot_in_fp32=False.
9. Llama train, 2 ranks stacked on the card: the same width at 2
   layers, atc over uniform_topology_spec(ExponentialTwoGraph(2)), 4 x
   2048 per rank: tokens/s per card, the combine's ms per step, launch
   counts; then, after 3 steps from one state on different per-rank data
   (1 x 512 per rank), the consensus distance under atc is below that
   under comm_mode="none".
10. Reference (Llama training): a tiny f32 Llama with attn_impl="flash"
   trained 3 atc steps over 2 ranks on the card (kernels) and on the
   CPU (plain versions) gives the same params and losses.
11. Llama-1B train, 1 rank, full depth and width (examples/
   llama_benchmark.py --model 1b: vocab 32000, dim 2048, 16 layers, 32
   heads, 8 kv heads, ffn 5632; remat=True), f32 master params, bf16
   compute, the f32 head, SGD(1e-3, momentum 0.9), batch 4 x 2048 from
   --seed, 3 warm-up and 10 timed steps per window: (a) splash, remat
   policy "none" (K2 2 x 16 x 13 launches, K5 16 x 13, K3a/K3b none);
   (b) flash (K3a/K3b 16 x 13 each, K5 none); (c) splash with remat
   policy "dots".  tokens/s per card, step ms, MFU, peak memory, losses
   finite near ln(vocab); torch.profiler over 2 steps of each window.
12. Llama-1B, splash, 2 ranks stacked, atc over ExponentialTwoGraph(2),
   2 warm-up and 3 timed steps: tokens/s per card, combine ms, peak
   memory, launch counts.
13. Reference (splash): the tiny f32 Llama with attn_impl="splash", T =
   128, 3 atc steps over 2 ranks, card (K2, K5) against host.
14. ViT-B/16 (attn_impl="flash": K2/K3a/K3b non-causal at T = 200),
   batch 128 of 224 x 224 images, bf16 compute, 1 rank, 3 warm-up and
   10 timed steps: img/s, step ms, peak memory, 12 x 13 launches of
   each kernel; then a tiny f32 ViT after 3 atc steps over 2 ranks, card
   against host.
15. The eager bf.* API: every op of the flat API (allreduce average and
   sum, broadcast, allgather uniform and variable, neighbor_allreduce
   static, weighted and dynamic with dst_weights, the hierarchical form
   at local_size 2, neighbor_allgather regular and ragged, pair_gossip,
   win_put / win_get / win_accumulate / win_update /
   win_update_then_collect with versions and associated p) on 8 ranks
   stacked on the card against the same calls on the host, f32 and bf16
   from --seed: the worst |err| over its tolerance per op; poll behind a
   device spin reads False then True and never blocks; a nonblocking
   dynamic neighbor_allreduce with new weight values makes 0 host syncs
   before its synchronize.
16. Eager wrappers: ResNet-50 at full width, 4 stacked ranks over
   ExponentialTwoGraph(4), batch 128 per rank, SGD(0.1, momentum 0.9)
   wrapped in the ATC, CTA (neighbor allreduce), gradient-allreduce,
   win-put and push-sum optimizers; each rank's forward and backward
   through ResNet.apply, .grad written rank-major, opt.step(); 2 warm-up
   and 3 timed steps, then one profiled step: img/s per card, step ms,
   device-busy ms and share, peak memory, window bytes; K1 20 x 4 x 6
   launches and no other kernel; push-sum's weights sum to 4; the eager
   ATC wrapper and build_train_step(comm_mode="atc") from one state on
   the same data agree after 2 steps (and whether bit-equal).
17. Reference (eager wrappers): the tiny f32 ResNet of phase 7, 3 eager
   steps over 4 ranks, card (K1) against host, for the six wrappers and
   CompressedOptimizer(TopK) over ATC, within phase 7's tolerance.

The line before the last is a JSON object with one entry per kernel
(seven); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# device-memory rate by card name (NVIDIA data sheets), bytes/s
MEM_RATE = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12), ("H200", 4.8e12))
# dense peak by input type (H100 SXM data sheet), operations/s
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
KERNEL_SOURCES = ["decode_attention", "conv1x1_backward", "flash_attention",
                  "splash_backward"]


def log(*a):
    print(*a, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def time_ms(fn, flush: torch.Tensor, reps: int = 25,
            spin: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after two
    warm-up runs, each run preceded by a write of ``flush`` and (``spin``)
    a ~0.1 ms device-side spin, so that the host's time to launch ``fn``
    overlaps device work and the events time the device alone.  Without
    the spin a small kernel's time includes the host's launch gap."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def phase_device():
    from bluefog_tpu_torch import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{name}, compute capability {torch.cuda.get_device_capability(0)}"
        f", {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    libs = cuda_build.build(KERNEL_SOURCES)
    log(f"[device] built {len(libs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s into {cuda_build.build_dir()}")
    return name


def _case_bytes_ops(q, k, idx, quantized):
    b, _, n_q, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    n_pos = (idx.clamp(max=s - 1) + 1).sum().item()
    per_pos = 2 * n_kv * d * k.element_size() + (8 * n_kv if quantized
                                                 else 0)
    nbytes = (2 * q.numel() * q.element_size() + idx.numel() * 4
              + n_pos * per_pos)
    ops = 4 * (n_q // n_kv) * n_kv * d * n_pos  # two mult-adds per element
    return nbytes, ops


def _ratio_to_tol(got, want, tol):
    """Largest |got - want| over allclose's bound atol + rtol * |want|
    (atol = rtol = tol): at most 1 passes."""
    want = want.float()
    return ((got.float() - want).abs() / (tol + tol * want.abs())).max().item()


def phase_kernels(name, seed):
    """K4 against its plain version at the serving shapes (B=8, KV=8,
    rep=4, D=128, S 2048 and 8192, bf16 and int8 caches) and a small odd
    f32 shape, bit-equal across two runs, on two sets of positions: one
    drawn per row from ``seed`` with rows at 0 and S-1 (the timed set),
    and at B=8 the same with rows one before, at and one after the split
    boundaries of the kernel's split (decode_attention.split_len),
    checked only.  Kernel, plain, SDPA and bound ms on the drawn set; at
    the serving shape the kernel and SDPA also without the device spin
    (the host's launch gap included), and the tolerance must reject a
    planted fault: the merge dropping each row's last live split
    (decode_attention_split_plain with one split fewer)."""
    from bluefog_tpu_torch.models.llama import _amax_quantize
    from bluefog_tpu_torch.parallel import decode_attention as da

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(8, 8, 4, 2048, 128, torch.bfloat16),
             (8, 8, 4, 8192, 128, torch.bfloat16),
             (3, 2, 1, 40, 16, torch.float32)]
    results = {}
    for b, n_kv, rep, s, d, dt in cases:
        q = torch.randn(b, 1, n_kv * rep, d, generator=g, device="cuda",
                        dtype=dt)
        k = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=dt)
        v = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=dt)
        split = da.split_len(s, b * n_kv, sms)
        idx = torch.randint(0, s, (b,), generator=g, device="cuda",
                            dtype=torch.int32)
        idx[0], idx[1] = 0, s - 1
        checked = [idx]
        if b == 8:   # around the split boundaries
            edges = idx.clone()
            edges[2:6] = torch.tensor([split - 1, split, split + 1,
                                       3 * split - 1], dtype=torch.int32)
            checked.append(edges)
        kq, ks = _amax_quantize(k)
        vq, vs = _amax_quantize(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        tol = 1.6e-2 if dt == torch.bfloat16 else 1e-5
        serving = (b, s, d) == (8, 2048, 128)
        for quantized in (False, True):
            if quantized:
                kname = "decode_attention_int8"
                run = lambda ix: da.decode_attention_int8(  # noqa: E731
                    q, kq, ks, vq, vs, ix)
                kv, scales = (kq, vq), (ks, vs)
            else:
                kname = "decode_attention"
                run = lambda ix: da.decode_attention(q, k, v, ix)  # noqa
                kv, scales = (k, v), ()
            cache = kv[0]
            plain = lambda ix: da.decode_attention_plain(  # noqa: E731
                q, *kv, ix, *scales)
            err = 0.0
            for ix in checked:
                out, again = run(ix), run(ix)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"{kname} B={b} S={s} idx="
                                         f"{ix.tolist()}: two runs differ")
                ref = plain(ix)
                e = (out.float() - ref.float()).abs().max().item()
                ratio = _ratio_to_tol(out, ref, tol)
                if ratio > 1:
                    raise AssertionError(
                        f"{kname} B={b} S={s} D={d} {dt} idx={ix.tolist()}:"
                        f" max |err| {e} beyond atol=rtol={tol}")
                err = max(err, e)
                log(f"[kernel] {kname} B={b} KV={n_kv} rep={rep} S={s} "
                    f"D={d} q={str(dt).split('.')[-1]} split={split} "
                    f"idx={ix.tolist()}: max|err| {e:.3g} ({ratio:.3g} of "
                    f"atol=rtol={tol}), bit-equal across two runs")
            if serving:
                # planted fault: a merge one split short in every row
                ix = checked[-1]
                ref = plain(ix)
                live = ix.long().clamp(max=s - 1) // split + 1
                bad = da.decode_attention_split_plain(
                    q, *kv, ix, split, *scales, n_live=live - 1)
                bad_ratio = _ratio_to_tol(bad, ref, tol)
                multi = live > 1   # rows that keep some splits
                multi_ratio = _ratio_to_tol(bad[multi], ref[multi], tol)
                if bad_ratio <= 1 or multi_ratio <= 1:
                    raise AssertionError(f"{kname}: the tolerance passes a "
                                         "merge that drops the last split")
                log(f"[kernel] planted K4 fault, the merge drops each row's "
                    f"last live split ({kname}, split {split}): "
                    f"{bad_ratio:.3g} times the tolerance, {multi_ratio:.3g}"
                    f" over the rows with more than one split; rejected")
            ms = time_ms(lambda: run(idx), flush)
            plain_ms = time_ms(lambda: plain(idx), flush)
            library_ms = sdpa = None
            if not quantized:
                # yardstick only: one PyTorch call computing the same
                # function (the port never calls it)
                qs = q.reshape(b, n_kv * rep, 1, d)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= idx[:, None].long())[:, None, None, :]
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
                    qs, k, v, attn_mask=mask, enable_gqa=True)
                lib = sdpa().reshape(b, 1, n_kv * rep, d)
                lib_err = (lib.float() - plain(idx).float()).abs().max()
                if lib_err.item() > 4 * tol + 1e-2:
                    raise AssertionError(f"library yardstick disagrees by "
                                         f"{lib_err.item()}")
                library_ms = time_ms(sdpa, flush)
            nbytes, ops = _case_bytes_ops(q, cache, idx, quantized)
            t_bytes = nbytes / rate * 1e3
            t_ops = ops / PEAK_OPS[cache.dtype] * 1e3
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations", library_ms=library_ms)
            log(f"[kernel] {kname} B={b} S={s} D={d} idx={idx.tolist()} "
                f"timed: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
                f"{'' if library_ms is None else f' (kernel/library {ms / library_ms:.3f})'}"
                f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB)")
            if serving:
                gap_ms = time_ms(lambda: run(idx), flush, spin=False)
                gap = f"kernel {gap_ms:.4f} ms"
                if sdpa is not None:
                    lib_gap = time_ms(sdpa, flush, spin=False)
                    gap += (f", library {lib_gap:.4f} ms (kernel/library "
                            f"{gap_ms / lib_gap:.3f})")
                log(f"[kernel] {kname} B={b} S={s} timed without the device"
                    f" spin (the host's launch gap included): {gap}")
                results[kname] = rec
    return results


def _requests(rng, n, vocab):
    from bluefog_tpu_torch.serving import Request

    reqs = []
    for i in range(n):
        plen = int(rng.randint(16, 1501))
        reqs.append(Request(
            rng.randint(0, vocab, (plen,)).astype(np.int32),
            int(rng.randint(32, 129)),
            temperature=0.0 if i % 2 == 0 else 0.8, seed=1000 + i))
    return reqs


def _serve(model, cfg, kv_quant, reqs, counter):
    """Serve ``reqs`` on a fresh engine with the launch counts set to 0
    just before; returns (summary, launches of ``counter``)."""
    from bluefog_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, cfg, capacity=8, max_len=2048,
                        prefill_chunk=256, kv_quant=kv_quant)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    m = eng.metrics.summary()
    bad = [r.rid for r in reqs
           if r.state != "completed" or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"requests {bad} did not complete their budget")
    if eng.nonfinite_logit_rows():
        raise AssertionError(f"{eng.nonfinite_logit_rows()} logit rows "
                             "were not finite")
    _expect_launches(f"serve kv_quant={kv_quant} (n_layers x decode steps)",
                     {counter: cfg.n_layers * m["decode_steps"]})
    log(f"[serve] kv_quant={kv_quant}: {len(reqs)} requests, "
        f"{m['tokens_generated']} tokens in {wall:.2f} s wall; tokens/s "
        f"{m['tokens_per_sec']:.1f}, TTFT p50 {m['ttft_p50'] * 1e3:.1f} ms,"
        f" decode step p50 {m['decode_step_ms_p50']:.2f} ms over "
        f"{m['decode_steps']} steps, {m['prefill_chunks']} prefill chunks, "
        f"{counter} launches {launches[counter]}")
    return m, launches[counter]


def _device_kernels(prof):
    """The profile's device kernels by name: CUDA events without the user
    annotations (``Optimizer.step#SGD.step`` spans kernels already
    counted, and would count them twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _profile_decode(model, cfg, reqs, steps=10):
    """torch.profiler over ``steps`` engine steps once all ``reqs`` are
    decoding: the device's busy share of the window and the kernels that
    take its time."""
    from torch.profiler import ProfilerActivity, profile

    from bluefog_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, cfg, capacity=8, max_len=2048,
                        prefill_chunk=256)
    for r in reqs:
        eng.submit(r)
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events)
    k4 = sum(e.self_device_time_total for e in events
             if "decode_split_kernel" in e.key
             or "decode_merge_kernel" in e.key)
    active = sum(r.state == "decode" for r in reqs)
    log(f"[profile] {steps} decode steps ({active} slots decoding): wall "
        f"{wall_us / steps / 1e3:.2f} ms/step, device busy "
        f"{busy / steps / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}%), "
        f"K4 (split + merge) {k4 / steps / 1e3:.3f} ms/step "
        f"({100 * k4 / max(busy, 1):.1f}% of device time)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:90]}")


def phase_serving(seed):
    import bluefog_tpu_torch as bt

    cfg = bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3")
    t0 = time.perf_counter()
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] Llama-3.1-8B: {n_params / 1e9:.2f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card, "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    # warm-up (cuBLAS handles, first launches), not measured
    from bluefog_tpu_torch.serving import Request
    _serve(model, cfg, "none", [Request(np.arange(300) % 997, 4)],
           "decode_attention")
    _, launches = _serve(model, cfg, "none",
                         _requests(rng, 16, cfg.vocab_size),
                         "decode_attention")
    _, launches8 = _serve(model, cfg, "int8",
                          _requests(rng, 4, cfg.vocab_size),
                          "decode_attention_int8")
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    _profile_decode(model, cfg, _requests(rng, 8, cfg.vocab_size))
    del model
    torch.cuda.empty_cache()
    return {"decode_attention": launches, "decode_attention_int8": launches8}


def phase_reference(seed):
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.serving import Request, ServingEngine

    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 9, 3, 17)]
    cpu_model = bt.Llama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    gpu_model = bt.Llama(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    for kv_quant in ("none", "int8"):
        outs = []
        for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
            eng = ServingEngine(model, cfg, capacity=2, max_len=48,
                                prefill_chunk=4, kv_quant=kv_quant,
                                device=dev)
            reqs = [eng.submit(Request(p, 8)) for p in prompts]
            eng.run()
            outs.append([r.output() for r in reqs])
        for a, b in zip(*outs):
            if not np.array_equal(a, b):
                raise AssertionError(f"kv_quant={kv_quant}: card {a} != "
                                     f"host {b}")
        log(f"[reference] tiny f32, kv_quant={kv_quant}: "
            f"{len(prompts)} greedy requests token-exact, card vs host")


FLASH_OUTPUTS = {"flash_forward": ("out",), "flash_backward_dq": ("dq",),
                 "flash_backward_dkv": ("dk", "dv")}
FLASH_REPLACES = {
    "flash_forward": "bluefog_tpu/parallel/pallas_attention.py:107",
    "flash_backward_dq": "bluefog_tpu/parallel/pallas_attention.py:267",
    "flash_backward_dkv": "bluefog_tpu/parallel/pallas_attention.py:309"}


def _live_pairs(t, s_len, causal, q_off, kv_off):
    """(query, key) pairs under the mask: the work the kernels do."""
    if not causal:
        return t * s_len
    rows = np.arange(t)
    return int(np.clip(q_off + rows - kv_off + 1, 0, s_len).sum())


def _flash_err(got, want, terms, what):
    """max |got - want|, after :func:`flash_check.mismatch` holds every
    entry to its own bound."""
    from bluefog_tpu_torch.parallel import flash_check

    ratio = flash_check.mismatch(got, want, terms)
    err = (got.float() - want.float()).abs().max().item()
    if ratio > 1:
        raise AssertionError(f"{what}: max |err| {err}, {ratio:.3g} times "
                             "its bound")
    return err, ratio


def phase_flash(name, seed):
    """K2, K3a and K3b against their plain versions at every shape of
    ``flash_check.CASES``, each entry of out, dQ, dK and dV within its
    own bound (``flash_check.mismatch``: bf16 two ulps of the entry plus
    2**-7 of the sizes of the terms whose bf16 rounding may differ and
    2**-12 of the largest such size, f32 1e-5 of the largest); lse (f32)
    within 1e-4 absolute plus 1e-5; every output bit-equal across two
    runs.  At the training shape the bound must also reject three planted
    faults (``flash_check.planted_faults`` at K3a's key tile).  K2 and
    SDPA's forward are timed at every shape; K3a, K3b, their plain
    versions and SDPA's backward at the three model shapes
    (``CASES[:3]``); the kernels line takes the training shape's."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import flash_check

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    results = {}
    for case in flash_check.CASES:
        b, t, h, kv, d, dt, causal, q_off, kv_off = case
        q, do = (torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, t, kv, d, generator=g, device="cuda").to(dt)
                for _ in range(2))
        args = (causal, None, q_off, kv_off)
        what = (f"flash B={b} T={t} H={h} KV={kv} D={d} "
                f"{str(dt).split('.')[-1]} causal={causal} q_offset={q_off}"
                f" kv_offset={kv_off}")
        out, lse = fa.flash_forward(q, k, v, *args)
        out2, lse2 = fa.flash_forward(q, k, v, *args)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        grads = [fa.flash_backward_dq(q, k, v, do, lse, delta, *args),
                 *fa.flash_backward_dkv(q, k, v, do, lse, delta, *args)]
        again = [fa.flash_backward_dq(q, k, v, do, lse, delta, *args),
                 *fa.flash_backward_dkv(q, k, v, do, lse, delta, *args)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"{what}: two backward runs differ")
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{what}: two forward runs differ")
        del out2, lse2
        ref_out, ref_lse = fa.flash_forward_plain(q, k, v, *args)
        ref = dict(zip(("out", "dq", "dk", "dv"),
                       (ref_out, *fa.flash_backward_plain(
                           q, k, v, do, lse, delta, *args))))
        terms = flash_check.term_sizes(q, k, v, do, lse, delta, *args)
        errs, ratios = {}, {}
        for key, got in zip(ref, (out, *grads)):
            errs[key], ratios[key] = _flash_err(got, ref[key], terms[key],
                                                f"{what} {key}")
        errs["lse"] = (lse - ref_lse).abs().max().item()
        if not torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{what}: lse differs by {errs['lse']}")
        if causal and kv_off > q_off:   # rows before kv_off - q_off: no key
            dead = kv_off - q_off
            if (out[:, :dead].any() or grads[0][:, :dead].any()
                    or not bool((lse[..., :dead] == -1e30).all())):
                raise AssertionError(f"{what}: masked rows are not exact")
            if dead >= t and (grads[1].any() or grads[2].any()):
                raise AssertionError(f"{what}: masked dK/dV are not zero")
        log(f"[kernel] {what}: max|err| "
            + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
            + "; of its bound "
            + ", ".join(f"{k_} {r:.3g}" for k_, r in ratios.items())
            + "; out, lse, dQ, dK, dV bit-equal across two runs")
        if case == flash_check.CASES[0]:
            # each fault lies in the kernels' own tiles: K3a's key step
            for fault, key, bad in flash_check.planted_faults(
                    q, k, v, do, lse, delta, ref, tile=fa.DQ_KEY_TILE):
                ratio = flash_check.mismatch(bad, ref[key], terms[key])
                if ratio <= 1:
                    raise AssertionError(f"{what}: the bound passes a "
                                         f"planted fault ({fault}, {key})")
                log(f"[kernel] planted fault, {fault}: {key} at {ratio:.3g} "
                    "times its bound, rejected")
                del bad
        del ref, ref_out, ref_lse, again, terms
        # K2 at every shape, SDPA's forward beside it (a yardstick of
        # speed only: it takes no offsets)
        pairs = _live_pairs(t, t, causal, q_off, kv_off)
        k2_ms = time_ms(lambda: fa.flash_forward(q, k, v, *args), flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        sdpa_ms = time_ms(sdpa, flush)
        ops = 4 * b * h * pairs * d
        es = q.element_size()
        nbytes = 2 * b * t * (h + kv) * d * es + b * h * t * 4
        bound = max(nbytes / rate, ops / PEAK_OPS[dt]) * 1e3
        k2_kernel = ("wgmma" if dt == torch.bfloat16 and d >= 64 else
                     "mma.sync" if dt == torch.bfloat16 else "f32 FMA")
        plain = ""
        if case in flash_check.CASES[:3]:   # the models' shapes
            plain_ms = time_ms(
                lambda: fa.flash_forward_plain(q, k, v, *args), flush, reps=5)
            plain = f", plain {plain_ms:.4f} ms"
        log(f"[kernel] K2 ({k2_kernel}) at {what}: {k2_ms:.4f} ms "
            f"({ops / k2_ms / 1e9:.1f} TFLOP/s), SDPA forward {sdpa_ms:.4f}"
            f" ms (K2/SDPA {k2_ms / sdpa_ms:.3f}){plain}, bound "
            f"{bound:.4f} ms")
        if case not in flash_check.CASES[:3]:
            continue
        # the models' shapes: K3a's and K3b's kernel, plain, bound and
        # library times (and K2's at the training shape, the kernels line's
        # entry for all three)
        first = case == flash_check.CASES[0]
        n_q, n_kv = b * t * h * d * es, b * t * kv * d * es
        n_row = b * h * t * 4
        timed = {
            "flash_forward": (
                lambda: fa.flash_forward(q, k, v, *args),
                lambda: fa.flash_forward_plain(q, k, v, *args),
                2 * n_q + 2 * n_kv + n_row, 4 * b * h * pairs * d),
            "flash_backward_dq": (
                lambda: fa.flash_backward_dq(q, k, v, do, lse, delta, *args),
                lambda: fa.flash_backward_dq_plain(
                    q, k, v, do, lse, delta, causal, d ** -0.5, q_off,
                    kv_off),
                3 * n_q + 2 * n_kv + 2 * n_row, 6 * b * h * pairs * d),
            "flash_backward_dkv": (
                lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta, *args),
                lambda: fa.flash_backward_dkv_plain(
                    q, k, v, do, lse, delta, causal, d ** -0.5, q_off,
                    kv_off),
                2 * n_q + 4 * n_kv + 2 * n_row, 8 * b * h * pairs * d),
        }
        # yardstick only: SDPA on the [B, H, T, D] views, its forward for
        # K2 and its backward (forward subtracted) for K3a + K3b together
        # (the port never calls it)
        dot = do.transpose(1, 2)
        lib_err = (sdpa().transpose(1, 2).float() - out.float()).abs().max()
        if lib_err.item() > 0.05:
            raise AssertionError(f"SDPA yardstick disagrees by {lib_err}")
        lib_fwd = sdpa_ms
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)

        lib_bwd = (time_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves,
                                                       dot), flush)
                   - time_ms(sdpa_fwd, flush))
        pair_ms = 0.0
        for kname, (run, plain, nbytes, ops) in timed.items():
            if kname == "flash_forward" and not first:
                continue  # K2 timed above at every shape
            ms = time_ms(run, flush)
            plain_ms = time_ms(plain, flush, reps=5)
            t_bytes, t_ops = nbytes / rate * 1e3, ops / PEAK_OPS[dt] * 1e3
            lib = lib_fwd if kname == "flash_forward" else lib_bwd
            rec = dict(
                max_abs_err=max(errs[o] for o in FLASH_OUTPUTS[kname]),
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib)
            if first:
                results[kname] = rec
            if kname != "flash_forward":
                pair_ms += ms
            log(f"[kernel] {kname} at {what}: kernel {ms:.4f} "
                f"ms ({ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
                f"ms, library {lib:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}, {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.1f} GFLOP)")
        log(f"[kernel] K3a + K3b at {what}: {pair_ms:.4f} ms, SDPA's "
            f"backward {lib_bwd:.4f} ms (pair/SDPA {pair_ms / lib_bwd:.3f})")
    return results


def _kernel_split_ms(fn, names, reps=5):
    """torch.profiler over ``reps`` calls of ``fn``: device ms per call of
    each group of kernel symbols in ``names`` ({label: (symbols,)})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    return {label: sum(e.self_device_time_total for e in events
                       if any(n in e.key for n in syms)) / reps / 1e3
            for label, syms in names.items()}


def phase_splash(name, seed):
    """K5 against its plain version at every shape of
    ``flash_check.SPLASH_CASES`` (causal, no offsets), each entry of dQ,
    dK and dV within its own bound (``flash_check.mismatch``, the bound of
    phase 2c), dQ/dK/dV bit-equal across two runs.  At the Llama-1B
    training shape the bound must also reject K5's planted faults
    (``flash_check.splash_planted_faults``).  At both training shapes:
    K5 (with its dQ sum), K3a + K3b, SDPA's backward (the yardstick) and
    the bound, and the sum pass's share of K5 (torch.profiler)."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import flash_check
    from bluefog_tpu_torch.parallel import splash as sp

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed + 2)
    results = {}
    for case in flash_check.SPLASH_CASES:
        b, t, h, kv, d, dt = case
        q, do = (torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, t, kv, d, generator=g, device="cuda").to(dt)
                for _ in range(2))
        what = (f"splash B={b} T={t} H={h} KV={kv} D={d} "
                f"{str(dt).split('.')[-1]}")
        out, lse = fa.flash_forward(q, k, v)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        del out
        grads = sp.splash_backward(q, k, v, do, lse, delta)
        again = sp.splash_backward(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"{what}: two K5 runs differ")
        del again
        ref = dict(zip(("dq", "dk", "dv"),
                       sp.splash_backward_plain(q, k, v, do, lse, delta)))
        terms = flash_check.term_sizes(q, k, v, do, lse, delta)
        errs, ratios = {}, {}
        for key, got in zip(ref, grads):
            errs[key], ratios[key] = _flash_err(got, ref[key], terms[key],
                                                f"{what} {key}")
        log(f"[kernel] {what}: max|err| "
            + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
            + "; of its bound "
            + ", ".join(f"{k_} {r:.3g}" for k_, r in ratios.items())
            + "; dQ, dK, dV bit-equal across two runs")
        if case == flash_check.SPLASH_CASES[0]:
            # at the kernel's own span and query step (the wgmma kernel's
            # 256 keys and 64 rows at this shape)
            span = sp._key_tile(dt, d)
            for fault, key, bad in flash_check.splash_planted_faults(
                    q, k, v, do, lse, delta, ref, tile=span,
                    rows=64 if span > 64 else 32):
                ratio = flash_check.mismatch(bad, ref[key], terms[key])
                if ratio <= 1:
                    raise AssertionError(f"{what}: the bound passes a "
                                         f"planted fault ({fault}, {key})")
                log(f"[kernel] planted K5 fault, {fault}: {key} at "
                    f"{ratio:.3g} times its bound, rejected")
                del bad
        del ref, terms, grads
        if case not in flash_check.SPLASH_CASES[:2]:
            continue
        # the training paths' shapes: kernel, plain, bound and library
        pairs = _live_pairs(t, t, True, 0, 0)
        es = q.element_size()
        n_q, n_kv, n_row = b * t * h * d * es, b * t * kv * d * es, b * h * t * 4
        nbytes = 3 * n_q + 4 * n_kv + 2 * n_row
        ops = 10 * b * h * pairs * d
        run = lambda: sp.splash_backward(q, k, v, do, lse, delta)  # noqa
        ms = time_ms(run, flush)
        plain_ms = time_ms(lambda: sp.splash_backward_plain(
            q, k, v, do, lse, delta), flush, reps=5)
        k3_ms = time_ms(lambda: (
            fa.flash_backward_dq(q, k, v, do, lse, delta),
            fa.flash_backward_dkv(q, k, v, do, lse, delta)), flush)
        split = _kernel_split_ms(run, {"main": ("k5_wgmma", "k5_tc"),
                                       "sum": ("k5_sum",)})
        # the dQ partials: each live (row, span) pair's D f32 written by
        # the main kernel and read back by the sum
        span = sp._key_tile(dt, d)
        part_bytes = b * h * d * 4 * sp.partial_rows(t, span)
        # yardstick only: SDPA's backward (forward subtracted) on the
        # [B, H, T, D] views (the port never calls it)
        leaves = [x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)

        lib = (time_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves, dot),
                       flush) - time_ms(sdpa_fwd, flush))
        t_bytes, t_ops = nbytes / rate * 1e3, ops / PEAK_OPS[dt] * 1e3
        rec = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib)
        log(f"[kernel] splash_backward at {what}: K5 {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TFLOP/s; main kernel {split['main']:.4f}"
            f" ms, dQ sum {split['sum']:.4f} ms = "
            f"{100 * split['sum'] / (split['main'] + split['sum']):.1f}%; "
            f"{math.ceil(t / span)} partials of {span} keys, "
            f"{part_bytes / 1e6:.1f} MB written and read back), "
            f"K3a + K3b {k3_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"backward {lib:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} GFLOP)")
        if case == flash_check.SPLASH_CASES[0]:
            results["splash_backward"] = rec
        del q, k, v, do, lse, delta, leaves
        torch.cuda.empty_cache()
    return results


# ResNet-50 at batch 128: the distinct (N, ci, co) of its 20 K1 launches
# per rank-step (16 expansions, 4 projections; stage 1's projection has
# its expansion's shape) with their launches per rank-step, then two small
# f32 shapes
K1_SHAPES = [(401408, 64, 256, torch.bfloat16, "stage 1 expand x3 + proj", 4),
             (100352, 128, 512, torch.bfloat16, "stage 2 expand x4", 4),
             (100352, 256, 512, torch.bfloat16, "stage 2 proj", 1),
             (25088, 256, 1024, torch.bfloat16, "stage 3 expand x6", 6),
             (25088, 512, 1024, torch.bfloat16, "stage 3 proj", 1),
             (6272, 512, 2048, torch.bfloat16, "stage 4 expand x3", 3),
             (6272, 1024, 2048, torch.bfloat16, "stage 4 proj", 1),
             (98, 32, 16, torch.float32, "small f32", 0),
             (196, 64, 24, torch.float32, "small f32", 0)]
K1_LAUNCHES_PER_RANK_STEP = 20
BATCH = 128


def phase_k1(name, seed):
    """K1 against its plain version at every distinct shape of the
    training path.  Tolerances: dx is rounded to x's type after an f32
    sum taken in another order than the plain version's (one ulp of x's
    type, plus 1e-3 of the largest entry near zero); dw is f32 from
    exact bf16 products summed in another order (1e-4 of its largest
    entry)."""
    from bluefog_tpu_torch.parallel import conv1x1 as k1

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    results = {}
    per_step = dict(kernel=0.0, bound=0.0, library=0.0)
    for n, ci, co, dt, what, count in K1_SHAPES:
        x = torch.randn(n, ci, generator=g, device="cuda").to(dt)
        dy = torch.randn(n, co, generator=g, device="cuda").to(dt)
        w = (torch.randn(ci, co, generator=g, device="cuda") * 0.1).to(dt)
        run = lambda: k1.conv1x1_backward(x, dy, w)  # noqa: E731
        plain = lambda: k1.conv1x1_backward_plain(x, dy, w)  # noqa: E731
        dx, dw = run()
        dx2, dw2 = run()
        torch.cuda.synchronize()
        if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
            raise AssertionError(f"K1 {what}: two runs differ")
        ref_dx, ref_dw = plain()
        ulp = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
        err_dx = (dx.float() - ref_dx.float()).abs().max().item()
        err_dw = (dw - ref_dw).abs().max().item()
        tol_dw = 1e-4 * ref_dw.abs().max().item()
        ok_dx = torch.allclose(dx.float(), ref_dx.float(), rtol=ulp,
                               atol=1e-3 * ref_dx.float().abs().max().item())
        if not ok_dx or err_dw > tol_dw:
            raise AssertionError(
                f"K1 {what} N={n} ci={ci} co={co}: max |err| dx {err_dx}, "
                f"dw {err_dw} (tolerance {tol_dw})")
        ms = time_ms(run, flush)
        plain_ms = time_ms(plain, flush)
        # yardstick only: cuBLAS computing the same two products (the
        # port never calls it)
        library_ms = time_ms(lambda: (dy @ w.T, x.T @ dy), flush)
        es = x.element_size()
        nbytes = 2 * n * ci * es + n * co * es + ci * co * (es + 4)
        ops = 4 * n * ci * co
        t_bytes = nbytes / rate * 1e3
        t_ops = ops / PEAK_OPS[dt] * 1e3
        rec = dict(max_abs_err=max(err_dx, err_dw), ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms)
        per_step["kernel"] += count * ms
        per_step["bound"] += count * rec["bound_ms"]
        per_step["library"] += count * library_ms
        log(f"[kernel] conv1x1_backward {what} N={n} ci={ci} co={co} "
            f"{str(dt).split('.')[-1]}: max|err| dx {err_dx:.3g} dw "
            f"{err_dw:.3g} (tol {tol_dw:.3g}), dw bit-equal across runs, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} GFLOP; {ops / ms / 1e9:.1f} TFLOP/s; kernel/"
            f"bound {ms / rec['bound_ms']:.2f}, kernel/library "
            f"{ms / library_ms:.3f}), {count} launches per rank-step")
        if (n, ci, co) == (401408, 64, 256):   # the heaviest path shape
            results["conv1x1_backward"] = rec
        del x, dy, w, dx, dw, dx2, dw2, ref_dx, ref_dw
    log(f"[kernel] conv1x1_backward per ResNet-50 rank-step "
        f"({K1_LAUNCHES_PER_RANK_STEP} launches): kernel "
        f"{per_step['kernel']:.4f} ms, bound {per_step['bound']:.4f} ms, "
        f"library (cuBLAS) {per_step['library']:.4f} ms")
    return results


def _resnet_step(n_ranks, comm_mode, seed, batch, **kw):
    """ResNet-50 (pallas_conv1x1=True) over ``n_ranks`` stacked ranks:
    (step, params, stats, optimizer, synthetic batch), all from --seed."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt

    model = bt.ResNet50(num_classes=1000, pallas_conv1x1=True,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    backend = bt.StackedBackend(n_ranks, device="cuda")
    p0, s0 = model.state()
    params, stats = bt.rank_major(p0, backend), bt.rank_major(s0, backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

    def loss_fn(p, s, b):
        images, labels = b
        logits, new = model.apply(p, s, images, train=True)
        return F.cross_entropy(logits, labels), new

    step = bt.build_train_step(loss_fn, opt, backend, comm_mode=comm_mode,
                               has_aux=True, **kw)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    images = torch.randn(n_ranks, batch, 224, 224, 3, generator=g,
                         device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (n_ranks, batch), generator=g,
                           device="cuda")
    return step, params, stats, opt, (images, labels)


def _reset_counts():
    from bluefog_tpu_torch.parallel import conv1x1 as k1
    from bluefog_tpu_torch.parallel import decode_attention as da
    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import splash as sp

    k1.reset_launch_counts()
    da.reset_launch_counts()
    fa.reset_launch_counts()
    sp.reset_launch_counts()


def _launches():
    """Every kernel wrapper's launch count, by kernel name."""
    from bluefog_tpu_torch.parallel import conv1x1 as k1
    from bluefog_tpu_torch.parallel import decode_attention as da
    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import splash as sp

    return {"decode_attention": da.decode_attention.launches,
            "decode_attention_int8": da.decode_attention_int8.launches,
            "conv1x1_backward": k1.conv1x1_backward.launches,
            "flash_forward": fa.flash_forward.launches,
            # the mma.sync launches of K2, K3a and K3b (bf16, D 16 and
            # 32): none on a model
            "flash_forward_mma_sync": fa.flash_forward.launches_mma_sync,
            "flash_backward_dq": fa.flash_backward_dq.launches,
            "flash_backward_dq_mma_sync":
                fa.flash_backward_dq.launches_mma_sync,
            "flash_backward_dkv": fa.flash_backward_dkv.launches,
            "flash_backward_dkv_mma_sync":
                fa.flash_backward_dkv.launches_mma_sync,
            "splash_backward": sp.splash_backward.launches,
            # K5's mma.sync launches (bf16, D 16 and 32): none on a model
            "splash_backward_mma_sync":
                sp.splash_backward.launches_mma_sync}


def _expect_launches(what, want):
    """The launch counts since the last reset must be ``want`` ({kernel:
    count}, each > 0) for the named kernels and 0 for every other.
    Returns the named kernels' counts."""
    got = _launches()
    expected = {k: want.get(k, 0) for k in got}
    if got != expected or not all(want.values()):
        raise AssertionError(f"{what}: launches {got}, want {want} and "
                             "none of the other kernels")
    return {k: got[k] for k in want}


def _profile_train(step, state, steps=3):
    """torch.profiler over ``steps`` train steps: device-busy share, the
    kernels that take the device time, K1's share."""
    from torch.profiler import ProfilerActivity, profile

    params, stats, opt, batch = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            params, stats, opt, loss = step(params, stats, opt, batch, i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events)
    k1_us = sum(e.self_device_time_total for e in events if "k1_" in e.key)
    log(f"[profile] {steps} train steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step "
        f"({100 * busy / wall_us:.1f}%), K1 {k1_us / steps / 1e3:.3f} "
        f"ms/step ({100 * k1_us / max(busy, 1):.1f}% of device time)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:90]}")


def phase_train_1rank(seed):
    step, params, stats, opt, batch = _resnet_step(1, "none", seed, BATCH)
    warmup, windows, per_window = 5, 3, 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, rates = [], []
    i = 0
    for _ in range(warmup):
        params, stats, opt, loss = step(params, stats, opt, batch, i)
        losses.append(loss)
        i += 1
    torch.cuda.synchronize()
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            params, stats, opt, loss = step(params, stats, opt, batch, i)
            losses.append(loss)
            i += 1
        torch.cuda.synchronize()
        rates.append(BATCH * per_window / (time.perf_counter() - t0))
    launches = _expect_launches(
        "train 1 rank", {"conv1x1_backward": K1_LAUNCHES_PER_RANK_STEP * i}
    )["conv1x1_backward"]
    losses = torch.cat(losses)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses.tolist()}")
    rate = statistics.median(rates)
    log(f"[train1] ResNet-50 batch {BATCH}, 1 rank, comm_mode none: "
        f"{rate:.1f} img/s per card (windows "
        f"{', '.join(f'{r:.1f}' for r in rates)}), step "
        f"{BATCH / rate * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
        f"{losses[0].item():.4f} -> {losses[-1].item():.4f}, K1 launches "
        f"{launches} = 20 x {i} steps")
    _profile_train(step, (params, stats, opt, batch))
    return launches


def phase_train_4ranks(seed):
    import bluefog_tpu_torch as bt

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    step, params, stats, opt, batch = _resnet_step(4, "atc", seed, BATCH,
                                                   topology=topo)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for i in range(warmup):
        params, stats, opt, loss = step(params, stats, opt, batch, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + timed):
        params, stats, opt, loss = step(params, stats, opt, batch, i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _expect_launches("train 4 ranks", {
        "conv1x1_backward": K1_LAUNCHES_PER_RANK_STEP * 4 * (warmup + timed)
    })["conv1x1_backward"]
    if not torch.isfinite(loss).all():
        raise AssertionError(f"non-finite loss: {loss.tolist()}")
    # the combine the step runs, alone, on a copy of the params (one
    # flat buffer per dtype: a cat, the gathers and multiply-adds, and
    # the copies back into the leaves)
    copy = {k: v.clone() for k, v in params.items()}
    combine_ms = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.combine(copy, 0)
        end.record()
        combine_ms.append((start, end))
    torch.cuda.synchronize()
    combine = statistics.median(s.elapsed_time(e) for s, e in combine_ms[1:])
    n_el = sum(v[0].numel() for v in params.values())
    log(f"[train4] ResNet-50 batch {BATCH} per rank, 4 ranks stacked, atc "
        f"over ExponentialTwoGraph(4): {4 * BATCH * timed / wall:.1f} img/s "
        f"per card, step {wall / timed * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, combine "
        f"{combine:.3f} ms per step ({len(params)} leaves, {n_el / 1e6:.1f} "
        f"M f32 values per rank as one buffer, 2 shift classes), K1 launches {launches} "
        f"= 20 x 4 ranks x {warmup + timed} steps")
    _profile_train(step, (params, stats, opt, batch), steps=1)
    del step, params, stats, opt, batch, copy
    torch.cuda.empty_cache()

    # consensus: the same start and per-rank data, atc against none
    spread = {}
    for mode, kw in (("atc", dict(topology=topo)), ("none", {})):
        step, params, stats, opt, batch = _resnet_step(4, mode, seed, 16,
                                                       **kw)
        for i in range(3):
            params, stats, opt, loss = step(params, stats, opt, batch, i)
        spread[mode] = float(bt.consensus_distance(params))
        del step, params, stats, opt, batch
    if not spread["atc"] < spread["none"]:
        raise AssertionError(f"consensus distance atc {spread['atc']} not "
                             f"below none {spread['none']}")
    log(f"[train4] consensus distance after 3 steps (batch 16 per rank): "
        f"atc {spread['atc']:.4g} < none {spread['none']:.4g}")
    torch.cuda.empty_cache()
    return launches


def phase_train_reference(seed):
    """A tiny f32 ResNet trained 3 atc steps over 4 ranks on the card (K1)
    and on the host (plain version).  Tolerance: 5e-4 of each leaf's
    largest entry plus 5e-7, losses 1e-5 (f32 sums in another order,
    carried through three momentum steps and train-mode batch norm, as
    in tests/test_torch_train_step.py; TF32 is off)."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models import BottleneckBlock
    from bluefog_tpu_torch.parallel import conv1x1 as k1

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(4, 4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4, 4)))
    out = {}
    init = None
    for dev in ("cuda", "cpu"):
        model = bt.ResNet((1, 1), BottleneckBlock, num_classes=10,
                          num_filters=8, dtype=torch.float32,
                          pallas_conv1x1=True, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        if init is None:
            init = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        backend = bt.StackedBackend(4, device=dev)
        p0, s0 = model.state()
        params, stats = bt.rank_major(p0, backend), bt.rank_major(s0,
                                                                  backend)
        opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

        def loss_fn(p, s, b, model=model):
            logits, new = model.apply(p, s, b[0], train=True)
            return F.cross_entropy(logits, b[1]), new

        step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                                   topology=topo, has_aux=True)
        batch = (x.to(dev), y.to(dev))
        k1.reset_launch_counts()
        losses = []
        for i in range(3):
            params, stats, opt, loss = step(params, stats, opt, batch, i)
            losses.append(loss.cpu())
        launches = k1.conv1x1_backward.launches
        # 4 sites (each block's expansion and projection) x 4 ranks x 3 steps
        if launches != (4 * 4 * 3 if dev == "cuda" else 0):
            raise AssertionError(f"tiny reference on {dev}: K1 launched "
                                 f"{launches} times")
        out[dev] = ({k: v.cpu() for k, v in params.items()},
                    {k: v.cpu() for k, v in stats.items()},
                    torch.stack(losses))
    worst = 0.0
    for which in (0, 1):
        for k, want in out["cpu"][which].items():
            got = out["cuda"][which][k]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            worst = max(worst, err / max(scale, 1e-12))
            if err > 5e-4 * scale + 5e-7:
                raise AssertionError(f"tiny reference: {k} differs by {err} "
                                     f"(largest entry {scale})")
    loss_err = (out["cuda"][2] - out["cpu"][2]).abs().max().item()
    if loss_err > 1e-5:
        raise AssertionError(f"tiny reference: losses differ by {loss_err}")
    log(f"[reference] tiny f32 ResNet, 3 atc steps over 4 ranks: card (K1, "
        f"48 launches) vs host (plain) params and batch statistics agree "
        f"to {worst:.3g} of each leaf's largest entry, losses to "
        f"{loss_err:.3g}")


# the train-step modes of phases 6b and 7b, in the docstring's order
TRAIN_MODES = ("guard_health", "cta_bucketed", "int8_sr", "topk",
               "hierarchical", "push_sum")


def _mode_config(name, n_ranks=4):
    """(comm_mode, build_train_step keywords) of one train-step mode over
    ``n_ranks`` stacked ranks: ExponentialTwoGraph over the ranks, or over
    the machines of 2 ranks for the hierarchical exchange.  ``"atc"`` is
    plain atc, the yardstick."""
    import bluefog_tpu_torch as bt

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(n_ranks))
    return {
        "atc": ("atc", dict(topology=topo)),
        "guard_health": ("atc", dict(topology=topo, guard=bt.GuardConfig(),
                                     health=bt.HealthConfig())),
        "cta_bucketed": ("cta", dict(topology=topo, overlap="bucketed",
                                     overlap_buckets=4)),
        "int8_sr": ("atc", dict(topology=topo, compress="int8_sr")),
        "topk": ("atc", dict(topology=topo,
                             compress=bt.MixCompressConfig(0.25, "int8"))),
        "hierarchical": ("atc", dict(
            topology=bt.uniform_topology_spec(
                bt.ExponentialTwoGraph(n_ranks // 2)),
            hierarchical_local_size=2)),
        "push_sum": ("push_sum", dict(topology=topo)),
    }[name]


def _mode_opt_state(step, opt, params, comm_mode):
    """The opt_state a mode's step takes: the optimizer, or (optimizer,
    MixState) under top-k mixing, or (optimizer, ps weights) under
    push-sum."""
    import bluefog_tpu_torch as bt

    if step.mix_config is not None:
        return (opt, step.init_mix_state(params))
    if comm_mode == "push_sum":
        n = next(iter(params.values())).shape[0]
        dev = next(iter(params.values())).device
        return (opt, bt.push_sum_weights(bt.StackedBackend(n, device=dev)))
    return opt


def _mode_call(step, params, stats, opt_state, batch, i):
    """One step of any mode: (params, stats, opt_state, loss, skipped or
    None, HealthVector or None)."""
    guarded = hasattr(step, "guard_config")
    args = (params, stats, opt_state, batch, i)
    out = step(*(args + (step.default_comm_weights,) if guarded else args))
    params, stats, opt_state, loss = out[:4]
    rest = list(out[4:])
    skipped = rest.pop(0) if guarded else None
    hv = rest.pop(0) if step.health_config is not None else None
    return params, stats, opt_state, loss, skipped, hv


def _count_syncs(fn):
    """The host syncs ``fn()`` makes: the "called a synchronizing CUDA
    operation" warnings of torch.cuda.set_sync_debug_mode("warn") (not
    the one-time notice that the mode is a prototype)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _profile_step(call, what, top=4, host_ops=True):
    """torch.profiler over one ``call()``: (wall ms, device-busy ms); logs
    the ``top`` kernels by device time.  ``host_ops=False`` traces the
    device only (a step of thousands of small ops profiles faster)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_kernels(prof)
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        log(f"[profile] {what}: {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:5d} calls  {e.key[:80]}")
    busy = sum(e.self_device_time_total for e in events)
    return wall_us / 1e3, busy / 1e3


def _time_combine(step, params, opt_state):
    """Median CUDA-event ms of the step's neighbor combine alone, on
    copies of the params (and of the MixState), 6 runs less the first."""
    copy = {k: v.clone() for k, v in params.items()}
    mix = None
    if step.mix_config is not None:
        ms = opt_state[1]
        mix = ms._replace(err=tuple(t.clone() for t in ms.err),
                          ref=tuple(t.clone() for t in ms.ref),
                          mirror=tuple(t.clone() for t in ms.mirror))
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.combine(copy, 0, mix_state=mix)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times[1:])


def _spread_after_3(seed, comm_mode, kw, batch=16):
    """Phase 6's consensus check: the consensus distance after 3 steps
    from one state on the same per-rank data."""
    import bluefog_tpu_torch as bt

    step, params, stats, opt, b = _resnet_step(4, comm_mode, seed, batch,
                                               **kw)
    opt_state = _mode_opt_state(step, opt, params, comm_mode)
    for i in range(3):
        params, stats, opt_state, *_ = _mode_call(step, params, stats,
                                                  opt_state, b, i)
    spread = float(bt.consensus_distance(params))
    del step, params, stats, opt, opt_state, b
    torch.cuda.empty_cache()
    return spread


def _cta_bit_equal(seed):
    """Plain and bucketed cta from one state, 2 steps (batch 16, cuDNN in
    its deterministic mode): the params must be bit-equal.  On a
    mismatch, a second plain run says whether the card's own training
    repeats bit for bit."""
    import bluefog_tpu_torch as bt

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    bench, det = torch.backends.cudnn.benchmark, \
        torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for kw in (dict(), dict(overlap="bucketed", overlap_buckets=4),
                   dict()):
            step, params, stats, opt, b = _resnet_step(
                4, "cta", seed, 16, topology=topo, **kw)
            for i in range(2):
                params, stats, opt, _ = step(params, stats, opt, b, i)
            runs.append({k: v.clone() for k, v in params.items()})
            del step, params, stats, opt, b
            if len(runs) == 2:
                same = all(torch.equal(runs[0][k], runs[1][k])
                           for k in runs[0])
                if same:
                    break
        if not same:
            control = all(torch.equal(runs[0][k], runs[2][k])
                          for k in runs[0])
            raise AssertionError(
                "bucketed cta is not bit-equal to plain cta after 2 steps "
                f"(plain against plain: {'equal' if control else 'unequal'})")
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
        torch.cuda.empty_cache()


def phase_train_modes(seed):
    """Phase 6b: plain atc, then each train-step mode, on ResNet-50 at
    full width, 4 stacked ranks, batch 128 per rank, each its own build,
    2 warm-up and 3 timed steps, then one profiled step (device-busy ms)
    and one step under the sync debug mode; K1 20 x 4 x 5 launches and no
    other kernel; no mode makes more host syncs than plain atc."""
    timed, warmup = 3, 2
    spread_none = _spread_after_3(seed, "none", {})
    rows = {}
    for name in ("atc",) + TRAIN_MODES:
        comm_mode, kw = _mode_config(name)
        step, params, stats, opt, batch = _resnet_step(4, comm_mode, seed,
                                                       BATCH, **kw)
        opt_state = _mode_opt_state(step, opt, params, comm_mode)
        poisoned = None
        if name == "guard_health":
            poisoned = (batch[0].clone(), batch[1])
            poisoned[0][2, 0, 0, 0, 0] = float("nan")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        kept = {}
        hvs, skips, losses = [], [], []
        for i in range(warmup + timed):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            b = poisoned if (poisoned is not None and i == 3) else batch
            if poisoned is not None and i == 3:
                kept["before"] = (
                    {k: opt.state[v]["momentum_buffer"][2].clone()
                     for k, v in params.items()},
                    {k: v[2].clone() for k, v in stats.items()})
            params, stats, opt_state, loss, skipped, hv = _mode_call(
                step, params, stats, opt_state, b, i)
            if poisoned is not None and i == 3:
                kept["after"] = (
                    {k: opt.state[v]["momentum_buffer"][2].clone()
                     for k, v in params.items()},
                    {k: v[2].clone() for k, v in stats.items()})
            losses.append(loss)
            skips.append(skipped)
            hvs.append(hv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = _expect_launches(f"mode {name}", {
            "conv1x1_backward":
                K1_LAUNCHES_PER_RANK_STEP * 4 * (warmup + timed)
        })["conv1x1_backward"]
        if not all(torch.isfinite(v).all() for v in params.values()):
            raise AssertionError(f"mode {name}: non-finite params")
        loss_all = torch.stack(losses)
        extra = ""
        if name == "guard_health":
            want = [[0, 0, 1, 0] if i == 3 else [0] * 4
                    for i in range(warmup + timed)]
            got = torch.stack(skips).tolist()
            if got != want:
                raise AssertionError(f"guard: skipped {got}, want {want}")
            for part in (0, 1):
                for k, v in kept["before"][part].items():
                    if not torch.equal(v, kept["after"][part][k]):
                        raise AssertionError(
                            f"guard: rank 2's {('momentum', 'stat')[part]} "
                            f"{k} changed in its skipped step")
            # the planted rank's loss, gradients and update are NaN at
            # step 3, so are its loss, grad and update norms (in JAX too)
            for i, hv in enumerate(hvs):
                for f, v in hv._asdict().items():
                    ok = torch.isfinite(v)
                    if f in ("loss", "grad_norm", "update_norm") and i == 3:
                        ok = ok | (torch.arange(4, device=v.device) == 2)
                    if not ok.all():
                        raise AssertionError(f"guard: HealthVector.{f} of "
                                             f"step {i}: {v.tolist()}")
            finite = torch.isfinite(loss_all)
            if finite.sum().item() != loss_all.numel() - 1 \
                    or finite[3, 2].item():
                raise AssertionError(f"guard: losses {loss_all.tolist()}")
            last = hvs[-1]
            extra = (f", skipped {got[3]} at step 3 (rank 2's momentum and "
                     f"statistics kept bit for bit), last HealthVector: "
                     f"grad_norm {[round(x, 4) for x in last.grad_norm.tolist()]}, "
                     f"update_norm {[round(x, 4) for x in last.update_norm.tolist()]}, "
                     f"consensus {[round(x, 4) for x in last.consensus.tolist()]}")
        elif not torch.isfinite(loss_all).all():
            raise AssertionError(f"mode {name}: losses {loss_all.tolist()}")
        if name == "push_sum":
            total = opt_state[1].sum().item()
            if abs(total - 4.0) > 1e-5:
                raise AssertionError(f"push_sum: ps weights sum to {total}")
            extra = f", ps weights {opt_state[1].tolist()} (sum {total:.7f})"
        if name == "topk":
            mix_bytes = sum(t.numel() * t.element_size()
                            for t in (opt_state[1].ratio,) + opt_state[1].err
                            + opt_state[1].ref + opt_state[1].mirror)
            extra = (f", MixState {mix_bytes / 1e9:.3f} GB "
                     f"({len(opt_state[1].err)} buckets), wire "
                     f"{sum(r['wire_bytes'] for r in step.mix_wire_layout(params)) / 1e6:.2f}"
                     " MB per rank per permute")
        combine = (f"{_time_combine(step, params, opt_state):.3f} ms"
                   if hasattr(step, "combine") else "n/a (push-sum)")
        prof_wall, busy = _profile_step(lambda: _mode_call(
            step, params, stats, opt_state, batch, warmup + timed), name)
        syncs = _count_syncs(lambda: _mode_call(
            step, params, stats, opt_state, batch, warmup + timed + 1))
        base_syncs = rows["atc"]["syncs"] if rows else syncs
        step_ms = wall / timed * 1e3
        rows[name] = dict(step_ms=step_ms, syncs=syncs, busy_ms=busy)
        log(f"[modes] {name} ({comm_mode}): "
            f"{4 * BATCH * timed / wall:.1f} img/s per card, step "
            f"{step_ms:.2f} ms, device busy {busy:.2f} ms in a profiled "
            f"step of {prof_wall:.2f} ms ({100 * busy / prof_wall:.1f}%), "
            f"peak memory {peak:.2f} GiB, combine {combine}, K1 launches "
            f"{launches} = 20 x 4 ranks x {warmup + timed} steps, host "
            f"syncs in a steady step {syncs} (plain atc {base_syncs})"
            f"{extra}")
        if syncs > base_syncs:
            raise AssertionError(f"mode {name}: {syncs} host syncs a step, "
                                 f"plain atc {base_syncs}")
        del step, params, stats, opt, opt_state, batch, poisoned, kept, b
        del hvs, skips, losses, loss_all, loss, skipped, hv
        torch.cuda.empty_cache()
        if name == "cta_bucketed":
            _cta_bit_equal(seed)
            log("[modes] cta_bucketed: bit-equal to plain cta after 2 steps "
                "from one state (batch 16, deterministic cuDNN)")
        if name in ("int8_sr", "topk"):
            spread = _spread_after_3(seed, comm_mode, kw)
            if not spread < spread_none:
                raise AssertionError(f"mode {name}: consensus distance "
                                     f"{spread} not below none's "
                                     f"{spread_none}")
            log(f"[modes] {name}: consensus distance after 3 steps (batch "
                f"16 per rank) {spread:.4g} < none {spread_none:.4g}")
    return rows


def _tiny_mode_run(name, dev, seed, init, x, y, nan_at=None):
    """A tiny f32 ResNet (K1 on the card, its plain version on the host)
    trained 3 steps over 4 ranks in one mode: params, statistics, losses,
    skip flags, HealthVector fields, the ps weights (host copies)."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models import BottleneckBlock

    model = bt.ResNet((1, 1), BottleneckBlock, num_classes=10,
                      num_filters=8, dtype=torch.float32,
                      pallas_conv1x1=True, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed))
    model.load_state_dict(init)
    backend = bt.StackedBackend(4, device=dev)
    p0, s0 = model.state()
    params, stats = bt.rank_major(p0, backend), bt.rank_major(s0, backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

    def loss_fn(p, s, b):
        logits, new = model.apply(p, s, b[0], train=True)
        return F.cross_entropy(logits, b[1]), new

    comm_mode, kw = _mode_config(name)
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode=comm_mode,
                               has_aux=True, **kw)
    opt_state = _mode_opt_state(step, opt, params, comm_mode)
    out = dict(loss=[], skipped=[], hv=[])
    for i in range(3):
        xi = x.clone()
        if nan_at is not None and i == nan_at[0]:
            xi[nan_at[1], 0, 0, 0, 0] = float("nan")
        params, stats, opt_state, loss, skipped, hv = _mode_call(
            step, params, stats, opt_state, (xi.to(dev), y.to(dev)), i)
        out["loss"].append(loss.cpu())
        if skipped is not None:
            out["skipped"].append(skipped.cpu())
        if hv is not None:
            out["hv"].append({f: v.cpu() for f, v in hv._asdict().items()})
    out["params"] = {k: v.cpu() for k, v in params.items()}
    out["stats"] = {k: v.cpu() for k, v in stats.items()}
    if comm_mode == "push_sum":
        out["ps"] = opt_state[1].cpu()
    return out


def phase_train_modes_reference(seed):
    """Phase 7b: the tiny f32 ResNet of phase 7, 3 steps over 4 ranks on
    the card (K1) and on the host (plain version), for the guard with
    health (a NaN in rank 2's images at step 1), bucketed cta, top-k
    mixing, the hierarchical exchange and push-sum: params, batch
    statistics, losses, skip flags and HealthVector agree within phase
    7's tolerance (5e-4 of each leaf's or field's largest entry plus
    5e-7; losses 1e-5).  int8_sr on the card only: finite, and bit-equal
    across two runs from one seed."""
    from bluefog_tpu_torch.models import BottleneckBlock

    import bluefog_tpu_torch as bt

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(4, 4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4, 4)))
    init = {k: v.cpu() for k, v in bt.ResNet(
        (1, 1), BottleneckBlock, num_classes=10, num_filters=8,
        dtype=torch.float32, pallas_conv1x1=True, device="cpu",
        generator=torch.Generator("cpu").manual_seed(seed)
    ).state_dict().items()}

    def close(got, want, what):
        """Within 5e-4 of the largest entry plus 5e-7; NaN where the host
        has NaN (the planted rank's norms) and nowhere else."""
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"{what}: NaN at {torch.isnan(got)}, host "
                                 f"{nan}")
        got, want = got[~nan], want[~nan]
        scale = want.abs().max().item() if want.numel() else 0.0
        err = (got - want).abs().max().item() if want.numel() else 0.0
        if not err <= 5e-4 * scale + 5e-7:
            raise AssertionError(f"{what} differs by {err} (largest entry "
                                 f"{scale})")
        return err / max(scale, 1e-12)

    for name in ("guard_health", "cta_bucketed", "topk", "hierarchical",
                 "push_sum"):
        nan_at = (1, 2) if name == "guard_health" else None
        card = _tiny_mode_run(name, "cuda", seed, init, x, y, nan_at)
        host = _tiny_mode_run(name, "cpu", seed, init, x, y, nan_at)
        worst = 0.0
        for part in ("params", "stats"):
            for k, want in host[part].items():
                worst = max(worst, close(card[part][k], want,
                                         f"7b {name}: {k}"))
        lc, lh = torch.stack(card["loss"]), torch.stack(host["loss"])
        if not torch.equal(torch.isnan(lc), torch.isnan(lh)) or \
                (lc - lh).nan_to_num().abs().max().item() > 1e-5:
            raise AssertionError(f"7b {name}: losses {lc.tolist()} vs "
                                 f"{lh.tolist()}")
        if card["skipped"] != [] and not all(
                torch.equal(a, b) for a, b in zip(card["skipped"],
                                                  host["skipped"])):
            raise AssertionError(f"7b {name}: skipped {card['skipped']} vs "
                                 f"{host['skipped']}")
        for i, (hc, hh) in enumerate(zip(card["hv"], host["hv"])):
            for f in hh:
                if f == "loss":
                    continue   # the losses above, NaN included
                worst = max(worst, close(hc[f], hh[f],
                                         f"7b {name}: HealthVector.{f} "
                                         f"step {i}"))
        if "ps" in host:
            close(card["ps"], host["ps"], f"7b {name}: ps weights")
        if name == "guard_health" and [s.tolist() for s in card["skipped"]] \
                != [[0, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]]:
            raise AssertionError(f"7b guard: skipped {card['skipped']}")
        log(f"[reference] 7b {name}: card vs host within {worst:.3g} of "
            "each leaf's (and HealthVector field's) largest entry, losses "
            f"within {(lc - lh).nan_to_num().abs().max().item():.3g}")
    runs = [_tiny_mode_run("int8_sr", "cuda", seed, init, x, y)
            for _ in range(2)]
    for k, v in runs[0]["params"].items():
        if not torch.isfinite(v).all() or not torch.equal(
                v, runs[1]["params"][k]):
            raise AssertionError(f"7b int8_sr: {k} not finite or not "
                                 "repeated bit for bit")
    log("[reference] 7b int8_sr (card only): 3 atc steps finite and "
        "bit-equal across two runs from one seed")


FLASH_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")


def _llama8b_cfg(n_layers):
    """Llama-3.1-8B's width at ``n_layers`` layers, attn_impl="flash"."""
    import bluefog_tpu_torch as bt

    # depth is the one cut, as examples/llama_benchmark.py's --layers
    return dataclasses.replace(
        bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3",
                                 attn_impl="flash"),
        n_layers=n_layers)


def _llama1b_cfg(**over):
    """examples/llama_benchmark.py's "1b" model (:141-144) at full depth
    and width, with the benchmark's defaults (remat=True, policy
    "none"): splash attention unless ``over`` says otherwise."""
    import bluefog_tpu_torch as bt

    base = dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32,
                n_kv_heads=8, hidden_dim=5632, max_seq_len=8192, remat=True,
                remat_policy="none", attn_impl="splash")
    base.update(over)
    return bt.LlamaConfig(**base)


def _llama_step(cfg, n_ranks, comm_mode, seed, batch, seq, **kw):
    """``cfg``'s model (f32 master params from --seed, bf16 compute) over
    ``n_ranks`` stacked ranks: (cfg, model, backend, step, params,
    optimizer, synthetic batch), all from --seed; the module keeps no copy
    of the weights (``state(release=True)``), so the rank-major params are
    the one copy on the card."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    state = model.state(release=True)
    backend = bt.StackedBackend(n_ranks, device="cuda")
    params = bt.rank_major(state, backend)
    del state
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                               comm_mode=comm_mode, **kw)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg.vocab_size, (n_ranks, batch, seq + 1),
                        generator=g, device="cuda")
    return (cfg, model, backend, step, params, opt,
            (raw[..., :-1].contiguous(), raw[..., 1:].contiguous()))


def _expect_flash(what, n):
    return _expect_launches(what, dict.fromkeys(FLASH_KERNELS, n))


def _model_flops(cfg, params, tokens):
    """llama_benchmark.py's count: 6 x matmul params (the embedding table
    is a gather) per token plus causal attention 6 x L x T x dim."""
    n_params = sum(v[0].numel() for v in params.values())
    matmul = n_params - cfg.vocab_size * cfg.dim
    return n_params, (6.0 * matmul * tokens
                      + 6.0 * cfg.n_layers * LLAMA_SEQ * cfg.dim * tokens)


LLAMA_BATCH, LLAMA_SEQ = 4, 2048
PEAK_BF16 = 989e12


# device kernels by the port's kernel, for the profiles' shares
KERNEL_SYMBOLS = {"K2": ("k2_forward",), "K3a+K3b": ("k3a_dq", "k3b_dkv"),
                  "K5": ("k5_wgmma", "k5_tc", "k5_fma", "k5_sum")}


def _profile_llama(step, params, opt, batch, steps=2, what="Llama"):
    """torch.profiler over ``steps`` train steps of ``what`` (a model
    with an f32 head): device-busy share, the top kernels, the attention
    kernels' shares (K2, K3a+K3b, K5) and the head's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt, loss = step(params, opt, batch, i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events)
    attn = {k: sum(e.self_device_time_total for e in events
                   if any(n in e.key for n in names))
            for k, names in KERNEL_SYMBOLS.items()}
    # the step's only f32 matrix products are the head's three (logits,
    # dX, dW); cuBLAS names its f32 kernels sgemm or gemm_f32f32
    head = sum(e.self_device_time_total for e in events
               if "sgemm" in e.key or "gemm_f32f32" in e.key)
    log(f"[profile] {steps} {what} train steps: wall "
        f"{wall_us / steps / 1e3:.2f} ms/step, device busy "
        f"{busy / steps / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}%), "
        + "".join(f"{k} {us / steps / 1e3:.3f} ms/step "
                  f"({100 * us / max(busy, 1):.1f}% of device time), "
                  for k, us in attn.items())
        + f"f32 GEMMs (the head) {head / steps / 1e3:.3f} ms/step "
        f"({100 * head / max(busy, 1):.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:90]}")
    return busy / steps / 1e3


def _head_ms(cfg, flush, tokens):
    """The f32 logits head alone at the step's shape: x [tokens, dim] @
    kernel [dim, vocab] in f32, log-softmax cross-entropy, and the
    backward of both (CUDA events, median of 5)."""
    import torch.nn.functional as F

    g = torch.Generator("cuda").manual_seed(7)
    x = torch.randn(tokens, cfg.dim, generator=g, device="cuda",
                    requires_grad=True)
    w = (torch.randn(cfg.dim, cfg.vocab_size, generator=g, device="cuda")
         * cfg.dim ** -0.5).requires_grad_(True)
    tgt = torch.randint(0, cfg.vocab_size, (tokens,), generator=g,
                        device="cuda")

    def head():
        loss = F.cross_entropy(x @ w, tgt)
        torch.autograd.grad(loss, (x, w))

    ms = time_ms(head, flush, reps=5)
    del x, w
    torch.cuda.empty_cache()
    return ms


def _llama_window(cfg, seed, warmup, timed, label, want):
    """One training window of ``cfg`` on 1 rank: a fresh model and
    optimizer from --seed, the launch counts set to 0, ``warmup`` then
    ``timed`` steps of batch 4 x 2048; the counts must be ``want`` and the
    losses finite near ln(vocab).  Logs tokens/s per card, step ms, MFU
    over 989 TFLOP/s, peak memory and the losses after ``label``.
    Returns (launches, (model, backend, step, params, opt, batch),
    model FLOP per step)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, backend, step, params, opt, batch = _llama_step(
        cfg, 1, "none", seed, LLAMA_BATCH, LLAMA_SEQ)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    n_params, flops = _model_flops(cfg, params, tokens)
    torch.cuda.synchronize()
    _reset_counts()
    losses = []
    for i in range(warmup):
        params, opt, loss = step(params, opt, batch, i)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + timed):
        params, opt, loss = step(params, opt, batch, i)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches = _expect_launches(label, want)
    losses = torch.cat(losses)
    ln_v = math.log(cfg.vocab_size)
    if not torch.isfinite(losses).all() or \
            (losses - ln_v).abs().max().item() > 2.0:
        raise AssertionError(f"{label}: losses {losses.tolist()} not finite "
                             f"near ln(vocab) = {ln_v:.2f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    remat = f"remat policy {cfg.remat_policy!r}" if cfg.remat else "no remat"
    log(f"{label} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B params), "
        f"1 rank, batch {LLAMA_BATCH} x {LLAMA_SEQ}, attn {cfg.attn_impl}, "
        f"{remat}, f32 head: {tokens / dt:.1f} tokens/s per card, step "
        f"{dt * 1e3:.2f} ms, MFU {flops / dt / PEAK_BF16:.4f} of 989 "
        f"TFLOP/s, peak memory {peak:.2f} GiB, losses "
        f"{', '.join(f'{x:.4f}' for x in losses.tolist())} (ln vocab "
        f"{ln_v:.4f}); launches {launches} over {warmup + timed} steps")
    return launches, (model, backend, step, params, opt, batch), flops


def phase_llama_train_1rank(seed):
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    n_layers, warmup, timed = 4, 3, 10
    cfg = _llama8b_cfg(n_layers)
    launches, state, flops = _llama_window(
        cfg, seed, warmup, timed, "[llama1] Llama-3.1-8B width",
        dict.fromkeys(FLASH_KERNELS, n_layers * (warmup + timed)))
    model, backend, step, params, opt, batch = state
    del state
    tokens = LLAMA_BATCH * LLAMA_SEQ
    busy_ms = _profile_llama(step, params, opt, batch)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    head = _head_ms(cfg, flush, tokens)
    log(f"[llama1] the f32 head alone (x @ kernel, cross-entropy and their "
        f"backward, [{tokens} x {cfg.dim}] x [{cfg.dim} x {cfg.vocab_size}]"
        f"): {head:.2f} ms, {100 * head / busy_ms:.1f}% of the step's "
        f"device time")
    # the same state, the head in bf16 (the JAX package's --bf16-logits):
    # a copy of the released module, which holds no weights, with the
    # head's compute dtype that Llama(logits_dot_in_fp32=False) gives it
    model16 = copy.deepcopy(model)
    model16.cfg = dataclasses.replace(cfg, logits_dot_in_fp32=False)
    model16.output.dtype = cfg.dtype
    step16 = bt.build_train_step(llama_loss_fn(model16), opt, backend,
                                 comm_mode="none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timed):
        params, opt, loss = step16(params, opt, batch, i)
    torch.cuda.synchronize()
    dt16 = (time.perf_counter() - t0) / timed
    if not torch.isfinite(loss).all():
        raise AssertionError(f"bf16 head: non-finite loss {loss.tolist()}")
    log(f"[llama1] logits_dot_in_fp32=False (bf16 head), {timed} steps: "
        f"{tokens / dt16:.1f} tokens/s per card, step {dt16 * 1e3:.2f} ms, "
        f"MFU {flops / dt16 / PEAK_BF16:.4f}, loss {loss.item():.4f}")
    del step, step16, params, opt, batch, model, model16, backend
    torch.cuda.empty_cache()
    return launches


def _llama_train_2ranks(cfg, seed, label, per_step):
    """``cfg`` over 2 ranks stacked on the card, atc over
    ExponentialTwoGraph(2), batch 4 x 2048 per rank, 2 warm-up and 3
    timed steps; each kernel of ``per_step`` ({kernel: launches per layer
    and rank-step}) launched that many times.  Logs tokens/s per card,
    step ms, MFU, peak memory and the combine's ms per step."""
    import bluefog_tpu_torch as bt

    warmup, timed = 2, 3
    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _, step, params, opt, batch = _llama_step(
        cfg, 2, "atc", seed, LLAMA_BATCH, LLAMA_SEQ, topology=topo)
    tokens = 2 * LLAMA_BATCH * LLAMA_SEQ
    n_params, flops = _model_flops(cfg, params, tokens)
    torch.cuda.synchronize()
    _reset_counts()
    for i in range(warmup):
        params, opt, loss = step(params, opt, batch, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + timed):
        params, opt, loss = step(params, opt, batch, i)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    n = cfg.n_layers * 2 * (warmup + timed)   # layers x ranks x steps
    launches = _expect_launches(label, {k: c * n
                                        for k, c in per_step.items()})
    if not torch.isfinite(loss).all():
        raise AssertionError(f"{label}: non-finite loss {loss.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    combine = []
    for _ in range(4):   # the step's own in-place combine, on its params
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.combine(params, 0)
        end.record()
        combine.append((start, end))
    torch.cuda.synchronize()
    combine_ms = statistics.median(a.elapsed_time(b) for a, b in combine[1:])
    log(f"{label} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B params "
        f"per rank), 2 ranks stacked, attn {cfg.attn_impl}, atc over "
        f"ExponentialTwoGraph(2), batch {LLAMA_BATCH} x {LLAMA_SEQ} per "
        f"rank: {tokens / dt:.1f} tokens/s per card, step {dt * 1e3:.2f} ms,"
        f" MFU {flops / dt / PEAK_BF16:.4f}, peak memory {peak:.2f} GiB, "
        f"combine {combine_ms:.3f} ms per step ({n_params / 1e6:.1f} M f32 "
        f"values per rank), loss {loss.tolist()}; launches {launches} over "
        f"{warmup + timed} steps")
    del step, params, opt, batch, model
    torch.cuda.empty_cache()


def phase_llama_train_2ranks(seed):
    import bluefog_tpu_torch as bt

    n_layers = 2
    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    _llama_train_2ranks(_llama8b_cfg(n_layers), seed,
                        "[llama2] Llama-3.1-8B width",
                        dict.fromkeys(FLASH_KERNELS, 1))
    # consensus: the same start, different per-rank data, atc against none
    spread = {}
    for mode, kw in (("atc", dict(topology=topo)), ("none", {})):
        _, model, _, step, params, opt, batch = _llama_step(
            _llama8b_cfg(n_layers), 2, mode, seed, 1, 512, **kw)
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
        spread[mode] = float(bt.consensus_distance(params))
        del model, step, params, opt, batch
        torch.cuda.empty_cache()
    if not spread["atc"] < spread["none"]:
        raise AssertionError(f"consensus distance atc {spread['atc']} not "
                             f"below none {spread['none']}")
    log(f"[llama2] consensus distance after 3 steps (1 x 512 per rank): "
        f"atc {spread['atc']:.4g} < none {spread['none']:.4g}")


def phase_llama_reference(seed, attn_impl="flash", seq=32):
    """The tiny f32 Llama (D=16: the kernels' f32 path) with ``attn_impl``
    "flash" (K2, K3a, K3b) or "splash" (K2, K5) trained 3 atc steps over 2
    ranks on the card (kernels) and on the host (plain versions), ``seq``
    tokens per row.  Tolerance: 1e-4 of each leaf's largest entry plus
    1e-7, losses 1e-5 (f32 sums in another order through three momentum
    steps; TF32 is off)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl=attn_impl)
    kernels = (FLASH_KERNELS if attn_impl == "flash"
               else ("flash_forward", "splash_backward"))
    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2, seq + 1)))
    init = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(seed)
                    ).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        model = bt.Llama(cfg, device=dev, param_dtype=torch.float32)
        model.load_state_dict(init)
        backend = bt.StackedBackend(2, device=dev)
        params = bt.rank_major(model.state(release=True), backend)
        opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
        step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                                   comm_mode="atc", topology=topo)
        batch = (raw[..., :-1].to(dev), raw[..., 1:].to(dev))
        _reset_counts()
        losses = []
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
            losses.append(loss.cpu())
        if dev == "cuda":
            _expect_launches(f"tiny reference ({attn_impl})",
                             dict.fromkeys(kernels, cfg.n_layers * 2 * 3))
        elif any(_launches().values()):
            raise AssertionError("the host run launched a kernel")
        out[dev] = ({k: v.cpu() for k, v in params.items()},
                    torch.stack(losses))
    worst = 0.0
    for k, want in out["cpu"][0].items():
        got = out["cuda"][0][k]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / max(scale, 1e-12))
        if err > 1e-4 * scale + 1e-7:
            raise AssertionError(f"tiny Llama reference: {k} differs by "
                                 f"{err} (largest entry {scale})")
    loss_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    if loss_err > 1e-5:
        raise AssertionError(f"tiny Llama reference: losses differ by "
                             f"{loss_err}")
    log(f"[reference] tiny f32 Llama ({attn_impl}, T={seq}), 3 atc steps "
        f"over 2 ranks: card ({', '.join(kernels)}, "
        f"{cfg.n_layers * 2 * 3} launches each) vs host (plain) params "
        f"agree to {worst:.3g} of each leaf's largest entry, losses to "
        f"{loss_err:.3g}")


def phase_llama1b(seed):
    """Llama-1B (examples/llama_benchmark.py --model 1b) at full depth on
    1 rank: window (a) splash with remat policy "none" (the benchmark's
    defaults), (b) flash, the A/B of the JAX package, (c) splash with
    remat policy "dots"; each followed by torch.profiler over 2 steps,
    whose device time is the A/B's steady measure (the host this card
    shares makes wall times vary between windows).  Under remat K2 runs
    twice per layer (forward and recompute)."""
    warmup, timed = 3, 10
    n = 16 * (warmup + timed)    # 16 layers x steps
    windows = [
        ("(a) splash", {}, {"flash_forward": 2 * n, "splash_backward": n}),
        ("(b) flash", dict(attn_impl="flash"),
         {"flash_forward": 2 * n, "flash_backward_dq": n,
          "flash_backward_dkv": n}),
        ("(c) splash, dots", dict(remat_policy="dots"),
         {"flash_forward": 2 * n, "splash_backward": n})]
    for what, over, want in windows:
        got, state, _ = _llama_window(_llama1b_cfg(**over), seed, warmup,
                                      timed, f"[llama1b] {what}", want)
        if not over:
            launches = got
        _profile_llama(*state[2:], what=f"Llama-1B {what}")
        del state
    torch.cuda.empty_cache()
    return launches


def phase_llama1b_2ranks(seed):
    """Llama-1B, splash, full depth, 2 ranks stacked on the card, atc."""
    _llama_train_2ranks(_llama1b_cfg(), seed, "[llama1b2] Llama-1B",
                        {"flash_forward": 2, "splash_backward": 1})


VIT_BATCH = 128


def _vit_step(cfg, n_ranks, comm_mode, seed, batch, dev="cuda",
              init=None, **kw):
    """ViT ``cfg`` over ``n_ranks`` stacked ranks on ``dev``: (model,
    step, params, optimizer, synthetic batch), weights from --seed (or
    ``init``, a state dict), SGD(1e-3, momentum 0.9), cross-entropy."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt

    model = bt.ViT(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    if init is not None:
        model.load_state_dict(init)
    backend = bt.StackedBackend(n_ranks, device=dev)
    params = bt.rank_major(model.state(), backend)
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)

    def loss_fn(p, b):
        return F.cross_entropy(model.apply(p, b[0]), b[1])

    step = bt.build_train_step(loss_fn, opt, backend, comm_mode=comm_mode,
                               **kw)
    g = torch.Generator().manual_seed(seed + 1)
    size = cfg.image_size
    images = torch.randn(n_ranks, batch, size, size, 3, generator=g)
    labels = torch.randint(0, cfg.num_classes, (n_ranks, batch), generator=g)
    images = images.to(dev, cfg.dtype)
    return model, step, params, opt, (images, labels.to(dev))


def phase_vit(seed):
    """ViT-B/16 (attn_impl="flash": K2, K3a, K3b non-causal at T = 200),
    224 x 224 images, 1000 classes, bf16 compute over f32 params, batch
    128, 1 rank, comm_mode="none", 3 warm-up and 10 timed steps: img/s,
    step ms, peak memory, K2/K3a/K3b launched 12 x steps times each.
    Then a tiny f32 ViT (flash, D=16: the f32 path) after 3 atc steps over
    2 ranks on the card and on the host: params within 1e-4 of each
    leaf's largest entry plus 1e-7, losses within 1e-5."""
    import bluefog_tpu_torch as bt

    warmup, timed = 3, 10
    cfg = bt.ViTConfig.base(attn_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step, params, opt, batch = _vit_step(cfg, 1, "none", seed,
                                                VIT_BATCH)
    torch.cuda.synchronize()
    _reset_counts()
    losses = []
    for i in range(warmup):
        params, opt, loss = step(params, opt, batch, i)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + timed):
        params, opt, loss = step(params, opt, batch, i)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches = _expect_flash("ViT-B/16 1 rank", cfg.depth * (warmup + timed))
    losses = torch.cat(losses)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"ViT-B/16: non-finite loss {losses.tolist()}")
    n_params = sum(v[0].numel() for v in params.values())
    log(f"[vit] ViT-B/16 ({n_params / 1e6:.1f} M params, {model.n_tokens} "
        f"tokens + {model.n_reg} registers), 1 rank, batch {VIT_BATCH} x "
        f"224 x 224, attn flash, bf16 compute: {VIT_BATCH / dt:.1f} img/s "
        f"per card, step {dt * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
        f"{losses[0].item():.4f} -> {losses[-1].item():.4f} (ln 1000 = "
        f"{math.log(1000):.4f}); launches {launches} = 12 layers x "
        f"{warmup + timed} steps each")
    _profile_llama(step, params, opt, batch, what="ViT-B/16")
    del model, step, params, opt, batch
    torch.cuda.empty_cache()

    # card against host: the tiny f32 ViT, 3 atc steps over 2 ranks
    tiny = bt.ViTConfig.tiny(dtype=torch.float32, attn_impl="flash")
    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    init = bt.ViT(tiny, device="cpu",
                  generator=torch.Generator().manual_seed(seed)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        _, step, params, opt, batch = _vit_step(tiny, 2, "atc", seed, 4,
                                                dev=dev, init=init,
                                                topology=topo)
        _reset_counts()
        losses = []
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
            losses.append(loss.cpu())
        if dev == "cuda":
            _expect_flash("tiny ViT reference", tiny.depth * 2 * 3)
        elif any(_launches().values()):
            raise AssertionError("the host run launched a kernel")
        out[dev] = ({k: v.cpu() for k, v in params.items()},
                    torch.stack(losses))
    worst, worst_key = 0.0, None
    for k, want in out["cpu"][0].items():
        err = (out["cuda"][0][k] - want).abs().max().item()
        ratio = err / (1e-4 * want.abs().max().item() + 1e-7)
        if ratio > worst:
            worst, worst_key = ratio, k
    if worst > 1:
        raise AssertionError(f"tiny ViT reference: {worst_key} differs by "
                             f"{worst:.3g} times its bound")
    loss_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    if loss_err > 1e-5:
        raise AssertionError(f"tiny ViT reference: losses differ by "
                             f"{loss_err}")
    # the key biases' updates are f32 noise (their gradient is zero in
    # exact arithmetic): the 1e-7 floor holds them
    log(f"[reference] tiny f32 ViT (flash), 3 atc steps over 2 ranks: card "
        f"(K2, K3a, K3b, {tiny.depth * 2 * 3} launches each) vs host "
        f"(plain) params within {worst:.3g} of their bound at most "
        f"({worst_key}), losses within {loss_err:.3g}")
    return launches

# ------------------------------------------------------------------ #
# phases 15-17: the eager bf.* API, windows and the optimizer wrappers
# ------------------------------------------------------------------ #
EAGER_WRAPPERS = ("DistributedAdaptThenCombineOptimizer",
                  "DistributedNeighborAllreduceOptimizer",
                  "DistributedGradientAllreduceOptimizer",
                  "DistributedWinPutOptimizer",
                  "DistributedPullGetOptimizer",
                  "DistributedPushSumOptimizer")
EAGER_FULL_WIDTH = ("DistributedAdaptThenCombineOptimizer",
                    "DistributedNeighborAllreduceOptimizer",
                    "DistributedGradientAllreduceOptimizer",
                    "DistributedWinPutOptimizer",
                    "DistributedPushSumOptimizer")


def eager_ops(dev, dtype, seed, n=8, shape=(64, 33)):
    """Every eager op of the flat API on ``n`` ranks stacked on ``dev``,
    from seeded f32 inputs cast to ``dtype``: {op: rank-major tensor}
    (ragged gathers as one tensor per rank, versions and associated p as
    tensors).  Re-initializes the global context and shuts it down."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as T

    rng = np.random.default_rng(seed)
    x_np = rng.standard_normal((n,) + tuple(shape)).astype(np.float32)
    out = {}
    bf.init(size=n, device=dev, local_size=2)
    try:
        x = torch.from_numpy(x_np).to(device=dev, dtype=dtype)
        out["allreduce_average"] = bf.allreduce(x)
        out["allreduce_sum"] = bf.allreduce(x, average=False)
        out["broadcast"] = bf.broadcast(x, 3)
        out["allgather"] = bf.allgather(x)
        out["allgather_variable"] = bf.allgather(
            [x[r, :r + 1] for r in range(n)])
        bf.set_topology(T.ExponentialTwoGraph(n))
        out["neighbor_allreduce_static"] = bf.neighbor_allreduce(x)
        out["neighbor_allgather_regular"] = bf.neighbor_allgather(x)
        bf.set_topology(T.MeshGrid2DGraph(n), is_weighted=True)
        out["neighbor_allreduce_weighted"] = bf.neighbor_allreduce(x)
        out["neighbor_allreduce_dynamic"] = bf.neighbor_allreduce(
            x, self_weight=0.5,
            src_weights=[{(r - 2) % n: 0.25} for r in range(n)],
            dst_weights=[{(r + 2) % n: 2.0} for r in range(n)])
        assert bf.set_machine_topology(T.RingGraph(n // 2))
        out["hierarchical_neighbor_allreduce"] = \
            bf.hierarchical_neighbor_allreduce(x)
        bf.set_topology(T.StarGraph(n))
        for r, t in enumerate(bf.neighbor_allgather(x)):
            out[f"neighbor_allgather_ragged.{r}"] = t
        out["pair_gossip"] = bf.pair_gossip(x, [r ^ 1 for r in range(n)],
                                            0.75, 0.25)
        bf.set_topology(T.ExponentialTwoGraph(n))
        bf.turn_on_win_ops_with_associated_p()
        assert bf.win_create(x, "w", zero_init=True)
        assert bf.win_put(x, "w", self_weight=0.5, dst_weights=[
            {(r + 1) % n: 0.5} for r in range(n)])
        out["win_put"] = bf.api._wm().window("w").mailbox.clone()
        assert bf.win_get("w", src_weights=[{(r - 2) % n: 0.25}
                                            for r in range(n)])
        out["win_get"] = bf.api._wm().window("w").mailbox.clone()
        assert bf.win_accumulate(x, "w")
        out["win_accumulate"] = bf.api._wm().window("w").mailbox.clone()
        out["win_versions"] = bf.api._wm().window("w").versions.clone()
        out["win_update"] = bf.win_update("w")
        assert bf.win_accumulate(x, "w", self_weight=0.25, dst_weights=[
            {d: 0.25 for d in bf.out_neighbor_ranks(r)} for r in range(n)])
        out["win_update_then_collect"] = bf.win_update_then_collect("w")
        out["win_associated_p"] = bf.api._wm().window("w").p.clone()
        bf.turn_off_win_ops_with_associated_p()
        bf.win_free()
    finally:
        bf.shutdown()
    return out


def eager_ops_worst(card, host, dtype):
    """{op: max |card - host| over its tolerance}: f32 within 1e-6 of the
    largest entry; bf16 within one bf16 step of the largest entry (both
    sides accumulate in f32 and round once to bf16, so an f32 difference
    at a rounding edge lands one bf16 step apart); integer versions and
    float64 p exactly and within 1e-12."""
    worst = {}
    for k, want in host.items():
        got = card[k].cpu()
        if not want.dtype.is_floating_point:
            worst[k] = float((got != want).sum())
            continue
        scale = max(want.abs().max().item(), 1e-30) if want.numel() else 1
        tol = {torch.float64: 1e-12, torch.bfloat16: 2.0 ** -7}.get(
            want.dtype, 1e-6) * scale
        err = (got.double() - want.double()).abs().max().item() \
            if want.numel() else 0.0
        worst[k] = err / tol
    return worst


def _eager_syncs_and_poll():
    """(host syncs of one nonblocking dynamic neighbor_allreduce with new
    weight values, before its synchronize; the polls of an op queued
    behind a device spin, and the longest poll in ms)."""
    import bluefog_tpu_torch as bf

    n = 8
    bf.init(size=n, device="cuda")
    try:
        x = torch.randn(n, 1 << 20, device="cuda")

        def call(w, shift):
            return bf.neighbor_allreduce_nonblocking(
                x, self_weight=1.0 - w,
                src_weights=[{(r - shift) % n: w} for r in range(n)],
                dst_weights=[[(r + shift) % n] for r in range(n)])

        bf.synchronize(call(0.5, 1))          # warm: the index tables
        handles = []
        syncs = _count_syncs(lambda: handles.append(call(0.3125, 1)))
        got = bf.synchronize(handles[0])
        want = 0.6875 * x + 0.3125 * x.roll(1, 0)
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise AssertionError("dynamic neighbor_allreduce: wrong values")
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)        # keep the device busy
        h = bf.allreduce_nonblocking(x)
        polls, longest = [], 0.0
        while True:
            t0 = time.perf_counter()
            ready = bf.poll(h)
            longest = max(longest, (time.perf_counter() - t0) * 1e3)
            if not polls or polls[-1] != ready:
                polls.append(ready)
            if ready:
                break
            time.sleep(0.001)
        bf.synchronize(h)
    finally:
        bf.shutdown()
    return syncs, polls, longest


def phase_eager_ops(seed):
    """Phase 15: every eager op on the card against the host, in f32 and
    bf16; poll never blocks; a nonblocking dynamic neighbor_allreduce
    makes no host sync before its synchronize."""
    for dtype in (torch.float32, torch.bfloat16):
        card = eager_ops("cuda", dtype, seed)
        host = eager_ops("cpu", dtype, seed)
        worst = eager_ops_worst(card, host, dtype)
        bad = {k: v for k, v in worst.items() if v > 1}
        if bad:
            raise AssertionError(f"eager ops {dtype}: card vs host beyond "
                                 f"tolerance {bad}")
        merged = {}
        for k, v in worst.items():
            op = k.split(".")[0]
            merged[op] = max(merged.get(op, 0.0), v)
        log(f"[eager] {str(dtype)[6:]}, 8 ranks: card vs host worst |err| "
            "/ tolerance per op: " + ", ".join(
                f"{k} {v:.3g}" for k, v in merged.items()))
    syncs, polls, longest = _eager_syncs_and_poll()
    if syncs != 0:
        raise AssertionError(f"nonblocking dynamic neighbor_allreduce made "
                             f"{syncs} host syncs before synchronize")
    if polls not in ([False, True], [True]) or longest > 50:
        raise AssertionError(f"poll read {polls}, longest {longest:.2f} ms")
    log(f"[eager] nonblocking dynamic neighbor_allreduce with new weight "
        f"values: {syncs} host syncs before synchronize; poll behind a "
        f"device spin read {polls}, longest poll {longest:.3f} ms")


def eager_step(model, params, stats, opt, batch):
    """One eager training step: every rank's forward and backward through
    ``model.apply``, the gradients written rank-major into ``.grad``, then
    ``opt.step()``.  Returns the per-rank losses ([n] f32)."""
    import torch.nn.functional as F

    images, labels = batch
    n = images.shape[0]
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    losses = torch.empty(n, dtype=torch.float32, device=images.device)
    for r in range(n):
        p_r = {k: v[r].detach().requires_grad_(True)
               for k, v in params.items()}
        with torch.enable_grad():
            logits, new = model.apply(p_r, {k: v[r] for k, v in
                                            stats.items()}, images[r],
                                      train=True)
            loss = F.cross_entropy(logits, labels[r])
            gs = torch.autograd.grad(loss, list(p_r.values()))
        with torch.no_grad():
            for k, g in zip(p_r, gs):
                grads[k][r].copy_(g)
            for k, v in new.items():
                stats[k][r].copy_(v)
            losses[r] = loss.detach().float()
        del loss, gs, p_r
    for k, v in params.items():
        v.grad = grads[k]
    opt.step()
    return losses


def eager_setup(wrapper, p0, s0, n, dev, compress=False):
    """Rank-major copies of ``p0``/``s0`` on ``dev`` and the named wrapper
    over SGD(0.1, momentum 0.9) (under ``compress``, wrapped in a
    CompressedOptimizer keeping half of each rank's gradient).  The
    global context must be initialized."""
    import bluefog_tpu_torch as bf

    def stack(t):
        t = t.detach().to(dev)
        return t.unsqueeze(0).repeat((n,) + (1,) * t.dim()).contiguous()

    params = {k: stack(v) for k, v in p0.items()}
    stats = {k: stack(v) for k, v in s0.items()}
    base = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    opt = getattr(bf, wrapper)(base, params)
    if compress:
        opt = bf.CompressedOptimizer(opt, bf.TopKCompressor(percentage=0.5),
                                     seed=0)
    return params, stats, opt


def phase_eager_resnet(seed):
    """Phase 16: ResNet-50 at full width, 4 stacked ranks, batch 128 per
    rank, trained through five eager wrappers (2 warm-up and 3 timed
    steps, then one profiled step): img/s, step ms, device-busy ms,
    peak memory, K1 20 x 4 x 6 launches and no other kernel; the eager
    ATC wrapper against build_train_step(comm_mode="atc") after 2 steps;
    push-sum's weights sum to 4."""
    import bluefog_tpu_torch as bf

    n, warmup, timed = 4, 2, 3
    model = bf.ResNet50(num_classes=1000, pallas_conv1x1=True,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    p0, s0 = model.state()
    g = torch.Generator("cuda").manual_seed(seed + 1)
    images = torch.randn(n, BATCH, 224, 224, 3, generator=g, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (n, BATCH), generator=g, device="cuda")
    batch = (images, labels)
    n_params = sum(v.numel() for v in p0.values())
    rows = {}
    for wrapper in EAGER_FULL_WIDTH:
        t_start = time.perf_counter()
        bf.init(size=n, device="cuda")
        bf.set_topology(bf.ExponentialTwoGraph(n))
        params, stats, opt = eager_setup(wrapper, p0, s0, n, "cuda")
        win_bytes = sum(w.nbytes() for w in
                        bf.api._wm().ctx.windows.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for i in range(warmup + timed):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            loss = eager_step(model, params, stats, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / timed
        t_prof = time.perf_counter()
        prof_wall, busy = _profile_step(
            lambda: eager_step(model, params, stats, opt, batch),
            wrapper[11:], top=3, host_ops=False)
        t_prof = time.perf_counter() - t_prof
        steps = warmup + timed + 1
        launches = _expect_launches(f"eager {wrapper}", {
            "conv1x1_backward": K1_LAUNCHES_PER_RANK_STEP * n * steps}
        )["conv1x1_backward"]
        if not torch.isfinite(loss).all():
            raise AssertionError(f"{wrapper}: non-finite loss "
                                 f"{loss.tolist()}")
        extra = ""
        if wrapper == "DistributedPushSumOptimizer":
            ps = opt.ps_weights().double().sum().item()
            if abs(ps - n) > 1e-4 * n:
                raise AssertionError(f"push-sum weights sum to {ps}")
            extra = f", push-sum weights sum {ps:.7f}"
        rows[wrapper] = wall
        log(f"[eager16] {wrapper}: {n * BATCH / wall:.1f} img/s per card, "
            f"step {wall * 1e3:.2f} ms, profiled step wall "
            f"{prof_wall:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / prof_wall:.1f}%), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, window "
            f"state {win_bytes / 1e6:.1f} MB, K1 launches {launches} = 20 x "
            f"{n} ranks x {steps} steps{extra} ({time.perf_counter() - t_start:.1f}"
            f" s, the profile {t_prof:.1f} s)")
        bf.win_free()
        bf.shutdown()
        del params, stats, opt
        torch.cuda.empty_cache()

    # the eager ATC wrapper against build_train_step(comm_mode="atc"):
    # one start, the same data, 2 steps
    topo = bf.uniform_topology_spec(bf.ExponentialTwoGraph(n))
    backend = bf.StackedBackend(n, device="cuda")
    ref = bf.rank_major(p0, backend)
    ref_stats = bf.rank_major(s0, backend)
    ref_opt = torch.optim.SGD(ref.values(), lr=0.1, momentum=0.9)

    def loss_fn(p, s, b):
        import torch.nn.functional as F
        logits, new = model.apply(p, s, b[0], train=True)
        return F.cross_entropy(logits, b[1]), new

    step = bf.build_train_step(loss_fn, ref_opt, backend, comm_mode="atc",
                               topology=topo, has_aux=True)
    for i in range(2):
        ref, ref_stats, ref_opt, ref_loss = step(ref, ref_stats, ref_opt,
                                                 batch, i)
    bf.init(size=n, device="cuda")
    bf.set_topology(bf.ExponentialTwoGraph(n))
    params, stats, opt = eager_setup(EAGER_WRAPPERS[0], p0, s0, n, "cuda")
    for i in range(2):
        loss = eager_step(model, params, stats, opt, batch)
    bf.shutdown()
    worst, equal = 0.0, True
    for k, want in ref.items():
        got = params[k]
        equal = equal and torch.equal(got, want)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / (5e-4 * scale + 5e-7))
    if worst > 1 or not torch.allclose(loss, ref_loss, rtol=0, atol=1e-3):
        raise AssertionError(f"eager ATC vs build_train_step(atc): params "
                             f"{worst:.3g} of the tolerance, losses "
                             f"{loss.tolist()} vs {ref_loss.tolist()}")
    log(f"[eager16] eager ATC wrapper vs build_train_step(comm_mode='atc') "
        f"after 2 steps: params within {worst:.3g} of the tolerance "
        f"(5e-4 of each leaf's largest entry + 5e-7), bit-equal: {equal}; "
        f"{n_params} params per rank")
    del ref, ref_stats, ref_opt, step, params, stats, opt, model
    torch.cuda.empty_cache()
    return rows


def eager_tiny_run(dev, seed, wrapper, compress=False, steps=3):
    """A tiny f32 ResNet (one Bottleneck per stage of (1, 1), 8 filters,
    pallas_conv1x1=True) trained ``steps`` steps over 4 ranks on ``dev``
    through ``wrapper``: (params, stats, losses [steps, 4]) on the host,
    and K1's launches."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.models import BottleneckBlock
    from bluefog_tpu_torch.parallel import conv1x1 as k1

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(4, 4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4, 4)))
    def build(d):
        return bf.ResNet((1, 1), BottleneckBlock, num_classes=10,
                         num_filters=8, dtype=torch.float32,
                         pallas_conv1x1=True, device=d,
                         generator=torch.Generator(d).manual_seed(seed))

    p0, s0 = build("cpu").state()       # one start for both devices
    model = build(dev)
    bf.init(size=4, device=dev)
    try:
        bf.set_topology(bf.ExponentialTwoGraph(4))
        params, stats, opt = eager_setup(wrapper, p0, s0, 4, dev, compress)
        k1.reset_launch_counts()
        losses = [eager_step(model, params, stats, opt,
                             (x.to(dev), y.to(dev))).cpu()
                  for _ in range(steps)]
        launches = k1.conv1x1_backward.launches
    finally:
        bf.win_free()
        bf.shutdown()
    return ({k: v.cpu() for k, v in params.items()},
            {k: v.cpu() for k, v in stats.items()},
            torch.stack(losses), launches)


def phase_eager_reference(seed):
    """Phase 17: the tiny f32 ResNet, 3 steps over 4 ranks, card (K1)
    against host (plain version) for each of the six wrappers and the
    CompressedOptimizer: params, batch statistics and losses within phase
    7's tolerance."""
    rows = []
    for wrapper, compress in ([(w, False) for w in EAGER_WRAPPERS]
                              + [(EAGER_WRAPPERS[0], True)]):
        card = eager_tiny_run("cuda", seed, wrapper, compress)
        host = eager_tiny_run("cpu", seed, wrapper, compress)
        if card[3] != 4 * 4 * 3 or host[3] != 0:
            raise AssertionError(f"{wrapper}: K1 launched {card[3]} times "
                                 f"on the card, {host[3]} on the host")
        worst = 0.0
        for which in (0, 1):
            for k, want in host[which].items():
                got = card[which][k]
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                worst = max(worst, err / (5e-4 * scale + 5e-7))
        loss_err = (card[2] - host[2]).abs().max().item()
        label = ("CompressedOptimizer(" + wrapper[11:] + ")" if compress
                 else wrapper[11:])
        if worst > 1 or loss_err > 1e-5:
            raise AssertionError(f"tiny eager reference {label}: params/"
                                 f"stats {worst:.3g} of the tolerance, "
                                 f"losses {loss_err:.3g}")
        rows.append(f"{label} {worst:.3g}/{loss_err:.2g}")
    log("[eager17] tiny f32 ResNet, 3 eager steps over 4 ranks, card (K1, "
        "48 launches each) vs host: worst params/stats error over its "
        "tolerance / worst loss error: " + ", ".join(rows))



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if os.environ.get("BLUEFOG_OPS_ON_CPU", "0") in ("1", "true", "True"):
        print("chip_smoke: BLUEFOG_OPS_ON_CPU asks the eager ops for the "
              "host; unset it to measure the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = phase_device()
    kernels = phase_kernels(name, args.seed)
    kernels.update(phase_k1(name, args.seed))
    kernels.update(phase_flash(name, args.seed))
    kernels.update(phase_splash(name, args.seed))
    launches = phase_serving(args.seed)
    phase_reference(args.seed)
    torch.backends.cudnn.benchmark = True   # the training path's convs
    launches["conv1x1_backward"] = phase_train_1rank(args.seed)
    phase_train_4ranks(args.seed)
    phase_train_modes(args.seed)
    torch.backends.cudnn.benchmark = False
    phase_train_reference(args.seed)
    phase_train_modes_reference(args.seed)
    launches.update(phase_llama_train_1rank(args.seed))
    phase_llama_train_2ranks(args.seed)
    phase_llama_reference(args.seed)
    launches["splash_backward"] = phase_llama1b(args.seed)["splash_backward"]
    phase_llama1b_2ranks(args.seed)
    phase_llama_reference(args.seed, attn_impl="splash", seq=128)
    phase_vit(args.seed)
    phase_eager_ops(args.seed)
    torch.backends.cudnn.benchmark = True   # the training path's convs
    phase_eager_resnet(args.seed)
    torch.backends.cudnn.benchmark = False
    phase_eager_reference(args.seed)
    entries = []
    for kname in ("decode_attention", "decode_attention_int8"):
        entries.append(dict(
            name=kname, route="cuda",
            source="bluefog_tpu_torch/csrc/decode_attention.cu",
            replaces="bluefog_tpu/parallel/pallas_decode.py:57",
            launches=launches[kname], **kernels[kname]))
    entries.append(dict(
        name="conv1x1_backward", route="cuda",
        source="bluefog_tpu_torch/csrc/conv1x1_backward.cu",
        replaces="bluefog_tpu/parallel/pallas_conv.py:80",
        launches=launches["conv1x1_backward"],
        **kernels["conv1x1_backward"]))
    for kname in FLASH_KERNELS:
        entries.append(dict(
            name=kname, route="cuda",
            source="bluefog_tpu_torch/csrc/flash_attention.cu",
            replaces=FLASH_REPLACES[kname], launches=launches[kname],
            **kernels[kname]))
    entries.append(dict(
        name="splash_backward", route="cuda",
        source="bluefog_tpu_torch/csrc/splash_backward.cu",
        replaces="bluefog_tpu/parallel/splash.py:98",
        launches=launches["splash_backward"], **kernels["splash_backward"]))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
