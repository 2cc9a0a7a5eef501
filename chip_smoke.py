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
   write of 128 MB that evicts the 50 MB L2; the bound is the larger of
   the bytes the call must move over the card's memory rate and its
   operations over the peak rate of its input type):
   a. K4 decode attention, bf16 and int8 cache, at the serving shapes of
      Llama-3.1-8B (B=8, KV=8, rep=4, D=128, S 2048 and 8192, per-row
      positions including 0 and S-1) and one small odd f32 shape;
   b. K1 1x1-conv backward at the 7 distinct ResNet-50 shapes of batch
      128 in bf16 and two small f32 shapes: max |err| of dx and dw, dw
      bit-equal across two runs, kernel, plain and bound ms, and the two
      cuBLAS products dy @ w.T and x.T @ dy as the library yardstick.
3. Serving: Llama-3.1-8B at full width (32 layers, random bf16 weights
   from --seed at flax's initializer scales) through ServingEngine
   (capacity 8, max_len 2048, prefill chunk 256): 16 requests, prompt
   lengths 16-1500, 32-128 new tokens, half greedy and half at
   temperature 0.8; then 4 requests with the int8 K/V cache.  Every
   request must complete its budget with finite logits, and the kernel's
   launch count in the run must equal n_layers x decode steps.
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
7. Reference (training): a tiny f32 ResNet trained 3 atc steps over 4
   ranks on the card (kernel) and on the CPU (plain version) gives the
   same params, batch statistics and losses within f32 tolerance.

The line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
KERNEL_SOURCES = ["decode_attention", "conv1x1_backward"]


def log(*a):
    print(*a, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def time_ms(fn, flush: torch.Tensor, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after two
    warm-up runs, each run preceded by a write of ``flush``."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def phase_kernels(name, seed):
    from bluefog_tpu_torch.models.llama import _amax_quantize
    from bluefog_tpu_torch.parallel import decode_attention as da

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    cases = [(8, 8, 4, 2048, 128, torch.bfloat16),
             (8, 8, 4, 8192, 128, torch.bfloat16),
             (3, 2, 1, 40, 16, torch.float32)]
    results = {}
    for b, n_kv, rep, s, d, dt in cases:
        q = torch.randn(b, 1, n_kv * rep, d, generator=g, device="cuda",
                        dtype=dt)
        k = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=dt)
        v = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=dt)
        idx = torch.randint(0, s, (b,), generator=g, device="cuda",
                            dtype=torch.int32)
        idx[0], idx[1] = 0, s - 1
        kq, ks = _amax_quantize(k)
        vq, vs = _amax_quantize(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        tol = 1.6e-2 if dt == torch.bfloat16 else 1e-5
        for quantized in (False, True):
            if quantized:
                kname = "decode_attention_int8"
                args = (q, kq, ks, vq, vs, idx)
                run = lambda: da.decode_attention_int8(*args)  # noqa: E731
                plain = lambda: da.decode_attention_plain(  # noqa: E731
                    q, kq, vq, idx, ks, vs)
                cache = kq
            else:
                kname = "decode_attention"
                run = lambda: da.decode_attention(q, k, v, idx)  # noqa
                plain = lambda: da.decode_attention_plain(q, k, v, idx)  # noqa
                cache = k
            out = run()
            torch.cuda.synchronize()
            ref = plain()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.allclose(out.float(), ref.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(
                    f"{kname} B={b} S={s} D={d} {dt}: max |err| {err} "
                    f"beyond atol=rtol={tol}")
            ms = time_ms(run, flush)
            plain_ms = time_ms(plain, flush)
            library_ms = None
            if not quantized:
                # yardstick only: one PyTorch call computing the same
                # function (the port never calls it)
                qs = q.reshape(b, n_kv * rep, 1, d)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= idx[:, None].long())[:, None, None, :]
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
                    qs, k, v, attn_mask=mask, enable_gqa=True)
                lib = sdpa().reshape(b, 1, n_kv * rep, d)
                lib_err = (lib.float() - ref.float()).abs().max().item()
                if lib_err > 4 * tol + 1e-2:
                    raise AssertionError(f"library yardstick disagrees by "
                                         f"{lib_err}")
                library_ms = time_ms(sdpa, flush)
            nbytes, ops = _case_bytes_ops(q, cache, idx, quantized)
            t_bytes = nbytes / rate * 1e3
            t_ops = ops / PEAK_OPS[cache.dtype] * 1e3
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations", library_ms=library_ms)
            log(f"[kernel] {kname} B={b} KV={n_kv} rep={rep} S={s} D={d} "
                f"q={str(dt).split('.')[-1]} idx={idx.tolist()}: max|err| "
                f"{err:.3g} (tol {tol}), kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
                f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB)")
            if (b, s, d) == (8, 2048, 128):  # the serving path's shape
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
    from bluefog_tpu_torch.parallel import decode_attention as da
    from bluefog_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, cfg, capacity=8, max_len=2048,
                        prefill_chunk=256, kv_quant=kv_quant)
    torch.cuda.synchronize()
    da.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da.decode_attention.launches,
                "decode_attention_int8": da.decode_attention_int8.launches}
    m = eng.metrics.summary()
    bad = [r.rid for r in reqs
           if r.state != "completed" or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"requests {bad} did not complete their budget")
    if eng.nonfinite_logit_rows():
        raise AssertionError(f"{eng.nonfinite_logit_rows()} logit rows "
                             "were not finite")
    want = cfg.n_layers * m["decode_steps"]
    if launches[counter] != want or launches[counter] == 0:
        raise AssertionError(f"{counter} launched {launches[counter]} "
                             f"times, want n_layers x decode steps = {want}")
    other = sum(v for k, v in launches.items() if k != counter)
    if other:
        raise AssertionError(f"unexpected launches {launches}")
    log(f"[serve] kv_quant={kv_quant}: {len(reqs)} requests, "
        f"{m['tokens_generated']} tokens in {wall:.2f} s wall; tokens/s "
        f"{m['tokens_per_sec']:.1f}, TTFT p50 {m['ttft_p50'] * 1e3:.1f} ms,"
        f" decode step p50 {m['decode_step_ms_p50']:.2f} ms over "
        f"{m['decode_steps']} steps, {m['prefill_chunks']} prefill chunks, "
        f"{counter} launches {launches[counter]}")
    return m, launches[counter]


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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events)
    active = sum(r.state == "decode" for r in reqs)
    log(f"[profile] {steps} decode steps ({active} slots decoding): wall "
        f"{wall_us / steps / 1e3:.2f} ms/step, device busy "
        f"{busy / steps / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}%)")
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


# ResNet-50 at batch 128: the distinct (N, ci, co) of its 20 K1 launches
# per rank-step (16 expansions, 4 projections; stage 1's projection has
# its expansion's shape), then two small f32 shapes
K1_SHAPES = [(401408, 64, 256, torch.bfloat16, "stage 1 expand x3 + proj"),
             (100352, 128, 512, torch.bfloat16, "stage 2 expand x4"),
             (100352, 256, 512, torch.bfloat16, "stage 2 proj"),
             (25088, 256, 1024, torch.bfloat16, "stage 3 expand x6"),
             (25088, 512, 1024, torch.bfloat16, "stage 3 proj"),
             (6272, 512, 2048, torch.bfloat16, "stage 4 expand x3"),
             (6272, 1024, 2048, torch.bfloat16, "stage 4 proj"),
             (98, 32, 16, torch.float32, "small f32"),
             (196, 64, 24, torch.float32, "small f32")]
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
    for n, ci, co, dt, what in K1_SHAPES:
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
        log(f"[kernel] conv1x1_backward {what} N={n} ci={ci} co={co} "
            f"{str(dt).split('.')[-1]}: max|err| dx {err_dx:.3g} dw "
            f"{err_dw:.3g} (tol {tol_dw:.3g}), dw bit-equal across runs, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} GFLOP; {ops / ms / 1e9:.1f} TFLOP/s)")
        if (n, ci, co) == (401408, 64, 256):   # the heaviest path shape
            results["conv1x1_backward"] = rec
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

    k1.reset_launch_counts()
    da.reset_launch_counts()


def _check_launches(want, what):
    from bluefog_tpu_torch.parallel import conv1x1 as k1
    from bluefog_tpu_torch.parallel import decode_attention as da

    got = k1.conv1x1_backward.launches
    if got != want or got == 0:
        raise AssertionError(f"{what}: conv1x1_backward launched {got} "
                             f"times, want {want}")
    if da.decode_attention.launches or da.decode_attention_int8.launches:
        raise AssertionError(f"{what}: decode attention launched")
    return got


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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
    launches = _check_launches(K1_LAUNCHES_PER_RANK_STEP * i,
                               "train 1 rank")
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
    launches = _check_launches(K1_LAUNCHES_PER_RANK_STEP * 4 * (warmup
                                                                + timed),
                               "train 4 ranks")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = phase_device()
    kernels = phase_kernels(name, args.seed)
    kernels.update(phase_k1(name, args.seed))
    launches = phase_serving(args.seed)
    phase_reference(args.seed)
    torch.backends.cudnn.benchmark = True   # the training path's convs
    launches["conv1x1_backward"] = phase_train_1rank(args.seed)
    phase_train_4ranks(args.seed)
    torch.backends.cudnn.benchmark = False
    phase_train_reference(args.seed)
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
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
