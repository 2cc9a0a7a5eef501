#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bluefog_tpu_torch) on one NVIDIA
card: the quickest proof that the port starts, builds its kernels and
serves on the GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero, printing no result):

1. Device: the card's name and power limit (nvidia-smi), its compute
   capability; build every kernel from the sources in the checkout into
   build/torch_kernels/ (one nvcc per source, all started together).
2. Kernel against plain: the decode-attention kernel, bf16 and int8
   cache, against its plain PyTorch version on the same inputs, at the
   serving shapes of Llama-3.1-8B (B=8, KV=8, rep=4, D=128, S 2048 and
   8192, per-row positions including 0 and S-1) and one small odd shape
   (D=16, S=40, rep=1, f32).  Times: CUDA events, median of 25 runs,
   each after a write of 128 MB that evicts the 50 MB L2 (in a decode
   step the other layers' weights do the same).  The bound is the
   larger of the bytes the call must move over the card's memory rate
   and its flops over the peak rate of its input type.
3. Serving: Llama-3.1-8B at full width (32 layers, random bf16 weights
   from --seed at flax's initializer scales) through ServingEngine
   (capacity 8, max_len 2048, prefill chunk 256): 16 requests, prompt
   lengths 16-1500, 32-128 new tokens, half greedy and half at
   temperature 0.8; then 4 requests with the int8 K/V cache.  Every
   request must complete its budget with finite logits, and the kernel's
   launch count in the run must equal n_layers x decode steps.
4. Reference: the tiny f32 config served on the card (kernel) and on the
   CPU (plain version) emits the same greedy tokens, both cache layouts.

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
KERNEL_SOURCES = ["decode_attention"]


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
    launches = phase_serving(args.seed)
    phase_reference(args.seed)
    entries = []
    for kname in ("decode_attention", "decode_attention_int8"):
        entries.append(dict(
            name=kname, route="cuda",
            source="bluefog_tpu_torch/csrc/decode_attention.cu",
            replaces="bluefog_tpu/parallel/pallas_decode.py:57",
            launches=launches[kname], **kernels[kname]))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
