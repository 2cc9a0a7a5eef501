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
      shapes of Llama-3.1-8B (KV=8, rep=4, D=128: B=8 at S 2048 and
      8192, phase 23c's B=8 and B=1 at S=1024 and B=1 at S=64, and
      phase 25b's tp 2 decode, B=16 KV=4 at S=128;
      positions drawn per row from --seed with rows at 0 and S-1, and
      positions either side of the split boundaries, checked only) and
      one small odd f32 shape, bit-equal across two runs, SDPA beside it
      on the drawn positions (at S=2048 also timed without the spin, the
      host's launch gap included); at every shape the tolerance rejects
      a planted merge that drops each row's last live split;
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
      128) and SDPA's forward timed at every shape; at the six model
      shapes (ViT-B/16 at 32 images too, phase 22b's launch shape, the
      8B width's at tp 2, phase 25a's B=8, H=16, KV=4, and phase 23c's
      uncached rollout at B=1, T=23, under one tile) K3a's
      and K3b's (wgmma) kernel, plain, bound and library ms (SDPA's
      backward for K3a + K3b together), K2's at the training shape
      (SDPA's forward), and at each of them the planted faults in K3a's
      key tiles rejected (causal: a skipped diagonal tile and group
      member, a block of keys within the one tile at T=23; non-causal: a
      skipped last key tile and query tile).
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
   (capacity 8, max_len 2048, prefill chunk 256): 8 requests, prompt
   lengths 16-1500, 32-128 new tokens, half greedy and half at
   temperature 0.8; then 2 requests with the int8 K/V cache.  Every
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
   (CUDA events); K1 launched 20 x 4 x steps times; the edge account
   (bf_edge_bytes_total{src,dst}) holds steps x one rank's parameter
   bytes on every edge of the topology and nothing elsewhere;
   observe.profile_step of one step prints its FLOPs (K1's work
   included), collective bytes (one rank's flat buffer per shift class)
   and device ms; and after 3 steps
   from one state on the same per-rank data (batch 16), the consensus
   distance under atc is below that of comm_mode="none".
6b. Train-step modes, 4 ranks stacked, ResNet-50 at full width, batch
   128 per rank, each mode its own build (1 warm-up, 3 timed steps, then
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
   from --seed (2 warm-up and 5 timed steps).  tokens/s per card, step ms, MFU over 989 TFLOP/s,
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
   --seed, 2 warm-up and 3 timed steps per window: (a) splash, remat
   policy "none" (K2 2 x 16 x 5 launches, K5 16 x 5, K3a/K3b none);
   (b) flash (K3a/K3b 16 x 5 each, K5 none); (c) splash with remat
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
   through ResNet.apply, .grad written rank-major, opt.step(); 1 warm-up
   and 3 timed steps, then one profiled step: img/s per card, step ms,
   device-busy ms and share, peak memory, window bytes; K1 20 x 4 x 5
   launches and no other kernel; push-sum's weights sum to 4; the eager
   ATC wrapper and build_train_step(comm_mode="atc") from one state on
   the same data agree after 2 steps (and whether bit-equal).
17. Reference (eager wrappers): the tiny f32 ResNet of phase 7, 3 eager
   steps over 4 ranks, card (K1) against host, for the six wrappers and
   CompressedOptimizer(TopK) over ATC, within phase 7's tolerance.
18. The process backend, through the port's bfrun (python -m
   bluefog_tpu_torch.run; the children are this script with --child,
   loading the kernels phase 1 built; every job under a timeout that
   kills all its processes): the parent first trains StackedBackend(2)
   3 atc steps over ExponentialTwoGraph(2) from one state, ResNet-50 at
   batch 16 a rank with cuDNN deterministic, as the reference.
   a. bfrun -np 1, one process holding 2 ranks, bf.init() joining an
      NCCL group of world size 1: the 3 reference steps bit-equal to
      the parent's; then batch 128 a rank, 2 warm-up and 3 timed steps
      (img/s per card, step ms, the combine's ms, peak memory, K1 20 x
      2 x 5 launches), 0 host syncs in a steady step; the eager
      allreduce, broadcast and allgather through NCCL, exact.
   b. bfrun -np 2 on the one card, each process creating a gloo group
      that bf.init(device="cuda:0") adopts (device tensors cross through
      pinned host buffers): the 3 reference steps within phase 7's
      tolerance of the parent's (and whether bit-equal); the consensus
      distance under atc below comm_mode="none"'s; the timed window of
      (a) at one rank a process (K1 20 x 5), the exchange's ms and the
      wire's three legs (device to host, gloo, host to device) for the
      params' bytes; then an eager job of 2 ranks a process:
      neighbor_allreduce consensus, win_put gossip, a ragged
      neighbor_allgather over StarGraph(4).
   c. NCCL asked for two ranks on one card: the exit code and NCCL's
      message (the reason (b) runs over gloo).
19. The rest of single-engine serving at Llama-3.1-8B's full width and
   depth (32 layers, random bf16 weights from --seed as phase 3), every
   engine with 8 slots and 256-token prefill chunks, each run with the
   launch counts reset just before and read just after (K4 only: its
   bf16 or int8 variant n_layers x decode steps, or the draft's layers x
   (lookahead + 1) x speculative steps):
   a. HF import: the model's state dict in HF's layout (Linear weights,
      half-split rotary rows) through llama_config_from_hf (a
      SimpleNamespace config) and llama_params_from_hf: every tensor and
      the logits of a 40-token prompt bit-equal to the source.
   b. quantize_llama_params on the card; 8 greedy requests (prompts
      16-700, 8 new tokens) at max_len 1024 with bf16 weights, then
      weight_quant="int8", then "w8a8" with the int8 K/V cache (the
      integer attention on every (layer, prefill chunk), counted): the
      probe's logits within tests/test_quant.py's bound of bf16's, first
      greedy tokens against bf16's (a flip only at a margin within twice
      the quantized logits' gap), decode step ms, tokens/s, peak memory
      and the int8 weight bytes.
   c. The prefix cache: two waves of 8 requests (8 new tokens each)
      sharing a 1024-token
      prefix (four 256-token chunks) through one PrefixCache; the second
      wave restores 32 chunks and its greedy streams equal a cold
      engine's bit for bit; TTFT p50 with and without the cache.
   d. Speculative decoding, lookahead 4, 8 greedy requests of 12 tokens:
      the target as its own draft and a 2-layer draft at 8B width from
      --seed + 1, against plain greedy; accepted tokens a step, tokens/s.
   e. Drain and failover (capacity 4, a virtual clock, 8 requests, half
      at temperature 0.8): e0.drain(handoff=e1.submit) mid-run, then e1
      behind a FaultyReplica dies and failover_stranded moves its
      requests to a replacement sharing the PrefixCache; one request
      whose deadline passed while e1 was dead retires expired; the rest
      against an unfaulted run.
   Where a stream of (d) or (e) parts from its reference, the flip must
   sit at a near-tie: the two tokens' margin in the multi-token path's
   logits (with the request's Gumbel draw at temperature > 0) within
   twice the sup-norm gap between the K4 path's and the multi-token
   path's logits there; and each of the two paths' logits must lie
   within twice the uncached bf16 forward's sup-norm distance of the f32
   forward over the same weights, a ceiling neither path sets.
20. The serving fleet at Llama-3.1-8B's full width and depth (random
   bf16 weights from --seed as phase 3): three replicas on the one card
   over one model's weights, each its own ServingEngine (8 slots,
   max_len 2048, 256-token chunks) with its own metrics registry and
   scheduler, all sharing one PrefixCache, behind FleetRouter (push-sum
   gossip of the replicas' gauges over ExponentialTwoGraph(3)); a
   harness clock (seconds since the phase began) drives every engine and
   the router; each round steps every live replica and polls the router
   once, and one request arrives a round through router.submit.  Each
   run with the launch counts reset just before and read just after (K4
   n_layers x decode steps summed over replicas, draft steps included):
   a. 12 requests (prompts 16-1500 tokens, 4 of them a shared 1024-token
      prefix, 32-128 new tokens, half greedy and half at temperature
      0.8): every request completes its budget with finite logits;
      placements per replica, fleet tokens/s, TTFT p50 and p99,
      decode-step ms p50 per replica; a second router over the same
      registries ranks every round alike; then the same requests on one
      replica (tokens/s beside the fleet's; one card's replicas share its
      SMs and host thread, so the pair is not a scaling number).
   b. The same requests with replica 1 behind a FaultyReplica that dies
      at its 20th step, on a round clock (the harness seconds at the
      start of the round: the replicas of a fleet step side by side, so
      a live one's heartbeat is as old as the round, whatever the steps
      of the others on this one host thread cost): the staleness guard
      (0.5 s) excises it at the first poll past the window,
      failover_stranded(resubmit=router.submit) moves its requests to
      the survivors, and every request completes; polls to excision,
      the time from death to the last moved request's first new token,
      chunks restored from the shared prefix cache; each stream that
      parts from (a)'s must part at a near-tie (phase 19's check).
   c. A burst against queues of 2 raises FleetSaturated with every
      replica's depth; router.publish lands the bf_fleet_serving_*
      gauges, prometheus_text() carries them, snapshot(dir) writes
      metrics.prom, events.jsonl and trace.json.
   d. profile() on a live replica mid-run, a plain engine and a
      self-drafting speculative one: each program's device ms by kernel,
      K4's share of decode_step (spec_step), FLOPs and MFU; the later
      streams equal those of a run without the call.

21. Sequence parallelism at Llama-3.1-8B's width (4 layers, f32 master
   params, bf16 compute, llama3 rope), one sequence of T = 8192 tokens
   (the config's max_seq_len: phase 8's 8192 tokens a step):
   a. one layer's attention at every kernel shape 21b and 21c run (8B
      width, bf16, causal): the flash ring at sp 4 (4 shards of q [1,
      2048, 32, 128], 8 kv heads; 10 live (shard, block) pairs) and at
      sp 2 (2 x 4096), forward (K2) and backward (K3a, K3b) held entry by
      entry to the same ring over the plain versions on the same card
      tensors (flash_check.ring_term_sizes), the ring with pair (S - 1,
      0) left out rejected; Ulysses at sp 4 (its kernels at [4, 8192, 8
      heads, 2 kv, 128], the head groups folded into the batch) and one
      flash_attention over the 8192, each launching K2, K3a and K3b once
      and held to the plain versions (flash_check.term_sizes, in parts
      of one kv head), planted faults rejected; ring forward + backward,
      wall and device ms, beside one flash_attention over the 8192 and
      SDPA; then K2, K3a and
      K3b on the ring's diagonal block (offsets equal) and a full
      off-diagonal block (q_offset 2048, kv_offset 0): kernel, plain,
      bound and SDPA ms (causal, non-causal), launches a 21b ring step.
   b. training on 1 rank, batch 1 x 8192, SGD(1e-3, momentum 0.9), 1
      warm-up and 3 timed steps each: (i) attn_mode "full" with flash,
      (ii) ring + flash and (iii) Ulysses + flash, both over SeqAxis("sp",
      4) with batch_specs ("bf", None, "sp"): tokens/s per card, step ms,
      MFU, peak memory, the losses; K2, K3a and K3b launched n_layers x
      steps times under (i) and (iii), 10 x that under (ii); the step-0
      losses of (ii) and (iii) within SP_LOSS_LIMIT of (i)'s, and the
      same step 0 with ring pair (3, 0) left out or Ulysses' head groups
      mispaired beyond it; a profile of 2 steps each (device-busy share,
      the attention kernels' shares).
   c. dp 2 x sp 2, 2 layers, ring + flash, atc over ExponentialTwoGraph(2),
      1 x 8192 a rank, 2 warm-up and 3 timed steps: tokens/s per card,
      launches 3 x 2 layers x 2 ranks x steps; after 3 steps (1 x 1024 a
      rank) the consensus distance under atc below comm_mode="none"'s.
   d. the tiny f32 Llama (D = 16) at dp 2 x sp 2, ring + flash and
      Ulysses + flash, 3 atc steps on the card against the host (phase
      10's tolerance); the host run launches no kernel.
   e. bfrun -np 1 at NCCL world size 1: one process holding 2 ranks x 2
      sequence shards, the tiny f32 ring + flash Llama, 3 atc steps,
      bit-equal to StackedBackend(2).

22. Data, checkpoints and fault-tolerant training (each run's temporary
   files under one directory, removed at the end):
   a. 4096 synthetic 224 x 224 x 3 uint8 images (616 MB) and labels over
      1000 classes from --seed through DataLoader(batch_size=128, world=4,
      rank_major=True): the native loader (use_native=True, built with
      g++ into build/torch_native/) and the Python pipeline, img/s of
      each over one epoch; then the native loader through
      device_prefetch(device="cuda"), every [4, 32, ...] batch copied
      back and checked bit for bit against the Python pipeline's.
   b. ViT-B/16 (attn_impl="flash", full width and depth, bf16 compute
      over f32 params) over 4 stacked ranks, guarded atc over
      ExponentialTwoGraph(4), SGD(1e-3, momentum 0.9), fed by the native
      loader through device_prefetch (cast and normalized on the card),
      under run_resilient for 36 steps with checkpoint_every=8 into a
      Checkpointer (max_to_keep=2, writes on a thread) and
      ElasticConfig(bootstrap_rounds=4, max_quarantine_steps=16,
      quarantine_threshold=2.0), through FaultPlan.nan_burst(4, rank=1,
      step=5, duration=2) merged with FaultPlan.preempt(4, rank=2,
      step=12, duration=12): the burst is trained through (skips, no
      rollback); rank 2 is declared dead, healed and the run rolls back
      to step 8; rank 2 rejoins at 24 and is promoted within
      max_quarantine_steps; every rank's params finite; K2, K3a and K3b
      launched 12 layers x 4 ranks x step calls each (replays included).
      img/s per card over the run; the runner's own cost in one window
      (a bare loop of the same step and run_resilient over 8 clean steps
      with a checkpointer that writes nothing, alternated 2 times);
      device ms of a profiled step, checkpoint bytes, save (snapshot and
      write apart), restore (load and copy apart), the rollback's wall
      time, peak memory.  Phase 2c holds K2, K3a and K3b to their plain
      versions at this launch shape (B=32, T=200, H=12, D=64).
   c. A tiny f32 ViT (flash, D = 16) through 22b's plan on the card and on
      the host: the card run launches K2, K3a and K3b 2 layers x 4 ranks
      x step calls each, the host run none; equal (kind, step, rank)
      events, params within phase 14's bound; a checkpoint saved from the card and restored into a fresh
      step runs 3 steps bit-equal to the uninterrupted run.
   d. BLUEFOG_TIMELINE set and bf.init(size=4) on the card (the native
      timeline writer): a 16-step run of the tiny ViT through a burst and
      a death; the Chrome trace parses, holds one resilience.* instant per
      event of the run and drops none.

23. Mixture of Experts: Llama-3.1-8B's width with examples/
   llama_benchmark.py's --experts 8 (top-2 of 8, aux weight 0.01,
   capacity factor 1.25, groups of 4096 tokens; f32 master params, bf16
   compute, the f32 head, remat, SGD(1e-3, momentum 0.9)):
   a. 2 layers, 1 rank, batch 4 x 2048, comm_mode="none", 2 warm-up and
      4 timed steps: tokens/s per card, step ms, MFU over 989 TFLOP/s
      counting 6 x ACTIVE params a token (the experts at top-2 / 8), the
      one-hot dispatch and combine FLOP apart, peak memory, the
      assignments each layer drops by capacity; the loss equals the
      cross-entropy plus 0.01 x the layers' aux loss, is finite and
      falls; K2 launched 2 x n_layers x steps times (remat), K3a and K3b
      n_layers x steps; a profile of 2 steps; then each MoE part alone at
      the step's shape (router and routing, the one-hot dispatch, the
      expert GEMMs, the one-hot combine; CUDA events) and its share of
      the step's device time.
   b. 1 layer, 2 ranks stacked, atc over ExponentialTwoGraph(2), 1 x
      2048 a rank, 2 warm-up and 3 timed steps: tokens/s per card, peak
      memory, the combine's ms a step over every f32 value of a rank,
      experts included; after 3 steps (1 x 512 a rank) the consensus
      distance under atc below comm_mode="none"'s.
   c. 16 of 32 layers in bf16 (random weights from --seed), served
      dropless by ServingEngine (8 slots, max_len 1024, 256-token
      chunks): 8 greedy requests (prompts 16-600, 16 new tokens) with K4
      n_layers x decode steps; tokens/s, TTFT p50, the decode step's
      wall and device ms beside the weight-read bound; each request's
      stream against llama_generate's (K4 counted), and 8 cached tokens
      of a 16-token prompt against the uncached dropless rollout (K2
      counted); a stream that parts must part at a near-tie (phase 19's
      margin check, without the f32 model: a second copy of the weights
      does not fit).
   d. moe/'s expert-sharded step at Mixtral's expert width (d 4096,
      hidden 14336) over 8 stacked ranks, 4 experts (two replicas each),
      2048 tokens a rank, capacity default_capacity(2048, 8): the
      compiled dispatch over compile_all_to_all(PodSpec(4, 2)) bit-equal
      to naive_all_to_all, the transpose round trip exact, the int8 wire
      repeatable and within half a code, each timed; then atc over
      torus_one_peer_schedule((4, 2), "exp2") with guard and health
      through a kill of rank 5, heal_route_table and its return on one
      step object: 0 host syncs in a steady step, experts rank-local,
      the router's spread shrinking, bf_edge_bytes_total billing the
      router's bytes on every edge of each round and nothing else; step
      ms, wire bytes.
   e. Card against host (phase 10's bound): a tiny f32 MoE Llama (flash,
      D = 16, both routers, capacity factor 0.5) forward and gradients,
      and a tiny 23d cycle over 8 ranks.
24. The topology control plane and the fleet simulator:
   a. ViT-B/16 at full width and depth over 8 stacked ranks of 32 random
      images (22b's K2/K3a/K3b shape), guarded atc over a 4-round
      carrier declaring shifts 1, 2, 4, 6, 7, under run_resilient(
      control=TopologyControlPlane(PodSpec(4, 2, ici_cost=1.0,
      dcn_cost=4.0), ..., synchronous=True)) for 22 steps, checkpoints
      at 0 and 12: a LinkWire bills the plane's registry each step from a
      FaultPlan that slows DCN links (0, 2) and (1, 3) 4x from step 2
      (trigger, swap, commit), and kills ranks 6 and 7 at step 13
      (rank_dead, rollback to 12, a membership trigger, swap, commit).
      The port's SimTrainingFleet on the same congestion makes the same
      decisions at the same steps with the same candidate and costs;
      every swap's weights equal swap_comm_weights(plane, dead) and
      every call's weights are carrier-shaped; the live params finite.
      Step wall before and after the swap (img/s per card), on_step's
      host ms, one probation health read's CUDA-event ms, peak memory.
   b. Llama-3.1-8B at full width and depth in bf16 as phase 20 builds it
      (capacity 8, max_len 2048, prefill chunk 256: K4 at B=8, S=2048):
      sim.measure_step_cost(engine, prompts, timer=time.perf_counter) on
      one engine at full slots; then 3 real engines on one VirtualClock
      behind FleetRouter and SimServingFleet under a CostModel with that
      cost, on one RequestTrace from the port's poisson_arrivals and one
      router seed: every routing decision bit-equal, and the ticks,
      makespan, tokens and virtual TTFTs equal.  The measured step cost
      and the simulated makespan.
25. The model axes (a rank's tp or ep shards stacked on the one card,
   bound as a MeshAxis):
   a. Llama-3.1-8B's width at phase 8's depth (4 layers) and batch (4 x
      2048), f32 masters, bf16 compute, flash: step 0 of tp 2 and of tp
      2 with vocab_parallel + tp_seq_shard on the same params as tp 1,
      the loss within TP_LOSS_LIMIT and every leaf's gradient within
      TP_GRAD_LIMIT of its largest entry, and a planted fault (shard 1's
      slice of layer 0's wq zeroed) beyond them; K2, K3a and K3b at each
      shard's heads folded into the batch (q [8, 2048, 16, 128], kv 4,
      held to the plain version in 2c).  Then 1 warm-up and 2 timed
      steps of each at dp 1 (tokens/s, step ms, MFU, peak memory, the
      profile's device ms beside phase 8's) and of tp 2 at dp 2 under
      atc (the combine's ms).
   b. Llama-3.1-8B at full width and depth (bf16, random weights):
      llama_generate of 8 prompts x 120 tokens, 8 greedy tokens, at tp 1
      and at tp 2 (mesh=MeshAxis("tp", 2)), every single-token step of
      the tp 2 decode through K4 at [16, 4, S, 128] (held in 2a); where
      the streams part, both layouts' logits within PATH_ERR_CEILING of
      the uncached bf16 forward's distance to the f32 forward (phase 19's
      near-tie rule); the decode step's wall and device ms.
   c. Phase 23a's MoE model (2 layers, 8 experts) over ep 2: step 0 of
      its first layer held to ep 1 as in a (a planted fault, shard 1's
      experts' w2 zeroed, beyond the limits), then 2 steps of the ep step
      through build_train_step(mesh_axes=, param_specs=): ms, tokens/s,
      peak memory.
26. Pipeline parallelism (a rank's stages stacked on the one card, the
   pp axis bound as a MeshAxis) and the sequence-sharded expert step:
   a. Llama-3.1-8B's width at phase 8's depth (4 layers) and batch (4 x
      2048), f32 masters, bf16 compute, f32 head, remat, flash: step 0
      of llama_pp_loss_fn at pp 2, GPipe (n_micro 2) and the circular
      schedule (2 loops, n_micro 2, the layers in its storage order), on
      the same params as pp 1, the loss within PP_LOSS_LIMIT and every
      leaf's gradient within PP_GRAD_LIMIT of its largest entry, and a
      planted fault (the hop into stage 1 dropped) beyond them; K2, K3a
      and K3b at both stages' microbatches folded into the batch (q [4,
      2048, 32, 128], held in 2c).  Then 1 warm-up and 2 timed steps of
      each through build_train_step(pp_axis=): tokens/s, step ms, MFU,
      peak memory, the profile's device ms and K2 / K3a+K3b ms beside
      phase 8's.
   b. dp 2 x pp 2 under atc at 2 layers: each rank's losses of steps 0
      and 1 within PP_LOSS_LIMIT of dp 2 without pp; step ms, tokens/s.
   c. The expert-sharded step (moe=) over sp_axis=SeqAxis("sp", 2) at
      23d's expert width over 4 stacked ranks, each rank's tokens split
      into two shards by batch_specs, each shard dispatched on its own:
      0 host syncs in a steady step, finite losses, the expert leaves
      bit-equal to a step under the identity combine.
27. Per-device wire buckets: the int8 wires and top-k mixing under
   model-parallel specs, each bucket planned and quantized per (rank,
   device) as a JAX device holds it:
   a. Llama-3.1-8B's width at dp 2 x tp 2 under atc over
      ExponentialTwoGraph(2) in the JAX package's 8B pod layout
      (vocab_parallel + tp_seq_shard, llama_param_specs(vocab_axis=
      "tp"): only the norms replicated), guard + health +
      overlap="bucketed" (4 buckets), SGD without momentum, batch 4 x
      2048 a rank: the uncompressed step, compress="int8" and "int8_sr"
      at WIRE_LAYERS, then MixCompressConfig(0.25, "int8") against its
      own uncompressed step at WIRE_MIX_LAYERS (its MixState is three
      f32 copies of a rank's params).
   b. 26b's dp 2 x pp 2 under atc (2 layers, remat, GPipe),
      uncompressed and under compress="int8".
   Each leg: step 0's loss the uncompressed step's (the wire acts after
   the backward); the params after 2 steps within WIRE_SLACK x the
   int8 grid's bound of the uncompressed run's (per bucket, what a
   receiver's view may miss: half a grid step of the sender's (rank,
   device) scale, one under stochastic rounding, the top-k residual's
   threshold for top-k); every quantizer call's per-(rank, device)
   scales equal to each device's absmax computed apart, and one scale
   over a rank's whole bucket (the old layout) rejected;
   verify_collective_contract [] on the step's profile against the
   per-device plan (mix_wire_layout for top-k; 27b with the pipeline's
   hops) and mismatches against whole-rank buckets; the profile's
   device ms, the combine's ms, wire bytes a step, peak memory and 0
   host syncs in a steady step.

The line before the last is a JSON object with one entry per kernel
(seven; K4's launches are phase 3's, 19's, 20's, 23c's, 24b's and
25b's; K2's, K3a's and K3b's phase 8's, 21b's, 21c's, 22b's, 23a's,
23b's, 24a's, 25's, 26's and 27's, K2's 23c's rollout too); the last
line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
            spin: bool = True, spin_cycles: int = 200_000) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after two
    warm-up runs, each run preceded by a write of ``flush`` and (``spin``)
    a device-side spin of ``spin_cycles`` (~0.1 ms), so that the host's
    time to launch ``fn`` overlaps device work and the events time the
    device alone.  Without the spin a small kernel's time includes the
    host's launch gap."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(spin_cycles)
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
    """K4 against its plain version at the serving shapes (KV=8, rep=4,
    D=128, bf16 and int8 caches: B=8 at S 2048 and 8192, and phase 23c's
    B=8 and B=1 at S=1024 and B=1 at S=64; phase 25b's tp 2 decode, B=16
    KV=4 at S=128) and a small odd f32 shape,
    bit-equal across two runs, on the positions drawn per row from
    ``seed`` (with rows at 0 and S-1 where B > 1; the timed set) and on
    positions at 0, S-1 and one before, at and one after the boundaries
    of the kernel's split (decode_attention.split_len; in rows of one
    set where B holds them all, else one set each), checked only.
    Kernel, plain, SDPA and bound ms on the drawn set; at S=2048 the
    kernel and SDPA also without the device spin (the host's launch gap
    included).  At every shape the tolerance must reject a planted
    fault: the merge dropping each row's last live split
    (decode_attention_split_plain with one split fewer), over the rows
    that keep some splits."""
    from bluefog_tpu_torch.models.llama import _amax_quantize
    from bluefog_tpu_torch.parallel import decode_attention as da

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(8, 8, 4, 2048, 128, torch.bfloat16),
             (8, 8, 4, 8192, 128, torch.bfloat16),
             # phase 23c's: the engine's 8 slots and llama_generate's one
             # row over a 1024-position cache, the rollout's over 64
             (8, 8, 4, 1024, 128, torch.bfloat16),
             (1, 8, 4, 1024, 128, torch.bfloat16),
             (1, 8, 4, 64, 128, torch.bfloat16),
             # phase 25b's tp 2 decode: 8 prompts' two shards folded into
             # the batch, 4 kv heads a shard, a 96 + 32-position cache
             (16, 4, 4, 128, 128, torch.bfloat16),
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
        if b > 1:
            idx[0], idx[1] = 0, s - 1
        checked = [idx]
        # around the split boundaries
        edges = sorted({e for e in (0, split - 1, split, split + 1,
                                    3 * split - 1, s - 1) if 0 <= e < s})
        if b >= len(edges):
            rows = idx.clone()
            rows[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
            checked.append(rows)
        else:
            checked += [torch.full((b,), e, dtype=torch.int32,
                                   device="cuda") for e in edges]
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
            # planted fault: a merge one split short in every row, over
            # the rows that keep some splits
            bad_ratio = 0.0
            for ix in checked:
                live = ix.long().clamp(max=s - 1) // split + 1
                multi = live > 1
                if not bool(multi.any()):
                    continue
                bad = da.decode_attention_split_plain(
                    q, *kv, ix, split, *scales, n_live=live - 1)
                bad_ratio = max(bad_ratio, _ratio_to_tol(
                    bad[multi], plain(ix)[multi], tol))
            if bad_ratio <= 1:
                raise AssertionError(f"{kname} B={b} S={s}: the tolerance "
                                     "passes a merge that drops the last "
                                     "split")
            log(f"[kernel] planted K4 fault, the merge drops each row's "
                f"last live split ({kname}, B={b} S={s}, split {split}): "
                f"{bad_ratio:.3g} times the tolerance over the rows with "
                f"more than one split; rejected")
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
                         _requests(rng, 8, cfg.vocab_size),
                         "decode_attention")
    _, launches8 = _serve(model, cfg, "int8",
                          _requests(rng, 2, cfg.vocab_size),
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
    from bluefog_tpu_torch.parallel.flash_attention import live_pairs

    return live_pairs(t, s_len, causal, q_off, kv_off)


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


def _flash_timed(q, k, v, do, lse, delta, args):
    """{kernel: (launch, its plain version, bytes moved, operations)} of
    K2, K3a and K3b on these inputs and ``args`` (causal, scale,
    q_offset, kv_offset): each input read once, each output written once;
    4, 6 and 8 operations a live pair and head dim."""
    from bluefog_tpu_torch.parallel import flash_attention as fa

    b, t, h, d = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    causal, _, q_off, kv_off = args
    es = q.element_size()
    n_q, n_kv = b * t * h * d * es, b * s_len * kv * d * es
    n_row = b * h * t * 4
    work = b * h * d * _live_pairs(t, s_len, causal, q_off, kv_off)
    plain = (causal, d ** -0.5, q_off, kv_off)
    return {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, *args),
            lambda: fa.flash_forward_plain(q, k, v, *args),
            2 * n_q + 2 * n_kv + n_row, 4 * work),
        "flash_backward_dq": (
            lambda: fa.flash_backward_dq(q, k, v, do, lse, delta, *args),
            lambda: fa.flash_backward_dq_plain(q, k, v, do, lse, delta,
                                               *plain),
            3 * n_q + 2 * n_kv + 2 * n_row, 6 * work),
        "flash_backward_dkv": (
            lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta, *args),
            lambda: fa.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                                *plain),
            2 * n_q + 4 * n_kv + 2 * n_row, 8 * work),
    }


def phase_flash(name, seed):
    """K2, K3a and K3b against their plain versions at every shape of
    ``flash_check.CASES``, each entry of out, dQ, dK and dV within its
    own bound (``flash_check.mismatch``: bf16 two ulps of the entry plus
    2**-7 of the sizes of the terms whose bf16 rounding may differ and
    2**-12 of the largest such size, f32 1e-5 of the largest); lse (f32)
    within 1e-4 absolute plus 1e-5; every output bit-equal across two
    runs.  At the model shapes (``CASES[:N_MODEL]``) the bound must also
    reject the planted faults (``flash_check.planted_faults`` at K3a's
    key tile, within the one tile where T is under two).  K2 and SDPA's forward are timed at every shape; K3a, K3b,
    their plain versions and SDPA's backward at the model shapes; the
    kernels line takes the training shape's."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import flash_check

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    results = {}
    models = flash_check.CASES[:flash_check.N_MODEL]
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
        if case in models:
            # each fault lies in the kernels' own tiles: K3a's key step
            for fault, key, bad in flash_check.planted_faults(
                    q, k, v, do, lse, delta, ref, tile=fa.DQ_KEY_TILE,
                    causal=causal):
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
        if case in models:
            plain_ms = time_ms(
                lambda: fa.flash_forward_plain(q, k, v, *args), flush, reps=5)
            plain = f", plain {plain_ms:.4f} ms"
        log(f"[kernel] K2 ({k2_kernel}) at {what}: {k2_ms:.4f} ms "
            f"({ops / k2_ms / 1e9:.1f} TFLOP/s), SDPA forward {sdpa_ms:.4f}"
            f" ms (K2/SDPA {k2_ms / sdpa_ms:.3f}){plain}, bound "
            f"{bound:.4f} ms")
        if case not in models:
            continue
        # the models' shapes: K3a's and K3b's kernel, plain, bound and
        # library times (and K2's at the training shape, the kernels line's
        # entry for all three)
        first = case == flash_check.CASES[0]
        timed = _flash_timed(q, k, v, do, lse, delta, args)
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


def _resnet_step(n_ranks, comm_mode, seed, batch, backend=None, **kw):
    """ResNet-50 (pallas_conv1x1=True) over ``n_ranks`` stacked ranks, or
    over ``backend`` (a ProcessBackend of ``n_ranks`` ranks: this
    process's rows of every rank's batch): (step, params, stats,
    optimizer, synthetic batch), all from --seed."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt

    model = bt.ResNet50(num_classes=1000, pallas_conv1x1=True,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    if backend is None:
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
    return step, params, stats, opt, (backend.own(images),
                                      backend.own(labels))


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


def _edge_account(topo, before, steps, payload):
    """``bf_edge_bytes_total{src,dst}`` since ``before`` must be ``steps``
    x ``payload`` on every edge of ``topo`` and 0 on every other pair."""
    from bluefog_tpu_torch.observe import fleet

    got = fleet.traffic_snapshot(since=before)
    edges = set(fleet.edge_list(topo))
    want = {e: float(steps * payload) for e in edges}
    if got != want:
        raise AssertionError(f"edge account {got}, want {want}")
    return sorted(edges)


def _profile_step_log(step, args, what):
    """observe.profile_step of one call: FLOPs (the flop counter's and
    the hand-written kernels'), collective bytes, device ms and MFU."""
    from bluefog_tpu_torch import observe

    prof = observe.profile_step(step, *args, name=what, publish=False)
    kern = ", ".join(f"{k} {v / 1e9:.1f}" for k, v in
                     sorted(prof.kernel_flops.items()))
    log(f"[profile_step] {what}: {prof.flops / 1e9:.1f} GFLOP (kernels: "
        f"{kern or 'none'} GFLOP), collective bytes "
        f"{json.dumps(prof.collective_bytes)}, device "
        f"{prof.device_seconds * 1e3:.2f} ms in a {prof.step_seconds * 1e3:.2f}"
        f" ms run, MFU {prof.mfu(prof.device_seconds):.4f} of device time, "
        f"{prof.mfu():.4f} of the run's wall")
    return prof


def phase_train_4ranks(seed):
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.observe import fleet

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    step, params, stats, opt, batch = _resnet_step(4, "atc", seed, BATCH,
                                                   topology=topo)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    traffic0 = fleet.traffic_snapshot()
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
    # the edge account: the flat payload of one rank's params on every
    # edge each step, computed on the host
    payload = sum(v[0].numel() * v.element_size() for v in params.values())
    edges = _edge_account(topo, traffic0, warmup + timed, payload)
    log(f"[train4] bf_edge_bytes_total: {warmup + timed} steps x {payload} "
        f"bytes on each of the {len(edges)} edges {edges}, 0 elsewhere")
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
    i = warmup + timed
    prof = _profile_step_log(step, (params, stats, opt, batch, i),
                             "train4.atc")
    want = {"collective-permute": {"count": len(topo.shift_classes),
                                   "bytes": len(topo.shift_classes)
                                   * payload}}
    if prof.collective_bytes != want:
        raise AssertionError(f"profile_step collective bytes "
                             f"{prof.collective_bytes}, want {want}")
    if not prof.kernel_flops.get("conv1x1_backward"):
        raise AssertionError("profile_step counted no K1 work")
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
    1 warm-up and 3 timed steps, then one profiled step (device-busy ms)
    and one step under the sync debug mode; K1 20 x 4 x 4 launches and no
    other kernel; no mode makes more host syncs than plain atc."""
    timed, warmup = 3, 1
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


def _llama_step(cfg, n_ranks, comm_mode, seed, batch, seq, pp_loops=None,
                **kw):
    """``cfg``'s model (f32 master params from --seed, bf16 compute) over
    ``n_ranks`` stacked ranks: (cfg, model, backend, step, params,
    optimizer, synthetic batch), all from --seed; the module keeps no copy
    of the weights (``state(release=True)``), so the rank-major params are
    the one copy on the card.  ``pp_loops`` (1 GPipe, 2 circular) trains
    through ``llama_pp_loss_fn`` over PP_STAGES stages and PP_MICRO
    microbatches instead (phase 26), the layers in the schedule's storage
    order."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import (llama_circular_layout,
                                                llama_loss_fn,
                                                llama_param_specs,
                                                llama_pp_loss_fn)

    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    state = model.state(release=True)
    loss_fn = llama_loss_fn(model)
    if pp_loops is not None:
        if pp_loops > 1:
            state = llama_circular_layout(state, PP_STAGES, pp_loops)
        loss_fn = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=PP_STAGES,
                                   n_micro=PP_MICRO, n_loops=pp_loops)
        kw.update(pp_axis=bt.MeshAxis("pp", PP_STAGES),
                  param_specs=llama_param_specs(
                      state, tp_axis=None, ep_axis=None, pp_axis="pp"))
    backend = bt.StackedBackend(n_ranks, device="cuda")
    params = bt.rank_major(state, backend)
    del state
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(loss_fn, opt, backend,
                               comm_mode=comm_mode, **kw)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg.vocab_size, (n_ranks, batch, seq + 1),
                        generator=g, device="cuda")
    return (cfg, model, backend, step, params, opt,
            (raw[..., :-1].contiguous(), raw[..., 1:].contiguous()))


def _expect_flash(what, n):
    return _expect_launches(what, dict.fromkeys(FLASH_KERNELS, n))


def _model_flops(cfg, params, tokens, seq=None):
    """llama_benchmark.py's count: 6 x matmul params (the embedding table
    is a gather) per token plus causal attention 6 x L x T x dim (T the
    sequence, LLAMA_SEQ unless ``seq``)."""
    n_params = sum(v[0].numel() for v in params.values())
    matmul = n_params - cfg.vocab_size * cfg.dim
    seq = LLAMA_SEQ if seq is None else seq
    return n_params, (6.0 * matmul * tokens
                      + 6.0 * cfg.n_layers * seq * cfg.dim * tokens)


LLAMA_BATCH, LLAMA_SEQ = 4, 2048
PEAK_BF16 = 989e12


# device kernels by the port's kernel, for the profiles' shares
KERNEL_SYMBOLS = {"K2": ("k2_forward",), "K3a+K3b": ("k3a_dq", "k3b_dkv"),
                  "K5": ("k5_wgmma", "k5_tc", "k5_fma", "k5_sum")}


# the last _profile_llama's device ms a step: {"device", "K2", "K3a+K3b",
# "K5", "head"}; phase 8 keeps its own in PHASE8_PROFILE
LAST_PROFILE: dict = {}
PHASE8_PROFILE: dict = {}


def _profile_llama(step, params, opt, batch, steps=2, what="Llama"):
    """torch.profiler over ``steps`` train steps of ``what`` (a model
    with an f32 head): device-busy share, the top kernels, the attention
    kernels' shares (K2, K3a+K3b, K5) and the head's (kept in
    LAST_PROFILE)."""
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
    LAST_PROFILE.clear()
    LAST_PROFILE.update({k: us / steps / 1e3 for k, us in attn.items()},
                        device=busy / steps / 1e3, head=head / steps / 1e3)
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


def _llama_window(cfg, seed, warmup, timed, label, want,
                  batch_rows=LLAMA_BATCH, seq=LLAMA_SEQ, **kw):
    """One training window of ``cfg`` on 1 rank: a fresh model and
    optimizer from --seed, the launch counts set to 0, ``warmup`` then
    ``timed`` steps of batch ``batch_rows`` x ``seq`` (4 x 2048); the
    counts must be ``want`` and the losses finite near ln(vocab).  Logs
    tokens/s per card, step ms, MFU over 989 TFLOP/s, peak memory and the
    losses after ``label``.  ``kw`` goes to build_train_step.  Returns
    (launches, (model, backend, step, params, opt, batch), model FLOP per
    step, the losses)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, backend, step, params, opt, batch = _llama_step(
        cfg, 1, "none", seed, batch_rows, seq, **kw)
    tokens = batch_rows * seq
    n_params, flops = _model_flops(cfg, params, tokens, seq)
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
    sp = kw.get("sp_axis")
    attn = (f"{cfg.attn_mode} + {cfg.attn_impl} over sp {sp.size}" if sp
            else cfg.attn_impl)
    log(f"{label} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B params), "
        f"1 rank, batch {batch_rows} x {seq}, attn {attn}, "
        f"{remat}, f32 head: {tokens / dt:.1f} tokens/s per card, step "
        f"{dt * 1e3:.2f} ms, MFU {flops / dt / PEAK_BF16:.4f} of 989 "
        f"TFLOP/s, peak memory {peak:.2f} GiB, losses "
        f"{', '.join(f'{x:.4f}' for x in losses.tolist())} (ln vocab "
        f"{ln_v:.4f}); launches {launches} over {warmup + timed} steps")
    return (launches, (model, backend, step, params, opt, batch), flops,
            losses)


def phase_llama_train_1rank(seed):
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    n_layers, warmup, timed = 4, 2, 5
    cfg = _llama8b_cfg(n_layers)
    launches, state, flops, _ = _llama_window(
        cfg, seed, warmup, timed, "[llama1] Llama-3.1-8B width",
        dict.fromkeys(FLASH_KERNELS, n_layers * (warmup + timed)))
    model, backend, step, params, opt, batch = state
    del state
    tokens = LLAMA_BATCH * LLAMA_SEQ
    busy_ms = _profile_llama(step, params, opt, batch)
    PHASE8_PROFILE.update(LAST_PROFILE)
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


def _llama_train_2ranks(cfg, seed, label, per_step, warmup=2, timed=3,
                        **kw):
    """``cfg`` over 2 ranks stacked on the card, atc over
    ExponentialTwoGraph(2), batch 4 x 2048 per rank, 2 warm-up and 3
    timed steps by default; each kernel of ``per_step`` ({kernel: launches per layer
    and rank-step}) launched that many times (``warmup`` and ``timed``
    steps).  Logs tokens/s per card,
    step ms, MFU, peak memory and the combine's ms per step.  ``kw`` goes
    to build_train_step.  Returns the launches."""
    import bluefog_tpu_torch as bt

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _, step, params, opt, batch = _llama_step(
        cfg, 2, "atc", seed, LLAMA_BATCH, LLAMA_SEQ, topology=topo, **kw)
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
    return launches


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


def phase_llama_reference(seed, attn_impl="flash", seq=32, mode="full",
                          sp=1):
    """The tiny f32 Llama (D=16: the kernels' f32 path) with ``attn_impl``
    "flash" (K2, K3a, K3b) or "splash" (K2, K5) trained 3 atc steps over 2
    ranks on the card (kernels) and on the host (plain versions), ``seq``
    tokens per row; with ``sp`` > 1 each rank's sequence in ``sp`` shards
    under ``attn_mode=mode`` ("ring": K2, K3a and K3b on each live (shard,
    block) pair; "ulysses": once a layer).  Tolerance: 1e-4 of each leaf's
    largest entry plus 1e-7, losses 1e-5 (f32 sums in another order
    through three momentum steps; TF32 is off)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    over, kw, per = {}, {}, 1
    if sp > 1:
        over = dict(attn_mode=mode, sp_axis="sp")
        kw = dict(sp_axis=bt.SeqAxis("sp", sp),
                  batch_specs=("bf", None, "sp"))
        per = _ring_pairs(sp) if mode == "ring" else 1
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl=attn_impl,
                              **over)
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
                                   comm_mode="atc", topology=topo, **kw)
        batch = (raw[..., :-1].to(dev), raw[..., 1:].to(dev))
        _reset_counts()
        losses = []
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
            losses.append(loss.cpu())
        if dev == "cuda":
            _expect_launches(f"tiny reference ({attn_impl})", dict.fromkeys(
                kernels, per * cfg.n_layers * 2 * 3))
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
    what = attn_impl if sp == 1 else f"{mode} + {attn_impl}, sp {sp}"
    log(f"[reference] tiny f32 Llama ({what}, T={seq}), 3 atc steps "
        f"over 2 ranks: card ({', '.join(kernels)}, "
        f"{per * cfg.n_layers * 2 * 3} launches each) vs host (plain) params "
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
    warmup, timed = 2, 3
    n = 16 * (warmup + timed)    # 16 layers x steps
    windows = [
        ("(a) splash", {}, {"flash_forward": 2 * n, "splash_backward": n}),
        ("(b) flash", dict(attn_impl="flash"),
         {"flash_forward": 2 * n, "flash_backward_dq": n,
          "flash_backward_dkv": n}),
        ("(c) splash, dots", dict(remat_policy="dots"),
         {"flash_forward": 2 * n, "splash_backward": n})]
    for what, over, want in windows:
        got, state, _, _ = _llama_window(_llama1b_cfg(**over), seed,
                                         warmup, timed, f"[llama1b] {what}",
                                         want)
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
    rank, trained through five eager wrappers (1 warm-up and 3 timed
    steps, then one profiled step): img/s, step ms, device-busy ms,
    peak memory, K1 20 x 4 x 5 launches and no other kernel; the eager
    ATC wrapper against build_train_step(comm_mode="atc") after 2 steps;
    push-sum's weights sum to 4."""
    import bluefog_tpu_torch as bf

    n, warmup, timed = 4, 1, 3
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




# ------------------------------------------------------------------ #
# phase 18: the process backend (bfrun, torch.distributed)
# ------------------------------------------------------------------ #
PROCESS_BATCH = 16   # the comparison's per-rank batch
PROCESS_STEPS = 3    # the comparison's steps from one state
PROCESS_TIMEOUT = 300


def _exp2(n):
    import bluefog_tpu_torch as bt

    return bt.uniform_topology_spec(bt.ExponentialTwoGraph(n))


def _process_compare(backend, seed, comm_mode="atc"):
    """PROCESS_STEPS steps of ResNet-50 over ``backend``'s 2 ranks from
    one state at PROCESS_BATCH a rank, cuDNN in its deterministic mode:
    (this process's params, stats and losses on the host, the consensus
    distance over every rank)."""
    import bluefog_tpu_torch as bt

    bench, det = (torch.backends.cudnn.benchmark,
                  torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        kw = dict(topology=_exp2(2)) if comm_mode == "atc" else {}
        step, params, stats, opt, batch = _resnet_step(
            2, comm_mode, seed, PROCESS_BATCH, backend=backend, **kw)
        losses = []
        for i in range(PROCESS_STEPS):
            params, stats, opt, loss = step(params, stats, opt, batch, i)
            losses.append(loss)
        spread = float(bt.consensus_distance(params, backend))
        out = {f"param.{k}": v.detach().cpu() for k, v in params.items()}
        out.update({f"stat.{k}": v.cpu() for k, v in stats.items()})
        out["loss"] = torch.stack(losses, dim=1).cpu()
        del step, params, stats, opt, batch
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
        torch.cuda.empty_cache()
    return out, spread


def _timed_process_steps(backend, seed, what, warmup=2, timed=3):
    """Phase 18's timed window: ResNet-50 at batch 128 a rank under atc
    over ExponentialTwoGraph(2), K1 counted from zero; then the host
    syncs of one more steady step and the combine alone (host wall: the
    gloo wire waits on the host).  Returns the record the parent logs."""
    torch.backends.cudnn.benchmark = True
    step, params, stats, opt, batch = _resnet_step(
        2, "atc", seed, BATCH, backend=backend, topology=_exp2(2))
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
    wall = (time.perf_counter() - t0) / timed
    launches = _expect_launches(what, {
        "conv1x1_backward": K1_LAUNCHES_PER_RANK_STEP * backend.n_local
        * (warmup + timed)})["conv1x1_backward"]
    if not torch.isfinite(loss).all():
        raise AssertionError(f"{what}: non-finite loss {loss.tolist()}")
    syncs = _count_syncs(lambda: step(params, stats, opt, batch,
                                      warmup + timed))
    copy = {k: v.clone() for k, v in params.items()}
    combine = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.combine(copy, 0)
        torch.cuda.synchronize()
        combine.append((time.perf_counter() - t1) * 1e3)
    rec = dict(step_ms=wall * 1e3,
               img_s=BATCH * backend.n_local * timed / (wall * timed),
               combine_ms=statistics.median(combine[1:]),
               launches=launches, steps=warmup + timed, syncs=syncs,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               wire=("gloo through host" if backend._staged
                     else backend.wire))
    del step, params, stats, opt, batch, copy
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return rec


def _report(rec):
    print("PHASE18 " + json.dumps(rec), flush=True)


def child_18a(seed, out_dir):
    """One process under bfrun -np 1, 2 stacked ranks, NCCL."""
    import torch.distributed as dist

    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.context import get_context

    bt.init()
    b = get_context().backend
    if not (type(b).__name__ == "ProcessBackend" and b.wire == "nccl"
            and (b.size, b.n_local, b.process_count) == (2, 2, 1)):
        raise AssertionError(f"18a: {b}")
    got, spread = _process_compare(b, seed)
    torch.save(got, os.path.join(out_dir, "a0.pt"))
    rec = _timed_process_steps(b, seed, "18a")
    if rec["syncs"] != 0:
        raise AssertionError(f"18a: a steady step made {rec['syncs']} "
                             "host syncs")
    # the eager collectives through NCCL: rank r holds r + 1
    x = bt.from_rank_values(lambda r: torch.full((1024,), float(r + 1),
                                                 device="cuda"))
    got_ops = dict(allreduce=bt.allreduce(x), broadcast=bt.broadcast(x, 1),
                   allgather=bt.allgather(x))
    want = dict(allreduce=torch.full_like(x, 1.5),
                broadcast=torch.full_like(x, 2.0),
                allgather=torch.cat([x[:1], x[1:]], dim=1).expand(2, -1))
    for k, v in want.items():
        if not torch.equal(got_ops[k], v):
            raise AssertionError(f"18a: eager {k} through NCCL is wrong")
    rec.update(backend=repr(b), nccl=torch.cuda.nccl.version(),
               eager_ops="allreduce, broadcast, allgather exact",
               spread=spread, world=dist.get_world_size())
    _report(rec)
    bt.shutdown()


def _wire_split(b, nbytes, reps=5):
    """The gloo wire's three legs for one ``nbytes`` payload each way,
    median ms of ``reps`` (the first run not counted): the device to
    pinned host copy, gloo's send and receive with the other process,
    and the copy back."""
    import torch.distributed as dist

    dev = torch.empty(nbytes, dtype=torch.uint8, device=b.device)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    inbox = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    peer = 1 - b.process_index
    legs = dict(d2h=[], gloo=[], h2d=[])
    for _ in range(reps + 1):
        for leg, fn in (
                ("d2h", lambda: host.copy_(dev, non_blocking=True)),
                ("gloo", lambda: [w.wait() for w in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, host, peer),
                     dist.P2POp(dist.irecv, inbox, peer)])]),
                ("h2d", lambda: dev.copy_(inbox, non_blocking=True))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            legs[leg].append((time.perf_counter() - t) * 1e3)
    return {f"{k}_ms": statistics.median(v[1:]) for k, v in legs.items()}


def child_18b(seed, out_dir):
    """Process p of 2 on the one card, 1 rank each, over a gloo group
    the process creates itself and bf.init adopts."""
    import datetime

    import torch.distributed as dist

    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.context import get_context
    from bluefog_tpu_torch.topology import StarGraph

    pid = int(os.environ["BLUEFOG_TPU_PROCESS_ID"])
    dist.init_process_group(
        "gloo", init_method=os.environ["BLUEFOG_TPU_COORDINATOR"], rank=pid,
        world_size=2, timeout=datetime.timedelta(seconds=PROCESS_TIMEOUT))
    bt.init(device="cuda:0")
    b = get_context().backend
    if not (b.wire == "gloo" and b._staged
            and (b.size, b.n_local, b.first_rank) == (2, 1, pid)):
        raise AssertionError(f"18b: {b}")
    got, spread = _process_compare(b, seed)
    torch.save(got, os.path.join(out_dir, f"b{pid}.pt"))
    _, spread_none = _process_compare(b, seed, comm_mode="none")
    rec = _timed_process_steps(b, seed, "18b")
    wire_bytes = sum(v[0].numel() * v.element_size()
                     for k, v in got.items() if k.startswith("param."))
    rec.update(backend=repr(b), spread_atc=spread, spread_none=spread_none,
               wire_bytes=wire_bytes, **_wire_split(b, wire_bytes))
    bt.shutdown()
    if not dist.is_initialized():
        raise AssertionError("18b: shutdown destroyed the adopted group")

    # the eager job over the same processes: 2 ranks each
    bt.init(size=4, device="cuda:0")
    x = bt.from_rank_values(lambda r: torch.full((64,), float(r),
                                                 device="cuda"))
    for _ in range(30):
        x = bt.neighbor_allreduce(x)
    err_nar = max(float(abs(v - 1.5).max()) for v in bt.to_rank_values(x))
    y = bt.from_rank_values(lambda r: torch.full((8,), float(r),
                                                 device="cuda"))
    bt.win_create(y, "w18")
    for _ in range(30):
        bt.win_put(y, "w18")
        y = bt.win_update("w18")
    err_win = max(float(abs(v - 1.5).max()) for v in bt.to_rank_values(y))
    bt.win_free("w18")
    bt.set_topology(StarGraph(4))
    z = bt.from_rank_values(lambda r: torch.full((2,), float(r),
                                                 device="cuda"))
    rag = bt.neighbor_allgather(z)
    want = {0: [1.0, 1.0, 2.0, 2.0, 3.0, 3.0], 1: [0.0, 0.0],
            2: [0.0, 0.0], 3: [0.0, 0.0]}
    for i, r in enumerate(range(2 * pid, 2 * pid + 2)):
        if rag[i].tolist() != want[r]:
            raise AssertionError(f"18b: ragged neighbor_allgather rank {r}: "
                                 f"{rag[i].tolist()}")
    if err_nar > 1e-5 or err_win > 1e-4:
        raise AssertionError(f"18b eager: consensus error {err_nar}, "
                             f"window gossip {err_win}")
    rec.update(eager_consensus_err=err_nar, eager_window_err=err_win)
    _report(rec)
    bt.shutdown()
    dist.destroy_process_group()


def child_nccl_two_ranks_one_card(seed, out_dir):
    """NCCL asked to put two ranks on one card."""
    import datetime

    import torch.distributed as dist

    pid = int(os.environ["BLUEFOG_TPU_PROCESS_ID"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=os.environ["BLUEFOG_TPU_COORDINATOR"], rank=pid,
        world_size=2, timeout=datetime.timedelta(seconds=60))
    t = torch.ones(1, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    _report(dict(nccl_two_ranks_one_card="accepted", sum=float(t)))
    dist.destroy_process_group()


CHILDREN = {"18a": child_18a, "18b": child_18b,
            "nccl_dup": child_nccl_two_ranks_one_card}


def _bfrun_children(name, nproc, out_dir, seed, extra_env=(),
                    timeout=PROCESS_TIMEOUT):
    """``python -m bluefog_tpu_torch.run -np nproc`` of this script's
    child ``name``, in a session of its own (a timeout kills the launcher
    and every process it started).  Returns (exit code, output, the
    children's PHASE18 records)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(nproc),
           "--coordinator", "file://" + os.path.join(out_dir,
                                                     f"{name}.store")]
    for kv in extra_env:
        cmd += ["--extra-env", kv]
    cmd += ["--", sys.executable, os.path.abspath(__file__), "--child",
            name, "--seed", str(seed), "--dir", out_dir]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=root, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"phase 18 {name}: the job ran past "
                             f"{timeout} s:\n{out[-4000:]}")
    recs = [json.loads(line.split("PHASE18 ", 1)[1])
            for line in out.splitlines() if "PHASE18 " in line]
    return proc.returncode, out, recs


def _check_against(got, want, rows, what, exact):
    """``got`` (a child's rows) against rows ``rows`` of the stacked
    reference: bit-equal when ``exact``, else phase 7's tolerance (5e-4
    of each leaf's largest entry plus 5e-7, losses 1e-5).  Returns
    (bit-equal, worst error over its tolerance)."""
    same, worst = True, 0.0
    for k, w in want.items():
        w = w[rows]
        g = got[k]
        if g.shape != w.shape:
            raise AssertionError(f"{what} {k}: shape {tuple(g.shape)}, "
                                 f"want {tuple(w.shape)}")
        same = same and torch.equal(g, w)
        tol = (1e-5 if k == "loss"
               else 5e-4 * float(w.abs().max()) + 5e-7)
        worst = max(worst, float((g.float() - w.float()).abs().max()) / tol)
    if exact and not same:
        raise AssertionError(f"{what}: not bit-equal to StackedBackend(2) "
                             f"(worst {worst:.3g} of phase 7's tolerance)")
    if worst > 1:
        raise AssertionError(f"{what}: {worst:.3g} of phase 7's tolerance")
    return same, worst


def phase_process(seed):
    """Phase 18: the process backend through the port's bfrun."""
    import shutil
    import tempfile

    import bluefog_tpu_torch as bt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="bf_phase18_")
    try:
        ref, ref_spread = _process_compare(
            bt.StackedBackend(2, device="cuda"), seed)
        torch.cuda.empty_cache()

        # 18a: NCCL at world size 1, 2 stacked ranks
        t0 = time.perf_counter()
        rc, out, recs = _bfrun_children(
            "18a", 1, out_dir, seed,
            extra_env=("BLUEFOG_TPU_RANKS_PER_PROCESS=2",))
        if rc != 0 or len(recs) != 1:
            raise AssertionError(f"phase 18a failed (exit {rc}):\n"
                                 f"{out[-6000:]}")
        a = recs[0]
        same, worst = _check_against(
            torch.load(os.path.join(out_dir, "a0.pt")), ref, slice(0, 2),
            "18a", exact=True)
        log(f"[process18a] bfrun -np 1, {a['backend']}, NCCL "
            f"{a['nccl']}: ResNet-50 batch {BATCH} a rank, atc over "
            f"ExponentialTwoGraph(2): {a['img_s']:.1f} img/s per card, step "
            f"{a['step_ms']:.2f} ms, combine {a['combine_ms']:.3f} ms, peak "
            f"{a['peak_gib']:.2f} GiB, K1 launches {a['launches']} = 20 x 2 "
            f"x {a['steps']} steps, {a['syncs']} host syncs a steady step; "
            f"after {PROCESS_STEPS} steps (batch {PROCESS_BATCH}, cuDNN "
            f"deterministic) bit-equal to StackedBackend(2) (consensus "
            f"distance {a['spread']:.6g}, stacked {ref_spread:.6g}); eager "
            f"{a['eager_ops']}; {time.perf_counter() - t0:.1f} s")

        # 18b: two processes on the one card, gloo through host buffers
        t0 = time.perf_counter()
        rc, out, recs = _bfrun_children("18b", 2, out_dir, seed)
        if rc != 0 or len(recs) != 2:
            raise AssertionError(f"phase 18b failed (exit {rc}):\n"
                                 f"{out[-6000:]}")
        for r in recs:
            p = r["backend"].split("process ")[1].split(" ")[0]
            same, worst = _check_against(
                torch.load(os.path.join(out_dir, f"b{p}.pt")), ref,
                slice(int(p), int(p) + 1), f"18b process {p}", exact=False)
            if r["launches"] != K1_LAUNCHES_PER_RANK_STEP * r["steps"]:
                raise AssertionError(f"18b process {p}: K1 {r['launches']}")
            if not r["spread_atc"] < r["spread_none"]:
                raise AssertionError(
                    f"18b: consensus distance atc {r['spread_atc']} not "
                    f"below none {r['spread_none']}")
            log(f"[process18b] process {p} of 2 on one card ({r['wire']}): "
                f"ResNet-50 batch {BATCH}, atc over ExponentialTwoGraph(2): "
                f"step {r['step_ms']:.2f} ms ({r['img_s']:.1f} img/s a "
                f"process), exchange {r['combine_ms']:.2f} ms, peak "
                f"{r['peak_gib']:.2f} GiB, K1 launches {r['launches']} = 20 "
                f"x {r['steps']} steps, {r['syncs']} host syncs a steady "
                f"step; after {PROCESS_STEPS} steps "
                f"{'bit-equal to' if same else 'within'} StackedBackend(2) "
                f"(worst {worst:.3g} of phase 7's tolerance); consensus "
                f"distance atc {r['spread_atc']:.6g} < none "
                f"{r['spread_none']:.6g}; the wire's legs for "
                f"{r['wire_bytes'] / 1e6:.1f} MB: device to host "
                f"{r['d2h_ms']:.2f} ms, gloo send and receive "
                f"{r['gloo_ms']:.2f} ms, host to device {r['h2d_ms']:.2f} "
                f"ms; eager: neighbor_allreduce "
                f"consensus err {r['eager_consensus_err']:.3g}, win_put "
                f"gossip {r['eager_window_err']:.3g}, ragged "
                f"neighbor_allgather exact")
        log(f"[process18b] {time.perf_counter() - t0:.1f} s")

        # NCCL asked for two ranks on one card (the reason 18b is gloo)
        rc, out, recs = _bfrun_children("nccl_dup", 2, out_dir, seed,
                                        timeout=120)
        lines = out.splitlines()
        said = ([ln for ln in lines if "Duplicate GPU" in ln]
                or [ln for ln in lines if "ncclInvalidUsage" in ln])
        log(f"[process18c] NCCL, two ranks on one card: exit {rc}; "
            + (f"refused: {said[0].strip()[:300]}" if said
               else f"{recs or out[-600:]}"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# ------------------------------------------------------------------ #
# phase 19: the rest of single-engine serving at Llama-3.1-8B's width
# ------------------------------------------------------------------ #
SERVE_CAP = 8        # slots of every phase-19 engine but 19e's
PREFIX_LEN = 1024    # 19c's shared prefix, four 256-token chunks
LOOKAHEAD = 4        # 19d


def _hf_state_dict(model, cfg):
    """The HF ``LlamaForCausalLM`` state dict of a port ``Llama``: the
    inverse of ``llama_params_from_hf``'s mapping (Linear weights
    ``[out, in]``, q/k rows in HF's half-split rotary order)."""
    sd = model.state_dict()
    hd = cfg.head_dim

    def permute(w, n_heads):   # HF's converter: interleaved -> half-split
        return (w.reshape(n_heads, hd // 2, 2, cfg.dim).transpose(1, 2)
                .reshape(n_heads * hd, cfg.dim).contiguous())

    out = {"model.embed_tokens.weight": sd["tok_embeddings.embedding"],
           "model.norm.weight": sd["norm.scale"],
           "lm_head.weight": sd["output.kernel"].T.contiguous()}
    for i in range(cfg.n_layers):
        p, h = f"layers.{i}.", f"model.layers.{i}."
        out[h + "input_layernorm.weight"] = sd[p + "attention_norm.scale"]
        out[h + "post_attention_layernorm.weight"] = sd[p + "ffn_norm.scale"]
        out[h + "self_attn.q_proj.weight"] = permute(
            sd[p + "attention.wq.kernel"].T, cfg.n_heads)
        out[h + "self_attn.k_proj.weight"] = permute(
            sd[p + "attention.wk.kernel"].T, cfg.n_kv_heads)
        for hf, port in (("self_attn.v_proj", "attention.wv"),
                         ("self_attn.o_proj", "attention.wo"),
                         ("mlp.gate_proj", "feed_forward.w1"),
                         ("mlp.up_proj", "feed_forward.w3"),
                         ("mlp.down_proj", "feed_forward.w2")):
            out[h + hf + ".weight"] = sd[p + port + ".kernel"].T.contiguous()
    return out


def _serve_reqs(rng, n, vocab, plen, new, temperature=0.0, prefix=None):
    from bluefog_tpu_torch.serving import Request

    reqs = []
    for i in range(n):
        p = rng.randint(0, vocab, (int(rng.randint(*plen)),)).astype(
            np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        t = temperature if i % 2 else 0.0
        reqs.append(Request(p, new, temperature=t, seed=2000 + i))
    return reqs


def _clones(reqs):
    from bluefog_tpu_torch.serving import Request

    return [Request(r.prompt.copy(), r.max_new_tokens, eos_id=r.eos_id,
                    temperature=r.temperature, seed=r.seed,
                    deadline=r.deadline) for r in reqs]


def _run_engine(eng, reqs, what, want, tally):
    """Submit ``reqs`` to ``eng`` and run it with the launch counts and
    the peak memory reset just before; the launches must be ``want(m)``
    ({kernel: count} from the summary ``m``) and nothing else, and are
    added to ``tally``.  Returns the summary, the wall seconds and the
    peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics.summary()
    for k, n in _expect_launches(what, want(m)).items():
        tally[k] = tally.get(k, 0) + n
    bad = [r.rid for r in reqs
           if r.state != "completed" or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"{what}: requests {bad} did not complete")
    if eng.nonfinite_logit_rows():
        raise AssertionError(f"{what}: non-finite logits")
    return m, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def _log_serve(what, m, wall, peak, extra=""):
    log(f"[serve19] {what}: {m['tokens_generated']} tokens in {wall:.2f} s "
        f"wall, tokens/s {m['tokens_per_sec']:.1f}, TTFT p50 "
        f"{m['ttft_p50'] * 1e3:.1f} ms, decode step p50 "
        f"{m['decode_step_ms_p50']:.2f} ms over {m['decode_steps']} steps, "
        f"{m['prefill_chunks']} prefill chunks, peak {peak:.2f} GiB{extra}")


# The most a serving path's logits may stray from the f32 reference, as a
# multiple of the plain bf16 forward's own distance to it (phase 19d/19e).
PATH_ERR_CEILING = 2.0


@torch.no_grad()
def _four_paths(model, ref, cfg, prompt, toks):
    """The logits after ``prompt ‖ toks`` four ways: one multi-token
    cached forward over the whole context (the arithmetic of a
    speculative verify and of a resumed request's re-prefill), the
    prompt's prefill followed by one single-token step (K4) per later
    token (the plain decode path's), the uncached bf16 forward (plain
    attention over the whole sequence, neither of the two paths under
    test), and the same uncached forward in f32 over the same bf16
    weights (``ref``, the reference)."""
    from bluefog_tpu_torch.models.generate import (decode_config,
                                                   decode_token_step,
                                                   init_cache,
                                                   prefill_cache)

    ctx = np.concatenate([prompt, np.asarray(toks, np.int32)])
    tokens = torch.from_numpy(ctx[None]).cuda()
    s = -(-ctx.size // 64) * 64
    dcfg = decode_config(cfg, s)
    cache = init_cache(dcfg, 1, s, device="cuda")
    whole = model(tokens, cache)[0, -1]
    cache = init_cache(dcfg, 1, s, device="cuda")
    if prompt.size > 1:
        prefill_cache(model, cache, torch.from_numpy(prompt[None, :-1]).cuda())
    for t in ctx[prompt.size - 1:]:
        last, cache = decode_token_step(
            model, cache, torch.tensor([[int(t)]], device="cuda"))
    del cache
    plain = model(tokens)[0, -1]
    f32 = ref.apply(dict(model.named_parameters()), tokens)[0, -1]
    return whole.float(), last[0].float(), plain.float(), f32.float()


def _f32_reference(cfg):
    """A module that runs ``cfg``'s model in f32 over parameters it is
    given (``Llama.apply``), each weight upcast as its layer runs.  It
    holds no weights of its own: its blocks are built on the meta device
    and the rest released, so it fits beside a model that fills most of
    the card."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import Block

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = bt.Llama(dataclasses.replace(f32, n_layers=1), device="cuda",
                   param_dtype=cfg.dtype)
    ref.state(release=True)
    ref.cfg = f32
    ref.layers = torch.nn.ModuleList(
        Block(f32, torch.device("meta"), cfg.dtype)
        for _ in range(cfg.n_layers))
    torch.cuda.empty_cache()
    return ref


def _explain_flips(model, cfg, pairs, what, paths=None):
    """Each pair is (request, reference tokens, tokens).  Where the two
    greedy (or sampled) streams first part, the flip must sit at a
    near-tie: the two tokens' margin in the multi-token path's logits
    (with the request's Gumbel draw added at temperature > 0) at most
    twice the sup-norm gap between that path's and the K4 path's logits
    at the same position (``_four_paths``), the most the two paths'
    rounding can move a margin there.  That gap is itself held to a
    ceiling that neither path sets: each path's sup-norm distance to the
    f32 forward over the same weights must stay within
    ``PATH_ERR_CEILING`` times the uncached bf16 forward's.  ``paths``,
    a dict the caller keeps across calls over the same ``model``, holds
    ``_four_paths``' logits by (prompt, tokens before the flip): two
    runs that part from one reference at the same place read them once.
    Returns the number of streams that differ."""
    from bluefog_tpu_torch.serving.engine import _gumbel

    n_diff = 0
    ref_model = None
    paths = {} if paths is None else paths
    for req, ref, got in pairs:
        ref, got = list(ref), list(got)
        j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 None)
        if j is None:
            continue
        n_diff += 1
        key = (req.prompt.tobytes(), tuple(ref[:j]))
        if key not in paths:
            if ref_model is None:
                ref_model = _f32_reference(cfg)
            paths[key] = _four_paths(model, ref_model, cfg, req.prompt,
                                     ref[:j])
        whole, k4, plain, f32 = paths[key]
        e_whole, e_k4, e_plain = ((x - f32).abs().max().item()
                                  for x in (whole, k4, plain))
        if max(e_whole, e_k4) > PATH_ERR_CEILING * e_plain:
            raise AssertionError(
                f"{what}: request {req.rid} at token {j}: distance to the "
                f"f32 forward {e_whole:.4g} (multi-token) and {e_k4:.4g} "
                f"(K4) against the uncached bf16 forward's {e_plain:.4g}: "
                f"beyond {PATH_ERR_CEILING} x")
        gap = (whole - k4).abs().max().item()
        a, b = ref[j], got[j]
        margin = (whole[a] - whole[b]).item()
        bound = 2 * gap
        if req.temperature > 0.0:
            g = _gumbel(req, j, 0, whole.numel(), torch.device("cuda"))
            margin = margin / req.temperature + (g[a] - g[b]).item()
            bound /= req.temperature
        ok = abs(margin) <= bound
        log(f"[serve19] {what}: request {req.rid} (T={req.temperature}) "
            f"parts at token {j} of {len(ref)}: {a} against {b}, margin "
            f"{abs(margin):.4g} {'<=' if ok else '>'} bound {bound:.4g} "
            f"(2 x the K4-path / multi-token-path logit gap {gap:.4g}); "
            f"distance to the f32 forward: multi-token {e_whole:.4g}, K4 "
            f"{e_k4:.4g}, uncached bf16 {e_plain:.4g}")
        if not ok:
            raise AssertionError(f"{what}: request {req.rid} differs at "
                                 f"token {j} beyond the rounding bound")
    del ref_model
    torch.cuda.empty_cache()
    return n_diff


def _device_ms_per_step(eng, reqs, steps=5):
    """torch.profiler over ``steps`` engine steps once every request of
    ``reqs`` decodes: the device's busy ms and the wall ms a step."""
    from torch.profiler import ProfilerActivity, profile

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
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = sum(e.self_device_time_total for e in _device_kernels(prof))
    eng.run()
    return busy / steps / 1e3, wall


def _phase19_import(model, cfg):
    """19a: the model through an HF state dict and back, bit for bit."""
    from types import SimpleNamespace

    from bluefog_tpu_torch.interop import (llama_config_from_hf,
                                           llama_params_from_hf)
    from bluefog_tpu_torch.models.generate import decode_config, init_cache

    t0 = time.perf_counter()
    hf = _hf_state_dict(model, cfg)
    hf_cfg = SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.ffn_dim,
        max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps, attention_bias=False, mlp_bias=False,
        rope_scaling={"rope_type": "llama3",
                      "factor": cfg.rope_scaling_factor,
                      "low_freq_factor": cfg.rope_scaling_low_freq_factor,
                      "high_freq_factor": cfg.rope_scaling_high_freq_factor,
                      "original_max_position_embeddings":
                          cfg.rope_scaling_original_max_len})
    icfg = llama_config_from_hf(hf_cfg)
    if icfg != cfg:
        raise AssertionError(f"imported config {icfg} != {cfg}")
    state = llama_params_from_hf(hf, icfg, device="cuda")
    hf_gib = sum(t.numel() * t.element_size() for t in hf.values()) / 2 ** 30
    del hf
    own = model.state_dict()
    if set(state) != set(own) or not all(torch.equal(state[k], own[k])
                                         for k in own):
        raise AssertionError("19a: imported weights differ from the source")
    tokens = torch.from_numpy(np.arange(7, 7 + 40, dtype=np.int32)[None]
                              ).cuda()
    dcfg = decode_config(cfg, 64)
    want = model(tokens, init_cache(dcfg, 1, 64, device="cuda"),
                 all_logits=True)
    got = torch.func.functional_call(
        model, state, (tokens, init_cache(dcfg, 1, 64, device="cuda")),
        {"all_logits": True})
    if not torch.equal(got, want):
        raise AssertionError("19a: imported logits differ from the source")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, own
    torch.cuda.empty_cache()
    log(f"[serve19a] HF import: {len(model.state_dict())} tensors through an"
        f" HF state dict of {hf_gib:.2f} GiB and llama_params_from_hf "
        f"(SimpleNamespace config) bit-equal to the source; logits [1, 40, "
        f"{cfg.vocab_size}] bit-equal; {time.perf_counter() - t0:.1f} s, "
        f"peak {peak:.2f} GiB")


def _phase19_quant(model, cfg, rng, tally):
    """19b: quantize_llama_params on the card; serve weight-only int8 and
    w8a8 with the int8 cache at max_len 1024."""
    import bluefog_tpu_torch.models.llama as tl
    from bluefog_tpu_torch.models.generate import (build_model,
                                                   decode_config, init_cache)
    from bluefog_tpu_torch.models.quant import quantize_llama_params
    from bluefog_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    qstate = quantize_llama_params(model)
    torch.cuda.synchronize()
    q_bytes = sum(t.numel() for t in qstate.values()
                  if t.dtype == torch.int8)
    scale_bytes = sum(t.numel() * 4 for k, t in qstate.items()
                      if k.endswith(".scale") and "norm" not in k)
    full_bytes = sum(t.numel() * t.element_size()
                     for k, t in model.state_dict().items()
                     if k.endswith(".kernel"))
    # why QuantDense keeps its kernel column-major: cuBLASLt's int8 GEMM
    # at w2's shape (a decode step's 8 rows, padded past 16) both ways
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    w2 = qstate["layers.0.feed_forward.w2.kernel"]
    x8 = torch.randint(-127, 128, (SERVE_CAP, w2.shape[0]), device="cuda",
                       dtype=torch.int8)
    col, row = w2.t().contiguous().t(), w2.contiguous()
    if not torch.equal(tl.int8_matmul(x8, col), tl.int8_matmul(x8, row)):
        raise AssertionError("19b: int8_matmul differs by kernel layout")
    col_ms = time_ms(lambda: tl.int8_matmul(x8, col), flush)
    row_ms = time_ms(lambda: tl.int8_matmul(x8, row), flush)
    del col, row, flush
    log(f"[serve19b] int8_matmul at w2's shape ({SERVE_CAP} rows, "
        f"{tuple(w2.shape)}): column-major kernel {col_ms:.4f} ms, "
        f"row-major {row_ms:.4f} ms")
    log(f"[serve19b] quantize_llama_params on the card in "
        f"{time.perf_counter() - t0:.2f} s: int8 kernels {q_bytes / 1e9:.3f} "
        f"GB + scales {scale_bytes / 1e6:.2f} MB, against "
        f"{full_bytes / 1e9:.3f} GB of bf16 projections and f32 head")
    reqs = _serve_reqs(rng, 8, cfg.vocab_size, (16, 700), 8)
    # the logits criterion of tests/test_quant.py on one prompt
    probe = torch.from_numpy(reqs[0].prompt[None]).cuda()
    s = 1024
    ref_logits = model(probe, init_cache(decode_config(cfg, s), 1, s,
                                         device="cuda"))[0, -1].float()
    bf16 = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=s,
                         prefill_chunk=256)
    base = _clones(reqs)
    m, wall, peak = _run_engine(
        bf16, base, "19b bf16",
        lambda m: {"decode_attention": cfg.n_layers * m["decode_steps"]},
        tally)
    dev, wall_step = _device_ms_per_step(
        bf16, _serve_reqs(rng, 8, cfg.vocab_size, (16, 64), 16))
    _log_serve("19b bf16 weights (yardstick)", m, wall, peak,
               f"; profiled decode step: device {dev:.2f} ms, wall "
               f"{wall_step:.2f} ms ({100 * dev / wall_step:.1f}% busy)")
    del bf16
    calls = {"n": 0}
    real = tl._cached_attention_int8

    def counted(*a):
        calls["n"] += 1
        return real(*a)

    for mode, kv, counter, tol in (("int8", "none", "decode_attention", 0.15),
                                   ("w8a8", "int8", "decode_attention_int8",
                                    0.2)):
        dcfg = decode_config(cfg, s, kv_quant=kv, weight_quant=mode)
        qmodel = build_model(qstate, dcfg, torch.device("cuda"))
        got = qmodel(probe, init_cache(dcfg, 1, s, kv_quant=kv,
                                       device="cuda"))[0, -1].float()
        err = (got - ref_logits).abs().max().item()
        bound = tol * (1.0 + ref_logits.abs().max().item())
        if err >= bound:
            raise AssertionError(f"19b {mode}: logits off by {err}")
        eng = ServingEngine(qmodel, cfg, capacity=SERVE_CAP, max_len=s,
                            prefill_chunk=256, kv_quant=kv,
                            weight_quant=mode)
        run = _clones(reqs)
        calls["n"] = 0
        tl._cached_attention_int8 = counted
        try:
            m, wall, peak = _run_engine(
                eng, run, f"19b {mode}",
                lambda m: {counter: cfg.n_layers * m["decode_steps"]}, tally)
        finally:
            tl._cached_attention_int8 = real
        want_calls = cfg.n_layers * m["prefill_chunks"] if mode == "w8a8" \
            else 0
        if calls["n"] != want_calls:
            raise AssertionError(f"19b {mode}: integer attention ran "
                                 f"{calls['n']} times, want {want_calls}")
        dev, wall_step = _device_ms_per_step(
            eng, _serve_reqs(rng, 8, cfg.vocab_size, (16, 64), 16))
        first = sum(a.tokens[0] == b.tokens[0] for a, b in zip(base, run))
        agree = np.mean([np.mean(np.asarray(a.tokens) == np.asarray(b.tokens))
                         for a, b in zip(base, run)])
        _log_serve(f"19b weight_quant={mode} kv_quant={kv}", m, wall, peak,
                   f"; probe logits max|err| {err:.4g} < {bound:.4g}; first "
                   f"greedy tokens equal to bf16's {first}/8, all tokens "
                   f"{agree:.3f}; integer attention on {calls['n']} "
                   f"(layer, prefill chunk) pairs; {counter} launches "
                   f"{cfg.n_layers * m['decode_steps']}; profiled decode "
                   f"step: device {dev:.2f} ms, wall {wall_step:.2f} ms "
                   f"({100 * dev / wall_step:.1f}% busy)")
        # the first tokens differ from bf16's only at near-ties of the
        # quantization's size (tests/test_quant.py demands them equal at
        # its tiny scale)
        for a, b in zip(base, run):
            if a.tokens[0] != b.tokens[0]:
                ql = qmodel(torch.from_numpy(a.prompt[None]).cuda(),
                            init_cache(dcfg, 1, s, kv_quant=kv,
                                       device="cuda"))[0, -1].float()
                fl = model(torch.from_numpy(a.prompt[None]).cuda(),
                           init_cache(decode_config(cfg, s), 1, s,
                                      device="cuda"))[0, -1].float()
                gap = (ql - fl).abs().max().item()
                margin = abs((fl[a.tokens[0]] - fl[b.tokens[0]]).item())
                log(f"[serve19b] {mode}: request {a.rid}'s first token "
                    f"{b.tokens[0]} against bf16's {a.tokens[0]}: margin "
                    f"{margin:.4g}, 2 x quantized-logit gap {2 * gap:.4g}")
                if margin > 2 * gap:
                    raise AssertionError(f"19b {mode}: first token flip "
                                         "beyond the quantization's gap")
        del eng, qmodel
        torch.cuda.empty_cache()
    return q_bytes


def _phase19_prefix(model, cfg, rng, tally):
    """19c: 8 requests sharing a 1024-token prefix, two waves through
    one prefix cache, the second against a cold engine."""
    from bluefog_tpu_torch.serving import PrefixCache, ServingEngine

    prefix = rng.randint(0, cfg.vocab_size, (PREFIX_LEN,)).astype(np.int32)
    waves = [_serve_reqs(rng, 8, cfg.vocab_size, (16, 200), 8,
                         prefix=prefix) for _ in range(2)]
    cache = PrefixCache(256, 4 << 30)
    warm = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                         prefill_chunk=256, prefix_cache=cache)
    def k4(m):
        return {"decode_attention": cfg.n_layers * m["decode_steps"]}

    m1, wall1, _ = _run_engine(warm, waves[0], "19c wave 1", k4, tally)
    restored1 = m1["prefix_chunks_restored"]
    warm = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                         prefill_chunk=256, prefix_cache=cache)
    m2, wall2, peak2 = _run_engine(warm, waves[1], "19c wave 2", k4, tally)
    cold = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                         prefill_chunk=256)
    ref = _clones(waves[1])
    mc, wallc, peakc = _run_engine(cold, ref, "19c cold", k4, tally)
    if m2["prefix_chunks_restored"] != 8 * PREFIX_LEN // 256:
        raise AssertionError(f"19c: wave 2 restored "
                             f"{m2['prefix_chunks_restored']} chunks")
    for a, b in zip(waves[1], ref):
        if a.tokens != b.tokens:
            raise AssertionError(f"19c: request {a.rid}'s stream differs "
                                 "from the cold engine's")
    _log_serve("19c wave 1 (cold cache)", m1, wall1, peak2,
               f"; {restored1} chunks restored")
    _log_serve("19c wave 2 (prefix cache)", m2, wall2, peak2,
               f"; {m2['prefix_chunks_restored']} chunks restored, "
               f"{len(cache)} entries, {cache.nbytes / 2 ** 30:.2f} GiB")
    _log_serve("19c wave 2 cold (no cache)", mc, wallc, peakc,
               "; greedy streams bit-equal to the cached engine's")
    log(f"[serve19c] TTFT p50 with the cache {m2['ttft_p50'] * 1e3:.1f} ms,"
        f" without {mc['ttft_p50'] * 1e3:.1f} ms")


def _phase19_spec(model, cfg, seed, rng, tally):
    """19d: speculative decoding, lookahead 4, the target as its own
    draft and a 2-layer draft at 8B width from another seed, against
    plain greedy."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.serving import ServingEngine, SpeculativeConfig

    reqs = _serve_reqs(rng, 8, cfg.vocab_size, (16, 500), 12)
    plain = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                          prefill_chunk=256)
    base = _clones(reqs)
    m, wall, peak = _run_engine(
        plain, base, "19d plain",
        lambda m: {"decode_attention": cfg.n_layers * m["decode_steps"]},
        tally)
    _log_serve("19d plain greedy (yardstick)", m, wall, peak)
    del plain
    dcfg = dataclasses.replace(cfg, n_layers=2)
    small = bt.Llama(dcfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed + 1))
    paths = {}
    for name, draft, draft_cfg in (("self-draft", model, cfg),
                                   ("2-layer draft", small, dcfg)):
        spec = SpeculativeConfig(draft, draft_cfg, lookahead=LOOKAHEAD)
        eng = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                            prefill_chunk=256, speculative=spec)
        run = _clones(reqs)
        m, wall, peak = _run_engine(
            eng, run, f"19d {name}",
            lambda m: {"decode_attention": draft_cfg.n_layers
                       * (LOOKAHEAD + 1) * m["spec_steps"]}, tally)
        n_diff = _explain_flips(model, cfg, [(r, b.tokens, r.tokens)
                                             for r, b in zip(run, base)],
                                f"19d {name}", paths)
        _log_serve(f"19d {name}, lookahead {LOOKAHEAD}", m, wall, peak,
                   f"; accepted {m['accepted_per_step']:.3f} tokens a step "
                   f"over {m['spec_steps']} steps; K4 launches "
                   f"{draft_cfg.n_layers * (LOOKAHEAD + 1) * m['spec_steps']}"
                   f" = draft layers x {LOOKAHEAD + 1} x steps; "
                   f"{n_diff}/8 streams differ from plain greedy")
        if m["accepted_per_step"] <= 1.0 and draft is model:
            raise AssertionError("19d: the self-draft accepted nothing")
        del eng
        torch.cuda.empty_cache()
    del small, paths
    torch.cuda.empty_cache()


def _phase19_failover(model, cfg, rng, tally):
    """19e: drain with handoff, then a replica killed mid-run and its
    requests failed over, against an unfaulted run."""
    from bluefog_tpu_torch.resilience import ServingFaultPlan
    from bluefog_tpu_torch.serving import (FaultyReplica, PrefixCache,
                                           ServingEngine, failover_stranded)

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    cache = PrefixCache(256, 4 << 30)

    def engine(prefix):
        return ServingEngine(model, cfg, capacity=4, max_len=2048,
                             prefill_chunk=256, clock=clock,
                             prefix_cache=prefix)

    reqs = _serve_reqs(rng, 8, cfg.vocab_size, (300, 900), 32,
                       temperature=0.8)
    base = _clones(reqs)
    _run_engine(engine(False), base, "19e unfaulted",
                lambda m: {"decode_attention":
                           cfg.n_layers * m["decode_steps"]}, tally)
    torch.cuda.synchronize()
    _reset_counts()
    e0, e1 = engine(cache), engine(cache)
    live = [e0.submit(r) for r in _clones(reqs)]
    for _ in range(8):
        clock.t += 0.01
        e0.step()
    states = sorted(r.state for r in live)
    drained = e0.drain(handoff=e1.submit)
    steps = [e0.metrics.summary()["decode_steps"]]
    del e0
    rep = FaultyReplica(e1, ServingFaultPlan.replica_death(1, 0, step=12), 0)
    while rep.step():
        clock.t += 0.01
    late = next(r for r in live if r.state == "decode")
    late.deadline = clock.t + 1.0      # passes while the replica is dead
    clock.t += 5.0
    e2 = engine(cache)
    moved, expired = failover_stranded(rep, e2.submit)
    while e2.step():
        clock.t += 0.01
    torch.cuda.synchronize()
    steps += [e.metrics.summary()["decode_steps"] for e in (e1, e2)]
    k4 = _expect_launches("19e drain and failover", {
        "decode_attention": cfg.n_layers * sum(steps)})["decode_attention"]
    tally["decode_attention"] += k4
    if [r.rid for r in expired] != [late.rid] or late.state != "expired":
        raise AssertionError(f"19e: expired {[r.rid for r in expired]}, "
                             f"want [{late.rid}]")
    done = [r for r in live if r is not late]
    if any(r.state != "completed" or len(r.tokens) != r.max_new_tokens
           for r in done):
        raise AssertionError("19e: a moved request did not complete")
    by_rid = {r.rid: b for r, b in zip(live, base)}
    n_diff = _explain_flips(model, cfg, [(r, by_rid[r.rid].tokens, r.tokens)
                                         for r in done], "19e failover")
    restored = (e1.metrics.summary()["prefix_chunks_restored"]
                + e2.metrics.summary()["prefix_chunks_restored"])
    log(f"[serve19e] states before the drain {states}; drain "
        f"{drained}; the replica died after {rep.steps} steps holding "
        f"{len(moved) + len(expired)} requests: {len(moved)} failed over, "
        f"{len(expired)} expired; n_failovers e0 "
        f"{drained['handed_off']} + e1 "
        f"{e1.metrics.summary()['n_failovers']}; prefix chunks restored "
        f"{restored}; {n_diff}/{len(done)} resumed streams differ from the "
        f"unfaulted run (4 sampled at T=0.8); decode_attention launches "
        f"{k4} = {cfg.n_layers} x {sum(steps)} decode steps {steps}")


def phase_serving_rest(seed):
    """Phase 19: HF import, int8 and w8a8 weights, the prefix cache,
    speculative decoding, drain and failover at Llama-3.1-8B's full
    width and depth."""
    import bluefog_tpu_torch as bt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3")
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    rng = np.random.RandomState(seed + 19)
    _phase19_import(model, cfg)
    tally = {"decode_attention": 0, "decode_attention_int8": 0}
    _phase19_quant(model, cfg, rng, tally)
    _phase19_prefix(model, cfg, rng, tally)
    _phase19_spec(model, cfg, seed, rng, tally)
    _phase19_failover(model, cfg, rng, tally)
    del model
    torch.cuda.empty_cache()
    log(f"[serve19] phase 19 in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K4 "
        f"launches {tally}")
    return tally


# ------------------------------------------------------------------ #
# phase 20: the serving fleet at Llama-3.1-8B's width and depth
# ------------------------------------------------------------------ #
FLEET = 3            # replicas on the one card
FLEET_REQS = 12      # 20a's requests, one arrival a round
STALE_S = 0.5        # 20b's staleness window, harness seconds
DEATH_STEP = 20      # 20b: replica 1 dies at its 20th step


class _HarnessClock:
    """The fleet's one clock, seconds since the harness started: every
    engine's and the router's."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self):
        return time.perf_counter() - self.t0


class _RoundClock(_HarnessClock):
    """20b's clock: the harness seconds at the start of the current
    round (``tick``).  On this card the replicas step one after another
    on one host thread; in a fleet they step side by side.  Every step
    of a round, and the poll after them, read the round's start, so a
    live replica's heartbeat is never older than the round, and a dead
    one's ages by the wall time of the rounds since its last step."""

    def __init__(self):
        super().__init__()
        self.t = 0.0

    def tick(self):
        self.t = time.perf_counter() - self.t0

    def __call__(self):
        return self.t


def _fleet_reqs(rng, vocab):
    """20a's requests: prompts of 16-1500 tokens (4 of them a shared
    1024-token prefix and a 16-476-token tail), 32-128 new tokens, half
    greedy and half at temperature 0.8."""
    from bluefog_tpu_torch.serving import Request

    prefix = rng.randint(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    reqs = []
    for i in range(FLEET_REQS):
        if i % 3 == 0:
            p = np.concatenate([prefix, rng.randint(
                0, vocab, (int(rng.randint(16, 477)),)).astype(np.int32)])
        else:
            p = rng.randint(0, vocab, (int(rng.randint(16, 1501)),)).astype(
                np.int32)
        reqs.append(Request(p, int(rng.randint(32, 129)),
                            temperature=0.8 if i % 2 else 0.0,
                            seed=3000 + i))
    return reqs


def _fleet_engines(model, cfg, clock, cache, n=FLEET):
    """``n`` replicas over one model's weights, each with its own engine,
    metrics registry and scheduler, all sharing ``cache``."""
    from bluefog_tpu_torch.observe.registry import MetricsRegistry
    from bluefog_tpu_torch.serving import ServingEngine

    return [ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                          prefill_chunk=256, clock=clock, prefix_cache=cache,
                          registry=MetricsRegistry()) for _ in range(n)]


def _drive_fleet(replicas, router, reqs, clock, twin=None, on_round=None,
                 max_rounds=5000):
    """Arrivals through ``router.submit``, one a round; each round steps
    every live replica, then polls the router once (and ``twin``, a
    second router over the same registries, which must rank alike).
    A round clock ticks at each round's start.  ``on_round(snap)`` runs
    after each poll.  Returns (placements, rounds, wall seconds)."""
    placed, rounds = [], 0
    t0 = time.perf_counter()
    tick = getattr(clock, "tick", lambda: None)
    tick()
    snap = router.poll()
    while rounds < max_rounds:
        tick()
        if len(placed) < len(reqs):
            i, _ = router.submit(reqs[len(placed)], snapshot=snap)
            placed.append(i)
        busy = [rep.step() for rep in replicas]
        rounds += 1
        snap = router.poll()
        if twin is not None:
            other = twin.poll()
            if other.order != snap.order or not np.array_equal(
                    other.scores, snap.scores):
                raise AssertionError(f"20a: two routers over the same "
                                     f"registries rank {snap.order} and "
                                     f"{other.order}")
        if on_round is not None:
            on_round(snap)
        if len(placed) == len(reqs) and all(r.done for r in reqs) \
                and not any(busy):
            break
    else:
        raise AssertionError(f"fleet still busy after {max_rounds} rounds")
    torch.cuda.synchronize()
    return placed, rounds, time.perf_counter() - t0


def _fleet_summary(engines, reqs, wall):
    """Fleet tokens/s over the drive's wall, TTFT p50/p99 over every
    replica's requests, decode-step ms p50 and steps per replica."""
    from bluefog_tpu_torch.serving import percentile

    ms = [e.metrics.summary() for e in engines]
    ttft = [t for e in engines for t in e.metrics.ttfts()]
    tokens = sum(len(r.tokens) for r in reqs)
    return dict(tokens=tokens, tokens_per_sec=tokens / wall,
                ttft_p50=percentile(ttft, 50), ttft_p99=percentile(ttft, 99),
                step_ms=[round(m["decode_step_ms_p50"], 2) for m in ms],
                decode_steps=[m["decode_steps"] for m in ms],
                restored=sum(m["prefix_chunks_restored"] for m in ms))


def _check_done(reqs, what, engines):
    bad = [r.rid for r in reqs
           if r.state != "completed" or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"{what}: requests {bad} did not complete")
    if any(e.nonfinite_logit_rows() for e in engines):
        raise AssertionError(f"{what}: non-finite logits")


def _phase20_route(model, cfg, rng, tally):
    """20a (three replicas behind FleetRouter, and the same requests on
    one replica) and 20c (saturation, publication, export)."""
    from bluefog_tpu_torch import observe
    from bluefog_tpu_torch.serving import (FleetRouter, FleetSaturated,
                                           PrefixCache, Request)

    reqs = _fleet_reqs(rng, cfg.vocab_size)
    clock = _HarnessClock()
    engines = _fleet_engines(model, cfg, clock, PrefixCache(256, 4 << 30))
    router = FleetRouter(engines)
    twin = FleetRouter(engines)
    run = _clones(reqs)
    torch.cuda.synchronize()
    _reset_counts()
    placed, rounds, wall = _drive_fleet(engines, router, run, clock, twin)
    s = _fleet_summary(engines, run, wall)
    k4 = _expect_launches("20a fleet", {
        "decode_attention": cfg.n_layers * sum(s["decode_steps"])})
    tally["decode_attention"] += k4["decode_attention"]
    _check_done(run, "20a", engines)
    log(f"[fleet20a] {FLEET} replicas of Llama-3.1-8B on one card behind "
        f"FleetRouter: {len(run)} requests, placements per replica "
        f"{[placed.count(i) for i in range(FLEET)]} in {rounds} rounds; "
        f"{s['tokens']} tokens in {wall:.2f} s: fleet {s['tokens_per_sec']:.1f}"
        f" tokens/s, TTFT p50 {s['ttft_p50'] * 1e3:.1f} ms, p99 "
        f"{s['ttft_p99'] * 1e3:.1f} ms; decode step ms p50 per replica "
        f"{s['step_ms']} over {s['decode_steps']} steps; {s['restored']} "
        f"prefix chunks restored; a second router ranked every round alike;"
        f" K4 launches {k4['decode_attention']} = {cfg.n_layers} x "
        f"{sum(s['decode_steps'])} decode steps")

    # the same requests on one replica, one arrival a step
    one = _fleet_engines(model, cfg, _HarnessClock(), PrefixCache(
        256, 4 << 30), n=1)
    solo = _clones(reqs)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in solo:
        one[0].submit(r)
        one[0].step()
    one[0].run()
    torch.cuda.synchronize()
    s1 = _fleet_summary(one, solo, time.perf_counter() - t0)
    k4 = _expect_launches("20a one replica", {
        "decode_attention": cfg.n_layers * s1["decode_steps"][0]})
    tally["decode_attention"] += k4["decode_attention"]
    _check_done(solo, "20a one replica", one)
    log(f"[fleet20a] the same {len(solo)} requests on one replica: "
        f"{s1['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
        f"{s1['ttft_p50'] * 1e3:.1f} ms, p99 {s1['ttft_p99'] * 1e3:.1f} ms, "
        f"decode step ms p50 {s1['step_ms'][0]}; fleet / one replica "
        f"{s['tokens_per_sec'] / s1['tokens_per_sec']:.3f} (the replicas "
        f"share one card's SMs and one host thread: not a scaling number)")
    del one

    # 20c: a burst against 2-deep queues saturates the fleet
    for e in engines:
        e.scheduler.max_queue = 2
    burst = [Request(np.arange(16 + i, dtype=np.int32) % cfg.vocab_size, 8)
             for i in range(2 * FLEET + 1)]
    for r in burst[:-1]:
        router.submit(r)
    try:
        router.submit(burst[-1])
    except FleetSaturated as exc:
        sat = exc
    else:
        raise AssertionError("20c: the burst did not saturate the fleet")
    if sat.queue_depths[-FLEET:] != [2] * FLEET or len(sat.causes) != FLEET:
        raise AssertionError(f"20c: FleetSaturated depths "
                             f"{sat.queue_depths}, causes {sat.causes}")
    for e in engines:
        e.scheduler.max_queue = 64
    _reset_counts()
    steps0 = sum(e.metrics.n_decode_steps for e in engines)
    while any([e.step() for e in engines]):
        router.poll()
    steps = sum(e.metrics.n_decode_steps for e in engines) - steps0
    k4 = _expect_launches("20c burst", {"decode_attention":
                                        cfg.n_layers * steps})
    tally["decode_attention"] += k4["decode_attention"]
    _check_done(burst[:-1], "20c burst", engines)
    snap = router.publish()
    text = observe.prometheus_text()
    want = ("bf_fleet_serving_occupancy", "bf_fleet_serving_queue_depth",
            "bf_fleet_serving_ttft_p50", "bf_fleet_serving_best_replica",
            "bf_replica_suspect")
    missing = [w for w in want if w not in text]
    if missing:
        raise AssertionError(f"20c: prometheus_text lacks {missing}")
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        dump = observe.snapshot(d)
        files = sorted(dump["files"])
        sizes = {f: os.path.getsize(dump["files"][f]) for f in files}
    if files != ["events.jsonl", "metrics.prom", "trace.json"]:
        raise AssertionError(f"20c: snapshot wrote {files}")
    log(f"[fleet20c] a burst of {len(burst)} against {FLEET} queues of 2: "
        f"FleetSaturated({sat.queue_depths[-FLEET:]}) with "
        f"{len(sat.causes)} causes; the {len(burst) - 1} accepted completed"
        f" (K4 {k4['decode_attention']}); router.publish: best replica "
        f"{snap.order[0]}, gossip {snap.rounds} rounds, spread "
        f"{snap.spread:.3g}; prometheus_text carries {len(want)} fleet "
        f"families ({len(text)} bytes); snapshot wrote {sizes}")
    del engines, router, twin
    torch.cuda.empty_cache()
    return reqs, run


def _phase20_failover(model, cfg, reqs, base, tally):
    """20b: 20a's requests with replica 1 dead at its 20th step: the
    staleness guard excises it, failover_stranded moves its requests
    through router.submit, and every stream completes, each that parts
    from 20a's at a near-tie."""
    from bluefog_tpu_torch.resilience import ServingFaultPlan
    from bluefog_tpu_torch.serving import (FaultyReplica, FleetRouter,
                                           PrefixCache, failover_stranded)

    clock = _RoundClock()
    cache = PrefixCache(256, 4 << 30)
    engines = _fleet_engines(model, cfg, clock, cache)
    plan = ServingFaultPlan.replica_death(FLEET, 1, step=DEATH_STEP)
    reps = [FaultyReplica(e, plan, i) for i, e in enumerate(engines)]
    router = FleetRouter(reps, stale_after=STALE_S)
    run = _clones(reqs)
    st = dict(death=None, polls=0, excised=None, moved=[], resumed={},
              prev=None, window=None)

    def on_round(snap):
        now = clock()
        if any(snap.suspect[i] for i in range(FLEET) if i != 1):
            raise AssertionError(f"20b: a live replica went suspect "
                                 f"(ages {snap.ages})")
        if st["death"] is None and reps[1].dead:
            st["death"] = now
        if st["death"] is not None and st["excised"] is None:
            st["polls"] += 1
            if snap.suspect[1]:
                st["excised"] = now
                st["window"] = (st["prev"], snap.ages[1])
                n0 = {r.rid: len(r.tokens) for r in
                      list(engines[1]._running.values())}
                moved, expired = failover_stranded(reps[1], router.submit)
                if expired:
                    raise AssertionError(f"20b: {len(expired)} expired")
                st["moved"] = [(r, n0.get(r.rid, len(r.tokens)))
                               for r in moved]
        for r, n in st["moved"]:
            if r.rid not in st["resumed"] and len(r.tokens) > n:
                st["resumed"][r.rid] = now
        st["prev"] = snap.ages[1]

    torch.cuda.synchronize()
    _reset_counts()
    placed, rounds, wall = _drive_fleet(reps, router, run, clock,
                                        on_round=on_round)
    s = _fleet_summary(engines, run, wall)
    k4 = _expect_launches("20b failover", {
        "decode_attention": cfg.n_layers * sum(s["decode_steps"])})
    tally["decode_attention"] += k4["decode_attention"]
    if st["excised"] is None or not st["moved"]:
        raise AssertionError("20b: replica 1 was not excised with requests")
    age = st["excised"] - engines[1].metrics.last_step_ts
    prev, seen = st["window"]
    if not (seen == age > STALE_S >= prev):
        raise AssertionError(f"20b: excised {age:.3f} s after its last "
                             f"heartbeat (the router saw {seen:.3f} s, "
                             f"{prev:.3f} s a poll before; stale_after "
                             f"{STALE_S}): not the first poll past it")
    _check_done(run, "20b", engines)
    resumed = max(st["resumed"].values()) if st["resumed"] else None
    if resumed is None or len(st["resumed"]) != len(st["moved"]):
        raise AssertionError("20b: a moved request emitted no new token")
    n_diff = _explain_flips(model, cfg, [(r, b.tokens, r.tokens)
                                         for r, b in zip(run, base)],
                            "20b failover")
    log(f"[fleet20b] replica 1 died at its step {DEATH_STEP}; excised "
        f"after {st['polls']} polls, {age:.3f} s after its last heartbeat "
        f"(stale_after {STALE_S} s); {len(st['moved'])} requests moved "
        f"through router.submit; death to the last moved request's first "
        f"new token {resumed - st['death']:.3f} s; {s['restored']} prefix "
        f"chunks restored; placements {[placed.count(i) for i in range(FLEET)]};"
        f" every request completed, {n_diff}/{len(run)} streams part from "
        f"20a's; fleet {s['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
        f"{s['ttft_p50'] * 1e3:.1f} ms, p99 {s['ttft_p99'] * 1e3:.1f} ms; "
        f"K4 launches {k4['decode_attention']} = {cfg.n_layers} x "
        f"{sum(s['decode_steps'])}")
    del engines, reps, router
    torch.cuda.empty_cache()


def _log_profiles(profs, what):
    for name, p in profs.items():
        top = sorted(p.op_breakdown.items(), key=lambda kv: -kv[1]["ms"])[:6]
        log(f"[fleet20d] {what} {name}: device {p.device_seconds * 1e3:.3f} "
            f"ms in a {p.step_seconds * 1e3:.2f} ms run, {p.flops / 1e9:.2f} "
            f"GFLOP, MFU {p.mfu(p.device_seconds):.4f} of device time; "
            + "; ".join(f"{k[:48]} {v['ms']:.3f} ms x{v['count']}"
                        for k, v in top))


def _phase20_profile(model, cfg, rng, tally):
    """20d: profile() on a live replica mid-run, plain and self-drafting
    speculative; the later streams equal those of a run without it."""
    from bluefog_tpu_torch.serving import ServingEngine, SpeculativeConfig

    reqs = _serve_reqs(rng, 8, cfg.vocab_size, (16, 500), 12,
                       temperature=0.8)
    spec = SpeculativeConfig(model, cfg, lookahead=LOOKAHEAD)
    for what, kw in (("plain", {}), ("self-draft", {"speculative": spec})):
        streams, profs, steps = [], None, 0
        torch.cuda.synchronize()
        _reset_counts()
        for call in (False, True):
            eng = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=2048,
                                prefill_chunk=256, **kw)
            run = _clones(reqs)
            for r in run:
                eng.submit(r)
            for _ in range(10):
                eng.step()
            if call:
                profs = eng.profile(publish=False)
            eng.run()
            _check_done(run, f"20d {what}", [eng])
            streams.append([r.tokens for r in run])
            m = eng.metrics.summary()
            steps += m["spec_steps"] if kw else m["decode_steps"]
            del eng
        if streams[0] != streams[1]:
            raise AssertionError(f"20d {what}: streams after profile() "
                                 "differ from a run without it")
        # each profiled decode program runs twice (counted, profiled)
        per = cfg.n_layers * ((LOOKAHEAD + 1) if kw else 1)
        k4 = _expect_launches(f"20d {what}", {
            "decode_attention": per * (steps + 2)})["decode_attention"]
        tally["decode_attention"] += k4
        name = "spec_step" if kw else "decode_step"
        want = {"prefill_chunk", "decode_step"} if not kw else {
            "prefill_chunk", "draft_prefill_chunk", "spec_step"}
        if set(profs) != want or not all(p.flops > 0
                                         for p in profs.values()):
            raise AssertionError(f"20d {what}: programs {sorted(profs)}")
        dec = profs[name]
        k4_ms = dec.kernel_ms("decode_split_kernel", "decode_merge_kernel")
        if k4_ms <= 0:
            raise AssertionError(f"20d {what}: {name}'s profile names no K4")
        _log_profiles(profs, what)
        log(f"[fleet20d] {what}: K4 {k4_ms:.3f} ms of {name}'s "
            f"{dec.device_seconds * 1e3:.3f} ms of device time "
            f"({100 * k4_ms / (dec.device_seconds * 1e3):.1f}%), K4 work "
            f"{dec.kernel_flops.get('decode_attention', 0) / 1e9:.3f} GFLOP; "
            f"streams after profile() bit-equal to a run without it; K4 "
            f"launches {k4} = {per} x ({steps} steps + 2 profiled)")
        torch.cuda.empty_cache()


def phase_fleet(seed):
    """Phase 20: the serving fleet (FleetRouter over gossiped gauges, the
    staleness guard and failover, saturation and export, and the step
    profiler) at Llama-3.1-8B's full width and depth."""
    import bluefog_tpu_torch as bt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3")
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    rng = np.random.RandomState(seed + 20)
    tally = {"decode_attention": 0}
    reqs, base = _phase20_route(model, cfg, rng, tally)
    _phase20_failover(model, cfg, reqs, base, tally)
    _phase20_profile(model, cfg, rng, tally)
    del model
    torch.cuda.empty_cache()
    log(f"[fleet20] phase 20 in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K4 "
        f"launches {tally}")
    return tally


# ------------------------------------------------------------------ #
# phase 21: sequence parallelism at Llama-3.1-8B's width, T = 8192
# ------------------------------------------------------------------ #
SP_SEQ = 8192       # one sequence of the config's own max_seq_len
SP_SHARDS = 4       # 21a and 21b's sequence shards


def _ring_pairs(n, causal=True):
    """Live (shard, block) pairs of a ring of ``n`` shards."""
    return n * (n + 1) // 2 if causal else n * n


def _sp_kw(n):
    import bluefog_tpu_torch as bt

    return dict(sp_axis=bt.SeqAxis("sp", n), batch_specs=("bf", None, "sp"))


def _wall_and_device_ms(fn, flush, reps=5):
    """(host wall ms per call, ending in a synchronize; device ms per
    call: CUDA events behind a ~25 ms device spin, long enough for the
    host to enqueue the whole call, so the events see no launch gap) of
    ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    return wall, time_ms(fn, flush, reps, spin_cycles=50_000_000)


def _sp_inputs(seed, s, b, t, h, kv, d):
    """Shard-major bf16 q, k, v and a cotangent do (q ``[s, b, t, h, d]``,
    k/v ``[s, b, t, kv, d]``) from ``seed`` on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    q, do = (torch.randn(s, b, t, h, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(s, b, t, kv, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _ring_check(seed, s, what):
    """The flash ring at ``s`` shards of one 8192-token sequence at 8B
    width (q [1, 8192 / s, 32, 128] a shard, 8 kv heads, bf16, causal):
    forward and backward through the kernels held entry by entry to the
    same ring over the plain versions on the same card tensors
    (flash_check.ring_term_sizes), the ring with pair (s - 1, 0) left out
    rejected.  Returns the shard-major inputs."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.parallel import flash_check
    from bluefog_tpu_torch.parallel.ring_attention import (PLAIN_KERNELS,
                                                           ring_flash_parts)

    b, t, h, kv, d = 1, SP_SEQ // s, 32, 8, 128
    q, k, v, do = _sp_inputs(seed, s, b, t, h, kv, d)
    axis = bt.SeqAxis("sp", s)
    live = _ring_pairs(s)
    _reset_counts()
    got = ring_flash_parts(q, k, v, do, axis)
    torch.cuda.synchronize()
    _expect_flash(f"{what} ring", live)
    want = ring_flash_parts(q, k, v, do, axis, kernels=PLAIN_KERNELS)
    delta = (do.float() * want["out"].float()).sum(-1).transpose(2, 3)
    terms = flash_check.ring_term_sizes(q, k, v, do, want["lse"], delta, s)
    del delta
    errs, ratios = {}, {}
    for key in ("out", "dq", "dk", "dv"):
        errs[key], ratios[key] = _flash_err(got[key], want[key], terms[key],
                                            f"{what} ring {key}")
    errs["lse"] = (got["lse"] - want["lse"]).abs().max().item()
    if not torch.allclose(got["lse"], want["lse"], rtol=1e-5, atol=1e-4):
        raise AssertionError(f"{what} ring: lse differs by {errs['lse']}")
    bad = flash_check.ring_planted_fault(q, k, v, do, axis)
    rejected = {}
    for key in ("out", "dq", "dk", "dv"):
        rejected[key] = flash_check.mismatch(bad[key], want[key], terms[key])
        if rejected[key] <= 1:
            raise AssertionError(f"{what}: the bound passes the ring with "
                                 f"pair ({s - 1}, 0) left out ({key})")
    del got, want, terms, bad
    torch.cuda.empty_cache()
    log(f"[sp{what}] ring at sp {s}, q [{b}, {t}, {h}, {d}] a shard, {kv} "
        f"kv heads, bf16, causal: {live} live pairs of {s * s}, K2/K3a/K3b "
        f"{live} launches each; against the plain ring, max|err| "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
        + "; of its bound "
        + ", ".join(f"{k_} {r:.3g}" for k_, r in ratios.items())
        + f"; pair ({s - 1}, 0) left out: "
        + ", ".join(f"{k_} {r:.3g}" for k_, r in rejected.items())
        + " times the bound, rejected")
    return q, k, v, do


def _slices(b, h, kv):
    """(batch row, query heads, kv head) index slices that cut attention
    into independent parts, one batch row and one kv head with its query
    heads each: the plain versions hold [B, H, T, S] f32 scores, 8.6 GB
    at 8B width over 8192 tokens."""
    rep = h // kv
    for i in range(b):
        for g in range(kv):
            yield (slice(i, i + 1), slice(g * rep, (g + 1) * rep),
                   slice(g, g + 1))


def _hold_to_plain(what, got, q, k, v, do, delta):
    """Hold the kernels' causal offset-free ``got`` ({"out", "lse", "dq",
    "dk", "dv"} of q ``[B, T, H, D]``, k/v ``[B, T, KV, D]``, ``delta =
    rowsum(dO·O)`` as the backward took it) entry by entry to the plain
    versions on the same inputs (flash_check.mismatch over term_sizes),
    part by part (:func:`_slices`); on the first part the bound must
    reject flash_check.planted_faults.  Logs the errors and ratios."""
    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel import flash_check

    args = (True, None, 0, 0)
    errs = dict.fromkeys(("out", "dq", "dk", "dv", "lse"), 0.0)
    ratios = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
    rejected = {}
    b, _, h, _ = q.shape
    for n, (bi, hs, gs) in enumerate(_slices(b, h, k.shape[2])):
        part = [x[bi, :, sl].contiguous() for x, sl in
                ((q, hs), (k, gs), (v, gs), (do, hs))]
        lse, dlt = (x[bi, hs].contiguous() for x in (got["lse"], delta))
        ref_out, ref_lse = fa.flash_forward_plain(*part[:3], *args)
        ref = dict(zip(("out", "dq", "dk", "dv"), (ref_out, *(
            fa.flash_backward_plain(*part, lse, dlt, *args)))))
        terms = flash_check.term_sizes(*part, lse, dlt, *args)
        for key, sl in (("out", hs), ("dq", hs), ("dk", gs), ("dv", gs)):
            err, ratio = _flash_err(got[key][bi, :, sl], ref[key],
                                    terms[key], f"{what} {key}")
            errs[key], ratios[key] = (max(errs[key], err),
                                      max(ratios[key], ratio))
        errs["lse"] = max(errs["lse"], (lse - ref_lse).abs().max().item())
        if not torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{what}: lse differs by {errs['lse']}")
        if n == 0:
            for fault, key, bad in flash_check.planted_faults(
                    *part, lse, dlt, ref, tile=fa.DQ_KEY_TILE):
                ratio = flash_check.mismatch(bad, ref[key], terms[key])
                if ratio <= 1:
                    raise AssertionError(f"{what}: the bound passes a "
                                         f"planted fault ({fault}, {key})")
                rejected[f"{fault}, {key}"] = ratio
        del part, ref, ref_out, ref_lse, terms
    torch.cuda.empty_cache()
    log(f"{what}: against the plain versions, max|err| "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
        + "; of its bound "
        + ", ".join(f"{k_} {r:.3g}" for k_, r in ratios.items())
        + "; planted faults rejected at "
        + ", ".join(f"{k_} {r:.3g}" for k_, r in rejected.items())
        + " times the bound")


def _attention_call(what, attend, q, k, v, do):
    """``attend(q, k, v)`` forward and backward through autograd, which
    must launch K2, K3a and K3b once each: ``(out, (dq, dk, dv))``."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    _reset_counts()
    out = attend(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    _expect_flash(what, 1)
    return out.detach(), grads


def _phase21_ring_check(seed):
    """21a: every kernel shape 21b and 21c run, held to the plain
    versions: the sp-4 ring (4 shards of q [1, 2048, 32, 128], 21b
    (ii)), the sp-2 ring (2 x 4096, 21c), one flash_attention over the
    8192 (21b (i): [1, 8192, 32 heads, 8 kv, 128]) and Ulysses at sp 4
    (21b (iii): K2/K3a/K3b at [4, 8192, 8 heads, 2 kv, 128], the head
    groups folded into the batch), each with a planted fault rejected.
    Then ring forward + backward beside one flash_attention over the
    whole 8192 (the same function) and SDPA."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.parallel import flash_attention as fa
    from bluefog_tpu_torch.parallel.ring_attention import ring_attention
    from bluefog_tpu_torch.parallel.ulysses import ulysses_attention

    s, h, d = SP_SHARDS, 32, 128
    _ring_check(seed + 1, 2, "21a sp-2")
    q, k, v, do = _ring_check(seed, s, "21a")
    b, t = q.shape[1], q.shape[2]
    axis = bt.SeqAxis("sp", s)
    # Ulysses: its kernels see the all-to-all'd, folded tensors
    out, grads = _attention_call(
        "21a Ulysses", lambda *x: ulysses_attention(*x, axis, impl="flash"),
        q, k, v, do)
    fold = lambda x: axis.all_to_all(x, 2, 1).reshape(  # noqa: E731
        s * b, s * t, -1, d)
    qf, kf, vf, dof = (fold(x) for x in (q, k, v, do))
    got = dict(out=fold(out), dq=fold(grads[0]), dk=fold(grads[1]),
               dv=fold(grads[2]))
    del out, grads
    got["lse"] = fa.flash_forward(qf, kf, vf, True, None, 0, 0)[1]
    delta = (dof.float() * got["out"].float()).sum(-1).transpose(1, 2)
    _hold_to_plain(f"[sp21a] Ulysses at sp {s}: K2/K3a/K3b at "
                   f"{list(qf.shape)}, {kf.shape[2]} kv heads, one "
                   "launch each", got, qf, kf, vf, dof, delta)
    del qf, kf, vf, dof, got, delta
    whole = [x.movedim(0, 1).reshape(b, s * t, *x.shape[3:]).detach()
             for x in (q, k, v, do)]
    out, grads = _attention_call("21a flash_attention", fa.flash_attention,
                                 *whole)
    got = dict(out=out, dq=grads[0], dk=grads[1], dv=grads[2],
               lse=fa.flash_forward(*whole[:3], True, None, 0, 0)[1])
    delta = (whole[3].float() * out.float()).sum(-1).transpose(1, 2)
    _hold_to_plain(f"[sp21a] flash_attention over {s * t} (21b (i)): "
                   f"{list(whole[0].shape)}, {k.shape[3]} kv heads", got,
                   *whole, delta)
    del out, grads, got, delta

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def ring():
        out = ring_attention(*leaves, axis, impl="flash")
        torch.autograd.grad(out, leaves, do)

    whole = [x.clone().requires_grad_(True) for x in whole[:3]]
    do_whole = do.movedim(0, 1).reshape(b, s * t, h, d)

    def flash():
        out = fa.flash_attention(*whole)
        torch.autograd.grad(out, whole, do_whole)

    lib = [x.detach().transpose(1, 2).requires_grad_(True) for x in whole]
    do_lib = do_whole.transpose(1, 2)

    def sdpa():
        out = F.scaled_dot_product_attention(*lib, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, lib, do_lib)

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    times = {name: _wall_and_device_ms(fn, flush)
             for name, fn in (("ring", ring), ("flash", flash),
                              ("sdpa", sdpa))}
    log(f"[sp21a] forward + backward over T = {s * t} (one layer's "
        f"attention, B {b}, {h} heads): ring at sp {s} wall "
        f"{times['ring'][0]:.3f} ms, device {times['ring'][1]:.3f} ms; one "
        f"flash_attention wall {times['flash'][0]:.3f} ms, device "
        f"{times['flash'][1]:.3f} ms; SDPA wall {times['sdpa'][0]:.3f} ms, "
        f"device {times['sdpa'][1]:.3f} ms; ring/flash device "
        f"{times['ring'][1] / times['flash'][1]:.3f}")
    del leaves, whole, lib
    torch.cuda.empty_cache()


def _phase21_blocks(name, seed, n_layers):
    """The kernel-table rows of the ring's two block kinds at 8B width,
    B = 1, 2048 x 2048, bf16: the diagonal causal block (offsets equal)
    and a full off-diagonal block (q_offset 2048, kv_offset 0).  Per
    kernel: its ms, launches a 21b ring step, bound, plain ms and SDPA's
    (causal for the diagonal, non-causal for the off-diagonal; forward
    for K2, the backward for K3a + K3b together)."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.parallel import flash_attention as fa

    rate = mem_rate(name)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    b, t, h, kv, d = 1, SP_SEQ // SP_SHARDS, 32, 8, 128
    dt = torch.bfloat16
    g = torch.Generator("cuda").manual_seed(seed + 21)
    q, do = (torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, t, kv, d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    per_step = {"diagonal": SP_SHARDS * n_layers,
                "off-diagonal": (_ring_pairs(SP_SHARDS) - SP_SHARDS)
                * n_layers}
    for kind, q_off, kv_off, causal in (("diagonal", t, t, True),
                                        ("off-diagonal", t, 0, False)):
        args = (True, None, q_off, kv_off)
        out, lse = fa.flash_forward(q, k, v, *args)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)

        lib_fwd = time_ms(sdpa_fwd, flush)
        lib_bwd = (time_ms(lambda: torch.autograd.grad(
            sdpa_fwd(), leaves, do.transpose(1, 2)), flush) - lib_fwd)
        lib = {"flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
               "flash_backward_dkv": lib_bwd}
        for kname, (run, plain, nbytes, ops) in _flash_timed(
                q, k, v, do, lse, delta, args).items():
            ms = time_ms(run, flush)
            plain_ms = time_ms(plain, flush, reps=5)
            t_bytes, t_ops = nbytes / rate * 1e3, ops / PEAK_OPS[dt] * 1e3
            lib_what = ("SDPA forward" if kname == "flash_forward"
                        else "SDPA backward (K3a + K3b's)")
            log(f"[sp21a] {kname} on the ring's {kind} block (q_offset "
                f"{q_off}, kv_offset {kv_off}, B {b}, {t} x {t}, {h} heads, "
                f"{kv} kv, D {d}, bf16): kernel {ms:.4f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s), {per_step[kind]} launches "
                f"a 21b ring step, bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain "
                f"{plain_ms:.4f} ms, {lib_what} "
                f"({'causal' if causal else 'non-causal'}) "
                f"{lib[kname]:.4f} ms")
        del out, lse, delta, leaves
    torch.cuda.empty_cache()


# |step-0 loss - full attention's| that 21b accepts for ring and Ulysses:
# above every sound reading and below every planted fault's (PERF.md §6,
# PR 13)
SP_LOSS_LIMIT = 2e-4


def _plant_ring_pair():
    """Leave the pair (last shard, first block) out of every flash ring
    (flash_check.drop_pair over the card kernels); returns the undo."""
    from bluefog_tpu_torch.parallel import flash_check
    from bluefog_tpu_torch.parallel import ring_attention as ra

    names = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    saved = [getattr(ra, n) for n in names]
    t = SP_SEQ // SP_SHARDS
    for n, fn in zip(names, flash_check.drop_pair(
            saved, (SP_SHARDS - 1) * t, 0)):
        setattr(ra, n, fn)
    return lambda: [setattr(ra, n, fn) for n, fn in zip(names, saved)]


def _plant_ulysses_groups():
    """Pair each Ulysses head group's queries with the previous group's
    keys and values (the folded batch rolled by one); returns the undo."""
    from bluefog_tpu_torch.parallel import ulysses as ul

    real = ul.flash_attention
    ul.flash_attention = lambda q, k, v, **kw: real(
        q, k.roll(1, 0), v.roll(1, 0), **kw)
    return lambda: setattr(ul, "flash_attention", real)


def _planted_loss(cfg, kw, seed, plant):
    """Step 0's loss of 21b's window of ``cfg`` (the same weights and
    tokens) with the fault ``plant`` planted."""
    torch.cuda.empty_cache()
    _, model, _, step, params, opt, batch = _llama_step(
        cfg, 1, "none", seed, 1, SP_SEQ, **kw)
    undo = plant()
    try:
        loss = step(params, opt, batch, 0)[2][0].item()
    finally:
        undo()
    del model, step, params, opt, batch
    torch.cuda.empty_cache()
    return loss


def _phase21_train(seed):
    """21b: Llama-3.1-8B's width at 4 layers, one sequence of 8192 tokens
    on 1 rank: (i) attn_mode "full" (flash), (ii) ring + flash at sp 4,
    (iii) Ulysses + flash at sp 4.  The step-0 losses of (ii) and (iii)
    within SP_LOSS_LIMIT of (i)'s, and the same steps with a ring pair
    left out or Ulysses' head groups mispaired beyond it.  Returns the
    windows' launches."""
    warmup, timed = 1, 3
    n_layers = 4
    steps = warmup + timed
    total = dict.fromkeys(FLASH_KERNELS, 0)
    losses, busy, runs = {}, {}, {}
    for label, over, per in (
            ("(i) full", {}, 1),
            ("(ii) ring", dict(attn_mode="ring"), _ring_pairs(SP_SHARDS)),
            ("(iii) ulysses", dict(attn_mode="ulysses"), 1)):
        kw = _sp_kw(SP_SHARDS) if over else {}
        cfg = dataclasses.replace(
            _llama8b_cfg(n_layers), **over,
            **(dict(sp_axis="sp") if over else {}))
        runs[label] = (cfg, kw)
        got, state, _, loss = _llama_window(
            cfg, seed, warmup, timed, f"[sp21b] {label}",
            dict.fromkeys(FLASH_KERNELS, per * n_layers * steps),
            batch_rows=1, seq=SP_SEQ, **kw)
        for kname in FLASH_KERNELS:
            total[kname] += got[kname]
        losses[label] = loss[0].item()
        busy[label] = _profile_llama(*state[2:], what=f"21b {label}")
        del state
        torch.cuda.empty_cache()
    ref = losses["(i) full"]
    gaps = {label: abs(losses[label] - ref)
            for label in ("(ii) ring", "(iii) ulysses")}
    moves = {
        "ring, pair (3, 0) left out": abs(_planted_loss(
            *runs["(ii) ring"], seed=seed, plant=_plant_ring_pair) - ref),
        "Ulysses, head groups mispaired": abs(_planted_loss(
            *runs["(iii) ulysses"], seed=seed,
            plant=_plant_ulysses_groups) - ref)}
    log("[sp21b] step-0 losses: " + ", ".join(
        f"{k} {v:.6f}" for k, v in losses.items())
        + "; |loss - full's|: " + ", ".join(
            f"{k} {v:.3g}" for k, v in gaps.items())
        + "; planted: " + ", ".join(f"{k} {v:.3g}" for k, v in moves.items())
        + f" (limit {SP_LOSS_LIMIT}); device ms a step: " + ", ".join(
            f"{k} {v:.2f}" for k, v in busy.items()))
    for label, gap in gaps.items():
        if not gap <= SP_LOSS_LIMIT:
            raise AssertionError(f"21b {label}: step-0 loss "
                                 f"{losses[label]} differs from full's {ref} "
                                 f"by {gap} > {SP_LOSS_LIMIT}")
    for label, move in moves.items():
        if not move > SP_LOSS_LIMIT:
            raise AssertionError(f"21b: the loss limit {SP_LOSS_LIMIT} "
                                 f"passes a planted fault ({label}: {move})")
    return total


def _phase21_dp(seed):
    """21c: dp 2 x sp 2, 2 layers at 8B width, ring + flash, atc over
    ExponentialTwoGraph(2), 1 x 8192 tokens a rank: tokens/s, then the
    consensus distance after 3 steps (1 x 1024 a rank, different data per
    rank) below comm_mode="none"'s.  Returns the timed run's launches."""
    import bluefog_tpu_torch as bt

    n_layers, warmup, timed = 2, 2, 3
    cfg = dataclasses.replace(_llama8b_cfg(n_layers), attn_mode="ring",
                              sp_axis="sp")
    topo = _exp2(2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _, step, params, opt, batch = _llama_step(
        cfg, 2, "atc", seed, 1, SP_SEQ, topology=topo, **_sp_kw(2))
    tokens = 2 * SP_SEQ
    n_params, flops = _model_flops(cfg, params, tokens, SP_SEQ)
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
    launches = _expect_flash("21c", _ring_pairs(2) * n_layers * 2
                             * (warmup + timed))
    if not torch.isfinite(loss).all():
        raise AssertionError(f"21c: non-finite loss {loss.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del step, params, opt, batch, model
    torch.cuda.empty_cache()
    spread = {}
    for mode, kw in (("atc", dict(topology=topo)), ("none", {})):
        _, model, _, step, params, opt, batch = _llama_step(
            cfg, 2, mode, seed, 1, 1024, **kw, **_sp_kw(2))
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
        spread[mode] = float(bt.consensus_distance(params))
        del model, step, params, opt, batch
        torch.cuda.empty_cache()
    if not spread["atc"] < spread["none"]:
        raise AssertionError(f"21c: consensus distance atc {spread['atc']} "
                             f"not below none {spread['none']}")
    log(f"[sp21c] dp 2 x sp 2 ({n_layers} layers, {n_params / 1e9:.3f} B "
        f"params a rank), ring + flash, atc over ExponentialTwoGraph(2), 1 "
        f"x {SP_SEQ} a rank: {tokens / dt:.1f} tokens/s per card, step "
        f"{dt * 1e3:.2f} ms, MFU {flops / dt / PEAK_BF16:.4f}, peak memory "
        f"{peak:.2f} GiB, loss {loss.tolist()}; launches {launches}; "
        f"consensus distance after 3 steps (1 x 1024 a rank): atc "
        f"{spread['atc']:.4g} < none {spread['none']:.4g}")
    return launches


def _sp_process_run(backend, seed):
    """21e's run: the tiny f32 ring + flash Llama, 3 atc steps over
    ``backend``'s 2 ranks, each rank's 32 tokens in 2 shards: the params
    and losses on the host."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                              attn_mode="ring", sp_axis="sp")
    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    params = bt.rank_major(model.state(release=True), backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                               comm_mode="atc", topology=_exp2(2),
                               **_sp_kw(2))
    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2, 33)))
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    batch = (raw[lo:hi, :, :-1].cuda(), raw[lo:hi, :, 1:].cuda())
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, batch, i)
        losses.append(loss)
    out = {f"param.{k}": v.detach().cpu() for k, v in params.items()}
    out["loss"] = torch.stack(losses, dim=1).cpu()
    return out


def child_21e(seed, out_dir):
    """One process under bfrun -np 1: 2 ranks x 2 sequence shards, NCCL."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.context import get_context

    bt.init()
    b = get_context().backend
    if not (type(b).__name__ == "ProcessBackend" and b.wire == "nccl"
            and (b.size, b.n_local, b.process_count) == (2, 2, 1)):
        raise AssertionError(f"21e: {b}")
    torch.save(_sp_process_run(b, seed), os.path.join(out_dir, "e0.pt"))
    print("PHASE18 " + json.dumps(dict(backend=repr(b))), flush=True)
    bt.shutdown()


CHILDREN["21e"] = child_21e


def _phase21_process(seed):
    """21e: bfrun at NCCL world size 1, one process holding 2 ranks x 2
    sequence shards, the tiny f32 ring + flash Llama, bit-equal to
    StackedBackend(2) (as tests/test_torch_sp_process.py holds the gloo
    job on the CPU)."""
    import shutil
    import tempfile

    import bluefog_tpu_torch as bt

    out_dir = tempfile.mkdtemp(prefix="bf_phase21_")
    try:
        ref = _sp_process_run(bt.StackedBackend(2, device="cuda"), seed)
        t0 = time.perf_counter()
        rc, out, recs = _bfrun_children(
            "21e", 1, out_dir, seed,
            extra_env=("BLUEFOG_TPU_RANKS_PER_PROCESS=2",))
        if rc != 0 or len(recs) != 1:
            raise AssertionError(f"phase 21e failed (exit {rc}):\n"
                                 f"{out[-6000:]}")
        _check_against(torch.load(os.path.join(out_dir, "e0.pt")), ref,
                       slice(0, 2), "21e", exact=True)
        log(f"[sp21e] bfrun -np 1, {recs[0]['backend']}: the tiny f32 ring "
            f"+ flash Llama, 2 ranks x 2 sequence shards, 3 atc steps "
            f"bit-equal to StackedBackend(2); "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_sp(name, seed):
    """Phase 21: sequence parallelism (see the module docstring).
    Returns the launches of 21b and 21c (the main path's)."""
    t0 = time.perf_counter()
    _phase21_ring_check(seed)
    _phase21_blocks(name, seed, n_layers=4)
    launches = _phase21_train(seed)
    for kname, n in _phase21_dp(seed).items():
        launches[kname] += n
    for mode in ("ring", "ulysses"):
        phase_llama_reference(seed, mode=mode, sp=2)
    _phase21_process(seed)
    log(f"[sp21] {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ #
# phase 22: data, checkpoints and fault-tolerant training (ViT-B/16)
# ------------------------------------------------------------------ #
P22_IMAGES, P22_RANKS, P22_BATCH = 4096, 4, 128
# 36 steps: the last event, the promotion at step 27, leaves 9 steps of
# the healed fleet
P22_STEPS, P22_EVERY = 36, 8


def _p22_plan(R):
    """22b's and 22c's faults: a NaN burst on rank 1 at steps 5-6, rank 2
    preempted for steps 12-23."""
    return R.FaultPlan.nan_burst(P22_RANKS, rank=1, step=5,
                                 duration=2).merged(
        R.FaultPlan.preempt(P22_RANKS, rank=2, step=12, duration=12))


def _p22_elastic():
    """Quarantine of 4 anneal rounds, promotion at a disagreement of 2.0:
    over ExponentialTwoGraph(4) with per-rank data, a joiner that mixes
    like a live rank but is read by none stays above the live ranks'
    largest deviation (22b and 22c print its reading), so the default of
    1.0 would hold it in quarantine, as it does in the JAX package
    (tests/test_torch_elastic.py::test_phase22_quarantine_equals_jax)."""
    from bluefog_tpu_torch.elastic import ElasticConfig

    return ElasticConfig(bootstrap_rounds=4, max_quarantine_steps=16,
                         quarantine_threshold=2.0)


def _p22_loader(images, labels, seed, native):
    import bluefog_tpu_torch as bt

    return bt.DataLoader((images, labels), batch_size=P22_BATCH,
                         world=P22_RANKS, rank_major=True, seed=seed,
                         use_native=native)


def _p22_data(seed):
    """22a: the native loader against the Python pipeline, and
    device_prefetch to the card.  Returns (images, labels)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch import native

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (P22_IMAGES, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, P22_IMAGES).astype(np.int32)
    made = time.perf_counter() - t0
    rates = {}
    for native_on in (True, False):
        loader = _p22_loader(images, labels, seed, native_on)
        if loader.native is not native_on:
            raise AssertionError(f"22a: loader native={loader.native}")
        t0 = time.perf_counter()
        n = sum(b[0].shape[0] * b[0].shape[1] for b in loader)
        rates[native_on] = n / (time.perf_counter() - t0)
        loader.close()
    if not native.available():
        raise AssertionError(f"22a: {native.build_error()}")
    plain = _p22_loader(images, labels, seed, False)
    loader = _p22_loader(images, labels, seed, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for (gx, gy), (wx, wy) in zip(bt.device_prefetch(loader, "cuda"), plain,
                                  strict=True):
        if tuple(gx.shape) != (P22_RANKS, P22_BATCH // P22_RANKS, 224, 224,
                               3) or not gx.is_cuda:
            raise AssertionError(f"22a: batch {tuple(gx.shape)} on "
                                 f"{gx.device}")
        if not (np.array_equal(gx.cpu().numpy(), wx)
                and np.array_equal(gy.cpu().numpy(), wy)):
            raise AssertionError("22a: a prefetched batch differs from the "
                                 "Python pipeline's")
        n += wx.shape[0] * wx.shape[1]
    prefetch_rate = n / (time.perf_counter() - t0)
    loader.close()
    plain.close()
    log(f"[data22a] {P22_IMAGES} images 224 x 224 x 3 uint8 "
        f"({images.nbytes / 1e6:.1f} MB, made in {made:.2f} s), batch "
        f"{P22_BATCH} as [{P22_RANKS}, {P22_BATCH // P22_RANKS}, ...]: "
        f"native loader {rates[True]:.1f} img/s, Python pipeline "
        f"{rates[False]:.1f} img/s (host only); native + device_prefetch "
        f"to the card, checked bit for bit against the Python pipeline "
        f"(each batch copied back), {prefetch_rate:.1f} img/s; native "
        f"library {native.library_path().name}")
    return images, labels


def _p22_vit(cfg, dev, seed, backend=None, init=None):
    """ViT ``cfg`` over 4 ranks (or ``backend``'s) on ``dev``: guarded atc
    over ExponentialTwoGraph(4), SGD(1e-3, momentum 0.9) as phase 14:
    (step, params, optimizer, schedule)."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt

    model = bt.ViT(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    if init is not None:
        model.load_state_dict(init)
    backend = backend or bt.StackedBackend(P22_RANKS, device=dev)
    params = bt.rank_major(model.state(), backend)
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    sched = [bt.uniform_topology_spec(bt.ExponentialTwoGraph(P22_RANKS))]

    def loss_fn(p, b):
        return F.cross_entropy(model.apply(p, b[0]), b[1])

    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               topology=sched[0], guard=bt.GuardConfig())
    return step, params, opt, sched


def _counted(step):
    """``step`` with a call count (``.calls``), its attributes kept."""
    import functools

    @functools.wraps(step)
    def call(*args):
        call.calls += 1
        return step(*args)

    call.calls = 0
    return call


def _p22_check_events(res, what):
    """22b's and 22c's asserts on the event list: the burst is trained
    through; rank 2 dies, heals and rolls back; rejoins and is promoted
    within max_quarantine_steps."""
    import bluefog_tpu_torch.resilience as R

    ev = res.events
    kinds = [e.kind for e in ev]
    burst = [e for e in ev if e.kind == "skip" and e.step in (5, 6)]
    dead = [e for e in ev if e.kind == "rank_dead"]
    rb = [e for e in ev if e.kind == "rollback"]
    join = [e for e in ev if e.kind == "rank_joining"]
    promo = [e for e in ev if e.kind == "rank_promoted"]
    if [e.detail["ranks"] for e in burst] != [[1], [1]] or any(
            e.kind == "rollback" and e.step < 12 for e in ev):
        raise AssertionError(f"{what}: the burst was not trained through: "
                             f"{kinds}")
    if [e.detail["rank"] for e in dead] != [2] or len(rb) != 1 \
            or rb[0].detail["restored_step"] != P22_EVERY \
            or rb[0].detail["dead"] != [2]:
        raise AssertionError(f"{what}: death and rollback: {ev}")
    if [e.detail["rank"] for e in join] != [2] or \
            [e.detail["rank"] for e in promo] != [2] or \
            promo[0].step - join[0].step >= \
            _p22_elastic().max_quarantine_steps:
        raise AssertionError(f"{what}: rejoin and promotion: {ev}")
    if res.membership != ["live"] * P22_RANKS or res.dead_mask.any() \
            or res.step != P22_STEPS:
        raise AssertionError(f"{what}: ends {res.membership}, step "
                             f"{res.step}")
    if not R.update_health(res.params).all():
        raise AssertionError(f"{what}: non-finite params")
    return dead[0], rb[0], join[0], promo[0]


def _p22_resilient(seed, images, labels, tmp):
    """22b: ViT-B/16 at full width and depth over 4 stacked ranks under
    run_resilient, fed by the native loader through device_prefetch.
    Returns the run's launches."""
    import bluefog_tpu_torch as bt
    import bluefog_tpu_torch.resilience as R
    from bluefog_tpu_torch import observe
    from bluefog_tpu_torch.checkpoint import Checkpointer

    cfg = bt.ViTConfig.base(attn_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, params, opt, sched = _p22_vit(cfg, "cuda", seed)
    loader = _p22_loader(images, labels, seed, True)

    def stream():
        while True:  # one epoch after another (the sampler reshuffles)
            yield from loader

    feed = bt.device_prefetch(stream(), "cuda", depth=2)
    cache = []

    def batch_fn(s):
        # a pure function of the step (a rollback replays the same
        # batches): pulled from the prefetching loader the first time
        while len(cache) <= s:
            cache.append(next(feed))
        x, y = cache[s]
        return (x.to(cfg.dtype).mul_(1 / 127.5).sub_(1), y.long())

    ck = Checkpointer(tempfile.mkdtemp(prefix="ck22b_", dir=tmp),
                      max_to_keep=2)
    saves, rollback_wall = [], []
    orig_save, orig_restore = ck.save, ck.restore_latest

    def save(*a, **k):
        t0 = time.perf_counter()
        out = orig_save(*a, **k)
        # the dict the write thread completes with its write_s
        saves.append((time.perf_counter() - t0, ck.last_save))
        return out

    def restore_latest(*a, **k):
        t0 = time.perf_counter()
        out = orig_restore(*a, **k)
        rollback_wall.append(time.perf_counter() - t0)
        return out

    ck.save, ck.restore_latest = save, restore_latest
    counted = _counted(step)
    hist = observe.get_registry().histogram(
        "bf_step_wall_seconds", "train/engine step wall time", loop="train")
    seen = len(hist.window_values)
    batch_fn(0)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = R.run_resilient(counted, params, opt, batch_fn, steps=P22_STEPS,
                          checkpointer=ck, schedule=sched,
                          fault_plan=_p22_plan(R),
                          checkpoint_every=P22_EVERY,
                          elastic=_p22_elastic())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _expect_flash("22b", cfg.depth * P22_RANKS * counted.calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dead, rb, join, promo = _p22_check_events(res, "22b")
    step_walls = hist.window_values[seen:]
    bare = _p22_bare(step, params, opt, batch_fn, sched)
    last_save = saves[-1][1]
    writes = [d["write_s"] for _, d in saves]
    log(f"[res22b] ViT-B/16 ({sum(v[0].numel() for v in params.values()) / 1e6:.1f} M "
        f"params a rank), {P22_RANKS} stacked ranks, batch "
        f"{P22_BATCH // P22_RANKS} a rank from the native loader, guarded "
        f"atc, run_resilient {P22_STEPS} steps ({counted.calls} step calls, "
        f"replays included) in {wall:.2f} s: "
        f"{P22_BATCH * counted.calls / wall:.1f} img/s per card over the "
        f"run; events: burst skips at 5-6, rank 2 dead at {dead.step}, "
        f"rollback to {rb.detail['restored_step']} (backoff "
        f"{rb.detail['backoff']} s), rejoin at {join.step}, promoted at "
        f"{promo.step} (disagreement {promo.detail['disagreement']:.4g}, "
        f"{promo.detail['rounds']} rounds); {len(saves)} checkpoints of "
        f"{last_save['bytes'] / 1e9:.3f} GB: save call "
        f"{1e3 * statistics.median(s for s, _ in saves):.1f} ms median "
        f"(snapshot {1e3 * last_save['snapshot_s']:.1f} ms in the last; "
        f"writes on a thread {1e3 * min(writes):.1f}-"
        f"{1e3 * max(writes):.1f} ms); restore "
        f"{1e3 * ck.last_restore['load_s']:.1f} ms load + "
        f"{1e3 * ck.last_restore['copy_s']:.1f} ms copy; rollback wall "
        f"{1e3 * rollback_wall[0]:.1f} ms + backoff; peak memory "
        f"{peak:.2f} GiB; launches {launches} = 12 layers x "
        f"{P22_RANKS} ranks x {counted.calls} step calls each; step wall "
        f"in the runner p50 {1e3 * statistics.median(step_walls):.2f} ms "
        f"({P22_BATCH / statistics.median(step_walls):.1f} img/s per card "
        f"on a clean step); "
        + bare)
    del step, params, opt, cache, feed, res
    loader.close()
    ck.close()
    torch.cuda.empty_cache()
    return launches


class _NoWrite:
    """A checkpointer that keeps nothing, for run_resilient on clean steps:
    its own cost, with no write thread contending for the host."""

    def save(self, *args, **kwargs):
        return True

    def wait(self):
        pass

    def restore_latest(self, like=None):
        raise AssertionError("22b: a clean run rolled back")


def _p22_bare(step, params, opt, batch_fn, sched, rounds=2, n=8):
    """The runner's own cost in one window: on the run's first ``n``
    batches, a bare loop of the same guarded step and run_resilient over
    ``n`` clean steps (no faults, a checkpointer that writes nothing),
    alternated ``rounds`` times after a warm-up; then one profiled step
    (device ms, and its busy share under the profiler)."""
    import bluefog_tpu_torch.resilience as R

    w = step.default_comm_weights
    batches = [batch_fn(s) for s in range(n)]
    for i in range(2):
        step(params, opt, batches[i], i, w)
    bare, loop = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(params, opt, batches[i], i, w)
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) / n)
        t0 = time.perf_counter()
        res = R.run_resilient(step, params, opt, lambda s: batches[s],
                              steps=n, checkpointer=_NoWrite(),
                              schedule=sched, checkpoint_every=0)
        loop.append((time.perf_counter() - t0) / n)
        if any(e.kind != "checkpoint" for e in res.events):
            raise AssertionError(f"22b: a clean run's events {res.events}")
    wall, busy = _profile_step(lambda: step(params, opt, batches[0], 0, w),
                               "22b bare step")
    b, r = statistics.median(bare), statistics.median(loop)
    return (f"in one window ({rounds} x {n} steps alternated): bare loop "
            f"{', '.join(f'{1e3 * x:.2f}' for x in bare)} ms a step "
            f"(median {1e3 * b:.2f}, {P22_BATCH / b:.1f} img/s per card), "
            f"run_resilient {', '.join(f'{1e3 * x:.2f}' for x in loop)} "
            f"ms a step (median {1e3 * r:.2f}, {P22_BATCH / r:.1f} img/s): "
            f"the runner's own cost {1e3 * (r - b):+.2f} ms a step; one "
            f"profiled step: device busy {busy:.2f} ms in a {wall:.2f} ms "
            f"wall under the profiler ({100 * busy / wall:.1f}%), "
            f"{100 * busy / (1e3 * b):.1f}% of the bare loop's median step")


def _p22_tiny_batches(seed, cfg, n=24):
    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn(n, P22_RANKS, 2, cfg.image_size, cfg.image_size, 3,
                    generator=g)
    y = torch.randint(0, cfg.num_classes, (n, P22_RANKS, 2), generator=g)
    return x, y


def _p22_reference(seed, tmp):
    """22c: the tiny f32 ViT (flash, D = 16) through 22b's plan on the card
    and on the host: equal (kind, step, rank) events, params within phase
    14's bound; a card checkpoint restored into a fresh step continues
    bit-equal to the uninterrupted run for 3 steps."""
    import bluefog_tpu_torch as bt
    import bluefog_tpu_torch.resilience as R
    from bluefog_tpu_torch.checkpoint import Checkpointer

    cfg = bt.ViTConfig.tiny(dtype=torch.float32, attn_impl="flash")
    init = bt.ViT(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed)).state_dict()
    x, y = _p22_tiny_batches(seed, cfg)
    out = {}
    for dev in ("cuda", "cpu"):
        step, params, opt, sched = _p22_vit(cfg, dev, seed, init=init)
        step = _counted(step)
        xs, ys = x.to(dev), y.to(dev)
        _reset_counts()
        res = R.run_resilient(
            step, params, opt, lambda s: (xs[s % len(xs)], ys[s % len(ys)]),
            steps=P22_STEPS,
            checkpointer=Checkpointer(tempfile.mkdtemp(dir=tmp)),
            schedule=sched, fault_plan=_p22_plan(R),
            checkpoint_every=P22_EVERY, elastic=_p22_elastic(),
            sleep=lambda s: None)
        if dev == "cuda":
            launches = _expect_flash("22c card",
                                     cfg.depth * P22_RANKS * step.calls)
        elif any(_launches().values()):
            raise AssertionError("22c: the host run launched a kernel")
        promo = _p22_check_events(res, f"22c {dev}")[3]
        out[dev] = ([(e.kind, e.step, e.detail.get("rank"))
                     for e in res.events],
                    {k: v.cpu() for k, v in res.params.items()},
                    promo.detail["disagreement"])
    if out["cuda"][0] != out["cpu"][0]:
        raise AssertionError(f"22c: card events {out['cuda'][0]} != host "
                             f"{out['cpu'][0]}")
    worst, worst_key = 0.0, None
    for k, want in out["cpu"][1].items():
        err = (out["cuda"][1][k] - want).abs().max().item()
        ratio = err / (1e-4 * want.abs().max().item() + 1e-7)
        if ratio > worst:
            worst, worst_key = ratio, k
    if worst > 1:
        raise AssertionError(f"22c: {worst_key} differs by {worst:.3g} times "
                             "its bound")
    # resume: a card checkpoint at step 3 restored into a fresh step
    runs = []
    ckdir = tempfile.mkdtemp(dir=tmp)
    for fresh in (False, True):
        step, params, opt, _ = _p22_vit(cfg, "cuda", seed, init=init)
        w = step.default_comm_weights
        ck = Checkpointer(ckdir)
        if fresh:
            ck.restore(3, like={"params": params, "opt_state": opt,
                                "step": 0})
        else:
            for s in range(3):
                step(params, opt, (x[s].cuda(), y[s].cuda()), s, w)
            ck.save(3, {"params": params, "opt_state": opt, "step": 3})
        for s in range(3, 6):
            step(params, opt, (x[s].cuda(), y[s].cuda()), s, w)
        runs.append({k: v.clone() for k, v in params.items()})
    if not all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]):
        raise AssertionError("22c: the restored run is not bit-equal to the "
                             "uninterrupted one")
    log(f"[res22c] tiny f32 ViT (flash), 22b's plan over {P22_STEPS} steps: "
        f"card (K2, K3a, K3b: {launches['flash_forward']} launches each = "
        f"{cfg.depth} layers x {P22_RANKS} ranks x "
        f"{launches['flash_forward'] // (cfg.depth * P22_RANKS)} step calls)"
        f" and host log the same {len(out['cpu'][0])} "
        f"events; params within {worst:.3g} of their bound at most "
        f"({worst_key}); the joiner's disagreement at promotion card "
        f"{out['cuda'][2]:.4g}, host {out['cpu'][2]:.4g}; a card checkpoint "
        "restored into a fresh step runs 3 steps bit-equal to the "
        "uninterrupted run")


def _p22_timeline(seed, tmp):
    """22d: BLUEFOG_TIMELINE set, bf.init on the card (the native writer),
    a short run of the tiny ViT through a burst and a death: the Chrome
    trace parses, holds the resilience.* instants, drops nothing."""
    import bluefog_tpu_torch as bt
    import bluefog_tpu_torch.resilience as R
    from bluefog_tpu_torch import timeline
    from bluefog_tpu_torch.checkpoint import Checkpointer
    from bluefog_tpu_torch.context import get_context

    prefix = os.path.join(tmp, "timeline")
    os.environ["BLUEFOG_TIMELINE"] = prefix
    try:
        bt.init(size=P22_RANKS, device="cuda")
        tl = timeline.get_timeline()
        if tl is None or tl.backend != "native":
            raise AssertionError(f"22d: timeline {tl and tl.backend}")
        cfg = bt.ViTConfig.tiny(dtype=torch.float32, attn_impl="flash")
        step, params, opt, sched = _p22_vit(cfg, "cuda", seed,
                                            backend=get_context().backend)
        x, y = _p22_tiny_batches(seed, cfg)
        xs, ys = x.cuda(), y.cuda()
        plan = R.FaultPlan.nan_burst(P22_RANKS, 1, 2, 2).merged(
            R.FaultPlan.rank_death(P22_RANKS, 3, 6))
        res = R.run_resilient(
            step, params, opt, lambda s: (xs[s % len(xs)], ys[s % len(ys)]),
            steps=16, checkpointer=Checkpointer(tempfile.mkdtemp(dir=tmp)),
            schedule=sched, fault_plan=plan, checkpoint_every=4,
            sleep=lambda s: None)
        dropped = tl.dropped_events()
        path = tl.path
    finally:
        bt.shutdown()
        os.environ.pop("BLUEFOG_TIMELINE", None)
    with open(path) as fh:
        events = json.load(fh)
    names = [e.get("name", "") for e in events]
    want = {f"resilience.{e.kind}" for e in res.events}
    got = {n for n in names if n.startswith("resilience.")}
    if not {"resilience.checkpoint", "resilience.skip",
            "resilience.rank_dead", "resilience.rollback"} <= want == got:
        raise AssertionError(f"22d: trace instants {sorted(got)}, events "
                             f"{sorted(want)}")
    if dropped or sum(n.startswith("resilience.") for n in names) \
            != len(res.events):
        raise AssertionError(f"22d: dropped {dropped}, {len(res.events)} "
                             "events")
    log(f"[res22d] native timeline ({os.path.basename(path)}): "
        f"{len(events)} trace events, {len(res.events)} resilience.* "
        f"instants ({', '.join(sorted(got))}), 0 dropped")


def phase_resilience(seed):
    """Phase 22 (see the module docstring).  Returns 22b's launches."""
    import shutil

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bf_phase22_")
    try:
        images, labels = _p22_data(seed)
        launches = _p22_resilient(seed, images, labels, tmp)
        del images, labels
        _p22_reference(seed, tmp)
        _p22_timeline(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[res22] phase 22 in {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ #
# phase 23: Mixture of Experts
# ------------------------------------------------------------------ #
MOE_LAYERS = 2           # 23a's depth (32 layers of f32 state: ~740 GB)
MOE_SERVE_LAYERS = 16    # 23c: 16 of 32 layers of bf16 experts (~46 GB)
EP_RANKS, EP_EXPERTS = 8, 4               # 23d: two replicas an expert
EP_DIM, EP_HIDDEN, EP_TOKENS = 4096, 14336, 2048  # Mixtral's expert width


def _moe8b_cfg(n_layers, **over):
    """Phase 23's model: Llama-3.1-8B's width (``_llama8b_cfg``) with
    examples/llama_benchmark.py's ``--experts 8`` (:110-119): top-2 of 8
    experts, aux weight 0.01, capacity factor 1.25, groups of 4096
    tokens (:52-56), and the benchmark's remat."""
    base = dict(n_experts=8, moe_top_k=2, moe_aux_weight=0.01,
                capacity_factor=1.25, moe_group_size=4096, remat=True)
    base.update(over)
    return dataclasses.replace(_llama8b_cfg(n_layers), **base)


def _moe_flops(cfg, params, tokens, seq, forwards):
    """(params per rank, model FLOP a step, the one-hot dispatch and
    combine FLOP a step): the model count is llama_benchmark.py's 6 x
    matmul params a token with the experts counted at top_k / n_experts
    (the ACTIVE params), plus causal attention 6 x L x T x dim; the
    one-hot products are 2 x g G E cap dim FLOP each a layer forward,
    run ``forwards`` times (2 under remat) plus twice in the backward."""
    n_params = sum(v[0].numel() for v in params.values())
    expert = sum(v[0].numel() for k, v in params.items()
                 if ".moe_ffn.w" in k)
    active = (n_params - cfg.vocab_size * cfg.dim
              - expert * (1 - cfg.moe_top_k / cfg.n_experts))
    flops = 6.0 * active * tokens + 6.0 * cfg.n_layers * seq * cfg.dim \
        * tokens
    from bluefog_tpu_torch.models.llama import moe_group_shape

    g, G, cap = moe_group_shape(cfg, tokens)
    onehot = 2 * 2.0 * g * G * cfg.n_experts * cap * cfg.dim \
        * (forwards + 2) * cfg.n_layers
    return n_params, flops, onehot


@torch.no_grad()
def _moe_drops(model, params, tokens):
    """Each MoE layer's dropped share of its top-k assignments (capacity
    overflow) in one forward of ``tokens``: a hook reads each layer's FFN
    input, and the layer's router and routing count what they keep."""
    from bluefog_tpu_torch.models.llama import (moe_combine_weights,
                                                moe_group_shape)

    cfg = model.cfg
    seen = []
    hooks = [blk.moe_ffn.register_forward_pre_hook(
        lambda m, a: seen.append(a[0])) for blk in model.layers]
    try:
        model.apply(params, tokens)
    finally:
        for h in hooks:
            h.remove()
    out = []
    for i, x in enumerate(seen):
        s = x.shape[0] * x.shape[1]
        g, G, cap = moe_group_shape(cfg, s)
        w = params[f"layers.{i}.moe_ffn.router.kernel"]
        probs = torch.softmax(x.reshape(-1, cfg.dim).float() @ w.float(), -1)
        comb = moe_combine_weights(probs.reshape(g, G, -1), cfg.moe_top_k,
                                   cap)
        out.append(1.0 - (comb > 0).sum().item() / (s * cfg.moe_top_k))
    return out


def _moe_parts_ms(cfg, flush, tokens):
    """One MoE layer's parts at the step's shape, each timed alone
    forward and forward + backward (CUDA events, median of 3): the f32
    router and routing (``moe_combine_weights``), the one-hot dispatch
    product, the expert GEMMs (w1, w3, w2 from f32 masters) and the
    one-hot combine product.  {part: (forward ms, forward + backward
    ms)}."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.llama import (moe_combine_weights,
                                                moe_group_shape)

    E, d, h, dt = cfg.n_experts, cfg.dim, cfg.ffn_dim, cfg.dtype
    g, G, cap = moe_group_shape(cfg, tokens)
    gen = torch.Generator("cuda").manual_seed(23)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype).requires_grad_(True)

    x = rnd(tokens, d, dtype=dt)
    wr = rnd(d, E, scale=d ** -0.5)
    w1, w3 = rnd(E, d, h, scale=d ** -0.5), rnd(E, d, h, scale=d ** -0.5)
    w2 = rnd(E, h, d, scale=h ** -0.5)
    with torch.no_grad():
        probs = torch.softmax(x.float() @ wr, -1).reshape(g, G, E)
        comb0 = moe_combine_weights(probs, cfg.moe_top_k, cap)
    disp = (comb0 > 0).to(dt)
    comb = comb0.to(dt).requires_grad_(True)
    e_in = rnd(E, g * cap, d, dtype=dt)
    e_out = rnd(E, g, cap, d, dtype=dt)

    def router():
        p = torch.softmax(x.float() @ wr, -1).reshape(g, G, E)
        return moe_combine_weights(p, cfg.moe_top_k, cap), (x, wr)

    def dispatch():
        return torch.einsum("gsec,gsd->egcd", disp, x.reshape(g, G, d)), (x,)

    def experts():
        a = torch.bmm(e_in, w1.to(dt))
        b = torch.bmm(e_in, w3.to(dt))
        return torch.bmm(F.silu(a) * b, w2.to(dt)), (e_in, w1, w3, w2)

    def combine():
        return torch.einsum("egcd,gsec->gsd", e_out, comb), (e_out, comb)

    out = {}
    for name, fn in (("router + routing", router), ("dispatch", dispatch),
                     ("experts", experts), ("combine", combine)):
        def fwd():
            with torch.no_grad():
                fn()

        def fwd_bwd():
            y, ins = fn()
            torch.autograd.grad(y, ins, torch.ones_like(y))

        out[name] = (time_ms(fwd, flush, reps=3),
                     time_ms(fwd_bwd, flush, reps=3))
    del x, wr, w1, w3, w2, comb, e_in, e_out, disp, comb0
    torch.cuda.empty_cache()
    return out


def _phase23_train(seed):
    """23a: the MoE Llama at 8B width, 2 layers, 1 rank.  Returns the
    timed window's launches."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.llama import llama_loss_fn

    cfg = _moe8b_cfg(MOE_LAYERS)
    warmup, timed = 2, 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _, step, params, opt, batch = _llama_step(
        cfg, 1, "none", seed, LLAMA_BATCH, LLAMA_SEQ)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    n_params, flops, onehot = _moe_flops(cfg, params, tokens, LLAMA_SEQ, 2)
    # the loss carries the aux term: ce + 0.01 x the layers' aux sum
    with torch.no_grad():
        p0 = {k: v[0] for k, v in params.items()}
        logits, aux = model.apply(p0, batch[0][0], return_aux=True)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             batch[1][0].reshape(-1))
        full = llama_loss_fn(model)(p0, (batch[0][0], batch[1][0]))
        del logits
    want_aux = (ce + cfg.moe_aux_weight * aux).item()
    if not (aux.item() >= 0.99 and abs(full.item() - want_aux) < 1e-4):
        raise AssertionError(f"23a: loss {full.item()} is not ce "
                             f"{ce.item()} + 0.01 x aux {aux.item()}")
    drops = _moe_drops(model, p0, batch[0][0])
    del p0
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
    n = cfg.n_layers * (warmup + timed)
    # remat recomputes each block's forward: K2 twice a layer and step
    launches = _expect_launches("23a", {"flash_forward": 2 * n,
                                        "flash_backward_dq": n,
                                        "flash_backward_dkv": n})
    losses = torch.cat(losses)
    if not torch.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"23a: losses {losses.tolist()} not finite "
                             "and falling")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[moe23a] MoE Llama at 8B width ({cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, {cfg.n_experts} experts top-"
        f"{cfg.moe_top_k}, capacity factor {cfg.capacity_factor}, groups "
        f"of {cfg.moe_group_size}), 1 rank, batch {LLAMA_BATCH} x "
        f"{LLAMA_SEQ}, flash, remat, f32 head: {tokens / dt:.1f} tokens/s "
        f"per card, step {dt * 1e3:.2f} ms, MFU {flops / dt / PEAK_BF16:.4f}"
        f" of 989 TFLOP/s (6 x active params), the one-hot dispatch and "
        f"combine {onehot / 1e12:.3f} TFLOP a step more "
        f"({onehot / dt / PEAK_BF16:.4f}), peak memory {peak:.2f} GiB, losses "
        f"{', '.join(f'{x:.4f}' for x in losses.tolist())} (aux "
        f"{aux.item():.4f} at step 0), assignments dropped by capacity "
        f"per layer {', '.join(f'{x:.4f}' for x in drops)}; launches "
        f"{launches} over {warmup + timed} steps")
    busy = _profile_llama(step, params, opt, batch, what="MoE Llama")
    del step, params, opt, batch, model
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    parts = _moe_parts_ms(cfg, flush, tokens)
    for name, (fwd, fwd_bwd) in parts.items():
        # remat runs each forward twice: the step pays fwd + fwd_bwd
        share = cfg.n_layers * (fwd + fwd_bwd)
        log(f"[moe23a] {name} alone: forward {fwd:.3f} ms, forward + "
            f"backward {fwd_bwd:.3f} ms a layer; x {cfg.n_layers} layers "
            f"with remat's second forward {share:.2f} ms, "
            f"{100 * share / busy:.1f}% of the step's device time")
    return launches


def _phase23_ranks(seed):
    """23b: one layer over 2 stacked ranks under atc.  Returns the
    launches."""
    import bluefog_tpu_torch as bt

    cfg = _moe8b_cfg(1)
    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    warmup, timed, seq = 2, 3, LLAMA_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _, step, params, opt, batch = _llama_step(
        cfg, 2, "atc", seed, 1, seq, topology=topo)
    n_params = sum(v[0].numel() for v in params.values())
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
    n = cfg.n_layers * 2 * (warmup + timed)
    launches = _expect_launches("23b", {"flash_forward": 2 * n,
                                        "flash_backward_dq": n,
                                        "flash_backward_dkv": n})
    if not torch.isfinite(loss).all():
        raise AssertionError(f"23b: non-finite loss {loss.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    combine = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.combine(params, 0)
        end.record()
        combine.append((start, end))
    torch.cuda.synchronize()
    combine_ms = statistics.median(a.elapsed_time(b) for a, b in combine[1:])
    log(f"[moe23b] MoE Llama at 8B width (1 layer, {n_params / 1e9:.3f} B "
        f"params a rank, experts included), 2 ranks stacked, atc over "
        f"ExponentialTwoGraph(2), batch 1 x {seq} a rank: "
        f"{2 * seq / dt:.1f} tokens/s per card, step {dt * 1e3:.2f} ms, "
        f"peak memory {peak:.2f} GiB, combine {combine_ms:.3f} ms a step "
        f"over {n_params / 1e9:.3f} B f32 values a rank, loss "
        f"{loss.tolist()}; launches {launches} over {warmup + timed} steps")
    del step, params, opt, batch, model
    torch.cuda.empty_cache()
    spread = {}
    for mode, kw in (("atc", dict(topology=topo)), ("none", {})):
        _, model, _, step, params, opt, batch = _llama_step(
            cfg, 2, mode, seed, 1, 512, **kw)
        for i in range(3):
            params, opt, loss = step(params, opt, batch, i)
        spread[mode] = float(bt.consensus_distance(params))
        del model, step, params, opt, batch
        torch.cuda.empty_cache()
    if not spread["atc"] < spread["none"]:
        raise AssertionError(f"23b: consensus distance atc {spread['atc']} "
                             f"not below none {spread['none']}")
    log(f"[moe23b] consensus distance after 3 steps (1 x 512 a rank): atc "
        f"{spread['atc']:.4g} < none {spread['none']:.4g}")
    return launches


def _phase23_serve(seed):
    """23c: the MoE model served, bf16, 16 layers.  Returns the counted
    runs' launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.serving import Request, ServingEngine

    # served dropless (decode_config's factor), so the uncached forward
    # of the same module is the no-cache dropless rollout; one group
    # (moe_group_size 4096 > any context here) is moe_group_size=0's
    cfg = _moe8b_cfg(MOE_SERVE_LAYERS, remat=False,
                     capacity_factor=float(8))
    L = cfg.n_layers
    torch.cuda.empty_cache()
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    weight_bytes = sum(p.numel() * p.element_size()
                       for k, p in model.named_parameters()
                       if k != "tok_embeddings.embedding")
    tally = {}
    rng = np.random.RandomState(seed + 23)
    reqs = _serve_reqs(rng, SERVE_CAP, cfg.vocab_size, (16, 600), 16)
    eng = ServingEngine(model, cfg, capacity=SERVE_CAP, max_len=1024,
                        prefill_chunk=256, device="cuda")
    m, wall, peak = _run_engine(
        eng, reqs, "23c engine",
        lambda m: {"decode_attention": L * m["decode_steps"]}, tally)
    busy, wall_step = _device_ms_per_step(eng, _clones(reqs))
    bound = weight_bytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
    log(f"[moe23c] MoE Llama at 8B width, {L} layers, bf16, "
        f"{weight_bytes / 1e9:.2f} GB of weights a decode step reads: "
        f"{m['tokens_generated']} tokens in {wall:.2f} s, tokens/s "
        f"{m['tokens_per_sec']:.1f}, TTFT p50 {m['ttft_p50'] * 1e3:.1f} ms, "
        f"decode step p50 {m['decode_step_ms_p50']:.2f} ms of wall, "
        f"{busy:.2f} ms of device time ({wall_step:.2f} ms wall under the "
        f"profiler) against the weight-read bound {bound:.2f} ms; peak "
        f"{peak:.2f} GiB")
    # the engine's streams against llama_generate's, one request a call
    torch.cuda.synchronize()
    _reset_counts()
    gens = [bt.llama_generate(model, cfg, r.prompt[None], r.max_new_tokens,
                              max_len=1024, device="cuda")[0, r.prompt.size:]
            .cpu().numpy() for r in reqs]
    for k, n in _expect_launches("23c llama_generate", {
            "decode_attention": L * sum(r.max_new_tokens - 1
                                        for r in reqs)}).items():
        tally[k] = tally.get(k, 0) + n
    n_diff = _explain_flips(model, cfg, [(r, g, r.tokens)
                                         for r, g in zip(reqs, gens)],
                            "23c engine vs llama_generate")
    # 8 tokens of one short prompt: the cached decode (K4) against the
    # rollout that runs the uncached forward over the whole sequence
    prompt = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
    torch.cuda.synchronize()
    _reset_counts()
    got = bt.llama_generate(model, cfg, prompt[None], 8, max_len=64,
                            device="cuda")[0, 16:].cpu().numpy()
    seq = torch.from_numpy(prompt[None]).cuda()
    with torch.no_grad():
        for _ in range(8):
            nxt = model(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], dim=1)
    for k, n in _expect_launches("23c rollout", {
            "decode_attention": L * 7, "flash_forward": L * 8}).items():
        tally[k] = tally.get(k, 0) + n
    roll = seq[0, 16:].cpu().numpy()
    n_roll = _explain_flips(model, cfg, [(Request(prompt, 8), roll, got)],
                            "23c cached decode vs no-cache rollout")
    log(f"[moe23c] engine streams equal to llama_generate's: "
        f"{len(reqs) - n_diff} of {len(reqs)} (the rest part at "
        f"near-ties); 8 cached tokens of a 16-token prompt "
        f"{'equal' if not n_roll else 'part at a near-tie from'} the "
        f"no-cache dropless rollout; K4 {tally.get('decode_attention', 0)} "
        f"launches, K2 {tally.get('flash_forward', 0)}")
    del eng, model
    torch.cuda.empty_cache()
    return tally


def _ep_batch(tokens, route, cmask, n):
    return (tokens, torch.as_tensor(route, device=tokens.device),
            torch.as_tensor(np.broadcast_to(cmask[None], (n, n)).copy(),
                            device=tokens.device))


def _ep_plan():
    """23d's dispatch plan: the compiled all-to-all of a pod of 4
    machines x 2 chips."""
    from bluefog_tpu_torch import moe
    from bluefog_tpu_torch.topology.compiler import (PodSpec,
                                                     compile_all_to_all)

    return moe.dispatch_plan(compile_all_to_all(PodSpec(4, 2)).schedule)


def _ep_schedule():
    """23d's neighbor mixing: one-peer exp2 rounds on the (4, 2) torus."""
    from bluefog_tpu_torch.topology.torus import torus_one_peer_schedule

    return torus_one_peer_schedule((4, 2), "exp2")


def _ep_cycle(backend, dev, seed, d, h, t, steps_after=0, draw="cuda"):
    """The expert-sharded step over ``backend`` (``EP_RANKS`` ranks,
    ``EP_EXPERTS`` experts, f32 params drawn per rank from --seed,
    SGD(1e-3, momentum 0.9), atc with guard and health) at width
    ``d``/``h``, ``t`` tokens a rank: steps 0 (every rank live), 1 (rank
    5 dead, the route healed), 2 (it returns), then ``steps_after`` live
    steps.  The params and tokens are drawn on ``draw`` (the host, for
    runs on two devices to start alike) and moved to ``dev``.  Returns
    (step, params, optimizer, the live batch, losses, the router's
    spread before)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch import moe

    n, E = EP_RANKS, EP_EXPERTS
    cap = moe.default_capacity(t, n)
    plan = _ep_plan()
    g = torch.Generator(draw).manual_seed(seed)
    params = {k: v.to(dev) for k, v in moe.init_moe_params(
        g, d, h, E, n_ranks=n, device=draw).items()}
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(
        moe.make_moe_loss(plan, backend, cap), opt, backend,
        comm_mode="atc", schedule=_ep_schedule(),
        guard=bt.GuardConfig(), health=bt.HealthConfig(),
        moe=bt.MoEConfig(E, cap))
    tokens = torch.randn(n, t, d, generator=g, device=draw).to(dev)
    route = moe.default_route_table(n, E)
    dead = np.zeros(n, bool)
    dead[5] = True
    live = _ep_batch(tokens, route, moe.capacity_mask_of(np.zeros(n)), n)
    healed = _ep_batch(tokens, moe.heal_route_table(route, dead, E),
                       moe.capacity_mask_of(dead), n)
    rw = params["router.w"]
    spread0 = (rw - rw.mean(0)).abs().max().item()
    w = step.default_comm_weights
    losses = []
    for i, b in enumerate([live, healed] + [live] * (1 + steps_after)):
        params, opt, loss, skipped, hv = step(params, opt, b, i, w)
        losses.append(loss)
    return step, params, opt, live, torch.stack(losses), spread0


def _ep_experts_local(step, params, opt, batch, i):
    """From one state, step ``i`` with the schedule's weights and again
    with the identity combine (self weight 1, neighbors 0): every expert
    leaf must come out bit-equal, so each rank's experts moved by their
    own update alone, and the router must not.  Leaves the identity
    step's state.  Returns what was compared, for the log."""
    w = step.default_comm_weights
    ident = tuple((torch.zeros_like(cw), torch.ones_like(sw))
                  for cw, sw in w)
    start = ({k: v.clone() for k, v in params.items()},
             [s["momentum_buffer"].clone() for s in opt.state.values()])
    mixed = {}
    for weights in (w, ident):
        with torch.no_grad():
            for k, v in start[0].items():
                params[k].copy_(v)
            for st, m in zip(opt.state.values(), start[1]):
                st["momentum_buffer"].copy_(m)
        params, opt, *_ = step(params, opt, batch, i, weights)
        if not mixed:
            mixed = {k: v.clone() for k, v in params.items()}
    experts = [k for k in params if k.startswith("expert.")]
    moved = [k for k in experts
             if not torch.equal(params[k], start[0][k])]
    same = [k for k in experts if torch.equal(params[k], mixed[k])]
    router_same = torch.equal(params["router.w"], mixed["router.w"])
    if moved != experts or same != experts or router_same:
        raise AssertionError(
            f"23d: of {experts}, updated {moved}, equal under the identity "
            f"combine {same}; the router equal under it: {router_same}")
    return (f"{', '.join(experts)} bit-equal to a step under the identity "
            f"combine, the router not")


def _phase23_ep(seed):
    """23d: the expert-sharded step at Mixtral's expert width over 8
    stacked ranks."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch import moe
    from bluefog_tpu_torch.observe import fleet

    n = EP_RANKS
    backend = bt.StackedBackend(n, device="cuda")
    cap = moe.default_capacity(EP_TOKENS, n)
    plan = _ep_plan()
    g = torch.Generator("cuda").manual_seed(seed + 1)
    x = torch.randn(n, n, cap, EP_DIM, generator=g, device="cuda")
    got = moe.all_to_all_dispatch(x, plan, backend)
    if not torch.equal(got, moe.naive_all_to_all(x, backend)):
        raise AssertionError("23d: the compiled dispatch differs from the "
                             "naive all-to-all")
    if not torch.equal(moe.all_to_all_dispatch(got, plan.transpose(),
                                                backend), x):
        raise AssertionError("23d: the transpose round trip is not the "
                             "identity")
    q1 = moe.all_to_all_dispatch(x, plan, backend, wire_dtype="int8")
    q2 = moe.all_to_all_dispatch(x, plan, backend, wire_dtype="int8")
    # half a code of the largest scale, plus the f32 rounding of the
    # dequantized product (half an ulp of the largest value)
    err = (q1 - got).abs().max().item()
    limit = x.abs().max().item() * (1 / 254 + 2 ** -24)
    if not torch.equal(q1, q2) or err > limit:
        raise AssertionError(f"23d: int8 wire repeatable "
                             f"{torch.equal(q1, q2)}, error {err} against "
                             f"half a code {limit}")
    del q1, q2, got
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    ms = {name: time_ms(fn, flush, reps=10) for name, fn in (
        ("compiled", lambda: moe.all_to_all_dispatch(x, plan, backend)),
        ("naive", lambda: moe.naive_all_to_all(x, backend)),
        ("int8", lambda: moe.all_to_all_dispatch(x, plan, backend,
                                                 wire_dtype="int8")))}
    shard = cap * EP_DIM * 4
    wire = n * (n - 1) * shard
    log(f"[moe23d] dispatch of [{n}, {n}, {cap}, {EP_DIM}] f32 over "
        f"compile_all_to_all(PodSpec(4, 2)) ({plan.permutes_per_period} "
        f"permutes): bit-equal to the naive all-to-all, round trip exact, "
        f"int8 repeatable within half a code ({err:.4g} <= {limit:.4g}); "
        f"compiled {ms['compiled']:.3f} ms, naive {ms['naive']:.3f} ms, "
        f"int8 {ms['int8']:.3f} ms; {wire / 1e6:.1f} MB on the wire a "
        f"dispatch (f32)")
    del x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    traffic0 = fleet.traffic_snapshot()
    timed = 3
    step, params, opt, live, losses, spread0 = _ep_cycle(
        backend, "cuda", seed, EP_DIM, EP_HIDDEN, EP_TOKENS)
    w = step.default_comm_weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 3 + timed):
        params, opt, loss, skipped, hv = step(params, opt, live, i, w)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    syncs = _count_syncs(lambda: step(params, opt, live, 3 + timed, w))
    steps = 4 + timed
    sched = _ep_schedule()
    router_bytes = params["router.w"][0].numel() * 4
    want = {}
    for i in range(steps):
        for e in fleet.edge_list(sched[i % len(sched)]):
            want[e] = want.get(e, 0.0) + router_bytes
    billed = fleet.traffic_snapshot(since=traffic0)
    rw = params["router.w"]
    spread = (rw - rw.mean(0)).abs().max().item()
    if not (torch.isfinite(torch.cat([losses, loss[None]], 0)).all()
            and syncs == 0 and billed == want and spread < spread0):
        raise AssertionError(
            f"23d: losses {losses.tolist()}, host syncs {syncs}, edge "
            f"account {billed} (want {want}), router spread {spread0} -> "
            f"{spread}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    local = _ep_experts_local(step, params, opt, live, 4 + timed)
    a2a = 4 * wire   # dispatch and return, forward and backward
    log(f"[moe23d] expert-sharded step, {n} ranks x {EP_TOKENS} tokens, "
        f"d {EP_DIM}, hidden {EP_HIDDEN}, {EP_EXPERTS} experts (two "
        f"replicas each), capacity {cap}, atc over torus_one_peer_schedule("
        f"(4, 2), 'exp2') with guard and health: kill of rank 5 -> heal -> "
        f"return on one step object, mean losses "
        f"{', '.join(f'{x:.5f}' for x in losses.mean(1).tolist())}; "
        f"steady step "
        f"{dt * 1e3:.2f} ms, {syncs} host syncs; router spread {spread0:.4g}"
        f" -> {spread:.4g}, experts rank-local ({local}); wire a step: "
        f"{a2a / 1e9:.3f} GB of all-to-all, {sum(want.values()) / steps:.0f}"
        f" B of mixing (the router only, as bf_edge_bytes_total bills); "
        f"peak {peak:.2f} GiB")
    del step, params, opt, live
    torch.cuda.empty_cache()


def _phase23_reference(seed):
    """23e: card against host: the tiny f32 MoE Llama (flash, D = 16, both
    routers, capacity drops) forward and gradients, and a tiny 23d cycle
    over 8 stacked ranks, each within phase 10's bound (1e-4 of each
    leaf's largest entry plus 1e-7, losses 1e-5)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_loss_fn

    def close(what, got, want):
        worst = 0.0
        for k, w in want.items():
            scale = w.abs().max().item()
            err = (got[k] - w).abs().max().item()
            worst = max(worst, err / max(scale, 1e-12))
            if err > 1e-4 * scale + 1e-7:
                raise AssertionError(f"23e {what}: {k} differs by {err} "
                                     f"(largest entry {scale})")
        return worst

    for router in ("topk", "expert_choice"):
        cfg = bt.LlamaConfig.tiny(
            dtype=torch.float32, attn_impl="flash", n_experts=4,
            moe_top_k=2, capacity_factor=0.5, moe_aux_weight=0.01,
            moe_router=router,
            allow_noncausal_router=router == "expert_choice")
        init = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(seed)
                        ).state_dict()
        raw = torch.from_numpy(np.random.RandomState(seed).randint(
            0, cfg.vocab_size, (2, 33)))
        out = {}
        for dev in ("cuda", "cpu"):
            model = bt.Llama(cfg, device=dev, param_dtype=torch.float32)
            model.load_state_dict(init)
            params = {k: v.requires_grad_(True)
                      for k, v in model.state().items()}
            _reset_counts()
            loss = llama_loss_fn(model)(params, (raw[:, :-1].to(dev),
                                                 raw[:, 1:].to(dev)))
            grads = torch.autograd.grad(loss, list(params.values()))
            if dev == "cuda":
                _expect_launches(f"23e tiny MoE Llama ({router})",
                                 dict.fromkeys(FLASH_KERNELS, cfg.n_layers))
            elif any(_launches().values()):
                raise AssertionError("23e: the host run launched a kernel")
            out[dev] = (loss.item(), {k: g.cpu() for k, g in
                                      zip(params, grads)})
        worst = close(f"tiny MoE Llama ({router})", out["cuda"][1],
                      out["cpu"][1])
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        if loss_err > 1e-5:
            raise AssertionError(f"23e: losses differ by {loss_err}")
        log(f"[moe23e] tiny f32 MoE Llama ({router}, capacity factor 0.5, "
            f"flash D=16): card vs host gradients agree to {worst:.3g} of "
            f"each leaf's largest entry, losses to {loss_err:.3g}")
    out = {}
    for dev in ("cuda", "cpu"):
        backend = bt.StackedBackend(EP_RANKS, device=dev)
        _, params, _, _, losses, _ = _ep_cycle(backend, dev, seed, 16, 32,
                                               12, steps_after=1,
                                               draw="cpu")
        out[dev] = ({k: v.cpu() for k, v in params.items()}, losses.cpu())
    worst = close("tiny expert-sharded cycle", out["cuda"][0], out["cpu"][0])
    loss_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    if loss_err > 1e-5:
        raise AssertionError(f"23e: cycle losses differ by {loss_err}")
    log(f"[moe23e] tiny expert-sharded cycle (8 ranks, d 16, hidden 32, 12 "
        f"tokens a rank; kill, heal, return and a live step): card vs host "
        f"params agree to {worst:.3g} of each leaf's largest entry, losses "
        f"to {loss_err:.3g}")


def phase_moe(seed):
    """Phase 23 (see the module docstring).  Returns the launches of its
    counted runs (K2, K3a, K3b from 23a and 23b; K4 and K2 from 23c)."""
    t0 = time.perf_counter()
    launches = {}
    for part in (_phase23_train, _phase23_ranks, _phase23_serve):
        for k, n in part(seed).items():
            launches[k] = launches.get(k, 0) + n
    _phase23_ep(seed)
    _phase23_reference(seed)
    log(f"[moe23] phase 23 in {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ #
# phase 24: the topology control plane and the fleet simulator
# ------------------------------------------------------------------ #
P24_RANKS, P24_BATCH = 8, 32     # 8 stacked ranks of 32 images (22b's shape)
P24_STEPS, P24_EVERY = 22, 12    # 24a's steps; checkpoints at 0 and 12
P24_CONGEST, P24_KILL = 2, 13    # DCN links slow from step 2; 6, 7 die at 13
P24_SHIFTS = (1, 2, 4, 6, 7)     # the carrier's declared shifts
P24_WIRE_UNIT = 1e-3             # virtual seconds per unit of pod cost
P24_REQS = 12                    # 24b's requests


def _p24_pod(TT):
    return TT.PodSpec(4, 2, ici_cost=1.0, dcn_cost=4.0)


def _p24_carrier(TT):
    """4 rounds, each declaring the full permutations of shifts 1, 2, 4,
    6 and 7: every candidate of the plane is weight data over them."""
    w = 1.0 / (len(P24_SHIFTS) + 1)
    ew = {(i, (i + s) % P24_RANKS): w for s in P24_SHIFTS
          for i in range(P24_RANKS)}
    return [TT.DynamicTopology.from_edges(P24_RANKS, ew,
                                          [w] * P24_RANKS)] * 4


def _p24_initial(TT):
    """The running plan: three machine-ring DCN rounds and one ICI round
    a period (benchmarks/chaos_adaptive_topology.py's incumbent)."""
    def dcn(direction):
        order = list(range(4)) if direction > 0 else [3, 2, 1, 0]
        pairs = TT.expand_machine_pairs(
            [(order[i], order[(i + 1) % 4]) for i in range(4)], 2)
        return TT.DynamicTopology.from_edges(
            P24_RANKS, {p: 0.5 for p in pairs}, [0.5] * P24_RANKS)

    ici = {}
    for m in range(4):
        ici[(2 * m, 2 * m + 1)] = ici[(2 * m + 1, 2 * m)] = 0.5
    return [dcn(+1), TT.DynamicTopology.from_edges(
        P24_RANKS, ici, [0.5] * P24_RANKS), dcn(+1), dcn(-1)]


def _p24_congestion(R):
    """The DCN links of machine link 0 -> 1 (rank pairs (0, 2) and
    (1, 3)) carry bytes 4x slower from step P24_CONGEST on."""
    plan = R.FaultPlan.congest_link(P24_RANKS, 0, 2, 4.0,
                                    start=P24_CONGEST, duration=1000)
    return plan.merged(R.FaultPlan.congest_link(
        P24_RANKS, 1, 3, 4.0, start=P24_CONGEST, duration=1000))


def _p24_plane(TT, registry):
    return TT.TopologyControlPlane(
        _p24_pod(TT), _p24_carrier(TT), registry=registry, window=4,
        patience=2, degrade_ratio=1.3, margin=0.05, cooldown=4,
        probation=3, rollback_tolerance=4.0, contention=3.0,
        synchronous=True, initial=_p24_initial(TT))


def _p24_wire(S, TT, plane, registry, plan, dead_fn):
    return S.LinkWire(
        _p24_pod(TT), registry,
        schedule_fn=lambda s: plane.active_schedule()[s % 4],
        dead_fn=dead_fn, congestion_fn=plan.congested_links,
        wire_unit=P24_WIRE_UNIT, period=4)


def _p24_sim_events(steps):
    """The port's SimTrainingFleet on 24a's congestion (no deaths) over
    ``steps`` steps: its topology events as (kind, step, detail)."""
    import bluefog_tpu_torch.resilience as R
    from bluefog_tpu_torch import sim as S
    from bluefog_tpu_torch import topology as TT
    from bluefog_tpu_torch.observe.registry import MetricsRegistry

    reg = MetricsRegistry()
    plan = _p24_congestion(R)
    plane = _p24_plane(TT, reg)
    wire = _p24_wire(S, TT, plane, reg, plan,
                     lambda: np.zeros(P24_RANKS, bool))
    fleet = S.SimTrainingFleet(
        control=plane, wire=wire, fault_plan=plan,
        cost=S.CostModel(train_step_s=1e-3, wire_unit_s=P24_WIRE_UNIT))
    fleet.run(steps)
    return [e for e in fleet.events if e[0].startswith("topology_")]


def _p24_control(cfg, dev, seed, tmp):
    """24a: ViT ``cfg`` over 8 stacked ranks on ``dev`` under
    run_resilient(control=TopologyControlPlane(...)): a LinkWire bills the
    plane's registry from a plan that congests one DCN link (trigger,
    swap, commit), then kills ranks 6 and 7 (rank_dead, rollback,
    membership trigger, swap, commit).  Returns a dict of the run's
    results and measurements."""
    import torch.nn.functional as F

    import bluefog_tpu_torch as bt
    import bluefog_tpu_torch.resilience as R
    from bluefog_tpu_torch import sim as S
    from bluefog_tpu_torch import topology as TT
    from bluefog_tpu_torch.checkpoint import Checkpointer
    from bluefog_tpu_torch.observe.registry import MetricsRegistry
    from bluefog_tpu_torch.topology import control as TC

    model = bt.ViT(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    backend = bt.StackedBackend(P24_RANKS, device=dev)
    params = bt.rank_major(model.state(), backend)
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    carrier = _p24_carrier(TT)

    def loss_fn(p, b):
        return F.cross_entropy(model.apply(p, b[0]), b[1])

    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               schedule=carrier, guard=bt.GuardConfig())
    g = torch.Generator(dev).manual_seed(seed + 24)
    size = cfg.image_size
    batches = [(torch.rand(P24_RANKS, P24_BATCH, size, size, 3, generator=g,
                           device=dev).mul_(2).sub_(1).to(cfg.dtype),
                torch.randint(0, cfg.num_classes, (P24_RANKS, P24_BATCH),
                              generator=g, device=dev)) for _ in range(4)]

    reg = MetricsRegistry()
    plan = _p24_congestion(R).merged(R.FaultPlan(P24_RANKS, [
        R.Fault(P24_KILL, 6, "dead"), R.Fault(P24_KILL, 7, "dead")]))
    plane = _p24_plane(TT, reg)
    det = R.FailureDetector(P24_RANKS)
    wire = _p24_wire(S, TT, plane, reg, plan, det.dead_mask)

    def batch_fn(s):
        # a pure function of the step; the wire bills each step call
        wire.bill(s)
        return batches[s % len(batches)]

    ref = [(tuple(cw.shape), tuple(sw.shape), cw.dtype)
           for cw, sw in step.default_comm_weights]
    pending, calls, delivered = [], [], []

    def recorded(p, o, batch, i, weights):
        # one step object; carrier-shaped weights at every call, and the
        # first call after a swap or rollback runs swap_comm_weights
        if [(tuple(cw.shape), tuple(sw.shape), cw.dtype)
                for cw, sw in weights] != ref:
            raise AssertionError(f"24a: step {i} got weights shaped "
                                 f"unlike the carrier's")
        if pending:
            want = pending.pop()
            for (cw, sw), (wcw, wsw) in zip(weights, want, strict=True):
                if not (torch.equal(cw.cpu(), wcw.cpu())
                        and torch.equal(sw.cpu(), wsw.cpu())):
                    raise AssertionError(
                        f"24a: step {i} after a swap ran weights other "
                        f"than swap_comm_weights(plane, dead)")
            delivered.append(i)
        calls.append((i, time.perf_counter()))
        return step(p, o, batch, i, weights)

    for attr in ("default_comm_weights", "backend", "guard_config"):
        setattr(recorded, attr, getattr(step, attr))

    def on_event(ev):
        if ev.kind in ("topology_swap", "topology_rollback"):
            pending.append(TC.swap_comm_weights(plane, det.dead_mask()))

    on_step_ms = []
    plane_on_step = plane.on_step

    def timed_on_step(*a, **k):
        t0 = time.perf_counter()
        out = plane_on_step(*a, **k)
        on_step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    plane.on_step = timed_on_step
    ck = Checkpointer(tempfile.mkdtemp(prefix="ck24a_", dir=tmp),
                      max_to_keep=1)
    if dev == "cuda":
        torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = R.run_resilient(
        recorded, params, opt, batch_fn, steps=P24_STEPS, checkpointer=ck,
        schedule=carrier,
        guard=bt.GuardConfig(max_consecutive_bad=3, backoff_base=0.0),
        fault_plan=plan, detector=det, checkpoint_every=P24_EVERY,
        sleep=lambda s: None, on_event=on_event, control=plane)
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ck.close()
    # a step's wall in the loop: from its call to the next call (the
    # runner's host transfer, bookkeeping and on_step included); a
    # replayed step keeps its first run's
    walls = {}
    for (i, t), (_, t_next) in zip(calls, calls[1:]):
        walls.setdefault(i, t_next - t)
    return dict(res=res, plane=plane, calls=calls, delivered=delivered,
                on_step_ms=on_step_ms, wall=wall, walls=walls,
                params=params, dead=det.dead_mask(), model=model)


def _p24_check_control(out, what):
    """24a's asserts: trigger (degraded) -> swap -> commit at the sim's
    steps with the sim's candidate and costs; rank_dead 6 and 7, the
    rollback, a membership trigger -> swap -> commit; every swap's
    weights delivered; the live ranks finite."""
    import bluefog_tpu_torch.resilience as R

    res, plane = out["res"], out["plane"]
    ev = res.events
    first_dead = next(i for i, e in enumerate(ev) if e.kind == "rank_dead")
    real = [(e.kind, e.step, e.detail) for e in ev[:first_dead]
            if e.kind.startswith("topology_")]
    sim = _p24_sim_events(P24_KILL)
    if real != sim:
        raise AssertionError(f"{what}: the real run's decisions {real} "
                             f"differ from SimTrainingFleet's {sim}")
    kinds = [(e.kind, e.step) for e in ev if e.kind.startswith("topology_")]
    if [k for k, _ in kinds] != ["topology_trigger", "topology_swap",
                                 "topology_commit"] * 2:
        raise AssertionError(f"{what}: topology events {kinds}")
    reasons = [e.detail["reason"] for e in ev
               if e.kind == "topology_trigger"]
    if reasons != ["degraded", "membership"]:
        raise AssertionError(f"{what}: trigger reasons {reasons}")
    dead = [e.detail["rank"] for e in ev if e.kind == "rank_dead"]
    rb = [e for e in ev if e.kind == "rollback"]
    if dead != [6, 7] or len(rb) != 1 \
            or rb[0].detail["restored_step"] != P24_EVERY:
        raise AssertionError(f"{what}: deaths {dead}, rollbacks {rb}")
    swaps = [e.step for e in ev if e.kind == "topology_swap"]
    if out["delivered"] != swaps or plane.swaps != 2 or plane.rollbacks:
        raise AssertionError(f"{what}: swaps at {swaps}, weights checked "
                             f"at {out['delivered']}")
    if res.step != P24_STEPS or list(np.flatnonzero(res.dead_mask)) != [6, 7]:
        raise AssertionError(f"{what}: ends at {res.step}, dead "
                             f"{np.flatnonzero(res.dead_mask)}")
    if not R.update_health(res.params)[~res.dead_mask].all():
        raise AssertionError(f"{what}: non-finite live params")
    return real, kinds


def _p24a(seed, tmp):
    """24a on the card at ViT-B/16's full width and depth.  Returns its
    K2/K3a/K3b launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.topology import control as TC

    cfg = bt.ViTConfig.base(attn_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = _p24_control(cfg, "cuda", seed, tmp)
    n_calls = len(out["calls"])
    launches = _expect_flash("24a", cfg.depth * P24_RANKS * n_calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    real, kinds = _p24_check_control(out, "24a")
    swap_at = real[1][1]
    walls = out["walls"]
    before = [walls[s] for s in range(3, swap_at)]
    after = [walls[s] for s in range(swap_at, P24_KILL)]
    imgs = P24_RANKS * P24_BATCH
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    live = ~out["dead"]
    health_ms = time_ms(lambda: TC._consensus_distance(out["params"], live),
                        flush, reps=9)
    health = TC._consensus_distance(out["params"], live)
    swap = real[1][2]
    n_params = sum(v[0].numel() for v in out["params"].values())
    log(f"[ctl24a] ViT-B/16 ({n_params / 1e6:.1f} M params a rank), "
        f"{P24_RANKS} stacked ranks x {P24_BATCH} images, "
        f"guarded atc over a 4-round carrier of shifts {P24_SHIFTS}, "
        f"run_resilient(control=TopologyControlPlane(PodSpec(4, 2), "
        f"synchronous=True)) {P24_STEPS} steps ({n_calls} step calls, "
        f"replays included) in {out['wall']:.2f} s; a LinkWire bills "
        f"DCN links (0, 2), (1, 3) 4x slow from step {P24_CONGEST}: "
        f"events {kinds}; the congestion swap to {swap['schedule']} at "
        f"cost-to-consensus {swap['cost_to_consensus']:.6g} against the "
        f"incumbent's {swap['incumbent']:.6g}, the same decisions at the "
        f"same steps as SimTrainingFleet; ranks 6, 7 dead at step "
        f"{P24_KILL}, rollback to {P24_EVERY}, membership swap to "
        f"{out['plane'].active_name()}; every swap's weights equal "
        f"swap_comm_weights(plane, dead) at steps {out['delivered']}; "
        f"step wall p50 before the swap "
        f"{1e3 * statistics.median(before):.2f} ms "
        f"({imgs / statistics.median(before):.1f} img/s per card), after "
        f"{1e3 * statistics.median(after):.2f} ms "
        f"({imgs / statistics.median(after):.1f} img/s; the step's work "
        f"does not change with the weights); on_step host ms p50 "
        f"{statistics.median(out['on_step_ms']):.3f}, max "
        f"{max(out['on_step_ms']):.3f} over {len(out['on_step_ms'])} "
        f"boundaries; one probation health read (consensus distance "
        f"{health:.4g} over the 6 live ranks, float64 on the card, one "
        f"transfer) {health_ms:.3f} ms by CUDA events; peak memory "
        f"{peak:.2f} GiB; launches {launches} = 12 layers x {P24_RANKS} "
        f"ranks x {n_calls} step calls each")
    del out
    torch.cuda.empty_cache()
    return launches


def _p24_lockstep(model, cfg, trace, step_s, eng_kw, seed):
    """The real fleet of 24b: FLEET engines on one VirtualClock behind
    FleetRouter, one poll a tick with arrivals, each tick stepping every
    engine and advancing the clock ``step_s``."""
    from bluefog_tpu_torch import sim as S
    from bluefog_tpu_torch.observe.registry import MetricsRegistry
    from bluefog_tpu_torch.serving import FleetRouter, Request, ServingEngine

    clock = S.VirtualClock()
    regs = [MetricsRegistry() for _ in range(FLEET)]
    engines = [ServingEngine(model, cfg, clock=clock, registry=regs[i],
                             **eng_kw) for i in range(FLEET)]
    router = FleetRouter(engines, registries=regs, clock=clock,
                         sleep=clock.advance, seed=seed)
    rs = np.random.RandomState(seed)
    reqs = [Request(rs.randint(0, cfg.vocab_size,
                               (int(trace.prompt_lens[k]),)).astype(np.int32),
                    int(trace.budgets[k]), rid=k) for k in range(trace.n)]
    dead = np.zeros(FLEET, bool)
    route, ticks, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        if i < trace.n and trace.arrivals[i] <= clock.t:
            snap = router.poll(dead_mask=dead)
            while i < trace.n and trace.arrivals[i] <= clock.t:
                j, _ = router.submit(reqs[i], snapshot=snap, dead_mask=dead)
                route.append(j)
                i += 1
        if not any(e._running or e._admitting or e.scheduler.queue_depth
                   for e in engines):
            if i >= trace.n:
                break
            clock.jump_to(float(trace.arrivals[i]))
            continue
        for e in engines:
            e.step()
        clock.advance(step_s)
        ticks += 1
        if ticks > 5000:
            raise AssertionError("24b: the real fleet did not drain")
    wall = time.perf_counter() - t0
    _check_done(reqs, "24b", engines)
    return dict(route=route, ticks=ticks, makespan=clock.t, wall=wall,
                tokens=[len(r.tokens) for r in reqs],
                ttfts=sorted(t for e in engines for t in e.metrics.ttfts()),
                decode_steps=sum(e.metrics.summary()["decode_steps"]
                                 for e in engines))


def _p24_fleet(model, cfg, dev, seed):
    """24b's runs over ``model``: measure_step_cost on one engine at full
    slots (a timer injected), then the real lockstep fleet and
    SimServingFleet under a CostModel with that cost, on one trace from
    the port's poisson_arrivals and one router seed; every routing
    decision, the ticks, makespan, tokens and TTFTs must agree exactly.
    Returns (step seconds, the real run, the sim's summary, decode steps
    of every engine)."""
    import re

    from bluefog_tpu_torch import sim as S
    from bluefog_tpu_torch.benchutil import poisson_arrivals
    from bluefog_tpu_torch.observe.registry import MetricsRegistry
    from bluefog_tpu_torch.serving import ServingEngine

    rng = np.random.RandomState(seed + 24)
    eng_kw = dict(capacity=SERVE_CAP, max_len=2048, prefill_chunk=256,
                  max_queue=64, device=dev)
    probe = ServingEngine(model, cfg, registry=MetricsRegistry(), **eng_kw)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(16, 257, SERVE_CAP)]
    # every slot admitted (one prefill chunk a step) before the timed steps
    step_s = S.measure_step_cost(probe, prompts, timer=time.perf_counter,
                                 new_tokens=32, warmup=SERVE_CAP + 1,
                                 reps=12)
    if len(probe._running) != SERVE_CAP:
        raise AssertionError("24b: the cost was not measured at full slots")
    probe_steps = probe.metrics.summary()["decode_steps"]
    del probe
    cost = S.CostModel(step_s=step_s, gossip_round_s=0.0)
    trace = S.RequestTrace.build(
        poisson_arrivals(0.5 / step_s, P24_REQS, seed), seed=seed + 1,
        prompt_len=(16, 256), new_tokens=(8, 32))
    real = _p24_lockstep(model, cfg, trace, step_s, eng_kw, seed + 11)
    clock = S.VirtualClock()
    sim_kw = {k: v for k, v in eng_kw.items() if k != "device"}
    reps = [S.SimReplica(f"replica-{i}", clock=clock, cost=cost, **sim_kw)
            for i in range(FLEET)]
    fleet = S.SimServingFleet(reps, cost=cost,
                              sim=S.Simulation(clock=clock,
                                               log=S.EventLog()),
                              router_kwargs=dict(seed=seed + 11))
    s = fleet.run(trace)
    route_re = re.compile(r" route replica-(\d+) rid=(\d+)$")
    sim_route = {}
    for line in fleet.log.lines:
        m = route_re.search(line)
        if m:
            sim_route[int(m.group(2))] = int(m.group(1))
    sim_ttfts = sorted(
        v for rep in fleet.replicas
        for name, kind, _h, _l, m in rep.registry.collect()
        if name == "bf_serving_ttft_seconds" and kind == "histogram"
        for v in m.window_values)
    if [sim_route.get(k) for k in range(trace.n)] != real["route"] \
            or s["ticks"] != real["ticks"] \
            or s["virtual_seconds"] != real["makespan"] \
            or s["tokens_total"] != float(sum(real["tokens"])) \
            or real["tokens"] != [int(b) for b in trace.budgets] \
            or sim_ttfts != real["ttfts"]:
        raise AssertionError(
            f"24b: sim and real fleets part: routes {sim_route} / "
            f"{real['route']}, ticks {s['ticks']} / {real['ticks']}, "
            f"makespan {s['virtual_seconds']} / {real['makespan']}, tokens "
            f"{s['tokens_total']} / {sum(real['tokens'])}")
    if len(set(real["route"])) != FLEET:
        raise AssertionError(f"24b: a replica took no request: "
                             f"{real['route']}")
    return step_s, trace, real, s, probe_steps + real["decode_steps"]


def _p24b(seed):
    """24b: Llama-3.1-8B at full width and depth in bf16, as phase 20
    builds it, through _p24_fleet.  Returns its K4 launches."""
    import bluefog_tpu_torch as bt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3")
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    _reset_counts()
    step_s, trace, real, s, decode_steps = _p24_fleet(model, cfg, "cuda",
                                                      seed)
    torch.cuda.synchronize()
    k4 = _expect_launches("24b", {"decode_attention":
                                  cfg.n_layers * decode_steps})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[sim24b] Llama-3.1-8B bf16 (32 layers), engines at capacity "
        f"{SERVE_CAP}, max_len 2048, prefill chunk 256: measure_step_cost "
        f"at full slots {1e3 * step_s:.3f} ms a step (median of 12, "
        f"time.perf_counter); {FLEET} real replicas on one VirtualClock "
        f"behind FleetRouter and SimServingFleet under CostModel(step_s="
        f"{step_s:.6g}) on one trace ({trace.n} Poisson arrivals at "
        f"{0.5 / step_s:.2f}/s, prompts 16-256, 8-32 new tokens), router "
        f"seed {seed + 11}: routes bit-equal "
        f"{[real['route'].count(r) for r in range(FLEET)]} a replica, "
        f"{real['ticks']} ticks each, simulated makespan "
        f"{s['virtual_seconds']:.6f} s (the real drive's virtual "
        f"{real['makespan']:.6f} s, its wall {real['wall']:.2f} s), "
        f"{int(s['tokens_total'])} tokens, TTFT p50 "
        f"{1e3 * s['ttft_p50_vs']:.3f} virtual ms in both; peak memory "
        f"{peak:.2f} GiB; K4 launches {k4['decode_attention']}")
    del model
    torch.cuda.empty_cache()
    return k4


def phase_control(seed):
    """Phase 24 (see the module docstring).  Returns its launches."""
    import shutil

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bf_phase24_")
    try:
        launches = _p24a(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches.update(_p24b(seed))
    log(f"[ctl24] phase 24 in {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ #
# phase 25: the model axes (tensor parallelism, experts over an ep
# axis, TP decode), the tp shards stacked on the one card
# ------------------------------------------------------------------ #
TP_SIZE = 2
# step 0 held to the unsharded (tp 1 / ep 1) model on the same params:
# |loss - loss_1| and, for every leaf, max |g - g_1| over max |g_1|
# (bf16 compute: the shards' row-parallel partials are rounded to bf16
# before the psum, one product's output rounding more than tp 1's)
TP_LOSS_LIMIT = 2e-3
TP_GRAD_LIMIT = 0.1
TP_LAYERS = 4            # 25a's depth: phase 8's
TP_PROMPTS, TP_PROMPT_LEN, TP_NEW = 8, 120, 8   # 25b


def _loss_grads(model, params, batch, axis=None, loss_fn=None):
    """Step 0 of ``model`` (or of ``loss_fn``, whose per-stage losses
    are summed) on one rank's ``params`` and ``batch``: the loss and
    every leaf's gradient, the axis bound."""
    from bluefog_tpu_torch.models.llama import llama_loss_fn
    import bluefog_tpu_torch as bt

    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad(), (bt.bind_axis(axis) if axis is not None
                               else contextlib.nullcontext()):
        loss = (loss_fn or llama_loss_fn(model))(p, batch).sum()
        grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), dict(zip(p, grads))


def _tp_gap(loss, grads, ref_loss, ref_grads):
    """(|loss - ref|, the worst leaf's max |g - ref| over max |ref|, that
    leaf)."""
    worst, leaf = 0.0, None
    for k, want in ref_grads.items():
        scale = max(want.abs().max().item(), 1e-30)
        r = (grads[k] - want).abs().max().item() / scale
        if r > worst:
            worst, leaf = r, k
    return abs(loss - ref_loss), worst, leaf


def _first_layer(model, cfg):
    """A twin of ``model`` (its parameters shared) that runs ``cfg``'s
    first layer alone."""
    twin = model.retarget(dataclasses.replace(cfg, n_layers=1))
    twin.layers = torch.nn.ModuleList(list(twin.layers)[:1])
    return twin


def _hold_to_unsharded(label, model, cfgs, params, batch, axis, plant,
                       retarget=None):
    """Step 0 of each of ``cfgs`` ({label: config of ``model``'s params})
    with ``axis`` bound, held to ``model``'s own config unbound within
    TP_LOSS_LIMIT / TP_GRAD_LIMIT; ``plant`` (label, {name: tensor}) is a
    fault in the first config's shards that the limits must reject.
    ``retarget(model, cfg)`` builds each config's twin (default
    ``model.retarget``).  Returns {label: (loss gap, grad gap)}."""
    if retarget is None:
        retarget = lambda m, c: m.retarget(c)  # noqa: E731
    ref_loss, ref_grads = _loss_grads(model, params, batch)
    gaps = {}
    for what, cfg in cfgs.items():
        loss, grads = _loss_grads(retarget(model, cfg), params, batch, axis)
        gap, worst, leaf = _tp_gap(loss, grads, ref_loss, ref_grads)
        del grads
        log(f"{label} {what}: step-0 loss {loss:.6f} against the unsharded "
            f"{ref_loss:.6f} (|gap| {gap:.3g}, limit {TP_LOSS_LIMIT}); "
            f"gradients within {worst:.3g} of each leaf's largest entry "
            f"(worst {leaf}; limit {TP_GRAD_LIMIT})")
        if not (gap <= TP_LOSS_LIMIT and worst <= TP_GRAD_LIMIT):
            raise AssertionError(f"{label} {what}: step 0 differs from the "
                                 f"unsharded model's (loss {gap}, grad "
                                 f"{worst} at {leaf})")
        gaps[what] = (gap, worst)
    fault, change = plant
    bad = dict(params, **change)
    loss, grads = _loss_grads(retarget(model, next(iter(cfgs.values()))),
                              bad, batch, axis)
    gap, worst, leaf = _tp_gap(loss, grads, ref_loss, ref_grads)
    del grads, bad
    log(f"{label} planted fault, {fault}: loss gap {gap:.3g}, gradients "
        f"{worst:.3g} of the leaf's largest entry ({leaf}): rejected")
    if gap <= TP_LOSS_LIMIT and worst <= TP_GRAD_LIMIT:
        raise AssertionError(f"{label}: the limits pass a planted fault "
                             f"({fault})")
    del ref_grads
    torch.cuda.empty_cache()
    return gaps


def _p25_train(seed):
    """25a: Llama-3.1-8B's width at phase 8's depth and batch, tp 2 on the
    one card (the shards stacked): step 0 held to tp 1 on the same
    params (tp 2, and tp 2 with vocab_parallel + tp_seq_shard), a planted
    fault (one shard's slice of layer 0's wq zeroed) rejected; then
    training windows at dp 1 (both layouts) and dp 2 x tp 2 under atc.
    Returns the windows' launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import llama_param_specs

    tp = bt.MeshAxis("tp", TP_SIZE)
    cfg1 = _llama8b_cfg(TP_LAYERS)
    cfgs = {"tp 2": dataclasses.replace(cfg1, tp_axis="tp",
                                        tp_size=TP_SIZE),
            "tp 2 + vocab_parallel + tp_seq_shard": dataclasses.replace(
                cfg1, tp_axis="tp", tp_size=TP_SIZE, vocab_parallel=True,
                tp_seq_shard=True)}
    torch.cuda.empty_cache()
    model = bt.Llama(cfg1, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    params = model.state(release=True)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg1.vocab_size, (LLAMA_BATCH, LLAMA_SEQ + 1),
                        generator=g, device="cuda")
    batch = (raw[:, :-1].contiguous(), raw[:, 1:].contiguous())
    wq = "layers.0.attention.wq.kernel"
    w = params[wq].clone()
    w[:, w.shape[1] // TP_SIZE:] = 0    # shard 1's columns: its q heads
    _reset_counts()
    _hold_to_unsharded("[tp25a]", model, cfgs, params, batch, tp,
                       ("shard 1's slice of layer 0's wq zeroed", {wq: w}))
    # the shards' attention at the per-shard shape, one launch a layer
    # for all shards (three forwards and backwards with the axis bound,
    # one without)
    _expect_flash("25a step-0 checks", 4 * TP_LAYERS)
    specs = llama_param_specs(params)
    vspecs = llama_param_specs(params, vocab_axis="tp")
    del model, params, batch, raw, w
    torch.cuda.empty_cache()
    total = dict.fromkeys(FLASH_KERNELS, 0)
    warmup, timed = 1, 2
    for what, cfg, sp in (("tp 2", cfgs["tp 2"], specs),
                          ("tp 2 + vocab_parallel + tp_seq_shard",
                           cfgs["tp 2 + vocab_parallel + tp_seq_shard"],
                           vspecs)):
        got, state, _, _ = _llama_window(
            cfg, seed, warmup, timed, f"[tp25a] {what}, dp 1",
            dict.fromkeys(FLASH_KERNELS, TP_LAYERS * (warmup + timed)),
            batch_rows=LLAMA_BATCH, seq=LLAMA_SEQ, mesh_axes=(tp,),
            param_specs=sp)
        for kname in FLASH_KERNELS:
            total[kname] += got[kname]
        busy = _profile_llama(*state[2:], what=f"25a {what}")
        log(f"[tp25a] {what}: {busy:.2f} ms of device time a step against "
            "phase 8's tp 1 (628.06 ms, the f32 head 78.0%; PERF.md)")
        del state
        torch.cuda.empty_cache()
    got = _llama_train_2ranks(
        cfgs["tp 2"], seed, "[tp25a] tp 2 x dp 2",
        dict.fromkeys(FLASH_KERNELS, 1), warmup=1, timed=2, mesh_axes=(tp,),
        param_specs=specs)
    for kname in FLASH_KERNELS:
        total[kname] += got[kname]
    return total


def _p25_decode(seed):
    """25b: Llama-3.1-8B at full width and depth (bf16, seeded random
    weights), tp 2 decode of TP_PROMPTS greedy prompts through K4 at the
    per-shard shape; its tokens equal the tp 1 decode's under phase 19's
    near-tie rule.  Returns K4's launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.generate import (decode_config,
                                                   decode_token_step,
                                                   init_cache,
                                                   prefill_cache)
    from torch.profiler import ProfilerActivity, profile

    tp = bt.MeshAxis("tp", TP_SIZE)
    cfg = bt.LlamaConfig.llama3_8b(rope_scaling_kind="llama3")
    cfg_tp = dataclasses.replace(cfg, tp_axis="tp", tp_size=TP_SIZE)
    torch.cuda.empty_cache()
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    rng = np.random.RandomState(seed)
    prompts = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (TP_PROMPTS, TP_PROMPT_LEN)).astype(np.int32))
    prompts = prompts.cuda()
    want = bt.llama_generate(model, cfg, prompts, TP_NEW)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    got = bt.llama_generate(model, cfg_tp, prompts, TP_NEW, mesh=tp)
    torch.cuda.synchronize()
    wall_gen = time.perf_counter() - t0
    launches = _expect_launches("25b", {
        "decode_attention": (TP_NEW - 1) * cfg.n_layers})
    # the decode step alone, tp 2: wall and device ms (a cache at the
    # prompts' end, the same token for every row)
    max_len = TP_PROMPT_LEN + TP_NEW
    dcfg = decode_config(cfg_tp, max_len, keep_tp=True)
    twin = model.retarget(dataclasses.replace(model.cfg, tp_axis="tp",
                                              tp_size=TP_SIZE))
    with bt.bind_axis(tp), torch.no_grad():
        cache = init_cache(dcfg, TP_PROMPTS, max_len, keep_tp=True,
                           device="cuda")
        prefill_cache(twin, cache, prompts)
        tok = prompts[:, -1:]
        steps = 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(steps):
                decode_token_step(twin, cache, tok)
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t1) * 1e3 / steps
        del cache
    busy = sum(e.self_device_time_total for e in _device_kernels(prof))
    k4 = sum(e.self_device_time_total for e in _device_kernels(prof)
             if "decode" in e.key)
    # phase 19's near-tie rule: where a tp 2 stream parts from tp 1's,
    # both layouts' logits at that context sit within PATH_ERR_CEILING x
    # the uncached bf16 forward's distance to the f32 forward
    n_diff = _tp_flips(model, cfg, twin, tp, prompts.cpu().numpy(),
                       want.cpu().numpy(), got.cpu().numpy())
    log(f"[tp25b] Llama-3.1-8B (32 layers, bf16, random weights), tp 2 "
        f"decode of {TP_PROMPTS} prompts x {TP_PROMPT_LEN} tokens, "
        f"{TP_NEW} greedy tokens each: {n_diff} of {TP_PROMPTS} streams "
        f"part from tp 1's (each at a near-tie); llama_generate "
        f"{wall_gen * 1e3:.1f} ms ({TP_PROMPTS * TP_NEW / wall_gen:.1f} "
        f"tokens/s); the decode step {step_wall:.2f} ms of wall, "
        f"{busy / steps / 1e3:.3f} ms of device time ({100 * busy / steps / 1e3 / step_wall:.1f}% busy), K4 "
        f"{k4 / steps / 1e3:.3f} ms of it at [{TP_SIZE * TP_PROMPTS}, "
        f"{cfg.n_kv_heads // TP_SIZE}, S, {cfg.head_dim}] a layer; K4 "
        f"launches {launches}")
    del model, twin
    torch.cuda.empty_cache()
    return launches


def _tp_flips(model, cfg, twin, tp, prompts, want, got):
    """The rows whose tp 2 stream parts from the tp 1 stream: at the first
    parting token, the tp 2 K4 path's logits (``twin`` with ``tp`` bound)
    and the tp 1 paths of ``_four_paths`` must each stay within
    PATH_ERR_CEILING x the uncached bf16 forward's distance to the f32
    forward; the two tokens' margin in tp 1's K4 logits is logged beside
    twice the two layouts' logit gap.  Returns the number of rows that
    differ."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.generate import (decode_config,
                                                   decode_token_step,
                                                   init_cache,
                                                   prefill_cache)

    n_diff, ref = 0, None
    p_len = prompts.shape[1]
    for r in range(prompts.shape[0]):
        j = next((i for i in range(p_len, want.shape[1])
                  if want[r, i] != got[r, i]), None)
        if j is None:
            continue
        n_diff += 1
        if ref is None:
            ref = _f32_reference(cfg)
        ctx = want[r, :j]
        whole, k4, plain, f32 = _four_paths(model, ref, cfg, prompts[r],
                                            ctx[p_len:])
        s = -(-ctx.size // 64) * 64
        with bt.bind_axis(tp), torch.no_grad():
            cache = init_cache(decode_config(twin.cfg, s, keep_tp=True), 1,
                               s, keep_tp=True, device="cuda")
            prefill_cache(twin, cache, torch.from_numpy(ctx[None, :-1])
                          .cuda())
            last, _ = decode_token_step(twin, cache, torch.tensor(
                [[int(ctx[-1])]], device="cuda"))
            del cache
        k4_tp = last[0].float()
        e_plain = (plain - f32).abs().max().item()
        errs = {k: (x - f32).abs().max().item()
                for k, x in (("multi-token", whole), ("K4", k4),
                             ("tp 2 K4", k4_tp))}
        a, b = int(want[r, j]), int(got[r, j])
        margin = (k4[a] - k4[b]).item()
        # the rounding noise between the ways of computing these logits:
        # the two layouts' K4 paths and tp 1's multi-token path
        gap = max((x - y).abs().max().item() for x, y in (
            (k4, k4_tp), (whole, k4), (whole, k4_tp)))
        log(f"[tp25b] prompt {r} parts at token {j - p_len} of "
            f"{want.shape[1] - p_len}: {a} against {b}, margin "
            f"{abs(margin):.4g} (2 x the largest gap between the tp 1 K4, "
            f"tp 2 K4 and multi-token logits {2 * gap:.4g}); distance to "
            "the f32 forward: "
            + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
            + f", uncached bf16 {e_plain:.4g}")
        if max(errs.values()) > PATH_ERR_CEILING * e_plain or \
                abs(margin) > 2 * gap:
            raise AssertionError(f"25b: prompt {r} parts at token "
                                 f"{j - p_len} beyond the near-tie rule")
    del ref
    torch.cuda.empty_cache()
    return n_diff


def _p25_moe(seed):
    """25c: phase 23a's MoE model (8B width, 8 experts, 2 layers) over an
    ep axis of 2: step 0 of its first layer held to ep 1 as in 25a (a
    planted fault, one shard's experts' w2 in layer 0 zeroed, rejected),
    then 2 steps of the ep step.  Returns its launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                                llama_param_specs)

    ep = bt.MeshAxis("ep", TP_SIZE)
    cfg1 = _moe8b_cfg(MOE_LAYERS)
    cfg2 = dataclasses.replace(cfg1, ep_axis="ep", ep_size=TP_SIZE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = bt.Llama(cfg1, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    params = model.state(release=True)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg1.vocab_size, (LLAMA_BATCH, LLAMA_SEQ + 1),
                        generator=g, device="cuda")
    batch = (raw[:, :-1].contiguous(), raw[:, 1:].contiguous())
    w2 = "layers.0.moe_ffn.w2"
    w = params[w2].clone()
    w[cfg1.n_experts // TP_SIZE:] = 0   # shard 1's experts
    # held at the first layer: its router reads the same inputs in both
    # layouts, so the routing is the same and the gap is the ep psum's
    # rounding.  From the second layer on, that rounding can flip a
    # near-tied routing decision and shift the capacity drops behind it,
    # moving single tokens' hidden states, and the head's gradient
    # columns of the targets only they hold, by O(1) (even in f32).
    first = {k: v for k, v in params.items()
             if not k.startswith("layers.") or k.startswith("layers.0.")}
    _hold_to_unsharded("[ep25c] (layer 0)", _first_layer(model, cfg1),
                       {"ep 2": dataclasses.replace(cfg2, n_layers=1)},
                       first, batch, ep,
                       ("shard 1's experts' w2 in layer 0 zeroed", {w2: w}),
                       _first_layer)
    del w, first
    backend = bt.StackedBackend(1, device="cuda")
    specs = llama_param_specs(params, tp_axis=None, ep_axis="ep")
    stacked = bt.rank_major(params, backend, specs=specs)
    del params
    torch.cuda.empty_cache()
    opt = torch.optim.SGD(stacked.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(llama_loss_fn(model.retarget(cfg2)), opt,
                               backend, comm_mode="none", mesh_axes=(ep,),
                               param_specs=specs)
    b = (batch[0][None], batch[1][None])
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(2):
        stacked, opt, loss = step(stacked, opt, b, i)
        losses.append(loss.item())
    dt = (time.perf_counter() - t0) / 2
    n = cfg2.n_layers * 2
    launches = _expect_launches("25c", {"flash_forward": 2 * n,
                                        "flash_backward_dq": n,
                                        "flash_backward_dkv": n})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = LLAMA_BATCH * LLAMA_SEQ
    log(f"[ep25c] MoE Llama at 8B width ({cfg2.n_layers} layers, "
        f"{cfg2.n_experts} experts over ep {TP_SIZE}, remat), 1 rank, "
        f"batch {LLAMA_BATCH} x {LLAMA_SEQ}: 2 steps {dt * 1e3:.2f} ms each "
        f"(the first included), {tokens / dt:.1f} tokens/s, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, peak memory {peak:.2f} "
        f"GiB; launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"25c: losses {losses}")
    del step, stacked, opt, batch, b, model
    torch.cuda.empty_cache()
    return launches


def phase_model_axes(seed):
    """Phase 25: the model axes.  Returns the kernels' launches."""
    t0 = time.perf_counter()
    out = _p25_train(seed)
    log(f"[tp25a] {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for kname, n in _p25_decode(seed).items():
        out[kname] = out.get(kname, 0) + n
    log(f"[tp25b] {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for kname, n in _p25_moe(seed).items():
        out[kname] = out.get(kname, 0) + n
    log(f"[ep25c] {time.perf_counter() - t1:.1f} s; phase 25 "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 26: pipeline parallelism (GPipe and the circular schedule) and
# the sequence-sharded expert step, a rank's stages stacked on the card
# ------------------------------------------------------------------ #
PP_STAGES, PP_MICRO, PP_LOOPS = 2, 2, 2
# step 0 held to pp 1 on the same params (bf16 compute), as 25a holds tp:
# a CPU bf16 run at dim 512-1024 (4 layers, B 4 x T 128) gave loss gaps
# of 0 and gradients within 0.0072-0.0074 of each leaf's largest entry;
# the card's batched products round in another order than pp 1's
PP_LOSS_LIMIT = 2e-3
PP_GRAD_LIMIT = 0.1
PP_LAYERS = 4            # 26a's depth: phase 8's
PP_DP_LAYERS = 2         # 26b's: phase 9's (memory)
SP_EP_RANKS = 4          # 26c: 23d's width over 4 stacked ranks


def _pp_cfg(n_layers):
    """26's model: Llama-3.1-8B's width, the scanned layout the pipeline
    needs, remat (the whole block recomputed)."""
    return dataclasses.replace(_llama8b_cfg(n_layers), scan_layers=True,
                               remat=True)


def _pp_launches(n_loops, n_layers, ranks=1):
    """K2/K3a/K3b launches of one pp forward and backward under remat: a
    layer slot's one launch a tick for both stages, the forward twice."""
    ticks = n_loops * PP_MICRO + PP_STAGES - 1
    slots = n_layers // (PP_STAGES * n_loops)
    n = ticks * slots * ranks
    return {"flash_forward": 2 * n, "flash_backward_dq": n,
            "flash_backward_dkv": n}


def _dropped_hop_axis():
    """A pp axis whose hop into stage 1 delivers zeros: 26a's planted
    fault (stage 1 never sees stage 0's activations)."""
    import bluefog_tpu_torch as bt

    class DroppedHop(bt.MeshAxis):
        def shift(self, x):
            y = super().shift(x)
            return torch.cat([y[:1], torch.zeros_like(y[1:2]), y[2:]])

    return DroppedHop("pp", PP_STAGES)


def _p26a(seed):
    """26a: Llama-3.1-8B's width at phase 8's depth and batch, pp 2 on the
    one card (the stages stacked): step 0 of GPipe and of the circular
    schedule held to pp 1 on the same params, a planted fault (the hop
    into stage 1 dropped) rejected; then a training window of each.
    Returns the windows' launches."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import (llama_circular_layout,
                                                llama_pp_loss_fn)

    cfg = _pp_cfg(PP_LAYERS)
    pp = bt.MeshAxis("pp", PP_STAGES)
    torch.cuda.empty_cache()
    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    params = model.state(release=True)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ + 1),
                        generator=g, device="cuda")
    batch = (raw[:, :-1].contiguous(), raw[:, 1:].contiguous())
    _reset_counts()
    ref_loss, ref_grads = _loss_grads(model, params, batch)

    def pp_loss(n_loops):
        return llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=PP_STAGES,
                                n_micro=PP_MICRO, n_loops=n_loops)

    for what, n_loops in (("GPipe", 1), ("circular", PP_LOOPS)):
        p = (params if n_loops == 1 else
             llama_circular_layout(params, PP_STAGES, n_loops))
        loss, grads = _loss_grads(model, p, batch, pp, pp_loss(n_loops))
        if n_loops > 1:
            grads = llama_circular_layout(grads, PP_STAGES, n_loops,
                                          inverse=True)
        gap, worst, leaf = _tp_gap(loss, grads, ref_loss, ref_grads)
        del grads
        log(f"[pp26a] {what}, pp {PP_STAGES}, n_micro {PP_MICRO}"
            f"{f', n_loops {n_loops}' if n_loops > 1 else ''}: step-0 loss "
            f"{loss:.6f} against pp 1's {ref_loss:.6f} (|gap| {gap:.3g}, "
            f"limit {PP_LOSS_LIMIT}); gradients within {worst:.3g} of each "
            f"leaf's largest entry (worst {leaf}; limit {PP_GRAD_LIMIT})")
        if not (gap <= PP_LOSS_LIMIT and worst <= PP_GRAD_LIMIT):
            raise AssertionError(f"26a {what}: step 0 differs from pp 1's "
                                 f"(loss {gap}, grad {worst} at {leaf})")
    loss, grads = _loss_grads(model, params, batch, _dropped_hop_axis(),
                              pp_loss(1))
    gap, worst, leaf = _tp_gap(loss, grads, ref_loss, ref_grads)
    del grads, ref_grads
    log(f"[pp26a] planted fault, the hop into stage 1 dropped: loss gap "
        f"{gap:.3g}, gradients {worst:.3g} of the leaf's largest entry "
        f"({leaf}): rejected")
    if gap <= PP_LOSS_LIMIT and worst <= PP_GRAD_LIMIT:
        raise AssertionError("26a: the limits pass a planted fault (the "
                             "hop into stage 1 dropped)")
    # pp 1 under remat, then GPipe, the circular schedule, the fault
    want = {k: PP_LAYERS * (2 if k == "flash_forward" else 1)
            for k in FLASH_KERNELS}
    for n_loops in (1, PP_LOOPS, 1):
        for k, n in _pp_launches(n_loops, PP_LAYERS).items():
            want[k] += n
    _expect_launches("26a step-0 checks", want)
    del model, params, batch, raw
    torch.cuda.empty_cache()
    total = dict.fromkeys(FLASH_KERNELS, 0)
    warmup, timed = 1, 2
    for what, n_loops in (("GPipe", 1), ("circular", PP_LOOPS)):
        label = (f"[pp26a] pp {PP_STAGES} {what}, n_micro {PP_MICRO}"
                 + (f", n_loops {n_loops}" if n_loops > 1 else ""))
        got, state, _, _ = _llama_window(
            cfg, seed, warmup, timed, label,
            {k: n * (warmup + timed) for k, n in
             _pp_launches(n_loops, PP_LAYERS).items()},
            pp_loops=n_loops)
        for kname in FLASH_KERNELS:
            total[kname] += got[kname]
        busy = _profile_llama(*state[2:], what=f"26a {what}")
        ticks = n_loops * PP_MICRO + PP_STAGES - 1
        log(f"{label}: {busy:.2f} ms of device time a step, K2 "
            f"{LAST_PROFILE['K2']:.3f} and K3a+K3b "
            f"{LAST_PROFILE['K3a+K3b']:.3f} ms a step beside phase 8's pp 1 "
            f"({PHASE8_PROFILE.get('device', float('nan')):.2f} ms, K2 "
            f"{PHASE8_PROFILE.get('K2', float('nan')):.3f}, K3a+K3b "
            f"{PHASE8_PROFILE.get('K3a+K3b', float('nan')):.3f}, no remat); "
            f"{ticks} ticks for {n_loops * PP_MICRO} chunk-microbatches a "
            f"stage, bubble {(PP_STAGES - 1) / ticks:.3f} of the layer work")
        del state
        torch.cuda.empty_cache()
    return total


def _p26b(seed):
    """26b: dp 2 x pp 2 under atc over ExponentialTwoGraph(2) at 2 layers,
    held to dp 2 without pp: each rank's loss at steps 0 and 1 (the
    first taken after the first atc combine) within PP_LOSS_LIMIT.
    Returns the launches."""
    import bluefog_tpu_torch as bt

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(2))
    cfg = _pp_cfg(PP_DP_LAYERS)
    losses, total = {}, dict.fromkeys(FLASH_KERNELS, 0)
    for what, pp_loops in (("dp 2", None), ("dp 2 x pp 2", 1)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, _, step, params, opt, batch = _llama_step(
            cfg, 2, "atc", seed, LLAMA_BATCH, LLAMA_SEQ, pp_loops=pp_loops,
            topology=topo)
        _reset_counts()
        got = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, batch, i)
            torch.cuda.synchronize()
            got.append(loss.clone())
        dt = time.perf_counter() - t0
        want = ({k: 2 * 2 * PP_DP_LAYERS * (2 if k == "flash_forward"
                                            else 1) for k in FLASH_KERNELS}
                if pp_loops is None else
                {k: 2 * n for k, n in _pp_launches(1, PP_DP_LAYERS,
                                                   2).items()})
        launches = _expect_launches(f"26b {what}", want)
        for kname in FLASH_KERNELS:
            total[kname] += launches[kname]
        losses[what] = torch.stack(got)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[pp26b] {what} ({PP_DP_LAYERS} layers, remat), atc over "
            f"ExponentialTwoGraph(2), batch {LLAMA_BATCH} x {LLAMA_SEQ} a "
            f"rank: step 1 {dt * 1e3:.2f} ms, "
            f"{2 * LLAMA_BATCH * LLAMA_SEQ / dt:.1f} tokens/s per card, "
            f"peak {peak:.2f} GiB, losses {losses[what].tolist()}")
        del step, params, opt, batch
        torch.cuda.empty_cache()
    gap = (losses["dp 2 x pp 2"] - losses["dp 2"]).abs().max().item()
    log(f"[pp26b] dp 2 x pp 2 against dp 2: losses of steps 0 and 1 within "
        f"{gap:.3g} (limit {PP_LOSS_LIMIT})")
    if not (gap <= PP_LOSS_LIMIT
            and torch.isfinite(losses["dp 2 x pp 2"]).all()):
        raise AssertionError(f"26b: dp 2 x pp 2 differs from dp 2 ({gap})")
    return total


def _p26c(seed):
    """26c: the expert-sharded step over a sequence axis at 23d's width
    (d 4096, hidden 14336, EP_EXPERTS experts, EP_TOKENS tokens a rank)
    over SP_EP_RANKS stacked ranks, sp 2: each rank's tokens split into
    two shards by batch_specs, each shard dispatched over the compiled
    all-to-all of PodSpec(2, 2) on its own, atc over the (2, 2) torus
    with guard and health.  0 host syncs in a steady step, finite losses,
    the expert leaves bit-equal to a step under the identity combine."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch import moe
    from bluefog_tpu_torch.parallel.collectives import bound_axis
    from bluefog_tpu_torch.topology.compiler import (PodSpec,
                                                     compile_all_to_all)
    from bluefog_tpu_torch.topology.torus import torus_one_peer_schedule

    n, E, sp = SP_EP_RANKS, EP_EXPERTS, 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    backend = bt.StackedBackend(n, device="cuda")
    plan = moe.dispatch_plan(compile_all_to_all(PodSpec(2, 2)).schedule)
    cap = moe.default_capacity(EP_TOKENS // sp, n)
    route = torch.as_tensor(moe.default_route_table(n, E), device="cuda")
    live = torch.as_tensor(np.broadcast_to(
        moe.capacity_mask_of(np.zeros(n))[None], (n, n)).copy(),
        device="cuda")

    def loss_fn(params, batch):
        (tokens,) = batch           # [n, sp, tokens / sp, d]
        out = []
        for s in range(bound_axis("sp").size):
            y, _ = moe.moe_apply(params, tokens[:, s], route, live,
                                 plan=plan, backend=backend, capacity=cap)
            out.append(torch.square(y - tokens[:, s]).mean(dim=(1, 2)))
        return torch.stack(out, dim=1)

    g = torch.Generator("cuda").manual_seed(seed)
    params = moe.init_moe_params(g, EP_DIM, EP_HIDDEN, E, n_ranks=n,
                                 device="cuda")
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode="atc",
        schedule=torus_one_peer_schedule((2, 2), "exp2"),
        guard=bt.GuardConfig(), health=bt.HealthConfig(),
        moe=bt.MoEConfig(E, cap), sp_axis=bt.SeqAxis("sp", sp),
        batch_specs=("bf", "sp"))
    batch = (torch.randn(n, EP_TOKENS, EP_DIM, generator=g, device="cuda"),)
    w = step.default_comm_weights
    losses = []
    for i in range(2):
        params, opt, loss, skipped, hv = step(params, opt, batch, i, w)
        losses.append(loss)
    timed = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + timed):
        params, opt, loss, skipped, hv = step(params, opt, batch, i, w)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    syncs = _count_syncs(lambda: step(params, opt, batch, 2 + timed, w))
    losses = torch.stack(losses)
    if not (torch.isfinite(losses).all() and syncs == 0):
        raise AssertionError(f"26c: losses {losses.tolist()}, host syncs "
                             f"{syncs}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    local = _ep_experts_local(step, params, opt, batch, 3 + timed)
    log(f"[moe26c] expert-sharded step over sp {sp}, {n} ranks x "
        f"{EP_TOKENS} tokens ({EP_TOKENS // sp} a shard), d {EP_DIM}, "
        f"hidden {EP_HIDDEN}, {E} experts, capacity {cap} a shard, atc "
        f"over torus_one_peer_schedule((2, 2), 'exp2') with guard and "
        f"health: mean losses "
        f"{', '.join(f'{x:.5f}' for x in losses.mean(1).tolist())}; "
        f"steady step {dt * 1e3:.2f} ms, {syncs} host syncs, experts "
        f"rank-local ({local}); peak {peak:.2f} GiB")
    del step, params, opt, batch
    torch.cuda.empty_cache()


def phase_pipeline(seed):
    """Phase 26: pipeline parallelism and the sequence-sharded expert
    step.  Returns the kernels' launches."""
    t0 = time.perf_counter()
    out = _p26a(seed)
    log(f"[pp26a] {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for kname, n in _p26b(seed).items():
        out[kname] += n
    log(f"[pp26b] {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    _p26c(seed)
    log(f"[moe26c] {time.perf_counter() - t1:.1f} s; phase 26 "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 27: per-device wire buckets (the int8 wires and top-k mixing
# under model-parallel specs), the JAX package's 8B pod layout
# ------------------------------------------------------------------ #
# 27a's int8 legs and 27b: 2 layers.  25a's 4 layers leave no room for
# the guard's snapshots of the params and the momentum (14.3 GiB each at
# 4 layers over 2 ranks); 27a drops the momentum, so the uncompressed
# step's params stay on the card beside its int8 legs; the top-k leg: 1
# layer, its MixState being three more f32 copies of a rank's mixed
# params, the uncompressed params on the host (PERF.md, PR 19)
WIRE_LAYERS = 2
WIRE_MIX_LAYERS = 1
WIRE_BUCKETS = 4
WIRE_RATIO = 0.25
# ExponentialTwoGraph(2): each rank takes half of its neighbour's wire
WIRE_W = 0.5
# the params bound's allowance for step 1's gradients, taken at params
# the step-0 wire moved (bf16 compute): on the H100 they added up to 0.9x
# the wire's own term (top-k's output.kernel; PERF.md, PR 19)
WIRE_SLACK = 3.0


class _WireSpy:
    """For one leg, wraps ``collectives._wire_quantize_int8`` (the int8
    wire's and top-k mixing's quantizer): each call's per-(rank, device)
    scales must equal a plain absmax of each device's row computed apart
    (each row alone, then / 127); one scale over a rank's whole bucket,
    the layout before per-device buckets, is the planted fault that must
    disagree.  Keeps per call the scales and each row's smallest kept
    magnitude (the top-k threshold, for top-k's values)."""

    def __init__(self):
        from bluefog_tpu_torch.parallel import collectives as C

        self.C, self.calls, self.old_agrees = C, [], 0

    def __enter__(self):
        real = self.real = self.C._wire_quantize_int8

        def spy(x, generator=None, first_rank=0, per_device=False):
            q, scale = real(x, generator, first_rank, per_device)
            if not per_device:
                raise AssertionError("27: a model-parallel bucket went on "
                                     "the wire with one scale per rank")
            n, D = scale.shape
            plain = torch.stack([torch.stack([
                x[r, d].float().abs().max() / 127.0 for d in range(D)])
                for r in range(n)])
            if not torch.equal(plain, scale):
                raise AssertionError(
                    f"27: scales {scale.tolist()} are not each device's "
                    f"absmax / 127 {plain.tolist()}")
            whole = (x.float().abs().reshape(n, -1).amax(1, keepdim=True)
                     / 127.0).expand(n, D)
            self.old_agrees += int(torch.equal(whole, scale))
            self.calls.append((scale.clone(), x.float().abs().reshape(
                n, D, -1).amin(-1)))
            return q, scale

        self.C._wire_quantize_int8 = spy
        return self

    def __exit__(self, *exc):
        self.C._wire_quantize_int8 = self.real


def _p27_buckets(params, specs, sizes, n_buckets, per_device=True):
    """The buckets JAX plans for rank-major ``params`` under ``specs``
    (its ``_local_shapes`` rule, computed apart from the step): each leaf
    with the rank axis stripped and every dim divided by the sizes of
    the axes its spec names, a stage-owned leaf's layers of one weight
    name one leaf ``[L / S, ...]`` where its first layer stands (with
    ``per_device=False``: a rank's whole leaves), then EpiloguePlan.
    Returns [(param names, per-device numel)]."""
    import re
    from types import SimpleNamespace

    from bluefog_tpu_torch.optim.fusion import EpiloguePlan

    leaves, names, where = [], [], {}
    for k, v in params.items():
        dims = list(v.shape[1:])
        spec = specs[k]
        if per_device:
            for i, e in enumerate(spec[1:]):
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a is not None:
                        dims[i] //= sizes[a]
        if per_device and isinstance(spec[0], tuple):
            key = re.sub(r"\.\d+\.", ".*.", k, count=1)
            if key in where:
                names[where[key]].append(k)
                continue
            count = sum(re.sub(r"\.\d+\.", ".*.", j, count=1) == key
                        for j in params)
            dims = [count // sizes[spec[0][1]]] + dims
            where[key] = len(leaves)
        leaves.append(SimpleNamespace(shape=tuple(dims), dtype=v.dtype))
        names.append([k])
    plan = EpiloguePlan.for_leaves(leaves, n_buckets)
    return [([n for i in b.leaves for n in names[i]],
             sum(int(np.prod(leaves[i].shape)) for i in b.leaves))
            for b in plan.buckets]


def _p27_step(cfg, seed, compress, momentum, pp=False, **kw):
    """``cfg``'s model over 2 stacked ranks, atc over
    ExponentialTwoGraph(2), f32 masters from --seed: tp 2 in the JAX
    pod's layout (vocab_parallel + tp_seq_shard, every matrix sharded,
    the norms replicated) or, with ``pp``, pp 2 (GPipe).  Returns (step,
    params, opt, batch, specs, axis sizes)."""
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                                llama_param_specs,
                                                llama_pp_loss_fn)
    from bluefog_tpu_torch.optim import functional as F

    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(seed))
    state = model.state(release=True)
    if pp:
        specs = llama_param_specs(state, tp_axis=None, ep_axis=None,
                                  pp_axis="pp")
        loss_fn = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=PP_STAGES,
                                   n_micro=PP_MICRO, n_loops=1)
        axes = dict(pp_axis=bt.MeshAxis("pp", PP_STAGES))
        sizes = {"pp": PP_STAGES}
    else:
        specs = llama_param_specs(state, vocab_axis="tp")
        loss_fn = llama_loss_fn(model)
        axes = dict(mesh_axes=(bt.MeshAxis("tp", TP_SIZE),))
        sizes = {"tp": TP_SIZE}
    backend = bt.StackedBackend(2, device="cuda")
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=momentum)
    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
        param_specs=specs,
        opt_state_specs=F.optax_state_specs(opt, state, specs),
        compress=compress, **axes, **kw)
    del state
    g = torch.Generator("cuda").manual_seed(seed + 1)
    raw = torch.randint(0, cfg.vocab_size, (2, LLAMA_BATCH, LLAMA_SEQ + 1),
                        generator=g, device="cuda")
    batch = (raw[..., :-1].contiguous(), raw[..., 1:].contiguous())
    return step, params, opt, batch, specs, sizes


def _p27_leg(label, cfg, seed, compress, momentum, per_step, ref=None,
             pp=False, hold="cuda", **kw):
    """One leg of phase 27: 2 steps (the first from the same params as
    the uncompressed step's), then a third under torch.profiler with the
    exchange tally on and the host syncs counted (the device ms, the
    contract's permutes), and the combine's ms.  ``ref`` (the
    uncompressed leg's record) holds step 0's loss equal and the params
    after 2 steps within the int8 grid's bound; without ``ref`` this is
    the uncompressed leg, and its params after 2 steps are kept in the
    record, on ``hold`` (the host where the card has no room for them
    beside the compressed legs).  ``per_step``: each kernel's launches a step.
    Returns the leg's record."""
    from torch.profiler import ProfilerActivity, profile

    from bluefog_tpu_torch import benchutil
    from bluefog_tpu_torch.parallel import collectives as C

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    laps = [time.perf_counter()]
    step, params, opt, batch, specs, sizes = _p27_step(
        cfg, seed, compress, momentum, pp=pp, **kw)
    mix = step.mix_config is not None
    guarded = "guard" in kw
    state = (opt, step.init_mix_state(params)) if mix else opt
    w = (step.default_comm_weights,) if guarded else ()
    _reset_counts()
    losses = []
    spy = _WireSpy()
    with spy if compress is not None else contextlib.nullcontext():
        for i in range(2):
            out = step(params, state, batch, i, *w)
            params, state, loss = out[:3]
            losses.append(loss.clone())
            if guarded and out[3].any():
                raise AssertionError(f"{label}: the guard skipped "
                                     f"{out[3].tolist()}")
    del out
    rec = dict(losses=torch.stack(losses).tolist())
    laps.append(time.perf_counter())
    if ref is None:
        rec["params"] = {k: v.to(hold, copy=True)
                         for k, v in params.items()}
    else:
        # step 0's loss is taken before the wire acts: the same bits
        if not torch.equal(losses[0], ref["loss0"]):
            raise AssertionError(f"{label}: step-0 loss {losses[0].tolist()}"
                                 f" is not the uncompressed step's "
                                 f"{ref['loss0'].tolist()}")
        n_buckets = WIRE_BUCKETS if "overlap" in kw else None
        buckets = _p27_buckets(params, specs, sizes, n_buckets)
        nb = len(buckets)
        if len(spy.calls) != 2 * nb:
            raise AssertionError(f"{label}: {len(spy.calls)} quantizer "
                                 f"calls, {2 * nb} buckets in 2 steps")
        if spy.old_agrees >= len(spy.calls):
            raise AssertionError(f"{label}: one scale over a rank's whole "
                                 "bucket passes the per-device check")
        # per step and bucket, what a receiver's view of a sender's
        # bucket may miss: half a grid step (one under stochastic
        # rounding); for top-k the larger of that and the smallest kept
        # magnitude (the residual held back), and the view at step 1
        # misses step 1's residual less step 0's (the reference carries
        # what was sent), so step 0's counts twice
        f = 1.0 if "int8_sr" in (compress, getattr(compress, "values",
                                                   None)) else 0.5
        miss = []
        for scale, kept in spy.calls:
            m = f * scale
            if mix:
                m = torch.maximum(m, kept)
            miss.append(float(m.max()))
        worst, where = 0.0, None
        for b, (names, _) in enumerate(buckets):
            bound = WIRE_SLACK * WIRE_W * (miss[b] * (2 if mix else 1)
                                           + miss[nb + b])
            for k in names:
                d = (params[k] - ref["params"][k].to(params[k].device)
                     ).abs().max().item()
                r = d / bound
                if r > worst:
                    worst, where = r, k
        rec.update(scales_checked=len(spy.calls),
                   old_layout_rejected=len(spy.calls) - spy.old_agrees,
                   worst_ratio=worst, worst_leaf=where)
        if worst > 1.0:
            raise AssertionError(f"{label}: params after 2 steps beyond the "
                                 f"int8 grid's bound ({worst:.3g} of it at "
                                 f"{where})")
    laps.append(time.perf_counter())
    # step 2: the device ms, the exchanges (one device's payload each) and
    # the host syncs of a steady step
    C._exchange_tally = {}
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec["syncs"] = _count_syncs(
                lambda: step(params, state, batch, 2, *w))
        tally = C._exchange_tally
    finally:
        C._exchange_tally = None
    rec["device_ms"] = sum(e.self_device_time_total
                           for e in _device_kernels(prof)) / 1e3
    del prof
    permutes = tally.get("collective-permute", {}).get("payloads", [])
    rec["wire_bytes"] = sum(permutes)
    if ref is not None:
        hops = ([(LLAMA_BATCH // PP_MICRO) * LLAMA_SEQ * cfg.dim * 2]
                * 2 * (PP_MICRO + PP_STAGES - 1) if pp else [])

        def predicted(bks):
            if mix:
                pay = [C.mix_wire_bytes(n, max(int(WIRE_RATIO * n), 1),
                                        "int8") for _, n in bks]
            else:
                pay = [n for _, n in bks] + [4] * len(bks)
            pay = pay + hops
            return ({"permutes_per_period": len(pay),
                     "bytes_per_period": float(sum(pay))}, sorted(set(pay)))

        if mix:
            layout = [r["numel"] for r in step.mix_wire_layout(params)]
            if layout != [n for _, n in buckets]:
                raise AssertionError(f"{label}: mix_wire_layout {layout} "
                                     "against the per-device plan's "
                                     f"{[n for _, n in buckets]}")
        got = benchutil.verify_collective_contract(tally, *predicted(
            buckets))
        whole = benchutil.verify_collective_contract(tally, *predicted(
            _p27_buckets(params, specs, sizes, n_buckets,
                         per_device=False)))
        if got or not whole:
            raise AssertionError(f"{label}: the collective contract gives "
                                 f"{got} (want []) and against whole-rank "
                                 f"buckets {whole} (want mismatches)")
        rec["contract_rejects"] = len(whole)
    laps.append(time.perf_counter())
    times = []
    for _ in range(3):   # the step's own in-place combine, on its params
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.combine(params, 0, state[1] if mix else None, *w)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    rec["combine_ms"] = statistics.median(a.elapsed_time(b)
                                          for a, b in times[1:])
    laps.append(time.perf_counter())
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["launches"] = _expect_launches(label, {k: 3 * n for k, n in
                                               per_step.items()})
    if not all(math.isfinite(x) for row in rec["losses"] for x in row):
        raise AssertionError(f"{label}: losses {rec['losses']}")
    if rec["syncs"]:
        raise AssertionError(f"{label}: {rec['syncs']} host syncs in a "
                             "steady step")
    log(f"{label}: losses {[[round(x, 6) for x in r] for r in rec['losses']]}"
        f", device {rec['device_ms']:.2f} ms a step, combine "
        f"{rec['combine_ms']:.3f} ms, wire {rec['wire_bytes']:,} bytes a "
        + ("step a rank (whole-rank buckets)" if ref is None else
           "step a device")
        + f", peak {rec['peak_gib']:.2f} GiB, {rec['syncs']} host syncs"
        + ("" if ref is None else
           f"; step 0's loss the uncompressed step's; params after 2 steps "
           f"within {rec['worst_ratio']:.3g} of the grid's bound (worst "
           f"{rec['worst_leaf']}); {rec['scales_checked']} calls' scales "
           f"each device's absmax, one scale a rank's bucket rejected at "
           f"{rec['old_layout_rejected']}; contract [] (whole-rank buckets: "
           f"{rec['contract_rejects']} mismatches)")
        + "; s: build + 2 steps {:.1f}, hold {:.1f}, profiled step {:.1f}, "
        "combine {:.1f}".format(*(b - a for a, b in zip(laps, laps[1:]))))
    rec["loss0"] = losses[0]
    del step, params, opt, state, batch, losses
    torch.cuda.empty_cache()
    return rec


def _p27a(seed):
    """27a: Llama-3.1-8B's width at dp 2 x tp 2 under atc in the JAX
    pod's layout (vocab_parallel + tp_seq_shard, llama_param_specs(
    vocab_axis="tp")), guard + health + overlap="bucketed", SGD without
    momentum: the uncompressed step, the int8 wire, the int8_sr wire
    (WIRE_LAYERS), then MixCompressConfig(WIRE_RATIO, "int8") against its
    own uncompressed step at WIRE_MIX_LAYERS.  Returns the launches."""
    import bluefog_tpu_torch as bt

    def cfg(n):
        return dataclasses.replace(_llama8b_cfg(n), tp_axis="tp",
                                   tp_size=TP_SIZE, vocab_parallel=True,
                                   tp_seq_shard=True)

    kw = dict(overlap="bucketed", overlap_buckets=WIRE_BUCKETS,
              guard=bt.GuardConfig(), health=bt.HealthConfig())
    total = dict.fromkeys(FLASH_KERNELS, 0)
    recs = {}
    for n_layers, hold, legs in (
            (WIRE_LAYERS, "cuda", (("int8", "int8"),
                                   ("int8_sr", "int8_sr"))),
            (WIRE_MIX_LAYERS, "cpu", ((
                f"top-k {WIRE_RATIO} int8",
                bt.MixCompressConfig(ratio=WIRE_RATIO, values="int8")),))):
        per_step = dict.fromkeys(FLASH_KERNELS, n_layers * 2)
        ref = _p27_leg(f"[wire27a] uncompressed, {n_layers} layers", cfg(
            n_layers), seed, None, 0.0, per_step, hold=hold, **kw)
        recs[f"uncompressed {n_layers}"] = ref
        for what, compress in legs:
            recs[what] = _p27_leg(f"[wire27a] {what}, {n_layers} layers",
                                  cfg(n_layers), seed, compress, 0.0,
                                  per_step, ref=ref, **kw)
        del ref["params"]
    for rec in recs.values():
        for k in FLASH_KERNELS:
            total[k] += rec["launches"][k]
    ms = {k: r["device_ms"] for k, r in recs.items()}
    log(f"[wire27a] dp 2 x tp 2: device ms a step uncompressed "
        f"{ms[f'uncompressed {WIRE_LAYERS}']:.2f} / int8 {ms['int8']:.2f} "
        f"/ int8_sr {ms['int8_sr']:.2f} at {WIRE_LAYERS} layers, "
        f"uncompressed {ms[f'uncompressed {WIRE_MIX_LAYERS}']:.2f} / top-k "
        f"{ms[f'top-k {WIRE_RATIO} int8']:.2f} at "
        f"{WIRE_MIX_LAYERS}, beside 25a's dp 2 x tp 2 at 4 layers (1,334.82 "
        "ms, PERF.md)")
    return total


def _p27b(seed):
    """27b: 26b's dp 2 x pp 2 under atc (PP_DP_LAYERS layers, remat,
    GPipe) uncompressed and under the int8 wire (a bucket a stage's
    weight stack, the replicated embedding, norm and head whole on each
    stage).  Returns the launches."""
    cfg = _pp_cfg(PP_DP_LAYERS)
    per_step = _pp_launches(1, PP_DP_LAYERS, 2)
    ref = _p27_leg("[wire27b] dp 2 x pp 2 uncompressed", cfg, seed, None,
                   0.9, per_step, pp=True)
    rec = _p27_leg("[wire27b] dp 2 x pp 2 int8", cfg, seed, "int8", 0.9,
                   per_step, ref=ref, pp=True)
    del ref["params"]
    log(f"[wire27b] dp 2 x pp 2 device ms a step: uncompressed "
        f"{ref['device_ms']:.2f}, int8 {rec['device_ms']:.2f}, beside "
        "26b's (1,294.20 / 1,289.86 ms of step wall, PERF.md)")
    return {k: ref["launches"][k] + rec["launches"][k] for k in per_step}


def phase_wire(seed):
    """Phase 27: per-device wire buckets under model-parallel specs.
    Returns the kernels' launches."""
    t0 = time.perf_counter()
    out = _p27a(seed)
    log(f"[wire27a] {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for kname, n in _p27b(seed).items():
        out[kname] += n
    log(f"[wire27b] {time.perf_counter() - t1:.1f} s; phase 27 "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 18's children (run by the port's bfrun), not for a user
    ap.add_argument("--child", choices=sorted(CHILDREN),
                    help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.child:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        CHILDREN[args.child](args.seed, args.dir)
        return 0
    if os.environ.get("BLUEFOG_OPS_ON_CPU", "0") in ("1", "true", "True"):
        print("chip_smoke: BLUEFOG_OPS_ON_CPU asks the eager ops for the "
              "host; unset it to measure the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    laps = [t0]

    def lap(what):
        # each phase's seconds, for cutting depth when the whole
        # smoke nears its time limit
        laps.append(time.perf_counter())
        log(f"[time] {what} {laps[-1] - laps[-2]:.1f} s, "
            f"{laps[-1] - t0:.1f} s in all")

    name = phase_device()
    lap("device")
    kernels = phase_kernels(name, args.seed)
    lap("kernels")
    kernels.update(phase_k1(name, args.seed))
    lap("k1")
    kernels.update(phase_flash(name, args.seed))
    lap("flash")
    kernels.update(phase_splash(name, args.seed))
    lap("splash")
    launches = phase_serving(args.seed)
    lap("serving")
    phase_reference(args.seed)
    lap("reference")
    torch.backends.cudnn.benchmark = True   # the training path's convs
    launches["conv1x1_backward"] = phase_train_1rank(args.seed)
    lap("train_1rank")
    phase_train_4ranks(args.seed)
    lap("train_4ranks")
    phase_train_modes(args.seed)
    lap("train_modes")
    torch.backends.cudnn.benchmark = False
    phase_train_reference(args.seed)
    lap("train_reference")
    phase_train_modes_reference(args.seed)
    lap("train_modes_reference")
    launches.update(phase_llama_train_1rank(args.seed))
    lap("llama_train_1rank")
    phase_llama_train_2ranks(args.seed)
    lap("llama_train_2ranks")
    phase_llama_reference(args.seed)
    lap("llama_reference")
    launches["splash_backward"] = phase_llama1b(args.seed)["splash_backward"]
    lap("llama1b")
    phase_llama1b_2ranks(args.seed)
    lap("llama1b_2ranks")
    phase_llama_reference(args.seed, attn_impl="splash", seq=128)
    lap("llama_reference_splash")
    phase_vit(args.seed)
    lap("vit")
    phase_eager_ops(args.seed)
    lap("eager_ops")
    torch.backends.cudnn.benchmark = True   # the training path's convs
    phase_eager_resnet(args.seed)
    lap("eager_resnet")
    torch.backends.cudnn.benchmark = False
    phase_eager_reference(args.seed)
    lap("eager_reference")
    phase_process(args.seed)
    lap("process")
    for kname, n in phase_serving_rest(args.seed).items():
        launches[kname] += n
    lap("serving_rest")
    for kname, n in phase_fleet(args.seed).items():
        launches[kname] += n
    lap("fleet")
    for kname, n in phase_sp(name, args.seed).items():
        launches[kname] += n
    lap("sp")
    for kname, n in phase_resilience(args.seed).items():
        launches[kname] += n
    lap("resilience")
    for kname, n in phase_moe(args.seed).items():
        launches[kname] += n
    lap("moe")
    for kname, n in phase_control(args.seed).items():
        launches[kname] += n
    lap("control")
    for kname, n in phase_model_axes(args.seed).items():
        launches[kname] += n
    lap("model_axes")
    for kname, n in phase_pipeline(args.seed).items():
        launches[kname] += n
    lap("pipeline")
    for kname, n in phase_wire(args.seed).items():
        launches[kname] += n
    lap("wire")
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
