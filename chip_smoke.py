#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, so the exit code is non-zero):

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per kernel family, all started together; six families
   hold the ports of the seven TPU kernels). ptxas must report every
   instance of the two bf16 attention kernels, 6 of
   ``flash_decode_mma_kernel`` and 3 of ``flash_attention_wgmma_kernel``
   (dh 64, 128, 256), with 0 bytes of spill.
2. Serve requests through ``GNNInferenceService`` on ``cuda`` at the
   paper's GraphSAGE width (``configs/rapidgnn_paper.py`` ``sage``):
   ``reddit_sim`` (d=602, 50 classes), 4 greedy partitions, worker 0,
   hidden 256, 2 layers, fan-outs (25, 10), n_hot 4096, 64 seeds per
   request, 4 requests per micro-batch, ``agg_backend="kernel"``.
   First uncached, then ``warm_now()``, then fresh. Every response must
   be bit-equal to ``oracle()``, and every kernel's launch count (set to
   0 just before serving, read just after) must have risen, except
   ``search``'s, which must stay 0: the fused assembly ranks inside its
   own kernel, one launch a micro-batch. Two
   responses are also held against the same service run on the CPU
   through the plain PyTorch versions (``rtol=1e-4, atol=1e-5``). Then
   one fresh micro-batch is stepped synchronously and split into host
   time and program time, and traced for the card's busy share.
3. Hold each kernel against its plain PyTorch version on the card, at
   the shapes the served micro-batch gives it and at awkward shapes
   (n_hot up to 32,768, the paper grid's largest, and 70,000, beyond a
   one-line splitter table; the fused ``assemble`` one launch and one
   card operation a call, no ``search``, against ``assemble_ref``, its
   time logged beside the two-launch design it replaced; ``search`` one
   card operation a call; all bit-exact; ``gather_agg`` also against a
   second run, one card operation a call, at d 1 / 3 / 130 / 256 / 602,
   each vector width and fan-outs up to 50), and time kernel, plain
   version and, where one exists, the single PyTorch library call
   computing the same function (``torch.searchsorted`` for ``search``,
   ``F.embedding_bag`` for ``gather_agg``; CUDA-graph replays timed with
   CUDA events, one call a replay and, for these short calls, 20 calls
   to a graph).
4. Train: the paper's RapidGNN pipeline on one card at the same width
   (``sage("reddit_sim", 1000)``: batch 1000, hidden 256, fan-outs
   (25, 10), n_hot 4096, Q 4, AdamW lr 3e-3, parameters from a seed).
   The schedule for 2 epochs is compiled on the card (``seg_sort``) and
   must be bit-equal to the numpy compiler's; then ``RapidGNNRunner``
   trains 2 epochs x 10 steps through the ``gather_agg`` forward and
   backward kernels, with every launch count (set to 0 before the
   schedule build, read after the run) risen, ``gather_agg_bwd``
   launched once a step (layer 1 only) and ``seg_sort`` only by the
   schedule compiler (the backward orders its edges in its own kernel).
   The first 3 losses must agree
   with the same steps on the CPU (plain versions) to ``rtol=1e-4,
   atol=1e-5`` and a second card run must give the same loss curve bit
   for bit. Prints build ms per epoch for each compiler, steps/s, the
   per-step prefetch stall and compute (H2D copy and step apart), the
   peak device memory and a traced split of the card's time by op.
5. Hold the ``gather_agg`` forward at training's two layer shapes (from
   the captured batch: bit-equal, one card operation a call, timed as in
   phase 3), ``seg_sort`` (the compiler's largest stream, keys only;
   bit-equal, at most 1 + passes card operations a call, beside its
   read-once bound and its own floor) and ``gather_agg_bwd`` (layer 1's
   shapes, and layer 0's for
   reference; bit-equal to the CPU plain version, which adds in edge
   order, and to a second run, and within ``rtol=atol=1e-5`` (layer 0:
   ``1e-4``) of the card plain version, whose ``index_add_`` adds in
   atomic order; at most 3 card operations a call at both layers, counted
   in a captured CUDA graph; each card op's own time from
   ``torch.profiler``; beside its byte bound, the order's own floor: the
   longest run of the batch's sources times 4 cycles of one dependent
   float add at the card's maximum SM clock) against their plain versions
   on the card, with their times beside ``torch.sort`` and
   ``index_add_``.

6. Decode serving: gemma2-2b (``configs/gemma2_2b.py``) at its full width
   and depth in bfloat16, weights from a seeded ``torch.Generator`` on
   the card. (a) Prefill: ``forward`` at B=1, S=8192 (the repo's
   ``prefill_32k`` with S cut to 8192, still past the 4096 window), one
   ``flash_attention`` launch per layer (26), with its time, peak device
   memory and traced split of the card's time. (b) Decode: the
   ``serve_decode`` launcher's greedy loop at B=8, prompt 16, gen 32, one
   ``flash_decode`` launch per layer a step (26 x 47), with ms/step and
   tokens/s, and a second run bit-identical. (c) In float32 at full width
   over S=64: each decode step's logits against ``forward``'s, within
   ``atol=1e-3``. (d) Each new kernel against its plain version on the
   card: ``flash_attention`` on a local and a global layer's own q/k/v at
   the prefill shape (bfloat16, the tensor-core kernel, within one
   bfloat16 step, ``rtol=2^-7``; the same q/k/v in float32, the CUDA-core
   kernel, within ``rtol=1e-4, atol=1e-5``, and timed beside it, with
   SDPA in float32 and the bound at the float32 CUDA-core rate), and
   ``flash_decode`` over a long cache (B=16, S=32768, ``length``/``start``
   masks, softcap 50) and the decode loop's own caches (float32
   partials, ``rtol=1e-4, atol=1e-5``; one card operation a call), with
   their times beside SDPA (``enable_gqa``, the same mask, no softcap)
   and their byte bounds. A call of a few microseconds is also timed 20
   to a CUDA graph, beside a trivial kernel's time both ways: one call a
   replay is paced by the host's graph launches.
7. The device-distributed epoch: all 4 workers of ``reddit_sim`` in one
   process on the card (``make_mesh((4,), ("data",))``) at the paper's
   GraphSAGE width (``sage("reddit_sim", 1000)``, one epoch, AdamW lr
   3e-3), collated on the card by ``collate_epoch_on_device`` as the
   runners stage an epoch, every tensor bit-equal to the numpy
   ``collate_device_epoch`` (hot caches and empty ones). (a)
   ``make_pipelined_epoch`` with the fused and with the
   staged assembly and ``make_ondemand_epoch`` over empty caches, each
   twice in turns: every loss curve bit-equal to the first (the second
   fused run's weights too), the first 3 losses within ``rtol=1e-4,
   atol=1e-5`` of the same steps on the CPU. (b) Step 0, worker by
   worker: ``pull_features``' buffers equal the numpy rows at
   ``send_pos``, the staged, fused and host-gathered features are
   bit-equal, and the pull lanes equal ``host_miss_matrix``. (c) Launch
   counts (set to 0 before each run): ``search`` and ``merge_gather``
   only in the staged runs, ``assemble`` only in the others. (d) ms/step
   of each run,
   the exchange's own ms a step (CUDA events), miss lanes of rapid and
   on-demand and their ratio, the wire bytes, peak memory and a traced
   split of the card's time. (e) The hot-token embedding lookup at
   gemma2-2b's widths (vocab 256,000, d 2,304, a 2.36 GB float32 table,
   8 workers x 16 x 256 tokens, n_hot 32,768): ``device_embedding_lookup``
   equal to ``table[tokens]`` bit for bit, with ``HotEmbeddingSim``'s
   traffic reduction. (f) ``merge_gather`` against its plain version at
   the staged epoch's and the embedding's shapes and awkward ones (d 1 /
   3 / 602 / 2304, m 0, an empty cache, all and no hits, bfloat16 and
   mixed dtypes, -1 and sentinel queries through ``cache_lookup``), all
   bit-exact, timed with CUDA-graph replays.

8. The multi-epoch runner: ``DeviceRapidGNNRunner`` over 3 epochs of
   the same 4 workers and width (``sage("reddit_sim", 1000)``, n_hot
   4096), staging epoch e+1 on a background thread while epoch e trains
   and swapping C_sec in at the boundary. (a) ``fused``, numpy
   schedules, flat, twice: ``trace_count`` 1, host parity on every
   epoch, the two curves and final weights bit-identical, the first 3
   losses within ``rtol=1e-4, atol=1e-5`` of the same steps on the CPU.
   (b) Lazy schedules compiled on the card (``compiler="device"``), so
   the staging thread launches ``seg_sort``: the curve bit-equal to
   (a), ``seg_sort`` launched. (c) ``DeviceBaselineRunner``: lanes never
   fewer than (a)'s, the curve bit-equal. (d) (a) on topology ``2x2``:
   the curve bit-equal, the tier lanes adding up to (a)'s and the tier
   wire rows to the run's own. (e) (a) checkpointed after epoch 1 into a
   run state, resumed by a fresh runner over [1, 3): the stitched curve
   and final weights bit-equal. (f) (a) under the ``cache-loss`` fault
   profile: epoch 1 degraded (``cache_lost``), the curve bit-equal,
   ``trace_count`` at most 2. Launch counts are set to 0 before each
   run and read after it: ``assemble`` and ``gather_agg`` in every run,
   ``search`` and ``merge_gather`` in none. Prints per run and epoch the
   training ms a step, wall, ``stage_s``, ``exposed_stage_s``, the
   boundary copy, miss lanes and wire rows (and their tier split), each
   run's launches and peak memory.
9. The paper-metrics campaign (``repro_torch.eval``) and the chaos
   sweep (``repro_torch.fault.chaos``) on the card. (a) The paper's
   GraphSAGE at full width as a campaign built here from the port's
   ``grid``: host-sim and device cells of ``rapidgnn`` and ``dgl-metis``
   (``reddit_sim``, batch 1000, 4 greedy workers, n_hot 4096, 3 epochs,
   hidden 256, fan-outs (25, 10)), and the device pair again on ``2x2``:
   6 cells, run one at a time with the launch counts set to 0 before
   each. Gates: ``validate_report`` finds nothing, every differential
   check passes with every layer present (host vs device miss parity
   and bytes, rapid vs baseline, flat vs ``2x2``, ``one_compilation``
   with ``trace_count`` 1), each cell launched its kernels (device
   cells ``assemble``, ``gather_agg`` and its backward; host cells the
   last two; no cell ``search``), and the device rapid cell's curve is
   phase 8's
   (a) bit for bit, its first 3 losses within ``rtol=1e-4, atol=1e-5`` of
   phase 8's CPU steps. (b) The same grid with every schedule compiled
   on the card (``seg_sort`` in every cell, lazily in the device
   runners' stage thread): every count and curve bit-equal to (a); both
   runs' times printed side by side. (c) The fault campaign
   (``fault_grid``, the tiny graph): every check passes, the report
   validates, at least one degraded cell. (d) ``run_chaos(seed=0,
   fast=True)`` on the card: ``ok``, the serve sweep's ``trace_count``
   1, each train plan's fires and outcome equal to the same sweep on the
   CPU. Prints per cell the step time, warm wall, fetch counters, wire
   rows and their tiers, hit rate, trace count, staging, launches and
   peak memory; per pair the throughput speedup, the fetch and byte
   reductions and the modelled energy ratios; the check counts, the
   fault rows, the chaos table and each sub-phase's wall. The reports
   go to ``artifacts/BENCH_torch_paper.json``,
   ``BENCH_torch_paper_device.json``, ``BENCH_torch_fault.json`` and
   ``chaos_torch.json``.
10. LM training (``lm_loss`` and ``make_train_step`` through autograd,
   the launcher's ``AdamW(lr=3e-4, weight_decay=0.01,
   max_grad_norm=1.0)``), after phase 6's parameters are freed. (a)
   granite-3-2b (``configs/granite_3_2b.py``) at its full width and
   depth in bfloat16, parameters from a seeded generator on the card,
   B=1, S=4096 (``train_4k``'s sequence, its global batch cut to one
   card), 5 steps: the attention takes the chunked path under
   ``torch.utils.checkpoint``, so ``flash_attention`` and
   ``flash_decode`` must launch 0 times (counts set to 0 just before
   the steps, read just after); the last loss below the first; a second
   fresh run's loss curve bit-equal. Prints ms a step, tokens/s, the
   6·N·T model TFLOP/s, peak device memory and a ``torch.profiler``
   split of one more step's card time by op beside its wall; the token
   embedding's backward (an accumulating index backward over 4096 Zipf
   tokens) twice, bit-equal, with the card kernels it ran. (b) The
   reduced smollm-360m, gemma2-2b, granite-3-2b and qwen1.5-32b in
   float32, 3 steps of the launcher's batch (8 x 128) on the card and on
   the CPU from the same parameters: losses within ``rtol=1e-4,
   atol=1e-5``, a second card run bit-equal, no kernel launched.
11. Decode serving of the MoE, SSD and RG-LRU blocks, last, after
   phase 10's parameters are freed, each model freed before the next;
   bfloat16, parameters from a seeded generator on the card; the same
   prefill and decode as phase 6 (``forward`` at B=1; the launcher's
   greedy loop at B=8, prompt 16, gen 32, a second run bit-equal in
   tokens and every step's logits; launch counts set to 0 just before
   and read just after: one ``flash_attention`` an attention layer a
   prefill, one ``flash_decode`` an attention layer a step), with peak
   memory, ms a step, tokens/s and the card's time by op (a prefill, and
   8 decode steps from a one-token prompt). (a)
   mamba2-1.3b (``configs/mamba2_1_3b.py``), 48 ``ssm`` layers, S=8192,
   no kernel launched. (b) recurrentgemma-9b, 38 layers (12 x (rglru,
   rglru, local) + 2 rglru), S=8192: 12 and 564 launches; then
   ``flash_attention`` at 16 q heads a kv head on its first local
   layer's own q/k/v (window 2048, bf16, within one bfloat16 step of the
   plain version) and ``flash_decode`` at 16 q heads a kv head over a
   full 2048-slot window cache and the decode loop's 48-slot one (full
   and ragged lengths; float32 outputs, ``rtol=1e-4, atol=1e-5``, one
   card operation a call), timed
   beside their plain versions, SDPA (``enable_gqa``) and their bounds.
   (c) qwen3-moe-30b-a3b, 48 MoE layers (128 experts, top-8), 30.53 B
   parameters, S=4096 (the weights take 61 GB): 48 and 2,256 launches;
   then the same two kernels at its 8 q heads a kv head, dh 128: on its
   first layer's own q/k/v, and over a 4096-position cache and the
   decode loop's 48-slot one (full and ragged lengths).
   (d) the reduced qwen3-moe-30b-a3b, mamba2-1.3b, recurrentgemma-9b and
   arctic-480b in float32: prefill logits over 8 x 48 tokens and the 47
   decode steps of the same tokens on the card within ``rtol=1e-4,
   atol=1e-4`` of the same code on the CPU, a second card run bit-equal.
   Each sub-phase prints its wall.
12. Decode serving of the enc-dec and M-RoPE models, after phase 11's
   parameters are freed, each model freed before the next; bfloat16,
   parameters from a seeded generator on the card, the frontends stubbed
   by 0.02 x normal frame or patch embeddings (as the reference's data
   pipeline makes them); the same prefill and decode lines and gates as
   phase 11. (a) seamless-m4t-medium (``configs/seamless_m4t_medium.py``)
   at full width and depth, 12 encoder and 12 decoder layers: ``encode``
   of 4096 frames (the reference's ``SRC_LEN``) and ``forward`` with
   ``enc_out`` at S=8192 (36 ``flash_attention`` a prefill: 12 encoder,
   12 decoder self, 12 cross at Sq 8192, Skv 4096); the greedy loop at
   B=8 against cross caches written from ``encode`` of 8 sources, x_len
   4096 - 97 b (24 ``flash_decode`` a step); and once more against the
   launcher's empty caches (x_len = 0), whose tokens and logits must
   equal a run without cross caches bit for bit. (b) qwen2-vl-72b at
   full width, its 80 layers cut to 16 (33.1 GB of weights): ``forward``
   at S=8192 with patch embeddings and M-RoPE streams t = i, h = i // 64,
   w = i % 64 (16 launches), and the launcher's greedy loop (the
   position on all three streams; 16 a step). Each model's first
   attention layer's own q/k/v go through ``flash_attention`` (bf16):
   seamless's causal decoder self-attention (1, 8192, 16, 64) and
   qwen2-vl's after M-RoPE (1, 8192, 64, 128) with 8 kv heads; and
   ``flash_decode`` runs at each model's heads over an 8192-position
   cache and the loop's (8, 48) one. Then ``flash_attention`` at
   seamless's encoder shape (1, 4096, 16, 64) without a mask and its
   cross shape (1, 8192, 16, 64) over 4096 keys and a ragged 4001, and
   ``flash_decode`` over its cross caches (8, 4096, 16, 64) at the
   loop's ragged lengths, full ones and ones with a 0. Each is held
   against its plain version, one card operation a call, and timed
   beside it, SDPA and its bound. (c) both reduced configs in float32,
   8 x 48 tokens, prefill and 47 decode steps on the card within
   ``rtol=1e-4, atol=1e-4`` of the CPU, a second card run bit-equal.

13. The ``("data", "model")`` mesh: the KV cache sequence-sharded over
   ``model`` (``sharded_decode_attention``: one ``flash_decode`` launch
   over the B x tp folded shards, then the (acc, m, l) combine) and the
   experts expert-parallel over it (``moe_apply``). (a) inside phase 11,
   qwen3-moe-30b-a3b at full width and depth over (2, 2): the prefill at
   B=1, S=4096 (two data groups of 2048 tokens) and the greedy loop
   through ``serve_step(mesh=...)``, with phase 11's gates (48
   ``flash_decode`` a step, a second run bit-equal), the last prefill
   position's and the first decode step's logits beside the unsharded
   run's (they differ by design: each data group is routed alone), and
   the expert bytes a step. (b) inside phase 6, gemma2-2b's loop over
   (1, 4) (softcap, G = 2, the local ring caches), the same gates. (c)
   the ``flash_decode_sharded`` row: qwen3-moe's (8, 4096, 4, 128) cache
   at tp = 4, the folded partials against their plain version, the
   output against the plain sharded call and the plain unsharded
   attention, timed beside the folded launch alone, the unsharded call,
   SDPA and the byte bound; the same at the loop's (8, 48) cache. (d)
   last, two ranks of a gloo group on the one card
   (``torch.multiprocessing`` spawn, a ``FileStore``; NCCL takes one card
   a rank): ``sharded_decode_shard`` over (c)'s cache split in two and
   ``moe_shard`` of one full-width qwen3-moe layer (64 + 64 experts) at
   T = 8 and 4096, each bit-equal to the in-process form at (1, 2). (e)
   the reduced qwen3-moe-30b-a3b (capacity factor 1.0), arctic-480b and
   gemma2-2b in float32 over (2, 2), 8 x 48, within ``rtol=1e-4,
   atol=1e-4`` of the CPU, a second card run bit-equal. Each part prints
   its wall.

14. The dry-run. (a) ``launch.dryrun.run_one`` of all 10 archs x
   4 input shapes on the 16x16 and the 2x16x16 production meshes, shape
   only (``meta`` tensors), one spawned process a CPU core; FLOPs by
   ``run_one``'s exact extrapolation from traces at 0 and 1 repeats of
   the pattern (held equal to the whole trace by the CPU tests). One line a combination: argument GiB a device, ``fits_hbm``,
   FLOPs a device, the computed roofline. Gate: ``memory_allocated``
   unchanged across the matrix and CUDA never initialised by a process
   that traced. (b) gemma2-2b prefill (B=1, S=8192), qwen3-moe-30b-a3b
   decode (B=8, S=4096) and granite-3-2b train (B=1, S=4096) at full
   width on a (1, 1) mesh: the spec's inputs made on the card must grow
   the bytes asked of the allocator by ``argument_size_bytes`` exactly.
   On one device that only shows that ``materialize`` allocates what the
   shape-only leaves declare; the sharding arithmetic rests on the CPU
   test against the reference's compiled argument sizes. Then one step,
   finite, its peak above the inputs (measured) beside the dry-run's
   null temp, its launches. (c) ``launch.dryrun_gnn`` rank 0
   of a fake process group of 256, then 512, in one process of its
   own: collective calls and bytes by kind (counted at dispatch),
   per-worker argument MiB, step ms, launches; gates: finite loss, a
   second run equal in counted bytes and launches, ``assemble``,
   ``gather_agg`` and ``gather_agg_bwd`` launched.

15. The paper's configurations the earlier phases do not run, last. (a)
   The training launcher's own settings (``launch/train.py``: 4 metis
   parts, batch 1000, 3 epochs, n_hot 4096, fan-outs (25, 10)) on
   ``ogbn_products_sim`` (sage rapidgnn on the numpy and the ``device``
   schedule compiler, the baseline, GCN) and ``ogbn_papers_sim``: the
   ``device`` schedule bit-equal to the numpy one (and its curve to the
   numpy run's), a second card run bit-equal, the first 3 losses within
   ``rtol=1e-4, atol=1e-5`` of the same run on the CPU (plain versions;
   its later steps fetch without training), ``rpc_count``,
   ``remote_bytes``, ``hit_rate`` and the per-epoch misses equal to the
   CPU run's, the loss falling. (b) ``full_grid()``'s
   ``ogbn_products_sim``, batch-100, n_hot-32768 scenario, cut to 1 of
   its 2 epochs: rapidgnn, dgl-metis, dgl-random and gcn (fan-outs 50,
   50) through ``run_host_cell``, every differential check, the report;
   the gcn cell again bit-equal and its first steps against the CPU.
   (c) the runner on ``reddit_sim`` at 8 workers, flat twice and
   ``2x4``, beside 4 workers flat (ms a step, exchange ms, wire bytes,
   launches), with phase 8's gates; the device campaign pair at 8
   workers, flat and ``2x4``, with phase 9's. (d) the reduced float32
   gemma2-2b and granite-3-2b at ``long_500k`` against the CPU
   (``rtol=1e-4, atol=1e-4``); then each at full width and depth in
   bf16, B = 1, caches filled from a seed (gemma2-2b's global layers
   524,288 slots, granite-3-2b an 8192-slot window), one ``serve_step``
   at position 524,287: one ``flash_decode`` a layer, a second step
   bit-equal, the ring slots the reference's, each layer's launch within
   ``rtol=1e-4, atol=1e-5`` of its plain version on its own inputs, the
   logits within ``LONG_LOGIT_SHARE`` of the largest of the step through
   the plain version (the bf16 floor, ``tools/bf16_logit_floor.py``). New
   shapes timed: the ``gather_agg`` forward at d 100 and 128 and at
   fan-out 50, its backward at the products and gcn layer 1, ``seg_sort``
   at the products schedule; two ``flash_decode`` rows. Prints its wall.
16. The LM paths the card had not run, last. (a) The non-dense
   families trained reduced in float32, as phase 10 (b): qwen3-moe-30b-a3b
   and arctic-480b (the MoE dispatch and combine under autograd),
   mamba2-1.3b (the SSD chunk scan), recurrentgemma-9b at 5 layers (the
   RG-LRU scan, local attention, the rglru tail), seamless-m4t-medium
   (``encode``, cross-attention) and qwen2-vl-72b (M-RoPE streams, patch
   ``embeds``): 3 steps on the card within ``rtol=1e-4, atol=1e-5`` of
   the CPU, a second card run bit-equal, no kernel launched; then each
   through the launcher, ``launch.train.main(["--workload", "lm",
   ...])`` on ``cuda``, its last loss below its first, no kernel
   launched. (b) mamba2-1.3b at full width and depth in bfloat16 as phase
   10 (a) trains granite-3-2b (B=1, S=4096, 8 steps, the remat path and
   the in-place AdamW): losses finite and falling, a second fresh run
   bit-equal; ms a step, tokens/s, peak memory, the step's split and the
   traced step's card ms by op. (c) qwen1.5-32b at full width and depth
   in bfloat16 (64 layers, 35.2 B parameters, 70.4 GB, the largest model
   one card holds whole), after every earlier phase's tensors are freed:
   phase 6's prefill at B=1 and the longest S of (8192, 4096, 2048) whose
   reckoned bytes fit beside the weights (64 ``flash_attention`` a
   prefill) and its greedy loop at B=8, prompt 16, gen 32 (64
   ``flash_decode`` a step), each a second run bit-equal; the decode
   step's card time beside its byte bound (every weight read once at 3.35
   TB/s); ``flash_attention`` (1, S, 40, 128) causal and ``flash_decode``
   (8, 4096, 40, 128) and the loop's (8, 48) cache, G = 1 bf16 (the
   CUDA-core kernel), each against its plain version, one card operation
   a call, timed beside it, SDPA and its bound; then the reduced config
   through ``reduced_check``. Prints each part's wall.

Output: one ``kernel {...}`` line per kernel row (phase 11 adds
``flash_attention_g16``/``flash_decode_g16`` and ``flash_attention_g8``/
``flash_decode_g8``, the same two kernels at recurrentgemma-9b's 16 and
qwen3-moe-30b-a3b's 8 q heads a kv head; phase 12
``flash_attention_g1``, ``flash_attention_g1_encoder``,
``flash_attention_cross``, ``flash_attention_g8_s8192``,
``flash_decode_g1_self``, ``flash_decode_g8_h64`` and ``flash_decode_g1``,
the last over the cross caches; phase 13 ``flash_decode_sharded``;
phase 14 and 15 add their launches to the rows of the kernels they
ran, phase 15 ``flash_decode_gemma2-2b_long_500k`` and
``flash_decode_granite-3-2b_long_500k``, phase 16
``flash_attention_g1_h128`` and ``flash_decode_g1_h128`` at
qwen1.5-32b's heads), the script's wall, the
card's name and power limit, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the full record of a run is written (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "artifacts")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the non-tensor
#: fp32 / int32 operation rate and the dense bf16 tensor-core rate
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

#: the two-launch design the fused kernel replaced (search, then select)
#: at the serving shape, one call a replay (PERF.md section 6 rows 1 and
#: 2), logged beside the fused kernel
TWO_LAUNCH_SEARCH_MS = 0.0101
TWO_LAUNCH_SELECT_MS = 0.1262
#: the CUDA-core design's bf16 ``flash_decode`` times that the tensor-core
#: kernel replaced (PERF.md section 6 rows 7 and 7s; NVIDIA H100 80GB
#: HBM3, 700 W), logged beside each row: the row's full cache one call a
#: replay, and the decode loop's cache a call in a graph of 20 (the
#: sharded row: the folded launch alone)
OLD_DECODE_MS = {"flash_decode": (0.3559, 0.0066),
                 "flash_decode_g16": (0.1124, 0.0196),
                 "flash_decode_g8": (0.1417, 0.0135),
                 "flash_decode_g8_h64": (0.5332, 0.0134),
                 "flash_decode_g1_self": (0.1012, 0.0052),
                 "flash_decode_g1": (0.0518, None),
                 "flash_decode_sharded": (0.1384, 0.0130)}
#: the sources of the bf16 ``flash_decode`` rows: the tensor cores at G
#: >= 2, the CUDA cores at G = 1
DECODE_SOURCE = ("src/repro_torch/kernels/flash_decode/csrc/"
                 "flash_decode_mma.cu")
DECODE_G1_SOURCE = ("src/repro_torch/kernels/flash_decode/csrc/"
                    "flash_decode.cu")
#: the source of the bf16 ``flash_attention`` rows (warpgroup MMA, TMA)
ATTENTION_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_wgmma.cu")
#: the ``mma.sync`` design's bf16 ``flash_attention`` times that the
#: warpgroup-MMA kernel replaced (PERF.md section 6 row 6; NVIDIA H100
#: 80GB HBM3, 700 W), one call a replay, logged beside each row
OLD_ATTENTION_MS = {"flash_attention local": 1.221,
                    "flash_attention attn": 1.466,
                    "flash_attention_g16": 1.1831,
                    "flash_attention_g8": 0.7422,
                    "flash_attention_g1": 0.9827,
                    "flash_attention_g8_s8192": 5.5939,
                    "flash_attention_g1_encoder": 0.4582,
                    "flash_attention_cross": 0.9179}
#: the card-op name prefix of every bf16 ``flash_attention`` instance
ATTENTION_KERNEL = "flash_attention_wgmma_kernel<"
#: the ptxas instances of the bf16 attention kernels, none of which may
#: spill: ``flash_decode_mma_kernel`` at dh 64, 128, 256 and 2 and 4
#: warps, ``flash_attention_wgmma_kernel`` at dh 64, 128, 256
BF16_INSTANCES = {"flash_decode_mma_kernel<": 6, ATTENTION_KERNEL: 3}

DATASET = "reddit_sim"
PARTS = 4
WORKER = 0
SEEDS_PER_REQUEST = 64
MAX_BATCH_REQUESTS = 4
UNCACHED_REQUESTS = 8
FRESH_REQUESTS = 24
CPU_CHECKS = 2
TRAIN_BATCH = 1000
TRAIN_EPOCHS = 2
TRAIN_LR = 3e-3
CPU_LOSS_STEPS = 3
LM_ARCH = "gemma2-2b"
LM_FULL = True              # full width and depth (get_arch)
LM_SEED = 0
PREFILL_S = 8192
DECODE_B, DECODE_PROMPT, DECODE_GEN = 8, 16, 32
CHECK_B, CHECK_S, CHECK_ATOL = 2, 64, 1e-3
LONG_B, LONG_S = 16, 32768
DIST_EPOCHS = 1
EMB_WORKERS, EMB_BATCH, EMB_SEQ = 8, 16, 256
EMB_N_HOT, EMB_STEPS, EMB_S0 = 32768, 100, 7
LM_TRAIN_ARCH = "granite-3-2b"
#: 8 steps: without warm-up the launcher's AdamW lifts granite-3-2b's loss
#: for its first steps (11.27 to 18.27 at step 3) and brings it below the
#: first from step 6 (PERF.md, LM training)
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 1, 4096, 8
LM_TRAIN_REDUCED = ("smollm-360m", "gemma2-2b", "granite-3-2b",
                    "qwen1.5-32b")
LM_REDUCED_B, LM_REDUCED_S, LM_REDUCED_STEPS = 8, 128, 3
EMB_BWD_CALLS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` call: ``fn`` is captured once in a
    CUDA graph and the graph replayed ``iters`` times between CUDA
    events, so host launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_call(torch, fn, calls: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` call among ``calls`` captured back to
    back in one CUDA graph: a graph of one short call is replayed no
    faster than the host can launch graphs, which ``launch_floor_ms``
    shows, so a call of a few microseconds is timed this way too."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / calls


def launch_floor_ms(torch, device) -> dict:
    """``device_ms`` and ``device_ms_per_call`` of one tiny elementwise
    kernel: the first is the host's rate of graph replays, the second the
    card's cost of one more kernel in a graph."""
    x = torch.zeros(16, device=device)
    return {"one_call_a_replay_ms": device_ms(torch, lambda: x.add_(1)),
            "in_a_graph_ms": device_ms_per_call(torch, lambda: x.add_(1))}


#: CUgraphNodeType values the card runs (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def device_ops(torch, fn) -> list:
    """The card operations (kernels, copies, memsets) one ``fn()`` call
    runs: one call captured in a CUDA graph, its nodes counted with
    libcuda's ``cuGraphGetNodes``. A profiler trace loses events of short
    kernels late in a long run; a graph holds exactly what was launched.
    The capture's stream and graph take card memory outside PyTorch's
    cache, so the cache's unused blocks go back to the card first (beside
    qwen1.5-32b's 70.4 GB the cache held the rest)."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in _NODE_TYPES:
            kinds.append(_NODE_TYPES[kind.value])
    del graph
    return kinds


#: cycles of one dependent float add on the card, for the order's floor
ADD_CYCLES = 4


def max_sm_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    p = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    return float(p.stdout.strip().splitlines()[0])


def op_times_ms(torch, fn, calls: int = 20, tries: int = 3) -> dict:
    """Each card op's own time a ``fn()`` call, in launch order, by kernel
    name (its first 50 characters; `` #i`` added for the i-th launch of a
    name a call makes more than once, such as one kernel a sort pass),
    from ``torch.profiler`` over ``calls`` calls (traced again, up to
    ``tries`` times, where the trace lost an op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        per = len(ops) // calls
        names = [e.name[:50] for e in ops[:per]]
        if ops and [e.name[:50] for e in ops] == names * calls:
            break
    else:
        raise RuntimeError(f"the profiler saw {len(ops)} card ops over "
                           f"{calls} calls, not the same ops a call")
    keys = [f"{k} #{names[:i].count(k)}" if names.count(k) > 1 else k
            for i, k in enumerate(names)]
    out = dict.fromkeys(keys, 0.0)
    for i, e in enumerate(ops):
        out[keys[i % per]] += (e.time_range.end - e.time_range.start) \
            / 1e3 / calls
    return out


def bound_ms(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def beside_old(name: str, ms: float, lib_ms: float, loop: bool = False):
    """A ``flash_decode`` row's time against SDPA's and the CUDA-core
    design's (``OLD_DECODE_MS``; none for a row it has no time for), as a
    log phrase."""
    old = OLD_DECODE_MS.get(name, (None, None))[1 if loop else 0]
    txt = f"{ms / lib_ms:.2f}x SDPA's time"
    if old is not None:
        txt += f"; the CUDA-core design {old:.4f} ({old / ms:.2f}x this)"
    return txt


def beside_old_attention(name: str, ms: float) -> str:
    """A ``flash_attention`` row's time against the ``mma.sync`` design's
    (``OLD_ATTENTION_MS``), as a log phrase; empty for a row it has no
    time for (a reduced configuration's)."""
    old = OLD_ATTENTION_MS.get(name)
    return "" if old is None else \
        f"; the mma.sync design {old:.4f} ({old / ms:.2f}x this)"


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return p.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the served path
# ---------------------------------------------------------------------------

def build_world(torch, device):
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import GNNConfig, init_params

    exp = sage(DATASET, SEEDS_PER_REQUEST, workers=PARTS)
    t0 = time.perf_counter()
    g = load_dataset(exp.dataset, seed=0)
    pg = partition_graph(g, exp.num_workers, "greedy")
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    params = init_params(cfg, torch.Generator().manual_seed(exp.s0))
    log(f"world: {exp.dataset} nodes={g.num_nodes} edges={g.num_edges} "
        f"d={g.feat_dim} classes={g.num_classes} parts={exp.num_workers} "
        f"fanouts={exp.fanouts} hidden={exp.hidden_dim} "
        f"n_hot={exp.n_hot} built in {time.perf_counter() - t0:.2f} s")
    return exp, g, pg, sampler, cfg, params


def serve(torch, device, exp, g, pg, sampler, cfg, params, counters):
    import numpy as np
    from repro_torch.graph.sampler import rng_from
    from repro_torch.serve.gnn import (TIER_FRESH, TIER_UNCACHED,
                                       GNNInferenceService)

    svc = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        high_water=256, default_timeout_s=60.0, warm_interval_s=3600.0,
        device=device)
    log(f"service: m_max={svc.collator.m_max} "
        f"edge_max={svc.collator.edge_max} "
        f"rows/micro-batch={MAX_BATCH_REQUESTS * svc.collator.m_max}")
    rng = rng_from(exp.s0, 0x5345)
    streams = [rng.integers(0, g.num_nodes, size=SEEDS_PER_REQUEST)
               for _ in range(UNCACHED_REQUESTS + FRESH_REQUESTS)]
    responses, phases = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    svc.start()
    try:
        for tier, lo, hi in ((TIER_UNCACHED, 0, UNCACHED_REQUESTS),
                             (TIER_FRESH, UNCACHED_REQUESTS, len(streams))):
            if tier == TIER_FRESH:
                if not svc.warmer.warm_now():
                    raise RuntimeError("warm cycle published nothing")
            t0 = time.perf_counter()
            pendings = [svc.submit(s) for s in streams[lo:hi]]
            got = [p.result(timeout=600.0) for p in pendings]
            wall = time.perf_counter() - t0
            lat = sorted(r.latency_s for r in got)
            bad = [r.rid for r in got if r.tier != tier]
            if bad:
                raise RuntimeError(f"requests {bad} not served {tier}")
            phases[tier] = {
                "requests": len(got), "wall_s": wall,
                "requests_per_s": len(got) / wall,
                "p50_ms": 1e3 * lat[len(lat) // 2],
                "p99_ms": 1e3 * lat[min(len(lat) - 1,
                                        int(0.99 * len(lat)))]}
            responses += got
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in counters}
        peak = torch.cuda.max_memory_allocated()
    finally:
        svc.close()
    err = svc.pending_error()
    if err is not None:
        raise RuntimeError(f"dispatcher failed: {err!r}")
    for name, n in launches.items():
        # the fused assembly ranks inside its own kernel: no search
        if (n == 0) != (name == "search"):
            raise RuntimeError(f"kernel {name} was launched {n} times "
                               f"while serving")
    # correctness: finite logits of the expected shape, bit-equal to the
    # clean single-request oracle
    for r in responses:
        if r.logits.shape != (SEEDS_PER_REQUEST, g.num_classes) or \
                not np.isfinite(r.logits).all():
            raise RuntimeError(f"request {r.rid}: bad logits "
                               f"{r.logits.shape}")
        want = svc.oracle(streams[r.rid], r.rid)
        if not (want.tobytes() == r.logits.tobytes()):
            raise RuntimeError(f"request {r.rid} is not bit-equal to "
                               f"the oracle")
    health = svc.health()
    for k, n in (("served_uncached", UNCACHED_REQUESTS),
                 ("served_fresh", FRESH_REQUESTS), ("errors", 0)):
        if health[k] != n:
            raise RuntimeError(f"health {k}={health[k]}, expected {n}")
    log(f"served {len(responses)} requests, all bit-equal to the oracle; "
        f"launches while serving {json.dumps(launches)}")
    for tier, ph in phases.items():
        log(f"serve {tier}: {ph['requests']} requests in "
            f"{ph['wall_s']:.3f} s = {ph['requests_per_s']:.2f} req/s, "
            f"p50 {ph['p50_ms']:.2f} ms, p99 {ph['p99_ms']:.2f} ms")
    log(f"peak device memory while serving: {peak / 2**20:.1f} MiB")
    log(f"health: {json.dumps(health)}")
    return svc, streams, responses, launches, phases, peak


def check_against_cpu(exp, pg, sampler, cfg, params, streams, responses):
    """The same service on the CPU (plain PyTorch versions) for a few
    requests: the card's responses must agree to the reference's
    cross-program tolerance."""
    import numpy as np
    from repro_torch.serve.gnn import GNNInferenceService

    cpu = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        device="cpu")
    try:
        worst = 0.0
        for r in responses[:CPU_CHECKS]:
            want = cpu.oracle(streams[r.rid], r.rid)
            np.testing.assert_allclose(r.logits, want, rtol=1e-4, atol=1e-5)
            worst = max(worst, float(np.abs(r.logits - want).max()))
    finally:
        cpu.close()
    log(f"card vs CPU plain path: {CPU_CHECKS} responses within "
        f"rtol=1e-4 atol=1e-5 (max abs diff {worst:.3e})")


def breakdown(torch, device, exp, pg, sampler, cfg, params, streams):
    """Where the time of one full fresh micro-batch goes. A second
    service on the card is stepped synchronously (no dispatcher thread);
    its program (H2D copies, kernels, GEMMs, D2H copy) is timed on the
    host clock with the card synchronised, the rest of the step
    (collation, host assembly, residual pulls) is host time, and one more
    step is traced by ``torch.profiler`` for the card's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.gnn import GNNInferenceService

    svc = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        default_timeout_s=60.0, device=device)
    program, program_s = svc.program, []

    def timed_program(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = program(*args)          # ends in a D2H copy: synchronised
        program_s.append(time.perf_counter() - t0)
        return out
    svc.program = timed_program
    batch = streams[:MAX_BATCH_REQUESTS]

    def step() -> float:
        for s in batch:
            svc.submit(s)
        t0 = time.perf_counter()
        if svc.step(timeout=1.0) != len(batch):
            raise RuntimeError("breakdown step served a partial batch")
        return time.perf_counter() - t0
    try:
        step()                        # uncached: gives the warmer traffic
        if not svc.warmer.warm_now():
            raise RuntimeError("warm cycle published nothing")
        step()
        program_s.clear()
        step_s = sorted(step() for _ in range(3))[1]
        prog_s = sorted(program_s)[1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_s = step()
    finally:
        svc.close()
    # the card's own events (kernels, copies, memsets); the CPU ops that
    # launched them carry the same time again, so they are left out
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    out = {"step_ms": 1e3 * step_s, "program_ms": 1e3 * prog_s,
           "host_ms": 1e3 * (step_s - prog_s),
           "traced_step_ms": 1e3 * traced_s, "card_busy_ms": busy_us / 1e3,
           "card_busy_share": busy_us / 1e6 / traced_s,
           "top_device_ms": {e.key: e.self_device_time_total / 1e3
                             for e in top}}
    log(f"fresh micro-batch ({MAX_BATCH_REQUESTS} requests): step "
        f"{out['step_ms']:.2f} ms = program {out['program_ms']:.2f} ms + "
        f"host {out['host_ms']:.2f} ms; traced step "
        f"{out['traced_step_ms']:.2f} ms, card busy "
        f"{out['card_busy_ms']:.3f} ms ({100 * out['card_busy_share']:.2f} %)")
    log(f"card time by op in the traced step (ms): "
        f"{json.dumps(out['top_device_ms'])}")
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, and its times
# ---------------------------------------------------------------------------

def served_inputs(torch, device, svc, streams, responses):
    """The device inputs of one served micro-batch (the first R fresh
    requests), rebuilt deterministically: collation is rid-keyed and
    the features read straight from the table, as ``oracle()`` does."""
    import numpy as np
    from repro_torch.serve.gnn.request import InferenceRequest

    fresh = [r for r in responses if r.tier == "fresh"][:MAX_BATCH_REQUESTS]
    reqs = [InferenceRequest(rid=r.rid, seeds=streams[r.rid],
                             deadline=float("inf"), submitted_at=0.0)
            for r in fresh]
    mb = svc.collator.collate_micro_batch(reqs)
    ids, mask = mb.input_nodes, mb.input_mask
    dev = svc.dv.g2d[np.where(mask, ids, 0)]
    query = np.where(mask, dev, -1).astype(np.int32).reshape(-1)
    pulled = np.zeros(mask.shape + (svc.store.d,), np.float32)
    pulled[mask] = svc.store.feat[ids[mask]]
    snap, _ = svc.warmer.snapshot()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"table": svc._table, "base": svc._base,
            "cache_ids": t(snap.dev_ids), "cache_feats": t(snap.dev_feats),
            "query": t(query), "pulled": t(pulled.reshape(-1, svc.store.d)),
            "edge_src": [t(e) for e in mb.edge_src],
            "edge_mask": [t(e) for e in mb.edge_mask],
            "params": svc.params, "fanouts": svc.cfg.fanouts,
            "R": MAX_BATCH_REQUESTS, "m": svc.collator.m_max}


def embedding_bag_mean(torch, h, src, msk, nd: int, fanout: int):
    """The one-call library yardstick of ``gather_agg``:
    ``F.embedding_bag`` in mean mode, one bag of ``fanout`` indices per
    dst row. A masked edge points at a row that no unmasked edge reads,
    named ``padding_idx``, so it neither adds nor counts. -> the call, or
    None when every row of ``h`` is read."""
    import torch.nn.functional as F
    read = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    read[src.long()[msk]] = True
    free = torch.nonzero(~read)
    if free.shape[0] == 0:
        return None
    pad = int(free[0, 0].item())
    idx = torch.where(msk, src.long(), pad).reshape(nd, fanout)
    return lambda: F.embedding_bag(idx, h, mode="mean", padding_idx=pad)


def _equal(torch, a, b) -> float:
    if not torch.equal(a, b):
        diff = (a.double() - b.double()).abs().max().item()
        raise RuntimeError(f"kernel differs from its plain version "
                           f"(max abs diff {diff})")
    return 0.0


def awkward_cases(torch, device):
    """(name, cache_ids, cache_feats, table, base, query, pulled) with
    shapes the tile-free kernels must still take: m = 1, an empty cache,
    d not a multiple of 4 or 128, all-hit, all-local, -1 and sentinel
    queries."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    sentinel = 2 ** 31 - 1
    out = []
    for name, m, n_hot, d, kind in (("m_one", 1, 8, 33, "mixed"),
                                    ("empty_cache", 257, 0, 602, "mixed"),
                                    ("d_130", 1000, 64, 130, "mixed"),
                                    ("all_hit", 300, 64, 602, "hit"),
                                    ("all_local", 300, 16, 5, "local"),
                                    ("padded", 513, 32, 7, "padded")):
        n_per, base, n_total = 200, 400, 2000
        table = torch.randn((n_per, d), generator=gen)
        remote = torch.cat([torch.arange(0, base),
                            torch.arange(base + n_per, n_total)])
        ids = remote[torch.randperm(remote.shape[0], generator=gen)[:n_hot]]
        ids = ids.sort().values.to(torch.int32)
        feats = torch.randn((n_hot, d), generator=gen)
        if kind == "hit":
            q = ids[torch.randint(0, n_hot, (m,), generator=gen)]
        elif kind == "local":
            q = torch.randint(base, base + n_per, (m,), generator=gen)
        else:
            q = torch.randint(0, n_total, (m,), generator=gen)
            if n_hot:
                q[::3] = ids[torch.randint(0, n_hot, (q[::3].shape[0],),
                                           generator=gen)]
            if kind == "padded":
                q[::4] = -1
                q[1::6] = sentinel
        q = q.to(torch.int32)
        pulled = torch.randn((m, d), generator=gen)
        out.append((name, *(x.to(device) for x in (ids, feats, table)),
                    base, q.to(device), pulled.to(device)))
    return out


def big_cache_cases(torch, device):
    """The awkward cases' form at the paper grid's largest hot set (n_hot
    32,768, ``repro/eval/spec.py``) and beyond a one-line splitter table
    (70,000 ids: 64-id segments, a fourth 32-ary level), d 602."""
    gen = torch.Generator(device="cpu").manual_seed(23)
    sentinel = 2 ** 31 - 1
    out = []
    for n_hot in (32768, 70000):
        m, d, n_per, base = 4096, 602, 200, 4 * n_hot
        ids = torch.randperm(4 * n_hot, generator=gen)[:n_hot - 3].sort() \
            .values.to(torch.int32)
        ids = torch.cat([ids, torch.full((3,), sentinel, dtype=torch.int32)])
        q = torch.randint(0, 4 * n_hot + n_per, (m,), generator=gen)
        q[::3] = ids[torch.randint(0, n_hot - 3, (q[::3].shape[0],),
                                   generator=gen)]
        q[::5] = -1
        q[1::7] = sentinel
        q[:2] = torch.stack([ids[0], ids[n_hot - 4]])
        out.append((f"n_hot_{n_hot}", ids.to(device),
                    torch.randn((n_hot, d), generator=gen).to(device),
                    torch.randn((n_per, d), generator=gen).to(device), base,
                    q.to(torch.int32).to(device),
                    torch.randn((m, d), generator=gen).to(device)))
    return out


def gather_agg_row(torch, h, src, msk, nd: int, fo: int, what: str):
    """The ``gather_agg`` forward at one shape: bit-equal to its plain
    version on the card (both sum each row's unmasked rows in edge order
    from +0 and divide by IEEE division) and to a second run, one card
    operation a call, timed one call a replay and 20 calls to a graph,
    beside the plain version, ``F.embedding_bag`` and the byte bound (the
    distinct source rows the unmasked edges read, the output, the edge
    lists). -> {"out": the result, "row": the measurements}."""
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    def call():
        return gather_ops.gather_agg(h, src, msk, nd=nd, fanout=fo)
    got = call()
    _equal(torch, got, gather_agg_ref(h, src, msk, nd, fo))
    _equal(torch, call(), got)
    ops = device_ops(torch, call)
    if len(ops) != 1:
        raise RuntimeError(f"gather_agg {what}: {len(ops)} card operations "
                           f"a call ({ops}), one kernel expected")
    d = h.shape[1]
    unmasked = int(msk.sum().item())
    nbytes = (torch.unique(src.long()[msk]).shape[0] * d * 4 + nd * d * 4
              + src.shape[0] * (4 + 1))
    lib = embedding_bag_mean(torch, h, src, msk, nd, fo)
    if lib is not None and not torch.allclose(lib(), got, rtol=1e-5,
                                              atol=1e-6):
        raise RuntimeError(f"embedding_bag yardstick of {what} computes "
                           f"another function")
    r = {"what": what, "err": 0.0,
         "bound": bound_ms(nbytes, unmasked * d + nd * d),
         "ms": device_ms(torch, call),
         "ms_in_a_graph": device_ms_per_call(torch, call),
         "plain_ms": device_ms(torch, lambda: gather_agg_ref(
             h, src, msk, nd, fo)),
         "library_ms": None if lib is None else device_ms(torch, lib),
         "library_ms_in_a_graph": (None if lib is None
                                   else device_ms_per_call(torch, lib)),
         "device_ops": len(ops),
         "shape": f"h=({h.shape[0]},{d}) nd={nd} fanout={fo} "
                  f"unmasked={unmasked}"}
    lib_s = "none" if lib is None else (
        f"{r['library_ms']:.4f} ({r['library_ms_in_a_graph']:.4f} in a "
        f"graph; F.embedding_bag)")
    log(f"gather_agg {what}: {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 20) plain_ms="
        f"{r['plain_ms']:.4f} library_ms={lib_s} bound_ms="
        f"{r['bound'][0]:.4f} ({nbytes / 1e6:.1f} MB); 1 card op a call; "
        f"bit-equal to the plain version and to a second run")
    return {"out": got, "row": r}


def gather_awkward(torch, device):
    """The ``gather_agg`` forward at the edges of its plan, bit-equal to
    its plain version: d 1 / 3 / 130 / 256 / 602, rows starting 16-, 8- and
    4-byte aligned (each vector width), fan-outs 1 / 10 / 25 / 33 / 50 (a
    fan-out above 32 is loaded in rounds of 32), nd 1, few rows (columns
    split over warps) and many, fully masked rows."""
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    gen = torch.Generator(device="cpu").manual_seed(17)
    for nd, fo, m, d, off in ((1, 1, 5, 1, 0), (7, 50, 40, 3, 0),
                              (2, 33, 10, 130, 0), (300, 25, 500, 602, 0),
                              (300, 25, 500, 602, 1), (1000, 10, 3000, 256, 0),
                              (1000, 10, 3000, 256, 2),
                              (1000, 10, 3000, 256, 1),
                              (6000, 10, 3000, 256, 0), (1, 25, 30, 602, 0)):
        # h starts `off` floats into its storage: 16-, 8- or 4-byte aligned
        flat = torch.empty(m * d + off, device=device)
        flat[off:] = torch.randn(m * d, generator=gen).to(device)
        h = flat[off:].view(m, d)
        src = torch.randint(0, m, (nd * fo,), generator=gen,
                            dtype=torch.int32).to(device)
        msk = (torch.rand(nd * fo, generator=gen) < 0.7).to(device)
        msk[:fo] = False                      # a fully masked row
        _equal(torch, gather_ops.gather_agg(h, src, msk, nd=nd, fanout=fo),
               gather_agg_ref(h, src, msk, nd, fo))
    log("awkward shapes: gather_agg (d 1/3/130/256/602, rows 16-, 8- and "
        "4-byte aligned, fan-out 1/10/25/33/50, nd 1 to 6000, fully masked "
        "rows) bit-equal to its plain version")


def kernel_phase(torch, device, x, launches):
    from repro_torch.kernels.assemble import ops as assemble_ops
    from repro_torch.kernels.assemble.ref import assemble_ref
    from repro_torch.kernels.cache_lookup import ops as search_ops
    from repro_torch.kernels.cache_lookup.ref import search_ref
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    R, m, d = x["R"], x["m"], x["pulled"].shape[1]
    M = R * m
    ids, q, pulled = x["cache_ids"], x["query"], x["pulled"]
    table, base, feats = x["table"], x["base"], x["cache_feats"]
    n_hot = ids.shape[0]
    results = []

    # -- search ------------------------------------------------------------
    pos, hit = search_ops.search(ids, q)
    err = _equal(torch, pos, search_ref(ids, q)[0])
    _equal(torch, hit, search_ref(ids, q)[1])
    if device_ops(torch, lambda: search_ops.search(ids, q)) != ["kernel"]:
        raise RuntimeError("search: more than its one kernel a call")
    nbytes = M * 4 + n_hot * 4 + M * 4 + M * 1
    ops = M * max(1, n_hot.bit_length())
    b, by = bound_ms(nbytes, ops)

    def lib_search():
        return torch.searchsorted(ids, q, out_int32=True)
    results.append({
        "name": "search", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_lookup/csrc/search.cu",
        "replaces": "src/repro/kernels/cache_lookup/cache_lookup.py:49",
        "launches": launches["search"], "max_abs_err": err,
        "ms": device_ms(torch, lambda: search_ops.search(ids, q)),
        "plain_ms": device_ms(torch, lambda: search_ref(ids, q)),
        "bound_ms": b, "bound_by": by,
        "library_ms": device_ms(torch, lib_search),
        # one call a replay is paced by the host's graph launches: the
        # same calls 20 to a graph give the card's own time a call
        "ms_in_a_graph": device_ms_per_call(
            torch, lambda: search_ops.search(ids, q)),
        "library_ms_in_a_graph": device_ms_per_call(torch, lib_search),
        "shape": f"queries={M} n_hot={n_hot}",
        "hit_rate": float(hit.float().mean().item())})
    r = results[-1]
    log(f"search: {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 20) library_ms="
        f"{r['library_ms']:.4f} ({r['library_ms_in_a_graph']:.4f} in a "
        f"graph; torch.searchsorted) bound_ms={r['bound_ms']:.6f}")

    # -- assemble: rank, classify and copy in one launch --------------------
    def fused():
        return assemble_ops.assemble_features(table, base, ids, feats, q,
                                              pulled, backend="fused")

    def plain():
        return assemble_ref(table, base, ids, feats, q, pulled)
    before = (assemble_ops.LAUNCHES.value, search_ops.LAUNCHES.value)
    out = fused()
    if (assemble_ops.LAUNCHES.value - before[0],
            search_ops.LAUNCHES.value - before[1]) != (1, 0):
        raise RuntimeError("the fused assembly launched other than its one "
                           "kernel")
    err = _equal(torch, out, plain())
    ops = device_ops(torch, fused)
    if ops != ["kernel"]:
        raise RuntimeError(f"fused assembly: card operations {ops}, one "
                           f"kernel expected")
    nbytes = 2 * M * d * 4 + M * 4 + n_hot * 4
    b, by = bound_ms(nbytes, 0)
    results.append({
        "name": "assemble", "route": "cuda",
        "source": "src/repro_torch/kernels/assemble/csrc/assemble.cu",
        "replaces": "src/repro/kernels/assemble/assemble.py:56",
        "launches": launches["assemble"], "max_abs_err": err,
        "ms": device_ms(torch, fused), "plain_ms": device_ms(torch, plain),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "ms_in_a_graph": device_ms_per_call(torch, fused),
        "shape": f"rows={M} d={d} n_hot={n_hot} n_per={table.shape[0]}"})
    r = results[-1]
    log(f"assemble (fused): {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 20) plain_ms="
        f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.6f} ({nbytes / 1e6:.1f}"
        f" MB; {100 * r['bound_ms'] / r['ms']:.1f} % of the bound); 1 launch,"
        f" 1 card op, no search; bit-equal to assemble_ref. The replaced two"
        f" launches at this shape: {TWO_LAUNCH_SEARCH_MS} (search) + "
        f"{TWO_LAUNCH_SELECT_MS} (select) ms (PERF.md section 6, NVIDIA H100 "
        f"80GB HBM3, 700 W)")

    # -- gather_agg, layer 0 then layer 1 of the served forward ------------
    layers = []
    h = out
    for l, fo in enumerate(x["fanouts"]):
        es, em = x["edge_src"][l], x["edge_mask"][l]
        nd = es.shape[1] // fo
        shift = (torch.arange(R, dtype=torch.int32, device=device)
                 * m)[:, None]
        src = (es + shift).reshape(-1)
        msk = em.reshape(-1).contiguous()
        res = gather_agg_row(torch, h, src, msk, R * nd, fo,
                             f"serving layer {l}")
        layers.append(res["row"])
        got = res["out"]
        # next layer's input: this layer's SAGE update of the same rows
        p = x["params"]["layers"][l]
        agg = torch.cat([got.reshape(R, nd, -1),
                         got.new_zeros((R, m - nd, got.shape[1]))], dim=1)
        h3 = h.reshape(R, m, -1)
        h = torch.relu(h3 @ p["w_self"] + agg @ p["w_neigh"] + p["b"]) \
            .reshape(M, -1).contiguous()
    results.append({
        "name": "gather_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/gather_agg/csrc/gather_agg.cu",
        "replaces": "src/repro/kernels/gather_agg/gather_agg.py:30",
        "launches": launches["gather_agg"],
        "max_abs_err": max(L["err"] for L in layers),
        "ms": sum(L["ms"] for L in layers),
        "plain_ms": sum(L["plain_ms"] for L in layers),
        "bound_ms": sum(L["bound"][0] for L in layers),
        "bound_by": layers[0]["bound"][1],
        "library_ms": (None if any(L["library_ms"] is None for L in layers)
                       else sum(L["library_ms"] for L in layers)),
        "ms_in_a_graph": sum(L["ms_in_a_graph"] for L in layers),
        "shape": " + ".join(L["shape"] for L in layers),
        "layers": layers})

    # -- awkward shapes ------------------------------------------------------
    gather_awkward(torch, device)
    for name, cids, cfeats, tab, b0, qq, pp in (awkward_cases(torch, device)
                                                + big_cache_cases(torch,
                                                                  device)):
        got = assemble_ops.assemble_features(tab, b0, cids, cfeats, qq, pp,
                                             backend="fused")
        _equal(torch, got, assemble_ref(tab, b0, cids, cfeats, qq, pp))
        if cids.shape[0]:
            p1, h1 = search_ops.search(cids, qq)
            p2, h2 = search_ref(cids, qq)
            _equal(torch, p1, p2)
            _equal(torch, h1, h2)
        nd_, fo_ = max(1, pp.shape[0] // 7), 7
        gsrc = (qq.abs() % pp.shape[0]).repeat(fo_)[:nd_ * fo_] \
            .contiguous()
        gmsk = (torch.arange(nd_ * fo_, device=device) % 3) != 0
        ga = gather_ops.gather_agg(pp, gsrc, gmsk, nd=nd_, fanout=fo_)
        _equal(torch, ga, gather_agg_ref(pp, gsrc, gmsk, nd_, fo_))
    log("awkward shapes: search, assemble and gather_agg equal to their "
        "plain versions (n_hot 0/8/16/32/64/32768/70000)")
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 4: the training path
# ---------------------------------------------------------------------------

def train_world(g):
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=PARTS, epochs=TRAIN_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    return exp, sampler, cfg


def schedule_kw(exp):
    return dict(worker=WORKER, s0=exp.s0, num_epochs=exp.num_epochs,
                n_hot=exp.n_hot)


def build_device_schedule(torch, device, exp, sampler, pg):
    """The schedule compiled on the card, with the largest key stream
    the compiler handed ``seg_sort`` kept (a copy) for the kernel rows."""
    import repro_torch.graph.device_sampler as dsm
    from repro_torch.core import build_schedule

    real, seen = dsm.seg_sort, {"n": -1}

    def recording(keys, payload=None, **kw):
        if payload is None and keys.shape[0] > seen["n"]:
            seen.update(n=keys.shape[0], keys=keys.clone(),
                        num_bits=kw["num_bits"])
        return real(keys, payload, **kw)
    dsm.seg_sort = recording
    try:
        t0 = time.perf_counter()
        ws = build_schedule(sampler, pg, compiler="device", device=device,
                            **schedule_kw(exp))
        seconds = time.perf_counter() - t0
    finally:
        dsm.seg_sort = real
    return ws, seconds, seen


def check_schedules_equal(ref, dev, n_epochs: int) -> None:
    """Every FlatEpoch array (dtype too), the hot set, the remote ids and
    frequencies and the pad bounds: bit-equal, or raise."""
    import numpy as np

    def same(a, b, what):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"device-compiled schedule differs from the "
                               f"numpy compiler's: {what}")
    for e in range(n_epochs):
        a, b = ref.epoch(e), dev.epoch(e)
        if a.m_max != b.m_max:
            raise RuntimeError(f"epoch {e}: m_max {a.m_max} != {b.m_max}")
        for f in ("seeds", "seed_starts", "input_nodes", "input_starts",
                  "num_dst"):
            same(getattr(a.flat, f), getattr(b.flat, f), f"epoch {e} {f}")
        for f in ("edge_src", "edge_dst", "edge_mask", "edge_starts"):
            for l, (x, y) in enumerate(zip(getattr(a.flat, f),
                                           getattr(b.flat, f))):
                same(x, y, f"epoch {e} {f}[{l}]")
        for f in ("cache_ids", "remote_ids", "remote_freq"):
            same(getattr(a, f), getattr(b, f), f"epoch {e} {f}")
    if ref.pad_bounds() != dev.pad_bounds():
        raise RuntimeError(f"pad bounds {ref.pad_bounds()} != "
                           f"{dev.pad_bounds()}")


def train_run(torch, device, exp, cfg, ws, pg, capture: int = 0,
              system: str = "rapidgnn", train_steps=None):
    """``RapidGNNRunner`` (``BaselineRunner`` for ``system="baseline"``)
    over the schedule with the port's train step on ``device``,
    parameters from ``exp.s0``; with ``train_steps``, only the first
    that many steps train and the rest fetch alone (the runner's fetch
    counters do not depend on the step). -> per-step losses, the run's
    metrics and wall time, the first ``capture`` (features, batch)
    pairs the step was given, and per-step (H2D, step) host seconds."""
    from repro_torch.core import (BaselineRunner, NetworkModel,
                                  RapidGNNRunner, ShardedFeatureStore)
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    params = init_params(cfg, torch.Generator().manual_seed(exp.s0), device)
    opt = AdamW(lr=TRAIN_LR)
    state = [params, opt.init(params)]
    step = make_train_step(cfg, opt)
    hist, captured, split = [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def train_fn(feats, cb):
        if train_steps is not None and len(hist) >= train_steps:
            return 0.0
        if len(captured) < capture:
            captured.append((feats.copy(), cb))
        t0 = time.perf_counter()
        batch = batch_to_device(cb, feats, device)
        sync()
        t1 = time.perf_counter()
        state[0], state[1], aux = step(state[0], state[1], batch)
        hist.append(float(aux["loss"]))       # waits for the step
        split.append((t1 - t0, time.perf_counter() - t1))
        return hist[-1]

    store = ShardedFeatureStore(pg, worker=WORKER,
                                net=NetworkModel(enabled=False))
    if system == "baseline":
        runner = BaselineRunner(ws, store, batch_size=exp.batch_size,
                                train_fn=train_fn)
    else:
        runner = RapidGNNRunner(ws, store, batch_size=exp.batch_size,
                                Q=exp.Q, train_fn=train_fn)
    t0 = time.perf_counter()
    metrics = runner.run()
    return hist, metrics, time.perf_counter() - t0, captured, split


def cpu_losses(torch, seed: int, cfg, captured):
    """The first steps again on the CPU (plain versions), from the same
    parameters (drawn from ``seed``) and the same batches."""
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(seed), cpu)
    opt = AdamW(lr=TRAIN_LR)
    state, step, out = opt.init(params), make_train_step(cfg, opt), []
    for feats, cb in captured:
        params, state, aux = step(params, state,
                                  batch_to_device(cb, feats, cpu))
        out.append(float(aux["loss"]))
    return out


def trace_steps(torch, device, exp, cfg, captured):
    """Card time by op over the captured steps (H2D copy included),
    traced by ``torch.profiler``; parameters fresh from the seed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    params = init_params(cfg, torch.Generator().manual_seed(exp.s0), device)
    opt = AdamW(lr=TRAIN_LR)
    state, step = opt.init(params), make_train_step(cfg, opt)
    feats, cb = captured[0]
    params, state, _ = step(params, state, batch_to_device(cb, feats, device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for feats, cb in captured:
            params, state, aux = step(params, state,
                                      batch_to_device(cb, feats, device))
            float(aux["loss"])
        traced_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    n = len(captured)
    return {"steps": n, "traced_step_ms": 1e3 * traced_s / n,
            "card_busy_ms_per_step": busy_us / 1e3 / n,
            "card_busy_share": busy_us / 1e6 / traced_s,
            "top_device_ms_per_step": {
                e.key: e.self_device_time_total / 1e3 / n for e in top}}


def train_phase(torch, device, g, pg, counters):
    """Schedule on the card (bit-equal to the numpy compiler), then
    ``TRAIN_EPOCHS`` epochs of RapidGNN training through the kernels,
    held against the CPU and against a second run on the card."""
    import numpy as np
    from repro_torch.core import build_schedule

    exp, sampler, cfg = train_world(g)
    t0 = time.perf_counter()
    ref = build_schedule(sampler, pg, compiler="batched", **schedule_kw(exp))
    numpy_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    ws, device_s, sort_input = build_device_schedule(torch, device, exp,
                                                     sampler, pg)
    schedule_sorts = next(c.value for c in counters if c.name == "seg_sort")
    hist, metrics, wall, captured, split = train_run(
        torch, device, exp, cfg, ws, pg, capture=CPU_LOSS_STEPS)
    torch.cuda.synchronize()
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check_schedules_equal(ref, ws, exp.num_epochs)
    m_max, edge_max = ws.pad_bounds()
    log(f"train schedule: {exp.num_epochs} epochs x "
        f"{ws.epoch(0).num_batches} batches, m_max={m_max} "
        f"edge_max={edge_max}; device compiler bit-equal to numpy; build "
        f"ms per epoch: device {1e3 * device_s / exp.num_epochs:.1f}, "
        f"numpy {1e3 * numpy_s / exp.num_epochs:.1f}")
    steps = len(hist)
    want = sum(ws.epoch(e).num_batches for e in range(exp.num_epochs))
    if steps != want or not np.isfinite(hist).all():
        raise RuntimeError(f"{steps} steps of {want}, losses {hist}")
    if launches["seg_sort"] == 0 or launches["gather_agg"] == 0:
        raise RuntimeError(f"training did not launch every kernel of its "
                           f"path: {launches}")
    # the schedule compiler sorts; the backward orders its edges inside
    # its own kernel and launches no seg_sort
    if launches["seg_sort"] != schedule_sorts:
        raise RuntimeError(f"seg_sort launched {launches['seg_sort']} times, "
                           f"{schedule_sorts} of them for the schedule: the "
                           f"backward sorted")
    # one backward launch a step: layer 1 only, never layer 0, whose
    # input (the features) needs no gradient
    if launches["gather_agg_bwd"] != steps:
        raise RuntimeError(f"gather_agg_bwd launched "
                           f"{launches['gather_agg_bwd']} times in {steps} "
                           f"steps (once a step, at layer 1, expected)")
    cpu = cpu_losses(torch, exp.s0, cfg, captured)
    np.testing.assert_allclose(hist[:CPU_LOSS_STEPS], cpu, rtol=1e-4,
                               atol=1e-5)
    again, _, wall2, _, _ = train_run(torch, device, exp, cfg, ws, pg)
    if again != hist:
        raise RuntimeError(f"a second run on the card gave another loss "
                           f"curve: {hist} vs {again}")
    tot = metrics.totals()
    h2d = sorted(a for a, _ in split)
    stp = sorted(b for _, b in split)
    out = {
        "schedule_ms_per_epoch": {"device": 1e3 * device_s / exp.num_epochs,
                                  "numpy": 1e3 * numpy_s / exp.num_epochs},
        "m_max": m_max, "edge_max": edge_max,
        "sort_stream": {"n": sort_input["n"],
                        "num_bits": sort_input["num_bits"]},
        "steps": steps, "losses": hist, "cpu_losses": cpu,
        "wall_s": wall, "wall_s_second_run": wall2,
        "steps_per_s": steps / wall,
        "prefetch_stall_ms_per_step": 1e3 * tot["fetch_stall_s"] / steps,
        "compute_ms_per_step": 1e3 * tot["compute_time_s"] / steps,
        "h2d_ms_median": 1e3 * h2d[len(h2d) // 2],
        "step_ms_median": 1e3 * stp[len(stp) // 2],
        "peak_bytes": peak, "launches": launches,
        "counters": {k: int(tot[k]) for k in (
            "rpc_count", "remote_bytes", "vector_pull_bytes", "cache_hits",
            "cache_misses", "prefetch_hits", "default_path")},
        "trace": trace_steps(torch, device, exp, cfg, captured)}
    log(f"train: {steps} steps in {wall:.3f} s = {out['steps_per_s']:.2f} "
        f"steps/s (second run {wall2:.3f} s); per step: prefetch stall "
        f"{out['prefetch_stall_ms_per_step']:.2f} ms + compute "
        f"{out['compute_ms_per_step']:.2f} ms (of which H2D copy "
        f"{out['h2d_ms_median']:.2f} ms, step {out['step_ms_median']:.2f} "
        f"ms, medians); peak device memory {peak / 2**20:.1f} MiB")
    log(f"train losses {['%.6f' % x for x in hist]}; first "
        f"{CPU_LOSS_STEPS} within rtol=1e-4 atol=1e-5 of the CPU "
        f"{['%.6f' % x for x in cpu]}; second card run bit-identical")
    log(f"train launches {json.dumps(launches)}; counters "
        f"{json.dumps(out['counters'])}")
    tr = out["trace"]
    log(f"traced steps: {tr['traced_step_ms']:.2f} ms a step, card busy "
        f"{tr['card_busy_ms_per_step']:.3f} ms "
        f"({100 * tr['card_busy_share']:.2f} %); card ms a step by op: "
        f"{json.dumps(tr['top_device_ms_per_step'])}")
    return out, sort_input, captured, m_max, cfg


def seg_sort_row(torch, keys, payload, num_bits, what):
    """``seg_sort`` at one stream: bit-equal to its plain version and to a
    second call, at most 1 + passes card operations, timed beside the
    plain version, ``torch.sort`` and the bounds."""
    from repro_torch.kernels.seg_sort import ops as sort_ops
    from repro_torch.kernels.seg_sort.ref import seg_sort_ref
    from repro_torch.kernels.seg_sort.seg_sort import CLUSTER, passes

    got = sort_ops.seg_sort(keys, payload, num_bits=num_bits)
    want = seg_sort_ref(keys, payload)
    _equal(torch, got[0], want[0])
    if payload is not None:
        _equal(torch, got[1], want[1])
    n = keys.shape[0]
    n_pass = passes(num_bits)
    width = 4 if payload is None else 8        # bytes a key carries

    def call():
        return sort_ops.seg_sort(keys, payload, num_bits=num_bits)
    _equal(torch, call()[0], got[0])
    ops = device_ops(torch, call)
    r = {"what": what, "n": n, "num_bits": num_bits,
         # each key read once and written once (the row's bound) ...
         "bound": bound_ms(n * 2 * width, n * n_pass),
         # ... and this design's own floor: read by the histogram and
         # by every pass, written by every pass
         "design_floor_ms": bound_ms(n * width * (1 + 2 * n_pass),
                                     0)[0],
         "ms": device_ms(torch, call),
         "ms_in_a_graph": device_ms_per_call(torch, call, calls=10),
         "plain_ms": device_ms(torch, lambda: seg_sort_ref(
             keys, payload)),
         "library_ms": device_ms(torch, lambda: torch.sort(
             keys, stable=True)),
         "op_ms": op_times_ms(torch, call),
         "passes": n_pass, "device_ops": len(ops), "ops": ops}
    log(f"seg_sort {what}: n={n} num_bits={num_bits} "
        f"ms={r['ms']:.4f} ({r['ms_in_a_graph']:.4f} a call in a graph "
        f"of 10) plain_ms={r['plain_ms']:.4f} library_ms="
        f"{r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} (read and "
        f"write once; the design's floor {r['design_floor_ms']:.4f}); "
        f"{len(ops)} card ops a call ({', '.join(ops)}) for {n_pass} "
        f"passes in clusters of {CLUSTER} tiles, each op's ms "
        f"{json.dumps({k: round(v, 4) for k, v in r['op_ms'].items()})}"
        f"; bit-equal to its plain version and to a second call")
    if len(ops) > 1 + n_pass:
        raise RuntimeError(f"seg_sort {what}: {len(ops)} card operations "
                           f"a call, at most 1 + {n_pass} expected")
    return r


def gather_bwd_row(torch, device, cb, fanouts, m_max, layer, d, what, tol):
    """The kernel must equal the plain version on the CPU bit for bit
    (both add each row's quotients in edge order from +0) and give
    the same bits twice; ``tol`` (rtol = atol) bounds its distance
    from the plain version on the card, whose ``index_add_`` sums
    with atomics in no fixed order. ``cb``: a collated batch, whose
    layer ``layer`` gives the edges; g is drawn at width ``d``."""
    import numpy as np
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    fo = fanouts[layer]
    src, msk = t(cb.edge_src[layer]), t(cb.edge_mask[layer])
    nd = src.shape[0] // fo
    gen = torch.Generator(device="cpu").manual_seed(layer)
    g = torch.randn((nd, d), generator=gen).to(device)
    got = gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                    fanout=fo)
    again = gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                      fanout=fo)
    want = gather_agg_bwd_ref(g, src, msk, m_max, nd, fo)
    cpu = gather_agg_bwd_ref(g.cpu(), src.cpu(), msk.cpu(), m_max, nd,
                             fo)
    if not torch.equal(got.cpu(), cpu):
        raise RuntimeError(
            f"gather_agg_bwd {what} is not the CPU plain version bit for "
            f"bit: max abs diff {(got.cpu() - cpu).abs().max().item()}")
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise RuntimeError(f"gather_agg_bwd {what} differs from its "
                           f"plain version on the card")
    if not torch.equal(got, again):
        raise RuntimeError(f"gather_agg_bwd {what}: two runs differ")
    cnt = msk.reshape(nd, fo).sum(1).float().clamp(min=1.0)
    msg = (g / cnt[:, None])[:, None, :].expand(nd, fo, d) \
        .reshape(nd * fo, d) * msk[:, None].float()
    src_l = src.long()

    def library():
        return torch.zeros((m_max, d), device=device).index_add_(
            0, src_l, msg)
    if not torch.allclose(library().cpu(), cpu, rtol=tol, atol=tol):
        raise RuntimeError("index_add_ yardstick computes another "
                           "function")
    unmasked = int(msk.sum().item())
    nbytes = nd * d * 4 + src.shape[0] * 5 + m_max * d * 4

    def call():
        return gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                         fanout=fo)
    ops = device_ops(torch, call)
    longest = int(torch.bincount(src[msk]).max().item()) \
        if unmasked else 0
    r = {"what": what, "err": (got - want).abs().max().item(),
         "bound": bound_ms(nbytes, 2 * unmasked * d),
         # the order's floor: each column's chain of dependent adds is
         # as long as the longest run, and edge order forbids a tree
         "order_floor_ms": longest * ADD_CYCLES / (max_sm_mhz() * 1e3),
         "longest_run": longest,
         "ms": device_ms(torch, call),
         "ms_in_a_graph": device_ms_per_call(torch, call, calls=10),
         "op_ms": op_times_ms(torch, call),
         "plain_ms": device_ms(torch, lambda: gather_agg_bwd_ref(
             g, src, msk, m_max, nd, fo)),
         "library_ms": device_ms(torch, library),
         "cpu_err": 0.0, "device_ops": len(ops), "ops": ops,
         "shape": f"g=({nd},{d}) m={m_max} fanout={fo} "
                  f"unmasked={unmasked}"}
    log(f"gather_agg_bwd {what}: {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 10) plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"(index_add_) bound_ms={r['bound'][0]:.4f} (bytes), the "
        f"order's floor {r['order_floor_ms']:.4f} (longest run "
        f"{longest} x {ADD_CYCLES} cycles at {max_sm_mhz():.0f} MHz); "
        f"{len(ops)} card ops a call ({', '.join(ops)}), each op's ms "
        f"{json.dumps({k: round(v, 4) for k, v in r['op_ms'].items()})}"
        f"; max_abs_err={r['err']:.3e} against the card plain version, "
        f"bit-equal to the CPU plain version and to a second run")
    if len(ops) > 3:
        raise RuntimeError(f"gather_agg_bwd ran {len(ops)} card "
                           f"operations a call at {what}: {ops}")
    return r


def train_kernel_phase(torch, device, cfg, sort_input, captured, m_max,
                       launches):
    """``seg_sort`` and ``gather_agg_bwd`` against their plain versions
    on the card, at the training path's shapes, with their times."""
    import numpy as np
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
    from repro_torch.kernels.seg_sort import ops as sort_ops
    from repro_torch.kernels.seg_sort.ref import seg_sort_ref
    from repro_torch.kernels.seg_sort.seg_sort import CLUSTER, TILE

    sentinel = 2 ** 31 - 1
    _, cb = captured[0]
    fanouts = cfg.fanouts

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the forward at training's two layer shapes, from the captured batch:
    # layer 0 over the step's input features, layer 1 over hidden rows
    feats = t(captured[0][0])
    gen = torch.Generator(device="cpu").manual_seed(11)
    hidden = torch.randn((feats.shape[0], cfg.hidden_dim),
                         generator=gen).to(device)
    forward = [gather_agg_row(
        torch, h, t(cb.edge_src[l]), t(cb.edge_mask[l]),
        cb.edge_src[l].shape[0] // fanouts[l], fanouts[l],
        f"training layer {l}")["row"]
        for l, h in enumerate((feats, hidden))]
    del feats, hidden

    # the compiler's largest stream (layer 0 of an epoch), keys only; the
    # backward no longer sorts (its order is built inside its own kernel,
    # timed in its row)
    sorts = [seg_sort_row(torch, sort_input["keys"], None,
                          sort_input["num_bits"], "layer-0 stream")]

    bwd1 = gather_bwd_row(torch, device, cb, fanouts, m_max, 1,
                          cfg.hidden_dim, "layer 1 (the path)", 1e-5)
    # layer 0's hub rows sum thousands of terms: the card's atomic order
    # moves the plain version by more than 1e-5 there
    bwd0 = gather_bwd_row(torch, device, cb, fanouts, m_max, 0, cfg.in_dim,
                          "layer 0 (for reference, not launched in "
                          "training)", 1e-4)

    # awkward shapes: around a tile and a cluster of tiles
    gen = torch.Generator(device="cpu").manual_seed(9)
    span = CLUSTER * TILE
    for n, bits, payload in ((1, 3, True), (4095, 20, True),
                             (4097, 31, False), (TILE - 1, 20, True),
                             (TILE + 1, 31, False), (700, 1, True),
                             (span - 1, 20, True), (span, 21, False),
                             (span + 1, 22, True), (3 * span + 1, 20, False)):
        keys = torch.randint(0, 1 << bits, (n,), generator=gen,
                             dtype=torch.int32)
        keys[::5] = sentinel
        pay = torch.randperm(n, generator=gen).to(torch.int32) \
            if payload else None
        keys = keys.to(device)
        pay = None if pay is None else pay.to(device)
        got = sort_ops.seg_sort(keys, pay, num_bits=bits)
        want = seg_sort_ref(keys, pay)
        _equal(torch, got[0], want[0])
        if pay is not None:
            _equal(torch, got[1], want[1])
    # keys and payload 4 and 12 bytes past a 16-byte boundary (views)
    big = torch.randint(0, 1 << 20, (span + 9,), generator=gen,
                        dtype=torch.int32)
    big[::7] = sentinel
    big = big.to(device)
    keys, pay = big[1:span + 6], big.flip(0)[3:span + 8]
    got = sort_ops.seg_sort(keys, pay, num_bits=20)
    want = seg_sort_ref(keys, pay)
    _equal(torch, got[0], want[0])
    _equal(torch, got[1], want[1])
    same = torch.full((3000,), 5, dtype=torch.int32, device=device)
    order = torch.arange(3000, dtype=torch.int32, device=device)
    _equal(torch, sort_ops.seg_sort(same, order, num_bits=4)[1], order)
    hub_src = torch.full((400,), 7, dtype=torch.int32, device=device)
    hub_msk = torch.ones(400, dtype=torch.bool, device=device)
    hub_msk[:10] = False
    hub_g = torch.randn((40, 33), generator=gen).to(device)
    got = gather_ops.gather_agg_bwd(hub_g, hub_src, hub_msk, m=9, nd=40,
                                    fanout=10)
    if not torch.equal(got.cpu(), gather_agg_bwd_ref(
            hub_g.cpu(), hub_src.cpu(), hub_msk.cpu(), 9, 40, 10)):
        raise RuntimeError("gather_agg_bwd hub row differs")
    log(f"awkward shapes: seg_sort (n=1, 4095, 4097, a tile {TILE} +- 1, "
        f"a cluster of {CLUSTER} tiles {span} +- 1, {3 * span + 1}, all keys equal, num_bits "
        f"1/3/20/21/22/31, sentinels between keys, with and without "
        f"payload, views 4 and 12 bytes past 16-byte alignment) and "
        f"gather_agg_bwd (one hub row, a zero-count dst row) "
        f"equal to their plain versions")
    torch.cuda.synchronize()

    rows = [{
        "name": "seg_sort", "route": "cuda",
        "source": "src/repro_torch/kernels/seg_sort/csrc/radix_sort.cu",
        "replaces": "src/repro/kernels/seg_sort/seg_sort.py:46",
        "launches": launches["seg_sort"], "max_abs_err": 0.0,
        "ms": sum(r["ms"] for r in sorts),
        "plain_ms": sum(r["plain_ms"] for r in sorts),
        "bound_ms": sum(r["bound"][0] for r in sorts),
        "bound_by": sorts[0]["bound"][1],
        "library_ms": sum(r["library_ms"] for r in sorts),
        "shape": " + ".join(f"{r['what']} n={r['n']} num_bits="
                            f"{r['num_bits']}" for r in sorts),
        "parts": sorts}, {
        "name": "gather_agg_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/gather_agg/csrc/"
                  "gather_agg_bwd.cu",
        "replaces": "src/repro/kernels/gather_agg/ops.py:39",
        "launches": launches["gather_agg_bwd"], "max_abs_err": bwd1["err"],
        "ms": bwd1["ms"], "plain_ms": bwd1["plain_ms"],
        "bound_ms": bwd1["bound"][0], "bound_by": bwd1["bound"][1],
        "library_ms": bwd1["library_ms"], "shape": bwd1["shape"],
        "layer0_reference": bwd0}]
    for r in rows[0]["parts"] + [rows[1]["layer0_reference"]] + forward:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return rows, forward


# ---------------------------------------------------------------------------
# phase 6: transformer decode serving (gemma2-2b)
# ---------------------------------------------------------------------------

def lm_config(dtype: str = "bfloat16"):
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    cfg = get_arch(LM_ARCH) if LM_FULL else get_reduced(LM_ARCH)
    return dataclasses.replace(cfg, dtype=dtype)


def lm_tokens(cfg, shape, field: int):
    from repro_torch.data.pipeline import zipf_tokens
    from repro_torch.graph.sampler import rng_from
    return zipf_tokens(rng_from(LM_SEED, field), cfg.vocab_size, shape)


#: the card-op names of the ``flash_decode`` kernels (both instances)
DECODE_KERNELS = ("flash_decode_mma_kernel<", "decode_kernel<")


def card_time_by_op(torch, fn, top: int = 8, host: bool = True,
                    sum_of=()):
    """Run ``fn`` once under ``torch.profiler``: (wall s, card busy ms,
    the ``top`` card ops by self time in ms, and under ``"all of " +
    sum_of`` the ms of every op whose name holds one of ``sum_of``).
    ``host=False`` records the card's activity alone, for a call of some
    10^5 kernels, whose host events take minutes to gather."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = {e.key: e.self_device_time_total / 1e3 for e in sorted(
        events, key=lambda e: -e.self_device_time_total)[:top]}
    if sum_of:
        ops["all of " + " ".join(sum_of)] = sum(
            e.self_device_time_total for e in events
            if any(n in e.key for n in sum_of)) / 1e3
    return wall, busy_us / 1e3, ops


def mesh_tag(mesh) -> str:
    return "" if mesh is None else f" over mesh {json.dumps(mesh.shape)}"


def attn_layers(cfg) -> int:
    """The attention layers of a config (one kernel launch each a
    prefill or a decode step)."""
    def n(kinds):
        return sum(k in ("attn", "local") for k in kinds)
    return n(cfg.pattern) * cfg.num_repeats + n(cfg.tail)


def prefill_phase(torch, device, cfg, params, counters, seq=None,
                  inputs=None, expect=None, mesh=None):
    """(a) ``forward`` at B=1, S=``seq`` (PREFILL_S): launches (counts set
    to 0 just before, read just after; ``expect`` ``flash_attention``
    launches, default one an attention layer), time, peak memory, card
    time by op. ``inputs()``, called inside each timed run, gives
    ``forward``'s other arguments (the encoder's output, the frontend
    stub's embeddings, M-RoPE streams). ``mesh``: ``forward`` over that
    ``("data", "model")`` mesh."""
    from repro_torch.models.transformer import forward

    seq = seq or PREFILL_S
    expect = attn_layers(cfg) if expect is None else expect
    toks = torch.from_numpy(lm_tokens(cfg, (1, seq), 0x5046)).to(
        device)

    def run():
        with torch.inference_mode():
            return forward(cfg, params, toks, mesh=mesh,
                           **(inputs() if inputs else {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    logits = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (1, seq, cfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} "
                           f"{logits.dtype} not finite of the right shape")
    if cfg.final_softcap and float(logits.abs().max()) > cfg.final_softcap:
        raise RuntimeError("prefill logits exceed the final softcap")
    last = logits[0, -1].clone()
    del logits
    if launches["flash_attention"] != expect or \
            launches["flash_decode"] != 0:
        raise RuntimeError(f"prefill launched {launches}, expected "
                           f"{expect} flash_attention")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        same = torch.equal(again[0, -1], last)
        del again
        if not same:
            raise RuntimeError("a second prefill gave other logits")
    traced_s, busy_ms, ops = card_time_by_op(torch, run,
                                             sum_of=(ATTENTION_KERNEL,))
    attn_ms = ops.pop("all of " + ATTENTION_KERNEL, 0.0)
    out = {"tokens": seq, "first_ms": 1e3 * first_s,
           "ms": 1e3 * min(times), "tokens_per_s": seq / min(times),
           "peak_bytes": peak, "launches": launches,
           "traced_ms": 1e3 * traced_s, "card_busy_ms": busy_ms,
           "card_ms_by_op": ops, "attention_card_ms": attn_ms}
    log(f"prefill {cfg.name}{mesh_tag(mesh)}: B=1 S={seq} in "
        f"{out['ms']:.2f} ms "
        f"({out['tokens_per_s']:.0f} tok/s; first call {out['first_ms']:.2f}"
        f" ms), peak device memory {peak / 2**30:.2f} GiB, launches "
        f"{json.dumps(launches)}; logits finite, second run bit-identical")
    log(f"prefill traced: {out['traced_ms']:.2f} ms, card busy "
        f"{busy_ms:.2f} ms, flash_attention {attn_ms:.3f} of it "
        f"({100 * attn_ms / max(busy_ms, 1e-9):.1f} %); card ms by op "
        f"{json.dumps(ops)}")
    return out


def decode_phase(torch, device, cfg, params, counters, host=True,
                 trace_steps=None, states=None, per_step=None, mesh=None):
    """(b) the ``serve_decode`` launcher's greedy loop: launches (counts
    set to 0 just before, read just after; ``per_step`` ``flash_decode``
    a step, default one an attention layer), ms/step, tokens/s, peak
    memory, a second run bit-identical (tokens and every step's logits),
    card time by op a step over the whole loop, or over ``trace_steps``
    steps from a one-token prompt (``host=False``: the card's activity
    alone). ``states(max_len)`` gives each run a fresh decode state (an
    enc-dec model's with its cross caches written in); default the
    launcher's. ``mesh``: every step over that ``("data", "model")``
    mesh."""
    import numpy as np
    from repro_torch.launch.serve_decode import greedy_decode

    def decode(prompts_, gen):
        return greedy_decode(
            cfg, params, prompts_, gen, device,
            states(prompts_.shape[1] + gen) if states else None, mesh=mesh)

    per_step = attn_layers(cfg) if per_step is None else per_step
    prompts = lm_tokens(cfg, (DECODE_B, DECODE_PROMPT), 0x4443)
    steps = DECODE_PROMPT + DECODE_GEN - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    toks, first_s, logits = decode(prompts, DECODE_GEN)
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    if launches["flash_decode"] != steps * per_step or \
            launches["flash_attention"] != 0:
        raise RuntimeError(f"decode launched {launches}, expected "
                           f"{per_step} flash_decode a step")
    if toks.shape != (DECODE_B, DECODE_PROMPT + DECODE_GEN) or \
            not np.array_equal(toks[:, :DECODE_PROMPT], prompts) or \
            toks.min() < 0 or toks.max() >= cfg.vocab_size or \
            not all(bool(torch.isfinite(x).all()) for x in logits):
        raise RuntimeError("decode gave bad tokens or logits")
    again, second_s, logits2 = decode(prompts, DECODE_GEN)
    if not np.array_equal(again, toks) or not all(
            torch.equal(a, b) for a, b in zip(logits, logits2)):
        raise RuntimeError("a second decode run gave other tokens or "
                           "logits")
    del logits, logits2
    traced = steps if trace_steps is None else trace_steps
    traced_s, busy_ms, ops = card_time_by_op(
        torch, lambda: decode(
            prompts if trace_steps is None else prompts[:, :1],
            DECODE_GEN if trace_steps is None else trace_steps),
        host=host, sum_of=DECODE_KERNELS)
    decode_ms = ops.pop("all of " + " ".join(DECODE_KERNELS)) / traced
    out = {"batch": DECODE_B, "prompt": DECODE_PROMPT, "gen": DECODE_GEN,
           "steps": steps, "first_ms_per_step": 1e3 * first_s / steps,
           "ms_per_step": 1e3 * second_s / steps,
           "tokens_per_s": DECODE_B * steps / second_s,
           "launches": launches, "peak_bytes": peak,
           "traced_steps": traced,
           "traced_ms_per_step": 1e3 * traced_s / traced,
           "card_busy_ms_per_step": busy_ms / traced,
           "card_busy_share": busy_ms / 1e3 / traced_s,
           "card_ms_by_op_per_step": {k: v / traced for k, v in ops.items()},
           "flash_decode_card_ms_per_step": decode_ms,
           "sample": toks[0, DECODE_PROMPT:DECODE_PROMPT + 10].tolist()}
    log(f"decode {cfg.name}{mesh_tag(mesh)}: B={DECODE_B} prompt "
        f"{DECODE_PROMPT} gen "
        f"{DECODE_GEN}: {steps} steps, {out['ms_per_step']:.2f} ms/step, "
        f"{out['tokens_per_s']:.1f} tok/s (first run "
        f"{out['first_ms_per_step']:.2f} ms/step); peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}; second "
        f"run bit-identical; sample {out['sample']}")
    log(f"decode traced ({traced} steps): {out['traced_ms_per_step']:.2f} "
        f"ms/step, card busy "
        f"{out['card_busy_ms_per_step']:.3f} ms/step "
        f"({100 * out['card_busy_share']:.2f} %); flash_decode "
        f"{decode_ms:.3f} card ms a step ("
        f"{100 * decode_ms / out['card_busy_ms_per_step']:.1f} % of the "
        f"busy ms); card ms a step by op "
        f"{json.dumps(out['card_ms_by_op_per_step'])}")
    return out


def decode_vs_prefill(torch, device):
    """(c) float32 at full width, S=CHECK_S: each decode step's logits
    against ``forward``'s at the same position."""
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                init_params, serve_step)
    cfg = lm_config("float32")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED + 1), device)
    toks = torch.from_numpy(lm_tokens(cfg, (CHECK_B, CHECK_S), 0x4356)).to(
        device)
    worst = 0.0
    with torch.inference_mode():
        full = forward(cfg, params, toks)
        states = init_decode_state(cfg, CHECK_B, max_len=CHECK_S,
                                   device=device)
        for t in range(CHECK_S):
            lg, states = serve_step(
                cfg, params, states, toks[:, t:t + 1],
                torch.full((CHECK_B,), t, dtype=torch.int32, device=device))
            worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    del params, states, full
    if not worst <= CHECK_ATOL:
        raise RuntimeError(f"decode logits differ from the prefill's by "
                           f"{worst} > {CHECK_ATOL}")
    log(f"decode vs prefill, float32, {cfg.name} "
        f"{'full width and depth' if LM_FULL else 'reduced'}, "
        f"B={CHECK_B} S={CHECK_S}: max abs diff {worst:.3e} (tolerance "
        f"atol={CHECK_ATOL}; logits up to {scale:.2f})")
    return {"max_abs_diff": worst, "atol": CHECK_ATOL, "max_logit": scale}


def layer_qkv(torch, cfg, params, toks):
    """q/k/v of layer 0 (local) and layer 1 (global) of the prefill, each
    from its own input: the embeddings, then layer 0's output."""
    from repro_torch.models.transformer.blocks import (_project_qkv,
                                                       block_apply)
    from repro_torch.models.transformer.common import rms_norm
    from repro_torch.models.transformer.model import _embed, _unstack

    pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
    out = []
    with torch.inference_mode():
        x = _embed(cfg, params, toks)
        for i, kind in enumerate(cfg.pattern[:2]):
            p = _unstack(params["blocks"][i])[0]
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = _project_qkv(cfg, p["attn"], h, pos)
            out.append((kind, cfg.window if kind == "local" else 0,
                        q.contiguous(), k.contiguous(), v.contiguous()))
            x = block_apply(cfg, kind, p, x, positions=pos)
    return out


def causal_pairs(S: int, window: int) -> int:
    """Valid (query, key) pairs of one head: the triangle, or the band."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attn_kernel_rows(torch, device, cfg, params, launches):
    """(d) ``flash_attention`` on the layers' own q/k/v at the prefill
    shape, in bfloat16 and in float32, against its plain version, with
    its time beside the plain version's and SDPA's (no softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    toks = torch.from_numpy(lm_tokens(cfg, (1, PREFILL_S), 0x5046)).to(
        device)
    cap = cfg.attn_softcap
    rows = []
    for kind, window, q, k, v in layer_qkv(torch, cfg, params, toks):
        B, S, H, dh = q.shape
        kw = dict(causal=True, window=window, softcap=cap)
        got = fa_ops.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=2 ** -7,
                              atol=1e-5):
            raise RuntimeError(f"flash_attention {kind} (bf16) differs from "
                               f"its plain version: {err}")
        q32, k32, v32 = q.float(), k.float(), v.float()
        got32 = fa_ops.flash_attention(q32, k32, v32, **kw)
        want32 = flash_attention_ref(q32, k32, v32, **kw)
        err32 = float((got32 - want32).abs().max())
        if not torch.allclose(got32, want32, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"flash_attention {kind} (fp32) differs from "
                               f"its plain version: {err32}")
        del got32, want32
        if window:
            ip = torch.arange(S, device=device)
            band = (ip[None, :] <= ip[:, None]) & \
                (ip[None, :] > ip[:, None] - window)

        def sdpa_of(q_, k_, v_):
            qt, kt, vt = (t.transpose(1, 2) for t in (q_, k_, v_))
            if window:
                return lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        # the float32 kernel (CUDA cores) on the same q/k/v, beside SDPA in
        # float32 and the bound at the float32 CUDA-core rate
        fp32_ms = device_ms(torch, lambda: fa_ops.flash_attention(
            q32, k32, v32, **kw), iters=3)
        sdpa_fp32_ms = device_ms(torch, sdpa_of(q32, k32, v32), iters=3)
        del q32, k32, v32
        sdpa = sdpa_of(q, k, v)
        lib_err = float((sdpa().transpose(1, 2).float() - flash_attention_ref(
            q, k, v, causal=True, window=window).float()).abs().max())
        if lib_err > 0.05:
            raise RuntimeError(f"SDPA yardstick ({kind}) computes another "
                               f"function: {lib_err}")
        pairs = causal_pairs(S, window)
        nbytes = B * S * (2 * H + 2 * k.shape[2]) * dh * q.element_size()
        r = {"kind": kind, "window": window, "err": err, "err_fp32": err32,
             "bound": bound_ms(nbytes, 4 * dh * H * B * pairs,
                               BF16_FLOPS_PER_S),
             "flop": 4 * dh * H * B * pairs,
             "ms": device_ms(torch, lambda: fa_ops.flash_attention(
                 q, k, v, **kw), iters=5),
             "plain_ms": device_ms(torch, lambda: flash_attention_ref(
                 q, k, v, **kw), iters=3),
             "library_ms": device_ms(torch, sdpa, iters=5),
             "library_err_no_softcap": lib_err, "fp32_ms": fp32_ms,
             "fp32_bound": bound_ms(2 * nbytes, 4 * dh * H * B * pairs),
             "sdpa_fp32_ms": sdpa_fp32_ms,
             "shape": f"{kind} q=({B},{S},{H},{dh}) kvH={k.shape[2]} "
                      f"window={window} softcap={cap} bf16"}
        # FLOP of the bound (4 dh a valid pair) over the kernel's time
        r["tflops"] = r["flop"] / r["ms"] / 1e9
        log(f"flash_attention {r['shape']}: ms={r['ms']:.3f} (bf16, tensor "
            f"cores) fp32_ms={fp32_ms:.3f} (float32 q/k/v, CUDA cores) "
            f"plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.3f} "
            f"(SDPA, no softcap) bound_ms={r['bound'][0]:.4f} "
            f"({r['tflops']:.1f} TFLOP/s, "
            f"{100 * r['tflops'] * 1e12 / BF16_FLOPS_PER_S:.1f} % of the "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bound"
            f"{beside_old_attention('flash_attention ' + kind, r['ms'])}); "
            f"max_abs_err "
            f"{err:.3e} (bf16, rtol=2^-7 atol=1e-5), {err32:.3e} (fp32, "
            f"rtol=1e-4 atol=1e-5)")
        log(f"flash_attention {kind} float32: fp32_ms={fp32_ms:.3f} "
            f"SDPA float32 {sdpa_fp32_ms:.3f} ms; bound at the float32 "
            f"CUDA-core rate {r['fp32_bound'][0]:.4f} ms "
            f"({r['fp32_bound'][1]}, {OPS_PER_S / 1e12:.0f} TFLOP/s)")
        rows.append(r)
        del got, want
    # awkward shapes: odd S, G = 1-8, dh = 48-256, fp32, non-causal window
    gen = torch.Generator(device="cpu").manual_seed(13)
    for B, S, H, kvH, dh, causal, window, softcap, dt in (
            (2, 77, 6, 2, 64, True, 0, 0.0, torch.float32),
            (1, 301, 3, 1, 128, True, 50, 30.0, torch.bfloat16),
            (1, 129, 8, 8, 256, False, 20, 50.0, torch.float32),
            (3, 5, 4, 2, 64, True, 3, 0.0, torch.bfloat16),
            (1, 1000, 8, 4, 256, True, 300, 50.0, torch.bfloat16),
            (2, 63, 16, 2, 48, False, 0, 0.0, torch.bfloat16)):
        qq = torch.randn((B, S, H, dh), generator=gen).to(device, dt)
        kk = torch.randn((B, S, kvH, dh), generator=gen).to(device, dt)
        vv = torch.randn((B, S, kvH, dh), generator=gen).to(device, dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = fa_ops.flash_attention(qq, kk, vv, **kw).float()
        want = flash_attention_ref(qq, kk, vv, **kw).float()
        tol = dict(rtol=1e-4, atol=1e-5) if dt == torch.float32 else \
            dict(rtol=2 ** -7, atol=1e-5)
        if not torch.allclose(got, want, **tol):
            raise RuntimeError(f"flash_attention differs at S={S} G="
                               f"{H // kvH} dh={dh}")
    log("awkward shapes: flash_attention (S 5/63/77/129/301/1000, G 1-8, "
        "dh 48-256, non-causal window) equal to its plain version")
    torch.cuda.synchronize()
    return {
        "name": "flash_attention", "route": "cuda",
        "source": ATTENTION_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "launches": launches["flash_attention"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound"][0] for r in rows),
        "bound_by": rows[0]["bound"][1],
        "library_ms": sum(r["library_ms"] for r in rows),
        "fp32_ms": sum(r["fp32_ms"] for r in rows),
        "fp32_bound_ms": sum(r["fp32_bound"][0] for r in rows),
        "sdpa_fp32_ms": sum(r["sdpa_fp32_ms"] for r in rows),
        "shape": " + ".join(r["shape"] for r in rows), "layers": rows}


def long_cache(torch, device, cfg):
    """B=LONG_B, S=LONG_S bfloat16 K/V with the model's heads, lengths and
    starts covering 0, 1, S, a window start, start == length."""
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 2)
    B, S, H, kvH, dh = LONG_B, LONG_S, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    q = torch.randn((B, H, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, kvH, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, kvH, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    lens = [S, S, 1, 0, S // 2, S - 1, 4097, 3, S, 1000, S, 2, 20000, S,
            12345, S][:B]
    starts = [0, S - 4096, 0, 0, S // 2 - 4096, 1, 1, 3, S // 3, 999, 0, 0,
              0, S - 1, 0, 5][:B]
    length = torch.tensor(lens, dtype=torch.int32, device=device)
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    return q, k, v, length, start


def decode_kernel_row(torch, device, cfg, params, launches):
    """(d) ``flash_decode`` against its plain version over the long cache
    and the decode loop's own cache shape, with its time beside the plain
    version's and SDPA's (no softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import (flash_decode_batched_ref,
                                                      finalize)

    cap = cfg.attn_softcap
    q, k, v, length, start = long_cache(torch, device, cfg)
    B, S, kvH, dh = k.shape
    H = q.shape[1]
    got = fd_ops.flash_decode_batched(q, k, v, length, start, softcap=cap)
    acc, m, l = flash_decode_batched_ref(q, k, v, length, start,
                                         softcap=cap)
    want = finalize(acc, l)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise RuntimeError(f"flash_decode (long cache) differs from its plain "
                           f"version: {err}")
    parts = fd_ops.flash_decode(q[2], k[2], v[2], length[2], start[2],
                                softcap=cap)
    for g_, w_ in zip(parts, (acc[2], m[2], l[2])):
        if not torch.allclose(g_, w_, rtol=1e-4, atol=1e-5):
            raise RuntimeError("flash_decode partials differ")
    empty = got[(length <= start)]
    if empty.numel() and not bool((empty == 0).all()):
        raise RuntimeError("flash_decode: an empty range did not give 0")
    # the decode loop's shape: the caches the serving loop fills
    from repro_torch.models.transformer import init_decode_state
    small = init_decode_state(cfg, DECODE_B, DECODE_PROMPT + DECODE_GEN,
                              device=device)
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 3)
    for st in small["scan"]:
        kc = torch.randn(st["k"][0].shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
        vc = torch.randn(st["v"][0].shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
        qc = torch.randn((DECODE_B, H, dh), generator=gen, device=device,
                         dtype=torch.bfloat16)
        ln = torch.arange(DECODE_B, dtype=torch.int32, device=device) * 7 % \
            (kc.shape[1] + 1)
        st0 = torch.zeros_like(ln)
        g2 = fd_ops.flash_decode_batched(qc, kc, vc, ln, st0, softcap=cap)
        a2, _, l2 = flash_decode_batched_ref(qc, kc, vc, ln, st0,
                                             softcap=cap)
        if not torch.allclose(g2, finalize(a2, l2), rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"flash_decode differs at the decode shape "
                               f"S={kc.shape[1]}")
        small_shape = tuple(kc.shape)

    valid = (length.clamp(max=S) - start.clamp(min=0)).clamp(min=0)
    n_valid = int(valid.sum())
    nbytes = n_valid * kvH * dh * 2 * k.element_size() + \
        q.numel() * q.element_size() + B * H * dh * 4
    pos = torch.arange(S, device=device)
    mask = ((pos[None, :] < length[:, None]) &
            (pos[None, :] >= start[:, None]))[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    full_rows = valid > 0
    lib = sdpa()[:, :, 0].float()
    lib_want = finalize(*flash_decode_batched_ref(q, k, v, length, start)[::2])
    lib_err = float((lib - lib_want)[full_rows].abs().max())
    if lib_err > 0.05:
        raise RuntimeError(f"SDPA yardstick (decode) computes another "
                           f"function: {lib_err}")
    r = {"name": "flash_decode", "route": "cuda",
         "source": DECODE_SOURCE,
         "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
         "launches": launches["flash_decode"], "max_abs_err": err,
         "ms": device_ms(torch, lambda: fd_ops.flash_decode_batched(
             q, k, v, length, start, softcap=cap)),
         "plain_ms": device_ms(torch, lambda: flash_decode_batched_ref(
             q, k, v, length, start, softcap=cap), iters=5),
         "library_ms": device_ms(torch, sdpa, iters=5),
         "library_err_no_softcap": lib_err,
         "old_design_ms": OLD_DECODE_MS["flash_decode"][0],
         "shape": f"q=({B},{H},{dh}) cache=({B},{S},{kvH},{dh}) bf16, "
                  f"{n_valid} valid positions, softcap {cap}"}
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 4 * dh * H * n_valid,
                                            BF16_FLOPS_PER_S)
    r["gb_per_s"] = nbytes / r["ms"] / 1e6
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    r["device_ops"] = len(device_ops(torch, lambda: fd_ops.flash_decode_batched(
        q, k, v, length, start, softcap=cap)))
    # the decode loop's shape: its caches filled (the time of the loop's
    # last steps), the same mask yardstick for SDPA
    qs = torch.randn((DECODE_B, H, dh), generator=gen, device=device,
                     dtype=torch.bfloat16)
    ln = torch.full((DECODE_B,), small_shape[1], dtype=torch.int32,
                    device=device)
    kc = torch.randn(small_shape, generator=gen, device=device,
                     dtype=torch.bfloat16)
    vc = torch.randn(small_shape, generator=gen, device=device,
                     dtype=torch.bfloat16)

    def small():
        return fd_ops.flash_decode_batched(qs, kc, vc, ln, softcap=cap)
    ops = device_ops(torch, small)
    if len(ops) != 1:
        raise RuntimeError(f"flash_decode ran {len(ops)} card operations a "
                           f"call at the decode loop's shape: {ops}")
    ppos = torch.arange(small_shape[1], device=device)
    smask = (ppos[None, :] < ln[:, None])[:, None, None, :]
    sq, sk, sv = qs[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

    def small_sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask,
                                              enable_gqa=True)
    s_bytes = (kc.numel() + vc.numel()) * kc.element_size() + \
        qs.numel() * qs.element_size() + DECODE_B * H * dh * 4
    s_bound = bound_ms(s_bytes, 4 * dh * H * DECODE_B * small_shape[1],
                       BF16_FLOPS_PER_S)
    r["decode_shape"] = {
        "cache": list(small_shape), "device_ops": len(ops),
        "ms": device_ms(torch, small),
        "ms_in_a_graph": device_ms_per_call(torch, small),
        "bound_ms": s_bound[0], "bound_by": s_bound[1],
        "library_ms": device_ms(torch, small_sdpa),
        "library_ms_in_a_graph": device_ms_per_call(torch, small_sdpa),
        "launch_floor": launch_floor_ms(torch, device)}
    ds = r["decode_shape"]
    log(f"flash_decode {r['shape']}: ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA, no "
        f"softcap) bound_ms={r['bound_ms']:.4f} ({r['gb_per_s']:.0f} GB/s, "
        f"{100 * r['share_of_bound']:.1f} % of the bound); "
        f"{r['device_ops']} card op a call; "
        f"{beside_old('flash_decode', r['ms'], r['library_ms'])}; "
        f"max_abs_err {err:.3e} (rtol=1e-4 atol=1e-5)")
    log(f"flash_decode at the decode loop's cache {tuple(small_shape)} "
        f"bf16: {ds['ms_in_a_graph']:.4f} ms a call in a graph of 20 "
        f"({ds['ms']:.4f} one call a replay; launch floor "
        f"{ds['launch_floor']['one_call_a_replay_ms']:.4f} / "
        f"{ds['launch_floor']['in_a_graph_ms']:.4f}), {len(ops)} card op a "
        f"call, bound_ms={ds['bound_ms']:.5f} ({ds['bound_by']}); SDPA "
        f"(same mask, no softcap) {ds['library_ms_in_a_graph']:.4f} ms in a "
        f"graph ({ds['library_ms']:.4f} one call a replay); in a graph "
        + beside_old('flash_decode', ds['ms_in_a_graph'],
                     ds['library_ms_in_a_graph'], loop=True))
    torch.cuda.synchronize()
    return r


def lm_phase(torch, device, counters):
    from repro_torch.models.transformer import init_params

    cfg = lm_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"lm: {cfg.name} {'full' if LM_FULL else 'reduced'} "
        f"{cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"kvH={cfg.num_kv_heads} dh={cfg.head_dim} window={cfg.window} "
        f"softcap {cfg.attn_softcap}/{cfg.final_softcap} {cfg.dtype}: "
        f"{n / 1e9:.3f} B parameters from seed {LM_SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    prefill = prefill_phase(torch, device, cfg, params, counters)
    decode = decode_phase(torch, device, cfg, params, counters)
    launches = {"flash_attention": prefill["launches"]["flash_attention"],
                "flash_decode": decode["launches"]["flash_decode"]}
    check = decode_vs_prefill(torch, device)
    rows = [attn_kernel_rows(torch, device, cfg, params, launches),
            decode_kernel_row(torch, device, cfg, params, launches)]
    # phase 13 (b), while the model is loaded
    mesh = mesh_serve(torch, device, cfg, params, counters, MESH_GEMMA)
    del params
    return {"prefill": prefill, "decode": decode, "decode_vs_prefill": check,
            "parameters": n, "mesh": mesh}, rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 7: the device-distributed epoch (P workers on one card)
# ---------------------------------------------------------------------------

def first_steps(tree, n: int):
    """The first ``n`` steps of a collated (S, P, ...) epoch dict."""
    if isinstance(tree, dict):
        return {k: first_steps(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [first_steps(v, n) for v in tree]
    return tree[:n]


def dist_world(g, pg, parts=PARTS):
    """The paper's GraphSAGE on all ``parts`` workers of ``pg``, one epoch:
    schedules, device view, both collations (hot caches and empty ones)
    and the stacked caches."""
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.core import build_schedule
    from repro_torch.core.schedule import epoch_edge_maxima
    from repro_torch.dist import (DeviceView, collate_device_epoch,
                                  empty_caches, epoch_k_max, stack_caches)
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=parts, epochs=DIST_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    t0 = time.perf_counter()
    schedules = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                                num_epochs=DIST_EPOCHS, n_hot=exp.n_hot)
                 for w in range(parts)]
    dv = DeviceView.build(pg)
    es = [ws.epoch(0) for ws in schedules]
    m_max = max(e.m_max for e in es)
    edge_max = [max(x) for x in zip(*(epoch_edge_maxima(e) for e in es))]
    S = max(e.num_batches for e in es)
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    empty = empty_caches(parts, g.feat_dim)
    k_max = epoch_k_max(es, caches, dv)
    k_base = epoch_k_max(es, empty, dv)
    rapid = collate_device_epoch(es, caches, dv, g.labels, exp.batch_size,
                                 m_max, edge_max, k_max, S)
    base = collate_device_epoch(es, empty, dv, g.labels, exp.batch_size,
                                m_max, edge_max, k_base, S)
    cids, cfeats = stack_caches(caches, dv, exp.n_hot)
    log(f"dist world: {parts} workers x {S} steps, batch {exp.batch_size}, "
        f"m_max={m_max} edge_max={edge_max} k_max rapid {k_max} on-demand "
        f"{k_base}, n_per={dv.n_per}; schedules and collation in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"exp": exp, "cfg": cfg, "schedules": schedules, "dv": dv,
            "m_max": m_max, "S": S, "rapid": rapid, "base": base,
            "cids": cids, "cfeats": cfeats, "k_max": k_max,
            "k_base": k_base, "es": es, "caches": caches, "empty": empty,
            "edge_max": edge_max}


def card_collate(device, g, w):
    """``dist_world``'s two collations again on ``device`` through
    ``collate_epoch_on_device``, as the runners stage an epoch: every
    tensor bit-equal (dtype, shape, bytes) to the numpy collation, the
    oracle. -> {"rapid", "base"} as tensors on ``device``."""
    from repro_torch.dist.device_collate import (collate_epoch_on_device,
                                                 to_host_epoch, upload)

    dv = w["dv"]
    labels, g2d = upload(g.labels, device), upload(dv.g2d, device)
    out = {}
    for key, caches, k in (("rapid", w["caches"], w["k_max"]),
                           ("base", w["empty"], w["k_base"])):
        out[key], _ = collate_epoch_on_device(
            w["es"], caches, dv, labels, w["exp"].batch_size, w["m_max"],
            w["edge_max"], k, w["S"], device=device, g2d=g2d)
        got, want = to_host_epoch(out[key]), w[key]
        if sorted(got) != sorted(want):
            raise RuntimeError(f"{key}: card collation keys {sorted(got)}")
        for name, v in want.items():
            pairs = zip(got[name], v) if isinstance(v, list) \
                else [(got[name], v)]
            if any(a.dtype != b.dtype or a.shape != b.shape
                   or a.tobytes() != b.tobytes() for a, b in pairs):
                raise RuntimeError(f"{key}: the card collation's {name} "
                                   f"differs from collate_device_epoch")
    log("dist world: the card collation bit-equal to the numpy one, hot "
        "caches and empty")
    return out


def dist_run(torch, device, w, x, kind, backend):
    """One epoch of all workers on ``device``: -> (params, losses, accs,
    wall s)."""
    from repro_torch.dist import (make_mesh, make_ondemand_epoch,
                                  make_pipelined_epoch)
    from repro_torch.models.gnn import init_params
    from repro_torch.train import AdamW

    mesh = make_mesh((PARTS,), ("data",), device=device)
    params = init_params(w["cfg"], torch.Generator().manual_seed(
        w["exp"].s0), device)
    opt = AdamW(lr=TRAIN_LR)
    if kind == "rapid":
        fn = make_pipelined_epoch(w["cfg"], opt, mesh, w["m_max"],
                                  assemble_backend=backend)
        args = (x["table"], x["offsets"], x["cids"], x["cfeats"], x["rapid"])
    else:
        fn = make_ondemand_epoch(w["cfg"], opt, mesh, w["m_max"],
                                 assemble_backend=backend)
        args = (x["table"], x["offsets"], x["base"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, losses, accs = fn(params, opt.init(params), *args)
    losses, accs = losses.cpu(), accs.cpu()        # waits for the epoch
    return params, losses, accs, time.perf_counter() - t0


def exchange_ms(torch, mesh, x, key, m_max, S):
    """The exchange alone: each step's ``pull_features`` between CUDA
    events, averaged over the steps."""
    from repro_torch.dist import pull_features
    bt = x[key]
    times = []
    for i in range(S):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pull_features(mesh, x["table"], bt["send_ids"][i], bt["send_pos"][i],
                      bt["send_mask"][i], x["offsets"], m_max)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / len(times)


def first_step_checks(torch, device, w, x):
    """(b) worker by worker on step 0: the pulled buffers are the numpy
    rows at ``send_pos``; staged, fused and a host gather of the features
    agree bit for bit. -> the step-0 inputs of worker 0 for the kernel
    row."""
    import numpy as np
    from repro_torch.dist import make_mesh, pull_features
    from repro_torch.kernels.assemble.ops import assemble_features
    from repro_torch.kernels.cache_lookup.ops import to_device_ids

    dv, rapid, m_max = w["dv"], w["rapid"], w["m_max"]
    mesh = make_mesh((PARTS,), ("data",), device=device)
    bt = x["rapid"]
    pulled = pull_features(mesh, x["table"], bt["send_ids"][0],
                           bt["send_pos"][0], bt["send_mask"][0],
                           x["offsets"], m_max)
    flat = dv.table.reshape(-1, dv.table.shape[-1])
    cids32 = to_device_ids(x["cids"])
    query = to_device_ids(bt["input_nodes"][0])
    for p in range(PARTS):
        msk = rapid["send_mask"][0, p]
        want = np.zeros((m_max, flat.shape[1]), np.float32)
        want[rapid["send_pos"][0, p][msk]] = \
            flat[rapid["send_ids"][0, p][msk]] + 0.0
        if want.tobytes() != pulled[p].cpu().numpy().tobytes():
            raise RuntimeError(f"worker {p}: pulled buffer differs from the "
                               f"numpy rows at send_pos")
        base = int(dv.offsets[p, 0])
        feats = {be: assemble_features(
            x["table"][p], base, cids32[p], x["cfeats"][p], query[p],
            pulled[p], backend=be).cpu().numpy() for be in ("fused",
                                                            "staged")}
        ids = rapid["input_nodes"][0, p]
        host = np.where((ids >= 0)[:, None], flat[np.maximum(ids, 0)], 0.0) \
            .astype(np.float32)
        if not (feats["fused"].tobytes() == feats["staged"].tobytes()
                == host.tobytes()):
            raise RuntimeError(f"worker {p}: staged, fused and host-gathered "
                               f"features differ on step 0")
    return {"cache_feats": x["cfeats"][0], "base": pulled[0],
            "cache_ids": cids32[0], "query": query[0]}


def dist_phase(torch, device, g, pg, counters):
    """(a)-(d): the pipelined epoch with the fused and the staged
    assembly and the on-demand epoch, all P workers on the card."""
    import numpy as np
    from repro_torch.dist import host_miss_matrix, make_mesh
    from repro_torch.dist.gnn_step import tree_to_device

    w = dist_world(g, pg)
    x = tree_to_device({"table": w["dv"].table,
                        "offsets": w["dv"].offsets.reshape(-1),
                        "cids": w["cids"], "cfeats": w["cfeats"]}, device)
    x.update(card_collate(device, g, w))
    S, m_max = w["S"], w["m_max"]
    # two rounds of the three runs, in turns: every curve must be the
    # first one bit for bit, and the spread of ms/step shows
    runs, launches, peaks = {}, {}, {}
    want_on = {"rapid fused": ("assemble", "gather_agg", "gather_agg_bwd"),
               "rapid staged": ("search", "merge_gather", "gather_agg",
                                "gather_agg_bwd"),
               "on-demand": ("assemble", "gather_agg", "gather_agg_bwd")}
    for _ in range(2):
        for name, kind, backend in (("rapid fused", "rapid", "fused"),
                                    ("rapid staged", "rapid", "staged"),
                                    ("on-demand", "ondemand", "fused")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.reset()
            runs.setdefault(name, []).append(
                dist_run(torch, device, w, x, kind, backend))
            torch.cuda.synchronize()
            launches[name] = {c.name: c.value for c in counters}
            peaks[name] = torch.cuda.max_memory_allocated()
            idle = [k for k in want_on[name] if launches[name][k] == 0]
            if idle:
                raise RuntimeError(f"{name} epoch did not launch {idle}: "
                                   f"{launches[name]}")
    # the fused assembly (the on-demand epoch's too) ranks inside its own
    # kernel: search only in the staged chain
    if launches["rapid fused"]["merge_gather"] or \
            launches["rapid staged"]["assemble"] or \
            launches["rapid fused"]["search"] or \
            launches["on-demand"]["search"]:
        raise RuntimeError(f"a backend ran another's kernel: {launches}")
    # the backward orders its edges in its own kernel: no seg_sort
    if any(v["seg_sort"] for v in launches.values()):
        raise RuntimeError(f"a distributed epoch launched seg_sort: "
                           f"{launches}")
    fused = runs["rapid fused"][0][1]
    if not bool(torch.isfinite(fused).all()) or fused.shape != (S,):
        raise RuntimeError(f"bad loss curve {fused.tolist()}")
    for name, rs in runs.items():
        for r in rs:
            if not torch.equal(r[1], fused):
                raise RuntimeError(f"{name} loss curve {r[1].tolist()} is "
                                   f"not the fused one {fused.tolist()}")
    first, again = runs["rapid fused"]
    for a, b in zip(again[0]["layers"], first[0]["layers"]):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise RuntimeError("a second fused run gave other weights")
    cpu_x = tree_to_device({"table": w["dv"].table,
                            "offsets": w["dv"].offsets.reshape(-1),
                            "cids": w["cids"], "cfeats": w["cfeats"],
                            "rapid": first_steps(w["rapid"], CPU_LOSS_STEPS)},
                           torch.device("cpu"))
    cpu = dist_run(torch, torch.device("cpu"), w, cpu_x, "rapid", "fused")
    np.testing.assert_allclose(fused[:CPU_LOSS_STEPS].numpy(), cpu[1].numpy(),
                               rtol=1e-4, atol=1e-5)

    # (b) step 0 worker by worker; lanes against the host-sim runner
    kernel_in = first_step_checks(torch, device, w, x)
    lanes = w["rapid"]["send_mask"].sum(axis=(0, 2, 3))
    lanes_base = w["base"]["send_mask"].sum(axis=(0, 2, 3))
    host = host_miss_matrix(w["schedules"], pg, w["exp"].batch_size)[0]
    if not np.array_equal(lanes, host):
        raise RuntimeError(f"pull lanes {lanes.tolist()} != host-sim "
                           f"cache_misses {host.tolist()}")

    # (d) the exchange alone, bytes, and a traced fused epoch
    mesh = make_mesh((PARTS,), ("data",), device=device)
    row = g.feat_dim * 4
    traffic = {}
    for key in ("rapid", "base"):
        n_lanes = int(w[key]["send_mask"].sum())
        slots = int(w[key]["send_ids"].size)
        traffic[key] = {"payload_bytes": n_lanes * row,
                        "wire_bytes": slots * row,
                        "request_bytes": slots * 4,
                        "exchange_ms_per_step": exchange_ms(
                            torch, mesh, x, key, m_max, S)}
    traced_s, busy_ms, ops = card_time_by_op(
        torch, lambda: dist_run(torch, device, w, x, "rapid", "fused"), 10)
    out = {"workers": PARTS, "steps": S, "m_max": m_max,
           "k_max": w["k_max"], "k_max_on_demand": w["k_base"],
           "losses": fused.tolist(), "cpu_losses": cpu[1].tolist(),
           "accs": first[2].tolist(),
           "ms_per_step": {k: [1e3 * r[3] / S for r in rs]
                           for k, rs in runs.items()},
           "launches": launches, "peak_bytes": peaks, "dead_pull": "skipped",
           "miss_lanes": {"rapid": lanes.tolist(),
                          "on_demand": lanes_base.tolist(),
                          "host_sim": host.tolist(),
                          "cut": float(lanes_base.sum() / max(lanes.sum(), 1))},
           "traffic": traffic,
           "traced_ms_per_step": 1e3 * traced_s / S,
           "card_busy_ms_per_step": busy_ms / S,
           "card_busy_share": busy_ms / 1e3 / traced_s,
           "card_ms_by_op_per_step": {k: v / S for k, v in ops.items()}}
    log(f"dist epoch: {PARTS} workers x {S} steps on one card; loss curves "
        f"of rapid fused, rapid staged and on-demand bit-equal, each run "
        f"twice (the second fused run's weights bit-identical too), the "
        f"first {CPU_LOSS_STEPS} within "
        f"rtol=1e-4 atol=1e-5 of the CPU; losses "
        f"{['%.6f' % v for v in out['losses']]}")
    log("dist ms/step (first, second run): " + ", ".join(
        f"{k} {v[0]:.2f} {v[1]:.2f}" for k, v in out["ms_per_step"].items())
        + f"; exchange "
        f"alone {traffic['rapid']['exchange_ms_per_step']:.3f} ms/step "
        f"(rapid), {traffic['base']['exchange_ms_per_step']:.3f} "
        f"(on-demand); peak device memory "
        f"{peaks['rapid fused'] / 2**20:.1f} MiB (fused), "
        f"{peaks['rapid staged'] / 2**20:.1f} (staged), "
        f"{peaks['on-demand'] / 2**20:.1f} (on-demand)")
    log(f"dist launches {json.dumps(launches)}; dead pull (the last step's "
        f"masked prefetch): skipped")
    log(f"dist miss lanes per worker: rapid {lanes.tolist()} (== host-sim "
        f"cache_misses), on-demand {lanes_base.tolist()}: remote fetches "
        f"cut {out['miss_lanes']['cut']:.3f}x")
    for key, t in traffic.items():
        log(f"dist bytes an epoch ({'rapid' if key == 'rapid' else 'on-demand'}"
            f"): payload_bytes {t['payload_bytes']} wire_bytes "
            f"{t['wire_bytes']} request_bytes {t['request_bytes']}")
    log(f"dist traced fused epoch: {out['traced_ms_per_step']:.2f} ms/step, "
        f"card busy {out['card_busy_ms_per_step']:.3f} ms/step "
        f"({100 * out['card_busy_share']:.2f} %); card ms a step by op "
        f"{json.dumps(out['card_ms_by_op_per_step'])}")
    return out, kernel_in


def embedding_phase(torch, device, counters):
    """(e) the hot-token embedding path at gemma2-2b's widths: every
    worker's batch through ``device_embedding_lookup`` over a residual-
    miss plan, equal to ``table[tokens]`` bit for bit."""
    import numpy as np
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.pipeline import (enumerate_token_accesses,
                                           zipf_tokens)
    from repro_torch.dist import build_pull_plan, make_mesh
    from repro_torch.graph.sampler import rng_from
    from repro_torch.models.transformer.embedding import (
        HotEmbeddingSim, device_embedding_lookup)

    cfg = get_arch(LM_ARCH) if LM_FULL else get_reduced(LM_ARCH)
    V, d, W = cfg.vocab_size, cfg.d_model, EMB_WORKERS
    m = EMB_BATCH * EMB_SEQ
    t0 = time.perf_counter()
    counts = enumerate_token_accesses(cfg, EMB_BATCH, EMB_SEQ, EMB_STEPS,
                                      s0=EMB_S0)
    sim = HotEmbeddingSim(vocab=V, d=d, num_workers=W, n_hot=EMB_N_HOT,
                          counts=counts)
    vper = -(-V // W)
    # worker w serves step w of the enumerated run
    tokens = np.stack([zipf_tokens(rng_from(EMB_S0, 0, w), V,
                                   (EMB_BATCH, EMB_SEQ)).reshape(-1)
                       for w in range(W)])
    cache_ids = np.full((W, EMB_N_HOT), 2 ** 31 - 1, np.int32)
    miss = []
    for p in range(W):
        c = sim.cache[p]
        cache_ids[p, :c.size] = c
        miss.append(~np.isin(tokens[p], c))
    k_max = max(int(np.bincount(sim.owner[tokens[p][miss[p]]],
                                minlength=W).max()) for p in range(W))
    plans = [build_pull_plan(tokens[p][miss[p]],
                             np.flatnonzero(miss[p]).astype(np.int32),
                             sim.owner, W, k_max) for p in range(W)]
    base_b = cach_b = hits = 0
    for p in range(W):
        b_, c_, h_ = sim.batch_traffic(tokens[p], worker=p)
        base_b, cach_b, hits = base_b + b_, cach_b + c_, hits + h_
    run_base = run_cach = 0
    for i in range(EMB_STEPS):
        b_, c_, _ = sim.batch_traffic(
            zipf_tokens(rng_from(EMB_S0, 0, i), V, (EMB_BATCH, EMB_SEQ)),
            worker=0)
        run_base, run_cach = run_base + b_, run_cach + c_
    run_cach += sim.cache_build_bytes()
    host_s = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(EMB_S0)
    table = torch.randn((W * vper, d), generator=gen, device=device)
    cids = torch.from_numpy(cache_ids).to(device)
    cfeats = table[cids.clamp(max=W * vper - 1).long()]
    tok = torch.from_numpy(tokens).to(device)
    plan = {k: torch.from_numpy(np.stack([getattr(p, k) for p in plans]))
            .to(device) for k in ("send_ids", "send_pos", "send_mask")}
    plan["offsets"] = (torch.arange(W, dtype=torch.int32, device=device)
                       * vper)
    mesh = make_mesh((W,), ("data",), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t1 = time.perf_counter()
    got = device_embedding_lookup(mesh, table.view(W, vper, d), cids,
                                  cfeats, tok, plan, m)
    torch.cuda.synchronize()
    lookup_s = time.perf_counter() - t1
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    want = table[tok.long()]
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError("device_embedding_lookup differs from "
                           "table[tokens]")
    if launches["search"] != W or launches["merge_gather"] != W:
        raise RuntimeError(f"embedding lookup launched {launches}, expected "
                           f"{W} search and {W} merge_gather")
    out = {"arch": cfg.name, "vocab": V, "d": d, "workers": W,
           "tokens_per_worker": m, "n_hot": EMB_N_HOT, "k_max": k_max,
           "table_bytes": table.numel() * 4, "lookup_ms": 1e3 * lookup_s,
           "host_prep_s": host_s, "peak_bytes": peak, "launches": launches,
           "hits": hits, "batch_baseline_bytes": base_b,
           "batch_cached_bytes": cach_b,
           "run_worker0_baseline_bytes": run_base,
           "run_worker0_cached_bytes": run_cach}
    log(f"embedding {cfg.name}: vocab {V} d {d} float32 table "
        f"{out['table_bytes'] / 1e9:.2f} GB, {W} workers x {m} tokens, n_hot "
        f"{EMB_N_HOT}, k_max {k_max}: device_embedding_lookup == "
        f"table[tokens] bit for bit; lookup {out['lookup_ms']:.2f} ms, peak "
        f"device memory {peak / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    log(f"embedding traffic (HotEmbeddingSim.batch_traffic): these {W} "
        f"batches {base_b / 1e6:.1f} MB -> {cach_b / 1e6:.1f} MB "
        f"({base_b / max(cach_b, 1):.2f}x less, {hits} hits); worker 0 over "
        f"{EMB_STEPS} steps with the cache build {run_base / 1e6:.1f} MB -> "
        f"{run_cach / 1e6:.1f} MB ({run_base / max(run_cach, 1):.2f}x less)")
    from repro_torch.kernels.cache_lookup.ops import search
    pos, hit = search(cids[0], tok[0])
    return out, {"cache_feats": cfeats[0], "base": got[0].clone(),
                 "pos": pos, "hit": hit}


def merge_awkward(torch, device):
    """(name, cache_ids, cache_feats, query, base): d 1 / 602 / 2304,
    m 0, an empty cache, all hits, no hits, bfloat16 (both sides and
    mixed), -1 and sentinel queries."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    sentinel = 2 ** 31 - 1
    out = []
    for name, m, n_hot, d, cdt, bdt, kind in (
            ("d_1", 1001, 37, 1, torch.float32, torch.float32, "mixed"),
            ("d_602", 777, 64, 602, torch.float32, torch.float32, "mixed"),
            ("d_2304", 300, 50, 2304, torch.float32, torch.float32, "mixed"),
            ("m_0", 0, 8, 602, torch.float32, torch.float32, "mixed"),
            ("empty_cache", 99, 0, 602, torch.float32, torch.float32,
             "mixed"),
            ("all_hit", 500, 64, 130, torch.float32, torch.float32, "hit"),
            ("no_hit", 500, 64, 130, torch.float32, torch.float32, "miss"),
            ("bf16", 400, 40, 2304, torch.bfloat16, torch.bfloat16,
             "mixed"),
            ("bf16_odd_d", 400, 40, 3, torch.bfloat16, torch.bfloat16,
             "mixed"),
            ("f32_cache_bf16_base", 300, 40, 602, torch.float32,
             torch.bfloat16, "mixed"),
            ("bf16_cache_f32_base", 300, 40, 602, torch.bfloat16,
             torch.float32, "mixed"),
            ("padded_queries", 513, 32, 7, torch.float32, torch.float32,
             "padded")):
        ids = torch.randperm(5000, generator=gen)[:n_hot].sort().values \
            .to(torch.int32)
        feats = torch.randn((n_hot, d), generator=gen).to(cdt)
        if kind == "hit":
            q = ids[torch.randint(0, n_hot, (m,), generator=gen)]
        elif kind == "miss":
            q = torch.randint(5000, 9000, (m,), generator=gen)
        else:
            q = torch.randint(0, 5200, (m,), generator=gen)
            if n_hot and m:
                q[::3] = ids[torch.randint(0, n_hot, (q[::3].shape[0],),
                                           generator=gen)]
            if kind == "padded":
                q[::4] = -1
                q[1::6] = sentinel
        base = torch.randn((m, d), generator=gen).to(bdt)
        out.append((name, ids.to(device), feats.to(device),
                    q.to(torch.int32).to(device), base.to(device)))
    return out


def merge_kernel_row(torch, device, dist_in, emb_in, launches):
    """(f) ``merge_gather`` against its plain version at the staged
    epoch's shape (worker 0, step 0) and the embedding shape (worker 0),
    and over the awkward cases, every case bit-exact; times from CUDA
    graph replays."""
    from repro_torch.kernels.cache_lookup import ops as lk
    from repro_torch.kernels.cache_lookup.ref import (cache_lookup_ref,
                                                      merge_gather_ref)

    pos, hit = lk.search(dist_in["cache_ids"], dist_in["query"])
    shapes = []
    for what, f, b, p, h in (
            ("staged epoch", dist_in["cache_feats"], dist_in["base"], pos,
             hit),
            ("embedding", emb_in["cache_feats"], emb_in["base"],
             emb_in["pos"], emb_in["hit"])):
        got = lk.merge_gather(f, b, p, h)
        _equal(torch, got, merge_gather_ref(f, b, p, h))
        m, d = b.shape
        r = {"what": what, "bound": bound_ms(2 * m * d * b.element_size()
                                             + m * 5, 0),
             "ms": device_ms(torch, lambda: lk.merge_gather(f, b, p, h)),
             "plain_ms": device_ms(torch, lambda: merge_gather_ref(
                 f, b, p, h)),
             "hit_rate": float(h.float().mean().item()),
             "shape": f"base=({m},{d}) cache=({f.shape[0]},{d}) "
                      f"{str(b.dtype).split('.')[-1]}"}
        log(f"merge_gather {what}: {r['shape']} hit rate "
            f"{r['hit_rate']:.3f} ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f}; bit-equal to "
            f"its plain version")
        shapes.append(r)
    for name, ids, feats, q, base in merge_awkward(torch, device):
        p, h = lk.search(ids, q)
        _equal(torch, lk.merge_gather(feats, base, p, h),
               merge_gather_ref(feats, base, p, h))
        merged, mhit = lk.cache_lookup(ids, feats, q, base)
        want, whit = cache_lookup_ref(ids, feats, q, base)
        _equal(torch, merged, want)
        _equal(torch, mhit, whit)
    log("awkward shapes: merge_gather and cache_lookup (d 1/3/7/130/602/"
        "2304, m 0, empty cache, all hits, no hits, bf16 and mixed dtypes, "
        "-1 and sentinel queries) bit-equal to their plain versions")
    torch.cuda.synchronize()
    main = shapes[0]
    return {
        "name": "merge_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_lookup/csrc/merge_gather.cu",
        "replaces": "src/repro/kernels/cache_lookup/cache_lookup.py:103",
        "launches": launches, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound"][0], "bound_by": main["bound"][1],
        "library_ms": None, "shape": main["shape"],
        "embedding_shape": {"shape": shapes[1]["shape"],
                            "ms": shapes[1]["ms"],
                            "plain_ms": shapes[1]["plain_ms"],
                            "bound_ms": shapes[1]["bound"][0]}}


# ---------------------------------------------------------------------------
# phase 8: the multi-epoch runner (C_s/C_sec swap, staging thread, run states)
# ---------------------------------------------------------------------------

RUNNER_EPOCHS = 3


def runner_world(torch, device, g, pg, parts=PARTS, lazy=True):
    """The paper's GraphSAGE on all ``parts`` workers for RUNNER_EPOCHS
    epochs: schedules from the numpy compiler, and (``lazy``) lazy ones
    compiled on the card (rebuilt by the runner's staging thread)."""
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.core import build_schedule
    from repro_torch.dist import DeviceView
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=parts, epochs=RUNNER_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    t0 = time.perf_counter()
    eager = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                            num_epochs=RUNNER_EPOCHS, n_hot=exp.n_hot)
             for w in range(parts)]
    t1 = time.perf_counter()
    lazy = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                           num_epochs=RUNNER_EPOCHS, n_hot=exp.n_hot,
                           compiler="device", lazy=True, device=device)
            for w in range(parts)] if lazy else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"runner world: {parts} workers x {RUNNER_EPOCHS} epochs, batch "
        f"{exp.batch_size}, n_hot {exp.n_hot}; schedules numpy "
        f"{t1 - t0:.2f} s, lazy on the card (metadata prepass) "
        f"{t2 - t1:.2f} s")
    return {"exp": exp, "cfg": cfg, "g": g, "pg": pg, "eager": eager,
            "lazy": lazy, "dv": DeviceView.build(pg), "parts": parts}


def runner_make(w, device, kind="rapid", layout="flat", lazy=False, **kw):
    from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                                  Topology, make_mesh)
    from repro_torch.train import AdamW

    topo = Topology.parse(layout, w["parts"])
    mesh = (topo.make_mesh(device) if topo.is_hierarchical
            else make_mesh((w["parts"],), ("data",), device=device))
    cls = DeviceRapidGNNRunner if kind == "rapid" else DeviceBaselineRunner
    return cls(w["lazy" if lazy else "eager"], w["dv"], w["cfg"],
               AdamW(lr=TRAIN_LR), mesh, w["exp"].batch_size, w["g"].labels,
               seed=w["exp"].s0, assemble_backend="fused", topology=topo,
               **kw)


def runner_drive(torch, runner, counters, **run_kw):
    """One run with every launch count set to 0 just before it and read
    just after -> (reports, launches, peak device bytes the run added to
    what was allocated when it started)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters:
        c.reset()
    reports = runner.run(**run_kw)
    torch.cuda.synchronize()
    return (reports, {c.name: c.value for c in counters},
            torch.cuda.max_memory_allocated() - held)


def runner_epochs(reports):
    """Per epoch: train ms a step (the epoch's wall less the boundary
    copy and the exposed staging), wall, staging, copy, lanes, wires."""
    return [{"epoch": r.epoch,
             "train_ms_per_step": 1e3 * (r.wall_time_s - r.copy_s
                                         - r.exposed_stage_s) / r.steps,
             "wall_time_s": r.wall_time_s, "stage_s": r.stage_s,
             "exposed_stage_s": r.exposed_stage_s,
             "copy_ms": 1e3 * r.copy_s,
             "miss_lanes": r.miss_lanes.tolist(),
             "wire_rows": int(r.wire_rows),
             "intra_wire_rows": int(r.intra_wire_rows),
             "inter_wire_rows": int(r.inter_wire_rows),
             "degraded": r.degrade_reason or None} for r in reports]


def runner_cpu_losses(torch, w, runner):
    """The first CPU_LOSS_STEPS steps of epoch 0, collated to the
    runner's bounds, through the port's pipelined epoch on the CPU."""
    from repro_torch.dist import (collate_device_epoch, make_mesh,
                                  make_pipelined_epoch, stack_caches)
    from repro_torch.models.gnn import init_params
    from repro_torch.train import AdamW

    cpu = torch.device("cpu")
    dv, exp = w["dv"], w["exp"]
    es = [ws.epoch(0) for ws in w["eager"]]
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    batches = collate_device_epoch(es, caches, dv, w["g"].labels,
                                   exp.batch_size, runner.m_max,
                                   runner.edge_max, runner.k_max,
                                   runner.num_steps)
    cids, cfeats = stack_caches(caches, dv, runner.n_hot)
    params = init_params(w["cfg"], torch.Generator().manual_seed(exp.s0),
                         cpu)
    opt = AdamW(lr=TRAIN_LR)
    fn = make_pipelined_epoch(w["cfg"], opt,
                              make_mesh((w["parts"],), ("data",),
                                        device=cpu),
                              runner.m_max, assemble_backend="fused")
    return fn(params, opt.init(params), dv.table, dv.offsets, cids, cfeats,
              first_steps(batches, CPU_LOSS_STEPS))[2].numpy()


def _curve(reports):
    import numpy as np
    return np.concatenate([r.losses for r in reports])


def runner_phase(torch, device, g, pg, counters):
    """(a)-(f): the multi-epoch runners on the card, each run's curve
    held against (a)'s bit for bit."""
    import tempfile

    import numpy as np
    from repro_torch.dist import assert_host_parity
    from repro_torch.fault import active_plan, plan_from_profile
    from repro_torch.models.gnn import init_params
    from repro_torch.train import latest_step, load_run_state

    w = runner_world(torch, device, g, pg)
    B = w["exp"].batch_size
    runs, launches, peaks, counts = {}, {}, {}, {}

    def drive(name, runner, **run_kw):
        reports, launches[name], peaks[name] = runner_drive(
            torch, runner, counters, **run_kw)
        runs[name] = reports
        counts[name] = {"trace_count": runner.trace_count,
                        "stage_time_s": runner.stage_time_s,
                        "exposed_stage_s": runner.exposed_stage_s,
                        "recovery_wall_s": runner.recovery_wall_s,
                        "stage_retries": runner.stage_retries,
                        "deadline_overruns": runner.deadline_overruns,
                        "degraded_epochs": runner.degraded_epochs}
        idle = [k for k in ("assemble", "gather_agg", "gather_agg_bwd")
                if launches[name][k] == 0]
        if idle or launches[name]["merge_gather"] or \
                launches[name]["search"]:
            raise RuntimeError(f"runner {name}: launches {launches[name]}")
        return runner, reports

    # (a) rapid, numpy schedules, flat; run twice
    first, rep_a = drive("a rapid flat", runner_make(w, device))
    again, rep_a2 = drive("a rapid flat, again", runner_make(w, device))
    curve = _curve(rep_a)
    if first.trace_count != 1 or again.trace_count != 1:
        raise RuntimeError(f"trace_count {first.trace_count}, "
                           f"{again.trace_count}: expected 1")
    if not np.isfinite(curve).all() or curve.shape != (
            RUNNER_EPOCHS * first.num_steps,):
        raise RuntimeError(f"bad runner curve {curve.tolist()}")
    if curve.tobytes() != _curve(rep_a2).tobytes():
        raise RuntimeError("a second runner run gave another curve")
    for x, y in zip(first.params["layers"], again.params["layers"]):
        for k in x:
            if not torch.equal(x[k], y[k]):
                raise RuntimeError("a second runner run gave other weights")
    assert_host_parity(w["eager"], pg, B, rep_a)
    cpu = runner_cpu_losses(torch, w, first)
    np.testing.assert_allclose(curve[:CPU_LOSS_STEPS], cpu, rtol=1e-4,
                               atol=1e-5)

    # (b) lazy schedules compiled on the card by the staging thread
    lazy, rep_b = drive("b rapid flat, lazy on the card",
                        runner_make(w, device, lazy=True))
    if _curve(rep_b).tobytes() != curve.tobytes():
        raise RuntimeError("the lazy card schedule changed the curve")
    if launches["b rapid flat, lazy on the card"]["seg_sort"] == 0:
        raise RuntimeError("the staging thread launched no seg_sort")
    if any(launches[k]["seg_sort"] for k in launches if not
           k.startswith("b ")):
        raise RuntimeError(f"seg_sort outside the lazy run: {launches}")

    # (c) the on-demand baseline
    _, rep_c = drive("c baseline flat", runner_make(w, device, "baseline"))
    if _curve(rep_c).tobytes() != curve.tobytes():
        raise RuntimeError("the baseline runner's curve is not (a)'s")
    for r, b in zip(rep_a, rep_c):
        if (b.miss_lanes < r.miss_lanes).any():
            raise RuntimeError(f"epoch {r.epoch}: baseline lanes "
                               f"{b.miss_lanes} < rapid {r.miss_lanes}")

    # (d) two hosts of two
    hier, rep_d = drive("d rapid 2x2", runner_make(w, device,
                                                   layout="2x2"))
    if _curve(rep_d).tobytes() != curve.tobytes() or hier.trace_count != 1:
        raise RuntimeError("the 2x2 runner's curve is not (a)'s")
    for r, h in zip(rep_a, rep_d):
        if not np.array_equal(h.intra_lanes + h.inter_lanes, r.miss_lanes) \
                or h.intra_wire_rows + h.inter_wire_rows != h.wire_rows:
            raise RuntimeError(f"epoch {r.epoch}: tiers do not add up")

    # (e) checkpoint after epoch 1, resume [1, 3) in a fresh runner
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as td:
        _, head = drive("e head [0, 1)",
                        runner_make(w, device, checkpoint_dir=td),
                        stop_epoch=1)
        tail_runner = runner_make(w, device)
        like = init_params(w["cfg"], torch.Generator().manual_seed(1),
                           device)
        t0 = time.perf_counter()
        state, step = load_run_state(td, {"params": like,
                                          "opt": tail_runner.opt.init(like)})
        load_s = time.perf_counter() - t0
        if step != 1 or latest_step(td) != 1:
            raise RuntimeError(f"run state at step {step}, expected 1")
        _, tail = drive("e tail [1, 3)", tail_runner,
                        params=state["params"], opt_state=state["opt"],
                        start_epoch=step)
    if _curve(head + tail).tobytes() != curve.tobytes():
        raise RuntimeError("the resumed curve is not (a)'s")
    for x, y in zip(tail_runner.params["layers"], first.params["layers"]):
        for k in x:
            if not torch.equal(x[k], y[k]):
                raise RuntimeError("the resumed run gave other weights")

    # (f) the cache-loss fault profile
    plan = plan_from_profile("cache-loss", seed=3)
    with active_plan(plan):
        lost, rep_f = drive("f rapid flat, cache-loss",
                            runner_make(w, device))
    if (rep_f[1].degraded, rep_f[1].degrade_reason) != (1, "cache_lost") \
            or sum(r.degraded for r in rep_f) != 1:
        raise RuntimeError(f"cache-loss: epochs degraded "
                           f"{[r.degrade_reason for r in rep_f]}")
    if _curve(rep_f).tobytes() != curve.tobytes() or lost.trace_count > 2:
        raise RuntimeError(f"cache-loss changed the curve (trace_count "
                           f"{lost.trace_count})")

    out = {"epochs": RUNNER_EPOCHS, "steps": first.num_steps,
           "m_max": first.m_max, "k_max": first.k_max,
           "k_max_2x2": [hier.k_max, hier.k_max_inter],
           "losses": curve.tolist(), "cpu_losses": cpu.tolist(),
           "runs": {k: runner_epochs(v) for k, v in runs.items()},
           "runners": counts, "launches": launches, "peak_bytes": peaks,
           "run_state_load_s": load_s}
    log(f"runner: {PARTS} workers x {RUNNER_EPOCHS} epochs x "
        f"{first.num_steps} steps; (a) trace_count 1, host parity on every "
        f"epoch, run twice bit-identical, first {CPU_LOSS_STEPS} losses "
        f"within rtol=1e-4 atol=1e-5 of the CPU port; (b) lazy card "
        f"schedules, (c) baseline, (d) 2x2, (e) resumed from a run state "
        f"after epoch 1, (f) cache-loss (epoch 1 degraded, trace_count "
        f"{lost.trace_count}): every curve bit-equal to (a); losses "
        f"{['%.6f' % v for v in curve[::first.num_steps]]} at each "
        f"epoch's start")
    for name, epochs in out["runs"].items():
        for e in epochs:
            tiers = (f" (intra {e['intra_wire_rows']} + inter "
                     f"{e['inter_wire_rows']})"
                     if e["inter_wire_rows"] else "")
            log(f"runner {name} epoch {e['epoch']}: "
                f"{e['train_ms_per_step']:.2f} ms/step, wall "
                f"{e['wall_time_s']:.3f} s, stage_s {e['stage_s']:.3f}, "
                f"exposed_stage_s {e['exposed_stage_s']:.3f}, copy "
                f"{e['copy_ms']:.2f} ms, miss lanes {e['miss_lanes']}, "
                f"wire rows {e['wire_rows']}{tiers}"
                + (f", degraded ({e['degraded']})" if e["degraded"] else ""))
    log("runner launches " + json.dumps(launches))
    log("runner peak device memory MiB above each run's start " + json.dumps(
        {k: round(v / 2 ** 20, 1) for k, v in peaks.items()}))
    log("runner staging " + json.dumps(
        {k: {f: round(v, 4) if isinstance(v, float) else v
             for f, v in c.items()} for k, c in counts.items()}))
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper-metrics campaign, the fault campaign, the chaos sweep
# ---------------------------------------------------------------------------

CAMPAIGN_EPOCHS = 3
CAMPAIGN_N_HOT = 4096
#: launches each cell must make (the schedule's seg_sort is (b)'s only);
#: no cell launches search or merge_gather (the fused assembly ranks
#: inside its own kernel)
HOST_CELL_KERNELS = ("gather_agg", "gather_agg_bwd")
DEVICE_CELL_KERNELS = ("assemble", "gather_agg", "gather_agg_bwd")
#: the differential layers the full-width campaign must run
CAMPAIGN_CHECKS = ("miss_parity", "payload_bytes", "vector_pull_bytes",
                   "fetch_not_more", "loss_agreement", "topology_miss_parity",
                   "topology_byte_sum", "topology_loss_parity",
                   "one_compilation")


def campaign_spec(schedule_backend: str):
    """The paper's GraphSAGE at full width as a campaign: rapid vs the
    on-demand baseline on both backends, and the device pair again on
    two hosts of two workers (6 cells)."""
    import dataclasses

    from repro_torch.eval import CampaignSpec, grid

    cells = grid(backends=("host", "device"),
                 systems=("rapidgnn", "dgl-metis"), datasets=(DATASET,),
                 batch_sizes=(TRAIN_BATCH,), workers=(PARTS,),
                 n_hots=(CAMPAIGN_N_HOT,), epochs=CAMPAIGN_EPOCHS, seed=42,
                 fanouts=(25, 10), hidden=256, partition="greedy",
                 schedule_backend=schedule_backend)
    cells += [dataclasses.replace(c, topology="2x2")
              for c in cells if c.backend == "device"]
    return CampaignSpec(name=f"paper-{DATASET}-{schedule_backend}",
                        cells=tuple(cells))


def campaign_run(torch, device, spec, counters, out_path):
    """Every cell through the port's cell runners, one at a time with
    the launch counts set to 0 just before it and read just after (device
    cells of one scenario share their schedules), then the differential
    checks and the report, as ``run_campaign`` makes them."""
    from repro_torch.eval import (build_report, run_device_cells,
                                  run_host_cell, verify_cells, write_report)

    cells, launches, peaks, scenarios = [], [], [], {}
    t0 = time.perf_counter()
    for c in spec.cells:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for k in counters:
            k.reset()
        if c.backend == "host":
            cells.append(run_host_cell(c, device=device))
        else:
            cells.append(run_device_cells([c], device=device,
                                          scenarios=scenarios)[0])
        torch.cuda.synchronize()
        launches.append({k.name: k.value for k in counters})
        peaks.append(torch.cuda.max_memory_allocated() - held)
        want = HOST_CELL_KERNELS if c.backend == "host" \
            else DEVICE_CELL_KERNELS
        idle = [k for k in want if launches[-1][k] == 0]
        seg = launches[-1]["seg_sort"]
        if idle or launches[-1]["merge_gather"] or launches[-1]["search"] \
                or ((seg == 0) == (c.schedule_backend == "device")):
            raise RuntimeError(f"campaign cell {c.label()}: launches "
                               f"{launches[-1]}")
    report = build_report(spec.name, cells, verify_cells(cells))
    write_report(report, out_path)
    return {"cells": cells, "report": report, "launches": launches,
            "peaks": peaks, "wall_s": time.perf_counter() - t0}


def campaign_gates(run, runner):
    """The report validates, every check passes with every layer
    present, each device cell traced one input shape, and the device
    rapid cell's curve is phase 8's run (a) bit for bit: the same
    schedules, parameters and kernels, so its first steps also agree
    with phase 8's CPU steps."""
    import numpy as np
    from repro_torch.eval import validate_report

    report = run["report"]
    probs = validate_report(report)
    fails = [c for c in report["differential"] if c["status"] == "FAIL"]
    ran = {c["check"] for c in report["differential"]}
    missing = [k for k in CAMPAIGN_CHECKS if k not in ran]
    if probs or fails or missing or not report["all_checks_pass"]:
        raise RuntimeError(f"campaign {report['campaign']}: invalid {probs}, "
                           f"failed {fails}, layers missing {missing}")
    traces = [c.trace_count for c in run["cells"] if c.backend == "device"]
    if traces != [1] * 4:
        raise RuntimeError(f"device cells traced {traces}: expected 1 each")
    rapid = next(c for c in run["cells"] if c.backend == "device"
                 and c.system == "rapidgnn" and c.spec["topology"] == "flat")
    curve = np.asarray(rapid.losses, np.float32)
    if curve.tobytes() != np.asarray(runner["losses"],
                                     np.float32).tobytes():
        raise RuntimeError("the campaign's device rapid cell is not phase "
                           "8's run (a)")
    np.testing.assert_allclose(curve[:CPU_LOSS_STEPS], runner["cpu_losses"],
                               rtol=1e-4, atol=1e-5)


#: the fields of a cell that no clock decides
CELL_COUNTS = ("num_steps", "warm_steps", "rpc_count", "remote_requests",
               "cache_hits", "cache_misses", "hit_rate", "remote_bytes",
               "vector_pull_bytes", "payload_bytes", "miss_matrix",
               "wire_rows", "device_cache_bytes", "request_bytes",
               "intra_misses", "inter_misses", "intra_bytes", "inter_bytes",
               "intra_wire_rows", "inter_wire_rows", "trace_count",
               "degraded_epochs", "fault_events", "losses", "accs")


def campaign_cell_lines(name, run):
    for c, ln, pk in zip(run["cells"], run["launches"], run["peaks"]):
        tiers = (f" (intra {c.intra_wire_rows} + inter {c.inter_wire_rows})"
                 if c.backend == "device" else "")
        log(f"campaign {name} {c.spec['backend']}/{c.system}/"
            f"{c.spec['topology']}: step_time_ms {c.step_time_ms:.3f}, "
            f"warm_wall_s {c.warm_wall_s:.3f}, rpc_count {c.rpc_count}, "
            f"remote_bytes {c.remote_bytes}, vector_pull_bytes "
            f"{c.vector_pull_bytes}, wire_rows {c.wire_rows}{tiers}, "
            f"hit_rate {c.hit_rate:.4f}, trace_count {c.trace_count}, "
            f"stage_time_s {c.stage_time_s:.3f} / exposed_stage_s "
            f"{c.exposed_stage_s:.3f}, launches "
            f"{json.dumps({k: v for k, v in ln.items() if v})}, peak "
            f"{pk / 2 ** 20:.1f} MiB")
    for p in run["report"]["pairs"]:
        e = p["energy"]
        log(f"campaign {name} pair {p['backend']}/"
            f"{p['scenario']['topology']} rapid vs {p['baseline_system']}: "
            f"throughput_speedup {p['throughput_speedup']}x, "
            f"fetch_reduction_x {p['fetch_reduction_x']}, "
            f"bytes_reduction_x {p['bytes_reduction_x']}; modelled energy "
            f"(Table 3 power x measured time) cpu_ratio {e['cpu_ratio']}, "
            f"gpu_ratio {e['gpu_ratio']}, total_ratio {e['total_ratio']}")
    n = {s: sum(1 for c in run["report"]["differential"] if c["status"] == s)
         for s in ("PASS", "FAIL", "SKIP")}
    log(f"campaign {name} differential: {n['PASS']} passed, {n['FAIL']} "
        f"failed, {n['SKIP']} skipped; wall {run['wall_s']:.2f} s")


def chaos_lines(out, cpu):
    for r, c in zip(out["runs"], cpu["runs"]):
        log(f"chaos train {r['plan']}: fires {r['fires']}, {r['outcome']} "
            f"(CPU: fires {c['fires']}, {c['outcome']})")
    for r in out["serve"]["runs"]:
        log(f"chaos serve {r['plan']}: fires {r['fires']}, ok {r['ok']}, "
            f"shed {r['shed']}, typed {r['typed']}, stale {r['stale']}")


def campaign_phase(torch, device, counters, runner):
    """(a) the paper campaign at full width, (b) the same grid with
    every schedule compiled on the card, (c) the fault campaign, (d) the
    chaos sweep on the card beside the same sweep on the CPU."""
    from repro_torch.eval import validate_fault_report
    from repro_torch.eval.campaign import run_fault_campaign
    from repro_torch.fault.chaos import run_chaos

    os.makedirs(OUT_DIR, exist_ok=True)
    walls = {}
    runs = {}
    for name, backend in (("a", "numpy"), ("b", "device")):
        suffix = "" if backend == "numpy" else "_device"
        runs[name] = campaign_run(
            torch, device, campaign_spec(backend), counters,
            os.path.join(OUT_DIR, f"BENCH_torch_paper{suffix}.json"))
        campaign_gates(runs[name], runner)
        walls[name] = runs[name]["wall_s"]
    for ca, cb in zip(runs["a"]["cells"], runs["b"]["cells"]):
        diff = [k for k in CELL_COUNTS if getattr(ca, k) != getattr(cb, k)]
        if diff:
            raise RuntimeError(f"{cb.spec['backend']}/{cb.system}/"
                               f"{cb.spec['topology']}: (b) differs from (a) "
                               f"in {diff}")
    for name in ("a", "b"):
        campaign_cell_lines(name, runs[name])
    log("campaign (a) numpy schedules vs (b) schedules on the card, "
        "step_time_ms: " + ", ".join(
            f"{ca.spec['backend']}/{ca.system}/{ca.spec['topology']} "
            f"{ca.step_time_ms:.3f} vs {cb.step_time_ms:.3f}"
            for ca, cb in zip(runs["a"]["cells"], runs["b"]["cells"])))

    t0 = time.perf_counter()
    for k in counters:
        k.reset()
    fault = run_fault_campaign(
        device=device, out_path=os.path.join(OUT_DIR,
                                             "BENCH_torch_fault.json"))
    torch.cuda.synchronize()
    walls["c"] = time.perf_counter() - t0
    fault_launches = {k.name: k.value for k in counters}
    probs = validate_fault_report(fault)
    if probs or not fault["all_checks_pass"] or not any(
            r["degraded_epochs"] > 0 for r in fault["fault_summary"]):
        raise RuntimeError(f"fault campaign: invalid {probs}, failed "
                           f"{[c for c in fault['differential'] if c['status'] == 'FAIL']}")
    for r in fault["fault_summary"]:
        log(f"fault {r['backend']} {r['fault_profile']}: fires "
            f"{r['fault_events']}, degraded {r['degraded_epochs']}, retries "
            f"{r['retry_total']}, recovery_wall_s {r['recovery_wall_s']}")

    t0 = time.perf_counter()
    for k in counters:
        k.reset()
    chaos = run_chaos(seed=0, fast=True, device=device, log=lambda s: None)
    torch.cuda.synchronize()
    walls["d"] = time.perf_counter() - t0
    chaos_launches = {k.name: k.value for k in counters}
    t0 = time.perf_counter()
    cpu = run_chaos(seed=0, fast=True, device=torch.device("cpu"),
                    log=lambda s: None)
    walls["d CPU"] = time.perf_counter() - t0
    plans = [(r["plan"], r["fires"], r["outcome"]) for r in chaos["runs"]]
    if not chaos["ok"] or chaos["serve"]["trace_count"] != 1 or plans != [
            (r["plan"], r["fires"], r["outcome"]) for r in cpu["runs"]]:
        raise RuntimeError(f"chaos: ok {chaos['ok']}, failed "
                           f"{chaos['failed_plans']}, serve trace_count "
                           f"{chaos['serve']['trace_count']}, plans {plans}")
    idle = [k for k in DEVICE_CELL_KERNELS if chaos_launches[k] == 0]
    if idle or fault_launches["gather_agg_bwd"] == 0 or \
            chaos_launches["search"] or fault_launches["search"]:
        raise RuntimeError(f"chaos launches {chaos_launches}, fault "
                           f"launches {fault_launches}")
    chaos_lines(chaos, cpu)
    log(f"chaos: {len(chaos['runs'])} train plans as on the CPU, "
        f"{len(chaos['serve']['runs'])} serve plans, serve trace_count 1, "
        f"checkpoint drill {chaos['checkpoint_drill']}; launches "
        + json.dumps({k: v for k, v in chaos_launches.items() if v}))
    log("fault campaign launches " + json.dumps(
        {k: v for k, v in fault_launches.items() if v}))
    total = {}
    for ln in runs["a"]["launches"]:
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    log("campaign (a) launches over its 6 cells " + json.dumps(total))
    log("campaign walls s " + json.dumps(
        {k: round(v, 2) for k, v in walls.items()}))
    with open(os.path.join(OUT_DIR, "chaos_torch.json"), "w") as f:
        json.dump({"card": chaos, "cpu": cpu}, f, indent=1)
    return {"walls": walls, "launches_a": total,
            "launches": {k: v["launches"] for k, v in runs.items()},
            "peaks": {k: v["peaks"] for k, v in runs.items()},
            "pairs": {k: v["report"]["pairs"] for k, v in runs.items()},
            "fault_summary": fault["fault_summary"],
            "fault_launches": fault_launches,
            "chaos": {"train": chaos["runs"], "serve": chaos["serve"]["runs"]},
            "chaos_launches": chaos_launches}


# ---------------------------------------------------------------------------
# phase 10: LM training
# ---------------------------------------------------------------------------

def lm_train_run(torch, device, cfg, batch: int, seq: int, steps: int,
                 gen_device, counters=(), trace: bool = False):
    """``make_train_step`` with the launcher's AdamW from parameters drawn
    by a seeded generator on ``gen_device``, over ``synthetic_lm_batches``
    on ``device``: the loss curve, each step's ms (host clock; the loss
    read synchronises), launches (counts set to 0 just before the steps,
    read just after), peak device memory, and with ``trace`` one more
    step under ``torch.profiler``."""
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.models.transformer import init_params, make_train_step
    from repro_torch.train import AdamW

    batches = [{k: v.to(device) for k, v in b.items()}
               for b in synthetic_lm_batches(cfg, batch=batch, seq=seq,
                                             steps=steps, s0=LM_SEED)]
    params = init_params(cfg, torch.Generator(device=gen_device).manual_seed(
        LM_SEED), device)
    opt = AdamW(lr=3e-4, weight_decay=0.01, max_grad_norm=1.0)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, aux = step(params, state, b)
        losses.append(aux["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    out = {"losses": losses, "step_ms": ms,
           "launches": {c.name: c.value for c in counters},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "parameters": sum(t.numel() for t in _leaves(params))}
    if trace:
        out["split_ms"] = step_split(torch, cfg, opt, params, state,
                                     batches[0])
        wall, busy, ops = card_time_by_op(
            torch, lambda: step(params, state, batches[0]), top=10,
            host=False)
        out.update(traced_ms=1e3 * wall, card_busy_ms=busy,
                   card_ms_by_op=ops)
    return out


def step_split(torch, cfg, opt, params, state, batch):
    """One more step of ``make_train_step``'s body, its three parts timed
    with CUDA events: the loss (forward), the gradient (the backward, each
    repeat's forward run again inside it) and the in-place update."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.optim import tree_leaves, tree_map
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm_loss(cfg, p, batch)
    ev[1].record()
    it = iter(torch.autograd.grad(loss, tree_leaves(p)))
    ev[2].record()
    grads = tree_map(lambda _: next(it), params)
    opt.update(grads, state, params, inplace=True)
    ev[3].record()
    torch.cuda.synchronize()
    return {part: ev[i].elapsed_time(ev[i + 1]) for i, part in
            enumerate(("forward", "backward", "update"))}


def attention_share(torch, device, cfg, seq: int):
    """One layer's chunked attention at the training shape, under autograd
    as a step runs it: the forward and the backward timed with CUDA events
    (median of 3), and what ``num_layers`` x (2 forwards, one of them the
    rematerialisation, + 1 backward) come to."""
    from repro_torch.models.transformer.attention import attention
    gen = torch.Generator(device=device).manual_seed(LM_SEED)

    def rand(h):
        return torch.randn((1, seq, h, cfg.head_dim), generator=gen,
                           device=device).to(torch.bfloat16)
    q = rand(cfg.num_heads).requires_grad_()
    k, v = (rand(cfg.num_kv_heads).requires_grad_() for _ in range(2))
    g = rand(cfg.num_heads)
    kw = dict(attn_softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
              kv_chunk=cfg.attn_kv_chunk)
    times = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        o = attention(q, k, v, **kw)
        ev[1].record()
        torch.autograd.grad(o, (q, k, v), g)
        ev[2].record()
        torch.cuda.synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    fwd, bwd = sorted(times)[1]
    return {"forward_ms": fwd, "backward_ms": bwd,
            "step_ms": cfg.num_layers * (2 * fwd + bwd)}


def embedding_backward(torch, device, cfg, tokens):
    """The token embedding's backward, which sums the rows of repeated
    tokens, twice on the same inputs, two ways: the model's ``_embed``
    (``F.embedding``; must be bit-equal) and ``table[tokens]`` (an
    accumulating ``index_put_``; recorded). Each with the card kernels it
    runs by name, ms a call over ``EMB_BWD_CALLS`` calls traced (a trace
    of one short call loses kernels at its edges)."""
    from repro_torch.models.transformer.model import _embed
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=device).to(torch.bfloat16).requires_grad_()
    g = torch.randn((*tokens.shape, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    out = {"tokens": tokens.numel(),
           "unique": int(torch.unique(tokens).numel())}
    for name, fwd in (("embedding", lambda: _embed(cfg, {"embed": table},
                                                    tokens)),
                      ("index", lambda: table[tokens.long()])):
        def run():
            return torch.autograd.grad(fwd(), table, g)[0]
        equal = torch.equal(run(), run())
        _, busy, ops = card_time_by_op(
            torch, lambda: [run() for _ in range(EMB_BWD_CALLS)], top=4)
        out[name] = {"bit_equal": equal,
                     "card_busy_ms": busy / EMB_BWD_CALLS,
                     "card_ms_by_op": {k: v / EMB_BWD_CALLS
                                       for k, v in ops.items()}}
    if not out["embedding"]["bit_equal"]:
        raise RuntimeError("the model's embedding backward differs between "
                           "two runs on the same inputs")
    return out


def _close(a, b, rtol=1e-4, atol=1e-5) -> bool:
    return all(abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))


def full_train(torch, device, cfg, counters):
    """``cfg`` at full width and depth in bfloat16, LM_TRAIN_B x
    LM_TRAIN_S, LM_TRAIN_STEPS steps from parameters drawn on the card,
    twice: no kernel launched, the losses finite and the last below the
    first, the second fresh run's curve bit-equal. Logs the ms a step,
    tokens/s, TFLOP/s of 6*N*T, peak memory, the step's split by CUDA
    events and the traced step's card ms by op."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    tokens = LM_TRAIN_B * LM_TRAIN_S
    runs = [lm_train_run(torch, device, cfg, LM_TRAIN_B, LM_TRAIN_S,
                         LM_TRAIN_STEPS, device, counters, trace)
            for trace in (True, False)]
    a, b = runs
    losses = a["losses"]
    if any(n for n in a["launches"].values()):
        raise RuntimeError(f"LM training launched {a['launches']}: the "
                           f"gradient path must not call the kernels")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"{cfg.name} losses {losses}: not finite or not "
                           f"falling")
    if b["losses"] != losses:
        raise RuntimeError(f"a second fresh run gave another curve: "
                           f"{b['losses']} against {losses}")
    steady = a["step_ms"][1:]
    ms = sum(steady) / len(steady)
    flops = 6 * a["parameters"] * tokens
    out = {"arch": cfg.name, "batch": LM_TRAIN_B, "seq": LM_TRAIN_S,
           "held_at_start_bytes": held, "runs": runs, "ms": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "model_tflops_per_s": flops / (ms / 1e3) / 1e12}
    kinds = "/".join(sorted(set(cfg.pattern + cfg.tail)))
    log(f"lm train {cfg.name}: {'full' if LM_FULL else 'reduced'} "
        f"{cfg.num_layers} layers ({kinds}) d={cfg.d_model} "
        f"H={cfg.num_heads} kvH={cfg.num_kv_heads} dh={cfg.head_dim} "
        f"{cfg.dtype}, {a['parameters'] / 1e9:.3f} B parameters, "
        f"B={LM_TRAIN_B} S={LM_TRAIN_S}; {held / 2**30:.2f} GiB held at the "
        f"start")
    log(f"lm train {cfg.name}: {LM_TRAIN_STEPS} steps, losses {losses}; ms "
        f"a step {[round(x, 2) for x in a['step_ms']]} (first includes "
        f"warm-up), {ms:.2f} after it ({out['tokens_per_s']:.0f} tok/s, "
        f"{out['model_tflops_per_s']:.1f} TFLOP/s of 6*N*T, "
        f"{100 * out['model_tflops_per_s'] * 1e12 / BF16_FLOPS_PER_S:.1f} % "
        f"of 989); peak device memory {a['peak_bytes'] / 2**30:.2f} GiB; "
        f"launches {json.dumps(a['launches'])}; last loss below the first; "
        f"second fresh run bit-equal (its ms a step "
        f"{[round(x, 2) for x in b['step_ms']]})")
    split = a["split_ms"]
    log(f"lm train {cfg.name} step split (CUDA events): forward "
        f"{split['forward']:.1f} ms, backward with the rematerialised "
        f"forwards {split['backward']:.1f} ms, AdamW in place "
        f"{split['update']:.1f} ms")
    log(f"lm train {cfg.name} traced step (card activity only): wall "
        f"{a['traced_ms']:.2f} ms, card busy {a['card_busy_ms']:.2f} ms; "
        f"card ms by op {json.dumps(a['card_ms_by_op'])}")
    return out


def reduced_train(torch, device, cfg, counters, what):
    """``cfg`` (a reduced config) in float32, LM_REDUCED_STEPS steps of
    the launcher's batch (LM_REDUCED_B x LM_REDUCED_S) on the card, again
    on the card and on the CPU, from the same CPU-drawn parameters: the
    card's losses within ``rtol=1e-4, atol=1e-5`` of the CPU's, the second
    card run bit-equal, no kernel launched."""
    cpu = torch.device("cpu")
    args = (cfg, LM_REDUCED_B, LM_REDUCED_S, LM_REDUCED_STEPS, cpu)
    card = lm_train_run(torch, device, *args, counters)
    again = lm_train_run(torch, device, *args)
    host = lm_train_run(torch, cpu, *args)
    if any(n for n in card["launches"].values()):
        raise RuntimeError(f"{what} training launched {card['launches']}")
    if not _close(card["losses"], host["losses"]):
        raise RuntimeError(f"{what}: card losses {card['losses']} vs CPU "
                           f"{host['losses']}")
    if again["losses"] != card["losses"]:
        raise RuntimeError(f"{what}: a second card run gave "
                           f"{again['losses']}, not {card['losses']}")
    log(f"lm train {what} (reduced, float32, {LM_REDUCED_B}x"
        f"{LM_REDUCED_S}): card {card['losses']} within rtol=1e-4 "
        f"atol=1e-5 of the CPU {host['losses']}; second card run "
        f"bit-equal; launches {json.dumps(card['launches'])}")
    return {"card": card["losses"], "cpu": host["losses"],
            "card_step_ms": card["step_ms"], "launches": card["launches"]}


def lm_train_phase(torch, device, counters):
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced

    cfg = get_arch(LM_TRAIN_ARCH) if LM_FULL else get_reduced(LM_TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    out = full_train(torch, device, cfg, counters)
    attn = attention_share(torch, device, cfg, LM_TRAIN_S)
    out["attention"] = attn
    log(f"lm train attention: one layer's chunked attention (1, "
        f"{LM_TRAIN_S}, {cfg.num_heads}/{cfg.num_kv_heads}, {cfg.head_dim}) "
        f"bf16: forward {attn['forward_ms']:.2f} ms, backward "
        f"{attn['backward_ms']:.2f} ms, x {cfg.num_layers} layers x (2 "
        f"forwards + 1 backward) = {attn['step_ms']:.1f} ms, "
        f"{100 * attn['step_ms'] / out['ms']:.1f} % of the step")
    from repro_torch.data.pipeline import synthetic_lm_batches
    toks = next(synthetic_lm_batches(cfg, batch=LM_TRAIN_B, seq=LM_TRAIN_S,
                                     steps=1, s0=LM_SEED))["tokens"]
    emb = embedding_backward(torch, device, cfg, toks.to(device))
    out["embedding_backward"] = emb
    for name in ("embedding", "index"):
        log(f"lm train embedding backward ({name}): {emb['tokens']} tokens "
            f"({emb['unique']} distinct) into ({cfg.padded_vocab}, "
            f"{cfg.d_model}) bf16, two runs bit-equal: "
            f"{emb[name]['bit_equal']}; card ms a call by op "
            f"{json.dumps(emb[name]['card_ms_by_op'])}")
    out["reduced"] = {arch: reduced_train(torch, device, get_reduced(arch),
                                          counters, arch)
                      for arch in LM_TRAIN_REDUCED}
    return out


# ---------------------------------------------------------------------------
# phase 11: decode serving of the MoE, SSD and RG-LRU blocks
# ---------------------------------------------------------------------------

#: (architecture, prefill S, why S): each served at its full width and
#: depth in bfloat16. The repo's ``prefill_32k`` (S=32768, global batch
#: 32) is cut to B=1: S=8192 as phase 6, and S=4096 for qwen3-moe, whose
#: weights take 61 GB of the card's 80
MIXER_SERVE = (
    ("mamba2-1.3b", 8192, "prefill_32k cut to B=1 S=8192, as phase 6"),
    ("recurrentgemma-9b", 8192, "prefill_32k cut to B=1 S=8192, as "
     "phase 6; past the 2048 window"),
    ("qwen3-moe-30b-a3b", 4096, "prefill_32k cut to B=1 S=4096: the "
     "weights take 61 GB of the card's 80"))
MIXER_FULL = True
MIXER_REDUCED = ("qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b",
                 "arctic-480b")
#: the reduced configs' check: prefill over 8 x 48 tokens, and the 47
#: decode steps of the same tokens (the 16-slot local ring wraps)
MIXER_REDUCED_B, MIXER_REDUCED_S = 8, 48
#: the full cache of each attention model's ``flash_decode`` row (the
#: row's numbers; the decode loop's own cache is checked and timed
#: beside it): recurrentgemma-9b's 2048-slot local window, and a cache as
#: long as qwen3-moe-30b-a3b's 4096-token prefill
MIXER_DECODE_CACHE = {"recurrentgemma-9b": 2048, "qwen3-moe-30b-a3b": 4096}
#: decode steps traced for the card's time by op (from a one-token
#: prompt), not the whole 47-step loop: at some 5,000 kernels a step
#: (qwen3-moe-30b-a3b) its events are slow to gather
MIXER_TRACE_STEPS = 8


def mixer_serve(torch, device, name, seq, cut, counters):
    """(a)-(c) one architecture at full width and depth: parameters from
    a seeded generator on the card, ``prefill_phase`` at B=1, S=``seq``
    and ``decode_phase``'s greedy loop (card activity traced alone)."""
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.models.transformer import init_params

    cfg = get_arch(name) if MIXER_FULL else get_reduced(name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    kinds = "/".join(sorted(set(cfg.pattern + cfg.tail)))
    log(f"mixer {name}: {'full' if MIXER_FULL else 'reduced'} "
        f"{cfg.num_layers} layers ({kinds}; {attn_layers(cfg)} attention) "
        f"d={cfg.d_model} H={cfg.num_heads} kvH={cfg.num_kv_heads} "
        f"dh={cfg.head_dim} window={cfg.window}"
        f"{f' experts {cfg.num_experts} top-{cfg.top_k}' if cfg.moe else ''}"
        f" {cfg.dtype}: {n / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) "
        f"from seed {LM_SEED} in {time.perf_counter() - t0:.2f} s; {cut}")
    prefill = prefill_phase(torch, device, cfg, params, counters, seq=seq)
    decode = decode_phase(torch, device, cfg, params, counters, host=False,
                          trace_steps=MIXER_TRACE_STEPS)
    return cfg, params, {"parameters": n, "prefill": prefill,
                         "decode": decode, "cut": cut}


def attention_row(torch, device, name, desc, q, k, v, launches, *,
                  causal=True, window=0, softcap=0.0, ragged_skv=None):
    """``flash_attention`` (bfloat16) on q/k/v against its plain version
    (``rtol=2^-7, atol=1e-5``) over the whole k/v and, without a mask,
    over its first ``ragged_skv`` keys too; one card operation a call,
    timed beside the plain version, SDPA (the same mask, ``enable_gqa``,
    no softcap) and its FLOP bound (4 dh a valid pair)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, Sq, H, dh = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    kw = dict(causal=causal, window=window, softcap=softcap)
    err = 0.0
    for n in (Skv,) + ((ragged_skv,) if ragged_skv else ()):
        kk, vv = (t[:, :n].contiguous() for t in (k, v))
        got = fa_ops.flash_attention(q, kk, vv, **kw).float()
        want = flash_attention_ref(q, kk, vv, **kw).float()
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=2 ** -7, atol=1e-5):
            raise RuntimeError(f"flash_attention G={G} ({desc}) differs "
                               f"from its plain version at Skv={n}: {err}")
        del kk, vv, got, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        ip = torch.arange(Sq, device=device)
        sdpa_kw, mask = {"attn_mask": (ip[None, :] <= ip[:, None]) & (
            ip[None, :] > ip[:, None] - window)}, "band mask"
    else:
        sdpa_kw = {"is_causal": causal}
        mask = "is_causal" if causal else "no mask"

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **sdpa_kw)

    def kern():
        return fa_ops.flash_attention(q, k, v, **kw)
    lib_err = float((sdpa().transpose(1, 2).float() - flash_attention_ref(
        q, k, v, causal=causal, window=window).float()).abs().max())
    if lib_err > 0.05:
        raise RuntimeError(f"SDPA yardstick (G={G}, {desc}) computes "
                           f"another function: {lib_err}")
    ops = device_ops(torch, kern)
    if len(ops) != 1:
        raise RuntimeError(f"flash_attention G={G} ({desc}) ran {len(ops)} "
                           f"card operations a call: {ops}")
    flop = 4 * dh * H * B * (causal_pairs(Sq, window) if causal
                             else Sq * Skv)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    r = {"name": name, "route": "cuda", "source": ATTENTION_SOURCE,
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
         "launches": launches, "max_abs_err": err,
         "ms": device_ms(torch, kern, iters=5),
         "plain_ms": device_ms(torch, lambda: flash_attention_ref(
             q, k, v, **kw), iters=3),
         "library_ms": device_ms(torch, sdpa, iters=5),
         "library_err_no_softcap": lib_err, "flop": flop,
         "device_ops": len(ops),
         "shape": f"{desc} q=({B},{Sq},{H},{dh}) k/v=({B},{Skv},{kvH},{dh}) "
                  f"{mask} window={window} softcap={softcap} bf16 (G={G})"}
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flop, BF16_FLOPS_PER_S)
    r["tflops"] = flop / r["ms"] / 1e9
    log(f"flash_attention {r['shape']}: ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.3f} library_ms={r['library_ms']:.4f} (SDPA, "
        f"{mask}, enable_gqa) bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}, {flop:.4g} FLOP; {r['tflops']:.1f} TFLOP/s, "
        f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound"
        f"{beside_old_attention(name, r['ms'])}); 1 card op a "
        f"call; max_abs_err {err:.3e} over Skv {Skv}"
        f"{f' and {ragged_skv}' if ragged_skv else ''} (rtol=2^-7 "
        f"atol=1e-5); launches {launches} in the model's prefill")
    return r


def mixer_attention_row(torch, device, cfg, params, seq, launches,
                        name=None, embeds=None, mrope_positions=None):
    """``attention_row`` on the model's first attention layer's own q/k/v
    at the prefill shape, B=1, S=``seq`` (recurrentgemma-9b's local layer
    at G=16 with window 2048, qwen3-moe-30b-a3b's global layer at G=8
    after q/k-norm, seamless-m4t-medium's causal decoder self-attention at
    G=1, qwen2-vl-72b's at G=8 after M-RoPE); ``embeds`` and
    ``mrope_positions`` as ``forward`` takes them."""
    from repro_torch.models.transformer.blocks import (_project_qkv,
                                                       block_apply)
    from repro_torch.models.transformer.common import rms_norm
    from repro_torch.models.transformer.model import _embed, _unstack

    toks = torch.from_numpy(lm_tokens(cfg, (1, seq), 0x5046)).to(device)
    pos = torch.arange(seq, device=device)[None, :]
    with torch.inference_mode():
        x = _embed(cfg, params, toks)
        if embeds is not None:
            x = x + embeds.to(x.dtype)
        for i, kind in enumerate(cfg.pattern):
            p = _unstack(params["blocks"][i])[0]
            if kind in ("attn", "local"):
                h = rms_norm(x, p["ln1"], cfg.norm_eps)
                q, k, v = (t.contiguous() for t in _project_qkv(
                    cfg, p["attn"], h, pos, mrope_positions))
                break
            x = block_apply(cfg, kind, p, x, positions=pos,
                            mrope_positions=mrope_positions)
    del x, h
    G = q.shape[2] // k.shape[2]
    return attention_row(
        torch, device, name or f"flash_attention_g{G}", f"{cfg.name} {kind}",
        q, k, v, launches, causal=True,
        window=cfg.window if kind == "local" else 0,
        softcap=cfg.attn_softcap)


def mixer_decode_row(torch, device, cfg, launches, full_s=None, loop=True,
                     lengths=None, name=None, what=""):
    """``flash_decode`` at the model's heads, B=DECODE_B, bfloat16, over a
    cache of ``full_s`` positions (``MIXER_DECODE_CACHE`` by default; the
    row's numbers) and, with ``loop``, the decode loop's own cache from
    ``init_decode_state``. At each cache size S, ``lengths(S)`` gives the
    (B,) length vectors, the first of them timed: by default full lengths
    and ragged ones from 0 to S. Against the plain version at each (float32
    outputs, ``rtol=1e-4, atol=1e-5``, exactly 0 at a length of 0), with
    the time beside the plain version's, SDPA's (``enable_gqa``; a
    boolean mask where the timed lengths are short of S) and the byte
    bound over the valid rows; one card operation a call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import (flash_decode_batched_ref,
                                                      finalize)
    from repro_torch.models.transformer import init_decode_state

    gen = torch.Generator(device=device).manual_seed(LM_SEED + 4)
    B, H, kvH, dh = DECODE_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // kvH
    name = name or f"flash_decode_g{G}"
    cap = cfg.attn_softcap
    sizes = [full_s or MIXER_DECODE_CACHE[cfg.name]]
    if loop:
        st = init_decode_state(cfg, B, DECODE_PROMPT + DECODE_GEN,
                               device=device)
        sizes.append(next(s["k"] for s in st["scan"] if "k" in s).shape[2])
        del st

    def default_lengths(S):
        return [torch.full((B,), S, dtype=torch.int32, device=device),
                torch.arange(B, dtype=torch.int32, device=device) * 7
                % (S + 1)]
    shapes = {}
    for S in sizes:
        q = torch.randn((B, H, dh), generator=gen, device=device,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, kvH, dh), generator=gen, device=device,
                            dtype=torch.bfloat16) for _ in range(2))
        lens = (lengths or default_lengths)(S)
        timed = lens[0]

        def kern():
            return fd_ops.flash_decode_batched(q, k, v, timed, softcap=cap)

        def plain():
            return flash_decode_batched_ref(q, k, v, timed, softcap=cap)
        err = 0.0
        for ln in lens:
            got = fd_ops.flash_decode_batched(q, k, v, ln, softcap=cap)
            acc, m, l = flash_decode_batched_ref(q, k, v, ln, softcap=cap)
            err = max(err, float((got - finalize(acc, l)).abs().max()))
            if not torch.allclose(got, finalize(acc, l), rtol=1e-4,
                                  atol=1e-5) or \
                    not bool((got[ln == 0] == 0).all()):
                raise RuntimeError(f"flash_decode G={G} ({cfg.name} {what})"
                                   f" differs from its plain version at "
                                   f"S={S}: {err}")
        acc, m, l = plain()
        parts = fd_ops.flash_decode(q[1], k[1], v[1], timed[1], softcap=cap)
        for g_, w_ in zip(parts, (acc[1], m[1], l[1])):
            if not torch.allclose(g_, w_, rtol=1e-4, atol=1e-5):
                raise RuntimeError(f"flash_decode G={G} partials differ")
        ops = device_ops(torch, kern)
        if len(ops) != 1:
            raise RuntimeError(f"flash_decode G={G} ran {len(ops)} card "
                               f"operations a call: {ops}")
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(S, device=device)[None, :] < timed[:, None])[
            :, None, None, :] if bool((timed < S).any()) else None

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((sdpa()[:, :, 0].float() - finalize(
            *flash_decode_batched_ref(q, k, v, timed)[::2])).abs().max())
        if lib_err > 0.05:
            raise RuntimeError(f"SDPA yardstick (decode G={G}) computes "
                               f"another function: {lib_err}")
        valid = int(timed.sum())
        nbytes = 2 * valid * kvH * dh * k.element_size() + \
            q.numel() * q.element_size() + B * H * dh * 4
        bound = bound_ms(nbytes, 4 * dh * H * valid, BF16_FLOPS_PER_S)
        shapes[S] = {
            "cache": [B, S, kvH, dh], "lengths": timed.tolist(),
            "max_abs_err": err, "device_ops": len(ops),
            "ms": device_ms(torch, kern),
            "ms_in_a_graph": device_ms_per_call(torch, kern),
            "plain_ms": device_ms(torch, plain, iters=5),
            "library_ms": device_ms(torch, sdpa),
            "library_ms_in_a_graph": device_ms_per_call(torch, sdpa),
            "library_err_no_softcap": lib_err, "bytes": nbytes,
            "bound_ms": bound[0], "bound_by": bound[1]}
        sh = shapes[S]
        log(f"flash_decode {cfg.name}{f' {what}' if what else ''} q=({B},"
            f"{H},{dh}) cache=({B},{S},{kvH},{dh}) bf16 (G={G}"
            f"{', the loop' if S != sizes[0] else ''}), lengths "
            f"{'full' if mask is None else timed.tolist()}: ms="
            f"{sh['ms']:.4f} ({sh['ms_in_a_graph']:.4f} a call in a graph "
            f"of 20) plain_ms={sh['plain_ms']:.4f} library_ms="
            f"{sh['library_ms']:.4f} ({sh['library_ms_in_a_graph']:.4f} in "
            f"a graph; SDPA enable_gqa, {'no' if mask is None else 'boolean'}"
            f" mask, no softcap) bound_ms={sh['bound_ms']:.5f} "
            f"({sh['bound_by']}, {nbytes / 1e6:.1f} MB); {len(ops)} card op "
            f"a call; "
            + (beside_old(name, sh['ms'], sh['library_ms'])
               if S == sizes[0] else
               "in a graph " + beside_old(name, sh['ms_in_a_graph'],
                                          sh['library_ms_in_a_graph'],
                                          loop=True))
            + f"; max_abs_err {err:.3e} over {len(lens)} length vectors "
            f"(rtol=1e-4 atol=1e-5)")
        del q, k, v
    first = shapes[sizes[0]]
    lens_txt = "full" if min(first["lengths"]) == sizes[0] else \
        first["lengths"]
    return {"name": name, "route": "cuda",
            "source": DECODE_SOURCE if G > 1 else DECODE_G1_SOURCE,
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "old_design_ms": OLD_DECODE_MS.get(name, (None,))[0],
            "shape": f"{cfg.name}{f' {what}' if what else ''} q=({B},{H},"
                     f"{dh}) cache=({B},{sizes[0]},{kvH},{dh}) bf16 (G={G}),"
                     f" lengths {lens_txt}",
            "shapes": {str(k_): v_ for k_, v_ in shapes.items()}}


def reduced_check(torch, device, counters, names, what, mesh_shape=None,
                  fields=None):
    """The reduced configs ``names`` in float32, the same port code on the
    card and on the CPU from the same parameters: ``forward`` over
    MIXER_REDUCED_B x MIXER_REDUCED_S tokens and the ``serve_step`` loop
    over the same tokens, logits within ``rtol=1e-4, atol=1e-4``; a
    second card run bit-equal; one kernel launch an attention. An enc-dec
    model's prefill encodes ENCDEC_REDUCED_SRC frames and its loop reads
    cross caches written from them (ragged lengths, one 0); an M-RoPE
    model's prefill adds patch embeddings and takes distinct streams, its
    loop the streams at each position. ``mesh_shape``: both runs over a
    ``("data", "model")`` mesh of that shape (on their own device);
    ``fields``: config fields set per name."""
    import dataclasses
    from repro_torch.dist import make_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import (encode, forward,
                                                init_decode_state,
                                                init_params, serve_step)
    from repro_torch.train.optim import tree_map

    cpu = torch.device("cpu")
    B, S = MIXER_REDUCED_B, MIXER_REDUCED_S
    out = {}
    for name in names:
        cfg = dataclasses.replace(get_reduced(name),
                                  **(fields or {}).get(name, {}))
        host_p = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
        card_p = tree_map(lambda t: t.to(device), host_p)
        toks = torch.from_numpy(lm_tokens(cfg, (B, S), 0x4D58))
        encdec = cfg.kind == "encdec"
        frames = stub_frames(torch, cfg, (B, ENCDEC_REDUCED_SRC if encdec
                                          else S), LM_SEED + 11, cpu)
        streams = mrope_streams(torch, B, S, cpu)
        x_len = (ENCDEC_REDUCED_SRC - 5 * torch.arange(B)).to(torch.int32)
        x_len[B // 2] = 0

        def run(dev, params):
            t = toks.to(dev)
            mesh = (make_mesh(mesh_shape, ("data", "model"), device=dev)
                    if mesh_shape else None)
            with torch.inference_mode():
                kw, states = {}, None
                if encdec:
                    enc = encode(cfg, params, frames.to(dev))
                    kw = {"enc_out": enc}
                    states = cross_caches(torch, cfg, params, enc,
                                          x_len.to(dev))(S)
                elif cfg.frontend == "vision":
                    kw = {"embeds": frames.to(dev),
                          "mrope_positions": streams.to(dev)}
                full = forward(cfg, params, t, mesh=mesh, **kw)
                states = states or init_decode_state(cfg, B, S, device=dev)
                steps = []
                for i in range(S - 1):
                    lg, states = serve_step(
                        cfg, params, states, t[:, i:i + 1],
                        torch.full((B,), i, dtype=torch.int32, device=dev),
                        mrope_positions=streams[:, :, i:i + 1].to(dev)
                        if cfg.mrope_sections else None, mesh=mesh)
                    steps.append(lg[:, 0])
            return full.cpu(), torch.stack(steps, 1).cpu()
        for c in counters:
            c.reset()
        card = run(device, card_p)
        launches = {c.name: c.value for c in counters}
        again = run(device, card_p)
        host = run(cpu, host_p)
        n = attn_layers(cfg) * (2 if encdec else 1)
        want = {"flash_attention": n + cfg.num_enc_layers,
                "flash_decode": (S - 1) * n}
        if launches != want:
            raise RuntimeError(f"{name} (reduced) launched {launches}, "
                               f"expected {want}")
        errs = [float((a - b).abs().max()) for a, b in zip(card, host)]
        if not all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                   for a, b in zip(card, host)):
            raise RuntimeError(f"{name} (reduced): card logits differ from "
                               f"the CPU's by {errs}")
        if not all(torch.equal(a, b) for a, b in zip(card, again)):
            raise RuntimeError(f"{name} (reduced): a second card run gave "
                               f"other logits")
        out[name] = {"prefill_max_abs_err": errs[0],
                     "decode_max_abs_err": errs[1], "launches": launches}
        log(f"{what} {name} (reduced, float32, {B}x{S}"
            f"{f', mesh {mesh_shape}' if mesh_shape else ''}"
            f"{f', {fields[name]}' if fields and fields.get(name) else ''}"
            f"{f', source {ENCDEC_REDUCED_SRC} frames' if encdec else ''}):"
            f" prefill and {S - 1} decode steps on the card within "
            f"rtol=1e-4 atol=1e-4 of the CPU (max abs err {errs[0]:.3e} / "
            f"{errs[1]:.3e}); second card run bit-equal; launches "
            f"{json.dumps(launches)}")
    return out


def mixer_phase(torch, device, counters):
    """Phase 11: (a) mamba2-1.3b, (b) recurrentgemma-9b with the G=16
    kernel rows, (c) qwen3-moe-30b-a3b with the G=8 ones, each at full
    width and depth and freed before the next, then (d) the reduced
    configs."""
    torch.cuda.empty_cache()
    out = {"held_at_start_bytes": torch.cuda.memory_allocated()}
    rows = []
    for name, seq, cut in MIXER_SERVE:
        t0 = time.perf_counter()
        cfg, params, res = mixer_serve(torch, device, name, seq, cut,
                                       counters)
        if attn_layers(cfg):
            rows.append(mixer_attention_row(
                torch, device, cfg, params, seq,
                res["prefill"]["launches"]["flash_attention"]))
            rows.append(mixer_decode_row(
                torch, device, cfg, res["decode"]["launches"]["flash_decode"]))
        if cfg.moe:
            # phase 13 (a) and (c), while the model is loaded
            res["mesh"] = mesh_serve(torch, device, cfg, params, counters,
                                     MESH_MOE, seq=seq)
            t1 = time.perf_counter()
            rows.append(mesh_decode_row(
                torch, device, cfg,
                res["mesh"]["decode"]["launches"]["flash_decode"]))
            res["mesh"]["row_wall_s"] = time.perf_counter() - t1
            log(f"mesh {name} flash_decode_sharded rows: sub-phase wall "
                f"{res['mesh']['row_wall_s']:.1f} s")
        del params
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        out[name] = res
        log(f"mixer {name}: sub-phase wall {res['wall_s']:.1f} s")
    t0 = time.perf_counter()
    out["reduced"] = reduced_check(torch, device, counters, MIXER_REDUCED,
                                   "mixer")
    out["reduced_wall_s"] = time.perf_counter() - t0
    log(f"mixer reduced configs: sub-phase wall {out['reduced_wall_s']:.1f} "
        f"s")
    return out, rows


# ---------------------------------------------------------------------------
# phase 12: decode serving of the enc-dec and M-RoPE models
# ---------------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-medium", "qwen2-vl-72b"
PHASE12_FULL = True
#: qwen2-vl-72b at full width, its 80 layers cut to 16: 80 layers are 145
#: GB of bf16 weights, which one 80 GB card cannot hold; 16 are 33.1 GB
#: (sharding over cards is ROADMAP Queue 1 item 4)
VLM_LAYERS = 16
#: frame embeddings a source: the reference's SRC_LEN
#: (``launch/specs.py``)
SRC_LEN = 4096
#: the decode loop's source lengths, one a sequence: 4096 - 97 b
SRC_STEP = 97
#: the patch grid of the M-RoPE streams: t = i, h = i // 64, w = i % 64
PATCH_GRID = 64
#: the reduced enc-dec model's source: 40 frames against 48 decoder tokens
ENCDEC_REDUCED_SRC = 40


def phase12_config(name, full: bool, dtype: str):
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    if not full:
        return dataclasses.replace(get_reduced(name), dtype=dtype)
    cfg = get_arch(name)
    if name == VLM_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=VLM_LAYERS)
    return dataclasses.replace(cfg, dtype=dtype)


def mrope_streams(torch, B: int, S: int, device):
    """(3, B, S) int32 M-RoPE streams of one image-like sequence: t = i,
    h = i // PATCH_GRID, w = i % PATCH_GRID (equal streams would make
    M-RoPE RoPE)."""
    t = torch.arange(S, dtype=torch.int32, device=device)
    return torch.stack([t, t // PATCH_GRID, t % PATCH_GRID])[:, None] \
        .expand(3, B, S).contiguous()


def stub_frames(torch, cfg, shape, seed: int, device):
    """The frontend stubs' (frame or patch) embeddings: 0.02 x normal,
    float32, as the reference's data pipeline makes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.02 * torch.randn((*shape, cfg.d_model), generator=gen,
                              device=device)


def cross_caches(torch, cfg, params, enc_out, x_len):
    """-> states(max_len): a fresh decode state whose cross caches hold
    each decoder layer's ``enc_out @ xattn.wk/wv`` (R, B, S_src, kvH, dh)
    and ``x_len`` (R, B), written as a caller writes them (the reference
    leaves them to its caller too)."""
    from repro_torch.models.transformer import init_decode_state

    B, S_src = enc_out.shape[:2]
    xp = params["blocks"][0]["xattn"]
    shape = (B, S_src, cfg.num_kv_heads, cfg.head_dim)
    with torch.inference_mode():
        xk = torch.stack([(enc_out @ w).reshape(shape) for w in xp["wk"]])
        xv = torch.stack([(enc_out @ w).reshape(shape) for w in xp["wv"]])
    xl = x_len.to(torch.int32).expand(cfg.num_repeats, B).contiguous()

    def states(max_len):
        st = init_decode_state(cfg, B, max_len, device=enc_out.device)
        st["scan"][0].update(xk=xk, xv=xv, x_len=xl)
        return st
    return states


def model_line(torch, cfg, params, t0, cut):
    n = sum(t.numel() for t in _leaves(params))
    log(f"model {cfg.name}: {cfg.kind} {cfg.num_layers} layers"
        f"{f' + {cfg.num_enc_layers} encoder' if cfg.num_enc_layers else ''}"
        f" d={cfg.d_model} H={cfg.num_heads} kvH={cfg.num_kv_heads} "
        f"dh={cfg.head_dim} vocab={cfg.vocab_size} frontend "
        f"{cfg.frontend!r} mrope {cfg.mrope_sections} {cfg.dtype}: "
        f"{n / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) "
        f"from seed {LM_SEED} in {time.perf_counter() - t0:.2f} s; {cut}")
    return n


def encdec_serve(torch, device, counters):
    """(a) seamless-m4t-medium at full width and depth: ``encode`` of
    SRC_LEN frames and ``forward`` with ``enc_out`` at S=PREFILL_S (one
    ``flash_attention`` an encoder layer, a decoder layer and a
    cross-attention); the greedy loop against cross caches filled from 8
    encoded sources with ragged lengths (two ``flash_decode`` a decoder
    layer a step), and once more against the launcher's empty caches
    (``x_len = 0``), whose logits must equal, bit for bit, a run with
    no cross caches at all. Also returns the inputs of the first
    attention layer's row: none, it is the decoder's self-attention."""
    import numpy as np
    from repro_torch.launch.serve_decode import greedy_decode
    from repro_torch.models.transformer import (encode, init_decode_state,
                                                init_params)

    cfg = phase12_config(ENCDEC_ARCH, PHASE12_FULL, "bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    n = model_line(torch, cfg, params, t0, f"prefill_32k cut to B=1 "
                   f"S={PREFILL_S} over a source of {SRC_LEN} frames")
    src = stub_frames(torch, cfg, (1, SRC_LEN), LM_SEED + 6, device)
    layers = attn_layers(cfg)
    prefill = prefill_phase(
        torch, device, cfg, params, counters,
        inputs=lambda: {"enc_out": encode(cfg, params, src)},
        expect=cfg.num_enc_layers + 2 * layers)
    del src
    with torch.inference_mode():
        enc = encode(cfg, params, stub_frames(
            torch, cfg, (DECODE_B, SRC_LEN), LM_SEED + 7, device))
    x_len = SRC_LEN - SRC_STEP * torch.arange(DECODE_B, device=device)
    states = cross_caches(torch, cfg, params, enc, x_len)
    del enc
    decode = decode_phase(torch, device, cfg, params, counters, host=False,
                          trace_steps=MIXER_TRACE_STEPS, states=states,
                          per_step=2 * layers)
    del states
    # the launcher's empty caches (x_len = 0) against no cross caches
    prompts = lm_tokens(cfg, (DECODE_B, DECODE_PROMPT), 0x4443)
    steps = DECODE_PROMPT + DECODE_GEN - 1
    for c in counters:
        c.reset()
    toks, empty_s, logits = greedy_decode(cfg, params, prompts, DECODE_GEN,
                                          device)
    launches = {c.name: c.value for c in counters}

    def bare(max_len):
        st = init_decode_state(cfg, DECODE_B, max_len, device=device)
        for k in ("xk", "xv", "x_len"):
            del st["scan"][0][k]
        return st
    toks2, _, logits2 = greedy_decode(cfg, params, prompts, DECODE_GEN,
                                      device, bare(DECODE_PROMPT
                                                   + DECODE_GEN))
    if launches != {"flash_attention": 0, "flash_decode": 2 * layers * steps}:
        raise RuntimeError(f"decode with empty cross caches launched "
                           f"{launches}")
    if not np.array_equal(toks, toks2) or not all(
            torch.equal(a, b) for a, b in zip(logits, logits2)) or \
            not all(bool(torch.isfinite(x).all()) for x in logits):
        raise RuntimeError("cross-attention over empty caches (x_len = 0) "
                           "did not add exactly 0")
    del logits, logits2
    empty = {"ms_per_step": 1e3 * empty_s / steps, "launches": launches}
    log(f"decode {cfg.name} over empty cross caches (x_len = 0, the "
        f"launcher's): {empty['ms_per_step']:.2f} ms/step, launches "
        f"{json.dumps(launches)}; tokens and every step's logits bit-equal "
        f"to a run without cross caches (the cross-attention adds exactly "
        f"0)")
    return cfg, params, {"parameters": n, "prefill": prefill,
                         "decode": decode, "decode_empty_cross": empty,
                         "x_len": x_len.tolist()}, {}


def vlm_serve(torch, device, counters):
    """(b) qwen2-vl-72b at full width, VLM_LAYERS layers: ``forward`` at
    S=PREFILL_S with patch embeddings and distinct M-RoPE streams (one
    ``flash_attention`` a layer), and the launcher's greedy loop (the
    position on all three streams; one ``flash_decode`` a layer a
    step). Also returns the prefill's inputs."""
    from repro_torch.models.transformer import init_params

    cfg = phase12_config(VLM_ARCH, PHASE12_FULL, "bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    n = model_line(torch, cfg, params, t0, f"80 layers cut to {VLM_LAYERS} "
                   f"(145 GB of weights do not fit one card); prefill_32k "
                   f"cut to B=1 S={PREFILL_S}")
    inputs = {"embeds": stub_frames(torch, cfg, (1, PREFILL_S), LM_SEED + 8,
                                    device),
              "mrope_positions": mrope_streams(torch, 1, PREFILL_S, device)}
    prefill = prefill_phase(torch, device, cfg, params, counters,
                            inputs=lambda: inputs)
    decode = decode_phase(torch, device, cfg, params, counters, host=False,
                          trace_steps=MIXER_TRACE_STEPS)
    return cfg, params, {"parameters": n, "prefill": prefill,
                         "decode": decode,
                         "cut": f"num_layers 80 -> {VLM_LAYERS}"}, inputs


def encdec_vlm_phase(torch, device, counters):
    """Phase 12: (a) seamless-m4t-medium and (b) qwen2-vl-72b, each with
    ``mixer_attention_row`` on its first attention layer (seamless's
    causal decoder self-attention, qwen2-vl's after M-RoPE) and
    ``mixer_decode_row`` over a PREFILL_S cache and the loop's, and freed
    before the next; then seamless's encoder (no mask, Sq == Skv) and
    cross shapes (Sq = PREFILL_S over SRC_LEN keys, and a ragged SRC_LEN -
    95) on seeded random q/k/v and its cross decode over SRC_LEN
    positions at the loop's ragged lengths, full ones and ones with a 0;
    then (c) the reduced configs."""
    torch.cuda.empty_cache()
    out = {"held_at_start_bytes": torch.cuda.memory_allocated()}
    rows, launches = [], {}
    for key, serve_fn, suffix in (("encdec", encdec_serve, ("", "_self")),
                                  ("vlm", vlm_serve,
                                   (f"_s{PREFILL_S}", "_h64"))):
        t0 = time.perf_counter()
        cfg, params, res, inputs = serve_fn(torch, device, counters)
        G = cfg.num_heads // cfg.num_kv_heads
        launches[key] = cfg, res["prefill"]["launches"]["flash_attention"], \
            res["decode"]["launches"]["flash_decode"]
        rows.append(mixer_attention_row(
            torch, device, cfg, params, PREFILL_S, launches[key][1],
            name=f"flash_attention_g{G}{suffix[0]}", **inputs))
        rows.append(mixer_decode_row(
            torch, device, cfg, launches[key][2], full_s=PREFILL_S,
            name=f"flash_decode_g{G}{suffix[1]}", what="self"))
        del params, inputs
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        out[cfg.name] = res
        log(f"model {cfg.name}: sub-phase wall {res['wall_s']:.1f} s")
    t0 = time.perf_counter()
    cfg, prefill_n, decode_n = launches["encdec"]
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 10)

    def rand(S, heads):
        return torch.randn((1, S, heads, cfg.head_dim), generator=gen,
                           device=device, dtype=torch.bfloat16)
    H, kvH = cfg.num_heads, cfg.num_kv_heads
    k, v = rand(SRC_LEN, kvH), rand(SRC_LEN, kvH)
    rows.append(attention_row(
        torch, device, "flash_attention_g1_encoder", f"{cfg.name} encoder",
        rand(SRC_LEN, H), k, v, prefill_n, causal=False))
    rows.append(attention_row(
        torch, device, "flash_attention_cross", f"{cfg.name} cross",
        rand(PREFILL_S, H), k, v, prefill_n, causal=False,
        ragged_skv=SRC_LEN - 95))
    del k, v
    x_len = (SRC_LEN - SRC_STEP * torch.arange(DECODE_B, device=device)).to(
        torch.int32)
    with_zero = x_len.clone()
    with_zero[DECODE_B // 2] = 0
    rows.append(mixer_decode_row(
        torch, device, cfg, decode_n, full_s=SRC_LEN, loop=False,
        lengths=lambda S: [x_len, torch.full_like(x_len, S), with_zero],
        name="flash_decode_g1", what="cross"))
    out["rows_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["reduced"] = reduced_check(torch, device, counters,
                                   (ENCDEC_ARCH, VLM_ARCH), "model")
    out["reduced_wall_s"] = time.perf_counter() - t0
    log(f"phase 12 seamless encoder/cross rows: wall {out['rows_wall_s']:.1f}"
        f" s; reduced configs: wall {out['reduced_wall_s']:.1f} s")
    return out, rows


# ---------------------------------------------------------------------------
# phase 13: the ("data", "model") mesh: sequence-sharded decode attention,
# expert-parallel MoE, and their process-group forms
# ---------------------------------------------------------------------------

#: (a) qwen3-moe-30b-a3b over 2 data groups of 2 model shards (its prefill
#: at B=1, S=4096 is two groups of 2048 tokens); (b) gemma2-2b's caches
#: over 4 model shards
MESH_MOE, MESH_GEMMA = (2, 2), (1, 4)
#: decode steps traced over the mesh, from a one-token prompt (the traced
#: loop's cache of 1 + steps slots splits over every tp here)
MESH_TRACE_STEPS = 3
#: (c) the sharded kernel row's model shards over qwen3-moe's long cache
MESH_ROW_TP = 4
#: (d) two ranks of a gloo group on the card: token counts of the MoE
#: layer, the inputs' seed, and a time limit on the ranks
MESH_PG_TOKENS = (8, 4096)
MESH_PG_SEED = LM_SEED + 13
MESH_PG_TIMEOUT_S = 300
#: (e) the reduced configs (float32, 8 x 48) over the (2, 2) mesh;
#: qwen3-moe at capacity factor 1.0, so tokens are dropped
MESH_REDUCED = {"qwen3-moe-30b-a3b": {"capacity_factor": 1.0},
                "arctic-480b": {}, "gemma2-2b": {}}


def expert_bytes(cfg) -> int:
    """The bytes of every expert's weights, all MoE layers."""
    per = cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff * 2
    return per * sum(k != "ssm" for k in cfg.pattern) * cfg.num_repeats


def mesh_serve(torch, device, cfg, params, counters, shape, seq=None):
    """(a)/(b) the loaded model over a ``("data", "model")`` mesh of
    ``shape``: with ``seq``, ``prefill_phase`` at B=1, S=``seq`` (its
    last position's logits beside the unsharded run's); the greedy loop
    of ``decode_phase`` (one ``flash_decode`` a layer a step, a second run
    bit-equal, MESH_TRACE_STEPS steps traced); the logits of the prompt's
    steps, fed alike, beside the unsharded steps' (the first step's
    single valid slot lies in shard 0, so its attention is exact). The
    two differ by design: each data group is routed alone, with its own
    capacity, and the sums run in another order."""
    from repro_torch.dist import make_mesh
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                serve_step)

    t0 = time.perf_counter()
    mesh = make_mesh(shape, ("data", "model"), device=device)
    out = {"mesh": mesh.shape}
    with torch.inference_mode():
        if seq:
            out["prefill"] = prefill_phase(torch, device, cfg, params,
                                           counters, seq=seq, mesh=mesh)
            toks = torch.from_numpy(lm_tokens(cfg, (1, seq), 0x5046)).to(
                device)
            last = [forward(cfg, params, toks, mesh=m)[0, -1]
                    for m in (None, mesh)]
            out["prefill_last_max_abs_diff"] = float(
                (last[0] - last[1]).abs().max())
            del last
        out["decode"] = decode_phase(torch, device, cfg, params, counters,
                                     host=False,
                                     trace_steps=MESH_TRACE_STEPS, mesh=mesh)
        prompts = torch.from_numpy(lm_tokens(
            cfg, (DECODE_B, DECODE_PROMPT), 0x4443)).to(device)
        runs = []
        for m in (None, mesh):
            st = init_decode_state(cfg, DECODE_B, DECODE_PROMPT + DECODE_GEN,
                                   device=device)
            runs.append(torch.stack([serve_step(
                cfg, params, st, prompts[:, t:t + 1],
                torch.full((DECODE_B,), t, dtype=torch.int32,
                           device=device), mesh=m)[0][:, 0]
                for t in range(DECODE_PROMPT)]))
            del st
    diff = (runs[0] - runs[1]).abs().amax(dim=(1, 2)).tolist()
    del runs
    out["first_step_max_abs_diff"] = diff[0]
    out["prompt_steps_max_abs_diff"] = diff
    txt = ""
    if cfg.moe:
        dp = shape[0] if DECODE_B % shape[0] == 0 else 1
        nbytes = expert_bytes(cfg)
        out["expert_bytes_per_step"] = dp * nbytes
        txt = (f"; the expert products read every expert once a data "
               f"group: {dp} x {nbytes / 1e9:.2f} GB a decode step "
               f"({1e3 * dp * nbytes / MEM_BYTES_PER_S:.1f} ms at "
               f"{MEM_BYTES_PER_S / 1e12:.2f} TB/s, against "
               f"{1e3 * nbytes / MEM_BYTES_PER_S:.1f} unsharded)")
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh {cfg.name} over {json.dumps(mesh.shape)}: "
        + (f"prefill last position's logits max |diff| from the unsharded "
           f"run {out['prefill_last_max_abs_diff']:.4g}; " if seq else "")
        + f"first decode step's logits max |diff| from the unsharded step "
        f"{diff[0]:.4g}, over the {DECODE_PROMPT} prompt steps (fed alike) "
        f"up to {max(diff):.4g} (per-group capacity and the order of sums "
        f"differ by design){txt}; sub-phase wall "
        f"{out['wall_s']:.1f} s")
    return out


def mesh_decode_row(torch, device, cfg, launches):
    """(c) ``sharded_decode_attention`` at tp = MESH_ROW_TP over a cache as
    long as qwen3-moe-30b-a3b's prefill (full lengths timed; ragged ones
    whose later shards hold no valid slot checked) and over the decode
    loop's: one ``flash_decode`` launch over the folded (B * tp, S / tp)
    rows plus the combine. The folded partials against their plain
    version (float32, ``rtol=1e-4, atol=1e-5``); the bfloat16 output
    against the plain version of the same sharded call and the plain
    unsharded attention (one bfloat16 step, ``rtol=2^-7, atol=1e-5``).
    Timed beside the folded launch alone, the unsharded call, the plain
    version, SDPA and the byte bound."""
    import torch.nn.functional as F
    from repro_torch.dist import make_mesh
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.flash_decode import split_plan
    from repro_torch.kernels.flash_decode.ref import (flash_decode_batched_ref,
                                                      finalize)
    from repro_torch.serve import sharded_decode_attention

    tp = MESH_ROW_TP
    mesh = make_mesh((1, tp), ("data", "model"), device=device)
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 5)
    B, H, kvH, dh = DECODE_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf = dict(dtype=torch.bfloat16, device=device, generator=gen)
    shapes = {}
    for S in (MIXER_DECODE_CACHE[cfg.name], DECODE_PROMPT + DECODE_GEN):
        q = torch.randn((B, 1, H, dh), **bf)
        k, v = (torch.randn((B, S, kvH, dh), **bf) for _ in range(2))
        full = torch.full((B,), S, dtype=torch.int32, device=device)
        s = S // tp
        ragged = torch.tensor([1, s, s + 1, S, 3 * s - 1, 17, S - 1, S // 2],
                              dtype=torch.int32, device=device)[:B]
        err = 0.0
        for ln in (full, ragged):
            lf = (ln[:, None] - torch.arange(tp, device=device)[None, :]
                  * s).clamp(0, s).reshape(-1).to(torch.int32)
            qf = q[:, 0].repeat_interleave(tp, dim=0)
            kf, vf = (t.reshape(B * tp, s, kvH, dh) for t in (k, v))
            got = fd_ops.flash_decode_partials(qf, kf, vf, lf)
            want = flash_decode_batched_ref(qf, kf, vf, lf)
            if not all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                       for a, b in zip(got, want)) or \
                    not bool((got[1][lf == 0] == -1e30).all()) or \
                    not bool((got[2][lf == 0] == 0).all()):
                raise RuntimeError(f"flash_decode folded partials differ "
                                   f"from their plain version at S={S}")
            out = sharded_decode_attention(mesh, q, k, v, ln).float()
            plain = sharded_decode_attention(mesh, q, k, v, ln,
                                             interpret=True).float()
            acc, _, l = flash_decode_batched_ref(q[:, 0], k, v, ln)
            whole = finalize(acc, l)[:, None].to(q.dtype).float()
            err = max(err, float((out - plain).abs().max()),
                      float((out - whole).abs().max()))
            if not (torch.allclose(out, plain, rtol=2 ** -7, atol=1e-5)
                    and torch.allclose(out, whole, rtol=2 ** -7,
                                       atol=1e-5)):
                raise RuntimeError(f"sharded_decode_attention at S={S} "
                                   f"differs from its plain version: {err}")
        qf = q[:, 0].repeat_interleave(tp, dim=0)
        kf, vf = (t.reshape(B * tp, s, kvH, dh) for t in (k, v))
        lf = torch.full((B * tp,), s, dtype=torch.int32, device=device)

        def kern():
            return sharded_decode_attention(mesh, q, k, v, full)

        def folded():
            return fd_ops.flash_decode_partials(qf, kf, vf, lf)

        def whole_call():
            return fd_ops.flash_decode_batched(q[:, 0], k, v, full)

        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - kern().float())
                        .abs().max())
        if lib_err > 0.05:
            raise RuntimeError(f"SDPA yardstick (sharded decode) computes "
                               f"another function: {lib_err}")
        before = fd_ops.LAUNCHES.value
        kern()
        if fd_ops.LAUNCHES.value - before != 1:
            raise RuntimeError(f"sharded_decode_attention launched "
                               f"{fd_ops.LAUNCHES.value - before} kernels "
                               f"a call")
        ops = device_ops(torch, kern)
        nbytes = 2 * B * S * kvH * dh * 2 + 2 * q.numel() * 2
        bound = bound_ms(nbytes, 4 * dh * H * B * S, BF16_FLOPS_PER_S)
        shapes[S] = {
            "cache": [B, S, kvH, dh], "tp": tp, "max_abs_err": err,
            "device_ops": len(ops), "ops": ops,
            "splits": {"folded": split_plan(B * tp, s, H, kvH, dh,
                                            q.dtype, device),
                       "unsharded": split_plan(B, S, H, kvH, dh, q.dtype,
                                               device)},
            "ms": device_ms(torch, kern),
            "ms_in_a_graph": device_ms_per_call(torch, kern),
            "folded_launch_ms": device_ms(torch, folded),
            "folded_launch_ms_in_a_graph": device_ms_per_call(torch, folded),
            "unsharded_ms": device_ms(torch, whole_call),
            "unsharded_ms_in_a_graph": device_ms_per_call(torch, whole_call),
            "plain_ms": device_ms(torch, lambda: sharded_decode_attention(
                mesh, q, k, v, full, interpret=True), iters=5),
            "library_ms": device_ms(torch, sdpa),
            "library_ms_in_a_graph": device_ms_per_call(torch, sdpa),
            "library_err_no_softcap": lib_err, "bytes": nbytes,
            "bound_ms": bound[0], "bound_by": bound[1]}
        sh = shapes[S]
        log(f"flash_decode_sharded {cfg.name} q=({B},1,{H},{dh}) cache=("
            f"{B},{S},{kvH},{dh}) bf16 over tp={tp} (one launch over the "
            f"folded ({B * tp},{s},{kvH},{dh}), {sh['splits']['folded']} "
            f"splits, then the combine; {len(ops)} card ops a call: "
            f"{ops}): ms={sh['ms']:.4f} ({sh['ms_in_a_graph']:.4f} a call "
            f"in a graph of 20); the folded launch alone "
            f"{sh['folded_launch_ms']:.4f} ({sh['folded_launch_ms_in_a_graph']:.4f}"
            f" in a graph); the unsharded call {sh['unsharded_ms']:.4f} "
            f"({sh['unsharded_ms_in_a_graph']:.4f} in a graph, "
            f"{sh['splits']['unsharded']} splits; PR 22: 0.1417 at "
            f"S=4096); plain_ms={sh['plain_ms']:.4f} library_ms="
            f"{sh['library_ms']:.4f} ({sh['library_ms_in_a_graph']:.4f} in "
            f"a graph; SDPA enable_gqa over the whole cache; PR 22: 0.0311) "
            f"bound_ms={sh['bound_ms']:.5f} ({sh['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB; PR 22: 0.0201, 67.3 MB); folding "
            f"{tp}x the rows: the folded launch takes "
            f"{sh['folded_launch_ms'] / sh['unsharded_ms']:.2f}x the "
            f"unsharded call's time; the folded launch "
            + (beside_old('flash_decode_sharded', sh['folded_launch_ms'],
                          sh['library_ms'])
               if S == MIXER_DECODE_CACHE[cfg.name] else
               "in a graph " + beside_old(
                   'flash_decode_sharded',
                   sh['folded_launch_ms_in_a_graph'],
                   sh['library_ms_in_a_graph'], loop=True))
            + f"; max_abs_err {err:.3e} over full and ragged lengths "
            f"(rtol=2^-7 atol=1e-5)")
        del q, k, v, qf, kf, vf
    first = shapes[MIXER_DECODE_CACHE[cfg.name]]
    S = MIXER_DECODE_CACHE[cfg.name]
    return {"name": "flash_decode_sharded", "route": "cuda",
            "source": DECODE_SOURCE,
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "old_design_folded_launch_ms":
                OLD_DECODE_MS["flash_decode_sharded"][0],
            "shape": f"{cfg.name} q=({B},1,{H},{dh}) cache=({B},{S},{kvH},"
                     f"{dh}) bf16 over tp={tp}, lengths full",
            "shapes": {str(k_): v_ for k_, v_ in shapes.items()}}


def pg_inputs(torch, device, full: bool):
    """(d)'s inputs, drawn alike in every process from MESH_PG_SEED on
    ``device``: a query and qwen3-moe-30b-a3b's long decode cache (bf16,
    lengths whose second half holds no valid slot in some rows), one of
    its MoE layers (``full``: at full width, 128 experts) and
    MESH_PG_TOKENS tokens."""
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.models.transformer.moe import init_moe_params

    cfg = dataclasses.replace((get_arch if full else get_reduced)(
        "qwen3-moe-30b-a3b"), dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(MESH_PG_SEED)
    bf = dict(dtype=torch.bfloat16, device=device, generator=gen)
    B, S = DECODE_B, MIXER_DECODE_CACHE[cfg.name]
    q = torch.randn((B, 1, cfg.num_heads, cfg.head_dim), **bf)
    k, v = (torch.randn((B, S, cfg.num_kv_heads, cfg.head_dim), **bf)
            for _ in range(2))
    ln = torch.tensor([S, 1, S // 2, S // 2 + 1, 3 * S // 4, 17, S - 1,
                       S // 3][:B], dtype=torch.int32, device=device)
    layer = init_moe_params(cfg, gen, torch.bfloat16, device)
    xs = [torch.randn((T, cfg.d_model), **bf) for T in MESH_PG_TOKENS]
    return cfg, (q, k, v, ln), layer, xs


def pg_rank(rank: int, world: int, src: str, out_dir: str, device: str,
            full: bool) -> None:
    """One rank of (d): model rank ``rank`` of ``world`` over gloo (NCCL
    takes one card a rank), on tensors of the one ``device``. It holds
    cache slots ``[rank * S/2, (rank + 1) * S/2)`` and experts ``[rank *
    E/2, (rank + 1) * E/2)``, runs ``sharded_decode_shard`` and
    ``moe_shard`` at each token count and saves its outputs."""
    sys.path.insert(0, src)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from repro_torch.models.transformer.moe import moe_shard
    from repro_torch.serve import sharded_decode_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        cfg, (q, k, v, ln), layer, xs = pg_inputs(torch, device, full)
        s = k.shape[1] // world
        mine = slice(rank * s, (rank + 1) * s)
        dec = sharded_decode_shard(q, k[:, mine].contiguous(),
                                   v[:, mine].contiguous(), ln, rank=rank,
                                   tp=world)
        n = cfg.num_experts // world
        local = {"router": layer["router"]}
        local.update({w: layer[w][rank * n:(rank + 1) * n].clone()
                      for w in ("w1", "w2", "w3")})
        del layer
        moes = [moe_shard(local, x, cfg, rank=rank, tp=world) for x in xs]
        torch.save({"decode": dec.cpu(), "moe": [m.cpu() for m in moes]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def process_group_check(torch, device):
    """(d) two ranks of a ``torch.distributed`` gloo group on the one card
    (``torch.multiprocessing`` spawn, a ``FileStore``): each rank's
    ``sharded_decode_shard`` and ``moe_shard`` against the in-process
    ``sharded_decode_attention`` and ``moe_apply`` at (1, 2) on the same
    inputs, bit for bit (every cross-rank sum has two terms). An op or
    dtype that gloo refuses on CUDA tensors fails the phase."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.dist import make_mesh
    from repro_torch.kernels.flash_decode.flash_decode import split_plan
    from repro_torch.models.transformer.moe import moe_apply
    from repro_torch.serve import sharded_decode_attention

    world = 2
    out_dir = os.path.join(HERE, "build", "mesh_pg")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    ctx = mp.start_processes(pg_rank, args=(world, os.path.join(HERE, "src"),
                                            out_dir, str(device),
                                            MIXER_FULL),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + MESH_PG_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {world} gloo ranks did not finish "
                                   f"in {MESH_PG_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    ranks_s = time.perf_counter() - t0
    cfg, (q, k, v, ln), layer, xs = pg_inputs(torch, device, MIXER_FULL)
    mesh = make_mesh((1, world), ("data", "model"), device=device)
    with torch.inference_mode():
        dec = sharded_decode_attention(mesh, q, k, v, ln).cpu()
        moes = [moe_apply(layer, x[None], cfg, mesh=mesh)[0].cpu()
                for x in xs]
    B, S = k.shape[:2]
    n = cfg.num_experts // world
    # a rank plans its launch for the folded batch, as the in-process
    # form launches it
    splits = split_plan(B * world, S // world, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim, k.dtype, device)
    del layer, q, k, v, xs
    for r in range(world):
        got = torch.load(os.path.join(out_dir, f"rank{r}.pt"))
        if not torch.equal(got["decode"], dec):
            raise RuntimeError(f"rank {r}'s sharded_decode_shard differs "
                               f"from sharded_decode_attention by "
                               f"{float((got['decode'] - dec).float().abs().max())}"
                               f" (split plan {splits})")
        for T, a, b in zip(MESH_PG_TOKENS, got["moe"], moes):
            if not torch.equal(a, b):
                raise RuntimeError(f"rank {r}'s moe_shard at T={T} differs "
                                   f"from moe_apply by "
                                   f"{float((a - b).float().abs().max())}")
    shutil.rmtree(out_dir, ignore_errors=True)
    out = {"ranks": world, "backend": "gloo", "ranks_wall_s": ranks_s,
           "decode_cache": [B, S, cfg.num_kv_heads, cfg.head_dim],
           "split_plan": splits, "moe_tokens": list(MESH_PG_TOKENS),
           "wall_s": time.perf_counter() - t0}
    log(f"mesh process group: {world} gloo ranks on the one card (NCCL "
        f"takes one card a rank), FileStore: sharded_decode_shard over "
        f"cache ({B},{S},{cfg.num_kv_heads},{cfg.head_dim}) bf16 split in "
        f"two ({splits} splits, a rank's launch planned for the folded "
        f"batch) and "
        f"moe_shard of one {'full-width' if MIXER_FULL else 'reduced'} "
        f"qwen3-moe-30b-a3b layer (experts {n} + {n}) at "
        f"T={list(MESH_PG_TOKENS)}: every rank bit-equal to the "
        f"in-process sharded_decode_attention and moe_apply at (1, 2); "
        f"ranks {ranks_s:.1f} s, sub-phase wall {out['wall_s']:.1f} s")
    return out


def mesh_phase(torch, device, counters):
    """Phase 13 (d) and (e), after phase 12's parameters are freed; (a)-(c)
    ran inside phases 6 and 11, while their models were loaded."""
    torch.cuda.empty_cache()
    out = {"process_group": process_group_check(torch, device)}
    t0 = time.perf_counter()
    out["reduced"] = reduced_check(torch, device, counters,
                                   tuple(MESH_REDUCED), "mesh",
                                   mesh_shape=MESH_MOE, fields=MESH_REDUCED)
    out["reduced_wall_s"] = time.perf_counter() - t0
    log(f"mesh reduced configs: sub-phase wall {out['reduced_wall_s']:.1f} "
        f"s")
    return out


# ---------------------------------------------------------------------------
# phase 14: the dry-run matrix, its accounting against the card, and the
# GNN's rank 0 of 256 and of 512 on a fake process group
# ---------------------------------------------------------------------------

#: (arch, shape, S, B) of (b): combinations one card holds, on a (1, 1) mesh
DRYRUN_CARD = (("gemma2-2b", "prefill_32k", 8192, 1),
               ("qwen3-moe-30b-a3b", "decode_32k", 4096, 8),
               ("granite-3-2b", "train_4k", 4096, 1))
#: (c): the fake group's sizes, the reference's single pod and multi-pod
DRYRUN_GNN_WORKERS = (256, 512)
#: the archs whose in-process experts take most of the matrix's trace
DRYRUN_HEAVY = ("qwen3-moe-30b-a3b", "arctic-480b")


def dryrun_matrix(torch, device):
    """(a) ``run_one`` of all 10 archs x 4 shapes on the 16x16 and the
    2x16x16 mesh, shape only, in one spawned process a CPU core. FLOPs
    from traces at 0 and 1 repeats of the pattern, extrapolated exactly
    (the CPU tests hold it equal to the whole trace); the whole trace of an MoE arch over 256 in-process routings a
    layer takes minutes. Gate: this process's ``memory_allocated`` is
    unchanged across the matrix and no process that traced a
    combination initialised CUDA."""
    from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES
    from repro_torch.launch.dryrun import run_matrix, summary

    combos = [(a, s, mp) for mp in (False, True) for a in ARCH_NAMES
              for s in INPUT_SHAPES]
    combos.sort(key=lambda c: (c[0] not in DRYRUN_HEAVY,
                               c[1] != "train_4k", not c[2]))
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    recs = run_matrix(combos, jobs=os.cpu_count() or 1)
    wall = time.perf_counter() - t0
    after = torch.cuda.memory_allocated(device)
    if after != before or any(r["cuda_initialized"] for r in recs):
        raise RuntimeError(f"dry-run matrix touched the card: "
                           f"memory_allocated {before} -> {after}")
    recs.sort(key=lambda r: (r["mesh"], ARCH_NAMES.index(r["arch"]),
                             list(INPUT_SHAPES).index(r["shape"])))
    for r in recs:
        log("dryrun " + summary(r))
    misfits = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in recs
               if not r["fits_hbm"]]
    log(f"dryrun matrix: {len(recs)} combinations ({len(ARCH_NAMES)} "
        f"archs x {len(INPUT_SHAPES)} shapes x 2 meshes) in {wall:.1f} s "
        f"on {os.cpu_count()} processes; "
        f"memory_allocated {before} -> {after} (unchanged), CUDA never "
        f"initialised by a trace; not fitting 80 GB a card (computed): "
        f"{misfits}")
    return {"records": recs, "wall_s": wall, "misfits": misfits}


def _requested_bytes(torch, device) -> int:
    return torch.cuda.memory_stats(device)["requested_bytes.all.current"]


def dryrun_card(torch, device, counters):
    """(b) combinations one card holds, on a (1, 1) mesh: the spec's
    inputs made on the card (``materialize``) must grow the bytes asked
    of the allocator by ``argument_size_bytes`` exactly. Unsharded, that
    shows only that ``materialize`` allocates what the shape-only leaves
    declare (the sharding arithmetic is held to the reference's compiled
    argument sizes on the CPU); ``memory_allocated``'s growth is
    printed beside it. Then one step, its peak above the inputs beside
    the dry-run's null temp, and its launches."""
    import gc

    from repro_torch.dist.mesh import make_mesh
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.specs import make_dryrun_spec, materialize

    mesh = make_mesh((1,), ("data",), device)
    out = []
    for arch, shape, S, B in DRYRUN_CARD:
        spec = make_dryrun_spec(arch, shape, mesh, S=S, B=B)
        want = argument_bytes(spec, mesh)
        leaves = sum(1 for _ in _leaves(list(spec.args)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        a0, r0 = (torch.cuda.memory_allocated(device),
                  _requested_bytes(torch, device))
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        args = materialize(list(spec.args), device, gen)
        torch.cuda.synchronize(device)
        grown = torch.cuda.memory_allocated(device) - a0
        asked = _requested_bytes(torch, device) - r0
        if asked != want or not want <= grown:
            raise RuntimeError(
                f"dryrun card {arch}/{shape}: inputs asked {asked} B, "
                f"allocated {grown} B, argument_size_bytes {want} B")
        for c in counters:
            c.reset()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        res = spec.fn(*args)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(device) - base
        launches = {c.name: c.value for c in counters}
        first = res[0] if isinstance(res, tuple) else res
        if spec.meta["kind"] == "train":
            first = res[2]
        if not bool(torch.isfinite(first.float()).all()):
            raise RuntimeError(f"dryrun card {arch}/{shape}: non-finite "
                               f"output")
        row = {"arch": arch, "shape": shape, "S": S, "B": B,
               "argument_size_bytes": want, "requested_growth": asked,
               "allocated_growth": grown, "leaves": leaves,
               "step_ms": ms,
               "peak_above_inputs_bytes": peak, "temp_size_bytes": None,
               "launches": launches}
        log(f"dryrun card {arch} {shape} S={S} B={B} mesh (1, 1): inputs "
            f"{want} B = argument_size_bytes exactly (asked of the "
            f"allocator by materialize; unsharded, so not a check of "
            f"the sharding arithmetic); memory_allocated grew {grown} B, "
            f"{grown - want} B above over {leaves} leaves; one step "
            f"{ms:.1f} ms, peak {peak / 2**30:.3f} GiB above the inputs "
            f"(the dry-run's temp_size_bytes: null), launches "
            f"{json.dumps(launches)}")
        out.append(row)
        del args, res, first
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_gnn_phase():
    """(c) ``launch.dryrun_gnn``: rank 0 of a fake group of 256, then of
    512, in one process of its own (the fake group must not meet phase
    13's gloo groups). Gates: finite loss, the two timed runs equal in
    counted collectives and launches, the fused assembly and both
    ``gather_agg`` kernels launched."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out_dir = os.path.join(OUT_DIR, "dryrun_torch")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_gnn", "--workers",
         *map(str, DRYRUN_GNN_WORKERS), "--out", out_dir],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"dryrun_gnn failed:\n{p.stdout[-3000:]}\n"
                           f"{p.stderr[-3000:]}")
    wall = time.perf_counter() - t0
    out = {"process_wall_s": wall}
    for P in DRYRUN_GNN_WORKERS:
        with open(os.path.join(out_dir, f"rapidgnn_gnn__w{P}.json")) as f:
            rec = json.load(f)
        col, ln = rec["collectives"], rec["launches"]
        if not (math.isfinite(rec["loss"]) and rec["rerun_equal"]
                and ln["assemble"] > 0 and ln["gather_agg"] > 0
                and ln["gather_agg_bwd"] > 0
                and col["counts"]["all-to-all"] == 2
                and col["counts"]["all-reduce"] == 1):
            raise RuntimeError(f"dryrun_gnn --workers {P}: gates failed: "
                               f"{json.dumps(rec)[:2000]}")
        log(f"dryrun_gnn rank 0 of {P} (fake group, on the card): "
            f"collectives {json.dumps({k: col[k] for k in ('all-to-all', 'all-reduce', 'total')})} "
            f"B, calls {json.dumps(col['counts'])}; per-worker arguments "
            f"{rec['memory']['argument_size_bytes'] / 2**20:.1f} MiB, peak "
            f"{rec['memory']['peak_above_inputs_bytes'] / 2**20:.1f} MiB "
            f"above them; step ms {[round(t, 3) for t in rec['step_ms']]} "
            f"(a synthetic query mix); "
            f"launches {json.dumps(ln)}; loss {rec['loss']:.6f}; second "
            f"run equal in counted bytes and launches; {rec['wall_s']:.1f} "
            f"s")
        out[P] = rec
    log(f"dryrun_gnn process: {wall:.1f} s")
    return out


def dryrun_phase(torch, device, card_counters):
    """Phase 14, last: (a) the matrix, (b) the accounting against the
    card, (c) the GNN's rank 0."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"matrix": dryrun_matrix(torch, device)}
    out["card"] = dryrun_card(torch, device, card_counters)
    out["gnn"] = dryrun_gnn_phase()
    out["wall_s"] = time.perf_counter() - t0
    log(f"dryrun phase wall {out['wall_s']:.1f} s (matrix "
        f"{out['matrix']['wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 15: the paper's configurations the card had not run
# ---------------------------------------------------------------------------

#: (a) the training launcher's own settings (``launch/train.py`` ``main``:
#: 4 metis parts, batch 1000, 3 epochs, n_hot 4096, Q 4, seed 42, hidden
#: 256, fan-outs (25, 10) for both models, the ``device`` compiler by
#: default): (dataset, model, system, schedule compiler)
LAUNCHER_RUNS = (
    ("ogbn_products_sim", "sage", "rapidgnn", "numpy"),
    ("ogbn_products_sim", "sage", "rapidgnn", "device"),
    ("ogbn_products_sim", "sage", "baseline", "device"),
    ("ogbn_products_sim", "gcn", "rapidgnn", "device"),
    ("ogbn_papers_sim", "sage", "rapidgnn", "device"))
LAUNCHER_EPOCHS = 3
#: (b) ``full_grid()``'s host scenario at this dataset and batch, its 2
#: epochs cut to GRID_EPOCHS
GRID_DATASET, GRID_BATCH, GRID_EPOCHS = "ogbn_products_sim", 100, 1
#: (c) the paper's scaling axis: SCALE_PARTS workers on one card
SCALE_PARTS, SCALE_LAYOUT = 8, "2x4"
#: (d) one ``serve_step`` at the last position of ``long_500k``
LONG_ARCHS = ("gemma2-2b", "granite-3-2b")
LONG_SEED = LM_SEED + 15
#: the whole step's bf16 logits against the step through the plain
#: version: a relative perturbation of 1e-7 to 1e-4 of every attention
#: output moves the logits of a 26- or 40-layer bf16 model by 1.2-5 % of
#: their largest (bf16 rounding of the residual stream, whatever the
#: perturbation's size), dropping 1/64 of the keys by 17-43 %
#: (``tools/bf16_logit_floor.py``); each layer's attention is held to
#: phase 6's ``rtol=1e-4, atol=1e-5`` on its own inputs besides
LONG_LOGIT_SHARE = 0.125


def launcher_exp(dataset: str, model: str):
    """The launcher's settings as a ``GNNExperimentConfig``."""
    import dataclasses
    from repro_torch.configs.rapidgnn_paper import sage
    return dataclasses.replace(
        sage(dataset, TRAIN_BATCH, workers=PARTS, epochs=LAUNCHER_EPOCHS),
        model=model)


def fetch_counters(metrics) -> dict:
    tot = metrics.totals()
    out = {k: tot[k] for k in ("rpc_count", "remote_bytes", "hit_rate",
                               "cache_hits", "cache_misses")}
    out["miss_matrix"] = [e.cache_misses for e in metrics.epochs]
    return out


def launcher_phase(torch, device, counters):
    """(a) each LAUNCHER_RUNS configuration through the launcher's
    pipeline on the card, twice, against the same run on the CPU (the
    first CPU_LOSS_STEPS steps trained with the plain versions, the rest
    fetched alone), with the ``device`` schedule bit-equal to the numpy
    compiler's. -> (per-run records, the first batch of each dataset's
    sage run, the products device schedule's largest sort stream)."""
    import numpy as np
    from repro_torch.core import build_schedule
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import GNNConfig

    cpu = torch.device("cpu")
    worlds, refs, cpu_runs, out, batches = {}, {}, {}, {}, {}
    sort_input = None
    for dataset, model, system, compiler in LAUNCHER_RUNS:
        name = f"{dataset} {model} {system} {compiler}"
        exp = launcher_exp(dataset, model)
        if dataset not in worlds:
            t0 = time.perf_counter()
            g = load_dataset(dataset)
            pg = partition_graph(g, PARTS, exp.partition)
            worlds[dataset] = (g, pg, time.perf_counter() - t0)
            log(f"launcher world {dataset}: {g.num_nodes} nodes, "
                f"{g.num_edges} edges, d={g.feat_dim}, {g.num_classes} "
                f"classes, {PARTS} {exp.partition} parts in "
                f"{worlds[dataset][2]:.2f} s")
        g, pg, _ = worlds[dataset]
        sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                              batch_size=exp.batch_size)
        cfg = GNNConfig(kind=model, in_dim=g.feat_dim,
                        hidden_dim=exp.hidden_dim,
                        num_classes=g.num_classes,
                        num_layers=exp.num_layers,
                        fanouts=tuple(exp.fanouts), agg_backend="kernel")
        if dataset not in refs:
            t0 = time.perf_counter()
            refs[dataset] = (build_schedule(sampler, pg, compiler="batched",
                                            **schedule_kw(exp)),
                             time.perf_counter() - t0)
        ref, numpy_s = refs[dataset]

        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        if compiler == "device":
            ws, build_s, seen = build_device_schedule(torch, device, exp,
                                                      sampler, pg)
            if dataset == LAUNCHER_RUNS[0][0] and sort_input is None:
                sort_input = seen
        else:
            ws, build_s = ref, numpy_s
        sorts = next(c.value for c in counters if c.name == "seg_sort")
        hist, metrics, wall, captured, split = train_run(
            torch, device, exp, cfg, ws, pg, capture=1, system=system)
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in counters}
        peak = torch.cuda.max_memory_allocated()
        if compiler == "device":
            check_schedules_equal(ref, ws, exp.num_epochs)
        steps = sum(ws.epoch(e).num_batches for e in range(exp.num_epochs))
        if len(hist) != steps or not np.isfinite(hist).all():
            raise RuntimeError(f"launcher {name}: {len(hist)} steps of "
                               f"{steps}, losses {hist}")
        if launches["gather_agg"] == 0 or launches["gather_agg_bwd"] != \
                steps or launches["seg_sort"] != sorts or \
                (sorts == 0) == (compiler == "device") or \
                launches["search"] or launches["merge_gather"] or \
                launches["assemble"]:
            raise RuntimeError(f"launcher {name}: launches {launches} "
                               f"({sorts} seg_sort by the schedule)")
        again = train_run(torch, device, exp, cfg, ws, pg, system=system)
        if again[0] != hist:
            raise RuntimeError(f"launcher {name}: a second card run gave "
                               f"another loss curve")
        key = (dataset, model, system)
        if key not in cpu_runs:
            t0 = time.perf_counter()
            run = train_run(torch, cpu, exp, cfg, ref, pg, system=system,
                            train_steps=CPU_LOSS_STEPS)
            cpu_runs[key] = (run[0], fetch_counters(run[1]),
                             time.perf_counter() - t0)
        cpu_losses_, cpu_fetch, cpu_s = cpu_runs[key]
        np.testing.assert_allclose(hist[:CPU_LOSS_STEPS], cpu_losses_,
                                   rtol=1e-4, atol=1e-5)
        fetch = fetch_counters(metrics)
        if fetch != cpu_fetch or fetch_counters(again[1]) != fetch:
            raise RuntimeError(f"launcher {name}: fetch counters {fetch} "
                               f"(second run {fetch_counters(again[1])}), "
                               f"on the CPU {cpu_fetch}")
        per = steps // exp.num_epochs
        first, last = np.mean(hist[:per]), np.mean(hist[-per:])
        if not last < first:
            raise RuntimeError(f"launcher {name}: the loss did not fall "
                               f"(epoch means {first} -> {last})")
        if compiler == "device" and (dataset, model, system, "numpy") in \
                out and out[(dataset, model, system, "numpy")][
                    "losses"] != hist:
            raise RuntimeError(f"launcher {name}: the device schedule "
                               f"trained another curve than the numpy one")
        if model == "sage" and system == "rapidgnn":
            batches.setdefault(dataset, (captured[0], cfg,
                                         ws.pad_bounds()[0]))
        tot = metrics.totals()
        h2d = sorted(a for a, _ in split)
        out[(dataset, model, system, compiler)] = r = {
            "steps": steps, "losses": hist, "cpu_losses": cpu_losses_,
            "schedule_ms_per_epoch": 1e3 * build_s / exp.num_epochs,
            "steps_per_s": steps / wall, "wall_s": wall,
            "wall_s_second_run": again[2],
            "stall_ms_per_step": 1e3 * tot["fetch_stall_s"] / steps,
            "compute_ms_per_step": 1e3 * tot["compute_time_s"] / steps,
            "h2d_ms_median": 1e3 * h2d[len(h2d) // 2],
            "peak_bytes": peak, "launches": launches, "fetch": fetch,
            "cpu_run_s": cpu_s}
        log(f"launcher {name}: {steps} steps ({exp.num_epochs} epochs) in "
            f"{wall:.3f} s = {r['steps_per_s']:.2f} steps/s (second run "
            f"{again[2]:.3f} s); per step stall "
            f"{r['stall_ms_per_step']:.2f} ms + compute "
            f"{r['compute_ms_per_step']:.2f} ms (H2D median "
            f"{r['h2d_ms_median']:.2f} ms); schedule "
            f"{r['schedule_ms_per_epoch']:.1f} ms an epoch ({compiler}"
            f"{', bit-equal to numpy' if compiler == 'device' else ''}); "
            f"hit_rate {fetch['hit_rate']:.4f}, rpc_count "
            f"{fetch['rpc_count']}, remote_bytes {fetch['remote_bytes']}, "
            f"miss matrix {fetch['miss_matrix']} (= the CPU run's); peak "
            f"{peak / 2 ** 20:.1f} MiB; launches {json.dumps(launches)}; "
            f"losses {hist[0]:.6f} -> {hist[-1]:.6f} (epoch means "
            f"{first:.6f} -> {last:.6f}), first {CPU_LOSS_STEPS} within "
            f"rtol=1e-4 atol=1e-5 of the CPU, second run bit-identical")
    return out, batches, sort_input


@contextlib.contextmanager
def captured_batches(n: int, out: list):
    """Records in ``out`` the first ``n`` (features, batch) pairs
    ``repro_torch.models.batch_to_device`` is handed (the host cells'
    step inputs)."""
    import repro_torch.models as models

    real = models.batch_to_device

    def recording(cb, feats, device):
        if len(out) < n:
            out.append((feats.copy(), cb))
        return real(cb, feats, device)
    models.batch_to_device = recording
    try:
        yield out
    finally:
        models.batch_to_device = real


def grid_phase(torch, device, counters):
    """(b) ``full_grid()``'s GRID_DATASET, batch-GRID_BATCH scenario: the
    four host systems through ``run_host_cell`` on the card, the
    differential checks and the report; the ``gcn`` cell (fan-outs 50,
    50) again, bit-equal, its first steps against the CPU."""
    import dataclasses

    import numpy as np
    from repro_torch.eval import (CampaignSpec, run_host_cell,
                                  validate_report)
    from repro_torch.eval.cells import cell_config
    from repro_torch.eval.spec import full_grid
    from repro_torch.graph import load_dataset

    cells = tuple(dataclasses.replace(c, epochs=GRID_EPOCHS)
                  for c in full_grid().host_cells()
                  if c.dataset == GRID_DATASET
                  and c.batch_size == GRID_BATCH)
    spec = CampaignSpec(name=f"full-{GRID_DATASET}-b{GRID_BATCH}"
                        f"-e{GRID_EPOCHS}", cells=cells)
    run = campaign_run(torch, device, spec, counters,
                       os.path.join(OUT_DIR, "BENCH_torch_full_ogbn.json"))
    report = run["report"]
    probs = validate_report(report)
    fails = [c for c in report["differential"] if c["status"] == "FAIL"]
    if probs or fails or not report["all_checks_pass"]:
        raise RuntimeError(f"grid {spec.name}: invalid {probs}, failed "
                           f"{fails}")
    i = next(j for j, c in enumerate(run["cells"]) if c.system == "gcn")
    gcn, captured = run["cells"][i], []
    with captured_batches(CPU_LOSS_STEPS, captured):
        again = run_host_cell(cells[i], device=device)
    if again.losses != gcn.losses or any(
            getattr(again, k) != getattr(gcn, k) for k in CELL_COUNTS
            if k not in ("losses", "accs")):
        raise RuntimeError("grid: a second run of the gcn cell differs")
    # the cell's step: initial_params(cfg, seed) and AdamW(lr=3e-3)
    cfg = cell_config(cells[i], load_dataset(GRID_DATASET))
    cpu_losses_ = cpu_losses(torch, cells[i].seed, cfg, captured)
    np.testing.assert_allclose(gcn.losses[:CPU_LOSS_STEPS], cpu_losses_,
                               rtol=1e-4, atol=1e-5)
    campaign_cell_lines("grid", run)
    fo50 = run["launches"][i]["gather_agg"]
    log(f"grid gcn cell (fan-outs {cfg.fanouts}, hidden {cfg.hidden_dim}): "
        f"second run bit-equal (losses and every counter), first "
        f"{CPU_LOSS_STEPS} losses within rtol=1e-4 atol=1e-5 of the CPU "
        f"{['%.6f' % x for x in cpu_losses_]}; gather_agg launches at "
        f"fan-out 50: {fo50}, gather_agg_bwd {run['launches'][i]['gather_agg_bwd']}"
        f"; {GRID_EPOCHS} epoch of the grid's 2")
    return {"cells": [c.to_dict() for c in run["cells"]],
            "pairs": report["pairs"], "launches": run["launches"],
            "peaks": run["peaks"], "wall_s": run["wall_s"],
            "gcn_cpu_losses": cpu_losses_, "gcn_fanout50_launches": fo50,
            "checks": {s: sum(1 for c in report["differential"]
                              if c["status"] == s)
                       for s in ("PASS", "FAIL", "SKIP")}}, \
        (captured[0], cfg)


def scale_phase(torch, device, g, pg, counters):
    """(c) the runner on ``DATASET`` at SCALE_PARTS workers, flat (twice)
    and SCALE_LAYOUT, beside the same flat run at PARTS; the device
    campaign pair at SCALE_PARTS, flat and SCALE_LAYOUT, under phase 9's
    checks."""
    import dataclasses

    import numpy as np
    from repro_torch.dist import assert_host_parity, make_mesh
    from repro_torch.dist.gnn_step import tree_to_device
    from repro_torch.eval import CampaignSpec, grid, validate_report
    from repro_torch.graph import partition_graph

    pgs = {PARTS: pg, SCALE_PARTS: partition_graph(g, SCALE_PARTS,
                                                   "greedy")}
    side, curves = {}, {}
    for P in (PARTS, SCALE_PARTS):
        w = runner_world(torch, device, g, pgs[P], parts=P, lazy=False)
        layouts = ("flat",) if P == PARTS else ("flat", "flat",
                                                SCALE_LAYOUT)
        runs = []
        for layout in layouts:
            runner = runner_make(w, device, layout=layout)
            reports, launches, peak = runner_drive(torch, runner, counters)
            idle = [k for k in ("assemble", "gather_agg", "gather_agg_bwd")
                    if launches[k] == 0]
            if idle or launches["merge_gather"] or launches["search"] or \
                    runner.trace_count != 1:
                raise RuntimeError(f"scale P={P} {layout}: launches "
                                   f"{launches}, trace_count "
                                   f"{runner.trace_count}")
            runs.append((runner, reports, launches, peak))
        runner, reports, launches, peak = runs[0]
        curve = _curve(reports)
        if not np.isfinite(curve).all():
            raise RuntimeError(f"scale P={P}: bad curve {curve.tolist()}")
        assert_host_parity(w["eager"], pgs[P], w["exp"].batch_size, reports)
        cpu = runner_cpu_losses(torch, w, runner)
        np.testing.assert_allclose(curve[:CPU_LOSS_STEPS], cpu, rtol=1e-4,
                                   atol=1e-5)
        for _, rep, _, _ in runs[1:]:
            if _curve(rep).tobytes() != curve.tobytes():
                raise RuntimeError(f"scale P={P}: a rerun or the "
                                   f"{SCALE_LAYOUT} run gave another curve")
        if P == SCALE_PARTS:
            hier = runs[2][1]
            for r, h in zip(reports, hier):
                if not np.array_equal(h.intra_lanes + h.inter_lanes,
                                      r.miss_lanes) or \
                        h.intra_wire_rows + h.inter_wire_rows != \
                        h.wire_rows or not h.inter_wire_rows:
                    raise RuntimeError(f"scale epoch {r.epoch}: the "
                                       f"{SCALE_LAYOUT} tiers do not add up")
        curves[P] = curve
        dw = dist_world(g, pgs[P], parts=P)
        x = tree_to_device({"table": dw["dv"].table,
                            "offsets": dw["dv"].offsets.reshape(-1),
                            "rapid": dw["rapid"]}, device)
        xms = exchange_ms(torch, make_mesh((P,), ("data",), device=device),
                          x, "rapid", dw["m_max"], dw["S"])
        del x, dw
        eps = runner_epochs(reports)
        row = g.feat_dim * 4
        side[P] = {
            "steps_per_epoch": runner.num_steps,
            "train_ms_per_step": [e["train_ms_per_step"] for e in eps],
            "exchange_ms_per_step": xms,
            "wire_bytes": sum(e["wire_rows"] for e in eps) * row,
            "miss_lanes": [e["miss_lanes"] for e in eps],
            "launches": launches, "peak_bytes": peak,
            "layouts": {lay: runner_epochs(rep) for lay, (_, rep, _, _)
                        in zip(("flat", "flat again", SCALE_LAYOUT)[
                            :len(runs)], runs)}}
        log(f"scale P={P} ({'flat' if P == PARTS else f'flat x2 and {SCALE_LAYOUT}'}): "
            f"{RUNNER_EPOCHS} epochs x {runner.num_steps} steps, ms a step "
            f"{['%.2f' % v for v in side[P]['train_ms_per_step']]}, "
            f"exchange alone {xms:.3f} ms a step (flat, epoch 0), wire "
            f"bytes {side[P]['wire_bytes']}, miss lanes "
            f"{side[P]['miss_lanes'][0]} (epoch 0), peak "
            f"{peak / 2 ** 20:.1f} MiB, launches {json.dumps(launches)}; "
            f"trace_count 1, host parity, first {CPU_LOSS_STEPS} losses "
            f"within rtol=1e-4 atol=1e-5 of the CPU"
            + (f", rerun and {SCALE_LAYOUT} bit-equal to flat"
               if P == SCALE_PARTS else ""))
    a, b = side[PARTS], side[SCALE_PARTS]
    log(f"scale side by side P={PARTS} | P={SCALE_PARTS}: warm ms a step "
        f"{np.mean(a['train_ms_per_step'][1:]):.2f} | "
        f"{np.mean(b['train_ms_per_step'][1:]):.2f}; exchange ms a step "
        f"{a['exchange_ms_per_step']:.3f} | {b['exchange_ms_per_step']:.3f};"
        f" wire bytes {a['wire_bytes']} | {b['wire_bytes']}; launches "
        f"{json.dumps(a['launches'])} | {json.dumps(b['launches'])} "
        f"(printed, not claimed)")

    cells = grid(backends=("device",), systems=("rapidgnn", "dgl-metis"),
                 datasets=(DATASET,), batch_sizes=(TRAIN_BATCH,),
                 workers=(SCALE_PARTS,), n_hots=(CAMPAIGN_N_HOT,),
                 epochs=CAMPAIGN_EPOCHS, seed=42, fanouts=(25, 10),
                 hidden=256, partition="greedy")
    cells += [dataclasses.replace(c, topology=SCALE_LAYOUT) for c in cells]
    spec = CampaignSpec(name=f"paper-{DATASET}-P{SCALE_PARTS}",
                        cells=tuple(cells))
    run = campaign_run(torch, device, spec, counters, os.path.join(
        OUT_DIR, f"BENCH_torch_paper_P{SCALE_PARTS}.json"))
    report = run["report"]
    probs = validate_report(report)
    fails = [c for c in report["differential"] if c["status"] == "FAIL"]
    ran = {c["check"] for c in report["differential"]}
    want = ("fetch_not_more", "loss_agreement", "topology_miss_parity",
            "topology_byte_sum", "topology_loss_parity", "one_compilation")
    missing = [k for k in want if k not in ran]
    if probs or fails or missing or not report["all_checks_pass"]:
        raise RuntimeError(f"campaign P={SCALE_PARTS}: invalid {probs}, "
                           f"failed {fails}, layers missing {missing}")
    if [c.trace_count for c in run["cells"]] != [1] * len(cells):
        raise RuntimeError("campaign P=8: a cell traced more than once")
    rapid = next(c for c in run["cells"] if c.system == "rapidgnn"
                 and c.spec["topology"] == "flat")
    if np.asarray(rapid.losses, np.float32).tobytes() != \
            curves[SCALE_PARTS].tobytes():
        raise RuntimeError(f"the P={SCALE_PARTS} campaign's rapid cell is not "
                           f"the runner's flat run")
    campaign_cell_lines(f"P={SCALE_PARTS}", run)
    return {"side": side, "campaign": {
        "cells": [c.to_dict() for c in run["cells"]],
        "pairs": report["pairs"], "launches": run["launches"],
        "peaks": run["peaks"], "wall_s": run["wall_s"]}}


def fill_caches(torch, states, seed: int, device):
    """Every k/v cache of ``states`` from its own seeded generator on
    ``device`` (drawn in the cache's dtype): layer (i, r)'s k and v are
    ``cache_fill(...)`` of (seed, i, r, 0 or 1)."""
    for i, st in enumerate(states["scan"]):
        for r in range(st["k"].shape[0]):
            for j, name in enumerate(("k", "v")):
                st[name][r].copy_(cache_fill(torch, st[name][r], seed, i, r,
                                             j, device))


def cache_fill(torch, like, seed, i, r, j, device):
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + i * 10_007 + r * 101 + j)
    return torch.randn(like.shape, generator=gen, device=device,
                       dtype=like.dtype).to(like.device)


def check_ring_slots(torch, states, seed: int, pos: int, device) -> list:
    """After a step at ``pos``, each cache differs from its fill at the
    one slot the reference writes, ``pos % S_cache``, and nowhere else.
    -> the slots."""
    slots = []
    for i, st in enumerate(states["scan"]):
        S = st["k"].shape[2]
        for r in range(st["k"].shape[0]):
            for j, name in enumerate(("k", "v")):
                cache = st[name][r]
                diff = (cache != cache_fill(torch, cache, seed, i, r, j,
                                            device)).flatten(2).any(-1)
                got = diff.nonzero().tolist()
                if got != [[0, pos % S]]:
                    raise RuntimeError(f"ring slots: layer ({i}, {r}) {name} "
                                       f"written at {got[:4]}, the "
                                       f"reference writes slot {pos % S} "
                                       f"of {S}")
        slots.append((S, pos % S))
    return slots


def long_decode_arch(torch, device, name, counters):
    """(d) one arch: full width and depth, bf16, B = 1, its long_500k
    caches (a window of LONG_WINDOW slots outside SUBQUADRATIC) filled
    from LONG_SEED; one ``serve_step`` at the last position, again
    (bit-equal), then with each layer's ``flash_decode`` checked against
    its plain version on its own inputs, then through the plain version;
    the ring slots; one global layer's kernel row."""
    import dataclasses
    import operator

    import torch.nn.functional as F
    import repro_torch.models.transformer.attention as attention
    from repro_torch.configs import INPUT_SHAPES, SUBQUADRATIC, get_arch
    from repro_torch.kernels.flash_decode.ref import (flash_decode_batched_ref,
                                                      finalize)
    from repro_torch.launch.specs import LONG_WINDOW
    from repro_torch.models.transformer import (init_decode_state,
                                                init_params, serve_step)

    S_full = INPUT_SHAPES["long_500k"][0]
    pos = S_full - 1
    window = 0 if name in SUBQUADRATIC else LONG_WINDOW
    cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    states = init_decode_state(cfg, 1, S_full, device=device,
                               window_override=window)
    fill_caches(torch, states, LONG_SEED, device)
    torch.cuda.synchronize()
    cache_bytes = sum(st[k].numel() * st[k].element_size()
                      for st in states["scan"] for k in ("k", "v"))
    setup_s = time.perf_counter() - t0
    tok = torch.from_numpy(lm_tokens(cfg, (1, 1), 0x4C35)).to(device)
    p = torch.full((1,), pos, dtype=torch.int32, device=device)
    real = attention.flash_decode_batched

    def step():
        with torch.inference_mode():
            out = serve_step(cfg, params, states, tok, p,
                             window_override=window)[0][0, 0]
        torch.cuda.synchronize()
        return out
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    logits = step()
    step_s = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"flash_attention": 0, "flash_decode": attn_layers(cfg)}:
        raise RuntimeError(f"long_500k {name}: launches {launches}, one "
                           f"flash_decode an attention layer expected")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"long_500k {name}: logits not finite")
    slots = check_ring_slots(torch, states, LONG_SEED, pos, device)
    t0 = time.perf_counter()
    again = step()
    again_s = time.perf_counter() - t0
    if not torch.equal(again, logits):
        raise RuntimeError(f"long_500k {name}: a second step differs")

    errs, kept = [], {}

    def checked(*a, **kw):
        out = real(*a, **kw)
        acc, _, l = flash_decode_batched_ref(*a, **kw)
        want = finalize(acc, l)
        errs.append(float((out - want).abs().max()))
        if not torch.allclose(out, want, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"long_500k {name}: flash_decode at a layer "
                               f"(cache {tuple(a[1].shape)}) differs from "
                               f"its plain version by {errs[-1]}")
        kept.setdefault(a[1].shape[1], (a, kw))
        return out
    attention.flash_decode_batched = checked
    try:
        checked_logits = step()
    finally:
        attention.flash_decode_batched = real
    if not torch.equal(checked_logits, logits) or \
            len(errs) != attn_layers(cfg):
        raise RuntimeError(f"long_500k {name}: the checked step differs")
    attention.flash_decode_batched = lambda *a, **kw: finalize(
        *operator.itemgetter(0, 2)(flash_decode_batched_ref(*a, **kw)))
    try:
        plain = step()
    finally:
        attention.flash_decode_batched = real
    top = float(plain.abs().max())
    logit_err = float((logits - plain).abs().max())
    if not logit_err <= LONG_LOGIT_SHARE * top:
        raise RuntimeError(f"long_500k {name}: logits differ from the plain "
                           f"step's by {logit_err} > {LONG_LOGIT_SHARE} x "
                           f"{top}")

    # the kernel row at the layer with the longest cache, on its inputs
    S = max(kept)
    (q, k, v, length, start), kw = kept[S]
    B, H, dh = q.shape
    kvH = k.shape[2]

    def call():
        return real(q, k, v, length, start, **kw)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    if kw.get("softcap", 0.0) == 0.0:
        lib_err = float((sdpa()[:, :, 0].float() - call()).abs().max())
        if lib_err > 0.05:
            raise RuntimeError(f"SDPA yardstick (long_500k {name}) "
                               f"computes another function: {lib_err}")
    nbytes = 2 * B * S * kvH * dh * k.element_size() + \
        q.numel() * q.element_size() + B * H * dh * 4
    ops = device_ops(torch, call)
    row = {"name": f"flash_decode_{name}_long_500k", "route": "cuda",
           "source": DECODE_SOURCE,
           "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
           "launches": launches["flash_decode"], "max_abs_err": max(errs),
           "ms": device_ms(torch, call),
           "plain_ms": device_ms(torch, lambda: flash_decode_batched_ref(
               q, k, v, length, start, **kw), iters=5),
           "library_ms": device_ms(torch, sdpa, iters=5),
           "device_ops": len(ops),
           "shape": f"q=({B},{H},{dh}) cache=({B},{S},{kvH},{dh}) bf16, "
                    f"G={H // kvH}, softcap {kw.get('softcap', 0.0)}"}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4 * dh * H * B * S,
                                                BF16_FLOPS_PER_S)
    out = {"cfg": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                   "window_override": window, "cache_bytes": cache_bytes},
           "pos": pos, "setup_s": setup_s, "step_ms": 1e3 * step_s,
           "second_step_ms": 1e3 * again_s, "peak_bytes": peak,
           "launches": launches, "ring_slots": sorted(set(slots)),
           "layer_max_abs_err": max(errs), "logit_max_abs_err": logit_err,
           "max_logit": top, "row": row}
    log(f"long_500k {name}: {cfg.num_layers} layers d={cfg.d_model} bf16, "
        f"B=1 at position {pos}, window_override {window}, caches "
        f"{cache_bytes / 2 ** 30:.2f} GiB from seed {LONG_SEED} (set up in "
        f"{setup_s:.1f} s); a step {1e3 * step_s:.1f} ms (second "
        f"{1e3 * again_s:.1f} ms, bit-equal), peak "
        f"{peak / 2 ** 30:.2f} GiB, launches {json.dumps(launches)}; ring "
        f"slots (S_cache, slot) {sorted(set(slots))} as the reference's "
        f"pos % S_cache; each layer's flash_decode within rtol=1e-4 "
        f"atol=1e-5 of its plain version on its own inputs (max abs err "
        f"{max(errs):.3e}); logits max |diff| from the step through the "
        f"plain version {logit_err:.4g} of largest {top:.4g} (bound "
        f"{LONG_LOGIT_SHARE} x largest, bf16)")
    log(f"flash_decode long_500k {name} {row['shape']}: ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f}"
        f" (SDPA enable_gqa, no softcap) bound_ms={row['bound_ms']:.4f} "
        f"({row['bound_by']}, {nbytes / 1e6:.1f} MB), "
        f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; "
        f"{len(ops)} card op a call")
    del params, states, kept
    torch.cuda.empty_cache()
    return out


def long_reduced_check(torch, device, counters):
    """(d) the reduced float32 configs of LONG_ARCHS at long_500k's length
    (the window outside SUBQUADRATIC), caches filled on the CPU: two
    ``serve_step``s at the last positions, on the card and on the CPU
    from the same parameters, logits within ``rtol=1e-4, atol=1e-4``; a
    second card run bit-equal; one launch an attention a step."""
    from repro_torch.configs import INPUT_SHAPES, SUBQUADRATIC, get_reduced
    from repro_torch.launch.specs import LONG_WINDOW
    from repro_torch.models.transformer import (init_decode_state,
                                                init_params, serve_step)
    from repro_torch.train.optim import tree_map

    cpu = torch.device("cpu")
    S_full = INPUT_SHAPES["long_500k"][0]
    out = {}
    for name in LONG_ARCHS:
        cfg = get_reduced(name)
        window = 0 if name in SUBQUADRATIC else LONG_WINDOW
        host_p = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
        card_p = tree_map(lambda t: t.to(device), host_p)
        toks = torch.from_numpy(lm_tokens(cfg, (1, 2), 0x4C52))

        def run(dev, params):
            states = init_decode_state(cfg, 1, S_full, device=dev,
                                       window_override=window)
            fill_caches(torch, states, LONG_SEED, cpu)
            got = []
            with torch.inference_mode():
                for i in range(2):
                    lg, _ = serve_step(
                        cfg, params, states, toks[:, i:i + 1].to(dev),
                        torch.full((1,), S_full - 2 + i, dtype=torch.int32,
                                   device=dev), window_override=window)
                    got.append(lg[0, 0].cpu())
            return torch.stack(got)
        for c in counters:
            c.reset()
        card = run(device, card_p)
        launches = {c.name: c.value for c in counters}
        again = run(device, card_p)
        host = run(cpu, host_p)
        err = float((card - host).abs().max())
        if launches != {"flash_attention": 0,
                        "flash_decode": 2 * attn_layers(cfg)}:
            raise RuntimeError(f"long_500k {name} (reduced): launches "
                               f"{launches}")
        if not torch.allclose(card, host, rtol=1e-4, atol=1e-4):
            raise RuntimeError(f"long_500k {name} (reduced): card logits "
                               f"differ from the CPU's by {err}")
        if not torch.equal(card, again):
            raise RuntimeError(f"long_500k {name} (reduced): a second card "
                               f"run differs")
        out[name] = {"max_abs_err": err, "launches": launches}
        log(f"long_500k {name} (reduced, float32, window_override {window}):"
            f" 2 steps at positions {S_full - 2}, {S_full - 1} on the card "
            f"within rtol=1e-4 atol=1e-4 of the CPU (max abs err "
            f"{err:.3e}); second card run bit-equal; launches "
            f"{json.dumps(launches)}")
    return out


def long_phase(torch, device, counters):
    out = {"reduced": long_reduced_check(torch, device, counters)}
    for name in LONG_ARCHS:
        out[name] = long_decode_arch(torch, device, name, counters)
    return out


def phase15_kernel_rows(torch, device, batches, sort_input, gcn_batch):
    """The new shapes of rows 3, 3b and 4: the ``gather_agg`` forward at
    layer 0 of each dataset (d 100 and 128) and at the gcn cell's fan-out
    50, its backward at layer 1 of the first dataset (ogbn_products_sim)
    and of the gcn cell, ``seg_sort`` at the first dataset's largest
    schedule stream."""
    import numpy as np

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    forward, backward = [], []
    for dataset, ((feats, cb), cfg, m_max) in batches.items():
        fo = cfg.fanouts[0]
        forward.append(gather_agg_row(
            torch, t(feats), t(cb.edge_src[0]), t(cb.edge_mask[0]),
            cb.edge_src[0].shape[0] // fo, fo, f"{dataset} layer 0")["row"])
        if dataset == LAUNCHER_RUNS[0][0]:
            backward.append(gather_bwd_row(
                torch, device, cb, cfg.fanouts, m_max, 1, cfg.hidden_dim,
                f"{dataset} layer 1", 1e-5))
    (feats, cb), cfg = gcn_batch
    fo = cfg.fanouts[0]
    forward.append(gather_agg_row(
        torch, t(feats), t(cb.edge_src[0]), t(cb.edge_mask[0]),
        cb.edge_src[0].shape[0] // fo, fo, "gcn cell layer 0")["row"])
    backward.append(gather_bwd_row(torch, device, cb, cfg.fanouts,
                                   feats.shape[0], 1, cfg.hidden_dim,
                                   "gcn cell layer 1", 1e-5))
    sorts = [seg_sort_row(torch, sort_input["keys"], None,
                          sort_input["num_bits"],
                          f"{LAUNCHER_RUNS[0][0]} layer-0 stream")]
    for r in forward + backward + sorts:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return {"gather_agg": forward, "gather_agg_bwd": backward,
            "seg_sort": sorts}


def phase15(torch, device, g, pg, counters, decode_counters):
    """Phase 15: (a)-(d), then the new kernel shapes. -> (record, the
    launches each kernel made on the phase's counted runs, the new
    flash_decode rows)."""
    walls, t0 = {}, time.perf_counter()
    launcher, batches, sort_input = launcher_phase(torch, device, counters)
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid_out, gcn_batch = grid_phase(torch, device, counters)
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scale = scale_phase(torch, device, g, pg, counters)
    walls["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phase15_kernel_rows(torch, device, batches, sort_input, gcn_batch)
    walls["rows"] = time.perf_counter() - t0
    del batches, sort_input, gcn_batch
    t0 = time.perf_counter()
    long = long_phase(torch, device, decode_counters)
    walls["d"] = time.perf_counter() - t0
    total = {}
    counted = [r["launches"] for r in launcher.values()] + \
        grid_out["launches"] + scale["campaign"]["launches"] + \
        [s["launches"] for s in scale["side"].values()]
    for ln in counted:
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    total["flash_decode"] = sum(long[n]["launches"]["flash_decode"]
                                for n in LONG_ARCHS) + sum(
        r["launches"]["flash_decode"] for r in long["reduced"].values())
    log(f"phase 15 launches over its counted runs {json.dumps(total)}; "
        f"walls s {json.dumps({k: round(v, 1) for k, v in walls.items()})}"
        f", the phase {sum(walls.values()):.1f} s")
    return {"launcher": {" ".join(k): v for k, v in launcher.items()},
            "grid": grid_out, "scale": scale,
            "long": {k: v for k, v in long.items()},
            "kernel_shapes": rows, "launches": total,
            "walls": walls}, total, [long[n]["row"] for n in LONG_ARCHS]


# ---------------------------------------------------------------------------
# phase 16: the LM paths the card had not run
# ---------------------------------------------------------------------------

#: the non-dense families trained reduced (config fields set on each):
#: MoE (arctic with its dense residual), SSD, RG-LRU and local attention
#: (5 layers: one (rglru, rglru, local) repeat and the two rglru tail
#: blocks), enc-dec (``encode``, cross-attention) and M-RoPE (patch
#: ``embeds``, three position streams)
FAMILY_TRAIN = {"qwen3-moe-30b-a3b": {}, "arctic-480b": {},
                "mamba2-1.3b": {}, "recurrentgemma-9b": {"num_layers": 5},
                "seamless-m4t-medium": {}, "qwen2-vl-72b": {}}
#: ``--steps`` of each launcher run: the fewest at which the launcher's
#: last loss is at least 0.02 below its first on the card (its defaults:
#: the reduced config, batch 8 x 128, seed 42; NVIDIA H100 80GB HBM3,
#: torch 2.11, numpy 2.3.5, whose draws differ from other versions').
#: mamba2-1.3b's second and third losses are within 0.02 of its first,
#: seamless-m4t-medium's second above it
FAMILY_LAUNCHER_STEPS = {"qwen3-moe-30b-a3b": 2, "arctic-480b": 2,
                         "mamba2-1.3b": 4, "recurrentgemma-9b": 2,
                         "seamless-m4t-medium": 3, "qwen2-vl-72b": 2}
#: the SSD family's full-width training, as phase 10's granite-3-2b run
SSD_TRAIN_ARCH = "mamba2-1.3b"
#: the largest model one card holds whole, served at full width and
#: depth; its prefill at the longest of these S that fits beside the
#: weights (``serve_prefill_s``)
SERVE_ARCH = "qwen1.5-32b"
SERVE_PREFILL_S = (8192, 4096, 2048)
#: what the card keeps free beyond the reckoned prefill (the allocator's
#: rounding, the profiler's buffers)
SERVE_SPARE_BYTES = 2 << 30
#: the ``flash_decode`` row's cache: as long as qwen3-moe-30b-a3b's
SERVE_DECODE_CACHE = 4096


def family_train(torch, device, counters):
    """(a) each family reduced: ``reduced_train`` (card against CPU, a
    second card run bit-equal, no kernel launched), then the launcher,
    ``launch.train.main(["--workload", "lm", ...])`` on the card, its
    last loss below its first (its own assertion), no kernel launched."""
    import dataclasses
    import io
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import main as train_main

    out = {}
    for arch, fields in FAMILY_TRAIN.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_reduced(arch), **fields)
        res = reduced_train(torch, device, cfg, counters,
                            f"{arch}{f' {fields}' if fields else ''}")
        steps = FAMILY_LAUNCHER_STEPS[arch]
        for c in counters:
            c.reset()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            train_main(["--workload", "lm", "--arch", arch,
                        "--steps", str(steps), "--device", device.type])
        launches = {c.name: c.value for c in counters}
        head = f"== lm {arch} (reduced) on {device.type} == {steps} steps"
        line = next((x for x in text.getvalue().splitlines()
                     if x.startswith(head)), None)
        if line is None or any(launches.values()):
            raise RuntimeError(f"the launcher on {arch}: {text.getvalue()!r}"
                               f", launches {launches}")
        res.update(launcher=line, launcher_launches=launches,
                   wall_s=time.perf_counter() - t0)
        log(f"lm launcher {arch}: {line}; launches {json.dumps(launches)}")
        out[arch] = res
    return out


def serve_prefill_s(cfg, free: int) -> tuple:
    """The longest of SERVE_PREFILL_S whose reckoned bytes fit in
    ``free`` less SERVE_SPARE_BYTES, and the reckoning: the largest of
    one layer's FFN (gate, up, their product) and q/k/v; the head's bf16
    product beside its float32 copy; ``prefill_phase``'s finite check of
    the float32 logits (``isfinite`` takes a float32 ``abs`` and three
    boolean masks beside them); and the ``flash_attention`` row's plain
    version (float32 k/v, four float32 score blocks of 1024 query
    rows)."""
    H, kvH, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def need(S):
        layer = S * cfg.d_ff * 2 * 3 + S * (H + 2 * kvH) * dh * 2 * 2
        logits = S * cfg.vocab_size
        row = 4 * H * min(S, 1024) * S * 4 + 2 * S * kvH * dh * 4
        return max(layer, logits * (2 + 4), logits * (4 + 4 + 3), row)
    reck = {S: need(S) for S in SERVE_PREFILL_S}
    fits = [S for S in SERVE_PREFILL_S if reck[S] + SERVE_SPARE_BYTES <= free]
    if not fits:
        raise RuntimeError(f"{cfg.name}: no prefill of {SERVE_PREFILL_S} "
                           f"fits in {free} free bytes ({reck})")
    return fits[0], reck


def serve_full(torch, device, counters):
    """(c) SERVE_ARCH at full width and depth in bfloat16, parameters from
    a seeded generator on the card: ``prefill_phase`` at B=1 and the
    longest S that fits, ``decode_phase``'s greedy loop (one launch an
    attention layer, a second run bit-equal), the decode step's byte
    bound (every weight read once), the two kernel rows at the model's
    heads (G = 1, dh 128); the model freed, then its reduced config in
    ``reduced_check``."""
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.models.transformer import init_params

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"serve {SERVE_ARCH}: {held} bytes ({held / 2**30:.3f} GiB) held on "
        f"the card at the start")
    cfg = get_arch(SERVE_ARCH) if LM_FULL else get_reduced(SERVE_ARCH)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    # the float32 draws' blocks, cached by the allocator, back to the card
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    seq, reck = serve_prefill_s(cfg, free)
    log(f"serve {cfg.name}: {'full' if LM_FULL else 'reduced'} "
        f"{cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"kvH={cfg.num_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} "
        f"{cfg.dtype}: {n / 1e9:.3f} B parameters, {weights / 1e9:.2f} GB "
        f"from seed {LM_SEED} in {time.perf_counter() - t0:.2f} s; "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free; prefill bytes "
        f"reckoned {json.dumps({S: round(b / 1e9, 3) for S, b in reck.items()})}"
        f" GB (+ {SERVE_SPARE_BYTES / 2**30:.0f} GiB spare): S={seq}")
    prefill = prefill_phase(torch, device, cfg, params, counters, seq=seq)
    decode = decode_phase(torch, device, cfg, params, counters, host=False,
                          trace_steps=MIXER_TRACE_STEPS)
    bound = 1e3 * weights / MEM_BYTES_PER_S
    log(f"decode {cfg.name} byte bound: {weights / 1e9:.2f} GB of weights "
        f"read once a step at 3.35 TB/s = {bound:.3f} ms, "
        f"{100 * bound / decode['card_busy_ms_per_step']:.1f} % of the traced"
        f" step's card busy {decode['card_busy_ms_per_step']:.3f} ms; its "
        f"wall {decode['traced_ms_per_step']:.3f} ms")
    rows = [mixer_attention_row(
                torch, device, cfg, params, seq,
                prefill["launches"]["flash_attention"],
                name="flash_attention_g1_h128"),
            mixer_decode_row(
                torch, device, cfg, decode["launches"]["flash_decode"],
                full_s=SERVE_DECODE_CACHE, name="flash_decode_g1_h128")]
    del params, leaves
    torch.cuda.empty_cache()
    out = {"held_at_start_bytes": held, "parameters": n,
           "weight_bytes": weights, "free_bytes": free, "prefill_s": seq,
           "reckoned_bytes": reck, "prefill": prefill, "decode": decode,
           "decode_bound_ms": bound,
           "reduced": reduced_check(torch, device, counters, (SERVE_ARCH,),
                                    "serve")}
    return out, rows


def phase16(torch, device, counters):
    """Phase 16: (a) the non-dense families' training, reduced, and their
    launcher runs; (b) SSD_TRAIN_ARCH trained at full width and depth;
    (c) SERVE_ARCH served at full width and depth, with its kernel rows.
    Each part prints its wall."""
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced

    walls, out = {}, {}
    t0 = time.perf_counter()
    out["families"] = family_train(torch, device, counters)
    walls["families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = get_arch(SSD_TRAIN_ARCH) if LM_FULL else \
        get_reduced(SSD_TRAIN_ARCH)
    out["ssd_train"] = full_train(torch, device,
                                  dataclasses.replace(cfg, dtype="bfloat16"),
                                  counters)
    walls["ssd_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"], rows = serve_full(torch, device, counters)
    walls["serve"] = time.perf_counter() - t0
    out["walls"] = walls
    log(f"phase 16 walls s {json.dumps({k: round(v, 1) for k, v in walls.items()})}, "
        f"the phase {sum(walls.values()):.1f} s")
    return out, rows


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found beside this "
              f"script", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.assemble import ops as assemble_ops
    from repro_torch.kernels.cache_lookup import ops as search_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.seg_sort import ops as sort_ops

    # float32 products in full float32 on the card (the plain versions and
    # the decode-vs-prefill check compare float32 sums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.FAMILIES)) as pool:
        list(pool.map(_build.library, _build.FAMILIES))
    log(f"build: {len(_build.FAMILIES)} kernel families in "
        f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR})")
    # every instance of the bf16 decode and prefill kernels: no spill
    # (their float32 accumulators are 128 registers a thread at dh 256)
    seen = {prefix: set() for prefix in BF16_INSTANCES}
    spills = []
    for fam in _build.FAMILIES:
        text = _build.library_path(fam).with_suffix(".log").read_text()
        fn = ""
        for line in text.splitlines():
            entry = re.search(r"entry function '(\S+)'", line)
            if entry:
                name = re.search(r"([a-z][a-z_]*_kernel)I((?:L\w\d+E)+)E",
                                 entry.group(1))
                args = re.findall(r"L\w(\d+)E", name.group(2)) if name \
                    else ()
                fn = f"{name.group(1)}<{','.join(args)}>" if name else ""
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {fam}: {fn} {line.strip()}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line)
                prefix = next((p for p in seen if fn.startswith(p)), None)
                if prefix and spill:
                    seen[prefix].add(fn)
                    if int(spill.group(1)) or int(spill.group(2)):
                        spills.append(f"{fn} {line.strip()}")
    found = {prefix: sorted(fns) for prefix, fns in seen.items()}
    if spills or any(len(found[p]) != n for p, n in BF16_INSTANCES.items()):
        raise RuntimeError(f"bf16 attention kernels: instances {found} "
                           f"(want {BF16_INSTANCES}: flash_decode_mma.cu at "
                           f"dh 64, 128, 256 and 2 and 4 warps, "
                           f"flash_attention_wgmma.cu at dh 64, 128, 256), "
                           f"spills {spills}")
    log(f"ptxas gate: instances {json.dumps(found)}, 0 bytes of spill")

    # each phase's wall, from the end of the one before it
    marks = [("build", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    counters = [search_ops.LAUNCHES, assemble_ops.LAUNCHES,
                gather_ops.LAUNCHES]
    exp, g, pg, sampler, cfg, params = build_world(torch, device)
    svc, streams, responses, launches, phases, peak = serve(
        torch, device, exp, g, pg, sampler, cfg, params, counters)
    check_against_cpu(exp, pg, sampler, cfg, params, streams, responses)
    split = breakdown(torch, device, exp, pg, sampler, cfg, params, streams)

    x = served_inputs(torch, device, svc, streams, responses)
    kernels = kernel_phase(torch, device, x, launches)
    mark("2-3")

    train_counters = counters + [gather_ops.BWD_LAUNCHES, sort_ops.LAUNCHES]
    train, sort_input, captured, m_max, train_cfg = train_phase(
        torch, device, g, pg, train_counters)
    train_rows, forward = train_kernel_phase(
        torch, device, train_cfg, sort_input, captured, m_max,
        train["launches"])
    kernels += train_rows
    # the forward's row is timed at the serving shapes; training's two
    # layers, which carry most of its launches, ride along in the record
    next(k for k in kernels if k["name"] == "gather_agg")[
        "training_layers"] = forward
    del captured, sort_input
    mark("4-5")
    lm, lm_rows = lm_phase(torch, device, [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    kernels += lm_rows
    mark("6")
    dist_counters = train_counters + [search_ops.MERGE_LAUNCHES]
    dist, dist_in = dist_phase(torch, device, g, pg, dist_counters)
    emb, emb_in = embedding_phase(torch, device, dist_counters)
    kernels.append(merge_kernel_row(
        torch, device, dist_in, emb_in,
        dist["launches"]["rapid staged"]["merge_gather"]
        + emb["launches"]["merge_gather"]))
    # serving's fused assembly ranks inside its own kernel: the standalone
    # search runs on the staged chain and the embedding lookup
    next(k for k in kernels if k["name"] == "search")["launches"] = (
        dist["launches"]["rapid staged"]["search"]
        + emb["launches"]["search"])
    del dist_in, emb_in
    mark("7")
    runner = runner_phase(torch, device, g, pg, dist_counters)
    mark("8")
    campaign = campaign_phase(torch, device, dist_counters, runner)
    mark("9")
    lm_train = lm_train_phase(torch, device,
                              [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    mark("10")
    mixers, mixer_rows = mixer_phase(torch, device,
                                     [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    kernels += mixer_rows
    mark("11")
    encdec_vlm, encdec_vlm_rows = encdec_vlm_phase(
        torch, device, [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    kernels += encdec_vlm_rows
    mark("12")
    mesh = mesh_phase(torch, device, [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    mark("13")
    # the sharded row's launches: phase 13's decode loops over a mesh,
    # qwen3-moe-30b-a3b's (a) and gemma2-2b's (b)
    next(k for k in kernels if k["name"] == "flash_decode_sharded")[
        "launches"] += lm["mesh"]["decode"]["launches"]["flash_decode"]
    dryrun = dryrun_phase(torch, device, [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    mark("14")
    # phase 14's launches: (b)'s one-card steps and (c)'s counted step of
    # each rank 0
    for row in dryrun["card"]:
        for name, n in row["launches"].items():
            next(k for k in kernels if k["name"] == name)["launches"] += n
    for P in DRYRUN_GNN_WORKERS:
        for name, n in dryrun["gnn"][P]["launches"].items():
            next(k for k in kernels if k["name"] == name)["launches"] += n
    p15, p15_launches, p15_rows = phase15(
        torch, device, g, pg, dist_counters,
        [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    # phase 15's launches (the first run of each configuration, its
    # grid's and campaign's cells, its long_500k steps) and new shapes
    for name, n in p15_launches.items():
        next(k for k in kernels if k["name"] == name)["launches"] += n
    for name, shapes in p15["kernel_shapes"].items():
        next(k for k in kernels if k["name"] == name)["phase15_shapes"] = \
            shapes
    kernels += p15_rows
    mark("15")
    p16, p16_rows = phase16(torch, device, [fa_ops.LAUNCHES,
                                            fd_ops.LAUNCHES])
    mark("16")
    # the rows at qwen1.5-32b's heads carry its full model's launches and
    # its reduced config's (the reduced families' training launches none)
    for row, kind in zip(p16_rows, ("flash_attention", "flash_decode")):
        row["launches"] += p16["serve"]["reduced"][SERVE_ARCH]["launches"][
            kind]
    kernels += p16_rows
    for k in kernels:
        log("kernel " + json.dumps(
            {"kernel": k["name"], "ms": k["ms"], "plain_ms": k["plain_ms"],
             "library_ms": k["library_ms"], "launches": k["launches"],
             "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
             "max_abs_err": k["max_abs_err"], "shape": k["shape"]}))

    card = card_line()
    walls = {name: round(t - marks[i][1], 1)
             for i, (name, t) in enumerate(marks[1:])}
    walls["build"] = round(marks[0][1] - t_start, 1)
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s; phase walls "
        f"s {json.dumps(walls)}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "serve": phases,
                   "breakdown": split, "peak_bytes": peak,
                   "launches": launches, "train": train, "lm": lm,
                   "dist": dist, "embedding": emb, "runner": runner,
                   "campaign": campaign, "lm_train": lm_train,
                   "mixers": mixers, "encdec_vlm": encdec_vlm,
                   "mesh": mesh, "dryrun": dryrun, "phase15": p15,
                   "phase16": p16, "walls": walls}, f,
                  indent=1)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
