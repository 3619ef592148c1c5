#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card. The
   gather and segment kernels: every aggregation, fp32/bf16/int8
   storage, the serving path's shapes (GCN's scaled gathers at F=11/64/
   128, GAT's softmax-weighted gather at F=128, the pooling, PNA's and
   GIN's edge-message aggregations at F=11/128) and the edge cases
   (empty segments, -1 and out-of-range ids on each stream, a prime edge
   count, one-edge segments, large and negative values, a Welford case
   of near-equal values, F = 256); sum/mean/var/std hold to rtol 1e-5,
   atol 1e-6 (same fold order; only rounding of the plain version's
   separate operations could differ), min/max exactly. The one-hot
   kernels on the same cases and storage types at every tile pair of
   ``ONEHOT_TILES`` (node_block {32, 64, 128} x edge_block {64, 128,
   256}), against their plain versions to the same tolerances and, in
   fp32, bit for bit against the CSR kernels' outputs. The CSR gather
   also at every columns-a-lane cap of ``gather_geometry``
   (``GATHER_CAPS``), at its default geometry on one SM and on a
   row-offset view of x one element into its buffer (the wrapper caps
   the columns a lane by the view's alignment), and with the edges in
   flight forced to either batch (four loaded by each lane; the deep
   batch, ids shared by shuffle), each bit for bit its default launch; its max |err| against the plain version is printed by
   storage type. The CSR segment
   kernel also launched once for each agg set of ``MULTI_AGGS`` (the
   pooling set, PNA's four towers, all six) at every storage type: each
   slice bit for bit the single-agg launch's output and within the same
   tolerances of the plain version. The one-hot kernels also on the
   streams that stress their bucketing (``ADVERSARIAL``: a hub of ~1125
   edges, every edge into one node tile, a reversed stream, every id
   dropped, S = 1 of ~500 edges, S = 301 that no tile divides). The segment-softmax
   kernel: both GAT layers' logits at both serving shapes and the edge
   cases (a prime edge count, -1 and >= S ids, ``valid == False``, an
   empty, a one-edge and a several-thousand-edge segment, which the
   kernel and its plain version both fold in 32 parts, +-1e4, -inf and
   all -inf logits), to rtol 1e-5, atol 1e-7, with exact 0 wherever the
   plain version gives 0 and every weight finite. The resident
   layer-stack kernel: GCN and SAGE x fp32/bf16/int8 precision rows x
   skip on/off, each without and with real layer widths (``widths=``),
   at the path's shapes (both full-width layers, K = 2, at 32, 256 and
   1024 graphs/batch, at the model's widths 11 -> 128 -> 64, there also
   against the kernel without widths) and on the edge cases (a
   1200-edge hub row, past two of the kernel's 512-edge chunks, bad ids
   on each stream, N = 1001, F = 96 and 160, K = 1 and 4, no edges;
   ragged ``EDGE_WIDTHS``), then every
   activation; to ``STACK_TOL`` on the output scale, each bf16 and int8
   output differing from the fp32 one. The streaming form
   (``aggregations.aggregate_stream``, a loop of updates on the card)
   against the CSR segment kernel, every agg, over the 8 destinations of
   the 32-graph batch with the most incoming edges, within 1e-5
   (``stream_vs_segment``);
4. serving of every registered conv (``core.convs.CONV_TYPES``: gcn,
   sage, gin, pna, gat) at the paper's full width
   (``configs.gnn.benchmark_config``) on qm9 graphs through
   ``repro_torch.launch.serve --conv``: 256 requests at 32 graphs per
   batch and 10240 at 1024 (10 measured batches), and for GCN also 2048
   at 1024. Every request is served with finite outputs; each batch
   launches each kernel exactly as ``LAUNCHES_PER_BATCH`` says (one
   segment launch for the pooling set, one for PNA's four towers; the
   counts are zeroed just before each drain and read just after); the
   first batch matches the port's CPU plain path with the same weights
   (atol 1e-4, rtol 1e-4). Then GCN and SAGE through
   ``apply_packed_resident(fusion_depth=2)`` by ``serve.drain_gnn_queue``
   at 32, 256 and 1024 graphs/batch (10 measured batches each), with the
   residency plan's verdict, ``RESIDENT_LAUNCHES`` per batch when it is
   legal, the first batch against ``apply_packed`` on the card (1e-5 of
   the output scale) and the CPU plain path (1e-4), and graphs/s and p50
   beside ``apply_packed``'s on the same queue in the same run. Then
   every conv again at the bf16 and int8 policies (``serve
   --precision``; int8 grids calibrated on the warm-up batch), 256
   requests at 32 graphs/batch and 4096 at 1024 (``LOW_DRAINS``): the
   same launch table (counting the warm-up batch's calibration and
   comparison forwards), graphs/s, p50/max latency, and the warm-up
   batch's max error and SQNR against the fp32 program of the same call,
   at least 30 dB (bf16) and 10 dB (int8; where the JAX package's own
   SQNR on the same weights and batch is below that, as for GIN, that
   less 1 dB: ``INT8_REF_SQNR_DB``); at 32 graphs/batch the first batch
   against the CPU plain path at the same policy (``low_bound``) and the
   grids calibrated on the card beside the CPU's. GCN and SAGE resident at both
   precisions (the weight stacks cast for the policy, 4 measured batches
   at 32, 256 and 1024), the first batch against ``apply_packed`` at the
   same policy within ``resident_tols`` (the JAX package's
   ``_resident_tols``);
5. for each conv, the full-width output on the first 32 qm9 graphs,
   weights from the golden file's numpy seed, against the JAX package's
   output stored in ``src/repro_torch/testdata/{conv}_qm9_full.json``
   (atol 1e-4, rtol 1e-4), for GCN and SAGE also through the resident
   path; the same at bf16 and int8 against
   ``testdata/{conv}_qm9_full_{bf16,int8}.json`` (JAX at the file's
   policy, its bf16 casts rounding each: ``low_bound``, the resident
   path within ``resident_tols`` more), with the int8 grids calibrated on
   the card printed beside the file's; and the padded per-graph oracle
   (``gnn_model.apply``) on 8 graphs against the rows of
   ``apply_packed``;
6. kernel timings at the serving path's shapes: CUDA events, median of
   25 runs of 10 launches queued behind a spin kernel (device time, not
   the host's launch rate) after a warm-up, beside the plain version
   (which synchronises with the host; its time includes that; the median
   of 5 calls, ``PLAIN_TIMING``), one
   PyTorch library call computing the same function where there is one,
   and the bound (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32;
   the H100 SXM data sheet); the segment kernel's pooling set and PNA's
   towers run as one launch each, as the model calls them (their library
   call: one ``scatter_reduce_`` per agg, none with std), and beside it
   each agg alone (rows off the batch's path, not in the summary's
   per-batch sums); the softmax also on phase 3's 3000-edge hub (off the
   path); the resident stack runs as the model calls
   it, at the real layer widths (held first against its plain version
   and against the kernel without widths), its bound counts the work at
   those widths (``stack_work``), and its time stands beside the same
   two layers run layer by layer (``gnn_model._backbone``) and beside the
   kernel without widths; the one-hot kernels at GCN's shapes with
   ``Project``'s default tiles (128, 128), beside the same library call
   and bound as the CSR kernels (one function), and their time per (node
   tile x edge tile) step, the source of ``H100Target.
   kernel_step_overhead``. Then the calls a bf16 or int8 policy makes at
   1024 graphs/batch, at that storage (``storage_timing_phase``): GCN's
   CSR and one-hot gathers (int8 with the grid's step in the scale),
   PNA's towers (one CSR launch a layer, one one-hot launch an agg) and
   the resident stack at the bf16 and int8 precision rows, each bound
   from its own bytes (no library call computes them);
7. ``core.project.Project`` at full width on qm9 graphs
   (``agg_backend="pallas"``): the paper's Listing 1 for GCN (fixed
   ``FPX(16, 10)``, ``gather_mode="onehot"``: testbench MAE < 1.0, the
   program within ``FIXED_GRID_STEPS`` grid steps of the port's CPU run
   with the same weights, the synthesis report); every conv one-hot at
   32 graphs/batch (packed MAE <= 1e-4 against the testbench reference,
   no CSR gather or segment launch inside the generated programs, one
   batch launching exactly ``ONEHOT_LAUNCHES_PER_BATCH``); GCN and SAGE
   at ``fusion_depth=2`` (residency engaged, stack launches); GCN at
   1024 graphs/batch in both gather modes, graphs/s side by side; then
   the same two at ``precision="bf16"`` and ``"int8"``: ``calibrate()``
   (config.json carrying the policy), the testbench's SQNR against its
   fp32 references at least the phase-4 floor, its quantization-error
   report (int8: the weights' too), packed graphs/s and the synthesis
   report's counted bytes beside fp32's (a ratio; bf16's below 1, int8's
   printed: its activation casts outweigh the narrower tables). The
   counts are set to 0 just before each generated program's run and read
   just after; the testbench's fp32 reference runs the default kernels;
8. the three kernels reached through their own entry points
   (``kernels/{gnn_aggregate,tiled_linear,flash_attention}/ops.py``).
   Each against its plain version on the card: the padded-table
   aggregation bit for bit, for every agg in fp32 and bf16 at every
   geometry ``launch_geometry`` chooses for the shape on this card's SMs,
   on 8 and on 1, and through ``block_nodes`` 32 and 128, on the edge
   cases (empty rows, ids >= N and below -1, N = 37, F = 33 and 256,
   N = 1, K = 0, K = 40 at F = 257), the packed table and ``Project``'s
   frame (F = 11, 128, 256); the matmul at the JAX kernel test's
   ragged triples and the GCN transforms, fp32 within 1e-5 and bf16
   within 1e-2 of the output scale, and the tiles of the parallel
   (16, 8) and base (1, 1) designs give the same bits; attention causal
   and not, fp32 at rtol = atol = 1e-4 (also at the qwen3-8b tile shape,
   D = block_q = block_k = 128, causal over 8 KV tiles) and bf16 at rtol
   8e-3, atol 1e-4 (one bf16 rounding step), with ragged S (1500, 100)
   non-causal. The fp32 (SIMT) bodies also at their edges: the matmul
   at every tile ``simt_tile_for`` picks, with ragged M, N and K (K =
   11), and attention at D = 40 / Dv = 24, D = 128 causal over 8 KV
   tiles, Sq != Skv causal and D = 30 (4-byte copies); each fp32 call is
   launched twice and must give the same bits. The bf16 calls of both
   kernels that ``body_for`` sends to the tensor-core (wgmma) body also
   at its edges: the matmul at
   (192, 448) @ (448, 320), at ragged M and K (130, 200) @ (200, 72) and
   at qwen3-8b's up-projection; attention with Sq != Skv under the causal
   mask at D = 128 (300 queries over 700 keys and 700 over 300) and
   whisper's ragged 1500 at D = 64, causal too. The bf16 shapes the
   wgmma body does not take run the SIMT body and are held too: the
   matmul at N = 70 and K = 11, attention at D = 40 and at Dv = 24.
   Each kernel-vs-plain call's body is the one its launch records, and
   must be wgmma for bf16 at the shapes it takes and simt otherwise.
   Each attention call is launched again asking for lse2 (a training
   forward): the output's bits must not change, and lse2 is held to
   ``attention_lse2_ref`` within ``LSE_TOL`` of its scale. Then the
   path once through the entry points at full width, the counts set to 0
   just before and read just after (one launch per call, each output
   against its plain version): the 1024-graph qm9 batch as one padded
   table (F = 64, 128) and ``Project``'s 600-node frame (F = 11, 128,
   256); the GCN transforms at 1024 graphs/batch and the MLP head with
   the tiles of the parallel (16, 8) design, and
   qwen3-8b's MLP up-projection (4096, 4096) @ (4096, 12288) in bf16;
   qwen3-8b's causal prefill attention (32 heads, K/V expanded from 8,
   S = 4096, D = 128, bf16) and whisper-base's encoder attention (B = 4,
   8 heads, S = 1500, D = 64, non-causal, fp32 and bf16). Each call's
   body is read from its wrapper's ``launches_by_body``: every bf16 call
   must have run "wgmma" and every fp32 call "simt". Each call is
   timed as in phase 6, with its body, beside ``torch.matmul`` (TF32 off),
   ``scaled_dot_product_attention`` or, for a sum/mean/max over the
   padded table, ``embedding_bag`` (the table as bags with a padding id,
   held against the plain version too) as its library call, and its bound
   prices bf16 products at the tensor-core peak (989 TFLOP/s);
9. continuous serving on the card (``serve --scheduler continuous``,
   ``runtime.scheduler``), each load a share of the wave drain's graphs/s
   for the same conv and batch size in phase 4 of this call
   (``CONTINUOUS_RUNS``): every conv at full width, 32 graphs/batch, 512
   requests at 0.5x; GCN at 1024 graphs/batch, 8192 requests at 0.5x and
   0.9x; p50/p99, batch fill and sustained graphs/s printed beside the
   wave drain's. Each run: every request ``served_packed``, no failed
   launch, retry or dead letter (an exception inside the served program
   stops the phase at once: ``fail_fast``), the launches of
   ``LAUNCHES_PER_BATCH`` per launch (counts zeroed just before the drain,
   read just after), and every launch's rows bit for bit a re-run of the
   same batch composition through ``apply_packed`` on the card. Then the
   oversize route: GCN at 32 graphs/batch with four giant graphs
   (``--oversize-requests``), through the wave and the continuous drain,
   each ``served_fallback`` by ``apply`` on the card (``ORACLE_LAUNCHES``
   a graph) within ``MODEL_TOL`` of the CPU plain path's ``apply``, with
   the fallback latency per graph. Then a fault-injected measured drain
   (GCN, 32 graphs/batch, ``FAULT_SEED``'s plan of crashes, hangs,
   slowdowns and corrupted outputs, a 50 ms launch timeout, two
   retries): every request one terminal status, each launch's failure
   the fault it took, every corrupted launch caught by the non-finite
   screen and its requests re-run, every served row bit for bit its
   launch's offline re-run. Last, ``tools/chaos_serving.py``'s smoke
   point with lane 0's GAT program on the card and every gate held;
10. the multi-device layer (``launch.mesh``) on the one card: ``DIST_RANKS``
   spawned ranks of one gloo group share it (NCCL needs a card a rank;
   gloo takes the CUDA tensors and stages them through host memory);
   the transport and the rank count are printed. (a) The sharded GCN wave drain
   (``serve.drain_gnn_queue_sharded``, ``gnn_model.make_sharded_apply``)
   on ranks 0 and 1 at full width, ``SHARD_GRAPHS`` qm9 graphs a shard,
   ``SHARD_WAVES`` waves: each rank's launches ``LAUNCHES_PER_BATCH``
   a wave (zeroed just before the drain, read just after), each shard's
   rows bit for bit that rank's single-rank ``apply_packed`` of it. (b)
   The partitioned program (``apply_packed_partitioned``), every conv at
   full width and fp32, on the ``PART_REQUESTS`` oversize graphs of
   ``serve.oversize_graphs`` at ``PART_GRAPHS`` graphs a batch's budgets
   and a ``HUB_IN_EDGES``-in-edge hub, over 2 and ``DIST_RANKS`` ranks:
   GCN and GAT bit for bit the padded oracle ``apply`` on the card, the
   others within ``MODEL_TOL``; each rank's launches ``ORACLE_LAUNCHES``
   a graph, and its ``tiled_matmul`` launches (the row-stable products
   of each rank's part, ``nn.layers.row_stable_products``) the oracle's
   a graph, less the head's on every rank but the root. (c) ``serve
   --shards 2 --dist-backend gloo --oversize-requests 4``: every request
   answered, all four oversize ones ``served_partitioned``. (d) On rank
   0's clock, in turns: the GCN drain's graphs/s at ``SHARD_GRAPHS``
   graphs a shard on rank 0 alone and on two ranks (single, 2, 2,
   single), and ms a graph of the four oversize GCN graphs through the
   padded oracle on rank 0 alone and the partitioned program on 2 and
   ``DIST_RANKS`` ranks, with the card line (ranks that share one card
   time-slice it: no scaling figure);
11. the design-space exploration on the card (``core.dse``,
   ``core.perf_model``). (a) ``dse.build_database(DSE_DESIGNS,
   seed=DSE_SEED, run_testbench=True)``: each design synthesized
   (``Project.run_synthesis``) and its testbench run on the card, its
   launches read around it: every record's ``latency_s``, ``hbm_bytes``,
   ``graphs_per_s`` and ``measured_ms`` finite and positive, every design
   launching its conv's CSR kernels (``dse_expected``: GIN with edge
   features and PNA run no gather) and ``tiled_matmul`` (the padded
   oracle's row-stable fp32 products), and none the kernels its inert
   knobs name (``DSE_INERT``). (b) Every design's timed program (the
   per-graph padded program ``measured_ms`` times) on its testbench
   graphs against the CPU plain path with the same parameters and
   (calibrated) policy, fp32 within ``MODEL_TOL``, bf16 and int8
   within ``low_bound`` (``within``; its fp32 and bf16 products are
   row-stable on both sides); its testbench report gated (fp32 MAE
   within ``MODEL_TOL`` of the references' scale; bf16/int8 SQNR at
   least ``SQNR_FLOOR_DB``, or within ``SQNR_MARGIN_DB`` of the CPU
   plain path's own where that is lower); for the first design of each
   conv its packed program (``torch.matmul`` products) on one batch
   against the CPU plain path's at the same bound, bf16 widened to the
   policy's own largest error against fp32 where that is larger, and the memory
   target (``_measure``'s device peak) on the zero frame
   ``run_synthesis`` reads beside a real graph's frame. (c)
   5-fold CV-MAPE of the latency forest on the modeled (``latency_s``)
   and the measured (``measured_ms``) target and of the memory forest
   (``hbm_bytes``), beside the paper's 36 / 17.5 %: finite, not gated at
   24 designs. (d) ``explore(DSE_CANDIDATES, seed=1)`` under one H100's
   HBM: the winner feasible, its ms an evaluation, then the winner
   synthesized and measured on the card (predicted, modeled and measured
   latency side by side; its timed program held as in (b)), then
   ``objective="p99_latency"`` under ``DEFAULT_SLO``. (e) Fig. 5:
   synthesis seconds a design against model ms an evaluation, in orders
   of magnitude. (f) The phase's wall time against its ``DSE_TARGET_S``
   target.
12. LM serving (``lm_phase``): (a) qwen3-8b at its full config (36
   layers, d 4096, 32/8 heads of 128, vocab 151936; ~8.2e9 parameters,
   bf16, drawn on the card from a seed) through ``serve --arch qwen3-8b
   --batch 4 --prompt-len 128 --gen 32``, every kernel's count set to 0
   just before: ``flash_attention`` launches exactly 36 times at prefill
   and 36 x 32 decoding, all on the wgmma body, no other kernel
   launches, every token in range and every logit finite; tok/s and
   ms/step printed. (a') rwkv6-1.6b at its full config (24 layers, d
   2048, vocab 65536, ~1.6e9 bf16 parameters drawn on the card) through
   ``serve --arch rwkv6-1.6b`` at the same sizes: attention-free, so no
   kernel launches (asserted), every token in range and every logit
   finite; tok/s and ms/step printed. (b) One launch of each distinct
   attention shape (``LM_SHAPES``: qwen3-8b's causal prefill at BH =
   128, S = 128, D = 128, its decode at BH = 32, Sq = 4, Skv = 129 and
   160; ``MLA_SHAPE``: deepseek-v2's MLA prefill from its (c) cut, BH =
   128, S = 64, D = 192, Dv = 128), captured from the runs, launched
   again on the wgmma body against ``attention_ref`` within
   ``ATTN_TOL`` and timed beside its plain version,
   ``scaled_dot_product_attention`` (null, with its error, where SDPA
   refuses) and its bound; the reduced configs whose head sizes are new
   to the kernel (``LM_REDUCED``: D = 16 on wgmma, D = 8 on simt)
   served on the card against the CPU plain path. (c) Full-width models
   cut in depth (``LM_CUTS``: qwen3-8b at 2 layers; llama-3.2-vision-11b
   at one superblock, an ``xattn`` and four ``attn`` rows, over 2048
   image tokens x 1280 with its gates at 0.5; whisper-base whole over
   1500 encoder frames; deepseek-v2-236b at its (mla, mlp) prefix and
   one (mla, moe) repeat of 160 experts; llama4-scout-17b-a16e at 2 of
   48 repeats; jamba-1.5-large-398b at the superblock ((mamba, moe),
   (attn, mlp)) once; rwkv6-1.6b at 2 of 24 layers, and whole at fp32)
   on the card against the CPU plain path with the same parameters fed
   the card's tokens: the prefill's and 4 decode steps' logits within
   ``LM_TOL`` of the logit scale (bf16 2^-5, fp32 1e-4), each card run's ``flash_attention`` launches counted
   (zeroed just before) and held to ``attention_launches``, the MoE
   cuts' least gap between a token's k-th and (k+1)-th router
   probability printed, the host's free memory printed before the jamba
   cut. (d) The depth cuts and the phase's wall time against
   ``LM_TARGET_S``;
13. LM training. (a) The ``flash_attention`` backward (the delta
   launch of ``csrc/flash_attention_bwd.cu``, then dK/dV and dQ by the
   body ``bwd_body_for`` picks: ``csrc/flash_attention_bwd_wgmma.cu``
   or the SIMT body of ``flash_attention_bwd.cu``), from the forward's
   own lse2 (held against ``attention_stats_ref`` within ``LSE_TOL``),
   at ``BWD_SHAPES`` (qwen3-8b's training call, deepseek-v2's MLA at D
   192 / Dv 128, whisper-base's encoder and cross-attention, an fp32
   call, ragged key lengths) against ``attention_bwd_ref`` in fp32 on
   the same inputs within ``BWD_TOL`` (dQ, dK and dV each), a second
   launch bit for bit, the body each ran printed (qwen3-8b's call on
   the wgmma body), timed beside its plain version,
   ``scaled_dot_product_attention``'s forward + backward and its bound
   (``attention_bwd_work``); at qwen3-8b's call the SIMT body too,
   held to the same bound and timed in turns with the wgmma body. (b) qwen3-8b at full width cut to 2 of 36
   layers (bf16, remat "full", fp32 AdamW moments): its first step's
   loss and global gradient norm against the CPU plain path (B 1, S 64)
   within ``TRAIN_TOL``, then 20 steps of ``token_batch`` (B 8, S 512)
   through ``launch.train.run`` (the ``Trainer``; no checkpoint) with
   the kernel counts set to 0 just before and read just after: the loss
   falls (the mean of the last 5 below the first 5's), ms a step (first
   and median), tok/s, peak memory, and the forward and backward
   ``flash_attention`` launches a step held to
   ``train_attention_launches`` (remat runs each layer's forward
   twice). (c) reduced qwen3-8b under
   ``torch.use_deterministic_algorithms(True)`` (cuBLAS's workspace
   fixed by ``CUBLAS_WORKSPACE_CONFIG``, set before torch starts): a
   run that fails at step 13 and resumes from its checkpoint ends bit for
   bit the uninterrupted run's state. (d) The other nine archs at
   reduced(), one train step each on the card against the CPU plain
   path, loss and grad norm within ``TRAIN_TOL``, launches counted.
14. GNN training (``gnn_train_phase``). (a) The backward launches of
   ``mse_loss_packed``'s gradient at ``GNN_PACKED_GRAPHS`` packed qm9
   graphs (GCN, GAT, PNA at ``benchmark_config``), captured and launched
   again: row 1's kernel over the source CSR (dx), the scale gradient
   (``csrc/fused_gather_aggregate_bwd.cu``), the segment aggregation's
   (``csrc/segment_aggregate_bwd.cu``: the pooling set, PNA's towers)
   and the softmax's (``csrc/segment_softmax_bwd.cu``), each against its
   plain version on the same inputs (``SEGMENT_TOL``; bit for bit
   expected and printed, and held for ``BITWISE_BACKWARDS``: the
   segment's at every launch geometry, the scale's at each run of edges
   a warp and by its generic body, which ``SCALE_GENERIC_CASES`` also
   drive at F = 11 and on a misaligned table), a second launch bit for
   bit the first, timed
   beside the plain version, its bound (``kernels/_cost.py``) and a
   library call (``torch.sparse.mm`` of the transposed adjacency for dx,
   ``torch.sparse.sampled_addmm`` for the scale's; none for the other
   two). (b) GCN at ``benchmark_config`` (fp32): its first step's loss,
   gradient norm and every gradient leaf at ``GNN_CHECK_BATCH`` padded
   graphs against the CPU plain path within ``GNN_TRAIN_TOL``, then
   ``GNN_TRAIN_STEPS`` steps of ``make_gnn_train_step`` at
   ``GNN_TRAIN_BATCH`` padded graphs of ``graph_batch`` through the
   ``Trainer``, the counts set to 0 just before: the loss falls (the mean
   of the last 5 below the first 5's), each step's launches are
   ``GCN_STEP_LAUNCHES``; ms a step, graphs/s, the host's batch build and
   the step's stream apart, peak memory, then ``GNN_PROFILE_STEPS``
   steps traced (device busy, idle share, top items). (c) Every conv at
   ``benchmark_config``: one train step at ``GNN_STEP_BATCH`` padded
   graphs and ``mse_loss_packed``'s gradient at ``GNN_PACKED_GRAPHS``
   packed graphs, each against the CPU plain path within
   ``GNN_TRAIN_TOL``. (d) GAT and PNA at reduced() under
   ``torch.use_deterministic_algorithms(True)``: a ``Trainer`` run that
   fails at step ``GNN_FAULT_AT`` and resumes ends bit for bit the
   uninterrupted run's state. (e) bf16 and int8 GNN training (ROADMAP
   item 12e-i): (e-1) the bf16 bodies of rows 2c (bf16 messages) and 1c's
   dscale (a bf16 table) at the calls of ``mse_loss_packed``'s gradient
   at bf16 (GIN's edge sum, PNA's towers at F 128 and 11; GAT's attention
   at F 64 and 128) and on hostile streams (a hub of ``BF16_HUB_EDGES``
   rows or out-edges, a misaligned F 11 table), each bit for bit its
   plain version at every geometry and a second launch the first's, the
   served calls timed beside their bound and the fp32 call of the same
   shape, in turns; (e-2) every conv at ``benchmark_config`` at bf16 and
   int8: (c)'s step (at ``GNN_LOW_STEP_BATCH`` padded graphs) and packed
   gradient against the CPU plain path within ``GNN_TRAIN_TOL`` of the
   policy; (e-3) GCN at bf16 and int8 through
   the ``Trainer`` as in (b): the loss falls, ``GCN_STEP_LAUNCHES`` and
   ``GCN_STEP_GATHERS`` (int8 reads the fp32 fake-quant grid where the
   gradient flows), beside (b)'s fp32 figures. The counts are set to 0
   after (e-1) and read after (e-3): every one of rows 1-3 (and row 1's
   dx), row 8b, the three backward kernels and the bf16 bodies of 1c and
   2c launched on the training path. (f) (ROADMAP item 12e-ii) a user's
   conv that aggregates by max or min, registered for (f) alone
   (``MINMAX_CONVS``: GraphSAGE with the max and the min aggregator, and
   GAT's attention aggregated by max, whose weights take the scale
   gradient): (f-1) the min/max gather's backward kernels (row 1d: the
   tie weights, dx, the masked scale gradient) at the calls of the three
   convs' packed gradients at 1024 graphs, fp32 and bf16, and on hostile
   streams (a hub of ``BF16_HUB_EDGES`` tied in-edges and one of as many
   out-edges, F 11 misaligned, F 130, a bf16 table, negative scales,
   empty segments, bad ids), each bit for bit its plain version at every
   geometry and across two launches, timed beside its bound and plain
   version, and each gather's whole backward timed in turns beside the
   sum gather's backward of the same shape and ``scatter_reduce_``'s
   forward and backward; (f-2) each conv at ``MINMAX_POLICIES``: (e-2)'s
   step and packed gradient against the CPU within ``GNN_TRAIN_TOL``;
   (f-3) sage_max through the ``Trainer``, 20 steps at
   ``MINMAX_TRAIN_BATCH`` frames: the loss falls, ``MINMAX_STEP_LAUNCHES``
   a step. The counts are set to 0 after (f-1) and read after (f-3): the
   three kernels and their bf16 bodies launched, added to (b)-(e)'s.

The last lines are the card, the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``. Each of the six model-path kernels'
entries also carries ``launches_by_precision`` (the launches of the
fp32, bf16 and int8 programs) and ``by_storage`` (phase 6's bf16 and
int8 rows, summed; the softmax is fp32 at every policy); every entry
carries ``launches_by_phase["11"]``, the DSE's launches, and
``launches_by_phase["12"]``, the LM path's (in ``launches``: (a)'s
serving run and (c)'s card runs); ``flash_attention``'s also
``lm_launches_by_body`` ((a)'s), ``lm_cut_launches`` ((c)'s by arch),
``lm_calls`` (phase 12 (b)'s rows), ``lm_serving`` and
``lm_serving_rwkv6`` (tok/s, ms/step, the first and the median step,
prefill ms of (a) and (a')). Every entry carries
``launches_by_phase["13"]``: ``flash_attention``'s forward launches on
the training path ((b) and (d), remat's recomputations included). The
entries ``flash_attention_backward`` (the delta launch and the SIMT
body) and ``flash_attention_backward_wgmma`` (the tensor-core body)
sum phase 13 (a)'s calls of their body and count their body's dK/dV
and dQ launches in (b) and (d) (the first also ``delta_launches``, one
a backward call); the first's ``training`` key holds (b)'s, (c)'s and
(d)'s readings. Every entry carries
``launches_by_phase["14"]``: the GNN training path's launches of rows
1-3 and 8b (row 1's with its dx launches, whose (a) readings are its
``backward_dx``; its ``gnn_training`` holds phase 14's (b)-(e)
readings); the last three entries, ``gather_scale_backward``,
``segment_aggregate_backward`` and ``segment_softmax_backward``, sum
phase 14 (a)'s calls and count their launches on that path; the first
two carry ``by_storage["bf16"]``, their bf16 body's (e-1) calls summed
(with the fp32 calls of the same shapes, timed in turns) and its
launches on the training path. The entries ``gather_tie_weights``,
``gather_minmax_dx`` and ``gather_minmax_scale_backward`` (row 1d) sum
phase 14 (f-1)'s fp32 calls (their bf16 calls in ``by_storage["bf16"]``)
and count their launches in (f-2) and (f-3); the first also carries
``backward_turns``, each gather's whole backward beside the sum
gather's and ``scatter_reduce_``'s.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic under torch.use_deterministic_algorithms only
# with a fixed workspace, read when it first runs (phase 13 (c)); this is
# the size torch takes on Hopper by default
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.convs import PNA_AGGS  # noqa: E402
from repro_torch.kernels._cost import (  # noqa: E402
    FP32_FLOPS_PER_S, HBM_BYTES_PER_S, TC_BF16_FLOPS_PER_S,
    gather_onehot_work, gather_work, nbytes, segment_onehot_work,
    segment_work, softmax_work, stack_work)

SEGMENT_TOL = dict(rtol=1e-5, atol=1e-6)
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
STORAGE = (torch.float32, torch.bfloat16, torch.int8)

KERNELS = ("fused_gather_aggregate", "segment_aggregate", "segment_softmax",
           "fused_layer_stack", "fused_gather_onehot",
           "segment_aggregate_onehot")
# kernel launches per served batch of apply_packed, in KERNELS order
LAUNCHES_PER_BATCH = {
    "gcn": (2, 1, 0, 0, 0, 0),   # a scaled gather per layer; pooling
    "sage": (2, 1, 0, 0, 0, 0),  # a mean gather per layer; pooling
    "gin": (0, 3, 0, 0, 0, 0),   # an edge-message sum per layer; pooling
    "pna": (0, 3, 0, 0, 0, 0),   # the four towers per layer; pooling
    "gat": (2, 1, 2, 0, 0, 0),   # a softmax and a weighted gather per layer
}
# the agg sets one segment_aggregate launch folds on the serving path
# (the pooling set add/mean/max; PNA's four towers), and all six, which
# phase 3 launches beside the single-agg calls
POOLING_AGGS = ("sum", "mean", "max")
MULTI_AGGS = (POOLING_AGGS, PNA_AGGS,
              ("sum", "mean", "min", "max", "var", "std"))
# the same batch under aggregation_scope(gather_mode="onehot")
# (Project(agg_backend="pallas", gather_mode="onehot")): the gathers and
# segment aggregations move to the one-hot kernels, one launch per agg
# (a pooling set is three, PNA's towers four a layer); GAT keeps its
# softmax
ONEHOT_LAUNCHES_PER_BATCH = {
    "gcn": (0, 0, 0, 0, 2, 3),
    "sage": (0, 0, 0, 0, 2, 3),
    "gin": (0, 0, 0, 0, 0, 5),
    "pna": (0, 0, 0, 0, 0, 11),
    "gat": (0, 0, 2, 0, 2, 3),
}
# per batch of apply_packed_resident(fusion_depth=2) when the plan is
# legal: both layers in one stack launch, then the pooling
RESIDENT_LAUNCHES = (0, 1, 0, 1, 0, 0)
RESIDENT_CONVS = ("gcn", "sage")
RESIDENT_BATCHES = (32, 256, 1024)
# the columns-a-lane caps (gather_geometry(..., max_cols=)) phase 3
# launches the CSR gather at, beside its default geometry
GATHER_CAPS = (1, 2, 4, 8)
# the one-hot kernels' tiles (node_block, edge_block) phase 3 launches
ONEHOT_TILES = tuple((nb, eb) for nb in (32, 64, 128) for eb in (64, 128, 256))
ONEHOT_DEFAULT_TILES = (128, 128)     # Project's node_block, edge_block
# fixed-point outputs of the card against the CPU: FPX(16, 10) rounds
# after every layer, so a sum in another order (cuBLAS against the CPU's
# BLAS) can land a value on the neighbouring grid point, and a later
# layer's rounding of a value so moved can move it one step more
FIXED_GRID_STEPS = 2
# how phase 6 times a plain version: few calls, since they are slow (3 to
# 20 ms at the served shapes, 1.5 s on the 3000-edge hub) and stand
# beside the kernels only for scale; each synchronises with the host
PLAIN_TIMING = dict(reps=5, inner=1, device_only=False)
# the scatter_reduce_ reduction of each agg, the library yardstick of the
# segment kernels (var/std have none)
LIB_REDUCE = {"sum": "sum", "mean": "mean", "min": "amin", "max": "amax",
              "var": None, "std": None}
NO_LIBRARY = {
    "segment_softmax": "no single PyTorch call computes a per-segment "
                       "softmax",
    "fused_layer_stack": "no single PyTorch call computes a GCN/SAGE "
                         "layer stack",
    "gnn_aggregate": "no library call computes Welford var/std over a "
                     "padded neighbour table (sum, mean and max are "
                     "timed against F.embedding_bag)",
}
# the resident kernel's precision rows [mode, s, lo, hi] and tolerances
# on the output scale, max|err| <= rtol * max|plain| + atol: fp32 the
# products sum in another order; bf16 a product summed in another order
# can round to the neighbouring bf16 value, one ulp (at most 2^-7 of the
# value, so under 1e-2 of the output scale); int8 one grid step. A bf16
# or int8 output must also differ from the fp32 one on the same inputs,
# so that a kernel ignoring the precision row fails.
INT8_S = 2.0 ** -5
QP_ROWS = {"fp32": (0.0, 1.0, 0.0, 0.0), "bf16": (1.0, 1.0, 0.0, 0.0),
           "int8": (2.0, INT8_S, -128 * INT8_S, 127 * INT8_S)}
STACK_TOL = {"fp32": (1e-5, 1e-6), "bf16": (1e-2, 1e-3),
             "int8": (5e-2, 1.05 * INT8_S)}
# the resident path against apply_packed on the card: 1e-5 of the output
# scale (the same fp32 math, aggregated first at the padded width)
RESIDENT_RTOL = 1e-5
# the precision policies phases 4, 5 and 7 serve, and phase 6's storage
# widths of the gather and segment tables beside fp32
PRECISIONS = ("fp32", "bf16", "int8")
LOW_PRECISIONS = ("bf16", "int8")
# SQNR floors of a full-width low-precision output against the fp32
# program of the same call (docs/KERNELS.md's precision table)
SQNR_FLOOR_DB = {"bf16": 30.0, "int8": 10.0}
# (conv, graphs/batch) of phase 4's int8 drains where the JAX package's
# own int8 output, on the serving weights and the warm-up batch with the
# grids calibrated there, is below the int8 floor against its fp32
# output: its SQNR in dB (tests/test_torch_precision_reference.py
# recomputes it). There the card must come within SQNR_MARGIN_DB of it
INT8_REF_SQNR_DB = {("gin", 32): 7.9798, ("gin", 1024): 7.1548}
SQNR_MARGIN_DB = 1.0
# a low-precision model output against another implementation of the
# same policy (the CPU plain path, the JAX golden output), on the output
# scale: bf16 2^-7 of it (a product or sum rounded to bf16 on the other
# side of a boundary, carried on by the later layers) + 1e-4; int8 1e-4
# of it + 1.05 steps of the head's grid (a value on the other side of a
# grid boundary moves one step)
BF16_RTOL = 2.0 ** -7
LOW_ATOL = 1e-4
INT8_RTOL = 1e-4
# requests of the low-precision drains at 32 and 1024 graphs/batch (8 and
# 4 measured batches) and of the low-precision resident drains (4
# measured batches at each size)
LOW_DRAINS = ((256, 32), (4096, 1024))
LOW_RESIDENT_BATCHES = 4


def low_bound(precision: str, want: torch.Tensor, policy) -> float:
    """``BF16_RTOL``/``INT8_RTOL`` bound of a low-precision output."""
    scale = float(want.abs().max())
    if precision == "bf16":
        return BF16_RTOL * scale + LOW_ATOL
    return INT8_RTOL * scale + 1.05 * policy.head.act_fpx.resolution


def resident_tols(precision: str, policy) -> tuple:
    """(rtol on the output scale, atol) of the resident path against
    ``apply_packed`` at the same policy: fp32 ``RESIDENT_RTOL``; bf16 and
    int8 the JAX package's ``_resident_tols`` (tests/test_gather_v2.py):
    the resident stack aggregates first at the padded width, so a bf16
    rounding lands elsewhere (5e-2, 1e-2), and an int8 grid boundary can
    move one step of the head's input grid."""
    if precision == "fp32":
        return RESIDENT_RTOL, 0.0
    if precision == "bf16":
        return 5e-2, 1e-2
    fpx = policy.head.in_fpx or policy.head.act_fpx
    return 5e-2, 1.05 * fpx.resolution


def grids(policy) -> str:
    """The int8 grids of a policy, layer by layer, then the head's."""
    if policy.name != "int8":
        return "no grids"
    layers = ", ".join(str(lp.act_fpx) for lp in policy.layers)
    h = policy.head
    return (f"acts [{layers}], weights "
            f"[{', '.join(str(lp.weight_fpx) for lp in policy.layers)}], "
            f"head in {h.in_fpx} hidden {h.act_fpx} weights {h.weight_fpx}")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def counters() -> dict:
    """The launch counter of each kernel's wrapper, by kernel name."""
    from repro_torch.kernels.fused_gather_aggregate.ops import (
        fused_gather_aggregate, fused_gather_onehot)
    from repro_torch.kernels.segment_aggregate.ops import (
        segment_aggregate, segment_aggregate_onehot)
    from repro_torch.kernels.segment_softmax.ops import segment_softmax
    from repro_torch.kernels.fused_layer_stack.ops import fused_layer_stack
    return dict(zip(KERNELS, (fused_gather_aggregate, segment_aggregate,
                              segment_softmax, fused_layer_stack,
                              fused_gather_onehot, segment_aggregate_onehot)))


def zero_counts() -> dict:
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def cuda_ms(fn, reps: int = 25, inner: int = 10,
            device_only: bool = True) -> float:
    """Median per-launch time of ``fn`` over ``reps`` runs of ``inner``
    back-to-back launches, timed with CUDA events after a warm-up.

    ``device_only``: the stream first runs a spin kernel
    (``torch.cuda._sleep``) long enough for the host to enqueue all
    ``inner`` launches behind it, so the events time the launches back
    to back on the device, not the host's rate of launching them (a small
    kernel's Python wrapper takes longer to launch than the kernel runs).
    The spin is lengthened until it outlasts the host's enqueue time; a
    ``fn`` that never falls behind it synchronises with the host and
    raises, so a kernel or library row is always device time. A ``fn``
    that synchronises by design (the plain versions read a segment depth)
    is timed with ``device_only=False``: its time then includes those
    host round trips."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1_000_000
    times = []
    while len(times) < reps:
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin.record()
        if device_only:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if device_only and spin.elapsed_time(start) < 1.5 * host_ms:
            cycles *= 4             # the device caught up with the host
            # the host waited on the device: fn synchronises
            check(cycles <= 1_000_000_000,
                  "a call timed as device time synchronises with the host")
            continue
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(bytes_moved: int, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def captured_softmax_inputs():
    """Record the (logits, perm, offsets) of every segment-softmax call
    the model makes inside the block (GAT: one per layer)."""
    from repro_torch.core import aggregations as A
    calls = []
    real = A._segment_softmax

    def capture(logits, perm, offsets):
        calls.append((logits.clone(), perm, offsets))
        return real(logits, perm, offsets)

    A._segment_softmax = capture
    try:
        yield calls
    finally:
        A._segment_softmax = real


@contextlib.contextmanager
def captured_stack_inputs():
    """Record the (args, kwargs) of every resident-stack call the model
    makes inside the block."""
    from repro_torch.core import gnn_model as G
    calls = []
    real = G.fused_layer_stack

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    G.fused_layer_stack = capture
    try:
        yield calls
    finally:
        G.fused_layer_stack = real


def resident_stack_inputs(dev, conv: str, batch) -> tuple:
    """The resident stack's (args, kwargs) on one packed batch: the
    full-width model with the weights ``launch.serve`` draws, both layers
    in one launch (fusion_depth 2)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    cfg = benchmark_config(conv)
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    with captured_stack_inputs() as calls, torch.inference_mode():
        G.apply_packed_resident(params, cfg, G.packed_to_device(batch, dev),
                                fusion_depth=2)
    check(len(calls) == 1, f"{conv}: {len(calls)} resident stack calls, "
                           "expected one for both layers")
    return calls[0]


def gat_softmax_inputs(dev, batch) -> list:
    """Both GAT layers' softmax inputs on one packed batch, at the full
    width and with the weights ``launch.serve`` draws."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    cfg = benchmark_config("gat")
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    with captured_softmax_inputs() as calls, torch.inference_mode():
        G.apply_packed(params, cfg, G.packed_to_device(batch, dev))
    check(len(calls) == cfg.gnn_num_layers,
          f"GAT made {len(calls)} softmax calls, expected one per layer")
    return calls


# ----------------------------------------------------------- phase 3 --
def storage(x: torch.Tensor, dtype: torch.dtype,
            rng: np.random.Generator) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.as_tensor(rng.integers(-128, 128, tuple(x.shape)),
                               dtype=torch.int8, device=x.device)
    return x.to(dtype).contiguous()


def compare(name: str, agg: str, got: torch.Tensor, want: torch.Tensor,
            errs: dict) -> float:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[both].abs().max()) if both.any() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if agg in ("min", "max"):
        check(torch.equal(got, want), f"{name} {agg}: not exact, max "
                                      f"|err| {err}")
    else:
        # +-inf/NaN (sums of the +-3e38 rows) must sit at the same places
        check(torch.allclose(got, want, equal_nan=True, **SEGMENT_TOL),
              f"{name} {agg}: max |err| {err} outside {SEGMENT_TOL}")
    return err


def compare_softmax(label: str, got: torch.Tensor, want: torch.Tensor,
                    errs: dict) -> None:
    name = "segment_softmax"
    check(got.shape == want.shape, f"{name} {label}: shape "
                                   f"{tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite "
                                           "weight")
    check(not got[want == 0].any(), f"{name} {label}: nonzero weight "
                                    "where the plain version gives 0")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    check(torch.allclose(got, want, **SOFTMAX_TOL),
          f"{name} {label}: max |err| {err} outside {SOFTMAX_TOL}")


ADVERSARIAL = ("hub", "one tile", "reversed", "all dropped", "S=1",
               "S ragged")


def adversarial_streams(kind: str, rng) -> tuple:
    """(n_src, num_segments, src, dst) int32 numpy streams that stress
    the one-hot kernels' bucketing: a hub destination of ~1125 edges,
    every edge into one node tile, a reversed (descending) stream, every
    edge dropped (bad src or bad dst), one segment (~500 edges), and a
    segment count that no tile divides. The hub and the one segment take
    1500 edges where the others take 6000: their plain versions fold
    them edge by edge, the longest part of phase 3."""
    n, s = 300, 300
    e = 1500 if kind in ("hub", "S=1") else 6000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s, e)
    if kind == "hub":
        dst[rng.random(e) < 0.75] = 5
    elif kind == "one tile":
        dst = rng.integers(0, 20, e)
    elif kind == "reversed":
        dst = np.sort(dst)[::-1].copy()
    elif kind == "all dropped":
        src[::2] = -1
        dst[1::2] = s + rng.integers(0, 5, len(dst[1::2]))
    elif kind == "S=1":
        s = 1
        dst = rng.integers(-1, 2, e)
    elif kind == "S ragged":
        s, e = 301, 4001
        src, dst = src[:e], rng.integers(0, s, e)
        dst[-1] = s - 1
    src[:3] = [-1, n, n + 9]
    return n, s, src.astype(np.int32), dst.astype(np.int32)


def gather_cases(dev, rng, path_batches):
    """(label, x fp32, src, dst, scale, n_src, num_segments) streams."""
    from repro_torch.core import gnn_model as G
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    cases = []
    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, _, _ = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        for f in (11, 64, 128):
            x = torch.randn((n, f), device=dev)
            cases.append((f"{label} F={f}", x, ei[:, 0], ei[:, 1],
                          g["gcn_edge_scale"], n, n))
        # GAT: softmax weights in the scale slot
        csr = g["edge_csr"]
        alpha = segment_softmax_ref(torch.randn(ei.shape[0], device=dev) * 3,
                                    csr.perm, csr.offsets)
        x = torch.randn((n, 128), device=dev)
        cases.append((f"{label} alpha F=128", x, ei[:, 0], ei[:, 1], alpha,
                      n, n))
    # edge cases: a prime edge count, -1 / out-of-range ids on each
    # stream, empty segments, a one-edge segment, large and negative
    # values, no scale
    n, s, e, f = 300, 257, 1009, 37
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s - 2, e)          # segments s-2, s-1: special
    src[:8] = [-1, n, n + 5, -7, 0, 1, 2, 3]
    dst[4:8] = [-1, s, s + 9, -3]
    dst[8] = s - 1                            # the only edge into s-1
    dst[dst == 5] = 6                         # segment 5 empty
    x = torch.as_tensor(rng.standard_normal((n, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[7, :5] = torch.tensor([1e30, -1e30, 3e38, -3e38, -1e-30])
    scale = torch.as_tensor(rng.uniform(0.25, 2.0, e), dtype=torch.float32,
                            device=dev)
    src_t = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst_t = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, src_t, dst_t, scale, n, s))
    cases.append(("edge cases, no scale", x, src_t, dst_t, None, n, s))
    for kind in ADVERSARIAL:
        n, s, src, dst = adversarial_streams(kind, rng)
        x = torch.as_tensor(rng.standard_normal((n, 37)) * 3,
                            dtype=torch.float32, device=dev)
        scale = torch.as_tensor(rng.uniform(0.25, 2.0, len(src)),
                                dtype=torch.float32, device=dev)
        cases.append((f"adversarial: {kind}", x,
                      torch.as_tensor(src, device=dev),
                      torch.as_tensor(dst, device=dev), scale, n, s))
    return cases


def segment_cases(dev, rng, path_batches):
    """(label, messages fp32, seg ids, valid, num_segments, storage
    types) streams."""
    cases = []
    for label, batch in path_batches:
        gid = torch.as_tensor(batch["node_graph_id"], device=dev)
        ng = batch["graph_valid"].shape[0]
        for f in (11, 64, 128):
            x = torch.randn((gid.numel(), f), device=dev)
            cases.append((f"{label} pooling F={f}", x, gid, gid < ng, ng,
                          STORAGE))
        # PNA's towers and GIN's edge sum: edge messages by destination
        ei = torch.as_tensor(batch["edge_index"], device=dev)
        n = gid.numel()
        for f in (11, 128):
            x = torch.randn((ei.shape[0], f), device=dev)
            cases.append((f"{label} edge messages F={f}", x, ei[:, 1],
                          ei[:, 0] >= 0, n, (torch.float32,)))
    e, s, f = 1009, 97, 40
    seg = rng.integers(0, s - 2, e)           # non-contiguous ids
    seg[:4] = [-1, s, s + 7, -5]
    seg[4] = s - 1                            # one-row segment
    seg[seg == 3] = 4                         # segment 3 empty
    x = torch.as_tensor(rng.standard_normal((e, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[9, :4] = torch.tensor([1e30, -1e30, 3e38, -3e38])
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, seg_t, None, s, STORAGE))
    # Welford: near-equal values in every segment
    near = 1000.0 + 1e-3 * torch.as_tensor(
        rng.standard_normal((e, f)), dtype=torch.float32, device=dev)
    cases.append(("welford near-equal", near, seg_t, None, s,
                  (torch.float32,)))
    # F = 256: the one-hot kernel's Welford tables at node_block 128 need
    # 256 KiB, so its columns split over a second grid axis
    wide = torch.as_tensor(rng.standard_normal((e, 256)) * 3,
                           dtype=torch.float32, device=dev)
    cases.append(("F=256", wide, seg_t, None, s, (torch.float32,)))
    for kind in ADVERSARIAL:
        n, s, src, seg = adversarial_streams(kind, rng)
        # a row whose source id is bad is dropped too
        seg = np.where((src >= 0) & (src < n), seg, -1).astype(np.int32)
        x = torch.as_tensor(rng.standard_normal((len(seg), 40)) * 3,
                            dtype=torch.float32, device=dev)
        cases.append((f"adversarial: {kind}", x,
                      torch.as_tensor(seg, device=dev), None, s, STORAGE))
    return cases


def softmax_cases(dev, rng, path_batches):
    """(label, logits, perm, offsets) streams: both GAT layers' inputs
    at each serving shape, then the edge cases."""
    from repro_torch.core import aggregations as A
    cases = []
    for label, batch in path_batches:
        for layer, (z, perm, off) in enumerate(gat_softmax_inputs(dev,
                                                                  batch)):
            cases.append((f"{label} GAT layer {layer} E={z.numel()}", z,
                          perm, off))
    e, s = 5003, 257                          # a prime edge count
    seg = rng.integers(0, s - 2, e)           # segments s-2, s-1: special
    seg[rng.choice(e, 3000, replace=False)] = 11   # a 3000-edge segment
    seg[seg == 4] = 5                         # segment 4 empty
    seg[:4] = [-1, s, s + 3, -9]              # padding ids
    seg[4] = s - 1                            # the only edge into s-1
    z = rng.standard_normal(e).astype(np.float32) * 6
    z[::97] = 1e4
    z[1::89] = -1e4
    z[2::53] = -np.inf                        # masked slots
    z[seg == 9] = -np.inf                     # an all -inf segment
    valid = rng.random(e) < 0.9
    z_t = torch.as_tensor(z, device=dev)
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    for tag, v in (("", None), (", valid mask",
                                torch.as_tensor(valid, device=dev))):
        csr = A.build_csr(seg_t, s, v)
        cases.append((f"edge cases{tag}", z_t, csr.perm, csr.offsets))
    return cases


def compare_stack(label: str, mode: str, got: torch.Tensor,
                  want: torch.Tensor, errs: dict) -> None:
    name = "fused_layer_stack"
    check(got.shape == want.shape, f"{name} {label}: shape "
                                   f"{tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
    err = float((got - want).abs().max())
    for key in (name, f"{name} {mode}"):
        errs[key] = max(errs.get(key, 0.0), err)
    rtol, atol = STACK_TOL[mode]
    bound = rtol * float(want.abs().max()) + atol
    check(err <= bound, f"{name} {label}: max |err| {err} > {bound} "
                        f"({mode}: rtol {rtol}, atol {atol})")


def stack_edge_cases(dev, rng):
    """(label, args, K) synthetic stacks: a hub row with 1200 in-edges
    (past two of the kernel's ``kEdgeCap`` = 512-edge chunks; the plain
    version folds it edge by edge, and the stack's plain calls took most
    of phase 3 with 3000), -1 /
    out-of-range / negative ids on each stream, N = 1001 (not a multiple
    of the 32-row tile), widths 96 and 160 (a partial column pass), 1
    and 4 layers, and an edgeless stack."""
    from repro_torch.core import aggregations as A
    n, e = 1001, 5000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[:4] = [-1, n, n + 7, -3]
    dst[4:8] = [-1, n, n + 2, -9]
    dst[rng.choice(np.arange(8, e), 1200, replace=False)] = 5     # hub
    cases = []
    for f, k, edges in ((96, 1, True), (160, 4, True), (128, 2, False)):
        s = src if edges else np.full(e, -1)
        src_t = torch.as_tensor(s, dtype=torch.int32, device=dev)
        dst_t = torch.as_tensor(dst, dtype=torch.int32, device=dev)
        csr = A.gather_csr(src_t, dst_t, n, n)

        def t(*shape, scale=1.0):
            return torch.as_tensor(rng.standard_normal(shape) * scale,
                                   dtype=torch.float32, device=dev)
        args = (t(n, f, scale=2.0), src_t,
                torch.as_tensor(rng.uniform(0.2, 1.5, e) / 40,
                                dtype=torch.float32, device=dev),
                csr.perm, csr.offsets,
                torch.as_tensor(rng.uniform(0.1, 1.0, n),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.random(n) < 0.9, dtype=torch.float32,
                                device=dev),
                t(k, f, f, scale=f ** -0.5), t(k, f, f, scale=f ** -0.5),
                t(k, f, f, scale=f ** -0.5), t(k, f, scale=0.1),
                torch.zeros((k, 4), device=dev))
        tag = "hub of 1200, bad ids" if edges else "no edges"
        cases.append((f"{tag}, N={n} F={f} K={k}", args, k))
    return cases


# real layer widths of stack_edge_cases, by (F, K): ragged ones (90, 61,
# 150, 37, 5: no multiple of 4) and ones as wide as the table
EDGE_WIDTHS = {(96, 1): [(90, 61)],
               (160, 4): [(150, 160), (160, 37), (37, 100), (100, 5)],
               (128, 2): [(11, 128), (128, 64)]}


def stack_vs_plain(dev, resident_batches, errs: dict) -> int:
    """The resident stack kernel against its plain version: both kinds x
    the three precision rows x skip on/off, each without and with real
    layer widths (``widths=``), at the serving path's shapes (both layers
    of the full-width model, K = 2, at 32, 256 and 1024 graphs/batch, at
    the model's widths 11 -> 128 -> 64 as ``apply_packed_resident`` calls
    it, and there also the kernel with widths against the kernel without,
    the weights being zero outside them) and on the edge cases (at
    ``EDGE_WIDTHS``); then every activation (fp32) on the first edge
    case, without and with its widths."""
    from repro_torch.kernels.fused_layer_stack.kernel import (
        ACT_CODES, fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)

    rng = np.random.default_rng(5)
    cases = []
    for label, batch in resident_batches:
        for conv in RESIDENT_CONVS:
            args, kw = resident_stack_inputs(dev, conv, batch)
            cases.append((f"{conv} {label}", conv, args, kw["widths"],
                          True))
    edge_cases = stack_edge_cases(dev, rng)
    for label, args, k in edge_cases:
        for conv in RESIDENT_CONVS:
            cases.append((f"{conv} {label}", conv, args,
                          EDGE_WIDTHS[args[0].shape[1], k], False))
    n_cmp = 0
    label, args, k = edge_cases[0]
    full = args[:11] + (torch.tensor([QP_ROWS["fp32"]] * k, device=dev),)
    for act in ACT_CODES:
        for kind in RESIDENT_CONVS:
            for widths in (None, EDGE_WIDTHS[args[0].shape[1], k]):
                got = fused_layer_stack_cuda(*full, kind=kind,
                                             activation=act, widths=widths)
                want = fused_layer_stack_ref(*full, kind=kind,
                                             activation=act, widths=widths)
                compare_stack(f"{kind} {label} {act} widths {widths}",
                              "fp32", got, want, errs)
                n_cmp += 1
    for label, kind, args, widths, zero_padded in cases:
        k = args[8].shape[0]
        for skip in (True, False):
            fp32_out = {}
            for mode, row in QP_ROWS.items():     # fp32 first
                qp = torch.tensor([row] * k, dtype=torch.float32,
                                  device=dev)
                full = args[:11] + (qp,)
                outs = []
                for wi, wd in enumerate((None, widths)):
                    got = fused_layer_stack_cuda(*full, kind=kind,
                                                 has_skip=skip, widths=wd)
                    want = fused_layer_stack_ref(*full, kind=kind,
                                                 has_skip=skip, widths=wd)
                    tag = f"{label} {mode} skip={skip} widths {wd}"
                    compare_stack(tag, mode, got, want, errs)
                    if wi not in fp32_out:
                        fp32_out[wi] = got
                    else:
                        check(not torch.equal(got, fp32_out[wi]),
                              f"fused_layer_stack {tag}: equals the fp32 "
                              "output, the precision row was ignored")
                    outs.append(got)
                    n_cmp += 1
                if zero_padded:
                    compare_stack(f"{label} {mode} skip={skip}: widths "
                                  "against none", mode, outs[1], outs[0],
                                  errs)
                    n_cmp += 1
    return n_cmp


# the streaming form's check: the destinations of the 32-graph batch with
# the most incoming edges, and its tolerance against the CSR kernel (the
# same Welford fold, its operations in another order of launches)
STREAM_DESTINATIONS = 8
STREAM_TOL = 1e-5


def stream_vs_segment(dev, batch, rng) -> int:
    """``aggregations.aggregate_stream`` (the streaming form, a loop of
    updates on the card) against the CSR segment kernel, every agg, over
    the ``STREAM_DESTINATIONS`` destinations of ``batch`` with the most
    incoming valid edges: each destination's rows in stream order, the
    kernel's row within ``STREAM_TOL``."""
    from repro_torch.core import aggregations as A
    from repro_torch.kernels.segment_aggregate.kernel import (
        AGGS as SEGMENT_AGGS, segment_aggregate_cuda)

    ei = torch.from_numpy(batch["edge_index"]).to(dev)
    n = batch["node_feat"].shape[0]
    msgs = torch.from_numpy(rng.standard_normal(
        (ei.shape[0], 64)).astype(np.float32)).to(dev)
    csr = A.build_csr(ei[:, 1], n, ei[:, 0] >= 0)
    deg = csr.offsets[1:] - csr.offsets[:-1]
    dests = torch.argsort(deg, descending=True, stable=True)[
        :STREAM_DESTINATIONS].tolist()
    off = csr.offsets.tolist()
    worst = 0.0
    for agg in SEGMENT_AGGS:
        out = segment_aggregate_cuda(msgs, csr.perm, csr.offsets, agg=agg)
        for d in dests:
            rows = msgs[csr.perm[off[d]:off[d + 1]].long()]
            got = A.aggregate_stream(agg, rows)
            check(got.device == msgs.device and got.dtype == torch.float32,
                  f"aggregate_stream {agg}: {got.dtype} on {got.device}")
            err = float((got - out[d]).abs().max())
            check(err <= STREAM_TOL,
                  f"aggregate_stream {agg} at destination {d} "
                  f"({off[d + 1] - off[d]} edges): max |err| {err} against "
                  f"segment_aggregate, above {STREAM_TOL}")
            worst = max(worst, err)
    print(f"[3] aggregate_stream on the card against segment_aggregate, "
          f"every agg, over the {len(dests)} destinations with the most "
          f"incoming edges ({[off[d + 1] - off[d] for d in dests]}): max "
          f"|err| {worst:.3e} (tolerance {STREAM_TOL})")
    return len(SEGMENT_AGGS) * len(dests)


def kernels_vs_plain(dev, path_batches, resident_batches) -> dict:
    from repro_torch.core import aggregations as A
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        AGGS as GATHER_AGGS, fused_gather_aggregate_cuda,
        fused_gather_onehot_cuda, gather_geometry)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        AGGS as SEGMENT_AGGS, segment_aggregate_cuda,
        segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.segment_softmax.kernel import (
        segment_softmax_cuda)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref

    rng = np.random.default_rng(3)
    errs: dict = {}
    n_cmp = 0

    def onehot_vs(name, agg, launch, want, csr_out, fp32, label):
        """A one-hot kernel at every tile pair against its plain version
        (``want``) and, in fp32, bit for bit against the CSR kernel's
        output (NaN payloads included)."""
        for nb, eb in ONEHOT_TILES:
            got = launch(eb, nb)
            compare(name, agg, got, want, errs)
            if fp32:
                check(torch.equal(got.view(torch.int32),
                                  csr_out.view(torch.int32)),
                      f"{name} {label} {agg} tiles ({nb}, {eb}): not bit "
                      "for bit the CSR kernel's output")
        return len(ONEHOT_TILES)

    def gather_layouts(xt, src32, sc, csr, agg, base, label):
        """The CSR gather at every columns-a-lane cap (``GATHER_CAPS``)
        and at the default geometry on one SM (a warp walks its
        destinations in series), and on a row-offset view of x one
        element into its buffer (the wrapper caps the columns a lane by
        its alignment), and with either batch of edges in flight forced:
        each bit for bit the default launch ``base``, NaN payloads
        included."""
        s = csr.offsets.numel() - 1
        n, f = xt.shape
        shape = (s, f, xt.element_size())
        geometries = [gather_geometry(*shape, sms, max_cols=c)
                      for c in GATHER_CAPS] + [gather_geometry(*shape, 1)]
        view = torch.empty(n * f + 1, dtype=xt.dtype, device=xt.device)[
            1:].view(n, f)
        view.copy_(xt)
        outs = [(g, fused_gather_aggregate_cuda(
            xt, src32, sc, csr.perm, csr.offsets, agg=agg, geometry=g))
            for g in geometries]
        outs.append(("a row-offset view", fused_gather_aggregate_cuda(
            view, src32, sc, csr.perm, csr.offsets, agg=agg)))
        outs += [(f"deep={deep}", fused_gather_aggregate_cuda(
            xt, src32, sc, csr.perm, csr.offsets, agg=agg, deep=deep))
            for deep in (False, True)]
        for how, got in outs:
            check(torch.equal(got.view(torch.int32),
                              base.view(torch.int32)),
                  f"fused_gather_aggregate {label} {xt.dtype} {agg} at "
                  f"{how}: not bit for bit the default launch")
        return len(outs)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gather_errs: dict = {}
    for label, x, src, dst, scale, n, s in gather_cases(dev, rng,
                                                        path_batches):
        csr = A.gather_csr(src, dst, n, s)
        src32 = src.to(torch.int32).contiguous()
        dst32 = dst.to(torch.int32).contiguous()
        for dt in STORAGE:
            xt = storage(x, dt, rng)
            sc = scale
            if dt == torch.int8 and scale is not None:
                sc = scale * 0.03125          # dequant factor folded in
            for agg in GATHER_AGGS:
                got = fused_gather_aggregate_cuda(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                want = fused_gather_aggregate_ref(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                err = compare("fused_gather_aggregate", agg, got, want, errs)
                gather_errs[dt] = max(gather_errs.get(dt, 0.0), err)
                n_cmp += gather_layouts(xt, src32, sc, csr, agg, got, label)
                n_cmp += 1 + onehot_vs(
                    "fused_gather_onehot", agg,
                    lambda eb, nb: fused_gather_onehot_cuda(
                        xt, src32, dst32, sc, s, agg=agg, edge_block=eb,
                        node_block=nb),
                    fused_gather_onehot_ref(xt, src32, dst32, sc, s,
                                            agg=agg),
                    got, dt == torch.float32, label)
    print("[3] fused_gather_aggregate against its plain version, max |err| "
          "by storage: " + ", ".join(f"{str(dt).split('.')[-1]} {v:.3e}"
                                     for dt, v in gather_errs.items())
          + f"; bit for bit at every cap {GATHER_CAPS}, on one SM, on a "
          "row-offset view and in either batch of edges in flight")
    for label, x, seg, valid, s, dtypes in segment_cases(dev, rng,
                                                         path_batches):
        csr = A.build_csr(seg, s, valid)
        seg32 = seg.to(torch.int32)
        if valid is not None:
            seg32 = torch.where(valid, seg32, torch.full_like(seg32, -1))
        seg32 = seg32.contiguous()
        for dt in dtypes:
            xt = storage(x, dt, rng)
            single, plain = {}, {}
            for agg in SEGMENT_AGGS:
                got = segment_aggregate_cuda(xt, csr.perm, csr.offsets,
                                             agg=agg)
                want = segment_aggregate_ref(xt, csr.perm, csr.offsets,
                                             agg=agg)
                compare("segment_aggregate", agg, got, want, errs)
                single[agg], plain[agg] = got, want
                n_cmp += 1 + onehot_vs(
                    "segment_aggregate_onehot", agg,
                    lambda eb, nb: segment_aggregate_onehot_cuda(
                        xt, seg32, s, agg=agg, edge_block=eb,
                        node_block=nb),
                    segment_aggregate_onehot_ref(xt, seg32, s, agg=agg),
                    got, dt == torch.float32, label)
            # one launch for a set of aggs: each slice bit for bit the
            # single-agg launch's output, and within the tolerances of
            # the plain version
            for aggs in MULTI_AGGS:
                multi = segment_aggregate_cuda(xt, csr.perm, csr.offsets,
                                               agg=aggs)
                f = x.shape[1]
                for i, agg in enumerate(aggs):
                    part = multi[:, i * f:(i + 1) * f].contiguous()
                    check(torch.equal(part.view(torch.int32),
                                      single[agg].view(torch.int32)),
                          f"segment_aggregate {label} {dt} {aggs}: {agg} "
                          "not bit for bit the single-agg launch")
                    compare("segment_aggregate", agg, part, plain[agg],
                            errs)
                n_cmp += 1
    for label, z, perm, off in softmax_cases(dev, rng, path_batches):
        got = segment_softmax_cuda(z, perm, off)
        want = segment_softmax_ref(z, perm, off)
        compare_softmax(label, got, want, errs)
        n_cmp += 1
    n_cmp += stream_vs_segment(dev, path_batches[0][1], rng)
    n_cmp += stack_vs_plain(dev, resident_batches, errs)
    torch.cuda.synchronize()
    print(f"[3] {n_cmp} kernel-vs-plain comparisons passed; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# ----------------------------------------------------------- phase 4 --
def p50_ms(stats: dict) -> float:
    lat = sorted(stats["batch_latency_s"])
    return lat[len(lat) // 2] * 1e3


def cpu_forward(conv: str, batch: dict, policy=None) -> torch.Tensor:
    """The full-width ``conv`` model with the serving weights on the
    port's CPU plain path."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    cfg = benchmark_config(conv)
    with torch.inference_mode():
        return G.apply_packed(serve_params(cfg, "cpu"), cfg,
                              G.packed_to_device(batch, "cpu"), None, policy)


def serve_phase(conv: str, requests: int, batch_graphs: int,
                precision: str = "fp32", wave: dict | None = None) -> dict:
    """``repro_torch.launch.serve --conv conv --precision precision``:
    every request served packed with finite outputs, each batch's
    launches as ``LAUNCHES_PER_BATCH`` says. fp32: the first batch against
    the CPU plain path (``MODEL_TOL``). bf16/int8: the warm-up batch's
    SQNR against the fp32 program of the same call at least
    ``SQNR_FLOOR_DB`` (or the JAX package's own SQNR less
    ``SQNR_MARGIN_DB`` where ``INT8_REF_SQNR_DB`` has it); at 32
    graphs/batch the first batch against the CPU plain path at the same
    policy (``low_bound``) and the int8 grids calibrated on the card
    beside the CPU's. ``wave``: where given, an fp32 drain records its
    (graphs/s, p50 batch ms) under (conv, batch_graphs), the rates phase
    9 offers its loads against."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.runtime import scheduler as S

    wrappers = zero_counts()
    outs, stats = serve.main(["--conv", conv, "--requests", str(requests),
                              "--batch-graphs", str(batch_graphs),
                              "--precision", precision])
    launches = {k: w.launches for k, w in wrappers.items()}
    # the drains' batches and the forwards of the warm-up batch outside
    # them (int8 calibration, the comparison with the fp32 program)
    n_batches = stats["n_batches"] + stats["warmup_batches"] \
        + stats["probe_batches"]
    label = f"{conv} {precision}"
    check(stats["served"] == requests,
          f"{label}: served {stats['served']} of {requests}")
    check(all(o["status"] == S.SERVED_PACKED for o in stats["outcomes"]),
          f"{label}: a request was not served packed")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"{label}: non-finite serving output")
    check(stats["precision"] == precision,
          f"{label}: served at {stats['precision']}")
    for name, per_batch in zip(KERNELS, LAUNCHES_PER_BATCH[conv]):
        check(launches[name] == per_batch * n_batches,
              f"{label}: {launches[name]} {name} launches for {n_batches} "
              f"batches, expected {per_batch} per batch")
    # packing is greedy in queue order: a batch needs only a prefix
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i)
             for i in range(min(requests, 2 * batch_graphs))]
    nb, eb = serve.budgets(batch_graphs, ds)
    first = P.pack_dataset(queue, nb, eb, batch_graphs)[0][0]
    policy = stats["policy"]
    extra = ""
    if precision == "fp32":
        ref = cpu_forward(conv, first)
        err = float((outs[0].cpu() - ref).abs().max())
        check(torch.allclose(outs[0].cpu(), ref, **MODEL_TOL),
              f"{label}: first batch vs CPU plain path: max |err| {err}")
        extra = f"; first batch vs CPU max |err| {err:.3e}"
        if wave is not None:
            wave[(conv, batch_graphs)] = (stats["graphs_per_s"],
                                          p50_ms(stats))
    else:
        sq = stats["output_error_vs_fp32"]
        floor = SQNR_FLOOR_DB[precision]
        ref_sq = INT8_REF_SQNR_DB.get((conv, batch_graphs)) \
            if precision == "int8" else None
        if ref_sq is not None:
            floor = ref_sq - SQNR_MARGIN_DB
            extra += (f"; the JAX package's own SQNR {ref_sq:.4f} dB on the "
                      f"same weights and batch, floor {floor:.4f} dB")
        check(sq["sqnr_db"] >= floor,
              f"{label}: SQNR {sq['sqnr_db']:.2f} dB against fp32 < "
              f"{floor:.2f} dB")
        if batch_graphs == 32:
            ref = cpu_forward(conv, first, policy)
            err = float((outs[0].cpu() - ref).abs().max())
            bound = low_bound(precision, ref, policy)
            check(err <= bound, f"{label}: first batch vs CPU plain path at "
                                f"the same policy: max |err| {err} > {bound}")
            extra += f"; first batch vs CPU {err:.3e} (bound {bound:.3e})"
            if precision == "int8":
                cfg = benchmark_config(conv)
                cpu_params = serve_params(cfg, "cpu")
                cpu_pol = G.calibrated_policy(
                    cpu_params, cfg, G.packed_to_device(first, "cpu"),
                    precision)
                extra += (f"; grids on the card {grids(policy)}, on the CPU "
                          + ("the same" if cpu_pol == policy
                             else grids(cpu_pol)))
        extra = (f"; warm-up batch vs fp32 max |err| {sq['max_abs']:.4e}, "
                 f"SQNR {sq['sqnr_db']:.4f} dB") + extra
    print(f"[4] {label}: served {requests} requests at {batch_graphs} "
          f"graphs/batch ({stats['n_batches']} measured batches, "
          f"{stats['total_s'] * 1e3:.4f} ms): {stats['graphs_per_s']:.1f} "
          f"graphs/s, batch latency p50 {p50_ms(stats):.4f} ms "
          f"max {max(stats['batch_latency_s']) * 1e3:.4f} ms, launches over "
          f"{n_batches} batches (warm-up included): "
          + ", ".join(f"{k} {v}" for k, v in launches.items()) + extra)
    return launches


def serve_params(cfg, device) -> dict:
    """The weights ``launch.serve`` draws, on ``device``."""
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params
    return init_params(cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED),
                       device)


def resident_phase(dev, conv: str, batch_graphs: int, requests: int,
                   precision: str = "fp32") -> dict:
    """Serve ``conv`` through ``apply_packed_resident(fusion_depth=2)``
    at ``precision`` (int8 grids calibrated on the first batch, the
    weight stacks built once for the policy) with
    ``serve.drain_gnn_queue`` (warm-up drain, then the measured one; the
    counts cover both), then the same queue through ``apply_packed`` at
    the same policy in the same run. Checks the plan's launches per
    batch, finite outputs, and the first batch against ``apply_packed``
    on the card (``resident_tols``) and, at fp32, against the CPU plain
    path (atol/rtol 1e-4)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core.convs import residency_plan
    from repro_torch.data import pipeline as P
    from repro_torch.device import l2_cache_bytes
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params
    from repro_torch.runtime import scheduler as S

    ds = DATASETS["qm9"]
    cfg = benchmark_config(conv)
    nb, eb = serve.budgets(batch_graphs, ds)
    plan = residency_plan(
        [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
         for i in range(cfg.gnn_num_layers)], nb, conv, 2, edge_budget=eb,
        l2_bytes=l2_cache_bytes(dev))
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    queue = [P.make_graph(ds, i) for i in range(requests)]
    policy = G.resolve_policy(cfg, precision)
    if policy.needs_calibration:
        warm, _ = P.pack_graphs(queue[:batch_graphs], nb, eb, batch_graphs)
        policy = G.calibrated_policy(params, cfg,
                                     G.packed_to_device(warm, dev), policy)
    # the weights cast for the policy and the padded weight stacks depend
    # on the weights and the policy only: built once, as a server does
    served = G.cast_for_policy(params, cfg, policy)
    stacks = G.resident_stacks(served, cfg, 2, policy)

    def resident(p, b):
        return G.apply_packed_resident(p, cfg, b, None, policy,
                                       fusion_depth=2, stacks=stacks)

    def packed(p, b):
        return G.apply_packed(p, cfg, b, None, policy)

    def drain(fn):
        _, warm = serve.drain_gnn_queue(fn, served, queue[:batch_graphs],
                                        nb, eb, batch_graphs, device=dev)
        outs, stats = serve.drain_gnn_queue(fn, served, queue, nb, eb,
                                            batch_graphs, device=dev)
        check(stats["served"] == requests
              and all(o["status"] == S.SERVED_PACKED
                      for o in stats["outcomes"]),
              f"{conv}: served {stats['served']} of {requests}")
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{conv}: non-finite serving output")
        return outs, stats, stats["n_batches"] + warm["n_batches"]

    wrappers = zero_counts()
    outs, stats, n_batches = drain(resident)
    launches = {k: w.launches for k, w in wrappers.items()}
    expected = RESIDENT_LAUNCHES if plan.legal else LAUNCHES_PER_BATCH[conv]
    for name, per_batch in zip(KERNELS, expected):
        check(launches[name] == per_batch * n_batches,
              f"{conv} resident: {launches[name]} {name} launches for "
              f"{n_batches} batches, expected {per_batch} per batch")
    pouts, pstats, _ = drain(packed)
    err_card = float((outs[0] - pouts[0]).abs().max())
    rtol, atol = resident_tols(precision, policy)
    bound = rtol * float(pouts[0].abs().max()) + atol
    check(err_card <= bound, f"{conv} {precision} resident vs apply_packed "
                             f"on the card: max |err| {err_card} > {bound}")
    label = f"{conv} resident" if precision == "fp32" \
        else f"{conv} {precision} resident"
    if precision != "fp32":
        print(f"[4] {label}, fusion_depth 2, {batch_graphs} graphs/batch "
              f"({nb} nodes): plan legal={plan.legal}; {requests} requests: "
              f"{stats['graphs_per_s']:.1f} graphs/s, p50 "
              f"{p50_ms(stats):.4f} ms; apply_packed at {precision} in the "
              f"same run: {pstats['graphs_per_s']:.1f} graphs/s, p50 "
              f"{p50_ms(pstats):.4f} ms; launches over {n_batches} batches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f"; first batch vs apply_packed max |err| {err_card:.3e} "
              f"(bound {bound:.3e}); {grids(policy)}")
        return launches
    cpu_params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), "cpu")
    first = P.pack_dataset(queue[:2 * batch_graphs], nb, eb,
                           batch_graphs)[0][0]
    with torch.inference_mode():
        ref = G.apply_packed_resident(cpu_params, cfg,
                                      G.packed_to_device(first, "cpu"),
                                      fusion_depth=2)
    err_cpu = float((outs[0].cpu() - ref).abs().max())
    check(torch.allclose(outs[0].cpu(), ref, **MODEL_TOL),
          f"{conv} resident: first batch vs CPU plain path: max |err| "
          f"{err_cpu}")
    print(f"[4] {conv} resident, fusion_depth 2, {batch_graphs} graphs/batch"
          f" ({nb} nodes): plan legal={plan.legal} depth={plan.depth} "
          f"fmax={plan.fmax} ({plan.reason}); {requests} requests: "
          f"{stats['graphs_per_s']:.1f} graphs/s, p50 {p50_ms(stats):.4f} "
          f"ms; apply_packed in the same run: "
          f"{pstats['graphs_per_s']:.1f} graphs/s, p50 "
          f"{p50_ms(pstats):.4f} ms; launches over {n_batches} batches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; first batch vs apply_packed max |err| {err_card:.3e} "
          f"(bound {bound:.3e}), vs CPU {err_cpu:.3e}")
    return launches


# ----------------------------------------------------------- phase 5 --
def oracle_phase(dev, conv: str, n_graphs: int = 8) -> float:
    """The padded per-graph oracle (``gnn_model.apply``, one padded qm9
    graph at a time) on the card against the rows of ``apply_packed``
    over the same graphs (atol/rtol 1e-4)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    ds = DATASETS["qm9"]
    cfg = benchmark_config(conv)
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    gb = P.graph_batch(ds, 0, n_graphs)
    nb, eb = serve.budgets(n_graphs, ds)
    batch, k = P.pack_graphs([P.make_graph(ds, i) for i in range(n_graphs)],
                             nb, eb, n_graphs)
    check(k == n_graphs, f"packed {k} of {n_graphs} graphs")
    with torch.inference_mode():
        packed = G.apply_packed(params, cfg, G.packed_to_device(batch, dev))
        per_graph = torch.stack([
            G.apply(params, cfg, G.packed_to_device(
                {key: v[i] for key, v in gb.items()}, dev))
            for i in range(n_graphs)])
    err = float((per_graph - packed[:n_graphs]).abs().max())
    check(bool(torch.isfinite(per_graph).all())
          and torch.allclose(per_graph, packed[:n_graphs], **MODEL_TOL),
          f"{conv}: padded oracle vs apply_packed: max |err| {err}")
    print(f"[5] padded oracle, full-width {conv} on {n_graphs} qm9 graphs "
          f"({gb['node_feat'].shape[1]}-node frames) vs apply_packed rows: "
          f"max |err| {err:.3e}")
    return err


def golden_phase(dev, conv: str, resident: bool = False,
                 precision: str = "fp32") -> float:
    """The full-width output on the golden file's batch and weights
    against the JAX package's output stored in
    ``testdata/{conv}_qm9_full[_{precision}].json``: fp32 to
    ``MODEL_TOL``; bf16 and int8 at the file's policy (the JAX grids)
    to ``low_bound``, the resident path also within ``resident_tols``.
    At int8 the grids calibrated on the card are printed beside the
    file's."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.data import pipeline as P
    from repro_torch.nn.param import materialize_numpy, params_from_jax

    suffix = "" if precision == "fp32" else f"_{precision}"
    gold = json.loads((ROOT / "src/repro_torch/testdata/"
                       f"{conv}_qm9_full{suffix}.json").read_text())
    ds = DATASETS[gold["dataset"]]
    cfg = benchmark_config(conv, gold["dataset"])
    graphs = [P.make_graph(ds, i) for i in range(gold["graphs"])]
    batch, k = P.pack_graphs(graphs, gold["node_budget"],
                             gold["edge_budget"], gold["batch_graphs"])
    check(k == gold["graphs"], f"packed {k} of {gold['graphs']} graphs")
    params = params_from_jax(
        cfg, materialize_numpy(G.model_plan(cfg), gold["seed"]), dev)
    b = G.packed_to_device(batch, dev)
    policy, note = None, ""
    if precision != "fp32":
        policy = Q.policy_from_description(gold["policy"])
        on_card = G.calibrated_policy(params, cfg, b, precision)
        if precision == "int8":
            note = (f"; grids of the file (JAX, CPU) {grids(policy)}, "
                    "calibrated on the card "
                    + ("the same" if on_card == policy else grids(on_card)))
    fn = G.apply_packed_resident if resident else G.apply_packed
    stack = counters()["fused_layer_stack"]
    before = stack.launches
    with torch.inference_mode():
        out = fn(params, cfg, b, None, policy).cpu()
    check(stack.launches == before + int(resident),
          f"{conv}: {stack.launches - before} stack launches")
    want = torch.tensor(gold["out"], dtype=torch.float32)
    err = float((out - want).abs().max())
    path = "resident" if resident else "packed"
    label = f"{conv} {path} {precision}"
    if precision == "fp32":
        check(torch.allclose(out, want, **MODEL_TOL),
              f"{label}: full-width output vs JAX golden: max |err| {err}")
        bound_txt = ""
    else:
        bound = low_bound(precision, want, policy)
        if resident:
            rtol, atol = resident_tols(precision, policy)
            bound += rtol * float(want.abs().max()) + atol
        check(err <= bound, f"{label}: full-width output vs JAX golden: max "
                            f"|err| {err} > {bound}")
        bound_txt = f" (bound {bound:.3e})"
    print(f"[5] full-width {conv} ({path}, {precision}) on {k} qm9 graphs vs "
          f"the JAX golden output: max |err| {err:.3e}{bound_txt}{note}")
    return err


# ----------------------------------------------------------- phase 6 --
def gather_widths(conv: str) -> list:
    """The width of each layer's gather in the paper's model: the input
    width where the layer aggregates first, else the output width (an
    attention conv aggregates its projection)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core.convs import conv_spec, resolve_dataflow
    cfg = benchmark_config(conv)
    widths = []
    for i in range(cfg.gnn_num_layers):
        cc = cfg.conv_cfg(i)
        agg_first = resolve_dataflow(cc) == "aggregate_first" \
            and not conv_spec(conv).attention
        widths.append(cc.in_dim if agg_first else cc.out_dim)
    return widths


def sparse_adj(ei, ok, w, n):
    """The (n, n) CSR adjacency of a batch's valid edges with weights
    ``w`` (row = destination): ``torch.sparse.mm(adj, x)`` is the library
    yardstick of the gather kernels, the same function as a sum gather."""
    return torch.sparse_coo_tensor(
        torch.stack([ei[ok, 1], ei[ok, 0]]).long(), w[ok], (n, n),
        check_invariants=True).coalesce().to_sparse_csr()


def timing_phase(dev, path_batches, resident_batches) -> list:
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import aggregations as A
    from repro_torch.core import gnn_model as G
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_aggregate_cuda, fused_gather_onehot_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_cuda, segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.segment_softmax.kernel import (
        segment_softmax_cuda)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    from repro_torch.kernels.fused_layer_stack.kernel import (
        fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    rows = []

    def row(kernel, conv, label, shape, kern, plain, lib, bytes_moved,
            flops, path=True, **extra):
        """``path``: the call is one the served batch makes (the per-batch
        sums of the summary add up these rows only)."""
        bound, by = bound_ms(bytes_moved, flops)
        rows.append(dict(
            kernel=kernel, conv=conv, batch=label, shape=shape, path=path,
            ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain, **PLAIN_TIMING),
            library_ms=None if lib is None else cuda_ms(lib),
            bound_ms=bound, bound_by=by,
            **{k: fn() for k, fn in extra.items()}))

    def gather_rows(conv, label, layers, src, scale, csr, n, adj, agg,
                    tag):
        """One row per (layer, width) of ``layers``."""
        n_valid = int(csr.offsets[-1])
        for layer, f in layers:
            x = torch.randn((n, f), device=dev)
            row("fused_gather_aggregate", conv, label,
                f"{tag} layer {layer}: N=S={n} E={src.numel()} (valid "
                f"{n_valid}) F={f}",
                lambda: fused_gather_aggregate_cuda(
                    x, src, scale, csr.perm, csr.offsets, agg=agg),
                lambda: fused_gather_aggregate_ref(
                    x, src, scale, csr.perm, csr.offsets, agg=agg),
                lambda: torch.sparse.mm(adj, x),
                *gather_work(x, src, scale, csr.perm, csr.offsets))

    def segment_row(conv, label, shape, x, csr, s, agg, idx, path):
        """One launch of one agg or (a tuple) of a set of aggs; the
        library yardstick is one ``scatter_reduce_`` per agg (none where
        an agg has none)."""
        aggs = (agg,) if isinstance(agg, str) else agg
        reduces = [LIB_REDUCE[a] for a in aggs]
        lib = None if None in reduces else (
            lambda: [torch.empty((s + 1, x.shape[1]), device=dev)
                     .scatter_reduce_(0, idx, x, r, include_self=False)
                     for r in reduces])
        row("segment_aggregate", conv, label, shape,
            lambda: segment_aggregate_cuda(x, csr.perm, csr.offsets,
                                           agg=agg),
            lambda: segment_aggregate_ref(x, csr.perm, csr.offsets,
                                          agg=agg),
            lib, *segment_work(x, csr.perm, csr.offsets, agg), path=path)

    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, node_mask, gid = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        src = ei[:, 0].contiguous()
        csr = g["edge_csr"]
        ok = g["valid_e"]
        n_valid = int(csr.offsets[-1])
        # GCN (library yardstick: one sparse CSR product, same weights)
        scale = g["gcn_edge_scale"]
        gather_rows("gcn", label, enumerate(gather_widths("gcn")), src,
                    scale, csr, n,
                    sparse_adj(ei, ok, scale, n), "sum", "GCN")
        ng = b["graph_valid"].shape[0]
        pcsr = A.build_csr(gid, ng, node_mask)
        f = benchmark_config("gcn").gnn_output_dim
        x = torch.randn((n, f), device=dev)
        idx = torch.where(node_mask, gid.long(),
                          torch.full_like(gid.long(), ng))[:, None].expand(
                              n, f).contiguous()
        # the pooling set in one launch (the path's), beside each method
        # alone
        segment_row("gcn", label, f"{'+'.join(POOLING_AGGS)} pooling, one "
                    f"launch: rows={n} S={ng} F={f}", x, pcsr, ng,
                    POOLING_AGGS, idx, True)
        for agg in POOLING_AGGS:
            segment_row("gcn", label, f"{agg} pooling: rows={n} S={ng} "
                        f"F={f}", x, pcsr, ng, agg, idx, False)
        # the same GCN batch on the one-hot schedule, at the default tiles
        # of Project(gather_mode="onehot"): the same function, so the same
        # bound and library call as the CSR kernels' rows
        nb_, eb_ = ONEHOT_DEFAULT_TILES
        dst = ei[:, 1].contiguous()
        steps = -(-n // nb_) * -(-ei.shape[0] // eb_)
        adj = sparse_adj(ei, ok, scale, n)
        for layer, f_in in enumerate(gather_widths("gcn")):
            xg = torch.randn((n, f_in), device=dev)
            row("fused_gather_onehot", "gcn", label,
                f"GCN layer {layer}: N=S={n} E={ei.shape[0]} (valid "
                f"{n_valid}) F={f_in}, tiles ({nb_}, {eb_}): {steps} steps",
                lambda: fused_gather_onehot_cuda(
                    xg, src, dst, scale, n, edge_block=eb_, node_block=nb_),
                lambda: fused_gather_onehot_ref(xg, src, dst, scale, n),
                lambda: torch.sparse.mm(adj, xg),
                *gather_onehot_work(xg, src, dst, scale, n),
                steps=lambda: steps)
        pseg = torch.where(node_mask, gid, torch.full_like(gid, -1))
        psteps = -(-ng // nb_) * -(-n // eb_)
        for agg in POOLING_AGGS:
            lib = LIB_REDUCE[agg]
            row("segment_aggregate_onehot", "gcn", label,
                f"{agg} pooling: rows={n} S={ng} F={f}, tiles ({nb_}, "
                f"{eb_}): {psteps} steps",
                lambda: segment_aggregate_onehot_cuda(
                    x, pseg, ng, agg=agg, edge_block=eb_, node_block=nb_),
                lambda: segment_aggregate_onehot_ref(x, pseg, ng, agg=agg),
                lambda: torch.empty((ng + 1, f), device=dev).scatter_reduce_(
                    0, idx, x, lib, include_self=False),
                *segment_onehot_work(x, pseg, ng, agg),
                steps=lambda: psteps)
        # GAT: each layer's softmax, then its weighted gather
        for layer, (z, perm, off) in enumerate(gat_softmax_inputs(dev,
                                                                  batch)):
            row("segment_softmax", "gat", label,
                f"GAT layer {layer}: E={z.numel()} (valid {n_valid}) "
                f"S={n}",
                lambda: segment_softmax_cuda(z, perm, off),
                lambda: segment_softmax_ref(z, perm, off), None,
                *softmax_work(z, perm, off))
            alpha = segment_softmax_cuda(z, perm, off)
            gather_rows("gat", label, [(layer, gather_widths("gat")[layer])],
                        src, alpha, csr, n, sparse_adj(ei, ok, alpha, n),
                        "sum", "GAT alpha-weighted")
        # SAGE: mean gathers (library: the product with 1/deg weights)
        deg = torch.clamp(g["in_deg"], min=1.0)
        inv_deg = (1.0 / deg)[ei[:, 1].long().clamp(0, n - 1)]
        gather_rows("sage", label, enumerate(gather_widths("sage")), src,
                    None, csr, n, sparse_adj(ei, ok, inv_deg, n), "mean",
                    "SAGE mean")
        # PNA: the four towers over the edge messages of each layer
        cfg = benchmark_config("pna")
        for layer in range(cfg.gnn_num_layers):
            f = cfg.conv_cfg(layer).in_dim
            msg = torch.randn((ei.shape[0], f), device=dev)
            idx = torch.where(ok, ei[:, 1].long(),
                              torch.full_like(ei[:, 1].long(), n))[
                                  :, None].expand(-1, f).contiguous()
            shape = f"layer {layer}: rows={ei.shape[0]} (valid " \
                    f"{n_valid}) S={n} F={f}"
            segment_row("pna", label, f"PNA towers "
                        f"{'+'.join(PNA_AGGS)}, one launch, {shape}", msg,
                        csr, n, PNA_AGGS, idx, True)
            for agg in PNA_AGGS:
                segment_row("pna", label, f"PNA {agg} tower, {shape}", msg,
                            csr, n, agg, idx, False)
    # the softmax on a hub: a segment of 3000 edges among 256 others
    # (phase 3's edge case), off the served path
    _, z, perm, off = softmax_cases(dev, np.random.default_rng(3), [])[0]
    row("segment_softmax", "gat", "hub",
        f"hub: E={z.numel()} S={off.numel() - 1}, one segment of "
        f"{int((off[1:] - off[:-1]).max())} edges",
        lambda: segment_softmax_cuda(z, perm, off),
        lambda: segment_softmax_ref(z, perm, off), None,
        *softmax_work(z, perm, off), path=False)
    # the resident stack: both layers of the full-width model in one
    # launch at the model's real widths, as apply_packed_resident calls
    # it (held against the plain version and against the kernel without
    # widths first); beside it, the same two layers through the
    # layer-by-layer path (gather kernel + matmuls, _backbone) on the
    # same batch, and the kernel without widths (every layer at the
    # padded table width)
    for label, batch in resident_batches:
        b = G.packed_to_device(batch, dev)
        g, x, node_mask, _ = G.packed_inputs(b)
        for conv in RESIDENT_CONVS:
            cfg = benchmark_config(conv)
            params = init_params(
                cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
            args, kw = resident_stack_inputs(dev, conv, batch)
            n, f = args[0].shape
            k = args[8].shape[0]
            check(k == cfg.gnn_num_layers, f"{conv}: K={k}")
            dims = [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
                    for i in range(k)]
            check(kw["widths"] == dims, f"{conv}: the model's stack call "
                                        f"has widths {kw['widths']}")
            padded = {**kw, "widths": None}
            got = fused_layer_stack_cuda(*args, **kw)
            held: dict = {}
            compare_stack(f"{conv} {label} widths", "fp32", got,
                          fused_layer_stack_ref(*args, **kw), held)
            compare_stack(f"{conv} {label} widths against none", "fp32",
                          got, fused_layer_stack_cuda(*args, **padded), held)
            widths = " -> ".join(str(w) for w in
                                 [dims[0][0]] + [o for _, o in dims])
            row("fused_layer_stack", conv, label,
                f"{conv.upper()} K={k}: N={n} widths {widths} (table F={f})"
                f" E={args[1].numel()} (valid {int(args[4][-1])})",
                lambda: fused_layer_stack_cuda(*args, **kw),
                lambda: fused_layer_stack_ref(*args, **kw), None,
                *stack_work(args, conv, kw["has_skip"], dims),
                layerwise_ms=lambda: cuda_ms(
                    lambda: G._backbone(params, cfg, g, x, node_mask)),
                padded_ms=lambda: cuda_ms(
                    lambda: fused_layer_stack_cuda(*args, **padded)))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        lw = f", layer-by-layer {r['layerwise_ms']:.5f} ms, without " \
             f"widths {r['padded_ms']:.5f} ms" if "layerwise_ms" in r else ""
        st = f", {r['ms'] / r['steps'] * 1e6:.2f} ns per step" \
            if "steps" in r else ""
        off = "" if r["path"] else " (off the batch's path)"
        print(f"[6] {r['kernel']} {r['batch']} {r['shape']}{off}: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}){lw}"
              f"{st}")
    onehot = [r for r in rows
              if "steps" in r and r["batch"] == rows[-1]["batch"]]
    print(f"[6] kernel_step_overhead: "
          f"{sum(r['ms'] for r in onehot) * 1e-3 / sum(r['steps'] for r in onehot):.4e}"
          f" s per (node tile x edge tile) step: the one-hot launches of a "
          f"GCN batch at {rows[-1]['batch']}, their time over their steps")
    return rows


def storage_timing_phase(dev, label: str, batch) -> list:
    """Phase 6 at the bf16 and int8 storage of a low-precision policy, on
    the served batch ``batch`` (1024 graphs): the calls the model makes
    at those widths, timed as the fp32 rows, each bound from its own
    bytes (``gather_work``/``segment_work`` read the element size): the
    CSR and one-hot gathers of GCN's layers (an int8 table with the
    grid's step folded into the scale), PNA's towers (one CSR launch a
    layer, one one-hot launch an agg) and the resident stack at the
    bf16 and int8 precision rows (its table stays fp32; the rows cast on
    the fly). The softmax is fp32 at every policy, and the pooling too,
    so their fp32 rows stand. No library call computes these functions
    on bf16 or int8 tables, so there is none."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_aggregate_cuda, fused_gather_onehot_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_cuda, segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.fused_layer_stack.kernel import (
        fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)

    rows = []
    grid = Q.FPX(8, 3)

    def row(kernel, conv, stored, shape, kern, plain, work):
        bound, by = bound_ms(*work)
        rows.append(dict(
            kernel=kernel, conv=conv, batch=label, shape=shape, path=False,
            storage=stored, ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain, **PLAIN_TIMING),
            library_ms=None, bound_ms=bound, bound_by=by))

    def table(x, stored):
        if stored == "bf16":
            return x.to(torch.bfloat16)
        return Q.quantize_int8(x, grid)

    b = G.packed_to_device(batch, dev)
    g, _, _, _ = G.packed_inputs(b)
    n = b["node_feat"].shape[0]
    ei = b["edge_index"]
    src, dst = ei[:, 0].contiguous(), ei[:, 1].contiguous()
    csr = g["edge_csr"]
    n_valid = int(csr.offsets[-1])
    nb_, eb_ = ONEHOT_DEFAULT_TILES
    pna = benchmark_config("pna")
    resident = {conv: resident_stack_inputs(dev, conv, batch)
                for conv in RESIDENT_CONVS}
    for stored in LOW_PRECISIONS:
        scale = g["gcn_edge_scale"].to(torch.float32)
        if stored == "int8":
            scale = (scale * grid.resolution).contiguous()
        for layer, f in enumerate(gather_widths("gcn")):
            x = table(torch.randn((n, f), device=dev), stored)
            shape = (f"GCN layer {layer}: N=S={n} E={src.numel()} (valid "
                     f"{n_valid}) F={f} {stored}")
            row("fused_gather_aggregate", "gcn", stored, shape,
                lambda: fused_gather_aggregate_cuda(
                    x, src, scale, csr.perm, csr.offsets),
                lambda: fused_gather_aggregate_ref(
                    x, src, scale, csr.perm, csr.offsets),
                gather_work(x, src, scale, csr.perm, csr.offsets))
            row("fused_gather_onehot", "gcn", stored,
                f"{shape}, tiles ({nb_}, {eb_})",
                lambda: fused_gather_onehot_cuda(
                    x, src, dst, scale, n, edge_block=eb_, node_block=nb_),
                lambda: fused_gather_onehot_ref(x, src, dst, scale, n),
                gather_onehot_work(x, src, dst, scale, n))
        seg = torch.where(g["valid_e"], dst, torch.full_like(dst, -1))
        for layer in range(pna.gnn_num_layers):
            f = pna.conv_cfg(layer).in_dim
            msg = table(torch.randn((ei.shape[0], f), device=dev), stored)
            shape = (f"PNA layer {layer}: rows={ei.shape[0]} (valid "
                     f"{n_valid}) S={n} F={f} {stored}")
            row("segment_aggregate", "pna", stored,
                f"towers {'+'.join(PNA_AGGS)}, one launch, {shape}",
                lambda: segment_aggregate_cuda(msg, csr.perm, csr.offsets,
                                               agg=PNA_AGGS),
                lambda: segment_aggregate_ref(msg, csr.perm, csr.offsets,
                                              agg=PNA_AGGS),
                segment_work(msg, csr.perm, csr.offsets, PNA_AGGS))
            for agg in PNA_AGGS:
                row("segment_aggregate_onehot", "pna", stored,
                    f"{agg} tower, {shape}, tiles ({nb_}, {eb_})",
                    lambda: segment_aggregate_onehot_cuda(
                        msg, seg, n, agg=agg, edge_block=eb_,
                        node_block=nb_),
                    lambda: segment_aggregate_onehot_ref(msg, seg, n,
                                                         agg=agg),
                    segment_onehot_work(msg, seg, n, agg))
        for conv, (args, kw) in resident.items():
            k = args[8].shape[0]
            qp = torch.tensor([QP_ROWS[stored]] * k, dtype=torch.float32,
                              device=dev)
            a = (*args[:11], qp)
            dims = kw["widths"]
            row("fused_layer_stack", conv, stored,
                f"{conv.upper()} K={k}: N={n} widths {dims}, {stored} "
                f"precision rows",
                lambda: fused_layer_stack_cuda(*a, **kw),
                lambda: fused_layer_stack_ref(*a, **kw),
                stack_work(a, conv, kw["has_skip"], dims))
    for r in rows:
        print(f"[6] {r['kernel']} {r['batch']} {r['shape']}: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"n/a, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


# ----------------------------------------------------------- phase 7 --
PROJECT_DIR = ROOT / "build" / "chip_smoke_project"
V2_KERNELS = ("fused_gather_aggregate", "segment_aggregate")
ONEHOT_KERNELS = ("fused_gather_onehot", "segment_aggregate_onehot")


def make_project(conv: str, batch_graphs: int, tag: str, **kw):
    """``Project`` on the full-width ``benchmark_config(conv)`` over qm9
    graphs, on the pallas backend (the one where the knobs engage)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core.project import Project
    return Project(f"{conv}_{tag}", benchmark_config(conv), "regression",
                   str(PROJECT_DIR / f"{conv}_{tag}"),
                   dataset_cfg=DATASETS["qm9"], batch_graphs=batch_graphs,
                   agg_backend="pallas", **kw)


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def run_testbench(p, n_graphs: int) -> tuple:
    """gen_hw_model, init_params and gen_testbench (whose fp32 reference
    runs the default kernels, as in the reference), then the counts set
    to 0 and ``build_and_run_testbench`` (the generated programs ``_fn``
    and ``_fn_packed``), the counts read just after."""
    p.gen_hw_model()
    p.init_params()
    p.gen_testbench(n_graphs)
    wrappers = zero_counts()
    tb = p.build_and_run_testbench()
    return tb, {k: w.launches for k, w in wrappers.items()}


def check_onehot_only(label: str, launches: dict, expect_onehot) -> None:
    for name in V2_KERNELS:
        check(launches[name] == 0, f"{label}: {launches[name]} {name} "
                                   "launches inside the one-hot programs")
    for name, want in zip(ONEHOT_KERNELS, expect_onehot):
        check((launches[name] > 0) == (want > 0),
              f"{label}: {launches[name]} {name} launches")


def listing1_phase(dev) -> dict:
    """The paper's Listing 1 on the card: GCN at full width, fixed
    ``FPX(16, 10)``, ``agg_backend="pallas"``, ``gather_mode="onehot"``:
    testbench MAE < 1.0 (``tests/test_system.py``), the generated program
    within ``FIXED_GRID_STEPS`` grid steps of the port's CPU run with the
    same weights, and the synthesis report."""
    from repro_torch.core.quantization import FPX, quantize_tree
    kw = dict(float_or_fixed="fixed", fpx=FPX(16, 10), gather_mode="onehot")
    p = make_project("gcn", 32, "listing1", **kw)
    tb, launches = run_testbench(p, 64)
    check(tb["mae"] < 1.0, f"Listing 1: testbench MAE {tb['mae']}")
    check_onehot_only("Listing 1", launches,
                      ONEHOT_LAUNCHES_PER_BATCH["gcn"][4:])
    synth = p.run_vitis_hls_synthesis()
    check(synth["latency_s"] > 0 and synth["flops"] > 0 and synth["fits_hbm"]
          and (PROJECT_DIR / "gcn_listing1" / "report.json").exists(),
          f"Listing 1: synthesis report {synth}")
    cpu = make_project("gcn", 32, "listing1_cpu", device="cpu", **kw)
    cpu.gen_hw_model()
    q_card = quantize_tree(p.params, p.fpx)
    q_cpu = tree_to(q_card, "cpu")
    steps = 0.0
    for g in p._tb_graphs[:16]:
        a = p._fn(q_card, p._graph_to_el(g)).cpu()
        b = cpu._fn(q_cpu, cpu._graph_to_el(g))
        steps = max(steps, float((a - b).abs().max()) / p.fpx.resolution)
    check(steps <= FIXED_GRID_STEPS,
          f"Listing 1: card vs CPU {steps} grid steps > {FIXED_GRID_STEPS}")
    print(f"[7] Listing 1 (GCN full width, fixed {p.fpx}, pallas, onehot, "
          f"32 graphs/batch): testbench MAE {tb['mae']:.6f} over "
          f"{tb['n_graphs']} graphs, {tb['mean_runtime_ms']:.4f} ms per "
          f"graph, packed MAE {tb['packed']['mae']:.6f} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; quant error "
          f"{tb['quant_error']['output']}; card vs CPU {steps:g} grid "
          f"steps; synthesis latency {synth['latency_ms']:.6f} ms, "
          f"{synth['flops']:.4g} FLOPs, {synth['bytes_accessed']:.4g} B, "
          f"temp {synth['temp_bytes']} B, args {synth['arg_bytes']} B, "
          f"compile {synth['compile_s']:.3f} s, packed "
          f"{synth['packed']['graphs_per_s']:.1f} graphs/s modeled; "
          f"launches {launches}")
    return launches


def onehot_conv_phase(dev, conv: str) -> dict:
    """Every conv through ``gather_mode="onehot"`` at 32 graphs/batch
    (fp32): packed MAE against the testbench reference <= 1e-4, only the
    one-hot kernels (and GAT's softmax) inside the generated programs,
    and one packed batch launching exactly
    ``ONEHOT_LAUNCHES_PER_BATCH``."""
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    p = make_project(conv, 32, "onehot", gather_mode="onehot")
    tb, launches = run_testbench(p, 64)
    check(tb["packed"]["mae"] <= 1e-4,
          f"{conv} onehot: packed MAE {tb['packed']['mae']}")
    check_onehot_only(f"{conv} onehot", launches,
                      ONEHOT_LAUNCHES_PER_BATCH[conv][4:])
    batch = G.packed_to_device(P.pack_dataset(
        p._tb_graphs, p.node_budget, p.edge_budget, p.batch_graphs)[0][0],
        dev)
    wrappers = zero_counts()
    out = p._fn_packed(p.params, batch)
    torch.cuda.synchronize()
    one = {k: w.launches for k, w in wrappers.items()}
    check(tuple(one[k] for k in KERNELS) == ONEHOT_LAUNCHES_PER_BATCH[conv]
          and bool(torch.isfinite(out).all()),
          f"{conv} onehot: one batch launched {one}")
    print(f"[7] {conv} onehot Project, 32 graphs/batch: testbench MAE "
          f"{tb['mae']:.3e}, packed MAE {tb['packed']['mae']:.3e} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; launches {launches}")
    for k, v in one.items():
        launches[k] += v
    return launches


def resident_project_phase(dev, conv: str) -> dict:
    """``fusion_depth=2`` on the pallas backend: the residency plan is
    legal at 32 graphs/batch, ``residency_engaged`` holds and the packed
    program launches the resident stack."""
    p = make_project(conv, 32, "resident", gather_mode="onehot",
                     fusion_depth=2)
    tb, launches = run_testbench(p, 64)
    config = json.loads((PROJECT_DIR / f"{conv}_resident" /
                         "config.json").read_text())
    check(p.residency_engaged and config["residency_engaged"]
          and launches["fused_layer_stack"] > 0
          and tb["packed"]["mae"] <= 1e-4,
          f"{conv} resident Project: engaged {p.residency_engaged}, "
          f"launches {launches}, packed MAE {tb['packed']['mae']}")
    print(f"[7] {conv} Project fusion_depth 2: residency engaged "
          f"({p.residency.reason}), packed MAE {tb['packed']['mae']:.3e} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; launches {launches}")
    return launches


# the testbench graphs of phase 7's GCN drains at 1024 graphs/batch (two
# measured batches; each graph's fp32 reference is a padded-oracle run)
THROUGHPUT_GRAPHS = 2048


def throughput_phase(dev) -> tuple:
    """GCN at 1024 graphs/batch through the packed testbench drain in
    both gather modes, side by side, with the modeled graphs/s of each
    synthesis report."""
    results, total = {}, dict.fromkeys(KERNELS, 0)
    for mode in ("onehot", "dma"):
        p = make_project("gcn", 1024, f"{mode}_1024", gather_mode=mode)
        p.gen_hw_model()
        p.init_params()
        p.gen_testbench(THROUGHPUT_GRAPHS)
        wrappers = zero_counts()
        packed = p._run_packed_testbench(p.params)
        for k, w in wrappers.items():
            total[k] += w.launches
        check(packed["mae"] <= 1e-4
              and packed["n_graphs"] == THROUGHPUT_GRAPHS,
              f"gcn {mode} 1024: {packed}")
        results[mode] = (packed, p.run_synthesis()["packed"])
    print(f"[7] GCN Project at 1024 graphs/batch, "
          f"{THROUGHPUT_GRAPHS // 1024} measured batches: "
          + "; ".join(f"{m} {r['graphs_per_s']:.1f} graphs/s "
                      f"({r['mean_batch_ms']:.4f} ms per batch, MAE "
                      f"{r['mae']:.3e}; modeled {s['graphs_per_s']:.1f})"
                      for m, (r, s) in results.items()))
    return total, results


def precision_project_phase(dev, precision: str, fp32: dict,
                            batch_graphs: int = 1024) -> dict:
    """``Project(precision=...)`` for GCN at 1024 graphs/batch in both
    gather modes: ``calibrate()`` (int8 grids fitted, config.json
    carrying the policy), the testbench at the policy (output and, at
    int8, weight quantization error; SQNR of the testbench outputs
    against the fp32 references at least ``SQNR_FLOOR_DB``), the packed
    drain's graphs/s beside fp32's (``fp32``: ``throughput_phase``'s
    results) and the synthesis report's counted bytes beside fp32's: a
    ratio, below 1 at bf16; at int8 printed and not held, since the
    activations' casts add more bytes than the int8 tables save (PERF.md
    §6)."""
    launches = dict.fromkeys(KERNELS, 0)
    parts = []
    for mode in ("dma", "onehot"):
        tag = f"{mode}_{batch_graphs}_{precision}"
        p = make_project("gcn", batch_graphs, tag, gather_mode=mode,
                         precision=precision)
        p.gen_hw_model()
        p.init_params()
        p.gen_testbench(batch_graphs)
        policy = p.calibrate()
        config = json.loads((PROJECT_DIR / f"gcn_{tag}" /
                             "config.json").read_text())
        check(policy.calibrated == (precision == "int8")
              and config["precision"] == policy.describe(),
              f"gcn {mode} {precision}: calibrate() gave {policy}, "
              f"config.json {config['precision']}")
        wrappers = zero_counts()
        tb = p.build_and_run_testbench()
        for k, w in wrappers.items():
            launches[k] += w.launches
        q = tb["quant_error"]
        check(tb["precision"] == precision
              and q["output"]["sqnr_db"] >= SQNR_FLOOR_DB[precision]
              and ("weights" in q) == (precision == "int8")
              and tb["packed"]["n_graphs"] == batch_graphs,
              f"gcn {mode} {precision}: testbench {tb}")
        rep = p.run_synthesis()["packed"]
        ratio = rep["bytes_accessed"] / fp32[mode][1]["bytes_accessed"]
        check(precision == "int8" or ratio < 1.0,
              f"gcn {mode} {precision}: counted bytes {ratio:.4f} of fp32's")
        parts.append(
            f"{mode}: MAE {tb['mae']:.4e} (packed {tb['packed']['mae']:.4e})"
            f", quant error output {q['output']}"
            + (f", weights {q['weights']}" if "weights" in q else "")
            + f"; packed {tb['packed']['graphs_per_s']:.1f} graphs/s "
            f"(fp32 {fp32[mode][0]['graphs_per_s']:.1f}); counted bytes "
            f"{rep['bytes_accessed']:.0f} = {ratio:.4f} of fp32's "
            f"{fp32[mode][1]['bytes_accessed']:.0f}, modeled "
            f"{rep['graphs_per_s']:.1f} graphs/s; {grids(policy)}")
    print(f"[7] GCN Project at {precision}, {batch_graphs} graphs/batch: "
          + "; ".join(parts) + f"; launches {launches}")
    return launches


def project_phase(dev, by_precision: dict) -> dict:
    """Phase 7; ``by_precision`` gains the launches of each precision's
    programs (the Listing 1 fixed-point programs run the fp32 policy)."""
    launches = dict.fromkeys(KERNELS, 0)
    parts = [listing1_phase(dev)]
    parts += [onehot_conv_phase(dev, conv) for conv in LAUNCHES_PER_BATCH]
    parts += [resident_project_phase(dev, conv) for conv in RESIDENT_CONVS]
    total, fp32 = throughput_phase(dev)
    parts.append(total)
    for part in parts:
        for k, v in part.items():
            launches[k] += v
            by_precision["fp32"][k] += v
    for precision in LOW_PRECISIONS:
        for k, v in precision_project_phase(dev, precision, fp32).items():
            launches[k] += v
            by_precision[precision][k] += v
    return launches


# ----------------------------------------------------------- phase 8 --
# the kernels each reached through its own entry point (kernels/*/ops.py)
ENTRY_KERNELS = ("gnn_aggregate", "tiled_matmul", "flash_attention")
ENTRY_META = {
    "gnn_aggregate": dict(
        source="src/repro_torch/csrc/gnn_aggregate.cu",
        replaces="src/repro/kernels/gnn_aggregate/kernel.py:90"),
    "tiled_matmul": dict(
        source="src/repro_torch/csrc/tiled_matmul.cu",
        replaces="src/repro/kernels/tiled_linear/kernel.py:35"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:57"),
}
GNN_AGG_BLOCKS = (32, 128)          # block_nodes held against the plain
# max|err| <= tol * max|plain| (matmul) or elementwise rtol/atol
# (attention): the products sum in another order in fp32; kernel and plain
# both round the fp32 result to bf16 once, so two bf16 outputs can land
# on neighbouring bf16 values, one step apart (at most 2^-7 of the value)
MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=8e-3, atol=1e-4)}
# the ragged triples (M, K, N, bm, bn, bk) of the JAX package's own
# kernel test (tests/test_kernels.py)
MATMUL_TRIPLES = ((128, 128, 128, 64, 64, 64), (130, 200, 70, 64, 64, 64),
                  (32, 512, 96, 32, 32, 128))
# the wgmma bodies' edges (bf16): several K stages and a partial N tile;
# ragged M and K (TMA's zero fill); and qwen3-8b's up-projection
WGMMA_MATMUL_EDGES = ((192, 448, 320), (130, 200, 72))
# (bh, Sq, Skv, D, tiles, causal set): Sq != Skv under the top-left causal
# mask at D = 128, whisper's ragged 1500 at D = 64 causal too
WGMMA_ATTN_EDGES = ((2, 300, 700, 128, 128, 128, (True, False)),
                    (2, 700, 300, 128, 128, 128, (True, False)),
                    (8, 1500, 1500, 64, 128, 128, (True,)))
# the wgmma body's wide instances (bf16 only; fp32 there raises): D = 192
# (three 64-column boxes) with Dv = 128, MLA's prefill, at Sq != Skv;
# Dv = 64 beside it; D = 144 (zero-filled to 192), each (bh, Sq, Skv, D,
# Dv, tiles, causal set)
WGMMA_WIDE_ATTN = ((2, 300, 700, 192, 128, 128, 128, (True, False)),
                   (2, 200, 129, 192, 64, 128, 128, (True, False)),
                   (3, 100, 100, 144, 128, 128, 128, (True,)))
BODIES = ("wgmma", "simt")
# the bf16 calls held against their plain versions that must run the
# SIMT body: the matmul's (M, K, N) where K or N is no multiple of 8
# (TMA's 16-byte row pitch), and attention where D or Dv is no multiple
# of 16 (a k16 step), each (bh, Sq, Skv, D, Dv, tiles, causal set)
SIMT_BF16_MATMUL = ((130, 200, 70), (27656, 11, 128))
# the fp32 SIMT bodies' edges: (M, K, N) reaching every tile of
# tiled_linear.kernel.SIMT_TILES with ragged M, N and K (4-byte copies
# where K or N is no multiple of 4), and attention (bh, Sq, Skv, D, Dv,
# tiles, causal set) at D = 128 causal over 8 KV tiles, Sq != Skv at
# D = 40 / Dv = 24, and D = 30 / Dv = 18 (4-byte copies)
SIMT_MATMUL_EDGES = ((12801, 11, 130), (12801, 35, 61), (12801, 128, 60),
                     (1000, 11, 70), (1000, 52, 68))
SIMT_ATTN_EDGES = ((2, 512, 512, 128, 128, 128, 128, (True,)),
                   (3, 100, 1500, 40, 24, 64, 64, (True, False)),
                   (3, 700, 300, 40, 24, 64, 64, (True, False)),
                   (2, 77, 33, 30, 18, 64, 64, (True, False)))
SIMT_BF16_ATTN = ((3, 40, 72, 40, 40, 32, 48, (True, False)),
                  (2, 130, 130, 64, 24, 64, 64, (True, False)))
# qwen3-8b (configs/qwen3_8b.py): d_model 4096, d_ff 12288, 32 query
# heads over 8 KV heads of 128; a 4096-token prefill
QWEN3 = dict(d_model=4096, d_ff=12288, heads=32, kv_heads=8, head_dim=128,
             tokens=4096)
# whisper-base's encoder (configs/whisper_base.py: 8 heads of 64,
# bidirectional) at its 1500 audio frames (arXiv:2212.04356), 4 clips
WHISPER = dict(batch=4, heads=8, head_dim=64, frames=1500)


def entry_counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gnn_aggregate.ops import gnn_aggregate
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul
    return dict(zip(ENTRY_KERNELS,
                    (gnn_aggregate, tiled_matmul, flash_attention)))


def product_rate(dtype: torch.dtype) -> float:
    """The peak that bounds a product kernel's operations: the tensor
    cores' for bf16 operands (the least time the card could take, not
    what a SIMT kernel reaches), the fp32 SIMT rate for fp32 (TF32 off)."""
    return TC_BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
        else FP32_FLOPS_PER_S


def padded_tables(batch, frame) -> list:
    """(label, N, nbr int32 numpy) of the two padded tables of the path:
    the packed batch as one table, and Project's 600-node frame of one
    graph; K is each one's max in-degree over its valid edges."""
    from repro_torch.kernels.gnn_aggregate.ref import neighbor_table
    out = []
    for label, ei, n in (("qm9 1024 graphs/batch", batch["edge_index"],
                          batch["node_feat"].shape[0]),
                         ("Project 600-node frame", frame.edge_index,
                          frame.node_feat.shape[0])):
        ei = np.asarray(ei)
        ok = (ei[:, 0] >= 0) & (ei[:, 1] >= 0)
        k = int(np.bincount(ei[ok, 1], minlength=n).max())
        out.append((label, n, neighbor_table(ei[ok], n, k)))
    return out


def gnn_agg_edge_tables(rng) -> list:
    """(label, N, F, nbr) edge cases: empty rows, ids >= N and below -1,
    N = 37 (no block divides it), F = 33 and F = 256; one row (N = 1); no
    slots (K = 0); more slots than a warp has lanes (K = 40) at a ragged
    F = 257."""
    from repro_torch.kernels.gnn_aggregate.ref import neighbor_table
    out = []
    for n, f, k in ((37, 33, 5), (300, 256, 9), (1, 3, 3), (500, 24, 0),
                    (300, 257, 40)):
        ei = rng.integers(0, n, (3 * n if k < 32 else 60 * n,
                                 2)).astype(np.int32)
        nbr = neighbor_table(ei, n, k)
        if n > 5 and k > 1:
            nbr[0, :] = -1
            nbr[3, :] = -1
            nbr[1, 0], nbr[2, 1], nbr[4, k - 1] = n, n + 11, -7
            nbr[5, :] = 2 ** 31 - 1
        out.append((f"edge cases N={n} F={f} K={k}", n, f, nbr))
    return out


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits, NaN at the same places (a bf16 value widens to fp32
    exactly)."""
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    return torch.equal(torch.isnan(g), nan) and torch.equal(
        g[~nan].view(torch.int32), w[~nan].view(torch.int32))


def close_to(name: str, label: str, got, want, tol: dict, errs: dict,
             on_scale: bool = False) -> None:
    """``got`` against ``want`` (both compared in fp32): elementwise
    rtol/atol, or ``on_scale``: max|err| <= rtol * max|want|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {label}: {got.dtype}{tuple(got.shape)} != "
          f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite")
    err = float((g - w).abs().max())
    errs[name] = max(errs.get(name, 0.0), err)
    ok = err <= tol["rtol"] * float(w.abs().max()) if on_scale \
        else torch.allclose(g, w, **tol)
    check(ok, f"{name} {label}: max |err| {err} outside {tol}")


def launched_body(label: str, launch, *args, want: str, **kwargs) -> tuple:
    """(output, body) of one call of a ``*_cuda`` launch, the body as the
    launch itself records it in ``by_body``; fails unless it is ``want``.
    An fp32 output is launched a second time and must give the same
    bits (the SIMT bodies sum in a fixed order, with no atomics)."""
    counts = dict.fromkeys(BODIES, 0)
    out = launch(*args, by_body=counts, **kwargs)
    check(counts == {**dict.fromkeys(BODIES, 0), want: 1},
          f"{label}: ran {counts}, expected one {want} launch")
    if out.dtype == torch.float32:
        check(torch.equal(out, launch(*args, **kwargs)),
              f"{label}: a second launch gave other bits")
    return out, want


def entry_kernels_vs_plain(dev, tables) -> dict:
    """Each kernel against its plain version on the card, outside the
    counted run: the padded-table aggregation bit for bit (every agg,
    fp32 and bf16, at every geometry ``launch_geometry`` chooses for the
    shape on this card's SMs, on 8 and on 1, and through block_nodes 32
    and 128; the edge cases, the packed table and Project's frame), the
    matmul at the ragged triples in fp32 and bf16 and the GCN transforms,
    attention causal and not in fp32 and bf16 with ragged S."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse2_ref, attention_ref)
    from repro_torch.kernels.gnn_aggregate.kernel import (gnn_aggregate_cuda,
                                                          launch_geometry)
    from repro_torch.kernels.gnn_aggregate.ref import AGGS, gnn_aggregate_ref
    from repro_torch.kernels.tiled_linear.kernel import (SIMT_TILES,
                                                         simt_tile_for,
                                                         tiled_matmul_cuda)
    from repro_torch.kernels.tiled_linear.ops import blocks_from_parallelism
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

    rng = np.random.default_rng(8)
    errs: dict = {}
    n_cmp = 0
    by_body = dict.fromkeys(BODIES, 0)
    label, n, nbr = tables[0]
    frame_label, frame_n, frame_nbr = tables[1]
    cases = gnn_agg_edge_tables(rng) + [(label, n, 64, nbr)] + [
        (frame_label, frame_n, f, frame_nbr) for f in (11, 128, 256)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometries = set()
    for label, n, f, nbr in cases:
        nt = torch.from_numpy(nbr).to(dev)
        x = torch.randn((n, f), device=dev) * 3
        for dt in (torch.float32, torch.bfloat16):
            xt = x.to(dt)
            shapes = {launch_geometry(n, f, nbr.shape[1], s,
                                      xt.element_size())
                      for s in (sms, 8, 1)}
            geometries |= shapes
            for agg in AGGS:
                want = gnn_aggregate_ref(xt, nt, agg=agg)
                launches = [dict(geometry=g) for g in shapes] + [
                    dict(block_nodes=bn) for bn in GNN_AGG_BLOCKS]
                for kw in launches:
                    got = gnn_aggregate_cuda(xt, nt, agg=agg, **kw)
                    check(got.dtype == dt, f"gnn_aggregate {label}: "
                                           f"{got.dtype} out of {dt}")
                    compare("gnn_aggregate", agg, got.float(), want.float(),
                            errs)
                    check(same_bits(got, want),
                          f"gnn_aggregate {label} {agg} {dt} {kw}: not bit "
                          "for bit the plain version")
                    n_cmp += 1
    print(f"[8] gnn_aggregate bit for bit at {len(geometries)} geometries "
          f"(lanes a row {sorted({g.lanes_per_row for g in geometries})}, "
          f"columns a lane {sorted({g.cols_per_lane for g in geometries})})")
    both, bf16 = (torch.float32, torch.bfloat16), (torch.bfloat16,)
    qwen3 = (QWEN3["tokens"], QWEN3["d_model"], QWEN3["d_ff"])
    matmul_cases = [(t, both) for t in MATMUL_TRIPLES + (
        (27656, 11, 128, 128, 128, 128), (1024, 192, 64, 128, 128, 128))]
    matmul_cases += [((m, k, n, 128, 128, 128), bf16)
                     for m, k, n in WGMMA_MATMUL_EDGES + (qwen3,)]
    matmul_cases += [((m, k, n, 128, 128, 128), (torch.float32,))
                     for m, k, n in SIMT_MATMUL_EDGES]
    tiles = {simt_tile_for(m, n) for m, _, n in SIMT_MATMUL_EDGES}
    check(tiles == set(range(len(SIMT_TILES))),
          f"SIMT_MATMUL_EDGES reach the tiles {sorted(tiles)} of "
          f"{len(SIMT_TILES)}")
    for (m, k, nn, bm, bn, bk), dts in matmul_cases:
        for dt in dts:
            x = torch.randn((m, k), device=dev).to(dt)
            w = torch.randn((k, nn), device=dev).to(dt)
            label = f"({m}, {k}) @ ({k}, {nn}) {dt}"
            got, body = launched_body(
                label, tiled_matmul_cuda, x, w, block_m=bm, block_n=bn,
                block_k=bk, want="wgmma" if dt == torch.bfloat16 and (
                    m, k, nn) not in SIMT_BF16_MATMUL else "simt")
            close_to("tiled_matmul", f"{label} {body}", got,
                     tiled_matmul_ref(x, w),
                     dict(rtol=MATMUL_TOL[dt], atol=0.0), errs, on_scale=True)
            by_body[body] += 1
            del x, w, got
    # the tiles of the parallel (16, 8) and base (1, 1) designs are no
    # launch knobs: the same bits at GCN layer 1's transform
    x = torch.randn((27656, 128), device=dev)
    w = torch.randn((128, 64), device=dev)
    outs = [tiled_matmul_cuda(x, w, block_m=128, block_n=bn, block_k=bk)
            for bk, bn in (blocks_from_parallelism(16, 8),
                           blocks_from_parallelism(1, 1))]
    check(torch.equal(*outs), "tiled_matmul: the (16, 8) and (1, 1) "
                              "designs' tiles give different results")
    attn_cases = [(bh, sq, skv, d, d, bq, bk, cs)
                  for bh, sq, skv, d, bq, bk, cs in (
                      (4, 128, 128, 32, 64, 64, (True, False)),
                      (2, 256, 256, 64, 64, 64, (True, False)),
                      (1, 64, 64, 16, 64, 64, (True, False)),
                      (8, 1500, 1500, 64, 128, 128, (False,)),
                      (8, 100, 100, 64, 128, 128, (False,)),
                      (3, 40, 72, 128, 32, 48, (True, False)),
                      (2, 1024, 1024, 128, 128, 128, (True,)),
                      *WGMMA_ATTN_EDGES)]
    for case in (attn_cases + list(SIMT_BF16_ATTN) + list(SIMT_ATTN_EDGES)
                 + list(WGMMA_WIDE_ATTN)):
        bh, sq, skv, d, dv, bq, bk, causal_set = case
        dts = (torch.float32,) if case in SIMT_ATTN_EDGES \
            else (torch.bfloat16,) if case in WGMMA_WIDE_ATTN \
            else (torch.float32, torch.bfloat16)
        for dt in dts:
            q, k = (torch.randn((bh, s, d), device=dev).to(dt)
                    for s in (sq, skv))
            v = torch.randn((bh, skv, dv), device=dev).to(dt)
            for causal in causal_set:
                label = (f"bh={bh} Sq={sq} Skv={skv} D={d} Dv={dv} tiles "
                         f"({bq}, {bk}) causal={causal} {dt}")
                got, body = launched_body(
                    label, flash_attention_cuda, q, k, v, causal=causal,
                    block_q=bq, block_k=bk,
                    want="wgmma" if dt == torch.bfloat16
                    and case not in SIMT_BF16_ATTN else "simt")
                close_to("flash_attention", f"{label} {body}", got,
                         attention_ref(q, k, v, causal=causal),
                         ATTN_TOL[dt], errs)
                by_body[body] += 1
                # a training forward: the same output bits, and lse2
                same, lse2 = flash_attention_cuda(
                    q, k, v, causal=causal, block_q=bq, block_k=bk,
                    with_lse2=True)
                check(same_bits(same, got), f"flash_attention {label} "
                      f"{body}: the forward asked for lse2 has other bits")
                close_to("flash_attention lse2", f"{label} {body}", lse2,
                         attention_lse2_ref(q, k, causal=causal),
                         dict(rtol=LSE_TOL, atol=0.0), errs, on_scale=True)
    # D above the SIMT body's 128 runs only on the wgmma body: fp32, and
    # bf16 at a pointer TMA cannot take, raise naming the limits
    def wide(dv, dt, offset=0):      # contiguous, ``offset`` elements in
        flat = torch.randn(2 * 64 * dv + offset, device=dev).to(dt)
        return flat[offset:].view(2, 64, dv)
    for label, args in (
            ("fp32", (wide(192, torch.float32), wide(192, torch.float32),
                      wide(128, torch.float32))),
            ("bf16 misaligned", (wide(192, torch.bfloat16, 1),
                                 wide(192, torch.bfloat16, 1),
                                 wide(128, torch.bfloat16, 1)))):
        try:
            flash_attention_cuda(*args)
        except ValueError as e:
            check("192" in str(e) and "128" in str(e),
                  f"flash_attention D = 192 {label}: {e}")
        else:
            raise PhaseError(f"flash_attention D = 192 {label} launched")
    torch.cuda.synchronize()
    n_cmp += sum(by_body.values())
    print(f"[8] {n_cmp} kernel-vs-plain comparisons passed (matmul and "
          f"attention by body: {by_body}); max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def entry_calls(dev, tables) -> list:
    """The full-width calls of phase 8's path, each (kernel, label, ops
    call, kernel launch, plain, library or None, (bytes, operations),
    rate): the padded-table aggregation at the packed table (F = 64, 128)
    and Project's frame (F = 11, 128, 256); the GCN transforms at 1024
    graphs/batch and the MLP head with the tiles of the parallel (16, 8)
    design, and qwen3-8b's MLP up-projection in bf16;
    qwen3-8b's causal prefill attention in bf16 and whisper-base's
    encoder attention in fp32 and bf16."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.kernels._cost import (attention_work, matmul_work,
                                           padded_agg_work)
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gnn_aggregate import ops as GO
    from repro_torch.kernels.gnn_aggregate.kernel import gnn_aggregate_cuda
    from repro_torch.kernels.gnn_aggregate.ref import gnn_aggregate_ref
    from repro_torch.kernels.tiled_linear import ops as TO
    from repro_torch.kernels.tiled_linear.kernel import tiled_matmul_cuda
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(dtype)

    calls = []
    for (label, n, nbr), widths in zip(tables, ((64, 128), (11, 128, 256))):
        nt = torch.from_numpy(nbr).to(dev)
        # the library's inputs, made outside the timing: embedding_bag
        # takes the (N, K) table as N bags with padding id N, a zero row
        bags = torch.where((nt >= 0) & (nt < n), nt,
                           torch.full_like(nt, n)).long()
        for f in widths:
            for agg in ("sum", "std") if f == 128 and n > 600 else ("sum",):
                x = randn(n, f)
                x_pad = torch.cat([x, x.new_zeros(1, f)])
                lib = None if agg in ("var", "std") else (
                    lambda x_pad=x_pad, bags=bags, agg=agg, n=n:
                    torch.nn.functional.embedding_bag(
                        bags, x_pad, mode=agg, padding_idx=n))
                calls.append((
                    "gnn_aggregate",
                    f"{label} {agg}: N={n} K={nt.shape[1]} F={f} fp32 "
                    f"(valid slots {int(((nt >= 0) & (nt < n)).sum())})",
                    lambda x=x, nt=nt, agg=agg: GO.gnn_aggregate(
                        x, nt, agg=agg, block_nodes=128),
                    lambda x=x, nt=nt, agg=agg: gnn_aggregate_cuda(
                        x, nt, agg=agg, block_nodes=128),
                    lambda x=x, nt=nt, agg=agg: gnn_aggregate_ref(
                        x, nt, agg=agg),
                    lib, padded_agg_work(x, nt, agg=agg),
                    FP32_FLOPS_PER_S))
    cfg = benchmark_config("gcn")
    n = tables[0][1]
    shapes = [(n, cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim,
               f"GCN layer {i} transform")
              for i in range(cfg.gnn_num_layers)]
    shapes.append((1024, 192, 64, "MLP head layer 0"))
    # the parallel design's tiles; the base design's give the same bits
    # (entry_kernels_vs_plain), so they are not timed again
    bk, bn = TO.blocks_from_parallelism(16, 8)
    for m, k, nn, what in shapes:
        x, w = randn(m, k), randn(k, nn, scale=k ** -0.5)
        calls.append((
            "tiled_matmul",
            f"{what}: ({m}, {k}) @ ({k}, {nn}) fp32, tiles of design "
            f"(16, 8) (128, {bn}, {bk})",
            lambda x=x, w=w: TO.tiled_matmul(
                x, w, block_m=128, block_n=bn, block_k=bk),
            lambda x=x, w=w: tiled_matmul_cuda(
                x, w, block_m=128, block_n=bn, block_k=bk),
            lambda x=x, w=w: tiled_matmul_ref(x, w),
            lambda x=x, w=w: torch.matmul(x, w),
            matmul_work(x, w), product_rate(x.dtype)))
    t, d, ff = QWEN3["tokens"], QWEN3["d_model"], QWEN3["d_ff"]
    x = randn(t, d, dtype=torch.bfloat16)
    w = randn(d, ff, dtype=torch.bfloat16, scale=d ** -0.5)
    calls.append((
        "tiled_matmul", f"qwen3-8b MLP up-projection, {t}-token prefill: "
        f"({t}, {d}) @ ({d}, {ff}) bf16",
        lambda x=x, w=w: TO.tiled_matmul(x, w),
        lambda x=x, w=w: tiled_matmul_cuda(x, w),
        lambda x=x, w=w: tiled_matmul_ref(x, w),
        lambda x=x, w=w: torch.matmul(x, w),
        matmul_work(x, w), product_rate(x.dtype)))
    qh, kvh, hd = QWEN3["heads"], QWEN3["kv_heads"], QWEN3["head_dim"]
    q = randn(1, qh, t, hd, dtype=torch.bfloat16)
    # K/V of the 8 KV heads expanded to the 32 query heads, as the
    # reference's nn/attention._expand_kv repeats each head
    k, v = (randn(1, kvh, t, hd, dtype=torch.bfloat16)
            .repeat_interleave(qh // kvh, dim=1).contiguous()
            for _ in range(2))
    attn = [(f"qwen3-8b causal prefill: B=1 H={qh} (K/V from {kvh} heads) "
             f"S={t} D={hd} bf16", q, k, v, True)]
    b, h, s, hd = (WHISPER["batch"], WHISPER["heads"], WHISPER["frames"],
                   WHISPER["head_dim"])
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn(b, h, s, hd, dtype=dt) for _ in range(3))
        attn.append((f"whisper-base encoder: B={b} H={h} S={s} D={hd} "
                     f"non-causal {str(dt).split('.')[-1]}", q, k, v, False))
    for label, q, k, v, causal in attn:
        q3, k3, v3 = (a.reshape(-1, *a.shape[2:]) for a in (q, k, v))
        calls.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal: FO.flash_attention(
                q, k, v, causal=c),
            lambda q3=q3, k3=k3, v3=v3, c=causal: flash_attention_cuda(
                q3, k3, v3, causal=c),
            lambda q3=q3, k3=k3, v3=v3, c=causal: attention_ref(
                q3, k3, v3, causal=c),
            lambda q=q, k=k, v=v, c=causal:
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=c),
            attention_work(q, k, v, causal=causal), product_rate(q.dtype)))
    return calls


def entry_path_phase(dev, calls, errs: dict) -> tuple:
    """Drive phase 8's path once through the entry points: the counts are
    set to 0 just before and read just after; each call launches its
    kernel once and agrees with the plain version. The matmul's and
    attention's ``launches_by_body`` say which body each call ran: every
    bf16 call "wgmma", every fp32 call "simt". Returns the launches and
    each call's body (None for ``gnn_aggregate``, which has one)."""
    wrappers = entry_counters()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "launches_by_body"):
            w.launches_by_body = dict.fromkeys(BODIES, 0)
    outs, bodies = [], []
    for name, _, call, *_ in calls:
        w = wrappers[name]
        before = dict(getattr(w, "launches_by_body", {}))
        outs.append(call())
        ran = [b for b, n in getattr(w, "launches_by_body", {}).items()
               if n != before[b]]
        bodies.append(ran[0] if len(ran) == 1 else None)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    for name in ENTRY_KERNELS:
        want = sum(c[0] == name for c in calls)
        check(launches[name] == want, f"{name}: {launches[name]} launches "
                                      f"on phase 8's path, expected {want}")
    for (name, label, *_), out, body in zip(calls, outs, bodies):
        if name == "gnn_aggregate":
            continue
        want = "wgmma" if out.dtype == torch.bfloat16 else "simt"
        check(body == want, f"{name} {label}: ran the {body} body, "
                            f"expected {want} for {out.dtype}")
    by_body = {k: w.launches_by_body for k, w in wrappers.items()
               if hasattr(w, "launches_by_body")}
    for name, counts in by_body.items():
        check(sum(counts.values()) == launches[name],
              f"{name}: launches by body {counts} do not add up to "
              f"{launches[name]}")
    for (name, label, _, _, plain, lib, *_), out in zip(calls, outs):
        ref = plain()
        if name == "gnn_aggregate" and lib is not None:
            # the library yardstick computes the same function
            close_to(name, label + " (library)", lib(), ref,
                     dict(rtol=1e-5, atol=0.0), {}, on_scale=True)
        if name == "tiled_matmul":
            close_to(name, label, out, ref, dict(
                rtol=MATMUL_TOL[out.dtype], atol=0.0), errs, on_scale=True)
        elif name == "flash_attention":
            close_to(name, label, out, ref.reshape(out.shape),
                     ATTN_TOL[out.dtype], errs)
        else:
            close_to(name, label, out, ref, SEGMENT_TOL, errs)
        del ref
    print(f"[8] path: {len(calls)} full-width calls through the entry "
          f"points, launches {launches}, by body {by_body}; each against "
          f"its plain version, every bf16 call on wgmma, every fp32 one on "
          f"simt")
    return launches, bodies


def entry_timing_phase(calls, bodies) -> list:
    """Each full-width call timed as phase 6 times (a long kernel with
    fewer runs), beside its plain version, its library call and its
    bound (the operations of a bf16 product at the tensor-core peak),
    with the body it ran."""
    rows = []
    for (name, label, _, kern, plain, lib, (moved, ops), rate), body in zip(
            calls, bodies):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kern()
        end.record()
        end.synchronize()
        reps = (7, 2) if start.elapsed_time(end) > 2.0 else (25, 10)
        bound, by = bound_ms(moved, ops, rate)
        rows.append(dict(
            kernel=name, shape=label,
            ms=cuda_ms(kern, *reps),
            plain_ms=cuda_ms(plain, reps=5, inner=1, device_only=False),
            library_ms=None if lib is None else cuda_ms(lib, *reps),
            bound_ms=bound, bound_by=by, body=body))
        r = rows[-1]
        lib_s = "n/a" if r["library_ms"] is None \
            else f"{r['library_ms']:.5f} ms"
        body_s = "" if body is None else f" [{body} body]"
        print(f"[8] {name}{body_s} {label}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib_s}, bound "
              f"{r['bound_ms']:.6f} ms ({by}), {ops / r['ms'] * 1e-9:.3f} "
              f"TFLOP/s")
    return rows


def summarize_entries(rows, errs, launches) -> list:
    """One entry per entry-point kernel: sums over phase 8's full-width
    calls (one launch each), with each call's numbers under ``calls``."""
    out = []
    for name in ENTRY_KERNELS:
        sel = [r for r in rows if r["kernel"] == name]
        check(len(sel) == launches[name],
              f"{name}: {len(sel)} timed calls for {launches[name]} "
              "launches on phase 8's path")
        libs = [r for r in sel if r["library_ms"] is not None]
        entry = {
            "name": name, "route": "cuda", **ENTRY_META[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sel)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in libs) if libs
            else None,
            "shapes": "phase 8 path, one launch per call: "
                      + "; ".join(r["shape"] for r in sel),
            "calls": [{k: r[k] for k in ("shape", "body", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")} for r in sel],
        }
        if any(r["body"] for r in sel):
            # the same sums for the calls of each body
            entry["by_body"] = {b: {
                "launches": sum(r["body"] == b for r in sel),
                **{k: sum(r[k] for r in sel if r["body"] == b)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": sum(r["library_ms"] for r in sel
                                  if r["body"] == b)}
                for b in BODIES}
        if len(libs) < len(sel):
            # library_ms sums the calls that have one; the kernel's ms
            # over the same calls stands beside it
            entry["library_calls"] = len(libs)
            entry["ms_on_library_calls"] = sum(r["ms"] for r in libs)
            entry["library_note"] = NO_LIBRARY[name]
        out.append(entry)
    return out


# ----------------------------------------------------------- phase 9 --
# the load-shaped continuous drains: (conv, graphs/batch, requests, load
# as a share of the wave drain's graphs/s for that conv and batch size in
# phase 4 of the same call)
CONTINUOUS_RUNS = tuple((conv, 32, 512, 0.5)
                        for conv in LAUNCHES_PER_BATCH) \
    + (("gcn", 1024, 8192, 0.5), ("gcn", 1024, 8192, 0.9))
# the padded oracle (gnn_model.apply) pools with plain PyTorch reductions:
# a graph launches the per-layer kernels of LAUNCHES_PER_BATCH, without
# the pooling's segment launch
ORACLE_LAUNCHES = {c: tuple(n - (name == "segment_aggregate")
                            for name, n in zip(KERNELS, t))
                   for c, t in LAUNCHES_PER_BATCH.items()}
# the oversize route: GCN at 32 graphs/batch, this many giant graphs
# (serve --oversize-requests) behind 64 qm9 ones
OVERSIZE_REQUESTS = 4
# the fault-injected measured drain (GCN, 32 graphs/batch): a seeded
# plan (runtime.faults.FaultPlan.random) whose first 11 calls hold every
# fault kind, a 50 ms launch timeout and two retries
FAULT_SEED = 6
FAULT_RATES = {"crash": 0.1, "hang": 0.1, "slowdown": 0.1, "corrupt": 0.1}
FAULT_TIMEOUT_MS = 50.0
FAULT_RETRIES = 2


class KernelFault(BaseException):
    """An exception inside the served program during phase 9. The
    scheduler handles any ``Exception`` of an executor as a lane fault
    (retry, then dead letter); after a CUDA error every retry fails too,
    so this derives from ``BaseException``, passes the scheduler's
    handler and stops the phase at the first failure."""


@contextlib.contextmanager
def fail_fast():
    """Route every exception of ``gnn_model.apply_packed``/``apply`` (and
    of the device work they queued: each call waits for the device) into
    ``KernelFault`` while the block runs."""
    from repro_torch.core import gnn_model as G
    real = G.apply_packed, G.apply

    def guard(fn):
        def call(*args, **kwargs):
            try:
                out = fn(*args, **kwargs)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                return out
            except Exception as e:
                raise KernelFault(f"{fn.__name__}: {e!r}") from e
        return call

    G.apply_packed, G.apply = guard(real[0]), guard(real[1])
    try:
        yield
    finally:
        G.apply_packed, G.apply = real


def counts_of(wrappers: dict) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


def check_launches(label: str, launches: dict, per: dict) -> None:
    """``per``: {per-call launch table: number of calls}."""
    for i, name in enumerate(KERNELS):
        want = sum(t[i] * n for t, n in per.items())
        check(launches[name] == want,
              f"{label}: {launches[name]} {name} launches, expected {want}")


def replay_launches(dev, conv: str, queue, nb: int, eb: int, bg: int,
                    launches, responses) -> int:
    """Each served packed launch re-run offline: its composition packed
    again and sent through ``apply_packed`` on the card with the serving
    weights; every row bit for bit the drain's. Returns the launches
    replayed."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    cfg = benchmark_config(conv)
    params = serve_params(cfg, dev)
    by = {r.req_id: r for r in responses}
    n = 0
    with torch.inference_mode():
        for launch in launches:
            if launch["status"] != "ok" or launch["kind"] != "packed":
                continue
            batch, k = P.pack_graphs([queue[r] for r in launch["req_ids"]],
                                     nb, eb, bg)
            check(k == len(launch["req_ids"]),
                  f"{conv}: launch {launch['seq']} does not pack again")
            ref = G.apply_packed(params, cfg, G.packed_to_device(
                batch, dev)).cpu().numpy()
            for j, rid in enumerate(launch["req_ids"]):
                check(by[rid].batch_seq == launch["seq"]
                      and np.array_equal(by[rid].output, ref[j]),
                      f"{conv}: request {rid} of launch {launch['seq']} is "
                      "not bit for bit its offline re-run")
            n += 1
    return n


def clean_run(label: str, stats: dict) -> None:
    """A fault-free drain: no failed launch, retry, dead letter, crash or
    timeout."""
    bad = [e for e in stats["events"] if e["kind"] == "launch_failed"]
    check(not bad and stats["failed"] == 0 and stats["retries"] == 0
          and stats["failed_launches"] == 0,
          f"{label}: {stats['failed_launches']} failed launches "
          f"({[e['error'] for e in bad][:5]}), {stats['failed']} failed "
          "requests")


def latency_ms(v) -> str:
    return "n/a" if v is None else f"{v * 1e3:.4f} ms"


def continuous_phase(dev, conv: str, batch_graphs: int, requests: int,
                     share: float, wave: dict) -> dict:
    """``serve --scheduler continuous`` at ``share`` of the wave drain's
    graphs/s: every request ``served_packed``, no failed launch, the
    launches of ``LAUNCHES_PER_BATCH`` per batch (warm-up included) and
    each launch bit for bit its offline re-run."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.runtime import scheduler as S

    rate, wave_p50 = wave[(conv, batch_graphs)]
    load = share * rate
    label = f"{conv} continuous {batch_graphs} at {share}x"
    wrappers = zero_counts()
    with fail_fast():
        responses, stats = serve.main([
            "--conv", conv, "--requests", str(requests), "--batch-graphs",
            str(batch_graphs), "--scheduler", "continuous", "--load",
            repr(load), "--queue-depth", str(max(1024, 4 * batch_graphs)),
            "--device", dev.type])
    launches = counts_of(wrappers)
    clean_run(label, stats)
    check(stats["served"] == stats["packed_served"] == requests
          and all(r.status == S.SERVED_PACKED for r in responses),
          f"{label}: served {stats['packed_served']} of {requests} packed")
    check(all(np.isfinite(r.output).all() for r in responses),
          f"{label}: non-finite output")
    n_batches = stats["n_batches"] + stats["warmup_batches"]
    check_launches(label, launches, {LAUNCHES_PER_BATCH[conv]: n_batches})
    ds = DATASETS["qm9"]
    nb, eb = serve.budgets(batch_graphs, ds)
    queue = [P.make_graph(ds, i) for i in range(requests)]
    replayed = replay_launches(dev, conv, queue, nb, eb, batch_graphs,
                               stats["launches"], responses)
    print(f"[9] {label} ({load:.1f} graphs/s offered, {requests} requests): "
          f"{stats['n_batches']} launches, p50 "
          f"{latency_ms(stats['p50_latency_s'])} p99 "
          f"{latency_ms(stats['p99_latency_s'])}, "
          f"batch fill {stats['mean_batch_fill']:.4f}, sustained "
          f"{stats['graphs_per_s']:.1f} graphs/s; the wave drain in phase 4: "
          f"{rate:.1f} graphs/s, batch latency p50 {wave_p50:.4f} ms; "
          f"{replayed} launches bit for bit their offline re-run; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return launches


def oversize_phase(dev, wave: dict) -> dict:
    """GCN at 32 graphs/batch with ``--oversize-requests``, through the
    wave and the continuous drain: every giant graph ``served_fallback``
    by ``apply`` on the card, within ``MODEL_TOL`` of the CPU plain
    path's ``apply`` on the same graph."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.launch import serve
    from repro_torch.runtime import scheduler as S

    ds = DATASETS["qm9"]
    bg, n = 32, 64
    nb, eb = serve.budgets(bg, ds)
    big = serve.oversize_graphs(ds, nb, eb, OVERSIZE_REQUESTS)
    cfg = benchmark_config("gcn")
    cpu_params = serve_params(cfg, "cpu")
    with torch.inference_mode():
        want = [G.apply(cpu_params, cfg, serve._fallback_input(g, "cpu"))
                for g in big]
    total = dict.fromkeys(KERNELS, 0)
    for scheduler in ("wave", "continuous"):
        label = f"gcn oversize, {scheduler}"
        argv = ["--conv", "gcn", "--requests", str(n), "--batch-graphs",
                str(bg), "--oversize-requests", str(OVERSIZE_REQUESTS),
                "--scheduler", scheduler, "--device", dev.type]
        if scheduler == "continuous":
            argv += ["--load", repr(0.5 * wave[("gcn", bg)][0])]
        wrappers = zero_counts()
        with fail_fast():
            outs, stats = serve.main(argv)
        launches = counts_of(wrappers)
        check(stats["packed_served"] == n
              and stats["fallback_served"] == OVERSIZE_REQUESTS
              and stats["served"] == n + OVERSIZE_REQUESTS,
              f"{label}: {stats['packed_served']} packed, "
              f"{stats['fallback_served']} fallback")
        if scheduler == "wave":
            check([o["status"] for o in stats["outcomes"][n:]]
                  == [S.SERVED_FALLBACK] * OVERSIZE_REQUESTS,
                  f"{label}: oversize outcomes {stats['outcomes'][n:]}")
            got = [o.cpu() for o in outs[stats["n_batches"]:]]
            lat = stats["oversize_latency_s"]
        else:
            clean_run(label, stats)
            by = {r.req_id: r for r in outs}
            fb = [by[n + i] for i in range(OVERSIZE_REQUESTS)]
            check(all(r.status == S.SERVED_FALLBACK for r in fb),
                  f"{label}: oversize statuses {[r.status for r in fb]}")
            got = [torch.from_numpy(r.output) for r in fb]
            lat = [r.complete_s - r.launch_s for r in fb]
        check_launches(label, launches, {
            LAUNCHES_PER_BATCH["gcn"]: stats["n_batches"]
            + stats["warmup_batches"],
            ORACLE_LAUNCHES["gcn"]: OVERSIZE_REQUESTS})
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        check(all(torch.allclose(g, w, **MODEL_TOL)
                  for g, w in zip(got, want)),
              f"{label}: fallback vs CPU apply max |err| {errs}")
        for k, v in launches.items():
            total[k] += v
        print(f"[9] {label}: {n} qm9 graphs packed, {OVERSIZE_REQUESTS} "
              f"giant graphs ({', '.join(str(g.num_nodes) for g in big)} "
              f"nodes in {big[0].node_feat.shape[0]}-node frames) served "
              f"by apply on the card, max |err| vs the CPU "
              f"{max(errs):.3e}; fallback latency per graph "
              + ", ".join(f"{v * 1e3:.4f}" for v in lat) + " ms")
    return total


def fault_phase(dev, wave: dict) -> dict:
    """GCN at 32 graphs/batch through ``drain_gnn_queue_continuous``
    under a seeded fault plan (crash, hang, slowdown, corrupt), a 50 ms
    launch timeout and two retries: every request one terminal status,
    every fault kind fired and recorded as its failure, every corrupted
    launch caught by the non-finite screen and its requests re-run (or
    dead-lettered after the retries), every served row bit for bit its
    launch's offline re-run."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.runtime import faults as F
    from repro_torch.runtime import scheduler as S

    ds = DATASETS["qm9"]
    bg, n = 32, 512
    nb, eb = serve.budgets(bg, ds)
    cfg = benchmark_config("gcn")
    params = serve_params(cfg, dev)
    queue = [P.make_graph(ds, i) for i in range(n)]
    plan = F.FaultPlan.random(FAULT_SEED, 4 * n // bg, FAULT_RATES)
    wrappers = zero_counts()
    with fail_fast():
        responses, stats = serve.drain_gnn_queue_continuous(
            lambda p, b: G.apply_packed(p, cfg, b), params, queue, nb, eb,
            bg, load_graphs_per_s=0.5 * wave[("gcn", bg)][0],
            launch_timeout_s=FAULT_TIMEOUT_MS / 1e3,
            max_retries=FAULT_RETRIES, device=dev, fault_plan=plan)
    launches = counts_of(wrappers)
    label = "gcn fault-injected"
    check(sorted(r.req_id for r in responses) == list(range(n)),
          f"{label}: a request without exactly one terminal status")
    injected = stats["injected"]
    check({k for _, k in injected} == set(F.KINDS),
          f"{label}: faults fired {injected}")
    log = stats["launches"]
    # one lane: its call i is launch i
    want = {"crash": S.FAIL_CRASH, "hang": S.FAIL_TIMEOUT,
            "corrupt": S.FAIL_NONFINITE, "slowdown": "ok"}
    fired = dict(injected)
    for launch in log:
        kind = fired.get(launch["seq"])
        expect = want[kind] if kind else "ok"
        check(launch["status"] == expect,
              f"{label}: launch {launch['seq']} ({kind or 'no fault'}) "
              f"ended {launch['status']}, expected {expect}")
    by = {r.req_id: r for r in responses}
    for call, kind in injected:
        if kind != "corrupt":
            continue
        for rid in log[call]["req_ids"]:
            check(by[rid].status == S.FAILED or any(
                rid in l["req_ids"] for l in log[call + 1:]),
                f"{label}: request {rid} of corrupted launch {call} was "
                "not re-run")
    # every call but a crash ran the program (a crash fires before it)
    ran = len(log) - sum(k == "crash" for _, k in injected)
    check_launches(label, launches, {LAUNCHES_PER_BATCH["gcn"]: ran})
    replayed = replay_launches(dev, "gcn", queue, nb, eb, bg, log,
                               responses)
    counts = {s: sum(r.status == s for r in responses)
              for s in (S.SERVED_PACKED, S.FAILED)}
    print(f"[9] {label} (seed {FAULT_SEED}, rates {FAULT_RATES}, timeout "
          f"{FAULT_TIMEOUT_MS} ms, {FAULT_RETRIES} retries): {len(log)} "
          f"launches, faults {injected}; {counts[S.SERVED_PACKED]} served, "
          f"{counts[S.FAILED]} dead-lettered, {stats['retries']} retries, "
          f"{stats['probes']['succeeded']} probe-backs, p99 "
          f"{latency_ms(stats['p99_latency_s'])}; {replayed} served "
          "launches bit for bit their offline re-run")
    return launches


def chaos_phase(dev) -> dict:
    """``tools/chaos_serving.py``'s smoke point, lane 0's GAT program on
    the card, with every gate held; the GAT kernels launch
    ``LAUNCHES_PER_BATCH["gat"]`` per program call."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chaos_serving", ROOT / "tools" / "chaos_serving.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    program = tool._gat_program(dev)
    key = next(k for k, v in tool._GAT_FN.items() if v is program)
    calls = []

    def counted(b):
        calls.append(1)
        return program(b)
    tool._GAT_FN[key] = counted
    wrappers = zero_counts()
    with fail_fast():
        res = tool.sweep([600], [1.0], 400, 0, device=dev,
                         log=lambda line: print(f"[9] chaos smoke: {line}"))
    launches = counts_of(wrappers)
    try:
        tool.check_acceptance(res)
    except AssertionError as e:
        raise PhaseError(f"chaos smoke gate: {e}") from e
    check(calls, "chaos smoke: lane 0 never ran the GAT program")
    check_launches("chaos smoke", launches,
                   {LAUNCHES_PER_BATCH["gat"]: len(calls)})
    return launches


def serving_phase(dev, wave: dict) -> dict:
    """Phase 9; returns the launches of every drain in it."""
    total = dict.fromkeys(KERNELS, 0)
    parts = [continuous_phase(dev, *run, wave) for run in CONTINUOUS_RUNS]
    parts += [oversize_phase(dev, wave), fault_phase(dev, wave),
              chaos_phase(dev)]
    for part in parts:
        for k, v in part.items():
            total[k] += v
    return total


# ---------------------------------------------------------- phase 10 --
# the multi-device layer on the one card: the ranks of one gloo group
# share it (NCCL needs a card a rank), each launching the port's kernels.
# DIST_RANKS ranks are spawned once; the sharded program and the 2-part
# partitions run on the sub-group of ranks 0 and 1
DIST_RANKS = 4
# graphs a shard of the sharded GCN drain, and its measured waves
SHARD_GRAPHS = 1024
SHARD_WAVES = 4
# the packed budgets (graphs a batch) the oversize graphs are cut under,
# as serve --oversize-requests builds them, and how many
PART_GRAPHS = 32
PART_REQUESTS = 4
# the hub graph: one node with this many in-edges (past the segment
# softmax's 128-edge fold, which it then splits in 32 parts)
HUB_IN_EDGES = 200
# serve --shards 2: qm9 requests at 32 graphs a shard behind the
# oversize ones
DIST_SERVE = ["--conv", "gcn", "--requests", "256", "--batch-graphs",
              str(PART_GRAPHS), "--oversize-requests", str(PART_REQUESTS),
              "--shards", "2", "--dist-backend", "gloo"]


def hub_graph(frame_nodes: int, frame_edges: int, n_in: int = HUB_IN_EDGES):
    """A qm9-width graph whose node 0 takes ``n_in`` in-edges from its
    spokes; each spoke also hears the hub and the next spoke on a ring.
    Features from a numpy seed, in a padded frame of ``frame_nodes`` /
    ``frame_edges`` rows (the oversize graphs' frames)."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    ds = DATASETS["qm9"]
    n = n_in + 1
    edges = [(i, 0) for i in range(1, n)] + [(0, i) for i in range(1, n)] \
        + [(i, i % n_in + 1) for i in range(1, n)]
    rng = np.random.default_rng(10)
    nf = np.zeros((frame_nodes, ds.node_feat_dim), np.float32)
    nf[:n] = rng.normal(size=(n, ds.node_feat_dim))
    ei = np.full((frame_edges, 2), -1, np.int32)
    ei[:len(edges)] = edges
    ef = np.zeros((frame_edges, ds.edge_feat_dim), np.float32)
    ef[:len(edges)] = rng.normal(size=(len(edges), ds.edge_feat_dim))
    return P.Graph(node_feat=nf, edge_index=ei, edge_feat=ef, num_nodes=n,
                   num_edges=len(edges), y=np.zeros((1,), np.float32))


def sharded_drain_rank(pair, dev) -> dict:
    """(a) on the ranks of ``pair``: the sharded GCN wave drain at
    ``SHARD_GRAPHS`` graphs a shard, full width, weights drawn on the
    root and broadcast; each rank's launches per wave as
    ``LAUNCHES_PER_BATCH`` says (counts zeroed just before the drain,
    read just after) and its shard of every wave bit for bit its own
    single-rank ``apply_packed`` of that shard on the card."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    ds = DATASETS["qm9"]
    cfg = benchmark_config("gcn")
    params = G.cast_for_policy(M.broadcast_tree(
        pair, serve_params(cfg, dev) if pair.is_root else None), cfg)
    nb, eb = serve.budgets(SHARD_GRAPHS, ds)
    queue = [P.make_graph(ds, i)
             for i in range(SHARD_WAVES * pair.size * SHARD_GRAPHS)]
    fn = G.make_sharded_apply(cfg, pair)
    serve.drain_gnn_queue_sharded(fn, params, queue[:pair.size
                                                    * SHARD_GRAPHS],
                                  nb, eb, SHARD_GRAPHS, pair.size,
                                  device=dev)
    wrappers = zero_counts()
    outs, stats = serve.drain_gnn_queue_sharded(
        fn, params, queue, nb, eb, SHARD_GRAPHS, pair.size, device=dev)
    launches = counts_of(wrappers)
    label = f"sharded gcn, rank {pair.rank}"
    check(stats["packed_served"] == len(queue),
          f"{label}: served {stats['packed_served']} of {len(queue)}")
    check_launches(label, launches,
                   {LAUNCHES_PER_BATCH["gcn"]: stats["n_batches"]})
    waves, _ = P.pack_dataset(queue, nb, eb, SHARD_GRAPHS,
                              num_shards=pair.size)
    check(len(waves) == stats["n_batches"], f"{label}: wave count")
    same = True
    with torch.inference_mode():
        for w, host in zip(waves, outs):
            ix = w.index[pair.rank]
            own = G.apply_packed(params, cfg, G.packed_to_device(
                w.shards[pair.rank], dev))[:len(ix)].cpu().numpy()
            same &= bool(np.array_equal(own, host[ix]))
            check(bool(np.isfinite(host).all()), f"{label}: non-finite")
    check(same, f"{label}: a shard differs from its single-rank output")
    return {"launches": launches, "waves": stats["n_batches"],
            "graphs_per_s": stats["graphs_per_s"]}


def partitioned_rank(mesh, groups: dict, dev) -> dict:
    """(b): every conv at fp32 on the ``PART_REQUESTS`` oversize graphs of
    ``serve.oversize_graphs`` at ``PART_GRAPHS`` graphs a batch's budgets
    and the hub, partitioned over each group of ``groups`` (by part
    count). The root holds each answer against the padded oracle
    ``apply`` on the card: bit for bit for the convs whose spec promises
    it (GCN, GAT), else within ``MODEL_TOL``. Each member's launches
    over a group's run (zeroed just before it) are
    ``ORACLE_LAUNCHES`` a graph: the per-layer kernels, the tail pooling
    with the oracle's plain reductions. Its ``tiled_matmul`` launches
    (every fp32 product of the program is row stable, as the oracle's
    are) are the oracle's a graph, less the head's products on every
    member but the root, which alone runs the tail."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import convs as C
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    ds = DATASETS["qm9"]
    nb, eb = serve.budgets(PART_GRAPHS, ds)
    big = serve.oversize_graphs(ds, nb, eb, PART_REQUESTS)
    graphs = big + [hub_graph(big[0].node_feat.shape[0],
                              big[0].edge_index.shape[0])]
    launches = dict.fromkeys(KERNELS, 0)
    products = 0
    errs = {}
    for conv in C.CONV_TYPES:
        cfg = benchmark_config(conv)
        params = G.cast_for_policy(M.broadcast_tree(
            mesh, serve_params(cfg, dev) if mesh.is_root else None), cfg)
        per_graph = None
        if mesh.is_root:
            tiled_matmul.launches = 0
            with torch.inference_mode():
                want = [G.apply(params, cfg, serve._fallback_input(g, dev))
                        for g in graphs]
            check(tiled_matmul.launches % len(graphs) == 0,
                  f"oracle {conv}: {tiled_matmul.launches} tiled_matmul "
                  f"launches over {len(graphs)} graphs")
            per_graph = tiled_matmul.launches // len(graphs)
        per_graph = M.broadcast_object(mesh, per_graph)
        head = cfg.mlp_head.hidden_layers + 1
        for n, group in groups.items():
            if group is None:
                continue
            parts = [P.partition_graph(g, n, nb, eb) for g in graphs]
            torch.cuda.synchronize(dev)
            wrappers = zero_counts()
            tiled_matmul.launches = 0
            with torch.inference_mode():
                got = [G.apply_packed_partitioned(params, cfg, p, group)
                       for p in parts]
            torch.cuda.synchronize(dev)
            part_launches = counts_of(wrappers)
            label = f"partitioned {conv} on {n} ranks"
            check_launches(label, part_launches,
                           {ORACLE_LAUNCHES[conv]: len(parts)})
            for k, v in part_launches.items():
                launches[k] += v
            own = per_graph - (0 if group.is_root else head)
            check(per_graph > head and tiled_matmul.launches
                  == own * len(parts),
                  f"{label}, rank {group.rank}: {tiled_matmul.launches} "
                  f"tiled_matmul launches, expected {own} a graph")
            products += tiled_matmul.launches
            if not group.is_root:
                continue
            bitwise = C.conv_spec(conv).partition_bitwise
            for g, p, a, b in zip(graphs, parts, got, want):
                label = (f"partitioned {conv}, {n} parts, {g.num_nodes} "
                         f"nodes ({p.cut_edges} cut edges)")
                check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
                if bitwise:
                    check(torch.equal(a, b), f"{label}: not bit for bit the "
                          f"padded oracle, max |err| "
                          f"{float((a - b).abs().max())}")
                else:
                    check(torch.allclose(a, b, **MODEL_TOL),
                          f"{label}: max |err| {float((a - b).abs().max())}")
                errs[(conv, n)] = max(errs.get((conv, n), 0.0),
                                      float((a - b).abs().max()))
    return {"launches": launches, "products": products, "errs": errs,
            "sizes": [g.num_nodes for g in graphs],
            "cuts": {n: [P.partition_graph(g, n, nb, eb).cut_edges
                         for g in graphs] for n in groups}}


def dist_timing_rank(mesh, pair, dev) -> dict:
    """(d), on the root's clock: graphs/s of the GCN drain at
    ``SHARD_GRAPHS`` graphs a shard on rank 0 alone (``drain_gnn_queue``)
    and on the pair (the sharded drain, the same queue), in turns
    (single, pair, pair, single); then ms a graph of the four oversize
    GCN graphs through the padded oracle on rank 0 alone and the
    partitioned program on 2 and on 4 ranks, in turns (oracle, 2, 4, 4,
    2, oracle), with the host time of cutting each graph and of one
    staged all-gather at the halo exchange's size. Every turn ends in a
    device synchronisation and a barrier of the whole group."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    ds = DATASETS["qm9"]
    cfg = benchmark_config("gcn")
    params = G.cast_for_policy(M.broadcast_tree(
        mesh, serve_params(cfg, dev) if mesh.is_root else None), cfg)
    nb, eb = serve.budgets(SHARD_GRAPHS, ds)
    queue = [P.make_graph(ds, i)
             for i in range(SHARD_WAVES * 2 * SHARD_GRAPHS)]
    sharded = G.make_sharded_apply(cfg, pair) if pair is not None else None

    def single(p, b):
        return G.apply_packed(p, cfg, b)

    rates = {"single": [], "pair": []}
    for turn in ("single", "pair", "pair", "single"):
        if turn == "single" and mesh.is_root:
            _, st = serve.drain_gnn_queue(single, params, queue, nb, eb,
                                          SHARD_GRAPHS, device=dev)
            rates[turn].append(st["graphs_per_s"])
        elif turn == "pair" and pair is not None:
            _, st = serve.drain_gnn_queue_sharded(
                sharded, params, queue, nb, eb, SHARD_GRAPHS, pair.size,
                device=dev)
            if pair.is_root:
                rates[turn].append(st["graphs_per_s"])
        M.barrier(mesh)
    pnb, peb = serve.budgets(PART_GRAPHS, ds)
    graphs = serve.oversize_graphs(ds, pnb, peb, PART_REQUESTS)
    groups = {2: pair, DIST_RANKS: mesh}
    ms = {"oracle": [], 2: [], DIST_RANKS: []}

    def timed(call) -> float:
        t0 = time.perf_counter()
        with torch.inference_mode():
            call()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    # the host's share of the partitioned route: cutting the graph
    cut_ms = []
    for g in graphs:
        t0 = time.perf_counter()
        P.partition_graph(g, 2, pnb, peb)
        cut_ms.append((time.perf_counter() - t0) * 1e3)
    # one staged collective of the partitioned program's sizes: the halo
    # all-gather of a (node budget, 128) table, on 2 and on all ranks
    coll = {2: [], DIST_RANKS: []}
    table = torch.ones((pnb, 128), device=dev)
    for n, group in groups.items():
        for _ in range(20):
            if group is not None:
                t0 = time.perf_counter()
                M.all_gather(group, table)
                torch.cuda.synchronize(dev)
                coll[n].append((time.perf_counter() - t0) * 1e3)
            M.barrier(mesh)
    for turn in ("oracle", 2, DIST_RANKS, DIST_RANKS, 2, "oracle"):
        if turn == "oracle" and mesh.is_root:
            ms[turn] += [timed(lambda: G.apply(
                params, cfg, serve._fallback_input(g, dev))) for g in graphs]
        elif turn != "oracle" and groups[turn] is not None:
            parts = [P.partition_graph(g, turn, pnb, peb) for g in graphs]
            t = [timed(lambda: G.apply_packed_partitioned(
                params, cfg, p, groups[turn])) for p in parts]
            if mesh.is_root:
                ms[turn] += t
        M.barrier(mesh)
    return {"rates": rates, "ms": ms, "cut_ms": cut_ms,
            "all_gather_ms": coll}


def dist_rank(mesh) -> dict:
    """One rank of phase 10's group: (a), (b) and (d) on the sub-group
    of ranks 0 and 1 and on the whole group."""
    from repro_torch.launch import mesh as M
    dev = mesh.device
    pair = M.sub_mesh(mesh, [0, 1])
    t0 = time.perf_counter()
    sharded = sharded_drain_rank(pair, dev) if pair is not None else None
    M.barrier(mesh)
    t_a = time.perf_counter() - t0
    part = partitioned_rank(mesh, {2: pair, DIST_RANKS: mesh}, dev)
    M.barrier(mesh)
    t_b = time.perf_counter() - t0 - t_a
    timing = dist_timing_rank(mesh, pair, dev)
    return {"rank": mesh.rank, "device": str(dev),
            "transport": mesh.transport,
            "sharded": sharded, "partitioned": part, "timing": timing,
            "seconds": (t_a, t_b, time.perf_counter() - t0 - t_a - t_b)}


def dist_serve_phase() -> None:
    """(c): ``serve --shards 2 --dist-backend gloo --oversize-requests 4``
    on the card: every request answered, the qm9 ones packed, all four
    oversize ones ``served_partitioned``, every output finite."""
    from repro_torch.launch import serve
    from repro_torch.runtime import scheduler as S
    t0 = time.perf_counter()
    outs, stats = serve.main(DIST_SERVE)
    n = int(DIST_SERVE[DIST_SERVE.index("--requests") + 1])
    check(stats["served"] == n + PART_REQUESTS
          and stats["packed_served"] == n
          and stats["partitioned_served"] == PART_REQUESTS,
          f"serve --shards 2: {stats['packed_served']} packed, "
          f"{stats['partitioned_served']} partitioned of "
          f"{n + PART_REQUESTS}")
    check([o["status"] for o in stats["outcomes"]]
          == [S.SERVED_PACKED] * n + [S.SERVED_PARTITIONED] * PART_REQUESTS,
          "serve --shards 2: statuses")
    check(all(bool(np.isfinite(np.asarray(o)).all()) for o in outs),
          "serve --shards 2: non-finite output")
    print(f"[10] (c) serve {' '.join(DIST_SERVE)}: {stats['served']} "
          f"answered ({stats['packed_served']} packed in "
          f"{stats['n_batches']} waves, {stats['partitioned_served']} "
          f"partitioned at "
          + ", ".join(f"{v * 1e3:.4f}" for v in stats["oversize_latency_s"])
          + f" ms), {stats['graphs_per_s']:.1f} graphs/s, "
          f"{time.perf_counter() - t0:.1f} s with the spawn")


def dist_phase(card: str) -> tuple:
    """Phase 10; returns the launches of every rank's counted runs and
    the ``tiled_matmul`` launches of every rank's partitioned runs."""
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    res = M.spawn(dist_rank, DIST_RANKS, device="cuda", backend="gloo")
    root = res[0]
    print(f"[10] {DIST_RANKS} ranks on {torch.cuda.device_count()} card(s) "
          f"({', '.join(r['device'] for r in res)}), transport: "
          f"{root['transport']} (torch {torch.__version__}); spawn and phase {time.perf_counter() - t0:.1f} s (a, b, d "
          + ", ".join(f"{s:.1f}" for s in root["seconds"]) + " s on rank 0)")
    total = dict.fromkeys(KERNELS, 0)
    for r in res:
        for part in (r["sharded"], r["partitioned"]):
            if part is not None:
                for k, v in part["launches"].items():
                    total[k] += v
    products = sum(r["partitioned"]["products"] for r in res)
    for r in res[:2]:
        s = r["sharded"]
        print(f"[10] (a) sharded gcn drain, rank {r['rank']} of 2, "
              f"{SHARD_GRAPHS} graphs a shard: {s['waves']} waves, each "
              f"shard bit for bit its single-rank apply_packed; launches "
              + ", ".join(f"{k} {v}" for k, v in s["launches"].items()))
    p = root["partitioned"]
    print(f"[10] (b) partitioned program at fp32 on graphs of "
          f"{p['sizes']} nodes (the last the {HUB_IN_EDGES}-in-edge hub), "
          f"cut edges " + "; ".join(f"{n} parts {c}"
                                    for n, c in p["cuts"].items())
          + ": max |err| vs the padded oracle on the card "
          + ", ".join(f"{c}/{n} {e:.3e}" for (c, n), e in p["errs"].items())
          + " (gcn, gat bit for bit); tiled_matmul launches (row-stable "
          f"products) on the ranks: {products}")
    t = root["timing"]
    rates, ms = t["rates"], t["ms"]
    print(f"[10] (d) {card}: gcn drain at {SHARD_GRAPHS} graphs a shard, "
          f"graphs/s in turns single, 2 ranks, 2 ranks, single: "
          f"{rates['single'][0]:.1f}, {rates['pair'][0]:.1f}, "
          f"{rates['pair'][1]:.1f}, {rates['single'][1]:.1f} (ranks share "
          f"one card: no scaling figure)")
    print(f"[10] (d) {card}: oversize gcn ms a graph, median of "
          f"{len(ms['oracle'])}: padded oracle "
          f"{statistics.median(ms['oracle']):.4f}, partitioned on 2 ranks "
          f"{statistics.median(ms[2]):.4f}, on {DIST_RANKS} ranks "
          f"{statistics.median(ms[DIST_RANKS]):.4f}; each turn: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                      for k, vs in ms.items()))
    print(f"[10] (d) {card}: partition_graph on the host "
          + ", ".join(f"{v:.4f}" for v in t["cut_ms"]) + " ms a graph (2 "
          f"parts); one staged all-gather of a ({PART_GRAPHS}-graph node "
          f"budget, 128) fp32 table, median of 20: "
          + ", ".join(f"{n} ranks {statistics.median(v):.4f} ms"
                      for n, v in t["all_gather_ms"].items()))
    dist_serve_phase()
    return total, products


# ---------------------------------------------------------- phase 11 --
DSE_DIR = ROOT / "build" / "chip_smoke_dse"
DSE_DESIGNS = 24           # dse.build_database(DSE_DESIGNS, seed=DSE_SEED)
DSE_SEED = 0
DSE_CANDIDATES = 4096      # dse.explore(DSE_CANDIDATES, seed=1)
DSE_EXPLORE_SEED = 1
DSE_TARGET_S = 120.0       # the phase's wall-time target, printed
PAPER_LATENCY_MAPE = 36.0  # the paper's 5-fold CV-MAPE (§VII-B, Fig. 4)
PAPER_BRAM_MAPE = 17.5
PAPER_SYNTHESIS_S = 9.4 * 60   # Fig. 5: a Vitis run against a model call
PAPER_MODEL_MS = 1.7
# the kernels that can never run in a DSE design: it keeps the default
# aggregation backend, so gather_mode/edge_block/node_block/fusion_depth
# do not reach the program (as in the reference's synthesize_design)
DSE_INERT = ("fused_layer_stack", "fused_gather_onehot",
             "segment_aggregate_onehot")
DSE_RECORDED = ("latency_s", "hbm_bytes", "graphs_per_s", "measured_ms")


def dse_counters() -> dict:
    """The model-path kernels' wrappers and ``tiled_matmul``'s (the
    padded oracle's row-stable fp32 products)."""
    return {**counters(), "tiled_matmul": entry_counters()["tiled_matmul"]}


def dse_expected(conv: str) -> set:
    """The kernels every design of ``conv`` launches on the card: its CSR
    kernels (``LAUNCHES_PER_BATCH``; GIN with edge features and PNA fold
    every aggregation in the segment kernel and run no gather) and
    ``tiled_matmul`` (the testbench's fp32 references at least)."""
    per = dict(zip(KERNELS, LAUNCHES_PER_BATCH[conv]))
    return {k for k in KERNELS[:3] if per[k] > 0} | {"tiled_matmul"}


@contextlib.contextmanager
def counted_designs(wrappers: dict, seconds: list, launches: list,
                    benches: list):
    """Inside the block every ``dse.synthesize_design`` appends its wall
    seconds, its launches by kernel (counts read just before and just
    after it) and (its design, its ``Project``, its testbench report) to
    ``benches``."""
    from repro_torch.core import dse
    from repro_torch.core.project import Project
    inner, run_tb = dse.synthesize_design, Project.build_and_run_testbench
    ran = []

    def kept(self, *args, **kwargs):
        tb = run_tb(self, *args, **kwargs)
        ran.append((self, tb))
        return tb

    def counted(d, *args, **kwargs):
        before = {k: w.launches for k, w in wrappers.items()}
        ran.clear()
        t0 = time.perf_counter()
        rec = inner(d, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        launches.append({k: w.launches - before[k]
                         for k, w in wrappers.items()})
        check(len(ran) == 1, f"[11] {len(ran)} testbenches in one design")
        benches.append((dict(d), *ran[0]))
        return rec
    dse.synthesize_design = counted
    Project.build_and_run_testbench = kept
    try:
        yield
    finally:
        dse.synthesize_design = inner
        Project.build_and_run_testbench = run_tb


def check_design(label: str, rec: dict, n: dict) -> None:
    for key in DSE_RECORDED:
        v = rec[key]
        check(np.isfinite(v) and v > 0, f"{label}: {key} = {v}")
    missing = sorted(k for k in dse_expected(rec["conv"]) if n[k] == 0)
    check(not missing, f"{label}: never launched {missing}: {n}")
    engaged = [k for k in DSE_INERT if n[k]]
    check(not engaged, f"{label}: a DSE knob reached the program: {n}")


def design_line(i, rec: dict, secs: float, n: dict) -> str:
    shards = rec["num_shards"]
    return (f"[11] (a) design {i:2d} {rec['conv']:4s} {rec['precision']:4s} "
            f"hidden {rec['gnn_hidden_dim']} x{rec['gnn_layers']}, "
            f"{rec['batch_graphs']} graphs/batch, {shards} shard(s)"
            + (" (sharded testbench skipped on one card; graphs/s modeled)"
               if shards > 1 else "")
            + f": modeled {rec['latency_s'] * 1e3:.6f} ms, measured "
            f"{rec['measured_ms']:.4f} ms a graph, hbm {rec['hbm_bytes']} B, "
            f"modeled {rec['graphs_per_s']:.1f} graphs/s; {secs:.2f} s; "
            + ", ".join(f"{k} {v}" for k, v in n.items() if v))


def dse_host(d: dict, proj):
    """The CPU plain path's ``Project`` of design ``d`` with the card
    project ``proj``'s parameters and (int8: calibrated) policy."""
    from repro_torch.core import dse
    host = dse.make_project(d, str(DSE_DIR / "cpu"), device="cpu")
    host.params = tree_to(proj.params, "cpu")
    host.policy = proj.policy
    host.gen_hw_model()
    return host


def within(precision: str, got, want, policy,
           own: float | None = None) -> tuple:
    """(max |err|, bound, whether ``got`` is within the bound of ``want``,
    the CPU plain path's output of the same policy): fp32 ``MODEL_TOL``;
    bf16 and int8 ``low_bound``. The per-graph timed program runs its
    fp32 and bf16 products row-stable on both sides
    (``nn.layers.row_stable_products``: a bf16 product is the same bits
    on the card and the CPU), so bf16 holds to ``low_bound`` alone. The
    packed program keeps ``torch.matmul``, whose bf16 sums cuBLAS and the
    CPU's BLAS fold in orders of their own: a sum can round to the other
    side of a bf16 boundary in an early layer (``tools/
    trace_dse_divergence.py`` traced one such product) and reach the
    output through every later one of a design up to 4 layers deep and
    256 wide, as far as the policy's rounding moves the design's output
    from fp32; there ``own``, the CPU plain path's bf16 error against
    its fp32 output, widens a bf16 bound where it is larger."""
    err = float((got - want).abs().max())
    if precision == "fp32":
        bound = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * float(
            want.abs().max())
        ok = torch.allclose(got, want, **MODEL_TOL)
    else:
        bound = low_bound(precision, want, policy)
        if precision == "bf16" and own is not None:
            bound = max(bound, own)
        ok = err <= bound
    return err, bound, bool(torch.isfinite(got).all()) and ok


def dse_timed_parity(label: str, d: dict, proj, tb: dict):
    """(b) The timed program ``_fn`` of a synthesized design (the one
    ``measured_ms`` times) on its testbench graphs on the card against
    the CPU plain path's with the same parameters and policy (``within``),
    and its testbench report gated: fp32 MAE against the fp32 references
    within ``MODEL_TOL`` of their scale; bf16/int8 SQNR against them at
    least ``SQNR_FLOOR_DB``, or, where the CPU plain path's own SQNR
    against its fp32 references is below that, within ``SQNR_MARGIN_DB``
    of it. Returns the host project and the line to print."""
    from repro_torch.core import dse
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    host = dse_host(d, proj)
    precision = proj.policy.name
    fp32 = Q.resolve_policy("fp32", host.cfg.gnn_num_layers)
    gots, outs, refs = [], [], []
    for g in proj._tb_graphs:
        gots.append(proj._fn(proj.params, proj._graph_to_el(g)).cpu())
        el = host._graph_to_el(g)
        outs.append(host._fn(host.params, el))
        refs.append(outs[-1] if precision == "fp32"
                    else G.apply(host.params, host.cfg, el, None, fp32))
    worst = 0.0
    for i, (got, want) in enumerate(zip(gots, outs)):
        err, bound, ok = within(precision, got, want, proj.policy)
        check(ok, f"{label}: testbench graph {i}: the card's timed "
                  f"{precision} program is {err} off the CPU plain path "
                  f"(bound {bound})")
        worst = max(worst, err / bound)
    line = (f"{label} {d['conv']} {precision} {dse.design_name(d)} "
            f"(hidden {d['gnn_hidden_dim']} x{d['gnn_layers']}): timed "
            f"program on {len(outs)} graphs against the CPU plain path at "
            f"most {worst:.3f} of its bound; testbench ")
    if precision == "fp32":
        scale = max(float(np.abs(r).max()) for r in proj._tb_refs)
        bound = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * scale
        check(np.isfinite(tb["mae"]) and tb["mae"] <= bound,
              f"{label}: testbench MAE {tb['mae']} > {bound}")
        return host, line + f"MAE {tb['mae']:.3e} (bound {bound:.3e})"
    sq_own = Q.error_stats(torch.stack(outs), torch.stack(refs))["sqnr_db"]
    floor = min(SQNR_FLOOR_DB[precision], sq_own - SQNR_MARGIN_DB)
    sqnr = tb["quant_error"]["output"]["sqnr_db"]
    check(sqnr >= floor, f"{label}: testbench SQNR {sqnr} dB < {floor} dB "
                         f"(the CPU plain path's own {sq_own} dB)")
    return host, line + (f"SQNR {sqnr:.2f} dB (floor {floor:.2f}; the "
                         f"CPU plain path's own {sq_own:.2f})")


def dse_packed_parity(d: dict, proj, host) -> str:
    """(b) The design's packed program on one batch of
    ``batch_graphs`` graphs on the card against the CPU plain path's."""
    from repro_torch.core import dse
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.data import pipeline as P
    graphs = [P.make_graph(host.dataset_cfg, i)
              for i in range(d["batch_graphs"])]
    batch, _ = P.pack_graphs(graphs, host.node_budget, host.edge_budget,
                             host.batch_graphs)
    got = proj._fn_packed(proj.params,
                          G.packed_to_device(batch, proj.device)).cpu()
    host_batch = G.packed_to_device(batch, "cpu")
    want = host._fn_packed(host.params, host_batch)
    ref = G.apply_packed(host.params, host.cfg, host_batch, None,
                         Q.resolve_policy("fp32", host.cfg.gnn_num_layers))
    precision = proj.policy.name
    err, bound, ok = within(precision, got, want, proj.policy,
                            float((want - ref).abs().max()))
    check(ok, f"[11] (b) {d['conv']}: the card's packed {precision} "
              f"program is {err} off the CPU plain path (bound {bound})")
    return (f"[11] (b) {d['conv']} {precision} {dse.design_name(d)}: packed "
            f"program on {int(batch['num_graphs'])} graphs in one batch max "
            f"|err| {err:.3e} against the CPU plain path (bound "
            f"{bound:.3e})")


def dse_memory_input(d: dict, proj) -> str:
    """(b) The memory target's input: ``run_synthesis`` measures the
    per-graph program on a zero frame (every edge slot a 0 -> 0 edge);
    the same measurement on the frame of the first testbench graph."""
    from repro_torch.core import dse
    zero = proj._measure(proj._fn, proj._zero_graph())
    real = proj._measure(proj._fn, proj._graph_to_el(proj._tb_graphs[0]))
    return (f"[11] (b) {d['conv']} {proj.policy.name} {dse.design_name(d)}: "
            f"memory target's input: hbm temp {zero['temp']} B on the zero frame, {real['temp']} B "
            f"on a real graph's ({real['temp'] - zero['temp']:+d}); counted "
            f"bytes {zero['bytes']} / {real['bytes']}")


def dse_checks(benches: list) -> None:
    """(b) over every design of the database: the timed program against
    the CPU plain path and the testbench gate; for the first design of
    each conv also the packed program against the CPU plain path and
    the memory target's input."""
    firsts = set()
    for i, (d, proj, tb) in enumerate(benches):
        host, line = dse_timed_parity(f"[11] (b) design {i:2d}", d, proj, tb)
        print(line)
        if d["conv"] not in firsts:
            firsts.add(d["conv"])
            print(dse_packed_parity(d, proj, host))
            print(dse_memory_input(d, proj))
    print(f"[11] (b) every one of the {len(benches)} designs' timed "
          f"programs held against the CPU plain path; convs "
          f"{sorted(firsts)}")


def dse_phase(dev) -> dict:
    """Phase 11: the DSE on the card; returns the launches of its
    synthesized designs (the winner's included) by kernel, the parity
    checks' not counted."""
    from repro_torch.core import dse
    from repro_torch.core import perf_model as PM
    from repro_torch.core.project import H100Target
    t0 = time.perf_counter()
    wrappers = dse_counters()
    seconds, launches, benches = [], [], []
    with counted_designs(wrappers, seconds, launches, benches):
        db = dse.build_database(DSE_DESIGNS, str(DSE_DIR), seed=DSE_SEED,
                                run_testbench=True, log=None, device=dev)
    check(len(db) == len(launches) == DSE_DESIGNS,
          f"[11] {len(db)} designs, {len(launches)} counted")
    for i, (rec, secs, n) in enumerate(zip(db, seconds, launches)):
        check_design(f"[11] (a) design {i}", rec, n)
        print(design_line(i, rec, secs, n))
    synth_s = statistics.mean(seconds)
    print(f"[11] (a) {DSE_DESIGNS} designs synthesized and measured on the "
          f"card in {sum(seconds):.1f} s ({synth_s:.3f} s a design, median "
          f"{statistics.median(seconds):.3f}, first {seconds[0]:.3f}); "
          "launches " + ", ".join(f"{k} {sum(n[k] for n in launches)}"
                                  for k in wrappers))
    dse_checks(benches)

    x = np.stack([PM.features(d) for d in db])
    cv = {key: PM.kfold_cv_mape(x, np.array([d[key] for d in db]), k=5)
          for key in ("latency_s", "measured_ms", "hbm_bytes")}
    check(all(np.isfinite(v) for v in cv.values()), f"[11] (c) CV-MAPE {cv}")
    print(f"[11] (c) 5-fold CV-MAPE over {len(db)} designs: latency "
          f"{cv['latency_s']:.2f} % on the modeled target (latency_s), "
          f"{cv['measured_ms']:.2f} % on the measured one (measured_ms; "
          f"paper {PAPER_LATENCY_MAPE} %); memory {cv['hbm_bytes']:.2f} % "
          f"(hbm_bytes; paper BRAM {PAPER_BRAM_MAPE} %); not gated at "
          f"{len(db)} designs")

    models = dse.fit_models(db)
    budget = H100Target().hbm_bytes
    best = dse.explore(models, DSE_CANDIDATES, seed=DSE_EXPLORE_SEED)
    check(best["feasible"] and best["pred_hbm_bytes"] <= budget,
          f"[11] (d) the explored winner is infeasible: {best}")
    winner = {k: best[k] for k in dse.sample_design(
        np.random.default_rng(0))}
    mark = len(seconds)
    with counted_designs(wrappers, seconds, launches, benches):
        rec = dse.synthesize_design(winner, str(DSE_DIR), run_testbench=True,
                                    device=dev)
    check_design("[11] (d) winner", rec, launches[mark])
    print(dse_timed_parity("[11] (d) winner", *benches[mark])[1])
    print(f"[11] (d) explore({DSE_CANDIDATES}) under {budget:.3g} B: "
          f"{best['ms_per_eval']:.5f} ms an evaluation "
          f"({best['dse_seconds']:.3f} s); winner {dse.design_name(winner)} "
          f"{winner['conv']} {winner['precision']} hidden "
          f"{winner['gnn_hidden_dim']} x{winner['gnn_layers']}, "
          f"{winner['batch_graphs']} graphs/batch, {winner['num_shards']} "
          f"shard(s); latency predicted {best['pred_latency_s'] * 1e3:.6f} "
          f"ms, modeled {rec['latency_s'] * 1e3:.6f} ms, measured "
          f"{rec['measured_ms']:.4f} ms a graph; hbm predicted "
          f"{best['pred_hbm_bytes']:.4g} B, synthesized {rec['hbm_bytes']} B")
    slo = dse.explore(models, DSE_CANDIDATES, seed=DSE_EXPLORE_SEED,
                      objective="p99_latency", slo=dse.DEFAULT_SLO)
    check(slo["feasible"] and np.isfinite(slo["pred_p99_latency_s"]),
          f"[11] (d) p99 objective: {slo}")
    print(f"[11] (d) objective p99_latency at "
          f"{slo['slo']['load_graphs_per_s']} graphs/s: winner "
          f"{slo['conv']} {slo['precision']}, {slo['batch_graphs']} "
          f"graphs/batch, predicted p50 / p99 "
          f"{slo['pred_p50_latency_s'] * 1e3:.4f} / "
          f"{slo['pred_p99_latency_s'] * 1e3:.4f} ms, fill "
          f"{slo['pred_batch_fill']:.3f}, {slo['pred_rejected']} rejected "
          f"({slo['slo_sim_seconds']:.2f} s of simulation)")

    model_s = best["ms_per_eval"] * 1e-3
    rest_s = statistics.mean(seconds[1:DSE_DESIGNS])
    print(f"[11] (e) Fig. 5: synthesis {synth_s:.3f} s a design ("
          f"{rest_s:.3f} s without the first) against "
          f"{best['ms_per_eval']:.5f} ms a model evaluation: "
          f"{np.log10(synth_s / model_s):.2f} ("
          f"{np.log10(rest_s / model_s):.2f}) orders of magnitude (paper: "
          f"{PAPER_SYNTHESIS_S:.0f} s against {PAPER_MODEL_MS} ms, "
          f"{np.log10(PAPER_SYNTHESIS_S / (PAPER_MODEL_MS * 1e-3)):.2f})")
    wall = time.perf_counter() - t0
    print(f"[11] (f) phase 11 took {wall:.1f} s (target "
          f"{DSE_TARGET_S:.0f} s)")
    return {k: sum(n[k] for n in launches) for k in wrappers}


# ---------------------------------------------------------- phase 12 --
# LM serving: qwen3-8b at its full config (configs/qwen3_8b.py: 36 layers,
# d_model 4096, 32 query heads over 8 KV heads of 128, vocab 151936),
# served through the CLI with random weights drawn on the card
LM_ARCH = "qwen3-8b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 32
LM_SERVE = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN)]
LM_ATTN_ROWS = 36           # qwen3-8b's attention rows, one launch each
# (a') rwkv6-1.6b at its full config (configs/rwkv6_16b.py: 24 layers,
# d_model 2048, vocab 65536), attention-free, through the same CLI
RWKV_ARCH = "rwkv6-1.6b"
RWKV_SERVE = ["--arch", RWKV_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
              str(LM_PROMPT), "--gen", str(LM_GEN)]
# (BH, Sq, Skv, D, Dv, causal) of the distinct attention calls (b) holds
# and times: qwen3-8b's prefill (B x 32 query heads, K/V repeated from
# the KV heads), its first and last decode step (B x 8 KV heads, the GQA
# group of 4 folded into Sq, the valid prefix as Skv); deepseek-v2's MLA
# prefill from its (c) cut (B = 1, 128 heads, D = nope + rope = 192, Dv =
# 128)
LM_SHAPES = ((LM_BATCH * 32, LM_PROMPT, LM_PROMPT, 128, 128, True),
             (LM_BATCH * 8, 4, LM_PROMPT + 1, 128, 128, False),
             (LM_BATCH * 8, 4, LM_PROMPT + LM_GEN, 128, 128, False))
LM_CUT_PROMPT, LM_CUT_STEPS = 64, 4
MLA_SHAPE = (128, LM_CUT_PROMPT, LM_CUT_PROMPT, 192, 128, True)
# (b) the reduced configs whose head sizes are new to the kernel, each
# with the body kernel.body_for picks: D = 16 (a k16 step) and D = 8
LM_REDUCED = (("qwen3-8b", "wgmma"), ("internlm2-20b", "simt"))
# jamba's superblock cut to the pattern of its own reduced() config: a
# Mamba row with MoE and an attention row with the MLP
JAMBA_CUT = (("mamba", "moe"), ("attn", "mlp"))
# (c) full-width models cut in depth, held against the CPU plain path
# with the same parameters at B = 1, a LM_CUT_PROMPT-token prompt and
# LM_CUT_STEPS decode steps: (arch, repeat kept (None: the config's),
# superblock (None: the config's), memory tokens: llama's image patches,
# whisper's encoder frames, dtype). rwkv6-1.6b runs twice: bf16 at 2 of
# its 24 layers, and whole at fp32. Whole at bf16 it misses the bf16
# bound (7.1 times it, tools/lm_divergence.py): each row adds one or two
# bf16 steps of the card's and the CPU's sums in their own orders, and
# 24 random layers compound them (fp32: 0.002 of the bound).
LM_CUTS = (("qwen3-8b", 2, None, 0, "bf16"),
           ("llama-3.2-vision-11b", 1, None, 2048, "bf16"),
           ("whisper-base", None, None, 1500, "bf16"),
           ("deepseek-v2-236b", 1, None, 0, "bf16"),
           ("llama4-scout-17b-a16e", 2, None, 0, "bf16"),
           ("jamba-1.5-large-398b", 1, JAMBA_CUT, 0, "bf16"),
           ("rwkv6-1.6b", 2, None, 0, "bf16"),
           ("rwkv6-1.6b", None, None, 0, "fp32"))
XATTN_GATE = 0.5            # the xattn gates initialize to 0
# the CPU tests' bounds (tests/test_torch_lm.py): max |err| <= tol * max
# |plain|, on the logits
LM_BF16_TOL = 2.0 ** -5
LM_TOL = {"bf16": LM_BF16_TOL, "fp32": 1e-4}
LM_TARGET_S = 150.0         # the phase's wall-time target, printed


def attention_key(q, k, v, causal: bool) -> tuple:
    """(BH, Sq, Skv, D, Dv, causal) of a ``flash_attention`` call."""
    return (q.numel() // (q.shape[-2] * q.shape[-1]), q.shape[-2],
            k.shape[-2], q.shape[-1], v.shape[-1], causal)


@contextlib.contextmanager
def captured_attention(shapes: tuple, store: dict):
    """Record a copy of the 3-D (q, k, v) of the first call of each
    ``attention_key`` in ``shapes`` that the LM attention
    (``nn.attention.flash_attention``) makes inside the block."""
    from repro_torch.nn import attention as TA
    real = TA.flash_attention

    def spy(q, k, v, *, causal=True):
        key = attention_key(q, k, v, causal)
        if key in shapes and key not in store:
            store[key] = tuple(t.reshape(-1, *t.shape[-2:]).contiguous()
                               .clone() for t in (q, k, v))
        return real(q, k, v, causal=causal)
    TA.flash_attention = spy
    try:
        yield store
    finally:
        TA.flash_attention = real


def lm_config(arch: str, reduced: bool = False, repeat=None,
              superblock=None, dtype=None):
    from repro_torch.configs import registry
    cfg = registry.get_config(arch, reduced=reduced)
    over = {k: v for k, v in (("repeat", repeat), ("superblock", superblock),
                              ("dtype", dtype)) if v is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def lm_params(cfg, dev) -> dict:
    """Random parameters of ``cfg`` drawn on the card (seed 0), the xattn
    gates at ``XATTN_GATE``."""
    from repro_torch.models import lm
    from repro_torch.nn.param import materialize
    params = materialize(lm.model_plan(cfg), torch.Generator(
        device=dev).manual_seed(0), dev)
    for i, (mixer, _) in enumerate(cfg.superblock):
        if mixer == "xattn":
            params["blocks"][f"r{i}"]["mixer"]["gate"].fill_(XATTN_GATE)
    return params


def attention_launches(cfg, steps: int, with_mem: bool) -> int:
    """The ``flash_attention`` launches of a prefill and ``steps`` decode
    steps of ``cfg``: one a prefill for each ``attn``, ``xattn`` and
    ``mla`` row (and each encoder row, given the memory), one a decode
    step for each ``attn`` and ``xattn`` row (MLA's decode is the
    absorbed form, plain PyTorch, as the reference's)."""
    rows = cfg.prefix + cfg.superblock * cfg.repeat
    pre = sum(m in ("attn", "xattn", "mla") for m, _ in rows)
    if cfg.encoder is not None and with_mem:
        pre += len(cfg.encoder.superblock) * cfg.encoder.repeat
    return pre + steps * sum(m in ("attn", "xattn") for m, _ in rows)


def served(argv: list, shapes: tuple) -> tuple:
    """``serve.main(argv)`` with every kernel's count set to 0 just before
    and read just after. Returns (its result, the launches by kernel, the
    attention launches by body, the captured attention inputs of
    ``shapes``, the command's wall seconds)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    wrappers = {**counters(), **entry_counters()}
    for w in wrappers.values():
        w.launches = 0
    flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_attention(shapes, {}) as captured:
        out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    return (out, launches, dict(flash_attention.launches_by_body), captured,
            wall)


def check_generated(label: str, out: dict) -> float:
    """Every token in range and every logit finite; returns the median
    step ms after the first."""
    cfg, toks = out["cfg"], out["tokens"]
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN + 1)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label} tokens {tuple(toks.shape)} out of range")
    check(all(bool(torch.isfinite(lg.float()).all())
              for lg in out["logits"]), f"{label} non-finite logits")
    return statistics.median(out["step_ms"][1:])


def serving_rates(out: dict, median: float) -> dict:
    return dict(tok_s=out["tok_s"], ms_per_step=out["ms_per_step"],
                first_step_ms=out["step_ms"][0], median_step_ms=median,
                prefill_ms=out["prefill_s"] * 1e3)


def rate_line(out: dict, median: float) -> str:
    return (f"{LM_BATCH} x {LM_GEN} tokens, {out['tok_s']:.2f} tok/s, "
            f"{out['ms_per_step']:.4f} ms/step (first step "
            f"{out['step_ms'][0]:.4f} ms, median of the rest {median:.4f} "
            f"ms: {LM_BATCH / median * 1e3:.2f} tok/s), prefill "
            f"{out['prefill_s'] * 1e3:.3f} ms (both with first launches)")


def lm_serve_phase() -> dict:
    """(a) qwen3-8b at its full config through ``serve --arch``. Returns
    the launches, their bodies, the captured attention inputs and the
    rates."""
    out, launches, by_body, captured, wall = served(LM_SERVE, LM_SHAPES)
    cfg = out["cfg"]
    want = LM_ATTN_ROWS * (1 + LM_GEN)
    check(cfg.repeat == LM_ATTN_ROWS and cfg.d_model == 4096
          and cfg.vocab_size == 151936, f"[12] (a) {cfg}")
    check(launches["flash_attention"] == want
          and by_body == {**dict.fromkeys(BODIES, 0), "wgmma": want},
          f"[12] (a) flash_attention launched {by_body}, expected {want} "
          f"wgmma ({LM_ATTN_ROWS} at prefill, {LM_ATTN_ROWS} x {LM_GEN} "
          "decoding)")
    stray = {k: n for k, n in launches.items()
             if k != "flash_attention" and n}
    check(not stray, f"[12] (a) other kernels launched: {stray}")
    median = check_generated("[12] (a)", out)
    check(set(captured) == set(LM_SHAPES),
          f"[12] (a) captured {sorted(captured)}, expected {LM_SHAPES}")
    print(f"[12] (a) {cfg.name} at its full config ({cfg.repeat} layers, "
          f"d {cfg.d_model}, {cfg.attn.num_heads}/{cfg.attn.num_kv_heads} "
          f"heads of {cfg.attn.head_dim}, vocab {cfg.vocab_size}, bf16, "
          f"random weights drawn on the card) through serve "
          f"{' '.join(LM_SERVE)}: {rate_line(out, median)}; the command "
          f"{wall:.1f} s with the weights' draw; flash_attention launches "
          f"{launches['flash_attention']} ({LM_ATTN_ROWS} at prefill + "
          f"{LM_ATTN_ROWS} x {LM_GEN} decode steps), by body {by_body}; "
          "every token in range, every logit finite")
    return dict(launches=launches["flash_attention"], by_body=by_body,
                captured=captured, **serving_rates(out, median))


def rwkv_serve_phase() -> dict:
    """(a') rwkv6-1.6b at its full config through ``serve --arch``: an
    attention-free model, so no kernel launches. Returns its rates."""
    out, launches, _, _, wall = served(RWKV_SERVE, ())
    cfg = out["cfg"]
    check(cfg.repeat == 24 and cfg.d_model == 2048
          and cfg.vocab_size == 65536, f"[12] (a') {cfg}")
    stray = {k: n for k, n in launches.items() if n}
    check(not stray, f"[12] (a') kernels launched: {stray}")
    median = check_generated("[12] (a')", out)
    from repro_torch.models import lm
    from repro_torch.nn.param import count_params
    print(f"[12] (a') {cfg.name} at its full config ({cfg.repeat} layers, "
          f"d {cfg.d_model}, {cfg.rwkv.num_heads} heads of "
          f"{cfg.rwkv.head_dim}, vocab {cfg.vocab_size}, "
          f"{count_params(lm.model_plan(cfg)):.4e} bf16 parameters drawn on "
          f"the card) through serve {' '.join(RWKV_SERVE)}: "
          f"{rate_line(out, median)}; the command {wall:.1f} s with the "
          "weights' draw; flash_attention launches 0 (attention-free), no "
          "other kernel; every token in range, every logit finite")
    return serving_rates(out, median)


def lm_attention_phase(captured: dict, errs: dict) -> list:
    """(b) Each captured attention call launched again outside the
    counted runs against ``attention_ref`` on the card within
    ``ATTN_TOL``, on the body ``body_for`` picks (the wgmma body for
    every one), then timed beside its plain version,
    ``scaled_dot_product_attention`` and its bound."""
    from repro_torch.kernels._cost import attention_work
    from repro_torch.kernels.flash_attention.kernel import (
        body_for, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rows = []
    for key in LM_SHAPES + (MLA_SHAPE,):
        bh, sq, skv, d, dv, causal = key
        q, k, v = captured[key]
        what = ("deepseek-v2 MLA prefill, causal" if key == MLA_SHAPE
                else "qwen3-8b prefill, causal" if causal
                else "qwen3-8b decode, GQA fold")
        label = (f"{what}: BH={bh} Sq={sq} Skv={skv} D={d} Dv={dv} "
                 f"{str(q.dtype).split('.')[-1]}")
        body = body_for(q.dtype, d, dv, q.data_ptr(), k.data_ptr(),
                        v.data_ptr())
        check(body == "wgmma", f"[12] (b) {label}: body {body}")
        out, _ = launched_body(f"[12] (b) {label}", flash_attention_cuda,
                               q, k, v, causal=causal, want=body)
        ref = attention_ref(q, k, v, causal=causal)
        close_to("flash_attention", f"[12] (b) {label}", out, ref,
                 ATTN_TOL[q.dtype], errs)
        err = float((out.float() - ref.float()).abs().max())
        moved, ops = attention_work(q, k, v, causal=causal)
        bound, by = bound_ms(moved, ops, product_rate(q.dtype))
        row = dict(
            shape=label, body=body, max_abs_err=err,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal)),
            plain_ms=cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                             reps=5, inner=1, device_only=False),
            bound_ms=bound, bound_by=by)
        try:
            # (1, BH, S, D): the layout SDPA's fused backends take
            row["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
            lib = f"{row['library_ms']:.6f} ms"
        except RuntimeError as e:
            row["library_ms"] = None
            row["library_note"] = f"scaled_dot_product_attention: {e}"
            lib = f"null ({e})"
        rows.append(row)
        print(f"[12] (b) flash_attention [{body} body] {label}: max |err| "
              f"{err:.3e} against attention_ref; kernel {row['ms']:.6f} ms, "
              f"plain {row['plain_ms']:.6f} ms, scaled_dot_product_attention "
              f"{lib}, bound {bound:.6f} ms ({by})")
    return rows


@contextlib.contextmanager
def router_gaps(store: list):
    """Record, for each ``nn.moe.route`` call inside the block, the least
    gap between a token's k-th and (k+1)-th router probability: a near
    tie a rounding step can flip."""
    from repro_torch.nn import moe
    real = moe.route

    def spy(params, x, cfg):
        probs = torch.softmax(x.to(torch.float32) @ params["router"], -1)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.top_k
        if k < top.shape[-1]:
            store.append(float((top[..., k - 1] - top[..., k]).min()))
        return real(params, x, cfg)
    moe.route = spy
    try:
        yield store
    finally:
        moe.route = real


def lm_vs_plain(label: str, cfg, params: dict, prompts: torch.Tensor,
                mem, steps: int, tol: float = LM_BF16_TOL) -> tuple:
    """``serve.lm_generate`` on the card (the kernel counts set to 0 just
    before and read just after), then the CPU plain path with the same
    parameters fed the card's tokens: the prefill's and every decode
    step's logits within ``tol`` of the plain path's scale.
    Returns (worst max |err| / bound, the card's result, its
    flash_attention launches by body, the least router gap of the CPU
    run or None)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.nn.param import abstract
    flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
    card = serve.lm_generate(cfg, params, prompts, steps, mem)
    by_body = dict(flash_attention.launches_by_body)
    host = tree_to(params, "cpu")
    hmem = None if mem is None else mem.cpu()
    b, plen = prompts.shape
    mem_len = hmem.shape[1] if cfg.family == "audio" else cfg.num_mem_tokens
    worst = 0.0
    with torch.inference_mode(), router_gaps([]) as gaps:
        logits, pref = lm.prefill(host, cfg, prompts.cpu(), hmem)
        caches = serve.pad_caches(pref, abstract(
            lm.cache_plan(cfg, b, plen + steps, mem_len=mem_len), "cpu"))
        del pref
        plain = [logits[:, -1]]
        for i in range(steps):
            logits, caches = lm.decode_step(
                host, cfg, caches, card["tokens"][:, i:i + 1].cpu(), plen + i)
            plain.append(logits[:, 0])
    gap = min(gaps) if gaps else None
    for i, (got, want) in enumerate(zip(card["logits"], plain)):
        want = want.float()
        err = float((got.cpu().float() - want).abs().max())
        bound = tol * float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"{label}: step {i} logits {err} off the CPU plain path "
              f"(bound {bound}; least router gap {gap})")
        worst = max(worst, err / bound)
    return worst, card, by_body, gap


def lm_reduced_phase(dev) -> None:
    """(b) The reduced configs' head sizes on the card: each served on
    the card (its attention on the body ``LM_REDUCED`` names) against the
    CPU plain path."""
    for arch, body in LM_REDUCED:
        cfg = lm_config(arch, reduced=True)
        params = lm_params(cfg, dev)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16))).to(dev)
        worst, _, by_body, _ = lm_vs_plain(f"[12] (b) {cfg.name}", cfg,
                                           params, prompts, None,
                                           LM_CUT_STEPS)
        ran = {b: n for b, n in by_body.items() if n}
        check(set(ran) == {body}, f"[12] (b) {cfg.name}: ran {ran}, "
                                  f"expected the {body} body")
        print(f"[12] (b) {cfg.name} (head dim {cfg.attn.head_dim}, "
              f"{cfg.attn.h} query / {cfg.attn.num_kv_heads} KV heads): "
              f"{ran} attention launches; prefill and {LM_CUT_STEPS} decode "
              f"steps at most {worst:.3f} of the bf16 bound against the CPU "
              f"plain path")


def host_free_gib() -> float:
    """The host's free memory, GiB."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def lm_cut_phase(dev) -> tuple:
    """(c) Full-width models cut in depth on the card against the CPU
    plain path with the same parameters (``lm_vs_plain``), deepseek-v2's
    MLA prefill captured for (b). Returns (the printed lines' cuts, the
    card runs' flash_attention launches by arch, the captured inputs)."""
    from repro_torch.models import lm
    from repro_torch.nn.param import count_params
    cuts, launches, captured = [], {}, {}
    for arch, repeat, superblock, mem_tokens, dtype in LM_CUTS:
        full = lm_config(arch)
        cfg = lm_config(arch, repeat=repeat, superblock=superblock,
                        dtype=torch.float32 if dtype == "fp32" else None)
        if superblock is not None:
            print(f"[12] (c) host memory free before the {cfg.name} "
                  f"cut: {host_free_gib():.1f} GiB")
        params = lm_params(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (1, LM_CUT_PROMPT))).to(dev)
        mem = None
        if cfg.family == "vlm":
            mem = torch.randn((1, mem_tokens, cfg.mem_dim), generator=gen,
                              device=dev).to(cfg.dtype)
            check(mem_tokens == cfg.num_mem_tokens, f"[12] (c) {cfg.name}")
        elif cfg.family == "audio":
            mem = torch.randn((1, mem_tokens, cfg.d_model), generator=gen,
                              device=dev).to(cfg.dtype)
        t0 = time.perf_counter()
        with captured_attention((MLA_SHAPE,), captured):
            worst, card, by_body, gap = lm_vs_plain(
                f"[12] (c) {cfg.name} {dtype}", cfg, params, prompts, mem,
                LM_CUT_STEPS, LM_TOL[dtype])
        n = sum(by_body.values())
        want = attention_launches(cfg, LM_CUT_STEPS, mem is not None)
        check(n == want, f"[12] (c) {cfg.name}: {by_body} flash_attention "
                         f"launches, expected {want}")
        launches[f"{arch} {dtype}"] = n
        cut = []
        if superblock is not None:
            cut.append(f"superblock {superblock} of the "
                       f"{len(full.superblock)}-row one")
        if repeat is not None:
            cut.append(f"{cfg.repeat} of {full.repeat} repeats")
        cut = (", ".join(cut) + f" ({cfg.num_layers} of {full.num_layers} "
               "layers)") if cut else "not cut"
        cuts.append(f"{cfg.name} {dtype}: {cut}")
        mem_s = "" if mem is None else f", memory {tuple(mem.shape)}"
        gap_s = "" if gap is None else (
            f"; least gap between a token's k-th and (k+1)-th router "
            f"probability {gap:.3e}")
        print(f"[12] (c) {cfg.name} at full width, {dtype}, {cut}, "
              f"{count_params(lm.model_plan(cfg)):.4e} parameters{mem_s}: "
              f"prefill of {LM_CUT_PROMPT} tokens and {LM_CUT_STEPS} decode "
              f"steps at most {worst:.3f} of the {dtype} bound "
              f"({LM_TOL[dtype]} of the logit scale) against the CPU plain "
              f"path; flash_attention {by_body}{gap_s}; "
              f"{time.perf_counter() - t0:.1f} s")
        del params, card
        torch.cuda.empty_cache()
    check(MLA_SHAPE in captured, f"[12] (c) no MLA prefill call {MLA_SHAPE}")
    return cuts, launches, captured


def lm_phase(dev, errs: dict) -> dict:
    """Phase 12: LM serving. Returns (a)'s launches and rates, (a')'s
    rates, (b)'s timed rows and (c)'s launches."""
    t0 = time.perf_counter()
    served_a = lm_serve_phase()
    captured = served_a.pop("captured")
    rwkv = rwkv_serve_phase()
    torch.cuda.empty_cache()
    lm_reduced_phase(dev)
    cuts, cut_launches, mla = lm_cut_phase(dev)
    rows = lm_attention_phase({**captured, **mla}, errs)
    del captured, mla
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[12] (d) depth cuts: {'; '.join(cuts)}; phase 12 took "
          f"{wall:.1f} s (target {LM_TARGET_S:.0f} s)")
    return {**served_a, "rwkv_serving": rwkv, "rows": rows,
            "cut_launches": cut_launches, "wall_s": wall}


# ---------------------------------------------------------- phase 13 --
# LM training. (a) the flash_attention backward (the delta launch, then
# dK/dV and dQ by the body kernel.bwd_body_for picks: "wgmma",
# csrc/flash_attention_bwd_wgmma.cu, or "simt", csrc/flash_attention_bwd
# .cu) against its plain version, attention_bwd_ref in fp32 on the same
# inputs, from the forward's own lse2, at (label, BH, Sq, Skv, D, Dv,
# causal, dtype): qwen3-8b's training call (B 8 x 32 heads, S 512);
# deepseek-v2's MLA at D 192, Dv 128 (B 1 x 128 heads); whisper-base's
# encoder (B 4 x 8 heads over 1500 frames, non-causal) and its
# cross-attention (the decoder's 375 tokens over the 1500 frames); one
# fp32 call; ragged key lengths (333, not a multiple of any tile, causal
# with Sq != Skv, and D 30 / Dv 18, whose rows take 4-byte copies and
# the SIMT body in bf16 too)
BWD_SHAPES = (("qwen3-8b train", 8 * 32, 512, 512, 128, 128, True, "bf16"),
              ("deepseek-v2 MLA", 128, 512, 512, 192, 128, True, "bf16"),
              ("whisper-base encoder", 4 * 8, 1500, 1500, 64, 64, False,
               "bf16"),
              ("whisper-base cross-attention", 4 * 8, 375, 1500, 64, 64,
               False, "bf16"),
              ("qwen3-8b head, fp32", 32, 512, 512, 128, 128, True, "fp32"),
              ("ragged Skv", 8, 300, 333, 128, 128, True, "bf16"),
              ("ragged Skv, D 30 / Dv 18, fp32", 6, 77, 333, 30, 18, False,
               "fp32"),
              ("ragged Skv, D 30 / Dv 18, bf16", 6, 77, 333, 30, 18, False,
               "bf16"))
# the shape whose SIMT body is timed beside its wgmma body, in turns
BWD_TURNS = "qwen3-8b train"
# max |err| <= tol * max |plain| for each of dQ, dK and dV: fp32 sums the
# same products in another order (1e-4 of the scale, as the forward's
# ATTN_TOL); bf16 outputs are the fp32 result rounded once, against the
# plain version's unrounded fp32: half a bf16 step (2^-9 of a value) plus
# the order, held at one step of the largest value, 2^-8 ... doubled (the
# wgmma body also rounds P and dS to bf16 once, as its products' inputs)
BWD_TOL = {"fp32": 1e-4, "bf16": 2.0 ** -7}
# the forward's lse2 against attention_stats_ref's (logsumexp of the fp32
# scores times log2(e)): max |err| <= LSE_TOL * max |lse2|. The kernel
# sums the same products in another order and takes exp2f / log2f; an
# error of 1e-4 of a scale of ~10 moves P by ~7e-4 of itself, under the
# 2^-9 that rounding P to bf16 costs
LSE_TOL = 1e-4
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def bwd_launch(q, k, v, o, do, lse2, causal: bool, by_body=None,
               body=None) -> tuple:
    """The three backward launches from the forward's ``lse2``, outside
    the wrapper's count: (dQ, dK, dV). ``body`` forces one (None: the
    body ``bwd_body_for`` picks)."""
    from repro_torch.kernels.flash_attention.kernel import (
        attention_delta_cuda, attention_dkdv_cuda, attention_dq_cuda)
    delta = attention_delta_cuda(o, do)
    dk, dv = attention_dkdv_cuda(q, k, v, do, lse2, delta, causal=causal,
                                 by_body=by_body, body=body)
    return attention_dq_cuda(q, k, v, do, lse2, delta, causal=causal,
                             by_body=by_body, body=body), dk, dv


def sdpa_fwd_bwd_ms(q, k, v, do, causal: bool):
    """ms of scaled_dot_product_attention's forward and backward on the
    same inputs (the library yardstick), or (None, why)."""
    qq, kk, vv = (t[None].detach().requires_grad_() for t in (q, k, v))
    dd = do[None]

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=causal)
        torch.autograd.grad(out, (qq, kk, vv), dd)
    try:
        return cuda_ms(run, reps=10, inner=3), None
    except RuntimeError as e:
        return None, f"scaled_dot_product_attention: {e}"


def attention_bwd_phase(dev, errs: dict) -> list:
    """(a) Each ``BWD_SHAPES`` call: normal q, k, v and dO drawn on the
    card from a seeded generator, the forward kernel's output and lse2
    (lse2 held against ``attention_stats_ref`` within ``LSE_TOL``), the
    backward's dQ, dK and dV against ``attention_bwd_ref`` in fp32
    within ``BWD_TOL``, a second launch bit for bit the first (no
    atomics), the body that ran (as the launches record it; the
    qwen3-8b training call must run "wgmma"), then the backward timed
    beside its plain version, SDPA's forward + backward and its bound
    (``attention_bwd_work``; operations at the tensor cores' rate for
    bf16 inputs, the fp32 rate for fp32). At ``BWD_TURNS`` the SIMT
    body is also held to the plain version and timed beside the wgmma
    body, in turns (simt, wgmma, wgmma, simt)."""
    from repro_torch.kernels._cost import attention_bwd_work
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_body_for, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_stats_ref)
    rows = []
    for label, bh, sq, skv, d, dv, causal, dt in BWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(sq * 7 + skv + d)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(
            DTYPES[dt]) for shape in (
                (bh, sq, d), (bh, skv, d), (bh, skv, dv), (bh, sq, dv)))
        with torch.no_grad():
            o, lse2 = flash_attention_cuda(q, k, v, causal=causal,
                                           with_lse2=True)
        shape = (f"{label}: BH={bh} Sq={sq} Skv={skv} D={d} Dv={dv} "
                 f"{'causal' if causal else 'non-causal'} {dt}")
        want_lse2, _ = attention_stats_ref(q, k, o, do, causal=causal)
        lse_err = float((lse2 - want_lse2).abs().max())
        lse_bound = LSE_TOL * float(want_lse2.abs().max())
        check(bool(torch.isfinite(lse2).all()) and lse_err <= lse_bound,
              f"[13] (a) {shape}: the forward's lse2 max |err| {lse_err} "
              f"> {lse_bound}")
        errs["flash_attention lse2"] = max(
            errs.get("flash_attention lse2", 0.0), lse_err)
        body = bwd_body_for(q.dtype, d, dv, *(t.data_ptr() for t in (
            q, k, v, do)))
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, o, do)),
                                 causal=causal)
        bodies = (body, "simt") if label == BWD_TURNS else (body,)
        check(label != BWD_TURNS or body == "wgmma",
              f"[13] (a) {shape}: bwd_body_for picks {body}, not wgmma")
        for b in bodies:
            counts = dict.fromkeys(BODIES, 0)
            got = bwd_launch(q, k, v, o, do, lse2, causal, counts,
                             body=None if b == body else b)
            again = bwd_launch(q, k, v, o, do, lse2, causal,
                               body=None if b == body else b)
            check(counts == {**dict.fromkeys(BODIES, 0), b: 2},
                  f"[13] (a) {shape}: ran {counts}, expected the {b} body's "
                  "dK/dV and dQ launches")
            err, share = {}, {}
            for name, g, w, g2 in zip(("dQ", "dK", "dV"), got, want, again):
                check(g.dtype == q.dtype and g.shape == w.shape,
                      f"[13] (a) {shape} {b}: {name} "
                      f"{g.dtype}{tuple(g.shape)}")
                check(torch.equal(g, g2), f"[13] (a) {shape} {b}: {name} of "
                                          "a second launch has other bits")
                gf = g.float()
                check(bool(torch.isfinite(gf).all()),
                      f"[13] (a) {shape} {b}: {name} not finite")
                err[name] = float((gf - w).abs().max())
                bound = BWD_TOL[dt] * float(w.abs().max())
                share[name] = err[name] / bound
                check(err[name] <= bound, f"[13] (a) {shape} {b}: {name} "
                                          f"max |err| {err[name]} > {bound}")
            worst = max(err.values())
            key = f"flash_attention_backward {b}"
            errs[key] = max(errs.get(key, 0.0), worst)
            print(f"[13] (a) flash_attention backward {shape}, {b} body"
                  f"{'' if b == body else ' (forced)'}: max |err| dQ "
                  f"{err['dQ']:.3e} dK {err['dK']:.3e} dV {err['dV']:.3e} "
                  f"against attention_bwd_ref (fp32; tol {BWD_TOL[dt]} of "
                  f"each scale: " + " / ".join(f"{share[n]:.3f}" for n in
                                                share)
                  + " of it), a second launch bit for bit; the forward's "
                  f"lse2 max |err| {lse_err:.3e} against attention_stats_ref")
            rows.append(dict(shape=shape, body=b, forced=b != body,
                             max_abs_err=worst, errs=err,
                             share_of_tol=share))
            del got, again
        moved, ops = attention_bwd_work(q, k, v, o, do, causal=causal)
        bound, by = bound_ms(moved, ops, product_rate(q.dtype))
        picked = [r for r in rows[-len(bodies):] if not r["forced"]][0]
        if len(bodies) == 2:
            # in turns on the same inputs: simt, wgmma, wgmma, simt
            turns = {b: [] for b in bodies}
            for b in ("simt", body, body, "simt"):
                turns[b].append(cuda_ms(
                    lambda b=b: bwd_launch(q, k, v, o, do, lse2, causal,
                                           body=None if b == body else b),
                    reps=10, inner=3))
            for r in rows[-2:]:
                r["turns_ms"] = turns[r["body"]]
                r["ms"] = statistics.mean(turns[r["body"]])
        else:
            picked["ms"] = cuda_ms(lambda: bwd_launch(q, k, v, o, do, lse2,
                                                      causal),
                                   reps=10, inner=3)
        plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, o, do,
                                                     causal=causal),
                           reps=3, inner=1, device_only=False)
        lib, note = sdpa_fwd_bwd_ms(q, k, v, do, causal)
        for r in rows[-len(bodies):]:
            r.update(plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=lib)
            if note:
                r["library_note"] = note
            lib_s = f"{lib:.6f} ms" if lib is not None else f"null ({note})"
            turns_s = (" (turns " + ", ".join(f"{t:.6f}" for t in
                                              r["turns_ms"]) + ")"
                       if "turns_ms" in r else "")
            print(f"[13] (a) flash_attention backward {shape}, {r['body']} "
                  f"body: {r['ms']:.6f} ms{turns_s}, plain {plain_ms:.6f} "
                  f"ms, SDPA forward + backward {lib_s}, bound "
                  f"{bound:.6f} ms ({by}); {card_line()}")
        del q, k, v, o, do, lse2, want
    torch.cuda.empty_cache()
    return rows


# (b) qwen3-8b at full width (configs/qwen3_8b.py), cut to 2 of its 36
# layers as phase 12 cuts it: bf16, remat "full", fp32 AdamW moments,
# 20 steps of token_batch at B 8, S 512 through launch.train.run (the
# Trainer), with no checkpoint (its state is ~20 GB); its first step held
# against the CPU plain path at B 1, S 64 from the same weights
TRAIN_ARCH, TRAIN_LAYERS = "qwen3-8b", 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR, TRAIN_WARMUP = 1e-3, 5
TRAIN_CHECK_SEQ = 64
# card against the CPU plain path, relative to the CPU's value: the loss
# and the global gradient norm within phase 12's bf16 bound (2^-5): each
# row's bf16 sums land a bf16 step or two (2^-8) apart in cuBLAS's and
# the CPU's orders, compounding over the layers (tools/lm_divergence.py
# reads 3.2e-3 to 9.6e-3 of the stream's scale a row), and the backward
# adds its own; in fp32 the CPU tests' 1e-4
TRAIN_TOL = {"bf16": LM_BF16_TOL, "fp32": 1e-4}
# (c) the fault path at reduced(): a run that fails at FAULT_AT and
# resumes from its checkpoint against an uninterrupted one
FAULT_ARCH, FAULT_STEPS, FAULT_AT, FAULT_EVERY = "qwen3-8b", 24, 13, 8
FAULT_DIR = ROOT / "build" / "chip_smoke_train"
# (d) the other nine archs at reduced(): one train step each, card
# against the CPU plain path
TRAIN_OTHER_BATCH, TRAIN_OTHER_SEQ = 4, 32
TRAIN_TARGET_S = 75.0       # the phase's wall-time target, printed


def attention_counts() -> tuple:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    return flash_attention.launches, flash_attention.backward_launches


def backward_bodies() -> dict:
    """The backward's dK/dV and dQ launches by body since the counts
    were zeroed (two a backward call)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    return dict(flash_attention.backward_launches_by_body)


def zero_attention_counts() -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    flash_attention.launches = flash_attention.backward_launches = 0
    flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
    flash_attention.backward_launches_by_body = dict.fromkeys(BODIES, 0)


def train_attention_launches(cfg, with_mem: bool) -> tuple:
    """(forward, backward) ``flash_attention`` launches of one train step
    of ``cfg``: one a call, each ``attn``, ``attn_bidir``, ``xattn`` and
    ``mla`` row (the encoder's given the memory) a call a microbatch;
    under remat the layers of the stack (and of the encoder) run their
    forward again in the backward pass, the unrepeated prefix rows not."""
    def calls(rows):
        return sum(m in ("attn", "attn_bidir", "xattn", "mla")
                   for m, _ in rows)
    pre = calls(cfg.prefix)
    stack = calls(cfg.superblock) * cfg.repeat
    if cfg.encoder is not None and with_mem:
        stack += calls(cfg.encoder.superblock) * cfg.encoder.repeat
    again = stack if cfg.remat != "none" else 0
    accum = max(1, cfg.grad_accum)
    return accum * (pre + stack + again), accum * (pre + stack)


def grads_on(cfg, params: dict, batch: dict, device) -> tuple:
    """(loss, global gradient norm) of ``lm.loss_fn`` (sync_grads) on
    ``device`` with ``params`` and ``batch`` (numpy) moved there."""
    from repro_torch.launch.steps import to_device, value_and_grad
    from repro_torch.models import lm
    from repro_torch.optim.adamw import global_norm
    p = params if next(iter(params["embed"].values())).device == device \
        else tree_to(params, device)
    b = to_device(batch, device)
    loss, grads = value_and_grad(lambda q: lm.loss_fn(q, cfg, b,
                                                      sync_grads=True), p)
    return float(loss), float(global_norm(grads))


def card_vs_plain(label: str, dev, cfg, params: dict, batch: dict,
                  dtype: str) -> dict:
    """The loss and global gradient norm of one batch on the card (``dev``)
    and on the CPU plain path with the same parameters, within
    ``TRAIN_TOL``."""
    card = grads_on(cfg, params, batch, dev)
    host = grads_on(cfg, params, batch, torch.device("cpu"))
    out = {}
    for name, got, want in zip(("loss", "grad_norm"), card, host):
        rel = abs(got - want) / abs(want)
        check(np.isfinite(got) and rel <= TRAIN_TOL[dtype],
              f"{label}: {name} {got} on the card against {want} on the CPU "
              f"({rel:.3e} of it; bound {TRAIN_TOL[dtype]})")
        out[name] = dict(card=got, cpu=want, rel=rel)
    return out


def train_full_width_phase(dev) -> dict:
    """(b) qwen3-8b at full width and ``TRAIN_LAYERS`` layers: the first
    step against the CPU plain path, then ``TRAIN_STEPS`` steps through
    ``launch.train.run`` with the kernel counts set to 0 just before and
    read just after."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.nn.param import count_params
    cfg = lm_config(TRAIN_ARCH, repeat=TRAIN_LAYERS)
    full = lm_config(TRAIN_ARCH)
    check(cfg.d_model == 4096 and cfg.attn.num_heads == 32
          and cfg.attn.num_kv_heads == 8 and cfg.d_ff == 12288
          and cfg.vocab_size == 151936 and cfg.dtype == torch.bfloat16
          and cfg.remat == "full", f"[13] (b) {cfg}")
    params, opt_state = train.init_state(cfg, dev)
    check(opt_state["m"]["out"]["w"].dtype == torch.float32,
          "[13] (b) AdamW moments are not fp32")
    first = train.build_batch_fn(cfg, TRAIN_CHECK_SEQ, 1)(0)
    t0 = time.perf_counter()
    vs = card_vs_plain("[13] (b) first step", dev, cfg, params, first,
                       "bf16")
    check_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train.run(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                    ckpt_dir=str(FAULT_DIR / "full_width"), ckpt_every=0,
                    device=dev, params=params, opt_state=opt_state,
                    log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = attention_counts()
    by_body = dict(flash_attention.launches_by_body)
    bwd_by_body = backward_bodies()
    peak = torch.cuda.max_memory_allocated(dev)
    want_fwd, want_bwd = train_attention_launches(cfg, False)
    check(fwd == TRAIN_STEPS * want_fwd and bwd == TRAIN_STEPS * want_bwd,
          f"[13] (b) flash_attention launches {fwd} forward, {bwd} backward "
          f"over {TRAIN_STEPS} steps; expected {want_fwd} and {want_bwd} a "
          "step")
    check(bwd_by_body == {**dict.fromkeys(BODIES, 0), "wgmma": 2 * bwd},
          f"[13] (b) the backward's dK/dV and dQ launches by body "
          f"{bwd_by_body}; expected all {2 * bwd} on the wgmma body")
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"[13] (b) losses {losses}")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(tail < head, f"[13] (b) the loss did not fall: mean of the first "
                       f"5 {head}, of the last 5 {tail}")
    step_ms = [s * 1e3 for s in out["trainer"].step_s]
    median = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = dict(
        arch=cfg.name, layers=f"{cfg.repeat} of {full.repeat}",
        params=count_params(lm.model_plan(cfg)), batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, loss_first=losses[0],
        loss_last=losses[-1], loss_first5=head, loss_last5=tail,
        first_step_ms=step_ms[0], median_step_ms=median,
        tok_s=tokens / median * 1e3,
        tok_s_with_first=TRAIN_STEPS * tokens / sum(step_ms) * 1e3,
        peak_gib=peak / 2 ** 30, forward_launches_per_step=want_fwd,
        backward_launches_per_step=want_bwd, launches_by_body=by_body,
        backward_launches_by_body=bwd_by_body, first_step_vs_cpu=vs,
        wall_s=wall)
    print(f"[13] (b) {cfg.name} at full width (d {cfg.d_model}, "
          f"{cfg.attn.num_heads}/{cfg.attn.num_kv_heads} heads of "
          f"{cfg.attn.head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, "
          f"remat {cfg.remat}), {res['layers']} layers, {res['params']:.4e} "
          f"parameters, fp32 AdamW moments: first step at B 1, S "
          f"{TRAIN_CHECK_SEQ} against the CPU plain path: loss "
          f"{vs['loss']['card']:.6f} / {vs['loss']['cpu']:.6f} "
          f"({vs['loss']['rel']:.3e}), grad norm "
          f"{vs['grad_norm']['card']:.6f} / {vs['grad_norm']['cpu']:.6f} "
          f"({vs['grad_norm']['rel']:.3e}; bound {TRAIN_TOL['bf16']} each, "
          f"{check_s:.1f} s); {TRAIN_STEPS} steps at B {TRAIN_BATCH}, S "
          f"{TRAIN_SEQ} through the Trainer: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the first 5 {head:.4f}, of the last 5 "
          f"{tail:.4f}), first step {step_ms[0]:.1f} ms, median of the rest "
          f"{median:.2f} ms ({res['tok_s']:.1f} tok/s; "
          f"{res['tok_s_with_first']:.1f} with the first step), peak memory "
          f"{res['peak_gib']:.2f} GiB; flash_attention {want_fwd} forward "
          f"launches a step (each layer's twice: remat recomputes it in the "
          f"backward pass) and {want_bwd} backward (3 kernels each), by body "
          f"{by_body}, the backward's dK/dV and dQ by body {bwd_by_body}; "
          f"{wall:.1f} s")
    del params, opt_state, out
    torch.cuda.empty_cache()
    return res


def same_state(a: dict, b: dict) -> tuple:
    """(bitwise equal, the largest |a - b| over every leaf) of two
    trainer states."""
    equal, gap = True, 0.0
    for k, x in a.items():
        y = b[k]
        if isinstance(x, dict):
            e, g = same_state(x, y)
            equal, gap = equal and e, max(gap, g)
            continue
        equal = equal and x.dtype == y.dtype and torch.equal(
            x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
            y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        if x.is_floating_point():
            gap = max(gap, float((x.float() - y.float()).abs().max()))
    return equal, gap


def train_fault_phase(dev) -> dict:
    """(c) ``FAULT_ARCH`` at reduced() on the card under
    ``torch.use_deterministic_algorithms(True)``: an uninterrupted run of
    ``FAULT_STEPS`` steps, and a run that fails at ``FAULT_AT`` and is
    restarted from its checkpoint; the two end states bit for bit."""
    import shutil
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import SimulatedFailure
    cfg = lm_config(FAULT_ARCH, reduced=True)
    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def run(name, fail_at=None):
            return train.run(cfg, steps=FAULT_STEPS, batch=8, seq=64,
                             lr=3e-3, warmup=4,
                             ckpt_dir=str(FAULT_DIR / name),
                             ckpt_every=FAULT_EVERY, fail_at=fail_at,
                             device=dev, log=None)
        ref = run("ref")
        try:
            run("fault", fail_at=FAULT_AT)
            raise PhaseError("[13] (c) the injected failure did not fire")
        except SimulatedFailure:
            pass
        resumed = run("fault")
    finally:
        torch.use_deterministic_algorithms(was)
    resumed_from = FAULT_STEPS - len(resumed["losses"])
    t_ref, t_res = ref["trainer"], resumed["trainer"]
    equal, gap = same_state({"p": t_ref.params, "o": t_ref.opt_state},
                            {"p": t_res.params, "o": t_res.opt_state})
    losses_equal = ref["losses"][resumed_from:] == resumed["losses"]
    check(equal and losses_equal,
          f"[13] (c) the resumed run's end state is not the uninterrupted "
          f"run's bit for bit: largest gap {gap}, losses equal "
          f"{losses_equal}")
    print(f"[13] (c) {cfg.name} (reduced) on the card under "
          f"torch.use_deterministic_algorithms(True): failed at step "
          f"{FAULT_AT}, resumed from the checkpoint of step {resumed_from} "
          f"(every {FAULT_EVERY}), ran to {FAULT_STEPS}: end state (params, "
          f"AdamW m, v, step) bit for bit the uninterrupted run's, and its "
          f"losses after the resume too (loss {ref['losses'][0]:.4f} -> "
          f"{ref['losses'][-1]:.4f})")
    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    return dict(arch=cfg.name, steps=FAULT_STEPS, fail_at=FAULT_AT,
                resumed_from=resumed_from, bitwise=True)


def train_other_archs_phase(dev) -> dict:
    """(d) One train step (``launch.steps.make_train_step``) of each
    other arch at reduced() on the card against the same step on the CPU
    plain path from the same state: loss and grad norm within
    ``TRAIN_TOL``; the card's flash_attention launches held to
    ``train_attention_launches``. Returns the launches by arch."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw
    out = {}
    for arch in ARCHS:
        if arch == TRAIN_ARCH:
            continue
        cfg = lm_config(arch, reduced=True)
        params, opt_state = train.init_state(cfg, dev)
        batch = train.build_batch_fn(cfg, TRAIN_OTHER_SEQ,
                                     TRAIN_OTHER_BATCH)(0)
        # copies: the card's step updates its state in place
        host = tuple(adamw.tree_map(lambda t: t.to("cpu", copy=True), tree)
                     for tree in (params, opt_state))
        zero_attention_counts()
        card = steps.make_train_step(cfg, seq=TRAIN_OTHER_SEQ,
                                     batch=TRAIN_OTHER_BATCH, device=dev)
        _, _, m = card.fn(params, opt_state, batch)
        got = {k: float(v) for k, v in m.items()}
        fwd, bwd = attention_counts()
        bwd_by_body = backward_bodies()
        plain = steps.make_train_step(cfg, seq=TRAIN_OTHER_SEQ,
                                      batch=TRAIN_OTHER_BATCH, device="cpu")
        _, _, m = plain.fn(*host, batch)
        want = {k: float(v) for k, v in m.items()}
        gaps = {}
        for k in ("loss", "grad_norm"):
            gaps[k] = abs(got[k] - want[k]) / abs(want[k])
            check(np.isfinite(got[k]) and gaps[k] <= TRAIN_TOL["bf16"],
                  f"[13] (d) {cfg.name}: {k} {got[k]} on the card, "
                  f"{want[k]} on the CPU ({gaps[k]:.3e} of it)")
        want_fwd, want_bwd = train_attention_launches(cfg, "mem" in batch)
        check((fwd, bwd) == (want_fwd, want_bwd),
              f"[13] (d) {cfg.name}: flash_attention {fwd} forward, {bwd} "
              f"backward launches; expected {want_fwd}, {want_bwd}")
        check(sum(bwd_by_body.values()) == 2 * bwd,
              f"[13] (d) {cfg.name}: the backward's launches by body "
              f"{bwd_by_body} for {bwd} calls")
        out[arch] = dict(loss=got["loss"], grad_norm=got["grad_norm"],
                         rel=gaps, forward_launches=fwd,
                         backward_launches=bwd,
                         backward_launches_by_body=bwd_by_body)
        print(f"[13] (d) {cfg.name}: one train step on the card (B "
              f"{TRAIN_OTHER_BATCH}, S {TRAIN_OTHER_SEQ}"
              f"{', memory' if 'mem' in batch else ''}): loss "
              f"{got['loss']:.6f} ({gaps['loss']:.3e} of the CPU's), grad "
              f"norm {got['grad_norm']:.6f} ({gaps['grad_norm']:.3e}); "
              f"flash_attention {fwd} forward, {bwd} backward launches "
              f"(dK/dV and dQ by body {bwd_by_body})")
        del params, opt_state, host
    torch.cuda.empty_cache()
    return out


def train_phase(dev, errs: dict) -> dict:
    """Phase 13: LM training. (a) the backward kernel against its plain
    version and timed; (b) qwen3-8b at full width; (c) the fault path;
    (d) the other archs. Returns the rows of (a), the launches of (b),
    (c) and (d) and their readings."""
    t0 = time.perf_counter()
    rows = attention_bwd_phase(dev, errs)
    ta = time.perf_counter() - t0
    launches = {"forward": 0, "backward": 0, **dict.fromkeys(BODIES, 0)}
    tb = time.perf_counter()
    full = train_full_width_phase(dev)
    launches["forward"] += full["forward_launches_per_step"] * TRAIN_STEPS
    launches["backward"] += full["backward_launches_per_step"] * TRAIN_STEPS
    for b, n in full["backward_launches_by_body"].items():
        launches[b] += n
    tb = time.perf_counter() - tb
    tc = time.perf_counter()
    fault = train_fault_phase(dev)
    tc = time.perf_counter() - tc
    td = time.perf_counter()
    others = train_other_archs_phase(dev)
    for v in others.values():
        launches["forward"] += v["forward_launches"]
        launches["backward"] += v["backward_launches"]
        for b, n in v["backward_launches_by_body"].items():
            launches[b] += n
    td = time.perf_counter() - td
    wall = time.perf_counter() - t0
    print(f"[13] phase 13 took {wall:.1f} s ((a) {ta:.1f}, (b) {tb:.1f}, "
          f"(c) {tc:.1f}, (d) {td:.1f}; target {TRAIN_TARGET_S:.0f} s); "
          f"flash_attention launches on the training path ((b) and (d)): "
          f"{launches['forward']} forward (remat's recomputations "
          f"included), {launches['backward']} backward (dK/dV and dQ: "
          f"{launches['wgmma']} wgmma, {launches['simt']} simt)")
    return dict(rows=rows, launches=launches, full_width=full, fault=fault,
                others=others, wall_s=wall)


# ------------------------------------------------- phase 14: GNN training --
GNN_TRAIN_CONV = "gcn"
GNN_TRAIN_BATCH = 2048      # make_gnn_train_step's default batch
GNN_TRAIN_STEPS = 20
GNN_TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=GNN_TRAIN_STEPS)
GNN_CHECK_BATCH = 16        # (b)'s first step against the CPU plain path
GNN_STEP_BATCH = 64         # (c) every conv's one step (PNA's post input at
#                             2048 frames alone would be 8.2 GB)
GNN_PACKED_GRAPHS = 1024    # (a)'s shapes and (c)'s packed loss
GNN_PROFILE_STEPS = 3       # (b)'s traced window
# (d) the fault path at reduced(): a run that fails at GNN_FAULT_AT and
# resumes from its checkpoint against an uninterrupted one
GNN_FAULT_CONVS = ("gat", "pna")
GNN_FAULT_STEPS, GNN_FAULT_AT, GNN_FAULT_EVERY = 24, 13, 8
GNN_FAULT_BATCH = 8
GNN_DIR = ROOT / "build" / "chip_smoke_gnn"
# card against the CPU plain path, relative, by policy: the loss and the
# global gradient norm, and each leaf of the packed gradient against its
# scale. fp32: the kernels' forward and backward folds are the plain
# versions' bit for bit; the fp32 products differ in the last place (the
# card's FMA chain against the CPU's rounded multiply and add in the
# row-stable products; cuBLAS against the CPU's BLAS in torch.matmul's
# gradients): the CPU tests' 1e-4 against the JAX package. bf16: a value
# so moved can round to the neighbouring bf16 value, carried on by the
# later layers: the LM's TRAIN_TOL for bf16. int8: a value moves by a
# whole grid step only where the two sides' fp32 inputs straddle a
# rounding midpoint (rare); held to bf16's bound
GNN_TRAIN_TOL = {"fp32": 1e-4, "bf16": 2.0 ** -5, "int8": 2.0 ** -5}
# (b)'s and (e-3)'s launches a GCN step at benchmark_config, by policy: a
# gather a layer; dx once (layer 0 gathers the input features, which need
# no gradient); the row-stable products of the two layers (W, the skip
# projection) and the head's four layers; the products' gradients are
# torch.matmul's. bf16 and int8 launch the same kernels: the bf16 gathers
# read bf16 tables (dx folds the fp32 output gradient); int8 training
# reads the fp32 fake-quant grid where the gradient flows (layer 1's
# gather and its dx) and the int8 table where none does (layer 0's input)
GCN_STEP_LAUNCHES = {p: {"fused_gather_aggregate": 2,
                         "fused_gather_aggregate dx": 1, "tiled_matmul": 8}
                     for p in PRECISIONS}
# the gathers of a GCN step by the table's storage, by policy
GCN_STEP_GATHERS = {"fp32": {"fp32": 2}, "bf16": {"bf16": 2},
                    "int8": {"int8": 1, "fp32": 1}}
GNN_TARGET_S = 45.0         # the phase's wall-time target, printed
# (a)'s kernels held bit for bit to their plain versions
BITWISE_BACKWARDS = ("gather_scale_backward", "segment_aggregate_backward",
                     "segment_softmax_backward")
# (a)'s scale gradient by its generic body (F not a multiple of 4, or a
# table not 16-byte aligned): (edges, F, offset of x in elements)
SCALE_GENERIC_CASES = ((1001, 11, 0), (1001, 64, 1))
# (e) bf16 and int8 GNN training (ROADMAP item 12e-i). (e-1): the bf16
# bodies of rows 2c and 1c, at the calls of mse_loss_packed's gradient at
# bf16 of these convs (GIN's edge sum and PNA's towers: 2c; GAT's
# attention: 1c's dscale), and on hostile streams: a hub of
# BF16_HUB_EDGES rows (a segment; a source's out-edges) at F 128 / 64,
# and a table at F 11 one element into its buffer (misaligned)
GNN_LOW = ("bf16", "int8")
# (e-2)'s step, cut from (c)'s GNN_STEP_BATCH to keep the script's wall
# time (its CPU side is the largest part of (e-2)); the packed gradient
# keeps GNN_PACKED_GRAPHS
GNN_LOW_STEP_BATCH = 16
BF16_CONVS = ("gin", "pna", "gat")
BF16_BODIES = ("segment_aggregate_backward", "gather_scale_backward")
BF16_HUB_EDGES = 3000
# (f) a user's conv that aggregates by max or min (ROADMAP item 12e-ii),
# registered in the port's registry for (f) alone: GraphSAGE with the max
# (min) aggregator, PyG's SAGEConv(aggr="max"), and GAT's attention
# aggregated by max, PyG's GATConv(aggr="max"), whose attention weights
# take the gather's scale gradient
MINMAX_CONVS = {"sage_max": "max", "sage_min": "min", "gat_max": "max"}
MINMAX_KERNELS = ("gather_tie_weights", "gather_minmax_dx",
                  "gather_minmax_scale_backward")
# (f-2)'s policies by conv: both SAGE convs at every policy, gat_max at
# fp32 and bf16 (the masked scale gradient's two bodies; its int8 step
# reads the fp32 grid as fp32 does), cut to keep (f) near 25 s
MINMAX_POLICIES = {"sage_max": PRECISIONS, "sage_min": PRECISIONS,
                   "gat_max": ("fp32", "bf16")}
# (f-3): sage_max through the Trainer, and its launches a step by policy:
# a gather a layer, the tie weights and dx once (layer 1: layer 0 gathers
# the input features), the row-stable products (W_self, W_neigh and the
# skip projection a layer, the head's four layers)
MINMAX_TRAIN_CONV = "sage_max"
MINMAX_TRAIN_BATCH = 64
MINMAX_STEP_LAUNCHES = {"fused_gather_aggregate": 2, "gather_tie_weights": 1,
                        "gather_minmax_dx": 1, "tiled_matmul": 10}
MINMAX_TARGET_S = 25.0      # (f)'s wall-time target, printed
# (f-1)'s whole backwards timed in turns: sage_min's have sage_max's
# shapes; the library's, 0.34-0.48 ms a call with a host-heavy autograd
# pass, over 5 runs (its spread is 0.1 %)
MINMAX_TURN_CONVS = ("sage_max", "gat_max")
MINMAX_LIBRARY_REPS = 5


def gnn_wrappers() -> dict:
    """Each count phase 14 reads: (the wrapper, its counter's name[, the
    key of a counter by storage]); the two backward kernels' bf16 bodies
    are counted apart, by ``launches_by_dtype``."""
    from repro_torch.kernels.fused_gather_aggregate import ops as GO
    from repro_torch.kernels.segment_aggregate import ops as SO
    from repro_torch.kernels.segment_softmax import ops as XO
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul
    return {
        "fused_gather_aggregate": (GO.fused_gather_aggregate, "launches"),
        "fused_gather_aggregate dx": (GO.fused_gather_aggregate,
                                      "backward_launches"),
        "gather_scale_backward": (GO.gather_scale_backward, "launches"),
        "segment_aggregate": (SO.segment_aggregate, "launches"),
        "segment_aggregate_backward": (SO.segment_aggregate_backward,
                                       "launches"),
        "segment_softmax": (XO.segment_softmax, "launches"),
        "segment_softmax_backward": (XO.segment_softmax_backward,
                                     "launches"),
        "tiled_matmul": (tiled_matmul, "launches"),
        "gather_scale_backward bf16": (GO.gather_scale_backward,
                                       "launches_by_dtype", "bf16"),
        "segment_aggregate_backward bf16": (SO.segment_aggregate_backward,
                                            "launches_by_dtype", "bf16"),
        **{k: (getattr(GO, k), "launches") for k in MINMAX_KERNELS},
        **{f"{k} bf16": (getattr(GO, k), "launches_by_dtype", "bf16")
           for k in MINMAX_KERNELS},
    }


def gnn_counts() -> dict:
    out = {}
    for k, (w, a, *key) in gnn_wrappers().items():
        v = getattr(w, a)
        out[k] = v[key[0]] if key else v
    return out


def zero_gnn_counts() -> None:
    from repro_torch.kernels.fused_gather_aggregate import ops as GO
    for w, a, *key in gnn_wrappers().values():
        setattr(w, a, dict.fromkeys(getattr(w, a), 0) if key else 0)
    GO.fused_gather_aggregate.launches_by_dtype = dict.fromkeys(
        GO.fused_gather_aggregate.launches_by_dtype, 0)


def gnn_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(gnn_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def gnn_loss_grads(cfg, loss: str, params: dict, batch: dict,
                   device) -> tuple:
    """(loss, global gradient norm, gradient tree) of ``gnn_model.<loss>``
    on ``device``, from copies of ``params`` and the numpy ``batch``."""
    from repro_torch.core import gnn_model as G
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.optim.adamw import global_norm, tree_map
    p = tree_map(lambda t: t.to(device, copy=True), params)
    b = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in batch.items()}
    value, grads = value_and_grad(lambda q: getattr(G, loss)(q, cfg, b), p)
    return float(value), float(global_norm(grads)), grads


def gnn_card_vs_plain(label: str, dev, cfg, loss: str, params: dict,
                      batch: dict) -> dict:
    """The loss, the global gradient norm and every gradient leaf of one
    batch on the card and on the CPU plain path from the same parameters,
    within ``GNN_TRAIN_TOL`` of the config's policy."""
    tol = GNN_TRAIN_TOL[cfg.gnn_precision]
    card = gnn_loss_grads(cfg, loss, params, batch, dev)
    host = gnn_loss_grads(cfg, loss, params, batch, torch.device("cpu"))
    out = {}
    for i, name in enumerate(("loss", "grad_norm")):
        got, want = card[i], host[i]
        rel = abs(got - want) / abs(want)
        check(np.isfinite(got) and rel <= tol,
              f"{label}: {name} {got} on the card against {want} on the CPU "
              f"({rel:.3e} of it; bound {tol})")
        out[name] = dict(card=got, cpu=want, rel=rel)
    G, H = gnn_flat(card[2]), gnn_flat(host[2])
    worst = 0.0
    for k, want in H.items():
        got = G[k].cpu()
        gap = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        check(bool(torch.isfinite(got).all()) and gap <= tol,
              f"{label}: gradient {k} {gap:.3e} of its scale off the CPU's")
        worst = max(worst, gap)
    out["worst_leaf"] = worst
    return out


@contextlib.contextmanager
def captured_gnn_backward(spots: dict | None = None):
    """The backward launches of the model's gradients, recorded: {kernel:
    [(args, kwargs)]} (inputs cloned), each call still made; ``spots``
    {kernel: (module, wrapper name)}, by default rows 1c-3c's and row 1's
    dx. ``store["order"]`` lists the kernels in call order."""
    from repro_torch.kernels.fused_gather_aggregate import ops as GO
    from repro_torch.kernels.segment_aggregate import ops as SO
    from repro_torch.kernels.segment_softmax import ops as XO
    spots = spots or {
        "fused_gather_aggregate dx": (GO, "_gather_dx"),
        "gather_scale_backward": (GO, "gather_scale_backward"),
        "segment_aggregate_backward": (SO, "segment_aggregate_backward"),
        "segment_softmax_backward": (XO, "segment_softmax_backward")}
    store = {k: [] for k in spots}
    order = []
    saved = {k: getattr(m, a) for k, (m, a) in spots.items()}

    class Spy:
        """Records each call; its attributes (the launch counts, which
        the wrapper updates through its module's name) are the
        wrapper's."""

        def __init__(self, name, fn):
            object.__setattr__(self, "name", name)
            object.__setattr__(self, "fn", fn)

        def __call__(self, *args, **kwargs):
            store[self.name].append((tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), dict(kwargs)))
            order.append(self.name)
            return self.fn(*args, **kwargs)

        def __getattr__(self, attr):
            return getattr(self.fn, attr)

        def __setattr__(self, attr, value):
            setattr(self.fn, attr, value)
    for k, (m, a) in spots.items():
        setattr(m, a, Spy(k, saved[k]))
    try:
        yield store, order
    finally:
        for k, (m, a) in spots.items():
            setattr(m, a, saved[k])


def gnn_backward_library(name: str, args: tuple):
    """(ms, note) of one PyTorch call computing the same function, or
    (None, why)."""
    if name == "fused_gather_aggregate dx":
        dout, dst, coef, s_perm, s_off = args
        n, s = s_off.numel() - 1, dout.shape[0]
        counts = (s_off[1:] - s_off[:-1]).long()
        edges = s_perm[:int(s_off[-1])].long()
        rows = torch.repeat_interleave(torch.arange(n, device=dout.device),
                                       counts)
        vals = coef[edges] if coef is not None else torch.ones_like(
            rows, dtype=torch.float32)
        at = torch.sparse_coo_tensor(torch.stack([rows, dst[edges].long()]),
                                     vals, (n, s)).coalesce().to_sparse_csr()
        return (cuda_ms(lambda: torch.sparse.mm(at, dout)),
                "torch.sparse.mm of the transposed (N, S) adjacency")
    if name == "gather_scale_backward":
        dout, x, src, dst, weight = args
        ok = (dst >= 0) & (src >= 0)
        pattern = torch.sparse_coo_tensor(
            torch.stack([dst[ok], src[ok]]).long(),
            torch.ones(int(ok.sum()), device=x.device),
            (dout.shape[0], x.shape[0])).coalesce().to_sparse_csr()
        xt = x.t().contiguous()
        try:
            return (cuda_ms(lambda: torch.sparse.sampled_addmm(
                pattern, dout, xt, beta=0.0)),
                "torch.sparse.sampled_addmm of dout @ x^T at the edges")
        except RuntimeError as e:
            return None, f"torch.sparse.sampled_addmm: {e}"
    if name == "segment_aggregate_backward":
        return None, ("no single PyTorch call computes the gradient of a "
                      "segment min/max/std set with ties split equally")
    return None, ("no single PyTorch call computes a segment softmax's "
                  "gradient")


def backward_geometries(name: str, args: tuple, kwargs: dict) -> list:
    """(label, launch) of every other launch geometry of a segment or
    scale gradient call: each columns-a-lane cap on the card's SMs and on
    8; the scale gradient's vector body at each run of edges a warp, and
    its generic body."""
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.segment_aggregate import kernel as SK
    from repro_torch.kernels.segment_aggregate.ref import agg_set
    if name == "gather_scale_backward":
        e, f = args[2].numel(), args[0].shape[1]
        sms = torch.cuda.get_device_properties(
            args[0].device).multi_processor_count
        aligned = all(t.data_ptr() % 16 == 0 for t in args[:2])
        geos = [GK.scale_backward_geometry(e, f, sms, run=run)
                for run in (32, 16, 8, 4) if f % 4 == 0 and aligned]
        geos.append(GK.scale_backward_geometry(e, f, sms, aligned=False))
        return [(str(g), lambda g=g: GK.gather_scale_backward_cuda(
            *args, **kwargs, geometry=g)) for g in geos]
    if name != "segment_aggregate_backward":
        return []
    messages, perm, offsets = args[:3]
    sms = torch.cuda.get_device_properties(
        messages.device).multi_processor_count
    out = []
    for card in (sms, 8):
        for cap in (1, 2, 4):
            g = SK.segment_backward_geometry(
                offsets.numel() - 1, messages.shape[1], perm.numel(), card,
                len(agg_set(kwargs.get("agg", "sum"))), max_cols=cap)
            out.append((str(g), lambda g=g: SK.
                        segment_aggregate_backward_cuda(*args, **kwargs,
                                                        geometry=g)))
    return out


def gnn_backward_kernels_phase(dev, batch) -> list:
    """(a) The model's backward launches captured from ``mse_loss_packed``'s
    gradient on the card at ``GNN_PACKED_GRAPHS`` graphs (GCN: dx and the
    pooling set; GAT: dx, dscale, the softmax and the pooling set; PNA:
    the towers and the pooling set), each distinct call launched again
    against its plain version on the same inputs (bit for bit expected,
    held at ``SEGMENT_TOL``; ``BITWISE_BACKWARDS`` bit for bit, the
    segment and scale gradients at every launch geometry,
    ``backward_geometries``), a second launch bit for bit the first, then
    timed beside the plain version, its bound and the library call; then
    the scale gradient's generic body (``scale_generic_check``)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.kernels import _cost
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.fused_gather_aggregate import ref as GR
    from repro_torch.kernels.segment_aggregate import kernel as SK
    from repro_torch.kernels.segment_aggregate import ref as SR
    from repro_torch.kernels.segment_softmax import kernel as XK
    from repro_torch.kernels.segment_softmax import ref as XR
    from repro_torch.nn.param import init_params
    table = {
        "fused_gather_aggregate dx": (GK.fused_gather_aggregate_cuda,
                                      GR.fused_gather_aggregate_ref,
                                      _cost.gather_work),
        "gather_scale_backward": (GK.gather_scale_backward_cuda,
                                  GR.gather_scale_backward_ref,
                                  _cost.gather_scale_work),
        "segment_aggregate_backward": (SK.segment_aggregate_backward_cuda,
                                       SR.segment_aggregate_backward_ref,
                                       _cost.segment_bwd_work),
        "segment_softmax_backward": (XK.segment_softmax_backward_cuda,
                                     XR.segment_softmax_backward_ref,
                                     _cost.softmax_bwd_work),
    }
    calls = {}
    for conv in ("gcn", "gat", "pna"):
        cfg = benchmark_config(conv)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        with captured_gnn_backward() as (store, _):
            gnn_loss_grads(cfg, "mse_loss_packed", params, batch, dev)
        for name, got in store.items():
            for args, kwargs in got:
                key = (name, tuple(tuple(a.shape) if isinstance(
                    a, torch.Tensor) else a for a in args),
                    tuple(sorted(kwargs.items())))
                calls.setdefault(key, (conv, args, kwargs))
    rows = []
    for (name, shapes, _), (conv, args, kwargs) in calls.items():
        launch, plain, work = table[name]
        got = launch(*args, **kwargs)
        again = launch(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        label = (f"[14] (a) {name} ({conv}, "
                 f"{'; '.join(str(s) for s in shapes if s not in ((), None))}"
                 f"{', ' + str(kwargs['agg']) if 'agg' in kwargs else ''})")
        check(err <= SEGMENT_TOL["rtol"] * scale + SEGMENT_TOL["atol"],
              f"{label}: max |err| {err} against the plain version")
        check(same_bits(again, got), f"{label}: a second launch differs")
        variants = backward_geometries(name, args, kwargs)
        if name in BITWISE_BACKWARDS:
            check(same_bits(got, want),
                  f"{label}: not bit for bit the plain version")
        for geo, fn in variants:
            check(same_bits(fn(), got), f"{label}: {geo} gives other bits")
        moved, ops = work(*args, **kwargs)
        b_ms, by = bound_ms(moved, ops)
        ms = cuda_ms(lambda: launch(*args, **kwargs))
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), **PLAIN_TIMING)
        lib_ms, lib_note = gnn_backward_library(name, args)
        rows.append(dict(kernel=name, conv=conv, shape=label[9:],
                         max_abs_err=err, bitwise=same_bits(got, want),
                         geometries=len(variants),
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, library_ms=lib_ms,
                         library_note=lib_note))
        print(f"{label}: max |err| {err:.3e} against the plain version "
              f"(bit for bit: {rows[-1]['bitwise']}), {ms:.6f} ms [bound "
              f"{b_ms:.6f}, {by}], plain {plain_ms:.6f} ms, library "
              f"{'null' if lib_ms is None else f'{lib_ms:.6f} ms'} "
              f"({lib_note}); {len(variants)} other geometries bit for "
              "bit")
    for name in table:
        check(any(r["kernel"] == name for r in rows),
              f"[14] (a) {name} was never launched by a model's gradient")
    scale_generic_check(dev)
    return rows


def scale_generic_check(dev) -> None:
    """(a)'s scale gradient by its generic body, which no served call
    takes: each ``SCALE_GENERIC_CASES`` stream (ids from a seed, some out
    of range, mean weights) with its geometry chosen by shape, bit for
    bit the plain version."""
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.fused_gather_aggregate import ref as GR
    rng = np.random.default_rng(14)
    for e, f, shift in SCALE_GENERIC_CASES:
        n = 97
        src = torch.from_numpy(rng.integers(-2, n + 2, e).astype(
            np.int32)).to(dev)
        dst = torch.from_numpy(rng.integers(-1, n, e).astype(np.int32)).to(
            dev)
        w = torch.from_numpy(rng.uniform(0.1, 1.0, e).astype(
            np.float32)).to(dev)
        dout = torch.from_numpy(rng.standard_normal((n, f)).astype(
            np.float32)).to(dev)
        flat = torch.from_numpy(rng.standard_normal(n * f + shift).astype(
            np.float32)).to(dev)
        x = flat[shift:].view(n, f)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        g = GK.scale_backward_geometry(e, f, sms, aligned=shift == 0)
        label = f"[14] (a) gather_scale_backward, generic body: E {e}, F " \
                f"{f}, x {shift} elements into its buffer"
        check(g.body == "generic", f"{label}: geometry {g}")
        got = GK.gather_scale_backward_cuda(dout, x, src, dst, w)
        want = GR.gather_scale_backward_ref(dout, x, src, dst, w)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"{label}: not bit for bit the plain "
              f"version (max |err| {float((got - want).abs().max())})")
        print(f"{label}: bit for bit the plain version", flush=True)


def gcn_trainer_run(dev, cfg, label: str, launches: dict | None = None,
                    gathers: dict | None = None,
                    batch: int = GNN_TRAIN_BATCH) -> tuple:
    """``GNN_TRAIN_STEPS`` steps of ``make_gnn_train_step`` for GCN at
    ``cfg`` (its policy ``cfg.gnn_precision``) at ``GNN_TRAIN_BATCH``
    padded graphs of ``graph_batch`` through the ``Trainer`` (no
    checkpoint), from seed-0 parameters, the counts read just before and
    just after: the loss falls (the mean of the last 5 below the first
    5's), each step launches ``GCN_STEP_LAUNCHES[policy]`` and nothing
    else, its gathers ``GCN_STEP_GATHERS[policy]`` by the table's
    storage. Another conv's ``cfg`` passes its own ``launches`` and
    ``gathers`` a step, and may take another ``batch`` of frames.
    Returns (figures, bundle, trainer, batch_fn)."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.kernels.fused_gather_aggregate.ops import \
        fused_gather_aggregate
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.nn.param import count_params, init_params, materialize
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    policy = cfg.gnn_precision
    launches = launches or GCN_STEP_LAUNCHES[policy]
    gathers_per_step = gathers or GCN_STEP_GATHERS[policy]
    ds = DATASETS["qm9"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    bundle = make_gnn_train_step(cfg, batch=batch,
                                 opt_cfg=adamw.OptConfig(**GNN_TRAIN_OPT),
                                 device=dev)
    opt = materialize(bundle.abstract_args[1], None, dev)
    batch_s, events = [], []

    def batch_fn(step):
        t = time.perf_counter()
        b = P.graph_batch(ds, step, batch)
        batch_s.append(time.perf_counter() - t)
        return b

    def step_fn(p, o, b):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = bundle.fn(p, o, b)
        end.record()
        events.append((start, end))
        return out
    trainer = Trainer(TrainerConfig(total_steps=GNN_TRAIN_STEPS, ckpt_every=0,
                                    ckpt_dir=str(GNN_DIR / "full_width"),
                                    log_every=1000),
                      step_fn, batch_fn, params, opt, log=None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gathers = dict(fused_gather_aggregate.launches_by_dtype)
    before = gnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in gnn_counts().items()}
    gathers = {k: v - gathers[k] for k, v in
               fused_gather_aggregate.launches_by_dtype.items() if v
               - gathers[k]}
    peak = torch.cuda.max_memory_allocated(dev)
    device_ms = [s.elapsed_time(e) for s, e in events]
    for k, n in launches.items():
        check(counts[k] == n * GNN_TRAIN_STEPS,
              f"{label} {k}: {counts[k]} launches over {GNN_TRAIN_STEPS} "
              f"steps, expected {n} a step")
    others = {k: v for k, v in counts.items() if k not in launches}
    check(not any(others.values()),
          f"{label} a {cfg.gnn_conv} step launched {others}")
    want = {k: n * GNN_TRAIN_STEPS for k, n in gathers_per_step.items()}
    check(gathers == want, f"{label} the gathers by storage {gathers}, "
                           f"expected {want}")
    losses = out["losses"]
    check(len(losses) == GNN_TRAIN_STEPS and all(np.isfinite(losses)),
          f"{label} losses {losses}")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(tail < head, f"{label} the loss did not fall: mean of the first "
                       f"5 {head}, of the last 5 {tail}")
    step_ms = [s * 1e3 for s in trainer.step_s]
    median = statistics.median(step_ms[1:])
    res = dict(
        conv=cfg.gnn_conv, policy=policy,
        params=count_params(G.model_plan(cfg)),
        batch=batch, steps=GNN_TRAIN_STEPS, loss_first=losses[0],
        loss_last=losses[-1], loss_first5=head, loss_last5=tail,
        first_step_ms=step_ms[0], median_step_ms=median,
        graphs_s=GNN_TRAIN_BATCH / median * 1e3,
        median_batch_build_ms=statistics.median(s * 1e3
                                                for s in batch_s[1:]),
        median_step_stream_ms=statistics.median(device_ms[1:]),
        peak_gib=peak / 2 ** 30,
        launches_per_step=launches,
        gathers_by_storage_per_step=gathers_per_step, wall_s=wall)
    return res, bundle, trainer, batch_fn


def trainer_line(res: dict) -> str:
    """A ``gcn_trainer_run``'s figures, printed."""
    return (f"{res['steps']} steps of {res['batch']} padded graphs "
            f"(graph_batch, 600-node frames) through the Trainer: loss "
            f"{res['loss_first']:.5f} -> {res['loss_last']:.5f} (mean of "
            f"the first 5 {res['loss_first5']:.5f}, of the last 5 "
            f"{res['loss_last5']:.5f}), first step "
            f"{res['first_step_ms']:.1f} ms, median of the rest "
            f"{res['median_step_ms']:.2f} ms ({res['graphs_s']:.1f} "
            f"graphs/s): the host's graph_batch "
            f"{res['median_batch_build_ms']:.2f} ms, the step's stream "
            f"(copy in, forward, backward, AdamW) "
            f"{res['median_step_stream_ms']:.2f} ms; peak memory "
            f"{res['peak_gib']:.2f} GiB; launches a step "
            f"{res['launches_per_step']}, gathers a step by storage "
            f"{res['gathers_by_storage_per_step']}; {res['wall_s']:.1f} s")


def gnn_train_full_width_phase(dev) -> dict:
    """(b) GCN at ``benchmark_config`` (11 -> 128 -> 64, projection skips,
    add/mean/max pooling, MLP 192 -> 64 x 3 -> 1, fp32): its first step
    at ``GNN_CHECK_BATCH`` graphs against the CPU plain path, then
    ``gcn_trainer_run``; then ``GNN_PROFILE_STEPS`` more steps traced."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.nn.param import init_params
    cfg = benchmark_config(GNN_TRAIN_CONV)
    check(G.layer_dims(cfg) == [(11, 128), (128, 64)]
          and cfg.gnn_skip_connection
          and cfg.global_pooling == ("add", "mean", "max")
          and cfg.mlp_head.in_dim == 192 and cfg.mlp_head.hidden_dim == 64
          and cfg.mlp_head.hidden_layers == 3
          and cfg.mlp_head.out_dim == 1 and cfg.gnn_precision == "fp32",
          f"[14] (b) {cfg}")
    ds = DATASETS["qm9"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    t0 = time.perf_counter()
    vs = gnn_card_vs_plain("[14] (b) first step", dev, cfg, "mse_loss",
                           params, P.graph_batch(ds, 0, GNN_CHECK_BATCH))
    check_s = time.perf_counter() - t0
    del params
    res, bundle, trainer, batch_fn = gcn_trainer_run(dev, cfg, "[14] (b)")
    res["trace"] = gnn_profile(bundle, trainer, batch_fn)
    res["first_step_vs_cpu"] = vs
    print(f"[14] (b) {GNN_TRAIN_CONV} at benchmark_config (11 -> 128 -> 64, "
          f"projection skips, add/mean/max pooling, MLP 192 -> 64 x 3 -> 1, "
          f"fp32, {res['params']} parameters): first step at "
          f"{GNN_CHECK_BATCH} graphs against the CPU plain path: loss "
          f"{vs['loss']['card']:.7f} / {vs['loss']['cpu']:.7f} "
          f"({vs['loss']['rel']:.3e}), grad norm "
          f"{vs['grad_norm']['card']:.6f} / {vs['grad_norm']['cpu']:.6f} "
          f"({vs['grad_norm']['rel']:.3e}), worst leaf "
          f"{vs['worst_leaf']:.3e} (bound {GNN_TRAIN_TOL['fp32']}; "
          f"{check_s:.1f} s); {trainer_line(res)}")
    del bundle, trainer
    torch.cuda.empty_cache()
    return res


def gnn_profile(bundle, trainer, batch_fn) -> dict:
    """``GNN_PROFILE_STEPS`` more steps of (b) under ``torch.profiler``:
    wall, device busy (the sum of the kernels' and copies' device time),
    and the top device items."""
    from torch.profiler import ProfilerActivity, profile
    batches = [batch_fn(GNN_TRAIN_STEPS + i) for i in range(
        GNN_PROFILE_STEPS)]
    p, o = trainer.params, trainer.opt_state
    p, o, _ = bundle.fn(p, o, batches[0])     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            p, o, _ = bundle.fn(p, o, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / GNN_PROFILE_STEPS
    from torch.autograd import DeviceType

    def device_us(e) -> float:
        if e.device_type != DeviceType.CUDA:
            return 0.0
        for name in ("device_time_total", "cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0
    rows = [(e.key, device_us(e) / 1e3 / GNN_PROFILE_STEPS,
             e.count // GNN_PROFILE_STEPS)
            for e in prof.key_averages() if device_us(e) > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    out = dict(step_wall_ms=wall, device_busy_ms=busy,
               idle_share=1.0 - busy / wall if busy else None,
               events_per_step=sum(r[2] for r in rows),
               top=[dict(name=k[:80], ms=ms, calls=c)
                    for k, ms, c in rows[:8]])
    print(f"[14] (b) traced {GNN_PROFILE_STEPS} steps (the batches built "
          f"before the window): {wall:.2f} ms a step, device busy "
          f"{busy:.3f} ms ({out['events_per_step']} device events a step)"
          + (f", idle share {out['idle_share']:.4f}" if busy else
             ": no device time recorded (not measured)")
          + "; top: " + "; ".join(f"{r['name']} {r['ms']:.3f} ms x{r['calls']}"
                                  for r in out["top"]))
    return out


def gnn_every_conv_phase(dev, packed: dict) -> dict:
    """(c) Every conv at ``benchmark_config``: one ``make_gnn_train_step``
    step at ``GNN_STEP_BATCH`` padded graphs on the card against the same
    step on the CPU plain path from the same state (loss, grad norm), and ``mse_loss_packed``'s gradient at
    ``GNN_PACKED_GRAPHS`` packed graphs against the CPU's (loss, grad norm
    and every leaf)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core.convs import CONV_TYPES
    from repro_torch.data import pipeline as P
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.nn.param import init_params, materialize
    from repro_torch.optim import adamw
    ds = DATASETS["qm9"]
    batch = P.graph_batch(ds, 0, GNN_STEP_BATCH)
    out = {}
    for conv in CONV_TYPES:
        cfg = benchmark_config(conv)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
        metrics = []        # the card's, then the CPU's
        for d in (dev, torch.device("cpu")):
            bundle = make_gnn_train_step(cfg, batch=GNN_STEP_BATCH,
                                         device=d)
            p = adamw.tree_map(lambda t: t.to(d, copy=True), params)
            o = materialize(bundle.abstract_args[1], None, d)
            p, o, m = bundle.fn(p, o, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        gaps = {}
        for k in ("loss", "grad_norm"):
            got, want = metrics[0][k], metrics[1][k]
            gaps[k] = abs(got - want) / abs(want)
            check(np.isfinite(got) and gaps[k] <= GNN_TRAIN_TOL["fp32"],
                  f"[14] (c) {conv} step: {k} {got} on the card, {want} on "
                  f"the CPU ({gaps[k]:.3e} of it)")
        packed_vs = gnn_card_vs_plain(f"[14] (c) {conv} packed", dev, cfg,
                                      "mse_loss_packed", params, packed)
        out[conv] = dict(step=dict(metrics[0], rel=gaps),
                         packed=packed_vs)
        print(f"[14] (c) {conv} at benchmark_config: one step at "
              f"{GNN_STEP_BATCH} padded graphs, loss "
              f"{metrics[0]['loss']:.6f} ({gaps['loss']:.3e} of the "
              f"CPU's), grad norm {metrics[0]['grad_norm']:.6f} "
              f"({gaps['grad_norm']:.3e}); mse_loss_packed at "
              f"{GNN_PACKED_GRAPHS} graphs: "
              f"loss {packed_vs['loss']['rel']:.3e}, grad norm "
              f"{packed_vs['grad_norm']['rel']:.3e}, worst leaf "
              f"{packed_vs['worst_leaf']:.3e} of the CPU's")
        del params
    torch.cuda.empty_cache()
    return out


def gnn_fault_phase(dev) -> dict:
    """(d) ``GNN_FAULT_CONVS`` at reduced() on the card under
    ``torch.use_deterministic_algorithms(True)``: an uninterrupted
    ``Trainer`` run of the GNN step and one that fails at
    ``GNN_FAULT_AT`` and resumes from its checkpoint; the end states bit
    for bit (GAT and PNA gather rows by index, whose gradient is an
    accumulating index_put on the card)."""
    import shutil
    from repro_torch.configs.gnn import DATASETS, config
    from repro_torch.data import pipeline as P
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.nn.param import init_params, materialize
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                             TrainerConfig)
    ds = DATASETS["qm9"]
    shutil.rmtree(GNN_DIR, ignore_errors=True)
    out = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for conv in GNN_FAULT_CONVS:
            cfg = config(conv, reduced=True)
            bundle = make_gnn_train_step(
                cfg, batch=GNN_FAULT_BATCH, device=dev,
                opt_cfg=adamw.OptConfig(peak_lr=3e-3, warmup_steps=4,
                                        decay_steps=GNN_FAULT_STEPS))

            def run(name, fail_at=None):
                params = init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev)
                opt = materialize(bundle.abstract_args[1], None, dev)
                t = Trainer(TrainerConfig(
                    total_steps=GNN_FAULT_STEPS, ckpt_every=GNN_FAULT_EVERY,
                    ckpt_dir=str(GNN_DIR / f"{conv}_{name}"), log_every=1000),
                    bundle.fn,
                    lambda step: P.graph_batch(ds, step, GNN_FAULT_BATCH),
                    params, opt, fail_at_step=fail_at, log=None)
                return t, t.run()
            ref, ref_out = run("ref")
            try:
                run("fault", fail_at=GNN_FAULT_AT)
                raise PhaseError("[14] (d) the injected failure did not fire")
            except SimulatedFailure:
                pass
            res, res_out = run("fault")
            resumed_from = GNN_FAULT_STEPS - len(res_out["losses"])
            equal, gap = same_state({"p": ref.params, "o": ref.opt_state},
                                    {"p": res.params, "o": res.opt_state})
            losses_equal = ref_out["losses"][resumed_from:] \
                == res_out["losses"]
            check(equal and losses_equal,
                  f"[14] (d) {conv}: the resumed run's end state is not the "
                  f"uninterrupted run's bit for bit: largest gap {gap}, "
                  f"losses equal {losses_equal}")
            out[conv] = dict(steps=GNN_FAULT_STEPS, fail_at=GNN_FAULT_AT,
                             resumed_from=resumed_from, bitwise=True,
                             loss_first=ref_out["losses"][0],
                             loss_last=ref_out["losses"][-1])
            print(f"[14] (d) {conv} (reduced) on the card under "
                  f"torch.use_deterministic_algorithms(True), "
                  f"{GNN_FAULT_BATCH} graphs a step: failed at step "
                  f"{GNN_FAULT_AT}, resumed from the checkpoint of step "
                  f"{resumed_from}, ran to {GNN_FAULT_STEPS}: end state "
                  f"(params, AdamW m, v, step) and the losses after the "
                  f"resume bit for bit the uninterrupted run's (loss "
                  f"{ref_out['losses'][0]:.4f} -> "
                  f"{ref_out['losses'][-1]:.4f})")
    finally:
        torch.use_deterministic_algorithms(was)
    shutil.rmtree(GNN_DIR, ignore_errors=True)
    return out


def bf16_body_calls(dev, packed: dict) -> dict:
    """{(kernel, shapes, agg): (conv, args, kwargs)}: the distinct calls
    of rows 2c's and 1c's bf16 bodies (bf16 messages, a bf16 table) in
    ``mse_loss_packed``'s gradient at bf16 on the card, for each of
    ``BF16_CONVS`` at ``benchmark_config``."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.nn.param import init_params
    calls = {}
    for conv in BF16_CONVS:
        cfg = dataclasses.replace(benchmark_config(conv),
                                  gnn_precision="bf16")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        with captured_gnn_backward() as (store, _):
            gnn_loss_grads(cfg, "mse_loss_packed", params, packed, dev)
        for name in BF16_BODIES:
            for args, kwargs in store[name]:
                table = args[1] if name == "gather_scale_backward" \
                    else args[0]
                if table.dtype != torch.bfloat16:
                    continue
                key = (name, tuple(tuple(a.shape) if isinstance(
                    a, torch.Tensor) else a for a in args),
                    tuple(sorted(kwargs.items())))
                calls.setdefault(key, (conv, args, kwargs))
    return calls


def bf16_launches(name: str, args: tuple, kwargs: dict) -> list:
    """(label, launch) of each launch geometry of a bf16-body call: the
    default; the segment gradient at each columns-a-lane cap up to 8 on
    the card's SMs and on 8; the scale gradient's vector body at each run
    of edges a warp (x aligned to 4 elements, F % 4 == 0) and its generic
    body."""
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.segment_aggregate import kernel as SK
    from repro_torch.kernels.segment_aggregate.ref import agg_set
    table = args[1] if name == "gather_scale_backward" else args[0]
    sms = torch.cuda.get_device_properties(
        table.device).multi_processor_count
    if name == "gather_scale_backward":
        e, f = args[2].numel(), args[0].shape[1]
        aligned = args[0].data_ptr() % 16 == 0 and table.data_ptr() % 8 == 0
        geos = [GK.scale_backward_geometry(e, f, sms, run=run, elem_bytes=2)
                for run in (32, 16, 8, 4) if f % 4 == 0 and aligned]
        geos.append(GK.scale_backward_geometry(e, f, sms, aligned=False,
                                               elem_bytes=2))
        launch = GK.gather_scale_backward_cuda
    else:
        perm, offsets = args[1:3]
        geos = [SK.segment_backward_geometry(
            offsets.numel() - 1, table.shape[1], perm.numel(), card,
            len(agg_set(kwargs.get("agg", "sum"))), max_cols=cap,
            elem_bytes=2) for card in (sms, 8) for cap in (1, 2, 4, 8)]
        launch = SK.segment_aggregate_backward_cuda
    return [("default", lambda: launch(*args, **kwargs))] + [
        (str(g), lambda g=g: launch(*args, **kwargs, geometry=g))
        for g in geos]


def bf16_plain(name: str):
    """The plain version of a bf16 body: the scale gradient's on the bf16
    table, the segment gradient's (fp32) rounded once to bf16."""
    from repro_torch.kernels.fused_gather_aggregate import ref as GR
    from repro_torch.kernels.segment_aggregate import ref as SR
    if name == "gather_scale_backward":
        return GR.gather_scale_backward_ref
    return lambda *a, **k: SR.segment_aggregate_backward_ref(
        *a, **k).to(SR.grad_dtype(a[0]))


def bf16_bits(label: str, name: str, args: tuple, kwargs: dict) -> tuple:
    """A bf16-body call bit for bit its plain version at every launch
    geometry (``bf16_launches``), and a second default launch bit for bit
    the first. Returns (the first output, the geometries held)."""
    want = bf16_plain(name)(*args, **kwargs)
    launches = bf16_launches(name, args, kwargs)
    first = launches[0][1]()
    torch.cuda.synchronize()
    check(first.dtype == want.dtype and same_bits(first, want),
          f"{label}: not bit for bit the plain version (max |err| "
          f"{float((first.float() - want.float()).abs().max())})")
    check(same_bits(launches[0][1](), first),
          f"{label}: a second launch differs")
    for geo, fn in launches[1:]:
        check(same_bits(fn(), first), f"{label}: {geo} gives other bits")
    return first, len(launches) - 1


def bf16_hostile_calls(dev) -> list:
    """(label, kernel, args, kwargs) of the bf16 bodies on hostile
    streams (ids from a seed): a segment of ``BF16_HUB_EDGES`` rows among
    two-row ones (PNA's towers at F 128, a sum at F 128), a source with
    ``BF16_HUB_EDGES`` out-edges (the scale gradient at F 64), and each
    kernel on an F 11 bf16 table one element into its buffer, with ids
    out of range."""
    from repro_torch.core.aggregations import build_csr
    from repro_torch.core.convs import PNA_AGGS
    from repro_torch.kernels.segment_aggregate import kernel as SK
    rng = np.random.default_rng(15)

    def rows(e, f, shift=0):
        flat = np.round(rng.standard_normal(e * f + shift) * 4) / 4
        t = torch.from_numpy(flat.astype(np.float32)).to(
            torch.bfloat16).to(dev)
        return t[shift:].view(e, f)
    out = []
    s = 1000
    seg = np.concatenate([np.zeros(BF16_HUB_EDGES), np.repeat(
        np.arange(1, s), 2)]).astype(np.int32)
    seg = seg[rng.permutation(seg.size)]
    seg[:3] = [-1, s, -4]
    for f, aggs, shift in ((128, PNA_AGGS, 0), (128, ("sum",), 0),
                           (11, PNA_AGGS, 1)):
        m = rows(seg.size, f, shift)
        csr = build_csr(torch.from_numpy(seg).to(dev), s)
        fwd = SK.segment_aggregate_cuda(m, csr.perm, csr.offsets, agg=aggs)
        dout = torch.from_numpy(rng.standard_normal(tuple(fwd.shape)).astype(
            np.float32)).to(dev)
        out.append((f"segment hub of {BF16_HUB_EDGES} rows, F {f}, "
                    f"{'/'.join(aggs)}, messages {shift} elements in",
                    "segment_aggregate_backward",
                    (m, csr.perm, csr.offsets, fwd, dout), dict(agg=aggs)))
    n, s = 500, 2000
    e = BF16_HUB_EDGES + 4000
    src = rng.integers(-1, n + 1, e).astype(np.int32)
    src[rng.choice(e, BF16_HUB_EDGES, replace=False)] = 7
    dst = rng.integers(-1, s, e).astype(np.int32)
    w = torch.from_numpy(rng.uniform(0.1, 1.0, e).astype(np.float32)).to(dev)
    for f, shift in ((64, 0), (11, 1)):
        dout = torch.from_numpy(rng.standard_normal((s, f)).astype(
            np.float32)).to(dev)
        out.append((f"source hub of {BF16_HUB_EDGES} out-edges, F {f}, x "
                    f"{shift} elements in", "gather_scale_backward",
                    (dout, rows(n, f, shift), torch.from_numpy(src).to(dev),
                     torch.from_numpy(dst).to(dev), w), {}))
    return out


def bf16_bodies_phase(dev, packed: dict) -> list:
    """(e-1) The bf16 bodies of rows 2c and 1c at the 1024-graph packed
    batch's calls (``bf16_body_calls``) and on ``bf16_hostile_calls``'
    streams, each bit for bit its plain version at every geometry and a
    second launch the first's (``bf16_bits``); each served call timed
    beside its bound (``kernels/_cost.py``) and beside the fp32 call of
    the same shape (the table upcast), in turns (bf16, fp32, fp32, bf16),
    and beside its plain version."""
    from repro_torch.kernels import _cost
    works = {"gather_scale_backward": _cost.gather_scale_work,
             "segment_aggregate_backward": _cost.segment_bwd_work}
    rows = []
    for (name, shapes, _), (conv, args, kwargs) in bf16_body_calls(
            dev, packed).items():
        at = 1 if name == "gather_scale_backward" else 0
        label = (f"[14] (e-1) {name} bf16 ({conv}, "
                 f"{'; '.join(str(s) for s in shapes if s not in ((), None))}"
                 f"{', ' + str(kwargs['agg']) if 'agg' in kwargs else ''})")
        got, geos = bf16_bits(label, name, args, kwargs)
        launch = bf16_launches(name, args, kwargs)[0][1]
        wide = tuple(a.float() if i == at else a for i, a in enumerate(args))
        fp32 = bf16_launches(name, wide, kwargs)[0][1]
        turns = {"bf16": [], "fp32": []}
        for which in ("bf16", "fp32", "fp32", "bf16"):
            turns[which].append(cuda_ms(launch if which == "bf16" else fp32))
        moved, ops = works[name](*args, **kwargs)
        b_ms, by = bound_ms(moved, ops)
        plain_ms = cuda_ms(lambda: bf16_plain(name)(*args, **kwargs),
                           **PLAIN_TIMING)
        ms, ms32 = (statistics.mean(turns[k]) for k in ("bf16", "fp32"))
        rows.append(dict(kernel=name, conv=conv, shape=label[11:],
                         bitwise=True, geometries=geos, ms=ms, fp32_ms=ms32,
                         turns=turns, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, library_ms=None,
                         library_note="no single PyTorch call takes a bf16 "
                                      "table with an fp32 gradient"))
        print(f"{label}: bit for bit the plain version at {geos} other "
              f"geometries and across two launches; {ms:.6f} ms [bound "
              f"{b_ms:.6f}, {by}] (turns bf16 {turns['bf16'][0]:.6f} / "
              f"{turns['bf16'][1]:.6f}), the fp32 call of the same shape "
              f"{turns['fp32'][0]:.6f} / {turns['fp32'][1]:.6f} ms, plain "
              f"{plain_ms:.6f} ms", flush=True)
    for name in BF16_BODIES:
        check(any(r["kernel"] == name for r in rows),
              f"[14] (e-1) no bf16 call of {name} in the models' gradients")
    for label, name, args, kwargs in bf16_hostile_calls(dev):
        _, geos = bf16_bits(f"[14] (e-1) {name} bf16, {label}", name, args,
                            kwargs)
        print(f"[14] (e-1) {name} bf16, {label}: bit for bit the plain "
              f"version at {geos} other geometries and across two launches",
              flush=True)
    return rows


def gnn_low_precision_phase(dev, packed: dict, cases=None,
                            tag: str = "(e-2)") -> dict:
    """(e-2) Every conv at ``benchmark_config`` at each of ``GNN_LOW``
    (or each (conv, policy) of ``cases``, printed under ``tag``):
    one ``make_gnn_train_step`` step at ``GNN_LOW_STEP_BATCH`` padded graphs
    on the card against the same step on the CPU plain path from the same
    state (loss, grad norm), and ``mse_loss_packed``'s gradient at
    ``GNN_PACKED_GRAPHS`` packed graphs against the CPU's (loss, grad
    norm and every leaf), within ``GNN_TRAIN_TOL[policy]``; the gaps
    printed."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core.convs import CONV_TYPES
    from repro_torch.data import pipeline as P
    from repro_torch.launch.steps import make_gnn_train_step
    from repro_torch.nn.param import init_params, materialize
    from repro_torch.optim import adamw
    batch = P.graph_batch(DATASETS["qm9"], 0, GNN_LOW_STEP_BATCH)
    out = {}
    cases = cases or [(c, p) for c in CONV_TYPES for p in GNN_LOW]
    for conv, policy in cases:
        cfg = dataclasses.replace(benchmark_config(conv),
                                  gnn_precision=policy)
        tol = GNN_TRAIN_TOL[policy]
        params = init_params(cfg, torch.Generator(
            device=dev).manual_seed(1), dev)
        metrics = []        # the card's, then the CPU's
        for d in (dev, torch.device("cpu")):
            bundle = make_gnn_train_step(
                cfg, batch=GNN_LOW_STEP_BATCH, device=d)
            p = adamw.tree_map(lambda t: t.to(d, copy=True), params)
            o = materialize(bundle.abstract_args[1], None, d)
            p, o, m = bundle.fn(p, o, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        gaps = {}
        for k in ("loss", "grad_norm"):
            got, want = metrics[0][k], metrics[1][k]
            gaps[k] = abs(got - want) / abs(want)
            check(np.isfinite(got) and gaps[k] <= tol,
                  f"[14] {tag} {conv} {policy} step: {k} {got} on the "
                  f"card, {want} on the CPU ({gaps[k]:.3e} of it; "
                  f"bound {tol})")
        packed_vs = gnn_card_vs_plain(f"[14] {tag} {conv} {policy} "
                                      "packed", dev, cfg,
                                      "mse_loss_packed", params, packed)
        out[f"{conv} {policy}"] = dict(step=dict(metrics[0], rel=gaps),
                                       packed=packed_vs)
        print(f"[14] {tag} {conv} at benchmark_config, {policy}: one "
              f"step at {GNN_LOW_STEP_BATCH} padded graphs, loss "
              f"{metrics[0]['loss']:.6f} ({gaps['loss']:.3e} of the "
              f"CPU's), grad norm {metrics[0]['grad_norm']:.6f} "
              f"({gaps['grad_norm']:.3e}); mse_loss_packed at "
              f"{GNN_PACKED_GRAPHS} graphs: loss "
              f"{packed_vs['loss']['rel']:.3e}, grad norm "
              f"{packed_vs['grad_norm']['rel']:.3e}, worst leaf "
              f"{packed_vs['worst_leaf']:.3e} of the CPU's (bound "
              f"{tol})", flush=True)
        del params
    torch.cuda.empty_cache()
    return out


def gcn_low_precision_phase(dev, fp32: dict) -> dict:
    """(e-3) GCN at ``benchmark_config`` at each of ``GNN_LOW``:
    ``gcn_trainer_run`` (the loss falls, ``GCN_STEP_LAUNCHES`` and
    ``GCN_STEP_GATHERS`` of the policy), printed beside (b)'s fp32
    figures from the same call (``fp32``)."""
    from repro_torch.configs.gnn import benchmark_config
    out = {}
    for policy in GNN_LOW:
        cfg = dataclasses.replace(benchmark_config("gcn"),
                                  gnn_precision=policy)
        res, bundle, trainer, _ = gcn_trainer_run(dev, cfg,
                                                  f"[14] (e-3) {policy}")
        out[policy] = res
        print(f"[14] (e-3) gcn at benchmark_config, {policy}: "
              f"{trainer_line(res)}; (b)'s fp32 in this call: "
              f"{fp32['median_step_ms']:.2f} ms a step "
              f"({fp32['graphs_s']:.1f} graphs/s), graph_batch "
              f"{fp32['median_batch_build_ms']:.2f} ms, stream "
              f"{fp32['median_step_stream_ms']:.2f} ms, peak "
              f"{fp32['peak_gib']:.2f} GiB", flush=True)
        del bundle, trainer
        torch.cuda.empty_cache()
    return out


# --------------------------------- phase 14 (f): a user's max/min conv --
def minmax_apply(agg: str, attention: bool):
    """The apply of a user's conv that aggregates by ``agg``
    (``MINMAX_CONVS``): SAGE's x' = W_self x_v + b + W_neigh agg_u x_u,
    the neighbours aggregated at the input width, or GAT's attention with
    its weighted messages aggregated by ``agg``."""
    import torch.nn.functional as F
    from repro_torch.core import aggregations as A
    from repro_torch.core import convs as C
    from repro_torch.nn.layers import linear, matmul

    def sage(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        aggr = A.gather_aggregate(agg, x, src, dst, x.shape[0], g["valid_e"],
                                  csr=g.get("edge_csr"),
                                  precision=cfg.precision).to(x.dtype)
        return linear(params["w_self"], x) + linear(params["w_neigh"], aggr)

    def gat(params, g, x, cfg):
        src, dst = C.edge_endpoints(g)
        n = x.shape[0]
        h = matmul(x, params["w"]["w"])
        hf = h.float()
        logits = C._gather(matmul(hf, params["a_src"]), src) \
            + C._gather(matmul(hf, params["a_dst"]), dst)
        if "a_edge" in params:
            logits = logits + matmul(g["edge_feat"].float(),
                                     params["a_edge"]["w"].float())[:, 0]
        csr = g.get("edge_csr")
        alpha = A.segment_softmax(F.leaky_relu(logits, 0.2), dst, n,
                                  g["valid_e"], csr=csr)
        aggr = A.gather_aggregate(agg, h, src, dst, n, g["valid_e"], alpha,
                                  csr=csr, precision=cfg.precision)
        return linear(params["w_self"], x) + aggr.to(x.dtype) \
            + params["w"]["b"]
    return gat if attention else sage


@contextlib.contextmanager
def minmax_convs():
    """``MINMAX_CONVS`` in the port's registry for the block, as a user
    registers them (``register_conv``), and gone after it."""
    from repro_torch.core import convs as C
    names = []
    try:
        for name, agg in MINMAX_CONVS.items():
            gat = name.startswith("gat")
            C.register_conv(name, C.gat_plan if gat else C.sage_plan,
                            minmax_apply(agg, gat), attention=gat, dse=False)
            names.append(name)
        yield
    finally:
        for name in reversed(names):
            C.unregister_conv(name)


def minmax_launchers() -> dict:
    """{kernel: (launch, plain, work)} of the min/max gather's backward
    kernels, each on its wrapper's arguments."""
    from repro_torch.kernels import _cost
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.fused_gather_aggregate import ref as GR

    def dscale(w, x, src, dst, ext, scale, **kw):
        return GK.gather_scale_backward_cuda(w, x, src, dst, ext=ext,
                                             scale=scale, **kw)

    def dscale_plain(w, x, src, dst, ext, scale):
        return GR.gather_scale_backward_ref(w, x, src, dst, ext=ext,
                                            scale=scale)
    return {
        "gather_tie_weights": (GK.gather_tie_weights_cuda,
                               GR.gather_tie_weights_ref,
                               _cost.gather_tie_work),
        "gather_minmax_dx": (GK.gather_minmax_dx_cuda,
                             lambda *a: GR.gather_minmax_dx_ref(*a).to(
                                 a[0].dtype),
                             _cost.gather_minmax_dx_work),
        "gather_minmax_scale_backward": (dscale, dscale_plain,
                                         _cost.gather_minmax_scale_work),
    }


def minmax_geometries(name: str, args: tuple, kwargs: dict) -> list:
    """(label, launch) of every other geometry of a min/max backward call:
    the tie weights and dx at each columns-a-lane cap the tables allow on
    the card's SMs, on 8 and on 1; the masked scale gradient at each run
    of edges a warp of its vector body, and its generic body."""
    from repro_torch.kernels._geometry import aligned_cols
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    launch = minmax_launchers()[name][0]
    sms = torch.cuda.get_device_properties(
        args[0].device).multi_processor_count
    if name == "gather_minmax_scale_backward":
        w, x, src, _, ext, _ = args
        e, f = src.numel(), w.shape[1]
        aligned = w.data_ptr() % 16 == 0 and ext.data_ptr() % 16 == 0 \
            and x.data_ptr() % (4 * x.element_size()) == 0
        geos = [GK.scale_backward_geometry(e, f, sms, run=run)
                for run in (32, 16, 8, 4) if f % 4 == 0 and aligned]
        geos.append(GK.scale_backward_geometry(e, f, sms, aligned=False))
    else:
        tie = name == "gather_tie_weights"
        rows = args[4].numel() - 1 if tie else args[0].shape[0]
        tables = (args[0], args[5]) if tie else (args[0], args[2], args[3])
        cap = min(aligned_cols(t.data_ptr(), t.element_size(), 4)
                  for t in tables)
        geos = [GK.minmax_geometry(rows, args[0].shape[1], card, max_cols=c)
                for card in (sms, 8, 1) for c in (1, 2, 4) if c <= cap]
    return [(str(g), lambda g=g: launch(*args, **kwargs, geometry=g))
            for g in geos]


def minmax_same(got, want) -> bool:
    """Bit for bit, a pair of outputs (the tie weights' w and ext) or
    one, of one dtype."""
    if isinstance(got, tuple):
        return all(minmax_same(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and same_bits(got, want)


def minmax_err(got, want) -> float:
    """max |got - want| over the outputs (a NaN extreme against a NaN
    counts 0)."""
    if isinstance(got, tuple):
        return max(minmax_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).nan_to_num().abs().max()) \
        if got.numel() else 0.0


def minmax_bits(label: str, name: str, args: tuple, kwargs: dict,
                want=None) -> tuple:
    """A min/max backward call bit for bit its plain version (``want``
    where the caller has it) at its default geometry, across two
    launches and at every other geometry (``minmax_geometries``).
    Returns (max |err|, the geometries held)."""
    launch, plain, _ = minmax_launchers()[name]
    if want is None:
        want = plain(*args, **kwargs)
    got = launch(*args, **kwargs)
    again = launch(*args, **kwargs)
    torch.cuda.synchronize()
    err = minmax_err(got, want)
    check(minmax_same(got, want),
          f"{label}: not bit for bit the plain version (max |err| {err})")
    check(minmax_same(again, got), f"{label}: a second launch differs")
    geos = minmax_geometries(name, args, kwargs)
    for geo, fn in geos:
        check(minmax_same(fn(), got), f"{label}: {geo} gives other bits")
    return err, len(geos)


def minmax_calls(dev, packed: dict) -> tuple:
    """The min/max backward launches of ``mse_loss_packed``'s gradient at
    ``GNN_PACKED_GRAPHS`` graphs, each conv of ``MINMAX_CONVS`` at fp32
    and bf16 (inputs cloned): (calls [(label, kernel, args, kwargs)],
    groups [{"label", "tie": (args, kwargs), "gather_minmax_dx": args,
    "gather_minmax_scale_backward": args}], one for each gather's
    backward)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.kernels.fused_gather_aggregate import ops as GO
    from repro_torch.nn.param import init_params
    spots = {k: (GO, k) for k in MINMAX_KERNELS}
    calls, groups = [], []
    for conv in MINMAX_CONVS:
        for policy in ("fp32", "bf16"):
            cfg = dataclasses.replace(benchmark_config(conv),
                                      gnn_precision=policy)
            params = init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), dev)
            with captured_gnn_backward(spots) as (store, order):
                gnn_loss_grads(cfg, "mse_loss_packed", params, packed, dev)
            at = dict.fromkeys(store, 0)
            for name in order:
                args, kwargs = store[name][at[name]]
                at[name] += 1
                tie = name == "gather_tie_weights"
                label = f"{conv} {policy}, gather backward " \
                        f"{len(groups) - (not tie)}"
                calls.append((label, name, args, kwargs))
                if tie:
                    groups.append(dict(label=label, policy=policy,
                                       agg=kwargs["agg"], tie=args))
                else:
                    groups[-1][name] = args
    return calls, groups


def minmax_backward_fns(group: dict) -> dict:
    """Three functions of one gather's backward, on its inputs: the min/max
    kernels (the tie weights, then dx and, where the scale has a gradient,
    the masked scale gradient); the sum gather's backward of the same
    shape (dx over the source CSR, dscale); and the library, the forward
    and backward of ``scatter_reduce_(reduce="amax"/"amin",
    include_self=False)`` over ``x[src] * scale``."""
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    x, src, scale, perm, offsets, dout = group["tie"]
    _, _, w, ext, dst, s_perm, s_offsets = group["gather_minmax_dx"]
    masked = group.get("gather_minmax_scale_backward")

    def minmax():
        w2, e2 = GK.gather_tie_weights_cuda(x, src, scale, perm, offsets,
                                            dout, agg=group["agg"])
        GK.gather_minmax_dx_cuda(x, scale, w2, e2, dst, s_perm, s_offsets)
        if masked is not None:
            GK.gather_scale_backward_cuda(w2, x, src, dst, ext=e2,
                                          scale=scale)

    def summed():
        GK.fused_gather_aggregate_cuda(dout, dst, scale, s_perm, s_offsets)
        if masked is not None:
            GK.gather_scale_backward_cuda(dout, x, src, dst)

    ok = dst >= 0
    s_idx, d_idx = src[ok].long(), dst[ok].long()
    d_idx = d_idx[:, None].expand(-1, x.shape[1])
    x32 = x.float().requires_grad_()
    sc = None if scale is None else scale[ok].clone().requires_grad_(
        masked is not None)
    leaves = [x32] + ([sc] if masked is not None else [])
    reduce = "amax" if group["agg"] == "max" else "amin"

    def library():
        msg = x32[s_idx]
        if sc is not None:
            msg = msg * sc[:, None]
        out = torch.zeros_like(dout).scatter_reduce(0, d_idx, msg, reduce,
                                                    include_self=False)
        torch.autograd.grad(out, leaves, dout)
    return dict(minmax=minmax, sum=summed, library=library)


def minmax_turns(groups: list) -> list:
    """Each gather's backward of ``MINMAX_TURN_CONVS`` timed in turns
    (min/max, sum, library, library, sum, min/max), the means kept."""
    out = []
    for g in groups:
        if g["label"].split()[0] not in MINMAX_TURN_CONVS:
            continue
        fns = minmax_backward_fns(g)
        turns = {k: [] for k in fns}
        for k in ("minmax", "sum", "library", "library", "sum", "minmax"):
            reps = MINMAX_LIBRARY_REPS if k == "library" else 25
            try:
                turns[k].append(cuda_ms(fns[k], reps=reps))
            except PhaseError:      # the library call synchronises
                turns[k].append(cuda_ms(fns[k], **PLAIN_TIMING))
        x, _, _, _, offsets, dout = g["tie"]
        out.append(dict(label=g["label"], policy=g["policy"],
                        shape=f"x {tuple(x.shape)} {str(x.dtype)[6:]}, S "
                              f"{offsets.numel() - 1}, dscale "
                              f"{'gather_minmax_scale_backward' in g}",
                        **{f"{k}_ms": statistics.mean(v)
                           for k, v in turns.items()}, turns=turns))
    return out


def minmax_hostile_calls(dev) -> list:
    """(label, agg, tie args, the source side of its CSR) of hostile
    streams (ids from a seed), on a coarse grid (ties) with negative
    scales, empty segments (0-2), -1 and out-of-range ids on both
    streams: with hubs (a destination of ``BF16_HUB_EDGES`` in-edges
    whose messages all tie, one source at scale 1, and a source of as
    many out-edges) at F 128, fp32 and bf16; without (the plain versions
    fold a hub slot by slot, seconds on the card) at F 11 one element
    into its buffer (misaligned) and F 130 (not a multiple of 4)."""
    from repro_torch.core.aggregations import gather_csr
    rng = np.random.default_rng(16)
    n, s = 500, 2000

    def stream(hubs: bool):
        e = 2 * BF16_HUB_EDGES * hubs + 4000
        src = rng.integers(0, n, e)
        dst = rng.integers(3, s, e)
        src[rng.random(e) < 0.05] = -1
        src[rng.random(e) < 0.03] = n + 2
        dst[rng.random(e) < 0.05] = -1
        dst[rng.random(e) < 0.03] = s + 1
        scale = rng.choice([-1.0, 0.5, 1.0, 2.0], e).astype(np.float32)
        if hubs:
            hub = rng.permutation(e)
            dst[hub[:BF16_HUB_EDGES]], src[hub[:BF16_HUB_EDGES]] = 5, 7
            scale[hub[:BF16_HUB_EDGES]] = 1.0
            src[hub[BF16_HUB_EDGES:2 * BF16_HUB_EDGES]] = 9
        src_t = torch.from_numpy(src.astype(np.int32)).to(dev)
        csr = gather_csr(src_t, torch.from_numpy(dst.astype(np.int32)).to(
            dev), n, s, transpose=True)
        return src_t, torch.from_numpy(scale).to(dev), csr
    streams = {True: stream(True), False: stream(False)}
    out = []
    for f, dtype, shift, agg, hubs in (
            (128, torch.float32, 0, "max", True),
            (128, torch.bfloat16, 0, "min", True),
            (11, torch.float32, 1, "max", False),
            (130, torch.float32, 0, "min", False)):
        src_t, sc, csr = streams[hubs]
        flat = np.round(rng.standard_normal(n * f + shift) * 2) / 2
        x = torch.from_numpy(flat.astype(np.float32)).to(dtype).to(dev)
        x = x[shift:].view(n, f)
        dout = torch.from_numpy(rng.standard_normal((s, f)).astype(
            np.float32)).to(dev)
        label = (f"hubs of {BF16_HUB_EDGES} tied in-edges and "
                 f"{BF16_HUB_EDGES} out-edges, " if hubs else "") + \
            f"F {f}, {str(dtype)[6:]}, x {shift} elements in, {agg}"
        out.append((label, agg, (x, src_t, sc, csr.perm, csr.offsets, dout),
                    csr.transpose))
    return out


def minmax_hostile_phase(dev) -> int:
    """(f-1)'s hostile calls: each kernel bit for bit its plain version at
    every geometry and across two launches (``minmax_bits``), with the
    scale and, at F 11, also without. Returns the calls held."""
    from repro_torch.kernels.fused_gather_aggregate import ref as GR
    held = 0
    for label, agg, tie, (dst, s_perm, s_off) in minmax_hostile_calls(dev):
        x, src, scale = tie[:3]
        for sc in (scale, None) if x.shape[1] == 11 else (scale,):
            args = (x, src, sc) + tie[3:]
            w, ext = GR.gather_tie_weights_ref(*args, agg=agg)
            calls = (("gather_tie_weights", args, dict(agg=agg)),
                     ("gather_minmax_dx",
                      (x, sc, w, ext, dst, s_perm, s_off), {}),
                     ("gather_minmax_scale_backward",
                      (w, x, src, dst, ext, sc), {}))
            for name, a, kw in calls:
                tag = f"[14] (f-1) {name}, {label}" + (
                    "" if sc is not None else ", no scale")
                err, geos = minmax_bits(
                    tag, name, a, kw,
                    (w, ext) if name == "gather_tie_weights" else None)
                held += 1
                print(f"{tag}: bit for bit the plain version at {geos} "
                      "other geometries and across two launches",
                      flush=True)
    return held


def minmax_kernels_phase(dev, packed: dict) -> tuple:
    """(f-1) The min/max backward kernels at the calls of
    ``minmax_calls`` (sage_max's, sage_min's and gat_max's gradients at
    1024 graphs, fp32 and bf16), each bit for bit its plain version at
    every geometry and across two launches (``minmax_bits``), timed
    beside its bound (``kernels/_cost.py``) and its plain version; each
    gather's whole backward timed in turns beside the sum gather's
    backward of the same shape and the library's scatter_reduce_
    (``minmax_turns``); then ``minmax_hostile_phase``. Returns (rows,
    turns, the hostile calls held)."""
    t0 = time.perf_counter()
    calls, groups = minmax_calls(dev, packed)
    t_capture = time.perf_counter() - t0
    rows = []
    for label, name, args, kwargs in calls:
        launch, plain, work = minmax_launchers()[name]
        tag = f"[14] (f-1) {name} ({label})"
        err, geos = minmax_bits(tag, name, args, kwargs)
        moved, ops = work(*args, **kwargs)
        b_ms, by = bound_ms(moved, ops)
        ms = cuda_ms(lambda: launch(*args, **kwargs))
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), **PLAIN_TIMING)
        rows.append(dict(kernel=name, call=label,
                         policy=label.split()[1].rstrip(","),
                         shape=f"x {tuple(args[1 if name.endswith('scale_backward') else 0].shape)}",
                         max_abs_err=err, bitwise=True, geometries=geos,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by))
        print(f"{tag}: bit for bit the plain version at {geos} other "
              f"geometries and across two launches; {ms:.6f} ms [bound "
              f"{b_ms:.6f}, {by}], plain {plain_ms:.6f} ms", flush=True)
    for name in MINMAX_KERNELS:
        for policy in ("fp32", "bf16"):
            check(any(r["kernel"] == name and r["policy"] == policy
                      for r in rows),
                  f"[14] (f-1) no {policy} call of {name} in the convs' "
                  "gradients")
    t_rows = time.perf_counter() - t0 - t_capture
    turns = minmax_turns(groups)
    t_turns = time.perf_counter() - t0 - t_capture - t_rows
    for t in turns:
        print(f"[14] (f-1) backward of {t['label']} ({t['shape']}): "
              f"min/max kernels {t['minmax_ms']:.6f} ms, the sum gather's "
              f"backward of the same shape {t['sum_ms']:.6f} ms, "
              f"scatter_reduce_ forward and backward {t['library_ms']:.6f} "
              f"ms (in turns)", flush=True)
    held = minmax_hostile_phase(dev)
    print(f"[14] (f-1) took {time.perf_counter() - t0:.1f} s: the calls "
          f"captured {t_capture:.1f}, held and timed {t_rows:.1f}, the "
          f"backwards in turns {t_turns:.1f}, the hostile calls "
          f"{time.perf_counter() - t0 - t_capture - t_rows - t_turns:.1f}",
          flush=True)
    return rows, turns, held


def gnn_minmax_phase(dev, packed: dict) -> dict:
    """(f) A user's conv that aggregates by max or min (``MINMAX_CONVS``,
    registered for (f) alone): (f-1) ``minmax_kernels_phase``; then, the
    counts set to 0, (f-2) each conv at ``benchmark_config`` at its
    ``MINMAX_POLICIES``: (e-2)'s step and packed gradient against the CPU
    plain path within ``GNN_TRAIN_TOL``; (f-3) ``MINMAX_TRAIN_CONV``
    through the ``Trainer`` at ``MINMAX_TRAIN_BATCH`` frames: the loss
    falls, ``MINMAX_STEP_LAUNCHES`` a step; the counts read after (f-3):
    the three kernels and their bf16 bodies launched."""
    from repro_torch.configs.gnn import benchmark_config
    t0 = time.perf_counter()
    with minmax_convs():
        rows, turns, held = minmax_kernels_phase(dev, packed)
        t1 = time.perf_counter()
        zero_gnn_counts()
        low = gnn_low_precision_phase(
            dev, packed, [(c, p) for c, ps in MINMAX_POLICIES.items()
                          for p in ps], tag="(f-2)")
        t2 = time.perf_counter()
        cfg = benchmark_config(MINMAX_TRAIN_CONV)
        res, bundle, trainer, _ = gcn_trainer_run(
            dev, cfg, "[14] (f-3)", launches=MINMAX_STEP_LAUNCHES,
            gathers={"fp32": 2}, batch=MINMAX_TRAIN_BATCH)
        launches = gnn_counts()
        del bundle, trainer
    t3 = time.perf_counter()
    for k in MINMAX_KERNELS:
        for key in (k, f"{k} bf16"):
            check(launches[key] > 0,
                  f"[14] (f) {key} was never launched on the training path")
    print(f"[14] (f-3) {MINMAX_TRAIN_CONV} at benchmark_config, fp32: "
          f"{trainer_line(res)}", flush=True)
    print(f"[14] (f) took {t3 - t0:.1f} s ((f-1) {t1 - t0:.1f}, (f-2) "
          f"{t2 - t1:.1f}, (f-3) {t3 - t2:.1f}; target "
          f"{MINMAX_TARGET_S:.0f} s); (f-1) held {len(rows)} served and "
          f"{held} hostile calls; launches on (f-2)-(f-3): "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    torch.cuda.empty_cache()
    return dict(rows=rows, turns=turns, hostile_calls=held, low=low,
                train=res, launches=launches, wall_s=t3 - t0)


def gnn_train_phase(dev) -> dict:
    """Phase 14: GNN training. (a) the backward kernels against their
    plain versions and timed; (e-1) their bf16 bodies likewise; (b) GCN
    at full width through the Trainer; (c) every conv's step and packed
    gradient against the CPU; (d) the fault path; (e-2) every conv's
    step and packed gradient at bf16 and int8 against the CPU; (e-3) GCN
    at bf16 and int8 through the Trainer. The kernel counts are set to 0
    after (e-1) and read after (e-3): the launches of the training
    path; then (f) a user's max/min conv (``gnn_minmax_phase``), whose
    counts are set to 0 after its (f-1) and read after its (f-3), and
    added."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    ds = DATASETS["qm9"]
    nb, eb = serve.budgets(GNN_PACKED_GRAPHS, ds)
    graphs = [P.make_graph(ds, i) for i in range(GNN_PACKED_GRAPHS)]
    packed, _ = P.pack_graphs(graphs, nb, eb, GNN_PACKED_GRAPHS)
    rows = gnn_backward_kernels_phase(dev, packed)
    ta = time.perf_counter() - t0
    te = time.perf_counter()
    bf16_rows = bf16_bodies_phase(dev, packed)
    te1 = time.perf_counter() - te
    zero_gnn_counts()
    tb = time.perf_counter()
    full = gnn_train_full_width_phase(dev)
    tb = time.perf_counter() - tb
    tc = time.perf_counter()
    every = gnn_every_conv_phase(dev, packed)
    tc = time.perf_counter() - tc
    td = time.perf_counter()
    fault = gnn_fault_phase(dev)
    td = time.perf_counter() - td
    te = time.perf_counter()
    low = gnn_low_precision_phase(dev, packed)
    te2 = time.perf_counter() - te
    te = time.perf_counter()
    low_gcn = gcn_low_precision_phase(dev, full)
    te3 = time.perf_counter() - te
    launches = gnn_counts()
    for k, n in launches.items():
        if k.split()[0] not in MINMAX_KERNELS:      # (f)'s, read after it
            check(n > 0, f"[14] {k} was never launched on the training path")
    minmax = gnn_minmax_phase(dev, packed)
    launches = {k: v + minmax["launches"][k] for k, v in launches.items()}
    wall = time.perf_counter() - t0
    print(f"[14] phase 14 took {wall:.1f} s ((a) {ta:.1f}, (b) {tb:.1f}, "
          f"(c) {tc:.1f}, (d) {td:.1f}, (e) {te1 + te2 + te3:.1f}: (e-1) "
          f"{te1:.1f}, (e-2) {te2:.1f}, (e-3) {te3:.1f}; (f) "
          f"{minmax['wall_s']:.1f}; target {GNN_TARGET_S:.0f} s for (a)-(e)); "
          f"launches on the training path ((b)-(f)): {launches}")
    return dict(rows=rows, bf16_rows=bf16_rows, launches=launches,
                full_width=full, every_conv=every, fault=fault,
                low_precision=dict(every_conv=low, gcn=low_gcn,
                                   wall_s=te1 + te2 + te3),
                minmax=minmax, wall_s=wall)


def summarize_gnn_backward(gnn: dict) -> list:
    """The three backward kernels' entries: (a)'s calls summed, the
    launches of phase 14's training path."""
    meta = {
        "gather_scale_backward": (
            "src/repro_torch/csrc/fused_gather_aggregate_bwd.cu",
            "src/repro/kernels/fused_gather_aggregate/kernel.py:259"),
        "segment_aggregate_backward": (
            "src/repro_torch/csrc/segment_aggregate_bwd.cu",
            "src/repro/kernels/segment_aggregate/kernel.py:271"),
        "segment_softmax_backward": (
            "src/repro_torch/csrc/segment_softmax_bwd.cu",
            "src/repro/kernels/segment_softmax/kernel.py:139"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rows = [r for r in gnn["rows"] if r["kernel"] == name]
        libs = [r for r in rows if r["library_ms"] is not None]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "replaces_note": "none: the JAX package differentiates its XLA "
                             "form and its Pallas kernel has no VJP; this "
                             "is the gradient of the port's forward kernel",
            "launches": gnn["launches"][name],
            "launches_by_phase": {"14": gnn["launches"][name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bitwise": all(r["bitwise"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in libs)
            if len(libs) == len(rows) else None,
            "library_note": rows[0]["library_note"],
            "shapes": "phase 14 (a): " + "; ".join(r["shape"] for r in rows),
            "calls": rows,
        }
        low = [r for r in gnn["bf16_rows"] if r["kernel"] == name]
        if low:     # the bf16 body: (e-1)'s calls, (b)-(e)'s launches
            entry["by_storage"] = {"bf16": {
                "launches": gnn["launches"][f"{name} bf16"],
                **{k: sum(r[k] for r in low) for k in (
                    "ms", "fp32_ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in low) else "operations",
                "library_ms": None, "library_note": low[0]["library_note"],
                "bitwise": all(r["bitwise"] for r in low),
                "shapes": "phase 14 (e-1): " + "; ".join(
                    r["shape"] for r in low),
                "calls": low}}
        out.append(entry)
    return out


def summarize_minmax(gnn: dict) -> list:
    """The min/max gather's three backward kernels' entries (row 1d):
    (f-1)'s fp32 calls summed (the bf16 body's under
    ``by_storage["bf16"]``), the launches of phase 14's training path
    ((f-2) and (f-3)); the tie weights' entry also carries each gather's
    whole backward timed in turns (``backward_turns``)."""
    mm = gnn["minmax"]
    sources = {
        "gather_tie_weights": "src/repro_torch/csrc/gather_minmax_bwd.cu",
        "gather_minmax_dx": "src/repro_torch/csrc/gather_minmax_bwd.cu",
        "gather_minmax_scale_backward":
            "src/repro_torch/csrc/fused_gather_aggregate_bwd.cu"}

    def summed(rows: list) -> dict:
        return {**{k: sum(r[k] for r in rows) for k in (
            "ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bitwise": all(r["bitwise"] for r in rows),
            "shapes": "phase 14 (f-1): " + "; ".join(
                f"{r['call']}, {r['shape']}" for r in rows)}
    out = []
    for name, source in sources.items():
        rows = [r for r in mm["rows"] if r["kernel"] == name]
        fp32 = [r for r in rows if r["policy"] == "fp32"]
        bf16 = [r for r in rows if r["policy"] == "bf16"]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/fused_gather_aggregate/"
                        "kernel.py:259",
            "replaces_note": "none: the backward of row 1's min/max "
                             "gather; the JAX package differentiates its "
                             "XLA form and its Pallas kernel has no VJP",
            "launches": gnn["launches"][name],
            "launches_by_phase": {"14": gnn["launches"][name]},
            **summed(fp32), "library_ms": None,
            "library_note": "no single PyTorch call computes this part of "
                            "the gradient; the whole backward against "
                            "scatter_reduce_'s forward and backward is in "
                            "the tie weights' backward_turns",
            "calls": fp32,
            "by_storage": {"bf16": {
                "launches": gnn["launches"][f"{name} bf16"], **summed(bf16),
                "library_ms": None, "calls": bf16}}}
        if name == "gather_tie_weights":
            entry["backward_turns"] = mm["turns"]
        out.append(entry)
    return out


def gnn_dx_entry(gnn: dict) -> dict:
    """Row 1's gradient dx: the gather kernel over the source CSR, (a)'s
    calls summed and its launches on the training path."""
    rows = [r for r in gnn["rows"]
            if r["kernel"] == "fused_gather_aggregate dx"]
    libs = [r for r in rows if r["library_ms"] is not None]
    return {
        "launches": gnn["launches"]["fused_gather_aggregate dx"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "bitwise": all(r["bitwise"] for r in rows),
        **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms",
                                                "bound_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in libs)
        if len(libs) == len(rows) else None,
        "library_note": rows[0]["library_note"],
        "shapes": "; ".join(r["shape"] for r in rows),
    }


def summarize_backward(train: dict, errs: dict) -> list:
    """The backward's entries, one a body: (a)'s calls of that body
    summed (each the three launches: delta, dK/dV, dQ), and the body's
    dK/dV and dQ launches on the training path ((b) and (d)); the delta
    launch, in the SIMT body's source, counts one a backward call."""
    meta = {
        "simt": ("flash_attention_backward",
                 "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "the delta launch and the SIMT body's dK/dV and dQ "
                 "launches"),
        "wgmma": ("flash_attention_backward_wgmma",
                  "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
                  "the tensor-core body's dK/dV and dQ launches, after "
                  "the delta launch of flash_attention_bwd.cu"),
    }
    out = []
    for body, (name, source, what) in meta.items():
        rows = [r for r in train["rows"] if r["body"] == body]
        libs = [r for r in rows if r["library_ms"] is not None]
        n = train["launches"][body]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:57",
            "replaces_note": "none: the JAX package differentiates its jnp "
                             "attention and has no Pallas backward; this is "
                             "the gradient of the port's forward kernel, "
                             + what,
            "launches": n,
            "launches_by_phase": {"13": n},
            "max_abs_err": errs[f"flash_attention_backward {body}"],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in libs) if libs
            else None,
            "library_note": "scaled_dot_product_attention forward + "
                            "backward",
            "shapes": "phase 13 (a): " + "; ".join(
                r["shape"] + (" (forced)" if r["forced"] else "")
                for r in rows),
            "calls": rows,
        }
        if body == "simt":
            entry["delta_launches"] = train["launches"]["backward"]
            entry["training"] = {k: train[k] for k in (
                "full_width", "fault", "others")}
        if len(libs) < len(rows):
            entry["library_calls"] = len(libs)
            entry["ms_on_library_calls"] = sum(r["ms"] for r in libs)
        out.append(entry)
    return out


def summarize(rows, errs, launches, by_precision) -> dict:
    """One entry per kernel: per-batch sums over its launches at the
    largest serving shape (1024 graphs per batch), for GCN's batch
    (gather, segment; the figures of the first slice; the resident
    stack; the one-hot kernels) and GAT's (softmax). ``launches`` counts
    every phase-4 drain of every conv at every precision, resident drains
    included, and the phase-7 Project programs (where the one-hot kernels
    run); ``launches_by_precision`` splits it by the policy of the
    program that launched. ``by_storage``: the same sums over phase 6's
    bf16 and int8 rows (GCN's gathers; PNA's towers; the stack at those
    precision rows)."""
    meta = {
        "fused_gather_aggregate": dict(
            source="src/repro_torch/csrc/fused_gather_aggregate.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/kernel.py:259",
            conv="gcn"),
        "segment_aggregate": dict(
            source="src/repro_torch/csrc/segment_aggregate.cu",
            replaces="src/repro/kernels/segment_aggregate/kernel.py:271",
            conv="gcn"),
        "segment_softmax": dict(
            source="src/repro_torch/csrc/segment_softmax.cu",
            replaces="src/repro/kernels/segment_softmax/kernel.py:88",
            conv="gat"),
        "fused_layer_stack": dict(
            source="src/repro_torch/csrc/fused_layer_stack.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/"
                     "residency.py:151",
            conv="gcn"),
        "fused_gather_onehot": dict(
            source="src/repro_torch/csrc/fused_gather_onehot.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/kernel.py:128",
            conv="gcn"),
        "segment_aggregate_onehot": dict(
            source="src/repro_torch/csrc/segment_aggregate_onehot.cu",
            replaces="src/repro/kernels/segment_aggregate/kernel.py:134",
            conv="gcn"),
    }
    last = rows[-1]["batch"]
    out = []
    for i, (name, m) in enumerate(meta.items()):
        sel = [r for r in rows if r["kernel"] == name and r["batch"] == last
               and r["conv"] == m["conv"] and r["path"]]
        table = ONEHOT_LAUNCHES_PER_BATCH if name.endswith("onehot") \
            else LAUNCHES_PER_BATCH
        per_batch = RESIDENT_LAUNCHES[i] if name == "fused_layer_stack" \
            else table[m["conv"]][i]
        check(len(sel) == per_batch,
              f"{name}: {len(sel)} timed launches for a {m['conv']} batch")
        by = "bytes" if all(r["bound_by"] == "bytes" for r in sel) \
            else "operations"
        libs = [r["library_ms"] for r in sel]
        entry = {
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": m["replaces"], "launches": launches[name],
            "launches_per_batch": {c: t[i] for c, t in table.items()},
            "resident_launches_per_batch": {
                c: RESIDENT_LAUNCHES[i] for c in RESIDENT_CONVS},
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": by,
            "library_ms": None if None in libs else sum(libs),
            "shapes": f"{m['conv']} {last}, per batch: "
                      + "; ".join(r["shape"] for r in sel),
        }
        entry["launches_by_precision"] = {
            p: by_precision[p][name] for p in PRECISIONS}
        low = [r for r in rows if r["kernel"] == name and r.get("storage")]
        if low:
            entry["by_storage"] = {st: {
                **{k: sum(r[k] for r in low if r["storage"] == st)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes" if all(
                    r["bound_by"] == "bytes" for r in low
                    if r["storage"] == st) else "operations",
                "library_ms": None,
                "shapes": "; ".join(r["shape"] for r in low
                                    if r["storage"] == st)}
                for st in LOW_PRECISIONS}
        else:
            entry["storage_note"] = ("fp32 at every policy: the softmax "
                                     "weights never take the layer's width")
        if name == "fused_layer_stack":
            entry["max_abs_err_by_mode"] = {
                mode: errs[f"{name} {mode}"] for mode in QP_ROWS}
            entry["layerwise_ms"] = sum(r["layerwise_ms"] for r in sel)
        if "steps" in sel[0]:
            entry["ms_per_step"] = [r["ms"] / r["steps"] for r in sel]
        if entry["library_ms"] is None:
            entry["library_note"] = NO_LIBRARY[name]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.convs import CONV_TYPES
    from repro_torch.data import pipeline as P
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[2] built {lib.name} from "
          f"{[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log").read_text()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             log))
    print(f"    ptxas: {len(regs)} kernel instances, at most {max(regs)} "
          f"registers per thread, {spills} bytes of spill stores")

    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(2048)]
    batches = {}
    for bg in RESIDENT_BATCHES:
        nb, eb = serve.budgets(bg, ds)
        batches[bg] = (f"{bg} graphs/batch",
                       P.pack_dataset(queue, nb, eb, bg)[0][0])
    path_batches = [batches[32], batches[1024]]
    resident_batches = [batches[bg] for bg in RESIDENT_BATCHES]

    t3 = time.perf_counter()
    errs = kernels_vs_plain(dev, path_batches, resident_batches)
    print(f"[3] phase 3 took {time.perf_counter() - t3:.1f} s")
    check(set(CONV_TYPES) == set(LAUNCHES_PER_BATCH),
          f"registered convs {CONV_TYPES} != launch table "
          f"{tuple(LAUNCHES_PER_BATCH)}")
    launches = dict.fromkeys(KERNELS, 0)
    by_precision = {p: dict.fromkeys(KERNELS, 0) for p in PRECISIONS}

    def add(part: dict, precision: str) -> None:
        for k, v in part.items():
            launches[k] += v
            by_precision[precision][k] += v

    t4 = time.perf_counter()
    wave = {}
    for conv in CONV_TYPES:
        # 2048 requests at 1024 graphs/batch are two measured batches; the
        # 10240-request drain gives a window of 10 batches for graphs/s
        drains = [(256, 32), (2048, 1024), (10240, 1024)] if conv == "gcn" \
            else [(256, 32), (10240, 1024)]
        for requests, bg in drains:
            add(serve_phase(conv, requests, bg, wave=wave), "fp32")
        for precision in LOW_PRECISIONS:
            for requests, bg in LOW_DRAINS:
                add(serve_phase(conv, requests, bg, precision), precision)
    for conv in RESIDENT_CONVS:
        for bg in RESIDENT_BATCHES:
            # 10 measured batches at each size
            add(resident_phase(dev, conv, bg, 10 * bg), "fp32")
        for precision in LOW_PRECISIONS:
            for bg in RESIDENT_BATCHES:
                add(resident_phase(dev, conv, bg, LOW_RESIDENT_BATCHES * bg,
                                   precision), precision)
    print(f"[4] phase 4 took {time.perf_counter() - t4:.1f} s")
    t5 = time.perf_counter()
    for conv in CONV_TYPES:
        for precision in PRECISIONS:
            golden_phase(dev, conv, precision=precision)
            if conv in RESIDENT_CONVS:
                golden_phase(dev, conv, resident=True, precision=precision)
        oracle_phase(dev, conv)
    print(f"[5] phase 5 took {time.perf_counter() - t5:.1f} s")
    t6 = time.perf_counter()
    rows = timing_phase(dev, path_batches, resident_batches)
    rows += storage_timing_phase(dev, *batches[1024])
    print(f"[6] phase 6 took {time.perf_counter() - t6:.1f} s")
    t7 = time.perf_counter()
    for k, v in project_phase(dev, by_precision).items():
        launches[k] += v
    print(f"[7] phase 7 took {time.perf_counter() - t7:.1f} s")
    for precision, counts in by_precision.items():
        check(all(v > 0 for v in counts.values()),
              f"a kernel was never launched by a {precision} program: "
              f"{counts}")
    t8 = time.perf_counter()
    tables = padded_tables(batches[1024][1], P.make_graph(ds, 0))
    entry_errs = entry_kernels_vs_plain(dev, tables)
    calls = entry_calls(dev, tables)
    entry_launches, bodies = entry_path_phase(dev, calls, entry_errs)
    entry_rows = entry_timing_phase(calls, bodies)
    del calls
    print(f"[8] phase 8 took {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    add(serving_phase(dev, wave), "fp32")
    print(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    dist_launches, products = dist_phase(card)
    add(dist_launches, "fp32")
    print(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s")
    dse_launches = dse_phase(dev)
    lm = lm_phase(dev, entry_errs)
    train = train_phase(dev, entry_errs)
    gnn = gnn_train_phase(dev)
    summary = summarize(rows, errs, launches, by_precision)
    summary["kernels"] += summarize_entries(entry_rows, entry_errs,
                                            entry_launches)
    # the partitioned program's row-stable products (phase 10) are
    # tiled_matmul launches on a model path
    for k in summary["kernels"]:
        if k["name"] == "tiled_matmul":
            k["launches_by_phase"] = {"8": k["launches"], "10": products}
            k["launches"] += products
    # the DSE's designs on the card (phase 11)
    for k in summary["kernels"]:
        n = dse_launches.get(k["name"], 0)
        k.setdefault("launches_by_phase", {})["11"] = n
        k["launches"] += n
    # the LM serving path (phase 12): every attention in flash_attention,
    # (a)'s serving run and (c)'s card runs
    for k in summary["kernels"]:
        n = (lm["launches"] + sum(lm["cut_launches"].values())
             if k["name"] == "flash_attention" else 0)
        k["launches_by_phase"]["12"] = n
        k["launches"] += n
        if n:
            k["launches_by_phase"]["8"] = entry_launches[k["name"]]
            k["lm_launches_by_body"] = lm["by_body"]
            k["lm_cut_launches"] = lm["cut_launches"]
            k["lm_calls"] = lm["rows"]
            k["lm_serving"] = {key: lm[key] for key in (
                "tok_s", "ms_per_step", "first_step_ms", "median_step_ms",
                "prefill_ms")}
            k["lm_serving_rwkv6"] = lm["rwkv_serving"]
    # the LM training path (phase 13): the forward launches of (b) and (d)
    # (remat's recomputations included), and the backward kernel's entry
    for k in summary["kernels"]:
        n = train["launches"]["forward"] \
            if k["name"] == "flash_attention" else 0
        k["launches_by_phase"]["13"] = n
        k["launches"] += n
    summary["kernels"] += summarize_backward(train, entry_errs)
    # the GNN training path (phase 14): rows 1-3's forward launches (row
    # 1's dx over the source CSR beside them) and row 8b's products, and
    # the three backward kernels' entries
    for k in summary["kernels"]:
        n = gnn["launches"].get(k["name"], 0)
        if k["name"] == "fused_gather_aggregate":
            n += gnn["launches"]["fused_gather_aggregate dx"]
            k["backward_dx"] = gnn_dx_entry(gnn)
            k["gnn_training"] = {key: gnn[key] for key in (
                "full_width", "every_conv", "fault", "low_precision",
                "wall_s")}
        k["launches_by_phase"]["14"] = n
        k["launches"] += n
    summary["kernels"] += summarize_gnn_backward(gnn)
    summary["kernels"] += summarize_minmax(gnn)
    check(all(k["launches"] > 0 for k in summary["kernels"]),
          "a kernel was never launched on the serving path")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except (Exception, KernelFault):    # any failed phase: exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
