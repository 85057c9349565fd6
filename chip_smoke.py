#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py [--out PATH]

Phases, each of which raises on failure (nothing is caught):

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, and the seconds ``nvcc`` took to build ``kernels/csrc/sweep.cu``.
2. Kernels vs plain at check shapes: each CUDA kernel against its plain
   PyTorch version on the same inputs on the card, bit for bit (ragged
   rows, d = 2..64, equal keys, a lattice of exact distance ties); K1 also
   on row counts that are not multiples of a block's rows; K2 also on the
   128 x 128 lattice with three key levels and where every d2 overflows
   (coordinates near 1e19: (inf, -1)); K3, the worklist sweep, also
   against dense K1.  Median times of five runs after a warm-up (CUDA
   events) at 65,536 rows.
3. The dense path: ``DPCEngine(d_cut, rho_min=10).fit`` on the Airline
   proxy (d = 3) at n = 1,048,576, d_cut from the benchmarks' rule
   ``pick_dcut(target_rho=30)``.  The launch counts are zeroed just before
   the timed fit and read just after it; the inputs each kernel was given
   in that fit are kept.
4. Kernels vs plain at the dense path's shapes: K1 on the fit's full
   2^20 x 2^20 against the fit's rho, and on a 65,536-row slice against
   its plain version (the plain sweep over all rows took 145 s); K2 on the
   fit's unresolved cell maxima against all 2^20 rows, and on 45 and 5,724
   of the rows against all 2^20 (K2's column split) with the fit's keys,
   tied integer keys, -inf on 60 % of the columns and NaN keys.  Kernel
   times are medians of five CUDA-event runs after a warm-up; a plain time
   is its one comparison run, timed by CUDA events.
5. The dense fit against float64: rho on 4,096 random rows, and the parent
   and delta of every cell maximum (rules 2 and 3) against a float64 masked
   search over all n.
6. Block-sparse at 2^20: the worklist of the same input, grid-sorted; K3
   bit-equal to dense K1 on all 2^20 rows and to its plain version on 256
   row tiles spread over the table, with its entries and pairs per phase
   and entries per row tile (mean, p99, max); then
   the block-sparse fit (counted and timed as the dense one: K3 and K9 must
   launch, K1 and K2 must not), whose rho, rho_key and delta must equal
   the dense fit's, and whose parent and labels must equal them wherever
   no exact distance tie decides a parent; K9 on the fit's unresolved rows
   as in phase 8.
7. Ex-DPC and Scan at 2^20 (each fit counted and timed): Ex-DPC
   block-sparse bit-equal to Scan block-sparse, and equal to Ex-DPC dense
   as in phase 6; its rho equal to the Approx-DPC fit's; its delta and
   parent of 4,096 random rows against a float64 masked search; the rows
   each fit sent to its fallback (K9 on their best-1 ring block-sparse, K2
   dense) and the fallback's time on them, ring included, beside K2's.
8. The main path at full width: ``DPCEngine(d_cut, rho_min=10,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy at
   Airline's full n = 5,810,462, run twice and the second counted and
   timed (K3 and K9 must launch, K1 and K2 must not); rho on 4,096 random
   rows and parent/delta of 4,096 random cell maxima against float64; K3
   against its plain version and dense K1 on 256 row tiles spread over the
   table, against all columns, with its schedule as in phase 6; on the
   fit's unresolved cell maxima, K2 against its plain version on a slice,
   and K9 on their best-1 ring against dense K2 on all of them and its
   plain version on a few row tiles, with K2, K9 and the route (ring build
   and K9) timed side by side, the route decision, the entries K9's row
   walks computed, the longest walk and K9's bound (and the earlier
   count's); a traced fit for the phase times and each phase's peak device
   memory.
9. The stream's kernels vs plain at check shapes: K4 ``range_count``, K5
   ``range_count_signed`` and K6 ``gather_masked_nn`` bit for bit against
   their plain versions (Airline 65,536 with 4,096 query rows, a 512-row
   batch of mixed signs and 4,096 slots with padding slots and the global
   peak; mixtures n = 1,000 at d = 2, 4, 8; a 128 x 128 lattice of exact
   ties with three key levels); K6 also against K2 on the gathered rows,
   and in both of its forms (the one its shape picks and the other).
10. The stream main path, the workload of ``benchmarks/stream_bench.py``
   at the card's size: ``DPCEngine(2000.0, window_capacity=2**20,
   batch_cap=4096, exec_spec=ExecSpec(layout="block-sparse"))`` on
   ``gaussian_mixture(k=15, d=2, seed=0)``: ``fit`` on 2^20 points, a
   first ``partial_fit`` that seeds the window, one traced tick (phase
   times and peaks), 32 counted ticks (launch counts zeroed just before
   them and read just after; each tick must launch K4, K5 and K6; their
   inputs kept and each tick's kernels held against the plain versions
   on a slice, the last tick's K4/K5 on all rows and K6 on 2,048 slots;
   the form each tick's K6 took, and on the last tick both forms held
   against it, each timed with its layout and its scan apart, beside K2
   on the gathered rows and K6's bound with its earlier count),
   the final state against a from-scratch block-sparse fit of the window
   (rho, rho_key, delta bit for bit, parents up to counted exact ties),
   rho against float64 on 4,096 rows, re-queried maxima against a float64
   masked search, the full recompute's time, and ``predict`` on 65,536
   queries (stream points, far rows that must fall back to a center, NaN
   rows that must be quarantined; HIT labels against a float64 nearest
   window point on 1,024 of them).
11. The same on the Airline proxy, d_cut of phase 3, 8 counted ticks.
12. S-Approx-DPC's kernels at check shapes: the gated K1 and K3
   ``fused_sweep(nn_sel=...)`` bit for bit against their plain versions
   and gated K3 against gated K1 (the phase 2 cases and the lattice of
   exact ties; gates all ones, which must equal the ungated sweep, all
   zeros, 40 % at random, 5 columns, and the representatives at eps 0.8
   with their rows as the queries; K1 on ragged row counts); the gated
   K3's computed entries; K7 ``prefix_nn`` on each case's table sorted by
   descending key, bit for bit against its plain version and against K2
   with key -position.
13. S-Approx-DPC at full width, the slice's main path:
   ``DPCEngine(d_cut, algorithm="sapproxdpc", eps=0.8, rho_min=10,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy
   at n = 5,810,462, d_cut of phase 8, run twice and the second counted
   and timed (gated K3 and K9 must launch, ungated K1/K3, gated K1 and K2
   must not); every member's rho, parent and delta from its representative;
   rho on 4,096 random representatives against float64, and their
   phase-1/phase-2 delta and parent against a float64 masked search among
   the representatives; gated K3 against its plain version, the fit's own
   sweep and gated K1 on 256 row tiles; K9 on the rows the fit sent it
   beside K2, as in phase 8; a traced fit for the phase times and each
   phase's peak.
14. The eps sweep at 2^20 (paper Table 5, ``benchmarks/eps_sweep.py``'s
   eps 0.2, 0.4, 0.6, 0.8, 1.0): each block-sparse fit's time and its Rand
   index against phase 7's Ex-DPC labels (at least 0.9); at eps 0.8 the
   dense fit too (counted: gated K1 and K2 must launch), whose rho, rho_key
   and delta must equal the block-sparse fit's and whose parents must
   equal it up to counted exact ties; gated K1 on the dense fit's inputs
   against its plain version on 8,192 rows.
15. K7 at 2^20 through ``CudaBackend.prefix_nn`` (counts zeroed just
   before, read just after) on phase 7's Ex-DPC table sorted by
   descending ``rho_key``: its delta equal to the Ex-DPC fit's bit for bit
   and its parents up to counted exact distance ties, on every row whose
   nearest earlier row is strictly denser; the rows whose nearest earlier
   row has an equal f32 key are counted (there K7 may be nearer); against
   its plain version on the first 65,536 rows; its time and bound.

16. The distributed kernels at check shapes: K8 ``worklist_range_count``,
   K9 ``worklist_masked_nn``, K10 ``halo_range_count`` and K11
   ``halo_masked_nn`` bit for bit against their plain versions on the
   phase 2 cases (and the lattice of exact ties), each table split into
   three shards as `distributed_dpc` splits it (padded 1e9 rows, a
   shard whose row count is not a multiple of the tile); K8 against dense
   K4, K9 against dense K2, K10 with spans covering the whole window (and
   a reversed and a negative span) against K4, K11 so against K2 masked to
   d_cut; each shard's halo window assembled by the ppermute ring, its
   empty spans negative; the layouts K10/K15 (no key) and K11/K16 build
   on the card against their plain version, array for array; the entries
   K9's row walks computed.
17. Distributed Ex-DPC at full width: ``DPCEngine(d_cut, algorithm="exdpc",
   rho_min=10, mesh=ShardMesh.on("cuda", shards=4), strategy=...,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy at
   n = 5,810,462, d_cut of phase 8, strategies ``halo`` (K10, K11, then K9
   on the unresolved rows) and ``gather`` (K8, K9), each run twice and the
   second counted and timed; each equal to the single-device block-sparse
   Ex-DPC fit (measured here too) up to counted exact distance ties, and
   rho and delta/parent of 4,096 random rows against float64; a traced
   fit per strategy for the phase times and peaks, the halo window W, its
   hops and the rows the ring moves against the gather's, the unresolved
   rows; K8-K11 on every call of the counted runs timed, against their
   plain versions on a few row tiles or 65,536 rows, their bounds from
   their inputs (K11's key tests only in the column tiles whose largest
   key is above the row's, the earlier count beside it), K10's and K11's
   registers and spills and the rows per run of rows sharing their spans
   (one candidate cell's), K10's keyless layout timed alone, its pieces
   by form and its splits, and a count for a later PR: the share of the
   span columns in 32-column chunks whose bounding box lies beyond d_cut
   of their piece's rows' (``k10_skip_share``); for K9 on the gather's
   delta and on the halo
   fallback, the entries its row walks computed and the longest walk; the
   halo fit's steps outside its ``dist.*`` spans (the points to the
   card, ``point_span_bounds``, the spans' padding, ``_window_bounds``,
   the sharding) timed alone on its input.  The four shards are logical
   shards of one card.
18. The dense gather strategy at 2^20 (K4 and K2 per shard, four shards):
   counted (K4 and K2 must launch, K8-K11 must not), equal to phase 7's
   dense Ex-DPC up to counted exact ties, and against float64 on 4,096
   rows.

19. The bf16 kernels at check shapes: K12 ``fused_sweep(precision=
   "bf16")`` (over the wrapper's bf16 column records, its tensor-core
   accumulators kept in registers through the epilogue) and K13 (its
   worklist form), gated and not, on lattices (integers in [0, 256) times
   2^s at d = 2, 3, 8, 16, 17; in [0, 16) at d = 64; the 128 x 128 sites)
   bit for bit against their plain versions, K13 against K12 and K12
   against f32 K1, K12 also on ragged rows and columns and on fewer than 8
   columns; on unit-scale data within the
   stated tolerance d * 2^-20 * (|x|^2 + |y|^2) per pair, the differing
   rows counted; K14 ``local_density_delta(worklist=...)`` bit for bit
   against its plain version and dense K5 on phase 16's shard shapes;
   their times at 65,536 rows against K1, K3 and K5.  K13 reads K12's
   records on K3's walk, heaviest row tile first, and ends a walk at the
   first entry past the in-d_cut ones that no row needs.
20. bf16 at full width on exact data: the lattice of 2^20 points with
   integer coordinates in [0, 256)^3 (seed 0), d_cut = sqrt(30.5):
   ``DPCEngine(d_cut, rho_min=10, exec_spec=ExecSpec(precision="bf16",
   layout=...)).fit`` for Approx-DPC and S-Approx-DPC (eps 0.8), dense and
   block-sparse, and Ex-DPC block-sparse, each run twice and the second
   counted and timed (the bf16 sweep must launch, no f32 sweep may), each
   equal to its f32 fit bit for bit (rho, rho_key, delta, parent,
   labels), block-sparse equal to dense up to counted exact distance
   ties; K12 and gated K12 on the dense fits' full inputs against f32 K1
   and their plain versions on 65,536 rows, with their pairs/s, share of
   their bound, ratio to f32 K1's time, kept-list insertions per row
   (mean, max) and registers and spills; K13 and gated K13 on the
   block-sparse fits' inputs against f32 K3 and their plain versions on a
   few row tiles, each timed against its f32 form, with their registers
   and spills, entries computed (total, the largest per row tile), the
   row tiles whose walk ended past the split, pairs/s and share of their
   bound.
21. bf16 on the users' data: Approx-DPC, block-sparse, bf16, on the
   Airline proxy at n = 5,810,462, d_cut of phase 8, against the f32 fit
   of the same input (not gated: on domain-1e5 data the bf16 expanded form
   moves d2 by about 1e8, which is the reference's semantics): both
   timed, the rows whose rho differs, the Rand index of the labels, the
   centers of each; K13 against its plain version on a few row tiles
   within the tolerance, with its walk, pairs/s and share of bound as in
   phase 20; a traced fit.
22. K14 at the stream's shape: the Airline window of 2^20 and a delta
   batch of 8,192 (4,096 inserted, 4,096 evicted, signs +-1), both
   grid-sorted, through ``CudaBackend.range_count_delta(layout=
   "block-sparse")`` (counts zeroed just before, read just after: K14 must
   launch, K5 must not), equal to dense K5 bit for bit and to its plain
   version on a few row tiles; K14, its worklist build and K5 timed.

23. The halo primitives on a span-pruned worklist: K15
   ``worklist_halo_range_count`` (``halo_density(worklist=...)``) and K16
   ``worklist_halo_masked_nn`` (``halo_dependent(worklist=...)``) at
   check shapes bit for bit against their plain versions and against
   K10/K11 (phase 16's cases: three shards, ragged rows, each shard's halo
   window through the ppermute ring, negative empty spans plus a reversed
   and a negative span per row, the lattice of exact ties); then at full
   width on every shard input phase 17's counted halo fit gave K10/K11
   (Airline 5,810,462, 4 shards): ``CudaBackend.range_count_halo`` /
   ``denser_nn_halo(layout="block-sparse")`` with the counts zeroed just
   before and read just after (K15/K16 must launch, nothing else may),
   each result equal to K10/K11 bit for bit, K15/K16 against their plain
   versions on a few row tiles, the layouts of K10/K15 (no key) and
   K11/K16 built on the card against their plain version array for array
   (also at check shapes); K15, K16, their worklist builds, K15's keyless
   layout and K10/K11 timed, kept, in-cut and computed entries, K15's
   pieces by form and its splits, K16's longest walk, bounds from the
   inputs (K16's recounted on the entries each row needs, the earlier
   count on each row tile's block-wide walk beside it), K15's and K16's
   registers and spills and the rows per run.

24. The sharded Airline stream: ``StreamDPC(cfg, mesh=ShardMesh.on("cuda",
   shards=4))`` (window 2^20, batches of 4,096, d_cut of phase 3,
   rho_min 10, block-sparse), bulk-loaded by ``initialize`` on the first
   2^20 points, beside a single-device ``StreamDPC`` on the same points:
   equal on every tick (every ``StreamTick`` field, rho, rho_key, delta,
   parent, labels, centers), one traced tick each (the stages' times),
   AIR_TICKS counted ticks (the sharded tick's launch counts zeroed just
   before it and read just after: K4, K5 and K9 once a shard, no K2 or
   K6), each counted launch's inputs kept and held against the plain
   versions on a slice; on the last tick's shard inputs K4, K5, K9 on its
   ring, K9 as routed (the ring built) and dense K2 timed, K9 equal to K2;
   a checkpoint saved after the second-to-last counted tick and restored
   onto one device, whose next two ticks equal the sharded run's (file
   size, save and restore times); ``DPCEngine(2000.0, mesh=...,
   window_capacity=65_536)`` streaming the mixture, equal to the engine
   without a mesh (dense: K2 once a shard a tick).

25. The ``torch`` reference backend on the card (plain PyTorch, no
   kernel): on the 2^20 Airline proxy (d_cut of phase 3) Approx-DPC,
   Ex-DPC and S-Approx-DPC (eps 0.8) on the dense stencil route, and
   Approx-DPC and Ex-DPC block-sparse on the ring walk; distributed Ex-DPC
   on 4 logical shards, gather and halo, dense, at 2^18 Airline-proxy
   rows; the mixture stream (window 65,536, batches of 4,096, 8 counted
   ticks, dense).  Every fit must return CUDA tensors and is held against
   the ``cuda`` backend's fit of the same input in this run (the
   distributed fits against the single-device ``torch`` fit, the stream
   against the ``cuda`` stream on every tick): rho equal off the 4-ulp
   band around d_cut^2, delta to rtol 1e-6, parents equal except rows
   shown to be exact distance ties (counted), labels equal away from the
   rows downstream of them.  Prints each fit's time (the second fit,
   untraced, ending in a synchronize), its spans and unresolved rows
   from a traced fit, and its peak device memory, and asserts that no
   ``torch`` fit launched a kernel of the port.
26. The paper's two baselines on the card: LSH-DDP (M 4, L 3, seed 0;
   K10 and K11 over each round's bucket spans, the NN unbounded, K2 on the
   rows no bucket resolves) and CFSFDP-A (k 32; K10 over the windows of
   the k-means clusters its triangle filter keeps, K2 for delta) at 2^20
   Airline-proxy rows (d_cut of phase 3), on the ``cuda`` route: after a
   warm-up, a traced fit (per round the cap and the bucket count,
   LSH-DDP's unresolved rows, CFSFDP-A's pruned share of (row, cluster)
   pairs and its empty clusters), the timed fit (untraced, ending in a
   synchronize; launch counts zeroed just before it and read just after:
   K10, K11 and K2 must launch for LSH-DDP, K10 and K2 for CFSFDP-A,
   nothing else), its peak device memory, and each kernel wrapper's calls
   and CUDA-event ms in a third fit, with the bound of K10's and K2's
   work, each of its calls held bit for bit against its plain version on
   a slice of its rows at full window width (K10 and K11 on the rows of
   the longest spans, up to 65,536 rows and 2^31 span pairs; K2 on 2,048
   rows at even ranks of the key order); K10 on CFSFDP-A's spans with the
   rows in the order it hands them (rows with the same kept clusters
   together) against the cluster-sorted order; ``threefry.choice`` of the
   pivots on the card equal to the host's at 2^20; at 2^16 rows each held
   against the ``torch`` backend on the same CUDA tensors (rho off the
   band, delta rtol 1e-6, parents equal except counted exact ties).
27. The plan layer (``run_plan_layer``): on the 5.8M Airline proxy, block-
   sparse Approx-DPC, after ``plan_cache_clear()`` a cold fit (it builds
   and caches the K3 worklist, and builds the K9 ring, which is never
   cached) and a warm refit (no K3 build), twice, with the builds, hits
   and misses, the K3 worklist's fingerprint and lookup against its
   build, the ring's build, and the bytes the plan's cache holds; cold,
   warm and phase 8's fits equal bit for bit; a refit with one coordinate
   one ulp away misses and equals an uncached fit; the backend probe (K4
   once) passes and, forced through ``degrade.probe``, ``plan()`` raises;
   the warm fit's JSON-lines trace renders through ``python -m
   repro_torch.obs report`` in a subprocess.  The run asserts that every
   plan resolved to the backend it asked for.
28. The serving path: ``ServeEngine`` on gemma-2b at full width (18
   layers, d_model 2048, 8 heads, MQA, head_dim 256, d_ff 16384, vocab
   256,000) in bf16, random weights from a seeded generator on the card:
   8 prompts of 64-512 tokens (numpy seed 0) left-padded to 512, 32 new
   greedy tokens (shape and range checked; a second engine on the same
   weights gives the same tokens); prefill and decode timed from a traced
   ``generate``.  ``compress_prompt_cache`` with ``DPCKVConfig(budget=64)``
   on ``cuda``, counted (counts zeroed just before, read just after: K4
   and K2 once per (layer, sequence, kv-head), 144 each, nothing else):
   DPC-KV's shape of K4 and K2 is one 544-row problem (512 valid rows) at
   d = 4 per head, each with its own d_cut; every launch held bit for bit
   against its plain version; K4, K2 (all 144 calls, CUDA events) and the
   compression timed, with their bounds; the same card cache through
   ``ExecSpec(backend="torch")`` equal in d_cut, rho, ordered centers and
   counts on every head off the 4-ulp band around d_cut^2 (band heads
   counted), with no kernel launched; the attention error of the
   compressed cache against the full one per layer beside random
   eviction at the same budget (reported); the peak device memory; and
   gemma-2b's full width cut to 2 layers in f32: its prefill logits on the
   card within 1e-3 of the largest |logit| of the CPU's on the same
   weights, TF32 off.
29. Serving the moe, ssm and hybrid families at full width in bf16 with
   phase 28's traffic (random weights from a seeded generator on the
   card; each model freed before the next): granite-moe-3b-a800m (32
   layers, d_model 1536, 40 experts padded to 48, top-8), mamba2-130m (24
   layers, state 128, chunk 256), recurrentgemma-9b (38 layers = 12 x
   (rec, rec, attn) + 2 rec, d_model 4096, window 2048) and
   qwen3-moe-30b-a3b cut to 12 of its 48 layers (128 experts, head_dim
   128): parameters, init, prefill and decode times from a traced
   ``generate`` that launches no kernel of the port, a second engine's
   greedy tokens equal, the MoE prefill's share of top-k assignments
   dropped past capacity per layer, the cache's shapes, the peak device
   memory.  On granite-moe's prompt cache ``compress_prompt_cache`` with
   budget 64 as phase 28 runs it: 32 x 8 x 8 = 2,048 launches each of K4
   and K2 (counted; nothing else), every one bit for bit against its
   plain version, timed with their bounds, the ``torch`` route equal off
   the band.  Per family its full width cut to 2 layers in f32 (the
   hybrid 3, one superblock; the ssm's prompt 256, a chunk), prefill
   logits on the card within 1e-3 of the largest |logit| of the CPU's.
30. Training: ``launch.train`` (``run``, the body of ``main``) on
   gemma-2b at full width, bf16 parameters and f32 AdamW state, random
   init from torch generator seed 0, ``TokenPipeline(seed=0)``, 8 steps
   of 8 x 512 tokens, one microbatch; the same run checkpointing every 4
   steps, stopped right after its first checkpoint (35 GB; its save
   timed); a fresh run restored from it (timed) takes steps 5-8 and ends
   equal to the uninterrupted run bit for bit (its losses, and every
   leaf of (params, opt_state) against the first run's, kept in host
   memory); mamba2-130m at full width, the same traffic.  Each run's step time
   (median of steps 2-8, each ending in a synchronize), tokens/s, loss
   and gradient norm per step (all finite) and peak device memory; no
   kernel of the port launched; one more step of each run's final state
   under ``torch.profiler``: the device's busy time and idle share, the
   matrix products' time and the ops with the most device time.  One step of each family's full width
   cut to 2 layers in f32 (the hybrid 3; the vlm's 256 patches and 64
   text tokens, the ssm's 256 tokens): the loss on the card within
   1e-5 of the CPU's, relative, and every leaf's gradient within 1e-4 of
   its largest |g|, TF32 off.
31. The static analyzer on the card (``repro_torch.analysis``): the CLI
   sweep (``run_sweep(device="cuda:0")``) over every valid spec and its
   plan, distributed, stream and serve targets, with no finding at all and
   every rule run (targets, skips, kernels launched and each target's host
   syncs under
   ``torch.cuda.set_sync_debug_mode("warn")``); the kernel attribute table
   (``build.kernel_attrs``: every ``__global__`` instantiation's block,
   registers, static and dynamic shared memory, local bytes and
   occupancy), its registers and stack frames held equal to ptxas's log
   of phase 1's build, and ``analysis/limits.py`` held against
   ``torch.cuda.get_device_properties``; negative controls: a shared-memory
   budget (``REPRO_LIMIT_SMEM_BYTES``) one byte below K12's makes a fresh
   bf16 plan raise ``AnalysisError`` at ``plan()``, under
   ``REPRO_ANALYSIS=0`` the plan is made and ``analysis_findings_total``
   counts the finding, and a bf16 record stripped of its resolve makes R3
   fire; the fresh plan's ``telemetry()["memory"]`` built from the gate's
   own run (no launch), every kernel with its attributes; every kernel whose body merges through an atomic (K2, K3's pair
   counters, K4, K6 in both forms, K9, K10, K11, K12's insertion counters,
   K15, K16) and both halo layouts run twice on 65,536 Airline-proxy
   points, every output equal bit for bit; the four ``@audit_determinism``
   float sums run twice at phase 28's, 26's, 29's and 25's shapes, the
   elements that moved and the largest relative difference reported, and
   a CFSFDP-A fit of phase 26's points twice, its rho and parent equal bit
   for bit (what the k-means sums' audit claims); the gate's cold ``plan()`` per fresh spec (host clock ending in a
   synchronize) beside ``plan()`` with ``REPRO_ANALYSIS=suspend``.

Plans are memoized with their worklists: each phase that fits at 5.8M
(8, 13, 17, 21) prints the bytes all plans hold at its end and drops them
(``plan_bytes``).  A timed fit after a warm-up or traced fit of the same
input serves its worklists from the plan's cache, so it no longer
includes the K3 worklist's build; phase 27 gives the cold fit beside the
warm one.

Prints the card line and a ``{"kernels": [...]}`` line (K1 and K2's
launches from the dense path, K2's times on the main path's unresolved
rows, K3 and K9 from the main path, K4 and K5 from the mixture stream, K6
from the Airline stream, gated
K3 from phase 13, gated K1 from phase 14's dense fit, K7 from phase 15,
K8 from phase 17's gather fit, K10 and K11 from its halo fit, K12
and gated K12/K13 from phase 20's dense and S-Approx-DPC fits, K13 from
phase 21, K14 from phase 22, K15 and K16 from phase 23; K2, K10 and K11
also carry ``baselines``: per baseline, their launches in phase 26's timed
fit, their CUDA-event ms and bound there, and their plain versions' ms,
rows and max abs error on the checked slices; K4 and K2 carry ``dpc_kv``:
their shape, launches, ms, plain ms, bound and max abs error in phase 28's
compression of gemma-2b's prompt cache, 144 x (544 x 544, d 4)),
and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
where no CUDA device is present.  ``--out`` also writes the full record
(check-shape times, bounds, worklist statistics with K3's computed
entries, phase times and peaks) as JSON.  Bounds take f32 operations at
the card's lane issue rate (SMs x 128 x its maximum SM clock): the
kernels' direct differences do not contract into FMAs.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 rate
# and bf16 on the tensor cores.  The kernels' f32 work is direct differences
# that may not contract into FMAs, so its floor is one operation per f32
# lane per cycle: SMs x 128 lanes x the SM clock, 132 x 128 x 1980 MHz on
# the data sheet's part, and main() sets it from the card's own SM count
# and maximum clock (the data sheet's 67 TFLOP/s counts an FMA as two).
HBM_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128           # Hopper: 128 f32 lanes per SM
F32_ISSUE_PER_S = 132 * F32_LANES_PER_SM * 1980e6
BF16_TC_OPS_PER_S = 989e12       # bf16 on the tensor cores, dense

N_MAIN = 1 << 20                 # the dense path (quadratic)
N_FULL = 5_810_462               # Airline's size: the block-sparse main path
N_CHECK = 65536
Q_CHECK = 4096
K1_PLAIN_ROWS = 65536            # rows of the dense path's plain K1 check
K1_RAGGED_ROWS = (1, 127, 511, 513, 4103)   # not multiples of R x 128
K2_SPLIT_ROWS = (45, 5724)       # K2 query rows against 2^20 columns
TILES_CHECK = 256                # row tiles of the full path's K3 check
K2_PLAIN_ROWS = 2048             # rows of the full path's plain K2 check
REPS = 5

N_WINDOW = 1 << 20               # the stream phases' window
STREAM_BATCH = 4096              # points per stream tick
MIX_TICKS = 32                   # counted ticks of the mixture stream
AIR_TICKS = 8                    # counted ticks of the Airline stream
N_PREDICT = 65536                # predict's queries
N_FAR = N_NAN = 16               # of them: far outside coverage, and NaN
TICK_PLAIN_ROWS = 256            # rows of each counted tick's plain checks
K5_PLAIN_ROWS = 32768            # window rows of each tick's plain K5 check
K6_PLAIN_ROWS = 2048             # slots of the last tick's plain K6 check

SAPPROX_EPS = 0.8                # S-Approx-DPC's main path (paper default)
EPS_SWEEP = (0.2, 0.4, 0.6, 0.8, 1.0)   # benchmarks/eps_sweep.py
SEL_PLAIN_ROWS = 8192            # rows of the dense fit's plain gated K1
PREFIX_PLAIN_ROWS = 65536        # leading rows of K7's plain check at 2^20

DIST_SHARDS = 4                  # logical shards of the distributed phases
DIST_PLAIN_TILES = 4             # row tiles of K8/K9's plain checks at 5.8M
DIST_PLAIN_ROWS = 65536          # shard rows of K10/K11's plain checks

BF16_FULL_REPS = 3               # timed runs of K12 and K1 at 2^20 x 2^20

SHARDED_PLAIN_TILES = 2          # row tiles of each sharded K9's plain check
ENGINE_WINDOW = 65536            # phase 24's mesh engine: its window
ENGINE_TICKS = 4                 # and its counted ticks
REF_DIST_N = 1 << 18             # phase 25: the torch distributed fits
REF_WINDOW = 65536               # phase 25: the torch stream's window
REF_TICKS = 8                    # and its counted ticks
BASE_N = 1 << 20                 # phase 26: the baselines' timed fits
BASE_PARITY_N = 1 << 16          # and their torch-backend parity
BASE_PLAIN_PAIRS = 1 << 31       # span pairs of their K10/K11 plain checks
ANALYZER_N = 1 << 16             # phase 31: the atomic kernels' rerun input
WOBBLE_KMEANS_N = 1 << 20        # and the float sums': CFSFDP-A's k-means
SERVE_ARCH = "gemma-2b"          # phase 28: the served model, full width
SERVE_BATCH = 8                  # its batch,
SERVE_PROMPT = 512               # prompt slots (prompts of 64-512 tokens),
SERVE_NEW = 32                   # new tokens
SERVE_BUDGET = 64                # and DPC-KV's kept pairs a head
SERVE_CHECK_LAYERS = 2           # the f32 card-vs-CPU check's depth
SERVE_CHECK_PROMPT = 64          # and its prompt length
FAMILY_ARCHS = ("granite-moe-3b-a800m", "mamba2-130m", "recurrentgemma-9b",
                "qwen3-moe-30b-a3b")   # phase 29: served at full width,
FAMILY_DEPTH = {"qwen3-moe-30b-a3b": 12}  # qwen3-moe cut to 12 of 48 layers
FAMILY_DPC_KV = "granite-moe-3b-a800m"    # DPC-KV on its prompt cache
FAMILY_REPS = 3                  # timed runs of its compression, K4 and K2
# per family, the f32 card-vs-CPU check's (layers, prompt): the ssm's
# prompt a multiple of its chunk of 256, the hybrid's 3 layers one
# (rec, rec, attn) superblock
FAMILY_CHECK = {"granite-moe-3b-a800m": (2, 64), "mamba2-130m": (2, 256),
                "recurrentgemma-9b": (3, 64)}
TRAIN_ARCH = "gemma-2b"          # phase 30: trained at full width,
TRAIN_SSM = "mamba2-130m"        # and the ssm family's backward,
TRAIN_BATCH = 8                  # batch,
TRAIN_SEQ = 512                  # tokens a sequence,
TRAIN_STEPS = 8                  # steps,
TRAIN_CKPT_EVERY = 4             # a checkpoint after the 4th (and the 8th)
# per family, the f32 card-vs-CPU step's (layers, sequence) at full width:
# the ssm's a chunk, the hybrid's one superblock, the vlm's 256 patches
# and 64 text tokens
TRAIN_CHECK = {"gemma-2b": (2, 64), "paligemma-3b": (2, 320),
               "hubert-xlarge": (2, 64), "granite-moe-3b-a800m": (2, 64),
               "mamba2-130m": (2, 256), "recurrentgemma-9b": (3, 64)}


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn):
    """(result, ms) of one run, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or f32
    operations over the lane issue rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_ISSUE_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def k1_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of fused_count_topk: each input read once,
    each output written once; 3d+1 operations per pair."""
    nbytes = 4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
    return nbytes, float(n) * m * (3 * d + 1)


def k3_needed_pairs(wl, m: int, topv: torch.Tensor) -> int:
    """The pairs the worklist sweep needs on this run's data, from its
    inputs and its (checked) answer: per row, the real columns of its
    in-d_cut entries and of the entries whose lb is at most the row's final
    8th d2 (``topv[:, 7]``), which no exact pruning can skip.  A row tile's
    entries are in ascending lb, so the second set is a prefix of its
    segment, found by a search on (row tile, lb's bits: lb >= 0)."""
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    n = topv.shape[0]
    dev = topv.device
    width = (m - wl.col_tile.long() * BLOCK_M).clamp(max=BLOCK_M)
    cum_all = torch.zeros(wl.n_kept + 1, dtype=torch.int64, device=dev)
    cum_cut = torch.zeros_like(cum_all)
    cum_all[1:] = torch.cumsum(width, 0)
    cum_cut[1:] = torch.cumsum(width * wl.in_cut, 0)
    key = (wl.row_tile() << 32) | wl.lb.view(torch.int32).long()
    tile = torch.arange(n, device=dev) // BLOCK_N
    tau = topv[:, -1].contiguous().view(torch.int32).long()
    p = torch.searchsorted(key, (tile << 32) | tau, right=True)
    ptr = wl.row_ptr.long()
    start, end = ptr[tile], ptr[tile + 1]
    return int((cum_all[p] - cum_all[start] + cum_cut[end] - cum_cut[p])
               .sum())


def k3_work(x, y, wl, needed: int, sel=None) -> tuple[float, float]:
    """Bytes and operations of worklist_count_topk on this run's data: the
    inputs and the worklist read once, the outputs written once, the
    wrapper's record pack (kernels/packing.py: y's records, and gated the
    selected columns' with each column tile's range, each written once and
    read once; the split and the tile order); 3d+1 operations per pair it
    needs (``needed``, from ``k3_needed_pairs``)."""
    from repro_torch.kernels.packing import record_width
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    rec = 2 * 4 * record_width(d)
    nbytes = (4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
              + 4 * wl.row_ptr.numel() + 9 * wl.n_kept
              + m * rec + 2 * 4 * wl.num_row_tiles)
    if sel is not None:
        nbytes += m + int(sel.sum()) * rec + 4 * (-(-m // 512) + 1)
    return nbytes, float(needed) * (3 * d + 1)


def k3_schedule(x, y, d_cut, wl, sel=None) -> dict:
    """K3's schedule on these inputs (a separate launch): entries computed
    per phase, the spread of entries per row tile, and the pairs each
    phase ran (phase 1: all 256 rows of a tile; phase 2: the rows that
    took each chunk)."""
    from repro_torch.kernels import ops, packing
    dev = x.device
    nbr = wl.num_row_tiles
    live = torch.zeros(nbr, dtype=torch.int32, device=dev)
    ran = torch.zeros((nbr, 2), dtype=torch.int64, device=dev)
    gate = {} if sel is None else {"nn_sel": sel}
    ops.fused_sweep(x, y, d_cut, worklist=wl, live=live, ran=ran, **gate)
    ph1 = int((packing.phase_split(wl).long() - wl.row_ptr[:-1].long())
              .sum())
    lv = live.double().cpu()
    return {"live": int(live.sum()), "phase1_entries": ph1,
            "phase2_entries": int(live.sum()) - ph1,
            "live_per_tile": {"mean": float(lv.mean()),
                              "p99": float(torch.quantile(lv, 0.99)),
                              "max": int(lv.max())},
            "phase1_pairs": int(ran[:, 0].sum()),
            "phase2_pairs": int(ran[:, 1].sum())}


def k3_schedule_line(sch: dict, needed: int) -> str:
    lt = sch["live_per_tile"]
    return (f"{sch['phase1_entries']} + {sch['phase2_entries']} entries "
            f"computed (phases 1 + 2; per row tile mean {lt['mean']:.1f}, "
            f"p99 {lt['p99']:.0f}, max {lt['max']}), pairs run "
            f"{sch['phase1_pairs']} + {sch['phase2_pairs']}, {needed} "
            f"needed")


def k2_work(x_key, y_key, d: int) -> tuple[float, float]:
    """Bytes and operations of masked_nn on these keys, as its schedule
    must do them: 3d+1 operations for each pair whose column is denser
    (the key-sorted prefix leaves no key test); the inputs read once, the
    outputs written once, and the sort and pack of the columns (keys
    sorted with their indices, rows gathered into records) and of the
    rows."""
    from repro_torch.kernels.packing import record_width
    n, m = x_key.numel(), y_key.numel()
    # counted apart from the wrapper's own key order: #{j : y_key[j] >
    # x_key[i]}, where a NaN key is never greater and nothing exceeds one
    neg_inf = torch.tensor(float("-inf"), device=y_key.device)
    ys = torch.sort(torch.where(torch.isnan(y_key), neg_inf, y_key)).values
    above = m - torch.searchsorted(ys, x_key, right=True)
    denser = float(torch.where(torch.isnan(x_key), 0, above).sum())
    nbytes = (4 * (n * d + n + m * d + m) + 8 * n
              + 16 * m + 4 * m * (d + record_width(d)) + 16 * n
              + 4 * n * (2 * d + 1))
    return nbytes, denser * (3 * d + 1)


def check_equal(name: str, got, want, what: str = "its plain version"):
    """Bit-equality of every output; returns the max abs error of the
    finite float outputs (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w) & ~(torch.isnan(g) & torch.isnan(w)) \
                if g.is_floating_point() else g != w
            raise AssertionError(f"{name}: kernel differs from {what} on "
                                 f"{int(bad.sum())} entries")
        if g.is_floating_point():
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


def sub_worklist(wl, tiles: torch.Tensor):
    """The entries of the row tiles ``tiles`` (ascending), as a worklist of
    len(tiles) row tiles over the same columns."""
    from repro_torch.kernels.blocksparse import Worklist
    ptr = wl.row_ptr.long()
    starts, counts = ptr[tiles], ptr[tiles + 1] - ptr[tiles]
    new_ptr = torch.zeros(tiles.numel() + 1, dtype=torch.int64,
                          device=ptr.device)
    new_ptr[1:] = torch.cumsum(counts, 0)
    idx = (torch.repeat_interleave(starts - new_ptr[:-1], counts)
           + torch.arange(int(new_ptr[-1]), device=ptr.device))
    nbc = wl.n_total // wl.num_row_tiles
    return Worklist(row_ptr=new_ptr.to(torch.int32), col_tile=wl.col_tile[idx],
                    in_cut=wl.in_cut[idx], lb=wl.lb[idx],
                    n_kept=int(new_ptr[-1]), n_total=tiles.numel() * nbc)


def downstream(parent: torch.Tensor, mark: torch.Tensor) -> torch.Tensor:
    """Rows whose parent chain (themselves included) passes a marked row."""
    n = parent.numel()
    ar = torch.arange(n, device=parent.device)
    p = torch.where(parent >= 0, parent.long(), ar)
    mark = mark.clone()
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mark |= mark[p]
        p = p[p]
    return mark


def float64_rho_check(pts64, rho, thr: float, rows) -> tuple[int, int]:
    """rho of ``rows`` against a float64 count, off a 4-ulp band around
    d_cut^2; returns (rows checked, rows with no pair in the band)."""
    band = 4 * float(np.spacing(np.float32(thr)))
    lo = torch.empty(rows.numel(), dtype=torch.int64, device=rows.device)
    hi = torch.empty_like(lo)
    step = max(1, (1 << 26) // pts64.shape[0])
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - pts64[None]) ** 2).sum(-1)
        lo[r0:r0 + step] = (d2 < thr - band).sum(1)
        hi[r0:r0 + step] = (d2 < thr + band).sum(1)
    got = rho[rows].to(torch.int64)
    off = int(((got < lo) | (got > hi)).sum())
    assert off == 0, \
        f"rho off the float64 count on {off} of {rows.numel()} rows"
    return rows.numel(), int((lo == hi).sum())


def float64_dependent_check(pts64, res, rows, d_cut: float | None) -> int:
    """Parent and delta of ``rows`` against a float64 masked search over
    all n: the parent is a nearest strictly-denser point ((inf, -1) at the
    peak) and the delta its distance (Ex-DPC: ``d_cut`` None) or, for
    Approx-DPC's cell maxima, d_cut where that point is within d_cut
    (rule 2) and its distance beyond (rule 3).  Returns the number of
    rule-2 rows."""
    dc32 = float(np.float32(d_cut if d_cut is not None else 0.0))
    key64 = res.rho_key.to(torch.float64)
    n_rule2 = 0
    step = max(1, (1 << 25) // pts64.shape[0])
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - pts64[None]) ** 2).sum(-1)
        d2 = torch.where(key64[None, :] > key64[rr, None], d2, float("inf"))
        best = d2.min(1).values
        par, dl = res.parent[rr].long(), res.delta[rr]
        peak = torch.isinf(best)
        assert bool((par[peak] == -1).all() and torch.isinf(dl[peak]).all()), \
            "a row with no denser point must get (inf, -1)"
        got = d2.gather(1, par.clamp_min(0)[:, None])[:, 0]
        assert bool((got[~peak] <= best[~peak] * (1 + 1e-6)).all()), \
            "a cell maximum's parent is not its nearest strictly-denser point"
        rule2 = ~peak & (best.sqrt() < dc32 * (1 - 1e-6))
        rule3 = ~peak & (best.sqrt() > dc32 * (1 + 1e-6))
        if d_cut is None:
            rule2, rule3 = peak & False, ~peak
        assert bool((dl[rule2] == dc32).all()), \
            "a cell maximum with a denser point within d_cut must get d_cut"
        torch.testing.assert_close(dl[rule3].double(), best[rule3].sqrt(),
                                   rtol=1e-6, atol=0)
        n_rule2 += int(rule2.sum())
    return n_rule2


def same_up_to_ties(x, a, b, lab_a, lab_b, what: str):
    """Two fits of the table ``x`` that may decide exact distance ties
    apart: rho, rho_key and delta equal bit for bit, parents equal except
    where both are equally near, labels equal away from the rows downstream
    of such a parent.  Returns (tied parents, rows downstream of them,
    labels that differ)."""
    from repro_torch.kernels.sweep import direct_d2
    for name in ("rho", "rho_key", "delta"):
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{what}: {name} differs"
    differ = a.parent != b.parent
    rows = torch.nonzero(differ).flatten()
    pa, pb = a.parent[rows].long(), b.parent[rows].long()
    assert bool((pa >= 0).all() and (pb >= 0).all() and torch.equal(
        direct_d2(x[rows], x[pa]), direct_d2(x[rows], x[pb]))), \
        f"{what}: a parent differs without a tie"
    tied = downstream(a.parent, differ) | downstream(b.parent, differ)
    assert torch.equal(lab_a[~tied], lab_b[~tied]), \
        f"{what}: labels differ away from tie-decided parents"
    return rows.numel(), int(tied.sum()), int((lab_a != lab_b).sum())


def k4_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of range_count: x and y read once, the counts
    written once; 3d+1 operations per pair."""
    return 4 * (n * d + m * d) + 4 * n, float(n) * m * (3 * d + 1)


def k5_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of range_count_signed: x, the batch and its
    signs read once, the sums written once; 3d+1 operations per pair."""
    return 4 * (n * d + m * d + m) + 4 * n, float(n) * m * (3 * d + 1)


def k6_work(keys, slots, d: int) -> tuple[float, float, dict]:
    """Bytes and operations of gather_masked_nn on these keys and slots,
    counted as K2's (``k2_work``) on the gathered rows: 3d+1 operations
    for each pair of a live slot and a strictly denser column, no key test
    (the prefix form tests none); the table, its keys and the slots read
    once, (d2, parent) written once, and the sort and pack of the columns
    and the rows.  ``info`` holds the earlier count, a key
    test for every pair of a live slot and a column plus 3d+1 for each
    denser one, with the table, keys and slots as its only bytes."""
    from repro_torch.kernels.packing import gather_rows
    m, q = keys.numel(), slots.numel()
    _, x_key = gather_rows(keys, slots)
    nbytes, ops = k2_work(x_key, keys, d)
    nbytes += 8 * q                       # the slots, as int64
    live = int(((slots >= 0) & (slots < m)).sum())
    old = (4 * (m * d + m) + 8 * q + 8 * q,
           float(live) * m + ops)
    b_ms, by = bound_ms(*old)
    return nbytes, ops, {"earlier_bytes": old[0], "earlier_ops": old[1],
                         "earlier_bound_ms": b_ms}


def stream_kernels():
    """K4, K5, K6 and their plain versions, as the checks call them."""
    from repro_torch.kernels import ops, sweep

    def k4(x, y, d_cut):
        return ops.local_density_xy(x, y, d_cut)

    def k4_plain(x, y, d_cut):
        return sweep.range_count_plain(x, y, sweep.d2cut_of(d_cut)).float()

    def k5(x, y, signs, d_cut):
        return ops.local_density_delta(x, y, signs, d_cut)

    def k5_plain(x, y, signs, d_cut):
        return sweep.range_count_signed_plain(x, y, signs,
                                              sweep.d2cut_of(d_cut))

    def k6(table, keys, slots):
        return ops.dependent_masked_gather(table, keys, slots)

    def k6_plain(table, keys, slots):
        best, arg = sweep.gather_masked_nn_plain(table, keys, slots)
        return torch.sqrt(best), arg

    return k4, k4_plain, k5, k5_plain, k6, k6_plain


def k6_forms(table, keys, slots, want) -> dict:
    """Both of K6's forms on one call's inputs: each held bit for bit
    against ``want`` (the wrapper's answer), its time, and its layout
    (gather, sort and pack) and scan (the launch on a built layout)
    timed apart."""
    from repro_torch.kernels import ops
    d = table.shape[1]
    parts = {}
    for form in ("key", "prefix"):
        lay = ops.gather_layout(table, keys, slots, form)
        best, arg = ops.gather_scan(lay, d)
        check_equal(f"gather_masked_nn, {form} form", [torch.sqrt(best), arg],
                    want, "the wrapper's form")
        parts[form] = {
            "ms": time_ms(lambda: ops.gather_scan(
                ops.gather_layout(table, keys, slots, form), d)),
            "layout_ms": time_ms(
                lambda: ops.gather_layout(table, keys, slots, form)),
            "scan_ms": time_ms(lambda: ops.gather_scan(lay, d))}
        del lay
    return parts


def stream_check_shapes(cases, card: str) -> dict:
    """K4/K5/K6 bit for bit against their plain versions at check shapes:
    K4 on up to 4,096 rows against all, K5 on all rows against a 512-row
    batch of mixed signs, K6 on up to 4,096 slots (the global peak among
    them, padding slots past and before the table at the end); K6 also
    against K2 on the gathered rows.  Times on the first case."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.kernels import ops
    k4, k4_plain, k5, k5_plain, k6, k6_plain = stream_kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    times = {}
    for label, pts, dc, tie_keys in cases:
        x = torch.from_numpy(pts).to(dev)
        n = len(pts)
        q = x[:min(Q_CHECK, n)].contiguous()
        check_equal(f"range_count [{label}]", [k4(q, x, dc)],
                    [k4_plain(q, x, dc)])
        batch = x[torch.from_numpy(rng.permutation(n)[:512]).to(dev)]
        signs = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], len(batch))
                                 .astype(np.float32)).to(dev)
        check_equal(f"range_count_signed [{label}]", [k5(x, batch, signs, dc)],
                    [k5_plain(x, batch, signs, dc)])
        if tie_keys:        # a few key levels: many exact distance ties
            keys = torch.from_numpy((np.arange(n) % 3).astype(np.float32))
            keys = keys.to(dev)
        else:
            keys = k4(x, x, dc) + density_jitter(n, dev)
        real = np.concatenate([[int(torch.argmax(keys))],
                               rng.permutation(n)[:min(Q_CHECK, n) - 1]])
        pad = [n, n + 7, -1, 2**40]
        slots = torch.from_numpy(np.concatenate([real, pad]).astype(
            np.int64)).to(dev)
        got = k6(x, keys, slots)
        check_equal(f"gather_masked_nn [{label}]", got,
                    k6_plain(x, keys, slots))
        rows = slots[:len(real)]
        check_equal(f"gather_masked_nn [{label}]",
                    [t[:len(real)] for t in got],
                    ops.dependent_masked(x[rows], keys[rows].contiguous(), x,
                                         keys), "masked_nn on the rows")
        for form in ("key", "prefix"):    # the form not picked, too
            best, arg = ops.gather_scan(
                ops.gather_layout(x, keys, slots, form), pts.shape[1])
            check_equal(f"gather_masked_nn [{label}, {form} form]",
                        [torch.sqrt(best), arg], got, "the wrapper's form")
        none = int((got[1][:len(real)] == -1).sum())
        assert none >= 1 and bool((got[1][len(real):] == -1).all()), \
            f"gather_masked_nn [{label}]: peak or padding slots not (inf, -1)"
        print(f"range_count, range_count_signed, gather_masked_nn == plain, "
              f"bit for bit: {label}, n={n} d={pts.shape[1]} ({none} slots "
              f"with no denser row, {len(pad)} padding slots; "
              f"gather_masked_nn == masked_nn on the gathered rows, its "
              f"{ops.gather_form(slots.numel())} form taken, both forms "
              f"equal)", flush=True)
        if not times:
            times = {
                "range_count": {
                    "shape": f"{q.shape[0]} x {n}, d={pts.shape[1]}",
                    "ms": time_ms(lambda: k4(q, x, dc)),
                    "plain_ms": time_ms(lambda: k4_plain(q, x, dc))},
                "range_count_signed": {
                    "shape": f"{n} x {len(batch)}, d={pts.shape[1]}",
                    "ms": time_ms(lambda: k5(x, batch, signs, dc)),
                    "plain_ms": time_ms(lambda: k5_plain(x, batch, signs,
                                                         dc))},
                "gather_masked_nn": {
                    "shape": f"{slots.numel()} slots x {n}, "
                             f"d={pts.shape[1]}",
                    "ms": time_ms(lambda: k6(x, keys, slots)),
                    "plain_ms": time_ms(lambda: k6_plain(x, keys, slots))}}
            for name, t in times.items():
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    return times


def run_stream(label: str, pts: np.ndarray, d_cut: float, ticks: int,
               card: str) -> dict:
    """The stream main path: ``fit`` on the first N_WINDOW points seeds
    the window at the first ``partial_fit``; one traced tick; then
    ``ticks`` counted ticks of STREAM_BATCH points, whose kernel inputs are
    kept; then the checks and ``predict``.  Returns the record, with each
    kernel's launches, times and bound at this stream's shapes."""
    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.kernels import ops, sweep
    from repro_torch.resilience.sanitize import AdmissionConfig
    from repro_torch.stream import QueryStatus, incremental
    k4, k4_plain, k5, k5_plain, k6, k6_plain = stream_kernels()
    dev = torch.device("cuda")
    n, B, d = N_WINDOW, STREAM_BATCH, pts.shape[1]
    batches = [pts[n + i * B:n + (i + 1) * B] for i in range(ticks + 2)]
    spec = ExecSpec(layout="block-sparse")
    eng = DPCEngine(d_cut, rho_min=10, window_capacity=n, batch_cap=B,
                    exec_spec=spec, admission=AdmissionConfig(policy="drop"))
    t0 = time.perf_counter()
    eng.fit(pts[:n])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.partial_fit(batches[0])       # seeds the window: a full recompute,
    torch.cuda.synchronize()          # then a tick re-querying all maxima
    seed_s = time.perf_counter() - t0
    s = eng.stream
    seeded = s.stats()

    # one traced tick: phase times and each phase's peak device memory
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    obs.configure("trace")
    obs.reset_spans()
    try:
        eng.partial_fit(batches[1])
    finally:
        obs.configure("off")
    phases: dict[str, float] = {}
    peaks: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
        peaks[sp["name"]] = max(peaks.get(sp["name"], 0.0),
                                sp.get("peak_bytes", 0) / 1e9)

    # the counted ticks: counts zeroed just before, read just after; each
    # kernel's inputs kept (the window table is updated in place, so the
    # inputs hold a clone of it per tick)
    names = ("range_count", "range_count_signed", "gather_masked_nn")
    given: dict[str, list] = {k: [] for k in names}
    launch = (ops.local_density_xy, ops.local_density_delta,
              ops.dependent_masked_gather)
    frozen: dict = {}

    def keep(t):
        if t.data_ptr() == s.window.device.data_ptr():
            return frozen.setdefault("window", t.clone())
        return t

    def rec_k4(x, y, dc):
        given["range_count"].append((x, keep(y), dc))
        return launch[0](x, y, dc)

    def rec_k5(x, y, signs, dc):
        given["range_count_signed"].append((keep(x), y, signs, dc))
        return launch[1](x, y, signs, dc)

    def rec_k6(table, keys, slots):
        given["gather_masked_nn"].append((keep(table), keys, slots))
        return launch[2](table, keys, slots)

    # dirty_near's inputs on the last counted tick: the cell maxima's
    # coords and the cells the batch touched, for timing its two routes
    near_in: dict = {}
    near_fn = incremental.IncrementalGrid.dirty_near

    def rec_near(grid, coords, rc):
        near_in.update(coords=coords, rc=rc, touched=grid.last_touched)
        return near_fn(grid, coords, rc)

    per_tick = []
    (ops.local_density_xy, ops.local_density_delta,
     ops.dependent_masked_gather) = rec_k4, rec_k5, rec_k6
    incremental.IncrementalGrid.dirty_near = rec_near
    try:
        ops.reset_launch_counts()
        for i in range(2, ticks + 2):
            frozen.clear()
            before = s.stats()
            seen = {k: len(v) for k, v in given.items()}
            t0 = time.perf_counter()
            tick = eng.partial_fit(batches[i])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = s.stats()
            for k in names:
                assert len(given[k]) > seen[k], \
                    f"{label}: tick {i} never launched {k}"
            per_tick.append({
                "ms": 1e3 * dt, "rebuilt": bool(tick.rebuilt),
                "maxima": after["nn_maxima_total"] - before["nn_maxima_total"],
                "queried": after["nn_queries"] - before["nn_queries"],
                "live_cells": after["live_cells"]})
        launches = ops.launch_counts()
    finally:
        (ops.local_density_xy, ops.local_density_delta,
         ops.dependent_masked_gather) = launch
        incremental.IncrementalGrid.dirty_near = near_fn
    for k in names:
        assert launches[k] == len(given[k]) >= ticks, (k, launches[k])
    forms6 = "/".join(sorted({ops.gather_form(s6.numel())
                              for t6, _, s6 in given["gather_masked_nn"]}))
    median_ms = statistics.median(t["ms"] for t in per_tick)
    print(f"{label} stream: window {n}, d={d}, d_cut={d_cut!r}, {ticks} "
          f"ticks of {B}: median tick {median_ms:.2f} ms (first tick after "
          f"the seeding fit {1e3 * seed_s:.1f} ms with the full recompute; "
          f"fit {1e3 * fit_s:.1f} ms); launches {launches}  ({card})",
          flush=True)
    print(f"  maxima re-queried/total per tick "
          f"{[(t['queried'], t['maxima']) for t in per_tick]}; live cells "
          f"{per_tick[-1]['live_cells']}; rebuilds "
          f"{sum(t['rebuilt'] for t in per_tick)}", flush=True)
    for name in ("engine.partial_fit", "stream.snapshot", "stream.tick",
                 "stream.push", "stream.grid_apply", "stream.rho_repair",
                 "stream.maxima", "stream.nn_update", "stream.assemble",
                 "labels.assign", "stream.continuity"):
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms, peak "
              f"{peaks.get(name, 0.0):.3f} GB")
    print(f"  traced tick: {held_gb:.3f} GB held before it", flush=True)

    # each counted tick's kernels against their plain versions on a slice;
    # the last tick's in full (K6: its first K6_PLAIN_ROWS slots)
    r = TICK_PLAIN_ROWS
    for i, ((x4, y4, c4), (x5, y5, s5, c5), (t6, k6k, s6)) in enumerate(zip(
            given["range_count"], given["range_count_signed"],
            given["gather_masked_nn"])):
        check_equal(f"range_count [{label} tick {i}]", [k4(x4[:r], y4, c4)],
                    [k4_plain(x4[:r], y4, c4)])
        xs = x5[:K5_PLAIN_ROWS]
        check_equal(f"range_count_signed [{label} tick {i}]",
                    [k5(xs, y5, s5, c5)], [k5_plain(xs, y5, s5, c5)])
        check_equal(f"gather_masked_nn [{label} tick {i}]",
                    k6(t6, k6k, s6[:r]), k6_plain(t6, k6k, s6[:r]))
    (x4, y4, c4), = given["range_count"][-1:]
    (x5, y5, s5, c5), = given["range_count_signed"][-1:]
    (t6, k6k, s6), = given["gather_masked_nn"][-1:]
    errs, times, bounds = {}, {}, {}
    want, p4 = timed_once(lambda: k4_plain(x4, y4, c4))
    errs["range_count"] = check_equal(f"range_count [{label} last tick]",
                                      [k4(x4, y4, c4)], [want])
    want, p5 = timed_once(lambda: k5_plain(x5, y5, s5, c5))
    errs["range_count_signed"] = check_equal(
        f"range_count_signed [{label} last tick]", [k5(x5, y5, s5, c5)],
        [want])
    sl = s6[:K6_PLAIN_ROWS]
    want, p6 = timed_once(lambda: k6_plain(t6, k6k, sl))
    errs["gather_masked_nn"] = check_equal(
        f"gather_masked_nn [{label} last tick]",
        [v[:sl.numel()] for v in k6(t6, k6k, s6)], want)
    times["range_count"] = {"ms": time_ms(lambda: k4(x4, y4, c4)),
                            "plain_ms": p4, "shape": f"{x4.shape[0]} x "
                            f"{y4.shape[0]}"}
    times["range_count_signed"] = {
        "ms": time_ms(lambda: k5(x5, y5, s5, c5)), "plain_ms": p5,
        "shape": f"{x5.shape[0]} x {y5.shape[0]}"}
    rows6 = t6[s6]
    times["gather_masked_nn"] = {
        "ms": time_ms(lambda: k6(t6, k6k, s6)), "plain_ms": p6,
        "plain_rows": sl.numel(),
        "shape": f"{s6.numel()} slots x {t6.shape[0]}",
        # K2 on the same rows, gathered, through its own wrapper
        "masked_nn_ms": time_ms(lambda: ops.dependent_masked(
            rows6, k6k[s6].contiguous(), t6, k6k)),
        "form": ops.gather_form(s6.numel()),
        "forms": forms6, "parts": k6_forms(t6, k6k, s6, k6(t6, k6k, s6))}
    bounds["range_count"] = k4_work(x4.shape[0], y4.shape[0], d)
    bounds["range_count_signed"] = k5_work(x5.shape[0], y5.shape[0], d)
    nb6, ops6, k6_info = k6_work(k6k, s6, d)
    bounds["gather_masked_nn"] = (nb6, ops6)
    times["gather_masked_nn"].update(k6_info)
    kernels = {}
    for k in names:
        b_ms, by = bound_ms(*bounds[k])
        kernels[k] = {**times[k], "launches": launches[k],
                      "launches_per_tick": launches[k] / ticks,
                      "max_abs_err": errs[k], "bound_ms": b_ms,
                      "bound_by": by}
        print(f"  {k} [{times[k]['shape']}]: kernel {times[k]['ms']:.3f} ms, "
              f"bound {b_ms:.3f} ms ({by}), plain {times[k]['plain_ms']:.1f} "
              f"ms{' on ' + str(sl.numel()) + ' slots' if k == names[2] else ''}"
              f", {launches[k] / ticks:.2f} launches per tick  ({card})",
              flush=True)
    t = times["gather_masked_nn"]
    print(f"  gather_masked_nn: the counted calls took the {forms6} form; "
          f"earlier bound {t['earlier_bound_ms']:.3f} ms (a key test a pair); "
          f"masked_nn on the same {s6.numel()} rows, gathered: "
          f"{t['masked_nn_ms']:.3f} ms  ({card})", flush=True)
    for form, part in t["parts"].items():
        taken = " (taken)" if form == t["form"] else ""
        print(f"  gather_masked_nn, {form} form{taken} on the last tick: "
              f"{part['ms']:.3f} ms, of which the layout "
              f"{part['layout_ms']:.3f} ms and the scan {part['scan_ms']:.3f} "
              f"ms; == the counted path bit for bit  ({card})", flush=True)
    print(f"  every counted tick: the three kernels == plain, bit for bit, "
          f"on {r} rows ({K5_PLAIN_ROWS} window rows for K5); the last tick's "
          f"K4 and K5 on all rows, K6 on {sl.numel()} slots", flush=True)
    del given, frozen

    # dirty_near's two routes on the last tick's maxima and touched cells:
    # dilated touched-cell keys looked up in a sorted set, and chunked
    # Chebyshev differences (the only route where (2 rc + 1)^d is large)
    near_rec = None
    if near_in.get("touched") is not None:
        q = torch.as_tensor(near_in["coords"], dtype=torch.int64, device=dev)
        t = torch.unique(torch.from_numpy(near_in["touched"].astype(
            np.int64)).to(dev), dim=0)
        rc = near_in["rc"]
        routes = {"dilated": incremental._near_dilated,
                  "pairwise": incremental._near_pairwise}
        got = {k: f(q, t, rc) for k, f in routes.items()}
        assert torch.equal(got["dilated"], got["pairwise"]), \
            f"{label}: dirty_near's routes disagree"
        near_rec = {"maxima": q.shape[0], "touched": t.shape[0], "rc": rc,
                    "near": int(got["dilated"].sum()),
                    **{f"{k}_ms": time_ms(lambda f=f: f(q, t, rc))
                       for k, f in routes.items()}}
        print(f"  dirty_near [{q.shape[0]} maxima x {t.shape[0]} touched "
              f"cells, radius {rc}]: dilated keys "
              f"{near_rec['dilated_ms']:.3f} ms, pairwise "
              f"{near_rec['pairwise_ms']:.3f} ms, equal ({near_rec['near']} "
              f"near)  ({card})", flush=True)

    # the end of the stream against a from-scratch fit of its window
    res = s.result
    wpts = s.window_points()
    fresh = DPCEngine(d_cut, rho_min=10, exec_spec=spec)
    fresh.fit(wpts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.fit(wpts)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    w = torch.from_numpy(wpts).to(dev)
    ties, tied, lab_diff = same_up_to_ties(
        w, fresh.result, res, fresh.clustering.labels, s.clustering.labels,
        f"{label} stream vs from-scratch fit")
    pts64 = w.double()
    gen = torch.Generator().manual_seed(1)
    rows = torch.randperm(n, generator=gen)[:Q_CHECK].to(dev)
    _, clear = float64_rho_check(pts64, res.rho, sweep.d2cut_of(d_cut), rows)
    requeried = s6[torch.randperm(s6.numel(), generator=gen)[:Q_CHECK]
                   .to(dev)]
    n_rule2 = float64_dependent_check(pts64, res, requeried, d_cut)
    print(f"  stream == from-scratch block-sparse fit of its window: rho, "
          f"rho_key, delta bit for bit; {ties} parents decided by exact "
          f"ties ({tied} rows downstream, {lab_diff} labels differ); rho == "
          f"float64 on {Q_CHECK} rows ({clear} clear of the band); "
          f"parent/delta == float64 on {requeried.numel()} re-queried "
          f"maxima ({n_rule2} rule 2); full recompute {1e3 * full_s:.1f} ms "
          f"= {full_s * 1e3 / median_ms:.2f} x the median tick  ({card})",
          flush=True)
    del fresh

    # predict: the next points of the stream, far rows, NaN rows
    rng = np.random.default_rng(2)
    tail = pts[n + (ticks + 2) * B:][:N_PREDICT - N_FAR - N_NAN]
    far = rng.uniform(4e8, 5e8, (N_FAR, d)).astype(np.float32)
    nan = np.full((N_NAN, d), np.nan, np.float32)
    order = rng.permutation(N_PREDICT)
    queries = np.concatenate([tail, far, nan])[order]
    kind = np.concatenate([np.zeros(len(tail)), np.ones(N_FAR),
                           np.full(N_NAN, 2)])[order]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.predict(queries)
    predict_s = time.perf_counter() - t0
    assert (out.status[kind == 1] == QueryStatus.MISS_FALLBACK).all(), \
        "far queries must fall back to the nearest center"
    assert (out.status[kind == 2] == QueryStatus.QUARANTINED).all() and \
        (out.labels[kind == 2] == -1).all(), "NaN queries must be quarantined"
    hit = np.nonzero(out.status == QueryStatus.HIT)[0]
    assert len(hit) > 0, "no query landed within d_cut of the window"
    labels_w = torch.from_numpy(eng.labels_).to(dev)
    pick = hit[rng.permutation(len(hit))[:1024]]
    qq = torch.from_numpy(queries[pick]).to(dev, torch.float64)
    got = torch.from_numpy(out.labels[pick]).to(dev)
    for c0 in range(0, len(pick), 16):
        d2 = ((qq[c0:c0 + 16, None, :] - pts64[None]) ** 2).sum(-1)
        best = d2.min(1).values
        assert bool((best.sqrt() < d_cut * (1 + 1e-6)).all()), \
            "a HIT query has no window point within d_cut"
        near = d2 <= best[:, None] * (1 + 1e-6)
        ok = (near & (labels_w[None, :] == got[c0:c0 + 16, None])).any(1)
        assert bool(ok.all()), "a HIT label is not its nearest point's"
    counts = {st.name: int((out.status == st).sum()) for st in QueryStatus}
    print(f"  predict: {N_PREDICT} queries in {1e3 * predict_s:.1f} ms: "
          f"{counts}; HIT labels == float64 nearest window point on "
          f"{len(pick)} queries  ({card})", flush=True)
    return {"n": n, "d": d, "d_cut": d_cut, "batch": B, "ticks": ticks,
            "fit_ms": 1e3 * fit_s, "seed_tick_ms": 1e3 * seed_s,
            "seeded_stats": seeded, "per_tick": per_tick,
            "median_tick_ms": median_ms, "launches": launches,
            "phases_ms": {k: 1e3 * v for k, v in phases.items()},
            "phases_peak_gb": peaks, "held_gb": held_gb,
            "kernels": kernels, "full_recompute_ms": 1e3 * full_s,
            "full_over_tick": full_s * 1e3 / median_ms,
            "parent_ties": ties, "rule2_requeried": n_rule2,
            "predict_ms": 1e3 * predict_s, "predict_status": counts,
            "dirty_near": near_rec,
            "stats": s.stats()}


def sapprox_kernels():
    """Gated K1, gated K3 and K7 and their plain versions, as the checks
    call them."""
    from repro_torch.kernels import ops, sweep

    def k1s(x, y, d_cut, sel):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel)

    def k1s_plain(x, y, d_cut, sel):
        c, v, i = sweep.fused_count_topk_plain(x, y, sweep.d2cut_of(d_cut),
                                               sel=sel.bool())
        return c.to(torch.float32), v, i

    def k3s(x, y, d_cut, wl, sel, live=None):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel, worklist=wl,
                               live=live)

    def k3s_plain(x, y, d_cut, wl, sel):
        c, v, i = sweep.worklist_count_topk_plain(
            x, y, sweep.d2cut_of(d_cut), wl, sel=sel.bool())
        return c.to(torch.float32), v, i

    def k7(pts):
        return ops.dependent_prefix(pts)

    def k7_plain(pts):
        best, arg = sweep.prefix_nn_plain(pts)
        return torch.sqrt(best), arg

    return k1s, k1s_plain, k3s, k3s_plain, k7, k7_plain


def sel_counts(sel: torch.Tensor) -> torch.Tensor:
    """Per column tile, the columns a gate lets into the kept k."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    nbc = -(-sel.numel() // BLOCK_M)
    return torch.bincount(torch.nonzero(sel).flatten() // BLOCK_M,
                          minlength=nbc)


def sapprox_check_shapes(cases, card: str) -> dict:
    """Gated K1/K3 bit for bit against their plain versions and gated K3
    against gated K1, under each gate; the all-ones gate against the
    ungated sweep; K7 against its plain version and K2 with key -position.
    Times on the first case, with the representatives' gate."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.sapproxdpc import representatives
    from repro_torch.kernels import blocksparse, ops
    k1s, k1s_plain, k3s, k3s_plain, k7, k7_plain = sapprox_kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out: dict = {"live": {}}
    for label, pts, dc in cases:
        x = torch.from_numpy(pts).to(dev)
        n, d = x.shape
        grid = build_grid(x, dc) if d <= 8 else None
        gs = x if grid is None else grid.points
        few = torch.zeros(n, dtype=torch.bool, device=dev)
        few[torch.from_numpy(rng.permutation(n)[:5]).to(dev)] = True
        gates = {"ones": torch.ones(n, dtype=torch.bool, device=dev),
                 "zeros": torch.zeros(n, dtype=torch.bool, device=dev),
                 "random": torch.from_numpy(rng.uniform(size=n) < 0.4)
                 .to(dev), "few": few}
        queries = dict.fromkeys(gates, gs)
        if grid is not None:
            reps, _ = representatives(grid, dc, SAPPROX_EPS)
            sel = torch.zeros(n, dtype=torch.bool, device=dev)
            sel[reps] = True
            gates["reps"], queries["reps"] = sel, gs[reps].contiguous()
        for gname, sel in gates.items():
            q = queries[gname]
            qr = q[:min(q.shape[0], Q_CHECK + 37)].contiguous()  # ragged
            got = k1s(qr, gs, dc, sel)
            check_equal(f"fused_count_topk_sel [{label}, {gname}]", got,
                        k1s_plain(qr, gs, dc, sel))
            if gname == "ones":
                check_equal(f"fused_count_topk_sel [{label}, ones]", got,
                            ops.fused_sweep(qr, gs, dc), "the ungated K1")
            wl = blocksparse.build_flat_worklist(
                q, gs, dc, nn_col_counts=sel_counts(sel))
            got = k3s(q, gs, dc, wl, sel)
            check_equal(f"worklist_count_topk_sel [{label}, {gname}]", got,
                        k3s_plain(q, gs, dc, wl, sel))
            check_equal(f"worklist_count_topk_sel [{label}, {gname}]", got,
                        k1s(q, gs, dc, sel), "gated fused_count_topk")
            live = torch.zeros(wl.num_row_tiles, dtype=torch.int32,
                               device=dev)
            k3s(q, gs, dc, wl, sel, live=live)
            out["live"][f"{label}, {gname}"] = {
                "rows": q.shape[0], "kept": wl.n_kept, "total": wl.n_total,
                "live": int(live.sum())}
        key = ops.fused_sweep(x, x, dc)[0] + density_jitter(n, dev)
        tbl = x[torch.argsort(key, descending=True, stable=True)]
        got = k7(tbl)
        check_equal(f"prefix_nn [{label}]", got, k7_plain(tbl))
        pos = -torch.arange(n, dtype=torch.float32, device=dev)
        check_equal(f"prefix_nn [{label}]", got,
                    ops.dependent_masked(tbl, pos, tbl, pos),
                    "masked_nn with key -position")
        print(f"fused_count_topk_sel, worklist_count_topk_sel == plain "
              f"(and == each other), prefix_nn == plain == masked_nn with "
              f"key -position, bit for bit: {label}, n={n} d={d}, gates "
              f"{list(gates)}", flush=True)
        if "times" not in out and "reps" in gates:
            sel, q = gates["reps"], queries["reps"]
            wl = blocksparse.build_flat_worklist(
                q, gs, dc, nn_col_counts=sel_counts(sel))
            out["times"] = {
                "fused_count_topk_sel": {
                    "shape": f"{q.shape[0]} reps x {n}, d={d}",
                    "ms": time_ms(lambda: k1s(q, gs, dc, sel)),
                    "plain_ms": time_ms(lambda: k1s_plain(q, gs, dc, sel)),
                    "ungated_ms": time_ms(lambda: ops.fused_sweep(q, gs,
                                                                  dc))},
                "worklist_count_topk_sel": {
                    "shape": f"{q.shape[0]} reps x {n}, d={d}, "
                             f"{wl.n_kept} entries",
                    "ms": time_ms(lambda: k3s(q, gs, dc, wl, sel)),
                    "plain_ms": time_ms(lambda: k3s_plain(q, gs, dc, wl,
                                                          sel))},
                "prefix_nn": {
                    "shape": f"n={n} d={d}",
                    "ms": time_ms(lambda: k7(tbl)),
                    "plain_ms": time_ms(lambda: k7_plain(tbl))}}
            for name, t in out["times"].items():
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    one = torch.zeros((1, 3), device=dev)
    d1, p1 = k7(one)
    assert bool(torch.isinf(d1).all()) and int(p1[0]) == -1, \
        "prefix_nn of one row must be (inf, -1)"
    return out


def float64_sapprox_check(pts64, res, rep_ids, is_rep, rows,
                          d_cut: float) -> tuple[int, int]:
    """S-Approx-DPC's representatives ``rows`` (original ids) against a
    float64 masked search among the representatives ``rep_ids``: the
    parent is a nearest strictly denser representative ((inf, -1) at the
    peak); the delta is d_cut where that one is within d_cut (phase 1)
    and its distance beyond (phase 2).  Returns the rows of each phase."""
    dc32 = float(np.float32(d_cut))
    key64 = res.rho_key.to(torch.float64)
    rp, rk = pts64[rep_ids], key64[rep_ids]
    n1 = n2 = 0
    step = max(1, (1 << 25) // rep_ids.numel())
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - rp[None]) ** 2).sum(-1)
        d2 = torch.where(rk[None, :] > key64[rr, None], d2, float("inf"))
        best = d2.min(1).values
        par, dl = res.parent[rr].long(), res.delta[rr]
        peak = torch.isinf(best)
        assert bool((par[peak] == -1).all() and torch.isinf(dl[peak]).all()), \
            "a representative with no denser one must get (inf, -1)"
        pc = par.clamp_min(0)
        got = ((pts64[rr] - pts64[pc]) ** 2).sum(-1)
        assert bool((is_rep[pc] & (key64[pc] > key64[rr]))[~peak].all()), \
            "a representative's parent is not a denser representative"
        assert bool((got[~peak] <= best[~peak] * (1 + 1e-6)).all()), \
            "a representative's parent is not its nearest denser one"
        ph1 = ~peak & (best.sqrt() < dc32 * (1 - 1e-6))
        ph2 = ~peak & (best.sqrt() > dc32 * (1 + 1e-6))
        assert bool((dl[ph1] == dc32).all()), \
            "a representative with a denser one within d_cut must get d_cut"
        torch.testing.assert_close(dl[ph2].double(), best[ph2].sqrt(),
                                   rtol=1e-6, atol=0)
        n1, n2 = n1 + int(ph1.sum()), n2 + int(ph2.sum())
    return n1, n2


def k3_row_tile_check(x, y, d_cut, wl, sel, name: str, card: str):
    """K3 (gated where ``sel`` is given) on TILES_CHECK row tiles spread
    over a fit's table, against all columns: equal to the fit's full
    sweep, to dense K1 (gated alike) and to its plain version.  Returns
    (max abs err, times, the work for the bound, the worklist record)."""
    from repro_torch.kernels import ops, sweep
    from repro_torch.kernels.blocksparse import BLOCK_N
    dev = x.device
    gate = {} if sel is None else {"nn_sel": sel}
    nbr = wl.num_row_tiles
    tiles = torch.linspace(0, nbr - 2, TILES_CHECK).round().long().unique()
    tiles = tiles.to(dev)
    sub = sub_worklist(wl, tiles)
    rows = (tiles[:, None] * BLOCK_N
            + torch.arange(BLOCK_N, device=dev)).flatten()
    sx = x[rows].contiguous()
    got = ops.fused_sweep(sx, y, d_cut, worklist=sub, **gate)
    fit_out = ops.fused_sweep(x, y, d_cut, worklist=wl, **gate)
    what = f"{name} [main path, row tiles]"
    check_equal(what, got, [t[rows] for t in fit_out], "the fit's full sweep")
    check_equal(what, got, ops.fused_sweep(sx, y, d_cut, **gate),
                "dense K1")
    plain_sel = None if sel is None else sel.bool()
    want, plain_ms = timed_once(lambda: sweep.worklist_count_topk_plain(
        sx, y, sweep.d2cut_of(d_cut), sub, sel=plain_sel))
    err = check_equal(what, got, (want[0].to(torch.float32), *want[1:]))
    sch = k3_schedule(x, y, d_cut, wl, sel)
    needed = k3_needed_pairs(wl, y.shape[0], fit_out[1])
    times = {"ms": time_ms(lambda: ops.fused_sweep(x, y, d_cut, worklist=wl,
                                                   **gate)),
             "plain_ms": plain_ms, "plain_row_tiles": tiles.numel()}
    rec = {"kept": wl.n_kept, "total": wl.n_total,
           "in_cut": int(wl.in_cut.sum()), **sch,
           "needed_pairs": needed, "pruned_frac": wl.pruned_frac,
           "live_frac_of_dense": sch["live"] / wl.n_total}
    print(f"{name} == plain == the fit's sweep == dense K1, bit for bit, on "
          f"{tiles.numel()} row tiles x {y.shape[0]} columns; worklist "
          f"{wl.n_kept} of {wl.n_total} tile pairs ({rec['in_cut']} in "
          f"d_cut), {k3_schedule_line(sch, needed)}; kernel "
          f"{times['ms']:.3f} ms, plain {plain_ms:.1f} ms on the row tiles  "
          f"({card})", flush=True)
    return err, times, k3_work(x, y, wl, needed, sel), rec


def k2_fit_check(calls, what: str, card: str):
    """K2 on the calls a fit made: each against its plain version on its
    first K2_PLAIN_ROWS rows, timed on all.  Returns (max abs err, times,
    the work for the bound)."""
    from repro_torch.kernels import ops, sweep
    err, ms, plain_ms, nbytes, nops = 0.0, 0.0, 0.0, 0.0, 0.0
    for i, (xq, xk, y, yk) in enumerate(calls):
        r = min(K2_PLAIN_ROWS, xq.shape[0])
        want, p_ms = timed_once(lambda: sweep.masked_nn_plain(
            xq[:r], xk[:r], y, yk))
        err = max(err, check_equal(
            f"masked_nn [{what}, call {i}]",
            [t[:r] for t in ops.dependent_masked(xq, xk, y, yk)],
            (torch.sqrt(want[0]), want[1])))
        ms += time_ms(lambda: ops.dependent_masked(xq, xk, y, yk))
        plain_ms += p_ms
        nb, no = k2_work(xk, yk, xq.shape[1])
        nbytes, nops = nbytes + nb, nops + no
    rows = [c[0].shape[0] for c in calls]
    b_ms, by = bound_ms(nbytes, nops)
    print(f"masked_nn == plain, bit for bit, on the first {K2_PLAIN_ROWS} of "
          f"{rows} rows x {calls[0][2].shape[0]} ({what}); kernel {ms:.3f} "
          f"ms on all rows, bound {b_ms:.3f} ms ({by}), plain "
          f"{plain_ms:.3f} ms on the slice  ({card})", flush=True)
    return err, {"ms": ms, "plain_ms": plain_ms, "rows": rows,
                 "plain_rows": K2_PLAIN_ROWS, "bound_ms": b_ms,
                 "bound_by": by}, (nbytes, nops)


def traced(fit, names, card: str, what: str):
    """Phase times and each phase's peak device memory of one traced
    ``fit()`` (a span records the most allocated while it was open, the
    script's own tensors included: ``held_gb`` of them at the start)."""
    from repro_torch import obs
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    obs.configure("trace")
    obs.reset_spans()
    try:
        with obs.span("smoke.traced_fit"):
            fit()
    finally:
        obs.configure("off")
    phases: dict[str, float] = {}
    peaks: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
        peaks[sp["name"]] = max(peaks.get(sp["name"], 0.0),
                                sp.get("peak_bytes", 0) / 1e9)
    for name in names:
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms, peak "
              f"{peaks.get(name, 0.0):.3f} GB")
    print(f"  {what}: peak device memory {peaks['smoke.traced_fit']:.3f} "
          f"GB, of which {held_gb:.3f} GB held by the script before the fit"
          f"  ({card})", flush=True)
    return {"phases_ms": {k: 1e3 * v for k, v in phases.items()},
            "phases_peak_gb": peaks, "held_gb": held_gb,
            "peak_gb": peaks["smoke.traced_fit"]}


def dist_kernels():
    """K8-K11 and their plain versions, as the checks call them."""
    from repro_torch.kernels import ops, sweep

    def k8(x, y, d_cut, wl):
        return ops.local_density_xy(x, y, d_cut, worklist=wl)

    def k8_plain(x, y, d_cut, wl):
        return sweep.worklist_range_count_plain(
            x, y, sweep.d2cut_of(d_cut), wl).float()

    def k9(x, xk, y, yk, wl, live=None):
        return ops.dependent_masked(x, xk, y, yk, worklist=wl, live=live)

    def k9_plain(x, xk, y, yk, wl):
        best, arg = sweep.worklist_masked_nn_plain(x, xk, y, yk, wl)
        return torch.sqrt(best), arg

    def k10(x, win, st, en, d_cut):
        return ops.halo_density(x, win, st, en, d_cut)

    def k10_plain(x, win, st, en, d_cut):
        return sweep.halo_range_count_plain(x, win, st, en,
                                            sweep.d2cut_of(d_cut)).float()

    def k11(x, xk, win, wk, st, en, d_cut):
        return ops.halo_dependent(x, xk, win, wk, st, en, d_cut)

    def k11_plain(x, xk, win, wk, st, en, d_cut):
        best, arg = sweep.halo_masked_nn_plain(x, xk, win, wk, st, en,
                                               sweep.d2cut_of(d_cut))
        return torch.sqrt(best), arg, torch.isfinite(best)

    return k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain


def halo_setup_ms(points: np.ndarray, d_cut: float, shards: int) -> dict:
    """Milliseconds of the halo fit's steps that run outside its ``dist.*``
    spans, as ``DPCEngine.fit`` and ``distributed_dpc`` run them on these
    points, each between two synchronizes (the second of two runs): the
    engine's host admission, the points to the card, the points padded
    and sharded, ``point_span_bounds``, the two ``_pad_rows`` of the
    spans, ``_window_bounds`` (its host copy included), the spans sharded
    and the keys' jitter; ``dist.grid``, which runs inside its span,
    beside them."""
    from repro_torch.core.device import as_points
    from repro_torch.core.dpc_types import with_jitter
    from repro_torch.resilience.sanitize import AdmissionConfig, admit
    from repro_torch.core.grid import build_grid, point_span_bounds
    from repro_torch.distributed import dpc as ddpc
    from repro_torch.kernels import sweep
    from repro_torch.launch import ShardMesh
    mesh = ShardMesh.on("cuda", shards=shards)
    for _ in range(2):
        ms = {}

        def step(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        step("admit", lambda: admit(points, AdmissionConfig(),
                                    where="engine.fit"))
        x = step("as_points", lambda: as_points(points, mesh.devices[0]))
        grid = step("dist.grid (in its span)", lambda: build_grid(x, d_cut))
        n = grid.points.shape[0]
        m = -(-n // shards) * shards
        step("mesh.shard(_pad_rows(points))", lambda: mesh.shard(
            ddpc._pad_rows(grid.points, m, sweep.PAD_COORD)))
        st, en = step("point_span_bounds", lambda: point_span_bounds(grid))
        st, en = step("_pad_rows x2", lambda: (ddpc._pad_rows(st, m, 0),
                                               ddpc._pad_rows(en, m, 0)))
        step("_window_bounds", lambda: ddpc._window_bounds(st, en, shards))
        step("mesh.shard(starts, ends)", lambda: (mesh.shard(st),
                                                  mesh.shard(en)))
        step("with_jitter", lambda: with_jitter(grid.cell_count.new_ones(
            n, dtype=torch.float32)))
        del x, grid, st, en
    return ms


def entry_widths(wl, m: int) -> torch.Tensor:
    """(W,) int64 real columns of each worklist entry's column tile."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    return (m - wl.col_tile.long() * BLOCK_M).clamp(max=BLOCK_M)


def tile_rows(wl, n: int) -> torch.Tensor:
    """(row tiles,) int64 real rows of each row tile."""
    from repro_torch.kernels.blocksparse import BLOCK_N
    t = torch.arange(wl.num_row_tiles, device=wl.row_ptr.device)
    return (n - t * BLOCK_N).clamp(max=BLOCK_N)


def k8_work(x, y, wl) -> tuple[float, float]:
    """Bytes and operations of worklist_range_count: x, y and the worklist
    read once (row_ptr, col_tile, in_cut), the counts written once; 3d+1
    operations per pair of an in-d_cut entry."""
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    pairs = float((entry_widths(wl, m) * wl.in_cut
                   * tile_rows(wl, n)[wl.row_tile()]).sum())
    nbytes = (4 * (n * d + m * d) + 4 * n + 4 * wl.row_ptr.numel()
              + 5 * wl.n_kept)
    return nbytes, pairs * (3 * d + 1)


def k9_work(x, xk, y, yk, wl, best_d2, sample: int = 2048,
            gen=None) -> tuple[float, float, dict]:
    """Bytes and operations of worklist_masked_nn on this run's data.
    Bytes: x, its keys, y, its keys and the ring (row_ptr, col_tile, lb)
    read once, (d2, parent) written once.  Operations, per row: a key test
    for each column of the entries it needs, those whose lb is at most its
    final best d2 (a prefix of its ring, found by a search on (row tile,
    lb's bits) as in ``k3_needed_pairs``) and whose column tile's largest
    key (``packing.tile_max_key``) is above the row's key, since no column
    of any other tile can be denser (rows keyed +inf or NaN need none);
    and 3d+1 for each of those columns that is denser: counted on
    ``sample`` random rows and scaled by their share of the key tests.
    ``info`` also holds the earlier count, a key test for every
    column of the prefix, and its operations."""
    from repro_torch.kernels import packing
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    dev = x.device
    width = entry_widths(wl, m)
    cum = torch.zeros(wl.n_kept + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(width, 0)
    key = (wl.row_tile() << 32) | wl.lb.view(torch.int32).long()
    tile = torch.arange(n, device=dev) // BLOCK_N
    tau = best_d2.contiguous().view(torch.int32).long()
    p = torch.searchsorted(key, (tile << 32) | tau, right=True)
    start = wl.row_ptr.long()[tile]
    seeks = xk < float("inf")
    prefix = torch.where(seeks, p - start, 0)
    earlier = float(torch.where(seeks, cum[p] - cum[start], 0).sum())
    # the prefix's entries whose tile holds a key above the row's, in
    # chunks of rows of at most ~40M entries
    tmax = packing.tile_max_key(yk)[wl.col_tile.long()]
    total = 0.0
    r0 = 0
    while r0 < n:
        r1 = min(n, r0 + 4096)
        while r1 < n and int(prefix[r0:r1].sum()) < 40_000_000:
            r1 = min(n, r1 + 4096)
        cnt = prefix[r0:r1]
        rows = torch.repeat_interleave(torch.arange(r0, r1, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        e = start[rows] + torch.arange(rows.numel(), device=dev) \
            - torch.repeat_interleave(first, cnt)
        total += float((width[e] * (tmax[e] > xk[rows])).sum())
        r0 = r1
    rows = torch.nonzero(seeks).flatten()
    rows = rows[torch.randperm(rows.numel(), generator=gen)[:sample]
                .to(dev)]
    lane = torch.arange(BLOCK_M, device=dev)
    s_needed = s_denser = 0
    for r in rows.tolist():
        ent = torch.arange(int(start[r]), int(p[r]), device=dev)
        ent = ent[tmax[ent] > xk[r]]
        tiles = wl.col_tile[ent].long()
        cols = (tiles[:, None] * BLOCK_M + lane).flatten()
        cols = cols[cols < m]
        s_needed += cols.numel()
        s_denser += int((yk[cols] > xk[r]).sum())
    # the same denser columns under either count: the tiles the key test
    # passes over hold none
    denser = total * s_denser / max(s_needed, 1)
    nbytes = (4 * (n * d + n + m * d + m) + 4 * wl.row_ptr.numel()
              + 8 * wl.n_kept + 8 * n)
    ops = total + denser * (3 * d + 1)
    ops_earlier = earlier + denser * (3 * d + 1)
    return nbytes, ops, {
        "key_tests": total, "denser_est": denser, "sample_rows": rows.numel(),
        "key_tests_earlier": earlier, "ops_earlier": ops_earlier,
        "bound_ms_earlier": bound_ms(nbytes, ops_earlier)[0]}


def row_tile_slice(wl, n_rows, count):
    """A few row tiles spread over a worklist (the last one ragged)."""
    from repro_torch.kernels.blocksparse import BLOCK_N
    dev = wl.row_ptr.device
    nbr = wl.num_row_tiles
    tiles = torch.linspace(0, nbr - 1, count).round().long().unique()
    tiles = tiles.to(dev)
    rows = (tiles[:, None] * BLOCK_N
            + torch.arange(BLOCK_N, device=dev)).flatten()
    return sub_worklist(wl, tiles), rows[rows < n_rows]


def k9_walks(x, xk, y, yk, wl) -> tuple:
    """(delta, parent) of K9 on the ring, the entries its rows' walks
    computed and the longest walk."""
    from repro_torch.kernels import ops
    live = torch.zeros((wl.num_row_tiles, 2), dtype=torch.int32,
                       device=x.device)
    out = ops.dependent_masked(x, xk, y, yk, worklist=wl, live=live)
    return out, int(live[:, 0].sum()), int(live[:, 1].max())


def k9_fit_check(calls, what: str, card: str, gen) -> tuple:
    """K9 on the rows a fit's block-sparse ``rho_delta`` sent it (its
    unresolved rows, each call's x, keys, y and column keys): bit for bit
    against dense K2 on all rows and against its plain version on a few
    row tiles; K2, K9 and the route K9 took (its best-1 ring built, then
    K9) timed; the entries its rows' walks computed, the longest walk, and
    its bound from the inputs.  Returns (max abs err against the plain
    version, the record, the work for the bound)."""
    from repro_torch.kernels import blocksparse, ops, sweep
    rec = {"rows": [], "k2_ms": 0.0, "k9_ms": 0.0, "route_ms": 0.0,
           "ring_ms": 0.0, "plain_ms": 0.0, "plain_rows": 0, "entries": 0,
           "longest": 0, "ring": 0}
    err, nb, no, no0 = 0.0, 0.0, 0.0, 0.0

    def ring_of(x, y):
        return blocksparse.build_flat_worklist(x, y, count=False, nn="best1")

    for i, (x, xk, y, yk) in enumerate(calls):
        ring, ring_ms = timed_once(lambda: ring_of(x, y))
        (d9, p9), entries, longest = k9_walks(x, xk, y, yk, ring)
        check_equal(f"worklist_masked_nn [{what}, call {i}]", (d9, p9),
                    ops.dependent_masked(x, xk, y, yk), "dense K2")
        sub, rows = row_tile_slice(ring, x.shape[0], DIST_PLAIN_TILES)
        sx, sk = x[rows].contiguous(), xk[rows].contiguous()
        want, p_ms = timed_once(lambda: sweep.worklist_masked_nn_plain(
            sx, sk, y, yk, sub))
        err = max(err, check_equal(
            f"worklist_masked_nn [{what}, call {i}, row tiles]",
            ops.dependent_masked(sx, sk, y, yk, worklist=sub),
            (torch.sqrt(want[0]), want[1])))
        rec["rows"].append(x.shape[0])
        rec["k2_ms"] += time_ms(lambda: ops.dependent_masked(x, xk, y, yk))
        rec["k9_ms"] += time_ms(lambda: ops.dependent_masked(
            x, xk, y, yk, worklist=ring))
        rec["route_ms"] += time_ms(lambda: ops.dependent_masked(
            x, xk, y, yk, worklist=ring_of(x, y)))
        rec["ring_ms"] += ring_ms
        rec["plain_ms"] += p_ms
        rec["plain_rows"] += rows.numel()
        rec["entries"] += entries
        rec["longest"] = max(rec["longest"], longest)
        rec["ring"] += ring.n_kept
        b, o, info = k9_work(x, xk, y, yk, ring, torch.square(d9), gen=gen)
        nb, no, no0 = nb + b, no + o, no0 + info["ops_earlier"]
        del ring
    rec["bound_ms"], rec["bound_by"] = bound_ms(nb, no)
    rec["bound_ms_earlier"] = bound_ms(nb, no0)[0]
    rec["route"] = ("K9" if rec["route_ms"] < rec["k2_ms"] else "K2")
    print(f"worklist_masked_nn [{what}]: == dense K2 bit for bit on all "
          f"{rec['rows']} rows, == plain on {rec['plain_rows']} rows of "
          f"{DIST_PLAIN_TILES} row tiles a call; "
          f"K9 {rec['k9_ms']:.3f} ms (+ ring {rec['ring_ms']:.3f} ms: route "
          f"{rec['route_ms']:.3f} ms) against K2 {rec['k2_ms']:.3f} ms: the "
          f"faster is {rec['route']}, and the block-sparse fallback runs K9; "
          f"entries computed {rec['entries']} of {rec['ring']} (a row's "
          f"walk each), longest walk {rec['longest']}; bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}; earlier count "
          f"{rec['bound_ms_earlier']:.3f})  ({card})", flush=True)
    return err, rec, (nb, no)


def span_pairs(st, en, w: int) -> torch.Tensor:
    """(n,) int64 window columns inside each row's spans (clipped)."""
    a = st.long().clamp_min(0)
    b = en.long().clamp(max=w)
    return (b - a).clamp_min(0).sum(1)


def k10_work(x, win, st, en) -> tuple[float, float]:
    """Bytes and operations of halo_range_count: x, the window and the
    spans read once, the counts written once; 3d+1 operations per window
    column inside a row's spans."""
    (n, d), w = x.shape, win.shape[0]
    pairs = float(span_pairs(st, en, w).sum())
    return 4 * (n * d + w * d) + 8 * st.numel() + 4 * n, pairs * (3 * d + 1)


def span_tiles(st, en, w: int, rows):
    """Every (row, span, column tile) that the clipped spans of ``rows``
    ((r,) int64) reach, flattened: (row, column tile, the span's columns
    in that tile), each (k,) int64."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    a = st[rows].long().clamp(0, w)
    b = torch.maximum(en[rows].long().clamp(0, w), a)
    reach = torch.where(b > a, (b - 1) // BLOCK_M - a // BLOCK_M + 1, 0)
    c = a[..., None] // BLOCK_M + torch.arange(
        max(int(reach.max()) if reach.numel() else 0, 1), device=st.device)
    cols = (torch.minimum(b[..., None], (c + 1) * BLOCK_M)
            - torch.maximum(a[..., None], c * BLOCK_M)).clamp_min(0)
    keep = cols > 0
    return rows[:, None, None].expand_as(c)[keep], c[keep], cols[keep]


def span_tile_chunks(st, en, w: int, rows=None, budget: int = 40_000_000):
    """``span_tiles`` over ``rows`` (default all) in chunks of rows of at
    most about ``budget`` (row, span, tile) slots."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    if rows is None:
        rows = torch.arange(st.shape[0], device=st.device)
    lens = (en.long().clamp(0, w) - st.long().clamp(0, w)).clamp_min(0)
    width = st.shape[1] * (int(lens.max()) // BLOCK_M + 2) if lens.numel() \
        else 1
    step = max(1, budget // width)
    for r0 in range(0, rows.numel(), step):
        yield span_tiles(st, en, w, rows[r0:r0 + step])


def k11_work(x, xk, win, wk, st, en) -> tuple[float, float, float]:
    """Bytes and operations of halo_masked_nn: x, its keys, the window, its
    keys and the spans read once, (delta, parent, found) written once; a
    key test per window column inside a row's spans whose column tile's
    largest key (``packing.tile_max_key``) is above the row's, since no
    column of another tile can be denser (counted exactly, (row, span,
    tile) by (row, span, tile)), and 3d+1 operations for each denser one
    (counted exactly, in row blocks).  The third value is the earlier
    count, a key test for every span column."""
    from repro_torch.kernels import packing, sweep
    (n, d), w = x.shape, win.shape[0]
    pairs = float(span_pairs(st, en, w).sum())
    tmax = packing.tile_max_key(wk)
    tests = 0
    for r, c, cols in span_tile_chunks(st, en, w):
        tests += int(cols[tmax[c] > xk[r]].sum())
    denser = 0
    step = sweep._span_rows(st, en)
    for r0 in range(0, n, step):
        idx, valid = sweep._span_candidates(st[r0:r0 + step],
                                            en[r0:r0 + step], w)
        denser += int((valid & (wk[idx] > xk[r0:r0 + step, None, None]))
                      .sum())
    nbytes = 4 * (n * d + n + w * d + w) + 8 * st.numel() + 9 * n
    return (nbytes, tests + denser * (3 * d + 1),
            pairs + denser * (3 * d + 1))


def halo_runs(st, en, w: int) -> dict:
    """Rows per run (the rows in order whose spans clip to the same
    columns: one candidate cell's, grid-sorted): mean, largest, and the
    share of the span columns (row by row) in runs of at least 32 rows."""
    from repro_torch.kernels import packing
    run = torch.cumsum(packing.span_runs(st, en, w), 0) - 1
    per = torch.bincount(run)
    a, b = packing.clip_spans(st, en, w)
    cols = (b - a).long().sum(1)
    return {"runs": per.numel(), "rows_mean": float(per.float().mean()),
            "rows_max": int(per.max()),
            "share_cols_runs_ge32": float(cols[per[run] >= 32].sum())
            / max(float(cols.sum()), 1.0)}


def halo_ptxas(log: str) -> dict:
    """K10's, K11's, K15's and K16's registers and spill bytes at d = 3
    (the halo fit's) from the build's ptxas log: by rows a lane (and, for
    the count, by form) they are not told apart (one kernel serves all),
    so each kernel's whole report."""
    from repro_torch.kernels.build import ptxas_usage
    out = {}
    for name, u in ptxas_usage(log).items():
        for kern, forms in (("halo_nn_kernel", ("K11", "K16")),
                            ("halo_count_kernel", ("K10", "K15"))):
            if kern in name and "ILi3E" in name:
                form = forms[1] if "Lb1E" in name else forms[0]
                out[form] = (u["registers"], u["spill_stores"],
                             u["spill_loads"])
    return out


def count_pieces(lay) -> dict:
    """The pieces of a count layout (``ops.halo_layout`` with no key) by
    form: a column a lane (at most ``packing.COUNT_BALLOT_ROWS`` rows), a
    row a lane, two rows a lane (above 32); the splits and pieces."""
    from repro_torch.kernels import packing
    plen = lay.plen[lay.plen > 0]
    cols = plen <= packing.COUNT_BALLOT_ROWS
    return {"splits": int(lay.meta[0]), "pieces": int(lay.meta[1]),
            "col_a_lane": int(cols.sum()),
            "row_a_lane": int((~cols & (plen <= 32)).sum()),
            "two_rows_a_lane": int((plen > 32).sum())}


def k10_skip_share(x, win, st, en, d_cut) -> dict:
    """A count for a later PR, recorded here: of the span columns K10's
    pieces walk (its keyless layout's pieces, each span cut into 32-column
    chunks from its start, as the kernel loads them), the share in chunks
    whose bounding box lies farther than d_cut from the bounding box of
    the piece's rows, and the share of row-column pairs there: what a
    distance skip could pass over.  Exact only with the box bound shrunk
    as ``blocksparse.LB_SHRINK`` shrinks the worklist's (its f32 rounding
    never above a pair's d2), counted so; without the shrink beside it.
    Plain PyTorch on the card's tensors, a window sparse table giving
    each chunk's box."""
    from repro_torch.kernels import ops, packing, sweep
    from repro_torch.kernels.blocksparse import LB_SHRINK
    n, d = x.shape
    w = win.shape[0]
    d2cut = sweep.d2cut_of(d_cut)
    lay = ops.halo_layout(None, win, None, st, en, ring=False)
    start = lay.plen > 0
    p0 = torch.nonzero(start).flatten()
    rows = lay.plen[p0].long()
    piece = torch.cumsum(start, 0) - 1
    plo = torch.full((p0.numel(), d), float("inf"), device=x.device)
    phi = torch.full((p0.numel(), d), float("-inf"), device=x.device)
    plo.scatter_reduce_(0, piece[:, None].expand(n, d), x, "amin")
    phi.scatter_reduce_(0, piece[:, None].expand(n, d), x, "amax")
    lo_t, hi_t = [win], [win]          # min / max over [j, j + 2^l)
    for lvl in range(1, 6):
        h = min(1 << (lvl - 1), w)
        a, b = lo_t[-1], hi_t[-1]
        lo_t.append(torch.minimum(a, torch.cat([a[h:], a[w - h:]])))
        hi_t.append(torch.maximum(b, torch.cat([b[h:], b[w - h:]])))
    a, b = packing.clip_spans(st[p0], en[p0], w)
    tot = {"cols": 0, "pairs": 0, "skip_cols": 0, "skip_pairs": 0,
           "skip_cols_no_shrink": 0, "chunks": 0}
    for k in range(st.shape[1]):
        length = (b[:, k] - a[:, k]).long()
        nch = (length + 31) // 32
        pc = torch.repeat_interleave(torch.arange(p0.numel(),
                                                  device=x.device), nch)
        first = torch.cumsum(nch, 0) - nch
        c0 = a[pc, k].long() + 32 * (torch.arange(pc.numel(),
                                                  device=x.device)
                                     - first[pc])
        ln = torch.clamp(b[pc, k].long() - c0, max=32)
        if not pc.numel():
            continue
        lvl = torch.floor(torch.log2(ln.double())).long()
        clo = torch.empty((pc.numel(), d), device=x.device)
        chi = torch.empty_like(clo)
        for v in range(6):
            m = lvl == v
            if not bool(m.any()):
                continue
            j0, j1 = c0[m], c0[m] + ln[m] - (1 << v)
            clo[m] = torch.minimum(lo_t[v][j0], lo_t[v][j1])
            chi[m] = torch.maximum(hi_t[v][j0], hi_t[v][j1])
        gap = torch.maximum(clo - phi[pc], plo[pc] - chi).clamp_min(0.0)
        g2 = sweep.direct_d2(gap, torch.zeros_like(gap))
        skip = g2 * LB_SHRINK > d2cut
        skip0 = g2 > d2cut
        r = rows[pc]
        tot["chunks"] += pc.numel()
        tot["cols"] += int(ln.sum())
        tot["pairs"] += int((ln * r).sum())
        tot["skip_cols"] += int(ln[skip].sum())
        tot["skip_pairs"] += int((ln * r)[skip].sum())
        tot["skip_cols_no_shrink"] += int(ln[skip0].sum())
    return tot


def dist_check_shapes(cases, card: str) -> dict:
    """K8-K11 bit for bit against their plain versions at check shapes,
    and against the dense kernels on the same inputs: for each case the
    grid-sorted table (d <= 8) split into three shards as
    ``distributed_dpc`` splits it (rows padded at 1e9, so the last shard
    ends in padded rows, keyed +inf as queries and -inf in the table),
    shard 1 cut to a row count that is not a multiple of the tile.  K8 on
    the count-only worklist == K4, K9 on the best-1 ring == K2 (computed
    entries counted); for d <= 8 each shard's halo window through the
    ppermute ring, K10/K11 on its window-local spans (empty spans turn
    negative), and with spans covering the whole window (plus a reversed
    and a negative span) K10 == K4 and K11 == K2 masked to d_cut.  Times
    on the first case."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid, point_span_bounds
    from repro_torch.distributed import dpc as ddpc
    from repro_torch.kernels import blocksparse, ops, sweep
    from repro_torch.launch import ShardMesh
    k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain = \
        dist_kernels()
    dev = torch.device("cuda")
    mesh = ShardMesh.on(dev, shards=3)
    times, computed = {}, {}
    for label, pts, dc in cases:
        x = torch.from_numpy(pts).to(dev)
        halo = pts.shape[1] <= 8
        grid = build_grid(x, dc) if halo else None
        xs = grid.points if halo else x
        n = xs.shape[0]
        m = -(-n // 3) * 3 + 3                   # three padded rows at least
        key = ops.local_density_xy(xs, xs, dc) + density_jitter(n, dev)
        tbl = ddpc._pad_rows(xs, m, sweep.PAD_COORD)
        tk = ddpc._pad_rows(key, m, float("-inf"))
        qk_all = ddpc._pad_rows(key, m, float("inf"))
        per = m // 3
        cut = per - 37 if per > 300 else per    # shard 1: a ragged count
        for s in range(3):
            r0, r1 = s * per, (s * per + cut if s == 1 else (s + 1) * per)
            q, qk = tbl[r0:r1], qk_all[r0:r1]
            wl = blocksparse.build_flat_worklist(q, tbl, dc, nn=None)
            got = k8(q, tbl, dc, wl)
            check_equal(f"worklist_range_count [{label}, shard {s}]", [got],
                        [k8_plain(q, tbl, dc, wl)])
            check_equal(f"worklist_range_count [{label}, shard {s}]", [got],
                        [ops.local_density_xy(q, tbl, dc)], "dense K4")
            ring = blocksparse.build_flat_worklist(q, tbl, count=False,
                                                   nn="best1")
            got, walked, longest = k9_walks(q, qk, tbl, tk, ring)
            check_equal(f"worklist_masked_nn [{label}, shard {s}]", got,
                        k9_plain(q, qk, tbl, tk, ring))
            check_equal(f"worklist_masked_nn [{label}, shard {s}]", got,
                        ops.dependent_masked(q, qk, tbl, tk), "dense K2")
            computed[f"{label} shard {s}"] = [walked, longest, ring.n_kept]
        line = (f"worklist_range_count == plain == dense K4, "
                f"worklist_masked_nn == plain == dense K2, bit for bit: "
                f"{label}, n={n} d={pts.shape[1]}, 3 shards (shard 1 "
                f"{cut} rows; {m - n} padded rows); K9's row walks computed "
                f"{[computed[f'{label} shard {s}'][0] for s in range(3)]} "
                f"entries (the ring: {ring.n_kept} per shard)")
        if halo:
            st, en = (ddpc._pad_rows(a, m, 0) for a in point_span_bounds(grid))
            lo, W, hf, hb = ddpc._window_bounds(st, en, 3)
            pts_p, rk_p = mesh.shard(tbl), mesh.shard(tk)
            both = [torch.cat([p, k[:, None]], 1) for p, k in zip(pts_p, rk_p)]
            wins = ddpc._halo_window(mesh, both, lo, W, hf, hb)
            neg = 0
            for s in range(3):
                q, qk = pts_p[s], mesh.shard(qk_all)[s]
                win = wins[s][:, :-1].contiguous()
                wk = wins[s][:, -1].contiguous()
                sst = (mesh.shard(st)[s] - lo[s]).contiguous()
                sen = (mesh.shard(en)[s] - lo[s]).contiguous()
                neg += int((sen < 0).sum())
                halo_layout_check(qk, win, wk, sst, sen,
                                  f"{label}, shard {s}")
                got = k10(q, win, sst, sen, dc)
                check_equal(f"halo_range_count [{label}, shard {s}]", [got],
                            [k10_plain(q, win, sst, sen, dc)])
                got = k11(q, qk, win, wk, sst, sen, dc)
                check_equal(f"halo_masked_nn [{label}, shard {s}]", got,
                            k11_plain(q, qk, win, wk, sst, sen, dc))
                whole = torch.tensor([[0, W], [5, 2], [-9, -3]],
                                     dtype=torch.int32, device=dev)
                wst = whole[:, 0].expand(q.shape[0], 3).contiguous()
                wen = whole[:, 1].expand(q.shape[0], 3).contiguous()
                halo_layout_check(qk, win, wk, wst, wen,
                                  f"{label}, shard {s}, whole window")
                check_equal(f"halo_range_count [{label}, shard {s}]",
                            [k10(q, win, wst, wen, dc)],
                            [ops.local_density_xy(q, win, dc)],
                            "dense K4 on the whole window")
                best, arg = sweep.masked_nn_plain(q, qk, win, wk)
                within = best < sweep.d2cut_of(dc)
                k2d, k2p = ops.dependent_masked(q, qk, win, wk)
                check_equal(f"halo_masked_nn [{label}, shard {s}]",
                            k11(q, qk, win, wk, wst, wen, dc),
                            (torch.where(within, k2d, float("inf")),
                             torch.where(within, k2p, -1), within),
                            "dense K2 masked to d_cut on the whole window")
            line += (f"; halo_range_count, halo_masked_nn == plain, and == "
                     f"K4 / d_cut-masked K2 on whole-window spans: W={W}, "
                     f"hops {hf} forward {hb} back, {neg} negative span "
                     f"bounds; their layouts built on the card == plain")
        print(line, flush=True)
        if not times:
            s1 = slice(per, per + cut)
            q, qk = tbl[s1], qk_all[s1]
            wl = blocksparse.build_flat_worklist(q, tbl, dc, nn=None)
            ring = blocksparse.build_flat_worklist(q, tbl, count=False,
                                                   nn="best1")
            win = wins[1][:, :-1].contiguous()
            wk = wins[1][:, -1].contiguous()
            sst = (st[s1] - lo[1]).contiguous()
            sen = (en[s1] - lo[1]).contiguous()
            qh, qhk = pts_p[1][:cut], mesh.shard(qk_all)[1][:cut]
            times = {
                "worklist_range_count": {
                    "ms": time_ms(lambda: k8(q, tbl, dc, wl)),
                    "plain_ms": time_ms(lambda: k8_plain(q, tbl, dc, wl))},
                "worklist_masked_nn": {
                    "ms": time_ms(lambda: k9(q, qk, tbl, tk, ring)),
                    "plain_ms": time_ms(lambda: k9_plain(q, qk, tbl, tk,
                                                         ring))},
                "halo_range_count": {
                    "ms": time_ms(lambda: k10(qh, win, sst, sen, dc)),
                    "plain_ms": time_ms(lambda: k10_plain(qh, win, sst, sen,
                                                          dc))},
                "halo_masked_nn": {
                    "ms": time_ms(lambda: k11(qh, qhk, win, wk, sst, sen,
                                              dc)),
                    "plain_ms": time_ms(lambda: k11_plain(
                        qh, qhk, win, wk, sst, sen, dc))}}
            for name, t in times.items():
                t["shape"] = f"{cut} shard rows x {n}, d={pts.shape[1]}"
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    return {"times": times, "k9_computed": computed}


# ------------------------------------------------------------ bf16 (K12-K14)
def bf16_kernels():
    """K12, K13, K14 and their plain versions, as the checks call them
    (``sel``: a gate, or None for the ungated form)."""
    from repro_torch.kernels import ops, sweep

    def k12(x, y, d_cut, sel=None):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel, precision="bf16")

    def k12_plain(x, y, d_cut, sel=None):
        c, v, i = sweep.fused_count_topk_bf16_plain(
            x, y, sweep.d2cut_of(d_cut), sel=None if sel is None
            else sel.bool())
        return c.to(torch.float32), v, i

    def k13(x, y, d_cut, wl, sel=None, live=None):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel, worklist=wl,
                               live=live, precision="bf16")

    def k13_plain(x, y, d_cut, wl, sel=None):
        c, v, i = sweep.worklist_count_topk_bf16_plain(
            x, y, sweep.d2cut_of(d_cut), wl, sel=None if sel is None
            else sel.bool())
        return c.to(torch.float32), v, i

    def k14(x, b, signs, d_cut, wl):
        return ops.local_density_delta(x, b, signs, d_cut, worklist=wl)

    def k14_plain(x, b, signs, d_cut, wl):
        return sweep.worklist_range_count_signed_plain(
            x, b, signs, sweep.d2cut_of(d_cut), wl)

    return k12, k12_plain, k13, k13_plain, k14, k14_plain


def bf16_bound_ms(nbytes: float, tc_ops: float,
                  f32_ops: float) -> tuple[float, str]:
    """The least time for a bf16 sweep's work: bytes over the memory rate,
    the cross term's operations over the bf16 tensor-core peak, or the
    epilogue's over the f32 lane issue rate, whichever is largest."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tc_ops / BF16_TC_OPS_PER_S, f32_ops / F32_ISSUE_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def bf16_work(n: int, m: int, d: int, pairs: float, sel=None,
              wl=None) -> tuple[float, float, float]:
    """Bytes, tensor-core operations and f32 operations of K12 (K13 given
    its worklist): x, y (and the gate) and the worklist read once, the
    outputs written once, K12's record pack (kernels/packing.py: the bf16
    records, the two f32 norms a column and the gate bytes, written once
    and read once); per pair 2 * 16 * ceil(d / 16) operations on the
    tensor cores (d padded to the MMA's k) and 2 f32 ones, the superset
    test xy >= lim + y2 * (1/2 - 2^-21) that every pair needs (an add and
    a compare); the exact epilogue on the few pairs that pass it is not
    counted."""
    from repro_torch.kernels.packing import BF16_GROUP, bf16_record_width
    nbytes = 4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
    if sel is not None:
        nbytes += m
    if wl is not None:
        nbytes += 4 * wl.row_ptr.numel() + 9 * wl.n_kept
    else:
        m16 = -(-m // BF16_GROUP) * BF16_GROUP
        nbytes += 2 * m16 * (2 * bf16_record_width(d) + 8
                             + (sel is not None))
    return nbytes, pairs * 32 * -(-d // 16), pairs * 2.0


def bf16_ptxas(log: str) -> dict:
    """Registers and spill bytes of each K12 and K13 instantiation in the
    build's ptxas log, by kernel, the d it serves and its gate."""
    from repro_torch.kernels.build import ptxas_usage
    kinds = {"1": "d<=8", "2": "d<=16", "0": "any d"}
    out: dict = {"K12": {}, "K13": {}}
    for name, u in ptxas_usage(log).items():
        for kernel, tag in (("fused_count_topk_bf16_kernel", "K12"),
                            ("worklist_count_topk_bf16_kernel", "K13")):
            if kernel in name:
                args = name.split(kernel + "ILi")[1]
                gated = " gated" if args[4] == "1" else ""
                out[tag][f"{kinds[args[0]]}{gated}"] = u
    return out


def k13_walk(wl, live: torch.Tensor) -> dict:
    """K13's walk from its ``live`` counts: the entries computed (total,
    the most in a row tile) and the row tiles whose walk ended past the
    split, before the end of their segment (the in_cut entries lead, and
    K13 computes them all)."""
    from repro_torch.kernels import packing
    seg = (wl.row_ptr[1:] - wl.row_ptr[:-1]).long()
    split = (packing.phase_split(wl) - wl.row_ptr[:-1]).long()
    live = live.long()
    return {"computed": int(live.sum()),
            "computed_max_tile": int(live.max()) if live.numel() else 0,
            "ended_past_split": int(((live < seg) & (live >= split)).sum()),
            "row_tiles": wl.num_row_tiles}


def k13_pairs(wl, n: int, m: int, live: torch.Tensor) -> float:
    """The pairs K13 computed: in each row tile, its real rows times the
    columns of the entries it computed (``live`` of them; taken as the
    first, whose lb are the least, since the in-d_cut entries lead and the
    NN-live ones follow)."""
    width = entry_widths(wl, m)
    cum = torch.zeros(wl.n_kept + 1, dtype=torch.int64, device=width.device)
    cum[1:] = torch.cumsum(width, 0)
    ptr = wl.row_ptr.long()
    cols = cum[ptr[:-1] + live.long()] - cum[ptr[:-1]]
    return float((tile_rows(wl, n) * cols).sum())


def bf16_tau(x2, y2, d: int) -> torch.Tensor:
    """The stated tolerance of a bf16 pair's d2 between a kernel and its
    plain version, ``d * 2^-20 * (|x|^2 + |y|^2)``: the tensor cores' sum
    of the exact bf16 products and the in-order f32 sum each stay within
    about d ulps of sum_k |x_k y_k| <= (|x|^2 + |y|^2) / 2, and d2 takes
    twice the cross term; 2^-20 leaves a factor of 4 over that."""
    return d * 2.0 ** -20 * (x2 + y2)


def bf16_within_tolerance(name: str, x, y, d_cut, got, want,
                          sel=None) -> dict:
    """A bf16 kernel against its plain version on data where the
    tensor-core sums may round apart: every count that differs has a pair
    whose plain d2 lies within ``bf16_tau`` of d2cut; every kept index that
    only one side holds has a plain d2 within twice the tolerance of the
    row's plain 8th kept value; every kept index both hold has its two d2
    within the tolerance.  Returns the rows whose count / kept set differ
    and the max abs error of the kept d2 both hold."""
    from repro_torch.kernels import sweep
    d = x.shape[1]
    thr = sweep.d2cut_of(d_cut)
    x2, y2 = sweep.sq_norms(x), sweep.sq_norms(y)
    gc, gv, gi = got
    wc, wv, wi = want
    rows_c = torch.nonzero(gc != wc).flatten()
    for r0 in range(0, rows_c.numel(), 256):
        rr = rows_c[r0:r0 + 256]
        d2 = sweep.expanded_d2_bf16(x[rr], y, x2[rr], y2)
        near = ((d2 - thr).abs() <= bf16_tau(x2[rr, None], y2[None], d))
        assert bool(near.any(1).all()), \
            f"{name}: a count differs with no pair within the tolerance"
    same = (gi == wi).all(1)
    ok_i = gi >= 0
    tau = bf16_tau(x2[:, None], y2[gi.clamp_min(0).long()], d)
    close = ((gv - wv).abs() <= tau) | ~ok_i
    assert bool(close[same].all()), \
        f"{name}: a kept d2 differs beyond the tolerance"
    both = same[:, None] & ok_i
    err = float((gv - wv)[both].abs().max()) if bool(both.any()) else 0.0
    rows_k = torch.nonzero(~same).flatten()
    for r in rows_k.tolist():
        g = dict(zip(gi[r].tolist(), gv[r].tolist()))
        w = dict(zip(wi[r].tolist(), wv[r].tolist()))
        g.pop(-1, None)
        w.pop(-1, None)
        for j in set(g) & set(w):
            t = float(bf16_tau(x2[r], y2[j], d))
            assert abs(g[j] - w[j]) <= t, \
                f"{name}: row {r} keeps {j} at d2 apart beyond the tolerance"
            err = max(err, abs(g[j] - w[j]))
        only = torch.tensor(sorted(set(g) ^ set(w)), dtype=torch.long,
                            device=x.device)
        if only.numel():
            d2 = sweep.expanded_d2_bf16(x[r:r + 1], y[only], x2[r:r + 1],
                                        y2[only])[0]
            t = bf16_tau(x2[r], y2[only], d)
            assert bool(((d2 - wv[r, -1]).abs() <= 2 * t).all()), \
                f"{name}: row {r} keeps another column away from a tie"
    return {"count_rows_differ": rows_c.numel(),
            "kept_rows_differ": rows_k.numel(), "max_abs_err": err}


def bf16_lattice(n: int, d: int, sexp: int, seed: int, high: int = 256):
    """Integer lattice points in [0, high)^d times 2^sexp, f32, and a d_cut
    whose square is a half integer times 4^sexp near the 30-neighbour
    quantile (the reference's ``_lattice`` rule: it never ties an integer
    d2).  Every norm, product and partial sum of the bf16 expanded form is
    an exact integer times 4^sexp, so K12/K13 equal their plain versions,
    and the f32 sweep, bit for bit."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, high, (n, d)).astype(np.float64)
    probe = ints[:min(n, 64)]
    d2 = ((probe[:, None, :] - ints[None]) ** 2).sum(-1)
    k = int(np.quantile(d2, min(30.0 / n, 0.5)))
    pts = (ints * 2.0 ** sexp).astype(np.float32)
    return pts, float(np.sqrt((k + 0.5) * 4.0 ** sexp))


def bf16_gates(m: int, seed: int):
    """(label, gate) pairs: none, 40 % of the columns, 5 columns."""
    rng = np.random.default_rng(seed)
    few = np.zeros(m, bool)
    few[rng.permutation(m)[:5]] = True
    return [("ungated", None), ("40%", rng.uniform(size=m) < 0.4),
            ("5 columns", few)]


def bf16_check_shapes(card: str) -> dict:
    """Phase 19: K12 and K13, gated and not, at check shapes; K14 on shard
    shapes; their times at 65,536 rows."""
    from repro_torch.core.grid import build_grid
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.distributed import dpc as ddpc
    from repro_torch.kernels import blocksparse, ops, sweep
    k12, k12_plain, k13, k13_plain, k14, k14_plain = bf16_kernels()
    dev = torch.device("cuda")

    def counts_of(sel):
        return None if sel is None else sel_counts(sel)

    lat = np.stack(np.meshgrid(np.arange(128), np.arange(128)), -1)
    lattices = [("128x128 sites", lat.reshape(-1, 2).astype(np.float32), 2.5)]
    for n, d, sexp, high in ((65536, 3, 3, 256), (1000, 2, -2, 256),
                             (1000, 8, 0, 256), (1000, 16, 1, 256),
                             (1000, 17, -1, 256), (300, 64, 0, 16)):
        pts, dc = bf16_lattice(n, d, sexp, seed=d, high=high)
        lattices.append((f"ints [0,{high})^{d} x 2^{sexp}", pts, dc))
    rec: dict = {"lattice": {}, "unit": {}, "k14": {}}
    for label, pts, dc in lattices:
        x = torch.from_numpy(pts).to(dev)
        if pts.shape[1] <= 8:       # the drivers' layout: grid-sorted
            x = build_grid(x, dc).points
        n = x.shape[0]
        gates = bf16_gates(n, seed=n)
        for glabel, g in gates if n <= 20000 else gates[:2]:
            sel = None if g is None else torch.from_numpy(g).to(dev)
            wl = blocksparse.build_flat_worklist(
                x, x, dc, nn_col_counts=counts_of(sel))
            what = f"[lattice {label}, n={n}, {glabel}]"
            dense = k12(x, x, dc, sel)
            check_equal(f"fused_count_topk_bf16 {what}", dense,
                        k12_plain(x, x, dc, sel))
            check_equal(f"fused_count_topk_bf16 {what}", dense,
                        ops.fused_sweep(x, x, dc, nn_sel=sel), "f32 K1")
            if n <= 20000:          # ragged rows and columns, < 8 columns
                for r, c in ((n - 3, 5), (257, n // 3)):
                    xr, yc = x[:r].contiguous(), x[-c:].contiguous()
                    sc = None if sel is None else sel[-c:].contiguous()
                    check_equal(f"fused_count_topk_bf16 {what} {r} x {c}",
                                k12(xr, yc, dc, sc),
                                k12_plain(xr, yc, dc, sc))
            live = torch.zeros(wl.num_row_tiles, dtype=torch.int32,
                               device=dev)
            sparse = k13(x, x, dc, wl, sel, live)
            check_equal(f"worklist_count_topk_bf16 {what}", sparse,
                        k13_plain(x, x, dc, wl, sel))
            check_equal(f"worklist_count_topk_bf16 {what}", sparse, dense,
                        "K12")
            rec["lattice"][f"{label} {glabel}"] = {
                "n": n, "d": pts.shape[1], "kept": wl.n_kept,
                "total": wl.n_total, "computed": int(live.sum())}
            print(f"K12 == plain == f32 K1 and K13 == plain == K12, bit for "
                  f"bit {what}: {int(live.sum())} of {wl.n_kept} entries "
                  f"computed", flush=True)

    # unit-scale data: within the stated tolerance
    for n, d in ((4096, 3), (1000, 16), (300, 64)):
        pts = np.random.default_rng(n + d).uniform(
            size=(n, d)).astype(np.float32)
        x = torch.from_numpy(pts).to(dev)
        if d <= 8:
            x = build_grid(x, 0.1).points
        dc = pick_dcut(pts, target_rho=30)
        for glabel, g in bf16_gates(n, seed=d)[:2]:
            sel = None if g is None else torch.from_numpy(g).to(dev)
            wl = blocksparse.build_flat_worklist(
                x, x, dc, nn_col_counts=counts_of(sel))
            what = f"[unit n={n} d={d}, {glabel}]"
            r12 = bf16_within_tolerance(f"fused_count_topk_bf16 {what}", x,
                                        x, dc, k12(x, x, dc, sel),
                                        k12_plain(x, x, dc, sel))
            r13 = bf16_within_tolerance(f"worklist_count_topk_bf16 {what}",
                                        x, x, dc, k13(x, x, dc, wl, sel),
                                        k13_plain(x, x, dc, wl, sel))
            rec["unit"][f"n={n} d={d} {glabel}"] = {"k12": r12, "k13": r13}
            print(f"K12 and K13 == plain within d*2^-20*(|x|^2+|y|^2) "
                  f"{what}: K12 {r12}, K13 {r13}", flush=True)

    # K14 on shard shapes: padded 1e9 rows, a ragged shard
    cases = [("airline", real_proxy("airline", N_CHECK, seed=0)[0]),
             ("mixture d=2", gaussian_mixture(1000, d=2, seed=2)[0]),
             ("normal d=64", np.random.default_rng(64).normal(
                 size=(300, 64)).astype(np.float32))]
    for label, pts in cases:
        x = torch.from_numpy(pts).to(dev)
        dc = pick_dcut(pts, target_rho=30)
        xs = build_grid(x, dc).points if pts.shape[1] <= 8 else x
        n = xs.shape[0]
        m = -(-n // 3) * 3 + 3
        tbl = ddpc._pad_rows(xs, m, sweep.PAD_COORD)
        rng = np.random.default_rng(n)
        pick = torch.from_numpy(np.sort(rng.permutation(n)[:512])).to(dev)
        batch = xs[pick].contiguous()
        signs = torch.from_numpy(rng.choice(
            [-1.0, 0.0, 1.0], pick.numel()).astype(np.float32)).to(dev)
        per = m // 3
        cut = per - 37 if per > 300 else per
        for s in range(3):
            r0, r1 = s * per, (s * per + cut if s == 1 else (s + 1) * per)
            q = tbl[r0:r1]
            wl = blocksparse.build_flat_worklist(q, batch, dc, nn=None)
            got = k14(q, batch, signs, dc, wl)
            check_equal(f"worklist_range_count_signed [{label}, shard {s}]",
                        [got], [k14_plain(q, batch, signs, dc, wl)])
            check_equal(f"worklist_range_count_signed [{label}, shard {s}]",
                        [got], [ops.local_density_delta(q, batch, signs, dc)],
                        "dense K5")
        print(f"K14 == plain == dense K5, bit for bit: {label}, three "
              f"shards of {per} rows (1e9 padding, one ragged) x a batch of "
              f"{pick.numel()}", flush=True)

    # times at 65,536 rows: the Airline proxy, grid-sorted
    pts = cases[0][1]
    dc = pick_dcut(pts, target_rho=30)
    xs = build_grid(torch.from_numpy(pts).to(dev), dc).points
    wl = blocksparse.build_flat_worklist(xs, xs, dc)
    batch = xs[torch.randperm(N_CHECK, generator=torch.Generator(
        ).manual_seed(0))[:4096].sort().values.to(dev)].contiguous()
    signs = torch.ones(4096, device=dev)
    signs[1::2] = -1.0
    wl14 = blocksparse.build_flat_worklist(xs, batch, dc, nn=None)
    times = {
        "fused_count_topk_bf16": {
            "ms": time_ms(lambda: k12(xs, xs, dc)),
            "plain_ms": timed_once(lambda: k12_plain(xs, xs, dc))[1],
            "k1_ms": time_ms(lambda: ops.fused_sweep(xs, xs, dc))},
        "worklist_count_topk_bf16": {
            "ms": time_ms(lambda: k13(xs, xs, dc, wl)),
            "plain_ms": timed_once(lambda: k13_plain(xs, xs, dc, wl))[1],
            "k3_ms": time_ms(lambda: ops.fused_sweep(xs, xs, dc,
                                                     worklist=wl))},
        "worklist_range_count_signed": {
            "ms": time_ms(lambda: k14(xs, batch, signs, dc, wl14)),
            "plain_ms": timed_once(lambda: k14_plain(xs, batch, signs, dc,
                                                     wl14))[1],
            "k5_ms": time_ms(lambda: ops.local_density_delta(xs, batch,
                                                             signs, dc))}}
    for name, t in times.items():
        print(f"{name} [n={N_CHECK} d=3 Airline, grid-sorted]: " + ", ".join(
            f"{k} {v:.3f}" for k, v in t.items()) + f"  ({card})", flush=True)
    rec["times"] = times
    return rec


# ------------------------------------ halo worklist forms (K15, K16)
def halo_wl_kernels():
    """K15, K16 and their plain versions, as the checks call them."""
    from repro_torch.kernels import ops, sweep

    def k15(x, win, st, en, d_cut, wl):
        return ops.halo_density(x, win, st, en, d_cut, worklist=wl)

    def k15_plain(x, win, st, en, d_cut, wl):
        return sweep.worklist_halo_range_count_plain(
            x, win, st, en, sweep.d2cut_of(d_cut), wl).float()

    def k16(x, xk, win, wk, st, en, d_cut, wl, live=None):
        return ops.halo_dependent(x, xk, win, wk, st, en, d_cut, worklist=wl,
                                  live=live)

    def k16_plain(x, xk, win, wk, st, en, d_cut, wl):
        best, arg = sweep.worklist_halo_masked_nn_plain(
            x, xk, win, wk, st, en, sweep.d2cut_of(d_cut), wl)
        return torch.sqrt(best), arg, torch.isfinite(best)

    return k15, k15_plain, k16, k16_plain


def span_count_worklist(x, win, st, en, d_cut):
    """K15's span count worklist of x over its window, as
    ``CudaBackend.range_count_halo`` builds it under the block-sparse
    layout."""
    from repro_torch.kernels import blocksparse
    return blocksparse.build_flat_worklist(x, win, d_cut, nn=None,
                                           starts=st, ends=en)


def halo_ring(x, win, st, en, d_cut):
    """K16's halo ring of x over its window, as
    ``CudaBackend.denser_nn_halo`` builds it under the block-sparse
    layout."""
    from repro_torch.kernels import blocksparse
    return blocksparse.build_flat_worklist(x, win, d_cut, count=False,
                                           nn="best1", nn_dcut=True,
                                           starts=st, ends=en)


def tile_mask(wl, nbc: int, entries: torch.Tensor) -> torch.Tensor:
    """(row tiles, nbc) bool: the tile pairs of the worklist entries that
    ``entries`` ((W,) bool) selects."""
    mask = torch.zeros((wl.num_row_tiles, nbc), dtype=torch.bool,
                       device=wl.col_tile.device)
    mask[wl.row_tile()[entries], wl.col_tile.long()[entries]] = True
    return mask


def masked_span_pairs(st, en, w: int, mask: torch.Tensor) -> torch.Tensor:
    """(n,) int64: per row, the window columns inside its spans (clipped
    to [0, w)) whose column tile its row tile computes (``mask``, (row
    tiles, column tiles) bool), from a per-row-tile prefix sum of the
    computed columns: O(n S), not one term per column."""
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    nbr, nbc = mask.shape
    dev = mask.device
    width = (w - torch.arange(nbc, device=dev) * BLOCK_M).clamp(max=BLOCK_M)
    cum = torch.zeros((nbr, nbc + 1), dtype=torch.int64, device=dev)
    cum[:, 1:] = torch.cumsum(mask * width, 1)
    t = (torch.arange(st.shape[0], device=dev) // BLOCK_N)[:, None]

    def upto(c):                 # computed columns left of column c
        j = c // BLOCK_M
        inside = mask[t, j.clamp(max=nbc - 1)] & (j < nbc)
        return cum[t, j] + inside * (c % BLOCK_M)

    a = st.long().clamp(0, w)
    b = torch.maximum(en.long().clamp(0, w), a)
    return (upto(b) - upto(a)).sum(1)


def k15_work(x, win, st, en, wl) -> tuple[float, float]:
    """Bytes and operations of worklist_halo_range_count: x, the window,
    the spans and the worklist (row_ptr, col_tile, in_cut) read once, the
    counts written once; 3d+1 operations per span column inside the in-cut
    entries, every one of which K15 computes."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    (n, d), w = x.shape, win.shape[0]
    mask = tile_mask(wl, -(-w // BLOCK_M), wl.in_cut)
    pairs = float(masked_span_pairs(st, en, w, mask).sum())
    nbytes = (4 * (n * d + w * d) + 8 * st.numel() + 4 * n
              + 4 * wl.row_ptr.numel() + 5 * wl.n_kept)
    return nbytes, pairs * (3 * d + 1)


def k16_work(x, xk, win, wk, st, en, wl, d2cut: float, parent,
             sample: int = 2048, gen=None) -> tuple[float, float, dict]:
    """Bytes and operations of worklist_halo_masked_nn on this run's data.
    Bytes: x, its keys, the window, its keys, the spans and the ring
    (row_ptr, col_tile, lb) read once, (delta, parent, found) written
    once.  Operations, per row: a key test per span column inside the ring
    entries it needs, those whose lb is at most its final best d2 (below
    d_cut^2 where it found none: no pair at or above it counts) and whose
    column tile's largest key is above the row's (rows keyed +inf or NaN
    need none), counted exactly (row, span, tile) by (row, span, tile);
    and 3d+1 for each of those columns that is denser: counted on
    ``sample`` random rows and scaled by their share of the key tests.
    The final best d2 is recomputed from ``parent`` with the kernels'
    arithmetic.  ``info`` also holds the earlier count, on the entries
    each row tile's block-wide walk computed: those whose lb is at most
    the largest final best of its seeking rows (+inf where one found
    none), which is where that walk stopped, since lb ascends."""
    from repro_torch.kernels import packing, sweep
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    (n, d), w = x.shape, win.shape[0]
    dev = x.device
    inf = float("inf")
    nbc = -(-w // BLOCK_M)
    lbt = torch.full((wl.num_row_tiles, nbc), inf, device=dev)
    lbt[wl.row_tile(), wl.col_tile.long()] = wl.lb
    tmax = packing.tile_max_key(wk)
    seeks = xk < inf
    found = parent >= 0
    best = torch.full((n,), inf, device=dev)
    best[found] = sweep.direct_d2(x[found], win[parent[found].long()])
    below = float(np.nextafter(np.float32(d2cut), np.float32(-inf)))
    thr = torch.where(found, best, below)
    tile = torch.arange(n, device=dev) // BLOCK_N
    old_thr = torch.full((wl.num_row_tiles,), -inf, device=dev)
    old_thr.scatter_reduce_(0, tile[seeks], best[seeks], "amax")
    tests = tests_old = 0
    for r, c, cols in span_tile_chunks(st, en, w):
        lb = lbt[tile[r], c]
        tests += int(cols[seeks[r] & (lb <= thr[r])
                          & (tmax[c] > xk[r])].sum())
        tests_old += int(cols[seeks[r] & (lb <= old_thr[tile[r]])].sum())
    rows = torch.nonzero(seeks).flatten()
    rows = rows[torch.randperm(rows.numel(), generator=gen)[:sample]
                .to(dev)]
    s_tests = s_denser = s_old = s_denser_old = 0
    for r0 in range(0, rows.numel(), 256):
        rr = rows[r0:r0 + 256]
        idx, valid = sweep._span_candidates(st[rr], en[rr], w)
        lb = lbt[(rr // BLOCK_N)[:, None, None], idx // BLOCK_M]
        denser = wk[idx] > xk[rr, None, None]
        new = valid & (lb <= thr[rr, None, None]) \
            & (tmax[idx // BLOCK_M] > xk[rr, None, None])
        old = valid & (lb <= old_thr[(rr // BLOCK_N)[:, None, None]])
        s_tests += int(new.sum())
        s_denser += int((new & denser).sum())
        s_old += int(old.sum())
        s_denser_old += int((old & denser).sum())
    denser = tests * s_denser / max(s_tests, 1)
    denser_old = tests_old * s_denser_old / max(s_old, 1)
    nbytes = (4 * (n * d + n + w * d + w) + 8 * st.numel() + 9 * n
              + 4 * wl.row_ptr.numel() + 8 * wl.n_kept)
    ops_old = tests_old + denser_old * (3 * d + 1)
    return nbytes, tests + denser * (3 * d + 1), {
        "key_tests": tests, "denser_est": denser,
        "sample_rows": rows.numel(), "key_tests_earlier": tests_old,
        "ops_earlier": ops_old}


def halo_layout_check(x_key, win, wk, st, en, what: str) -> None:
    """The layouts K11/K16 and, with no key, K10/K15 build on the card
    (``ops.halo_layout``) equal to their plain version
    (``packing.halo_layout``) array for array, both forms of each, the
    records bit for bit."""
    from repro_torch.kernels import ops, packing
    splits = (torch.cuda.get_device_properties(x_key.device)
              .multi_processor_count * ops.HALO_SPLITS_PER_SM)
    for xk, k in ((x_key, wk), (None, None)):
        for ring in (False, True):
            got = ops.halo_layout(xk, win, k, st, en, ring=ring)
            want = packing.halo_layout(xk, win, k, st, en, ring=ring,
                                       splits=splits)
            for name, g, w in zip(got._fields, got, want):
                same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                        if name == "rec" else torch.equal(g, w.to(g.dtype)))
                if not same:
                    raise AssertionError(
                        f"halo layout [{what}, ring={ring}, "
                        f"{'keyed' if xk is not None else 'no key'}]: "
                        f"{name} differs from its plain version")


def halo_worklist_check_shapes(cases, card: str) -> dict:
    """K15/K16 bit for bit against their plain versions and against
    K10/K11 at check shapes: phase 16's cases with d <= 8 (and its lattice
    of exact ties), each grid-sorted table split into three shards as
    ``distributed_dpc`` splits it (rows padded at 1e9, keyed +inf as
    queries and -inf in the window; shard 1 cut to a ragged row count),
    each shard's halo window through the ppermute ring, its window-local
    spans (empty spans negative) plus a reversed and a negative span per
    row.  Entries kept, in-cut and computed (K16) counted; times on the
    first case's shard 1."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid, point_span_bounds
    from repro_torch.distributed import dpc as ddpc
    from repro_torch.kernels import ops, sweep
    from repro_torch.launch import ShardMesh
    _, _, _, _, k10, _, k11, _ = dist_kernels()
    k15, k15_plain, k16, k16_plain = halo_wl_kernels()
    dev = torch.device("cuda")
    mesh = ShardMesh.on(dev, shards=3)
    extra = torch.tensor([[5, 2], [-9, -3]], dtype=torch.int32, device=dev)
    times, entries = {}, {}
    for label, pts, dc in cases:
        if pts.shape[1] > 8:
            continue
        grid = build_grid(torch.from_numpy(pts).to(dev), dc)
        xs = grid.points
        n = xs.shape[0]
        m = -(-n // 3) * 3 + 3                   # three padded rows at least
        key = ops.local_density_xy(xs, xs, dc) + density_jitter(n, dev)
        tbl = ddpc._pad_rows(xs, m, sweep.PAD_COORD)
        tk = ddpc._pad_rows(key, m, float("-inf"))
        qk_p = mesh.shard(ddpc._pad_rows(key, m, float("inf")))
        per = m // 3
        cut = per - 37 if per > 300 else per    # shard 1: a ragged count
        st, en = (ddpc._pad_rows(a, m, 0) for a in point_span_bounds(grid))
        lo, W, hf, hb = ddpc._window_bounds(st, en, 3)
        pts_p = mesh.shard(tbl)
        both = [torch.cat([p, k[:, None]], 1)
                for p, k in zip(pts_p, mesh.shard(tk))]
        wins = ddpc._halo_window(mesh, both, lo, W, hf, hb)
        shard_in = []
        for s in range(3):
            r = cut if s == 1 else per
            q, qk = pts_p[s][:r].contiguous(), qk_p[s][:r].contiguous()
            win = wins[s][:, :-1].contiguous()
            wk = wins[s][:, -1].contiguous()
            sst = torch.cat([mesh.shard(st)[s][:r] - lo[s],
                             extra[:, 0].expand(r, 2)], 1).contiguous()
            sen = torch.cat([mesh.shard(en)[s][:r] - lo[s],
                             extra[:, 1].expand(r, 2)], 1).contiguous()
            halo_layout_check(qk, win, wk, sst, sen, f"{label}, shard {s}")
            cwl = span_count_worklist(q, win, sst, sen, dc)
            ring = halo_ring(q, win, sst, sen, dc)
            got = k15(q, win, sst, sen, dc, cwl)
            check_equal(f"worklist_halo_range_count [{label}, shard {s}]",
                        [got], [k15_plain(q, win, sst, sen, dc, cwl)])
            check_equal(f"worklist_halo_range_count [{label}, shard {s}]",
                        [got], [k10(q, win, sst, sen, dc)], "K10")
            live = torch.zeros((ring.num_row_tiles, 2), dtype=torch.int32,
                               device=dev)
            got = k16(q, qk, win, wk, sst, sen, dc, ring, live)
            check_equal(f"worklist_halo_masked_nn [{label}, shard {s}]", got,
                        k16_plain(q, qk, win, wk, sst, sen, dc, ring))
            check_equal(f"worklist_halo_masked_nn [{label}, shard {s}]", got,
                        k11(q, qk, win, wk, sst, sen, dc), "K11")
            entries[f"{label} shard {s}"] = {
                "count_kept": cwl.n_kept, "in_cut": int(cwl.in_cut.sum()),
                "ring": ring.n_kept, "k16_computed": int(live[:, 0].sum()),
                "k16_longest": int(live[:, 1].max()), "total": cwl.n_total}
            shard_in.append((q, qk, win, wk, sst, sen, cwl, ring))
        print(f"worklist_halo_range_count == plain == K10, "
              f"worklist_halo_masked_nn == plain == K11, bit for bit: "
              f"{label}, n={n} d={pts.shape[1]}, 3 shards (shard 1 {cut} "
              f"rows), W={W}; per shard (in-cut of kept; entries K16's "
              f"pieces computed, its longest walk, the ring): " + ", ".join(
                  f"{e['in_cut']}/{e['count_kept']}; {e['k16_computed']}, "
                  f"{e['k16_longest']}, {e['ring']}"
                  for k, e in entries.items() if k.startswith(label + " ")),
              flush=True)
        if not times:
            q, qk, win, wk, sst, sen, cwl, ring = shard_in[1]
            times = {
                "worklist_halo_range_count": {
                    "ms": time_ms(lambda: k15(q, win, sst, sen, dc, cwl)),
                    "plain_ms": time_ms(lambda: k15_plain(q, win, sst, sen,
                                                          dc, cwl)),
                    "k10_ms": time_ms(lambda: k10(q, win, sst, sen, dc))},
                "worklist_halo_masked_nn": {
                    "ms": time_ms(lambda: k16(q, qk, win, wk, sst, sen, dc,
                                              ring)),
                    "plain_ms": time_ms(lambda: k16_plain(
                        q, qk, win, wk, sst, sen, dc, ring)),
                    "k11_ms": time_ms(lambda: k11(q, qk, win, wk, sst, sen,
                                                  dc))}}
            for name, t in times.items():
                t["shape"] = f"{cut} shard rows, W={W}, d={pts.shape[1]}"
                print(f"{name} [{t['shape']}]: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in t.items() if k != "shape")
                    + f"  ({card})", flush=True)
    return {"times": times, "entries": entries}


def halo_worklist_full(calls10, calls11, row_tile_slice, card: str,
                       gen, regs: dict) -> dict:
    """Phase 23 at full width: every shard input that phase 17's counted
    halo fit gave K10 (``calls10``) and K11 (``calls11``), through
    ``CudaBackend.range_count_halo`` / ``denser_nn_halo(layout=
    "block-sparse")`` with the launch counts zeroed just before and read
    just after (K15/K16 must launch, nothing else may); each result equal
    to K10/K11 bit for bit; K15/K16 against their plain versions on a few
    row tiles of the first shard; medians of five CUDA-event runs of each
    kernel and of each worklist build, summed over the shards; kept,
    in-cut and computed entries, K16's longest walk; bounds from the
    inputs (K16's recounted on the entries each row needs, the earlier
    count beside it); the rows per run; K16's registers and spills
    (``regs``, from ``halo_ptxas``)."""
    from repro_torch.kernels import ops, sweep
    from repro_torch.kernels.backend import get_backend
    _, _, _, _, k10, _, k11, _ = dist_kernels()
    k15, k15_plain, k16, k16_plain = halo_wl_kernels()
    be = get_backend("cuda")
    ops.reset_launch_counts()
    got15 = [be.range_count_halo(*a, span_cap=0, layout="block-sparse")
             for a in calls10]
    got16 = [be.denser_nn_halo(*a, span_cap=0, layout="block-sparse")
             for a in calls11]
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    assert {k: v for k, v in launched.items() if v} == {
        "worklist_halo_range_count": len(calls10),
        "worklist_halo_masked_nn": len(calls11)}, launched
    for s, (a, g) in enumerate(zip(calls10, got15)):
        check_equal(f"worklist_halo_range_count [main path, shard {s}]", [g],
                    [k10(*a)], "K10")
    for s, (a, g) in enumerate(zip(calls11, got16)):
        check_equal(f"worklist_halo_masked_nn [main path, shard {s}]", g,
                    k11(*a), "K11")
    del got15, got16

    rec = {"launches": launched, "shards": []}
    tot = {"k15_ms": 0.0, "k16_ms": 0.0, "k15_build_ms": 0.0,
           "k16_build_ms": 0.0, "k10_ms": 0.0, "k11_ms": 0.0,
           "k15_layout_ms": 0.0}
    work15, work16 = [0.0, 0.0], [0.0, 0.0, 0.0]
    first = None
    for a10, a11 in zip(calls10, calls11):
        x, win, st, en, dc = a10
        x11, xk, win11, wk, st11, en11, _ = a11
        halo_layout_check(xk, win11, wk, st11, en11,
                          f"main path, shard {len(rec['shards'])}")
        cwl = span_count_worklist(*a10)
        ring = halo_ring(x11, win11, st11, en11, dc)
        live = torch.zeros((ring.num_row_tiles, 2), dtype=torch.int32,
                           device=x.device)
        parent = k16(*a11, ring, live)[1]
        t = {"k15_ms": time_ms(lambda: k15(*a10, cwl)),
             "k16_ms": time_ms(lambda: k16(*a11, ring)),
             "k15_build_ms": time_ms(lambda: span_count_worklist(*a10)),
             "k16_build_ms": time_ms(lambda: halo_ring(x11, win11, st11,
                                                       en11, dc)),
             "k10_ms": time_ms(lambda: k10(*a10)),
             "k11_ms": time_ms(lambda: k11(*a11)),
             "k15_layout_ms": time_ms(lambda: ops.halo_layout(
                 None, win, None, st, en, ring=True))}
        for k, v in t.items():
            tot[k] += v
        b15 = k15_work(x, win, st, en, cwl)
        b16 = k16_work(x11, xk, win11, wk, st11, en11, ring,
                       sweep.d2cut_of(dc), parent, gen=gen)
        work15 = [work15[0] + b15[0], work15[1] + b15[1]]
        work16 = [work16[0] + b16[0], work16[1] + b16[1],
                  work16[2] + b16[2]["ops_earlier"]]
        rec["shards"].append({
            "rows": x.shape[0], "window": win.shape[0], "spans": st.shape[1],
            "count_kept": cwl.n_kept, "in_cut": int(cwl.in_cut.sum()),
            "ring": ring.n_kept, "k16_computed": int(live[:, 0].sum()),
            "k16_longest": int(live[:, 1].max()), "total": cwl.n_total,
            "k16_work": b16[2], "runs": halo_runs(st11, en11, win11.shape[0]),
            "k15_pieces": count_pieces(ops.halo_layout(None, win, None, st,
                                                       en, ring=True)),
            **t})
        if first is None:
            first = (a10, a11, cwl, ring)
        del cwl, ring, live, parent

    plain = {}
    for name in ("worklist_halo_range_count", "worklist_halo_masked_nn"):
        a10, a11, cwl, ring = first
        if name == "worklist_halo_range_count":
            x, win, st, en, dc = a10
            sub, rows = row_tile_slice(cwl, x.shape[0], DIST_PLAIN_TILES)
            sl = (x[rows].contiguous(), win, st[rows].contiguous(),
                  en[rows].contiguous(), dc)
            got = [k15(*sl, sub)]
            full = [k15(*a10, cwl)[rows]]
            want, p_ms = timed_once(lambda: [k15_plain(*sl, sub)])
        else:
            x, xk, win, wk, st, en, dc = a11
            sub, rows = row_tile_slice(ring, x.shape[0], DIST_PLAIN_TILES)
            sl = (x[rows].contiguous(), xk[rows].contiguous(), win, wk,
                  st[rows].contiguous(), en[rows].contiguous(), dc)
            got = k16(*sl, sub)
            full = [t[rows] for t in k16(*a11, ring)]
            want, p_ms = timed_once(lambda: k16_plain(*sl, sub))
        check_equal(f"{name} [main path, row tiles]", got, full,
                    "the full call")
        plain[name] = {"err": check_equal(f"{name} [main path, row tiles]",
                                          got, want),
                       "plain_ms": p_ms, "plain_rows": rows.numel()}
    del first
    b16_earlier = bound_ms(work16[0], work16[2])[0]
    rec.update(totals=tot, plain=plain, ptxas=regs, work={
        "worklist_halo_range_count": tuple(work15),
        "worklist_halo_masked_nn": tuple(work16[:2])},
        k16_bound_ms_earlier=b16_earlier)
    sh = rec["shards"]
    for name, key, bkey, work, ref in (
            ("worklist_halo_range_count", "k15_ms", "k15_build_ms", work15,
             "k10_ms"),
            ("worklist_halo_masked_nn", "k16_ms", "k16_build_ms",
             work16[:2], "k11_ms")):
        b_ms, by = bound_ms(*work)
        kept = [e["count_kept" if key == "k15_ms" else "ring"] for e in sh]
        if key == "k15_ms":
            comp = f"entries computed {[e['in_cut'] for e in sh]}"
            more = (f"; its keyless layout alone {tot['k15_layout_ms']:.3f} "
                    f"ms; ptxas (registers, spill bytes) "
                    f"{regs.get('K15', 'not measured')}; pieces a shard "
                    f"(splits, pieces; a column a lane, a row a lane, two "
                    f"rows a lane): " + "; ".join(
                        f"{e['k15_pieces']['splits']}, "
                        f"{e['k15_pieces']['pieces']}; "
                        f"{e['k15_pieces']['col_a_lane']}, "
                        f"{e['k15_pieces']['row_a_lane']}, "
                        f"{e['k15_pieces']['two_rows_a_lane']}"
                        for e in sh))
        else:
            comp = (f"entries its pieces computed "
                    f"{[e['k16_computed'] for e in sh]}, longest walk "
                    f"{max(e['k16_longest'] for e in sh)},")
            more = (f" (earlier count {b16_earlier:.3f}, on each row "
                    f"tile's block-wide walk); ptxas (registers, spill "
                    f"bytes) {regs.get('K16', 'not measured')}")
        print(f"{name} [main path: {len(sh)} shards x "
              f"{[e['rows'] for e in sh]} rows, W {[e['window'] for e in sh]}"
              f", S={sh[0]['spans']}]: == {ref[:3].upper()} bit for bit on "
              f"every shard, == plain on {plain[name]['plain_rows']} rows "
              f"({plain[name]['plain_ms']:.1f} ms); kernel {tot[key]:.3f} ms "
              f"+ worklist builds {tot[bkey]:.3f} ms against "
              f"{ref[:3].upper()} {tot[ref]:.3f} ms; {comp} of kept {kept} "
              f"of {sh[0]['total']} tile pairs a shard; bound {b_ms:.3f} ms "
              f"({by}){more}  ({card})", flush=True)
    runs = [e["runs"] for e in sh]
    print("  rows per run (candidate cell) on the shards: " + "; ".join(
        f"{r['runs']} runs, mean {r['rows_mean']:.2f}, largest "
        f"{r['rows_max']}, {100 * r['share_cols_runs_ge32']:.1f} % of the "
        f"span columns in runs of 32 rows or more" for r in runs),
        flush=True)
    return rec


def run_sharded_stream(pts: np.ndarray, d_cut: float, card: str) -> dict:
    """Phase 24: the Airline stream on DIST_SHARDS logical shards of the
    card beside the single-device stream, both bulk-loaded by
    ``initialize`` on the first N_WINDOW points and fed the same batches;
    equal on every tick.  The sharded stream's counted ticks are counted
    and their K4/K5/K9 inputs kept and held against the plain versions;
    a checkpoint after the second-to-last counted tick restores onto one
    device; a mesh engine streams the mixture beside one without."""
    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.data.points import gaussian_mixture
    from repro_torch.kernels import blocksparse, ops, sweep
    from repro_torch.launch import ShardMesh
    from repro_torch.stream import StreamDPC, StreamDPCConfig
    k4, k4_plain, k5, k5_plain, _, _ = stream_kernels()
    n, B, d, S, ticks = N_WINDOW, STREAM_BATCH, pts.shape[1], DIST_SHARDS, \
        AIR_TICKS
    batches = [pts[n + i * B:n + (i + 1) * B] for i in range(ticks + 3)]
    cfg = StreamDPCConfig(d_cut=d_cut, capacity=n, batch_cap=B, rho_min=10,
                          exec_spec=ExecSpec(layout="block-sparse"))
    sh = StreamDPC(cfg, mesh=ShardMesh.on("cuda", shards=S))
    one = StreamDPC(cfg)
    assert sh.device.type == "cuda" and sh.mesh.size == S

    def same(what, a, ta, b_res, b_cl, tb):
        """The sharded tick against the single-device one (or a kept
        tick), bit for bit: every StreamTick field, rho, rho_key, delta,
        parent, labels and centers."""
        for name in ta._fields:
            assert np.array_equal(np.asarray(getattr(ta, name)),
                                  np.asarray(getattr(tb, name))), \
                f"{what}: {name} differs"
        check_equal(what, [*a.result, a.clustering.labels,
                           a.clustering.centers],
                    [*b_res, b_cl.labels, b_cl.centers],
                    "the single-device stream")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    rec: dict = {"shards": S, "n": n, "d": d, "d_cut": d_cut, "batch": B,
                 "ticks": ticks}
    ta, rec["init_sharded_ms"] = timed(lambda: sh.initialize(pts[:n]))
    tb, rec["init_one_ms"] = timed(lambda: one.initialize(pts[:n]))
    same("initialize", sh, ta, one.result, one.clustering, tb)
    ta, rec["first_tick_sharded_ms"] = timed(lambda: sh.ingest(batches[0]))
    tb, rec["first_tick_one_ms"] = timed(lambda: one.ingest(batches[0]))
    same("first tick", sh, ta, one.result, one.clustering, tb)

    # one traced tick each: the stages' times
    stages = ("stream.tick", "stream.grid_apply", "stream.rho_repair",
              "stream.maxima", "stream.nn_update", "stream.assemble",
              "labels.assign", "stream.continuity")
    traced_ms = {}
    for label, s in (("sharded", sh), ("one", one)):
        obs.configure("trace")
        obs.reset_spans()
        try:
            t = s.ingest(batches[1])
        finally:
            obs.configure("off")
        traced_ms[label] = {}
        for sp in obs.spans():
            traced_ms[label][sp["name"]] = traced_ms[label].get(
                sp["name"], 0.0) + 1e3 * sp["host_s"]
        if label == "sharded":
            ta = t
    same("traced tick", sh, ta, one.result, one.clustering, t)

    # the counted ticks: the sharded tick with the launch counts zeroed
    # just before it and read just after, its K4/K5/K9 inputs kept (the
    # window's shards are views of the table updated in place: cloned)
    names = ("range_count", "range_count_signed", "worklist_masked_nn")
    given: dict[str, list] = {k: [] for k in names}
    launch = (ops.local_density_xy, ops.local_density_delta,
              ops.dependent_masked)
    table = sh.window.device.untyped_storage().data_ptr()

    def keep(t):
        return t.clone() if t.untyped_storage().data_ptr() == table else t

    def rec_k4(x, y, dc, **kw):
        given["range_count"].append((x, keep(y), dc))
        return launch[0](x, y, dc, **kw)

    def rec_k5(x, y, signs, dc, **kw):
        given["range_count_signed"].append((keep(x), y, signs, dc))
        return launch[1](x, y, signs, dc, **kw)

    def rec_k9(x, xk, y, yk, **kw):
        given["worklist_masked_nn"].append((x, xk, keep(y), yk,
                                            kw.get("worklist")))
        return launch[2](x, xk, y, yk, **kw)

    launches = {k: 0 for k in ops.launch_counts()}
    per_tick, kept_ticks = [], {}
    ckpt = ROOT / "build" / "phase24_stream.npz"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    for i in range(2, ticks + 3):
        counted = i < ticks + 2
        if counted:
            (ops.local_density_xy, ops.local_density_delta,
             ops.dependent_masked) = rec_k4, rec_k5, rec_k9
            ops.reset_launch_counts()
        try:
            ta, ms_sh = timed(lambda: sh.ingest(batches[i]))
            got = ops.launch_counts()
        finally:
            (ops.local_density_xy, ops.local_density_delta,
             ops.dependent_masked) = launch
        tb, ms_one = timed(lambda: one.ingest(batches[i]))
        same(f"tick {i}", sh, ta, one.result, one.clustering, tb)
        if i >= ticks + 1:          # the two ticks after the checkpoint
            kept_ticks[i] = (ta, sh.result, sh.clustering)
        if not counted:
            continue
        for k, v in got.items():
            launches[k] += v
        for k in names:
            assert got[k] == S, f"sharded tick {i}: {k} launched {got[k]} " \
                f"times, not once a shard"
        assert got["gather_masked_nn"] == got["masked_nn"] == 0, got
        st = sh.stats()
        per_tick.append({"ms": ms_sh, "one_ms": ms_one,
                         "rebuilt": bool(ta.rebuilt)})
        if i == ticks:              # after the second-to-last counted tick
            _, rec["save_ms"] = timed(lambda: sh.save(str(ckpt)))
            rec["ckpt_bytes"] = ckpt.stat().st_size
    rec["launches"] = launches
    rec["launches_per_tick"] = {k: v / ticks for k, v in launches.items()
                                if v}
    rec["per_tick"] = per_tick
    rec["median_tick_ms"] = statistics.median(t["ms"] for t in per_tick)
    rec["median_tick_one_ms"] = statistics.median(t["one_ms"]
                                                  for t in per_tick)
    rec["traced_ms"] = traced_ms
    rec["stats"] = sh.stats()

    # the checkpoint onto one device: its next two ticks are the sharded
    # run's, bit for bit
    r, rec["restore_ms"] = timed(lambda: StreamDPC.restore(str(ckpt)))
    assert r.mesh is None and r.device.type == "cuda"
    for i in (ticks + 1, ticks + 2):
        t_keep, res_keep, cl_keep = kept_ticks[i]
        tr = r.ingest(batches[i])
        same(f"restored onto one device, tick {i}", r, tr, res_keep,
             cl_keep, t_keep)
    ckpt.unlink()
    del r, kept_ticks

    # each counted launch against its plain version on a slice
    gen = torch.Generator().manual_seed(24)
    rows = TICK_PLAIN_ROWS
    errs = {k: 0.0 for k in names}
    for x4, y4, c4 in given["range_count"]:
        errs["range_count"] = max(errs["range_count"], check_equal(
            "range_count [sharded stream]", [k4(x4[:rows], y4, c4)],
            [k4_plain(x4[:rows], y4, c4)]))
    for x5, y5, s5, c5 in given["range_count_signed"]:
        xs = x5[:K5_PLAIN_ROWS]
        errs["range_count_signed"] = max(
            errs["range_count_signed"], check_equal(
                "range_count_signed [sharded stream]", [k5(xs, y5, s5, c5)],
                [k5_plain(xs, y5, s5, c5)]))
    for x, xk, y, yk, wl in given["worklist_masked_nn"]:
        sub, sr = row_tile_slice(wl, x.shape[0], SHARDED_PLAIN_TILES)
        sx, sk = x[sr].contiguous(), xk[sr].contiguous()
        errs["worklist_masked_nn"] = max(
            errs["worklist_masked_nn"], check_equal(
                "worklist_masked_nn [sharded stream]",
                ops.dependent_masked(sx, sk, y, yk, worklist=sub,
                                     squared=True),
                sweep.worklist_masked_nn_plain(sx, sk, y, yk, sub)))
    rec["max_abs_err"] = errs

    # the last counted tick's per-shard inputs: K4, K5 and K9 as routed
    # (the best-1 ring built, then K9), K9 on the kept ring and dense K2
    k9_calls = given["worklist_masked_nn"][-S:]
    shard = {"k4_ms": 0.0, "k5_ms": 0.0, "k9_ms": 0.0, "route_ms": 0.0,
             "ring_ms": 0.0, "k2_ms": 0.0, "entries": 0, "longest": 0,
             "ring": 0}
    work = {"range_count": [0.0, 0.0], "range_count_signed": [0.0, 0.0],
            "worklist_masked_nn": [0.0, 0.0], "masked_nn": [0.0, 0.0]}
    for x4, y4, c4 in given["range_count"][-S:]:
        shard["k4_ms"] += time_ms(lambda: k4(x4, y4, c4))
        for j, v in enumerate(k4_work(x4.shape[0], y4.shape[0], d)):
            work["range_count"][j] += v
    for x5, y5, s5, c5 in given["range_count_signed"][-S:]:
        shard["k5_ms"] += time_ms(lambda: k5(x5, y5, s5, c5))
        for j, v in enumerate(k5_work(x5.shape[0], y5.shape[0], d)):
            work["range_count_signed"][j] += v
    for x, xk, y, yk, wl in k9_calls:
        (d9, p9), entries, longest = k9_walks(x, xk, y, yk, wl)
        check_equal("worklist_masked_nn [sharded stream, last tick]",
                    (d9, p9), ops.dependent_masked(x, xk, y, yk), "dense K2")
        shard["entries"] += entries
        shard["longest"] = max(shard["longest"], longest)
        shard["ring"] += wl.n_kept
        shard["k9_ms"] += time_ms(lambda: ops.dependent_masked(
            x, xk, y, yk, worklist=wl), reps=3)
        shard["route_ms"] += time_ms(lambda: ops.dependent_masked(
            x, xk, y, yk, worklist=blocksparse.build_flat_worklist(
                x, y, count=False, nn="best1")), reps=3)
        shard["ring_ms"] += time_ms(lambda: blocksparse.build_flat_worklist(
            x, y, count=False, nn="best1"), reps=3)
        shard["k2_ms"] += time_ms(lambda: ops.dependent_masked(
            x, xk, y, yk), reps=3)
        b9, o9, _ = k9_work(x, xk, y, yk, wl, torch.square(d9), sample=256,
                            gen=gen)
        b2, o2 = k2_work(xk, yk, d)
        work["worklist_masked_nn"][0] += b9
        work["worklist_masked_nn"][1] += o9
        work["masked_nn"][0] += b2
        work["masked_nn"][1] += o2
    bounds = {k: bound_ms(*v) for k, v in work.items()}
    rec["last_tick"] = {**shard, "rows": [c[0].shape[0] for c in k9_calls],
                        "shard_rows": k9_calls[0][2].shape[0],
                        "bounds": {k: {"bound_ms": b, "bound_by": by}
                                   for k, (b, by) in bounds.items()}}
    del given, k9_calls

    print(f"sharded Airline stream: window {n} on {S} logical shards, d={d}, "
          f"d_cut={d_cut!r}, block-sparse, {ticks} counted ticks of {B}: "
          f"median tick {rec['median_tick_ms']:.2f} ms against the "
          f"single-device stream's {rec['median_tick_one_ms']:.2f} ms beside "
          f"it; every tick equal bit for bit (StreamTick, rho, rho_key, "
          f"delta, parent, labels, centers); initialize {rec['init_sharded_ms']:.1f} "
          f"/ {rec['init_one_ms']:.1f} ms, first tick "
          f"{rec['first_tick_sharded_ms']:.1f} / "
          f"{rec['first_tick_one_ms']:.1f} ms  ({card})", flush=True)
    print(f"  launches per sharded tick {rec['launches_per_tick']}; "
          f"maxima re-queried/total {sh.stats()['nn_queries']}/"
          f"{sh.stats()['nn_maxima_total']} over all ticks", flush=True)
    for name in stages:
        print(f"  traced {name}: sharded "
              f"{traced_ms['sharded'].get(name, 0.0):.2f} ms, one device "
              f"{traced_ms['one'].get(name, 0.0):.2f} ms")
    print(f"  checkpoint after tick {ticks}: {rec['ckpt_bytes']} bytes, save "
          f"{rec['save_ms']:.1f} ms, restore onto one device "
          f"{rec['restore_ms']:.1f} ms; its next two ticks == the sharded "
          f"run's bit for bit  ({card})", flush=True)
    lt = rec["last_tick"]
    print(f"  every counted launch == plain, bit for bit (K4 on {rows} rows, "
          f"K5 on {K5_PLAIN_ROWS} shard rows, K9 on {SHARDED_PLAIN_TILES} "
          f"row tiles a call); last tick, summed over the shards "
          f"({lt['rows'][0]} query rows x {lt['shard_rows']} shard rows): "
          f"K4 {lt['k4_ms']:.3f} ms (bound "
          f"{bounds['range_count'][0]:.3f}), K5 {lt['k5_ms']:.3f} ms (bound "
          f"{bounds['range_count_signed'][0]:.3f}); K9 {lt['k9_ms']:.3f} ms "
          f"(+ ring {lt['ring_ms']:.3f}: route {lt['route_ms']:.3f} ms; "
          f"bound {bounds['worklist_masked_nn'][0]:.3f}, entries computed "
          f"{lt['entries']} of {lt['ring']}, longest walk {lt['longest']}) "
          f"against dense K2 {lt['k2_ms']:.3f} ms (bound "
          f"{bounds['masked_nn'][0]:.3f}), equal bit for bit  ({card})",
          flush=True)

    # a mesh engine streams the mixture, equal to the engine without one
    mix, _ = gaussian_mixture(ENGINE_WINDOW + ENGINE_TICKS * B, k=15, d=2,
                              seed=0)
    kw = dict(rho_min=10, window_capacity=ENGINE_WINDOW, batch_cap=B)
    ea = DPCEngine(2000.0, mesh=ShardMesh.on("cuda", shards=S), **kw)
    eb = DPCEngine(2000.0, **kw)
    eng_launches = {k: 0 for k in ops.launch_counts()}
    eng_ms = []
    for t in range(ENGINE_TICKS + 1):
        batch = mix[:ENGINE_WINDOW] if t == 0 else \
            mix[ENGINE_WINDOW + (t - 1) * B:ENGINE_WINDOW + t * B]
        ops.reset_launch_counts()
        ta, ms = timed(lambda: ea.partial_fit(batch))
        got = ops.launch_counts()
        tb = eb.partial_fit(batch)
        same(f"mesh engine, partial_fit {t}", ea.stream, ta,
             eb.stream.result, eb.stream.clustering, tb)
        assert np.array_equal(ea.labels_, eb.labels_)
        if t:
            eng_ms.append(ms)
            assert got["masked_nn"] == S and got["range_count"] == S \
                and got["range_count_signed"] == S \
                and got["gather_masked_nn"] == 0, got
            for k, v in got.items():
                eng_launches[k] += v
    rec["engine"] = {"window": ENGINE_WINDOW, "ticks": ENGINE_TICKS,
                     "median_tick_ms": statistics.median(eng_ms),
                     "launches": eng_launches}
    print(f"  DPCEngine(2000.0, mesh=ShardMesh.on('cuda', shards={S}), "
          f"window_capacity={ENGINE_WINDOW}).partial_fit on the mixture: "
          f"{ENGINE_TICKS} ticks == the engine without a mesh, bit for bit; "
          f"median tick {rec['engine']['median_tick_ms']:.2f} ms; dense: "
          f"K2 masked_nn, K4, K5 once a shard a tick  ({card})", flush=True)
    return rec


def hold_against(x, got, want, d_cut: float, what: str) -> dict:
    """A ``torch`` fit of the table ``x`` against the ``cuda`` fit of the same
    input: both on the card; rho equal off the 4-ulp band around d_cut^2
    (each differing row is shown to have a pair there, in float64); delta
    equal to f32 rounding (rtol 1e-6, the same rows infinite); parents
    equal except rows shown to be exact distance ties; labels (rho_min 10,
    delta_min 2 d_cut) equal away from the rows downstream of such a
    parent.  Returns the counts."""
    from repro_torch.core.labels import assign_labels
    from repro_torch.kernels.sweep import direct_d2
    for t in got:
        assert t.is_cuda, f"{what}: the torch fit returned a host tensor"
    thr = float(np.float32(d_cut) ** 2)
    ulp = float(np.spacing(np.float32(thr)))
    rows = torch.nonzero(got.rho != want.rho).flatten()
    x64 = x.double()
    for r in rows.tolist():
        d2 = ((x64 - x64[r]) ** 2).sum(1)
        assert bool(((d2 - thr).abs() <= 4 * ulp).any()), \
            f"{what}: rho of row {r} differs off the threshold band"
    assert torch.equal(torch.isinf(got.delta), torch.isinf(want.delta)), \
        f"{what}: delta is infinite on other rows"
    fin = torch.isfinite(want.delta)
    assert torch.allclose(got.delta[fin], want.delta[fin], rtol=1e-6,
                          atol=0.0), f"{what}: delta differs"
    differ = got.parent != want.parent
    prow = torch.nonzero(differ).flatten()
    pa, pb = got.parent[prow].long(), want.parent[prow].long()
    assert bool((pa >= 0).all() and (pb >= 0).all() and torch.equal(
        direct_d2(x[prow], x[pa]), direct_d2(x[prow], x[pb]))), \
        f"{what}: a parent differs without an exact distance tie"
    la = assign_labels(got, 10.0, 2 * d_cut).labels
    lb = assign_labels(want, 10.0, 2 * d_cut).labels
    tied = downstream(got.parent, differ) | downstream(want.parent, differ)
    assert torch.equal(la[~tied], lb[~tied]), \
        f"{what}: labels differ away from tie-decided parents"
    return {"rho_in_band": rows.numel(), "tied_parents": prow.numel(),
            "downstream": int(tied.sum()), "labels_differ": int(
                (la != lb).sum())}


def run_reference_backend(main_pts: np.ndarray, d_cut: float,
                          card: str) -> dict:
    """Phase 25: the ``torch`` reference backend on the card at its default
    chunks, every fit held against the ``cuda`` backend's fit of the same
    input in this run, and none launching a kernel of the port."""
    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.core.approxdpc import run_approxdpc
    from repro_torch.core.exdpc import run_exdpc
    from repro_torch.core.sapproxdpc import run_sapproxdpc
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.kernels import ops
    from repro_torch.launch import ShardMesh
    from repro_torch.stream import StreamDPC, StreamDPCConfig
    dev = torch.device("cuda")
    out: dict = {}

    def spec(backend, layout="dense"):
        return ExecSpec(backend=backend, layout=layout)

    def no_kernel(fn, what):
        """``fn()``, asserting that it launched no kernel of the port."""
        ops.reset_launch_counts()
        res = fn()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        assert not launched, f"{what}: the torch fit launched {launched}"
        return res

    fits = {
        "approxdpc": lambda x, b, lay: run_approxdpc(
            x, d_cut, exec_spec=spec(b, lay)),
        "exdpc": lambda x, b, lay: run_exdpc(x, d_cut,
                                             exec_spec=spec(b, lay)),
        "sapproxdpc": lambda x, b, lay: run_sapproxdpc(
            x, d_cut, eps=SAPPROX_EPS, exec_spec=spec(b, lay))}

    def unresolved_of(recs) -> dict:
        return {r["name"]: r["attrs"]["unresolved"] for r in recs
                if "unresolved" in r.get("attrs", {})}

    def timed_fit(fn, what):
        """A traced fit (phase times, peaks, the unresolved rows), then the
        timed one, untraced, ending in a synchronize, and its peak; neither
        may launch a kernel of the port."""
        torch.cuda.synchronize()
        obs.configure("trace")
        obs.reset_spans()
        try:
            no_kernel(fn, what)
        finally:
            obs.configure("off")
        recs = obs.spans()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = no_kernel(fn, what)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        phases: dict[str, float] = {}
        for r in recs:
            phases[r["name"]] = phases.get(r["name"], 0.0) \
                + 1e3 * r["host_s"]
        return res, {"ms": ms, "peak_gb": peak, "phases_ms": phases,
                     "unresolved": unresolved_of(recs)}

    x = torch.from_numpy(main_pts).to(dev)
    for algo, layout in (("approxdpc", "dense"), ("exdpc", "dense"),
                         ("sapproxdpc", "dense"),
                         ("approxdpc", "block-sparse"),
                         ("exdpc", "block-sparse")):
        what = f"torch {algo} {layout} n={len(main_pts)}"
        got, rec = timed_fit(lambda: fits[algo](x, "torch", layout), what)
        want = fits[algo](x, "cuda", layout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fits[algo](x, "cuda", layout)
        torch.cuda.synchronize()
        rec["cuda_ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(hold_against(x, got, want, d_cut, what))
        shown = ", ".join(f"{k} {v:.2f}" for k, v in rec["phases_ms"].items())
        print(f"{what}: {rec['ms']:.1f} ms (cuda {rec['cuda_ms']:.1f} ms), "
              f"peak {rec['peak_gb']:.3f} GB above the script's; spans "
              f"(ms, traced run): {shown}; unresolved rows "
              f"{rec['unresolved']}; == cuda fit: rho off the band, delta "
              f"rtol 1e-6, {rec['tied_parents']} parents differ at exact "
              f"ties ({rec['downstream']} rows downstream, "
              f"{rec['labels_differ']} labels)  ({card})", flush=True)
        out[f"{algo} {layout}"] = rec
        del got, want
        torch.cuda.empty_cache()
    del x

    # distributed Ex-DPC, 4 logical shards, dense: the gather strategy's
    # stencil phases and the halo strategy's gather-form halo primitives
    dpts, _ = real_proxy("airline", REF_DIST_N, seed=0)
    dc = pick_dcut(dpts, target_rho=30)
    xd = torch.from_numpy(dpts).to(dev)
    single = no_kernel(lambda: run_exdpc(xd, dc, exec_spec=spec("torch")),
                       f"torch exdpc n={REF_DIST_N}")
    for strategy in ("gather", "halo"):
        eng = DPCEngine(dc, algorithm="exdpc", rho_min=10, strategy=strategy,
                        mesh=ShardMesh.on("cuda", shards=DIST_SHARDS),
                        exec_spec=spec("torch"))
        what = f"torch distributed exdpc {strategy} n={REF_DIST_N}"
        no_kernel(lambda: eng.fit(dpts), what)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        no_kernel(lambda: eng.fit(dpts), what)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"ms": ms, **hold_against(xd, eng.result, single, dc, what)}
        print(f"{what}, {DIST_SHARDS} shards, dense: {ms:.1f} ms; == the "
              f"single-device torch fit, {rec['tied_parents']} parents "
              f"differ at exact ties  ({card})", flush=True)
        out[f"distributed {strategy}"] = rec
    del xd, single, eng
    torch.cuda.empty_cache()

    # the mixture stream on a torch plan against the cuda stream, tick by
    # tick (dense: a full tick is the stencil route)
    B = STREAM_BATCH
    mix, _ = gaussian_mixture(REF_WINDOW + (REF_TICKS + 1) * B, k=15, d=2,
                              seed=0)
    streams = {b: StreamDPC(StreamDPCConfig(
        d_cut=2000.0, capacity=REF_WINDOW, batch_cap=B, rho_min=10,
        exec_spec=spec(b))) for b in ("torch", "cuda")}
    tick_ms: dict[str, list] = {"torch": [], "cuda": []}
    tied = 0
    no_kernel(lambda: streams["torch"].initialize(mix[:REF_WINDOW]),
              "torch stream initialize")
    streams["cuda"].initialize(mix[:REF_WINDOW])
    for t in range(REF_TICKS + 1):
        batch = mix[REF_WINDOW + t * B:REF_WINDOW + (t + 1) * B]
        ticks = {}
        for b, s in streams.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ticks[b] = no_kernel(lambda: s.ingest(batch),
                                 f"torch stream tick {t}") \
                if b == "torch" else s.ingest(batch)
            torch.cuda.synchronize()
            if t:                       # the first tick is a warm-up
                tick_ms[b].append((time.perf_counter() - t0) * 1e3)
        a, c = streams["torch"], streams["cuda"]
        assert np.array_equal(ticks["torch"].labels, ticks["cuda"].labels)
        assert np.array_equal(ticks["torch"].stable_ids,
                              ticks["cuda"].stable_ids)
        w = torch.from_numpy(a.window_points()).to(dev)
        tied += hold_against(w, a.result, c.result, 2000.0,
                             f"torch stream tick {t}")["tied_parents"]
    rec = {"tick_ms": {b: statistics.median(v) for b, v in tick_ms.items()},
           "tied_parents": tied}
    print(f"torch mixture stream, window {REF_WINDOW}, batches of {B}, "
          f"dense, {REF_TICKS} counted ticks: == the cuda stream on every "
          f"tick ({tied} parents differ at exact ties); median tick "
          f"{rec['tick_ms']['torch']:.2f} ms (cuda "
          f"{rec['tick_ms']['cuda']:.2f} ms)  ({card})", flush=True)
    out["stream"] = rec
    return out


def heaviest_rows(weight: torch.Tensor) -> torch.Tensor:
    """The rows of the most span columns (``weight``), at most
    DIST_PLAIN_ROWS of them and BASE_PLAIN_PAIRS columns in all (one row at
    least), in the call's row order: rows that share their spans come
    together, so these are the heaviest runs."""
    w, idx = torch.sort(weight, descending=True, stable=True)
    within = int((torch.cumsum(w, 0) <= BASE_PLAIN_PAIRS).sum())
    return torch.sort(idx[:max(1, min(DIST_PLAIN_ROWS, within))]).values


def base_plain_check(algo: str, given: dict, card: str) -> dict:
    """Each kernel call of a baseline's fit (its arguments and result, as
    the fit made it) against its plain version on a slice of its rows at
    full window width, bit for bit: K10 and K11 on the rows of the longest
    spans (``heaviest_rows``), K2 on K2_PLAIN_ROWS rows at even ranks of
    the key order (the first scans every denser column, the last none).
    Per kernel: the plain version's ms (one run a call, summed), the rows
    it took and the max abs error."""
    from repro_torch.kernels import sweep
    _, _, _, _, _, k10_plain, _, k11_plain = dist_kernels()
    out = {}
    for kernel, calls in given.items():
        err, p_ms, rows_n = 0.0, 0.0, 0
        for i, (a, kw, got) in enumerate(calls):
            assert kw.get("worklist") is None and not kw.get("squared")
            if kernel == "masked_nn":           # x, x_key, y, y_key
                x, xk, y, yk = a
                cols = y.shape[0]
                ranks = torch.linspace(0, x.shape[0] - 1,
                                       min(K2_PLAIN_ROWS, x.shape[0]),
                                       device=x.device).round().long()
                rows = torch.sort(torch.argsort(xk, stable=True)[
                    ranks.unique()]).values
                want, ms = timed_once(lambda: sweep.masked_nn_plain(
                    x[rows], xk[rows], y, yk))
                want = (torch.sqrt(want[0]), want[1])
            elif kernel == "halo_range_count":  # x, window, starts, ends
                x, win, st, en, dc = a
                cols = win.shape[0]
                rows = heaviest_rows(span_pairs(st, en, win.shape[0]))
                want, ms = timed_once(lambda: [k10_plain(
                    x[rows], win, st[rows], en[rows], dc)])
            else:                               # K11: keys beside each
                x, xk, win, wk, st, en, dc = a
                cols = win.shape[0]
                rows = heaviest_rows(span_pairs(st, en, win.shape[0]))
                want, ms = timed_once(lambda: k11_plain(
                    x[rows], xk[rows], win, wk, st[rows], en[rows], dc))
            err = max(err, check_equal(
                f"{kernel} [{algo}, call {i}, {rows.numel()} of "
                f"{x.shape[0]} rows x {cols} columns]",
                [t[rows] for t in got], want))
            p_ms, rows_n = p_ms + ms, rows_n + rows.numel()
        out[kernel] = {"plain_ms": p_ms, "plain_rows": rows_n,
                       "max_abs_err": err}
        print(f"{kernel} [{algo}]: the fit's {len(calls)} calls == plain, "
              f"bit for bit, on {rows_n} of their rows at full window "
              f"width; plain {p_ms:.3f} ms  ({card})", flush=True)
    return out


def run_baselines(main_pts: np.ndarray, d_cut: float, card: str) -> dict:
    """Phase 26: the paper's two baselines on the card's kernels.  At
    ``BASE_N`` Airline-proxy rows (d_cut of phase 3), LSH-DDP (M 4, L 3,
    seed 0: K10 and K11 over each round's bucket spans, K2 on the rows no
    bucket resolves) and CFSFDP-A (k 32: K10 over the kept clusters'
    windows, K2 for delta) on the ``cuda`` route: after a warm-up, a
    traced fit (its spans and attributes), then the timed fit, untraced,
    ending in a synchronize, with the launch counts zeroed just before it
    and read just after (the kernels named must launch), then a fit with
    each kernel wrapper timed by CUDA events (the wrapper's time: the
    layout it builds and its launch) whose calls are each held against
    their plain versions (``base_plain_check``); K10 on CFSFDP-A's spans
    in two row orders; the k-means pivots drawn on the card against the
    host's.  At ``BASE_PARITY_N`` rows each is
    held against the same function on the ``torch`` backend on the same
    CUDA tensors."""
    from repro_torch import ExecSpec, obs
    from repro_torch.core import threefry
    from repro_torch.core.cfsfdp_a import run_cfsfdp_a
    from repro_torch.core.lsh_ddp import run_lsh_ddp
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    out: dict = {}
    runs = {"lsh_ddp": (run_lsh_ddp, ("halo_range_count", "halo_masked_nn",
                                      "masked_nn")),
            "cfsfdp_a": (run_cfsfdp_a, ("halo_range_count", "masked_nn"))}
    wrapped = {"halo_range_count": "halo_density",
               "halo_masked_nn": "halo_dependent",
               "masked_nn": "dependent_masked"}

    def work(kernel, a) -> tuple[float, float]:
        """Bytes and operations of one call by phase 17's and phase 8's
        counts: K10 3d+1 per span column; K11 a key test per span column
        of a tile keyed above the row plus 3d+1 per denser one (its d_cut,
        here unbounded, bounds no count); K2 on its keys."""
        if kernel == "halo_range_count":
            return k10_work(*a[:4])
        if kernel == "halo_masked_nn":
            return k11_work(*a[:6])[:2]
        return k2_work(a[1], a[3], a[0].shape[1])

    def event_times(fn) -> tuple[dict, dict]:
        """Per kernel wrapper: calls, summed CUDA-event ms and the bound of
        its work in one fit; and each call's arguments and result."""
        times = {k: [] for k in wrapped}
        given = {k: [] for k in wrapped}
        saved = {k: getattr(ops, w) for k, w in wrapped.items()}

        def timed(kernel, f):
            def call(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = f(*a, **kw)
                end.record()
                times[kernel].append((start, end, work(kernel, a)))
                kept = res if isinstance(res, tuple) else (res,)
                given[kernel].append((a, kw, [t.clone() for t in kept]))
                return res
            return call
        for k, w in wrapped.items():
            setattr(ops, w, timed(k, saved[k]))
        try:
            fn()
        finally:
            for k, w in wrapped.items():
                setattr(ops, w, saved[k])
        torch.cuda.synchronize()
        out = {}
        for k, v in times.items():
            if v:
                nb = sum(w[0] for _, _, w in v)
                no = sum(w[1] for _, _, w in v)
                out[k] = {"calls": len(v),
                          "ms": sum(a.elapsed_time(b) for a, b, _ in v),
                          "bound_ms": bound_ms(nb, no)[0] if no else None}
        return out, {k: v for k, v in given.items() if v}

    x = torch.from_numpy(main_pts[:BASE_N]).to(dev)
    for algo, (run, need) in runs.items():
        def fit():
            return run(x, d_cut)
        fit()                           # a warm-up
        torch.cuda.synchronize()
        obs.configure("trace")
        obs.reset_spans()
        try:
            fit()
        finally:
            obs.configure("off")
        spans = obs.spans()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fit()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        for k in need:
            assert launches.get(k, 0) > 0, f"{algo}: {k} did not launch"
        assert set(launches) <= set(need), f"{algo} launched {launches}"
        assert all(t.is_cuda for t in res)
        assert bool(torch.isfinite(res.rho).all()) and int(
            torch.isinf(res.delta).sum()) >= 1, f"{algo}: no peak"
        kernels, given = event_times(fit)
        for k, checked in base_plain_check(algo, given, card).items():
            kernels[k].update(checked)
        del given
        phases: dict[str, float] = {}
        attrs: dict[str, list] = {}
        for r in spans:
            phases[r["name"]] = phases.get(r["name"], 0.0) \
                + 1e3 * r["host_s"]
            for key in ("cap", "buckets", "unresolved", "pruned", "empty"):
                if key in r.get("attrs", {}):
                    attrs.setdefault(key, []).append(r["attrs"][key])
        rec = {"ms": ms, "peak_gb": peak, "launches": launches,
               "kernels": kernels, "phases_ms": phases, **attrs}
        out[algo] = rec
        shown = ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
        kern = ", ".join(f"{k} {v['calls']} calls {v['ms']:.3f} ms (bound "
                         f"{v['bound_ms'] or 0:.3f}; plain {v['plain_ms']:.3f}"
                         f" ms on {v['plain_rows']} of its rows)"
                         for k, v in kernels.items())
        print(f"{algo} n={BASE_N}: {ms:.1f} ms, peak {peak:.3f} GB above "
              f"the script's; launches {launches}; kernels (CUDA events, "
              f"layout included): {kern}; spans (ms, traced run): {shown}; "
              f"{attrs}  ({card})",
              flush=True)
        del res
        torch.cuda.empty_cache()

    # the row order CFSFDP-A hands K10 (rows with the same kept clusters
    # together) against the cluster-sorted order, the same counts
    from repro_torch.core import cfsfdp_a as cf
    from repro_torch.kernels.backend import get_backend
    cents, assign = cf.kmeans_pivots(x, 32)
    order, start, end = cf.cluster_windows(assign, 32)
    keep = cf.triangle_keep(x, cents, assign, d_cut)
    pts_s = x[order]
    orders: dict[str, float] = {}
    counts = []
    for name, rows in (("kept-cluster pattern", cf.pattern_order(keep)),
                       ("cluster", order)):
        st, en = cf.row_spans(keep[rows], start, end)
        xr = x[rows]

        def k10():
            return get_backend("cuda").range_count_halo(
                xr, pts_s, st, en, d_cut, span_cap=0)
        got = torch.empty((x.shape[0],), device=dev)
        got[rows] = k10()
        counts.append(got)
        orders[name] = time_ms(k10)
    assert torch.equal(counts[0], counts[1])
    orders["pattern sort"] = time_ms(lambda: cf.pattern_order(keep))
    out["cfsfdp_a"]["k10_row_order_ms"] = orders
    print(f"cfsfdp_a K10 by row order (CUDA events, median of {REPS}, "
          f"layout included): {orders}  ({card})", flush=True)
    del keep, counts, pts_s, st, en, xr

    # the pivots' draw on the card equals the host's (k-means draws it on
    # the points' device)
    n = x.shape[0]
    host = threefry.choice(threefry.prng_key(0), n, (32,))
    card_pick = threefry.choice(threefry.prng_key(0, dev), n, (32,))
    assert torch.equal(card_pick.cpu(), host), "threefry.choice on the card"
    print(f"threefry.choice(PRNGKey(0), {n}, (32,)) on the card == on the "
          f"host (two rounds of the sort-based shuffle)", flush=True)
    del x
    torch.cuda.empty_cache()

    # parity: the cuda route against the torch backend on the same tensors
    xs = torch.from_numpy(main_pts[:BASE_PARITY_N]).to(dev)
    for algo, (run, _) in runs.items():
        want = run(xs, d_cut)
        got = run(xs, d_cut, exec_spec=ExecSpec(backend="torch"))
        what = f"{algo} torch vs cuda n={BASE_PARITY_N}"
        held = hold_against(xs, got, want, d_cut, what)
        out[algo]["parity"] = held
        print(f"{what}: rho off the band, delta rtol 1e-6, "
              f"{held['tied_parents']} parents differ at exact ties "
              f"({held['downstream']} rows downstream, "
              f"{held['labels_differ']} labels)  ({card})", flush=True)
    return out


def plan_bytes(phase: int, record: dict) -> None:
    """Print the device bytes all memoized plans' worklist caches hold at
    the end of a phase that fits at 5.8M, then drop the plans (and their
    worklists) so they crowd no later phase's peak."""
    from repro_torch.engine import planner
    held = planner.plan_cache_bytes()
    record.setdefault("plan_cache_bytes", {})[phase] = held
    print(f"  plan caches hold {held} bytes of worklists at the end of "
          f"phase {phase}; dropped", flush=True)
    planner.plan_cache_clear()
    torch.cuda.empty_cache()


def run_plan_layer(full_pts: np.ndarray, d_cut: float, want: dict,
                   card: str) -> dict:
    """Phase 27: the plan layer on the 5.8M Airline proxy, block-sparse
    Approx-DPC.  After ``plan_cache_clear()`` a cold fit (builds and caches
    the K3 worklist, builds the K9 ring) then a warm refit (a hit: only the
    uncached ring is built), twice, each timed on the host clock ending in
    a synchronize; the builds, hits and misses across them; per cached
    build the fingerprint and lookup (a build served from a warm cache)
    against the build itself, and the ring's build (CUDA events, median of
    REPS); the bytes the plan's cache holds; the
    fingerprint on the card equal to the host's.  Asserts: rho, delta,
    parent and labels equal bit for bit across the cold fit, the warm fit
    and phase 8's (``want``); a refit with one coordinate one ulp away
    misses and equals an uncached fit of the same points; the backend
    probe passes on the card (K4 launched once) and, with ``degrade.probe``
    forced, ``plan()`` raises; the warm fit's trace, written to
    ``build/`` through ``configure(trace_path=...)``, renders through
    ``python -m repro_torch.obs report`` in a subprocess with
    ``engine.fit`` and the ``rho_delta.*`` spans among its phase rows."""
    import contextlib
    from collections import OrderedDict

    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.engine import planner
    from repro_torch.kernels import blocksparse, ops
    from repro_torch.resilience import degrade, faultinject
    out: dict = {}
    spec = ExecSpec(layout="block-sparse")

    def counters() -> tuple[int, int, int]:
        return (blocksparse.worklist_build_count(),
                blocksparse.worklist_cache_hits(),
                blocksparse.worklist_fingerprint_misses())

    def fit_ms(eng, pts) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.fit(pts)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def result_of(eng) -> dict:
        r = eng.result
        return {"rho": r.rho, "delta": r.delta, "parent": r.parent,
                "labels": eng.clustering.labels}

    def same(got: dict, ref: dict, what: str) -> None:
        for k, v in ref.items():
            assert torch.equal(got[k].cpu(), v.cpu()), f"{what}: {k} differs"

    # cold and warm, twice; the build calls of the first cold fit are kept
    builds: list = []
    real_build = blocksparse.build_flat_worklist

    def recording_build(*a, **kw):
        builds.append((a, kw))
        return real_build(*a, **kw)

    pairs = []
    for rep in range(2):
        planner.plan_cache_clear()
        torch.cuda.empty_cache()
        eng = DPCEngine(d_cut, rho_min=10, exec_spec=spec)
        c0 = counters()
        blocksparse.build_flat_worklist = recording_build if rep == 0 \
            else real_build
        try:
            cold = fit_ms(eng, full_pts)
        finally:
            blocksparse.build_flat_worklist = real_build
        c1 = counters()
        cold_res = {k: v.clone() for k, v in result_of(eng).items()}
        warm = fit_ms(eng, full_pts)
        c2 = counters()
        built, cached = c1[0] - c0[0], c1[2] - c0[2]
        assert built > cached >= 1 and c1[1] == c0[1], (c0, c1)
        assert c2[0] - c1[0] == built - cached, \
            "the warm refit built a sweep worklist"
        assert c2[1] - c1[1] == cached and c2[2] == c1[2], (c1, c2)
        same(cold_res, want, "cold fit vs phase 8")
        same(result_of(eng), cold_res, "warm fit vs cold fit")
        pairs.append({"cold_ms": cold, "warm_ms": warm, "builds": built,
                      "cold_counts": [c1[i] - c0[i] for i in range(3)],
                      "warm_counts": [c2[i] - c1[i] for i in range(3)]})
        print(f"plan layer, pair {rep}: cold fit {cold:.1f} ms (worklist "
              f"builds, hits, misses {pairs[-1]['cold_counts']}), warm refit "
              f"{warm:.1f} ms ({pairs[-1]['warm_counts']}); cold == warm == "
              f"phase 8's fit, bit for bit  ({card})", flush=True)
    out["pairs"] = pairs
    tele = eng.plan.telemetry()["worklists"]
    held = eng.plan.worklist_bytes()
    out.update(cache=tele, bytes_held=held)
    print(f"plan cache: {tele['cache_entries']} worklists, {held} bytes "
          f"({[(c['n_kept'], c['bytes']) for c in tele['cached']]} kept "
          f"entries and bytes each), cap {blocksparse.WL_CACHE_MAX_BYTES}",
          flush=True)

    # per build of the cold fit: the fingerprint and lookup against the
    # build where it is cached, the build alone for the ring
    per_build = []
    for a, kw in builds:
        warm_cache: OrderedDict = OrderedDict()
        with blocksparse.worklist_cache(warm_cache):
            wl = real_build(*a, **kw)

        def lookup():
            with blocksparse.worklist_cache(warm_cache):
                return real_build(*a, **kw)
        ring = kw.get("nn") == "best1"
        assert (len(warm_cache) == 0) == ring
        rows = a[0].shape[0]
        rec = {"rows": rows, "cols": a[1].shape[0],
               "form": {k: v for k, v in kw.items()
                        if not isinstance(v, torch.Tensor)},
               "entries": wl.n_kept, "bytes": wl.nbytes, "cached": not ring,
               "build_ms": time_ms(lambda: real_build(*a, **kw))}
        if not ring:
            assert lookup() is wl
            rec["fingerprint_ms"] = time_ms(lookup)
        per_build.append(rec)
        print(f"  worklist of {rows} x {rec['cols']} rows {rec['form']}: "
              f"{rec['entries']} entries, {rec['bytes']} bytes; "
              + ("not cached" if ring else
                 f"fingerprint and lookup {rec['fingerprint_ms']:.3f} ms")
              + f" against the build {rec['build_ms']:.3f} ms (CUDA events, "
              f"median of {REPS})  ({card})", flush=True)
        del wl, warm_cache
    out["builds"] = per_build
    x = builds[0][0][0]
    head = x[:1 << 20]
    out["fingerprint_x_ms"] = time_ms(lambda: blocksparse.fingerprint(x))
    assert blocksparse.fingerprint(head) == \
        blocksparse.fingerprint(head.cpu()), "the card's fingerprint"
    print(f"  fingerprint of the grid-sorted points ({x.shape[0]} x "
          f"{x.shape[1]} f32): {out['fingerprint_x_ms']:.3f} ms; its two "
          f"lanes on the card == on the host (first 2^20 rows)", flush=True)
    del builds, x, head

    # one coordinate one ulp away misses, and equals an uncached fit
    nudged = full_pts.copy()
    nudged[N_FULL // 3, 1] = np.nextafter(nudged[N_FULL // 3, 1],
                                          np.float32(np.inf))
    c0 = counters()
    eng.fit(nudged)
    c1 = counters()
    assert c1[2] > c0[2] and c1[0] > c0[0], (c0, c1)
    got = result_of(eng)
    ctx = planner.DPCPlan._ctx
    planner.DPCPlan._ctx = lambda self: contextlib.nullcontext()
    try:
        plain = DPCEngine(d_cut, rho_min=10, exec_spec=spec).fit(nudged)
    finally:
        planner.DPCPlan._ctx = ctx
    same(got, result_of(plain), "nudged refit vs an uncached fit")
    out["nudged_counts"] = [c1[i] - c0[i] for i in range(3)]
    print(f"refit with one coordinate one ulp away: builds, hits, misses "
          f"{out['nudged_counts']}; == an uncached fit of the same points, "
          f"bit for bit", flush=True)
    del plain, got, nudged
    torch.cuda.empty_cache()

    # the warm fit's trace, rendered by the report CLI in a subprocess
    eng.fit(full_pts)                                   # warm again
    trace = ROOT / "build" / "phase27_trace.jsonl"
    snap = ROOT / "build" / "phase27_snapshot.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    trace.unlink(missing_ok=True)
    c0 = counters()
    obs.configure(level="trace", trace_path=str(trace))
    obs.reset_spans()
    try:
        eng.fit(full_pts)
        obs.flush()
    finally:
        obs.configure(level="off", trace_path=None)
    c1 = counters()
    assert c1[2] == c0[2] and c1[1] > c0[1], "the traced warm fit missed"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", "--trace",
         str(trace), "--json", str(snap)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    phases = json.loads(snap.read_text())["phases"]
    names = {p.rsplit("/", 1)[-1] for p in phases}
    need = {"engine.fit", "rho_delta.worklist", "worklist.fingerprint",
            "rho_delta.sweep", "rho_delta.resolve", "rho_delta.fallback"}
    assert "engine.fit" in phases and need <= names, sorted(names)
    out["warm_trace_ms"] = {p: 1e3 * r["host_s"] for p, r in phases.items()}
    print("warm fit's trace through `python -m repro_torch.obs report`:")
    print(run.stdout, flush=True)
    trace.unlink()
    snap.unlink()

    # the backend probe: K4 once on the card; a forced failure raises
    ops.reset_launch_counts()
    degrade.reset()
    assert degrade.probe_backend("cuda") is None
    probe_launches = {k: v for k, v in ops.launch_counts().items() if v}
    assert probe_launches == {"range_count": 1}, probe_launches
    faultinject.activate("degrade.probe", trigger=0)
    degrade.reset()
    try:
        planner.plan((8, 2), ExecSpec())
        raise AssertionError("a failed probe did not raise at plan()")
    except RuntimeError as e:
        out["forced_probe"] = str(e)
    finally:
        faultinject.deactivate()
        degrade.reset()
    print(f"backend probe on the card: passed, launches {probe_launches}; "
          f"forced through degrade.probe, plan() raised: "
          f"{out['forced_probe']}", flush=True)
    del eng
    planner.plan_cache_clear()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- serving (phases 28 and 29)
def serve_band_heads(pts: torch.Tensor, d_cut: torch.Tensor,
                     valid: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """(H,) bool: the head has a pair of valid rows whose float64 d^2
    lies within 4 f32 ulp of d_cut^2 (where rounding may decide a
    count).  ``chunk`` heads at a time bound the (chunk, S, S) float64
    pair tensors."""
    out = []
    for h0 in range(0, pts.shape[0], chunk):
        x = pts[h0:h0 + chunk].double()
        d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
        thr = (d_cut[h0:h0 + chunk].float() ** 2).double()
        ulp = (torch.nextafter(thr.float(), torch.tensor(
            float("inf"), device=thr.device)).double() - thr)
        near = (d2 - thr[:, None, None]).abs() <= 4 * ulp[:, None, None]
        v = valid[h0:h0 + chunk]
        out.append((near & v[:, :, None] & v[:, None, :]).flatten(1)
                   .any(dim=1))
    return torch.cat(out)


def attention_errors(eng, comp, gen) -> dict:
    """Per layer: the relative error of attention over the compressed
    prompt cache against the full one for a seeded query, beside keeping
    as many random rows (counts 1)."""
    from repro_torch.serve.dpc_kv import attend_compressed
    cfg = eng.model.cfg
    k_c, v_c, counts = comp
    L, B, M, K, hd = k_c.shape
    Lp = eng.cfg.max_prompt
    q = torch.from_numpy(gen.normal(size=(B, cfg.n_heads, hd)).astype(
        np.float32)).to(k_c.device)
    keep = torch.from_numpy(gen.choice(Lp, M, replace=False)).to(k_c.device)
    ones = torch.ones((B, M, K), device=k_c.device)
    dpc, rand = [], []
    for layer in range(L):
        k = eng.cache.k[layer, :, :Lp]
        v = eng.cache.v[layer, :, :Lp]
        full = attend_compressed(q, k, v, torch.ones((B, Lp, K),
                                                     device=k.device))
        got = attend_compressed(q, k_c[layer], v_c[layer], counts[layer])
        got_r = attend_compressed(q, k[:, keep], v[:, keep], ones)
        norm = float(torch.linalg.norm(full))
        dpc.append(float(torch.linalg.norm(got - full)) / norm)
        rand.append(float(torch.linalg.norm(got_r - full)) / norm)
    return {"dpc_kv": dpc, "random": rand}


def compress_and_check(eng, kv, card: str, label: str,
                       reps: int = REPS) -> tuple[dict, dict]:
    """``compress_prompt_cache`` on an engine's prefilled 5-d cache,
    counted (counts zeroed just before, read just after: K4 and K2 once
    per (layer, sequence, kv-head), nothing else), every launch held bit
    for bit against its plain version; K4, K2 (all calls, CUDA events)
    and the compression timed with their bounds; the ``torch`` route on
    the same cache equal in d_cut, rho, ordered centers and counts on
    every head off the 4-ulp band; the attention error.  Returns the
    record and, for K4 and K2, their entries at this shape."""
    from repro_torch import obs
    from repro_torch.engine.spec import ExecSpec
    from repro_torch.kernels import ops, sweep
    from repro_torch.serve import DPCKVConfig
    from repro_torch.serve import dpc_kv

    cfg = eng.model.cfg
    prompt = eng.cfg.max_prompt
    given: dict[str, list] = {"range_count": [], "masked_nn": []}
    k4_launch, k2_launch = ops.local_density_xy, ops.dependent_masked

    def rec_k4(x, y, dc, **kw):
        given["range_count"].append((x, y, dc))
        return k4_launch(x, y, dc, **kw)

    def rec_k2(x, xk, y, yk, **kw):
        given["masked_nn"].append((x, xk, y, yk))
        return k2_launch(x, xk, y, yk, **kw)

    ops.local_density_xy, ops.dependent_masked = rec_k4, rec_k2
    try:
        ops.reset_launch_counts()
        comp, comp_once_ms = timed_once(eng.compress_prompt_cache)
        launches = ops.launch_counts()
    finally:
        ops.local_density_xy, ops.dependent_masked = k4_launch, k2_launch
    L, B, S, K, hd = eng.cache.k.shape
    H = L * B * K
    ran = {k: v for k, v in launches.items() if v}
    assert ran == {"range_count": H, "masked_nn": H}, ran
    assert all(len(given[k]) == H for k in given)
    k_c, v_c, counts = comp
    M = kv.budget
    assert k_c.shape == v_c.shape == (L, B, M, K, hd), k_c.shape
    assert counts.shape == (L, B, M, K)
    assert k_c.dtype == cfg.dtype and torch.isfinite(k_c.float()).all()
    assert float(counts.max()) <= prompt
    assert (counts.sum(dim=2) <= prompt).all()
    assert (counts.sum(dim=2) > 0).all()
    errs = {"range_count": 0.0, "masked_nn": 0.0}
    for x, y, dc in given["range_count"]:
        want = sweep.range_count_plain(x, y, sweep.d2cut_of(dc)).float()
        errs["range_count"] = max(errs["range_count"], check_equal(
            f"range_count [DPC-KV, {label}]", [k4_launch(x, y, dc)],
            [want]))
    for x, xk, y, yk in given["masked_nn"]:
        best, arg = sweep.masked_nn_plain(x, xk, y, yk)
        errs["masked_nn"] = max(errs["masked_nn"], check_equal(
            f"masked_nn [DPC-KV, {label}]", k2_launch(x, xk, y, yk),
            [torch.sqrt(best), arg]))
    comp_ms = time_ms(eng.compress_prompt_cache, reps)
    kernels = {}
    for name, launch, plain in (
            ("range_count", k4_launch,
             lambda x, y, dc: sweep.range_count_plain(
                 x, y, sweep.d2cut_of(dc))),
            ("masked_nn", k2_launch, sweep.masked_nn_plain)):
        calls = given[name]
        ms = time_ms(lambda: [launch(*c) for c in calls], reps)
        _, plain_ms = timed_once(lambda: [plain(*c) for c in calls])
        work = [k4_work(c[0].shape[0], c[1].shape[0], c[0].shape[1])
                if name == "range_count" else k2_work(c[1], c[3], c[0].shape[1])
                for c in calls]
        b_ms, by = bound_ms(sum(w[0] for w in work), sum(w[1] for w in work))
        x0, y0 = calls[0][0], calls[0][-2 if name == "masked_nn" else 1]
        kernels[name] = {"shape": f"{H} x ({x0.shape[0]} x {y0.shape[0]}, "
                         f"d {x0.shape[1]})", "launches": ran[name],
                         "max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": by, "library_ms": None}
        print(f"{name} at DPC-KV's shape on {label}, "
              f"{kernels[name]['shape']}: {ran[name]} launches, {ms:.3f} ms "
              f"for all (CUDA events, median of {reps}; "
              f"{1e3 * ms / H:.2f} us a launch), bound {b_ms:.4f} ms "
              f"({by}), plain {plain_ms:.1f} ms; every launch == plain, bit "
              f"for bit  ({card})", flush=True)
    obs.reset_spans()
    obs.configure(level="trace")
    try:
        eng.compress_prompt_cache()
    finally:
        obs.configure(level="off")
    sp = [s for s in obs.spans() if s["name"] == "serve.compress"][-1]
    assert sp["attrs"]["heads"] == H and sp["attrs"]["launches"] == 2 * H, \
        sp["attrs"]
    print(f"compress_prompt_cache on {label}: {comp_ms:.2f} ms (CUDA events, "
          f"median of {reps}; the counted one {comp_once_ms:.2f}); {H} heads "
          f"of {prompt} rows, budget {M}: k_c/v_c {tuple(k_c.shape)}, counts "
          f"at most {int(counts.max())}; traced span "
          f"{1e3 * sp['host_s']:.2f} ms, attrs {sp['attrs']}", flush=True)

    # the same card cache through the torch route: equal off the band
    kh, valid = dpc_kv._heads(eng.cache.k.reshape(L * B, S, K, hd), prompt)
    cu = dpc_kv._cluster_heads(kh, valid, kv)
    kv_t = DPCKVConfig(budget=M, exec_spec=ExecSpec(backend="torch"))
    ops.reset_launch_counts()
    tr = dpc_kv._cluster_heads(kh, valid, kv_t)
    assert not any(ops.launch_counts().values()), "the torch route launched"
    band = serve_band_heads(cu["pts"], cu["d_cut"], valid)
    off = ~band
    assert torch.equal(cu["d_cut"], tr["d_cut"])
    rows = off[:, None] & valid
    assert torch.equal(cu["rho"][rows], tr["rho"][rows])
    assert torch.equal(cu["centers"][off], tr["centers"][off])
    c_cu = counts.reshape(L * B, M, K).permute(0, 2, 1).reshape(H, M)
    c_tr = torch.zeros((H, M + 1), device=c_cu.device).scatter_add_(
        1, tr["member_slot"], torch.ones_like(tr["member_slot"],
                                              dtype=torch.float32))[:, :M]
    assert torch.equal(c_cu[off], c_tr[off])
    print(f"the torch route on the same card cache ({label}): d_cut equal, "
          f"rho, centers (ordered) and counts equal on the {int(off.sum())} "
          f"of {H} heads off the 4-ulp band around d_cut^2 "
          f"({int(band.sum())} in it); no kernel launched", flush=True)
    att = attention_errors(eng, comp, np.random.default_rng(1))
    print(f"attention over the compressed cache against the full one "
          f"({label}), relative error per layer (seeded query; reported, not "
          f"gated): DPC-KV mean {statistics.mean(att['dpc_kv']):.4f} "
          f"[{min(att['dpc_kv']):.4f}, {max(att['dpc_kv']):.4f}], random "
          f"eviction at the same budget mean "
          f"{statistics.mean(att['random']):.4f} [{min(att['random']):.4f}, "
          f"{max(att['random']):.4f}]", flush=True)
    return {"compress_ms": comp_ms, "compress_counted_ms": comp_once_ms,
            "heads": H, "band_heads": int(band.sum()),
            "attention_error": att, "kernels": kernels}, kernels


def f32_card_check(cfg, layers: int, prompt: int, gen, card: str) -> dict:
    """``cfg``'s full width cut to ``layers`` layers in f32, weights from
    ``gen`` on the card: its prefill logits on the card within 1e-3 of
    the largest |logit| of the CPU's on the same weights, TF32 off."""
    from repro_torch.models import build_model

    cfg2 = cfg.replace(n_layers=layers, dtype=torch.float32)
    model = build_model(cfg2)
    p2 = model.init(generator=gen)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, prompt)))
    with torch.inference_mode():
        got, _ = model.prefill(p2, {"tokens": toks.to(p2.device)},
                               model.init_cache(2, prompt))
        p_cpu = type(p2)(cfg2, {k: v.cpu() for k, v in
                                p2.state_dict().items()})
        want, _ = model.prefill(p_cpu, {"tokens": toks},
                                model.init_cache(2, prompt, device="cpu"))
    got = got.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all() and got.shape == (2, cfg.vocab)
    assert err <= 1e-3 * scale, (cfg.name, err, scale)
    print(f"{cfg.name} at full width, {layers} layers, f32, batch 2, "
          f"{prompt}-token prompts: prefill logits on the card against the "
          f"CPU on the same weights, max |diff| {err:.3e} against 1e-3 x max "
          f"|logit| = {1e-3 * scale:.3e} (TF32 off)  ({card})", flush=True)
    del p2, p_cpu
    torch.cuda.empty_cache()
    return {"layers": layers, "prompt": prompt, "max_abs_diff": err,
            "max_abs_logit": scale}


def serve_prompts(vocab: int) -> tuple[np.ndarray, list]:
    """Phases 28 and 29's traffic: SERVE_BATCH prompts of 64 to
    SERVE_PROMPT tokens (numpy seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, SERVE_PROMPT + 1, SERVE_BATCH)
    return lens, [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def run_serving(card: str) -> tuple[dict, dict]:
    """Phase 28: ``ServeEngine`` on gemma-2b at full width in bf16 (random
    weights from a seeded generator on the card), 8 prompts of 64-512
    tokens, 32 new tokens, DPC-KV at budget 64 on the ``cuda`` route.
    Returns the record and, for K4 and K2, their DPC-KV entries."""
    from repro_torch import obs
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    dev = torch.device("cuda")
    out: dict = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[SERVE_ARCH]
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    (params, init_ms) = timed_once(lambda: model.init(generator=gen))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{SERVE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, kv {cfg.n_kv_heads}, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_params:,} parameters in {cfg.dtype}, initialized on the card "
          f"in {init_ms:.1f} ms", flush=True)
    lens, prompts = serve_prompts(cfg.vocab)
    kv = DPCKVConfig(budget=SERVE_BUDGET)
    scfg = ServeConfig(batch=SERVE_BATCH, max_prompt=SERVE_PROMPT,
                       max_new_tokens=SERVE_NEW, dpc_kv=kv)
    eng = ServeEngine(model, params, scfg)
    eng.generate(prompts)                                    # warm-up
    obs.reset_spans()
    obs.configure(level="trace")
    try:
        tokens = eng.generate(prompts)
    finally:
        obs.configure(level="off")
    spans = {s["name"]: s for s in obs.spans()}
    prefill_ms = 1e3 * spans["serve.prefill"]["host_s"]
    decode_ms = 1e3 * spans["serve.decode"]["host_s"] / SERVE_NEW
    assert tokens.shape == (SERVE_BATCH, SERVE_NEW), tokens.shape
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
    again = ServeEngine(model, params, scfg).generate(prompts)
    assert np.array_equal(again, tokens), "a second engine's greedy tokens"
    print(f"served {SERVE_BATCH} prompts of {lens.tolist()} tokens (left-"
          f"padded to {SERVE_PROMPT}), {SERVE_NEW} new tokens each: prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms per token "
          f"(traced, fenced); a second engine on the same weights gave the "
          f"same greedy tokens  ({card})", flush=True)
    comp, kernels = compress_and_check(eng, kv, card, SERVE_ARCH)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"serving peak device memory {peak:.3f} GB", flush=True)
    out.update(arch=SERVE_ARCH, params=n_params, init_ms=init_ms,
               prompt_lens=lens.tolist(), prefill_ms=prefill_ms,
               decode_ms_per_token=decode_ms, peak_gb=peak, **comp)
    del eng, params
    torch.cuda.empty_cache()
    # gemma-2b's full width at 2 layers in f32: the card against the CPU
    gen.manual_seed(1)
    out["f32_check"] = f32_card_check(cfg, SERVE_CHECK_LAYERS,
                                      SERVE_CHECK_PROMPT, gen, card)
    return out, kernels


def prefill_drops(moe_mod, tokens: int, shares: list):
    """A stand-in for ``moe.moe_ffn`` that appends, for each call over
    ``tokens`` tokens (the prefill's), the share of its top-k assignments
    that fall past their expert's capacity, then calls the real one."""
    real = moe_mod.moe_ffn

    def counted(x, lp, cfg):
        T = x.shape[0] * x.shape[1]
        if T == tokens:
            probs = torch.softmax(x.reshape(T, -1).float() @ lp["router"],
                                  dim=-1)
            top = torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices[:, :cfg.top_k]
            per = torch.bincount(top.flatten(), minlength=cfg.n_experts)
            over = torch.clamp_min(per - moe_mod.capacity(cfg, T), 0)
            shares.append(float(over.sum()) / (T * cfg.top_k))
        return real(x, lp, cfg)
    return counted


def run_serving_families(card: str) -> tuple[dict, dict]:
    """Phase 29: ``ServeEngine`` on the moe, ssm and hybrid families at
    full width in bf16 (random weights from a seeded generator on the
    card), phase 28's traffic; DPC-KV on granite-moe's cache.  Returns the
    record and, for K4 and K2, their entries at granite-moe's shape."""
    from repro_torch import obs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    out: dict = {}
    kernels: dict = {}
    for arch in FAMILY_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = ARCHS[arch]
        cut = {}
        if arch in FAMILY_DEPTH:
            cut = {"n_layers": f"{FAMILY_DEPTH[arch]} of {cfg.n_layers}"}
            cfg = cfg.replace(n_layers=FAMILY_DEPTH[arch])
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params, init_ms = timed_once(lambda: model.init(generator=gen))
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{arch} [{cfg.family}]: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}, {n_params:,} parameters "
              f"in {cfg.dtype}, initialized on the card in {init_ms:.1f} ms"
              f"{'; cut: ' + str(cut) if cut else ''}", flush=True)
        lens, prompts = serve_prompts(cfg.vocab)
        kv = DPCKVConfig(budget=SERVE_BUDGET) if arch == FAMILY_DPC_KV \
            else None
        scfg = ServeConfig(batch=SERVE_BATCH, max_prompt=SERVE_PROMPT,
                           max_new_tokens=SERVE_NEW, dpc_kv=kv)
        eng = ServeEngine(model, params, scfg)
        eng.generate(prompts)                                # warm-up
        ops.reset_launch_counts()
        obs.reset_spans()
        obs.configure(level="trace")
        try:
            tokens = eng.generate(prompts)
        finally:
            obs.configure(level="off")
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        spans = {s["name"]: s for s in obs.spans()}
        prefill_ms = 1e3 * spans["serve.prefill"]["host_s"]
        decode_ms = 1e3 * spans["serve.decode"]["host_s"] / SERVE_NEW
        assert tokens.shape == (SERVE_BATCH, SERVE_NEW), tokens.shape
        assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
        drops: list = []
        if cfg.family == "moe":
            real = moe.moe_ffn
            moe.moe_ffn = prefill_drops(moe, SERVE_BATCH * SERVE_PROMPT,
                                        drops)
        try:
            again = ServeEngine(model, params, scfg).generate(prompts)
        finally:
            if cfg.family == "moe":
                moe.moe_ffn = real
        assert np.array_equal(again, tokens), \
            f"{arch}: a second engine's greedy tokens"
        rec = {"family": cfg.family, "layers": cfg.n_layers, "cut": cut,
               "params": n_params, "init_ms": init_ms,
               "prompt_lens": lens.tolist(), "prefill_ms": prefill_ms,
               "decode_ms_per_token": decode_ms,
               "cache": {k: list(v.shape) for k, v in
                         (eng.cache._asdict() if hasattr(eng.cache, "_asdict")
                          else eng.cache).items()}}
        print(f"{arch}: served {SERVE_BATCH} prompts (left-padded to "
              f"{SERVE_PROMPT}), {SERVE_NEW} new tokens each: prefill "
              f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms per token "
              f"(traced, fenced); no kernel of the port launched; a second "
              f"engine gave the same greedy tokens; cache {rec['cache']}  "
              f"({card})", flush=True)
        if drops:
            assert len(drops) == cfg.n_layers, len(drops)
            rec["prefill_drop_share"] = drops
            print(f"{arch}: share of the prefill's top-{cfg.top_k} "
                  f"assignments dropped past capacity "
                  f"{moe.capacity(cfg, SERVE_BATCH * SERVE_PROMPT)}, per "
                  f"layer: {[round(d, 4) for d in drops]}", flush=True)
        if kv is not None:
            rec["dpc_kv"], kernels = compress_and_check(
                eng, kv, card, arch, reps=FAMILY_REPS)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"{arch}: serving peak device memory {rec['peak_gb']:.3f} GB",
              flush=True)
        del eng, params
        torch.cuda.empty_cache()
        if arch in FAMILY_CHECK:
            gen.manual_seed(1)
            rec["f32_check"] = f32_card_check(ARCHS[arch],
                                              *FAMILY_CHECK[arch], gen, card)
        out[arch] = rec
    return out, kernels


def train_argv(arch: str, ckpt_dir: Path | None, ckpt_every: int) -> list:
    """Phase 30's ``launch.train`` arguments (on the card, seed 0)."""
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0",
            "--log-every", "1"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(ckpt_every)]
    return argv


def train_report(arch: str, run, card: str) -> dict:
    """A ``launch.train`` run's step time (median of steps 2-8, each
    ending in a synchronize), tokens/s, per-step loss and gradient norm,
    all finite, and the peak device memory since the last reset."""
    n_params = sum(p.numel() for p in run.params.parameters())
    step_ms = 1e3 * statistics.median(run.step_s[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(v) for v in run.losses + run.grad_norms), \
        (run.losses, run.grad_norms)
    rec = {"params": n_params, "step_ms": step_ms,
           "step_ms_all": [1e3 * t for t in run.step_s],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "losses": run.losses, "grad_norms": run.grad_norms,
           "lrs": run.lrs, "peak_gb": peak}
    print(f"{arch}: {n_params:,} parameters, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: step {step_ms:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS}; all "
          f"{[round(1e3 * t, 1) for t in run.step_s]}), "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {peak:.3f} GB; loss "
          f"{[round(v, 4) for v in run.losses]}, grad norm "
          f"{[round(v, 4) for v in run.grad_norms]}; no kernel of the port "
          f"launched  ({card})", flush=True)
    return rec


PRODUCT_OPS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm")


def profile_step(arch: str, step_fn, params, opt_state, batch: dict,
                 step_idx: int, card: str) -> dict:
    """One more training step of a finished run under ``torch.profiler``:
    its wall time (ending in a synchronize), the device's busy time (the
    kernels' self time) and idle share, the matrix products' share and
    the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch, step_idx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ka = prof.key_averages()
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in ka
                         if e.device_type == DeviceType.CUDA)
    ops = sorted(((e.key, 1e-3 * e.self_device_time_total) for e in ka
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    products_ms = sum(ms for name, ms in ops if name in PRODUCT_OPS)
    launches = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms, "products_ms": products_ms,
           "kernel_launches": launches,
           "top_ops_ms": [[name, ms] for name, ms in ops[:8]]}
    print(f"{arch}: one profiled step {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {rec['idle_share']:.3f}), "
          f"{launches} kernel launches; matrix products {products_ms:.1f} "
          f"ms, the rest elementwise and reductions; most device time: "
          f"{', '.join(f'{n} {ms:.1f}' for n, ms in ops[:8])}  ({card})",
          flush=True)
    return rec


def profiled_run_step(arch: str, run, card: str) -> dict:
    """``profile_step`` on a ``launch.train`` run's final state with the
    next batch of its pipeline and its schedule."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import TrainStepConfig, make_train_step

    cfg = ARCHS[arch]
    step_fn = make_train_step(build_model(cfg).loss_fn, TrainStepConfig(
        peak_lr=3e-4, warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS))
    batch = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(
        TRAIN_STEPS)
    dev = run.params.device
    return profile_step(arch, step_fn, run.params, run.opt_state,
                        {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}, TRAIN_STEPS, card)


class TrainingStopped(Exception):
    """Raised where phase 30 stops a run right after its first
    checkpoint, as a crash there would."""


def stop_after_save(ckpt_mod, saved: list):
    """A stand-in for ``checkpoint.save`` that saves, appends (path,
    seconds, bytes) to ``saved`` and stops the run."""
    real = ckpt_mod.save

    def save_then_stop(directory, step, tree, extras=None):
        t0 = time.perf_counter()
        path = real(directory, step, tree, extras)
        saved.append((path, time.perf_counter() - t0,
                      sum(f.stat().st_size for f in Path(path).iterdir())))
        raise TrainingStopped(path)
    return save_then_stop


def f32_train_check(arch: str, layers: int, seq: int, gen, card: str) -> dict:
    """One training step's loss and gradients of ``arch``'s full width cut
    to ``layers`` layers in f32 (weights from ``gen`` on the card, the
    pipeline's first batch of one sequence): the card's loss within 1e-5
    of the CPU's, relative, and each leaf's gradient within 1e-4 of its
    largest |g| there, TF32 off."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import TrainStepConfig
    from repro_torch.train.step import value_and_grad

    cfg = ARCHS[arch].replace(n_layers=layers, dtype=torch.float32)
    model = build_model(cfg)
    p_card = model.init(generator=gen)
    batch = TokenPipeline(cfg, 1, seq, seed=1).batch_at(0)
    loss, grads = value_and_grad(
        model.loss_fn, p_card, {k: torch.from_numpy(v).to(p_card.device)
                                for k, v in batch.items()}, TrainStepConfig())
    p_cpu = type(p_card)(cfg, {k: v.detach().cpu() for k, v in
                               p_card.state_dict().items()})
    del p_card
    want_loss, want = value_and_grad(
        model.loss_fn, p_cpu, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, TrainStepConfig())
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    assert math.isfinite(float(loss)) and rel <= 1e-5, (arch, rel)
    worst = 0.0
    for name, g in want.items():
        scale = float(g.abs().max())
        err = float((grads[name].cpu() - g).abs().max())
        assert err <= 1e-4 * scale, (arch, name, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    print(f"{arch} at full width, {layers} layers, f32, one sequence of "
          f"{seq}: a training step's loss on the card {float(loss):.6f} "
          f"against the CPU's {float(want_loss):.6f} (relative {rel:.2e}, "
          f"bound 1e-5); gradients of {len(want)} leaves, the largest "
          f"|diff| {worst:.2e} of its leaf's max |g| (bound 1e-4), TF32 off "
          f" ({card})", flush=True)
    del grads, want, p_cpu
    torch.cuda.empty_cache()
    return {"layers": layers, "seq": seq, "loss": float(loss),
            "cpu_loss": float(want_loss), "loss_rel_diff": rel,
            "grad_max_rel_diff": worst}


def run_training(card: str) -> dict:
    """Phase 30: ``launch.train`` on gemma-2b at full width (bf16
    parameters, f32 AdamW state, random init from torch generator seed
    0, ``TokenPipeline(seed=0)``), 8 steps of 8 x 512 tokens; the same
    run checkpointing every 4 steps, stopped right after its first
    checkpoint; a fresh run restored from it takes steps 5-8 and must
    end where the uninterrupted run did, bit for bit; mamba2-130m at
    full width, 8 steps; each family's f32 cut on the card against the
    CPU.  No kernel of the port may launch.  One checkpoint of gemma-2b
    is 35 GB: the run writes only that one (the card's machine takes
    45 GiB of writes a call)."""
    import gc
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt

    assert not torch.backends.cuda.matmul.allow_tf32
    out: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_cli.run(train_argv(TRAIN_ARCH, None, 0))
    wall = time.perf_counter() - t0
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    rec = train_report(TRAIN_ARCH, first, card)
    rec["run_s"] = wall
    # the uninterrupted run's end, kept in host memory (35 GB)
    want = [t.detach().cpu() for _, t in ckpt.leaves((first.params,
                                                      first.opt_state))]
    del first
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = ROOT / "build" / "phase30_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved: list = []
    real_save = ckpt.save
    ckpt.save = stop_after_save(ckpt, saved)
    try:
        train_cli.run(train_argv(TRAIN_ARCH, ckpt_dir, TRAIN_CKPT_EVERY))
        raise AssertionError("the run was not stopped at its checkpoint")
    except TrainingStopped:
        pass
    finally:
        ckpt.save = real_save
    gc.collect()
    torch.cuda.empty_cache()
    try:
        assert os.listdir(ckpt_dir) == [f"step_{TRAIN_CKPT_EVERY - 1}"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # the fresh run saves no checkpoint of its own
        again = train_cli.run(train_argv(TRAIN_ARCH, ckpt_dir,
                                         10 * TRAIN_STEPS))
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert again.start_step == TRAIN_CKPT_EVERY
    assert again.losses == rec["losses"][TRAIN_CKPT_EVERY:], \
        (again.losses, rec["losses"])
    got = list(ckpt.leaves((again.params, again.opt_state)))
    assert len(got) == len(want)
    for (name, t), w in zip(got, want):
        assert torch.equal(w.to(t.device), t.detach()), name
    _, save_s, ckpt_bytes = saved[0]
    rec.update(resume_s=resume_s, restore_s=again.restore_s, save_s=save_s,
               checkpoint_bytes=ckpt_bytes, resumed_leaves=len(got))
    print(f"{TRAIN_ARCH}: the same run checkpointing every "
          f"{TRAIN_CKPT_EVERY} steps, stopped after its first checkpoint "
          f"({ckpt_bytes / 1e9:.2f} GB saved in {save_s:.1f} s); a fresh "
          f"run restored it in {again.restore_s:.1f} s, took steps "
          f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} ({resume_s:.1f} s in all) "
          f"and ended equal to the uninterrupted run, bit for bit: its "
          f"losses and all {len(got)} leaves of (params, opt_state)  "
          f"({card})", flush=True)
    del got, want
    rec["profile"] = profiled_run_step(TRAIN_ARCH, again, card)
    out[TRAIN_ARCH] = rec
    del again
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ssm = train_cli.run(train_argv(TRAIN_SSM, None, 0))
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    out[TRAIN_SSM] = train_report(TRAIN_SSM, ssm, card)
    out[TRAIN_SSM]["profile"] = profiled_run_step(TRAIN_SSM, ssm, card)
    del ssm
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    checks = {}
    for arch, (layers, seq) in TRAIN_CHECK.items():
        gen.manual_seed(1)
        checks[arch] = f32_train_check(arch, layers, seq, gen, card)
    out["f32_check"] = checks
    return out


def rerun_equal(name: str, fn) -> dict:
    """``fn()`` twice on the card: every output tensor must be equal bit for
    bit between the runs."""
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, (tuple, list)) else (first,)
    seconds = second if isinstance(second, (tuple, list)) else (second,)
    for i, (a, b) in enumerate(zip(firsts, seconds)):
        if a is None:
            continue
        assert torch.equal(a, b), f"{name}: output {i} moved between runs"
    return {"outputs": len(firsts),
            "elements": sum(int(t.numel()) for t in firsts
                            if t is not None)}


def wobble(name: str, fn) -> dict:
    """``fn()`` twice on the card: the count of elements whose bits moved
    between the runs and the largest relative difference, reported."""
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, (tuple, list)) else (first,)
    seconds = second if isinstance(second, (tuple, list)) else (second,)
    moved, rel, total, each = 0, 0.0, 0, []
    for a, b in zip(firsts, seconds):
        a64, b64 = a.double(), b.double()
        diff = (a64 - b64).abs()
        each.append(int((a != b).sum()))
        moved += each[-1]
        total += a.numel()
        scale = torch.maximum(a64.abs(), b64.abs()).clamp_min(1e-30)
        rel = max(rel, float((diff / scale).max()) if diff.numel() else 0.0)
    print(f"  wobble {name}: {moved} of {total} elements moved between two "
          f"runs (per output {each}), largest relative difference "
          f"{rel:.3e}", flush=True)
    return {"moved": moved, "elements": total, "max_rel": rel,
            "moved_per_output": each}


def run_analyzer(card: str, build_log: str, base_pts: np.ndarray,
                 base_dcut: float) -> dict:
    """Phase 31: ``repro_torch.analysis`` on the card.  The sweep over
    every valid spec and all four target groups on ``cuda:0`` (clean, every
    rule run; targets, skips, host syncs and launched kernels printed);
    the kernel attribute table (every instantiation, registers and stack
    frames held equal to ptxas's log of the phase-1 build, ``limits.py``
    held against the card's properties); the negative controls at
    ``plan()`` (a shared-memory budget below K12's, the ``REPRO_ANALYSIS=0``
    bypass counted, a record stripped of its resolve); the kernels whose
    bodies merge through atomics run twice, bit for bit; the four blessed
    float sums run twice, their wobble reported, and a CFSFDP-A fit of
    ``base_pts`` (phase 26's) twice, its rho and parent held equal bit for
    bit; the gate's cost per fresh spec."""
    from repro_torch import analysis
    from repro_torch.analysis import limits, r3_precision, record, targets
    from repro_torch.core import cfsfdp_a as cf
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid, point_span_bounds
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.engine import planner
    from repro_torch.engine.spec import ExecSpec
    from repro_torch.kernels import blocksparse, build, ops
    from repro_torch.serve import DPCKVConfig
    from repro_torch.serve.dpc_kv import compress_kv

    dev = torch.device("cuda")
    out: dict = {}
    assert os.environ.get("REPRO_ANALYSIS") is None, "the gate must be on"

    # ------------------------------------------- the attribute table
    lim = limits.card_limits()
    props = torch.cuda.get_device_properties(0)
    for field, want in (("shared_memory_per_block_optin",
                         lim.smem_optin_bytes),
                        ("shared_memory_per_block", lim.smem_default_bytes),
                        ("shared_memory_per_multiprocessor",
                         lim.smem_sm_bytes),
                        ("regs_per_multiprocessor", lim.regs_sm),
                        ("max_threads_per_block", lim.threads_block),
                        ("multi_processor_count", lim.sms)):
        got = getattr(props, field)
        assert got == want, f"limits.py: {field} {want}, the card {got}"
    rows = build.kernel_attrs(targets.DIM)
    usage = {build.kernel_name(k): u
             for k, u in build.ptxas_usage(build_log).items()}
    held = 0
    for r in rows:
        u = usage.get(r["name"])
        if u is not None:
            assert (u["registers"], u["stack_frame"]) == \
                (r["num_regs"], r["local_bytes"]), (r["name"], u, r)
            held += 1
        assert r["error"] == 0 and r["occupancy"] >= 1, r
        spill = "-" if u is None else \
            f"{u['spill_stores']}/{u['spill_loads']}"
        print(f"  {r['name']} d{r['d_lo']}{'+' if r['d_hi'] > 224 else ''}"
              f" {r['threads']}t {r['num_regs']}r smem {r['static_smem']}+"
              f"{r['dyn_smem']} local {r['local_bytes']} spill {spill} "
              f"occ {r['occupancy']}")
    functions = {r["name"].split("<")[0] for r in rows}
    assert len(functions) == 24, sorted(functions)
    assert held == len(rows) or not usage, (held, len(rows))
    print(f"attribute table: {len(rows)} instantiations of "
          f"{len(functions)} kernels at d = {targets.DIM}; registers and "
          f"stack frames equal to ptxas's on {held}; limits.py equal to the "
          f"card's properties", flush=True)
    out["attributes"] = {"rows": rows, "held_against_ptxas": held}

    # --------------------------------------------------------- the sweep
    t0 = time.perf_counter()
    rep = analysis.run_sweep(device="cuda:0")
    sweep_s = time.perf_counter() - t0
    # on the card R4's attribute half runs: a clean sweep has no finding
    # at all, and a target that raised would be a "trace" error
    assert rep["ok"] and rep["findings"] == [], rep["findings"]
    assert rep["device"] == "cuda" and \
        rep["rules_run"] == sorted(rep["rules"]), rep["rules_run"]
    launched = sorted(set().union(*(set(v) for v in
                                    rep["launches"].values())))
    print(f"sweep: {len(rep['targets'])} targets on the card in "
          f"{sweep_s:.2f} s, rules run {rep['rules_run']}, "
          f"{len(rep['findings'])} findings "
          f"{sorted({(f['rule'], f['severity']) for f in rep['findings']})}",
          flush=True)
    print(f"  skipped: {rep['skipped']}")
    print(f"  kernels the sweep launched: {launched}")
    print("  targets (host syncs): " + "; ".join(
        f"{t.removeprefix('plan[')} {c}"
        for t, c in rep["host_syncs"].items()), flush=True)
    out["sweep"] = {"seconds": sweep_s, "targets": rep["targets"],
                    "skipped": rep["skipped"], "findings": rep["findings"],
                    "host_syncs": rep["host_syncs"],
                    "launches": rep["launches"], "launched": launched}

    # ---------------------------------------------- negative controls
    k12 = next(r for r in rows
               if r["name"] == "fused_count_topk_bf16_kernel<1,false>")
    spec = ExecSpec(precision="bf16", block=31)

    def fresh():
        planner._ANALYZED.pop(spec, None)
        planner._PLANS.pop((None, spec), None)

    budget = k12["static_smem"] + k12["dyn_smem"] - 1
    os.environ["REPRO_LIMIT_SMEM_BYTES"] = str(budget)
    try:
        fresh()
        try:
            planner.plan(None, spec)
            raise AssertionError("a shared-memory budget below K12's "
                                 "passed plan()")
        except analysis.AnalysisError as exc:
            hit = [f for f in exc.findings if f.rule == "R9-memory-budget"
                   and "fused_count_topk_bf16_kernel" in f.message]
            assert hit, exc.findings
            print(f"negative control: REPRO_LIMIT_SMEM_BYTES={budget} "
                  f"(K12 takes {budget + 1} B): plan() raised "
                  f"AnalysisError: {hit[0].message}", flush=True)
        before = planner._M_FINDINGS.value(rule="R9-memory-budget",
                                           level="error")
        os.environ["REPRO_ANALYSIS"] = "0"
        fresh()
        assert planner.plan(None, spec) is not None
        counted = planner._M_FINDINGS.value(rule="R9-memory-budget",
                                            level="error") - before
        assert counted >= 1, counted
        print(f"  under REPRO_ANALYSIS=0 the plan is made and "
              f"analysis_findings_total counts {counted} R9 error(s)",
              flush=True)
    finally:
        os.environ.pop("REPRO_LIMIT_SMEM_BYTES", None)
        os.environ.pop("REPRO_ANALYSIS", None)
        fresh()
    pl = planner.plan(None, spec)
    with record.recording() as again:
        mem = pl.telemetry()["memory"]
    assert again == [] and mem["kernels"] and all(
        k["attributes"] for k in mem["kernels"]), (again, mem)
    assert mem["live_peak_bytes"] is not None, mem
    print("  telemetry()['memory'] of the fresh bf16 plan, from the gate's "
          "run (no launch): " + "; ".join(
              f"{k['kernel']} " + ", ".join(
                  f"{a['num_regs']}r {a['static_smem']}+{a['dyn_smem']} B "
                  f"occ {a['occupancy']}" for a in k["attributes"])
              for k in mem["kernels"])
          + f"; peak {mem['live_peak_bytes']} B", flush=True)
    events = pl._canonical.events["rho_delta"]
    stripped = [e for e in events if not (isinstance(e, record.Step)
                                          and e.kind == "resolve")]
    rule = r3_precision.PrecisionFlowRule()
    assert rule.check_launches("t", events) == []
    fired = rule.check_launches("t", stripped)
    assert fired, "R3 let a bf16 sweep through without its resolve"
    print(f"  a bf16 record stripped of its resolve: R3 fired "
          f"({fired[0].message[:60]}...)", flush=True)
    out["negative_controls"] = {"smem_budget": budget,
                                "bypass_counted": counted}
    out["telemetry_memory"] = mem

    # ------------------------------------------ the atomic kernels, twice
    pts, _ = real_proxy("airline", ANALYZER_N, seed=0)
    d_cut = pick_dcut(pts, target_rho=30)
    grid = build_grid(torch.from_numpy(pts).to(dev), d_cut)
    x = grid.points.contiguous()
    n = x.shape[0]
    key = ops.local_density_xy(x, x, d_cut) + density_jitter(n, dev)
    starts, ends = point_span_bounds(grid)
    wl = blocksparse.build_flat_worklist(x, x, d_cut)
    ring = blocksparse.build_flat_worklist(x, x, count=False, nn="best1")
    span_wl = blocksparse.build_flat_worklist(x, x, d_cut, nn=None,
                                              starts=starts, ends=ends)
    halo_ring = blocksparse.build_flat_worklist(
        x, x, d_cut, count=False, nn="best1", nn_dcut=True, starts=starts,
        ends=ends)
    tiles = wl.num_row_tiles
    slots = torch.arange(0, n, 3, device=dev)

    def with_counter(shape, dtype, fn):
        def run():
            c = torch.zeros(shape, dtype=dtype, device=dev)
            return (*fn(c), c)
        return run

    cases = {
        "K4 range_count": lambda: ops.local_density_xy(x, x, d_cut),
        "K2 masked_nn": lambda: ops.dependent_masked(x, key, x, key),
        "K6 gather_masked_nn (prefix form)":
            lambda: ops.dependent_masked_gather(x, key, slots),
        "K6 gather_masked_nn (key form)":
            lambda: ops.dependent_masked_gather(x, key, slots[:2048]),
        "K3 worklist_count_topk (pair counters)": with_counter(
            (tiles, 2), torch.int64,
            lambda c: ops.fused_sweep(x, x, d_cut, worklist=wl, ran=c)),
        "K9 worklist_masked_nn (walk counters)": with_counter(
            (ring.num_row_tiles, 2), torch.int32,
            lambda c: ops.dependent_masked(x, key, x, key, worklist=ring,
                                           live=c)),
        "K10 halo_range_count": lambda: ops.halo_density(
            x, x, starts, ends, d_cut),
        "K15 worklist_halo_range_count": lambda: ops.halo_density(
            x, x, starts, ends, d_cut, worklist=span_wl),
        "K11 halo_masked_nn": lambda: ops.halo_dependent(
            x, key, x, key, starts, ends, d_cut),
        "K16 worklist_halo_masked_nn (walk counters)": with_counter(
            (halo_ring.num_row_tiles, 2), torch.int32,
            lambda c: ops.halo_dependent(x, key, x, key, starts, ends,
                                         d_cut, worklist=halo_ring, live=c)),
        "K12 fused_count_topk_bf16 (insert counters)": with_counter(
            (n,), torch.int32,
            lambda c: ops.fused_sweep(x, x, d_cut, precision="bf16",
                                      inserted=c)),
        "halo_layout (keyed)": lambda: tuple(ops.halo_layout(
            key, x, key, starts, ends, ring=False)),
        "halo_layout (count, ring)": lambda: tuple(ops.halo_layout(
            None, x, None, starts, ends, ring=True)),
    }
    reruns = {}
    for name, fn in cases.items():
        reruns[name] = rerun_equal(name, fn)
    print(f"atomics: {len(cases)} kernels and layouts run twice on "
          f"{n:,} Airline-proxy points (d = {x.shape[1]}, d_cut "
          f"{d_cut:.6g}), every output equal bit for bit: "
          f"{sorted(reruns)}", flush=True)
    out["reruns"] = reruns

    # ------------------------------------------ the blessed float sums
    sums = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kc = torch.randn((SERVE_BATCH, SERVE_PROMPT + 32, 1, 256), device=dev,
                     generator=gen).to(torch.bfloat16)
    vc = torch.randn(kc.shape, device=dev, generator=gen).to(torch.bfloat16)
    kv = DPCKVConfig(budget=SERVE_BUDGET)
    sums["dpc_kv member sums (phase 28's 8 x 544 x 256 heads)"] = wobble(
        "compress_kv", lambda: compress_kv(kc, vc, SERVE_PROMPT, kv))
    del kc, vc
    bpts, _ = real_proxy("airline", WOBBLE_KMEANS_N, seed=0)
    bx = torch.from_numpy(bpts).to(dev)
    sums["cfsfdp_a k-means sums (phase 26's 2^20 points, k = 32)"] = wobble(
        "kmeans_pivots", lambda: cf.kmeans_pivots(bx, 32)[0])
    del bx
    # what kmeans_pivots' audit claims, held: the fit's rho and parent do
    # not move with the centroids' last bits
    fx = torch.from_numpy(base_pts).to(dev)

    def fit_twice():
        res = cf.run_cfsfdp_a(fx, base_dcut)
        return res.rho, res.parent

    fit = wobble("run_cfsfdp_a", fit_twice)
    assert fit["moved"] == 0, f"a CFSFDP-A fit moved between runs: {fit}"
    sums["cfsfdp_a fit, rho and parent (phase 26's 2^20 points)"] = fit
    del fx
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model, moe
    mcfg = ARCHS[FAMILY_DPC_KV].replace(n_layers=1)
    mparams = build_model(mcfg).init(generator=gen)
    xm = torch.randn((SERVE_BATCH, SERVE_PROMPT, mcfg.d_model), device=dev,
                     generator=gen).to(mcfg.dtype)
    with torch.inference_mode(), moe.dispatch_mode("scatter"):
        sums["moe combine (phase 29's granite-moe prefill, scatter mode)"] \
            = wobble("moe_ffn", lambda: moe.moe_ffn(
                xm, mparams.layer(0), mcfg)[0])
    del mparams, xm
    mix, _ = gaussian_mixture(REF_WINDOW + STREAM_BATCH, k=15, d=2, seed=0)
    mix = torch.from_numpy(mix).to(dev)
    signs = torch.where(torch.arange(STREAM_BATCH, device=dev) % 2 == 0,
                        1.0, -1.0)
    sums["ring walk weighted counts (phase 25's stream tick)"] = wobble(
        "ring_range_count", lambda: blocksparse.ring_range_count(
            mix[:REF_WINDOW], mix[REF_WINDOW:], 2000.0, signs))
    out["float_sums"] = sums
    torch.cuda.empty_cache()

    # ----------------------------------------------------- the gate's cost
    costs = {}
    for s in targets.sweep_specs():
        planner._ANALYZED.pop(s, None)
        planner._PLANS.pop((None, s), None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planner.plan(None, s)
        torch.cuda.synchronize()
        gate_ms = 1e3 * (time.perf_counter() - t0)
        planner._PLANS.pop((None, s), None)
        os.environ["REPRO_ANALYSIS"] = "suspend"
        try:
            t0 = time.perf_counter()
            planner.plan(None, s)
            torch.cuda.synchronize()
            bare_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            os.environ.pop("REPRO_ANALYSIS", None)
        costs[f"{s.backend or 'auto'}:{s.layout or '-'}:"
              f"{s.precision or '-'}"] = {"plan_ms": gate_ms,
                                          "suspended_ms": bare_ms}
    print("gate: cold plan() per fresh spec, ms (host clock ending in a "
          "synchronize), with the gate / with REPRO_ANALYSIS=suspend: "
          + "; ".join(f"{k} {v['plan_ms']:.2f} / {v['suspended_ms']:.3f}"
                      for k, v in costs.items()) + f"  ({card})", flush=True)
    out["gate_ms"] = costs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch import DPCEngine, ExecSpec
    from repro_torch.core.approxdpc import _group_segments, _maxima_mask
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.metrics import rand_index
    from repro_torch.core.sapproxdpc import representatives
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.kernels import blocksparse, build, ops, sweep
    from repro_torch.kernels.backend import get_backend

    dev = torch.device("cuda")
    record: dict = {}
    t_start = time.perf_counter()
    phase_s: dict[int, float] = {}

    # every plan the run makes, with the backend it asked for and got
    from repro_torch.engine import planner
    plans_made: list[tuple] = []
    plan_init = planner.DPCPlan.__init__

    def recording_init(self, pspec, spec):
        plan_init(self, pspec, spec)
        plans_made.append((spec.backend, self.backend_name))
    planner.DPCPlan.__init__ = recording_init

    def stamp(phase: int) -> None:
        """Seconds since the start at which a phase begins."""
        phase_s[phase] = time.perf_counter() - t_start
        print(f"[{phase_s[phase]:.1f} s] phase {phase}", flush=True)

    # ---------------------------------------------------- 1. card and build
    stamp(1)
    card = smi("name,power.limit")
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_rate = sms * F32_LANES_PER_SM * max_sm_mhz * 1e6
    global F32_ISSUE_PER_S
    F32_ISSUE_PER_S = issue_rate
    print(f"card: {card}")
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  SMs {sms}", flush=True)
    b = build.build()
    build_log = b.log           # phase 31 holds the attribute table to it
    print(f"build: {b.seconds:.2f} s  ({b.path.name})")
    usage = build.ptxas_usage(b.log)
    spills = [name for name, u in usage.items()
              if u["spill_stores"] or u["spill_loads"]]
    print(f"  ptxas: registers per instantiation "
          f"{[u['registers'] for u in usage.values()]}; spills in: "
          f"{spills or 'none'}")
    bf16_regs = bf16_ptxas(b.log)
    print(f"  ptxas, K12 (registers, spill bytes): {bf16_regs['K12']}")
    print(f"  ptxas, K13 (registers, spill bytes): {bf16_regs['K13']}")
    halo_regs = halo_ptxas(b.log)
    print(f"  ptxas, K10, K11, K15 and K16 at d = 3 (registers, spill "
          f"bytes): {halo_regs}")
    record.update(card=card, clocks=clocks, build_s=b.seconds,
                  bf16_ptxas=bf16_regs, halo_ptxas=halo_regs)

    # --------------------------------------- 2. kernels vs plain, check shapes
    stamp(2)
    def k1(x, y, d_cut):
        return ops.fused_sweep(x, y, d_cut)

    def k1_plain(x, y, d_cut):
        c, v, i = sweep.fused_count_topk_plain(x, y, sweep.d2cut_of(d_cut))
        return c.to(torch.float32), v, i

    def k3(x, y, d_cut, wl, live=None):
        return ops.fused_sweep(x, y, d_cut, worklist=wl, live=live)

    def k3_plain(x, y, d_cut, wl):
        c, v, i = sweep.worklist_count_topk_plain(x, y, sweep.d2cut_of(d_cut),
                                                  wl)
        return c.to(torch.float32), v, i

    def k3_live(x, y, d_cut, wl) -> int:
        """Entries K3 computes on these inputs (a separate launch)."""
        live = torch.zeros(wl.num_row_tiles, dtype=torch.int32, device=dev)
        k3(x, y, d_cut, wl, live=live)
        return int(live.sum())

    def k2(x, xk, y, yk):
        return ops.dependent_masked(x, xk, y, yk)

    def k2_plain(x, xk, y, yk):
        best, arg = sweep.masked_nn_plain(x, xk, y, yk)
        return torch.sqrt(best), arg

    cases = [("airline", real_proxy("airline", N_CHECK, seed=0)[0])]
    for d in (2, 4, 8):
        cases.append((f"mixture d={d}",
                      gaussian_mixture(1000, d=d, seed=d)[0]))
    cases.append(("normal d=64", np.random.default_rng(64).normal(
        size=(300, 64)).astype(np.float32)))
    lattice = np.stack(np.meshgrid(np.arange(128), np.arange(128)), -1)
    for label, pts in cases:
        x = torch.from_numpy(pts).to(dev)
        dc = pick_dcut(pts, target_rho=30)
        check_equal(f"fused_count_topk [{label}]", k1(x, x, dc),
                    k1_plain(x, x, dc))
        print(f"fused_count_topk == plain, bit for bit: {label}, "
              f"n={len(pts)} d={pts.shape[1]}", flush=True)
    xa = torch.from_numpy(cases[0][1]).to(dev)
    dca = pick_dcut(cases[0][1], target_rho=30)
    for r in K1_RAGGED_ROWS:
        check_equal(f"fused_count_topk [airline, {r} rows]",
                    k1(xa[:r].contiguous(), xa, dca),
                    k1_plain(xa[:r].contiguous(), xa, dca))
    print(f"fused_count_topk == plain, bit for bit: airline rows "
          f"{K1_RAGGED_ROWS} x {N_CHECK} (not multiples of a block's "
          f"rows)", flush=True)

    k3_checks = {}
    for label, pts, dc in [(lb, p, pick_dcut(p, target_rho=30))
                           for lb, p in cases] + [
            ("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
             2.5)]:
        x = torch.from_numpy(pts).to(dev)
        if pts.shape[1] <= 8:       # the drivers' layout: grid-sorted
            x = build_grid(x, dc).points
        wl = blocksparse.build_flat_worklist(x, x, dc)
        got = k3(x, x, dc, wl)
        check_equal(f"worklist_count_topk [{label}]", got,
                    k3_plain(x, x, dc, wl))
        check_equal(f"worklist_count_topk [{label}]", got, k1(x, x, dc),
                    "dense fused_count_topk")
        live = k3_live(x, x, dc, wl)
        k3_checks[label] = {"n": len(pts), "d": pts.shape[1],
                            "kept": wl.n_kept, "total": wl.n_total,
                            "in_cut": int(wl.in_cut.sum()), "live": live}
        print(f"worklist_count_topk == plain == dense K1, bit for bit: "
              f"{label}, n={len(pts)} d={pts.shape[1]}: {wl.n_kept} of "
              f"{wl.n_total} tile pairs kept, {live} computed", flush=True)

    pts = cases[0][1]
    x = torch.from_numpy(pts).to(dev)
    dc = pick_dcut(pts, target_rho=30)
    key = k1(x, x, dc)[0] + density_jitter(N_CHECK, dev)
    q, qk = x[:Q_CHECK].contiguous(), key[:Q_CHECK].contiguous()
    check_equal("masked_nn [airline]", k2(q, qk, x, key),
                k2_plain(q, qk, x, key))
    flat = torch.zeros(N_CHECK, device=dev)
    fd, fp = k2(q, flat[:Q_CHECK].contiguous(), x, flat)
    check_equal("masked_nn [equal keys]", (fd, fp),
                k2_plain(q, flat[:Q_CHECK].contiguous(), x, flat))
    assert torch.isinf(fd).all() and (fp == -1).all(), \
        "masked_nn with equal keys must return (inf, -1) everywhere"
    print(f"masked_nn == plain, bit for bit: q={Q_CHECK} m={N_CHECK} d=3, "
          f"and (inf, -1) everywhere for equal keys", flush=True)
    lat = torch.from_numpy(lattice.reshape(-1, 2).astype(np.float32)).to(dev)
    lk = torch.from_numpy(np.random.default_rng(3).integers(
        0, 3, len(lat)).astype(np.float32)).to(dev)        # 3 key levels
    check_equal("masked_nn [lattice 128x128]", k2(lat, lk, lat, lk),
                k2_plain(lat, lk, lat, lk))
    u = torch.from_numpy(np.random.default_rng(19).uniform(
        size=(600, 3)).astype(np.float32)).to(dev)
    far_x, far_y = (u[:300] + 1) * 2e19, -(u[300:] + 1) * 2e19
    far_k = torch.randperm(600, generator=torch.Generator().manual_seed(19)
                           ).to(dev, torch.float32)
    fd, fp = k2(far_x, far_k[:300].contiguous(), far_y,
                far_k[300:].contiguous())
    check_equal("masked_nn [coordinates near 1e19]", (fd, fp), k2_plain(
        far_x, far_k[:300].contiguous(), far_y, far_k[300:].contiguous()))
    assert torch.isinf(fd).all() and (fp == -1).all(), \
        "masked_nn where every d2 overflows must return (inf, -1)"
    print("masked_nn == plain, bit for bit: the 128x128 lattice of exact "
          "ties with three key levels; (inf, -1) where every d2 is inf "
          "(coordinates near 1e19)", flush=True)

    xs_check = build_grid(x, dc).points
    wl_check = blocksparse.build_flat_worklist(xs_check, xs_check, dc)
    check_times = {
        "fused_count_topk": {
            "shape": f"n=m={N_CHECK} d=3",
            "ms": time_ms(lambda: k1(x, x, dc)),
            "plain_ms": time_ms(lambda: k1_plain(x, x, dc))},
        "worklist_count_topk": {
            "shape": f"n=m={N_CHECK} d=3 grid-sorted, "
                     f"{wl_check.n_kept} entries",
            "ms": time_ms(lambda: k3(xs_check, xs_check, dc, wl_check)),
            "plain_ms": time_ms(lambda: k3_plain(xs_check, xs_check, dc,
                                                 wl_check)),
            "k1_sorted_ms": time_ms(lambda: k1(xs_check, xs_check, dc))},
        "masked_nn": {
            "shape": f"q={Q_CHECK} m={N_CHECK} d=3",
            "ms": time_ms(lambda: k2(q, qk, x, key)),
            "plain_ms": time_ms(lambda: k2_plain(q, qk, x, key))},
    }
    for name, t in check_times.items():
        print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms  ({card})", flush=True)

    # ------------------------------------------------- 3. the dense path
    stamp(3)
    main_pts, _ = real_proxy("airline", N_MAIN, seed=0)
    d_cut = pick_dcut(main_pts, target_rho=30)
    engine = DPCEngine(d_cut, rho_min=10)
    engine.fit(main_pts)                                   # warm-up
    torch.cuda.synchronize()

    # keep the inputs each kernel is given in a counted fit
    given: dict[str, list] = {}
    launch_sweep, launch_nn = ops.fused_sweep, ops.dependent_masked

    def recording_sweep(*a, **kw):
        kind = ("worklist_count_topk" if kw.get("worklist") is not None
                else "fused_count_topk")
        if kw.get("precision") == "bf16":
            kind += "_bf16"
        if kw.get("nn_sel") is not None:
            kind += "_sel"
        given[kind].append((*a, kw.get("worklist"), kw.get("nn_sel")))
        return launch_sweep(*a, **kw)

    def recording_nn(*a, **kw):
        kind = ("worklist_masked_nn" if kw.get("worklist") is not None
                else "masked_nn")
        given[kind].append(a)
        return launch_nn(*a, **kw)

    def counted_fit(eng, points):
        """(seconds, launch counts) of one fit, counts zeroed just before
        it and read just after; the kernels' inputs land in ``given``."""
        for name in ops.launch_counts():
            given[name] = []
        ops.fused_sweep, ops.dependent_masked = recording_sweep, recording_nn
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            eng.fit(points)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            ops.fused_sweep, ops.dependent_masked = launch_sweep, launch_nn
        for name, count in launches.items():
            assert len(given[name]) == count, (name, len(given[name]), count)
        return seconds, launches

    fit_s, launches_dense = counted_fit(engine, main_pts)
    k2_rows = [a[0].shape[0] for a in given["masked_nn"]]
    print(f"dense fit: n={N_MAIN} d=3 d_cut={d_cut!r}: {fit_s * 1e3:.1f} ms, "
          f"launches {launches_dense}, masked_nn rows {k2_rows}  ({card})",
          flush=True)
    for name in ("fused_count_topk", "masked_nn"):
        assert launches_dense[name] >= 1, \
            f"the dense path never launched {name}"
    assert launches_dense["worklist_count_topk"] == 0
    res, cl = engine.result, engine.clustering
    dense_given = dict(given)

    # ------------------------- 4. kernels vs plain, the dense path's shapes
    stamp(4)
    main_times: dict[str, dict] = {}
    errs: dict[str, float] = {}
    bounds: dict[str, tuple] = {}
    (mx, my, mdc, _, _), = dense_given["fused_count_topk"]
    full = k1(mx, my, mdc)
    assert torch.equal(res.rho, full[0]), "the fit's rho differs from K1's"
    want, plain_ms = timed_once(lambda: k1_plain(mx[:K1_PLAIN_ROWS], my, mdc))
    errs["fused_count_topk"] = check_equal(
        "fused_count_topk [dense path]", [t[:K1_PLAIN_ROWS] for t in full],
        want)
    main_times["fused_count_topk"] = {
        "ms": time_ms(lambda: k1(mx, my, mdc)), "plain_ms": plain_ms,
        "plain_rows": K1_PLAIN_ROWS}
    bounds["fused_count_topk"] = k1_work(mx.shape[0], my.shape[0],
                                         mx.shape[1])
    print(f"fused_count_topk == plain, bit for bit, on {K1_PLAIN_ROWS} rows "
          f"x {my.shape[0]} columns; the fit's rho == K1's count on all "
          f"{mx.shape[0]} rows", flush=True)

    dense_k2 = {"ms": 0.0, "plain_ms": 0.0}
    for i, (xq, xk, y, yk) in enumerate(dense_given["masked_nn"]):
        want, p_ms = timed_once(lambda: k2_plain(xq, xk, y, yk))
        check_equal(f"masked_nn [dense path, call {i}]", k2(xq, xk, y, yk),
                    want)
        dense_k2["ms"] += time_ms(lambda: k2(xq, xk, y, yk))
        dense_k2["plain_ms"] += p_ms
    print(f"masked_nn == plain, bit for bit: dense path q={k2_rows} "
          f"m={N_MAIN} d=3", flush=True)
    # few query rows against 2^20 columns (the column split), with the
    # callers' key forms: the fit's keys, tied integer keys, S-Approx-DPC's
    # -inf off a set of columns, NaN keys
    (_, _, sy, syk), = dense_given["masked_nn"][:1]
    gen_k = torch.Generator(device=dev).manual_seed(5)
    off = torch.rand(syk.shape, generator=gen_k, device=dev) < 0.6
    nan_y = syk.clone()
    nan_y[::5] = float("nan")
    split_k2 = {}
    for r in K2_SPLIT_ROWS:
        pick = torch.linspace(0, N_MAIN - 1, r, device=dev).round().long()
        q, qk = sy[pick].contiguous(), syk[pick].contiguous()
        nan_q = qk.clone()
        nan_q[::7] = float("nan")
        for kind, xk_, yk_ in (
                ("keys", qk, syk), ("tied", qk.floor(), syk.floor()),
                ("-inf columns", qk,
                 torch.where(off, float("-inf"), syk)),
                ("NaN keys", nan_q, nan_y)):
            check_equal(f"masked_nn [{r} rows x {N_MAIN}, {kind}]",
                        k2(q, xk_, sy, yk_), k2_plain(q, xk_, sy, yk_))
        split_k2[r] = time_ms(lambda: k2(q, qk, sy, syk))
    print(f"masked_nn == plain, bit for bit: {list(K2_SPLIT_ROWS)} rows x "
          f"{N_MAIN}, the fit's, tied, -inf and NaN keys; kernel "
          f"{split_k2} ms  ({card})", flush=True)
    print(f"fused_count_topk [dense path]: kernel "
          f"{main_times['fused_count_topk']['ms']:.3f} ms, plain "
          f"{plain_ms:.3f} ms on {K1_PLAIN_ROWS} rows; masked_nn: kernel "
          f"{dense_k2['ms']:.3f} ms, plain {dense_k2['plain_ms']:.3f} ms  "
          f"({card})", flush=True)

    # ---------------------------------------- 5. the dense fit against float64
    stamp(5)
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    _, exact_rows = float64_rho_check(pts64, res.rho, sweep.d2cut_of(d_cut),
                                      rows)
    print(f"rho == float64 count on {Q_CHECK} random rows ({exact_rows} "
          f"with no pair within 4 ulps of d_cut^2)", flush=True)
    xs = torch.from_numpy(main_pts).to(dev)
    grid = build_grid(xs, d_cut)
    maxima = torch.nonzero(_maxima_mask(grid, _group_segments(grid),
                                        res.rho_key)).flatten()
    n_rule2 = float64_dependent_check(pts64, res, maxima, d_cut)
    n_clusters = int(cl.num_clusters)
    assert n_clusters >= 1, "no cluster found"
    print(f"parent/delta == float64 masked search on all {maxima.numel()} "
          f"cell maxima ({n_rule2} rule 2); {n_clusters} clusters",
          flush=True)
    del pts64
    record["dense"] = {"fit_ms": fit_s * 1e3, "n": N_MAIN, "d_cut": d_cut,
                       "clusters": n_clusters, "cell_maxima": maxima.numel(),
                       "rule2_rows": n_rule2, "k2_rows": k2_rows,
                       "k2": dense_k2, "k2_split_ms": split_k2}

    # ------------------------------------------ 6. block-sparse at 2^20
    stamp(6)
    gs = grid.points
    wl, wl_ms = timed_once(lambda: blocksparse.build_flat_worklist(gs, gs,
                                                                   d_cut))
    got = k3(gs, gs, d_cut, wl)
    check_equal("worklist_count_topk [2^20]", got, k1(gs, gs, d_cut),
                "dense fused_count_topk")
    # the plain version on TILES_CHECK row tiles spread over the table (on
    # all 2^20 rows it took 47.9 s of the script's time limit)
    tiles = torch.linspace(0, wl.num_row_tiles - 1, TILES_CHECK).round() \
        .long().unique().to(dev)
    rows = (tiles[:, None] * blocksparse.BLOCK_N
            + torch.arange(blocksparse.BLOCK_N, device=dev)).flatten()
    rows = rows[rows < N_MAIN]
    want, k3_plain_ms = timed_once(lambda: k3_plain(
        gs[rows].contiguous(), gs, d_cut, sub_worklist(wl, tiles)))
    check_equal("worklist_count_topk [2^20, row tiles]",
                [t[rows] for t in got], want)
    sch = k3_schedule(gs, gs, d_cut, wl)
    k3_2e20 = {"kept": wl.n_kept, "total": wl.n_total,
               "in_cut": int(wl.in_cut.sum()), **sch,
               "needed_pairs": k3_needed_pairs(wl, N_MAIN, got[1]),
               "build_ms": wl_ms, "ms": time_ms(lambda: k3(gs, gs, d_cut, wl)),
               "plain_ms": k3_plain_ms, "plain_rows": rows.numel()}
    print(f"worklist_count_topk == dense K1 on all {N_MAIN} rows "
          f"(grid-sorted), == plain on {rows.numel()} rows of {tiles.numel()} "
          f"row tiles, bit for bit: {wl.n_kept} of {wl.n_total} tile "
          f"pairs kept ({int(wl.in_cut.sum())} in d_cut), "
          f"{k3_schedule_line(sch, k3_2e20['needed_pairs'])}; K3 "
          f"{k3_2e20['ms']:.3f} ms, plain {k3_plain_ms:.1f} ms, "
          f"build {wl_ms:.2f} ms  ({card})", flush=True)
    del want, got

    sparse_engine = DPCEngine(d_cut, rho_min=10,
                              exec_spec=ExecSpec(layout="block-sparse"))
    sparse_engine.fit(main_pts)                            # warm-up
    torch.cuda.synchronize()
    sparse_s, launches_2e20 = counted_fit(sparse_engine, main_pts)
    assert launches_2e20["fused_count_topk"] == 0 and \
        launches_2e20["masked_nn"] == 0 and \
        launches_2e20["worklist_count_topk"] >= 1 and \
        launches_2e20["worklist_masked_nn"] >= 1, launches_2e20
    print(f"block-sparse fit: n={N_MAIN}: {sparse_s * 1e3:.1f} ms (dense "
          f"{fit_s * 1e3:.1f} ms), launches {launches_2e20}  ({card})",
          flush=True)
    _, k9_2e20, _ = k9_fit_check(given["worklist_masked_nn"],
                                 "Approx-DPC 2^20, unresolved rows", card,
                                 torch.Generator().manual_seed(1))
    ties, tied, lab_diff = same_up_to_ties(
        xs, res, sparse_engine.result, cl.labels,
        sparse_engine.clustering.labels, "Approx-DPC block-sparse vs dense")
    print(f"block-sparse fit == dense fit at n={N_MAIN}: rho, rho_key, delta "
          f"equal; parent and labels equal except {ties} exact distance "
          f"ties ({tied} rows downstream of them, {lab_diff} labels "
          f"differ)", flush=True)
    k3_2e20.update(parent_ties=ties, fit_ms=sparse_s * 1e3, k9=k9_2e20)
    record["block_sparse_2e20"] = k3_2e20
    del sparse_engine, wl

    # ------------------------------ 7. Ex-DPC and Scan at 2^20, both layouts
    stamp(7)
    exact_fits, exact_rec = {}, {}
    for algo, layout in (("exdpc", "block-sparse"), ("scan", "block-sparse"),
                         ("exdpc", "dense")):
        eng = DPCEngine(d_cut, rho_min=10, algorithm=algo,
                        exec_spec=ExecSpec(layout=layout))
        eng.fit(main_pts)                                  # warm-up
        torch.cuda.synchronize()
        secs, launched = counted_fit(eng, main_pts)
        sparse = layout == "block-sparse"
        swept, skipped = ("worklist_count_topk", "fused_count_topk")[
            ::1 if sparse else -1]
        # the unresolved rows: K9 on their best-1 ring, or dense K2
        tail, no_tail = ("worklist_masked_nn", "masked_nn")[
            ::1 if sparse else -1]
        assert launched[swept] >= 1 and launched[tail] >= 1 \
            and launched[skipped] == 0 and launched[no_tail] == 0, \
            (algo, layout, launched)
        calls = given[tail]
        rows_k2 = [a[0].shape[0] for a in calls]
        ms_k2 = sum(time_ms(lambda a=a: k2(*a)) for a in calls)
        ms_tail = ms_k2 if not sparse else sum(time_ms(
            lambda a=a: ops.dependent_masked(
                *a, worklist=blocksparse.build_flat_worklist(
                    a[0], a[2], count=False, nn="best1"))) for a in calls)
        exact_fits[algo, layout] = eng
        exact_rec[f"{algo} {layout}"] = {
            "fit_ms": secs * 1e3, "launches": launched, "k2_rows": rows_k2,
            "k2_ms": ms_k2, "tail": tail, "tail_ms": ms_tail}
        print(f"{algo} fit, {layout}: n={N_MAIN}: {secs * 1e3:.1f} ms, "
              f"launches {launched}, {tail} rows {rows_k2}: {ms_tail:.3f} "
              f"ms (ring included; K2 on them {ms_k2:.3f} ms)  ({card})",
              flush=True)
    ex, sc = exact_fits["exdpc", "block-sparse"], exact_fits[
        "scan", "block-sparse"]
    for a, b in zip(ex.result, sc.result):
        assert torch.equal(a, b), "Ex-DPC differs from Scan"
    assert torch.equal(ex.clustering.labels, sc.clustering.labels), \
        "Ex-DPC labels differ from Scan's"
    assert torch.equal(ex.result.rho, res.rho), \
        "Ex-DPC rho differs from Approx-DPC's"
    ex_dense = exact_fits["exdpc", "dense"]
    ties, tied, lab_diff = same_up_to_ties(
        xs, ex_dense.result, ex.result, ex_dense.clustering.labels,
        ex.clustering.labels, "Ex-DPC block-sparse vs dense")
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    float64_dependent_check(pts64, ex.result, rows, None)
    del pts64
    exact_rec["dense_ties"] = ties
    record["exact_2e20"] = exact_rec
    ex_res, ex_labels = ex.result, ex.clustering.labels   # phases 14, 15
    ex_dense_res = ex_dense.result                         # phase 18
    ex_dense_labels = ex_dense.clustering.labels
    print(f"Ex-DPC block-sparse == Scan block-sparse, bit for bit; == Ex-DPC "
          f"dense except {ties} exact distance ties ({tied} rows downstream, "
          f"{lab_diff} labels differ); rho == Approx-DPC's; delta/parent == "
          f"float64 masked search on {Q_CHECK} random rows", flush=True)
    del exact_fits, ex, sc, ex_dense

    # ---------------------------- 8. the main path at full width (5.8M)
    stamp(8)
    full_pts, _ = real_proxy("airline", N_FULL, seed=0)
    d_full = pick_dcut(full_pts, target_rho=30)
    engine = DPCEngine(d_full, rho_min=10,
                       exec_spec=ExecSpec(layout="block-sparse"))
    engine.fit(full_pts)                                   # warm-up
    torch.cuda.synchronize()
    full_s, launches = counted_fit(engine, full_pts)
    k2_rows_full = [a[0].shape[0] for a in given["worklist_masked_nn"]]
    print(f"main path fit: n={N_FULL} d=3 d_cut={d_full!r} block-sparse: "
          f"{full_s * 1e3:.1f} ms, launches {launches}, worklist_masked_nn "
          f"rows {k2_rows_full}  ({card})", flush=True)
    for name in ("worklist_count_topk", "worklist_masked_nn"):
        assert launches[name] >= 1, f"the main path never launched {name}"
    for name in ("fused_count_topk", "masked_nn"):
        assert launches[name] == 0, \
            f"the block-sparse main path launched the dense {name}"
    fres, fcl = engine.result, engine.clustering
    phase8_fit = {"rho": fres.rho.cpu(), "delta": fres.delta.cpu(),
                  "parent": fres.parent.cpu(), "labels": fcl.labels.cpu()}

    pts64 = torch.from_numpy(full_pts).to(dev, torch.float64)
    rows = torch.randperm(N_FULL, generator=gen)[:Q_CHECK].to(dev)
    _, exact_rows = float64_rho_check(pts64, fres.rho,
                                      sweep.d2cut_of(d_full), rows)
    fx = torch.from_numpy(full_pts).to(dev)
    fgrid = build_grid(fx, d_full)
    fmax = torch.nonzero(_maxima_mask(fgrid, _group_segments(fgrid),
                                      fres.rho_key)).flatten()
    pick = fmax[torch.randperm(fmax.numel(), generator=gen)[:Q_CHECK]
                .to(dev)]
    n_rule2_full = float64_dependent_check(pts64, fres, pick, d_full)
    del pts64
    print(f"rho == float64 count on {Q_CHECK} random rows ({exact_rows} "
          f"clear of the band); parent/delta == float64 masked search on "
          f"{pick.numel()} random cell maxima of {fmax.numel()} "
          f"({n_rule2_full} rule 2, {pick.numel() - n_rule2_full} rule 3 "
          f"or peak); {int(fcl.num_clusters)} clusters", flush=True)

    # K3 against its plain version and dense K1 on 256 row tiles; K9 on
    # the fit's unresolved cell maxima beside K2 (the route), each against
    # its plain version on a slice
    (fxs, fys, fdc, fwl, _), = given["worklist_count_topk"]
    (errs["worklist_count_topk"], main_times["worklist_count_topk"],
     bounds["worklist_count_topk"], wl_full) = k3_row_tile_check(
        fxs, fys, fdc, fwl, None, "worklist_count_topk", card)
    errs["masked_nn"], main_times["masked_nn"], bounds["masked_nn"] = \
        k2_fit_check(given["worklist_masked_nn"], "main path", card)
    errs["worklist_masked_nn"], k9_main, bounds["worklist_masked_nn"] = \
        k9_fit_check(given["worklist_masked_nn"],
                     "main path, unresolved cell maxima", card, gen)
    main_times["worklist_masked_nn"] = {
        "ms": k9_main["k9_ms"], "plain_ms": k9_main["plain_ms"],
        "plain_rows": k9_main["plain_rows"], "route_ms": k9_main["route_ms"]}

    # traced fit: phase times and each phase's peak device memory
    del given, fxs, fys, fwl, fx, fgrid
    trace_full = traced(
        lambda: engine.fit(full_pts),
        ("engine.fit", "approxdpc.grid", "approxdpc.rho_delta",
         "rho_delta.worklist", "rho_delta.sweep", "rho_delta.resolve",
         "rho_delta.fallback", "approxdpc.rules", "labels.assign"),
        card, f"traced Approx-DPC fit, fallback rows {k2_rows_full}")

    # ---------------------- 9. stream kernels vs plain, check shapes
    stamp(9)
    n_clusters_full = int(fcl.num_clusters)
    del engine, fres, fcl
    plan_bytes(8, record)
    stream_cases = [("airline", cases[0][1], pick_dcut(cases[0][1],
                                                       target_rho=30), False)]
    for label, pts_c in cases[1:4]:
        stream_cases.append((label, pts_c, pick_dcut(pts_c, target_rho=30),
                             False))
    stream_cases.append(("lattice 128x128",
                         lattice.reshape(-1, 2).astype(np.float32), 2.5,
                         True))
    stream_check = stream_check_shapes(stream_cases, card)

    # ------------------ 10. the stream main path: mixture, 2^20 window
    stamp(10)
    mix, _ = gaussian_mixture(N_WINDOW + (MIX_TICKS + 2) * STREAM_BATCH
                              + N_PREDICT, k=15, d=2, seed=0)
    streams = {"mixture": run_stream("mixture", mix, 2000.0, MIX_TICKS, card)}
    del mix
    torch.cuda.empty_cache()

    # ---- 11. the Airline stream, 2^20 window, the dense path's d_cut
    stamp(11)
    air, _ = real_proxy("airline", N_WINDOW + (AIR_TICKS + 2) * STREAM_BATCH
                        + N_PREDICT, seed=0)
    streams["airline"] = run_stream("airline", air, d_cut, AIR_TICKS, card)
    del air
    torch.cuda.empty_cache()

    # ------------------- 12. S-Approx-DPC's kernels vs plain, check shapes
    stamp(12)
    k1s, k1s_plain, _, _, k7, k7_plain = sapprox_kernels()
    sapprox_check = sapprox_check_shapes(
        [(label, p, pick_dcut(p, target_rho=30)) for label, p in cases]
        + [("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
            2.5)], card)

    # ------------- 13. S-Approx-DPC at full width (5.8M): the main path
    stamp(13)
    member_delta = float(np.float32(min(SAPPROX_EPS, 1.0) * d_full))
    sa_engine = DPCEngine(d_full, algorithm="sapproxdpc", eps=SAPPROX_EPS,
                          rho_min=10, exec_spec=ExecSpec(layout="block-sparse"))
    sa_engine.fit(full_pts)                                # warm-up
    torch.cuda.synchronize()
    given = {}
    sa_s, sa_launches = counted_fit(sa_engine, full_pts)
    sres, scl = sa_engine.result, sa_engine.clustering
    sa_k2_rows = [a[0].shape[0] for a in given["worklist_masked_nn"]]
    assert sa_launches["worklist_count_topk_sel"] >= 1 and \
        sa_launches["worklist_masked_nn"] >= 1, sa_launches
    for name in ("fused_count_topk", "worklist_count_topk",
                 "fused_count_topk_sel", "masked_nn"):
        assert sa_launches[name] == 0, \
            f"the S-Approx-DPC main path launched {name}: {sa_launches}"
    fx = torch.from_numpy(full_pts).to(dev)
    fgrid = build_grid(fx, d_full)
    rep_slots, seg = representatives(fgrid, d_full, SAPPROX_EPS)
    rep_ids = fgrid.order[rep_slots]
    n_reps = rep_ids.numel()
    print(f"S-Approx-DPC fit: n={N_FULL} d=3 d_cut={d_full!r} eps="
          f"{SAPPROX_EPS} block-sparse: {sa_s * 1e3:.1f} ms, {n_reps} "
          f"representatives ({100 * n_reps / N_FULL:.1f} %), launches "
          f"{sa_launches}, worklist_masked_nn rows {sa_k2_rows}, "
          f"{int(scl.num_clusters)} clusters  ({card})", flush=True)
    is_rep = torch.zeros(N_FULL, dtype=torch.bool, device=dev)
    is_rep[rep_ids] = True
    rep_of = fgrid.order[rep_slots[seg]][fgrid.inv_order]
    member = ~is_rep
    assert torch.equal(sres.rho, sres.rho[rep_of]), \
        "a member's rho is not its representative's"
    assert bool((sres.parent[member].long() == rep_of[member]).all()), \
        "a member's parent is not its representative"
    assert bool((sres.delta[member] == member_delta).all()), \
        "a member's delta is not min(eps, 1) * d_cut"
    pts64 = fx.double()
    pick = rep_ids[torch.randperm(n_reps, generator=gen)[:Q_CHECK].to(dev)]
    _, sa_clear = float64_rho_check(pts64, sres.rho, sweep.d2cut_of(d_full),
                                    pick)
    n_ph1, n_ph2 = float64_sapprox_check(pts64, sres, rep_ids, is_rep, pick,
                                         d_full)
    del pts64
    print(f"members: rho, parent, delta from their representative, all "
          f"{int(member.sum())}; rho == float64 count on {Q_CHECK} random "
          f"representatives ({sa_clear} clear of the band); parent/delta == "
          f"float64 masked search among the representatives on them "
          f"({n_ph1} phase 1, {n_ph2} phase 2, "
          f"{Q_CHECK - n_ph1 - n_ph2} peak or at d_cut)", flush=True)

    (sxs, sys_, sdc, swl, ssel), = given["worklist_count_topk_sel"]
    (errs["worklist_count_topk_sel"], main_times["worklist_count_topk_sel"],
     bounds["worklist_count_topk_sel"], sa_wl) = k3_row_tile_check(
        sxs, sys_, sdc, swl, ssel, "worklist_count_topk_sel", card)
    del sxs, sys_, swl, ssel
    _, sa_k9, _ = k9_fit_check(given["worklist_masked_nn"],
                               "S-Approx-DPC main path, members keyed -inf",
                               card, gen)
    del given, fx, fgrid, rep_of, is_rep, member
    trace_sa = traced(
        lambda: sa_engine.fit(full_pts),
        ("engine.fit", "sapproxdpc.grid", "sapproxdpc.reps",
         "sapproxdpc.rep_sweep", "rho_delta.worklist", "rho_delta.sweep",
         "rho_delta.resolve", "rho_delta.fallback", "sapproxdpc.assemble",
         "labels.assign"),
        card, f"traced S-Approx-DPC fit, fallback rows {sa_k2_rows}")
    record["sapprox_full"] = {
        "fit_ms": sa_s * 1e3, "n": N_FULL, "d_cut": d_full,
        "eps": SAPPROX_EPS, "reps": n_reps, "launches": sa_launches,
        "clusters": int(scl.num_clusters), "phase1_rows": n_ph1,
        "phase2_rows": n_ph2, "k9": sa_k9, "worklist": sa_wl, **trace_sa}
    del sa_engine, sres, scl
    plan_bytes(13, record)

    # --------------------------- 14. the eps sweep at 2^20 (Table 5)
    stamp(14)
    ex_lab = ex_labels.cpu().numpy()
    eps_rec = {}
    for eps in EPS_SWEEP:
        eng = DPCEngine(d_cut, algorithm="sapproxdpc", eps=eps, rho_min=10,
                        exec_spec=ExecSpec(layout="block-sparse"))
        eng.fit(main_pts)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.fit(main_pts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ri = rand_index(eng.clustering.labels, ex_lab)
        n_r = representatives(grid, d_cut, eps)[0].numel()
        eps_rec[eps] = {"fit_ms": secs * 1e3, "reps": n_r, "rand_index": ri,
                        "clusters": int(eng.clustering.num_clusters)}
        assert ri >= 0.9, f"eps {eps}: Rand index {ri} against Ex-DPC"
        line = (f"eps {eps}: block-sparse fit n={N_MAIN} {secs * 1e3:.1f} "
                f"ms, {n_r} representatives, Rand index vs Ex-DPC {ri:.6f}, "
                f"{eps_rec[eps]['clusters']} clusters")
        if eps == SAPPROX_EPS:
            dense = DPCEngine(d_cut, algorithm="sapproxdpc", eps=eps,
                              rho_min=10, exec_spec=ExecSpec(layout="dense"))
            dense.fit(main_pts)                            # warm-up
            torch.cuda.synchronize()
            given = {}
            dsecs, sel_launches = counted_fit(dense, main_pts)
            assert sel_launches["fused_count_topk_sel"] >= 1 and \
                sel_launches["masked_nn"] >= 1 and \
                sel_launches["worklist_count_topk_sel"] == 0 and \
                sel_launches["fused_count_topk"] == 0, sel_launches
            ties, tied, lab_diff = same_up_to_ties(
                xs, dense.result, eng.result, dense.clustering.labels,
                eng.clustering.labels, "S-Approx-DPC dense vs block-sparse")
            (dx, dy, ddc, _, dsel), = given["fused_count_topk_sel"]
            r = min(SEL_PLAIN_ROWS, dx.shape[0])
            full_out = k1s(dx, dy, ddc, dsel)
            want, p_ms = timed_once(lambda: k1s_plain(dx[:r], dy, ddc, dsel))
            errs["fused_count_topk_sel"] = check_equal(
                "fused_count_topk_sel [dense S-Approx-DPC fit]",
                [t[:r] for t in full_out], want)
            main_times["fused_count_topk_sel"] = {
                "ms": time_ms(lambda: k1s(dx, dy, ddc, dsel)),
                "plain_ms": p_ms, "plain_rows": r}
            bounds["fused_count_topk_sel"] = k1_work(dx.shape[0],
                                                     dy.shape[0], dx.shape[1])
            eps_rec["dense"] = {"fit_ms": dsecs * 1e3,
                                "launches": sel_launches,
                                "parent_ties": ties}
            line += (f"; dense fit {dsecs * 1e3:.1f} ms, launches "
                     f"{sel_launches}, == block-sparse (rho, rho_key, delta "
                     f"bit for bit; {ties} parents decided by exact ties, "
                     f"{tied} rows downstream, {lab_diff} labels differ); "
                     f"gated K1 {main_times['fused_count_topk_sel']['ms']:.3f}"
                     f" ms on {dx.shape[0]} x {dy.shape[0]}, == plain on {r} "
                     f"rows ({p_ms:.1f} ms)")
            del dense, given, full_out, want, dx, dy, dsel
        print(line + f"  ({card})", flush=True)
        del eng
    record["eps_sweep_2e20"] = eps_rec

    # ---------------------------------------------- 15. K7 at 2^20
    stamp(15)
    rk = ex_res.rho_key
    order = torch.argsort(rk, descending=True, stable=True)
    tbl = xs[order].contiguous()
    ops.reset_launch_counts()
    d7, p7 = get_backend("cuda").prefix_nn(tbl)
    torch.cuda.synchronize()
    k7_launches = ops.launch_counts()["prefix_nn"]
    assert k7_launches == 1, f"prefix_nn launched {k7_launches} times"
    want_d, want_p = ex_res.delta[order], ex_res.parent[order].long()
    has = p7 >= 0
    par = torch.where(has, order[p7.clamp_min(0).long()], -1)
    key_tie = has & (rk[par.clamp_min(0)] == rk[order])
    assert bool((rk[par[has]] >= rk[order][has]).all()), \
        "prefix_nn's parent is not an earlier row"
    ok = ~key_tie
    assert torch.equal(d7[ok], want_d[ok]), \
        "prefix_nn's delta differs from the Ex-DPC fit's"
    differ = torch.nonzero(ok & (par != want_p)).flatten()
    assert bool(torch.equal(
        sweep.direct_d2(tbl[differ], xs[par[differ]]),
        sweep.direct_d2(tbl[differ], xs[want_p[differ]]))), \
        "prefix_nn's parent differs from Ex-DPC's without a distance tie"
    assert bool((d7[key_tie] <= want_d[key_tie]).all()), \
        "prefix_nn is farther than Ex-DPC on a row with an equal-key parent"
    want, k7_plain_ms = timed_once(lambda: k7_plain(
        tbl[:PREFIX_PLAIN_ROWS]))
    errs["prefix_nn"] = check_equal(
        "prefix_nn [2^20]", [d7[:PREFIX_PLAIN_ROWS], p7[:PREFIX_PLAIN_ROWS]],
        want)
    main_times["prefix_nn"] = {"ms": time_ms(lambda: k7(tbl)),
                               "plain_ms": k7_plain_ms,
                               "plain_rows": PREFIX_PLAIN_ROWS}
    bounds["prefix_nn"] = (4 * N_MAIN * 3 + 8 * N_MAIN,
                           N_MAIN * (N_MAIN - 1) / 2 * (3 * 3 + 1))
    record["prefix_2e20"] = {"key_tie_rows": int(key_tie.sum()),
                             "parent_ties": differ.numel(),
                             "launches": k7_launches}
    print(f"prefix_nn on the Ex-DPC table sorted by rho_key, n={N_MAIN}: "
          f"delta == the Ex-DPC fit's bit for bit on {int(ok.sum())} rows, "
          f"parents equal but {differ.numel()} exact distance ties; "
          f"{int(key_tie.sum())} rows whose nearest earlier row has an "
          f"equal f32 key (there K7 is as near or nearer); == plain on the "
          f"first {PREFIX_PLAIN_ROWS} rows; kernel "
          f"{main_times['prefix_nn']['ms']:.3f} ms, plain "
          f"{k7_plain_ms:.1f} ms on the rows  ({card})", flush=True)
    del want, d7, p7, tbl

    # --------------------- 16. the distributed kernels vs plain, check shapes
    stamp(16)
    dist_check = dist_check_shapes(
        [(label, p, pick_dcut(p, target_rho=30)) for label, p in cases]
        + [("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
            2.5)], card)

    # ------- 17. distributed Ex-DPC at full width (5.8M), four shards
    stamp(17)
    from repro_torch import obs
    from repro_torch.launch import ShardMesh
    k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain = \
        dist_kernels()
    dist_names = {"local_density_xy": ("range_count", "worklist_range_count"),
                  "dependent_masked": ("masked_nn", "worklist_masked_nn"),
                  "halo_density": ("halo_range_count",
                                   "worklist_halo_range_count"),
                  "halo_dependent": ("halo_masked_nn",
                                     "worklist_halo_masked_nn")}

    def counted_dist_fit(eng, points):
        """(seconds, launch counts, the kernels' inputs by kernel) of one
        fit, counts zeroed just before it and read just after."""
        given = {k: [] for names in dist_names.values() for k in names}
        launch_fns = {f: getattr(ops, f) for f in dist_names}

        def recorder(f):
            def record(*a, **kw):
                kind = dist_names[f][kw.get("worklist") is not None]
                given[kind].append((a, kw))
                return launch_fns[f](*a, **kw)
            return record

        for f in dist_names:
            setattr(ops, f, recorder(f))
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            eng.fit(points)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = ops.launch_counts()
        finally:
            for f, fn in launch_fns.items():
                setattr(ops, f, fn)
        for name, calls in given.items():
            assert len(calls) == launched[name], (name, len(calls),
                                                  launched[name])
        return seconds, launched, given

    single = DPCEngine(d_full, rho_min=10, algorithm="exdpc",
                       exec_spec=ExecSpec(layout="block-sparse"))
    single.fit(full_pts)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single.fit(full_pts)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    print(f"single-device Ex-DPC, block-sparse: n={N_FULL} d=3 d_cut="
          f"{d_full!r}: {single_s * 1e3:.1f} ms  ({card})", flush=True)
    fx = torch.from_numpy(full_pts).to(dev)
    pts64 = fx.double()
    dist_rec = {"single_exdpc_ms": single_s * 1e3, "shards": DIST_SHARDS}
    dist_given, dist_launches = {}, {}
    for strategy in ("halo", "gather"):
        eng = DPCEngine(d_full, rho_min=10, algorithm="exdpc",
                        mesh=ShardMesh.on("cuda", shards=DIST_SHARDS),
                        strategy=strategy,
                        exec_spec=ExecSpec(layout="block-sparse"))
        eng.fit(full_pts)                                  # warm-up
        torch.cuda.synchronize()
        # traced before the counted fit, whose kept inputs would count
        # towards the phases' peaks
        trace = traced(lambda: eng.fit(full_pts),
                       ("engine.fit", "dist.grid", "dist.rho", "dist.delta",
                        "dist.fallback", "labels.assign"), card,
                       f"traced distributed {strategy} fit (the shards are "
                       f"logical shards of one card: the times are the "
                       f"kernels' work split {DIST_SHARDS} ways, not an "
                       f"interconnect)")
        attrs = {sp["name"]: sp.get("attrs", {}) for sp in obs.spans()}
        secs, launched, given = counted_dist_fit(eng, full_pts)
        if strategy == "halo":
            swept = ("halo_range_count", "halo_masked_nn",
                     "worklist_masked_nn")
        else:
            swept = ("worklist_range_count", "worklist_masked_nn")
        for name in ("worklist_range_count", "worklist_masked_nn",
                     "halo_range_count", "halo_masked_nn", "range_count",
                     "masked_nn", "worklist_halo_range_count",
                     "worklist_halo_masked_nn"):
            assert (launched[name] >= 1) == (name in swept), \
                f"{strategy}: launches {launched}"
        ties, tied, lab_diff = same_up_to_ties(
            fx, single.result, eng.result, single.clustering.labels,
            eng.clustering.labels, f"distributed {strategy} vs single-device")
        rows = torch.randperm(N_FULL, generator=gen)[:Q_CHECK].to(dev)
        _, clear = float64_rho_check(pts64, eng.result.rho,
                                     sweep.d2cut_of(d_full), rows)
        float64_dependent_check(pts64, eng.result, rows, None)
        kl = {k: launched[k] for k in swept + ("masked_nn", "range_count")}
        print(f"distributed Ex-DPC, {strategy}, {DIST_SHARDS} shards on one "
              f"card, block-sparse: n={N_FULL}: {secs * 1e3:.1f} ms (single "
              f"device {single_s * 1e3:.1f} ms), launches {kl}; == the "
              f"single-device fit (rho, rho_key, delta bit for bit; {ties} "
              f"parents decided by exact distance ties, {tied} rows "
              f"downstream, {lab_diff} labels differ); rho == float64 on "
              f"{Q_CHECK} random rows ({clear} clear of the band), "
              f"delta/parent == float64 masked search on them  ({card})",
              flush=True)
        rec = {"fit_ms": secs * 1e3, "launches": launched,
               "parent_ties": ties, "labels_differ": lab_diff, **trace}
        m_rows = -(-N_FULL // DIST_SHARDS)
        if strategy == "halo":
            a = attrs["dist.rho"]
            unres = attrs.get("dist.fallback", {}).get("unresolved", 0)
            rec.update(window=a["window"], hops_fwd=a["hops_fwd"],
                       hops_bwd=a["hops_bwd"], unresolved=unres)
            print(f"  halo window W={a['window']}, hops {a['hops_fwd']} "
                  f"forward {a['hops_bwd']} back: the ring moves "
                  f"{(a['hops_fwd'] + a['hops_bwd']) * m_rows} rows per "
                  f"shard against the gather's {DIST_SHARDS * m_rows}; "
                  f"{unres} rows unresolved by the stencil go to the "
                  f"fallback (K9)", flush=True)
            spans = trace["phases_ms"]
            outside = spans.get("smoke.traced_fit", 0.0) - sum(
                v for k, v in spans.items() if k.startswith("dist.")
                or k == "labels.assign")
            setup = halo_setup_ms(full_pts, d_full, DIST_SHARDS)
            rec.update(setup_ms=setup, outside_spans_ms=outside)
            print(f"  the traced halo fit outside its dist.* and "
                  f"labels.assign spans: {outside:.1f} ms of "
                  f"{spans.get('smoke.traced_fit', 0.0):.1f}; its steps "
                  f"there, timed alone between synchronizes: " + ", ".join(
                      f"{k} {v:.1f} ms" for k, v in setup.items())
                  + f"  ({card})", flush=True)
        dist_rec[strategy] = rec
        dist_given[strategy], dist_launches[strategy] = given, launched
        del eng
    del pts64
    torch.cuda.empty_cache()

    # the kernels at the main path's shapes: times of every call of the
    # counted runs, plain versions on slices, bounds from their inputs
    g8 = dist_given["gather"]["worklist_range_count"]
    (x8, y8, dc8), kw8 = g8[0]
    sub, rows = row_tile_slice(kw8["worklist"], x8.shape[0], DIST_PLAIN_TILES)
    got = k8(x8[rows].contiguous(), y8, dc8, sub)
    check_equal("worklist_range_count [main path, row tiles]", [got],
                [k8(x8, y8, dc8, kw8["worklist"])[rows]], "the fit's call")
    want, p_ms = timed_once(lambda: k8_plain(x8[rows].contiguous(), y8, dc8,
                                             sub))
    errs["worklist_range_count"] = check_equal(
        "worklist_range_count [main path, row tiles]", [got], [want])
    main_times["worklist_range_count"] = {
        "ms": sum(time_ms(lambda a=a, kw=kw: k8(*a, kw["worklist"]))
                  for a, kw in g8), "plain_ms": p_ms,
        "plain_rows": rows.numel()}
    works = [k8_work(a[0], a[1], kw["worklist"]) for a, kw in g8]
    bounds["worklist_range_count"] = (sum(w[0] for w in works),
                                      sum(w[1] for w in works))

    k9_rec = {}
    for strategy in ("gather", "halo"):
        calls = dist_given[strategy]["worklist_masked_nn"]
        ms, nb, no, no0, comp, ring, longest = 0.0, 0.0, 0.0, 0.0, 0, 0, 0
        for (x9, xk9, y9, yk9), kw in calls:
            wl9 = kw["worklist"]
            (d9, _), walked, lng = k9_walks(x9, xk9, y9, yk9, wl9)
            comp, ring = comp + walked, ring + wl9.n_kept
            longest = max(longest, lng)
            ms += time_ms(lambda: k9(x9, xk9, y9, yk9, wl9))
            b, o, info = k9_work(x9, xk9, y9, yk9, wl9, torch.square(d9),
                                 gen=gen)
            nb, no, no0 = nb + b, no + o, no0 + info["ops_earlier"]
        k9_rec[strategy] = {"ms": ms, "calls": len(calls),
                            "rows": [c[0][0].shape[0] for c in calls],
                            "computed": comp, "longest_walk": longest,
                            "ring": ring, "bound": bound_ms(nb, no),
                            "bound_earlier": bound_ms(nb, no0),
                            "work": (nb, no)}
    (x9, xk9, y9, yk9), kw9 = dist_given["gather"]["worklist_masked_nn"][-1]
    sub, rows = row_tile_slice(kw9["worklist"], x9.shape[0], DIST_PLAIN_TILES)
    sx, sk = x9[rows].contiguous(), xk9[rows].contiguous()
    got = k9(sx, sk, y9, yk9, sub)
    check_equal("worklist_masked_nn [gather, row tiles]", got,
                [t[rows] for t in k9(x9, xk9, y9, yk9, kw9["worklist"])],
                "the fit's call")
    want, p_ms = timed_once(lambda: k9_plain(sx, sk, y9, yk9, sub))
    errs["worklist_masked_nn"] = max(errs["worklist_masked_nn"], check_equal(
        "worklist_masked_nn [gather, row tiles]", got, want))
    main_times["worklist_masked_nn"].update(
        gather_ms=k9_rec["gather"]["ms"], halo_fallback_ms=k9_rec["halo"]["ms"])

    for name, kern, plain, work in (
            ("halo_range_count", k10, k10_plain, k10_work),
            ("halo_masked_nn", k11, k11_plain, k11_work)):
        calls = dist_given["halo"][name]
        a0 = calls[0][0]
        r = min(DIST_PLAIN_ROWS, a0[0].shape[0])
        if name == "halo_masked_nn":   # x, x_key, window, w_key, starts, ends
            sl = [a0[0][:r].contiguous(), a0[1][:r].contiguous(), a0[2],
                  a0[3], a0[4][:r].contiguous(), a0[5][:r].contiguous()]
        else:                          # x, window, starts, ends
            sl = [a0[0][:r].contiguous(), a0[1], a0[2][:r].contiguous(),
                  a0[3][:r].contiguous()]
        want, p_ms = timed_once(lambda: plain(*sl, a0[-1]))
        got = kern(*sl, a0[-1])
        full = kern(*a0)
        got = [got] if name == "halo_range_count" else got
        full = [full] if name == "halo_range_count" else full
        want = [want] if name == "halo_range_count" else want
        check_equal(f"{name} [main path, {r} rows]", got,
                    [t[:r] for t in full], "the fit's call")
        errs[name] = check_equal(f"{name} [main path, {r} rows]", got, want)
        main_times[name] = {"ms": sum(time_ms(lambda a=a: kern(*a))
                                      for a, _ in calls),
                            "plain_ms": p_ms, "plain_rows": r}
        if name == "halo_range_count":
            works = [work(a[0], a[1], a[2], a[3]) for a, _ in calls]
            k10_info = []
            for a, _ in calls:
                lay = ops.halo_layout(None, a[1], None, a[2], a[3],
                                      ring=False)
                k10_info.append({
                    "pieces": count_pieces(lay),
                    "layout_ms": time_ms(lambda a=a: ops.halo_layout(
                        None, a[1], None, a[2], a[3], ring=False)),
                    "skip": k10_skip_share(*a)})
                del lay
        else:
            works = [work(*a[:6]) for a, _ in calls]
            k11_earlier = bound_ms(sum(w[0] for w in works),
                                   sum(w[2] for w in works))[0]
            k11_runs = [halo_runs(a[4], a[5], a[2].shape[0])
                        for a, _ in calls]
        bounds[name] = (sum(w[0] for w in works), sum(w[1] for w in works))
    for name in ("worklist_range_count", "halo_range_count",
                 "halo_masked_nn"):
        t = main_times[name]
        b_ms, by = bound_ms(*bounds[name])
        more = ""
        if name == "halo_range_count":
            sk = {k: sum(i["skip"][k] for i in k10_info)
                  for k in k10_info[0]["skip"]}
            no_margin = sk["skip_cols_no_shrink"] / max(sk["cols"], 1)
            lay_ms = sum(i["layout_ms"] for i in k10_info)
            more = (f"; its keyless layout alone {lay_ms:.3f} ms; ptxas "
                    f"(registers, spill bytes) "
                    f"{halo_regs.get('K10', 'not measured')}; pieces a shard "
                    f"(splits, pieces; a column a lane, a row a lane, two "
                    f"rows a lane): " + "; ".join(
                        f"{i['pieces']['splits']}, {i['pieces']['pieces']}; "
                        f"{i['pieces']['col_a_lane']}, "
                        f"{i['pieces']['row_a_lane']}, "
                        f"{i['pieces']['two_rows_a_lane']}"
                        for i in k10_info)
                    + f"; a distance skip of 32-column chunks beyond d_cut "
                    f"of their piece's rows (LB_SHRINK's margin) could pass "
                    f"over {100 * sk['skip_cols'] / max(sk['cols'], 1):.1f} "
                    f"% of the span columns, "
                    f"{100 * sk['skip_pairs'] / max(sk['pairs'], 1):.1f} % "
                    f"of the pairs ({100 * no_margin:.1f} % of the columns "
                    f"with no margin; {sk['chunks']} "
                    f"chunks)")
            dist_rec["k10"] = {"shards": k10_info, "skip": sk}
        if name == "halo_masked_nn":
            more = (f" (earlier count {k11_earlier:.3f}, a key test for "
                    f"every span column); ptxas (registers, spill bytes) "
                    f"{halo_regs.get('K11', 'not measured')}; rows per run "
                    f"(candidate cell) a shard: " + "; ".join(
                        f"{r['runs']} runs, mean {r['rows_mean']:.2f}, "
                        f"largest {r['rows_max']}, "
                        f"{100 * r['share_cols_runs_ge32']:.1f} % of the "
                        f"span columns in runs of 32 rows or more"
                        for r in k11_runs))
            dist_rec["k11"] = {"bound_ms_earlier": k11_earlier,
                               "runs": k11_runs}
        print(f"{name} [main path, all calls]: kernel {t['ms']:.3f} ms, "
              f"bound {b_ms:.3f} ms ({by}){more}, == plain on "
              f"{t['plain_rows']} rows ({t['plain_ms']:.1f} ms)  ({card})",
              flush=True)
    for strategy, r9 in k9_rec.items():
        print(f"worklist_masked_nn [{strategy}]: {r9['calls']} calls on "
              f"{r9['rows']} rows, {r9['ms']:.3f} ms, its row walks computed "
              f"{r9['computed']} entries (the rings: {r9['ring']}), longest "
              f"walk {r9['longest_walk']}, bound {r9['bound'][0]:.3f} ms "
              f"({r9['bound'][1]}; earlier count "
              f"{r9['bound_earlier'][0]:.3f})  ({card})", flush=True)
    dist_rec["k9"] = {k: {kk: vv for kk, vv in v.items() if kk != "work"}
                      for k, v in k9_rec.items()}
    record["distributed_full"] = dist_rec
    # phase 23 runs K15/K16 on the halo fit's K10/K11 inputs: kept in host
    # memory meanwhile, so they add nothing to later phases' device peaks
    halo_calls = {name: [tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                               for t in a)
                         for a, _ in dist_given["halo"][name]]
                  for name in ("halo_range_count", "halo_masked_nn")}
    del dist_given, g8, x8, y8, kw8, sub, x9, xk9, y9, yk9, kw9, sx, sk
    del single, fx
    plan_bytes(17, record)

    # ------------- 18. the dense gather strategy at 2^20, four shards
    stamp(18)
    dense_dist = DPCEngine(d_cut, rho_min=10, algorithm="exdpc",
                           mesh=ShardMesh.on("cuda", shards=DIST_SHARDS),
                           strategy="gather")
    dense_dist.fit(main_pts)                               # warm-up
    torch.cuda.synchronize()
    secs, launched, _ = counted_dist_fit(dense_dist, main_pts)
    assert launched["range_count"] == launched["masked_nn"] == DIST_SHARDS \
        and not any(launched[k] for k in (
            "worklist_range_count", "worklist_masked_nn",
            "halo_range_count", "halo_masked_nn",
            "worklist_halo_range_count", "worklist_halo_masked_nn")), \
        launched
    ties, tied, lab_diff = same_up_to_ties(
        xs, ex_dense_res, dense_dist.result, ex_dense_labels,
        dense_dist.clustering.labels, "dense gather vs dense Ex-DPC")
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    float64_rho_check(pts64, dense_dist.result.rho, sweep.d2cut_of(d_cut),
                      rows)
    float64_dependent_check(pts64, dense_dist.result, rows, None)
    del pts64
    record["distributed_dense_2e20"] = {
        "fit_ms": secs * 1e3, "launches": launched, "parent_ties": ties,
        "exdpc_dense_ms": exact_rec["exdpc dense"]["fit_ms"]}
    print(f"distributed Ex-DPC, gather, dense, {DIST_SHARDS} shards: "
          f"n={N_MAIN}: {secs * 1e3:.1f} ms (single-device dense Ex-DPC "
          f"{exact_rec['exdpc dense']['fit_ms']:.1f} ms), launches "
          f"range_count {launched['range_count']}, masked_nn "
          f"{launched['masked_nn']}; == phase 7's dense Ex-DPC (rho, rho_key, "
          f"delta bit for bit; {ties} parents decided by exact ties, {tied} "
          f"rows downstream, {lab_diff} labels differ); rho and delta/parent "
          f"== float64 on {Q_CHECK} random rows  ({card})", flush=True)
    del dense_dist
    torch.cuda.empty_cache()

    # ---------------- 19. the bf16 kernels vs plain, check shapes (K12-K14)
    stamp(19)
    bf16_check = bf16_check_shapes(card)
    k12, k12_plain, k13, k13_plain, k14, k14_plain = bf16_kernels()

    # -------------- 20. bf16 at full width on exact data: the 2^20 lattice
    stamp(20)
    lat_pts = np.random.default_rng(0).integers(
        0, 256, (N_MAIN, 3)).astype(np.float32)
    lat_dc = math.sqrt(30.5)
    lat_x = torch.from_numpy(lat_pts).to(dev)
    lat_rec, lat_fits, lat_given, lat_launches = {}, {}, {}, {}
    f32_sweeps = ("fused_count_topk", "worklist_count_topk",
                  "fused_count_topk_sel", "worklist_count_topk_sel")
    for algo, layout in (("approxdpc", "dense"),
                         ("approxdpc", "block-sparse"),
                         ("sapproxdpc", "dense"),
                         ("sapproxdpc", "block-sparse"),
                         ("exdpc", "block-sparse")):
        kw = {"eps": SAPPROX_EPS} if algo == "sapproxdpc" else {}
        ref = DPCEngine(lat_dc, rho_min=10, algorithm=algo,
                        exec_spec=ExecSpec(layout=layout), **kw)
        ref_s, _ = counted_fit(ref, lat_pts)
        eng = DPCEngine(lat_dc, rho_min=10, algorithm=algo, exec_spec=ExecSpec(
            layout=layout, precision="bf16"), **kw)
        eng.fit(lat_pts)                                   # warm-up
        torch.cuda.synchronize()
        secs, launched = counted_fit(eng, lat_pts)
        swept = ("worklist_count_topk_bf16" if layout == "block-sparse"
                 else "fused_count_topk_bf16")
        swept += "_sel" if algo == "sapproxdpc" else ""
        assert launched[swept] >= 1 and not any(
            launched[k] for k in f32_sweeps), (algo, layout, launched)
        for name in ("rho", "rho_key", "delta", "parent"):
            assert torch.equal(getattr(eng.result, name),
                               getattr(ref.result, name)), \
                f"bf16 {algo} {layout} on the lattice: {name} differs from f32"
        assert torch.equal(eng.clustering.labels, ref.clustering.labels), \
            f"bf16 {algo} {layout} on the lattice: labels differ from f32"
        lat_given[algo, layout] = list(given[swept])
        lat_launches[algo, layout] = launched
        lat_fits[algo, layout] = eng
        lat_rec[f"{algo} {layout}"] = {
            "fit_ms": secs * 1e3, "f32_fit_ms": ref_s * 1e3,
            "launches": {k: v for k, v in launched.items() if v},
            "k2_rows": [a[0].shape[0] for a in given["masked_nn"]
                        + given["worklist_masked_nn"]],
            "clusters": int(eng.clustering.num_clusters)}
        print(f"bf16 {algo} {layout} on the 2^20 lattice: {secs * 1e3:.1f} "
              f"ms (f32 {ref_s * 1e3:.1f} ms), launches "
              f"{lat_rec[f'{algo} {layout}']['launches']}; == the f32 fit "
              f"bit for bit (rho, rho_key, delta, parent, labels), "
              f"{lat_rec[f'{algo} {layout}']['clusters']} clusters  ({card})",
              flush=True)
        del ref
    for algo in ("approxdpc", "sapproxdpc"):
        a, b = lat_fits[algo, "dense"], lat_fits[algo, "block-sparse"]
        ties, tied, lab_diff = same_up_to_ties(
            lat_x, a.result, b.result, a.clustering.labels,
            b.clustering.labels, f"bf16 {algo} block-sparse vs dense")
        lat_rec[f"{algo} layouts"] = {"parent_ties": ties,
                                      "rows_downstream": tied,
                                      "labels_differ": lab_diff}
        print(f"bf16 {algo} block-sparse == dense on the lattice: rho, "
              f"rho_key, delta bit for bit; {ties} parents decided by exact "
              f"distance ties ({tied} rows downstream, {lab_diff} labels "
              f"differ)", flush=True)
    del lat_fits

    # K12 (gated or not) on the dense fits' full inputs: == f32 K1, == plain
    # on a slice; K13 (gated or not) on the block-sparse fits' inputs: ==
    # f32 K3 on them, == plain on row tiles; each timed against its f32 form
    for algo, gated in (("approxdpc", ""), ("sapproxdpc", "_sel")):
        (x, y, dc, _, sel), = lat_given[algo, "dense"]
        name = "fused_count_topk_bf16" + gated
        full = k12(x, y, dc, sel)
        check_equal(f"{name} [2^20 lattice]", full,
                    ops.fused_sweep(x, y, dc, nn_sel=sel), "f32 K1")
        r = min(K1_PLAIN_ROWS, x.shape[0])
        want, p_ms = timed_once(lambda: k12_plain(x[:r], y, dc, sel))
        errs[name] = check_equal(f"{name} [2^20 lattice, {r} rows]",
                                 [t[:r] for t in full], want)
        ins = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
        ops.fused_sweep(x, y, dc, nn_sel=sel, inserted=ins,
                        precision="bf16")
        pairs = float(x.shape[0]) * y.shape[0]
        t = main_times[name] = {
            "ms": time_ms(lambda: k12(x, y, dc, sel), BF16_FULL_REPS),
            "rows": x.shape[0], "plain_ms": p_ms, "plain_rows": r,
            "f32_ms": time_ms(
                lambda: ops.fused_sweep(x, y, dc, nn_sel=sel),
                BF16_FULL_REPS),
            "insertions_mean": float(ins.double().mean()),
            "insertions_max": int(ins.max()),
            "ptxas": bf16_regs["K12"].get("d<=8" + (" gated" if gated
                                                       else ""),
                                          "not measured (library reused)")}
        t.update(pairs_per_s=pairs / (t["ms"] * 1e-3),
                 f32_ratio=t["ms"] / t["f32_ms"])
        bounds[name] = bf16_work(x.shape[0], y.shape[0], x.shape[1],
                                 pairs, sel)
        t["bound_share"] = bf16_bound_ms(*bounds[name])[0] / t["ms"]
        print(f"{name} [2^20 lattice]: {t['pairs_per_s']:.4g} pairs/s, "
              f"{100 * t['bound_share']:.1f} % of its bound, "
              f"{t['f32_ratio']:.3f} x f32 K1's time; kept-list insertions "
              f"per row mean {t['insertions_mean']:.1f}, max "
              f"{t['insertions_max']}; ptxas {t['ptxas']}  ({card})",
              flush=True)
        del full, want, ins
        (x, y, dc, wl, sel), = lat_given[algo, "block-sparse"]
        name = "worklist_count_topk_bf16" + gated
        live = torch.zeros(wl.num_row_tiles, dtype=torch.int32, device=dev)
        got = k13(x, y, dc, wl, sel, live)
        check_equal(f"{name} [2^20 lattice]", got,
                    ops.fused_sweep(x, y, dc, nn_sel=sel, worklist=wl),
                    "f32 K3")
        sub, rows = row_tile_slice(wl, x.shape[0], TILES_CHECK // 16)
        want, p_ms = timed_once(lambda: k13_plain(x[rows].contiguous(), y,
                                                  dc, sub, sel))
        errs[name] = check_equal(f"{name} [2^20 lattice, row tiles]",
                                 [t[rows] for t in got], want)
        pairs = k13_pairs(wl, x.shape[0], y.shape[0], live)
        t = main_times[name] = {
            "ms": time_ms(lambda: k13(x, y, dc, wl, sel)), "plain_ms": p_ms,
            "plain_rows": rows.numel(), "f32_ms": time_ms(
                lambda: ops.fused_sweep(x, y, dc, nn_sel=sel, worklist=wl)),
            "kept": wl.n_kept, **k13_walk(wl, live), "pairs": pairs,
            "ptxas": bf16_regs["K13"].get("d<=8" + (" gated" if gated
                                                    else ""),
                                          "not measured (library reused)")}
        bounds[name] = bf16_work(x.shape[0], y.shape[0], x.shape[1], pairs,
                                 sel, wl)
        t.update(pairs_per_s=pairs / (t["ms"] * 1e-3),
                 bound_share=bf16_bound_ms(*bounds[name])[0] / t["ms"])
        print(f"{name} [2^20 lattice]: {t['pairs_per_s']:.4g} pairs/s, "
              f"{100 * t['bound_share']:.1f} % of its bound; entries "
              f"computed {t['computed']} of {t['kept']} (at most "
              f"{t['computed_max_tile']} in a row tile), walks ended past "
              f"the split in {t['ended_past_split']} of {t['row_tiles']} "
              f"row tiles; ptxas {t['ptxas']}  ({card})", flush=True)
        del got, want
    for name in ("fused_count_topk_bf16", "worklist_count_topk_bf16",
                 "fused_count_topk_bf16_sel", "worklist_count_topk_bf16_sel"):
        t = main_times[name]
        b_ms, by = bf16_bound_ms(*bounds[name])
        print(f"{name} [2^20 lattice fit's inputs]: kernel {t['ms']:.3f} ms, "
              f"f32 form {t['f32_ms']:.3f} ms, bound {b_ms:.3f} ms ({by}); "
              f"== f32 and == plain on {t['plain_rows']} rows "
              f"({t['plain_ms']:.1f} ms)  ({card})", flush=True)
    record["bf16_lattice"] = lat_rec
    del lat_given, lat_x, x, y, wl, sel, sub, rows, live

    # ------------- 21. bf16 on the users' data: Airline at 5.8M, Approx-DPC
    stamp(21)
    f32_air = DPCEngine(d_full, rho_min=10,
                        exec_spec=ExecSpec(layout="block-sparse"))
    f32_air.fit(full_pts)                                  # warm-up
    torch.cuda.synchronize()
    f32_air_s, _ = counted_fit(f32_air, full_pts)
    bf_air = DPCEngine(d_full, rho_min=10, exec_spec=ExecSpec(
        layout="block-sparse", precision="bf16"))
    bf_air.fit(full_pts)                                   # warm-up
    torch.cuda.synchronize()
    air_s, air_launches = counted_fit(bf_air, full_pts)
    assert air_launches["worklist_count_topk_bf16"] >= 1 \
        and air_launches["worklist_masked_nn"] >= 1 and not any(
            air_launches[k] for k in (*f32_sweeps, "fused_count_topk_bf16")), \
        air_launches
    air_k2_rows = [a[0].shape[0] for a in given["worklist_masked_nn"]]
    (x, y, dc, wl, _), = given["worklist_count_topk_bf16"]
    del given
    fr, br = f32_air.result, bf_air.result
    rho_differ = int((fr.rho != br.rho).sum())
    ri = rand_index(bf_air.clustering.labels, f32_air.clustering.labels)
    centers = (int(f32_air.clustering.num_clusters),
               int(bf_air.clustering.num_clusters))
    sub, rows = row_tile_slice(wl, x.shape[0], DIST_PLAIN_TILES)
    xr = x[rows].contiguous()
    got = k13(xr, y, dc, sub)
    check_equal("worklist_count_topk_bf16 [Airline 5.8M, row tiles]", got,
                [t[rows] for t in k13(x, y, dc, wl)], "the fit's full sweep")
    want, p_ms = timed_once(lambda: k13_plain(xr, y, dc, sub))
    tol = bf16_within_tolerance(
        "worklist_count_topk_bf16 [Airline 5.8M, row tiles]", xr, y, dc,
        got, want)
    live = torch.zeros(wl.num_row_tiles, dtype=torch.int32, device=dev)
    k13(x, y, dc, wl, live=live)
    errs["worklist_count_topk_bf16"] = tol["max_abs_err"]
    pairs = k13_pairs(wl, x.shape[0], y.shape[0], live)
    t = main_times["worklist_count_topk_bf16"] = {
        "ms": time_ms(lambda: k13(x, y, dc, wl)), "plain_ms": p_ms,
        "plain_rows": rows.numel(), "f32_ms": time_ms(
            lambda: ops.fused_sweep(x, y, dc, worklist=wl)),
        "kept": wl.n_kept, **k13_walk(wl, live), "pairs": pairs,
        "ptxas": bf16_regs["K13"].get("d<=8", "not measured (library "
                                              "reused)"),
        "tolerance": tol, "lattice": main_times["worklist_count_topk_bf16"]}
    bounds["worklist_count_topk_bf16"] = bf16_work(
        x.shape[0], y.shape[0], x.shape[1], pairs, None, wl)
    b_ms, by = bf16_bound_ms(*bounds["worklist_count_topk_bf16"])
    t.update(pairs_per_s=pairs / (t["ms"] * 1e-3),
             bound_share=b_ms / t["ms"])
    del x, y, wl, xr, got, want, sub, rows, live
    trace_air = traced(
        lambda: bf_air.fit(full_pts),
        ("engine.fit", "approxdpc.rho_delta", "rho_delta.worklist",
         "rho_delta.sweep", "rho_delta.resolve", "rho_delta.fallback"),
        card, f"traced bf16 Approx-DPC fit, fallback rows {air_k2_rows}")
    record["bf16_airline"] = {
        "fit_ms": air_s * 1e3, "f32_fit_ms": f32_air_s * 1e3,
        "launches": {k: v for k, v in air_launches.items() if v},
        "k2_rows": air_k2_rows, "rho_rows_differ": rho_differ,
        "rand_index_vs_f32": ri, "centers_f32_bf16": centers,
        "k13": t, **trace_air}
    print(f"bf16 Approx-DPC block-sparse, Airline n={N_FULL}: "
          f"{air_s * 1e3:.1f} ms (f32 {f32_air_s * 1e3:.1f} ms), launches "
          f"{record['bf16_airline']['launches']}, masked_nn rows "
          f"{air_k2_rows}; rho differs from f32 on {rho_differ} rows, Rand "
          f"index vs f32 {ri:.6f}, centers f32 {centers[0]} bf16 "
          f"{centers[1]}; K13 {t['ms']:.3f} ms (f32 K3 {t['f32_ms']:.3f} ms, "
          f"bound {b_ms:.3f} ms, {by}), {t['computed']} of {t['kept']} "
          f"entries computed (at most {t['computed_max_tile']} in a row "
          f"tile; walks ended past the split in {t['ended_past_split']} of "
          f"{t['row_tiles']} row tiles), {t['pairs_per_s']:.4g} pairs/s, "
          f"{100 * t['bound_share']:.1f} % of its bound, ptxas "
          f"{t['ptxas']}; == plain within d*2^-20*(|x|^2+|y|^2) on "
          f"{t['plain_rows']} rows: {tol}  ({card})", flush=True)
    del f32_air, bf_air, fr, br
    plan_bytes(21, record)

    # ------- 22. K14 at the stream's shape: Airline window 2^20, batch 8192
    stamp(22)
    air_stream, _ = real_proxy("airline", N_WINDOW + STREAM_BATCH, seed=3)
    win = build_grid(torch.from_numpy(air_stream[:N_WINDOW]).to(dev),
                     d_cut).points
    delta_pts = torch.from_numpy(np.concatenate(
        [air_stream[N_WINDOW:], air_stream[:STREAM_BATCH]])).to(dev)
    delta_signs = torch.cat([torch.ones(STREAM_BATCH, device=dev),
                             -torch.ones(STREAM_BATCH, device=dev)])
    bgrid = build_grid(delta_pts, d_cut)
    batch = bgrid.points
    signs = delta_signs[bgrid.order.long()].contiguous()
    be = get_backend("cuda")
    ops.reset_launch_counts()
    got = be.range_count_delta(win, batch, signs, d_cut,
                               layout="block-sparse")
    torch.cuda.synchronize()
    k14_launches = ops.launch_counts()
    assert k14_launches["worklist_range_count_signed"] == 1 \
        and k14_launches["range_count_signed"] == 0, k14_launches
    dense14 = ops.local_density_delta(win, batch, signs, d_cut)
    check_equal("worklist_range_count_signed [stream shape]", [got],
                [dense14], "dense K5")
    wl14, build_ms = timed_once(lambda: blocksparse.build_flat_worklist(
        win, batch, d_cut, nn=None))
    sub, rows = row_tile_slice(wl14, N_WINDOW, DIST_PLAIN_TILES)
    wr = win[rows].contiguous()
    want, p_ms = timed_once(lambda: k14_plain(wr, batch, signs, d_cut, sub))
    errs["worklist_range_count_signed"] = check_equal(
        "worklist_range_count_signed [stream shape, row tiles]",
        [k14(wr, batch, signs, d_cut, sub)], [want])
    main_times["worklist_range_count_signed"] = {
        "ms": time_ms(lambda: k14(win, batch, signs, d_cut, wl14)),
        "plain_ms": p_ms, "plain_rows": rows.numel(),
        "k5_ms": time_ms(lambda: ops.local_density_delta(win, batch, signs,
                                                         d_cut)),
        "build_ms": build_ms, "kept": wl14.n_kept, "total": wl14.n_total}
    nb, no = k8_work(win, batch, wl14)     # K8's work, the signs, one add
    pairs14 = no / (3 * win.shape[1] + 1)  # per in-d_cut pair
    bounds["worklist_range_count_signed"] = (nb + 4 * batch.shape[0],
                                             no + pairs14)
    t = main_times["worklist_range_count_signed"]
    b_ms, by = bound_ms(*bounds["worklist_range_count_signed"])
    print(f"worklist_range_count_signed [window {N_WINDOW} x batch "
          f"{batch.shape[0]}, grid-sorted]: == dense K5 bit for bit, == plain "
          f"on {rows.numel()} rows; K14 {t['ms']:.3f} ms + worklist build "
          f"{build_ms:.3f} ms ({wl14.n_kept} of {wl14.n_total} tile pairs), "
          f"K5 {t['k5_ms']:.3f} ms, bound {b_ms:.3f} ms ({by})  ({card})",
          flush=True)
    record["bf16_check_shapes"] = bf16_check
    del win, batch, signs, got, dense14, wl14, sub, rows, wr, want
    torch.cuda.empty_cache()

    # ----------- 23. the halo primitives on a span-pruned worklist (K15, K16)
    stamp(23)
    halo_wl_check = halo_worklist_check_shapes(
        [(label, p, pick_dcut(p, target_rho=30)) for label, p in cases]
        + [("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
            2.5)], card)
    halo_wl = halo_worklist_full(
        *([tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in a)
           for a in halo_calls[name]]
          for name in ("halo_range_count", "halo_masked_nn")),
        row_tile_slice, card, gen, halo_regs)
    del halo_calls
    for name, key in (("worklist_halo_range_count", "k15_ms"),
                      ("worklist_halo_masked_nn", "k16_ms")):
        p = halo_wl["plain"][name]
        errs[name] = p["err"]
        main_times[name] = {"ms": halo_wl["totals"][key],
                            "plain_ms": p["plain_ms"],
                            "plain_rows": p["plain_rows"]}
        bounds[name] = halo_wl["work"][name]
    record["halo_worklist"] = {
        k: v for k, v in halo_wl.items() if k != "work"}
    record["halo_worklist_check_shapes"] = halo_wl_check
    torch.cuda.empty_cache()

    # ---------- 24. the sharded Airline stream, 4 logical shards, 2^20
    stamp(24)
    air, _ = real_proxy("airline", N_WINDOW + (AIR_TICKS + 3) * STREAM_BATCH,
                        seed=0)
    record["sharded_stream"] = run_sharded_stream(air, d_cut, card)
    del air
    torch.cuda.empty_cache()

    # ------------------------ 25. the torch reference backend on the card
    stamp(25)
    record["reference_backend"] = run_reference_backend(main_pts, d_cut,
                                                        card)
    torch.cuda.empty_cache()

    # ------------------- 26. the paper's baselines, LSH-DDP and CFSFDP-A
    stamp(26)
    record["baselines"] = run_baselines(main_pts, d_cut, card)
    base_kernels = {name: {algo: {"launches": rec["launches"].get(name, 0),
                                  **rec["kernels"][name]}
                           for algo, rec in record["baselines"].items()
                           if name in rec["kernels"]}
                    for name in ("halo_range_count", "halo_masked_nn",
                                 "masked_nn")}
    torch.cuda.empty_cache()

    # ------------------------------------------------- 27. the plan layer
    stamp(27)
    record["plan_layer"] = run_plan_layer(full_pts, d_full, phase8_fit,
                                          card)

    # ------------------- 28. the serving path: gemma-2b with DPC-KV
    stamp(28)
    torch.cuda.empty_cache()
    record["serving"], serve_kernels = run_serving(card)

    # -------- 29. serving the moe, ssm and hybrid families, DPC-KV on moe
    stamp(29)
    torch.cuda.empty_cache()
    record["serving_families"], family_kernels = run_serving_families(card)

    # ------------------------------------------------------------ 30. training
    stamp(30)
    record["training"] = run_training(card)
    wrong = [(a, b) for a, b in plans_made
             if b != (a if a not in (None, "auto") else "cuda")]
    assert not wrong, f"plans resolved to another backend: {wrong}"
    planner.DPCPlan.__init__ = plan_init
    print(f"{len(plans_made)} plans made, each on the backend it asked for",
          flush=True)

    # -------------------------------------------- 31. the analyzer on the card
    stamp(31)
    record["analyzer"] = run_analyzer(card, build_log, main_pts[:BASE_N],
                                      d_cut)

    # --------------------------------------------------------- the record
    kernels = []
    for name, launched, where in (
            ("fused_count_topk", launches_dense, "sweep.py:432"),
            ("masked_nn", launches_dense, "sweep.py:432"),
            ("worklist_count_topk", launches, "sweep.py:432"),
            ("fused_count_topk_sel", sel_launches, "sweep.py:432"),
            ("worklist_count_topk_sel", sa_launches, "sweep.py:432"),
            ("prefix_nn", {"prefix_nn": k7_launches}, "dependent.py:28"),
            ("worklist_range_count", dist_launches["gather"],
             "sweep.py:432"),
            ("worklist_masked_nn", launches, "sweep.py:432"),
            ("halo_range_count", dist_launches["halo"], "density.py:68"),
            ("halo_masked_nn", dist_launches["halo"], "dependent.py:56"),
            ("worklist_halo_range_count", halo_wl["launches"],
             "backend.py:729"),
            ("worklist_halo_masked_nn", halo_wl["launches"],
             "backend.py:742")):
        t = main_times[name]
        b_ms, by = bound_ms(*bounds[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": f"src/repro/kernels/{where}",
            "launches": launched[name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
        if name in base_kernels:    # phase 26's fits, beside the main path
            kernels[-1]["baselines"] = base_kernels[name]
            kernels[-1]["max_abs_err"] = max(
                [errs[name]] + [b["max_abs_err"]
                                for b in base_kernels[name].values()])
        record.setdefault("bounds", {})[name] = {"bound_ms": b_ms,
                                                 "bound_by": by}
    for name, launched in (
            ("fused_count_topk_bf16", lat_launches["approxdpc", "dense"]),
            ("worklist_count_topk_bf16", air_launches),
            ("fused_count_topk_bf16_sel", lat_launches["sapproxdpc", "dense"]),
            ("worklist_count_topk_bf16_sel",
             lat_launches["sapproxdpc", "block-sparse"]),
            ("worklist_range_count_signed", k14_launches)):
        t = main_times[name]
        b_ms, by = (bound_ms(*bounds[name]) if len(bounds[name]) == 2
                    else bf16_bound_ms(*bounds[name]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": "src/repro/kernels/sweep.py:432",
            "launches": launched[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b_ms,
            "bound_by": by, "library_ms": None})
        record.setdefault("bounds", {})[name] = {"bound_ms": b_ms,
                                                 "bound_by": by}
    replaces = {"range_count": "src/repro/kernels/sweep.py:432",
                "range_count_signed": "src/repro/kernels/sweep.py:432",
                "gather_masked_nn": "src/repro/kernels/sweep.py:510"}
    for name, where in replaces.items():
        # K6 where it loses the most: the Airline stream's tick
        k = streams["airline" if name == "gather_masked_nn" else "mixture"][
            "kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": where, "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    for entry in kernels:   # phases 28 and 29: DPC-KV's shapes of K4 and K2
        if entry["name"] in serve_kernels:
            entry["dpc_kv"] = {SERVE_ARCH: serve_kernels[entry["name"]],
                               FAMILY_DPC_KV: family_kernels[entry["name"]]}
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]] + [k["max_abs_err"] for k in
                                          entry["dpc_kv"].values()])
    record.update(streams=streams, stream_check_shapes=stream_check,
                  sapprox_check_shapes=sapprox_check,
                  dist_check_shapes=dist_check)
    record.update(kernels=kernels, main_times=main_times,
                  check_shapes=check_times, k3_checks=k3_checks,
                  main={"fit_ms": full_s * 1e3, "n": N_FULL, "d_cut": d_full,
                        "clusters": n_clusters_full,
                        "cell_maxima": fmax.numel(), "k2_rows": k2_rows_full,
                        "k9": k9_main,
                        "worklist": wl_full, **trace_full},
                  issue_rate=issue_rate, phase_start_s=phase_s,
                  seconds=time.perf_counter() - t_start,
                  clocks_after=smi("clocks.sm,power.draw,temperature.gpu"))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: {record['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
