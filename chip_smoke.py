#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``fps_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fps_tpu_torch/ops/csrc`` and then,
on the card, raising on the first failure:

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the kernels and prints the build time;
3. holds each kernel against its plain PyTorch version at the shapes its
   paths give it, with -1 and >= R ids mixed in: the gathers (K1, K5) must
   be bit-equal (as int32 views), K5 at binary PA as the one call of the
   head-prefix route (the head view and the tail alone beside it, off the
   path), each timed beside ``index_select`` and ``Tensor.copy_`` of its
   output's size, and K1 at the 20-class PA pull also over a synchronised
   loop of 100 calls, a call of which its held time must cover; the
   scatter-adds (K2, K4) must lie within the float32
   summation bound of a float64 sum, equal the exact float64 sum bit for
   bit on inputs rounded to sixteenths, and give the same bits on two
   launches; K2's hand-written radix sort must equal ``torch.sort(keys,
   stable=True)`` bit for bit, in keys and positions, at every K2 shape and
   at its off-path edges (R = 1, R = 2^31 - 1, every id dropped, one id
   owning 2^20 ids, runs across its tile edges, a batch that is not a
   multiple of the tile). K1 / K2 at the MF step (ML-20M widths, B =
   32,768, Zipf(0.8) items and uniform users as ``synthetic_ratings``
   draws them), the 20-class PA step (47,236 x 20, 2^20 ids) and the
   AdaGrad logistic-regression step
   (1M x 2 pull, 1M x 3 push); K5 / K4 at the binary PA step (the head view
   47,236[:2,048] with the head-sorted prefix, then the tail) and the
   logistic-regression step (1M x 1, 13 + 16,384 x 26 ids), plus K4 at 2^20
   ids: the whole PA push, uniform ids, and one id owning every push. K3,
   the head scatter-add of the hot/cold split, the same way at the head
   shapes of its paths (H = 2,048: the MF item push's count-column
   scatter, the 20-class PA push, the AdaGrad push), with one id owning
   every push and on the whole-table route, rows past the head unchanged,
   timed beside the same slices unclustered; at the three path shapes the
   split as the store calls it (``ops.scatter_add_`` with ``hot_rows``)
   against K2 alone over the whole push; then the crossover sweep behind
   ``packed_crossover_rows``: K3 over the whole table against K2 with its
   sort, B = 32,768 Zipf(0.8) ids, D in {10, 32, 100, 200}, R from 512 to
   32,768. K1 / K2 at word2vec's text8 width (vocab 50,000, dim 100): the
   block path's pulls of 8,197 and 49,182 ids and its mean pushes' count-
   column scatters at D = 101, then, off the main path, the pairs path's
   81,920 and 491,520 ids, each from the paths' own first step (Zipf ids
   of the corpus, the worker's negatives). K1 / K2 at iALS's step as
   ``bench.py run_ials`` makes it (32,768 users, 16,384 Zipf-skewed items,
   rank 16, B = 65,536, the path's first step): the fixed side's pulls at
   D = 16 in both halves and the ``A`` (D = 256) and ``b`` (D = 16) pushes
   keyed by users and by items. K1, K2, K5 and K4 at the hot tier's
   shapes from phase 9's first step: the replica pull, the reconcile's
   gather of a shard's owned rows, the pending buffers' scatters (MF's
   2,048 x 17 mean buffer, logistic regression's 2,048 x 1). K1, K2 and K4
   at the adaptive tier's shapes from phase 10's stream after the
   rotation: the slot-addressed replica pull (512 x 16, 1,024 slots), the
   re-split's gather of a shard's owned rows (its 1,024 x 16 block, 512
   ids), the mapped reconcile's scatter into them (128 owned of 512, D =
   16), the tracker's window (4 x 2,048 = 8,192 rows, 4,096 pushes). K4 at
   the word2vec sketch tap's stack (16
   probes x 5 x 1,024 = 81,920 rows, two row tiles, the 409,600 items of
   the block path's first step). K4's bucket pass by row tile,
   where its plan has one (the 1M-row logistic-regression table), must
   equal its plain version (a stable sort by bucket) bit for bit. Times
   are CUDA-event medians of 30 (the crossover sweep: 10) with the card held busy, beside the bound (least bytes /
   3.35 TB/s), the library call's time and, for K2 and K4, their sort's
   time (K2: its radix sort; K4: its bucket pass, none where the table is
   one tile; ``torch.sort``'s beside both);
4. drives each path at full width, every launch counter at 0 just before it
   and read just after: online MF at ML-20M size (2 epochs sync, 2 SSP);
   binary PA-I at the RCV1 shape with the head prefix (K5 once and K4
   twice a step, no K1 / K2); 20-class PA-I (K1 / K2 only); SSP logistic
   regression at the Criteo shape with SGD and the dense head (K5 and K4
   once a step),
   then a smaller AdaGrad run (K1 / K2 only). Then the hot/cold split
   through device-resident ingest and ``run_indexed``: MF at ML-20M size
   with ``hot_items = 2048`` (2 epochs sync, 2 SSP; K1 2, K2 2 and K3 1 a
   step), 20-class PA-I and AdaGrad logistic regression with
   ``hot_features = 2048`` (K1, K2 and K3 once a step each), and one traced
   run_indexed epoch of the MF configuration for the device's busy share.
   Before them, word2vec SGNS as ``bench.py run_w2v`` trains it, on a 2M-
   token text8-size corpus: the block worker through
   ``Word2VecDevicePlan`` and ``run_indexed``, 2 epochs sync, then 1 SSP
   epoch (s = 4), K1 2 and K2 2 a step, words/s and steady ms a step; the
   pair worker, two ``run_chunk`` calls of 8 steps (81,920 pairs a step),
   K1 2 and K2 2 a step; after them, one traced w2v epoch for its busy
   share. Then the w2v block worker with ``cooccurrence_sketch_tap`` of the
   16 most frequent words, one ``run_indexed`` call of an epoch (K1 2, K2 2,
   K4 1 a step; the similarity matrix finite with a positive diagonal);
   iALS as ``bench.py run_ials`` trains it, a warm-up epoch on throwaway
   state and then epochs until recall@20 on the first 2,000 held-out pairs
   reaches 0.35, at most 8 (K1 1, K2 2 a step; the recall curve, seconds an
   epoch, interactions/s, time to the target, the parts of a half-epoch
   timed apart and one traced epoch); and MF at ML-20M width with the
   online top-k tap (k 10, every 4th step, one call of 17 steps; K1 3 and
   K2 2 a step), whose ids on every tapped step must equal a float64
   brute-force ranking of that step's live item table. Each must learn:
   MF's train RMSE falls; over the last chunk PA's mistake rate lies below
   0.5 (20 classes: 0.95) and the logistic log loss below 0.693; word2vec's
   last real step's loss a pair lies below its first and below (1 + K) log
   2 = 4.159;
5. runs small MF, head-prefix PA and SSP logistic-regression jobs, and
   run_indexed jobs of MF with ``hot_items``, 20-class PA with
   ``hot_features`` and word2vec (block sync, pairs SSP), on the card and
   on the CPU from the same tables and seeds, and compares the tables
   (within 1e-5 of their largest value); a small iALS job (factors within
   1e-4 of the largest value) and the w2v block worker with the sketch tap
   (tap sums bit for bit); then traces 10 K2 calls at each of its path shapes
   (``torch.profiler``) for the device time and launches of each kernel K2
   launches, which must be 3 a sort pass plus 2, 10 calls of the sort
   alone at each sort edge, 3 kernels a pass, 10 K3 calls at each K3
   shape, its slice pass once a call and its fold pass once more where the
   plan has more than one cluster, 10 K4 calls at each K4 shape, whose
   kernels a call (the bucket pass's count and scatter where the plan has
   buckets, the tile pass, the fold where it has more than one cluster)
   must be what ``dim1_plan`` counts, and 10 K1 and K5 calls at each of
   their path shapes, one kernel a call;
6. drives the host pipeline and delayed pushes at full width, every launch
   counter at 0 just before each run and read just after: the prefetch A/B
   of ``bench.py host_pipeline_ab`` (the same chunk stream, an ``islice``
   of ``epoch_chunks`` assembled in the stream, through ``fit_stream`` at
   prefetch 0, 2, 2, 0 from fresh state: MF as ``run_mf``'s host arm, B
   32,768, 12 chunks of 8 steps; SSP logistic regression as
   ``run_logreg``'s, B 4,096, rounds of 8; iALS at ``run_ials`` width with
   ``IALSSolver.prefetch`` over 2 epochs of host chunks), whose tables,
   local state, metrics (iALS: factors and recall@20) and launch counts
   must be equal across the arms, with no prefetch thread left after any
   arm; each arm's wall, time to its first chunk, steady ms a step (CUDA
   events at each chunk's start), the driver thread's host-serial seconds
   (assembly and placement, or the queue wait) and the worker's seconds
   (through the prefetcher's duck-typed timer), the overlap ratio and the
   speedup; then ``push_delay`` 1 and 4 against 0 with a pusher independent
   of its pulls into a 26,744 x 10 table (K1, K2) and the 1M x 1 table (K5,
   K4), which must end equal to delay 0 within the float32 summation bound
   (bit-equal reported) with the same launches; MF at ML-20M size with
   ``push_delay = 4`` at lr 0.05, sync and SSP (s = 4), 2 epochs, timed
   beside the same job at ``push_delay = 0`` in turns 0, 4, 4, 0, whose
   RMSE must fall with K1 2 and K2 2 a step and equal launches at 0 and
   4; and a small MF job with
   ``push_delay = 2`` and ``prefetch = 2``, card against CPU within 1e-5
   of the largest value. It runs after phase 5;
7. drives the sharded mesh on the one card, every launch counter at 0
   just before each run and read just after: MF at ML-20M width (the data
   of ``load_movielens(None, "20m")``, phase 4's rank, its global batch of
   32,768 split over the workers) through ``run_indexed``, one epoch sync
   and one SSP (s = 4), on a (1, 1), a (1, 4) and a (2, 2) mesh whose
   positions are all ``cuda:0``, whose RMSE must fall with K1 2 and K2 2
   a position a step and whose data replicas must be bit-equal; binary
   PA-I at (1, 4), K5 and K4 once a position a step, mistakes below 0.5;
   the word2vec block worker at phase 4's width on its corpus, a block of
   8,192 tokens a worker a step, through ``Word2VecDevicePlan(num_workers=
   W)`` and ``run_indexed``: one sync epoch at (1, 4) after two warm-up
   epochs, then one SSP epoch (s = 4) at (2, 2) from where it ended, K1 2
   and K2 2 a position a step, the loss falling as phase 4's and the (2, 2)
   replicas bit-equal; iALS at phase 4's width at (1, 4), phase 4's chunks
   cut over the workers, epochs until recall@20 reaches 0.35 (at most 8),
   K1 1 and K2 2 a position a half-step; MF with the online top-k tap at
   (1, 4) (phase 4's settings, the batch split over the workers, K1 3 and
   K2 2 a position a step), every worker's ids on every tapped step equal
   to a float64 brute force of that step's live table in the merge's pool
   order; ``recommend_topk`` of 64 users over the resulting 4 shards of
   the ML-20M item table, ids equal to the brute force;
   the dense against the gathered push of one MF item push at 4 shards,
   within the float32 summation bound; small MF, word2vec (with the sketch
   tap), iALS and top-k jobs on both meshes, card against CPU (MF and
   word2vec tables within 1e-5 of the largest value, iALS factors within
   1e-4, sketch sums and top-k ids and scores equal). It prints each run's
   ms a step and launches a step. The positions share one card, so these
   times measure the single controller's launches, not scaling;
8. drives the mesh over several processes (``torch.distributed``), every
   position on ``cuda:0``, the ranks spawned from this script
   (``--phase8-rank``) after the kernels were built, with their files in
   a temporary directory, every launch counter at 0 just before each run
   in every rank and read just after: one NCCL rank at world size 1, MF
   at ML-20M width at (1, 4), one ``run_indexed`` call of 64 steps; two
   gloo ranks of 2 positions each, MF one sync epoch at (1, 4) and one SSP
   epoch (s = 4) at (2, 2), binary PA-I one epoch at (1, 4), the word2vec
   block worker one ``run_indexed`` call of 32 steps at (1, 4), iALS one
   epoch at (1, 4), phase 9's ``head_compact`` arm at (1, 4) for 32 steps
   (the hot tier), phase 10's recovery arm at (1, 4) for 32 steps with a
   re-rank at every chunk (the adaptive tier), MF at (1, 4) for 4 chunks
   of 16 steps with both ranks saving into one checkpoint directory after
   every chunk (then this process restores their last save and must hold
   their state bit for bit), each rank after one uncounted MF call of 64
   steps
   (its first use of each kernel and exchange). Every job's tables, local
   state and metrics on every rank must equal, bit for bit, the same job
   run by this process alone on a mesh of the same shape, with K1 2 and
   K2 2 (MF, w2v), K5 1 and K4 1 (PA), K1 1 and K2 2 a half-step (iALS) a
   position a step; a rank
   that exits non-zero or hangs fails the phase, and every rank left is
   killed. It prints each job's ms a step and the share of it in
   cross-process exchange; two ranks share one card through host
   staging, so these times measure that, not scaling;
9. drives the static hot tier (``TableSpec.hot_tier``, ``hot_sync_every``,
   ``cold_budget``, ``ServerLogic.hot_fold``), every position on
   ``cuda:0``, every launch counter at 0 just before each run and read just
   after: ``bench.py run_tiered``'s five arms at its widths on a (2, 4)
   mesh (online MF, 4,096 users and items, rank 16, lr 0.05, the mean
   combine, windows of 4, local batch 1,024, chunks of 8 steps of
   Zipf(1.05) ratings; ``off``, ``on`` (the whole item table replicated),
   ``head`` (2,048 rows, the gathered route), ``head_compact`` (lanes of
   256) and ``ssp`` (``head_compact`` at s = 2)), each from fresh state
   after 2 warm-up chunks through ``fit_stream``: the train RMSE must
   fall, the replica must equal the canonical head rows bit for bit after
   every call, the hit counts must equal numpy's, ``cold_dropped`` must be
   0 with every chunk certified, ``head_compact``'s tables must equal
   ``head``'s bit for bit, and each arm must launch what the code gives (a
   position a step: off K1 2, K2 2; on K1 2, K2 2; head K1 3, K2 3;
   head_compact K1 4, K2 3; ssp K1 2, K2 3; and K1 once a position a
   reconcile); it prints each arm's ms a step, examples/s, launches, the
   exchanges a step and their bytes (the reconcile's apart from the
   routes'), the hit rate and ``delta_sq``. Then phase 4's SSP logistic
   regression at (1, 4) with a head of 2,048 and windows of 8 for one
   epoch (K5 1 and K4 2 a position a step, K5 once a position a round;
   log loss below 0.693); arm ``on`` with an Adagrad hot fold for 4
   chunks (the RMSE falls, the fold state finite and sharded); and small
   tiered jobs at (2, 4), card against CPU (MF ``head_compact`` sync and
   SSP, logistic regression with a partial head, Adagrad and Adam folds,
   the max combine; tables, replicas and fold states within 1e-5 of the
   largest value). Phase 8 also runs the ``head_compact`` arm at (1, 4)
   over its two gloo ranks for 32 steps, bit-equal to one process;
10. drives the adaptive tier (``Trainer.retierer``,
   ``TrainerConfig.auto_tier``), every position on ``cuda:0``, every
   launch counter at 0 just before each run and read after every chunk:
   ``bench.py run_tiered_drift`` at its widths on a (2, 4) mesh (phase 9's
   MF on its drifting stream: Zipf(1.2) items whose ranking rotates at
   chunk 6 of 12, in stream order): ``oracle`` (the whole item table
   replicated), ``stale`` (the head 512) and ``adaptive`` (``auto_tier``,
   its plan landed in a warm-up of 6 chunks, printed), each from fresh
   state after 6 warm-up chunks; then the recovery pair, the head 512 with
   and without ``Retierer(check_every=2, churn_threshold=0.1)``, over both
   halves of the stream. Each arm's train RMSE must fall within each half
   (the rotation lifts it), the replica must equal the canonical rows of
   the current hot ids bit for bit after every chunk, and every chunk must
   launch what the code gives (a position a step: oracle K1 2, K2 2;
   stale K1 3, K2 3; the mapped head K1 3, K2 3, K4 1; a reconcile K1 once
   a position, K2 on the mapped head), the same before and after each
   re-rank; the retierer must re-rank, and its hit rate after the
   rotation must lie above the static head's. It prints each arm's ms a
   step, examples/s, train RMSE, launches a step, hit rate and the
   exchanges a step with their bytes (the reconcile's, the tracking
   merge's, the re-split's and the routes' apart). The mapped tier on the
   identity ranking (a retierer that never checks) must equal the static
   tier's tables, replica, local state and metrics bit for bit, and the
   window after one chunk a host count-min of its ids bit for bit. Small
   jobs at (2, 4) with a re-rank at every chunk (logistic regression with
   a mapped head of 256 of 2,000, sync and SSP; MF with a mapped head and
   its lanes) on the card and on the CPU: the same hot ids, the slot
   maps, ids and windows equal, the rest within 1e-5 of the largest
   value;
11. drives durability on ``cuda:0`` at phase 4's MF width (ML-20M, rank
   10, batch 32,768, mean combine), every launch counter at 0 just before
   each run: (a) a child (``--phase11-child``) trains 3 epochs through
   ``run_indexed`` with an ``AsyncCheckpointer`` saving every epoch and
   dies by SIGKILL after epoch 2, leaving a torn tmp file; this process
   restores its latest valid snapshot, finishes, and must equal the
   uninterrupted run bit for bit, then again past a truncated newest
   snapshot (the fallback, the ``.corrupt`` quarantine); (b) 12 host
   chunks of 16 steps through ``fit_stream`` with prefetch 2 and a save
   every chunk, full snapshots and ``DeltaPolicy(full_every=8)``, each
   bit-equal to no checkpointer, the head equal to the live state and
   ``compact()`` to the chain; (c) that (1, 1) snapshot restored onto a
   (2, 4) mesh of the card and back, and onto the CPU, bit for bit; (d)
   chunk 3 of 8 poisoned with NaN and 1e30 ratings: the mask guard keeps
   the tables finite and masks exactly the host's count of poisoned live
   rows, an observe guard's quarantine equals a preset skip at
   ``health_lag`` 0 and 1, and a clean mask run equals ``guard=None``;
   (e) ``bench.py run_storage``'s arms: phase 4's SSP logistic regression
   with prefetch 2 and ``when_full="degrade"``, clean and under the
   port's faultfs (an EIO blackout past the retry budget, slow fsyncs),
   final weights and recovered snapshots bit-equal to the clean stream's;
   (f) phase 9's MF at (2, 4) with an Adagrad hot fold, and phase 10's
   recovery arm with the Retierer's sidecar, restarted at chunk 6 and
   bit-equal to the uninterrupted runs. Phase 3 also holds K2 and K4 at
   the guard's shapes (1 % of the ids masked to -1, their deltas zeroed);
12. drives telemetry (``fps_tpu_torch.obs``) on ``cuda:0`` at phase 4's
   widths, every launch counter at 0 just before each run: (a) MF through
   ``run_indexed`` (2 epochs, a save an epoch) and ``fit_stream``
   (prefetch 2, 12 chunks, a save every 4), each with a ``StepWatchdog``,
   in turns with an ``open_run`` recorder (A) and without (B), A, B, B,
   A, after one untimed run of each driver: the tables bit-equal, the
   launches and the synchronising calls (``torch.cuda.set_sync_debug_mode
   ("warn")``) equal, the phase totals holding dispatch, host_sync,
   place, ingest, prefetch and checkpoint, ``driver.examples`` the
   examples fed; (b) phase 11 (d)'s poisoned chunk 3 of 8 under an
   observe guard with rollback and a ``HealthMonitor``: escalation to
   mask at the chunk the reference's policy names, ``guard_escalated``
   in the journal, and a monitor with ``abort_after_chunks=1`` raising
   ``PoisonedStreamError``; (c) an ``on_chunk`` that stalls the card past
   a 0.5 s watchdog: one ``stall`` and its recovery, the stream
   finished; (d) ``obs.trace`` around one SSP round of phase 4's
   logistic regression: the Chrome trace names K5's and K4's kernels and
   the ``fps.pull`` / ``fps.push`` ranges (padded and retraced as phase
   5's windows are); (e) ``tools/obs_report.py`` and
   ``tools/trace_export.py`` exit 0 over the runs' obs dirs and report
   their chunks and epochs; (f) the steady ms a step of each turn, printed
   beside the card, not gated;
13. serves while the card trains (``fps_tpu_torch.serve``): phase 11's MF
   (ML-20M, rank 10, batch 32,768, mean combine) on ``cuda:0`` through
   ``fit_stream``, 14 chunks of 2 steps, an ``AsyncCheckpointer`` with
   ``DeltaPolicy(full_every=4)`` publishing every chunk, in turns A, B, B,
   A: with (A) a ``ServingFleet`` of 3 readers (quorum 2) polling on
   threads, a ``TcpServe`` on reader 0 and a ``WireClient`` thread sending
   pulls of 256 item ids and ``topk`` of 64 users (k 20), each pull's ids
   also pulled in process from readers 1 and 2, and without (B), every
   launch counter at 0 just before each run. The first A is gated: every
   answer's step published and at or behind the fence, a pull's rows the
   card's at that step, bit for bit; the fleet converged on the last step
   serving the card's item rows (``ParamStore.table`` read back) and the
   exported user rows bit for bit, its ``topk`` the same selection over
   them; then one more chunk published as a delta, bit-flipped by the
   port's ``testing.chaos``, refused (``SnapshotRejected``) and never
   answered. It reports the write->servable lag, pull and topk latency
   (p50, p99) and the ms a step of each turn, not gated;
14. supervises training on the card (``fps_tpu_torch.supervise``): four
   jobs at once, each under the port's supervisor CLI
   (``fps_tpu_torch/examples/supervise.py``) run with torch and jax made
   unimportable, every child on ``cuda:0`` loading the library this process
   built (it builds nothing): (a) SGD logistic regression at 1,000,000
   features (``bench.py run_logreg``'s table; the demo's 8,000 examples, 2
   epochs, local batch 32, 8 steps a chunk, an ``AsyncCheckpointer`` every
   chunk) run straight, then under the CLI SIGSTOP-wedged after chunk 3:
   success, one deadline abort, one restart, restored step 3, no
   ``*.corrupt`` file, the final weights bit-equal to the straight run's;
   (b) the same job crashing at chunk 2 on every attempt: chunk 2
   quarantined, attempt codes 3, 3, 0, ``quarantine_carried`` in the last
   child's log, bit-equal to a straight run given the quarantine through
   the env contract; (c) the megastep (K 2) killed after megastep 3,
   bit-equal to its straight megastep run; every child of (a)-(c) on
   ``cuda:0`` with K5 and K4 launched; (d) the MF example at ML-20M width
   (batch 32,768, mean combine, lr 0.1, 1 epoch) under the CLI with the
   heartbeat from the env contract: one attempt, success, its last beat
   naming a driver sub-phase. It reports, not gated, the time to recovered
   of (a) and (c), each attempt's start-to-first-beat seconds, the card's
   free memory at each attempt's start and the phase's seconds;
15. runs a pod and two tenants on the card (``fps_tpu_torch.supervise.pod``,
   ``fps_tpu_torch.tenancy``), one scenario after another, every member
   agent (the port's CLI in pod mode) and the tenants' manager with torch
   and jax made unimportable, every child on ``cuda:0`` training phase
   14's logistic regression at 1,000,000 features (the demo's 8,000
   examples, 2 epochs; (b): 20,000 examples, 4 epochs) and loading the
   library this process built: (a) a three-member pod whose member h1's
   child is SIGKILLed after chunk 3: every member succeeds with one
   coordinated restart, no quarantine, no eviction, the kill fired, one
   restart span tree whose attempt children are h0, h1 and h2, each
   carrying its epoch, no torn or ``*.corrupt`` snapshot and no publish
   behind a fence, every member's weights bit-equal to the straight run's;
   (b) the elastic cycle: a non-leader host's agent and child SIGKILLed,
   world 2 observed, the host relaunched and re-admitted, every digest at
   world 3 with one re-admission, every member bit-equal to the straight
   run, no torn snapshot and no stale publish; (c) two tenants, tenant a
   crashing at chunk 3 on every attempt: a quarantines chunk 3 and
   finishes, b bit-equal to its solo run, ``audit_namespaces`` clean,
   ``tenant_fleet_digest`` reporting both tenants; every child with K5 and
   K4 launched. It reports, not gated, each scenario's time to recovered,
   each attempt's start to its first chunk (pods) or first beat
   (tenants), the card's free memory at each child's start, the lease
   seizures and the phase's seconds;
16. audits the programs on the card (``fps_tpu_torch.analysis``): (a) MF at
   ML-20M width (rank 10, batch 32,768) on one position, one chunk of 4
   steps with ``Trainer(audit="strict")`` against the same chunk
   unaudited: the certificate clean, the record's K1 and K2 entries equal
   to the launch counters' deltas over the call, its host transfers equal
   to the synchronising calls ``SyncCount`` sees over the call (and, with
   a step tap that reads one value back a step, 4 = 4), the tables
   and launches bit-equal to the unaudited call's, the audited first
   call's ms against the plain call's reported; (b) phase 9's tiered MF at
   (2, 4): ``replica_consistency`` certifies and the reconcile's
   reduce-scatter is in the census; (c) phase 9's megastep at (2, 4) with
   a tick every 2 segments: the records of K = 4 and K = 16 certify with
   equal censuses; (d) SSP logistic regression at 1,000,000 features (K5,
   K4) certifies; (e) the drift detector pinned to the port's
   ``BUDGETS`` (``fps_tpu_torch/examples/audit_programs.py``) stays quiet
   over 3 chunks of the audit's MF row run on the card at (1, 8), and the
   pinned bytes halved raise exactly one ``budget_drift`` incident;
17. runs the chaos sweep, the native host library and the planner's
   command line on the card: (a) two processes of the port's sweep
   (``fps_tpu_torch/examples/chaos_sweep.py``) at once, ``--shard 1/2``
   and ``--shard 2/2`` over its seven in-process scenarios (the logistic
   regression harness at ``(1, 8)`` on ``cuda:0``: K5, K4) and the
   training-plane kills ``prefetch_kill``, ``hot_tier_kill``,
   ``retier_kill`` and ``reconcile_shard_kill`` (their children on
   ``cuda:0``, the tiers at 8 positions), each scenario bounded by
   ``--timeout-s``: every scenario survived, the program certificate ok,
   no recovery-SLO breach, the device ``cuda:0``, every child on
   ``cuda:0`` loading the library this process built, K5 and K4 launched
   in the straight run and the last attempt; (b) ``fps_tpu_torch.native``
   builds with ``g++`` and loads, and the first chunk of
   ``skipgram_chunks(use_native=True)`` over phase 3's corpus (50,000
   words, 2M tokens) trains the pair worker at text8 width through
   ``fit_stream``, 8 steps of 81,920 pairs, K1 2 and K2 2 a step, a
   finite loss; the whole stream's pairs a second, native and numpy; (c)
   the planner's command line (``fps_tpu_torch/examples/plan.py``) over
   ML-20M's two MF tables records the plan's and the untiered program on
   the card and on the CPU: the same ``predicted``, ``untiered_baseline``
   and plan. It reports each shard's time to recovered and seconds;
18. runs the driver's entry points and the route-timing tools on the card
   (``fps_tpu_torch/entry.py``, ``fps_tpu_torch/examples/
   profile_mf_step.py``, ``bench_scatter.py``, ``bench_logreg_routes.py``,
   ``pa_scaling.py``): (a) ``entry()``'s chunk twice on the same
   arguments, bit-equal outputs, the arguments unchanged, K1 4 and K2 4 a
   call, and within 1e-5 of the largest value of ``entry(device="cpu")``;
   (b) ``dryrun_multichip(4)`` and ``dryrun_multichip(8)`` on ``cuda:0``:
   every family processed examples, K3 launched by the w2v route, both hot
   tiers on with rows served, K1-K5 each launched; (c) the four tools at
   their full widths with ``T = P18_T`` steps (``pa_scaling`` at its full
   size, 3 timed epochs a point, all three routes), each with its spot
   checks as gates, their readings logged;
19. prints one JSON line describing every ported kernel, then, as the last
   line, ``{"ok": true, "device": {...}}``.

``--phases LIST`` (``3,18`` or ``9-11``) runs a subset: phases 1 and 2
always run, phase 5 brings phase 3 and phase 6 brings phase 4 with it
(they read their results), and the data each phase needs is made for it.
A subset prints, before the last line, a summary of the phases it ran
(their paths' launches, outputs and seconds) in place of the kernels
line.

It imports neither jax nor the JAX package. Without CUDA it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
EPS32 = float(np.finfo(np.float32).eps)
# About 1 ms of the card's clock: longer than the host takes to enqueue any
# one call timed here, so that call's kernels queue up behind the hold.
HOLD_CYCLES = 2_000_000
# About 10 ms: longer than the host takes to enqueue 100 gather calls.
LOOP_HOLD_CYCLES = 20_000_000

ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS = 138_493, 26_744, 20_000_263
RANK = 10
BATCH = 32_768

# The JAX package's bench settings (bench.py run_pa / run_logreg); only the
# number of examples and epochs is cut.
PA_NF, PA_NNZ, PA_NEX, PA_HEAD = 47_236, 64, 800_000, 2048
PA_MC_NEX, PA_MC_CLASSES = 200_000, 20
LR_NF, LR_NNZ, LR_DENSE, LR_NEX = 1_000_000, 39, 13, 1_000_000
LR_ADAGRAD_NEX = 262_144
SPARSE_BATCH = 16_384
HOT = 2048  # the write-hot head of the split paths (bench.py's head size)
# The sharded mesh's (data, shard) shapes, every position on the one card.
MESH_SHAPES = ((1, 4), (2, 2))

# word2vec as bench.py run_w2v trains it (text8 width: vocab 50,000, dim
# 100, window 5, 5 negatives, lr 0.025, subsample 1e-4, blocks of 8,192
# tokens, mean combine on both tables); only the corpus is cut, from the
# bench's 17M tokens to 2M.
W2V_VOCAB, W2V_DIM, W2V_TOKENS, W2V_BLOCK = 50_000, 100, 2_000_000, 8192
W2V_PAIR_STEPS = 8  # the pairs-mode call
# The w2v example's --sketch-words: a tug-of-war sketch (depth 5, width
# 1,024) of the 16 most frequent words' contexts, a stack of 81,920 rows.
SKETCH_PROBES, SKETCH_DEPTH, SKETCH_WIDTH = 16, 5, 1024

# iALS as bench.py run_ials trains it (synthetic_implicit with a rank-8
# planted model, rank 16, alpha 40, reg 0.1, local batch 65,536 in chunks of
# 4 steps; recall@20 on the first 2,000 held-out pairs to 0.35, at most 8
# epochs); nothing is cut.
IALS_USERS, IALS_ITEMS, IALS_PER_USER = 32_768, 16_384, 64
IALS_RANK, IALS_BATCH, IALS_STEPS = 16, 65_536, 4
IALS_TARGET, IALS_MAX_EPOCHS, IALS_EVAL = 0.35, 8, 2000

# MF with the online top-k tap: k 10 for the first 2 users of every 4th
# step, one run_chunk call of 17 steps (the last one tapped).
TOPK_K, TOPK_EVERY, TOPK_QUERIES, TOPK_STEPS = 10, 4, 2, 17

# The margin each traced window keeps at its edges (profiled): host seconds
# after it opens and before it closes, and the cycles of a spin kernel
# (about 1 ms on an H100) ahead of the traced calls.
PROFILE_PAD_S, PROFILE_SPIN_CYCLES = 0.01, 2_000_000

# The host pipeline's A/B as bench.py host_pipeline_ab runs it: 12 chunks
# of 8 steps (an SSP round of 8 a chunk for logistic regression), prefetch
# depth 2 against 0, in turns: off, on, on, off.
AB_CHUNKS, AB_STEPS, AB_ORDER = 12, 8, (0, 2, 2, 0)
# MF with push_delay 4 is timed beside push_delay 0 in the same turns.
AB_ORDER_DELAY = (0, 4, 4, 0)


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mix_dropped(ids: np.ndarray, num_rows: int) -> np.ndarray:
    """Some -1 padding and some out-of-range ids, as a push carries them."""
    ids = np.array(ids, dtype=np.int32)
    ids[::97] = -1
    ids[13::101] = num_rows + (np.arange(len(ids[13::101])) % 7)
    return ids


def path_ids(rng, num_rows: int, batch: int, zipf: bool) -> np.ndarray:
    """Ids over ``num_rows`` as ``synthetic_ratings`` draws them: Zipf(0.8)
    for items, uniform for users; with some -1 padding and some
    out-of-range ids mixed in."""
    if zipf:
        pop = 1.0 / np.arange(1, num_rows + 1) ** 0.8
        ids = rng.choice(num_rows, batch, p=pop / pop.sum())
    else:
        ids = rng.integers(0, num_rows, batch)
    return mix_dropped(ids, num_rows)


def time_ms(torch, fn, *, setup=None, hold: bool = True, reps: int = 30,
            warmup: int = 5):
    """Median milliseconds of ``fn(setup())`` over ``reps`` runs, each
    between its own pair of CUDA events, after ``warmup`` runs.

    ``hold=True`` times the device's work: before each run the card is kept
    busy (``torch.cuda._sleep``) while the host enqueues the start event,
    ``fn`` and the end event, so the host's launch overhead falls outside
    the events (a function that synchronises inside, as the plain
    scatter-add's boolean mask does, still pays for its wait).
    ``hold=False`` times one call on an idle card, host overhead included:
    what the training loop pays per call when the host is the bottleneck.
    """
    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn(arg)
        end.record()
        if i >= warmup:
            times.append((start, end))
        if not hold:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def check_gather(torch, kernels, label, kernel, plain, table, ids, path, *,
                 head=None, loop=False, collect=None):
    """Hold a gather kernel against its plain version (bit-equal, as int32
    views: -0.0 and +0.0 differ) and time it, its plain version,
    ``index_select`` (with the head-prefix route, ``head = (H, q)``: of the
    head view and the rest, and their concatenation) and ``Tensor.copy_``
    of an output of the same size (the card's rate for writing it; a
    yardstick only), and record the kernel's plan. ``loop`` also times a
    synchronised loop of 100 calls, the card held while the host enqueues
    them, whose time a call the held time must cover (programmatic
    dependent launch must not let the end event pass the kernel).
    ``collect`` (a list) gathers the call for :func:`gather_breakdown`."""
    num_rows, dim = table.shape
    B = ids.shape[0]
    kw = {} if head is None else {"head_rows": head[0],
                                  "head_prefix": head[1]}

    def call(_=None):
        return kernel(table, ids, **kw)

    got = call()
    want = plain(table, ids, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{label}: kernel differs from plain version")
    bound = torch.full_like(ids, num_rows)
    if head is not None:
        bound[:head[1]] = min(head[0], num_rows)
    valid = (ids >= 0) & (ids < bound)
    safe = torch.where(valid, ids, 0)
    uniq = int(torch.unique(ids[valid]).numel())
    if head is None:
        def library(_):
            return table.index_select(0, safe)
    else:
        q = head[1]

        def library(_):
            return torch.cat([table[:head[0]].index_select(0, safe[:q]),
                              table.index_select(0, safe[q:])])
    src = torch.zeros((B, dim), device=table.device)
    dst = torch.empty_like(src)
    # Least bytes: the ids read, each distinct touched row read once, the
    # output written.
    nbytes = B * 4 + uniq * dim * 4 + B * dim * 4
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "head": head, "unique_rows": uniq,
        "max_abs_err": float((got - want).abs().max()) if B else 0.0,
        "ms": time_ms(torch, call),
        "call_ms": time_ms(torch, call, hold=False),
        "plain_ms": time_ms(torch, lambda _: plain(table, ids, **kw)),
        "library_ms": time_ms(torch, library),
        "copy_ms": time_ms(torch, lambda _: dst.copy_(src)),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    case["plan"] = kernels.card_plan_for(table, ids)._asdict()
    if loop:
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # Held too, for as long as the host takes to enqueue the 100 calls,
        # so that the loop times the card's work and not the host's.
        torch.cuda._sleep(LOOP_HOLD_CYCLES)
        start.record()
        for _ in range(100):
            call()
        end.record()
        torch.cuda.synchronize()
        case["loop_ms"] = start.elapsed_time(end) / 100
        if not case["ms"] >= 0.9 * case["loop_ms"]:
            raise AssertionError(
                f"{label}: held time {case['ms']} ms does not cover a call "
                f"of a synchronised loop of 100 ({case['loop_ms']} ms)")
    log(f"{label}: bit-equal to plain; " + json.dumps(case))
    if collect is not None:
        collect.append((label, call))
    return case


def gather_breakdown(torch, inputs):
    """Traced, at each K1 and K5 shape of the paths: the device µs and
    launches a call of each kernel, which must be the gather's one kernel
    (``gather_rows_kernel``, ``gather_dim1_kernel``). Run last, after every
    timed phase."""
    out = {}
    for label, call in inputs:
        us, launched = profiled(torch, call)
        want = "gather_dim1_kernel" if label.startswith("K5") else (
            "gather_rows_kernel")
        if launched != {want: 1}:
            raise AssertionError(f"{label}: traced launches a call "
                                 f"{launched}, expected {{{want!r}: 1}} "
                                 f"(window records {TRACE_WINDOWS[-1]})")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": 1}
        log(f"gather breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def check_sum_bound(torch, label, table, kid, kd, got, want):
    """Hold a scatter-add's kernel result ``got`` and plain result ``want``
    against the float64 sum of ``table`` and the pushes ``kd`` to rows
    ``kid``; return that sum and each row's push count."""
    ref = table.double().index_add_(0, kid, kd.double())
    # Tolerance: a float32 sum of k terms in any order lies within
    # k * eps32 * (sum of the terms' magnitudes) of the exact sum; k is the
    # row's push count plus one (the table value).
    mag = table.double().abs().index_add_(0, kid, kd.double().abs())
    count = torch.zeros(table.shape[0], dtype=torch.float64,
                        device=table.device)
    count.index_add_(0, kid, torch.ones_like(kid, dtype=torch.float64))
    tol = (count + 1)[:, None] * EPS32 * mag
    for which, val in (("kernel", got), ("plain", want)):
        excess = float((((val.double() - ref).abs()) - tol).max())
        if excess > 0:
            raise AssertionError(
                f"{label}: {which} outside the float32 bound of the float64 "
                f"sum by {excess}")
    return ref, count


def check_scatter(torch, label, kernel, plain, table, ids, deltas, path,
                  kernels=None, collect=None, sort_fn=None):
    """Hold a scatter-add kernel against its plain version and a float64 sum
    (within the float32 summation bound; the same bits on two launches), and
    on sixteenths of the same inputs against the exact float64 sum, bit for
    bit; time it, its sort, its plain version, ``index_add_`` and
    ``torch.sort``. With ``kernels`` (K2) the sort is K2's hand-written
    radix sort, first held bit for bit to ``torch.sort(keys, stable=True)``;
    without (K4), ``sort_fn`` (its bucket pass), or no sort where it is
    None. ``collect`` (a list) gathers the inputs for :func:`k2_breakdown`
    and :func:`k4_breakdown`."""
    num_rows, dim = table.shape
    B = ids.shape[0]
    got = kernel(table.clone(), ids, deltas)
    again = kernel(table.clone(), ids, deltas)
    want = plain(table.clone(), ids, deltas)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches gave different bits")
    keep = (ids >= 0) & (ids < num_rows)
    kid, kd = ids[keep], deltas[keep]
    ref, count = check_sum_bound(torch, label, table, kid, kd, got, want)
    et, ed = sixteenths(torch, table), sixteenths(torch, deltas)
    exact = et.double().index_add_(0, kid, ed[keep].double())
    for which, fn in (("kernel", kernel), ("plain", plain)):
        if not torch.equal(fn(et.clone(), ids, ed).double(), exact):
            raise AssertionError(
                f"{label}: {which} differs from the exact sum of sixteenths")
    if kernels is not None:
        check_sort(torch, kernels, label, ids, num_rows)
        sort_fn = (lambda _: kernels.radix_sort_cuda(ids, num_rows))
    uniq = int(torch.unique(kid).numel())
    # Least bytes: the ids, the deltas of in-range ids read, and each
    # touched row read and written once.
    nbytes = B * 4 + kid.numel() * dim * 4 + 2 * uniq * dim * 4
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "unique_rows": uniq, "max_run": int(count.max()),
        "max_abs_err": float((got - want).abs().max()),
        "max_err_vs_f64": float((got.double() - ref).abs().max()),
        "ms": time_ms(torch, lambda t: kernel(t, ids, deltas),
                      setup=table.clone),
        "call_ms": time_ms(torch, lambda t: kernel(t, ids, deltas),
                           setup=table.clone, hold=False),
        # The sort alone, a part of "ms"; torch.sort's time beside it.
        "sort_ms": time_ms(torch, sort_fn) if sort_fn is not None else None,
        "torch_sort_ms": time_ms(torch,
                                 lambda _: torch.sort(ids, stable=True)),
        "plain_ms": time_ms(torch, lambda t: plain(t, ids, deltas),
                            setup=table.clone),
        "library_ms": time_ms(torch, lambda t: t.index_add_(0, kid, kd),
                              setup=table.clone),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    log(f"{label}: deterministic, within the float32 bound and exact on "
        "sixteenths (kernel and plain); " + json.dumps(case))
    if collect is not None:
        collect.append((label, table, ids, deltas))
    return case


# Every traced window's records (profiled): raw event count, device-side
# records, host-side launch calls, whether the spin kernel was recorded, and
# the kernels counted; the JSON line carries them.
TRACE_WINDOWS = []
# A window whose device-side records lack the spin kernel (the tracer lost
# them; the host side shows the launches) is traced again, at most this
# many times in all.
PROFILE_ATTEMPTS = 3


def window_records(torch, events, calls):
    """What one traced window recorded: ``prof.events()``' count, its
    device-side records (CUDA kernels, copies, memsets), the host's launch
    calls, and whether the spin kernel that opens the window is among the
    device records (the tracer's sentinel: a window without it lost its
    device records, whatever the traced calls launched)."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e for e in events if e.device_type != DeviceType.CUDA
                and re.search(r"(cuda|cu)LaunchKernel", e.name)]
    return {"events": len(events), "device_records": len(device),
            "host_launch_calls": len(launches),
            "spin_kernel": any("spin_kernel" in e.name for e in device),
            "calls": calls}


def profiled(torch, fn, calls=10):
    """Device µs and launches a call of each kernel of K2 and its sort
    (``radix_*``, ``rows_*``), of K3 (``packed_*``), of K4 (``dim1_*``) and
    of K1 and K5 (``gather_*``) over ``calls`` calls
    of ``fn``, from ``torch.profiler``: ``({name: µs}, {name:
    launches})``. Each window's records are kept in ``TRACE_WINDOWS``; a
    window whose device records lack the spin kernel is traced again (at
    most ``PROFILE_ATTEMPTS`` windows), and the last is counted."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # A warm-up window of ``calls`` calls first, its events discarded: the
    # tracer can miss the kernels that run just after it starts, which
    # would read as a call that launched fewer. Each window also keeps its
    # traced kernels clear of its edges: the host waits PROFILE_PAD_S after
    # the window opens, a spin kernel (not traced by name) runs first on the
    # card, and the host waits again after the card is done, before the
    # window closes.
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_PAD_S)
                torch.cuda._sleep(PROFILE_SPIN_CYCLES)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
                prof.step()
        records = dict(window_records(torch, prof.events(), calls),
                       attempt=attempt)
        TRACE_WINDOWS.append(records)
        if records["spin_kernel"]:
            break
        log("traced window without its spin kernel (device records lost), "
            "tracing again: " + json.dumps(records))
    us, count = {}, {}
    for ev in prof.key_averages():
        name = re.search(r"\b(radix_\w+|rows_\w+|packed_\w+|dim1_\w+|"
                         r"gather_\w+)", ev.key)
        if not name:
            continue
        us[name[1]] = us.get(name[1], 0.0) + (
            getattr(ev, "device_time_total", 0)
            or getattr(ev, "cuda_time_total", 0)) / calls
        count[name[1]] = count.get(name[1], 0) + ev.count
    records["kernels"] = dict(count)
    if any(n % calls for n in count.values()):
        raise AssertionError(f"kernel launches {count} over {calls} calls "
                             f"are not the same each call ({records})")
    return us, {k: n // calls for k, n in count.items()}


def traced_launches(torch, kernels, num_rows, fn, plus, label):
    """The kernels ``fn`` launches a call, traced: the sort's passes are
    its count kernel's launches; there must be as many as
    ``radix_sort_passes(num_rows)`` and 3 kernels a pass plus ``plus``."""
    us, launched = profiled(torch, fn)
    passes = launched.get("radix_count", 0)
    total = sum(launched.values())
    if (passes != kernels.radix_sort_passes(num_rows)
            or total != 3 * passes + plus):
        raise AssertionError(
            f"{label}: traced launches a call {launched}, expected "
            f"{kernels.radix_sort_passes(num_rows)} passes of 3 kernels "
            f"plus {plus}")
    return {"device_us": us, "launches": launched, "kernels_per_call": total,
            "sort_passes": passes}


def k2_breakdown(torch, kernels, inputs, sort_inputs):
    """Traced, at each K2 shape: the device µs and launches a call of each
    kernel K2 launches (the sort's count, scan and scatter; the sum's tile
    and carry passes), which must be 3 a sort pass plus 2; at each sort
    edge, the sort's own, 3 a pass. Run last, after every timed phase."""
    out = {}
    for label, table, ids, deltas in inputs:
        work = table.clone()
        out[label] = traced_launches(
            torch, kernels, table.shape[0],
            lambda: kernels.scatter_add_cuda_(work, ids, deltas), 2, label)
        log(f"K2 breakdown, {label}, a call: " + json.dumps(out[label]))
    sorts = {}
    for label, ids, num_rows in sort_inputs:
        sorts[label] = traced_launches(
            torch, kernels, num_rows,
            lambda: kernels.radix_sort_cuda(ids, num_rows), 0, label)
        log(f"K2 sort, {label}, a call: " + json.dumps(sorts[label]))
    return out, sorts


def k3_breakdown(torch, kernels, inputs):
    """Traced, at each K3 shape: the device µs and launches a call of each
    kernel K3 launches. The slice pass runs once a call and the fold pass
    once more where the plan has more than one cluster a tile. Run last,
    after every timed phase."""
    out = {}
    for label, table, ids, deltas, H in inputs:
        work = table.clone()
        us, launched = profiled(
            torch, lambda: kernels.scatter_add_packed_cuda_(work, ids,
                                                            deltas, H))
        plan = kernels.card_packed_plan(ids.device, ids.numel(), H,
                                         table.shape[1])
        want = {"packed_slice_pass": 1}
        if plan.groups > 1:
            want["packed_fold_pass"] = 1
        if launched != want:
            raise AssertionError(f"{label}: traced K3 launches a call "
                                 f"{launched}, expected {want}")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": sum(launched.values())}
        log(f"K3 breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def k4_breakdown(torch, kernels, inputs):
    """Traced, at each K4 shape: the device µs and launches a call of each
    kernel K4 launches, which must be what its plan counts: the bucket
    pass's count and scatter where the plan has more than one bucket, the
    tile pass, and the fold where it has more than one cluster. Run last,
    after every timed phase."""
    out = {}
    for label, table, ids, deltas in inputs:
        work = table.clone()
        us, launched = profiled(
            torch, lambda: kernels.scatter_add_dim1_cuda_(work, ids, deltas))
        plan = kernels.card_dim1_plan(ids.device, ids.numel(),
                                      table.shape[0])
        want = {"dim1_tile_pass": 1}
        if plan.buckets > 1:
            want.update(dim1_bucket_count=1, dim1_bucket_scatter=1)
        if plan.clusters > 1:
            want["dim1_fold_pass"] = 1
        if launched != want or sum(launched.values()) != plan.kernels:
            raise AssertionError(f"{label}: traced K4 launches a call "
                                 f"{launched}, expected {want} "
                                 f"({plan.kernels} kernels, dim1_plan)")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": plan.kernels}
        log(f"K4 breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def check_bucket(torch, kernels, label, ids, deltas, num_rows, plan):
    """Hold K4's bucket pass alone to its plain version (a stable sort of
    the kept ids by bucket): ids, deltas and starts bit for bit."""
    got_ids, got_vals, starts = kernels.dim1_bucket_cuda(ids, deltas,
                                                         num_rows)
    want = kernels.dim1_bucket_plain(ids, deltas, num_rows,
                                     plan.bucket_rows, plan.buckets)
    n = int(starts[-1])
    if not (torch.equal(starts, want[2]) and
            torch.equal(got_ids[:n], want[0]) and
            torch.equal(got_vals[:n], want[1])):
        raise AssertionError(f"{label}: K4's bucket pass differs from its "
                             "plain version")


def check_sort(torch, kernels, label, ids, num_rows):
    """Hold K2's radix sort to ``torch.sort(keys, stable=True)`` (keys
    and int32 positions, bit for bit)."""
    keys, perm = kernels.radix_sort_cuda(ids, num_rows)
    want_keys, want_perm = kernels.radix_sort_plain(ids, num_rows)
    torch.cuda.synchronize()
    if not (torch.equal(keys, want_keys) and torch.equal(perm, want_perm)):
        raise AssertionError(f"{label}: the radix sort differs from "
                             "torch.sort(keys, stable=True)")


def sort_edges(torch, kernels, dev):
    """K2's sort off the paths, each bit-equal to ``torch.sort``: one pass
    (R = 1) and four (R = 2^31 - 1), every id dropped, one id owning 2^20
    ids, equal keys across the sort's 4,096-position tiles, and batches that
    are not a multiple of the tile. Returns each case with its time, and
    the inputs for :func:`k2_breakdown`."""
    rng = np.random.default_rng(4)
    tile_runs = np.repeat(np.arange(12), [1, 4095, 1, 4096, 8192, 3, 4093,
                                          7, 4096, 2, 1, 4094])
    cases = [
        ("R = 1", 1, rng.integers(-1, 3, BATCH)),
        ("R = 2^31 - 1", 2**31 - 1, rng.integers(-5, 2**31 - 1, BATCH)),
        ("every id dropped", PA_NF, np.where(np.arange(BATCH) % 2, -1,
                                             PA_NF)),
        ("one id owns 2^20", PA_NF, np.full(SPARSE_BATCH * PA_NNZ, 7)),
        # 262,225 ids: tiles of 4,096 positions, the largest.
        ("runs across tile edges", PA_NF, np.concatenate(
            [tile_runs + 12 * k for k in range(9)] + [np.full(4096, -1)])
         [::-1]),
        ("B = 32,767 (not a multiple of the tile)", ML20M_ITEMS,
         rng.integers(-1, ML20M_ITEMS + 1, BATCH - 1)),
    ]
    out, inputs = [], []
    for label, num_rows, ids in cases:
        ids = torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(dev)
        check_sort(torch, kernels, label, ids, num_rows)
        case = {"shape": label, "R": num_rows, "B": int(ids.numel()),
                "sort_ms": time_ms(torch, lambda _: kernels.radix_sort_cuda(
                    ids, num_rows)),
                "torch_sort_ms": time_ms(torch, lambda _: torch.sort(
                    ids, stable=True))}
        log(f"K2 sort, {label}: bit-equal to torch.sort; " + json.dumps(case))
        out.append(case)
        inputs.append((label, ids, num_rows))
    return out, inputs


def sixteenths(torch, x):
    """``x`` rounded to a multiple of 1/16 within [-1/2, 1/2]. Float32 sums
    of up to 2^20 such terms stay below 2^24 sixteenths, so every partial
    sum is exact and any order of adding gives the float64 sum."""
    return torch.round(x.clamp(-2, 2) * 4) / 16


def check_packed(torch, label, kernels, table, ids, deltas, hot_rows, path,
                 reps=30, collect=None):
    """Hold K3 against its plain version and a float64 sum over the head
    rows (within the float32 summation bound; the same bits on two
    launches; rows past the head unchanged), and on sixteenths of the same
    inputs against the exact float64 sum, bit for bit: the worst-case bound
    grows with a row's push count past the row's own sum, so only the exact
    sums catch a lost or doubled push to a hot row. Time K3, K3 with the
    same slices unclustered (each block's partial through global scratch,
    the design before the cluster reduction), its plain version and
    ``index_add_`` of the head pushes into ``table[:H]``. ``collect`` (a
    list) gathers the inputs for :func:`k3_breakdown`."""
    kernel = kernels.scatter_add_packed_cuda_
    plain = kernels.scatter_add_packed_plain
    num_rows, dim = table.shape
    H = min(hot_rows, num_rows)
    B = ids.shape[0]
    got = kernel(table.clone(), ids, deltas, H)
    again = kernel(table.clone(), ids, deltas, H)
    want = plain(table.clone(), ids, deltas, H)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches gave different bits")
    if not torch.equal(got[H:], table[H:]):
        raise AssertionError(f"{label}: rows past the head changed")
    keep = (ids >= 0) & (ids < H)
    kid, kd = ids[keep], deltas[keep]
    ref, count = check_sum_bound(torch, label, table, kid, kd, got, want)
    et, ed = sixteenths(torch, table), sixteenths(torch, deltas)
    exact = et.double().index_add_(0, kid, ed[keep].double())
    for which, fn in (("kernel", kernel), ("plain", plain)):
        if not torch.equal(fn(et.clone(), ids, ed, H).double(), exact):
            raise AssertionError(
                f"{label}: {which} differs from the exact sum of sixteenths")
    uniq = int(torch.unique(kid).numel())
    # Least bytes: every id read, the head pushes' deltas read, each
    # touched head row read and written once.
    nbytes = B * 4 + kid.numel() * dim * 4 + 2 * uniq * dim * 4
    head = table[:H]
    plan = kernels.card_packed_plan(ids.device, B, H, dim)
    flat = plan._replace(cluster=1, groups=plan.slices,
                         partial_words=plan.slices * H * dim)
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "H": H, "head_pushes": int(kid.numel()), "unique_rows": uniq,
        "max_run": int(count.max()) if num_rows else 0,
        "plan": plan._asdict(),
        "max_abs_err": float((got - want).abs().max()),
        "max_err_vs_f64": float((got.double() - ref).abs().max()),
        "ms": time_ms(torch, lambda t: kernel(t, ids, deltas, H),
                      setup=table.clone, reps=reps),
        "call_ms": time_ms(torch, lambda t: kernel(t, ids, deltas, H),
                           setup=table.clone, hold=False, reps=reps),
        "unclustered_ms": time_ms(
            torch, lambda t: kernel(t, ids, deltas, H, plan=flat),
            setup=table.clone, reps=reps),
        "plain_ms": time_ms(torch, lambda t: plain(t, ids, deltas, H),
                            setup=table.clone, reps=reps),
        "library_ms": time_ms(torch, lambda t: t.index_add_(0, kid, kd),
                              setup=head.clone, reps=reps),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    log(f"{label}: deterministic, within the float32 bound and exact on "
        "sixteenths (kernel and plain); " + json.dumps(case))
    if collect is not None:
        collect.append((label, table, ids, deltas, H))
    return case


def split_end_to_end(torch, kernels, ops, label, table, ids, deltas, path):
    """The hot/cold split as the store calls it, ``ops.scatter_add_`` with
    ``hot_rows = 2,048`` (K3 for the head, the ``torch.where`` rewrite, K2
    for the tail), against K2 alone over the whole push: both within the
    float32 summation bound of the float64 sum, both timed."""
    num_rows, dim = table.shape
    got = ops.scatter_add_(table.clone(), ids, deltas, hot_rows=HOT)
    want = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    torch.cuda.synchronize()
    keep = (ids >= 0) & (ids < num_rows)
    check_sum_bound(torch, label, table, ids[keep], deltas[keep], got, want)
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim,
        "B": ids.shape[0], "hot_rows": HOT,
        "split_ms": time_ms(torch, lambda t: ops.scatter_add_(
            t, ids, deltas, hot_rows=HOT), setup=table.clone),
        "k2_ms": time_ms(torch, lambda t: kernels.scatter_add_cuda_(
            t, ids, deltas), setup=table.clone),
    }
    log(f"{label}: the split and K2 alone within the float32 bound; "
        + json.dumps(case))
    return case


def crossover_sweep(torch, kernels, dev):
    """K3 over the whole table (``hot_rows = R``) against K2 with its sort,
    at the JAX package's sweep shape (B = 32,768 Zipf(0.8) ids); the
    largest R at which K3 is not slower, for each D, is what
    ``fps_tpu_torch.ops.packed_crossover_rows`` returns."""
    rng = np.random.default_rng(1)
    rows = []
    for dim in (10, 32, 100, 200):
        for num_rows in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            pop = 1.0 / np.arange(1, num_rows + 1) ** 0.8
            ids = torch.from_numpy(rng.choice(
                num_rows, BATCH, p=pop / pop.sum()).astype(np.int32)).to(dev)
            table = torch.from_numpy(rng.normal(
                0, 1, (num_rows, dim)).astype(np.float32)).to(dev)
            deltas = torch.from_numpy(rng.normal(
                0, 1, (BATCH, dim)).astype(np.float32)).to(dev)
            k3 = time_ms(torch, lambda t: kernels.scatter_add_packed_cuda_(
                t, ids, deltas, num_rows), setup=table.clone, reps=10,
                warmup=2)
            k2 = time_ms(torch, lambda t: kernels.scatter_add_cuda_(
                t, ids, deltas), setup=table.clone, reps=10, warmup=2)
            rows.append({"D": dim, "R": num_rows, "k3_ms": k3, "k2_ms": k2})
            log(f"crossover D={dim} R={num_rows}: K3 {k3:.4f} ms, K2 (with "
                f"sort) {k2:.4f} ms")
    wins = {}
    for dim in (10, 32, 100, 200):
        ok = [r["R"] for r in rows if r["D"] == dim and r["k3_ms"] <= r["k2_ms"]]
        wins[dim] = max(ok) if ok else 0
    log(f"crossover: K3 not slower than K2 through R = {json.dumps(wins)}")
    return {"rows": rows, "k3_wins_through_R": wins}


def check_k4(torch, kernels, dev, label, view, ids, dl, path, collect):
    """K4 at one shape, with its plan and, where the plan has one, its
    bucket pass held to its plain version and timed alone."""
    R = view.shape[0]
    plan = kernels.card_dim1_plan(dev, ids.numel(), R)
    bucket = None
    if plan.buckets > 1:
        check_bucket(torch, kernels, label, ids, dl, R, plan)
        bucket = (lambda _: kernels.dim1_bucket_cuda(ids, dl, R))
    case = check_scatter(torch, label, kernels.scatter_add_dim1_cuda_,
                         kernels.scatter_add_dim1_plain, view, ids, dl, path,
                         collect=collect, sort_fn=bucket)
    case["plan"] = plan._asdict()
    return case


def kernel_phase(torch, kernels, pa_data, pa_q, mc_data, lr_data, dev):
    """Phase 3: every kernel against its plain version at its paths'
    shapes. Returns ``{kernel name: [case, ...]}``."""
    import fps_tpu_torch.ops as ops

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(rows, dim):
        return t(rng.normal(0, 1, (rows, dim)).astype(np.float32))

    def deltas(n, dim):
        return t(rng.normal(0, 1, (n, dim)).astype(np.float32))

    g1, s2 = kernels.gather_rows_cuda, kernels.scatter_add_cuda_
    g1p, s2p = kernels.gather_rows_plain, kernels.scatter_add_plain
    g5, g5p = kernels.gather_rows_dim1_cuda, kernels.gather_rows_dim1_plain
    cases = {"gather_rows": [], "scatter_add": [], "gather_rows_dim1": [],
             "scatter_add_dim1": [], "scatter_add_packed": [], "split": []}
    k2_inputs = cases["k2_inputs"] = []
    k3_inputs = cases["k3_inputs"] = []
    k4_inputs = cases["k4_inputs"] = []
    gather_inputs = cases["gather_inputs"] = []

    def k4_case(label, view, ids, dl, path):
        return check_k4(torch, kernels, dev, label, view, ids, dl, path,
                        k4_inputs)

    # K1 / K2 at the MF step: the item pull and push (mean's count column),
    # the user factors' gather and update; the "sum" combine's push is off
    # the smoke's path.
    for name, rows, zipf in (("items", ML20M_ITEMS, True),
                             ("users", ML20M_USERS, False)):
        cases["gather_rows"].append(check_gather(
            torch, kernels, f"K1 MF {name}", g1, g1p, table(rows, RANK),
            t(path_ids(rng, rows, BATCH, zipf)), "mf",
            collect=gather_inputs))
    for name, rows, dim, zipf, path in (
            ("items_mean_count_column", ML20M_ITEMS, RANK + 1, True, "mf"),
            ("users", ML20M_USERS, RANK, False, "mf"),
            ("items_sum", ML20M_ITEMS, RANK, True, "off_path")):
        cases["scatter_add"].append(check_scatter(
            torch, f"K2 MF {name}", s2, s2p, table(rows, dim),
            t(path_ids(rng, rows, BATCH, zipf)), deltas(BATCH, dim), path,
            kernels, k2_inputs))

    # The MF item push with hot_items = 2,048: the count-column scatter into
    # zeros, the head through K3, the tail through K2 (head ids -1).
    item_ids = t(path_ids(rng, ML20M_ITEMS, BATCH, True))
    item_deltas = deltas(BATCH, RANK + 1)
    acc = torch.zeros((ML20M_ITEMS, RANK + 1), device=dev)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 MF item head", kernels, acc, item_ids, item_deltas, HOT,
        "mf_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split MF item push", acc, item_ids,
        item_deltas, "mf_hot"))
    tail_ids = torch.where((item_ids >= 0) & (item_ids < HOT), -1, item_ids)
    cases["scatter_add"].append(check_scatter(
        torch, "K2 MF item tail", s2, s2p, acc, tail_ids, item_deltas,
        "mf_hot", kernels, k2_inputs))

    # K1 / K2 at the 20-class PA step: 2^20 Zipf(0.9) ids into (NF, 20).
    mc_ids = t(mix_dropped(mc_data["feat_ids"][:SPARSE_BATCH].reshape(-1),
                           PA_NF))
    cases["gather_rows"].append(check_gather(
        torch, kernels, "K1 PA multiclass", g1, g1p,
        table(PA_NF, PA_MC_CLASSES), mc_ids, "pa_multiclass", loop=True,
        collect=gather_inputs))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 PA multiclass", s2, s2p, table(PA_NF, PA_MC_CLASSES),
        mc_ids, deltas(mc_ids.numel(), PA_MC_CLASSES), "pa_multiclass",
        kernels, k2_inputs))
    mc_deltas = deltas(mc_ids.numel(), PA_MC_CLASSES)
    mc_table = table(PA_NF, PA_MC_CLASSES)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 PA multiclass head", kernels, mc_table, mc_ids, mc_deltas,
        HOT, "pa_multiclass_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split PA multiclass push", mc_table, mc_ids,
        mc_deltas, "pa_multiclass_hot"))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 PA multiclass tail", s2, s2p, table(PA_NF, PA_MC_CLASSES),
        torch.where((mc_ids >= 0) & (mc_ids < HOT), -1, mc_ids), mc_deltas,
        "pa_multiclass_hot", kernels, k2_inputs))
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 one id owns 2^20 pushes", kernels,
        table(PA_NF, PA_MC_CLASSES), torch.full_like(mc_ids, 7), mc_deltas,
        HOT, "off_path", collect=k3_inputs))

    # The logistic-regression step's ids: the dense head, then the tail.
    lr_ids = mix_dropped(np.concatenate([
        np.arange(LR_DENSE), lr_data["feat_ids"][:SPARSE_BATCH, LR_DENSE:]
        .reshape(-1)]), LR_NF)
    lr_ids = t(lr_ids)
    # K1 / K2 at the AdaGrad step: (NF, 2) pull, (NF, 3) push of [g, g^2,
    # count] into zeros.
    cases["gather_rows"].append(check_gather(
        torch, kernels, "K1 logreg adagrad", g1, g1p, table(LR_NF, 2),
        lr_ids, "logreg_adagrad", collect=gather_inputs))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 logreg adagrad", s2, s2p,
        torch.zeros((LR_NF, 3), device=dev), lr_ids,
        deltas(lr_ids.numel(), 3), "logreg_adagrad", kernels, k2_inputs))
    lr_deltas = deltas(lr_ids.numel(), 3)
    lr_zeros = torch.zeros((LR_NF, 3), device=dev)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 logreg adagrad head", kernels, lr_zeros, lr_ids,
        lr_deltas, HOT, "logreg_adagrad_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split logreg adagrad push", lr_zeros, lr_ids,
        lr_deltas, "logreg_adagrad_hot"))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 logreg adagrad tail", s2, s2p,
        torch.zeros((LR_NF, 3), device=dev),
        torch.where((lr_ids >= 0) & (lr_ids < HOT), -1, lr_ids), lr_deltas,
        "logreg_adagrad_hot", kernels, k2_inputs))
    # The whole-table route (hot_rows >= R), as hot_ids="auto" takes it.
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 whole table 4,096 x 10", kernels, table(4096, RANK),
        t(path_ids(rng, 4096, BATCH, True)), deltas(BATCH, RANK), 4096,
        "off_path", collect=k3_inputs))

    # K5 / K4 at the binary PA step: nnz-major ids of one head-sorted batch,
    # the first q * B read against the head table[:H] and pushed through the
    # head view, the rest against and through the whole table. The read is
    # one K5 call (the path's shape); the head view and the tail alone are
    # timed beside it off the path.
    ids = pa_data["feat_ids"][:SPARSE_BATCH].T.reshape(-1)
    split = pa_q * SPARSE_BATCH
    pa_table = table(PA_NF, 1)
    parts = {"head view": (pa_table[:PA_HEAD],
                           t(mix_dropped(ids[:split], PA_HEAD))),
             "tail": (pa_table, t(mix_dropped(ids[split:], PA_NF)))}
    cases["gather_rows_dim1"].append(check_gather(
        torch, kernels, "K5 PA head prefix, one call", g5, g5p, pa_table,
        torch.cat([parts["head view"][1], parts["tail"][1]]), "pa_binary",
        head=(PA_HEAD, split), collect=gather_inputs))
    for name, (view, part) in parts.items():
        cases["gather_rows_dim1"].append(check_gather(
            torch, kernels, f"K5 PA {name} alone", g5, g5p, view, part,
            "off_path"))
        cases["scatter_add_dim1"].append(k4_case(
            f"K4 PA {name}", view, part, deltas(part.numel(), 1),
            "pa_binary"))
    lr_table = table(LR_NF, 1)
    cases["gather_rows_dim1"].append(check_gather(
        torch, kernels, "K5 logreg", g5, g5p, lr_table, lr_ids, "logreg_sgd",
        collect=gather_inputs))
    cases["scatter_add_dim1"].append(k4_case(
        "K4 logreg", lr_table, lr_ids, deltas(lr_ids.numel(), 1),
        "logreg_sgd"))
    # K4 at 2^20 ids off the path: the whole PA push in one call, uniform
    # ids, and one id owning every push (its run cut over every block and
    # cluster).
    n = SPARSE_BATCH * PA_NNZ
    for name, all_ids in (
            ("whole push 2^20", mix_dropped(ids, PA_NF)),
            ("uniform 2^20", rng.integers(0, PA_NF, n)),
            ("one id owns 2^20", np.full(n, 7))):
        cases["scatter_add_dim1"].append(k4_case(
            f"K4 PA {name}", table(PA_NF, 1), t(all_ids.astype(np.int32)),
            deltas(n, 1), "off_path"))
    return cases


def check_launches(label, launched, per_step, steps):
    for name, count in launched.items():
        want = per_step.get(name, 0) * steps
        if count != want:
            raise AssertionError(
                f"{label}: {name} launched {count} times, expected {want} "
                f"({per_step.get(name, 0)} per step x {steps} steps)")


def check_finite(torch, label, tables, local_state):
    from fps_tpu_torch.parallel.mesh import Blocks

    leaves = dict(tables)
    if isinstance(local_state, (Blocks, torch.Tensor)):
        leaves["local_state"] = local_state
    for name, tb in leaves.items():
        for block in blocks_of(torch, tb):
            if not bool(torch.isfinite(block).all()):
                raise AssertionError(f"{label}: {name} has non-finite "
                                     "values")


def blocks_of(torch, x):
    """The tensors of a table or local-state leaf: a ``Blocks``' blocks, or
    the tensor itself."""
    return [x] if isinstance(x, torch.Tensor) else list(x)


def on_device(torch, x, device):
    """A copy of tables or local state (``Blocks``, tensors, dicts of them)
    with every block on ``device``."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, dict):
        return {k: on_device(torch, v, device) for k, v in x.items()}
    if isinstance(x, Blocks):
        return Blocks([b.to(device, copy=True) for b in x],
                      replicas=x.replicas)
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return x


def on_host(torch, x):
    """The global arrays of tables or local state as CPU tensors."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, dict):
        return {k: on_host(torch, v) for k, v in x.items()}
    if isinstance(x, Blocks):
        return torch.from_numpy(x.numpy())
    return x.cpu()


def run_path(torch, kernels, label, trainer, chunks, per_step, quality,
             card):
    """Train over ``chunks`` (prebuilt on the host) from fresh tables, the
    launch counters at 0 just before and read just after; check the counts
    (``per_step`` launches of each kernel a step), finite tables and
    ``quality(metrics)``; return a summary."""
    tables, local_state = trainer.init_state(0)
    steps = sum(int(np.prod(c["weight"].shape[:-1])) for c in chunks)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.fit_stream(
        tables, local_state, chunks, 1,
        on_chunk=lambda i, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, per_step, steps)
    check_finite(torch, label, tables, local_state)
    checks = quality(metrics)
    n = float(sum(m["n"].sum() for m in metrics))
    per_chunk = np.diff([t0] + stamps)
    steady = per_chunk[1:] if len(per_chunk) > 1 else per_chunk
    steps_per_chunk = steps // len(chunks)
    summary = {
        "path": label, "chunks": len(chunks), "steps": steps,
        "examples": n, "seconds": elapsed, "examples_per_s": n / elapsed,
        "ms_per_step": elapsed / steps * 1e3,
        "steady_ms_per_step": float(np.median(steady)) / steps_per_chunk
        * 1e3,
        "chunk_seconds": per_chunk.tolist(), "launches": launched,
        "launches_per_step": {k: v / steps for k, v in launched.items()
                              if v},
        "mesh": dict(trainer.mesh.shape), "quality": checks, "card": card,
    }
    log(f"path {label}: " + json.dumps(summary))
    return summary


def run_indexed_path(torch, fps, kernels, label, trainer, data, route_key,
                     local_batch, epochs, per_step, quality, card,
                     chunk_steps, state_check=None):
    """Train ``epochs`` epochs through device-resident ingest and
    ``run_indexed`` from fresh tables, the launch counters at 0 just before
    the run and read just after (the dataset's upload is set-up, before
    them); check the counts (``per_step`` launches of each kernel for every
    step of every epoch), finite
    tables and ``quality`` over the metrics cut into pieces of
    ``chunk_steps`` steps (``None``: one piece an epoch), and
    ``state_check(tables, local_state)`` where given; return a summary.
    Every position of the trainer's mesh is a worker of ``local_batch``
    examples a step."""
    mesh = trainer.mesh
    t0 = time.perf_counter()
    dataset = fps.DeviceDataset(mesh, data)
    plan = fps.DeviceEpochPlan(
        dataset, num_workers=fps.num_workers_of(mesh),
        local_batch=local_batch, route_key=route_key,
        seed=0, sync_every=trainer.config.sync_every)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    steps_per_call = trainer._indexed_call_steps(plan)
    steps_run = epochs * plan.steps_per_epoch
    tables, local_state = trainer.init_state(0)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=epochs,
        on_epoch=lambda e, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, per_step, steps_run)
    check_finite(torch, label, tables, local_state)
    state = (state_check(tables, local_state) if state_check is not None
             else None)
    pieces = [{k: v[i:i + (chunk_steps or len(m["n"]))] for k, v in m.items()}
              for m in metrics
              for i in range(0, len(m["n"]), chunk_steps or len(m["n"]))]
    checks = quality(pieces)
    n = float(sum(m["n"].sum() for m in metrics))
    per_epoch = np.diff([t0] + stamps)
    steps_per_epoch_run = steps_run // epochs
    summary = {
        "path": label, "epochs": epochs,
        "steps_per_epoch": plan.steps_per_epoch,
        "steps_per_call": steps_per_call, "steps_run": steps_run,
        "examples": n, "upload_seconds": upload_s, "seconds": elapsed,
        "examples_per_s": n / elapsed, "ms_per_step": elapsed / steps_run
        * 1e3,
        "steady_ms_per_step": float(per_epoch[-1]) / steps_per_epoch_run
        * 1e3,
        "epoch_seconds": per_epoch.tolist(), "launches": launched,
        "launches_per_step": {k: v / steps_run for k, v in launched.items()
                              if v},
        "mesh": dict(mesh.shape), "quality": checks, "card": card,
    }
    if state is not None:
        summary["state"] = state
    log(f"path {label}: " + json.dumps(summary))
    return summary


def traced_epoch(torch, label, trainer, plan, card):
    """Device busy share of a ``run_indexed`` step: a warm-up and an
    untraced epoch, timed, then a traced one (``torch.profiler``,
    summarised by ``fps_tpu_torch.utils.trace_summary``: each kernel's
    device time a step) against the untraced step. The trace goes to a
    temporary directory and is deleted."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    tables, local_state = trainer.init_state(0)
    times = []
    for e in range(2):  # warm-up, then the untraced epoch that is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables, local_state, _ = trainer.run_indexed(
            tables, local_state, plan, 1, start_epoch=e)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    untraced_ms = times[-1] / plan.steps_per_epoch * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path))
        with prof:
            for e in (2, 3):
                tables, local_state, _ = trainer.run_indexed(
                    tables, local_state, plan, 1, start_epoch=e)
                torch.cuda.synchronize()
                prof.step()
        summary = trace_summary.summarize(trace_summary.load(path),
                                          plan.steps_per_epoch, top=30)
    busy = summary["device_busy_ms_per_step"]
    out = {"path": label, "steps": plan.steps_per_epoch,
           "untraced_ms_per_step": untraced_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / untraced_ms,
           "device_launches_per_step": summary["device_launches_per_step"],
           "traced_host_ms_per_step": summary["traced_host_ms_per_step"],
           "kernels": summary["kernels"], "card": card}
    log(f"traced epoch, {label}: " + json.dumps(out))
    return out


def traced_mf_epoch(torch, fps, mf_data, card):
    """:func:`traced_epoch` of the MF run_indexed step with hot_items: 64
    steps over the first 63 x 32,768 ratings."""
    mesh = fps.make_ps_mesh()
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01, hot_items=HOT)
    trainer, _ = fps.online_mf(mesh, cfg, combine="mean")
    part = {k: v[:63 * BATCH] for k, v in mf_data.items()}
    plan = fps.DeviceEpochPlan(fps.DeviceDataset(mesh, part), num_workers=1,
                               local_batch=BATCH, route_key="user", seed=0)
    return traced_epoch(torch, "MF sync, hot_items, run_indexed (traced "
                        "epoch)", trainer, plan, card)


def falling_rmse(metrics):
    rmses = [float(np.sqrt(m["se"].sum() / max(1.0, m["n"].sum())))
             for m in metrics]
    if not all(np.isfinite(rmses)) or not rmses[-1] < rmses[0]:
        raise AssertionError(f"train RMSE per chunk {rmses} is not finite "
                             "and falling")
    return {"train_rmse_per_chunk": rmses}


def below(key, limit):
    """``key`` per example over the last chunk (the end of the last epoch)
    must lie below ``limit``; chance is 0.5 for a binary mistake rate, 0.95
    for 20 classes, log 2 = 0.693 for the log loss."""
    def check(metrics):
        per_chunk = [float(m[key].sum() / max(1.0, m["n"].sum()))
                     for m in metrics]
        if not np.isfinite(per_chunk).all() or not per_chunk[-1] < limit:
            raise AssertionError(f"{key} per example by chunk {per_chunk}: "
                                 f"the last is not below {limit}")
        return {f"{key}_per_example_by_chunk": per_chunk, "limit": limit}
    return check


def paths_phase(torch, fps, kernels, pa_data, pa_q, mc_data, lr_data, card):
    """Phase 4: every path at full width, counters reset before each."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    mesh = fps.make_ps_mesh()
    runs = []
    data = synthetic_ratings(ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS, seed=0)
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.1, reg=0.01)
        trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                   combine="mean")
        t0 = time.perf_counter()
        chunks = list(multi_epoch_chunks(
            data, 2, num_workers=1, local_batch=BATCH, steps_per_chunk=64,
            route_key="user", sync_every=sync_every, seed=0))
        ingest_s = time.perf_counter() - t0
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        runs.append(dict(run_path(
            torch, kernels, f"MF {mode}", trainer, chunks,
            {"gather_rows": 2, "scatter_add": 2}, falling_rmse, card),
            host_ingest_s=ingest_s))
        del chunks

    def sparse(data, epochs, spc, sync_every=None):
        return list(multi_epoch_chunks(
            data, epochs, num_workers=1, local_batch=SPARSE_BATCH,
            steps_per_chunk=spc, sync_every=sync_every, seed=1))

    # Binary PA-I with the head prefix (bench.py run_pa on one device).
    # 800,000 examples make 49 steps an epoch: 7 chunks of 7 steps.
    cfg = fps.PAConfig(num_features=PA_NF, variant="PA-I", C=1.0,
                       hot_features=PA_HEAD, head_prefix_cols=pa_q)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I binary, head prefix", trainer,
        sparse(pa_data, 2, 7), {"gather_rows_dim1": 1,
                                "scatter_add_dim1": 2},
        below("mistakes", 0.5), card))
    # 20-class PA-I: 200,000 examples, 13 steps an epoch.
    cfg = fps.PAConfig(num_features=PA_NF, num_classes=PA_MC_CLASSES,
                       variant="PA-I", C=1.0)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I 20 classes", trainer, sparse(mc_data, 2, 13),
        {"gather_rows": 1, "scatter_add": 1}, below("mistakes", 0.95), card))
    # SSP logistic regression, SGD with the dense head (bench.py
    # run_logreg): 1,000,000 examples make 62 steps an epoch, padded to 64.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                           dense_features=LR_DENSE)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    runs.append(run_path(
        torch, kernels, "logreg SSP SGD, dense head", trainer,
        sparse(lr_data, 2, 16, sync_every=8),
        {"gather_rows_dim1": 1, "scatter_add_dim1": 1},
        below("logloss", 0.693), card))
    # A smaller AdaGrad run: 16 steps an epoch. AdaGrad's first steps on a
    # feature that every example carries are about lr * sqrt(B) times the
    # mean-to-rms ratio of its per-example gradients (the accumulator sums
    # per-example squares), so at B = 16,384 the SGD run's lr 0.1
    # overshoots (log loss 1.84, then 1.19 over two epochs on the card);
    # lr 0.01 takes steps of about 0.1 there.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.01,
                           dense_features=LR_DENSE, optimizer="adagrad")
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    small = {k: v[:LR_ADAGRAD_NEX] for k, v in lr_data.items()}
    runs.append(run_path(
        torch, kernels, "logreg SSP AdaGrad, dense head", trainer,
        sparse(small, 2, 16, sync_every=8),
        {"gather_rows": 1, "scatter_add": 1}, below("logloss", 0.693), card))

    # The hot/cold split through device-resident ingest and run_indexed.
    # MF as bench.py run_mf trains it, with hot_items = 2,048: calls of 64
    # steps (the last call of each epoch padded with weight-0 steps).
    split = {"gather_rows": 2, "scatter_add": 2, "scatter_add_packed": 1}
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.1, reg=0.01,
                           hot_items=HOT)
        trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                   combine="mean", max_steps_per_call=64)
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        runs.append(run_indexed_path(
            torch, fps, kernels, f"MF {mode}, hot_items, run_indexed",
            trainer, data, "user", BATCH, 2, split, falling_rmse, card, 64))
    runs.append(mf_topk_path(torch, fps, kernels, data, card)[0])
    mf_data = data
    del data
    # 20-class PA-I with hot_features = 2,048 (the multiclass table takes
    # the split: K3 for the head, K2 for the tail).
    cfg = fps.PAConfig(num_features=PA_NF, num_classes=PA_MC_CLASSES,
                       variant="PA-I", C=1.0, hot_features=HOT)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_indexed_path(
        torch, fps, kernels, "PA-I 20 classes, hot_features, run_indexed",
        trainer, mc_data, None, SPARSE_BATCH, 2,
        {"gather_rows": 1, "scatter_add": 1, "scatter_add_packed": 1},
        below("mistakes", 0.95), card, None))
    # AdaGrad logistic regression with hot_features = 2,048: the apply_fn
    # push's (NF, 3) sum-and-count scatter takes the split.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.01,
                           dense_features=LR_DENSE, optimizer="adagrad",
                           hot_features=HOT)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    runs.append(run_indexed_path(
        torch, fps, kernels, "logreg SSP AdaGrad, hot_features, run_indexed",
        trainer, small, None, SPARSE_BATCH, 2,
        {"gather_rows": 1, "scatter_add": 1, "scatter_add_packed": 1},
        below("logloss", 0.693), card, None))
    # Last, so that the profiler cannot slow the timed paths.
    traced = traced_mf_epoch(torch, fps, mf_data, card)
    return runs, traced, mf_data


def card_vs_cpu(torch, fps):
    """Small MF, head-prefix PA and SSP logistic-regression jobs on the card
    and on the CPU, from the same tables; return the largest table
    difference of each, relative to max(1, the table's largest value)."""
    from fps_tpu_torch.core.ingest import epoch_chunks, multi_epoch_chunks
    from fps_tpu_torch.utils import datasets as ds

    mf_data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    mf_cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                          learning_rate=0.1, reg=0.01)
    pa_data, q = ds.head_sort_slots(
        ds.synthetic_sparse_classification(8192, 2000, 16, seed=6,
                                           noise=0.05), 128)
    lr_data = ds.synthetic_sparse_classification(8192, 5000, 16, seed=7,
                                                 noise=0.05,
                                                 dense_features=3)
    lr_data["label"] = (lr_data["label"] > 0).astype(np.float32)
    jobs = {
        "MF sync": (lambda m: fps.online_mf(m, mf_cfg, combine="mean"),
                    lambda: epoch_chunks(mf_data, num_workers=1,
                                         local_batch=512, steps_per_chunk=8,
                                         route_key="user", seed=3)),
        "MF SSP": (lambda m: fps.online_mf(m, mf_cfg, sync_every=4,
                                           combine="mean"),
                   lambda: epoch_chunks(mf_data, num_workers=1,
                                        local_batch=512, steps_per_chunk=8,
                                        route_key="user", sync_every=4,
                                        seed=3)),
        "PA-I head prefix": (
            lambda m: fps.passive_aggressive(m, fps.PAConfig(
                num_features=2000, hot_features=128, head_prefix_cols=q)),
            lambda: multi_epoch_chunks(pa_data, 2, num_workers=1,
                                       local_batch=512, steps_per_chunk=8,
                                       seed=3)),
        "logreg SSP": (
            lambda m: fps.logistic_regression(m, fps.LogRegConfig(
                num_features=5000, learning_rate=0.1, dense_features=3),
                sync_every=4),
            lambda: multi_epoch_chunks(lr_data, 2, num_workers=1,
                                       local_batch=512, steps_per_chunk=8,
                                       sync_every=4, seed=3)),
    }
    # The hot/cold split through run_indexed: MF with hot_items (the item
    # push's count-column scatter on K3 + K2) and 20-class PA with
    # hot_features, each over a dataset resident on its device.
    mc_data = ds.synthetic_sparse_multiclass(4096, 2000, 20, 16, seed=8)

    def indexed(data, route_key, local_batch, sync_every=None):
        def run(trainer, tables, local):
            plan = fps.DeviceEpochPlan(
                fps.DeviceDataset(trainer.mesh, data), num_workers=1,
                local_batch=local_batch, route_key=route_key, seed=3,
                sync_every=sync_every)
            return trainer.run_indexed(tables, local, plan, 2, epochs=2)
        return run

    jobs.update(w2v_card_vs_cpu_jobs(fps))
    hot_mf = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                          learning_rate=0.1, reg=0.01, hot_items=64)
    jobs.update({
        "MF hot_items, run_indexed": (
            lambda m: fps.online_mf(m, hot_mf, combine="mean",
                                    max_steps_per_call=8),
            indexed(mf_data, "user", 512)),
        "MF hot_items SSP, run_indexed": (
            lambda m: fps.online_mf(m, hot_mf, sync_every=4, combine="mean"),
            indexed(mf_data, "user", 512, 4)),
        "PA-I 20 classes hot_features, run_indexed": (
            lambda m: fps.passive_aggressive(m, fps.PAConfig(
                num_features=2000, num_classes=20, hot_features=128)),
            indexed(mc_data, None, 256)),
    })
    worst = {}
    for job, (build, chunks) in jobs.items():
        runs = {}
        tables0 = local0 = None
        for device in ("cpu", "cuda"):
            mesh = fps.make_ps_mesh(device=device)
            trainer, _ = build(mesh)
            if tables0 is None:
                tables0, local0 = trainer.init_state(7)
            # Copies: the trainer updates its tables in place (donate).
            tables = on_device(torch, tables0, mesh.device)
            local = on_device(torch, local0, mesh.device)
            if job.endswith("run_indexed"):
                tables, local, _ = chunks(trainer, tables, local)
            else:
                tables, local, _ = trainer.fit_stream(tables, local,
                                                      chunks(), 2)
            leaves = on_host(torch, tables)
            if local0 != ():
                leaves["local_state"] = on_host(torch, local)
            runs[device] = leaves
        worst[job] = 0.0
        for name, want in runs["cpu"].items():
            diff = float((want - runs["cuda"][name]).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[job] = max(worst[job], diff / scale)
            log(f"card vs CPU, {job}, {name}: max abs diff {diff:.3e} "
                f"(largest value {scale:.3e})")
    return worst


# ---------------------------------------------------------------------------
# word2vec SGNS at text8 width (K1 and K2 at D = 100 and 101).
# ---------------------------------------------------------------------------

def w2v_config(fps):
    return fps.W2VConfig(vocab_size=W2V_VOCAB, dim=W2V_DIM)


def w2v_first_step_ids(torch, fps, tokens, uni):
    """The ids of each w2v path's first step, as the trainer makes them on
    the card: the block plan's first block (8,197 tokens) and, with the
    block worker's negatives, the OUT pull (49,182); the pairs plan's
    first step's 81,920 centers and 491,520 contexts and negatives."""
    from fps_tpu_torch.models import word2vec as w2v

    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    out = {}
    for mode, worker in (
            ("block", w2v.Word2VecBlockWorker(cfg, uni, W2V_BLOCK)),
            ("pairs", w2v.Word2VecWorker(cfg, uni))):
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=W2V_BLOCK, seed=1, mode=mode)
        batch = {k: v[0] for k, v in plan.call_batches(
            plan.epoch_args(0), 0, 1).items()}
        ids = worker.pull_ids(worker.prepare(batch, 0))
        out[mode] = {name: i.cpu().numpy() for name, i in ids.items()}
    return out


def w2v_kernel_cases(torch, kernels, cases, ids_by_mode, dev):
    """Phase 3 at the w2v shapes: K1 pulls of the (50,000, 100) tables and
    K2 mean pushes (the sum-and-count scatter, D = 101, into zeros) at the
    block path's 8,197 and 49,182 ids and, off the main path, the pairs
    path's 81,920 and 491,520; Zipf ids from the corpus, with -1 and >= R
    ids mixed in. Appends to ``cases`` and its collected inputs."""
    from fps_tpu_torch.models.word2vec import IN_TABLE, OUT_TABLE

    rng = np.random.default_rng(9)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for mode, path in (("block", "w2v_block"), ("pairs", "w2v_pairs")):
        for name, label in ((IN_TABLE, "IN"), (OUT_TABLE, "OUT")):
            ids = t(mix_dropped(ids_by_mode[mode][name], W2V_VOCAB))
            B = ids.numel()
            table = t(rng.normal(0, 0.05, (W2V_VOCAB, W2V_DIM)).astype(
                np.float32))
            cases["gather_rows"].append(check_gather(
                torch, kernels, f"K1 w2v {mode} {label} pull, {B} ids",
                kernels.gather_rows_cuda, kernels.gather_rows_plain, table,
                ids, path, collect=cases["gather_inputs"]))
            deltas = rng.normal(0, 0.01, (B, W2V_DIM + 1)).astype(np.float32)
            deltas[:, -1] = 1.0  # the count column
            cases["scatter_add"].append(check_scatter(
                torch, f"K2 w2v {mode} {label} mean push, {B} ids",
                kernels.scatter_add_cuda_, kernels.scatter_add_plain,
                torch.zeros((W2V_VOCAB, W2V_DIM + 1), device=dev), ids,
                t(deltas), path, kernels, cases["k2_inputs"]))


def first_last_real_step(metrics):
    """Loss a pair at the first and the last step with pairs, over the
    run's epochs (bench.py ``first_last_real_step``)."""
    loss = np.concatenate([m["loss"] for m in metrics])
    n = np.concatenate([m["n"] for m in metrics])
    real = np.flatnonzero(n > 0)
    return float(loss[real[0]] / n[real[0]]), float(loss[real[-1]] /
                                                    n[real[-1]])


def w2v_learns(negatives):
    """The last real step's loss a pair lies below the first step's and
    below the initial ``(1 + K) log 2`` (4.159 at K = 5)."""
    limit = (1 + negatives) * float(np.log(2.0))

    def check(metrics):
        first, last = first_last_real_step(metrics)
        if not (np.isfinite([first, last]).all() and last < first
                and last < limit):
            raise AssertionError(f"w2v loss a pair {first} -> {last}: not "
                                 f"falling below {limit}")
        return {"loss_per_pair_first_step": first,
                "loss_per_pair_last_step": last, "limit": limit}
    return check


def w2v_paths(torch, fps, kernels, tokens, uni, card):
    """Phase 4, word2vec at text8 width through its entry points: the block
    worker through ``Word2VecDevicePlan(mode="block")`` and ``run_indexed``
    (calls of up to 256 steps, as the bench), 2 epochs sync from fresh
    tables, then 1 SSP epoch (s = 4) from where they ended (as the bench
    times an epoch after a warm-up one: SGNS from a zero OUT table moves
    the loss a pair by about 1e-6 in its first epoch of this corpus, a few
    float32 roundings of the loss's sum); then the pair worker, two
    ``run_chunk`` calls of 8 steps of the pairs plan from fresh tables, the
    second timed. Counters at 0 just before each run, read just after: K1 2
    and K2 2 a step."""
    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    per_step = {"gather_rows": 2, "scatter_add": 2}
    runs = []
    state = None
    for sync_every, epochs in ((None, 2), (4, 1)):
        trainer, _ = fps.word2vec_block(mesh, cfg, uni, W2V_BLOCK,
                                        sync_every=sync_every,
                                        max_steps_per_call=256)
        t0 = time.perf_counter()
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=W2V_BLOCK, seed=1,
                                      sync_every=sync_every, mode="block")
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        summary, state = run_w2v(
            torch, kernels, f"w2v block {mode}, run_indexed", trainer, plan,
            epochs, per_step, len(tokens), card, state)
        runs.append(dict(summary, upload_seconds=upload_s))
    # The pair worker: one call of 8 steps (81,920 pairs a step).
    trainer, _ = fps.word2vec(mesh, cfg, uni)
    plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                  block_len=W2V_BLOCK, seed=1, mode="pairs")
    chunk = plan.call_batches(plan.epoch_args(0), 0, W2V_PAIR_STEPS)
    tables, local_state = trainer.init_state(0)
    times = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for rep in range(2):  # the second call is the steady one
        t0 = time.perf_counter()
        tables, local_state, m = trainer.run_chunk(tables, local_state,
                                                   chunk, rep)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launched = kernels.launch_counts()
    check_launches("w2v pairs, run_chunk", launched, per_step,
                   2 * W2V_PAIR_STEPS)
    check_finite(torch, "w2v pairs, run_chunk", tables, local_state)
    m = {k: v.cpu().numpy() for k, v in m.items()}
    pairs = float(m["n"].sum())
    summary = {
        "path": "w2v pairs, run_chunk", "calls": 2,
        "steps_per_call": W2V_PAIR_STEPS, "pairs_per_call": pairs,
        "call_seconds": times,
        "steady_ms_per_step": times[-1] / W2V_PAIR_STEPS * 1e3,
        "pairs_per_s": pairs / times[-1],
        "loss_per_pair": float(m["loss"].sum()) / max(pairs, 1.0),
        "launches": launched, "card": card}
    if not np.isfinite(summary["loss_per_pair"]):
        raise AssertionError("w2v pairs: the loss is not finite")
    log("path w2v pairs, run_chunk: " + json.dumps(summary))
    runs.append(summary)
    return runs


def run_w2v(torch, kernels, label, trainer, plan, epochs, per_step,
            num_tokens, card, state=None):
    """``epochs`` epochs of ``plan`` through ``run_indexed`` from
    ``state`` (``(tables, local_state)``; ``None``: fresh tables), the
    launch counters at 0 just before and read just after; checks the
    counts, finite tables and a falling loss; returns a summary with words/s
    (corpus tokens an epoch over the time) and steady ms a step (the last
    epoch), and the state it ended in."""
    tables, local_state = state or trainer.init_state(0)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=epochs,
        on_epoch=lambda e, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    steps_run = epochs * plan.steps_per_epoch
    check_launches(label, launched, per_step, steps_run)
    check_finite(torch, label, tables, local_state)
    checks = w2v_learns(trainer.logic.cfg.negatives)(metrics)
    pairs = float(sum(m["n"].sum() for m in metrics))
    per_epoch = np.diff([t0] + stamps)
    summary = {
        "path": label, "epochs": epochs,
        "steps_per_epoch": plan.steps_per_epoch,
        "steps_per_call": trainer._indexed_call_steps(plan),
        "steps_run": steps_run, "tokens_per_epoch": num_tokens,
        "pairs": pairs, "seconds": elapsed,
        "words_per_s": epochs * num_tokens / elapsed,
        "pairs_per_s": pairs / elapsed,
        "ms_per_step": elapsed / steps_run * 1e3,
        "steady_ms_per_step": float(per_epoch[-1]) / plan.steps_per_epoch
        * 1e3,
        "steady_words_per_s": num_tokens / float(per_epoch[-1]),
        "epoch_seconds": per_epoch.tolist(), "launches": launched,
        "quality": checks, "from_fresh_tables": state is None, "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary, (tables, local_state)


def traced_w2v_epoch(torch, fps, tokens, uni, card):
    """:func:`traced_epoch` of the w2v block step over the corpus's first
    300,000 tokens (21 steps); its kernels include the mean pushes'
    accumulator fills and adds."""
    mesh = fps.make_ps_mesh()
    trainer, _ = fps.word2vec_block(mesh, w2v_config(fps), uni, W2V_BLOCK,
                                    max_steps_per_call=256)
    plan = fps.Word2VecDevicePlan(tokens[:300_000], uni, w2v_config(fps),
                                  mesh, num_workers=1, block_len=W2V_BLOCK,
                                  seed=1, mode="block")
    return traced_epoch(torch, "w2v block sync, run_indexed (traced epoch)",
                        trainer, plan, card)


def w2v_card_vs_cpu_jobs(fps):
    """Small w2v jobs for :func:`card_vs_cpu`: the block worker (sync) and
    the pair worker (SSP, s = 4) through ``run_indexed``, 2 epochs each, on
    a 2,000-word corpus of 60,000 tokens, dim 32, blocks of 1,024; lr 0.1,
    so that the IN table's largest value triples and OUT's grows from 0 to
    about 0.02 over the run (the CPU's reading)."""
    from fps_tpu_torch.utils.datasets import load_text8

    tokens, vocab, uni = load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)

    def indexed(mode, sync_every):
        def run(trainer, tables, local):
            plan = fps.Word2VecDevicePlan(
                tokens, uni, cfg, trainer.mesh, num_workers=1,
                block_len=1024, seed=5, sync_every=sync_every, mode=mode)
            return trainer.run_indexed(tables, local, plan, 6, epochs=2)
        return run

    return {
        "w2v block, run_indexed": (
            lambda m: fps.word2vec_block(m, cfg, uni, 1024,
                                         max_steps_per_call=16),
            indexed("block", None)),
        "w2v pairs SSP, run_indexed": (
            lambda m: fps.word2vec(m, cfg, uni, sync_every=4),
            indexed("pairs", 4)),
    }

# ---------------------------------------------------------------------------
# iALS at the bench's width (K1 at D = 16, K2 at D = 256 and 16), the w2v
# co-occurrence sketch tap (K4 on its 81,920-row stack) and MF's online
# top-k tap.
# ---------------------------------------------------------------------------

def ials_data(ds):
    """bench.py run_ials's data and chunks: ``(train, test, chunks)``, the
    chunks of ``interaction_chunks(seed=0)``, the same every epoch (the
    bench makes them anew each epoch from the same seed)."""
    from fps_tpu_torch.models.ials import interaction_chunks

    data = ds.synthetic_implicit(IALS_USERS, IALS_ITEMS, IALS_PER_USER,
                                 rank=8, seed=0)
    train, test = ds.train_test_split(data, test_frac=0.1, seed=1)
    chunks = list(interaction_chunks(train, num_workers=1,
                                     local_batch=IALS_BATCH,
                                     steps_per_chunk=IALS_STEPS, seed=0))
    return train, test, chunks


def ials_kernel_cases(torch, kernels, cases, chunks, dev):
    """Phase 3 at the iALS step's shapes, from the path's first step: K1's
    pull of the fixed side (items, 16,384 x 16, in the user half; users,
    32,768 x 16, in the item half), B = 65,536, and K2's pushes of the
    solved side's ``A`` (D = 256) and ``b`` (D = 16) accumulators, into
    zeros, keyed by users (uniform) or items (Zipf-skewed); -1 and >= R ids
    mixed in."""
    rng = np.random.default_rng(10)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    step = {k: v[0] for k, v in chunks[0].items()}
    live = step["weight"] > 0
    sides = {"user": (IALS_USERS, step["user"]),
             "item": (IALS_ITEMS, step["item"])}
    for solve, fixed in (("user", "item"), ("item", "user")):
        rows, ids = sides[fixed]
        table = t(rng.normal(0, 0.3, (rows, IALS_RANK)).astype(np.float32))
        cases["gather_rows"].append(check_gather(
            torch, kernels, f"K1 iALS {solve} half pull, {rows} x "
            f"{IALS_RANK}", kernels.gather_rows_cuda,
            kernels.gather_rows_plain, table, t(mix_dropped(ids, rows)),
            "ials", collect=cases["gather_inputs"]))
        rows, ids = sides[solve]
        ids = t(mix_dropped(np.where(live, ids, -1), rows))
        for name, dim in (("A", IALS_RANK * IALS_RANK), ("b", IALS_RANK)):
            cases["scatter_add"].append(check_scatter(
                torch, f"K2 iALS {solve} half {name} push, D = {dim}",
                kernels.scatter_add_cuda_, kernels.scatter_add_plain,
                torch.zeros((rows, dim), device=dev), ids,
                t(rng.normal(0, 1, (IALS_BATCH, dim)).astype(np.float32)),
                "ials", kernels, cases["k2_inputs"]))


def sketch_spec():
    from fps_tpu_torch.sketch import TugOfWarSpec

    return TugOfWarSpec(depth=SKETCH_DEPTH, width=SKETCH_WIDTH, seed=0)


def sketch_kernel_case(torch, fps, kernels, cases, tokens, uni, dev):
    """Phase 3 at the sketch tap's stack update: K4 into the (16 x 5 x 1,024,
    1) stack (two row tiles: its bucket pass runs), the 409,600 items of the
    w2v block path's first step (the flat bucket of each of its 81,920 pairs
    in each of 5 hash rows, signed 0/1 weights), -1 and >= R ids mixed
    in."""
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.sketch import tow_rows_items

    mesh = fps.make_ps_mesh()
    plan = fps.Word2VecDevicePlan(tokens, uni, w2v_config(fps), mesh,
                                  num_workers=1, block_len=W2V_BLOCK, seed=1,
                                  mode="block")
    batch = {k: v[0] for k, v in plan.call_batches(plan.epoch_args(0), 0,
                                                   1).items()}
    center, ctx, w = w2v.block_pair_stream(batch)
    probe = torch.from_numpy(np.argsort(-uni)[:SKETCH_PROBES].astype(
        np.int32)).to(dev)
    R = SKETCH_PROBES * SKETCH_DEPTH * SKETCH_WIDTH
    flat, vals = tow_rows_items(sketch_spec(), SKETCH_PROBES,
                                w2v._probe_rows(probe, center), ctx, w)
    ids = torch.from_numpy(mix_dropped(flat.reshape(-1).cpu().numpy(),
                                       R)).to(dev)
    cases["scatter_add_dim1"].append(check_k4(
        torch, kernels, dev, f"K4 w2v sketch tap stack {R} x 1, "
        f"{ids.numel()} items", torch.zeros((R, 1), device=dev), ids,
        vals.reshape(-1, 1).contiguous(), "w2v_sketch_tap",
        cases["k4_inputs"]))


def ials_to_target(torch, kernels, label, solver, dev_chunks, train, test,
                   card):
    """A warm-up epoch on throwaway state, then epochs from fresh factors
    until recall@20 on the first 2,000 held-out pairs reaches 0.35 (at most
    8), the launch counters at 0 just before them and read just after: K1
    once and K2 twice a position a half-step (each shard's pull of the
    fixed side; each position's ``A`` and ``b`` pushes). Returns ``(summary,
    epoch)``, ``epoch()`` running one more epoch of the chunks."""
    from fps_tpu_torch.models.ials import recall_at_k

    P = len(solver.mesh.positions)
    half_steps = sum(c["weight"].shape[0] for c in dev_chunks)

    def epoch():
        solver.epoch(lambda: iter(dev_chunks))

    solver.init(99)
    epoch()  # warm-up on throwaway state, as the bench
    solver.init(0)
    epoch_s, recalls = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(IALS_MAX_EPOCHS):
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        recalls.append(recall_at_k(
            solver, test["user"][:IALS_EVAL], test["item"][:IALS_EVAL], k=20,
            exclude=(train["user"], train["item"])))
        if recalls[-1] >= IALS_TARGET:
            break
    launched = kernels.launch_counts()
    steps = 2 * half_steps * len(epoch_s)
    check_launches(label, launched, {"gather_rows": P, "scatter_add": 2 * P},
                   steps)
    check_finite(torch, label, solver.store.tables, None)
    if not recalls[-1] >= IALS_TARGET:
        raise AssertionError(f"{label}: recall@20 by epoch {recalls}: "
                             f"{IALS_TARGET} not reached in "
                             f"{IALS_MAX_EPOCHS} epochs")
    n = len(train["user"])
    summary = {
        "path": label, "epochs": len(epoch_s),
        "steps_per_epoch": 2 * half_steps, "interactions": n,
        "epoch_seconds": epoch_s, "recall_at_20_by_epoch": recalls,
        "target": IALS_TARGET, "seconds_to_target": sum(epoch_s),
        "interactions_per_s": [n / e for e in epoch_s],
        "ms_per_step": sum(epoch_s) / steps * 1e3,
        "steady_ms_per_step": epoch_s[-1] / (2 * half_steps) * 1e3,
        "launches": launched,
        "launches_per_step": {k: v / steps for k, v in launched.items()
                              if v},
        "mesh": dict(solver.mesh.shape), "card": card}
    return summary, epoch


def ials_path(torch, fps, kernels, train, test, chunks, card):
    """Phase 4, iALS as bench.py run_ials trains it: the chunks uploaded
    once (set-up), then :func:`ials_to_target` on one position (K1 1 and K2
    2 a step). Then, on the trained state, the parts of a half-epoch timed
    apart (CUDA events, the card held: the Gramian, one accumulate step,
    the solve; one step's host time too) and one traced epoch for the
    device's busy share."""
    from fps_tpu_torch.models.ials import ITEM_TABLE

    mesh = fps.make_ps_mesh()
    solver = fps.IALSSolver(mesh, fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))
    t0 = time.perf_counter()
    dev_chunks = [{k: torch.from_numpy(v).to(mesh.device)
                   for k, v in c.items()} for c in chunks]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    summary, epoch = ials_to_target(torch, kernels, "iALS, bench.py run_ials",
                                    solver, dev_chunks, train, test, card)

    # The parts of the user half on the trained state (one position: one
    # block each).
    fixed = list(solver.store.tables[ITEM_TABLE])
    gram = solver._gram(fixed, IALS_ITEMS)
    A = [torch.zeros((IALS_USERS, IALS_RANK * IALS_RANK), device=mesh.device)]
    b = [torch.zeros((IALS_USERS, IALS_RANK), device=mesh.device)]
    c0 = dev_chunks[0]
    step = [{"solve_ids": c0["user"][:1], "fixed_ids": c0["item"][:1],
             "rating": c0["rating"][:1], "weight": c0["weight"][:1]}]
    parts = {
        "gram_ms": time_ms(torch, lambda _: solver._gram(fixed, IALS_ITEMS)),
        "step_ms": time_ms(torch, lambda _: solver._accumulate(fixed, A, b,
                                                               step)),
        "step_call_ms": time_ms(torch, lambda _: solver._accumulate(
            fixed, A, b, step), hold=False),
        "solve_ms": time_ms(torch, lambda _: solver._solve(gram, A, b,
                                                           IALS_USERS)),
    }
    summary = dict(summary, upload_seconds=upload_s, parts_held=parts)
    log("path iALS: " + json.dumps(summary))
    traced = traced_ials_epoch(torch, solver, epoch,
                               summary["steps_per_epoch"],
                               summary["epoch_seconds"][-1], card)
    return summary, traced


def traced_ials_epoch(torch, solver, epoch, steps, untraced_s, card):
    """One iALS epoch under ``torch.profiler`` (after a warm-up one): the
    device's busy time a step against the untraced epoch's step."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path))
        with prof:
            for _ in range(2):
                epoch()
                torch.cuda.synchronize()
                prof.step()
        summary = trace_summary.summarize(trace_summary.load(path), steps,
                                          top=20)
    untraced_ms = untraced_s / steps * 1e3
    busy = summary["device_busy_ms_per_step"]
    out = {"path": "iALS (traced epoch)", "steps": steps,
           "untraced_ms_per_step": untraced_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / untraced_ms,
           "device_launches_per_step": summary["device_launches_per_step"],
           "traced_host_ms_per_step": summary["traced_host_ms_per_step"],
           "kernels": summary["kernels"], "card": card}
    log("traced epoch, iALS: " + json.dumps(out))
    return out


def w2v_sketch_path(torch, fps, kernels, tokens, uni, card):
    """Phase 4, the w2v block worker with ``cooccurrence_sketch_tap`` of the
    16 most frequent words (the example's ``--sketch-words 16``), one
    ``run_indexed`` call of an epoch of the phase's corpus from fresh
    tables, the launch counters at 0 just before and read just after: K1 2,
    K2 2 and K4 1 a step. The similarity matrix must be finite with a
    positive diagonal."""
    from fps_tpu_torch.models import word2vec as w2v

    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    trainer, _ = fps.word2vec_block(
        mesh, cfg, uni, W2V_BLOCK, max_steps_per_call=256,
        step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
    plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                  block_len=W2V_BLOCK, seed=1, mode="block")
    if trainer._indexed_call_steps(plan) != plan.steps_per_epoch:
        raise AssertionError("the sketch path's epoch is not one call")
    tables, local_state = trainer.init_state(0)
    label = "w2v block sync, sketch tap, run_indexed"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, {"gather_rows": 2, "scatter_add": 2,
                                     "scatter_add_dim1": 1},
                   plan.steps_per_epoch)
    check_finite(torch, label, tables, local_state)
    sims = w2v.sketch_similarity(w2v.accumulate_sketch_taps(metrics))
    if not (np.isfinite(sims).all() and (np.diag(sims) > 0).all()):
        raise AssertionError(f"{label}: similarity {sims} is not finite with "
                             "a positive diagonal")
    summary = {
        "path": label, "steps": plan.steps_per_epoch, "seconds": elapsed,
        "ms_per_step": elapsed / plan.steps_per_epoch * 1e3,
        "words_per_s": len(tokens) / elapsed,
        "probe_words": probe.tolist(),
        "similarity_diagonal": np.diag(sims).tolist(),
        "launches": launched, "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary


def pool_order_topk(scores, k, S):
    """The float64 ranking in the order of the top-k merge's shard-major
    pool: by score, ties by shard (``id % S``), then by row within the
    shard (``id // S``); on one shard, by (-score, id)."""
    ids = np.arange(scores.shape[1])
    return np.stack([np.lexsort((ids // S, ids % S, -r))[:k]
                     for r in scores])


def logical_rows(blocks, S):
    """A table's logical rows (``num_ids`` rows, padding dropped: the
    caller slices) from replica 0's ``S`` blocks, on the host, float64."""
    from fps_tpu_torch.core.store import id_to_phys

    full = np.concatenate([b.cpu().numpy() for b in blocks[:S]]).astype(
        np.float64)
    rps = full.shape[0] // S
    return full[np.asarray(id_to_phys(np.arange(full.shape[0]), S, rps))]


def mf_topk_path(torch, fps, kernels, data, card, mesh=None):
    """MF at ML-20M width with ``make_online_topk_tap`` (k 10, the first 2
    users of every 4th step, every worker): one ``run_chunk`` of 17 steps
    from fresh tables on ``mesh`` (default: one position; phase 4), the
    global batch of 32,768 split over the workers, the launch counters at 0
    just before and read just after (K1 3 a position a step: the item pull,
    the user rows, the tap's query rows; K2 2). On every tapped step each
    worker's ids must equal a float64 brute-force ranking, in the merge's
    pool order (:func:`pool_order_topk`), of that step's live item table
    (copied by a checking collective tap around the port's) for its users;
    the other steps emit -1. Then the same chunk again with the port's tap
    alone, timed (steady ms a step). Returns ``(summary, store,
    local_state)``."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.models import recommendation as rec

    mesh = mesh or fps.make_ps_mesh()
    W, S = fps.num_workers_of(mesh), mesh.shape["shard"]
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01)
    trainer, store = fps.online_mf(mesh, cfg, combine="mean")
    topk = rec.make_online_topk_tap(store, "item_factors", TOPK_K,
                                    every=TOPK_EVERY,
                                    query_fn=rec.mf_topk_query_fn(
                                        W, TOPK_QUERIES))
    seen = {}

    def tap(tables, batches, local_states, t):
        if t % TOPK_EVERY == 0:
            seen[t] = ([b.clone() for b in tables["item_factors"]],
                       torch.cat(list(local_states)).clone())
        return topk(tables, batches, local_states, t)

    tap.collective = True
    trainer.config = dataclasses.replace(trainer.config, step_tap=tap)
    chunk = next(epoch_chunks(data, num_workers=W, local_batch=BATCH // W,
                              steps_per_chunk=TOPK_STEPS, route_key="user",
                              seed=0))
    tables, local_state = trainer.init_state(0)
    label = "MF sync, online top-k tap, run_chunk" + (
        f", mesh {mesh.shape['data']}x{S}" if W > 1 else "")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, m = trainer.run_chunk(tables, local_state, chunk, 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, {"gather_rows": 3 * W,
                                     "scatter_add": 2 * W}, TOPK_STEPS)
    check_finite(torch, label, tables, local_state)
    ids = m["tap"]["topk_ids"].cpu().numpy()  # (T, W, q, k)
    users = m["tap"]["topk_query"].cpu().numpy()  # (T, W, q)
    scores = m["tap"]["topk_scores"].cpu().numpy()
    checked = 0
    for t in range(TOPK_STEPS):
        if t not in seen:
            if not ((ids[t] == -1).all() and (users[t] == -1).all()):
                raise AssertionError(f"{label}: step {t} is not tapped but "
                                     "emitted ids")
            continue
        item_blocks, user_rows = seen[t]
        items = logical_rows(item_blocks, S)[:ML20M_ITEMS]
        user_rows = user_rows.cpu().numpy().astype(np.float64)
        for w in range(W):
            valid = users[t, w] >= 0
            q = rec.mf_user_vectors(user_rows, W, users[t, w][valid])
            want = pool_order_topk(q @ items.T, TOPK_K, S)
            if not valid.any() or not np.array_equal(ids[t, w][valid],
                                                      want):
                raise AssertionError(f"{label}: step {t} worker {w} ids "
                                     f"{ids[t, w]} != brute force {want}")
            if not (np.diff(scores[t, w][valid], axis=1) <= 0).all():
                raise AssertionError(f"{label}: step {t} scores not "
                                     "descending")
            checked += int(valid.sum())
    trainer.config = dataclasses.replace(trainer.config, step_tap=topk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, local_state, _ = trainer.run_chunk(tables, local_state, chunk, 2)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    summary = {"path": label, "steps": TOPK_STEPS,
               "checked_call_seconds": elapsed,
               "ms_per_step": elapsed / TOPK_STEPS * 1e3,
               "steady_ms_per_step": steady / TOPK_STEPS * 1e3,
               "tapped_steps": sorted(seen), "k": TOPK_K,
               "queries_per_step": TOPK_QUERIES * W,
               "queries_checked": checked, "launches": launched,
               "launches_per_step": {k: v / TOPK_STEPS
                                     for k, v in launched.items() if v},
               "mesh": dict(mesh.shape), "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary, store, local_state


def taps_card_vs_cpu(torch, fps):
    """Phase 5 for this slice: a small iALS job (2,000 users, 1,000 items,
    rank 16, 2 epochs) and the w2v block worker with the sketch tap (the
    small corpus of :func:`w2v_card_vs_cpu_jobs`, 2 epochs), each on the
    card and on the CPU from the same tables and seeds. iALS's factors must
    lie within 1e-4 of the largest |value| (the same float32 systems; the
    sums and solves in another order); the tap sums must be equal bit for
    bit (±1 sums of 0/1 weights are exact in any order, and the plan's
    draws are the same on both) and the w2v tables within 1e-5."""
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.models.ials import interaction_chunks
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_implicit(2000, 1000, 20, rank=4, seed=0)
    chunks = list(interaction_chunks(data, num_workers=1, local_batch=4096,
                                     steps_per_chunk=4, seed=0))
    factors, tables0 = {}, None
    for device in ("cpu", "cuda"):
        solver = fps.IALSSolver(fps.make_ps_mesh(device=device),
                                fps.IALSConfig(2000, 1000, rank=IALS_RANK))
        if tables0 is None:
            tables0 = dict(solver.init(7))
        solver.store.tables = on_device(torch, tables0, solver.device)
        for _ in range(2):
            solver.epoch(lambda: iter(chunks))
        factors[device] = solver.factors()
    ials = max(float(np.abs(c - g).max() / np.abs(c).max())
               for c, g in zip(factors["cpu"], factors["cuda"]))
    if not ials <= 1e-4:
        raise AssertionError(f"card vs CPU, iALS: factors differ by {ials} "
                             "of their largest value > 1e-4")
    tokens, vocab, uni = ds.load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    runs, tables0 = {}, None
    for device in ("cpu", "cuda"):
        mesh = fps.make_ps_mesh(device=device)
        trainer, _ = fps.word2vec_block(
            mesh, cfg, uni, 1024, max_steps_per_call=16,
            step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
        if tables0 is None:
            tables0, local0 = trainer.init_state(7)
        tables = on_device(torch, tables0, mesh.device)
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=1024, seed=5, mode="block")
        tables, _, metrics = trainer.run_indexed(tables, local0, plan, 6,
                                                 epochs=2)
        runs[device] = (on_host(torch, tables),
                        w2v.accumulate_sketch_taps(metrics))
    if not np.array_equal(runs["cpu"][1], runs["cuda"][1]):
        raise AssertionError("card vs CPU, w2v sketch tap: the tap sums "
                             "differ")
    w2v_diff = max(float((runs["cpu"][0][k] - runs["cuda"][0][k]).abs().max())
                   / max(1.0, float(runs["cpu"][0][k].abs().max()))
                   for k in runs["cpu"][0])
    if not w2v_diff <= 1e-5:
        raise AssertionError(f"card vs CPU, w2v with the sketch tap: tables "
                             f"differ by {w2v_diff} > 1e-5")
    out = {"ials_factors": ials, "w2v_sketch_tap_tables": w2v_diff,
           "w2v_sketch_tap_sums_bit_equal": True,
           "w2v_sketch_tap_sum_abs": float(np.abs(runs["cpu"][1]).sum())}
    log("card vs CPU, iALS and the sketch tap: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The host pipeline (prefetch) and delayed pushes (push_delay).
# ---------------------------------------------------------------------------

class HostProbe:
    """Host seconds by part (``assemble``, ``place``, ``wait``), apart for
    the driver thread and the pipeline's worker; ``add`` is the duck-typed
    timer the prefetcher reports its worker's seconds a chunk to."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.s = {}

    def part(self, name, seconds):
        import threading

        who = ("driver" if threading.current_thread()
               is threading.main_thread() else "worker")
        with self.lock:
            key = f"{who}_{name}"
            self.s[key] = self.s.get(key, 0.0) + seconds

    def add(self, name, seconds):  # the prefetcher's timer
        with self.lock:
            key = f"timer_{name}"
            self.s[key] = self.s.get(key, 0.0) + seconds

    def host_serial(self):
        """The driver thread's seconds getting each next chunk onto the
        card: assembly plus placement when it does them, the queue wait
        when the pipeline does."""
        return sum(self.s.get(f"driver_{k}", 0.0)
                   for k in ("assemble", "place", "wait"))


def timed_source(chunks, probe):
    """``chunks``, each ``next`` timed as assembly on its thread."""
    it = iter(chunks)
    end = object()
    while True:
        t0 = time.perf_counter()
        item = next(it, end)
        probe.part("assemble", time.perf_counter() - t0)
        if item is end:
            return
        yield item


def probed(probe):
    """A context in which the driver's and the iALS solver's placement and
    prefetcher are timed into ``probe``: placement by thread, the driver
    thread's waits on the pipeline, and the worker's seconds through the
    prefetcher's ``timer``."""
    import contextlib

    from fps_tpu_torch.core import driver, prefetch
    from fps_tpu_torch.models import ials

    base_pf, base_place = prefetch.ChunkPrefetcher, prefetch.place_columns

    class TimedPrefetcher(base_pf):
        # The probe takes the driver's timer's place: phase 6 runs no
        # recorder, so the driver hands the prefetcher timer=None.
        def __init__(self, *args, timer=None, **kw):
            super().__init__(*args, timer=probe, **kw)

        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                probe.part("wait", time.perf_counter() - t0)

    def timed_place(columns, device):
        t0 = time.perf_counter()
        out = base_place(columns, device)
        probe.part("place", time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def ctx():
        mods = (driver, ials)
        try:
            for m in mods:
                m.ChunkPrefetcher = TimedPrefetcher
                m.place_columns = timed_place
            yield
        finally:
            for m in mods:
                m.ChunkPrefetcher, m.place_columns = base_pf, base_place

    return ctx()


def prefetch_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith("fps-prefetch")]


def chunk_marks(torch, obj, method, marks):
    """Record a CUDA event on the compute stream, and the host's clock, as
    each call of ``obj.method`` (one a chunk) begins; the intervals between
    the events are the pipeline's pace on the card's clock."""
    fn = getattr(obj, method)

    def marked(*args, **kw):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))
        return fn(*args, **kw)

    setattr(obj, method, marked)


def steady_ms(marks, steps_per_chunk):
    """Median ms between chunk starts after the first, a step."""
    gaps = [a.elapsed_time(b)
            for (a, _), (b, _) in zip(marks[1:-1], marks[2:])]
    return float(np.median(gaps)) / steps_per_chunk if gaps else None


def ab_arm(torch, kernels, label, depth, run, steps_per_chunk, card):
    """One arm of the A/B: ``run(depth, probe, marks)`` trains and returns
    a function that gives its state (run after the clock stops); the
    counters at 0 just before it and read just after."""
    probe, marks = HostProbe(), []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with probed(probe):
        state = run(depth, probe, marks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()
    state = state()
    left = prefetch_threads()
    if left:
        raise AssertionError(f"{label}, prefetch {depth}: threads {left} "
                             "alive after the run")
    serial = probe.host_serial()
    first = marks[0][1] - t0 if marks else None
    out = {"path": f"{label}, prefetch {depth}", "prefetch": depth,
           "chunks": len(marks), "wall_s": wall,
           "to_first_chunk_s": first, "after_first_chunk_s": wall - first,
           "steady_ms_per_step": steady_ms(marks, steps_per_chunk),
           "host_serial_s": serial, "host_serial_share": serial / wall,
           "worker_s": probe.s.get("timer_prefetch", 0.0),
           "host_s_by_part": dict(probe.s), "launches": launched,
           "card": card}
    return out, state


def same_state(torch, label, a, b):
    """Tables, local state and metrics of two arms, bit for bit."""
    (ta, la, ma), (tb, lb, mb) = a, b
    for k in ta:
        if not torch.equal(on_host(torch, ta[k]), on_host(torch, tb[k])):
            raise AssertionError(f"{label}: table {k} differs between arms")
    if (la is not None and la != ()
            and not torch.equal(on_host(torch, la), on_host(torch, lb))):
        raise AssertionError(f"{label}: local state differs between arms")
    for x, y in zip(ma, mb):
        for k in x:
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{label}: metric {k} differs")
    if len(ma) != len(mb):
        raise AssertionError(f"{label}: {len(ma)} and {len(mb)} chunks")


def host_ab(torch, kernels, label, make_trainer, make_chunks, card):
    """bench.py host_pipeline_ab on the port: the same chunk stream (an
    ``islice`` of ``epoch_chunks``, assembled inside the stream) through
    ``fit_stream`` at prefetch 0, then 2, each from fresh state after a
    warm-up of 2 chunks; the arms' tables, local state, metrics and launch
    counts must be equal."""
    import dataclasses
    from itertools import islice

    trainer = make_trainer()
    base = trainer.config
    tables, local = trainer.init_state(7)
    trainer.fit_stream(tables, local, islice(make_chunks(), 2), 8)

    def run(depth, probe, marks):
        trainer.config = dataclasses.replace(base, prefetch=depth)
        trainer.__dict__.pop("run_chunk", None)
        chunk_marks(torch, trainer, "run_chunk", marks)
        tables, local = trainer.init_state(0)
        out = trainer.fit_stream(
            tables, local, timed_source(islice(make_chunks(), AB_CHUNKS),
                                        probe), 1)
        return lambda: out

    arms = [ab_arm(torch, kernels, label, d, run, AB_STEPS, card)
            for d in AB_ORDER]
    trainer.config = base
    return finish_ab(torch, label, arms)


def finish_ab(torch, label, arms):
    """The gates and the summary of the arms, run in ``AB_ORDER``: every
    arm's state and launches equal the first arm's; the overlap ratio and
    the speedup from the summed host-serial seconds and walls of the two
    prefetch-0 and the two prefetch-2 arms (each pair also apart)."""
    (first, a) = arms[0]
    for arm, b in arms[1:]:
        same_state(torch, f"{label}, prefetch {arm['prefetch']}", a, b)
        if arm["launches"] != first["launches"]:
            raise AssertionError(f"{label}: launches {first['launches']} "
                                 f"and {arm['launches']} differ")
    off = [arm for arm, _ in arms if arm["prefetch"] == 0]
    on = [arm for arm, _ in arms if arm["prefetch"] != 0]

    def ratios(off, on):
        serial_off = sum(a["host_serial_s"] for a in off)
        serial_on = sum(a["host_serial_s"] for a in on)
        return {"overlap_ratio": (1.0 - serial_on / serial_off
                                  if serial_off > 0 else None),
                "speedup": (sum(a["wall_s"] for a in off)
                            / sum(a["wall_s"] for a in on)),
                "speedup_after_first_chunk": (
                    sum(a["after_first_chunk_s"] for a in off)
                    / sum(a["after_first_chunk_s"] for a in on))}

    out = dict({"path": label, "arms": [arm for arm, _ in arms],
                "by_pair": [ratios([f], [n]) for f, n in zip(off, on)]},
               **ratios(off, on))
    log(f"host pipeline A/B, {label}: " + json.dumps(out))
    return out


def ials_ab(torch, fps, kernels, train, test, card):
    """The iALS arm: ``IALSSolver.prefetch`` 0, then 2, over host chunks
    (``interaction_chunks``, assembled inside the stream), 2 epochs from the
    same factors after a warm-up epoch; factors bit-equal, recall@20 and
    launch counts equal."""
    from fps_tpu_torch.models.ials import interaction_chunks, recall_at_k

    solver = fps.IALSSolver(fps.make_ps_mesh(), fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))

    def chunks(probe=None):
        c = interaction_chunks(train, num_workers=1, local_batch=IALS_BATCH,
                               steps_per_chunk=IALS_STEPS, seed=0)
        return c if probe is None else timed_source(c, probe)

    solver.init(99)
    solver.epoch(chunks)

    def run(depth, probe, marks):
        solver.prefetch = depth
        solver.__dict__.pop("_accumulate", None)
        chunk_marks(torch, solver, "_accumulate", marks)
        solver.init(0)
        for _ in range(2):
            solver.epoch(lambda: chunks(probe))

        def state():
            recall = recall_at_k(solver, test["user"][:IALS_EVAL],
                                 test["item"][:IALS_EVAL], k=20,
                                 exclude=(train["user"], train["item"]))
            users, items = solver.factors()
            return ({"users": torch.from_numpy(users),
                     "items": torch.from_numpy(items)}, None,
                    [{"recall_at_20": np.array([recall])}])
        return state

    arms = [ab_arm(torch, kernels, "iALS host chunks", d, run, IALS_STEPS,
                   card) for d in AB_ORDER]
    solver.prefetch = 0
    return finish_ab(torch, "iALS host chunks", arms)


def constant_pusher(torch):
    """A worker that pushes ``val`` to ``id`` (``(B, k)`` ids, ``(B, k, D)``
    values): pushes that do not depend on the pulls, so every delivery
    schedule that lands each push once ends with the same table."""
    from fps_tpu_torch.core.api import StepOutput, WorkerLogic

    class ConstantPusher(WorkerLogic):
        def pull_ids(self, batch):
            return {"t": batch["id"].reshape(-1).to(torch.int32)}

        def step(self, batch, pulled, local_state, gen):
            ids = batch["id"].reshape(-1).to(torch.int32)
            vals = batch["val"].reshape(ids.shape[0], -1)
            return StepOutput(pushes={"t": (ids, vals)},
                              local_state=local_state, out={"n": vals.sum()})

    return ConstantPusher()


def delivered_once(torch, fps, kernels, mf_data, lr_data, card):
    """``push_delay`` 1 and 4 against 0 with the constant pusher: a wide
    table (26,744 x 10, B 32,768 Zipf item ids: K1 and K2) and an ``(R, 1)``
    table (1M rows, 16,384 x 39 ids: K5 and K4), 16 steps each; each table
    must end equal to the delay-0 one, within the float32 summation bound
    (bit-equal expected: the same scatter-adds in the same order), and each
    run launch what the delay-0 run launches."""
    from fps_tpu_torch.core.driver import Trainer, TrainerConfig
    from fps_tpu_torch.core.ingest import epoch_chunks

    rng = np.random.default_rng(3)
    n_mf = 16 * BATCH
    cases = {
        "wide K2": (ML20M_ITEMS, RANK, BATCH, {
            "id": mf_data["item"][:n_mf, None],
            "val": rng.normal(0, 1, (n_mf, 1, RANK)).astype(np.float32)}),
        "(R, 1) K4": (LR_NF, 1, SPARSE_BATCH, {
            "id": lr_data["feat_ids"][:16 * SPARSE_BATCH],
            "val": lr_data["feat_vals"][:16 * SPARSE_BATCH, :, None]}),
    }
    out = {}
    mesh = fps.make_ps_mesh()
    for label, (rows, dim, batch, data) in cases.items():
        chunks = list(epoch_chunks(data, num_workers=1, local_batch=batch,
                                   steps_per_chunk=8, seed=1))
        res = {}
        for d in (0, 1, 4):
            store = fps.ParamStore(mesh, [fps.TableSpec("t", rows,
                                                        dim).zeros_init()])
            trainer = Trainer(mesh, store, constant_pusher(torch),
                              config=TrainerConfig(push_delay=d))
            tables, local = trainer.init_state(0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tables, _, _ = trainer.fit_stream(tables, local, chunks, 1)
            torch.cuda.synchronize()
            res[d] = (tables["t"][0].clone(), kernels.launch_counts())
        base, launched = res[0]
        # Float32 sums of the same terms in any order lie within 2 k eps32
        # sum|terms| of each other, k the row's pushes + 1.
        ids = torch.from_numpy(np.concatenate(
            [c["id"].reshape(-1) for c in chunks])).to(base.device).long()
        vals = torch.from_numpy(np.concatenate(
            [c["val"].reshape(-1, dim) for c in chunks])).to(base.device)
        keep = (ids >= 0) & (ids < rows)
        mag = torch.zeros((rows, dim), dtype=torch.float64,
                          device=base.device).index_add_(
            0, ids[keep], vals[keep].double().abs())
        cnt = torch.zeros(rows, dtype=torch.float64,
                          device=base.device).index_add_(
            0, ids[keep], torch.ones_like(ids[keep], dtype=torch.float64))
        bound = 2 * (cnt + 1)[:, None] * EPS32 * mag
        entry = {"steps": 16, "pushes_per_step": batch * (
            data["id"].shape[1]), "launches_delay_0": launched}
        for d in (1, 4):
            got, got_launched = res[d]
            if got_launched != launched:
                raise AssertionError(
                    f"push_delay {d}, {label}: launches {got_launched}, at "
                    f"delay 0 {launched}")
            diff = (got.double() - base.double()).abs()
            if not bool((diff <= bound).all()):
                raise AssertionError(
                    f"push_delay {d}, {label}: differs from delay 0 past "
                    "the float32 summation bound")
            entry[f"delay_{d}"] = {"bit_equal": bool(torch.equal(got, base)),
                                   "max_abs_diff": float(diff.max())}
        out[label] = entry
    log("push_delay delivered once: " + json.dumps(out))
    return out


def push_delay_learns(torch, fps, kernels, mf_data, runs, card):
    """MF at ML-20M width with ``push_delay = 4`` at half phase 4's learning
    rate (tests/test_staleness.py's recipe), sync and SSP (s = 4), 2 epochs
    of prebuilt host chunks as phase 4's MF, timed beside the same job at
    ``push_delay = 0`` in turns (0, 4, 4, 0) at this position: every run's
    RMSE falls and its tables stay finite, a step launches what phase 4's MF
    step launches (K1 2, K2 2), and the runs at 4 launch what those at 0
    do. Each mode's summary gives the ms a step at 4 over that at 0, by
    pair and over both, and that at 0 over phase 4's (this phase runs after
    phase 5's traces). Returns ``(runs, summaries)``."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    mesh = fps.make_ps_mesh()
    runs_out, out = [], []
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.05, reg=0.01)
        chunks = list(multi_epoch_chunks(
            mf_data, 2, num_workers=1, local_batch=BATCH, steps_per_chunk=64,
            route_key="user", sync_every=sync_every, seed=0))
        mode = ("sync" if sync_every is None
                else f"ssp(sync_every={sync_every})")
        turns = []
        for d in AB_ORDER_DELAY:
            trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                       combine="mean", push_delay=d)
            turns.append(run_path(
                torch, kernels, f"MF {mode}, push_delay {d}", trainer,
                chunks, {"gather_rows": 2, "scatter_add": 2}, falling_rmse,
                card))
        at = {d: [t for t, dd in zip(turns, AB_ORDER_DELAY) if dd == d]
              for d in (0, 4)}
        for t in at[4]:
            if t["launches"] != at[0][0]["launches"]:
                raise AssertionError(
                    f"MF {mode}: launches at push_delay 4 {t['launches']}, "
                    f"at 0 {at[0][0]['launches']}")

        def ms(ts):
            return float(np.mean([t["steady_ms_per_step"] for t in ts]))

        phase4 = next(r for r in runs if r["path"] == f"MF {mode}")
        summary = {
            "path": f"MF {mode}, push_delay 4 against 0",
            "order": list(AB_ORDER_DELAY),
            "delay_4_over_0": ms(at[4]) / ms(at[0]),
            "delay_4_over_0_by_pair": [
                a["steady_ms_per_step"] / b["steady_ms_per_step"]
                for a, b in zip(at[4], at[0])],
            "phase4_steady_ms_per_step": phase4["steady_ms_per_step"],
            "delay_0_over_phase4": ms(at[0])
            / phase4["steady_ms_per_step"],
            "card": card}
        log("push_delay 4 beside 0: " + json.dumps(summary))
        runs_out += turns
        out.append(summary)
        del chunks
    return runs_out, out


def pipeline_card_vs_cpu(torch, fps):
    """A small MF job with ``push_delay = 2`` and ``prefetch = 2`` on the
    card and on the CPU from the same tables: the largest difference of
    its tables and local state, relative to max(1, the largest value)."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                       learning_rate=0.1, reg=0.01)
    runs, tables0, local0 = {}, None, None
    for device in ("cpu", "cuda"):
        trainer, _ = fps.online_mf(fps.make_ps_mesh(device=device), cfg,
                                   combine="mean", push_delay=2)
        trainer.config = dataclasses.replace(trainer.config, prefetch=2)
        if tables0 is None:
            tables0, local0 = trainer.init_state(7)
        tables = on_device(torch, tables0, trainer.device)
        local = on_device(torch, local0, trainer.device)
        tables, local, _ = trainer.fit_stream(
            tables, local, epoch_chunks(data, num_workers=1, local_batch=512,
                                        steps_per_chunk=8, route_key="user",
                                        seed=3), 2)
        runs[device] = dict(on_host(torch, tables),
                            local_state=on_host(torch, local))
    worst = 0.0
    for name, want in runs["cpu"].items():
        diff = float((want - runs["cuda"][name]).abs().max())
        worst = max(worst, diff / max(1.0, float(want.abs().max())))
    if not worst <= 1e-5:
        raise AssertionError(f"card vs CPU, MF push_delay 2 prefetch 2: "
                             f"{worst} of the largest value > 1e-5")
    log(f"card vs CPU, MF push_delay 2, prefetch 2: {worst:.3e} of the "
        "largest value")
    return worst


def pipeline_phase(torch, fps, kernels, mf_data, lr_data, ials_train,
                   ials_test, runs, card):
    """The host pipeline and delayed pushes, at full width: (a) the
    prefetch A/B on the MF (bench.py run_mf's), SSP logistic-regression
    (run_logreg's) and iALS arms; (b) push_delay delivered once on K2 and
    K4 tables, and MF with push_delay 4 learning; (c) the card against the
    CPU with push_delay 2 and prefetch 2."""
    from fps_tpu_torch.core.ingest import epoch_chunks

    mesh = fps.make_ps_mesh()
    ab = [
        host_ab(torch, kernels, "MF, bench.py run_mf host arm",
                lambda: fps.online_mf(mesh, fps.MFConfig(
                    num_users=ML20M_USERS, num_items=ML20M_ITEMS, rank=RANK,
                    learning_rate=0.1, reg=0.01), combine="mean")[0],
                lambda: epoch_chunks(mf_data, num_workers=1,
                                     local_batch=BATCH,
                                     steps_per_chunk=AB_STEPS,
                                     route_key="user", seed=5), card),
        host_ab(torch, kernels, "logreg SSP, bench.py run_logreg host arm",
                lambda: fps.logistic_regression(mesh, fps.LogRegConfig(
                    num_features=LR_NF, learning_rate=0.1,
                    dense_features=LR_DENSE), sync_every=8)[0],
                lambda: epoch_chunks(lr_data, num_workers=1, local_batch=4096,
                                     steps_per_chunk=AB_STEPS, sync_every=8,
                                     seed=5), card),
        ials_ab(torch, fps, kernels, ials_train, ials_test, card),
    ]
    once = delivered_once(torch, fps, kernels, mf_data, lr_data, card)
    delay_runs, learns = push_delay_learns(torch, fps, kernels, mf_data, runs,
                                           card)
    worst = pipeline_card_vs_cpu(torch, fps)
    return {"prefetch_ab": ab, "push_delay_delivered_once": once,
            "push_delay_learns": learns, "push_delay_runs": delay_runs,
            "card_vs_cpu": worst}


# ---------------------------------------------------------------------------
# The sharded mesh: meshes of several positions, all on the one card.
# ---------------------------------------------------------------------------

def replicas_equal(torch, mesh):
    """``state_check``: every data replica of each table's shard equals
    replica 0's bit for bit."""
    D, S = mesh.shape["data"], mesh.shape["shard"]

    def check(tables, local_state):
        for name, blocks in tables.items():
            for p in range(S, D * S):
                if not torch.equal(blocks[p], blocks[p % S]):
                    raise AssertionError(
                        f"mesh {D}x{S}: table {name}, position {p} differs "
                        f"from replica 0 of shard {p % S}")
        return {"replicas": D, "replicas_bit_equal": True}
    return check


def mesh_card_vs_cpu(torch, fps, shapes):
    """Small MF jobs (sync and SSP, run_indexed) on each mesh, on the card
    and on the CPU from the same state; the largest difference of the
    tables and the local state, relative to max(1, the largest value)."""
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                       learning_rate=0.1, reg=0.01)
    worst = {}
    for D, S in shapes:
        for sync_every in (None, 4):
            runs, tables0, local0 = {}, None, None
            for device in ("cpu", "cuda:0"):
                mesh = fps.make_ps_mesh(S, D, device=device)
                trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                           combine="mean")
                if tables0 is None:
                    tables0, local0 = trainer.init_state(7)
                plan = fps.DeviceEpochPlan(
                    fps.DeviceDataset(mesh, data), num_workers=D * S,
                    local_batch=512 // (D * S), route_key="user", seed=3,
                    sync_every=sync_every)
                tables, local, _ = trainer.run_indexed(
                    on_device(torch, tables0, mesh.device),
                    on_device(torch, local0, mesh.device), plan, 2,
                    epochs=2)
                runs[device] = dict(on_host(torch, tables),
                                    local_state=on_host(torch, local))
            job = f"MF {'sync' if sync_every is None else 'SSP'} {D}x{S}"
            worst[job] = max(
                float((want - runs["cuda:0"][k]).abs().max())
                / max(1.0, float(want.abs().max()))
                for k, want in runs["cpu"].items())
    log("card vs CPU on the mesh: " + json.dumps(worst))
    for job, diff in worst.items():
        if not diff <= 1e-5:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 "value > 1e-5")
    return worst


def dense_vs_gathered(torch, fps, kernels, card):
    """The dense and the gathered push of one MF item push (B = 32,768
    Zipf(0.8) ids over 4 workers) into the ML-20M item table on a (1, 4)
    mesh of the card: within the float32 summation bound of a float64 sum
    of each other, K2 once a position on either route; each route's time
    (CUDA events, median of 10, host launches included)."""
    from fps_tpu_torch.core import store as st

    D, S, W = 1, 4, 4
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    store = fps.ParamStore(mesh, [fps.TableSpec("t", ML20M_ITEMS, RANK)])
    blocks = list(store.init(0)["t"])
    rng = np.random.default_rng(11)
    ids = path_ids(rng, ML20M_ITEMS, BATCH, True)
    ids[::97] = -1
    dev = mesh.device
    tid = torch.from_numpy(ids).to(dev)
    dl = torch.from_numpy(rng.normal(0, 1e-2, (BATCH, RANK)).astype(
        np.float32)).to(dev)
    wid, wdl = list(torch.chunk(tid, W)), list(torch.chunk(dl, W))
    out, times = {}, {}
    for dense in (False, True):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = st.push(blocks, wid, wdl, num_shards=S, dense=dense)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        if launched["scatter_add"] != W or sum(launched.values()) != W:
            raise AssertionError(f"dense={dense}: launches {launched}, "
                                 f"expected K2 {W}")
        out[dense] = torch.cat(got)
        times[dense] = time_ms(torch, lambda _: st.push(
            blocks, wid, wdl, num_shards=S, dense=dense), hold=False,
            reps=10, warmup=2)
    table = torch.cat(blocks).double()
    rps = blocks[0].shape[0]
    keep = (tid >= 0) & (tid < S * rps)
    phys = st.id_to_phys(tid[keep].long(), S, rps)
    mag = table.abs().index_add_(0, phys, dl[keep].double().abs())
    count = torch.zeros(table.shape[0], dtype=torch.float64,
                        device=dev).index_add_(
        0, phys, torch.ones_like(phys, dtype=torch.float64))
    bound = 2 * (count + 1)[:, None] * EPS32 * mag
    diff = (out[True].double() - out[False].double()).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError("dense vs gathered push: beyond the float32 "
                             f"bound by {float((diff - bound).max())}")
    res = {"shape": f"{ML20M_ITEMS}x{RANK}, B {BATCH}, mesh 1x4",
           "max_abs_diff": float(diff.max()),
           "bit_equal": bool(torch.equal(out[True], out[False])),
           "gathered_ms": times[False], "dense_ms": times[True],
           "card": card}
    log("dense vs gathered push: " + json.dumps(res))
    return res


def mesh_phase(torch, fps, kernels, mf_data, pa_data, pa_q, w2v_tokens,
               w2v_uni, ials_train, ials_test, ials_chunks, card):
    """The sharded mesh on the one card, every launch counter at 0 just
    before each run and read just after: MF at ML-20M width
    (``load_movielens(None, "20m")``'s data, phase 4's rank, the global
    batch of phase 4 split over the workers) through ``run_indexed``, one
    epoch sync and one SSP (s = 4), on a (1, 1), a (1, 4) and a (2, 2)
    mesh whose positions are all ``cuda:0`` (K1 2 and K2 2 a position a
    step: the shard's gather and the worker's user gather, the shard's
    count-column scatter and the worker's user scatter), the data replicas
    bit-equal; binary PA-I at (1, 4) (K5 and K4 once a position a step: no
    mesh of more than one position keeps the head prefix); word2vec at
    (1, 4) and (2, 2) (:func:`w2v_mesh_runs`), iALS at (1, 4)
    (:func:`ials_mesh_run`), MF with the online top-k tap at (1, 4) and
    ``recommend_topk`` over its item table; the dense against the gathered
    push at 4 shards; and small jobs of every family on both meshes, card
    against CPU. The positions share one card: the times measure what the
    single controller's launches cost, not scaling."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    runs = []
    for D, S in ((1, 1),) + MESH_SHAPES:
        W = D * S
        mesh = fps.make_ps_mesh(S, D, device="cuda:0")
        for sync_every in (None, 4):
            cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                               rank=RANK, learning_rate=0.1, reg=0.01)
            trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                       combine="mean", max_steps_per_call=64)
            mode = ("sync" if sync_every is None
                    else f"ssp(sync_every={sync_every})")
            runs.append(run_indexed_path(
                torch, fps, kernels, f"MF {mode}, mesh {D}x{S}, run_indexed",
                trainer, mf_data, "user", BATCH // W, 1,
                {"gather_rows": 2 * W, "scatter_add": 2 * W}, falling_rmse,
                card, 64, state_check=replicas_equal(torch, mesh)))
    mesh = fps.make_ps_mesh(4, 1, device="cuda:0")
    cfg = fps.PAConfig(num_features=PA_NF, variant="PA-I", C=1.0,
                       hot_features=PA_HEAD, head_prefix_cols=pa_q)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I binary, mesh 1x4", trainer,
        list(multi_epoch_chunks(pa_data, 2, num_workers=4,
                                local_batch=SPARSE_BATCH // 4,
                                steps_per_chunk=7, seed=1)),
        {"gather_rows_dim1": 4, "scatter_add_dim1": 4},
        below("mistakes", 0.5), card))
    runs += w2v_mesh_runs(torch, fps, kernels, w2v_tokens, w2v_uni, card)
    runs.append(ials_mesh_run(torch, fps, kernels, ials_train, ials_test,
                              ials_chunks, card))
    topk, store, local_state = mf_topk_path(
        torch, fps, kernels, mf_data, card,
        mesh=fps.make_ps_mesh(4, 1, device="cuda:0"))
    runs.append(topk)
    recommend = recommend_topk_check(torch, fps, kernels, store, local_state,
                                     card)
    dense = dense_vs_gathered(torch, fps, kernels, card)
    worst = dict(mesh_card_vs_cpu(torch, fps, MESH_SHAPES),
                 **mesh_models_card_vs_cpu(torch, fps, MESH_SHAPES))
    steps = {r["path"]: {"ms_per_step": r["ms_per_step"],
                         "steady_ms_per_step": r["steady_ms_per_step"],
                         "launches_per_step": r["launches_per_step"]}
             for r in runs}
    for path, entry in steps.items():
        log(f"mesh phase, {path}: {entry['steady_ms_per_step']:.3f} ms a "
            f"step (steady), launches a step {entry['launches_per_step']} "
            f"({card})")
    return {"runs": runs, "per_step": steps, "dense_vs_gathered": dense,
            "recommend_topk": recommend, "card_vs_cpu": worst, "card": card}


def reshard(torch, src, dst):
    """``dst``'s tables set to ``src``'s (their logical rows, through the
    host): the owner-major layout depends on the shard count."""
    from fps_tpu_torch.core.store import id_to_phys, padded_rows

    for name, spec in dst.specs.items():
        S = dst.num_shards
        full = np.zeros((padded_rows(spec.num_ids, S), spec.dim), np.float32)
        ids = np.arange(spec.num_ids)
        full[np.asarray(id_to_phys(ids, S, full.shape[0] // S))] = \
            src.lookup_host(name, ids)
        dst.put(name, torch.from_numpy(full).to(dst.mesh.device))
    return dict(dst.tables)


def w2v_mesh_runs(torch, fps, kernels, tokens, uni, card):
    """Phase 7, word2vec's block worker at phase 4's text8 width on the
    phase's corpus, through ``Word2VecDevicePlan(num_workers=W)`` and
    ``run_indexed``, every worker a block of 8,192 tokens a step: at (1, 4)
    two warm-up epochs from fresh tables (SGNS from a zero OUT table moves
    the loss a pair by about 1e-5 an epoch at first, phase 4's reading),
    then one sync epoch; at (2, 2) one
    SSP epoch (s = 4) from where (1, 4) ended (the tables laid out again for
    two shards). Counters at 0 just before each counted epoch, read just
    after: K1 2 and K2 2 a position a step; the loss falls as
    :func:`w2v_learns` requires, the (2, 2) data replicas bit-equal."""
    cfg = w2v_config(fps)
    runs, src = [], None
    for (D, S), sync_every in (((1, 4), None), ((2, 2), 4)):
        W = D * S
        mesh = fps.make_ps_mesh(S, D, device="cuda:0")
        trainer, store = fps.word2vec_block(mesh, cfg, uni, W2V_BLOCK,
                                            sync_every=sync_every,
                                            max_steps_per_call=256)
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=W,
                                      block_len=W2V_BLOCK, seed=1,
                                      sync_every=sync_every, mode="block")
        if src is None:
            tables, local = trainer.init_state(0)
            tables, local, _ = trainer.run_indexed(tables, local, plan, 0,
                                                   start_epoch=1, epochs=2)
            state = (tables, local)
        else:
            state = (reshard(torch, src, store), ())
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        summary, (tables, local) = run_w2v(
            torch, kernels, f"w2v block {mode}, mesh {D}x{S}, run_indexed",
            trainer, plan, 1, {"gather_rows": 2 * W, "scatter_add": 2 * W},
            len(tokens), card, state)
        summary = dict(summary, mesh=dict(mesh.shape),
                       state=replicas_equal(torch, mesh)(tables, local),
                       launches_per_step={
                           k: v / summary["steps_run"]
                           for k, v in summary["launches"].items() if v})
        runs.append(summary)
        src = store
    return runs


def ials_mesh_run(torch, fps, kernels, train, test, chunks, card):
    """Phase 7, iALS at bench.py run_ials's width on a (1, 4) mesh: phase
    4's chunks (a global batch of 65,536 a step), each step's columns cut
    over the 4 workers, :func:`ials_to_target` (K1 1 and K2 2 a position a
    half-step)."""
    mesh = fps.make_ps_mesh(4, 1, device="cuda:0")
    solver = fps.IALSSolver(mesh, fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))
    dev_chunks = [{k: torch.from_numpy(v).to(mesh.device)
                   for k, v in c.items()} for c in chunks]
    summary, _ = ials_to_target(torch, kernels, "iALS, bench.py run_ials, "
                                "mesh 1x4", solver, dev_chunks, train, test,
                                card)
    log("path iALS, mesh 1x4: " + json.dumps(summary))
    return summary


def recommend_topk_check(torch, fps, kernels, store, local_state, card):
    """``recommend_topk`` for the first 64 users' factors against the
    store's item table (4 shards of ML-20M's after the top-k path's MF):
    ids equal to the float64 brute force in the merge's pool order; the
    call's time (host clock around it, synchronised), median of 10."""
    from fps_tpu_torch.models import recommendation as rec

    W, S = fps.num_workers_of(store.mesh), store.num_shards
    users = np.arange(64)
    q = rec.mf_user_vectors(local_state.numpy(), W, users)
    items = logical_rows(list(store.tables["item_factors"]), S)[:ML20M_ITEMS]
    want = pool_order_topk(q.astype(np.float64) @ items.T, TOPK_K, S)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        ids, scores = rec.recommend_topk(store, "item_factors", q, TOPK_K)
        times.append(time.perf_counter() - t0)
    if not np.array_equal(ids, want):
        raise AssertionError(f"recommend_topk at {S} shards: ids != brute "
                             "force")
    out = {"path": f"recommend_topk, {len(users)} queries, {S} shards",
           "queries": len(users), "k": TOPK_K, "ids_equal_brute_force": True,
           "call_ms": float(np.median(times)) * 1e3,
           "launches": kernels.launch_counts(),
           "mesh": dict(store.mesh.shape), "card": card}
    log("recommend_topk on the mesh: " + json.dumps(out))
    return out


def mesh_models_card_vs_cpu(torch, fps, shapes):
    """Small jobs on each mesh, on the card and on the CPU from the same
    state: the w2v block worker with the sketch tap (:func:`w2v_card_vs_cpu_
    jobs`'s corpus, blocks of 256 a worker, 2 epochs; tables within 1e-5 of
    their largest value, tap sums bit for bit), iALS (2,000 users, 1,000
    items, rank 16, 2 epochs; factors within 1e-4) and ``recommend_topk``
    over a small-integer table (exact scores: ids and scores equal)."""
    from fps_tpu_torch.models import recommendation as rec
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.models.ials import interaction_chunks
    from fps_tpu_torch.utils import datasets as ds

    tokens, vocab, uni = ds.load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    idata = ds.synthetic_implicit(2000, 1000, 20, rank=4, seed=0)
    rng = np.random.default_rng(2)
    items = rng.integers(-3, 4, (1000, 8)).astype(np.float32)
    queries = rng.integers(-2, 3, (64, 8)).astype(np.float32)
    worst = {}
    for D, S in shapes:
        W = D * S
        out = {}
        for device in ("cpu", "cuda:0"):
            mesh = fps.make_ps_mesh(S, D, device=device)
            trainer, _ = fps.word2vec_block(
                mesh, cfg, uni, 256, max_steps_per_call=16,
                step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
            tables, local = trainer.init_state(7)
            plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh,
                                          num_workers=W, block_len=256,
                                          seed=5, mode="block")
            tables, _, metrics = trainer.run_indexed(tables, local, plan, 6,
                                                     epochs=2)
            solver = fps.IALSSolver(mesh, fps.IALSConfig(2000, 1000,
                                                         rank=IALS_RANK))
            solver.init(7)
            chunks = list(interaction_chunks(idata, num_workers=W,
                                             local_batch=4096 // W,
                                             steps_per_chunk=4, seed=0))
            for _ in range(2):
                solver.epoch(lambda: iter(chunks))
            store = fps.ParamStore(mesh, [fps.TableSpec("items", 1000, 8)])
            store.put("items", torch.from_numpy(np.concatenate(
                [items[s::S] for s in range(S)])).to(mesh.device))
            out[device] = (on_host(torch, tables),
                           w2v.accumulate_sketch_taps(metrics),
                           solver.factors(),
                           rec.recommend_topk(store, "items", queries, 10))
        cpu, card = out["cpu"], out["cuda:0"]
        job = f"{D}x{S}"
        worst[f"w2v block, sketch tap {job}"] = max(
            float((cpu[0][k] - card[0][k]).abs().max())
            / max(1.0, float(cpu[0][k].abs().max())) for k in cpu[0])
        if not np.array_equal(cpu[1], card[1]):
            raise AssertionError(f"card vs CPU, w2v sketch tap {job}: the "
                                 "tap sums differ")
        worst[f"iALS {job}"] = max(
            float(np.abs(c - g).max() / np.abs(c).max())
            for c, g in zip(cpu[2], card[2]))
        for c, g in zip(cpu[3], card[3]):
            if not np.array_equal(c, g):
                raise AssertionError(f"card vs CPU, recommend_topk {job}: "
                                     "ids or scores differ")
    log("card vs CPU, word2vec, iALS and top-k on the mesh: "
        + json.dumps(worst))
    for job, diff in worst.items():
        tol = 1e-4 if job.startswith("iALS") else 1e-5
        if not diff <= tol:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 f"value > {tol}")
    return dict(worst, w2v_sketch_tap_sums_bit_equal=True,
                recommend_topk_equal=True)


# ---------------------------------------------------------------------------
# Phase 8: the mesh over several processes (torch.distributed).
# ---------------------------------------------------------------------------

# Each rank's collective timeout and the longest phase 8 waits on a rank
# (seconds); the depth of the NCCL rank's MF call and of the w2v call.
P8_TIMEOUT_S, P8_WAIT_S = 120, 300
P8_MF_STEPS, P8_W2V_STEPS = 64, 32
# Where every position of the phase lives, and the backend of its one rank.
P8_DEVICE, P8_ONE_RANK_BACKEND = "cuda:0", "nccl"
# The gloo ranks' jobs, in order (p8_job).
P8_GLOO_JOBS = ("mf_sync_1x4", "mf_ssp_2x2", "pa_1x4", "w2v_1x4",
                "ials_1x4", "tiered_1x4", "mapped_1x4", "ckpt_1x4")
# The checkpoint job: MF at (1, 4), 4 chunks of 16 steps, every rank saving
# into one directory after every chunk (under P8_WHERE, the phase's
# directory; the one process saves apart).
P8_CKPT_CHUNKS, P8_CKPT_STEPS = 4, 16
P8_WHERE = [None]
# The hot tier's gloo job: phase 9's head_compact arm at (1, 4), 32 steps;
# the adaptive tier's: phase 10's recovery arm at (1, 4) on the first 32
# steps of its stream, re-ranked at every chunk.
P8_TIER_CHUNKS = 4


def p8_save(where, mf_data, pa_data, tokens, uni, ials_chunks):
    """The phase's inputs, made once in the parent, for the ranks."""
    arrays = {f"mf_{k}": mf_data[k] for k in ("user", "item", "rating")}
    arrays.update({f"pa_{k}": v for k, v in pa_data.items()})
    arrays.update(w2v_tokens=tokens, w2v_uni=uni)
    for i, c in enumerate(ials_chunks):
        arrays.update({f"ials{i}_{k}": v for k, v in c.items()})
    np.savez(os.path.join(where, "data.npz"), **arrays)


def p8_load(where):
    with np.load(os.path.join(where, "data.npz")) as z:
        d = {k: z[k] for k in z.files}
    ials = {}
    for k, v in d.items():
        if k.startswith("ials"):
            i, col = k[4:].split("_", 1)
            ials.setdefault(int(i), {})[col] = v
    return {"mf": {k: d[f"mf_{k}"] for k in ("user", "item", "rating")},
            "pa": {k[3:]: v for k, v in d.items() if k.startswith("pa_")},
            "tokens": d["w2v_tokens"], "uni": d["w2v_uni"],
            "ials": [ials[i] for i in sorted(ials)]}


def p8_trained(result):
    """``read()`` of a trainer's result: every table, the local state and
    the metrics on the host (collectives over several processes)."""
    tables, local, metrics = result

    def read():
        out = {f"table/{k}": v.numpy() for k, v in tables.items()}
        if not isinstance(local, tuple):
            out["local"] = local.numpy()
        flat = [flat_metrics(m) for m in metrics]
        for k in flat[0]:
            out[f"metrics/{k}"] = np.concatenate([m[k] for m in flat])
        return out
    return read


def p8_job(torch, fps, job, mesh_of, data):
    """``(label, mesh, run, steps, per_step)``: ``run()`` trains from fresh
    state and returns ``read()``; ``per_step`` is each kernel's launches a
    position a step (or a function that gives them after the run)."""
    from fps_tpu_torch.core.ingest import epoch_chunks

    mf_cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                          rank=RANK, learning_rate=0.1, reg=0.01)
    if job.startswith("mf"):
        (D, S), sync_every, steps = {
            "mf_call_1x4": ((1, 4), None, P8_MF_STEPS),
            "mf_sync_1x4": ((1, 4), None, None),
            "mf_ssp_2x2": ((2, 2), 4, None)}[job]
        mesh = mesh_of(D, S)
        trainer, _ = fps.online_mf(mesh, mf_cfg, sync_every=sync_every,
                                   combine="mean", max_steps_per_call=64)
        plan = fps.DeviceEpochPlan(
            fps.DeviceDataset(mesh, data["mf"]), num_workers=D * S,
            local_batch=BATCH // (D * S), route_key="user", seed=0,
            sync_every=sync_every)
        if steps:  # depth cut: the epoch's first call
            plan.steps_per_epoch = steps
        state = trainer.init_state(0)
        mode = "sync" if sync_every is None else f"SSP (s = {sync_every})"
        return (f"MF {mode}, mesh {D}x{S}, run_indexed", mesh,
                lambda: p8_trained(trainer.run_indexed(*state, plan, 1)),
                plan.steps_per_epoch, {"gather_rows": 2, "scatter_add": 2})
    if job == "pa_1x4":
        mesh = mesh_of(1, 4)
        pa_data = dict(data["pa"])
        q = int(pa_data.pop("head_prefix_cols"))
        trainer, _ = fps.passive_aggressive(mesh, fps.PAConfig(
            num_features=PA_NF, variant="PA-I", C=1.0, hot_features=PA_HEAD,
            head_prefix_cols=q))
        chunks = list(epoch_chunks(pa_data, num_workers=4,
                                   local_batch=SPARSE_BATCH // 4,
                                   steps_per_chunk=7, seed=1))
        state = trainer.init_state(0)
        return ("PA-I binary, mesh 1x4, fit_stream", mesh,
                lambda: p8_trained(trainer.fit_stream(*state, chunks, 1)),
                sum(c["weight"].shape[0] for c in chunks),
                {"gather_rows_dim1": 1, "scatter_add_dim1": 1})
    if job == "w2v_1x4":
        mesh = mesh_of(1, 4)
        cfg = w2v_config(fps)
        trainer, _ = fps.word2vec_block(mesh, cfg, data["uni"], W2V_BLOCK,
                                        max_steps_per_call=P8_W2V_STEPS)
        plan = fps.Word2VecDevicePlan(data["tokens"], data["uni"], cfg, mesh,
                                      num_workers=4, block_len=W2V_BLOCK,
                                      seed=1, mode="block")
        plan.steps_per_epoch = P8_W2V_STEPS  # depth cut: one call
        state = trainer.init_state(0)
        return ("w2v block, mesh 1x4, run_indexed", mesh,
                lambda: p8_trained(trainer.run_indexed(*state, plan, 0)),
                P8_W2V_STEPS, {"gather_rows": 2, "scatter_add": 2})
    if job == "tiered_1x4":
        from fps_tpu_torch.utils import datasets as ds

        mesh = mesh_of(1, 4)
        trainer, _ = tier_mf(fps, mesh, TIER_H, TIER_C, True, None)
        chunks = tier_chunks(ds.zipf_ratings(
            TIER_NU, TIER_NI, 4 * TIER_LOCAL * TIER_SPC * P8_TIER_CHUNKS,
            seed=0), 4, None)[:P8_TIER_CHUNKS]
        steps = sum(c["weight"].shape[0] for c in chunks)
        state = trainer.init_state(0)
        k1, k2 = TIER_LAUNCHES["head_compact"]
        return ("MF tiered head_compact, mesh 1x4, fit_stream", mesh,
                lambda: p8_trained(trainer.fit_stream(*state, chunks, 1)),
                steps, {"gather_rows": k1 + 1 / TIER_E, "scatter_add": k2})
    if job == "mapped_1x4":
        from fps_tpu_torch.tiering import Retierer

        mesh = mesh_of(1, 4)
        trainer, _ = drift_mf(fps, mesh, "recovery")
        trainer.retierer = rt = Retierer(check_every=1,
                                         churn_threshold=-1.0)
        chunks = drift_chunks(drift_data(4, P8_TIER_CHUNKS),
                              4)[:P8_TIER_CHUNKS]
        steps = sum(c["weight"].shape[0] for c in chunks)
        state = trainer.init_state(0)

        def per_step():
            # K1 once a position for the entry's re-split and each re-rank.
            k1, k2 = DRIFT_LAUNCHES["mapped"][0], 1 / TIER_E
            return {"gather_rows": k1["gather_rows"]
                    + (1 + rt.re_ranks) / steps,
                    "scatter_add": k1["scatter_add"] + k2,
                    "scatter_add_dim1": k1["scatter_add_dim1"]}

        def run():
            out = p8_trained(trainer.fit_stream(*state, chunks, 1))
            if not rt.re_ranks:
                raise AssertionError("mapped_1x4: nothing re-ranked")
            return lambda: dict(out(), hot_ids=rt.hot_ids_for(
                ITEM, DRIFT_H), re_ranks=np.array(rt.re_ranks))
        return ("MF mapped head, re-ranked, mesh 1x4, fit_stream", mesh,
                run, steps, per_step)
    if job == "ckpt_1x4":
        import itertools

        from fps_tpu_torch.core.checkpoint import Checkpointer

        mesh = mesh_of(1, 4)
        trainer, store = fps.online_mf(mesh, mf_cfg, combine="mean")
        chunks = list(itertools.islice(epoch_chunks(
            data["mf"], num_workers=4, local_batch=BATCH // 4,
            steps_per_chunk=P8_CKPT_STEPS, route_key="user", seed=0),
            P8_CKPT_CHUNKS))
        state = trainer.init_state(0)
        ck = Checkpointer(os.path.join(P8_WHERE[0], "ckpt"), keep=8)

        def run():
            tables, local, _ = trainer.fit_stream(
                *state, chunks, 1, checkpointer=ck, checkpoint_every=1)
            return lambda: {"item_factors": store.dump_model(ITEM)[1],
                            "users": trainer.logic.export_local_state(
                                local.numpy()),
                            "steps": np.array(ck.steps())}
        return ("MF, every rank saving every chunk, mesh 1x4, fit_stream",
                mesh, run, P8_CKPT_CHUNKS * P8_CKPT_STEPS,
                {"gather_rows": 2, "scatter_add": 2})
    assert job == "ials_1x4", job
    mesh = mesh_of(1, 4)
    solver = fps.IALSSolver(mesh, fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))
    solver.init(0)

    def run():
        solver.epoch(lambda: iter(data["ials"]))
        return lambda: dict(zip(("users", "items"), solver.factors()))
    return ("iALS, mesh 1x4, one epoch", mesh, run,
            2 * sum(c["weight"].shape[0] for c in data["ials"]),
            {"gather_rows": 1, "scatter_add": 2})


def p8_run(torch, fps, kernels, job, mesh_of, data, spent):
    """One job, the launch counters at 0 just before and read just after:
    its arrays and its stats (``spent[0]``: seconds in cross-process
    exchange, where the rank counts them)."""
    label, mesh, run, steps, per_step = p8_job(torch, fps, job, mesh_of,
                                                data)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    spent[0] = 0.0
    t0 = time.perf_counter()
    read = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    exchange_s = spent[0]
    own = len(mesh.local)
    if callable(per_step):  # counts only the run knows
        per_step = per_step()
    check_launches(label, launched, {k: v * own for k, v in per_step.items()},
                   steps)
    arrays = read()
    for k, v in arrays.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"{label}: {k} has non-finite values")
    return arrays, {"path": label, "steps": steps, "seconds": elapsed,
                    "ms_per_step": elapsed / steps * 1e3,
                    "exchange_seconds": exchange_s,
                    "exchange_share": exchange_s / elapsed,
                    "launches": launched, "positions": own,
                    "mesh": dict(mesh.shape)}


def p8_timed_exchange(torch, collectives, sync: bool):
    """Seconds spent in the collectives' exchanges between processes (the
    packing, staging and the library call): ``[seconds]``. With ``sync``
    (gloo, whose staged copies wait for the card anyway) the card's queue
    is drained first, so the wait for earlier kernels is not counted."""
    spent = [0.0]

    def timed(fn):
        def wrapper(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return wrapper
    collectives._gather = timed(collectives._gather)
    collectives._pieces = timed(collectives._pieces)
    return spent


def p8_rank(argv) -> int:
    """A phase 8 rank: ``--phase8-rank <rank> <world> <backend> <dir> <tag>
    <job,...>``. Joins the group, runs an uncounted MF call, then the jobs
    on meshes of its share of positions on ``P8_DEVICE``, and writes each
    job's arrays and the stats."""
    import datetime

    import torch

    import fps_tpu_torch as fps
    from fps_tpu_torch.ops import _build, kernels
    from fps_tpu_torch.parallel import collectives
    from fps_tpu_torch.parallel import mesh as tmesh

    rank, world, backend, where, tag, jobs = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4],
        argv[5].split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()  # built by the parent: this loads it
    tmesh.init_distributed(f"file://{where}/store_{tag}", world, rank,
                           backend=backend, device=P8_DEVICE,
                           timeout=datetime.timedelta(seconds=P8_TIMEOUT_S))
    P8_WHERE[0] = os.path.join(where, f"ranks_{tag}")
    try:
        data = p8_load(where)
        spent = p8_timed_exchange(torch, collectives, backend == "gloo")

        def mesh_of(D, S):
            return fps.make_ps_mesh(S, D, device=P8_DEVICE)

        # A fresh process's first call also pays for its first use of each
        # kernel and of the exchange: one MF call first, not counted.
        p8_run(torch, fps, kernels, "mf_call_1x4", mesh_of, data, spent)
        stats = {}
        for job in jobs:
            arrays, stats[job] = p8_run(torch, fps, kernels, job, mesh_of,
                                        data, spent)
            np.savez(os.path.join(where, f"{tag}_{job}_rank{rank}.npz"),
                     **arrays)
        with open(os.path.join(where, f"{tag}_rank{rank}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        tmesh.shutdown_distributed()
    return 0


def p8_spawn(where, tag, world, backend, jobs):
    """``world`` ranks of this script, logs to files (never pipes)."""
    procs = []
    for rank in range(world):
        with open(os.path.join(where, f"{tag}_log{rank}"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase8-rank",
                 str(rank), str(world), backend, where, tag, ",".join(jobs)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    return procs


def p8_wait(where, tag, procs):
    """Every rank's exit, or a failure naming the rank: a rank that exits
    non-zero or outlives ``P8_WAIT_S`` fails the phase; every rank still
    alive is killed on the way out."""
    t_end = time.monotonic() + P8_WAIT_S
    try:
        for rank, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(os.path.join(where, f"{tag}_log{rank}")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(
                    f"phase 8 {tag}: rank {rank} "
                    f"{'hung' if rc is None else f'exited {rc}'}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def p8_compare(where, tag, world, job, want):
    """Every rank's arrays of ``job`` against the one process's, bit for
    bit."""
    for rank in range(world):
        with np.load(os.path.join(where, f"{tag}_{job}_rank{rank}.npz")) as z:
            got = {k: z[k] for k in z.files}
        if sorted(got) != sorted(want):
            raise AssertionError(f"phase 8 {tag} {job}, rank {rank}: arrays "
                                 f"{sorted(got)} != {sorted(want)}")
        for k, v in want.items():
            if not np.array_equal(got[k], v):
                raise AssertionError(
                    f"phase 8 {tag} {job}, rank {rank}: {k} differs from "
                    "the one process's by up to "
                    f"{float(np.abs(got[k].astype(np.float64) - v).max())}")


def p8_restore_check(fps, where, tag, want):
    """One process restores the ranks' last save of the checkpoint job onto
    a (1, 4) mesh of the card: the state both ranks ended with, bit for
    bit."""
    from fps_tpu_torch.core.checkpoint import Checkpointer

    d = os.path.join(where, f"ranks_{tag}", "ckpt")
    if [f for f in os.listdir(d) if f.endswith(".tmp.npz")]:
        raise AssertionError(f"phase 8 {tag}: tmp files left in {d}")
    trainer, store = fps.online_mf(
        fps.make_ps_mesh(4, 1, device=P8_DEVICE), fps.MFConfig(
            num_users=ML20M_USERS, num_items=ML20M_ITEMS, rank=RANK,
            learning_rate=0.1, reg=0.01), combine="mean")
    _, like = trainer.init_state(3)
    _, local, step = trainer.restore_checkpoint(Checkpointer(d), like)
    got = {"item_factors": store.dump_model(ITEM)[1],
           "users": trainer.logic.export_local_state(local.numpy())}
    for k, v in got.items():
        if not np.array_equal(v, want[k]):
            raise AssertionError(f"phase 8 {tag}: the restored {k} differs "
                                 "from the ranks' state")
    if step != P8_CKPT_CHUNKS:
        raise AssertionError(f"phase 8 {tag}: restored step {step}")
    log(f"phase 8 {tag}: one process restored the ranks' save of step "
        f"{step} bit for bit")
    return {"step": step, "bit_equal": True}


def process_phase(torch, fps, kernels, mf_data, pa_data, pa_q, tokens, uni,
                  ials_chunks, card):
    """Phase 8: the mesh over several processes on ``torch.distributed``,
    every position on ``cuda:0``. (a) One NCCL rank at world size 1: MF at
    ML-20M width at (1, 4), one ``run_indexed`` call of 64 steps. (b) Two
    gloo ranks of 2 positions each (NCCL takes one rank a card; gloo's
    exchanges stage through pinned host memory): MF one sync epoch at
    (1, 4) and one SSP epoch (s = 4) at (2, 2), binary PA-I one epoch at
    (1, 4), the w2v block worker one ``run_indexed`` call of 32 steps at
    (1, 4), iALS one epoch at (1, 4). Every job's tables, local state and
    metrics on every rank equal, bit for bit, the same job run by this
    process alone on a mesh of the same shape (no ``init_distributed``),
    and every rank counts each kernel's launches a position a step as phase
    7 does. The two ranks share one card through host staging: their times
    measure that, not scaling."""
    import shutil
    import tempfile

    where = tempfile.mkdtemp(prefix="chip_smoke_phase8_")
    try:
        p8_save(where, mf_data, dict(pa_data, head_prefix_cols=np.int64(pa_q)),
                tokens, uni, ials_chunks)
        data = p8_load(where)
        one = {}
        P8_WHERE[0] = os.path.join(where, "one_process")
        for job in ("mf_call_1x4",) + P8_GLOO_JOBS:
            one[job] = p8_run(
                torch, fps, kernels, job,
                lambda D, S: fps.make_ps_mesh(S, D, device=P8_DEVICE), data,
                [0.0])
        del data
        results = {}
        for tag, world, backend, jobs in (
                ("a", 1, P8_ONE_RANK_BACKEND, ("mf_call_1x4",)),
                ("b", 2, "gloo", P8_GLOO_JOBS)):
            t0 = time.perf_counter()
            p8_wait(where, tag, p8_spawn(where, tag, world, backend, jobs))
            wall = time.perf_counter() - t0
            stats = []
            for rank in range(world):
                with open(os.path.join(where, f"{tag}_rank{rank}.json")) as f:
                    stats.append(json.load(f))
            for job in jobs:
                p8_compare(where, tag, world, job, one[job][0])
                ranks = [s[job] for s in stats]
                base = one[job][1]
                launched = {k: sum(r["launches"][k] for r in ranks)
                            for k in kernels.WRAPPERS}
                W = sum(r["positions"] for r in ranks)
                res = {
                    "path": f"{base['path']}, {world} {backend} rank"
                            f"{'s' if world > 1 else ''}",
                    "backend": backend, "ranks": world, "mesh": base["mesh"],
                    "steps": base["steps"],
                    "ms_per_step": max(r["ms_per_step"] for r in ranks),
                    "ms_per_step_by_rank": [r["ms_per_step"] for r in ranks],
                    "exchange_share_by_rank": [r["exchange_share"]
                                               for r in ranks],
                    "one_process_ms_per_step": base["ms_per_step"],
                    "launches": launched,
                    "launches_per_position_per_step": {
                        k: v / (W * base["steps"])
                        for k, v in launched.items() if v},
                    "bit_equal_to_one_process": True, "card": card}
                results[f"{tag}/{job}"] = res
                log(f"phase 8, {res['path']}: {res['ms_per_step']:.3f} ms a "
                    f"step (one process: {res['one_process_ms_per_step']:.3f}"
                    "), cross-process exchange "
                    f"{max(res['exchange_share_by_rank']):.1%} of it; "
                    "launches a position a step "
                    f"{res['launches_per_position_per_step']}; bit-equal to "
                    f"one process ({card})")
            log(f"phase 8 {tag}: {world} {backend} rank(s) done in "
                f"{wall:.1f} s")
            if "ckpt_1x4" in jobs:
                results[f"{tag}/ckpt_1x4"]["restored_by_one_process"] = (
                    p8_restore_check(fps, where, tag, one["ckpt_1x4"][0]))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    return {"runs": list(results.values()), "card": card,
            "note": "every position on one card; two ranks share it through "
                    "host staging: not scaling"}


# ---------------------------------------------------------------------------
# Phase 9: the static hot tier (TableSpec.hot_tier, hot_sync_every,
# cold_budget, ServerLogic.hot_fold).
# ---------------------------------------------------------------------------

# bench.py run_tiered (:946-1180) at its own widths: online MF, 4,096 users
# and items, rank 16, lr 0.05, mean combine, windows of 4 steps, local
# batch 1,024, 8 steps a chunk, 12 chunks' worth of Zipf(1.05) ratings,
# route_key "user", seed 5, a (2, 4) mesh (default_mesh_shape(8)).
TIER_NU = TIER_NI = 4096
TIER_RANK, TIER_LR, TIER_E = 16, 0.05, 4
TIER_H, TIER_C, TIER_SSP = 2048, 256, 2
TIER_LOCAL, TIER_SPC, TIER_CHUNKS, TIER_WARM = 1024, 8, 12, 2
TIER_MESH = (2, 4)
# (arm, hot_tier, cold_budget, gathered route, sync_every): run_tiered's.
TIER_ARMS = (("off", 0, 0, False, None), ("on", TIER_NI, 0, False, None),
             ("head", TIER_H, 0, True, None),
             ("head_compact", TIER_H, TIER_C, True, None),
             ("ssp", TIER_H, TIER_C, True, TIER_SSP))
# Each arm's launches a position a step (K1, K2) and a position a
# reconcile (K1: the owned rows' gather), read from the port's code: the
# user factors' gather and scatter (1 each) in every arm; the item pull
# (off: the gathered route's gather; on: the replica's; head: the
# replica's and the cold route's; head_compact: the replica's, the lane's
# and the lane's rows back to the batch; ssp: the snapshot's), the item
# push (off, on: one scatter, into the table or the buffer; head,
# head_compact, ssp: the cold push and the buffer's).
TIER_LAUNCHES = {"off": (2, 2), "on": (2, 2), "head": (3, 3),
                 "head_compact": (4, 3), "ssp": (2, 3)}
# SSP logistic regression as phase 4 runs it (1M features, SGD, dense head
# 13, s = 8), on a (1, 4) mesh with a head of 2,048 and windows of 8, one
# epoch: K5 1 and K4 2 a position a step (the snapshot's read; the cold
# push and the buffer's), K5 1 a position a round.
TIER_LR_H, TIER_LR_E, TIER_LR_MESH = 2048, 8, (1, 4)
TIER_FOLD_CHUNKS = 4
# The hot fold's step: Adagrad scales each row's window step to about lr,
# so lr is set to the size of a mean step here (the default, 1.0, is a
# unit step a row).
TIER_FOLD_LR = 0.01
ITEM = "item_factors"


def tier_kernel_cases(torch, kernels, cases, lr_data, dev):
    """Phase 3 at the hot tier's shapes, from phase 9's first step of
    worker 0: K1 the replica pull (the ``head`` arm's 2,048 x 16 replica,
    the worker's 1,024 items with its cold slots -1) and the reconcile's
    gather of a shard's owned rows (512 of the 2,048 x 16 step); K2 the
    mean buffer's scatter (2,048 x 17 with the count column, the worker's
    hot pushes); K5 the logistic-regression reconcile's gather (512 of
    2,048 x 1) and K4 its buffer's scatter (2,048 x 1, the hot part of
    the worker's first step, 4,096 examples of 39 ids)."""
    from fps_tpu_torch.utils import datasets as ds

    rng = np.random.default_rng(11)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    W, S = TIER_MESH[0] * TIER_MESH[1], TIER_MESH[1]
    hl = -(-TIER_H // S)
    own = np.arange(hl, dtype=np.int32) * S + 1  # shard 1's head rows
    own = np.where(own < TIER_H, own, -1).astype(np.int32)
    data = ds.zipf_ratings(TIER_NU, TIER_NI, W * TIER_LOCAL * TIER_SPC,
                           seed=0)
    item = tier_chunks(data, W, None)[0]["item"][0, :TIER_LOCAL]
    hot = np.where(item < TIER_H, item, -1).astype(np.int32)
    for label, rows, ids in (
            (f"replica pull, {TIER_LOCAL} ids", TIER_H, hot),
            (f"reconcile, a shard's {hl} owned rows", TIER_H, own)):
        cases["gather_rows"].append(check_gather(
            torch, kernels, f"K1 hot tier {rows} x {TIER_RANK}, {label}",
            kernels.gather_rows_cuda, kernels.gather_rows_plain,
            t(rng.normal(0, 0.1, (rows, TIER_RANK)).astype(np.float32)),
            t(ids), "tier", collect=cases["gather_inputs"]))
    deltas = rng.normal(0, 0.01, (TIER_LOCAL, TIER_RANK + 1)).astype(
        np.float32)
    deltas[:, -1] = hot >= 0  # the count column
    cases["scatter_add"].append(check_scatter(
        torch, f"K2 hot tier mean buffer {TIER_H} x {TIER_RANK + 1}, "
        f"{TIER_LOCAL} pushes", kernels.scatter_add_cuda_,
        kernels.scatter_add_plain,
        torch.zeros((TIER_H, TIER_RANK + 1), device=dev), t(hot), t(deltas),
        "tier", kernels, cases["k2_inputs"]))
    lr_own = np.arange(-(-TIER_LR_H // 4), dtype=np.int32) * 4 + 1
    cases["gather_rows_dim1"].append(check_gather(
        torch, kernels, f"K5 hot tier logreg reconcile {TIER_LR_H} x 1, a "
        f"shard's {lr_own.size} owned rows", kernels.gather_rows_dim1_cuda,
        kernels.gather_rows_dim1_plain,
        t(rng.normal(0, 0.1, (TIER_LR_H, 1)).astype(np.float32)),
        t(lr_own), "tier_logreg", collect=cases["gather_inputs"]))
    ids = lr_data["feat_ids"][:SPARSE_BATCH // 4].reshape(-1)
    lr_hot = np.where(ids < TIER_LR_H, ids, -1).astype(np.int32)
    cases["scatter_add_dim1"].append(check_k4(
        torch, kernels, dev, f"K4 hot tier logreg buffer {TIER_LR_H} x 1, "
        f"{lr_hot.size} pushes", torch.zeros((TIER_LR_H, 1), device=dev),
        t(lr_hot), t(rng.normal(0, 0.01, (lr_hot.size, 1)).astype(
            np.float32)), "tier_logreg", cases["k4_inputs"]))


class ExchangeSpy:
    """Counts the collectives a run calls (``parallel.collectives``' axis
    collectives) and the bytes this process's positions hand to them (each
    position's input tensors), split into the hot tier's reconcile (calls
    made inside ``reconcile_hot`` or ``reconcile_hot_mapped``), the
    adaptive tier's tracking (the windows' merge, ``merge_windows``), its
    re-splits (``ParamStore.rows_replica`` and ``head_replica``, at the
    boundaries) and the routes (the cold pull and push, the SSP snapshot).
    The step's metrics (``sum_home_each``) are not counted. ``compact``
    counts the driver's ``compact_cold`` calls."""

    NAMES = ("all_gather", "psum_scatter", "all_to_all", "psum", "pmax",
             "pmin")
    KINDS = ("reconcile", "tracking", "resplit", "routes")

    def __init__(self):
        self.calls = {k: 0 for k in self.KINDS}
        self.bytes = {k: 0 for k in self.KINDS}
        self.compact = 0
        self._within = []
        self._saved = []

    def __enter__(self):
        from fps_tpu_torch.core import driver
        from fps_tpu_torch.core.store import ParamStore
        from fps_tpu_torch.parallel import collectives

        def count(fn):
            def spy(mesh, xs, axis, *a, **k):
                kind = self._within[-1] if self._within else "routes"
                self.calls[kind] += 1
                self.bytes[kind] += sum(x.numel() * x.element_size()
                                        for x in xs)
                return fn(mesh, xs, axis, *a, **k)
            return spy

        def within(kind):
            def wrap(fn):
                def spy(*a, **k):
                    self._within.append(kind)
                    try:
                        return fn(*a, **k)
                    finally:
                        self._within.pop()
                return spy
            return wrap

        def compacted(fn):
            def spy(*a, **k):
                self.compact += 1
                return fn(*a, **k)
            return spy

        for name in self.NAMES:
            self._patch(collectives, name, count)
        for name in ("reconcile_hot", "reconcile_hot_mapped"):
            self._patch(driver, name, within("reconcile"))
        self._patch(driver, "merge_windows", within("tracking"))
        for name in ("rows_replica", "head_replica"):
            self._patch(ParamStore, name, within("resplit"))
        self._patch(driver, "compact_cold", compacted)
        return self

    def _patch(self, module, name, wrap):
        fn = getattr(module, name)
        self._saved.append((module, name, fn))
        setattr(module, name, wrap(fn))

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()


def tier_mf(fps, mesh, H, C, gathered, sync_every, fold=None):
    """run_tiered's MF trainer with the item table's tier set."""
    import dataclasses

    cfg = fps.MFConfig(num_users=TIER_NU, num_items=TIER_NI, rank=TIER_RANK,
                       learning_rate=TIER_LR)
    trainer, store = fps.online_mf(mesh, cfg, combine="mean",
                                   sync_every=sync_every)
    if H:
        store.specs[ITEM] = dataclasses.replace(
            store.specs[ITEM], hot_tier=H, cold_budget=C,
            **({"dense_collectives": False} if gathered else {}))
        trainer.config = dataclasses.replace(trainer.config,
                                             hot_sync_every=TIER_E)
    if fold is not None:
        trainer.server_logic[ITEM] = dataclasses.replace(
            trainer.server_logic[ITEM], hot_fold=fold)
    return trainer, store


def tier_chunks(data, W, sync_every):
    from fps_tpu_torch.core.ingest import epoch_chunks

    return list(epoch_chunks(data, num_workers=W, local_batch=TIER_LOCAL,
                             steps_per_chunk=TIER_SPC, route_key="user",
                             sync_every=sync_every, seed=5))


def boundary_check(torch, store, tables, name):
    """After a call: every position's replica equals the canonical table's
    head rows, bit for bit."""
    from fps_tpu_torch.core.store import hot_key

    rep = tables[hot_key(name)]
    for r in rep[1:]:
        if not torch.equal(r, rep[0]):
            raise AssertionError(f"{name}: the replicas differ")
    H = rep[0].shape[0]
    want = store.lookup_host(name, np.arange(H))
    if not np.array_equal(rep[0].cpu().numpy(), want):
        raise AssertionError(f"{name}: the replica differs from the "
                             "canonical head rows")


def flat_metrics(metrics):
    """A chunk's metrics with nested dicts as ``a/b/c`` keys."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}{k}/", v)
        else:
            out[prefix[:-1]] = np.asarray(x)
    walk("", metrics)
    return out


def tier_run(torch, kernels, label, trainer, store, chunks, table, card,
             per_step, reconcile_k, quality, warm=None):
    """One tiered job through ``fit_stream`` from fresh state (after
    ``warm`` chunks on fresh state, uncounted), the launch counters at 0
    just before and read just after, the collectives counted by an
    :class:`ExchangeSpy`, and the boundary invariant checked after every
    call (outside the timed stretches). ``per_step``: each kernel's
    launches a position a step; ``reconcile_k``: the kernel each reconcile
    launches once a position. Returns ``(summary, tables, local_state,
    host metrics)``."""
    W = len(trainer.mesh.local)
    if warm:
        tables, local = trainer.init_state(0)
        trainer.fit_stream(tables, local, warm, 9)
    tables, local = trainer.init_state(0)
    tiered = bool(trainer._hot_tier_map())
    tables = trainer._attach_hot(tables)  # not timed, not counted
    per_chunk, last, checks = [], [0.0], [0.0]

    def on_chunk(i, m):
        # A chunk's time runs from the end of the last chunk's check.
        now = time.perf_counter()
        per_chunk.append(now - last[0])
        if tiered:
            boundary_check(torch, store, trainer.store.tables, table)
        last[0] = time.perf_counter()
        checks[0] += last[0] - now

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with ExchangeSpy() as spy:
        t0 = last[0] = time.perf_counter()
        tables, local, metrics = trainer.fit_stream(tables, local, chunks, 1,
                                                    on_chunk=on_chunk)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0 - checks[0]
    launched = kernels.launch_counts()
    steps = sum(int(np.prod(c["weight"].shape[:-1])) for c in chunks)
    s = trainer.config.sync_every
    reconciles = 0
    if tiered:
        for c in chunks:
            T = int(np.prod(c["weight"].shape[:-1]))
            reconciles += T // s if s else -(-T // trainer.config.
                                             hot_sync_every)
    want = {k: v * W * steps for k, v in per_step.items()}
    if reconcile_k:
        want[reconcile_k] = want.get(reconcile_k, 0) + W * reconciles
    for k in kernels.WRAPPERS:
        if launched[k] != want.get(k, 0):
            raise AssertionError(
                f"{label}: {k} launched {launched[k]} times, expected "
                f"{want.get(k, 0)} ({per_step} a position a step, "
                f"{reconcile_k} once a position for each of {reconciles} "
                f"reconciles, {W} positions, {steps} steps)")
    check_finite(torch, label, tables, local)
    checked = quality(metrics)
    steady = per_chunk[1:] if len(per_chunk) > 1 else per_chunk
    n = float(sum(m["n"].sum() for m in metrics))
    summary = {
        "path": label, "chunks": len(chunks), "steps": steps,
        "examples": n, "seconds": elapsed, "examples_per_s": n / elapsed,
        "ms_per_step": elapsed / steps * 1e3,
        "steady_ms_per_step": float(np.median(steady))
        / (steps // len(chunks)) * 1e3,
        "launches": launched,
        "launches_per_position_per_step": {
            k: v / (W * steps) for k, v in launched.items() if v},
        "reconciles": reconciles,
        "exchanges_per_step": {k: v / steps for k, v in spy.calls.items()},
        "exchange_bytes_per_step": {k: v / steps
                                    for k, v in spy.bytes.items()},
        "compact_cold_calls": spy.compact,
        "mesh": dict(trainer.mesh.shape), "quality": checked, "card": card}
    return summary, tables, local, metrics


def hit_counts(chunks, H):
    """numpy's hot and pulled ids a step over the chunks: ``(hot,
    pulled)``, each a step's count over every worker."""
    hot, pulled = [], []
    for c in chunks:
        item = c["item"].reshape(-1, c["item"].shape[-1])
        hot.append(((item >= 0) & (item < H)).sum(1))
        pulled.append((item >= 0).sum(1))
    return np.concatenate(hot), np.concatenate(pulled)


def tier_arms(torch, fps, kernels, card):
    """Phase 9 (a): bench.py run_tiered's five arms on a (2, 4) mesh of the
    card, each from fresh state after 2 warm-up chunks, through
    ``fit_stream``."""
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    data = ds.zipf_ratings(TIER_NU, TIER_NI,
                           W * TIER_LOCAL * TIER_SPC * TIER_CHUNKS, seed=0)
    chunks = {s: tier_chunks(data, W, s) for s in (None, TIER_SSP)}
    out, finals = {}, {}
    for arm, H, C, gathered, s in TIER_ARMS:
        trainer, store = tier_mf(fps, mesh, H, C, gathered, s)
        k1, k2 = TIER_LAUNCHES[arm]
        summary, tables, local, metrics = tier_run(
            torch, kernels, f"MF tiered {arm}, mesh {D}x{S}, fit_stream",
            trainer, store, chunks[s], ITEM, card,
            per_step={"gather_rows": k1, "scatter_add": k2},
            reconcile_k="gather_rows" if H else None, quality=falling_rmse,
            warm=chunks[s][:TIER_WARM])
        summary["arm"] = arm
        hot = [flat_metrics(m) for m in metrics]
        key = f"hot_tier/{ITEM}/"
        if H and s is None:
            want_hot, want_pulled = hit_counts(chunks[s], H)
            got_hot = np.concatenate([m[key + "hot_rows"] for m in hot])
            got_pulled = np.concatenate([m[key + "pulled_rows"]
                                         for m in hot])
            if not (np.array_equal(got_hot, want_hot)
                    and np.array_equal(got_pulled, want_pulled)):
                raise AssertionError(f"{arm}: hot_rows / pulled_rows differ "
                                     "from numpy's counts")
            summary["hit_rate"] = float(got_hot.sum() / got_pulled.sum())
        if H:
            summary["delta_sq_mean"] = float(np.mean(np.concatenate(
                [m[key + "delta_sq"] for m in hot])))
        if C:
            dropped = sum(int(m[key + "cold_dropped"].sum()) for m in hot)
            if dropped:
                raise AssertionError(f"{arm}: cold_dropped {dropped} != 0")
            steps = summary["steps"]
            want = (2 if s is None else 1) * W * steps
            if summary["compact_cold_calls"] != want:
                raise AssertionError(
                    f"{arm}: compact_cold called {summary['compact_cold_calls']}"
                    f" times, expected {want}: a chunk did not certify")
            summary["cold_dropped"] = dropped
            summary["certified_chunks"] = len(chunks[s])
        finals[arm] = {k: v.numpy() for k, v in tables.items()}
        finals[arm]["local"] = local.numpy()
        out[arm] = summary
        log(f"phase 9, {arm}: {summary['steady_ms_per_step']:.3f} ms a step "
            f"(steady), {summary['examples_per_s']:.0f} examples/s, launches "
            f"a position a step {summary['launches_per_position_per_step']},"
            f" exchanges a step {summary['exchanges_per_step']} "
            f"({summary['exchange_bytes_per_step']} bytes), hit rate "
            f"{summary.get('hit_rate')}, cold_dropped "
            f"{summary.get('cold_dropped')}, delta_sq "
            f"{summary.get('delta_sq_mean')} ({card})")
    a, b = finals["head"], finals["head_compact"]
    if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k])
                                         for k in a):
        raise AssertionError("head_compact's tables differ from head's")
    log("phase 9: head_compact's tables, replica and local state equal "
        "head's bit for bit")
    return out


def tier_logreg(torch, fps, kernels, lr_data, card):
    """Phase 9 (b): SSP logistic regression as phase 4 runs it at (1, 4)
    with a hot head of 2,048 and windows of 8, one epoch of phase 4's
    data: K5 and K4 on the replica and its buffer."""
    import dataclasses

    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    D, S = TIER_LR_MESH
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                           dense_features=LR_DENSE)
    trainer, store = fps.logistic_regression(mesh, cfg, sync_every=8)
    store.specs["weights"] = dataclasses.replace(store.specs["weights"],
                                                 hot_tier=TIER_LR_H)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_LR_E)
    chunks = list(multi_epoch_chunks(
        lr_data, 1, num_workers=D * S, local_batch=SPARSE_BATCH // (D * S),
        steps_per_chunk=16, sync_every=8, seed=1))
    summary, _, _, _ = tier_run(
        torch, kernels, f"logreg SSP SGD, dense head, hot tier, mesh {D}x{S}",
        trainer, store, chunks, "weights", card,
        per_step={"gather_rows_dim1": 1, "scatter_add_dim1": 2},
        reconcile_k="gather_rows_dim1", quality=below("logloss", 0.693))
    log(f"phase 9, logreg: {summary['steady_ms_per_step']:.3f} ms a step, "
        f"launches a position a step "
        f"{summary['launches_per_position_per_step']} ({card})")
    return summary


def tier_fold(torch, fps, kernels, card):
    """Phase 9 (c): arm ``on`` with an Adagrad hot fold for 4 chunks: the
    RMSE falls, the fold state is finite and sharded over the shard axis
    (``hot_fold_state_shape``; data replicas equal, shards distinct)."""
    from fps_tpu_torch.core.store import fold_key, hot_fold_state_shape
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    fold = fps.HotFold(kind="adagrad", lr=TIER_FOLD_LR)
    trainer, store = tier_mf(fps, mesh, TIER_NI, 0, False, None, fold=fold)
    data = ds.zipf_ratings(TIER_NU, TIER_NI,
                           W * TIER_LOCAL * TIER_SPC * TIER_FOLD_CHUNKS,
                           seed=1)
    chunks = tier_chunks(data, W, None)[:TIER_FOLD_CHUNKS]
    summary, tables, _, _ = tier_run(
        torch, kernels, f"MF tiered on, Adagrad hot fold, mesh {D}x{S}",
        trainer, store, chunks, ITEM, card,
        per_step={"gather_rows": 2, "scatter_add": 2},
        reconcile_k="gather_rows", quality=falling_rmse)
    state = tables[fold_key(ITEM)]
    rows, cols = hot_fold_state_shape(fold, TIER_NI, TIER_RANK, S)
    if (state.numpy().shape != (rows, cols)
            or any(b.shape != (rows // S, cols) for b in state)
            or not all(torch.equal(state[p], state[p % S])
                       for p in range(W))
            or torch.equal(state[0], state[1])
            or not bool(torch.isfinite(torch.cat(list(state))).all())):
        raise AssertionError("the hot fold's state is not finite and "
                             "sharded over the shard axis")
    summary["fold_state"] = {"shape": [rows, cols], "block": [rows // S,
                                                              cols],
                             "finite": True, "sharded": True}
    log(f"phase 9, hot fold: {json.dumps(summary['quality'])}, state "
        f"{summary['fold_state']} ({card})")
    return summary


def tier_card_vs_cpu(torch, fps):
    """Phase 9 (d): small tiered jobs at (2, 4) on the card and on the CPU
    from the same tables and seeds: MF ``head_compact`` sync and SSP,
    logistic regression with a partial head, Adagrad and Adam hot folds,
    and the max combine; the largest difference of every table, replica,
    fold state and the local state, relative to max(1, the largest
    value)."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks, per_worker_cold_counts
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mf = ds.zipf_ratings(300, 200, W * 64 * 4 * 3, seed=2)
    lr = ds.synthetic_sparse_classification(W * 64 * 4 * 3, 2000, 8, seed=4,
                                            noise=0.05)
    lr["label"] = (lr["label"] > 0).astype(np.float32)

    def mf_job(sync_every):
        chunks = list(epoch_chunks(mf, num_workers=W, local_batch=64,
                                   steps_per_chunk=4, route_key="user",
                                   sync_every=sync_every, seed=5))
        lane = max(int(per_worker_cold_counts(c["item"], W,
                                              hot_head=100).max())
                   for c in chunks)

        def make(mesh):
            trainer, store = fps.online_mf(mesh, fps.MFConfig(
                num_users=300, num_items=200, rank=RANK, learning_rate=0.1),
                combine="mean", sync_every=sync_every)
            store.specs[ITEM] = dataclasses.replace(
                store.specs[ITEM], hot_tier=100, cold_budget=lane,
                dense_collectives=False)
            trainer.config = dataclasses.replace(trainer.config,
                                                 hot_sync_every=3)
            return trainer
        return make, chunks

    def lr_job(H, combine="sum", fold=None):
        chunks = list(epoch_chunks(lr, num_workers=W, local_batch=64,
                                   steps_per_chunk=4, seed=3))

        def make(mesh):
            trainer, store = fps.logistic_regression(mesh, fps.LogRegConfig(
                num_features=2000, learning_rate=0.5))
            store.specs["weights"] = dataclasses.replace(
                store.specs["weights"], hot_tier=H)
            trainer.config = dataclasses.replace(trainer.config,
                                                 hot_sync_every=3)
            trainer.server_logic["weights"] = dataclasses.replace(
                trainer.server_logic["weights"], combine=combine,
                hot_fold=fold)
            return trainer
        return make, chunks

    jobs = {"MF head_compact sync": mf_job(None),
            "MF head_compact SSP": mf_job(2),
            "logreg partial head": lr_job(512),
            "logreg Adagrad hot fold": lr_job(2000, fold="adagrad"),
            "logreg Adam hot fold": lr_job(2000, fold=fps.HotFold(
                kind="adam", lr=0.01)),
            "logreg max combine": lr_job(2000, combine="max")}
    worst = {}
    for job, (make, chunks) in jobs.items():
        runs, state0 = {}, None
        for device in ("cpu", "cuda:0"):
            trainer = make(fps.make_ps_mesh(S, D, device=device))
            if state0 is None:
                state0 = trainer.init_state(7)
            tables, local, _ = trainer.fit_stream(
                on_device(torch, state0[0], device),
                on_device(torch, state0[1], device), chunks, 2)
            runs[device] = dict(on_host(torch, tables))
            if not isinstance(local, tuple):
                runs[device]["local_state"] = on_host(torch, local)
        if sorted(runs["cpu"]) != sorted(runs["cuda:0"]):
            raise AssertionError(f"card vs CPU, {job}: entries differ")
        worst[job] = max(
            float((want - runs["cuda:0"][k]).abs().max())
            / max(1.0, float(want.abs().max()))
            for k, want in runs["cpu"].items())
    log("phase 9, card vs CPU: " + json.dumps(worst))
    for job, diff in worst.items():
        if not diff <= 1e-5:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 "value > 1e-5")
    return worst


# bench.py run_megastep_ab (:1678-1800) at its own widths: phase 9's MF
# (4,096 users and items, rank 16, lr 0.05, the mean combine, a (2, 4) mesh)
# with the item table's head of 2,048 on the gathered route and lanes of 8,
# windows of 4, local batch 32, calls of 2 steps (max_steps_per_call), K = 16
# chunks a dispatch, Zipf(1.05) ratings (seed 0) in a DeviceEpochPlan routed
# by user (seed 5), 1 epoch. Cut to depth only: 32 chunks' worth of
# ratings of the bench's 768, one of its epochs. The turns: A (run_indexed), B (run_megastep, K = 16),
# B, A; then "auto" (chunks_per_dispatch="auto") and "tick" (a
# MegastepTick re-ranking every 2 segments, K = 16) twice. Each arm is
# warmed up on throwaway state (one epoch) before its first turn.
MEGA_LOCAL, MEGA_SPC, MEGA_CHUNKS, MEGA_BENCH_CHUNKS = 32, 2, 32, 768
MEGA_K, MEGA_C, MEGA_EPOCHS, MEGA_CHECK = 16, 8, 1, 2
MEGA_TURNS = ("A", "B", "B", "A", "auto", "tick", "tick")
# The card-against-CPU tick job: tests/test_torch_megastep.py's size (57
# users, 31 items, rank 4, a mapped head of 16, windows of 2, calls of 4
# steps, local batch 8, lanes of 8) on its drifting stream, K = 2, a tick
# at every segment.
MEGA_CPU = dict(nu=57, ni=31, rank=4, H=16, E=2, T=4, B=8, C=8, n=1200)


def mega_mf(fps, mesh, data, H, C, E, *, nu, ni, rank, lr, local, spc):
    """run_megastep_ab's trainer and plan: MF with the item table's head on
    the gathered route, lanes of ``C``, windows of ``E``, calls of ``spc``
    steps."""
    import dataclasses

    trainer, store = fps.online_mf(mesh, fps.MFConfig(
        num_users=nu, num_items=ni, rank=rank, learning_rate=lr),
        combine="mean", max_steps_per_call=spc)
    store.specs[ITEM] = dataclasses.replace(
        store.specs[ITEM], hot_tier=H, cold_budget=C,
        dense_collectives=False)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E)
    plan = fps.DeviceEpochPlan(fps.DeviceDataset(mesh, data),
                               num_workers=mesh.shape["data"]
                               * mesh.shape["shard"], local_batch=local,
                               route_key="user", seed=5)
    return trainer, store, plan


def mega_strip(tree):
    """A metrics tree without the megastep's ``cold_dropped`` leaves
    (``run_indexed`` never packs its lanes)."""
    if not isinstance(tree, dict):
        return tree
    return {k: mega_strip(v) for k, v in tree.items() if k != "cold_dropped"}


def mega_flat(metrics):
    """One run's metrics (a list of trees) as flat arrays joined along the
    step axis."""
    parts = [flat_metrics(m) for m in metrics]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def mega_arm(torch, fps, kernels, mesh, data, turn, card, warm):
    """One turn of phase 9's megastep arms from fresh state (after one
    warm-up epoch on throwaway state when ``warm``), the launch counters at
    0 just before and read just after, the synchronising calls counted
    (``SyncCount``), the lanes' packing counted (``ExchangeSpy``). The
    ``auto`` arm's calibration window is timed and counted apart: its
    launches and packing are taken out of the run's (its seconds are
    not)."""
    from fps_tpu_torch.core import autok
    from fps_tpu_torch.tiering import MegastepTick

    trainer, store, plan = mega_mf(
        fps, mesh, data, TIER_H, MEGA_C, TIER_E, nu=TIER_NU, ni=TIER_NI,
        rank=TIER_RANK, lr=TIER_LR, local=MEGA_LOCAL, spc=MEGA_SPC)

    def go(tables, local, seed, epochs, rec=None):
        if turn == "A":
            return trainer.run_indexed(tables, local, plan, seed,
                                       epochs=epochs, recorder=rec)
        tick = None
        if turn == "tick":
            tick = MegastepTick(check_every=MEGA_CHECK, churn_threshold=-1.0)
            trainer.retierer = None
        return trainer.run_megastep(
            tables, local, plan, seed, epochs=epochs,
            chunks_per_dispatch="auto" if turn == "auto" else MEGA_K,
            tick=tick, recorder=rec)

    if warm:
        tables, local = trainer.init_state(7)
        go(tables, local, 9, 1)
    calibrated, spies = [], []
    real = autok.calibrate_chunks_per_dispatch

    def calibrate(*a, **k):
        # The calibration window's dispatches (on copies of the state) are
        # counted apart from the run's.
        torch.cuda.synchronize()
        before, packed = kernels.launch_counts(), spies[0].compact
        t0 = time.perf_counter()
        calibrated.append(real(*a, **k))
        torch.cuda.synchronize()
        calibrated.append({
            "seconds": time.perf_counter() - t0,
            "launches": {n: v - before[n]
                         for n, v in kernels.launch_counts().items()},
            "compact_cold_calls": spies[0].compact - packed})
        return calibrated[0]

    autok.calibrate_chunks_per_dispatch = calibrate
    rec = fps.obs.Recorder(sinks=[])
    tables, local = trainer.init_state(0)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with ExchangeSpy() as spy, SyncCount(torch) as syncs:
            spies.append(spy)
            t0 = time.perf_counter()
            tables, local, metrics = go(tables, local, 1, MEGA_EPOCHS, rec)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        autok.calibrate_chunks_per_dispatch = real
    launched = kernels.launch_counts()
    packed = spy.compact
    if calibrated:
        launched = {n: v - calibrated[1]["launches"][n]
                    for n, v in launched.items()}
        packed -= calibrated[1]["compact_cold_calls"]
    T_call = trainer._indexed_call_steps(plan)
    n_calls = plan.calls_per_epoch(T_call)
    steps = MEGA_EPOCHS * plan.steps_per_epoch
    W = len(mesh.local)
    K = 1 if turn == "A" else int(
        rec.snapshot()["gauges"]["megastep.chunks_per_dispatch"])
    dispatches = MEGA_EPOCHS * (n_calls if turn == "A"
                                else -(-n_calls // K))
    summary = {
        "path": f"MF megastep arm {turn}, mesh 2x4", "turn": turn,
        "seconds": seconds, "steps": steps,
        "ms_per_step": seconds / steps * 1e3,
        "examples": float(sum(m["n"].sum() for m in metrics)),
        "launches": launched,
        "launches_per_position_per_step": {
            k: v / (W * steps) for k, v in launched.items() if v},
        "chunks_per_dispatch": K, "dispatches": dispatches,
        "chunk_calls": MEGA_EPOCHS * n_calls,
        "host_syncs": syncs.calls, "host_sync_sites": syncs.sites,
        "host_syncs_per_dispatch": syncs.calls / dispatches,
        "compact_cold_calls": packed,
        "counters": {k: rec.counter_value(k) for k in (
            "cold_route.vote_compact_windows",
            "cold_route.vote_overflow_windows", "megastep.windows")},
        "card": card}
    if calibrated:
        summary["calibration"] = dict(
            calibrated[1], chosen_k=calibrated[0][0],
            overhead_s=calibrated[0][1], per_chunk_s=calibrated[0][2])
        summary["ms_per_step_without_calibration"] = (
            seconds - calibrated[1]["seconds"]) / steps * 1e3
    if turn == "tick":
        summary["re_ranks"] = rec.counter_value("tiering.re_ranks",
                                                table=ITEM)
    state = {k: v.numpy() for k, v in tables.items()}
    state["local"] = local.numpy()
    return summary, state, mega_flat([mega_strip(m) for m in metrics]), \
        trainer, store


def mega_same(label, a, b):
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: the entries differ: {sorted(a)} vs "
                             f"{sorted(b)}")
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{label}: {k} differs")


def mega_launch_check(summary, W):
    """The launches the code gives a run of the arms: a position a step K1
    3 (the user row, the replica, the cold route) and one more in a step of
    a certified segment (the lane's rows back to the batch: ``compact_cold``
    runs twice a worker a certified step), K2 3 (the user push, the cold
    push, the buffer), and K1 once a position a call (the reconcile's owned
    rows); the tick adds K4 1 a position a step (the tracker's window), K2
    once a position a reconcile (the mapped reconcile's owned rows, in
    place of K1) and K1 once a position a tick (the re-split) and once at
    the run's entry (the mapped replica's derivation)."""
    steps, calls = summary["steps"], summary["chunk_calls"]
    lanes = summary["compact_cold_calls"] // 2
    got = summary["launches"]
    if summary["turn"] == "tick":
        ticks = summary["ticks"]
        want = {"gather_rows": W * (3 * steps + ticks + 1) + lanes,
                "scatter_add": W * (3 * steps + calls),
                "scatter_add_dim1": W * steps}
    else:
        want = {"gather_rows": W * (3 * steps + calls) + lanes,
                "scatter_add": W * 3 * steps}
    for k, v in got.items():
        if v != want.get(k, 0):
            raise AssertionError(
                f"{summary['path']}: {k} launched {v} times, expected "
                f"{want.get(k, 0)} ({steps} steps, {calls} calls, {lanes} "
                f"certified worker-steps, {W} positions)")


def tier_megastep(torch, fps, kernels, card):
    """Phase 9 (e): bench.py run_megastep_ab's arms in turns (A
    ``run_indexed``, B ``run_megastep`` K = 16, B, A, ``"auto"``, a tick
    every 2 segments twice), every position on ``cuda:0``. Gates: every
    megastep arm's tables, replica, local state and metrics equal
    ``run_indexed``'s bit for bit (the tick arm's its own second run's);
    the vote counters sum to the real windows; the tick re-ranks, its
    replica is the canonical rows of the final hot ids and its slot map
    their order; each run's launches are what the code gives."""
    from fps_tpu_torch.core.store import hot_key, ids_key, map_key
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    data = ds.zipf_ratings(TIER_NU, TIER_NI,
                           W * MEGA_LOCAL * MEGA_SPC * MEGA_CHUNKS, seed=0)
    arms, states, metrics = [], {}, {}
    warmed = set()
    for turn in MEGA_TURNS:
        summary, state, flat, trainer, store = mega_arm(
            torch, fps, kernels, mesh, data, turn, card, turn not in warmed)
        warmed.add(turn)
        windows = summary["chunk_calls"]
        c = summary["counters"]
        if turn != "A":
            if not (c["megastep.windows"] == windows == c[
                    "cold_route.vote_compact_windows"]
                    + c["cold_route.vote_overflow_windows"]):
                raise AssertionError(
                    f"arm {turn}: vote counters {c} against {windows} real "
                    "windows")
        if turn == "tick":
            if summary["re_ranks"] < 1:
                raise AssertionError("the tick arm did not re-rank")
            gids = store.tables[ids_key(ITEM)].numpy()
            if not np.array_equal(store.tables[hot_key(ITEM)].numpy(),
                                  store.lookup_host(ITEM, gids)):
                raise AssertionError("the tick arm's replica is not the "
                                     "canonical rows of its hot ids")
            smap = store.tables[map_key(ITEM)].numpy()
            if not np.array_equal(smap[gids], np.arange(len(gids))):
                raise AssertionError("the tick arm's slot map is not its "
                                     "hot ids' order")
            summary["ticks"] = trainer.retierer.tick
            summary["hot_ids_changed"] = int(
                np.setdiff1d(gids, np.arange(TIER_H)).size)
        mega_launch_check(summary, W)
        if turn in states:
            mega_same(f"arm {turn}, two turns", states[turn], state)
            mega_same(f"arm {turn} metrics, two turns", metrics[turn], flat)
        states.setdefault(turn, state)
        metrics.setdefault(turn, flat)
        arms.append(summary)
        log(f"phase 9, megastep arm {turn}: {summary['ms_per_step']:.3f} ms "
            f"a step, K {summary['chunks_per_dispatch']}, "
            f"{summary['dispatches']} dispatches, launches a position a "
            f"step {summary['launches_per_position_per_step']}, "
            f"synchronising calls {summary['host_syncs']} "
            f"({summary['host_syncs_per_dispatch']:.2f} a dispatch; "
            f"{summary['host_sync_sites']}), vote {c}, calibration "
            f"{summary.get('calibration')} ({card})")
    for turn in ("B", "auto"):
        mega_same(f"arm {turn} against run_indexed", states["A"],
                  states[turn])
        mega_same(f"arm {turn} metrics against run_indexed", metrics["A"],
                  metrics[turn])
    log("phase 9: the megastep arms (K = 16 and auto) equal run_indexed bit "
        "for bit; the tick arm's two runs equal each other")
    by = {}
    for a in arms:
        by.setdefault(a["turn"], []).append(a["ms_per_step"])
        if "ms_per_step_without_calibration" in a:
            by.setdefault("auto without calibration", []).append(
                a["ms_per_step_without_calibration"])
    readings = {t: {"median": float(np.median(v)), "min": min(v),
                    "max": max(v), "turns": v} for t, v in by.items()}
    auto = next(a for a in arms if a["turn"] == "auto")
    return {"arms": arms, "ms_per_step": readings,
            "calibration": auto.get("calibration"),
            "cut": {"chunks": MEGA_CHUNKS, "of_bench": MEGA_BENCH_CHUNKS,
                    "epochs": MEGA_EPOCHS}}


def megastep_card_vs_cpu(torch, fps):
    """Phase 9 (f): the CPU test's tick job (``MEGA_CPU``) on the card and
    on the CPU from the same tables: the same hot ids, and every table
    within 1e-5 of max(1, its largest value)."""
    from fps_tpu_torch.tiering import MegastepTick

    cfg = MEGA_CPU
    rng = np.random.default_rng(0)
    n = cfg["n"]
    item = np.where(rng.random(n) < 0.9, rng.integers(15, cfg["ni"], n),
                    rng.integers(0, 15, n)).astype(np.int32)
    data = {"user": rng.integers(0, cfg["nu"], n).astype(np.int32),
            "item": item, "rating": rng.normal(size=n).astype(np.float32)}
    D, S = TIER_MESH
    runs, state0 = {}, None
    for device in ("cpu", "cuda:0"):
        mesh = fps.make_ps_mesh(S, D, device=device)
        trainer, _, plan = mega_mf(
            fps, mesh, data, cfg["H"], cfg["C"], cfg["E"], nu=cfg["nu"],
            ni=cfg["ni"], rank=cfg["rank"], lr=0.1, local=cfg["B"],
            spc=cfg["T"])
        if state0 is None:
            state0 = trainer.init_state(0)
        tick = MegastepTick(check_every=1, churn_threshold=-1.0)
        tables, local, _ = trainer.run_megastep(
            on_device(torch, state0[0], device),
            on_device(torch, state0[1], device), plan, 1, epochs=2,
            chunks_per_dispatch=2, tick=tick)
        runs[device] = (dict(on_host(torch, tables)),
                        tick.hot_ids[ITEM].copy())
        runs[device][0]["local_state"] = on_host(torch, local)
    cpu, card = runs["cpu"], runs["cuda:0"]
    if not np.array_equal(cpu[1], card[1]):
        raise AssertionError(f"megastep card vs CPU: hot ids {card[1]} "
                             f"against {cpu[1]}")
    worst = max(float((want - card[0][k]).abs().max())
                / max(1.0, float(want.abs().max()))
                for k, want in cpu[0].items()
                if want.dtype.is_floating_point)
    log(f"phase 9, megastep card vs CPU: hot ids equal, worst {worst}")
    if not worst <= 1e-5:
        raise AssertionError(f"megastep card vs CPU: {worst} of the largest "
                             "value > 1e-5")
    for k, want in cpu[0].items():
        if not want.dtype.is_floating_point and not torch.equal(
                want, card[0][k]):
            raise AssertionError(f"megastep card vs CPU: {k} differs")
    return {"worst": worst, "hot_ids": cpu[1].tolist()}


def tier_phase(torch, fps, kernels, lr_data, card):
    """Phase 9: the static hot tier on the card, every position on
    ``cuda:0``, every launch counter at 0 just before each run and read
    just after; then the megastep's arms on its tiered MF."""
    t0 = time.perf_counter()
    arms = tier_arms(torch, fps, kernels, card)
    logreg = tier_logreg(torch, fps, kernels, lr_data, card)
    fold = tier_fold(torch, fps, kernels, card)
    worst = tier_card_vs_cpu(torch, fps)
    t_mega = time.perf_counter()
    mega = tier_megastep(torch, fps, kernels, card)
    mega["card_vs_cpu"] = megastep_card_vs_cpu(torch, fps)
    now = time.perf_counter()
    mega["seconds"] = now - t_mega
    seconds = now - t0
    log(f"phase 9 done in {seconds:.1f} s (the megastep arms "
        f"{mega['seconds']:.1f} s)")
    return {"runs": list(arms.values()) + [logreg, fold] + mega["arms"],
            "arms": arms, "card_vs_cpu": worst,
            "megastep": {k: v for k, v in mega.items() if k != "arms"},
            "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# Phase 10: the adaptive tier (Trainer.retierer, TrainerConfig.auto_tier).
# ---------------------------------------------------------------------------

# bench.py run_tiered_drift (:1182-1370) at its own widths: phase 9's MF (4,096
# users and items, rank 16, lr 0.05, the mean combine, windows of 4, local
# batch 1,024, chunks of 8 steps, a (2, 4) mesh) on its drifting stream
# (_drifting_zipf_ratings: Zipf(1.2) items whose ranking rotates at chunk 6
# of 12, seed 0, chunked in stream order); every arm warmed up on 6 chunks
# from fresh state before its run, as the bench does; the stale head 512.
DRIFT_CHUNKS, DRIFT_WARM, DRIFT_H = 12, 6, 512
# The recovery pair's retierer, the bench's: a check every 2 chunks, a
# re-rank past a churn of 0.1.
DRIFT_CHECK, DRIFT_CHURN = 2, 0.1
# Each arm's launches a position a step (K1, K2, K4) and the kernel each
# reconcile launches once a position, read from the port's code: the user
# factors' gather and scatter in every arm; oracle (the whole item table
# replicated): the replica's gather, the buffer's scatter, the reconcile's
# gather of the owned head rows (K1); stale: also the cold route's gather
# and the cold push; the mapped head (the recovery arm with its retierer):
# stale's, the tracker's window (K4), and the reconcile's scatter into the
# owned rows of the hot ids (K2). A re-rank's re-split gathers once a
# position (K1), at the boundary.
DRIFT_LAUNCHES = {
    "oracle": ({"gather_rows": 2, "scatter_add": 2}, "gather_rows"),
    "stale": ({"gather_rows": 3, "scatter_add": 3}, "gather_rows"),
    "mapped": ({"gather_rows": 3, "scatter_add": 3, "scatter_add_dim1": 1},
               "scatter_add")}
# The card-against-CPU jobs: SSP-capable logistic regression at (2, 4) with
# a mapped head of 256 of 2,000 features, re-ranked at every chunk.
DRIFT_CPU_NF, DRIFT_CPU_H = 2000, 256


def drift_data(W, chunks):
    from fps_tpu_torch.utils import datasets as ds

    return ds.drifting_zipf_ratings(TIER_NU, TIER_NI,
                                    W * TIER_LOCAL * TIER_SPC * chunks,
                                    alpha=1.2, seed=0)


def drift_chunks(data, W):
    """The stream in its order (``seed=None``): the drift is the
    workload."""
    from fps_tpu_torch.core.ingest import epoch_chunks

    return list(epoch_chunks(data, num_workers=W, local_batch=TIER_LOCAL,
                             steps_per_chunk=TIER_SPC, route_key="user",
                             seed=None))


def drift_mf(fps, mesh, arm):
    """``run_tiered_drift``'s MF trainer for ``arm``: ``oracle`` (the whole
    item table replicated), ``stale`` (the head 512), ``adaptive``
    (``auto_tier``), ``recovery`` (the head 512 with the bench's
    retierer) and ``identity`` (the head 512 with a retierer that never
    checks: the mapped tier on the identity ranking)."""
    import dataclasses

    from fps_tpu_torch.tiering import Retierer

    cfg = fps.MFConfig(num_users=TIER_NU, num_items=TIER_NI, rank=TIER_RANK,
                       learning_rate=TIER_LR)
    trainer, store = fps.online_mf(mesh, cfg, combine="mean")
    if arm == "adaptive":
        trainer.config = dataclasses.replace(trainer.config, auto_tier=True)
        return trainer, store
    store.specs[ITEM] = dataclasses.replace(
        store.specs[ITEM], hot_tier=TIER_NI if arm == "oracle" else DRIFT_H)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E)
    if arm == "recovery":
        trainer.retierer = Retierer(check_every=DRIFT_CHECK,
                                    churn_threshold=DRIFT_CHURN)
    elif arm == "identity":
        trainer.retierer = Retierer(check_every=1 << 30)
    return trainer, store


def current_hot_ids(trainer, name):
    """The ids the replica of ``name`` holds: the retierer's set on the
    mapped tier, the static head ``[0, H)`` otherwise."""
    H = trainer._hot_tier_map()[name]
    if name in trainer._mapped_tables():
        return trainer.retierer.hot_ids_for(name, H)
    return np.arange(H)


def replica_check(torch, trainer, name):
    """After a call: every position's replica equals the canonical rows of
    the current hot ids, bit for bit."""
    store = trainer.store
    rep = store.tables[f"{name}::hot"]
    for r in rep[1:]:
        if not torch.equal(r, rep[0]):
            raise AssertionError(f"{name}: the replicas differ")
    want = store.lookup_host(name, current_hot_ids(trainer, name))
    if not np.array_equal(rep[0].cpu().numpy(), want):
        raise AssertionError(f"{name}: the replica differs from the "
                             "canonical rows of the current hot ids")


def drift_fit(torch, kernels, trainer, chunks, *, tables=None, local=None,
              start=0, seed=1):
    """``fit_stream`` over ``chunks`` (from fresh state unless given), the
    launch counters at 0 just before: each chunk's launches apart (a
    retierer's boundary after it not among them), the exchanges counted by
    an :class:`ExchangeSpy`, the replica checked against the canonical rows
    of the current hot ids after every chunk, the seconds less the checks.
    Returns ``(tables, local, metrics, per_chunk, seconds, spy)``."""
    if tables is None:
        tables, local = trainer.init_state(0)
    tables = trainer._attach_hot(tables)  # not timed, not counted
    per_chunk, mark, checks = [], [{}], [0.0]
    rt = trainer.retierer
    if rt is not None:
        def boundary(tr, tb, i, **k):
            out = type(rt).on_boundary(rt, tr, tb, i, **k)
            mark[0] = kernels.launch_counts()
            return out
        rt.on_boundary = boundary

    def on_chunk(i, m):
        now = time.perf_counter()
        counts = kernels.launch_counts()
        per_chunk.append({k: v - mark[0].get(k, 0) for k, v in counts.items()
                          if v - mark[0].get(k, 0)})
        mark[0] = counts
        if trainer._hot_tier_map():
            replica_check(torch, trainer, ITEM)
        checks[0] += time.perf_counter() - now

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        with ExchangeSpy() as spy:
            t0 = time.perf_counter()
            tables, local, metrics = trainer.fit_stream(
                tables, local, chunks, seed, start_step=start,
                on_chunk=on_chunk)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0 - checks[0]
    finally:
        if rt is not None:
            del rt.on_boundary  # the class's method again
    return tables, local, metrics, per_chunk, seconds, spy


def hit_rate(metrics):
    hot = sum(float(m["hot_tier"][ITEM]["hot_rows"].sum()) for m in metrics)
    pulled = sum(float(m["hot_tier"][ITEM]["pulled_rows"].sum())
                 for m in metrics)
    return hot / pulled


def drift_launch_check(label, per_chunk, kind, W, E):
    """Every chunk of 8 steps launches what the code gives: ``kind``'s
    launches a position a step, and its reconcile kernel once a position
    for each of the chunk's windows of ``E`` steps."""
    per_step, rk = DRIFT_LAUNCHES[kind]
    want = {k: v * W * TIER_SPC for k, v in per_step.items()}
    want[rk] = want.get(rk, 0) + W * -(-TIER_SPC // E)
    for i, got in enumerate(per_chunk):
        if got != want:
            raise AssertionError(f"{label}: chunk {i} launched {got}, "
                                 f"expected {want} ({kind}: {per_step} a "
                                 f"position a step, {rk} once a position "
                                 "a reconcile)")
    return want


def falling_by_half(metrics):
    """The drifting stream's learning check: the rotation at chunk 6 lifts
    the train RMSE (its hot items are new), so it is held within each half
    of the stream: the RMSE over the later chunks of a half (pooled by
    examples) must lie below that over its earlier ones. (Pooled, because
    the stream's last chunk is ragged: a few examples, a noisy RMSE.)"""
    half = DRIFT_CHUNKS // 2
    out = {}
    for name, part in (("before", metrics[:half]), ("after", metrics[half:])):
        k = len(part) // 2
        early, late = (float(np.sqrt(
            sum(m["se"].sum() for m in ms)
            / max(1.0, sum(m["n"].sum() for m in ms))))
            for ms in (part[:k], part[k:]))
        if not np.isfinite([early, late]).all() or not late < early:
            raise AssertionError(
                f"train RMSE {name} the rotation: {late} over its later "
                f"chunks is not below {early} over its earlier ones")
        out[name] = {"earlier_chunks": early, "later_chunks": late}
    return {"train_rmse_within_each_half": out}


def drift_summary(kernels, label, trainer, metrics, per_chunk, seconds, spy,
                  card, quality=falling_by_half):
    steps = TIER_SPC * len(per_chunk)
    W = len(trainer.mesh.local)
    n = float(sum(m["n"].sum() for m in metrics))
    launched = {}
    for c in per_chunk:
        for k, v in c.items():
            launched[k] = launched.get(k, 0) + v
    return {
        "path": label, "chunks": len(per_chunk), "steps": steps,
        "examples": n, "seconds": seconds, "examples_per_s": n / seconds,
        "ms_per_step": seconds / steps * 1e3,
        "launches": {k: launched.get(k, 0) for k in kernels.WRAPPERS},
        "launches_per_position_per_step": {
            k: v / (W * steps) for k, v in launched.items()},
        "exchanges_per_step": {k: v / steps for k, v in spy.calls.items()},
        "exchange_bytes_per_step": {k: v / steps
                                    for k, v in spy.bytes.items()},
        "train_rmse": float(np.sqrt(
            sum(m["se"].sum() for m in metrics) / max(n, 1.0))),
        "quality": quality(metrics), "hit_rate": hit_rate(metrics),
        "mesh": dict(trainer.mesh.shape), "card": card}


def drift_arms(torch, fps, kernels, mesh, chunks, card):
    """Phase 10 (a): ``run_tiered_drift``'s three arms, each from fresh
    state after its warm-up: oracle, stale and adaptive (``auto_tier``,
    whose plan lands in the warm-up)."""
    from itertools import islice

    W = len(mesh.local)
    out, finals = {}, {}
    for arm in ("oracle", "stale", "adaptive"):
        trainer, store = drift_mf(fps, mesh, arm)
        tables, local = trainer.init_state(0)
        trainer.fit_stream(tables, local, islice(iter(chunks), DRIFT_WARM), 9)
        if arm == "adaptive":
            rt = trainer.retierer
            if not rt.planned or ITEM not in trainer._hot_tier_map():
                raise AssertionError(f"adaptive: no plan tiered {ITEM} in "
                                     f"the warm-up ({rt.plans})")
        tables, local, metrics, per_chunk, seconds, spy = drift_fit(
            torch, kernels, trainer, chunks)
        kind = arm if arm != "adaptive" else (
            "mapped" if trainer._mapped_tables() else
            "oracle" if trainer._hot_tier_map()[ITEM] == TIER_NI
            else "stale")
        want = drift_launch_check(f"phase 10 {arm}", per_chunk, kind, W,
                                  trainer.config.hot_sync_every)
        summary = drift_summary(
            kernels, f"MF drifting Zipf, {arm}, mesh {TIER_MESH[0]}x"
            f"{TIER_MESH[1]}, fit_stream", trainer, metrics, per_chunk,
            seconds, spy, card)
        summary.update(arm=arm, launches_per_chunk=want,
                       hot_sync_every=trainer.config.hot_sync_every,
                       hot_tier=trainer._hot_tier_map()[ITEM])
        if arm == "adaptive":
            summary["planned"] = {n: p.to_json()
                                  for n, p in sorted(rt.plans.items())}
            summary["retierer"] = {"checks": rt.checks,
                                   "re_ranks": rt.re_ranks}
        check_finite(torch, arm, tables, local)
        finals[arm] = (tables, local, metrics)
        out[arm] = summary
        log(f"phase 10, {arm}: {summary['ms_per_step']:.3f} ms a step, "
            f"{summary['examples_per_s']:.0f} examples/s, train RMSE "
            f"{summary['train_rmse']:.4f}, launches a position a step "
            f"{summary['launches_per_position_per_step']}, hit rate "
            f"{summary['hit_rate']:.4f}, exchanges a step "
            f"{summary['exchanges_per_step']} "
            f"({summary['exchange_bytes_per_step']} bytes)"
            + (f", plan {summary['planned']}" if arm == "adaptive" else "")
            + f" ({card})")
    return out, finals


def drift_recovery(torch, fps, kernels, mesh, chunks, card):
    """Phase 10 (b): the recovery pair, the head 512 with and without the
    bench's retierer, through both halves of the stream (``fit_stream``
    each, the second from where the first ended): the hit rate before and
    after the rotation, the re-ranks, every chunk's launches the same
    across the re-ranks."""
    W = len(mesh.local)
    half = DRIFT_CHUNKS // 2
    out = {}
    for label in ("static", "adaptive"):
        trainer, store = drift_mf(fps, mesh, "stale" if label == "static"
                                  else "recovery")
        tables = local = None
        entry, runs, every = {}, [], []
        for phase, sl, start in (("phase1", chunks[:half], 0),
                                 ("phase2", chunks[half:], half)):
            tables, local, metrics, per_chunk, seconds, spy = drift_fit(
                torch, kernels, trainer, sl, tables=tables, local=local,
                start=start)
            drift_launch_check(f"phase 10 recovery {label} {phase}",
                               per_chunk, "stale" if label == "static"
                               else "mapped", W, TIER_E)
            # The RMSE is held over both halves (the rotation lifts it).
            runs.append(drift_summary(
                kernels, f"MF drifting Zipf, recovery {label} {phase}, mesh "
                f"{TIER_MESH[0]}x{TIER_MESH[1]}, fit_stream", trainer,
                metrics, per_chunk, seconds, spy, card,
                quality=lambda m: None))
            entry[f"hit_rate_{phase}"] = runs[-1]["hit_rate"]
            every += metrics
        entry["quality"] = falling_by_half(every)
        if label == "adaptive":
            entry["re_ranks"] = trainer.retierer.re_ranks
            entry["checks"] = trainer.retierer.checks
            entry["last_churn"] = trainer.retierer.last_churn
        entry["runs"] = runs
        check_finite(torch, f"recovery {label}", tables, local)
        out[label] = entry
    a, s = out["adaptive"], out["static"]
    if not a["re_ranks"] >= 1:
        raise AssertionError("phase 10 recovery: the retierer never "
                             "re-ranked")
    if not a["hit_rate_phase2"] > s["hit_rate_phase2"]:
        raise AssertionError(
            f"phase 10 recovery: the hit rate after the rotation "
            f"{a['hit_rate_phase2']} is not above the static head's "
            f"{s['hit_rate_phase2']}")
    log("phase 10, recovery: hit rate before / after the rotation, static "
        f"{s['hit_rate_phase1']:.4f} / {s['hit_rate_phase2']:.4f}, "
        f"adaptive {a['hit_rate_phase1']:.4f} / {a['hit_rate_phase2']:.4f} "
        f"with {a['re_ranks']} re-ranks; launches a chunk the same before "
        f"and after each ({card})")
    return out


def drift_identity(torch, fps, kernels, mesh, chunks, stale):
    """Phase 10 (c): the mapped tier on the identity ranking (a retierer
    that never checks) over the stale arm's chunks from the same state:
    its tables, replica, local state and metrics equal the static tier's
    bit for bit; and the window after one chunk equals a host count-min of
    the chunk's live pulled ids, bit for bit."""
    from fps_tpu_torch import sketch

    trainer, _ = drift_mf(fps, mesh, "identity")
    tables, local, metrics, _, _, _ = drift_fit(torch, kernels, trainer,
                                                chunks)
    s_tables, s_local, s_metrics = stale
    for k, v in s_tables.items():
        if not np.array_equal(tables[k].numpy(), v.numpy()):
            raise AssertionError(f"phase 10 identity: {k} differs from the "
                                 "static tier's")
    if not np.array_equal(local.numpy(), s_local.numpy()):
        raise AssertionError("phase 10 identity: the local state differs")
    for a, b in zip(metrics, s_metrics):
        if not np.array_equal(a["se"], b["se"]):
            raise AssertionError("phase 10 identity: the metrics differ")
    trainer, _ = drift_mf(fps, mesh, "identity")
    tables, _, _, _, _, _ = drift_fit(torch, kernels, trainer, chunks[:1])
    spec = trainer.retierer._table_cm(ITEM)
    host = sketch.cm_update(spec, sketch.cm_init(spec), torch.from_numpy(
        chunks[0]["item"].reshape(-1).astype(np.int32)))
    win = tables[f"{ITEM}::sketch"]
    for w in win:
        if not np.array_equal(w.cpu().numpy(), host.numpy()):
            raise AssertionError("phase 10: the device window differs from "
                                 "the host count-min of the chunk's ids")
    log("phase 10: the mapped tier on the identity ranking equals the "
        "static tier bit for bit; the window after one chunk equals the "
        "host count-min bit for bit")
    return {"identity_bit_equal_to_static": True,
            "window_bit_equal_to_host": True,
            "window_sum": float(host.sum())}


def drift_card_vs_cpu(torch, fps):
    """Phase 10 (d): logistic regression at (2, 4) with a mapped head of
    256 of 2,000 features re-ranked at every chunk (``churn_threshold =
    -1``), sync and SSP (s = 2), and MF with a mapped head and its lanes,
    on the card and on the CPU from the same tables and seeds: every
    table, replica, slot map, id array and window within 1e-5 of the
    largest value (the maps, ids and windows equal), the same hot ids."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.tiering import Retierer
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    lr = ds.synthetic_sparse_classification(W * 64 * 4 * 4, DRIFT_CPU_NF, 8,
                                            seed=4, noise=0.05)
    lr["label"] = (lr["label"] > 0).astype(np.float32)
    mf = ds.drifting_zipf_ratings(300, 200, W * 64 * 4 * 4, seed=2)

    def lr_job(sync_every):
        chunks = list(epoch_chunks(lr, num_workers=W, local_batch=64,
                                   steps_per_chunk=4, sync_every=sync_every,
                                   seed=3))

        def make(mesh):
            trainer, store = fps.logistic_regression(mesh, fps.LogRegConfig(
                num_features=DRIFT_CPU_NF, learning_rate=0.5),
                sync_every=sync_every)
            store.specs["weights"] = dataclasses.replace(
                store.specs["weights"], hot_tier=DRIFT_CPU_H)
            trainer.config = dataclasses.replace(trainer.config,
                                                 hot_sync_every=3)
            trainer.retierer = Retierer(check_every=1, churn_threshold=-1.0)
            return trainer, "weights", DRIFT_CPU_H
        return make, chunks

    def mf_job():
        chunks = list(epoch_chunks(mf, num_workers=W, local_batch=64,
                                   steps_per_chunk=4, route_key="user",
                                   seed=None))

        def make(mesh):
            trainer, store = fps.online_mf(mesh, fps.MFConfig(
                num_users=300, num_items=200, rank=RANK, learning_rate=0.1),
                combine="mean")
            store.specs[ITEM] = dataclasses.replace(
                store.specs[ITEM], hot_tier=40, cold_budget=56,
                dense_collectives=False)
            trainer.config = dataclasses.replace(trainer.config,
                                                 hot_sync_every=3)
            trainer.retierer = Retierer(check_every=1, churn_threshold=-1.0)
            return trainer, ITEM, 40
        return make, chunks

    jobs = {"logreg mapped head sync": lr_job(None),
            "logreg mapped head SSP": lr_job(2),
            "MF mapped head with lanes": mf_job()}
    worst, re_ranks = {}, {}
    for job, (make, chunks) in jobs.items():
        runs, ids, state0 = {}, {}, None
        for device in ("cpu", "cuda:0"):
            trainer, name, H = make(fps.make_ps_mesh(S, D, device=device))
            if state0 is None:
                state0 = trainer.init_state(7)
            tables, local, _ = trainer.fit_stream(
                on_device(torch, state0[0], device),
                on_device(torch, state0[1], device), chunks, 2)
            runs[device] = dict(on_host(torch, tables))
            if not isinstance(local, tuple):
                runs[device]["local_state"] = on_host(torch, local)
            ids[device] = trainer.retierer.hot_ids_for(name, H)
            re_ranks[job] = trainer.retierer.re_ranks
        cpu, card = runs["cpu"], runs["cuda:0"]
        if sorted(cpu) != sorted(card):
            raise AssertionError(f"card vs CPU, {job}: entries differ")
        if not np.array_equal(ids["cpu"], ids["cuda:0"]) or not re_ranks[job]:
            raise AssertionError(f"card vs CPU, {job}: the hot ids differ "
                                 "or nothing re-ranked")
        for k in cpu:
            if k.endswith(("::hotmap", "::hotids", "::sketch")) and not (
                    torch.equal(cpu[k], card[k])):
                raise AssertionError(f"card vs CPU, {job}: {k} differs")
        worst[job] = max(
            float((cpu[k].double() - card[k].double()).abs().max())
            / max(1.0, float(cpu[k].double().abs().max())) for k in cpu)
    log("phase 10, card vs CPU: " + json.dumps(worst)
        + f", re-ranks {json.dumps(re_ranks)}")
    for job, diff in worst.items():
        if not diff <= 1e-5:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 "value > 1e-5")
    return {"worst": worst, "re_ranks": re_ranks}


def adaptive_kernel_cases(torch, kernels, cases, dev):
    """Phase 3 at the adaptive tier's shapes, from phase 10's stream: the
    mapped head of 512 after the rotation (the top 512 items of the second
    half, ranked as the retierer ranks them), worker 0's first step after
    the rotation. K1 the slot-addressed replica pull (the 512 x 16 replica,
    the worker's 1,024 slots, cold slots -1) and the re-split's gather of
    shard 1's owned rows of the hot ids (its 1,024 x 16 block, 512 ids, -1
    where another shard owns the id); K2 the mapped reconcile's scatter
    into the same owned rows (128 of them, 512 x 16 steps); K4 the
    tracker's window (4 x 2,048 = 8,192 rows, the worker's 1,024 ids in
    each of the 4 rows: 4,096 pushes)."""
    from fps_tpu_torch import sketch
    from fps_tpu_torch.core.store import hot_slot_map
    from fps_tpu_torch.tiering import Retierer, top_ids

    rng = np.random.default_rng(13)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    D, S = TIER_MESH
    W = D * S
    chunks = drift_chunks(drift_data(W, DRIFT_CHUNKS), W)
    half = DRIFT_CHUNKS // 2
    later = np.concatenate([c["item"].reshape(-1) for c in chunks[half:]])
    hot = top_ids(np.bincount(later[later >= 0], minlength=TIER_NI
                              ).astype(np.float32), DRIFT_H)
    item = chunks[half]["item"][0, :TIER_LOCAL]
    slots = hot_slot_map(TIER_NI, hot)[np.where(item >= 0, item, TIER_NI)]
    cases["gather_rows"].append(check_gather(
        torch, kernels, f"K1 adaptive tier {DRIFT_H} x {TIER_RANK} replica, "
        f"{TIER_LOCAL} slots", kernels.gather_rows_cuda,
        kernels.gather_rows_plain,
        t(rng.normal(0, 0.1, (DRIFT_H, TIER_RANK)).astype(np.float32)),
        t(slots.astype(np.int32)), "adaptive",
        collect=cases["gather_inputs"]))
    rps = TIER_NI // S
    owned = np.where(hot % S == 1, hot // S, -1).astype(np.int32)
    cases["gather_rows"].append(check_gather(
        torch, kernels, f"K1 adaptive tier re-split, shard 1's {rps} x "
        f"{TIER_RANK} block, {DRIFT_H} ids", kernels.gather_rows_cuda,
        kernels.gather_rows_plain,
        t(rng.normal(0, 0.1, (rps, TIER_RANK)).astype(np.float32)),
        t(owned), "adaptive", collect=cases["gather_inputs"]))
    cases["scatter_add"].append(check_scatter(
        torch, f"K2 adaptive tier reconcile, shard 1's {rps} x {TIER_RANK} "
        f"block, {int((owned >= 0).sum())} owned of {DRIFT_H}",
        kernels.scatter_add_cuda_, kernels.scatter_add_plain,
        t(rng.normal(0, 0.1, (rps, TIER_RANK)).astype(np.float32)),
        t(owned), t(rng.normal(0, 0.01, (DRIFT_H, TIER_RANK)).astype(
            np.float32)), "adaptive", kernels, cases["k2_inputs"]))
    spec = Retierer()._table_cm(ITEM)
    a, b = spec.constants()
    ids = torch.from_numpy(item.astype(np.int32))
    flat = (torch.arange(spec.depth, dtype=torch.int32)[:, None] * spec.width
            + sketch._bucket(ids, a, b, spec.width)).reshape(-1)
    ones = (ids >= 0).to(torch.float32)[None, :].expand(spec.depth, -1)
    cases["scatter_add_dim1"].append(check_k4(
        torch, kernels, dev, f"K4 adaptive tier window {spec.depth} x "
        f"{spec.width}, {flat.numel()} pushes",
        torch.zeros((spec.depth * spec.width, 1), device=dev),
        flat.to(dev), ones.reshape(-1, 1).contiguous().to(dev), "adaptive",
        cases["k4_inputs"]))


def adaptive_phase(torch, fps, kernels, card):
    """Phase 10: the adaptive tier on the card, every position on
    ``cuda:0``, every launch counter at 0 just before each run."""
    t0 = time.perf_counter()
    D, S = TIER_MESH
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    chunks = drift_chunks(drift_data(D * S, DRIFT_CHUNKS), D * S)
    arms, finals = drift_arms(torch, fps, kernels, mesh, chunks, card)
    recovery = drift_recovery(torch, fps, kernels, mesh, chunks, card)
    identity = drift_identity(torch, fps, kernels, mesh, chunks,
                              finals["stale"])
    del finals
    cpu = drift_card_vs_cpu(torch, fps)
    seconds = time.perf_counter() - t0
    log(f"phase 10 done in {seconds:.1f} s")
    runs = list(arms.values()) + [r for e in recovery.values()
                                  for r in e["runs"]]
    return {"runs": runs,
            "arms": arms, "rerank_recovery": recovery, "identity": identity,
            "card_vs_cpu": cpu, "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# Phase 11: durability (checkpoints, delta chains, restore, the guard and
# rollback, storage faults, the tier across a restart).
# ---------------------------------------------------------------------------

# MF at phase 4's width on ML-20M (load_movielens(None, "20m")'s data, the
# same as phase 4's): rank 10, global batch 32,768, mean combine. (a) 3
# epochs through run_indexed, killed after epoch 2 (index 1); (b), (d) the
# first 12 (8) host chunks of 16 steps of an epoch through fit_stream; (d)
# poisons chunk 3. (e) phase 4's SSP logistic regression (1M features, SGD,
# dense head 13, s = 8), one epoch in chunks of one round. (f) phase 9's
# MF at (2, 4), 12 chunks, restarted at chunk 6.
P11 = dict(epochs=3, kill_epoch=1, chunk_steps=16, stream_chunks=12,
           guard_chunks=8, poison_chunk=3, poison_frac=1e-4,
           norm_limit=100.0, lr_chunk_steps=8, tier_chunks=12,
           tier_restart=6, wait_s=300)


def p11_mf(fps, mesh):
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01)
    return fps.online_mf(mesh, cfg, combine="mean", max_steps_per_call=64)


def p11_plan(fps, mesh, data):
    return fps.DeviceEpochPlan(fps.DeviceDataset(mesh, data), num_workers=1,
                               local_batch=BATCH, route_key="user", seed=0)


def p11_state(trainer, store, local):
    """The logical state: every table's rows in id order (a restore
    zero-fills the padding rows no id reaches), the hot fold's state and
    the local state in its export form, on the host."""
    from fps_tpu_torch.core.store import FOLD_KEY_SUFFIX

    out = {f"table/{k}": store.dump_model(k)[1] for k in store.specs}
    for k, v in store.tables.items():
        if k.endswith(FOLD_KEY_SUFFIX):
            out[f"table/{k}"] = v.numpy()
    leaves = trainer.logic.export_local_state(
        trainer._host_local_state(local))
    from fps_tpu_torch.core.resilience import tree_flatten

    for i, leaf in enumerate(tree_flatten(leaves)[0]):
        out[f"local/{i}"] = np.asarray(leaf)
    return out


def p11_equal(label, got, want):
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: arrays {sorted(got)} != "
                             f"{sorted(want)}")
    for k, v in want.items():
        g = np.asarray(got[k])
        if g.dtype != v.dtype or g.shape != v.shape or not np.array_equal(
                g.view(np.uint8), np.ascontiguousarray(v).view(np.uint8)):
            raise AssertionError(f"{label}: {k} differs bit for bit")


def p11_counted(torch, kernels, label, steps, per_step, fn, card,
                phase=11):
    """Run ``fn`` with every launch counter at 0 just before and read just
    after; on the card hold the counts to ``per_step`` (each kernel's
    launches a step, ``None``: recorded only). Returns ``(result,
    summary)``."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = kernels.launch_counts()
    if cuda and per_step is not None:
        check_launches(label, launched, per_step, steps)
    summary = {"path": label, "steps": steps, "seconds": seconds,
               "ms_per_step": seconds / steps * 1e3, "launches": launched,
               "launches_per_step": {k: v / steps for k, v in
                                     launched.items() if v},
               "card": card}
    log(f"phase {phase}, {label}: {summary['ms_per_step']:.3f} ms a step, "
        f"launches a step {summary['launches_per_step']} ({card})")
    return out, summary


def p11_child(argv) -> int:
    """(a)'s victim: ``--phase11-child <dir> <device>``. Trains 3 epochs of
    MF through ``run_indexed`` with an ``AsyncCheckpointer`` saving every
    epoch, and after epoch 2's training (index 1), before its save, flushes
    it, leaves a torn tmp file and dies by SIGKILL
    (``partial_write_then_kill``): step 1 is the latest on disk."""
    import torch

    import fps_tpu_torch as fps
    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.ops import _build
    from fps_tpu_torch.testing import chaos

    where, device = argv[0], argv[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.device(device).type == "cuda":
        _build.library()  # built by the parent: this loads it
    with np.load(os.path.join(where, "mf.npz")) as z:
        data = {k: z[k] for k in z.files}
    mesh = fps.make_ps_mesh(device=device)
    trainer, _ = p11_mf(fps, mesh)
    plan = p11_plan(fps, mesh, data)
    tables, local = trainer.init_state(0)
    ck = AsyncCheckpointer(os.path.join(where, "a"), keep=4)

    def on_epoch(e, _metrics):
        if e == P11["kill_epoch"]:
            ck.flush()  # the saves before this epoch's are durable
            chaos.partial_write_then_kill(ck.dir)

    trainer.run_indexed(tables, local, plan, 1, epochs=P11["epochs"],
                        checkpointer=ck, checkpoint_every=1,
                        on_epoch=on_epoch)
    return 3  # the victim never gets here


def p11_resume(torch, fps, kernels, mf_data, where, dev, card):
    """(a): SIGKILL and resume, bit for bit, then the fallback past a
    truncated newest snapshot."""
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.testing import chaos

    np.savez(os.path.join(where, "mf.npz"),
             **{k: mf_data[k] for k in ("user", "item", "rating")})
    log_path = os.path.join(where, "child.log")
    with open(log_path, "w") as log_f:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase11-child",
             where, str(dev)], cwd=ROOT, stdout=log_f,
            stderr=subprocess.STDOUT)
    try:
        mesh = fps.make_ps_mesh(device=dev)
        plan = p11_plan(fps, mesh, mf_data)
        trainer, store = p11_mf(fps, mesh)
        tables, local = trainer.init_state(0)
        steps = P11["epochs"] * plan.steps_per_epoch
        (tables, local, _), run = p11_counted(
            torch, kernels, "MF, 3 epochs uninterrupted, run_indexed", steps,
            {"gather_rows": 2, "scatter_add": 2},
            lambda: trainer.run_indexed(tables, local, plan, 1,
                                        epochs=P11["epochs"]), card)
        want = p11_state(trainer, store, local)
        try:
            rc = child.wait(timeout=P11["wait_s"])
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != -9:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"phase 11 (a): the child "
                             f"{'hung' if rc is None else f'exited {rc}'}"
                             f", not by SIGKILL:\n{tail}")
    d = os.path.join(where, "a")
    torn = [f for f in os.listdir(d) if f.endswith(".tmp.npz")]
    ck = Checkpointer(d)
    latest = ck.latest_valid_step()
    if latest != P11["kill_epoch"] or not torn:
        raise AssertionError(f"phase 11 (a): latest valid step {latest}, "
                             f"torn tmp files {torn}")

    def resume(label):
        tr, st = p11_mf(fps, mesh)
        _, like = tr.init_state(5)
        t0 = time.perf_counter()
        tb, ls, step = tr.restore_checkpoint(Checkpointer(d), like)
        restore_s = time.perf_counter() - t0
        left = P11["epochs"] - step
        (tb, ls, _), summary = p11_counted(
            torch, kernels, f"MF, resumed at epoch {step}, run_indexed",
            left * plan.steps_per_epoch,
            {"gather_rows": 2, "scatter_add": 2},
            lambda: tr.run_indexed(tb, ls, plan, 1, epochs=left,
                                   start_epoch=step,
                                   checkpointer=Checkpointer(d),
                                   checkpoint_every=1), card)
        p11_equal(label, p11_state(tr, st, ls), want)
        summary["restore_seconds"] = restore_s
        return step, summary

    step1, r1 = resume("phase 11 (a), resumed after SIGKILL")
    newest = os.path.join(d, f"ckpt_{P11['epochs']:012d}.npz")
    chaos.truncate_file(newest)
    step2, r2 = resume("phase 11 (a), resumed past a truncated snapshot")
    if step2 != P11["epochs"] - 1 or not os.path.exists(newest + ".corrupt"):
        raise AssertionError(f"phase 11 (a): the fallback restored step "
                             f"{step2}, corrupt file kept: "
                             f"{os.path.exists(newest + '.corrupt')}")
    log(f"phase 11 (a): killed after epoch {P11['kill_epoch'] + 1} (torn "
        f"tmp {torn}), resumed from step {step1} and, past a truncated "
        f"step {P11['epochs']}, from step {step2}: both bit-equal to the "
        f"uninterrupted run ({card})")
    return {"killed_after_epoch": P11["kill_epoch"] + 1,
            "resumed_from": [step1, step2], "bit_equal": True,
            "torn_tmp_files": torn,
            "restore_seconds": [r1["restore_seconds"],
                                r2["restore_seconds"]]}, [run, r1, r2]


def p11_chunks(data, n, steps, *, W=1, local_batch=BATCH, route_key="user",
               sync_every=None, seed=0):
    import itertools

    from fps_tpu_torch.core.ingest import epoch_chunks

    return list(itertools.islice(epoch_chunks(
        data, num_workers=W, local_batch=local_batch, steps_per_chunk=steps,
        route_key=route_key, sync_every=sync_every, seed=seed), n))


def p11_streams(torch, fps, kernels, chunks, where, dev, card):
    """(b): fit_stream with prefetch 2 and a save every chunk, full
    snapshots and a delta chain, against no checkpointer; (c): the (1, 1)
    snapshot onto a (2, 4) mesh of the card and back, and onto the CPU."""
    import dataclasses

    from fps_tpu_torch.core.checkpoint import (
        AsyncCheckpointer,
        Checkpointer,
        DeltaPolicy,
    )

    mesh = fps.make_ps_mesh(device=dev)
    steps = len(chunks) * P11["chunk_steps"]
    out, runs, states = {}, [], {}
    for arm in ("none", "full", "delta"):
        trainer, store = p11_mf(fps, mesh)
        trainer.config = dataclasses.replace(trainer.config, prefetch=2)
        tables, local = trainer.init_state(0)
        ck = None
        if arm != "none":
            ck = AsyncCheckpointer(
                os.path.join(where, f"b_{arm}"), keep=3,
                delta=DeltaPolicy(full_every=8) if arm == "delta" else None)
        # The savers' timings go to the process-default recorder; the
        # stream flushes the writer before it returns.
        rec = fps.obs.Recorder()
        with fps.obs.events.default_recorder(rec):
            (tables, local, _), summary = p11_counted(
                torch, kernels, f"MF, fit_stream, prefetch 2, saves: {arm}",
                steps, {"gather_rows": 2, "scatter_add": 2},
                lambda: trainer.fit_stream(tables, local, chunks, 1,
                                           checkpointer=ck,
                                           checkpoint_every=1),
                card)
        states[arm] = p11_state(trainer, store, local)
        runs.append(summary)
        if ck is None:
            continue
        p11_equal(f"phase 11 (b), {arm} against no checkpointer",
                  states[arm], states["none"])
        head, values, leaves, _ = ck.read_snapshot()
        if head != len(chunks):
            raise AssertionError(f"phase 11 (b), {arm}: the head is step "
                                 f"{head}, not {len(chunks)}")
        snap = {f"table/{k}": values[k] for k in store.specs}
        snap.update({f"local/{i}": v for i, v in enumerate(leaves)})
        p11_equal(f"phase 11 (b), {arm}: the head against the live state",
                  snap, states[arm])
        folded = ck.compact()
        if folded is not None:
            after = ck.read_snapshot(head)[1]
            p11_equal(f"phase 11 (b), {arm}: compact",
                      {k: after[k] for k in store.specs},
                      {k: values[k] for k in store.specs})
        ck.close()
        m = rec.snapshot()["histograms"]
        out[arm] = {
            "full_publishes": ck.full_publishes,
            "delta_publishes": ck.delta_publishes,
            "publish_bytes": ck.publish_bytes_total,
            "delta_bytes": ck.delta_bytes_total,
            "compacted": folded is not None,
            "dump_seconds": [m["checkpoint.dump_seconds"]["sum"],
                             m["checkpoint.dump_seconds"]["count"]],
            "capture_seconds": [m["checkpoint.capture_seconds"]["sum"],
                                m["checkpoint.capture_seconds"]["count"]],
            "ms_per_step": summary["ms_per_step"],
            "ms_per_step_without_saves": runs[0]["ms_per_step"]}
        log(f"phase 11 (b), {arm}: {ck.full_publishes} fulls, "
            f"{ck.delta_publishes} deltas, {ck.publish_bytes_total} bytes "
            f"published; dump (training thread) {out[arm]['dump_seconds']}"
            f" s, capture (writer) {out[arm]['capture_seconds']} s over "
            f"(total, count); bit-equal to no checkpointer, the head to "
            f"the live state ({card})")

    # (c) The elastic re-split: (1, 1) -> (2, 4) on the card -> (1, 1),
    # and onto the CPU.
    want = states["delta"]
    src = os.path.join(where, "b_delta")
    D, S = TIER_MESH
    elastic = {}
    for label, target, source in (
            ("(1, 1) -> (2, 4)", fps.make_ps_mesh(S, D, device=dev), src),
            ("(2, 4) -> (1, 1)", mesh, os.path.join(where, "c_24")),
            ("(1, 1) -> the CPU", fps.make_ps_mesh(device="cpu"), src)):
        trainer, store = p11_mf(fps, target)
        _, like = trainer.init_state(7)
        ck = Checkpointer(source)
        # The checkpointer's metrics go to the process-default recorder.
        rec = fps.obs.Recorder()
        t0 = time.perf_counter()
        with fps.obs.events.default_recorder(rec):
            _, local, step = trainer.restore_checkpoint(ck, like)
        seconds = time.perf_counter() - t0
        p11_equal(f"phase 11 (c), {label}", p11_state(trainer, store, local),
                  want)
        resplits = rec.counter_value("checkpoint.resplits")
        if resplits != (0 if "CPU" in label else 1):
            raise AssertionError(f"phase 11 (c), {label}: {resplits} "
                                 "re-splits recorded")
        if label.startswith("(1, 1) -> (2, 4)"):
            trainer._save_checkpoint(Checkpointer(
                os.path.join(where, "c_24")), step, local)
        elastic[label] = {"seconds": seconds, "resplits": resplits}
    log(f"phase 11 (c): the (1, 1) snapshot restores onto (2, 4) and back "
        f"and onto the CPU bit for bit: {json.dumps(elastic)} ({card})")
    return {"arms": out, "elastic": elastic}, runs


def p11_poison(chunks, index, frac):
    """``chunks`` with chunk ``index``'s rating column poisoned: NaN at a
    seeded ``frac`` of its entries (``poison_chunks``), 1e30 at as many
    more; the host's count of poisoned live rows."""
    from fps_tpu_torch.testing import chaos

    out = list(chaos.poison_chunks(chunks, chunk_index=index,
                                   column="rating", kind="nan", frac=frac,
                                   seed=1))
    c = dict(out[index])
    r = np.array(c["rating"], copy=True)
    flat = r.reshape(-1)
    rng = np.random.default_rng(2)
    clean = np.flatnonzero(np.isfinite(flat))
    flat[rng.choice(clean, size=max(1, int(frac * flat.size)),
                    replace=False)] = 1e30
    c["rating"] = r
    out[index] = c
    live = (~np.isfinite(r) | (r == 1e30)) & (c["weight"] > 0)
    return out, int(live.sum())


def p11_host_launches(torch, fn):
    """Kernel launches the host made during ``fn()`` (every
    ``cudaLaunchKernel`` and the like, from ``torch.profiler``'s host-side
    records), and the result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if re.fullmatch(r"cu(da)?LaunchKernel(ExC)?(_v2)?", e.name))
    return n, out


def p11_guard(torch, fps, kernels, chunks, dev, card):
    """(d): the guard and rollback on MF's stream, chunk 3 poisoned."""
    import dataclasses

    from fps_tpu_torch.core.resilience import GuardConfig, RollbackPolicy

    mesh = fps.make_ps_mesh(device=dev)
    steps = len(chunks) * P11["chunk_steps"]
    poisoned, n_poison = p11_poison(chunks, P11["poison_chunk"],
                                    P11["poison_frac"])
    mask = GuardConfig(mode="mask", norm_limit=P11["norm_limit"],
                       local=True)
    per_step = {"gather_rows": 2, "scatter_add": 2}
    runs, states, out = [], {}, {}

    def run(label, guard, stream, *, rollback=None, lag=0, traced=False,
            extra=0):
        """``extra``: chunks run beyond the stream's (a lag-1
        quarantine runs the next chunk again) or, negative, skipped."""
        trainer, store = p11_mf(fps, mesh)
        trainer.config = dataclasses.replace(trainer.config, guard=guard,
                                             health_lag=lag)
        tables, local = trainer.init_state(0)
        n_steps = steps + extra * P11["chunk_steps"]

        def go():
            return trainer.fit_stream(tables, local, stream, 1,
                                      rollback=rollback)

        (tables, local, metrics), summary = p11_counted(
            torch, kernels, f"MF, fit_stream, {label}", n_steps, per_step,
            go, card)
        runs.append(summary)
        states[label] = p11_state(trainer, store, local)
        if traced and torch.cuda.is_available():
            # One more chunk, traced: the host's kernel launches a step.
            n, _ = p11_host_launches(torch, lambda: trainer.run_chunk(
                tables, local, stream[0], 99))
            summary["host_launches_per_step"] = n / P11["chunk_steps"]
        return tables, local, metrics, summary

    _, _, _, none_run = run("clean, guard None", None, chunks, traced=True)
    _, _, m_clean, mask_run = run("clean, guard mask", mask, chunks,
                                  traced=True)
    p11_equal("phase 11 (d), clean mask against guard None",
              states["clean, guard mask"], states["clean, guard None"])
    if any(int(np.sum(c[k])) for m in m_clean
           for c in m["health"].values() for k in c):
        raise AssertionError("phase 11 (d): the clean stream counted poison")
    tables, local, metrics, _ = run("poisoned, guard mask", mask, poisoned)
    check_finite(torch, "phase 11 (d), poisoned, mask", tables, local)
    masked = int(sum(np.sum(m["health"][ITEM]["masked"]) for m in metrics))
    if masked != n_poison:
        raise AssertionError(f"phase 11 (d): masked {masked} rows, the host "
                             f"counts {n_poison} poisoned live rows")
    for lag in (0, 1):
        rb = RollbackPolicy(max_rollbacks=1)
        run(f"poisoned, observe, rollback, health_lag {lag}", "observe",
            poisoned, rollback=rb, lag=lag, extra=lag)
        if rb.quarantined != [P11["poison_chunk"]]:
            raise AssertionError(f"phase 11 (d): lag {lag} quarantined "
                                 f"{rb.quarantined}")
    run("poisoned, observe, preset skip", "observe", poisoned,
        rollback=RollbackPolicy(preset={P11["poison_chunk"]}), extra=-1)
    want = states["poisoned, observe, preset skip"]
    for lag in (0, 1):
        p11_equal(f"phase 11 (d), quarantine at lag {lag} against a preset "
                  "skip",
                  states[f"poisoned, observe, rollback, health_lag {lag}"],
                  want)
    out = {"poisoned_live_rows": n_poison, "masked": masked,
           "quarantined": [P11["poison_chunk"]],
           "ms_per_step_guard_none": none_run["ms_per_step"],
           "ms_per_step_guard_mask": mask_run["ms_per_step"],
           "kernel_launches_per_step_guard_none":
               none_run["launches_per_step"],
           "kernel_launches_per_step_guard_mask":
               mask_run["launches_per_step"]}
    if "host_launches_per_step" in none_run:
        out["host_launches_per_step"] = {
            "none": none_run["host_launches_per_step"],
            "mask": mask_run["host_launches_per_step"]}
        out["launches_the_guard_adds_per_step"] = (
            mask_run["host_launches_per_step"]
            - none_run["host_launches_per_step"])
    log(f"phase 11 (d): mask kept the tables finite and masked {masked} = "
        f"{n_poison} poisoned live rows; quarantine = preset skip at lag 0 "
        f"and 1; clean mask = guard None bit for bit; {json.dumps(out)} "
        f"({card})")
    return out, runs


def p11_brownout(torch, fps, kernels, lr_data, where, dev, card):
    """(e): bench.py run_storage's arms on the port: SSP logistic
    regression at phase 4's width, prefetch 2, an AsyncCheckpointer
    (``when_full="degrade"``) saving every chunk, clean and under the
    port's faultfs (an EIO blackout past the retry budget, slow fsyncs)."""
    import dataclasses
    import threading

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.testing import faultfs
    from fps_tpu_torch.testing.faultfs import FaultRule

    mesh = fps.make_ps_mesh(device=dev)
    chunks = p11_chunks(lr_data, 1 << 30, P11["lr_chunk_steps"],
                        local_batch=SPARSE_BATCH, route_key=None,
                        sync_every=8, seed=1)
    steps = len(chunks) * P11["lr_chunk_steps"]
    rules = [FaultRule("snapshot", "write", "errno", errno_name="EIO",
                       start=2, count=6),
             FaultRule("snapshot", "fsync", "delay", delay_s=0.01, start=0,
                       count=None, every=3)]

    def trainer_of():
        cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                               dense_features=LR_DENSE)
        tr, st = fps.logistic_regression(mesh, cfg, sync_every=8)
        tr.config = dataclasses.replace(tr.config, prefetch=2)
        return tr, st

    # The reference: the weights after every chunk, untimed.
    tr, st = trainer_of()
    tables, local = tr.init_state(0)
    per_chunk = []
    tr.fit_stream(tables, local, chunks, 1, on_chunk=lambda i, m:
                  per_chunk.append(st.dump_model("weights")[1]))
    arms, runs = {}, []
    for arm in ("clean", "brownout"):
        tr, st = trainer_of()
        tables, local = tr.init_state(0)
        d = os.path.join(where, f"e_{arm}")
        ck = AsyncCheckpointer(d, keep=len(chunks) + 2, when_full="degrade")
        fs = faultfs.install(rules, seed=0) if arm == "brownout" else None
        peak, stop = [0], threading.Event()

        def sample():
            while not stop.is_set():
                peak[0] = max(peak[0], ck._publish_backlog)
                stop.wait(0.005)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        # The writer's retries go to the process-default recorder.
        rec = fps.obs.Recorder()
        try:
            with fps.obs.events.default_recorder(rec):
                (tables, local, metrics), summary = p11_counted(
                    torch, kernels, f"logreg SSP, fit_stream, saves every "
                    f"chunk, {arm}", steps,
                    {"gather_rows_dim1": 1, "scatter_add_dim1": 1},
                    lambda: tr.fit_stream(tables, local, chunks, 1,
                                          checkpointer=ck,
                                          checkpoint_every=1),
                    card)
        finally:
            stop.set()
            sampler.join(timeout=5.0)
            injected = fs.injected_counts() if fs is not None else None
            faultfs.uninstall()
        runs.append(summary)
        weights = st.dump_model("weights")[1]
        p11_equal(f"phase 11 (e), {arm}: final weights",
                  {"w": weights}, {"w": per_chunk[-1]})
        step = ck.latest_valid_step()
        snap = ck.read_snapshot(step)[1]["weights"]
        p11_equal(f"phase 11 (e), {arm}: the recovered snapshot of step "
                  f"{step}", {"w": snap}, {"w": per_chunk[step - 1]})
        n = float(sum(np.sum(m["n"]) for m in metrics))
        arms[arm] = {"examples_per_s": n / summary["seconds"],
                     "degraded_publishes": ck.degraded_publishes,
                     "backlog_peak": peak[0],
                     "backlog_final": ck._publish_backlog,
                     "publishes_landed": ck.full_publishes,
                     "retries": rec.counter_value("storage.retries",
                                                  plane="checkpoint"),
                     "last_recovered_step": step, "chunks": len(chunks),
                     "injected": ({"/".join(k): v for k, v in
                                   injected.items()} if injected else None)}
        ck.close()
    if arms["brownout"]["degraded_publishes"] < 1:
        raise AssertionError("phase 11 (e): the blackout degraded nothing")
    retention = (arms["brownout"]["examples_per_s"]
                 / arms["clean"]["examples_per_s"])
    out = {"arms": arms, "throughput_retention": retention}
    log(f"phase 11 (e): throughput retention {retention:.4f}, degraded "
        f"{arms['brownout']['degraded_publishes']}, backlog peak "
        f"{arms['brownout']['backlog_peak']}; final weights and the "
        f"recovered snapshots bit-equal to the clean stream's "
        f"{json.dumps(arms)} ({card})")
    return out, runs


def p11_tier(torch, fps, kernels, dev, card):
    """(f): the tier across a restart at (2, 4): the whole item table
    replicated with an Adagrad hot fold (phase 9's fold arm; a fold needs
    the whole table), and phase 10's recovery arm with the sidecar."""
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.core.store import fold_key
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mesh = fps.make_ps_mesh(S, D, device=dev)
    n, k = P11["tier_chunks"], P11["tier_restart"]
    fold = fps.HotFold(kind="adagrad", lr=TIER_FOLD_LR)
    out, runs = {}, []
    import tempfile

    for arm in ("fold", "recovery"):
        if arm == "fold":
            chunks = tier_chunks(ds.zipf_ratings(
                TIER_NU, TIER_NI, W * TIER_LOCAL * TIER_SPC * n, seed=1),
                W, None)[:n]

            def make(state_dir=None):
                return tier_mf(fps, mesh, TIER_NI, 0, False, None,
                               fold=fold)
        else:
            chunks = drift_chunks(drift_data(W, n), W)[:n]

            def make(state_dir=None):
                tr, st = drift_mf(fps, mesh, "recovery")
                tr.retierer.state_dir = state_dir
                return tr, st
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p11_") as d:
            tr, st = make()
            tables, local = tr.init_state(0)
            (tables, local, _), summary = p11_counted(
                torch, kernels, f"MF tier {arm}, mesh {D}x{S}, "
                "uninterrupted", n * TIER_SPC, None,
                lambda: tr.fit_stream(tables, local, chunks, 1), card)
            runs.append(summary)
            want = p11_state(tr, st, local)
            want_ids = (tr.retierer.hot_ids_for(ITEM, DRIFT_H).copy()
                        if arm == "recovery" else None)
            tr, st = make(d)
            tables, local = tr.init_state(0)
            tr.fit_stream(tables, local, chunks[:k], 1,
                          checkpointer=Checkpointer(d), checkpoint_every=k)
            tr, st = make(d)
            _, like = tr.init_state(3)
            tables, local, step = tr.restore_checkpoint(Checkpointer(d),
                                                        like)
            if arm == "recovery" and not tr.retierer.restore(step):
                raise AssertionError("phase 11 (f): no sidecar at step "
                                     f"{step}")
            (tables, local, _), summary = p11_counted(
                torch, kernels, f"MF tier {arm}, mesh {D}x{S}, resumed at "
                f"chunk {step}", (n - k) * TIER_SPC, None,
                lambda: tr.fit_stream(tables, local, chunks[k:], 1,
                                      start_step=k), card)
            runs.append(summary)
            p11_equal(f"phase 11 (f), {arm}: resumed against "
                      "uninterrupted", p11_state(tr, st, local), want)
            entry = {"restored_step": step, "bit_equal": True}
            if arm == "fold":
                if f"table/{fold_key(ITEM)}" not in want:
                    raise AssertionError("phase 11 (f): no fold state")
                # An untiered trainer restores the same canonical tables.
                tr0, st0 = tier_mf(fps, mesh, 0, 0, False, None)
                _, like = tr0.init_state(3)
                tr0.restore_checkpoint(Checkpointer(d), like)
                tr1, st1 = make()
                _, like = tr1.init_state(3)
                tr1.restore_checkpoint(Checkpointer(d), like)
                p11_equal("phase 11 (f): an untiered restore",
                          {"t": st0.dump_model(ITEM)[1]},
                          {"t": st1.dump_model(ITEM)[1]})
                entry["untiered_restore_equal"] = True
            else:
                got_ids = tr.retierer.hot_ids_for(ITEM, DRIFT_H)
                if not np.array_equal(got_ids, want_ids):
                    raise AssertionError("phase 11 (f): the resumed hot ids "
                                         "differ")
                entry["re_ranks_after_resume"] = tr.retierer.re_ranks
            out[arm] = entry
    log(f"phase 11 (f): the tier resumed bit for bit, fold state and "
        f"sidecar included: {json.dumps(out)} ({card})")
    return out, runs


def durability_phase(torch, fps, kernels, mf_data, lr_data, card,
                     dev="cuda:0"):
    """Phase 11: durability at phase 4's MF width on ``dev``, every launch
    counter at 0 just before each run: (a) SIGKILL and resume, (b) saves
    that change nothing and the delta chain, (c) the elastic re-split, (d)
    the guard and rollback, (e) the storage brownout, (f) the tier across
    a restart."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    where = tempfile.mkdtemp(prefix="chip_smoke_phase11_")
    runs = []
    try:
        resume, r = p11_resume(torch, fps, kernels, mf_data, where, dev, card)
        runs += r
        chunks = p11_chunks(mf_data, max(P11["stream_chunks"],
                                         P11["guard_chunks"]),
                            P11["chunk_steps"])
        streams, r = p11_streams(torch, fps, kernels,
                                 chunks[:P11["stream_chunks"]], where, dev,
                                 card)
        runs += r
        guard, r = p11_guard(torch, fps, kernels,
                             chunks[:P11["guard_chunks"]], dev, card)
        runs += r
        del chunks
        brownout, r = p11_brownout(torch, fps, kernels, lr_data, where, dev,
                                   card)
        runs += r
        tier, r = p11_tier(torch, fps, kernels, dev, card)
        runs += r
    finally:
        shutil.rmtree(where, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"phase 11 done in {seconds:.1f} s")
    return {"runs": runs, "resume": resume, "streams": streams,
            "guard": guard, "brownout": brownout, "tier": tier,
            "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# Phase 12: telemetry on the card.
# ---------------------------------------------------------------------------

P12 = dict(indexed_epochs=2, stream_chunks=12, chunk_steps=16, ckpt_every=4,
           prefetch=2, watchdog_s=60.0, guard_chunks=8, poison_chunk=3,
           poison_frac=1e-4, norm_limit=100.0, stall_chunks=6, stall_after=2,
           stall_deadline_s=0.5, stall_cycles=1_500_000_000,
           stall_host_s=0.8, trace_warm_spins=64)
# What the recorder's phase totals must hold, across (a)'s two drivers
# (run_indexed has no ingest, placement or prefetch of its own).
P12_PHASES = ("dispatch", "host_sync", "place", "ingest", "prefetch",
              "checkpoint")
# (f)'s turns: with the recorder (A) and without (B).
P12_TURNS = ("A", "B", "B", "A")


class SyncCount:
    """The synchronising CUDA calls made while entered, every thread's:
    torch's sync debug mode (``"warn"``) turns each into a warning, counted
    here with the Python line that made it (``sites``) and, for each
    site, the stack of its first call (``stacks``). Off the card, none."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = 0
        self.sites = {}
        self.stacks = {}
        self._arming = False

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        import traceback

        if self._arming or "synchroniz" not in str(message).lower():
            return
        site = f"{os.path.basename(filename)}:{lineno}"
        self.calls += 1
        self.sites[site] = self.sites.get(site, 0) + 1
        if site not in self.stacks:
            self.stacks[site] = "".join(traceback.format_stack(limit=10))

    def __enter__(self):
        import warnings

        self._cuda = self.torch.cuda.is_available()
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        if self._cuda:
            # Switching the mode on warns once a process itself: not a
            # call of the code under count.
            self._arming = True
            self.torch.cuda.set_sync_debug_mode("warn")
        self._arming = False
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self.torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)


def p12_counted(torch, kernels, fn):
    """``fn()`` with every launch counter at 0 just before and read just
    after, and its synchronising calls counted: ``(result, launches,
    SyncCount, seconds)``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with SyncCount(torch) as syncs:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, kernels.launch_counts(), syncs, time.perf_counter() - t0


def p12_journal(obs_dir):
    """The events of ``obs_dir``'s journal (process 0)."""
    with open(os.path.join(obs_dir, "journal-p0.jsonl")) as f:
        return [json.loads(line) for line in f]


def p12_same(label, a, b):
    """Two arms' tables and local state bit for bit, launches and
    synchronising calls equal."""
    p11_equal(f"phase 12 (a), {label}: tables with the recorder against "
              "without", a["state"], b["state"])
    if a["launches"] != b["launches"]:
        raise AssertionError(f"phase 12 (a), {label}: launches "
                             f"{a['launches']} with the recorder, "
                             f"{b['launches']} without")
    if a["syncs"] != b["syncs"]:
        odd = {site: (a["sync_stacks"].get(site) or b["sync_stacks"][site])
               for site in set(a["sync_sites"]) | set(b["sync_sites"])
               if a["sync_sites"].get(site) != b["sync_sites"].get(site)}
        raise AssertionError(f"phase 12 (a), {label}: {a['syncs']} "
                             f"synchronising calls with the recorder "
                             f"({a['sync_sites']}), {b['syncs']} without "
                             f"({b['sync_sites']}); where they differ: "
                             + json.dumps(odd))


def p12_arm(torch, fps, kernels, mesh, label, obs_dir, ck_dir, run, steps,
            fed, card):
    """One arm of (a) / (f): a fresh MF trainer, a checkpointer and a
    ``StepWatchdog`` (deadline far off: it watches, it does not fire), and
    with ``obs_dir`` an ``open_run`` recorder (installed: the checkpoint
    trail flows to it). ``run(trainer, tables, local, **kw)`` trains."""
    import shutil

    from fps_tpu_torch.core.checkpoint import Checkpointer

    shutil.rmtree(ck_dir, ignore_errors=True)
    trainer, store = p11_mf(fps, mesh)
    rec = None
    if obs_dir is not None:
        rec = fps.obs.open_run(obs_dir, config={"phase": 12, "arm": label},
                               meta={"workload": "mf"})
    wd = fps.obs.StepWatchdog(P12["watchdog_s"], recorder=rec)
    tables, local = trainer.init_state(0)
    stamps = []
    try:
        (tables, local, metrics), launched, syncs, seconds = p12_counted(
            torch, kernels, lambda: run(
                trainer, tables, local, recorder=rec, watchdog=wd,
                checkpointer=Checkpointer(ck_dir, keep=2), stamps=stamps))
    finally:
        if rec is not None:
            rec.close()
    check_finite(torch, f"phase 12, {label}", tables, local)
    per_chunk = np.diff(stamps) if len(stamps) > 1 else np.array([seconds])
    steps_per_chunk = steps / max(1, len(stamps))
    arm = {"label": label, "recorder": rec is not None, "steps": steps,
           "seconds": seconds, "ms_per_step": seconds / steps * 1e3,
           "steady_ms_per_step": float(np.median(per_chunk))
           / steps_per_chunk * 1e3,
           "launches": launched, "syncs": syncs.calls,
           "sync_sites": syncs.sites, "sync_stacks": syncs.stacks,
           "stalls": len(wd.stalls),
           "state": p11_state(trainer, store, local)}
    if rec is not None:
        totals = rec.phase_totals()
        arm["phase_totals"] = totals
        arm["examples"] = rec.counter_value("driver.examples")
        # The counter adds each chunk's (epoch's) float32 sum of the
        # per-step "n" leaf, as the reference's does: exact below 2^24
        # examples a sum, a few float32 roundings of it above (ML-20M's
        # epoch is 20M). 1e-6 of the total is 8 ulps at float32.
        if not abs(arm["examples"] - fed) <= 1e-6 * fed:
            raise AssertionError(f"phase 12 (a), {label}: driver.examples "
                                 f"{arm['examples']}, {fed} fed")
    if wd.stalls:
        raise AssertionError(f"phase 12 (a), {label}: the watchdog flagged "
                             f"{wd.stalls}")
    log(f"phase 12 (a), {label}: {seconds:.3f} s, "
        f"{arm['steady_ms_per_step']:.4f} ms a step steady, "
        f"{syncs.calls} synchronising calls ({syncs.sites}), launches "
        f"{launched} ({card})")
    return arm


def p12_recorder_changes_nothing(torch, fps, kernels, mesh, mf_data,
                                 chunks, where, card):
    """(a) and (f): MF through run_indexed (A then B) and fit_stream
    (A, B, B, A), each arm with a checkpointer and a watchdog, A with an
    ``open_run`` recorder."""
    import tempfile
    plan = p11_plan(fps, mesh, mf_data)

    def indexed(trainer, tables, local, recorder, watchdog, checkpointer,
                stamps):
        return trainer.run_indexed(
            tables, local, plan, 1, epochs=P12["indexed_epochs"],
            checkpointer=checkpointer, checkpoint_every=1,
            recorder=recorder, watchdog=watchdog,
            on_epoch=lambda e, m: stamps.append(time.perf_counter()))

    def stream(trainer, tables, local, recorder, watchdog, checkpointer,
               stamps):
        import dataclasses

        trainer.config = dataclasses.replace(trainer.config,
                                             prefetch=P12["prefetch"])
        return trainer.fit_stream(
            tables, local, chunks, 1, checkpointer=checkpointer,
            checkpoint_every=P12["ckpt_every"], recorder=recorder,
            watchdog=watchdog,
            on_chunk=lambda i, m: stamps.append(time.perf_counter()))

    n = len(mf_data["rating"])
    arms = {}
    # A process's first run at these shapes pays one-time work (the
    # kernels' card plans are queried and cached): each driver runs once
    # untimed first, so the arms compare like with like.
    for run in (indexed, stream):
        trainer, _ = p11_mf(fps, mesh)
        tables, local = trainer.init_state(0)
        with tempfile.TemporaryDirectory(dir=where) as ck:
            from fps_tpu_torch.core.checkpoint import Checkpointer

            run(trainer, tables, local, recorder=None,
                watchdog=fps.obs.StepWatchdog(P12["watchdog_s"]),
                checkpointer=Checkpointer(ck, keep=2), stamps=[])
    for label, run, steps, fed, turns in (
            ("run_indexed", indexed,
             P12["indexed_epochs"] * plan.steps_per_epoch,
             float(P12["indexed_epochs"] * n), P12_TURNS),
            ("fit_stream", stream, len(chunks) * P12["chunk_steps"],
             float(sum(np.sum(c["weight"] > 0) for c in chunks)),
             P12_TURNS)):
        arms[label] = []
        for i, turn in enumerate(turns):
            obs_dir = (os.path.join(where, f"obs_{label}_{i}")
                       if turn == "A" else None)
            arms[label].append(dict(p12_arm(
                torch, fps, kernels, mesh, f"{label}, turn {i} ({turn})",
                obs_dir,
                os.path.join(where, f"ck_{label}"), run, steps, fed, card),
                turn=turn, obs_dir=obs_dir))
        a = [x for x in arms[label] if x["turn"] == "A"]
        b = [x for x in arms[label] if x["turn"] == "B"]
        for x, y in zip(a, b):
            p12_same(label, x, y)
    have = set()
    for label in arms:
        for x in arms[label]:
            have |= set(x.get("phase_totals", {}))
    missing = [p for p in P12_PHASES if p not in have]
    if missing:
        raise AssertionError(f"phase 12 (a): the phase totals lack "
                             f"{missing} (have {sorted(have)})")
    return arms


def p12_health(torch, fps, kernels, mesh, chunks, where, card):
    """(b): phase 11 (d)'s stream, chunk 3 of 8 poisoned, under an observe
    guard with a rollback policy and a HealthMonitor: the guard escalates
    to mask where the reference's policy says (the first chunk whose
    cumulative poisoned rows reach the threshold), the journal holds the
    ``guard_escalated`` event; a monitor with ``abort_after_chunks=1``
    raises PoisonedStreamError."""
    import dataclasses

    from fps_tpu_torch.core.resilience import (
        GuardConfig,
        PoisonedStreamError,
        RollbackPolicy,
    )

    poisoned, n_poison = p11_poison(chunks, P12["poison_chunk"],
                                    P12["poison_frac"])
    guard = GuardConfig(mode="observe", norm_limit=P12["norm_limit"])
    threshold = max(1, n_poison // 2)
    out = {"poisoned_live_rows": n_poison, "escalate_after_rows": threshold}

    trainer, _ = p11_mf(fps, mesh)
    trainer.config = dataclasses.replace(trainer.config, guard=guard)
    obs_dir = os.path.join(where, "obs_health")
    rec = fps.obs.open_run(obs_dir, config={"phase": 12, "part": "b"})
    monitor = fps.obs.HealthMonitor(escalate_after_rows=threshold)
    rb = RollbackPolicy(max_rollbacks=1)
    tables, local = trainer.init_state(0)
    try:
        tables, local, _ = trainer.fit_stream(
            tables, local, poisoned, 1, recorder=rec, health=monitor,
            rollback=rb)
    finally:
        rec.close()
    journal = p12_journal(obs_dir)
    poison_by_chunk = {e["index"]: e.get("poison_rows", 0)
                       for e in journal if e["event"] == "chunk"}
    # The reference's policy (fps_tpu/obs/health.py HealthMonitor.update):
    # escalate at the first chunk whose cumulative poisoned rows reach the
    # threshold.
    total, expected = 0, None
    for i in sorted(poison_by_chunk):
        total += poison_by_chunk[i]
        if total >= threshold:
            expected = i
            break
    esc = [e for e in journal if e["event"] == "guard_escalated"]
    if (monitor.escalated_at != expected or expected != P12["poison_chunk"]
            or len(esc) != 1 or esc[0]["index"] != expected
            or trainer.config.guard.mode != "mask"):
        raise AssertionError(
            f"phase 12 (b): escalated at {monitor.escalated_at}, the "
            f"policy says {expected} (poison by chunk {poison_by_chunk}), "
            f"journal {esc}, guard {trainer.config.guard}")
    if rb.quarantined != [P12["poison_chunk"]]:
        raise AssertionError(f"phase 12 (b): quarantined {rb.quarantined}")
    check_finite(torch, "phase 12 (b)", tables, local)
    out.update(escalated_at=monitor.escalated_at,
               poison_rows_by_chunk=poison_by_chunk,
               quarantined=rb.quarantined)

    trainer, _ = p11_mf(fps, mesh)
    trainer.config = dataclasses.replace(trainer.config, guard=guard)
    sink = fps.obs.MemorySink()
    abort = fps.obs.HealthMonitor(abort_after_chunks=1)
    tables, local = trainer.init_state(0)
    try:
        trainer.fit_stream(tables, local, poisoned, 1,
                           recorder=fps.obs.Recorder(sinks=[sink]),
                           health=abort)
        raise AssertionError("phase 12 (b): the abort monitor let the "
                             "poisoned stream finish")
    except PoisonedStreamError as e:
        if (abort.aborted_at != P12["poison_chunk"]
                or len(sink.events("health_abort")) != 1):
            raise AssertionError(f"phase 12 (b): aborted at "
                                 f"{abort.aborted_at}: {e}") from e
    out["aborted_at"] = abort.aborted_at
    log(f"phase 12 (b): escalated observe -> mask at chunk "
        f"{monitor.escalated_at} as the policy says, quarantined "
        f"{rb.quarantined}, aborted at chunk {abort.aborted_at}: "
        f"{json.dumps(out)}")
    return out


def p12_stall(torch, fps, kernels, mesh, chunks, card):
    """(c): on_chunk of chunk 2 stalls the card (a spin kernel of ~0.8 s;
    on the CPU the next chunk sleeps): the 0.5 s watchdog records one
    ``stall`` (chunk 3, the chunk whose read waits) and its recovery, and
    the stream finishes."""
    trainer, _ = p11_mf(fps, mesh)
    sink = fps.obs.MemorySink()
    rec = fps.obs.Recorder(sinks=[sink])
    wd = fps.obs.StepWatchdog(P12["stall_deadline_s"], recorder=rec)
    cuda = mesh.device.type == "cuda"
    host_stall = []

    def on_chunk(i, m):
        if i == P12["stall_after"]:
            if cuda:
                torch.cuda._sleep(P12["stall_cycles"])
            else:
                host_stall.append(i)

    if not cuda:
        run_chunk = trainer.run_chunk

        def slow(*a, **k):
            if host_stall:
                time.sleep(P12["stall_host_s"])
                host_stall.clear()
            return run_chunk(*a, **k)

        trainer.run_chunk = slow
    tables, local = trainer.init_state(0)
    _, _, metrics = trainer.fit_stream(tables, local, chunks, 1,
                                       recorder=rec, watchdog=wd,
                                       on_chunk=on_chunk)
    stalls = sink.events("stall")
    recovered = sink.events("stall_recovered")
    if (len(metrics) != len(chunks) or len(wd.stalls) != 1
            or len(stalls) != 1 or len(recovered) != 1
            or stalls[0]["index"] != P12["stall_after"] + 1
            or rec.counter_value("watchdog.stalls") != 1):
        raise AssertionError(f"phase 12 (c): stalls {wd.stalls}, events "
                             f"{stalls} / {recovered}, {len(metrics)} "
                             f"chunks of {len(chunks)}")
    out = {"stall": stalls[0], "elapsed_s": recovered[0]["elapsed_s"],
           "chunks": len(metrics)}
    log(f"phase 12 (c): one stall at chunk {stalls[0]['index']}, "
        f"recovered after {recovered[0]['elapsed_s']} s, the stream "
        f"finished ({card})")
    return out


def p12_trace(torch, fps, kernels, mesh, lr_data, where, card):
    """(d): ``obs.trace`` around one SSP round (8 steps) of phase 4's
    logistic regression writes a Chrome trace naming K5's and K4's kernels
    and the step's ``fps.pull`` / ``fps.push`` ranges. The window is padded
    as phase 5's are (host waits, a spin kernel first) and traced again
    when the tracer lost its device records."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    cuda = mesh.device.type == "cuda"
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                           dense_features=LR_DENSE)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    it = multi_epoch_chunks(lr_data, 1, num_workers=1,
                            local_batch=SPARSE_BATCH, steps_per_chunk=8,
                            sync_every=8, seed=1)
    warm, chunk = next(it), next(it)
    tables, local = trainer.init_state(0)
    tables, local, _ = trainer.run_chunk(tables, local, warm, 0)
    for attempt in range(PROFILE_ATTEMPTS):
        d = os.path.join(where, f"trace_{attempt}")
        with fps.obs.trace(d) as prof:
            time.sleep(PROFILE_PAD_S)
            if cuda:
                # obs.trace has no warm-up cycle, and late in a process
                # the tracer drops the first records of a window (the
                # full chip_smoke run lost its first 32): a burst of
                # short spins takes them before the sentinel spin.
                for _ in range(P12["trace_warm_spins"]):
                    torch.cuda._sleep(1000)
                torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            trainer.run_chunk(tables, local, chunk, 1)
            if cuda:
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        records = dict(window_records(torch, prof.events(), 1),
                       attempt=attempt)
        if cuda:
            TRACE_WINDOWS.append(records)
        if records["spin_kernel"] or not cuda:
            break
        log("phase 12 (d): traced window without its spin kernel, tracing "
            "again: " + json.dumps(records))
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {"fps.pull": "fps.pull" in names, "fps.push": "fps.push" in names}
    if cuda:
        found["K5 gather_dim1"] = any("gather_dim1" in n for n in names)
        found["K4 dim1_*_pass"] = any(re.search(r"dim1_(tile|fold)_pass", n)
                                      for n in names)
    if not all(found.values()):
        raise AssertionError(f"phase 12 (d): the trace lacks "
                             f"{[k for k, v in found.items() if not v]}")
    out = {"trace": os.path.relpath(d, where), "found": found,
           "events": len(names), "window": records}
    log(f"phase 12 (d): obs.trace named {sorted(found)}; {json.dumps(out)}")
    return out


def p12_tools(obs_dirs, card):
    """(e): the reference's tools (stdlib-only) read the port's obs dirs:
    ``tools/obs_report.py`` and ``tools/trace_export.py`` each exit 0 and
    report the run's chunks (epochs)."""
    out = {}
    for label, d, kind, want in obs_dirs:
        rep = subprocess.run([sys.executable, os.path.join(
            ROOT, "tools", "obs_report.py"), d, "--json"],
            capture_output=True, text=True, timeout=120)
        tr = subprocess.run([sys.executable, os.path.join(
            ROOT, "tools", "trace_export.py"), d],
            capture_output=True, text=True, timeout=120)
        if rep.returncode != 0 or tr.returncode != 0:
            raise AssertionError(f"phase 12 (e), {label}: obs_report exit "
                                 f"{rep.returncode} ({rep.stderr[-500:]}), "
                                 f"trace_export exit {tr.returncode} "
                                 f"({tr.stderr[-500:]})")
        digest = json.loads(rep.stdout)
        spans = [e for e in json.loads(tr.stdout)["traceEvents"]
                 if e.get("name") == kind and e.get("ph") == "X"]
        key = kind + "s"
        if digest[key] != want or len(spans) != want:
            raise AssertionError(f"phase 12 (e), {label}: obs_report "
                                 f"{key} {digest[key]}, trace_export "
                                 f"{len(spans)} {kind} spans, {want} run")
        out[label] = {key: digest[key], "spans": len(spans),
                      "phase_seconds": sorted(digest["phase_seconds"]),
                      "checkpoint_saves": digest["checkpoint_saves"]}
    log(f"phase 12 (e): tools/obs_report.py and tools/trace_export.py read "
        f"the port's runs: {json.dumps(out)}")
    return out


def telemetry_phase(torch, fps, kernels, mf_data, lr_data, card,
                    dev="cuda:0"):
    """Phase 12: telemetry at phase 4's widths on ``dev``, every launch
    counter at 0 just before each run: (a) the recorder changes no table,
    launch or synchronising call, (b) health escalation and abort, (c) one
    stall, (d) the profiler trace, (e) the reference's tools, (f) the
    recorder's cost in turns."""
    import shutil
    import tempfile

    mesh = fps.make_ps_mesh(device=dev)
    t0 = time.perf_counter()
    where = tempfile.mkdtemp(prefix="chip_smoke_phase12_")
    try:
        chunks = p11_chunks(mf_data, P12["stream_chunks"],
                            P12["chunk_steps"])
        arms = p12_recorder_changes_nothing(torch, fps, kernels, mesh,
                                            mf_data, chunks, where, card)
        health = p12_health(torch, fps, kernels, mesh,
                            chunks[:P12["guard_chunks"]], where, card)
        stall = p12_stall(torch, fps, kernels, mesh,
                          chunks[:P12["stall_chunks"]], card)
        trace = p12_trace(torch, fps, kernels, mesh, lr_data, where, card)
        a_stream = [x for x in arms["fit_stream"] if x["turn"] == "A"][0]
        a_indexed = arms["run_indexed"][0]
        tools = p12_tools([
            ("fit_stream", a_stream["obs_dir"], "chunk", len(chunks)),
            ("run_indexed", a_indexed["obs_dir"], "epoch",
             P12["indexed_epochs"])], card)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    cost = {label: [{k: x[k] for k in ("turn", "ms_per_step",
                                       "steady_ms_per_step", "syncs",
                                       "sync_sites")}
                    for x in runs] for label, runs in arms.items()}
    for label, runs in cost.items():
        log(f"phase 12 (f), {label}: steady ms a step by turn "
            + ", ".join(f"{x['turn']} {x['steady_ms_per_step']:.4f}"
                        for x in runs) + f" (A: recorder on) ({card})")
    runs = []
    for label, xs in arms.items():
        for x in xs:
            runs.append({"path": f"phase 12, MF {x['label']}",
                         "steps": x["steps"], "seconds": x["seconds"],
                         "ms_per_step": x["ms_per_step"],
                         "launches": x["launches"],
                         "launches_per_step": {
                             k: v / x["steps"] for k, v in
                             x["launches"].items() if v},
                         "synchronising_calls": x["syncs"], "card": card})
    seconds = time.perf_counter() - t0
    out = {"runs": runs, "cost": cost, "health": health, "stall": stall,
           "trace": trace, "tools": tools,
           "phase_totals": {label: [x.get("phase_totals") for x in xs
                                    if x["turn"] == "A"]
                            for label, xs in arms.items()},
           "seconds": seconds, "card": card}
    log(f"phase 12 done in {seconds:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: serving while the card trains.
# ---------------------------------------------------------------------------

P13 = dict(chunks=14, chunk_steps=2, full_every=4, readers=3, quorum=2,
           poll_s=0.005, pull_ids=256, topk_users=64, k=20,
           converge_s=60.0, join_s=30.0)
# The training arms, in turns: with the fleet and its client (A) and
# without (B), the first A gated.
P13_TURNS = ("A", "B", "B", "A")


def p13_client(serve, host, port, others, fence, answers, errors, stop):
    """The query traffic: over one ``WireClient`` on reader 0's
    ``TcpServe``, pulls of ``P13["pull_ids"]`` item ids and ``topk`` of
    ``P13["topk_users"]`` users (k ``P13["k"]``) in turns until ``stop``,
    each pull's ids also pulled in process from the ``others`` readers;
    each answer with its reader, op, seconds, step, the fence read just
    after, and a pull's ids and rows."""
    rng = np.random.default_rng(13)
    try:
        with serve.WireClient(host, port, timeout=10.0,
                              deadline_s=10.0) as c:
            i = 0
            while not stop.is_set():
                if i % 2 == 0:
                    ids = rng.integers(0, ML20M_ITEMS, P13["pull_ids"])
                    req = {"op": "pull", "table": ITEM, "ids": ids.tolist()}
                else:
                    ids = rng.integers(0, ML20M_USERS, P13["topk_users"])
                    req = {"op": "topk", "users": ids.tolist(),
                           "k": P13["k"]}
                t0 = time.perf_counter()
                r = c.request(req)
                dt = time.perf_counter() - t0
                i += 1
                if not r["ok"]:
                    if r.get("retryable"):
                        time.sleep(0.001)  # nothing published yet
                        continue
                    errors.append(r)
                    return
                a = {"reader": "r0", "op": req["op"], "s": dt,
                     "step": r["step"], "fence": fence.read()}
                if req["op"] == "pull":
                    a["ids"] = ids
                    a["values"] = np.asarray(r["values"], np.float32)
                answers.append(a)
                if req["op"] != "pull":
                    continue
                for rd in others:
                    try:
                        step, values = rd.server.pull(ITEM, ids)
                    except serve.NoSnapshotError:
                        continue
                    answers.append({"reader": rd.reader_id, "op": "local",
                                    "step": step, "fence": fence.read(),
                                    "ids": ids, "values": values})
    except Exception as e:  # noqa: BLE001 — failed by the phase
        errors.append(repr(e))


def p13_quantiles(xs):
    xs = np.asarray(xs, np.float64)
    if not xs.size:
        raise AssertionError("phase 13: no sample to summarise")
    return {"p50": float(np.quantile(xs, 0.5)),
            "p99": float(np.quantile(xs, 0.99)), "n": int(xs.size)}


def p13_arm(torch, fps, kernels, mesh, index, turn, where, chunks, card):
    """One training arm: a fresh MF trainer at phase 11's width through
    ``fit_stream``, an ``AsyncCheckpointer`` with
    ``DeltaPolicy(full_every=P13["full_every"])`` publishing every chunk,
    the card's item rows read back after each chunk; with ``turn == "A"``
    a ``ServingFleet`` of ``P13["readers"]`` readers polling on threads, a
    ``TcpServe`` on reader 0 and a ``WireClient`` thread. Returns the arm
    and, for A, what the gates read."""
    import shutil
    import threading

    from fps_tpu_torch import serve
    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer, DeltaPolicy

    d = os.path.join(where, f"arm_{index}_{turn}")
    shutil.rmtree(d, ignore_errors=True)
    trainer, store = p11_mf(fps, mesh)
    tables, local = trainer.init_state(0)
    ck = AsyncCheckpointer(d, keep=64, delta=DeltaPolicy(
        full_every=P13["full_every"]))
    rows_at, stamps = {}, []

    def on_chunk(j, _metrics):
        # A copy: on the CPU ``.cpu()`` is the live table itself.
        rows_at[j + 1] = store.table(ITEM)[:ML20M_ITEMS].cpu().numpy().copy()
        stamps.append(time.perf_counter())

    fleet = tcp = None
    answers, errors, swaps, threads = [], [], [], []
    stop = threading.Event()
    if turn == "A":
        fleet = serve.ServingFleet(d, P13["readers"], quorum=P13["quorum"])
        for r in fleet.readers:
            def swap_to(snap, _r=r, _orig=r.server.swap_to):
                if snap is not None:
                    swaps.append((_r.reader_id, snap.step, time.time()))
                _orig(snap)
            r.server.swap_to = swap_to
        tcp = serve.TcpServe(fleet.readers[0].server, port=0).start()
        threads.append(threading.Thread(
            target=p13_client, name="p13-client",
            args=(serve, tcp.host, tcp.port, fleet.readers[1:],
                  serve.StepFence(d, "client"), answers, errors, stop)))
    steps = len(chunks) * P13["chunk_steps"]
    try:
        if fleet is not None:
            fleet.start(interval_s=P13["poll_s"])
        for t in threads:
            t.start()
        (tables, local, _), summary = p11_counted(
            torch, kernels, f"MF, fit_stream, a publish a chunk, turn "
            f"{index + 1} of {len(P13_TURNS)} ({turn})", steps, {"gather_rows": 2, "scatter_add": 2},
            lambda: trainer.fit_stream(tables, local, chunks, 1,
                                       checkpointer=ck, checkpoint_every=1,
                                       on_chunk=on_chunk), card, phase=13)
        converged = None
        if fleet is not None:
            deadline = time.monotonic() + P13["converge_s"]
            while {r.server._snap.step if r.server._snap else None
                   for r in fleet.readers} != {len(chunks)}:
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"phase 13: the fleet did not converge on step "
                        f"{len(chunks)}: {fleet.stats()}")
                time.sleep(0.01)
            converged = time.perf_counter()
            # A few answers at the converged step before the traffic stops.
            n = len(answers)
            while len(answers) < n + 4 and not errors and all(
                    t.is_alive() for t in threads):
                if time.perf_counter() - converged > P13["join_s"]:
                    break
                time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=P13["join_s"])
        if tcp is not None:
            tcp.close()
        if fleet is not None:
            fleet.stop(timeout=P13["join_s"])
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise AssertionError(f"phase 13: threads still running: {alive}")
    check_finite(torch, f"phase 13, turn {turn}", tables, local)
    per_chunk = np.diff(stamps) if len(stamps) > 1 else np.array(
        [summary["seconds"]])
    arm = {"turn": turn, "steps": steps, "seconds": summary["seconds"],
           "ms_per_step": summary["ms_per_step"],
           "steady_ms_per_step": float(np.median(per_chunk))
           / P13["chunk_steps"] * 1e3,
           "full_publishes": ck.full_publishes,
           "delta_publishes": ck.delta_publishes,
           "publish_bytes": ck.publish_bytes_total}
    seen = None
    if fleet is None:
        ck.close()
    if fleet is not None:
        if errors:
            raise AssertionError(f"phase 13: the client failed: {errors[:3]}")
        seen = {"dir": d, "fleet": fleet, "trainer": trainer,
                "store": store, "local": local, "tcp_answers": answers,
                "swaps": swaps, "rows_at": rows_at, "ck": ck,
                "tables": tables}
    return arm, summary, seen


def p13_gates(seen, chunks):
    """The gated A arm: every answer from a published step at or behind
    the fence, a pull's rows the card's at its step; the fleet converged
    on the last step serving the card's item rows and the exported user
    rows bit for bit, and a ``topk`` equal to the selection over them; a
    corrupted delta refused and never answered. Returns the readings."""
    from fps_tpu_torch import serve
    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.serve.server import ReadServer

    d, fleet, last = seen["dir"], seen["fleet"], len(chunks)
    pubs = fmt.publications(d)
    published = set(pubs)
    if published != set(range(1, last + 1)):
        raise AssertionError(f"phase 13: published {sorted(published)}")
    answers = seen["tcp_answers"]
    if not answers:
        raise AssertionError("phase 13: no answer while training")
    for a in answers:
        if a["step"] not in published:
            raise AssertionError(f"phase 13: an answer at step {a['step']}, "
                                 "never published")
        if a["fence"] is None or a["step"] > a["fence"][1]:
            raise AssertionError(f"phase 13: an answer at step {a['step']} "
                                 f"ahead of the fence {a['fence']}")
        if a["op"] in ("pull", "local"):
            want = seen["rows_at"][a["step"]][a["ids"]]
            if a["values"].tobytes() != want.tobytes():
                raise AssertionError(f"phase 13: a pull at step {a['step']}"
                                     " differs from the card's rows there")
    for r in fleet.readers:
        trail = r.served_steps
        if any(b < a for a, b in zip(trail, trail[1:])) or not set(
                trail) <= published:
            raise AssertionError(f"phase 13: reader {r.reader_id} served "
                                 f"{trail}")
    # Converged: the card's tables read back, and the exported users.
    items = seen["store"].table(ITEM)[:ML20M_ITEMS].cpu().numpy()
    users = np.asarray(seen["trainer"].logic.export_local_state(
        seen["local"]))
    rng = np.random.default_rng(14)
    uids = rng.integers(0, ML20M_USERS, P13["topk_users"])
    want_items, want_scores = ReadServer._topk_select(
        users[uids] @ items.T, P13["k"])
    for r in fleet.readers:
        if r.fence.read() != (0, last):
            raise AssertionError(f"phase 13: reader {r.reader_id}'s fence "
                                 f"{r.fence.read()}")
        step, got = r.server.pull(ITEM, np.arange(ML20M_ITEMS))
        if step != last or got.tobytes() != items.tobytes():
            raise AssertionError(f"phase 13: reader {r.reader_id} serves "
                                 f"items at {step} unlike the card's")
        snap = r.server.snapshot
        if np.asarray(serve.materialize(snap.local_state[0])).tobytes() \
                != users.tobytes():
            raise AssertionError(f"phase 13: reader {r.reader_id}'s user "
                                 "rows differ from the exported state")
        step, ids, scores = r.server.topk(uids, k=P13["k"])
        if (ids.tobytes() != want_items.tobytes()
                or scores.tobytes() != want_scores.tobytes()):
            raise AssertionError(f"phase 13: reader {r.reader_id}'s topk "
                                 "differs from the selection on the card's "
                                 "rows")
    return {"answers": len(answers),
            "answers_by_op": {op: sum(1 for a in answers if a["op"] == op)
                              for op in ("pull", "topk", "local")},
            "steps_answered": sorted({a["step"] for a in answers}),
            "served_steps": {r.reader_id: r.served_steps
                             for r in fleet.readers},
            "rejected": {r.reader_id: r.watcher.rejected
                         for r in fleet.readers}}


def p13_corrupt_delta(torch, fps, kernels, seen, extra, card):
    """One more chunk through ``fit_stream`` (the fleet's threads
    stopped), published as a delta of the last step, bit-flipped by the
    port's ``testing.chaos`` before any reader polls: ``open_chain`` and
    ``with_delta`` refuse it (``SnapshotRejected``), and the fleet, polled
    and queried over TCP, keeps answering from the last step."""
    from fps_tpu_torch import serve
    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.testing import chaos

    d, fleet, ck = seen["dir"], seen["fleet"], seen["ck"]
    trainer = seen["trainer"]
    last = max(fmt.publications(d))
    _, summary = p11_counted(
        torch, kernels, "MF, fit_stream, the corrupted delta's chunk",
        P13["chunk_steps"], {"gather_rows": 2, "scatter_add": 2},
        lambda: trainer.fit_stream(seen["tables"], seen["local"], [extra],
                                   1, checkpointer=ck, checkpoint_every=1,
                                   start_step=last), card, phase=13)
    ck.close()
    pub = fmt.publications(d).get(last + 1)
    if pub is None or pub.kind != "delta" or pub.base != last:
        raise AssertionError(f"phase 13: step {last + 1} published as "
                             f"{pub}, not a delta of {last}")
    chaos.bitflip_file(pub.path, nflips=8, seed=0)
    refused = []
    for what, fn in (
            ("open_chain", lambda: serve.ServableSnapshot.open_chain(
                d, last + 1)),
            ("with_delta", lambda: fleet.readers[0].server.snapshot
             .with_delta(pub.path))):
        try:
            fn()
        except serve.SnapshotRejected as e:
            refused.append(f"{what}: {e}")
            continue
        raise AssertionError(f"phase 13: {what} took the corrupted delta")
    for _ in range(3):
        fleet.poll()
    with serve.TcpServe(fleet.readers[0].server, port=0) as tcp, \
            serve.WireClient(tcp.host, tcp.port, timeout=10.0) as c:
        r = c.request({"op": "pull", "table": ITEM, "ids": [0, 1, 2]})
    for rd in fleet.readers:
        if (rd.server.snapshot.step != last or rd.fence.read() != (0, last)
                or last + 1 in rd.served_steps):
            raise AssertionError(f"phase 13: reader {rd.reader_id} moved "
                                 f"past {last}: {rd.served_steps}, fence "
                                 f"{rd.fence.read()}")
        if rd.watcher.rejected < 1:
            raise AssertionError(f"phase 13: reader {rd.reader_id} never "
                                 "counted the corrupted delta")
    if not (r["ok"] and r["step"] == last):
        raise AssertionError(f"phase 13: after the corrupted delta the "
                             f"server answered {r}")
    log(f"phase 13: the corrupted delta {os.path.basename(pub.path)} was "
        f"refused ({refused[0][:120]}...) and never answered ({card})")
    return {"delta": os.path.basename(pub.path), "refused": refused,
            "rejected": {rd.reader_id: rd.watcher.rejected
                         for rd in fleet.readers}}, summary


def p13_lags(seen):
    """Write→servable lag: each (reader, step) a reader swapped to, from
    the publication's mtime (its atomic rename of a finished file) to the
    swap's wall clock."""
    from fps_tpu_torch.core import snapshot_format as fmt

    pubs = fmt.publications(seen["dir"])
    first = {}
    for reader, step, t in seen["swaps"]:
        first.setdefault((reader, step), t)
    return [t - os.stat(pubs[step].path).st_mtime
            for (reader, step), t in first.items() if step in pubs]


def serving_phase(torch, fps, kernels, mf_data, card, dev="cuda:0"):
    """Phase 13: serving while the card trains. MF at phase 11's width on
    ``dev`` through ``fit_stream``, an ``AsyncCheckpointer`` with a
    ``DeltaPolicy`` publishing every chunk, in turns with a 3-reader
    ``ServingFleet`` (quorum 2), a ``TcpServe`` on reader 0 and a
    ``WireClient`` thread (A) and without them (B); the first A gated
    (:func:`p13_gates`), then a corrupted delta
    (:func:`p13_corrupt_delta`). Every launch counter at 0 just before
    each run."""
    import shutil
    import tempfile

    mesh = fps.make_ps_mesh(device=dev)
    t0 = time.perf_counter()
    where = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    chunks = p11_chunks(mf_data, P13["chunks"] + 1, P13["chunk_steps"])
    extra, chunks = chunks[-1], chunks[:-1]
    arms, runs = [], []
    gates = corrupt = lags = None
    try:
        for index, turn in enumerate(P13_TURNS):
            arm, summary, seen = p13_arm(torch, fps, kernels, mesh, index,
                                         turn, where, chunks, card)
            arms.append(arm)
            runs.append(summary)
            if seen is None:
                continue
            if gates is None:
                gates = p13_gates(seen, chunks)
                corrupt, summary = p13_corrupt_delta(torch, fps, kernels,
                                                     seen, extra, card)
                runs.append(summary)
                lags = p13_lags(seen)
                answers = seen["tcp_answers"]
            else:
                seen["ck"].close()
                lags += p13_lags(seen)
                answers += seen["tcp_answers"]
    finally:
        shutil.rmtree(where, ignore_errors=True)
    readings = {
        "write_to_servable_s": p13_quantiles(lags),
        "pull_s": p13_quantiles([a["s"] for a in answers
                                 if a["op"] == "pull"]),
        "topk_s": p13_quantiles([a["s"] for a in answers
                                 if a["op"] == "topk"]),
        "steady_ms_per_step_by_turn": [
            [a["turn"], a["steady_ms_per_step"]] for a in arms],
        "ms_per_step_by_turn": [[a["turn"], a["ms_per_step"]]
                                for a in arms]}
    seconds = time.perf_counter() - t0
    log(f"phase 13: write->servable {readings['write_to_servable_s']} s; "
        f"pull {readings['pull_s']} s; topk {readings['topk_s']} s; "
        "steady ms a step by turn (A: the fleet on) "
        + ", ".join(f"{t} {ms:.4f}" for t, ms in
                    readings["steady_ms_per_step_by_turn"]) + f" ({card})")
    log(f"phase 13 done in {seconds:.1f} s")
    return {"runs": runs, "arms": arms, "gates": gates,
            "corrupted_delta": corrupt, "readings": readings,
            "seconds": seconds, "card": card}


P14 = dict(nf=1_000_000, stall_s=6.0, grace_s=120.0, timeout=400,
           mf_stall_s=60.0)


def p14_first_beats(state_dir):
    """Each attempt's start-to-first-beat seconds, from the supervisor's
    journal (``attempt_first_signal``)."""
    out = []
    path = os.path.join(state_dir, "journal-supervisor.jsonl")
    with open(path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "attempt_first_signal":
                out.append(rec["t_rel_s"])
    return out


def p14_children(label, detail, dev, pushes=("scatter_add_dim1",)):
    """The gates on every child of a scenario on the card: each attempt
    that started ran on ``dev`` and only loaded the library built by this
    process; the straight and the last attempt launched K5 and one of
    ``pushes`` (K4; a tier's pushes may go to K2 or K3). Returns their
    launch counts as two runs of the JSON line."""
    starts = detail["attempt_starts"]
    for i, st in enumerate(starts):
        if not st:
            continue  # an attempt that died before its first line
        if st.get("device") != dev or st.get("build_cached") is not True:
            raise AssertionError(f"{label}: attempt {i} started "
                                 f"on {st.get('device')} (library cached: "
                                 f"{st.get('build_cached')})")
    runs = []
    for which, counts in (("straight", detail["straight_launches"]),
                          ("supervised, last attempt", detail["launches"])):
        if not counts or not (counts["gather_rows_dim1"] > 0
                              and any(counts[k] > 0 for k in pushes)):
            raise AssertionError(f"{label}, {which}: K5 / {pushes} "
                                 f"launches {counts}")
        runs.append({"path": f"{label}, {which} (child process)",
                     "launches": counts})
    return runs


def p14_mf(where, dev, card):
    """(d): the MF example at ML-20M width under the CLI, its heartbeat
    from the env contract. One attempt, success, and the heartbeat's last
    record names a driver sub-phase."""
    from fps_tpu_torch.testing import supervised_demo as sd

    state = os.path.join(where, "d")
    argv = sd.supervise_cmd(state, stall_timeout_s=P14["mf_stall_s"],
                            startup_grace_s=P14["grace_s"]) + [
        sys.executable, "-m", "fps_tpu_torch.examples.mf", "--scale", "20m",
        "--local-batch", "32768", "--combine", "mean", "--learning-rate",
        "0.1", "--epochs", "1", "--device", dev]
    rc, digest, tail = sd.run_supervisor(argv, state, env=sd._env(dev),
                                         timeout=P14["timeout"])
    if digest is None or rc != 0 or not digest.get("success") or (
            digest.get("attempts") != 1):
        raise AssertionError(f"phase 14 (d): rc {rc}, digest {digest}:\n"
                             f"{tail[-3000:]}")
    with open(os.path.join(state, "heartbeat.json"), encoding="utf-8") as f:
        beat = json.load(f)
    if beat.get("phase") not in ("prefetch", "ingest", "dispatch"):
        raise AssertionError(f"phase 14 (d): the last beat {beat} names no "
                             "driver sub-phase")
    with open(os.path.join(state, "attempt-0.log"), encoding="utf-8") as f:
        done = [json.loads(line) for line in f
                if line.startswith('{"event": "done"')]
    return {"digest": {k: digest.get(k) for k in
                       ("success", "attempts", "restarts", "wall_s")},
            "last_beat": {k: beat.get(k) for k in ("index", "phase")},
            "done": done[-1] if done else None,
            "first_beat_s": p14_first_beats(state)}


def supervise_phase(torch, card, dev="cuda:0"):
    """Phase 14: the supervisor drives training on the card. Four jobs at
    once, each under the port's supervisor CLI run with torch and jax
    unimportable: (a) the SIGSTOP-wedged logistic regression at 1M
    features, (b) the deterministic crash and its quarantine, (c) the
    megastep killed at megastep 3 (both at 1M features), (d) the MF example
    at ML-20M width. Every child only loads the library this process
    built. Nothing is caught: a failed gate fails the script."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from fps_tpu_torch.testing import supervised_demo as sd

    t0 = time.perf_counter()
    where = tempfile.mkdtemp(prefix="chip_smoke_phase14_")
    demo = ("--num-features", str(P14["nf"]))
    kw = dict(device=dev, demo_args=demo, timeout=P14["timeout"],
              startup_grace_s=P14["grace_s"])
    jobs = {
        "(a) wedge": lambda: sd.run_supervised_scenario(
            os.path.join(where, "a"), stall_timeout_s=P14["stall_s"], **kw),
        "(b) crash": lambda: sd.run_crash_quarantine_scenario(
            os.path.join(where, "b"), **kw),
        "(c) megastep": lambda: sd.run_megastep_kill_scenario(
            os.path.join(where, "c"), **kw),
        "(d) mf": lambda: p14_mf(where, dev, card),
    }
    runs, report = [], {}
    try:
        for sub in "abc":
            os.makedirs(os.path.join(where, sub))
        with ThreadPoolExecutor(len(jobs)) as ex:
            futures = {k: ex.submit(fn) for k, fn in jobs.items()}
            results = {k: f.result() for k, f in futures.items()}
        for label in ("(a) wedge", "(b) crash", "(c) megastep"):
            ok, detail = results[label]
            if not ok:
                raise AssertionError(f"phase 14 {label}: "
                                     f"{json.dumps(detail)}")
            runs += p14_children(f"phase 14 {label}", detail, dev)
            report[label] = {
                "supervisor": detail["supervisor"],
                "restored_step": detail["restored_step"],
                "time_to_recovered_s": detail["time_to_recovered_s"],
                "first_beat_s": p14_first_beats(
                    os.path.join(where, label[1], "sup")),
                "mem_free_gib_at_start": [
                    round(st["mem_free_bytes"] / 2**30, 3)
                    for st in detail["attempt_starts"] if st],
                **{k: detail[k] for k in ("attempt_codes",
                                          "quarantine_carried", "skipped")
                   if k in detail}}
        report["(d) mf"] = results["(d) mf"]
    finally:
        shutil.rmtree(where, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for label, r in report.items():
        log(f"phase 14 {label}: {json.dumps(r)} ({card})")
    log(f"phase 14: time to recovered (a) "
        f"{report['(a) wedge']['time_to_recovered_s']} s, (c) "
        f"{report['(c) megastep']['time_to_recovered_s']} s; start to "
        f"first beat {[r['first_beat_s'] for r in report.values()]} s; "
        f"done in {seconds:.1f} s ({card})")
    return {"runs": runs, "report": report, "seconds": seconds,
            "card": card}


P15 = dict(nf=1_000_000, stall_s=20.0, grace_s=120.0, timeout=400)


def p15_first_chunks(member_dir):
    """Each attempt's start-to-first-chunk seconds in a pod member's dir:
    its supervisor journal's ``attempt_start`` to the first ``chunk`` event
    after it in the child's run journals (PodMember journals no first
    signal). ``None`` for an attempt that trained no chunk."""
    from fps_tpu_torch.testing.supervised_demo import _jsonl

    starts = [r["t"] for r in _jsonl(os.path.join(
        member_dir, "journal-supervisor.jsonl"))
        if r.get("event") == "attempt_start"]
    chunks = sorted(r["t"] for p in sorted(os.listdir(member_dir))
                    if p.startswith("journal-p") and p.endswith(".jsonl")
                    for r in _jsonl(os.path.join(member_dir, p))
                    if r.get("event") == "chunk")
    out = []
    for i, t in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else float("inf")
        first = [c for c in chunks if t <= c < end]
        out.append(round(first[0] - t, 3) if first else None)
    return out


def p15_children(label, children, ref_launches, ref_name, dev):
    """The gates on every child of a pod or tenant scenario on the card:
    each attempt that started ran on ``dev`` and only loaded the library
    this process built; every member's (tenant's) last attempt and the
    straight (solo) run launched K4 and K5. Returns their launch counts
    as runs of the JSON line."""
    runs = []
    for who, ch in children.items():
        for i, st in enumerate(ch["attempt_starts"]):
            if not st:
                continue  # an attempt that died before its first line
            if (st.get("device") != dev
                    or st.get("build_cached") is not True):
                raise AssertionError(
                    f"phase 15 {label}: {who} attempt {i} started on "
                    f"{st.get('device')} (library cached: "
                    f"{st.get('build_cached')})")
    for who, counts in [(ref_name, ref_launches)] + [
            (f"{who}, last attempt", ch["meta"].get("launches"))
            for who, ch in children.items()]:
        if not counts or not (counts["gather_rows_dim1"] > 0
                              and counts["scatter_add_dim1"] > 0):
            raise AssertionError(f"phase 15 {label}, {who}: K5 / K4 "
                                 f"launches {counts}")
        runs.append({"path": f"phase 15 {label}, {who} (child process)",
                     "launches": counts})
    return runs


def p15_free_gib(children):
    return {who: [round(st["mem_free_bytes"] / 2**30, 3)
                  for st in ch["attempt_starts"] if st]
            for who, ch in children.items()}


def pod_phase(torch, card, dev="cuda:0"):
    """Phase 15: a pod and two tenants train on the card, one after
    another: (a) a three-member pod whose member h1's child is SIGKILLed
    after chunk 3, (b) the elastic W -> W-1 -> W cycle (a non-leader host's
    agent and child SIGKILLed, evicted at world 2, relaunched and
    re-admitted), (c) two tenants under a TenantManager, tenant a crashing
    at chunk 3 on every attempt. Every child trains the demo's logistic
    regression at 1M features on ``dev`` and only loads the library this
    process built; every member agent and the tenants' manager run with
    torch and jax unimportable. Nothing is caught: a failed gate fails the
    script."""
    import shutil
    import tempfile

    from fps_tpu_torch.obs import fleet
    from fps_tpu_torch.testing import supervised_demo as sd
    from fps_tpu_torch.testing import tenant_demo as td

    t0 = time.perf_counter()
    where = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    demo = ("--num-features", str(P15["nf"]))
    kw = dict(device=dev, demo_args=demo, timeout=P15["timeout"],
              stall_timeout_s=P15["stall_s"], startup_grace_s=P15["grace_s"])
    hosts = sd.SCENARIO_POD_HOSTS
    runs, report = [], {}
    try:
        for sub, label, fn in (
                ("a", "(a) kill one host", sd.run_pod_kill_one_host_scenario),
                ("b", "(b) elastic", sd.run_pod_elastic_resize_scenario)):
            t = time.perf_counter()
            ok, detail = fn(os.path.join(where, sub), **kw)
            seconds = time.perf_counter() - t
            if not ok:
                raise AssertionError(f"phase 15 {label}: "
                                     f"{json.dumps(detail, default=str)}")
            runs += p15_children(label, detail["children"],
                                 detail["straight_launches"], "straight",
                                 dev)
            pod_dir = os.path.join(where, sub, "pod")
            report[label] = {
                "digests": detail["digests"],
                "time_to_recovered_s": detail["time_to_recovered_s"],
                "start_to_first_chunk_s": {
                    h: p15_first_chunks(os.path.join(pod_dir, h))
                    for h in hosts},
                "mem_free_gib_at_start": p15_free_gib(detail["children"]),
                "lease_seizures": detail["lease_seizures"],
                "seconds": round(seconds, 3),
                **{k: detail[k] for k in ("victim", "kill_to_eviction_s",
                                          "victim_restored_step")
                   if k in detail}}
            if "trace" in detail:
                report[label]["restart_trees"] = detail["trace"][
                    "restart_trees"]
        label = "(c) tenants"
        t = time.perf_counter()
        ok, detail = td.run_tenant_poison_isolation_scenario(
            os.path.join(where, "c"), **kw)
        seconds = time.perf_counter() - t
        if not ok:
            raise AssertionError(f"phase 15 {label}: "
                                 f"{json.dumps(detail, default=str)}")
        runs += p15_children(label, detail["children"],
                             detail["solo_launches"], "solo", dev)
        root = os.path.join(where, "c", "pod")
        tenants = fleet.tenant_fleet_digest(root)["tenants"]
        if sorted(tenants) != [td.TENANT_INJECTED, td.TENANT_NEIGHBOR]:
            raise AssertionError(f"phase 15 {label}: tenant_fleet_digest "
                                 f"reports {sorted(tenants)}")
        report[label] = {
            **{k: detail[k] for k in ("injected", "neighbor",
                                      "injected_skipped", "fence_epochs",
                                      "recovery", "time_to_recovered_s")},
            "audit_files": detail["namespace_audit"]["per_tenant"],
            "fleet_recovery": {n: tenants[n]["recovery"]["count"]
                               for n in sorted(tenants)},
            "start_to_first_beat_s": {
                n: p14_first_beats(os.path.join(root, "tenants", n,
                                                "state"))
                for n in (td.TENANT_INJECTED, td.TENANT_NEIGHBOR)},
            "mem_free_gib_at_start": p15_free_gib(detail["children"]),
            "seconds": round(seconds, 3)}
    finally:
        shutil.rmtree(where, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for label, r in report.items():
        log(f"phase 15 {label}: {json.dumps(r)} ({card})")
    log(f"phase 15: time to recovered "
        f"{[r['time_to_recovered_s'] for r in report.values()]} s, lease "
        f"seizures {[r.get('lease_seizures') for r in report.values()]}; "
        f"done in {seconds:.1f} s ({card})")
    return {"runs": runs, "report": report, "seconds": seconds,
            "card": card}


# Phase 16: the program auditor on the card. (a) one chunk of MF at the
# bench's width on one position, its data made here (BATCH * P16_STEPS *
# P16_CHUNKS ratings over ML-20M's users and items); (e) the audit's MF row
# (fps_tpu_torch/examples/audit_programs.py) on (1, 8) for P16_DRIFT_CHUNKS
# chunks.
P16_STEPS, P16_CHUNKS, P16_DRIFT_CHUNKS = 4, 2, 3
P16_KS = (4, 16)


def p16_keep_records(analysis):
    """A strict auditor that keeps each certified program's record."""
    class Keep(analysis.ProgramAuditor):
        def __init__(self):
            super().__init__(strict=True)
            self.records = []

        def certify(self, program, text, **kw):
            self.records.append(text)
            return super().certify(program, text, **kw)

    return Keep()


def p16_mf(torch, fps, kernels, analysis, card):
    """(a): MF at full width, one chunk with ``Trainer(audit="strict")``
    against the same chunk unaudited, each from fresh state after an
    untimed warm-up. Gates: the certificate is clean; the record's kernel
    entries equal the launch counters' deltas over the call; its host
    transfers equal the synchronising calls ``SyncCount`` sees over the
    call; the tables and launches equal the unaudited call's."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    mesh = fps.make_ps_mesh()
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01)
    data = synthetic_ratings(ML20M_USERS, ML20M_ITEMS,
                             BATCH * P16_STEPS * P16_CHUNKS, seed=16)
    chunk = next(iter(epoch_chunks(data, num_workers=1, local_batch=BATCH,
                                   steps_per_chunk=P16_STEPS,
                                   route_key="user", seed=0)))

    def call(audit):
        trainer, _ = fps.online_mf(mesh, cfg, combine="mean")
        trainer.audit = audit
        tables, local = trainer.init_state(0)
        placed = trainer._place_chunk(chunk)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with SyncCount(torch) as syncs:
            t0 = time.perf_counter()
            out = trainer.run_chunk(tables, local, placed, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return trainer, out, kernels.launch_counts(), syncs, ms

    call(None)  # warm-up: the kernels' plans, the allocator
    _, plain, plain_launches, _, plain_ms = call(None)
    auditor = p16_keep_records(analysis)
    trainer, audited, launches, syncs, audited_ms = call(auditor)
    [cert] = auditor.certificates
    [rec] = auditor.records
    if not cert.ok:
        raise AssertionError(f"phase 16 (a): {cert.to_json()}")
    want = {k: v for k, v in launches.items() if v}
    if rec.kernel_counts() != want:
        raise AssertionError(f"phase 16 (a): the record's kernels "
                             f"{rec.kernel_counts()} != the launch "
                             f"counters' {want}")
    if rec.host_reads() != syncs.calls:
        raise AssertionError(
            f"phase 16 (a): the record's host transfers "
            f"{[(op.site, op.custom_target, op.count) for op in rec.host_transfers()]}"
            f" != the synchronising calls {syncs.sites} "
            f"{list(syncs.stacks.values())[:2]}")
    if launches != plain_launches:
        raise AssertionError(f"phase 16 (a): audited launches {launches} "
                             f"!= unaudited {plain_launches}")
    for name in plain[0]:
        for a, b in zip(plain[0][name], audited[0][name]):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 16 (a): table {name} differs "
                                     "with the auditor on")
    # The host-transfer check made non-vacuous: a step tap that reads one
    # value back a step, under a recording (not strict) auditor.
    def read_back(tables, batch, state, t):
        total = batch["rating"].sum()
        total.item()
        return {"total": total}

    probe = p16_keep_records(analysis)
    probe.strict = False
    probe_trainer, _ = fps.online_mf(mesh, cfg, combine="mean")
    probe_trainer.config = dataclasses.replace(probe_trainer.config,
                                               step_tap=read_back)
    probe_trainer.audit = probe
    tables, local = probe_trainer.init_state(0)
    placed = probe_trainer._place_chunk(chunk)
    torch.cuda.synchronize()
    with SyncCount(torch) as probe_syncs:
        probe_trainer.run_chunk(tables, local, placed, 1)
    torch.cuda.synchronize()
    [probe_rec] = probe.records
    fired = {v.pass_name for v in probe.certificates[0].violations}
    if not (probe_rec.host_reads() == probe_syncs.calls == P16_STEPS
            and fired == {"host_transfer"}):
        raise AssertionError(
            f"phase 16 (a), read-back tap: the record's host transfers "
            f"{probe_rec.host_reads()}, the synchronising calls "
            f"{probe_syncs.calls} {probe_syncs.sites}, expected "
            f"{P16_STEPS} each; passes fired {fired}")
    out = {"program": cert.program, "ok": cert.ok,
           "collectives": cert.collective_count,
           "read_back_tap": {"host_reads": probe_rec.host_reads(),
                             "sync_calls": probe_syncs.calls},
           "kernels": rec.kernel_counts(), "host_reads": rec.host_reads(),
           "sync_calls": syncs.calls, "audited_first_call_ms": audited_ms,
           "plain_call_ms": plain_ms, "steps": P16_STEPS,
           "batch": BATCH, "launches": launches}
    log(f"phase 16 (a): MF {ML20M_USERS}x{ML20M_ITEMS} rank {RANK}, batch "
        f"{BATCH}, {P16_STEPS} steps: certified {cert.ok}, kernels "
        f"{rec.kernel_counts()} = launch counters, host reads "
        f"{rec.host_reads()} = sync calls {syncs.calls} (a read-back tap: "
        f"{probe_rec.host_reads()} = {probe_syncs.calls}), tables bit-equal "
        f"({card})")
    log(f"phase 16 (a): audited first call {audited_ms:.1f} ms, plain call "
        f"{plain_ms:.1f} ms ({card})")
    return out, dict(path="auditor (a): MF, audited first call",
                     launches=launches)


def p16_tiered(torch, fps, analysis, card):
    """(b): phase 9's tiered MF at (2, 4) on the card (head 2,048 of 4,096,
    lanes of 256, gathered cold routes): its record certifies, the
    reconcile's reduce-scatter over the shard groups in the census."""
    from fps_tpu_torch.analysis.passes import RECONCILE_SITES
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    trainer, store = tier_mf(fps, mesh, TIER_H, TIER_C, True, None)
    data = ds.zipf_ratings(TIER_NU, TIER_NI, D * S * TIER_LOCAL * TIER_SPC,
                           seed=0)
    chunk = tier_chunks(data, D * S, None)[0]
    rec = analysis.ProgramRecord.from_text(trainer.lowered_chunk_text(chunk))
    cert = analysis.certify(rec, analysis.contract_for_trainer(trainer))
    head = TIER_H * TIER_RANK * 4
    reconcile = [op for op in rec.collectives()
                 if op.kind == "reduce_scatter" and op.group_size == S
                 and op.site_function in RECONCILE_SITES
                 and op.payload_bytes >= head]
    if not cert.ok or not reconcile:
        raise AssertionError(f"phase 16 (b): certified {cert.ok} "
                             f"{[v.summary for v in cert.violations]}, "
                             f"reconcile in the census: {len(reconcile)}")
    log(f"phase 16 (b): tiered MF at {D}x{S}: replica_consistency "
        f"certified, the reconcile's reduce_scatter of "
        f"{reconcile[0].payload_bytes} B >= {head} B over groups of {S}; "
        f"{cert.collective_count} collectives {cert.per_kind()} ({card})")
    return {"program": rec.program, "ok": cert.ok,
            "per_kind": cert.per_kind(),
            "reconcile_bytes": reconcile[0].payload_bytes}


def p16_megastep(torch, fps, analysis, card):
    """(c): phase 9's megastep at (2, 4) with a tick every 2 segments: the
    records of K = 4 and K = 16 certify, with equal censuses."""
    from fps_tpu_torch.tiering import MegastepTick
    from fps_tpu_torch.utils import datasets as ds

    D, S = TIER_MESH
    W = D * S
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    data = ds.zipf_ratings(TIER_NU, TIER_NI,
                           W * MEGA_LOCAL * MEGA_SPC * MEGA_CHUNKS, seed=0)
    census, out = [], {}
    for K in P16_KS:
        trainer, _, plan = mega_mf(
            fps, mesh, data, TIER_H, MEGA_C, TIER_E, nu=TIER_NU,
            ni=TIER_NI, rank=TIER_RANK, lr=TIER_LR, local=MEGA_LOCAL,
            spc=MEGA_SPC)
        text = trainer.lowered_megastep_text(
            plan, chunks_per_dispatch=K,
            tick=MegastepTick(check_every=MEGA_CHECK))
        cert = analysis.certify(text, analysis.contract_for_trainer(
            trainer, program="megastep"))
        if not cert.ok:
            raise AssertionError(f"phase 16 (c), K {K}: "
                                 f"{[v.summary for v in cert.violations]}")
        census.append(sorted((c.kind, c.payload_bytes)
                             for c in cert.collectives))
        out[f"K{K}"] = {"collectives": cert.collective_count,
                        "bytes": cert.collective_bytes,
                        "host_reads": analysis.ProgramRecord.from_text(
                            text).host_reads()}
    if census[0] != census[1]:
        raise AssertionError(f"phase 16 (c): census K {P16_KS[0]} "
                             f"{census[0]} != K {P16_KS[1]} {census[1]}")
    log(f"phase 16 (c): megastep K {P16_KS[0]} and K {P16_KS[1]}: equal "
        f"censuses of {len(census[0])} collectives, certified ({card})")
    return out


def p16_logreg(torch, fps, lr_data, analysis, card):
    """(d): SSP logistic regression at 1,000,000 features on one position
    (K5 pulls, K4 pushes): its record certifies."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    mesh = fps.make_ps_mesh()
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                           dense_features=LR_DENSE)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    chunk = next(iter(multi_epoch_chunks(
        lr_data, 1, num_workers=1, local_batch=SPARSE_BATCH,
        steps_per_chunk=16, sync_every=8, seed=1)))
    rec = analysis.ProgramRecord.from_text(
        trainer.lowered_chunk_text(chunk, "ssp"))
    cert = analysis.certify(rec, analysis.contract_for_trainer(trainer,
                                                               "ssp"))
    kernels = rec.kernel_counts()
    if not cert.ok or not (kernels.get("gather_rows_dim1")
                           and kernels.get("scatter_add_dim1")):
        raise AssertionError(f"phase 16 (d): certified {cert.ok} "
                             f"{[v.summary for v in cert.violations]}, "
                             f"kernels {kernels}")
    log(f"phase 16 (d): SSP logreg at {LR_NF} features: certified, kernels "
        f"{kernels} ({card})")
    return {"program": rec.program, "ok": cert.ok, "kernels": kernels}


def p16_drift(torch, fps, card):
    """(e): the drift detector pinned to the port's BUDGETS over the audit's
    MF row run on the card at (1, 8) (every position on cuda:0), chunk by
    chunk with a recorder: quiet; then the pinned bytes halved: exactly one
    ``budget_drift`` incident."""
    import copy

    from fps_tpu_torch.examples import audit_programs as ap
    from fps_tpu_torch.obs.drift import BudgetDriftDetector

    mesh = fps.make_ps_mesh(8, 1, device="cuda:0")
    trainer, chunks = ap._mf_pieces(mesh)
    chunks = list(chunks)[:P16_DRIFT_CHUNKS]
    mem = fps.obs.MemorySink()
    rec = fps.obs.Recorder(sinks=[mem])
    trainer.recorder = rec
    det = BudgetDriftDetector(ap.pinned_budgets(), recorder=rec)
    tables, local = trainer.init_state(0)
    for i, chunk in enumerate(chunks):
        tables, local, _ = trainer.fit_stream(tables, local, iter([chunk]),
                                              i)
        det.observe_trainer_chunk(trainer, chunk, program="mf", chunks=1)
    reports = det.evaluate()
    if not all(r.ok for r in reports) or mem.events("budget_drift"):
        raise AssertionError(f"phase 16 (e): not quiet: "
                             f"{[r.to_json() for r in reports]}")
    pinned = copy.deepcopy(ap.pinned_budgets())
    pinned["mf"]["bytes"] //= 2
    mem2 = fps.obs.MemorySink()
    det2 = BudgetDriftDetector(pinned,
                               recorder=fps.obs.Recorder(sinks=[mem2]))
    det2.observe_trainer_chunk(trainer, chunks[0], program="mf",
                               chunks=len(chunks))
    det2.evaluate()
    incidents = mem2.events("budget_drift")
    if len(incidents) != 1:
        raise AssertionError(f"phase 16 (e): {len(incidents)} incidents "
                             "after the seeded mutation, expected 1")
    log(f"phase 16 (e): drift quiet over {len(chunks)} chunks of the audit's "
        f"MF at 1x8 (ratios {[r.byte_ratio for r in reports]}); the seeded "
        f"mutation raised 1 incident, ratio {incidents[0]['byte_ratio']} "
        f"({card})")
    return {"chunks": len(chunks), "ratios": [r.byte_ratio for r in reports],
            "mutation_incidents": len(incidents),
            "mutation_ratio": incidents[0]["byte_ratio"]}


def audit_phase(torch, fps, kernels, lr_data, card):
    """Phase 16: the program auditor on the card, (a)-(e). Nothing is
    caught: a failed gate fails the script."""
    from fps_tpu_torch import analysis

    t0 = time.perf_counter()
    a, run = p16_mf(torch, fps, kernels, analysis, card)
    out = {"mf": a,
           "tiered": p16_tiered(torch, fps, analysis, card),
           "megastep": p16_megastep(torch, fps, analysis, card),
           "logreg": p16_logreg(torch, fps, lr_data, analysis, card),
           "drift": p16_drift(torch, fps, card),
           "runs": [run]}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16: {out['seconds']:.1f} s ({card})")
    return out


# Phase 17: the chaos sweep, the native host library and the planner's
# command line on the card.
P17_SWEEP = ("nan_mask", "inf_mask", "huge_norm_mask", "observe_rollback",
             "ckpt_truncate", "ckpt_bitflip", "tmp_sweep", "prefetch_kill",
             "hot_tier_kill", "retier_kill", "reconcile_shard_kill")
P17_KILLS = P17_SWEEP[7:]
# A tier's pushes go to its replica's buffer (K2, K3) or the table (K4).
P17_PUSHES = ("scatter_add_dim1", "scatter_add", "scatter_add_packed")
P17_TIMEOUT_S = 240.0  # a scenario's bound (--timeout-s)
P17_SHARDS = 2
P17_PLAN_TABLES = ("item_factors:26744:10", "user_factors:138493:10")


def p17_sweep(card, dev="cuda:0"):
    """(a): two sweep processes at once, one a shard; their digests gated.
    Returns the children's launch counts as runs of the JSON line and the
    report."""
    import shutil
    import signal
    import tempfile

    where = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    procs = {}
    t0 = time.perf_counter()
    try:
        for k in range(1, P17_SHARDS + 1):
            with open(os.path.join(where, f"{k}.out"), "w") as out, \
                    open(os.path.join(where, f"{k}.err"), "w") as err:
                procs[k] = subprocess.Popen(
                    [sys.executable, "-m", "fps_tpu_torch.examples.chaos_sweep",
                     "--only", ",".join(P17_SWEEP), "--shard",
                     f"{k}/{P17_SHARDS}", "--timeout-s", str(P17_TIMEOUT_S)],
                    cwd=ROOT, stdout=out, stderr=err,
                    start_new_session=True)
        seconds = {}
        for k, proc in procs.items():
            proc.wait(timeout=P17_TIMEOUT_S * len(P17_SWEEP))
            seconds[k] = time.perf_counter() - t0
        digests = {}
        for k, proc in procs.items():
            with open(os.path.join(where, f"{k}.out")) as f:
                lines = f.read().strip().splitlines()
            with open(os.path.join(where, f"{k}.err")) as f:
                tail = f.read()[-3000:]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"phase 17 (a) shard {k}/{P17_SHARDS}: "
                                     f"exit {proc.returncode}\n{tail}")
            digests[k] = json.loads(lines[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(where, ignore_errors=True)
    ran = [n for d in digests.values() for n in d["chaos_sweep"]]
    if sorted(ran) != sorted(P17_SWEEP):
        raise AssertionError(f"phase 17 (a): the shards ran {ran}")
    runs, report = [], {}
    for k, d in digests.items():
        label = f"phase 17 (a) shard {k}/{P17_SHARDS}"
        cert = d["program_certificate"]
        if (d["failed"] or d["survived"] != d["total"]
                or not (cert and cert["ok"])
                or d["recovery_slo"]["breaches"] or d["device"] != dev
                or d["mesh"] != {"data": 1, "shard": 8}):
            raise AssertionError(f"{label}: {json.dumps(d)}")
        for name in d["chaos_sweep"]:
            if name in P17_KILLS:
                runs += p14_children(f"{label} {name}", d["detail"][name],
                                     dev, pushes=P17_PUSHES)
        report[f"shard {k}/{P17_SHARDS}"] = {
            "scenarios": list(d["chaos_sweep"]),
            "survived": d["survived"], "total": d["total"],
            "time_to_recovered_s": d["time_to_recovered_s"],
            "certificate": cert["collectives"]["per_kind"],
            "clean_test_acc": d["clean_test_acc"],
            "seconds": seconds[k]}
    log(f"phase 17 (a): {json.dumps(report)} ({card})")
    return runs, report


def p17_native(torch, fps, kernels, tokens, uni, card):
    """(b): the native library builds and loads; its pair stream's first
    chunk trains the pair worker through ``fit_stream`` (counters at 0
    just before, K1 2 and K2 2 a step); the stream's pairs a second, native
    and numpy."""
    from fps_tpu_torch import native
    from fps_tpu_torch.models import word2vec as w2v

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 17 (b): fps_tpu_torch.native did not "
                             "build or load (g++)")
    build_s = time.perf_counter() - t0
    cfg = w2v_config(fps)
    kw = dict(num_workers=1, local_batch=2 * cfg.window * W2V_BLOCK,
              steps_per_chunk=W2V_PAIR_STEPS, seed=1)
    rates = {}
    for use_native in (True, False):
        t0 = time.perf_counter()
        pairs = chunks = 0
        for c in w2v.skipgram_chunks(tokens, uni, cfg, use_native=use_native,
                                     **kw):
            pairs += float(c["weight"].sum())
            chunks += 1
        dt = time.perf_counter() - t0
        rates["native" if use_native else "numpy"] = {
            "pairs": pairs, "chunks": chunks, "seconds": dt,
            "pairs_per_s": pairs / dt}
    first = next(w2v.skipgram_chunks(tokens, uni, cfg, use_native=True,
                                     **kw))

    def quality(metrics):
        n = float(sum(m["n"].sum() for m in metrics))
        loss = float(sum(m["loss"].sum() for m in metrics)) / max(n, 1.0)
        if not (np.isfinite(loss) and n > 0):
            raise AssertionError(f"phase 17 (b): loss a pair {loss} over "
                                 f"{n} pairs")
        return {"loss_per_pair": loss, "pairs": n}

    trainer, _ = fps.word2vec(fps.make_ps_mesh(), cfg, uni)
    run = run_path(torch, kernels, "w2v pairs, native skipgram_chunks, "
                   "fit_stream", trainer, [first],
                   {"gather_rows": 2, "scatter_add": 2}, quality, card)
    report = {"library": os.path.relpath(native.library_path(), ROOT),
              "build_or_load_seconds": build_s, "pair_rates": rates}
    log(f"phase 17 (b): {json.dumps(report)} ({card})")
    return run, report


def p17_plan(card):
    """(c): the planner's command line over ML-20M's two MF tables on the
    card and on the CPU; the recorded budgets equal."""
    import contextlib
    import io

    from fps_tpu_torch.examples import plan as plan_cli

    outs, seconds = {}, {}
    for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        argv = [a for t in P17_PLAN_TABLES for a in ("--table", t)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = plan_cli.main(argv + ["--json"] + extra)
        seconds[where] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"phase 17 (c), {where}: exit {rc}")
        outs[where] = json.loads(buf.getvalue().strip().splitlines()[-1])
    if outs["card"] != outs["cpu"]:
        raise AssertionError(f"phase 17 (c): the card's plan "
                             f"{json.dumps(outs['card'])} differs from the "
                             f"CPU's {json.dumps(outs['cpu'])}")
    report = {k: outs["card"][k] for k in ("predicted", "untiered_baseline",
                                           "hot_sync_every", "mesh")}
    report["seconds"] = seconds
    log(f"phase 17 (c): {json.dumps(report)} ({card})")
    return report


def sweep_phase(torch, fps, kernels, tokens, uni, card):
    """Phase 17, (a)-(c). Nothing is caught: a failed gate fails the
    script."""
    t0 = time.perf_counter()
    runs, sweep = p17_sweep(card)
    native_run, native_report = p17_native(torch, fps, kernels, tokens, uni,
                                           card)
    out = {"sweep": sweep, "native": native_report, "plan": p17_plan(card),
           "runs": runs + [native_run]}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {out['seconds']:.1f} s ({card})")
    return out


# Phase 18: the driver's entry points and the route-timing tools on the
# card. The tools run at their full widths, each timed pass cut to P18_T
# steps (the tools' own T is 256 or 512).
P18_T = 16
# entry()'s chunk: 2 MF steps, K1 2 (the item pull, the user rows) and K2 2
# (the item push, the user push) a step.
P18_ENTRY_LAUNCHES = {"gather_rows": 4, "scatter_add": 4}
# The kernels each tool's job must launch.
P18_TOOL_KERNELS = {
    "profile_mf_step": ("gather_rows", "scatter_add"),
    "bench_scatter run": ("scatter_add", "scatter_add_packed"),
    "bench_scatter dim1": ("gather_rows_dim1", "scatter_add_dim1"),
    "bench_scatter sweep": ("scatter_add", "scatter_add_packed"),
    "bench_logreg_routes": ("gather_rows_dim1", "scatter_add_dim1"),
    "pa_scaling": ("gather_rows_dim1", "scatter_add_dim1"),
}


def p18_host(out):
    """``(tables, local_state, dict of tensors)`` read to numpy."""
    tables, local_state, extra = out
    return ({k: v.numpy() for k, v in tables.items()}, local_state.numpy(),
            {k: v.cpu().numpy() for k, v in extra.items()})


def p18_equal(a, b) -> bool:
    return (a[0].keys() == b[0].keys() and a[2].keys() == b[2].keys()
            and all(np.array_equal(a[0][k], b[0][k]) for k in a[0])
            and np.array_equal(a[1], b[1])
            and all(np.array_equal(a[2][k], b[2][k]) for k in a[2]))


def p18_entry(torch, kernels, card):
    """(a): ``entry()``'s chunk twice on the same arguments, against the
    CPU's."""
    from fps_tpu_torch import entry as fe

    fn, args = fe.entry()
    before = p18_host(args[:3])
    runs, outs = [], []
    for i in range(2):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = kernels.launch_counts()
        want = {**dict.fromkeys(launched, 0), **P18_ENTRY_LAUNCHES}
        if launched != want:
            raise AssertionError(f"phase 18 (a): entry() call {i + 1} "
                                 f"launched {launched}, expected {want}")
        outs.append(p18_host(out))
        runs.append({"path": f"entry() chunk, call {i + 1}",
                     "launches": launched, "seconds": secs,
                     "examples": float(outs[-1][2]["n"].sum()),
                     "card": card})
    if not p18_equal(outs[0], outs[1]):
        raise AssertionError("phase 18 (a): entry() gave other bits on its "
                             "second call")
    if not p18_equal(before, p18_host(args[:3])):
        raise AssertionError("phase 18 (a): entry()'s call changed its "
                             "arguments")
    cfn, cargs = fe.entry(device="cpu")
    init = max(float(np.abs(before[0][k] - v.numpy()).max())
               for k, v in cargs[0].items())
    cpu = p18_host(cfn(*cargs))
    card_out = outs[0]
    worst = max(
        [float(np.abs(card_out[0][k] - cpu[0][k]).max()
               / np.abs(cpu[0][k]).max()) for k in cpu[0]]
        + [float(np.abs(card_out[1] - cpu[1]).max()
                 / np.abs(cpu[1]).max())])
    if not worst <= 1e-5:
        raise AssertionError(f"phase 18 (a): entry() card vs CPU: {worst} "
                             "of the largest value > 1e-5")
    out = {"calls_bit_equal": True, "arguments_unchanged": True,
           "card_vs_cpu": worst, "initial_tables_max_diff": init,
           "launches_per_call": runs[0]["launches"],
           "seconds": [r["seconds"] for r in runs]}
    log(f"phase 18 (a): entry() twice bit-equal, arguments unchanged, "
        f"{P18_ENTRY_LAUNCHES} a call, card vs CPU {worst} of the largest "
        f"value ({card})")
    return runs, out


def p18_dryrun(torch, kernels, card):
    """(b): ``dryrun_multichip(4)`` and ``(8)``, every position on
    ``cuda:0``."""
    from fps_tpu_torch import entry as fe

    runs, out = [], {}
    for n in (4, 8):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = fe.dryrun_multichip(n, device="cuda:0")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = kernels.launch_counts()
        idle = [k for k, v in launched.items() if not v]
        if idle:
            raise AssertionError(f"phase 18 (b): dryrun_multichip({n}) "
                                 f"launched no {idle}: {launched}")
        if got["launches"] != launched:
            raise AssertionError(f"phase 18 (b): dryrun_multichip({n}) "
                                 f"counted {got['launches']}, the counters "
                                 f"{launched}")
        if got["k3_calls"] <= 0 or min(got["hot_rows"].values()) <= 0:
            raise AssertionError(f"phase 18 (b): dryrun_multichip({n}): {got}")
        runs.append({"path": f"dryrun_multichip({n}) on cuda:0",
                     "launches": launched, "seconds": secs,
                     "examples": sum(got["examples"].values()),
                     "mesh": list(got["mesh"]), "card": card})
        out[str(n)] = {k: v for k, v in got.items() if k != "launches"}
        out[str(n)]["seconds"] = secs
        log(f"phase 18 (b): dryrun_multichip({n}) on cuda:0 in {secs:.1f} s: "
            f"{json.dumps(out[str(n)])}, launches {launched} ({card})")
    return runs, out


def p18_tools(torch, kernels, card):
    """(c): the four tools at full width, ``P18_T`` steps a timed pass."""
    from fps_tpu_torch.examples import bench_logreg_routes as bl
    from fps_tpu_torch.examples import bench_scatter as bs
    from fps_tpu_torch.examples import pa_scaling as ps
    from fps_tpu_torch.examples import profile_mf_step as pm

    dev = torch.device("cuda", 0)
    jobs = {
        "profile_mf_step": lambda: pm.profile(dev, card, iters=P18_T),
        "bench_scatter run": lambda: bs.main_shapes(dev, card, iters=P18_T),
        "bench_scatter dim1": lambda: [bs.dim1_shapes(dev, card,
                                                      iters=P18_T)],
        "bench_scatter sweep": lambda: bs.small_r_sweep(dev, card,
                                                        iters=P18_T),
        "bench_logreg_routes": lambda: bl.run_stages(list(bl.STAGES), dev,
                                                     card, iters=P18_T),
        "pa_scaling": lambda: ps.run_curves(ps.ROUTES, dev, card),
    }
    runs, readings = [], {}
    for name, job in jobs.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lines = job()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = kernels.launch_counts()
        idle = [k for k in P18_TOOL_KERNELS[name] if not launched[k]]
        if idle:
            raise AssertionError(f"phase 18 (c): {name} launched no {idle}: "
                                 f"{launched}")
        runs.append({"path": f"tool {name}", "launches": launched,
                     "seconds": secs, "lines": len(lines), "card": card})
        readings[name] = lines
        log(f"phase 18 (c): {name}: {len(lines)} lines in {secs:.1f} s, "
            f"launches {launched} ({card})")
    return runs, readings


def entry_phase(torch, kernels, card):
    """Phase 18, (a)-(c). Nothing is caught: a failed gate fails the
    script."""
    t0 = time.perf_counter()
    entry_runs, entry_out = p18_entry(torch, kernels, card)
    dry_runs, dry = p18_dryrun(torch, kernels, card)
    tool_runs, readings = p18_tools(torch, kernels, card)
    out = {"entry": entry_out, "dryrun": dry, "tools": readings,
           "tool_t": P18_T, "runs": entry_runs + dry_runs + tool_runs}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18: {out['seconds']:.1f} s ({card})")
    return out


def guard_kernel_cases(torch, kernels, cases, lr_data, dev):
    """Phase 3 at the guard's shapes (phase 11 (d)): K2 at the MF item push
    (the mean combine's count column, ML-20M items, B = 32,768 Zipf ids)
    and K4 at the SGD logistic-regression push (1M x 1, 13 + 16,384 x 26
    ids), each with 1 % of its ids masked to -1 and their deltas zeroed, as
    ``guard_pushes`` in mask mode hands them over."""
    rng = np.random.default_rng(11)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def masked(ids, dim):
        ids = np.array(ids, np.int32, copy=True)
        deltas = rng.normal(0, 1, (ids.size, dim)).astype(np.float32)
        bad = rng.random(ids.size) < 0.01
        ids[bad] = -1
        deltas[bad] = 0.0
        return t(ids), t(deltas)

    ids, dl = masked(path_ids(rng, ML20M_ITEMS, BATCH, True), RANK + 1)
    cases["scatter_add"].append(check_scatter(
        torch, "K2 MF item push, guarded (1 % masked)",
        kernels.scatter_add_cuda_, kernels.scatter_add_plain,
        t(rng.normal(0, 1, (ML20M_ITEMS, RANK + 1)).astype(np.float32)),
        ids, dl, "guarded", kernels))
    lr_ids = mix_dropped(np.concatenate([
        np.arange(LR_DENSE), lr_data["feat_ids"][:SPARSE_BATCH, LR_DENSE:]
        .reshape(-1)]), LR_NF)
    ids, dl = masked(lr_ids, 1)
    cases["scatter_add_dim1"].append(check_k4(
        torch, kernels, dev, "K4 logreg push, guarded (1 % masked)",
        t(rng.normal(0, 1, (LR_NF, 1)).astype(np.float32)), ids, dl,
        "guarded", None))


def path_sums(cases, path, copy=False):
    """A kernel's times summed over its shapes on one path (a step's)."""
    own = [c for c in cases if c["path"] == path]
    keys = ["ms", "call_ms", "plain_ms", "library_ms", "bound_ms"]
    out = {k: sum(c[k] for c in own) for k in keys + (["copy_ms"] if copy
                                                      else [])}
    if not copy:
        # None: a K4 call with no bucket pass (one row tile) sorts nothing.
        out["sort_ms"] = sum(c["sort_ms"] or 0.0 for c in own)
        out["torch_sort_ms"] = sum(c["torch_sort_ms"] or 0.0 for c in own)
    out["shapes"] = [c["shape"] for c in own]
    return out


def kernels_phase(torch, fps, kernels, pa_data, pa_q, mc_data, lr_data,
                  w2v_tokens, w2v_uni, ials_chunks, dev):
    """Phase 3: every kernel against its plain version at its paths'
    shapes, the sort's edges and the crossover sweep. Returns ``(cases,
    sort_cases, sweep, inputs)``, ``inputs`` phase 5's traced calls."""
    cases = kernel_phase(torch, kernels, pa_data, pa_q, mc_data, lr_data,
                         dev)
    w2v_kernel_cases(torch, kernels, cases,
                     w2v_first_step_ids(torch, fps, w2v_tokens, w2v_uni),
                     dev)
    ials_kernel_cases(torch, kernels, cases, ials_chunks, dev)
    sketch_kernel_case(torch, fps, kernels, cases, w2v_tokens, w2v_uni, dev)
    tier_kernel_cases(torch, kernels, cases, lr_data, dev)
    adaptive_kernel_cases(torch, kernels, cases, dev)
    guard_kernel_cases(torch, kernels, cases, lr_data, dev)
    inputs = {k: cases.pop(k) for k in ("k2_inputs", "k3_inputs",
                                        "k4_inputs", "gather_inputs")}
    sort_cases, inputs["sort_inputs"] = sort_edges(torch, kernels, dev)
    sweep = crossover_sweep(torch, kernels, dev)
    return cases, sort_cases, sweep, inputs


def main_paths_phase(torch, fps, kernels, pa_data, pa_q, mc_data, lr_data,
                     w2v_tokens, w2v_uni, ials_train, ials_test, ials_chunks,
                     card):
    """Phase 4: the paths at full width, counters at 0 just before each.
    Returns ``(runs, traced MF, traced w2v, traced iALS, MF data)``."""
    w2v_runs = w2v_paths(torch, fps, kernels, w2v_tokens, w2v_uni, card)
    w2v_runs.append(w2v_sketch_path(torch, fps, kernels, w2v_tokens, w2v_uni,
                                    card))
    ials_run, traced_ials = ials_path(torch, fps, kernels, ials_train,
                                      ials_test, ials_chunks, card)
    w2v_runs.append(ials_run)
    runs, traced, mf_data = paths_phase(torch, fps, kernels, pa_data, pa_q,
                                        mc_data, lr_data, card)
    runs += w2v_runs
    traced_w2v = traced_w2v_epoch(torch, fps, w2v_tokens, w2v_uni, card)
    return runs, traced, traced_w2v, traced_ials, mf_data


def card_vs_cpu_phase(torch, fps, kernels, inputs):
    """Phase 5: the card against the CPU, and phase 3's calls traced.

    Both devices read exactly. The CPU folds each row's pushes one by one
    in batch order (index_add_); on the card K2 sums each row's pushes in a
    fixed tree order (a scan within tiles of sorted positions, then across
    the tiles) and adds the sum into the row once, and K3 and K4 sum each
    row's pushes in a fixed tree a batch of 1,024, the batches in order
    within a block's share, then across a cluster's blocks and the clusters
    in order. So a row's sum differs from the CPU's by a few float32
    roundings of its terms each push. The card and the CPU also order dot
    products and row sums differently (about one rounding each). PA's and
    the logistic loss's steps are continuous in the weights, and so are
    SGNS's (whose draws, a hash of seeds and counters, are the same on both
    devices), so these differences stay near a few ulps of the largest
    value over the ~30 steps of each job (about 1e-6 relative); 1e-5 of the
    largest value leaves a margin and still catches a wrong row or a
    dropped push (a push moves a weight by 1e-4 to 1e-2 of its size
    here)."""
    worst = card_vs_cpu(torch, fps)
    taps_worst = taps_card_vs_cpu(torch, fps)
    breakdown, sort_traced = k2_breakdown(torch, kernels,
                                          inputs["k2_inputs"],
                                          inputs["sort_inputs"])
    k3_traced = k3_breakdown(torch, kernels, inputs["k3_inputs"])
    k4_traced = k4_breakdown(torch, kernels, inputs["k4_inputs"])
    gather_traced = gather_breakdown(torch, inputs["gather_inputs"])
    tol = 1e-5
    for job, diff in worst.items():
        if not diff <= tol:
            raise AssertionError(f"card vs CPU, {job}: tables differ by "
                                 f"{diff} of their largest value > {tol}")
    log(f"card vs CPU: tables agree within {tol} of their largest value "
        f"({json.dumps(worst)})")
    return (worst, taps_worst, breakdown, sort_traced, k3_traced, k4_traced,
            gather_traced)


ALL_PHASES = frozenset(range(1, 19))
# A phase that reads another's results brings it with it.
PHASE_NEEDS = {5: 3, 6: 4}


def parse_phases(spec: str | None) -> frozenset:
    """``--phases``: a comma list of phases and ranges (``3,18``,
    ``9-11``); phases 1 and 2 (environment, build) always run, and a phase
    brings the one whose results it reads (:data:`PHASE_NEEDS`)."""
    if spec is None:
        return ALL_PHASES
    want = {1, 2}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        want.update(range(int(lo), int(hi or lo) + 1))
    if not want <= ALL_PHASES:
        raise SystemExit(f"chip_smoke: --phases {spec}: phases are 1-18")
    for phase, need in PHASE_NEEDS.items():
        if phase in want:
            want.add(need)
    return frozenset(want)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch "
                                 "port on one NVIDIA GPU (see the module's "
                                 "docstring).")
    ap.add_argument("--phases", default=None,
                    help="run these phases only, e.g. 3,18 or 9-11 "
                         "(default: all)")
    want = parse_phases(ap.parse_args(argv).phases)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on the "
              "card only", file=sys.stderr)
        return 2
    try:
        import fps_tpu_torch as fps
        from fps_tpu_torch.ops import _build, kernels
        from fps_tpu_torch.utils import datasets as ds
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    # Full float32 matmuls (the default, stated): TF32 would change the
    # models' dot products and the card-vs-CPU comparison with them.
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Environment.
    card = nvidia_smi_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(card)

    # 2. Build.
    t0 = time.perf_counter()
    _build.library()
    log(f"built {os.path.relpath(_build.build_info['path'], ROOT)} from "
        f"{[os.path.relpath(s, ROOT) for s in _build.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_info['seconds']:.2f} s, cached: "
        f"{_build.build_info['cached']})")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "==" in line:
            log("  " + line.strip())

    if want != ALL_PHASES:
        log(f"phases {sorted(want)} of 1-18")
    # The sparse workloads' data, as bench.py makes it (seeds 3, 5, 0).
    pa_data = pa_q = mc_data = lr_data = None
    if want & {3, 4, 7, 8, 9, 11, 12, 16}:
        t0 = time.perf_counter()
        pa_data = ds.synthetic_sparse_classification(PA_NEX, PA_NF, PA_NNZ,
                                                     seed=3, noise=0.05)
        pa_data["label"] = np.where(pa_data["label"] > 0, 1.0,
                                    -1.0).astype(np.float32)
        pa_data, pa_q = ds.head_sort_slots(pa_data, PA_HEAD)
        mc_data = ds.synthetic_sparse_multiclass(PA_MC_NEX, PA_NF,
                                                 PA_MC_CLASSES, PA_NNZ,
                                                 seed=5)
        lr_data = ds.synthetic_sparse_classification(
            LR_NEX, LR_NF, LR_NNZ, seed=0, noise=0.05,
            dense_features=LR_DENSE)
        lr_data["label"] = (lr_data["label"] > 0).astype(np.float32)
        log(f"sparse data made in {time.perf_counter() - t0:.1f} s; PA head "
            f"prefix q = {pa_q} columns of {PA_NNZ}")
    # word2vec's corpus, as bench.py run_w2v makes it (load_text8 with no
    # file: the synthetic Zipfian stream), cut to 2M tokens.
    w2v_tokens = w2v_uni = None
    if want & {3, 4, 7, 8, 17}:
        t0 = time.perf_counter()
        w2v_tokens, _, w2v_uni = ds.load_text8(None, W2V_VOCAB, W2V_TOKENS)
        log(f"text8-size corpus ({W2V_TOKENS} tokens, vocab {W2V_VOCAB}) "
            f"made in {time.perf_counter() - t0:.1f} s")
    # iALS's interactions and chunks, as bench.py run_ials makes them.
    ials_train = ials_test = ials_chunks = None
    if want & {3, 4, 6, 7, 8}:
        t0 = time.perf_counter()
        ials_train, ials_test, ials_chunks = ials_data(ds)
        log(f"iALS data ({len(ials_train['user'])} training interactions, "
            f"{len(ials_chunks)} chunks) made in "
            f"{time.perf_counter() - t0:.1f} s")
    if 3 in want:
        cases, sort_cases, sweep, k_inputs = kernels_phase(
            torch, fps, kernels, pa_data, pa_q, mc_data, lr_data, w2v_tokens,
            w2v_uni, ials_chunks, dev)
    runs = []
    if 4 in want:
        runs, traced, traced_w2v, traced_ials, mf_data = main_paths_phase(
            torch, fps, kernels, pa_data, pa_q, mc_data, lr_data, w2v_tokens,
            w2v_uni, ials_train, ials_test, ials_chunks, card)
    elif want & {6, 7, 8, 11, 12, 13}:
        mf_data = ds.synthetic_ratings(ML20M_USERS, ML20M_ITEMS,
                                       ML20M_RATINGS, seed=0)
    if 5 in want:
        (worst, taps_worst, breakdown, sort_traced, k3_traced, k4_traced,
         gather_traced) = card_vs_cpu_phase(torch, fps, kernels, k_inputs)
        del k_inputs
    phase_out = {}
    for phase, key, fn in (
        (6, "host_pipeline_and_push_delay", lambda: pipeline_phase(
            torch, fps, kernels, mf_data, lr_data, ials_train, ials_test,
            runs, card)),
        (7, "sharded_mesh", lambda: mesh_phase(
            torch, fps, kernels, mf_data, pa_data, pa_q, w2v_tokens, w2v_uni,
            ials_train, ials_test, ials_chunks, card)),
        (8, "processes", lambda: process_phase(
            torch, fps, kernels, mf_data, pa_data, pa_q, w2v_tokens, w2v_uni,
            ials_chunks, card)),
        (9, "hot_tier", lambda: tier_phase(torch, fps, kernels, lr_data,
                                           card)),
        (10, "adaptive_tier", lambda: adaptive_phase(torch, fps, kernels,
                                                     card)),
        (11, "durability", lambda: durability_phase(
            torch, fps, kernels, mf_data, lr_data, card)),
        (12, "telemetry", lambda: telemetry_phase(torch, fps, kernels,
                                                  mf_data, lr_data, card)),
        (13, "serving", lambda: serving_phase(torch, fps, kernels, mf_data,
                                              card)),
        (14, "supervised", lambda: supervise_phase(torch, card)),
        (15, "pod_and_tenants", lambda: pod_phase(torch, card)),
        (16, "auditor", lambda: audit_phase(torch, fps, kernels, lr_data,
                                            card)),
        (17, "chaos_native_plan", lambda: sweep_phase(
            torch, fps, kernels, w2v_tokens, w2v_uni, card)),
        (18, "entry_points_and_tools", lambda: entry_phase(torch, kernels,
                                                           card)),
    ):
        # 6. The host pipeline and delayed pushes, after phase 5's traces:
        # its times compare runs made inside it, in turns, never with a
        # phase that ran before the profiler. 7. The sharded mesh. 8. The
        # mesh over several processes (every rank counts from 0). 9. The
        # static hot tier. 10. The adaptive tier. 11. Durability. 12.
        # Telemetry. 13. Serving while the card trains. 14. The supervisor
        # drives training on the card and 15. a pod and two tenants (their
        # children count their own launches). 16. The program auditor (its
        # audited call's launches counted from 0). 17. The chaos sweep (its
        # children count their own), the native pair stream and the
        # planner. 18. The entry points and the route-timing tools. Counters
        # at 0 before each run.
        if phase in want:
            phase_out[key] = fn()
        if phase == 8:
            ials_chunks = None
        if phase == 13:
            mf_data = None
    pipeline = phase_out.get("host_pipeline_and_push_delay")
    if pipeline is not None:
        runs += [dict(arm, path=f"{arm['path']}, arm {i}")
                 for ab in pipeline["prefetch_ab"]
                 for i, arm in enumerate(ab["arms"])]
        runs += pipeline.pop("push_delay_runs")
    for key, out in phase_out.items():
        if key != "host_pipeline_and_push_delay":
            runs += out["runs"]
    launches = {name: sum(r["launches"][name] for r in runs)
                for name in kernels.WRAPPERS}
    log(f"launch counters over the paths: {launches}")
    if want != ALL_PHASES:
        # A subset: what its phases ran, in place of the kernels line.
        log(card)
        log(json.dumps({
            "phases": sorted(want), "launches": launches, "paths": runs,
            **{k: ({kk: vv for kk, vv in v.items() if kk != "runs"}
                   if isinstance(v, dict) else v)
               for k, v in phase_out.items()},
            **({"card_vs_cpu": worst,
                "card_vs_cpu_ials_and_sketch_tap": taps_worst}
               if 5 in want else {}),
            "seconds": time.perf_counter() - t_start, "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    (mesh, processes, tier, adaptive, durability, telemetry, serving,
     supervised, pod, auditor, chaos, entry_points) = (phase_out[k] for k in (
        "sharded_mesh", "processes", "hot_tier", "adaptive_tier",
        "durability", "telemetry", "serving", "supervised",
        "pod_and_tenants", "auditor", "chaos_native_plan",
        "entry_points_and_tools"))
    split = cases.pop("split")
    for case in sort_cases:
        case["sort_passes"] = sort_traced[case["shape"]]["sort_passes"]

    # 19. Summary lines. Each entry's times are per step of its first path
    # (K1 / K2: one MF step; K5 / K4: one binary PA step, head and tail;
    # K3: one MF step with hot_items, the item head); every shape is listed
    # under per_shape with the path it belongs to.
    def entry(name, source, replaces, first_path):
        own = [c for c in cases[name] if c["path"] == first_path]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {r["path"]: r["launches"][name]
                                 for r in runs},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": sum(c["ms"] for c in own),
            "call_ms": sum(c["call_ms"] for c in own),
            "plain_ms": sum(c["plain_ms"] for c in own),
            "bound_ms": sum(c["bound_ms"] for c in own),
            "bound_by": "bytes",
            "library_ms": sum(c["library_ms"] for c in own),
            "per_step_of": first_path,
            "per_shape": cases[name],
        }

    src = "fps_tpu_torch/ops/csrc/"
    pallas = "fps_tpu/ops/pallas_kernels.py"
    def gather_entry(name, source, replaces, first_path):
        traced = {label: b for label, b in gather_traced.items()
                  if label.startswith("K1" if name == "gather_rows" else "K5")}
        return dict(entry(name, source, replaces, first_path),
                    copy_ms=sum(c["copy_ms"] for c in cases[name]
                                if c["path"] == first_path),
                    traced_by_shape=traced)

    # K1's and K2's times a step of the w2v paths (the block path's two
    # pulls or pushes; the pairs path's, off the main path) and of the iALS
    # path (a pull and two pushes of each half's step, summed over both
    # halves: two steps' worth).
    w2v_steps = {k: {p: path_sums(cases[k], p, copy=k == "gather_rows")
                     for p in ("w2v_block", "w2v_pairs")}
                 for k in ("gather_rows", "scatter_add")}
    ials_steps = {k: path_sums(cases[k], "ials", copy=k == "gather_rows")
                  for k in ("gather_rows", "scatter_add")}
    line = {"kernels": [
        dict(gather_entry("gather_rows", src + "gather_rows.cu",
                          pallas + ":513", "mf"),
             w2v_per_step=w2v_steps["gather_rows"],
             ials_two_half_steps=ials_steps["gather_rows"],
             hot_tier_shapes=path_sums(cases["gather_rows"], "tier",
                                       copy=True),
             adaptive_tier_shapes=path_sums(cases["gather_rows"], "adaptive",
                                            copy=True)),
        dict(entry("scatter_add", src + "scatter_add.cu", pallas + ":112",
                   "mf"), w2v_per_step=w2v_steps["scatter_add"],
             ials_two_half_steps=ials_steps["scatter_add"],
             hot_tier_shapes=path_sums(cases["scatter_add"], "tier"),
             adaptive_tier_shapes=path_sums(cases["scatter_add"],
                                            "adaptive"),
             guarded_shapes=path_sums(cases["scatter_add"], "guarded"),
             sort={"source": src + "radix_sort.cu",
                   "passes_by_shape": {label: b["sort_passes"]
                                       for label, b in breakdown.items()},
                   "ms": sum(c["sort_ms"] for c in cases["scatter_add"]
                             if c["path"] == "mf"),
                   "torch_sort_ms": sum(
                       c["torch_sort_ms"] for c in cases["scatter_add"]
                       if c["path"] == "mf"),
                   "off_path": sort_cases},
             traced_by_shape=breakdown),
        dict(gather_entry("gather_rows_dim1", src + "gather_rows_dim1.cu",
                          pallas + ":429", "pa_binary"),
             hot_tier_shapes=path_sums(cases["gather_rows_dim1"],
                                       "tier_logreg", copy=True)),
        dict(entry("scatter_add_dim1", src + "scatter_add_dim1.cu",
                   pallas + ":338", "pa_binary"),
             bucket_pass={
                 "ms_by_shape": {c["shape"]: c["sort_ms"]
                                 for c in cases["scatter_add_dim1"]},
                 "torch_sort_ms_by_shape": {
                     c["shape"]: c["torch_sort_ms"]
                     for c in cases["scatter_add_dim1"]}},
             sketch_tap_per_step=path_sums(cases["scatter_add_dim1"],
                                           "w2v_sketch_tap"),
             hot_tier_shapes=path_sums(cases["scatter_add_dim1"],
                                       "tier_logreg"),
             adaptive_tier_shapes=path_sums(cases["scatter_add_dim1"],
                                            "adaptive"),
             guarded_shapes=path_sums(cases["scatter_add_dim1"], "guarded"),
             traced_by_shape=k4_traced),
        dict(entry("scatter_add_packed", src + "scatter_add_packed.cu",
                   pallas + ":178", "mf_hot"),
             traced_by_shape=k3_traced, split_end_to_end=split,
             crossover_sweep=sweep),
    ], "paths": runs, "traced_mf_run_indexed": traced,
        "traced_w2v_run_indexed": traced_w2v,
        "traced_ials_epoch": traced_ials, "card_vs_cpu": worst,
        "host_pipeline_and_push_delay": pipeline,
        "card_vs_cpu_ials_and_sketch_tap": taps_worst,
        "sharded_mesh": {k: v for k, v in mesh.items() if k != "runs"},
        "processes": processes,
        "hot_tier": {k: v for k, v in tier.items() if k != "runs"},
        "adaptive_tier": {k: v for k, v in adaptive.items() if k != "runs"},
        "durability": {k: v for k, v in durability.items() if k != "runs"},
        "telemetry": {k: v for k, v in telemetry.items() if k != "runs"},
        "serving": {k: v for k, v in serving.items() if k != "runs"},
        "supervised": {k: v for k, v in supervised.items() if k != "runs"},
        "pod_and_tenants": {k: v for k, v in pod.items() if k != "runs"},
        "auditor": {k: v for k, v in auditor.items() if k != "runs"},
        "chaos_native_plan": {k: v for k, v in chaos.items() if k != "runs"},
        "entry_points_and_tools": {k: v for k, v in entry_points.items()
                                   if k != "runs"},
        "trace_windows": {
            "windows": len(TRACE_WINDOWS),
            "retraced": sum(1 for w in TRACE_WINDOWS if w["attempt"] > 0),
            "without_spin_kernel": [w for w in TRACE_WINDOWS
                                    if not w["spin_kernel"]],
            "device_records": [min(w["device_records"]
                                   for w in TRACE_WINDOWS),
                               max(w["device_records"]
                                   for w in TRACE_WINDOWS)]},
        "pa_head_prefix_cols": pa_q,
        "seconds": time.perf_counter() - t_start, "card": card}
    log(card)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase8-rank"]:
        sys.exit(p8_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase11-child"]:
        sys.exit(p11_child(sys.argv[2:]))
    sys.exit(main())
