#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``mercury_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``. In order:

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. builds the CUDA kernels from ``mercury_tpu_torch/ops/csrc/`` (timed,
   with ``ptxas``'s register and spill report);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and a few larger ones, and times kernel, plain version
   and (where one exists) the one-call PyTorch equivalent (for nll_bwd the
   2 ATen calls of ``F.cross_entropy``'s gradient). Both NLL kernels also
   run untimed at odd and wide C, pointers off 16 bytes, labels in
   [−1, C] and non-finite rows (NaN-aware). The selection
   kernels run at N = 320 … 1,000,000 and L = 5000 … 1,000,000, each case
   printed with the cluster size K it launched with, and every draw is
   held to its interval of the float64 CDF of the kernel's own probs. The
   ingest runs at [32], [64] and [320], at every crop offset, gathering
   its rows from the 5000-image shard, and at shapes that stage by bytes,
   in float32 and bfloat16, each bit-equal to the plain version. The NLL
   kernels also run at phase 9's CIFAR-100 shapes ([320, 100], [32, 100],
   [64, 100]) and phase 19's 20 classes ([320, 20], [32, 20], [64, 20]),
   timed beside their library calls;
4. drives the main path: ``Trainer(TrainConfig(model="resnet18",
   dataset="synthetic", world_size=1))`` at full width (batch 32, pool 320,
   bf16, importance sampling and telemetry on) for 30 steps, with the
   kernels' launch counts zeroed just before and read just after; checks
   the losses are finite, the launch counts, that the scoring forward
   leaves the BN running statistics alone, every step's telemetry (the JAX
   step's metric keys, ESS in (0, 1], clip share in [0, 1], the gradient's
   norm finite and positive, the IS-weight histogram summing to the
   batch), and one step with kernels against the same step with the plain
   versions, its telemetry included;
5. drives the scoretable path the same way: ``sampler="scoretable",
   fused_input=True`` (a table over the 5000-image shard, a refresh window
   of 64, batch 32, every ingest through the fused kernel) for 30 steps,
   with its own launch counts, the cursor's advance, the telemetry as in
   phase 4 plus the table's histogram (summing to L), its ages (against
   the closed form) and the ledger (grown by 30·32, equal to the count of
   the drawn slots), and a kernel step against a plain step;
6. drives the default pool configuration at ``world_size=2``: two ranks,
   one process each, in a gloo process group, both on card 0
   (``parallel.distributed.spawn``), batch 32 and a pool of 320 a rank,
   synced BN, 3 + 10 steps. Each rank must launch the kernels as often a
   step as phase 4 did and issue 3·20 + 4 all-reduces a step (telemetry
   on: its values ride in the metrics' all-reduce), and match a plain step
   with a kernel step; after the steps the two replicas' parameters, Adam
   state and BN running statistics, and the two ranks' ESS, clip share,
   drift and gradient norm, must be bit-equal.
   Each rank's steps/s is printed: two ranks sharing one card over gloo,
   not a data-parallel rate;
7. resume and accumulate: the default pool configuration with
   ``grad_accum_steps=2`` under deterministic cuDNN. Three microsteps (the
   parameters bit-unchanged across the first of a window, changed across
   the second; 2 nll_fwd, 1 nll_bwd and 1 score_and_draw a microstep), a
   ``save`` (bytes and time printed), four more microsteps; then a fresh
   ``Trainer`` that ``restore``s the file (time printed; every tensor equal
   to the saved one by sha256) and runs the same four, bit-equal to the
   first. ``predict`` on the test split gives ``evaluate``'s accuracy
   exactly, and uint8 input equals the same images as float / 255. The
   microstep rate (10 microsteps a turn: live, restored, restored, live)
   is printed beside phase 4's step rate;
8. telemetry: the pool and the scoretable path with ``telemetry=False``
   and ``True`` in turns (10 steps a turn, 4 turns each), steps/s of each;
   CUDA kernels a step each way (``torch.profiler``); the synchronizing
   calls a step each way (``torch.cuda.set_sync_debug_mode("warn")``),
   which must be equal; ``variance_probe_every=2`` for 6 steps (a finite,
   positive ``var_ratio`` on even steps, −1.0 on odd ones); and the
   scoretable Trainer's seven sampler-health keys at a log tick;
9. the config surface: (a) ``model="resnet152", dataset="cifar100",
   importance_score="grad_norm", augmentation="iid"`` at full width, 3 +
   20 steps (steps/s, peak memory, 2 nll_fwd at [320, 100] and [32, 100],
   1 nll_bwd and 1 score_and_draw a step, a kernel step against a plain
   step, kernels and device time a step from ``torch.profiler``) and its
   IID evaluation; (b) ``model="resnet101"`` on the
   scoretable path with ``cutout=True``, 3 + 10 steps (nll_fwd at
   [64, 100] and [32, 100], 1 table_refresh_draw a step), then fused
   without cutout, 3 + 5 steps (2 augment_normalize a step with
   CIFAR-100's statistics), each with a kernel step against a plain step;
   (c) ``label_smoothing=0.1`` refused with the kernels and, with
   ``use_pallas=False``, 3 steps launching none; (d) ``fit()`` under
   ``step_budget=3`` with 4 steps an epoch stops at step 4 and returns the
   evaluation. Every configuration of the phase reads CIFAR-100 from an
   empty ``data_dir``, so each trains on the synthetic 100-class set
   (checked), whatever lies in the loader's default directories;
10. the host stream (``data_placement="host_stream"``): (a) the default
   pool path with its train pixels in host memory against the replicated
   placement: the dataset's device bytes in each (15,360,000 more
   replicated), 3 + 20 steps of each bit-equal under deterministic cuDNN
   with 2 nll_fwd, 1 nll_bwd and 1 score_and_draw a step, then steps/s
   in turns (replicated, host_stream, host_stream, replicated) with the
   stall share and 983,040 bytes sent a step, and a host-stream kernel
   step against a plain step; (b) the streamed scoretable at CIFAR-10's
   train size: a 153,600,000-byte ``np.memmap`` of 50,000 random rows,
   L=50,000, ``fused_input`` and ``scoring_dtype="bfloat16"``, 3 + 20
   steps launching 2 nll_fwd, 1 nll_bwd, 1 score_and_draw at N=50,000,
   2 augment_normalize without ``rows`` (bf16 [64], f32 [32]) and no
   table_refresh_draw a step, its steps/s and stall share, and a kernel
   step against a plain step; (c) (a)'s host_stream configuration under
   deterministic cuDNN saved with its ring in flight, 4 steps live and 4
   restored, bit-equal; (d) ``scoring_dtype="bfloat16"`` against None on
   the replicated pool path with float32 training: steps/s in turns and
   the scoring forward's device time a step (``torch.profiler``) and
   alone at [320] (CUDA events);
11. the pool sampler's step modes on the main path's config: (a)
   ``pipelined_scoring=True``, (b) ``score_refresh_every=8``, (c)
   ``sampler="groupwise", fused_input=True``, each 3 warm steps and then
   20 a turn in 2 turns with the default pool step (steps/s), every
   window's launches held to :func:`mode_launches` (pipelined 2 nll_fwd,
   1 nll_bwd and 1 score_and_draw a step, 3/1/2 at step 0; cadence 1
   nll_fwd and 1 nll_bwd, one more nll_fwd on a refresh step; groupwise 2
   nll_fwd, 1 nll_bwd and 2 augment_normalize), a kernel step against a
   plain step in each (the cadence at a refresh and at a reuse step),
   every groupwise weight finite and positive, and a save with each
   mode's state in flight, then 4 steps live and 4 restored, bit-equal
   under deterministic cuDNN.

12. the gradient path's options at ``world_size=2`` (two gloo ranks on
   the one card, as phase 6), the default pool config at full width: (a)
   ``zero_sharding=True``, (b) ``grad_compression="int8"``, (c) both, (d)
   ``grad_compression="stochastic"``, each 3 warm steps, then 5 timed
   steps a turn after 5 of the plain W=2 step. Every window's launches
   are the pool step's; after every window the replicas' parameters and
   BN statistics are bit-equal (sha256); a kernel step matches a plain
   step with the same draws on each rank; ``train/sparse_rate`` is in
   (0, 1] under (d) and 1.0 elsewhere; (a) and (c) save, then run 4 steps
   live and 4 restored, bit-equal under deterministic cuDNN. Printed: each
   arm's steps/s a rank beside the plain step's in its turn, the bytes
   handed to ``torch.distributed`` a step by call and dtype (and what a
   rank sends for them), their host ms, and the optimizer state's bytes a
   rank; the int8 arms must send ¼ of the float32 gradient's bytes;
13. async scoring (``refresh_mode="async"``): (a) from one state, a
   ``score_once`` chunk against the same window through the live model and
   the plain NLL, the chunk applied at age 0 and 3 (bit for bit), one async
   step with the kernels (``table_refresh_draw`` with a one-slot sentinel
   window) against the plain route (the same slots, slot 0 the decay
   alone), the sentinel and ``table_refresh_draw`` at R=1 against the plain
   versions at L=5000 and 50,000; (b) phase 5's config with the plain and
   the fused ingest: the sync step, the async step with a live fleet and
   one with ``scorer_throttle_s=0.005``, 10 steps a turn in turns (1
   nll_fwd a step against sync's 2; chunks applied and rejected, the
   staleness, the fleet's rows/s and launches, a snapshot's ms); (c) phase
   10 (b)'s streamed scoretable under async (32 rows streamed a step
   against 96, the stall share, a kernel step against a plain step); (d) a
   restore in the middle of a live run (the queue empty, the snapshot at
   the restored step) and no scorer thread alive after ``close()``;
14. the scorer service (``sampling/scorer_service.py``): (a) from one
   snapshot, the device backend's two chunks bit-equal to the host
   fleet's, its ``nll_fwd`` counted apart on its own stream, tenant 1's
   chunk from ``chunk_seed(seed, 0x100000)`` against the plain NLL; (b)
   phase 5's config, plain and fused ingest: sync, async with the host
   fleet and async with ``scorer_backend="device"``, 10 steps a turn in
   six turns (chunks scored and applied a step, staleness, the scorer's
   launches a step; the device arm picks at most 2 chunks a snapshot
   epoch); (c) two tenants at "3,1" on the host backend against one, in
   turns (the shares, the rates); (d) the device backend's lockstep at
   W=2, two gloo ranks on the one card, ``snapshot_every=4``, 16 steps
   run twice (the schedule one snapshot behind, each rank's table
   bit-equal across the runs, the trainer's wait at each snapshot); (e) a
   restore in the live device run and no service thread after ``close()``;
15. the command line (``mercury_tpu_torch/cli.py``) on the main path's
   config as flags: (a) ``cli.main([..., "--dry-run"])`` in this process
   (2 nll_fwd, 1 nll_bwd and 1 score_and_draw, and the same step from the
   state before it with the plain versions); (b) ``python -m
   mercury_tpu_torch --dry-run`` (exit 0, a JSON last line); (c) a 40-step
   ``fit`` through ``cli.main`` with ``--log-every 10 --heartbeat-every 10
   --log-dir D``: four records with a finite loss and 0 < ``perf/mfu`` <
   1, the manifest naming the card, the rank's shards, heartbeat lines;
   (d) the fit's steps/s with no metric stream, with records but no
   ``log_dir``, and with ``log_dir`` and the heartbeat, in turns, and the
   synchronizing calls of one log tick on the training thread (none);
   (e) ``timing_breakdown`` in ms; (f) ``torchrun --nproc_per_node=1 -m
   mercury_tpu_torch --distributed --dry-run`` over NCCL; (g) ``trace``
   around 3 steps, whose Chrome trace names ``nll_fwd_kernel`` and
   ``select_kernel``;
16. durable checkpoints, elastic restore and the fault plane on the main
   path's config under deterministic cuDNN: (a) a 24-step ``fit`` saving
   every 8 with the sha256 manifest (file bytes, each save's blocking,
   write and digest ms, a verified restore's read, verify and load ms, and
   saves with and without the manifest in turns); (b) 40-step fits saving
   every 10, sync and ``async_checkpoint`` in four turns (the ms each save
   blocks the training thread, steps/s, steps/s while a write is in
   flight, and the async files equal to the sync files by their tensors'
   sha256); (c) a byte of the newest file flipped: ``auto_resume`` falls
   back to the older step naming the failed check, and 8 steps from there
   are bit-equal to an explicit restore of it (the same pair under cuDNN's
   default settings is read, not checked); (d) ``ckpt_io_error@step=16``
   with two retries (every save lands, the next record shows one write
   failure) and ``every=1`` without retries (``fit`` raises ``OSError``,
   no ``.tmp`` left); (e) elastic restore with two gloo ranks on the card:
   a W=2 ZeRO file restored at W=1 (moments equal to the chunks
   concatenated; 8 steps launching 2 nll_fwd, 1 nll_bwd, 1 score_and_draw
   a step; a kernel step against a plain step), and a W=1 scoretable +
   fused file restored at W=2 (each rank's table equal to the plain
   repartition; 4 steps launching the scoretable path's kernels; a kernel
   step against a plain step on each rank); (f) the host stream with
   ``prefetch_stall@step=5,secs=0.5`` bit-equal to a run without, and
   ``prefetch_die`` raising at the next ``pop`` with its name;
17. the supervised runtime (``supervise=True``) on phase 5's config under
   ``refresh_mode="async"`` with a ``log_dir``: (a) ``scorer_die@step=5``
   restarted once within the budget (``mercury-scorer-0-r1``, level 0,
   the restart's journal parent the ``fault/fired``), then unsupervised,
   supervised and supervised-without-journal fits of 15 steps in six turns
   (steps/s, host µs a step, the tick's host µs); (b) budget 0, a probe
   and a sync refresh every step, two every-step ``scorer_die`` and
   ``host_slow``: ``fit`` ends green at level 3 with ``sampler/is_active``
   0 and the table constant at 0, each level's launches a step (the step's
   and the fleet's), the level-3 ``table_refresh_draw`` kernel against its
   plain version (the same slots, p = 1/L, weights 1) and a kernel step
   against a plain step; (c) budget 0 and one death: async → sync → async
   through the probe, the workers revived with a fresh budget, and a
   chunk scored on the training thread against the plain NLL; (d) the
   host-stream pool step with ``prefetch_die@step=3`` under deterministic
   cuDNN bit-equal to an uninterrupted run (``mercury-prefetch-r1``), and a
   kernel step against a plain step; (e) ``anomaly_inject_nan_step=10``
   writes ``flight_record_step10_non_finite.json`` with the card's
   allocator statistics, whether ``mfu_floor`` fired at the default 0.01,
   and in (b)'s journal each ``supervisor/degrade``'s parent chain rooted
   at a ``fault/fired``;
18. the rest of the host runtime's observability: (a) the main path's
   config with ``trace=True``, ``serve_port`` on a free port and a
   ``log_dir``, 30 steps of ``fit`` while a thread scrapes ``/healthz``,
   ``/statusz`` and ``/metricsz`` (``/metricsz`` parses back to the
   writer's latest record); ``trace.json`` holds one ``trainer/dispatch``
   span a step on the ``train`` thread and the journal's lane;
   ``anomaly_inject_nan_step`` opens a profiler window whose
   ``profile/trace_step<N>.json`` ``obs/profile_parse`` attributes at
   ``attributed_frac`` 1.0 with device time in ``mercury_scoring`` and
   ``mercury_optimizer`` (its lanes and categories printed); the fit's
   launches are the step's 30 times over and the evaluation's; steps/s
   with the tracer off and on and the server off and on (scraped once and
   ten times a second by another process), in turns, each turn's launches
   held; CUDA kernels a step with the tracer off, on and the scopes open
   (printed); a span's host ns, on and off; a kernel step against a plain
   step; (b)
   two gloo ranks on the card, phase 14's lockstep config supervised,
   with ``host_slow`` on rank 1 alone under ``crosshost_telemetry``
   ``"allgather"`` and then ``"files"`` (rank 0's records carry the
   ``host/*`` keys and the straggler trigger fires from
   ``host/straggler_ratio`` above 1.5), then ``scorer_die`` on rank 1
   alone at budget 0 with probes off (both ranks act on the same level at
   every step, walk the same transitions, leave the lockstep and finish
   in time), the agreement's host µs a tick, and the four kernels a step;
   (c) ``python -m mercury_tpu_torch.obs.report`` on (a)'s run, as HTML
   too, and ``--diff`` against a second run of (a)'s config: exit 0.
19. the image family on ``synthetic_hard`` (20 classes, 5000 images),
   batch 32, bf16: (a) SmallCNN, VGG-11, VGG-16 and MobileNetV2 at full
   width on the default pool step, 3 warm-up and 30 timed steps each, the
   kernels' launches a step phase 4's, each kernel's output on one step's
   own inputs ([320, 20] and [32, 20] logits, the pool's draw) against its
   plain version, a kernel step against a plain step; steps/s, the device
   busy share (``torch.profiler``, 5 steps), peak memory, MFU and the
   IS/uniform step-rate ratio in two turns; (b) MobileNetV2 on the
   scoretable sampler with the fused ingest, 30 steps; (c) only where
   scikit-learn imports, ResNet-18 on ``digits_imb``, importance sampling
   against uniform, a fixed number of steps each: test accuracy, the
   rare classes' (5-9) accuracy and the seconds;
20. the sequence family at the JAX package's default widths, batch 32,
   bf16: (a) BiLSTM-attention (two BiLSTMs of 128, 675,722 parameters)
   and the Transformer (d_model 128, 4 heads, 2 layers, 662,410) on
   ``synthetic_seq`` (5000 float32 [32, 16] sequences,
   ``augmentation="none"``) and ViT (patch 4, 4 layers, 809,098) on
   ``synthetic``, each as phase 19's (a): 30 timed steps held to 2/1/1
   launches a step, each kernel on the step's own inputs against its plain
   version, a kernel step against a plain step, steps/s, busy share,
   peak memory, MFU, and the uniform arm (1/1/0) in turns; (b) ViT on the
   scoretable sampler with the fused ingest, 30 steps held to 2/1/0/1/2;
   (c) the Transformer with ``remat=True`` against without from the same
   seed, in turns: the same losses, each arm's peak memory and the steps/s
   ratio; (d) ``evaluate`` and ``predict`` on ``synthetic_seq``: finite,
   ``[N, 10]``, predict's argmax accuracy evaluate's. ``digits_seq`` runs
   only where scikit-learn imports, and says so where it does not;
21. experts and chunks, batch 32, a pool of 320, bf16: (a) the
   Transformer of phase 20 with ``moe_experts=8`` (2,508,442 parameters)
   on ``synthetic_seq`` as phase 20's (a), every step's ``train/moe_aux``
   finite and in (0, 8·layers]; (b) ViT with ``moe_experts=8``
   (4,501,162) on the fused scoretable step, 2/1/0/1/2 launches a step;
   (c) the first block's ``MoEMLP`` on the train forward's 1024 tokens,
   under bf16 autocast: at ``capacity_factor=8`` its output within two
   bf16 ulps of the largest of its ``reference()`` oracle's, at 1.0 under
   a router tilted to one expert the overflow (the count past each
   bucket's capacity) exactly zero and the rest the oracle's;
   (d) ``scan_steps=4`` against 1 on the main path (ResNet-18) under
   deterministic cuDNN, 16 steps a turn in turns (1, 4, 4, 1): equal
   losses, equal ``state_digests``, 2/1/1 launches a step and both
   steps/s;
22. the mesh, gloo ranks on card 0 as phase 6's, under deterministic
   cuDNN, batch 32, a pool of 320: (a) tensor parallelism in float32, the
   Transformer of phase 20 (662,410 parameters) on ``synthetic_seq`` at
   ``world_size=2, tensor_parallel=2`` (four ranks) and at
   ``world_size=2`` (two); (b) FSDP, full-width ResNet-18 (11,173,962) on
   ``synthetic`` in bf16 at ``world_size=1, fsdp_parallel=2`` (two ranks)
   and at ``world_size=1`` (this process, before and after). Each arm: 3 warm-up
   and 10 timed steps on every rank, 2/1/1 launches a step (phase 4's),
   each kernel on one step's inputs against its plain version and a
   kernel step against a plain step on every rank, the selections
   bit-equal across each model group, the collectives a step by group
   (count, bytes handed in, host ms), steps/s, and a rank's parameter and
   Adam-moment bytes (``requested_bytes`` freed when they are dropped)
   equal to what the layout predicts; then the sharded arm's losses
   against the unsharded arm's: (a) while every worker's T=2 ranks draw
   the indices its T=1 rank draws, which they must through the 3 warm-up
   steps at least, each step's pool loss, loss and gradient norm to rtol
   1e-4 (the row-parallel sums reassociate float32; the differences grow
   until a score near a CDF boundary draws another sample, and the later
   losses are printed, not held), (b) all 20 timed losses to rtol 1e-5
   (the gathered weights are the whole ones, the reduce-scatter's mean of
   two equal gradients exact);
23. the compositions of a second axis, gloo ranks on card 0 under
   deterministic cuDNN: (a) phase 22's Transformer in float32 at
   ``world_size=2, tensor_parallel=2`` under each ``grad_compression``
   ("none", "int8", "stochastic"), 3 warm-up and 10 timed steps an arm on
   four ranks: 2/1/1 launches a step, each kernel on one step's inputs
   against its plain version, a kernel step against a plain step, the
   selections bit-equal in each model group, the whole parameters
   gathered after the steps equal on every rank (sha256), 5,578,872
   parameter and moment bytes a rank, the collectives a step by group,
   kind and dtype (int8 payloads and float32 scales on the data group
   under int8, float32 all-reduces only otherwise), ``train/sparse_rate``
   below 1 under "stochastic" alone, steps/s a rank; the "none" arm
   saves; (b) ResNet-18 at ``world_size=1, fsdp_parallel=2`` on the fused
   scoretable under ``refresh_mode="async"`` (the host fleet, one
   worker), 3 + 10 steps on two ranks: 1/1/1/1 launches a step (nll_fwd
   [32, 10], nll_bwd, table_refresh_draw at R=1, augment_normalize [32]
   with ``rows``), the two ranks' tables bit-equal after every step, the
   chunks applied and their ages, the scorer's own launches and threads
   on the first rank only; (c) (a)'s file restored with
   ``restore_elastic`` at ``world_size=1, tensor_parallel=2`` (two ranks)
   and at ``world_size=1`` (this process): the gathered model and Adam
   state equal the file's by sha256, the EMA the rows' mean, 3 steps with
   the selections bit-equal in the model group and the losses within rel
   1e-5 of W=1's;
24. sequence parallelism (``train/sp_step.py``), gloo ranks on card 0
   under deterministic cuDNN, phase 20's Transformer (662,410 parameters)
   on ``synthetic_seq`` in float32, batch 32, a pool of 320, Adam: (a)
   ``make_dp_sp_mercury_step`` at W=1 × S=2 under ``ring``, ``zigzag``
   (causal) and ``ulysses``, 3 + 10 steps each on two ranks, against S=1
   in this process from the same weights and draws (non-causal, and
   causal for zigzag): step 1's loss within rel 1e-5 and its selections
   equal (the step where they first part printed), the two ranks'
   selections and losses equal at every step, 2/1/1 launches a step on
   every rank at [320, 10] and [32, 10], the collectives a step by group,
   kind and bytes; (b) ``ring`` at W=2 × S=2 on four ranks, 3 + 10 steps:
   the EMA equal on all four, each seq group's selections and losses
   equal, the collectives a step; (c) the attentions alone at B=2,
   L=4096, H=4, D=32 in float32, ``ring`` and ``ulysses`` and causal
   ``zigzag`` at S=2 against ``dense_attention`` here: the output's and
   the gradients' largest errors, each rank's forward peak memory (below
   dense's), and the forward's and backward's ms;
25. pipeline parallelism (``parallel/pipeline.py``, ``train/pp_step.py``),
   gloo ranks on card 0 under deterministic cuDNN, float32, Adam, batch 32,
   a pool of 320: (a) ViT at full width (phase 20's, 809,098 parameters)
   on ``synthetic`` images at S=2, M=2 (two ranks) and S=4, M=4 (four
   ranks), 3 + 10 steps; (b) the Transformer with 8 experts a block (phase
   21's, 2,508,442) on ``synthetic_seq`` at S=2, M=2, 3 + 5 steps; each
   against S=1 at the same M in this process from the same weights: step
   1's loss (and router loss) within rel 1e-5 and its selections equal
   (the step where they first part printed), the selections and losses
   equal on every stage, 2/1/1 launches a step on every rank at [320, 10]
   and [32, 10], each rank's parameter and Adam-moment bytes exactly 12 ×
   its stage's parameters, the collectives a step by group, kind and
   bytes, and steps/s a rank;
26. two model axes (``parallel/mesh.make_pp_mesh``, expert parallelism in
   ``models/moe.py``), on phase 25's process group of four gloo ranks on
   card 0 after its arms (one spawn for both phases), under deterministic
   cuDNN, float32, Adam, batch 32, a pool of 320, M=2:
   (a) phase 20's Transformer at pipe 2 × seq 2 under ring attention, 3 +
   10 steps; (b) phase 21's Transformer with 8 experts a block at capacity
   factor 8 at pipe 2 × expert 2, each rank scoring 160 pool rows and
   training 16 batch rows, 3 + 5 steps; each against S=1 at M=2 in this
   process from the same weights and draws ((b)'s S=1 batch in the expert
   ranks' microbatch grouping): step 1's loss (and router loss) within rel
   1e-5 and its selections equal (the step where they first part
   printed), the selections and losses equal on all four ranks, 2/1/1
   launches a step on every rank ([320, 10] and [32, 10]; (b) [160, 10]
   and [16, 10]), each kernel against its plain version on one step's
   inputs, each rank's parameter and Adam-moment bytes exactly 12 × the
   parameters it holds, the collectives a step by group, kind and bytes,
   and steps/s a rank.

``--profile`` adds a ``torch.profiler`` window over a few steps of each
path and the step rates of the importance-sampled pool step, the uniform
arm and the scoretable step, in turns (see :func:`profile_phase`).

Any failed check exits non-zero. The second-to-last line of stdout is the
``kernels`` JSON object, the last ``{"ok": true, "device": {...}}``. The
per-case details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data sheet: HBM3 rate and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN_STEPS = 30
WARMUP_STEPS = 3
TWO_RANKS = 2
TWO_RANK_STEPS = 10   # timed steps a rank in phase 6
TELEMETRY_TURN = 10   # steps a turn of phase 8's rates
TELEMETRY_TURNS = ("off", "on", "on", "off")
PROBE_STEPS = 6       # steps of phase 8 with variance_probe_every=2
TIMED_CALLS = 50      # kernel calls captured in one CUDA graph
TIMED_REPLAYS = 20    # replays of that graph, median taken
SOURCE = "mercury_tpu_torch/ops/csrc/mercury_kernels.cu"
REPLACES = {
    "nll_fwd": "mercury_tpu/ops/mercury_kernels.py:82",
    "nll_bwd": "mercury_tpu/ops/mercury_kernels.py:127",
    "score_and_draw": "mercury_tpu/ops/mercury_kernels.py:279",
    "table_refresh_draw": "mercury_tpu/ops/mercury_kernels.py:394",
    "augment_normalize": "mercury_tpu/ops/mercury_kernels.py:531",
}
def spare_card(torch, mk, card: str) -> dict:
    """(f) Only when a second card is visible: the device backend of a
    Trainer on card 0 scores on the spare card ``reserve_scorer_device``
    gives. From one snapshot, taken just before three steps rewrite the
    parameters it copied, the spare card's two chunks agree with the host
    fleet's on card 0 to the kernel phase's ``nll_fwd`` tolerance (so the
    copy to the spare read the parameters before the allocator could
    reuse them); then a live fit applies the spare card's chunks."""
    if torch.cuda.device_count() < 2:
        print(f"service (f): one card visible, the spare-card path is not run [{card}]")
        return {"run": False}
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.sampling.scorer_fleet import ScorerFleet
    from mercury_tpu_torch.sampling.scorer_service import ScorerService

    config = TrainConfig(**ASYNC_TABLE, scorer_backend="device", snapshot_every=4)
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    ds, model, dev = trainer.dataset, trainer.state.model, trainer.device
    program = trainer._scorer_fleet.summary()["program"]
    check(program == {"backend": "device", "device": "cuda:1", "dedicated_slice": True},
          f"spare card: the device backend on {dev} scores with {program}")
    fleet = ScorerFleet(ds, model, config.replace(scorer_backend="host"), dev)
    svc = ScorerService(ds, model, config, dev)
    for s in (fleet, svc):
        s.close()
        s.snapshot(model, trainer.state.step)
    for _ in range(3):
        trainer.train_step()
    host = [fleet.score_once() for _ in range(2)]
    spare = [svc.score_once() for _ in range(2)]
    errs = [within(b.scores, a.scores, rtol=1e-5, atol=1e-5) for a, b in zip(host, spare)]
    bit_equal = all(torch.equal(a.scores, b.scores) for a, b in zip(host, spare))
    check(all(torch.equal(a.slots, b.slots) for a, b in zip(host, spare))
          and svc.launch_counts["nll_fwd"] == 2,
          f"spare card: chunks {[c.slots[:4] for c in spare]}, "
          f"nll_fwd {svc.launch_counts['nll_fwd']}")
    live = trainer._scorer_fleet
    fitted = trainer.fit(steps=16)
    summary = live.summary()
    check(math.isfinite(fitted["train/loss"]) and summary["chunks_applied"] >= 1
          and live.launch_counts["nll_fwd"] >= 1
          and bool(torch.isfinite(trainer.state.scoretable.scores).all()),
          f"spare card: fit gave {fitted}, {summary}")
    trainer.close()
    print(f"service (f): {torch.cuda.device_count()} cards visible; the device backend on "
          f"{dev} scores on {program['device']}; its 2 chunks from a snapshot taken before "
          f"3 steps against the host fleet's on {dev}: max |err| {max(errs):.2e}, bit-equal "
          f"{bit_equal}; after fit(steps=16), {summary['chunks_applied']} chunks applied and "
          f"{live.launch_counts['nll_fwd']} nll_fwd on the spare since the Trainer was built "
          f"[{card}]")
    del trainer, fleet, svc, live
    torch.cuda.empty_cache()
    return {"run": True, "cards": torch.cuda.device_count(), "max_abs_err": max(errs),
            "bit_equal": bit_equal, "chunks_applied": summary["chunks_applied"]}


# The one PyTorch computation of each kernel's function timed as library_ms.
LIBRARY_CALLS = {
    "nll_fwd": 'F.cross_entropy(reduction="none")',
    "nll_bwd": "2 ATen calls: nll_loss_backward, _log_softmax_backward_data",
}
# The configuration of the scoretable path (phase 5), beside the default.
SCORETABLE = dict(model="resnet18", dataset="synthetic", world_size=1,
                  sampler="scoretable", fused_input=True)
# The configuration of phase 7: the default pool step, two microsteps an
# update.
ACCUM = dict(model="resnet18", dataset="synthetic", world_size=1, grad_accum_steps=2)
ACCUM_FIRST = 3  # microsteps before the save: the middle of the second window
ACCUM_RUN = 4    # microsteps after it, on the live and on the restored trainer
ACCUM_RATE = 10  # microsteps a turn of the rate (live, restored, restored, live)
# Phase 9, the config surface: (a) the pool path at full width and depth
# 152 on 100 classes, with gradient-norm scores and the IID augmentation;
# (b) the scoretable path at depth 101 with cutout, then fused without it;
# (c) label smoothing on the plain route; (d) fit's step budget.
SURFACE_POOL = dict(model="resnet152", dataset="cifar100", world_size=1,
                    importance_score="grad_norm", augmentation="iid")
SURFACE_TABLE = dict(model="resnet101", dataset="cifar100", world_size=1,
                     sampler="scoretable", cutout=True)
SURFACE_POOL_STEPS = 20
SURFACE_TABLE_STEPS = 10
SURFACE_FUSED_STEPS = 5
SMOOTH_STEPS = 3
# Phase 10, the host stream: (a) the default pool path with its pixels in
# host memory, against the replicated placement; (b) the streamed
# scoretable at CIFAR-10's train size, a 50,000-row np.memmap, with a bf16
# scorer; (c) a resume with the ring in flight; (d) the bf16 scorer on the
# replicated pool path with float32 training.
STREAM = dict(model="resnet18", dataset="synthetic", world_size=1)
STREAM_TABLE = dict(model="resnet18", dataset="synthetic", world_size=1,
                    sampler="scoretable", fused_input=True, scoring_dtype="bfloat16",
                    data_placement="host_stream")
STREAM_STEPS = 20
STREAM_ROWS = 50_000      # CIFAR-10's train split
STREAM_TEST_ROWS = 1000
STREAM_RESUME = 4         # steps live and restored in (c)
SCORING_TURNS = ("bfloat16", None, None, "bfloat16")
# Phase 11, the pool sampler's step modes on the main path's config: (a)
# pipelined scoring, (b) a score refresh every 8 steps, (c) the groupwise
# sampler with the fused ingest; each against the default pool step in turns.
MODES = {"pipelined": dict(pipelined_scoring=True),
         "cadence": dict(score_refresh_every=8),
         "groupwise": dict(sampler="groupwise", fused_input=True)}
MODE_STEPS = 20
MODE_TURNS = ("pool", "pipelined", "cadence", "groupwise",
              "groupwise", "cadence", "pipelined", "pool")
MODE_RESUME = 4           # steps live and restored after a save
# Phase 12, the gradient path's options at W=2 (two gloo ranks on the one
# card): each arm 3 warm steps, then GRAD_STEPS timed steps in a turn after
# the plain W=2 step's GRAD_STEPS.
GRAD_ARMS = {"zero": dict(zero_sharding=True),
             "int8": dict(grad_compression="int8"),
             "zero_int8": dict(zero_sharding=True, grad_compression="int8"),
             "stochastic": dict(grad_compression="stochastic")}
GRAD_STEPS = 5
GRAD_RESUME = 4           # steps live and restored after a save (ZeRO arms)
# Phase 13, async scoring: phase 5's scoretable config with
# refresh_mode="async" (its fused ingest, and the plain one), against the
# sync step in turns, and with the fleet throttled; phase 10 (b)'s
# streamed scoretable under async.
ASYNC_TABLE = dict(SCORETABLE, refresh_mode="async")
ASYNC_STEPS = 10
ASYNC_TURNS = ("sync", "async", "throttled", "throttled", "async", "sync")
ASYNC_THROTTLE_S = 0.005
# Phase 14, the scorer service: (b) sync, the async host fleet and the
# async device backend in turns; (c) two tenants at "3,1" against one, in
# turns; (d) the device backend's lockstep at W=2 over gloo, run twice.
SERVICE_STEPS = 10
SERVICE_TURNS = ("sync", "host", "device", "device", "host", "sync")
TENANT_STEPS = 20
TENANT_TURNS = ("one", "two", "two", "one")
TENANT_WEIGHTS = "3,1"
LOCKSTEP = dict(ASYNC_TABLE, world_size=TWO_RANKS, scorer_backend="device", snapshot_every=4)
LOCKSTEP_STEPS = 16
# Phase 15, the command line: the main path's config as flags, a 40-step
# fit with a record every 10 steps, and the fit's rate with and without the
# metric stream in turns.
CLI_ARGS = ["--model", "resnet18", "--dataset", "synthetic", "--world-size", "1"]
CLI_FIT_STEPS = 40
CLI_LOG_EVERY = 10
CLI_RATE_STEPS = 15
CLI_RATE_TURNS = ("none", "records", "log_dir", "log_dir", "records", "none")
CLI_RATE_ARMS = {"none": dict(log_every=0, heartbeat_every=0),
                 "records": dict(log_every=CLI_LOG_EVERY, heartbeat_every=0),
                 "log_dir": dict(log_every=CLI_LOG_EVERY, heartbeat_every=CLI_LOG_EVERY)}
CLI_TIMEOUT_S = 300
# Phase 16: the main path's config with the durability defaults.
DURABLE = dict(model="resnet18", dataset="synthetic", world_size=1, eval_every=0,
               log_every=0)
DURABLE_FIT = 24          # (a) steps, a save every DURABLE_EVERY
DURABLE_EVERY = 8
RATE_FIT = 40             # (b) steps of a turn, a save every RATE_EVERY
RATE_EVERY = 10
RATE_TURNS = ("sync", "async", "async", "sync")
FLIP_RUN = 8              # (c) steps after the fallback
ELASTIC_AT = 4            # (e) the step of the saves restored elastically
ELASTIC_RUN = 8           # (e) steps after the shrink's restore
GROW_RUN = 4              # (e) steps a rank after the grow's restore
STALL = "prefetch_stall@step=5,secs=0.5"
STALL_STEPS = 10          # (f)
# Phase 17 (PR 19): the supervised runtime on phase 5's config under async
# refresh, with a log_dir (the journal, flight records, the summary).
SUPERVISED = dict(ASYNC_TABLE, supervise=True, supervisor_backoff_s=0.0, eval_every=0,
                  log_every=10, heartbeat_every=0)
SUP_FIT = 20              # (a) steps after the warm-up; the death at step 5
SUP_RATE = 15             # (a) steps a turn of the rates
SUP_TURNS = ("plain", "supervised", "journal_off", "journal_off", "supervised", "plain")
CHAOS = ("scorer_die@step=1,every=1;scorer_die@step=1,every=1;"
         "host_slow@step=1,every=1,secs=0.02")
CHAOS_STEPS = 12          # (b)
RECOVER_STEPS = 12        # (c)
PREFETCH_STEPS = 8        # (d), the death at step 3
# Phase 18: the main path's config with the tracer, the status
# server, a log_dir and an anomaly-armed profiler window; the W=2 lockstep
# config supervised, with cross-rank aggregation and the agreed ladder.
# Only the injected NaN triggers (a): slow_step and the MFU floor are off,
# so the NaN's window is the one that opens.
OBS = dict(model="resnet18", dataset="synthetic", world_size=1, eval_every=0, log_every=10,
           heartbeat_every=0, anomaly_slow_step_factor=0.0, slo_mfu_floor=0.0)
OBS_STEPS = 30            # (a) steps of each fit
OBS_NAN_STEP = 12         # (a) the injected NaN: the tick at step 20 opens the window
OBS_WINDOW = 3            # (a) steps of the profiler window
OBS_TURN = 15             # (a) steps a turn of the rates
# The arms of the rates: the tracer on, and the status server scraped once
# a second (a fast prober) or ten times a second (30 scrapes a second).
OBS_TURNS = ("off", "trace", "serve10", "serve1", "serve1", "serve10", "trace", "off")
OBS_SCRAPE_S = {"serve1": 1.0, "serve10": 0.1}
OBS_SPANS = 20_000        # spans timed for a span's host ns
OBS_RANKS = dict(LOCKSTEP, supervise=True, supervisor_backoff_s=0.0, eval_every=0,
                 log_every=2, heartbeat_every=0, anomaly_straggler_factor=1.5,
                 anomaly_slow_step_factor=0.0)
OBS_RANK_STEPS = 8        # (b) steps of each fit
OBS_SLOW = "host_slow@step=0,every=1,secs=0.1"
OBS_DIE_STEP = 3          # (b) rank 1's scorer_die
OBS_RANK_TIMEOUT_S = 120  # (b) the ladder fit must end within this
ENDPOINTS = ("/healthz", "/statusz", "/metricsz")
# Phase 19, the image family on synthetic_hard: (a) each model on the
# default pool step, its rate against the uniform arm in turns (is,
# uniform); (b) MobileNetV2 on the fused scoretable step; (c)
# ResNet-18 on digits_imb, IS against uniform, where scikit-learn imports.
IMAGE_MODELS = ("smallcnn", "vgg11", "vgg16", "mobilenetv2")
IMAGE = dict(dataset="synthetic_hard", world_size=1)
IMAGE_TABLE = dict(IMAGE, model="mobilenetv2", sampler="scoretable", fused_input=True)
IMAGE_TURNS = ("is", "uniform", "uniform", "is")
DIGITS = dict(model="resnet18", dataset="digits_imb", world_size=1, eval_every=0,
              log_every=0)
DIGITS_STEPS = 300        # (c) steps of each arm
RARE_CLASSES = (5, 6, 7, 8, 9)
# Phase 20, the sequence family at the JAX package's default widths: (a)
# path A (BiLSTM-attention) and path B (the Transformer) on synthetic_seq
# and ViT on synthetic, each on the pool step with its uniform arm in
# turns; (b) ViT on the fused scoretable step; (c) the Transformer with
# remat against without, in turns; (d) evaluate and predict on
# synthetic_seq; digits_seq only where scikit-learn imports.
SEQUENCE = dict(dataset="synthetic_seq", world_size=1, augmentation="none")
SEQUENCE_MODELS = ("bilstm_attention", "transformer")
VIT = dict(model="vit", dataset="synthetic", world_size=1)
VIT_TABLE = dict(VIT, sampler="scoretable", fused_input=True)
REMAT_TURNS = ("off", "on", "on", "off")
# Kernel launches a step of the pool and the fused scoretable steps.
POOL_STEP = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1, "table_refresh_draw": 0,
             "augment_normalize": 0}
TABLE_STEP = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 0, "table_refresh_draw": 1,
              "augment_normalize": 2}
DIGITS_SEQ = dict(SEQUENCE, model="bilstm_attention", dataset="digits_seq",
                  eval_every=0, log_every=0)
DIGITS_SEQ_STEPS = 30
# Phase 21: (a) the Transformer and (b) ViT with 8 experts a block; (c) the
# experts' layer on the train forward's tokens (batch 32 × T 32); (d) the
# main path at scan_steps=SCAN_K against 1, SCAN_STEPS steps a turn.
MOE_SEQ = dict(SEQUENCE, model="transformer", moe_experts=8)
MOE_VIT_TABLE = dict(VIT_TABLE, moe_experts=8)
MOE_TOKENS = 32 * 32
MOE_TILT = 4.0            # (c) added to expert 0's router bias
SCAN = dict(model="resnet18", dataset="synthetic", world_size=1)
SCAN_K = 4
SCAN_STEPS = 16
SCAN_TURNS = (1, SCAN_K, SCAN_K, 1)
# Phase 22, the mesh, gloo ranks on card 0: (a) the Transformer of phase 20
# at W=2 × T=2 against W=2 × T=1; (b) ResNet-18 at W=1 × F=2 against W=1.
MESH_TP = dict(SEQUENCE, model="transformer", world_size=2, compute_dtype="float32")
MESH_FSDP = dict(model="resnet18", dataset="synthetic", world_size=1)
MESH_N = 2                # T and F
MESH_STEPS = 10           # timed steps of each arm
MESH_KINDS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single")
MESH_SERIES = ("train/pool_loss", "train/loss", "train/grad_norm")
MESH_TP_RTOL = 1e-4       # (a) T=2 against T=1, float32, while the draws agree
# Phase 23, the compositions of a second axis: (a) phase 22's Transformer
# at W=2 × T=2 with each gradient wire; (b) ResNet-18 at W=1 × F=2 on the
# fused scoretable under async refresh; (c) (a)'s "none" file restored
# elastically at W=1 × T=2, against W=1 in this process.
COMP_WIRES = ("none", "int8", "stochastic")
COMP_STEPS = 10           # timed steps of each arm
COMP_TP_BYTES = 5_578_872  # a T=2 rank's parameter and moment bytes (phase 22)
COMP_ASYNC = dict(model="resnet18", dataset="synthetic", world_size=1, sampler="scoretable",
                  fused_input=True, refresh_mode="async", scorer_workers=1, snapshot_every=4,
                  fsdp_parallel=MESH_N)
# Kernel launches a step of the async step: nll_fwd [32, C], nll_bwd,
# table_refresh_draw at R=1, augment_normalize [32] with rows.
ASYNC_STEP = {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 0, "table_refresh_draw": 1,
              "augment_normalize": 1}
COMP_RESTORED_STEPS = 3
COMP_RESTORE_RTOL = 1e-5  # (c) T=2 against T=1 after the restore, float32
# Phase 24, sequence parallelism, gloo ranks on card 0: (a) phase 20's
# Transformer on synthetic_seq at W=1 × S=2 under each sp_impl against S=1
# in this process; (b) the ring at W=2 × S=2; (c) the attentions alone at
# a long length against dense attention.
SP_ARMS = {"ring": dict(sp_impl="ring"), "zigzag": dict(sp_impl="zigzag", causal=True),
           "ulysses": dict(sp_impl="ulysses")}
SP_S = 2                  # the seq axis
SP_STEPS = 10             # timed steps after the warm-up
SP_BATCH, SP_PRESAMPLE = 32, 10
SP_LR = 1e-3              # Adam
SP_LONG = (2, 4096, 4, 32)  # (c): B, L, H, D
SP_LONG_IMPLS = (("ring", False), ("ulysses", False), ("zigzag", True))
SP_LONG_REPEATS = 3       # timed forwards and backwards after one untimed
SP_LONG_ATOL = 1e-4       # (c): the output against dense attention
SP_LONG_GRAD_RTOL = 1e-3  # (c): the gradients, of max(|g|, 1)
# Phase 25, pipeline parallelism, gloo ranks on card 0: (a) phase 20's ViT
# on synthetic through train/pp_step.py at S=2, M=2 and S=4, M=4, (b) phase
# 21's Transformer with 8 experts at S=2, M=2, each against S=1 at its M in
# this process; (name, microbatches, timed steps) by S.
PP_ARMS = {1: (("vit", 2, 10), ("vit", 4, 10), ("moe", 2, 5)),
           2: (("vit", 2, 10), ("moe", 2, 5)),
           4: (("vit", 4, 10),)}
PP_RTOL = 1e-5            # step 1's loss and router loss against S=1, float32
# A rank's parameter and Adam-moment bytes, 12 an element: ViT's blocks hold
# 198,272 parameters each and the rest 16,010; the experts' 1,121,288 and
# 265,866.
PP_BYTES = {("vit", 1): 9_709_176, ("vit", 2): 4_950_648, ("vit", 4): 2_571_384,
            ("moe", 1): 30_101_304, ("moe", 2): 16_645_848}
# Phase 26, two model axes, on phase 25's process group of four gloo ranks:
# (a) phase 20's Transformer at pipe 2 × seq 2 (ring attention), (b) phase
# 21's Transformer with 8 experts a block at pipe 2 × expert 2, capacity
# factor 8 (every token admitted), each at M=2 against S=1 at M=2 in this
# process; keywords by arm, timed steps after the warm-up, and a rank's
# parameter and Adam-moment bytes (12 an element: one block of 198,272
# parameters, or 66,560 + 1,032 + 4 of the 8 experts' 131,712 each, and the
# 265,866 outside the blocks).
PP2D_ARMS = {"seq": dict(sp_impl="ring"), "expert": dict(moe_experts=8,
                                                         moe_capacity_factor=8.0)}
PP2D_STEPS = {"seq": 10, "expert": 5}
PP2D_M = 2
PP2D_BYTES = {"seq": 5_569_656, "expert": 10_323_672}
PP2D_RTOL = 1e-5          # step 1's loss and router loss against S=1, float32
# (b)'s S=1 batch in the grouping of the expert ranks' microbatches: its
# microbatch t of 16 rows is rows e·16 + [t·8, (t+1)·8) of the drawn batch
# for e = 0, 1 (JAX's group_perm in tests/test_expert_parallel.py).
PP2D_GROUP_ORDER = [e * 16 + t * 8 + j for t in range(2) for e in range(2) for j in range(8)]
# The torch.distributed calls whose bytes phase 12 counts: the tensor
# handed in (all_reduce's buffer, the input of the others), and what a
# rank of W sends for it in a bandwidth-optimal algorithm, as a multiple
# of those bytes (a ring all-reduce 2(W−1)/W; all-to-all and
# reduce-scatter (W−1)/W; all-gather W−1).
WIRE_CALLS = {"all_reduce": lambda w: 2 * (w - 1) / w,
              "all_to_all_single": lambda w: (w - 1) / w,
              "all_gather_into_tensor": lambda w: w - 1,
              "reduce_scatter_tensor": lambda w: (w - 1) / w}
# CIFAR-100's normalization (float32 in the dataset).
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
# Parameter counts at full width, by model and class count (CPU tests hold
# them to the JAX package's models); phase 19's models have synthetic_hard's
# 20 classes, phase 20's the 10 of synthetic_seq ([32, 16] sequences) and
# synthetic.
PARAMETERS = {("resnet18", 10): 11_173_962, ("resnet18", 100): 11_220_132,
              ("resnet101", 100): 42_697_380, ("resnet152", 100): 58_341_028,
              ("smallcnn", 20): 5_796, ("vgg11", 20): 9_291_476,
              ("vgg16", 20): 14_787_156, ("mobilenetv2", 20): 2_249_492,
              ("bilstm_attention", 10): 675_722, ("transformer", 10): 662_410,
              ("vit", 10): 809_098}
# The same with moe_experts=8 (phase 21): each block's dense MLP becomes
# eight experts and a router.
MOE_PARAMETERS = {("transformer", 10): 2_508_442, ("vit", 10): 4_501_162}

# The metric keys of the JAX package's default step (pool), its scoretable
# step and its async scoretable step, with telemetry on (its default): a CPU test holds this
# literal to the JAX step's own keys.
_W_HIST = [f"sampler_dist/w_hist/b{i:02d}" for i in range(16)]
_SCORE_HIST = [f"sampler_dist/score_hist/b{i:02d}" for i in range(16)]
JAX_STEP_KEYS = {
    "pool": {"train/loss", "train/acc", "train/pool_loss", "train/sparse_rate",
             "train/moe_aux", "sampler/ess", "sampler/clip_frac", "sampler/ema_drift",
             "train/grad_norm", *_W_HIST},
    "scoretable": {"train/loss", "train/acc", "train/pool_loss", "train/sparse_rate",
                   "train/moe_aux", "sampler/ess", "sampler/clip_frac",
                   "sampler/ema_drift", "train/grad_norm", "sampler/table_age_min",
                   "sampler/table_age_mean", "sampler/table_age_max", *_W_HIST,
                   *_SCORE_HIST},
}
# The async scoretable step: no window, so no table ages.
JAX_STEP_KEYS["async"] = JAX_STEP_KEYS["scoretable"] - {
    "sampler/table_age_min", "sampler/table_age_mean", "sampler/table_age_max"}
# The JAX keys of options the port does not implement (none since the
# mixture of experts), and the port's own keys: the draws.
JAX_ONLY_KEYS: set = set()
PORT_ONLY_KEYS = {"sampler/selected", "sampler/probs"}
# The seven keys of the scoretable Trainer's sampler-health monitor.
MONITOR_KEYS = {"sampler_dist/frac_never_selected", "sampler_dist/gini",
                "sampler_dist/class_share_min", "sampler_dist/class_share_max",
                "sampler_dist/class_starved", "sampler_dist/bias_chi2",
                "sampler_dist/bias_ok"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    # Fails here when the script stands alone, without the package.
    from mercury_tpu_torch.ops import _build

    card = run_phase("device", device_phase, torch)
    build_s, ptxas = run_phase("build", build_phase, _build)
    print(f"build: {build_s:.1f} s (nvcc, sm_90a)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    kernels, cases = run_phase("kernels", kernel_phase, torch, card)
    main_path = run_phase("main path", main_path_phase, torch, card)
    table_path = run_phase("scoretable path", scoretable_path_phase, torch, card)
    two_ranks = run_phase("two ranks", two_rank_phase, torch, card, main_path)
    accum = run_phase("resume and accumulate", accum_resume_phase, torch, card, main_path)
    telemetry = run_phase("telemetry", telemetry_phase, torch, card, main_path, table_path)
    surface = run_phase("config surface", config_surface_phase, torch, card)
    stream = run_phase("host stream", host_stream_phase, torch, card)
    modes = run_phase("sampler modes", sampler_modes_phase, torch, card)
    grad = run_phase("gradient path", grad_path_phase, torch, card, main_path)
    async_ = run_phase("async scoring", async_scoring_phase, torch, card, stream["summary"])
    service = run_phase("scorer service", scorer_service_phase, torch, card)
    cmd = run_phase("command line", command_line_phase, torch, card)
    durable = run_phase("durable checkpoints", durable_phase, torch, card, main_path, table_path)
    supervised = run_phase("supervised runtime", supervised_phase, torch, card, main_path,
                           table_path)
    observed = run_phase("observability", observability_phase, torch, card, main_path)
    image = run_phase("image family", image_family_phase, torch, card)
    sequence = run_phase("sequence family", sequence_family_phase, torch, card)
    experts = run_phase("experts and chunks", experts_chunks_phase, torch, card)
    mesh = run_phase("mesh", mesh_phase, torch, card, main_path)
    compositions = run_phase("mesh compositions", mesh_compositions_phase, torch, card,
                             main_path)
    sp = run_phase("sequence parallelism", sequence_parallel_phase, torch, card)
    pp = run_phase("pipeline parallelism", pipeline_parallel_phase, torch, card)
    pp2d = run_phase("two model axes", two_model_axes_phase, torch, card, pp["pp2d_ranks"])
    for k in kernels:
        by_path = {"pool": main_path["launches"][k["name"]],
                   "scoretable": table_path["launches"][k["name"]],
                   "two_ranks": two_ranks["launches"][k["name"]],
                   "accum_resume": accum["launches"][k["name"]],
                   "config_surface": surface["launches"][k["name"]],
                   "host_stream": stream["launches"][k["name"]],
                   "sampler_modes": modes["launches"][k["name"]],
                   "grad_path": grad["launches"][k["name"]],
                   "async_scoring": async_["launches"][k["name"]],
                   "scorer_service": service["launches"][k["name"]],
                   "command_line": cmd["launches"][k["name"]],
                   "durable_checkpoints": durable["launches"][k["name"]],
                   "supervised_runtime": supervised["launches"][k["name"]],
                   "observability": observed["launches"][k["name"]],
                   "observability_two_ranks": observed["two_rank_launches"][k["name"]],
                   "image_models": image["launches"][k["name"]],
                   "sequence_models": sequence["launches"][k["name"]],
                   "experts_and_chunks": experts["launches"][k["name"]],
                   "mesh": mesh["launches"][k["name"]],
                   "mesh_compositions": compositions["launches"][k["name"]],
                   "sequence_parallel": sp["launches"][k["name"]],
                   "pipeline_parallel": pp["launches"][k["name"]],
                   "two_model_axes": pp2d["launches"][k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    if "--profile" in sys.argv:
        run_phase("profile", profile_phase, torch, card, main_path, table_path)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "phase_seconds": PHASE_SECONDS,
         "kernels": kernels, "cases": cases,
         "main_path": main_path["summary"], "scoretable_path": table_path["summary"],
         "two_ranks": two_ranks["summary"], "accum_resume": accum["summary"],
         "telemetry": telemetry, "config_surface": surface["summary"],
         "host_stream": stream["summary"], "sampler_modes": modes["summary"],
         "grad_path": grad["summary"], "async_scoring": async_["summary"],
         "scorer_service": service["summary"], "command_line": cmd["summary"],
         "durable_checkpoints": durable["summary"],
         "supervised_runtime": supervised["summary"],
         "observability": observed["summary"], "image_family": image["summary"],
         "sequence_family": sequence["summary"],
         "experts_and_chunks": experts["summary"], "mesh": mesh["summary"],
         "mesh_compositions": compositions["summary"],
         "sequence_parallel": sp["summary"], "pipeline_parallel": pp["summary"],
         "two_model_axes": pp2d["summary"]},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Each phase's seconds, by name, in the order run (written to chip_smoke.json).
PHASE_SECONDS: dict = {}


def run_phase(name, fn, *args):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"   {name}: passed in {PHASE_SECONDS[name]:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ phase 1
def device_phase(torch) -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"device 0: {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    return card


# ------------------------------------------------------------------ phase 2
def build_phase(_build):
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    return time.perf_counter() - t0, _build.build_log


# ------------------------------------------------------------------ phase 3
def graph_ms(torch, fn) -> float:
    """Device time of one call: TIMED_CALLS calls captured in a CUDA graph
    and replayed between CUDA events, so the host's launch cost is out of
    the number; median over TIMED_REPLAYS replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_CALLS)
    return statistics.median(times)


def eager_ms(torch, fn, calls: int = 200) -> float:
    """Time per call on the stream when called one by one from Python:
    what the eager main path pays, host launch cost included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, rtol: float, atol: float) -> float:
    """Max |got − want|; fails unless |got − want| ≤ atol + rtol·|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"max |err| {float(err.max()):.3e} over atol {atol} + rtol {rtol}")
    return float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, card: str):
    import torch.nn.functional as F

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.ops import reference
    from mercury_tpu_torch.ops.select_sweep import aten_nll_backward

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # The nll_bwd cases beyond the first four draw from a generator of their
    # own, so every other case keeps its inputs.
    bwd_gen = torch.Generator(device=dev).manual_seed(7)
    cases = []

    def logits_case(n, c, dtype, rng=gen):
        z = (torch.randn(n, c, generator=rng, device=dev) * 3).to(dtype)
        y = torch.randint(0, c, (n,), generator=rng, device=dev, dtype=torch.int32)
        return z, y

    # nll_fwd: expf/logf against ATen's exp/log, reductions in another
    # order; losses are O(10). The pool's scores [320, 10], the train batch
    # [32, 10], the scoretable window [64, 10], and a CIFAR-100-sized call.
    fwd_tol = dict(rtol=1e-5, atol=1e-5)
    # nll_bwd (check_bwd): f32 to ~1 ulp of softmax, rtol 1e-5, atol 1e-6;
    # bf16 to one bf16 ulp of the plain version's float32 gradient before
    # its cast. The kernel sums Σexp in float64, the plain version in
    # float32, so a value near a rounding midpoint may round the other way:
    # one ulp from the plain bf16 gradient, counted as `one_ulp`.
    # Phase 9's CIFAR-100 calls — the pool [320, 100], the train batch
    # [32, 100] and the scoretable window [64, 100] — draw from a generator
    # of their own, so every other case keeps its inputs.
    c100_gen = torch.Generator(device=dev).manual_seed(11)
    # Phase 19's 20 classes (synthetic_hard): the pool, the train batch and
    # the scoretable window, from a generator of their own too.
    c20_gen = torch.Generator(device=dev).manual_seed(13)
    for rng, n, c, dtype in [(gen, 320, 10, torch.float32), (gen, 32, 10, torch.float32),
                             (gen, 64, 10, torch.float32), (gen, 4096, 100, torch.float32),
                             (gen, 320, 10, torch.bfloat16), (gen, 32, 10, torch.bfloat16),
                             (gen, 64, 10, torch.bfloat16), (gen, 4096, 100, torch.bfloat16),
                             (c100_gen, 320, 100, torch.float32),
                             (c100_gen, 32, 100, torch.float32),
                             (c100_gen, 64, 100, torch.float32),
                             (c20_gen, 320, 20, torch.float32),
                             (c20_gen, 32, 20, torch.float32),
                             (c20_gen, 64, 20, torch.float32)]:
        z, y = logits_case(n, c, dtype, rng)
        err = within(mk.nll_fwd_kernel(z, y), reference.nll_forward(z, y), **fwd_tol)
        y64 = y.long()
        geo = mk.nll_geometry(n, c, z.element_size())
        case = dict(kernel="nll_fwd", shape=[n, c], dtype=str(dtype)[6:],
                    lanes=geo.lanes, threads=geo.threads, vec=geo.vec,
                    max_abs_err=err, tol=fwd_tol,
                    ms=graph_ms(torch, lambda: mk.nll_fwd_kernel(z, y)),
                    eager_ms=eager_ms(torch, lambda: mk.nll_fwd_kernel(z, y)),
                    plain_ms=graph_ms(torch, lambda: reference.nll_forward(z, y)),
                    library_ms=graph_ms(torch, lambda: F.cross_entropy(
                        z, y64, reduction="none")))
        esize = z.element_size()
        case["bound_ms"], case["bound_by"] = bound(n * c * esize + 8 * n,
                                                   5 * n * c + 2 * n)
        cases.append(case)

    def odd_case(kernel, rng, n, c, dtype, off):
        """Untimed: logits a pointer ``off`` elements past 16-byte aligned,
        labels in [-1, C]."""
        flat = (torch.randn(n * c + off, generator=rng, device=dev) * 3).to(dtype)
        z = flat[off:].view(n, c)
        y = torch.randint(-1, c + 1, (n,), generator=rng, device=dev, dtype=torch.int32)
        one_ulp = None
        if kernel == "nll_fwd":
            err = within(mk.nll_fwd_kernel(z, y), reference.nll_forward(z, y), **fwd_tol)
        else:
            g = torch.rand(n, generator=rng, device=dev) + 0.1
            err, one_ulp = check_bwd(torch, reference, f"nll_bwd odd [{n},{c}]",
                                     mk.nll_bwd_kernel(z, y, g), z, y, g)
        geo = mk.nll_geometry(n, c, z.element_size(), mk._alignment(z))
        print(f"{kernel} [{n},{c}] {str(dtype)[6:]} pointer +{off * z.element_size()} B, labels "
              f"in [-1, C]: lanes={geo.lanes} threads={geo.threads} vec={geo.vec}, "
              f"max|err| {err:.2e}" + ("" if one_ulp is None else f", {one_ulp} one-ulp"))
        return dict(kernel=kernel, shape=[n, c], dtype=str(dtype)[6:], offset=off,
                    lanes=geo.lanes, threads=geo.threads, vec=geo.vec, max_abs_err=err,
                    one_ulp=one_ulp)

    # Untimed: non-finite rows; shapes that take one value a load (C odd, a
    # pointer one element off), the widest loads, many lanes a row, and rows
    # too long for a lane's registers (walked in chunks).
    nll_checks = [check_nonfinite(torch, mk, reference, "nll_fwd", dtype, c, fwd_tol)
                  for dtype in (torch.float32, torch.bfloat16) for c in (10, 100)]
    odd_shapes = [(33, 1, torch.float32, 0), (31, 3, torch.bfloat16, 0),
                  (64, 33, torch.float32, 0), (64, 10, torch.float32, 1),
                  (64, 10, torch.bfloat16, 1), (64, 1000, torch.bfloat16, 0),
                  (300, 1000, torch.float32, 0), (16, 2053, torch.float32, 0),
                  (8, 40000, torch.bfloat16, 0)]
    nll_checks += [odd_case("nll_fwd", gen, *shape) for shape in odd_shapes]

    # nll_bwd: the train batch [32, 10] (the step's one call) and a
    # CIFAR-100-sized call, then (from bwd_gen) the scoretable window and
    # pool widths, phase 9's train batch [32, 100] and phase 19's [32, 20];
    # the library is the
    # 2 ATen calls of F.cross_entropy's gradient.
    for rng, n, c, dtype in [(gen, 32, 10, torch.float32), (gen, 4096, 100, torch.float32),
                             (gen, 32, 10, torch.bfloat16), (gen, 4096, 100, torch.bfloat16),
                             (bwd_gen, 64, 10, torch.float32), (bwd_gen, 64, 10, torch.bfloat16),
                             (bwd_gen, 320, 10, torch.float32),
                             (bwd_gen, 320, 10, torch.bfloat16),
                             (c100_gen, 32, 100, torch.float32),
                             (c20_gen, 32, 20, torch.float32)]:
        z, y = logits_case(n, c, dtype, rng)
        g = torch.rand(n, generator=rng, device=dev) + 0.1
        got = mk.nll_bwd_kernel(z, y, g)
        check(got.dtype == dtype, f"nll_bwd returned {got.dtype}, not {dtype}")
        err, one_ulp = check_bwd(torch, reference, f"nll_bwd [{n},{c}]", got, z, y, g)
        geo = mk.nll_geometry(n, c, z.element_size())
        case = dict(kernel="nll_bwd", shape=[n, c], dtype=str(dtype)[6:],
                    lanes=geo.lanes, threads=geo.threads, vec=geo.vec,
                    max_abs_err=err, one_ulp=one_ulp,
                    tol="rtol 1e-5, atol 1e-6" if dtype == torch.float32
                    else "one bf16 ulp of the plain float32 gradient",
                    ms=graph_ms(torch, lambda: mk.nll_bwd_kernel(z, y, g)),
                    eager_ms=eager_ms(torch, lambda: mk.nll_bwd_kernel(z, y, g)),
                    plain_ms=graph_ms(torch, lambda: reference.nll_backward(z, y, g)),
                    library_ms=graph_ms(torch, aten_nll_backward(torch, z, y.long(), g)))
        esize = z.element_size()
        case["bound_ms"], case["bound_by"] = bound(2 * n * c * esize + 8 * n,
                                                   7 * n * c + 2 * n)
        cases.append(case)

    # Untimed nll_bwd, from bwd_gen: non-finite rows, the forward's odd
    # shapes, the logits' pointer 4 bytes off in bf16 and a [64, 100] row
    # of single loads (the stores narrow too; the fresh gradient is
    # aligned, so the two kernels take one geometry).
    nll_checks += [check_nonfinite(torch, mk, reference, "nll_bwd", dtype, c, None)
                   for dtype in (torch.float32, torch.bfloat16) for c in (10, 100)]
    nll_checks += [odd_case("nll_bwd", bwd_gen, *shape)
                   for shape in odd_shapes + [(64, 10, torch.bfloat16, 2),
                                              (64, 100, torch.float32, 1)]]

    # The autograd route: per_sample_nll(...).backward runs the bwd kernel.
    z, y = logits_case(32, 10, torch.float32)
    zk = z.clone().requires_grad_()
    mk.per_sample_nll(zk, y).mean().backward()
    within(zk.grad, reference.nll_backward(z, y, torch.full((32,), 1 / 32, device=dev)),
           rtol=1e-5, atol=1e-7)

    # The pool (320) and larger arrays up to a million, across the cluster
    # sizes (one block up to 8192, then up to the card's limit) and the runs
    # read from device memory (1,000,000); all mass on the first element
    # (u -> 1 clamps to n - 1) and, in a cluster, all mass in the last block.
    print(f"selection kernels: clusters of up to {mk.cluster_limit()} blocks [{card}]")
    for n, skew in [(320, None), (1000, None), (5000, None), (50000, None),
                    (50001, None), (1_000_000, None), (320, "first"),
                    (50000, "first"), (50000, "last")]:
        cases.append(draw_case(torch, mk, reference, gen, n, 32, skew))

    # The table over the synthetic shard (5000), CIFAR-10's (50,000) and a
    # million slots, a window of 64, a batch of 32. The window wraps past
    # the table's end as the round-robin cursor does, or straddles the
    # boundary of the first two blocks; one case with repeated slots.
    for n, dup, wrap in [(5000, False, True), (5000, True, True), (50000, False, False),
                         (50000, False, True), (1_000_000, False, False)]:
        cases.append(table_case(torch, mk, reference, gen, n, 64, 32, dup, wrap))

    # The refresh window (64), the train batch (32) and the fused pool path's
    # pool (320), at both output types; all 81 offsets × both flips; the
    # window and the pool gathered by rows from the 5000-image shard, as the
    # step calls it; 30×30 images and misaligned images, staged by bytes.
    for n, dtype in [(64, torch.float32), (32, torch.float32), (320, torch.float32),
                     (64, torch.bfloat16), (32, torch.bfloat16), (320, torch.bfloat16),
                     (162, torch.float32), (162, torch.bfloat16)]:
        cases.append(augment_case(torch, mk, reference, gen, n, dtype,
                                  every_offset=n == 162))
    for n, dtype in [(64, torch.float32), (64, torch.bfloat16), (320, torch.float32)]:
        cases.append(augment_case(torch, mk, reference, gen, n, dtype, rows=True))
    for n, dtype in [(64, torch.float32), (64, torch.bfloat16)]:
        cases.append(augment_case(torch, mk, reference, gen, n, dtype, hw=30))
        cases.append(augment_case(torch, mk, reference, gen, n, dtype, misaligned=True))

    for c in cases:
        print(f"{c['kernel']:>18} {str(c['shape']):>16} {c.get('dtype', ''):>8}"
              + (f" K={c['clusters']} run={c['run']}" if "clusters" in c else "")
              + (f" skew={c['skew']}" if c.get("skew") else "")
              + (" dup" if c.get("dup") else "")
              + (" wrap" if c.get("wrap") else "")
              + (" rows" if c.get("rows") else "")
              + (" misaligned" if c.get("misaligned") else "")
              + (f" threads={c['threads']} rows/block={c['band_rows']} copy={c['copy']}"
                 if "band_rows" in c else "")
              + (f" lanes={c['lanes']} threads={c['threads']} vec={c['vec']}"
                 if "lanes" in c else "")
              + f": max|err| {c['max_abs_err']:.2e}"
              + (f", {c['one_ulp']} one-ulp" if c.get("one_ulp") is not None else "")
              + (f", {c['in_band']} u in band {c['band']:.1e}, "
                 f"{c['mismatches']} index mismatches" if "band" in c else "")
              + f"; kernel {c['ms'] * 1e3:.2f} us (eager {c['eager_ms'] * 1e3:.2f} us), "
              + (f"gather + kernel {c['gather_and_kernel_ms'] * 1e3:.2f} us, "
                 if "gather_and_kernel_ms" in c else "")
              + f"plain {c['plain_ms'] * 1e3:.2f} us, library "
              + (f"{c['library_ms'] * 1e3:.2f} us ({LIBRARY_CALLS[c['kernel']]})"
                 if c["library_ms"] else "none")
              + f", bound {c['bound_ms'] * 1e3:.4f} us ({c['bound_by']}) [{card}]")

    # One entry per kernel at its path's shape: [320, 10] f32 logits
    # (scoring; the [32, 10] train forward is the smaller call), [32, 10]
    # f32 for the backward, a pool of 320 drawn to 32, a table of 5000 with
    # a window of 64 drawn to 32, and the window's 64 images (the train
    # batch's 32 are the smaller call).
    main_shape = {"nll_fwd": [320, 10], "nll_bwd": [32, 10],
                  "score_and_draw": [320, 32], "table_refresh_draw": [5000, 64, 32],
                  "augment_normalize": [64, 32, 32, 3]}
    kernels = []
    for name in mk.KERNELS:
        c = next(c for c in cases if c["kernel"] == name
                 and c["shape"] == main_shape[name]
                 and c.get("dtype", "float32") == "float32"
                 and not (c.get("skew") or c.get("dup") or c.get("every_offset")
                         or c.get("rows") or c.get("misaligned")))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "library_call": LIBRARY_CALLS.get(name),
            "shape": c["shape"], "eager_ms": c["eager_ms"],
            "clusters": c.get("clusters"),
        })
    return kernels, cases + nll_checks


def check_nonfinite(torch, mk, reference, kernel: str, dtype, c: int, tol):
    """``kernel`` (nll_fwd or nll_bwd) on rows with non-finite logits
    against the plain version, NaN-aware: −inf off the label (a finite loss;
    a finite gradient row), −inf on the label (+inf; −g_i there), +inf and
    NaN (NaN; NaN rows), an all −inf row (NaN), a label outside [0, C) (the
    logsumexp; nothing subtracted), then finite rows. NaN must fall on NaN
    and an infinity on the same infinity; finite values within ``tol``
    (nll_fwd) or as :func:`check_bwd` holds them (nll_bwd)."""
    dev = torch.device("cuda")
    n = 40
    gen = torch.Generator(device=dev).manual_seed(c)
    z = torch.randn(n, c, generator=gen, device=dev) * 3
    y = torch.randint(0, c, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.rand(n, generator=gen, device=dev) + 0.1
    y[:6] = torch.tensor([1, 2, 0, 3, 1, c], dtype=torch.int32)
    z[0, c - 1] = -math.inf
    z[1, 2] = -math.inf
    z[2, 1] = math.inf
    z[3, 0] = math.nan
    z[4] = -math.inf
    z = z.to(dtype)
    if kernel == "nll_fwd":
        got, want = mk.nll_fwd_kernel(z, y), reference.nll_forward(z, y)
    else:
        got, want = mk.nll_bwd_kernel(z, y, g), reference.nll_backward(z, y, g)
    what = f"{kernel} non-finite {dtype} C={c}"
    nan, inf = torch.isnan(want), torch.isinf(want)
    check(torch.equal(torch.isnan(got), nan),
          f"{what}: NaN at {torch.isnan(got).nonzero().tolist()}, plain at "
          f"{nan.nonzero().tolist()}")
    check(torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf]),
          f"{what}: infinities differ")
    # Rows: those with a NaN, and those with an infinity.
    nan_rows = (nan if nan.dim() == 1 else nan.any(1)).nonzero().flatten().tolist()
    inf_rows = (inf if inf.dim() == 1 else inf.any(1)).nonzero().flatten().tolist()
    check(nan_rows == [2, 3, 4], f"{what}: NaN rows {nan_rows}")
    if kernel == "nll_fwd":
        check(inf_rows == [1], f"{what}: inf rows {inf_rows}")
    else:
        check(bool(nan[2:5].all()) and inf_rows == []
              and float(got[1, 2]) == -float(g[1].to(dtype)),
              f"{what}: rows 2-4 not all NaN, or row 1 at its label {float(got[1, 2])}")
    fin = ~(nan | inf)
    one_ulp = None
    if kernel == "nll_fwd":
        err = within(got[fin], want[fin], **tol)
    else:
        err, one_ulp = check_bwd(torch, reference, what, got[fin], z, y, g, fin)
    print(f"{kernel} non-finite rows, {str(dtype)[6:]} C={c}: NaN rows {nan_rows}, inf rows "
          f"{inf_rows} on both sides; finite max|err| {err:.2e}"
          + ("" if one_ulp is None else f", {one_ulp} one-ulp"))
    return dict(kernel=kernel, shape=[n, c], dtype=str(dtype)[6:], nonfinite=True,
                max_abs_err=err, nan_rows=nan_rows, inf_rows=inf_rows, one_ulp=one_ulp)


def check_bwd(torch, reference, what: str, got, z, y, g, mask=None):
    """nll_bwd's gradient ``got`` of ``(z, y, g)`` (its elements at
    ``mask``) against the plain version (``select_sweep.nll_bwd_misfits``):
    f32 within rtol 1e-5, atol 1e-6; bf16 within one bf16 ulp of the plain
    version's float32 gradient before its cast. Returns the max |err| and,
    for bf16, the count of elements one ulp from the plain bf16 gradient."""
    from mercury_tpu_torch.ops.select_sweep import nll_bwd_misfits

    want = reference.nll_backward(z, y, g)
    want32 = None if z.dtype == torch.float32 else reference.nll_backward(z.float(), y, g)
    if mask is not None:
        want = want[mask]
        want32 = None if want32 is None else want32[mask]
    misfits, one_ulp, err = nll_bwd_misfits(torch, got, want, want32)
    check(misfits == 0, f"{what} {z.dtype}: {misfits} gradients outside the limit "
          f"(max|err| {err:.3e})")
    return err, (None if want32 is None else one_ulp)


def draw_case(torch, mk, reference, gen, n: int, b: int, skew):
    """score_and_draw against cumsum + searchsorted(right) + clamp on the
    card. probs: the total is summed in another order (rtol 1e-5 at up to
    a million terms). Draws: as :func:`check_draws` allows. ``skew``: all
    mass on the first element ("first") or the last ("last"), with u up to
    1.0: then the draws are 0 and a clamp to n - 1, or all n - 1."""
    dev = torch.device("cuda")
    u = torch.rand(b, generator=gen, device=dev)
    if skew:
        losses = torch.zeros(n, device=dev)
        losses[0 if skew == "first" else n - 1] = 100.0
        ema, alpha = torch.zeros((), device=dev), 0.0
        u[-2], u[-1] = 1.0 - 2 ** -24, 1.0
    else:
        losses = -torch.log(torch.rand(n, generator=gen, device=dev))
        ema, alpha = torch.tensor(0.8, device=dev), 0.5
    ema1 = ema.reshape(1)
    probs, sel, scaled = mk.score_and_draw_kernel(losses, ema1, u, alpha)
    p_ref, s_ref, c_ref = reference.score_and_draw(losses, ema, u, alpha)
    err = within(probs, p_ref, rtol=1e-5, atol=0.0)
    band, in_band, differ = check_draws(torch, f"score_and_draw N={n}", probs, u,
                                        sel, s_ref)
    same = ~differ
    err = max(err, within(scaled[same], c_ref[same], rtol=1e-5, atol=0.0))
    if skew == "first":
        check(sel[:-1].eq(0).all().item() and int(sel[-1]) == n - 1,
              f"mass on the first: expected 0s then the clamp to {n - 1}, got {sel.tolist()}")
    elif skew == "last":
        check(sel.eq(n - 1).all().item(),
              f"mass on the last: expected only {n - 1}, got {sel.tolist()}")

    fn = lambda: mk.score_and_draw_kernel(losses, ema1, u, alpha)  # noqa: E731
    geo = mk.draw_geometry(n, max_cluster=mk.cluster_limit())
    case = dict(kernel="score_and_draw", shape=[n, b], skew=skew,
                clusters=geo.clusters, threads=geo.threads, run=geo.run,
                max_abs_err=err, band=band, in_band=in_band,
                mismatches=int(differ.sum()),
                ms=graph_ms(torch, fn), eager_ms=eager_ms(torch, fn),
                plain_ms=graph_ms(torch, lambda: reference.score_and_draw(
                    losses, ema, u, alpha)),
                library_ms=None)
    search = b * math.ceil(math.log2(n + 1))
    case["bound_ms"], case["bound_by"] = bound(8 * n + 4 + 12 * b, 4 * n + 2 * search)
    return case


def check_draws(torch, what: str, probs, u, sel, s_ref):
    """Two checks of the kernel's draws, with δ = max(1e-6, 4·max|cdf_f32 −
    cdf_f64|) over the float64 and float32 cumulative sums of ``probs``.
    (1) Against the plain version's draws ``s_ref``: equal, except where u
    lies within δ of every CDF value from the lower of the two draws up to
    the higher. (2) Size-free: every draw idx satisfies cdf64[idx−1] − δ ≤
    u < cdf64[idx] + δ (cdf64[−1] = 0; the clamp idx = n − 1 has no upper
    limit). At n ≈ 10⁶ the CDF spacing falls to δ and (1) checks little;
    (2) still holds each draw to its own interval. Returns (δ, u in the
    band, mask of draws that differ)."""
    n = probs.shape[0]
    cdf64 = torch.cumsum(probs.double(), 0)
    cdf32 = torch.cumsum(probs, 0)
    band = max(1e-6, 4 * float((cdf32.double() - cdf64).abs().max()))
    u64 = u.double()
    pos = torch.searchsorted(cdf64, u64).clamp(max=n - 1)
    dist = torch.minimum((cdf64[pos] - u64).abs(), (cdf64[(pos - 1).clamp(min=0)] - u64).abs())
    in_band = int((dist < band).sum())
    check(int(sel.min()) >= 0 and int(sel.max()) < n, f"{what}: index out of range")
    differ = sel != s_ref
    for k in differ.nonzero().flatten().tolist():
        a, c = int(sel[k]), int(s_ref[k])
        seg = cdf64[min(a, c):max(a, c)]
        check(bool(((seg - u64[k]).abs() < band).all()),
              f"{what}: draw {k} gave {a}, plain {c}, u={float(u[k])!r}")
    idx = sel.long()
    lower = torch.where(idx > 0, cdf64[(idx - 1).clamp(min=0)], torch.zeros_like(u64))
    upper = torch.where(idx < n - 1, cdf64[idx], torch.full_like(u64, math.inf))
    bad = ~((lower - band <= u64) & (u64 < upper + band))
    check(not bool(bad.any()),
          f"{what}: draws {idx[bad].tolist()} for u={u[bad].tolist()} lie outside "
          f"their float64 CDF intervals (band {band:.1e})")
    return band, in_band, differ


def table_case(torch, mk, reference, gen, n: int, r: int, b: int, dup: bool, wrap: bool):
    """table_refresh_draw against decay + index_add_ scatter-mean + cumsum
    + searchsorted on the card. The table: bit-equal, the same rounded ops
    in the same order, except that a slot hit three or more times is a sum
    whose order the plain version's atomics change (rtol 1e-6). probs: the
    total is summed in another order (rtol 1e-5). Draws: as in draw_case.
    ``wrap``: the window wraps past the table's end, as the round-robin
    cursor does; otherwise it straddles the end of the first block's range."""
    dev = torch.device("cuda")
    geo = mk.draw_geometry(n, refresh=r, max_cluster=mk.cluster_limit())
    scores = torch.rand(n, generator=gen, device=dev) * 4 + 0.1
    start = n - 20 if wrap else geo.per_block - 20
    slots = (start + torch.arange(r, device=dev)) % n
    if dup:
        slots[1] = slots[0]
        slots[4] = slots[5] = slots[2]
        slots[10:20] = slots[9]
    rscores = -torch.log(torch.rand(r, generator=gen, device=dev))
    ema = torch.tensor(0.9, device=dev)
    u = torch.rand(b, generator=gen, device=dev)
    ema1 = ema.reshape(1)
    new_t, probs, sel, scaled = mk.table_refresh_draw_kernel(
        scores, slots, rscores, ema1, u, 0.5, 0.98)
    t_ref, p_ref, s_ref, c_ref = reference.table_refresh_draw(
        scores, slots, rscores, ema, u, 0.5, 0.98)
    if not dup:
        check(torch.equal(new_t, t_ref), f"table_refresh_draw L={n}: table not bit-equal")
    err = within(new_t, t_ref, rtol=1e-6, atol=0.0)
    err = max(err, within(probs, p_ref, rtol=1e-5, atol=0.0))
    band, in_band, differ = check_draws(torch, f"table_refresh_draw L={n}", probs, u,
                                        sel, s_ref)
    same = ~differ
    err = max(err, within(scaled[same], c_ref[same], rtol=1e-5, atol=0.0))

    fn = lambda: mk.table_refresh_draw_kernel(  # noqa: E731
        scores, slots, rscores, ema1, u, 0.5, 0.98)
    case = dict(kernel="table_refresh_draw", shape=[n, r, b], dup=dup, wrap=wrap,
                clusters=geo.clusters, threads=geo.threads, run=geo.run,
                max_abs_err=err, band=band, in_band=in_band,
                mismatches=int(differ.sum()),
                ms=graph_ms(torch, fn), eager_ms=eager_ms(torch, fn),
                plain_ms=graph_ms(torch, lambda: reference.table_refresh_draw(
                    scores, slots, rscores, ema, u, 0.5, 0.98)),
                library_ms=None)
    # Read: table, slots (int64), refresh scores, EMA, uniforms. Written:
    # table, probs, selected, scaled. Operations: decay 3, smooth, floor and
    # normalize 3, scan 1 per slot; R² slot compares; the B binary searches.
    search = b * math.ceil(math.log2(n + 1))
    case["bound_ms"], case["bound_by"] = bound(
        4 * n + 12 * r + 4 + 4 * b + 8 * n + 8 * b, 7 * n + r * r + 2 * search)
    return case


def augment_case(torch, mk, reference, gen, n: int, dtype, every_offset: bool = False,
                 rows: bool = False, hw: int = 32, misaligned: bool = False):
    """augment_normalize against the plain fma-normalize + pad + gather +
    flip + cast on the card: bit-equal at float32 and at bfloat16 (each
    rounding is spelled out on both sides, and the bf16 cast is one
    round-to-nearest-even of the same float32 value). ``rows``: the kernel
    gathers ``n`` random rows (one repeated) of a 5000-image tensor, held
    against the plain version on ``raw[rows]``, and also timed against that
    gather followed by the kernel. ``hw``: the image side (30 takes the
    byte-load staging and the per-pixel stores). ``misaligned``: CIFAR
    images one byte off a 16-byte boundary (byte-load staging, 16-byte
    stores)."""
    from mercury_tpu_torch.data.cifar import CIFAR10_MEAN, CIFAR10_STD

    dev = torch.device("cuda")
    m = 5000 if rows else n
    shape = (m, hw, hw, 3)
    if misaligned:
        flat = torch.randint(0, 256, (math.prod(shape) + 1,), generator=gen, device=dev,
                             dtype=torch.uint8)
        raw = flat[1:].view(shape)
        check(raw.data_ptr() % 16 != 0, "the misaligned case is aligned")
    else:
        raw = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
    idx = None
    if rows:
        idx = torch.randint(0, m, (n,), generator=gen, device=dev)
        idx[1] = idx[0]
    mean = torch.tensor(CIFAR10_MEAN, device=dev)
    std = torch.tensor(CIFAR10_STD, device=dev)
    if every_offset:
        offs = torch.cartesian_prod(torch.arange(9), torch.arange(9))
        crop = torch.cat([offs, offs]).to(device=dev, dtype=torch.int32)
        flip = (torch.arange(2 * len(offs)) >= len(offs)).to(dev)
        check(crop.shape[0] == n, f"every-offset case needs N={crop.shape[0]}")
    else:
        crop = torch.randint(0, 9, (n, 2), generator=gen, device=dev, dtype=torch.int32)
        flip = torch.rand(n, generator=gen, device=dev) < 0.5
    check(bool(flip.any()) and not bool(flip.all()), "augment case without both flips")
    got = mk.augment_normalize_kernel(raw, mean, std, crop, flip, 4, dtype, rows=idx)
    src = raw if idx is None else raw[idx]
    want = reference.augment_normalize(src, mean, std, crop, flip, 4, dtype)
    check(got.dtype == dtype and got.shape == want.shape, "augment_normalize output")
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    check(torch.equal(got.view(ints), want.view(ints)),
          f"augment_normalize N={n} {dtype} rows={rows} hw={hw} misaligned={misaligned}: "
          f"output not bit-equal")
    err = within(got, want, rtol=0.0, atol=0.0)

    fn = lambda: mk.augment_normalize_kernel(  # noqa: E731
        raw, mean, std, crop, flip, 4, dtype, rows=idx)
    geo = mk.ingest_geometry(n, hw, hw, 3, got.element_size(), 4,
                             aligned=raw.data_ptr() % 16 == 0)
    case = dict(kernel="augment_normalize", shape=[n, hw, hw, 3], dtype=str(dtype)[6:],
                every_offset=every_offset, rows=rows, misaligned=misaligned,
                threads=geo.threads, band_rows=geo.band, copy=geo.copy, max_abs_err=err,
                ms=graph_ms(torch, fn), eager_ms=eager_ms(torch, fn),
                plain_ms=graph_ms(torch, lambda: reference.augment_normalize(
                    raw if idx is None else raw[idx], mean, std, crop, flip, 4, dtype)),
                library_ms=None)
    if rows:
        case["gather_and_kernel_ms"] = graph_ms(torch, lambda: mk.augment_normalize_kernel(
            raw[idx], mean, std, crop, flip, 4, dtype))
    elems = n * hw * hw * 3
    # uint8 in (the gathered images), one output element each, offsets,
    # flips and rows, mean and std; a lookup and the bounds compares per
    # element, an fma and a division per table entry.
    case["bound_ms"], case["bound_by"] = bound(
        elems * (1 + got.element_size()) + (17 if rows else 9) * n + 24,
        2 * elems + 2 * 256 * 3)
    return case


# ------------------------------------------------------------------ phase 4
def warm(trainer, steps: int = WARMUP_STEPS) -> None:
    """Untimed, uncounted steps: the first calls' cuDNN plans and caches."""
    for _ in range(steps):
        trainer.train_step()


def timed_steps(torch, mk, trainer, steps: int = MAIN_STEPS):
    """``steps`` steps with the launch counts zeroed just before and read
    just after; host clock around work that ends in a synchronize. Returns
    the time, the counts, the losses and every step's metrics."""
    mk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [trainer.train_step() for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mk.launch_counts)
    losses = torch.stack([m["train/loss"] for m in metrics]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite losses {losses.tolist()}")
    return dt, counts, losses, metrics


def kernel_vs_plain_step(torch, trainer, config, attempts: int = 3,
                         any_rank=bool, quiet: bool = False):
    """One step from the same state and draws, kernels against plain
    versions on the card. The bf16 forwards are the same calls on the same
    inputs on both sides; the f32 NLL and draw arithmetic differ in the last
    bits, so the losses agree to rtol 1e-4 and the draws match. A draw may
    differ only as :func:`check_draws` allows (a uniform in the boundary
    band of the CDF, likelier over a table of thousands than over a pool of
    320); then the losses differ too, and the step is repeated from the same
    state with fresh draws. One of ``attempts`` must draw the same batch.
    Under ``grad_compression="stochastic"`` the two gradients differ where
    the bf16 backward rounds a last-bit difference of the NLL's gradient
    the other way (one bf16 ulp, 2⁻⁸ of the value), and every element whose
    uniform lies that close to ``|g|/max|g|`` is kept on one side and
    dropped on the other: there the sparse rates may differ by 1e-3 (a
    thousandth of the gradient's elements kept on one side only) and the
    gradient's norm by rtol 1e-2 (both differences returned).
    At two ranks ``any_rank`` tells whether a draw differed on any rank, so
    the ranks repeat (and issue their collectives) together."""
    from mercury_tpu_torch.train.step import make_draws

    state = trainer.state
    band_misses = 0
    try:
        for _ in range(attempts):
            draws = make_draws(state, config)
            results, tables = {}, {}
            for use_kernels in (True, False):
                trainer.state = state.clone()
                results[use_kernels] = trainer.train_step(draws, use_kernels=use_kernels)
                tables[use_kernels] = trainer.state.scoretable
            k_m, p_m = results[True], results[False]
            _, _, differ = check_draws(torch, "kernel step vs plain step",
                                       p_m["sampler/probs"], draws.uniforms.reshape(-1),
                                       k_m["sampler/selected"], p_m["sampler/selected"])
            if not any_rank(bool(differ.any())):
                break
            band_misses += 1
        else:
            raise SmokeFailure(f"kernel and plain steps drew different batches in "
                               f"{attempts} tries (all within the boundary band)")
    finally:
        trainer.state = state
    step_err = {"band_misses": band_misses}
    stochastic = config.grad_compression == "stochastic"
    if stochastic:
        a, b = float(k_m["train/sparse_rate"]), float(p_m["train/sparse_rate"])
        step_err["train/sparse_rate"] = abs(a - b)
        check(0 < a <= 1 and abs(a - b) <= 1e-3,
              f"train/sparse_rate: kernel step {a!r}, plain step {b!r}")
    for key in ("train/loss", "train/pool_loss"):
        a, b = float(k_m[key]), float(p_m[key])
        step_err[key] = abs(a - b)
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"{key}: kernel step {a!r}, plain step {b!r}")
    if config.telemetry:
        p_table = None if tables[False] is None else tables[False].scores
        step_err["telemetry"] = telemetry_agree(torch, k_m, p_m, p_table,
                                                trained_weights(state, config, p_m),
                                                grad_norm_rtol=1e-2 if stochastic else 1e-4)
    if not quiet:
        print(f"kernel step vs plain step: |d loss| {step_err['train/loss']:.2e}, "
              f"|d pool_loss| {step_err['train/pool_loss']:.2e}, same draws "
              f"({band_misses} earlier tries differed inside the boundary band); "
              f"telemetry {step_err.get('telemetry')}")
    return step_err


def trained_weights(state, config, metrics):
    """The IS weights of the batch a step trained on, where they are not
    ``probs[selected]·N`` of its metrics: under ``pipelined_scoring`` the
    carried batch's (the state's before the step), under the groupwise
    sampler ``p·M`` with M the group's size. None elsewhere."""
    if config.use_pipelined:
        return state.pending_batch.scaled_probs
    if config.use_groupwise:
        probs = metrics["sampler/probs"]
        return probs[metrics["sampler/selected"]] * (probs > 0).sum()
    return None


def build_trainer(torch, config, quiet: bool = False, dataset=None):
    from mercury_tpu_torch import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(config, dataset=dataset)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    classes = trainer.dataset.num_classes
    want = (PARAMETERS if config.moe_experts is None else MOE_PARAMETERS)[config.model, classes]
    check(n_params == want, f"{config.model} with {classes} classes has {n_params} "
          f"parameters, not {want}")
    if not quiet:
        print(f"Trainer built in {time.perf_counter() - t0:.1f} s on "
              f"{trainer.device}: {config.model}, {classes} classes, {n_params} parameters")
    return trainer


def telemetry_rows(torch, metrics, keys):
    """``[steps, len(keys)]`` float32 on the host: each step's values of
    ``keys`` (read after the timing)."""
    return torch.stack([torch.stack([m[k].float().cpu() for k in keys]) for m in metrics])


def check_telemetry(torch, metrics, path: str, batch: int):
    """Every step's telemetry on ``path`` ("pool", "scoretable" or "async"): the
    JAX step's metric keys (``JAX_STEP_KEYS``, less the options the port
    does not implement, plus the port's draws), ESS in (0, 1], clip share
    in [0, 1], the gradient's norm finite and positive, the IS-weight
    histogram summing to the batch and the table's to its length."""
    want = JAX_STEP_KEYS[path] - JAX_ONLY_KEYS
    for m in metrics:
        got = set(m) - PORT_ONLY_KEYS
        check(got == want, f"{path}: metric keys differ from the JAX step's: "
              f"{sorted(got ^ want)}")
    ess, clip, gnorm = telemetry_rows(
        torch, metrics, ("sampler/ess", "sampler/clip_frac", "train/grad_norm")).T
    check(bool(((ess > 0) & (ess <= 1)).all()), f"{path}: ESS outside (0, 1]: {ess.tolist()}")
    check(bool(((clip >= 0) & (clip <= 1)).all()), f"{path}: clip share {clip.tolist()}")
    check(bool((torch.isfinite(gnorm) & (gnorm > 0)).all()),
          f"{path}: gradient norms {gnorm.tolist()}")
    w_sums = telemetry_rows(torch, metrics, _W_HIST).sum(1)
    check(bool((w_sums == batch).all()), f"{path}: w_hist sums {w_sums.tolist()}, not {batch}")
    out = {"ess": [ess.min().item(), ess.max().item()],
           "clip_frac": [clip.min().item(), clip.max().item()],
           "grad_norm": [gnorm.min().item(), gnorm.max().item()]}
    if path in ("scoretable", "async"):
        length = metrics[0]["sampler/probs"].numel()
        s_sums = telemetry_rows(torch, metrics, _SCORE_HIST).sum(1)
        check(bool((s_sums == length).all()),
              f"{path}: score_hist sums {s_sums.tolist()}, not {length}")
    print(f"telemetry ({path}, {len(metrics)} steps): the JAX step's {len(want)} keys "
          f"(+ {sorted(PORT_ONLY_KEYS)}); ESS {out['ess']}, clip {out['clip_frac']}, "
          f"grad norm {out['grad_norm']}")
    return out


def near_edges(torch, values, lo: float, hi: float, rel: float = 1e-5) -> int:
    """How many ``values`` lie within ``rel`` (relative) of an edge of the
    log-spaced histogram bins over ``[lo, hi)``."""
    from mercury_tpu_torch.obs.sampler_health import hist_bin_edges

    edges = torch.as_tensor(hist_bin_edges(lo, hi), device=values.device)
    v = values.detach().double().reshape(-1, 1)
    return int(((v / edges - 1).abs() <= rel).any(1).sum())


def telemetry_agree(torch, k_m, p_m, p_table=None, weights=None,
                    grad_norm_rtol: float = 1e-4) -> dict:
    """A kernel step's telemetry against the plain step's (same state and
    draws): ESS and clip share rtol 1e-5, the drift within 1e-5 of the pool
    mean it is taken from (the EMA before the step is the same on both
    sides), the gradient's norm rtol ``grad_norm_rtol`` (1e-4; see
    :func:`kernel_vs_plain_step` for the stochastic quantizer's); the
    histograms equal, except
    that a value within 1e-5 of a bin edge may move one bin (the f32 NLL
    and draw arithmetic differ in the last bits). ``weights``, the batch's
    IS weights, default to the plain step's ``p·N`` of its draw."""
    from mercury_tpu_torch.obs.sampler_health import (
        SCORE_HIST_HI,
        SCORE_HIST_LO,
        WEIGHT_HIST_HI,
        WEIGHT_HIST_LO,
    )

    err = {}
    for key, rtol in (("sampler/ess", 1e-5), ("sampler/clip_frac", 1e-5),
                      ("train/grad_norm", grad_norm_rtol)):
        a, b = float(k_m[key]), float(p_m[key])
        err[key] = abs(a - b)
        check(math.isfinite(a) and abs(a - b) <= rtol * abs(b),
              f"{key}: kernel step {a!r}, plain step {b!r}")
    a, b = float(k_m["sampler/ema_drift"]), float(p_m["sampler/ema_drift"])
    err["sampler/ema_drift"] = abs(a - b)
    # Async scores no pool: its drift is taken from the trained batch's
    # reweighted scores, whose mean is the train loss.
    scale = float(p_m["train/pool_loss"]) or float(p_m["train/loss"])
    check(abs(a - b) <= 1e-5 * abs(scale),
          f"sampler/ema_drift: kernel step {a!r}, plain step {b!r}")
    probs = p_m["sampler/probs"]
    if weights is None:
        weights = probs[p_m["sampler/selected"]] * probs.numel()
    hists = [(_W_HIST, weights, WEIGHT_HIST_LO, WEIGHT_HIST_HI)]
    if p_table is not None:
        hists.append((_SCORE_HIST, p_table, SCORE_HIST_LO, SCORE_HIST_HI))
    for keys, values, lo, hi in hists:
        moved = sum(abs(int(k_m[k]) - int(p_m[k])) for k in keys)
        near = near_edges(torch, values, lo, hi)
        check(moved <= 2 * near, f"{keys[0][:-4]}: {moved} counts differ between the "
              f"kernel and plain steps, {near} values near an edge")
        err[keys[0][:-4] + " moved"] = moved
    return err


def main_path_phase(torch, card: str):
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.data.pipeline import normalize_images
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.step import to_nchw

    config = TrainConfig(model="resnet18", dataset="synthetic", world_size=1)
    check(config.candidate_pool_size == 320 and config.batch_size == 32
          and config.compute_dtype == "bfloat16" and config.use_importance_sampling
          and not config.fused_input and config.sampler == "pool",
          f"unexpected default config {config}")
    trainer = build_trainer(torch, config)
    model = trainer.state.model

    # The scoring forward (train-mode, keep_stats=False) at the pool's
    # shape leaves the running statistics alone; a train step moves them.
    def running_stats():
        return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}

    before = running_stats()
    ds = trainer.dataset
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        raw = ds.x_train[:config.candidate_pool_size]
        model(to_nchw(normalize_images(raw, ds.mean, ds.std)), train=True,
              keep_stats=False)
    check(all(torch.equal(v, before[k]) for k, v in running_stats().items()),
          "the scoring forward changed BN running statistics")

    warm(trainer)
    after = running_stats()
    check(all(not torch.equal(v, before[k]) for k, v in after.items()
              if k.endswith("running_mean")),
          "train steps left some BN running mean unchanged")

    dt, counts, losses, metrics = timed_steps(torch, mk, trainer)
    want = {"nll_fwd": 2 * MAIN_STEPS, "nll_bwd": MAIN_STEPS,
            "score_and_draw": MAIN_STEPS, "table_refresh_draw": 0,
            "augment_normalize": 0}
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(config.telemetry, "telemetry is off in the default config")
    telemetry = check_telemetry(torch, metrics, "pool", config.batch_size)
    steps_s = MAIN_STEPS / dt
    print(f"main path: {MAIN_STEPS} steps in {dt:.3f} s = {steps_s:.2f} steps/s, "
          f"{steps_s * config.batch_size:.1f} trained images/s, "
          f"{steps_s * config.candidate_pool_size:.1f} scored candidates/s [{card}]")
    print(f"losses: first {losses[0].item():.4f}, last {losses[-1].item():.4f}, "
          f"launches {counts}")
    step_err = kernel_vs_plain_step(torch, trainer, config)
    return {"launches": counts, "trainer": trainer, "config": config,
            "step_us": dt / MAIN_STEPS * 1e6,
            "summary": {"steps": MAIN_STEPS, "seconds": dt, "steps_per_s": steps_s,
                        "images_per_s": steps_s * config.batch_size,
                        "candidates_per_s": steps_s * config.candidate_pool_size,
                        "launches": counts, "first_loss": losses[0].item(),
                        "last_loss": losses[-1].item(), "kernel_vs_plain": step_err,
                        "telemetry": telemetry, "card": card}}


# ------------------------------------------------------------------ phase 5
def scoretable_path_phase(torch, card: str):
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    config = TrainConfig(**SCORETABLE)
    check(config.use_scoretable and config.fused_input and config.batch_size == 32
          and config.refresh_size == 64 and config.table_decay == 0.98
          and config.is_alpha == 0.5 and config.compute_dtype == "bfloat16",
          f"unexpected scoretable config {config}")
    trainer = build_trainer(torch, config)
    length = trainer.dataset.shard_len
    table = trainer.state.scoretable
    check(table is not None and table.scores.shape == (length,) and length == 5000,
          f"score table of {tuple(table.scores.shape)} for a shard of {length}")

    warm(trainer)
    cursor = trainer.state.scoretable.cursor
    stream_cursor = trainer.state.stream.cursor
    ledger = trainer.state.sel_counts.clone()
    dt, counts, losses, metrics = timed_steps(torch, mk, trainer)
    # Two nll_fwd a step (the window's scores and the train loss; the
    # write-back reuses the loss's per-sample values), two fused ingests
    # (window and batch), one table kernel, no pool selection.
    want = {"nll_fwd": 2 * MAIN_STEPS, "nll_bwd": MAIN_STEPS, "score_and_draw": 0,
            "table_refresh_draw": MAIN_STEPS, "augment_normalize": 2 * MAIN_STEPS}
    check(counts == want, f"launch counts {counts}, expected {want}")
    table = trainer.state.scoretable
    want_cursor = (cursor + config.refresh_size * MAIN_STEPS) % length
    check(table.cursor == want_cursor, f"cursor {table.cursor}, expected {want_cursor}")
    check(trainer.state.stream.cursor == stream_cursor, "the scoretable step read the stream")
    check(bool(torch.isfinite(table.scores).all()) and float(table.scores.min()) > 0,
          "score table not finite and positive")
    telemetry = check_telemetry(torch, metrics, "scoretable", config.batch_size)
    telemetry.update(check_ledger_and_ages(torch, trainer, metrics, ledger, cursor))
    steps_s = MAIN_STEPS / dt
    print(f"scoretable path: {MAIN_STEPS} steps in {dt:.3f} s = {steps_s:.2f} steps/s, "
          f"{steps_s * config.batch_size:.1f} trained images/s, "
          f"{steps_s * config.refresh_size:.1f} rescored slots/s [{card}]")
    print(f"losses: first {losses[0].item():.4f}, last {losses[-1].item():.4f}, "
          f"cursor {cursor} -> {table.cursor}, launches {counts}")
    step_err = kernel_vs_plain_step(torch, trainer, config)
    return {"launches": counts, "trainer": trainer, "config": config,
            "step_us": dt / MAIN_STEPS * 1e6,
            "summary": {"steps": MAIN_STEPS, "seconds": dt, "steps_per_s": steps_s,
                        "images_per_s": steps_s * config.batch_size,
                        "rescored_per_s": steps_s * config.refresh_size,
                        "launches": counts, "first_loss": losses[0].item(),
                        "last_loss": losses[-1].item(), "kernel_vs_plain": step_err,
                        "cursor": [cursor, table.cursor], "telemetry": telemetry,
                        "card": card}}


def check_ledger_and_ages(torch, trainer, metrics, ledger_before, cursor: int) -> dict:
    """The ledger grew by one count for each drawn slot of the run (30·32,
    duplicates counted each time: the histogram of ``sampler/selected``),
    and each step's table ages equal the ages of its window's cursor
    (``obs.diagnostics.table_ages`` on the card): min and max exactly, the
    float32 mean to rtol 1e-6 of the float64 mean."""
    from mercury_tpu_torch.obs.diagnostics import table_ages

    config = trainer.config
    length, r = trainer.dataset.shard_len, config.refresh_size
    grown = (trainer.state.sel_counts - ledger_before).cpu()
    drawn = torch.cat([m["sampler/selected"] for m in metrics]).cpu()
    check(int(grown.sum()) == len(metrics) * config.batch_size,
          f"ledger grew by {int(grown.sum())}, expected {len(metrics) * config.batch_size}")
    check(torch.equal(grown.long(), torch.bincount(drawn, minlength=length)),
          "the ledger differs from the count of the drawn slots")
    for i, m in enumerate(metrics):
        ages = table_ages((cursor + i * r) % length, length, r, device=trainer.device)
        got = [float(m[f"sampler/table_age_{k}"]) for k in ("min", "mean", "max")]
        lo, mean, hi = float(ages.min()), float(ages.double().mean()), float(ages.max())
        check(got[0] == lo and got[2] == hi and abs(got[1] - mean) <= 1e-6 * mean,
              f"step {i}: table ages {got}, closed form {[lo, mean, hi]}")
    print(f"ledger: +{int(grown.sum())} counts over {len(metrics)} steps, equal to the "
          f"drawn slots' histogram ({int((grown > 1).sum())} slots drawn more than once); "
          f"table ages {got} = the closed form at every step")
    return {"ledger_growth": int(grown.sum()), "table_ages": got}


# ------------------------------------------------------------------ phase 6
def two_rank_phase(torch, card: str, main_path):
    """The default pool configuration at ``world_size=2``: two gloo ranks,
    both on card 0 (NCCL refuses two ranks on one card), started by
    ``parallel.distributed.spawn``; :func:`two_rank_body` is each rank's
    part. Checks that each rank launches the main path's kernels as often
    a step as phase 4 did, that a kernel step matches a plain step on each
    rank, and that the two replicas (parameters, Adam state, BN running
    statistics) are bit-equal after the steps."""
    from mercury_tpu_torch.parallel.distributed import spawn

    per_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    ranks = spawn(two_rank_body, TWO_RANKS, "gloo", per_step,
                  devices=[0] * TWO_RANKS, timeout_s=600)
    r0, r1 = ranks
    check(r0["telemetry"] == r1["telemetry"],
          f"two ranks: telemetry differs: {r0['telemetry']} and {r1['telemetry']}")
    for key in ("params", "adam", "running_stats"):
        differ = sorted(k for k in r0[key] if r0[key][k] != r1[key].get(k))
        check(r0[key].keys() == r1[key].keys() and not differ,
              f"two ranks: {key} not bit-equal after the steps: {differ[:5]}")
    for r in ranks:
        e = r["kernel_vs_plain"]
        print(f"rank {r['rank']}: {TWO_RANK_STEPS} steps in {r['seconds']:.3f} s = "
              f"{r['steps_per_s']:.2f} steps/s, two ranks sharing one card over gloo "
              f"(not a data-parallel rate) [{card}]")
        print(f"  losses: first {r['losses'][0]:.4f}, last {r['losses'][-1]:.4f}; launches "
              f"{r['launches']}; {r['all_reduces_per_step']} all-reduces a step taking "
              f"{r['all_reduce_ms_per_step']:.2f} ms of host time, "
              f"{r['gradient_bucket_ms_per_step']:.2f} ms of it the gradient bucket "
              f"({r['gradient_bucket_elements']} floats); kernel step vs plain step "
              f"|d loss| {e['train/loss']:.2e}, |d pool_loss| {e['train/pool_loss']:.2e} "
              f"({e['band_misses']} band retries)")
    print(f"replicas bit-equal after the steps: {len(r0['params'])} parameters, "
          f"{len(r0['adam'])} Adam tensors, {len(r0['running_stats'])} running statistics; "
          f"the last step's telemetry equal on both ranks: {r0['telemetry']}")
    launches = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    return {"launches": launches,
            "summary": {"ranks": TWO_RANKS, "backend": "gloo", "steps": TWO_RANK_STEPS,
                        "card": card, "per_rank": [
                            {k: r[k] for k in ("rank", "seconds", "steps_per_s", "launches",
                                               "losses", "all_reduces_per_step",
                                               "all_reduce_ms_per_step",
                                               "gradient_bucket_ms_per_step",
                                               "kernel_vs_plain", "telemetry")}
                            for r in ranks]}}


def two_rank_body(per_step):
    """One rank of phase 6 (run by ``spawn``; prints nothing): the default
    pool config at W=2 on this rank's shard, WARMUP_STEPS then
    TWO_RANK_STEPS timed steps with the launch counts and all-reduces
    counted, one kernel step against a plain step, and digests of the
    replica."""
    import torch
    import torch.distributed as dist

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.models.resnet import BatchNorm
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.collectives import allreduce_sum

    config = TrainConfig(model="resnet18", dataset="synthetic", world_size=TWO_RANKS)
    check(config.batch_norm == "sync" and config.candidate_pool_size == 320
          and config.batch_size == 32 and config.compute_dtype == "bfloat16"
          and config.sampler == "pool" and config.data_placement == "replicated",
          f"unexpected two-rank config {config}")
    trainer = build_trainer(torch, config, quiet=True)
    rank = trainer.rank
    warm(trainer)
    calls = []  # (elements, host seconds) of each all-reduce: gloo returns when done
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kwargs)
        calls.append((tensor.numel(), time.perf_counter() - t0))
        return out

    dist.all_reduce = counted
    try:
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, TWO_RANK_STEPS)
    finally:
        dist.all_reduce = all_reduce
    check(config.telemetry, "telemetry is off in the two-rank config")
    telemetry = {k: float(metrics[-1][k]) for k in ("sampler/ess", "sampler/clip_frac",
                                                    "sampler/ema_drift", "train/grad_norm")}
    want = {k: v * TWO_RANK_STEPS for k, v in per_step.items()}
    check(counts == want, f"rank {rank}: launch counts {counts}, expected {want}")
    n_bn = sum(isinstance(m, BatchNorm) for m in trainer.state.model.modules())
    per_step_calls = len(calls) / TWO_RANK_STEPS
    check(per_step_calls == 3 * n_bn + 4,
          f"rank {rank}: {per_step_calls} all-reduces a step, expected 3·{n_bn} + 4")

    def any_rank(flag: bool) -> bool:
        return bool(allreduce_sum(torch.tensor(float(flag), device=trainer.device)) > 0)

    step_err = kernel_vs_plain_step(torch, trainer, config, any_rank=any_rank, quiet=True)
    torch.cuda.synchronize()

    model = trainer.state.model
    adam = {f"{i}.{k}": digest(v)
            for i, st in trainer.state.optimizer.state_dict()["state"].items()
            for k, v in st.items() if torch.is_tensor(v)}
    biggest = max(n for n, _ in calls)
    return {"rank": rank, "seconds": dt, "steps_per_s": TWO_RANK_STEPS / dt,
            "launches": counts, "losses": losses.tolist(),
            "all_reduces_per_step": per_step_calls, "kernel_vs_plain": step_err,
            "telemetry": telemetry,
            "all_reduce_ms_per_step": sum(t for _, t in calls) / TWO_RANK_STEPS * 1e3,
            "gradient_bucket_ms_per_step": sum(t for n, t in calls if n == biggest)
            / TWO_RANK_STEPS * 1e3, "gradient_bucket_elements": biggest,
            "params": {k: digest(v) for k, v in model.named_parameters()},
            "adam": adam,
            "running_stats": {k: digest(v) for k, v in model.named_buffers()
                              if "running_" in k}}


def digest(t) -> str:
    """sha256 of a tensor's bytes, in its logical order."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().reshape(-1).cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


# ------------------------------------------------------------------ phase 7
def state_digests(state) -> dict:
    """sha256 of everything a resumed run carries over: parameters and BN
    running statistics, Adam's moments and counts, the accumulator, the
    EMA, the stream permutation, the generator's state, and the counters
    and cursors."""
    out = {f"model.{k}": digest(v) for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": digest(v) for k, v in st.items()})
    out.update({f"accum.{i}": digest(a) for i, a in enumerate(state.accum or ())})
    out.update({"ema.value": digest(state.ema.value), "ema.count": digest(state.ema.count),
                "stream.perm": digest(state.stream.perm),
                "generator": digest(state.generator.get_state())})
    out.update({k: str(getattr(state, k)) for k in ("step", "updates", "mini_step")})
    out["stream.cursor"] = str(state.stream.cursor)
    if state.sel_counts is not None:
        out["sel_counts"] = digest(state.sel_counts)
    return out


def deterministic_cudnn(torch):
    """Deterministic cuDNN, as phase 7 runs; returns the undo."""
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False

    def undo():
        cudnn.deterministic, cudnn.benchmark = flags

    return undo


def accum_resume_phase(torch, card: str, main_path):
    """The default pool configuration with ``grad_accum_steps=2``, under
    deterministic cuDNN (the previous settings restored after): launches
    and parameters across three microsteps, a save in the middle of a
    window, four more microsteps on the live trainer (run A) and the same
    four on a fresh trainer restored from the file (run B), bit-equal; then
    ``predict`` against ``evaluate``."""
    import shutil
    import tempfile

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    config = TrainConfig(**ACCUM)
    check(config.candidate_pool_size == 320 and config.batch_size == 32
          and config.compute_dtype == "bfloat16" and config.sampler == "pool"
          and config.grad_accum_steps == 2, f"unexpected accumulation config {config}")
    per_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1, "table_refresh_draw": 0,
                "augment_normalize": 0}
    check({k: v // MAIN_STEPS for k, v in main_path["launches"].items()} == per_step,
          f"phase 4 launched {main_path['launches']} in {MAIN_STEPS} steps")
    undo = deterministic_cudnn(torch)
    directory = tempfile.mkdtemp(prefix="mercury_ckpt_")
    try:
        return _accum_resume(torch, mk, card, config, per_step, directory, main_path)
    finally:
        undo()
        shutil.rmtree(directory, ignore_errors=True)


def _accum_resume(torch, mk, card, config, per_step, directory, main_path):
    def times(n):
        return {k: v * n for k, v in per_step.items()}

    def run(trainer, steps):
        """``steps`` microsteps, each timed on the host clock to a
        synchronize; returns the times and the losses."""
        times_s, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step()["train/loss"])
            torch.cuda.synchronize()
            times_s.append(time.perf_counter() - t0)
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"non-finite losses {losses.tolist()}")
        return times_s, losses

    live = build_trainer(torch, config)
    mk.reset_launch_counts()
    changed = []
    for _ in range(ACCUM_FIRST):
        before = [p.detach().clone() for p in live.state.model.parameters()]
        live.train_step()
        changed.append(not all(torch.equal(a, p) for a, p in
                               zip(before, live.state.model.parameters())))
    check(changed == [False, True, False],
          f"parameters changed across microsteps 1-3: {changed}, expected only across the 2nd")
    check(dict(mk.launch_counts) == times(ACCUM_FIRST),
          f"launch counts {dict(mk.launch_counts)} in {ACCUM_FIRST} microsteps, "
          f"expected {times(ACCUM_FIRST)}")
    check((live.state.step, live.state.updates, live.state.mini_step) == (ACCUM_FIRST, 1, 1),
          f"counters {live.state.step, live.state.updates, live.state.mini_step}")

    saved = state_digests(live.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = live.save(directory)
    save_s = time.perf_counter() - t0
    nbytes = Path(path).stat().st_size
    print(f"save: {Path(path).name}, {nbytes} bytes in {save_s * 1e3:.1f} ms "
          f"(step {live.state.step}, mini_step {live.state.mini_step}) [{card}]")

    dt_a, losses_a = run(live, ACCUM_RUN)
    after_a = state_digests(live.state)

    fresh = build_trainer(torch, config, quiet=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = fresh.restore(directory)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == ACCUM_FIRST, f"restored step {step}")
    restored = state_digests(fresh.state)
    differ = sorted(k for k in saved if restored.get(k) != saved[k])
    check(restored.keys() == saved.keys() and not differ,
          f"restored state differs from the saved one: {differ[:5]}")
    print(f"restore: {restore_s * 1e3:.1f} ms; {len(saved)} tensors and counters equal "
          f"to the saved ones by sha256 [{card}]")

    dt_b, losses_b = run(fresh, ACCUM_RUN)
    after_b = state_digests(fresh.state)
    differ = sorted(k for k in after_a if after_b.get(k) != after_a[k])
    check(after_a.keys() == after_b.keys() and not differ,
          f"run B (restored) differs from run A (live): {differ[:5]}")
    check(torch.equal(losses_a, losses_b), f"losses A {losses_a.tolist()}, B {losses_b.tolist()}")
    print(f"runs A and B bit-equal after {ACCUM_RUN} microsteps: {len(after_a)} tensors and "
          f"counters; losses {losses_a.tolist()}")
    print(f"microstep ms, run A {[round(t * 1e3, 2) for t in dt_a]}, run B (restored) "
          f"{[round(t * 1e3, 2) for t in dt_b]} [{card}]")

    # The rate, the live and the restored trainer in turns.
    rates = {"live": [], "restored": []}
    for name in ("live", "restored", "restored", "live"):
        dt, _ = run(live if name == "live" else fresh, ACCUM_RATE)
        rates[name].append(ACCUM_RATE / sum(dt))
    counts = dict(mk.launch_counts)
    want = times(ACCUM_FIRST + 2 * ACCUM_RUN + 4 * ACCUM_RATE)
    check(counts == want, f"launch counts {counts}, expected {want}")

    ev = fresh.evaluate(include_train=False)
    ds = fresh.dataset
    logits = fresh.predict(ds.x_test)
    n = int(ds.x_test.shape[0])
    check(tuple(logits.shape) == (n, ds.num_classes) and bool(torch.isfinite(logits).all()),
          f"predict gave {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    acc = int((logits.argmax(-1) == ds.y_test.cpu().long()).sum()) / n
    check(acc == ev["test/eval_acc"], f"predict accuracy {acc}, evaluate {ev['test/eval_acc']}")
    check(torch.equal(logits, fresh.predict(ds.x_test.float() / 255)),
          "predict(uint8) differs from predict(float / 255)")
    per_class = fresh.per_class_accuracy()
    print(f"predict: {n} test images, accuracy {acc} = evaluate's; uint8 and float / 255 "
          f"bit-equal; per-class accuracy {[round(v, 4) for v in per_class.tolist()]}")

    print(f"accumulation, microsteps/s in turns of {ACCUM_RATE}: live {rates['live']}, "
          f"restored {rates['restored']}; phase 4's W=1 step in this call "
          f"{main_path['summary']['steps_per_s']:.2f} steps/s [{card}]")
    return {"launches": counts,
            "summary": {"grad_accum_steps": config.grad_accum_steps, "card": card,
                        "checkpoint_bytes": nbytes, "save_ms": save_s * 1e3,
                        "restore_ms": restore_s * 1e3, "tensors_and_counters": len(saved),
                        "microstep_ms": {"A": [t * 1e3 for t in dt_a],
                                         "B": [t * 1e3 for t in dt_b]},
                        "microsteps_per_s": rates,
                        "w1_steps_per_s": main_path["summary"]["steps_per_s"],
                        "losses": losses_a.tolist(), "launches": counts,
                        "predict_acc": acc, "eval_acc": ev["test/eval_acc"],
                        "per_class_accuracy": per_class.tolist()}}


# ------------------------------------------------------------------ phase 8
def sync_calls(torch, trainer) -> list:
    """The synchronizing CUDA calls of one step, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)]


def telemetry_phase(torch, card: str, main_path, table_path) -> dict:
    """Telemetry off against on, on the pool and the scoretable path: the
    rate in turns, the CUDA kernels a step (``torch.profiler``) and the
    synchronizing calls a step (equal both ways); the grad-variance probe
    on its cadence; and the scoretable Trainer's monitor at a log tick."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    out = {"card": card}
    for path, config in (("pool", main_path["config"]), ("scoretable", table_path["config"])):
        arms = {arm: build_trainer(torch, config.replace(telemetry=arm == "on", log_every=10),
                                   quiet=True) for arm in ("off", "on")}
        for trainer in arms.values():
            warm(trainer)
        rates = {"off": [], "on": []}
        for arm in TELEMETRY_TURNS:
            dt, _, _, _ = timed_steps(torch, mk, arms[arm], TELEMETRY_TURN)
            rates[arm].append(TELEMETRY_TURN / dt)
        syncs = {arm: sync_calls(torch, arms[arm]) for arm in arms}
        check(len(syncs["on"]) == len(syncs["off"]),
              f"{path}: telemetry adds synchronizing calls: on {syncs['on']}, off {syncs['off']}")
        kernels = {arm: profile_window(torch, arms[arm],
                                       1e6 / statistics.mean(rates[arm]), steps=5)
                   for arm in arms}
        row = {"steps_per_s": rates,
               "kernels_per_step": {a: kernels[a]["kernels_per_step"] for a in arms},
               "device_us_per_step": {a: kernels[a]["device_us_per_step"] for a in arms},
               "sync_calls_per_step": {a: len(syncs[a]) for a in arms},
               "sync_calls": syncs["on"]}
        print(f"telemetry {path}: steps/s in turns of {TELEMETRY_TURN}, off "
              f"{[round(r, 2) for r in rates['off']]}, on {[round(r, 2) for r in rates['on']]} "
              f"(means {statistics.mean(rates['off']):.2f} and {statistics.mean(rates['on']):.2f})"
              f"; CUDA kernels a step off {row['kernels_per_step']['off']:.1f}, on "
              f"{row['kernels_per_step']['on']:.1f}; device us a step off "
              f"{row['device_us_per_step']['off']:.1f}, on {row['device_us_per_step']['on']:.1f}; "
              f"synchronizing calls a step off {len(syncs['off'])}, on {len(syncs['on'])} [{card}]")
        if path == "scoretable":
            trainer = arms["on"]
            every = trainer.config.log_every
            health = trainer.fit(steps=every - trainer.state.step % every)
            check(trainer.state.step % every == 0 and MONITOR_KEYS <= set(health),
                  f"no sampler-health keys at the log tick of step {trainer.state.step}")
            health = {k: health[k] for k in sorted(MONITOR_KEYS)}
            check(0.0 <= health["sampler_dist/gini"] <= 1.0
                  and 0.0 <= health["sampler_dist/frac_never_selected"] <= 1.0
                  and health["sampler_dist/bias_ok"] in (0.0, 1.0)
                  and all(math.isfinite(v) for v in health.values()),
                  f"sampler-health keys {health}")
            print(f"sampler health at the log tick of step {trainer.state.step}: {health}")
            row["monitor"] = health
        out[path] = row
        del arms

    probe = build_trainer(torch, main_path["config"].replace(variance_probe_every=2),
                          quiet=True)
    ratios = []
    for _ in range(PROBE_STEPS):
        ratios.append((probe.train_step()["sampler_dist/var_ratio"], probe.state.step))
    ratios = [(float(r), step) for r, step in ratios]
    for r, step in ratios:
        check((r == -1.0) if step % 2 else (math.isfinite(r) and r > 0),
              f"var_ratio {r} at step {step}")
    print(f"variance probe every 2 steps: {[(step, round(r, 5)) for r, step in ratios]} "
          f"(step, var_ratio) [{card}]")
    out["var_ratio"] = ratios
    return out


# ------------------------------------------------------------------ phase 9
def record_nll_shapes(mk):
    """Wrap ``nll_fwd_kernel`` to record the logits' shape of each launch
    (the wrapper still counts it); returns the list and the undo."""
    launch = mk.nll_fwd_kernel
    shapes = []

    def recorded(logits, labels):
        shapes.append(tuple(logits.shape))
        return launch(logits, labels)

    mk.nll_fwd_kernel = recorded

    def undo():
        mk.nll_fwd_kernel = launch

    return shapes, undo


def surface_path(torch, mk, card: str, name: str, config, steps: int, per_step: dict):
    """``steps`` timed steps of ``config`` with the launch counts (``per_step``
    a step) and the NLL kernel's shapes recorded, its telemetry checked, a
    kernel step against a plain step, the peak memory, and the CUDA kernels
    and device time a step (``torch.profiler``, five steps)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(torch, config)
    ds = trainer.dataset
    check(ds.synthetic and ds.num_classes == 100
          and ds.mean.tolist() == torch.tensor(CIFAR100_MEAN).tolist()
          and ds.std.tolist() == torch.tensor(CIFAR100_STD).tolist(),
          f"{name}: synthetic {ds.synthetic}, {ds.num_classes} classes, mean {ds.mean}, "
          f"std {ds.std}")
    warm(trainer)
    shapes, undo = record_nll_shapes(mk)
    try:
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, steps)
    finally:
        undo()
    want = {k: v * steps for k, v in per_step.items()}
    check(counts == want, f"{name}: launch counts {counts}, expected {want}")
    path = "scoretable" if config.use_scoretable else "pool"
    telemetry = check_telemetry(torch, metrics, path, config.batch_size)
    peak = torch.cuda.max_memory_allocated()
    steps_s = steps / dt
    print(f"{name}: {config.model}, {ds.num_classes} classes "
          f"({'synthetic' if ds.synthetic else 'real'} data), {steps} steps in {dt:.3f} s = "
          f"{steps_s:.2f} steps/s, {steps_s * config.batch_size:.1f} trained images/s, "
          f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    print(f"  losses: first {losses[0].item():.4f}, last {losses[-1].item():.4f}; launches "
          f"{counts}; nll_fwd shapes a step {shapes[:len(shapes) // steps]}")
    step_err = kernel_vs_plain_step(torch, trainer, config)
    window = profile_window(torch, trainer, dt / steps * 1e6, steps=5)
    print(f"  torch.profiler over 5 steps: {window['kernels_per_step']:.1f} CUDA kernels and "
          f"{window['device_us_per_step']:.1f} us of device time a step; the device busy "
          f"{100 * window['busy_share_unprofiled']:.1f}% of the unprofiled step [{card}]")
    window.pop("by_kernel")
    return trainer, counts, {
        "config": {k: getattr(config, k) for k in (
            "model", "dataset", "sampler", "importance_score", "augmentation", "cutout",
            "fused_input")},
        "steps": steps, "seconds": dt, "steps_per_s": steps_s, "peak_bytes": peak,
        "synthetic": ds.synthetic, "launches": counts,
        "nll_fwd_shapes": [list(x) for x in shapes[:len(shapes) // steps]],
        "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
        "kernel_vs_plain": step_err, "telemetry": telemetry, "profile": window, "card": card}


def config_surface_phase(torch, card: str) -> dict:
    """Phase 9: the configuration fields beyond the default run, on the
    card. (a) ResNet-152 on 100 classes with gradient-norm scores and the
    IID augmentation (and its evaluation); (b) ResNet-101 on the scoretable
    path with cutout, then with the fused ingest; (c) label smoothing,
    refused with the kernels and run on the plain versions with none;
    (d) ``fit`` under a step budget."""
    from mercury_tpu_torch import TrainConfig, Trainer
    from mercury_tpu_torch.ops import mercury_kernels as mk

    out, launches = {"card": card}, {k: 0 for k in mk.KERNELS}
    # Every configuration reads CIFAR-100 from an empty data_dir: the loader
    # then searches no default directory and gives the synthetic set.
    empty = tempfile.TemporaryDirectory()

    def surface(**fields):
        return TrainConfig(**fields, data_dir=empty.name)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) Two nll_fwd a step: the pool's mean loss (the scores are gradient
    # norms) and the train loss.
    config = surface(**SURFACE_POOL)
    pool_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1, "table_refresh_draw": 0,
                 "augment_normalize": 0}
    trainer, counts, out["pool"] = surface_path(
        torch, mk, card, "config surface (a) pool, grad_norm, iid", config,
        SURFACE_POOL_STEPS, pool_step)
    add(counts)
    check(out["pool"]["nll_fwd_shapes"] == [[320, 100], [32, 100]],
          f"nll_fwd shapes {out['pool']['nll_fwd_shapes']}")
    ev = trainer.evaluate(include_train=False)
    check(math.isfinite(ev["test/eval_loss"]) and 0.0 <= ev["test/eval_acc"] <= 1.0,
          f"IID evaluation {ev}")
    print(f"  IID evaluation (resize 33, crop 32): {ev}")
    out["pool"]["evaluation"] = ev
    del trainer

    # (b) The window's and the batch's nll_fwd, one table draw; unfused
    # with cutout, then fused (CIFAR-100's statistics in the kernel).
    table_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 0, "table_refresh_draw": 1,
                  "augment_normalize": 0}
    config = surface(**SURFACE_TABLE)
    trainer, counts, out["scoretable"] = surface_path(
        torch, mk, card, "config surface (b) scoretable, cutout", config,
        SURFACE_TABLE_STEPS, table_step)
    add(counts)
    check(out["scoretable"]["nll_fwd_shapes"] == [[64, 100], [32, 100]],
          f"nll_fwd shapes {out['scoretable']['nll_fwd_shapes']}")
    del trainer
    config = surface(**{**SURFACE_TABLE, "cutout": False, "fused_input": True})
    trainer, counts, out["scoretable_fused"] = surface_path(
        torch, mk, card, "config surface (b) scoretable, fused", config,
        SURFACE_FUSED_STEPS, {**table_step, "augment_normalize": 2})
    add(counts)
    del trainer

    # (c) The NLL kernels compute the plain NLL: smoothing with them is
    # refused; on the plain route nothing launches.
    smooth = dict(model="resnet18", dataset="cifar100", world_size=1, label_smoothing=0.1)
    try:
        Trainer(surface(**smooth))
    except ValueError as e:
        check("label_smoothing" in str(e), f"label smoothing refused with {e}")
    else:
        raise SmokeFailure("label_smoothing=0.1 with the kernels did not raise")
    trainer = build_trainer(torch, surface(**smooth, use_pallas=False), quiet=True)
    _, counts, losses, _ = timed_steps(torch, mk, trainer, SMOOTH_STEPS)
    check(set(counts.values()) == {0}, f"use_pallas=False launched {counts}")
    print(f"config surface (c) label_smoothing=0.1: refused with the kernels; with "
          f"use_pallas=False {SMOOTH_STEPS} steps, losses {losses.tolist()}, launches {counts} "
          f"[{card}]")
    out["smoothing"] = {"losses": losses.tolist(), "launches": counts}
    del trainer

    # (d) fit stops after the first step at which step × world_size
    # exceeds the budget, and returns the final evaluation.
    trainer = build_trainer(torch, surface(
        model="resnet18", dataset="cifar100", world_size=1, steps_per_epoch=4,
        num_epochs=2, step_budget=3, eval_every=0, log_every=0), quiet=True)
    result = trainer.fit()
    check(trainer.state.step == 4 and "test/eval_acc" in result,
          f"fit under step_budget=3 stopped at step {trainer.state.step}: {sorted(result)}")
    print(f"config surface (d) fit, 4 steps an epoch, 2 epochs, step_budget 3: stopped at "
          f"step {trainer.state.step}, test/eval_acc {result['test/eval_acc']} [{card}]")
    out["fit_budget"] = {"step": trainer.state.step, "eval_acc": result["test/eval_acc"]}
    del trainer
    empty.cleanup()
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 10
def stream_dataset(torch, config, rows: int, directory: str, seed: int = 0):
    """This rank's dataset with its train pixels an ``np.memmap`` of ``rows``
    random CIFAR-shaped uint8 rows written to ``directory`` (labels from the
    same seed), partitioned as ``build_dataset`` partitions, and a random
    test split of ``STREAM_TEST_ROWS`` in memory. Returns the dataset and
    the file's size."""
    import numpy as np

    from mercury_tpu_torch.data import cifar
    from mercury_tpu_torch.data.partition import partition_data
    from mercury_tpu_torch.data.pipeline import make_sharded_dataset
    from mercury_tpu_torch.train.trainer import resolve_device

    rng = np.random.default_rng(seed)
    path = Path(directory) / "train_pixels.u8"
    shape = (rows, 32, 32, 3)
    out = np.memmap(path, dtype=np.uint8, mode="w+", shape=shape)
    for lo in range(0, rows, 5000):
        hi = min(lo + 5000, rows)
        out[lo:hi] = rng.integers(0, 256, (hi - lo,) + shape[1:], dtype=np.uint8)
    out.flush()
    del out
    x = np.memmap(path, dtype=np.uint8, mode="r", shape=shape)
    y = rng.integers(0, 10, rows).astype(np.int32)
    xt = rng.integers(0, 256, (STREAM_TEST_ROWS,) + shape[1:], dtype=np.uint8)
    yt = rng.integers(0, 10, STREAM_TEST_ROWS).astype(np.int32)
    shards = partition_data(y, config.world_size, mode="hetero" if config.noniid else "homo",
                            alpha=config.dirichlet_alpha, seed=config.seed,
                            min_size=config.min_shard_size)
    ds = make_sharded_dataset((x, y), (xt, yt), shards, cifar.CIFAR10_MEAN, cifar.CIFAR10_STD,
                              10, device=resolve_device(), synthetic=True,
                              placement=config.data_placement)
    return ds, path.stat().st_size


def stream_kernel_vs_plain_step(torch, trainer, config, attempts: int = 3):
    """One host-stream step from the same state, popped rows and draws,
    kernels against plain versions on the card, as
    :func:`kernel_vs_plain_step` holds the replicated step: the losses to
    rtol 1e-4, the same draws (pool: the pool's draw; scoretable: the
    lookahead's draw over the table), the telemetry and the emitted rows.
    The kernel step is kept: its state goes on and its rows are pushed."""
    from mercury_tpu_torch.train.step import make_draws

    state = trainer.state
    batch = trainer._stream_pipe.pop()
    band_misses = 0
    for _ in range(attempts):
        draws = make_draws(state, config)
        results, states = {}, {}
        for use_kernels in (True, False):
            states[use_kernels] = state.clone()
            results[use_kernels] = trainer._step_fn(states[use_kernels], batch, draws,
                                                    use_kernels)
        (k_m, k_next), (p_m, p_next) = results[True], results[False]
        if config.use_scoretable:
            # The ring's newest row: the window (sync) and the draw.
            r = 0 if config.use_async else config.refresh_size
            u = draws.uniforms
            k_sel, p_sel = (states[x].pending.slots[-1][r:] for x in (True, False))
        else:
            u = state.pending.draws[0].uniforms
            k_sel, p_sel = k_m["sampler/selected"], p_m["sampler/selected"]
        _, _, differ = check_draws(torch, "host-stream kernel step vs plain step",
                                   p_m["sampler/probs"], u.reshape(-1), k_sel, p_sel)
        if not bool(differ.any()):
            break
        band_misses += 1
    else:
        raise SmokeFailure(f"host-stream kernel and plain steps drew different batches in "
                           f"{attempts} tries (all within the boundary band)")
    check(torch.equal(k_next, p_next), "host-stream kernel and plain steps emitted other rows")
    step_err = {"band_misses": band_misses}
    for key in ("train/loss", "train/pool_loss"):
        a, b = float(k_m[key]), float(p_m[key])
        step_err[key] = abs(a - b)
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"host stream {key}: kernel step {a!r}, plain step {b!r}")
    if config.use_scoretable:
        # The weights are the ring front's (the same on both sides); the
        # table after the write-back may differ in the last bits.
        weights = state.pending.scaled_probs[0]
        step_err["telemetry"] = telemetry_agree(torch, k_m, p_m,
                                                states[False].scoretable.scores, weights)
    else:
        step_err["telemetry"] = telemetry_agree(torch, k_m, p_m)
    trainer.state = states[True]
    trainer._stream_pipe.push(k_next)
    print(f"host-stream kernel step vs plain step: |d loss| {step_err['train/loss']:.2e}, "
          f"|d pool_loss| {step_err['train/pool_loss']:.2e}, same draws and rows "
          f"({band_misses} earlier tries differed inside the boundary band); telemetry "
          f"{step_err['telemetry']}")
    return step_err


def stream_pool(torch, mk, card: str) -> dict:
    """(a) The default pool path, replicated and host_stream: the device
    bytes each dataset holds, 3 + 20 steps of each bit-equal under
    deterministic cuDNN, then the rates in turns under the default
    settings with the stall share and the bytes sent a step."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.train.trainer import build_dataset, resolve_device

    configs = {"replicated": TrainConfig(**STREAM),
               "host_stream": TrainConfig(**STREAM, data_placement="host_stream")}
    check(configs["host_stream"].prefetch_depth == 2
          and configs["host_stream"].stream_rows == 320, f"{configs['host_stream']}")
    # The bytes the build asked the caching allocator for. Its allocated
    # bytes would count whole cached blocks: a free block less than 1 MiB
    # larger than a request is handed out unsplit, so that count moves with
    # what earlier phases left in the cache.
    def requested() -> int:
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    datasets, held, tensors = {}, {}, {}
    for name, config in configs.items():
        torch.cuda.synchronize()
        before = requested()
        datasets[name] = build_dataset(config, resolve_device())
        torch.cuda.synchronize()
        held[name] = requested() - before
        fields = (getattr(datasets[name], f.name) for f in dataclasses.fields(datasets[name]))
        tensors[name] = sum(t.untyped_storage().nbytes() for t in fields
                            if isinstance(t, torch.Tensor) and t.is_cuda)
    pixels = datasets["replicated"].x_train.numel()
    check(pixels == 15_360_000 and held == tensors
          and held["replicated"] - held["host_stream"] == pixels,
          f"device bytes of the datasets {held}, their tensors {tensors}, pixels {pixels}")
    print(f"dataset device bytes: replicated {held['replicated']}, host_stream "
          f"{held['host_stream']} (the 5000 x 3072 train pixels stay in host memory)")

    undo = deterministic_cudnn(torch)
    try:
        trainers = {name: build_trainer(torch, config, dataset=datasets[name], quiet=True)
                    for name, config in configs.items()}
        losses, counts = {}, {}
        for name, trainer in trainers.items():
            mk.reset_launch_counts()
            steps = WARMUP_STEPS + STREAM_STEPS
            losses[name] = torch.stack([trainer.train_step()["train/loss"]
                                        for _ in range(steps)]).float().cpu()
            counts[name] = dict(mk.launch_counts)
        per_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1,
                    "table_refresh_draw": 0, "augment_normalize": 0}
        want = {k: v * (WARMUP_STEPS + STREAM_STEPS) for k, v in per_step.items()}
        check(counts["replicated"] == counts["host_stream"] == want,
              f"launch counts {counts}, expected {want} each")
        check(bool(torch.isfinite(losses["host_stream"]).all())
              and torch.equal(losses["replicated"], losses["host_stream"]),
              f"losses replicated {losses['replicated'].tolist()}, host_stream "
              f"{losses['host_stream'].tolist()}")
        print(f"pool path, deterministic cuDNN: {WARMUP_STEPS + STREAM_STEPS} steps of "
              f"host_stream bit-equal to replicated; losses first "
              f"{losses['host_stream'][0].item():.4f}, last {losses['host_stream'][-1].item():.4f}")
    finally:
        undo()

    hs = trainers["host_stream"]
    rates = {"replicated": [], "host_stream": []}
    stall_share, h2d, launches = [], [], {k: 0 for k in mk.KERNELS}
    for name in ("replicated", "host_stream", "host_stream", "replicated"):
        trainer = trainers[name]
        warm(trainer)
        trainer.stream_stats()
        dt, window, _, metrics = timed_steps(torch, mk, trainer, STREAM_STEPS)
        rates[name].append(STREAM_STEPS / dt)
        if name == "host_stream":
            stats = trainer.stream_stats()
            stall_share.append(stats["data/stall_s"] / dt)
            h2d.append(stats["data/h2d_bytes"])
            for k, v in window.items():
                launches[k] += v
            check_telemetry(torch, metrics, "pool", configs[name].batch_size)
    slab = configs["host_stream"].stream_rows * 32 * 32 * 3
    depth = configs["host_stream"].prefetch_depth
    check(slab == 983_040 and all(b % slab == 0 and abs(b / slab - STREAM_STEPS) <= depth
                                  for b in h2d),
          f"H2D bytes of the windows {h2d}, a slab {slab}")
    step_err = stream_kernel_vs_plain_step(torch, hs, configs["host_stream"])
    print(f"pool path steps/s in turns: replicated {rates['replicated']}, host_stream "
          f"{rates['host_stream']}; stall share {stall_share}; H2D {slab} bytes a step "
          f"(windows {h2d}) [{card}]")
    for trainer in trainers.values():
        trainer.close()
    return {"launches": launches,
            "summary": {"dataset_device_bytes": held, "losses_bit_equal": True,
                        "steps_per_s": rates, "stall_share": stall_share,
                        "h2d_bytes_per_step": slab, "h2d_window_bytes": h2d,
                        "kernel_vs_plain": step_err, "card": card}}


def stream_table(torch, mk, card: str) -> dict:
    """(b) The streamed scoretable at CIFAR-10's train size: a 50,000-row
    np.memmap, a bf16 scorer, 3 + 20 steps with the launches' shapes."""
    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**STREAM_TABLE)
    check(config.refresh_size == 64 and config.batch_size == 32
          and config.stream_rows == 96, f"unexpected streamed scoretable config {config}")
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        ds, nbytes = stream_dataset(torch, config, STREAM_ROWS, directory)
        check(nbytes == STREAM_ROWS * 3072 == 153_600_000, f"memmap of {nbytes} bytes")
        trainer = build_trainer(torch, config, dataset=ds, quiet=True)
        length = trainer.state.scoretable.scores.shape[0]
        check(length == STREAM_ROWS, f"a table of {length} slots")
        print(f"streamed scoretable: {nbytes} bytes of pixels in an np.memmap, a table of "
              f"{length} slots, built in {time.perf_counter() - t0:.1f} s")
        warm(trainer)
        draw_n, ingests = [], []
        select, ingest = mk.score_and_draw_kernel, mk.augment_normalize_kernel

        def select_recorded(losses, *a, **k):
            draw_n.append(int(losses.shape[0]))
            return select(losses, *a, **k)

        def ingest_recorded(raw, *a, **k):
            out = ingest(raw, *a, **k)
            rows = k.get("rows", a[6] if len(a) > 6 else None)
            ingests.append((int(out.shape[0]), rows is None, str(out.dtype)))
            return out

        mk.score_and_draw_kernel, mk.augment_normalize_kernel = select_recorded, ingest_recorded
        try:
            trainer.stream_stats()
            dt, counts, losses, metrics = timed_steps(torch, mk, trainer, STREAM_STEPS)
            stats = trainer.stream_stats()
        finally:
            mk.score_and_draw_kernel, mk.augment_normalize_kernel = select, ingest
        per_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1,
                    "table_refresh_draw": 0, "augment_normalize": 2}
        want = {k: v * STREAM_STEPS for k, v in per_step.items()}
        check(counts == want, f"launch counts {counts}, expected {want}")
        check(draw_n == [STREAM_ROWS] * STREAM_STEPS, f"score_and_draw sizes {set(draw_n)}")
        want_ingest = [(64, True, "torch.bfloat16"), (32, True, "torch.float32")]
        check(ingests == want_ingest * STREAM_STEPS,
              f"augment_normalize launches {sorted(set(ingests))}, expected {want_ingest} a step")
        telemetry = check_telemetry(torch, metrics, "scoretable", config.batch_size)
        steps_s = STREAM_STEPS / dt
        stall = stats["data/stall_s"] / dt
        print(f"streamed scoretable: {STREAM_STEPS} steps in {dt:.3f} s = {steps_s:.2f} "
              f"steps/s, stall share {stall:.4f}, H2D {stats['data/h2d_bytes']:.0f} bytes "
              f"in the window; a step: 2 nll_fwd, 1 nll_bwd, 1 score_and_draw at N={length}, "
              f"augment_normalize without rows at [64] bf16 and [32] f32 [{card}]")
        print(f"  losses: first {losses[0].item():.4f}, last {losses[-1].item():.4f}")
        step_err = stream_kernel_vs_plain_step(torch, trainer, config)
        trainer.close()
        del trainer, ds
    torch.cuda.empty_cache()
    return {"launches": counts,
            "summary": {"memmap_bytes": nbytes, "table_slots": length, "steps": STREAM_STEPS,
                        "seconds": dt, "steps_per_s": steps_s, "stall_share": stall,
                        "h2d_window_bytes": stats["data/h2d_bytes"], "launches": counts,
                        "telemetry": telemetry, "kernel_vs_plain": step_err, "card": card}}


def stream_resume(torch, mk, card: str) -> dict:
    """(c) (a)'s host_stream configuration under deterministic cuDNN: a save
    with the ring in flight after 3 steps, 4 steps on the live trainer and 4
    on a fresh one restored from the file, bit-equal."""
    import shutil

    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**STREAM, data_placement="host_stream")
    undo = deterministic_cudnn(torch)
    directory = tempfile.mkdtemp(prefix="mercury_stream_ckpt_")
    try:
        mk.reset_launch_counts()
        live = build_trainer(torch, config, quiet=True)
        for _ in range(3):
            live.train_step()
        ring = live.state.pending.slots.clone()
        path = live.save(directory)
        a = torch.stack([live.train_step()["train/loss"] for _ in range(STREAM_RESUME)])
        fresh = build_trainer(torch, config, quiet=True)
        check(fresh.restore(directory) == 3, "restored step")
        check(torch.equal(fresh.state.pending.slots, ring), "the restored ring differs")
        b = torch.stack([fresh.train_step()["train/loss"] for _ in range(STREAM_RESUME)])
        counts = dict(mk.launch_counts)
        check(torch.equal(a, b), f"losses live {a.tolist()}, restored {b.tolist()}")
        params = [digest(p) for p in live.state.model.parameters()]
        check(params == [digest(p) for p in fresh.state.model.parameters()],
              "parameters differ after the resumed steps")
        print(f"host-stream resume: saved at step 3 with {config.prefetch_depth} selections "
              f"in flight ({Path(path).stat().st_size} bytes); {STREAM_RESUME} steps live and "
              f"restored bit-equal, losses {a.tolist()} [{card}]")
        live.close()
        fresh.close()
    finally:
        undo()
        shutil.rmtree(directory, ignore_errors=True)
    return {"launches": counts, "summary": {"losses": a.tolist(), "card": card}}


def scoring_device_us(torch, trainer, steps: int = 5) -> float:
    """Device time a step of the scoring forward, from a ``torch.profiler``
    window with the forward under a ``record_function`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mercury_tpu_torch.train import step as step_module

    forward = step_module.scoring_forward

    def annotated(*args, **kwargs):
        with record_function("mercury_scoring"):
            return forward(*args, **kwargs)

    step_module.scoring_forward = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                trainer.train_step()
            torch.cuda.synchronize()
    finally:
        step_module.scoring_forward = forward
    rows = [e for e in prof.key_averages()
            if e.key == "mercury_scoring" and e.device_type == DeviceType.CPU]
    total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) for e in rows)
    return total / steps


def forward_ms(torch, model, images, config, calls: int = 20) -> float:
    """The scoring forward of ``images`` alone, CUDA events over ``calls``."""
    from mercury_tpu_torch.train.step import scoring_forward

    for _ in range(3):
        scoring_forward(model, images, config)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        scoring_forward(model, images, config)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def scoring_dtype_turns(torch, mk, card: str) -> dict:
    """(d) The replicated pool path with float32 training, a bf16 scorer
    against the float32 one: steps/s in turns, the scoring forward's device
    time a step (profiler window) and its time alone at the pool's shape
    (CUDA events)."""
    from mercury_tpu_torch import TrainConfig

    base = TrainConfig(**STREAM, compute_dtype="float32")
    trainers = {dt: build_trainer(torch, base.replace(scoring_dtype=dt), quiet=True)
                for dt in ("bfloat16", None)}
    per_step = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1, "table_refresh_draw": 0,
                "augment_normalize": 0}
    rates = {"bfloat16": [], None: []}
    launches = {k: 0 for k in mk.KERNELS}
    for dt in SCORING_TURNS:
        trainer = trainers[dt]
        warm(trainer)
        seconds, counts, _, _ = timed_steps(torch, mk, trainer, STREAM_STEPS)
        check(counts == {k: v * STREAM_STEPS for k, v in per_step.items()},
              f"scoring_dtype={dt}: launch counts {counts}")
        for k, v in counts.items():
            launches[k] += v
        rates[dt].append(STREAM_STEPS / seconds)
    device_us = {dt: scoring_device_us(torch, trainers[dt]) for dt in rates}
    device = trainers[None].device
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((base.candidate_pool_size, 32, 32, 3), generator=gen, device=device)
    alone = {dt: forward_ms(torch, trainers[dt].state.model, images, trainers[dt].config)
             for dt in rates}
    check(all(v > 0 for v in alone.values()), f"scoring forward times {alone}")
    print(f"scoring_dtype (float32 training, pool path) steps/s in turns: bfloat16 "
          f"{rates['bfloat16']}, float32 scorer {rates[None]}; scoring forward device time a "
          f"step (profiler): bfloat16 {device_us['bfloat16']:.1f} us, float32 "
          f"{device_us[None]:.1f} us; the forward alone at [320] (CUDA events): bfloat16 "
          f"{alone['bfloat16']:.3f} ms, float32 {alone[None]:.3f} ms [{card}]")
    return {"launches": launches,
            "summary": {"steps_per_s": {"bfloat16": rates["bfloat16"], "float32": rates[None]},
                        "scoring_device_us_per_step": {"bfloat16": device_us["bfloat16"],
                                                       "float32": device_us[None]},
                        "scoring_forward_ms": {"bfloat16": alone["bfloat16"],
                                               "float32": alone[None]},
                        "card": card}}


def host_stream_phase(torch, card: str) -> dict:
    """Phase 10: (a) the pool path streamed from host memory against the
    replicated one; (b) the streamed scoretable at CIFAR-10's size with a
    bf16 scorer; (c) a resume with the ring in flight; (d) the bf16 scorer
    on the replicated pool path."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    out, launches = {"card": card}, {k: 0 for k in mk.KERNELS}
    for name, part in (("pool", stream_pool), ("scoretable", stream_table),
                       ("resume", stream_resume), ("scoring_dtype", scoring_dtype_turns)):
        result = part(torch, mk, card)
        out[name] = result["summary"]
        for k, v in result["launches"].items():
            launches[k] += v
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 11
def mode_launches(kernels, name: str, first: int, n: int) -> dict:
    """The launches of ``n`` steps of ``name`` (a ``MODES`` key or "pool")
    from ``state.step == first``, with ``importance_score="loss"``: the
    pool step 2 nll_fwd (pool and batch), 1 nll_bwd, 1 score_and_draw;
    pipelined the same, and at step 0 one more nll_fwd and score_and_draw
    (the boot pool); the cadence 1 nll_fwd and 1 nll_bwd, and one more
    nll_fwd on a refresh step (``step % 8 == 0``), no draw kernel (its draw
    is plain torch); groupwise (fused) 2 nll_fwd, 1 nll_bwd and 2
    augment_normalize (window and batch), its draw plain torch."""
    steps = range(first, first + n)
    out = {k: 0 for k in kernels}
    out.update(nll_fwd=2 * n, nll_bwd=n)
    if name in ("pool", "pipelined"):
        boot = int(name == "pipelined" and 0 in steps)
        out.update(nll_fwd=2 * n + boot, score_and_draw=n + boot)
    elif name == "cadence":
        every = MODES["cadence"]["score_refresh_every"]
        out.update(nll_fwd=n + sum(s % every == 0 for s in steps))
    else:
        out.update(augment_normalize=2 * n)
    return out


def carried_digests(state) -> dict:
    """:func:`state_digests` plus the step mode's carried state: the
    pending batch, the cached pool or the groupwise importance, tags,
    cursor and generation."""
    out = state_digests(dataclasses.replace(state, accum=state.accum or []))
    for name in ("pending_batch", "cached_pool", "groupwise"):
        value = getattr(state, name)
        if value is not None:
            for k, v in value._asdict().items():
                out[f"{name}.{k}"] = digest(v) if hasattr(v, "dtype") else str(v)
    return out


def mode_resume(torch, mk, card: str, trainer, name: str) -> dict:
    """A save of ``trainer`` with its mode's state in flight (the cadence
    two steps before a refresh), then ``MODE_RESUME`` steps live and on a
    fresh trainer restored from the file, under deterministic cuDNN: the
    losses and every digest of the state bit-equal."""
    import shutil

    config = trainer.config
    if config.use_cadence:
        every = config.score_refresh_every
        while trainer.state.step % every != every - 2:
            trainer.train_step()
    undo = deterministic_cudnn(torch)
    directory = tempfile.mkdtemp(prefix="mercury_modes_ckpt_")
    try:
        at = trainer.state.step
        trainer.save(directory)
        saved = carried_digests(trainer.state)
        mk.reset_launch_counts()
        a = torch.stack([trainer.train_step()["train/loss"] for _ in range(MODE_RESUME)])
        counts = dict(mk.launch_counts)
        after = carried_digests(trainer.state)
        fresh = build_trainer(torch, config, quiet=True)
        check(fresh.restore(directory) == at, f"{name}: restored step")
        restored = carried_digests(fresh.state)
        differ = sorted(k for k in saved if restored.get(k) != saved[k])
        check(restored.keys() == saved.keys() and not differ,
              f"{name}: the restored state differs from the saved one: {differ[:5]}")
        b = torch.stack([fresh.train_step()["train/loss"] for _ in range(MODE_RESUME)])
        check(torch.equal(a, b), f"{name}: losses live {a.tolist()}, restored {b.tolist()}")
        again = carried_digests(fresh.state)
        differ = sorted(k for k in after if again.get(k) != after[k])
        check(again.keys() == after.keys() and not differ,
              f"{name}: the restored run's state differs from the live one's: {differ[:5]}")
        check(counts == mode_launches(mk.KERNELS, name, at, MODE_RESUME),
              f"{name}: launch counts {counts} in the resumed steps from step {at}")
        print(f"{name} resume: saved at step {at}, {MODE_RESUME} steps live and restored "
              f"bit-equal ({len(saved)} tensors and counters, the mode's carried state "
              f"among them), losses {a.tolist()} [{card}]")
        del fresh
    finally:
        undo()
        shutil.rmtree(directory, ignore_errors=True)
    return {"saved_at": at, "losses": a.tolist()}


def sampler_modes_phase(torch, card: str) -> dict:
    """Phase 11: the pool sampler's step modes on the main path's config
    (full-width ResNet-18, batch 32, pool 320, 5000 synthetic images, bf16
    autocast): (a) ``pipelined_scoring``, (b) ``score_refresh_every=8``,
    (c) ``sampler="groupwise", fused_input=True``. Each runs 3 warm steps,
    then ``MODE_STEPS`` timed steps a turn in turns with the default pool
    step, its launches counted in every window against
    :func:`mode_launches`; a kernel step against a plain step (the cadence
    at a refresh and at a reuse step); the groupwise weights finite and
    positive; and a save and resume, bit-equal."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    configs = {"pool": TrainConfig(**STREAM)}
    configs.update({name: TrainConfig(**STREAM, **kw) for name, kw in MODES.items()})
    check(configs["pipelined"].use_pipelined and configs["cadence"].use_cadence
          and configs["groupwise"].use_groupwise and configs["groupwise"].fused_input
          and all(c.candidate_pool_size == 320 and c.batch_size == 32 for c in configs.values()),
          f"unexpected sampler-mode configs {configs}")
    trainers = {name: build_trainer(torch, config, quiet=True)
                for name, config in configs.items()}
    launches = {k: 0 for k in mk.KERNELS}
    rates = {name: [] for name in configs}
    summary = {"card": card}

    def window(name, steps, timed=False):
        if steps == 0:
            return {k: 0 for k in mk.KERNELS}, None, []
        trainer = trainers[name]
        first = trainer.state.step
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, steps)
        want = mode_launches(mk.KERNELS, name, first, steps)
        check(counts == want, f"{name}: launch counts {counts} in steps {first}-"
              f"{first + steps - 1}, expected {want}")
        if name != "pool":
            for k, v in counts.items():
                launches[k] += v
        if timed:
            rates[name].append(steps / dt)
        return counts, losses, metrics

    # Step 0 of each mode alone: the pipelined boot (3 nll_fwd, 2
    # score_and_draw), the cadence's first refresh.
    first = {name: window(name, 1)[0] for name in MODES}
    for name in configs:
        window(name, WARMUP_STEPS - (name != "pool"))
    per_step = {}
    for name in MODE_TURNS:
        counts, losses, metrics = window(name, MODE_STEPS, timed=True)
        check_telemetry(torch, metrics, "pool", configs[name].batch_size)
        per_step[name] = {k: v / MODE_STEPS for k, v in counts.items() if v}
        if name == "groupwise":
            for m in metrics:
                w = trained_weights(None, configs[name], m)
                check(bool(torch.isfinite(w).all()) and bool((w > 0).all()),
                      f"groupwise: drawn weights {w.tolist()}")
    for name in MODES:
        print(f"{name}: step 0 launched {first[name]}; a step then {per_step[name]} "
              f"(as mode_launches expects)")
    print(f"sampler modes, steps/s in turns of {MODE_STEPS}: " + ", ".join(
        f"{name} {[round(r, 2) for r in rates[name]]}" for name in configs) + f" [{card}]")
    gw = trainers["groupwise"].state.groupwise
    check(gw.generation == trainers["groupwise"].state.step and gw.generation > 5000 // 320,
          f"groupwise generation {gw.generation} after {trainers['groupwise'].state.step} steps")
    check(trainers["groupwise"].state.stream.cursor == 0, "the groupwise step read the stream")

    for name in MODES:
        trainer, config = trainers[name], configs[name]
        if name == "cadence":
            # Up to a refresh step, compared; that step, then the reuse
            # step after it, compared.
            every = config.score_refresh_every
            window(name, -trainer.state.step % every)
            refresh = kernel_vs_plain_step(torch, trainer, config, quiet=True)
            window(name, 1)
            reuse = kernel_vs_plain_step(torch, trainer, config, quiet=True)
            step_err = {"refresh": refresh, "reuse": reuse}
        else:
            step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
        print(f"{name} kernel step vs plain step: {step_err}")
        summary[name] = {"steps_per_s": rates[name], "launches_step0": first[name],
                         "launches_per_step": per_step[name], "kernel_vs_plain": step_err}
    summary["pool"] = {"steps_per_s": rates["pool"], "launches_per_step": per_step["pool"]}
    for name in MODES:
        summary[name]["resume"] = mode_resume(torch, mk, card, trainers[name], name)
    for trainer in trainers.values():
        trainer.close()
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": summary}


# ----------------------------------------------------------------- phase 12
def grad_path_phase(torch, card: str, main_path) -> dict:
    """Phase 12: the gradient path's options at W=2, two gloo ranks on card
    0 started by ``spawn`` (:func:`grad_path_body` is each rank's part).
    Checks that both ranks saw the same windows, launches, replicas and
    resumes, and prints each arm's rate beside the plain W=2 step's in its
    turn, the collective bytes a step and the optimizer bytes a rank."""
    import shutil

    from mercury_tpu_torch.parallel.distributed import spawn

    per_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    directory = tempfile.mkdtemp(prefix="mercury_grad_ckpt_")
    try:
        ranks = spawn(grad_path_body, TWO_RANKS, "gloo", per_step, directory,
                      devices=[0] * TWO_RANKS, timeout_s=600)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    r0, r1 = ranks
    for key in ("replicas", "resume", "sparse_rate"):
        check(r0[key] == r1[key], f"gradient path: the ranks' {key} differ: "
              f"{r0[key]} and {r1[key]}")
    wire, sent = r0["wire_bytes_per_step"], r0["sent_bytes_per_step"]
    # The gradient's bytes sent a step: the plain bucket's are what the
    # plain arm's all-reduces send beyond the int8 arm's (the BN
    # statistics, the running statistics and the metrics on both); ZeRO's
    # its reduce-scatter and all-gather; int8's every int8 byte.
    bucket = sent["plain"]["all_reduce float32"] - sent["int8"]["all_reduce float32"]
    zero_f32 = (sent["zero"]["reduce_scatter_tensor float32"]
                + sent["zero"]["all_gather_into_tensor float32"])
    ratios = {name: sum(v for k, v in sent[name].items() if k.endswith("int8")) / ref
              for name, ref in (("int8", bucket), ("zero_int8", zero_f32))}
    check(all(0.24 < r < 0.26 for r in ratios.values()),
          f"gradient path: int8 bytes sent over float32 {ratios}")
    summary = {"card": card, "ranks": TWO_RANKS, "backend": "gloo", "steps": GRAD_STEPS,
               "gradient_bucket_sent_bytes": bucket, "zero_float32_sent_bytes": zero_f32,
               "int8_over_float32_sent": ratios, "per_rank": ranks}
    for name in ("plain", *GRAD_ARMS):
        rates = {r["rank"]: [round(v, 3) for v in r["steps_per_s"][name]] for r in ranks}
        ms = [{k: round(v, 2) for k, v in window.items()} for window in r0["wire_ms_per_step"][name]]
        print(f"{name}: steps/s a rank {rates}; bytes handed to torch.distributed a step "
              f"{ {k: round(v) for k, v in wire[name].items()} }, their host ms a step (rank "
              f"0, each window) {ms}; optimizer state {r0['optimizer_bytes'][name]} bytes a "
              f"rank (rank 1: {r1['optimizer_bytes'][name]}); sparse rate "
              f"{r0['sparse_rate'][name]} [{card}]")
    for name in GRAD_ARMS:
        errs = [{**{k: v for k, v in e.items() if k != "telemetry"},
                 "train/grad_norm": e["telemetry"]["train/grad_norm"]}
                for e in (r["kernel_vs_plain"][name] for r in ranks)]
        print(f"{name}: {[round(v, 3) for v in r0['steps_per_s'][name]]} steps/s against the "
              f"plain W=2 step's {[round(v, 3) for v in r0['steps_per_s']['plain_' + name]]} "
              f"in its turn (rank 0) [{card}]; kernel step vs plain step {errs}")
    print(f"the gradient's bytes sent a step by a rank: int8 {ratios['int8']:.4f} of the "
          f"plain all-reduce's {round(bucket)}, ZeRO+int8 {ratios['zero_int8']:.4f} of ZeRO's "
          f"{round(zero_f32)}; sent by call and dtype "
          f"{ {n: {k: round(v) for k, v in sent[n].items()} for n in sent} }")
    print(f"replicas bit-equal after every window ({sum(map(len, r0['replicas'].values()))} "
          f"windows); resumes bit-equal: "
          f"{ {k: v['tensors_and_counters'] for k, v in r0['resume'].items()} } tensors and "
          f"counters, saved at step {r0['resume']['zero']['saved_at']}")
    launches = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    return {"launches": launches, "summary": summary}


def grad_path_body(per_step, directory):
    """One rank of phase 12 (run by ``spawn``; prints nothing): the default
    pool config at W=2 with each ``GRAD_ARMS`` option and without (the
    plain arm), all built first, warmed, then timed in turns (plain, arm),
    with launches, collective bytes and replica digests checked or taken
    per window; a kernel step against a plain step in each arm; under ZeRO
    a save into ``directory`` and a resume."""
    import torch
    import torch.distributed as dist

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.collectives import allreduce_sum

    configs = {"plain": TrainConfig(model="resnet18", dataset="synthetic",
                                    world_size=TWO_RANKS)}
    configs.update({name: configs["plain"].replace(**kw) for name, kw in GRAD_ARMS.items()})
    check(all(c.candidate_pool_size == 320 and c.batch_size == 32 and c.batch_norm == "sync"
              and c.compute_dtype == "bfloat16" for c in configs.values()),
          f"unexpected gradient-path configs {configs}")
    trainers = {name: build_trainer(torch, config, quiet=True)
                for name, config in configs.items()}
    rank = trainers["plain"].rank
    for trainer in trainers.values():
        warm(trainer)

    # (call, dtype, bytes, host seconds) of each collective in a window;
    # gloo returns when the collective is done.
    calls = []

    def counting(name, original, at):
        def counted(*args, **kwargs):
            t = args[at]
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            calls.append((name, str(t.dtype).replace("torch.", ""),
                          t.numel() * t.element_size(), time.perf_counter() - t0))
            return out
        return counted

    originals = {name: getattr(dist, name) for name in WIRE_CALLS}
    for name in WIRE_CALLS:
        setattr(dist, name, counting(name, originals[name], 0 if name == "all_reduce" else 1))

    def replica(trainer):
        model = trainer.state.model
        return {k: digest(v) for k, v in model.state_dict().items()}

    launches = {k: 0 for k in mk.KERNELS}
    rates = {}
    wire, sent, wire_ms, sparse, replicas = {}, {}, {}, {}, {}
    try:
        for arm in GRAD_ARMS:
            for name, key in (("plain", "plain_" + arm), (arm, arm)):
                calls.clear()
                dt, counts, losses, metrics = timed_steps(torch, mk, trainers[name], GRAD_STEPS)
                want = {k: v * GRAD_STEPS for k, v in per_step.items()}
                check(counts == want, f"rank {rank} {name}: launch counts {counts}, "
                      f"expected {want}")
                rates.setdefault(key, []).append(GRAD_STEPS / dt)
                rates.setdefault(name, []).append(GRAD_STEPS / dt)
                if name != "plain":
                    for k, v in counts.items():
                        launches[k] += v
                by, out, ms = {}, {}, {}
                for call, dtype, nbytes, seconds in calls:
                    key = f"{call} {dtype}"
                    by[key] = by.get(key, 0) + nbytes / GRAD_STEPS
                    out[key] = (out.get(key, 0)
                                + WIRE_CALLS[call](TWO_RANKS) * nbytes / GRAD_STEPS)
                    ms[key] = ms.get(key, 0) + seconds * 1e3 / GRAD_STEPS
                wire[name], sent[name] = by, out
                wire_ms.setdefault(name, []).append(ms)
                rate = torch.stack([m["train/sparse_rate"] for m in metrics]).cpu()
                ok = (((rate > 0) & (rate <= 1)).all() if name == "stochastic"
                      else (rate == 1.0).all())
                check(bool(torch.isfinite(rate).all()) and bool(ok),
                      f"rank {rank} {name}: train/sparse_rate {rate.tolist()}")
                sparse[name] = [rate.min().item(), rate.max().item()]
                replicas.setdefault(name, []).append(replica(trainers[name]))
    finally:
        for name, original in originals.items():
            setattr(dist, name, original)

    def any_rank(flag: bool) -> bool:
        return bool(allreduce_sum(torch.tensor(float(flag), device=trainers["plain"].device)) > 0)

    step_err = {}
    for name in GRAD_ARMS:
        try:
            step_err[name] = kernel_vs_plain_step(
                torch, trainers[name], configs[name], any_rank=any_rank, quiet=True)
        except SmokeFailure as e:
            raise SmokeFailure(f"rank {rank} {name}: {e}") from e
    optimizer_bytes = {name: sum(v.numel() * v.element_size()
                                 for st in t.state.optimizer.state.values()
                                 for v in st.values() if torch.is_tensor(v))
                       for name, t in trainers.items()}
    resume = {}
    for name in ("zero", "zero_int8"):
        resume[name] = grad_resume(torch, trainers[name], directory)
    torch.cuda.synchronize()
    for trainer in trainers.values():
        trainer.close()
    return {"rank": rank, "steps_per_s": rates, "launches": launches,
            "wire_bytes_per_step": wire, "sent_bytes_per_step": sent,
            "wire_ms_per_step": wire_ms, "sparse_rate": sparse,
            "replicas": {name: [digest_of_digests(d) for d in windows]
                         for name, windows in replicas.items()},
            "kernel_vs_plain": step_err, "optimizer_bytes": optimizer_bytes,
            "resume": resume}


def digest_of_digests(digests: dict) -> str:
    """One sha256 over a dict of digests, in key order."""
    import hashlib

    return hashlib.sha256(json.dumps(digests, sort_keys=True).encode()).hexdigest()


def grad_resume(torch, trainer, directory: str) -> dict:
    """Under deterministic cuDNN, at two ranks: a save of ``trainer`` into
    ``directory``, ``GRAD_RESUME`` steps live, a fresh trainer restored from
    the file and the same steps; the saved and restored states (each rank's
    ZeRO chunk moments among them), the losses and the states after
    bit-equal. Returns the step saved at, the tensors compared and the
    digest of the state reached."""
    undo = deterministic_cudnn(torch)
    try:
        at = trainer.state.step
        trainer.save(directory)
        saved = carried_digests(trainer.state)
        a = torch.stack([trainer.train_step()["train/loss"] for _ in range(GRAD_RESUME)])
        after = carried_digests(trainer.state)
        fresh = build_trainer(torch, trainer.config, quiet=True)
        check(fresh.restore(directory) == at, "restored step")
        restored = carried_digests(fresh.state)
        differ = sorted(k for k in saved if restored.get(k) != saved[k])
        check(restored.keys() == saved.keys() and not differ,
              f"the restored state differs from the saved one: {differ[:5]}")
        b = torch.stack([fresh.train_step()["train/loss"] for _ in range(GRAD_RESUME)])
        check(torch.equal(a, b), f"losses live {a.tolist()}, restored {b.tolist()}")
        again = carried_digests(fresh.state)
        differ = sorted(k for k in after if again.get(k) != after[k])
        check(again.keys() == after.keys() and not differ,
              f"the restored run's state differs from the live one's: {differ[:5]}")
        fresh.close()
    finally:
        undo()
    return {"saved_at": at, "tensors_and_counters": len(saved),
            "reached": digest_of_digests({k: v for k, v in after.items()
                                          if k.startswith("model.")})}


# ----------------------------------------------------------------- phase 13
def async_kernel_vs_plain(torch, mk, card: str) -> dict:
    """(a) From one state, with the fleet's workers stopped: a chunk of
    ``score_once`` against the same window, augmentation and parameters
    through the live model and the plain NLL; the chunk applied at age 0
    (its scores exactly) and at age 3 (``v·w + μ·(1 − w)`` in float32, bit
    for bit); one async step with the kernels against the plain route from
    the same draws (the same slots, weights to rtol 1e-5, the table's
    untouched slots bit-equal, the rest to rtol 1e-5, slot 0 the decay
    alone); and the sentinel refresh and ``table_refresh_draw`` at R=1
    against the plain versions at L = 5000 and 50,000."""
    import numpy as np

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.data.pipeline import normalize_images
    from mercury_tpu_torch.ops import reference
    from mercury_tpu_torch.sampling.scoretable import decay_scores
    from mercury_tpu_torch.sampling.scorer_fleet import chunk_seed
    from mercury_tpu_torch.train.step import (
        augment_images,
        draw_augment,
        make_draws,
        scoring_forward,
    )

    config = TrainConfig(**ASYNC_TABLE)
    check(config.use_async and config.fused_input and config.refresh_size == 64
          and config.snapshot_every == 16 and config.scorer_workers == 1,
          f"unexpected async config {config}")
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    fleet = trainer._scorer_fleet
    fleet.close()
    ds, state, dev = trainer.dataset, trainer.state, trainer.device
    length, r = ds.shard_len, config.refresh_size
    fleet.snapshot(state.model, state.step)
    chunk_id, start = fleet._chunk_seq, fleet._cursor
    before = dict(fleet.launch_counts)
    chunk = fleet.score_once()
    fleet_nll = fleet.launch_counts["nll_fwd"] - before["nll_fwd"]
    slots = (start + torch.arange(r, device=trainer.device)) % length
    check(torch.equal(chunk.slots, slots.cpu()) and chunk.step == state.step
          and chunk.scores.is_pinned() == (dev.type == "cuda") and fleet_nll == 1,
          f"score_once: slots {chunk.slots.tolist()[:4]}..., step {chunk.step}, "
          f"{fleet_nll} nll_fwd launches")
    gidx = ds.shard_indices[ds.rank][slots]
    gen = torch.Generator(device=trainer.device).manual_seed(chunk_seed(config.seed, chunk_id))
    images = augment_images(normalize_images(ds.x_train[gidx], ds.mean, ds.std),
                            draw_augment(gen, r, config), config)
    with torch.no_grad():
        want = reference.nll_forward(scoring_forward(state.model, images, config).float(),
                                     ds.y_train[gidx])
    score_err = within(chunk.scores, want.cpu(), rtol=1e-3, atol=1e-3)

    table0 = state.scoretable.scores.clone()
    ema = np.float32(state.ema.value.item())
    slots_d = chunk.slots.to(trainer.device)
    rest = torch.ones(length, dtype=torch.bool, device=trainer.device)
    rest[slots_d] = False
    for age in (0, 3):
        state.scoretable = state.scoretable._replace(scores=table0.clone())
        trainer._apply_chunks([chunk._replace(step=state.step - age)], state.step)
        w = np.float32(config.table_decay ** age)
        want_v = chunk.scores.numpy() * w + ema * (np.float32(1.0) - w)
        got = state.scoretable.scores
        check(np.array_equal(got[slots_d].cpu().numpy(), want_v)
              and torch.equal(got[rest], table0[rest]),
              f"the chunk applied at age {age} is not v·w + μ·(1 − w) bit for bit")

    # One async step, kernels against the plain route, from one state.
    probe = state.clone()
    for _ in range(3):
        draws = make_draws(probe, config)
        runs = {}
        for use_kernels in (True, False):
            s = state.clone()
            mk.reset_launch_counts()
            m = trainer._step_fn(s, draws, use_kernels)
            runs[use_kernels] = (m, s, dict(mk.launch_counts))
        (k_m, k_s, k_c), (p_m, p_s, p_c) = runs[True], runs[False]
        _, _, differ = check_draws(torch, "async kernel step vs plain step", p_m["sampler/probs"],
                                   draws.uniforms.reshape(-1), k_m["sampler/selected"],
                                   p_m["sampler/selected"])
        if not bool(differ.any()):
            break
    else:
        raise SmokeFailure("async kernel and plain steps drew different batches in 3 tries")
    check(k_c["table_refresh_draw"] == 1 and p_c["table_refresh_draw"] == 0
          and k_c["nll_fwd"] == 1 and k_c["augment_normalize"] == 1,
          f"async step launches: kernels {k_c}, plain {p_c}")
    sel = k_m["sampler/selected"]
    scaled_err = within(k_m["sampler/probs"][sel] * length,
                        p_m["sampler/probs"][sel] * length, rtol=1e-5, atol=0.0)
    trained = torch.zeros(length, dtype=torch.bool, device=trainer.device)
    trained[sel] = True
    kt, pt = k_s.scoretable.scores, p_s.scoretable.scores
    check(torch.equal(kt[~trained], pt[~trained]),
          "async step: the untouched slots of the kernel and plain tables differ")
    table_err = within(kt[trained], pt[trained], rtol=1e-5, atol=0.0)
    decayed = decay_scores(state.scoretable.scores, state.ema.value, config.table_decay)
    sentinel_ok = bool(trained[0]) or kt[0].item() == decayed[0].item()
    check(sentinel_ok, f"slot 0 after the sentinel {kt[0].item()!r}, the decay "
          f"{decayed[0].item()!r}")
    loss_err = abs(float(k_m["train/loss"]) - float(p_m["train/loss"]))
    check(loss_err <= 1e-4 * abs(float(p_m["train/loss"])),
          f"async step losses {float(k_m['train/loss'])!r}, {float(p_m['train/loss'])!r}")
    tel = telemetry_agree(torch, k_m, p_m, pt)
    check(k_s.scoretable.cursor == state.scoretable.cursor, "the async step moved the cursor")

    # The sentinel refresh alone and the kernel at R = 1, at one block and
    # at a cluster of 16.
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for n in (5000, 50_000):
        scores = torch.rand(n, generator=gen, device=dev) * 4 + 0.1
        ema_t = torch.tensor([0.9], device=dev)
        sent = ema_t + (scores[:1] - ema_t) * config.table_decay
        u = torch.rand(config.batch_size, generator=gen, device=dev)
        new_t = mk.table_refresh_draw_kernel(
            scores, torch.zeros(1, dtype=torch.int64, device=dev), sent, ema_t, u,
            config.is_alpha, config.table_decay)[0]
        check(torch.equal(new_t, decay_scores(scores, ema_t[0], config.table_decay)),
              f"the sentinel refresh at L={n} is not the decay alone")
        for wrap in (False, True):
            cases.append(table_case(torch, mk, reference, gen, n, 1, config.batch_size,
                                    dup=False, wrap=wrap))
    print(f"async (a): score_once [{r}] vs the live model and plain NLL max |err| "
          f"{score_err:.2e}; applied at ages 0 and 3 bit for bit; kernel vs plain step: "
          f"same slots, |d scaled| {scaled_err:.2e}, written-back slots |err| {table_err:.2e}, "
          f"untouched slots and slot 0 (the sentinel) bit-equal, |d loss| {loss_err:.2e}; "
          f"telemetry {tel}; table_refresh_draw at R=1: " + ", ".join(
              f"L={c['shape'][0]} K={c['clusters']} {c['ms'] * 1e3:.2f} us "
              f"(plain {c['plain_ms'] * 1e3:.2f} us)" for c in cases) + f" [{card}]")
    trainer.close()
    del trainer
    return {"score_once_err": score_err, "scaled_err": scaled_err, "table_err": table_err,
            "loss_err": loss_err, "telemetry": tel, "sentinel_slot0_drawn": bool(trained[0]),
            "r1_cases": cases}


def async_live(torch, mk, card: str, fused: bool) -> dict:
    """(b) The scoretable config of phase 5 (``fused_input`` as given):
    the sync step, the async step with a live fleet, and the async step
    with the fleet throttled, ``ASYNC_STEPS`` a turn in ``ASYNC_TURNS``.
    Each window's step launches are checked (async: one nll_fwd a step, the
    sync step's two); the fleet's launches, chunks applied and rejected,
    the staleness, the fleet's rows/s and the snapshot's ms are read."""
    import statistics as st

    from mercury_tpu_torch import TrainConfig

    base = dict(SCORETABLE, fused_input=fused)
    configs = {"sync": TrainConfig(**base),
               "async": TrainConfig(**base, refresh_mode="async"),
               "throttled": TrainConfig(**base, refresh_mode="async",
                                        scorer_throttle_s=ASYNC_THROTTLE_S)}
    trainers = {name: build_trainer(torch, c, quiet=True) for name, c in configs.items()}
    for trainer in trainers.values():
        warm(trainer)
    ingest = 1 if fused else 0
    per_step = {"sync": {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 0,
                         "table_refresh_draw": 1, "augment_normalize": 2 * ingest},
                "async": {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 0,
                          "table_refresh_draw": 1, "augment_normalize": ingest}}
    launches = {k: 0 for k in mk.KERNELS}
    rates = {name: [] for name in configs}
    fleet = {name: {"chunks_applied": 0, "fleet_launches": {k: 0 for k in mk.KERNELS},
                    "staleness_mean": [], "staleness_max": [], "rows_per_s": [],
                    "rejected": 0, "table_range": None} for name in ("async", "throttled")}
    for name in ASYNC_TURNS:
        trainer = trainers[name]
        f = trainer._scorer_fleet
        if f is not None:
            trainer.scorer_stats()
            applied0, counts0 = f.summary()["chunks_applied"], dict(f.launch_counts)
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, ASYNC_STEPS)
        want = {k: v * ASYNC_STEPS for k, v in per_step["sync" if f is None else "async"].items()}
        check(counts == want, f"{name} (fused={fused}): step launches {counts}, expected {want}")
        check_telemetry(torch, metrics, "scoretable" if f is None else "async",
                        configs[name].batch_size)
        rates[name].append(ASYNC_STEPS / dt)
        if f is None:
            continue
        for k, v in counts.items():
            launches[k] += v
        stats = trainer.scorer_stats()
        rec = fleet[name]
        rec["chunks_applied"] += f.summary()["chunks_applied"] - applied0
        for k in mk.KERNELS:
            rec["fleet_launches"][k] += f.launch_counts[k] - counts0[k]
        rec["rejected"] = stats["sampler/chunks_rejected"]
        rec["staleness_mean"].append(stats["sampler/score_staleness_mean"])
        rec["staleness_max"].append(stats["sampler/score_staleness_max"])
        rec["rows_per_s"].append(stats["scorer/throughput"])
        check(trainer.state.scoretable.cursor == 0, f"{name}: the async step moved the cursor")
        # Losses, and so scores, are >= 0; a saturated bf16 softmax gives
        # exact zeros.
        table = trainer.state.scoretable.scores
        check(bool(torch.isfinite(table).all()) and float(table.min()) >= 0,
              f"{name}: the table is not finite and >= 0: min {float(table.min())!r}, "
              f"max {float(table.max())!r}, {int((~torch.isfinite(table)).sum())} "
              f"non-finite, EMA {float(trainer.state.ema.value)!r}")
        rec["table_range"] = [float(table.min()), float(table.max()),
                              int((table == 0).sum())]
    summary = {"steps_per_s": rates, "per_step_launches": per_step}
    for name, rec in fleet.items():
        f = trainers[name]._scorer_fleet
        check(rec["rejected"] == 0, f"{name}: {rec['rejected']} chunks rejected")
        check(rec["chunks_applied"] >= 1 and rec["fleet_launches"]["nll_fwd"] >= 1,
              f"{name}: the fleet applied {rec['chunks_applied']} chunks, launched "
              f"{rec['fleet_launches']}")
        check(rec["fleet_launches"]["augment_normalize"] == 0
              and rec["fleet_launches"]["table_refresh_draw"] == 0,
              f"{name}: fleet launches {rec['fleet_launches']}")
        # A snapshot's host time (the call: the trainer does not wait) and
        # its device time on the trainer's stream (CUDA events around it),
        # the fleet's worker running beside it; medians of 5.
        model, step = trainers[name].state.model, trainers[name].state.step
        host, device = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            f.snapshot(model, step)
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        rec["snapshot_ms"], rec["snapshot_device_ms"] = st.median(host), st.median(device)
        rec["snapshot_bytes"] = sum(t.numel() * t.element_size()
                                    for t in f._snap.tensors.values())
        summary[name] = rec
    print(f"async (b), fused_input={fused}: steps/s in turns of {ASYNC_STEPS}: " + ", ".join(
        f"{n} {[round(x, 2) for x in rates[n]]}" for n in configs) + f"; step launches a "
        f"step sync {per_step['sync']}, async {per_step['async']} [{card}]")
    for name, rec in fleet.items():
        print(f"  {name}: chunks applied {rec['chunks_applied']}, rejected {rec['rejected']}, "
              f"staleness mean {rec['staleness_mean']} max {rec['staleness_max']} steps, "
              f"fleet rows/s {[round(x, 1) for x in rec['rows_per_s']]}, fleet launches "
              f"{rec['fleet_launches']}, snapshot {rec['snapshot_ms']:.3f} ms on the host, "
              f"{rec['snapshot_device_ms']:.3f} ms on the stream ({rec['snapshot_bytes']} "
              f"bytes); table min, max, zeros {rec['table_range']}")
    keep = trainers.pop("async")
    for trainer in trainers.values():
        trainer.close()
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": summary, "trainer": keep}


def async_stream(torch, mk, card: str, stream) -> dict:
    """(c) Phase 10 (b)'s streamed scoretable (a 50,000-row np.memmap,
    fused, bf16 scorer) under async: 3 + 20 steps, B rows streamed a step
    against the sync step's R + B, the stall share, and a kernel step
    against a plain step. The fleet gathers its windows from the memmap on
    the host."""
    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**STREAM_TABLE, refresh_mode="async")
    sync_rows = TrainConfig(**STREAM_TABLE).stream_rows
    check(config.stream_rows == config.batch_size == 32 and sync_rows == 96,
          f"streamed rows: async {config.stream_rows}, sync {sync_rows}")
    with tempfile.TemporaryDirectory() as directory:
        ds, nbytes = stream_dataset(torch, config, STREAM_ROWS, directory)
        trainer = build_trainer(torch, config, dataset=ds, quiet=True)
        warm(trainer)
        fleet = trainer._scorer_fleet
        trainer.stream_stats()
        trainer.scorer_stats()
        applied0 = fleet.summary()["chunks_applied"]
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, STREAM_STEPS)
        stats, fstats = trainer.stream_stats(), trainer.scorer_stats()
        per_step = {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 1,
                    "table_refresh_draw": 0, "augment_normalize": 1}
        want = {k: v * STREAM_STEPS for k, v in per_step.items()}
        check(counts == want, f"async stream: launch counts {counts}, expected {want}")
        # Whole batches of B rows; the pipeline runs prefetch_depth ahead,
        # so a window of STREAM_STEPS pops sees that many copies, give or
        # take the depth.
        batch_bytes = config.batch_size * 32 * 32 * 3
        copies = stats["data/h2d_bytes"] / batch_bytes
        check(copies == int(copies)
              and abs(copies - STREAM_STEPS) <= config.prefetch_depth,
              f"async stream: {stats['data/h2d_bytes']} bytes sent in {STREAM_STEPS} steps, "
              f"not whole batches of {batch_bytes}")
        check_telemetry(torch, metrics, "async", config.batch_size)
        applied = fleet.summary()["chunks_applied"] - applied0
        step_err = stream_kernel_vs_plain_step(torch, trainer, config)
        steps_s, stall = STREAM_STEPS / dt, stats["data/stall_s"] / dt
        sync_bytes = stream["scoretable"]["h2d_window_bytes"] / STREAM_STEPS
        print(f"async (c) streamed scoretable, L={ds.shard_len}: {steps_s:.2f} steps/s "
              f"(sync in phase 10: {stream['scoretable']['steps_per_s']:.2f}), stall share "
              f"{stall:.4f}; {config.stream_rows} rows = {batch_bytes} bytes streamed a step "
              f"({copies:.0f} batches copied in the window) against sync's {sync_rows} rows "
              f"= {sync_bytes:.0f} (phase 10's window over its steps); "
              f"chunks applied {applied}, staleness mean "
              f"{fstats['sampler/score_staleness_mean']:.2f} max "
              f"{fstats['sampler/score_staleness_max']:.0f} steps [{card}]")
        trainer.close()
        del trainer, ds
    torch.cuda.empty_cache()
    return {"launches": counts,
            "summary": {"steps_per_s": steps_s, "stall_share": stall,
                        "rows_per_step": config.stream_rows, "sync_rows_per_step": sync_rows,
                        "bytes_per_step": batch_bytes, "batches_copied": copies,
                        "sync_bytes_per_step": sync_bytes, "chunks_applied": applied,
                        "staleness": [fstats["sampler/score_staleness_mean"],
                                      fstats["sampler/score_staleness_max"]],
                        "launches": counts, "kernel_vs_plain": step_err, "card": card}}


def async_resume(torch, trainer) -> dict:
    """(d) A save, 3 steps, then a restore in the middle of the live run:
    the queue is empty, the snapshot is the restored step's, and every
    chunk applied after it was scored from that snapshot or a later one."""
    steps_after = []
    apply = trainer._apply_chunks

    def recorded(chunks, step):
        steps_after.extend(c.step for c in chunks)
        apply(chunks, step)

    with tempfile.TemporaryDirectory() as directory:
        trainer.save(directory)
        saved = trainer.state.step
        for _ in range(3):
            trainer.train_step()
        t0 = time.perf_counter()
        step = trainer.restore(directory)
        restore_s = time.perf_counter() - t0
        summary = trainer._scorer_fleet.summary()
        check(step == saved == trainer.state.step and summary["queue_depth"] == 0
              and summary["snapshot_step"] == saved,
              f"restore at {step} (saved {saved}): queue {summary['queue_depth']}, "
              f"snapshot step {summary['snapshot_step']}")
        trainer._apply_chunks = recorded
        try:
            deadline = time.monotonic() + 60
            while not steps_after:
                check(time.monotonic() < deadline, "no chunk applied after the restore")
                trainer.train_step()
        finally:
            del trainer._apply_chunks
    check(min(steps_after) >= saved, f"chunks of steps {steps_after} applied after the "
          f"restore to step {saved}")
    trainer.close()
    trainer.close()
    alive = [t.name for t in threading.enumerate() if t.name.startswith("mercury-scorer-")]
    check(not alive, f"scorer threads alive after close(): {alive}")
    print(f"async (d): restored step {saved} in {restore_s:.2f} s with the fleet live: queue "
          f"empty, snapshot at the restored step, the next chunks scored at steps "
          f"{sorted(set(steps_after))}; after close() no scorer thread alive")
    return {"restored_step": saved, "restore_s": restore_s, "chunk_steps_after": steps_after}


def async_scoring_phase(torch, card: str, stream) -> dict:
    """Phase 13: async scoring, (a) kernel against plain from one state,
    (b) a live fleet with the plain and the fused ingest against the sync
    step in turns, (c) the async host stream at L=50,000, (d) a restore in
    the middle of a run and the fleet's close."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    out = {"card": card, "kernel_vs_plain": async_kernel_vs_plain(torch, mk, card)}
    launches = {k: 0 for k in mk.KERNELS}
    live = {}
    for fused in (False, True):
        result = async_live(torch, mk, card, fused)
        out["fused" if fused else "plain"] = result["summary"]
        for k, v in result["launches"].items():
            launches[k] += v
        if fused:
            live = result["trainer"]
        else:
            result["trainer"].close()
    result = async_stream(torch, mk, card, stream)
    out["host_stream"] = result["summary"]
    for k, v in result["launches"].items():
        launches[k] += v
    out["resume"] = async_resume(torch, live)
    del live
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 14
def service_chunks(torch, mk, card: str) -> dict:
    """(a) From one state and snapshot, workers stopped: the device
    backend's two chunks against the host fleet's (bit for bit), with the
    service's ``nll_fwd`` counted in its own counts, on a stream of its
    own; tenant 1's chunk from its own generator (``chunk_seed(seed,
    0x100000)``), held against the same chunk with the plain NLL to the
    kernel phase's ``nll_fwd`` tolerance."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.sampling import scorer_fleet
    from mercury_tpu_torch.sampling.scorer_fleet import ScorerFleet, chunk_seed
    from mercury_tpu_torch.sampling.scorer_service import _TENANT_KEY_STRIDE, ScorerService

    config = TrainConfig(**ASYNC_TABLE)
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    trainer.close()
    ds, model, dev, step = trainer.dataset, trainer.state.model, trainer.device, trainer.state.step
    tenants = config.replace(scorer_tenants=2)
    scorers = {"fleet": ScorerFleet(ds, model, config, dev),
               "device": ScorerService(ds, model, config.replace(scorer_backend="device"), dev),
               "tenants": ScorerService(ds, model, tenants, dev),
               "plain": ScorerService(ds, model, tenants.replace(use_pallas=False), dev)}
    for s in scorers.values():
        s.close()
        s.snapshot(model, step)
    mk.reset_launch_counts()
    host = [scorers["fleet"].score_once() for _ in range(2)]
    svc = scorers["device"]
    before = svc.launch_counts["nll_fwd"]
    # The stream current at each of the service's nll_fwd calls.
    streams = []
    nll = mk.per_sample_nll

    def on_stream(logits, labels):
        streams.append(torch.cuda.current_stream(logits.device).cuda_stream
                       if logits.is_cuda else None)
        return nll(logits, labels)

    mk.per_sample_nll = on_stream
    try:
        on_device = [svc.score_once() for _ in range(2)]
    finally:
        mk.per_sample_nll = nll
    svc_nll = svc.launch_counts["nll_fwd"] - before
    for k, (a, b) in enumerate(zip(host, on_device)):
        check(a.step == b.step == step and torch.equal(a.slots, b.slots)
              and torch.equal(a.scores, b.scores),
              f"the device backend's chunk {k} is not the host fleet's")
    own = svc._scorer.stream()   # this thread's scoring stream (None on the CPU)
    check(svc_nll == 2 and mk.launch_counts["nll_fwd"] == 0
          and (dev.type == "cpu"
               or (streams == [own.cuda_stream] * 2
                   and own.cuda_stream != torch.cuda.default_stream(dev).cuda_stream)),
          f"the service's nll_fwd: {svc_nll} launches in its counts, "
          f"{mk.launch_counts['nll_fwd']} in the step's; on streams {streams}, its own "
          f"{own}")
    seeds = []
    draw = scorer_fleet.draw_augment

    def recorded(gen, n, cfg):
        seeds.append(gen.initial_seed())
        return draw(gen, n, cfg)

    scorer_fleet.draw_augment = recorded
    try:
        t1 = scorers["tenants"].score_once(1)
        plain = scorers["plain"].score_once(1)
    finally:
        scorer_fleet.draw_augment = draw
    want_seed = chunk_seed(config.seed, _TENANT_KEY_STRIDE)
    check(seeds == [want_seed] * 2 and torch.equal(t1.slots, host[0].slots)
          and not torch.equal(t1.scores, host[0].scores),
          f"tenant 1's chunk: seeds {seeds}, want {want_seed}")
    err = within(t1.scores, plain.scores, rtol=1e-5, atol=1e-5)
    program = svc.summary()["program"]
    print(f"service (a): the device backend's 2 chunks [{config.refresh_size}] bit-equal to "
          f"the host fleet's; the service's nll_fwd {svc_nll} launches in its own counts (the "
          f"step's 0), on its own stream; program {program}; tenant 1's chunk from seed "
          f"chunk_seed(seed, 0x100000), kernel against the plain NLL max |err| {err:.2e} "
          f"[{card}]")
    del trainer, scorers
    torch.cuda.empty_cache()
    return {"bit_equal_chunks": 2, "service_nll_fwd": svc_nll, "tenant1_err": err,
            "program": program}


def service_live(torch, mk, card: str, fused: bool) -> dict:
    """(b) Phase 5's scoretable config (``fused_input`` as given): the
    sync step, async with the host fleet and async with the device backend,
    ``SERVICE_STEPS`` a turn in ``SERVICE_TURNS``. Each window's step
    launches are checked; each async arm's chunks scored and applied a
    step, staleness and scorer launches a step are read; the device arm's
    picks in each snapshot epoch (read at the next snapshot) must be at
    most its cap."""
    from mercury_tpu_torch import TrainConfig

    base = dict(SCORETABLE, fused_input=fused)
    configs = {"sync": TrainConfig(**base),
               "host": TrainConfig(**base, refresh_mode="async"),
               "device": TrainConfig(**base, refresh_mode="async", scorer_backend="device")}
    trainers = {name: build_trainer(torch, c, quiet=True) for name, c in configs.items()}
    svc = trainers["device"]._scorer_fleet
    epochs = []
    snapshot = svc.snapshot

    def paced(model, step):
        epochs.append(svc._tenants[0].scored_in_epoch)
        snapshot(model, step)

    svc.snapshot = paced
    for trainer in trainers.values():
        warm(trainer)
    ingest = 1 if fused else 0
    per_step = {"sync": {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 0,
                         "table_refresh_draw": 1, "augment_normalize": 2 * ingest},
                "async": {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 0,
                          "table_refresh_draw": 1, "augment_normalize": ingest}}
    launches = {k: 0 for k in mk.KERNELS}
    rates = {name: [] for name in configs}
    arms = {name: {"scored": 0, "applied": 0, "scorer_launches": {k: 0 for k in mk.KERNELS},
                   "staleness_mean": [], "staleness_max": [], "rejected": 0}
            for name in ("host", "device")}
    epochs_before = len(epochs)
    for turn, name in enumerate(SERVICE_TURNS):
        trainer = trainers[name]
        f = trainer._scorer_fleet
        if f is not None:
            trainer.scorer_stats()
            s0, c0 = f.summary(), dict(f.launch_counts)
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, SERVICE_STEPS)
        want = {k: v * SERVICE_STEPS
                for k, v in per_step["sync" if f is None else "async"].items()}
        check(counts == want, f"{name} (fused={fused}): step launches {counts}, "
              f"expected {want}")
        rates[name].append(SERVICE_STEPS / dt)
        if f is None:
            continue
        if name == "device" and turn == SERVICE_TURNS.index("device"):
            check_telemetry(torch, metrics, "async", configs[name].batch_size)
        stats, s1 = trainer.scorer_stats(), f.summary()
        rec = arms[name]
        rec["scored"] += s1["chunks_scored"] - s0["chunks_scored"]
        rec["applied"] += s1["chunks_applied"] - s0["chunks_applied"]
        for k in mk.KERNELS:
            rec["scorer_launches"][k] += f.launch_counts[k] - c0[k]
        rec["rejected"] = stats["sampler/chunks_rejected"]
        rec["staleness_mean"].append(stats["sampler/score_staleness_mean"])
        rec["staleness_max"].append(stats["sampler/score_staleness_max"])
        if name == "device":
            for k, v in counts.items():
                launches[k] += v
            for k in mk.KERNELS:
                launches[k] += f.launch_counts[k] - c0[k]
        table = trainer.state.scoretable.scores
        check(bool(torch.isfinite(table).all()) and trainer.state.scoretable.cursor == 0,
              f"{name}: the table is not finite, or the cursor moved")
    steps = SERVICE_STEPS * SERVICE_TURNS.count("host")
    for name, rec in arms.items():
        check(rec["rejected"] == 0 and rec["applied"] >= 1
              and rec["scorer_launches"]["nll_fwd"] >= 1
              and rec["scorer_launches"]["augment_normalize"] == 0,
              f"{name} (fused={fused}): {rec}")
        rec.update(scored_per_step=rec["scored"] / steps, applied_per_step=rec["applied"] / steps,
                   nll_fwd_per_step=rec["scorer_launches"]["nll_fwd"] / steps)
    cap = svc._epoch_cap
    paced_epochs = epochs[epochs_before:]
    check(paced_epochs and max(paced_epochs) <= cap and max(paced_epochs) >= 1,
          f"device (fused={fused}): chunks picked in each snapshot epoch {paced_epochs}, "
          f"cap {cap}")
    # Each arm's turn over the sync turn in the same half of the order.
    ratios = {name: [a / b for a, b in zip(rates[name], rates["sync"])]
              for name in ("host", "device")}
    print(f"service (b), fused_input={fused}: steps/s in turns of {SERVICE_STEPS}: " + ", ".join(
        f"{n} {[round(x, 2) for x in rates[n]]}" for n in configs) + f"; device picked "
        f"{paced_epochs} chunks in its snapshot epochs (cap {cap}) [{card}]")
    for name, rec in arms.items():
        print(f"  {name}: {rec['scored_per_step']:.3f} chunks scored and "
              f"{rec['applied_per_step']:.3f} applied a step, staleness mean "
              f"{rec['staleness_mean']} max {rec['staleness_max']} steps, scorer nll_fwd "
              f"{rec['nll_fwd_per_step']:.3f} a step, rejected {rec['rejected']}")
    keep = trainers.pop("device")
    keep._scorer_fleet.snapshot = snapshot
    for trainer in trainers.values():
        trainer.close()
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches, "trainer": keep,
            "summary": {"steps_per_s": rates, "epoch_picks": paced_epochs, "cap": cap,
                        "turn_ratios_over_sync": ratios, **arms}}


def tenant_shares(torch, mk, card: str) -> dict:
    """(c) Two tenants at ``TENANT_WEIGHTS`` on the host backend against
    the one-tenant fleet, ``TENANT_STEPS`` a turn in ``TENANT_TURNS``: the
    chunk shares, the rates, and tenant 1's chunks discarded as
    delivered."""
    from mercury_tpu_torch import TrainConfig

    configs = {"one": TrainConfig(**ASYNC_TABLE),
               "two": TrainConfig(**ASYNC_TABLE, scorer_tenants=2,
                                  scorer_tenant_weights=TENANT_WEIGHTS)}
    trainers = {name: build_trainer(torch, c, quiet=True) for name, c in configs.items()}
    for trainer in trainers.values():
        warm(trainer)
    svc, fleet = trainers["two"]._scorer_fleet, trainers["one"]._scorer_fleet
    scored0 = [t["chunks_scored"] for t in svc.summary()["tenants"]]
    fleet0 = fleet.summary()["chunks_scored"]
    c0 = dict(svc.launch_counts)
    launches = {k: 0 for k in mk.KERNELS}
    rates = {name: [] for name in configs}
    for name in TENANT_TURNS:
        dt, counts, losses, metrics = timed_steps(torch, mk, trainers[name], TENANT_STEPS)
        rates[name].append(TENANT_STEPS / dt)
        if name == "two":
            for k, v in counts.items():
                launches[k] += v
    trainers["two"].train_step()   # drains what the last turn queued
    fitted = trainers["two"].fit(steps=2)
    check(math.isfinite(fitted["train/loss"]) and math.isfinite(fitted["test/eval_loss"]),
          f"two tenants: fit gave {fitted}")
    tenants = svc.summary()["tenants"]
    scored = [t["chunks_scored"] - s for t, s in zip(tenants, scored0)]
    one = fleet.summary()["chunks_scored"] - fleet0
    for k in mk.KERNELS:
        launches[k] += svc.launch_counts[k] - c0[k]
    total = max(sum(scored), 1)
    shares = [c / total for c in scored]
    check(scored[1] >= 1 and scored[0] > scored[1]
          and tenants[1]["discarded"] == tenants[1]["delivered"] >= 1
          and tenants[0]["discarded"] == 0,
          f"two tenants: scored {scored}, tenants {tenants}")
    steps = TENANT_STEPS * TENANT_TURNS.count("two")
    print(f"service (c): two tenants at weights {TENANT_WEIGHTS!r}, host backend: chunks "
          f"scored {scored} in {steps} steps (shares {[round(x, 3) for x in shares]}; the "
          f"one-tenant fleet {one}); steps/s "
          f"in turns of {TENANT_STEPS}: one tenant {[round(x, 2) for x in rates['one']]}, "
          f"two {[round(x, 2) for x in rates['two']]}; tenant 1 delivered and discarded "
          f"{tenants[1]['discarded']} [{card}]")
    for trainer in trainers.values():
        trainer.close()
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches,
            "summary": {"scored": scored, "shares": shares, "one_tenant_scored": one,
                        "steps_per_s": rates, "tenants": tenants}}


def lockstep_phase(torch, card: str) -> dict:
    """(d) The device backend's lockstep at W=2: two gloo ranks on card 0
    (:func:`lockstep_body`), each running ``LOCKSTEP_STEPS`` steps twice.
    Chunk q carries snapshot q's step and is applied at the tick after
    snapshot q+1 on both ranks, in both runs, and each rank's final table
    is bit-equal between its runs."""
    from mercury_tpu_torch.parallel.distributed import spawn

    ranks = spawn(lockstep_body, TWO_RANKS, "gloo", devices=[0] * TWO_RANKS, timeout_s=600)
    every = LOCKSTEP["snapshot_every"]
    want = [(s + every + 1, s) for s in range(0, LOCKSTEP_STEPS - every, every)]
    for r in ranks:
        check(r["tables"][0] == r["tables"][1],
              f"lockstep rank {r['rank']}: the final tables of the two runs differ")
        for run in r["runs"]:
            check(run["applied"] == want, f"lockstep rank {r['rank']}: applied (tick step, "
                  f"chunk step) {run['applied']}, expected {want}")
    check(ranks[0]["runs"][0]["applied"] == ranks[1]["runs"][0]["applied"],
          "lockstep: the ranks applied different schedules")
    for r in ranks:
        waits = [[round(w, 3) for w in run["waits_ms"]] for run in r["runs"]]
        print(f"service (d) rank {r['rank']}: lockstep W=2 over gloo on one card, "
              f"snapshot_every={every}: chunks applied at (tick, snapshot step) "
              f"{r['runs'][0]['applied']}; the trainer's wait at each snapshot {waits} ms; "
              f"steps/s {[round(run['steps_per_s'], 2) for run in r['runs']]}; final table "
              f"bit-equal across the two runs ({r['tables'][0][:12]}); service nll_fwd "
              f"{r['runs'][-1]['service_launches']['nll_fwd']} [{card}]")
    launches = {k: sum(run["launches"][k] + run["service_launches"][k]
                       for r in ranks for run in r["runs"])
                for k in ranks[0]["runs"][0]["launches"]}
    return {"launches": launches, "summary": {"per_rank": ranks, "applied": want}}


def lockstep_body():
    """One rank of phase 14 (d) (run by ``spawn``; prints nothing):
    ``LOCKSTEP`` under deterministic cuDNN, ``LOCKSTEP_STEPS`` steps from
    a fresh Trainer, twice; each run's applied chunks, snapshot waits,
    launches, rate and final table's digest."""
    import torch

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    config = TrainConfig(**LOCKSTEP)
    undo = deterministic_cudnn(torch)
    runs, tables = [], []
    try:
        for _ in range(2):
            trainer = build_trainer(torch, config, quiet=True)
            svc = trainer._scorer_fleet
            check(svc.summary()["lockstep"], "the W=2 device backend is not in lockstep")
            applied = []
            apply = trainer._apply_chunks

            def recorded(chunks, step, apply=apply, applied=applied):
                applied.extend((step, c.step) for c in chunks)
                apply(chunks, step)

            trainer._apply_chunks = recorded
            c0 = dict(svc.launch_counts)
            dt, counts, losses, metrics = timed_steps(torch, mk, trainer, LOCKSTEP_STEPS)
            runs.append({"applied": list(applied), "waits_ms": list(svc.barrier_waits_ms),
                         "steps_per_s": LOCKSTEP_STEPS / dt, "launches": counts,
                         "service_launches": {k: svc.launch_counts[k] - c0[k]
                                              for k in mk.KERNELS},
                         "losses": losses.tolist()})
            tables.append(digest(trainer.state.scoretable.scores))
            fitted = trainer.fit(steps=2)
            check(math.isfinite(fitted["train/loss"]), f"lockstep: fit gave {fitted}")
            trainer.close()
            del trainer, svc
            torch.cuda.empty_cache()
    finally:
        undo()
    import torch.distributed as dist

    return {"rank": dist.get_rank(), "runs": runs, "tables": tables}


def service_resume(torch, trainer) -> dict:
    """(e) ``fit`` for 2 steps, a save, 3 steps, then a restore in the
    live device-backend run: every tenant's queue is empty and the
    snapshot is the restored step's; after ``close()`` (twice) no scorer
    thread is left."""
    fitted = trainer.fit(steps=2)
    check(math.isfinite(fitted["train/loss"]) and math.isfinite(fitted["test/eval_loss"]),
          f"device backend: fit gave {fitted}")
    with tempfile.TemporaryDirectory() as directory:
        trainer.save(directory)
        saved = trainer.state.step
        for _ in range(3):
            trainer.train_step()
        step = trainer.restore(directory)
        summary = trainer._scorer_fleet.summary()
        check(step == saved == trainer.state.step and summary["snapshot_step"] == saved
              and all(t["queue_depth"] == 0 for t in summary["tenants"]),
              f"restore at {step} (saved {saved}): {summary}")
        trainer.train_step()
    trainer.close()
    trainer.close()
    alive = [t.name for t in threading.enumerate() if t.name.startswith("mercury-scorer-")]
    check(not alive, f"scorer threads alive after close(): {alive}")
    print(f"service (e): fit(steps=2) loss {fitted['train/loss']:.4f}; restored step {saved} "
          f"in a live device-backend run: every queue empty, the snapshot at the restored "
          f"step; no scorer thread after close()")
    return {"restored_step": saved}


def scorer_service_phase(torch, card: str) -> dict:
    """Phase 14: the scorer service. (a) the device backend's chunks
    against the fleet's, and tenant 1's; (b) sync, async host and async
    device in turns, plain and fused ingest; (c) two tenants at "3,1";
    (d) the lockstep at W=2, twice; (e) a restore in a live device run;
    (f) with a second card visible, the device backend on the spare."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    out = {"card": card, "chunks": service_chunks(torch, mk, card)}
    launches = {k: 0 for k in mk.KERNELS}
    live = None
    for fused in (False, True):
        result = service_live(torch, mk, card, fused)
        out["fused" if fused else "plain"] = result["summary"]
        for k, v in result["launches"].items():
            launches[k] += v
        if fused:
            live = result["trainer"]
        else:
            result["trainer"].close()
    for name, result in (("tenants", tenant_shares(torch, mk, card)),
                         ("lockstep", lockstep_phase(torch, card))):
        out[name] = result["summary"]
        for k, v in result["launches"].items():
            launches[k] += v
    out["resume"] = service_resume(torch, live)
    del live
    out["spare"] = spare_card(torch, mk, card)
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": out}

# ----------------------------------------------------------------- phase 15
def cli_subprocess(argv, timeout_s: float = CLI_TIMEOUT_S) -> dict:
    """Run ``argv`` from the checkout's root; it must exit 0 with a JSON
    object as its last line of stdout, which is returned with the time."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=timeout_s)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(argv[:6])} … exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    try:
        metrics = json.loads(last)
    except ValueError:
        raise SmokeFailure(f"{' '.join(argv[:6])} …: last line is not JSON: {last[:300]}")
    check(math.isfinite(metrics.get("train/loss", math.nan)),
          f"{' '.join(argv[:6])} …: train/loss {metrics.get('train/loss')}")
    return {"seconds": seconds, "metrics": metrics}


def main_thread_syncs(torch, fn) -> list:
    """The synchronizing CUDA calls ``fn`` makes on this thread, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (another
    thread's, such as the metric writer's drain, are left out)."""
    import warnings

    me = threading.current_thread()
    caught = []

    def show(message, *args, **kwargs):
        # "called a synchronizing CUDA operation"; not the mode's one-time
        # notice that it is a prototype.
        if (threading.current_thread() is me
                and "synchronizing CUDA operation" in str(message)):
            caught.append(str(message).splitlines()[0])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return caught


def cli_dry_run(torch, mk, card: str) -> dict:
    """(a) ``cli.main(["--dry-run", …])`` in this process: its launches,
    then its step again from the state before it (the same draws), with the
    kernels against the plain versions."""
    import io
    from contextlib import redirect_stdout

    from mercury_tpu_torch import TrainConfig, cli
    from mercury_tpu_torch.train.trainer import Trainer

    seen = {}
    step = Trainer.train_step

    def spy(self, *args, **kwargs):
        seen["trainer"], seen["before"] = self, self.state.clone()
        seen["metrics"] = step(self, *args, **kwargs)
        return seen["metrics"]

    out = io.StringIO()
    Trainer.train_step = spy
    try:
        mk.reset_launch_counts()
        with redirect_stdout(out):
            rc = cli.main(CLI_ARGS + ["--dry-run"])
        torch.cuda.synchronize()
        counts = dict(mk.launch_counts)
    finally:
        Trainer.train_step = step
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2, f"dry run: rc {rc}, output {lines}")
    printed = json.loads(lines[-1])
    want = {"nll_fwd": 2, "nll_bwd": 1, "score_and_draw": 1, "table_refresh_draw": 0,
            "augment_normalize": 0}
    check(counts == want, f"dry run: launches {counts}, expected {want}")
    check(set(printed) == set(seen["metrics"]) and math.isfinite(printed["train/loss"]),
          f"dry run printed {sorted(printed)}")
    trainer = seen["trainer"]
    check(trainer.device.type == "cuda", f"dry run trained on {trainer.device}")
    config = TrainConfig(model="resnet18", dataset="synthetic", world_size=1)
    check(trainer.config == config, f"dry run config {trainer.config}")
    trainer.state = seen["before"]
    step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
    print(f"cli (a): {lines[0]}; one step, launches {counts}, train/loss "
          f"{printed['train/loss']:.4f}; the same step with the plain versions |d loss| "
          f"{step_err['train/loss']:.2e} ({step_err['band_misses']} band retries) [{card}]")
    del trainer, seen
    torch.cuda.empty_cache()
    return {"launches": counts, "loss": printed["train/loss"], "kernel_vs_plain": step_err}


def cli_fit(torch, mk, card: str, directory: str) -> dict:
    """(c) ``cli.main`` fitting CLI_FIT_STEPS steps with a record every
    CLI_LOG_EVERY and a heartbeat every CLI_LOG_EVERY into ``directory``:
    one record a tick with a finite loss and 0 < perf/mfu < 1, the
    manifest's card, the shards, the heartbeat lines, and the launches (the
    steps' and the final evaluation's nll_fwd)."""
    import io
    from contextlib import redirect_stdout

    from mercury_tpu_torch import cli

    out = io.StringIO()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        rc = cli.main(CLI_ARGS + [
            "--steps-per-epoch", str(CLI_FIT_STEPS), "--num-epochs", "1",
            "--log-every", str(CLI_LOG_EVERY), "--heartbeat-every", str(CLI_LOG_EVERY),
            "--eval-every", "0", "--log-dir", directory])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(mk.launch_counts)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0, f"fit: rc {rc}")
    final = json.loads(lines[-1])
    records = [json.loads(line) for line in open(Path(directory) / "metrics.jsonl")]
    ticks = list(range(CLI_LOG_EVERY, CLI_FIT_STEPS + 1, CLI_LOG_EVERY))
    check([r["step"] for r in records] == ticks, f"fit: records at {[r['step'] for r in records]}")
    for r in records:
        check(math.isfinite(r["train/loss"]) and 0 < r["perf/mfu"] < 1,
              f"fit: record at {r['step']}: loss {r['train/loss']}, mfu {r['perf/mfu']}")
    manifest = json.loads((Path(directory) / "run_manifest.json").read_text())
    name = torch.cuda.get_device_name(0)
    check(manifest["device_kind"] == name and manifest["platform"] == "gpu"
          and manifest["peak_flops"] == 989.4e12, f"fit: manifest {manifest}")
    shards = sorted(p.name for p in Path(directory).iterdir())
    check({"metrics.h0.jsonl", "heartbeat.h0.jsonl"} <= set(shards), f"fit: files {shards}")
    beats = [line for line in lines if line.startswith("step ")]
    check(beats, f"fit: no heartbeat line in {lines[:5]}")
    # The final evaluation runs nll_fwd once a batch of 256 on each split.
    evals = -(-5000 // 256) + -(-1000 // 256)
    want = {"nll_fwd": 2 * CLI_FIT_STEPS + evals, "nll_bwd": CLI_FIT_STEPS,
            "score_and_draw": CLI_FIT_STEPS, "table_refresh_draw": 0, "augment_normalize": 0}
    check(counts == want, f"fit: launches {counts}, expected {want}")
    flops = records[-1]["perf/flops_per_step"]
    summary = {"seconds": seconds, "launches": counts, "final": final, "heartbeats": beats,
               "records": records, "flops_per_step": flops, "manifest_device": name,
               "files": shards}
    print(f"cli (c): fit of {CLI_FIT_STEPS} steps in {seconds:.2f} s (build and final "
          f"evaluation included); records at {ticks}: steps/s "
          f"{[round(r['perf/steps_per_s'], 2) for r in records]}, perf/mfu "
          f"{[round(r['perf/mfu'], 5) for r in records]}, perf/flops_per_step {flops:.0f}, "
          f"loss {[round(r['train/loss'], 4) for r in records]}; {len(beats)} heartbeat "
          f"line(s), first: {beats[0]!r}; files {shards}; launches {counts} [{card}]")
    return summary


def cli_rates(torch, mk, card: str, directory: str) -> dict:
    """(d) ``fit`` of CLI_RATE_STEPS steps a turn with no metric stream
    (``log_every=0``), with records but no ``log_dir``, and with
    ``log_dir`` and the heartbeat, in turns (the final evaluation left
    out; a first fit of CLI_LOG_EVERY steps a trainer, untimed, takes the
    FLOP count and starts the drain thread); the host time of a log tick
    on the training thread and of a record on the drain thread; the time
    of the FLOP count; the synchronizing calls of one log tick on the
    training thread (none expected); returns the log_dir trainer for (e)
    and (g)."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.obs.accounting import flops_per_step

    def timed(fn, into):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                into.append(time.perf_counter() - t0)
        return wrapper

    trainers = {}
    try:
        for name, kw in CLI_RATE_ARMS.items():
            log_dir = str(Path(directory) / "rates") if name == "log_dir" else None
            trainer = build_trainer(torch, TrainConfig(
                model="resnet18", dataset="synthetic", world_size=1, log_dir=log_dir,
                eval_every=0, **kw), quiet=True)
            trainers[name] = trainer
            trainer.evaluate = lambda include_train=True: {}
            warm(trainer)
            trainer.fit(steps=CLI_LOG_EVERY)
        live = trainers["log_dir"]
        t0 = time.perf_counter()
        flops = flops_per_step(live)
        count_ms = (time.perf_counter() - t0) * 1e3
        tick_s, emit_s, flush_s = [], [], []
        live._log_tick = timed(live._log_tick, tick_s)
        live.logger._emit = timed(live.logger._emit, emit_s)
        live.logger._flush_sinks = timed(live.logger._flush_sinks, flush_s)
        sink_s = {f"{i}:{type(sink).__name__}": [] for i, sink in enumerate(live.logger.sinks)}
        for (name, into), sink in zip(sink_s.items(), live.logger.sinks):
            sink.write = timed(sink.write, into)
        rates = {name: [] for name in trainers}
        for name in CLI_RATE_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[name].fit(steps=CLI_RATE_STEPS)
            torch.cuda.synchronize()
            rates[name].append(CLI_RATE_STEPS / (time.perf_counter() - t0))
        live.logger.flush()
        tick_us = statistics.mean(tick_s) * 1e6
        emit_us = statistics.mean(emit_s) * 1e6
        sink_us = {name: statistics.mean(v) * 1e6 for name, v in sink_s.items() if v}
        flush_us = statistics.mean(flush_s) * 1e6
        metrics = live.train_step()
        syncs = main_thread_syncs(torch, lambda: live._log_tick(live.state.step, metrics))
        check(not syncs, f"a log tick synchronized the training thread: {syncs}")
        live.logger.flush()
    except BaseException:
        for trainer in trainers.values():
            trainer.close()
        raise
    for name in ("none", "records"):
        trainers[name].close()
    ratio = {name: [a / b for a, b in zip(rates[name], rates["none"])]
             for name in ("records", "log_dir")}
    print(f"cli (d): fit steps/s in turns of {CLI_RATE_STEPS} (a record every "
          f"{CLI_LOG_EVERY} steps): no stream {[round(r, 2) for r in rates['none']]}, "
          f"records without log_dir {[round(r, 2) for r in rates['records']]}, log_dir and "
          f"heartbeat {[round(r, 2) for r in rates['log_dir']]}; over no stream, turn by "
          f"turn: records {[round(r, 3) for r in ratio['records']]}, log_dir "
          f"{[round(r, 3) for r in ratio['log_dir']]}; a log tick (log_dir) takes "
          f"{tick_us:.1f} us of the training thread and {len(syncs)} synchronizing calls "
          f"there, a record {emit_us:.1f} us of the drain thread ({len(emit_s)} records; "
          f"a write by sink, us: { {k: round(v, 1) for k, v in sink_us.items()} }), a flush "
          f"of the sinks {flush_us:.1f} us ({len(flush_s)} flushes); "
          f"the FLOP count ({flops:.0f}) takes {count_ms:.1f} ms once [{card}]")
    return {"trainer": live, "summary": {"steps_per_s": rates, "over_none": ratio,
                                         "log_tick_syncs": syncs, "log_tick_us": tick_us,
                                         "record_drain_us": emit_us, "sink_write_us": sink_us,
                                         "sink_flush_us": flush_us,
                                         "flops_count_ms": count_ms}}


def command_line_phase(torch, card: str) -> dict:
    """Phase 15: the command line. (a) ``--dry-run`` in-process; (b) ``python
    -m mercury_tpu_torch --dry-run``; (c) a fit with ``--log-dir``; (d) the
    fit's rate with and without the metric stream; (e)
    ``timing_breakdown``; (f) ``torchrun`` with ``--distributed`` over NCCL;
    (g) ``trace`` around 3 steps."""
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.profile import timing_breakdown, trace

    out = {"card": card}
    dry = cli_dry_run(torch, mk, card)
    out["dry_run"] = {k: dry[k] for k in ("loss", "kernel_vs_plain")}
    launches = dict(dry["launches"])
    sub = cli_subprocess([sys.executable, "-m", "mercury_tpu_torch", *CLI_ARGS, "--dry-run"])
    out["module"] = {"seconds": sub["seconds"], "loss": sub["metrics"]["train/loss"]}
    print(f"cli (b): python -m mercury_tpu_torch --dry-run: exit 0 in {sub['seconds']:.1f} s, "
          f"train/loss {sub['metrics']['train/loss']:.4f} [{card}]")
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as directory:
        fit = cli_fit(torch, mk, card, directory)
        for k, v in fit["launches"].items():
            launches[k] += v
        out["fit"] = fit
        rates = cli_rates(torch, mk, card, directory)
        out["rates"] = rates["summary"]
        trainer = rates["trainer"]
        seg = timing_breakdown(trainer, iters=10)
        out["timing_breakdown_ms"] = {k: v * 1e3 for k, v in seg.items()}
        print("cli (e): timing_breakdown (ms, median of 10): "
              + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in seg.items()) + f" [{card}]")
        with trace(directory):
            for _ in range(3):
                trainer.train_step()
            torch.cuda.synchronize()
        text = (Path(directory) / "trace.json").read_text()
        names = {k: text.count(k) for k in ("nll_fwd_kernel", "select_kernel",
                                            "nll_bwd_kernel")}
        check(names["nll_fwd_kernel"] > 0 and names["select_kernel"] > 0,
              f"trace: kernel names {names}")
        out["trace"] = {"bytes": len(text), "names": names}
        print(f"cli (g): trace of 3 steps, {len(text)} bytes of Chrome trace, kernel "
              f"names {names} [{card}]")
        trainer.close()
        del trainer, rates
        torch.cuda.empty_cache()
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    run = cli_subprocess([sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
                          "--nproc_per_node=1", "--master_addr=127.0.0.1",
                          f"--master_port={port}", "-m", "mercury_tpu_torch",
                          "--distributed", *CLI_ARGS, "--dry-run"])
    out["torchrun"] = {"seconds": run["seconds"], "loss": run["metrics"]["train/loss"]}
    print(f"cli (f): torchrun --nproc_per_node=1 -m mercury_tpu_torch --distributed "
          f"--dry-run over NCCL: exit 0 in {run['seconds']:.1f} s, train/loss "
          f"{run['metrics']['train/loss']:.4f} [{card}]")
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 16
def counted(mk, total: dict, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after, added into ``total``; returns ``fn()``'s result and the counts."""
    mk.reset_launch_counts()
    out = fn()
    counts = dict(mk.launch_counts)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return out, counts


def eval_launches(trainer) -> int:
    """The ``nll_fwd`` launches of one ``evaluate()``: one a batch of the
    train and the test split."""
    from mercury_tpu_torch.data.pipeline import eval_batches
    from mercury_tpu_torch.train.trainer import EVAL_BATCH

    ds = trainer.dataset
    return (len(eval_batches(int(ds.x_train.shape[0]), EVAL_BATCH))
            + len(eval_batches(int(ds.x_test.shape[0]), EVAL_BATCH)))


def fit_launches(trainer, steps: int, per_step: dict) -> dict:
    """What a ``fit`` of ``steps`` steps ending in one ``evaluate()``
    launches."""
    want = {k: v * steps for k, v in per_step.items()}
    want["nll_fwd"] += eval_launches(trainer)
    return want


class KeptMessages:
    """A logging handler that keeps each record's message."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.messages.append(record.getMessage())

        self.messages = []
        self.handler = Handler()


def durable_fit(torch, mk, card: str, directory: str, per_step: dict, total: dict) -> dict:
    """(a) ``fit`` with manifests: a save every ``DURABLE_EVERY`` steps,
    each timed (blocking, serialize and write, digests); a verified restore
    timed; saves of the same state with and without the manifest, in
    turns."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.train import checkpoint

    config = TrainConfig(**DURABLE, checkpoint_dir=directory, checkpoint_every=DURABLE_EVERY)
    check(config.checkpoint_manifest and config.checkpoint_verify and config.checkpoint_keep == 3,
          f"unexpected durability defaults {config}")
    trainer = build_trainer(torch, config, quiet=True)
    saves = []
    save = trainer.save

    def timed_save(directory=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(directory)
        ms = (time.perf_counter() - t0) * 1e3
        t = checkpoint.timings()
        saves.append({"blocking_ms": ms, "write_ms": t["write_s"] * 1e3,
                      "digest_ms": t["digest_s"] * 1e3})
        return path

    trainer.save = timed_save
    _, counts = counted(mk, total, lambda: trainer.fit(steps=DURABLE_FIT))
    want = fit_launches(trainer, DURABLE_FIT, per_step)
    check(counts == want, f"durable fit: launch counts {counts}, expected {want}")
    steps = checkpoint.all_steps(directory)
    check(steps == [8, 16, 24] and len(saves) == 3, f"durable fit: saved {steps}, {len(saves)} "
          "saves timed")
    path = checkpoint.checkpoint_path(directory, DURABLE_FIT)
    nbytes = os.path.getsize(path)
    doc = json.loads(Path(checkpoint.manifest_path(path)).read_text())
    check(doc["bytes"] == nbytes and doc["step"] == DURABLE_FIT,
          f"manifest of {path}: {doc['bytes']} bytes, step {doc['step']}")
    fresh = build_trainer(torch, config, quiet=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(fresh.restore() == DURABLE_FIT, "restore of the newest file")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    t = checkpoint.timings()
    verify = {"restore_ms": restore_ms, "read_ms": t["read_s"] * 1e3,
              "verify_ms": t["verify_s"] * 1e3, "load_ms": t["load_s"] * 1e3}
    saved, restored = carried_digests(trainer.state), carried_digests(fresh.state)
    differ = sorted(k for k, v in saved.items() if restored.get(k) != v)
    check(saved.keys() == restored.keys() and not differ,
          f"verified restore differs from the saved state: {differ[:5]}")
    turns = {"manifest": [], "plain": []}
    side = os.path.join(directory, "turns")
    for name in ("manifest", "plain", "plain", "manifest"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(side, trainer.state, config, manifest=name == "manifest")
        turns[name].append((time.perf_counter() - t0) * 1e3)
    print(f"durable (a): fit of {DURABLE_FIT} steps saving every {DURABLE_EVERY}: "
          f"{nbytes} bytes a file, {len(doc['tensors'])} tensor digests; save ms (blocking / "
          f"serialize+write+fsync / sha256 of the file and of each tensor) "
          + "; ".join(f"{s['blocking_ms']:.1f} / {s['write_ms']:.1f} / {s['digest_ms']:.1f}"
                      for s in saves)
          + f"; verified restore {restore_ms:.1f} ms (read {verify['read_ms']:.1f}, verify "
          f"{verify['verify_ms']:.1f}, load {verify['load_ms']:.1f}); save ms in turns with the "
          f"manifest {[round(v, 1) for v in turns['manifest']]}, without "
          f"{[round(v, 1) for v in turns['plain']]} [{card}]")
    shutil.rmtree(side, ignore_errors=True)
    fresh.close()
    return {"trainer": trainer, "config": config,
            "summary": {"file_bytes": nbytes, "tensors": len(doc["tensors"]), "saves": saves,
                        "restore": verify, "save_ms_turns": turns}}


def durable_rates(torch, mk, card: str, root: str, per_step: dict, total: dict) -> dict:
    """(b) ``RATE_FIT``-step fits saving every ``RATE_EVERY``, sync and
    async in turns: the training thread's blocking ms a save, steps/s of
    the fit (saves included, the closing evaluation not), steps/s of the
    steps taken while a write was in flight and of the others, and the
    files of the two kinds compared by their tensors' sha256."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.train import checkpoint

    out = {"sync": [], "async": []}
    manifests = {}
    for turn, name in enumerate(RATE_TURNS):
        directory = os.path.join(root, f"rate_{turn}_{name}")
        config = TrainConfig(**DURABLE, checkpoint_dir=directory, checkpoint_every=RATE_EVERY,
                             async_checkpoint=name == "async")
        trainer = build_trainer(torch, config, quiet=True)
        blocking, step_s, eval_s = [], [], []
        step, evaluate, save = trainer.train_step, trainer.evaluate, trainer.save
        join, save_async = trainer._join_checkpoint, checkpoint.save_checkpoint_async

        def timed(fn, into):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    into.append(time.perf_counter() - t0)
            return wrapped

        def timed_step(*args, **kwargs):
            flight = trainer._ckpt_thread
            in_flight = flight is not None and not flight.done()
            t0 = time.perf_counter()
            metrics = step(*args, **kwargs)
            step_s.append((time.perf_counter() - t0, in_flight))
            return metrics

        joins, async_calls = [], []
        trainer.train_step, trainer.evaluate = timed_step, timed(evaluate, eval_s)
        trainer.save = timed(save, blocking)
        trainer._join_checkpoint = timed(join, joins)
        checkpoint.save_checkpoint_async = timed(save_async, async_calls)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, counts = counted(mk, total, lambda: trainer.fit(steps=RATE_FIT))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            checkpoint.save_checkpoint_async = save_async
        want = fit_launches(trainer, RATE_FIT, per_step)
        check(counts == want, f"durable (b) {name}: launch counts {counts}, expected {want}")
        saves = RATE_FIT // RATE_EVERY
        if name == "async":
            check(len(async_calls) == saves and not blocking,
                  f"durable (b) async: {len(async_calls)} async saves, {len(blocking)} sync")
            # A save blocks for its host copy, and for the previous write
            # when that is still in flight at the next save; fit's end
            # waits for the last write.
            per_save = [(a + j) * 1e3 for a, j in zip(async_calls, joins)]
            final_join_ms = sum(joins[saves:]) * 1e3
        else:
            check(len(blocking) == saves and not async_calls,
                  f"durable (b) sync: {len(blocking)} saves, {len(async_calls)} async")
            per_save = [b * 1e3 for b in blocking]
            final_join_ms = 0.0
        flying = [s for s, f in step_s if f]
        grounded = [s for s, f in step_s if not f]
        out[name].append({
            "blocking_ms": per_save, "final_join_ms": final_join_ms,
            "steps_per_s": RATE_FIT / (wall - sum(eval_s)),
            "steps_in_flight": len(flying),
            "in_flight_steps_per_s": len(flying) / sum(flying) if flying else None,
            "other_steps_per_s": len(grounded) / sum(grounded)})
        steps = checkpoint.all_steps(directory)
        check(steps == [20, 30, 40], f"durable (b) {name}: files {steps}")
        manifests.setdefault(name, {s: json.loads(Path(checkpoint.manifest_path(
            checkpoint.checkpoint_path(directory, s))).read_text())["tensors"] for s in steps})
        trainer.close()
        del trainer
        shutil.rmtree(directory, ignore_errors=True)
    differ = {s: sorted(k for k, v in manifests["sync"][s].items()
                        if manifests["async"][s].get(k) != v) for s in manifests["sync"]}
    check(all(manifests["async"][s].keys() == manifests["sync"][s].keys() for s in differ)
          and not any(differ.values()),
          f"durable (b): async files differ from sync files: { {s: d[:3] for s, d in differ.items()} }")
    for name in ("sync", "async"):
        print(f"durable (b) {name}: blocking ms a save "
              f"{[[round(v, 1) for v in t['blocking_ms']] for t in out[name]]}; steps/s "
              f"{[round(t['steps_per_s'], 2) for t in out[name]]}; steps/s with a write in "
              f"flight {[t['in_flight_steps_per_s'] and round(t['in_flight_steps_per_s'], 2) for t in out[name]]} "
              f"({[t['steps_in_flight'] for t in out[name]]} steps), without "
              f"{[round(t['other_steps_per_s'], 2) for t in out[name]]}; fit's closing wait "
              f"for the last write, ms {[round(t['final_join_ms'], 1) for t in out[name]]} "
              f"[{card}]")
    print(f"durable (b): the async files at steps 20, 30, 40 equal the sync files, "
          f"{len(manifests['sync'][40])} tensors by sha256")
    return out


def durable_flip(torch, mk, card: str, fit: dict, total: dict) -> dict:
    """(c) One byte of the newest file flipped: a fresh ``auto_resume``
    Trainer lands on the older step, naming the failed check, and
    ``FLIP_RUN`` steps from there are bit-equal to a run restored
    explicitly from that step. Then the same pair under the default cuDNN
    settings, read and not checked."""
    from mercury_tpu_torch.train import checkpoint

    config = fit["config"]
    directory = config.checkpoint_dir
    path = checkpoint.checkpoint_path(directory, DURABLE_FIT)
    blob = bytearray(Path(path).read_bytes())
    blob[len(blob) // 2] ^= 0x01
    Path(path).write_bytes(bytes(blob))
    kept = KeptMessages()
    checkpoint._log.addHandler(kept.handler)
    try:
        walked = build_trainer(torch, config.replace(auto_resume=True), quiet=True)
    finally:
        checkpoint._log.removeHandler(kept.handler)
    older = DURABLE_FIT - DURABLE_EVERY
    check(walked.state.step == older, f"auto_resume landed on step {walked.state.step}, "
          f"not {older}")
    named = [m for m in kept.messages if f"ckpt_{DURABLE_FIT}.pt" in m and "sha256 mismatch" in m]
    check(bool(named), f"the fallback's warning does not name the failed check: {kept.messages}")
    explicit = build_trainer(torch, config, quiet=True)
    check(explicit.restore(step=older) == older, "explicit restore")

    def run(trainer):
        losses = torch.stack([trainer.train_step()["train/loss"] for _ in range(FLIP_RUN)])
        torch.cuda.synchronize()
        return losses.cpu(), carried_digests(trainer.state)

    (la, da), _ = counted(mk, total, lambda: run(walked))
    (lb, db), _ = counted(mk, total, lambda: run(explicit))
    differ = sorted(k for k in da if db.get(k) != da[k])
    check(torch.equal(la, lb) and not differ,
          f"fallback run vs explicit restore: losses {la.tolist()} {lb.tolist()}, differ {differ[:5]}")
    walked.close()
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = False, False   # PyTorch's defaults
    pair = []
    try:
        for _ in range(2):
            explicit.restore(step=older)
            (losses, digests), _ = counted(mk, total, lambda: run(explicit))
            pair.append((losses, digests))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        explicit.close()
    default_equal = (torch.equal(pair[0][0], pair[1][0])
                     and all(pair[1][1].get(k) == v for k, v in pair[0][1].items()))
    default_differ = sum(pair[1][1].get(k) != v for k, v in pair[0][1].items())
    print(f"durable (c): byte {len(blob) // 2} of ckpt_{DURABLE_FIT}.pt flipped; auto_resume "
          f"fell back to step {older} ({named[0][:100]}…); {FLIP_RUN} steps from there bit-equal "
          f"to an explicit restore of step {older} ({len(da)} tensors and counters, losses "
          f"{la.tolist()}); under cuDNN's default settings two runs restored from step {older} "
          f"are {'bit-equal' if default_equal else 'not bit-equal'} after {FLIP_RUN} steps "
          f"({default_differ} of {len(pair[0][1])} digests differ) [{card}]")
    return {"fell_back_to": older, "warning": named[0], "tensors_and_counters": len(da),
            "default_cudnn_bit_equal": default_equal, "default_cudnn_differ": default_differ}


def durable_faults(torch, mk, card: str, root: str, per_step: dict, total: dict) -> dict:
    """(d) ``ckpt_io_error@step=16`` with two retries: every save lands and
    the record after the failed attempt shows one more write failure;
    ``every=1`` without retries: ``fit`` raises ``OSError`` and leaves no
    ``.tmp``."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.train import checkpoint

    directory = os.path.join(root, "faults")
    config = TrainConfig(**{**DURABLE, "log_every": DURABLE_EVERY}, checkpoint_dir=directory,
                         checkpoint_every=DURABLE_EVERY, checkpoint_write_retries=2,
                         fault_spec="ckpt_io_error@step=16")
    trainer = build_trainer(torch, config, quiet=True)
    records = []
    trainer.logger.add_observer(lambda r: records.append(dict(r)))
    before = checkpoint.write_failures()
    steps = DURABLE_FIT + DURABLE_EVERY
    _, counts = counted(mk, total, lambda: trainer.fit(steps=steps))
    want = fit_launches(trainer, steps, per_step)
    check(counts == want, f"durable (d): launch counts {counts}, expected {want}")
    trainer.logger.flush()
    failures = {int(r["step"]): r["checkpoint/write_failures"] - before for r in records}
    check(failures == {8: 0, 16: 0, 24: 0, 32: 1},
          f"durable (d): write failures by record {failures}, expected one after step 24's save")
    check(checkpoint.all_steps(directory) == [16, 24, 32]
          and trainer._faults.stats() == {"fault/injected": 1.0, "fault/armed": 0.0},
          f"durable (d): files {checkpoint.all_steps(directory)}, {trainer._faults.stats()}")
    trainer.close()
    directory = os.path.join(root, "faults_every")
    config = config.replace(checkpoint_dir=directory, checkpoint_every=2,
                            checkpoint_write_retries=0, fault_spec="ckpt_io_error@step=0,every=1")
    trainer = build_trainer(torch, config, quiet=True)
    before = checkpoint.write_failures()
    try:
        trainer.fit(steps=4)
    except OSError as exc:
        raised = f"{type(exc).__name__}: {exc}"
    else:
        raise SmokeFailure("durable (d): fit with every checkpoint write failing did not raise")
    left = sorted(os.listdir(directory)) if os.path.isdir(directory) else []
    check("ckpt_io_error" in raised and not left and trainer.state.step == 2
          and checkpoint.write_failures() == before + 1,
          f"durable (d): raised {raised!r} at step {trainer.state.step}, left {left}")
    trainer.close()
    print(f"durable (d): ckpt_io_error@step=16 with 2 retries fired at step 24's save (the "
          f"clock reads 23 there), the write landed at its 2nd attempt and the step-32 record "
          f"shows 1 write failure; every=1 without retries: fit raised {raised!r} at step 2, "
          f"nothing left in the directory [{card}]")
    return {"failures_by_record": failures, "raised": raised}


def durable_elastic(torch, mk, card: str, root: str, pool_step: dict, table_step: dict,
                    total: dict) -> dict:
    """(e) Shrink: a W=2 ZeRO pool run (two gloo ranks on the card) saves
    at step ``ELASTIC_AT``; a W=1 ZeRO Trainer restores it elastically (its
    moments equal the ranks' chunks concatenated), then ``ELASTIC_RUN``
    steps with their launches, and a kernel step against a plain step.
    Grow: a W=1 scoretable + fused run saves at ``ELASTIC_AT``; the two
    ranks restore it (each rank's table held to a plain recomputation),
    then ``GROW_RUN`` steps a rank with their launches and a kernel step
    against a plain step on each."""
    import numpy as np

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.parallel.distributed import spawn
    from mercury_tpu_torch.train import checkpoint

    shrink_dir, grow_dir = os.path.join(root, "shrink"), os.path.join(root, "grow")
    source = build_trainer(torch, TrainConfig(**SCORETABLE), quiet=True)
    counted(mk, total, lambda: [source.train_step() for _ in range(ELASTIC_AT)])
    source.save(grow_dir)
    shard = source.dataset.shard_indices[0].cpu().numpy()
    source.close()
    del source
    ranks = spawn(elastic_body, TWO_RANKS, "gloo", table_step, shrink_dir, grow_dir, shard,
                  devices=[0] * TWO_RANKS, timeout_s=600)
    for r in ranks:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    config = TrainConfig(**{**DURABLE, "zero_sharding": True})
    trainer = build_trainer(torch, config, quiet=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(trainer.restore_elastic(shrink_dir) == ELASTIC_AT, "shrink: restored step")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    raw = torch.load(checkpoint.checkpoint_path(shrink_dir, ELASTIC_AT), weights_only=True)
    n = sum(p.numel() for p in trainer.state.model.parameters())
    st = trainer.state.optimizer.state_dict()["state"][0]
    for key in ("exp_avg", "exp_avg_sq"):
        want = torch.cat([row["optimizer"]["state"][0][key] for row in raw["ranks"]])[:n]
        check(torch.equal(st[key].cpu(), want), f"shrink: {key} is not the ranks' chunks "
              "concatenated")
    check(all(torch.equal(v.cpu(), raw["model"][k])
              for k, v in trainer.state.model.state_dict().items()),
          "shrink: the model differs from the checkpoint's")
    _, counts = counted(mk, total, lambda: [trainer.train_step() for _ in range(ELASTIC_RUN)])
    want = {k: v * ELASTIC_RUN for k, v in pool_step.items()}
    check(counts == want, f"shrink: launch counts {counts}, expected {want}")
    step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    for r in ranks:
        e = r["kernel_vs_plain"]
        print(f"durable (e) grow, rank {r['rank']}: W=1 scoretable file restored at W=2 in "
              f"{r['restore_ms']:.1f} ms, the table over this rank's {r['table_len']} slots "
              f"equal to the plain repartition; {GROW_RUN} steps launching "
              f"{r['window_launches']}, "
              f"losses {[round(v, 4) for v in r['losses']]}; kernel step vs plain step "
              f"|d loss| {e['train/loss']:.2e} [{card}]")
    print(f"durable (e) shrink: W=2 ZeRO file restored at W=1 in {restore_ms:.1f} ms, Adam "
          f"moments equal to the 2 chunks concatenated ({n} elements); {ELASTIC_RUN} steps "
          f"launching {counts}; kernel step vs plain step |d loss| {step_err['train/loss']:.2e}, "
          f"|d pool_loss| {step_err['train/pool_loss']:.2e} [{card}]")
    return {"shrink": {"restore_ms": restore_ms, "launches": counts, "kernel_vs_plain": step_err},
            "grow": [{k: r[k] for k in ("rank", "restore_ms", "table_len", "window_launches",
                                        "losses", "kernel_vs_plain")} for r in ranks]}


def elastic_body(table_step, shrink_dir, grow_dir, shard_w1):
    """One rank of phase 16 (e) (run by ``spawn``; prints nothing): a W=2
    ZeRO pool run of ``ELASTIC_AT`` steps saved into ``shrink_dir``; then a
    W=2 scoretable + fused Trainer restoring the W=1 file in ``grow_dir``,
    its table held to the plain repartition (``shard_w1``: the W=1 run's
    shard), ``GROW_RUN`` steps with their launches and a kernel step
    against a plain step."""
    import numpy as np
    import torch

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.collectives import allreduce_sum
    from mercury_tpu_torch.train import checkpoint

    launches = {}
    zero = build_trainer(torch, TrainConfig(**{**DURABLE, "zero_sharding": True,
                                                "world_size": TWO_RANKS}), quiet=True)
    counted(mk, launches, lambda: [zero.train_step() for _ in range(ELASTIC_AT)])
    zero.save(shrink_dir)
    zero.close()
    del zero
    config = TrainConfig(**{**SCORETABLE, "world_size": TWO_RANKS})
    trainer = build_trainer(torch, config, quiet=True)
    rank = trainer.rank
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(trainer.restore_elastic(grow_dir) == ELASTIC_AT, f"rank {rank}: grow step")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    row = torch.load(checkpoint.checkpoint_path(grow_dir, ELASTIC_AT),
                     weights_only=True)["ranks"][0]
    plain = np.full(int(trainer.dataset.y_train.numel()), float(row["ema_value"]), np.float32)
    plain[shard_w1] = row["table"].numpy()
    want = plain[trainer.dataset.shard_indices[rank].cpu().numpy()]
    got = trainer.state.scoretable.scores.cpu().numpy()
    check(np.array_equal(got, want), f"rank {rank}: the grown table is not the plain repartition")
    (losses, counts) = counted(mk, launches, lambda: torch.stack(
        [trainer.train_step()["train/loss"] for _ in range(GROW_RUN)]).cpu())
    want_counts = {k: v * GROW_RUN for k, v in table_step.items()}
    check(counts == want_counts, f"rank {rank}: grow launch counts {counts}, expected "
          f"{want_counts}")
    check(bool(torch.isfinite(losses).all()), f"rank {rank}: losses {losses.tolist()}")

    def any_rank(flag: bool) -> bool:
        return bool(allreduce_sum(torch.tensor(float(flag), device=trainer.device)) > 0)

    step_err = kernel_vs_plain_step(torch, trainer, config, any_rank=any_rank, quiet=True)
    torch.cuda.synchronize()
    trainer.close()
    return {"rank": rank, "restore_ms": restore_ms, "table_len": int(got.size),
            "launches": launches, "window_launches": counts, "losses": losses.tolist(),
            "kernel_vs_plain": step_err}


def durable_stream(torch, mk, card: str, per_step: dict, total: dict) -> dict:
    """(f) The host stream with ``prefetch_stall@step=5,secs=0.5``: the
    stalled run's state bit-equal to a run without, and the stall counted;
    ``prefetch_die`` raises at the next ``pop`` naming itself."""
    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**{**DURABLE, "data_placement": "host_stream"})
    runs = {}
    for name, spec in (("plain", ""), ("stalled", STALL)):
        trainer = build_trainer(torch, config.replace(fault_spec=spec), quiet=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, counts = counted(mk, total, lambda: trainer.fit(steps=STALL_STEPS))
        torch.cuda.synchronize()
        want = fit_launches(trainer, STALL_STEPS, per_step)
        check(counts == want, f"durable (f) {name}: launch counts {counts}, expected {want}")
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "digests": carried_digests(trainer.state),
                      "wait_s": trainer._stream_pipe.summary()["total_wait_s"],
                      "faults": None if trainer._faults is None else trainer._faults.stats()}
        trainer.close()
    differ = sorted(k for k, v in runs["plain"]["digests"].items()
                    if runs["stalled"]["digests"].get(k) != v)
    check(not differ, f"durable (f): the stalled run differs: {differ[:5]}")
    # The stall precedes the gather, so the pops wait for it.
    extra = runs["stalled"]["wait_s"] - runs["plain"]["wait_s"]
    check(runs["stalled"]["faults"] == {"fault/injected": 1.0, "fault/armed": 0.0}
          and extra >= 0.3,
          f"durable (f): the pops waited {extra:.3f} s more, {runs['stalled']['faults']}")
    trainer = build_trainer(torch, config.replace(fault_spec="prefetch_die@step=3"), quiet=True)
    try:
        trainer.fit(steps=8)
    except RuntimeError as exc:
        raised = str(exc)
    else:
        raise SmokeFailure("durable (f): prefetch_die did not raise")
    finally:
        trainer.close()
    check("prefetch worker died" in raised and "prefetch_die" in raised,
          f"durable (f): the death does not name the fault: {raised[:200]}")
    print(f"durable (f): host stream, {STALL}: {STALL_STEPS} steps bit-equal to a run "
          f"without ({len(runs['plain']['digests'])} digests), pops waited "
          f"{runs['stalled']['wait_s']:.3f} s against {runs['plain']['wait_s']:.3f} s, fit "
          f"{runs['stalled']['seconds']:.2f} s "
          f"against {runs['plain']['seconds']:.2f} s; prefetch_die@step=3: fit raised "
          f"'prefetch worker died' naming prefetch_die [{card}]")
    return {k: {"seconds": v["seconds"], "wait_s": v["wait_s"]} for k, v in runs.items()}


def durable_phase(torch, card: str, main_path, table_path) -> dict:
    """Phase 16: durable checkpoints, elastic restore and the fault plane
    on the main path's config at full width, under deterministic cuDNN
    (the previous settings restored after): (a) a fit with manifests, (b)
    async against sync in turns, (c) a flipped byte, (d) write faults, (e)
    elastic restore across world sizes, (f) prefetch faults."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    pool_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    table_step = {k: v // MAIN_STEPS for k, v in table_path["launches"].items()}
    total = {k: 0 for k in mk.KERNELS}
    undo = deterministic_cudnn(torch)
    root = tempfile.mkdtemp(prefix="mercury_durable_")
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        fit = part("a", durable_fit, torch, mk, card, os.path.join(root, "fit"), pool_step,
                   total)
        rates = part("b", durable_rates, torch, mk, card, root, pool_step, total)
        flip = part("c", durable_flip, torch, mk, card, fit, total)
        fit["trainer"].close()
        faults = part("d", durable_faults, torch, mk, card, root, pool_step, total)
        elastic = part("e", durable_elastic, torch, mk, card, root, pool_step, table_step,
                       total)
        stream = part("f", durable_stream, torch, mk, card, pool_step, total)
    finally:
        undo()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    print("durable: seconds by part " + ", ".join(f"({k}) {v:.1f}" for k, v in seconds.items()))
    return {"launches": total,
            "summary": {"card": card, "fit": fit["summary"], "rates": rates, "flip": flip,
                        "faults": faults, "elastic": elastic, "stream": stream,
                        "launches": total, "seconds": seconds}}


# ------------------------------------------------------------------ phase 17
def fleet_delta(fleet, before: dict) -> dict:
    return {k: fleet.launch_counts[k] - before[k] for k in before}


def timed_fit(torch, trainer, steps: int) -> dict:
    """``fit(steps=...)`` with its final evaluation timed apart (the rate
    leaves it out), and the supervisor's ticks timed on the host."""
    evals, ticks = [], []
    evaluate, sup = trainer.evaluate, trainer.supervisor

    def timed_evaluate(*a, **kw):
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        evals.append(time.perf_counter() - t0)
        return out

    trainer.evaluate = timed_evaluate
    if sup is not None:
        tick = sup.tick

        def timed_tick(step):
            t0 = time.perf_counter()
            tick(step)
            ticks.append(time.perf_counter() - t0)

        sup.tick = timed_tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = trainer.fit(steps=steps)
    finally:
        del trainer.evaluate
        if sup is not None:
            del sup.tick
    wall = time.perf_counter() - t0 - sum(evals)
    return {"out": out, "steps_per_s": steps / wall, "us_per_step": wall / steps * 1e6,
            "tick_us": (statistics.mean(ticks) * 1e6) if ticks else None}


def async_step_vs_plain(torch, mk, trainer, what: str) -> dict:
    """One async step from the trainer's state and draws, kernels against
    the plain route (``table_refresh_draw`` with the sentinel window,
    ``nll_fwd``, ``nll_bwd``, ``augment_normalize`` against the plain
    versions): the same slots, the loss to rtol 1e-4, the telemetry. The
    state is left as it was."""
    from mercury_tpu_torch.train.step import make_draws

    state = trainer.state
    for _ in range(3):
        draws = make_draws(state.clone(), trainer.config)
        runs = {}
        for use_kernels in (True, False):
            s = state.clone()
            mk.reset_launch_counts()
            m = trainer._step_fn(s, draws, use_kernels)
            runs[use_kernels] = (m, s, dict(mk.launch_counts))
        (k_m, k_s, k_c), (p_m, p_s, p_c) = runs[True], runs[False]
        _, _, differ = check_draws(torch, f"{what}: kernel step vs plain step",
                                   p_m["sampler/probs"], draws.uniforms.reshape(-1),
                                   k_m["sampler/selected"], p_m["sampler/selected"])
        if not bool(differ.any()):
            break
    else:
        raise SmokeFailure(f"{what}: kernel and plain steps drew different batches in 3 tries")
    check(k_c["table_refresh_draw"] == 1 and k_c["nll_fwd"] == 1
          and k_c["nll_bwd"] == 1 and k_c["augment_normalize"] == 1
          and sum(p_c.values()) == 0, f"{what}: launches kernels {k_c}, plain {p_c}")
    loss_err = abs(float(k_m["train/loss"]) - float(p_m["train/loss"]))
    check(loss_err <= 1e-4 * abs(float(p_m["train/loss"])),
          f"{what}: losses {float(k_m['train/loss'])!r}, {float(p_m['train/loss'])!r}")
    tel = telemetry_agree(torch, k_m, p_m, p_s.scoretable.scores)
    return {"loss_err": loss_err, "telemetry": tel}


def flat_table_draw(torch, mk, trainer) -> dict:
    """The level-3 draw: ``table_refresh_draw`` on the flattened table with
    the sentinel window, the kernel against its plain version from the
    same uniforms: the same slots, p = 1/L for every slot, weights 1."""
    from mercury_tpu_torch.ops import reference

    config, state, dev = trainer.config, trainer.state, trainer.device
    table, ema = state.scoretable.scores, state.ema.value
    n = table.numel()
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {"L": n, "same_slots": True}
    for _ in range(4):
        u = torch.rand(config.batch_size, generator=gen, device=dev)
        sent = ema + (table[:1] - ema) * config.table_decay
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        k = mk.table_refresh_draw_kernel(table, zero, sent, ema, u, config.is_alpha,
                                         config.table_decay)
        p = reference.table_refresh_draw(table, zero, sent, ema, u, config.is_alpha,
                                         config.table_decay)
        check(torch.equal(k[2].long(), p[2].long()),
              f"level 3: kernel slots {k[2].tolist()}, plain {p[2].tolist()}")
        flat = torch.full_like(k[1], 1.0 / n)
        out["probs_err"] = max(out.get("probs_err", 0.0),
                               within(k[1], flat, rtol=1e-6, atol=0.0),
                               within(p[1], flat, rtol=1e-6, atol=0.0))
        ones = torch.ones_like(k[3])
        out["weights_err"] = max(out.get("weights_err", 0.0),
                                 within(k[3], ones, rtol=1e-6, atol=0.0),
                                 within(p[3], ones, rtol=1e-6, atol=0.0))
    return out


def score_once_vs_plain(torch, trainer) -> float:
    """A chunk scored on the training thread (the sync level's and the
    probes' path: the fleet's ``nll_fwd``) against the same window,
    augmentation and parameters through the live model and the plain NLL;
    the fleet's workers stopped first."""
    from mercury_tpu_torch.data.pipeline import normalize_images
    from mercury_tpu_torch.ops import reference
    from mercury_tpu_torch.sampling.scorer_fleet import chunk_seed
    from mercury_tpu_torch.train.step import augment_images, draw_augment, scoring_forward

    config, ds, state = trainer.config, trainer.dataset, trainer.state
    fleet = trainer._scorer_fleet
    fleet.close()
    fleet.snapshot(state.model, state.step)
    chunk_id, start = fleet._chunk_seq, fleet._cursor
    before = fleet.launch_counts["nll_fwd"]
    chunk = fleet.score_once()
    check(fleet.launch_counts["nll_fwd"] - before == 1, "score_once launched no nll_fwd")
    slots = (start + torch.arange(config.refresh_size, device=trainer.device)) % ds.shard_len
    gidx = ds.shard_indices[ds.rank][slots]
    gen = torch.Generator(device=trainer.device).manual_seed(chunk_seed(config.seed, chunk_id))
    images = augment_images(normalize_images(ds.x_train[gidx], ds.mean, ds.std),
                            draw_augment(gen, config.refresh_size, config), config)
    with torch.no_grad():
        want = reference.nll_forward(scoring_forward(state.model, images, config).float(),
                                     ds.y_train[gidx])
    return within(chunk.scores, want.cpu(), rtol=1e-3, atol=1e-3)


def read_events(directory: str) -> list:
    from mercury_tpu_torch.obs.events import read_journal

    return read_journal(os.path.join(directory, "events.h0.jsonl"))


def supervised_restart(torch, mk, card: str, root: str, step_launches: dict,
                       total: dict) -> dict:
    """(a) A one-shot ``scorer_die@step=5``: the fleet restarted once
    (``-r1``), level 0, green; with ``anomaly_inject_nan_step=10`` the
    non_finite flight record (e). Then unsupervised, supervised and
    supervised without the journal fits in turns: steps/s and the tick's
    host µs."""
    from mercury_tpu_torch import TrainConfig

    directory = os.path.join(root, "a")
    config = TrainConfig(**SUPERVISED, fault_spec="scorer_die@step=5", log_dir=directory,
                         anomaly_inject_nan_step=10)
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    fleet = trainer._scorer_fleet
    f0 = dict(fleet.launch_counts)
    _, counts = counted(mk, total, lambda: trainer.fit(steps=SUP_FIT))
    torch.cuda.synchronize()
    fl = fleet_delta(fleet, f0)
    for k, v in fl.items():
        total[k] += v
    want = fit_launches(trainer, SUP_FIT, step_launches)
    check(counts == want, f"supervised (a): step launches {counts}, expected {want}")
    check(fl["nll_fwd"] >= 1 and sum(fl.values()) == fl["nll_fwd"],
          f"supervised (a): fleet launches {fl}")
    summ, stats = fleet.summary(), trainer.supervisor.stats()
    names = [t.name for t in fleet._threads]
    check(summ["restarts"] == 1 and names == ["mercury-scorer-0-r1"] and fleet.alive()
          and stats["supervisor/restarts"] == 1.0 and stats["supervisor/level"] == 0.0,
          f"supervised (a): fleet {summ}, threads {names}, supervisor {stats}")
    kvp = async_step_vs_plain(torch, mk, trainer, "supervised (a)")
    trainer.close()
    flights = sorted(n for n in os.listdir(directory) if n.startswith("flight_record_"))
    check("flight_record_step10_non_finite.json" in flights,
          f"supervised (e): no non_finite flight record in {flights}")
    doc = json.load(open(os.path.join(directory, "flight_record_step10_non_finite.json")))
    mem = doc["device_memory"]
    check(doc["trigger"]["kind"] == "non_finite" and "cuda:0" in mem
          and mem["cuda:0"].get("allocated_bytes.all.current", 0) > 0,
          f"supervised (e): flight record trigger {doc['trigger']}, memory keys {list(mem)}")
    rows = read_events(directory)
    kinds = [r["kind"] for r in rows]
    check(kinds.count("supervisor/restart") == 1 and "fault/fired" in kinds,
          f"supervised (a): journal kinds {kinds}")
    restart = rows[kinds.index("supervisor/restart")]
    fired = rows[kinds.index("fault/fired")]
    check(restart["parent_id"] == fired["event_id"],
          f"supervised (a): the restart's parent {restart['parent_id']}, the fault "
          f"{fired['event_id']}")
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    mfus = [r.get("perf/mfu") for r in records if "perf/mfu" in r]
    triggers = doc["trigger_counts"]
    summary_a = {"flight_records": flights, "trigger_counts_at_dump": triggers,
                 "journal_kinds": kinds, "mfu": mfus, "kernel_vs_plain": kvp,
                 "fleet_launches": fl, "peak_allocated": mem["cuda:0"].get(
                     "allocated_bytes.all.peak")}
    print(f"supervised (a): scorer_die@step=5 restarted once (threads {names}), level 0, "
          f"{SUP_FIT} steps green; fleet launches {fl}; kernel vs plain async step |d loss| "
          f"{kvp['loss_err']:.2e}; (e) flight records {flights}, memory stats of "
          f"{list(mem)}, perf/mfu {mfus} against the floor 0.01 [{card}]")

    # The rates: unsupervised, supervised, supervised without the journal.
    arms = {"plain": dict(supervise=False), "supervised": {},
            "journal_off": dict(event_journal=False)}
    trainers, fleet0 = {}, {}
    for name, kw in arms.items():
        cfg = TrainConfig(**{**SUPERVISED, **kw, "log_dir": os.path.join(root, f"rate_{name}")})
        trainers[name] = build_trainer(torch, cfg, quiet=True)
        warm(trainers[name])
        # Untimed: the first log tick counts the step's FLOPs (~1 s).
        trainers[name].fit(steps=CLI_LOG_EVERY)
        fleet0[name] = dict(trainers[name]._scorer_fleet.launch_counts)
    rates = {name: [] for name in arms}
    us = {name: [] for name in arms}
    ticks = []
    for name in SUP_TURNS:
        t = trainers[name]
        r, counts = counted(mk, total, lambda: timed_fit(torch, t, SUP_RATE))
        want = fit_launches(t, SUP_RATE, step_launches)
        check(counts == want, f"supervised rates ({name}): launches {counts}, expected {want}")
        rates[name].append(r["steps_per_s"])
        us[name].append(r["us_per_step"])
        if r["tick_us"] is not None:
            ticks.append(r["tick_us"])
    mfu_fired = {}
    for name, t in trainers.items():
        mfu_fired[name] = (t.anomaly.trigger_counts.get("mfu_floor", 0)
                           if t.anomaly is not None else None)
        for k, v in fleet_delta(t._scorer_fleet, fleet0[name]).items():
            total[k] += v
        t.close()
    # Each turn over its neighbour of the other arm (ABBA order).
    ratio = [s / p for s, p in zip(rates["supervised"], rates["plain"])]
    journal_ratio = [s / o for s, o in zip(rates["supervised"], rates["journal_off"])]
    print(f"supervised (a) rates, {SUP_RATE} steps a turn in turns {SUP_TURNS}: steps/s "
          + ", ".join(f"{n} {[round(x, 2) for x in v]}" for n, v in rates.items())
          + f"; supervised/plain {[round(x, 3) for x in ratio]}, journal on/off "
          f"{[round(x, 3) for x in journal_ratio]}; host us a step "
          + ", ".join(f"{n} {[round(x, 1) for x in v]}" for n, v in us.items())
          + f"; the tick {[round(x, 2) for x in ticks]} us a step; mfu_floor triggers "
          f"at the default floor {mfu_fired} [{card}]")
    summary_a.update(steps_per_s=rates, us_per_step=us, tick_us=ticks,
                     supervised_over_plain=ratio, journal_on_over_off=journal_ratio,
                     mfu_floor_triggers=mfu_fired)
    return summary_a


def supervised_chaos(torch, mk, card: str, root: str, step_launches: dict,
                     total: dict) -> dict:
    """(b) Budget 0, a probe and a sync refresh every step, two every-step
    scorer deaths and a slow host: ``fit`` ends green at level 3, the table
    constant, each level's launches a step counted, the level-3 draw held
    to its plain version, and the journal's chains (e)."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.obs.events import parent_chain

    directory = os.path.join(root, "b")
    config = TrainConfig(**SUPERVISED, fault_spec=CHAOS, log_dir=directory,
                         supervisor_restart_budget=0, supervisor_probe_every=1,
                         supervisor_sync_every=1)
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    fleet, sup = trainer._scorer_fleet, trainer.supervisor
    # The counts at each step's start and before the final evaluation: a
    # step's interval holds its launches and its tick's (the probe's).
    marks = []
    step, evaluate = trainer.train_step, trainer.evaluate

    def mark():
        marks.append((sup.level(), dict(mk.launch_counts), dict(fleet.launch_counts)))

    def marked_step(*a, **kw):
        mark()
        return step(*a, **kw)

    def marked_evaluate(*a, **kw):
        mark()
        return evaluate(*a, **kw)

    trainer.train_step, trainer.evaluate = marked_step, marked_evaluate
    f0 = dict(fleet.launch_counts)
    try:
        out, counts = counted(mk, total, lambda: trainer.fit(steps=CHAOS_STEPS))
    finally:
        del trainer.train_step, trainer.evaluate
    torch.cuda.synchronize()
    fl = fleet_delta(fleet, f0)
    for k, v in fl.items():
        total[k] += v
    want = fit_launches(trainer, CHAOS_STEPS, step_launches)
    check(counts == want, f"supervised (b): step launches {counts}, expected {want}")
    by_level = {}
    for (level, s0, q0), (_, s1, q1) in zip(marks[:-1], marks[1:]):
        rec = by_level.setdefault(level, {"steps": 0, "step": {k: 0 for k in s0},
                                          "fleet": {k: 0 for k in q0}})
        rec["steps"] += 1
        for k in s0:
            rec["step"][k] += s1[k] - s0[k]
            rec["fleet"][k] += q1[k] - q0[k]
    stats = sup.stats()
    table = trainer.state.scoretable.scores
    check(math.isfinite(out["train/loss"]) and stats["supervisor/level"] == 3.0
          and stats["sampler/is_active"] == 0.0 and stats["supervisor/degradations"] >= 3
          and bool((table == table[0]).all()) and float(table[0]) == 0.0,
          f"supervised (b): loss {out['train/loss']!r}, {stats}, table min "
          f"{float(table.min())!r} max {float(table.max())!r}")
    flat = flat_table_draw(torch, mk, trainer)
    kvp = async_step_vs_plain(torch, mk, trainer, "supervised (b), level 3")
    transitions = [t["to"] for t in sup.summary()["transitions"]]
    trainer.close()
    rows = read_events(directory)
    degrades = [r for r in rows if r["kind"] == "supervisor/degrade"]
    chains = [[e["kind"] for e in parent_chain(rows, r["event_id"])] for r in degrades]
    check([r["detail"]["to"] for r in degrades][-3:] == ["sync", "frozen", "uniform"]
          and all(c[0] == "fault/fired" for c in chains),
          f"supervised (b): degrades {[r['detail'] for r in degrades]}, chains {chains}")
    check(os.path.exists(os.path.join(directory, "supervisor_summary.json")),
          "supervised (b): no supervisor_summary.json")
    per_step = {level: {part: {k: v / rec["steps"] for k, v in rec[part].items()}
                        for part in ("step", "fleet")} | {"steps": rec["steps"]}
                for level, rec in sorted(by_level.items())}
    print(f"supervised (b): chaos past a budget of 0, {CHAOS_STEPS} steps green at level 3 "
          f"(transitions {transitions}), the table constant at 0; launches a step by the "
          f"level at the step's start {per_step}; level-3 table_refresh_draw at L="
          f"{flat['L']}: the kernel's slots the plain version's, p = 1/L to "
          f"{flat['probs_err']:.2e}, weights 1 to {flat['weights_err']:.2e}; kernel vs plain "
          f"step at level 3 |d loss| {kvp['loss_err']:.2e}; (e) each degrade's chain: "
          f"{chains[-3:]} [{card}]")
    return {"transitions": transitions, "per_step_by_level": per_step, "flat_draw": flat,
            "kernel_vs_plain": kvp, "chains": chains, "fleet_launches": fl,
            "journal_events": len(rows)}


def supervised_recovery(torch, mk, card: str, root: str, step_launches: dict,
                        total: dict) -> dict:
    """(c) Budget 0 and a one-shot death: async → sync, then the probe
    revives the workers and climbs back to async with a fresh budget. Then
    a chunk scored on the training thread held to the plain NLL."""
    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**SUPERVISED, fault_spec="scorer_die@step=5",
                         log_dir=os.path.join(root, "c"), supervisor_restart_budget=0,
                         supervisor_probe_every=4, supervisor_sync_every=2)
    trainer = build_trainer(torch, config, quiet=True)
    warm(trainer)
    fleet, sup = trainer._scorer_fleet, trainer.supervisor
    f0 = dict(fleet.launch_counts)
    _, counts = counted(mk, total, lambda: trainer.fit(steps=RECOVER_STEPS))
    torch.cuda.synchronize()
    fl = fleet_delta(fleet, f0)
    for k, v in fl.items():
        total[k] += v
    want = fit_launches(trainer, RECOVER_STEPS, step_launches)
    check(counts == want, f"supervised (c): step launches {counts}, expected {want}")
    moves = [(t["from"], t["to"]) for t in sup.summary()["transitions"]]
    state = sup.model_state()
    check(moves == [("async", "sync"), ("sync", "async")] and sup.level() == 0
          and fleet.alive() and fleet.summary()["restarts"] == 1
          and state["budget_bucket"] == "fresh",
          f"supervised (c): transitions {moves}, {state}, fleet {fleet.summary()}")
    err = score_once_vs_plain(torch, trainer)
    trainer.close()
    print(f"supervised (c): one death past a budget of 0: {moves}, the workers revived "
          f"(restart 1), budget {state['budget_bucket']}; fleet launches {fl}; a chunk "
          f"scored on the training thread vs the plain NLL max |err| {err:.2e} [{card}]")
    return {"transitions": moves, "fleet_launches": fl, "score_once_err": err}


def supervised_prefetch(torch, mk, card: str, pool_launches: dict, total: dict) -> dict:
    """(d) The host-stream pool step, supervised, under deterministic cuDNN
    with ``prefetch_die@step=3``: the state bit-equal to an uninterrupted
    unsupervised run's, ``score_and_draw`` launched, and a kernel step
    against a plain step after the restart."""
    from mercury_tpu_torch import TrainConfig

    config = TrainConfig(**{**DURABLE, "data_placement": "host_stream"})
    undo = deterministic_cudnn(torch)
    runs = {}
    try:
        for name, kw in (("plain", {}), ("supervised", dict(
                supervise=True, supervisor_backoff_s=0.0, fault_spec="prefetch_die@step=3"))):
            trainer = build_trainer(torch, config.replace(**kw), quiet=True)
            _, counts = counted(mk, total, lambda: trainer.fit(steps=PREFETCH_STEPS))
            torch.cuda.synchronize()
            want = fit_launches(trainer, PREFETCH_STEPS, pool_launches)
            check(counts == want and counts["score_and_draw"] == PREFETCH_STEPS,
                  f"supervised (d) {name}: launches {counts}, expected {want}")
            runs[name] = {"digests": carried_digests(trainer.state), "trainer": trainer}
        sup = runs["supervised"]["trainer"]
        check(sup.supervisor.stats()["supervisor/restarts"] == 1.0 and sup._stream_gen == 1
              and sup._stream_pipe._thread.name == "mercury-prefetch-r1",
              f"supervised (d): {sup.supervisor.stats()}, generation {sup._stream_gen}")
        differ = sorted(k for k, v in runs["plain"]["digests"].items()
                        if runs["supervised"]["digests"].get(k) != v)
        check(not differ, f"supervised (d): the restarted run differs: {differ[:5]}")
        step_err = stream_kernel_vs_plain_step(torch, sup, sup.config)
    finally:
        undo()
        for run in runs.values():
            run["trainer"].close()
    print(f"supervised (d): host-stream pool step, prefetch_die@step=3 restarted "
          f"(mercury-prefetch-r1), {PREFETCH_STEPS} steps bit-equal to an uninterrupted run "
          f"({len(runs['plain']['digests'])} digests), {pool_launches} a step [{card}]")
    return {"digests": len(runs["plain"]["digests"]), "kernel_vs_plain": step_err}


def supervised_phase(torch, card: str, main_path, table_path) -> dict:
    """Phase 17: the supervised runtime on phase 5's config under async
    refresh (a) a restart within the budget, (b) chaos past it to uniform
    sampling, (c) a recovery to async, (d) a prefetch restart on the pool
    path, (e) the anomaly engine and the journal. The launches counted are
    the fits' steps and the fleet's scoring."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    pool_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    async_step = {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 0, "table_refresh_draw": 1,
                  "augment_normalize": 1}
    total = {k: 0 for k in mk.KERNELS}
    root = tempfile.mkdtemp(prefix="mercury_supervised_")
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        restart = part("a", supervised_restart, torch, mk, card, root, async_step, total)
        chaos = part("b", supervised_chaos, torch, mk, card, root, async_step, total)
        recovery = part("c", supervised_recovery, torch, mk, card, root, async_step, total)
        prefetch = part("d", supervised_prefetch, torch, mk, card, pool_step, total)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    check(all(v > 0 for v in total.values()), f"supervised: a kernel never launched: {total}")
    print("supervised: seconds by part " + ", ".join(f"({k}) {v:.1f}"
                                                     for k, v in seconds.items()))
    return {"launches": total,
            "summary": {"card": card, "restart": restart, "chaos": chaos,
                        "recovery": recovery, "prefetch": prefetch, "launches": total,
                        "seconds": seconds}}


# ------------------------------------------------------------------ phase 18
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str):
    """(status, body) of a GET on the loopback (``http.client``: no proxy
    is consulted)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


# The scraper's process: GETs the endpoints every period until its stdin
# closes, then prints each endpoint's status codes and the errors as JSON.
SCRAPER = r"""
import http.client, json, select, sys
port, period, endpoints = int(sys.argv[1]), float(sys.argv[2]), sys.argv[3:]
codes, errors = {ep: [] for ep in endpoints}, []
while not select.select([sys.stdin], [], [], period)[0]:
    for ep in endpoints:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", ep)
            r = conn.getresponse()
            r.read()
            codes[ep].append(r.status)
        except Exception as exc:
            errors.append(f"{ep}: {type(exc).__name__}: {exc}")
        finally:
            conn.close()
print(json.dumps({"codes": codes, "errors": errors}))
"""


class Scraper:
    """A process of its own (as a scraper is: its client work holds none of
    the trainer's GIL) reading the three endpoints every ``period_s`` until
    :meth:`stop`: each endpoint's status codes, and the errors."""

    def __init__(self, port: int, period_s: float = OBS_SCRAPE_S["serve10"]):
        self._proc = subprocess.Popen(
            [sys.executable, "-c", SCRAPER, str(port), str(period_s), *ENDPOINTS],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.codes = {ep: [] for ep in ENDPOINTS}
        self.errors = []

    def stop(self) -> dict:
        if self._proc is not None:
            out, _ = self._proc.communicate(input="", timeout=60)
            self._proc = None
            got = json.loads(out.strip().splitlines()[-1])
            self.codes, self.errors = got["codes"], got["errors"]
        return {ep: len(c) for ep, c in self.codes.items()}


def kernels_a_step(torch, trainer, steps: int = 10) -> dict:
    """CUDA kernels and memsets a step over ``steps`` steps: the
    ``kernel`` and ``gpu_memset`` events of a ``torch.profiler`` trace (the
    activity records themselves, not an aggregate)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    return {cat: sum(1 for e in events if e.get("cat") == cat) / steps
            for cat in ("kernel", "gpu_memset")}


def span_ns(tracer, spans: int = OBS_SPANS) -> float:
    """Host ns of one ``with tracer.span(...)`` (the loop's own cost
    included)."""
    t0 = time.perf_counter_ns()
    for _ in range(spans):
        with tracer.span("trainer/dispatch", cat="trainer"):
            pass
    return (time.perf_counter_ns() - t0) / spans


def trace_lanes(doc: dict) -> dict:
    """What a ``torch.profiler`` Chrome trace calls its lanes: the process
    and thread names of the pids that hold device events, the count of
    events a category, and the names of the annotation ranges on the host
    and on the card."""
    cats: dict = {}
    device_pids = set()
    ranges = {"user_annotation": set(), "gpu_user_annotation": set()}
    for e in doc.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") == "X":
            cats[cat] = cats.get(cat, 0) + 1
            if cat in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation"):
                device_pids.add(e.get("pid"))
            if cat in ranges:
                ranges[cat].add(e.get("name"))
    names = sorted({f"{e.get('pid')}:{e.get('name')}={(e.get('args') or {}).get('name')}"
                    for e in doc.get("traceEvents", [])
                    if e.get("ph") == "M" and e.get("pid") in device_pids
                    and e.get("name") in ("process_name", "thread_name")})
    return {"categories": cats, "device_lane_names": names,
            "ranges": {k: sorted(v) for k, v in ranges.items()}}


def observed_fit(torch, mk, card: str, root: str, pool_step: dict, total: dict) -> dict:
    """(a) 30 steps of ``fit`` on the main path's config with the tracer,
    the status server (scraped from another thread), a log_dir and the NaN
    injection's profiler window; then the trace, the window's attribution
    and the records."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.obs import profile_parse, serve

    port = free_port()
    run = os.path.join(root, "a")
    config = TrainConfig(**OBS, trace=True, serve_port=port, log_dir=run,
                         anomaly_inject_nan_step=OBS_NAN_STEP,
                         anomaly_profile_steps=OBS_WINDOW)
    trainer = build_trainer(torch, config, quiet=True)
    scraper = Scraper(port)
    try:
        warm(trainer)
        out, counts = counted(mk, total, lambda: trainer.fit(steps=OBS_STEPS))
        want = fit_launches(trainer, OBS_STEPS, pool_step)
        check(counts == want, f"observed fit: launches {counts}, expected {want} "
              "(the step's, inside and outside the profiler window, and the evaluation's)")
        check(math.isfinite(out["test/eval_loss"]), f"observed fit gave {out}")
        trainer.logger.flush()
        scrapes = scraper.stop()
        check(not scraper.errors, f"scrapes failed: {scraper.errors[:3]}")
        check(all(n > 0 and set(scraper.codes[ep]) == {200} for ep, n in scrapes.items()),
              f"scrapes during the fit: {scraper.codes}")
        code, text = http_get(port, "/metricsz")
        samples = serve.parse_openmetrics(text)
        latest = trainer.logger.latest_record()
        want_samples = {serve.metric_name(k): float(v) for k, v in latest.items()
                        if isinstance(v, (int, float))}
        check(code == 200 and samples.keys() == want_samples.keys() and all(
            samples[k] == want_samples[k] or (math.isnan(samples[k]) and math.isnan(v))
            for k, v in want_samples.items()),
            "/metricsz does not parse back to the writer's latest record")
        status = json.loads(http_get(port, "/statusz")[1])
        check(status["step"] == trainer.state.step and status["state_schema_sha"] is None
              and status["manifest"]["device_kind"] == torch.cuda.get_device_name(0),
              f"/statusz: {sorted(status)}")
        health = json.loads(http_get(port, "/healthz")[1])
        check(health["healthy"] and health["step"] == trainer.state.step, f"/healthz {health}")
        windows = trainer._profiler.written
        check(len(windows) == 1, f"profiler windows written: {windows}")
    finally:
        scraper.stop()
        trainer.close()
    window = windows[0]
    check(os.path.basename(window).startswith("trace_step")
          and os.path.dirname(window) == os.path.join(run, "profile"), f"window at {window}")
    bd = profile_parse.parse_profile(window)
    lanes = trace_lanes(json.load(open(window)))
    scopes = {k: v["time_us"] for k, v in bd["scopes"].items()}
    check(bd["attributed_frac"] == 1.0 and bd["counts"]["lane"] == "torch_streams"
          and scopes["mercury_scoring"] > 0 and scopes["mercury_optimizer"] > 0,
          f"window attribution: {bd['attributed_frac']} {scopes} {lanes}")
    saved = json.load(open(os.path.join(run, "device_time_breakdown.json")))
    check(saved["total_device_time_us"] == bd["total_device_time_us"],
          "device_time_breakdown.json is not the window's breakdown")
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    check(any("prof/scope_frac/mercury_scoring" in r for r in records),
          "no prof/* record after the window")
    doc = json.load(open(os.path.join(run, "trace.json")))
    threads = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"}
    dispatch = [e for e in doc["traceEvents"] if e.get("name") == "trainer/dispatch"]
    check(len(dispatch) == WARMUP_STEPS + OBS_STEPS
          and {e["tid"] for e in dispatch} == {threads["train"]},
          f"trace.json: {len(dispatch)} dispatch spans, expected "
          f"{WARMUP_STEPS + OBS_STEPS} on the train thread")
    check("events/anomaly" in threads and doc["otherData"]["journal_events"] > 0,
          f"trace.json: no journal lane ({sorted(threads)})")
    flight = [n for n in os.listdir(run) if n.startswith("flight_record_")]
    opened = int(os.path.basename(window)[len("trace_step"):-len(".json")])
    check(flight == ["flight_record_step20_non_finite.json"] and 20 < opened <= 30,
          f"flight records {flight}, window {window}: not the NaN's")
    spans = json.load(open(os.path.join(run, flight[0])))["spans"]
    check(any(s["name"] == "trainer/dispatch" for s in spans), "the flight record has no spans")
    print(f"observability (a): {OBS_STEPS} steps with trace, serve_port {port} (scrapes "
          f"{scrapes}), window {os.path.basename(window)}: scopes "
          + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in scopes.items())
          + f", attributed_frac {bd['attributed_frac']}, idle {bd['idle']['idle_frac']:.3f}, "
          f"{bd['counts']['device_events']} device events ({bd['counts']['by_launch']} placed "
          f"by their launch), {bd['counts']['annotation_ranges']} host ranges; trace.json "
          f"{len(doc['traceEvents'])} events [{card}]")
    print(f"observability (a): the window's lanes {lanes}")
    return {"run": run, "scrapes": scrapes, "window": os.path.basename(window),
            "breakdown": {k: bd[k] for k in ("scopes", "total_device_time_us",
                                             "attributed_frac", "h2d", "idle", "counts")},
            "lanes": lanes, "trace_events": len(doc["traceEvents"]),
            "dispatch_spans": len(dispatch), "flight_record": flight[0]}


def observed_rates(torch, mk, card: str, root: str, pool_step: dict, total: dict) -> dict:
    """(a) A second run of the config (trace, a log_dir, no injection) for
    (c)'s diff, then steps/s with the tracer off and on and the status
    server off and on (scraped once or ten times a second by another
    process) in turns, CUDA kernels a step, a span's host ns, and a kernel
    step against a plain step."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.obs.serve import StatusServer
    from mercury_tpu_torch.obs.trace import NULL_TRACER, SpanTracer

    run = os.path.join(root, "b")
    config = TrainConfig(**OBS, trace=True, log_dir=run)
    trainer = build_trainer(torch, config, quiet=True)
    rates = {arm: [] for arm in ("off", "trace", "serve1", "serve10")}
    scrapes = []
    try:
        warm(trainer)
        out, counts = counted(mk, total, lambda: trainer.fit(steps=OBS_STEPS))
        want = fit_launches(trainer, OBS_STEPS, pool_step)
        check(counts == want, f"second fit: launches {counts}, expected {want}")
        # Against the plain versions at phase 4's step (33), after the fit,
        # so the two runs of (c)'s diff draw alike; after the turns the loss
        # nears 0 and float32's rounding of lse − z[y] is no longer small
        # beside it.
        step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
        own = trainer.tracer
        for arm in OBS_TURNS:
            trainer.tracer = SpanTracer(config.trace_capacity) if arm == "trace" else NULL_TRACER
            server = scraper = None
            if arm in OBS_SCRAPE_S:
                server = StatusServer(0, health_fn=trainer._serve_health,
                                      status_fn=trainer._serve_status,
                                      metrics_fn=trainer.logger.latest_record)
                scraper = Scraper(server.port, OBS_SCRAPE_S[arm])
            try:
                dt, counts, _, _ = timed_steps(torch, mk, trainer, OBS_TURN)
            finally:
                if scraper is not None:
                    scrapes.append({arm: scraper.stop()})
                    check(not scraper.errors, f"{arm}: scrapes failed {scraper.errors[:3]}")
                    server.close()
            for k, v in counts.items():
                total[k] += v
            want = {k: v * OBS_TURN for k, v in pool_step.items()}
            check(counts == want, f"{arm} turn: launches {counts}, expected {want}")
            rates[arm].append(OBS_TURN / dt)
        # CUDA kernels a step (torch.profiler, not a ProfilerWindow: the
        # step's scopes stay shut) with the tracer off and on, and with the
        # scopes forced open, each arm from the same state (a reshuffle of
        # the stream falls on the same step). Printed, not held equal: the
        # count moves by a few kernels in ten steps between reads of one
        # state whatever the arm; the hand-written kernels' launches, held
        # exact in every turn, are the step's own.
        from mercury_tpu_torch.train import scopes

        kernels, state = {}, trainer.state
        for arm in ("off", "trace", "scopes"):
            trainer.tracer = own if arm == "trace" else NULL_TRACER
            trainer.state = state.clone()
            scopes.state.capturing = arm == "scopes"
            try:
                kernels[arm] = kernels_a_step(torch, trainer)
            finally:
                scopes.state.capturing = False
        trainer.state = state
        trainer.tracer = own
        ns = {"null": span_ns(NULL_TRACER), "span_tracer": span_ns(SpanTracer(4096))}
    finally:
        trainer.close()
    ratios = {arm: [a / b for a, b in zip(rates[arm], rates["off"])]
              for arm in ("trace", "serve1", "serve10")}
    print(f"observability (a): steps/s in turns {OBS_TURNS}: "
          + ", ".join(f"{arm} {v}" for arm, v in rates.items())
          + f" (scrapes {scrapes}); over off: "
          + ", ".join(f"{arm} {[round(r, 3) for r in v]}" for arm, v in ratios.items())
          + f"; CUDA kernels a step {kernels}; "
          f"a span {ns['span_tracer']:.0f} ns on, "
          f"{ns['null']:.0f} ns off; kernel step vs plain |d loss| "
          f"{step_err['train/loss']:.2e} [{card}]")
    return {"run": run, "rates": rates, "ratios": ratios, "scrapes": scrapes,
            "span_ns": ns, "kernels_per_step": kernels, "kernel_vs_plain": step_err}


def observed_ranks_body(root: str):
    """One rank of phase 18 (b) (run by ``spawn``; prints nothing): the
    W=2 lockstep config supervised, ``host_slow`` on rank 1 under each
    aggregation mode, then ``scorer_die`` on rank 1 at budget 0 with the
    levels recorded at every tick and refresh."""
    import torch
    import torch.distributed as dist

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    rank = dist.get_rank()
    step = {"nll_fwd": 1, "nll_bwd": 1, "score_and_draw": 0, "table_refresh_draw": 1,
            "augment_normalize": 1}
    total = {k: 0 for k in mk.KERNELS}
    service = {k: 0 for k in mk.KERNELS}
    out = {"rank": rank, "runs": {}}

    def fit(kw, before_fit=None):
        trainer = build_trainer(torch, TrainConfig(**kw), quiet=True)
        svc = trainer._scorer_fleet
        c0 = dict(svc.launch_counts)
        try:
            extra = before_fit(trainer) if before_fit else None
            t0 = time.perf_counter()
            result, counts = counted(mk, total, lambda: trainer.fit(steps=OBS_RANK_STEPS))
            elapsed = time.perf_counter() - t0
            want = fit_launches(trainer, OBS_RANK_STEPS, step)
            check(counts == want, f"rank {rank}: launches {counts}, expected {want}")
            check(math.isfinite(result["train/loss"]), f"rank {rank}: fit gave {result}")
            for k in service:
                service[k] += svc.launch_counts[k] - c0[k]
            return trainer, elapsed, extra
        except BaseException:
            trainer.close()
            raise

    for mode in ("allgather", "files"):
        kw = dict(OBS_RANKS, crosshost_telemetry=mode, log_dir=os.path.join(root, mode))
        if rank == 1:
            kw["fault_spec"] = OBS_SLOW
        trainer, elapsed, _ = fit(kw)
        trainer.close()
        out["runs"][mode] = {"seconds": elapsed, "triggers": (
            None if trainer.anomaly is None else dict(trainer.anomaly.trigger_counts))}

    kw = dict(OBS_RANKS, crosshost_telemetry="off", supervisor_restart_budget=0,
              supervisor_probe_every=0, supervisor_sync_every=1,
              log_dir=os.path.join(root, "ladder"))
    if rank == 1:
        kw["fault_spec"] = f"scorer_die@step={OBS_DIE_STEP}"
    levels, acted, agree_us = [], [], []

    def record(trainer):
        from mercury_tpu_torch.parallel import collectives

        sup = trainer.supervisor
        tick, refresh, agree = sup.tick, trainer._refresh_tick, sup._agree

        def ticked(step_):
            tick(step_)
            levels.append((step_, sup.level()))

        def refreshed(step_, advanced=1):
            acted.append((step_, sup.level()))
            refresh(step_, advanced)

        def timed_agree(values):
            t0 = time.perf_counter()
            got = agree(values)
            agree_us.append((time.perf_counter() - t0) * 1e6)
            return got

        check(agree is collectives.allreduce_max_ints, "the W=2 supervisor has no agreement")
        sup.tick, trainer._refresh_tick, sup._agree = ticked, refreshed, timed_agree

    trainer, elapsed, _ = fit(kw, record)
    try:
        out["ladder"] = {"levels": levels, "acted": acted, "seconds": elapsed,
                         "transitions": trainer.supervisor.summary()["transitions"],
                         "released": trainer._scorer_fleet._ls_released,
                         "agree_us": agree_us}
    finally:
        trainer.close()
    out["launches"], out["service_launches"] = total, service
    return out


def observed_ranks(torch, card: str, root: str, total: dict) -> dict:
    """(b) Two gloo ranks on card 0 (:func:`observed_ranks_body`)."""
    from mercury_tpu_torch.parallel.distributed import spawn

    ranks = spawn(observed_ranks_body, TWO_RANKS, "gloo", root, devices=[0] * TWO_RANKS,
                  timeout_s=600)
    for mode in ("allgather", "files"):
        check(ranks[1]["runs"][mode]["triggers"] is None, "rank 1 has an anomaly engine")
        fired = ranks[0]["runs"][mode]["triggers"]
        check(fired.get("straggler", 0) >= 1, f"{mode}: the straggler trigger did not fire "
              f"on rank 0 ({fired})")
        records = [json.loads(line)
                   for line in open(os.path.join(root, mode, "metrics.jsonl"))]
        ticks = [r for r in records if "host/reporting" in r]
        check(ticks and all(k in ticks[-1] for k in ("host/min/step_time_s",
                                                     "host/max/step_time_s",
                                                     "host/spread/step_time_s")),
              f"{mode}: rank 0's records lack the host/* keys")
        ratios = [r["host/straggler_ratio"] for r in ticks if "host/straggler_ratio" in r]
        check(ratios and max(ratios) > OBS_RANKS["anomaly_straggler_factor"],
              f"{mode}: host/straggler_ratio {ratios}")
        ranks[0]["runs"][mode]["straggler_ratio"] = ratios
    a, b = ranks[0]["ladder"], ranks[1]["ladder"]
    check(a["levels"] == b["levels"] and a["acted"] == b["acted"],
          f"the ranks' levels differ: {a['levels']} / {b['levels']}")
    moves = [[(t["step"], t["from"], t["to"]) for t in r["transitions"]] for r in (a, b)]
    check(moves[0] == moves[1] and len(moves[0]) == 1 and moves[0][0][1:] == ("async", "sync"),
          f"the ranks' transitions: {moves}")
    check(a["released"] and b["released"], "a rank did not leave the lockstep")
    check(max(a["seconds"], b["seconds"]) < OBS_RANK_TIMEOUT_S,
          f"the ladder fits took {a['seconds']:.1f} and {b['seconds']:.1f} s")
    check(a["acted"][-1][1] == 1, f"the last refresh acted on level {a['acted'][-1]}")
    launches = {k: sum(r["launches"][k] + r["service_launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    for k in ("nll_fwd", "nll_bwd", "table_refresh_draw", "augment_normalize"):
        check(all(r["launches"][k] > 0 for r in ranks), f"(b): {k} never launched")
    agree = a["agree_us"] + b["agree_us"]
    print(f"observability (b): two gloo ranks on one card; straggler ratios "
          f"allgather {[round(x, 3) for x in ranks[0]['runs']['allgather']['straggler_ratio']]}"
          f", files {[round(x, 3) for x in ranks[0]['runs']['files']['straggler_ratio']]}; "
          f"ladder {moves[0]}, levels a tick {[lvl for _, lvl in a['levels']]} on both "
          f"ranks, fits {a['seconds']:.1f}/{b['seconds']:.1f} s; the agreement "
          f"{statistics.median(agree):.1f} µs a tick (median of {len(agree)}, max "
          f"{max(agree):.1f}); launches {launches} [{card}]")
    for k, v in launches.items():
        total[k] += v
    return {"per_rank": ranks, "launches": launches,
            "agree_us": {"median": statistics.median(agree), "max": max(agree),
                         "n": len(agree)}}


def observed_reports(card: str, run_a: str, run_b: str) -> dict:
    """(c) The report of (a)'s run, as markdown and HTML (``report.main``
    in this process), and ``--diff`` of (a)'s two runs through the command
    line, ``python -m mercury_tpu_torch.obs.report``."""
    from mercury_tpu_torch.obs import report

    out = {}
    for name, args in (("report", [run_a, "--out", os.path.join(run_a, "report.md")]),
                       ("html", [run_a, "--html", "--out", os.path.join(run_a, "report.html")])):
        rc = report.main(args)
        out[name] = {"rc": rc}
        check(rc == 0, f"report {name}: rc {rc}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mercury_tpu_torch.obs.report", "--diff",
                           run_a, run_b], capture_output=True, text=True, timeout=120, cwd=ROOT)
    out["diff"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                   "checked": [line for line in proc.stdout.splitlines()
                               if line.startswith(("ok ", "skip "))]}
    check(proc.returncode == 0, f"report --diff: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    text = open(os.path.join(run_a, "report.md")).read()
    sections = [line for line in text.splitlines() if line.startswith("## ")]
    for want in ("## Manifest", "## Metrics", "## Device-time breakdown", "## Run timeline",
                 "## Flight records"):
        check(want in sections, f"the report lacks {want}: {sections}")
    print(f"observability (c): report sections {sections}; --diff exit 0 over "
          f"{len(out['diff']['checked'])} rules [{card}]")
    out["sections"] = sections
    return out


def observability_phase(torch, card: str, main_path) -> dict:
    """Phase 18: (a) tracing, serving and the profiler window on the main
    path, (b) aggregation and the agreed ladder at W=2, (c) reports. The
    launches counted are the fits' and the turns' steps and, in (b), the
    service's scoring."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    pool_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    total = {k: 0 for k in mk.KERNELS}
    two_ranks = {k: 0 for k in mk.KERNELS}
    root = tempfile.mkdtemp(prefix="mercury_observed_")
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        fitted = part("a", observed_fit, torch, mk, card, root, pool_step, total)
        rates = part("a rates", observed_rates, torch, mk, card, root, pool_step, total)
        torch.cuda.empty_cache()
        ranks = part("b", observed_ranks, torch, card, os.path.join(root, "ranks"), two_ranks)
        reports = part("c", observed_reports, card, fitted["run"], rates["run"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    check(all(v > 0 for k, v in total.items() if k in pool_step and pool_step[k]),
          f"observability: a kernel of the main path never launched: {total}")
    print("observability: seconds by part " + ", ".join(f"({k}) {v:.1f}"
                                                        for k, v in seconds.items()))
    return {"launches": total, "two_rank_launches": two_ranks,
            "summary": {"card": card, "fit": fitted, "rates": rates,
                        "ranks": {k: v for k, v in ranks.items() if k != "per_rank"},
                        "per_rank": ranks["per_rank"], "reports": reports,
                        "seconds": seconds}}


# ----------------------------------------------------------------- phase 19
def record_kernel_inputs(mk, names=("nll_fwd_kernel", "nll_bwd_kernel",
                                    "score_and_draw_kernel")):
    """Wrap the kernels ``names`` (default: the pool step's three) to keep a
    copy of the inputs of each launch the step makes (on the training
    thread or autograd's; not a scorer's threads; the wrappers still
    launch and count); returns the dict of lists and the undo."""
    import threading

    launches = {n: getattr(mk, n) for n in names}
    seen = {n: [] for n in names}

    def recorder(name):
        def recorded(*args):
            if not threading.current_thread().name.startswith("mercury-scorer"):
                seen[name].append(tuple(a.clone() if hasattr(a, "clone") else a
                                        for a in args))
            return launches[name](*args)
        return recorded

    for n in names:
        setattr(mk, n, recorder(n))

    def undo():
        for n, f in launches.items():
            setattr(mk, n, f)

    return seen, undo


def step_kernels_vs_plain(torch, mk, trainer, name: str) -> dict:
    """One pool step with its kernels' inputs kept, then each kernel
    launched again on those inputs against its plain version, to the kernel
    phase's tolerances: nll_fwd rtol 1e-5, atol 1e-5 ([320, C] and [32,
    C]); nll_bwd as :func:`check_bwd` ([32, C]); score_and_draw's probs
    rtol 1e-5 and its draws as :func:`check_draws`. Returns the shapes and
    the largest errors."""
    seen, undo = record_kernel_inputs(mk)
    try:
        trainer.train_step()
        torch.cuda.synchronize()
    finally:
        undo()
    out = kernels_vs_plain(torch, mk, seen, name)
    shapes = {k: [c["shape"] for c in v] for k, v in out.items()}
    classes = trainer.dataset.num_classes
    want = {"nll_fwd": [[320, classes], [32, classes]], "nll_bwd": [[32, classes]],
            "score_and_draw": [[320, 32]]}
    check(shapes == want, f"{name}: the step's kernel shapes {shapes}, expected {want}")
    return out


def kernels_vs_plain(torch, mk, seen: dict, name: str) -> dict:
    """Each kernel launched again on the inputs ``seen`` recorded
    (:func:`record_kernel_inputs`) against its plain version, to the
    kernel phase's tolerances (:func:`step_kernels_vs_plain`); the shapes
    and the largest errors by kernel."""
    from mercury_tpu_torch.ops import reference

    out = {"nll_fwd": [], "nll_bwd": [], "score_and_draw": []}
    for z, y in seen["nll_fwd_kernel"]:
        err = within(mk.nll_fwd_kernel(z, y), reference.nll_forward(z, y),
                     rtol=1e-5, atol=1e-5)
        out["nll_fwd"].append({"shape": list(z.shape), "dtype": str(z.dtype)[6:],
                               "max_abs_err": err})
    for z, y, g in seen["nll_bwd_kernel"]:
        err, one_ulp = check_bwd(torch, reference, f"{name}: nll_bwd {list(z.shape)}",
                                 mk.nll_bwd_kernel(z, y, g), z, y, g)
        out["nll_bwd"].append({"shape": list(z.shape), "dtype": str(z.dtype)[6:],
                               "max_abs_err": err, "one_ulp": one_ulp})
    for losses, ema1, u, alpha in seen["score_and_draw_kernel"]:
        probs, sel, scaled = mk.score_and_draw_kernel(losses, ema1, u, alpha)
        p_ref, s_ref, c_ref = reference.score_and_draw(losses, ema1.reshape(()), u, alpha)
        err = within(probs, p_ref, rtol=1e-5, atol=0.0)
        _, _, differ = check_draws(torch, f"{name}: score_and_draw N={losses.numel()}",
                                   probs, u, sel, s_ref)
        same = ~differ
        err = max(err, within(scaled[same], c_ref[same], rtol=1e-5, atol=0.0))
        out["score_and_draw"].append({"shape": [losses.numel(), u.numel()],
                                      "max_abs_err": err, "mismatches": int(differ.sum())})
    return out


def pool_arm(torch, mk, card: str, config, dataset, launches: dict, label: str) -> dict:
    """``config`` (a model on the default pool step) over ``dataset``: 3
    warm-up and 30 timed steps with the launches a step phase 4's, the
    kernels on one step's inputs and a kernel step against a plain step, a
    profiler window, peak memory (above the arm's start: earlier phases'
    trainers stay alive), MFU, then the uniform arm in turns. Phase 19's
    (a) and phase 20's (a)."""
    from mercury_tpu_torch.obs.accounting import flops_per_step, peak_flops

    model = config.model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # The peak above what earlier phases and the dataset hold.
    base = torch.cuda.memory_allocated()
    trainer = build_trainer(torch, config, quiet=True, dataset=dataset)
    warm(trainer)
    dt, counts, losses, metrics = timed_steps(torch, mk, trainer)
    pool_step = POOL_STEP
    want = {k: v * MAIN_STEPS for k, v in pool_step.items()}
    check(counts == want, f"{label} {model}: launch counts {counts}, expected {want}")
    for k, v in counts.items():
        launches[k] += v
    peak = torch.cuda.max_memory_allocated() - base
    telemetry = check_telemetry(torch, metrics, "pool", config.batch_size)
    moe_aux = check_moe_aux(torch, trainer, metrics, label)
    kernels = step_kernels_vs_plain(torch, mk, trainer, model)
    step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
    window = profile_window(torch, trainer, dt / MAIN_STEPS * 1e6, steps=5)
    window.pop("by_kernel")
    flops = flops_per_step(trainer)
    check(flops is not None and flops > 0, f"{label} {model}: FLOPs a step {flops}")
    peak_rate = peak_flops(torch.cuda.get_device_name(0))
    rates = {"is": [MAIN_STEPS / dt], "uniform": []}
    arms = {"is": trainer,
            "uniform": build_trainer(torch, config.replace(use_importance_sampling=False),
                                     quiet=True, dataset=dataset)}
    warm(arms["uniform"])
    uniform_step = {**pool_step, "nll_fwd": 1, "score_and_draw": 0}
    for turn in IMAGE_TURNS[1:]:
        t_dt, t_counts, _, _ = timed_steps(torch, mk, arms[turn])
        t_want = {k: v * MAIN_STEPS for k, v in
                  (pool_step if turn == "is" else uniform_step).items()}
        check(t_counts == t_want, f"{label} {model} ({turn} turn): launch counts {t_counts}, "
              f"expected {t_want}")
        rates[turn].append(MAIN_STEPS / t_dt)
        for k, v in t_counts.items():
            launches[k] += v
    steps_s = statistics.mean(rates["is"])
    mfu = flops * steps_s / peak_rate if peak_rate else None
    ratio = steps_s / statistics.mean(rates["uniform"])
    fwd_err = max(c["max_abs_err"] for c in kernels["nll_fwd"])
    print(f"{label} {model}: {MAIN_STEPS} steps in {dt:.3f} s = {MAIN_STEPS / dt:.2f} "
          f"steps/s; losses first {losses[0].item():.4f}, last {losses[-1].item():.4f}; "
          f"launches {counts}; train/moe_aux {moe_aux}; peak memory {peak / 2**30:.3f} GiB above the arm's start; "
          f"device busy "
          f"{100 * window['busy_share_unprofiled']:.1f}% of the unprofiled step, "
          f"{window['kernels_per_step']:.1f} CUDA kernels a step [{card}]")
    print(f"  FLOPs a step {flops:.4g}, perf/mfu {mfu}; steps/s in turns: IS {rates['is']}, "
          f"uniform {rates['uniform']}, IS/uniform {ratio:.3f}; the step's kernels on its "
          f"own inputs: nll_fwd {[c['shape'] for c in kernels['nll_fwd']]} max|err| "
          f"{fwd_err:.2e}, nll_bwd {kernels['nll_bwd'][0]['max_abs_err']:.2e}, "
          f"score_and_draw {kernels['score_and_draw'][0]['max_abs_err']:.2e}; kernel step "
          f"vs plain step |d loss| {step_err['train/loss']:.2e} [{card}]")
    summary = {"model": model, "parameters": sum(p.numel() for p in
                                                trainer.state.model.parameters()),
               "steps": MAIN_STEPS, "seconds": dt, "steps_per_s": MAIN_STEPS / dt,
               "launches": counts, "first_loss": losses[0].item(),
               "last_loss": losses[-1].item(), "peak_bytes": peak, "profile": window,
               "flops_per_step": flops, "mfu": mfu, "rates": rates, "is_over_uniform": ratio,
               "step_kernels": kernels, "kernel_vs_plain": step_err, "telemetry": telemetry,
               "moe_aux": moe_aux, "card": card}
    for arm in arms.values():
        arm.close()
    del arms, trainer
    torch.cuda.empty_cache()
    return summary


def check_moe_aux(torch, trainer, metrics, label: str):
    """Every step's ``train/moe_aux``: finite and in (0, E·layers] with
    experts (each block's Switch loss lies in (0, E]), exactly 0.0
    without. Returns its range over the steps."""
    aux = torch.stack([m["train/moe_aux"] for m in metrics]).float().cpu()
    experts = trainer.config.moe_experts
    if experts is None:
        check(bool((aux == 0).all()), f"{label}: train/moe_aux without experts {aux.tolist()}")
        return None
    top = experts * len(trainer.state.model.blocks)
    check(bool((torch.isfinite(aux) & (aux > 0) & (aux <= top)).all()),
          f"{label}: train/moe_aux outside (0, {top}]: {aux.tolist()}")
    return [aux.min().item(), aux.max().item()]


def digits_arms(torch, mk, card: str) -> dict:
    """(c) ResNet-18 on digits_imb, importance sampling against uniform,
    ``DIGITS_STEPS`` steps each from the same seed: test accuracy, the rare
    classes' accuracy and the seconds. Only where scikit-learn imports (the
    digits ship inside it); the numbers are printed and checked finite."""
    try:
        import sklearn.datasets  # noqa: F401
    except ImportError:
        print(f"image (c): scikit-learn does not import here, so ResNet-18 on digits_imb "
              f"(IS against uniform) was not run [{card}]")
        return {"run": False}
    from mercury_tpu_torch import TrainConfig

    out = {"run": True, "steps": DIGITS_STEPS}
    for arm, is_on in (("is", True), ("uniform", False)):
        config = TrainConfig(**DIGITS, use_importance_sampling=is_on)
        trainer = build_trainer(torch, config, quiet=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted = trainer.fit(steps=DIGITS_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        per_class = trainer.per_class_accuracy()
        rare = float(per_class[list(RARE_CLASSES)].mean())
        acc = float(fitted["test/eval_acc"])
        check(math.isfinite(acc) and math.isfinite(rare),
              f"image (c) {arm}: test accuracy {acc}, rare classes {rare}")
        out[arm] = {"test_acc": acc, "rare_acc": rare, "seconds": seconds,
                    "per_class": per_class.tolist(), "n_train": trainer.dataset.n_train}
        print(f"image (c) ResNet-18 on digits_imb ({trainer.dataset.n_train} train images), "
              f"{arm}: {DIGITS_STEPS} steps in {seconds:.2f} s, test accuracy {acc:.4f}, "
              f"classes 5-9 {rare:.4f} [{card}]")
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    return out


def image_family_phase(torch, card: str) -> dict:
    """Phase 19: the image family on the card. (a) SmallCNN, VGG-11, VGG-16
    and MobileNetV2 on the default pool step over synthetic_hard (20
    classes); (b) MobileNetV2 on the fused scoretable step; (c) ResNet-18
    on digits_imb where scikit-learn imports."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.trainer import build_dataset

    launches, seconds, out = {k: 0 for k in mk.KERNELS}, {}, {"card": card}
    t0 = time.perf_counter()
    dataset = build_dataset(TrainConfig(**IMAGE), torch.device("cuda"))
    check(dataset.num_classes == 20 and dataset.synthetic and dataset.n_train == 5000,
          f"synthetic_hard: {dataset.num_classes} classes, {dataset.n_train} images")
    out["pool"] = {}
    for model in IMAGE_MODELS:
        out["pool"][model] = pool_arm(torch, mk, card, TrainConfig(**IMAGE, model=model),
                                      dataset, launches, "image (a)")
    seconds["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["scoretable"] = table_arm(torch, mk, card, TrainConfig(**IMAGE_TABLE), dataset,
                                  launches, "image (b)")
    del dataset
    torch.cuda.empty_cache()
    seconds["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["digits"] = digits_arms(torch, mk, card)
    seconds["c"] = time.perf_counter() - t0
    check(all(launches[k] > 0 for k in mk.KERNELS),
          f"image family: a kernel of the path never launched: {launches}")
    print("image family: seconds by part " + ", ".join(f"({k}) {v:.1f}"
                                                        for k, v in seconds.items()))
    out["seconds"] = seconds
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 20
def table_arm(torch, mk, card: str, config, dataset, launches: dict, label: str) -> dict:
    """``config`` on the fused scoretable step: 30 timed steps held to
    2/1/0/1/2 launches a step (nll_fwd/nll_bwd/score_and_draw/
    table_refresh_draw/augment_normalize), the telemetry, and a kernel
    step against a plain step. Phase 19's (b) and phase 20's (b)."""
    trainer = build_trainer(torch, config, quiet=True, dataset=dataset)
    warm(trainer)
    dt, counts, losses, metrics = timed_steps(torch, mk, trainer)
    want = {k: v * MAIN_STEPS for k, v in TABLE_STEP.items()}
    check(counts == want, f"{label}: launch counts {counts}, expected {want}")
    for k, v in counts.items():
        launches[k] += v
    telemetry = check_telemetry(torch, metrics, "scoretable", config.batch_size)
    moe_aux = check_moe_aux(torch, trainer, metrics, label)
    step_err = kernel_vs_plain_step(torch, trainer, config, quiet=True)
    print(f"{label} {config.model}, scoretable + fused: {MAIN_STEPS} steps in {dt:.3f} s = "
          f"{MAIN_STEPS / dt:.2f} steps/s; losses first {losses[0].item():.4f}, last "
          f"{losses[-1].item():.4f}; launches {counts}; train/moe_aux {moe_aux}; kernel step "
          f"vs plain step |d loss| {step_err['train/loss']:.2e} [{card}]")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return {"steps": MAIN_STEPS, "seconds": dt, "steps_per_s": MAIN_STEPS / dt,
            "launches": counts, "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
            "kernel_vs_plain": step_err, "telemetry": telemetry, "moe_aux": moe_aux}


def remat_turns(torch, mk, card: str, dataset, launches: dict) -> dict:
    """(c) Path B with ``remat=True`` against without, from the same seed
    (the same weights and draws), in turns (off, on, on, off): each turn's
    losses equal the other arm's at the same steps (rtol 1e-5), the
    launches a step are the pool step's, and the peak memory above each
    turn's start and the steps/s ratio are printed."""
    from mercury_tpu_torch import TrainConfig

    arms = {name: build_trainer(torch, TrainConfig(**SEQUENCE, model="transformer",
                                                   remat=name == "on"),
                                quiet=True, dataset=dataset)
            for name in ("off", "on")}
    check(arms["on"].state.model.remat and not arms["off"].state.model.remat,
          "remat: the arms' models")
    rates, peaks, losses = {"off": [], "on": []}, {"off": [], "on": []}, {"off": [], "on": []}
    for turn in REMAT_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dt, counts, turn_losses, _ = timed_steps(torch, mk, arms[turn])
        check(counts == {k: v * MAIN_STEPS for k, v in POOL_STEP.items()},
              f"remat ({turn} turn): launch counts {counts}")
        for k, v in counts.items():
            launches[k] += v
        rates[turn].append(MAIN_STEPS / dt)
        peaks[turn].append(torch.cuda.max_memory_allocated() - base)
        losses[turn].append(turn_losses)
    diff = max(float(((a - b).abs() / b.abs()).max())
               for a, b in zip(losses["on"], losses["off"]))
    check(diff <= 1e-5, f"remat on and off: losses differ by {diff:.3e} (relative) after "
          f"the same draws")
    ratio = statistics.mean(rates["on"]) / statistics.mean(rates["off"])
    print(f"sequence (c) transformer remat on vs off, turns {REMAT_TURNS}: steps/s off "
          f"{rates['off']}, on {rates['on']}, on/off {ratio:.3f}; peak memory above each "
          f"turn's start off {[p / 2**20 for p in peaks['off']]} MiB, on "
          f"{[p / 2**20 for p in peaks['on']]} MiB; losses on vs off max relative "
          f"difference {diff:.2e} [{card}]")
    for arm in arms.values():
        arm.close()
    del arms
    torch.cuda.empty_cache()
    return {"turns": list(REMAT_TURNS), "rates": rates, "on_over_off": ratio,
            "peak_bytes": peaks, "loss_rel_diff": diff}


def evaluate_predict(torch, card: str, dataset) -> dict:
    """(d) Path A's Trainer after a few steps: ``evaluate`` finite, and
    ``predict`` on the test split ``[N, 10]`` float32 and finite, its
    argmax accuracy ``evaluate``'s exactly; a single ``[T, F]`` sequence
    predicts one row."""
    from mercury_tpu_torch import TrainConfig

    trainer = build_trainer(torch, TrainConfig(**SEQUENCE, model="bilstm_attention"),
                            quiet=True, dataset=dataset)
    warm(trainer)
    t0 = time.perf_counter()
    ev = trainer.evaluate()
    eval_s = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in ev.values()), f"evaluate: {ev}")
    x, y = dataset.x_test, dataset.y_test
    t0 = time.perf_counter()
    logits = trainer.predict(x)
    predict_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (x.shape[0], 10) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"predict: {tuple(logits.shape)}, "
          f"{logits.dtype}")
    acc = int((logits.argmax(-1) == y.cpu().long()).sum()) / x.shape[0]
    check(acc == ev["test/eval_acc"], f"predict's accuracy {acc} vs evaluate's "
          f"{ev['test/eval_acc']}")
    one = trainer.predict(x[0].cpu().numpy())
    check(tuple(one.shape) == (1, 10), f"predict of one [T, F] sequence: {tuple(one.shape)}")
    print(f"sequence (d) bilstm_attention: evaluate {ev} in {eval_s:.3f} s; predict "
          f"{tuple(logits.shape)} in {predict_s:.3f} s, argmax accuracy {acc:.4f} = "
          f"evaluate's [{card}]")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return {"evaluate": ev, "predict_acc": acc, "eval_s": eval_s, "predict_s": predict_s}


def digits_seq_arm(torch, card: str) -> dict:
    """digits_seq (scikit-learn's scans as [64, 1] sequences) with path A:
    a short fit and a finite test accuracy, where scikit-learn imports;
    otherwise a line that says it did not run."""
    try:
        import sklearn.datasets  # noqa: F401
    except ImportError:
        print(f"sequence: scikit-learn does not import here, so bilstm_attention on "
              f"digits_seq was not run [{card}]")
        return {"run": False}
    from mercury_tpu_torch import TrainConfig, Trainer

    # [64, 1] scanlines: the first cells' input kernels are 16× narrower
    # than at synthetic_seq's 16 features, so PARAMETERS does not apply.
    trainer = Trainer(TrainConfig(**DIGITS_SEQ))
    fitted = trainer.fit(steps=DIGITS_SEQ_STEPS)
    acc = float(fitted["test/eval_acc"])
    check(math.isfinite(acc), f"digits_seq: test accuracy {acc}")
    print(f"sequence: bilstm_attention on digits_seq, {DIGITS_SEQ_STEPS} steps, test "
          f"accuracy {acc:.4f} [{card}]")
    trainer.close()
    return {"run": True, "steps": DIGITS_SEQ_STEPS, "test_acc": acc}


def sequence_family_phase(torch, card: str) -> dict:
    """Phase 20: the sequence family on the card at the JAX package's
    default widths. (a) BiLSTM-attention and the Transformer on
    synthetic_seq and ViT on synthetic, each on the pool step with its
    uniform arm in turns; (b) ViT on the fused scoretable step; (c) the
    Transformer with remat against without; (d) evaluate and predict on
    synthetic_seq."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.trainer import build_dataset

    launches, seconds, out = {k: 0 for k in mk.KERNELS}, {}, {"card": card, "pool": {}}
    t0 = time.perf_counter()
    seq = build_dataset(TrainConfig(**SEQUENCE), torch.device("cuda"))
    check(seq.x_train.dtype == torch.float32 and tuple(seq.x_train.shape) == (5000, 32, 16)
          and seq.num_classes == 10, f"synthetic_seq: {seq.x_train.dtype} "
          f"{tuple(seq.x_train.shape)}, {seq.num_classes} classes")
    for model in SEQUENCE_MODELS:
        out["pool"][model] = pool_arm(torch, mk, card, TrainConfig(**SEQUENCE, model=model),
                                      seq, launches, "sequence (a)")
    images = build_dataset(TrainConfig(**VIT), torch.device("cuda"))
    out["pool"]["vit"] = pool_arm(torch, mk, card, TrainConfig(**VIT), images, launches,
                                  "sequence (a)")
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["scoretable"] = table_arm(torch, mk, card, TrainConfig(**VIT_TABLE), images,
                                  launches, "sequence (b)")
    del images
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["remat"] = remat_turns(torch, mk, card, seq, launches)
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["predict"] = evaluate_predict(torch, card, seq)
    out["digits_seq"] = digits_seq_arm(torch, card)
    seconds["d"] = time.perf_counter() - t0
    del seq
    torch.cuda.empty_cache()
    check(all(launches[k] > 0 for k in mk.KERNELS),
          f"sequence family: a kernel of the path never launched: {launches}")
    print("sequence family: seconds by part " + ", ".join(f"({k}) {v:.1f}"
                                                           for k, v in seconds.items()))
    out["seconds"] = seconds
    return {"launches": launches, "summary": out}


# ----------------------------------------------------------------- phase 21
def experts_layer(torch, card: str, dataset) -> dict:
    """(c) The first block's experts on the train forward's tokens (a
    forward hook keeps the input of the step's last forward, after a
    warm-up), in fresh ``MoEMLP`` layers with the block's weights, under
    bf16 autocast: at ``capacity_factor=8`` nothing drops and the output is
    the ``reference()`` oracle's to two bf16 ulps of the oracle's largest
    (``2**-6 · max|ref|``); at 1.0 with ``MOE_TILT`` added to expert 0's
    router bias, exactly the tokens past each bucket's capacity (in token
    order) have zero rows, and every other row is the oracle's to the same
    tolerance. The bucketed forward and the oracle are timed (CUDA
    graphs)."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.models import MoEMLP

    trainer = build_trainer(torch, TrainConfig(**MOE_SEQ), quiet=True, dataset=dataset)
    warm(trainer)
    block = trainer.state.model.blocks[0].moe
    seen = []
    hook = block.register_forward_hook(lambda mod, args, out: seen.append(args[0].detach()))
    try:
        trainer.train_step()
    finally:
        hook.remove()
    x = seen[-1]
    d = x.shape[-1]
    check(x.shape[0] * x.shape[1] == MOE_TOKENS and x.dtype == torch.bfloat16,
          f"experts (c): the train forward's tokens {tuple(x.shape)} {x.dtype}")
    out = {"tokens": MOE_TOKENS}
    for name, factor, tilt in (("room", 8.0, 0.0), ("tilted", 1.0, MOE_TILT)):
        layer = MoEMLP(block.num_experts, d, block.w_up.shape[-1] // d, factor).to(x.device)
        layer.load_state_dict(block.state_dict())
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            layer.gate.bias[0] += tilt
            y, aux = layer(x)
            ref, ref_aux = layer.reference(x)
            expert = layer._route(x.reshape(-1, d).to(torch.bfloat16))[0]
            y_ms = graph_ms(torch, lambda: layer(x))
            ref_ms = graph_ms(torch, lambda: layer.reference(x))
        y, ref = y.float().reshape(-1, d), ref.float().reshape(-1, d)
        cap = layer.capacity(MOE_TOKENS)
        # Each token's place in its expert's bucket, in token order.
        place = torch.zeros_like(expert)
        for e in range(block.num_experts):
            mine = expert == e
            place[mine] = torch.arange(int(mine.sum()), device=x.device)
        over = place >= cap
        zero = (y == 0).all(dim=-1)
        tol = 2.0 ** -6 * ref.abs().max().item()
        err = (y[~over] - ref[~over]).abs().max().item()
        check(torch.equal(zero, over) and bool(over.any()) == (tilt > 0),
              f"experts (c) {name}: {int(zero.sum())} zero rows, {int(over.sum())} tokens "
              f"past capacity {cap}")
        check(bool(ref[over].abs().amax(dim=-1).gt(0).all()) if tilt else True,
              f"experts (c) {name}: a dropped token's oracle row is zero")
        check(err <= tol and torch.equal(aux, ref_aux) and math.isfinite(aux.item()),
              f"experts (c) {name}: max|y − oracle| {err:.3e} > {tol:.3e}, aux {aux.item()} "
              f"vs {ref_aux.item()}")
        out[name] = {"capacity_factor": factor, "capacity": cap, "dropped": int(over.sum()),
                     "max_abs_err": err, "tol": tol, "aux": aux.item(), "ms": y_ms,
                     "oracle_ms": ref_ms}
        print(f"experts (c) {name}: MoEMLP(8, {d}) on the train forward's {MOE_TOKENS} "
              f"tokens, capacity_factor {factor} (C={cap}): {int(over.sum())} dropped, their "
              f"rows exactly zero; max|y − oracle| {err:.2e} (tol {tol:.2e}); aux "
              f"{aux.item():.4f}; bucketed {y_ms:.4f} ms, oracle {ref_ms:.4f} ms [{card}]")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return out


def scan_turns(torch, mk, card: str, launches: dict) -> dict:
    """(d) The main path at ``scan_steps=SCAN_K`` (``train_chunk``) against
    single steps, from the same seed under deterministic cuDNN, in turns
    ``SCAN_TURNS`` of ``SCAN_STEPS`` steps after the same single-step
    warm-up: each arm's losses of its n-th turn equal the other's, the launches a step the pool step's, and after
    the turns the two states' ``state_digests`` equal."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.train.trainer import build_dataset

    undo = deterministic_cudnn(torch)
    try:
        dataset = build_dataset(TrainConfig(**SCAN), torch.device("cuda"))
        arms = {k: build_trainer(torch, TrainConfig(**SCAN, scan_steps=k), quiet=True,
                                 dataset=dataset) for k in (1, SCAN_K)}
        for trainer in arms.values():
            warm(trainer)
        rates = {k: [] for k in arms}
        losses = {k: [] for k in arms}
        for turn in SCAN_TURNS:
            trainer = arms[turn]
            mk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == 1:
                got = torch.stack([trainer.train_step()["train/loss"]
                                   for _ in range(SCAN_STEPS)])
            else:
                got = torch.cat([trainer.train_chunk()["train/loss"]
                                 for _ in range(SCAN_STEPS // turn)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(mk.launch_counts)
            want = {k: v * SCAN_STEPS for k, v in POOL_STEP.items()}
            check(counts == want, f"scan (scan_steps={turn}): launch counts {counts}, "
                  f"expected {want}")
            for k, v in counts.items():
                launches[k] += v
            rates[turn].append(SCAN_STEPS / dt)
            losses[turn].append(got.cpu())
        for a, b in zip(losses[1], losses[SCAN_K]):
            check(torch.equal(a, b) and bool(torch.isfinite(a).all()),
                  f"scan: scan_steps={SCAN_K} losses {b.tolist()} vs single {a.tolist()}")
        digests = {k: state_digests(t.state) for k, t in arms.items()}
        differ = sorted(k for k in digests[1] if digests[1][k] != digests[SCAN_K].get(k))
        check(not differ and digests[1].keys() == digests[SCAN_K].keys(),
              f"scan: state digests differ: {differ[:8]}")
        ratio = statistics.mean(rates[SCAN_K]) / statistics.mean(rates[1])
        print(f"experts (d) scan_steps={SCAN_K} vs 1 on resnet18 under deterministic cuDNN, "
              f"turns {SCAN_TURNS} of {SCAN_STEPS} steps: losses bit-equal, {len(digests[1])} "
              f"state digests equal; steps/s single {rates[1]}, chunked {rates[SCAN_K]}, "
              f"chunked/single {ratio:.3f} [{card}]")
        for trainer in arms.values():
            trainer.close()
        del arms, dataset
        torch.cuda.empty_cache()
    finally:
        undo()
    return {"turns": list(SCAN_TURNS), "steps": SCAN_STEPS, "rates": rates,
            "chunked_over_single": ratio, "digests": len(digests[1])}


def experts_chunks_phase(torch, card: str) -> dict:
    """Phase 21: the mixture of experts and K steps a call. (a) The
    Transformer with ``moe_experts=8`` on synthetic_seq as phase 20's (a);
    (b) ViT with ``moe_experts=8`` on the fused scoretable step; (c) the
    experts' layer against its oracle on the card; (d) ``scan_steps=4``
    against 1 on the main path."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.trainer import build_dataset

    launches, seconds, out = {k: 0 for k in mk.KERNELS}, {}, {"card": card}
    t0 = time.perf_counter()
    seq = build_dataset(TrainConfig(**SEQUENCE), torch.device("cuda"))
    out["pool"] = pool_arm(torch, mk, card, TrainConfig(**MOE_SEQ), seq, launches,
                           "experts (a)")
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    images = build_dataset(TrainConfig(**VIT), torch.device("cuda"))
    out["scoretable"] = table_arm(torch, mk, card, TrainConfig(**MOE_VIT_TABLE), images,
                                  launches, "experts (b)")
    del images
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["layer"] = experts_layer(torch, card, seq)
    del seq
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["scan"] = scan_turns(torch, mk, card, launches)
    seconds["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(all(launches[k] > 0 for k in mk.KERNELS),
          f"experts and chunks: a kernel of the path never launched: {launches}")
    print("experts and chunks: seconds by part " + ", ".join(f"({k}) {v:.1f}"
                                                              for k, v in seconds.items()))
    out["seconds"] = seconds
    return {"launches": launches, "summary": out}


# ------------------------------------------------------------------ phase 22
def counting_by_group(torch, mesh, world: str = "data"):
    """Record each ``torch.distributed`` collective of :data:`MESH_KINDS`
    with its group's name in ``mesh`` (``data``, the second axis's, or
    ``world`` for the default group), the bytes handed in, their dtype and
    its host seconds (gloo returns when done); returns the list and the
    undo."""
    import torch.distributed as dist

    names = {id(None): world}
    if mesh.model is not None:
        names[id(mesh.model.group)] = mesh.axis_names[1]
    if mesh.inner is not None:
        names[id(mesh.inner.group)] = mesh.inner_axis
    calls, originals = [], {k: getattr(dist, k) for k in MESH_KINDS}

    def counter(kind):
        def counted(*args, **kwargs):
            sent = args[0] if kind == "all_reduce" else args[1]
            group = kwargs.get("group")
            t0 = time.perf_counter()
            out = originals[kind](*args, **kwargs)
            calls.append((kind, names.get(id(group), "data"),
                          sent.numel() * sent.element_size(), time.perf_counter() - t0,
                          str(sent.dtype).replace("torch.", "")))
            return out
        return counted

    for kind in MESH_KINDS:
        setattr(dist, kind, counter(kind))

    def undo():
        for kind, fn in originals.items():
            setattr(dist, kind, fn)

    return calls, undo


def requested_bytes(torch) -> int:
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def state_bytes(torch, model, opt) -> dict:
    """A rank's parameter and Adam-moment bytes: what the layout predicts
    (float32 parameters, ``exp_avg`` and ``exp_avg_sq`` of each rank's
    shard: 12 bytes an element, from the unsharded shapes and the split
    dimensions), against the ``requested_bytes`` freed when the rank drops
    ``model``'s parameters and ``opt``'s state (the gradients dropped
    first; both are unusable after)."""
    import gc

    from mercury_tpu_torch.parallel.mesh import sharding_of

    sh = sharding_of(model)
    n, dims = (1, {}) if sh is None else (sh.size, sh.dims)
    whole = {k: p.numel() * (n if k in dims else 1) for k, p in model.named_parameters()}
    predicted = 12 * sum(v // (n if k in dims else 1) for k, v in whole.items())
    # Adam's step counts, where the optimizer keeps them on the card.
    counters = sum(t.numel() * t.element_size() for st in opt.state.values()
                   for key, t in st.items() if key == "step" and t.is_cuda)
    opt.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)

    def settled() -> int:
        # Gloo records a CUDA tensor it sends on its own stream
        # (record_stream), so the allocator frees such a block only when it
        # next processes its events: empty_cache does, after a sync.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return requested_bytes(torch)

    before = settled()
    for p in model.parameters():
        p.data = torch.empty(0, device=p.device)
    opt.state.clear()
    freed = before - settled()
    return {"predicted": predicted + counters, "freed": freed, "whole_parameters": sum(
        whole.values()), "local_parameters": predicted // 12, "step_counter_bytes": counters}


def mesh_arm(torch, mk, config, per_step, label: str, steps: int = MESH_STEPS,
             save: str = "") -> dict:
    """One arm of phases 22 and 23 on this rank: 3 warm-up and ``steps``
    timed steps with the launches and the collectives counted (by kind,
    group and dtype), the digests of the whole model gathered after them,
    the kernels on one step's inputs against their plain versions, a
    kernel step against a plain step (retries agreed across every rank),
    a save into ``save`` if given, then the state's bytes. Prints
    nothing."""
    import torch.distributed as dist

    from mercury_tpu_torch import Trainer
    from mercury_tpu_torch.parallel.collectives import allreduce_sum
    from mercury_tpu_torch.parallel.mesh import full_state_dict

    t0 = time.perf_counter()
    trainer = Trainer(config)
    build_s = time.perf_counter() - t0
    mesh = trainer.mesh
    classes = trainer.dataset.num_classes
    # The warm-up steps (untimed, uncounted), their series kept with the
    # timed steps': the first is taken from the same weights in every arm.
    first = [trainer.train_step() for _ in range(WARMUP_STEPS)]
    calls, undo = counting_by_group(torch, mesh)
    try:
        dt, counts, losses, metrics = timed_steps(torch, mk, trainer, steps)
    finally:
        undo()
    want = {k: v * steps for k, v in per_step.items()}
    check(counts == want, f"{label} rank {mesh.rank}: launch counts {counts}, expected {want}")
    selected = torch.stack([m["sampler/selected"] for m in metrics]).cpu()
    # Every step's (warm-up and timed) held series and selections.
    series = {k: torch.stack([m[k] for m in first + metrics]).float().cpu().tolist()
              for k in MESH_SERIES + ("train/sparse_rate",)}
    every_selected = torch.stack([m["sampler/selected"] for m in first + metrics]).cpu()
    del first, metrics
    by_group = {}
    for kind, group, nbytes, secs, dtype in calls:
        row = by_group.setdefault(f"{kind}/{group}/{dtype}", [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += secs
    by_group = {k: {"calls": c / steps, "bytes": b / steps,
                    "host_ms": s / steps * 1e3} for k, (c, b, s) in by_group.items()}
    full = {k: digest(v) for k, v in full_state_dict(trainer.state.model).items()}
    kernels = step_kernels_vs_plain(torch, mk, trainer, f"{label} rank {mesh.rank}")

    def any_rank(flag: bool) -> bool:
        if not dist.is_initialized():
            return flag
        return bool(allreduce_sum(torch.tensor(float(flag), device=trainer.device)) > 0)

    step_err = kernel_vs_plain_step(torch, trainer, config, any_rank=any_rank, quiet=True)
    if save:
        trainer.save(save)
    torch.cuda.synchronize()
    nbytes = state_bytes(torch, trainer.state.model, trainer.state.optimizer)
    check(nbytes["whole_parameters"] == PARAMETERS[config.model, classes],
          f"{label}: {nbytes['whole_parameters']} parameters unsharded, expected "
          f"{PARAMETERS[config.model, classes]}")
    check(nbytes["freed"] == nbytes["predicted"],
          f"{label} rank {mesh.rank}: {nbytes['freed']} parameter and moment bytes, the "
          f"layout predicts {nbytes['predicted']}")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return {"rank": mesh.rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
            "mesh": dict(mesh.shape), "build_s": build_s, "seconds": dt,
            "steps_per_s": steps / dt, "launches": counts, "losses": losses.tolist(),
            "series": series, "every_selected": every_selected, "full": full,
            "selected": selected, "collectives": by_group, "kernels": kernels,
            "kernel_vs_plain": step_err, "bytes": nbytes}


def mesh_body(jobs, per_step):
    """One gloo rank of phase 22 (run by ``spawn``): each job's arm under
    deterministic cuDNN."""
    import torch

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    undo = deterministic_cudnn(torch)
    try:
        return [mesh_arm(torch, mk, TrainConfig(**kw), per_step, label)
                for label, kw in jobs]
    finally:
        undo()


def mesh_phase(torch, card: str, main_path) -> dict:
    """Phase 22: the mesh (see the module docstring). Spawns two gloo
    process groups on card 0 (NCCL refuses two ranks on one card): four
    ranks for (a)'s W=2 × T=2, then two for (a)'s W=2 × T=1 and (b)'s W=1
    × F=2; (b)'s W=1 runs here, before and after."""
    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.distributed import spawn

    per_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    seconds, arms = {}, {}
    tp = dict(MESH_TP, tensor_parallel=MESH_N)
    fsdp = dict(MESH_FSDP, fsdp_parallel=MESH_N)
    undo = deterministic_cudnn(torch)
    try:
        t0 = time.perf_counter()
        arms["w1_first"] = [mesh_arm(torch, mk, TrainConfig(**MESH_FSDP), per_step, "W=1")]
        seconds["w1_first"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arms["tp"] = [r[0] for r in spawn(mesh_body, 2 * MESH_N, "gloo",
                                          [("W=2 × T=2", tp)], per_step,
                                          devices=[0] * 2 * MESH_N, timeout_s=600)]
        seconds["tp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = spawn(mesh_body, 2, "gloo", [("W=2", MESH_TP), ("W=1 × F=2", fsdp)],
                      per_step, devices=[0, 0], timeout_s=600)
        arms["dp"], arms["fsdp"] = [r[0] for r in pairs], [r[1] for r in pairs]
        seconds["dp_fsdp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arms["w1_second"] = [mesh_arm(torch, mk, TrainConfig(**MESH_FSDP), per_step, "W=1")]
        seconds["w1_second"] = time.perf_counter() - t0
    finally:
        undo()
    # The model groups' selections, bit for bit.
    for name in ("tp", "fsdp"):
        ranks = arms[name]
        for r in ranks:
            first = ranks[r["data_rank"] * MESH_N]
            check(torch.equal(r["selected"], first["selected"]),
                  f"mesh {name}: rank {r['rank']} selected other indices than rank "
                  f"{first['rank']}")
    # The sharded arms against the unsharded arms. (a) In float32, while
    # every worker's T=2 ranks draw the indices its T=1 rank draws: each
    # step's pool loss (scored before the draw, so the first step whose
    # draws differ too), loss and gradient norm to MESH_TP_RTOL (the
    # row-parallel sums reassociate float32). Those rounding differences
    # grow with the steps until a score near a CDF boundary draws another
    # sample, after which the arms train apart; the draws must agree
    # through the warm-up steps at least. (b) Every timed loss to rtol 1e-5.
    steps = WARMUP_STEPS + MESH_STEPS
    apart = [next((i for i, (a, b) in enumerate(zip(r["every_selected"],
                                                    arms["dp"][r["data_rank"]]["every_selected"]))
                   if not torch.equal(a, b)), steps) for r in arms["tp"]]
    held = min(apart)
    errs = {}
    for r in arms["tp"]:
        base = arms["dp"][r["data_rank"]]
        for key in MESH_SERIES:
            n = min(held + 1, steps) if key == "train/pool_loss" else held
            err = max(abs(a - b) / abs(b) for a, b in zip(r["series"][key][:n],
                                                          base["series"][key][:n]))
            errs[f"tp_{key}"] = max(errs.get(f"tp_{key}", 0.0), err)
    errs["tp_trained_losses"] = max(abs(a - b) / abs(b) for r in arms["tp"] for a, b in zip(
        r["series"]["train/loss"], arms["dp"][r["data_rank"]]["series"]["train/loss"]))
    errs["fsdp_losses"] = max(abs(a - b) / abs(b) for r in arms["fsdp"] for a, b in
                              zip(r["losses"], arms["w1_first"][0]["losses"]))
    print(f"mesh, sharded against unsharded: (a) the first step whose draws differ, by T=2 "
          f"rank: {apart} of {steps}; over the {held} steps before it, max rel " + ", ".join(
              f"{key} {errs[f'tp_{key}']:.2e}" for key in MESH_SERIES)
          + f" (all {steps} losses, printed, not held: up to rel "
          f"{errs['tp_trained_losses']:.2e}); (b) {MESH_STEPS} losses max rel "
          f"{errs['fsdp_losses']:.2e}")
    for name in ("tp", "dp"):
        r = arms[name][0]
        print(f"mesh {name} rank 0: first steps' " + "; ".join(
            f"{key} {[round(v, 6) for v in r['series'][key][:held + 1]]}"
            for key in MESH_SERIES))
    check(held >= WARMUP_STEPS, f"mesh tp: T=2 ranks drew other indices than T=1 from "
          f"step {held} (by rank {apart}), before the {WARMUP_STEPS} warm-up steps ended")
    for key in MESH_SERIES:
        check(errs[f"tp_{key}"] <= MESH_TP_RTOL, f"mesh tp: {key} rel "
              f"{errs[f'tp_{key}']:.2e} against T=1 over {held} steps, rtol {MESH_TP_RTOL}")
    check(errs["fsdp_losses"] <= 1e-5, f"mesh fsdp: losses rel {errs['fsdp_losses']:.2e} "
          f"against W=1, rtol 1e-5")
    check(arms["w1_first"][0]["losses"] == arms["w1_second"][0]["losses"],
          "mesh: the two W=1 turns' losses differ")
    launches = {k: 0 for k in mk.KERNELS}
    for name in ("tp", "dp", "fsdp", "w1_first", "w1_second"):
        for r in arms[name]:
            for k, v in r["launches"].items():
                launches[k] += v
            e = r["kernel_vs_plain"]
            b = r["bytes"]
            print(f"mesh {name} rank {r['rank']} (worker {r['data_rank']}, shard "
                  f"{r['model_rank']}, mesh {r['mesh']}): {MESH_STEPS} steps in "
                  f"{r['seconds']:.3f} s = {r['steps_per_s']:.2f} steps/s [{card}]; losses "
                  f"first {r['losses'][0]:.6f}, last {r['losses'][-1]:.6f}; launches "
                  f"{r['launches']}; kernel step vs plain step |d loss| "
                  f"{e['train/loss']:.2e} ({e['band_misses']} band retries); "
                  f"parameter+moment bytes {b['freed']} (layout {b['predicted']}, "
                  f"{b['local_parameters']} of {b['whole_parameters']} parameters)")
            print(f"  collectives a step: " + "; ".join(
                f"{k} {v['calls']:g} calls, {v['bytes'] / 1e6:.3f} MB, {v['host_ms']:.2f} ms"
                for k, v in sorted(r["collectives"].items())) if r["collectives"]
                else "  collectives a step: none")
            print("  kernels on the step's inputs: " + ", ".join(
                f"{k} {c['shape']} {c['max_abs_err']:.2e}"
                for k, v in r["kernels"].items() for c in v))
    check(all(launches[k] > 0 for k in ("nll_fwd", "nll_bwd", "score_and_draw")),
          f"mesh: a kernel of the path never launched: {launches}")
    rate = {name: statistics.mean(r["steps_per_s"] for r in arms[name]) for name in arms}
    print(f"mesh steps/s a rank (mean over ranks), one turn each in the order W=1, "
          f"W=2×T=2, W=2 and W=1×F=2, W=1: " + ", ".join(f"{k} {v:.2f}"
                                                      for k, v in rate.items())
          + f"; T=2/T=1 {rate['tp'] / rate['dp']:.3f}, F=2/W=1 "
          f"{rate['fsdp'] / statistics.mean([rate['w1_first'], rate['w1_second']]):.3f} "
          f"[{card}]")
    print(f"mesh seconds by part " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    summary = {name: [{k: v for k, v in r.items() if k not in ("selected", "every_selected")}
                      for r in ranks] for name, ranks in arms.items()}
    summary.update(seconds=seconds, loss_rel_err=errs, steps_per_s=rate, card=card)
    return {"launches": launches, "summary": summary}


# ------------------------------------------------------------------ phase 23
def wires_body(per_step, directory):
    """One gloo rank of phase 23 (a) (run by ``spawn``): each gradient
    wire's arm of the Transformer at W=2 × T=2, the "none" arm saved into
    ``directory``."""
    import torch

    from mercury_tpu_torch import TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk

    undo = deterministic_cudnn(torch)
    try:
        return [mesh_arm(torch, mk, TrainConfig(**dict(
            MESH_TP, tensor_parallel=MESH_N, grad_compression=wire)), per_step,
            f"W=2 × T=2 {wire}", steps=COMP_STEPS, save=directory if wire == "none" else "")
            for wire in COMP_WIRES]
    finally:
        undo()


def async_fsdp_arm(torch, mk) -> dict:
    """Phase 23 (b) on this rank: ResNet-18 at W=1 × F=2 on the fused
    scoretable under async refresh (the host fleet, one worker, on the
    model group's first rank): 3 warm-up and COMP_STEPS timed steps with
    the launches counted, each step's table kept, the chunks applied and
    their ages, one more step with its launches' shapes, the scorer's own
    launches and threads."""
    import threading

    from mercury_tpu_torch import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(**COMP_ASYNC))
    fleet = trainer._scorer_fleet
    applied = []
    apply = trainer._apply_chunks

    def recorded(chunks, step):
        applied.extend((step, c.step) for c in chunks)
        apply(chunks, step)

    trainer._apply_chunks = recorded
    warm(trainer)
    scorer_before = None if fleet is None else dict(fleet.launch_counts)
    mk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, losses = [], []
    for _ in range(COMP_STEPS):
        m = trainer.train_step()
        tables.append(trainer.state.scoretable.scores.clone())
        losses.append(m["train/loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mk.launch_counts)
    seen, undo = record_kernel_inputs(mk, ("nll_fwd_kernel", "table_refresh_draw_kernel",
                                           "augment_normalize_kernel"))
    try:
        trainer.train_step()
        torch.cuda.synchronize()
    finally:
        undo()
    # nll_fwd's logits, the table and its refresh slots, the ingest's crops
    # and its rows.
    shapes = ([("nll_fwd_kernel", list(z.shape)) for z, _ in seen["nll_fwd_kernel"]]
              + [("table_refresh_draw_kernel", [a[0].numel(), a[1].numel()])
                 for a in seen["table_refresh_draw_kernel"]]
              + [("augment_normalize_kernel", [a[3].shape[0], a[7] is not None])
                 for a in seen["augment_normalize_kernel"]])
    scorer = (None if fleet is None else
              {k: v - scorer_before[k] for k, v in fleet.launch_counts.items()})
    out = {"rank": trainer.mesh.rank, "model_rank": trainer.mesh.model_rank,
           "seconds": dt, "steps_per_s": COMP_STEPS / dt, "launches": counts,
           "tables": [digest(t) for t in tables],
           "losses": torch.stack(losses).float().cpu().tolist(), "applied": applied,
           "shapes": shapes, "scorer_launches": scorer,
           "scorer_threads": sorted(t.name for t in threading.enumerate()
                                    if t.name.startswith("mercury-scorer")),
           "fleet": None if fleet is None else fleet.summary()}
    trainer.close()
    return out


def elastic_tp_arm(torch, mk, directory: str, tp: int) -> dict:
    """Phase 23 (c) on this rank (``tp=1``: in the script's process): phase
    22's Transformer at W=1 × T=``tp`` restores ``directory``'s W=2 × T=2
    file elastically, gathers the whole model and Adam state (digests) and
    the EMA, then takes COMP_RESTORED_STEPS steps with the launches
    counted."""
    from mercury_tpu_torch import TrainConfig, Trainer
    from mercury_tpu_torch.parallel.mesh import full_optimizer_state, full_state_dict

    config = dict(MESH_TP, world_size=1)
    if tp > 1:
        config["tensor_parallel"] = tp
    trainer = Trainer(TrainConfig(**config))
    step = trainer.restore_elastic(directory)
    state = trainer.state
    adam = full_optimizer_state(state.model, state.optimizer.state_dict())["state"]
    out = {"rank": trainer.mesh.rank, "step": step,
           "model": {k: digest(v) for k, v in full_state_dict(state.model).items()},
           "adam": {f"{i}.{k}": digest(v) for i, st in adam.items() for k, v in st.items()
                    if torch.is_tensor(v)},
           "ema": (float(state.ema.value), int(state.ema.count))}
    dt, counts, losses, metrics = timed_steps(torch, mk, trainer, COMP_RESTORED_STEPS)
    out.update(launches=counts, losses=losses.tolist(),
               selected=torch.stack([m["sampler/selected"] for m in metrics]).cpu())
    trainer.close()
    return out


def compositions_body(directory):
    """One gloo rank of phase 23 (b) and (c) (run by ``spawn``)."""
    import torch

    from mercury_tpu_torch.ops import mercury_kernels as mk

    undo = deterministic_cudnn(torch)
    try:
        return [async_fsdp_arm(torch, mk), elastic_tp_arm(torch, mk, directory, MESH_N)]
    finally:
        undo()


def file_digests(torch, directory: str) -> dict:
    """The digests of the newest checkpoint's model and Adam state, and
    its rank rows' EMAs."""
    from mercury_tpu_torch.train import checkpoint

    raw = torch.load(os.path.join(directory, f"ckpt_{checkpoint.latest_step(directory)}.pt"),
                     weights_only=False, map_location="cpu")
    return {"model": {k: digest(v) for k, v in raw["model"].items()},
            "adam": {f"{i}.{k}": digest(v) for i, st in raw["optimizer"]["state"].items()
                     for k, v in st.items() if torch.is_tensor(v)},
            "ema": [(float(r["ema_value"]), int(r["ema_count"])) for r in raw["ranks"]],
            "step": raw["step"]}


def wire_arms_checks(torch, arms, card: str) -> dict:
    """Phase 23 (a)'s checks across ranks and arms; prints each rank's
    line and returns the steps/s a rank by wire."""
    rate = {}
    for i, wire in enumerate(COMP_WIRES):
        ranks = [r[i] for r in arms]
        first = ranks[0]
        for r in ranks:
            lead = ranks[r["data_rank"] * MESH_N]
            check(torch.equal(r["every_selected"], lead["every_selected"]),
                  f"{wire}: rank {r['rank']} selected other indices than rank {lead['rank']}")
            check(r["full"] == first["full"], f"{wire}: rank {r['rank']}'s whole parameters "
                  f"differ from rank 0's after the steps")
            b = r["bytes"]
            check(b["freed"] == b["predicted"] == COMP_TP_BYTES,
                  f"{wire} rank {r['rank']}: {b['freed']} parameter and moment bytes, the "
                  f"layout predicts {b['predicted']}, phase 22 read {COMP_TP_BYTES}")
            data = {k: v for k, v in r["collectives"].items() if k.split("/")[1] == "data"}
            kinds = {k.split("/")[0] + "/" + k.split("/")[2]: v["calls"] for k, v in data.items()}
            if wire == "int8":
                want = {"all_to_all_single/int8": 1, "all_to_all_single/float32": 1,
                        "all_gather_into_tensor/int8": 1, "all_gather_into_tensor/float32": 1}
                check(all(kinds.get(k) == v for k, v in want.items()),
                      f"int8 rank {r['rank']}: the data group's collectives a step {kinds}")
            else:
                check(not [k for k in kinds if not k.startswith("all_reduce/float32")],
                      f"{wire} rank {r['rank']}: the data group's collectives a step {kinds}")
            rates = r["series"]["train/sparse_rate"]
            check((wire == "stochastic") == all(x < 1.0 for x in rates),
                  f"{wire} rank {r['rank']}: train/sparse_rate {rates}")
            e = r["kernel_vs_plain"]
            print(f"compositions (a) {wire} rank {r['rank']} (worker {r['data_rank']}, shard "
                  f"{r['model_rank']}): {COMP_STEPS} steps in {r['seconds']:.3f} s = "
                  f"{r['steps_per_s']:.2f} steps/s [{card}]; losses first "
                  f"{r['losses'][0]:.6f}, last {r['losses'][-1]:.6f}; sparse rate last "
                  f"{rates[-1]:.6f}; launches {r['launches']}; kernel step vs plain step "
                  f"|d loss| {e['train/loss']:.2e}; bytes {b['freed']}")
            print("  collectives a step: " + "; ".join(
                f"{k} {v['calls']:g} calls, {v['bytes'] / 1e6:.6f} MB, {v['host_ms']:.2f} ms"
                for k, v in sorted(r["collectives"].items())))
        rate[wire] = statistics.mean(r["steps_per_s"] for r in ranks)
    return rate


def mesh_compositions_phase(torch, card: str, main_path) -> dict:
    """Phase 23: what a second axis runs since the mesh's slice (see the
    module docstring). Two gloo process groups on card 0: four ranks for
    (a), two for (b) and (c); (c)'s W=1 restore runs here."""
    import tempfile

    import numpy as np

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.distributed import spawn

    per_step = {k: v // MAIN_STEPS for k, v in main_path["launches"].items()}
    seconds = {}
    directory = tempfile.mkdtemp(prefix="mesh_compositions_")
    undo = deterministic_cudnn(torch)
    try:
        t0 = time.perf_counter()
        wires = spawn(wires_body, 2 * MESH_N, "gloo", per_step, directory,
                      devices=[0] * 2 * MESH_N, timeout_s=600)
        seconds["wires"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pair = spawn(compositions_body, MESH_N, "gloo", directory, devices=[0] * MESH_N,
                     timeout_s=600)
        seconds["async_elastic"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = elastic_tp_arm(torch, mk, directory, 1)
        seconds["elastic_w1"] = time.perf_counter() - t0
        saved = file_digests(torch, directory)
    finally:
        undo()
        shutil.rmtree(directory, ignore_errors=True)
    launches = {k: 0 for k in mk.KERNELS}
    for rank in wires:
        for arm in rank:
            want = {k: v * COMP_STEPS for k, v in per_step.items()}
            check(arm["launches"] == want, f"compositions (a) rank {arm['rank']}: launches "
                  f"{arm['launches']}, expected {want}")
            for k, v in arm["launches"].items():
                launches[k] += v
    rate = wire_arms_checks(torch, wires, card)
    # (b) async under FSDP.
    asyncs = [r[0] for r in pair]
    lead, other = asyncs
    want = {k: v * COMP_STEPS for k, v in ASYNC_STEP.items()}
    classes = 10
    for r in asyncs:
        check(r["launches"] == want, f"compositions (b) rank {r['rank']}: launches "
              f"{r['launches']}, expected {want}")
        shapes = sorted(r["shapes"])
        check(shapes == sorted([("augment_normalize_kernel", [32, True]),
                                ("nll_fwd_kernel", [32, classes]),
                                ("table_refresh_draw_kernel", [5000, 1])]),
              f"compositions (b) rank {r['rank']}: a step's launches {shapes}")
        for k, v in r["launches"].items():
            launches[k] += v
    check(lead["tables"] == other["tables"], "compositions (b): the two ranks' score "
          "tables differ after a step")
    check(lead["losses"] == other["losses"] and lead["applied"] == other["applied"],
          "compositions (b): the two ranks' losses or applied chunks differ")
    check(lead["scorer_launches"] is not None and other["scorer_launches"] is None
          and not other["scorer_threads"] and lead["scorer_threads"],
          f"compositions (b): scorer threads {lead['scorer_threads']} and "
          f"{other['scorer_threads']}")
    check(lead["applied"], "compositions (b): no chunk applied in 3 + 11 steps")
    ages = [step - chunk for step, chunk in lead["applied"]]
    print(f"compositions (b) async under FSDP (W=1 × F=2, ResNet-18, fused scoretable): "
          f"{COMP_STEPS} steps in {lead['seconds']:.3f} | {other['seconds']:.3f} s = "
          f"{lead['steps_per_s']:.2f} | {other['steps_per_s']:.2f} steps/s a rank [{card}]; "
          f"launches a rank {lead['launches']}; a step's shapes {sorted(lead['shapes'])}; "
          f"tables bit-equal at all {COMP_STEPS} steps; {len(lead['applied'])} chunks "
          f"applied (tick step, snapshot step) {lead['applied']}, ages {ages}; the "
          f"scorer's own launches {lead['scorer_launches']} on rank 0 alone, threads "
          f"{lead['scorer_threads']} | {other['scorer_threads']}")
    # (c) restore_elastic into TP.
    restored = [r[1] for r in pair]
    ema_want = (float(np.mean(np.asarray([e for e, _ in saved["ema"]], np.float32))),
                max(c for _, c in saved["ema"]))
    for r in restored + [one]:
        check(r["step"] == saved["step"] and r["model"] == saved["model"]
              and r["adam"] == saved["adam"], f"compositions (c) rank {r['rank']}: the "
              f"gathered state differs from the file's")
        check(r["ema"] == ema_want, f"compositions (c): EMA {r['ema']}, the rows' mean "
              f"{ema_want}")
        want = {k: v * COMP_RESTORED_STEPS for k, v in per_step.items()}
        check(r["launches"] == want, f"compositions (c): launches {r['launches']}, "
              f"expected {want}")
    for k, v in restored[0]["launches"].items():
        launches[k] += v + restored[1]["launches"][k]
    check(torch.equal(restored[0]["selected"], restored[1]["selected"]),
          "compositions (c): the model group's ranks selected other indices")
    err = max(abs(a - b) / abs(b) for r in restored for a, b in zip(r["losses"], one["losses"]))
    check(err <= COMP_RESTORE_RTOL, f"compositions (c): losses rel {err:.2e} against the "
          f"W=1 restore, rtol {COMP_RESTORE_RTOL}")
    print(f"compositions (c) restore_elastic of the W=2 × T=2 file (step {saved['step']}, "
          f"{len(saved['ema'])} rows) at W=1 × T=2: {len(saved['model'])} model and "
          f"{len(saved['adam'])} Adam tensors equal the file's by sha256 on both ranks and "
          f"at W=1; EMA {restored[0]['ema']} (the rows' mean); {COMP_RESTORED_STEPS} losses "
          f"{restored[0]['losses']} against W=1 {one['losses']}, max rel {err:.2e}")
    check(all(launches[k] > 0 for k in mk.KERNELS if k != "score_and_draw")
          and launches["score_and_draw"] > 0,
          f"compositions: a kernel of the paths never launched: {launches}")
    print(f"compositions steps/s a rank (mean over ranks), one turn each: " + ", ".join(
        f"{k} {v:.2f}" for k, v in rate.items()) + f"; int8/none "
          f"{rate['int8'] / rate['none']:.3f}, stochastic/none "
          f"{rate['stochastic'] / rate['none']:.3f} [{card}]")
    print("compositions seconds by part " + ", ".join(f"{k} {v:.1f}"
                                                    for k, v in seconds.items()))
    summary = {"wires": [[{k: v for k, v in a.items() if k not in ("selected", "every_selected")}
                          for a in rank] for rank in wires],
               "async": asyncs, "elastic": [{k: v for k, v in r.items() if k != "selected"}
                                            for r in restored],
               "elastic_w1_losses": one["losses"], "loss_rel_err": err,
               "steps_per_s": rate, "seconds": seconds, "card": card}
    return {"launches": launches, "summary": summary}


# ------------------------------------------------------------------ phase 24
def sp_model(torch, kw: dict, sp: bool):
    """Phase 20's Transformer (d_model 128, 4 heads, 2 blocks) on
    ``synthetic_seq``'s [32, 16] samples from seed 0, with ``kw``'s
    ``sp_impl`` and ``causal``, built with ``sp_axis="seq"`` if ``sp``."""
    from mercury_tpu_torch.models import create_model

    kw = dict(kw)
    impl = kw.pop("sp_impl")
    model = create_model("transformer", 10, torch.Generator().manual_seed(0), (32, 16),
                         sp_axis="seq" if sp else None, sp_impl=impl, **kw)
    n = sum(p.numel() for p in model.parameters())
    check(n == PARAMETERS["transformer", 10], f"sequence parallelism: {n} parameters")
    return model


def sp_data(torch, dev):
    """``synthetic_seq``'s train split on ``dev``: [5000, 32, 16] float32
    and int32 labels."""
    from mercury_tpu_torch.data.cifar import synthetic_sequences

    (x, y), _ = synthetic_sequences(10, 5000, 1000, seed=0)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev, dtype=torch.int32))


def counted_steps(torch, mk, mesh, step, steps: int, label: str, rows: int = 32):
    """``step()`` (one Mercury step at batch 32 and a pool of 320,
    returning its metrics) on this rank of ``mesh``: once with the kernels'
    inputs recorded, their shapes held to the pool step's (the NLL's on
    ``rows`` of the batch and ten times as many of the pool) and each kernel
    held to its plain version on them (:func:`kernels_vs_plain`), then
    ``WARMUP_STEPS − 1`` more and ``steps`` timed steps with the launches
    (held to 2/1/1 a step) and the collectives (by kind, group and dtype)
    counted. Returns every step's metrics, the launches, the collectives a
    step and the seconds. Phases 24-26."""
    seen, undo = record_kernel_inputs(mk)
    try:
        metrics = [step()]
    finally:
        undo()
    shapes = {k: sorted(list(a[0].shape) if k != "score_and_draw_kernel"
                        else [a[0].numel(), a[2].numel()] for a in v) for k, v in seen.items()}
    want = {"nll_fwd_kernel": [[rows, 10], [10 * rows, 10]], "nll_bwd_kernel": [[rows, 10]],
            "score_and_draw_kernel": [[320, 32]]}
    check(shapes == want, f"{label} rank {mesh.rank}: a step's kernel shapes {shapes}")
    kernels_vs_plain(torch, mk, seen, f"{label} rank {mesh.rank}")
    metrics += [step() for _ in range(WARMUP_STEPS - 1)]
    calls, undo = counting_by_group(torch, mesh, world="world")
    try:
        mk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics += [step() for _ in range(steps)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(mk.launch_counts)
    finally:
        undo()
    want = {k: v * steps for k, v in POOL_STEP.items()}
    check(counts == want, f"{label} rank {mesh.rank}: launches {counts}, expected {want}")
    losses = torch.stack([m["train/loss"] for m in metrics]).cpu()
    check(bool(torch.isfinite(losses).all()), f"{label}: losses {losses.tolist()}")
    for m in metrics:
        check(0.0 < float(m["sampler/ess"]) <= 1.0 and math.isfinite(float(
            m["train/grad_norm"])), f"{label}: telemetry {m}")
    by_group = {}
    for kind, group, nbytes, _, dtype in calls:
        row = by_group.setdefault(f"{kind}/{group}/{dtype}", [0, 0])
        row[0] += 1
        row[1] += nbytes
    return metrics, counts, {k: {"calls": c / steps, "bytes": b / steps}
                             for k, (c, b) in by_group.items()}, dt


def sp_arm(torch, mk, mesh, kw: dict, sp: bool, label: str) -> dict:
    """One arm of phase 24 on this rank of ``mesh``: the Mercury step of
    ``train/sp_step.py`` (telemetry on, Adam at lr 1e-3, batch 32, a pool of
    320) for 3 warm-up and ``SP_STEPS`` timed steps (:func:`counted_steps`).
    Returns every step's losses and selections, the EMA, the launches, the
    collectives a step and the seconds."""
    from mercury_tpu_torch.parallel.distributed import device
    from mercury_tpu_torch.train.sp_step import init_sp_mercury_state, make_dp_sp_mercury_step

    dev = device()
    x, y = sp_data(torch, dev)
    model = sp_model(torch, kw, sp)
    opt = torch.optim.Adam(model.parameters(), lr=SP_LR)
    state = init_sp_mercury_state(model, opt, mesh, x.shape[0], seed=0, device=dev)
    step = make_dp_sp_mercury_step(model, mesh, SP_BATCH, SP_PRESAMPLE, telemetry=True)
    metrics, counts, collectives, dt = counted_steps(
        torch, mk, mesh, lambda: step(state, x, y)[1], SP_STEPS, label)
    return {"rank": mesh.rank, "data_rank": mesh.data_rank, "seq_rank": mesh.model_rank,
            "losses": torch.stack([m["train/loss"] for m in metrics]).cpu().tolist(),
            "selected": torch.stack([m["sampler/selected"] for m in metrics]).cpu(),
            "ema": state.ema.value.item(), "launches": counts, "seconds": dt,
            "collectives": collectives}


def sp_long_inputs(torch, causal_zigzag: bool):
    """(c)'s q, k, v and the cotangent, [2, 4096, 4, 32] float32 on the
    host from seed 24, in the zigzag layout of S=2 if asked."""
    from mercury_tpu_torch.parallel.sequence import zigzag_order

    b, l, h, d = SP_LONG
    gen = torch.Generator().manual_seed(24)
    ts = [torch.randn((b, l, h, d), generator=gen) for _ in range(4)]
    if causal_zigzag:
        perm = torch.as_tensor(zigzag_order(l, SP_S))
        ts = [t[:, perm] for t in ts]
    return ts


def sp_long(torch, impl: str, causal: bool, group) -> dict:
    """(c) on this rank (or with ``group`` None, dense attention on the
    whole sequence): the forward's peak memory above what was allocated
    before it (``max_memory_allocated``), the median of ``SP_LONG_REPEATS``
    forwards and backwards (host clock around synchronized work), and the
    output and gradients on the host."""
    from mercury_tpu_torch.parallel.distributed import device
    from mercury_tpu_torch.parallel.sequence import attention, dense_attention

    dev = device()
    q, k, v, ct = sp_long_inputs(torch, impl == "zigzag")
    if group is not None:
        q, k, v, ct = (t.chunk(SP_S, dim=1)[group.rank].contiguous() for t in (q, k, v, ct))
    q, k, v, ct = (t.to(dev) for t in (q, k, v, ct))

    def forward(q, k, v):
        if group is None:
            return dense_attention(q, k, v, causal=causal)
        return attention(q, k, v, causal=causal, sp_axis="seq", sp_impl=impl, group=group)

    fwd, bwd, peak = [], [], []
    for _ in range(SP_LONG_REPEATS + 1):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = forward(*leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak.append(torch.cuda.max_memory_allocated() - base)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    out_cpu = out.detach().cpu()
    grads = [t.grad.cpu() for t in leaves]
    del out, leaves
    torch.cuda.empty_cache()
    # The first round builds the caches; the medians are the others'.
    return {"impl": impl, "causal": causal, "forward_peak_bytes": max(peak[1:]),
            "forward_ms": statistics.median(fwd[1:]), "backward_ms": statistics.median(bwd[1:]),
            "out": out_cpu, "grads": grads}


def sp_body(arms):
    """One gloo rank of phase 24 (a) and (c) (run by ``spawn``): the
    W=1 × S=2 mesh, each arm of ``arms`` under deterministic cuDNN, then
    each attention of (c) at L=4096."""
    import torch

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh

    mesh = make_tp_mesh(1, SP_S, "data", "seq")
    undo = deterministic_cudnn(torch)
    try:
        out = {name: sp_arm(torch, mk, mesh, SP_ARMS[name], True, f"sp (a) {name}")
               for name in arms}
    finally:
        undo()
    out["long"] = [sp_long(torch, impl, causal, mesh.model) for impl, causal in SP_LONG_IMPLS]
    return out


def sp_grid_body():
    """One gloo rank of phase 24 (b): the ring at W=2 × S=2."""
    import torch

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh

    mesh = make_tp_mesh(2, SP_S, "data", "seq")
    undo = deterministic_cudnn(torch)
    try:
        return sp_arm(torch, mk, mesh, SP_ARMS["ring"], True, "sp (b) ring W=2 × S=2")
    finally:
        undo()


def sequence_parallel_phase(torch, card: str) -> dict:
    """Phase 24: sequence parallelism (see the module docstring). Two gloo
    process groups on card 0: two ranks for (a)'s three arms and (c), four
    for (b); (a)'s S=1 arms and (c)'s dense attention run here."""
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.distributed import spawn
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh
    from mercury_tpu_torch.parallel.sequence import zigzag_inverse

    seconds = {}
    t0 = time.perf_counter()
    pair = spawn(sp_body, SP_S, "gloo", tuple(SP_ARMS), devices=[0] * SP_S, timeout_s=600)
    seconds["s2_and_long"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = spawn(sp_grid_body, 2 * SP_S, "gloo", devices=[0] * 2 * SP_S, timeout_s=600)
    seconds["w2_s2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_mesh = make_tp_mesh(1, 1, "data", "seq")
    undo = deterministic_cudnn(torch)
    try:
        one = {c: sp_arm(torch, mk, one_mesh, dict(sp_impl="ring", causal=c), False,
                         f"sp S=1 {'causal' if c else 'full'}") for c in (False, True)}
    finally:
        undo()
    dense = {c: sp_long(torch, "dense", c, None) for c in (False, True)}
    seconds["s1_and_dense"] = time.perf_counter() - t0
    launches = {k: 0 for k in mk.KERNELS}
    for r in [a for rank in pair for name, a in rank.items() if name != "long"] + grid \
            + list(one.values()):
        for k, v in r["launches"].items():
            launches[k] += v
    # (a) S=2 against S=1 from the same weights and draws.
    rows = {}
    for name, kw in SP_ARMS.items():
        base = one[bool(kw.get("causal"))]
        for rank in pair:
            a = rank[name]
            rel = abs(a["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
            check(rel <= 1e-5, f"sp (a) {name} rank {a['rank']}: step 1's loss "
                  f"{a['losses'][0]} against S=1's {base['losses'][0]}, rel {rel:.2e}")
            check(torch.equal(a["selected"][0], base["selected"][0]),
                  f"sp (a) {name} rank {a['rank']}: step 1 selected other indices than S=1")
        a0, a1 = pair[0][name], pair[1][name]
        check(torch.equal(a0["selected"], a1["selected"]) and a0["losses"] == a1["losses"],
              f"sp (a) {name}: the two seq ranks drew or trained apart")
        steps = len(base["losses"])
        apart = next((i for i in range(steps) if not torch.equal(a0["selected"][i],
                                                                 base["selected"][i])), steps)
        rows[name] = {"first_rel": abs(a0["losses"][0] - base["losses"][0])
                      / abs(base["losses"][0]), "parts_at_step": apart + 1 if apart < steps
                      else None, "losses": a0["losses"], "s1_losses": base["losses"],
                      "steps_per_s": [SP_STEPS / r[name]["seconds"] for r in pair],
                      "collectives": a0["collectives"]}
        print(f"sp (a) {name} ({'causal' if kw.get('causal') else 'full'}) W=1 × S=2 against "
              f"S=1: step 1 loss rel {rows[name]['first_rel']:.2e}, selections "
              + (f"first part at step {apart + 1} of {steps}" if apart < steps else
                 f"equal at all {steps} steps")
              + f"; losses first {a0['losses'][0]:.6f} last {a0['losses'][-1]:.6f} (S=1 "
              f"{base['losses'][-1]:.6f}); launches a rank {a0['launches']}; "
              f"{rows[name]['steps_per_s'][0]:.2f} steps/s a rank (S=1 "
              f"{SP_STEPS / base['seconds']:.2f}) [{card}]")
        print("  collectives a step a rank: " + "; ".join(
            f"{k} {v['calls']:g} calls, {v['bytes']:,.0f} bytes"
            for k, v in sorted(a0["collectives"].items())))
    # (b) W=2 × S=2: one EMA, and each seq group's ranks drawing alike.
    check(len({r["ema"] for r in grid}) == 1, f"sp (b): EMAs {[r['ema'] for r in grid]}")
    for r in grid:
        peer = grid[r["data_rank"] * SP_S]
        check(torch.equal(r["selected"], peer["selected"]) and r["losses"] == peer["losses"],
              f"sp (b): rank {r['rank']} drew or trained apart from rank {peer['rank']}")
    check(not torch.equal(grid[0]["selected"], grid[SP_S]["selected"]),
          "sp (b): the two workers drew the same indices")
    print(f"sp (b) ring W=2 × S=2: EMA {grid[0]['ema']:.6f} on all four ranks, each seq "
          f"group's selections equal at all {WARMUP_STEPS + SP_STEPS} steps; losses first "
          f"{grid[0]['losses'][0]:.6f} last {grid[0]['losses'][-1]:.6f}; "
          + ", ".join(f"rank {r['rank']} {SP_STEPS / r['seconds']:.2f} steps/s" for r in grid)
          + f" [{card}]")
    print("  collectives a step a rank: " + "; ".join(
        f"{k} {v['calls']:g} calls, {v['bytes']:,.0f} bytes"
        for k, v in sorted(grid[0]["collectives"].items())))
    # (c) the attentions alone at L=4096 against dense attention.
    long_rows = []
    inv = torch.as_tensor(zigzag_inverse(SP_LONG[1], SP_S))
    for i, (impl, causal) in enumerate(SP_LONG_IMPLS):
        parts = [rank["long"][i] for rank in pair]
        want = dense[causal]
        out = torch.cat([p["out"] for p in parts], dim=1)
        grads = [torch.cat([p["grads"][j] for p in parts], dim=1) for j in range(3)]
        if impl == "zigzag":
            out, grads = out[:, inv], [g[:, inv] for g in grads]
        err = float((out - want["out"]).abs().max())
        gerr = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
                   for g, w in zip(grads, want["grads"]))
        check(err <= SP_LONG_ATOL, f"sp (c) {impl}: output max |err| {err:.2e} against "
              f"dense, atol {SP_LONG_ATOL}")
        check(gerr <= SP_LONG_GRAD_RTOL, f"sp (c) {impl}: gradients max |err| {gerr:.2e} "
              f"of max(|g|, 1), bound {SP_LONG_GRAD_RTOL}")
        for p in parts:
            check(p["forward_peak_bytes"] < want["forward_peak_bytes"],
                  f"sp (c) {impl}: a rank's forward peak {p['forward_peak_bytes']} bytes, "
                  f"dense's {want['forward_peak_bytes']}")
        long_rows.append({"impl": impl, "causal": causal, "max_abs_err": err,
                          "grad_rel_err": gerr,
                          "forward_peak_bytes": [p["forward_peak_bytes"] for p in parts],
                          "forward_ms": [p["forward_ms"] for p in parts],
                          "backward_ms": [p["backward_ms"] for p in parts],
                          "dense": {k: want[k] for k in ("forward_peak_bytes", "forward_ms",
                                                         "backward_ms")}})
        print(f"sp (c) {impl} ({'causal' if causal else 'full'}) S=2 at B, L, H, D = "
              f"{SP_LONG}: max |err| {err:.2e}, gradients {gerr:.2e} against dense; "
              f"forward peak a rank " + " | ".join(
                  f"{p['forward_peak_bytes'] / 1e6:.1f}" for p in parts)
              + f" MB (dense {want['forward_peak_bytes'] / 1e6:.1f} MB); forward "
              + " | ".join(f"{p['forward_ms']:.2f}" for p in parts)
              + f" ms, backward " + " | ".join(f"{p['backward_ms']:.2f}" for p in parts)
              + f" ms (dense {want['forward_ms']:.2f} and {want['backward_ms']:.2f} ms) "
              f"[{card}]")
    check(all(launches[k] > 0 for k in ("nll_fwd", "nll_bwd", "score_and_draw")),
          f"sp: a kernel of the path never launched: {launches}")
    print("sp seconds by part " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    summary = {"arms": rows, "grid": [{k: v for k, v in r.items() if k != "selected"}
                                      for r in grid],
               "long": long_rows, "seconds": seconds, "card": card}
    return {"launches": launches, "summary": summary}


def shift_forms_body(form: str):
    """One rank of :func:`shift_forms` (run by ``spawn``). ``form="ring"``:
    the ring's shift of a [2, 1024] block in the port's form
    (``ring_shift``: one ``all_to_all_single`` whose splits send to the
    next rank), ``works`` or ``wrong block``, then the causal ring
    attention of a [2, 64, 4, 8] sequence over the ranks, its output and
    gradients. ``form="p2p"``: the same shift as ``batch_isend_irecv``."""
    import torch
    import torch.distributed as dist

    from mercury_tpu_torch.parallel.distributed import device
    from mercury_tpu_torch.parallel.mesh import GroupRef
    from mercury_tpu_torch.parallel.sequence import ring_attention, ring_shift

    w, r = dist.get_world_size(), dist.get_rank()
    dev = device()
    group = GroupRef(dist.group.WORLD, w, r)
    x = torch.full((2, 1024), float(r), device=dev)

    def verdict(y) -> str:
        torch.cuda.synchronize()
        return "works" if bool((y == float((r - 1) % w)).all()) else "wrong block"

    if form == "p2p":
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (r + 1) % w),
                                           dist.P2POp(dist.irecv, y, (r - 1) % w)]):
            req.wait()
        return {"form": verdict(y)}
    gen = torch.Generator().manual_seed(3)
    qkv = [torch.randn((2, 64, 4, 8), generator=gen).chunk(w, dim=1)[r].to(dev)
           .requires_grad_() for _ in range(3)]
    out = ring_attention(*qkv, group, causal=True)
    out.square().sum().backward()
    return {"form": verdict(ring_shift(x, group)), "out": out.detach().cpu(),
            "grads": [t.grad.cpu() for t in qkv]}


def shift_forms(torch, card: str) -> dict:
    """Not a phase of the default run: which form of the ring's shift each
    backend takes with CUDA tensors. Two gloo ranks on card 0, and, where
    a second card is visible, two NCCL ranks on cards 0 and 1 (NCCL
    refuses two ranks on one card): the port's form with the causal ring
    attention, whose output and gradients must be bit-equal across the
    backends, then ``batch_isend_irecv`` in a launch of its own (a rank
    that fails it may abort). Run alone: ``python3 -c "import torch,
    chip_smoke as c; c.shift_forms(torch, c.device_phase(torch))"`` (on
    four cards for NCCL)."""
    from mercury_tpu_torch.parallel.distributed import spawn

    backends = {"gloo": [0, 0]}
    if torch.cuda.device_count() >= 2:
        backends["nccl"] = [0, 1]
    else:
        print(f"shift forms: one card visible, NCCL not run [{card}]")
    found, rings = {}, {}
    for backend, devices in backends.items():
        rings[backend] = spawn(shift_forms_body, 2, backend, "ring", devices=devices,
                               timeout_s=120)
        check(all(r["form"] == "works" for r in rings[backend]),
              f"shift forms: the port's form under {backend}: {rings[backend]}")
        try:
            p2p = [r["form"] for r in spawn(shift_forms_body, 2, backend, "p2p",
                                            devices=devices, timeout_s=120)]
        except Exception as e:  # the probe's answer: how the form failed
            p2p = f"failed: {type(e).__name__}: {str(e).strip().splitlines()[-1][:200]}"
        found[backend] = {"all_to_all_single": "works", "batch_isend_irecv": p2p}
        print(f"shift forms under {backend} (cards {devices}): {found[backend]} [{card}]")
    if "nccl" in rings:
        same = all(torch.equal(a["out"], b["out"]) and all(
            torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
            for a, b in zip(rings["gloo"], rings["nccl"]))
        print(f"shift forms: the causal ring attention's output and gradients under nccl "
              f"bit-equal to gloo's: {same}")
        check(same, "shift forms: the ring attention differs between gloo and nccl")
    return found


# ------------------------------------------------------------------ phase 25
def pp_model(torch, name: str):
    """(a)'s ViT (phase 20's: patch 4, 4 blocks, d_model 128, 4 heads) or
    (b)'s Transformer with 8 experts a block (phase 21's, 2 blocks), from
    seed 0, with its parameter count held."""
    from mercury_tpu_torch.models import create_model

    gen = torch.Generator().manual_seed(0)
    if name == "vit":
        model, want = create_model("vit", 10, gen, (32, 32, 3)), PARAMETERS["vit", 10]
    else:
        model = create_model("transformer", 10, gen, (32, 16), moe_experts=8)
        want = MOE_PARAMETERS["transformer", 10]
    n = sum(p.numel() for p in model.parameters())
    check(n == want, f"pipeline parallelism: {name} has {n} parameters, expected {want}")
    return model


def pp_data(torch, name: str, dev):
    """``synthetic``'s 5000 train images from seed 0 as model-ready NCHW
    float32 (CIFAR-10's normalization) for the ViT, ``synthetic_seq``'s
    sequences for the experts; int32 labels."""
    if name != "vit":
        return sp_data(torch, dev)
    from mercury_tpu_torch.data.cifar import CIFAR10_MEAN, CIFAR10_STD, synthetic_cifar
    from mercury_tpu_torch.data.pipeline import normalize_images

    (x, y), _ = synthetic_cifar(10, 5000, 1000, seed=0)
    x = normalize_images(torch.as_tensor(x, device=dev), CIFAR10_MEAN, CIFAR10_STD)
    return (x.permute(0, 3, 1, 2).contiguous(),
            torch.as_tensor(y, device=dev, dtype=torch.int32))


def pp_arm(torch, mk, mesh, name: str, m: int, steps: int) -> dict:
    """One arm of phase 25 on this rank of ``mesh``: ``name``'s model cut
    to the rank's stage, the Mercury step of ``train/pp_step.py`` (telemetry
    on, Adam at lr 1e-3, batch 32, a pool of 320, ``m`` microbatches) for 3
    warm-up and ``steps`` timed steps (:func:`counted_steps`), then the
    rank's parameter and Adam-moment bytes (the model unusable after).
    Returns every step's losses, router losses and selections, the
    launches, the collectives a step, the seconds and the bytes."""
    from mercury_tpu_torch.parallel.distributed import device
    from mercury_tpu_torch.parallel.pipeline import shard_stacked_blocks
    from mercury_tpu_torch.train.pp_step import create_pp_state, make_pp_mercury_step

    dev = device()
    label = f"pp (S={mesh.second}) {name} M={m}"
    x, y = pp_data(torch, name, dev)
    model = shard_stacked_blocks(pp_model(torch, name), mesh)
    opt = torch.optim.Adam(model.parameters(), lr=SP_LR)
    state = create_pp_state(model, opt, mesh, x.shape[0], seed=0, device=dev)
    step = make_pp_mercury_step(model, mesh, SP_BATCH, SP_PRESAMPLE, m, telemetry=True)
    metrics, counts, collectives, dt = counted_steps(
        torch, mk, mesh, lambda: step(state, x, y)[1], steps, label)
    aux = torch.stack([m["train/moe_aux"] for m in metrics]).cpu()
    check(bool(torch.isfinite(aux).all()) and (name == "vit") == bool((aux == 0).all()),
          f"{label}: router losses {aux.tolist()}")
    torch.cuda.synchronize()
    nbytes = state_bytes(torch, model, opt)
    check(nbytes["freed"] == nbytes["predicted"] == PP_BYTES[name, mesh.second],
          f"{label} rank {mesh.rank}: {nbytes['freed']} parameter and moment bytes freed, "
          f"the stage predicts {nbytes['predicted']}, the counts {PP_BYTES[name, mesh.second]}")
    return {"rank": mesh.rank, "stages": mesh.second,
            "losses": torch.stack([m["train/loss"] for m in metrics]).cpu().tolist(),
            "aux": aux.tolist(), "selected": torch.stack(
                [m["sampler/selected"] for m in metrics]).cpu(),
            "launches": counts, "steps": steps, "seconds": dt, "collectives": collectives,
            "bytes": nbytes["freed"]}


def pp_body():
    """Phase 25's arms on this rank, under deterministic cuDNN, by ``(S,
    name, M)``: at one rank (here) those of S=1; on four gloo ranks (run by
    ``spawn``) those of S=2 on ranks 0 and 1, the first pipe group of
    ``make_tp_mesh(2, 2, "data", "pipe")`` (ranks 2 and 3 go on to wait in
    S=4's first collective), then those of S=4 on all four."""
    import torch

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.collectives import world
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh

    sizes = (1,) if world() == 1 else (2, 4)
    meshes = {s: make_tp_mesh(world() // s, s, "data", "pipe") for s in sizes}
    undo = deterministic_cudnn(torch)
    try:
        return {(s, name, m): pp_arm(torch, mk, mesh, name, m, steps)
                for s, mesh in meshes.items() if mesh.data_rank == 0
                for name, m, steps in PP_ARMS[s]}
    finally:
        undo()


def pipeline_ranks_body():
    """Phases 25 and 26's four-rank arms on this rank, one process group
    for both (a spawn costs tens of seconds): :func:`pp_body`'s, then
    :func:`pp2d_body`'s."""
    return {"pp": pp_body(), "pp2d": pp2d_body()}


def pipeline_parallel_phase(torch, card: str) -> dict:
    """Phase 25: pipeline parallelism (see the module docstring). One gloo
    process group of four ranks on card 0 for S=2 and S=4, which runs
    phase 26's arms after them (:func:`pipeline_ranks_body`; their results
    are returned as ``pp2d_ranks``); the S=1 arms run here."""
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.distributed import spawn

    seconds = {}
    t0 = time.perf_counter()
    pool = spawn(pipeline_ranks_body, 4, "gloo", devices=[0] * 4, timeout_s=900)
    four = [r["pp"] for r in pool]
    seconds["four_ranks_with_phase_26"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = pp_body()
    seconds["s1"] = time.perf_counter() - t0
    launches = {k: 0 for k in mk.KERNELS}
    for arms in four + [one]:
        for a in arms.values():
            for k, v in a["launches"].items():
                launches[k] += v
    rows = {}
    for s, name, m in four[0]:
        base = one[1, name, m]
        ranks = [r[s, name, m] for r in four if (s, name, m) in r]
        for a in ranks[1:]:
            check(torch.equal(a["selected"], ranks[0]["selected"])
                  and a["losses"] == ranks[0]["losses"],
                  f"pp S={s} {name} M={m}: rank {a['rank']} drew or trained apart")
        a = ranks[0]
        rel = abs(a["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        check(rel <= PP_RTOL, f"pp S={s} {name} M={m}: step 1's loss {a['losses'][0]} "
              f"against S=1's {base['losses'][0]}, rel {rel:.2e}")
        check(torch.equal(a["selected"][0], base["selected"][0]),
              f"pp S={s} {name} M={m}: step 1 selected other indices than S=1")
        aux_rel = (abs(a["aux"][0] - base["aux"][0]) / abs(base["aux"][0])
                   if name != "vit" else 0.0)
        check(aux_rel <= PP_RTOL, f"pp S={s} {name} M={m}: step 1's router loss "
              f"{a['aux'][0]} against S=1's {base['aux'][0]}, rel {aux_rel:.2e}")
        steps = len(base["losses"])
        apart = next((i for i in range(steps) if not torch.equal(
            a["selected"][i], base["selected"][i])), steps)
        rows[f"{name} S={s} M={m}"] = {
            "first_rel": rel, "aux_first_rel": aux_rel,
            "parts_at_step": apart + 1 if apart < steps else None,
            "losses": a["losses"], "s1_losses": base["losses"], "aux": a["aux"],
            "s1_aux": base["aux"], "bytes": [r["bytes"] for r in ranks],
            "s1_bytes": base["bytes"],
            "steps_per_s": [r["steps"] / r["seconds"] for r in ranks],
            "s1_steps_per_s": base["steps"] / base["seconds"],
            "collectives": a["collectives"]}
        row = rows[f"{name} S={s} M={m}"]
        print(f"pp {name} S={s} M={m} against S=1 M={m}: step 1 loss rel {rel:.2e}"
              + (f", router loss {a['aux'][0]:.6f} (S=1 {base['aux'][0]:.6f}, rel "
                 f"{aux_rel:.2e})" if name != "vit" else "")
              + ", selections equal on the stages, "
              + (f"first part from S=1's at step {apart + 1} of {steps}" if apart < steps
                 else f"S=1's at all {steps} steps")
              + f"; losses first {a['losses'][0]:.6f} last {a['losses'][-1]:.6f} (S=1 "
              f"{base['losses'][-1]:.6f}); launches a rank {a['launches']}; parameter "
              f"and moment bytes a rank {row['bytes']} (S=1 {base['bytes']}); "
              + ", ".join(f"{v:.2f}" for v in row["steps_per_s"])
              + f" steps/s a rank (S=1 {row['s1_steps_per_s']:.2f}; gloo ranks sharing "
              f"one card: no speed-up is measured) [{card}]")
        print("  collectives a step a rank: " + "; ".join(
            f"{k} {v['calls']:g} calls, {v['bytes']:,.0f} bytes"
            for k, v in sorted(a["collectives"].items())))
    check(all(launches[k] > 0 for k in ("nll_fwd", "nll_bwd", "score_and_draw")),
          f"pp: a kernel of the path never launched: {launches}")
    print("pp seconds by part " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"launches": launches, "pp2d_ranks": [r["pp2d"] for r in pool],
            "summary": {"arms": rows, "s1_bytes": {f"{n} M={m}": a["bytes"]
                                                    for (_, n, m), a in one.items()},
                        "seconds": seconds, "card": card}}


# ------------------------------------------------------------------ phase 26
def pp2d_model(torch, name: str, two_axes: bool):
    """(a)'s Transformer (phase 20's) or (b)'s with 8 experts at capacity
    factor 8 (phase 21's), from seed 0, built with its second model axis
    if ``two_axes``, its parameter count held."""
    from mercury_tpu_torch.models import create_model

    kw = dict(PP2D_ARMS[name])
    if two_axes:
        kw["sp_axis" if name == "seq" else "moe_ep_axis"] = name
    model = create_model("transformer", 10, torch.Generator().manual_seed(0), (32, 16), **kw)
    want = (PARAMETERS if name == "seq" else MOE_PARAMETERS)["transformer", 10]
    n = sum(p.numel() for p in model.parameters())
    check(n == want, f"two model axes: {name} has {n} parameters, expected {want}")
    return model


def pp2d_arm(torch, mk, mesh, name: str) -> dict:
    """One arm of phase 26 on this rank: on a pipe × ``name`` mesh the
    model with its second axis, staged (and under expert its experts cut)
    by ``shard_stacked_blocks``, else the model whole at S=1; the Mercury
    step of ``train/pp_step.py`` (telemetry on, Adam at lr 1e-3, batch 32,
    a pool of 320, M=2) for 3 warm-up and ``PP2D_STEPS[name]`` timed steps
    (:func:`counted_steps`; at S=1 under expert every step's draws in the
    expert ranks' grouping, ``PP2D_GROUP_ORDER``), then the rank's
    parameter and Adam-moment bytes (the model unusable after). Returns
    every step's losses, router losses and selections (at S=1 under expert
    in the expert ranks' order), the launches, the collectives a step, the
    seconds and the bytes."""
    from mercury_tpu_torch.parallel.distributed import device
    from mercury_tpu_torch.parallel.pipeline import shard_stacked_blocks
    from mercury_tpu_torch.train.pp_step import create_pp_state, make_pp_mercury_step, pp_draws

    dev = device()
    two_axes = mesh.inner is not None
    label = f"pp2d {name} " + (f"S=2 × {mesh.inner.size}" if two_axes else "S=1")
    x, y = sp_data(torch, dev)
    model = shard_stacked_blocks(pp2d_model(torch, name, two_axes), mesh)
    opt = torch.optim.Adam(model.parameters(), lr=SP_LR)
    state = create_pp_state(model, opt, mesh, x.shape[0], seed=0, device=dev)
    step = make_pp_mercury_step(model, mesh, SP_BATCH, SP_PRESAMPLE, PP2D_M, telemetry=True)
    regroup = name == "expert" and not two_axes
    order = torch.as_tensor(PP2D_GROUP_ORDER, device=dev)

    def one():
        draws = pp_draws(state, SP_BATCH * SP_PRESAMPLE, SP_BATCH)
        if regroup:
            draws = draws._replace(uniforms=draws.uniforms[:, order])
        m = step(state, x, y, draws)[1]
        if regroup:
            # Back to the expert ranks' order: position order[k] drew k.
            m["sampler/selected"] = m["sampler/selected"][order.argsort()]
        return m

    rows = SP_BATCH // mesh.inner.size if name == "expert" and two_axes else SP_BATCH
    metrics, counts, collectives, dt = counted_steps(torch, mk, mesh, one, PP2D_STEPS[name],
                                                     label, rows)
    aux = torch.stack([m["train/moe_aux"] for m in metrics]).cpu()
    check(bool(torch.isfinite(aux).all()) and (name == "seq") == bool((aux == 0).all()),
          f"{label}: router losses {aux.tolist()}")
    torch.cuda.synchronize()
    nbytes = state_bytes(torch, model, opt)
    if two_axes:
        check(nbytes["freed"] == nbytes["predicted"] == PP2D_BYTES[name],
              f"{label} rank {mesh.rank}: {nbytes['freed']} parameter and moment bytes "
              f"freed, the rank predicts {nbytes['predicted']}, the counts "
              f"{PP2D_BYTES[name]}")
    return {"rank": mesh.rank, "losses": torch.stack([m["train/loss"] for m in metrics])
            .cpu().tolist(), "aux": aux.tolist(),
            "selected": torch.stack([m["sampler/selected"] for m in metrics]).cpu(),
            "launches": counts, "steps": PP2D_STEPS[name], "seconds": dt,
            "collectives": collectives, "bytes": nbytes["freed"]}


def pp2d_body():
    """Phase 26's arms on this rank, under deterministic cuDNN: at one rank
    (here) both at S=1; on four gloo ranks (run by ``spawn``) (a) on
    ``make_pp_mesh(2, 2, "seq")`` and (b) on ``make_pp_mesh(2, 2,
    "expert")``, both meshes made first on every rank."""
    import torch

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.collectives import world
    from mercury_tpu_torch.parallel.mesh import make_pp_mesh, make_tp_mesh

    if world() == 1:
        meshes = dict.fromkeys(PP2D_ARMS, make_tp_mesh(1, 1, "data", "pipe"))
    else:
        meshes = {name: make_pp_mesh(2, 2, name) for name in PP2D_ARMS}
    undo = deterministic_cudnn(torch)
    try:
        return {name: pp2d_arm(torch, mk, mesh, name) for name, mesh in meshes.items()}
    finally:
        undo()


def two_model_axes_phase(torch, card: str, four=None) -> dict:
    """Phase 26: the pipeline on two model axes (see the module docstring).
    Both arms on one gloo process group of four ranks on card 0
    (:func:`pp2d_body`): ``four``, the ranks' results from phase 25's
    process group, or, without it, a spawn of its own; the S=1 arms run
    here."""
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.parallel.distributed import spawn

    seconds = {}
    t0 = time.perf_counter()
    if four is None:
        four = spawn(pp2d_body, 4, "gloo", devices=[0] * 4, timeout_s=600)
        seconds["four_ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = pp2d_body()
    seconds["s1"] = time.perf_counter() - t0
    launches = {k: 0 for k in mk.KERNELS}
    for arms in four + [one]:
        for a in arms.values():
            for k, v in a["launches"].items():
                launches[k] += v
    rows = {}
    for name in PP2D_ARMS:
        base, ranks = one[name], [r[name] for r in four]
        for a in ranks[1:]:
            check(torch.equal(a["selected"], ranks[0]["selected"])
                  and a["losses"] == ranks[0]["losses"] and a["aux"] == ranks[0]["aux"],
                  f"pp2d {name}: rank {a['rank']} drew or trained apart")
        a = ranks[0]
        rel = abs(a["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        check(rel <= PP2D_RTOL, f"pp2d {name}: step 1's loss {a['losses'][0]} against "
              f"S=1's {base['losses'][0]}, rel {rel:.2e}")
        check(torch.equal(a["selected"][0], base["selected"][0]),
              f"pp2d {name}: step 1 selected other indices than S=1")
        aux_rel = (abs(a["aux"][0] - base["aux"][0]) / abs(base["aux"][0])
                   if name == "expert" else 0.0)
        check(aux_rel <= PP2D_RTOL, f"pp2d {name}: step 1's router loss {a['aux'][0]} "
              f"against S=1's {base['aux'][0]}, rel {aux_rel:.2e}")
        steps = len(base["losses"])
        apart = next((i for i in range(steps) if not torch.equal(
            a["selected"][i], base["selected"][i])), steps)
        row = rows[name] = {
            "first_rel": rel, "aux_first_rel": aux_rel,
            "parts_at_step": apart + 1 if apart < steps else None,
            "losses": a["losses"], "s1_losses": base["losses"], "aux": a["aux"],
            "s1_aux": base["aux"], "bytes": [r["bytes"] for r in ranks],
            "s1_bytes": base["bytes"],
            "steps_per_s": [r["steps"] / r["seconds"] for r in ranks],
            "s1_steps_per_s": base["steps"] / base["seconds"],
            "collectives": [r["collectives"] for r in ranks]}
        print(f"pp2d {name} S=2 × 2 M={PP2D_M} against S=1 M={PP2D_M}: step 1 loss rel "
              f"{rel:.2e}"
              + (f", router loss {a['aux'][0]:.6f} (S=1 {base['aux'][0]:.6f}, rel "
                 f"{aux_rel:.2e})" if name == "expert" else "")
              + ", selections equal on the four ranks, "
              + (f"first part from S=1's at step {apart + 1} of {steps}" if apart < steps
                 else f"S=1's at all {steps} steps")
              + f"; losses first {a['losses'][0]:.6f} last {a['losses'][-1]:.6f} (S=1 "
              f"{base['losses'][-1]:.6f}); launches a rank {a['launches']}; parameter "
              f"and moment bytes a rank {row['bytes']} (S=1 {base['bytes']}); "
              + ", ".join(f"{v:.2f}" for v in row["steps_per_s"])
              + f" steps/s a rank (S=1 {row['s1_steps_per_s']:.2f}; gloo ranks sharing "
              f"one card: no speed-up is measured) [{card}]")
        for r in ranks:
            print(f"  rank {r['rank']} collectives a step: " + "; ".join(
                f"{k} {v['calls']:g} calls, {v['bytes']:,.0f} bytes"
                for k, v in sorted(r["collectives"].items())))
    check(all(launches[k] > 0 for k in ("nll_fwd", "nll_bwd", "score_and_draw")),
          f"pp2d: a kernel of the path never launched: {launches}")
    print("pp2d seconds by part " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"launches": launches,
            "summary": {"arms": rows, "seconds": seconds, "card": card}}


def profile_window(torch, trainer, step_us: float, steps: int = 10):
    """Device busy share, kernel launches a step and device time by kernel
    over ``steps`` steps, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernels only: the CPU ops that launched them, and user annotations
    # such as ``Optimizer.step#Adam.step`` on the device track, carry the
    # same device time again.
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    return {"steps": steps, "wall_us_per_step": wall_us / steps,
            "device_us_per_step": device_us / steps, "busy_share": device_us / wall_us,
            "unprofiled_us_per_step": step_us,
            "busy_share_unprofiled": device_us / steps / step_us,
            "kernels_per_step": launches / steps,
            "by_kernel": [{"key": k, "count": c, "device_us": u} for k, c, u in rows]}


def profile_phase(torch, card: str, main_path, table_path) -> None:
    """``--profile`` only: where a step's time goes on each path
    (:func:`profile_window`), and the step rates of the importance-sampled
    pool step, the uniform arm and the scoretable step in turns on one
    card. Written to ``chiprun_out/chip_smoke_profile.json``."""
    from mercury_tpu_torch import Trainer
    from mercury_tpu_torch.ops import mercury_kernels as mk

    windows = {}
    for name, path in (("pool", main_path), ("scoretable", table_path)):
        w = profile_window(torch, path["trainer"], path["step_us"])
        windows[name] = w
        print(f"profile {name}: {w['steps']} steps, wall {w['wall_us_per_step']:.1f} "
              f"us/step, device busy {w['device_us_per_step']:.1f} us/step "
              f"({100 * w['busy_share']:.1f}% busy), {w['kernels_per_step']:.1f} "
              f"kernels/step; against the unprofiled {w['unprofiled_us_per_step']:.1f} "
              f"us/step the device is busy {100 * w['busy_share_unprofiled']:.1f}% [{card}]")
        for row in w["by_kernel"][:12]:
            print(f"  {row['device_us'] / w['steps']:9.1f} us/step "
                  f"{row['count'] / w['steps']:6.1f}/step  {row['key'][:90]}")

    # The three arms in turns (is, uniform, table, table, uniform, is).
    base = main_path["config"]
    arm_configs = {"is": base, "uniform": base.replace(use_importance_sampling=False),
                   "scoretable": table_path["config"]}
    arms = {k: [] for k in arm_configs}
    for name in ("is", "uniform", "scoretable", "scoretable", "uniform", "is"):
        arm = Trainer(arm_configs[name])
        warm(arm)
        dt, _, _, _ = timed_steps(torch, mk, arm)
        arms[name].append(MAIN_STEPS / dt)
        del arm
    print(f"arms (steps/s, in turns): importance sampling {arms['is']}, "
          f"uniform {arms['uniform']}, scoretable+fused {arms['scoretable']} [{card}]")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(json.dumps({
        "card": card, "windows": windows, "arms_steps_per_s": arms}, indent=1))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
