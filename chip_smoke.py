#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``znicz_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and forgotten):

  1. the card's name and power limit; build the CUDA kernels from
     ``znicz_torch/csrc`` (one ``nvcc`` per source, all at once);
  2. each forward kernel (K1, K2, K3) against its plain PyTorch version
     on the card, at the shapes AlexNet's forward gives it at batch 128:
     error against the stated tolerance, kernel / plain / library time,
     the wrapper's host time per call, and the least time the card could
     take (bytes over 3.35 TB/s or operations over the float32 rate,
     whichever is larger); K1 and K3 must be bit-exact, and are also run
     bit-exact at the small shapes, pools and LRN constants of
     ``K1_PATHS`` and ``K3_PATHS``, which take their scalar and float4
     paths, each pooling branch, odd and even windows and both forms of
     s^-beta;
  3. full-width AlexNet (227x227x3, 96/256/384/384/256/4096/4096, 1000
     classes, seeded random weights) behind ``InferenceServer``
     (max_batch 128; each rung a captured CUDA graph, as every served
     phase's server; the references are eager runners) with
     ``fused_elementwise`` and ``fused_tail`` on:
     64 requests of 1-16 rows from 4 threads; every reply checked against
     the same rows through the composed forward (knobs off); the kernel
     counts must show 2 block launches and 3 bias+ReLU launches per
     dispatch;
  4. the same with ``pallas_lrn`` on and ``fused_elementwise`` off: 2 LRN
     launches and 5 bias+ReLU launches per dispatch;
  5. each backward kernel (K1b, K2b, K3b) against its plain version at
     the batch-128 shapes of the AlexNet train step, as in phase 2, with
     the bias gradient held to a tolerance relative to its sums; every
     dx must be bit-exact, also at the cases of ``K1B_PATHS`` (scalar and
     float4 paths, strips, column tiles, tied inputs), ``K2B_PATHS``
     (channel counts from 1 to 1536, one row, unaligned operands; db the
     same bits on a second launch) and ``K3B_PATHS`` (as ``K3_PATHS``,
     plus rows that keep x and dy * sb in the ring and dy with signed
     zeros); K3b's library yardstick is the autograd backward of
     ``F.local_response_norm``;
  6. full-width AlexNet trained by ``FusedTrainer.run()`` (the port's
     ``samples/alexnet.py``: 227x227x3, batch 128, 256 train + 128 valid
     images, 2 epochs, 1000 classes) three times from the same weights and
     the same dropout masks: composed, ``fused`` and ``pallas_lrn``.  Every
     loss must be finite; each fused routing's per-step losses and final
     weights must stay within the stated bands of the composed run's; the
     kernel counts must be exactly 2/2/3/3 (K1/K1b/K2/K2b) per train step
     under ``fused`` and 2/2/5/5 (K3/K3b/K2/K2b) under ``pallas_lrn``, and
     eval steps launch forward kernels only;
  7. K2, K2b, K3 and K3b against their plain versions at CIFAR10's
     batch-100 shapes, as in phases 2 and 5 (the three convolutions'
     outputs, the norm after the first pool), reported in each kernel's
     row as ``"cifar"``;
  8. the MNIST and CIFAR10 anchors (BASELINE configs 0 and 1) at their
     default configurations through each sample's workflow and
     ``samples.train`` (what its ``run()`` calls), every named stream
     reset to 1013 first, as ``bench.py`` seeds them: MNIST, then
     CIFAR10 composed, under ``fused_tail`` and under ``pallas_lrn`` +
     ``fused_tail``.  Under ``fused_tail`` a train step launches K2 and
     K2b three times each, under ``pallas_lrn`` also K3 and K3b once
     each, an eval step the forward kernels only, and K1 and K1b never
     launch; each run's first 8 train losses must match the port's CPU
     run of them within rtol 1e-4; each final must lie inside its
     ``ANCHOR_BANDS`` entry, but for CIFAR10's valid error, whose
     misses are printed and not raised (``DRIFTS``).  These runs, like
     phase 6's, drive ``FusedTrainer`` explicitly;
  9. ``units``, the unit-at-a-time engine (the default of the MNIST and
     CIFAR10 samples' ``run()``), every named stream reset to 1013:
     MNIST, CIFAR10 composed and CIFAR10 under ``pallas_lrn``, each
     through its workflow and ``samples.train`` with the engine left to
     its default; each run's first 8 train losses against the port's own
     CPU unit-engine run within rtol 1e-4, its finals against
     ``ANCHOR_BANDS`` under the ``DRIFTS`` rule, K3 launched by the LRN
     units (twice per train step: the forward unit and the GD unit's
     recomputed forward, once per eval step) and K3b by the LRN GD unit
     once per train step, no other kernel; the images/s of each next to
     a ``FusedTrainer`` run of the same sample; MNIST's best snapshot
     reloaded into a fresh workflow on the card, bit-equal.  Then
     full-width AlexNet (phase 6's configuration) for its 3 train steps
     on the unit engine under ``pallas_lrn``, its dropout masks those of
     a composed ``FusedTrainer`` run from the same seed: losses within
     rtol 1e-3 of that run, final weights within its weight band, K3 and
     K3b counted against the LRN units' firings;
 10. ``bf16``, training with ``compute_dtype`` bf16: the bf16 operand
     variants of K1, K1b, K2 and K2b against their plain versions (float32
     arithmetic on the widened operands, rounded once) at AlexNet's
     batch-128 shapes and at the cases of ``BF16_PATHS`` (odd C, C not a
     multiple of 8, one row, unaligned operands, pools 3x3/2, 2x2/2,
     4x4/2 and 1x1/4, windows 1, 3, 4, 5, 7 and 9, powf, tied maxima,
     short strips, strips x column tiles): every output and dx bit-exact
     and the same bits on a second launch, db within DB_RTOL of the
     float32 sums and the same bits on a second launch, with bounds
     counting 2 bytes a bf16 element and 4 a db float.  The bf16 K1 and
     K1b run the float32 ring kernels on bf16 rows where their planners
     take the shape, the simple kernels elsewhere: each case asserts
     which, AlexNet's shapes must take the ring (their rows print the
     plan and time the simple kernels beside it, ``simple_ms``) and the
     AlexNet bf16 training runs must launch no simple kernel; the bf16
     K3 and K3b (every operation in bf16, as the reference's LRN kernels
     compute) run the float32 K3's and K3b's ring design on 8-channel
     units where their planners take the shape, the simple kernels
     elsewhere, as the bf16 K1 and K1b do (AlexNet's and CIFAR10's shapes
     must take the ring, with ``simple_ms`` beside), at AlexNet's shapes
     and the cases of ``BF16_LRN_PATHS`` (each asserting its path), y and
     dx bit-exact and the same bits twice, the ring's table of powers
     against ``torch.pow`` for every bf16 value, timed against
     ``F.local_response_norm`` in bf16 and its autograd backward; the bf16
     K2 and K2b run the float32 K2's and K2b's design on 16-byte units of
     eight bf16 where C % 8 == 0 and the operands are 16-byte aligned,
     the simple kernels elsewhere (each ``BF16_PATHS`` case asserts which;
     AlexNet's and CIFAR10's shapes must take the 16-byte kernels, with
     ``simple_ms`` beside); the bf16 K2, K2b, K3 and K3b at CIFAR10's
     shapes;
     full-width AlexNet (phase 6's configuration) trained 3 steps from the
     same weights and masks in float32 (composed, ``fused``) and in bf16
     (composed, ``fused``, ``fused`` with ``state_dtype`` and with
     ``master_dtype`` bf16, ``pallas_lrn`` + ``fused_tail``): every loss
     finite, each bf16 kernel routing within rtol 5e-2 of the bf16
     composed run, exactly 2/2/3/3 bf16 K1/K1b/K2/K2b launches a train
     step (2/0/3/0 an eval step) under ``fused`` and 2/2/5/5 bf16
     K3/K3b/K2/K2b (2/0/5/0) under ``pallas_lrn``, no float32 kernel
     launch, the stored velocity and parameter dtypes asserted, each train
     step's device time printed beside the float32 one; MNIST at its
     defaults on ``FusedTrainer`` in bf16, its finals against the float32
     run's; CIFAR10 at its defaults on ``FusedTrainer`` in bf16 under
     ``pallas_lrn`` + ``fused_tail``: every loss finite, the first 8
     within rtol 5e-2 of the port's CPU run, bf16 K3/K3b once and K2/K2b
     three times a train step, no simple bf16 K2, K2b, K3 or K3b, its
     finals printed beside phase 8's float32 ``pallas_lrn`` finals;
 11. ``mnist_ae`` and ``kohonen``, BASELINE configs 2 and 3 at their
     defaults on the unit engine (the only engine either graph takes),
     every named stream reset to 1013: each final inside its
     ``ANCHOR_BANDS`` entry (no drift allowed); MnistAE's first 8 train
     losses and Kohonen's qerror of each of its 10 epochs within rtol
     1e-4 of the port's CPU run of the same seed; every parameter,
     velocity and the dataset on the card; MnistAE's ``conv.weights``
     and ``deconv.weights`` one tensor after training; no kernel
     launched (neither path reaches one); the images/s (points/s) and
     the wall time of each run beside the card's name and power limit;
 12. ``kinds``, the layer kinds ported last: full-width AlexNet (phase
     6's configuration) built from plain ``conv`` + ``activation_str``
     layers, loaded with the ``conv_strict_relu`` model's weights and
     trained 3 steps with its dropout masks under composed, ``fused``,
     ``pallas_lrn`` and bf16 ``fused``, beside that model under the same
     routing: under the kernel routings the planners' span-4 and span-2
     matches must give the same launch counts (2/2/3/3 K1/K1b/K2/K2b, or
     2/2/5/5 K3/K3b/K2/K2b, a train step) and the same losses and final
     weights bit for bit, under composed the phase 6 bands; each train
     step's device time beside the ``conv_strict_relu`` one.  A narrow
     conv -> tanh -> stochastic pooling -> softmax net on digit glyphs, on
     the unit engine and on ``FusedTrainer``, replaying the offsets its
     CPU run drew: the first 8 losses within rtol 1e-4 of that run; the
     default Philox sampler's chi-square at a fixed seed; the fused
     select's backward the same bits twice.  ``wine`` at its defaults on
     both engines: the first 8 losses within rtol 1e-4 of the port's CPU
     run, the normalised dataset on the card, the finals beside the
     reference's CPU finals, rows/s and wall time.  None of the
     stochastic or wine runs launches a kernel;
 13. ``samples``, the last procedural samples and the host runtime: the
     host runtime built with g++ from ``znicz_torch/csrc/host``, its
     ``XorShift128P(1013)`` draws and shuffle against ``NATIVE_PINS``
     (the values ``tests/test_torch_native.py`` pins); K2 and K2b, float32
     and bf16, at Kanji's (batch 128: (B,24,24,16), (B,12,12,32)) and
     YaleFaces' (batch 32: (B,32,32,8), (B,16,16,16)) conv outputs against
     their plain versions, as in phase 7, the rows under ``"kanji"`` and
     ``"yale"`` (the ``K2B_PATHS`` and ``BF16_PATHS`` cases at those
     shapes assert the float4 and 16-byte paths); then Kanji (4096 + 512
     glyphs, 64 classes, batch 128, 8 epochs), VideoAE (2000 + 400
     frames, batch 100, 20 epochs) and YaleFaces (8 subjects x 16 + 4
     images written as PNG files into the temporary directory, 32x32,
     batch 32, 10 epochs; PIL decodes them) at their defaults, every
     named stream reset to 1013, on the unit engine and on
     ``FusedTrainer`` (Kanji and YaleFaces under ``fused_tail`` in float32
     and in bf16): exactly 2 K2 and 2 K2b a train step and 2 K2 an eval
     step under ``fused_tail`` (no simple bf16 kernel), no kernel
     elsewhere, every loss finite, the first 8 train losses within rtol
     1e-4 (5e-2 in bf16) of the port's CPU run on the same engine, the
     finals beside the reference's CPU finals, images/s and wall time;
 14. ``segments``, the segmented run (``FusedTrainer.run()``: segments of
     up to ``scan_chunk`` steps, on the card each step a replay of a
     captured CUDA graph) and the streaming path: full-width AlexNet
     (1280 + 128 seeded 227x227 textures made on the card, uint8
     resident and decoded in the step, batch 128, 1000 classes, 2 epochs:
     a segment of 8, one of 1 and the tail an epoch) under ``fused`` in
     float32 and in bf16, ``scan_chunk`` 8 against 1: losses, weights,
     velocities and confusions bit-equal, the K1/K1b/K2/K2b launches
     equal and 2/2/3/3 a train step with the replays counted, captured
     and eager steps and images/s both ways; ``remat`` (one checkpoint a
     block) on against off, captured and at ``scan_chunk`` 1, bit-equal,
     ``torch.cuda.max_memory_allocated`` of each from the same start
     (every run's state kept on the host), ``remat``'s lower; the same
     rows host-staged (``stream_budget_mb`` 0: pinned segments copied
     ahead on a copy stream by the ``DeviceStager``) against the resident
     run, bit-equal, the stager's counts printed; 128 + 384 of the
     textures written as PNG files and streamed through the
     ``DecodePool`` for an epoch against the same rows resident,
     bit-equal; CIFAR10 at its defaults under ``pallas_lrn`` +
     ``fused_tail`` (K2/K2b/K3/K3b), ``scan_chunk`` 8 against 1
     bit-equal, its finals in ``ANCHOR_BANDS`` under the ``DRIFTS`` rule,
     its background snapshot against an in-line one of the same run
     (arrays, loader, prng streams equal); phase 12's stochastic pooling
     net at ``scan_chunk`` 8, uncaptured by rule, bit-equal to 1.  A
     capture or replay error fails the run;
 15. ``deep``, the deep pipeline (``pipeline_depth`` above 1: whole epochs
     queued back to back, their metrics read late, several epochs in one
     transfer): phase 14's AlexNet textures for 5 epochs under ``fused``
     in float32 and bf16 (after a one-epoch warm-up run each),
     ``pipeline_depth`` 2 against 1 at ``scan_chunk`` 8: losses, weights,
     velocities, confusions, the Decision's epoch and best, ``steps_done``
     and the loader bit-equal, the K1/K1b/K2/K2b launches equal and
     2/2/3/3 a train step, each run's captured and eager steps, images/s
     (warm: after the first epoch, on the device's clock for the deep
     run), peak memory, epochs queued and flushed, pulls and the most in
     flight; in float32 the snapshotter is active and the best snapshot
     each run queues (held in memory, not written) is compared: arrays
     bit for bit, the loader, the prng streams and the Decision exact.
     CIFAR10 under ``pallas_lrn`` + ``fused_tail`` at ``learning_rate``
     1e-4, ``fail_iterations`` 2 and ``max_epochs`` 50, ``pipeline_depth``
     4 against 1: the stop found late and rolled back once, bit-equal to
     the segmented run (weights, velocities, ``steps_done``, the loader,
     the ``lr_adjust`` iteration), every queued step's K2/K2b/K3/K3b
     launches counted, the rolled-back ones too;
 16. ``shard``, the fused trainer on a mesh of ranks
     (``parallel/mesh.py``): phase 14's AlexNet textures, float32
     ``fused``, trained once in this process (2 epochs, captured), then
     2 ranks spawned over a ``FileStore``, each joining a gloo group on
     ``cuda:0`` (``distributed_init(..., backend="gloo")``); each rank
     prints which collectives gloo takes on CUDA tensors and the time of
     summing the 62.4 M-float gradient buffer, then trains (b) on mesh
     (1, 2) (fc6 and fc7 split by rows; its best snapshot written by
     rank 0 alone, in the background), (a) on mesh (2, 1) (64 rows a
     rank, the gradients summed a step) and (c) on mesh (2, 1) at
     ``pipeline_depth`` 2 and 1 for 3 epochs, all uncaptured.  Before
     the ranks, K1/K1b/K2/K2b are held to their plain versions at the
     64-row shapes a rank of (a) gives them.  Each run: the ranks
     bit-equal (weights, velocities, losses, confusions); one train step
     of (a) and of (b) within the cross-layout band of one process's
     (loss rtol 1e-3, weights and velocities rtol 2e-3 / atol 2e-5) with
     its error count and confusion equal; the short run (ROADMAP C.5): N,
     the most train steps up to ``SHARD_SHORT_MAX`` over which one
     process from a start 1 ulp away stays in that band step by step
     (error counts and confusions equal), found first, then (a) and (b)
     over N steps held to the same band at every step; the whole of (a)
     and of (b) held to one process's run: losses within rtol 1e-3, and
     weights,
     velocities, confusions and error counts no further from it than
     ``SHARD_DRIFT_FACTOR`` times (plus ``SHARD_SAMPLES`` samples) what a
     one-process run from a start 1 ulp away drifts (the yardstick);
     K1/K1b/K2/K2b 2/2/3/3 a train step on every rank; (c)'s two depths
     bit-equal; steps, images/s, the seconds in collectives against the
     seconds of steps, peak memory of each rank.  The snapshot is loaded
     into this process's trainer.  A rank that fails or times out fails
     the phase;
 17. ``snapshots``, the snapshot formats and the served swap: 2 gloo ranks
     on the card train phase 14's AlexNet under ``fused`` for an epoch on
     mesh (1, 2) and save a sharded orbax snapshot (``format="orbax"``,
     ``sharded``: each rank writes its rows of fc6/fc7), twice; a fresh
     trainer on (2, 1) restores it (``restore_sharded``), and so does one
     process here: every leaf bit-equal to the saving run's whole arrays,
     the save's, the restores' seconds and the size on disk printed.
     Then an ``InferenceServer`` under ``fused`` (generation 1: a fresh
     random AlexNet) serves phase 3's 64 requests four times: before a
     swap, while ``swap_async`` moves it to the snapshot (generation 2),
     after the flip, and after ``rollback``; every reply within
     ``SERVE_TOL`` of the composed forward of the generation stamped on
     it, K1/K2 2/3 a dispatch (the swap's warm dispatches too);
 18. ``zmq``, the served path over ZMQ: full-width AlexNet (phase 3's
     configuration, seeded again) behind ``InferenceServer`` bound to
     ``tcp://127.0.0.1:*``, under ``fused`` and then ``pallas_lrn``:
     phase 3's 64 requests in process (4 threads), then from 4
     ``InferenceClient``s (one a thread, up to 8 requests in flight
     each): every reply within ``SERVE_TOL`` of the composed forward,
     K1/K2 2/3 (K3/K2 2/5) launches a dispatch, images/s and p50/p99 on
     the client's and the server's clock and the codec's bytes in and out
     printed for each pass.  On the ``fused`` server: a rate limit (burst
     128 rows, 1e-3 rows/s) that one flooding client crosses and gets only
     ``rate_limited`` refusals while three others get every reply;
     ``deadline_ms=0`` refused ``deadline`` at ingress; a garbage frame
     answered and counted, the next request served; ping, stats; ``swap``
     over the wire to a host snapshot this phase writes (every leaf moved)
     and ``rollback``, each reply within ``SERVE_TOL`` of its generation's
     composed forward.  Then ``python -m znicz_torch alexnet --serve
     tcp://127.0.0.1:* --snapshot`` that snapshot (``fused``, max_batch
     128, ``max_requests`` 16) as a subprocess on the card: the endpoint
     read from its output, 16 requests over ZMQ, each reply within
     ``SERVE_TOL`` of the snapshot's composed forward, exit 0 within
     ``CLI_TIMEOUT_S``;
 19. ``graphs``, each ladder rung a captured CUDA graph: full-width
     AlexNet (phase 3's configuration) behind an ``InferenceServer``
     eager (``capture=False``) and then captured, under ``fused`` and
     under ``pallas_lrn``: ``compiles == graph_cache_size() == 8`` after
     the warm; a 128-row slice at every rung through each server's runner,
     captured against eager bit for bit; phase 3's 64 requests from 4
     threads, every reply within ``SERVE_TOL`` of the composed forward and
     bit-equal to the eager forward of the rung it rode, no capture under
     traffic, K1/K2 2/3 (K3/K2 2/5) launches a dispatch counted through
     the replays, images/s and p50/p99 both ways, the memory of a family
     (``memory_allocated`` and ``memory_reserved`` before and after its
     captures).  On the ``fused`` server: a swap under traffic captures
     exactly 8 graphs (its time, its family's memory), the rollback
     captures none and its rungs are generation 1's bits again; then the
     chaos harness: ``FaultSchedule`` stalls of every dispatch, counted; a
     ``ChaosProxy`` (drop, corrupt, duplicate, delay) between two
     ``InferenceClient``s and the server, every request answered once or
     refused readably, the proxy's counts against its log and the
     server's ``bad_frames``; a second server with a rate limit flooded by
     a ``FloodProcess`` at 10x it, only ``rate_limited`` refusals, while a
     paced client gets its replies;
 20. ``serve_mesh``, the serving mesh: K1 and K2 against their plain
     versions at a rank's 64-row shapes (rows under ``"serve_mesh"``);
     one process serves phase 3's requests captured under ``fused`` at
     generations 1 and 2; then 2 gloo ranks on ``cuda:0`` (rank 0 the
     ``InferenceServer``, rank 1 ``ModelRunner.follow()``) serve them on
     meshes (2, 1) and (1, 2) (``root.common.serving.mesh``): the rungs
     snapped to multiples of dp, every reply within the cross-layout band
     (rtol 2e-3, atol 2e-5) of one process's, a swap and a rollback that
     keep both ranks on one generation (rank 1's steps recorded), equal
     dispatch counts, K1/K2 2/3 launches a dispatch on each rank, the
     service's images/s and a rank's beside one process's;
 21. ``fleet``, the replica fleet: a ``ReplicaBalancer`` on
     ``tcp://127.0.0.1:*`` in front of two full-width AlexNet replicas
     (``fused``, captured rungs, ``announce``; ids ``r0``, ``r1``), each
     under a ``ReplicaHarness``, sharing the card in this process: phase
     3's 64 requests from 4 clients through the balancer (every reply
     stamped ``lb``, ``r0`` or ``r1`` and generation 1, within
     ``SERVE_TOL`` of the composed forward, both replicas serving, the
     ledger balanced, K1/K2 2/3 launches a dispatch in total and in each
     replica's 8 captured rungs) against one replica served directly over
     ZMQ, in turns (images/s, the client's p50/p99, ``memory_allocated``
     with both up); the pass again with ``r0`` killed at a third and restarted at
     two thirds (each request answered once); whether one request's rows
     are bit-equal at rungs 16 and 128; a ``swap`` wave to a second
     snapshot of the same weights promoted (the canary's warm and the
     wave's time); a wave to weights scaled by 0.75 rolled back for
     reply parity; a wave to a third with the canary's every dispatch
     stalled
     (``runner.inject_compute_faults``) rolled back on its p99; ``r1``
     restarted with its boot snapshot and healed onto the fleet path, its
     replies then at generation 2 within ``SERVE_TOL``.  Every wave but
     the stalled one runs under ``parity: true`` with 8 requests in
     flight: the same weights promote (each parity probe and its primary
     served alone, at ``bucket_for`` its rows, as the replicas' batchers
     record), weights scaled by 0.75 roll back for reply parity;
 22. ``aot``, the build cache: a full-width AlexNet snapshot, then four
     boots of it under ``fused``, each in a child process
     (``--aot-child``) whose kernel build directory starts empty, with
     ``aot_cache/`` beside the snapshot: cold (``nvcc`` builds the
     libraries the forward asks for, which are stored), warm (every
     library loaded from the cache, zero ``nvcc`` runs, ``warm_source``
     ``cache_hit``, the warm proof holding with 8 captures, the answers
     to 4 batches bit-equal to the cold boot's, a swap with no ``nvcc``),
     refused (an entry cut short: refused, rebuilt, stored over) and
     healed (every library from the cache again); each boot's
     process-start-to-ready and serve-to-ready seconds;
 23. ``master``, the master/slave star on ``tcp://127.0.0.1:*``: a
     ``Server`` and one ``FusedClient`` slave on full-width AlexNet
     (float32, ``fused``, no prefetch, single-minibatch jobs) for an
     epoch, the master's tree within ``STAR_RTOL`` of one
     ``FusedTrainer`` taking the same 4 steps, K1/K1b/K2/K2b 2/2/3/3 a
     train job, the seconds a job, the bytes an update each way and the
     master's apply time; two ``FusedClient`` slaves and one that takes a
     job and dies behind a quorum of 3, the lost job re-queued and done
     once; CIFAR10 on a unit-engine ``Client`` under ``pallas_lrn``, K3
     and K3b counted against the jobs;
 24. ``tree``, the relay tree and the meshed slave on
     ``tcp://127.0.0.1:*``: phase 23's one-slave epoch with a ``Relay``
     (fanout 1, float32 wire) between the master and the ``FusedClient``,
     the master's tree within ``STAR_RTOL`` of one ``FusedTrainer``'s,
     the bytes into the master and through the relay; two
     ``FusedClient`` slaves behind a relay of fanout 2 for an epoch
     (aggregated updates, fewer update messages than jobs, the books on
     the leaf ids, the master's update bytes against phase 23's star),
     then the same under a ``RelayHarness`` killed once a job is done
     (the children fall back to the master, the reaper re-queues, the
     epoch completes, the ledger balances); a meshed ``FusedClient`` of
     two gloo ranks spawned on ``cuda:0`` (``TREE_MESH_SHAPE``) for an
     epoch of 2 train jobs: ``slave_meshes`` records its shape and the
     master's tree lies within phase 16's cross-layout band of one
     ``FusedTrainer``'s; K1/K1b/K2/K2b 2/2/3/3 a train job and 2/0/3/0 an
     eval job on every slave and rank; each meshed job's broadcast and
     gather seconds;
 25. ``charlm``, the sequence model at the sample's own defaults (vocab
     32, embed 32, 2 heads, FFN 64, seq_len 64, minibatch 32, 384 train
     and 96 valid windows, 8 epochs): trained under ``fused``, ``fused``
     + ``fused_tail`` and on the unit engine from seed 1013, each run's
     first 8 train losses against the same run on the CPU (the band
     printed, held to ``STEP_RTOL``), the ``fused`` run's VALID token
     error under ``CHARLM_VALID_ERR``, epoch seconds and warm steps a
     second; no kernel launched on this path (every counter 0).  Then
     the ``fused`` run's snapshot served in process on the 2-D ladder
     (``max_batch`` 8: 4 rows rungs x 7 seq rungs, 28 captured buckets):
     a stream of ``CHARLM_STREAM`` requests of lengths 1-64, each reply
     ``(n, len, 32)`` and bit-equal to the eager forward of the padded
     bucket it rode, no capture after the warmup, pad tokens changed
     under probes changing no bit of the real positions, and the served
     rows a second at each seq rung.
 26. charlm generating from that snapshot: the paged runner's captured
     graphs, the sampler against the CPU, the service under mixed
     traffic, ``--serve --generate`` over ZMQ;
 27. ``seq_parallel``: spawns of 2 and of 4 gloo ranks on the card, each
     running (a) ``ring_attention`` over its ranks, causal and not, at
     charlm's attention shapes (batch 32, T 64, 2 heads of 16) and at a
     long context (batch 4, T 4096), outputs and q/k/v gradients against
     the dense core within the reference's tolerances, ms a call of ring
     and dense, the ring's P2P calls, bytes and host seconds; and (b)
     charlm at its defaults on ``FusedTrainer`` with ``seq_parallel`` 2
     on (1, 2), then (2, 2): the attention bound to the trainer's mesh,
     the ranks of a data row bit-equal, the first 8 TRAIN losses in the
     cross-layout band of one unmeshed run from the same seed, all the
     losses and the final tree within phase 16's multiple of the drift of
     that run from a start one ulp away, VALID token error under 50%,
     warm steps a second, each rank ringing over its data row's model
     ranks; beside the unmeshed run, charlm's embedding backward timed
     both ways (the sum in index order against ``index_add_``'s atomics).
     Then (c) in this process: the genetic search over ``python -m
     znicz_torch mnist --fitness`` runs on the card, ``DeviceBenchmark``
     (cuda faster than cpu), CD-1 steps of an RBM on MNIST rows.  No
     kernel lies on this path.

A ``[clock]`` line after each phase gives the seconds since the start.
Snapshots go to a temporary directory, removed at the end; the AlexNet
runs write none (their snapshotter is gated off, or in phase 15 its
saves are held in memory: a full-width snapshot is 0.5 GB of gzip) but
phase 16's one best save and phase 17's orbax directory.  The last
lines are the ``kernels`` JSON object and then ``{"ok": true,
"device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.

    python3 chip_smoke.py --only fused_block_fwd[,...]

runs phases 1 and 2 for the named kernels alone, with the ``*_PATHS``
cases of each kernel named (``fused_block_fwd``, ``fused_block_bwd``,
``lrn_fwd``, ``bias_relu_bwd``, ``lrn_bwd``, ``lrn_bf16_fwd``,
``lrn_bf16_bwd``, and the ``BF16_PATHS`` kernels: ``fused_block_bf16_fwd``,
``fused_block_bf16_bwd``, ``bias_relu_bf16_fwd``, ``bias_relu_bf16_bwd``),
phases 7 and 8 for
``anchors``, phase 9 for ``units``, phase 10 for ``bf16``, phase 11
for ``mnist_ae`` and ``kohonen`` (each alone or both), phase 12 for
``kinds``, phase 13 for ``samples``, phase 14 for ``segments``,
phase 15 for ``deep``, phase 16 for ``shard``, phase 17 for
``snapshots``, phase 18 for ``zmq``, phase 19 for ``graphs``, phase
20 for ``serve_mesh``, phase 21 for ``fleet``, phase 22 for ``aot``,
phase 23 for ``master``, phase 24 for ``tree``, phase 25 for
``charlm``, phase 26 for ``generate`` and phase 27 for
``seq_parallel``; it prints the ``kernels`` object and no ``ok`` line.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future

import numpy as np

SEED = 20261016
BATCH = 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores

#: kernel vs plain: elementwise |k - p| <= ATOL + RTOL * |p|.  Same
#: float32 arithmetic in the same order; the kernel's powf and sqrtf may
#: differ from PyTorch's pow/sqrt by an ulp or two
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
#: a bias gradient vs plain, per channel: |k - p| <= DB_RTOL * sum|dx|.
#: Both sum the same terms over B, H, W in different orders
DB_RTOL = 1e-4
#: served logits vs the composed forward, as max|a - b| / max|b|: TF32
#: off, float32 throughout; the paths differ by rounding in the LRN and
#: by the convolution algorithm cuDNN picks per batch size
SERVE_TOL = 1e-4
#: a fused routing's training vs the composed run's: per-step losses
#: within LOSS_RTOL, final weights within |d| <= W_ATOL + W_RTOL*|w|, the
#: band of the reference's own trainer parity test
#: (tests/test_fused_block_pallas.py:244-248).  The routings differ by
#: rounding (rsqrt vs pow LRN, cuDNN's backward algorithms)
LOSS_RTOL, W_RTOL, W_ATOL = 1e-3, 5e-3, 5e-5
#: 2 train minibatches and 1 valid minibatch an epoch: 3 train steps in 2
#: epochs (the last tail's update is skipped once the run completes).
#: Rounding differences between the routings grow with every step: the
#: weight band's margin shrinks from 3 to 5 to 7 steps (PERF.md)
TRAIN_CFG = {"minibatch_size": BATCH, "n_train": 256, "n_valid": 128,
             "n_test": 0, "n_classes": 1000, "image_size": 227}
TRAIN_EPOCHS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_kernel(torch, fn, iters: int = 20, warmup: int = 3):
    """(mean device time of ``fn`` in ms, from CUDA events around
    ``iters`` launches after ``warmup``; mean host time of one call in
    us, from the host clock around the same ``iters`` enqueues, before
    the synchronise).  A host time above the device time means the host
    paces the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters, host / iters * 1e6


def queued_ms(torch, fn, host_us: float, iters: int = 20):
    """Mean device time of ``fn`` in ms with the host's enqueue hidden:
    the card spins (``torch.cuda._sleep``) while the host enqueues
    ``iters`` calls, so CUDA events around them time the calls back to
    back on the device alone.  The spin is sized from ``host_us`` (the
    host's time a call) and doubled until it outlasts the enqueue, which
    is checked against the spin's own events; ``None`` after four
    tries."""
    spin, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = int(host_us * iters * 4e3) + 1_000_000  # ~2x at 2 GHz
    for _ in range(4):
        torch.cuda.synchronize()
        spin.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        b.record()
        b.synchronize()
        if spin.elapsed_time(a) > host * 1.1e3 + 0.05:
            return a.elapsed_time(b) / iters
        cycles *= 2
    return None


#: bytes read before each launch that :func:`device_ms` times, to evict
#: its operands from the 50 MB L2 cache (a read leaves no dirty lines for
#: the launch to write back)
L2_FLUSH_BYTES = 128 << 20
_FLUSH = []


def device_ms(torch, fn, host_us: float, iters: int = 20):
    """Mean device time of one call of ``fn`` in ms, the host's enqueue
    hidden and the L2 cache cold, as the bound assumes (every byte from
    HBM): :func:`queued_ms` of a 128 MB read and ``fn``, less that of
    the read alone.  Back to back without the write, a layer's operands
    that fit the L2 stay there from one launch to the next.  ``None``
    where either time is."""
    if not _FLUSH:
        _FLUSH.append(torch.zeros(L2_FLUSH_BYTES // 4, device="cuda"))
    flush = _FLUSH[0].sum
    flush()
    t0 = time.perf_counter()
    flush()
    flush_us = (time.perf_counter() - t0) * 1e6
    both = queued_ms(torch, lambda: (flush(), fn()), host_us + flush_us,
                     iters)
    alone = queued_ms(torch, flush, flush_us, iters)
    return None if both is None or alone is None else both - alone


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (:func:`time_kernel`)."""
    return time_kernel(torch, fn, iters, warmup)[0]


def warm_clocks(torch, seconds: float = 0.5) -> None:
    """Keep the card busy for ``seconds`` so that the timings after it do
    not catch its clocks ramping up."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def _ms(t) -> str:
    return "none" if t is None else f"{t:.4f}"


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


#: the bias+ReLU kernels run at conv3-5 under ``fused`` and at conv1-5
#: under ``pallas_lrn``; their rows sum all five
BIAS_RELU_LAYERS = {"conv3": (13, 384), "conv4": (13, 384),
                    "conv5": (13, 256), "conv1": (55, 96), "conv2": (27, 256)}
#: kernel -> (source, TPU kernel it replaces, {layer: (plane, channels)})
KERNELS = {
    "fused_block_fwd": ("znicz_torch/csrc/fused_block.cu",
                        "znicz_tpu/pallas_fused_block.py:112",
                        {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_fwd": ("znicz_torch/csrc/bias_relu.cu",
                      "znicz_tpu/pallas_fused_block.py:392", BIAS_RELU_LAYERS),
    "lrn_fwd": ("znicz_torch/csrc/lrn.cu", "znicz_tpu/ops/lrn_pallas.py:78",
                {"conv1": (55, 96), "conv2": (27, 256)}),
    "fused_block_bwd": ("znicz_torch/csrc/fused_block_bwd.cu",
                        "znicz_tpu/pallas_fused_block.py:125",
                        {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_bwd": ("znicz_torch/csrc/bias_relu_bwd.cu",
                      "znicz_tpu/pallas_fused_block.py:400", BIAS_RELU_LAYERS),
    "lrn_bwd": ("znicz_torch/csrc/lrn_bwd.cu",
                "znicz_tpu/ops/lrn_pallas.py:86",
                {"conv1": (55, 96), "conv2": (27, 256)}),
    # the bf16 operand variants (phase 10): compute_dtype bf16 under
    # ``fused`` runs the bias+ReLU kernels at conv3-5, under
    # ``pallas_lrn`` at conv1-5, with the standalone LRN kernels
    "fused_block_bf16_fwd": ("znicz_torch/csrc/fused_block.cu",
                             "znicz_tpu/pallas_fused_block.py:112",
                             {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_bf16_fwd": ("znicz_torch/csrc/bias_relu.cu",
                           "znicz_tpu/pallas_fused_block.py:392",
                           BIAS_RELU_LAYERS),
    "lrn_bf16_fwd": ("znicz_torch/csrc/lrn.cu",
                     "znicz_tpu/ops/lrn_pallas.py:78",
                     {"conv1": (55, 96), "conv2": (27, 256)}),
    "fused_block_bf16_bwd": ("znicz_torch/csrc/fused_block_bwd.cu",
                             "znicz_tpu/pallas_fused_block.py:125",
                             {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_bf16_bwd": ("znicz_torch/csrc/bias_relu_bwd.cu",
                           "znicz_tpu/pallas_fused_block.py:400",
                           BIAS_RELU_LAYERS),
    "lrn_bf16_bwd": ("znicz_torch/csrc/lrn_bwd.cu",
                     "znicz_tpu/ops/lrn_pallas.py:86",
                     {"conv1": (55, 96), "conv2": (27, 256)}),
}
#: the bf16 operand variants, checked and run in phase 10
BF16_KERNELS = ("fused_block_bf16_fwd", "bias_relu_bf16_fwd", "lrn_bf16_fwd",
                "fused_block_bf16_bwd", "bias_relu_bf16_bwd", "lrn_bf16_bwd")


def counters():
    """kernel name -> its wrapper, whose ``.launches`` counts it: each call
    that launches, and each replay of a captured step that holds it
    (``znicz_torch/parallel/graphs.py`` adds a capture's launches per
    replay)."""
    from znicz_torch.parallel.graphs import counted

    by_name = {fn.__name__: fn for fn in counted()}
    return {name: by_name[name] for name in KERNELS}


def _case(torch, name, x, b, gen, n, alpha, beta, k, pool):
    """(kernel fn, plain fn, library fn or None, bytes, operations) of
    kernel ``name`` on the raw conv output ``x`` and bias ``b``."""
    import torch.nn.functional as F

    from znicz_torch.fused_block import (bias_relu_bwd, bias_relu_bwd_plain,
                                         bias_relu_fwd, bias_relu_plain,
                                         fused_block_bwd,
                                         fused_block_bwd_plain,
                                         fused_block_fwd, fused_block_plain)
    from znicz_torch.ops.lrn import lrn_bwd, lrn_bwd_plain, lrn_fwd, \
        lrn_plain

    c = x.shape[-1]
    hw = x.shape[1]
    pooled = (x.shape[0], (hw - 3) // 2 + 1, (hw - 3) // 2 + 1, c)
    if name in BF16_KERNELS:
        return _bf16_case(torch, name, x, b, gen, n, alpha, beta, k, pool,
                          pooled)
    if name == "fused_block_fwd":
        out = BATCH * pooled[1] * pooled[2] * c
        return (lambda: fused_block_fwd(x, b, n, alpha, beta, k, pool),
                lambda: fused_block_plain(x, b, n, alpha, beta, k, pool),
                None, 4 * (x.numel() + c + out),
                x.numel() * (n + 8) + out * 8)
    if name == "bias_relu_fwd":
        return (lambda: bias_relu_fwd(x, b), lambda: bias_relu_plain(x, b),
                None, 4 * (2 * x.numel() + c), 2 * x.numel())
    if name == "fused_block_bwd":
        dp = torch.randn(pooled, generator=gen, device="cuda")
        return (lambda: fused_block_bwd(x, b, dp, n, alpha, beta, k, pool),
                lambda: fused_block_bwd_plain(x, b, dp, n, alpha, beta, k,
                                              pool),
                None, 4 * (2 * x.numel() + dp.numel() + 2 * c),
                x.numel() * (3 * n + 20) + dp.numel() * 18)
    if name == "bias_relu_bwd":
        dp = torch.randn(x.shape, generator=gen, device="cuda")
        return (lambda: bias_relu_bwd(x, b, dp),
                lambda: bias_relu_bwd_plain(x, b, dp),
                None, 4 * (3 * x.numel() + 2 * c), 4 * x.numel())
    r = torch.clamp_min(x, 0.0)                 # LRN reads ReLU output
    if name == "lrn_fwd":
        return (lambda: lrn_fwd(r, n, alpha, beta, k),
                lambda: lrn_plain(r, n, alpha, beta, k),
                lambda: F.local_response_norm(
                    r.permute(0, 3, 1, 2), n, alpha * n, beta, k)
                .permute(0, 2, 3, 1),
                4 * 2 * r.numel(), r.numel() * (n + 5))
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    # the library's backward alone: autograd through F.local_response_norm
    # on the NCHW view, its graph built once here and kept
    rn = r.permute(0, 3, 1, 2).detach().requires_grad_(True)
    yn = F.local_response_norm(rn, n, alpha * n, beta, k)
    dyn = dy.permute(0, 3, 1, 2)
    return (lambda: lrn_bwd(r, dy, n, alpha, beta, k),
            lambda: lrn_bwd_plain(r, dy, n, alpha, beta, k),
            lambda: torch.autograd.grad(yn, rn, dyn, retain_graph=True)[0]
            .permute(0, 2, 3, 1),
            4 * 3 * r.numel(), r.numel() * (3 * n + 14))


def _bf16_case(torch, name, x, b, gen, n, alpha, beta, k, pool, pooled):
    """:func:`_case` for a bf16 variant: ``x`` and ``b`` (and the
    cotangent) rounded to bf16; 2 bytes a bf16 element, 4 a db float.
    The LRN kernels' library yardsticks are ``F.local_response_norm`` and
    its autograd backward in bf16."""
    import torch.nn.functional as F

    from znicz_torch import fused_block as fb
    from znicz_torch.ops import lrn

    x, b = x.to(torch.bfloat16), b.to(torch.bfloat16)
    c = x.shape[-1]
    if name.startswith("lrn"):
        r = torch.clamp_min(x, 0.0)             # LRN reads ReLU output
        rn = r.permute(0, 3, 1, 2)
        if name == "lrn_bf16_fwd":
            def kern():
                return lrn.lrn_bf16_fwd(r, n, alpha, beta, k)

            # the "before" column: the simple kernel, same operands
            kern.simple = lambda: lrn._bf16_fwd_launch(r, n, alpha, beta, k,
                                                       None)
            return (kern, lambda: lrn.lrn_plain(r, n, alpha, beta, k),
                    lambda: F.local_response_norm(rn, n, alpha * n, beta, k)
                    .permute(0, 2, 3, 1),
                    2 * 2 * r.numel(), r.numel() * (n + 5))
        dy = torch.randn(r.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        rn = rn.detach().requires_grad_(True)
        yn = F.local_response_norm(rn, n, alpha * n, beta, k)
        dyn = dy.permute(0, 3, 1, 2)

        def kern():
            return lrn.lrn_bf16_bwd(r, dy, n, alpha, beta, k)

        kern.simple = lambda: lrn._bf16_bwd_launch(r, dy, n, alpha, beta, k,
                                                   None)
        return (kern, lambda: lrn.lrn_bwd_plain(r, dy, n, alpha, beta, k),
                lambda: torch.autograd.grad(yn, rn, dyn, retain_graph=True)[0]
                .permute(0, 2, 3, 1),
                2 * 3 * r.numel(), r.numel() * (3 * n + 14))
    if name == "fused_block_bf16_fwd":
        out = BATCH * pooled[1] * pooled[2] * c

        def kern():
            return fb.fused_block_bf16_fwd(x, b, n, alpha, beta, k, pool)

        # the "before" column: the simple kernel on the same operands
        kern.simple = lambda: fb._bf16_fwd_launch(x, b, n, alpha, beta, k,
                                                  pool, None)
        return (kern,
                lambda: fb.fused_block_plain(x, b, n, alpha, beta, k, pool),
                None, 2 * (x.numel() + c + out),
                x.numel() * (n + 8) + out * 8)
    if name == "bias_relu_bf16_fwd":
        def kern():
            return fb.bias_relu_bf16_fwd(x, b)

        kern.simple = lambda: fb._bf16_relu_fwd_launch(x, b, "simple")
        return (kern, lambda: fb.bias_relu_plain(x, b),
                None, 2 * (2 * x.numel() + c), 2 * x.numel())
    if name == "fused_block_bf16_bwd":
        dp = torch.randn(pooled, generator=gen, device="cuda").to(
            torch.bfloat16)

        def kern():
            return fb.fused_block_bf16_bwd(x, b, dp, n, alpha, beta, k, pool)

        kern.simple = lambda: fb._bf16_bwd_launch(x, b, dp, n, alpha, beta,
                                                  k, pool, None)
        return (kern,
                lambda: fb.fused_block_bwd_plain(x, b, dp, n, alpha, beta, k,
                                                 pool),
                None, 2 * (2 * x.numel() + dp.numel() + c) + 4 * c,
                x.numel() * (3 * n + 20) + dp.numel() * 18)
    dp = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)

    def kern():
        return fb.bias_relu_bf16_bwd(x, b, dp)

    kern.simple = lambda: fb._bf16_relu_bwd_launch(x, b, dp, None)
    return (kern, lambda: fb.bias_relu_bwd_plain(x, b, dp),
            None, 2 * (3 * x.numel() + c) + 4 * c, 4 * x.numel())


def check_kernels(torch, names, shapes=None, batch=BATCH):
    """Each kernel of ``names`` against its plain version at AlexNet's
    batch-128 shapes, or at ``shapes[name]`` ({layer: (plane, channels)})
    and ``batch``.  Returns {kernel: accumulated JSON row}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, alpha, beta, k, pool = 5, 1e-4, 0.75, 2.0, (3, 3, 2, 2)
    warm_clocks(torch)
    rows = {}
    for name in names:
        source, replaces, layers = KERNELS[name]
        layers = (shapes or {}).get(name, layers)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": None, "host_us": 0.0}
        for layer, (hw, c) in layers.items():
            x = torch.randn((batch, hw, hw, c), generator=gen,
                            device="cuda") * 2.0
            b = torch.randn((c,), generator=gen, device="cuda") * 0.1
            kern, plain, lib, nbytes, ops = _case(torch, name, x, b, gen, n,
                                                  alpha, beta, k, pool)
            if name in BF16_PLANNED and PLANS[name](x, b) == "simple":
                raise AssertionError(f"{name}[{layer}]: the planner took "
                                     f"the simple kernel")
            got, want = kern(), plain()
            torch.cuda.synchronize()
            db_note, db_ok = "", True
            if isinstance(got, tuple):          # backward: (dx, db)
                (got, got_db), (want, want_db) = got, want
                db_ok, db_note = db_check(torch, got_db, want_db, want)
                if name in ("bias_relu_bwd",) + BF16_KERNELS:
                    again = deterministic_db(torch, kern, got_db)
                    db_ok = db_ok and again
                    db_note += f" db_same_bits_twice={again}"
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name}[{layer}]: {got.dtype} "
                                     f"{tuple(got.shape)} vs plain "
                                     f"{want.dtype} {tuple(want.shape)}")
            err = (got.float() - want.float()).abs()
            limit = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
            max_err = float(err.max())
            rel = float((err / want.float().abs().clamp_min(1e-30)).max())
            ok = bool((err <= limit).all()) and bool(
                torch.isfinite(got).all()) and db_ok
            if name in BF16_KERNELS:
                bits = same_bits(torch, got, want)
                ok = ok and bits
                db_note += f" same_bits={bits}"
            if name in BF16_LRN + BF16_PLANNED:
                again = kern()
                again = same_bits(torch, again[0] if isinstance(again, tuple)
                                  else again, got)
                ok = ok and again
                db_note += f" same_bits_twice={again}"
            simple, t_s = getattr(kern, "simple", None), None
            if simple is not None:              # the simple kernel, timed
                first = simple()
                first = first[0] if isinstance(first, tuple) else first
                bits = same_bits(torch, first, want)
                ok = ok and bits
                t_s, s_host = time_kernel(torch, simple)
                t_sq = device_ms(torch, simple, s_host)
                db_note += (f" simple_same_bits={bits} simple_ms={t_s:.4f} "
                            f"simple_device_ms={_ms(t_sq)}")
                del first
            lib_err = None
            if lib is not None:
                lib_err = float((lib() - want).abs().max())
            del got, want
            t_k, host_us = time_kernel(torch, kern)
            t_q = device_ms(torch, kern, host_us)
            t_p = cuda_ms(torch, plain, iters=5, warmup=1)
            t_l = None if lib is None else cuda_ms(torch, lib)
            b_ms, b_by = bound_ms(nbytes, ops)
            log(f"[kernel] {name}[{layer}] shape={tuple(x.shape)} "
                f"max_abs_err={max_err:.3e} max_rel_err={rel:.3e} "
                f"tol=|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|plain|{db_note} "
                f"ms={t_k:.4f} host_us={host_us:.1f} device_ms={_ms(t_q)} "
                f"plain_ms={t_p:.4f} "
                f"bound_us={b_ms * 1e3:.2f} ({b_by}, {nbytes / 1e6:.1f} MB)"
                + (" library_ms=none" if t_l is None else
                   f" library_ms={t_l:.4f} library_err={lib_err:.3e}")
                + (f" plan={PLANS[name](x, b)}" if name in PLANS else "")
                + f" -> {'ok' if ok else 'FAIL'}")
            if not ok or (name in BIT_EXACT and max_err != 0.0):
                raise AssertionError(f"{name}[{layer}] disagrees with its "
                                     f"plain version: {max_err:.3e}")
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
            row["ms"] += t_k
            row["host_us"] += host_us
            if t_q is not None and row.get("device_ms", 0.0) is not None:
                row["device_ms"] = row.get("device_ms", 0.0) + t_q
            else:
                row["device_ms"] = None
            row["plain_ms"] += t_p
            row["bound_ms"] += b_ms
            row["bound_by"] = b_by
            if t_l is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + t_l
            if t_s is not None:
                row["simple_ms"] = row.get("simple_ms", 0.0) + t_s
                if t_sq is not None and \
                        row.get("simple_device_ms", 0.0) is not None:
                    row["simple_device_ms"] = row.get(
                        "simple_device_ms", 0.0) + t_sq
                else:
                    row["simple_device_ms"] = None
            del x, b, kern, plain, lib, simple
            torch.cuda.empty_cache()
        rows[name] = row
    return rows


#: the bf16 LRN kernels, which compute in bf16 as the reference's do
BF16_LRN = ("lrn_bf16_fwd", "lrn_bf16_bwd")
#: the bf16 K1 and K1b, which run the float32 ring kernels on bf16 rows,
#: and the bf16 K3 and K3b, which run the float32 K3's and K3b's ring
#: design on 8-channel units, where their planners take the shape, and
#: the simple kernels elsewhere; at AlexNet's (and CIFAR10's) shapes the
#: ring must run
BF16_RING = ("fused_block_bf16_fwd", "fused_block_bf16_bwd", "lrn_bf16_fwd",
             "lrn_bf16_bwd")
#: the bf16 K2 and K2b, which run the float32 K2's and K2b's design on
#: 16-byte units of eight bf16 where their planners take the shape (C % 8
#: == 0, 16-byte aligned operands), the simple kernels elsewhere; at
#: AlexNet's and CIFAR10's shapes the 16-byte kernels must run
BF16_VEC = ("bias_relu_bf16_fwd", "bias_relu_bf16_bwd")
#: the bf16 kernels with a planned route and a simple kernel beside it
BF16_PLANNED = BF16_RING + BF16_VEC
#: kernels whose output (dx for a backward) must equal the plain version's
#: bits
BIT_EXACT = ("fused_block_fwd", "fused_block_bwd", "lrn_fwd",
             "bias_relu_bwd", "lrn_bwd") + BF16_KERNELS


def same_bits(torch, a, b) -> bool:
    """Whether float32 or bf16 tensors ``a`` and ``b`` hold the same bits,
    signed zeros and NaNs included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.view(view), b.view(view))


def deterministic_db(torch, kern, db) -> bool:
    """Whether a second launch of ``kern`` gives ``db``'s bits again."""
    _, again = kern()
    torch.cuda.synchronize()
    return same_bits(torch, again, db)


def db_check(torch, got_db, want_db, want_dx, nonfinite=False):
    """(ok, note) of a bias gradient against the plain version's: per
    channel |d| <= DB_RTOL * sum|dx|, and finite; with ``nonfinite``, the
    channels where the plain db is NaN or inf must be NaN or the same inf,
    and the others are held so."""
    scale = want_dx.float().abs().sum(dim=tuple(range(want_dx.ndim - 1)))
    db_err = (got_db - want_db).abs()
    fin = torch.isfinite(want_db) if nonfinite else torch.ones_like(
        want_db, dtype=torch.bool)
    ok = bool((db_err[fin] <= DB_RTOL * scale[fin]).all()) and bool(
        torch.isfinite(got_db[fin]).all())
    if nonfinite:
        ok = ok and torch.equal(got_db.isnan(), want_db.isnan()) and \
            torch.equal(got_db[want_db.isinf()], want_db[want_db.isinf()])
    rel = float((db_err[fin] / scale[fin].clamp_min(1e-30)).max())
    return ok, (f" db_max_abs_err={float(db_err.max()):.3e} "
                f"db_max_rel_to_sum={rel:.3e} "
                f"db_tol=|d|<={DB_RTOL:g}*sum|dx|")


def k1_plan(x, b, n=5, pool=(3, 3, 2, 2)):
    from znicz_torch.fused_block import fwd_plan_for

    p = fwd_plan_for(x, b, n, pool)
    return (f"{'float4+bulk' if p.vec else 'scalar+cp.async'}/"
            f"strips={p.n_strips}/stages={p.stages}/smem={p.smem}/"
            f"blocks_per_sm={p.blocks_per_sm}")


#: K1 beyond AlexNet's case, each bit-exact against its plain version:
#: (what it takes, shape, pool, n, alpha, beta, k, input scale, whether
#: its planner must pick the float4 path).  beta 0.6 takes powf on both
#: sides (PyTorch's pow special-cases -0.5); the x100 input with k 1e-3
#: spreads s over about 20 binades through the rsqrt/sqrt fast path
K1_PATHS = [
    ("scalar, C%4!=0", (5, 27, 27, 33), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     2.0, False),
    ("scalar, even window", (4, 27, 27, 64), (3, 3, 2, 2), 4, 1e-4, 0.75,
     2.0, 2.0, False),
    ("scalar, powf", (3, 13, 13, 33), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0,
     False),
    ("float4, short strips", (3, 13, 13, 20), (3, 3, 2, 2), 5, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 2x2/2", (4, 26, 26, 32), (2, 2, 2, 2), 5, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 4x4/2", (4, 12, 12, 32), (4, 4, 2, 2), 3, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 1x1/4", (4, 9, 9, 24), (1, 1, 4, 4), 7, 1e-4, 0.75, 2.0,
     2.0, True),
    ("float4, powf", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0,
     True),
    ("float4, s over 20 binades", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-2,
     0.75, 1e-3, 100.0, True),
]


def check_k1_paths(torch):
    """K1 at each case of :data:`K1_PATHS`, bit-exact against its plain
    version; reported on their own lines, outside the AlexNet row."""
    from znicz_torch.fused_block import (fused_block_fwd, fused_block_plain,
                                         fwd_plan_for)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for label, shape, pool, n, alpha, beta, k, scale, vec in K1_PATHS:
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        b = torch.randn(shape[-1:], generator=gen, device="cuda") * 0.1
        if fwd_plan_for(x, b, n, pool).vec != vec:
            raise AssertionError(f"K1 {label}: planner took the wrong "
                                 f"path: {k1_plan(x, b, n, pool)}")

        def kern():
            return fused_block_fwd(x, b, n, alpha, beta, k, pool)

        got, want = kern(), fused_block_plain(x, b, n, alpha, beta, k, pool)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = got.shape == want.shape and err == 0.0 and bool(
            torch.isfinite(got).all())
        log(f"[kernel] fused_block_fwd[{label}] shape={shape} pool={pool} "
            f"n={n} alpha={alpha:g} beta={beta:g} k={k:g} x*{scale:g} "
            f"plan={k1_plan(x, b, n, pool)} max_abs_err={err:.3e} "
            f"(bit-exact required) ms={cuda_ms(torch, kern):.4f} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version: {err:.3e}")


def k1b_plan(x, b, n=5, pool=(3, 3, 2, 2), dp=None):
    from znicz_torch.fused_block import bwd_plan_for

    p = bwd_plan_for(x, b, n, pool, dp)
    return (f"{'float4+bulk' if p.vec else 'scalar+cp.async'}/"
            f"strips={p.n_strips}/ctiles={p.n_ctiles}/stages={p.stages}/"
            f"smem={p.smem}/blocks_per_sm={p.blocks_per_sm}")


def k1_bf16_plan(x, b, n=5, pool=(3, 3, 2, 2)):
    from znicz_torch.fused_block import bf16_fwd_plan_for

    p = bf16_fwd_plan_for(x, b, n, pool)
    if p is None:
        return "simple"
    return (f"ring:bf16x4+bulk/strips={p.n_strips}/stages={p.stages}/"
            f"smem={p.smem}/blocks_per_sm={p.blocks_per_sm}")


def k1b_bf16_plan(x, b, n=5, pool=(3, 3, 2, 2), dp=None):
    from znicz_torch.fused_block import bf16_bwd_plan_for

    p = bf16_bwd_plan_for(x, b, n, pool, dp)
    if p is None:
        return "simple"
    return (f"ring:bf16x4+bulk/strips={p.n_strips}/ctiles={p.n_ctiles}/"
            f"stages={p.stages}/smem={p.smem}/"
            f"blocks_per_sm={p.blocks_per_sm}")


def k3_plan(x, b=None, n=5):
    from znicz_torch.ops.lrn import fwd_plan_for

    p = fwd_plan_for(x, n)
    return (f"{'float4' if p.vec else 'scalar'}/threads_per_row="
            f"{p.threads_per_row}/rows={p.rows}/blocks={p.blocks}/"
            f"groups_per_block={p.groups_per_block}/stages={p.stages}/"
            f"smem={p.smem}/blocks_per_sm={p.blocks_per_sm}/window="
            f"{p.lo}+{p.taps}")


def k3b_plan(x, b=None, n=5, dy=None):
    from znicz_torch.ops.lrn import bwd_plan_for

    p = bwd_plan_for(x, x if dy is None else dy, n)
    units = x.shape[-1] // 4 if p.vec else x.shape[-1]
    return (f"{'float4' if p.vec else 'scalar'}/threads_per_row="
            f"{p.threads_per_row}/rows={p.rows}/blocks={p.blocks}/"
            f"groups_per_block={p.groups_per_block}/stages={p.stages}/"
            f"smem={p.smem}/blocks_per_sm={p.blocks_per_sm}/window="
            f"{p.lo}+{p.taps}/units_per_thread="
            f"{-(-units // p.threads_per_row)}")


def k3_bf16_plan(x, b=None, n=5):
    from znicz_torch.ops.lrn import bf16_fwd_plan_for

    return _bf16_lrn_plan(bf16_fwd_plan_for(x, n))


def k3b_bf16_plan(x, b=None, n=5, dy=None):
    from znicz_torch.ops.lrn import bf16_bwd_plan_for

    return _bf16_lrn_plan(bf16_bwd_plan_for(x, x if dy is None else dy, n))


def _bf16_lrn_plan(p):
    if p is None:
        return "simple"
    return (f"ring:bf16x8/threads_per_row={p.threads_per_row}/rows={p.rows}/"
            f"blocks={p.blocks}/groups_per_block={p.groups_per_block}/"
            f"stages={p.stages}/smem={p.smem}/blocks_per_sm="
            f"{p.blocks_per_sm}/window={p.lo}+{p.taps}")


def k2b_plan(x, b, dp=None):
    from znicz_torch.fused_block import bias_relu_bwd_plan_for

    p = bias_relu_bwd_plan_for(x, b, x if dp is None else dp)
    return (f"{'float4' if p.vec else 'scalar'}/threads_per_row="
            f"{p.threads_per_row}/rows={p.rows}/chunks={p.chunks}/"
            f"row_blocks={p.row_blocks}/splits={p.splits}/smem={p.smem}")


def k2_bf16_plan(x, b, dp=None):
    from znicz_torch.fused_block import _aligned16, _bf16_relu_fwd_route

    route = _bf16_relu_fwd_route(x.shape[-1], _aligned16(x, b))
    return "simple" if route == "simple" else f"{route}/units={x.numel() // 8}"


def k2b_bf16_plan(x, b, dp=None):
    from znicz_torch.fused_block import bf16_relu_bwd_plan_for

    p = bf16_relu_bwd_plan_for(x, b, x if dp is None else dp)
    if p is None:
        return "simple"
    return (f"bf16x8/threads_per_row={p.threads_per_row}/rows={p.rows}/"
            f"chunks={p.chunks}/row_blocks={p.row_blocks}/splits={p.splits}/"
            f"smem={p.smem}")


#: kernel -> its plan as printed on its ``[kernel]`` lines
PLANS = {"fused_block_fwd": k1_plan, "fused_block_bwd": k1b_plan,
         "lrn_fwd": k3_plan, "bias_relu_bwd": k2b_plan, "lrn_bwd": k3b_plan,
         "fused_block_bf16_fwd": k1_bf16_plan,
         "fused_block_bf16_bwd": k1b_bf16_plan, "lrn_bf16_fwd": k3_bf16_plan,
         "lrn_bf16_bwd": k3b_bf16_plan, "bias_relu_bf16_fwd": k2_bf16_plan,
         "bias_relu_bf16_bwd": k2b_bf16_plan}


def unaligned(torch, t, offset: int = 4):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    16-byte boundary: operands like it take the kernels' scalar paths."""
    shift = offset // t.element_size()
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = buf[shift:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == offset
    return out


#: K3 beyond AlexNet's case, each bit-exact against its plain version:
#: (what it takes, shape, n, alpha, beta, k, input scale, whether its
#: planner must pick the float4 path, whether x lies off a 16-byte
#: boundary).  n 5 on the float4 path is unrolled, every other window
#: loops over its taps; beta 0.6 takes powf on both sides; 23328 rows are
#: no multiple of conv1's 21-row groups and give each block two groups
#: through its ring; C 4000 gives a thread four float4 units and a block
#: more than 48 KB of shared memory; CIFAR10's norm has four float4 units a
#: row, two threads of two units each, and its window spans most of a row
K3_PATHS = [
    ("float4, C 96", (4, 13, 13, 96), 5, 1e-4, 0.75, 2.0, 2.0, True, False),
    ("float4, C 256", (4, 13, 13, 256), 5, 1e-4, 0.75, 2.0, 2.0, True,
     False),
    ("scalar, C 33", (5, 9, 9, 33), 5, 1e-4, 0.75, 2.0, 2.0, False, False),
    ("float4, even window n 4", (4, 9, 9, 64), 4, 1e-4, 0.75, 2.0, 2.0,
     True, False),
    ("float4, even window n 2", (4, 9, 9, 64), 2, 1e-4, 0.75, 2.0, 2.0,
     True, False),
    ("float4, n 1", (3, 9, 9, 32), 1, 1e-4, 0.75, 2.0, 2.0, True, False),
    ("float4, n 7", (3, 9, 9, 32), 7, 1e-4, 0.75, 2.0, 2.0, True, False),
    ("scalar, C 3 < n 5", (6, 9, 9, 3), 5, 1e-4, 0.75, 2.0, 2.0, False,
     False),
    ("float4, powf beta 0.6", (4, 13, 13, 96), 5, 1e-4, 0.6, 2.0, 2.0,
     True, False),
    ("float4, s over 20 binades", (4, 13, 13, 96), 5, 1e-2, 0.75, 1e-3,
     100.0, True, False),
    ("float4, C 1024", (2, 7, 7, 1024), 5, 1e-4, 0.75, 2.0, 2.0, True,
     False),
    ("float4, two groups a block, ragged last group", (32, 27, 27, 96), 5,
     1e-4, 0.75, 2.0, 2.0, True, False),
    ("scalar, unaligned operand", (4, 9, 9, 64), 5, 1e-4, 0.75, 2.0, 2.0,
     False, True),
    ("float4, C 4000, four units a thread, past 48 KB", (2, 3, 5, 4000), 5,
     1e-4, 0.75, 2.0, 2.0, True, False),
    ("float4, CIFAR10's norm, C 16: two threads a row", (100, 16, 16, 16), 5,
     1e-4, 0.75, 2.0, 2.0, True, False),
]


def check_k3_paths(torch):
    """K3 at each case of :data:`K3_PATHS`, bit-exact against its plain
    version; reported on their own lines, outside the AlexNet row."""
    from znicz_torch.ops.lrn import fwd_plan_for, lrn_fwd, lrn_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for label, shape, n, alpha, beta, k, scale, vec, off in K3_PATHS:
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        if off:
            x = unaligned(torch, x)
        plan = k3_plan(x, n=n)
        if fwd_plan_for(x, n).vec != vec:
            raise AssertionError(f"K3 {label}: planner took the wrong "
                                 f"path: {plan}")

        def kern():
            return lrn_fwd(x, n, alpha, beta, k)

        got, want = kern(), lrn_plain(x, n, alpha, beta, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = same_bits(torch, got, want) and bool(torch.isfinite(got).all())
        log(f"[kernel] lrn_fwd[{label}] shape={shape} n={n} "
            f"alpha={alpha:g} beta={beta:g} k={k:g} x*{scale:g} plan={plan} "
            f"max_abs_err={err:.3e} (bit-exact required) "
            f"ms={cuda_ms(torch, kern):.4f} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 {label} disagrees with its plain "
                                 f"version: {err:.3e}")


#: K3b beyond AlexNet's case, dx bit-exact (signed zeros included)
#: against its plain version: (what it takes, shape, n, alpha, beta, k,
#: input scale, whether its planner must pick the float4 path, the operand
#: that lies off a 16-byte boundary, whether x is mostly zeros and dy holds
#: +0s and -0s).  x is ReLU output, as on the main path.  As K3_PATHS;
#: besides, rows of C 601 (scalar) and C 4000 (float4) give a thread more
#: than two units, so it keeps x and dy * sb in the ring, not in registers;
#: the zero-heavy cases give windows of t that are all -0 (n 1: t itself);
#: CIFAR10's norm as in K3_PATHS
K3B_PATHS = [
    ("float4, C 96", (4, 13, 13, 96), 5, 1e-4, 0.75, 2.0, 2.0, True, "",
     False),
    ("float4, C 256", (4, 13, 13, 256), 5, 1e-4, 0.75, 2.0, 2.0, True, "",
     False),
    ("scalar, C 33", (5, 9, 9, 33), 5, 1e-4, 0.75, 2.0, 2.0, False, "",
     False),
    ("float4, even window n 4", (4, 13, 13, 64), 4, 1e-4, 0.75, 2.0, 2.0,
     True, "", False),
    ("float4, even window n 2", (4, 9, 9, 64), 2, 1e-4, 0.75, 2.0, 2.0,
     True, "", False),
    ("float4, n 1", (3, 9, 9, 32), 1, 1e-4, 0.75, 2.0, 2.0, True, "",
     False),
    ("float4, n 7", (3, 9, 9, 32), 7, 1e-4, 0.75, 2.0, 2.0, True, "",
     False),
    ("scalar, C 3 < n 5", (6, 9, 9, 3), 5, 1e-4, 0.75, 2.0, 2.0, False, "",
     False),
    ("float4, powf beta 0.6", (4, 13, 13, 96), 5, 1e-4, 0.6, 2.0, 2.0,
     True, "", False),
    ("float4, s over 20 binades", (4, 13, 13, 96), 5, 1e-2, 0.75, 1e-3,
     100.0, True, "", False),
    ("float4, C 1024", (2, 7, 7, 1024), 5, 1e-4, 0.75, 2.0, 2.0, True, "",
     False),
    ("float4, several groups a block, ragged last group", (32, 27, 27, 96),
     5, 1e-4, 0.75, 2.0, 2.0, True, "", False),
    ("scalar, unaligned x", (4, 9, 9, 64), 5, 1e-4, 0.75, 2.0, 2.0, False,
     "x", False),
    ("scalar, unaligned dy", (4, 9, 9, 64), 5, 1e-4, 0.75, 2.0, 2.0, False,
     "dy", False),
    ("scalar, C 601, three units a thread in the ring", (2, 9, 9, 601), 5,
     1e-4, 0.75, 2.0, 2.0, False, "", False),
    ("float4, C 4000, four units a thread in the ring, past 48 KB",
     (2, 3, 5, 4000), 5, 1e-4, 0.75, 2.0, 2.0, True, "", False),
    ("float4, zero-heavy x, +-0 in dy", (4, 13, 13, 96), 5, 1e-4, 0.75, 2.0,
     2.0, True, "", True),
    ("float4, n 1, zero-heavy x, +-0 in dy", (3, 9, 9, 32), 1, 1e-4, 0.75,
     2.0, 2.0, True, "", True),
    ("float4, CIFAR10's norm, C 16: two threads a row", (100, 16, 16, 16), 5,
     1e-4, 0.75, 2.0, 2.0, True, "", False),
]


def check_k3b_paths(torch):
    """K3b at each case of :data:`K3B_PATHS`, dx bit-exact against its
    plain version; reported on their own lines, outside the AlexNet row."""
    from znicz_torch.ops.lrn import bwd_plan_for, lrn_bwd, lrn_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for (label, shape, n, alpha, beta, k, scale, vec, off,
         zeros) in K3B_PATHS:
        x = torch.randn(shape, generator=gen, device="cuda")
        x = torch.clamp_min((x - 0.8 if zeros else x) * scale, 0.0)
        dy = torch.randn(shape, generator=gen, device="cuda")
        if zeros:                       # a quarter +0, a quarter -0
            u = torch.rand(shape, generator=gen, device="cuda")
            z = torch.zeros_like(dy)
            dy = torch.where(u < 0.25, z, torch.where(u < 0.5, -z, dy))
        if off == "x":
            x = unaligned(torch, x)
        elif off == "dy":
            dy = unaligned(torch, dy)
        plan = k3b_plan(x, n=n, dy=dy)
        if bwd_plan_for(x, dy, n).vec != vec:
            raise AssertionError(f"K3b {label}: planner took the wrong "
                                 f"path: {plan}")

        def kern():
            return lrn_bwd(x, dy, n, alpha, beta, k)

        got, want = kern(), lrn_bwd_plain(x, dy, n, alpha, beta, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = same_bits(torch, got, want) and bool(torch.isfinite(got).all())
        neg0 = int(((want == 0) & torch.signbit(want)).sum())
        log(f"[kernel] lrn_bwd[{label}] shape={shape} n={n} "
            f"alpha={alpha:g} beta={beta:g} k={k:g} x*{scale:g} plan={plan} "
            f"max_abs_err={err:.3e} (bit-exact required, dx -0s {neg0}) "
            f"ms={cuda_ms(torch, kern):.4f} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3b {label} disagrees with its plain "
                                 f"version: {err:.3e}")


#: K2b beyond AlexNet's case, dx bit-exact (signed zeros included), db
#: within DB_RTOL and the same bits on a second launch: (what it takes,
#: shape, whether its planner must pick the float4 path, whether x lies
#: off a 16-byte boundary).  C 1536 is past the old kernel's 1024 limit;
#: its unaligned twin takes three channel chunks; CIFAR10's three
#: convolutions have C 16 and 32 at a batch of 100, Kanji's C 16 and 32 at
#: 128, YaleFaces' C 8 and 16 at 32
K2B_PATHS = [
    ("float4, C 96", (4, 13, 13, 96), True, False),
    ("float4, C 256", (4, 13, 13, 256), True, False),
    ("float4, C 384", (4, 13, 13, 384), True, False),
    ("scalar, C 33", (5, 9, 9, 33), False, False),
    ("scalar, C 1", (3, 17, 17, 1), False, False),
    ("float4, C 1536", (2, 9, 9, 1536), True, False),
    ("scalar, C 1536, three chunks", (2, 9, 9, 1536), False, True),
    ("float4, one row", (1, 1, 1, 256), True, False),
    ("scalar, unaligned operand", (4, 9, 9, 64), False, True),
    ("float4, CIFAR10's conv1, C 16", (100, 32, 32, 16), True, False),
    ("float4, CIFAR10's conv2, C 32", (100, 16, 16, 32), True, False),
    ("float4, CIFAR10's conv3, C 32", (100, 8, 8, 32), True, False),
    ("float4, Kanji's conv1, C 16", (128, 24, 24, 16), True, False),
    ("float4, Kanji's conv2, C 32", (128, 12, 12, 32), True, False),
    ("float4, YaleFaces' conv1, C 8", (32, 32, 32, 8), True, False),
    ("float4, YaleFaces' conv2, C 16", (32, 16, 16, 16), True, False),
]


def check_k2b_paths(torch):
    """K2b at each case of :data:`K2B_PATHS`; x = -b at a quarter of the
    elements shuts the strict gate exactly."""
    from znicz_torch.fused_block import (bias_relu_bwd,
                                         bias_relu_bwd_plain,
                                         bias_relu_bwd_plan_for)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for label, shape, vec, off in K2B_PATHS:
        x = torch.randn(shape, generator=gen, device="cuda")
        b = torch.randn(shape[-1:], generator=gen, device="cuda") * 0.3
        shut = torch.rand(shape, generator=gen, device="cuda") < 0.25
        x = torch.where(shut, -b.expand(shape), x)
        dp = torch.randn(shape, generator=gen, device="cuda")
        if off:
            x = unaligned(torch, x)
        plan = k2b_plan(x, b, dp)
        if bias_relu_bwd_plan_for(x, b, dp).vec != vec:
            raise AssertionError(f"K2b {label}: planner took the wrong "
                                 f"path: {plan}")

        def kern():
            return bias_relu_bwd(x, b, dp)

        got, got_db = kern()
        want, want_db = bias_relu_bwd_plain(x, b, dp)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        db_ok, db_note = db_check(torch, got_db, want_db, want)
        again = deterministic_db(torch, kern, got_db)
        ok = same_bits(torch, got, want) and db_ok and again
        log(f"[kernel] bias_relu_bwd[{label}] shape={shape} plan={plan} "
            f"max_abs_err={err:.3e} (bit-exact required){db_note} "
            f"db_same_bits_twice={again} ms={cuda_ms(torch, kern):.4f} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2b {label} disagrees with its plain "
                                 f"version: {err:.3e}, db ok {db_ok}, "
                                 f"deterministic {again}")


def tie_heavy(torch, shape, gen):
    """Each image a channel vector scaled by 1 or 2 per pixel and rounded
    to quarters, so that pixels of one scale have equal y and windows tie
    on non-zero maxima; image 0 is spatially constant (every window a
    full tie)."""
    B, H, W, C = shape
    scale = 1.0 + torch.randint(0, 2, (B, H, W, 1), generator=gen,
                                device="cuda").float()
    scale[0] = 1.0
    chan = torch.randn((B, 1, 1, C), generator=gen, device="cuda")
    return torch.round(chan * scale * 4.0) / 4.0


#: K1b beyond AlexNet's case, each bit-exact on dx against its plain
#: version (db within DB_RTOL): (what it takes, shape, pool, n, alpha,
#: beta, k, input scale or "ties", whether its planner must pick the
#: float4 path).  As K1_PATHS; the later cases cut strips and column
#: tiles together at conv2's width, tie non-zero maxima, give a thread
#: two channels (C > 512 on the scalar path) and several pooled columns
#: (C 1024), whose second pooling phase recomputes its horizontal maxima
K1B_PATHS = [
    ("scalar, C%4!=0", (5, 27, 27, 33), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     2.0, False),
    ("scalar, even window", (4, 27, 27, 64), (3, 3, 2, 2), 4, 1e-4, 0.75,
     2.0, 2.0, False),
    ("scalar, powf", (3, 13, 13, 33), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0,
     False),
    ("float4, short strips", (3, 13, 13, 20), (3, 3, 2, 2), 5, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 2x2/2", (4, 26, 26, 32), (2, 2, 2, 2), 5, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 4x4/2", (4, 12, 12, 32), (4, 4, 2, 2), 3, 1e-4, 0.75,
     2.0, 2.0, True),
    ("float4, pool 1x1/4", (4, 9, 9, 24), (1, 1, 4, 4), 7, 1e-4, 0.75, 2.0,
     2.0, True),
    ("float4, powf", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0,
     True),
    ("float4, s over 20 binades", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-2,
     0.75, 1e-3, 100.0, True),
    ("float4, strips x column tiles", (4, 27, 27, 256), (3, 3, 2, 2), 5,
     1e-4, 0.75, 2.0, 2.0, True),
    ("float4, ties", (8, 27, 27, 64), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     "ties", True),
    ("scalar, ties", (8, 27, 27, 33), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     "ties", False),
    ("scalar, two channels a thread", (2, 9, 9, 601), (3, 3, 2, 2), 5,
     1e-4, 0.75, 2.0, 2.0, False),
    ("float4, C 1024, several pooled columns a thread", (2, 7, 9, 1024),
     (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0, True),
]


def check_k1b_paths(torch):
    """K1b at each case of :data:`K1B_PATHS`: dx bit-exact and db within
    DB_RTOL of its plain version; reported on their own lines, outside
    the AlexNet row."""
    from znicz_torch.fused_block import (bwd_plan_for, fused_block_bwd,
                                         fused_block_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for label, shape, pool, n, alpha, beta, k, scale, vec in K1B_PATHS:
        x = tie_heavy(torch, shape, gen) if scale == "ties" else \
            torch.randn(shape, generator=gen, device="cuda") * scale
        b = torch.zeros(shape[-1:], device="cuda") if scale == "ties" \
            else torch.randn(shape[-1:], generator=gen, device="cuda") * 0.1
        ky, kx, sy, sx = pool
        dp = torch.randn((shape[0], (shape[1] - ky) // sy + 1,
                          (shape[2] - kx) // sx + 1, shape[3]),
                         generator=gen, device="cuda")
        plan = k1b_plan(x, b, n, pool, dp)
        if bwd_plan_for(x, b, n, pool, dp).vec != vec:
            raise AssertionError(f"K1b {label}: planner took the wrong "
                                 f"path: {plan}")

        def kern():
            return fused_block_bwd(x, b, dp, n, alpha, beta, k, pool)

        (got, got_db) = kern()
        want, want_db = fused_block_bwd_plain(x, b, dp, n, alpha, beta, k,
                                              pool)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        db_ok, db_note = db_check(torch, got_db, want_db, want)
        ok = got.shape == want.shape and err == 0.0 and db_ok and bool(
            torch.isfinite(got).all())
        log(f"[kernel] fused_block_bwd[{label}] shape={shape} pool={pool} "
            f"n={n} alpha={alpha:g} beta={beta:g} k={k:g} x*{scale} "
            f"plan={plan} max_abs_err={err:.3e} (bit-exact required)"
            f"{db_note} ms={cuda_ms(torch, kern):.4f} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1b {label} disagrees with its plain "
                                 f"version: {err:.3e}")


def make_requests(n_requests: int = 64):
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(1, 17, size=n_requests)
    return [rng.standard_normal((int(s), 227, 227, 3), dtype=np.float32)
            for s in sizes]


def serve_phase(torch, label, wf, requests, knobs, expect):
    """Serve ``requests`` through a fresh InferenceServer with ``knobs``
    set; check the kernel counts per dispatch against ``expect``
    ({counter name: launches per dispatch}).  Returns (replies,
    launches, stats)."""
    from znicz_torch.core.config import root
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    ctrs = {name: fn for name, fn in counters().items() if name in expect}
    for key, val in knobs.items():
        setattr(root.common.engine, key, val)
    srv = InferenceServer(wf, max_batch=BATCH, max_delay_ms=5.0,
                          queue_bound=4096)
    t0 = time.perf_counter()
    srv.start()                                 # warms all 8 rungs
    log(f"[{label}] warmup of {len(srv.batcher.ladder.rungs)} rungs "
        f"{time.perf_counter() - t0:.2f}s")
    futures = [Future() for _ in requests]

    def client(tid):
        for i in range(tid, len(requests), 4):
            srv.submit(Request(requests[i], requests[i].shape[0],
                               reply_to=futures[i], req_id=i))

    for fn in ctrs.values():                    # the main path starts here
        fn.launches = 0
    srv.runner.dispatches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    replies = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ctrs.items()}
    dispatches = srv.runner.dispatches
    srv.stop()
    for key in knobs:
        setattr(root.common.engine, key, False)
    if srv.error is not None:
        raise RuntimeError(f"[{label}] compute loop died") from srv.error
    bad = [r for r in replies if not r["ok"]]
    if bad:
        raise AssertionError(f"[{label}] {len(bad)} refused/failed replies: "
                             f"{bad[0]}")
    rows = sum(r.shape[0] for r in requests)
    stats = srv.stats()
    log(f"[{label}] {len(requests)} requests, {rows} images, "
        f"{dispatches} dispatches, launches={launches} "
        f"batches={stats['batcher']['bucket_hits']}")
    for name, per in expect.items():
        if launches[name] != per * dispatches or dispatches == 0:
            raise AssertionError(
                f"[{label}] {name}: {launches[name]} launches for "
                f"{dispatches} dispatches, expected {per} per dispatch")
    return replies, launches, {"images_per_s": rows / wall, **stats}


def _rel_err(y, ref) -> float:
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def check_replies(label, replies, refs):
    """Each reply within ``SERVE_TOL`` of its composed forward; on a
    failure the bad replies are named (their place, error, the reply's
    stamps, and the other requests whose forward they match)."""
    errs = []
    for i, (rep, ref) in enumerate(zip(replies, refs)):
        if "y" not in rep:
            raise AssertionError(f"[{label}] request {i} was not answered: "
                                 f"{rep}")
        y = rep["y"]
        if y.shape != ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"[{label}] request {i}: shape {y.shape} "
                                 f"vs {ref.shape} or non-finite")
        errs.append(_rel_err(y, ref))
    worst = max(errs, default=0.0)
    log(f"[{label}] replies vs composed forward: max|d|/max|ref| = "
        f"{worst:.3e} (tol {SERVE_TOL:g})")
    if worst > SERVE_TOL:
        bad = [i for i, e in enumerate(errs) if e > SERVE_TOL]
        for i in bad[:5]:
            y = replies[i]["y"]
            like = [j for j, r in enumerate(refs) if r.shape == y.shape
                    and _rel_err(y, r) <= SERVE_TOL]
            log(f"[{label}] bad reply {i} of {len(replies)}: "
                f"{errs[i]:.3e}, stamps "
                f"{ {k: v for k, v in replies[i].items() if k != 'y'} }, "
                f"matches the forward of requests {like[:5]}")
        raise AssertionError(f"[{label}] replies disagree: {worst:.3e} "
                             f"({len(bad)} of {len(replies)} replies)")


#: routing -> (knobs, {kernel: (launches per train step, per eval step)})
TRAIN_ROUTINGS = {
    "composed": ({}, {}),
    "fused": ({"fused_elementwise": True, "fused_tail": True},
              {"fused_block_fwd": (2, 2), "fused_block_bwd": (2, 0),
               "bias_relu_fwd": (3, 3), "bias_relu_bwd": (3, 0)}),
    "pallas_lrn": ({"pallas_lrn": True, "fused_tail": True},
                   {"lrn_fwd": (2, 2), "lrn_bwd": (2, 0),
                    "bias_relu_fwd": (5, 5), "bias_relu_bwd": (5, 0)}),
    # the composed run again: its distance to the first is the run-to-run
    # spread (cuDNN's backward algorithms may sum in any order)
    "composed_repeat": ({}, {}),
}


def train_phase(torch, card):
    """Phase 6: ``FusedTrainer.run()`` on full-width AlexNet under each
    routing from the same start.  Returns {routing: {kernel: launches}}
    of the runs."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.decision import DecisionGD
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import training_workflow

    root.alexnet.loader.update(TRAIN_CFG)
    root.alexnet.decision.max_epochs = TRAIN_EPOCHS
    prng.reset(SEED)
    t0 = time.perf_counter()
    wf = no_snapshots(training_workflow())
    ldr = wf.loader
    log(f"[train] AlexNet {wf.sample_shape} -> {wf.output_sample_shape}, "
        f"{ldr.class_lengths[2]} train + {ldr.class_lengths[1]} valid "
        f"images resident on {ldr.data.device}, batch {BATCH}, "
        f"{TRAIN_EPOCHS} epochs; built in {time.perf_counter() - t0:.2f}s")
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    ctrs = counters()
    runs = {}
    for label, (knobs, expect) in TRAIN_ROUTINGS.items():
        prng.reset(SEED)                        # same shuffles, same masks
        ldr.reset()
        with torch.no_grad():
            for f in wf.forwards:
                for k, p in FusedTrainer._params_of(f).items() \
                        if f.has_weights else ():
                    p.copy_(start[f.name][k])
        for gd in wf.gds.values():
            gd.velocities = {}
        wf.decision = DecisionGD(max_epochs=TRAIN_EPOCHS, fail_iterations=0)
        valid_err = []
        wf.decision.on_epoch_end.append(
            lambda d: valid_err.append(d.epoch_metrics[1]["err_pct"]))
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        trainer = FusedTrainer(wf)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        st = trainer.stats
        n_train, n_eval = st["train_steps"], st["eval_steps"]
        losses = list(trainer.train_losses)
        final = {name: {k: p.detach().clone() for k, p in leaves.items()}
                 for name, leaves in trainer.extract_params().items()}
        idx = np.arange(BATCH)
        step_ms = cuda_ms(torch, lambda: trainer.train_step(idx, BATCH, 0),
                          iters=5, warmup=1)
        for key in knobs:
            setattr(root.common.engine, key, False)
        log(f"[train:{label}] {n_train} train steps + {n_eval} eval steps "
            f"in {wall:.2f}s; losses {['%.6f' % v for v in losses]}; "
            f"valid err% per epoch {valid_err}")
        log(f"[train:{label}] {card}: images/s={st['img_per_sec']:.1f} "
            f"(after the first step of each kind "
            f"{st['warm_img_per_sec']:.1f}); one train step "
            f"{step_ms:.3f} ms on the device ({BATCH / step_ms * 1e3:.0f} "
            f"images/s); launches={launches}")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"[train:{label}] non-finite loss: {losses}")
        for name, fn in ctrs.items():
            per_train, per_eval = expect.get(name, (0, 0))
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want:
                raise AssertionError(
                    f"[train:{label}] {name}: {launches[name]} launches for "
                    f"{n_train} train + {n_eval} eval steps, expected {want}")
        runs[label] = (losses, final, launches)
    base_losses, base_final, _ = runs["composed"]
    for label in ("fused", "pallas_lrn", "composed_repeat"):
        losses, final, _ = runs[label]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        w_err, w_worst, w_bad = 0.0, "", []
        for name, leaves in final.items():
            for k, w in leaves.items():
                ref = base_final[name][k]
                d = (w - ref).abs()
                e = float((d / (W_ATOL + W_RTOL * ref.abs())).max())
                if e > w_err:
                    w_err, w_worst = e, f"{name}.{k}"
                if e > 1.0:
                    w_bad.append(f"{name}.{k}")
        log(f"[train:{label}] vs composed: losses max rel "
            f"{l_err:.3e} (tol {LOSS_RTOL:g}); final weights max "
            f"|d|/({W_ATOL:g}+{W_RTOL:g}|w|) = {w_err:.3f} at {w_worst} "
            f"(tol 1)")
        if len(losses) != len(base_losses) or l_err > LOSS_RTOL or w_bad:
            raise AssertionError(f"[train:{label}] leaves the composed "
                                 f"run's band: losses {l_err:.3e}, weights "
                                 f"{w_bad}")
    return {label: launches for label, (_, _, launches) in runs.items()}


#: bench.py:4316 ANCHOR_BANDS, the seeded finals the reference recorded for
#: BASELINE configs 0 (MNIST) and 1 (CIFAR10): {config: {metric: (centre,
#: half width)}}.  Copied, not imported: bench.py is the JAX package's
ANCHOR_BANDS = {
    0: {"final_train_loss": (0.0109, 0.005), "valid_err_pct": (0.875, 0.5)},
    1: {"final_train_loss": (0.9501, 0.05), "valid_err_pct": (44.0, 1.5)},
    2: {"final_train_mse": (2.0818, 0.1), "valid_mse": (2.1689, 0.1)},
    3: {"final_qerror": (0.0505, 0.02)},
}
#: bench.py seeds every named stream with this before each sample
ANCHOR_SEED = 1013
ANCHOR_WORKFLOWS = {"mnist": "MnistWorkflow", "cifar": "CifarWorkflow",
                    "mnist_ae": "MnistAEWorkflow",
                    "kohonen": "KohonenWorkflow", "kanji": "KanjiWorkflow",
                    "video_ae": "VideoAEWorkflow",
                    "yale_faces": "YaleFacesWorkflow",
                    "charlm": "CharLMWorkflow"}


def sample_workflow(sample, device=None):
    """``sample``'s workflow class of ``ANCHOR_WORKFLOWS`` built on
    ``device`` (the card by default)."""
    import importlib

    mod = importlib.import_module(f"znicz_torch.samples.{sample}")
    return getattr(mod, ANCHOR_WORKFLOWS[sample])(device=device)
#: the card's first STEP_CHECK train losses of each anchor run against the
#: port's CPU run of them (plain twins), as |card - cpu| <= STEP_RTOL *
#: |cpu|, the rtol the CPU parity tests hold the port's train steps to
#: against the reference (tests/test_torch_train.py STEP_TOL).  Rounding
#: alone, and a max pool's choice flipped by an ulp, stay under 1e-5 there;
#: later steps part further (PERF.md)
STEP_CHECK, STEP_RTOL = 8, 1e-4
#: (sample, final) pairs whose seeded final may leave its band on the card
#: by drift, not by a fault (PERF.md §6): CIFAR10's last-epoch valid error
#: moves by up to 27 points with the float32 rounding of its 239 steps, and
#: the reference's own leaves the band at 12 of seeds 1013-1036.  Over
#: those 24 seeds (``seed_sweep.py``: ``python -m znicz_tpu cifar --seed N``
#: on a CPU, ``python -m znicz_torch cifar --seed N`` on the card) the two
#: distributions of valid errors agree, ``scipy.stats.ks_2samp`` p 0.99999,
#: so a miss at one seed is printed, not raised
DRIFTS = {("cifar", "valid_err_pct")}
#: CIFAR10's kernel shapes at its batch of 100: the three convolutions'
#: outputs (bias+ReLU) and the norm after the first pool (LRN)
CIFAR_BATCH = 100
CIFAR_LAYERS = {"conv1": (32, 16), "conv2": (16, 32), "conv3": (8, 32)}
CIFAR_SHAPES = {"bias_relu_fwd": CIFAR_LAYERS, "bias_relu_bwd": CIFAR_LAYERS,
                "lrn_fwd": {"norm": (16, 16)}, "lrn_bwd": {"norm": (16, 16)}}
#: anchor run -> (sample, BASELINE config, knobs, {kernel: (launches per
#: train step, per eval step)}); every kernel not named launches 0 times.
#: CIFAR10's LRN follows a pool, so no conv block (K1, K1b) ever fuses
ANCHOR_RUNS = {
    "mnist": ("mnist", 0, {}, {}),
    "cifar": ("cifar", 1, {}, {}),
    "cifar:fused_tail": ("cifar", 1, {"fused_tail": True},
                         {"bias_relu_fwd": (3, 3), "bias_relu_bwd": (3, 0)}),
    "cifar:pallas_lrn": ("cifar", 1, {"pallas_lrn": True, "fused_tail": True},
                         {"bias_relu_fwd": (3, 3), "bias_relu_bwd": (3, 0),
                          "lrn_fwd": (1, 1), "lrn_bwd": (1, 0)}),
}


#: each anchor run's finals, for phase 10's CIFAR10 run to print beside
ANCHOR_FINALS = {}


def cpu_steps(sample, n):
    """The first ``n`` train losses of ``sample``'s default run on
    ``FusedTrainer`` on the CPU (the plain twins), epoch tails included,
    seeded as the card's runs are and under the knobs set now; the run
    stops once the Decision has seen ``n`` of them."""
    from znicz_torch.core import prng
    from znicz_torch.parallel.fused import FusedTrainer

    prng.reset(ANCHOR_SEED)
    wf = sample_workflow(sample, "cpu")
    d, run = wf.decision, wf.decision.run

    def run_until():
        run()
        if len(d.train_losses) >= n:
            d.complete.set(True)

    d.run = run_until
    FusedTrainer(wf).run()
    return d.train_losses[:n]


def anchors_phase(torch, card, trace_path=""):
    """The MNIST and CIFAR10 anchors at their default configurations,
    each trained through its sample's workflow and ``samples.train`` with
    ``FusedTrainer`` (``fused=True``) after every named stream is reset to
    ``ANCHOR_SEED``: CIFAR10 under each routing of ``ANCHOR_RUNS``.  Each
    kernel's launches must be its count per step times the steps; the
    first ``STEP_CHECK`` train losses must match the port's CPU run of
    the same sample within ``STEP_RTOL``; each final must lie in its
    ``ANCHOR_BANDS`` entry, except that a final of ``DRIFTS`` outside
    its band is printed as a miss and not raised.  With ``trace_path``,
    every run's per-step losses and per-epoch metrics are written there
    as JSON.  Returns {run: {kernel: launches}}."""
    import importlib

    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import train

    ctrs = counters()
    runs, trace = {}, {}
    for label, (sample, config, knobs, expect) in ANCHOR_RUNS.items():
        mod = importlib.import_module(f"znicz_torch.samples.{sample}")
        prng.reset(ANCHOR_SEED)
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        wf = getattr(mod, ANCHOR_WORKFLOWS[sample])()
        epochs = []
        wf.decision.on_epoch_end.append(lambda d: epochs.append(
            {"valid_err_pct": d.epoch_metrics[1]["err_pct"],
             "valid_loss": d.epoch_metrics[1]["loss"],
             "train_loss": d.epoch_metrics[2]["loss"]}))
        train(wf, sample, fused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        losses = list(wf.trainer.train_losses)
        cpu = cpu_steps(sample, STEP_CHECK)
        for key in knobs:
            setattr(root.common.engine, key, False)
        d, st = wf.decision, wf.trainer.stats
        trace[label] = {"train_losses": losses, "cpu_losses": cpu,
                        "epochs": epochs}
        finals = {"final_train_loss": d.epoch_metrics[2]["loss"],
                  "valid_err_pct": d.epoch_metrics[1]["err_pct"]}
        bands = {m: {"value": finals[m], "center": c, "band": h,
                     "ok": abs(finals[m] - c) <= h}
                 for m, (c, h) in ANCHOR_BANDS[config].items()}
        n_train, n_eval = st["train_steps"], st["eval_steps"]
        step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
        log(f"[anchor:{label}] {card}: {json.dumps(finals)} bands "
            f"{json.dumps(bands)}; {int(d.epoch_number) + 1} epochs, "
            f"{n_train} train steps + {n_eval} eval steps on "
            f"{wf.device}; run() {wall:.2f}s, images/s="
            f"{st['img_per_sec']:.1f} (after the first call of each kind "
            f"{st['warm_img_per_sec']:.1f}); launches={launches}")
        log(f"[anchor:{label}] valid err% per epoch "
            f"{[e['valid_err_pct'] for e in epochs]}; first {STEP_CHECK} "
            f"train losses vs the port on the CPU: max rel {step_err:.3e} "
            f"(tol {STEP_RTOL:g})")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[anchor:{label}] non-finite loss")
        for name, fn in ctrs.items():
            per_train, per_eval = expect.get(name, (0, 0))
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want:
                raise AssertionError(
                    f"[anchor:{label}] {name}: {launches[name]} launches for "
                    f"{n_train} train + {n_eval} eval steps, expected {want}")
        if step_err > STEP_RTOL:
            raise AssertionError(f"[anchor:{label}] the card leaves the "
                                 f"CPU's first {STEP_CHECK} steps: "
                                 f"{step_err:.3e}")
        missed = {m: b for m, b in bands.items() if not b["ok"]}
        for m, b in missed.items():
            log(f"[anchor:{label}] MISS: {m} {b['value']} outside "
                f"{b['center']} +- {b['band']} (BASELINE config {config})"
                + (", a seed's drift (PERF.md §6, the seed sweep)"
                   if (sample, m) in DRIFTS else ""))
        fatal = {m: b for m, b in missed.items() if (sample, m) not in DRIFTS}
        if fatal:
            raise AssertionError(f"[anchor:{label}] outside the band of "
                                 f"BASELINE config {config}: {fatal}")
        runs[label] = launches
        ANCHOR_FINALS[label] = finals
        del wf
        torch.cuda.empty_cache()
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)),
                    exist_ok=True)
        with open(trace_path, "w") as f:
            json.dump(trace, f)
    return runs


def no_snapshots(wf):
    """Gate ``wf``'s snapshotter off (both engines skip a gated one) and
    return ``wf``: a full-width AlexNet snapshot is 0.5 GB of gzip."""
    from znicz_torch.core.mutable import Bool

    wf.snapshotter.gate_skip = Bool(True)
    return wf


#: unit-engine run -> (sample, BASELINE config, knobs)
UNIT_RUNS = {
    "mnist": ("mnist", 0, {}),
    "cifar": ("cifar", 1, {}),
    "cifar:pallas_lrn": ("cifar", 1, {"pallas_lrn": True}),
}


def lrn_unit_launches(wf):
    """(K3, K3b) launches the LRN units of ``wf`` made on the unit engine
    under ``pallas_lrn``: K3 in each forward firing and in each GD
    firing's recomputed forward, K3b in each GD firing."""
    from znicz_torch.lrn import LRNormalizerBackward

    gds = [g for g in wf.gd_units if isinstance(g, LRNormalizerBackward)]
    return (sum(g.forward.run_count + g.run_count for g in gds),
            sum(g.run_count for g in gds))


def cpu_unit_steps(sample, n):
    """The first ``n`` train losses of ``sample``'s default run on the
    port's unit engine on the CPU (the plain twins), seeded as the card's
    runs are and under the knobs set now; the graph is stopped once the
    Decision has seen ``n`` of them."""
    from znicz_torch.core import prng
    from znicz_torch.core.units import TrivialUnit

    class StopAfter(TrivialUnit):
        def run(self):
            if len(self.workflow.decision.train_losses) >= n:
                self.workflow.stop()

    prng.reset(ANCHOR_SEED)
    wf = sample_workflow(sample, "cpu")
    StopAfter(wf, name="stop_after").link_from(wf.decision)
    wf.run()
    return wf.decision.train_losses[:n]


def units_phase(torch, card):
    """Phase 9, the unit engine: the ``UNIT_RUNS`` of MNIST and CIFAR10
    at their defaults, the images/s of ``FusedTrainer`` beside each
    sample's, MNIST's best snapshot reloaded on the card, and AlexNet at
    full width (:func:`alexnet_units`).  Returns {run: {kernel:
    launches}}."""
    import importlib

    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import train
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_torch.weights import params_to_numpy

    if root.common.engine.get("fused", False):
        raise AssertionError("root.common.engine.fused is set: the samples "
                             "would not take the unit engine")
    ctrs = counters()
    runs, speed = {}, {}
    for label, (sample, config, knobs) in UNIT_RUNS.items():
        mod = importlib.import_module(f"znicz_torch.samples.{sample}")
        prng.reset(ANCHOR_SEED)
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        wf = getattr(mod, ANCHOR_WORKFLOWS[sample])()
        train(wf, sample)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        if hasattr(wf, "trainer"):
            raise AssertionError(f"[units:{label}] trained on FusedTrainer")
        losses = list(wf.decision.train_losses)
        cpu = cpu_unit_steps(sample, STEP_CHECK)
        for key in knobs:
            setattr(root.common.engine, key, False)
        d, st = wf.decision, wf.train_stats
        finals = {"final_train_loss": d.epoch_metrics[2]["loss"],
                  "valid_err_pct": d.epoch_metrics[1]["err_pct"]}
        bands = {m: {"value": finals[m], "center": c, "band": h,
                     "ok": abs(finals[m] - c) <= h}
                 for m, (c, h) in ANCHOR_BANDS[config].items()}
        step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
        k3, k3b = lrn_unit_launches(wf) if knobs else (0, 0)
        expect = {"lrn_fwd": k3, "lrn_bwd": k3b}
        log(f"[units:{label}] {card}: {json.dumps(finals)} bands "
            f"{json.dumps(bands)}; {int(d.epoch_number) + 1} epochs, "
            f"{st['train_steps']} train steps on {wf.device}; run() "
            f"{wall:.2f}s, images/s={st['img_per_sec']:.1f} (after the "
            f"first epoch {st['warm_img_per_sec']:.1f}); "
            f"launches={launches}")
        log(f"[units:{label}] first {STEP_CHECK} train losses vs the port's "
            f"unit engine on the CPU: max rel {step_err:.3e} (tol "
            f"{STEP_RTOL:g}); unit timing:\n{wf.print_stats()}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[units:{label}] non-finite loss")
        for name in ctrs:
            if launches[name] != expect.get(name, 0):
                raise AssertionError(
                    f"[units:{label}] {name}: {launches[name]} launches, "
                    f"expected {expect.get(name, 0)} from the LRN units' "
                    f"firings")
        if knobs and not (k3 and k3b):
            raise AssertionError(f"[units:{label}] no LRN unit fired")
        if step_err > STEP_RTOL:
            raise AssertionError(f"[units:{label}] the card leaves the "
                                 f"CPU's first {STEP_CHECK} steps: "
                                 f"{step_err:.3e}")
        missed = {m: b for m, b in bands.items() if not b["ok"]}
        for m, b in missed.items():
            log(f"[units:{label}] MISS: {m} {b['value']} outside "
                f"{b['center']} +- {b['band']} (BASELINE config {config})"
                + (", a seed's drift (PERF.md §6, the seed sweep)"
                   if (sample, m) in DRIFTS else ""))
        fatal = {m: b for m, b in missed.items() if (sample, m) not in DRIFTS}
        if fatal:
            raise AssertionError(f"[units:{label}] outside the band of "
                                 f"BASELINE config {config}: {fatal}")
        runs[label] = launches
        if sample == "mnist":
            path = wf.snapshotter.destination
            if not path or not os.path.isfile(path) or \
                    not path.endswith("mnist_best.pickle.gz"):
                raise AssertionError(f"[units:mnist] no best snapshot: "
                                     f"{path}")
            snap = Snapshotter.load(path)
            fresh = mod.MnistWorkflow()
            restore(fresh, snap)
            got = params_to_numpy(fresh)
            same = all(np.array_equal(got[u][k], v)
                       for u, leaves in snap["units"].items()
                       for k, v in leaves.items())
            log(f"[units:mnist] snapshot {os.path.basename(path)} (epoch "
                f"{snap['epoch']}, best {snap['metric']}) reloaded on "
                f"{fresh.device}: weights bit-equal={same}")
            if not same or sorted(got) != sorted(snap["units"]):
                raise AssertionError("[units:mnist] the reloaded snapshot's "
                                     "weights differ")
            del fresh
        if not knobs:
            speed[sample] = st["img_per_sec"], st["warm_img_per_sec"]
        del wf
        torch.cuda.empty_cache()
    for sample, (unit_ips, unit_warm) in speed.items():
        mod = importlib.import_module(f"znicz_torch.samples.{sample}")
        prng.reset(ANCHOR_SEED)
        wf = train(getattr(mod, ANCHOR_WORKFLOWS[sample])(), sample,
                   fused=True)
        st = wf.train_stats
        log(f"[units:speed] {sample} {card}: unit engine images/s="
            f"{unit_ips:.1f} (after the first epoch {unit_warm:.1f}); "
            f"FusedTrainer images/s={st['img_per_sec']:.1f} (after each "
            f"kind's first call {st['warm_img_per_sec']:.1f})")
        del wf
        torch.cuda.empty_cache()
    runs["alexnet"] = alexnet_units(torch, card)
    return runs


def alexnet_units(torch, card):
    """Full-width AlexNet (phase 6's configuration) trained on the unit
    engine under ``pallas_lrn`` through ``samples.train(fused=False)``,
    the two halves of ``samples.alexnet.run(fused=False)``, against a
    composed ``FusedTrainer`` run from the same seed whose dropout masks
    its dropout units take.  Returns {kernel: launches}."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples import train
    from znicz_torch.samples.alexnet import training_workflow

    root.alexnet.loader.update(TRAIN_CFG)
    root.alexnet.decision.max_epochs = TRAIN_EPOCHS
    prng.reset(SEED)
    ref = no_snapshots(training_workflow())
    trainer = FusedTrainer(ref)
    trainer.run()
    ref_losses = list(trainer.train_losses)
    ref_final = {name: {k: p.detach().clone() for k, p in leaves.items()}
                 for name, leaves in trainer.extract_params().items()}
    del ref
    torch.cuda.empty_cache()

    prng.reset(SEED)
    wf = no_snapshots(training_workflow())
    for unit in wf.forward_units:
        if hasattr(unit, "mask_fn"):
            unit.mask_fn = (lambda step, shape, ratio,
                            i=unit.module.layer_index:
                            trainer.default_mask(step, i, shape, ratio))
    ctrs = counters()
    root.common.engine.pallas_lrn = True
    try:
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        train(wf, "alexnet", fused=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
    finally:
        root.common.engine.pallas_lrn = False
    losses, st = list(wf.decision.train_losses), wf.train_stats
    k3, k3b = lrn_unit_launches(wf)

    l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    w_err, w_worst = 0.0, ""
    for f in wf.forwards:
        if not f.has_weights:
            continue
        for k, want in ref_final[f.name].items():
            got = getattr(f, k).detach()
            e = float(((got - want).abs()
                       / (W_ATOL + W_RTOL * want.abs())).max())
            if e > w_err:
                w_err, w_worst = e, f"{f.name}.{k}"
    log(f"[units:alexnet] {card}: {st['train_steps']} train steps on the "
        f"unit engine under pallas_lrn in {wall:.2f}s, images/s="
        f"{st['img_per_sec']:.1f}; losses {['%.6f' % v for v in losses]}; "
        f"vs the composed FusedTrainer run: losses max rel {l_err:.3e} "
        f"(tol {LOSS_RTOL:g}), final weights max |d|/({W_ATOL:g}+"
        f"{W_RTOL:g}|w|) = {w_err:.3f} at {w_worst} (tol 1); "
        f"launches={launches}, LRN unit firings give K3 {k3}, K3b {k3b}; "
        f"unit timing:\n{wf.print_stats()}")
    if not all(np.isfinite(losses)) or len(losses) != len(ref_losses):
        raise AssertionError(f"[units:alexnet] losses {losses} against "
                             f"{ref_losses}")
    if st["train_steps"] != 3 or l_err > LOSS_RTOL or w_err > 1.0:
        raise AssertionError(f"[units:alexnet] leaves the composed run's "
                             f"band: {st['train_steps']} steps, losses "
                             f"{l_err:.3e}, weights {w_err:.3f}")
    expect = {"lrn_fwd": k3, "lrn_bwd": k3b}
    if not (k3 and k3b) or any(launches[name] != expect.get(name, 0)
                               for name in ctrs):
        raise AssertionError(f"[units:alexnet] launches {launches}, "
                             f"expected {expect} and no other kernel")

    def lap():
        """One train minibatch's units, as the graph fires them."""
        for unit in wf.forward_units:
            unit.run()
        wf.evaluator.run()
        for gd in wf.gd_units:
            gd.run()

    # after the checks, since it trains on: the device time of one train
    # lap on the loader's last minibatch (the evaluator's read-back
    # included), beside the composed fused step
    root.common.engine.pallas_lrn = True
    try:
        lap_ms = cuda_ms(torch, lap, iters=5, warmup=1)
    finally:
        root.common.engine.pallas_lrn = False
    idx = np.arange(BATCH)
    fused_ms = cuda_ms(torch, lambda: trainer.train_step(idx, BATCH, 0),
                       iters=5, warmup=1)
    log(f"[units:alexnet] {card}: one train lap {lap_ms:.3f} ms on the "
        f"device; the composed FusedTrainer train step {fused_ms:.3f} ms")
    del wf, trainer
    torch.cuda.empty_cache()
    return launches


#: the bf16 variants beyond AlexNet's case (phase 10), each output and dx
#: bit-exact against its plain version and the same bits twice, db within
#: DB_RTOL and the same bits twice: kernel -> [(what it takes, shape, pool,
#: n, alpha, beta, k, input scale or "ties", whether x lies 2 bytes past a
#: 16-byte boundary, whether the bf16 K1/K1b planners must take the ring
#: kernels, or the bf16 K2/K2b planners the 16-byte ones (else the simple
#: ones))].  The
#: bias+ReLU cases shut a quarter of the gates exactly (x = -b).  The
#: "ring" cases are the bf16 counterparts of K1_PATHS' and K1B_PATHS'
#: group-path cases, C 16 or 32 where those have C 20
_BF16_BLOCK_PATHS = [
    ("odd C 33", (5, 27, 27, 33), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0,
     False, False),
    ("C 20, not a multiple of 8", (3, 13, 13, 20), (3, 3, 2, 2), 5, 1e-4,
     0.75, 2.0, 2.0, False, False),
    ("even window 4", (4, 27, 27, 64), (3, 3, 2, 2), 4, 1e-4, 0.75, 2.0, 2.0,
     False, False),
    ("pool 2x2/2", (4, 26, 26, 32), (2, 2, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0,
     False, True),
    ("pool 4x4/2, window 1", (4, 12, 12, 32), (4, 4, 2, 2), 1, 1e-4, 0.75,
     2.0, 2.0, False, True),
    ("pool 1x1/4, window 7", (4, 9, 9, 24), (1, 1, 4, 4), 7, 1e-4, 0.75,
     2.0, 2.0, False, True),
    ("powf", (3, 13, 13, 33), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0, False,
     False),
    ("s over 20 binades", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-2, 0.75, 1e-3,
     100.0, False, True),
    ("one pooled row", (1, 3, 3, 8), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0,
     False, True),
    ("unaligned operand", (4, 9, 9, 64), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     2.0, True, False),
    ("ties", (8, 27, 27, 64), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, "ties",
     False, True),
    ("ties, odd C", (8, 27, 27, 33), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0,
     "ties", False, False),
    ("C 601", (2, 9, 9, 601), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0, False,
     False),
    ("C 1024", (2, 7, 9, 1024), (3, 3, 2, 2), 5, 1e-4, 0.75, 2.0, 2.0,
     False, True),
    ("ring, short strips", (3, 13, 13, 16), (3, 3, 2, 2), 5, 1e-4, 0.75,
     2.0, 2.0, False, True),
    ("ring, pool 4x4/2, window 3", (4, 12, 12, 32), (4, 4, 2, 2), 3, 1e-4,
     0.75, 2.0, 2.0, False, True),
    ("ring, window 9", (4, 13, 13, 32), (3, 3, 2, 2), 9, 1e-4, 0.75, 2.0,
     2.0, False, True),
    ("ring, powf", (4, 27, 27, 64), (3, 3, 2, 2), 5, 1e-4, 0.6, 2.0, 2.0,
     False, True),
    ("ring, strips x column tiles", (4, 27, 27, 256), (3, 3, 2, 2), 5, 1e-4,
     0.75, 2.0, 2.0, False, True),
    ("ring, ties at conv2's width", (8, 27, 27, 256), (3, 3, 2, 2), 5, 1e-4,
     0.75, 2.0, "ties", False, True),
    ("ring, conv1's width, one image", (1, 55, 55, 96), (3, 3, 2, 2), 5,
     1e-4, 0.75, 2.0, 2.0, False, True),
]
#: The bias+ReLU cases' last field is whether the bf16 K2 and K2b take
#: the 16-byte kernels (else the simple ones): C % 8 == 0 and aligned
#: operands.  Their edges: one unit (C 8), an odd unit count (C 24), two
#: chunks of 512 units (C 8192), one row; "inf" puts +-inf in dp at a
#: quarter of the first half of the channels and +-0 at a quarter of all,
#: so dx holds inf, NaN (inf times a shut gate) and signed zeros, and db
#: NaN where the channel saw inf
_BF16_RELU_PATHS = [
    (label, shape, None, 0, 0.0, 0.0, 0.0, scale, off, vec)
    for label, shape, scale, off, vec in (
        ("C 1", (3, 17, 17, 1), 1.0, False, False),
        ("odd C 33", (5, 9, 9, 33), 1.0, False, False),
        ("C 20, not a multiple of 8", (4, 9, 9, 20), 1.0, False, False),
        ("C 384", (4, 13, 13, 384), 1.0, False, True),
        ("C 1536", (2, 9, 9, 1536), 1.0, False, True),
        ("one row, C 256", (1, 1, 1, 256), 1.0, False, True),
        ("unaligned operand", (4, 9, 9, 64), 1.0, True, False),
        ("CIFAR10's conv1, C 16", (100, 32, 32, 16), 1.0, False, True),
        ("Kanji's conv1, C 16", (128, 24, 24, 16), 1.0, False, True),
        ("Kanji's conv2, C 32", (128, 12, 12, 32), 1.0, False, True),
        ("YaleFaces' conv1, C 8", (32, 32, 32, 8), 1.0, False, True),
        ("YaleFaces' conv2, C 16", (32, 16, 16, 16), 1.0, False, True),
        ("C 8, one unit", (4, 9, 9, 8), 1.0, False, True),
        ("C 24, an odd unit count", (4, 9, 9, 24), 1.0, False, True),
        ("C 8192, two chunks of units", (2, 5, 7, 8192), 1.0, False, True),
        ("+-inf and +-0 in dp", (4, 13, 13, 96), "inf", False, True))]
BF16_PATHS = {"fused_block_bf16_fwd": _BF16_BLOCK_PATHS,
              "fused_block_bf16_bwd": _BF16_BLOCK_PATHS,
              "bias_relu_bf16_fwd": _BF16_RELU_PATHS,
              "bias_relu_bf16_bwd": _BF16_RELU_PATHS}


def check_bf16_paths(torch, names=tuple(BF16_PATHS)):
    """Each bf16 variant of ``names`` at each case of :data:`BF16_PATHS`:
    output and dx bit-exact against the plain version and the same bits on
    a second launch, db (float32) within DB_RTOL of it and the same bits
    on a second launch (NaN and inf where the plain db has them), each
    kernel on the path the case names; reported on their own lines,
    outside the AlexNet rows."""
    from znicz_torch import fused_block as fb

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for name, cases in BF16_PATHS.items():
        if name not in names:
            continue
        for label, shape, pool, n, alpha, beta, k, scale, off, ring in cases:
            inf = scale == "inf"
            if scale == "ties":
                x = tie_heavy(torch, shape, gen)
                b = torch.zeros(shape[-1:], device="cuda")
            else:
                x = torch.randn(shape, generator=gen, device="cuda") * (
                    1.0 if inf else scale)
                b = torch.randn(shape[-1:], generator=gen,
                                device="cuda") * 0.3
            x, b = x.to(bf16), b.to(bf16)
            if pool is None:
                shut = torch.rand(shape, generator=gen, device="cuda") < 0.25
                x = torch.where(shut, -b.expand(shape), x)
                dp_shape = shape
            else:
                ky, kx, sy, sx = pool
                dp_shape = (shape[0], (shape[1] - ky) // sy + 1,
                            (shape[2] - kx) // sx + 1, shape[3])
            dp = torch.randn(dp_shape, generator=gen, device="cuda")
            if inf:
                pick = torch.rand(dp_shape, generator=gen, device="cuda")
                sign = torch.where(torch.rand(dp_shape, generator=gen,
                                              device="cuda") < 0.5, -1.0, 1.0)
                low = torch.arange(dp_shape[-1], device="cuda") < \
                    dp_shape[-1] // 2
                dp = torch.where((pick < 0.25) & low, sign * float("inf"),
                                 torch.where(pick > 0.75, sign * 0.0, dp))
            dp = dp.to(bf16)
            if off:
                x = unaligned(torch, x, 2)
            hyp = (n, alpha, beta, k, pool)
            kern, plain = {
                "fused_block_bf16_fwd": (
                    lambda: fb.fused_block_bf16_fwd(x, b, *hyp),
                    lambda: fb.fused_block_plain(x, b, *hyp)),
                "fused_block_bf16_bwd": (
                    lambda: fb.fused_block_bf16_bwd(x, b, dp, *hyp),
                    lambda: fb.fused_block_bwd_plain(x, b, dp, *hyp)),
                "bias_relu_bf16_fwd": (
                    lambda: fb.bias_relu_bf16_fwd(x, b),
                    lambda: fb.bias_relu_plain(x, b)),
                "bias_relu_bf16_bwd": (
                    lambda: fb.bias_relu_bf16_bwd(x, b, dp),
                    lambda: fb.bias_relu_bwd_plain(x, b, dp)),
            }[name]
            if name in BF16_VEC:
                plan = PLANS[name](x, b, dp)
            else:
                plan = (k1_bf16_plan(x, b, n, pool) if name.endswith("fwd")
                        else k1b_bf16_plan(x, b, n, pool, dp))
            if (plan != "simple") != ring:
                raise AssertionError(f"{name} {label}: planner took the "
                                     f"wrong path: {plan}")
            plan = f" plan={plan}"
            got, want = kern(), plain()
            torch.cuda.synchronize()
            db_ok, note = True, ""
            if isinstance(got, tuple):
                (got, got_db), (want, want_db) = got, want
                db_ok, note = db_check(torch, got_db, want_db, want, inf)
                again, again_db = kern()
                torch.cuda.synchronize()
                twice = same_bits(torch, again_db, got_db)
                db_ok = db_ok and twice and got_db.dtype == torch.float32
                note += f" db_same_bits_twice={twice}"
            else:
                again = kern()
            twice = same_bits(torch, again, got)
            err = float((got.float() - want.float()).abs().max())
            ok = same_bits(torch, got, want) and twice and db_ok and (
                inf or bool(torch.isfinite(got).all()))
            log(f"[kernel] {name}[{label}] shape={shape} pool={pool} n={n} "
                f"alpha={alpha:g} beta={beta:g} k={k:g} x*{scale}{plan} "
                f"max_abs_err={err:.3e} (same bits required, twice: "
                f"{twice}){note} ms={cuda_ms(torch, kern):.4f} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {label} disagrees with its "
                                     f"plain version: {err:.3e}")


#: which kernel the bf16 K3 and K3b planners must choose at a case of
#: :data:`BF16_LRN_PATHS`: (K3 on the ring, K3b on the ring)
RING, SIMPLE = (True, True), (False, False)
#: the bf16 K3 and K3b beyond AlexNet's case, y and dx bit-exact against
#: their plain versions, the same bits on a second launch: (what it takes,
#: shape, n, alpha, beta, k, input scale, the operand that lies 2 bytes
#: past a 16-byte boundary, whether x is mostly zeros and dy holds +0s and
#: -0s, the kernels the planners must choose).  x is ReLU output, as on the
#: main path.  beta 0.5, 1 and 2 take torch.pow's rsqrt, reciprocal and
#: 1/(s*s) cases on the card, beta 0.6 rounds -beta to bf16 (-0.6015625);
#: x*1e-20 makes the squares bf16 subnormals, x*1e-39 x itself and y.  The
#: ring's edges: one unit (C 8), an odd unit count (C 24), the widest row
#: (C 4096) and one past it, a last group one row long (43 rows, 42 a
#: group at C 96), windows 1, 4 and 7 (the general path), signed zeros
BF16_LRN_PATHS = [
    ("odd C 33", (5, 9, 9, 33), 5, 1e-4, 0.75, 2.0, 2.0, "", False, SIMPLE),
    ("C 20, not a multiple of 8", (4, 9, 9, 20), 5, 1e-4, 0.75, 2.0, 2.0, "",
     False, SIMPLE),
    ("CIFAR10's norm, C 16", (100, 16, 16, 16), 5, 1e-4, 0.75, 2.0, 2.0, "",
     False, RING),
    ("even window 4", (4, 9, 9, 64), 4, 1e-4, 0.75, 2.0, 2.0, "", False,
     RING),
    ("window 1", (3, 9, 9, 32), 1, 1e-4, 0.75, 2.0, 2.0, "", False, RING),
    ("window 7", (3, 9, 9, 32), 7, 1e-4, 0.75, 2.0, 2.0, "", False, RING),
    ("beta 0.6, powf", (4, 13, 13, 96), 5, 1e-4, 0.6, 2.0, 2.0, "", False,
     RING),
    ("beta 0.5, rsqrt", (4, 13, 13, 96), 5, 1e-4, 0.5, 2.0, 2.0, "", False,
     RING),
    ("alpha 1e-2, k 1e-3, x*100", (4, 13, 13, 96), 5, 1e-2, 0.75, 1e-3,
     100.0, "", False, RING),
    ("C 1024", (2, 7, 7, 1024), 5, 1e-4, 0.75, 2.0, 2.0, "", False, RING),
    ("C 4097, one row a block", (2, 3, 5, 4097), 5, 1e-4, 0.75, 2.0, 2.0, "",
     False, SIMPLE),
    ("x 2 bytes past 16", (4, 9, 9, 64), 5, 1e-4, 0.75, 2.0, 2.0, "x",
     False, SIMPLE),
    ("dy 2 bytes past 16", (4, 9, 9, 64), 5, 1e-4, 0.75, 2.0, 2.0, "dy",
     False, (True, False)),
    ("one row", (1, 1, 1, 256), 5, 1e-4, 0.75, 2.0, 2.0, "", False, RING),
    ("zero-heavy x, +-0 in dy", (4, 13, 13, 96), 5, 1e-4, 0.75, 2.0, 2.0, "",
     True, RING),
    ("window 1, zero-heavy x, +-0 in dy", (3, 9, 9, 32), 1, 1e-4, 0.75, 2.0,
     2.0, "", True, RING),
    ("C 8, one unit", (4, 9, 9, 8), 5, 1e-4, 0.75, 2.0, 2.0, "", False,
     RING),
    ("C 24, an odd unit count", (4, 9, 9, 24), 5, 1e-4, 0.75, 2.0, 2.0, "",
     False, RING),
    ("C 4096, the widest ring row", (2, 3, 5, 4096), 5, 1e-4, 0.75, 2.0,
     2.0, "", False, RING),
    ("C 4104, past the ring's width", (2, 3, 3, 4104), 5, 1e-4, 0.75, 2.0,
     2.0, "", False, SIMPLE),
    ("43 rows, the last group one row", (1, 1, 43, 96), 5, 1e-4, 0.75, 2.0,
     2.0, "", False, RING),
    ("x*1e-20, subnormal squares", (4, 9, 9, 96), 5, 1e-4, 0.75, 2.0, 1e-20,
     "", False, RING),
    ("x*1e-39, subnormal x and y", (4, 9, 9, 96), 5, 1e-4, 0.75, 2.0, 1e-39,
     "", False, RING),
    ("beta 1, reciprocal", (4, 13, 13, 96), 5, 1e-4, 1.0, 2.0, 2.0, "",
     False, RING),
    ("beta 2, 1/(s*s)", (4, 13, 13, 96), 5, 1e-4, 2.0, 2.0, 2.0, "", False,
     RING),
    ("window 4 at conv1's C 96", (4, 13, 13, 96), 4, 1e-4, 0.75, 2.0, 2.0,
     "", False, RING),
    ("window 7 at conv2's C 256, zero-heavy x, +-0 in dy", (2, 13, 13, 256),
     7, 1e-4, 0.75, 2.0, 2.0, "", True, RING),
]


def check_bf16_pow_tables(torch):
    """The bf16 ring kernels' tables of powers against ``torch.pow`` on the
    card, for every bf16 s and each beta of :data:`BF16_LRN_PATHS`: the
    same bits wherever the power is a number, NaN where it is NaN."""
    from znicz_torch.ops.lrn import bf16_pow_table, operand_constants

    every = torch.arange(65536, dtype=torch.int32, device="cuda").to(
        torch.int16).view(torch.bfloat16)
    for beta in sorted({case[4] for case in BF16_LRN_PATHS}):
        nb, = operand_constants(torch.bfloat16, -beta)
        got, want = bf16_pow_table(every.device, nb), torch.pow(every, nb)
        nan = torch.isnan(want)
        ok = bool((torch.isnan(got) == nan).all()) and torch.equal(
            got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])
        log(f"[kernel] bf16 pow table nb={nb:g}: {int((~nan).sum())} "
            f"powers the same bits as torch.pow, {int(nan.sum())} NaN "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 pow table at nb={nb:g} "
                                 f"disagrees with torch.pow")


def check_bf16_lrn_paths(torch):
    """The bf16 K3 and K3b at each case of :data:`BF16_LRN_PATHS`: the
    planners' choice of kernel, y and dx bit-exact against the plain
    versions (signed zeros included), the same bits on a second launch;
    reported on their own lines with the kernel's time; first the tables
    of powers (:func:`check_bf16_pow_tables`)."""
    from znicz_torch.ops.lrn import (lrn_bf16_bwd, lrn_bf16_fwd,
                                     lrn_bwd_plain, lrn_plain)

    check_bf16_pow_tables(torch)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for (label, shape, n, alpha, beta, k, scale, off, zeros,
         ring) in BF16_LRN_PATHS:
        x = torch.randn(shape, generator=gen, device="cuda")
        x = torch.clamp_min((x - 0.8 if zeros else x) * scale, 0.0).to(bf16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        if zeros:                       # a quarter +0, a quarter -0
            u = torch.rand(shape, generator=gen, device="cuda")
            z = torch.zeros_like(dy)
            dy = torch.where(u < 0.25, z, torch.where(u < 0.5, -z, dy))
        if off == "x":
            x = unaligned(torch, x, 2)
        elif off == "dy":
            dy = unaligned(torch, dy, 2)
        hyp = (n, alpha, beta, k)
        for name, kern, plain, plan, on_ring in (
                ("lrn_bf16_fwd", lambda: lrn_bf16_fwd(x, *hyp),
                 lambda: lrn_plain(x, *hyp), k3_bf16_plan(x, None, n),
                 ring[0]),
                ("lrn_bf16_bwd", lambda: lrn_bf16_bwd(x, dy, *hyp),
                 lambda: lrn_bwd_plain(x, dy, *hyp),
                 k3b_bf16_plan(x, None, n, dy), ring[1])):
            if (plan != "simple") != on_ring:
                raise AssertionError(f"{name} {label}: planner took the "
                                     f"wrong kernel: {plan}")
            got, want = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = (same_bits(torch, got, want) and same_bits(torch, again, got)
                  and bool(torch.isfinite(got).all()))
            neg0 = int(((want == 0) & torch.signbit(want)).sum())
            sub = int(((want != 0) & (want.float().abs() < 1.1754944e-38))
                      .sum())
            log(f"[kernel] {name}[{label}] shape={shape} n={n} "
                f"alpha={alpha:g} beta={beta:g} k={k:g} x*{scale:g} "
                f"plan={plan} max_abs_err={err:.3e} (same bits required, "
                f"twice; -0s {neg0}, subnormals {sub}) "
                f"ms={cuda_ms(torch, kern):.4f} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {label} disagrees with its "
                                     f"plain version: {err:.3e}")


#: the engine's precision knobs and their defaults
DTYPE_KNOBS = {"compute_dtype": None, "state_dtype": "float32",
               "master_dtype": "float32"}
FUSED_KNOBS = {"fused_elementwise": True, "fused_tail": True}
_BF16_FUSED_COUNTS = {"fused_block_bf16_fwd": (2, 2),
                      "fused_block_bf16_bwd": (2, 0),
                      "bias_relu_bf16_fwd": (3, 3),
                      "bias_relu_bf16_bwd": (3, 0)}
#: phase 10's AlexNet runs: routing -> (knobs, {kernel: (launches per
#: train step, per eval step)}, stored dtypes of (parameters, velocities))
BF16_ROUTINGS = {
    "f32:composed": ({}, {}, ("float32", "float32")),
    "f32:fused": (FUSED_KNOBS, TRAIN_ROUTINGS["fused"][1],
                  ("float32", "float32")),
    "bf16:composed": ({"compute_dtype": "bf16"}, {},
                      ("float32", "float32")),
    "bf16:fused": ({"compute_dtype": "bf16", **FUSED_KNOBS},
                   _BF16_FUSED_COUNTS, ("float32", "float32")),
    "bf16:fused+state_dtype": (
        {"compute_dtype": "bf16", "state_dtype": "bfloat16", **FUSED_KNOBS},
        _BF16_FUSED_COUNTS, ("float32", "bfloat16")),
    "bf16:fused+master_dtype": (
        {"compute_dtype": "bf16", "master_dtype": "bfloat16",
         **FUSED_KNOBS}, _BF16_FUSED_COUNTS, ("bfloat16", "float32")),
    "bf16:pallas_lrn": (
        {"compute_dtype": "bf16", "pallas_lrn": True, "fused_tail": True},
        {"lrn_bf16_fwd": (2, 2), "lrn_bf16_bwd": (2, 0),
         "bias_relu_bf16_fwd": (5, 5), "bias_relu_bf16_bwd": (5, 0)},
        ("float32", "float32")),
}
#: a bf16 routing's per-step losses against the bf16 composed run's: the
#: band of the reference's own bf16 routing tests
#: (tests/test_fused_block_pallas.py:251-266, tests/test_fused_tail.py)
BF16_LOSS_RTOL = 5e-2


def set_knobs(knobs):
    """Set ``root.common.engine`` knobs; returns a function that puts
    them back to their defaults (False, or :data:`DTYPE_KNOBS`')."""
    from znicz_torch.core.config import root

    for key, val in knobs.items():
        setattr(root.common.engine, key, val)

    def reset():
        for key in knobs:
            setattr(root.common.engine, key, DTYPE_KNOBS.get(key, False))

    return reset


def bf16_train(torch, card):
    """Phase 10's AlexNet runs (:data:`BF16_ROUTINGS`): full-width AlexNet
    (phase 6's configuration), ``FusedTrainer.run()`` from the same
    weights, shuffles and dropout masks under each routing.  Returns
    {routing: {kernel: launches}}."""
    from torch import nn

    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.decision import DecisionGD
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import training_workflow

    root.alexnet.loader.update(TRAIN_CFG)
    root.alexnet.decision.max_epochs = TRAIN_EPOCHS
    prng.reset(SEED)
    wf = no_snapshots(training_workflow())
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    ctrs = counters()
    runs = {}
    for label, (knobs, expect, stored) in BF16_ROUTINGS.items():
        prng.reset(SEED)                        # same shuffles, same masks
        wf.loader.reset()
        for f in wf.forwards:                   # fresh float32 parameters
            for k, w in start.get(f.name, {}).items():
                setattr(f, k, nn.Parameter(w.clone(), requires_grad=False))
        for gd in wf.gds.values():
            gd.velocities = {}
        wf.decision = DecisionGD(max_epochs=TRAIN_EPOCHS, fail_iterations=0)
        reset = set_knobs(knobs)
        try:
            trainer = FusedTrainer(wf)
            for fn in ctrs.values():            # the main path starts here
                fn.launches = 0
            for name in BF16_PLANNED:
                ctrs[name].simple_launches = 0
            t0 = time.perf_counter()
            trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in ctrs.items()}
            simple = {name: ctrs[name].simple_launches
                      for name in BF16_PLANNED}
            st = trainer.stats
            n_train, n_eval = st["train_steps"], st["eval_steps"]
            losses = list(trainer.train_losses)
            dtypes = (
                {str(p.dtype).split(".")[-1]
                 for ps in trainer.extract_params().values()
                 for p in ps.values()},
                {str(v.dtype).split(".")[-1]
                 for vs in trainer.extract_velocities().values()
                 for v in vs.values()})
            idx = np.arange(BATCH)
            step_ms = cuda_ms(torch,
                              lambda: trainer.train_step(idx, BATCH, 0),
                              iters=5, warmup=1)
        finally:
            reset()
        log(f"[bf16:{label}] {n_train} train steps + {n_eval} eval steps "
            f"in {wall:.2f}s; losses {['%.6f' % v for v in losses]}; "
            f"stored dtypes: parameters {sorted(dtypes[0])}, velocities "
            f"{sorted(dtypes[1])}")
        log(f"[bf16:{label}] {card}: one train step {step_ms:.3f} ms on "
            f"the device ({BATCH / step_ms * 1e3:.0f} images/s); "
            f"images/s={st['img_per_sec']:.1f} (after the first step of "
            f"each kind {st['warm_img_per_sec']:.1f}); launches={launches}")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"[bf16:{label}] non-finite loss: {losses}")
        if dtypes != ({stored[0]}, {stored[1]}):
            raise AssertionError(f"[bf16:{label}] stored dtypes {dtypes}, "
                                 f"expected {stored}")
        if any(simple.values()):                # AlexNet's shapes
            raise AssertionError(f"[bf16:{label}] a simple bf16 kernel "
                                 f"ran: {simple}")
        for name, fn in ctrs.items():
            per_train, per_eval = expect.get(name, (0, 0))
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want:
                raise AssertionError(
                    f"[bf16:{label}] {name}: {launches[name]} launches for "
                    f"{n_train} train + {n_eval} eval steps, expected {want}")
        runs[label] = (losses, launches, step_ms)
    def max_rel(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))

    f32_base = runs["f32:composed"][0]
    for label, (losses, _, _) in runs.items():
        f32 = label.startswith("f32")
        ref = f32_base if f32 else runs["bf16:composed"][0]
        l_err = max_rel(losses, ref)
        tol = LOSS_RTOL if f32 else BF16_LOSS_RTOL
        log(f"[bf16:{label}] losses vs {'f32' if f32 else 'bf16'}:composed:"
            f" max rel {l_err:.3e} (tol {tol:g}); vs f32:composed: max rel "
            f"{max_rel(losses, f32_base):.3e}")
        if len(losses) != len(ref) or l_err > tol:
            raise AssertionError(f"[bf16:{label}] leaves the band: "
                                 f"{l_err:.3e}")
    log(f"[bf16:step] {card}: one AlexNet train step, batch {BATCH}, ms on "
        f"the device: " + ", ".join(f"{label} {ms:.3f}"
                                    for label, (_, _, ms) in runs.items()))
    del wf
    torch.cuda.empty_cache()
    return {label: launches for label, (_, launches, _) in runs.items()}


def bf16_mnist(torch, card):
    """MNIST at its defaults (BASELINE config 0) on ``FusedTrainer``,
    float32 and then bf16, every named stream reset to ``ANCHOR_SEED``
    before each: the bf16 run's final train loss within rtol
    BF16_LOSS_RTOL of the float32 run's, and its valid error within that
    rtol or one valid image (a count of whole images)."""
    from znicz_torch.core import prng
    from znicz_torch.samples import mnist, train

    finals = {}
    for label, knobs in (("f32", {}), ("bf16", {"compute_dtype": "bf16"})):
        prng.reset(ANCHOR_SEED)
        reset = set_knobs(knobs)
        try:
            wf = train(mnist.MnistWorkflow(), "mnist", fused=True)
            dtype = wf.trainer.compute_dtype
        finally:
            reset()
        d = wf.decision
        finals[label] = (d.epoch_metrics[2]["loss"],
                         d.epoch_metrics[1]["err_pct"],
                         wf.loader.class_lengths[1])
        log(f"[bf16:mnist:{label}] {card}: compute {dtype}: "
            f"final_train_loss={finals[label][0]:.9f} "
            f"valid_err_pct={finals[label][1]} images/s="
            f"{wf.train_stats['img_per_sec']:.1f}")
        del wf
    (l32, e32, n_valid), (l16, e16, _) = finals["f32"], finals["bf16"]
    one_image = 100.0 / max(n_valid, 1)
    l_err = abs(l16 - l32) / abs(l32)
    ok = l_err <= BF16_LOSS_RTOL and abs(e16 - e32) <= max(
        BF16_LOSS_RTOL * abs(e32), one_image)
    log(f"[bf16:mnist] bf16 vs f32: train loss rel {l_err:.3e} (tol "
        f"{BF16_LOSS_RTOL:g}), valid err {e16} vs {e32} (tol "
        f"{BF16_LOSS_RTOL:g} rel or one image, {one_image:g}%) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or not np.isfinite(l16):
        raise AssertionError(f"[bf16:mnist] bf16 leaves the float32 run: "
                             f"{finals}")


#: phase 10's CIFAR10 run: knobs and {kernel: (launches per train step,
#: per eval step)}; its one LRN follows a pool, so no block kernel fuses
BF16_CIFAR = ({"compute_dtype": "bf16", "pallas_lrn": True,
               "fused_tail": True},
              {"bias_relu_bf16_fwd": (3, 3), "bias_relu_bf16_bwd": (3, 0),
               "lrn_bf16_fwd": (1, 1), "lrn_bf16_bwd": (1, 0)})
#: the bf16 variants at CIFAR10's batch-100 shapes, as CIFAR_SHAPES
CIFAR_BF16_SHAPES = {"bias_relu_bf16_fwd": CIFAR_LAYERS,
                     "bias_relu_bf16_bwd": CIFAR_LAYERS,
                     "lrn_bf16_fwd": {"norm": (16, 16)},
                     "lrn_bf16_bwd": {"norm": (16, 16)}}


def bf16_cifar(torch, card):
    """CIFAR10 at its defaults (BASELINE config 1) on ``FusedTrainer``
    under :data:`BF16_CIFAR`'s knobs, every named stream reset to
    ``ANCHOR_SEED``: every loss finite, the first ``STEP_CHECK`` train
    losses within BF16_LOSS_RTOL of the port's CPU run of the same
    configuration, each kernel launched exactly its count per step; the
    finals printed beside phase 8's float32 ``pallas_lrn`` run's, a miss
    of ``ANCHOR_BANDS[1]`` printed as a drift (the band is the float32
    reference's), not raised.  Returns {kernel: launches}."""
    from znicz_torch.core import prng
    from znicz_torch.samples import cifar, train

    knobs, expect = BF16_CIFAR
    ctrs = counters()
    prng.reset(ANCHOR_SEED)
    reset = set_knobs(knobs)
    try:
        wf = cifar.CifarWorkflow()
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        for name in BF16_LRN + BF16_VEC:
            ctrs[name].simple_launches = 0
        t0 = time.perf_counter()
        train(wf, "cifar", fused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        simple = {name: ctrs[name].simple_launches
                  for name in BF16_LRN + BF16_VEC}
        dtype = wf.trainer.compute_dtype
        cpu = cpu_steps("cifar", STEP_CHECK)
    finally:
        reset()
    d, st = wf.decision, wf.trainer.stats
    losses = list(wf.trainer.train_losses)
    finals = {"final_train_loss": d.epoch_metrics[2]["loss"],
              "valid_err_pct": d.epoch_metrics[1]["err_pct"]}
    n_train, n_eval = st["train_steps"], st["eval_steps"]
    step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
    log(f"[bf16:cifar] {card}: compute {dtype}: {json.dumps(finals)}; "
        f"float32 pallas_lrn (phase 8): "
        f"{json.dumps(ANCHOR_FINALS.get('cifar:pallas_lrn', 'not run'))}; "
        f"{n_train} train steps + {n_eval} eval steps, run() {wall:.2f}s, "
        f"images/s={st['img_per_sec']:.1f} (after the first call of each "
        f"kind {st['warm_img_per_sec']:.1f}); launches={launches}")
    log(f"[bf16:cifar] first {STEP_CHECK} train losses vs the port on the "
        f"CPU: max rel {step_err:.3e} (tol {BF16_LOSS_RTOL:g})")
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"[bf16:cifar] non-finite loss: {losses}")
    if any(simple.values()):                    # C 16 and 32
        raise AssertionError(f"[bf16:cifar] a simple bf16 kernel ran: "
                             f"{simple}")
    for name in ctrs:
        per_train, per_eval = expect.get(name, (0, 0))
        want = per_train * n_train + per_eval * n_eval
        if launches[name] != want:
            raise AssertionError(
                f"[bf16:cifar] {name}: {launches[name]} launches for "
                f"{n_train} train + {n_eval} eval steps, expected {want}")
    if step_err > BF16_LOSS_RTOL:
        raise AssertionError(f"[bf16:cifar] the card leaves the CPU's first "
                             f"{STEP_CHECK} steps: {step_err:.3e}")
    for m, (c, h) in ANCHOR_BANDS[1].items():
        if abs(finals[m] - c) > h:
            log(f"[bf16:cifar] MISS: {m} {finals[m]} outside {c} +- {h} "
                f"(BASELINE config 1, a float32 band), a drift")
    del wf
    torch.cuda.empty_cache()
    return launches


def bf16_phase(torch, card):
    """Phase 10: the bf16 variants against their plain versions, at
    AlexNet's and CIFAR10's shapes and the ``*_PATHS`` cases, then
    :func:`bf16_train`, :func:`bf16_mnist` and :func:`bf16_cifar`.
    Returns ({kernel: JSON row}, {routing: {kernel: launches}})."""
    rows = check_kernels(torch, list(BF16_KERNELS))
    check_bf16_paths(torch)
    check_bf16_lrn_paths(torch)
    cifar_rows(torch, rows, CIFAR_BF16_SHAPES)
    torch.cuda.empty_cache()
    runs = bf16_train(torch, card)
    bf16_mnist(torch, card)
    runs["bf16:cifar"] = bf16_cifar(torch, card)
    return rows, runs


def cifar_rows(torch, rows, shapes=CIFAR_SHAPES, tag="cifar",
               batch=CIFAR_BATCH):
    """K2, K2b, K3 and K3b (or the kernels of ``shapes``) at CIFAR10's
    shapes (or at ``shapes`` and ``batch``) against their plain versions,
    as at AlexNet's; their times and bounds (and a ring kernel's
    ``simple_ms``) go into each kernel's row under ``tag``."""
    for name, row in check_kernels(torch, list(shapes), shapes,
                                   batch).items():
        rows.setdefault(name, {"name": name})[tag] = {
            key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "host_us", "device_ms", "simple_ms",
                                      "simple_device_ms") if key in row}

#: phase 11: sample -> BASELINE config; MnistAE's first STEP_CHECK train
#: losses and every Kohonen epoch's qerror are held to the port's CPU run
AE_SOM_RUNS = {"mnist_ae": 2, "kohonen": 3}


def live_tensors(wf):
    """(name, tensor) of every parameter, velocity and dataset copy of
    ``wf``'s units."""
    from znicz_torch.nn_units import GradientDescentBase

    out = [("loader.data", wf.loader.data)]
    for u in wf:
        if hasattr(u, "params"):
            out += [(f"{u.name}.{k}", t) for k, t in u.params().items()]
        if isinstance(u, GradientDescentBase):
            out += [(f"{u.name}.v.{k}", t) for k, t in u.velocities.items()]
    return out


def ae_som_phase(torch, card, samples=tuple(AE_SOM_RUNS)):
    """Phase 11: MnistAE and Kohonen (BASELINE configs 2 and 3) at their
    defaults on the unit engine on the card, every named stream reset to
    ``ANCHOR_SEED``: finals inside ``ANCHOR_BANDS`` (no ``DRIFTS``);
    MnistAE's first ``STEP_CHECK`` train losses and Kohonen's qerror of
    every epoch within ``STEP_RTOL`` of the port's CPU run of the same
    seed; every parameter, velocity and the dataset on the card;
    ``conv.weights`` and ``deconv.weights`` one tensor after training;
    no kernel launched.  Returns {sample: {kernel: launches}}."""
    import importlib

    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.core import prng
    from znicz_torch.samples import train

    ctrs = counters()
    runs = {}
    for sample in samples:
        config = AE_SOM_RUNS[sample]
        mod = importlib.import_module(f"znicz_torch.samples.{sample}")
        prng.reset(ANCHOR_SEED)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        wf = getattr(mod, ANCHOR_WORKFLOWS[sample])()
        train(wf, sample)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        d, st = wf.decision, wf.train_stats
        if sample == "kohonen":
            epochs = len(d.epoch_qerror)
            steps = list(d.epoch_qerror)
            prng.reset(ANCHOR_SEED)
            cpu = train(mod.KohonenWorkflow(device="cpu"),
                        sample).decision.epoch_qerror
            what = f"qerror of all {len(cpu)} epochs"
        else:
            epochs = int(d.epoch_number) + 1
            steps = list(d.train_losses[:STEP_CHECK])
            cpu = cpu_unit_steps(sample, STEP_CHECK)
            what = f"first {STEP_CHECK} train losses"
        if len(steps) != len(cpu):
            raise AssertionError(f"[{sample}] {len(steps)} steps on the "
                                 f"card, {len(cpu)} on the CPU")
        step_err = max(abs(a - b) / abs(b) for a, b in zip(steps, cpu))
        finals = sample_finals(sample, wf)
        bands = {m: {"value": finals[m], "center": c, "band": h,
                     "ok": abs(finals[m] - c) <= h}
                 for m, (c, h) in ANCHOR_BANDS[config].items()}
        where = {name: str(t.device) for name, t in live_tensors(wf)}
        unit = "points" if sample == "kohonen" else "images"
        log(f"[{sample}] {card}: {json.dumps(finals)} bands "
            f"{json.dumps(bands)}; {epochs} epochs, {st['train_steps']} "
            f"updates on {wf.device}; run() "
            f"{wall:.2f}s, {unit}/s={st['img_per_sec']:.1f} (after the "
            f"first epoch {st['warm_img_per_sec']:.1f}); "
            f"launches={launches}")
        log(f"[{sample}] {what} vs the port's unit engine on the CPU: max "
            f"rel {step_err:.3e} (tol {STEP_RTOL:g}); {len(where)} tensors "
            f"on {sorted(set(where.values()))}; unit timing:\n"
            f"{wf.print_stats()}")
        if not all(np.isfinite(steps)):
            raise AssertionError(f"[{sample}] non-finite loss")
        if any(launches.values()):
            raise AssertionError(f"[{sample}] a kernel launched: {launches}")
        off = {n: dev for n, dev in where.items()
               if not dev.startswith("cuda")}
        if off:
            raise AssertionError(f"[{sample}] tensors off the card: {off}")
        if sample == "mnist_ae":
            cw, dw = wf.conv.module.weights, wf.deconv.module.weights
            if cw is not dw or cw.data_ptr() != dw.data_ptr():
                raise AssertionError("[mnist_ae] conv.weights and "
                                     "deconv.weights no longer share "
                                     "storage")
            log(f"[mnist_ae] conv.weights and deconv.weights: one tensor "
                f"at {cw.data_ptr():#x} after training")
        if step_err > STEP_RTOL:
            raise AssertionError(f"[{sample}] the card leaves the CPU's "
                                 f"{what}: {step_err:.3e}")
        missed = {m: b for m, b in bands.items() if not b["ok"]}
        if missed:
            raise AssertionError(f"[{sample}] outside the band of BASELINE "
                                 f"config {config}: {missed}")
        runs[sample] = launches
        del wf
        torch.cuda.empty_cache()
    return runs


# -- phase 12: the layer kinds ported last ------------------------------------


def plain_conv(layers):
    """``layers`` with each ``conv_strict_relu`` as a plain ``conv`` (the
    same keywords) followed by an ``activation_str`` layer."""
    out = []
    for layer in layers:
        if layer["type"] == "conv_strict_relu":
            out.append({**layer, "type": "conv"})
            out.append({"type": "activation_str"})
        else:
            out.append(layer)
    return out


#: phase 12's AlexNet routings: label -> (knobs, {kernel: (launches per
#: train step, per eval step)}), those of the ``conv_strict_relu`` model
KIND_ROUTINGS = {
    "composed": ({}, {}),
    "fused": TRAIN_ROUTINGS["fused"],
    "pallas_lrn": TRAIN_ROUTINGS["pallas_lrn"],
    "bf16:fused": ({"compute_dtype": "bf16", **FUSED_KNOBS},
                   _BF16_FUSED_COUNTS),
}


def alexnet_run(torch, wf, start, knobs, mask_fn=None):
    """``FusedTrainer.run()`` of ``wf`` (phase 6's configuration) from the
    parameters ``start`` (a list in the order of ``wf``'s weighted
    modules), every named stream reset to SEED, under ``knobs``; returns
    (losses, final parameters in that order, launches, train steps, eval
    steps, one train step's device ms)."""
    from torch import nn

    from znicz_torch.core import prng
    from znicz_torch.decision import DecisionGD
    from znicz_torch.parallel.fused import FusedTrainer

    prng.reset(SEED)
    wf.loader.reset()
    weighted = [f for f in wf.forwards if f.has_weights]
    for f, leaves in zip(weighted, start):
        for k, w in leaves.items():
            setattr(f, k, nn.Parameter(w.clone(), requires_grad=False))
    for gd in wf.gds.values():
        gd.velocities = {}
    wf.decision = DecisionGD(max_epochs=TRAIN_EPOCHS, fail_iterations=0)
    ctrs = counters()
    reset = set_knobs(knobs)
    try:
        trainer = FusedTrainer(wf, mask_fn=mask_fn)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        trainer.run()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in ctrs.items()}
        steps = (trainer.stats["train_steps"], trainer.stats["eval_steps"])
        final = [{k: p.detach().clone() for k, p in f_params.items()}
                 for f_params in (FusedTrainer._params_of(f)
                                  for f in weighted)]
        idx = np.arange(BATCH)
        step_ms = cuda_ms(torch, lambda: trainer.train_step(idx, BATCH, 0),
                          iters=5, warmup=1)
    finally:
        reset()
    return (list(trainer.train_losses), final, launches, *steps, step_ms)


def kinds_alexnet(torch, card):
    """Phase 12's AlexNet: phase 6's configuration built from plain
    ``conv`` + ``activation_str`` layers, loaded with the
    ``conv_strict_relu`` model's weights and trained with its dropout
    masks (looked up by its layer indices) under each of
    :data:`KIND_ROUTINGS`, beside that model under the same routing: under
    the kernel routings the same losses and final weights bit for bit and
    the same launch counts, under composed within LOSS_RTOL and the weight
    band.  Returns {routing: {kernel: launches}} of the plain model."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import make_layers, training_workflow
    from znicz_torch.standard_workflow import StandardWorkflow

    root.alexnet.loader.update(TRAIN_CFG)
    root.alexnet.decision.max_epochs = TRAIN_EPOCHS
    prng.reset(SEED)
    base = no_snapshots(training_workflow())
    ldr = FullBatchLoader(minibatch_size=BATCH)
    ldr.original_data = base.loader.original_data
    ldr.original_labels = base.loader.original_labels
    ldr.class_lengths = list(base.loader.class_lengths)
    layers = plain_conv(make_layers(TRAIN_CFG["n_classes"]))
    plain = no_snapshots(StandardWorkflow(
        layers, name="PlainConvAlexNet", loader=ldr,
        decision_config={"max_epochs": TRAIN_EPOCHS, "fail_iterations": 0}))
    kinds = [f.layer_kind for f in plain.forwards]
    log(f"[kinds:alexnet] {len(kinds)} layers: {kinds}")
    start = [{k: p.detach().clone()
              for k, p in FusedTrainer._params_of(f).items()}
             for f in base.forwards if f.has_weights]
    # the plain model's layer index -> the conv_strict_relu model's
    remap = {i: j for j, i in enumerate(
        i for i, kind in enumerate(kinds) if kind != "activation_str")}
    masks = FusedTrainer(base)

    def mask_fn(step, index, shape, ratio):
        return masks.default_mask(step, remap[index], shape, ratio)

    runs = {}
    for label, (knobs, expect) in KIND_ROUTINGS.items():
        ref = alexnet_run(torch, base, start, knobs)
        got = alexnet_run(torch, plain, start, knobs, mask_fn)
        losses, final, launches, n_train, n_eval, step_ms = got
        same = (losses == ref[0] and all(
            torch.equal(a[k], b[k]) for a, b in zip(final, ref[1])
            for k in a))
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0]))
        w_err = max(float(((a[k] - b[k]).abs()
                           / (W_ATOL + W_RTOL * b[k].abs())).max())
                    for a, b in zip(final, ref[1]) for k in a)
        log(f"[kinds:alexnet:{label}] {n_train} train + {n_eval} eval steps;"
            f" losses {['%.6f' % v for v in losses]}; vs conv_strict_relu: "
            f"bit-equal {same}, losses max rel {l_err:.3e}, weights max "
            f"|d|/({W_ATOL:g}+{W_RTOL:g}|w|) {w_err:.3f}; launches "
            f"{ {k: v for k, v in launches.items() if v} } (conv_strict_relu"
            f" { {k: v for k, v in ref[2].items() if v} })")
        log(f"[kinds:alexnet:{label}] {card}: one train step {step_ms:.3f} "
            f"ms on the device (conv_strict_relu {ref[5]:.3f} ms)")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"[kinds:{label}] non-finite loss")
        for name in launches:
            per_train, per_eval = expect.get(name, (0, 0))
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want or ref[2][name] != want:
                raise AssertionError(
                    f"[kinds:{label}] {name}: {launches[name]} launches "
                    f"(conv_strict_relu {ref[2][name]}) for {n_train} train"
                    f" + {n_eval} eval steps, expected {want}")
        if expect and not same:
            raise AssertionError(f"[kinds:{label}] the plain-conv model "
                                 f"leaves the conv_strict_relu model's bits")
        if len(losses) != len(ref[0]) or l_err > LOSS_RTOL or w_err > 1.0:
            raise AssertionError(f"[kinds:{label}] leaves the band: losses "
                                 f"{l_err:.3e}, weights {w_err:.3f}")
        runs[label] = launches
    del base, plain, masks
    torch.cuda.empty_cache()
    return runs


#: phase 12's stochastic pooling net: 28x28 digit glyphs, a narrow conv,
#: tanh, an overlapping 3x3/2 stochastic pool, softmax; 600 train and 200
#: valid rows in minibatches of 60, 2 epochs
STOCH_ROWS, STOCH_BATCH, STOCH_EPOCHS = (200, 600), 60, 2
STOCH_LAYERS = [
    {"type": "conv", "->": {"n_kernels": 8, "kx": 5, "ky": 5},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "activation_tanh"},
    {"type": "stochastic_pooling", "->": {"kx": 3, "ky": 3,
                                          "sliding": (2, 2)}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]
#: the default sampler's chi-square at a fixed seed: 0.1% point of
#: chi-square with 3 degrees of freedom
CHI2_LIMIT = 16.27


def stochastic_workflow(device):
    """The stochastic pooling net on ``device``, every named stream reset
    to ANCHOR_SEED first."""
    from znicz_torch import datasets
    from znicz_torch.core import prng
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.standard_workflow import StandardWorkflow

    prng.reset(ANCHOR_SEED)
    ldr = FullBatchLoader(minibatch_size=STOCH_BATCH)
    n = sum(STOCH_ROWS)
    data, labels = datasets.digits(n)
    ldr.original_data = data.reshape(n, 28, 28, 1)
    ldr.original_labels = labels
    ldr.class_lengths = [0, *STOCH_ROWS]
    return no_snapshots(StandardWorkflow(
        STOCH_LAYERS, device=device, name="StochasticNet", loader=ldr,
        decision_config={"max_epochs": STOCH_EPOCHS,
                         "fail_iterations": 0}))


def _recorded(record, replay):
    """A maker of offset seams around a ``default`` draw: with ``replay``
    (a dict) the seam returns the offsets recorded under the same
    arguments (all but the probabilities), moved to the probabilities'
    device; else it draws with ``default`` and records them in
    ``record`` on the host."""
    def seam(default):
        def fn(*args):
            key, probs = args[:-1], args[-1]
            if replay is not None:
                return replay[key].to(probs.device)
            off = default(*args)
            record[key] = off.cpu()
            return off
        return fn
    return seam


def stochastic_runs(torch, card):
    """Phase 12's stochastic pooling: the net on the CPU and then on the
    card, on the unit engine and on ``FusedTrainer``, the card replaying
    the offsets the CPU run drew; the first STEP_CHECK losses within
    STEP_RTOL; no kernel launched.  Then the default sampler's chi-square
    on the card, and the fused select's backward twice, the same bits."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.pooling import StochasticPooling, StochasticPoolingUnit
    from znicz_torch.samples import train

    ctrs = counters()
    for fused in (False, True):
        label = "fused" if fused else "units"
        losses, record = {}, {}
        for device in ("cpu", None):
            wf = stochastic_workflow(device)
            seam = _recorded(record, record if device is None else None)
            if fused:
                trainer = FusedTrainer(wf)
                trainer.offset_fn = seam(trainer.default_offsets)
            else:
                for u in wf.forward_units:
                    if isinstance(u, StochasticPoolingUnit):
                        u.offset_fn = seam(u.default_offsets)
            for fn in ctrs.values():            # the main path starts here
                fn.launches = 0
            t0 = time.perf_counter()
            if fused:
                trainer.run()
                wf.train_stats = {k: trainer.stats[k] for k in
                                  ("train_steps", "img_per_sec")}
            else:
                train(wf, "stochastic", fused=False)
            if device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses[device] = list(wf.decision.train_losses)
        launches = {k: v for k, v in ctrs.items() if v.launches}
        card_l, cpu_l = losses[None][:STEP_CHECK], losses["cpu"][:STEP_CHECK]
        err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        log(f"[kinds:stochastic:{label}] {card}: {len(losses[None])} train "
            f"losses on {wf.device}, the last {losses[None][-1]:.6f} (CPU "
            f"{losses['cpu'][-1]:.6f}); first {STEP_CHECK} vs the CPU run: "
            f"max rel {err:.3e} (tol {STEP_RTOL:g}); {len(record)} offset "
            f"draws replayed; valid err% "
            f"{wf.decision.epoch_metrics[1]['err_pct']}; run() {wall:.2f}s, "
            f"images/s={wf.train_stats['img_per_sec']:.1f}")
        if len(card_l) != STEP_CHECK or not all(np.isfinite(losses[None])):
            raise AssertionError(f"[kinds:stochastic:{label}] losses "
                                 f"{losses[None]}")
        if err > STEP_RTOL:
            raise AssertionError(f"[kinds:stochastic:{label}] the card "
                                 f"leaves the CPU's losses: {err:.3e}")
        if launches:
            raise AssertionError(f"[kinds:stochastic:{label}] a kernel "
                                 f"launched: {sorted(launches)}")
    from znicz_torch.core import prng

    p = torch.tensor([0.1, 0.0, 0.2, 0.3, 0.0, 0.4], device="cuda")
    n = 1 << 20
    gen = prng.get("sampler").torch_generator(0, 0, "cuda")
    off = StochasticPooling.sample_offsets(p.repeat(n, 1), gen)
    counts = torch.bincount(off, minlength=6).cpu().numpy()
    want = p.cpu().numpy()[[0, 2, 3, 5]] * n
    chi2 = float((((counts[[0, 2, 3, 5]] - want) ** 2) / want).sum())
    log(f"[kinds:stochastic] the default sampler (Philox) over {n} windows: "
        f"counts {counts.tolist()}, chi-square {chi2:.3f} (limit "
        f"{CHI2_LIMIT}, 3 degrees of freedom)")
    if chi2 >= CHI2_LIMIT or counts[1] or counts[4]:
        raise AssertionError(f"[kinds:stochastic] the sampler leaves its "
                             f"probabilities: {counts}, {chi2:.3f}")
    pool = StochasticPooling(name="sp", kx=3, ky=3, sliding=(2, 2))
    pool.build((STOCH_BATCH, 24, 24, 8), torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(STOCH_BATCH, 24, 24, 8, device="cuda", generator=g)
    x.requires_grad_(True)
    off = pool.sample_offsets(pool.probabilities(
        pool.windows(x.detach(), 0.0)), g)
    dy = torch.randn(pool.output_shape_for(tuple(x.shape)), device="cuda",
                     generator=g)
    dxs = [torch.autograd.grad(pool.select_sampled(x, off), x, dy)[0]
           for _ in range(2)]
    same = same_bits(torch, dxs[0], dxs[1])
    log(f"[kinds:stochastic] fused select backward at ({STOCH_BATCH}, 24, "
        f"24, 8) 3x3/2: the same bits twice {same}")
    if not same:
        raise AssertionError("[kinds:stochastic] the select's backward is "
                             "not deterministic")


#: the reference's wine finals at seed 1013 on the CPU (``python -m
#: znicz_tpu wine``'s last epoch line: epoch 19, valid err_pct 0, train
#: loss 0.00575249)
WINE_REF_FINALS = {"valid_err_pct": 0.0, "final_train_loss": 0.00575249}


def wine_runs(torch, card):
    """Phase 12's ``wine`` at its defaults, every named stream reset to
    ANCHOR_SEED, on the unit engine and on ``FusedTrainer``: the first
    STEP_CHECK losses within STEP_RTOL of the port's CPU run, the
    normalised dataset on the card and equal to the CPU's, no kernel
    launched."""
    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.core import prng
    from znicz_torch.samples import train
    from znicz_torch.samples.wine import WineWorkflow

    ctrs = counters()
    for fused in (False, True):
        label = "fused" if fused else "units"
        out = {}
        for device in ("cpu", None):
            prng.reset(ANCHOR_SEED)
            for fn in ctrs.values():            # the main path starts here
                fn.launches = 0
            t0 = time.perf_counter()
            wf = WineWorkflow(device)
            data = wf.loader.data
            train(wf, "wine", fused=fused)
            if device is None:
                torch.cuda.synchronize()
            out[device] = (wf, data, time.perf_counter() - t0)
        wf, data, wall = out[None]
        cpu_wf, cpu_data, _ = out["cpu"]
        launches = {k: v.launches for k, v in ctrs.items() if v.launches}
        steps = wf.decision.train_losses[:STEP_CHECK]
        cpu = cpu_wf.decision.train_losses[:STEP_CHECK]
        err = max(abs(a - b) / abs(b) for a, b in zip(steps, cpu))
        same_data = bool(torch.equal(data.cpu(), cpu_data))
        fin = sample_finals("wine", wf)
        log(f"[kinds:wine:{label}] {card}: {json.dumps(fin)} (the "
            f"reference's CPU finals {json.dumps(WINE_REF_FINALS)}, the "
            f"port's CPU {json.dumps(sample_finals('wine', cpu_wf))}); "
            f"{wf.train_stats['train_steps']} updates; run() {wall:.2f}s, "
            f"rows/s={wf.train_stats['img_per_sec']:.1f}; first "
            f"{STEP_CHECK} losses vs the CPU: max rel {err:.3e} (tol "
            f"{STEP_RTOL:g}); dataset {tuple(data.shape)} on {data.device}, "
            f"normalised, equal to the CPU's {same_data}")
        if data.device.type != "cuda" or not same_data:
            raise AssertionError(f"[kinds:wine:{label}] the normalised "
                                 f"dataset is not the CPU's on the card")
        if len(steps) != STEP_CHECK or err > STEP_RTOL:
            raise AssertionError(f"[kinds:wine:{label}] the card leaves "
                                 f"the CPU's losses: {err:.3e}")
        if launches:
            raise AssertionError(f"[kinds:wine:{label}] a kernel launched: "
                                 f"{launches}")


def kinds_phase(torch, card):
    """Phase 12: the plain-conv AlexNet, stochastic pooling and ``wine``.
    Returns {routing: {kernel: launches}} of the plain-conv AlexNet."""
    t0 = time.perf_counter()
    runs = kinds_alexnet(torch, card)
    t1 = time.perf_counter()
    stochastic_runs(torch, card)
    t2 = time.perf_counter()
    wine_runs(torch, card)
    log(f"[kinds] {card}: AlexNet {t1 - t0:.2f}s, stochastic pooling "
        f"{t2 - t1:.2f}s, wine {time.perf_counter() - t2:.2f}s")
    return runs


# -- phase 13: Kanji, VideoAE, YaleFaces and the host runtime ----------------

#: XorShift128P(1013)'s first 16 uniforms in [0, 1), and its shuffle of
#: arange(1000) as int32 (the first 8 and the sha256 of its bytes): the
#: values tests/test_torch_native.py pins on the CPU
NATIVE_PINS = {
    "seed": 1013,
    "uniform": [
        0.8475832343101501, 0.1285988837480545, 0.14996427297592163,
        0.4142548143863678, 0.8048638105392456, 0.12118154764175415,
        0.9533067941665649, 0.3582358658313751, 0.44586315751075745,
        0.31895825266838074, 0.2598508894443512, 0.7621958255767822,
        0.7675018310546875, 0.9624818563461304, 0.45829910039901733,
        0.37678441405296326],
    "shuffle_head": [134, 720, 975, 392, 259, 467, 339, 25],
    "shuffle_sha256":
        "a19974db28f8eb1626ca826d07f4ebae770872d575a51a9374b22af9a788e582"}
#: the reference's finals at seed 1013 on the CPU, unit engine, defaults
#: (``python -m znicz_tpu <sample>``'s last epoch line)
SAMPLE_REF_FINALS = {
    "kanji": {"valid_err_pct": 0.0, "final_train_loss": 0.00220895},
    "video_ae": {"final_train_mse": 0.40523, "valid_mse": 0.521656},
    "yale_faces": {"valid_err_pct": 59.375, "final_train_loss": 1.7338},
}
#: K2 and K2b at Kanji's (batch 128) and YaleFaces' (batch 32) conv
#: outputs: tag -> (batch, {layer: (plane, channels)})
SAMPLE_SHAPES = {"kanji": (128, {"conv1": (24, 16), "conv2": (12, 32)}),
                 "yale": (32, {"conv1": (32, 8), "conv2": (16, 16)})}
_TAIL = {"bias_relu_fwd": (2, 2), "bias_relu_bwd": (2, 0)}
_TAIL_BF16 = {"bias_relu_bf16_fwd": (2, 2), "bias_relu_bf16_bwd": (2, 0)}
_BF16 = {"compute_dtype": "bf16", "fused_tail": True}
#: phase 13's runs: label -> (sample, on FusedTrainer, knobs, {kernel:
#: (launches per train step, per eval step)}); every kernel not named
#: launches 0 times.  Kanji's and YaleFaces' two convolutions take K2/K2b
#: under ``fused_tail``; VideoAE's two products reach no kernel
SAMPLE_RUNS = {
    "kanji:units": ("kanji", False, {}, {}),
    "kanji:fused_tail": ("kanji", True, {"fused_tail": True}, _TAIL),
    "kanji:bf16:fused_tail": ("kanji", True, _BF16, _TAIL_BF16),
    "video_ae:units": ("video_ae", False, {}, {}),
    "video_ae:fused": ("video_ae", True, {}, {}),
    "yale_faces:units": ("yale_faces", False, {}, {}),
    "yale_faces:fused_tail": ("yale_faces", True, {"fused_tail": True},
                              _TAIL),
    "yale_faces:bf16:fused_tail": ("yale_faces", True, _BF16, _TAIL_BF16),
}


def native_check(card):
    """The host runtime built with g++ from ``znicz_torch/csrc/host``:
    XorShift128P(1013)'s draws against :data:`NATIVE_PINS`."""
    import hashlib

    from znicz_torch import native

    t0 = time.perf_counter()
    path = native.build()
    built = time.perf_counter() - t0
    u = np.zeros(16, np.float32)
    native.XorShift128P(NATIVE_PINS["seed"]).fill_uniform(u, 0.0, 1.0)
    p = np.arange(1000, dtype=np.int32)
    native.XorShift128P(NATIVE_PINS["seed"]).shuffle(p)
    digest = hashlib.sha256(p.tobytes()).hexdigest()
    ok = ([float(v) for v in u] == NATIVE_PINS["uniform"]
          and p[:8].tolist() == NATIVE_PINS["shuffle_head"]
          and digest == NATIVE_PINS["shuffle_sha256"])
    log(f"[samples:native] {card}: {path.name} built in {built:.2f}s; "
        f"XorShift128P({NATIVE_PINS['seed']}) uniforms "
        f"{[round(float(v), 6) for v in u[:4]]}..., shuffle of arange(1000) "
        f"{p[:8].tolist()}... sha256 {digest[:16]}: the pinned values "
        f"{ok}")
    if not ok:
        raise AssertionError("[samples:native] the host runtime's draws "
                             "differ from the pinned ones")


def sample_run(torch, card, label):
    """One run of :data:`SAMPLE_RUNS` at the sample's defaults, every named
    stream reset to ANCHOR_SEED: launches against the counts per step (no
    simple bf16 kernel), every loss finite, the first STEP_CHECK train
    losses within STEP_RTOL (BF16_LOSS_RTOL in bf16) of the port's CPU run
    on the same engine.  Returns (finals, {kernel: launches})."""
    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.samples import train

    sample, fused, knobs, expect = SAMPLE_RUNS[label]
    ctrs = counters()
    reset = set_knobs(knobs)
    try:
        from znicz_torch.core import prng

        prng.reset(ANCHOR_SEED)
        wf = sample_workflow(sample)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        for name in BF16_VEC:
            ctrs[name].simple_launches = 0
        t0 = time.perf_counter()
        train(wf, sample, fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        simple = {name: ctrs[name].simple_launches for name in BF16_VEC}
        cpu = (cpu_steps if fused else cpu_unit_steps)(sample, STEP_CHECK)
    finally:
        reset()
    d, st = wf.decision, wf.train_stats
    trainer = getattr(wf, "trainer", None)
    n_train, n_eval = ((trainer.stats["train_steps"],
                        trainer.stats["eval_steps"]) if fused
                       else (st["train_steps"], 0))
    losses = list(d.train_losses)
    steps = losses[:STEP_CHECK]
    tol = BF16_LOSS_RTOL if "bf16" in label else STEP_RTOL
    step_err = max(abs(a - b) / abs(b) for a, b in zip(steps, cpu))
    fin = sample_finals(sample, wf)
    log(f"[samples:{label}] {card}: {json.dumps(fin)} (the reference's CPU "
        f"{json.dumps(SAMPLE_REF_FINALS[sample])}); {n_train} train steps"
        + (f" + {n_eval} eval steps" if fused else " (updates)")
        + f" on {wf.device}; run() {wall:.2f}s, images/s="
        f"{st['img_per_sec']:.1f} (warm {st['warm_img_per_sec']:.1f}); "
        f"first {STEP_CHECK} train losses vs the port on the CPU: max rel "
        f"{step_err:.3e} (tol {tol:g}); launches="
        f"{ {k: v for k, v in launches.items() if v} }")
    if len(steps) != STEP_CHECK or len(cpu) != STEP_CHECK:
        raise AssertionError(f"[samples:{label}] {len(steps)} steps on the "
                             f"card, {len(cpu)} on the CPU")
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"[samples:{label}] non-finite loss")
    if any(simple.values()):                    # C 8, 16 and 32
        raise AssertionError(f"[samples:{label}] a simple bf16 kernel ran: "
                             f"{simple}")
    for name in ctrs:
        per_train, per_eval = expect.get(name, (0, 0))
        want = per_train * n_train + per_eval * n_eval
        if launches[name] != want:
            raise AssertionError(
                f"[samples:{label}] {name}: {launches[name]} launches for "
                f"{n_train} train + {n_eval} eval steps, expected {want}")
    if step_err > tol:
        raise AssertionError(f"[samples:{label}] the card leaves the CPU's "
                             f"first {STEP_CHECK} steps: {step_err:.3e}")
    del wf
    torch.cuda.empty_cache()
    return fin, launches


def samples_phase(torch, card, rows):
    """Phase 13: the host runtime; K2/K2b (float32 and bf16) at Kanji's and
    YaleFaces' shapes, their rows under ``"kanji"`` and ``"yale"``; then
    every run of :data:`SAMPLE_RUNS`, YaleFaces from PNG files written
    into the temporary directory.  Returns {run: {kernel: launches}}."""
    from znicz_torch.core.config import root

    native_check(card)
    names = ("bias_relu_fwd", "bias_relu_bwd", "bias_relu_bf16_fwd",
             "bias_relu_bf16_bwd")
    for tag, (batch, layers) in SAMPLE_SHAPES.items():
        cifar_rows(torch, rows, {name: layers for name in names}, tag, batch)
    torch.cuda.empty_cache()
    base = os.path.join(root.common.dirs.snapshots, "yale_faces_data")
    root.yale_faces.loader.data_dir = base
    runs, finals = {}, {}
    for label in SAMPLE_RUNS:
        finals[label], runs[label] = sample_run(torch, card, label)
        if label == "yale_faces:units":
            pngs = sum(len(files) for _, _, files in os.walk(base))
            log(f"[samples:yale_faces] {pngs} PNG files under {base} "
                f"(decoded by FullBatchFileImageLoader)")
    for sample in SAMPLE_REF_FINALS:
        log(f"[samples:{sample}] finals "
            + json.dumps({k: v for k, v in finals.items()
                          if k.startswith(sample + ":")})
            + f"; the reference's CPU {json.dumps(SAMPLE_REF_FINALS[sample])}")
    return runs


# -- phase 14: the segmented run, CUDA graphs and the streaming path ---------

#: phase 14's AlexNet: VALID and TRAIN rows of seeded textures (10 train
#: minibatches an epoch: a segment of 8, one of 1 and the tail), epochs
SEG_ROWS, SEG_EPOCHS = (128, 1280), 2
#: the file-streamed run: VALID and TRAIN PNGs, 1 epoch
SEG_FILE_ROWS = (128, 384)
#: routing -> (knobs, {kernel: (launches a train step, an eval step)})
SEG_ROUTINGS = {
    "f32": (FUSED_KNOBS, TRAIN_ROUTINGS["fused"][1]),
    "bf16": ({"compute_dtype": "bf16", **FUSED_KNOBS}, _BF16_FUSED_COUNTS),
}
SEG_CIFAR_KNOBS = {"pallas_lrn": True, "fused_tail": True}
_SEG_UNSET = object()


class engine_knobs:
    """Set ``root.common.engine`` knobs within a ``with`` block and put
    the old values back after it."""

    def __init__(self, **knobs):
        self.knobs, self.saved = knobs, []

    def __enter__(self):
        from znicz_torch.core.config import root

        for key, val in self.knobs.items():
            self.saved.append((key, root.common.engine.get(key, _SEG_UNSET)))
            setattr(root.common.engine, key, val)

    def __exit__(self, *exc):
        from znicz_torch.core.config import root

        for key, old in reversed(self.saved):
            if old is _SEG_UNSET:
                delattr(root.common.engine, key)
            else:
                setattr(root.common.engine, key, old)


def seg_textures(torch, n, n_classes=1000):
    """``n`` seeded 227x227x3 uint8 textures made on the card (15x15
    noise upsampled bilinearly, half of it a tint of the image's class)
    and their labels, on the host."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device="cuda")
    tint = torch.rand((n_classes, 3), generator=gen, device="cuda")
    base = torch.rand((n, 3, 15, 15), generator=gen, device="cuda")
    img = F.interpolate(base, size=(227, 227), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    img = 0.5 * img + 0.5 * tint[labels][:, None, None, :]
    u8 = (img * 255.0).round().clamp(0, 255).to(torch.uint8).contiguous()
    return u8.cpu().numpy(), labels.to(torch.int32).cpu().numpy()


def seg_state(trainer):
    """(losses, parameters, velocities, per-class confusions) of a run,
    copied to the host: a kept state holds no device memory, so every
    run's peak starts from the same allocation."""
    d = trainer.decision
    return (list(d.train_losses),
            {n: {k: p.detach().cpu() for k, p in leaves.items()}
             for n, leaves in trainer.extract_params().items()},
            {n: {k: v.cpu() for k, v in leaves.items()}
             for n, leaves in trainer.extract_velocities().items()},
            [None if m is None or m.get("confusion") is None
             else m["confusion"].cpu() for m in d.epoch_metrics])


def seg_differences(torch, a, b):
    """Where two runs' states differ in a single bit: [] when nowhere."""
    la, pa, va, ca = a
    lb, pb, vb, cb = b
    bad = [] if la == lb else ["losses"]
    for what, ta, tb in (("params", pa, pb), ("velocities", va, vb)):
        for name in ta:
            for k in ta[name]:
                if not torch.equal(ta[name][k], tb[name][k]):
                    bad.append(f"{what}:{name}.{k}")
    for klass, (x, y) in enumerate(zip(ca, cb)):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            bad.append(f"confusion:{klass}")
    return bad


def load_start(torch, wf, start):
    """Every weighted module's parameters set to ``start``, whole: a
    module a meshed trainer split gets whole parameters again and loses
    its placement."""
    from torch import nn

    from znicz_torch.parallel.fused import FusedTrainer

    with torch.no_grad():
        for f in wf.forwards:
            if getattr(f, "mesh_placement", None) is not None:
                for k in f.mesh_placement.specs:
                    setattr(f, k, nn.Parameter(start[f.name][k].clone()))
                del f.mesh_placement
            for k, p in FusedTrainer._params_of(f).items():
                p.copy_(start[f.name][k])


def seg_run(torch, card, label, wf, start, loader, knobs, expect=None,
            epochs=SEG_EPOCHS, remat=False, tag="segments", snapshots=None,
            mesh=None):
    """One ``FusedTrainer.run()`` of ``wf`` (on ``mesh``, if given) from
    ``start`` over ``loader``, every named stream reset to SEED, under
    ``knobs``; the launches held to ``expect`` (a train step recomputes
    its forward under ``remat``; the deep pipeline's rolled-back steps
    launch too).  With ``snapshots`` (a dict) the snapshotter is active,
    wired to the run's Decision, and each save it queues is kept there by
    tag, its device clones and metadata, instead of written; with
    ``snapshots="write"`` it writes them, its background writer left to
    finish after the run (``flush_async`` waits for it).  Returns a record
    of the run."""
    from znicz_torch.core import prng
    from znicz_torch.core.mutable import Bool
    from znicz_torch.decision import DecisionGD
    from znicz_torch.parallel.fused import FusedTrainer

    prng.reset(SEED)
    loader.reset()
    wf.loader = loader
    load_start(torch, wf, start)
    for gd in wf.gds.values():
        gd.velocities = {}
    decision = DecisionGD(max_epochs=epochs, fail_iterations=0)
    if wf.decision in wf.units:
        # in the old one's place: a snapshot records the workflow's
        # Decision
        wf.units[wf.units.index(wf.decision)] = decision
        decision.workflow = wf
    wf.decision = decision
    snap = wf.snapshotter
    snap.__dict__.pop("save_async", None)
    if snapshots is None:
        snap.gate_skip = Bool(True)
    elif snapshots == "write":
        snap.gate_skip = ~wf.decision.epoch_ended
        snap._last_best_save_t = -1e18
        # no run's end waits for the writer: the caller drops this and
        # calls the real flush_async when it wants the file
        snap.flush_async = lambda: None
    else:
        snap.gate_skip = ~wf.decision.epoch_ended
        snap._last_best_save_t = -1e18

        def keep(state, tags, ready=None):
            if ready is not None:
                ready.synchronize()
            for t in tags:
                snapshots[t] = state

        snap.save_async = keep
    ctrs = counters()
    gc.collect()                  # an earlier run's captures let go
    with engine_knobs(**knobs):
        trainer = FusedTrainer(wf, mesh=mesh)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
            if hasattr(fn, "simple_launches"):
                fn.simple_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in ctrs.items()}
    simple = {name: fn.simple_launches for name, fn in ctrs.items()
              if getattr(fn, "simple_launches", 0)}
    st = trainer.stats
    n_train = st["train_steps"] + st["deep_discarded_train_steps"]
    n_eval = st["eval_steps"] + st["deep_discarded_eval_steps"]
    log(f"[{tag}:{label}] {card}: scan_chunk {trainer.scan_chunk}, "
        f"{n_train} train + {n_eval} eval steps, captured "
        f"{st['captured_steps']} / eager {st['eager_steps']} (warm-ups "
        f"{st['warmup_s']:.3f}s, captures {st['capture_s']:.3f}s of host "
        f"time), segments {dict(sorted(trainer.segments.items()))}; run() "
        f"{wall:.2f}s, "
        f"images/s={st['img_per_sec']:.1f} (after the first interval of "
        f"each kind {st['warm_img_per_sec']:.1f}); peak "
        f"{peak / 2**30:.3f} GiB allocated (from {base / 2**30:.3f} at "
        f"the start); launches={launches}")
    losses = list(trainer.train_losses)
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}:{label}] non-finite loss: {losses}")
    if simple:
        raise AssertionError(f"[{tag}:{label}] simple kernels: {simple}")
    if expect is not None:
        for name, fn in ctrs.items():
            per_train, per_eval = expect.get(name, (0, 0))
            if remat and name.endswith("_fwd"):
                per_train *= 2
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want:
                raise AssertionError(
                    f"[{tag}:{label}] {name}: {launches[name]} launches "
                    f"for {n_train} train + {n_eval} eval steps, expected "
                    f"{want}")
    return {"state": seg_state(trainer), "launches": launches,
            "stats": dict(st), "wall": wall, "peak": peak, "base": base,
            "trainer": trainer}


def seg_same(torch, label, a, b, what, tag="segments"):
    bad = seg_differences(torch, a["state"], b["state"])
    log(f"[{tag}:{label}] {what}: "
        + ("bit-equal: losses, weights, velocities, confusions" if not bad
           else f"DIFFER at {bad[:8]}"))
    if bad:
        raise AssertionError(f"[{tag}:{label}] {what} differ at {bad}")


def seg_alexnet(torch, card, tmp):
    """Phase 14's AlexNet runs: scan_chunk 8 (captured) against 1 in
    float32 and bf16 under ``fused``, remat, the host-staged uint8 run and
    the file-streamed run.  Returns {run: {kernel: launches}}."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from znicz_torch.loader.streaming import (HostArraySource,
                                              ImageFileSource,
                                              StreamingLoader)
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    t0 = time.perf_counter()
    n_valid, n_train = SEG_ROWS
    u8, labels = seg_textures(torch, n_valid + n_train)

    def resident(rows, initialize=True):
        ldr = StreamingLoader(source=HostArraySource(u8[:rows],
                                                     labels[:rows]),
                              class_lengths=[0, n_valid, rows - n_valid],
                              minibatch_size=BATCH,
                              device_budget_bytes=1 << 40)
        if initialize:
            ldr.initialize(device="cuda:0")
        return ldr

    main = resident(n_valid + n_train, initialize=False)   # the workflow's
    wf = no_snapshots(AlexNetWorkflow(
        sample_shape=(227, 227, 3), n_classes=1000, loader=main,
        decision_config={"max_epochs": SEG_EPOCHS, "fail_iterations": 0}))
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    log(f"[segments] AlexNet {n_train} + {n_valid} textures (uint8, "
        f"resident, decoded in the step), batch {BATCH}, {SEG_EPOCHS} "
        f"epochs; built in {time.perf_counter() - t0:.2f}s")
    runs, out = {}, {}
    for routing, (knobs, expect) in SEG_ROUTINGS.items():
        for chunk in (8, 1):
            label = f"{routing}:scan{chunk}"
            runs[label] = seg_run(torch, card, label, wf, start, main,
                                  {**knobs, "scan_chunk": chunk}, expect)
            del runs[label]["trainer"]
        a, b = runs[f"{routing}:scan8"], runs[f"{routing}:scan1"]
        if a["stats"]["captured_steps"] == 0 or \
                b["stats"]["captured_steps"] != 0:
            raise AssertionError(f"[segments:{routing}] captured steps "
                                 f"{a['stats']['captured_steps']} / "
                                 f"{b['stats']['captured_steps']}")
        seg_same(torch, routing, a, b, "captured scan_chunk 8 vs 1")
        if a["launches"] != b["launches"]:
            raise AssertionError(f"[segments:{routing}] launches differ: "
                                 f"{a['launches']} vs {b['launches']}")
        log(f"[segments:{routing}] {card}: images/s captured "
            f"{a['stats']['img_per_sec']:.1f} (warm "
            f"{a['stats']['warm_img_per_sec']:.1f}) vs step at a time "
            f"{b['stats']['img_per_sec']:.1f} (warm "
            f"{b['stats']['warm_img_per_sec']:.1f})")
    f32_knobs = SEG_ROUTINGS["f32"][0]
    # remat checkpoints each block (ROADMAP C.7): its peak below the run
    # without it, captured and step at a time, from the same start
    higher = []
    for chunk in (8, 1):
        label = f"f32:remat:scan{chunk}"
        runs[label] = seg_run(torch, card, label, wf, start, main,
                              {**f32_knobs, "remat": True,
                               "scan_chunk": chunk},
                              SEG_ROUTINGS["f32"][1], remat=True)
        del runs[label]["trainer"]
        plain = runs[f"f32:scan{chunk}"]
        seg_same(torch, label, runs[label], plain, "remat vs no remat")
        got, want = runs[label]["peak"], plain["peak"]
        log(f"[segments:{label}] {card}: max_memory_allocated "
            f"{got / 2**30:.3f} GiB with remat, {want / 2**30:.3f} GiB "
            f"without ({(got - want) / 2**30:+.3f} GiB; from "
            f"{runs[label]['base'] / 2**30:.3f} and "
            f"{plain['base'] / 2**30:.3f} GiB at their starts)")
        if got >= want:
            higher.append(f"{label}: {got} B, not below {want} B")
    if higher:
        raise AssertionError(f"[segments] remat's peak {higher}")
    # host-staged: the budget knob sends the same rows through pinned
    # segments, copied ahead on the copy stream
    with engine_knobs(stream_budget_mb=0):
        staged = StreamingLoader(source=HostArraySource(u8, labels),
                                 class_lengths=[0, n_valid, n_train],
                                 minibatch_size=BATCH)
        staged.initialize(device="cuda:0")
    if staged.device_resident:
        raise AssertionError("[segments:staged] the loader is resident")
    runs["f32:staged"] = seg_run(torch, card, "f32:staged", wf, start,
                                 staged, f32_knobs, SEG_ROUTINGS["f32"][1])
    t = runs["f32:staged"]["trainer"]
    log(f"[segments:f32:staged] {card}: staged segments "
        f"{t.stats['staged_segments']}, stager {t.stager_stats}, host "
        f"gathers {t.stats['stage_gather_s']:.3f}s, copies enqueued in "
        f"{t.stats['stage_copy_s']:.3f}s, device buffers written again "
        f"{t.staging_buffers.reused}")
    if not t.stats["staged_segments"] or not t.stager_stats["stage_hits"]:
        raise AssertionError("[segments:staged] nothing staged ahead")
    seg_same(torch, "f32:staged", runs["f32:staged"], runs["f32:scan8"],
             "host-staged vs resident")
    # image files through the decode pool against the same rows resident
    rows = sum(SEG_FILE_ROWS)
    paths = [os.path.join(tmp, f"{i:04d}.png") for i in range(rows)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: Image.fromarray(u8[i]).save(
            paths[i], compress_level=1), range(rows)))
    log(f"[segments:files] {rows} PNGs of 227x227 written in "
        f"{time.perf_counter() - t0:.2f}s")
    files = StreamingLoader(
        source=ImageFileSource(paths, labels[:rows], (227, 227)),
        class_lengths=[0, *SEG_FILE_ROWS], minibatch_size=BATCH,
        device_budget_bytes=0)
    files.initialize(device="cuda:0")
    runs["f32:files"] = seg_run(torch, card, "f32:files", wf, start, files,
                                f32_knobs, SEG_ROUTINGS["f32"][1], epochs=1)
    runs["f32:files_resident"] = seg_run(
        torch, card, "f32:files_resident", wf, start, resident(rows),
        f32_knobs, SEG_ROUTINGS["f32"][1], epochs=1)
    pool = files.ingest_stats
    log(f"[segments:files] {card}: decode pool "
        f"{files.source.pool().workers} workers, {pool}; images/s files "
        f"{runs['f32:files']['stats']['img_per_sec']:.1f} vs resident "
        f"{runs['f32:files_resident']['stats']['img_per_sec']:.1f}")
    if not pool["prefetch_hits"]:
        raise AssertionError("[segments:files] no prefetched row")
    seg_same(torch, "f32:files", runs["f32:files"],
             runs["f32:files_resident"], "PNG files vs the rows resident")
    wf.loader = main
    for label, run in runs.items():
        out[label] = run["launches"]
    del runs, wf, main, staged, files
    torch.cuda.empty_cache()
    return out


def seg_snapshot_differences(a, b):
    bad = []
    for group in ("units", "velocities"):
        for name, leaves in a[group].items():
            for k, x in leaves.items():
                if not np.array_equal(x, b[group][name][k]):
                    bad.append(f"{group}:{name}.{k}")
    for key in ("epoch_number", "samples_served", "last_minibatch"):
        if a["loader"][key] != b["loader"][key]:
            bad.append(f"loader:{key}")
    if not np.array_equal(a["loader"]["shuffled_indices"],
                          b["loader"]["shuffled_indices"]):
        bad.append("loader:shuffled_indices")
    if repr(a["prng"]) != repr(b["prng"]):
        bad.append("prng")
    for key in ("epoch", "metric", "decision"):
        if a[key] != b[key]:
            bad.append(key)
    return bad


def seg_cifar(torch, card, tmp):
    """CIFAR10 at its defaults under ``pallas_lrn`` + ``fused_tail``:
    scan_chunk 8 (captured, snapshots in the background) against 1, and
    against scan_chunk 8 with in-line snapshots."""
    from znicz_torch.core import prng
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import Snapshotter

    ctrs = counters()
    expect = ANCHOR_RUNS["cifar:pallas_lrn"][3]
    runs, out = {}, {}
    for label, knobs in (("scan8", {"scan_chunk": 8}),
                         ("scan1", {"scan_chunk": 1}),
                         ("scan8:sync", {"scan_chunk": 8,
                                         "async_snapshot": False})):
        with engine_knobs(**SEG_CIFAR_KNOBS, **knobs):
            prng.reset(ANCHOR_SEED)
            wf = sample_workflow("cifar")
            wf.snapshotter.directory = os.path.join(tmp, label)
            trainer = FusedTrainer(wf)
            for fn in ctrs.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        d, st = wf.decision, trainer.stats
        launches = {name: fn.launches for name, fn in ctrs.items()}
        n_train, n_eval = st["train_steps"], st["eval_steps"]
        for name in ctrs:
            per_train, per_eval = expect.get(name, (0, 0))
            if launches[name] != per_train * n_train + per_eval * n_eval:
                raise AssertionError(
                    f"[segments:cifar:{label}] {name}: {launches[name]} "
                    f"launches for {n_train} + {n_eval} steps")
        finals = {"final_train_loss": d.epoch_metrics[2]["loss"],
                  "valid_err_pct": d.epoch_metrics[1]["err_pct"]}
        bands = {m: abs(finals[m] - c) <= h
                 for m, (c, h) in ANCHOR_BANDS[1].items()}
        log(f"[segments:cifar:{label}] {card}: {json.dumps(finals)} in "
            f"band {bands}; {n_train} train + {n_eval} eval steps, captured "
            f"{st['captured_steps']} / eager {st['eager_steps']} (warm-ups "
            f"{st['warmup_s']:.3f}s, captures {st['capture_s']:.3f}s); run() "
            f"{wall:.2f}s, images/s={st['img_per_sec']:.1f} (warm "
            f"{st['warm_img_per_sec']:.1f}); async saves "
            f"{wf.snapshotter.async_saves_written}; launches={launches}")
        fatal = [m for m, ok in bands.items()
                 if not ok and ("cifar", m) not in DRIFTS]
        if fatal:
            raise AssertionError(f"[segments:cifar:{label}] outside "
                                 f"ANCHOR_BANDS[1]: {fatal}")
        runs[label] = {"state": seg_state(trainer), "stats": dict(st),
                       "snap": Snapshotter.load(wf.snapshotter.destination),
                       "async": wf.snapshotter.async_saves_written}
        out[f"cifar:{label}"] = launches
        del wf, trainer
    if not runs["scan8"]["stats"]["captured_steps"]:
        raise AssertionError("[segments:cifar] nothing captured")
    seg_same(torch, "cifar", runs["scan8"], runs["scan1"],
             "captured scan_chunk 8 vs 1")
    if not runs["scan8"]["async"] or runs["scan8:sync"]["async"]:
        raise AssertionError("[segments:cifar] async saves "
                             f"{runs['scan8']['async']} / "
                             f"{runs['scan8:sync']['async']}")
    bad = seg_snapshot_differences(runs["scan8"]["snap"],
                                   runs["scan8:sync"]["snap"])
    log("[segments:cifar] the async snapshot vs the in-line one: "
        + ("arrays, loader, prng streams, epoch and metric equal"
           if not bad else f"DIFFER at {bad}"))
    if bad:
        raise AssertionError(f"[segments:cifar] snapshots differ: {bad}")
    torch.cuda.empty_cache()
    return out


def seg_stochastic(torch, card):
    """Phase 12's stochastic pooling net at scan_chunk 8 (uncaptured by
    the rule) against 1, the default Philox sampler on the card."""
    from znicz_torch.parallel.fused import FusedTrainer

    runs = {}
    for chunk in (8, 1):
        with engine_knobs(scan_chunk=chunk):
            wf = stochastic_workflow(None)
            trainer = FusedTrainer(wf)
            trainer.run()
            torch.cuda.synchronize()
        st = trainer.stats
        log(f"[segments:stochastic:scan{chunk}] {card}: captured "
            f"{st['captured_steps']} / eager {st['eager_steps']} "
            f"(uncaptured: {trainer.uncaptured_reason}); segments "
            f"{dict(sorted(trainer.segments.items()))}")
        if st["captured_steps"] or not trainer.uncaptured_reason:
            raise AssertionError("[segments:stochastic] a capture")
        runs[chunk] = {"state": seg_state(trainer)}
    seg_same(torch, "stochastic", runs[8], runs[1], "scan_chunk 8 vs 1")


def segments_phase(torch, card):
    """Phase 14.  Returns {run: {kernel: launches}}."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_segments_")
    try:
        out = seg_alexnet(torch, card, tmp)
        out.update(seg_cifar(torch, card, tmp))
        seg_stochastic(torch, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 15: the deep pipeline ---------------------------------------------

#: phase 15's AlexNet: phase 14's textures, epochs, the deep run's depth
DEEP_EPOCHS, DEEP_DEPTH = 5, 2
#: the rollback: CIFAR10 under pallas_lrn + fused_tail at a rate so small
#: that validation stops improving, found up to 2 * depth epochs late
DEEP_CIFAR = {"learning_rate": 1e-4, "decision.fail_iterations": 2,
              "decision.max_epochs": 50}
DEEP_CIFAR_DEPTH = 4


def deep_extra(trainer):
    """What a run leaves besides ``seg_state``: the Decision's epoch and
    best, ``steps_done``, the loader's position and order, the
    ``lr_adjust`` iteration."""
    d, ldr = trainer.decision, trainer.loader
    lr = trainer.lr_adjust
    return {"epoch_number": int(d.epoch_number),
            "best_metric": float(d.best_metric),
            "steps_done": trainer.steps_done,
            "loader": (int(ldr.epoch_number), int(ldr.samples_served),
                       int(ldr._pos), bool(ldr.last_minibatch)),
            "order": np.array(ldr._shuffled_indices),
            "lr_iteration": None if lr is None else lr.iteration}


def deep_extra_differences(a, b):
    return [k for k in a if not (np.array_equal(a[k], b[k]) if k == "order"
                                 else a[k] == b[k])]


def deep_log(card, label, trainer):
    st = trainer.stats
    log(f"[deep:{label}] {card}: pipeline_depth {trainer.pipeline_depth}, "
        f"epochs queued {st['deep_epochs']}, flushed "
        f"{st['deep_flushes']}, pulls {st['deep_pulls']}, most in flight "
        f"{st['deep_inflight_max']}, rollbacks {st['deep_rollbacks']} "
        f"(discarded {st['deep_discarded_train_steps']} train + "
        f"{st['deep_discarded_eval_steps']} eval steps); {st['train_steps']} "
        f"train + {st['eval_steps']} eval steps kept, captured "
        f"{st['captured_steps']} / eager {st['eager_steps']}; images/s "
        f"{st['img_per_sec']:.1f} (warm {st['warm_img_per_sec']:.1f})")


def host_snapshot(state):
    """A queued snapshot with its device leaves copied to the host, as
    the background writer copies them."""
    return {**state, **{group: {name: {k: v.cpu().numpy()
                                       for k, v in leaves.items()}
                                for name, leaves in state[group].items()}
                        for group in ("units", "velocities")}}


def deep_alexnet(torch, card):
    """Phase 15's AlexNet runs: ``fused`` in float32 and bf16, 5 epochs at
    pipeline_depth 2 against 1 (scan_chunk 8), the float32 runs with an
    active snapshotter whose queued saves are compared.  Returns {run:
    {kernel: launches}}."""
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    t0 = time.perf_counter()
    n_valid, n_train = SEG_ROWS
    u8, labels = seg_textures(torch, n_valid + n_train)
    main = StreamingLoader(source=HostArraySource(u8, labels),
                           class_lengths=[0, n_valid, n_train],
                           minibatch_size=BATCH, device_budget_bytes=1 << 40)
    wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000,
                         loader=main,
                         decision_config={"max_epochs": DEEP_EPOCHS,
                                          "fail_iterations": 0})
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    log(f"[deep] AlexNet {n_train} + {n_valid} textures (uint8, resident), "
        f"batch {BATCH}, {DEEP_EPOCHS} epochs, pipeline_depth {DEEP_DEPTH} "
        f"against 1; built in {time.perf_counter() - t0:.2f}s")
    out = {}
    for routing in ("f32", "bf16"):
        knobs, expect = SEG_ROUTINGS[routing]
        # one epoch first, so that neither timed run pays the process's
        # first cuDNN plans and allocations
        seg_run(torch, card, f"{routing}:warm-up", wf, start, main,
                {**knobs, "scan_chunk": 8}, expect, epochs=1, tag="deep")
        runs = {}
        for depth in (DEEP_DEPTH, 1):
            label = f"{routing}:depth{depth}"
            snaps = {} if routing == "f32" else None
            run = seg_run(torch, card, label, wf, start, main,
                          {**knobs, "scan_chunk": 8,
                           "pipeline_depth": depth},
                          expect, epochs=DEEP_EPOCHS, tag="deep",
                          snapshots=snaps)
            trainer = run.pop("trainer")
            deep_log(card, label, trainer)
            run.update(extra=deep_extra(trainer), snaps=snaps)
            if (trainer.stats["deep_epochs"] != 0) != (depth > 1):
                raise AssertionError(f"[deep:{label}] the deep pipeline "
                                     f"ran: {trainer.stats['deep_epochs']}")
            runs[depth] = run
            out[label] = run["launches"]
            del trainer
        deep, seg = runs[DEEP_DEPTH], runs[1]
        seg_same(torch, routing, deep, seg, f"pipeline_depth {DEEP_DEPTH} "
                 "vs 1", tag="deep")
        bad = deep_extra_differences(deep["extra"], seg["extra"])
        log(f"[deep:{routing}] epoch, best metric, steps_done, loader, "
            f"lr_adjust: " + ("equal" if not bad else f"DIFFER at {bad}")
            + f" ({deep['extra']['epoch_number']}, "
            f"{deep['extra']['best_metric']}, {deep['extra']['steps_done']}, "
            f"{deep['extra']['loader']})")
        if bad:
            raise AssertionError(f"[deep:{routing}] differ at {bad}")
        if deep["launches"] != seg["launches"]:
            raise AssertionError(f"[deep:{routing}] launches differ: "
                                 f"{deep['launches']} vs {seg['launches']}")
        log(f"[deep:{routing}] {card}: images/s depth {DEEP_DEPTH} "
            f"{deep['stats']['img_per_sec']:.1f} (warm "
            f"{deep['stats']['warm_img_per_sec']:.1f}) vs 1 "
            f"{seg['stats']['img_per_sec']:.1f} (warm "
            f"{seg['stats']['warm_img_per_sec']:.1f}); max_memory_allocated "
            f"{deep['peak'] / 2**30:.3f} vs {seg['peak'] / 2**30:.3f} GiB")
        if routing == "f32":
            # (c) the best snapshot each run queued
            a, b = deep["snaps"].get("best"), seg["snaps"].get("best")
            if a is None or b is None:
                raise AssertionError("[deep:snapshot] no best snapshot")
            bad = seg_snapshot_differences(host_snapshot(a),
                                           host_snapshot(b))
            log(f"[deep:snapshot] best of epoch {a['epoch']} at depth "
                f"{DEEP_DEPTH} vs 1: " + (
                    "arrays bit-equal; loader, prng streams and Decision "
                    "equal" if not bad else f"DIFFER at {bad}"))
            if bad:
                raise AssertionError(f"[deep:snapshot] differ at {bad}")
        del runs, deep, seg
    wf.snapshotter.__dict__.pop("save_async", None)
    del wf, main, start
    torch.cuda.empty_cache()
    return out


class cifar_config:
    """Set ``root.cifar`` keys (dotted below it) within a ``with`` block
    and put the old values back after it."""

    def __init__(self, values):
        self.values, self.saved = values, []

    def __enter__(self):
        from znicz_torch.core.config import root

        for key, val in self.values.items():
            self.saved.append((key, root.cifar.get_by_path(key)))
            root.cifar.set_by_path(key, val)

    def __exit__(self, *exc):
        from znicz_torch.core.config import root

        for key, old in reversed(self.saved):
            root.cifar.set_by_path(key, old)


def deep_cifar(torch, card, tmp):
    """(b) CIFAR10 under ``pallas_lrn`` + ``fused_tail`` at a rate that
    fail-stops: pipeline_depth 4 (the stop found late, rolled back)
    against the segmented run, bit for bit; the launches of every queued
    step counted, the rolled-back ones too."""
    from znicz_torch.core import prng
    from znicz_torch.parallel.fused import FusedTrainer

    ctrs = counters()
    expect = ANCHOR_RUNS["cifar:pallas_lrn"][3]
    runs, out = {}, {}
    for depth in (DEEP_CIFAR_DEPTH, 1):
        label = f"cifar:depth{depth}"
        with engine_knobs(**SEG_CIFAR_KNOBS, scan_chunk=8,
                          pipeline_depth=depth), cifar_config(DEEP_CIFAR):
            prng.reset(ANCHOR_SEED)
            wf = sample_workflow("cifar")
            wf.snapshotter.directory = os.path.join(tmp, label)
            trainer = FusedTrainer(wf)
            for fn in ctrs.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = trainer.stats
        launches = {name: fn.launches for name, fn in ctrs.items()}
        n_train = st["train_steps"] + st["deep_discarded_train_steps"]
        n_eval = st["eval_steps"] + st["deep_discarded_eval_steps"]
        for name in ctrs:
            per_train, per_eval = expect.get(name, (0, 0))
            if launches[name] != per_train * n_train + per_eval * n_eval:
                raise AssertionError(
                    f"[deep:{label}] {name}: {launches[name]} launches for "
                    f"{n_train} + {n_eval} queued steps")
        losses = list(trainer.train_losses)
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"[deep:{label}] non-finite loss")
        log(f"[deep:{label}] {card}: stopped at epoch "
            f"{wf.decision.epoch_number} of {wf.decision.max_epochs} "
            f"(fail_iterations {wf.decision.fail_iterations}); run() "
            f"{wall:.2f}s; launches={launches}")
        deep_log(card, label, trainer)
        runs[depth] = {"state": seg_state(trainer),
                       "extra": deep_extra(trainer), "stats": dict(st)}
        out[label] = launches
        del wf, trainer
    deep, seg = runs[DEEP_CIFAR_DEPTH], runs[1]
    if deep["stats"]["deep_rollbacks"] != 1 or \
            deep["extra"]["epoch_number"] + 1 >= 50:
        raise AssertionError(f"[deep:cifar] rollbacks "
                             f"{deep['stats']['deep_rollbacks']}, stopped at "
                             f"epoch {deep['extra']['epoch_number']}")
    seg_same(torch, "cifar", deep, seg, f"pipeline_depth {DEEP_CIFAR_DEPTH} "
             "(rolled back) vs 1", tag="deep")
    bad = deep_extra_differences(deep["extra"], seg["extra"])
    log(f"[deep:cifar] epoch, best metric, steps_done, loader, lr_adjust: "
        + ("equal" if not bad else f"DIFFER at {bad}")
        + f" ({deep['extra']['epoch_number']}, "
        f"{deep['extra']['steps_done']}, {deep['extra']['loader']}, "
        f"{deep['extra']['lr_iteration']})")
    if bad:
        raise AssertionError(f"[deep:cifar] differ at {bad}")
    for key in ("train_steps", "eval_steps", "images"):
        if deep["stats"][key] != seg["stats"][key]:
            raise AssertionError(f"[deep:cifar] {key} differ")
    torch.cuda.empty_cache()
    return out


def deep_phase(torch, card):
    """Phase 15.  Returns {run: {kernel: launches}}."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deep_")
    try:
        out = deep_alexnet(torch, card)
        out.update(deep_cifar(torch, card, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 16: the fused trainer on a mesh of ranks ----------------------------

#: phase 16's ranks (gloo, all on the one card) and the longest the parent
#: waits for them
SHARD_WORLD, SHARD_JOIN_S = 2, 420
#: label -> (mesh (data, model), pipeline_depth, epochs, writes its best
#: snapshot); run in this order in each rank
SHARD_RUNS = {"model": ((1, 2), 1, SEG_EPOCHS, True),
              "data": ((2, 1), 1, SEG_EPOCHS, False),
              "deep2": ((2, 1), 2, 3, False),
              "deep1": ((2, 1), 1, 3, False)}
#: the cross-layout band (tests/test_shard_training.py:165-170)
SHARD_LOSS_RTOL, SHARD_RTOL, SHARD_ATOL = 1e-3, 2e-3, 2e-5
#: a whole meshed run against one process's: its weights' and
#: velocities' drift (largest difference, and share of what the run moved
#: them) at most this many times the yardstick's, and its confusions and
#: error counts at most this many times as many samples off, plus
#: SHARD_SAMPLES (the yardstick: one process from a start 1 ulp away)
SHARD_DRIFT_FACTOR, SHARD_SAMPLES = 2.0, 2
#: C.5's closing check: the short run is the largest count of train
#: steps up to this one at which the 1-ulp nudged run stays in the band
SHARD_SHORT_MAX = 20
#: K1/K1b/K2/K2b at the rows a rank of mesh (2, 1) gives them
SHARD_KERNEL_SHAPES = {
    "fused_block_fwd": KERNELS["fused_block_fwd"][2],
    "fused_block_bwd": KERNELS["fused_block_bwd"][2],
    "bias_relu_fwd": {k: BIAS_RELU_LAYERS[k]
                      for k in ("conv3", "conv4", "conv5")},
    "bias_relu_bwd": {k: BIAS_RELU_LAYERS[k]
                      for k in ("conv3", "conv4", "conv5")}}
#: the column-sharded layers of AlexNet, and their whole shapes
SHARD_FC = {"fwd_all2all_strict_relu_10": (4096, 9216),
            "fwd_all2all_strict_relu_12": (4096, 4096)}
#: the gradient buffer's bytes: AlexNet's 62.4 M float32 parameters
SHARD_GRAD_FLOATS = 62_378_344


def shard_state(torch, wf):
    """(losses, {leaf: whole tensor on the card}, per-class confusions,
    per-class error counts) of a run: parameters and velocities gathered
    whole (a collective on a mesh)."""
    from znicz_torch.snapshotter import collect

    snap = collect(wf, device_copies=True)
    leaves = {f"{group}:{name}.{k}": t for group in ("units", "velocities")
              for name, tree in snap[group].items() for k, t in tree.items()}
    d = wf.decision
    return (list(d.train_losses), leaves,
            [None if m is None or m.get("confusion") is None
             else m["confusion"].cpu().numpy().tolist()
             for m in d.epoch_metrics],
            [None if m is None else m.get("err_pct")
             for m in d.epoch_metrics])


def shard_drift(torch, got, want, start):
    """(max |w - w1|, the leaves outside the cross-layout band, the
    largest of max |w - w1| / max |w1 - w0| over the parameters: the
    meshed run's distance from the one-process run as a share of what
    that run moved them) of whole leaves ``got`` against ``want``, both
    from ``start``."""
    worst, out, share = 0.0, [], 0.0
    for key, w in want.items():
        diff = (got[key].double() - w.double()).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > SHARD_ATOL + SHARD_RTOL * w.double().abs()).any()):
            out.append(key)
        if key in start:
            moved = float((w.double() - start[key].double()).abs().max())
            share = max(share, float(diff.max()) / max(moved, 1e-30))
    return worst, out, share


def shard_samples_off(got, want) -> int:
    """The samples by which two runs' metrics differ: the larger of the
    confusions' moves (half the sum of |a - b| over the cells of every
    class) and the error counts' difference in any class.  ``got`` and
    ``want`` are :func:`shard_state`'s (confusions, error percentages)."""
    (cg, eg), (cw, ew) = got, want
    sizes = (0,) + tuple(SEG_ROWS)              # test, valid, train
    moved = 0
    for a, b in zip(cg, cw):
        if (a is None) != (b is None):
            return 1 << 30
        if a is not None:
            moved = max(moved, int(np.abs(np.array(a) - np.array(b)).sum())
                        // 2)
    for n, pa, pb in zip(sizes, eg, ew):
        if (pa is None) != (pb is None):
            return 1 << 30
        if pa is not None:
            moved = max(moved, round(abs(pa - pb) * n / 100))
    return moved


def shard_band(torch, got, want, start):
    """(max relative loss error, the first steps' relative loss errors,
    :func:`shard_drift`, :func:`shard_samples_off`, the two runs'
    per-class error percentages) of a meshed run ``got`` against the
    one-process run ``want``."""
    lg, wg, cg, eg = got
    lw, ww, cw, ew = want
    errs = np.abs(np.array(lg) - lw) / np.abs(lw)
    return (float(errs.max()), [float(e) for e in errs[:4]],
            shard_drift(torch, wg, ww, start),
            shard_samples_off((cg, eg), (cw, ew)), [eg, ew])


def shard_steps(torch, wf, start, n, mesh=None, each=None):
    """``n`` train steps (``FusedTrainer.train_step``) of ``wf`` (on
    ``mesh``) from ``start``, step s on the TRAIN minibatches in order
    with step s's masks: each step's (loss, error count, confusion);
    ``each(s, that step's triple)`` is called after step s."""
    from znicz_torch.core import prng
    from znicz_torch.parallel.fused import FusedTrainer

    prng.reset(SEED)
    load_start(torch, wf, start)
    for gd in wf.gds.values():
        gd.velocities = {}
    out = []
    with engine_knobs(**SEG_ROUTINGS["f32"][0]):
        trainer = FusedTrainer(wf, mesh=mesh)
        for step in range(n):
            row0 = SEG_ROWS[0] + step % (SEG_ROWS[1] // BATCH) * BATCH
            loss, n_err, conf = trainer.train_step(
                np.arange(row0, row0 + BATCH), BATCH, step)
            out.append((float(loss), int(n_err),
                        conf.cpu().numpy().tolist()))
            if each is not None:
                each(step, out[-1])
    return out


def shard_step(torch, wf, start, mesh=None):
    """One train step (:func:`shard_steps`): (its loss, its error count
    and confusion, the whole leaves after it)."""
    (loss, n_err, conf), = shard_steps(torch, wf, start, 1, mesh)
    return loss, n_err, conf, shard_state(torch, wf)[1]


def shard_in_band(torch, got, want, leaves, want_leaves, w0):
    """(loss error, leaves outside the cross-layout band, error count and
    confusion equal) of a train step's (loss, n_err, confusion) ``got``
    and the whole ``leaves`` after it, against ``want`` and
    ``want_leaves``."""
    _, outside, _ = shard_drift(torch, leaves, want_leaves, w0)
    return (abs(got[0] - want[0]) / abs(want[0]), outside,
            tuple(got[1:]) == tuple(want[1:]))


def shard_short_n(torch, wf, start, nudged, w0):
    """C.5's closing check, its length: one process from ``start`` and
    from ``nudged`` (1 ulp away) for ``SHARD_SHORT_MAX`` train steps;
    N is the largest count whose every step of the nudged run stayed in
    the band (loss within ``SHARD_LOSS_RTOL``, weights and velocities
    within ``SHARD_RTOL`` / ``SHARD_ATOL``, error count and confusion
    equal).  Returns (N, the one-process run's first N steps, its whole
    leaves after step N on the host, the nudged run's per-step (loss
    error, leaves outside, metrics equal))."""
    states = []
    ref = shard_steps(torch, wf, start, SHARD_SHORT_MAX,
                      each=lambda s, m: states.append(
                          shard_state(torch, wf)[1]))
    marks = []
    shard_steps(torch, wf, nudged, SHARD_SHORT_MAX,
                each=lambda s, m: marks.append(shard_in_band(
                    torch, m, ref[s], shard_state(torch, wf)[1], states[s],
                    w0)))
    n = 0
    for loss_err, outside, equal in marks:
        if loss_err > SHARD_LOSS_RTOL or outside or not equal:
            break
        n += 1
    leaves = {} if n == 0 else {k: t.cpu() for k, t in states[n - 1].items()}
    return n, ref[:n], leaves, [(e, len(o), q) for e, o, q in marks]


def start_leaves(start) -> dict:
    """``start``'s parameters keyed as :func:`shard_state`'s leaves."""
    return {f"units:{name}.{k}": t for name, leaves in start.items()
            for k, t in leaves.items()}


def shard_digest(torch, leaves) -> dict:
    """A SHA-256 of each leaf's bytes: equal digests are equal bits."""
    import hashlib

    return {k: hashlib.sha256(t.contiguous().view(-1).view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()
            for k, t in leaves.items()}


def gloo_cuda_collectives(torch) -> dict:
    """Which collectives this build's gloo takes on CUDA tensors: "ok"
    or the error's first line."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    probes = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(8, device=dev)),
        "broadcast": lambda: dist.broadcast(torch.ones(8, device=dev), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(8, device=dev) for _ in range(world)],
            torch.ones(8, device=dev)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), torch.ones(8, device=dev)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8, device=dev), torch.ones(8 * world, device=dev)),
        "reduce": lambda: dist.reduce(torch.ones(8, device=dev), 0)}
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:          # a refusal is the finding
            out[name] = f"{type(exc).__name__}: " + \
                (str(exc).splitlines() or [""])[0][:160]
    return out


def shard_rank(rank, world, store, tmp, card):
    """One rank of phase 16 (a spawned process): joins the gloo group on
    the card, probes gloo's CUDA collectives and times the gradient
    buffer's sum, then runs ``SHARD_RUNS`` on phase 14's AlexNet from the
    parent's start and holds each to the parent's one-process run.
    Writes its results to ``tmp/rank<N>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader
    from znicz_torch.parallel import mesh as mesh_mod
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    mesh_mod.distributed_init(f"file://{store}", world, rank,
                              backend="gloo")
    out = {"rank": rank, "device": str(torch.device(
        "cuda", torch.cuda.current_device())),
        "gloo_cuda": gloo_cuda_collectives(torch)}
    group = torch.distributed.group.WORLD
    buf = torch.ones(SHARD_GRAD_FLOATS, device="cuda")
    out["allreduce_s"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        mesh_mod.all_reduce_(buf, group)
        out["allreduce_s"].append(time.perf_counter() - t0)
    del buf
    ref = torch.load(os.path.join(tmp, "ref.pt"))
    start = {n: {k: t.cuda() for k, t in leaves.items()}
             for n, leaves in ref["start"].items()}
    losses, leaves, confusions, errors = ref["single"]
    one = (losses, {k: t.cuda() for k, t in leaves.items()}, confusions,
           errors)
    step_loss, step_err, step_conf, step_leaves = ref["step"]
    step_leaves = {k: t.cuda() for k, t in step_leaves.items()}
    del ref, leaves
    w0 = start_leaves(start)
    n_valid, n_train = SEG_ROWS
    u8, labels = seg_textures(torch, n_valid + n_train)
    main = StreamingLoader(source=HostArraySource(u8, labels),
                           class_lengths=[0, n_valid, n_train],
                           minibatch_size=BATCH, device_budget_bytes=1 << 40)
    prng.reset(SEED)
    wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000,
                         loader=main, decision_config={
                             "max_epochs": SEG_EPOCHS, "fail_iterations": 0})
    snapdir = os.path.join(tmp, f"snapshots{rank}")
    root.common.dirs.snapshots = snapdir
    wf.snapshotter.directory = snapdir
    # one best save (the first epoch's): a full-width one is 0.5 GB of gzip
    wf.snapshotter.min_save_interval_s = 3600.0
    knobs, expect = SEG_ROUTINGS["f32"]
    states, runs = {}, {}
    # one step on each mesh against one process's
    out["step"] = {}
    for label, (shape, _, _, _) in list(SHARD_RUNS.items())[:2]:
        loss, n_err, conf, leaves = shard_step(
            torch, wf, start, mesh_mod.make_mesh(shape, ("data", "model")))
        out["step"][label] = (abs(loss - step_loss) / abs(step_loss),
                              shard_drift(torch, leaves, step_leaves, w0),
                              n_err == step_err and conf == step_conf)
        del leaves
    # C.5's closing check: the meshes over the short run, step by step
    short = torch.load(os.path.join(tmp, "short.pt"))
    short_leaves = {k: t.cuda() for k, t in short["leaves"].items()}
    out["short"] = {}
    for label, (shape, _, _, _) in list(SHARD_RUNS.items())[:2]:
        got = shard_steps(torch, wf, start, short["n"],
                          mesh_mod.make_mesh(shape, ("data", "model")))
        worst, outside, share = shard_drift(
            torch, shard_state(torch, wf)[1], short_leaves, w0)
        out["short"][label] = (
            max(abs(g[0] - w[0]) / abs(w[0])
                for g, w in zip(got, short["steps"])),
            all(tuple(g[1:]) == tuple(w[1:])
                for g, w in zip(got, short["steps"])),
            worst, outside, share)
    del short, short_leaves
    for label, (shape, depth, epochs, write) in SHARD_RUNS.items():
        mesh = mesh_mod.make_mesh(shape, ("data", "model"))
        run = seg_run(torch, card, f"{label}:rank{rank}", wf, start, main,
                      {**knobs, "scan_chunk": 8, "pipeline_depth": depth},
                      expect, epochs=epochs, tag="shard",
                      snapshots="write" if write else None, mesh=mesh)
        trainer = run.pop("trainer")
        state = shard_state(torch, wf)
        st = trainer.stats
        rec = {"mesh": trainer.mesh_shape, "depth": depth, "epochs": epochs,
               "launches": run["launches"], "peak": run["peak"],
               "wall": run["wall"], "losses": state[0],
               "confusions": state[2], "err_pct": state[3],
               "digest": shard_digest(torch, state[1]),
               "steps_done": trainer.steps_done,
               "uncaptured": trainer.uncaptured_reason,
               "rows": trainer._local_idx(np.zeros((1, BATCH))).shape[1],
               "shapes": {n: list(trainer._params_of(f)["weights"].shape)
                          for f in trainer._weighted()
                          for n in [f.name] if n in SHARD_FC},
               "stats": {k: st[k] for k in (
                   "train_steps", "eval_steps", "eager_steps",
                   "captured_steps", "img_per_sec", "warm_img_per_sec",
                   "wall_s", "collectives", "collective_bytes",
                   "collective_s", "deep_epochs", "deep_pulls")}}
        if epochs == SEG_EPOCHS:
            rec["band"] = shard_band(torch, state, one, w0)
        if label == "deep2":
            states[label] = state
        elif label == "deep1":
            a = states.pop("deep2")
            rec["deep_equal"] = (a[0] == state[0] and a[2] == state[2] and
                                 all(torch.equal(a[1][k], state[1][k])
                                     for k in state[1]))
            rec["deep_steps"] = runs["deep2"]["steps_done"]
        runs[label] = rec
        del trainer, state
        torch.cuda.empty_cache()
    # the model run's best save, written in the background meanwhile
    t0 = time.perf_counter()
    wf.snapshotter.__dict__.pop("flush_async", None)
    wf.snapshotter.flush_async()
    out["snapshot_wait_s"] = time.perf_counter() - t0
    out["snapshot_files"] = sorted(os.listdir(snapdir)) \
        if os.path.isdir(snapdir) else []
    out["snapshots_written"] = wf.snapshotter.async_saves_written
    out["destination"] = wf.snapshotter.destination
    out["runs"] = runs
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def shard_phase(torch, card, rows):
    """Phase 16: K1/K1b/K2/K2b at a rank's 64-row shapes against their
    plain versions (their rows under ``"shard"`` in ``rows``); the
    one-process runs the meshes are held to, on the card; then
    ``SHARD_WORLD`` gloo ranks spawned over a ``FileStore``, all on
    ``cuda:0``, each running ``SHARD_RUNS``; the ranks' results checked
    and printed, and the best snapshot rank 0 wrote loaded into a
    one-process trainer.  Returns {run: {kernel: launches}} (rank 0's)."""
    import multiprocessing as mp

    from znicz_torch.core import prng
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.snapshotter import Snapshotter, restore

    cifar_rows(torch, rows, SHARD_KERNEL_SHAPES, tag="shard",
               batch=BATCH // 2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        t0 = time.perf_counter()
        n_valid, n_train = SEG_ROWS
        u8, labels = seg_textures(torch, n_valid + n_train)
        main = StreamingLoader(source=HostArraySource(u8, labels),
                               class_lengths=[0, n_valid, n_train],
                               minibatch_size=BATCH,
                               device_budget_bytes=1 << 40)
        prng.reset(SEED)
        wf = no_snapshots(AlexNetWorkflow(
            sample_shape=(227, 227, 3), n_classes=1000, loader=main,
            decision_config={"max_epochs": SEG_EPOCHS,
                             "fail_iterations": 0}))
        start = {f.name: {k: p.detach().clone()
                          for k, p in FusedTrainer._params_of(f).items()}
                 for f in wf.forwards if f.has_weights}
        knobs, expect = SEG_ROUTINGS["f32"]
        step_loss, step_err, step_conf, step_leaves = shard_step(
            torch, wf, start)
        # the one-process run (2 epochs, captured) that the data and the
        # model runs are held to
        one = seg_run(torch, card, "one-process", wf, start, main,
                      {**knobs, "scan_chunk": 8}, expect, tag="shard")
        state = shard_state(torch, wf)
        single = (state[0], {k: t.cpu() for k, t in state[1].items()},
                  state[2], state[3])
        torch.save({"start": {n: {k: t.cpu() for k, t in leaves.items()}
                              for n, leaves in start.items()},
                    "single": single,
                    "step": (step_loss, step_err, step_conf,
                             {k: t.cpu() for k, t in step_leaves.items()})},
                   os.path.join(tmp, "ref.pt"))
        del step_leaves
        # the yardstick of the run's sensitivity: one process again from
        # a start one ulp away in a single weight
        w0 = start_leaves(start)
        nudged = {n: dict(leaves) for n, leaves in start.items()}
        first = next(iter(nudged))
        w = nudged[first]["weights"].clone()
        w.view(-1)[0] = torch.nextafter(w.view(-1)[0],
                                        torch.tensor(np.inf, device=w.device))
        nudged[first]["weights"] = w
        seg_run(torch, card, "one-process-nudged", wf, nudged, main,
                {**knobs, "scan_chunk": 8}, expect, tag="shard")
        nudge = shard_state(torch, wf)
        loss_err = float(np.max(np.abs(np.array(nudge[0]) - single[0])
                                / np.abs(single[0])))
        worst, outside, share = shard_drift(
            torch, nudge[1], {k: t.cuda() for k, t in single[1].items()},
            w0)
        samples = shard_samples_off(nudge[2:], single[2:])
        yard = (worst, share, samples)
        log(f"[shard:yardstick] one process from a start 1 ulp away in "
            f"{first}.weights[0]: losses within {loss_err:.3g}, weights "
            f"and velocities within {worst:.3g}, at most {share:.3g} of "
            f"what the run moved them ({len(outside)} leaves outside the "
            f"band {SHARD_RTOL} / {SHARD_ATOL}), confusions and errors "
            f"{samples} sample(s) off")
        del nudge
        # C.5's closing check: the longest run the nudge itself keeps in
        # the band, found before any mesh is compared
        t1 = time.perf_counter()
        short_n, short_ref, short_leaves, marks = shard_short_n(
            torch, wf, start, nudged, w0)
        log(f"[shard:short] one process against itself 1 ulp away, "
            f"train step by train step (loss error, leaves outside the "
            f"band, error count and confusion equal): "
            + ", ".join(f"{i + 1}: ({e:.2g}, {o}, {q})"
                        for i, (e, o, q) in enumerate(marks))
            + f"; N = {short_n} of at most {SHARD_SHORT_MAX} "
            f"({time.perf_counter() - t1:.2f}s)")
        if short_n == 0:
            raise AssertionError("[shard:short] the nudged run leaves the "
                                 "band at its first step")
        torch.save({"n": short_n, "steps": short_ref,
                    "leaves": short_leaves},
                   os.path.join(tmp, "short.pt"))
        del nudged, w0, short_leaves
        log(f"[shard:one-process] {card}: AlexNet f32 `fused` "
            f"{SEG_EPOCHS} epochs, batch {BATCH}, mesh None: "
            f"{one['wall']:.2f}s, images/s {one['stats']['img_per_sec']:.1f}"
            f" (warm {one['stats']['warm_img_per_sec']:.1f}), peak "
            f"{one['peak'] / 2**30:.3f} GiB; references written in "
            f"{time.perf_counter() - t0:.2f}s")
        del one, state
        torch.cuda.empty_cache()
        # the ranks
        t1 = time.perf_counter()
        store = os.path.join(tmp, "store")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=shard_rank,
                             args=(rank, SHARD_WORLD, store, tmp, card))
                 for rank in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_JOIN_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * SHARD_WORLD:
            raise AssertionError(f"[shard] ranks exited {codes}")
        ranks = []
        for rank in range(SHARD_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        log(f"[shard] {SHARD_WORLD} gloo ranks on {ranks[0]['device']} "
            f"(FileStore), spawned and joined in "
            f"{time.perf_counter() - t1:.2f}s")
        log(f"[shard:gloo] CUDA tensors: " + ", ".join(
            f"{k} {v}" for k, v in ranks[0]["gloo_cuda"].items()))
        for r in ranks:
            log(f"[shard:gloo] rank {r['rank']}: all_reduce of "
                f"{SHARD_GRAD_FLOATS} float32 on the card ("
                f"{SHARD_GRAD_FLOATS * 4 / 1e6:.1f} MB): " + ", ".join(
                    f"{t:.3f}s" for t in r["allreduce_s"]))
        bad = []
        out = {}
        for label in SHARD_RUNS:
            recs = [r["runs"][label] for r in ranks]
            for rec, r in zip(recs, ranks):
                st = rec["stats"]
                log(f"[shard:{label}] {card} rank {r['rank']}: mesh "
                    f"{rec['mesh']}, pipeline_depth {rec['depth']}, "
                    f"{rec['rows']} rows a step, {st['train_steps']} train "
                    f"+ {st['eval_steps']} eval steps (eager "
                    f"{st['eager_steps']}, captured {st['captured_steps']}); "
                    f"run() {rec['wall']:.2f}s, images/s "
                    f"{st['img_per_sec']:.1f} (warm "
                    f"{st['warm_img_per_sec']:.1f}); collectives "
                    f"{st['collectives']} moving "
                    f"{st['collective_bytes'] / 1e9:.3f} GB in "
                    f"{st['collective_s']:.2f}s of {st['wall_s']:.2f}s of "
                    f"steps; peak {rec['peak'] / 2**30:.3f} GiB allocated; "
                    f"fc6/fc7 held as {rec['shapes']}; "
                    f"launches={rec['launches']}")
                if rec["uncaptured"] is None or st["captured_steps"]:
                    bad.append(f"{label}: captured")
            differ = sorted({k for r in recs[1:] for k in r["digest"]
                             if r["digest"][k] != recs[0]["digest"][k]})
            if any(r["losses"] != recs[0]["losses"] or
                   r["confusions"] != recs[0]["confusions"]
                   for r in recs[1:]):
                differ.append("metrics")
            log(f"[shard:{label}] ranks' weights, velocities, losses and "
                f"confusions: " + ("bit-equal" if not differ
                                   else f"DIFFER at {differ[:4]}"))
            if differ:
                bad.append(f"{label}: ranks differ at {differ[:4]}")
            rec = recs[0]
            if label in ranks[0]["step"]:
                loss_err, (worst, outside, share), metrics_equal = \
                    ranks[0]["step"][label]
                log(f"[shard:{label}] one train step against one "
                    f"process's: loss within {loss_err:.3g}, error count "
                    f"and confusion " + ("equal" if metrics_equal
                                         else "DIFFER")
                    + f", weights and velocities within {worst:.3g} "
                    f"({len(outside)} leaves outside the band {SHARD_RTOL} "
                    f"/ {SHARD_ATOL}), at most {share:.3g} of the step's "
                    f"own update")
                if loss_err > SHARD_LOSS_RTOL or outside or \
                        not metrics_equal:
                    bad.append(f"{label}: one step {outside[:4]}")
            if label in ranks[0]["short"]:
                loss_err, equal, worst, outside, share = \
                    ranks[0]["short"][label]
                log(f"[shard:{label}] the short run (C.5), {short_n} train "
                    f"steps against one process's: losses within "
                    f"{loss_err:.3g} (rtol {SHARD_LOSS_RTOL}), error counts "
                    f"and confusions " + ("equal at every step" if equal
                                          else "DIFFER")
                    + f", weights and velocities within {worst:.3g} "
                    f"({len(outside)} leaves outside the band {SHARD_RTOL} "
                    f"/ {SHARD_ATOL}: {outside[:3]}), at most {share:.3g} of "
                    f"what the run moved them")
                if loss_err > SHARD_LOSS_RTOL or outside or not equal:
                    bad.append(f"{label}: the short run leaves the band")
            if "band" in rec:
                loss_err, first, (worst, outside, share), samples, \
                    errors = rec["band"]
                # a one-ulp difference drifts as far over the run as the
                # cross-layout band (ROADMAP C.5), so the whole run's
                # weights and metrics are held to the yardstick's drift
                limits = (SHARD_DRIFT_FACTOR * yard[0],
                          SHARD_DRIFT_FACTOR * yard[1],
                          int(SHARD_DRIFT_FACTOR * yard[2]) + SHARD_SAMPLES)
                log(f"[shard:{label}] against one process: losses within "
                    f"{loss_err:.3g} (rtol {SHARD_LOSS_RTOL}; first steps "
                    f"{', '.join(f'{e:.2g}' for e in first)}); after the "
                    f"run weights and velocities within {worst:.3g} "
                    f"(limit {limits[0]:.3g}), at most {share:.3g} of what "
                    f"the run moved them (limit {limits[1]:.3g}; band "
                    f"{SHARD_RTOL} / {SHARD_ATOL}: {len(outside)} leaves "
                    f"outside: {outside[:3]}), confusions and errors "
                    f"{samples} sample(s) off (limit {limits[2]}; err % by "
                    f"class {errors[0]} against {errors[1]})")
                if loss_err > SHARD_LOSS_RTOL:
                    bad.append(f"{label}: losses")
                if worst > limits[0] or share > limits[1] or \
                        samples > limits[2]:
                    bad.append(f"{label}: the run drifts past the "
                               f"yardstick's {SHARD_DRIFT_FACTOR}x")
            n_train = rec["stats"]["train_steps"]
            n_eval = rec["stats"]["eval_steps"]
            for name, (per_train, per_eval) in expect.items():
                want = per_train * n_train + per_eval * n_eval
                if any(r["launches"][name] != want for r in recs):
                    bad.append(f"{label}: {name} launches")
            if rec["rows"] != BATCH // rec["mesh"]["data"]:
                bad.append(f"{label}: {rec['rows']} rows a rank")
            mp_ = rec["mesh"]["model"]
            for name, (rows, cols) in SHARD_FC.items():
                if rec["shapes"][name] != [rows // mp_, cols]:
                    bad.append(f"{label}: {name} held as "
                               f"{rec['shapes'][name]}")
            out[label] = rec["launches"]
        deep1 = [r["runs"]["deep1"] for r in ranks]
        ok = all(r["deep_equal"] and r["deep_steps"] == r["steps_done"]
                 for r in deep1) and all(
            r["runs"]["deep2"]["stats"]["deep_epochs"] == 3 and
            r["runs"]["deep1"]["stats"]["deep_epochs"] == 0 for r in ranks)
        log(f"[shard:deep] mesh (2, 1), pipeline_depth 2 against 1, 3 "
            f"epochs: losses, weights, velocities, confusions, steps_done "
            + ("bit-equal" if ok else "DIFFER") + " on every rank")
        if not ok:
            bad.append("deep: differ")
        # the best snapshot of the model run: rank 0's file alone
        files = [r["snapshot_files"] for r in ranks]
        dest = [r["destination"] for r in ranks]
        log(f"[shard:snapshot] files by rank {files}, written "
            f"{[r['snapshots_written'] for r in ranks]}, rank 0 waited "
            f"{ranks[0]['snapshot_wait_s']:.2f}s for its writer at the end; "
            f"destinations {[os.path.basename(d or '') for d in dest]}")
        if files[0] != [os.path.basename(dest[0] or "")] or \
                any(files[1:]) or len({os.path.basename(d or "")
                                       for d in dest}) != 1:
            bad.append(f"snapshot files {files}")
        t2 = time.perf_counter()
        snap = Snapshotter.load(dest[0])
        shapes = {n: snap["units"][n]["weights"].shape for n in SHARD_FC}
        restore(wf, snap)
        restored = all(np.array_equal(
            FusedTrainer._params_of(f)[k].detach().cpu().numpy(),
            snap["units"][f.name][k])
            for f in wf.forwards if f.has_weights
            for k in FusedTrainer._params_of(f))
        log(f"[shard:snapshot] rank 0's best (epoch {snap['epoch']}) holds "
            f"{shapes}; loaded into a one-process trainer in "
            f"{time.perf_counter() - t2:.2f}s: "
            + ("every parameter the file's" if restored else "DIFFERS"))
        if not restored or any(shapes[n] != SHARD_FC[n] for n in SHARD_FC):
            bad.append("snapshot restore")
        if bad:
            raise AssertionError(f"[shard] {bad}")
        del wf, main, start, single, snap
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 17: the mesh that trains and saves, the mesh that restores, the
#: epochs trained, and the passes of phase 3's requests served around the
#: swap (one before it, one while it runs, one after the flip, one after
#: the rollback)
SNAP_SAVE_MESH, SNAP_RESTORE_MESH, SNAP_EPOCHS = (1, 2), (2, 1), 1


def snapshot_digests(torch, wf):
    """:func:`shard_digest` of ``wf``'s whole parameters and velocities
    (gathered: a collective on a mesh)."""
    return shard_digest(torch, shard_state(torch, wf)[1])


def snapshots_rank(rank, world, store, tmp, card):
    """One rank of phase 17 (a spawned process): full-width AlexNet under
    ``fused`` trains on mesh ``SNAP_SAVE_MESH`` and saves a sharded
    orbax snapshot into ``tmp/alexnet_p17.orbax`` (every rank its rows);
    a fresh trainer on ``SNAP_RESTORE_MESH`` restores it with
    ``restore_sharded``.  Writes the whole leaves' digests of both, the
    save's and the restore's seconds and the launches to
    ``tmp/rank<N>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from znicz_torch.core import prng
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader
    from znicz_torch.parallel import mesh as mesh_mod
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    mesh_mod.distributed_init(f"file://{store}", world, rank,
                              backend="gloo")
    n_valid, n_train = SEG_ROWS
    u8, labels = seg_textures(torch, n_valid + n_train)
    main = StreamingLoader(source=HostArraySource(u8, labels),
                           class_lengths=[0, n_valid, n_train],
                           minibatch_size=BATCH, device_budget_bytes=1 << 40)
    prng.reset(SEED)
    wf = no_snapshots(AlexNetWorkflow(
        sample_shape=(227, 227, 3), n_classes=1000, loader=main,
        decision_config={"max_epochs": SNAP_EPOCHS, "fail_iterations": 0}))
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    knobs, expect = SEG_ROUTINGS["f32"]
    run = seg_run(torch, card, f"train:rank{rank}", wf, start, main,
                  {**knobs, "scan_chunk": 8},
                  expect, epochs=SNAP_EPOCHS, tag="snapshots",
                  mesh=mesh_mod.make_mesh(SNAP_SAVE_MESH, ("data", "model")))
    trainer = run.pop("trainer")
    out = {"rank": rank, "launches": run["launches"],
           "stats": {k: trainer.stats[k] for k in ("train_steps",
                                                   "eval_steps")},
           "shapes": {n: list(trainer._params_of(f)["weights"].shape)
                      for f in trainer._weighted()
                      for n in [f.name] if n in SHARD_FC}}
    snap = wf.snapshotter
    snap.directory, snap.prefix = tmp, "alexnet"
    snap.format, snap.sharded = "orbax", True
    out["save_s"] = []
    for _ in range(2):              # the first in a process, then again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["path"] = snap.save("p17")
        out["save_s"].append(time.perf_counter() - t0)
    out["saved"] = snapshot_digests(torch, wf)
    del trainer
    # a fresh trainer on the other mesh shape: the modules whole again
    load_start(torch, wf, start)
    for gd in wf.gds.values():
        gd.velocities = {}
    restorer = FusedTrainer(wf, mesh=mesh_mod.make_mesh(SNAP_RESTORE_MESH,
                                                        ("data", "model")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = restorer.restore_sharded(out["path"])
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["restored"] = snapshot_digests(torch, wf)
    out["epoch"] = meta["epoch"]
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def snapshots_phase(torch, card):
    """Phase 17: the sharded snapshot and the served swap at full width.
    ``SHARD_WORLD`` gloo ranks on the card train AlexNet on mesh (1, 2)
    and save a sharded orbax snapshot, which they restore on (2, 1), and
    this process restores on one device: every restored leaf bit-equal to
    the saving run's whole arrays.  Then an ``InferenceServer`` under
    ``fused`` serves phase 3's requests in four passes: generation 1
    (random weights), a pass while ``swap_async`` moves it to the
    snapshot, one after the flip, one after ``rollback``; every reply
    within ``SERVE_TOL`` of the composed forward of the generation
    stamped on it.  Returns {path: {kernel: launches}}."""
    import multiprocessing as mp

    from znicz_torch.core import prng
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer
    from znicz_torch.serving.model import ModelRunner

    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshots_")
    try:
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=snapshots_rank,
                             args=(rank, SHARD_WORLD, store, tmp, card))
                 for rank in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_JOIN_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * SHARD_WORLD:
            raise AssertionError(f"[snapshots] ranks exited {codes}")
        ranks = []
        for rank in range(SHARD_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        path = ranks[0]["path"]
        size = sum(os.path.getsize(os.path.join(d, name))
                   for d, _, names in os.walk(path) for name in names)
        files = sorted(os.listdir(os.path.join(path, "arrays")))
        bad = []
        expect = SEG_ROUTINGS["f32"][1]
        for r in ranks:
            n_train, n_eval = (r["stats"]["train_steps"],
                               r["stats"]["eval_steps"])
            log(f"[snapshots:rank{r['rank']}] {card}: AlexNet f32 `fused` "
                f"on mesh {SNAP_SAVE_MESH}, {n_train} train + {n_eval} eval "
                f"steps, fc6/fc7 held as {r['shapes']}; sharded orbax save "
                f"{r['save_s'][0]:.3f}s (the process's first), "
                f"{r['save_s'][1]:.3f}s (again); restored on mesh "
                f"{SNAP_RESTORE_MESH} in {r['restore_s']:.3f}s (epoch "
                f"{r['epoch']}); launches={r['launches']}")
            for name, (per_train, per_eval) in expect.items():
                if r["launches"][name] != per_train * n_train \
                        + per_eval * n_eval:
                    bad.append(f"rank {r['rank']}: {name} launches")
            if r["restored"] != r["saved"] or r["saved"] != ranks[0]["saved"]:
                bad.append(f"rank {r['rank']}: restored leaves differ")
        log(f"[snapshots] {os.path.basename(path)}: {size / 1e6:.1f} MB on "
            f"disk, arrays/ {files}; ranks spawned, trained, saved and "
            f"restored in {time.perf_counter() - t0:.2f}s; on mesh "
            f"{SNAP_RESTORE_MESH} every leaf "
            + ("bit-equal to the saving run's whole arrays"
               if not bad else "DIFFERS"))
        # one process restores the same directory
        n_valid, n_train = SEG_ROWS
        u8, labels = seg_textures(torch, n_valid + n_train)
        prng.reset(SEED)
        wf = no_snapshots(AlexNetWorkflow(
            sample_shape=(227, 227, 3), n_classes=1000,
            loader=StreamingLoader(source=HostArraySource(u8, labels),
                                   class_lengths=[0, n_valid, n_train],
                                   minibatch_size=BATCH,
                                   device_budget_bytes=1 << 40),
            decision_config={"max_epochs": SNAP_EPOCHS,
                             "fail_iterations": 0}))
        del u8, labels
        restorer, restore_s = FusedTrainer(wf), []
        for _ in range(2):          # the first in this process, then again
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            meta = restorer.restore_sharded(path)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t1)
        one = snapshot_digests(torch, wf)
        same = one == ranks[0]["saved"]
        log(f"[snapshots:one-process] {card}: restore_sharded "
            f"{restore_s[0]:.3f}s (the process's first), {restore_s[1]:.3f}s "
            f"(again) (epoch {meta['epoch']}): every leaf "
            + ("bit-equal to the saving run's" if same else "DIFFERS"))
        if not same:
            bad.append("one process: restored leaves differ")
        # the served swap: generation 1 is a fresh random AlexNet
        requests = make_requests()
        prng.reset(SEED + 1)
        served = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000)
        refs = {1: [ModelRunner(served, capture=False).infer(x)
                    for x in requests],
                2: [ModelRunner(wf, capture=False).infer(x)
                    for x in requests]}
        del wf
        ctrs = {name: fn for name, fn in counters().items()
                if name in ("fused_block_fwd", "bias_relu_fwd")}
        with engine_knobs(**FUSED_KNOBS):
            srv = InferenceServer(served, max_batch=BATCH, max_delay_ms=5.0,
                                  queue_bound=4096).start()
            for fn in ctrs.values():           # the main path starts here
                fn.launches = 0
            srv.runner.dispatches = 0
            stamps = []

            def serve_pass():
                futures = [Future() for _ in requests]
                for i, x in enumerate(requests):
                    srv.submit(Request(x, x.shape[0], reply_to=futures[i],
                                       req_id=i))
                return [f.result(timeout=600) for f in futures]

            passes = {"before": serve_pass()}
            t1 = time.perf_counter()
            swap = srv.swap_async(path)
            passes["during"] = serve_pass()
            swap.join(600)
            swap_s = time.perf_counter() - t1
            st = srv.stats()
            passes["after"] = serve_pass()
            rolled = srv.runner.rollback()
            passes["rolled_back"] = serve_pass()
            launches = {name: fn.launches for name, fn in ctrs.items()}
            dispatches = srv.runner.dispatches
            stats = srv.stats()
            srv.stop()
        if srv.error is not None:
            raise RuntimeError("[snapshots] compute loop died") \
                from srv.error
        worst = {1: 0.0, 2: 0.0}
        for label, got in passes.items():
            for i, rep in enumerate(got):
                if not rep["ok"]:
                    raise AssertionError(f"[snapshots:{label}] request {i}: "
                                         f"{rep}")
                ref = refs[rep["gen"]][i]
                if rep["y"].shape != ref.shape or \
                        not np.isfinite(rep["y"]).all():
                    raise AssertionError(f"[snapshots:{label}] request {i}: "
                                         f"shape or non-finite")
                worst[rep["gen"]] = max(worst[rep["gen"]], float(
                    np.abs(rep["y"] - ref).max()
                    / max(np.abs(ref).max(), 1e-30)))
            stamps.append(sorted({rep["gen"] for rep in got}))
        log(f"[snapshots:serve] {card}: swap_async to the snapshot "
            f"{swap_s:.3f}s (load, warm of {len(srv.batcher.ladder.rungs)} "
            f"rungs, flip) while a pass was served; generations by pass "
            f"{dict(zip(passes, stamps))}; rollback to {rolled}; replies "
            f"vs the composed forward of their generation: max|d|/max|ref| "
            f"{worst[1]:.3e} (gen 1), {worst[2]:.3e} (gen 2) (tol "
            f"{SERVE_TOL:g}); {dispatches} dispatches, launches={launches};"
            f" swaps {stats['swaps']}, failures {stats['swap_failures']}, "
            f"rollbacks {stats['rollbacks']}")
        if stamps[0] != [1] or stamps[2] != [2] or stamps[3] != [1] or \
                st["generation"] != 2 or rolled != 1:
            bad.append(f"generations {stamps}, {st['generation']}, {rolled}")
        if max(worst.values()) > SERVE_TOL:
            bad.append(f"replies disagree: {worst}")
        if stats["swaps"] != 1 or stats["swap_failures"] or \
                stats["rollbacks"] != 1:
            bad.append(f"swap counts {stats}")
        per = {"fused_block_fwd": 2, "bias_relu_fwd": 3}
        for name, n in per.items():
            if launches[name] != n * dispatches or not dispatches:
                bad.append(f"serve: {name} {launches[name]} launches for "
                           f"{dispatches} dispatches")
        if bad:
            raise AssertionError(f"[snapshots] {bad}")
        out = {"train": ranks[0]["launches"], "serve": launches}
        del served, refs, passes
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 18: routing -> (knobs, {kernel: launches per dispatch})
ZMQ_ROUTINGS = {
    "fused": ({"fused_elementwise": True, "fused_tail": True},
              {"fused_block_fwd": 2, "bias_relu_fwd": 3, "lrn_fwd": 0}),
    "pallas_lrn": ({"pallas_lrn": True, "fused_tail": True},
                   {"fused_block_fwd": 0, "bias_relu_fwd": 5, "lrn_fwd": 2}),
}
#: phase 18: ZMQ clients and the requests each keeps in flight
ZMQ_CLIENTS, ZMQ_IN_FLIGHT = 4, 8
#: phase 18: the ``--serve`` subprocess's requests and its time limit (s):
#: start, the snapshot's load, the warm of 8 rungs, 16 replies, exit
CLI_REQUESTS, CLI_TIMEOUT_S = 16, 600


def quantiles(lat_s) -> str:
    a = np.asarray(lat_s) * 1e3
    return (f"p50_ms={np.percentile(a, 50):.2f} "
            f"p99_ms={np.percentile(a, 99):.2f}")


def zmq_clients(endpoint, requests, assignment=None, client_ids=None,
                in_flight=ZMQ_IN_FLIGHT):
    """``requests`` over ZMQ from InferenceClients, one a thread: client
    c sends the requests ``assignment[c]`` lists (default: request i from
    client i % ``ZMQ_CLIENTS``), each keeping up to ``in_flight`` out.
    Returns (replies in request order, each request's submit-to-reply
    seconds on the client's clock, wall s)."""
    from znicz_torch.serving import InferenceClient

    if assignment is None:
        assignment = [list(range(c, len(requests), ZMQ_CLIENTS))
                      for c in range(ZMQ_CLIENTS)]
    replies = [None] * len(requests)
    lat = [None] * len(requests)
    errors = []

    def run(tid):
        try:
            cli = InferenceClient(
                endpoint, timeout=600, resend_after_s=600,
                client_id=None if client_ids is None else client_ids[tid])
            try:
                todo = list(assignment[tid])
                sent = {}
                while todo or sent:
                    while todo and len(sent) < in_flight:
                        i = todo.pop(0)
                        sent[cli.submit(requests[i])] = (
                            i, time.perf_counter())
                    for rep in cli.collect(0.05):
                        i, t0 = sent.pop(rep["req_id"])
                        lat[i] = time.perf_counter() - t0
                        replies[i] = rep
            finally:
                cli.close()
        except Exception as exc:       # raised in the caller below
            errors.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(t,))
               for t in range(len(assignment))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    sent = sorted(i for a in assignment for i in a)
    if any(t.is_alive() for t in threads) or \
            any(replies[i] is None for i in sent):
        raise AssertionError("a ZMQ client did not finish")
    return replies, lat, wall


def zmq_routing(torch, card, label, wf, requests, refs):
    """One routing of phase 18 (its knobs set by the caller): an
    ``InferenceServer`` bound to ``tcp://127.0.0.1:*`` serves ``requests``
    in process (phase 3's drive: 4 threads, Futures) and then over ZMQ
    (``zmq_clients``), each pass's replies within ``SERVE_TOL`` of
    ``refs`` and its launches checked per dispatch.  Returns (the server,
    still running; {kernel: ZMQ-pass launches})."""
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    expect = ZMQ_ROUTINGS[label][1]
    ctrs = {name: fn for name, fn in counters().items() if name in expect}
    srv = InferenceServer(wf, bind="tcp://127.0.0.1:*", max_batch=BATCH,
                          max_delay_ms=5.0, queue_bound=4096,
                          request_ttl_s=600.0)
    t0 = time.perf_counter()
    srv.start()
    log(f"[zmq:{label}] serving at {srv.endpoint}; warmup of "
        f"{len(srv.batcher.ladder.rungs)} rungs "
        f"{time.perf_counter() - t0:.2f}s")
    rows = sum(x.shape[0] for x in requests)
    out = {}
    for how in ("in-process", "zmq"):
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        srv.runner.dispatches = 0
        with srv._lock:
            srv._latencies.clear()
        bytes_in, bytes_out = srv.codec.bytes_in, srv.codec.bytes_out
        if how == "zmq":
            replies, lat, wall = zmq_clients(srv.endpoint, requests)
        else:
            futures = [Future() for _ in requests]

            def client(tid):
                for i in range(tid, len(requests), 4):
                    srv.submit(Request(requests[i], requests[i].shape[0],
                                       reply_to=futures[i], req_id=i))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            replies = [f.result(timeout=600) for f in futures]
            wall = time.perf_counter() - t0
            lat = None
        launches = {name: fn.launches for name, fn in ctrs.items()}
        dispatches = srv.runner.dispatches
        bad = [r for r in replies if not r["ok"]]
        if bad:
            raise AssertionError(f"[zmq:{label}:{how}] {len(bad)} refused "
                                 f"replies: {bad[0]}")
        check_replies(f"zmq:{label}:{how}", replies, refs)
        for name, per in expect.items():
            if launches[name] != per * dispatches or not dispatches:
                raise AssertionError(
                    f"[zmq:{label}:{how}] {name}: {launches[name]} launches "
                    f"for {dispatches} dispatches, expected {per} each")
        server = srv.latency_quantiles()
        log(f"[zmq:{label}:{how}] {card}: {len(requests)} requests, {rows} "
            f"images in {wall:.3f}s: images/s={rows / wall:.1f}; "
            + (f"client clock {quantiles(lat)}; " if lat else "")
            + f"server clock p50_ms={server['p50_ms']:.2f} "
            f"p99_ms={server['p99_ms']:.2f}; {dispatches} dispatches, "
            f"launches={launches}; wire bytes in "
            f"{srv.codec.bytes_in - bytes_in}, out "
            f"{srv.codec.bytes_out - bytes_out}")
        out[how] = launches
    return srv, out["zmq"]


def zmq_admission(torch, card, srv, requests, refs, path, refs2):
    """Phase 18's admission, robustness and control steps on the running
    ``fused`` server: a rate limit that one flooding client crosses,
    ``deadline_ms=0``, a garbage frame, ping and stats, and a swap to the
    snapshot at ``path`` and the rollback, each reply within
    ``SERVE_TOL`` of its generation's composed forward (``refs``,
    ``refs2``)."""
    import zmq

    from znicz_torch.parallel import wire
    from znicz_torch.serving import AdmissionPolicy, InferenceClient

    # a burst of 128 rows a client, nothing refilled within the phase
    # (1e-3 rows/s): the flooding client sends all 64 requests (~530
    # rows), the other three 4 requests each (at most 64 rows)
    srv.batcher.set_admission(AdmissionPolicy(rate_limit=1e-3,
                                              rate_burst=128.0))
    n = len(requests)
    assignment = [list(range(n)), list(range(4)), list(range(4, 8)),
                  list(range(8, 12))]
    ids = ["flood", "good-1", "good-2", "good-3"]
    flood_reps, _, wall = zmq_clients(srv.endpoint, requests,
                                      assignment[:1], ids[:1])
    others, _, _ = zmq_clients(srv.endpoint, requests, assignment[1:],
                               ids[1:])
    others = others[:12]
    refused = [r for r in flood_reps if not r["ok"]]
    if not refused or {r.get("policy") for r in refused} != {"rate_limited"}:
        raise AssertionError(f"[zmq:admission] the flooding client's "
                             f"refusals: {[r.get('policy') for r in refused]}")
    if any(not r["ok"] for r in others):
        raise AssertionError("[zmq:admission] a client within its rate was "
                             "refused")
    check_replies("zmq:admission", others, refs[:12])
    served = [(r, ref) for r, ref in zip(flood_reps, refs) if r["ok"]]
    check_replies("zmq:admission flood", *zip(*served))
    adm = srv.batcher.admission_stats()
    log(f"[zmq:admission] {card}: flood {len(served)} served, "
        f"{len(refused)} rate_limited in {wall:.3f}s; the other 3 clients "
        f"{len(others)} served; clients "
        f"{ {k: v['rate_limited'] for k, v in adm['clients'].items()} }")
    srv.batcher.set_admission(AdmissionPolicy())
    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(srv.endpoint)
    cli = InferenceClient(srv.endpoint, timeout=600, resend_after_s=600)
    try:
        def ask(frames):
            sock.send_multipart(frames)
            if not sock.poll(600_000):
                raise AssertionError("[zmq:control] no reply")
            raw = sock.recv_multipart()
            return wire.decode_message(wire.split_envelope(raw)[1]
                                       or raw)[0]

        rep = ask([b""] + wire.encode_message(
            {"cmd": "infer", "req_id": 1, "x": requests[0],
             "deadline_ms": 0})[0])
        if rep.get("policy") != "deadline" or not rep.get("timed_out"):
            raise AssertionError(f"[zmq:control] deadline 0: {rep}")
        before = srv.bad_frames
        rep = ask([b"\xff garbage \x00"])
        if not rep.get("bad_frame") or srv.bad_frames != before + 1:
            raise AssertionError(f"[zmq:control] garbage frame: {rep}")
        check_replies("zmq:after-garbage", [cli.result(cli.submit(
            requests[1]))], refs[1:2])
        if not cli.ping()["pong"]:
            raise AssertionError("[zmq:control] ping")
        st = cli.stats()
        if st["bad_frames"] != srv.bad_frames or st["generation"] != 1:
            raise AssertionError(f"[zmq:control] stats {st}")
        t0 = time.perf_counter()
        ack = cli.swap(path)
        while cli.stats()["generation"] != 2:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("[zmq:control] the swap did not flip")
            time.sleep(0.05)
        swap_s = time.perf_counter() - t0
        gen2 = [cli.result(cli.submit(x)) for x in requests[:8]]
        back = cli.rollback()
        gen1 = [cli.result(cli.submit(x)) for x in requests[:8]]
        if not ack["swap_started"] or back["generation"] != 1 or \
                {r["gen"] for r in gen2} != {2} or \
                {r["gen"] for r in gen1} != {1}:
            raise AssertionError(f"[zmq:control] generations: {ack}, "
                                 f"{back}")
        check_replies("zmq:swap gen 2", gen2, refs2[:8])
        check_replies("zmq:rollback gen 1", gen1, refs[:8])
        st = cli.stats()
        log(f"[zmq:control] {card}: deadline 0 refused at ingress; garbage "
            f"frame answered (bad_frames {st['bad_frames']}); ping, stats; "
            f"swap over the wire flipped in {swap_s:.3f}s, rollback to "
            f"{back['generation']}; timed_out {st['timed_out']}, rejected "
            f"{st['rejected']}, expired_results {st['expired_results']}")
    finally:
        cli.close()
        sock.close(0)


class ServingProcess:
    """``python -m znicz_torch ... --serve`` in a subprocess from the repo's
    root: its output read on threads, ``endpoint`` taken from its
    ``serving <sample> at EP`` line (``up`` s after the start).  Raises
    when the line does not come within ``timeout``; :meth:`finish` waits
    for the exit and raises unless it is 0; :meth:`kill` ends it."""

    def __init__(self, cmd, sample: str, label: str, timeout: float):
        import queue as queue_mod

        self.label, self.t0 = label, time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.DEVNULL, text=True)
        self.lines: "queue_mod.Queue" = queue_mod.Queue()
        self.err: list = []
        self.reader = threading.Thread(
            target=lambda: [self.lines.put(ln) for ln in self.proc.stdout],
            daemon=True)
        threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                         daemon=True).start()
        self.reader.start()
        try:
            try:
                self.line = self.lines.get(timeout=timeout)
            except queue_mod.Empty:
                raise AssertionError(f"[{label}] no serving line") from None
            if not self.line.startswith(f"serving {sample} at "
                                        f"tcp://127.0.0.1:"):
                self.proc.wait(60)
                raise AssertionError(f"[{label}] {self.line!r}; stderr: "
                                     f"{''.join(self.err)[-3000:]}")
        except BaseException:
            self.kill()
            raise
        self.endpoint = self.line.split(" at ")[1].split()[0]
        self.up = time.perf_counter() - self.t0

    def finish(self, timeout: float) -> str:
        """Wait for the exit (raising unless 0); returns its last line."""
        rc = self.proc.wait(timeout)
        self.reader.join(60)
        tail = []
        while not self.lines.empty():
            tail.append(self.lines.get())
        if rc != 0:
            raise AssertionError(f"[{self.label}] exit {rc}; stderr: "
                                 f"{''.join(self.err)[-3000:]}")
        return tail[-1].strip() if tail else ""

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)


def zmq_cli(torch, card, path, requests, refs2):
    """Phase 18's real entry point: ``python -m znicz_torch alexnet --serve
    tcp://127.0.0.1:* --snapshot path`` on the card under ``fused``; the
    endpoint read from its output, ``CLI_REQUESTS`` requests, each reply
    within ``SERVE_TOL`` of the snapshot's composed forward; exit 0 within
    ``CLI_TIMEOUT_S``."""
    cmd = [sys.executable, "-m", "znicz_torch", "alexnet", "--serve",
           "tcp://127.0.0.1:*", "--snapshot", path, "--replica-id", "cli",
           "root.alexnet.loader.n_classes=1000",
           "root.common.engine.fused_elementwise=True",
           "root.common.engine.fused_tail=True",
           f"root.common.serving.max_batch={BATCH}",
           f"root.common.serving.max_requests={CLI_REQUESTS}"]
    served = ServingProcess(cmd, "alexnet", "zmq:cli", CLI_TIMEOUT_S)
    try:
        reqs = requests[:CLI_REQUESTS]
        replies, lat, wall = zmq_clients(served.endpoint, reqs)
        if any(not r["ok"] or r["replica_id"] != "cli" for r in replies):
            raise AssertionError(f"[zmq:cli] refusals: {replies[0]}")
        check_replies("zmq:cli", replies, refs2[:CLI_REQUESTS])
        last = served.finish(CLI_TIMEOUT_S)
        rows = sum(x.shape[0] for x in reqs)
        log(f"[zmq:cli] {card}: up in {served.up:.2f}s "
            f"({served.line.strip()}); {len(reqs)} requests, {rows} images "
            f"in {wall:.3f}s (images/s={rows / wall:.1f}, client clock "
            f"{quantiles(lat)}); exit 0 "
            f"{time.perf_counter() - served.t0:.2f}s after the start; "
            f"{last}")
    finally:
        served.kill()


def zmq_phase(torch, card):
    """Phase 18: full-width AlexNet (phase 3's configuration) served over
    ZMQ.  Under ``fused`` and under ``pallas_lrn``: an ``InferenceServer``
    on ``tcp://127.0.0.1:*`` serves phase 3's 64 requests in process and
    then from ``ZMQ_CLIENTS`` InferenceClients with ``ZMQ_IN_FLIGHT`` in
    flight each, every reply within ``SERVE_TOL`` of the composed
    forward, K1/K2 2/3 (K3/K2 2/5) launches a dispatch, images/s and
    p50/p99 on both clocks and the wire bytes printed.  Then, on the
    ``fused`` server: admission (``zmq_admission``) and the swap to a
    host snapshot this phase saves and the rollback; then the ``--serve``
    subprocess from that snapshot (``zmq_cli``).  Returns {path: {kernel:
    launches}}."""
    from znicz_torch.core import prng
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.snapshotter import write_host_pickle

    tmp = tempfile.mkdtemp(prefix="chip_smoke_zmq_")
    out = {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        prng.reset(SEED)
        wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000)
        with torch.no_grad():
            for f in wf.forwards:
                if f.bias is not None:
                    f.bias.normal_(0.0, 0.05, generator=gen)
        requests = make_requests()
        runner = ModelRunner(wf, capture=False)
        refs = [runner.infer(x) for x in requests]
        # the second generation: every leaf moved, saved uncompressed
        rng = np.random.default_rng(SEED + 1)
        tree = {name: {k: (0.5 * t.cpu().numpy() + 0.01 * rng.standard_normal(
            tuple(t.shape), dtype=np.float32)).astype(np.float32)
            for k, t in leaves.items()}
            for name, leaves in runner._active[0].items()}
        path = os.path.join(tmp, "alexnet_gen2.pickle")
        t0 = time.perf_counter()
        write_host_pickle(path, {"units": tree, "velocities": {},
                                 "epoch": 2}, compression="none")
        log(f"[zmq] snapshot of generation 2 written in "
            f"{time.perf_counter() - t0:.2f}s "
            f"({os.path.getsize(path) / 2**20:.1f} MiB)")
        del tree, runner
        runner2 = ModelRunner(AlexNetWorkflow(sample_shape=(227, 227, 3),
                                              n_classes=1000),
                              snapshot=path, capture=False)
        refs2 = [runner2.infer(x) for x in requests]
        del runner2
        worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(refs, refs2))
        if not worst > 100 * SERVE_TOL:
            raise AssertionError(f"generation 2 too close: {worst}")
        torch.cuda.empty_cache()
        for label, (knobs, _) in ZMQ_ROUTINGS.items():
            with engine_knobs(**knobs):
                srv, launches = zmq_routing(torch, card, label, wf,
                                            requests, refs)
                try:
                    if label == "fused":
                        zmq_admission(torch, card, srv, requests, refs,
                                      path, refs2)
                finally:
                    srv.stop()
            if srv.error is not None:
                raise RuntimeError(f"[zmq:{label}] compute loop died") \
                    from srv.error
            out[f"zmq:{label}"] = launches
        del wf
        torch.cuda.empty_cache()
        zmq_cli(torch, card, path, requests, refs2)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 19: the chaos steps: the compute stall (seed, probability,
#: seconds), the proxy's wire faults and seed, the flood's per-client rate
#: limit (rows/s, its burst) and rows a flood request, the requests each
GRAPH_STALL = (99, 1.0, (0.02, 0.02))
GRAPH_PROXY_SEED = 2024
GRAPH_PROXY = {"drop": 0.05, "corrupt": 0.06, "duplicate": 0.04,
               "delay": 0.05, "delay_s": (0.01, 0.05)}
GRAPH_FLOOD_RATE, GRAPH_FLOOD_BURST, GRAPH_FLOOD_ROWS = 16.0, 16.0, 4
GRAPH_CHAOS_REQUESTS = 16


def alexnet_served(torch):
    """Phase 3's full-width AlexNet: seeded weights and biases."""
    from znicz_torch.core import prng
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prng.reset(SEED)
    wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000)
    with torch.no_grad():
        for f in wf.forwards:
            if f.bias is not None:
                f.bias.normal_(0.0, 0.05, generator=gen)
    return wf


def gen2_snapshot(runner, path):
    """Generation 2 of ``runner``'s live tree (every leaf moved), written
    uncompressed to ``path`` as phase 18 writes it."""
    from znicz_torch.snapshotter import write_host_pickle

    rng = np.random.default_rng(SEED + 1)
    tree = {name: {k: (0.5 * t.cpu().numpy() + 0.01 * rng.standard_normal(
        tuple(t.shape), dtype=np.float32)).astype(np.float32)
        for k, t in leaves.items()}
        for name, leaves in runner._active.tree.items()}
    write_host_pickle(path, {"units": tree, "velocities": {}, "epoch": 2},
                      compression="none")
    return path


def serve_pass(srv, requests, n_threads=4):
    """``requests`` submitted from ``n_threads`` threads as phase 3 does;
    (replies in order, wall s, each request's submit-to-reply s)."""
    from znicz_torch.serving.batcher import Request

    futures = [Future() for _ in requests]
    lat = [None] * len(requests)

    def done(i, t0):
        def cb(_fut):
            lat[i] = time.perf_counter() - t0
        return cb

    def client(tid):
        for i in range(tid, len(requests), n_threads):
            futures[i].add_done_callback(done(i, time.perf_counter()))
            srv.submit(Request(requests[i], requests[i].shape[0],
                               reply_to=futures[i], req_id=i))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    replies = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    bad = [r for r in replies if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} refused/failed replies: {bad[0]}")
    return replies, wall, lat


def memory(torch):
    """(allocated, reserved) bytes on the card after a sync."""
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _mib(n) -> str:
    return f"{n / 2**20:.1f} MiB"


#: phase 19: the order of the timed passes of the eager (E) and the
#: captured (C) server, in turns; each server's first is the main path
GRAPH_TURNS = "ECCEEC"


def graphs_routing(torch, card, label, wf, requests, refs, eager_ref):
    """One routing of phase 19 (its knobs set by the caller): the same
    requests through an eager and a captured ``InferenceServer``, both
    running.  Each server's runner dispatches a 128-row slice at every
    rung (captured against eager, bit-equal); then the 64 requests are
    served in ``GRAPH_TURNS`` passes.  Each server's first pass is the
    main path: its replies held to the composed forward (``SERVE_TOL``)
    and, bit for bit, to the eager forward of the rung each rode, no
    capture under traffic, the kernels launched (through the replays)
    as many times a dispatch as ``ZMQ_ROUTINGS`` says.  Returns (the
    captured server, still running; its main pass's launches; {"eager" /
    "captured": numbers}; the captured rung outputs)."""
    from znicz_torch.serving.frontend import InferenceServer

    expect = ZMQ_ROUTINGS[label][1]
    ctrs = {name: fn for name, fn in counters().items() if name in expect}
    rows_x = np.concatenate(requests)[:BATCH]
    n_images = sum(x.shape[0] for x in requests)
    servers, numbers, rung_y, replies_of = {}, {}, {}, {}
    try:
        for how in ("eager", "captured"):
            gc.collect()
            torch.cuda.empty_cache()
            m0 = memory(torch)
            t0 = time.perf_counter()
            srv = servers[how] = InferenceServer(
                wf, max_batch=BATCH, max_delay_ms=5.0, queue_bound=4096,
                request_ttl_s=600.0, capture=how == "captured")
            srv.start()                        # warms (captures) 8 rungs
            warm_s = time.perf_counter() - t0
            m1 = memory(torch)
            runner, rungs = srv.runner, srv.batcher.ladder.rungs
            if runner.capture != (how == "captured") or not \
                    runner.compiles == runner.graph_cache_size() \
                    == len(rungs):
                raise AssertionError(
                    f"[graphs:{label}:{how}] capture {runner.capture}, "
                    f"compiles {runner.compiles}, graph_cache_size "
                    f"{runner.graph_cache_size()} after the warm of {rungs}")
            rung_y[how] = {r: torch.from_numpy(runner.infer(rows_x[:r]))
                           for r in rungs}
            numbers[how] = {"warm_s": warm_s, "capture_s": runner.capture_s,
                            "allocated": m1[0] - m0[0],
                            "reserved": m1[1] - m0[1], "images_per_s": []}
        launches = None
        for turn in GRAPH_TURNS:
            how = "eager" if turn == "E" else "captured"
            srv, runner = servers[how], servers[how].runner
            first = how not in replies_of
            if first:
                for fn in ctrs.values():       # the main path starts here
                    fn.launches = 0
                runner.dispatches = 0
                compiles = runner.compiles
                with srv._lock:
                    srv._latencies.clear()
            replies, wall, _ = serve_pass(srv, requests)
            numbers[how]["images_per_s"].append(n_images / wall)
            if not first:
                continue
            replies_of[how] = replies
            got = {name: fn.launches for name, fn in ctrs.items()}
            dispatches = runner.dispatches
            check_replies(f"graphs:{label}:{how}", replies, refs)
            for name, per in expect.items():
                if got[name] != per * dispatches or not dispatches:
                    raise AssertionError(
                        f"[graphs:{label}:{how}] {name}: {got[name]} "
                        f"launches for {dispatches} dispatches, expected "
                        f"{per}")
            if runner.compiles != compiles:
                raise AssertionError(f"[graphs:{label}:{how}] "
                                     f"{runner.compiles - compiles} "
                                     f"captures under traffic")
            numbers[how].update(dispatches=dispatches, launches=got)
            if how == "captured":
                launches = got
        for how, srv in servers.items():
            nb = numbers[how]
            nb.update(srv.latency_quantiles())
            log(f"[graphs:{label}:{how}] {card}: warm of "
                f"{len(srv.batcher.ladder.rungs)} rungs {nb['warm_s']:.3f}s "
                f"(captures {nb['capture_s']:.3f}s), memory allocated "
                f"+{_mib(nb['allocated'])}, reserved "
                f"+{_mib(nb['reserved'])}; {len(requests)} requests, "
                f"{n_images} images a pass, passes in turns "
                f"{GRAPH_TURNS}: images/s "
                + ", ".join(f"{r:.1f}" for r in nb["images_per_s"])
                + f"; server clock over the passes p50_ms="
                f"{nb['p50_ms']:.2f} p99_ms={nb['p99_ms']:.2f}; the main "
                f"pass: {nb['dispatches']} dispatches, 0 captures, "
                f"launches={nb['launches']}")
        # every rung, captured against eager, bit for bit
        differ = [r for r in rung_y["eager"]
                  if not same_bits(torch, rung_y["eager"][r],
                                   rung_y["captured"][r])]
        # every reply bit-equal to the eager forward of the rung it rode
        # (the two servers may coalesce a request into other rungs)
        ladder, off_rung = servers["captured"].batcher.ladder, []
        for i, x in enumerate(requests):
            a = replies_of["captured"][i]["y"]
            if np.array_equal(a, replies_of["eager"][i]["y"]):
                continue
            rides = [eager_ref.infer(eager_ref.pad(x, b))[:len(x)]
                     for b in ladder.rungs if b >= len(x)]
            if not any(np.array_equal(a, y) for y in rides):
                off_rung.append(i)
        rate = {how: float(np.median(nb["images_per_s"]))
                for how, nb in numbers.items()}
        log(f"[graphs:{label}] captured against eager: "
            f"{len(rung_y['eager'])} rungs "
            + ("bit-equal" if not differ else f"DIFFER at {differ}")
            + f"; {len(requests)} replies "
            + ("bit-equal to the eager forward of their rung"
               if not off_rung else f"DIFFER: requests {off_rung}")
            + f"; median images/s captured {rate['captured']:.1f} against "
            f"eager {rate['eager']:.1f}")
        if differ or off_rung:
            raise AssertionError(f"[graphs:{label}] captured replies "
                                 f"differ from eager: rungs {differ}, "
                                 f"requests {off_rung}")
        eager = servers.pop("eager")
        eager.stop()
        if eager.error is not None:
            raise RuntimeError(f"[graphs:{label}] eager compute loop "
                               f"died") from eager.error
        return servers.pop("captured"), launches, numbers, \
            rung_y["captured"]
    finally:
        for srv in servers.values():
            srv.stop()


def graphs_swap(torch, card, srv, requests, path, refs2):
    """Phase 19's swap on the running captured ``fused`` server: a swap
    under traffic captures exactly the ladder's rungs for generation 2
    (its replies within ``SERVE_TOL`` of generation 2's composed
    forward); the rollback captures none and serves generation 1's
    bits again (the caller compares them)."""
    runner = srv.runner
    rungs = len(srv.batcher.ladder.rungs)
    c0, cap0 = runner.compiles, runner.capture_s
    m0 = memory(torch)
    t0 = time.perf_counter()
    swap = srv.swap_async(path)
    during, _, _ = serve_pass(srv, requests)
    swap.join(600)
    swap_s = time.perf_counter() - t0
    m1 = memory(torch)
    captured, capture_s = runner.compiles - c0, runner.capture_s - cap0
    if swap.is_alive() or runner.generation != 2 or captured != rungs \
            or runner.graph_cache_size() != rungs:
        raise AssertionError(f"[graphs:swap] generation "
                             f"{runner.generation}, {captured} captures, "
                             f"family {runner.graph_cache_size()}")
    after, _, _ = serve_pass(srv, requests)
    check_replies("graphs:swap:after", after, refs2)
    gens = sorted({r["gen"] for r in during})
    c1 = runner.compiles
    rolled = runner.rollback()
    m2 = memory(torch)
    if rolled != 1 or runner.compiles != c1:
        raise AssertionError(f"[graphs:rollback] to {rolled}, "
                             f"{runner.compiles - c1} captures")
    log(f"[graphs:swap] {card}: swap_async under traffic {swap_s:.3f}s "
        f"(load, {captured} captures in {capture_s:.3f}s, flip); "
        f"generation 2's family allocated +{_mib(m1[0] - m0[0])}, reserved "
        f"+{_mib(m1[1] - m0[1])}; generations while swapping {gens}; "
        f"rollback to {rolled}: 0 captures, allocated "
        f"{_mib(m2[0] - m1[0])} (the rolled-away family freed)")
    return {"swap_s": swap_s, "capture_s": capture_s,
            "family_allocated": m1[0] - m0[0],
            "family_reserved": m1[1] - m0[1]}


def graphs_chaos(torch, card, wf, srv, requests, refs):
    """Phase 19's chaos on the running captured ``fused`` server: compute
    stalls on every dispatch, counted; a ``ChaosProxy`` between two
    ``InferenceClient``s and the server, every request answered once or
    refused readably and the counts balanced; then a second server with a
    rate limit, flooded by a ``FloodProcess`` at ten times it (only
    ``rate_limited`` refusals) while a paced client gets every reply."""
    from znicz_torch.parallel.chaos import (ChaosProxy, FaultSchedule,
                                            FloodProcess)
    from znicz_torch.serving import (AdmissionPolicy, InferenceClient,
                                     InferenceError, InferenceServer)

    runner = srv.runner
    reqs = requests[:GRAPH_CHAOS_REQUESTS]
    seed, p, span = GRAPH_STALL
    runner.inject_compute_faults(FaultSchedule(seed, stall=p, stall_s=span))
    d0, s0 = runner.dispatches, runner.stalls
    replies, wall, lat = serve_pass(srv, reqs)
    runner.inject_compute_faults(None)
    made, stalls = runner.dispatches - d0, runner.stalls - s0
    check_replies("graphs:stall", replies, refs[:len(reqs)])
    log(f"[graphs:stall] {card}: FaultSchedule({seed}, stall={p}, "
        f"stall_s={span}): {made} dispatches, {stalls} stalls "
        f"(stats {srv.stats()['stalls']}); {len(reqs)} requests in "
        f"{wall:.3f}s, submit-to-reply {quantiles(lat)}")
    if not made or stalls != made:
        raise AssertionError(f"[graphs:stall] {stalls} stalls for {made} "
                             f"dispatches")

    proxy = ChaosProxy("tcp://127.0.0.1:*", srv.endpoint,
                       FaultSchedule(GRAPH_PROXY_SEED, **GRAPH_PROXY)).start()
    bad0 = srv.bad_frames
    outcomes = [None] * len(reqs)
    errors = []

    def client(tid):
        cli = InferenceClient(proxy.front_endpoint, timeout=300,
                              resend_after_s=2.0, max_resends=100)
        try:
            for i in range(tid, len(reqs), 2):
                try:
                    outcomes[i] = cli.result(cli.submit(reqs[i]))
                except InferenceError as exc:   # a readable refusal
                    outcomes[i] = exc.reply
        except Exception as exc:                # raised below
            errors.append(exc)
        finally:
            cli.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    proxy.stop()
    c = proxy.counters
    if errors or any(t.is_alive() for t in threads) or None in outcomes:
        raise AssertionError(f"[graphs:proxy] unanswered: {errors}")
    ok = [i for i, r in enumerate(outcomes) if r.get("ok")]
    refused = [r for r in outcomes if not r.get("ok")]
    check_replies("graphs:proxy", [outcomes[i] for i in ok],
                  [refs[i] for i in ok])
    bad_frames = srv.bad_frames - bad0
    log(f"[graphs:proxy] {card}: {len(reqs)} requests through the proxy in "
        f"{wall:.3f}s: {len(ok)} answered, {len(refused)} refused "
        f"({sorted({r.get('policy') for r in refused})}); proxy counts "
        f"{c}; server bad_frames +{bad_frames}")
    if any("policy" not in r and "error" not in r for r in refused) or \
            len(proxy.log) != sum(n for d in c.values() for n in d.values()) \
            or bad_frames != c["req"]["corrupt"] or not proxy.total_faults():
        raise AssertionError(f"[graphs:proxy] counts do not balance: {c}, "
                             f"bad_frames {bad_frames}")

    flood_srv = InferenceServer(
        wf, max_batch=BATCH, max_delay_ms=5.0, queue_bound=4096,
        request_ttl_s=600.0,
        admission=AdmissionPolicy(rate_limit=GRAPH_FLOOD_RATE,
                                  rate_burst=GRAPH_FLOOD_BURST)).start()
    flood = cli = None
    try:
        flood = FloodProcess(flood_srv.endpoint,
                             flood_srv.runner.sample_shape,
                             GRAPH_FLOOD_RATE, factor=10.0,
                             rows=GRAPH_FLOOD_ROWS)
        cli = InferenceClient(flood_srv.endpoint, timeout=300)
        flood.start_flood()
        t0 = time.perf_counter()
        while flood_srv.batcher.stats()["rate_limited"] == 0:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("[graphs:flood] never rate limited")
            time.sleep(0.01)
        paced = []
        for x in requests[:4]:
            t1 = time.perf_counter()
            y = cli.infer(x[:1])
            paced.append(time.perf_counter() - t1)
            if y.shape != refs[0][:1].shape or not np.isfinite(y).all():
                raise AssertionError(f"[graphs:flood] paced reply {y.shape}")
            time.sleep(0.25)
        stats = flood.stop_flood()
        log(f"[graphs:flood] {card}: FloodProcess at 10x {GRAPH_FLOOD_RATE:g} "
            f"rows/s ({GRAPH_FLOOD_ROWS}-row requests): {stats}; a paced "
            f"client's 4 replies in {quantiles(paced)}")
        if set(stats["refusals"]) != {"rate_limited"} or \
                not stats["accepted"]:
            raise AssertionError(f"[graphs:flood] {stats}")
    finally:
        if cli is not None:
            cli.close()
        if flood is not None:
            flood.close()
        flood_srv.stop()
    return {"stalls": stalls, "proxy": c, "flood": stats}


def capture_stream_check(torch, card) -> None:
    """ROADMAP C.11: the capture stream is a CUDA stream of its own: none
    of 96 streams PyTorch's pool hands out (32 a priority, round robin)
    is it, it is non-blocking (no implicit sync with the legacy
    stream), and it was made in its device's primary context."""
    import ctypes

    from znicz_torch.parallel.graphs import capturing

    with capturing(torch.device("cuda", 0)) as stream:
        handle = stream.cuda_stream
    pooled = {torch.cuda.Stream(device=0).cuda_stream for _ in range(96)}
    cuda = ctypes.CDLL("libcuda.so.1")
    flags = ctypes.c_uint()
    rc = cuda.cuStreamGetFlags(ctypes.c_void_p(handle), ctypes.byref(flags))
    # the stream lives in device 0's primary context
    ctx, primary, dev = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    rc_ctx = (cuda.cuStreamGetCtx(ctypes.c_void_p(handle), ctypes.byref(ctx))
              or cuda.cuDeviceGet(ctypes.byref(dev), 0)
              or cuda.cuDevicePrimaryCtxRetain(ctypes.byref(primary), dev))
    if not rc_ctx:
        cuda.cuDevicePrimaryCtxRelease(dev)
    if (handle in pooled or rc != 0 or flags.value != 1 or rc_ctx != 0
            or ctx.value != primary.value):
        raise AssertionError(f"[graphs:stream] the capture stream "
                             f"{handle:#x} is pooled ({handle in pooled}), "
                             f"not non-blocking (rc {rc}, flags "
                             f"{flags.value}) or outside device 0's primary "
                             f"context (rc {rc_ctx})")
    log(f"[graphs:stream] {card}: the capture stream {handle:#x} is none of "
        f"{len(pooled)} pooled streams, non-blocking (flags "
        f"{flags.value}) and in device 0's primary context")


def graphs_phase(torch, card):
    """Phase 19: the capture stream apart from PyTorch's pool
    (``capture_stream_check``); full-width AlexNet (phase 3's
    configuration) served as one captured CUDA graph a ladder rung,
    against the same server eager (``capture=False``), under ``fused``
    and ``pallas_lrn`` (``graphs_routing``); on the ``fused`` server a
    swap under traffic and the rollback (``graphs_swap``) and the chaos
    harness (``graphs_chaos``).  Returns {path: {kernel: launches}}."""
    from znicz_torch.serving.model import ModelRunner

    capture_stream_check(torch, card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    out = {}
    try:
        wf = alexnet_served(torch)
        requests = make_requests()
        eager_ref = ModelRunner(wf, capture=False)
        refs = [eager_ref.infer(x) for x in requests]     # composed
        path = gen2_snapshot(eager_ref, os.path.join(tmp, "gen2.pickle"))
        eager_ref.swap(path)
        refs2 = [eager_ref.infer(x) for x in requests]
        eager_ref.rollback()
        numbers = {}
        for label, (knobs, _) in ZMQ_ROUTINGS.items():
            with engine_knobs(**knobs):
                srv, launches, numbers[label], rung_y = graphs_routing(
                    torch, card, label, wf, requests, refs, eager_ref)
                try:
                    if label == "fused":
                        numbers["swap"] = graphs_swap(torch, card, srv,
                                                      requests, path, refs2)
                        back = [r for r in rung_y if not same_bits(
                            torch, rung_y[r], torch.from_numpy(
                                srv.runner.infer(np.concatenate(
                                    requests)[:r])))]
                        if back:
                            raise AssertionError(f"[graphs:rollback] rungs "
                                                 f"{back} differ")
                        log(f"[graphs:rollback] {len(rung_y)} rungs "
                            f"bit-equal to generation 1's before the swap")
                        numbers["chaos"] = graphs_chaos(
                            torch, card, wf, srv, requests, refs)
                finally:
                    srv.stop()
                if srv.error is not None:
                    raise RuntimeError(f"[graphs:{label}] compute loop "
                                       f"died") from srv.error
                out[f"graphs:{label}"] = launches
                del srv
        log(f"[graphs] {card}: " + json.dumps(
            {k: v for k, v in numbers.items() if k != "chaos"},
            default=float))
        del wf, eager_ref
        gc.collect()
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 20: the serving meshes (data, model) the ranks serve on, in order
SERVE_MESHES = ((2, 1), (1, 2))
#: phase 20: K1 and K2 at the rows a rank of mesh (2, 1) gives them
SERVE_MESH_KERNEL_SHAPES = {
    name: SHARD_KERNEL_SHAPES[name]
    for name in ("fused_block_fwd", "bias_relu_fwd")}


def serve_mesh_lead(torch, wf, requests, path, ctrs):
    """Rank 0 of phase 20: the ``InferenceServer`` on the serving mesh of
    ``root.common.serving.mesh``: the requests at generation 1, a swap to
    ``path``, the requests at generation 2, the rollback, some requests
    at generation 1 again."""
    from znicz_torch.serving.frontend import InferenceServer

    t0 = time.perf_counter()
    srv = InferenceServer(wf, max_batch=BATCH, max_delay_ms=5.0,
                          queue_bound=4096, request_ttl_s=600.0).start()
    runner = srv.runner
    rec = {"warm_s": time.perf_counter() - t0,
           "rungs": list(srv.batcher.ladder.rungs),
           "mesh": runner.mesh_shape, "capture": runner.capture,
           "compiles": runner.compiles}
    try:
        for fn in ctrs.values():               # the main path starts here
            fn.launches = 0
        d0 = runner.dispatches
        replies, wall, lat = serve_pass(srv, requests)
        rec["launches"] = {name: fn.launches for name, fn in ctrs.items()}
        rec["pass_dispatches"] = runner.dispatches - d0
        server = srv.latency_quantiles()
        rec.update(images_per_s=sum(x.shape[0] for x in requests) / wall,
                   p50_ms=server["p50_ms"], p99_ms=server["p99_ms"],
                   client=quantiles(lat))
        rec["passes"] = [[(r["gen"], r["y"]) for r in replies]]
        t0 = time.perf_counter()
        runner.swap(path, srv.batcher.ladder)
        rec["swap_s"] = time.perf_counter() - t0
        rec["passes"].append([(r["gen"], r["y"])
                              for r in serve_pass(srv, requests)[0]])
        rec["rollback"] = runner.rollback()
        rec["passes"].append([(r["gen"], r["y"]) for r in serve_pass(
            srv, requests[:GRAPH_CHAOS_REQUESTS])[0]])
    finally:
        srv.stop()
    if srv.error is not None:
        raise RuntimeError("[serve_mesh] compute loop died") from srv.error
    rec.update(generation=runner.generation, dispatches=runner.dispatches,
               swaps=runner.swaps, rollbacks=runner.rollbacks)
    return rec


def serve_mesh_follow(torch, wf, ctrs):
    """A rank other than 0 of phase 20: ``ModelRunner.follow()``, each
    generation step it takes recorded."""
    from znicz_torch.serving.model import ModelRunner

    runner = ModelRunner(wf)
    for fn in ctrs.values():
        fn.launches = 0
    history = []
    flip, roll_back = runner._flip, runner._roll_back

    def flip_(gen):
        history.append(("flip", gen))
        return flip(gen)

    def roll_back_():
        out = roll_back()
        history.append(("rollback", out[0]))
        return out

    runner._flip, runner._roll_back = flip_, roll_back_
    runner.follow()
    return {"history": history, "generation": runner.generation,
            "dispatches": runner.dispatches, "mesh": runner.mesh_shape,
            "capture": runner.capture,
            "launches": {name: fn.launches for name, fn in ctrs.items()}}


def serve_mesh_rank(rank, world, store, tmp, card):
    """One rank of phase 20 (a spawned process): joins the gloo group on
    the card and serves full-width AlexNet under ``fused`` on each of
    ``SERVE_MESHES`` (rank 0 leads, the others follow).  Writes its
    records to ``tmp/rank<N>.pkl``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pickle

    import torch

    from znicz_torch.core.config import root
    from znicz_torch.parallel import mesh as mesh_mod

    mesh_mod.distributed_init(f"file://{store}", world, rank,
                              backend="gloo")
    requests = make_requests() if rank == 0 else None
    ctrs = {name: fn for name, fn in counters().items()
            if name in ("fused_block_fwd", "bias_relu_fwd")}
    out = {"rank": rank}
    with engine_knobs(**FUSED_KNOBS):
        for dp, mp in SERVE_MESHES:
            root.common.serving.mesh.data = dp
            root.common.serving.mesh.model = mp
            wf = alexnet_served(torch)
            if rank == 0:
                out[dp, mp] = serve_mesh_lead(
                    torch, wf, requests, os.path.join(tmp, "gen2.pickle"),
                    ctrs)
            else:
                out[dp, mp] = serve_mesh_follow(torch, wf, ctrs)
            del wf
            gc.collect()
            torch.cuda.empty_cache()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def serve_mesh_phase(torch, card, rows):
    """Phase 20: K1 and K2 at a rank's 64-row shapes against their plain
    versions (rows under ``"serve_mesh"``); one process serves phase 3's
    requests captured under ``fused`` at generations 1 and 2 (the
    yardstick); then ``SHARD_WORLD`` gloo ranks on the card serve them on
    each of ``SERVE_MESHES`` (``serve_mesh_rank``): the rungs snapped to
    dp, every reply within the cross-layout band of one process's, a
    swap and a rollback keeping every rank on one generation, K1/K2 2/3 a
    dispatch on every rank, images/s a rank beside one process's.
    Returns {path: {kernel: launches}} (rank 0's)."""
    import multiprocessing as mp
    import pickle

    from znicz_torch.serving.batcher import BucketLadder
    from znicz_torch.serving.frontend import InferenceServer

    cifar_rows(torch, rows, SERVE_MESH_KERNEL_SHAPES, tag="serve_mesh",
               batch=BATCH // 2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    try:
        requests = make_requests()
        n_images = sum(x.shape[0] for x in requests)
        with engine_knobs(**FUSED_KNOBS):
            wf = alexnet_served(torch)
            srv = InferenceServer(wf, max_batch=BATCH, max_delay_ms=5.0,
                                  queue_bound=4096,
                                  request_ttl_s=600.0).start()
            try:
                replies, wall, _ = serve_pass(srv, requests)
                one = {1: [r["y"] for r in replies]}
                one_rate = n_images / wall
                path = gen2_snapshot(srv.runner,
                                     os.path.join(tmp, "gen2.pickle"))
                srv.runner.swap(path, srv.batcher.ladder)
                one[2] = [r["y"] for r in serve_pass(srv, requests)[0]]
            finally:
                srv.stop()
            del srv, wf
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=serve_mesh_rank,
                             args=(rank, SHARD_WORLD, store, tmp, card))
                 for rank in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_JOIN_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * SHARD_WORLD:
            raise AssertionError(f"[serve_mesh] ranks exited {codes}")
        ranks = []
        for rank in range(SHARD_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        log(f"[serve_mesh] ranks spawned and served {len(SERVE_MESHES)} "
            f"meshes in {time.perf_counter() - t0:.2f}s; one process "
            f"(captured) images/s={one_rate:.1f}")
        bad, out = [], {}
        per = {name: n for name, n in ZMQ_ROUTINGS["fused"][1].items() if n}
        for dp, mp_ in SERVE_MESHES:
            lead = ranks[0][dp, mp_]
            tag = f"serve_mesh:{dp}x{mp_}"
            worst, outside = 0.0, 0
            for gen, got in zip((1, 2, 1), lead["passes"]):
                for i, (stamp, y) in enumerate(got):
                    want = one[gen][i]
                    if stamp != gen or y.shape != want.shape or \
                            not np.isfinite(y).all():
                        bad.append(f"{tag}: request {i} stamped {stamp}, "
                                   f"shape {y.shape}")
                        continue
                    d = np.abs(y - want)
                    worst = max(worst, float(d.max()))
                    outside += int((d > SHARD_ATOL + SHARD_RTOL
                                    * np.abs(want)).sum())
            if lead["rungs"] != BucketLadder(BATCH, dp=dp).rungs or \
                    any(r % dp for r in lead["rungs"]):
                bad.append(f"{tag}: rungs {lead['rungs']}")
            if outside:
                bad.append(f"{tag}: {outside} logits outside the band")
            for r in ranks[1:]:
                rec = r[dp, mp_]
                if rec["history"] != [("flip", 2), ("rollback", 1)] or \
                        rec["generation"] != lead["generation"] or \
                        lead["generation"] != 1 or \
                        rec["dispatches"] != lead["dispatches"] or \
                        rec["capture"] or rec["mesh"] != lead["mesh"]:
                    bad.append(f"{tag}: rank {r['rank']} {rec['history']}, "
                               f"generation {rec['generation']}, "
                               f"{rec['dispatches']} dispatches against "
                               f"{lead['dispatches']}")
                for name, n in per.items():
                    if rec["launches"][name] != n * rec["dispatches"]:
                        bad.append(f"{tag}: rank {r['rank']} {name} "
                                   f"{rec['launches'][name]} launches for "
                                   f"{rec['dispatches']} dispatches")
            for name, n in per.items():
                if lead["launches"][name] != n * lead["pass_dispatches"] \
                        or not lead["pass_dispatches"]:
                    bad.append(f"{tag}: rank 0 {name} launches "
                               f"{lead['launches'][name]}")
            log(f"[{tag}] {card}: mesh {lead['mesh']}, uncaptured, rungs "
                f"{lead['rungs']} (warm {lead['warm_s']:.2f}s); "
                f"{len(requests)} requests on {SHARD_WORLD} ranks: "
                f"images/s={lead['images_per_s']:.1f}, a rank "
                f"{lead['images_per_s'] / dp:.1f} (one process "
                f"{one_rate:.1f}), server clock "
                f"p50_ms={lead['p50_ms']:.2f} p99_ms={lead['p99_ms']:.2f}, "
                f"submit-to-reply {lead['client']}; "
                f"{lead['pass_dispatches']} dispatches, rank 0 "
                f"launches={lead['launches']}; replies against one "
                f"process's: max|d| {worst:.3e}, {outside} outside rtol "
                f"{SHARD_RTOL:g} / atol {SHARD_ATOL:g}; swap "
                f"{lead['swap_s']:.3f}s, rollback to {lead['rollback']}; "
                f"rank 1 took {[r[dp, mp_]['history'] for r in ranks[1:]]}, "
                f"{lead['dispatches']} dispatches on every rank")
            out[tag] = lead["launches"]
        if bad:
            raise AssertionError(f"[serve_mesh] {bad}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 21: the replica fleet ----------------------------------------------

#: phase 21: the balancer's knobs: the TTL, failover and hedge clocks
#: above a loaded host's heartbeat jitter and a full pass's queueing (32
#: requests in flight wait 0.2-0.5 s), the canary judged on 8 replies
#: with a parity probe every 2nd old dispatch
FLEET_BALANCE = {"replica_ttl_s": 5.0, "failover_timeout_s": 5.0,
                 "hedge_floor_s": 1.0, "canary_requests": 8,
                 "canary_timeout_s": 120.0, "parity_every": 2}
#: phase 21: the stall the rolled-back wave's canary takes on every
#: dispatch (seed, probability, seconds): far above 3x the old
#: generation's p99 of one request at a time
FLEET_STALL = (21, 1.0, (0.5, 0.5))
#: phase 21: the rungs one request's rows are compared at
FLEET_PARITY_RUNGS = (16, BATCH)
#: phase 21: requests in flight while the promoted wave is judged.  Its
#: verdict compares the p99 of 8 canary replies (their max) with the old
#: replica's at 3x: one request at a time (~25 ms) a single host hiccup
#: on the canary's side trips it (one run: a 114-ms reply among 8); with
#: 8 in flight both sides queue (~100-300 ms)
FLEET_PROMOTE_IN_FLIGHT = 8
#: phase 21: the most any state the phase waits for may take (s)
FLEET_WAIT_S = 300.0


def fleet_wait(pred, what, budget=FLEET_WAIT_S) -> float:
    """Poll ``pred()`` until true; the seconds it took.  Raises past
    ``budget``."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > budget:
            raise AssertionError(f"[fleet] never {what} within {budget}s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def fleet_member(bal, rid):
    """``rid``'s row of the balancer's stats (None: not a member)."""
    rows = [m for m in bal.stats()["replicas"] if m["replica_id"] == rid]
    return rows[0] if rows else None


def fleet_drive(cli, requests, refs, pred, what, label, in_flight=1,
                on_reply=None):
    """Requests of ``requests`` (in turn) through ``cli``, ``in_flight``
    at a time, until ``pred()``: each reply ok, stamped ``lb``, and, with
    ``refs``, within ``SERVE_TOL`` of its composed forward (None: a wave
    of other weights, whose canary's replies differ).  Returns [(request
    index, reply, submit-to-reply s)] in reply order."""
    out, sent = [], {}
    n = 0
    t0 = time.perf_counter()
    while sent or not pred():
        if time.perf_counter() - t0 > FLEET_WAIT_S:
            raise AssertionError(f"[{label}] never {what}")
        while len(sent) < in_flight and not pred():
            i = n % len(requests)
            n += 1
            sent[cli.submit(requests[i])] = (i, time.perf_counter())
        for rep in cli.collect(0.05):
            i, t_sent = sent.pop(rep["req_id"])
            if not rep.get("ok") or rep.get("lb") is not True:
                raise AssertionError(f"[{label}] reply {rep}")
            out.append((i, rep, time.perf_counter() - t_sent))
            if on_reply is not None:
                on_reply(rep)
    if refs is not None:
        check_replies(label, [r for _, r, _ in out],
                      [refs[i] for i, _, _ in out])
    return out


def slowest(served, k=3) -> str:
    """The ``k`` slowest replies of a :func:`fleet_drive`: replica,
    generation and ms on the client's clock."""
    rows = sorted(served, key=lambda t: -t[2])[:k]
    return ", ".join(f"{r['replica_id']}@{r['gen']} {s * 1e3:.1f}"
                     for _, r, s in rows)


def family_launches(runner):
    """{kernel: launches} of one replay of each rung of ``runner``'s live
    family (a capture records its launches)."""
    from znicz_torch.parallel.graphs import counted

    names = [fn.__name__ for fn in counted()]
    return [{n: k for n, (k, _) in zip(names, g.launches)}
            for g in runner._active.family.graphs.values()]


def fleet_phase(torch, card):
    """Phase 21: a ``ReplicaBalancer`` in front of two full-width AlexNet
    replicas (``fused``, captured rungs, ``announce``), each under a
    ``ReplicaHarness``, sharing the card in this process.  Serve phase
    3's 64 requests from ``ZMQ_CLIENTS`` clients through the balancer (the
    main path) and directly to one replica; a kill and restart of ``r0``
    mid-pass; a canary wave of the same weights promoted under ``parity:
    true`` (each probe and its primary served alone, at the rung of its
    rows: ROADMAP C.9), a wave of other weights rolled back for reply
    parity, and a stalled canary rolled back on its p99; ``r1``
    restarted and healed onto the fleet path.  Returns {path: {kernel:
    launches}}."""
    from znicz_torch.parallel.chaos import ReplicaHarness
    from znicz_torch.serving import (InferenceClient, InferenceServer,
                                     ReplicaBalancer)
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.snapshotter import write_host_pickle

    expect = ZMQ_ROUTINGS["fused"][1]
    ctrs = {name: fn for name, fn in counters().items() if name in expect}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    bal, harnesses, cli = None, [], None
    # the waves' verdicts compare two replicas' latencies inside this
    # interpreter: the earlier phases' objects are frozen out of the
    # collector, so a full collection does not rescan them mid-wave
    gc.collect()
    gc.freeze()
    try:
        t_phase = time.perf_counter()
        requests = make_requests()
        n_images = sum(x.shape[0] for x in requests)
        wfs = [alexnet_served(torch) for _ in range(2)]
        eager_ref = ModelRunner(wfs[0], capture=False)
        refs = [eager_ref.infer(x) for x in requests]     # composed
        # the waves' snapshots: generation 1's weights at new paths
        tree = {name: {k: t.cpu().numpy() for k, t in leaves.items()}
                for name, leaves in eager_ref._active.tree.items()}
        paths = [os.path.join(tmp, f"fleet_{tag}.pickle")
                 for tag in ("promote", "rollback", "changed")]
        write_host_pickle(paths[0], {"units": tree, "velocities": {},
                                     "epoch": 1}, compression="none")
        shutil.copyfile(paths[0], paths[1])
        # other weights for the parity wave: each leaf scaled by 0.75
        write_host_pickle(paths[2], {
            "units": {name: {k: (a * np.float32(0.75)).astype(a.dtype)
                             for k, a in leaves.items()}
                      for name, leaves in tree.items()},
            "velocities": {}, "epoch": 1}, compression="none")
        del tree, eager_ref
        with engine_knobs(**FUSED_KNOBS):
            bal = ReplicaBalancer("tcp://127.0.0.1:*",
                                  **FLEET_BALANCE).start()

            def harness(rid, wf):
                return ReplicaHarness(lambda: InferenceServer(
                    wf, bind="tcp://127.0.0.1:*", max_batch=BATCH,
                    max_delay_ms=5.0, queue_bound=4096,
                    request_ttl_s=600.0, announce=bal.endpoint,
                    replica_id=rid))

            harnesses = [harness(f"r{i}", wf) for i, wf in enumerate(wfs)]
            t0 = time.perf_counter()
            for h in harnesses:
                h.start()
            fleet_wait(lambda: bal.ready_count() == 2, "two ready")
            log(f"[fleet] balancer at {bal.endpoint}; replicas "
                f"{[h.server.endpoint for h in harnesses]} up in "
                f"{time.perf_counter() - t0:.2f}s (8 captures each)")
            launches = fleet_serve(torch, card, bal, harnesses, requests,
                                   refs, ctrs, expect, n_images)
            fleet_failover(card, bal, harnesses, requests, refs, n_images)
            cli = InferenceClient(bal.endpoint, timeout=600,
                                  resend_after_s=600, breaker_failures=0)
            fleet_waves(torch, card, bal, harnesses, cli, requests, refs,
                        paths)
            fleet_heal(card, bal, harnesses, cli, requests, refs, paths[0])
        if not bal.ledger()["balanced"]:
            raise AssertionError(f"[fleet] ledger {bal.ledger()}")
        log(f"[fleet] {card}: ledger {bal.ledger()}; counters "
            + json.dumps({k: getattr(bal, k) for k in bal.COUNTERS})
            + f"; phase {time.perf_counter() - t_phase:.1f}s")
        return {"fleet:fused": launches}
    finally:
        if cli is not None:
            cli.close()
        if bal is not None:
            bal.stop()
        for h in harnesses:
            if h.server is not None:
                h.server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.unfreeze()
        gc.collect()
        torch.cuda.empty_cache()


#: phase 21: the order of the timed passes to one replica directly (D)
#: and through the balancer (F); the first F is the main path
FLEET_TURNS = "DFFD"


def fleet_serve(torch, card, bal, harnesses, requests, refs, ctrs, expect,
                n_images):
    """Phase 21's serve, in ``FLEET_TURNS``: one replica directly over ZMQ
    and the fleet through the balancer.  The first pass through the
    balancer is the main path (its launches counted): every reply within
    ``SERVE_TOL`` of the composed forward, stamped ``lb``, ``r0`` or
    ``r1`` and generation 1, both replicas serving, K1/K2 2/3 a dispatch
    in total and in each replica's captured family.  Returns {kernel:
    launches}."""
    runners = [h.server.runner for h in harnesses]
    rates = {"D": [], "F": []}
    launches = None
    for turn in FLEET_TURNS:
        main = turn == "F" and launches is None
        if main:
            for fn in ctrs.values():            # the main path starts here
                fn.launches = 0
        d0 = [r.dispatches for r in runners]
        led0 = bal.ledger()
        endpoint = bal.endpoint if turn == "F" \
            else harnesses[0].server.endpoint
        replies, lat, wall = zmq_clients(endpoint, requests)
        made = [r.dispatches - d for r, d in zip(runners, d0)]
        rates[turn].append(n_images / wall)
        check_replies("fleet:serve" if turn == "F" else "fleet:direct",
                      replies, refs)
        if turn == "D":
            log(f"[fleet:direct] {card}: one replica over ZMQ, "
                f"{len(requests)} requests, {n_images} images in "
                f"{wall:.3f}s: images/s={rates['D'][-1]:.1f}; client clock "
                f"{quantiles(lat)}")
            continue
        led = bal.ledger()
        bad = [r for r in replies if r.get("lb") is not True
               or r.get("replica_id") not in ("r0", "r1")
               or r.get("gen") != 1]
        by = {rid: sum(1 for r in replies if r["replica_id"] == rid)
              for rid in ("r0", "r1")}
        if bad or not all(by.values()) or not all(made) or \
                not led["balanced"] or \
                led["accepted"] - led0["accepted"] != len(requests):
            raise AssertionError(f"[fleet:serve] replies by replica {by}, "
                                 f"dispatches {made}, ledger {led}, "
                                 f"{len(bad)} bad: {bad[:1]}")
        if main:
            launches = {name: fn.launches for name, fn in ctrs.items()}
            alloc, reserved = memory(torch)
            for name, per in expect.items():
                if launches[name] != per * sum(made):
                    raise AssertionError(
                        f"[fleet:serve] {name}: {launches[name]} launches "
                        f"for {made} dispatches, expected {per} each")
            for rid, h in zip(("r0", "r1"), harnesses):
                fam = family_launches(h.server.runner)
                if len(fam) != len(h.server.batcher.ladder.rungs) or any(
                        f[name] != per for f in fam
                        for name, per in expect.items()):
                    raise AssertionError(f"[fleet:serve] {rid}'s rungs "
                                         f"launch {fam}")
        log(f"[fleet:serve] {card}: {len(requests)} requests, {n_images} "
            f"images through the balancer in {wall:.3f}s: "
            f"images/s={rates['F'][-1]:.1f}; client clock "
            f"{quantiles(lat)}; replies by replica {by}, dispatches "
            f"{dict(zip(('r0', 'r1'), made))}"
            + (f", launches={launches} (each replica's rungs {expect})"
               if main else "")
            + f"; hedges {bal.hedges} (won {bal.hedge_wins}), failovers "
            f"{bal.failovers}; ledger {led}")
    log(f"[fleet:serve] {card}: images/s through the balancer "
        f"{[round(r, 1) for r in rates['F']]} against one replica direct "
        f"{[round(r, 1) for r in rates['D']]} (turns {FLEET_TURNS}): "
        f"median {np.median(rates['F']) / np.median(rates['D']):.1%}")
    log(f"[fleet:memory] {card}: two replicas up: memory_allocated "
        f"{_mib(alloc)}, memory_reserved {_mib(reserved)}")
    return launches


def fleet_failover(card, bal, harnesses, requests, refs, n_images):
    """Phase 21's failover: the pass again, ``r0`` killed once a third of
    it is answered and restarted (a wildcard bind: a new endpoint) once
    two thirds are; every request answered exactly once, within
    ``SERVE_TOL``, the ledger balanced."""
    led0 = bal.ledger()
    c0 = {k: getattr(bal, k) for k in ("failovers", "replicas_lost",
                                       "hedges", "hedge_wins")}
    events, errors = {}, []

    def chaos():
        try:
            n = len(requests)
            fleet_wait(lambda: bal.replied - led0["replied"] >= n // 3,
                       "a third answered")
            t0 = time.perf_counter()
            harnesses[0].kill()
            events["kill_s"] = time.perf_counter() - t0
            fleet_wait(lambda: bal.replied - led0["replied"]
                       >= 2 * n // 3, "two thirds answered")
            t0 = time.perf_counter()
            harnesses[0].restart()
            events["restart_s"] = time.perf_counter() - t0
        except Exception as exc:               # raised below
            errors.append(exc)

    monitor = threading.Thread(target=chaos)
    monitor.start()
    replies, lat, wall = zmq_clients(bal.endpoint, requests)
    monitor.join(FLEET_WAIT_S)
    if errors or monitor.is_alive():
        raise AssertionError(f"[fleet:failover] {errors or 'hung'}")
    endpoint = harnesses[0].server.endpoint
    back = fleet_wait(lambda: (fleet_member(bal, "r0") or {}).get(
        "endpoint") == endpoint and bal.ready_count() == 2,
        "r0 back at its new endpoint")
    check_replies("fleet:failover", replies, refs)
    led = bal.ledger()
    got = {k: led[k] - led0[k] for k in ("accepted", "replied", "refused")}
    if got != {"accepted": len(requests), "replied": len(requests),
               "refused": 0} or not led["balanced"] or led["in_flight"]:
        raise AssertionError(f"[fleet:failover] not exactly once: {got}, "
                             f"ledger {led}")
    c = {k: getattr(bal, k) - v for k, v in c0.items()}
    log(f"[fleet:failover] {card}: r0 killed at 1/3 ({events['kill_s']:.2f}s"
        f" to stop) and restarted at 2/3 ({events['restart_s']:.2f}s, 8 "
        f"captures; a member again {back:.2f}s later): {len(requests)} "
        f"requests, {n_images} images in {wall:.3f}s, each answered once "
        f"({got}); client clock {quantiles(lat)}; {c}; ledger {led}")


def rung_parity(torch, runner, x):
    """Whether ``x``'s rows come out bit-equal at each rung of
    ``FLEET_PARITY_RUNGS`` (the served forward, replayed); (equal, max|d|
    / max|y|)."""
    n = x.shape[0]
    ys = [runner.infer(runner.pad(x, r))[:n] for r in FLEET_PARITY_RUNGS]
    equal = all(same_bits(torch, torch.from_numpy(ys[0]),
                          torch.from_numpy(y)) for y in ys[1:])
    worst = max(float(np.abs(y - ys[0]).max() / np.abs(ys[0]).max())
                for y in ys[1:])
    return equal, worst


def solo_rungs(harnesses):
    """Each replica's solo batches (req_id, rows, rung) since its batcher
    began; raises unless each rode the smallest rung of its rows."""
    out = []
    for h in harnesses:
        b = h.server.batcher
        for rid, rows, rung in b.solo_rungs:
            if rung != b.ladder.bucket_for(rows):
                raise AssertionError(f"[fleet:solo] {h.server.replica_id}: "
                                     f"{rows} rows served at rung {rung}")
            out.append((rid, rows, rung))
    return out


def fleet_waves(torch, card, bal, harnesses, cli, requests, refs, paths):
    """Phase 21's canary waves, all but the last under ``parity: true``
    with ``FLEET_PROMOTE_IN_FLIGHT`` requests in flight: a swap to
    ``paths[0]`` (the same weights) promoted, both heartbeats on it, every
    parity probe and its primary served alone at the rung of its rows; a
    swap to ``paths[2]`` (other weights) rolled back for reply parity;
    then a swap to ``paths[1]`` with the canary stalled on every dispatch
    (``FLEET_STALL``), rolled back on its p99, the fleet left on
    ``paths[0]``."""
    from znicz_torch.parallel.chaos import FaultSchedule

    canary = harnesses[0].server.runner
    x = next(r for r in requests if r.shape[0] <= FLEET_PARITY_RUNGS[0])
    parity, worst = rung_parity(torch, canary, x)
    log(f"[fleet:rung_parity] {card}: a {x.shape[0]}-row request at rungs "
        f"{FLEET_PARITY_RUNGS}: "
        + ("bit-equal" if parity else f"not bit-equal (max|d|/max|y| "
           f"{worst:.3e}): parity probes are served alone at the rung of "
           f"their rows (ROADMAP C.9)"))
    solo0 = len(solo_rungs(harnesses))
    t0 = time.perf_counter()
    rep = cli.result(cli._send({"cmd": "swap", "path": paths[0],
                                "parity": True}))
    if not rep.get("ok") or rep.get("canary") != ["r0"]:
        raise AssertionError(f"[fleet:promote] {rep}")
    warm = []

    def promoted():
        roll = bal.stats()["rollover"]
        if not warm and (roll is None or roll["phase"] != "warm_canary"):
            warm.append(time.perf_counter() - t0)
        return bal.rollovers == 1

    served = fleet_drive(cli, requests, refs, promoted, "promoted",
                         "fleet:promote", in_flight=FLEET_PROMOTE_IN_FLIGHT)
    record = bal.rollover_history[-1]
    on_path = fleet_wait(lambda: all(
        m["snapshot_path"] == paths[0] and m["gen"] == 2
        for m in bal.stats()["replicas"]) and bal.member_count() == 2,
        "both heartbeats on the promoted path")
    if record["result"] != "promoted" or not bal.parity_checks \
            or bal.parity_mismatches:
        raise AssertionError(f"[fleet:promote] {record}; parity checks "
                             f"{bal.parity_checks}, mismatches "
                             f"{bal.parity_mismatches}")
    solo = solo_rungs(harnesses)[solo0:]
    if len(solo) < 2 * bal.parity_checks:
        raise AssertionError(f"[fleet:solo] {len(solo)} solo batches for "
                             f"{bal.parity_checks} parity checks")
    rungs = collections.Counter(r for _, _, r in solo)
    log(f"[fleet:promote] {card}: parity true ({bal.parity_checks} probes "
        f"compared, {bal.parity_mismatches} mismatched; {len(solo)} solo "
        f"batches, each at bucket_for(its rows), by rung "
        f"{dict(sorted(rungs.items()))}); canary warm {warm[0]:.3f}s (the "
        f"load and 8 captures, confirmed by heartbeat); wave "
        f"{record['elapsed_s']}s; both heartbeats on the path "
        f"{on_path:.2f}s later; {len(served)} requests served during it, "
        f"{FLEET_PROMOTE_IN_FLIGHT} in flight (slowest, ms on the client's "
        f"clock: {slowest(served)}); record {record}")

    # other weights under parity: the probes mismatch, the wave rolls back
    rollbacks, checks = bal.rollbacks, bal.parity_checks
    rep = cli.result(cli._send({"cmd": "swap", "path": paths[2],
                                "parity": True}))
    if not rep.get("ok") or rep.get("canary") != ["r0"]:
        raise AssertionError(f"[fleet:parity] {rep}")
    served = fleet_drive(cli, requests, None,
                         lambda: bal.rollbacks == rollbacks + 1,
                         "rolled back for parity", "fleet:parity",
                         in_flight=FLEET_PROMOTE_IN_FLIGHT)
    record = bal.rollover_history[-1]
    if record["result"] != "rolled_back" \
            or "reply parity broken" not in record["reason"]:
        raise AssertionError(f"[fleet:parity] {record}")
    fleet_wait(lambda: all(m["snapshot_path"] == paths[0]
                           for m in bal.stats()["replicas"])
               and bal.stats()["fleet_path"] == paths[0],
               "the fleet back on the promoted path after the parity wave")
    log(f"[fleet:parity] {card}: weights x0.75 under parity true: "
        f"{record['result']} after {record['elapsed_s']}s: "
        f"{record['reason']}; {bal.parity_checks - checks} probes compared "
        f"in the wave, {record['parity_mismatches']} mismatched; "
        f"{len(served)} requests served during it")

    with bal._lock:                 # the stalled canary must not be raced
        hedge = bal.knobs["hedge"]
        bal.knobs["hedge"] = False
    seed, p, span = FLEET_STALL
    canary.inject_compute_faults(FaultSchedule(seed, stall=p, stall_s=span))
    try:
        rep = cli.result(cli._send({"cmd": "swap", "path": paths[1],
                                    "parity": False}))
        if not rep.get("ok") or rep.get("canary") != ["r0"]:
            raise AssertionError(f"[fleet:rollback] {rep}")
        rollbacks = bal.rollbacks
        served = fleet_drive(cli, requests, refs,
                             lambda: bal.rollbacks == rollbacks + 1,
                             "rolled back", "fleet:rollback")
    finally:
        canary.inject_compute_faults(None)
        with bal._lock:
            bal.knobs["hedge"] = hedge
    record = bal.rollover_history[-1]
    if record["result"] != "rolled_back" or "p99" not in record["reason"] \
            or record["canary_p99_ms"] is None:
        raise AssertionError(f"[fleet:rollback] {record}")
    fleet_wait(lambda: all(m["snapshot_path"] == paths[0] and m["gen"] == 2
                           for m in bal.stats()["replicas"])
               and bal.stats()["fleet_path"] == paths[0],
               "the fleet back on the promoted path")
    log(f"[fleet:rollback] {card}: canary stalled {span[0]:g}s a dispatch "
        f"({canary.stalls} stalls): {record['result']} after "
        f"{record['elapsed_s']}s: {record['reason']}; canary p99 "
        f"{record['canary_p99_ms']} ms over {record['canary_samples']} "
        f"replies against {record['old_p99_ms']} ms over "
        f"{record['old_samples']}; {len(served)} requests served during it, "
        f"one at a time (slowest {slowest(served)}); the fleet on "
        f"{os.path.basename(paths[0])}, generation 2")


def fleet_heal(card, bal, harnesses, cli, requests, refs, path):
    """Phase 21's heal: ``r1`` killed and restarted with its boot snapshot
    (a fresh init: generation 1's weights, path ""); the balancer swaps it
    onto the fleet path (``heals`` >= 1), and its replies then match the
    promoted generation's forward."""
    heals = bal.heals
    t0 = time.perf_counter()
    harnesses[1].kill()
    harnesses[1].restart()
    boot = time.perf_counter() - t0
    endpoint = harnesses[1].server.endpoint

    def healed():
        m = fleet_member(bal, "r1")
        return m is not None and m["endpoint"] == endpoint and \
            m["snapshot_path"] == path and m["ready"] and \
            not m["swapping"] and bal.heals > heals

    took = fleet_wait(healed, "r1 healed")
    from_r1 = []
    fleet_drive(cli, requests, refs, lambda: len(from_r1) >= 4,
                "4 replies from r1", "fleet:heal",
                on_reply=lambda rep: from_r1.append(rep)
                if rep["replica_id"] == "r1" else None)
    gens = {rep["gen"] for rep in from_r1}
    if gens != {2}:
        raise AssertionError(f"[fleet:heal] r1 replied at generations "
                             f"{gens}")
    log(f"[fleet:heal] {card}: r1 restarted with its boot snapshot in "
        f"{boot:.2f}s (8 captures), healed onto "
        f"{os.path.basename(path)} {took:.2f}s later (heals "
        f"{bal.heals}); its replies at generation 2 within SERVE_TOL")


# -- phase 22: the build cache: cold, warm, refused and healed boots ----------

#: phase 22: the rows of the batches each boot answers (each at its rung)
AOT_ROWS = (1, 5, 16, 128)
#: phase 22: the most one boot's child process may take (s)
AOT_CHILD_TIMEOUT_S = 400
#: phase 22: the sample shape and classes of the served AlexNet
AOT_SHAPE, AOT_CLASSES = (227, 227, 3), 1000
#: phase 22: the library whose entry the refusal boot finds truncated
AOT_TRUNCATED = "bias_relu"


def aot_child(spec: dict) -> dict:
    """One boot of phase 22, in a process of its own: full-width AlexNet
    under ``fused`` served from ``spec["snapshot"]`` by an
    ``InferenceServer`` with the build cache on (``spec["aot_dir"]``),
    its kernel libraries built into the empty ``spec["build_dir"]``;
    the batches of ``AOT_ROWS`` answered at their rungs and saved to
    ``spec["out"]``; with ``spec["swap"]`` a swap to that snapshot after.
    Returns what the parent checks."""
    from pathlib import Path

    import torch

    from znicz_torch import _build
    from znicz_torch.core.config import root
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.serving import InferenceServer

    _build.BUILD_DIR = Path(spec["build_dir"])
    root.common.engine.fused_elementwise = True
    root.common.engine.fused_tail = True
    root.common.serving.aot_cache.enabled = True
    root.common.serving.aot_cache.dir = spec["aot_dir"]
    ctrs = counters()
    wf = AlexNetWorkflow(sample_shape=AOT_SHAPE, n_classes=AOT_CLASSES,
                         device=spec.get("device"))
    srv = InferenceServer(wf, snapshot=spec["snapshot"], max_batch=BATCH,
                          max_delay_ms=1.0).start()
    ready_s = time.time() - spec["t_spawn"]
    runner, ladder = srv.runner, srv.batcher.ladder
    launches = {n: fn.launches for n, fn in ctrs.items() if fn.launches}
    rng = np.random.default_rng(SEED)
    ys = []
    for n in AOT_ROWS:
        x = rng.normal(size=(n,) + AOT_SHAPE).astype(np.float32)
        ys.append(runner.infer(runner.pad(x, ladder.bucket_for(n)))[:n])
    compiles = runner.compiles
    out = {"ready_s": ready_s, "boot_to_ready_s": srv.boot_to_ready_s,
           "report": srv.warm_report, "nvcc_runs": _build.nvcc_runs,
           "origins": dict(_build.origins),
           "cache": runner._aot_cache.stats(),
           "entries": {n: runner._aot_cache.path(_build.library_entry(n))
                       for n in runner.kernels},
           "heartbeat": {k: srv.heartbeat_payload()[k] for k in
                         ("warm_source", "warm_hits", "warm_misses")},
           "launches": launches, "traffic_compiles": compiles
           - srv.warm_report["compiles"]}
    if spec.get("swap"):
        n0 = _build.nvcc_runs
        t0 = time.perf_counter()
        runner.swap(spec["swap"], ladder)
        out["swap"] = {"s": time.perf_counter() - t0,
                       "nvcc_runs": _build.nvcc_runs - n0,
                       "generation": runner.generation,
                       "graphs": runner.graph_cache_size()}
    srv.stop()
    np.savez(spec["out"], *ys)
    torch.cuda.synchronize()
    return out


def aot_boot(tag: str, spec: dict) -> dict:
    """Run :func:`aot_child` for ``spec`` as ``python3 chip_smoke.py
    --aot-child``; its result, with the boot's batches as ``ys``."""
    spec = dict(spec, out=spec["out"] + f"_{tag}.npz",
                build_dir=spec["build_dir"] + f"_{tag}", t_spawn=time.time())
    os.makedirs(spec["build_dir"])
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--aot-child",
         json.dumps(spec)], capture_output=True, text=True,
        timeout=AOT_CHILD_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"[aot:{tag}] boot failed (rc "
                             f"{proc.returncode}): {proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    with np.load(spec["out"]) as z:
        out["ys"] = [z[f"arr_{i}"] for i in range(len(AOT_ROWS))]
    return out


def aot_phase(torch, card):
    """Phase 22: the build cache (``serving/aot_cache.py``).  A full-width
    AlexNet snapshot is saved; four boots follow, each in a child process
    whose kernel build directory starts empty, each serving it under
    ``fused`` with ``aot_cache/`` beside the snapshot: cold (the
    libraries built by ``nvcc`` and stored), warm (every library loaded
    from the cache, zero ``nvcc`` runs, ``warm_source`` ``cache_hit``,
    the proof holding with 8 captures, the batches' answers bit-equal to
    the cold boot's, and a swap that runs no ``nvcc``), refused (the
    ``AOT_TRUNCATED`` entry cut short: refused, rebuilt and stored over)
    and healed (every library from the cache again).  Returns {path:
    {kernel: launches}} of the warm boot's warmup."""
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.snapshotter import write_host_pickle

    tmp = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    try:
        t_phase = time.perf_counter()
        wf = alexnet_served(torch)
        tree = {name: {k: t.cpu().numpy() for k, t in leaves.items()}
                for name, leaves in
                ModelRunner(wf, capture=False)._active.tree.items()}
        snaps = os.path.join(tmp, "snapshots")
        os.makedirs(snaps)
        paths = [os.path.join(snaps, f"alexnet_{tag}.pickle")
                 for tag in ("served", "swapped")]
        for path in paths:
            write_host_pickle(path, {"units": tree, "velocities": {},
                                     "epoch": 1}, compression="none")
        del wf, tree
        torch.cuda.empty_cache()
        spec = {"snapshot": paths[0], "aot_dir":
                os.path.join(snaps, "aot_cache"),
                "build_dir": os.path.join(tmp, "kernels"),
                "out": os.path.join(tmp, "ys")}
        cold = aot_boot("cold", spec)
        n_libs = len(cold["report"]["kernels"])
        rungs = cold["report"]["expected"]
        if not (cold["report"]["ok"] and n_libs >= 2
                and cold["nvcc_runs"] == n_libs
                and cold["cache"]["stores"] == n_libs
                and cold["report"]["warm_source"] == "compiled"
                and cold["report"]["compiles"] == rungs):
            raise AssertionError(f"[aot:cold] {cold['report']}, nvcc "
                                 f"{cold['nvcc_runs']}, {cold['cache']}")
        warm = aot_boot("warm", dict(spec, swap=paths[1]))
        rep = warm["report"]
        if not (rep["ok"] and warm["nvcc_runs"] == 0
                and rep["warm_source"] == "cache_hit"
                and rep["cache_hits"] == n_libs
                and rep["compiles"] == rep["graph_cache_size"] == rungs
                and warm["traffic_compiles"] == 0
                and warm["swap"]["nvcc_runs"] == 0
                and warm["heartbeat"]["warm_source"] == "cache_hit"):
            raise AssertionError(f"[aot:warm] {rep}, nvcc "
                                 f"{warm['nvcc_runs']}, swap "
                                 f"{warm['swap']}, {warm['heartbeat']}")
        for n, a, b in zip(AOT_ROWS, cold["ys"], warm["ys"]):
            if not same_bits(torch, torch.from_numpy(a), torch.from_numpy(b)):
                raise AssertionError(f"[aot:warm] the {n}-row batch's "
                                     f"answer differs from the cold boot's")
        entry = cold["entries"][AOT_TRUNCATED]
        with open(entry, "rb") as f:
            data = f.read()
        with open(entry, "wb") as f:
            f.write(data[:len(data) // 2])
        refused = aot_boot("refused", spec)
        rep = refused["report"]
        if not (rep["ok"] and rep["cache_refusals"] == 1
                and refused["nvcc_runs"] == 1
                and refused["origins"].get(AOT_TRUNCATED) == "nvcc"
                and rep["warm_source"] == "mixed"
                and os.path.getsize(entry) == len(data)):
            raise AssertionError(f"[aot:refused] {rep}, nvcc "
                                 f"{refused['nvcc_runs']}, "
                                 f"{refused['origins']}")
        healed = aot_boot("healed", spec)
        rep = healed["report"]
        if not (rep["ok"] and healed["nvcc_runs"] == 0
                and rep["warm_source"] == "cache_hit"):
            raise AssertionError(f"[aot:healed] {rep}")
        for tag, boot in (("refused", refused), ("healed", healed)):
            for n, a, b in zip(AOT_ROWS, cold["ys"], boot["ys"]):
                if not same_bits(torch, torch.from_numpy(a),
                                 torch.from_numpy(b)):
                    raise AssertionError(f"[aot:{tag}] the {n}-row batch "
                                         f"differs from the cold boot's")
        for tag, boot in (("cold", cold), ("warm", warm),
                          ("refused", refused), ("healed", healed)):
            rep = boot["report"]
            log(f"[aot:{tag}] {card}: process start to ready "
                f"{boot['ready_s']:.3f}s, serve() to ready "
                f"{boot['boot_to_ready_s']:.3f}s; libraries "
                f"{boot['origins']}; nvcc runs {boot['nvcc_runs']}; "
                f"warm_source {rep['warm_source']}; hits "
                f"{rep['cache_hits']} misses {rep['cache_misses']} "
                f"refusals {rep['cache_refusals']}; {rep['compiles']} "
                f"captures (graph family {rep['graph_cache_size']}); proof "
                f"ok {rep['ok']}; warmup launches {boot['launches']}")
        log(f"[aot:warm] swap to a second snapshot: {warm['swap']}; the "
            f"{len(AOT_ROWS)} batches ({AOT_ROWS} rows) bit-equal across "
            f"the four boots; phase {time.perf_counter() - t_phase:.1f}s")
        return {"aot:warm_boot": warm["launches"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 23: the master/slave star ----------------------------------------

#: phase 23: full-width AlexNet under ``fused``: 4 train minibatches of
#: 128 (the last the epoch tail) and one valid minibatch, one epoch
STAR_CFG = {"minibatch_size": BATCH, "n_train": 4 * BATCH,
            "n_valid": BATCH, "n_test": 0, "n_classes": 1000,
            "image_size": 227}
#: phase 23: the jobs of an epoch (one eval job, 4 train jobs)
STAR_JOBS = 5
#: phase 23 (a): the master's tree after the slave's 4 train jobs against
#: one FusedTrainer's 4 steps: per leaf, max|d| <= STAR_RTOL * max|w|
#: (float32: the delta's round trip through the wire and the master's add)
STAR_RTOL = 1e-6
#: phase 23 (b, c): the reap timeout (s): past the slowest job (its
#: first, which captures), so only the dead slave's job is reaped
STAR_JOB_TIMEOUT_S = 10.0
#: phase 23 (d): CIFAR10 on the unit engine under ``pallas_lrn``
STAR_CIFAR = {"n_train": 200, "n_valid": 100, "n_test": 0,
              "minibatch_size": 100}
#: phase 23: the most any state the phase waits for may take (s)
STAR_WAIT_S = 300.0


#: phases 23-24: the images :func:`star_workflow`'s loaders read, drawn
#: once a process: {"dir": the directory, (n, size): .npz path}
_STAR_DATA: dict = {"dir": None}


def star_dataset(cfg) -> str:
    """The .npz of ``cfg``'s images and labels, drawn from ``SEED`` as
    the loader draws them, once a process: the AlexNet builds of phases
    23 and 24 read it (the loader's ``data_path``) instead of drawing the
    textures again, seconds of host time a build."""
    from znicz_torch import datasets
    from znicz_torch.core import prng

    key = (cfg["n_train"] + cfg["n_valid"] + cfg["n_test"],
           cfg["image_size"])
    if key not in _STAR_DATA:
        if _STAR_DATA["dir"] is None:
            _STAR_DATA["dir"] = tempfile.mkdtemp(prefix="chip_smoke_data_")
        prng.reset(SEED)
        data, labels = datasets.tinyimages(key[0], size=key[1])
        path = os.path.join(_STAR_DATA["dir"], f"{key[0]}x{key[1]}.npz")
        np.savez(path, data=data, labels=labels)
        _STAR_DATA[key] = path
    return _STAR_DATA[key]


def star_workflow(torch, cfg=None):
    """Phase 23's AlexNet (``cfg``, default ``STAR_CFG``), its streams
    reset to ``SEED``: every call gives the same weights and data (the
    images from :func:`star_dataset`, unless ``cfg`` names a
    ``data_path``)."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples.alexnet import training_workflow

    cfg = dict(cfg or STAR_CFG)
    if not cfg.get("data_path"):
        cfg["data_path"] = star_dataset(cfg)
    root.alexnet.loader.update(cfg)
    root.alexnet.decision.max_epochs = 1
    prng.reset(SEED)
    return no_snapshots(training_workflow())


def star_run(server, slaves, doomed=None):
    """Run ``slaves`` on threads against the started ``server`` (after a
    slave of ``doomed``'s workflow took a job and died, when given), and
    join them all; returns the dead slave's job id."""
    from znicz_torch.parallel.chaos import take_job_and_die

    errors = []

    def work(s):
        try:
            s.run()
        except BaseException as exc:
            errors.append(repr(exc))
            raise

    threads = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in slaves]
    for t in threads:
        t.start()
    jid = None
    if doomed is not None:
        jid = take_job_and_die(server.endpoint, doomed, "doomed")
    if not server.join(STAR_WAIT_S):
        raise AssertionError("[master] the master never finished")
    for t in threads:
        t.join(STAR_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"[master] slaves failed: {errors}")
    return jid


def star_tree(wf):
    from znicz_torch.weights import params_to_numpy

    return params_to_numpy(wf)


def master_phase(torch, card):
    """Phase 23: the master/slave star (``server.Server``,
    ``client.FusedClient``/``Client``) on the card, every socket on
    ``tcp://127.0.0.1:*``: :func:`star_one_slave`, :func:`star_two_slaves`
    and :func:`star_lrn`.  Returns {path: {kernel: launches}}."""
    t_phase = time.perf_counter()
    out = {"master:fused": star_one_slave(torch, card)}
    torch.cuda.empty_cache()
    star_two_slaves(torch, card)
    torch.cuda.empty_cache()
    out["master:units_pallas_lrn"] = star_lrn(torch, card)
    log(f"[master] phase {time.perf_counter() - t_phase:.1f}s")
    return out


def star_one_slave(torch, card):
    """Phase 23 (a): a master and one ``FusedClient`` slave on full-width
    AlexNet (float32, ``fused``, ``job_prefetch`` off, ``job_segment`` 1,
    a float32 wire) for an epoch: its 4 train jobs leave the master's
    tree within ``STAR_RTOL`` of one ``FusedTrainer`` taking the same 4
    steps on the same minibatches, K1/K1b/K2/K2b launched 2/2/3/3 a train
    job and 2/0/3/0 an eval job; the seconds a job, the bytes an update
    each way and the master's apply time logged.  Returns {kernel:
    launches}."""
    from znicz_torch.client import FusedClient
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.server import Server

    ctrs = counters()
    with engine_knobs(**FUSED_KNOBS, job_prefetch=False, job_segment=1,
                      wire_dtype="float32"):
        master_wf, slave_wf, ref_wf = (star_workflow(torch)
                                       for _ in range(3))
        server = Server(master_wf, job_timeout=STAR_WAIT_S)
        jobs = []
        handle = server._handle

        def logged(req):
            rep = handle(req)
            if "job" in rep:
                jobs.append(rep["job"])
            return rep

        server._handle = logged
        applies = []
        apply = server.apply_deltas

        def timed(deltas, scale=1.0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply(deltas, scale)
            torch.cuda.synchronize()
            applies.append(time.perf_counter() - t0)

        server.apply_deltas = timed
        slave = FusedClient(slave_wf, endpoint="", slave_id="s0")
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        server.start()
        slave.endpoint = server.endpoint
        star_run(server, [slave])
        launches = {n: fn.launches for n, fn in ctrs.items()}
        train_jobs = [j for j in jobs if j["class"] == 2]
        n_train = len(train_jobs)
        if n_train != 4 or len(jobs) != STAR_JOBS \
                or not bool(master_wf.decision.complete):
            raise AssertionError(f"[master:a] {len(jobs)} jobs, "
                                 f"{n_train} train")
        want = {"fused_block_fwd": 2 * STAR_JOBS,
                "fused_block_bwd": 2 * n_train,
                "bias_relu_fwd": 3 * STAR_JOBS,
                "bias_relu_bwd": 3 * n_train}
        got = {n: launches[n] for n in want}
        if got != want:
            raise AssertionError(f"[master:a] launches {got}, want {want}")
        ref = FusedTrainer(ref_wf)
        for step, job in enumerate(train_jobs):
            ref.train_step(np.asarray(job["indices"]), int(job["size"]),
                           step)
        got_tree, want_tree = star_tree(master_wf), star_tree(ref_wf)
        worst, where = 0.0, ""
        for name, leaves in want_tree.items():
            for k, w in leaves.items():
                e = float(np.abs(got_tree[name][k] - w).max()
                          / max(np.abs(w).max(), 1e-30))
                if e >= worst:
                    worst, where = e, f"{name}.{k}"
        if worst > STAR_RTOL:
            raise AssertionError(f"[master:a] the master's tree is "
                                 f"{worst:.3e} from one process's at "
                                 f"{where} (tol {STAR_RTOL:g})")
        updates = server.updates_received
        log(f"[master:a] {card}: one FusedClient slave, {len(jobs)} jobs "
            f"({n_train} train): the master's tree vs one FusedTrainer's "
            f"{n_train} steps max|d|/max|w| {worst:.3e} at {where} (tol "
            f"{STAR_RTOL:g}); launches {got} (2/2/3/3 a train job, 2/0/3/0 "
            f"an eval job); seconds a job "
            f"{['%.4f' % s for s in slave.job_seconds]}; bytes an update "
            f"in {server.update_bytes_in / max(updates, 1):.0f} (message), "
            f"params out a job "
            f"{server.tensor_bytes_wire_out / max(len(jobs), 1):.0f} "
            f"(tensor frames); the master's apply "
            f"{['%.4f' % s for s in applies]} s")
    return launches


def star_two_slaves(torch, card):
    """Phase 23 (b, c): two ``FusedClient`` slaves and a slave that takes
    a job and dies (``take_job_and_die``) finish an epoch behind a quorum
    of 3: both slaves took jobs, ``jobs_done == sum(jobs_by_slave) ==
    STAR_JOBS``, the dead slave's job re-queued and done once, the ledger
    balanced."""
    from znicz_torch.client import FusedClient
    from znicz_torch.server import Server

    with engine_knobs(**FUSED_KNOBS, min_slaves=3):
        master_wf = star_workflow(torch)
        server = Server(master_wf, job_timeout=STAR_JOB_TIMEOUT_S)
        slaves = [FusedClient(star_workflow(torch), endpoint="",
                              slave_id=f"s{i}") for i in range(2)]
        server.start()
        for s in slaves:
            s.endpoint = server.endpoint
        t0 = time.perf_counter()
        jid = star_run(server, slaves, doomed=master_wf)
        wall = time.perf_counter() - t0
        ledger = server.jobs_ledger()
        by_slave = dict(server.jobs_by_slave)
        if not (jid is not None and jid not in server._inflight
                and server.jobs_requeued >= 1
                and by_slave.get("doomed", 0) == 0
                and all(by_slave.get(f"s{i}", 0) > 0 for i in range(2))
                and server.jobs_done == sum(by_slave.values()) == STAR_JOBS
                and ledger["balanced"]
                and bool(master_wf.decision.complete)):
            raise AssertionError(f"[master:b] jobs by slave {by_slave}, "
                                 f"requeued {server.jobs_requeued}, "
                                 f"ledger {ledger}")
        STAR_BYTES.update(update_bytes_in=server.update_bytes_in,
                          updates=server.updates_received,
                          jobs=server.jobs_done)
        log(f"[master:b] {card}: two FusedClient slaves and one that took "
            f"job {jid} and died: jobs by slave {by_slave}, the lost job "
            f"re-queued ({server.jobs_requeued}) and done once; ledger "
            f"{ledger}; the epoch in {wall:.2f}s (a reap window of "
            f"{STAR_JOB_TIMEOUT_S:g}s)")


def star_lrn(torch, card):
    """Phase 23 (d): CIFAR10 on the unit engine under ``pallas_lrn``: a
    master and a ``Client`` slave for an epoch, K3 launched twice a train
    job and once an eval job, K3b once a train job.  Returns {kernel:
    launches}."""
    from znicz_torch.client import Client
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import cifar
    from znicz_torch.server import Server

    ctrs = counters()
    root.cifar.loader.update(STAR_CIFAR)
    root.cifar.decision.max_epochs = 1
    with engine_knobs(pallas_lrn=True):
        prng.reset(SEED)
        master_wf = cifar.CifarWorkflow()
        prng.reset(SEED)
        slave = Client(cifar.CifarWorkflow(), endpoint="", slave_id="u0")
        server = Server(master_wf, job_timeout=STAR_WAIT_S)
        for fn in ctrs.values():
            fn.launches = 0
        server.start()
        slave.endpoint = server.endpoint
        star_run(server, [slave])
        launches = {n: fn.launches for n, fn in ctrs.items()}
        n_train = STAR_CIFAR["n_train"] // STAR_CIFAR["minibatch_size"]
        n_eval = STAR_CIFAR["n_valid"] // STAR_CIFAR["minibatch_size"]
        want = {"lrn_fwd": 2 * n_train + n_eval, "lrn_bwd": n_train}
        if {n: launches[n] for n in want} != want \
                or server.jobs_done != n_train + n_eval:
            raise AssertionError(f"[master:d] launches {launches}, jobs "
                                 f"{server.jobs_done}, want {want}")
        log(f"[master:d] {card}: CIFAR10 on a unit-engine Client under "
            f"pallas_lrn: {server.jobs_done} jobs, K3/K3b launches {want}; "
            f"seconds a job {['%.4f' % s for s in slave.job_seconds]}; "
            f"valid err% "
            f"{master_wf.decision.epoch_metrics[1]['err_pct']:.2f}")
    return launches


# -- phase 24: the relay tree and the meshed slave ---------------------------

#: phase 24 (c): the meshed slave's epoch: 2 train minibatches of 128 (the
#: second the tail) and one valid minibatch, within phase 16's short run
TREE_MESH_CFG = dict(STAR_CFG, n_train=2 * BATCH)
#: phase 24 (c): the meshed slave's (data, model) shape: two gloo ranks
TREE_MESH_SHAPE = (2, 1)
#: phase 24 (c): the most the meshed tree's distance from one trainer's
#: may be, as a share of what that trainer moved the leaves (phase 16's
#: short runs read at most 0.06 on an H100; a zero delta reads 1)
TREE_MESH_SHARE = 0.2
#: phase 24 (b): the children's link to the relay killed mid-epoch: a
#: 4-s receive, one reconnect, then the fallback to the master
TREE_FALLBACK = dict(recv_timeout=4.0, max_reconnects=1, backoff_base=0.05,
                     backoff_cap=0.2)
#: phase 24 (b): the reap window (s) of the epoch whose relay is killed:
#: past the slowest job through the relay (two first jobs capturing in
#: turns), so the reaper takes back the jobs the dead relay held
TREE_REAP_S = 6.0
#: phase 24 (b): the relay's flush window (s).  Slaves of one process take
#: the card in turns, so a sibling's update comes a job's steps later
#: than the first's: the window waits for it
TREE_FLUSH_S = 2.0
#: phase 23 (b)'s star, for phase 24 (b)'s bytes into the master
STAR_BYTES: dict = {}


def tree_master(torch, cfg, **kw):
    """A ``Server`` on phase 23's AlexNet (``cfg``) whose dispatched jobs
    are logged in order; returns (server, jobs)."""
    from znicz_torch.server import Server

    server = Server(star_workflow(torch, cfg), **kw)
    jobs = []
    handle = server._handle

    def logged(req):
        rep = handle(req)
        jobs.extend(e["job"] for e in rep.get("jobs", ()))
        if "job" in rep:
            jobs.append(rep["job"])
        return rep

    server._handle = logged
    return server, jobs


def tree_reference(torch, jobs, cfg):
    """The tree of one ``FusedTrainer`` taking the train ``jobs`` in order
    from phase 23's start (``cfg``)."""
    from znicz_torch.parallel.fused import FusedTrainer

    wf = star_workflow(torch, cfg)
    ref = FusedTrainer(wf)
    for step, job in enumerate(j for j in jobs if j["class"] == 2):
        ref.train_step(np.asarray(job["indices"]), int(job["size"]), step)
    return star_tree(wf)


def tree_launches(launches, jobs, what, factor=1):
    """K1/K1b/K2/K2b against 2/2/3/3 a train job and 2/0/3/0 an eval job
    (times ``factor`` ranks or slaves that each ran every job); returns
    the four counts."""
    n_train = sum(1 for j in jobs if j["class"] == 2)
    want = {"fused_block_fwd": 2 * len(jobs) * factor,
            "fused_block_bwd": 2 * n_train * factor,
            "bias_relu_fwd": 3 * len(jobs) * factor,
            "bias_relu_bwd": 3 * n_train * factor}
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"[tree:{what}] launches {got}, want {want}")
    return got


def tree_phase(torch, card):
    """Phase 24: the relay tree (``parallel/relay.py``) and the meshed
    slave on the card, every socket on ``tcp://127.0.0.1:*``:
    :func:`tree_one_slave`, :func:`tree_two_slaves`,
    :func:`tree_relay_kill` and :func:`tree_meshed`.  Returns {path:
    {kernel: launches}}."""
    t_phase = time.perf_counter()
    # the slaves' workflows serve (a), (b) and the kill in turn: a job
    # overwrites every parameter from the master's payload, and (a), which
    # needs the velocities zero, comes first
    slave_wfs = [star_workflow(torch) for _ in range(2)]
    out = {"tree:one": tree_one_slave(torch, card, slave_wfs[0])}
    torch.cuda.empty_cache()
    out["tree:two"] = tree_two_slaves(torch, card, slave_wfs)
    torch.cuda.empty_cache()
    out["tree:kill"] = tree_relay_kill(torch, card, slave_wfs)
    del slave_wfs
    torch.cuda.empty_cache()
    out["tree:mesh"] = tree_meshed(torch, card)
    torch.cuda.empty_cache()
    log(f"[tree] phase {time.perf_counter() - t_phase:.1f}s")
    return out


def tree_one_slave(torch, card, slave_wf):
    """Phase 24 (a): phase 23 (a) with a ``Relay`` between the master and
    the ``FusedClient`` (float32 wire, fanout 1: a job a fetch, a flush an
    update): the master's tree within ``STAR_RTOL`` of one
    ``FusedTrainer`` taking the same 4 steps (one contribution passes the
    relay byte for byte), K1/K1b/K2/K2b 2/2/3/3 a train job; the bytes
    into the master and through the relay.  Returns {kernel: launches}."""
    from znicz_torch.client import FusedClient
    from znicz_torch.parallel.relay import Relay

    ctrs = counters()
    with engine_knobs(**FUSED_KNOBS, job_prefetch=False, job_segment=1,
                      wire_dtype="float32"):
        server, jobs = tree_master(torch, STAR_CFG, job_timeout=STAR_WAIT_S)
        slave = FusedClient(slave_wf, endpoint="", slave_id="s0")
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        server.start()
        relay = Relay(server.endpoint, "tcp://127.0.0.1:*", relay_id="r0",
                      fanout=1).start()
        slave.endpoint = relay.endpoint
        try:
            star_run(server, [slave])
        finally:
            relay.stop()
        launches = {n: fn.launches for n, fn in ctrs.items()}
        if len(jobs) != STAR_JOBS or not bool(server.decision.complete) \
                or server.aggregated_updates != STAR_JOBS \
                or server.jobs_by_slave != {"s0": STAR_JOBS}:
            raise AssertionError(f"[tree:a] {len(jobs)} jobs, aggregated "
                                 f"{server.aggregated_updates}, by slave "
                                 f"{server.jobs_by_slave}")
        got = tree_launches(launches, jobs, "a")
        want_tree = tree_reference(torch, jobs, STAR_CFG)
        got_tree = star_tree(server.workflow)
        worst, where = 0.0, ""
        for name, leaves in want_tree.items():
            for k, w in leaves.items():
                e = float(np.abs(got_tree[name][k] - w).max()
                          / max(np.abs(w).max(), 1e-30))
                if e >= worst:
                    worst, where = e, f"{name}.{k}"
        if worst > STAR_RTOL:
            raise AssertionError(f"[tree:a] the master's tree is "
                                 f"{worst:.3e} from one process's at "
                                 f"{where} (tol {STAR_RTOL:g})")
        st = relay.stats()
        log(f"[tree:a] {card}: one FusedClient behind a relay (fanout 1, "
            f"float32 wire), {len(jobs)} jobs: the master's tree vs one "
            f"FusedTrainer's max|d|/max|w| {worst:.3e} at {where} (tol "
            f"{STAR_RTOL:g}); launches {got}; seconds a job "
            f"{['%.4f' % s for s in slave.job_seconds]}; the master's "
            f"bytes_in {server.bytes_in} (updates {server.update_bytes_in} "
            f"in {server.updates_received} messages), bytes_out "
            f"{server.bytes_out}; the relay's bytes_in {st['bytes_in']}, "
            f"bytes_out {st['bytes_out']}, flushes {st['flushes']}")
    return launches


def tree_two_slaves(torch, card, slave_wfs):
    """Phase 24 (b): two ``FusedClient`` slaves behind one relay (fanout
    2) for an epoch: the master applied aggregated updates (fewer update
    messages than jobs), ``jobs_by_slave`` holds the leaf ids alone, the
    ledger balanced; the master's update bytes against phase 23 (b)'s
    two-slave star.  Returns {kernel: launches}."""
    from znicz_torch.client import FusedClient
    from znicz_torch.parallel.relay import Relay

    ctrs = counters()
    with engine_knobs(**FUSED_KNOBS):
        server, jobs = tree_master(torch, STAR_CFG, job_timeout=STAR_WAIT_S)
        slaves = [FusedClient(wf, endpoint="", slave_id=f"s{i}")
                  for i, wf in enumerate(slave_wfs)]
        for fn in ctrs.values():
            fn.launches = 0
        server.start()
        relay = Relay(server.endpoint, "tcp://127.0.0.1:*", relay_id="r0",
                      fanout=2, flush_s=TREE_FLUSH_S).start()
        for s in slaves:
            s.endpoint = relay.endpoint
        t0 = time.perf_counter()
        try:
            star_run(server, slaves)
        finally:
            relay.stop()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in ctrs.items()}
        ledger = server.jobs_ledger()
        by_slave = dict(server.jobs_by_slave)
        if not (server.aggregated_updates >= 1
                and server.updates_received < server.jobs_done
                and set(by_slave) <= {"s0", "s1"}
                and server.jobs_done == sum(by_slave.values()) == STAR_JOBS
                and ledger["balanced"]
                and bool(server.decision.complete)):
            raise AssertionError(f"[tree:b] aggregated "
                                 f"{server.aggregated_updates}, updates "
                                 f"{server.updates_received}, jobs by slave "
                                 f"{by_slave}, ledger {ledger}")
        got = tree_launches(launches, jobs, "b")
        star = (f"{STAR_BYTES['update_bytes_in']} B in "
                f"{STAR_BYTES['updates']} messages for "
                f"{STAR_BYTES['jobs']} jobs" if STAR_BYTES
                else "not run in this call")
        st = relay.stats()
        log(f"[tree:b] {card}: two FusedClient slaves behind a relay "
            f"(fanout 2): jobs by slave {by_slave}, {server.jobs_done} jobs "
            f"in {server.updates_received} update messages "
            f"({server.aggregated_updates} aggregated); the master's update "
            f"bytes {server.update_bytes_in} against phase 23 (b)'s star "
            f"{star}; the relay's bytes_in {st['bytes_in']}, bytes_out "
            f"{st['bytes_out']}, flushes {st['flushes']}, contributions "
            f"{st['contributions']}; launches {got}; ledger {ledger}; the "
            f"epoch in {wall:.2f}s")
    return launches


def tree_relay_kill(torch, card, slave_wfs):
    """Phase 24 (b), the kill: the same slaves behind a ``RelayHarness`` of
    fanout 3, killed while it holds a fetched job no child took: the
    children fall back to the master it advertised (two receives of
    ``TREE_FALLBACK``) and re-send their updates there, the reaper
    re-queues the lost job (``TREE_REAP_S``), the epoch completes and the
    ledger balances.  Returns {kernel: launches}."""
    from znicz_torch.client import FusedClient
    from znicz_torch.parallel.chaos import RelayHarness

    ctrs = counters()
    with engine_knobs(**FUSED_KNOBS):
        server, _ = tree_master(torch, STAR_CFG, job_timeout=TREE_REAP_S)
        slaves = [FusedClient(wf, endpoint="", slave_id=f"k{i}")
                  for i, wf in enumerate(slave_wfs)]
        for fn in ctrs.values():
            fn.launches = 0
        server.start()
        # fanout 3 with two children: each fetch leaves a job queued
        harness = RelayHarness(server.endpoint, "tcp://127.0.0.1:*",
                               relay_id="doomed", fanout=3,
                               flush_s=TREE_FLUSH_S)
        harness.start()
        for s in slaves:
            s.endpoint = harness.endpoint
        errors = []

        def work(s):
            try:
                s.run(**TREE_FALLBACK)
            except BaseException as exc:
                errors.append(repr(exc))
                raise

        threads = [threading.Thread(target=work, args=(s,), daemon=True)
                   for s in slaves]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # the kill comes while the relay holds a fetched job no child has
        # taken: that job dies with it, and the reaper must bring it back
        # (the jobs the children compute come back as their updates,
        # re-sent to the master after the fallback)
        t_kill = fleet_wait(lambda: harness.relay.queue_depth >= 1,
                            "[tree:kill] a job queued at the relay",
                            STAR_WAIT_S)
        done_at_kill = server.jobs_done
        harness.kill()
        if not server.join(STAR_WAIT_S):
            raise AssertionError("[tree:kill] the master never finished")
        for t in threads:
            t.join(STAR_WAIT_S)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"[tree:kill] slaves failed: {errors}")
        launches = {n: fn.launches for n, fn in ctrs.items()}
        ledger = server.jobs_ledger()
        by_slave = dict(server.jobs_by_slave)
        if not (all(s.endpoint == server.endpoint for s in slaves)
                and server.jobs_requeued >= 1
                and set(by_slave) <= {"k0", "k1"}
                and server.jobs_done == sum(by_slave.values()) == STAR_JOBS
                and ledger["balanced"]
                and bool(server.decision.complete)):
            raise AssertionError(f"[tree:kill] endpoints "
                                 f"{[s.endpoint for s in slaves]}, "
                                 f"requeued {server.jobs_requeued}, by slave "
                                 f"{by_slave}, ledger {ledger}")
        log(f"[tree:kill] {card}: the relay (fanout 3) killed {t_kill:.2f}s "
            f"in, a job queued, {done_at_kill} done: both children fell back "
            f"to the master "
            f"(reconnects {[s.reconnects for s in slaves]}), re-queued "
            f"{server.jobs_requeued}, jobs by slave {by_slave}, "
            f"{server.aggregated_updates} aggregated and "
            f"{server.updates_received - server.aggregated_updates} direct "
            f"updates; ledger {ledger}; the epoch in {wall:.2f}s (receive "
            f"{TREE_FALLBACK['recv_timeout']:g}s, reap window "
            f"{TREE_REAP_S:g}s); launches "
            f"{ {n: launches[n] for n in KERNELS if launches[n]} }")
    return launches


def tree_mesh_rank(rank, world, store, tmp, endpoint, cfg):
    """One rank of phase 24 (c) (a spawned process): joins the gloo group
    on the card, builds phase 23's AlexNet of ``cfg`` (``TREE_MESH_CFG``,
    its images read from the parent's ``data_path``) and a meshed
    ``FusedClient`` on ``TREE_MESH_SHAPE``, works for the master at
    ``endpoint``; writes its launches, seconds and shape to
    ``tmp/rank<N>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from znicz_torch.client import FusedClient
    from znicz_torch.core.config import root
    from znicz_torch.parallel import mesh as mesh_mod

    mesh_mod.distributed_init(f"file://{store}", world, rank,
                              backend="gloo")
    root.common.dirs.snapshots = os.path.join(tmp, f"snapshots{rank}")
    dp, mp = TREE_MESH_SHAPE
    for key, val in dict(FUSED_KNOBS, job_prefetch=False, job_segment=1,
                         wire_dtype="float32", train_shard=True,
                         **{"mesh.data": dp, "mesh.model": mp}).items():
        root.common.engine.set_by_path(key, val)
    client = FusedClient(star_workflow(torch, cfg), endpoint=endpoint,
                         slave_id="m0")
    ctrs = counters()
    for fn in ctrs.values():
        fn.launches = 0
    coll0 = dict(mesh_mod.STATS)
    client.run()
    torch.cuda.synchronize()
    out = {"rank": client.rank, "mesh": client.mesh_shape,
           "launches": {n: fn.launches for n, fn in ctrs.items()},
           "jobs": client.jobs_done, "job_seconds": client.job_seconds,
           "mesh_seconds": client.mesh_seconds,
           "collectives": {k: mesh_mod.STATS[k] - coll0[k]
                           for k in ("calls", "bytes", "seconds")},
           "device": str(client._trainer.device)}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def tree_meshed(torch, card):
    """Phase 24 (c): a meshed ``FusedClient`` of ``TREE_MESH_SHAPE``: two
    gloo ranks spawned on ``cuda:0`` over a ``FileStore`` (as phase 16
    starts them), rank 0 working for a master in this process for an
    epoch of ``TREE_MESH_CFG`` (2 train jobs and an eval job): the
    master's ``slave_meshes`` records the shape, its tree lies within
    phase 16's cross-layout band of one ``FusedTrainer`` taking the same
    steps, and each rank launched K1/K1b/K2/K2b 2/2/3/3 a train job;
    each job's broadcast and gather seconds.  Returns {kernel: launches}
    summed over the ranks."""
    import multiprocessing as mp

    world = TREE_MESH_SHAPE[0] * TREE_MESH_SHAPE[1]
    # the ranks read the images this process draws
    cfg = dict(TREE_MESH_CFG, data_path=star_dataset(TREE_MESH_CFG))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tree_")
    try:
        with engine_knobs(**FUSED_KNOBS):
            server, jobs = tree_master(torch, cfg, job_timeout=STAR_WAIT_S)
        start_tree = star_tree(server.workflow)
        server.start()
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tree_mesh_rank,
                             args=(rank, world, os.path.join(tmp, "store"),
                                   tmp, server.endpoint, cfg))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + STAR_WAIT_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"[tree:c] ranks exited {codes}")
        if not server.join(STAR_WAIT_S):
            raise AssertionError("[tree:c] the master never finished")
        wall = time.perf_counter() - t0
        ranks = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        shape = {"data": TREE_MESH_SHAPE[0], "model": TREE_MESH_SHAPE[1]}
        if server.slave_meshes != {"m0": shape} \
                or server.jobs_by_slave != {"m0": len(jobs)} \
                or not bool(server.decision.complete) \
                or any(r["mesh"] != shape for r in ranks):
            raise AssertionError(f"[tree:c] slave_meshes "
                                 f"{server.slave_meshes}, by slave "
                                 f"{server.jobs_by_slave}, rank meshes "
                                 f"{[r['mesh'] for r in ranks]}")
        got = {}
        for r in ranks:
            got[r["rank"]] = tree_launches(r["launches"], jobs,
                                           f"c:rank{r['rank']}")
        def flat(tree):
            return {f"{name}.{k}": torch.from_numpy(np.asarray(a))
                    for name, leaves in tree.items() for k, a in leaves.items()}

        want, start = flat(tree_reference(torch, jobs, cfg)), flat(start_tree)
        worst, outside, share = shard_drift(
            torch, flat(star_tree(server.workflow)), want, start)
        # the band is loose on a short run (ROADMAP C.5): the reference
        # must have left it, and the meshed run's distance from the
        # reference must be a small share of what the reference moved
        _, moved_out, _ = shard_drift(torch, start, want, start)
        moved = max(float((want[k].double() - start[k].double()).abs().max())
                    for k in want)
        if outside or not moved_out or share > TREE_MESH_SHARE:
            raise AssertionError(
                f"[tree:c] leaves outside the band {SHARD_RTOL} / "
                f"{SHARD_ATOL}: {outside}; the reference moved "
                f"{len(moved_out)} leaves out of it from the start; max|d| "
                f"{worst:.3g} is {share:.3g} of the move (limit "
                f"{TREE_MESH_SHARE})")
        r0 = ranks[0]
        log(f"[tree:c] {card}: a meshed FusedClient {shape} of {world} gloo "
            f"ranks on {r0['device']}, {len(jobs)} jobs "
            f"({sum(1 for j in jobs if j['class'] == 2)} train): "
            f"slave_meshes {server.slave_meshes}; the master's tree vs one "
            f"FusedTrainer's within the band {SHARD_RTOL} / {SHARD_ATOL}: "
            f"max|d| {worst:.3g}, at most {share:.3g} of what the reference "
            f"moved the leaves (limit {TREE_MESH_SHARE}; max|w1 - w0| "
            f"{moved:.3g}, {len(moved_out)} of {len(want)} leaves moved out "
            f"of the band); launches by rank "
            f"{got}; rank 0's seconds a job "
            f"{['%.4f' % s for s in r0['job_seconds']]}; broadcast s "
            + "; ".join(f"rank {r['rank']} "
                        f"{['%.4f' % s for s in r['mesh_seconds']['broadcast']]}"
                        for r in ranks)
            + f"; gather s {['%.4f' % s for s in r0['mesh_seconds']['gather']]}"
            f"; collectives by rank "
            f"{[r['collectives'] for r in ranks]}; spawned, trained and "
            f"joined in {wall:.2f}s")
        return {n: sum(r["launches"][n] for r in ranks) for n in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 25: charlm, the sequence model ---------------------------------------

#: phase 25's training runs: label -> (on FusedTrainer, knobs); no kernel
#: lies on charlm's path (the attention ops, the seq epilogue and the loss
#: head are PyTorch ops, as the reference's are XLA ops)
CHARLM_RUNS = {"charlm:fused": (True, {}),
               "charlm:fused_tail": (True, {"fused_tail": True}),
               "charlm:units": (False, {})}
#: the ``fused`` run's VALID token error must be under this (%), the
#: reference's own band (tests/test_charlm.py)
CHARLM_VALID_ERR = 50.0
#: the served ladder's rows, and the mixed-length stream's requests
CHARLM_MAX_BATCH = 8
CHARLM_STREAM = 192
#: requests of CHARLM_MAX_BATCH rows a seq rung for its rows a second
CHARLM_RATE_REQUESTS = 64
#: served requests whose pad tokens are changed under the captured runner
CHARLM_PAD_PROBES = 8


def charlm_train(torch, card, label):
    """One run of :data:`CHARLM_RUNS` at the sample's defaults after
    ``prng.reset(ANCHOR_SEED)``: every loss finite, the first STEP_CHECK
    train losses within STEP_RTOL of the same run on the CPU, no kernel
    launched.  Returns (workflow, finals, {kernel: launches})."""
    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.core import prng
    from znicz_torch.samples import train

    fused, knobs = CHARLM_RUNS[label]
    ctrs = counters()
    reset = set_knobs(knobs)
    try:
        prng.reset(ANCHOR_SEED)
        wf = sample_workflow("charlm")
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        train(wf, "charlm", fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        cpu = (cpu_steps if fused else cpu_unit_steps)("charlm", STEP_CHECK)
    finally:
        reset()
    losses = list(wf.decision.train_losses)
    steps = losses[:STEP_CHECK]
    band = max(abs(a - b) / abs(b) for a, b in zip(steps, cpu))
    fin = sample_finals("charlm", wf)
    st = wf.train_stats
    batch = wf.loader.max_minibatch_size
    trainer = getattr(wf, "trainer", None)
    captured = (f", {trainer.stats['captured_steps']} captured and "
                f"{trainer.stats['eager_steps']} eager steps"
                if fused else "")
    log(f"[charlm:{label[7:]}] {card}: {json.dumps(fin)}; run() "
        f"{wall:.2f}s, {wall / fin['epochs']:.3f}s an epoch, "
        f"{st['train_steps']} train steps, warm steps/s "
        f"{st['warm_img_per_sec'] / batch:.1f} (images/s "
        f"{st['img_per_sec']:.1f}, warm {st['warm_img_per_sec']:.1f})"
        f"{captured} on {wf.device}; first {STEP_CHECK} train losses vs "
        f"the port on the CPU: band {band:.3e} (tol {STEP_RTOL:g})")
    if len(steps) != STEP_CHECK or len(cpu) != STEP_CHECK:
        raise AssertionError(f"[{label}] {len(steps)} steps on the card, "
                             f"{len(cpu)} on the CPU")
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"[{label}] non-finite loss")
    if any(launches.values()):
        raise AssertionError(f"[{label}] a kernel launched on charlm's "
                             f"path: {launches}")
    if band > STEP_RTOL:
        raise AssertionError(f"[{label}] the card leaves the CPU's first "
                             f"{STEP_CHECK} steps: {band:.3e}")
    if label == "charlm:fused" and \
            not fin["valid_token_err_pct"] < CHARLM_VALID_ERR:
        raise AssertionError(f"[{label}] VALID token error "
                             f"{fin['valid_token_err_pct']:.2f}% is not "
                             f"under {CHARLM_VALID_ERR}%")
    return wf, fin, launches


def seq_pass(srv, requests):
    """``requests`` ((n, len) id arrays) submitted in process as one
    stream; (replies in order, wall s)."""
    from znicz_torch.serving.batcher import Request

    futures = [Future() for _ in requests]
    t0 = time.perf_counter()
    for i, x in enumerate(requests):
        srv.submit(Request(x, x.shape[0], reply_to=futures[i], req_id=i,
                           seq_len=x.shape[1]))
    replies = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    bad = [r for r in replies if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} refused/failed replies: {bad[0]}")
    return replies, wall


def charlm_serve(torch, card, path):
    """Phase 25's serving half: the snapshot at ``path`` served in process
    on the 2-D ladder, each (rows, seq) bucket one captured graph.
    Returns {kernel: launches} of the mixed-length stream."""
    from znicz_torch.core import prng
    from znicz_torch.serving.frontend import InferenceServer
    from znicz_torch.serving.model import ModelRunner

    ctrs = counters()
    prng.reset(ANCHOR_SEED)
    wf = sample_workflow("charlm")
    vocab, seq_len = wf.output_sample_shape[-1], wf.serving_seq_len
    eager = ModelRunner(sample_workflow("charlm"), snapshot=path,
                        capture=False)
    t0 = time.perf_counter()
    srv = InferenceServer(wf, snapshot=path, max_batch=CHARLM_MAX_BATCH,
                          max_delay_ms=2.0, queue_bound=4096,
                          request_ttl_s=600.0).start()
    warm_s = time.perf_counter() - t0
    try:
        runner, lad = srv.runner, srv.batcher.ladder
        buckets = lad.buckets()
        log(f"[charlm:serve] {card}: ladder {lad}, {len(buckets)} buckets; "
            f"warmup {warm_s:.3f}s to ready ({runner.compiles} captures, "
            f"{runner.capture_s:.3f}s in them); warm proof "
            f"{srv.warm_report['ok']}")
        if not (runner.capture and len(buckets) == 28
                and runner.compiles == runner.graph_cache_size()
                == len(buckets) and srv.warm_report["ok"]):
            raise AssertionError(
                f"[charlm:serve] capture {runner.capture}, compiles "
                f"{runner.compiles}, graph_cache_size "
                f"{runner.graph_cache_size()} for {len(buckets)} buckets, "
                f"warm report {srv.warm_report}")
        compiles = runner.compiles
        rng = np.random.default_rng(SEED)
        lengths = [1, seq_len] + [int(v) for v in rng.integers(
            1, seq_len + 1, size=CHARLM_STREAM - 2)]
        requests = [rng.integers(1, vocab, size=(int(rng.integers(1, 3)),
                                                 L)).astype(np.uint8)
                    for L in lengths]
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        replies, wall = seq_pass(srv, requests)
        launches = {name: fn.launches for name, fn in ctrs.items()}
        if runner.compiles != compiles:
            raise AssertionError(f"[charlm:serve] {runner.compiles - compiles}"
                                 f" captures after the warmup")
        # each reply: its shape, and bit for bit the eager forward of the
        # padded bucket it rode (its rows rung depends on its neighbours)
        off, cache = [], {}
        for i, x in enumerate(requests):
            n, L = x.shape
            y = replies[i]["y"]
            if y.shape != (n, L, vocab) or not np.isfinite(y).all():
                raise AssertionError(f"[charlm:serve] request {i}: reply "
                                     f"{y.shape} for {x.shape}")
            s = lad.seq_bucket_for(L)
            rides = []
            for b in (r for r in lad.rungs if r >= n):
                xb = np.zeros((b, s), np.uint8)
                xb[:n, :L] = x
                key = (b, s, x.tobytes())
                if key not in cache:
                    cache[key] = eager.infer(xb)[:n, :L]
                rides.append(cache[key])
            if not any(np.array_equal(y, r) for r in rides):
                off.append(i)
        # pad tokens changed under the captured runner: no bit of the real
        # positions moves
        moved = []
        for i in range(CHARLM_PAD_PROBES):
            x = requests[2 + i]
            n, L = x.shape
            xb = np.zeros((lad.bucket_for(n), lad.seq_bucket_for(L)),
                          np.uint8)
            xb[:n, :L] = x
            base = runner.infer(xb)[:n, :L]
            xb[:, L:] = rng.integers(0, vocab, size=xb[:, L:].shape)
            xb[n:] = rng.integers(0, vocab, size=xb[n:].shape)
            if not np.array_equal(base, runner.infer(xb)[:n, :L]):
                moved.append(i)
        if runner.compiles != compiles:
            raise AssertionError("[charlm:serve] the pad probes captured")
        rows = sum(x.shape[0] for x in requests)
        tokens = sum(x.size for x in requests)
        st = srv.batcher.stats()
        log(f"[charlm:serve] {card}: {len(requests)} requests of lengths "
            f"1-{seq_len} ({rows} rows, {tokens} tokens) in {wall:.3f}s, "
            f"{st['batches']} batches, real cells {st['real_cells']}, pad "
            f"cells {st['padded_cells']}; 0 captures after the warmup; "
            f"replies (n, len, {vocab}) and bit-equal to the eager forward "
            f"of their bucket: "
            + ("all" if not off else f"DIFFER at {off}")
            + f"; pad tokens changed under {CHARLM_PAD_PROBES} probes: "
            + ("no bit moved" if not moved else f"MOVED at {moved}")
            + f"; launches={ {k: v for k, v in launches.items() if v} }")
        if off or moved:
            raise AssertionError(f"[charlm:serve] replies off their "
                                 f"buckets {off}, pad visible {moved}")
        if any(launches.values()):
            raise AssertionError(f"[charlm:serve] a kernel launched: "
                                 f"{launches}")
        # the served rows a second at each seq rung: requests of
        # CHARLM_MAX_BATCH rows, one rows rung, every batch full
        rates = {}
        for s in lad.seq_rungs:
            batch = [rng.integers(1, vocab, size=(CHARLM_MAX_BATCH, s))
                     .astype(np.uint8) for _ in range(CHARLM_RATE_REQUESTS)]
            _, wall = seq_pass(srv, batch)
            rates[s] = CHARLM_MAX_BATCH * CHARLM_RATE_REQUESTS / wall
        if runner.compiles != compiles:
            raise AssertionError("[charlm:serve] the rate passes captured")
        log(f"[charlm:serve] {card}: served rows/s by seq rung "
            + ", ".join(f"{s}: {r:.1f}" for s, r in rates.items())
            + f" ({CHARLM_RATE_REQUESTS} requests of {CHARLM_MAX_BATCH} "
            f"rows a rung, in process)")
    finally:
        srv.stop()
    if srv.error is not None:
        raise RuntimeError("[charlm:serve] the compute loop died") \
            from srv.error
    return launches


def charlm_phase(torch, card):
    """Phase 25: the three :data:`CHARLM_RUNS`, then the ``fused`` run's
    snapshot served on the 2-D ladder.  Returns {run: {kernel:
    launches}}."""
    runs, path = {}, None
    for label in CHARLM_RUNS:
        wf, _, runs[label] = charlm_train(torch, card, label)
        if label == "charlm:fused":
            path = _CHARLM_SNAPSHOT["path"] = wf.snapshotter.save(
                "charlm_phase25")
        del wf
        torch.cuda.empty_cache()
    runs["charlm:serve"] = charlm_serve(torch, card, path)
    return runs


# -- phase 26: charlm generating on the card ------------------------------------

#: the generation plane at the reference's serving defaults for charlm
#: (max_len 64): pages of 16, 8 slots, 8 x 4 pages, chunks of a page
GEN_DEFAULTS = {"page_size": 16, "num_pages": 32, "slots": 8,
                "prefill_chunk": 16}
#: (prefill rungs 3 + decode rungs 4) x page rungs 3 + the copy
GEN_EXECUTABLES = 22
#: paged compute against the full forward: the reference's band
#: (tests/test_generate.py)
GEN_BAND = {"rtol": 1e-5, "atol": 1e-6}
#: (seed, position) pairs whose bits the card and the CPU must share
GEN_SAMPLER_PAIRS = 512
#: the noise's band, in ulp of max(|noise|, 1) (tests/test_torch_random.py)
GEN_GUMBEL_ULPS = 4
#: sampled draws on identical logits: 4 (temp, top_k) pairs x 1024 rows
GEN_DRAW_ROWS = 1024
GEN_DRAW_KNOBS = ((0.5, 0), (0.5, 5), (1.0, 0), (1.0, 5))
#: a draw whose top two perturbed scores on the CPU lie within this many
#: ulp may pick the other on the card
GEN_TIE_ULPS = 8
#: the service's stream: requests, client threads, streamed ones, ones
#: sharing a GEN_PREFIX-token prefix, in flight a client
GEN_REQUESTS = 64
GEN_THREADS = 4
GEN_STREAMED = 8
GEN_SHARED = 16
GEN_PREFIX = 32
GEN_IN_FLIGHT = 4
#: scoring requests interleaved with the generations
GEN_SCORING = 96
#: timed dispatches a decode rung, and replays of one decode graph
GEN_RATE_STEPS = 200
GEN_REPLAYS = 200
#: ``--serve --generate`` subprocess budget (s)
GEN_CLI_TIMEOUT_S = 300
#: phase 25's fused snapshot, reused by phase 26 when both run
_CHARLM_SNAPSHOT: dict = {"path": None}


def gen_in_band(got, want) -> float:
    """max(|got - want| - (atol + rtol |want|)) under :data:`GEN_BAND`:
    <= 0 inside it."""
    return float(np.max(np.abs(got - want) - (
        GEN_BAND["atol"] + GEN_BAND["rtol"] * np.abs(want))))


def gen_by_hand(g, prompt, n_new, pages=None, greedy=True):
    """One request through the paged runner by hand: its prompt in
    chunks of ``prefill_chunk`` from the first uncached position, then
    greedy decode.  Returns (tokens, the logits row of each, pages)."""
    ps, c = g.page_size, g.prefill_chunk
    pages = [] if pages is None else pages
    t0 = min(len(pages) * ps, len(prompt) - 1)
    while t0 < len(prompt):
        n = min(c, len(prompt) - t0)
        while len(pages) < -(-(t0 + n) // ps):
            pages.append(g.alloc_page())
        x = np.zeros((1, c), np.uint8)
        x[0, :n] = prompt[t0:t0 + n]
        tok, _, logits, _ = g.prefill(x, [t0], [n], [pages], [0.0], [0], [0])
        t0 += n
    toks, rows = [int(tok[0])], [logits[0]]
    t = len(prompt)
    for _ in range(n_new - 1):
        if t % ps == 0:
            pages.append(g.alloc_page())
        tok, _, logits, _ = g.decode([pages], [toks[-1]], [t], [0.0], [0],
                                     [0])
        toks.append(int(tok[0]))
        rows.append(logits[0])
        t += 1
    return toks, rows, pages


def sampler_replay_ms(torch, b, vocab, device) -> float:
    """Device ms of one replay of ``_sample_tokens`` alone at (b, vocab),
    captured on its own and replayed back to back under CUDA events: the
    sampler's share of a decode replay."""
    from znicz_torch.parallel.graphs import capturing
    from znicz_torch.serving.model import _sample_tokens

    args = (torch.zeros((b, vocab), device=device),
            torch.full((b,), 0.8, device=device),
            torch.zeros(b, dtype=torch.int64, device=device),
            torch.arange(b, device=device), torch.arange(b, device=device))
    graph = torch.cuda.CUDAGraph()
    with capturing(device) as stream:
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            _sample_tokens(*args)
        torch.cuda.synchronize(device)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            _sample_tokens(*args)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    graph.replay()
    start.record()
    for _ in range(GEN_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / GEN_REPLAYS
    graph.reset()
    return ms


def gen_host_ms(torch, g, sched_cls, seq_cls, vocab):
    """A scheduler's decode ticks over ``slots`` greedy one-token prompts
    on ``g``: (median tick wall ms, device ms of one replay of the tick's
    decode graph, back to back under CUDA events, the graph's key)."""
    sched = sched_cls(g, max_new_cap=64)
    rng = np.random.default_rng(SEED + 1)
    # prompts past two pages: every decode tick rides the top page rung
    n = 2 * g.page_size + 1
    for i in range(g.slots):
        sched.submit(seq_cls(rng.integers(1, vocab, size=n), g.max_ctx - n,
                             req_id=i))
    ticks = []
    while sched.work_available():
        t0 = time.perf_counter()
        sched.step()
        ticks.append(time.perf_counter() - t0)
    tick_ms = float(np.median(ticks[4:-4])) * 1e3
    key = ("decode", g.decode_rungs[-1], g.page_rungs[-1])
    cap = g.runner._active.family.graphs[key]
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    cap.replay()
    start.record()
    for _ in range(GEN_REPLAYS):
        cap.replay()
    end.record()
    torch.cuda.synchronize()
    return tick_ms, start.elapsed_time(end) / GEN_REPLAYS, key


def gen_parity(g, eager, rng):
    """Greedy paged decode on ``g`` from a 5-token prompt across three
    page boundaries, and a 24-token prompt in three 8-token chunks,
    against ``eager``'s full forward of the same positions.  Returns
    (decode rows, their full-forward rows, the decode's tokens, pages
    crossed, the last chunk's logits row, its full-forward row)."""
    vocab = eager.workflow.output_sample_shape[-1]
    ps = g.page_size
    prompt = rng.integers(1, vocab, size=5).astype(np.uint8)
    toks, rows, pages = gen_by_hand(g, prompt, 3 * ps + 2 - 5 + 1)
    seq = np.asarray(list(prompt) + toks[:-1], np.uint8)[None]
    full = eager.infer(seq)[0, 4:4 + len(rows)]
    crossed = len(pages) - 1
    g.release_pages(pages)
    p24 = rng.integers(1, vocab, size=24).astype(np.uint8)
    pages = []
    for i in range(3):
        while len(pages) < -(-(8 * i + 8) // ps):
            pages.append(g.alloc_page())
        x = np.zeros((1, g.prefill_chunk), np.uint8)
        x[0, :8] = p24[8 * i:8 * i + 8]
        _, _, logits, _ = g.prefill(x, [8 * i], [8], [pages], [0.0], [0],
                                    [0])
    chunk_full = eager.infer(p24[None])[0, 23]
    g.release_pages(pages)
    return (np.stack(rows), full, toks, seq, crossed, logits[0],
            chunk_full)


def cpu_forwards(torch, path, seq):
    """The snapshot's full forward of ``seq`` on the CPU, in float32 and
    in float64 (the port's modules on float64 copies of the tree)."""
    from znicz_torch.core import prng
    from znicz_torch.serving.model import ModelRunner

    prng.reset(ANCHOR_SEED)
    r = ModelRunner(sample_workflow("charlm", "cpu"), snapshot=path,
                    capture=False)
    tree = {n: {k: t.double() for k, t in leaves.items()}
            for n, leaves in r._active.tree.items()}
    with torch.inference_mode(), r._bound(tree):
        h = r._trainer._decode(torch.from_numpy(seq))
        f64 = r._trainer.forward_pass(h).numpy()
    return r.infer(seq), f64


def gen_runner_checks(torch, card, path):
    """Phase 26 (a): ``enable_generation`` at the defaults.  On charlm's
    seeded init (the model the reference's test holds to GEN_BAND):
    greedy paged decode across three page boundaries and a 24-token
    prompt in three chunks within GEN_BAND of the full forward.  On the
    snapshot at ``path``: each graph's first replay bit-equal to its
    eager dispatch; the same decode's tokens equal to the full forward's
    argmax at every step, its distance to the full forward and to a
    float64 forward printed beside the full forward's own; a prefix hit
    bit-equal to a cold prefill; copy-on-write leaving the shared page's
    bytes; greedy tokens equal with ``on_device_sampling`` on and off; no
    page leaked.  Prints the dispatch times."""
    from znicz_torch.core import prng
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq
    from znicz_torch.serving.model import ModelRunner

    # the reference's band on the seeded init (tests/test_generate.py
    # holds it on a fresh charlm)
    runners = []
    for capture in (None, False):
        prng.reset(ANCHOR_SEED)
        runners.append(ModelRunner(sample_workflow("charlm"),
                                   capture=capture))
    init_g = runners[0].enable_generation(**GEN_DEFAULTS)
    rows, full, _, _, crossed, last, chunk_full = gen_parity(
        init_g, runners[1], np.random.default_rng(SEED))
    band = {"decode": gen_in_band(rows, full),
            "chunks": gen_in_band(last, chunk_full)}
    errs = {"decode": float(np.abs(rows - full).max()),
            "chunks": float(np.abs(last - chunk_full).max())}
    log(f"[generate:runner] {card}: seeded init, against the full "
        f"forward: greedy decode across {crossed} page boundaries max "
        f"|err| {errs['decode']:.3e}, 24 tokens in 3 chunks max |err| "
        f"{errs['chunks']:.3e}: "
        + ("both inside" if max(band.values()) <= 0 else "OUTSIDE")
        + f" rtol {GEN_BAND['rtol']:g} atol {GEN_BAND['atol']:g}")
    if max(band.values()) > 0 or crossed != 3:
        raise AssertionError(f"[generate:runner] the reference's band: "
                             f"{band}, {crossed} boundaries")
    del runners, init_g
    prng.reset(ANCHOR_SEED)
    runner = ModelRunner(sample_workflow("charlm"), snapshot=path)
    eager = ModelRunner(sample_workflow("charlm"), snapshot=path,
                        capture=False)
    vocab = runner.workflow.output_sample_shape[-1]
    g = runner.enable_generation(**GEN_DEFAULTS)
    if not runner.capture or g.executables() != GEN_EXECUTABLES:
        raise AssertionError(f"[generate:runner] capture {runner.capture}, "
                             f"{g.executables()} executables")
    # each graph: its first dispatch eager (and captured), its second a
    # replay of the same inputs
    t0 = time.perf_counter()
    differ = []
    for key in g.keys():
        first = g.warm_one(key)
        again = g.warm_one(key)
        if first is not None and not all(
                np.array_equal(a, b) for a, b in zip(first, again)):
            differ.append(key)
    warm_s = time.perf_counter() - t0
    if differ or runner.compiles != GEN_EXECUTABLES \
            or g.graph_cache_size() != GEN_EXECUTABLES:
        raise AssertionError(f"[generate:runner] replays differ from eager "
                             f"at {differ}; {runner.compiles} captures")
    rng = np.random.default_rng(SEED)
    ps = g.page_size
    # the trained snapshot: tokens against the full forward's argmax,
    # the distances against a float64 forward
    rows, full, toks, seq, _, last, chunk_full = gen_parity(g, eager, rng)
    f32, f64 = (f[0, 4:4 + len(rows)]
                for f in cpu_forwards(torch, path, seq))
    argmax_same = [int(t) for t in full.argmax(-1)] == toks and int(
        np.argmax(last)) == int(np.argmax(chunk_full))
    snap = {"decode vs full": float(np.abs(rows - full).max()),
            "decode vs float64": float(np.abs(rows - f64).max()),
            "full vs float64": float(np.abs(full - f64).max()),
            "CPU full vs float64": float(np.abs(f32 - f64).max()),
            "chunks vs full": float(np.abs(last - chunk_full).max())}
    snap_band = max(gen_in_band(rows, full), gen_in_band(last, chunk_full))
    # a prefix hit against the cold prefill, bit for bit
    p40 = rng.integers(1, vocab, size=2 * ps + 8).astype(np.uint8)
    cold_t, cold_r, cold_p = gen_by_hand(g, p40, 7)
    g.prefix.register(p40, cold_p)
    g.release_pages(cold_p)
    held, covered = g.prefix.lookup(p40)
    hit_t, hit_r, hit_p = gen_by_hand(g, p40, 7, pages=held)
    g.release_pages(hit_p)
    hit_same = covered == 2 * ps and hit_t == cold_t and all(
        np.array_equal(a, b) for a, b in zip(cold_r, hit_r))
    # copy-on-write: a full hit's last-token write lands in a copy
    p16 = rng.integers(1, vocab, size=ps).astype(np.uint8)
    toks_a, _, pages_a = gen_by_hand(g, p16, 4)
    g.prefix.register(p16, pages_a)
    shared = pages_a[0]
    before = {n: (g.pk[n][shared].clone(), g.pv[n][shared].clone())
              for n in g.pk}
    pages_b, covered = g.prefix.lookup(p16)
    fresh = g.alloc_page()
    g.copy_page(shared, fresh)
    copied = all(torch.equal(g.pk[n][fresh], g.pk[n][shared])
                 and torch.equal(g.pv[n][fresh], g.pv[n][shared])
                 for n in g.pk)
    g.decref(shared)
    pages_b[0] = fresh
    toks_b, _, pages_b = gen_by_hand(g, p16, 4, pages=pages_b)
    untouched = all(torch.equal(g.pk[n][shared], k)
                    and torch.equal(g.pv[n][shared], v)
                    for n, (k, v) in before.items())
    g.release_pages(pages_a)
    g.release_pages(pages_b)
    # greedy tokens with in-graph sampling on and off
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.uint8)
               for n in rng.integers(1, ps, size=6)]
    streams = {}
    for on in (True, False):
        sched = GenerationScheduler(g, max_new_cap=64, on_device_sampling=on)
        for i, p in enumerate(prompts):
            sched.submit(GenSeq(p, 12, req_id=i))
        finals = {}
        while sched.work_available():
            for _, rep in sched.step()[1]:
                finals[rep["req_id"]] = rep["tokens"]
        streams[on] = [finals[i] for i in range(len(prompts))]
    knob_same = all(np.array_equal(a, b)
                    for a, b in zip(streams[True], streams[False]))
    log(f"[generate:runner] {card}: snapshot: {GEN_EXECUTABLES} graphs "
        f"captured in {warm_s:.3f}s ({runner.capture_s:.3f}s in the "
        f"captures), each first replay bit-equal to its eager dispatch; "
        f"decode and chunk tokens against the full forward's argmax: "
        + ("equal" if argmax_same else "DIFFER")
        + "; max |err| "
        + ", ".join(f"{k} {v:.3e}" for k, v in snap.items())
        + f" (logits up to {np.abs(full).max():.2f}; the reference's band "
        + ("met" if snap_band <= 0 else f"exceeded by {snap_band:.3e}")
        + ", C.13); prefix hit vs cold prefill: "
        + ("bit-equal" if hit_same else "DIFFERS")
        + "; copy-on-write: shared page "
        + ("untouched" if untouched else "WRITTEN")
        + f", copy {'bit-equal' if copied else 'DIFFERS'}, tokens "
        + ("equal" if toks_a == toks_b else "DIFFER")
        + "; greedy on/off in-graph sampling: "
        + ("bit-identical" if knob_same else "DIFFER"))
    if not argmax_same or not hit_same or not untouched or not copied \
            or toks_a != toks_b or not knob_same:
        raise AssertionError("[generate:runner] a check failed (above)")
    # the dispatch times, host clock around each fetch
    rates = {}
    width = g.page_rungs[-1]
    for b in g.decode_rungs:
        pages = [[g.scratch] * width] * b
        z = np.zeros(b, np.int64)
        g.decode(pages, z, z, np.zeros(b, np.float32), z, z)
        t0 = time.perf_counter()
        for _ in range(GEN_RATE_STEPS):
            g.decode(pages, z, z, np.zeros(b, np.float32), z, z)
        rates[b] = (time.perf_counter() - t0) / GEN_RATE_STEPS
    x = np.zeros((1, g.prefill_chunk), np.uint8)
    t0 = time.perf_counter()
    for _ in range(GEN_RATE_STEPS):
        g.prefill(x, [0], [g.prefill_chunk], [[g.scratch] * width], [0.0],
                  [0], [0])
    chunk_ms = (time.perf_counter() - t0) / GEN_RATE_STEPS * 1e3
    tick_ms, replay_ms, key = gen_host_ms(torch, g, GenerationScheduler,
                                          GenSeq, vocab)
    sampler_ms = sampler_replay_ms(torch, key[1], vocab, runner.device)
    log(f"[generate:runner] {card}: a decode dispatch with its fetch "
        f"(pages rung {width}): "
        + ", ".join(f"rung {b}: {s * 1e3:.3f} ms, {b / s:.0f} tokens/s"
                    for b, s in rates.items())
        + f"; one prefill chunk ({g.prefill_chunk} tokens, rung 1) "
        f"{chunk_ms:.3f} ms; a scheduler decode tick of {g.slots} "
        f"sequences {tick_ms:.3f} ms, of which one {key} replay "
        f"{replay_ms:.4f} ms on the device (back to back; the sampler "
        f"alone {sampler_ms:.4f} ms): host {tick_ms - replay_ms:.3f} ms a "
        f"tick ({(tick_ms - replay_ms) / tick_ms:.1%})")
    if g.pages_leaked():
        raise AssertionError(f"[generate:runner] {g.pages_leaked()} pages "
                             f"leaked")
    del runner, eager, g


def gen_sampler_checks(torch, card):
    """Phase 26 (b): the threefry bits on the card equal the CPU's over
    GEN_SAMPLER_PAIRS (seed, position) pairs, the noise within
    GEN_GUMBEL_ULPS; on identical logits, 4096 draws give the CPU's
    tokens, a draw whose top two perturbed CPU scores lie within
    GEN_TIE_ULPS excepted (counted)."""
    from znicz_torch.ops import random as rnd
    from znicz_torch.serving.model import _sample_tokens

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 2)
    seeds = np.concatenate([[0, 1, 2**31, 2**32 - 1], rng.integers(
        0, 2**32, GEN_SAMPLER_PAIRS - 4, dtype=np.int64)])
    pos = rng.integers(0, 4096, GEN_SAMPLER_PAIRS)
    s_t, p_t = torch.from_numpy(seeds), torch.from_numpy(pos)
    vocab = 32
    bits_cpu = rnd.bits(rnd.fold_in(s_t, p_t), vocab)
    bits_card = rnd.bits(rnd.fold_in(s_t.to(dev), p_t.to(dev)), vocab).cpu()
    g_cpu = rnd.gumbel(rnd.fold_in(s_t, p_t), vocab).numpy()
    g_card = rnd.gumbel(rnd.fold_in(s_t.to(dev), p_t.to(dev)),
                        vocab).cpu().numpy()
    ulps = float((np.abs(g_card - g_cpu) / np.spacing(np.maximum(
        np.abs(g_cpu), 1).astype(np.float32))).max())
    bits_same = torch.equal(bits_cpu, bits_card)
    differ = ties = 0
    for temp, top_k in GEN_DRAW_KNOBS:
        logits = (rng.normal(size=(GEN_DRAW_ROWS, vocab)) * 3).astype(
            np.float32)
        args = [torch.from_numpy(logits),
                torch.full((GEN_DRAW_ROWS,), temp, dtype=torch.float32),
                torch.full((GEN_DRAW_ROWS,), top_k, dtype=torch.int64),
                torch.from_numpy(rng.integers(0, 2**32, GEN_DRAW_ROWS,
                                              dtype=np.int64)),
                torch.from_numpy(rng.integers(0, 64, GEN_DRAW_ROWS))]
        cpu, _ = _sample_tokens(*args)
        on_card, _ = _sample_tokens(*[a.to(dev) for a in args])
        off = np.nonzero(cpu.numpy() != on_card.cpu().numpy())[0]
        if off.size:
            # the CPU's perturbed scores of the rows that differ
            z = logits / temp
            if top_k:
                kth = np.sort(z, -1)[:, -top_k][:, None]
                z = np.where(z < kth, -np.inf, z)
            z = z + rnd.gumbel(rnd.fold_in(args[3], args[4]),
                               vocab).numpy()
            top2 = np.sort(z[off], -1)[:, -2:]
            near = (top2[:, 1] - top2[:, 0]) <= GEN_TIE_ULPS * np.spacing(
                np.abs(top2[:, 1]))
            ties += int(near.sum())
            differ += int((~near).sum())
    draws = GEN_DRAW_ROWS * len(GEN_DRAW_KNOBS)
    log(f"[generate:sampler] {card}: threefry bits over "
        f"{GEN_SAMPLER_PAIRS} (seed, position) pairs x {vocab}: "
        + ("equal to the CPU's" if bits_same else "DIFFER")
        + f"; gumbel noise within {ulps:.1f} ulp (band {GEN_GUMBEL_ULPS}); "
        f"{draws} draws on identical logits (temp, top_k) in "
        f"{list(GEN_DRAW_KNOBS)}: {draws - differ - ties} equal, {ties} "
        f"near-ties (top two perturbed scores within {GEN_TIE_ULPS} ulp), "
        f"{differ} differ")
    if not bits_same or ulps > GEN_GUMBEL_ULPS or differ:
        raise AssertionError("[generate:sampler] the card's sampler leaves "
                             "the CPU's")


def gen_requests(vocab):
    """Phase 26's stream: (prompt, max_new_tokens, options) of
    GEN_REQUESTS requests, lengths 1-48 and 1-16 new tokens, half greedy
    and half seeded sampled, GEN_STREAMED streamed, the first GEN_SHARED
    sharing a GEN_PREFIX-token prefix (every fourth of those the prefix
    alone: its last token's write copies a shared page); and the
    prefix."""
    rng = np.random.default_rng(SEED + 26)
    prefix = rng.integers(1, vocab, size=GEN_PREFIX).astype(np.uint8)
    reqs = []
    for i in range(GEN_REQUESTS):
        if i < GEN_SHARED:
            tail = 0 if i % 4 == 0 else int(rng.integers(1, 17))
            prompt = np.concatenate([prefix, rng.integers(
                1, vocab, size=tail).astype(np.uint8)])
        else:
            prompt = rng.integers(1, vocab, size=int(rng.integers(1, 49))
                                  ).astype(np.uint8)
        sampled = i % 2 == 1
        opts = {"temperature": 0.8 if sampled else 0.0,
                "top_k": 5 if i % 4 == 3 else 0,
                "seed": 9000 + i if sampled else None,
                "stream": i % (GEN_REQUESTS // GEN_STREAMED) == 2,
                "return_logits": True}
        reqs.append((prompt, int(rng.integers(1, 17)), opts))
    return reqs, prefix


def gen_clients(endpoint, reqs):
    """``reqs`` over ZMQ from GEN_THREADS InferenceClients, one a thread,
    each keeping GEN_IN_FLIGHT out.  Returns (finals in request order,
    the streamed partials (i, token) of each, wall s)."""
    from znicz_torch.serving import InferenceClient

    finals = [None] * len(reqs)
    parts = [[] for _ in reqs]
    errors = []

    def run(tid):
        try:
            cli = InferenceClient(endpoint, timeout=600, resend_after_s=600)
            try:
                todo = list(range(tid, len(reqs), GEN_THREADS))
                sent = {}
                while todo or sent:
                    while todo and len(sent) < GEN_IN_FLIGHT:
                        i = todo.pop(0)
                        prompt, n_new, opts = reqs[i]
                        on_token = None
                        if opts["stream"]:
                            def on_token(t, j, out=parts[i]):
                                out.append((j, t))
                        rid = cli.submit_generate(prompt, n_new,
                                                  on_token=on_token, **opts)
                        sent[rid] = i
                    for rep in cli.collect(0.05):
                        finals[sent.pop(rep["req_id"])] = rep
            finally:
                cli.close()
        except Exception as exc:       # raised in the caller below
            errors.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(t,))
               for t in range(GEN_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(f is None for f in finals):
        raise AssertionError("a generate client did not finish")
    return finals, parts, wall


def gen_departs(got, want, opts, prompt_len):
    """Where two replies' tokens part: None when equal, "tie" when they
    part where ``want``'s logits (the reference of the two) have a
    near-tie inside GEN_BAND's reach (greedy: the top two logits;
    sampled: the top two perturbed scores), else "differ"."""
    from znicz_torch.ops import random as rnd

    import torch

    a, b = list(got["tokens"]), list(want["tokens"])
    if a == b:
        return None
    j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
    row = want["logits"][j].astype(np.float64)
    reach = 2 * (GEN_BAND["atol"] + GEN_BAND["rtol"] * np.abs(row).max())
    if opts["temperature"] > 0:
        z = row / opts["temperature"]
        reach /= opts["temperature"]
        if opts["top_k"]:
            z = np.where(z < np.sort(z)[-opts["top_k"]], -np.inf, z)
        t = torch.tensor([prompt_len - 1 + j])
        z = z + rnd.gumbel(rnd.fold_in(torch.tensor([opts["seed"]]), t),
                           len(row)).numpy()[0]
        row = z
    top2 = np.sort(row)[-2:]
    return "tie" if top2[1] - top2[0] <= reach else "differ"


def gen_service_checks(torch, card, path):
    """Phase 26 (c): the snapshot at ``path`` served in process with
    generation on: 50 captures at warm-up and none after; the
    GEN_REQUESTS stream from GEN_THREADS clients with phase 25's scoring
    stream beside it; each greedy reply equal to the same request alone,
    each sampled reply to its resend (a near-tie across rungs counted,
    not raised), streamed partials in order and equal to the final,
    prefix hits and copies, no page leaked after the drain.  Returns
    (a short greedy prompt, its tokens alone) for (d)."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.serving import InferenceClient
    from znicz_torch.serving.frontend import InferenceServer

    prng.reset(ANCHOR_SEED)
    wf = sample_workflow("charlm")
    vocab, seq_len = wf.output_sample_shape[-1], wf.serving_seq_len
    root.common.serving.generate.enabled = True
    try:
        t0 = time.perf_counter()
        srv = InferenceServer(wf, snapshot=path, max_batch=CHARLM_MAX_BATCH,
                              max_delay_ms=2.0, queue_bound=4096,
                              request_ttl_s=600.0)
    finally:
        del root.common.serving.generate.enabled
    srv.start()
    warm_s = time.perf_counter() - t0
    try:
        runner, gen = srv.runner, srv.gen_sched.gen
        expected = len(srv.batcher.ladder.buckets()) + gen.executables()
        log(f"[generate:serve] {card}: warm-up {warm_s:.3f}s to ready, "
            f"{runner.compiles} captures ({len(srv.batcher.ladder.buckets())}"
            f" ladder buckets + {gen.executables()} generation graphs, "
            f"{runner.capture_s:.3f}s in them); warm proof "
            f"{srv.warm_report['ok']}")
        if not (runner.compiles == runner.graph_cache_size() == expected
                == 28 + GEN_EXECUTABLES and srv.warm_report["ok"]):
            raise AssertionError(f"[generate:serve] {runner.compiles} "
                                 f"captures, warm report {srv.warm_report}")
        compiles = runner.compiles
        reqs, prefix = gen_requests(vocab)
        cli = InferenceClient(srv.endpoint, timeout=600, resend_after_s=600)
        try:
            # the prefix indexed first, so the shared requests hit
            cli.generate(np.concatenate([prefix, prefix[:1]]), 1)
            rng = np.random.default_rng(SEED + 25)
            scoring = [rng.integers(1, vocab, size=(int(rng.integers(1, 3)),
                                                    int(L))).astype(np.uint8)
                       for L in rng.integers(1, seq_len + 1,
                                             size=GEN_SCORING)]
            scored = {}
            side = threading.Thread(target=lambda: scored.update(
                zip(("replies", "wall"), seq_pass(srv, scoring))))
            st0 = srv.gen_sched.stats()
            side.start()
            finals, parts, wall = gen_clients(srv.endpoint, reqs)
            side.join(900)
            st = srv.gen_sched.stats()
            if "replies" not in scored or any(
                    r["y"].shape != x.shape + (vocab,)
                    for r, x in zip(scored["replies"], scoring)):
                raise AssertionError("[generate:serve] the scoring stream "
                                     "failed")
            bad = [r for r in finals if not r["ok"]]
            if bad:
                raise AssertionError(f"[generate:serve] {len(bad)} refused "
                                     f"or failed: {bad[0]}")
            tokens = sum(len(r["tokens"]) for r in finals)
            short = [i for i, (_, n, _) in enumerate(reqs)
                     if len(finals[i]["tokens"]) != n]
            streamed = [i for i, (_, _, o) in enumerate(reqs) if o["stream"]]
            order = [i for i in streamed
                     if [j for j, _ in parts[i]] != list(range(
                         len(finals[i]["tokens"])))
                     or [t for _, t in parts[i]]
                     != list(finals[i]["tokens"])]
            # each request again, alone: greedy ones against the alone
            # run, sampled ones against their resend
            ties, differ = 0, []
            alone = {}
            for i, (prompt, n_new, opts) in enumerate(reqs):
                again = cli.generate(prompt, n_new, **dict(opts,
                                                           stream=False))
                alone[i] = again
                how = gen_departs(finals[i], again, opts, len(prompt))
                if how == "tie":
                    ties += 1
                elif how == "differ":
                    differ.append(i)
        finally:
            cli.close()
        gst = srv.stats()["generate"]
        if runner.compiles != compiles:
            raise AssertionError(f"[generate:serve] "
                                 f"{runner.compiles - compiles} captures "
                                 f"after the warm-up")
        decoded = st["decode_tokens"] - st0["decode_tokens"]
        log(f"[generate:serve] {card}: {len(reqs)} generate requests from "
            f"{GEN_THREADS} clients ({GEN_STREAMED} streamed, {GEN_SHARED} "
            f"on a {GEN_PREFIX}-token prefix) beside {len(scoring)} scoring "
            f"requests: {tokens} tokens in {wall:.3f}s ({tokens / wall:.1f} "
            f"tokens/s; {st['decode_batches'] - st0['decode_batches']} "
            f"decode ticks for {decoded} tokens, "
            f"{st['prefill_batches'] - st0['prefill_batches']} prefill "
            f"chunks for {st['prefill_tokens'] - st0['prefill_tokens']} "
            f"prompt tokens); TTFT p50 {gst['ttft_p50_ms']} ms p99 "
            f"{gst['ttft_p99_ms']} ms (queue wait p50 "
            f"{gst['queue_wait_p50_ms']} ms), inter-token p50 "
            f"{gst['inter_token_p50_ms']} ms p99 {gst['inter_token_p99_ms']}"
            f" ms; prefix hits {gst['prefix_hits']}, copies "
            f"{gst['cow_copies']}, fetch bytes {gst['fetch_bytes']}; "
            f"0 captures after the warm-up; streamed partials in order and "
            f"equal to the final: "
            + ("all" if not order else f"NOT at {order}")
            + f"; against the request alone (greedy) or resent (sampled): "
            f"{len(reqs) - ties - len(differ)} equal, {ties} part at a "
            f"near-tie inside the band, "
            + (f"{len(differ)} DIFFER at {differ}" if differ else
               "none differ"))
        if short or order or differ or not gst["prefix_hits"] \
                or not gst["cow_copies"]:
            raise AssertionError(f"[generate:serve] short {short}, order "
                                 f"{order}, differ {differ} (C.13), hits "
                                 f"{gst['prefix_hits']}, copies "
                                 f"{gst['cow_copies']}")
        probe = next(i for i, (p, n, o) in enumerate(reqs)
                     if o["temperature"] == 0 and len(p) < gen.page_size
                     and n > 4)
    finally:
        srv.stop()
    if srv.error is not None:
        raise RuntimeError("[generate:serve] the compute loop died") \
            from srv.error
    if gen.pages_leaked() or gen.pages_active() != len(gen.prefix):
        raise AssertionError(f"[generate:serve] after the drain "
                             f"{gen.pages_leaked()} pages leaked, "
                             f"{gen.pages_active()} active for "
                             f"{len(gen.prefix)} indexed")
    log(f"[generate:serve] {card}: after the drain 0 pages leaked, "
        f"{gen.pages_active()} held by the prefix index")
    prompt, n_new, _ = reqs[probe]
    return prompt, n_new, list(alone[probe]["tokens"])


def gen_cli(torch, card, path, probe):
    """Phase 26 (d): ``python -m znicz_torch charlm --serve
    tcp://127.0.0.1:* --snapshot path --generate`` in a subprocess on the
    card: one greedy request, not streamed and streamed, equal to (c)'s
    tokens of it alone; exit 0 at ``max_requests``."""
    from znicz_torch.serving import InferenceClient

    prompt, n_new, want = probe
    cmd = [sys.executable, "-m", "znicz_torch", "charlm", "--serve",
           "tcp://127.0.0.1:*", "--snapshot", path, "--generate",
           "root.common.serving.max_requests=2"]
    served = ServingProcess(cmd, "charlm", "generate:cli", GEN_CLI_TIMEOUT_S)
    try:
        cli = InferenceClient(served.endpoint, timeout=GEN_CLI_TIMEOUT_S)
        try:
            whole = list(cli.generate(prompt, n_new)["tokens"])
            got = []
            fin = cli.generate(prompt, n_new, stream=True,
                               on_token=lambda t, i: got.append(t))
        finally:
            cli.close()
        last = served.finish(GEN_CLI_TIMEOUT_S)
        same = whole == want == got == list(fin["tokens"])
        log(f"[generate:cli] {card}: up in {served.up:.2f}s; a greedy "
            f"request of {len(prompt)} tokens for {n_new}: not streamed and "
            f"streamed "
            + ("equal to the in-process tokens" if same else
               f"DIFFER: {whole} / {got} against {want}")
            + f"; exit 0 {time.perf_counter() - served.t0:.2f}s after the "
            f"start; {last}")
        if not same:
            raise AssertionError("[generate:cli] the ZMQ tokens differ")
    finally:
        served.kill()


def generate_phase(torch, card):
    """Phase 26: charlm generating on the card from phase 25's ``fused``
    snapshot (trained here when phase 25 did not run): (a) the runner,
    (b) the sampler, (c) the service, (d) ``--serve --generate`` over
    ZMQ.  No kernel lies on this path (the attention ops, the paged ops
    and the sampler are PyTorch ops, as the reference's are XLA ops):
    the counts stay 0.  Returns {label: {kernel: launches}}."""
    path = _CHARLM_SNAPSHOT["path"]
    if path is None:
        wf, _, _ = charlm_train(torch, card, "charlm:fused")
        path = _CHARLM_SNAPSHOT["path"] = wf.snapshotter.save(
            "charlm_phase26")
        del wf
        torch.cuda.empty_cache()
    ctrs = counters()
    for fn in ctrs.values():                # the main path starts here
        fn.launches = 0
    gen_runner_checks(torch, card, path)
    torch.cuda.empty_cache()
    gen_sampler_checks(torch, card)
    probe = gen_service_checks(torch, card, path)
    torch.cuda.empty_cache()
    gen_cli(torch, card, path, probe)
    launches = {name: fn.launches for name, fn in ctrs.items()}
    if any(launches.values()):
        raise AssertionError(f"[generate] a kernel launched on the "
                             f"generation path: {launches}")
    return {"generate": launches}


# -- phase 27: seq_parallel, then the tuning units ------------------------------

#: (a)'s ring cases: label -> (batch, T, heads, head_dim): charlm's
#: attention at the sample's defaults, and one long context
SEQPAR_RING = {"charlm": (32, 64, 2, 16), "long": (4, 4096, 2, 16)}
#: the reference's tolerances (tests/test_attention.py): outputs, then
#: gradients, as (rtol, atol)
SEQPAR_FWD_TOL, SEQPAR_GRAD_TOL = (2e-4, 1e-5), (2e-4, 1e-6)
#: ranks of each spawn -> the mesh (data, model) charlm trains on there
SEQPAR_MESHES = {2: (1, 2), 4: (2, 2)}
#: root.common.engine.seq_parallel for charlm's runs
SEQPAR_SP = 2
#: charlm's embedding lookup at the sample's defaults: (ids, vocab,
#: embed), and the calls timed each way
SEQPAR_LOOKUP, SEQPAR_LOOKUP_ITERS = (32 * 64, 32, 32), 200
#: calls timed a case, and the longest the parent waits for its ranks
SEQPAR_ITERS, SEQPAR_JOIN_S = 5, 420
#: the rank processes' device: the card (a CPU rehearsal sets "cpu")
SEQPAR_DEVICE = None
#: (c): the GA over MNIST at its defaults on ``FusedTrainer``, two epochs
#: a run (an epoch's VALID pass comes before its TRAIN pass, so the first
#: epoch's fitness is the untrained model's, the same for every one)
GA_GENERATIONS, GA_POPULATION = 2, 4
GA_EPOCHS = 2
GA_OVERRIDES = ["--fused", f"root.mnist.decision.max_epochs={GA_EPOCHS}"]
GA_TIMEOUT_S = 300.0
#: (c): CD-1 on MNIST rows: rows, hidden width, steps, learning rate, and
#: the share of the first reconstruction error the last must be under
RBM_ROWS, RBM_HIDDEN, RBM_STEPS, RBM_LR, RBM_DROP = 1000, 256, 30, 0.1, 0.7


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(torch, dev, fn, iters=SEQPAR_ITERS) -> float:
    """Host milliseconds a call of ``fn`` (a warm-up first; the device
    synchronised around the calls: the ring waits on the host anyway)."""
    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(torch, dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def seqpar_ring(torch, world, rank, dev):
    """(a) in one rank: for each :data:`SEQPAR_RING` case, causal and not,
    this rank's blocks of seeded q, k, v through ``ring_attention`` over
    the world, output and q/k/v gradients against the dense core over the
    whole sequence (computed in each rank), the ring's ms a call forward
    and forward + backward, its P2P calls, bytes and host seconds; rank 0
    times the dense core alone, the others waiting.  {case: record}."""
    import torch.distributed as dist

    from znicz_torch.ops.attention import attention, ring_attention
    from znicz_torch.parallel import mesh as mesh_mod

    group, out = dist.group.WORLD, {}
    for label, (b, t, h, d) in SEQPAR_RING.items():
        for causal in (False, True):
            gen = torch.Generator(device=dev).manual_seed(SEED + t + causal)
            q, k, v, cot = (torch.randn((b, t, h, d), generator=gen,
                                        device=dev) for _ in range(4))
            n = t // world
            blk = slice(rank * n, (rank + 1) * n)
            whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
            y = attention(*whole, causal=causal)
            y.backward(cot)
            want = [y.detach()[:, blk]] + [x.grad[:, blk] for x in whole]
            del y, whole

            def ring(grad=True):
                ls = [x[:, blk].clone().requires_grad_(grad)
                      for x in (q, k, v)]
                o = ring_attention(*ls, group, causal=causal)
                if grad:
                    o.backward(cot[:, blk].contiguous())
                return [o.detach()] + [x.grad for x in ls]

            c0 = dict(mesh_mod.STATS)
            got = ring()
            _sync(torch, dev)
            p2p = {key: mesh_mod.STATS[key] - c0[key]
                   for key in ("calls", "bytes", "seconds")}
            errs, ok = [], True
            for i, (g, w) in enumerate(zip(got, want)):
                rtol, atol = SEQPAR_GRAD_TOL if i else SEQPAR_FWD_TOL
                errs.append(float((g - w).abs().max()))
                ok = ok and bool(torch.allclose(g, w, rtol=rtol, atol=atol))
            rec = {"ok": ok, "max_abs_err": errs, "p2p": p2p,
                   "ring_fwd_ms": _host_ms(
                       torch, dev, lambda: ring(False)),
                   "ring_fwd_bwd_ms": _host_ms(torch, dev, ring)}
            if rank == 0:
                def dense(grad=True):
                    ls = [x.clone().requires_grad_(grad) for x in (q, k, v)]
                    o = attention(*ls, causal=causal)
                    if grad:
                        o.backward(cot)

                rec["dense_fwd_ms"] = _host_ms(
                    torch, dev, lambda: dense(False))
                rec["dense_fwd_bwd_ms"] = _host_ms(torch, dev, dense)
            dist.barrier()
            out[f"{label}:{'causal' if causal else 'full'}"] = rec
            del q, k, v, cot, want, got
    return out


def seqpar_charlm(torch, world, rank, dev, tmp):
    """(b) in one rank: charlm at ``root.charlm``'s defaults from
    ``ANCHOR_SEED`` on ``FusedTrainer`` on :data:`SEQPAR_MESHES`'s mesh
    with ``seq_parallel`` :data:`SEQPAR_SP`: whether the attention bound
    to the mesh, the TRAIN losses, the finals, the parameters (an .npz in
    ``tmp``), warm steps a second, the collectives and the launches."""
    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.attention import MultiHeadAttention
    from znicz_torch.core import prng
    from znicz_torch.parallel import mesh as mesh_mod
    from znicz_torch.samples import train
    from znicz_torch.weights import params_to_numpy

    shape = SEQPAR_MESHES[world]
    ctrs = counters()
    with engine_knobs(seq_parallel=SEQPAR_SP):
        prng.reset(ANCHOR_SEED)
        wf = sample_workflow("charlm", dev)
        mesh = mesh_mod.make_mesh(shape, ("data", "model"))
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        c0 = dict(mesh_mod.STATS)
        t0 = time.perf_counter()
        train(wf, "charlm", fused=True, mesh=mesh)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    mha = [f for f in wf.trainer.forwards if isinstance(f, MultiHeadAttention)]
    rings = [torch.distributed.get_process_group_ranks(
        mesh_mod.axis_group(m._sp_mesh, m._seq_axis)) for m in mha]
    np.savez(os.path.join(tmp, f"charlm{world}_{rank}.npz"),
             **{f"{name}.{k}": a for name, leaves in
                params_to_numpy(wf).items() for k, a in leaves.items()})
    return {"bound": [m._sp_mesh is mesh for m in mha],
            "ring_ranks": rings,
            "data": mesh_mod.axis_index(mesh, "data"),
            "losses": [float(x) for x in wf.decision.train_losses],
            "finals": sample_finals("charlm", wf), "wall_s": wall,
            "steps_per_s": (wf.train_stats["warm_img_per_sec"]
                            / wf.loader.max_minibatch_size),
            "uncaptured": wf.trainer.uncaptured_reason,
            "collectives": {key: mesh_mod.STATS[key] - c0[key]
                            for key in ("calls", "bytes", "seconds")},
            "launches": {n: fn.launches for n, fn in ctrs.items()}}


def seqpar_rank(rank, world, store, tmp, device=None):
    """One rank of phase 27 (a) and (b) (a spawned process): joins the
    gloo group of ``world`` ranks on ``device`` (the card by default),
    runs :func:`seqpar_ring` and :func:`seqpar_charlm`, and writes their
    records to ``tmp/seqpar<world>_<rank>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from znicz_torch import backends
    from znicz_torch.core.config import root
    from znicz_torch.parallel import mesh as mesh_mod

    mesh_mod.distributed_init(f"file://{store}", world, rank,
                              backend="gloo", device=device)
    dev = backends.process_device()
    root.common.dirs.snapshots = os.path.join(tmp, f"snapshots{world}_{rank}")
    out = {"ring": seqpar_ring(torch, world, rank, dev),
           "charlm": seqpar_charlm(torch, world, rank, dev, tmp)}
    with open(os.path.join(tmp, f"seqpar{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def seqpar_spawn(world, tmp):
    """:func:`seqpar_rank` on ``world`` spawned ranks; their records."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, f"store{world}")
    procs = [ctx.Process(target=seqpar_rank,
                         args=(rank, world, store, tmp, SEQPAR_DEVICE))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SEQPAR_JOIN_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"[seq_parallel] {world} ranks exited {codes}")
    recs = []
    for rank in range(world):
        with open(os.path.join(tmp, f"seqpar{world}_{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


def seqpar_reference(torch, card, dev):
    """charlm at its defaults from ``ANCHOR_SEED`` on one unmeshed
    ``FusedTrainer`` (``seq_parallel`` off), then again from a start one
    ulp away in one weight, the yardstick of how far rounding alone
    drifts over the run (phase 16's; ``mha.wq[0, 0]``: the embedding's
    first row is the pad id's, which the corpus never holds): (TRAIN
    losses, finals, {leaf:
    start tensor}, {leaf: final tensor}, warm steps a second, the
    yardstick's (max loss error, max|d|, share of the move))."""
    from znicz_torch.__main__ import finals as sample_finals
    from znicz_torch.core import prng
    from znicz_torch.nn_units import params_of
    from znicz_torch.samples import train
    from znicz_torch.weights import params_to_numpy

    def flat(wf):
        return {f"{name}.{k}": torch.from_numpy(a)
                for name, leaves in params_to_numpy(wf).items()
                for k, a in leaves.items()}

    runs = []
    for nudge in (False, True):
        prng.reset(ANCHOR_SEED)
        wf = sample_workflow("charlm", dev)
        if nudge:                       # the attention's first weight
            w = next(params_of(f)["wq"] for f in wf.forwards
                     if f.name == "mha")
            with torch.no_grad():
                w.view(-1)[0] = torch.nextafter(
                    w.view(-1)[0], torch.tensor(np.inf, device=w.device))
        else:
            start = flat(wf)
        train(wf, "charlm", fused=True)
        runs.append(([float(x) for x in wf.decision.train_losses],
                     sample_finals("charlm", wf), flat(wf),
                     wf.train_stats["warm_img_per_sec"]
                     / wf.loader.max_minibatch_size))
        del wf
    (losses, fin, final, rate), (n_losses, _, n_final, _) = runs
    loss_err = float(np.max(np.abs(np.array(n_losses) - losses)
                            / np.abs(losses)))
    worst, outside, share = shard_drift(torch, n_final, final, start)
    log(f"[seq_parallel:yardstick] {card}: charlm unmeshed from a start 1 "
        f"ulp away in mha.wq[0, 0]: losses within {loss_err:.3g}, the "
        f"final tree within {worst:.3g} ({len(outside)} leaves outside the "
        f"band {SHARD_RTOL} / {SHARD_ATOL}), at most {share:.3g} of the "
        f"move")
    return losses, fin, start, final, rate, (loss_err, worst, share)


def seqpar_lookup_cost(torch, card, dev, rate):
    """The cost of summing the embedding's gradient in index order
    (``attention._Lookup``: a stable sort and one pass on the card)
    against ``index_select``'s own backward (``index_add_``'s atomics,
    whose order two ranks of one ring may not share), at charlm's lookup
    (:data:`SEQPAR_LOOKUP`): ms of one eager forward + backward each way
    (CUDA events around the calls on the card, host-paced at this size),
    timed in the order sorted, atomic, atomic, sorted, beside one
    unmeshed step (1 / ``rate``).  The two sums agree within
    float32 and the sorted one gives the same bits twice."""
    from znicz_torch.attention import _Lookup

    n, vocab, embed = SEQPAR_LOOKUP
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    g = torch.randn((n, embed), generator=gen, device=dev)
    table = torch.randn((vocab, embed), generator=gen,
                        device=dev).requires_grad_(True)

    def sorted_sum():
        table.grad = None
        _Lookup.apply(table, idx).backward(g)
        return table.grad

    def atomic_sum():
        table.grad = None
        torch.index_select(table, 0, idx).backward(g)
        return table.grad

    a, b, c = sorted_sum().clone(), sorted_sum().clone(), atomic_sum()
    if not torch.equal(a, b) or not torch.allclose(a, c, rtol=1e-5,
                                                   atol=1e-5):
        raise AssertionError(
            f"[seq_parallel:lookup] the sorted sum is not reproducible or "
            f"leaves the atomic one: {float((a - b).abs().max())}, "
            f"{float((a - c).abs().max())}")

    def timed(fn):
        if dev.type == "cuda":
            return cuda_ms(torch, fn, SEQPAR_LOOKUP_ITERS)
        return _host_ms(torch, dev, fn, SEQPAR_LOOKUP_ITERS)

    ms = [timed(fn) for fn in (sorted_sum, atomic_sum, atomic_sum,
                               sorted_sum)]
    sorted_ms, atomic_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    step_ms = 1e3 / rate
    log(f"[seq_parallel:lookup] {card}: charlm's embedding lookup "
        f"({n} ids into ({vocab}, {embed})), forward + backward: sorted "
        f"sum {sorted_ms:.4f} ms, index_add_'s atomics {atomic_ms:.4f} ms "
        f"(runs {[round(x, 4) for x in ms]}); the difference "
        f"{sorted_ms - atomic_ms:.4f} ms against an unmeshed step's "
        f"{step_ms:.4f} ms ({(sorted_ms - atomic_ms) / step_ms:.2%}); "
        f"sorted max|d| to the atomic {float((a - c).abs().max()):.3g}, "
        f"the same bits twice")


def seqpar_ring_log(card, world, recs):
    """Check and print (a)'s records of one spawn."""
    for case in recs[0]["ring"]:
        rows = [r["ring"][case] for r in recs]
        bad = [i for i, r in enumerate(rows) if not r["ok"]]
        worst = [max(r["max_abs_err"][i] for r in rows) for i in range(4)]
        r0 = rows[0]
        log(f"[seq_parallel:a] {card}: ring over {world} gloo ranks, "
            f"{case} {SEQPAR_RING[case.split(':')[0]]}: ring "
            f"{r0['ring_fwd_ms']:.3f} ms forward, "
            f"{r0['ring_fwd_bwd_ms']:.3f} ms forward + backward a call; "
            f"dense core (rank 0 alone) {r0['dense_fwd_ms']:.3f} / "
            f"{r0['dense_fwd_bwd_ms']:.3f} ms; max|d| against the dense "
            f"core y {worst[0]:.3g} dq {worst[1]:.3g} dk {worst[2]:.3g} "
            f"dv {worst[3]:.3g} (tol {SEQPAR_FWD_TOL} / {SEQPAR_GRAD_TOL}); "
            f"P2P a rank for one forward + backward: "
            f"{r0['p2p']['calls']} calls, {r0['p2p']['bytes']} bytes, "
            f"{r0['p2p']['seconds'] * 1e3:.3f} ms of host time")
        if bad:
            raise AssertionError(f"[seq_parallel:a] {world} ranks, {case}: "
                                 f"ranks {bad} outside the tolerances")
        if r0["p2p"]["calls"] != 2 * (world - 1):
            raise AssertionError(f"[seq_parallel:a] {case}: "
                                 f"{r0['p2p']['calls']} P2P calls, not "
                                 f"{2 * (world - 1)}")


def seqpar_charlm_log(torch, card, world, recs, ref, tmp):
    """Check and print (b)'s records of one spawn against the unmeshed
    run ``ref`` (:func:`seqpar_reference`)."""
    want_losses, want_fin, start, want, want_rate, yard = ref
    # a one-ulp difference drifts over the whole run (ROADMAP C.5): the
    # run is held to phase 16's multiple of the yardstick's drift
    limits = (max(SHARD_LOSS_RTOL, SHARD_DRIFT_FACTOR * yard[0]),
              SHARD_DRIFT_FACTOR * yard[1], SHARD_DRIFT_FACTOR * yard[2])
    shape = SEQPAR_MESHES[world]
    trees = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"charlm{world}_{rank}.npz")) as z:
            trees.append({k: torch.from_numpy(z[k]) for k in z.files})
    # each rank rings over the model ranks of its own data row
    rows = [[[r["charlm"]["data"] * shape[1] + j for j in range(shape[1])]]
            for r in recs]
    first, unequal = {}, []                 # data row -> its first rank
    for rank, r in enumerate(recs):
        r0 = first.setdefault(r["charlm"]["data"], rank)
        if any(not torch.equal(trees[rank][k], trees[r0][k])
               for k in trees[rank]):
            unequal.append(rank)
    rec = recs[0]["charlm"]
    worst, outside, share = shard_drift(torch, trees[0], want, start)
    _, moved_out, _ = shard_drift(torch, start, want, start)
    errs = (np.abs(np.array(rec["losses"]) - want_losses)
            / np.abs(want_losses))
    fin = rec["finals"]
    log(f"[seq_parallel:b] {card}: charlm (root.charlm defaults) on "
        f"FusedTrainer on {shape} of {world} gloo ranks, seq_parallel "
        f"{SEQPAR_SP}: attention bound {[r['charlm']['bound'] for r in recs]}"
        f" ring ranks {[r['charlm']['ring_ranks'] for r in recs]}; "
        f"{json.dumps(fin)}; warm steps/s "
        f"{rec['steps_per_s']:.1f} (one unmeshed FusedTrainer "
        f"{want_rate:.1f}, its VALID token error "
        f"{want_fin['valid_token_err_pct']:.2f}%); run() {rec['wall_s']:.2f}s;"
        f" TRAIN losses against the unmeshed run: first {STEP_CHECK} max "
        f"rel {float(errs[:STEP_CHECK].max()):.3g} (rtol {SHARD_LOSS_RTOL}), "
        f"all {len(errs)} max rel {float(errs.max()):.3g} (limit "
        f"{limits[0]:.3g}); final tree max|d| {worst:.3g} (limit "
        f"{limits[1]:.3g}), at most {share:.3g} of the move (limit "
        f"{limits[2]:.3g}; {len(outside)} leaves outside the band "
        f"{SHARD_RTOL} / {SHARD_ATOL}, the unmeshed run moved "
        f"{len(moved_out)} of {len(want)} out of it); rank 0's collectives "
        f"{rec['collectives']}; ranks unequal within their data row "
        f"{unequal}")
    if not all(all(r["charlm"]["bound"]) and r["charlm"]["bound"]
               for r in recs) \
            or [r["charlm"]["ring_ranks"] for r in recs] != rows \
            or not rec["uncaptured"]:
        raise AssertionError(
            f"[seq_parallel:b] {shape}: the attention did not bind to its "
            f"data row's model ranks {rows}: "
            f"{[r['charlm']['ring_ranks'] for r in recs]}, "
            f"{rec['uncaptured']}")
    if unequal:
        raise AssertionError(f"[seq_parallel:b] {shape}: ranks {unequal} "
                             f"differ from their data row's")
    if len(errs) != len(want_losses) or \
            float(errs[:STEP_CHECK].max()) > SHARD_LOSS_RTOL or \
            float(errs.max()) > limits[0]:
        raise AssertionError(f"[seq_parallel:b] {shape}: TRAIN losses leave "
                             f"the band: {errs}")
    if worst > limits[1] or share > limits[2]:
        raise AssertionError(f"[seq_parallel:b] {shape}: the final tree "
                             f"drifts {worst:.3g} / {share:.3g}, past "
                             f"{limits[1:]}")
    if not fin["valid_token_err_pct"] < CHARLM_VALID_ERR:
        raise AssertionError(f"[seq_parallel:b] {shape}: VALID token error "
                             f"{fin['valid_token_err_pct']:.2f}% is not "
                             f"under {CHARLM_VALID_ERR}%")
    if any(any(r["charlm"]["launches"].values()) for r in recs):
        raise AssertionError(f"[seq_parallel:b] a kernel launched: "
                             f"{[r['charlm']['launches'] for r in recs]}")


def seqpar_tuning(torch, card, dev, tmp):
    """(c): the genetic search on the card (``GeneticsOptimizer`` with
    ``SubprocessEvaluator(workers=1)`` over ``python -m znicz_torch mnist
    --fused ... --fitness``, tuning ``root.mnist.learning_rate`` in [0.01, 1.0]:
    :data:`GA_GENERATIONS` generations of :data:`GA_POPULATION`, every
    individual a finite fitness); ``DeviceBenchmark`` (cuda faster than
    cpu); CD-1 on MNIST rows (the reconstruction error down to
    :data:`RBM_DROP` of its first).  Cut from the defaults: MNIST trains
    :data:`GA_EPOCHS` epochs a run, not 5; the GA runs 2 generations of
    4, not 5 of 8."""
    from znicz_torch import datasets
    from znicz_torch.accelerated_units import DeviceBenchmark
    from znicz_torch.all2all import All2AllSigmoid
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.genetics import (GeneticsOptimizer, SubprocessEvaluator,
                                      Tune)
    from znicz_torch.memory import Array
    from znicz_torch.nn_units import ForwardBase
    from znicz_torch.rbm import GradientRBM

    prng.reset(ANCHOR_SEED)
    cfg = root.ga_chip_smoke
    cfg.learning_rate = Tune(float(root.mnist.get("learning_rate", 0.1)),
                             0.01, 1.0)
    extra = ([] if SEQPAR_DEVICE is None else ["--device", SEQPAR_DEVICE])
    evaluator = SubprocessEvaluator(
        "mnist", overrides=GA_OVERRIDES + extra + [
            f"root.common.dirs.snapshots={os.path.join(tmp, 'ga')}"],
        prefix="root.mnist", timeout=GA_TIMEOUT_S)
    runs, launch, read = [], evaluator.launch, evaluator.fitness_from

    def timed_launch(assignments):
        proc = launch(assignments)
        proc.started, proc.lr = time.perf_counter(), assignments
        return proc

    def recorded(proc):
        fit = read(proc)
        runs.append((proc.lr["learning_rate"], fit,
                     time.perf_counter() - proc.started))
        return fit

    evaluator.launch, evaluator.fitness_from = timed_launch, recorded
    opt = GeneticsOptimizer(config_root=cfg, generations=GA_GENERATIONS,
                            population=GA_POPULATION, workers=1,
                            subprocess_evaluator=evaluator)
    t0 = time.perf_counter()
    best, fitness = opt.run()
    wall = time.perf_counter() - t0
    log(f"[seq_parallel:c] {card}: GA over python -m znicz_torch mnist "
        f"--fused --fitness ({GA_GENERATIONS} generations of {GA_POPULATION}, "
        f"{GA_EPOCHS} epochs a run, workers 1): {len(runs)} runs (lr, valid "
        f"error, s) "
        + ", ".join(f"({lr:.4f}, {fit:.4f}, {s:.2f})" for lr, fit, s in runs)
        + f"; best lr {best[0]:.4f} fitness {fitness:.4f}, history "
        f"{opt.history}; {wall:.2f}s")
    if len(runs) != GA_POPULATION + (GA_GENERATIONS - 1) * (
            GA_POPULATION - 1) or not all(np.isfinite(f) for _, f, _ in runs):
        raise AssertionError(f"[seq_parallel:c] GA runs {runs}")

    bench = DeviceBenchmark()
    results = bench.run()
    log(f"[seq_parallel:c] {card}: DeviceBenchmark (matmul + tanh forward, "
        f"backward and update at {bench.size}) s a step "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in results.items())
        + f"; best {bench.best()}")
    if SEQPAR_DEVICE is None and bench.best() != "cuda":
        raise AssertionError(f"[seq_parallel:c] DeviceBenchmark best "
                             f"{bench.best()}: {results}")

    rows = datasets.digits(RBM_ROWS, stream="dataset.rbm")[0].reshape(
        RBM_ROWS, -1).astype(np.float32)
    wf = Workflow(name="rbm")
    hidden = All2AllSigmoid(name="rbm_h", output_sample_shape=(RBM_HIDDEN,))
    hidden.build(rows.shape, dev)
    rbm = GradientRBM(wf, name="rbm_gd",
                      hidden=ForwardBase(wf, module=hidden),
                      learning_rate=RBM_LR)
    rbm.input = Array(rows)
    rbm.input.initialize(dev)
    rbm.batch_size = RBM_ROWS
    rbm.initialize(device=dev)
    errs = []
    t0 = time.perf_counter()
    for _ in range(RBM_STEPS):
        rbm.run()
        errs.append(rbm.reconstruction_error)
    wall = time.perf_counter() - t0
    log(f"[seq_parallel:c] {card}: RBM CD-1 on {RBM_ROWS} MNIST rows, "
        f"784 -> {RBM_HIDDEN}, lr {RBM_LR}: reconstruction error "
        f"{errs[0]:.4f} -> {errs[-1]:.4f} in {RBM_STEPS} steps, "
        f"{wall * 1e3 / RBM_STEPS:.3f} ms a step (host, the error read "
        f"each step)")
    if not errs[-1] < RBM_DROP * errs[0]:
        raise AssertionError(f"[seq_parallel:c] the RBM's reconstruction "
                             f"error {errs[0]} -> {errs[-1]}")


def seq_parallel_phase(torch, card):
    """Phase 27: (a) and (b) on spawns of 2 and of 4 gloo ranks on the
    card, then (c) in this process.  No kernel lies on this path (the
    ring is PyTorch ops and gloo P2P, as the reference's is XLA ops and
    ``ppermute``): every count stays 0.  Returns {label: {kernel:
    launches}}."""
    from znicz_torch import backends

    dev = backends.resolve_device(SEQPAR_DEVICE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seqpar_")
    ctrs = counters()
    try:
        ref = seqpar_reference(torch, card, dev)
        seqpar_lookup_cost(torch, card, dev, ref[4])
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        for world in SEQPAR_MESHES:
            t0 = time.perf_counter()
            recs = seqpar_spawn(world, tmp)
            log(f"[seq_parallel] {world} ranks spawned, run and joined in "
                f"{time.perf_counter() - t0:.2f}s")
            seqpar_ring_log(card, world, recs)
            seqpar_charlm_log(torch, card, world, recs, ref, tmp)
        seqpar_tuning(torch, card, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: fn.launches for name, fn in ctrs.items()}
    if any(launches.values()):
        raise AssertionError(f"[seq_parallel] a kernel launched: {launches}")
    return {"seq_parallel": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated kernels: run phases 1-2 for them "
                         "alone; 'anchors': phases 7-8; 'units': phase 9; "
                         "'bf16': phase 10; 'mnist_ae', 'kohonen': phase "
                         "11 for that sample; 'kinds': phase 12; "
                         "'samples': phase 13; 'segments': phase 14; "
                         "'deep': phase 15; 'shard': phase 16; "
                         "'snapshots': phase 17; 'zmq': phase 18; "
                         "'graphs': phase 19; 'serve_mesh': phase 20; "
                         "'fleet': phase 21; 'aot': phase 22; 'master': "
                         "phase 23; 'tree': phase 24; 'charlm': phase 25; "
                         "'generate': phase 26; 'seq_parallel': phase 27")
    ap.add_argument("--aot-child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--trace", default="",
                    help="write the anchor runs' per-step losses and "
                         "per-epoch metrics to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from znicz_torch.core.config import root

    snapshots = tempfile.mkdtemp(prefix="chip_smoke_snapshots_")
    root.common.dirs.snapshots = snapshots
    try:
        if args.aot_child:
            print(json.dumps(aot_child(json.loads(args.aot_child))),
                  flush=True)
            return 0
        return run_phases(torch, args)
    finally:
        shutil.rmtree(snapshots, ignore_errors=True)
        if _STAR_DATA["dir"] is not None:
            shutil.rmtree(_STAR_DATA["dir"], ignore_errors=True)


def run_phases(torch, args) -> int:
    from znicz_torch import _build
    from znicz_torch.core import prng
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.serving.model import ModelRunner

    start = time.perf_counter()

    def lap(done: str) -> None:
        log(f"[clock] {done} done {time.perf_counter() - start:.1f}s after "
            f"the start")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[build] {len(build_logs)} libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    # each kernel's ptxas report: per instantiation, registers, spills,
    # static smem
    for lib, tag in (("fused_block", "K1"), ("fused_block_bwd", "K1b"),
                     ("lrn", "K3"), ("lrn_bwd", "K3b"), ("bias_relu", "K2"),
                     ("bias_relu_bwd", "K2b")):
        for line in build_logs.get(lib, "").splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                log(f"[build] {tag} ptxas: {line.strip()}")

    if args.only:
        names = args.only.split(",")
        anchors, units = "anchors" in names, "units" in names
        bf16, kinds = "bf16" in names, "kinds" in names
        samples, segments = "samples" in names, "segments" in names
        deep, shard = "deep" in names, "shard" in names
        snapshots, zmq = "snapshots" in names, "zmq" in names
        graphs, serve_mesh = "graphs" in names, "serve_mesh" in names
        fleet = "fleet" in names
        aot, master = "aot" in names, "master" in names
        tree, charlm = "tree" in names, "charlm" in names
        generate, seq_parallel = "generate" in names, "seq_parallel" in names
        ae_som = [name for name in names if name in AE_SOM_RUNS]
        names = [name for name in names if name not in
                 ("anchors", "units", "bf16", "kinds", "samples",
                  "segments", "deep", "shard", "snapshots", "zmq",
                  "graphs", "serve_mesh", "fleet", "aot", "master", "tree",
                  "charlm", "generate", "seq_parallel", *AE_SOM_RUNS)]
        if units:
            names += [n for n in ("lrn_fwd", "lrn_bwd") if n not in names]
        rows = check_kernels(torch, names)
        if "fused_block_fwd" in names:
            check_k1_paths(torch)
        if "fused_block_bwd" in names:
            check_k1b_paths(torch)
        if "lrn_fwd" in names:
            check_k3_paths(torch)
        if "bias_relu_bwd" in names:
            check_k2b_paths(torch)
        if "lrn_bwd" in names:
            check_k3b_paths(torch)
        if set(BF16_PATHS) & set(names):
            check_bf16_paths(torch, names)
        if set(BF16_LRN) & set(names):
            check_bf16_lrn_paths(torch)
        if anchors:
            cifar_rows(torch, rows)
            for label, launches in anchors_phase(torch, card,
                                                 args.trace).items():
                for name, count in launches.items():
                    if count:
                        rows[name].setdefault("launches_by_path", {})[
                            f"anchor:{label}"] = count
        if units:
            for label, launches in units_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows[name].setdefault("launches_by_path", {})[
                            f"units:{label}"] = count
        if bf16:
            bf16_rows, runs = bf16_phase(torch, card)
            rows.update(bf16_rows)
            for label, launches in runs.items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[f"train:{label}"] = count
        if ae_som:
            ae_som_phase(torch, card, ae_som)
        if kinds:
            for label, launches in kinds_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[f"kinds:{label}"] = count
        if samples:
            for label, launches in samples_phase(torch, card, rows).items():
                for name, count in launches.items():
                    if count:
                        rows[name].setdefault("launches_by_path", {})[
                            f"samples:{label}"] = count
        if segments:
            for label, launches in segments_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[
                                f"segments:{label}"] = count
            lap("phase 14")
        if deep:
            for label, launches in deep_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[f"deep:{label}"] = count
            lap("phase 15")
        if shard:
            for label, launches in shard_phase(torch, card, rows).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[f"shard:{label}"] = count
            lap("phase 16")
        if snapshots:
            for label, launches in snapshots_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[
                                f"snapshots:{label}"] = count
            lap("phase 17")
        if zmq:
            for label, launches in zmq_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[label] = count
            lap("phase 18")
        if graphs:
            for label, launches in graphs_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[label] = count
            lap("phase 19")
        if serve_mesh:
            for label, launches in serve_mesh_phase(torch, card,
                                                    rows).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[label] = count
            lap("phase 20")
        if fleet:
            for label, launches in fleet_phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[label] = count
            lap("phase 21")
        for flag, phase, tag in ((aot, aot_phase, "phase 22"),
                                 (master, master_phase, "phase 23"),
                                 (tree, tree_phase, "phase 24"),
                                 (charlm, charlm_phase, "phase 25"),
                                 (generate, generate_phase, "phase 26"),
                                 (seq_parallel, seq_parallel_phase,
                                  "phase 27")):
            if not flag:
                continue
            for label, launches in phase(torch, card).items():
                for name, count in launches.items():
                    if count:
                        rows.setdefault(name, {"name": name}).setdefault(
                            "launches_by_path", {})[label] = count
            lap(tag)
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        return 0

    lap("phase 1")

    # -- phase 2: forward kernels against their plain versions --------------
    rows = check_kernels(torch, ["fused_block_fwd", "bias_relu_fwd",
                                 "lrn_fwd"])
    check_k1_paths(torch)
    check_k3_paths(torch)
    # hand the paths' cached blocks back, so that the timed phases start
    # with the allocator as the AlexNet-shape checks leave it
    torch.cuda.empty_cache()

    lap("phase 2")

    # -- phase 3/4: the served path -----------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prng.reset(SEED)
    wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000)
    with torch.no_grad():
        for f in wf.forwards:
            if f.bias is not None:
                f.bias.normal_(0.0, 0.05, generator=gen)
    widths = [f.n_kernels if hasattr(f, "n_kernels") else
              f.output_samples_number for f in wf.forwards if f.has_weights]
    log(f"[model] AlexNet widths {widths} on {wf.device}")
    requests = make_requests()

    # references: the same rows through the composed forward (knobs off)
    ref_runner = ModelRunner(wf, capture=False)
    t0 = time.perf_counter()
    refs = [ref_runner.infer(x) for x in requests]
    log(f"[reference] {len(refs)} requests composed "
        f"{time.perf_counter() - t0:.2f}s; logits std "
        f"{float(np.std(np.concatenate(refs))):.4f}")
    if not float(np.std(np.concatenate(refs))) > 0:
        raise AssertionError("degenerate logits")

    phases = [
        ("fused", {"fused_elementwise": True, "fused_tail": True},
         {"fused_block_fwd": 2, "bias_relu_fwd": 3, "lrn_fwd": 0}),
        ("pallas_lrn", {"pallas_lrn": True, "fused_tail": True},
         {"fused_block_fwd": 0, "bias_relu_fwd": 5, "lrn_fwd": 2}),
    ]
    # device time of one batch-128 forward on each path (CUDA events)
    from znicz_torch.core.config import root

    staged = ref_runner.stage(np.concatenate(requests)[:BATCH])
    for label, knobs, _ in [("composed", {}, None)] + phases:
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        t = cuda_ms(torch, lambda: ref_runner.infer_staged(staged), iters=10)
        for key in knobs:
            setattr(root.common.engine, key, False)
        log(f"[forward] {label} batch {BATCH}: {t:.3f} ms on the device "
            f"({BATCH / t * 1e3:.0f} images/s)")
    del staged
    by_path = {name: {} for name in KERNELS}
    for label, knobs, expect in phases:
        replies, launches, stats = serve_phase(torch, label, wf, requests,
                                               knobs, expect)
        check_replies(label, replies, refs)
        for name, count in launches.items():
            if expect[name]:
                by_path[name][f"serve:{label}"] = count
        log(f"[{label}] {card}: images/s={stats['images_per_s']:.1f} "
            f"p50_ms={stats['p50_ms']:.2f} p99_ms={stats['p99_ms']:.2f} "
            f"occupancy={stats['batcher']['mean_occupancy']:.3f}")
    del wf, ref_runner, refs, requests
    torch.cuda.empty_cache()

    lap("phases 3/4")

    # -- phase 5: backward kernels against their plain versions -------------
    rows.update(check_kernels(torch, ["fused_block_bwd", "bias_relu_bwd",
                                      "lrn_bwd"]))
    check_k1b_paths(torch)
    check_k2b_paths(torch)
    check_k3b_paths(torch)
    torch.cuda.empty_cache()

    lap("phase 5")

    # -- phase 6: the training path -----------------------------------------
    for label, launches in train_phase(torch, card).items():
        for name, count in launches.items():
            if TRAIN_ROUTINGS[label][1].get(name):
                by_path[name][f"train:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 6")

    # -- phase 7: K2, K2b, K3, K3b at CIFAR10's shapes ----------------------
    cifar_rows(torch, rows)

    lap("phase 7")

    # -- phase 8: the MNIST and CIFAR10 anchors ------------------------------
    for label, launches in anchors_phase(torch, card, args.trace).items():
        for name, count in launches.items():
            if ANCHOR_RUNS[label][3].get(name):
                by_path[name][f"anchor:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 8")

    # -- phase 9: the unit-at-a-time engine ---------------------------------
    for label, launches in units_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][f"units:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 9")

    # -- phase 10: bf16 training ---------------------------------------------
    bf16_rows, runs = bf16_phase(torch, card)
    rows.update(bf16_rows)
    for label, launches in runs.items():
        for name, count in launches.items():
            if count and label.startswith("bf16"):
                by_path[name][f"train:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 10")

    # -- phase 11: MnistAE and Kohonen on the unit engine --------------------
    ae_som_phase(torch, card)
    torch.cuda.empty_cache()

    lap("phase 11")

    # -- phase 12: the layer kinds ported last -------------------------------
    for label, launches in kinds_phase(torch, card).items():
        for name, count in launches.items():
            if KIND_ROUTINGS[label][1].get(name):
                by_path[name][f"kinds:{label}"] = count

    lap("phase 12")

    # -- phase 13: Kanji, VideoAE, YaleFaces and the host runtime -----------
    for label, launches in samples_phase(torch, card, rows).items():
        for name, count in launches.items():
            if SAMPLE_RUNS[label][3].get(name):
                by_path[name][f"samples:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 13")

    # -- phase 14: segments as CUDA-graph replays, remat, async snapshots,
    # -- the staged and file-streamed data paths ---------------------------
    for label, launches in segments_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][f"segments:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 14")

    # -- phase 15: the deep pipeline: epochs queued back to back, metrics
    # -- read late, the fail-stop rollback, snapshots at flushes ----------
    for label, launches in deep_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][f"deep:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 15")

    # -- phase 16: the fused trainer on a mesh of gloo ranks on the card:
    # -- data sharding, column-sharded fc6/fc7, the deep pipeline -------
    for label, launches in shard_phase(torch, card, rows).items():
        for name, count in launches.items():
            if count:
                by_path[name][f"shard:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 16")

    # -- phase 17: a sharded orbax snapshot across mesh shapes, and the
    # -- served swap to it and the rollback ----------------------------
    for label, launches in snapshots_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][f"snapshots:{label}"] = count
    torch.cuda.empty_cache()

    lap("phase 17")

    # -- phase 18: the served path over ZMQ: the ROUTER frontend and the
    # -- clients, admission and control, the --serve entry point -------
    for label, launches in zmq_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 18")

    # -- phase 19: each ladder rung a captured CUDA graph, against eager;
    # -- a swap and a rollback of graph families; the chaos harness -----
    for label, launches in graphs_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 19")

    # -- phase 20: the serving mesh: two gloo ranks on the card ---------
    for label, launches in serve_mesh_phase(torch, card, rows).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 20")

    # -- phase 21: the replica fleet: a balancer in front of two replicas;
    # -- failover, canary waves, healing ------------------------------
    for label, launches in fleet_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 21")

    # -- phase 22: the build cache: cold, warm, refused and healed boots
    # -- in child processes with empty build directories ----------------
    for label, launches in aot_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 22")

    # -- phase 23: the master/slave star: one slave against one process,
    # -- two slaves and a lost job, the LRN kernels on a unit slave -----
    for label, launches in master_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 23")

    # -- phase 24: the relay tree: one slave behind a relay against one
    # -- process, two slaves and a relay killed, the meshed slave ------
    for label, launches in tree_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 24")

    # -- phase 25: the sequence model: charlm trained on both engines, then
    # -- served on the 2-D (rows x seq) ladder of captured buckets ------
    for label, launches in charlm_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 25")

    # -- phase 26: charlm generating: the paged runner, the sampler, the
    # -- service under mixed traffic, --serve --generate over ZMQ -------
    for label, launches in generate_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 26")

    # -- phase 27: ring attention over gloo ranks on the card, charlm on a
    # -- sequence mesh, the genetic search, the device benchmark, an RBM
    for label, launches in seq_parallel_phase(torch, card).items():
        for name, count in launches.items():
            if count:
                by_path[name][label] = count
    torch.cuda.empty_cache()

    lap("phase 27")

    for name, row in rows.items():
        if not by_path[name] or not all(by_path[name].values()):
            raise AssertionError(f"{name} was not launched on a main path: "
                                 f"{by_path[name]}")
        row["launches"] = sum(by_path[name].values())
        row["launches_by_path"] = by_path[name]

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
