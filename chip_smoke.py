#!/usr/bin/env python3
"""Drives the PyTorch/H100 port's main paths once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--actions N] [--steps N]
                          [--snail-steps N] [--profile]
    python3 chip_smoke.py --main-path-turns OTHER_CHECKOUT [--actions N]

Run from the repository root. ``--main-path-turns`` runs only phases 1, 2
and the main path's timing (phase 5's ms/action) of this checkout and of
OTHER_CHECKOUT in turns (other, this, this, other), each turn a child
process run from its checkout's root, and prints the ms/action of each
turn as JSON. The phases of a run without it:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   both TF32 flags. The paths and timings run at torch's defaults (cuDNN
   TF32 on, cuBLAS TF32 off); each check phase turns both off for itself
   and restores them, and the run fails if they are not restored;
2. build every CUDA kernel from ``tensor2robot_tpu_torch/ops/csrc``, one
   ``nvcc`` per source, all started together; ptxas's stack-frame line of
   each ``fused_update_kernel`` instantiation is printed and must read 0
   bytes (its table is a ``__grid_constant__`` parameter); ptxas's
   registers, stack frame and spills of every instantiation of the flash
   kernels (``flash_fwd_mma_kernel``, ``flash_fwd_kernel``,
   ``flash_dq_mma_kernel``, ``flash_dq_kernel``, ``flash_dkv_mma_kernel``,
   ``flash_dkv_kernel``), of the pool backward's ``pool_bwd_scatter_kernel``
   and of conv1's ``conv_dx_mma_kernel``, ``conv_fwd_ffma_kernel`` and
   ``conv_dx_ffma_kernel`` are printed;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the pool forward bitwise (values and slots) at the
   three QT-Opt pools in bfloat16 at B=64 and B=32, pool1 in float32, a
   C=3 and a storage-offset case (the one-channel instantiation), an
   overlapping 3x3/s2 window, a planted tie and NaN, -0.0 and +0.0 at slot
   0; the pool backward bit for bit (routed gradients, NaN, -0.0 and
   infinite cotangents planted) at the three pools in bfloat16 at B=32 and
   B=64 and pool1 in float32, a VALID case with uncovered tails, C=3, an
   unaligned cotangent and a runtime window on the scatter route, odd and
   overlapping cases on the gather route (the route and launch choice
   logged and counted), and a planted tie; conv1 forward at
   [64, 472, 472, 3] and [32, 472, 472, 3] (and in float32 also with x
   off 16-byte alignment) and its dW and dx at [32, 472, 472, 3], all
   also at an odd geometry ([4, 101, 97, 2], 5x5/s3, Cout 48), in
   bfloat16 (band: 2**-7 relative, one bfloat16 ulp, plus 1e-6 for the
   forward and 1e-5 of the largest magnitude for the gradients'
   reassociated sums) and in float32 with TF32 off (band 1e-5), and dx in
   bfloat16 on the CUDA cores at the odd geometry with an unaligned
   cotangent; the forward, dW and dx (bfloat16 on the tensor cores,
   float32 on the CUDA cores, the route and plan logged and counted) run
   twice must agree bit for bit; the flash attention forward
   (out and lse), dq and dk/dv, causal and full, at the SNAIL shapes [2, 1024, 8, 8] and [8, 80, 1, 64]
   (float32), bench.py's [2, 4096, 8, 64] (float32 and bfloat16), the
   streamed-regime shapes [1, 33792, 1, 64] (bfloat16) and
   [1, 17408, 1, 64] (float32), and the bfloat16 forward's route edges
   (a ragged T = 1000, D = 16 and 128 on the tensor cores, D = 8 on the
   CUDA cores), each run twice bit for bit, the forward's, dq's and dk/dv's
   routes and plans logged (bands: the JAX suite's, float32 out 2e-5 and
   gradients 5e-4, bfloat16 3e-2, lse 2e-5, times the largest magnitude
   when above 1; out's relative L2 error within FLASH_OUT_REL_L2 and dq's,
   dk's and dv's within FLASH_GRAD_REL_L2, which two controls must fail:
   the plain result rounded to a narrower type, and the plain function
   with V, or for the gradients dO, taken one 64-row tile early);
   the fused optimizer update in all 8
   variants (Adam or SGD, EMA on or off, guard on or off) over the real
   leaves of SNAIL long-horizon (115) and Grasping44 (59) at a constant and
   a scheduled rate (band atol 1e-6 / rtol 1e-5, twice bit for bit, a False
   guard bitwise untouched); the photometric pass at [32, 472, 472, 3] in
   float32 (1e-6) and bfloat16 (bit for bit the rounding of the float32
   pass, which lies within a band derived from its float32 roundings and
   the two means' difference, and within one ulp wherever that band is
   under half an ulp), twice bit for bit;
4. the serving path at full width: ``GraspingModelWrapper(device_type='gpu',
   kernel_policy='pool_conv')`` -> ``CheckpointPredictor`` with seeded
   random weights -> ``CEMPolicy(64 samples x 3 iterations,
   device_resident=True)`` on 512x640 uint8 frames, one warm-up action and
   then timed actions, with every launch counter set to 0 just before and
   read just after (3 conv1 forwards, on the tensor cores, and 9 pool
   launches per action); then
   ``predict`` on 8 frame/action pairs, and a float32 check of the full
   network on the card against the same network on the CPU (plain
   versions) on 2 pairs: q, and the end points ``pool2``, ``final_conv``
   and ``logits`` (conv1's float32 forward on the CUDA cores, 2 launches
   counted);
5. the training path at full width: ``Trainer(GraspingModelWrapper(
   device_type='gpu', kernel_policy='pool_conv'), TrainerConfig(...))
   .train(...)`` on seeded 512x640 uint8 frames, actions and 0/1 rewards
   at batch 32, one warm-up step and then timed steps, with every launch
   counter set to 0 just before and read just after (per step: 3
   ``pool_fwd``, 3 ``pool_bwd`` on the scatter route, 1 ``conv_s2d_fwd``
   and 1 ``conv_s2d_dw``, both on their tensor-core routes, 0
   ``conv_s2d_dx``); a finite loss, a
   finite gradient on every trainable parameter, parameters and EMA moved;
   then the EMA weights and batch statistics served by a
   ``CheckpointPredictor`` on 8 pairs;
6. checkpoints, resume, eval and serving from a checkpoint at full width,
   batch 32, under deterministic cuDNN without autotuning (restored
   after the phase), all files under a temporary directory below
   ``chiprun_out/`` that the phase removes: ``train_eval_model`` with
   random-data generators, 6 steps, saves and eval passes (2 batches)
   every 3, and an uninterrupted 9-step run; a fresh ``Trainer`` restores
   step 6 bit for bit what was saved (``same_bits`` over the whole
   payload), evaluates to train_eval_model's step-6 metrics exactly, and
   resumes to step 9 bit for bit the uninterrupted run's state;
   ``CheckpointPredictor.restore()`` loads step 9 (q on 8 pairs bit for
   bit a predictor loaded from the state), the device-resident CEM serves
   3 actions from it, and after a save at step 12 a second ``restore()``
   makes the same ``device_serving_fn`` serve step 12; every part's
   launches counted (3 ``pool_fwd``, 3 ``pool_bwd``, 1 ``conv_s2d_fwd``
   and 1 ``conv_s2d_dw`` a step, 3 ``pool_fwd`` and 1 ``conv_s2d_fwd`` an
   eval batch, 9 and 3 an action); the checkpoint's size, the restore,
   the eval pass and the predictor's restore to first action printed
   beside the card, and the split of an async save (the loop's save call
   and its host copy, the step after the save against three quiet steps,
   the writer thread's ``torch.save`` and fsync); and the trainer binary
   (``python -m tensor2robot_tpu_torch.bin.run_t2r_trainer`` on the
   port's ``train_qtopt.gin``, 3 steps) in a subprocess, which must exit
   0 and leave a committed ``ckpt_3``;
6a. export, the exported predictor and the batching plane at full width,
   under deterministic cuDNN without autotuning (restored after the
   phase), files under a temporary directory below ``chiprun_out/`` that
   the phase removes: ``ModelExporter`` writes the seeded serving weights
   as an export version traced on the card (the graph's op nodes, its 3
   ``t2r.pool_fwd`` and 1 ``t2r.conv_s2d_fwd`` nodes, the artifact's bytes
   and the export's ms printed; ``self_contained_serving_fn`` must be
   true); a subprocess that cannot import the port's ``research`` and
   ``models`` modules loads it with ``ExportedModelPredictor`` and
   predicts 8 (frame, grasp) pairs, bit for bit the eager
   ``CheckpointPredictor``'s q, with its restore-to-first-prediction ms
   and launches (3 and 1); ``CEMPolicy(64 x 3, device_resident=True)``
   through the exported predictor and through the eager one in blocks of
   5 actions in turns (eager, exported, exported, eager), ms/action
   printed, the same actions from both, 9 ``pool_fwd`` and 3
   ``conv_s2d_fwd`` launches an action; a program traced on the CPU and
   moved to the card launches the same and chooses the same actions;
   ``DynamicBatcher(max_batch=64)`` over ``ExportedModelPredictor.
   stateless_serving_fn()`` with 8 client threads of 8-example requests
   for 6 s, a second version with other weights exported under load at
   2 s by a process of its own, as a trainer exports: requests/s, examples/s, p50/p99 latency, ``serving/
   bucket_compiles`` after warm-up and at the end (equal), the swap
   (``serving/model_swaps`` at least 1, no failed request, the program
   key kept) and 3/1 launches a dispatch;
6c. HTTP serving at full width, under deterministic cuDNN, files under a
   temporary directory below ``chiprun_out/`` that the phase removes: the
   seeded critic and a second seeded critic exported on the card; two
   ``run_serving`` replicas in router mode (``SERVE_WRAPPER``, a ``python
   -c`` that calls the binary's ``main`` and prints its kernel counters on
   exit): A serving the critic, B both critics under ``--hbm-budget-mb``
   of 1.5 critics. One request of one frame and one grasp to A, bit for
   bit the in-process ``ExportedModelPredictor``'s q at batch 1, its
   ``X-Request-Id`` echoed; ``loadgen`` from this process, closed loop
   (4 clients, 6 s) and then open loop at half that rate for 6 s with
   half the arrivals best-effort (requests/s, examples/s, p50/p99/max and
   the request count on the client's clock, sheds, errors), and the host
   ms of ``json.loads`` + ``np.asarray`` of one request body here (a
   replica decodes such a body in its decoder processes); the two critics
   in turns on B (``page_ins`` up, ``serving/bucket_compiles`` flat, the
   critic's q the lone request's); ``run_balancer`` at its default probe
   and ejection settings over A and B with 2 clients, A SIGTERM'd under
   traffic (drains, exits 0, ejected), restarted on its port and
   readmitted, no failed request; full-sample request tracing's cost to
   the in-process batcher (8 clients over the mock model, 2 rounds of a
   traced and an untraced slice, every round printed); every replica's
   launches after its start
   3 ``pool_fwd`` and 1 ``conv_s2d_fwd`` (tensor cores) a dispatch, no
   plain-version call, bucket warm-ups flat to exit;
6b. the record feed at full width: 4 TFRecord shards of 48 QT-Opt
   examples (seeded 512x640x3 uint8 frames as PNG, actions, 0/1 rewards,
   index sidecars) written into a temporary directory below
   ``chiprun_out/``; ``Trainer`` steps at batch 32 from
   ``NativeRecordInputGenerator`` (the C++ reader and parser, PNG decode
   in the engine's workers, a ring of page-locked slots, the trainer's
   ``non_blocking`` upload on a side stream) on one trainer, in blocks of
   one warm-up step and 10 counted ones (3/3/1/1 ``pool_fwd``/``pool_bwd``/
   ``conv_s2d_fwd``/``conv_s2d_dw`` a step), three feeds taking turns
   twice: the record feed, the same batches decoded beforehand (no feed
   threads), and the record feed with one decode thread an engine worker,
   so the feed's threads and the train loop fit the host's cores;
   under deterministic cuDNN, the state after 8 record-fed steps through a
   ring at its least depth (fewer slots than steps), each slot's frames
   poisoned at its release, bit for bit the state after the same batches
   uploaded by a synchronous ``.to('cuda')``, and a control that releases
   each slot as soon as its upload is issued must differ from it;
   ``train_eval_model(checkpoint_input_state=True)`` stopped at 4 and
   resumed in a fresh ``Trainer`` to 8 bit for bit the uninterrupted 8
   steps; printed beside the card: each feed's ms/step, and the record
   feed's against the synthetic-fed training path's, one batch's 31.5 MB upload pinned
   ``non_blocking`` against pageable (CUDA events), the host's parse +
   decode ms of a batch and the engine's workers, the PNG decode ms of a
   batch of the cell's frames against camera-like frames with row
   filters 1-4, and under ``--profile`` the record-fed steps' device time
   and idle share;
7. dx on a path: a full-width conv1, and the odd geometry, whose input
   requires a gradient launch ``conv_s2d_dx`` once each, in bfloat16 on
   the tensor cores and in float32 on the CUDA cores (with the forward
   and dW), and dx matches the plain version and repeats bit for bit;
8. a float32 training step on the card (kernels) against the same step on
   the CPU (plain versions) at full width and batch 2, TF32 off, both held
   to a float64 CPU gradient of the same step: the losses within 1e-4;
   every leaf of the card's gradient no further from float64 (relative
   L2) than 6x the CPU float32 gradient's worst leaf, and within 0.1 of the
   leaf's largest magnitude of the CPU's (see ``REFERENCE_L2_RATIO``); two
   controls printed leaf by leaf against the same float64 gradient, cuDNN
   deterministic without autotuning and the pools and conv1 left to the
   library, with the cuDNN flags and the card step's kernels by name; the
   card step runs conv1's float32 forward and dW once each on the CUDA
   cores, counted, as the float32 check of phase 4 runs the forward twice;
9. the SNAIL training paths at full width, each a ``Trainer`` with default
   Adam on seeded 220x300 uint8 episodes: ``VRGripperEnvLongHorizonModel(
   episode_length=512, 8 heads of 8)`` at batch 2 and
   ``VRGripperEnvSequentialModel(episode_length=40)`` at batch 8 (the
   repo's ``run_train_long_horizon.gin`` and ``run_train_sequential.gin``),
   one warm-up step and then timed steps, every counter set to 0 just
   before and read just after (per step: 2 ``flash_fwd``, 2 ``flash_dq``,
   2 ``flash_dkv``); a finite loss, a finite gradient on every parameter,
   parameters and Adam moments moved;
10. a float32 long-horizon SNAIL step (episode 64, batch 1), TF32 off, on
   the card through the flash kernels, on the card through the dense
   attention and on the CPU, held to each other and to a float64 CPU
   gradient of the same step (see ``phase_snail_reference``);
11. the fused update paths: QT-Opt training at full width and batch 32 with
   tagged Adam under a decaying rate, the EMA, ``fused_update=True`` and
   ``nonfinite_mode='skip_update'`` (per step: the five kernels above and
   1 ``fused_update``), then one NaN-poisoned batch that must leave
   parameters, moments, counts, EMA, batch statistics, step and generator
   bitwise as they were; both SNAIL paths with ``fused_update=True`` and
   default Adam (per step: 2/2/2 flash and 1 ``fused_update`` launch, the
   stock ``Adam.step`` never entered), each ms/step printed beside the
   stock run's;
12. the fused photometric branch, ``apply_photometric_image_distortions(
   random_brightness=True, random_contrast=True, use_fused_kernel=True)``,
   on QT-Opt's training images at batch 32 against the stock chain on the
   same generator (1e-6), with its launches counted;
12a. K steps a dispatch (``phase_dispatch``) at full width, batch 32,
   bf16, ``pool_conv``, under deterministic cuDNN without autotuning
   (restored after the phase), no plain-version call in the phase:
   ``Trainer(TrainerConfig(steps_per_dispatch=8))`` over 19 batches (two
   captured CUDA graph replays and a 3-batch eager tail), every counter
   set to 0 just before and read just after (its warm-up, capture and
   tail: 19 steps' launches), bit for bit a K=1 trainer over the same
   batches (parameters, batch statistics, momentum, optimizer groups,
   EMA, generator, step); the fused arm (tagged Adam under a decaying
   rate, EMA, ``fused_update``, ``skip_update``) the same with a NaN batch
   at slot 3 of dispatch 2 (step 18, one skip); ``remat_policy=
   'conv_towers'`` one step bit for bit ``'none'`` at batch 32, with the
   peak device memory of both at batch 32 and 96;
   ``grad_accum_microbatches=2`` at batch 64 against the eager
   accumulation written out (``DISPATCH_ACCUM_BAND``); K=1 eager, K=8
   graph and K=8 graph with ``device_feed`` in turns, 2 runs of 48 steps
   each on the same pre-decoded batches: host ms/step, host ms a dispatch
   outside the replay, the superbatch upload's ms (CUDA events) and the
   copies a dispatch, the capture's one-off ms; and the trainer binary on
   the port's ``train_qtopt.gin`` (``steps_per_dispatch = 8`` live; cut to
   64 of its 1000 steps and a save interval of 50, because the host's
   random generator bounds it, with one batch's draw time printed) in a
   subprocess, which must exit 0 and commit steps [56, 64];
12b. Grasp2Vec at the reference config's full width (``phase_grasp2vec``,
   after the K-step path): 4 TFRecord shards of 12 examples, each three
   seeded 512x640x3 uint8 frames as PNG under the spec names ``image``,
   ``postgrasp_image`` and ``present_image``, in a temporary directory
   below ``chiprun_out/`` that the phase removes;
   ``Trainer`` steps of ``Grasp2VecModel(kernel_policy='pool')``
   (ResNet-50 v2 towers, 472x472 crops, bfloat16 activations, float32
   parameters, Adam at 1e-4) at batch 16 from
   ``DefaultRecordInputGenerator``, a warm-up step and 3 counted ones
   (per step 2 ``pool_fwd`` and 2 ``pool_bwd`` on the gather route, 0
   plain calls), ms/step and the peak device memory printed beside the
   card; the same model with ``fused_update=True`` for 4 steps (1
   ``fused_update`` a step), each update held within FUSED_BAND to the
   stock ``Adam.step`` on copies of the same parameters, gradients and
   moments; 12 more steps of the in-process trainer on those batches, its
   state saved through an async ``CheckpointManager`` after the 4th and
   the 8th, with each save's split printed as in phase 6; the trainer
   binary on the port's ``train_grasp2vec.gin``
   (cut to 4 steps, saves every 2, one eval batch) in a subprocess that
   prints its launches, plain calls, step times and peak memory (it must
   exit 0 and commit steps 2 and 4); ``CheckpointPredictor`` restores the
   binary's step 4 and, under deterministic cuDNN, its embeddings and
   spatial maps and the ``heatmap_keypoints`` on 2 frame triples are bit
   for bit the in-process network's in eval mode. The stem pool's kernels
   are held bitwise to their plain versions at [32, 236, 236, 64] and
   [16, 236, 236, 64] bfloat16 with the check phases, timed there with the
   other kernels (rows ``pool_fwd_stem`` and ``pool_bwd_gather``), and the
   step's device time by op is profiled after the other profile phases;
12c. SNAIL sequential from records (``phase_record_snail``, after the
   Grasp2Vec phase): 4 MetaExample shards of 4 records (a condition and
   an inference episode of 40 seeded 220x300x3 uint8 frames as PNG, 14-d
   poses and 7-d actions under the reference's names; about 15.8 MB a
   record) in a temporary directory below ``chiprun_out/`` that the phase
   removes, their size on disk printed; ``Trainer`` steps of
   ``VRGripperEnvSequentialModel`` at ``run_train_sequential.gin``'s
   width (episode 40, batch 8, default Adam) from
   ``DefaultRecordInputGenerator`` through the engine's page-locked ring:
   a warm-up step, then 4 counted ones (2 ``flash_fwd``, 2 ``flash_dq``
   and 2 ``flash_dkv`` a step, 0 plain calls), finite loss and gradients,
   parameters moved; the record feed and the same batches decoded
   beforehand in turns (twice each, 4 timed steps a turn), the host's
   parse + decode ms of one batch of 640 frames, and under ``--profile``
   the device ms and idle share of record-fed steps; the first EVAL batch
   of the feed bit for bit the same records parsed by the plain Python
   decoder; the trainer binary on the port's ``run_train_sequential.gin``
   (cut to 12 steps, saves every 6, 2 eval batches, a shuffle buffer of
   8 records) in a subprocess that must exit 0, commit steps 6 and 12
   and launch the flash kernels for every step and eval batch; and the
   pose_env gate (800 steps at batch 16, seeds 7 and 8, eval ``pose_mse``
   at most 1.5e-3) through the binary on the port's ``run_train_reg.gin``
   and ``tests/test_data/pose_env_test_data.tfrecord`` (its model runs no
   kernel, so it is started before the build, trains beside it and is
   collected right after it, before the first check phase: no timed phase
   runs beside it), with the JPEG route of the host (PIL where ``jpeglib.h`` is absent) printed;
12d. SNAIL and Grasp2Vec served from exported programs
   (``phase_export_models``, after ``phase_record_snail``, deterministic
   cuDNN): SNAIL sequential (``run_train_sequential.gin``: episode 40,
   220x300 frames), SNAIL long-horizon (episode 512, 8 heads of 8) and
   Grasp2Vec (``train_grasp2vec.gin``: ResNet-50 v2, 472x472, bf16, the
   stem pools on the kernels), seeded weights, each exported on the card
   by ``ModelExporter`` (its op and kernel nodes, 2 ``t2r.flash_fwd`` or 2
   ``t2r.pool_fwd``, ``serving_fn.pt2``'s bytes and the export's ms
   printed; ``self_contained_serving_fn`` true); the eager
   ``CheckpointPredictor`` predicts seeded batches of 1 and 8 (Grasp2Vec 1
   and 4), 2 launches a predict counted; ONE subprocess that cannot import
   the port's ``research`` and ``models`` modules loads all three
   versions and predicts the same batches (and the larger once more):
   every output bit for bit the eager one, each predict moving
   ``flash_fwd`` or ``pool_fwd`` by 2, its restore and predict ms printed;
   the photometric pass exported as a program on the card at
   [32, 472, 472, 3] float32, one ``t2r.photometric`` node, launched once
   and bit for bit the eager kernel;
12e. weight-only int8 and fp8 serving (``phase_quantized_serving``): the
   QT-Opt critic (bf16, ``pool_conv``, spread seeded weights) exported on
   the card and served by ``DynamicBatcher(64)`` in full precision, int8
   and fp8 (start ms; param bytes and their ratio; the parity report,
   which must lie within the default band; 3/1 launches a program run,
   the parity check's four included); one dispatch of 64 pairs for each
   in turns (off, int8, fp8, fp8, int8, off; blocks of 10, host clock);
   the zero band (atol = rtol = 0) refused, 1 ``quant_parity_rejects``,
   full precision served bit for bit; ``run_serving --quantize int8`` in
   a process of its own (``SERVE_WRAPPER``) answers one request within
   the band, ``/statz`` shows the active twin, 3/1 launches a dispatch;
   every phase's host seconds are printed before the kernels line;
13. timings with CUDA events (each call after an L2 flush and a spin
   kernel that keeps the card busy while the host enqueues it): each
   kernel, its plain version, one library
   call computing the same function (``F.max_pool2d(return_indices=True)``,
   ``aten.max_pool2d_with_indices_backward``, ``F.conv2d`` in
   channels-last, ``torch.nn.grad.conv2d_weight``,
   ``torch.nn.grad.conv2d_input``, ``F.scaled_dot_product_attention`` and
   its backward, ``torch.optim.Adam(fused=True)``; none for the
   photometric pass; the fused update's row is the trainer's per-step
   call through its packed table and the library's step, both on the host
   clock, since the host bounds them, with the kernel's own device time
   printed beside them, profiled after an L2 flush), and each kernel's
   bound on an H100
   SXM (3.35 TB/s;
   989 TFLOP/s for bf16 inputs, 67 TFLOP/s for float32 ones); conv1's
   float32 routes on the CUDA cores have rows of their own
   (``conv_s2d_fwd_float32`` at [64, 472, 472, 3], ``conv_s2d_dw_float32``
   and ``conv_s2d_dx_float32`` at [32, 472, 472, 3]: launches over the
   float32 checks of phases 4 and 8 and the float32 dx path, the FFMA
   bound, and cuDNN with TF32 off, logged with TF32 on too); the bfloat16
   forward at the training shape is logged;
   each pool's ``pool_bwd`` with its route;
   flash_fwd, flash_dq and flash_dkv at each SNAIL shape and at bench.py's
   and the streamed bf16 shapes with their routes, listed under
   ``per_shape`` in their records;
13a. after the timings (``phase_dispatch_profile``, torch.profiler): over
   two replays of a K=8 trainer, 24 ``pool_fwd_kernel``, 24
   ``pool_bwd_scatter_kernel``, 8 ``conv_fwd_mma_kernel``, 8
   ``conv_dw_mma_kernel`` and 8 ``conv_dw_reduce_kernel`` rows a dispatch,
   8 ``fused_update_kernel`` rows on the fused arm (0 on the stock one),
   one ``cudaGraphLaunch`` a dispatch and no Python launch count (a pair
   of replays whose rows the profiler delivered short is profiled again,
   up to three pairs; a row above the count fails at once); the device
   ms a step of K=1 eager, K=8 graph, K=8 with the device feed and the
   fused K=8 arm;
13b. SNAIL and Grasp2Vec at ``steps_per_dispatch=8``
   (``phase_dispatch_models``, after the profile phases, deterministic
   cuDNN, no plain-version call): SNAIL long-horizon (episode 512, 8 heads
   of 8, batch 2) and sequential (episode 40, batch 8) on seeded 220x300
   episodes, and Grasp2Vec (ResNet-50 v2 towers, batch 16, 472x472) fed
   from 4 freshly written record shards, each with the stock Adam and the
   fused update: 2 dispatches of 8 (the first warms up, captures and
   replays; every counter zeroed just before and read just after: 16
   steps' launches) bit for bit 16 K=1 steps on the same batches
   (parameters, batch statistics, Adam moments, groups, generator, step);
   on the stock arms K=1 and K=8 in turns on the host clock (K=1, K=8,
   K=8, K=1; 16 steps each on SNAIL, 8 on Grasp2Vec), the superbatch's
   host assembly and upload ms against one batch's pageable upload, the
   peak device memory of both; then two replays profiled: 16
   ``flash_fwd_kernel``, ``flash_dq_kernel`` and ``flash_dkv_kernel``
   rows a replay (SNAIL) or 16 ``pool_fwd_kernel`` and
   ``pool_bwd_gather_kernel`` (Grasp2Vec), 8 ``fused_update_kernel`` on
   the fused arms, one ``cudaGraphLaunch`` a replay and no Python launch,
   with the device ms a step of K=8 and of 4 K=1 steps;
   ``--profile`` adds ``torch.profiler`` breakdowns of two actions, a
   stock and a fused QT-Opt training step and one stock and one fused step
   of each SNAIL path, written to
   ``chiprun_out/chip_smoke_profile*.txt``, each with the profiler's
   'Activity Buffer Request' row printed beside the device time that
   leaves it out.

The last three lines of the output are the JSON ``kernels`` record, the
card's name and power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them) and ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before them, and nothing falls back to the CPU.
"""

import argparse
import atexit
import collections
import concurrent.futures
import contextlib
import copy
import functools
import http.client
import inspect
import itertools
import json
import os
import pathlib
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.data import (example_codec, image_codec,
                                         input_generators, native_io, records,
                                         shard_index)
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.observability import metrics as metrics_lib
from tensor2robot_tpu_torch.ops import (_build, _dispatch, conv_s2d,
                                        fused_update, photometric, pool)
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.quantize import quantization as quant_lib
from tensor2robot_tpu_torch.policies import CEMPolicy
from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.research.vrgripper import (
    VRGripperEnvLongHorizonModel, VRGripperEnvSequentialModel)
from tensor2robot_tpu_torch.serving import (DynamicBatcher, default_buckets,
                                            loadgen, wire)
from tensor2robot_tpu_torch.train import (Trainer, TrainerCallback,
                                          TrainerConfig, train_eval_model)
from tensor2robot_tpu_torch.train import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.train import train_state
from tensor2robot_tpu_torch.train import trainer as trainer_lib
from tensor2robot_tpu_torch.train.trainer import BatchUploader
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
POOLS = (  # name, input NHWC, window, strides (all SAME padding)
    ('pool1', (64, 236, 236, 64), (3, 3), (3, 3)),
    ('pool2', (64, 79, 79, 64), (3, 3), (3, 3)),
    ('pool3', (64, 27, 27, 64), (2, 2), (2, 2)),
)
TRAIN_BATCH = 32
TRAIN_POOLS = tuple((name, (TRAIN_BATCH,) + shape[1:], window, strides)
                    for name, shape, window, strides in POOLS)
CONV1_X = (64, 472, 472, 3)
CONV1_W = (6, 6, 3, 64)
TRAIN_CONV1_X = (TRAIN_BATCH,) + CONV1_X[1:]
CONV1_PADS = ((2, 2), (2, 2))  # SAME, 6x6/s2 on 472
# Kernel launches per training step on the main path.
NO_FLASH = {'flash_fwd': 0, 'flash_dq': 0, 'flash_dkv': 0}
NO_QTOPT = {'pool_fwd': 0, 'pool_bwd': 0, 'pool_bwd_scatter': 0,
            'conv_s2d_fwd': 0, 'conv_s2d_fwd_tensor_core': 0,
            'conv_s2d_dw': 0, 'conv_s2d_dw_tensor_core': 0,
            'conv_s2d_dx': 0, 'conv_s2d_dx_tensor_core': 0}
# The fused optimizer update and the photometric pass run only on their own
# paths (fused_update=True, use_fused_kernel=True).
NO_FUSED = {'fused_update': 0, 'photometric': 0}
# conv1 is bfloat16 there, so its forward and dW run the tensor-core
# kernels; the three pools do not overlap, so their backward runs the
# scatter route.
TRAIN_LAUNCHES = {'pool_fwd': 3, 'pool_bwd': 3, 'pool_bwd_scatter': 3,
                  'conv_s2d_fwd': 1, 'conv_s2d_fwd_tensor_core': 1,
                  'conv_s2d_dw': 1, 'conv_s2d_dw_tensor_core': 1,
                  'conv_s2d_dx': 0, 'conv_s2d_dx_tensor_core': 0,
                  **NO_FLASH, **NO_FUSED}
# Kernel launches per SNAIL training step: two attention blocks, each one
# forward and one backward.
SNAIL_LAUNCHES = {**NO_QTOPT, 'flash_fwd': 2, 'flash_dq': 2, 'flash_dkv': 2,
                  **NO_FUSED}
# The SNAIL configurations at full width: the repo's gin files
# (research/vrgripper/configs/run_train_{long_horizon,sequential}.gin).
SNAIL_CONFIGS = (
    ('long_horizon', VRGripperEnvLongHorizonModel,
     dict(episode_length=512, num_attention_heads=8, attention_head_size=8,
          num_mixture_components=1, sequence_parallelism='auto'), 2),
    ('sequential', VRGripperEnvSequentialModel,
     dict(num_mixture_components=1, condition_gripper_pose=False), 8),
)
# Flash kernel checks: name, [B, T, H, D], dtype. The first two are the
# SNAIL attention shapes, then bench.py's staged shape, two shapes that
# _use_streamed classifies as streamed (2·T·D·itemsize > 8 MB), and the
# edges of the forward's tensor-core route in bfloat16: a ragged last q and
# K/V tile (T = 1000), the narrowest and widest head dims it takes (16, 128)
# and D = 8, which takes the CUDA-core route.
FLASH_SHAPES = (
    ('long_horizon', (2, 1024, 8, 8), torch.float32),
    ('sequential', (8, 80, 1, 64), torch.float32),
    ('bench', (2, 4096, 8, 64), torch.float32),
    ('bench', (2, 4096, 8, 64), torch.bfloat16),
    ('streamed', (1, 33792, 1, 64), torch.bfloat16),
    ('streamed', (1, 17408, 1, 64), torch.float32),
    ('ragged', (2, 1000, 4, 64), torch.bfloat16),
    ('d16', (2, 1024, 4, 16), torch.bfloat16),
    ('d128', (1, 2048, 2, 128), torch.bfloat16),
    ('d8', (2, 1024, 8, 8), torch.bfloat16),
)
# The flash forward's out must also lie within this relative L2 error
# ||got - want|| / ||want|| of the plain version. flash_band's bar scales
# with the largest |out|, which under the causal mask is a row that sees
# one key (4-5 with randn inputs), while a row deep in T averages hundreds
# of keys to |out| ~0.01-0.05: a fault that moves those rows by their own
# size can pass the bar. An H100 read at FLASH_SHAPES (PERF.md): bfloat16
# kernels 2.0e-3 to 2.5e-3 (the tensor-core route's bf16 P and the two
# bf16 roundings of out) and the plain output rounded through
# float8_e4m3fn 2.7e-2 and more, so the limit lies about 3x from each;
# float32 kernels up to 2.5e-6 and the output rounded through bfloat16
# 1.6e-3. Both controls must fail the limit at every shape.
FLASH_OUT_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# dq, dk and dv likewise. The tensor-core routes round dS (and for dk/dv
# P^T) to bfloat16 where the JAX kernels keep float32: on the CPU the
# emulated route lands 2.5e-3 to 2.8e-3 from the JAX kernels
# (tests/test_torch_flash_bwd_plan.py). An H100 read at FLASH_SHAPES
# (PERF.md): bfloat16 kernels up to 2.8e-3 and the float8_e4m3fn control
# from 2.6e-2, so 8e-3 lies about 3x from each; float32 kernels up to
# 3.1e-6 and the bfloat16 control from 1.6e-3.
FLASH_GRAD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
FLASH_CONTROL_DTYPE = {torch.float32: torch.bfloat16,
                       torch.bfloat16: torch.float8_e4m3fn}
# Flash timings, causal: name, [B, T, H, D], dtype, and whether the shape is
# on a main path (the SNAIL paths; the kernels line sums those).
FLASH_TIMED = (
    ('long_horizon', (2, 1024, 8, 8), torch.float32, True),
    ('sequential', (8, 80, 1, 64), torch.float32, True),
    ('bench', (2, 4096, 8, 64), torch.bfloat16, False),
    ('streamed', (1, 33792, 1, 64), torch.bfloat16, False),
)
# Leaves whose gradient is 0 but for rounding: the attention key biases
# (softmax is invariant to a constant added to a query's logits) and the
# tower's final LayerNorm bias (the spatial softmax is invariant to a
# constant added to a channel). A relative band means nothing there.
INVARIANT_LEAVES = ('key.bias', 'final_norm.bias')
OUT_DIR = pathlib.Path(__file__).resolve().parent / 'chiprun_out'
# The float32 training step, card against CPU and float64 (see
# phase_train_reference): a leaf of the card's gradient may lie at most
# this many times as far from float64 (relative L2) as the CPU's float32
# gradient's worst leaf does, and its largest element error against the
# CPU may reach this share of the leaf's largest magnitude (a relu kink or
# a pool near-tie that flips between two float32 computations moves a
# whole element of the gradient). The ratio is 6: cuBLAS, cuDNN and the
# conv1 dW kernel reduce the train-mode network's long, cancelling sums
# (BatchNorm's backward centres the cotangent per channel) in other orders
# than the CPU's blocked reductions, and the card's worst leaf lands 4.4x
# as far from float64 as the CPU's worst (7.6e-3 against 1.7e-3, on an
# H100 at batch 2); the rest is room for another card's algorithm choice.
REFERENCE_L2_RATIO = 6.0
REFERENCE_MAX_BAND = 0.1
# The SNAIL float32 step (see phase_snail_reference): the card's gradient
# may lie this far (relative L2, per leaf) from float64. cuDNN's and
# cuBLAS's float32 weight gradients for the vision tower sum ~3e5 products
# whose total cancels to a small share of their magnitudes, in another
# order than the CPU's blocked reductions.
REFERENCE_L2_FLOOR = 5e-2
# The same step on the card through the flash kernels and through the
# dense attention: what the kernels change, leaf by leaf (relative L2).
SNAIL_FLASH_VS_DENSE = 1e-3
# The fused update's variants (kind, EMA, guard) and its band against its
# plain version, atol and rtol: the JAX package's fused-vs-optax band.
UPDATE_VARIANTS = tuple((kind, ema, guard) for kind in ('adam', 'sgd')
                        for ema in (False, True) for guard in (False, True))
FUSED_BAND = (1e-6, 1e-5)
# The photometric pass at QT-Opt's training images, and its float32 band.
# The bfloat16 bars are photometric_bf16_check's.
PHOTOMETRIC_SHAPE = (TRAIN_BATCH, 472, 472, 3)
PHOTOMETRIC_F32_BAND = 1e-6
# The checkpoint phase: saves and eval passes every CKPT_INTERVAL steps,
# CKPT_EVAL_BATCHES batches a pass, CKPT_ACTIONS actions served from the
# restored step; the trainer binary runs the port's QT-Opt config.
CKPT_INTERVAL = 3
CKPT_EVAL_BATCHES = 2
CKPT_ACTIONS = 3
QTOPT_GIN = 'tensor2robot_tpu_torch/research/qtopt/configs/train_qtopt.gin'


def log(*parts):
  print(*parts, flush=True)


def counters():
  """Every kernel wrapper's launch counts, by kernel name: (wrapper,
  attribute). The tensor-core routes of conv_s2d_fwd, conv_s2d_dw and
  conv_s2d_dx and the scatter route of pool_bwd have counts of their
  own."""
  wrappers = {'pool_fwd': pool.pool_fwd, 'pool_bwd': pool.pool_bwd,
              'conv_s2d_fwd': conv_s2d.conv_s2d_fwd,
              'conv_s2d_dw': conv_s2d.conv_s2d_dw,
              'conv_s2d_dx': conv_s2d.conv_s2d_dx,
              'flash_fwd': fa.flash_fwd, 'flash_dq': fa.flash_dq,
              'flash_dkv': fa.flash_dkv,
              'fused_update': fused_update.fused_update,
              'photometric': photometric.photometric}
  found = {name: (fn, 'launches') for name, fn in wrappers.items()}
  found['conv_s2d_fwd_tensor_core'] = (conv_s2d.conv_s2d_fwd,
                                       'tensor_core_launches')
  found['conv_s2d_dw_tensor_core'] = (conv_s2d.conv_s2d_dw,
                                      'tensor_core_launches')
  found['conv_s2d_dx_tensor_core'] = (conv_s2d.conv_s2d_dx,
                                      'tensor_core_launches')
  found['pool_bwd_scatter'] = (pool.pool_bwd, 'scatter_launches')
  return found


def zero_counters():
  for fn, attr in counters().values():
    setattr(fn, attr, 0)


def read_counters():
  return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def tf32_flags():
  return (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def tf32_off():
  """TF32 off for cuBLAS and cuDNN within the context (a check holds
  float32 to float32), both flags restored after it. As a decorator, for
  the whole of a check phase."""
  saved = tf32_flags()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def within(got, want, rel, of_max):
  """Max abs error, and whether every element lies within ``rel`` of its
  own magnitude plus ``of_max`` of the largest magnitude."""
  got, want = got.float(), want.float()
  err = (got - want).abs()
  limit = rel * want.abs() + of_max * float(want.abs().max())
  return float(err.max()), bool((err <= limit).all())


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms():
  """Cycles of ``torch.cuda._sleep`` that take one millisecond on this
  card, measured once."""
  torch.cuda._sleep(10**6)  # pylint: disable=protected-access
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  torch.cuda._sleep(10**7)  # pylint: disable=protected-access
  end.record()
  torch.cuda.synchronize()
  return 10**7 / start.elapsed_time(end)


def cuda_ms(fn, iters=20, warmup=3):
  """Mean device time of one call of ``fn``: each call is timed alone with
  CUDA events, after a 256 MB write has flushed the 50 MB L2 cache, so its
  inputs come from device memory as the bytes bound assumes. A spin kernel
  after the flush keeps the card busy while the host enqueues ``fn`` (for
  twice the longest host time of a warm-up call, 0.2 to 20 ms), so the
  start event fires with ``fn``'s launches already queued and the time is
  the device's, not the host's launch latency."""
  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda')
  host = []
  for _ in range(warmup):
    begin = time.perf_counter()
    fn()
    host.append(time.perf_counter() - begin)
  torch.cuda.synchronize()
  host_ms = 1e3 * max(host[1:] or host)
  spin = int(spin_cycles_per_ms() * min(20.0, max(0.2, 2 * host_ms)))
  events = []
  for _ in range(iters):
    flush.zero_()
    torch.cuda._sleep(spin)  # pylint: disable=protected-access
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    events.append((start, end))
  torch.cuda.synchronize()
  return sum(start.elapsed_time(end) for start, end in events) / iters


def tied_normal(shape, dtype, generator, device):
  """Seeded normal data with ties (channel 0 rounded to halves)."""
  x = torch.randn(shape, generator=generator, device=device)
  x[..., 0] = torch.round(x[..., 0] * 2) / 2
  return x.to(dtype).contiguous()


def phase_card():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  card = smi.splitlines()[0].strip()
  log(card)
  matmul, cudnn = tf32_flags()
  log(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'python {sys.version.split()[0]}; TF32: '
      f'torch.backends.cuda.matmul.allow_tf32={matmul}, '
      f'torch.backends.cudnn.allow_tf32={cudnn} (the paths and timings run '
      'so; each check phase turns both off and restores them)')
  return card


def stack_frames(report, kernel):
  """{mangled name: ptxas's stack-frame line} of every instantiation of
  ``kernel`` in a ``ptxas -v`` report ('Function properties for <name>',
  then the line with its stack frame and spills), with '; N registers'
  added where the report's next 'Used N registers' line follows."""
  frames, name = {}, None
  for line in report.splitlines():
    if 'Function properties for' in line:
      name = line.split('Function properties for')[-1].strip()
      name = name if kernel in name else None
    elif name is not None and 'stack frame' in line:
      frames[name] = line.strip()
    elif name is not None and 'registers' in line:
      frames[name] += '; ' + line.split('Used')[-1].split(',')[0].strip()
      name = None
  return frames


FLASH_KERNELS = ('flash_fwd_mma_kernel', 'flash_fwd_kernel',
                 'flash_dq_mma_kernel', 'flash_dq_kernel',
                 'flash_dkv_mma_kernel', 'flash_dkv_kernel')
# The pool backward's scatter and gather routes, conv1's tensor-core dx and
# its float32 forward, dW and CUDA-core dx (each instantiation), by source.
BWD_KERNELS = (('pool', 'pool_bwd_scatter_kernel'),
               ('pool', 'pool_bwd_gather_kernel'),
               ('conv_s2d', 'conv_dx_mma_kernel'),
               ('conv_s2d', 'conv_fwd_ffma_kernel'),
               ('conv_s2d', 'conv_dw_ffma_kernel'),
               ('conv_s2d', 'conv_dx_ffma_kernel'))


def phase_build():
  """Builds every kernel; the fused update's table parameter must leave
  every instantiation of its kernel a 0-byte stack frame (a table copied
  into local memory would show there). ptxas's registers, stack frame and
  spills of every flash kernel's instantiations are printed."""
  start = time.perf_counter()
  reports = _build.build()
  seconds = time.perf_counter() - start
  log(f'build: {seconds:.1f} s for {list(reports) or "cached libraries"}')
  for name, report in reports.items():
    if name.startswith('flash_attention'):
      continue
    for line in report.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  ptxas {name}: {line.strip()}')
  for source, kernel in BWD_KERNELS:
    frames = stack_frames(_build.report(source), kernel)
    for mangled, line in sorted(frames.items()):
      rest = mangled.split(kernel, 1)[1]
      args = rest.split('EEv')[0] + 'E' if rest.startswith('I') else ''
      log(f'ptxas {kernel}{args}: {line}')
    if not frames:
      raise AssertionError(f'no {kernel} in the ptxas report of {source}')
  flash = (_build.report('flash_attention') +
           _build.report('flash_attention_bwd'))
  for kernel in FLASH_KERNELS:
    frames = {name.split(kernel, 1)[1].split('EEv')[0] + 'E': line
              for name, line in stack_frames(flash, kernel).items()}
    for args, line in sorted(frames.items()):
      log(f'ptxas {kernel}{args}: {line}')
    spilled = [args for args, line in frames.items()
               if '0 bytes spill stores, 0 bytes spill loads' not in line]
    log(f'ptxas: {len(frames)} {kernel} instantiations, '
        f'{len(spilled)} with spills {spilled}')
  frames = stack_frames(_build.report('fused_update'), 'fused_update_kernel')
  for kernel, line in sorted(frames.items()):
    log(f'ptxas fused_update_kernel {kernel}: {line}')
  if len(frames) != 8 or not all(
      line.startswith('0 bytes stack frame') for line in frames.values()):
    raise AssertionError(f'fused_update_kernel stack frames: {frames}')
  log('ptxas: all 8 fused_update_kernel instantiations have a 0-byte stack '
      'frame')
  return seconds


def same_bits(a, b):
  """Bitwise equality (NaN payloads included) of two tensors."""
  int_type = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
  return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
      a.view(int_type.get(a.dtype, a.dtype)),
      b.view(int_type.get(b.dtype, b.dtype)))


def phase_check_pool(generator):
  """pool_fwd against plain_max_pool_argmax, values (bit for bit) and
  slots: the three QT-Opt pools at B=64 and B=32 in bf16, pool1 in
  float32, a C=3 and a storage-offset (unaligned) case, which take the
  one-channel instantiation, a C=16 odd window (3x2/s(1,2)), which takes
  the 8-channel one with the window at run time, an overlapping 3x3/s2
  window, a planted tie, and NaN, -0.0 and +0.0 planted at slot 0. Each
  case logs its launch choice (ops/pool.fwd_launch, which the C entry
  refuses to differ from)."""
  cases = [(f'{name}_b{shape[0]}', shape, window, strides, torch.bfloat16, 0)
           for pools in (POOLS, TRAIN_POOLS)
           for name, shape, window, strides in pools]
  cases += [('pool1_f32', POOLS[0][1], (3, 3), (3, 3), torch.float32, 0),
            ('c3_f32', (2, 11, 13, 3), (3, 2), (1, 2), torch.float32, 0),
            ('odd_f32', (2, 11, 13, 16), (3, 2), (1, 2), torch.float32, 0),
            ('c3_bf16', (4, 79, 79, 3), (3, 3), (3, 3), torch.bfloat16, 0),
            ('unaligned_bf16', (8, 79, 79, 64), (3, 3), (3, 3),
             torch.bfloat16, 1),
            ('overlap_f32', (4, 23, 23, 64), (3, 3), (2, 2), torch.float32,
             0),
            ('overlap_bf16', (8, 79, 79, 64), (3, 3), (2, 2), torch.bfloat16,
             0)]
  max_err, routes = 0.0, set()
  for name, shape, window, strides, dtype, offset in cases:
    x = tied_normal(shape, dtype, generator, 'cuda')
    if offset:
      buffer = torch.empty(x.numel() + offset, dtype=dtype, device='cuda')
      buffer[offset:].copy_(x.flatten())
      x = buffer[offset:].view(shape)
    pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
    got = pool.pool_fwd(x, window, strides, pads)
    want = pool.plain_max_pool_argmax(x, window, strides, pads)
    torch.cuda.synchronize()
    if not (same_bits(got[0], want[0]) and torch.equal(got[1], want[1])):
      raise AssertionError(f'pool_fwd {name} differs from its plain version')
    launch = pool.fwd_launch(shape, window, strides, pads,
                             aligned=x.data_ptr() % 16 == 0)
    routes.add((launch['vec'], launch['templated']))
    max_err = max(max_err, float((got[0].float() - want[0].float()).abs()
                                 .max()))
    log(f'check pool_fwd {name} {shape} {str(dtype)[6:]} window {window} '
        f'strides {strides}: bitwise (launch: {launch["vec"]} channel(s) a '
        f'thread, {64 if launch["wide"] else 32}-bit offsets, '
        f'{"templated" if launch["templated"] else "runtime"} window)')
    del x, got, want
  vec = pool.fwd_launch((1, 4, 4, 8), (2, 2), (2, 2), ((0, 0), (0, 0)))['vec']
  if not {(1, True), (vec, True), (vec, False)} <= routes:
    raise AssertionError(f'pool_fwd checks took only {routes}')
  tie = torch.zeros((1, 4, 4, 8), device='cuda')
  tie[0, 2, 2] = tie[0, 3, 3] = 9.0
  out, slot = pool.pool_fwd(tie, (2, 2), (2, 2), ((0, 0), (0, 0)))
  torch.cuda.synchronize()
  if int(slot[0, 1, 1].max()) != 0 or int(slot[0, 0, 0].max()) != 0:
    raise AssertionError('pool_fwd tie did not keep the first slot')
  if float(out[0, 1, 1].min()) != 9.0:
    raise AssertionError('pool_fwd tie value')
  log('check pool_fwd planted tie: first slot wins')
  for dtype in (torch.bfloat16, torch.float32):
    x = torch.ones((2, 6, 6, 16), dtype=dtype, device='cuda') * -1.0
    x[0, 0, 0, :8] = float('nan')      # NaN at slot 0 sticks
    x[0, 0, 1, :8] = 5.0
    x[0, 0, 2, 8:] = -0.0              # -0.0 at slot 0 against +0.0
    x[0, 1, 3, 8:] = 0.0
    x[1, 0, 0] = 0.0                   # +0.0 at slot 0 against -0.0
    x[1, 1, 1] = -0.0
    got = pool.pool_fwd(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
    want = pool.plain_max_pool_argmax(x, (2, 2), (2, 2), ((0, 0), (0, 0)))
    torch.cuda.synchronize()
    if not (same_bits(got[0], want[0]) and torch.equal(got[1], want[1])):
      raise AssertionError(f'pool_fwd NaN/signed-zero case {dtype} differs')
    if not (bool(got[0][0, 0, 0, :8].isnan().all()) and
            int(got[1][0, 0, 0, :8].max()) == 0 and
            bool(torch.signbit(got[0][0, 0, 1, 8:]).all()) and
            not bool(torch.signbit(got[0][1, 0, 0]).any())):
      raise AssertionError(f'pool_fwd NaN/signed-zero semantics {dtype}')
  log('check pool_fwd NaN, -0.0 and +0.0 at slot 0: the first slot keeps '
      'them, bit for bit with the plain version')
  return max_err


@tf32_off()
def phase_check_conv(generator):
  """conv1's forward against its plain version, twice bit for bit, each
  plan logged and its route counted: bfloat16 on the tensor cores at the
  serving and the training shape (their plans differ) and at the odd
  geometry (ODD_CONV_*); float32 on the CUDA cores (conv_fwd_ffma_kernel)
  at the serving and the training shape (conv1's templated instantiation,
  16-byte copies), at the odd geometry (the generic instantiation; x's
  rows are not whole 16-byte units, so 4-byte copies) and at conv1's
  geometry with x one element off 16-byte alignment (4-byte copies),
  within 1e-5 of the plain version with TF32 off. Returns the largest
  error of the bfloat16 and of the float32 conv1 shapes."""
  errors = {}
  for label, shape, wshape, strides, dtype, offset in (
      ('conv1', CONV1_X, CONV1_W, (2, 2), torch.bfloat16, 0),
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.bfloat16, 0),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.bfloat16, 0),
      ('conv1', CONV1_X, CONV1_W, (2, 2), torch.float32, 0),
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.float32, 0),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.float32, 0),
      ('conv1_unaligned', (8,) + CONV1_X[1:], CONV1_W, (2, 2),
       torch.float32, 1)):
    band = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, shape[1:3])
    x = torch.rand(shape, generator=generator, device='cuda').to(dtype)
    if offset:
      buffer = torch.empty(x.numel() + offset, dtype=dtype, device='cuda')
      buffer[offset:].copy_(x.flatten())
      x = buffer[offset:].view(shape)
    w = (0.1 * torch.randn(wshape, generator=generator, device='cuda')).to(
        dtype)
    plan = conv_s2d.fwd_plan(shape, wshape, strides, pads, dtype)
    tensor_core = conv_s2d.conv_s2d_fwd.tensor_core_launches
    got = conv_s2d.conv_s2d_fwd(x, w, strides, pads)
    again = conv_s2d.conv_s2d_fwd(x, w, strides, pads)
    tensor_core = conv_s2d.conv_s2d_fwd.tensor_core_launches - tensor_core
    want = conv_s2d.plain_conv2d(x, w, strides, pads).float()
    torch.cuda.synchronize()
    what = f'conv_s2d_fwd {label} {shape} {str(dtype)[6:]}'
    if tensor_core != (2 if plan['route'] == conv_s2d.ROUTE_TENSOR_CORE
                       else 0):
      raise AssertionError(f'{what}: route {plan["route"]} but '
                           f'{tensor_core} tensor-core launches')
    if not torch.equal(got, again):
      raise AssertionError(f'{what} is not deterministic')
    err = (got.float() - want).abs()
    limit = band * want.abs() + (1e-6 if dtype == torch.bfloat16 else band)
    if not bool((err <= limit).all()):
      raise AssertionError(
          f'{what} outside its band: max err {float(err.max())}')
    errors[label, shape, dtype] = float(err.max())
    same = ''
    (plh, phh), (plw, phw) = pads
    if dtype == torch.float32 and (plh, plw) == (phh, phw):
      # cuDNN's float32 forward (TF32 off here) as the timings call it, on
      # the channels-last views, logged beside the check.
      library = F.conv2d(
          x.permute(0, 3, 1, 2),
          w.permute(3, 2, 0, 1).contiguous(
              memory_format=torch.channels_last),
          stride=strides, padding=(plh, plw)).permute(0, 2, 3, 1)
      same = (f'; bit for bit F.conv2d (TF32 off): '
              f'{torch.equal(got, library)}')
      del library
    log(f'check {what}: plan {plan}, max abs err {float(err.max()):.3e} '
        f'(band {band:.1e} relative), at most '
        f'{float((err / limit).max()):.3f} of the band; twice: bitwise '
        f'equal{same}')
    del x, w, got, again, want, err, limit
  return tuple(max(err for (label, _, dtype), err in errors.items()
                   if label == 'conv1' and dtype == want_dtype)
               for want_dtype in (torch.bfloat16, torch.float32))


def phase_main_path(seed, actions):
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  predictor = CheckpointPredictor(model, device='cuda')
  predictor.init_randomly(torch.Generator().manual_seed(seed))
  policy = CEMPolicy(t2r_model=model, predictor=predictor, action_size=5,
                     cem_samples=64, cem_iters=3, num_elites=6,
                     device_resident=True)
  frames = np.random.RandomState(seed).randint(
      0, 256, (actions + 1, 512, 640, 3), dtype=np.uint8)
  np.random.seed(seed)
  with _dispatch.force_kernels(True):
    policy.SelectAction(frames[0], None, 0)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    start = time.perf_counter()
    chosen = [policy.SelectAction(frames[t], None, t)
              for t in range(1, actions + 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counters()
  for action in chosen:
    if action.shape != (5,) or not np.isfinite(action).all():
      raise AssertionError(f'bad action {action!r}')
  want = {**NO_QTOPT, 'pool_fwd': 9 * actions,
          'conv_s2d_fwd': 3 * actions,
          'conv_s2d_fwd_tensor_core': 3 * actions, **NO_FLASH, **NO_FUSED}
  if launches != want:
    raise AssertionError(f'launches over {actions} actions: {launches}')
  ms_per_action = 1e3 * seconds / actions
  log(f'main path: {actions} actions, {ms_per_action:.2f} ms/action '
      f'(host clock, synchronised), launches {launches}, last action '
      f'{np.array2string(chosen[-1], precision=4)}')

  rng = np.random.RandomState(seed + 1)
  images = rng.randint(0, 256, (8, 512, 640, 3), dtype=np.uint8)
  pairs = rng.randn(8, 5).astype(np.float32)
  with _dispatch.force_kernels(True):
    q = predictor.predict({'state/image': images,
                           'action/world_vector': pairs[:, :3],
                           'action/vertical_rotation': pairs[:, 3:]})
  q = q['q_predicted']
  if q.shape != (8,) or not np.isfinite(q).all() or not (
      (q >= 0) & (q <= 1)).all():
    raise AssertionError(f'bad predict output {q!r}')
  log(f'predict: 8 pairs, q_predicted {np.array2string(q, precision=4)}')
  return ms_per_action, launches, policy, frames


def spread_weights(network, generator):
  """Kernels of std 1/sqrt(fan_in), so a float32 check sees real signal
  (a fresh critic scores everything near 0.5)."""
  state = {}
  for name, value in network.state_dict().items():
    if name.endswith(('kernel', 'weight')):
      fan_in = (value[..., 0].numel() if name.endswith('kernel') else
                value[0].numel())
      value = torch.randn(value.shape, generator=generator) / fan_in**0.5
    elif name.endswith(('bias', 'mean')):
      value = 0.1 * torch.randn(value.shape, generator=generator)
    elif name.endswith('var'):
      value = 0.5 + torch.rand(value.shape, generator=generator)
    state[name] = value
  return state


def cuda_core_launches(counts):
  """conv1's CUDA-core launches (conv_fwd_ffma_kernel, the float32 dW's
  first pass, conv_dx_ffma_kernel) in a read of the counters."""
  return {name: counts[name] - counts[name + '_tensor_core']
          for name in ('conv_s2d_fwd', 'conv_s2d_dw', 'conv_s2d_dx')}


@tf32_off()
def phase_reference(seed):
  """The whole float32 network on the card (kernels) against the CPU
  (plain versions) on 2 full-width pairs, TF32 off. The card's predict
  and its end points run conv1's float32 forward on the CUDA cores once
  each, and nothing else of conv1: returns those launches."""
  model = GraspingModelWrapper(device_type='cpu', kernel_policy='pool_conv')
  on_card = CheckpointPredictor(model, device='cuda')
  on_cpu = CheckpointPredictor(model, device='cpu')
  on_card.init_randomly()
  on_cpu.init_randomly()
  state = spread_weights(on_cpu.network, torch.Generator().manual_seed(seed))
  on_card.network.load_state_dict(state)
  on_cpu.network.load_state_dict(state)
  rng = np.random.RandomState(seed + 2)
  features = {
      'state/image': rng.randint(0, 256, (2, 512, 640, 3), dtype=np.uint8),
      'action/world_vector': rng.randn(2, 3).astype(np.float32),
      'action/vertical_rotation': rng.randn(2, 2).astype(np.float32),
  }
  zero_counters()
  with _dispatch.force_kernels(True):
    got = on_card.predict(features)['q_predicted']
  with _dispatch.force_kernels(False):
    want = on_cpu.predict(features)['q_predicted']
  err = float(np.abs(got - want).max())
  if not np.isfinite(got).all() or err > 1e-4:
    raise AssertionError(f'card {got} vs cpu {want}: err {err}')
  log(f'reference: float32 network card vs cpu on 2 pairs, q {got} vs '
      f'{want}, max abs err {err:.2e} (band 1e-4)')
  # q of a random critic moves little with the image, so the image tower's
  # end points are held too, each within 1e-4 of its largest magnitude.
  def end_points(predictor, kernels):
    device_features = {k: torch.from_numpy(v).to(predictor.device)
                       for k, v in features.items()}
    with torch.inference_mode(), _dispatch.force_kernels(kernels):
      inputs, _ = model.preprocessor.preprocess(device_features, None,
                                                ModeKeys.PREDICT)
      return predictor.network(inputs['state/image'],
                               model.grasp_params(inputs))[1]

  card_points = end_points(on_card, True)
  torch.cuda.synchronize()
  launches = cuda_core_launches(read_counters())
  if launches != {'conv_s2d_fwd': 2, 'conv_s2d_dw': 0, 'conv_s2d_dx': 0}:
    raise AssertionError(f'reference: conv1 CUDA-core launches {launches}, '
                         'expected 2 forwards')
  log(f'reference: conv1 CUDA-core launches {launches} (a predict and its '
      'end points)')
  cpu_points = end_points(on_cpu, False)
  for name in ('pool2', 'final_conv', 'logits'):
    want = cpu_points[name]
    err = float((card_points[name].cpu() - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * scale:
      raise AssertionError(f'end point {name}: err {err} at scale {scale}')
    log(f'reference: end point {name} {tuple(want.shape)}: max abs err '
        f'{err:.2e} at max magnitude {scale:.3e} (band 1e-4 relative)')
  return launches


def phase_check_pool_bwd(generator):
  """pool_bwd against plain_max_pool_bwd, bit for bit (NaN payloads and
  signed zeros included): the three pools in bfloat16 at the training
  (B=32) and serving (B=64) shapes and pool1 in float32, a VALID case
  whose tail rows and columns no window covers, C=3 and a storage-offset
  (unaligned) case (one channel a thread), a runtime window (3x2 with
  stride 3x2), all on the scatter route; on the gather route the
  Grasp2Vec stem's exact geometry at full width (3x3/s2, pads (1, 1), both
  towers' batches, bf16; the templated instantiation), an odd window
  (runtime), two more overlapping cases, a tile ragged in rows and columns
  and C=3 (one channel a thread); NaN, -0.0 and infinite cotangents; a
  planted tie whose cotangent must go to the first slot. Each case logs
  its launch choice (ops/pool.bwd_launch, which the C entry refuses to
  differ from) and the scatter count must move exactly on the scatter
  cases."""
  cases = [(f'{name}_b{shape[0]}', shape, window, strides, 'SAME',
            torch.bfloat16, 0)
           for pools in (TRAIN_POOLS, POOLS)
           for name, shape, window, strides in pools]
  cases += [('pool1_f32', TRAIN_POOLS[0][1], (3, 3), (3, 3), 'SAME',
             torch.float32, 0),
            ('valid_tails_bf16', (4, 80, 82, 64), (3, 3), (3, 3), 'VALID',
             torch.bfloat16, 0),
            ('c3_bf16', (4, 79, 79, 3), (3, 3), (3, 3), 'SAME',
             torch.bfloat16, 0),
            ('unaligned_bf16', (8, 79, 79, 64), (3, 3), (3, 3), 'SAME',
             torch.bfloat16, 1),
            ('runtime_window_f32', (2, 29, 31, 16), (3, 2), (3, 2), 'SAME',
             torch.float32, 0),
            ('odd_f32', (2, 11, 13, 16), (3, 2), (1, 2), 'SAME',
             torch.float32, 0),
            ('overlap_f32', (4, 23, 23, 64), (3, 3), (2, 2), 'SAME',
             torch.float32, 0),
            ('overlap_bf16', (8, 79, 79, 64), (3, 3), (2, 2), 'SAME',
             torch.bfloat16, 0),
            ('stem_b16_bf16', (GRASP2VEC_BATCH, 236, 236, 64), STEM_WINDOW,
             STEM_STRIDES, STEM_PADS, torch.bfloat16, 0),
            ('stem_b32_bf16', (2 * GRASP2VEC_BATCH, 236, 236, 64),
             STEM_WINDOW, STEM_STRIDES, STEM_PADS, torch.bfloat16, 0),
            ('gather_ragged_f32', (3, 27, 37, 64), (3, 3), (2, 2), 'SAME',
             torch.float32, 0),
            ('gather_c3_bf16', (2, 13, 11, 3), (3, 3), (2, 2), 'SAME',
             torch.bfloat16, 0)]
  routes = set()
  for name, shape, window, strides, padding, dtype, offset in cases:
    x = tied_normal(shape, dtype, generator, 'cuda')
    pads = pool.resolve_padding(padding, window, strides, shape[1:3])
    _, slot = pool.pool_fwd(x, window, strides, pads)
    g = tied_normal(tuple(slot.shape), dtype, generator, 'cuda')
    g.view(-1)[::97] = float('nan')
    g.view(-1)[5::101] = -0.0
    g.view(-1)[7::103] = float('-inf')
    if offset:
      buffer = torch.empty(g.numel() + offset, dtype=dtype, device='cuda')
      buffer[offset:].copy_(g.flatten())
      g = buffer[offset:].view(g.shape)
    launch = pool.bwd_launch(shape, window, strides, pads,
                             aligned=g.data_ptr() % 16 == 0, dtype=dtype)
    scatter = pool.pool_bwd.scatter_launches
    got = pool.pool_bwd(g, slot, shape, window, strides, pads)
    scatter = pool.pool_bwd.scatter_launches - scatter
    want = pool.plain_max_pool_bwd(g, slot, shape, window, strides, pads)
    torch.cuda.synchronize()
    if not same_bits(got, want):
      raise AssertionError(f'pool_bwd {name} differs from its plain version')
    if scatter != (launch['route'] == pool.ROUTE_SCATTER):
      raise AssertionError(f'pool_bwd {name}: route {launch["route"]}, '
                           f'{scatter} scatter launches')
    routes.add((launch['route'], launch['vec'], launch['templated']))
    log(f'check pool_bwd {name} {shape} {str(dtype)[6:]} window {window} '
        f'strides {strides} {padding}: bit for bit (route '
        f'{launch["route"]}, {launch["vec"]} channel(s) a thread, '
        f'{64 if launch["wide"] else 32}-bit offsets'
        + f', {"templated" if launch["templated"] else "runtime"} window'
        + (f', tiles {launch["tile"]} x {launch["groups_per_span"]} channel '
           f'groups, halo {launch["halo"]}, grid {launch["grid"]}, '
           f'{launch["smem"]} bytes of shared memory'
           if launch['route'] == pool.ROUTE_GATHER else '') + ')')
    del x, slot, g, got, want
  if not {(pool.ROUTE_SCATTER, 8, 1), (pool.ROUTE_SCATTER, 1, 1),
          (pool.ROUTE_SCATTER, 8, 0), (pool.ROUTE_GATHER, 8, 0),
          (pool.ROUTE_GATHER, 8, 1), (pool.ROUTE_GATHER, 1, 1)} <= routes:
    raise AssertionError(f'pool_bwd checks took only {routes}')
  for dtype in (torch.bfloat16, torch.float32):
    tie = torch.zeros((1, 4, 4, 8), dtype=dtype, device='cuda')
    tie[0, 2, 2] = tie[0, 3, 3] = 9.0
    _, slot = pool.pool_fwd(tie, (2, 2), (2, 2), ((0, 0), (0, 0)))
    g = torch.full((1, 2, 2, 8), 3.0, dtype=dtype, device='cuda')
    dx = pool.pool_bwd(g, slot, tie.shape, (2, 2), (2, 2), ((0, 0), (0, 0)))
    torch.cuda.synchronize()
    if float(dx[0, 2, 2].min()) != 3.0 or float(dx[0, 3, 3].abs().max()) != 0:
      raise AssertionError('pool_bwd tie did not route to the first slot')
  log('check pool_bwd planted tie: the cotangent goes to the first slot')
  return 0.0


# conv1's odd geometry for the gradient checks: stride 3, Cin 2, Cout 48,
# odd sizes (the tensor-core dx packs its 9 phases four to an n8 tile).
ODD_CONV_X = (4, 101, 97, 2)
ODD_CONV_W = (5, 5, 2, 48)
ODD_CONV_STRIDES = (3, 3)


def conv_out_shape(xshape, wshape, strides, pads):
  """[B, OH, OW, Cout] of a conv of NHWC ``xshape`` and HWIO ``wshape``."""
  (plh, phh), (plw, phw) = pads
  return (xshape[0], (xshape[1] + plh + phh - wshape[0]) // strides[0] + 1,
          (xshape[2] + plw + phw - wshape[1]) // strides[1] + 1, wshape[3])


@tf32_off()
def phase_check_conv_grads(generator):
  """conv_s2d_dw and conv_s2d_dx against their plain versions at the
  training conv1 shape and at an odd geometry (ODD_CONV_*), bfloat16 (dW
  and dx on the tensor cores) and float32 (both on the CUDA cores; TF32
  off for the plain versions), and dx in bfloat16 on the CUDA cores
  (conv_dx_ffma_kernel) at the odd geometry with g one element off
  16-byte alignment, which the tensor cores do not take; each kernel
  twice, bit for bit, its route logged and counted. Returns the errors of
  conv1's bfloat16 dW and dx and of its float32 dW and dx."""
  errors = {}
  for label, xshape, wshape, strides, dtype, offset in (
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.bfloat16, 0),
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.float32, 0),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.bfloat16, 0),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.float32, 0),
      ('odd_unaligned', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES,
       torch.bfloat16, 1)):
    pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, xshape[1:3])
    rel, of_max = (2.0**-7 if dtype == torch.bfloat16 else 0.0), 1e-5
    x = torch.rand(xshape, generator=generator, device='cuda').to(dtype)
    w = (0.1 * torch.randn(wshape, generator=generator, device='cuda')).to(
        dtype)
    g = torch.randn(conv_out_shape(xshape, wshape, strides, pads),
                    generator=generator, device='cuda').to(dtype)
    if offset:
      buffer = torch.empty(g.numel() + offset, dtype=dtype, device='cuda')
      buffer[offset:].copy_(g.flatten())
      g = buffer[offset:].view(g.shape)
    plans = {'conv_s2d_dx': conv_s2d.dx_plan(xshape, wshape, strides, pads,
                                             dtype, aligned=not offset)}
    runs = {'conv_s2d_dx': lambda: conv_s2d.conv_s2d_dx(g, w, xshape,
                                                        strides, pads)}
    want = {'conv_s2d_dx': conv_s2d.plain_conv2d_dx(g, w, xshape, strides,
                                                    pads)}
    if not offset:
      plans['conv_s2d_dw'] = conv_s2d.dw_plan(xshape, wshape, strides, pads,
                                              dtype)
      runs['conv_s2d_dw'] = lambda: conv_s2d.conv_s2d_dw(x, g, wshape,
                                                         strides, pads)
      want['conv_s2d_dw'] = conv_s2d.plain_conv2d_dw(x, g, wshape, strides,
                                                     pads)
    for name, plan in plans.items():
      before = getattr(conv_s2d, name).tensor_core_launches
      first, again = runs[name](), runs[name]()
      torch.cuda.synchronize()
      tensor_core = getattr(conv_s2d, name).tensor_core_launches - before
      what = f'{name} {label} {xshape} {str(dtype)[6:]}'
      if tensor_core != (2 if plan['route'] == conv_s2d.ROUTE_TENSOR_CORE
                         else 0):
        raise AssertionError(f'{what}: route {plan["route"]} but '
                             f'{tensor_core} tensor-core launches')
      if not torch.equal(first, again):
        raise AssertionError(f'{what} is not deterministic')
      scale = float(want[name].float().abs().max())
      err, ok = within(first, want[name], rel, of_max)
      if not ok:
        raise AssertionError(f'{what} outside its band: max abs err {err} '
                             f'at max magnitude {scale}')
      errors[(name, label, dtype)] = err
      log(f'check {what}: max abs err {err:.3e} at max magnitude '
          f'{scale:.3e} (band {rel:.1e} relative + {of_max:.0e} of the '
          f'max); twice: bitwise equal; plan {plan}')
      del first, again
    del x, w, g, want
  return tuple(errors[(name, 'conv1', dtype)]
               for dtype in (torch.bfloat16, torch.float32)
               for name in ('conv_s2d_dw', 'conv_s2d_dx'))


def train_batches(seed, count, batch, shuffle_rewards=True):
  """Seeded (features, labels) host batches: uint8 frames, actions, 0/1
  rewards."""
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(count):
    features = {
        'state/image': rng.randint(0, 256, (batch, 512, 640, 3),
                                   dtype=np.uint8),
        'action/world_vector': rng.randn(batch, 3).astype(np.float32),
        'action/vertical_rotation': rng.randn(batch, 2).astype(np.float32),
    }
    rewards = rng.randint(0, 2, (batch, 1)) if shuffle_rewards else (
        np.arange(batch)[:, None] % 2)
    batches.append((features, {'reward': rewards.astype(np.float32)}))
  return batches


def phase_train(seed, steps):
  """The training main path at full width, batch 32, bf16."""
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                         log_interval_steps=0, seed=seed))
  batches = iter(train_batches(seed, 1 + steps, TRAIN_BATCH))
  with _dispatch.force_kernels(True):
    trainer.train(batches, None)  # builds the state; warm-up step
    torch.cuda.synchronize()
    state = trainer.state
    params = dict(state.network.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    ema_before = {k: v.clone() for k, v in state.ema.items()}
    copies = pool.MaxPoolArgmax.cotangent_copies
    trainer.config.max_train_steps = 1 + steps
    zero_counters()
    start = time.perf_counter()
    scalars = trainer.train(batches, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counters()
  copies = pool.MaxPoolArgmax.cotangent_copies - copies
  want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
  if launches != want or trainer.step != 1 + steps:
    raise AssertionError(
        f'launches over {steps} steps: {launches}, expected {want}')
  if not all(np.isfinite(v) for v in scalars.values()):
    raise AssertionError(f'non-finite step summaries {scalars}')
  for name, param in params.items():
    if param.grad is None or not bool(torch.isfinite(param.grad).all()):
      raise AssertionError(f'{name}: gradient {param.grad!r}')
    if torch.equal(param.detach(), before[name]):
      raise AssertionError(f'{name} did not move in {steps} steps')
  ema_moved = [k for k in ema_before
               if not torch.equal(state.ema[k], ema_before[k])]
  if not ema_moved:
    raise AssertionError('the EMA did not move')
  ms_per_step = 1e3 * seconds / steps
  log(f'train: {steps} steps at batch {TRAIN_BATCH}, {ms_per_step:.2f} '
      f'ms/step (host clock, synchronised), loss {scalars["loss"]:.4f}, '
      f'q_mean {scalars["q_mean"]:.4f}, launches {launches}, '
      f'{len(params)} parameters with finite gradients, all moved; EMA '
      f'moved in {len(ema_moved)} of {len(ema_before)}; cotangent layout '
      f'copies {copies / steps:g} per step')
  peak = torch.cuda.max_memory_allocated() / 2**30
  log(f'train: peak device memory so far {peak:.2f} GiB')

  predictor = CheckpointPredictor(model, device='cuda')
  predictor.load_state_dict(state.eval_state_dict(), global_step=trainer.step)
  rng = np.random.RandomState(seed + 3)
  pairs = rng.randn(8, 5).astype(np.float32)
  with _dispatch.force_kernels(True):
    q = predictor.predict({
        'state/image': rng.randint(0, 256, (8, 512, 640, 3), dtype=np.uint8),
        'action/world_vector': pairs[:, :3],
        'action/vertical_rotation': pairs[:, 3:]})['q_predicted']
  if q.shape != (8,) or not np.isfinite(q).all() or not (
      (q >= 0) & (q <= 1)).all():
    raise AssertionError(f'bad predict output from the EMA weights {q!r}')
  log(f'train: EMA weights served, q_predicted '
      f'{np.array2string(q, precision=4)}')
  return ms_per_step, launches, trainer


# Kernel launches of the checkpoint phase's parts: per training step as on
# the training path, per eval batch and per served action one forward.
EVAL_BATCH_LAUNCHES = {'pool_fwd': 3, 'conv_s2d_fwd': 1,
                       'conv_s2d_fwd_tensor_core': 1}
ACTION_LAUNCHES = {'pool_fwd': 9, 'conv_s2d_fwd': 3,
                   'conv_s2d_fwd_tensor_core': 3}


def path_launches(steps=0, eval_batches=0, actions=0):
  """The launch counts of ``steps`` training steps, ``eval_batches`` eval
  batches and ``actions`` served actions of the QT-Opt paths."""
  want = {name: steps * count for name, count in TRAIN_LAUNCHES.items()}
  for per, count in ((EVAL_BATCH_LAUNCHES, eval_batches),
                     (ACTION_LAUNCHES, actions)):
    for name, value in per.items():
      want[name] += count * value
  return want


def check_launches(what, launches, want):
  if launches != want:
    raise AssertionError(f'checkpoint phase, {what}: launches {launches}, '
                         f'expected {want}')


def payload_tensors(tree, prefix=''):
  """(path, leaf) of every leaf of a checkpoint payload."""
  if isinstance(tree, dict):
    for key, value in tree.items():
      yield from payload_tensors(value, f'{prefix}/{key}')
  elif isinstance(tree, (list, tuple)):
    for i, value in enumerate(tree):
      yield from payload_tensors(value, f'{prefix}/{i}')
  else:
    yield prefix, tree


def payload_mismatches(got, want):
  """The paths where two payloads differ: tensors by their bits, other
  leaves by value."""
  got, want = dict(payload_tensors(got)), dict(payload_tensors(want))
  if set(got) != set(want):
    return sorted(set(got) ^ set(want))
  bad = []
  for path, value in want.items():
    other = got[path]
    if isinstance(value, torch.Tensor):
      same = isinstance(other, torch.Tensor) and same_bits(
          other.cpu(), value.cpu())
    else:
      same = other == value
    if not same:
      bad.append(path)
  return bad


class _Recorder(TrainerCallback):
  """Keeps the eval metrics by step, a host copy of the state at each
  checkpoint (while ``keep``: a timing window turns it off, since the copy
  is the harness's, not the loop's), and the host-clock time of each step
  (synchronised)."""

  def __init__(self):
    self.metrics, self.saved, self.step_ms = {}, {}, {}
    self.keep = True
    self._last = None

  def begin(self, trainer):
    torch.cuda.synchronize()
    self._last = time.perf_counter()

  def after_step(self, trainer, step, scalars):
    torch.cuda.synchronize()
    now = time.perf_counter()
    self.step_ms[step] = 1e3 * (now - self._last)
    self._last = now

  def after_checkpoint(self, trainer, step):
    if self.keep:
      self.saved[step] = ckpt_lib.to_host(
          train_state.state_dict(trainer.state))

  def after_eval(self, trainer, step, metrics):
    self.metrics[step] = dict(metrics)


# The step after a save before the staged writer (PR 12 and PR 17's
# chip_smoke.py runs, NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's split.
SAVE_BEFORE = {'qtopt': 'the step after a save 41-54 ms (PR 12)',
               'grasp2vec': 'the binary\'s step after a save 0.982-1.175 s '
                            '(PR 17)'}


class SaveTimes:
  """Each save of a ``CheckpointManager``: its ``timings`` dict (the
  writer thread completes it with ``serialize_ms``, ``sync_ms`` and
  ``write_ms``) with the loop's whole ``save`` call as ``call_ms``."""

  def __init__(self, manager):
    self.by_step = {}
    real = manager.save

    def save(step, payload, force=False):
      start = time.perf_counter()
      saved = real(step, payload, force=force)
      if saved:
        manager.timings['call_ms'] = 1e3 * (time.perf_counter() - start)
        self.by_step[int(step)] = manager.timings
      return saved

    manager.save = save


class SaveWindow(TrainerCallback):
  """Once armed, times every step (synchronised) and saves the trainer's
  state through ``manager`` after the steps of ``at``, as the trainer's
  own save follows a step's callbacks: a save's cost falls in the next
  step's time. Unarmed, it does nothing."""

  def __init__(self):
    self.step_ms, self.manager, self.at, self.saves = {}, None, (), None
    self._last = None

  def arm(self, manager, at):
    self.manager, self.at, self.saves = manager, set(at), SaveTimes(manager)

  def begin(self, trainer):
    if self.manager is not None:
      torch.cuda.synchronize()
      self._last = time.perf_counter()

  def after_step(self, trainer, step, scalars):
    if self.manager is None:
      return
    torch.cuda.synchronize()
    now = time.perf_counter()
    self.step_ms[step] = 1e3 * (now - self._last)
    self._last = now
    if step in self.at:
      self.manager.save(step, train_state.state_dict(trainer.state),
                        force=True)


def log_save_split(what, step_ms, quiet, saves, size_mb, card):
  """The loop's cost of each save of ``saves`` (a SaveTimes whose writes
  have ended) against the ``quiet`` steps, which had no save in them."""
  quiet_ms = [step_ms[s] for s in quiet]
  mean = float(np.mean(quiet_ms))
  for step, t in sorted(saves.by_step.items()):
    if step + 1 not in step_ms:
      continue
    after = step_ms[step + 1]
    log(f'{what}: async save of step {step} ({size_mb:.1f} MB payload): the '
        f'loop\'s save call {t["call_ms"]:.3f} ms, {t["copy_ms"]:.3f} of it '
        f'the host copy (into the page-locked staging buffers); the step '
        f'after it {after:.3f} ms against the quiet steps '
        f'{np.round(quiet_ms, 3).tolist()} (mean {mean:.3f}, spread '
        f'{max(quiet_ms) - min(quiet_ms):.3f}): {after - mean:.3f} ms over a '
        f'quiet step, {after - mean - t["copy_ms"]:.3f} beyond the copy; the '
        f'next steps {[round(step_ms[s], 3) for s in range(step + 2, step + 4) if s in step_ms]};'
        f' on the writer thread torch.save {t.get("serialize_ms", 0):.3f} ms, '
        f'fsync {t.get("sync_ms", 0):.3f}, write to durable '
        f'{t.get("write_ms", 0):.3f} (host clock, synchronised steps) on '
        f'{card}; before the staged writer: {SAVE_BEFORE[what]}')


def synced_ms(fn):
  torch.cuda.synchronize()
  start = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - start), out


def run_trainer_binary(model_dir):
  """The trainer binary on the port's QT-Opt config, 3 steps and one eval
  batch, in a subprocess; its model_dir must hold a committed ckpt_3."""
  repo = pathlib.Path(__file__).resolve().parent
  cmd = [sys.executable, '-m', 'tensor2robot_tpu_torch.bin.run_t2r_trainer',
         '--gin_configs', str(repo / QTOPT_GIN),
         '--gin_bindings', 'train_eval_model.max_train_steps = 3',
         '--gin_bindings', 'train_eval_model.eval_steps = 1',
         '--gin_bindings', f"train_eval_model.model_dir = '{model_dir}'"]
  start = time.perf_counter()
  proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                        timeout=600, check=False)
  seconds = time.perf_counter() - start
  step = ckpt_lib.latest_checkpoint_step(str(model_dir / 'checkpoints'))
  if proc.returncode != 0 or step != 3:
    raise AssertionError(
        f'trainer binary: exit {proc.returncode}, newest committed step '
        f'{step}; its output ended:\n{proc.stdout[-3000:]}\n'
        f'{proc.stderr[-3000:]}')
  log(f'checkpoint: python -m tensor2robot_tpu_torch.bin.run_t2r_trainer '
      f'--gin_configs {QTOPT_GIN} (3 steps, eval_steps 1) exited 0 in '
      f'{seconds:.1f} s and left a committed ckpt_3')


def phase_checkpoint(seed, card):
  """Checkpoints, resume, eval and serving from a checkpoint on the QT-Opt
  main path at full width, batch 32, under deterministic cuDNN without
  autotuning (restored after the phase). Returns the launch counts of
  its training, eval and serving parts."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='checkpoint_phase_',
                                       dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        _dispatch.force_kernels(True):
      return checkpoint_paths(seed, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def checkpoint_paths(seed, card, root):
  def model():
    return GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')

  def generator(mode):
    gen = input_generators.DefaultRandomInputGenerator(batch_size=TRAIN_BATCH)
    gen.set_specification_from_model(model(), mode)
    return gen

  def run(model_dir, steps, recorder):
    return train_eval_model(
        model=model(), model_dir=str(model_dir),
        train_input_generator=generator(ModeKeys.TRAIN),
        eval_input_generator=generator(ModeKeys.EVAL),
        max_train_steps=steps, eval_steps=CKPT_EVAL_BATCHES,
        eval_interval_steps=CKPT_INTERVAL, save_interval_steps=CKPT_INTERVAL,
        log_interval_steps=0, seed=seed, callbacks=[recorder], device='cuda')

  total = path_launches()

  def counted(what, fn, want):
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counters()
    check_launches(what, launches, want)
    for name in total:
      total[name] += launches[name]
    return out

  # 1. Training with saves and interleaved eval, and an uninterrupted run.
  first, straight = _Recorder(), _Recorder()
  dir_a, dir_b = root / 'a', root / 'b'
  metrics = counted(
      'train_eval_model, 6 steps', lambda: run(dir_a, 6, first),
      path_launches(steps=6, eval_batches=2 * CKPT_EVAL_BATCHES))
  counted('train_eval_model, 9 steps', lambda: run(dir_b, 9, straight),
          path_launches(steps=9, eval_batches=3 * CKPT_EVAL_BATCHES))
  ckpt_dir = dir_a / 'checkpoints'
  if ckpt_lib.latest_checkpoint_step(str(ckpt_dir)) != 6 or sorted(
      first.saved) != [3, 6]:
    raise AssertionError(f'saves {sorted(first.saved)} under {ckpt_dir}')
  size_mb = (ckpt_dir / 'ckpt_6' / ckpt_lib.STATE_FILENAME).stat().st_size / 1e6

  # 2. A fresh trainer restores step 6: bit for bit what was saved.
  timed = _Recorder()
  trainer = Trainer(model(), TrainerConfig(
      model_dir=str(dir_a), max_train_steps=9, eval_steps=CKPT_EVAL_BATCHES,
      save_interval_steps=CKPT_INTERVAL, log_interval_steps=0, seed=seed),
                    callbacks=[timed])
  stream = itertools.islice(generator(ModeKeys.TRAIN).create_iterator(
      ModeKeys.TRAIN), 5, None)
  trainer.initialize(next(stream)[0])
  restored = ckpt_lib.to_host(train_state.state_dict(trainer.state))
  bad = payload_mismatches(restored, first.saved[6])
  if trainer.step != 6 or bad:
    raise AssertionError(f'restored step {trainer.step}; differs from the '
                         f'saved state at {bad[:8]}')
  restore_ms, _ = synced_ms(lambda: trainer.restore_checkpoint(6))
  log(f'checkpoint: step 6 restored bit for bit ({len(restored["network"])} '
      f'network tensors, the momentum buffers and counts, the EMA, the '
      f'generator and the step; same_bits)')

  # 4. Eval: train_eval_model's metrics at step 6 again from the restore.
  if not all(np.isfinite(v) for v in metrics.values()) or (
      metrics != first.metrics[6]):
    raise AssertionError(f'eval metrics {metrics} at step 6, recorded '
                         f'{first.metrics}')
  eval_batches = list(itertools.islice(
      generator(ModeKeys.EVAL).create_iterator(ModeKeys.EVAL),
      CKPT_EVAL_BATCHES))
  eval_ms, again = synced_ms(lambda: counted(
      'Trainer.evaluate', lambda: trainer.evaluate(iter(eval_batches)),
      path_launches(eval_batches=CKPT_EVAL_BATCHES)))
  if again != metrics:
    raise AssertionError(f'eval from the restored state {again}, from '
                         f'train_eval_model {metrics}')
  log(f'checkpoint: eval at step 6 {metrics}, equal from the restored '
      'state')

  # 3. Resume to 9: bit for bit the uninterrupted run's step 9.
  batches = list(itertools.islice(stream, 12))
  counted('resume 6 -> 9', lambda: trainer.train(iter(batches[:3])),
          path_launches(steps=3))
  bad = payload_mismatches(ckpt_lib.to_host(
      train_state.state_dict(trainer.state)), straight.saved[9])
  if trainer.step != 9 or bad:
    raise AssertionError(
        f'resumed step {trainer.step} differs from the uninterrupted run at '
        f'{bad[:8]} ({len(bad)} leaves)')
  log('checkpoint: resumed 6 -> 9 bit for bit the uninterrupted 9-step run '
      '(parameters, batch statistics, EMA, momentum buffers, counts, '
      f'generator; {cudnn_flags()})')

  # 5. Serving from the checkpoint, then a hot swap to step 12.
  serving_model = model()
  predictor = CheckpointPredictor(serving_model, str(dir_a), device='cuda')
  np.random.seed(seed)
  frames = np.random.RandomState(seed + 5).randint(
      0, 256, (CKPT_ACTIONS + 1, 512, 640, 3), dtype=np.uint8)
  policy = CEMPolicy(t2r_model=serving_model, predictor=predictor,
                     action_size=5, cem_samples=64, cem_iters=3,
                     num_elites=6, device_resident=True)
  first_ms, _ = synced_ms(lambda: (predictor.restore(), policy.SelectAction(
      frames[0], None, 0)))
  if predictor.global_step != 9:
    raise AssertionError(f'restored step {predictor.global_step}, not 9')
  rng = np.random.RandomState(seed + 6)
  pairs = rng.randn(8, 5).astype(np.float32)
  features = {'state/image': rng.randint(0, 256, (8, 512, 640, 3),
                                         dtype=np.uint8),
              'action/world_vector': pairs[:, :3],
              'action/vertical_rotation': pairs[:, 3:]}
  direct = CheckpointPredictor(model(), device='cuda')
  direct.load_state_dict(trainer.state.eval_state_dict(), global_step=9)
  q = predictor.predict(features)['q_predicted']
  if not np.array_equal(q.view(np.int32), direct.predict(features)[
      'q_predicted'].view(np.int32)) or not np.isfinite(q).all():
    raise AssertionError(f'restored q {q} differs from the state\'s')
  actions = counted(
      'serving', lambda: [policy.SelectAction(frames[t], None, t)
                          for t in range(1, CKPT_ACTIONS + 1)],
      path_launches(actions=CKPT_ACTIONS))
  if not all(a.shape == (5,) and np.isfinite(a).all() for a in actions):
    raise AssertionError(f'bad actions {actions}')
  serving_fn = predictor.device_serving_fn()
  served_9 = {k: v.clone() for k, v in serving_fn.network.state_dict().items()}
  trainer.config.max_train_steps = 12
  counted('train 9 -> 12', lambda: trainer.train(iter(batches[3:6])),
          path_launches(steps=3))
  if not predictor.restore() or predictor.global_step != 12 or (
      predictor.device_serving_fn() is not serving_fn):
    raise AssertionError(f'hot swap: step {predictor.global_step}')
  want = trainer.state.eval_state_dict()
  swapped = [name for name, value in serving_fn.network.state_dict().items()
             if not same_bits(value, want[name])]
  moved = [name for name, value in served_9.items()
           if not same_bits(value, want[name])]
  if swapped or not moved:
    raise AssertionError(f'the served network is not step 12 at {swapped}, '
                         f'or step 12 is step 9 ({len(moved)} moved)')
  policy.SelectAction(frames[0], None, 0)
  log(f'checkpoint: CheckpointPredictor.restore() served {CKPT_ACTIONS} CEM '
      'actions from step 9 (q on 8 pairs bit for bit a predictor loaded '
      'from the state), then the same device_serving_fn served step 12')

  # 8. Timings: steps 13-15 with no save in them, 16-18 with step 15's
  # save (its host copy before step 16, its write during 16-17); the
  # recorder keeps no copy of its own in the window.
  trainer.config.max_train_steps = 18
  manager = trainer.checkpoint_manager
  saves = SaveTimes(manager)
  timed.keep = False
  trainer.train(iter(batches[6:12]))
  quiet = [timed.step_ms[s] for s in (13, 14, 15)]
  saving = [timed.step_ms[s] for s in (16, 17, 18)]
  log(f'checkpoint: state.pt {size_mb:.2f} MB on {card}')
  log_save_split('qtopt', timed.step_ms, (13, 14, 15), saves, size_mb, card)
  log(f'checkpoint: restore of step 6 {restore_ms:.2f} ms (host clock, '
      f'synchronised: read, copy into the live state) on {card}')
  log(f'checkpoint: eval pass {eval_ms / CKPT_EVAL_BATCHES:.2f} ms/batch '
      f'(host clock, synchronised, batch {TRAIN_BATCH}, batches made '
      f'beforehand) on {card}')
  log(f'checkpoint: ms/step steps 13-15 (no save) '
      f'{np.round(quiet, 3).tolist()}, mean {np.mean(quiet):.3f}; steps 16-18 '
      f'(step 15\'s async save) {np.round(saving, 3).tolist()}, mean '
      f'{np.mean(saving):.3f} (host clock, synchronised) on {card}')
  log(f'checkpoint: predictor restore to first action {first_ms:.2f} ms '
      f'(build, load step 9, one CEM action) on {card}')

  # 7. The trainer binary.
  run_trainer_binary(root / 'binary')
  return total


# The export and serving path: the critic exported as a torch.export program
# (the pool and conv1 kernels as custom ops), loaded without the model,
# driving CEM and the batching plane.
EXPORT_ACTIONS = 5  # actions a block; two blocks a predictor, in turns
BATCHER_CLIENTS = 8
BATCHER_EXAMPLES = 8  # a request: one frame and 8 grasps
BATCHER_MAX_BATCH = 64
BATCHER_SECONDS = 6.0
BATCHER_SWAP_AT = 2.0  # seconds into the load when version 2 is written
SUBPROCESS_PAIRS = 8

# Loads the exported program in a process that cannot import the model's
# modules, predicts q for the parent's (frame, grasp) pairs and reports
# restore-to-first-prediction ms and its launches.
EXPORT_LOADER = '''
import importlib.abc, json, sys, time
class _Blocked(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.startswith(('tensor2robot_tpu_torch.research',
                        'tensor2robot_tpu_torch.models')):
      raise ImportError('blocked: ' + name)
    return None
sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
from tensor2robot_tpu_torch.ops import conv_s2d, pool
from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
root, features, out = sys.argv[1:4]
features = dict(np.load(features))
torch.cuda.synchronize()
marks = [time.perf_counter()]
predictor = ExportedModelPredictor(root, device='cuda')
assert predictor.restore()
marks.append(time.perf_counter())
for _ in range(2):
  q = predictor.predict(features)['q_predicted']
  torch.cuda.synchronize()
  marks.append(time.perf_counter())
np.save(out, q)
leaked = sorted(m for m in sys.modules if m.startswith((
    'tensor2robot_tpu_torch.research', 'tensor2robot_tpu_torch.models')))
assert not leaked, leaked
from tensor2robot_tpu_torch.export import exporters
with open(predictor.model_path + '/' + exporters.SERVING_FN_FILENAME,
          'rb') as f:
  data = f.read()
marks.append(time.perf_counter())
exporters.deserialize_serving_program(data, 'cuda').module()
marks.append(time.perf_counter())
exporters.load_state_from_export_dir(predictor.model_path, 'cuda')
torch.cuda.synchronize()
marks.append(time.perf_counter())
ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
print(json.dumps({'restore_to_first_prediction_ms': ms[0] + ms[1],
                  'restore_ms': ms[0], 'first_predict_ms': ms[1],
                  'second_predict_ms': ms[2], 'warm_load_ms': ms[4],
                  'warm_state_ms': ms[5],
                  'pool_fwd': pool.pool_fwd.launches,
                  'conv_s2d_fwd': conv_s2d.conv_s2d_fwd.launches,
                  'research_modules': leaked}))
'''


# Writes version 2 (the seeded weights of ``seed``) into the export root
# from a process of its own, as a trainer does: it builds the model and its
# weights, prints 'ready', and exports when a line arrives on its stdin.
EXPORT_WRITER = '''
import json, sys, time
import torch
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.qtopt import GraspingModelWrapper
root, seed = sys.argv[1], int(sys.argv[2])
model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
predictor = CheckpointPredictor(model, device='cuda')
predictor.init_randomly(torch.Generator().manual_seed(seed))
torch.cuda.synchronize()
print('ready', flush=True)
sys.stdin.readline()
start = time.perf_counter()
path = exporters.ModelExporter().export(
    model, exporters.ServingState(1, predictor.network.state_dict()), root,
    version=2)
print(json.dumps({'export_s': time.perf_counter() - start, 'path': path}),
      flush=True)
'''


def phase_export_serving(seed, card):
  """Export, the exported predictor and the batching plane on the QT-Opt
  serving path at full width, under deterministic cuDNN without
  autotuning (restored after the phase); files under a temporary
  directory below ``chiprun_out/``, removed at the end. Returns the
  launch counts of its CEM and batcher parts."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='export_phase_', dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        _dispatch.force_kernels(True):
      return export_serving_paths(seed, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def frame_shape(model):
  return tuple(exporters.serving_feature_spec(model)['state/image'].shape)


def serving_pairs(model, seed, count):
  rng = np.random.RandomState(seed)
  pairs = rng.randn(count, 5).astype(np.float32)
  return {'state/image': rng.randint(0, 256, (count,) + frame_shape(model),
                                     dtype=np.uint8),
          'action/world_vector': pairs[:, :3],
          'action/vertical_rotation': pairs[:, 3:]}


def export_version(model, state_dict, step, root, version):
  """One export version of ``state_dict`` (its tensors' device traces)."""
  return pathlib.Path(exporters.ModelExporter().export(
      model, exporters.ServingState(step, state_dict), str(root),
      version=version))


def program_nodes(path):
  program = torch.export.load(str(path / exporters.SERVING_FN_FILENAME))
  counts = exporters.program_op_counts(program)
  return (counts.get('t2r.pool_fwd.default', 0),
          counts.get('t2r.conv_s2d_fwd.default', 0), sum(counts.values()))


def check_meta(path, trace_device):
  meta = exporters.read_export_meta(str(path))
  if meta['self_contained_serving_fn'] is not True or (
      torch.device(meta['trace_device']).type != trace_device):
    raise AssertionError(f'export {path.name}: meta {meta}, expected a '
                         f'self-contained program traced on {trace_device}')
  return meta


def cem_block(policy, frames, seed):
  """Host-clock ms of one synchronised block of actions, and the actions."""
  np.random.seed(seed)
  torch.cuda.synchronize()
  start = time.perf_counter()
  actions = [policy.SelectAction(frame, None, t)
             for t, frame in enumerate(frames)]
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - start), actions


def export_serving_paths(seed, card, root):
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  eager = CheckpointPredictor(model, device='cuda')
  eager.init_randomly(torch.Generator().manual_seed(seed))
  total = path_launches()

  def counted(what, fn, want):
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != want:
      raise AssertionError(f'export phase, {what}: launches {launches}, '
                           f'expected {want}')
    for name in total:
      total[name] += launches[name]
    return out

  # 1. Export on the card.
  export_ms, version = synced_ms(lambda: export_version(
      model, eager.network.state_dict(), 0, root / 'export', 1))
  meta = check_meta(version, eager.device.type)
  pools, convs, ops = program_nodes(version)
  artifact = (version / exporters.SERVING_FN_FILENAME).stat().st_size
  if (pools, convs) != (3, 1):
    raise AssertionError(f'exported graph: {pools} t2r.pool_fwd and {convs} '
                         't2r.conv_s2d_fwd nodes, expected 3 and 1')
  log(f'export: program traced on {meta["trace_device"]} with {ops} op nodes, '
      f'{pools} t2r.pool_fwd and {convs} t2r.conv_s2d_fwd; '
      f'self_contained_serving_fn {meta["self_contained_serving_fn"]}; '
      f'serving_fn.pt2 {artifact} bytes; export {export_ms:.1f} ms (trace, '
      f'state, assets, warmup, commit; host clock) on {card}')

  # 2. Load in a process that cannot import the model; q against the eager
  # predictor on the same weights.
  features = serving_pairs(model, seed + 7, SUBPROCESS_PAIRS)
  np.savez(root / 'pairs.npz', **features)
  repo = pathlib.Path(__file__).resolve().parent
  proc = subprocess.run(
      [sys.executable, '-c', EXPORT_LOADER, str(root / 'export'),
       str(root / 'pairs.npz'), str(root / 'q.npy')],
      cwd=repo, capture_output=True, text=True, timeout=600, check=False,
      env=dict(os.environ, T2R_FORCE_PALLAS_KERNELS='1'))
  if proc.returncode != 0:
    raise AssertionError(f'export loader: exit {proc.returncode}:\n'
                         f'{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}')
  loaded = json.loads(proc.stdout.strip().splitlines()[-1])
  if (loaded['pool_fwd'], loaded['conv_s2d_fwd']) != (6, 2):
    raise AssertionError(f'export loader launches {loaded}')
  want = eager.predict(features)['q_predicted']
  got = np.load(root / 'q.npy')
  diff = float(np.abs(got - want).max())
  log(f'export: a process without the model modules (research_modules '
      f'{loaded["research_modules"]}) loaded the program and predicted '
      f'{SUBPROCESS_PAIRS} pairs, restore to first prediction '
      f'{loaded["restore_to_first_prediction_ms"]:.1f} ms (restore '
      f'{loaded["restore_ms"]:.1f}: the first torch.export.load with its '
      f'imports, the move pass, state.pt; first predict '
      f'{loaded["first_predict_ms"]:.1f}, second '
      f'{loaded["second_predict_ms"]:.1f}; a second program load and move '
      f'{loaded["warm_load_ms"]:.1f}, a second state.pt load '
      f'{loaded["warm_state_ms"]:.1f}), launches over the two '
      f'pool_fwd {loaded["pool_fwd"]} conv_s2d_fwd {loaded["conv_s2d_fwd"]}; '
      f'q against the eager CheckpointPredictor: max abs diff {diff:.3e}, '
      f'bit for bit {np.array_equal(got.view(np.int32), want.view(np.int32))} '
      f'on {card}')
  if not np.array_equal(got.view(np.int32), want.view(np.int32)):
    raise AssertionError(f'exported q {got} differs from eager {want}')

  # 3. CEM through the exported predictor, in turns with the eager one;
  # then an artifact traced on the CPU and moved to the card.
  exported = ExportedModelPredictor(str(root / 'export'), device='cuda')
  if not exported.restore():
    raise AssertionError('the exported predictor found no version')
  policies = {name: CEMPolicy(t2r_model=model, predictor=p, action_size=5,
                              cem_samples=64, cem_iters=3, num_elites=6,
                              device_resident=True)
              for name, p in (('eager', eager), ('exported', exported))}
  frames = np.random.RandomState(seed + 8).randint(
      0, 256, (EXPORT_ACTIONS,) + frame_shape(model), dtype=np.uint8)
  for policy in policies.values():
    cem_block(policy, frames[:1], seed)  # warm-up
  times = {'eager': [], 'exported': []}
  chosen = {}
  for name in ('eager', 'exported', 'exported', 'eager'):
    ms, actions = counted(
        f'{name} CEM', lambda name=name: cem_block(policies[name], frames,
                                                   seed),
        path_launches(actions=EXPORT_ACTIONS))
    times[name].append(ms / EXPORT_ACTIONS)
    chosen.setdefault(name, actions)
  same = all(np.array_equal(a, b) for a, b in zip(chosen['eager'],
                                                  chosen['exported']))
  if not same:
    raise AssertionError(f'exported CEM actions {chosen["exported"]} differ '
                         f'from eager {chosen["eager"]}')
  log(f'export: CEM 64x3 through the exported predictor '
      f'{np.round(times["exported"], 3).tolist()} ms/action, through the '
      f'eager CheckpointPredictor {np.round(times["eager"], 3).tolist()} '
      f'(blocks of {EXPORT_ACTIONS} in turns eager, exported, exported, '
      f'eager; host clock, synchronised, deterministic cuDNN); the same '
      f'{EXPORT_ACTIONS} actions from both; launches per action '
      f'{ACTION_LAUNCHES} on {card}')

  cpu_ms, cpu_version = synced_ms(lambda: export_version(
      model, {k: v.cpu() for k, v in eager.network.state_dict().items()}, 0,
      root / 'cpu_export', 1))
  check_meta(cpu_version, 'cpu')
  moved = ExportedModelPredictor(str(root / 'cpu_export'), device='cuda')
  if not moved.restore():
    raise AssertionError('the CPU-traced export did not load')
  moved_policy = CEMPolicy(t2r_model=model, predictor=moved, action_size=5,
                           cem_samples=64, cem_iters=3, num_elites=6,
                           device_resident=True)
  _, moved_actions = counted(
      'CEM on the CPU-traced program',
      lambda: cem_block(moved_policy, frames, seed),
      path_launches(actions=EXPORT_ACTIONS))
  if not all(np.array_equal(a, b) for a, b in zip(moved_actions,
                                                  chosen['exported'])):
    raise AssertionError('the CPU-traced program chose other actions')
  log(f'export: the program traced on the CPU (export {cpu_ms:.1f} ms, the '
      f'second export of the process; serving_fn.pt2 '
      f'{(cpu_version / exporters.SERVING_FN_FILENAME).stat().st_size} '
      f'bytes), moved to the card, launched {ACTION_LAUNCHES} an action over '
      f'{EXPORT_ACTIONS} actions and chose the card-traced program\'s '
      f'actions on {card}')

  # 4. The batching plane over the exported predictor, with a second
  # version (other weights) exported under load.
  def tally(launches):
    for name in total:
      total[name] += launches[name]

  export_batcher(seed, card, model, exported, root, frames, tally)
  return total


def export_batcher(seed, card, model, exported, root, frames, tally):
  """DynamicBatcher(max_batch=64) over ``exported.stateless_serving_fn()``:
  8 client threads, each submitting requests of one frame and 8 grasps in
  a closed loop for BATCHER_SECONDS, while version 2 (other weights) is
  exported into the root by another process (EXPORT_WRITER) at
  BATCHER_SWAP_AT and adopted under load; then one full dispatch taken
  apart. A dispatch runs the program once: one eval batch's launches."""
  compiles = metrics_lib.counter('serving/bucket_compiles')
  dispatches = metrics_lib.counter('serving/dispatches')
  swaps = metrics_lib.counter('serving/model_swaps')
  rng = np.random.RandomState(seed + 9)
  requests = []
  for c in range(BATCHER_CLIENTS):
    grasps = rng.randn(BATCHER_EXAMPLES, 5).astype(np.float32)
    requests.append({
        'state/image': np.repeat(frames[c % len(frames)][None],
                                 BATCHER_EXAMPLES, axis=0),
        'action/world_vector': grasps[:, :3],
        'action/vertical_rotation': grasps[:, 3:]})
  other = CheckpointPredictor(model, device='cuda')
  other.init_randomly(torch.Generator().manual_seed(seed + 1))
  key = exported.stateless_serving_fn().program_key
  done, errors = [], []  # (completion time, latency ms)
  stop = threading.Event()
  batcher = DynamicBatcher(exported, max_batch=BATCHER_MAX_BATCH,
                           batch_deadline_ms=5.0, reload_interval_secs=0.2)

  def client(c):
    while not stop.is_set():
      begin = time.perf_counter()
      try:
        batcher.submit(requests[c]).result(timeout=60.0)
        end = time.perf_counter()
        done.append((end, 1e3 * (end - begin)))
      except Exception as e:  # pylint: disable=broad-except
        errors.append(repr(e))

  def load(writer):
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(BATCHER_CLIENTS)]
    dispatched, swaps0 = dispatches.value, swaps.value
    begin = time.perf_counter()
    for thread in threads:
      thread.start()
    time.sleep(BATCHER_SWAP_AT)
    swap_begin = time.perf_counter()
    writer.stdin.write('go\n')
    writer.stdin.flush()
    line = writer.stdout.readline()
    if not line:
      stop.set()
      writer.wait(timeout=60)
      raise AssertionError(f'export writer: exit {writer.returncode}:\n'
                           f'{(root / "writer.err").read_text()[-3000:]}')
    written = json.loads(line)
    export_s = time.perf_counter() - swap_begin
    deadline = time.perf_counter() + 60.0
    while batcher.model_version != 1 and time.perf_counter() < deadline:
      time.sleep(0.05)
    adopted = time.perf_counter() - begin
    time.sleep(max(0.0, BATCHER_SECONDS - adopted))
    stop.set()
    for thread in threads:
      thread.join(timeout=120.0)
    return dict(seconds=time.perf_counter() - begin,
                count=dispatches.value - dispatched,
                swapped=swaps.value - swaps0, adopted=adopted,
                export_s=export_s, writer_export_s=written['export_s'],
                steady_s=swap_begin - begin, swap_begin=swap_begin,
                adopted_at=begin + adopted)

  repo = pathlib.Path(__file__).resolve().parent
  with open(root / 'writer.err', 'w') as err:
    writer = subprocess.Popen(
        [sys.executable, '-c', EXPORT_WRITER, str(root / 'export'),
         str(seed + 1)], cwd=repo, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=err, text=True,
        env=dict(os.environ, T2R_FORCE_PALLAS_KERNELS='1'))
  try:
    if writer.stdout.readline().strip() != 'ready':
      writer.wait(timeout=60)
      raise AssertionError(f'export writer: exit {writer.returncode}:\n'
                           f'{(root / "writer.err").read_text()[-3000:]}')
    start_ms, _ = synced_ms(batcher.start)
    warm = compiles.value
    zero_counters()
    run = load(writer)
    torch.cuda.synchronize()
    launches = read_counters()
    want = path_launches(eval_batches=run['count'])
    if launches != want:
      raise AssertionError(
          f'export phase, batcher: launches {launches} over {run["count"]} '
          f'dispatches, expected {want}')
    tally(launches)
    end = compiles.value
    version = batcher.model_version
    served_key = batcher.current_executor().program_key
    report = batcher.report()
    dispatch_ms = metrics_lib.histogram('serving/dispatch_ms').snapshot()
    lone = batcher.submit(requests[0]).result(timeout=60.0)['q_predicted']
    parts = dispatch_parts(exported, batcher.current_executor(), requests)
    if writer.wait(timeout=60) != 0:
      raise AssertionError(f'export writer: exit {writer.returncode}:\n'
                           f'{(root / "writer.err").read_text()[-3000:]}')
  finally:
    batcher.close()
    if writer.poll() is None:
      writer.kill()
      writer.wait()
  want = other.predict(requests[0])['q_predicted']
  if (errors or run['swapped'] < 1 or version != 1 or end != warm or
      served_key != key or exported.stateless_serving_fn().program_key != key
      or not np.array_equal(lone.view(np.int32), want.view(np.int32))):
    raise AssertionError(
        f'batcher: errors {errors[:3]} ({len(errors)}), swaps '
        f'{run["swapped"]}, version {version}, bucket_compiles {warm} -> '
        f'{end}, program key {key} -> {served_key}, q after the swap {lone} '
        f'against {want}')
  seconds = run['seconds']
  latencies = [ms for _, ms in done]
  steady = [ms for t, ms in done if t < run['swap_begin']]
  swapping = [ms for t, ms in done
              if run['swap_begin'] <= t <= run['adopted_at']]
  p50, p99 = np.percentile(latencies, [50, 99])
  s50, s99 = np.percentile(steady, [50, 99])
  w99 = np.percentile(swapping, 99) if swapping else float('nan')
  log(f'export: DynamicBatcher(max_batch={BATCHER_MAX_BATCH}) over the '
      f'exported predictor, {BATCHER_CLIENTS} clients x {BATCHER_EXAMPLES} '
      f'examples a request, {seconds:.2f} s: {len(done)} requests, '
      f'{len(done) / seconds:.1f} requests/s, '
      f'{BATCHER_EXAMPLES * len(done) / seconds:.1f} examples/s, latency '
      f'p50 {p50:.2f} ms p99 {p99:.2f} ms (client clock; the whole window, '
      f'the swap included); before version 2 was written '
      f'({run["steady_s"]:.2f} s, {len(steady)} requests, '
      f'{BATCHER_EXAMPLES * len(steady) / run["steady_s"]:.1f} examples/s) '
      f'p50 {s50:.2f} ms p99 {s99:.2f} ms; from the writer\'s signal to the '
      f'adoption {len(swapping)} requests, p99 {w99:.2f} ms; '
      f'{run["count"]} dispatches (mean '
      f'batch {report["batch_size"]["mean"]:.1f}, dispatch '
      f'{dispatch_ms["mean"]:.2f} ms mean, {dispatch_ms["max"]:.2f} max: '
      f'assembly to outputs on the host), 0 failed; launches '
      f'{ {k: v for k, v in launches.items() if v} } on {card}')
  log(f'export: serving/bucket_compiles {warm} after warm-up of buckets '
      f'{list(batcher.buckets)} ({start_ms:.1f} ms), {end} at the end; '
      f'version 2 (other weights) exported under load by another process '
      f'at {BATCHER_SWAP_AT:.1f} s (its export {run["writer_export_s"]:.2f} '
      f's, committed {run["export_s"]:.2f} s after the signal), adopted by '
      f'{run["adopted"]:.2f} s, serving/model_swaps +{run["swapped"]}, the '
      f'program reused (program key {key[0]} {key[1][:12]}...), q after the '
      f'swap bit for bit the new weights\' eager q on {card}')
  log(f'export: one dispatch of {BATCHER_MAX_BATCH} examples alone, median '
      f'of 5 (host clock, synchronised): concatenate '
      f'{parts["concatenate"]:.2f} ms, pageable upload {parts["upload"]:.2f} '
      f'ms ({parts["upload_mb"]:.1f} MB), program {parts["program"]:.2f} ms, '
      f'outputs to the host {parts["download"]:.2f} ms; the executor\'s '
      f'execute {parts["execute"]:.2f} ms on {card}')


def dispatch_parts(exported, executor, requests):
  """Median host ms of one full dispatch's parts, timed one at a time."""
  serving = exported.stateless_serving_fn()
  times = collections.defaultdict(list)
  for _ in range(5):
    ms, batch = synced_ms(lambda: {
        k: np.concatenate([r[k] for r in requests]) for k in requests[0]})
    times['concatenate'].append(ms)
    ms, device = synced_ms(lambda: {
        k: torch.from_numpy(v).to(exported.device) for k, v in batch.items()})
    times['upload'].append(ms)
    ms, outputs = synced_ms(lambda: serving.fn(serving.params, device))
    times['program'].append(ms)
    ms, _ = synced_ms(lambda: {k: v.cpu().numpy()
                               for k, v in outputs.items()})
    times['download'].append(ms)
    ms, _ = synced_ms(lambda: executor.execute(batch, BATCHER_MAX_BATCH))
    times['execute'].append(ms)
  parts = {name: float(np.median(v)) for name, v in times.items()}
  parts['upload_mb'] = sum(v.nbytes for v in batch.values()) / 1e6
  return parts


# The HTTP serving path: run_serving replicas in router mode serve the
# exported critic over the JSON wire, driven by the port's load generator
# from this process; a second replica pages two critics under a byte
# budget; run_balancer fronts both while one replica drains on SIGTERM and
# comes back on its port.
HTTP_MAX_BATCH = 8
HTTP_CLIENTS = 4
# Cut from 12 s, 20 s and 6 rounds when the exported-models and
# quantized-serving phases joined the run, to keep it inside its limit.
HTTP_CLOSED_SECONDS = 6.0
HTTP_OPEN_SECONDS = 6.0
HTTP_TRACE_ROUNDS = 2  # untraced and traced slices, the order alternated
HTTP_TRACE_SLICE_SECONDS = 1.5
HTTP_ALTERNATIONS = 6  # named requests, the two critics in turn
HTTP_BUDGET_CRITICS = 1.5  # the paging replica's budget, in critics
HTTP_DECODES = 5

# Runs the serving binary's main unchanged and prints, as its last stdout
# line on exit, the kernel launches after the server started (the counters
# are zeroed there), the plain versions' calls over the whole process, the
# dispatches, the bucket warm-ups and the page-in times.
SERVE_WRAPPER = '''
import json, sys
import torch
from tensor2robot_tpu_torch.bin import run_serving
from tensor2robot_tpu_torch.observability import metrics
from tensor2robot_tpu_torch.ops import conv_s2d, pool
from tensor2robot_tpu_torch.serving import server
if torch.cuda.is_available():
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.benchmark = False
plain = {'pool': 0, 'conv': 0}
def count_calls(module, name, key):
  fn = getattr(module, name)
  def counted(*args, **kwargs):
    plain[key] += 1
    return fn(*args, **kwargs)
  setattr(module, name, counted)
count_calls(pool, 'plain_max_pool_argmax', 'pool')
count_calls(conv_s2d, 'plain_conv2d', 'conv')
def sync():
  if torch.cuda.is_available():
    torch.cuda.synchronize()
def dispatches():
  return sum(v for k, v in metrics.snapshot('serving/').items()
             if k.endswith('/dispatches'))
def compiles():
  return metrics.counter('serving/bucket_compiles').value
warm = {}
start = server.ServingServer.start
def started(self):
  out = start(self)
  sync()
  warm.update(pool_fwd=pool.pool_fwd.launches,
              conv_s2d_fwd=conv_s2d.conv_s2d_fwd.launches,
              compiles=compiles(), dispatches=dispatches())
  pool.pool_fwd.launches = 0
  conv_s2d.conv_s2d_fwd.launches = 0
  conv_s2d.conv_s2d_fwd.tensor_core_launches = 0
  return out
server.ServingServer.start = started
code = run_serving.main(sys.argv[1:])
sync()
print(json.dumps({
    'exit': code, 'warm': warm, 'pool_fwd': pool.pool_fwd.launches,
    'conv_s2d_fwd': conv_s2d.conv_s2d_fwd.launches,
    'conv_s2d_fwd_tensor_core': conv_s2d.conv_s2d_fwd.tensor_core_launches,
    'plain': plain, 'dispatches': dispatches() - warm.get('dispatches', 0),
    'compiles': compiles(),
    'page_ins': metrics.counter('serving/page_ins').value,
    'page_in_ms': metrics.histogram('serving/page_in_ms').snapshot()}),
    flush=True)
run_serving.exit_without_finalizing(code)
'''


class Replica:
  """One ``run_serving`` process under SERVE_WRAPPER (or the balancer
  binary), its stderr in ``log``; ``ready`` is its ready-line document."""

  def __init__(self, args, log, device, wrapped=True):
    repo = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ)
    if device == 'cuda':
      env['T2R_FORCE_PALLAS_KERNELS'] = '1'
    head = (['-c', SERVE_WRAPPER] if wrapped else
            ['-m', 'tensor2robot_tpu_torch.bin.run_balancer'])
    with open(log, 'a') as err:
      self.process = subprocess.Popen(
          [sys.executable] + head + [str(a) for a in args], cwd=repo,
          stdout=subprocess.PIPE, stderr=err, text=True, env=env)
    self.log = log
    self.ready = None

  def wait_ready(self):
    line = self.process.stdout.readline()
    if not line:
      self.process.wait(timeout=60)
      raise AssertionError(f'replica exited {self.process.returncode}:\n'
                           f'{pathlib.Path(self.log).read_text()[-3000:]}')
    self.ready = json.loads(line)
    return self

  @property
  def port(self):
    return self.ready['port']

  def stop(self):
    """SIGTERM; (seconds to exit, the last stdout document or None)."""
    begin = time.perf_counter()
    self.process.send_signal(signal.SIGTERM)
    out, _ = self.process.communicate(timeout=120)
    seconds = time.perf_counter() - begin
    if self.process.returncode != 0:
      raise AssertionError(f'exit {self.process.returncode} after SIGTERM:\n'
                           f'{pathlib.Path(self.log).read_text()[-3000:]}')
    lines = out.strip().splitlines()
    return seconds, (json.loads(lines[-1]) if lines else None)

  def kill(self):
    if self.process.poll() is None:
      self.process.kill()
    self.process.wait(timeout=60)


def http_call(port, path, body=None, headers=None):
  """(status, headers, JSON body) on a fresh connection (GET without a
  body)."""
  conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
  try:
    conn.request('GET' if body is None else 'POST', path, body=body,
                 headers=dict(headers or {}))
    response = conn.getresponse()
    return (response.status, dict(response.getheaders()),
            json.loads(response.read() or b'{}'))
  finally:
    conn.close()


def wait_for(predicate, seconds):
  deadline = time.perf_counter() + seconds
  while time.perf_counter() < deadline:
    if predicate():
      return True
    time.sleep(0.05)
  return predicate()


def http_replica_launches(name, doc):
  """A replica's launches after its start, held to 3 pool_fwd and 1
  conv_s2d_fwd (on the tensor cores) a dispatch, with no plain-version
  call over its whole life."""
  count = doc['dispatches']
  want = path_launches(eval_batches=count)
  got = {key: doc.get(key, 0) for key in want}
  if got != want or doc['plain'] != {'pool': 0, 'conv': 0} or count < 1:
    raise AssertionError(f'HTTP phase, replica {name}: launches {got} and '
                         f'plain calls {doc["plain"]} over {count} '
                         f'dispatches, expected {want} and none')
  return got


def tracing_overhead(device, clients=8):
  """Full-sample request tracing's cost to the batcher: HTTP_TRACE_ROUNDS
  rounds of two slices, one on a plane untraced and one on a plane with
  ``request_trace_sample=1.0`` (the flight ring's lifecycle events for
  every request), the order alternated each round, 8 in-process clients
  over the mock model. Returns each round's (untraced, traced)
  examples/s."""
  predictor = CheckpointPredictor(MockT2RModel(), device=device)
  predictor.init_randomly(torch.Generator().manual_seed(0))
  features = {'measured_position': np.full((1, 2), 0.5, np.float32)}
  planes = [DynamicBatcher(predictor, max_batch=64, batch_deadline_ms=0.2,
                           request_trace_sample=sample, register_report=False,
                           metrics_prefix=f'serving/trace_cost_{name}')
            for name, sample in (('untraced', 0.0), ('traced', 1.0))]
  rounds = []
  with planes[0], planes[1]:
    for i in range(HTTP_TRACE_ROUNDS):
      rates = {}
      for j in ((0, 1) if i % 2 == 0 else (1, 0)):
        rates[j] = loadgen.run_load(
            loadgen.inproc_submit_fn(planes[j]), lambda c: features,
            num_clients=clients,
            duration_secs=HTTP_TRACE_SLICE_SECONDS).actions_per_sec
      rounds.append((rates[0], rates[1]))
  return rounds


def timed_submit(submit, latencies):
  """``submit`` with each call's ms on the client's clock appended to
  ``latencies``."""

  def call(body):
    start = time.perf_counter()
    out = submit(body)
    latencies.append(1e3 * (time.perf_counter() - start))
    return out

  return call


def latency_line(latencies):
  values = np.asarray(latencies)
  return (f'p50 {np.percentile(values, 50):.1f} ms, p99 '
          f'{np.percentile(values, 99):.1f} ms, max {values.max():.1f} ms '
          f'over {values.size} requests')


def phase_http_serving(seed, card, device='cuda', model=None):
  """The exported critic served over HTTP at full width by ``run_serving``
  replicas, behind ``run_balancer``, under deterministic cuDNN (restored
  after the phase); files under a temporary directory below
  ``chiprun_out/``, removed at the end. Returns the replicas' launch
  counts."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='http_phase_', dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        _dispatch.force_kernels(device == 'cuda'):
      return http_serving_paths(seed, card, device, model, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def http_serving_paths(seed, card, device, model, root):
  begin = time.perf_counter()
  model = model or GraspingModelWrapper(device_type='gpu',
                                        kernel_policy='pool_conv')
  for name, weights_seed in (('critic', seed), ('other', seed + 1)):
    # Spread weights: a fresh critic scores every pair near 0.5, and the
    # bit checks below must see two critics that answer apart.
    predictor = CheckpointPredictor(model, device=device)
    predictor.load_state_dict(spread_weights(
        model.create_module(), torch.Generator().manual_seed(weights_seed)))
    export_version(model, predictor.network.state_dict(), 0, root / name, 1)
  exported = ExportedModelPredictor(str(root / 'critic'), device=device)
  if not exported.restore():
    raise AssertionError('the exported critic did not load')
  critic_bytes = sum(v.numel() * v.element_size() for v in
                     exported.stateless_serving_fn().params.values())
  common = ['--device', device, '--max-batch', HTTP_MAX_BATCH,
            '--batch-deadline-ms', 5, '--reload-interval-secs', 0]
  serving_a = ['--model', f'critic={root / "critic"}'] + common
  paging = (['--model', f'critic={root / "critic"}',
             '--model', f'other={root / "other"}', '--hbm-budget-mb',
             HTTP_BUDGET_CRITICS * critic_bytes / 1e6] + common)
  live = []
  try:
    start_s = time.perf_counter()
    live += [Replica(serving_a + ['--port', 0], root / 'a.log', device),
             Replica(paging + ['--port', 0], root / 'b.log', device)]
    replica_a, replica_b = (r.wait_ready() for r in live)
    start_s = time.perf_counter() - start_s

    # 1. One request of one frame and one grasp, bit for bit the
    # in-process exported predictor's q at batch 1.
    one = serving_pairs(model, seed + 11, 1)
    body = loadgen.encode_request(one)
    decode_ms, encode_ms = [], []
    for _ in range(HTTP_DECODES):
      ms, _ = synced_ms(lambda: loadgen.encode_request(one))
      encode_ms.append(ms)
      t0 = time.perf_counter()
      doc = json.loads(body)
      {k: np.asarray(v) for k, v in doc['features'].items()}
      decode_ms.append(1e3 * (time.perf_counter() - t0))
    want = exported.predict(one)['q_predicted']
    status, headers, reply = http_call(replica_a.port, '/v1/predict', body,
                                       {'X-Request-Id': 'chip-lone-1'})
    got = np.asarray(reply.get('outputs', {}).get('q_predicted'), np.float32)
    if (status != 200 or headers.get('X-Request-Id') != 'chip-lone-1' or
        reply['request_id'] != 'chip-lone-1' or
        not np.array_equal(got.view(np.int32), want.view(np.int32))):
      raise AssertionError(f'lone HTTP request: status {status}, headers '
                           f'{headers}, q {got} against in-process {want}')
    log(f'http: one {model.__class__.__name__} request over JSON '
        f'({len(body) / 1e6:.2f} MB body), q {got.tolist()} bit for bit the '
        f'in-process ExportedModelPredictor\'s at batch 1, X-Request-Id '
        f'echoed; replicas up {start_s:.1f} s after launch (imports, program '
        f'load, {len(default_buckets(HTTP_MAX_BATCH))} bucket warm-ups); '
        f'host ms in this process (median of {HTTP_DECODES}): json.loads + '
        f'np.asarray of the body {np.median(decode_ms):.1f} (min '
        f'{min(decode_ms):.1f}), its encoding {np.median(encode_ms):.1f} on '
        f'{card}')

    # 2. Closed loop, then open loop at half the closed-loop rate with half
    # the arrivals best-effort.
    bodies = [loadgen.encode_request(serving_pairs(model, seed + 12 + c, 1))
              for c in range(HTTP_CLIENTS)]
    closed_ms, probe_ms = [], []
    probing = threading.Event()

    def probe():
      # What a balancer's health probe waits for under this load.
      while not probing.wait(0.25):
        start = time.perf_counter()
        status = http_call(replica_a.port, '/healthz')[0]
        probe_ms.append(1e3 * (time.perf_counter() - start)
                        if status == 200 else float('inf'))

    prober = threading.Thread(target=probe, daemon=True)
    prober.start()
    try:
      closed = loadgen.run_load(
          timed_submit(loadgen.http_submit_fn('127.0.0.1', replica_a.port),
                       closed_ms),
          lambda c: bodies[c], num_clients=HTTP_CLIENTS,
          duration_secs=HTTP_CLOSED_SECONDS)
    finally:
      probing.set()
      prober.join(timeout=130)
    rate = 0.5 * closed.requests / closed.duration_s
    opened = loadgen.run_open_loop(
        loadgen.http_open_submit_fn('127.0.0.1', replica_a.port),
        lambda i: bodies[i % HTTP_CLIENTS], rate_rps=rate,
        duration_secs=HTTP_OPEN_SECONDS, workers=2 * HTTP_CLIENTS,
        seed=seed, best_effort_fraction=0.5, warmup_requests=0)
    if closed.errors or opened.errors or not closed.requests:
      raise AssertionError(f'HTTP load: closed {closed}, open {opened}')
    log(f'http: closed loop, {HTTP_CLIENTS} clients x 1 example, '
        f'{closed.duration_s:.2f} s: {closed.requests} requests, '
        f'{closed.requests / closed.duration_s:.2f} requests/s = '
        f'{closed.actions_per_sec:.2f} examples/s, latency '
        f'{latency_line(closed_ms)} (client clock), {closed.errors} errors, '
        f'/healthz meanwhile p50 {np.median(probe_ms):.1f} ms max '
        f'{max(probe_ms):.1f} ms over {len(probe_ms)} probes; '
        f'open loop (Poisson) at {rate:.2f} requests/s offered for '
        f'{HTTP_OPEN_SECONDS:.0f} s, half best-effort: {opened.arrivals} '
        f'arrivals, {opened.achieved_rps:.2f} ok/s, p50 '
        f'{opened.latency_ms_p50:.1f} ms p99 {opened.latency_ms_p99:.1f} ms '
        f'max {opened.latency_ms_max:.1f} ms from the scheduled arrival, '
        f'{opened.shed} shed, {opened.errors} errors, classes '
        f'{opened.classes}; the replica\'s decoder processes '
        f'{wire.DECODERS} at most, for bodies of {wire.MIN_BYTES} bytes or '
        f'more, on {card}')

    # 3. Router paging: the two critics in turns under a budget of 1.5.
    before = http_call(replica_b.port, '/statz')[2]
    other = ExportedModelPredictor(str(root / 'other'), device=device)
    if not other.restore():
      raise AssertionError('the second exported critic did not load')
    expected = {'critic': got.tolist(),
                'other': other.predict(one)['q_predicted'].tolist()}
    answers = {}
    for i in range(HTTP_ALTERNATIONS):
      name = ('critic', 'other')[i % 2]
      status, _, reply = http_call(replica_b.port,
                                   f'/v1/models/{name}/predict', body)
      if status != 200:
        raise AssertionError(f'paging replica, {name}: {status} {reply}')
      answers.setdefault(name, reply['outputs']['q_predicted'])
    after = http_call(replica_b.port, '/statz')[2]
    compiles = [doc['models']['critic']['bucket_compiles']
                for doc in (before, after)]
    if (after['page_ins'] <= before['page_ins'] or after['page_ins'] < 1 or
        compiles[0] != compiles[1] or len(after['models_resident']) != 1 or
        answers != expected or answers['critic'] == answers['other']):
      raise AssertionError(f'paging replica: page_ins {before["page_ins"]} '
                           f'-> {after["page_ins"]}, bucket_compiles '
                           f'{compiles}, resident {after["models_resident"]},'
                           f' answers {answers}')
    log(f'http: router replica with 2 critics of {critic_bytes / 1e6:.2f} MB '
        f'under --hbm-budget-mb {HTTP_BUDGET_CRITICS * critic_bytes / 1e6:.2f}'
        f': {HTTP_ALTERNATIONS} named requests in turns, page_ins '
        f'{before["page_ins"]} -> {after["page_ins"]}, page_outs '
        f'{before["page_outs"]} -> {after["page_outs"]}, resident '
        f'{after["models_resident"]}, serving/bucket_compiles {compiles[0]} '
        f'-> {compiles[1]}; each critic\'s q over the router bit for bit its '
        f'in-process ExportedModelPredictor\'s on {card}')

    # 4. The balancer over both, at run_balancer's default probe interval,
    # probe timeout and ejection; replica A drained by SIGTERM under
    # traffic, then restarted on its port.
    balancer = Replica(['--backend', f'127.0.0.1:{replica_a.port}',
                        '--backend', f'127.0.0.1:{replica_b.port}', '--port',
                        0], root / 'lb.log', device, wrapped=False)
    live.append(balancer)
    balancer.wait_ready()
    if http_call(balancer.port, '/statz')[2]['backends_healthy'] != 2:
      raise AssertionError('balancer: both replicas should be healthy')
    submit = loadgen.http_submit_fn('127.0.0.1', balancer.port)
    done, failures = [], []
    stop = threading.Event()

    def client(c):
      while not stop.is_set():
        try:
          submit(bodies[c])
          done.append(c)
        except Exception as e:  # pylint: disable=broad-except
          failures.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(2)]
    for thread in threads:
      thread.start()
    try:
      if not wait_for(lambda: len(done) >= 4, 60):
        raise AssertionError(f'balancer: no traffic ({failures[:3]})')
      drain_s, doc_a = replica_a.stop()
      live.remove(replica_a)

      def healthy():
        return http_call(balancer.port, '/statz')[2]['backends_healthy']

      ejected = wait_for(lambda: healthy() == 1, 15)
      served = len(done)
      wait_for(lambda: len(done) >= served + 2, 60)
      restart_s = time.perf_counter()
      replica_a2 = Replica(serving_a + ['--port', replica_a.port],
                           root / 'a.log', device)
      live.append(replica_a2)
      replica_a2.wait_ready()
      readmitted = wait_for(lambda: healthy() == 2, 15)
      restart_s = time.perf_counter() - restart_s
      served = len(done)
      wait_for(lambda: len(done) >= served + 3, 60)
    finally:
      stop.set()
      for thread in threads:
        thread.join(timeout=120)
    report = http_call(balancer.port, '/statz')[2]
    if (failures or not ejected or not readmitted or
        report['ejections'] < 1 or report['readmissions'] < 1 or
        replica_a2.port != replica_a.port):
      raise AssertionError(f'balancer drill: {len(failures)} failed '
                           f'({failures[:3]}), ejected {ejected}, readmitted '
                           f'{readmitted}, report {report}')
    docs = {'a': doc_a}
    for name, replica in (('b', replica_b), ('a2', replica_a2),
                          ('balancer', balancer)):
      docs[name] = replica.stop()[1]
      live.remove(replica)
    log(f'http: run_balancer over both replicas at its defaults (probe '
        f'every {report["health_interval_secs"]} s, eject after '
        f'{report["eject_after"]} failed), 2 closed-loop clients: '
        f'{len(done)} requests, 0 failed; replica A took SIGTERM under '
        f'traffic, drained and exited 0 in {drain_s:.2f} s, ejected '
        f'(ejections {report["ejections"]}); restarted on port '
        f'{replica_a.port} and readmitted {restart_s:.1f} s after its launch '
        f'(readmissions {report["readmissions"]}, retries '
        f'{report["retries"]}, transport errors '
        f'{report["transport_errors"]}) on {card}')
  finally:
    for replica in live:
      replica.kill()

  # 5. Full-sample tracing's cost, with no replica left on the host.
  rounds = tracing_overhead(device)
  ratios = [traced / untraced for untraced, traced in rounds]
  log(f'http: full-sample request tracing (request_trace_sample=1.0, the '
      f'flight ring\'s 4 lifecycle events a request) in the batcher, 8 '
      f'in-process clients over the mock model, {HTTP_TRACE_ROUNDS} rounds '
      f'of {HTTP_TRACE_SLICE_SECONDS} s slices, (untraced, traced) '
      f'examples/s: {[(round(u, 1), round(t, 1)) for u, t in rounds]}; '
      f'traced/untraced {[round(r, 4) for r in ratios]}, median '
      f'{np.median(ratios):.4f}, spread {max(ratios) - min(ratios):.4f} on '
      f'{card}')

  # 6. The replicas' launches: 3 pool_fwd and 1 conv_s2d_fwd a dispatch.
  total = path_launches()
  for name in ('a', 'b', 'a2'):
    doc = docs[name]
    if doc['compiles'] != doc['warm']['compiles']:
      raise AssertionError(f'replica {name}: serving/bucket_compiles '
                           f'{doc["warm"]["compiles"]} after warm-up, '
                           f'{doc["compiles"]} at exit')
    for key, value in http_replica_launches(name, doc).items():
      total[key] += value
  page_in = docs['b']['page_in_ms']
  log(f'http: replica launches after start, per replica (dispatches, '
      f'pool_fwd, conv_s2d_fwd): '
      f'{ {n: (docs[n]["dispatches"], docs[n]["pool_fwd"], docs[n]["conv_s2d_fwd"]) for n in ("a", "b", "a2")} }'
      f', plain-version calls 0; bucket warm-ups '
      f'{ {n: docs[n]["warm"]["compiles"] for n in ("a", "b", "a2")} }, flat '
      f'to exit; page-ins {docs["b"]["page_ins"]}, page_in_ms mean '
      f'{page_in.get("mean", 0.0):.2f} max {page_in.get("max", 0.0):.2f}; '
      f'phase {time.perf_counter() - begin:.1f} s on {card}')
  return total


# The record-fed QT-Opt path: shards of PNG frames (the card's host had no
# libjpeg header when probed, so JPEG decodes there through PIL, as the
# pose_env gate prints; ROADMAP queue 1 item 4).
RECORD_SHARDS = 4
RECORD_PER_SHARD = 48
RECORD_SHUFFLE = 64
RECORD_STEPS = 10
RECORD_BITS_STEPS = 8  # more than the ring's slots at its least depth
RECORD_RESUME = (4, 8)
RECORD_PROFILE_STEPS = 3


def write_record_shards(root, seed):
  """RECORD_SHARDS TFRecord shards of RECORD_PER_SHARD QT-Opt examples at
  the wrapper's in-specs: seeded uint8 frames as PNG (zlib level 1),
  actions and 0/1 rewards; each shard with its index sidecar. Returns the
  paths, the bytes written and the seconds taken."""
  pre = GraspingModelWrapper(device_type='gpu').preprocessor
  spec = dict(pre.get_in_feature_specification(ModeKeys.TRAIN).items())
  spec.update(pre.get_in_label_specification(ModeKeys.TRAIN).items())
  input_shape = spec['state/image'].shape
  rng = np.random.RandomState(seed + 11)
  values = [[{
      'state/image': rng.randint(0, 256, input_shape, dtype=np.uint8),
      'action/world_vector': rng.randn(3).astype(np.float32),
      'action/vertical_rotation': rng.randn(2).astype(np.float32),
      'reward': rng.randint(0, 2, (1,)).astype(np.float32),
  } for _ in range(RECORD_PER_SHARD)] for _ in range(RECORD_SHARDS)]
  start = time.perf_counter()

  def write(shard):
    path = str(root / f'qtopt-{shard:05d}-of-{RECORD_SHARDS:05d}.tfrecord')
    records.write_examples(path, [
        example_codec.encode_example(spec, value, png_level=1)
        for value in values[shard]])
    shard_index.write_index(path)
    return path

  with concurrent.futures.ThreadPoolExecutor(RECORD_SHARDS) as pool_:
    paths = list(pool_.map(write, range(RECORD_SHARDS)))
  seconds = time.perf_counter() - start
  return (paths, 'x'.join(map(str, input_shape)),
          sum(pathlib.Path(p).stat().st_size for p in paths), seconds)


def record_generator(paths, seed, **kwargs):
  """The record feed of the QT-Opt training path: batch 32, a 64-record
  shuffle buffer, the engine's ring of page-locked slots."""
  gen = input_generators.NativeRecordInputGenerator(
      ','.join(paths), batch_size=TRAIN_BATCH,
      shuffle_buffer_size=RECORD_SHUFFLE, seed=seed,
      reuse_batch_buffers=True, **kwargs)
  gen.set_specification_from_model(
      GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv'),
      ModeKeys.TRAIN)
  return gen


def phase_record_train(seed, card, synthetic_ms, profile):
  """QT-Opt trained from TFRecord shards at full width (see the module
  doc, phase 6b). Returns the launch counts of its training runs; with
  ``profile``, profiles record-fed steps while the shards still exist."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='record_phase_', dir=OUT_DIR))
  try:
    with _dispatch.force_kernels(True):
      return record_paths(seed, card, synthetic_ms, root, profile)
  finally:
    shutil.rmtree(root, ignore_errors=True)


class PoisonOnRelease:
  """A record iterator whose batch frames are overwritten in part the
  moment their ring slot is released: the last row of every frame is
  inverted, as a worker that takes the slot at once would overwrite it.
  A slot released before its upload has ended uploads poisoned frames,
  so a bit check against the untouched batches sees the early release
  whatever the workers' timing."""

  def __init__(self, inner):
    self._inner = inner
    self._leased = collections.deque()
    self.poisoned = 0

  def __iter__(self):
    return self

  def __next__(self):
    batch = next(self._inner)
    self._leased.append(batch[0]['state/image'])
    return batch

  def release(self):
    frames = self._leased.popleft()
    np.invert(frames[:, -1], out=frames[:, -1])
    self.poisoned += 1
    self._inner.release()

  def close(self):
    self._inner.close()


class EarlyReleaseUploader(BatchUploader):
  """The control of the release check: gives a batch's ring slot back as
  soon as its upload is issued, before the copy has ended."""

  def stage(self, batch, release=None):
    staged = super().stage(batch)
    if release is not None:
      release()
    return staged


def record_paths(seed, card, synthetic_ms, root, profile):
  def model():
    return GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')

  paths, shape, nbytes, write_s = write_record_shards(root, seed)
  log(f'record: {RECORD_SHARDS} shards of {RECORD_PER_SHARD} examples '
      f'({shape} uint8 PNG frames, zlib level 1), {nbytes / 1e6:.1f} MB, '
      f'written with index sidecars in {write_s:.2f} s')
  total = path_launches()

  def counted(what, fn, steps, keep=True):
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counters()
    want = path_launches(steps=steps)
    if launches != want:
      raise AssertionError(f'record phase, {what}: launches {launches}, '
                           f'expected {want}')
    if keep:
      for name in total:
        total[name] += launches[name]
    return out

  # 1. Training from the shards, on one trainer, in blocks of a warm-up
  # step and RECORD_STEPS timed ones, the feeds taking turns twice so that
  # the host's drift falls on each alike: the record feed (the engine's
  # workers, 8 decode threads each); the same batches decoded beforehand
  # into pageable host memory (no feed threads, as the synthetic paths);
  # the record feed with one decode thread a worker, so the feed's threads
  # and the train loop together take fewer threads than the host's cpus.
  gen = record_generator(paths, seed)
  lean = record_generator(paths, seed, decode_workers=1)
  plain = record_generator(paths, seed, engine_workers=0).create_iterator(
      ModeKeys.TRAIN)
  try:
    decoded = list(itertools.islice(plain, 1 + RECORD_STEPS))
  finally:
    plain.close()
  timed = _Recorder()
  trainer = Trainer(model(), TrainerConfig(max_train_steps=0,
                                           log_interval_steps=0, seed=seed),
                    callbacks=[timed])
  feeds = {
      'record-fed, 8 decode threads a worker':
          lambda: gen.create_iterator(ModeKeys.TRAIN),
      'pre-decoded pageable batches, no feed threads':
          lambda: iter(decoded),
      'record-fed, 1 decode thread a worker':
          lambda: lean.create_iterator(ModeKeys.TRAIN),
  }
  block_ms = {name: [] for name in feeds}
  for name, make in list(feeds.items()) * 2:
    it = make()
    try:
      if name.startswith('record') and not it.reuse_buffers:
        raise AssertionError('the record feed did not take the ring of slots')
      start = trainer.step
      trainer.config.max_train_steps = start + 1
      counted(f'{name}: warm-up step', lambda: trainer.train(it), 1)
      trainer.config.max_train_steps = start + 1 + RECORD_STEPS
      scalars = counted(f'{name}: {RECORD_STEPS} steps',
                        lambda: trainer.train(it), RECORD_STEPS)
    finally:
      if hasattr(it, 'close'):
        it.close()
    if trainer.step != start + 1 + RECORD_STEPS or not all(
        np.isfinite(v) for v in scalars.values()):
      raise AssertionError(f'{name}: step {trainer.step}, {scalars}')
    block_ms[name].append([timed.step_ms[s] for s in range(
        start + 3, start + 2 + RECORD_STEPS)])
  decision = gen.last_decision
  log(f'record: steps from the shards at batch {TRAIN_BATCH}, launches '
      '3/3/1/1 a step (pool_fwd/pool_bwd/conv_s2d_fwd/conv_s2d_dw), loss '
      f'{scalars["loss"]:.4f}; engine {decision.num_workers} workers, a ring '
      f'of {decision.ring_depth} slots ('
      f'{"page-locked" if gen.pin_memory else "pageable"}), '
      f'{decision.cpus} cpus')
  for name, blocks in block_ms.items():
    log(f'record: ms/step, {name}: median of steps 3-{1 + RECORD_STEPS} of '
        f'two blocks {np.median(blocks[0]):.3f} and {np.median(blocks[1]):.3f}'
        f' (each {[np.round(b, 3).tolist() for b in blocks]}; host clock, '
        f'synchronised), on {card}')
  record_ms = np.median(block_ms['record-fed, 8 decode threads a worker'])
  log(f'record: record-fed ms/step {record_ms:.3f} (median of both blocks) '
      f'against the synthetic-fed training path\'s {synthetic_ms:.3f} in '
      f'this run, on {card}')
  if profile:
    it = gen.create_iterator(ModeKeys.TRAIN)
    try:
      trainer.config.max_train_steps = trainer.step + 2
      trainer.train(it)  # the engine's ring fills
      phase_profile_records(trainer, it, card)
    finally:
      it.close()

  upload_timing(decoded[0][0]['state/image'], card)
  decode_timing(paths, gen, seed, decision, card)

  with cudnn_settings(deterministic=True, benchmark=False):
    # 2. Bits, upload: the record-fed state after RECORD_BITS_STEPS steps
    # equals the state after the same batches uploaded synchronously. The
    # ring has its least depth (workers + 1 slots), fewer than the steps,
    # so slots are reused within the run, and each slot's frames are
    # poisoned when it is released; the control releases each slot as soon
    # as its upload is issued and must differ.
    def record_fed(early):
      t = Trainer(model(), TrainerConfig(max_train_steps=RECORD_BITS_STEPS,
                                         log_interval_steps=0, seed=seed))
      if early:
        t._uploader = EarlyReleaseUploader(t._device)  # pylint: disable=protected-access
      bits_gen = record_generator(paths, seed, engine_ring_depth=1)
      it = PoisonOnRelease(bits_gen.create_iterator(ModeKeys.TRAIN))
      try:
        t.train(it)
      finally:
        it.close()
      ring = bits_gen.last_decision.ring_depth
      if ring >= RECORD_BITS_STEPS or it.poisoned != RECORD_BITS_STEPS:
        raise AssertionError(f'release check: a ring of {ring} slots over '
                             f'{RECORD_BITS_STEPS} steps, {it.poisoned} '
                             'slots released')
      return t, ring

    def synchronous():
      batches = [synchronous_upload(batch)
                 for batch in decoded[:RECORD_BITS_STEPS]]
      t = Trainer(model(), TrainerConfig(max_train_steps=RECORD_BITS_STEPS,
                                         log_interval_steps=0, seed=seed))
      t.train(iter(batches))
      return t

    fed, ring = counted('record-fed bits run', lambda: record_fed(False),
                        RECORD_BITS_STEPS)
    sync = counted('synchronous bits run', synchronous, RECORD_BITS_STEPS)
    sync_state = ckpt_lib.to_host(train_state.state_dict(sync.state))
    bad = payload_mismatches(
        ckpt_lib.to_host(train_state.state_dict(fed.state)), sync_state)
    if bad:
      raise AssertionError(f'record-fed state differs from the synchronously '
                           f'uploaded one at {bad[:8]} ({len(bad)} leaves)')
    early, _ = counted('early-release control', lambda: record_fed(True),
                       RECORD_BITS_STEPS, keep=False)
    control = payload_mismatches(
        ckpt_lib.to_host(train_state.state_dict(early.state)), sync_state)
    if not control:
      raise AssertionError('the early-release control trained the same state '
                           'as the synchronous upload: the bit check cannot '
                           'see a slot released before its copy ended')
    log(f'record: after {RECORD_BITS_STEPS} steps through a ring of {ring} '
        'slots, each poisoned at its release, the record-fed state '
        '(page-locked ring, non_blocking side-stream upload) equals bit for '
        'bit the state fed the same batches by a synchronous .to(\'cuda\') '
        f'(parameters, batch statistics, EMA, momentum, step; '
        f'{cudnn_flags()}); the control that releases each slot as its '
        f'upload is issued differs at {len(control)} leaves')

    # 3. Bits, resume: checkpoint_input_state stopped at 4, resumed in a
    # fresh Trainer to 8, equals the uninterrupted 8 steps.
    stop, end = RECORD_RESUME

    def run(model_dir, steps, recorder):
      return train_eval_model(
          model=model(), model_dir=str(model_dir),
          train_input_generator=record_generator(paths, seed),
          max_train_steps=steps, save_interval_steps=2,
          eval_interval_steps=0, log_interval_steps=0, seed=seed,
          checkpoint_input_state=True, callbacks=[recorder], device='cuda')

    straight, first, resumed = _Recorder(), _Recorder(), _Recorder()
    counted('input-state run, straight', lambda: run(
        root / 'straight', end, straight), end)
    counted('input-state run to the stop', lambda: run(
        root / 'resumed', stop, first), stop)
    counted('input-state run resumed', lambda: run(
        root / 'resumed', end, resumed), end - stop)
    bad = payload_mismatches(resumed.saved[end], straight.saved[end])
    if bad:
      raise AssertionError(f'resumed record-fed run differs at {bad[:8]} '
                           f'({len(bad)} leaves)')
    log(f'record: train_eval_model(checkpoint_input_state=True) stopped at '
        f'{stop} and resumed in a fresh Trainer to {end} equals the '
        f'uninterrupted {end} steps bit for bit')
  return total


def smooth_frames(shape, seed, count):
  """``count`` seeded camera-like uint8 frames: low-frequency colour
  gradients with mild noise, which zlib compresses (unlike uniform
  noise, which it stores)."""
  rng = np.random.RandomState(seed)
  h, w, c = shape
  y, x = np.mgrid[0:h, 0:w].astype(np.float32)
  frames = []
  for _ in range(count):
    freq = rng.uniform(0.004, 0.02, (c, 2))
    phase = rng.uniform(0, 2 * np.pi, c)
    base = np.stack([127 + 100 * np.sin(freq[k, 0] * y + freq[k, 1] * x +
                                        phase[k]) for k in range(c)], -1)
    frames.append(np.clip(base + rng.normal(0, 3, shape), 0, 255).astype(
        np.uint8))
  return frames


def decode_timing(paths, gen, seed, decision, card):
  """Host parse + decode of one batch of the cell's records, as one engine
  worker does it, and the PNG decode alone of a batch of the cell's frames
  against camera-like frames with every non-zero row filter, as a
  standard encoder's adaptive filtering writes them (8 decode threads,
  median of 5)."""
  parse_fn = native_io.make_native_parse_fn(
      gen.feature_spec, gen.label_spec, decode_workers=8)
  with native_io.NativeInterleaveReader(paths) as reader:
    raw = list(itertools.islice(reader, TRAIN_BATCH))

  def median_ms(fn):
    fn()
    times = []
    for _ in range(5):
      begin = time.perf_counter()
      fn()
      times.append(1e3 * (time.perf_counter() - begin))
    return np.median(times)

  log(f'record: host parse + PNG decode of one batch of {TRAIN_BATCH} '
      f'records {median_ms(lambda: parse_fn(raw)):.2f} ms (median of 5, 8 '
      f'decode threads, one engine worker\'s share); {decision.num_workers} '
      'engine workers decode different batches at once')
  shape = tuple(gen.feature_spec['state/image'].shape)
  rng = np.random.RandomState(seed + 11)
  noise = [rng.randint(0, 256, shape, dtype=np.uint8) for _ in range(8)]
  smooth = smooth_frames(shape, seed + 12, 8)
  out = np.empty((TRAIN_BATCH,) + shape, np.uint8)
  for label, frames, level, filters in (
      ('the cell\'s uniform noise, filter 0', noise, 1, 0),
      ('camera-like, filter 0', smooth, 6, 0),
      ('camera-like, filters 1-4 cycled over the rows', smooth, 6,
       (1, 2, 3, 4)),
      ('camera-like, Paeth on every row', smooth, 6, 4)):
    pngs = [image_codec.encode_png(frame, level, filters) for frame in frames]
    batch = [pngs[i % len(pngs)] for i in range(TRAIN_BATCH)]
    ms = median_ms(lambda b=batch: image_codec.decode_image_batch(
        b, shape, out=out, workers=8))
    if not all(np.array_equal(out[i], frames[i % len(frames)])
               for i in range(len(frames))):
      raise AssertionError(f'PNG decode of {label} differs from its frames')
    one_ms = median_ms(lambda png=pngs[0]: image_codec.decode_png(png))
    log(f'record: PNG decode of {TRAIN_BATCH} frames ({label}, zlib level '
        f'{level}, {sum(map(len, batch)) / TRAIN_BATCH / 1e6:.3f} MB a '
        f'frame) {ms:.2f} ms (median of 5, 8 decode threads), one frame on '
        f'one thread {one_ms:.2f} ms, on {card}\'s host')


def synchronous_upload(batch):
  """A host batch on the card by a plain synchronous ``.to('cuda')``."""
  return tuple({k: torch.from_numpy(np.array(v)).to('cuda')
                for k, v in part.items()} for part in batch)


def upload_timing(frames, card):
  """One batch's frames uploaded from page-locked memory with
  ``non_blocking`` against a pageable copy (CUDA events, after an L2
  flush)."""
  pinned = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
  pinned.numpy()[...] = frames
  pageable = torch.from_numpy(np.array(frames))
  pinned_ms = cuda_ms(lambda: pinned.to('cuda', non_blocking=True), iters=10)
  pageable_ms = cuda_ms(lambda: pageable.to('cuda'), iters=10)
  log(f'record: upload of one batch\'s frames ({frames.nbytes / 1e6:.1f} MB): '
      f'pinned non_blocking {pinned_ms:.3f} ms, pageable {pageable_ms:.3f} ms '
      f'(CUDA events, mean of 10) on {card}')


def phase_profile_records(trainer, stream, card, label='records'):
  """Device time and the compute stream's idle share over record-fed
  steps (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile

  trainer.config.max_train_steps = trainer.step + RECORD_PROFILE_STEPS
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    begin = time.perf_counter()
    with _dispatch.force_kernels(True):
      trainer.train(stream)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - begin)
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=40)
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / f'chip_smoke_profile_{label}.txt').write_text(table)
  upload_us = device_time_us(averages, 'Memcpy HtoD')
  kernel_us = device_time_us(averages) - upload_us
  steps = RECORD_PROFILE_STEPS
  log(f'profile {label}: {RECORD_PROFILE_STEPS} record-fed steps, '
      f'{kernel_us / 1e3 / steps:.3f} ms of device time a step outside the '
      f'upload, {upload_us / 1e3 / steps:.3f} ms of host-to-device copy a '
      f'step (side stream), {wall_ms / steps:.3f} ms a step on the host clock;'
      f' the device idle share {1 - kernel_us / 1e3 / wall_ms:.3f} (1 - '
      f'device time outside the upload / wall time) on {card}; table in '
      f'chiprun_out/chip_smoke_profile_{label}.txt')
  log_activity_row(f' {label}', averages)


def phase_dx_path(generator):
  """Full-width conv1 and the odd geometry (ODD_CONV_*) with an input that
  requires a gradient, in bfloat16 and in float32 (TF32 off for the plain
  version): each backward launches dx once (bfloat16 on the tensor cores,
  float32 with the forward and dW on the CUDA cores), within its band of
  the plain version, and a second backward gives the same dx bit for bit.
  Returns the launch counts of a bfloat16 backward at conv1, the main
  path's, and the float32 runs' CUDA-core launches (one backward of each
  geometry)."""
  launches = None
  cuda_core = {'conv_s2d_fwd': 0, 'conv_s2d_dw': 0, 'conv_s2d_dx': 0}
  for label, xshape, wshape, strides, dtype in (
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.bfloat16),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.bfloat16),
      ('conv1', TRAIN_CONV1_X, CONV1_W, (2, 2), torch.float32),
      ('odd', ODD_CONV_X, ODD_CONV_W, ODD_CONV_STRIDES, torch.float32)):
    x = torch.rand(xshape, generator=generator, device='cuda').to(
        dtype).requires_grad_()
    w = (0.1 * torch.randn(wshape, generator=generator, device='cuda')).to(
        dtype).requires_grad_()
    pads = conv_s2d.resolve_padding('SAME', wshape[:2], strides, xshape[1:3])
    g = torch.randn(conv_out_shape(xshape, wshape, strides, pads),
                    generator=generator, device='cuda').to(dtype)
    grads = []
    for _ in range(2):
      x.grad = w.grad = None
      with _dispatch.force_kernels(True):
        zero_counters()
        conv_s2d.conv2d(x, w, strides, 'SAME').backward(g)
        torch.cuda.synchronize()
        counts = read_counters()
      grads.append(x.grad)
    tensor_core = int(dtype == torch.bfloat16)
    want = {**NO_QTOPT, 'conv_s2d_fwd': 1,
            'conv_s2d_fwd_tensor_core': tensor_core, 'conv_s2d_dw': 1,
            'conv_s2d_dw_tensor_core': tensor_core, 'conv_s2d_dx': 1,
            'conv_s2d_dx_tensor_core': tensor_core, **NO_FLASH, **NO_FUSED}
    if counts != want:
      raise AssertionError(f'dx path {label} {dtype} launches {counts}, '
                           f'expected {want}')
    if not torch.equal(grads[0], grads[1]):
      raise AssertionError(f'dx path {label} {dtype}: dx differs between '
                           'two runs')
    with tf32_off():
      plain = conv_s2d.plain_conv2d_dx(g, w.detach(), xshape, strides, pads)
    err, ok = within(grads[0], plain, 2.0**-7 if tensor_core else 0.0, 1e-5)
    if not ok:
      raise AssertionError(f'dx path {label} {dtype}: dx outside its band, '
                           f'max abs err {err}')
    log(f'dx path: {label} {xshape} {str(dtype)[6:]} with an input that '
        f'needs a gradient: launches {counts}; dx max abs err {err:.3e} '
        'against the plain version; twice: bitwise equal')
    if tensor_core:
      launches = launches or counts
    else:
      for name, count in cuda_core_launches(counts).items():
        cuda_core[name] += count
    del x, w, g, grads, plain
  return launches, cuda_core


def float64_gradients(state, batch, seed):
  """The step's loss and gradients in float64 on the CPU, stock ops: the
  trainer's weights, and its crop (the same draws from a generator seeded
  as the trainer's) of the same batch, on the same float32 image."""
  model = GraspingModelWrapper(device_type='cpu', kernel_policy='none')
  network = networks.Grasping44(dtype=None, kernel_policy='none')
  generator = torch.Generator().manual_seed(seed)
  model.init_network(network, generator)
  network.load_state_dict(state)
  network = network.double().train()
  features, labels = batch
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, ModeKeys.TRAIN,
      generator)
  _, ends = network(features['state/image'].double(),
                    model.grasp_params(features).double())
  q = torch.clamp(ends['predictions'], 1e-7, 1 - 1e-7)
  reward = labels['reward'].double().reshape(q.shape)
  loss = -torch.mean(reward * torch.log(q) + (1 - reward) * torch.log(1 - q))
  loss.backward()
  return float(loss.detach()), {k: p.grad for k, p in network.named_parameters()}


@contextlib.contextmanager
def cudnn_settings(**flags):
  """``torch.backends.cudnn`` flags set within the context, restored after
  it."""
  cudnn = torch.backends.cudnn
  saved = {name: getattr(cudnn, name) for name in flags}
  for name, value in flags.items():
    setattr(cudnn, name, value)
  try:
    yield
  finally:
    for name, value in saved.items():
      setattr(cudnn, name, value)


def cudnn_flags():
  cudnn = torch.backends.cudnn
  return (f'cuDNN {cudnn.version()}: enabled={cudnn.enabled}, '
          f'deterministic={cudnn.deterministic}, benchmark={cudnn.benchmark}, '
          f'allow_tf32={cudnn.allow_tf32}; cuBLAS allow_tf32='
          f'{torch.backends.cuda.matmul.allow_tf32}')


def reference_gradients(state, batch, seed, device, kernel_policy):
  """(loss, {leaf: float64 CPU copy of the gradient}) of one float32
  training step of Grasping44 from ``state`` on ``device`` under
  ``kernel_policy``. A CUDA step under 'none' leaves pools and conv1 to
  the library: a port kernel entry reached there raises."""
  model = GraspingModelWrapper(
      device_type='cpu', kernel_policy=kernel_policy,
      init_from_checkpoint_fn=lambda network: network.load_state_dict(state))
  trainer = Trainer(model, TrainerConfig(max_train_steps=1,
                                         log_interval_steps=0, seed=seed),
                    device=device)
  with _dispatch.force_kernels(device == 'cuda' and kernel_policy != 'none'):
    scalars = trainer.train(iter(batch), None)
    if device == 'cuda':
      torch.cuda.synchronize()
  return scalars['loss'], {
      k: p.grad.detach().cpu().double()
      for k, p in trainer.state.network.named_parameters()}


def reference_state(seed):
  """The reference step's weights (std 1/sqrt(fan_in)) and its batch."""
  state = spread_weights(
      GraspingModelWrapper(device_type='cpu').create_module(),
      torch.Generator().manual_seed(seed))
  return state, train_batches(seed + 4, 1, 2, shuffle_rewards=False)


def relative_l2(grads, exact):
  return {name: float((grads[name] - want).norm()) / float(want.norm())
          for name, want in exact.items()}


def worst_leaves(l2, count=4):
  return ', '.join(f'{name} {value:.2e}' for name, value in
                   sorted(l2.items(), key=lambda kv: -kv[1])[:count])


@tf32_off()
def phase_train_reference(seed):
  """One float32 training step on the card (kernels) against the same
  step on the CPU (plain versions), full width, batch 2, TF32 off. The
  card's step runs conv1's float32 forward and dW on the CUDA cores once
  each, and no dx (the image needs no gradient): returns those launches.

  Card and CPU reduce long float32 sums in different orders (batch norms
  over the batch, relu kinks and pool near-ties amplify that), so both
  are also held to a float64 gradient of the same step: every leaf of the
  card's gradient must lie no further from it, in relative L2, than
  REFERENCE_L2_RATIO times the CPU float32 gradient's worst leaf, and
  within REFERENCE_MAX_BAND of the leaf's largest magnitude of the CPU's.

  Three controls of the card's step, each printed leaf by leaf against the
  same float64 gradient: cuDNN restricted to deterministic algorithms
  without autotuning; the pools and conv1 left to the library
  (kernel_policy 'none'); and cuDNN disabled, so PyTorch's own CUDA
  convolutions and batch norms run. ``--profile`` names the card step's
  kernels (``phase_profile_reference``)."""
  state, batch = reference_state(seed)
  log(f'reference: {cudnn_flags()}')
  zero_counters()
  card_loss, card = reference_gradients(state, batch, seed, 'cuda',
                                        'pool_conv')
  launches = cuda_core_launches(read_counters())
  if launches != {'conv_s2d_fwd': 1, 'conv_s2d_dw': 1, 'conv_s2d_dx': 0}:
    raise AssertionError(f'reference step: conv1 CUDA-core launches '
                         f'{launches}, expected a forward and a dW')
  log(f'reference step: conv1 CUDA-core launches {launches}')
  with cudnn_settings(deterministic=True, benchmark=False):
    log(f'reference control: {cudnn_flags()}')
    det_loss, det = reference_gradients(state, batch, seed, 'cuda',
                                        'pool_conv')
  lib_loss, lib = reference_gradients(state, batch, seed, 'cuda', 'none')
  with cudnn_settings(enabled=False):
    log(f'reference control: {cudnn_flags()}')
    off_loss, off = reference_gradients(state, batch, seed, 'cuda',
                                        'pool_conv')
  cpu_loss, cpu = reference_gradients(state, batch, seed, 'cpu', 'pool_conv')
  exact_loss, exact = float64_gradients(state, batch[0], seed)
  if not (np.isfinite(card_loss) and abs(card_loss - cpu_loss) <= 1e-4 and
          abs(cpu_loss - exact_loss) <= 1e-4):
    raise AssertionError(f'reference step: loss card {card_loss}, cpu '
                         f'{cpu_loss}, float64 {exact_loss}')
  l2 = {name: relative_l2(grads, exact) for name, grads in (
      ('card', card), ('card, cuDNN deterministic', det),
      ('card, library pools and conv1', lib), ('card, cuDNN off', off),
      ('cpu', cpu))}
  for name, leaves in l2.items():
    log(f'reference: relative L2 from float64, worst leaves, {name}: '
        f'{worst_leaves(leaves)}')
  log(f'reference: losses card {card_loss:.7f}, cuDNN deterministic '
      f'{det_loss:.7f}, library pools and conv1 {lib_loss:.7f}, cuDNN off '
      f'{off_loss:.7f}, cpu {cpu_loss:.7f}, float64 {exact_loss:.7f}')
  cpu_worst = max(l2['cpu'].values())
  card_worst = max((value, name) for name, value in l2['card'].items())
  worst_max = (0.0, '')
  for name, card_l2 in l2['card'].items():
    max_err = float((card[name] - cpu[name]).abs().max())
    scale = float(cpu[name].abs().max())
    if not (card_l2 <= REFERENCE_L2_RATIO * cpu_worst and
            max_err <= REFERENCE_MAX_BAND * scale):
      raise AssertionError(
          f'reference step: gradient of {name}: card {card_l2:.3e} and cpu '
          f'{l2["cpu"][name]:.3e} relative L2 from float64 (cpu worst '
          f'{cpu_worst:.3e}); card vs cpu max err {max_err:.3e} at scale '
          f'{scale:.3e}')
    worst_max = max(worst_max, (max_err / max(scale, 1e-30), name))
  log(f'reference: float32 training step at batch 2, loss card '
      f'{card_loss:.7f}, cpu {cpu_loss:.7f}, float64 {exact_loss:.7f}; '
      f'relative L2 from float64: cpu float32 up to {cpu_worst:.2e}, card '
      f'up to {card_worst[0]:.2e} ({card_worst[1]}); card vs cpu max err '
      f'up to {worst_max[0]:.2e} of the leaf\'s largest magnitude '
      f'({worst_max[1]})')
  return launches


def flash_band(got, want, band):
  """Max abs error, and whether it lies within ``band`` times the larger
  of 1 and the largest magnitude (the JAX suite's absolute bars, scaled)."""
  err = float((got.float() - want.float()).abs().max())
  return err, err <= band * max(1.0, float(want.float().abs().max()))


def rel_l2(got, want):
  """||got - want|| / ||want||, in float32."""
  want = want.float()
  return float((got.float() - want).norm() / want.norm())


def flash_inputs(shape, dtype, generator):
  return tuple(torch.randn(shape, generator=generator, device='cuda').to(dtype)
               for _ in range(4))


def plain_blocks(shape, dtype):
  """Blocks for the plain versions: their defaults where ``_check`` takes
  them, else (a ragged T for the kernels' 64-row tiles) the largest
  multiple of 8 up to 256 that divides T."""
  _, t, _, d = shape
  if fa.is_supported(t, d, itemsize=dtype.itemsize):
    return None, None
  block = max(b for b in range(8, 257, 8) if t % b == 0)
  return block, block


def route_text(plan):
  return (f'route {plan["route"]}, {plan["rows"]}-row tiles, '
          f'{plan["warps"]} warps, {plan["grid"][0]} blocks, '
          f'{plan["smem"]} bytes of shared memory, {plan["order"]}')


def bwd_routes_text(shape, dtype, causal):
  return '; '.join(
      f'flash_{kernel} '
      f'{route_text(fa.bwd_plan(kernel, shape, dtype, causal))}'
      for kernel in fa.BWD_KERNELS)


def expected_route(shape, dtype):
  """The route every flash kernel must report: the tensor cores for
  bfloat16 with D % 16 == 0 (FLASH_SHAPES' tensors are aligned), else the
  CUDA cores."""
  mma = dtype == torch.bfloat16 and shape[3] % 16 == 0
  return fa.ROUTE_MMA if mma else fa.ROUTE_CUDA_CORES


@tf32_off()
def phase_check_flash(generator):
  """flash_fwd (out and lse), flash_dq and flash_dkv against their plain
  versions, causal and full, at FLASH_SHAPES; each kernel twice, bit for
  bit; out within FLASH_OUT_REL_L2 and dq, dk, dv within FLASH_GRAD_REL_L2,
  which both controls must fail; every kernel on the route its dtype and
  head dim call for. Returns each kernel's largest error at the SNAIL
  shapes."""
  errors = dict(NO_FLASH)
  labels = ('out', 'dq', 'dk', 'dv')
  sound = {(dtype, label): 0.0 for dtype in FLASH_OUT_REL_L2
           for label in labels}
  controls = {(dtype, label, control): float('inf')
              for dtype in FLASH_OUT_REL_L2 for label in labels
              for control in ('narrow', 'shift')}
  for name, shape, dtype in FLASH_SHAPES:
    f32 = dtype == torch.float32
    out_band, grad_band = (2e-5, 5e-4) if f32 else (3e-2, 3e-2)
    streamed = fa._use_streamed(shape[1], shape[3], dtype.itemsize)  # pylint: disable=protected-access
    blocks = plain_blocks(shape, dtype)
    for causal in (True, False):
      plans = {'fwd': fa.fwd_plan(shape, dtype, causal)}
      plans.update((kernel, fa.bwd_plan(kernel, shape, dtype, causal))
                   for kernel in fa.BWD_KERNELS)
      routes = {kernel: plan['route'] for kernel, plan in plans.items()}
      if set(routes.values()) != {expected_route(shape, dtype)}:
        raise AssertionError(f'flash {name} {shape} {dtype}: routes {routes}')
      q, k, v, do = flash_inputs(shape, dtype, generator)
      out, lse = fa.flash_fwd(q, k, v, causal)
      again = fa.flash_fwd(q, k, v, causal)
      want_out, want_lse = fa.plain_flash_fwd(q, k, v, causal, *blocks)
      delta = fa.flash_delta(want_out, do)
      dq = fa.flash_dq(q, k, v, do, want_lse, delta, causal)
      dq_again = fa.flash_dq(q, k, v, do, want_lse, delta, causal)
      dk, dv = fa.flash_dkv(q, k, v, do, want_lse, delta, causal)
      dkv_again = fa.flash_dkv(q, k, v, do, want_lse, delta, causal)
      want_dq = fa.plain_flash_dq(q, k, v, do, want_lse, delta, causal,
                                  *blocks)
      want_dk, want_dv = fa.plain_flash_dkv(q, k, v, do, want_lse, delta,
                                            causal, *blocks)
      torch.cuda.synchronize()
      for kernel, a, b in (('flash_fwd', out, again[0]),
                           ('flash_fwd', lse, again[1]),
                           ('flash_dq', dq, dq_again),
                           ('flash_dkv', dk, dkv_again[0]),
                           ('flash_dkv', dv, dkv_again[1])):
        if not torch.equal(a, b):
          raise AssertionError(f'{kernel} {name} {shape} is not deterministic')
      results = []
      for kernel, label, got, want, band in (
          ('flash_fwd', 'out', out, want_out, out_band),
          ('flash_fwd', 'lse', lse, want_lse, 2e-5),
          ('flash_dq', 'dq', dq, want_dq, grad_band),
          ('flash_dkv', 'dk', dk, want_dk, grad_band),
          ('flash_dkv', 'dv', dv, want_dv, grad_band)):
        err, ok = flash_band(got, want, band)
        if not ok:
          raise AssertionError(
              f'{kernel} {label} {name} {shape} {dtype} causal={causal}: '
              f'max abs err {err} at max magnitude '
              f'{float(want.float().abs().max())} (band {band})')
        if name in ('long_horizon', 'sequential'):
          errors[kernel] = max(errors[kernel], err)
        results.append(f'{label} {err:.2e}')
      # The controls: the plain results rounded to a narrower type, and
      # the plain functions with V (out) or dO (the gradients) one 64-row
      # tile early, as a ring stage read out of turn would give.
      early = fa._KEY_ROWS  # pylint: disable=protected-access
      shifted, _ = fa.plain_flash_fwd(q, k, torch.roll(v, early, 1), causal,
                                      *blocks)
      do_early = torch.roll(do, early, 1)
      shifted_dq = fa.plain_flash_dq(q, k, v, do_early, want_lse, delta,
                                     causal, *blocks)
      shifted_dk, shifted_dv = fa.plain_flash_dkv(q, k, v, do_early, want_lse,
                                                  delta, causal, *blocks)
      readings = {}
      for label, got, want, shift in (
          ('out', out, want_out, shifted), ('dq', dq, want_dq, shifted_dq),
          ('dk', dk, want_dk, shifted_dk), ('dv', dv, want_dv, shifted_dv)):
        limit = (FLASH_OUT_REL_L2 if label == 'out' else
                 FLASH_GRAD_REL_L2)[dtype]
        reading = dict(
            kernel=rel_l2(got, want),
            narrow=rel_l2(want.to(FLASH_CONTROL_DTYPE[dtype]), want),
            shift=rel_l2(shift, want))
        where = (f'flash {label} {name} {shape} {dtype} causal={causal}: '
                 f'relative L2 {reading} (limit {limit})')
        if reading['kernel'] > limit:
          raise AssertionError(where)
        if min(reading['narrow'], reading['shift']) <= limit:
          raise AssertionError(f'a control passes the limit: {where}')
        sound[dtype, label] = max(sound[dtype, label], reading['kernel'])
        for control in ('narrow', 'shift'):
          controls[dtype, label, control] = min(
              controls[dtype, label, control], reading[control])
        readings[label] = reading
      narrow = str(FLASH_CONTROL_DTYPE[dtype])[6:]
      log(f'check flash {name} {shape} {str(dtype)[6:]} '
          f'{"causal" if causal else "full"}'
          f'{" (streamed regime)" if streamed else ""}: max abs err '
          f'{", ".join(results)}; relative L2 ' + ', '.join(
              f'{label} {r["kernel"]:.2e} (controls: {narrow} '
              f'{r["narrow"]:.2e}, a tile early {r["shift"]:.2e})'
              for label, r in readings.items()) +
          f'; limits out {FLASH_OUT_REL_L2[dtype]:g}, gradients '
          f'{FLASH_GRAD_REL_L2[dtype]:g}; each kernel twice: bitwise; '
          f'flash_fwd {route_text(plans["fwd"])}; '
          f'{bwd_routes_text(shape, dtype, causal)}')
      del q, k, v, do, out, lse, again, want_out, want_lse, delta, dq
      del dq_again, dk, dv, dkv_again, want_dq, want_dk, want_dv, shifted
      del do_early, shifted_dq, shifted_dk, shifted_dv
  for dtype in FLASH_OUT_REL_L2:
    for label in labels:
      limit = (FLASH_OUT_REL_L2 if label == 'out' else
               FLASH_GRAD_REL_L2)[dtype]
      log(f'check flash {str(dtype)[6:]}: {label} relative L2 up to '
          f'{sound[dtype, label]:.3e} against the limit {limit:g}; the '
          f'controls from {controls[dtype, label, "narrow"]:.3e} (rounded '
          f'through {str(FLASH_CONTROL_DTYPE[dtype])[6:]}) and '
          f'{controls[dtype, label, "shift"]:.3e} (a tile early)')
  torch.cuda.empty_cache()
  return errors


def snail_batches(seed, count, batch, episode):
  """Seeded host batches in the SNAIL models' in-spec: one condition and
  one inference episode of 220x300 uint8 frames, 14-d gripper poses and
  7-d actions. The frames come from raw random bytes (fast at 400 MB)."""
  rng = np.random.RandomState(seed)
  frames = (batch, episode, 220, 300, 3)
  batches = []
  for _ in range(count):
    features = {}
    for prefix in ('condition', 'inference'):
      features[f'{prefix}/features/image/0'] = np.frombuffer(
          bytearray(rng.bytes(int(np.prod(frames)))), np.uint8).reshape(
              frames)
      features[f'{prefix}/features/gripper_pose/0'] = rng.randn(
          batch, episode, 14).astype(np.float32)
    features['condition/labels/action/0'] = rng.randn(
        batch, episode, 7).astype(np.float32)
    batches.append((features, {'action/0': rng.randn(batch, episode, 7)
                               .astype(np.float32)}))
  return batches


def phase_snail_train(seed, steps):
  """Both SNAIL training paths at full width on the card: a warm-up step,
  then ``steps`` timed steps with every counter zeroed just before and read
  just after. Returns {config: (ms/step, launches, trainer, batches)}."""
  results = {}
  for name, model_cls, kwargs, batch in SNAIL_CONFIGS:
    model = model_cls(**kwargs)
    episode = kwargs.get('episode_length', 40)
    trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                           log_interval_steps=0, seed=seed))
    host = snail_batches(seed + 10, 2, batch, episode)
    nbytes = sum(v.nbytes for v in host[0][0].values() if v.dtype == np.uint8)

    def stream(host=host):
      while True:
        yield from host

    batches = stream()
    with _dispatch.force_kernels(True):
      trainer.train(batches, None)  # builds the state; warm-up step
      torch.cuda.synchronize()
      state = trainer.state
      params = dict(state.network.named_parameters())
      before = {k: p.detach().clone() for k, p in params.items()}
      moments = {k: state.optimizer.state[p]['mu'].clone()
                 for k, p in params.items()}
      trainer.config.max_train_steps = 1 + steps
      zero_counters()
      start = time.perf_counter()
      scalars = trainer.train(batches, None)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
      launches = read_counters()
    want = {k: v * steps for k, v in SNAIL_LAUNCHES.items()}
    if launches != want or trainer.step != 1 + steps:
      raise AssertionError(f'{name}: launches over {steps} steps: '
                           f'{launches}, expected {want}')
    if not all(np.isfinite(v) for v in scalars.values()):
      raise AssertionError(f'{name}: non-finite step summaries {scalars}')
    for key, param in params.items():
      if param.grad is None or not bool(torch.isfinite(param.grad).all()):
        raise AssertionError(f'{name} {key}: gradient {param.grad!r}')
      if torch.equal(param.detach(), before[key]):
        raise AssertionError(f'{name} {key} did not move in {steps} steps')
      if torch.equal(state.optimizer.state[param]['mu'], moments[key]):
        raise AssertionError(f'{name} {key}: the Adam moment did not move')
    ms_per_step = 1e3 * seconds / steps
    log(f'snail {name}: {steps} steps at batch {batch}, T={2 * episode}, '
        f'{ms_per_step:.2f} ms/step (host clock, synchronised), loss '
        f'{scalars["loss"]:.4f}, launches {launches}, {len(params)} '
        f'parameters with finite gradients, all moved, Adam moments moved; '
        f'{nbytes / 1e6:.1f} MB of uint8 frames per batch')
    log(f'snail {name}: peak device memory so far '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    results[name] = (ms_per_step, launches, trainer, batches)
  return results


def snail_float64_step(model, state, batch, seed):
  """The step's loss and gradients in float64 on the CPU, dense attention:
  the trainer's weights and its crop offsets (the same draws from a
  generator seeded as the trainer's) on the same batch."""
  network = model.create_module()
  generator = torch.Generator().manual_seed(seed)
  model.init_network(network, generator)
  network.load_state_dict(state)
  network = network.double().train()
  features, labels = batch
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()}, ModeKeys.TRAIN,
      generator)
  images, aux, condition_length = model._sequence_inputs(features)  # pylint: disable=protected-access
  poses, _ = network(images.double(), aux.double())
  prediction = poses[:, condition_length:][:, None]
  loss = torch.mean(torch.square(prediction - labels['action'].double()))
  loss.backward()
  return float(loss.detach()), {k: p.grad
                                for k, p in network.named_parameters()}


@tf32_off()
def phase_snail_reference(seed):
  """One float32 long-horizon SNAIL step (episode 64, batch 1, 8 heads of
  8), TF32 off, three times: on the card through the flash kernels, on the
  card through the dense attention, and on the CPU (dense); and once in
  float64 on the CPU. Checks:

  * the losses within 1e-5 of each other and of float64;
  * flash against dense on the card, leaf by leaf, within
    SNAIL_FLASH_VS_DENSE relative L2: the two runs share every other
    kernel (cuDNN's convs, cuBLAS's matmuls), so this isolates what the
    flash kernels change;
  * every leaf of the card's flash gradient within REFERENCE_L2_FLOOR
    (relative L2) of float64, and within REFERENCE_MAX_BAND of the leaf's
    largest magnitude of the CPU's, element by element.

  INVARIANT_LEAVES are reported only."""
  kwargs = dict(episode_length=64, num_attention_heads=8,
                attention_head_size=8)
  init = VRGripperEnvLongHorizonModel(**kwargs)
  network = init.create_module()
  init.init_network(network, torch.Generator().manual_seed(seed + 7))
  state = {k: v.clone() for k, v in network.state_dict().items()}
  batch = snail_batches(seed + 11, 1, 1, 64)
  results = {}
  auto = snail._flash_auto_ok  # pylint: disable=protected-access
  for run, device, flash in (('flash', 'cuda', True), ('dense', 'cuda', False),
                             ('cpu', 'cpu', False)):
    model = VRGripperEnvLongHorizonModel(
        init_from_checkpoint_fn=lambda net: net.load_state_dict(state),
        **kwargs)
    trainer = Trainer(model, TrainerConfig(max_train_steps=1,
                                           log_interval_steps=0, seed=seed),
                      device=device)
    snail._flash_auto_ok = auto if flash else (lambda x: False)  # pylint: disable=protected-access
    try:
      with _dispatch.force_kernels(device == 'cuda'):
        zero_counters()
        scalars = trainer.train(iter(batch), None)
        launches = read_counters()
    finally:
      snail._flash_auto_ok = auto  # pylint: disable=protected-access
    want = SNAIL_LAUNCHES if flash else {**NO_QTOPT, **NO_FLASH, **NO_FUSED}
    if launches != want:
      raise AssertionError(f'snail reference {run}: launches {launches}')
    results[run] = (scalars['loss'], {
        k: p.grad.detach().cpu().double()
        for k, p in trainer.state.network.named_parameters()})
  exact_loss, exact = snail_float64_step(model, state, batch[0], seed)
  losses = {run: loss for run, (loss, _) in results.items()}
  if not all(np.isfinite(loss) and abs(loss - exact_loss) <= 1e-5
             for loss in losses.values()):
    raise AssertionError(f'snail reference step: losses {losses}, float64 '
                         f'{exact_loss}')
  card, dense, cpu = (results[run][1] for run in ('flash', 'dense', 'cpu'))

  def rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)

  names = [name for name in exact if not name.endswith(INVARIANT_LEAVES)]
  table = {name: (rel(card[name], exact[name]), rel(dense[name], exact[name]),
                  rel(cpu[name], exact[name]), rel(card[name], dense[name]))
           for name in names}
  log('snail reference: relative L2 (flash vs float64, dense vs float64, '
      'cpu vs float64, flash vs dense), worst leaves: ' + ', '.join(
          f'{name} ' + ' '.join(f'{x:.2e}' for x in row)
          for name, row in sorted(table.items(), key=lambda kv: -kv[1][0])[:5]))
  worst_max = (0.0, '')
  for name, (card_l2, _, _, flash_dense) in table.items():
    max_err = float((card[name] - cpu[name]).abs().max())
    scale = float(cpu[name].abs().max())
    if not (card_l2 <= REFERENCE_L2_FLOOR and
            flash_dense <= SNAIL_FLASH_VS_DENSE and
            max_err <= REFERENCE_MAX_BAND * scale):
      raise AssertionError(
          f'snail reference step: gradient of {name}: relative L2 {card_l2:.3e} '
          f'from float64, {flash_dense:.3e} from the dense path on the card; '
          f'card vs cpu max err {max_err:.3e} at scale {scale:.3e}')
    worst_max = max(worst_max, (max_err / max(scale, 1e-30), name))
  worst = [max((row[i], name) for name, row in table.items())
           for i in range(4)]
  invariant = max(float(card[name].abs().max()) for name in exact
                  if name.endswith(INVARIANT_LEAVES))
  log(f'snail reference: float32 long-horizon step (T=128, batch 1), losses '
      f'flash {losses["flash"]:.7f}, dense {losses["dense"]:.7f}, cpu '
      f'{losses["cpu"]:.7f}, float64 {exact_loss:.7f}; worst relative L2 over '
      f'{len(table)} leaves: flash vs float64 {worst[0][0]:.2e} ({worst[0][1]}),'
      f' dense vs float64 {worst[1][0]:.2e}, cpu vs float64 {worst[2][0]:.2e},'
      f' flash vs dense {worst[3][0]:.2e} ({worst[3][1]}); card vs cpu max '
      f'err up to {worst_max[0]:.2e} of the leaf\'s largest magnitude '
      f'({worst_max[1]}); invariant leaves\' gradients up to {invariant:.1e}')


def model_leaf_shapes():
  """The parameter shapes of the two fused-update paths: SNAIL
  long-horizon at full width and Grasping44."""
  _, model_cls, kwargs, _ = SNAIL_CONFIGS[0]
  model = model_cls(**kwargs)
  model.set_mesh(None)
  grasp = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  return {name: [tuple(p.shape) for p in net.parameters()]
          for name, net in (('long_horizon', model.create_module()),
                            ('grasping44', grasp.create_module()))}


def update_leaves(shapes, kind, with_ema, generator):
  """Seeded float32 leaves on the card: p, g, mu, nu >= 0 and the EMA."""
  adam = kind == 'adam'
  leaves = []
  for shape in shapes:
    def make(positive=False, shape=shape):
      x = torch.randn(shape, generator=generator, device='cuda')
      return x.abs() * 1e-3 if positive else x
    leaves.append(fused_update.Leaf(
        make(), make(), make() if adam else None,
        make(True) if adam else None, make() if with_ema else None))
  return leaves


def clone_leaves(leaves):
  return [fused_update.Leaf(*(None if t is None else t.clone() for t in leaf))
          for leaf in leaves]


def update_scalars(lr, count=11, b1=0.9, b2=0.999):
  """The kernel's by-value scalars at ``count`` updates (bias corrections
  as optimizers.Adam computes them)."""
  return dict(lr=lr, c1=float(fused_update.bias_correction(b1, count)),
              c2=float(fused_update.bias_correction(b2, count)), b1=b1,
              b2=b2, eps=1e-8)


def check_apply_update(model, shapes, generator, steps=4):
  """The trainer's entry, apply_update, on the card over ``steps`` steps
  with new gradients each step, at one path's real leaves and variant
  (SNAIL long-horizon: Adam at a constant rate; Grasping44: Adam, the EMA
  and the guard at a rate that decays every step, the guard False at the
  second step). After every step the parameters, both moments and the EMA
  are held within FUSED_BAND against plain_fused_update run on clones with
  the same gradients and the scalars of the reference's own count; a
  False step leaves every tensor bitwise as it was. The leaves are
  validated once (the same PreparedUpdate at every step) and each step is
  1 launch. Returns the largest error."""
  atol, rtol = FUSED_BAND
  qtopt = model == 'grasping44'
  rate = (optimizers.create_exp_decaying_learning_rate_fn(
      1e-3, decay_steps=1, staircase=True) if qtopt else 1e-4)
  params = [torch.nn.Parameter(torch.randn(shape, generator=generator,
                                           device='cuda'))
            for shape in shapes]
  optimizer = optimizers.create_adam_optimizer(rate)(params)
  decay = 0.9999 if qtopt else None
  ema = ({p: torch.randn(p.shape, generator=generator, device='cuda')
          for p in params} if qtopt else None)
  plan = fused_update.plan_for(optimizer, ema_decay=decay)
  reference = [fused_update.Leaf(
      p.detach().clone(), None, torch.zeros_like(p), torch.zeros_like(p),
      ema[p].clone() if qtopt else None) for p in params]
  count, worst, kept = 0, 0.0, set()
  for step in range(steps):
    grads = [torch.randn(shape, generator=generator, device='cuda')
             for shape in shapes]
    for p, g in zip(params, grads):
      p.grad = g
    applied = not (qtopt and step == 1)
    ok = (torch.tensor([applied], device='cuda') if qtopt else None)
    lr = rate(count) if callable(rate) else rate
    before = [(p.detach().clone(), ema[p].clone()) for p in params] if (
        not applied) else None
    launches = fused_update.fused_update.launches
    if fused_update.apply_update(plan, optimizer,
                                 dict(ema) if qtopt else None, ok) != applied:
      raise AssertionError(f'apply_update {model} step {step}: applied '
                           f'is not {applied}')
    if fused_update.fused_update.launches - launches != 1:
      raise AssertionError(f'apply_update {model} step {step}: '
                           f'{fused_update.fused_update.launches - launches}'
                           ' launches, not 1')
    kept.add(id(plan.prepared[0]))
    fused_update.plain_fused_update(
        [leaf._replace(g=g) for leaf, g in zip(reference, grads)], 'adam',
        lr=lr, c1=float(fused_update.bias_correction(0.9, count + 1)),
        c2=float(fused_update.bias_correction(0.999, count + 1)), b1=0.9,
        b2=0.999, eps=1e-8, decay=decay, ok=ok)
    count += applied
    torch.cuda.synchronize()
    for i, (p, leaf) in enumerate(zip(params, reference)):
      state = optimizer.state[p]
      got = (p.detach(), state['mu'], state['nu']) + (
          (ema[p],) if qtopt else ())
      for name, x, z in zip(('p', 'mu', 'nu', 'ema'), got,
                            (leaf.p, leaf.mu, leaf.nu, leaf.ema)):
        e = (x - z).abs()
        if not bool((e <= atol + rtol * z.abs()).all()):
          raise AssertionError(
              f'apply_update {model} step {step} leaf {i} {name} '
              f'{tuple(x.shape)}: max abs err {float(e.max())}')
        worst = max(worst, float(e.max()) if e.numel() else 0.0)
      if before is not None and not (torch.equal(p, before[i][0]) and
                                     torch.equal(ema[p], before[i][1])):
        raise AssertionError(f'apply_update {model} step {step}: a False '
                             f'guard changed leaf {i}')
  if len(kept) != 1 or optimizer.param_groups[0]['count'] != count:
    raise AssertionError(f'apply_update {model}: validated {len(kept)} '
                         f'times, count {optimizer.param_groups[0]["count"]}'
                         f' against {count}')
  log(f'check apply_update {model} ({len(shapes)} leaves) Adam'
      f'{", EMA, guard (False at step 1), a decaying rate" if qtopt else ""}: '
      f'{steps} steps with new gradients through one validation, 1 launch '
      f'a step, max abs err {worst:.2e} against the plain version on clones')
  return worst


def phase_check_fused_update(generator):
  """fused_update against plain_fused_update on the card, all 8 variants
  (Adam or SGD, EMA on or off, guard on or off) over the real leaves of
  SNAIL long-horizon and Grasping44, at a constant rate and at QT-Opt's
  decaying schedule: within FUSED_BAND, each run twice bit for bit, and a
  False guard leaves every tensor bitwise as it was. Then the trainer's
  entry over several steps at each path's variant (check_apply_update)."""
  schedule = optimizers.create_exp_decaying_learning_rate_fn(
      1e-3, decay_steps=10, staircase=True)
  rates = (('constant', 1e-4), ('schedule', schedule(11)))
  atol, rtol = FUSED_BAND
  worst = 0.0
  for model, shapes in model_leaf_shapes().items():
    elements = sum(int(np.prod(shape)) for shape in shapes)
    for kind, with_ema, guard in UPDATE_VARIANTS:
      leaves = update_leaves(shapes, kind, with_ema, generator)
      decay = 0.9999 if with_ema else None
      ok = torch.ones(1, dtype=torch.bool, device='cuda') if guard else None
      errs = []
      for _, lr in rates:
        args = update_scalars(lr)
        got, again, want = (clone_leaves(leaves) for _ in range(3))
        fused_update.fused_update(got, kind, decay=decay, ok=ok, **args)
        fused_update.fused_update(again, kind, decay=decay, ok=ok, **args)
        fused_update.plain_fused_update(want, kind, decay=decay, ok=ok,
                                        **args)
        torch.cuda.synchronize()
        err = 0.0
        for a, b, w in zip(got, again, want):
          for x, y, z in zip(a, b, w):
            if x is None:
              continue
            if not torch.equal(x, y):
              raise AssertionError(f'fused_update {model} {kind} is not '
                                   'deterministic')
            e = (x - z).abs()
            if not bool((e <= atol + rtol * z.abs()).all()):
              raise AssertionError(
                  f'fused_update {model} {kind} ema={with_ema} '
                  f'guard={guard} lr={lr}: max abs err {float(e.max())}')
            err = max(err, float(e.max()))
        errs.append(err)
        del got, again, want
      held = ''
      if guard:
        kept = clone_leaves(leaves)
        fused_update.fused_update(
            kept, kind, decay=decay,
            ok=torch.zeros(1, dtype=torch.bool, device='cuda'),
            **update_scalars(1e-4))
        torch.cuda.synchronize()
        for a, b in zip(kept, leaves):
          for x, y in zip(a, b):
            if x is not None and not torch.equal(x, y):
              raise AssertionError(f'fused_update {model} {kind}: a False '
                                   'guard changed a tensor')
        held = '; ok=0 leaves every tensor bitwise'
      worst = max(worst, *errs)
      log(f'check fused_update {model} ({len(shapes)} leaves, {elements} '
          f'elements) {kind} ema={with_ema} guard={guard}: max abs err '
          f'{errs[0]:.2e} (constant lr), {errs[1]:.2e} (schedule); twice '
          f'bitwise{held}')
      del leaves
    worst = max(worst, check_apply_update(model, shapes, generator))
  return worst


def bf16_ulp(x):
  """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
  _, exponent = torch.frexp(x.float())
  return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def photometric_float32_band(images, delta, factor, kernel_mean):
  """Per element of [B, H, W, C] ``images``, in float64: the most by which
  two float32 evaluations of clip((x - m) * factor + m) can differ, where
  x = image + delta is the same float32 in both and m is the plain
  version's mean (computed here as it computes it) in one and
  ``kernel_mean`` ([B, 1, 1, C]) in the other. With dm = |kernel_mean - m|
  and u = 2**-24: |1 - factor| * dm from the means, and u times
  7 (|x - m| + dm) * factor + 3 (|m| + dm) for the roundings of the
  subtraction, the product and the addition in each (fused or not, at most
  6 and 2), with room for the terms in u**2. Clipping to [0, 1] shrinks a
  difference, never widens it."""
  shape = (images.shape[0], 1, 1, 1)
  x = images.float() + delta.float().reshape(shape)
  mean = x.mean(dim=(1, 2), keepdim=True)
  dm = (kernel_mean.double() - mean.double()).abs()
  f = factor.double().reshape(shape)
  a = ((x.double() - mean.double()).abs() + dm) * f
  return (1 - f).abs() * dm + 2.0**-24 * (7 * a + 3 * (mean.double().abs() +
                                                        dm))


def photometric_bf16_check(got, images, delta, factor):
  """The bars of a bfloat16 photometric output ``got`` on the card, each
  raising AssertionError: (1) got is the bfloat16 rounding, bit for bit,
  of the float32 pass over the same images upcast (the same sums in the
  same order); (2) that float32 pass lies within photometric_float32_band
  of the plain version's float32, with the kernel's own means read back
  from the pass at factor 0 (fma(x - m, 0, m) = m); (3) got lies within
  one bfloat16 ulp of the plain version's bfloat16 output wherever that
  band is under half a bfloat16 ulp, as (1) and (2) imply. Where
  (x - m) * factor + m cancels near 0, a bfloat16 ulp is smaller than the
  float32 roundings, and one ulp cannot hold. Returns (max abs err, the
  elements past one ulp, the largest |plain| among them)."""
  wide = images.float()
  fused = photometric.photometric(wide, delta, factor)
  if not same_bits(got, fused.to(torch.bfloat16)):
    raise AssertionError('photometric bfloat16 is not the rounding of its '
                         'float32 pass')
  kernel_mean = photometric.photometric(
      wide, delta, torch.zeros_like(factor))[:, :1, :1, :]
  if not bool(((kernel_mean > 0) & (kernel_mean < 1)).all()):
    raise AssertionError('photometric means outside (0, 1): the pass at '
                         'factor 0 clipped them')
  plain = photometric.plain_brightness_contrast(wide, delta, factor)
  band = photometric_float32_band(wide, delta, factor, kernel_mean)
  off = (fused.double() - plain.double()).abs() - band
  if not bool((off <= 0).all()):
    raise AssertionError(f'photometric float32 pass outside its derived '
                         f'band by up to {float(off.max())}')
  want = plain.to(torch.bfloat16).float()
  err = (got.float() - want).abs()
  ulp = bf16_ulp(want)
  tight = band < ulp / 2
  if not bool((err <= ulp)[tight].all()):
    raise AssertionError('photometric bfloat16 past one ulp where its band '
                         'is under half an ulp')
  past = err > ulp
  largest = float(want[past].abs().max()) if bool(past.any()) else 0.0
  return float(err.max()), int(past.sum()), largest


def phase_check_photometric(generator):
  """photometric against plain_brightness_contrast on the card at QT-Opt's
  training shape: float32 within PHOTOMETRIC_F32_BAND, bfloat16 to
  photometric_bf16_check's bars, each dtype twice bit for bit."""
  errors = {}
  for dtype in (torch.float32, torch.bfloat16):
    images = torch.rand(PHOTOMETRIC_SHAPE, generator=generator,
                        device='cuda').to(dtype)
    delta = (torch.rand(TRAIN_BATCH, generator=generator, device='cuda') -
             0.5) * 0.25
    factor = torch.rand(TRAIN_BATCH, generator=generator, device='cuda') + 0.5
    got = photometric.photometric(images, delta, factor)
    again = photometric.photometric(images, delta, factor)
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.equal(got, again):
      raise AssertionError(f'photometric {dtype} is not deterministic')
    if dtype == torch.float32:
      want = photometric.plain_brightness_contrast(images, delta, factor)
      errors[dtype] = float((got - want).abs().max())
      if not errors[dtype] <= PHOTOMETRIC_F32_BAND:
        raise AssertionError(f'photometric {dtype}: max abs err '
                             f'{errors[dtype]}')
      detail = 'band 1e-6'
    else:
      errors[dtype], past, largest = photometric_bf16_check(
          got, images, delta, factor)
      detail = (f'the rounding of its float32 pass, bitwise; that pass '
                f'within its derived float32 band; one bf16 ulp where the '
                f'band is under half an ulp; {past} elements past one ulp, '
                f'all with |plain| <= {largest:.3e}')
    log(f'check photometric {PHOTOMETRIC_SHAPE} {str(dtype)[6:]}: max abs '
        f'err {errors[dtype]:.2e} ({detail}); twice bitwise')
    del images, got, again
  return errors[torch.float32]


def phase_photometric_path(seed, calls=3):
  """The fused photometric branch a user calls:
  ``apply_photometric_image_distortions(random_brightness=True,
  random_contrast=True, use_fused_kernel=True)`` on QT-Opt's training
  images (random 472x472 crops of 512x640 uint8 frames, /255) at batch 32,
  against the stock chain on the same generator, then ``calls`` timed
  calls with every counter zeroed just before and read just after."""
  frames = torch.from_numpy(np.random.RandomState(seed + 8).randint(
      0, 256, (TRAIN_BATCH, 512, 640, 3), dtype=np.uint8)).cuda()
  generator = torch.Generator().manual_seed(seed)
  images = image_transformations.random_crop_images(
      frames, (472, 472), generator).to(torch.float32) / 255.0
  options = dict(random_brightness=True, random_contrast=True)
  with _dispatch.force_kernels(True):
    fused = image_transformations.apply_photometric_image_distortions(
        images, torch.Generator().manual_seed(seed + 1),
        use_fused_kernel=True, **options)
    stock = image_transformations.apply_photometric_image_distortions(
        images, torch.Generator().manual_seed(seed + 1), **options)
    torch.cuda.synchronize()
    err = float((fused - stock).abs().max())
    if (fused.shape != images.shape or fused.dtype != torch.float32 or
        not bool(torch.isfinite(fused).all()) or err > 1e-6 or
        float(fused.min()) < 0 or float(fused.max()) > 1):
      raise AssertionError(f'photometric path: fused branch against the '
                           f'stock chain, max abs err {err}')
    zero_counters()
    start = time.perf_counter()
    for _ in range(calls):
      image_transformations.apply_photometric_image_distortions(
          images, generator, use_fused_kernel=True, **options)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counters()
  want = {**NO_QTOPT, **NO_FLASH, **NO_FUSED, 'photometric': calls}
  if launches != want:
    raise AssertionError(f'photometric path launches {launches}')
  log(f'photometric path: {calls} calls of the fused branch on '
      f'{tuple(images.shape)} float32, {1e3 * seconds / calls:.3f} ms/call '
      f'(host clock, synchronised), launches {launches}; against the stock '
      f'chain on one generator: max abs err {err:.2e}')
  return launches


def phase_train_fused(seed, steps, stock_ms):
  """QT-Opt training at full width, batch 32, on the fused update path:
  tagged Adam under a decaying rate (the JAX suite's _qtopt_mock), the
  EMA, fused_update=True and nonfinite_mode='skip_update'. Timed steps with
  the counters zeroed just before and read just after, then one
  NaN-poisoned batch, which must leave parameters, moments, counts, EMA,
  batch statistics, step and generator bitwise as they were."""
  model = GraspingModelWrapper(
      device_type='gpu', kernel_policy='pool_conv',
      create_optimizer_fn=lambda: optimizers.create_adam_optimizer(
          optimizers.create_exp_decaying_learning_rate_fn(
              1e-3, decay_steps=10, staircase=True)))
  trainer = Trainer(model, TrainerConfig(
      model_dir='', max_train_steps=1, log_interval_steps=0, seed=seed,
      fused_update=True, nonfinite_mode='skip_update'))
  batches = iter(train_batches(seed + 6, 1 + steps, TRAIN_BATCH))
  with _dispatch.force_kernels(True):
    trainer.train(batches, None)  # builds the state; warm-up step
    torch.cuda.synchronize()
    state = trainer.state
    params = dict(state.network.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    ema_before = {k: v.clone() for k, v in state.ema.items()}
    trainer.config.max_train_steps = 1 + steps
    zero_counters()
    start = time.perf_counter()
    scalars = trainer.train(batches, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_counters()
  leaves = len(params)
  per_step = {**TRAIN_LAUNCHES,
              'fused_update': -(-leaves // fused_update.LEAVES_PER_LAUNCH)}
  want = {k: v * steps for k, v in per_step.items()}
  if trainer.fused_plan is None or launches != want or (
      trainer.step != 1 + steps) or per_step['fused_update'] != 1:
    raise AssertionError(f'fused training launches over {steps} steps: '
                         f'{launches}, expected {want}')
  if not all(np.isfinite(v) for v in scalars.values()):
    raise AssertionError(f'fused training: non-finite summaries {scalars}')
  for name, param in params.items():
    if torch.equal(param.detach(), before[name]):
      raise AssertionError(f'fused training: {name} did not move')
    if torch.equal(state.optimizer.state[param]['mu'],
                   torch.zeros_like(param)):
      raise AssertionError(f'fused training: {name} has no moment')
  if not any(not torch.equal(state.ema[k], v) for k, v in ema_before.items()):
    raise AssertionError('fused training: the EMA did not move')
  ms_per_step = 1e3 * seconds / steps
  log(f'train fused: {steps} steps at batch {TRAIN_BATCH}, {ms_per_step:.2f} '
      f'ms/step (host clock, synchronised; the stock momentum run: '
      f'{stock_ms:.2f}), Adam with a decaying rate, EMA and the skip_update '
      f'guard, loss {scalars["loss"]:.4f}, launches {launches} '
      f'({leaves} leaves, {per_step["fused_update"]} fused launch per step)')

  bad_features, bad_labels = train_batches(seed + 7, 1, TRAIN_BATCH)[0]
  bad_features['action/world_vector'][0, 0] = np.nan
  kept = {
      'params': {k: p.detach().clone() for k, p in params.items()},
      'moments': {(k, slot): v.clone() for k, p in params.items()
                  for slot, v in state.optimizer.state[p].items()},
      'ema': {k: v.clone() for k, v in state.ema.items()},
      'buffers': {k: b.clone() for k, b in state.network.named_buffers()},
  }
  step, counts = trainer.step, [g['count'] for g in state.optimizer.param_groups]
  generator_state = state.generator.get_state()
  trainer.config.max_train_steps = step + 1
  with _dispatch.force_kernels(True):
    zero_counters()
    bad = trainer.train(iter([(bad_features, bad_labels)]), None)
    torch.cuda.synchronize()
    bad_launches = read_counters()
  now = {
      'params': dict(state.network.named_parameters()),
      'moments': {(k, slot): v for k, p in params.items()
                  for slot, v in state.optimizer.state[p].items()},
      'ema': state.ema,
      'buffers': dict(state.network.named_buffers()),
  }
  for part, tensors in kept.items():
    for key, value in tensors.items():
      if not torch.equal(now[part][key].detach(), value):
        raise AssertionError(f'NaN batch changed {part} {key}')
  if (trainer.step != step or
      [g['count'] for g in state.optimizer.param_groups] != counts or
      not torch.equal(state.generator.get_state(), generator_state) or
      trainer.nonfinite_policy.bad_steps != 1 or
      bad_launches['fused_update'] != per_step['fused_update'] or
      bad['nonfinite_count'] != 1):
    raise AssertionError(f'NaN batch: step {trainer.step} (was {step}), '
                         f'policy {trainer.nonfinite_policy.bad_steps} skips, '
                         f'launches {bad_launches}, summaries {bad}')
  log(f'train fused: a NaN batch left parameters, {len(kept["moments"])} '
      f'moments, counts {counts}, {len(kept["ema"])} EMA tensors, '
      f'{len(kept["buffers"])} batch statistics, step {step} and the '
      'generator bitwise as they were; the policy counted 1 skip; the '
      f'guarded kernel launched {bad_launches["fused_update"]} time(s)')
  return ms_per_step, launches, trainer


def phase_snail_fused(seed, steps, stock_ms):
  """Both SNAIL training paths at full width with fused_update=True and
  default Adam: timed steps with the counters zeroed just before and read
  just after; the stock Adam.step is never entered. ``stock_ms`` holds
  each path's stock ms/step. Returns {config: (ms/step, launches, trainer,
  batches)}."""
  stock_step = optimizers.Adam.step
  entered = []

  def counted_step(self, closure=None):
    entered.append(1)
    return stock_step(self, closure)

  results = {}
  for name, model_cls, kwargs, batch in SNAIL_CONFIGS:
    model = model_cls(**kwargs)
    trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                           log_interval_steps=0, seed=seed,
                                           fused_update=True))
    host = snail_batches(seed + 10, 2, batch,
                         kwargs.get('episode_length', 40))

    def stream(host=host):
      while True:
        yield from host

    batches = stream()
    optimizers.Adam.step = counted_step
    try:
      with _dispatch.force_kernels(True):
        trainer.train(batches, None)  # builds the state; warm-up step
        torch.cuda.synchronize()
        state = trainer.state
        params = dict(state.network.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        moments = {(k, slot): state.optimizer.state[p][slot].clone()
                   for k, p in params.items() for slot in ('mu', 'nu')}
        trainer.config.max_train_steps = 1 + steps
        zero_counters()
        start = time.perf_counter()
        scalars = trainer.train(batches, None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_counters()
    finally:
      optimizers.Adam.step = stock_step
    per_step = {**SNAIL_LAUNCHES, 'fused_update': -(
        -len(params) // fused_update.LEAVES_PER_LAUNCH)}
    want = {k: v * steps for k, v in per_step.items()}
    if (trainer.fused_plan is None or entered or launches != want or
        trainer.step != 1 + steps or per_step['fused_update'] != 1):
      raise AssertionError(f'snail {name} fused: launches {launches}, '
                           f'expected {want}; stock Adam.step entered '
                           f'{len(entered)} times')
    if not all(np.isfinite(v) for v in scalars.values()):
      raise AssertionError(f'snail {name} fused: non-finite summaries '
                           f'{scalars}')
    for key, param in params.items():
      if torch.equal(param.detach(), before[key]):
        raise AssertionError(f'snail {name} fused: {key} did not move')
      for slot in ('mu', 'nu'):
        if torch.equal(state.optimizer.state[param][slot],
                       moments[key, slot]):
          raise AssertionError(f'snail {name} fused: {key} {slot} did not '
                               'move')
    ms_per_step = 1e3 * seconds / steps
    log(f'snail {name} fused: {steps} steps at batch {batch}, '
        f'{ms_per_step:.2f} ms/step (host clock, synchronised) against '
        f'{stock_ms[name]:.2f} ms/step on the stock Adam loop; loss '
        f'{scalars["loss"]:.4f}, launches {launches} ({len(params)} leaves, '
        f'{per_step["fused_update"]} fused launch per step); stock '
        'Adam.step never entered; every parameter and both moments moved')
    results[name] = (ms_per_step, launches, trainer, batches)
  return results


def flash_work(shape, dtype, causal):
  """(bytes, operations) of each flash kernel for one call: inputs read
  once and outputs written once; q·kᵀ and the other [T, T]-by-D products
  at 2 operations per multiply-add, half of them under the causal mask."""
  b, t, h, d = shape
  item = dtype.itemsize
  tensor, stat = b * t * h * d * item, b * h * t * 4
  pair = 2 * b * h * t * t * d * (0.5 if causal else 1.0)  # one product
  return {'flash_fwd': (4 * tensor + stat, 2 * pair),
          'flash_dq': (5 * tensor + 2 * stat, 3 * pair),
          'flash_dkv': (6 * tensor + 2 * stat, 4 * pair)}


def flash_fwd_full_timing(record, name, shape, dtype, q, k, v):
  """flash_fwd without the mask beside SDPA at one FLASH_TIMED shape,
  listed under the record's ``per_shape``."""
  rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
  plan = fa.fwd_plan(shape, dtype, False)
  ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, False),
               iters=5 if name == 'streamed' else 20)
  plain = cuda_ms(lambda: fa.plain_flash_fwd(q, k, v, False), iters=2,
                  warmup=1)
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
  nbytes, ops = flash_work(shape, dtype, False)['flash_fwd']
  log(f'time flash_fwd {name} {shape} {str(dtype)[6:]} full '
      f'({route_text(plan)}): kernel {ms:.4f} ms, plain {plain:.4f} ms, '
      f'F.scaled_dot_product_attention {lib:.4f} ms, '
      f'{bound_text(nbytes, ops, rate)}')
  flash_shape_entry(record, f'{name} {list(shape)} {str(dtype)[6:]} full',
                    plan, ms, plain, lib, nbytes, ops, rate)


def flash_shape_entry(record, label, plan, ms, plain, lib, nbytes, ops, rate,
                      kernel='flash_fwd'):
  """One shape of a flash kernel's ``per_shape`` list: under
  ``flash_fwd_per_shape`` for the forward, ``flash_bwd_per_shape`` (with
  the kernel's name; ``library_ms`` is SDPA's backward) for dq and
  dk/dv."""
  bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate
  entry = dict(
      shape=label, route=plan['route'], rows=plan['rows'], ms=ms,
      plain_ms=plain, library_ms=lib, bound_ms=max(bytes_ms, ops_ms),
      bound_by='bytes' if bytes_ms >= ops_ms else 'operations')
  if kernel == 'flash_fwd':
    record.setdefault('flash_fwd_per_shape', []).append(entry)
  else:
    record.setdefault('flash_bwd_per_shape', []).append(
        dict(kernel=kernel, **entry))


def flash_timing(record, generator):
  """Each flash kernel, its plain version and the library call at the
  FLASH_TIMED shapes, causal, and flash_fwd without the mask: the JSON
  record sums the two causal SNAIL shapes (one launch of each) and lists
  each kernel at every timed shape (flash_fwd also without the mask) with
  its route and bound under ``per_shape``."""
  for name, shape, dtype, in_record in FLASH_TIMED:
    rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    q, k, v, do = flash_inputs(shape, dtype, generator)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(out, do)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float((lib_out.detach().transpose(1, 2).float() -
                     out.float()).abs().max())
    do_t = do.transpose(1, 2)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=True))
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do_t, retain_graph=True))
    plain_iters = 2 if name == 'streamed' else 5
    kernels = (
        ('flash_fwd', lambda: fa.flash_fwd(q, k, v, True),
         lambda: fa.plain_flash_fwd(q, k, v, True), lib_fwd),
        ('flash_dq', lambda: fa.flash_dq(q, k, v, do, lse, delta, True),
         lambda: fa.plain_flash_dq(q, k, v, do, lse, delta, True), lib_bwd),
        ('flash_dkv', lambda: fa.flash_dkv(q, k, v, do, lse, delta, True),
         lambda: fa.plain_flash_dkv(q, k, v, do, lse, delta, True), lib_bwd))
    work = flash_work(shape, dtype, True)
    plans = {'flash_fwd': fa.fwd_plan(shape, dtype, True)}
    plans.update((f'flash_{kernel}', fa.bwd_plan(kernel, shape, dtype, True))
                 for kernel in fa.BWD_KERNELS)
    bwd_ms = 0.0
    for kernel, kernel_fn, plain_fn, lib in kernels:
      ms = cuda_ms(kernel_fn, iters=5 if name == 'streamed' else 20)
      plain = cuda_ms(plain_fn, iters=plain_iters, warmup=1)
      nbytes, ops = work[kernel]
      lib_name = ('F.scaled_dot_product_attention' if kernel == 'flash_fwd'
                  else 'its backward (dq, dk and dv together)')
      log(f'time {kernel} {name} {shape} {str(dtype)[6:]} causal '
          f'({route_text(plans[kernel])}): kernel {ms:.4f} ms, plain '
          f'{plain:.4f} ms, {lib_name} {lib:.4f} ms, '
          f'{bound_text(nbytes, ops, rate)}')
      if in_record:
        timing_entry(record, kernel, ms, plain, lib, nbytes, ops, rate)
      flash_shape_entry(record,
                        f'{name} {list(shape)} {str(dtype)[6:]} causal',
                        plans[kernel], ms, plain, lib, nbytes, ops, rate,
                        kernel)
      bwd_ms += ms if kernel != 'flash_fwd' else 0.0
    log(f'time flash {name} {shape} {str(dtype)[6:]} causal: dq + dk/dv '
        f'{bwd_ms:.4f} ms against the SDPA backward\'s {lib_bwd:.4f} ms '
        f'({bwd_ms / lib_bwd:.2f}x)')
    log(f'time flash {name}: SDPA output within {lib_err:.2e} of the '
        'kernel\'s')
    flash_fwd_full_timing(record, name, shape, dtype, q, k, v)
    del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out, do_t
    torch.cuda.empty_cache()


def kernel_device_ms(fn, names):
  """Device time of one call of ``fn`` spent in kernels whose names hold
  one of ``names`` (torch.profiler), without the host time that CUDA events
  around a host-bound call also take in; None when the profiler recorded
  no such kernel. A 256 MB write flushes the 50 MB L2 cache before the
  profiled call, so its inputs come from device memory, as the bytes bound
  assumes."""
  from torch.profiler import ProfilerActivity, profile

  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda')
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    flush.zero_()
    fn()
    torch.cuda.synchronize()
  rows = [e for e in prof.key_averages()
          if any(name in e.key for name in names)]
  if not rows:
    return None
  return sum(getattr(e, 'self_device_time_total', None) or
             getattr(e, 'self_cuda_time_total', 0) for e in rows) / 1e3


def device_text(ms):
  return 'not measured (no such kernel in the profile)' if ms is None else (
      f'{ms:.4f} ms')


def update_work(leaves, kind, with_ema):
  """(bytes, operations) of one fused update: p and g read, p written;
  Adam adds mu and nu read and written, the EMA its tensor read and
  written; about 14 operations per element for Adam (2 for SGD), 3 more
  for the EMA."""
  elements = sum(leaf.p.numel() for leaf in leaves)
  tensors = 2 + (2 if kind == 'adam' else 0) + (1 if with_ema else 0)
  outputs = tensors - 1
  ops = (14 if kind == 'adam' else 2) + (3 if with_ema else 0)
  return 4 * elements * (tensors + outputs), elements * ops


def host_ms(fn, iters=50, warmup=5):
  """Host-clock time of one call of ``fn`` over back-to-back calls, the
  card synchronised before and after: what a step pays for a call that
  its host, not the card, bounds."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(iters):
    fn()
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - start) / iters


def fused_update_timing(record, generator):
  """One step's fused update at each path's leaves and variant (SNAIL
  long-horizon: Adam; Grasping44 on the QT-Opt fused path: Adam, the EMA
  and the guard). The record's kernel time is the trainer's per-step call,
  ``apply_update`` under the validation made at its first call (host
  clock, one launch); beside it the one-shot ``fused_update(leaves, ...)``
  (host clock), the kernel's device time (profiler), its plain version,
  and torch.optim.Adam(fused=True).step over the same leaves (host clock;
  no EMA, no guard). The record sums the two paths."""
  iters, warmup = 50, 5
  for model, shapes in model_leaf_shapes().items():
    with_ema = guard = model == 'grasping44'
    leaves = update_leaves(shapes, 'adam', with_ema, generator)
    decay = 0.9999 if with_ema else None
    ok = torch.ones(1, dtype=torch.bool, device='cuda') if guard else None
    args = update_scalars(1e-4)

    def parameters():
      params = [torch.nn.Parameter(leaf.p.clone()) for leaf in leaves]
      for param, leaf in zip(params, leaves):
        param.grad = leaf.g
      return params

    params = parameters()
    optimizer = optimizers.create_adam_optimizer(1e-4)(params)
    ema = ({param: leaf.ema.clone() for param, leaf in zip(params, leaves)}
           if with_ema else None)
    plan = fused_update.plan_for(optimizer, ema_decay=decay)

    def step():
      fused_update.apply_update(plan, optimizer, ema, ok)

    step()  # packs the table
    prepared = fused_update.prepare(plan, optimizer, ema)[0]
    before = fused_update.fused_update.launches
    ms = host_ms(step, iters, warmup)
    launches = fused_update.fused_update.launches - before
    if (launches != iters + warmup or
        fused_update.prepare(plan, optimizer, ema)[0] is not prepared):
      raise AssertionError(f'fused_update {model}: {launches} launches over '
                           f'{iters + warmup} steps, or the leaves validated '
                           'anew')
    events_ms = cuda_ms(step)
    one_shot = host_ms(lambda: fused_update.fused_update(
        leaves, 'adam', decay=decay, ok=ok, **args), iters, warmup)
    plain = cuda_ms(lambda: fused_update.plain_fused_update(
        leaves, 'adam', decay=decay, ok=ok, **args), iters=5, warmup=1)
    library = torch.optim.Adam(parameters(), lr=1e-4, fused=True)
    lib = host_ms(library.step, iters, warmup)
    lib_events = cuda_ms(library.step)
    device = kernel_device_ms(step, ('fused_update_kernel',))
    nbytes, ops = update_work(leaves, 'adam', with_ema)
    log(f'time fused_update {model} ({len(leaves)} leaves, Adam'
        f'{", EMA, guard" if guard else ""}): the trainer\'s per-step call '
        f'{ms:.4f} ms (host clock, back to back; 1 launch, the leaves '
        f'validated once), one-shot fused_update {one_shot:.4f} ms (host '
        f'clock), '
        f'{device_text(device)} on the device (profiler), plain '
        f'{plain:.4f} ms, '
        f'torch.optim.Adam(fused=True).step {lib:.4f} ms (host clock); '
        f'CUDA events after an L2 flush, as the other rows are timed: per-step '
        f'call {events_ms:.4f} ms, Adam(fused=True) {lib_events:.4f} ms; '
        f'{bound_text(nbytes, ops, F32_FLOP_PER_S)}')
    timing_entry(record, 'fused_update', ms, plain, lib, nbytes, ops,
                 F32_FLOP_PER_S)
    del leaves, params, optimizer, ema, library


def photometric_timing(record, generator):
  """The photometric pass at QT-Opt's training images, float32 (the path's
  dtype, in the record) and bfloat16 (printed): kernel and plain version;
  no single library call computes it. Bound: each image element read once
  and written once; the kernel reads the images twice (sums, then apply)."""
  for dtype in (torch.float32, torch.bfloat16):
    images = torch.rand(PHOTOMETRIC_SHAPE, generator=generator,
                        device='cuda').to(dtype)
    delta = (torch.rand(TRAIN_BATCH, generator=generator, device='cuda') -
             0.5) * 0.25
    factor = torch.rand(TRAIN_BATCH, generator=generator, device='cuda') + 0.5
    ms = cuda_ms(lambda: photometric.photometric(images, delta, factor))
    plain = cuda_ms(lambda: photometric.plain_brightness_contrast(
        images, delta, factor), iters=5)
    device = kernel_device_ms(
        lambda: photometric.photometric(images, delta, factor),
        ('photometric_sums_kernel', 'photometric_apply_kernel'))
    nbytes = 2 * images.numel() * dtype.itemsize + 2 * TRAIN_BATCH * 4
    ops = 8 * images.numel()
    log(f'time photometric {PHOTOMETRIC_SHAPE} {str(dtype)[6:]}: kernel '
        f'{ms:.4f} ms ({device_text(device)} in its two kernels, profiled), '
        f'plain {plain:.4f} ms, no library call, '
        f'{bound_text(nbytes, ops, F32_FLOP_PER_S)}; reading the images '
        f'twice: {1e3 * 1.5 * (nbytes - 8 * TRAIN_BATCH) / HBM_BYTES_PER_S:.4f} '
        'ms')
    if dtype == torch.float32:
      timing_entry(record, 'photometric', ms, plain, None, nbytes, ops,
                   F32_FLOP_PER_S)
    del images


def phase_profile_snail(name, trainer, batches):
  """Device time by kernel over one SNAIL training step (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile

  trainer.config.max_train_steps = trainer.step + 1
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with _dispatch.force_kernels(True):
      start = time.perf_counter()
      trainer.train(batches, None)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=50)
  OUT_DIR.mkdir(exist_ok=True)
  path = OUT_DIR / f'chip_smoke_profile_snail_{name}.txt'
  path.write_text(table)
  device_us = device_time_us(averages)
  upload_us = device_time_us(averages, 'Memcpy HtoD')
  flash_us = device_time_us(averages, 'void (anonymous namespace)::flash')
  launches = sum(e.count for e in averages
                 if str(getattr(e, 'device_type', '')).endswith('CUDA') and
                 not e.key.startswith(('Memcpy', 'Memset', 'Activity',
                                       'Optimizer.')))
  optimizer_us = sum(
      getattr(e, 'self_device_time_total', None) or
      getattr(e, 'self_cuda_time_total', 0) for e in averages
      if e.key.startswith('Optimizer.step') and
      str(getattr(e, 'device_type', '')).endswith('CUDA'))
  log(f'profile snail {name}: the optimizer step spans {optimizer_us / 1e3:.3f}'
      ' ms of the device timeline')
  log(f'profile snail {name}: {device_us / 1e3:.3f} ms of device time in a '
      f'{1e3 * seconds:.3f} ms step (host clock, profiler on), '
      f'{upload_us / 1e3:.3f} ms of it the host-to-device copy, '
      f'{flash_us / 1e3:.3f} ms the flash kernels; {launches} kernel '
      f'launches; table in {path.relative_to(OUT_DIR.parent)}')
  log_activity_row(f' snail {name}', averages)
  for line in table.splitlines()[:24]:
    log('  ' + line)


def pool_bytes(shape, window, strides, itemsize):
  pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
  (plh, phh), (plw, phw) = pads
  oh = (shape[1] + plh + phh - window[0]) // strides[0] + 1
  ow = (shape[2] + plw + phw - window[1]) // strides[1] + 1
  outputs = shape[0] * oh * ow * shape[3]
  return (np.prod(shape) * itemsize + outputs * (itemsize + 4), pads,
          outputs * window[0] * window[1])


def library_pool(x_nhwc, window, strides, pads):
  """One F.max_pool2d call for the same pool: the high-end pad of SAME is
  ceil_mode's, a symmetric one is padding=."""
  (plh, _), _ = pads
  x = x_nhwc.permute(0, 3, 1, 2)
  if plh:
    return F.max_pool2d(x, window, strides, padding=plh, return_indices=True)
  return F.max_pool2d(x, window, strides, ceil_mode=True, return_indices=True)


def library_pool_bwd(g_nhwc, x_nhwc, indices, window, strides, pads):
  """One aten.max_pool2d_with_indices_backward call for the same pool, on
  the NCHW views, with the library forward's indices."""
  (plh, _), _ = pads
  return torch.ops.aten.max_pool2d_with_indices_backward(
      g_nhwc.permute(0, 3, 1, 2), x_nhwc.permute(0, 3, 1, 2), list(window),
      list(strides), [plh, plh], [1, 1], not plh, indices)


def timing_entry(record, name, ms, plain, lib, nbytes, ops,
                 ops_rate=BF16_FLOP_PER_S):
  """Adds one timed shape to a kernel's record: times, and the bytes and
  operations bounds in ms (operations at ``ops_rate``, the peak for the
  inputs' type)."""
  entry = record.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                       bytes_ms=0.0, ops_ms=0.0))
  entry['ms'] += ms
  entry['plain_ms'] += plain
  # None: no single library call computes the function.
  entry['library_ms'] = (None if lib is None or entry['library_ms'] is None
                         else entry['library_ms'] + lib)
  entry['bytes_ms'] += 1e3 * nbytes / HBM_BYTES_PER_S
  entry['ops_ms'] += 1e3 * ops / ops_rate


def bound_text(nbytes, ops, ops_rate=BF16_FLOP_PER_S):
  return (f'bytes bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms '
          f'({nbytes / 1e6:.1f} MB), ops bound '
          f'{1e3 * ops / ops_rate:.4f} ms ({ops / 1e9:.2f} G at '
          f'{ops_rate / 1e12:g} TFLOP/s)')


def float32_timing(record, card, name, kernel_fn, plain_fn, library_fn,
                   library_name, nbytes, ops):
  """One float32 CUDA-core route of conv1 (row ``name`` of the kernels
  line): the kernel, its plain version (TF32 off) and one cuDNN call at
  torch's default (TF32 on) and with TF32 off, logged beside the card and
  the FFMA bound; the row keeps the TF32-off library time, the one that
  computes the same float32 function."""
  ms = cuda_ms(kernel_fn)
  with tf32_off():
    plain = cuda_ms(plain_fn, iters=5)
    lib_exact = cuda_ms(library_fn)
  lib = cuda_ms(library_fn)
  bound = 1e3 * ops / F32_FLOP_PER_S
  log(f'time {name}: kernel {ms:.4f} ms ({100 * bound / ms:.1f}% of the '
      f'FFMA bound), plain {plain:.4f} ms, {library_name} {lib_exact:.4f} '
      f'ms (TF32 off), {lib:.4f} ms (TF32 '
      f'{torch.backends.cudnn.allow_tf32}), '
      f'{bound_text(nbytes, ops, F32_FLOP_PER_S)}; {card}')
  timing_entry(record, name, ms, plain, lib_exact, nbytes, ops,
               F32_FLOP_PER_S)


def conv_float32_timing(record, card, generator, patch):
  """conv1's float32 routes on the CUDA cores: the forward at the serving
  shape [64, 472, 472, 3] (the float32 critic's CEM batch) against
  F.conv2d, dW and dx at the training shape against
  torch.nn.grad.conv2d_weight and conv2d_input."""
  pads = CONV1_PADS
  x = torch.rand(CONV1_X, generator=generator, device='cuda')
  w = 0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')
  x_cl = x.permute(0, 3, 1, 2)
  w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  pixels = CONV1_X[0] * 236 * 236
  float32_timing(
      record, card, 'conv_s2d_fwd_float32',
      lambda: conv_s2d.conv_s2d_fwd(x, w, (2, 2), pads),
      lambda: conv_s2d.plain_conv2d(x, w, (2, 2), pads),
      lambda: F.conv2d(x_cl, w_cl, stride=2, padding=pads[0][0]),
      'F.conv2d',
      4 * (np.prod(CONV1_X) + np.prod(CONV1_W) + pixels * CONV1_W[3]),
      2 * pixels * patch * CONV1_W[3])
  del x, x_cl
  x = torch.rand(TRAIN_CONV1_X, generator=generator, device='cuda')
  g = torch.randn((TRAIN_BATCH, 236, 236, 64), generator=generator,
                  device='cuda')
  x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
  pixels = TRAIN_BATCH * 236 * 236
  nbytes = 4 * (np.prod(TRAIN_CONV1_X) + np.prod(CONV1_W) + g.numel())
  ops = 2 * pixels * patch * CONV1_W[3]
  dw = lambda: conv_s2d.conv_s2d_dw(x, g, CONV1_W, (2, 2), pads)
  float32_timing(
      record, card, 'conv_s2d_dw_float32', dw,
      lambda: conv_s2d.plain_conv2d_dw(x, g, CONV1_W, (2, 2), pads),
      lambda: torch.nn.grad.conv2d_weight(x_cl, w_cl.shape, g_cl, stride=2,
                                          padding=2),
      'torch.nn.grad.conv2d_weight', nbytes, ops)
  # The two passes apart (profiler rows, L2 flushed before the call).
  first = kernel_device_ms(dw, ('conv_dw_ffma_kernel',))
  second = kernel_device_ms(dw, ('conv_dw_reduce_kernel',))
  bound = 1e3 * ops / F32_FLOP_PER_S
  runs = conv_s2d.dw_plan(TRAIN_CONV1_X, CONV1_W, (2, 2), pads,
                          torch.float32)['chunks']
  log(f'time conv_s2d_dw_float32 by pass (profiler): conv_dw_ffma_kernel '
      f'{device_text(first)}'
      + (f' ({100 * bound / first:.1f}% of the FFMA bound)' if first else '')
      + f', conv_dw_reduce_kernel {device_text(second)} over {runs} '
      f'partials; {card}')
  float32_timing(
      record, card, 'conv_s2d_dx_float32',
      lambda: conv_s2d.conv_s2d_dx(g, w, TRAIN_CONV1_X, (2, 2), pads),
      lambda: conv_s2d.plain_conv2d_dx(g, w, TRAIN_CONV1_X, (2, 2), pads),
      lambda: torch.nn.grad.conv2d_input(x_cl.shape, w_cl, g_cl, stride=2,
                                         padding=2),
      'torch.nn.grad.conv2d_input', nbytes, ops)
  del x, w, g, x_cl, w_cl, g_cl


def fwd_logged_timing(generator, patch):
  """conv1's bfloat16 forward at the training shape beside its row of the
  kernels line (the serving shape), logged only, against F.conv2d."""
  x = torch.rand(TRAIN_CONV1_X, generator=generator, device='cuda').to(
      torch.bfloat16)
  w = (0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')).to(
      torch.bfloat16)
  x_cl = x.permute(0, 3, 1, 2)
  w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  ms = cuda_ms(lambda: conv_s2d.conv_s2d_fwd(x, w, (2, 2), CONV1_PADS))
  lib = cuda_ms(lambda: F.conv2d(x_cl, w_cl, stride=2,
                                 padding=CONV1_PADS[0][0]))
  pixels = TRAIN_CONV1_X[0] * 236 * 236
  nbytes = 2 * (np.prod(TRAIN_CONV1_X) + np.prod(CONV1_W) +
                pixels * CONV1_W[3])
  ops = 2 * pixels * patch * CONV1_W[3]
  log(f'time conv_s2d_fwd {TRAIN_CONV1_X} bf16 (tensor_core): kernel '
      f'{ms:.4f} ms, F.conv2d {lib:.4f} ms, '
      + bound_text(nbytes, ops, BF16_FLOP_PER_S))
  del x, w, x_cl, w_cl


def stem_pool_timing(record, generator):
  """The stem pool's kernels at both Grasp2Vec towers' shapes (a step's
  work), bfloat16: pool_fwd with its plain version and F.max_pool2d
  (padding 1, return_indices) on the channels-last view, and the gather
  route of pool_bwd with its plain version and
  aten.max_pool2d_with_indices_backward; the bytes bound reads the input
  (or the cotangent and the int32 slots) once and writes the output once."""
  for name, shape in STEM_SHAPES:
    x = tied_normal(shape, torch.bfloat16, generator, 'cuda')
    out, slot = pool.pool_fwd(x, STEM_WINDOW, STEM_STRIDES, STEM_PADS)
    lib_vals, indices = library_pool(x, STEM_WINDOW, STEM_STRIDES, STEM_PADS)
    if not torch.equal(lib_vals.permute(0, 2, 3, 1), out):
      raise AssertionError(f'library pool at the {name} stem computes '
                           'another function')
    g = tied_normal(tuple(out.shape), torch.bfloat16, generator, 'cuda')
    windows = out.numel() * STEM_WINDOW[0] * STEM_WINDOW[1]
    nbytes = x.numel() * 2 + out.numel() * (2 + 4)
    fwd = (lambda: pool.pool_fwd(x, STEM_WINDOW, STEM_STRIDES, STEM_PADS),
           lambda: pool.plain_max_pool_argmax(x, STEM_WINDOW, STEM_STRIDES,
                                              STEM_PADS),
           lambda: library_pool(x, STEM_WINDOW, STEM_STRIDES, STEM_PADS))
    bwd = (lambda: pool.pool_bwd(g, slot, shape, STEM_WINDOW, STEM_STRIDES,
                                 STEM_PADS),
           lambda: pool.plain_max_pool_bwd(g, slot, shape, STEM_WINDOW,
                                           STEM_STRIDES, STEM_PADS),
           lambda: library_pool_bwd(g, x, indices, STEM_WINDOW, STEM_STRIDES,
                                    STEM_PADS))
    for entry, (kernel_fn, plain_fn, lib_fn), lib_name in (
        ('pool_fwd_stem', fwd, 'F.max_pool2d'),
        ('pool_bwd_gather', bwd, 'max_pool2d_with_indices_backward')):
      ms = cuda_ms(kernel_fn)
      plain = cuda_ms(plain_fn, iters=5)
      lib = cuda_ms(lib_fn)
      log(f'time {entry} {name} {shape} bf16 window {STEM_WINDOW} strides '
          f'{STEM_STRIDES} pads {STEM_PADS}: kernel {ms:.4f} ms, plain '
          f'{plain:.4f} ms, {lib_name} {lib:.4f} ms, '
          f'{bound_text(nbytes, windows)}')
      if entry == 'pool_bwd_gather':
        device = kernel_device_ms(kernel_fn, ('pool_bwd_gather_kernel',))
        log(f'time {entry} {name} by kernel (profiler, L2 flushed): '
            f'pool_bwd_gather_kernel {device_text(device)}'
            + (f', {nbytes / device / 1e6:.1f} GB/s' if device else ''))
      timing_entry(record, entry, ms, plain, lib, nbytes, windows)
    del x, out, slot, lib_vals, indices, g
  for entry in ('pool_fwd_stem', 'pool_bwd_gather'):
    e = record[entry]
    log(f'time {entry} both towers (a step): kernel {e["ms"]:.4f} ms, plain '
        f'{e["plain_ms"]:.4f} ms, library {e["library_ms"]:.4f} ms, bytes '
        f'bound {e["bytes_ms"]:.4f} ms')


def phase_timing(generator, errors, launches, card):
  record = {}
  for name, shape, window, strides in POOLS:
    x = tied_normal(shape, torch.bfloat16, generator, 'cuda')
    nbytes, pads, ops = pool_bytes(shape, window, strides, 2)
    lib_vals, _ = library_pool(x, window, strides, pads)
    if not torch.equal(lib_vals.permute(0, 2, 3, 1),
                       pool.pool_fwd(x, window, strides, pads)[0]):
      raise AssertionError(f'library pool {name} computes another function')
    ms = cuda_ms(lambda: pool.pool_fwd(x, window, strides, pads))
    plain = cuda_ms(
        lambda: pool.plain_max_pool_argmax(x, window, strides, pads), iters=5)
    lib = cuda_ms(lambda: library_pool(x, window, strides, pads))
    log(f'time pool_fwd {name} {shape} bf16: kernel {ms:.4f} ms, plain '
        f'{plain:.4f} ms, F.max_pool2d {lib:.4f} ms, '
        f'{bound_text(nbytes, ops)}')
    timing_entry(record, 'pool_fwd', ms, plain, lib, nbytes, ops)
    del x, lib_vals

  for name, shape, window, strides in TRAIN_POOLS:
    x = tied_normal(shape, torch.bfloat16, generator, 'cuda')
    pads = pool.resolve_padding('SAME', window, strides, shape[1:3])
    _, slot = pool.pool_fwd(x, window, strides, pads)
    g = tied_normal(tuple(slot.shape), torch.bfloat16, generator, 'cuda')
    _, indices = library_pool(x, window, strides, pads)
    dx = pool.pool_bwd(g, slot, shape, window, strides, pads)
    lib_dx = library_pool_bwd(g, x, indices, window, strides, pads)
    same = torch.equal(lib_dx.permute(0, 2, 3, 1), dx)
    ms = cuda_ms(lambda: pool.pool_bwd(g, slot, shape, window, strides, pads))
    plain = cuda_ms(lambda: pool.plain_max_pool_bwd(
        g, slot, shape, window, strides, pads), iters=5)
    lib = cuda_ms(
        lambda: library_pool_bwd(g, x, indices, window, strides, pads))
    nbytes = slot.numel() * (2 + 4) + x.numel() * 2
    ops = x.numel()  # one slot compare per covering window
    route = pool.bwd_launch(shape, window, strides, pads)['route']
    log(f'time pool_bwd {name} {shape} bf16 ({route}): kernel {ms:.4f} ms, '
        f'plain {plain:.4f} ms, max_pool2d_with_indices_backward {lib:.4f} '
        f'ms (equal to the kernel: {same}), {bound_text(nbytes, ops)}')
    timing_entry(record, 'pool_bwd', ms, plain, lib, nbytes, ops)
    del x, slot, g, indices, dx, lib_dx

  x = torch.rand(CONV1_X, generator=generator, device='cuda').to(
      torch.bfloat16)
  w = (0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')).to(
      torch.bfloat16)
  pads = CONV1_PADS
  x_cl = x.permute(0, 3, 1, 2)
  w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  ms = cuda_ms(lambda: conv_s2d.conv_s2d_fwd(x, w, (2, 2), pads))
  plain = cuda_ms(lambda: conv_s2d.plain_conv2d(x, w, (2, 2), pads), iters=5)
  lib = cuda_ms(lambda: F.conv2d(x_cl, w_cl, stride=2, padding=pads[0][0]))
  pixels = CONV1_X[0] * 236 * 236
  patch = int(np.prod(CONV1_W[:3]))
  nbytes = 2 * (np.prod(CONV1_X) + np.prod(CONV1_W) + pixels * CONV1_W[3])
  ops = 2 * pixels * patch * CONV1_W[3]
  log(f'time conv_s2d_fwd {CONV1_X} bf16: kernel {ms:.4f} ms, plain '
      f'{plain:.4f} ms, F.conv2d {lib:.4f} ms, {bound_text(nbytes, ops)}')
  timing_entry(record, 'conv_s2d_fwd', ms, plain, lib, nbytes, ops)
  del x, w, x_cl, w_cl
  fwd_logged_timing(generator, patch)

  x = torch.rand(TRAIN_CONV1_X, generator=generator, device='cuda').to(
      torch.bfloat16)
  w = (0.1 * torch.randn(CONV1_W, generator=generator, device='cuda')).to(
      torch.bfloat16)
  g = torch.randn((TRAIN_BATCH, 236, 236, 64), generator=generator,
                  device='cuda').to(torch.bfloat16)
  x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
  w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  pixels = TRAIN_BATCH * 236 * 236
  ops = 2 * pixels * patch * CONV1_W[3]
  nbytes = 2 * (np.prod(TRAIN_CONV1_X) + np.prod(CONV1_W) +
                pixels * CONV1_W[3])
  for name, kernel_fn, plain_fn, lib_fn, lib_name in (
      ('conv_s2d_dw',
       lambda: conv_s2d.conv_s2d_dw(x, g, CONV1_W, (2, 2), pads),
       lambda: conv_s2d.plain_conv2d_dw(x, g, CONV1_W, (2, 2), pads),
       lambda: torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, g_cl,
                                           stride=2, padding=2),
       'torch.nn.grad.conv2d_weight'),
      ('conv_s2d_dx',
       lambda: conv_s2d.conv_s2d_dx(g, w, TRAIN_CONV1_X, (2, 2), pads),
       lambda: conv_s2d.plain_conv2d_dx(g, w, TRAIN_CONV1_X, (2, 2), pads),
       lambda: torch.nn.grad.conv2d_input(x_cl.shape, w_oihw, g_cl,
                                          stride=2, padding=2),
       'torch.nn.grad.conv2d_input')):
    ms = cuda_ms(kernel_fn)
    plain = cuda_ms(plain_fn, iters=5)
    lib = cuda_ms(lib_fn)
    route = getattr(conv_s2d, name.replace('conv_s2d_', '') + '_plan')(
        TRAIN_CONV1_X, CONV1_W, (2, 2), pads, torch.bfloat16)['route']
    log(f'time {name} {TRAIN_CONV1_X} bf16 ({route}): kernel {ms:.4f} ms, '
        f'plain {plain:.4f} ms, {lib_name} {lib:.4f} ms, '
        f'{bound_text(nbytes, ops)}')
    timing_entry(record, name, ms, plain, lib, nbytes, ops)
  del x, w, g, x_cl, g_cl, w_oihw
  conv_float32_timing(record, card, generator, patch)

  stem_pool_timing(record, generator)
  flash_timing(record, generator)
  fused_update_timing(record, generator)
  photometric_timing(record, generator)

  kernels = []
  meta = {
      'pool_fwd': ('tensor2robot_tpu_torch/ops/csrc/pool.cu',
                   'tensor2robot_tpu/ops/pool.py:258'),
      'pool_bwd': ('tensor2robot_tpu_torch/ops/csrc/pool.cu',
                   'tensor2robot_tpu/ops/pool.py:284'),
      # The Grasp2Vec stem's overlapping 3x3/s2 pool: the forward's padded
      # 3x3 instantiation and the backward's gather route
      # (pool_bwd_gather_kernel, its 3x3/s2 instantiation).
      'pool_fwd_stem': ('tensor2robot_tpu_torch/ops/csrc/pool.cu',
                        'tensor2robot_tpu/ops/pool.py:258'),
      'pool_bwd_gather': ('tensor2robot_tpu_torch/ops/csrc/pool.cu',
                          'tensor2robot_tpu/ops/pool.py:284'),
      'conv_s2d_fwd': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                       'tensor2robot_tpu/ops/conv_s2d.py:223'),
      'conv_s2d_dw': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                      'tensor2robot_tpu/ops/conv_s2d.py:246'),
      'conv_s2d_dx': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                      'tensor2robot_tpu/ops/conv_s2d.py:269'),
      # conv1's float32 routes on the CUDA cores (conv_fwd_ffma_kernel,
      # conv_dw_ffma_kernel + conv_dw_reduce_kernel, conv_dx_ffma_kernel),
      # launched by the float32 critic's paths.
      'conv_s2d_fwd_float32': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                               'tensor2robot_tpu/ops/conv_s2d.py:223'),
      'conv_s2d_dw_float32': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                              'tensor2robot_tpu/ops/conv_s2d.py:246'),
      'conv_s2d_dx_float32': ('tensor2robot_tpu_torch/ops/csrc/conv_s2d.cu',
                              'tensor2robot_tpu/ops/conv_s2d.py:269'),
      # The staged TPU kernels' sites; the streamed ones (:424, :491,
      # :510) are the same CUDA kernels, checked at the streamed shapes.
      'flash_fwd': ('tensor2robot_tpu_torch/ops/csrc/flash_attention.cu',
                    'tensor2robot_tpu/ops/flash_attention.py:448'),
      'flash_dq': ('tensor2robot_tpu_torch/ops/csrc/flash_attention.cu',
                   'tensor2robot_tpu/ops/flash_attention.py:537'),
      'flash_dkv': ('tensor2robot_tpu_torch/ops/csrc/flash_attention.cu',
                    'tensor2robot_tpu/ops/flash_attention.py:555'),
      'fused_update': ('tensor2robot_tpu_torch/ops/csrc/fused_update.cu',
                       'tensor2robot_tpu/ops/fused_update.py:269'),
      'photometric': ('tensor2robot_tpu_torch/ops/csrc/photometric.cu',
                      'tensor2robot_tpu/ops/photometric.py:72'),
  }
  # conv1's forward and dx rows are their tensor-core kernels, pool_bwd's
  # its scatter route: their own counts.
  counted = {'conv_s2d_fwd': 'conv_s2d_fwd_tensor_core',
             'conv_s2d_dx': 'conv_s2d_dx_tensor_core',
             'pool_bwd': 'pool_bwd_scatter'}
  for name, (source, replaces) in meta.items():
    entry = record[name]
    bytes_ms, ops_ms = entry['bytes_ms'], entry['ops_ms']
    kernels.append({
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': replaces, 'launches': launches[counted.get(name, name)],
        'max_abs_err': errors[name], 'ms': entry['ms'],
        'plain_ms': entry['plain_ms'], 'bound_ms': max(bytes_ms, ops_ms),
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': entry['library_ms'],
    })
    if name == 'flash_fwd':
      kernels[-1]['per_shape'] = record['flash_fwd_per_shape']
    elif name in ('flash_dq', 'flash_dkv'):
      kernels[-1]['per_shape'] = [
          entry for entry in record['flash_bwd_per_shape']
          if entry['kernel'] == name]
  return kernels


def device_time_us(averages, prefix=''):
  """Device time of the kernels' and copies' own rows (device_type CUDA;
  older torch names the device time after CUDA), without the profiler's
  own 'Activity Buffer Request' row, which shadows other activity, and
  without user annotations (e.g. 'Optimizer.step#Adam.step'), whose device
  rows span the kernels they enclose."""
  return sum(
      getattr(e, 'self_device_time_total', None) or
      getattr(e, 'self_cuda_time_total', 0) for e in averages
      if str(getattr(e, 'device_type', '')).endswith('CUDA') and
      e.key != 'Activity Buffer Request' and
      not getattr(e, 'is_user_annotation', False) and
      not e.key.startswith('Optimizer.') and e.key.startswith(prefix))


def activity_buffer_us(averages):
  """The device time of the profiler's own 'Activity Buffer Request' row,
  which device_time_us leaves out; printed beside it."""
  return sum(getattr(e, 'self_device_time_total', None) or
             getattr(e, 'self_cuda_time_total', 0) for e in averages
             if e.key == 'Activity Buffer Request')


def log_activity_row(label, averages, count=1):
  log(f'profile{label}: the \'Activity Buffer Request\' row, left out of '
      f'the device time above: {activity_buffer_us(averages) / count / 1e3:.3f}'
      f' ms{" per action" if count > 1 else ""}')


def phase_profile(policy, frames):
  """Device time by kernel over two actions (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile

  np.random.seed(1)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for t in range(2):
      policy.SelectAction(frames[t], None, t)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=40)
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / 'chip_smoke_profile.txt').write_text(table)
  device_us = device_time_us(averages)
  log(f'profile: {device_us / 2e3:.3f} ms of device kernel time per action '
      f'(2 actions); table in chiprun_out/chip_smoke_profile.txt')
  log_activity_row('', averages, count=2)
  for line in table.splitlines()[:16]:
    log('  ' + line)


@tf32_off()
def phase_profile_reference(seed):
  """The device kernels of phase_train_reference's float32 card step, by
  device time: the names of cuDNN's and cuBLAS's algorithms."""
  from torch.profiler import ProfilerActivity, profile

  state, batch = reference_state(seed)
  reference_gradients(state, batch, seed, 'cuda', 'pool_conv')  # warm-up
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    reference_gradients(state, batch, seed, 'cuda', 'pool_conv')
  rows = sorted((e for e in prof.key_averages()
                 if str(getattr(e, 'device_type', '')).endswith('CUDA')),
                key=lambda e: -(getattr(e, 'self_device_time_total', None) or
                                getattr(e, 'self_cuda_time_total', 0)))
  log('profile reference: the float32 card step\'s device kernels by time '
      f'({cudnn_flags()}):')
  for e in rows[:14]:
    us = (getattr(e, 'self_device_time_total', None) or
          getattr(e, 'self_cuda_time_total', 0))
    log(f'  {us / 1e3:8.3f} ms x{e.count:<4d} {e.key[:160]}')


def phase_profile_train(trainer, seed, label=''):
  """Device time by kernel over one training step (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile

  trainer.config.max_train_steps = trainer.step + 1
  batches = iter(train_batches(seed + 5, 1, TRAIN_BATCH))
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with _dispatch.force_kernels(True):
      trainer.train(batches, None)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=50)
  OUT_DIR.mkdir(exist_ok=True)
  name = f'chip_smoke_profile_train{"_" + label if label else ""}.txt'
  (OUT_DIR / name).write_text(table)
  device_us = device_time_us(averages)
  upload_us = device_time_us(averages, 'Memcpy HtoD')
  kernels = sum(e.count for e in averages
                if str(getattr(e, 'device_type', '')).endswith('CUDA') and
                not e.key.startswith(('Memcpy', 'Memset', 'Activity')))
  log(f'profile{" " + label if label else ""}: {device_us / 1e3:.3f} ms of '
      f'device time per training step, {upload_us / 1e3:.3f} ms of it the '
      f'host-to-device copy of the batch; {kernels} kernel launches; table '
      f'in chiprun_out/{name}')
  log_activity_row(f' {label}' if label else '', averages)
  for line in table.splitlines()[:24]:
    log('  ' + line)


# ------------------------------------------------- K steps per dispatch

DISPATCH_K = 8
DISPATCH_BATCHES = 19     # two graph dispatches and a 3-batch ragged tail
DISPATCH_NAN_AT = 8 + 3   # slot 3 of the second dispatch
DISPATCH_TIMED = 48       # steps a timed run: six dispatches of 8
DISPATCH_TURNS = 2  # 3 until the run's limit needed the seconds
DISPATCH_ACCUM_BATCH = 64
# The binary's run, cut from the config's 1000 steps (run_dispatch_binary),
# and the steps it must commit: the dispatch boundaries on or after 50 and
# 100, and the final step.
# 112 steps until the exported-models phases needed the run's seconds.
DISPATCH_BINARY_STEPS = 64
DISPATCH_BINARY_SAVE_INTERVAL = 50
DISPATCH_BINARY_SAVES = (56, 64)
DISPATCH_MEMORY_BATCHES = (32, 96)
# The M=2 step against the eager accumulation written out: every parameter
# within 1e-6 of its leaf's largest magnitude (the same operations in the
# same order, so bit for bit is expected; the band is stated, not needed).
DISPATCH_ACCUM_BAND = 1e-6
# Kernel rows a replayed dispatch of 8 steps must show in the profiler.
DISPATCH_ROWS = {'pool_fwd_kernel': 24, 'pool_bwd_scatter_kernel': 24,
                 'conv_fwd_mma_kernel': 8, 'conv_dw_mma_kernel': 8,
                 'conv_dw_reduce_kernel': 8}
# Profiled pairs of replays a K=8 arm may take to show all of its rows.
# The profiler's device records are best-effort (CUPTI drops records when
# its buffers run short, as one H100 run lost a step's last backward
# kernels), while a replayed graph launches the same kernels every time:
# a graph short of a kernel shows short in every pair, and a row above
# the count, a missing replay or a Python launch fails at once.
DISPATCH_PROFILE_ATTEMPTS = 3
PLAIN_VERSIONS = ((pool, 'plain_max_pool_argmax'),
                  (pool, 'plain_max_pool_bwd'),
                  (conv_s2d, 'plain_conv2d'), (conv_s2d, 'plain_conv2d_dw'),
                  (conv_s2d, 'plain_conv2d_dx'),
                  (fa, 'plain_flash_fwd'), (fa, 'plain_flash_dq'),
                  (fa, 'plain_flash_dkv'),
                  (fused_update, 'plain_fused_update'))


@contextlib.contextmanager
def counted_plain_calls():
  """Counts calls of every kernel's plain version within the context (a
  card run must make none)."""
  calls = collections.Counter()
  saved = []
  for module, name in PLAIN_VERSIONS:
    fn = getattr(module, name)
    saved.append((module, name, fn))

    def counting(*args, __fn=fn, __name=name, **kwargs):
      calls[__name] += 1
      return __fn(*args, **kwargs)

    setattr(module, name, counting)
  try:
    yield calls
  finally:
    for module, name, fn in saved:
      setattr(module, name, fn)


def dispatch_trainer(seed, k, fused=False, **cfg):
  """A full-width QT-Opt trainer (batch 32, bf16, pool_conv); ``fused``:
  tagged Adam under a decaying rate, the EMA, fused_update and
  skip_update, as the fused training path."""
  kwargs = {}
  if fused:
    kwargs['create_optimizer_fn'] = (
        lambda: optimizers.create_adam_optimizer(
            optimizers.create_exp_decaying_learning_rate_fn(
                1e-3, decay_steps=10, staircase=True)))
    cfg.update(fused_update=True, nonfinite_mode='skip_update')
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv',
                               **kwargs)
  cfg.setdefault('max_train_steps', DISPATCH_BATCHES)
  return Trainer(model, TrainerConfig(model_dir='', log_interval_steps=0,
                                      seed=seed, steps_per_dispatch=k,
                                      **cfg))


def state_mismatches(a, b):
  """Names of the state's parts where two trainers differ bit for bit:
  parameters and batch statistics, optimizer slots and groups, EMA,
  generator, step."""
  bad = [name for (name, x), y in zip(a.state.network.state_dict().items(),
                                      b.state.network.state_dict().values())
         if not same_bits(x, y)]
  if (a.state.ema is None) != (b.state.ema is None):
    bad.append('ema')
  bad += [f'ema {name}' for name in a.state.ema or {}
          if not same_bits(a.state.ema[name], b.state.ema[name])]
  sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
  if sa['param_groups'] != sb['param_groups']:
    bad.append('optimizer groups')
  bad += [f'slot {i} {slot}' for i, slots in sa['state'].items()
          for slot, value in slots.items()
          if not same_bits(value, sb['state'][i][slot])]
  if not torch.equal(a.state.generator.get_state(),
                     b.state.generator.get_state()):
    bad.append('generator')
  if a.step != b.step:
    bad.append(f'step {a.step} != {b.step}')
  return bad


def phase_dispatch(seed, card):
  """K=8 steps per dispatch at full width, under deterministic cuDNN
  without autotuning (restored after the phase), files under a temporary
  directory below ``chiprun_out/`` that the phase removes. Returns the
  launch counts of its main run (the stock K=8 trainer over 19 batches)."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='dispatch_phase_',
                                       dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        _dispatch.force_kernels(True), counted_plain_calls() as plain:
      launches = dispatch_paths(seed, card, root)
    if sum(plain.values()):
      raise AssertionError(f'dispatch phase: plain versions ran {plain}')
    log('dispatch: 0 plain-version calls in the phase')
    return launches
  finally:
    shutil.rmtree(root, ignore_errors=True)


def dispatch_paths(seed, card, root):
  start = time.perf_counter()
  batches = train_batches(seed + 20, DISPATCH_BATCHES, TRAIN_BATCH)
  timed = train_batches(seed + 25, DISPATCH_TIMED, TRAIN_BATCH)
  # The stock arm: QT-Opt's momentum optimizer and EMA.
  zero_counters()
  grouped = dispatch_trainer(seed, DISPATCH_K)
  grouped.train(iter(batches))
  torch.cuda.synchronize()
  launches = read_counters()
  single = dispatch_trainer(seed, 1)
  single.train(iter(batches))
  torch.cuda.synchronize()
  (captured,) = grouped.captured_dispatches.values()
  bad = state_mismatches(single, grouped)
  if bad or captured.replays != 2 or grouped.step != DISPATCH_BATCHES:
    raise AssertionError(
        f'dispatch stock arm: K=8 against K=1 differs in {bad[:8]} '
        f'({len(bad)} parts); {captured.replays} replays, step '
        f'{grouped.step}')
  # Counted at the warm-up and the capture (8 steps each), and on the
  # eager ragged tail (3): a replay runs no Python.
  want = {k: v * (2 * DISPATCH_K + 3) for k, v in TRAIN_LAUNCHES.items()}
  check_launches('dispatch stock K=8 (warm-up + capture + tail)', launches,
                 want)
  log(f'dispatch: stock arm, K=8 over {DISPATCH_BATCHES} batches (2 graph '
      f'replays + a 3-batch eager tail) bit for bit K=1: parameters, batch '
      f'statistics, momentum, groups, EMA, generator, step '
      f'{grouped.step}; capture {captured.capture_ms:.1f} ms one-off '
      f'(warm-up + restore + capture); launch counters {launches}')
  del single, grouped, captured
  torch.cuda.empty_cache()

  # The fused arm: Adam + EMA + skip_update, a NaN batch at slot 3 of
  # dispatch 2.
  fused_batches = train_batches(seed + 21, DISPATCH_BATCHES, TRAIN_BATCH)
  fused_batches[DISPATCH_NAN_AT][0]['action/world_vector'][0, 0] = np.nan
  grouped = dispatch_trainer(seed, DISPATCH_K, fused=True)
  grouped.train(iter(fused_batches))
  single = dispatch_trainer(seed, 1, fused=True)
  single.train(iter(fused_batches))
  torch.cuda.synchronize()
  bad = state_mismatches(single, grouped)
  if (bad or grouped.fused_plan is None or
      grouped.step != DISPATCH_BATCHES - 1 or
      grouped.nonfinite_policy.bad_steps != 1 or
      single.nonfinite_policy.bad_steps != 1):
    raise AssertionError(
        f'dispatch fused arm: K=8 against K=1 differs in {bad[:8]}; step '
        f'{grouped.step}, skips {grouped.nonfinite_policy.bad_steps}')
  log(f'dispatch: fused arm (Adam + EMA + skip_update, a NaN batch at slot '
      f'3 of dispatch 2), K=8 bit for bit K=1: step {grouped.step} of '
      f'{DISPATCH_BATCHES} batches, 1 update skipped, its crop draws taken '
      'by slot 4 (the generator states agree)')
  del single, grouped
  torch.cuda.empty_cache()

  dispatch_remat_and_accum(seed)
  del batches, fused_batches
  dispatch_timings(seed, timed, card)
  del timed
  run_dispatch_binary(root)
  log(f'dispatch: phase {time.perf_counter() - start:.1f} s')
  return launches


def one_step_trainer(seed, batch, **kwargs):
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv',
                               **kwargs.pop('model', {}))
  trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                         log_interval_steps=0, seed=seed,
                                         **kwargs))
  trainer.train(iter([batch]))
  torch.cuda.synchronize()
  return trainer


def forward_activation_gib(trainer, batch):
  """Device memory that a TRAIN forward of ``batch`` holds for its
  backward: memory allocated after the forward and the loss, less
  before (the tensors remat trades against recompute)."""
  model, state = trainer.model, trainer.state
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v).cuda() for k, v in batch[0].items()},
      {k: torch.from_numpy(v).cuda() for k, v in batch[1].items()},
      ModeKeys.TRAIN, torch.Generator().manual_seed(0))
  torch.cuda.synchronize()
  before = torch.cuda.memory_allocated()
  outputs = model.inference_network_fn(state.network, features, labels,
                                       ModeKeys.TRAIN)
  loss, _ = model.model_train_fn(features, labels, outputs, ModeKeys.TRAIN)
  torch.cuda.synchronize()
  held = torch.cuda.memory_allocated() - before
  del loss, outputs
  return held / 2**30


def dispatch_remat_and_accum(seed):
  """Remat against none (one step bit for bit, batch statistics moved
  once; a one-step run's peak memory and the memory a forward holds for
  its backward, at two batches), and M=2 at batch 64 against the eager
  accumulation written out."""
  peaks, held = {}, {}
  for batch_size in DISPATCH_MEMORY_BATCHES:
    batch = train_batches(seed + 22, 1, batch_size)[0]
    trainers = {}
    for policy in ('none', 'conv_towers'):
      torch.cuda.empty_cache()
      torch.cuda.reset_peak_memory_stats()
      trainers[policy] = one_step_trainer(
          seed, batch, model=dict(remat_policy=policy))
      peaks[(batch_size, policy)] = torch.cuda.max_memory_allocated() / 2**30
    if batch_size == TRAIN_BATCH:
      bad = state_mismatches(trainers['none'], trainers['conv_towers'])
      if bad:
        raise AssertionError(f'remat conv_towers differs from none in {bad}')
    for policy, trainer in trainers.items():
      held[(batch_size, policy)] = forward_activation_gib(trainer, batch)
    del trainers
  log('dispatch: remat_policy=conv_towers one step bit for bit none at '
      'batch 32 (batch statistics included: moved once); peak device memory '
      'of a one-step run ' + ', '.join(
          f'batch {b} {p}: {gib:.3f} GiB' for (b, p), gib in peaks.items()) +
      '; held by a forward for its backward ' + ', '.join(
          f'batch {b} {p}: {gib:.3f} GiB' for (b, p), gib in held.items()))
  torch.cuda.empty_cache()

  batch = train_batches(seed + 23, 1, DISPATCH_ACCUM_BATCH)[0]
  trainer = one_step_trainer(seed, batch, grad_accum_microbatches=2)
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  reference = Trainer(model, TrainerConfig(model_dir='', max_train_steps=0,
                                           seed=seed))
  state = reference.initialize(batch[0])
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v).cuda() for k, v in batch[0].items()},
      {k: torch.from_numpy(v).cuda() for k, v in batch[1].items()},
      ModeKeys.TRAIN, state.generator)
  half = DISPATCH_ACCUM_BATCH // 2
  for part in (slice(0, half), slice(half, None)):
    f = {k: v[part] for k, v in features.items()}
    l = {k: v[part] for k, v in labels.items()}
    outputs = model.inference_network_fn(state.network, f, l, ModeKeys.TRAIN)
    loss, _ = model.model_train_fn(f, l, outputs, ModeKeys.TRAIN)
    loss.backward()
  for p in state.network.parameters():
    p.grad.div_(2.0)
  state.optimizer.step()
  torch.cuda.synchronize()
  worst, exact = 0.0, True
  for (name, got), want in zip(trainer.state.network.state_dict().items(),
                               state.network.state_dict().values()):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    exact &= same_bits(got, want)
    if err > DISPATCH_ACCUM_BAND * max(scale, 1e-12):
      raise AssertionError(f'grad_accum_microbatches=2: {name} off by {err}')
    worst = max(worst, err)
  log(f'dispatch: grad_accum_microbatches=2 at batch '
      f'{DISPATCH_ACCUM_BATCH}, one step against the eager accumulation: '
      f'max abs error {worst:.3g} (band {DISPATCH_ACCUM_BAND:g} of each '
      f'leaf\'s largest magnitude), bit for bit: {exact}')
  del trainer, reference, state
  torch.cuda.empty_cache()


class _HostClock:
  """Host time spent in a wrapped callable, per call."""

  def __init__(self, fn):
    self.fn, self.ms = fn, []

  def __call__(self, *args, **kwargs):
    begin = time.perf_counter()
    out = self.fn(*args, **kwargs)
    self.ms.append(1e3 * (time.perf_counter() - begin))
    return out


def dispatch_timings(seed, timed, card):
  """K=1 eager, K=8 graph and K=8 graph with the device feed, in turns on
  the same pre-decoded batches: host ms/step, host ms a dispatch outside
  the replay, the superbatch upload's ms and copies a dispatch."""
  arms = {'K=1 eager': dispatch_trainer(seed, 1),
          'K=8 graph': dispatch_trainer(seed, DISPATCH_K),
          'K=8 graph + device_feed': dispatch_trainer(seed, DISPATCH_K,
                                                      device_feed=True)}
  for trainer in arms.values():  # builds the state, captures
    trainer.config.max_train_steps = DISPATCH_K
    trainer.train(iter(timed[:DISPATCH_K]))
  torch.cuda.synchronize()
  clocks = {}
  for name, trainer in arms.items():
    if trainer.config.steps_per_dispatch > 1:
      (captured,) = trainer.captured_dispatches.values()
      clocks[name] = (_HostClock(trainer._dispatch_group),  # pylint: disable=protected-access
                      _HostClock(captured.replay), [])
      trainer._dispatch_group = clocks[name][0]  # pylint: disable=protected-access
      captured.replay = clocks[name][1]
      feed = trainer._feed  # pylint: disable=protected-access
      finish, uploads = feed.finish, clocks[name][2]

      def timed_finish(staged, release, __finish=finish, __uploads=uploads):
        __finish(staged, release)
        if staged.start is not None:
          __uploads.append(staged.start.elapsed_time(staged.ready))

      feed.finish = timed_finish
  puts = metrics_lib.counter('trainer/h2d/device_puts')
  ms = collections.defaultdict(list)
  copies = {}
  for _ in range(DISPATCH_TURNS):
    for name, trainer in arms.items():
      trainer.config.max_train_steps = trainer.step + DISPATCH_TIMED
      before = puts.value
      torch.cuda.synchronize()
      begin = time.perf_counter()
      trainer.train(iter(timed))
      torch.cuda.synchronize()
      ms[name].append(1e3 * (time.perf_counter() - begin) / DISPATCH_TIMED)
      copies[name] = (puts.value - before) / (DISPATCH_TIMED / DISPATCH_K)
  for name, values in ms.items():
    line = (f'dispatch timing: {name}: host ms/step median '
            f'{statistics.median(values):.3f}, spread {min(values):.3f}-'
            f'{max(values):.3f} over {DISPATCH_TURNS} runs of '
            f'{DISPATCH_TIMED} steps')
    if name in clocks:
      dispatch_ms, replay_ms, uploads = clocks[name]
      outside = statistics.median(dispatch_ms.ms) - statistics.median(
          replay_ms.ms)
      leaves = 4
      line += (f'; host ms a dispatch outside the replay {outside:.3f} '
               f'(the replay call {statistics.median(replay_ms.ms):.3f}); '
               f'superbatch upload {statistics.median(uploads):.3f} ms '
               f'({min(uploads):.3f}-{max(uploads):.3f}, 251.7 MB pinned); '
               + (f'{copies[name]:g} trainer/h2d/device_puts a dispatch'
                  if 'feed' in name else
                  f'{leaves} leaf copies a dispatch') +
               ' (+ the rates and draws, 2 small copies)')
    log(line + f' on {card}')
  del arms, clocks
  torch.cuda.empty_cache()
  return ms


def run_dispatch_binary(root):
  """The trainer binary on the port's train_qtopt.gin, steps_per_dispatch
  = 8 live, in a subprocess; it must exit 0, commit the final step and
  save at dispatch boundaries: the first on or after each multiple of the
  save interval (56), then the final step (64). The config's own
  1000 steps are bound by the host's random input generator (it draws
  31.5 MB of uint8 a batch; the phase prints the seconds one draw takes),
  not by depth, so the run is cut by binding ``DISPATCH_BINARY_STEPS`` and
  a save interval of ``DISPATCH_BINARY_SAVE_INTERVAL``."""
  repo = pathlib.Path(__file__).resolve().parent
  model = GraspingModelWrapper(device_type='gpu', kernel_policy='pool_conv')
  generator = input_generators.DefaultRandomInputGenerator(
      batch_size=TRAIN_BATCH)
  generator.set_specification_from_model(model, ModeKeys.TRAIN)
  draws = generator.create_iterator(ModeKeys.TRAIN)
  next(draws)
  begin = time.perf_counter()
  next(draws)
  draw_s = time.perf_counter() - begin
  model_dir = root / 'binary'
  cmd = [sys.executable, '-m', 'tensor2robot_tpu_torch.bin.run_t2r_trainer',
         '--gin_configs', str(repo / QTOPT_GIN),
         '--gin_bindings',
         f'train_eval_model.max_train_steps = {DISPATCH_BINARY_STEPS}',
         '--gin_bindings', 'train_eval_model.save_interval_steps = '
         f'{DISPATCH_BINARY_SAVE_INTERVAL}',
         '--gin_bindings', f"train_eval_model.model_dir = '{model_dir}'"]
  start = time.perf_counter()
  proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                        timeout=900, check=False)
  seconds = time.perf_counter() - start
  manager_dir = str(model_dir / 'checkpoints')
  step = ckpt_lib.latest_checkpoint_step(manager_dir)
  steps = sorted(int(n.split('_')[1]) for n in os.listdir(manager_dir)
                 if n.startswith('ckpt_') and '.' not in n) if (
                     os.path.isdir(manager_dir)) else []
  if (proc.returncode != 0 or step != DISPATCH_BINARY_STEPS or
      steps != list(DISPATCH_BINARY_SAVES)):
    raise AssertionError(
        f'dispatch binary: exit {proc.returncode}, newest committed step '
        f'{step}, steps {steps}; its output ended:\n{proc.stdout[-3000:]}\n'
        f'{proc.stderr[-3000:]}')
  log(f'dispatch: python -m tensor2robot_tpu_torch.bin.run_t2r_trainer '
      f'--gin_configs {QTOPT_GIN} (steps_per_dispatch = 8; cut: '
      f'max_train_steps {DISPATCH_BINARY_STEPS} of the config\'s 1000, '
      f'save_interval_steps {DISPATCH_BINARY_SAVE_INTERVAL}: the host\'s '
      'DefaultRandomInputGenerator '
      f'takes {draw_s:.3f} s to draw one batch, so 1000 steps would take '
      f'{1000 * draw_s:.0f} s or more) exited 0 in {seconds:.1f} s, '
      f'committed steps {steps}')


def profile_dispatches(name, trainer, batches, want, steps=2 * DISPATCH_K):
  """Device ms a step and kernel rows (torch.profiler) over ``steps`` more
  steps of ``trainer`` on ``batches()`` (an iterator of host batches),
  every Python launch counter zeroed just before. At K > 1 the steps are
  two replays, whose rows must read ``want`` with one ``cudaGraphLaunch``
  a replay and no Python launch: a pair that the profiler delivered short
  is profiled again, up to ``DISPATCH_PROFILE_ATTEMPTS`` pairs, and a row
  above its count, a third graph launch or a Python launch fails at once.
  An eager K=1 run records the card's activity only: its device time is
  all that is read there. Returns the device ms a step, host-to-device
  copies included."""
  from torch.profiler import ProfilerActivity, profile

  k = trainer.config.steps_per_dispatch
  activities = [ProfilerActivity.CUDA]
  if k > 1:
    activities.append(ProfilerActivity.CPU)
  for attempt in range(1, DISPATCH_PROFILE_ATTEMPTS + 1):
    trainer.config.max_train_steps = trainer.step + steps
    torch.cuda.synchronize()
    zero_counters()
    with profile(activities=activities) as prof:
      trainer.train(batches(), None)
      torch.cuda.synchronize()
    python_launches = read_counters()
    averages = prof.key_averages()
    device_ms = device_time_us(averages) / 1e3 / steps
    h2d_ms = device_time_us(averages, 'Memcpy HtoD') / 1e3 / steps
    rows = {kernel: sum(e.count for e in averages if kernel in e.key)
            for kernel in want}
    graph_launches = sum(e.count for e in averages
                         if e.key.startswith('cudaGraphLaunch'))
    h2d = sum(e.count for e in averages if e.key.startswith('Memcpy HtoD'))
    log(f'dispatch profile: {name}: device {device_ms:.3f} ms/step '
        f'({h2d_ms:.3f} of it host-to-device copies); over {steps} steps: '
        f'kernel rows {rows}, cudaGraphLaunch {graph_launches}, '
        f'host-to-device copies {h2d}; Python launch counters '
        f'{python_launches}')
    if k == 1:
      return device_ms
    short = rows != want or graph_launches != 2
    if (any(python_launches.values()) or graph_launches > 2 or
        any(rows[kernel] > n for kernel, n in want.items()) or
        (short and attempt == DISPATCH_PROFILE_ATTEMPTS)):
      raise AssertionError(
          f'dispatch profile {name}: rows {rows}, expected {want}; '
          f'{graph_launches} cudaGraphLaunch; Python counters '
          f'{python_launches} (a replay runs no Python); profiled pair '
          f'{attempt} of {DISPATCH_PROFILE_ATTEMPTS}')
    if not short:
      return device_ms
    lost = sum(want.values()) - sum(rows.values())
    log(f'dispatch profile: {name}: the profiler delivered {lost} fewer '
        f'kernel rows and {2 - graph_launches} fewer cudaGraphLaunch than 2 '
        f'replays launch (pair {attempt} of {DISPATCH_PROFILE_ATTEMPTS}); '
        'profiling the next 2 dispatches')
  raise AssertionError('unreachable')


def phase_dispatch_profile(seed):
  """Kernel rows over two replays (torch.profiler) of the stock and the
  fused K=8 trainers, with the device ms a step of K=1 eager, K=8 graph
  and K=8 graph with the device feed (``profile_dispatches``). Runs after
  the timing phase: a profiler session early in a process left later
  sessions empty."""
  batches = train_batches(seed + 24, 3 * DISPATCH_K, TRAIN_BATCH)
  arms = (('K=1 eager', 1, {}), ('K=8 graph', DISPATCH_K, {}),
          ('K=8 graph + device_feed', DISPATCH_K, dict(device_feed=True)),
          ('K=8 graph, fused', DISPATCH_K, dict(fused=True)))
  with cudnn_settings(deterministic=True, benchmark=False), \
      _dispatch.force_kernels(True), counted_plain_calls() as plain:
    for name, k, cfg in arms:
      trainer = dispatch_trainer(seed, k, max_train_steps=DISPATCH_K, **cfg)
      trainer.train(iter(batches[:DISPATCH_K]))
      want = {kernel: 2 * n for kernel, n in DISPATCH_ROWS.items()}
      want['fused_update_kernel'] = 2 * DISPATCH_K if cfg.get('fused') else 0
      profile_dispatches(f'QT-Opt {name}', trainer,
                         lambda: iter(batches[DISPATCH_K:]), want)
      del trainer
      torch.cuda.empty_cache()
  if sum(plain.values()):
    raise AssertionError(f'dispatch profile: plain versions ran {plain}')


# ------------------------------------------------------------- Grasp2Vec

GRASP2VEC_GIN = (
    'tensor2robot_tpu_torch/research/grasp2vec/configs/train_grasp2vec.gin')
GRASP2VEC_BATCH = 16
GRASP2VEC_KEYS = ('pregrasp_image', 'postgrasp_image', 'goal_image')
GRASP2VEC_SHARDS = 4
GRASP2VEC_PER_SHARD = 12
GRASP2VEC_STEPS = 3
GRASP2VEC_FUSED_STEPS = 3
GRASP2VEC_SAVE_STEPS = 12  # the in-process save window: saves after 4, 8
# The binary: its steps and save interval (saves at 2 and 4), one eval
# batch at the end.
GRASP2VEC_BINARY_STEPS = 4
GRASP2VEC_BINARY_SAVES = (2, 4)
GRASP2VEC_FRAMES = 2  # frame triples served from the checkpoint
# The ResNet stem's 3x3/s2 max pool with (1, 1) padding (windows overlap:
# the backward's gather route), at the two towers' shapes in bfloat16.
STEM_WINDOW, STEM_STRIDES, STEM_PADS = (3, 3), (2, 2), ((1, 1), (1, 1))
STEM_SHAPES = (('scene', (2 * GRASP2VEC_BATCH, 236, 236, 64)),
               ('goal', (GRASP2VEC_BATCH, 236, 236, 64)))
# Launches a Grasp2Vec training step: each tower's stem pool forward and
# its backward on the gather route; an eval or serving batch runs both
# forwards.
GRASP2VEC_STEP_LAUNCHES = {**NO_QTOPT, **NO_FLASH, **NO_FUSED,
                           'pool_fwd': 2, 'pool_bwd': 2}
GRASP2VEC_FORWARD_LAUNCHES = {**NO_QTOPT, **NO_FLASH, **NO_FUSED,
                              'pool_fwd': 2}

# Runs the trainer binary's main unchanged and prints, as its last stdout
# line, the pool kernels' launches, the plain versions' calls, the host ms
# of each training step (synchronised, from a callback added to every
# Trainer) and the peak device memory.
GRASP2VEC_BINARY = '''
import json, sys, time
import torch
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.ops import pool
from tensor2robot_tpu_torch.train import trainer as trainer_lib
plain = {'pool': 0}
for name in ('plain_max_pool_argmax', 'plain_max_pool_bwd'):
  def counted(*args, fn=getattr(pool, name), **kwargs):
    plain['pool'] += 1
    return fn(*args, **kwargs)
  setattr(pool, name, counted)
def sync():
  if torch.cuda.is_available():
    torch.cuda.synchronize()
class StepClock(trainer_lib.TrainerCallback):
  def __init__(self):
    self.ms, self.last = [], None
  def begin(self, trainer):
    sync()
    self.last = time.perf_counter()
  def after_step(self, trainer, step, scalars):
    sync()
    now = time.perf_counter()
    self.ms.append(1e3 * (now - self.last))
    self.last = now
clock = StepClock()
init = trainer_lib.Trainer.__init__
def with_clock(self, *args, **kwargs):
  init(self, *args, **kwargs)
  self._callbacks.append(clock)
trainer_lib.Trainer.__init__ = with_clock
run_t2r_trainer.main(sys.argv[1:])
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
print(json.dumps({'pool_fwd': pool.pool_fwd.launches,
                  'pool_bwd': pool.pool_bwd.launches,
                  'pool_bwd_scatter': pool.pool_bwd.scatter_launches,
                  'plain': plain['pool'], 'step_ms': clock.ms,
                  'peak_gib': peak / 2**30}))
'''


def write_grasp2vec_shards(root, seed):
  """GRASP2VEC_SHARDS TFRecord shards of GRASP2VEC_PER_SHARD Grasp2Vec
  examples at the model's in-specs (three seeded 512x640x3 uint8 frames
  under the spec names 'image', 'postgrasp_image' and 'present_image', as
  PNG at zlib level 1), each with its index sidecar. Returns the paths, the
  bytes written and the seconds taken."""
  from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel

  pre = Grasp2VecModel().preprocessor
  spec = dict(pre.get_in_feature_specification(ModeKeys.TRAIN).items())
  rng = np.random.RandomState(seed + 31)
  values = [[{key: rng.randint(0, 256, spec[key].shape, dtype=np.uint8)
              for key in GRASP2VEC_KEYS}
             for _ in range(GRASP2VEC_PER_SHARD)]
            for _ in range(GRASP2VEC_SHARDS)]
  start = time.perf_counter()

  def write(shard):
    path = str(root / f'grasp2vec-{shard:05d}-of-{GRASP2VEC_SHARDS:05d}'
               '.tfrecord')
    records.write_examples(path, [
        example_codec.encode_example(spec, value, png_level=1)
        for value in values[shard]])
    shard_index.write_index(path)
    return path

  with concurrent.futures.ThreadPoolExecutor(GRASP2VEC_SHARDS) as pool_:
    paths = list(pool_.map(write, range(GRASP2VEC_SHARDS)))
  return (paths, sum(pathlib.Path(p).stat().st_size for p in paths),
          time.perf_counter() - start)


def phase_check_stem_pool(generator):
  """The stem pool's kernels at the Grasp2Vec towers' shapes in bfloat16
  against their plain versions, bit for bit: the forward's values and
  slots, and the backward (the gather route) with NaN, -0.0 and infinite
  cotangents planted."""
  for name, shape in STEM_SHAPES:
    x = tied_normal(shape, torch.bfloat16, generator, 'cuda')
    out, slot = pool.pool_fwd(x, STEM_WINDOW, STEM_STRIDES, STEM_PADS)
    want = pool.plain_max_pool_argmax(x, STEM_WINDOW, STEM_STRIDES,
                                      STEM_PADS)
    g = tied_normal(tuple(out.shape), torch.bfloat16, generator, 'cuda')
    g.view(-1)[::97] = float('nan')
    g.view(-1)[5::101] = -0.0
    g.view(-1)[7::103] = float('-inf')
    dx = pool.pool_bwd(g, slot, shape, STEM_WINDOW, STEM_STRIDES, STEM_PADS)
    want_dx = pool.plain_max_pool_bwd(g, slot, shape, STEM_WINDOW,
                                      STEM_STRIDES, STEM_PADS)
    torch.cuda.synchronize()
    launch = pool.bwd_launch(shape, STEM_WINDOW, STEM_STRIDES, STEM_PADS)
    if not (same_bits(out, want[0]) and torch.equal(slot, want[1])):
      raise AssertionError(f'pool_fwd at the {name} stem {shape} differs')
    if not same_bits(dx, want_dx) or launch['route'] != pool.ROUTE_GATHER:
      raise AssertionError(f'pool_bwd at the {name} stem {shape} differs '
                           f'(route {launch["route"]})')
    log(f'check stem pool {name} {shape} bf16 window {STEM_WINDOW} strides '
        f'{STEM_STRIDES} pads {STEM_PADS}: pool_fwd bitwise (values and '
        f'slots), pool_bwd bit for bit on the {launch["route"]} route '
        f'({launch["vec"]} channels a thread)')
    del x, out, slot, want, g, dx, want_dx
  return 0.0


def grasp2vec_model(**kwargs):
  """The port's train_grasp2vec.gin model: ResNet-50 v2 towers, 472x472
  crops, bfloat16 activations, float32 parameters, Adam at 1e-4, the stem
  pools on the kernels."""
  from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel

  return Grasp2VecModel(scene_size=(472, 472), goal_size=(472, 472),
                        kernel_policy='pool', **kwargs)


def grasp2vec_generator(paths, seed, **kwargs):
  gen = input_generators.DefaultRecordInputGenerator(
      file_patterns=','.join(paths), batch_size=GRASP2VEC_BATCH, seed=seed,
      **kwargs)
  gen.set_specification_from_model(grasp2vec_model(), ModeKeys.TRAIN)
  return gen


@contextlib.contextmanager
def stock_adam_shadow(model, worst):
  """Within the context, every fused update (``fused_update.apply_update``)
  is held to the stock ``Adam.step`` on copies of the same parameters,
  gradients and moments: parameters and both moments within FUSED_BAND
  (atol, rtol). ``worst`` collects each update's largest error."""
  real = fused_update.apply_update
  atol, rtol = FUSED_BAND

  def checked(plan, optimizer, *args, **kwargs):
    params = [p for group in optimizer.param_groups for p in group['params']]
    shadow = [torch.nn.Parameter(p.detach().clone()) for p in params]
    for twin, param in zip(shadow, params):
      twin.grad = None if param.grad is None else param.grad.clone()
    stock = model.create_optimizer()(shadow)
    # A deep copy: load_state_dict keeps the very moment tensors it is
    # given where device and dtype agree, and the stock step updates them
    # in place.
    stock.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    stock.step()
    applied = real(plan, optimizer, *args, **kwargs)
    err = 0.0
    for index, (twin, param) in enumerate(zip(shadow, params)):
      pairs = [('param', param.detach(), twin.detach())]
      pairs += [(slot, optimizer.state[param][slot], stock.state[twin][slot])
                for slot in ('mu', 'nu')]
      for what, got, want in pairs:
        diff = (got - want).abs()
        if not bool((diff <= atol + rtol * want.abs()).all()):
          worst_at = int(diff.argmax())
          raise AssertionError(
              f'fused update {len(worst) + 1}, leaf {index} {what}: outside '
              f'(atol {atol}, rtol {rtol}) of the stock Adam.step, '
              f'{float(diff.max())} at {float(got.flatten()[worst_at])} '
              f'against {float(want.flatten()[worst_at])} (gradient '
              f'{float(twin.grad.flatten()[worst_at])})')
        err = max(err, float(diff.max()))
    worst.append(err)
    return applied

  fused_update.apply_update = checked
  try:
    yield
  finally:
    fused_update.apply_update = real


def run_grasp2vec_binary(root, paths):
  """The trainer binary on the port's train_grasp2vec.gin through
  GRASP2VEC_BINARY, cut to GRASP2VEC_BINARY_STEPS steps with saves every 2
  and one eval batch at the end; it must exit 0, commit the saves, launch
  the stem kernels for every step and eval batch and call no plain
  version. Returns its model_dir, its report and its seconds."""
  repo = pathlib.Path(__file__).resolve().parent
  model_dir = root / 'binary'
  patterns = ','.join(paths)
  bindings = [
      f"train_eval_model.model_dir = '{model_dir}'",
      f"train/DefaultRecordInputGenerator.file_patterns = '{patterns}'",
      f"eval/DefaultRecordInputGenerator.file_patterns = '{patterns}'",
      f'train_eval_model.max_train_steps = {GRASP2VEC_BINARY_STEPS}',
      'train_eval_model.save_interval_steps = 2',
      'train_eval_model.eval_steps = 1']
  cmd = [sys.executable, '-c', GRASP2VEC_BINARY,
         '--gin_configs', str(repo / GRASP2VEC_GIN)]
  for binding in bindings:
    cmd += ['--gin_bindings', binding]
  start = time.perf_counter()
  proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                        timeout=900, check=False)
  seconds = time.perf_counter() - start
  manager_dir = model_dir / 'checkpoints'
  steps = sorted(int(n.split('_')[1]) for n in os.listdir(manager_dir)
                 if n.startswith('ckpt_') and '.' not in n) if (
                     manager_dir.is_dir()) else []
  report = {}
  if proc.returncode == 0 and proc.stdout.strip():
    report = json.loads(proc.stdout.strip().splitlines()[-1])
  want = {'pool_fwd': 2 * GRASP2VEC_BINARY_STEPS + 2,
          'pool_bwd': 2 * GRASP2VEC_BINARY_STEPS, 'pool_bwd_scatter': 0,
          'plain': 0}
  got = {key: report.get(key) for key in want}
  if (proc.returncode != 0 or steps != list(GRASP2VEC_BINARY_SAVES) or
      got != want or
      ckpt_lib.latest_checkpoint_step(str(manager_dir)) !=
      GRASP2VEC_BINARY_STEPS):
    raise AssertionError(
        f'grasp2vec binary: exit {proc.returncode}, committed steps {steps}, '
        f'launches {got} (expected {want}); its output ended:\n'
        f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
  return model_dir, report, seconds


def phase_grasp2vec(seed, card, device='cuda'):
  """Grasp2Vec at the reference config's full width from record shards
  (see the module docstring, 12b). Returns the path's launch counts, the
  in-process trainer and a batch for the profile phase."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='grasp2vec_phase_',
                                       dir=OUT_DIR))
  try:
    with _dispatch.force_kernels(True):
      return grasp2vec_paths(seed, card, root, device)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def grasp2vec_paths(seed, card, root, device):
  from tensor2robot_tpu_torch.research.grasp2vec import visualization

  begin = time.perf_counter()
  paths, nbytes, write_s = write_grasp2vec_shards(root, seed)
  log(f'grasp2vec: {GRASP2VEC_SHARDS} shards of {GRASP2VEC_PER_SHARD} '
      f'examples (3 frames of 512x640x3 uint8 PNG each, zlib level 1), '
      f'{nbytes / 1e6:.1f} MB, written in {write_s:.2f} s')
  total = {name: 0 for name in read_counters()}

  def add(launches):
    for name, value in launches.items():
      total[name] += value

  # 1. In process: Trainer steps at batch 16 from the record feed, the
  # counters zeroed just before and read just after, no plain call.
  gen = grasp2vec_generator(paths, seed)
  it = gen.create_iterator(ModeKeys.TRAIN)
  model = grasp2vec_model()
  window = SaveWindow()
  trainer = Trainer(model, TrainerConfig(model_dir='', max_train_steps=1,
                                         log_interval_steps=0, seed=seed),
                    callbacks=[window], device=device)
  try:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    trainer.train(it, None)  # builds the state; warm-up step
    torch.cuda.synchronize()
    add(read_counters())
    state = trainer.state
    params = dict(state.network.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    trainer.config.max_train_steps = 1 + GRASP2VEC_STEPS
    copies = pool.MaxPoolArgmax.cotangent_copies
    with counted_plain_calls() as plain:
      zero_counters()
      start = time.perf_counter()
      scalars = trainer.train(it, None)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
      launches = read_counters()
  finally:
    it.close()
  copies = pool.MaxPoolArgmax.cotangent_copies - copies
  peak = torch.cuda.max_memory_allocated()
  add(launches)
  want = {k: v * GRASP2VEC_STEPS for k, v in GRASP2VEC_STEP_LAUNCHES.items()}
  if launches != want or sum(plain.values()) or (
      trainer.step != 1 + GRASP2VEC_STEPS):
    raise AssertionError(f'grasp2vec: launches over {GRASP2VEC_STEPS} steps '
                         f'{launches}, expected {want}; plain calls {plain}')
  if not all(np.isfinite(v) for v in scalars.values()):
    raise AssertionError(f'grasp2vec: non-finite summaries {scalars}')
  for name, param in params.items():
    if param.grad is None or not bool(torch.isfinite(param.grad).all()):
      raise AssertionError(f'grasp2vec {name}: gradient {param.grad!r}')
  moved = sum(not torch.equal(p.detach(), before[k])
              for k, p in params.items())
  ms_per_step = 1e3 * seconds / GRASP2VEC_STEPS
  log(f'grasp2vec: {GRASP2VEC_STEPS} steps at batch {GRASP2VEC_BATCH} '
      f'(ResNet-50 v2 towers, 472x472, bf16, Adam 1e-4, record-fed), '
      f'{ms_per_step:.3f} ms/step (host clock, synchronised), embed_loss '
      f'{scalars["embed_loss"]:.4f}, {len(params)} parameters with finite '
      f'gradients, {moved} moved; launches {launches} (per step 2 pool_fwd, '
      f'2 pool_bwd on the gather route), plain calls 0; cotangent layout '
      f'copies {copies / GRASP2VEC_STEPS:g} per step; peak device memory '
      f'{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the '
      f'{base / 2**30:.3f} GiB held before the phase) on {card}')

  # 2. The fused arm: the same model with fused_update=True over pre-read
  # batches, each update held to the stock Adam.step on the same inputs.
  plain_it = grasp2vec_generator(paths, seed + 1, engine_workers=0)
  decoded = plain_it.create_iterator(ModeKeys.TRAIN)
  try:
    batches = list(itertools.islice(decoded, 1 + GRASP2VEC_FUSED_STEPS))
  finally:
    decoded.close()
  fused_model = grasp2vec_model()
  fused = Trainer(fused_model, TrainerConfig(
      model_dir='', max_train_steps=1 + GRASP2VEC_FUSED_STEPS,
      log_interval_steps=0, seed=seed, fused_update=True), device=device)
  worst = []
  with stock_adam_shadow(fused_model, worst), counted_plain_calls() as plain:
    zero_counters()
    fused.train(iter(batches), None)
    torch.cuda.synchronize()
    fused_launches = read_counters()
  add(fused_launches)
  leaves = len(list(fused.state.network.parameters()))
  steps = 1 + GRASP2VEC_FUSED_STEPS
  want = {k: v * steps for k, v in GRASP2VEC_STEP_LAUNCHES.items()}
  want['fused_update'] = steps * -(-leaves // fused_update.LEAVES_PER_LAUNCH)
  if (fused.fused_plan is None or fused_launches != want or
      len(worst) != steps or sum(plain.values())):
    raise AssertionError(f'grasp2vec fused: launches {fused_launches}, '
                         f'expected {want}; {len(worst)} updates checked; '
                         f'plain calls {plain}')
  log(f'grasp2vec fused: {steps} steps with fused_update=True over '
      f'{leaves} leaves, {want["fused_update"] // steps} fused_update launch '
      f'a step; each update within (atol, rtol) {FUSED_BAND} of the stock '
      f'Adam.step on copies of the same parameters, gradients and moments '
      f'(largest error a step {[f"{e:.3g}" for e in worst]}; no leaf left '
      f'out: every update is compared on its own gradients); launches '
      f'{fused_launches}')
  del fused

  # 2b. Saves: GRASP2VEC_SAVE_STEPS more steps of the in-process trainer on
  # the pre-read batches, its state saved through an async
  # CheckpointManager after the 4th and the 8th (the staging allocated
  # beforehand, as Trainer.initialize allocates it); the 2nd-4th have no
  # save in them.
  manager = ckpt_lib.CheckpointManager(str(root / 'saves'), async_save=True)
  prepare_ms, _ = synced_ms(lambda: manager.prepare(
      train_state.state_dict(trainer.state)))
  log(f'grasp2vec: the save\'s page-locked staging allocated in '
      f'{prepare_ms:.1f} ms, as the trainer allocates it when it builds its '
      f'state with a model_dir, on {card}')
  start = trainer.step
  window.arm(manager, (start + 4, start + 8))
  trainer.config.max_train_steps = start + GRASP2VEC_SAVE_STEPS
  with counted_plain_calls() as plain:
    zero_counters()
    trainer.train(itertools.cycle(batches), None)
    torch.cuda.synchronize()
    save_launches = read_counters()
  manager.close()
  add(save_launches)
  want = {k: v * GRASP2VEC_SAVE_STEPS
          for k, v in GRASP2VEC_STEP_LAUNCHES.items()}
  if save_launches != want or sum(plain.values()):
    raise AssertionError(f'grasp2vec saves: launches {save_launches}, '
                         f'expected {want}; plain calls {plain}')
  size_mb = pathlib.Path(ckpt_lib.state_path(str(
      root / 'saves' / f'ckpt_{start + 4}'))).stat().st_size / 1e6
  log_save_split('grasp2vec', window.step_ms,
                 (start + 2, start + 3, start + 4), window.saves, size_mb,
                 card)

  # 3. The binary on the port's gin.
  model_dir, report, binary_s = run_grasp2vec_binary(root, paths)
  add({'pool_fwd': report['pool_fwd'], 'pool_bwd': report['pool_bwd']})
  step_ms = report['step_ms']
  log(f'grasp2vec: python -m tensor2robot_tpu_torch.bin.run_t2r_trainer '
      f'--gin_configs {GRASP2VEC_GIN} (batch {GRASP2VEC_BATCH}, ResNet-50, '
      f'472x472, bf16, kernel_policy pool; cut: max_train_steps '
      f'{GRASP2VEC_BINARY_STEPS} of the config\'s 100000, saves every 2, '
      f'eval_steps 1) exited 0 in {binary_s:.1f} s, committed steps '
      f'{list(GRASP2VEC_BINARY_SAVES)}; its steps '
      f'{[round(ms, 3) for ms in step_ms]} ms (host clock, synchronised; the '
      f'first builds the state and picks cuDNN\'s algorithms); launches '
      f'pool_fwd {report["pool_fwd"]}, pool_bwd {report["pool_bwd"]} '
      f'(scatter {report["pool_bwd_scatter"]}), plain calls '
      f'{report["plain"]}; peak device memory {report["peak_gib"]:.3f} GiB; '
      f'{card}')

  # 4. Serving from the binary's checkpoint, deterministic cuDNN: the
  # embeddings and heatmap keypoints of CheckpointPredictor bit for bit the
  # in-process network's in eval mode.
  serve_model = grasp2vec_model()
  rng = np.random.RandomState(seed + 37)
  frames = {key: rng.randint(0, 256, (GRASP2VEC_FRAMES, 512, 640, 3),
                             dtype=np.uint8) for key in GRASP2VEC_KEYS}
  with cudnn_settings(deterministic=True, benchmark=False):
    predictor = CheckpointPredictor(serve_model, model_dir=str(model_dir),
                                    device=device)
    if not predictor.restore():
      raise AssertionError('grasp2vec: CheckpointPredictor restored nothing')
    zero_counters()
    served = predictor.predict(frames)
    torch.cuda.synchronize()
    serve_launches = read_counters()
    add(serve_launches)
    network = serve_model.create_module().to(device)
    payload = torch.load(ckpt_lib.state_path(str(
        model_dir / 'checkpoints' / f'ckpt_{GRASP2VEC_BINARY_STEPS}')),
                         map_location=device, weights_only=True)
    network.load_state_dict(payload['network'])
    with torch.no_grad():
      features, _ = serve_model.preprocessor.preprocess(
          {k: torch.from_numpy(v).to(device) for k, v in frames.items()},
          None, ModeKeys.PREDICT)
      outputs = serve_model.inference_network_fn(network, features, None,
                                                  ModeKeys.PREDICT)
      want_points = visualization.heatmap_keypoints(outputs['goal_vector'],
                                                    outputs['pre_spatial'])
      got_points = visualization.heatmap_keypoints(
          torch.from_numpy(served['goal_vector']).to(device),
          torch.from_numpy(served['pre_spatial']).to(device))
    torch.cuda.synchronize()
  if serve_launches != GRASP2VEC_FORWARD_LAUNCHES:
    raise AssertionError(f'grasp2vec serving: launches {serve_launches}, '
                         f'expected {GRASP2VEC_FORWARD_LAUNCHES}')
  for name, value in outputs.items():
    if not same_bits(torch.from_numpy(served[name]),
                     value.float().cpu()):
      raise AssertionError(f'grasp2vec serving: {name} differs from the '
                           'in-process network')
  if not same_bits(got_points.cpu(), want_points.cpu()):
    raise AssertionError('grasp2vec serving: heatmap keypoints differ')
  if not np.isfinite(served['pre_vector']).all():
    raise AssertionError('grasp2vec serving: non-finite embeddings')
  log(f'grasp2vec serving: CheckpointPredictor restored step '
      f'{GRASP2VEC_BINARY_STEPS} of the binary\'s model_dir; on '
      f'{GRASP2VEC_FRAMES} frame triples its {sorted(served)} and the '
      f'heatmap keypoints {np.array2string(got_points.cpu().numpy(), precision=4)}'
      f' bit for bit the in-process network\'s in eval mode; launches '
      f'{serve_launches}')
  log(f'grasp2vec: phase took {time.perf_counter() - begin:.1f} s')
  return total, ms_per_step, trainer, batches[0]


def phase_grasp2vec_profile(trainer, batch):
  """Device time by op over two Grasp2Vec training steps (torch.profiler),
  on the phase's trainer and one pre-read batch; after the other profile
  phases, since an early profiler session left later ones empty."""
  from torch.profiler import ProfilerActivity, profile

  with _dispatch.force_kernels(True):
    trainer.config.max_train_steps = trainer.step + 1
    trainer.train(iter([batch]), None)
    torch.cuda.synchronize()
    trainer.config.max_train_steps = trainer.step + 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      trainer.train(iter([batch, batch]), None)
      torch.cuda.synchronize()
  averages = prof.key_averages()
  table = averages.table(sort_by='self_cuda_time_total', row_limit=40)
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / 'chip_smoke_profile_grasp2vec.txt').write_text(table)
  device_us = device_time_us(averages) / 2
  log(f'grasp2vec profile: {device_us / 1e3:.3f} ms of device time a '
      f'training step (2 steps, batch {GRASP2VEC_BATCH}); table in '
      'chiprun_out/chip_smoke_profile_grasp2vec.txt')
  log_activity_row(' grasp2vec', averages)
  for line in table.splitlines()[:28]:
    log('  ' + line)
  return device_us / 1e3


# ------------------------------------ SNAIL and Grasp2Vec at K=8 a dispatch

# The SNAIL arms cycle this many distinct host batches (405.5 MB each on
# long-horizon).
MODEL_DISPATCH_BATCHES = 4
# Host-clock turns (K=1, K=8, K=8, K=1) of this many steps each: two
# dispatches on SNAIL, whose host assembles a superbatch of up to 3.24 GB
# before the first one; one on Grasp2Vec, whose dispatch takes 2 s of
# device time.
SNAIL_TIMED_STEPS = 2 * DISPATCH_K
GRASP2VEC_TIMED_STEPS = DISPATCH_K
# Steps of the K=1 eager profile.
MODEL_K1_PROFILED = 4
# Kernel rows a replayed dispatch of 8 steps must show in the profiler: two
# attention blocks a SNAIL step, two stem pools a Grasp2Vec step.
SNAIL_DISPATCH_ROWS = {'flash_fwd_kernel': 2 * DISPATCH_K,
                       'flash_dq_kernel': 2 * DISPATCH_K,
                       'flash_dkv_kernel': 2 * DISPATCH_K}
GRASP2VEC_DISPATCH_ROWS = {'pool_fwd_kernel': 2 * DISPATCH_K,
                           'pool_bwd_gather_kernel': 2 * DISPATCH_K,
                           'pool_bwd_scatter_kernel': 0}


def phase_dispatch_models(seed, card):
  """SNAIL long-horizon and sequential and Grasp2Vec (record-fed) at
  ``steps_per_dispatch=8``, each with the stock Adam and the fused update,
  under deterministic cuDNN without autotuning, no plain-version call in
  the phase (``model_dispatch_arm``). Returns the Python launch counts of
  its K=8 runs (their warm-ups and captures; the replays are counted from
  the profiler)."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='dispatch_models_',
                                       dir=OUT_DIR))
  begin = time.perf_counter()
  launches = collections.Counter()
  opened = []
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        _dispatch.force_kernels(True), counted_plain_calls() as plain:
      for name, model_cls, kwargs, batch in SNAIL_CONFIGS:
        episode = kwargs.get('episode_length', 40)
        host = snail_batches(seed + 40, MODEL_DISPATCH_BATCHES, batch,
                             episode)
        frame_mb = sum(v.nbytes for v in host[0][0].values()
                       if v.dtype == np.uint8) / 1e6

        def feed(host=host):
          return itertools.cycle(host)

        for fused in (False, True):
          launches.update(model_dispatch_arm(
              f'snail {name}', seed, card,
              lambda model_cls=model_cls, kwargs=kwargs: model_cls(**kwargs),
              (feed, feed), fused, SNAIL_LAUNCHES, SNAIL_DISPATCH_ROWS,
              host[0], frame_mb, SNAIL_TIMED_STEPS))
        del host
      paths, nbytes, write_s = write_grasp2vec_shards(root, seed + 41)
      log(f'dispatch models: {GRASP2VEC_SHARDS} Grasp2Vec shards, '
          f'{nbytes / 1e6:.1f} MB, written in {write_s:.2f} s')

      def records():
        it = grasp2vec_generator(paths, seed).create_iterator(ModeKeys.TRAIN)
        opened.append(it)
        return it

      sample = next(records())
      for fused in (False, True):
        # One record stream for each trainer, from the same seed: the K=8
        # and the K=1 trainer see the same batches in the same order.
        streams = (records(), records())
        launches.update(model_dispatch_arm(
            'grasp2vec', seed, card, grasp2vec_model,
            tuple(lambda it=it: it for it in streams), fused,
            GRASP2VEC_STEP_LAUNCHES, GRASP2VEC_DISPATCH_ROWS, sample,
            sum(v.nbytes for v in sample[0].values()) / 1e6,
            GRASP2VEC_TIMED_STEPS))
    if sum(plain.values()):
      raise AssertionError(f'dispatch models: plain versions ran {plain}')
  finally:
    for it in opened:
      it.close()
    shutil.rmtree(root, ignore_errors=True)
  log(f'dispatch models: 0 plain-version calls; phase '
      f'{time.perf_counter() - begin:.1f} s')
  return dict(launches)


def model_dispatch_arm(label, seed, card, make_model, feeds, fused,
                       per_step, rows, upload_batch, batch_mb, timed_steps):
  """One model's K=8 arm: a K=8 trainer over 2 dispatches (the first
  warms up and captures, both replay), every counter zeroed just before
  and read just after, against a K=1 trainer over the same 16 batches,
  bit for bit (parameters, batch statistics, Adam moments and groups,
  generator, step); on the stock arm K=1 and K=8 in turns on the host
  clock, the superbatch upload's ms against one batch's pageable upload
  (``upload_batch``); then two replays
  and, on the stock arm, K=1 steps profiled. ``feeds`` gives the K=8 and
  the K=1 trainer's batch iterators. Returns the K=8 run's launches."""
  arm = f'{label} K=8{" fused" if fused else ""}'
  begin = time.perf_counter()

  def trainer(k):
    return Trainer(make_model(), TrainerConfig(
        model_dir='', log_interval_steps=0, seed=seed, steps_per_dispatch=k,
        max_train_steps=2 * DISPATCH_K, fused_update=fused))

  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  grouped = trainer(DISPATCH_K)
  zero_counters()
  start = time.perf_counter()
  grouped.train(feeds[0](), None)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = read_counters()
  grouped_peak = torch.cuda.max_memory_allocated() - base
  torch.cuda.reset_peak_memory_stats()
  before = torch.cuda.memory_allocated()
  single = trainer(1)
  single.train(feeds[1](), None)
  torch.cuda.synchronize()
  single_peak = torch.cuda.max_memory_allocated() - before
  (captured,) = grouped.captured_dispatches.values()
  bad = state_mismatches(single, grouped)
  if (bad or captured.replays != 2 or grouped.step != 2 * DISPATCH_K or
      single.step != 2 * DISPATCH_K or (grouped.fused_plan is None) == fused):
    raise AssertionError(
        f'{arm}: K=8 against K=1 differs in {bad[:8]} ({len(bad)} parts); '
        f'{captured.replays} replays, steps {grouped.step} and '
        f'{single.step}, fused plan {grouped.fused_plan is not None}')
  leaves = len(list(grouped.state.network.parameters()))
  step_launches = dict(per_step)
  if fused:
    step_launches['fused_update'] = -(-leaves //
                                      fused_update.LEAVES_PER_LAUNCH)
  want = {k: v * 2 * DISPATCH_K for k, v in step_launches.items()}
  if launches != want:
    raise AssertionError(f'{arm}: launches at the warm-up and capture '
                         f'{launches}, expected {want}')
  log(f'dispatch models: {arm}: 2 dispatches of 8 (the first warms up, '
      f'captures and replays; {first_s:.1f} s with the capture\'s '
      f'{captured.capture_ms:.1f} ms) bit for bit 16 K=1 steps on the same '
      f'batches: parameters, batch statistics, Adam moments, groups, '
      f'generator, step {grouped.step}; {leaves} leaves; launches at the '
      f'warm-up and capture {launches}; peak device memory above the '
      f'{base / 2**30:.3f} GiB before: K=8 {grouped_peak / 2**30:.3f} GiB '
      f'(two landing buffers and the graph\'s input included), K=1 '
      f'{single_peak / 2**30:.3f} GiB, on {card}')
  want_rows = {kernel: 2 * n for kernel, n in rows.items()}
  want_rows['fused_update_kernel'] = 2 * DISPATCH_K if fused else 0
  if not fused:
    dispatch_turns(arm, grouped, single, feeds, upload_batch, batch_mb,
                   timed_steps, card)
  device_ms = profile_dispatches(arm, grouped, feeds[0], want_rows)
  summary = f'dispatch models: {arm}: device {device_ms:.3f} ms/step'
  if not fused:
    single_ms = profile_dispatches(f'{label} K=1', single, feeds[1], {},
                                   steps=MODEL_K1_PROFILED)
    summary += f' against K=1\'s {single_ms:.3f}'
  log(f'{summary}; each replay {rows} kernel rows, 1 cudaGraphLaunch, no '
      f'Python launch; the arm took {time.perf_counter() - begin:.1f} s, on '
      f'{card}')
  del grouped, single, captured
  torch.cuda.empty_cache()
  return launches


def dispatch_turns(arm, grouped, single, feeds, upload_batch, batch_mb,
                   steps, card):
  """Host ms/step of K=1 and K=8 in turns (K=1, K=8, K=8, K=1) over
  ``steps`` steps each, synchronised; the host ms of assembling each
  superbatch (on the prefetch thread) and its upload's ms (CUDA events on
  the feed's side stream) against one batch's pageable upload of its
  uint8 frames (CUDA events)."""
  feed = grouped._feed  # pylint: disable=protected-access
  finish, uploads = feed.finish, []
  assemble = trainer_lib._SuperbatchAssembler._assemble  # pylint: disable=protected-access
  assembly = _HostClock(assemble)

  def timed_finish(staged, release):
    finish(staged, release)
    if staged.start is not None:
      uploads.append(staged.start.elapsed_time(staged.ready))

  feed.finish = timed_finish
  trainer_lib._SuperbatchAssembler._assemble = (  # pylint: disable=protected-access
      lambda self, group: assembly(self, group))
  ms = collections.defaultdict(list)
  try:
    for trainer, it in ((single, feeds[1]), (grouped, feeds[0]),
                        (grouped, feeds[0]), (single, feeds[1])):
      trainer.config.max_train_steps = trainer.step + steps
      torch.cuda.synchronize()
      begin = time.perf_counter()
      trainer.train(it(), None)
      torch.cuda.synchronize()
      ms[trainer.config.steps_per_dispatch].append(
          1e3 * (time.perf_counter() - begin) / steps)
  finally:
    feed.finish = finish
    trainer_lib._SuperbatchAssembler._assemble = assemble  # pylint: disable=protected-access
  line = (f'dispatch models: {arm} host ms/step over {steps} steps in '
          f'turns: K=1 {ms[1][0]:.3f}, {ms[1][1]:.3f}; K=8 '
          f'{ms[DISPATCH_K][0]:.3f}, {ms[DISPATCH_K][1]:.3f}; superbatch '
          f'assembly on the host {statistics.median(assembly.ms):.3f} ms '
          f'({min(assembly.ms):.3f}-{max(assembly.ms):.3f}, '
          f'{statistics.median(assembly.ms) / DISPATCH_K:.3f} a step); its '
          f'upload (8 batches, {8 * batch_mb:.1f} MB of frames, pinned) '
          f'{statistics.median(uploads):.3f} ms ({min(uploads):.3f}-'
          f'{max(uploads):.3f}), {statistics.median(uploads) / DISPATCH_K:.3f}'
          ' ms a step')
  frames = [torch.from_numpy(np.asarray(v)) for v in upload_batch[0].values()
            if np.asarray(v).dtype == np.uint8]
  pageable = cuda_ms(lambda: [x.to('cuda', non_blocking=True)
                              for x in frames], iters=3, warmup=1)
  line += (f'; K=1\'s pageable upload of a batch\'s {batch_mb:.1f} MB of '
           f'frames {pageable:.3f} ms')
  log(line + f' on {card}')


# ------------------------------------------ SNAIL sequential from records

SEQUENTIAL_GIN = ('tensor2robot_tpu_torch/research/vrgripper/configs/'
                  'run_train_sequential.gin')
REG_GIN = 'tensor2robot_tpu_torch/research/pose_env/configs/run_train_reg.gin'
POSE_DATA = pathlib.Path(__file__).resolve().parent / 'tests' / 'test_data' / (
    'pose_env_test_data.tfrecord')
SNAIL_RECORD_FILES = 4
SNAIL_RECORD_PER_FILE = 4
SNAIL_RECORD_BATCH = 8       # run_train_sequential.gin's batch size
SNAIL_RECORD_STEPS = 4       # counted record-fed steps after the warm-up
SNAIL_RECORD_TURN_STEPS = 4  # timed steps a feed's turn, after a warm-up
# The shuffle buffer, in records: the generator's default of 1000 would
# hold 1000 records of 15.8 MB before the first batch.
SNAIL_RECORD_SHUFFLE = 8
# The binary on run_train_sequential.gin, cut: its steps (of 5000), its
# save interval (the gin has none: the trainer's 500) and eval batches
# (of 100); one eval at the end.
SNAIL_BINARY_STEPS = 12  # 24 before the exported-models phases
SNAIL_BINARY_SAVES = (6, 12)
SNAIL_BINARY_EVAL = 2
# The pose_env gate (tests/test_torch_pose_env.py): 800 steps at batch 16,
# generator seeds 7 (train) and 8 (eval), 4 eval batches, pose_mse at most
# 1.5e-3; through the binary on run_train_reg.gin.
POSE_GATE = dict(steps=800, batch=16, seeds=(7, 8), eval_steps=4,
                 pose_mse=1.5e-3)

# Runs the trainer binary's main unchanged and prints, as its last stdout
# line, the flash kernels' launches, the plain versions' calls, the JPEG
# route of this host, the metrics main returned and its own seconds.
RECORD_BINARY = '''
import json, sys, time
start = time.perf_counter()
from tensor2robot_tpu_torch.bin import run_t2r_trainer
from tensor2robot_tpu_torch.data import image_codec
from tensor2robot_tpu_torch.ops import flash_attention as fa
plain = {'flash': 0}
for name in ('plain_flash_fwd', 'plain_flash_dq', 'plain_flash_dkv'):
  def counted(*args, fn=getattr(fa, name), **kwargs):
    plain['flash'] += 1
    return fn(*args, **kwargs)
  setattr(fa, name, counted)
metrics = run_t2r_trainer.main(sys.argv[1:])
print(json.dumps({'flash_fwd': fa.flash_fwd.launches,
                  'flash_dq': fa.flash_dq.launches,
                  'flash_dkv': fa.flash_dkv.launches, 'plain': plain['flash'],
                  'jpeg_route': image_codec.jpeg_route(),
                  'metrics': {k: float(v) for k, v in metrics.items()},
                  'seconds': time.perf_counter() - start}))
'''


def sequential_model():
  """run_train_sequential.gin's model: episode 40, batch 8, default Adam."""
  return VRGripperEnvSequentialModel(num_mixture_components=1,
                                     condition_gripper_pose=False)


def write_snail_shards(root, seed):
  """SNAIL_RECORD_FILES MetaExample shards of SNAIL_RECORD_PER_FILE
  records at the sequential model's in-specs: a condition and an
  inference episode of 40 seeded 220x300x3 uint8 frames as PNG (zlib
  level 1), 14-d poses and 7-d actions under the reference's names.
  Returns the paths, the bytes on disk and the seconds taken."""
  pre = sequential_model().preprocessor
  spec = dict(pre.get_in_feature_specification(ModeKeys.TRAIN).items())
  spec.update(pre.get_in_label_specification(ModeKeys.TRAIN).items())
  rng = np.random.RandomState(seed + 41)

  def values():
    out = {}
    for key, s in spec.items():
      if s.dtype == torch.uint8:
        out[key] = np.frombuffer(bytearray(rng.bytes(int(np.prod(s.shape)))),
                                 np.uint8).reshape(s.shape)
      else:
        out[key] = rng.randn(*s.shape).astype(np.float32)
    return out

  start = time.perf_counter()
  per_file = [[values() for _ in range(SNAIL_RECORD_PER_FILE)]
              for _ in range(SNAIL_RECORD_FILES)]

  def write(index):
    path = str(root / f'meta-{index:05d}-of-{SNAIL_RECORD_FILES:05d}.tfrecord')
    records.write_examples(path, [
        example_codec.encode_example(spec, value, png_level=1)
        for value in per_file[index]])
    return path

  with concurrent.futures.ThreadPoolExecutor(SNAIL_RECORD_FILES) as pool_:
    paths = list(pool_.map(write, range(SNAIL_RECORD_FILES)))
  return (paths, sum(pathlib.Path(p).stat().st_size for p in paths),
          time.perf_counter() - start)


def snail_generator(paths, seed, **kwargs):
  gen = input_generators.DefaultRecordInputGenerator(
      file_patterns=','.join(paths), batch_size=SNAIL_RECORD_BATCH,
      shuffle_buffer_size=SNAIL_RECORD_SHUFFLE, seed=seed, **kwargs)
  gen.set_specification_from_model(sequential_model(), ModeKeys.TRAIN)
  return gen


def start_record_binary(gin, bindings, out_dir):
  """Starts the trainer binary through RECORD_BINARY, its stdout and
  stderr into files under ``out_dir``; returns the running handle."""
  repo = pathlib.Path(__file__).resolve().parent
  cmd = [sys.executable, '-c', RECORD_BINARY, '--gin_configs',
         str(repo / gin)]
  for binding in bindings:
    cmd += ['--gin_bindings', binding]
  out_dir.mkdir(parents=True, exist_ok=True)
  with open(out_dir / 'stdout.txt', 'w') as out, \
      open(out_dir / 'stderr.txt', 'w') as err:
    proc = subprocess.Popen(cmd, cwd=repo, stdout=out, stderr=err, text=True)
  return proc, out_dir, time.perf_counter()


def finish_record_binary(running, gin, timeout):
  """Waits for a started binary; returns its report (the last stdout
  line) and its seconds since the start. It must exit 0."""
  proc, out_dir, start = running
  try:
    proc.wait(timeout=timeout)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  seconds = time.perf_counter() - start
  stdout = (out_dir / 'stdout.txt').read_text()
  if proc.returncode != 0 or not stdout.strip():
    raise AssertionError(f'{gin}: the binary exited {proc.returncode}; its '
                         f'output ended:\n{stdout[-3000:]}\n'
                         f'{(out_dir / "stderr.txt").read_text()[-3000:]}')
  return json.loads(stdout.strip().splitlines()[-1]), seconds


def run_record_binary(gin, bindings, timeout, out_dir):
  """The trainer binary through RECORD_BINARY, run to its end; returns its
  report and its seconds. It must exit 0."""
  return finish_record_binary(start_record_binary(gin, bindings, out_dir),
                              gin, timeout)


def committed_steps(model_dir):
  directory = str(model_dir / 'checkpoints')
  return [s for s in ckpt_lib.CheckpointManager(directory).all_steps()
          if ckpt_lib.read_commit_marker(directory, s) is not None]


class PoseGate:
  """The pose_env gate: the trainer binary on the port's run_train_reg.gin
  over ``tests/test_data/pose_env_test_data.tfrecord`` (POSE_GATE's steps,
  batch and seeds), in a process of its own started by :meth:`start`. Its
  model runs no kernel of the port, so ``main`` starts it before the build
  and it trains while the kernels compile; ``phase_pose_gate`` checks it
  with :meth:`finish` before any timed phase. A gate still running at exit
  is killed."""

  def __init__(self):
    OUT_DIR.mkdir(exist_ok=True)
    self.root = pathlib.Path(tempfile.mkdtemp(prefix='pose_gate_',
                                              dir=OUT_DIR))
    self.running = None

  def start(self):
    train_seed, eval_seed = POSE_GATE['seeds']
    self.running = start_record_binary(REG_GIN, [
        f"train/DefaultRecordInputGenerator.file_patterns = '{POSE_DATA}'",
        f"eval/DefaultRecordInputGenerator.file_patterns = '{POSE_DATA}'",
        f'train/DefaultRecordInputGenerator.seed = {train_seed}',
        f'eval/DefaultRecordInputGenerator.seed = {eval_seed}',
        f"train_eval_model.model_dir = '{self.root / 'pose_env'}'",
        f'train_eval_model.max_train_steps = {POSE_GATE["steps"]}',
        f'train_eval_model.eval_steps = {POSE_GATE["eval_steps"]}',
        f'DefaultRecordInputGenerator.batch_size = {POSE_GATE["batch"]}'],
                                       self.root / 'logs')
    atexit.register(self.stop)
    return self

  def stop(self):
    if self.running is not None and self.running[0].poll() is None:
      self.running[0].kill()
      self.running[0].wait()
    shutil.rmtree(self.root, ignore_errors=True)

  def finish(self):
    """Waits for the gate: eval ``pose_mse`` at most POSE_GATE's and the
    final step committed; logs it."""
    try:
      report, seconds = finish_record_binary(self.running, REG_GIN, 600)
      gate_dir = self.root / 'pose_env'
      mse = report['metrics'].get('pose_mse', float('nan'))
      if not mse <= POSE_GATE['pose_mse'] or committed_steps(gate_dir) != [
          POSE_GATE['steps']]:
        raise AssertionError(f'pose_env gate: pose_mse {mse} (at most '
                             f'{POSE_GATE["pose_mse"]}), committed steps '
                             f'{committed_steps(gate_dir)}')
    finally:
      self.stop()
    log(f'pose_env gate: the trainer binary python -m '
        f'tensor2robot_tpu_torch.bin.run_t2r_trainer --gin_configs {REG_GIN} '
        f'on tests/test_data/pose_env_test_data.tfrecord '
        f'({POSE_GATE["steps"]} of 10000 steps at batch {POSE_GATE["batch"]} '
        f'of 64, seeds {POSE_GATE["seeds"]}, eval_steps '
        f'{POSE_GATE["eval_steps"]} of 10): eval pose_mse {mse:.6f} <= '
        f'{POSE_GATE["pose_mse"]}; it ran {report["seconds"]:.1f} s (its own '
        f'clock, beside the build) and was collected {seconds:.1f} s after '
        f'its start; JPEG decoded through {report["jpeg_route"]} on this '
        f'host (jpeglib.h '
        f'{"present" if report["jpeg_route"] == "libjpeg" else "absent"})')


def phase_pose_gate(gate, build_seconds):
  """Collects the pose_env gate (a :class:`PoseGate` started before the
  build) before the first check phase, and logs how long it ran on after
  the build: no timed phase runs beside it."""
  start = time.perf_counter()
  gate.finish()
  log(f'pose_env gate: collected {time.perf_counter() - start:.1f} s after '
      f'the build ({build_seconds:.1f} s) ended; it overlapped no timed '
      f'phase')


def phase_record_snail(seed, card, profile):
  """SNAIL sequential trained from MetaExample shards at the reference
  config's full width (see the module doc, 12c). Returns its launch
  counts."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='record_snail_', dir=OUT_DIR))
  begin = time.perf_counter()
  try:
    with _dispatch.force_kernels(True):
      total = record_snail_paths(seed, card, root, profile)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  log(f'record snail: phase took {time.perf_counter() - begin:.1f} s')
  return total


def record_snail_paths(seed, card, root, profile):
  paths, nbytes, write_s = write_snail_shards(root, seed)
  episode = sequential_model().preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)['condition/features/image/0'].shape
  log(f'record snail: {SNAIL_RECORD_FILES} shards of {SNAIL_RECORD_PER_FILE} '
      'MetaExample records (a condition and an inference episode of '
      f'{"x".join(map(str, episode))} uint8 frames as PNG at zlib level 1, '
      f'14-d poses, 7-d actions), {nbytes / 1e6:.1f} MB on disk, '
      f'{nbytes / 1e6 / (SNAIL_RECORD_FILES * SNAIL_RECORD_PER_FILE):.2f} MB '
      f'a record, written in {write_s:.2f} s')
  total = {name: 0 for name in read_counters()}

  def add(launches):
    for name, value in launches.items():
      total[name] += value

  # 1. Trainer steps from DefaultRecordInputGenerator at batch 8, the
  # engine's ring of page-locked slots: a warm-up step, then counted ones.
  gen = snail_generator(paths, seed, reuse_batch_buffers=True)
  timed = _Recorder()
  trainer = Trainer(sequential_model(), TrainerConfig(
      model_dir='', max_train_steps=1, log_interval_steps=0, seed=seed),
                    callbacks=[timed])
  it = gen.create_iterator(ModeKeys.TRAIN)
  try:
    if not it.reuse_buffers:
      raise AssertionError('the record feed did not take the ring of slots')
    zero_counters()
    trainer.train(it, None)  # builds the state; warm-up step
    torch.cuda.synchronize()
    add(read_counters())
    params = dict(trainer.state.network.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    trainer.config.max_train_steps = 1 + SNAIL_RECORD_STEPS
    with counted_plain_calls() as plain:
      zero_counters()
      scalars = trainer.train(it, None)
      torch.cuda.synchronize()
      launches = read_counters()
  finally:
    it.close()
  add(launches)
  want = {k: v * SNAIL_RECORD_STEPS for k, v in SNAIL_LAUNCHES.items()}
  if launches != want or sum(plain.values()):
    raise AssertionError(f'record snail: launches over {SNAIL_RECORD_STEPS} '
                         f'steps {launches}, expected {want}; plain calls '
                         f'{dict(plain)}')
  if not all(np.isfinite(v) for v in scalars.values()):
    raise AssertionError(f'record snail: non-finite summaries {scalars}')
  for name, param in params.items():
    if param.grad is None or not bool(torch.isfinite(param.grad).all()):
      raise AssertionError(f'record snail {name}: gradient {param.grad!r}')
  moved = sum(not torch.equal(p.detach(), before[k])
              for k, p in params.items())
  if not moved:
    raise AssertionError('record snail: no parameter moved')
  log(f'record snail: {SNAIL_RECORD_STEPS} record-fed steps of '
      'VRGripperEnvSequentialModel (run_train_sequential.gin: episode 40, '
      f'batch {SNAIL_RECORD_BATCH}, 220x300 frames, default Adam) after a '
      f'warm-up, launches {launches} (2 flash_fwd, 2 flash_dq, 2 flash_dkv a '
      f'step), plain calls 0, loss {scalars["loss"]:.4f}, {len(params)} '
      f'parameters with finite gradients, {moved} moved; engine '
      f'{gen.last_decision.num_workers} workers, a ring of '
      f'{gen.last_decision.ring_depth} page-locked slots')

  # 2. The feeds in turns on the same trainer: the record feed, and the
  # same batches decoded beforehand into pageable memory.
  plain_it = snail_generator(paths, seed, engine_workers=0).create_iterator(
      ModeKeys.TRAIN)
  try:
    decoded = list(itertools.islice(plain_it, 1 + SNAIL_RECORD_TURN_STEPS))
  finally:
    plain_it.close()
  feeds = {'record-fed': lambda: gen.create_iterator(ModeKeys.TRAIN),
           'pre-decoded batches': lambda: iter(decoded)}
  block_ms = {name: [] for name in feeds}
  for name, make in list(feeds.items()) * 2:
    stream = make()
    try:
      start = trainer.step
      trainer.config.max_train_steps = start + 1 + SNAIL_RECORD_TURN_STEPS
      zero_counters()
      trainer.train(stream, None)
      torch.cuda.synchronize()
      turn = read_counters()
    finally:
      if hasattr(stream, 'close'):
        stream.close()
    add(turn)
    if turn != {k: v * (1 + SNAIL_RECORD_TURN_STEPS)
                for k, v in SNAIL_LAUNCHES.items()}:
      raise AssertionError(f'record snail, {name}: launches {turn}')
    block_ms[name].append([timed.step_ms[s] for s in range(
        start + 2, start + 2 + SNAIL_RECORD_TURN_STEPS)])
  for name, blocks in block_ms.items():
    log(f'record snail: ms/step, {name}: median of two turns of '
        f'{SNAIL_RECORD_TURN_STEPS} steps after a warm-up '
        f'{np.median(blocks[0]):.3f} and {np.median(blocks[1]):.3f} (each '
        f'{[np.round(b, 3).tolist() for b in blocks]}; host clock, '
        f'synchronised), on {card}')
  parse_fn = native_io.make_native_parse_fn(gen.feature_spec, gen.label_spec,
                                            decode_workers=8)
  with native_io.NativeInterleaveReader(paths) as reader:
    raw = list(itertools.islice(reader, SNAIL_RECORD_BATCH))
  frames = sum(int(spec.shape[0]) for spec in gen.feature_spec.values()
               if len(spec.shape) == 4)
  image_shape = next(tuple(spec.shape) for spec in gen.feature_spec.values()
                     if len(spec.shape) == 4)
  parse_fn(raw)
  times = []
  for _ in range(3):
    t0 = time.perf_counter()
    parse_fn(raw)
    times.append(1e3 * (time.perf_counter() - t0))
  log(f'record snail: host parse + PNG decode of one batch of '
      f'{SNAIL_RECORD_BATCH} records ({SNAIL_RECORD_BATCH * frames} frames '
      f'into {[SNAIL_RECORD_BATCH, *image_shape]} buffers) '
      f'{np.median(times):.2f} ms (median of 3, '
      f'8 decode threads, one engine worker\'s share) on {card}\'s host')
  if profile:
    stream = gen.create_iterator(ModeKeys.TRAIN)
    try:
      trainer.config.max_train_steps = trainer.step + 2
      trainer.train(stream, None)  # the ring fills
      phase_profile_records(trainer, stream, card, 'snail')
    finally:
      stream.close()

  # 3. The feed against the parser: the first EVAL batch of the record
  # feed (files in order, through the ring) bit for bit the same records
  # parsed by the plain Python decoder.
  eval_gen = input_generators.DefaultRecordInputGenerator(
      file_patterns=','.join(paths), batch_size=SNAIL_RECORD_BATCH,
      reuse_batch_buffers=True)
  eval_gen.set_specification_from_model(sequential_model(), ModeKeys.EVAL)
  eval_it = eval_gen.create_iterator(ModeKeys.EVAL)
  try:
    features, labels = next(eval_it)
    fed = {**{f'f/{k}': np.array(v) for k, v in features.items()},
           **{f'l/{k}': np.array(v) for k, v in labels.items()}}
  finally:
    eval_it.close()
  in_order = [r for p in paths for r in native_io.read_records(p)]
  want_f, want_l = example_codec.make_plain_parse_fn(
      eval_gen.feature_spec, eval_gen.label_spec)(
          in_order[:SNAIL_RECORD_BATCH])
  want = {**{f'f/{k}': v for k, v in want_f.items()},
          **{f'l/{k}': v for k, v in want_l.items()}}
  bad = [k for k in want if k not in fed or fed[k].dtype != want[k].dtype or
         not np.array_equal(fed[k], want[k])]
  if bad or sorted(fed) != sorted(want):
    raise AssertionError(f'record snail: the fed batch differs from the plain '
                         f'decoder at {bad}')
  log(f'record snail: the first record-fed EVAL batch ({len(want)} leaves, '
      f'{sum(v.nbytes for v in want.values()) / 1e6:.1f} MB) is bit for bit '
      'the same records parsed and decoded by the plain Python decoder')
  del trainer

  # 4. The binary on the port's run_train_sequential.gin.
  model_dir = root / 'binary'
  patterns = ','.join(paths)
  report, seconds = run_record_binary(SEQUENTIAL_GIN, [
      f"train/DefaultRecordInputGenerator.file_patterns = '{patterns}'",
      f"eval/DefaultRecordInputGenerator.file_patterns = '{patterns}'",
      f"train_eval_model.model_dir = '{model_dir}'",
      f'train_eval_model.max_train_steps = {SNAIL_BINARY_STEPS}',
      f'train_eval_model.save_interval_steps = {SNAIL_BINARY_SAVES[0]}',
      f'train_eval_model.eval_steps = {SNAIL_BINARY_EVAL}',
      'DefaultRecordInputGenerator.shuffle_buffer_size = '
      f'{SNAIL_RECORD_SHUFFLE}'], timeout=600, out_dir=root / 'binary_logs')
  steps = committed_steps(model_dir)
  want = {'flash_fwd': 2 * (SNAIL_BINARY_STEPS + SNAIL_BINARY_EVAL),
          'flash_dq': 2 * SNAIL_BINARY_STEPS,
          'flash_dkv': 2 * SNAIL_BINARY_STEPS, 'plain': 0}
  got = {key: report[key] for key in want}
  if steps != list(SNAIL_BINARY_SAVES) or got != want or not all(
      np.isfinite(v) for v in report['metrics'].values()):
    raise AssertionError(f'record snail binary: committed steps {steps}, '
                         f'launches {got} (expected {want}), metrics '
                         f'{report["metrics"]}')
  add({k: report[k] for k in ('flash_fwd', 'flash_dq', 'flash_dkv')})
  log(f'record snail: python -m tensor2robot_tpu_torch.bin.run_t2r_trainer '
      f'--gin_configs {SEQUENTIAL_GIN} (cut: max_train_steps '
      f'{SNAIL_BINARY_STEPS} of 5000, save_interval_steps '
      f'{SNAIL_BINARY_SAVES[0]}, eval_steps {SNAIL_BINARY_EVAL} of 100, '
      f'shuffle_buffer_size {SNAIL_RECORD_SHUFFLE} of 1000; file_patterns '
      f'and model_dir bound) exited 0 in {seconds:.1f} s, committed steps '
      f'{steps}, launches {got}, eval {report["metrics"]}')
  return total


# The models exported and served from their programs (phase_export_models):
# each one's predict batches, and the kernel node its program holds twice
# with the counter that node moves once a predict.
EXPORT_MODEL_BATCHES = {'sequential': (1, 8), 'long_horizon': (1, 8),
                        'grasp2vec': (1, 4)}
EXPORT_MODEL_NODES = {'sequential': ('t2r.flash_fwd.default', 'flash_fwd'),
                      'long_horizon': ('t2r.flash_fwd.default', 'flash_fwd'),
                      'grasp2vec': ('t2r.pool_fwd.default', 'pool_fwd')}


def seeded_features(spec, batch, seed):
  """Seeded spec-shaped numpy features, the keys in sorted order: uint8
  frames drawn as uint8 (a long-horizon batch of 8 holds 1.6 GB of them)
  and float32 uniform [0, 1) otherwise."""
  rng = np.random.default_rng(seed)
  out = {}
  for key in sorted(spec):
    shape = (batch,) + tuple(spec[key].shape)
    if spec[key].dtype == torch.uint8:
      out[key] = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
      out[key] = rng.random(size=shape, dtype=np.float32)
  return out


# Loads every export root of the parent in ONE process that cannot import
# the model's modules, predicts seeded spec-shaped batches (the parent
# draws the same ones with the same function) and prints, per root, the
# restore ms, each predict's ms and launches, and saves the outputs.
EXPORT_MODELS_LOADER = '''
import importlib.abc, json, sys, time
class _Blocked(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.startswith(('tensor2robot_tpu_torch.research',
                        'tensor2robot_tpu_torch.models')):
      raise ImportError('blocked: ' + name)
    return None
sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
from tensor2robot_tpu_torch.ops import flash_attention as fa, pool
from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
SEEDED_FEATURES
def launches():
  return {'flash_fwd': fa.flash_fwd.launches, 'pool_fwd': pool.pool_fwd.launches}
report = {}
device = sys.argv[2]
def sync():
  if device == 'cuda':
    torch.cuda.synchronize()
for name, root, batches, seed, out in json.loads(sys.argv[1]):
  sync()
  start = time.perf_counter()
  predictor = ExportedModelPredictor(root, device=device)
  assert predictor.restore()
  sync()
  entry = {'restore_ms': 1e3 * (time.perf_counter() - start), 'predicts': []}
  outputs = {}
  for batch in list(batches) + [batches[-1]]:
    features = seeded_features(predictor.get_feature_specification(), batch,
                               seed + batch)
    before = launches()
    sync()
    start = time.perf_counter()
    result = predictor.predict(features)
    sync()
    ms = 1e3 * (time.perf_counter() - start)
    entry['predicts'].append(dict(
        batch=batch, ms=ms,
        **{k: v - before[k] for k, v in launches().items()}))
    for key, value in result.items():
      outputs[f'{batch}/{key}'] = value
  np.savez(out, **outputs)
  report[name] = entry
leaked = sorted(m for m in sys.modules if m.startswith((
    'tensor2robot_tpu_torch.research', 'tensor2robot_tpu_torch.models')))
assert not leaked, leaked
print(json.dumps(report))
'''


def export_model(name):
  """The full-width model of each exported configuration: SNAIL
  sequential (run_train_sequential.gin), SNAIL long-horizon
  (run_train_long_horizon.gin: episode 512, 8 heads of 8) and Grasp2Vec
  (train_grasp2vec.gin: ResNet-50 v2, 472x472, bfloat16, the stem pools on
  the kernels)."""
  if name == 'sequential':
    return sequential_model()
  if name == 'long_horizon':
    return VRGripperEnvLongHorizonModel(**SNAIL_CONFIGS[0][2])
  return grasp2vec_model()


class _PhotometricProgram(torch.nn.Module):
  """The fused photometric pass as a module, for ``torch.export``."""

  def forward(self, images, delta, factor):  # pylint: disable=arguments-differ
    return photometric.fused_brightness_contrast(images, delta, factor)


def kernels_forced(device):
  """Kernels forced on for the card; nothing forced on the CPU (a
  rehearsal of a phase runs the plain versions)."""
  return (_dispatch.force_kernels(True) if device == 'cuda' else
          contextlib.nullcontext())


def phase_export_models(seed, card, device='cuda', make_model=export_model):
  """SNAIL sequential, SNAIL long-horizon and Grasp2Vec exported on the
  card and served from their programs, under deterministic cuDNN without
  autotuning (restored after the phase); files under a temporary
  directory below OUT_DIR, removed at the end. Returns the
  launches of its eager and program predicts and of the photometric
  program, with the Grasp2Vec stem's pool launches under
  ``pool_fwd_stem``."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='export_models_', dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        kernels_forced(device):
      return export_models_paths(seed, card, root, device, make_model)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def export_models_paths(seed, card, root, device, make_model):
  begin = time.perf_counter()
  total = path_launches()
  total['pool_fwd_stem'] = 0
  eager_out, jobs = {}, []
  for index, name in enumerate(EXPORT_MODEL_BATCHES):
    model = make_model(name)
    node, counter = EXPORT_MODEL_NODES[name]
    eager = CheckpointPredictor(model, device=device)
    eager.init_randomly(torch.Generator().manual_seed(seed + index))
    export_ms, version = synced_ms(lambda: export_version(
        model, eager.network.state_dict(), 0, root / name, 1))
    meta = check_meta(version, device)
    program = torch.export.load(str(version / exporters.SERVING_FN_FILENAME))
    ops = exporters.program_op_counts(program)
    if meta['kernel_ops'] != {node: 2} or exporters.kernel_op_counts(
        program) != {node: 2}:
      raise AssertionError(f'export models, {name}: kernel nodes '
                           f'{meta["kernel_ops"]}, expected 2 {node}')
    del program
    artifact = (version / exporters.SERVING_FN_FILENAME).stat().st_size
    log(f'export models, {name}: program traced on {meta["trace_device"]} '
        f'with {sum(ops.values())} op nodes, kernel nodes '
        f'{meta["kernel_ops"]}; self_contained_serving_fn '
        f'{meta["self_contained_serving_fn"]}; serving_fn.pt2 {artifact} '
        f'bytes; export {export_ms:.1f} ms (trace, state, assets, warmup, '
        f'commit; host clock) on {card}')
    batches = EXPORT_MODEL_BATCHES[name]
    eager_out[name] = {}
    for batch in batches:
      features = seeded_features(eager.get_feature_specification(), batch,
                                 seed + 100 * index + batch)
      zero_counters()
      ms, out = synced_ms(lambda: eager.predict(features))
      launches = read_counters()
      want = dict(path_launches(), **{counter: 2})
      if launches != want:
        raise AssertionError(f'export models, {name}: an eager predict at '
                             f'batch {batch} launched {launches}, expected '
                             f'{want}')
      for key in total:
        total[key] += launches.get(key, 0)
      if name == 'grasp2vec':
        total['pool_fwd_stem'] += launches['pool_fwd']
      eager_out[name][batch] = out
      log(f'export models, {name}: eager CheckpointPredictor predict at '
          f'batch {batch} {ms:.1f} ms (host clock, synchronised, the first '
          f'call of its shape) on {card}')
      del features
    jobs.append((name, str(root / name), batches, seed + 100 * index,
                 str(root / f'{name}.npz')))
    del eager
    torch.cuda.empty_cache()

  # One process without the model modules loads the three programs.
  repo = pathlib.Path(__file__).resolve().parent
  start = time.perf_counter()
  env = dict(os.environ)
  if device == 'cuda':
    env['T2R_FORCE_PALLAS_KERNELS'] = '1'
  loader = EXPORT_MODELS_LOADER.replace('SEEDED_FEATURES',
                                        inspect.getsource(seeded_features))
  proc = subprocess.run(
      [sys.executable, '-c', loader, json.dumps(jobs), device],
      cwd=repo, capture_output=True, text=True, timeout=900, check=False,
      env=env)
  child_s = time.perf_counter() - start
  if proc.returncode != 0:
    raise AssertionError(f'export models loader: exit {proc.returncode}:\n'
                         f'{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}')
  loaded = json.loads(proc.stdout.strip().splitlines()[-1])
  for name, _, batches, _, out_path in jobs:
    node, counter = EXPORT_MODEL_NODES[name]
    entry = loaded[name]
    for predict in entry['predicts']:
      moved = {key: predict[key] for key in ('flash_fwd', 'pool_fwd')}
      want = {'flash_fwd': 0, 'pool_fwd': 0, counter: 2}
      if moved != want:
        raise AssertionError(f'export models, {name}: a program predict at '
                             f'batch {predict["batch"]} moved the counters '
                             f'by {moved}, expected {want}')
      total[counter] += 2
      if name == 'grasp2vec':
        total['pool_fwd_stem'] += 2
    got = np.load(out_path)
    for batch in batches:
      for key, value in eager_out[name][batch].items():
        program_value = got[f'{batch}/{key}']
        if (program_value.dtype != value.dtype or
            program_value.shape != value.shape or
            program_value.tobytes() != value.tobytes()):
          raise AssertionError(
              f'export models, {name}: {key} at batch {batch} from the '
              f'program differs from the eager predictor (max abs diff '
              f'{float(np.abs(program_value - value).max()):.3e})')
    predicts = ', '.join(
        f'batch {p["batch"]} {p["ms"]:.1f} ms ({p[counter]} {counter})'
        for p in entry['predicts'])
    log(f'export models, {name}: loaded without the model modules, restore '
        f'{entry["restore_ms"]:.1f} ms; program predicts {predicts} (the '
        f'last a second call at its batch; host clock, synchronised); every '
        f'output bit for bit the eager predictor\'s at batches {batches} on '
        f'{card}')
  log(f'export models: the loader process took {child_s:.1f} s (start, '
      f'imports, three loads and their predicts) on {card}')

  # The photometric pass as an exported program at the training shape.
  generator = torch.Generator(device=device).manual_seed(seed + 5)
  images = torch.rand(PHOTOMETRIC_SHAPE, generator=generator, device=device)
  shape = (PHOTOMETRIC_SHAPE[0], 1, 1, 1)
  delta = torch.rand(shape, generator=generator, device=device) * 0.25 - 0.125
  factor = torch.rand(shape, generator=generator, device=device) + 0.5
  export_ms, program = synced_ms(lambda: torch.export.export(
      _PhotometricProgram(), (images, delta, factor)))
  nodes = exporters.kernel_op_counts(program)
  if nodes != {'t2r.photometric.default': 1}:
    raise AssertionError(f'photometric program: kernel nodes {nodes}')
  zero_counters()
  got = program.module()(images, delta, factor)
  torch.cuda.synchronize()
  launches = read_counters()
  if launches != dict(path_launches(), photometric=1):
    raise AssertionError(f'photometric program launched {launches}')
  total['photometric'] += 1
  eager = (photometric.photometric if device == 'cuda' else
           photometric.plain_brightness_contrast)
  if not same_bits(got, eager(images, delta, factor)):
    raise AssertionError('the photometric program differs from the eager '
                         'kernel')
  log(f'export models: the photometric pass exported on the card '
      f'({export_ms:.1f} ms) holds 1 t2r.photometric node, launched it once '
      f'at {list(PHOTOMETRIC_SHAPE)} float32 and matched the eager kernel '
      f'bit for bit on {card}')
  log(f'export models: phase {time.perf_counter() - begin:.1f} s on {card}')
  return total


QUANT_MODES = ('off', 'int8', 'fp8')
QUANT_DISPATCH_TURNS = ('off', 'int8', 'fp8', 'fp8', 'int8', 'off')
QUANT_DISPATCH_REPEATS = 10
QUANT_CALIBRATION_RUNS = 4  # two calibration batches, full and quantized


def phase_quantized_serving(seed, card, device='cuda', model=None):
  """The QT-Opt critic's weight-only int8 and fp8 twins served from its
  exported program, under deterministic cuDNN without autotuning
  (restored after the phase); files under a temporary directory below
  OUT_DIR, removed at the end. Returns the launches."""
  OUT_DIR.mkdir(exist_ok=True)
  root = pathlib.Path(tempfile.mkdtemp(prefix='quant_phase_', dir=OUT_DIR))
  try:
    with cudnn_settings(deterministic=True, benchmark=False), \
        kernels_forced(device):
      return quantized_serving_paths(seed, card, root, device, model)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def quantized_device_ms(exported, features, card):
  """Device ms (``cuda_ms``, CUDA events) of the twins' eager
  dequantize alone and of one serving-fn call on a batch already on the
  card, full precision beside int8 and fp8."""
  batch = {key: torch.from_numpy(np.ascontiguousarray(value)).cuda()
           for key, value in features.items()}
  snapshots = {mode: exported.stateless_serving_fn(quantize=mode)
               for mode in QUANT_MODES}
  with torch.inference_mode():
    call_ms = {mode: cuda_ms(lambda s=s: s.fn(s.params, batch), iters=10)
               for mode, s in snapshots.items()}
    dequantize_ms = {mode: cuda_ms(
        lambda s=snapshots[mode]: quant_lib.dequantize_params(s.params),
        iters=10) for mode in ('int8', 'fp8')}
  n = len(next(iter(features.values())))
  for mode in ('int8', 'fp8'):
    log(f'quantized serving, {mode}: device ms (CUDA events, L2 flushed): '
        f'dequantize_params {dequantize_ms[mode]:.3f} '
        f'({quant_lib.quantized_leaf_count(snapshots[mode].params)} leaves), '
        f'the serving fn on {n} pairs on the card {call_ms[mode]:.3f} '
        f'against full precision {call_ms["off"]:.3f} '
        f'({call_ms[mode] / call_ms["off"]:.3f}x) on {card}')


def quantized_serving_paths(seed, card, root, device, model):
  begin = time.perf_counter()
  model = model or GraspingModelWrapper(device_type='gpu',
                                        kernel_policy='pool_conv')
  eager = CheckpointPredictor(model, device=device)
  # Spread weights: a fresh critic scores every pair near 0.5, where the
  # twins' errors could round away in bfloat16.
  eager.load_state_dict(spread_weights(
      model.create_module(), torch.Generator().manual_seed(seed + 3)))
  export_version(model, eager.network.state_dict(), 0, root / 'export', 1)
  exported = ExportedModelPredictor(str(root / 'export'), device=device)
  if not exported.restore():
    raise AssertionError('quantized serving: the export did not load')
  total = path_launches()

  def counted(what, fn, eval_batches):
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counters()
    want = path_launches(eval_batches=eval_batches)
    if launches != want:
      raise AssertionError(f'quantized serving, {what}: launches {launches}, '
                           f'expected {want}')
    for name in total:
      total[name] += launches[name]
    return out

  batchers, reports = {}, {}
  try:
    for mode in QUANT_MODES:
      warm = len(default_buckets(BATCHER_MAX_BATCH)) + (
          QUANT_CALIBRATION_RUNS if mode != 'off' else 0)
      start_ms, batchers[mode] = synced_ms(lambda mode=mode: counted(
          f'{mode} start', lambda: DynamicBatcher(
              exported, max_batch=BATCHER_MAX_BATCH, quantize=mode,
              metrics_prefix=f'serving/quant_{mode}',
              register_report=False).start(), warm))
      reports[mode] = batchers[mode].report()
      if reports[mode]['quantized_active'] != (mode != 'off'):
        raise AssertionError(f'quantized serving, {mode}: report '
                             f'{reports[mode]}')
      log(f'quantized serving, {mode}: batcher start {start_ms:.1f} ms '
          f'(the quantization and its parity check where on, '
          f'{len(default_buckets(BATCHER_MAX_BATCH))} bucket warm-ups; host '
          f'clock) on {card}')
    full = reports['off']['param_bytes']
    for mode in ('int8', 'fp8'):
      r = reports[mode]
      log(f'quantized serving, {mode}: param bytes {r["param_bytes"]} of '
          f'{full} full ({r["param_bytes"] / full:.4f}x; gauge '
          f'{r["quant_param_bytes_ratio"]:.4f}); parity within the default '
          f'band (atol 0.05, rtol 0.05): max abs err '
          f'{r["quant_parity_max_abs_err"]:.3e}, max rel err '
          f'{r["quant_parity_max_rel_err"]:.3e}, rejects '
          f'{r["quant_parity_rejects"]}, errors {r["quant_errors"]}')
      if r['quant_parity_rejects'] or r['quant_errors']:
        raise AssertionError(f'quantized serving, {mode}: refused: {r}')

    # One dispatch of 64 (frame, grasp) pairs, the three in turns.
    features = serving_pairs(model, seed + 21, BATCHER_MAX_BATCH)
    executors = {mode: batchers[mode].current_executor()
                 for mode in QUANT_MODES}
    outputs = {mode: counted(f'{mode} dispatch warm-up', lambda mode=mode:
                             executors[mode].execute(features,
                                                     BATCHER_MAX_BATCH), 1)
               for mode in QUANT_MODES}
    times = {mode: [] for mode in QUANT_MODES}
    for mode in QUANT_DISPATCH_TURNS:
      def block(mode=mode):
        for _ in range(QUANT_DISPATCH_REPEATS):
          executors[mode].execute(features, BATCHER_MAX_BATCH)
      ms, _ = synced_ms(lambda: counted(f'{mode} dispatches', block,
                                        QUANT_DISPATCH_REPEATS))
      times[mode].append(ms / QUANT_DISPATCH_REPEATS)
    want = outputs['off']['q_predicted']
    for mode in ('int8', 'fp8'):
      diff = float(np.abs(outputs[mode]['q_predicted'] - want).max())
      log(f'quantized serving, {mode}: one dispatch of '
          f'{BATCHER_MAX_BATCH} {np.round(times[mode], 3).tolist()} ms '
          f'against full precision {np.round(times["off"], 3).tolist()} ms '
          f'(blocks of {QUANT_DISPATCH_REPEATS} in turns '
          f'{list(QUANT_DISPATCH_TURNS)}; host clock, synchronised, the '
          f'upload and the read-back included); q max abs diff from full '
          f'precision {diff:.3e} on {card}')
    if device == 'cuda':
      quantized_device_ms(exported, features, card)

    # The zero band: refused, full precision served bit for bit.
    control = counted('zero-band start', lambda: DynamicBatcher(
        exported, max_batch=BATCHER_MAX_BATCH, quantize='int8',
        quant_parity_atol=0.0, quant_parity_rtol=0.0,
        metrics_prefix='serving/quant_zero', register_report=False).start(),
        len(default_buckets(BATCHER_MAX_BATCH)) + QUANT_CALIBRATION_RUNS)
    batchers['zero'] = control
    request = serving_pairs(model, seed + 22, BATCHER_EXAMPLES)
    got = counted('zero-band request', lambda: control.submit(
        request).result(timeout=120), 1)['q_predicted']
    want = counted('full-precision predict', lambda: exported.predict(
        request), 1)['q_predicted']
    report = control.report()
    if (report['quant_parity_rejects'] != 1 or report['quantized_active'] or
        not np.array_equal(got.view(np.int32), want.view(np.int32))):
      raise AssertionError(f'quantized serving, zero band: report {report}, '
                           f'q {got} against full precision {want}')
    log(f'quantized serving: the zero band (atol = rtol = 0) refused the '
        f'int8 twin (quant_parity_rejects {report["quant_parity_rejects"]}, '
        f'measured max abs err {report["quant_parity_max_abs_err"]:.3e}) and '
        f'served full precision, q bit for bit the exported predictor\'s on '
        f'{BATCHER_EXAMPLES} pairs on {card}')
  finally:
    for batcher in batchers.values():
      batcher.close()

  # The serving binary with --quantize int8, in a process of its own.
  replica = Replica(['--export_dir', root / 'export', '--port', 0, '--device',
                     device, '--max-batch', 8, '--batch-deadline-ms', 5,
                     '--reload-interval-secs', 0, '--quantize', 'int8'],
                    root / 'quantized.log', device)
  try:
    start_s = time.perf_counter()
    replica.wait_ready()
    start_s = time.perf_counter() - start_s
    one = serving_pairs(model, seed + 23, 1)
    status, _, reply = http_call(replica.port, '/v1/predict',
                                 loadgen.encode_request(one))
    got = np.asarray(reply.get('outputs', {}).get('q_predicted'), np.float32)
    want = counted('full-precision predict', lambda: exported.predict(one),
                   1)['q_predicted']
    _, _, statz = http_call(replica.port, '/statz')
    if (status != 200 or got.shape != want.shape or
        float(np.abs(got - want).max()) > 0.05 + 0.05 * float(
            np.abs(want).max()) or statz.get('quantize') != 'int8' or
        statz.get('quantized_active') is not True):
      raise AssertionError(f'run_serving --quantize int8: status {status}, '
                           f'q {got} against {want}, statz {statz}')
    seconds, doc = replica.stop()
  finally:
    replica.kill()
  launches = http_replica_launches('quantized', doc)
  for name, count in launches.items():
    total[name] += count
  log(f'quantized serving: run_serving --quantize int8 ready in '
      f'{start_s:.1f} s (imports, load, quantize, parity, warm-ups), answered '
      f'one request (q max abs diff from full precision '
      f'{float(np.abs(got - want).max()):.3e}), /statz quantized_active '
      f'{statz["quantized_active"]} at {statz["quant_param_bytes_ratio"]:.4f}'
      f' of the full param bytes, exited 0 in {seconds:.1f} s after SIGTERM, '
      f'launches {launches} on {card}')
  log(f'quantized serving: phase {time.perf_counter() - begin:.1f} s on '
      f'{card}')
  return total


# One turn of --main-path-turns: run from a checkout's root, it builds
# that checkout's kernels (cached) and times its main path.
MAIN_PATH_TURN = '''
import json, sys
import chip_smoke
chip_smoke.phase_build()
ms = chip_smoke.phase_main_path(int(sys.argv[1]), int(sys.argv[2]))[0]
print(json.dumps({'ms_per_action': ms}))
'''
MAIN_PATH_TURNS = ('other', 'this', 'this', 'other')


def phase_main_path_turns(other, seed, actions, card):
  """ms/action of the main path (``phase_main_path``) of this checkout and
  of the checkout at ``other`` in turns (MAIN_PATH_TURNS), each turn in a
  child process run from its checkout's root. ``other``'s build directory
  takes this checkout's libraries first: a library's name hashes its
  sources, so ``other`` uses those it shares and builds the rest."""
  roots = {'this': pathlib.Path(__file__).resolve().parent,
           'other': pathlib.Path(other).resolve()}
  other_build = roots['other'] / _build.BUILD_DIR.relative_to(roots['this'])
  other_build.mkdir(parents=True, exist_ok=True)
  for lib in _build.BUILD_DIR.glob('lib*'):
    shutil.copy2(lib, other_build / lib.name)
  times = {'this': [], 'other': []}
  for which in MAIN_PATH_TURNS:
    done = subprocess.run(
        [sys.executable, '-c', MAIN_PATH_TURN, str(seed), str(actions)],
        cwd=roots[which], capture_output=True, text=True, timeout=600,
        check=False)
    if done.returncode != 0:
      raise AssertionError(f'main path turn in {roots[which]} exited '
                           f'{done.returncode}: {done.stderr[-4000:]}')
    times[which].append(json.loads(
        done.stdout.strip().splitlines()[-1])['ms_per_action'])
    log(f'main path turn, {which} ({roots[which]}): '
        f'{times[which][-1]:.3f} ms/action over {actions} actions')
  log(f'main path turns {list(MAIN_PATH_TURNS)} (host clock, synchronised, '
      f'each turn a fresh process after one warm-up action) on {card}')
  log(json.dumps({'main_path_turns': {
      'actions': actions, 'this': times['this'], 'other': times['other'],
      'other_root': str(roots['other'])}}))


PHASE_SECONDS = {}


def time_phases():
  """Wraps every module-level ``phase_*`` function so that each call's host
  seconds add up in PHASE_SECONDS under the phase's name, printed before
  the kernels line."""
  def timed(name, phase):
    @functools.wraps(phase)
    def run(*args, **kwargs):
      start = time.perf_counter()
      try:
        return phase(*args, **kwargs)
      finally:
        PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0) +
                                    time.perf_counter() - start, 1)
    return run

  for name, fn in list(globals().items()):
    if name.startswith('phase_') and callable(fn):
      globals()[name] = timed(name[len('phase_'):], fn)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--actions', type=int, default=5)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--snail-steps', type=int, default=3)
  parser.add_argument('--profile', action='store_true')
  parser.add_argument('--main-path-turns', metavar='OTHER_CHECKOUT',
                      help='time the main path of this checkout and of '
                      'OTHER_CHECKOUT in turns, and nothing else')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA card is visible; nothing was run.',
          file=sys.stderr)
    return 2
  time_phases()
  defaults = tf32_flags()
  card = phase_card()
  if args.main_path_turns:
    phase_build()
    phase_main_path_turns(args.main_path_turns, args.seed, args.actions, card)
    return 0
  # The pose_env gate runs no kernel: it trains while the kernels build,
  # and is collected before the first check phase.
  gate = PoseGate().start()
  phase_pose_gate(gate, phase_build())
  generator = torch.Generator(device='cuda').manual_seed(args.seed)
  errors = {'pool_fwd': phase_check_pool(generator),
            'pool_bwd': phase_check_pool_bwd(generator)}
  errors['conv_s2d_fwd'], errors['conv_s2d_fwd_float32'] = (
      phase_check_conv(generator))
  (errors['conv_s2d_dw'], errors['conv_s2d_dx'],
   errors['conv_s2d_dw_float32'],
   errors['conv_s2d_dx_float32']) = phase_check_conv_grads(generator)
  errors.update(phase_check_flash(generator))
  errors['fused_update'] = phase_check_fused_update(generator)
  errors['photometric'] = phase_check_photometric(generator)
  errors['pool_fwd_stem'] = errors['pool_bwd_gather'] = (
      phase_check_stem_pool(generator))
  if tf32_flags() != defaults:
    raise AssertionError(f'TF32 flags {tf32_flags()} after the checks, '
                         f'{defaults} before')
  log(f'TF32 flags after the check phases: {tf32_flags()} (matmul, cudnn), '
      'as before them')
  torch.cuda.empty_cache()
  ms_per_action, serve_launches, policy, frames = phase_main_path(
      args.seed, args.actions)
  reference_launches = phase_reference(args.seed)
  torch.cuda.empty_cache()
  ms_per_step, train_launches, trainer = phase_train(args.seed, args.steps)
  checkpoint_launches = phase_checkpoint(args.seed, card)
  torch.cuda.empty_cache()
  export_launches = phase_export_serving(args.seed, card)
  torch.cuda.empty_cache()
  http_launches = phase_http_serving(args.seed, card)
  record_launches = phase_record_train(args.seed, card, ms_per_step,
                                       args.profile)
  torch.cuda.empty_cache()
  fused_ms, fused_launches, fused_trainer = phase_train_fused(
      args.seed, args.steps, ms_per_step)
  dx_launches, dx_float32_launches = phase_dx_path(generator)
  train_reference_launches = phase_train_reference(args.seed)
  torch.cuda.empty_cache()
  snail = phase_snail_train(args.seed, args.snail_steps)
  snail_fused = phase_snail_fused(
      args.seed, args.snail_steps,
      {name: result[0] for name, result in snail.items()})
  phase_snail_reference(args.seed)
  torch.cuda.empty_cache()
  photometric_launches = phase_photometric_path(args.seed)
  torch.cuda.empty_cache()
  dispatch_launches = phase_dispatch(args.seed, card)
  torch.cuda.empty_cache()
  (grasp2vec_launches, grasp2vec_ms, grasp2vec_trainer,
   grasp2vec_batch) = phase_grasp2vec(args.seed, card)
  torch.cuda.empty_cache()
  record_snail_launches = phase_record_snail(args.seed, card, args.profile)
  torch.cuda.empty_cache()
  export_models_launches = phase_export_models(args.seed, card)
  torch.cuda.empty_cache()
  quantized_launches = phase_quantized_serving(args.seed, card)
  torch.cuda.empty_cache()
  # Launches: the pool and conv forward kernels over the QT-Opt serving,
  # training, checkpoint, export, HTTP serving, record-fed and K-step
  # paths, their backward ones over the training paths, dx over the path
  # that needs it, the flash kernels over the three SNAIL paths, the fused
  # update over the two fused training paths, the photometric pass over
  # its branch. The K-step path counts its warm-up, its capture and its
  # eager tail (a replay runs no Python); its replays' kernels are counted
  # from the profiler by phase_dispatch_profile. The exported SNAIL,
  # Grasp2Vec and photometric programs and the quantized QT-Opt serving
  # count their eager and program predicts, those of their child processes
  # included.
  paths = [serve_launches, train_launches, checkpoint_launches,
           export_launches, http_launches, record_launches, fused_launches,
           *(result[1] for result in snail.values()),
           *(result[1] for result in snail_fused.values()),
           photometric_launches, dispatch_launches, grasp2vec_launches,
           record_snail_launches, export_models_launches,
           quantized_launches]
  launches = {name: sum(path[name] for path in paths)
              for name in serve_launches}
  # The Grasp2Vec stem's routes have rows of their own.
  launches['pool_fwd_stem'] = (grasp2vec_launches['pool_fwd'] +
                               export_models_launches['pool_fwd_stem'])
  launches['pool_bwd_gather'] = (grasp2vec_launches['pool_bwd'] -
                                 grasp2vec_launches['pool_bwd_scatter'])
  for name in ('conv_s2d_dx', 'conv_s2d_dx_tensor_core'):
    launches[name] = dx_launches[name]
  # conv1's float32 routes: the float32 critic's reference predict and
  # training step and the float32 dx path.
  for name in ('conv_s2d_fwd', 'conv_s2d_dw', 'conv_s2d_dx'):
    launches[name + '_float32'] = sum(
        path[name] for path in (reference_launches, train_reference_launches,
                                dx_float32_launches))
  log(f'launches: serving {serve_launches} over {args.actions} actions; '
      f'training {train_launches} and fused training {fused_launches} over '
      f'{args.steps} steps; checkpoint phase {checkpoint_launches}; export '
      f'phase {export_launches}; HTTP serving replicas {http_launches}; '
      f'record phase {record_launches}; dx path '
      f'{dx_launches} (float32: {dx_float32_launches}); float32 '
      f'reference predict {reference_launches} and step '
      f'{train_reference_launches}; SNAIL '
      f'{ {name: result[1] for name, result in snail.items()} } and fused '
      f'{ {name: result[1] for name, result in snail_fused.items()} } over '
      f'{args.snail_steps} steps each; photometric path '
      f'{photometric_launches}; K-step path {dispatch_launches}; Grasp2Vec '
      f'path {grasp2vec_launches}; record-fed SNAIL path '
      f'{record_snail_launches}; exported models '
      f'{export_models_launches}; quantized serving {quantized_launches}')
  if tf32_flags() != defaults:
    raise AssertionError(f'TF32 flags {tf32_flags()} before the timings, '
                         f'{defaults} at the start')
  kernels = phase_timing(generator, errors, launches, card)
  torch.cuda.empty_cache()
  phase_dispatch_profile(args.seed)
  grasp2vec_device_ms = phase_grasp2vec_profile(grasp2vec_trainer,
                                                grasp2vec_batch)
  del grasp2vec_trainer
  torch.cuda.empty_cache()
  # SNAIL and Grasp2Vec at K=8, after the timings because its profiles are
  # sessions of their own. Its warm-ups' and captures' launches join the
  # kernels line; the replays' are the profiler's rows.
  model_launches = phase_dispatch_models(args.seed, card)
  extra = {name: model_launches[name] for name in (
      'flash_fwd', 'flash_dq', 'flash_dkv', 'fused_update', 'pool_fwd')}
  extra['pool_fwd_stem'] = model_launches['pool_fwd']
  extra['pool_bwd_gather'] = (model_launches['pool_bwd'] -
                              model_launches['pool_bwd_scatter'])
  for entry in kernels:
    entry['launches'] += extra.get(entry['name'], 0)
  log(f'launches: SNAIL and Grasp2Vec K=8 path (warm-ups and captures) '
      f'{model_launches}')
  if args.profile:
    phase_profile_reference(args.seed)
    phase_profile(policy, frames)
    phase_profile_train(trainer, args.seed)
    phase_profile_train(fused_trainer, args.seed, 'fused')
    for name, (_, _, snail_trainer, batches) in snail.items():
      phase_profile_snail(name, snail_trainer, batches)
    for name, (_, _, snail_trainer, batches) in snail_fused.items():
      phase_profile_snail(f'{name}_fused', snail_trainer, batches)
  log(f'ms/action {ms_per_action:.3f}, ms/train step {ms_per_step:.3f} '
      f'(fused Adam + EMA + guard: {fused_ms:.3f}) at batch {TRAIN_BATCH}; '
      f'SNAIL ms/step '
      f'{ {name: round(result[0], 3) for name, result in snail.items()} }, '
      f'fused '
      f'{ {name: round(result[0], 3) for name, result in snail_fused.items()} }'
      f'; Grasp2Vec ms/step {grasp2vec_ms:.3f} (device '
      f'{grasp2vec_device_ms:.3f}) at batch {GRASP2VEC_BATCH} on {card}')
  log(f'phase seconds (host clock, a phase inside another counted in both): '
      f'{json.dumps(PHASE_SECONDS)} on {card}')
  log(json.dumps({'kernels': kernels}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
