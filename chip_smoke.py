#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``elektronn2_tpu_torch``).

Drives the port's paths at full width and checks them: the dense-serving
deployment (whole KNOSSOS datasets swept slab by slab by ``sweep_knossos``,
the flagship through K1, the wide U-Net, and the ``predict`` CLI); training
of the bench's neuro3d net (the fused loop, one CUDA graph per chunk) with the
trained weights served through K1 after it, its batch-normed dropout form
(served densely after it), and its rows under the train lowerings and
remat; the training entry point (the train CLI on four example configs,
the neuro3d weights it saved served through K1); the tracer's prelu head
and skeleton-field training; dense MFP inference
of the flagship neuro3d-class net (20/30/40/40 channels) with the tail-conv
kernel K1 (``csrc/tailconv.cu``, a 3xTF32 implicit GEMM on ``wgmma``); the
same request with the flagship's
head units in the head-unit kernel K4 (``csrc/headconv.cu``); U-Net
conv-dense serving of the wide U-Net (``examples/unet3d_wide.py``, widths
64/128/256) with K1 on its (3,3,3) convs; fused agent tracing of the
tracing deployment's recurrent model (16^3 patch, Perceptron 64 -> GRU 64
via ScanN -> 3-vector step) with the patch kernels K2 (``csrc/extract.cu``,
translation) and K3 (``csrc/extract_rot.cu``, frame-aligned, float32 and
bf16), and the tracing campaign around it (the respawning and chained
pools, ``tune_batch``, a pooled registry drain) and tracing training
(``examples/tracing3d.py`` through the train CLI, ``TracingTrainerRNN``
with the fused carry); the K4
probe at the conv-dense path's kz=1 shapes; and the entry points of the
three kernels no production route runs: K5's benchmark (the im2col dilated
conv, ``csrc/dilated_conv.cu``) and the probes P1 (the ``wgmma`` dot rate
at K1's dot shapes, ``csrc/ptail_dot.cu``) and P2 (K1's own body with its
legs removed one at a time, ``csrc/ptail_ablate.cu``). Phases:

1. device: the card's name, capability, ``nvidia-smi`` name and power limit,
   and the float32 flags (cuDNN and cuBLAS TF32 off, a conv and a matmul
   checked against float64);
2. build: K1, K4, K2, K3, K5, P1 and P2 compiled with ``nvcc`` from the
   checkout's sources, one nvcc per source, all started together; ptxas
   registers and spills, and SASS op counts (``cuobjdump -sass``): every
   instance of K1 and of K4's tensor-core body must hold HGMMAs (the
   tensor-core ``wgmma``) and no library's ptxas report may carry C7514
   (``wgmma`` serialized); both P1 kernels must hold HGMMAs and no HMMA
   and no FFMA loop; per P2 probe, HGMMAs (at least the 9 a stage) exactly
   when it has the dot leg and LDGSTS (``cp.async``) when it has the dma
   leg show that the probed work survived compilation;
3. kernel: each kernel against its plain PyTorch version on the same
   inputs, at the main paths' shapes (timed with CUDA events: plain, kernel,
   kernel, plain; K2 and K3 in CUDA graphs) and at ragged and border shapes, with each timed case's
   bound on an H100: the larger of its bytes at 3.35 TB/s and its FLOPs
   at 67 TFLOP/s FP32 for the FFMA kernels (K2, K3, K5), at 495 / 3
   TFLOP/s for K1, K4, P2 and P1's float32 dots (three TF32 products per
   multiply-add), at 989 TFLOP/s for P1's bf16 dots. K1 and K4:
   ``assert_close`` rtol=atol=1e-4 (float32 sums of up to 27*Cin or 9*Cin
   products in another order). At its eight main-path shapes (the
   flagship's conv2 and conv3 of one request and, at N = 2, of a sweep
   chunk of two (112, 496, 496) slabs; the U-Net's four) K1 is timed in
   turns with its plain version and one ``F.conv3d`` with the bias (its
   library call; no ReLU), and held against a float64 conv on the first 8
   output planes: its ``f64_max_abs`` must be within 2x cuDNN float32's + 1e-6.
   K4 (both bodies, ``head_tc`` and ``head_ffma``, and the wrapper's
   choice) covers the flagship's head units, ragged Y, d=3, Cout past one
   N tile and the probe's shapes; its plain version is the flagship route's
   own cuDNN sequence. At the head units and the probe's shapes the plain
   version, both bodies and, with pool=1, one ``F.conv3d`` with the bias
   are timed in turns, and the tensor-core body is held against float64 on
   8 output planes (within 2x cuDNN float32's + 1e-6).
   K2: atol 1e-5 (values in [0, 1), 8 products per output in another
   order). K3: atol 1e-4 on a 256^3 volume (coordinates near 256 carry an
   ulp of 1.5e-5, which moves a sample by about that much) and ``ok`` equal
   except for agents with a box corner within 1e-4 of a bound (counted).
   Both are expected bit for bit (``bit_exact``). Their times are device
   time per launch: CUDA events around replays of a CUDA graph of 20
   launches (``graph_ms``), with the bytes their windows stage (K3's as its
   own count, ``extract_rot.staging_stats``, which must show no item left
   unstaged).
   K5: rtol=atol=1e-4 (float32 sums of 27*Cin products in another order)
   and its pad channels exactly 0, at its benchmark's perf case (timed, with
   one ``F.conv3d`` as its library call) and correctness case, the JAX
   test's case and a ragged case (Cout 45, Yo 37, Y over-padded);
4. slice: the MFP route (``predict`` + ``fragments2dense``) against
   ``predict_dense_device`` on a patch-sized volume (atol 1e-5), then three
   requests of distinct random 120x496x496 volumes through
   ``predict_dense_device(vol, pad_raw=True)``: shape, finite values, channel
   sums of 1 (within 1e-5), two K1 launches per request, and one request
   against the plain cuDNN route (``pallas_tail=False``, atol 1e-5);
5. head_chain: one request through K4 (conv0) -> K4 (conv1) -> K1 (conv2,
   conv3) -> barrier -> softmax against ``predict_dense_device`` (atol
   1e-5), two K4 and two K1 launches (and K4's tensor-core launches),
   timed against the request;
6. convdense_request: three distinct random 128x448x448 slabs of the
   full-width wide U-Net through ``predict_dense_device(pad_raw=True)``
   under ``set_convdense_impl(zfold=True, skipsum=True, ptail=True)``:
   shape (2, 128, 448, 448), finite values, channel sums of 1 (within
   1e-5), four K1 launches per slab, time, Mvox/s and peak memory; one slab
   against the cuDNN route (``ptail=False``, the bench's configuration;
   atol 1e-4, ``CONVDENSE_ATOL``); then ``convdense_profile``: one warm
   slab under ``torch.profiler``, its top device kernels and K1's share;
7. trace_rollout: ``DeviceTracer.trace_batch`` of B=1024 seeds for K=256
   steps over a 256^3 volume (``min_step=0``): on the card one replay of
   the rollout's CUDA graph (captured once, ``capture_seconds``); one
   replay and one eager rollout under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); then the
   graphed route and the eager loop timed in turns (graphed, eager, eager,
   graphed, graphed, eager): agent-steps/s (B*K / wall) of each, alive
   fraction, K2 launches (K per rollout: the ``trace_batch`` run is
   profiled, and the device's count of K2 launches in it, which goes into
   the kernels line, must equal K and the wrapper's counter, to which a
   replay adds the launches it captured), peak memory, the ``trace_batch``
   wall with its host-side decode (``*_main_profile``: profiled, its idle
   share counts the decode); (d) the graphed rollout equals the eager
   kernel route bit for
   bit (``traj`` and ``moved``); ``*_profile``: one graphed rollout under
   ``torch.profiler`` (device idle share, top device kernels, K2's device
   us per launch); against the plain route (``use_pallas_extract=False``):
   (a) teacher-forced, the plain rollout's positions fed to the kernel at
   every step (atol 1e-5), (b) K=8 rollouts (``traj`` within 1e-4,
   ``alive`` equal), (c) the full horizon, reported (first step over 1e-3,
   share of agents within 1e-3 at the end);
8. trace_rot_rollout: the same with ``rotate_to_heading=True``, B=512, K=64,
   K3 (atol 1e-4 in (a)), and K3's staging count over the ``trace_batch``
   run: no item left unstaged;
9. trace_kzip: ``trace_batch(save_kzip=...)`` on a few agents, read back by
   the port's NML parser; then ``ShotgunRegistry.run`` drains 2*B seeds;
10. kernel (``rotated_patches_bf16``): K3's bf16 mode against its plain
    version (the same bf16 arithmetic in PyTorch; atol ``K3_ATOL``, bit
    for bit expected and reported, ``ok`` equal except near a bound) at
    the rotated tracer's shape, an anisotropic patch (Y % 8 == 0), the ok
    boundary and a ragged Y; at the tracer's shape timed with its plain
    version and the float32 mode (``graph_ms``), its bound (bf16 windows),
    the values it stages (its own count, 2 bytes each) and both modes'
    error against float64 (50th / 99th percentile, max);
11. trace_pool: the translation pools at B=1024, K=256, a queue of 8B
    seeds (``trace_pool`` through its entry point under ``torch.profiler``:
    the device counts K2's launches; every consumed seed decoded once), the
    bench's protocol for the respawning and the chained pool (``pool_rates``:
    effective agent-steps/s, util, beside the raw rate x alive), one wave
    graphed = eager bit for bit and replayed under
    ``set_sync_debug_mode("error")``, and on a 48-seed queue the pools'
    traces against ``trace_batch`` (1e-5);
12. trace_rot_pool: the rotated pools at B=512, K=64, in K3's float32 and
    bf16 modes, the same way (no item left unstaged);
13. tune_batch: candidates 256-2048, 64 steps; the tracer's ``max_steps``
    and kept graph put back, its next ``trace_batch`` a replay;
14. registry_pool: ``ShotgunRegistry.run(pool=True)`` over 16B seeds, its
    seconds split into waves, ``register`` and the k.zip, the k.zip read
    back equal to the traces;
15. train_tracing (run after train_cli): the train CLI on
    ``examples/tracing3d.py`` (300 steps,
    data seeded; its 50-step mean loss must fall), then
    ``TracingTrainerRNN`` with fused chunks on the deployment's model over
    ``AgentData`` on a 256^3 volume, its losses and final ``h0`` against
    the per-step carry on the same batches (1e-5), and a chained pool
    served with the trained weights;
16. headk_probe: the rows of ``elektronn2_tpu_torch.scripts.
    exp_convdense_headk.main()`` (K4 against the zfold cuDNN conv, with
    the body the wrapper ran);
17. k5_main: the rows of ``elektronn2_tpu_torch.ops.experimental.
    dilated_conv.main()``, K5's benchmark;
18. probe_dot: the rows of ``elektronn2_tpu_torch.scripts.exp_ptail_dot.
    main()`` (P1's six configs; each within rtol=atol=1e-3 of its plain
    version in float32, rtol=atol=1e-2 in bf16, the float32 rows within 2x
    the plain float32 version's error against float64 + 1e-6, and none
    faster than its bound), each with its library call, one batched
    ``torch.matmul`` over the same 1024 x 8 dots in the row's type;
19. probe_ablate: the rows of ``elektronn2_tpu_torch.scripts.
    exp_ptail_ablate.main()`` at the canonical tail shape (``k_disp=2``)
    and at the wide U-Net's d1 conv (``k_disp=1``): the eight probes of
    K1's body, ``full`` equal to K1 (``torch.equal``) and within 1e-4 of
    its plain version, ``noepi`` within ``noepi_tol`` of the bare conv (and
    1e-4 at the canonical shape), and
    ``k1_ms``, K1 through its wrapper beside ``full``;
20. train (``train_row``, ``train_profile``, ``train_checks`` per row,
    ``train_serve``): the bench's training net at full width
    (``utils/convert.neuro3d_train_model``, weights from numpy seed 0, Adam
    1e-3) in its two rows, b4 (B=4, 15x54x54 in, K=16 steps a chunk, two
    1x48x128x128 cubes) and slab (B=1, 47x182x182, K=4, two 1x72x200x200
    cubes), cubes from numpy seed 0 with labels = the raw cube thresholded
    at 0.5 (learnable, so the loss can fall), augmented on the card (warp
    0.5, grey on channel 0, flips). ``FusedTrainLoop.run_chunk`` replays one
    CUDA graph per chunk (the main path); graphed and eager chunks timed in
    turns (it/s, input Mvox/s), the graphed chunk again with cuDNN's
    algorithm search on, ``trainingstep`` per step on a fixed batch,
    ``capture_seconds``, peak memory, the FP32 bound of a step (its convs'
    forward and backward FLOPs at 67 TFLOP/s) and one graphed chunk under
    ``torch.profiler`` (device time, idle share, kernels per step, top
    kernels). Checks: (a) one step's gradients against the same step in
    float64 (plain float64 ops), each leaf's relative L2 error within 1e-4
    (TF32 in a backward conv shows about 1e-3); (b) under
    ``cudnn.deterministic`` a graphed chunk equals the eager chunk from the
    same parameters, optimiser state and generator state, bit for bit;
    (c) losses finite, and the mean loss of the last of at least 16 b4
    chunks below the first's; (d) an eager chunk and a replay make no host
    sync (``set_sync_debug_mode("error")``); (e) after the b4 row, a
    64x256x256 request through the trained model's K1 route
    (``set_dilated_impl("direct", zfold=True, pallas_tail=True)``, two K1
    launches, which join the kernels line) equals its cuDNN route within
    ``SLICE_ATOL`` and differs from the same request served before
    training;
20b. train_bn (``train_bn_row``, ``train_bn_checks`` per row,
    ``train_bn_serve``): the same rows, cubes and loop for the batch-normed,
    dropout net (``utils/convert.neuro3d_bn_train_model``: ``simple_cnn``
    with batch norm on every conv and dropout 0.1 on the two (3,3,3)
    convs): the running statistics are written in place inside the chunk
    graph, the masks drawn from the loop's generator. Graph = eager bit for
    bit (losses, parameters, running statistics), the b4 step's gradients
    against float64 with its masks held (the conv biases before batch
    norm, whose exact gradient is 0, against the largest leaf norm), no
    host sync, the b4 loss falls; graphed and eager chunks in turns, a
    profiled chunk. The b4 net is then served: rebuilt with MFP on, through
    ``predict_dense_device`` with ``pallas_tail=True`` (K1 takes no
    batch-normed conv: 0 launches) against the host-tiled MFP route
    (``SLICE_ATOL``), and after ``save`` -> ``modelload`` the same map bit
    for bit;
20c. train_lowering (``train_lowering`` per row and mode,
    ``train_lowering_serve``, ``train_lowering_unet``): the plain rows of
    20. under the default trace, ``set_train_lowering(zfold=True)`` and
    ``set_remat(True)`` from the same start: one step's gradients within
    1e-4 per leaf and the first chunk's losses within 1e-5 of the default's
    (the first chunk also reported under ``cudnn.deterministic``), it/s,
    peak memory, a graphed chunk's
    weight-gradient kernels and, from an eager chunk under the profiler
    with ``record_shapes``, the weight-gradient ms by layer; the
    zfold-trained b4 weights served through K1 (two launches into the
    kernels line, each held against its plain version); the wide U-Net's
    host-fed chunk under ``skipsum`` against the default trace (1e-5, under
    ``cudnn.deterministic``, in each of three runs from fresh models);
21. train_cli (x5, ``train_cli_serve``): the training entry point, the
    train CLI's ``main([...])`` (``elektronn2_tpu_torch/scripts/train.py``)
    on the unchanged example configs into a temporary directory:
    ``examples/neuro3d.py`` (20/30/40/40, 23x102x102, B=1, Adam, warp 0.5,
    grey; per step, two forked ``BackgroundProc`` workers started after the
    first step with CUDA up, each batch staged through pinned buffers, the
    one-step loss lag, validation at its ``history_freq``) for 300 steps,
    ``examples/unet3d_wide.py`` (64/128/256, 16x64x64, warp 0.3;
    ``HostFedFusedLoop``: 4 host batches a CUDA graph replay, the next
    chunk drawn by the prefetch thread) for 64 steps, and
    ``examples/neuro3d_fast.py`` (B=4, bf16 conv operands,
    ``FusedTrainLoop`` on the card, 16 steps a replay) for 96,
    ``examples/mlp_mnist.py`` (Perceptrons with dropout on the synthetic
    digits, one forked worker) for 300 and ``examples/malis3d.py``
    (``MalisNLL``, per step, the pair counting on the host) for 300. The
    calls
    the trainer trains with are wrapped (``CliProbe``): steady-state it/s
    and ms a step from the end of the warm-up (20 steps, or 2 chunks) to a
    ``torch.profiler`` window over the last 20 steps (whole chunks), which
    gives the device's ms a step, the host-to-device copies' ms a step and
    the idle share (1 - device time / window wall); the time the loop
    waited on its workers (``BackgroundProc.get``) a step; the host's
    ``getbatch`` ms a batch and its thrown-away draws, timed alone after
    the run (a tracing trainer's ``get_tracing_batch``); peak memory; the smoothed loss at the first and last step;
    the capture seconds. Checks: every loss finite, the smoothed loss
    falls (last < 0.98 x first), a ``.mdl`` written; then the neuro3d
    weights the CLI saved, through ``modelload``, serve a 64x256x256
    request through K1 (two launches, which join the kernels line) within
    ``SLICE_ATOL`` of the cuDNN route and unlike the request served with
    the weights the run started from; trained probabilities saturate, so
    each K1 launch's own output (conv2, conv3) is also held against cuDNN
    float32 on the same input, within ``K1_SERVE_RTOL`` of the output's
    largest magnitude, with at least ``K1_SERVE_MIN_ACTIVE`` of its voxels
    past the ReLU, and no further from float64 than twice cuDNN's error;
21b. tracing_nodes (``tracing_nodes_prelu`` with its ``_main_profile``,
    ``_profile`` and ``_checks``, run after 7.; ``tracing_nodes_field``,
    run after train_tracing): (a) the tracing model with a 64-wide prelu
    layer between the GRU scan and the step head through every step and
    check of 7. (B=1024, K=256; K2's launches counted by the device in
    ``trace_batch`` and held against the wrapper's count, into the kernels
    line);
    (b) a step head (prelu layer included) trained on ``SkelLossField``
    over the 256^3 field of a helix in ``HostFedFusedLoop`` chunks: graph =
    eager bit for bit, the loss falls; (c) ``SkelLoss`` (the host KD-tree)
    on one batch with the trained weights within 0.6 of ``SkelLossField``;
21c. malis (run after tracing_nodes): the native MALIS core must be the
    one taken and equal the numpy fallback at (6, 20, 20);
    ``examples/malis3d.py``'s net at its own widths on a (1, 1, 16, 128,
    128) input ((14, 124, 124) out, 215k voxels, 646k edges), labels as the
    example makes them: 10 eager ``trainingstep`` calls under the profiler,
    each split into the device forward, the prediction's copy to the host,
    the host pair counting, the weights' copy back and the device backward
    and update (ms a step), the device's idle share, the loss first and
    last (finite), and the loss's gradient in the prediction against
    float64 on the CPU with the same weights (rel L2 <= 1e-5);
21d. reduced_matmuls (``reduced_matmuls_mlp`` x4,
    ``reduced_matmuls_tracer``): ``examples/mlp_mnist.py``'s net in
    graphed ``HostFedFusedLoop`` chunks under float32, bf16, float16 and
    float32 again (each mode recaptures; it/s, losses finite); the bench's
    tracer model (16^3, 64/64, GRU + Perceptron head) in
    ``TracingTrainerRNN`` fused chunks at float32 and bf16 from the same
    weights and batches (it/s, the first chunk's loss deviation, the GRU
    output's deviation, a recapture on each dtype change), and
    ``DeviceTracer`` rollouts of the bf16-set model bit for bit its float32
    rollout;
22. sweep (``sweep_flagship`` x4, ``sweep_flagship_checks``, ``sweep_cli``,
    ``sweep_unet`` x2, ``sweep_unet_checks``): KNOSSOS datasets from numpy
    seeds written in 128^3 cubes by the port's ``save_knossos`` into a
    temporary directory (removed after the phase). The flagship (weights as
    in 4., K1 route) sweeps a 224x992x992 uint8 dataset at the default
    ptail step (112, 496, 496), 8 slabs, through ``Model.sweep_knossos``
    (a fresh ``KnossosArray`` each time, so the cube cache starts empty) at
    slab_batch 1, 2, 2, 1: wall seconds, Mvox/s, host staging and
    write-back ms per slab, peak memory, the out-of-memory fallback count
    and K1's launches; then one sweep at each slab_batch under
    ``torch.profiler``: device (kernel) ms per slab, K1's, the copies', and
    the idle share (1 - kernel time / wall, also against the unprofiled
    walls). Checks: (a) a step-sized block centred on the first seams
    (z 112, x 496, y 496) equals one ``predict_dense_device`` of the raw
    block plus its halo (1e-5); (b) slab_batch 2 equals 1 (1e-5); (c)
    finite, channel sums 1 within 1e-5; (d) no out-of-memory fallback; (e)
    two K1 launches per chunk (each over slab_batch slabs). The predict
    CLI (``scripts/predict.main([... "--ptail", "--knossos-out", ...])``)
    over a 112x496x496 dataset, its uint8 maps read back with
    ``KnossosArray`` equal to clip(sweep x 255) byte for byte; where h5py
    does not import, the CLI's own two calls (``sweep_knossos``,
    ``save_knossos``) run in its place and the line says so. The wide U-Net
    (64/128/256, ``set_convdense_impl(zfold, skipsum, ptail)``) sweeps a
    256x512x512 dataset at step (128, 512, 512), 2 slabs, at slab_batch 1
    and 2 (running out of memory at 2 falls back per slab and is reported,
    not failed); checks (b), (c) and the first slab against one
    ``predict_dense_device`` of the slab as staged (1e-4). K1's launches in
    the timed sweeps and the CLI join the kernels line. Inside the sweep
    phase, reduced-precision serving's entry points: after the flagship's
    timed sweeps ``Model.tune_serving(apply=True)`` over every contender
    (direct, direct + K1, bf16, int8 stored in bf16) at
    ``DEFAULT_TUNE_STEPS_3D`` clamped to the dataset, slab batches 1 and 2,
    K=4 (``tune_flagship_row``: one line a row, each with its largest map
    and whether it passes 2^31; ``tune_flagship``), then the sweep with the
    winner's step and slab batch beside the default sweep's Mvox/s, its
    output within 1e-5 of the default's for a float32 winner, else at the
    winner's argmax floor (``tune_flagship_sweep``); after ``sweep_cli``
    the predict CLI with ``--tune``, ``--int8`` and ``--bf16`` (``-o ''``),
    each CLI's maps equal to the API's sweep under the same settings byte
    for byte (``cli_modes``), and ``elektronn2-torch-profile`` on the
    flagship at two sizes (``cli_profile``); after the U-Net sweep its six
    conv-dense contenders at one (128, 448, 448) slab, K=2, every one with
    skipsum (``tune_unet_row``, ``tune_unet``: dilate against d2s);
23. quant_conv (run before the sweep): ``ops.conv.quantized_conv`` at the
    flagship's conv2 and conv3 and the wide U-Net's d1 conv (256 -> 128,
    seven channel groups) and UpConv u0, random operands and every operand
    +-127 with aligned signs (sums past 2^24 where the shapes allow), each
    equal bit for bit, on ``QUANT_F64_PLANES`` output planes, to a float64
    conv of the same int8 values times the scale; timed in turns beside
    ``F.conv3d`` (``F.conv_transpose3d``) in float32 and bf16;
24. serve_dtypes: one warm 120x496x496 flagship request in each of
    ``SERVE_MODES`` (float32 cuDNN, K1, bf16, bf16 stored, int8, int8
    stored, int8 calibrated) and a 128x448x448 wide U-Net slab in
    ``UNET_SERVE_MODES`` (K1, bf16, int8): ms, Mvox/s, peak, max and
    p99.9 abs deviation from the first mode, argmax agreement (above
    ``ARGMAX_FLOOR``: bf16 0.95, int8 0.97), finite maps, K1's launches
    (2 / 4 in the K1 modes, which join the kernels line, 0 in the others);
25. train_dp (after reduced_matmuls): ``examples/neuro3d_pod.py``
    through the train CLI under a mesh of one (NCCL, graphed chunks of 8),
    a mesh of one against no mesh (eager steps and graphed chunks, equal
    to 1e-6; the NCCL kernels counted in a profiled replay, at least one a
    step; both timed in turns), two gloo ranks on CUDA tensors against one
    process, and the trained weights served through K1 (one launch, which
    joins the kernels line).

Each phase prints JSON lines; then the kernels line (per kernel: launches
on the main paths, the largest error against its plain version, ms,
plain_ms, bound_ms, bound_by, library_ms; K4's are summed over the
probe's pool=1 shapes, where one ``F.conv3d`` is its library call; P1's
are its float32 (120, 360, 512) row: ``ms`` and ``library_ms`` one call of
1024 cells x 8 dots, ``plain_ms`` the 8 dots once), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
the exit code is not 0. Without a CUDA device it exits non-zero before any result.
Usage, from the repository root: ``python3 chip_smoke.py``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from elektronn2_tpu_torch.data.knossos_array import KnossosArray, save_knossos
from elektronn2_tpu_torch.data.skeleton import read_nml_file
from elektronn2_tpu_torch.data.tracing_utils import (DeviceTracer,
                                                     ShotgunRegistry,
                                                     flight_frame)
from elektronn2_tpu_torch.neuromancer import inference
from elektronn2_tpu_torch.neuromancer.model import modelload
from elektronn2_tpu_torch.ops import extract, extract_rot, tailconv
from elektronn2_tpu_torch.ops.conv import f32_convs, f32_matmuls
from elektronn2_tpu_torch.ops.experimental import dilated_conv
from elektronn2_tpu_torch.ops.mfp import fragments2dense
from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
from elektronn2_tpu_torch.scripts import (exp_convdense_headk,
                                          exp_ptail_ablate, exp_ptail_dot,
                                          predict)
from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
from elektronn2_tpu_torch.utils.convert import (flagship_model,
                                                neuro3d_bn_train_model,
                                                neuro3d_train_model,
                                                tracer_model,
                                                wide_unet_model)
from elektronn2_tpu_torch.utils.cuda_build import find_nvcc
from elektronn2_tpu_torch.utils.device_timing import (best_ms, bound_ms,
                                                      conv3x3_bound, graph_ms,
                                                      in_turns, palindrome_ms,
                                                      time_ms)

SEED = 0
REQ_SHAPE = (1, 120, 496, 496)          # (f, Z, X, Y) of one request
N_REQUESTS = 3
SLAB_SHAPE = (1, 128, 448, 448)         # one conv-dense slab of the U-Net
N_SLABS = 3
# K1 route vs cuDNN route on the wide U-Net: float32 sums of up to 6912
# products (d1: 27 taps x 256 channels) in another order, through 9 layers
CONVDENSE_ATOL = 1e-4
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
SLICE_ATOL = 1e-5
K2_ATOL = 1e-5
K3_ATOL = 1e-4
TRACE_VOL = (1, 256, 256, 256)          # the tracing deployment's volume
TRACE_PATCH = (16, 16, 16)
TRACE_B, TRACE_K = 1024, 256            # translation rollout
TRACE_SEEDS = (10, 246)                 # seeds uniform in this range
ROT_B, ROT_K = 512, 64                  # rotated rollout
ROT_SEEDS = (24, 232)
SHORT_K = 8                             # check (b)
ROLLOUT_ATOL = 1e-4                     # check (b)
HORIZON_TOL = 1e-3                      # check (c), reported


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_device():
    smi = nvidia_smi_line()
    x = torch.rand(1, 8, 6, 40, 40, device="cuda") - 0.5
    w = torch.rand(8, 8, 3, 3, 3, device="cuda") - 0.5
    with f32_convs():
        y = torch.nn.functional.conv3d(x, w, dilation=(1, 2, 2))
        flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cudnn.conv.fp32_precision": getattr(
                     getattr(torch.backends.cudnn, "conv", None),
                     "fp32_precision", None)}
    y64 = torch.nn.functional.conv3d(x.double(), w.double(),
                                     dilation=(1, 2, 2))
    f32_err = (y.double() - y64).abs().max().item()
    # the tracer encoder's matmul shape: (B, 16^3) @ (16^3, 64)
    a = torch.rand(1024, 4096, device="cuda") - 0.5
    b = torch.rand(4096, 64, device="cuda") - 0.5
    mm = torch.backends.cuda.matmul
    with f32_matmuls():
        c = a @ b
        try:
            flags["cuda.matmul.fp32_precision"] = mm.fp32_precision
        except AttributeError:
            flags["cuda.matmul.allow_tf32"] = mm.allow_tf32
    mm_err = (c.double() - a.double() @ b.double()).abs().max().item()
    emit("device", name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         f32_flags=flags, cudnn_vs_f64_max_abs=f32_err,
         cublas_vs_f64_max_abs=mm_err)
    # TF32 keeps ~3 decimal digits: its error here would be ~1e-3
    if f32_err > 1e-5:
        raise AssertionError(f"cuDNN conv is not full float32: {f32_err}")
    # sums of 4096 products, of magnitude ~5: float32 errs ~1e-5, TF32 ~1e-2
    if mm_err > 1e-4:
        raise AssertionError(f"cuBLAS matmul is not full float32: {mm_err}")
    return smi


SASS_OPS = ("FFMA", "HMMA", "HGMMA", "LDG", "LDGSTS", "STG", "LDS", "STS")


def sass_counts(path):
    """{kernel function: {op: count}} of the SASS in a built library
    (``cuobjdump -sass``, from nvcc's directory), for the ops in
    ``SASS_OPS``; instructions predicated on ``!PT`` (never executed: the
    compiler's ``@!PT LDS RZ, [RZ]`` fillers) are not counted."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True, timeout=300)
    counts, fn = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None and "@!PT" not in ln:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", ln):
                counts[fn][op] += 1
    return counts


#: P2's probes with the dot leg (9 ``wgmma`` a stage) and with the dma leg
P2_DOT = ("full", "nostage", "noepi", "dotonly")
P2_DMA = ("full", "nodot", "nostage", "noepi", "none", "dmaonly")


def check_probe_sass(kernel, counts):
    """The probes run what they claim: both of P1's kernels (each with its
    dot-only instance) hold HGMMAs (``wgmma``), no HMMA (``mma.sync``) and
    fewer than 64 FFMAs (the FFMA dot of before had 512 a k step); in P2,
    at each N tile of ``exp_ptail_ablate.N_TILES``, every probe with the dot
    leg holds at least K1's 9 HGMMAs a stage and the others none, and every
    probe with the dma leg holds LDGSTS (``cp.async``)."""
    if kernel == "ptail_dot":
        for key in ("dot_tf32_kernel", "dot_bf16_kernel"):
            got = [c for f, c in counts.items() if key in f]
            if len(got) != 2 or any(c["HGMMA"] < 1 or c["HMMA"]
                                    or c["FFMA"] >= 64 for c in got):
                raise AssertionError(f"ptail_dot {key}: SASS {got}")
        return
    inst = {(int(m.group(1)), int(m.group(2))): c for f, c in counts.items()
            for m in [re.search(r"tailconv_tc_kernelILi(\d+)ELi(\d+)EE", f)]
            if m}
    want = sorted((nt, i) for nt in exp_ptail_ablate.N_TILES
                  for i in range(len(exp_ptail_ablate.PROBES)))
    if sorted(inst) != want:
        raise AssertionError(f"ptail_ablate: instances {sorted(inst)}")
    for (nt, i), c in inst.items():
        name = exp_ptail_ablate.PROBES[i]
        if ((c["HGMMA"] < 9 if name in P2_DOT else c["HGMMA"] > 0)
                or (name in P2_DMA and c["LDGSTS"] < 1)):
            raise AssertionError(f"ptail_ablate {name} N {nt}: SASS {c}")


def phase_build():
    """One nvcc per kernel source, all started together; each library's
    ptxas report and SASS op counts, the probes' checked."""
    builds = {"conv3x3_dilated": tailconv.build,
              "conv1x3x3_pool_dilated": tailconv.build_head,
              "trilinear_patches": extract.build,
              "rotated_patches": extract_rot.build,
              "dilated_conv": dilated_conv.build,
              "ptail_dot": exp_ptail_dot.build,
              "ptail_ablate": exp_ptail_ablate.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(b) for k, b in builds.items()}
        libs = {k: f.result() for k, f in futs.items()}
    wall = time.perf_counter() - t0
    for k, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        sass = sass_counts(lib.path)
        emit("build", kernel=k, library=lib.path,
             nvcc_seconds=lib.build_seconds, wall_seconds=wall, ptxas=ptxas,
             sass=sass)
        if k in ("ptail_dot", "ptail_ablate"):
            check_probe_sass(k, sass)
        # the tensor-core kernels (every instance of K1, K4's tc body): no
        # instance may have lost its wgmma; and ptxas must not have
        # serialized a wgmma (warning C7514: non-wgmma code reads live
        # accumulators) in any library
        tc = {"conv3x3_dilated": "tailconv_tc_kernel",
              "conv1x3x3_pool_dilated": "headconv_tc_kernel"}.get(k)
        if tc is not None:
            inst = [c["HGMMA"] for f, c in sass.items() if tc in f]
            if not inst or min(inst) < 1:
                raise AssertionError(f"{k}: no HGMMA in some instance: {sass}")
        if "C7514" in lib.build_log:
            raise AssertionError(f"{k}: ptxas serialized wgmma (C7514)")


#: input z-planes of K1's float64 check (8 output planes)
F64_PLANES = 10


def conv3d_f32(x, w, b, dil):
    """K1's library call: one ``F.conv3d`` with the bias (no ReLU), in full
    float32."""
    with f32_convs():
        return torch.nn.functional.conv3d(x, w, b, dilation=dil)


def f64_errors(x, w, b, dil):
    """(K1, cuDNN float32) max abs against a float64 conv + bias + ReLU, on
    the first ``F64_PLANES`` input z-planes of ``x``."""
    xs = x[:, :, :F64_PLANES].contiguous()
    ref = torch.relu(torch.nn.functional.conv3d(
        xs.double(), w.double(), b.double(), dilation=dil))
    k1 = tailconv.conv3x3_dilated(xs, w, b, dil).double()
    cudnn = torch.relu(conv3d_f32(xs, w, b, dil)).double()
    return ((k1 - ref).abs().max().item(),
            (cudnn - ref).abs().max().item())


#: cuDNN's calls stay within 32-bit indexing up to this many elements a
#: tensor; past it they take its 64-bit-indexed kernels, several times
#: slower (PERF.md section 5)
INT32_ELEMS = 2**31 - 1


def k1_plain(x, w, b, dil):
    """K1's plain version, ``conv3x3_dilated_reference``; where ``x`` or
    the output passes ``INT32_ELEMS`` elements, over z-chunks of the output
    that each stay within it, concatenated (the same values)."""
    n, cin, z, X, Y = x.shape
    plane_in = n * cin * X * Y
    plane_out = n * w.shape[0] * (X - 2 * dil[1]) * (Y - 2 * dil[2])
    if x.numel() <= INT32_ELEMS and (z - 2) * plane_out <= INT32_ELEMS:
        return tailconv.conv3x3_dilated_reference(x, w, b, dil)
    k = min(INT32_ELEMS // plane_in - 2, INT32_ELEMS // plane_out)
    return torch.cat([tailconv.conv3x3_dilated_reference(
        x[:, :, z0:z0 + k + 2], w, b, dil) for z0 in range(0, z - 2, k)],
        dim=2)


def phase_kernel():
    """K1 against its plain version; returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms) with the times summed over the main
    path's conv2 + conv3 shapes; the library call is one ``F.conv3d`` with
    the bias (no ReLU), in full float32. At the timed shapes and the U-Net
    sweep's (``unet512_*``, untimed) K1 is also held against float64
    (``f64_errors``)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # name, N, Cin, Cout, (Z, X, Y), dil
        ("conv2", 1, 30, 40, (124, 512, 512), (1, 4, 4)),
        ("conv3", 1, 40, 40, (122, 504, 504), (1, 4, 4)),
        # the wide U-Net's K1 convs at one 128x448x448 slab (pad_raw)
        ("wide_e1a", 1, 64, 128, (136, 238, 238), (1, 1, 1)),
        ("wide_e1b", 1, 128, 128, (134, 236, 236), (1, 1, 1)),
        ("wide_bott", 1, 128, 256, (132, 117, 117), (1, 1, 1)),
        ("wide_d1", 1, 256, 128, (130, 230, 230), (1, 1, 1)),
        # the same convs in the U-Net sweep's (128, 512, 512) slab (staged
        # 136x543x543, padded to 136x544x544); d1's input passes 2^31
        # elements
        ("unet512_e1a", 1, 64, 128, (136, 270, 270), (1, 1, 1)),
        ("unet512_e1b", 1, 128, 128, (134, 268, 268), (1, 1, 1)),
        ("unet512_bott", 1, 128, 256, (132, 133, 133), (1, 1, 1)),
        ("unet512_d1", 1, 256, 128, (130, 262, 262), (1, 1, 1)),
        # the flagship's conv2 and conv3 in a sweep chunk of two
        # (112, 496, 496) slabs with their halo (slab_batch=2)
        ("sweep_conv2_n2", 2, 30, 40, (116, 512, 512), (1, 4, 4)),
        ("sweep_conv3_n2", 2, 40, 40, (114, 504, 504), (1, 4, 4)),
        ("ragged_d1", 2, 3, 5, (6, 14, 20), (1, 1, 1)),
        ("ragged_d23", 2, 3, 5, (5, 20, 30), (1, 2, 3)),
        ("ragged_cout45", 1, 30, 45, (5, 40, 300), (1, 4, 4)),
    ]
    max_err, ms_sum, plain_sum, bound_sum, lib_sum = 0.0, 0.0, 0.0, 0.0, 0.0
    by = None
    for name, N, cin, cout, sp, dil in cases:
        x = torch.rand((N, cin) + sp, device="cuda", generator=g) - 0.5
        w = (torch.rand(cout, cin, 3, 3, 3, device="cuda", generator=g)
             - 0.5) * (2.0 / (27 * cin)) ** 0.5
        b = torch.rand(cout, device="cuda", generator=g) * 0.2 - 0.1
        got = tailconv.conv3x3_dilated(x, w, b, dil)
        ref = k1_plain(x, w, b, dil)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        del ref
        rec = dict(case=name, x=[N, cin, *sp], cout=cout, dil=list(dil),
                   max_abs_err=err)
        if name.startswith("sweep"):    # each item as its N = 1 launch
            rec["items_equal_n1"] = all(
                torch.equal(got[i], tailconv.conv3x3_dilated(
                    x[i:i + 1], w, b, dil)[0]) for i in range(N))
            if not rec["items_equal_n1"]:
                emit("kernel", **rec)
                raise AssertionError(f"K1 {name}: an item differs from its "
                                     "own N = 1 launch")
        del got
        if name in ("conv2", "conv3") or name.startswith(
                ("wide", "sweep", "unet512")):
            k64, c64 = f64_errors(x, w, b, dil)
            rec.update(f64_max_abs=k64, cudnn_f64_max_abs=c64)
            if k64 > 2 * c64 + 1e-6:
                emit("kernel", **rec)
                raise AssertionError(f"K1 {name}: {k64} from float64, over "
                                     f"2x cuDNN float32's {c64} + 1e-6")
        if name in ("conv2", "conv3") or name.startswith(("wide", "sweep")):
            # in turns: plain, kernel, library, then reversed
            pms, ms, lms = palindrome_ms([
                lambda: tailconv.conv3x3_dilated_reference(x, w, b, dil),
                lambda: tailconv.conv3x3_dilated(x, w, b, dil),
                lambda: conv3d_f32(x, w, b, dil)])
            zo, xo, yo = sp[0] - 2, sp[1] - 2 * dil[1], sp[2] - 2 * dil[2]
            flop = 2.0 * N * cout * cin * 27 * zo * xo * yo
            bound, by = conv3x3_bound(cin, cout, x.numel(),
                                      N * cout * zo * xo * yo)
            rec.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
                       bound_by=by, kernel_tflop_s=flop / ms / 1e9,
                       library_tflop_s=flop / lms / 1e9,
                       plain_tflop_s=flop / pms / 1e9)
            if name in ("conv2", "conv3"):      # the flagship's main path
                ms_sum += ms
                plain_sum += pms
                bound_sum += bound
                lib_sum += lms
        emit("kernel", **rec)
        del x, w, b
    torch.cuda.empty_cache()
    return max_err, ms_sum, plain_sum, bound_sum, by, lib_sum


K4_CASES = [  # name, N, Cin, Cout, (Z, X, Y), d, pool, timed (N=1)
    # the flagship's head units at one 120x496x496 request (pad_raw)
    ("conv0", 1, 1, 20, (124, 521, 521), 1, 2, True),
    ("conv1", 1, 20, 30, (124, 518, 518), 2, 2, True),
    ("ragged_y", 1, 20, 30, (4, 60, 301), 2, 2, False),
    ("d3_pool2", 2, 3, 5, (3, 40, 45), 3, 2, False),
    # Cout past one 64-channel group with pool 2, and a 128 N tile (pool 1)
    ("cout72_pool2", 1, 9, 72, (2, 30, 140), 2, 2, False),
    ("cout128_pool1", 1, 11, 128, (2, 20, 140), 1, 1, False),
]


def head_f64_errors(x, w, b, d, pool):
    """(tensor-core body, cuDNN float32) max abs against a float64 conv +
    bias (+ pool) + ReLU on the first ``F64_PLANES`` - 2 z-planes of ``x``
    (kz = 1: as many output planes as K1's check)."""
    xs = x[:, :, :F64_PLANES - 2].contiguous()
    ref = tailconv.conv1x3x3_pool_reference(xs.double(), w.double(),
                                            b.double(), (d, d), pool)
    tc = tailconv.head_tc(xs, w, b, (d, d), pool).double()
    cudnn = tailconv.conv1x3x3_pool_reference(xs, w, b, (d, d), pool).double()
    return ((tc - ref).abs().max().item(), (cudnn - ref).abs().max().item())


def phase_kernel_k4():
    """K4 against its plain version (``assert_close`` 1e-4), both bodies
    (``head_tc``, ``head_ffma``) and the wrapper's choice, at the flagship's
    head shapes, ragged Y, d=3, Cout past one N tile and the probe's
    shapes. The plain version is the flagship route's own cuDNN sequence
    (conv3d + bias, max_pool3d, ReLU), so its time is that route's. At the
    timed shapes the plain version, both bodies and, with pool=1, the
    library call (one ``F.conv3d`` with the bias; no ReLU) are timed in
    turns, and the tensor-core body is held against float64
    (``head_f64_errors``, within 2x cuDNN float32's + 1e-6). Returns
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms) summed over
    the probe's shapes, all pool=1: the conv-dense path's kz=1 layers,
    where one ``F.conv3d`` is the library call; ``ms`` is the body the
    wrapper ran."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    probe = [(n, 1, ci, co, sp, 1, 1, True)
             for n, ci, co, sp in exp_convdense_headk.cases()]
    max_err, sums, parts = 0.0, [0.0] * 4, []
    for name, N, cin, cout, sp, d, pool, timed in K4_CASES + probe:
        x = torch.rand((N, cin) + sp, device="cuda", generator=g) - 0.5
        w = (torch.rand(cout, cin, 1, 3, 3, device="cuda", generator=g)
             - 0.5) * (2.0 / (9 * cin)) ** 0.5
        b = torch.rand(cout, device="cuda", generator=g) * 0.2 - 0.1
        body = tailconv.head_body(cin, cout, pool)
        ref = tailconv.conv1x3x3_pool_reference(x, w, b, (d, d), pool)
        errs = {}
        for fn, key in ((tailconv.conv1x3x3_pool_dilated, "wrapper"),
                        (tailconv.head_tc, "tc"), (tailconv.head_ffma, "ffma")):
            got = fn(x, w, b, (d, d), pool)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **KERNEL_TOL)
            errs[key] = (got - ref).abs().max().item()
            del got
        del ref
        max_err = max(max_err, *errs.values())
        rec = dict(kernel="conv1x3x3_pool_dilated", case=name,
                   x=[N, cin, *sp], cout=cout, d=d, pool=pool, body=body,
                   max_abs_err=errs["wrapper"], tc_max_abs_err=errs["tc"],
                   ffma_max_abs_err=errs["ffma"])
        if timed:
            k64, c64 = head_f64_errors(x, w, b, d, pool)
            rec.update(f64_max_abs=k64, cudnn_f64_max_abs=c64)
            if k64 > 2 * c64 + 1e-6:
                emit("kernel", **rec)
                raise AssertionError(f"K4 {name}: {k64} from float64, over "
                                     f"2x cuDNN float32's {c64} + 1e-6")
            fns = [lambda: tailconv.conv1x3x3_pool_reference(x, w, b, (d, d),
                                                             pool),
                   lambda: tailconv.head_tc(x, w, b, (d, d), pool),
                   lambda: tailconv.head_ffma(x, w, b, (d, d), pool)]
            if pool == 1:
                fns.append(lambda: conv3d_f32(x, w, b, (1, d, d)))
            pms, tms, fms, *lms = palindrome_ms(fns)
            ms = tms if body == "tc" else fms
            lms = lms[0] if lms else None
            bound, by = exp_convdense_headk.head_bound_ms(cin, cout, sp, d,
                                                          pool)
            rec.update(ms=ms, plain_ms=pms, tc_ms=tms, ffma_ms=fms,
                       library_ms=lms, bound_ms=bound, bound_by=by,
                       body_within_5pct=ms <= 1.05 * min(tms, fms))
            if pool == 1:
                for k, v in enumerate((ms, pms, bound, lms)):
                    sums[k] += v
                parts.append((bound, by))
        emit("kernel", **rec)
        del x, w, b
        torch.cuda.empty_cache()
    ms, pms, bound, lms = sums
    return max_err, ms, pms, bound, max(parts)[1], lms


def k2_cases(rng):
    """(name, vol, pos, patch, timed) for K2: the tracer's shape, a ragged
    patch with two channels, and positions on every border (inside, on and
    past each bound, so the clip and the fraction taken before it are
    hit)."""
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    pos = rng.uniform(*TRACE_SEEDS, (TRACE_B, 3))
    yield "tracer", vol, pos, TRACE_PATCH, True
    dims = np.asarray(TRACE_VOL[1:], np.float64)
    border = []
    for d in range(3):
        edge = (TRACE_PATCH[d] - 1) / 2.0
        for v in (-2.4, 0.0, 0.3, edge, edge + 0.25, dims[d] - edge - 2.0,
                  dims[d] - edge - 1.5, dims[d] - 1.25, dims[d],
                  dims[d] + 1.7):
            p = dims / 2.0 + 0.37
            p[d] = v
            border.append(p)
    yield "borders", vol, np.asarray(border), TRACE_PATCH, False
    vol2 = torch.from_numpy(rng.rand(2, 30, 40, 50).astype(np.float32)).cuda()
    yield "ragged_f2", vol2, rng.uniform(-3, 53, (3, 3)), (5, 7, 9), False


def k3_cases(rng):
    """(name, vol, pos, frames, patch, timed) for K3: the rotated tracer's
    shape with random unit headings, an anisotropic patch with two
    channels, and agents whose lowest box corner sits at the ok bound."""
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    h = rng.randn(ROT_B, 3)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    yield ("tracer", vol, rng.uniform(*ROT_SEEDS, (ROT_B, 3)), h,
           TRACE_PATCH, True)
    vol2 = torch.from_numpy(rng.rand(2, 40, 48, 56).astype(np.float32)).cuda()
    yield ("aniso_f2", vol2, rng.uniform(4, 36, (64, 3)), rng.randn(64, 3),
           (4, 8, 6), False)
    # ok boundary: shift each agent so that its lowest corner along one axis
    # lands at 0 + delta
    hb = rng.randn(96, 3)
    F = flight_frame(torch.from_numpy(hb.astype(np.float32))).numpy()
    half = (np.asarray(TRACE_PATCH) - 1) / 2.0
    signs = np.asarray([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                        for c in (-1, 1)])
    low = np.einsum("bji,kj->bki", F, signs * half).min(axis=1)   # (B, 3)
    pos = np.tile(np.asarray(TRACE_VOL[1:], np.float64) / 2.0, (96, 1))
    deltas = (-1e-3, -1e-4, -1e-5, 0.0, 1e-5, 1e-4, 1e-3, 0.1)
    for i in range(96):
        d = i % 3
        pos[i, d] = -low[i, d] + deltas[i % len(deltas)]
    yield "ok_boundary", vol, pos, hb, TRACE_PATCH, False


def near_bound_agents(vol_shape, pos, F, patch, tol=1e-4):
    """(B,) agents with a patch-box corner within ``tol`` of a bound (0 or
    dims-2), in float64."""
    half = (np.asarray(patch) - 1) / 2.0
    signs = np.asarray([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                        for c in (-1, 1)])
    c = (pos.double().cpu().numpy()[:, None, :]
         + np.einsum("bji,kj->bki", F.double().cpu().numpy(), signs * half))
    hi = np.asarray(vol_shape[1:], np.float64) - 2.0
    return (np.abs(c).min(axis=(1, 2)) < tol) \
        | (np.abs(c - hi).min(axis=(1, 2)) < tol)


def patch_bound(B, f, patch, in_bytes, flop_per_sample, window_bytes=4):
    """(bound ms, 'bytes' or 'operations') of a batched patch cut on an
    H100: each agent's (p+1)^3 window of the volume read once (the voxels
    its samples touch, ``window_bytes`` each), its other inputs
    (``in_bytes``) read once and the float32 patches written once, against
    its arithmetic over the FP32 rate."""
    samples = B * f * int(np.prod(patch))
    window = B * f * int(np.prod([p + 1 for p in patch]))
    return bound_ms(window_bytes * window + 4.0 * samples + in_bytes,
                    flop_per_sample * samples)


def phase_kernel_k2():
    """K2 against its plain version; returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms) at the tracer's shape. Times are device
    time per launch: CUDA events around replays of a CUDA graph of 20
    launches, the kernel and the plain version in turns (``graph_ms``).
    No single PyTorch call computes K2:
    ``grid_sample`` clamps its samples, where K2 takes the fraction before
    it clips the window's base."""
    rng = np.random.RandomState(SEED + 2)
    max_err, ms, pms = 0.0, None, None
    for name, vol, pos, patch, timed in k2_cases(rng):
        pos = torch.from_numpy(pos.astype(np.float32)).cuda()
        got = extract.trilinear_patches(vol, pos, patch)
        ref = extract.trilinear_patches_reference(vol, pos, patch)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=K2_ATOL, rtol=0)
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        rec = dict(kernel="trilinear_patches", case=name,
                   vol=list(vol.shape), B=pos.shape[0], patch=list(patch),
                   max_abs_err=err, bit_exact=bool(torch.equal(got, ref)))
        if timed:
            pms, ms = graph_ms([
                lambda: extract.trilinear_patches_reference(vol, pos, patch),
                lambda: extract.trilinear_patches(vol, pos, patch)])
            bound = patch_bound(pos.shape[0], vol.shape[0], patch,
                                4.0 * pos.numel(), 21)
            rec.update(ms=ms, plain_ms=pms, bound_ms=bound[0],
                       bound_by=bound[1], library_ms=None,
                       timing="cuda graph of 20 launches, CUDA events",
                       staged_bytes=4 * pos.shape[0] * vol.shape[0]
                       * extract.staged_floats(patch))
        emit("kernel", **rec)
    return (max_err, ms, pms) + bound + (None,)


def phase_kernel_k3():
    """K3 against its plain version; returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms) at the rotated tracer's shape, timed
    as K2's (``graph_ms``), with the bytes its staged boxes read beside the
    bound (its own count). Every case must stage every item. No single
    PyTorch call computes K3:
    ``grid_sample`` has no ``ok`` flag."""
    rng = np.random.RandomState(SEED + 3)
    max_err, ms, pms = 0.0, None, None
    for name, vol, pos, heads, patch, timed in k3_cases(rng):
        pos = torch.from_numpy(pos.astype(np.float32)).cuda()
        F = flight_frame(torch.from_numpy(heads.astype(np.float32)).cuda())
        stats = extract_rot.staging_stats(vol.device)
        stats.zero_()
        got, ok = extract_rot.rotated_patches(vol, pos, F, patch)
        ref, ok_ref = extract_rot.rotated_patches_reference(vol, pos, F,
                                                            patch)
        unstaged, staged = stats.tolist()
        if unstaged:
            raise AssertionError(f"K3 {name}: {unstaged} items not staged")
        torch.testing.assert_close(got, ref, atol=K3_ATOL, rtol=0)
        near = near_bound_agents(vol.shape, pos, F, patch)
        differ = (ok != ok_ref).cpu().numpy()
        if (differ & ~near).any():
            raise AssertionError(f"K3 {name}: ok differs from the plain "
                                 f"version for {int(differ.sum())} agents, "
                                 f"{int((differ & ~near).sum())} of them "
                                 "not near a bound")
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        rec = dict(kernel="rotated_patches", case=name, vol=list(vol.shape),
                   B=pos.shape[0], patch=list(patch), max_abs_err=err,
                   staged_bytes=4 * staged,
                   bit_exact=bool(torch.equal(got, ref)),
                   ok_fraction=ok.float().mean().item(),
                   ok_differ=int(differ.sum()),
                   near_bound_agents=int(near.sum()))
        if timed:
            pms, ms = graph_ms([
                lambda: extract_rot.rotated_patches_reference(vol, pos, F,
                                                              patch),
                lambda: extract_rot.rotated_patches(vol, pos, F, patch)])
            # per sample: the frame rotation (9 multiply-adds), the blend
            bound = patch_bound(pos.shape[0], vol.shape[0], patch,
                                4.0 * (pos.numel() + F.numel()), 39)
            rec.update(ms=ms, plain_ms=pms, bound_ms=bound[0],
                       bound_by=bound[1], library_ms=None,
                       timing="cuda graph of 20 launches, CUDA events")
        emit("kernel", **rec)
    return (max_err, ms, pms) + bound + (None,)


K5_CASES = [  # name, (Z, X, Cin, Y), Cout, d, Yo, timed
    # the benchmark's perf case (its __main__), Y over-padded 520 -> 640
    ("perf", (44, 307, 30, 640), 40, 4, 512, True),
    ("correct", (12, 12, 5, 136), 7, 4, 128, False),
    # tests/test_pallas_experimental.py's case, Y over-padded 132 -> 256
    ("jax_test", (8, 8, 5, 256), 7, 2, 128, False),
    # Cout 45 -> Cout_pad 48 (two channel groups, three pad rows), ragged Yo
    ("ragged", (6, 9, 3, 50), 45, 1, 37, False),
]


def phase_kernel_k5():
    """K5 against its plain version (``dilated_conv.check``: rtol=atol=1e-4,
    pad channels exactly 0); returns (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms) at the benchmark's perf case. The library call is
    one ``F.conv3d`` on the same input in NCDHW (transposed outside the
    timed window), in full float32."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    max_err = 0.0
    for name, sp, cout, d, yo, timed in K5_CASES:
        cin = sp[2]
        x = torch.rand(sp, device="cuda", generator=g) - 0.5
        w = (torch.rand(cout, cin, 3, 3, 3, device="cuda", generator=g)
             - 0.5) * (2.0 / (27 * cin)) ** 0.5
        got = dilated_conv.dilated_conv(x, w, d, yo)
        err = dilated_conv.check(
            got, dilated_conv.dilated_conv_reference(x, w, d, yo), cout)
        max_err = max(max_err, err)
        rec = dict(kernel="dilated_conv", case=name, x=list(sp), cout=cout,
                   d=d, Yo=yo, out=list(got.shape), max_abs_err=err,
                   pad_rows_zero=True)
        if timed:
            ms, pms = in_turns(
                lambda: dilated_conv.dilated_conv(x, w, d, yo),
                lambda: dilated_conv.dilated_conv_reference(x, w, d, yo))
            xn = x[..., :yo + 2 * d].permute(2, 0, 1, 3)[None].contiguous()
            with f32_convs():
                lms = time_ms(lambda: torch.nn.functional.conv3d(
                    xn, w, dilation=(d, d, d)))
            bound, by = dilated_conv.conv_bound(x, w, got)
            flop = dilated_conv.conv_flop(sp[0] - 2 * d, sp[1] - 2 * d, yo,
                                          cin, cout)
            rec.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
                       bound_by=by, kernel_tflop_s=flop / ms / 1e9,
                       library_tflop_s=flop / lms / 1e9)
            row = (ms, pms, bound, by, lms)
            del xn
        emit("kernel", **rec)
        del x, w, got
    torch.cuda.empty_cache()
    return (max_err,) + row


def phase_k5_main():
    """K5's entry point, its benchmark (``dilated_conv.main()``, the port of
    the JAX module's ``__main__``); returns its kernel launches."""
    dilated_conv.launches = 0
    for row in dilated_conv.main():
        emit("k5_main", **row)
    launches = dilated_conv.launches
    torch.cuda.empty_cache()
    return launches


def phase_probe_dot():
    """P1's entry point, ``exp_ptail_dot.main()`` (its six configs, each held
    against its plain version inside, the float32 rows also against
    float64, each with its batched library call); returns (launches,
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms)) with the
    times of the float32 (120, 360, 512) config. A time below the bound
    would mean the compiler removed work: it fails."""
    exp_ptail_dot.launches = 0
    rows = exp_ptail_dot.main()
    launches = exp_ptail_dot.launches
    for row in rows:
        emit("probe_dot", **row)
        if row["ms"] < row["bound_ms"]:
            raise AssertionError(f"probe_dot {row}: faster than its bound")
    torch.cuda.empty_cache()
    r = rows[0]
    return launches, (max(x["max_abs_err"] for x in rows), r["ms"],
                      r["plain_ms"], r["bound_ms"], r["bound_by"],
                      r["library_ms"])


#: P2 at the canonical isolated tail shape, and at the wide U-Net's d1 conv
#: (the K1 shape that loses most to cuDNN): (shape, dil, cout, k_disp)
ABLATE_RUNS = [((1, 40, 34, 320, 531), (1, 4, 4), 40, 2),
               ((1, 256, 130, 230, 230), (1, 1, 1), 128, 1)]


def phase_probe_ablate():
    """P2's entry point, ``exp_ptail_ablate.main()`` at ``ABLATE_RUNS``
    (``full`` held to K1 with ``torch.equal`` and, with ``noepi``, to its
    plain version inside, every probe checked for shape and finite values);
    returns (launches,
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms)) of
    ``full`` at the canonical shape."""
    exp_ptail_ablate.launches = 0
    runs = []
    for shape, dil, cout, k_disp in ABLATE_RUNS:
        rows = exp_ptail_ablate.main(shape=shape, dil=dil, cout=cout,
                                     k_disp=k_disp)
        torch.cuda.empty_cache()
        for row in rows:
            emit("probe_ablate", **row)
        runs.append({r["probe"]: r for r in rows})
    launches = exp_ptail_ablate.launches
    if runs[0]["noepi"]["max_abs_err"] > 1e-4:     # the canonical shape
        raise AssertionError(f"probe_ablate noepi: {runs[0]['noepi']}")
    full = runs[0]["full"]
    return launches, (max(r["full"]["max_abs_err"] for r in runs), full["ms"],
                      full["plain_ms"], full["bound_ms"], full["bound_by"],
                      full["library_ms"])


def seeded_params(model, rng):
    """Random weights from a numpy seed: He-normal conv weights, small
    uniform biases."""
    params = {}
    for nname, d in model.params.items():
        w = d["w"]
        fan_in = int(np.prod(w.shape[1:]))
        params[nname] = {
            "w": rng.standard_normal(tuple(w.shape)) * np.sqrt(2.0 / fan_in),
            "b": rng.uniform(-0.1, 0.1, size=tuple(d["b"].shape))}
    return params


def check_probs(out, shape):
    if tuple(out.shape) != shape:
        raise AssertionError(f"output shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    dev = (out.sum(0) - 1.0).abs().max().item()
    if dev > 1e-5:
        raise AssertionError(f"channel sums deviate from 1 by {dev}")
    return dev


def phase_slice():
    """The flagship's dense MFP path; returns the K1 launch count of the
    three requests."""
    rng = np.random.RandomState(SEED)
    model = flagship_model(mfp=True, patch=[23, 103, 103])
    model.set_params(seeded_params(model, rng))
    model.set_dilated_impl("direct", zfold=True, pallas_tail=True)

    # MFP route (fragments + restitch, cuDNN convs) vs the dilated path (K1)
    patch = tuple(model.input_node.shape.spatial_shape)
    vol = torch.from_numpy(rng.rand(1, *patch).astype(np.float32)).cuda()
    frag = model.predict(vol[None])
    mfp = fragments2dense(frag, model.prediction_node.shape.mfp_offsets)[0]
    dense = model.predict_dense_device(vol, pad_raw=False)
    torch.cuda.synchronize()
    if tuple(mfp.shape) != tuple(dense.shape):
        raise AssertionError(f"MFP {tuple(mfp.shape)} vs dense "
                             f"{tuple(dense.shape)}")
    mfp_err = (mfp - dense).abs().max().item()
    emit("slice_mfp_vs_dense", patch=list(patch), out=list(dense.shape),
         max_abs_err=mfp_err)
    if mfp_err > SLICE_ATOL:
        raise AssertionError(f"MFP vs dense: {mfp_err} > {SLICE_ATOL}")
    del vol, frag, mfp, dense

    # three distinct requests, made on the host from the seed, staged first
    vols = [torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
            for _ in range(N_REQUESTS)]
    warm = torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
    out_shape = (2,) + REQ_SHAPE[1:]
    check_probs(model.predict_dense_device(warm, pad_raw=True), out_shape)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mvox = np.prod(REQ_SHAPE[1:]) / 1e6

    tailconv.launches = 0
    first = None
    for i, v in enumerate(vols):
        before = tailconv.launches
        t0 = time.perf_counter()
        out = model.predict_dense_device(v, pad_raw=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tailconv.launches - before
        dev = check_probs(out, out_shape)
        if n != 2:
            raise AssertionError(f"request {i}: {n} K1 launches, expected 2")
        emit("slice_request", request=i, seconds=dt, mvox_s=mvox / dt,
             k1_launches=n, channel_sum_dev=dev, out=list(out.shape),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if first is None:
            first = out
    launches = tailconv.launches

    # the same request through the plain cuDNN route
    model.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    t0 = time.perf_counter()
    plain = model.predict_dense_device(vols[0], pad_raw=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = (first - plain).abs().max().item()
    emit("slice_vs_plain_route", request=0, max_abs_err=err,
         plain_seconds=dt, plain_mvox_s=mvox / dt,
         k1_launches=tailconv.launches - launches)
    if err > SLICE_ATOL:
        raise AssertionError(f"K1 route vs cuDNN route: {err} > {SLICE_ATOL}")
    if tailconv.launches != launches:
        raise AssertionError("the plain route launched K1")
    return launches


def head_chain(model, vol):
    """The flagship's dense path of one request with its head units in K4:
    K4 (conv0, d=1, pool) -> K4 (conv1, d=2, pool) -> K1 (conv2, conv3 at
    dilation (1,4,4)) -> the 1x1 barrier -> softmax, on the volume
    reflect-padded by the fov as ``predict_dense_device(pad_raw=True)``
    pads it. NCDHW throughout: no transposes between the kernels."""
    p = model.params
    pads = []
    for f in reversed(model.prediction_node.shape.fov):
        pads += [(f - 1) // 2, f - 1 - (f - 1) // 2]
    with torch.no_grad(), f32_convs():
        h = torch.nn.functional.pad(vol[None], pads, mode="reflect")
        h = tailconv.conv1x3x3_pool_dilated(h, p["conv0"]["w"],
                                            p["conv0"]["b"], (1, 1), 2)
        h = tailconv.conv1x3x3_pool_dilated(h, p["conv1"]["w"],
                                            p["conv1"]["b"], (2, 2), 2)
        for name in ("conv2", "conv3"):
            h = tailconv.conv3x3_dilated(h, p[name]["w"], p[name]["b"],
                                         (1, 4, 4))
        y = torch.nn.functional.conv3d(h, p["barrier"]["w"],
                                       p["barrier"]["b"])
        return torch.softmax(y, dim=1)[0]


def phase_head_chain():
    """One 120x496x496 request of the flagship through ``head_chain``
    against ``predict_dense_device(pad_raw=True)`` (K1 route, cuDNN head)
    on the same weights (atol 1e-5); returns the K4 and K1 launches of the
    chain's run."""
    rng = np.random.RandomState(SEED + 8)
    model = flagship_model(mfp=True, patch=[23, 103, 103])
    model.set_params(seeded_params(model, rng))
    model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    vol = torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
    out_shape = (2,) + REQ_SHAPE[1:]
    check_probs(head_chain(model, vol), out_shape)         # warm
    ref = model.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    tailconv.launches, tailconv.head_launches = 0, 0
    tailconv.head_tc_launches = 0
    t0 = time.perf_counter()
    got = head_chain(model, vol)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k4, k1 = tailconv.head_launches, tailconv.launches
    k4_tc = tailconv.head_tc_launches
    dev = check_probs(got, out_shape)
    if k4 != 2 or k1 != 2:
        raise AssertionError(f"head chain: {k4} K4 and {k1} K1 launches, "
                             "expected 2 and 2")
    err = (got - ref).abs().max().item()
    t0 = time.perf_counter()
    model.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    ref_dt = time.perf_counter() - t0
    emit("head_chain", seconds=dt, request_seconds=ref_dt,
         mvox_s=np.prod(REQ_SHAPE[1:]) / 1e6 / dt, k4_launches=k4,
         k4_tc_launches=k4_tc, k1_launches=k1, channel_sum_dev=dev,
         max_abs_err_vs_request=err)
    if err > SLICE_ATOL:
        raise AssertionError(f"head chain vs request: {err} > {SLICE_ATOL}")
    return k4, k1


def phase_convdense():
    """U-Net conv-dense serving: three distinct 128x448x448 slabs of the
    full-width wide U-Net through ``predict_dense_device(pad_raw=True)``
    with K1 on its (3,3,3) convs, then one slab through the cuDNN route;
    returns the K1 launches of the three slabs. Then one more slab under
    the profiler (``profile_slab``), outside the counted run."""
    rng = np.random.RandomState(SEED + 7)
    model = wide_unet_model()
    model.set_params(seeded_params(model, rng))
    model.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    vols = [torch.from_numpy(rng.rand(*SLAB_SHAPE).astype(np.float32)).cuda()
            for _ in range(N_SLABS)]
    warm = torch.from_numpy(rng.rand(*SLAB_SHAPE).astype(np.float32)).cuda()
    out_shape = (2,) + SLAB_SHAPE[1:]
    check_probs(model.predict_dense_device(warm, pad_raw=True), out_shape)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mvox = np.prod(SLAB_SHAPE[1:]) / 1e6
    tailconv.launches = 0
    first = None
    for i, v in enumerate(vols):
        before = tailconv.launches
        t0 = time.perf_counter()
        out = model.predict_dense_device(v, pad_raw=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tailconv.launches - before
        dev = check_probs(out, out_shape)
        if n != 4:
            raise AssertionError(f"slab {i}: {n} K1 launches, expected 4")
        emit("convdense_request", slab=i, seconds=dt, mvox_s=mvox / dt,
             k1_launches=n, channel_sum_dev=dev, out=list(out.shape),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if first is None:
            first = out
    launches = tailconv.launches
    # the bench's configuration: the same slab with every conv in cuDNN
    model.set_convdense_impl(zfold=True, skipsum=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = model.predict_dense_device(vols[0], pad_raw=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = (first - plain).abs().max().item()
    emit("convdense_vs_cudnn_route", slab=0, max_abs_err=err,
         tolerance=CONVDENSE_ATOL, cudnn_seconds=dt, cudnn_mvox_s=mvox / dt,
         cudnn_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=tailconv.launches - launches)
    if err > CONVDENSE_ATOL:
        raise AssertionError(f"conv-dense K1 route vs cuDNN route: {err} > "
                             f"{CONVDENSE_ATOL}")
    if tailconv.launches != launches:
        raise AssertionError("the cuDNN route launched K1")
    model.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    profile_slab(model, vols[1])
    return launches


def profile_slab(model, vol, top=12):
    """One warm K1-route slab under ``torch.profiler``: the device kernels
    by total time, K1's share and the share outside it, and the device
    idle share of the slab's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model.predict_dense_device(vol, pad_raw=True)           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict_dense_device(vol, pad_raw=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "tailconv_tc_kernel" in e.key) / 1e3
    emit("convdense_profile", wall_ms=wall * 1e3, device_ms=dev_ms,
         k1_ms=k1_ms,
         outside_k1_share=(dev_ms - k1_ms) / dev_ms if dev_ms else None,
         idle_share=1.0 - dev_ms / (wall * 1e3) if dev_ms else None,
         top=[dict(kernel=e.key[:100], ms=e.self_device_time_total / 1e3,
                   calls=e.count) for e in kernels[:top]])


def phase_headk_probe():
    """The ported probe ``exp_convdense_headk``: K4 (pool=1) against the
    zfold cuDNN conv at the conv-dense path's kz=1 shapes."""
    before = tailconv.head_launches
    for row in exp_convdense_headk.main():
        emit("headk_probe", **row)
    return tailconv.head_launches - before


def seeded_tracer_params(model, rng):
    """Random tracer weights from a numpy seed: matrices normal with std
    sqrt(1/fan_in), biases and the initial state uniform in [-0.1, 0.1]."""
    params = {}
    for nname, d in model.params.items():
        params[nname] = {}
        for k, v in d.items():
            shape = tuple(v.shape)
            if len(shape) == 2 and k != "state0":
                val = rng.standard_normal(shape) / np.sqrt(shape[0])
            else:
                val = rng.uniform(-0.1, 0.1, size=shape)
            params[nname][k] = val
    return params


def make_tracer(model, vol, **kw):
    return DeviceTracer(model, vol, min_step=0.0, **kw)


def record_plain_inputs(tracer):
    """Make a plain-route tracer record the inputs of its patch cuts: a list
    of (pos, headings or None) per step."""
    log = []
    if tracer.rotate_to_heading:
        cut = tracer._extract_rot_batch
        tracer._extract_rot_batch = lambda v, p, h: (
            log.append((p.clone(), h.clone())) or cut(v, p, h))
    else:
        cut = tracer._extract
        tracer._extract = lambda v, p: log.append((p.clone(), None)) \
            or cut(v, p)
    return log


def teacher_forced_err(log, vol, rotate):
    """Max |kernel - plain| over every step's recorded positions."""
    err = 0.0
    for pos, heads in log:
        if rotate:
            F = flight_frame(heads)
            got, ok = extract_rot.rotated_patches(vol, pos, F, TRACE_PATCH)
            ref, ok_ref = extract_rot.rotated_patches_reference(
                vol, pos, F, TRACE_PATCH)
            near = near_bound_agents(vol.shape, pos, F, TRACE_PATCH)
            if ((ok != ok_ref).cpu().numpy() & ~near).any():
                raise AssertionError("teacher-forced: K3 ok differs")
        else:
            got = extract.trilinear_patches(vol, pos, TRACE_PATCH)
            ref = extract.trilinear_patches_reference(vol, pos, TRACE_PATCH)
        err = max(err, (got - ref).abs().max().item())
    return err


#: the timed rollouts, in turns: the graphed route first, then the eager
#: loop, then the other way round, and again
ROLLOUT_TURNS = ("graphed", "eager", "eager", "graphed", "graphed", "eager")


def profile_once(fn, kernel, top=10):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time of its kernels, the device idle share of the wall, the top
    device kernels, and the launches and device us per launch of ``kernel``
    (a substring of its name) as the device recorded them. A profile with
    no device events reports None and the wall. The counts fall short as
    the process ages: after ``phase_trace_pool`` the same ``trace_batch``
    profile lacks its first rollout step's kernels and the host copies
    before it, so the rollouts whose launches the device counts run
    before the pools."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    mine = [e for e in kernels if kernel in e.key]
    n = sum(e.count for e in mine)
    return dict(wall_ms=wall * 1e3, device_ms=dev_ms if kernels else None,
                idle_share=1.0 - dev_ms / (wall * 1e3) if kernels else None,
                kernel_us_per_launch=sum(e.self_device_time_total
                                         for e in mine) / n if n else None,
                kernel_launches=n, device_kernels=sum(e.count
                                                      for e in kernels),
                top=[dict(kernel=e.key[:90],
                          ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in kernels[:top]])


def phase_trace(rotate, prelu_w=0):
    """One fused-tracing path at full width: the main path through
    ``trace_batch`` (one replay of the rollout's CUDA graph, profiled: the
    device counts the kernel's launches), the graphed route and the eager
    loop timed in turns, check (d) (the graphed rollout equals the eager
    kernel route bit for bit), a profile of one graphed rollout, and the
    rollout checks (a), (b), (c) against the plain route. With
    ``prelu_w`` the model is the tracing head with a ``prelu_w``-wide
    prelu Perceptron between the GRU scan and the step head
    (``tracer_model(prelu_w=...)``, the structure of the JAX package's
    tests/test_tracing.py:613). Returns the device's count of the kernel's
    launches in the main path's run (``launches``), the graphed rate
    (``agent_steps_s``) and the alive fraction, which the pools' phases
    take."""
    name = ("trace_rot_rollout" if rotate else "tracing_nodes_prelu"
            if prelu_w else "trace_rollout")
    mod = extract_rot if rotate else extract
    B, K = (ROT_B, ROT_K) if rotate else (TRACE_B, TRACE_K)
    lo, hi = ROT_SEEDS if rotate else TRACE_SEEDS
    atol_a = K3_ATOL if rotate else K2_ATOL
    rng = np.random.RandomState(SEED + (12 if prelu_w else 4))
    model = tracer_model(TRACE_PATCH, prelu_w=prelu_w)
    params = seeded_tracer_params(model, rng)
    if prelu_w:
        params["mid"]["alpha"] = rng.uniform(0.05, 0.4, prelu_w)
    model.set_params(params)
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    seeds = rng.uniform(lo, hi, (B, 3)).astype(np.float32)
    kw = dict(rotate_to_heading=rotate)
    tracer = make_tracer(model, vol, max_steps=K, **kw)
    if not (tracer._rot_kernel if rotate else tracer._extract_kernel):
        raise AssertionError(f"{name}: the tracer did not pick the kernel")
    seeds_d = torch.from_numpy(seeds).cuda()
    heads_d = seeds_d.new_tensor([[0.0, 0.0, 1.0]]).expand(B, 3)
    routes = {
        "eager": lambda: tracer._rollout(model.params, vol, seeds_d, heads_d),
        "graphed": lambda: tracer._rollout_graphed(model.params, seeds_d,
                                                   heads_d)}

    routes["eager"]()                           # warm
    t0 = time.perf_counter()
    routes["graphed"]()                         # warm-up step and capture
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    capture = tracer.capture_seconds
    # no host sync inside a replay or the eager loop: PyTorch raises on any
    # synchronising call (a copy to or from the host, .item(), ...)
    torch.cuda.set_sync_debug_mode("error")
    try:
        routes["graphed"]()
        routes["eager"]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # the main path, through the user's entry point: one replay, profiled,
    # so the launches are the device's count in this run, held against K
    # and against the wrapper's counter (which the replay added to)
    kernel = "rotated_patches_kernel" if rotate else "trilinear_patches_kernel"
    if rotate:
        stats = extract_rot.staging_stats(vol.device)
        stats.zero_()
    mod.launches = 0
    traces = []
    main = profile_once(lambda: traces.extend(tracer.trace_batch(seeds)),
                        kernel)
    counted = mod.launches
    launches = main["kernel_launches"]
    staged = {}
    if rotate:
        unstaged, floats = stats.tolist()
        staged = dict(unstaged_items=unstaged,
                      staged_bytes_per_launch=4 * floats / K)
    emit(name + "_main_profile", route="trace_batch", **main, **staged,
         counted_launches=counted)
    if launches != K or counted != K:
        raise AssertionError(f"{name}: {launches} kernel launches on the "
                             f"device in trace_batch and {counted} counted, "
                             f"expected {K}")
    if rotate and unstaged:
        raise AssertionError(f"{name}: {unstaged} items not staged")
    if len(tracer._graphs) != 1:
        raise AssertionError(f"{name}: {len(tracer._graphs)} graphs kept, "
                             "expected the one captured")
    n_pts = sum(len(t.coords) for t in traces)
    if len(traces) != B or not all(np.isfinite(t.coords).all()
                                   for t in traces):
        raise AssertionError(f"{name}: bad traces from trace_batch")

    walls = {"graphed": [], "eager": []}
    peak = {}
    out = {}
    for route in ROLLOUT_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = mod.launches
        t0 = time.perf_counter()
        out[route] = routes[route]()
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
        peak[route] = max(peak.get(route, 0.0),
                          torch.cuda.max_memory_allocated() / 2**30)
        if mod.launches - before != K:
            raise AssertionError(f"{name}: {mod.launches - before} launches "
                                 f"in a {route} rollout, expected {K}")
    (traj, moved), (gtraj, gmoved) = out["eager"], out["graphed"]
    if tuple(traj.shape) != (K, B, 3) or not bool(torch.isfinite(traj).all()):
        raise AssertionError(f"{name}: bad trajectory {tuple(traj.shape)}")
    # (d) the graph replays the eager kernel route, bit for bit
    check_d = bool(torch.equal(gtraj, traj) and torch.equal(gmoved, moved))
    if not check_d:
        raise AssertionError(f"{name}: the graphed rollout differs from the "
                             "eager kernel route")
    g, e = min(walls["graphed"]), min(walls["eager"])
    emit(name, B=B, K=K, vol=list(TRACE_VOL), patch=list(TRACE_PATCH),
         graphed_seconds=walls["graphed"], eager_seconds=walls["eager"],
         agent_steps_s=B * K / g, eager_agent_steps_s=B * K / e,
         graphed_speedup=e / g, capture_seconds=capture,
         first_call_seconds=first_call, alive_fraction=moved.float().mean()
         .item(), launches_per_rollout=K, peak_gib=peak["graphed"],
         eager_peak_gib=peak["eager"],
         reserved_gib=torch.cuda.memory_reserved() / 2**30,
         trace_batch_points=n_pts,
         main_path_launches=launches, host_syncs_in_rollout=0,
         graphed_equals_eager=check_d)
    routes["graphed"]()
    prof = profile_once(routes["graphed"], kernel)
    if prof["kernel_launches"] != K:
        raise AssertionError(f"{name}: {prof['kernel_launches']} kernel "
                             f"launches in a profiled replay, expected {K}")
    # the profiler stretches the wall it watches: the idle share against
    # the fastest unprofiled replay too
    emit(name + "_profile", route="graphed", **prof,
         idle_share_of_timed_wall=None if prof["device_ms"] is None
         else 1.0 - prof["device_ms"] / (g * 1e3))

    # (a) teacher-forced and (c) full horizon, from one plain rollout
    plain = make_tracer(model, vol, max_steps=K, use_pallas_extract=False,
                        use_pallas_rot=False, **kw)
    log = record_plain_inputs(plain)
    before = mod.launches
    ptraj, pmoved = plain._rollout(model.params, vol, seeds_d, heads_d)
    if mod.launches != before:
        raise AssertionError(f"{name}: the plain route launched the kernel")
    err_a = teacher_forced_err(log, vol, rotate)
    if err_a > atol_a:
        raise AssertionError(f"{name}: teacher-forced patches differ by "
                             f"{err_a} > {atol_a}")
    d = (traj - ptraj).abs().amax(dim=2)               # (K, B)
    over = torch.nonzero((d > HORIZON_TOL).any(dim=1))
    first = int(over[0]) if len(over) else None

    # (b) short horizon
    short = [make_tracer(model, vol, max_steps=SHORT_K, **kw),
             make_tracer(model, vol, max_steps=SHORT_K,
                         use_pallas_extract=False, use_pallas_rot=False,
                         **kw)]
    (kt, km), (pt, pm) = [t._rollout(model.params, vol, seeds_d, heads_d)
                          for t in short]
    err_b = (kt - pt).abs().max().item()
    if err_b > ROLLOUT_ATOL or not torch.equal(km, pm):
        raise AssertionError(f"{name}: K={SHORT_K} rollouts differ: traj "
                             f"{err_b}, alive equal {torch.equal(km, pm)}")
    emit(name + "_checks", teacher_forced_max_abs=err_a,
         short_horizon_k=SHORT_K, short_horizon_max_abs=err_b,
         short_horizon_alive_equal=True,
         full_horizon_max_abs=d.max().item(),
         full_horizon_first_step_over_1e_3=first,
         full_horizon_share_within_1e_3=(d[-1] <= HORIZON_TOL).float()
         .mean().item(),
         full_horizon_alive_equal=bool(torch.equal(moved, pmoved)),
         bit_exact=bool(torch.equal(traj, ptraj)),
         graphed_equals_eager=check_d)
    return dict(launches=launches, agent_steps_s=B * K / g,
                alive_fraction=moved.float().mean().item())


def phase_trace_kzip():
    """``trace_batch(save_kzip=...)`` read back by the port's NML parser,
    then a ShotgunRegistry drain of 2*B seeds."""
    rng = np.random.RandomState(SEED + 5)
    model = tracer_model(TRACE_PATCH)
    model.set_params(seeded_tracer_params(model, rng))
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    tracer = make_tracer(model, vol, max_steps=64)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "traces.k.zip")
        traces = tracer.trace_batch(rng.uniform(*TRACE_SEEDS, (8, 3)),
                                    save_kzip=out)
        nodes, edges, _ = read_nml_file(out)
    pts = np.asarray([nodes[i] for i in sorted(nodes)])
    want = np.concatenate([t.coords for t in traces])
    if pts.shape != want.shape or not np.array_equal(pts, want) \
            or len(edges) != len(pts) - len(traces):
        raise AssertionError("trace_kzip: the annotation read back differs")
    tracer = make_tracer(model, vol, max_steps=TRACE_K)
    reg = ShotgunRegistry(rng.uniform(*TRACE_SEEDS, (2 * TRACE_B, 3)),
                          radius=2.0)
    t0 = time.perf_counter()
    reg_traces = reg.run(tracer, batch_size=TRACE_B)
    dt = time.perf_counter() - t0
    if reg.next_seed() is not None or not reg_traces:
        raise AssertionError("trace_kzip: the registry did not drain")
    emit("trace_kzip", kzip_nodes=len(pts), kzip_traces=len(traces),
         registry_seeds=2 * TRACE_B, registry_traces=len(reg_traces),
         registry_points=int(sum(len(t) for t in reg_traces)),
         registry_seconds=dt)


# ------------------------------------------------------------ tracing pools

POOL_QUEUE = 8                          # queue seeds a slot (bench.py:362)
CHAIN_WAVES = 3                         # full waves before the drain wave
SUB_B, SUB_N = 16, 48                   # the per-seed check's pool
POOL_ATOL = 1e-5                        # tests/test_tracing.py:1023
TUNE_CANDIDATES = (256, 512, 1024, 2048)
TUNE_STEPS = 64


def pool_total(N, B, K, alive):
    """The bench's single-wave pool length (``bench.py:362-364``)."""
    return int(N * max(0.05, alive) * K / B) + K


def chain_wave_steps(K, alive):
    """The bench's chained wave length (``bench.py:391-395``)."""
    return max(int(K), int(5 * max(0.1, alive) * K))


def pool_rates(tracer, B, K, alive, rng, lo, hi):
    """The bench's pool protocol (``bench.py:351-445``) on the card, timed
    as device work ending in one synchronize, the host decode left out: the
    respawning pool, one wave of ``pool_total`` steps over N = 8B seeds (two
    warm-up waves, then the best of two), and the chained pool, three waves
    of ``chain_wave_steps`` steps with fresh N-seed queues and a K-step
    drain wave with an empty queue, the id offset kept on the device (one
    warm-up, the best of two). Effective agent-steps/s = recorded steps /
    wall; util = recorded steps / slot-steps."""
    params = tracer.model.params
    dev = tracer.volume.device
    N = POOL_QUEUE * B
    total = pool_total(N, B, K, alive)
    seeds = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    waves = [rng.uniform(lo, hi, (N, 3)).astype(np.float32)
             for _ in range(CHAIN_WAVES)]
    empty = np.zeros((N, 3), np.float32)
    no_cut = np.iinfo(np.int32).max
    WS = chain_wave_steps(K, alive)
    st = tracer._pool_setup(B, N)

    def one_pool():
        st.reset(tracer._init_carry(params, B))
        _, moved, _ = tracer._pool_wave(params, st, seeds, N, total,
                                        max(0, total - K), 0)
        return moved.sum()

    def run_chain():
        st.reset(tracer._init_carry(params, B))
        off = torch.zeros((), dtype=torch.int32, device=dev)
        movs = []
        for sw in waves:
            _, mv, _ = tracer._pool_wave(params, st, sw, N, WS, no_cut, off)
            movs.append(mv.sum())
            off = off + st.ptr
        _, mv, _ = tracer._pool_wave(params, st, empty, 0, K, no_cut, off)
        movs.append(mv.sum())
        return torch.stack(movs).sum()

    out = {}
    for name, fn, warm, slots in (("pool", one_pool, 2, B * total),
                                  ("chain", run_chain, 1,
                                   B * (CHAIN_WAVES * WS + K))):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            eff = int(fn().item())
            walls.append(time.perf_counter() - t0)
        out[name] = dict(seconds=walls, effective_steps=eff,
                         slot_steps=slots, eff_sps=eff / min(walls),
                         util=eff / slots)
    out["pool"]["total_steps"] = total
    out["chain"].update(wave_steps=WS, waves=CHAIN_WAVES, drain_steps=K)
    return out


def check_decoded(traces, stats, seeds, name):
    """Every consumed seed decoded once: one trace each, in seed order,
    starting at its seed, their steps summing to the recorded steps."""
    n = stats["consumed"]
    if len(traces) != n or n == 0:
        raise AssertionError(f"{name}: {len(traces)} traces for {n} "
                             "consumed seeds")
    starts = np.asarray([t.coords[0] for t in traces])
    if not np.array_equal(starts, seeds[:n].astype(np.float64)):
        raise AssertionError(f"{name}: a trace does not start at its seed")
    if sum(len(t) - 1 for t in traces) != stats["effective_steps"]:
        raise AssertionError(f"{name}: the traces' steps differ from the "
                             "recorded steps")
    if not all(np.isfinite(t.coords).all() for t in traces):
        raise AssertionError(f"{name}: non-finite trace")


def same_traces(got, ref):
    """Max abs difference of two lists of traces of equal lengths (inf when
    a length differs)."""
    if len(got) != len(ref):
        return float("inf")
    err = 0.0
    for g, r in zip(got, ref):
        if len(g) != len(r):
            return float("inf")
        err = max(err, float(np.abs(g.coords - r.coords).max()))
    return err


def pool_wave_checks(tracer, B, N, total, seeds, name):
    """One wave graphed against the same wave eager, bit for bit (outputs
    and final state), and a replayed wave under
    ``set_sync_debug_mode("error")`` (no host sync inside a wave)."""
    params = tracer.model.params
    st = tracer._pool_setup(B, N)
    got = tracer._pool_wave(params, st, seeds, N, total, total - tracer.
                            max_steps, 0)
    g_state = [x.clone() for x in st.tensors()]
    st = tracer._pool_setup(B, N)
    ref = tracer._pool_wave(params, st, seeds, N, total, total - tracer.
                            max_steps, 0, graphed=False)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref)) and all(
        torch.equal(a, b) for a, b in zip(g_state, st.tensors()))
    if not equal:
        raise AssertionError(f"{name}: the graphed pool wave differs from "
                             "the eager one")
    st = tracer._pool_setup(B, N)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracer._pool_wave(params, st, seeds, N, total,
                          total - tracer.max_steps, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return equal


def all_launches():
    """The patch kernels' launch counters (K2, K3 in both modes), summed:
    a pool runs one of them."""
    return extract.launches + extract_rot.launches + extract_rot.launches_bf16


def pool_main_path(tracer, seeds, B, total, kernel, name, stats=None):
    """The respawning pool through its entry point, ``trace_pool``: a first
    call (which captures the chunk graph), then the same call under
    ``torch.profiler``, whose device count of ``kernel``'s launches must be
    the replays' (``n_rep`` x S) and the wrapper's count; both calls give
    the same traces, every consumed seed decoded once. ``stats``: K3's
    staging counts, which must show no item left unstaged in either call;
    the values staged in the profiled call are returned. Returns (traces,
    stats, launches, the first call's seconds, the profile, staged
    values)."""
    if stats is not None:
        stats.zero_()
    t0 = time.perf_counter()
    traces, st = tracer.trace_pool(seeds, batch_size=B, total_steps=total)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check_decoded(traces, st, seeds, name)
    if stats is not None:
        if stats[0].item():
            raise AssertionError(f"{name}: items not staged")
        stats.zero_()
    before = all_launches()
    out = []
    prof = profile_once(lambda: out.append(tracer.trace_pool(
        seeds, batch_size=B, total_steps=total)), kernel)
    counted = all_launches() - before
    S = tracer._pool_chunk_len(total)
    expect = -(-total // S) * S
    if prof["kernel_launches"] != expect or counted != expect:
        raise AssertionError(f"{name}: {prof['kernel_launches']} launches "
                             f"on the device, {counted} counted, expected "
                             f"{expect}")
    again, st2 = out[0]
    if st2 != st or same_traces(again, traces) != 0.0:
        raise AssertionError(f"{name}: a second trace_pool differs")
    values = None
    if stats is not None:
        unstaged, values = stats.tolist()
        if unstaged:
            raise AssertionError(f"{name}: {unstaged} items not staged")
    return traces, st, expect, first, prof, values


def phase_trace_pool(raw):
    """The translation pools at full width (B = 1024, K = 256, N = 8B):
    ``trace_pool`` through its entry point (``pool_main_path``; K2's
    launches counted by the device), the bench's protocol for both pools
    (``pool_rates``) beside the raw rollout rate of ``phase_trace``, one
    wave graphed = eager and without a host sync (``pool_wave_checks``),
    and on a small sub-queue the pools' traces against each seed's own
    ``trace_batch`` (``POOL_ATOL``, K = ``SHORT_K``). Returns K2's launches
    on the main path."""
    rng = np.random.RandomState(SEED + 6)
    model = tracer_model(TRACE_PATCH)
    model.set_params(seeded_tracer_params(model, rng))
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    B, K = TRACE_B, TRACE_K
    N = POOL_QUEUE * B
    alive, raw_sps = raw["alive_fraction"], raw["agent_steps_s"]
    total = pool_total(N, B, K, alive)
    seeds = rng.uniform(*TRACE_SEEDS, (N, 3)).astype(np.float32)
    tracer = make_tracer(model, vol, max_steps=K)
    torch.cuda.reset_peak_memory_stats()
    traces, stats, launches, first, prof, _ = pool_main_path(
        tracer, seeds, B, total, "trilinear_patches_kernel", "trace_pool")
    peak = torch.cuda.max_memory_allocated() / 2**30
    capture = [e.capture_seconds for e in tracer._pool_graphs.values()]
    emit("trace_pool_main_profile", route="trace_pool", **prof)
    equal = pool_wave_checks(tracer, B, N, total, seeds, "trace_pool")
    rates = pool_rates(tracer, B, K, alive, rng, *TRACE_SEEDS)
    p, c = rates["pool"], rates["chain"]
    best = max(("pool", p["eff_sps"]), ("chain", c["eff_sps"]),
               key=lambda x: x[1])
    emit("trace_pool", B=B, K=K, queue=N, vol=list(TRACE_VOL),
         patch=list(TRACE_PATCH), total_steps=total,
         chunk_steps=tracer._pool_chunk_len(total), pool=p, chain=c,
         raw_sps=raw_sps, raw_alive=alive, raw_x_alive=raw_sps * alive,
         pool_wins=p["eff_sps"] > raw_sps * alive,
         chain_wins=c["eff_sps"] > raw_sps * alive,
         headline=dict(impl=best[0], sps=best[1]) if best[1] > raw_sps
         * alive else dict(impl="raw", sps=raw_sps),
         capture_seconds=capture, first_call_seconds=first, peak_gib=peak,
         main_path_launches=launches, consumed=stats["consumed"],
         main_effective_steps=stats["effective_steps"],
         graphed_equals_eager=equal, host_syncs_in_wave=0)
    # per seed, on a small sub-queue at a short horizon
    short = make_tracer(model, vol, max_steps=SHORT_K)
    sub = seeds[:SUB_N]
    ref = short.trace_batch(sub)
    got, st = short.trace_pool(sub, batch_size=SUB_B)
    err_pool = same_traces(got, ref)
    chain, cst = short.trace_pool_chain(sub, batch_size=SUB_B,
                                        wave_seeds=SUB_B, wave_steps=5)
    err_chain = same_traces(chain, ref)
    emit("trace_pool_checks", sub_queue=SUB_N, slots=SUB_B, k=SHORT_K,
         pool_consumed=st["consumed"], pool_max_abs_vs_trace_batch=err_pool,
         chain_consumed=cst["consumed"], chain_waves=cst["waves"],
         chain_max_abs_vs_trace_batch=err_chain)
    if st["consumed"] != SUB_N or cst["consumed"] != SUB_N \
            or err_pool > POOL_ATOL or err_chain > POOL_ATOL:
        raise AssertionError(f"trace_pool: the pools' traces differ from "
                             f"trace_batch ({err_pool}, {err_chain})")
    del tracer, short, vol
    torch.cuda.empty_cache()
    return launches


def phase_trace_rot_pool(raw):
    """The rotated pools (B = 512, K = 64, N = 8B), in K3's float32 mode and
    in its bf16 mode: each through ``trace_pool`` (launches counted by the
    device, no item left unstaged), one wave graphed = eager without a host
    sync, and the bench's protocol for both pools. Returns K3's main-path
    launches in each mode."""
    rng = np.random.RandomState(SEED + 7)
    model = tracer_model(TRACE_PATCH)
    model.set_params(seeded_tracer_params(model, rng))
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    B, K = ROT_B, ROT_K
    N = POOL_QUEUE * B
    alive, raw_sps = raw["alive_fraction"], raw["agent_steps_s"]
    total = pool_total(N, B, K, alive)
    seeds = rng.uniform(*ROT_SEEDS, (N, 3)).astype(np.float32)
    launches = {}
    for mode in ("float32", "bfloat16"):
        tracer = make_tracer(model, vol, max_steps=K, rotate_to_heading=True,
                             rot_compute_dtype=mode)
        if not tracer._rot_kernel or tracer._rot_bf16 != (mode == "bfloat16"):
            raise AssertionError(f"trace_rot_pool {mode}: not K3's {mode} "
                                 "kernel")
        dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
        traces, st, n, first, prof, values = pool_main_path(
            tracer, seeds, B, total, "rotated_patches_kernel",
            f"trace_rot_pool {mode}",
            stats=extract_rot.staging_stats(vol.device, dtype))
        launches[mode] = n
        emit("trace_rot_pool_main_profile", mode=mode, route="trace_pool",
             **prof)
        equal = pool_wave_checks(tracer, B, N, total, seeds,
                                 f"trace_rot_pool {mode}")
        rates = pool_rates(tracer, B, K, alive, rng, *ROT_SEEDS)
        emit("trace_rot_pool", mode=mode, B=B, K=K, queue=N,
             total_steps=total, chunk_steps=tracer._pool_chunk_len(total),
             pool=rates["pool"], chain=rates["chain"], raw_sps=raw_sps,
             raw_alive=alive,
             pool_wins=rates["pool"]["eff_sps"] > raw_sps * alive,
             chain_wins=rates["chain"]["eff_sps"] > raw_sps * alive,
             capture_seconds=[e.capture_seconds
                              for e in tracer._pool_graphs.values()],
             first_call_seconds=first, main_path_launches=n,
             consumed=st["consumed"],
             staged_bytes_per_launch=values * (2 if mode == "bfloat16"
                                               else 4) / n,
             graphed_equals_eager=equal, host_syncs_in_wave=0)
        del tracer
    torch.cuda.empty_cache()
    return launches["float32"], launches["bfloat16"]


def phase_tune_batch():
    """``tune_batch`` on the card at the deployment's shapes: the table of
    agent-steps/s per candidate batch from graphed rollouts of
    ``TUNE_STEPS`` steps; afterwards the tracer's ``max_steps`` and its kept
    rollout graph are as they were, and the next ``trace_batch`` replays the
    kept graph (no capture)."""
    rng = np.random.RandomState(SEED + 8)
    model = tracer_model(TRACE_PATCH)
    model.set_params(seeded_tracer_params(model, rng))
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    tracer = make_tracer(model, vol, max_steps=TRACE_K)
    seeds = rng.uniform(*TRACE_SEEDS, (TRACE_B, 3)).astype(np.float32)
    tracer.trace_batch(seeds)
    kept = list(tracer._graphs.items())
    t0 = time.perf_counter()
    res = tracer.tune_batch(TUNE_CANDIDATES, steps=TUNE_STEPS)
    dt = time.perf_counter() - t0
    restored = (tracer.max_steps == TRACE_K
                and list(tracer._graphs.items()) == kept)
    capture = tracer.capture_seconds
    tracer.trace_batch(seeds)
    replayed = (list(tracer._graphs.items()) == kept
                and tracer.capture_seconds == capture)
    emit("tune_batch", candidates=list(TUNE_CANDIDATES), steps=TUNE_STEPS,
         table={str(b): v for b, v in res["table"].items()},
         best=res["best"], seconds=dt, max_steps_restored=tracer.max_steps,
         kept_graphs_restored=restored, next_trace_batch_replayed=replayed)
    if not restored or not replayed or set(res["table"]) != set(
            TUNE_CANDIDATES) or min(res["table"].values()) <= 0:
        raise AssertionError("tune_batch: the table is wrong or the "
                             "tracer was not put back")
    del tracer, vol
    torch.cuda.empty_cache()


def phase_registry_pool():
    """``ShotgunRegistry.run(pool=True)`` over 2N = 16B seeds at B = 1024,
    K = 256 and the registry's default radius (the chained pool, fed and
    deduped by the registry between waves), then its ``.k.zip`` written and
    read back by the port's NML parser: the nodes are the traces' points,
    in order. The drain's seconds are split into the waves on the card
    (with their readback and decode), ``register`` (the dedupe KD-tree)
    and the k.zip. Returns K2's launches (the wrapper's count)."""
    rng = np.random.RandomState(SEED + 9)
    model = tracer_model(TRACE_PATCH)
    model.set_params(seeded_tracer_params(model, rng))
    vol = torch.from_numpy(rng.rand(*TRACE_VOL).astype(np.float32)).cuda()
    tracer = make_tracer(model, vol, max_steps=TRACE_K)
    n = 2 * POOL_QUEUE * TRACE_B
    reg = ShotgunRegistry(rng.uniform(*TRACE_SEEDS, (n, 3)))
    spent = {"register": 0.0}
    register = reg.register

    def timed(trace):
        t0 = time.perf_counter()
        register(trace)
        spent["register"] += time.perf_counter() - t0
    reg.register = timed
    before = extract.launches
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "registry.k.zip")
        t0 = time.perf_counter()
        traces = reg.run(tracer, batch_size=TRACE_B, pool=True)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg.save_kzip(out)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nodes, edges, _ = read_nml_file(out)
        read_s = time.perf_counter() - t0
        kzip_mb = os.path.getsize(out) / 2**20
    launches = extract.launches - before
    pts = np.asarray([nodes[i] for i in sorted(nodes)])
    want = np.concatenate([t.coords for t in traces])
    ok = (reg.next_seed() is None and len(traces) > 0
          and pts.shape == want.shape and np.array_equal(pts, want)
          and len(edges) == len(pts) - len(traces))
    emit("registry_pool", seeds=n, B=TRACE_B, K=TRACE_K, radius=reg.radius,
         traces=len(traces), points=int(len(want)), drain_seconds=dt,
         register_seconds=spent["register"], kzip_write_seconds=write_s,
         kzip_read_seconds=read_s, kzip_mb=kzip_mb, k2_launches=launches,
         kzip_equal=ok)
    if not ok:
        raise AssertionError("registry_pool: the drain or its k.zip is "
                             "wrong")
    del tracer, vol
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- tracing training

TRACE_TRAIN_CLI = ("tracing3d", 300, 20)   # (config, steps, warm-up steps)
TRACE_FALL_WINDOW = 50                  # its loss falls: mean of 50 steps
TT_B, TT_T, TT_K, TT_STEPS = 16, 8, 8, 64  # batch, scan, chunk, steps
CARRY_TOL = 1e-5


def helix_skeleton(shape, n=400):
    """``examples/tracing3d.py``'s helix, scaled to a volume of ``shape``
    (Z, X, Y)."""
    from elektronn2_tpu_torch.data import SkeletonMFK
    z, x, y = (np.asarray(shape, np.float64))
    t = np.linspace(0, 4 * np.pi, n)
    pos = np.stack([z * 0.2 + t * z * 0.6 / (4 * np.pi),
                    x / 2 + x * 0.22 * np.cos(t),
                    y / 2 + y * 0.22 * np.sin(t)], 1)
    return SkeletonMFK(pos, [(i, i + 1) for i in range(n - 1)])


def phase_train_tracing(smi):
    """Tracing training on the card. (1) The train CLI on
    ``examples/tracing3d.py`` unchanged (``train_cli_run``: it/s, idle
    share, the loss first and last; its batches of two agents make the loss
    noisy, so the mean of the last ``TRACE_FALL_WINDOW`` steps must fall
    below 0.98 x that of the first, on a data stream seeded from
    ``SEED``). (2)
    ``TracingTrainerRNN`` with ``fused_steps`` on the deployment's model
    (``tracer_model``, 16^3, 64/64) over ``AgentData`` on a 256^3 volume
    with a helix skeleton: the host-fed chunks with the carry in the graph,
    held against the per-step carry on the same batches from the same
    weights (losses rtol and final ``h0`` atol ``CARRY_TOL``); then the
    trained weights serve a chained pool. Returns K2's launches in that
    pool."""
    from elektronn2_tpu_torch.data import AgentData
    from elektronn2_tpu_torch.training.trainer import TracingTrainerRNN
    with tempfile.TemporaryDirectory() as tmp:
        train_cli_run(smi, *TRACE_TRAIN_CLI, tmp,
                      fall_window=TRACE_FALL_WINDOW, data_seed=SEED)
        rng = np.random.RandomState(SEED + 10)
        vol = rng.rand(*TRACE_VOL).astype(np.float32)
        ad = AgentData(input_data=[vol], target_data=[
            (vol[0] > 0.5).astype(np.int16)])
        ad.set_geometry(TRACE_PATCH)
        ad.skeletons = [helix_skeleton(TRACE_VOL[1:])]
        ad.rng = np.random.RandomState(SEED)
        drawn = []
        draw = ad.get_tracing_batch
        ad.get_tracing_batch = lambda *a, **k: drawn.append(
            draw(*a, **k)) or drawn[-1]
        weights = None
        models = []
        for _ in range(2):
            m = tracer_model(TRACE_PATCH, batch=TT_B, t=TT_T)
            weights = weights or seeded_tracer_params(m, rng)
            m.set_params(weights)
            models.append(m)
        tr = TracingTrainerRNN(model=models[0], data=ad, n_scan_steps=TT_T,
                               batch_size=TT_B, fused_steps=TT_K,
                               n_steps=TT_STEPS, n_workers=0,
                               history_freq=0, save_freq=0, save_path=tmp,
                               optimiser="Adam",
                               optimiser_params={"lr": 1e-3})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fused = tr.history.timeline.data[:, 2]
        h_fused = tr.fused_loop.rnn_carry["h0"].clone()
        # the per-step TBPTT on the same batches, eagerly
        m = models[1]
        m.set_opt("Adam", lr=1e-3)
        m.debug_outputs.append(m.nodes["scan"])
        carry, per_step = None, []
        for d, t in drawn[:TT_STEPS]:
            lv, aux = m.trainingstep(
                torch.from_numpy(d).cuda(), torch.from_numpy(t).cuda(),
                feed_overrides=None if carry is None else {"h0": carry})
            per_step.append(float(lv))
            carry = aux["scan"][-1]
        loss_err = float(np.abs(fused - np.asarray(per_step)).max())
        h_err = (h_fused - carry).abs().max().item()
        # the trained weights serve a chained pool
        tracer = make_tracer(tr.model, torch.from_numpy(vol).cuda(),
                             max_steps=TRACE_K)
        before = extract.launches
        t0 = time.perf_counter()
        traces, st = tracer.trace_pool_chain(
            rng.uniform(*TRACE_SEEDS, (2 * TRACE_B, 3)),
            batch_size=TRACE_B)
        serve_s = time.perf_counter() - t0
        launches = extract.launches - before
        emit("train_tracing", model="tracer_model", patch=list(TRACE_PATCH),
             batch=TT_B, scan_steps=TT_T, fused_steps=TT_K, steps=TT_STEPS,
             vol=list(TRACE_VOL), seconds=wall, it_s=TT_STEPS / wall,
             capture_seconds=tr.fused_loop.capture_seconds,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             loss_first=float(fused[0]), loss_last=float(fused[-1]),
             fused_vs_per_step_loss_max_abs=loss_err,
             fused_vs_per_step_h0_max_abs=h_err,
             served_chain=dict(seeds=2 * TRACE_B, consumed=st["consumed"],
                               waves=st["waves"], util=st["util"],
                               seconds=serve_s, k2_launches=launches))
        if not np.isfinite(fused).all() or len(fused) != TT_STEPS:
            raise AssertionError("train_tracing: bad losses")
        if loss_err > CARRY_TOL * max(1.0, abs(per_step[0])) \
                or h_err > CARRY_TOL:
            raise AssertionError(f"train_tracing: the fused carry differs "
                                 f"from the per-step carry ({loss_err}, "
                                 f"{h_err})")
        if st["consumed"] != 2 * TRACE_B or len(traces) != 2 * TRACE_B \
                or not all(np.isfinite(t.coords).all() for t in traces):
            raise AssertionError("train_tracing: the served chain is wrong")
        del tr, tracer, models, m
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- K3's bf16 mode

F64_SAMPLES = 64                        # agents of the float64 comparison


def k3_errors_vs_f64(vol, pos, F, patch, got_f32, got_bf16):
    """The float32 and bf16 modes' errors against float64 truth (the plain
    version in float64 at float64 coordinates) on the first
    ``F64_SAMPLES`` agents with ``ok``: 50th and 99th percentile and max."""
    n = F64_SAMPLES
    ref, ok = extract_rot.rotated_patches_reference(
        vol.double(), pos[:n].double(), F[:n].double(), patch)
    out = {}
    for mode, got in (("float32", got_f32), ("bfloat16", got_bf16)):
        e = (got[:n][ok] - ref[ok]).abs().flatten().double()
        q = torch.quantile(e[:2**24], torch.tensor([0.5, 0.99],
                                                   dtype=torch.float64,
                                                   device=e.device))
        out[mode] = dict(p50=q[0].item(), p99=q[1].item(),
                         max=e.max().item())
    return out


def phase_kernel_k3_bf16():
    """K3's bf16 mode against its plain version (the same bf16 arithmetic in
    PyTorch; ``assert_close`` atol ``K3_ATOL``, bit for bit expected and
    reported, ``ok`` as in ``phase_kernel_k3``) on ``k3_cases`` (the rotated
    tracer's shape, B = 512 at 16^3, an anisotropic patch with two channels
    and Y % 8 == 0, the ok boundary) and a case with Y % 8 != 0 (the
    unaligned instance). At the tracer's shape: device ms per launch from
    graph replays (``graph_ms``: the plain version, the bf16 kernel and the
    float32 kernel in turns), its bound (bf16 windows, float32 patches and
    inputs at 3.35 TB/s against its FLOPs at the FP32 peak), the values it
    stages (its own count, 2 bytes each) and both modes' errors against
    float64 (``k3_errors_vs_f64``). No single PyTorch call computes it:
    ``grid_sample`` has no ``ok`` and no bf16 rounding of its operands.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms)."""
    rng = np.random.RandomState(SEED + 12)
    cases = list(k3_cases(rng))
    vol3 = torch.from_numpy(rng.rand(2, 20, 30, 42).astype(np.float32)).cuda()
    cases.append(("ragged_y", vol3, rng.uniform(3, 17, (40, 3)),
                  rng.randn(40, 3), (5, 7, 6), False))
    max_err, ms, pms, bound = 0.0, None, None, (None, None)
    for name, vol, pos, heads, patch, timed in cases:
        pos = torch.from_numpy(pos.astype(np.float32)).cuda()
        F = flight_frame(torch.from_numpy(heads.astype(np.float32)).cuda())
        vb = vol.to(torch.bfloat16).contiguous()
        stats = extract_rot.staging_stats(vol.device, torch.bfloat16)
        stats.zero_()
        before = extract_rot.launches_bf16
        got, ok = extract_rot.rotated_patches_bf16(vb, pos, F, patch)
        ref, ok_ref = extract_rot.rotated_patches_bf16_reference(vb, pos, F,
                                                                 patch)
        unstaged, staged = stats.tolist()
        if extract_rot.launches_bf16 != before + 1:
            raise AssertionError(f"K3 bf16 {name}: the wrapper did not count "
                                 "its launch")
        if unstaged:
            raise AssertionError(f"K3 bf16 {name}: {unstaged} items not "
                                 "staged")
        torch.testing.assert_close(got, ref, atol=K3_ATOL, rtol=0)
        near = near_bound_agents(vol.shape, pos, F, patch)
        differ = (ok != ok_ref).cpu().numpy()
        if (differ & ~near).any():
            raise AssertionError(f"K3 bf16 {name}: ok differs from the plain "
                                 "version")
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        rec = dict(kernel="rotated_patches_bf16", case=name,
                   vol=list(vol.shape), B=pos.shape[0], patch=list(patch),
                   max_abs_err=err, staged_bytes=2 * staged,
                   bit_exact=bool(torch.equal(got, ref)),
                   ok_fraction=ok.float().mean().item(),
                   ok_differ=int(differ.sum()),
                   aligned_instance=vol.shape[3] % 8 == 0)
        if timed:
            pms, ms, f32_ms = graph_ms([
                lambda: extract_rot.rotated_patches_bf16_reference(
                    vb, pos, F, patch),
                lambda: extract_rot.rotated_patches_bf16(vb, pos, F, patch),
                lambda: extract_rot.rotated_patches(vol, pos, F, patch)])
            got32, _ = extract_rot.rotated_patches(vol, pos, F, patch)
            bound = patch_bound(pos.shape[0], vol.shape[0], patch,
                                4.0 * (pos.numel() + F.numel()), 39,
                                window_bytes=2)
            stats32 = extract_rot.staging_stats(vol.device)
            stats32.zero_()
            extract_rot.rotated_patches(vol, pos, F, patch)
            rec.update(ms=ms, plain_ms=pms, f32_kernel_ms=f32_ms,
                       bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                       f32_staged_bytes=4 * stats32[1].item(),
                       timing="cuda graph of 20 launches, CUDA events",
                       f64_errors=k3_errors_vs_f64(vol, pos, F, patch, got32,
                                                   got))
        emit("kernel", **rec)
    return (max_err, ms, pms) + bound + (None,)


# ---------------------------------------------------------------- training

#: the bench's two training rows (``bench.py:210-296``): name, batch,
#: desired patch, steps a chunk, cube shape (f, Z, X, Y); two cubes each
TRAIN_ROWS = (("b4", 4, (15, 55, 55), 16, (1, 48, 128, 128)),
              ("slab", 1, (47, 183, 183), 4, (1, 72, 200, 200)))
TRAIN_MIN_CHUNKS = 16                   # check (c): b4 chunks at least
TRAIN_TURN_CHUNKS = 2                   # chunks in one timed turn
TRAINSTEP_N = 8                         # trainingstep calls timed
GRAD_F64_TOL = 1e-4                     # check (a): relative L2 per leaf
SERVE_SHAPE = (1, 64, 256, 256)         # check (e): one request


def full_params(model, params):
    """``params`` completed with the model's own values of the leaves it
    lacks (batch norm's gamma 1 and beta 0, prelu's slopes)."""
    out = {n: dict(d) for n, d in params.items()}
    for n, d in model.params.items():
        for k, v in d.items():
            out.setdefault(n, {}).setdefault(k, v)
    return out


def train_setup(B, patch, K, cube, build=neuro3d_train_model):
    """The bench's training net at full width (or ``build``'s, e.g. its
    batch-normed form) with He-normal weights from numpy seed 0 (batch
    norm's gamma and beta left at 1 and 0), two cubes from numpy seed 0
    labelled by thresholding the raw cube at 0.5 (labels the net can learn,
    so check (c) can see the loss fall), the augmenter (warp amount 1, grey
    on channel 0) and the fused loop (warp 0.5, flips on)."""
    model = build(B, patch)
    model.set_params(full_params(model, seeded_params(
        model, np.random.RandomState(SEED))))
    rng = np.random.RandomState(SEED)
    raws = [rng.rand(*cube).astype(np.float32) for _ in range(2)]
    labs = [(r[0] > 0.5).astype(np.int16) for r in raws]
    ps = model.prediction_node.shape
    aug = DeviceBatchAugmenter(raws, labs,
                               patch_size=model.input_node.shape.spatial_shape,
                               target_size=ps.spatial_shape,
                               target_strides=ps.strides, grey_channels=[0],
                               seed=SEED)
    loop = FusedTrainLoop(model, aug, batch_size=B, n_inner=K, warp=0.5,
                          seed=SEED)
    return model, aug, loop


def neuro3d_loss_f64(model, params, x, t):
    """The neuro3d net's loss written out in plain float64 ops (conv + bias
    -> max pool -> ReLU, the 1x1 conv, softmax, the sparse NLL's mean), the
    reference of check (a)."""
    F = torch.nn.functional
    h = x.double()
    for i in range(4):
        node, p = model.nodes[f"conv{i}"], params[f"conv{i}"]
        h = F.conv3d(h, p["w"], p["b"])
        if any(q > 1 for q in node.pool_shape):
            h = F.max_pool3d(h, node.pool_shape)
        h = torch.relu(h)
    probs = torch.softmax(F.conv3d(h, params["cls"]["w"],
                                   params["cls"]["b"]), 1)
    logp = torch.log(torch.clamp(probs, min=1e-10))
    return -torch.gather(logp, 1, t.long()[:, None]).mean()


def grads_vs_f64(model, aug, B):
    """Check (a): one step's gradients (the port's float32 forward and
    backward on the card) against the same step in float64; returns each
    leaf's relative L2 error."""
    data, tgt = aug.getbatch(B, warp=0.5)
    _, _, grads, _ = model._loss_and_grads(model._feed(data, tgt), None)
    p64 = {n: {k: v.detach().double().requires_grad_() for k, v in d.items()}
           for n, d in model.params.items()}
    names = [(n, k) for n in sorted(p64) for k in sorted(p64[n])]
    g64 = torch.autograd.grad(neuro3d_loss_f64(model, p64, data, tgt),
                              [p64[n][k] for n, k in names])
    errs = {f"{n}/{k}": ((grads[n][k].double() - g).norm() / g.norm()).item()
            for (n, k), g in zip(names, g64)}
    bad = {k: v for k, v in errs.items() if not v <= GRAD_F64_TOL}
    if bad:
        raise AssertionError(f"train: gradients off float64 by {bad} > "
                             f"{GRAD_F64_TOL} (TF32 would show ~1e-3)")
    return errs


def trees_equal(a, b):
    return set(a) == set(b) and all(
        torch.equal(a[n][k], v) for n, d in b.items() for k, v in d.items())


def clone_tree(tree):
    return {n: {k: v.clone() for k, v in d.items()} for n, d in tree.items()}


def graphed_equals_eager(model, loop):
    """Check (b): under cudnn.deterministic, a graphed chunk equals the
    eager chunk from the same parameters, optimiser state, aux state (batch
    norm's running statistics) and generator state (batches, dropout's
    masks), bit for bit: the losses, the parameters and the aux state.
    Returns the chunk means of the two chunks that trained on."""
    torch.backends.cudnn.deterministic = True
    try:
        first, _ = loop.run_chunk()             # captured under the flag
        model.snapshot_good()
        state = loop.generator.get_state()
        eager_l, _ = loop._run_chunk_eager()
        eager_p, eager_s = clone_tree(model.params), clone_tree(model.state)
        model.repair_fuckup()
        loop.generator.set_state(state)
        graph_l, _ = loop.run_chunk()
    finally:
        torch.backends.cudnn.deterministic = False
    if not (np.array_equal(graph_l, eager_l)
            and trees_equal(model.params, eager_p)
            and trees_equal(model.state, eager_s)):
        raise AssertionError("train: the graphed chunk differs from the "
                             "eager chunk")
    return [float(first.mean()), float(graph_l.mean())]


def no_sync_chunks(loop):
    """Check (d): an eager chunk and a replay each launch with no host sync
    (PyTorch raises on any synchronising call); each chunk's losses are read
    after it. Returns the two chunks' mean losses."""
    means = []
    for launch in (loop._launch_eager, loop._launch_graphed):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        means.append(float(loop._result()[0].mean()))
    return means


def step_work(model, aug, B):
    """(step FLOPs, augmentation FLOPs, bytes) of one training step: each
    conv's forward, weight gradient and (but the first's) data gradient at
    2 FLOPs a multiply-add; the separable warp's four matmul passes of the
    image and of the target; the batch and the target read once, the
    parameters and Adam's two slots read and written once."""
    from elektronn2_tpu_torch.ops.warp import _sep_geometry
    flop = 0.0
    for name in ("conv0", "conv1", "conv2", "conv3", "cls"):
        node, w = model.nodes[name], model.params[name]["w"]
        out = B * np.prod([s - k + 1 for s, k in zip(
            node.parents[0].shape.spatial_shape, w.shape[2:])])
        fwd = 2.0 * out * w.shape[0] * int(np.prod(w.shape[1:]))
        flop += fwd * (2 if name == "conv0" else 3)
    nx3, (nbz, nbx, nby) = _sep_geometry(aug.patch_size, aug.warp_amount)

    def passes(f, z, x, y):
        return f * (z * nbz * nbx * nby + nby * nx3 * nbx * z
                    + nx3 * y * nby * z + y * x * nx3 * z)
    aug_flop = 2.0 * B * (passes(aug.raws.shape[1], *aug.patch_size)
                          + passes(1, *aug.target_size))
    nbytes = 4.0 * (B * (np.prod(aug.patch_size) + np.prod(aug.target_size))
                    + 3 * 2 * model.param_count)
    return flop, aug_flop, nbytes


def serve_request(model, vol, ptail):
    model.set_dilated_impl("direct", zfold=True, pallas_tail=ptail)
    out = model.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    return out


def phase_train(smi):
    """The training path at full width, the bench's b4 and slab rows: the
    fused loop's graphed chunks (one CUDA graph replay each, the main path)
    and eager chunks timed in turns, ``trainingstep`` per step, a profile
    of one graphed chunk, checks (a)-(d), and after the b4 row check (e):
    the trained weights served through K1. Returns K1's launches in the
    serving run."""
    k1_launches = 0
    for name, B, patch, K, cube in TRAIN_ROWS:
        model, aug, loop = train_setup(B, patch, K, cube)
        pin = tuple(model.input_node.shape.spatial_shape)
        pout = tuple(model.prediction_node.shape.spatial_shape)
        if name == "b4":
            rng = np.random.RandomState(SEED + 9)
            vol = torch.from_numpy(rng.rand(*SERVE_SHAPE).astype(
                np.float32)).cuda()
            before = serve_request(model, vol, ptail=True)
            grads = grads_vs_f64(model, aug, B)             # (a)
        history = graphed_equals_eager(model, loop)         # (b)
        capture = loop.capture_seconds
        history.append(float(loop.run_chunk()[0].mean()))  # recapture
        history += no_sync_chunks(loop)                     # (d)
        walls = {"graphed": [], "eager": []}
        routes = {"graphed": loop.run_chunk, "eager": loop._run_chunk_eager}
        peak = {}
        torch.cuda.synchronize()
        for route in ROLLOUT_TURNS:
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TRAIN_TURN_CHUNKS):
                t0 = time.perf_counter()
                losses, _ = routes[route]()
                walls[route].append(time.perf_counter() - t0)
                if not np.isfinite(losses).all():
                    raise AssertionError(f"train {name}: non-finite loss")
                history.append(float(losses.mean()))
            peak[route] = max(peak.get(route, 0.0),
                              torch.cuda.max_memory_allocated() / 2**30)
        # the same graphed chunk with cuDNN's algorithm search on (captured
        # anew: the flag is in the graph's key), for where the time goes
        torch.backends.cudnn.benchmark = True
        try:
            history.append(float(loop.run_chunk()[0].mean()))
            search = []
            for _ in range(TRAIN_TURN_CHUNKS):
                t0 = time.perf_counter()
                history.append(float(loop.run_chunk()[0].mean()))
                search.append(time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.benchmark = False
        while name == "b4" and len(history) < TRAIN_MIN_CHUNKS:
            history.append(float(loop.run_chunk()[0].mean()))
        data, tgt = aug.getbatch(B, warp=0.5)
        model.trainingstep(data, tgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAINSTEP_N):
            model.trainingstep(data, tgt)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TRAINSTEP_N
        flop, aug_flop, nbytes = step_work(model, aug, B)
        bound, by = bound_ms(nbytes, flop)
        g, e = min(walls["graphed"]), min(walls["eager"])
        mvox = B * float(np.prod(pin)) * K / 1e6
        emit("train_row", row=name, B=B, K=K, patch_in=list(pin),
             patch_out=list(pout), cube=list(cube),
             graphed_chunk_seconds=walls["graphed"],
             eager_chunk_seconds=walls["eager"], it_s=K / g,
             eager_it_s=K / e, mvox_in_s=mvox / g, eager_mvox_in_s=mvox / e,
             graphed_speedup=e / g, trainingstep_ms=step_s * 1e3,
             cudnn_benchmark_chunk_seconds=search,
             cudnn_benchmark_it_s=K / min(search),
             capture_seconds=capture, recapture_seconds=loop.capture_seconds,
             peak_gib=peak["graphed"], eager_peak_gib=peak["eager"],
             step_gflop=flop / 1e9, aug_gflop=aug_flop / 1e9,
             step_bound_ms=bound, step_bound_by=by,
             graphed_step_ms=g / K * 1e3, nvidia_smi=smi)
        history.append(float(loop.run_chunk()[0].mean()))  # recapture
        prof = profile_once(loop.run_chunk, "conv")
        emit("train_profile", row=name, route="graphed", **prof,
             kernels_per_step=prof["device_kernels"] / K,
             idle_share_of_timed_wall=None if prof["device_ms"] is None
             else 1.0 - prof["device_ms"] / (g * 1e3))
        checks = dict(graphed_equals_eager=True, host_syncs_in_chunk=0,
                      chunks=len(history), chunk_mean_losses=history)
        if name == "b4":
            # (c) the loss falls over at least TRAIN_MIN_CHUNKS chunks
            if not history[-1] < history[0]:
                raise AssertionError(f"train: last chunk's mean loss "
                                     f"{history[-1]} not below the first's "
                                     f"{history[0]}")
            checks["grad_f64_rel_l2"] = grads
            # (e) the trained weights through K1, against the cuDNN route
            # and against the request served before training
            tailconv.launches = 0
            t0 = time.perf_counter()
            k1 = serve_request(model, vol, ptail=True)
            dt = time.perf_counter() - t0
            k1_launches = tailconv.launches
            if k1_launches != 2:
                raise AssertionError(f"train serve: {k1_launches} K1 "
                                     "launches, expected 2")
            ref = serve_request(model, vol, ptail=False)
            err = (k1 - ref).abs().max().item()
            moved = (k1 - before).abs().max().item()
            emit("train_serve", request=list(SERVE_SHAPE), seconds=dt,
                 k1_launches=k1_launches, max_abs_vs_cudnn=err,
                 max_abs_vs_before_training=moved,
                 channel_sum_dev=check_probs(k1, (2,) + SERVE_SHAPE[1:]))
            if err > SLICE_ATOL:
                raise AssertionError(f"train serve: K1 vs cuDNN {err} > "
                                     f"{SLICE_ATOL}")
            if not moved > 100 * SLICE_ATOL:
                raise AssertionError("train serve: the trained model serves "
                                     f"the old weights ({moved})")
            del vol, before, k1, ref
        emit("train_checks", row=name, **checks)
        del model, aug, loop
        torch.cuda.empty_cache()
    return k1_launches


# ------------------------------------------- batch norm and dropout training

BN_TURNS = ("graphed", "eager", "eager", "graphed")   # one chunk a turn
BN_SERVE_SHAPE = (1, 32, 160, 160)     # the served BN net's request
#: a leaf whose float64 gradient is below this share of the step's largest
#: leaf norm has an exact gradient of 0 (a conv bias before batch norm):
#: it is held to an absolute error instead of a relative one
ZERO_GRAD_SHARE = 1e-6


def bn_loss_f64(model, params, x, t, draws):
    """The BN net's loss in plain float64 ops: conv + bias -> max pool ->
    batch norm (the batch's mean and biased variance, eps 1e-5) -> ReLU ->
    dropout with the f32 step's masks, the 1x1 conv, softmax, the sparse
    NLL's mean."""
    F = torch.nn.functional
    h = x.double()
    for i in range(4):
        name = f"conv{i}"
        node, p = model.nodes[name], params[name]
        h = F.conv3d(h, p["w"], p["b"])
        if any(q > 1 for q in node.pool_shape):
            h = F.max_pool3d(h, node.pool_shape)
        mean = h.mean(dim=(0, 2, 3, 4), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2, 3, 4), keepdim=True)
        shape = (1, -1, 1, 1, 1)
        h = (p["bn_gamma"].reshape(shape) * (h - mean)
             * torch.rsqrt(var + 1e-5) + p["bn_beta"].reshape(shape))
        h = torch.relu(h)
        if node.dropout_rate:
            keep = 1.0 - node.dropout_rate
            h = torch.where(draws[name], h / keep, 0.0)
    probs = torch.softmax(F.conv3d(h, params["class"]["w"],
                                   params["class"]["b"]), 1)
    logp = torch.log(torch.clamp(probs, min=1e-10))
    return -torch.gather(logp, 1, t.long()[:, None]).mean()


def bn_grads_vs_f64(model, aug, B):
    """One step's gradients of the BN net (float32 on the card, its dropout
    masks drawn from a generator of its own) against the same step in
    float64 with those masks: relative L2 per leaf (``GRAD_F64_TOL``); a
    leaf whose exact gradient is 0 (``ZERO_GRAD_SHARE``) is held to
    ``GRAD_F64_TOL`` times the largest leaf norm."""
    data, tgt = aug.getbatch(B, warp=0.5)
    gen = torch.Generator(model.device).manual_seed(SEED + 5)
    draws = {}
    _, _, grads, _ = model._loss_and_grads(model._feed(data, tgt), gen,
                                           draws=draws)
    p64 = {n: {k: v.detach().double().requires_grad_() for k, v in d.items()}
           for n, d in model.params.items()}
    names = [(n, k) for n in sorted(p64) for k in sorted(p64[n])]
    g64 = torch.autograd.grad(bn_loss_f64(model, p64, data, tgt, draws),
                              [p64[n][k] for n, k in names])
    want = {}
    for (n, k), g in zip(names, g64):
        want.setdefault(n, {})[k] = g
    rel, zero = grad_errs(grads, want, "train_bn: gradients off float64")
    return dict(grad_f64_rel_l2=rel, grad_f64_zero_leaves_abs_l2=zero,
                dropout_masks=sorted(draws))


def grad_errs(grads, want, what):
    """Each leaf of ``grads`` against ``want``'s: the relative L2 error
    (``rel``), or for a leaf whose reference gradient is 0
    (``ZERO_GRAD_SHARE`` of the largest leaf norm) the L2 error relative to
    that largest norm (``zero``); raises ``what`` if one is over
    ``GRAD_F64_TOL``. Returns (rel, zero)."""
    top = max(g.norm().item() for d in want.values() for g in d.values())
    rel, zero = {}, {}
    for n, d in want.items():
        for k, g in d.items():
            err = (grads[n][k].double() - g.double()).norm().item()
            if g.norm().item() < ZERO_GRAD_SHARE * top:
                zero[f"{n}/{k}"] = err / top
            else:
                rel[f"{n}/{k}"] = err / g.norm().item()
    bad = {k: v for k, v in {**rel, **zero}.items() if not v <= GRAD_F64_TOL}
    if bad:
        raise AssertionError(f"{what} by {bad} > {GRAD_F64_TOL}")
    return rel, zero


def serve_bn(model, path):
    """The trained BN net served densely: rebuilt with MFP on at the
    nearest valid MFP patch, through ``predict_dense_device`` under
    ``set_dilated_impl("direct", pallas_tail=True)`` (batch norm as a
    per-channel affine of the running statistics; K1 takes none of its
    convs: 0 launches), against the host-tiled MFP route (``SLICE_ATOL``),
    and again after ``save`` -> ``modelload``: the same map bit for bit."""
    from elektronn2_tpu_torch.neuromancer.model import rebuild_model
    from elektronn2_tpu_torch.utils.cnncalculator import cnncalculator
    from elektronn2_tpu_torch.utils.convert import (NEURO3D_FILTERS,
                                                    NEURO3D_POOLS)
    patch = cnncalculator(NEURO3D_FILTERS, NEURO3D_POOLS,
                          list(model.input_node.shape.spatial_shape),
                          mfp=True, ndim=3).input
    vol = torch.from_numpy(np.random.RandomState(SEED + 13).rand(
        *BN_SERVE_SHAPE).astype(np.float32)).cuda()

    def serve(m):
        m.set_dilated_impl("direct", pallas_tail=True)
        tailconv.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.predict_dense_device(vol, pad_raw=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, tailconv.launches

    served = rebuild_model(model, override_mfp_to_active=True,
                           imposed_patch_size=patch)
    if inference._dilated_unsupported(served.prediction_node,
                                      served.state) is not None:
        raise AssertionError("train_bn serve: the dilated path refuses the "
                             "trained BN net")
    before, dt, k1 = serve(served)
    t0 = time.perf_counter()
    tiled = served.predict_dense(vol.cpu().numpy(), pad_raw=True,
                                 prefer_device=False)
    tiled_s = time.perf_counter() - t0
    err = float(np.abs(before.cpu().numpy() - tiled).max())
    model.save(path)
    loaded = modelload(path, override_mfp_to_active=True,
                       imposed_patch_size=patch)
    after, _, k1_after = serve(loaded)
    same = bool(torch.equal(before, after))
    rec = dict(request=list(BN_SERVE_SHAPE), patch_mfp=list(patch),
               seconds=dt, tiled_seconds=tiled_s, k1_launches=k1 + k1_after,
               max_abs_vs_tiled_mfp=err, round_trip_bit_exact=same,
               state_nodes=sorted(loaded.state),
               channel_sum_dev=check_probs(before,
                                           (2,) + BN_SERVE_SHAPE[1:]))
    if k1 or k1_after:
        raise AssertionError(f"train_bn serve: K1 took {k1 + k1_after} "
                             "batch-normed convs")
    if err > SLICE_ATOL:
        raise AssertionError(f"train_bn serve: dense vs tiled MFP {err} > "
                             f"{SLICE_ATOL}")
    if not same:
        raise AssertionError("train_bn serve: the map changed over the "
                             "save/load round trip")
    return rec


def phase_train_bn(smi):
    """The batch-normed, dropout neuro3d net (``neuro3d_bn_train_model``:
    ``simple_cnn`` at 20/30/40/40, batch norm on every conv, dropout 0.1 on
    the two (3,3,3) convs) at ``TRAIN_ROWS``' two rows through
    ``FusedTrainLoop``: the running statistics live in the chunk graph and
    are written in place, the masks come from the loop's generator. Checks:
    graph = eager bit for bit (losses, parameters, running statistics), the
    b4 step's gradients against float64 with its masks held, no host sync
    in a chunk, the b4 loss falls over >= ``TRAIN_MIN_CHUNKS`` chunks;
    graphed and eager chunks timed in turns (``BN_TURNS``), a profiled
    graphed chunk (kernels a step). Then the b4 net served
    (``serve_bn``)."""
    for name, B, patch, K, cube in TRAIN_ROWS:
        model, aug, loop = train_setup(B, patch, K, cube,
                                       build=neuro3d_bn_train_model)
        checks = {}
        if name == "b4":
            checks.update(bn_grads_vs_f64(model, aug, B))
        history = graphed_equals_eager(model, loop)
        capture = loop.capture_seconds
        history += no_sync_chunks(loop)
        walls = {"graphed": [], "eager": []}
        routes = {"graphed": loop.run_chunk, "eager": loop._run_chunk_eager}
        peak = {}
        for route in BN_TURNS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses, _ = routes[route]()
            walls[route].append(time.perf_counter() - t0)
            if not np.isfinite(losses).all():
                raise AssertionError(f"train_bn {name}: non-finite loss")
            history.append(float(losses.mean()))
            peak[route] = max(peak.get(route, 0.0),
                              torch.cuda.max_memory_allocated() / 2**30)
        while name == "b4" and len(history) < TRAIN_MIN_CHUNKS:
            history.append(float(loop.run_chunk()[0].mean()))
        prof = profile_once(lambda: history.append(float(
            loop.run_chunk()[0].mean())), "conv")
        g, e = min(walls["graphed"]), min(walls["eager"])
        mvox = B * float(np.prod(model.input_node.shape.spatial_shape)) * K
        emit("train_bn_row", row=name, B=B, K=K,
             patch_in=list(model.input_node.shape.spatial_shape),
             patch_out=list(model.prediction_node.shape.spatial_shape),
             dropout=[model.nodes[f"conv{i}"].dropout_rate for i in range(4)],
             graphed_chunk_seconds=walls["graphed"],
             eager_chunk_seconds=walls["eager"], it_s=K / g,
             eager_it_s=K / e, mvox_in_s=mvox / 1e6 / g,
             eager_mvox_in_s=mvox / 1e6 / e, graphed_speedup=e / g,
             capture_seconds=capture, peak_gib=peak["graphed"],
             eager_peak_gib=peak["eager"],
             kernels_per_step=prof["device_kernels"] / K,
             profile_device_ms=prof["device_ms"],
             profile_idle_share=prof["idle_share"], top=prof["top"][:6],
             nvidia_smi=smi)
        checks.update(graphed_equals_eager=True, host_syncs_in_chunk=0,
                      chunks=len(history), chunk_mean_losses=history,
                      running_stats=sorted(model.state))
        if name == "b4":
            if not history[-1] < history[0]:
                raise AssertionError(f"train_bn: last chunk's mean loss "
                                     f"{history[-1]} not below the first's "
                                     f"{history[0]}")
            with tempfile.TemporaryDirectory() as tmp:
                emit("train_bn_serve", **serve_bn(
                    model, os.path.join(tmp, "bn.mdl")))
        emit("train_bn_checks", row=name, **checks)
        del model, aug, loop
        torch.cuda.empty_cache()


# ------------------------------------------- train lowerings and remat

LOWERING_MODES = (("default", {}, False), ("zfold", dict(zfold=True), False),
                  ("remat", {}, True))
LOWERING_CHUNKS = 2                     # timed chunks a mode
LOWERING_ATOL = 1e-5                    # tests/test_training.py:501
UNET_CHUNK = 4                          # the wide U-Net's host-fed chunk
UNET_GATE_RUNS = 3                      # the skipsum gate's runs


def wgrad_by_layer(model, loop):
    """One eager chunk under ``torch.profiler`` with ``record_shapes``: the
    device ms of the weight-gradient kernels (names holding ``wgrad``) and
    of all kernels under each ``aten::convolution_backward``, by layer (the
    op's weight shape; a z-folded conv's 2-D weight maps to its layer). A
    replay records no ops, so the per-layer split is read from the eager
    chunk; the graphed chunk's own total is ``profile_once``'s."""
    from torch.profiler import ProfilerActivity, profile
    layers = {}
    for n, d in model.params.items():
        w = tuple(d["w"].shape)
        layers[w] = n
        if len(w) == 5 and w[2] == 1:
            layers[w[:2] + w[3:]] = n

    def kernels(evt):
        ks = [(k.name, k.duration) for k in getattr(evt, "kernels", [])]
        for c in evt.cpu_children:
            ks += kernels(c)
        return ks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loop._run_chunk_eager()
        torch.cuda.synchronize()
    wgrad, bwd = {}, {}
    for evt in prof.events():
        if evt.name != "aten::convolution_backward":
            continue
        shapes = evt.input_shapes or []
        layer = layers.get(tuple(shapes[2]) if len(shapes) > 2 else None,
                           "unmatched")
        for kname, us in kernels(evt):
            bwd[layer] = bwd.get(layer, 0.0) + us / 1e3
            if "wgrad" in kname.lower():
                wgrad[layer] = wgrad.get(layer, 0.0) + us / 1e3
    return dict(wgrad_ms_per_chunk=wgrad or None,
                conv_backward_ms_per_chunk=bwd or None)


class UnetData:
    """Seeded host batches for the wide U-Net: raw (B, 1, *patch) uniform,
    labels raw > 0.5 at the output's centre (int32)."""

    def __init__(self, model, seed):
        self.rng = np.random.RandomState(seed)
        self.patch = tuple(model.input_node.shape.spatial_shape)
        self.out = tuple(model.prediction_node.shape.spatial_shape)

    def getbatch(self, batch_size):
        x = self.rng.rand(batch_size, 1, *self.patch).astype(np.float32)
        lo = [(p - o) // 2 for p, o in zip(self.patch, self.out)]
        c = x[:, 0, lo[0]:lo[0] + self.out[0], lo[1]:lo[1] + self.out[1],
              lo[2]:lo[2] + self.out[2]]
        return x, (c > 0.5).astype(np.int32)


def unet_skipsum_chunks(smi):
    """``examples/unet3d_wide.py``'s net at full width (64/128/256,
    16x64x64, the example's own initial weights, its Adam lr 1e-3 clip 10)
    through ``HostFedFusedLoop`` chunks of ``UNET_CHUNK``, under the default
    trace and under ``set_train_lowering(skipsum=True)``, from the same
    weights on the same batches, ``UNET_GATE_RUNS`` times from fresh
    models. Each run's first chunk runs under ``cudnn.deterministic``, so
    the gate reads skipsum's own rounding and not the order of cuDNN's
    atomic adds: its losses within ``LOWERING_ATOL`` of the default
    trace's in every run. In the first run the flag then goes off (the loop
    recaptures) and a chunk is timed."""
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    res = {False: [], True: []}
    for run in range(UNET_GATE_RUNS):
        for skipsum in (False, True):
            m = wide_unet_model(batch=1)
            m.set_opt("Adam", lr=1e-3, clip=10.0)
            m.set_train_lowering(skipsum=skipsum)
            loop = HostFedFusedLoop(m, UnetData(m, SEED), 1, UNET_CHUNK,
                                    prefetch=False)
            torch.cuda.reset_peak_memory_stats()
            torch.backends.cudnn.deterministic = True
            try:
                first, _ = loop.run_chunk()
            finally:
                torch.backends.cudnn.deterministic = False
            row = dict(losses=first.tolist(),
                       capture_seconds=loop.capture_seconds)
            if run == 0:
                loop.run_chunk()                # recaptured without the flag
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.run_chunk()
                wall = time.perf_counter() - t0
                row.update(chunk_seconds=wall, it_s=UNET_CHUNK / wall,
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2**30)
            res[skipsum].append(row)
            del m, loop
            torch.cuda.empty_cache()
    errs = [float(np.abs(np.asarray(s["losses"])
                         - np.asarray(d["losses"])).max())
            for d, s in zip(res[False], res[True])]
    emit("train_lowering_unet", config="examples/unet3d_wide.py",
         chunk=UNET_CHUNK, runs=UNET_GATE_RUNS, default=res[False][0],
         skipsum=res[True][0], loss_max_abs_vs_default=max(errs),
         loss_max_abs_vs_default_by_run=errs,
         default_losses_by_run=[r["losses"] for r in res[False]],
         skipsum_losses_by_run=[r["losses"] for r in res[True]],
         nvidia_smi=smi)
    if not max(errs) <= LOWERING_ATOL:
        raise AssertionError(f"train_lowering unet: skipsum's losses off "
                             f"the default trace's by {errs}")


def phase_train_lowering(smi):
    """``phase_train``'s plain neuro3d rows under the default trace, under
    ``set_train_lowering(zfold=True)`` and under ``set_remat(True)``, each
    from the same weights, batches and draws. Checks: one step's gradients
    (before any chunk, on one ``getbatch`` batch) against the default
    trace's, per leaf as ``grad_errs`` (``GRAD_F64_TOL``), and the first
    graphed chunk's losses within ``LOWERING_ATOL`` of the default trace's,
    both with the algorithms training runs. The same first chunk is also
    run under ``cudnn.deterministic`` from the same start and its distance
    from the default's reported (cuDNN takes other algorithms there, and
    Adam carries their rounding into later losses). Then it/s and peak GiB
    over ``LOWERING_CHUNKS`` graphed chunks, one graphed chunk profiled
    (the weight-gradient kernels' device ms) and the weight-gradient time
    by layer (``wgrad_by_layer``). The zfold-trained b4 weights then serve
    one request through K1, each launch held against its plain version.
    Then the wide U-Net's skipsum chunk (``unet_skipsum_chunks``). Returns
    K1's launches in the served request."""
    k1_launches = 0
    for name, B, patch, K, cube in TRAIN_ROWS:
        ref = ref_det = ref_grads = None
        for mode, lowering, remat in LOWERING_MODES:
            model, aug, loop = train_setup(B, patch, K, cube)
            model.set_train_lowering(**lowering)
            model.set_remat(remat)
            data, tgt = aug.getbatch(B, warp=0.5)
            grads = model._loss_and_grads(model._feed(data, tgt), None)[2]
            ref_grads = grads if ref_grads is None else ref_grads
            g_rel, g_zero = grad_errs(grads, ref_grads,
                                      f"train_lowering {name} {mode}: "
                                      "gradients off the default trace's")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model.snapshot_good()
            gen = loop.generator.get_state()
            torch.backends.cudnn.deterministic = True
            try:
                first_det, _ = loop.run_chunk()
            finally:
                torch.backends.cudnn.deterministic = False
            model.repair_fuckup()
            loop.generator.set_state(gen)
            first, _ = loop.run_chunk()         # recaptured without the flag
            ref = first if ref is None else ref
            ref_det = first_det if ref_det is None else ref_det
            err = float(np.abs(first - ref).max())
            err_det = float(np.abs(first_det - ref_det).max())
            walls = []
            for _ in range(LOWERING_CHUNKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.run_chunk()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            prof = profile_once(loop.run_chunk, "wgrad")
            emit("train_lowering", row=name, mode=mode, B=B, K=K,
                 chunk_seconds=walls, it_s=K / min(walls), peak_gib=peak,
                 first_chunk_losses=first.tolist(),
                 loss_max_abs_vs_default=err,
                 grad_rel_l2_vs_default=g_rel,
                 grad_zero_leaves_abs_l2_vs_default=g_zero,
                 deterministic_first_chunk_losses=first_det.tolist(),
                 deterministic_loss_max_abs_vs_default=err_det,
                 graphed_wgrad_ms=(None if prof["kernel_us_per_launch"] is None
                                   else prof["kernel_us_per_launch"]
                                   * prof["kernel_launches"] / 1e3),
                 graphed_wgrad_launches=prof["kernel_launches"],
                 graphed_device_ms=prof["device_ms"],
                 graphed_top=prof["top"][:6],
                 **wgrad_by_layer(model, loop), nvidia_smi=smi)
            if not err <= LOWERING_ATOL:
                raise AssertionError(f"train_lowering {name} {mode}: the "
                                     f"losses are off the default trace's by "
                                     f"{err}")
            if name == "b4" and mode == "zfold":
                vol = torch.from_numpy(np.random.RandomState(SEED + 14).rand(
                    *SERVE_SHAPE).astype(np.float32)).cuda()
                out, dt, k1_launches, per_launch = k1_serve_recorded(
                    model, vol, "train_lowering serve")
                err_c = (out - serve_request(model, vol, ptail=False)).abs() \
                    .max().item()
                emit("train_lowering_serve", row=name, mode=mode,
                     request=list(SERVE_SHAPE), seconds=dt,
                     k1_launches=k1_launches, max_abs_vs_cudnn=err_c,
                     channel_sum_dev=check_probs(out, (2,) + SERVE_SHAPE[1:]),
                     k1_launches_vs_plain=per_launch)
                if err_c > SLICE_ATOL:
                    raise AssertionError(f"train_lowering serve: K1 vs cuDNN "
                                         f"{err_c} > {SLICE_ATOL}")
                del vol, out
            del model, aug, loop
            torch.cuda.empty_cache()
    unet_skipsum_chunks(smi)
    return k1_launches


# ------------------------------------------- tracing heads

TN_PRELU_W = 64                          # the prelu layer of head (a)
TN_FIELD_B, TN_FIELD_K, TN_FIELD_CHUNKS = 256, 8, 12
TN_FIELD_NOISE = 3.0                     # voxels off the helix, std
SKEL_FIELD_TOL = 0.6                     # tests/test_tracing.py:680
HELIX_NODES = 2000                       # ~0.4 voxel between nodes


class FieldData:
    """Host batches of the skeleton-field head: agents at helix points
    moved off it by ``TN_FIELD_NOISE`` voxels, their ``TRACE_PATCH`` views
    of ``vol`` and their [skel_id, z, x, y] rows."""

    def __init__(self, vol, helix, seed):
        self.vol, self.helix = vol, helix
        self.rng = np.random.RandomState(seed)
        self.half = np.asarray(TRACE_PATCH) // 2

    def getbatch(self, batch_size):
        idx = self.rng.randint(0, len(self.helix.positions), batch_size)
        pos = self.helix.positions[idx] + self.rng.normal(
            0, TN_FIELD_NOISE, (batch_size, 3))
        lo = np.clip(np.round(pos).astype(int) - self.half, 0,
                     np.asarray(self.vol.shape[1:]) - TRACE_PATCH)
        x = np.stack([self.vol[:, a:a + TRACE_PATCH[0], b:b + TRACE_PATCH[1],
                               c:c + TRACE_PATCH[2]] for a, b, c in lo])
        rows = np.concatenate([np.zeros((batch_size, 1)), pos], 1)
        return x.astype(np.float32), rows.astype(np.float32)


def field_head(fields, loss):
    """The skeleton head: a ``TRACE_PATCH`` view -> Perceptron(64, relu,
    flatten) -> Perceptron(64, prelu) -> Perceptron(3, lin) step, under
    ``SkelLossField`` (``fields``) or ``SkelLoss``; the skeleton rows are a
    ``GenericInput`` fed as the target."""
    from elektronn2_tpu_torch import neuromancer as nm
    nm.model_manager.reset()
    x = nm.Input([TN_FIELD_B, 1, *TRACE_PATCH], "b,f,z,x,y", name="x")
    h = nm.Perceptron(x, 64, flatten=True, name="enc")
    h = nm.Perceptron(h, 64, activation_func="prelu", name="mid")
    step = nm.Perceptron(h, 3, activation_func="lin", name="step")
    skel = nm.GenericInput(name="skel")
    sl = (nm.SkelLossField(step, skel, fields, name="slf")
          if loss == "field" else nm.SkelLoss(step, skel, name="skel_loss"))
    m = nm.model_manager.getmodel("skel_head")
    m.designate_nodes(input_node=x, target_node=skel,
                      loss_node=nm.AggregateLoss(sl), prediction_node=step)
    return m.to("cuda")


def skel_field_training(smi):
    """(b) The skeleton head trained on ``SkelLossField`` over the 256^3
    field of a helix (``HELIX_NODES`` nodes) in ``HostFedFusedLoop``
    chunks (B ``TN_FIELD_B``, K ``TN_FIELD_K``) on views of a volume that
    shows the helix: a chunk graphed equals it eager bit for bit on the
    same staged batches, the loss falls over ``TN_FIELD_CHUNKS`` chunks.
    (c) ``SkelLoss`` (the host KD-tree) evaluated eagerly on one batch with
    the trained weights: its loss within ``SKEL_FIELD_TOL`` of
    ``SkelLossField``'s."""
    from elektronn2_tpu_torch.data import skeleton as sk
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    helix = helix_skeleton(TRACE_VOL[1:], n=HELIX_NODES)
    t0 = time.perf_counter()
    fields = sk.skeleton_distance_field([helix], TRACE_VOL[1:])
    field_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 15)
    vol = (np.exp(-fields / 8.0) + 0.1 * rng.rand(*TRACE_VOL)).astype(
        np.float32)
    model = field_head(fields, "field")
    params = {}
    for n, fan_in in (("enc", int(np.prod(TRACE_PATCH))), ("mid", 64),
                      ("step", 64)):
        d = model.params[n]
        params[n] = {"w": rng.standard_normal(tuple(d["w"].shape))
                     / np.sqrt(fan_in), "b": np.zeros(tuple(d["b"].shape))}
    params["mid"]["alpha"] = np.full(64, 0.25)
    params["slf"] = {"fields": model.params["slf"]["fields"]}
    model.set_params(params)
    model.set_opt("Adam", lr=1e-3)
    loop = HostFedFusedLoop(model, FieldData(vol, helix, SEED), TN_FIELD_B,
                            TN_FIELD_K, prefetch=False)
    history = [float(loop.run_chunk()[0].mean())]       # capture
    torch.backends.cudnn.deterministic = True
    try:
        model.snapshot_good()
        loop._upload(loop._fill())
        loop._launch_eager()
        eager = loop._result()[0]
        eager_p = clone_tree(model.params)
        model.repair_fuckup()
        loop._launch_graphed()
        graphed = loop._result()[0]
    finally:
        torch.backends.cudnn.deterministic = False
    same = bool(np.array_equal(eager, graphed)
                and trees_equal(model.params, eager_p))
    walls = []
    for _ in range(TN_FIELD_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history.append(float(loop.run_chunk()[0].mean()))
        walls.append(time.perf_counter() - t0)
    # (c) the host query on one batch with the trained weights
    sk.clear_skeleton_registry()
    sk.register_skeleton(helix)
    host = field_head(None, "callback")
    host.set_params({n: d for n, d in model.params.items() if n != "slf"})
    x, rows = FieldData(vol, helix, SEED + 1).getbatch(TN_FIELD_B)
    x, rows = torch.from_numpy(x).cuda(), torch.from_numpy(rows).cuda()
    l_field = float(model.loss(x, rows))
    t0 = time.perf_counter()
    l_host = float(host.loss(x, rows))
    host_s = time.perf_counter() - t0
    per = [m._apply([m.loss_node.parents[0]], m.params, m.state,
                    m._feed(x, rows), None, train=False)[0][0]
           for m in (model, host)]
    diff = (per[0] - per[1]).abs()
    sk.clear_skeleton_registry()
    emit("tracing_nodes_field", B=TN_FIELD_B, K=TN_FIELD_K,
         chunks=len(history), vol=list(TRACE_VOL), helix_nodes=HELIX_NODES,
         field_seconds=field_s, chunk_seconds=walls,
         it_s=TN_FIELD_K / min(walls), capture_seconds=loop.capture_seconds,
         chunk_mean_losses=history, graphed_equals_eager=same,
         skel_loss=l_host, skel_loss_field=l_field,
         skel_loss_seconds=host_s,
         per_agent_abs_diff=dict(median=diff.median().item(),
                                 max=diff.max().item()),
         nvidia_smi=smi)
    if not same:
        raise AssertionError("tracing_nodes: the graphed field chunk "
                             "differs from the eager one")
    if not history[-1] < history[0]:
        raise AssertionError(f"tracing_nodes: the field loss {history[-1]} "
                             f"did not fall below {history[0]}")
    if not abs(l_host - l_field) <= SKEL_FIELD_TOL:
        raise AssertionError(f"tracing_nodes: SkelLoss {l_host} vs "
                             f"SkelLossField {l_field}")
    del model, host, loop
    torch.cuda.empty_cache()


def phase_tracing_nodes(smi):
    """The tracer's new heads, (b) and (c): ``skel_field_training``. Head
    (a), the prelu head, is ``phase_trace(rotate=False,
    prelu_w=TN_PRELU_W)``, run in ``main`` beside the other rollouts,
    before the pools (``profile_once``)."""
    skel_field_training(smi)


TRAIN_CLI_RUNS = (                      # (config, steps, warm-up steps)
    ("neuro3d", 300, 20),                # per step, 2 forked workers
    ("unet3d_wide", 64, 8),              # host-fed chunks of 4
    ("neuro3d_fast", 96, 32),            # device-sampled chunks of 16
    ("mlp_mnist", 300, 20),              # Perceptrons with dropout, 1 worker
    ("malis3d", 300, 20))                # MalisNLL, per step
TRAIN_CLI_WINDOW = 20                   # steps profiled, at a run's end
GETBATCH_N = 20                         # host getbatch calls timed


class CliProbe:
    """What a CLI run's Trainer did, seen from the calls it trains with
    (``Model.trainingstep`` a step, either fused loop's ``run_chunk`` a
    chunk): the steps done and the time after each call, a
    ``torch.profiler`` window over the run's last ``window`` steps or more
    (whole calls), and the trainer itself (``Trainer.run``)."""

    def __init__(self, n_steps, window, data_seed=None):
        self.n_steps, self.window = n_steps, window
        self.data_seed = data_seed
        self.steps, self.stamps = 0, []
        self.prof = self.trainer = self.window_at = self.rate_at = None
        self.initial = None             # the parameters before Trainer.run
        self.window_wall = self.window_steps = None
        self.batch_waits = []           # seconds in BackgroundProc.get

    def _timed_get(self, orig):
        def get(bg, *a, **kw):
            t0 = time.perf_counter()
            out = orig(bg, *a, **kw)
            self.batch_waits.append(time.perf_counter() - t0)
            return out
        return get

    def _wrap(self, orig, k):
        def call(obj, *a, **kw):
            n = k or obj.n_inner
            if self.window_at is None and \
                    self.steps + n > self.n_steps - self.window:
                from torch.profiler import ProfilerActivity, profile
                self.rate_at = (self.steps, time.perf_counter())
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.window_at = (self.steps, time.perf_counter())
            out = orig(obj, *a, **kw)
            self.steps += n
            self.stamps.append((self.steps, time.perf_counter()))
            if self.prof is not None and self.steps >= self.n_steps:
                torch.cuda.synchronize()
                self.window_wall = time.perf_counter() - self.window_at[1]
                self.window_steps = self.steps - self.window_at[0]
                self.prof.stop()
            return out
        return call

    def patches(self):
        """(owner, attribute, replacement) of every wrapped call."""
        from elektronn2_tpu_torch.neuromancer.model import Model
        from elektronn2_tpu_torch.training import fused_loop
        from elektronn2_tpu_torch.training.parallelisation import \
            BackgroundProc
        from elektronn2_tpu_torch.training.trainer import Trainer
        run = Trainer.run

        def keep(tr):
            self.trainer = tr
            if self.data_seed is not None:       # a reproducible stream
                tr.data.rng = np.random.RandomState(self.data_seed)
            self.initial = {n: {k: v.detach().cpu().clone()
                                for k, v in d.items()}
                            for n, d in tr.model.params.items()}
            return run(tr)
        return [(Model, "trainingstep", self._wrap(Model.trainingstep, 1)),
                (fused_loop.FusedTrainLoop, "run_chunk",
                 self._wrap(fused_loop.FusedTrainLoop.run_chunk, None)),
                (fused_loop.HostFedFusedLoop, "run_chunk",
                 self._wrap(fused_loop.HostFedFusedLoop.run_chunk, None)),
                (BackgroundProc, "get", self._timed_get(BackgroundProc.get)),
                (Trainer, "run", keep)]

    def rate(self, warm):
        """Steps a second from the end of the call that finished the
        ``warm``-th step to the start of the profiled window (before the
        profiler starts: its first start in a process takes seconds)."""
        s0, t0 = next((s, t) for s, t in self.stamps if s >= warm)
        s1, t1 = self.rate_at
        return (s1 - s0) / (t1 - t0)

    def window_profile(self, top=6):
        """Device ms a step (kernels; host-to-device copies apart), the
        copies' ms a step, and the device's idle share of the window."""
        from torch.autograd import DeviceType
        dev = [e for e in self.prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        h2d = [e for e in dev if e.key.startswith("Memcpy HtoD")]
        kern = sorted((e for e in dev if not e.key.startswith("Memcpy")
                       and not e.key.startswith("Memset")),
                      key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        n = self.window_steps
        return dict(
            window_steps=n, window_wall_ms=self.window_wall * 1e3,
            device_ms_per_step=sum(e.self_device_time_total
                                   for e in kern) / 1e3 / n,
            h2d_ms_per_step=sum(e.self_device_time_total
                                for e in h2d) / 1e3 / n,
            h2d_copies=sum(e.count for e in h2d),
            idle_share=1.0 - busy_ms / (self.window_wall * 1e3),
            top=[dict(kernel=e.key[:80], ms=e.self_device_time_total / 1e3,
                      calls=e.count) for e in kern[:top]])


def getbatch_cost(trainer):
    """The host's ``getbatch`` of the run's data source: ms a batch (mean of
    ``GETBATCH_N`` calls in this process, alone on the host) and the
    patches it drew and threw away a batch (``WarpingOOBError`` retries);
    None for a source that samples on the card."""
    data = trainer.data
    if hasattr(data, "device_batch"):
        return None, None
    if hasattr(trainer, "n_scan_steps"):         # tracing batches
        t0 = time.perf_counter()
        for _ in range(GETBATCH_N):
            data.get_tracing_batch(trainer.batch_size,
                                   n_steps=trainer.n_scan_steps)
        return (time.perf_counter() - t0) / GETBATCH_N * 1e3, None
    data.getbatch(trainer.batch_size, **trainer.data_batch_args)
    failed = getattr(data, "_n_failed", None)     # image sources only
    t0 = time.perf_counter()
    for _ in range(GETBATCH_N):
        data.getbatch(trainer.batch_size, **trainer.data_batch_args)
    return ((time.perf_counter() - t0) / GETBATCH_N * 1e3,
            None if failed is None else
            (data._n_failed - failed) / GETBATCH_N)


def train_cli_run(smi, name, n_steps, warm, tmp, fall_window=None,
                  data_seed=None):
    """One run of the train CLI's ``main`` on ``examples/<name>.py``: its
    numbers (one JSON line) and checks (the loss falls, every loss finite,
    a ``.mdl`` written). The loss falls when the smoothed loss at the last
    step is below 0.98 x that at the first or, with ``fall_window``, when
    the mean loss of the last ``fall_window`` steps is below 0.98 x that of
    the first (for a noisy loss, whose smoothing starts at one draw).
    ``data_seed``: the data source's ``RandomState`` seed, set when the run
    starts. Returns the trainer, the model file and the parameters the run
    started from."""
    from elektronn2_tpu_torch.scripts import train
    probe = CliProbe(n_steps, TRAIN_CLI_WINDOW, data_seed)
    out = os.path.join(tmp, name)
    args = [os.path.join("examples", f"{name}.py"), "--n-steps",
            str(n_steps), "--save-path", out]
    saved = [(o, a, getattr(o, a)) for o, a, _ in probe.patches()]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for o, a, f in probe.patches():
        setattr(o, a, f)
    try:
        train.main(args)
    finally:
        for o, a, f in saved:
            setattr(o, a, f)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    tr = probe.trainer
    tl = tr.history.timeline.data
    mdl = os.path.join(out, f"{name}-LAST.mdl")
    loop = getattr(tr, "fused_loop", None)
    gb_ms, gb_retries = getbatch_cost(tr)
    waits = probe.batch_waits[warm:]
    emit("train_cli", run=name, config=f"examples/{name}.py",
         steps=tr.step, batch=tr.batch_size,
         patch_in=list(tr.model.input_node.shape.spatial_shape),
         fused_steps=None if loop is None else loop.n_inner,
         loop=None if loop is None else type(loop).__name__,
         workers=tr.n_workers if loop is None else 0,
         warm_steps=warm, it_s=probe.rate(warm),
         ms_per_step=1e3 / probe.rate(warm), getbatch_ms=gb_ms,
         getbatch_retries=gb_retries,
         worker_wait_ms_per_step=(sum(waits) / len(waits) * 1e3 if waits
                                  else None),
         **probe.window_profile(), peak_gib=peak,
         loss_smooth_first=float(tl[0, 3]), loss_smooth_last=float(tl[-1, 3]),
         **({} if fall_window is None else dict(
             fall_window=fall_window,
             loss_mean_first=float(tl[:fall_window, 2].mean()),
             loss_mean_last=float(tl[-fall_window:, 2].mean()))),
         data_seed=data_seed,
         capture_seconds=None if loop is None else loop.capture_seconds,
         call_ms=(np.diff([t for _, t in probe.stamps]) * 1e3).round(
             3).tolist() if loop is not None else None,
         wall_seconds=wall, nvidia_smi=smi)
    if len(tl) != n_steps or tr.step != n_steps:
        raise AssertionError(f"train_cli {name}: {len(tl)} steps recorded, "
                             f"{tr.step} run, {n_steps} asked")
    if not np.isfinite(tl[:, 2]).all():
        raise AssertionError(f"train_cli {name}: non-finite loss")
    first, last = ((tl[0, 3], tl[-1, 3]) if fall_window is None else
                   (tl[:fall_window, 2].mean(), tl[-fall_window:, 2].mean()))
    if not last < first * 0.98:
        raise AssertionError(f"train_cli {name}: the loss {last} did not "
                             f"fall below 0.98 x {first}")
    if not os.path.exists(mdl):
        raise AssertionError(f"train_cli {name}: no {mdl}")
    return tr, mdl, probe.initial


#: K1's own output in the served request against cuDNN float32 on the same
#: input: max abs error over the output's largest magnitude
K1_SERVE_RTOL = 1e-4
#: and a real share of its voxels past the ReLU, so the check can fail
K1_SERVE_MIN_ACTIVE = 0.01


def k1_calls_vs_plain(calls, what):
    """Each recorded K1 launch ``(x, w, b, dil, y)`` of a served request
    held against the plain version on the same input: the error relative
    to the activation's largest magnitude (``K1_SERVE_RTOL``), the share of
    voxels past the ReLU (``K1_SERVE_MIN_ACTIVE``) and, on the first
    ``F64_PLANES`` planes, K1's and cuDNN's distance from float64 (K1 no
    further than twice cuDNN's, as in ``phase_kernel``)."""
    recs = []
    for i, (x, w, b, dil, y) in enumerate(calls):
        ref = k1_plain(x, w, b, dil)
        scale = ref.abs().max().item()
        err = (y - ref).abs().max().item()
        active = (ref > 0).float().mean().item()
        k64, c64 = f64_errors(x, w, b, dil)
        rec = dict(launch=i, x=list(x.shape), cout=w.shape[0],
                   dil=list(dil), max_abs_err=err, max_abs_ref=scale,
                   rel_err=err / scale if scale else None,
                   active_share=active, f64_max_abs=k64,
                   cudnn_f64_max_abs=c64)
        recs.append(rec)
        if not active > K1_SERVE_MIN_ACTIVE or not scale > 0:
            raise AssertionError(f"{what}: K1 launch {i} is past "
                                 f"its ReLU at {active} of its voxels")
        if err > K1_SERVE_RTOL * scale:
            raise AssertionError(f"{what}: K1 launch {i} vs cuDNN "
                                 f"{err} > {K1_SERVE_RTOL} x {scale}")
        if k64 > 2 * c64 + 1e-6 * scale:
            raise AssertionError(f"{what}: K1 launch {i} {k64} "
                                 f"from float64, over 2x cuDNN's {c64}")
        del ref
    return recs


def k1_serve_recorded(model, vol, what, expect=2):
    """One request through the K1 route with every K1 launch recorded and
    held against its plain version (``k1_calls_vs_plain``); ``expect``
    launches (the flagship-class nets' two). Returns the served map, its
    seconds, the launches and the per-launch records."""
    calls, k1_fn = [], tailconv.conv3x3_dilated

    def recorded(x, w, b, dil=(1, 1, 1), relu=True):
        y = k1_fn(x, w, b, dil, relu)
        calls.append((x, w, b, tuple(dil), y))
        return y
    tailconv.launches = 0
    tailconv.conv3x3_dilated = recorded
    try:
        t0 = time.perf_counter()
        out = serve_request(model, vol, ptail=True)
        dt = time.perf_counter() - t0
    finally:
        tailconv.conv3x3_dilated = k1_fn
    launches = tailconv.launches
    if launches != expect or len(calls) != expect:
        raise AssertionError(f"{what}: {launches} K1 launches, "
                             f"{len(calls)} recorded, expected {expect}")
    return out, dt, launches, k1_calls_vs_plain(calls, what)


def phase_train_cli(smi):
    """The training entry point at full width: the train CLI on the
    unchanged example configs (``TRAIN_CLI_RUNS``) into a temporary
    directory; then the neuro3d weights it saved, loaded by ``modelload``,
    served through K1 (``set_dilated_impl("direct", zfold=True,
    pallas_tail=True)``). The served probabilities are held against the
    cuDNN route at ``SLICE_ATOL`` and against the request served with the
    weights the run started from (they must have moved); each K1 launch of
    the request is held against its plain version on the same input
    (``k1_calls_vs_plain``), since trained probabilities can saturate and
    then hide a wrong activation. Returns K1's launches in that request."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, n_steps, warm in TRAIN_CLI_RUNS:
            _, mdl, initial = train_cli_run(smi, name, n_steps, warm, tmp)
            if name == "neuro3d":
                served, start = mdl, initial
            torch.cuda.empty_cache()
        model = modelload(served)
        vol = torch.from_numpy(np.random.RandomState(SEED + 11).rand(
            *SERVE_SHAPE).astype(np.float32)).cuda()
        ref = serve_request(model, vol, ptail=False)
        k1, dt, launches, per_launch = k1_serve_recorded(model, vol,
                                                         "train_cli serve")
        err = (k1 - ref).abs().max().item()
        unsaturated = ((k1 > 1e-3) & (k1 < 1 - 1e-3)).float().mean().item()
        probs_dev = check_probs(k1, (2,) + SERVE_SHAPE[1:])
        model.set_params(start)
        moved = (k1 - serve_request(model, vol, ptail=True)).abs().max(
            ).item()
        emit("train_cli_serve", model=os.path.basename(served),
             request=list(SERVE_SHAPE), seconds=dt, k1_launches=launches,
             max_abs_vs_cudnn=err, max_abs_vs_before_training=moved,
             unsaturated_share=unsaturated, channel_sum_dev=probs_dev,
             k1_launches_vs_plain=per_launch)
        if err > SLICE_ATOL:
            raise AssertionError(f"train_cli serve: K1 vs cuDNN {err} > "
                                 f"{SLICE_ATOL}")
        if not moved > 100 * SLICE_ATOL:
            raise AssertionError("train_cli serve: the trained model serves "
                                 f"the weights it started from ({moved})")
        del model, vol, ref, k1
    torch.cuda.empty_cache()
    return launches


DP_CLI_STEPS = 96       # neuro3d_pod through the CLI: 12 graphed chunks of 8
DP_CLI_WARM = 16        # steps before the CLI's it/s is taken
DP_FALL_WINDOW = 16     # the loss falls: mean of the last 16 vs the first
DP_EAGER_STEPS = 4      # (b): eager trainingsteps, mesh of one vs none
DP_CHUNKS = 2           # (b): graphed chunks each
DP_RTOL = 1e-6          # (b): losses and parameters, relative
DP_TIMED_CHUNKS = 5     # (b): chunks timed in turns, mesh and no mesh
DP_RANK_STEPS = 3       # (c): eager steps on two gloo ranks
DP_RANK_LOSS_RTOL = 1e-5            # (c): as tests/test_torch_parallel.py
DP_RANK_W_RTOL, DP_RANK_W_ATOL = 1e-4, 1e-6


def pod_setup():
    """neuro3d_pod's model (its config's seed-0 weights, optimiser) and
    augmenter on the card, built from the unchanged config file."""
    from elektronn2_tpu_torch.config import ExperimentConfig
    exp = ExperimentConfig.from_file(os.path.join("examples",
                                                  "neuro3d_pod.py"))
    model = exp.create_model().to("cuda")
    model.set_opt(exp.optimiser, **exp.optimiser_params)
    aug = DeviceBatchAugmenter(**exp.data_init_kwargs, device="cuda")
    return exp, model, aug


def rel_tree_err(a, b):
    """The largest relative difference of two parameter trees (per leaf,
    over the leaf's largest magnitude)."""
    return max(((a[n][k] - b[n][k]).abs().max()
                / b[n][k].abs().max().clamp_min(1e-30)).item()
               for n in b for k in b[n])


#: what names NCCL's kernels (at one rank, ``oneRankReduce``)
NCCL_KERNEL_KEYS = ("nccl", "onerank")


def device_kernels(prof):
    """``{kernel name: (launches, device ms)}`` of a profile."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def nccl_kernels(kernels):
    """(launches, device ms, names) of the NCCL kernels among
    ``device_kernels``' result."""
    ev = {k: v for k, v in kernels.items()
          if any(t in k.lower() for t in NCCL_KERNEL_KEYS)}
    return (sum(n for n, _ in ev.values()),
            sum(ms for _, ms in ev.values()), sorted(ev))


def dp_mesh_of_one(smi):
    """(b): neuro3d_pod under a mesh of one (NCCL) against no mesh, from
    the same weights and batches: ``DP_EAGER_STEPS`` eager trainingsteps,
    then ``DP_CHUNKS`` graphed FusedTrainLoop chunks each, losses and
    parameters within ``DP_RTOL``; the NCCL kernels counted in one
    profiled replay of the meshed chunk (at least one a step: the gradient
    all-reduce is in the graph, not skipped at world size 1); both loops'
    chunks timed in turns."""
    from torch.profiler import ProfilerActivity, profile
    from elektronn2_tpu_torch.parallel import make_mesh
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exp, plain, aug = pod_setup()
        _, meshed, aug_m = pod_setup()
        meshed.set_params(plain.params)
        meshed.use_mesh(make_mesh({"data": 1}))
        B, K = exp.batch_size, exp.fused_steps
        warp = exp.data_batch_args.get("warp", 0.5)
        gen = torch.Generator("cuda").manual_seed(SEED)
        eager = []
        for _ in range(DP_EAGER_STEPS):
            d, t = aug.device_batch(gen, B, warp=warp)
            eager.append([float(m.trainingstep(d, t)[0])
                          for m in (plain, meshed)])
        loops = [FusedTrainLoop(m, a, B, K, warp=warp, seed=SEED)
                 for m, a in ((plain, aug), (meshed, aug_m))]
        chunks = [[loop.run_chunk()[0] for loop in loops]
                  for _ in range(DP_CHUNKS)]
        loss_err = max([abs(a - b) / abs(a) for a, b in eager]
                       + [float(np.max(np.abs(a - b) / np.abs(a)))
                          for a, b in chunks])
        w_err = rel_tree_err(meshed.params, plain.params)
        times = {"none": [], "mesh": []}
        for _ in range(DP_TIMED_CHUNKS):
            for name, loop in zip(("none", "mesh"), loops):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.run_chunk()
                times[name].append((time.perf_counter() - t0) * 1e3)
        kernels = []
        for loop in loops:             # one profiled replay each
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loop.run_chunk()
                torch.cuda.synchronize()
            kernels.append(device_kernels(prof))
        n_nccl, nccl_ms, names = nccl_kernels(kernels[1])
        busy = sum(ms for _, ms in kernels[1].values())
        mesh_only = {k: v for k, v in kernels[1].items()
                     if v[0] != kernels[0].get(k, (0, 0))[0]}
    finally:
        torch.backends.cudnn.deterministic = det
    none_ms, mesh_ms = np.median(times["none"]), np.median(times["mesh"])
    emit("train_dp_mesh_of_one", config="examples/neuro3d_pod.py", batch=B,
         fused_steps=K, eager_steps=DP_EAGER_STEPS, graphed_chunks=DP_CHUNKS,
         eager_losses=eager, chunk_losses=[[a.tolist(), b.tolist()]
                                           for a, b in chunks],
         max_rel_loss_err=loss_err, max_rel_param_err=w_err,
         chunk_ms_no_mesh=times["none"], chunk_ms_mesh=times["mesh"],
         it_s_no_mesh=K / none_ms * 1e3, it_s_mesh=K / mesh_ms * 1e3,
         mesh_overhead=mesh_ms / none_ms - 1,
         nccl_kernels_in_replay=n_nccl, nccl_ms_in_replay=nccl_ms,
         nccl_kernel_names=names, replay_device_ms=busy,
         replay_device_ms_no_mesh=sum(ms for _, ms in kernels[0].values()),
         kernels_added_by_mesh={k: list(v) for k, v in mesh_only.items()},
         nccl_share_of_replay=nccl_ms / busy if busy else None,
         capture_seconds=loops[1].capture_seconds, nvidia_smi=smi)
    if not loss_err <= DP_RTOL or not w_err <= DP_RTOL:
        raise AssertionError(f"train_dp: mesh of one vs no mesh: losses "
                             f"{loss_err}, parameters {w_err} > {DP_RTOL}")
    if n_nccl < K:
        raise AssertionError(f"train_dp: {n_nccl} NCCL kernels in a replay "
                             f"of {K} steps; the all-reduce is not in the "
                             "graph")


def dp_rank(rank, world, port, inputs, out_dir):
    """(c): one of two gloo ranks on the one card: neuro3d_pod's model
    from ``inputs`` (weights and global batches), a mesh over the two
    ranks, eager trainingsteps; writes its losses and parameters."""
    import torch.distributed as dist
    from elektronn2_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        _, model, _ = pod_setup()
        with np.load(inputs) as z:
            model.set_params({n: {k: z[f"w/{n}/{k}"]
                                  for k in model.params[n]}
                              for n in model.params})
            batches = [(torch.from_numpy(z[f"d{i}"]).cuda(),
                        torch.from_numpy(z[f"t{i}"]).cuda())
                       for i in range(DP_RANK_STEPS)]
        model.use_mesh(make_mesh({"data": world}))
        losses = [float(model.trainingstep(d, t)[0]) for d, t in batches]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.asarray(losses),
                 **{f"w/{n}/{k}": v.cpu().numpy()
                    for n, d in model.params.items() for k, v in d.items()})
    finally:
        dist.destroy_process_group()


def dp_two_ranks(smi, tmp):
    """(c): two gloo ranks on CUDA tensors (eager steps) against the
    single-process run of the same weights and global batches."""
    import torch.multiprocessing as mp
    from elektronn2_tpu_torch.parallel.mesh import free_port
    exp, model, aug = pod_setup()
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    warp = exp.data_batch_args.get("warp", 0.5)
    batches = [aug.device_batch(gen, exp.batch_size, warp=warp)
               for _ in range(DP_RANK_STEPS)]
    inputs = os.path.join(tmp, "dp_inputs.npz")
    np.savez(inputs, **{f"w/{n}/{k}": v.cpu().numpy()
                        for n, d in model.params.items()
                        for k, v in d.items()},
             **{f"d{i}": d.cpu().numpy() for i, (d, _) in enumerate(batches)},
             **{f"t{i}": t.cpu().numpy() for i, (_, t) in enumerate(batches)})
    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(2, free_port(), inputs, tmp),
                       nprocs=2, join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ref = [float(model.trainingstep(d, t)[0]) for d, t in batches]
    ranks = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(2)]
    loss_err = max(float(np.max(np.abs(r["losses"] - ref) / np.abs(ref)))
                   for r in ranks)
    w_err, same = 0.0, True
    for n, d in model.params.items():
        for k, v in d.items():
            want = v.cpu().numpy()
            for r in ranks:
                got = r[f"w/{n}/{k}"]
                w_err = max(w_err, float(np.max(np.abs(got - want)
                                                - DP_RANK_W_RTOL
                                                * np.abs(want))))
            same &= np.array_equal(ranks[0][f"w/{n}/{k}"],
                                   ranks[1][f"w/{n}/{k}"])
    emit("train_dp_two_ranks", backend="gloo", tensors="cuda", ranks=2,
         steps=DP_RANK_STEPS, global_batch=exp.batch_size,
         losses=[r["losses"].tolist() for r in ranks], losses_single=ref,
         max_rel_loss_err=loss_err, max_excess_param_err=w_err,
         ranks_equal=bool(same), seconds=spawn_s, nvidia_smi=smi)
    if not loss_err <= DP_RANK_LOSS_RTOL or not w_err <= DP_RANK_W_ATOL \
            or not same:
        raise AssertionError(f"train_dp: two gloo ranks vs one process: "
                             f"losses {loss_err}, parameters {w_err}, "
                             f"ranks equal {same}")


def phase_train_dp(smi):
    """Data-parallel training on the card (``Model.use_mesh``):
    (a) ``examples/neuro3d_pod.py`` unchanged through the train CLI
    (``mesh_axes`` {"data": 1} from the loader's device count, a process
    group of one on NCCL, ``fused_steps`` 8: ``DP_CLI_STEPS`` steps in
    graphed chunks), the loss falling; (b) a mesh of one against no mesh
    (``dp_mesh_of_one``); (c) two gloo ranks on CUDA tensors against one
    process (``dp_two_ranks``); (d) the trained weights served through K1
    (its conv1, (3,3,3) at xy-dilation 2), each launch held against its
    plain version and the map against the cuDNN route. Returns K1's
    launches in (d)."""
    with tempfile.TemporaryDirectory() as tmp:
        _, mdl, initial = train_cli_run(smi, "neuro3d_pod", DP_CLI_STEPS,
                                        DP_CLI_WARM, tmp,
                                        fall_window=DP_FALL_WINDOW)
        torch.cuda.empty_cache()
        dp_mesh_of_one(smi)
        dp_two_ranks(smi, tmp)
        model = modelload(mdl)
        vol = torch.from_numpy(np.random.RandomState(SEED + 12).rand(
            *SERVE_SHAPE).astype(np.float32)).cuda()
        ref = serve_request(model, vol, ptail=False)
        k1, dt, launches, per_launch = k1_serve_recorded(
            model, vol, "train_dp serve", expect=1)
        err = (k1 - ref).abs().max().item()
        probs_dev = check_probs(k1, (2,) + SERVE_SHAPE[1:])
        model.set_params(initial)
        moved = (k1 - serve_request(model, vol, ptail=True)).abs().max(
            ).item()
        emit("train_dp_serve", model=os.path.basename(mdl),
             request=list(SERVE_SHAPE), seconds=dt, k1_launches=launches,
             max_abs_vs_cudnn=err, max_abs_vs_before_training=moved,
             channel_sum_dev=probs_dev, k1_launches_vs_plain=per_launch)
        if err > SLICE_ATOL:
            raise AssertionError(f"train_dp serve: K1 vs cuDNN {err} > "
                                 f"{SLICE_ATOL}")
        if not moved > 100 * SLICE_ATOL:
            raise AssertionError("train_dp serve: the trained model serves "
                                 f"the weights it started from ({moved})")
        del model, vol, ref, k1
    torch.cuda.empty_cache()
    import torch.distributed as dist
    if dist.is_initialized():               # the CLI's mesh of one
        dist.destroy_process_group()
    return launches


SWEEP_SHAPE = (224, 992, 992)           # the flagship sweep's dataset
SWEEP_STEP = (112, 496, 496)            # sweep_knossos' default under ptail
UNET_SWEEP_SHAPE = (256, 512, 512)      # the U-Net sweep's dataset
UNET_SWEEP_STEP = (128, 512, 512)
SWEEP_TURNS = (1, 2, 2, 1)              # slab_batch of the timed sweeps
KNOSSOS_EDGE = 128


def write_dataset(path, shape, seed):
    """A uint8 volume from numpy ``seed``, written as a KNOSSOS dataset in
    128^3 cubes by the port's ``save_knossos``; returns the volume."""
    vol = np.random.RandomState(seed).randint(0, 256, size=shape,
                                              dtype=np.uint8)
    save_knossos(vol, path, exp_name="raw", cube_edge=KNOSSOS_EDGE)
    return vol


def timed_sweep(model, path, slab_batch, step=None):
    """One ``sweep_knossos`` over the whole dataset at ``path`` (a fresh
    ``KnossosArray``, so its cube cache starts empty), timed on the host
    clock: the sweep returns after its last readback event, so the card is
    done. Returns (output, record)."""
    t = {}
    fallbacks = inference.sweep_oom_fallbacks
    k1 = tailconv.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.sweep_knossos(KnossosArray(path), step=step,
                              slab_batch=slab_batch, timings=t)
    wall = time.perf_counter() - t0
    n = sum(t["slabs"])
    return out, dict(
        slab_batch=slab_batch, seconds=wall,
        mvox_s=float(np.prod(out.shape[1:])) / 1e6 / wall, slabs=n,
        chunks=len(t["slabs"]),
        stage_ms_per_slab=sum(t["stage_s"]) / n * 1e3,
        write_ms_per_slab=sum(t["write_s"]) / n * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        oom_fallbacks=inference.sweep_oom_fallbacks - fallbacks,
        k1_launches=tailconv.launches - k1)


def sweep_timeline(prof):
    """Where a profiled sweep's device idles: from the profiler's trace,
    the union of the kernels' intervals (all streams) within the sweep's
    span (``chip_smoke.sweep``): the idle time before the first kernel
    (``lead_ms``), after the last (``tail_ms``), and between them, summed
    by the sweep's host span on the main thread (``sweep_knossos.enqueue``,
    else "other") that was running when each gap began."""
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "trace.json")
        prof.export_chrome_trace(f)
        with open(f) as fh:
            ev = json.load(fh)["traceEvents"]
    sweep = next(e for e in ev if e.get("name") == "chip_smoke.sweep")
    t0, t1 = sweep["ts"], sweep["ts"] + sweep["dur"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
             if e.get("cat") == "user_annotation"
             and e.get("tid") == sweep.get("tid")
             and e["name"].startswith("sweep_knossos.")]
    busy = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                       if e.get("cat") == "kernel"):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    if not busy:
        return dict(lead_ms=None, tail_ms=None, gaps={})
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        lab = next((n for s, e, n in spans if s <= a < e), "other")
        gaps[lab] = gaps.get(lab, 0.0) + (b - a) / 1e3
    return dict(lead_ms=(busy[0][0] - t0) / 1e3,
                tail_ms=(t1 - busy[-1][1]) / 1e3,
                gaps_by_host_span_ms=gaps,
                busy_ms=sum(b - a for a, b in busy) / 1e3)


def profile_sweep(model, path, slab_batch, step=None, top=8):
    """One more sweep under ``torch.profiler``: the device's kernel time
    (all streams; copies apart) per slab, K1's share, the idle share of
    the sweep's wall (1 - kernel time / wall) and where the idle time
    falls (``sweep_timeline``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    t = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("chip_smoke.sweep"):
            model.sweep_knossos(KnossosArray(path), step=step,
                                slab_batch=slab_batch, timings=t)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the spans' device-side annotations would count their kernels twice
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not e.key.startswith(("chip_smoke.", "sweep_knossos."))]
    copies = [e for e in dev if e.key.startswith(("Memcpy", "Memset"))]
    kernels = sorted((e for e in dev if e not in copies),
                     key=lambda e: e.self_device_time_total, reverse=True)
    kern_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "tailconv_tc_kernel" in e.key) / 1e3
    n = sum(t["slabs"])
    return dict(profiled_wall_ms=wall_ms, kernel_ms=kern_ms,
                device_ms_per_slab=kern_ms / n, k1_ms_per_slab=k1_ms / n,
                copy_ms=sum(e.self_device_time_total for e in copies) / 1e3,
                idle_share=1.0 - kern_ms / wall_ms,
                timeline=sweep_timeline(prof),
                top=[dict(kernel=e.key[:80], ms=e.self_device_time_total
                          / 1e3, calls=e.count) for e in kernels[:top]])


def check_sweep_out(out, shape):
    """(c) finite, channel sums 1 within ``SLICE_ATOL``: on the card."""
    o = torch.from_numpy(out).cuda()
    dev = check_probs(o, shape)
    del o
    return dev


def sweep_max_diff(a, b):
    return (torch.from_numpy(a).cuda() - torch.from_numpy(b).cuda()
            ).abs().max().item()


def phase_sweep_flagship(smi, model, tmp):
    """The flagship swept over a 224x992x992 uint8 KNOSSOS dataset at the
    default ptail step (112, 496, 496), 8 slabs, at slab_batch 1 and 2 in
    turns; checks (a)-(e). Returns K1's launches in the timed sweeps."""
    path = os.path.join(tmp, "flagship_raw")
    t0 = time.perf_counter()
    vol = write_dataset(path, SWEEP_SHAPE, SEED)
    write_s = time.perf_counter() - t0
    shape = (2,) + SWEEP_SHAPE
    step = list(SWEEP_STEP)
    n_slabs = int(np.prod([-(-n // s) for n, s in zip(SWEEP_SHAPE, step)]))
    for b in (1, 2):                  # warm: one row of slabs each
        model.sweep_knossos(KnossosArray(path), slab_batch=b, step=step,
                            region=[(0, step[0]), (0, step[1]),
                                    (0, SWEEP_SHAPE[2])])
    torch.cuda.synchronize()
    outs, walls = {}, {}
    tailconv.launches = 0
    for turn, b in enumerate(SWEEP_TURNS):
        out, rec = timed_sweep(model, path, b, step=step)
        want_k1 = 2 * -(-n_slabs // b)
        emit("sweep_flagship", turn=turn, dataset=list(SWEEP_SHAPE),
             step=step, k1_launches_expected=want_k1, nvidia_smi=smi,
             **rec)
        if rec["oom_fallbacks"]:                                 # (d)
            raise AssertionError(f"flagship sweep slab_batch={b}: "
                                 "fell back per slab (out of memory)")
        if rec["k1_launches"] != want_k1:                        # (e)
            raise AssertionError(f"flagship sweep slab_batch={b}: "
                                 f"{rec['k1_launches']} K1 launches, "
                                 f"expected {want_k1}")
        walls.setdefault(b, []).append(rec["seconds"])
        outs.setdefault(b, out)
        del out
    launches = tailconv.launches
    devs = {b: check_sweep_out(o, shape) for b, o in outs.items()}   # (c)
    b_err = sweep_max_diff(outs[1], outs[2])                         # (b)
    # (a) a step-sized block centred on the first slab seams (z 112, x 496,
    # y 496) against one predict_dense_device of the raw block plus its
    # halo
    fov = model.prediction_node.shape.fov
    lo = [(f - 1) // 2 for f in fov]
    hi = [f - 1 - a for f, a in zip(fov, lo)]
    blk = [(s // 2, s + s // 2) for s in step]
    raw = vol[tuple(slice(a - l, b + h) for (a, b), l, h in zip(blk, lo, hi))]
    ref = model.predict_dense_device(torch.from_numpy(
        raw[None].astype(np.float32) / 255.0).cuda())
    got = torch.from_numpy(np.ascontiguousarray(outs[1][
        (slice(None),) + tuple(slice(a, b) for a, b in blk)])).cuda()
    a_err = (got - ref).abs().max().item()
    del ref, got, raw
    prof = {b: profile_sweep(model, path, b, step=step) for b in (1, 2)}
    for b, p in prof.items():
        p["idle_share_of_timed_wall"] = (
            1.0 - p["kernel_ms"] / (np.mean(walls[b]) * 1e3))
    emit("sweep_flagship_checks", a_seams_vs_request_max_abs=a_err,
         b_batch2_vs_batch1_max_abs=b_err, c_channel_sum_dev=devs,
         d_oom_fallbacks=0, e_k1_launches=launches, tolerance=SLICE_ATOL,
         dataset_write_seconds=write_s, profile=prof, nvidia_smi=smi)
    if a_err > SLICE_ATOL or b_err > SLICE_ATOL:
        raise AssertionError(f"flagship sweep: seams vs request {a_err}, "
                             f"slab_batch 2 vs 1 {b_err} (> {SLICE_ATOL})")
    return launches + tune_flagship(smi, model, path, outs, walls)


def phase_sweep_unet(smi, tmp):
    """The wide U-Net (64/128/256) swept over a 256x512x512 uint8 dataset
    at step (128, 512, 512), 2 slabs, at slab_batch 1 and 2 (running out of
    memory at 2 is reported, not a failure: the sweep then restarts per
    slab, and check (b) compares the per-slab path with itself); checks
    (b), (c) and the first slab against one ``predict_dense_device`` of its
    staged slab on the cuDNN route (``ptail=False``), within
    ``CONVDENSE_ATOL``. Returns K1's launches in the timed sweeps."""
    rng = np.random.RandomState(SEED + 7)
    model = wide_unet_model()
    model.set_params(seeded_params(model, rng))
    model.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    path = os.path.join(tmp, "unet_raw")
    vol = write_dataset(path, UNET_SWEEP_SHAPE, SEED + 1)
    shape = (2,) + UNET_SWEEP_SHAPE
    step = list(UNET_SWEEP_STEP)
    model.sweep_knossos(KnossosArray(path), step=step,    # warm: one slab
                        region=[(0, s) for s in step])
    torch.cuda.synchronize()
    outs, oom = {}, False
    tailconv.launches = 0
    for b in (1, 2):
        out, rec = timed_sweep(model, path, b, step=step)
        oom = oom or bool(rec["oom_fallbacks"])
        emit("sweep_unet", dataset=list(UNET_SWEEP_SHAPE), step=step,
             out_of_memory_at_slab_batch=bool(rec["oom_fallbacks"]),
             nvidia_smi=smi, **rec)
        if b == 1 and rec["k1_launches"] != 8:
            raise AssertionError(f"U-Net sweep: {rec['k1_launches']} K1 "
                                 "launches, expected 4 per slab")
        outs[b] = out
        del out
    launches = tailconv.launches
    devs = {b: check_sweep_out(o, shape) for b, o in outs.items()}   # (c)
    b_err = sweep_max_diff(outs[1], outs[2])                         # (b)
    # the first slab (origin 0) as the sweep stages it: the M-aligned front
    # halo reflect-padded at the dataset's edge, the back halo read
    pred = model.prediction_node
    M = inference._valid_period(pred, 3)
    fov = pred.shape.fov
    lo = [-(-((f - 1) // 2) // m) * m for f, m in zip(fov, M)]
    hi = [f - 1 - (f - 1) // 2 for f in fov]
    delta = [a - (f - 1) // 2 for a, f in zip(lo, fov)]
    sub = vol[tuple(slice(0, min(s + h, n)) for s, h, n in
                    zip(step, hi, UNET_SWEEP_SHAPE))]
    slab = np.pad(sub, [(a, s + a + h - n - a) for a, s, h, n in
                        zip(lo, step, hi, sub.shape)], mode="reflect")
    model.set_convdense_impl(zfold=True, skipsum=True, ptail=False)
    k1 = tailconv.launches
    ref = model.predict_dense_device(torch.from_numpy(
        slab[None].astype(np.float32) / 255.0).cuda())
    if tailconv.launches != k1:
        raise AssertionError("U-Net cuDNN route launched K1")
    model.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    ref = ref[(slice(None),) + tuple(slice(d, d + s)
                                     for d, s in zip(delta, step))]
    got = torch.from_numpy(np.ascontiguousarray(outs[1][
        (slice(None),) + tuple(slice(0, s) for s in step)])).cuda()
    slab_err = (got - ref).abs().max().item()
    del ref, got
    prof = profile_sweep(model, path, 1, step=step)
    emit("sweep_unet_checks", b_batch2_vs_batch1_max_abs=b_err,
         b_compares_per_slab_with_itself=oom, c_channel_sum_dev=devs,
         first_slab_vs_cudnn_route_max_abs=slab_err,
         tolerance=dict(b=SLICE_ATOL, slab=CONVDENSE_ATOL),
         staged_slab=list(slab.shape), profile_slab_batch_1=prof,
         nvidia_smi=smi)
    if b_err > SLICE_ATOL or slab_err > CONVDENSE_ATOL:
        raise AssertionError(f"U-Net sweep: slab_batch 2 vs 1 {b_err}, "
                             f"first slab vs the cuDNN route {slab_err}")
    return launches


def phase_sweep_cli(smi, model, tmp):
    """``elektronn2_tpu_torch.scripts.predict.main`` over a 112x496x496
    KNOSSOS dataset (one slab, ``SWEEP_STEP``) with ``--ptail
    --knossos-out``: the uint8 maps read back
    must equal clip(sweep * 255) of the same dataset byte for byte. Where
    h5py does not import, the CLI's own two calls (``Model.sweep_knossos``,
    then ``save_knossos``) run in its place. Returns K1's launches."""
    kdir, kout = os.path.join(tmp, "cli_raw"), os.path.join(tmp, "cli_out")
    write_dataset(kdir, SWEEP_STEP, SEED + 2)
    mdl = os.path.join(tmp, "flagship.mdl")
    model.save(mdl)
    want = model.sweep_knossos(KnossosArray(kdir))
    u8 = np.clip(want * 255.0, 0, 255).astype(np.uint8)
    h5 = importlib.util.find_spec("h5py") is not None
    tailconv.launches = 0
    t0 = time.perf_counter()
    if h5:
        rc = predict.main([mdl, kdir, "--ptail", "--knossos-out", kout,
                           "-o", os.path.join(tmp, "prediction.h5")])
        if rc != 0:
            raise AssertionError(f"predict CLI exited with {rc}")
    else:
        m = modelload(mdl)
        m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
        out = m.sweep_knossos(KnossosArray(kdir), verbose=True)
        out = np.clip(out * 255.0, 0, 255).astype(np.uint8)
        for c in range(out.shape[0]):
            save_knossos(out[c], os.path.join(kout, f"c{c}"),
                         exp_name=f"pred_c{c}")
    dt = time.perf_counter() - t0
    launches = tailconv.launches
    equal = [bool(np.array_equal(
        KnossosArray(os.path.join(kout, f"c{c}"))[:, :, :], u8[c]))
        for c in range(u8.shape[0])]
    emit("sweep_cli", h5py=h5, ran="predict.main" if h5 else
         "h5py does not import: sweep_knossos + save_knossos in its place",
         dataset=list(SWEEP_STEP), seconds=dt, k1_launches=launches,
         maps_equal_sweep=equal, nvidia_smi=smi)
    if not all(equal):
        raise AssertionError("CLI KNOSSOS maps differ from the sweep's")
    if launches != 2:
        raise AssertionError(f"CLI: {launches} K1 launches, expected 2")
    return launches


# ------------------------------------------------------------------ MALIS

MALIS_PATCH = (16, 128, 128)            # input; output (14, 124, 124)
MALIS_STEPS = 10                        # eager trainingsteps, timed
MALIS_SMALL = (6, 20, 20)               # native core vs the numpy fallback
MALIS_GRAD_RTOL = 1e-5                  # rel L2, card vs float64 on the CPU


def malis3d_model(patch):
    """``examples/malis3d.py``'s ``create_model`` (its layers and widths:
    (1,3,3) 12, (3,3,3) 24, 1x1 3 sigmoid affinities, ``MalisNLL``), loaded
    as the train CLI loads the file, on an input of ``patch``, on the
    card."""
    from elektronn2_tpu_torch.config import ExperimentConfig
    cfg = ExperimentConfig.from_file(os.path.join("examples", "malis3d.py"))
    cfg.create_model.__globals__["PATCH"] = tuple(patch)
    return cfg.create_model().to("cuda")


def malis_volume(patch, out, rng):
    """Raw and labels as ``examples/malis3d.py::_synth_data`` makes them, at
    the input ``patch``: a seeded field smoothed by (2, 4, 4), the raw a
    noisy tanh of it, the labels ``ndimage.label`` of its positive part on
    the output's central crop ``out``."""
    from scipy import ndimage
    field = ndimage.gaussian_filter(rng.randn(*patch), (2, 4, 4))
    raw = (0.5 + 0.4 * np.tanh(field * 3) + 0.05 * rng.randn(*patch)
           ).clip(0, 1).astype(np.float32)
    crop = tuple(slice((p - o) // 2, (p - o) // 2 + o)
                 for p, o in zip(patch, out))
    seg, n = ndimage.label(field[crop] > 0)
    return raw[None, None], seg[None].astype(np.int32), n


class MalisSplit:
    """Times the stages of MALIS steps by wrapping the three host stages of
    ``malis.malis_weighted_nll``: CUDA events from the step's start to the
    prediction's copy (the forward) and from the weights' return to the
    step's end (the backward and the update); host clocks around the copy
    to the host (after a sync, so the forward is done), the pair counting
    and the copy back (synced). ``weights`` keeps the last weights sent."""

    def __init__(self):
        from elektronn2_tpu_torch import malis
        self.malis, self.rows, self.cur, self.weights = malis, [], None, None

    def patches(self):
        m = self.malis
        to_host, count, to_device = m._to_host, m.batch_weights, m._to_device

        def timed_to_host(tensors):
            self.cur["fwd_end"].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = to_host(tensors)
            self.cur["d2h_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def timed_count(*a, **kw):
            t0 = time.perf_counter()
            out = count(*a, **kw)
            self.cur["pairs_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def timed_to_device(w, like):
            t0 = time.perf_counter()
            out = to_device(w, like)
            torch.cuda.synchronize()
            self.cur["h2d_ms"] = (time.perf_counter() - t0) * 1e3
            self.cur["bwd_start"].record()
            self.weights = out
            return out
        return [(m, "_to_host", timed_to_host),
                (m, "batch_weights", timed_count),
                (m, "_to_device", timed_to_device)]

    def step(self, model, x, seg):
        """One timed ``trainingstep``; returns its loss."""
        self.cur = {k: torch.cuda.Event(enable_timing=True)
                    for k in ("start", "fwd_end", "bwd_start", "end")}
        self.cur["start"].record()
        t0 = time.perf_counter()
        loss, _ = model.trainingstep(x, seg)
        self.cur["end"].record()
        lv = float(loss)
        self.cur["wall_ms"] = (time.perf_counter() - t0) * 1e3
        ev = self.cur
        self.rows.append(dict(
            wall_ms=ev["wall_ms"],
            device_forward_ms=ev["start"].elapsed_time(ev["fwd_end"]),
            d2h_ms=ev["d2h_ms"], pairs_ms=ev["pairs_ms"],
            h2d_ms=ev["h2d_ms"],
            device_backward_ms=ev["bwd_start"].elapsed_time(ev["end"])))
        return lv


def malis_grad_vs_f64(model, x, seg, split):
    """The gradient of the MALIS loss (``AggregateLoss``'s mean of the
    ``MalisNLL`` map) in the prediction, on the card, against the same
    function in float64 on the CPU with the same pair weights: relative L2
    error."""
    from elektronn2_tpu_torch.malis import malis_weighted_nll
    node = model.nodes["malis"]
    pred = model.get_activations(x, ["aff"])["aff"].requires_grad_(True)
    malis_weighted_nll(pred, None, seg, node.nhood,
                       node.unrestrict_neg).mean().backward()
    w = split.weights.double().cpu()
    p64 = pred.detach().double().cpu().requires_grad_(True)
    eps = torch.tensor(1e-10, dtype=torch.float64)
    nll = -(w[0] * torch.log(torch.maximum(p64, eps))
            + w[1] * torch.log(torch.maximum(1.0 - p64, eps)))
    nll.sum(dim=1).mean().backward()
    g, g64 = pred.grad.double().cpu(), p64.grad
    return ((g - g64).norm() / g64.norm()).item()


def phase_malis(smi):
    """MALIS on the card. The native pair-counting core must be the one
    taken (``HAVE_NATIVE``) and equal the numpy fallback at a small size,
    both passes. Then ``examples/malis3d.py``'s net at its own widths on a
    (1, 1, 16, 128, 128) input, a (14, 124, 124) output (215k voxels, 646k
    edges), labels made as the example makes them: ``MALIS_STEPS`` eager
    ``trainingstep`` calls after one warm-up, under ``torch.profiler``,
    each split into the device forward, the prediction's copy to the host,
    the host pair counting, the weights' copy back and the device backward
    with the update (``MalisSplit``); the device's idle share over the
    steps; the loss first and last (finite); the loss's gradient in the
    prediction against float64 (``MALIS_GRAD_RTOL``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from elektronn2_tpu_torch import malis
    if not malis.HAVE_NATIVE or malis._malis_cpp is None:
        raise AssertionError("malis: the native pair-counting core did not "
                             "build")
    rng = np.random.RandomState(SEED + 30)
    _, seg_s, _ = malis_volume(MALIS_SMALL, MALIS_SMALL, rng)
    nh = malis.mknhood3d(1)
    aff_s = rng.rand(len(nh), *MALIS_SMALL).astype(np.float32)
    native_equal = all(np.array_equal(
        malis._malis_cpp.malis_pass(aff_s, seg_s[0], nh, pos),
        malis._malis_pass_np(aff_s, seg_s[0], nh, pos)) for pos in (1, 0))
    model = malis3d_model(MALIS_PATCH)
    out = tuple(model.prediction_node.shape.spatial_shape)
    raw, seg, n_seg = malis_volume(MALIS_PATCH, out, rng)
    x, t = torch.from_numpy(raw).cuda(), torch.from_numpy(seg).cuda()
    model.set_opt("Adam", lr=1e-3)
    split = MalisSplit()
    saved = [(o, a, getattr(o, a)) for o, a, _ in split.patches()]
    for o, a, f in split.patches():
        setattr(o, a, f)
    try:
        split.step(model, x, t)                      # warm-up
        split.rows.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses = [split.step(model, x, t) for _ in range(MALIS_STEPS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        grad_err = malis_grad_vs_f64(model, x, t, split)
    finally:
        for o, a, f in saved:
            setattr(o, a, f)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    mean = {k: float(np.mean([r[k] for r in split.rows]))
            for k in split.rows[0]}
    edges = sum(int(np.prod([s - abs(int(o)) for s, o in zip(out, off)]))
                for off in model.nodes["malis"].nhood)
    emit("malis", config="examples/malis3d.py", patch_in=list(MALIS_PATCH),
         out=list(out), voxels=int(np.prod(out)), edges=edges,
         segments=n_seg, steps=MALIS_STEPS, have_native=malis.HAVE_NATIVE,
         native_equals_fallback=native_equal, ms_per_step=mean["wall_ms"],
         split_ms=mean, pairs_share=mean["pairs_ms"] / mean["wall_ms"],
         idle_share=1.0 - busy_ms / (wall * 1e3), device_busy_ms=busy_ms,
         profiled_wall_ms=wall * 1e3, loss_first=losses[0],
         loss_last=losses[-1], grad_rel_l2_vs_f64=grad_err,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         nvidia_smi=smi)
    if not native_equal:
        raise AssertionError("malis: the native core differs from the numpy "
                             "fallback")
    if not np.isfinite(losses).all():
        raise AssertionError(f"malis: non-finite losses {losses}")
    if not grad_err <= MALIS_GRAD_RTOL:
        raise AssertionError(f"malis: gradient rel L2 {grad_err} vs float64 "
                             f"> {MALIS_GRAD_RTOL}")
    del model, x, t
    torch.cuda.empty_cache()


# ------------------------------------------ reduced-precision matmuls

RM_MODES = (None, "bfloat16", "float16", None)   # float32 in turns
RM_CHUNK = 16                           # mlp_mnist: steps a graphed chunk
RM_TIMED = 3                            # chunks timed after the capture
RM_VOL = (1, 128, 128, 128)             # the tracer phase's volume
RM_ROLLOUT_B, RM_ROLLOUT_K = 256, 64


def timed_chunks(loop, n):
    """``n`` chunks of ``loop`` after the one that captured: it/s and the
    last chunk's losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        losses, _ = loop.run_chunk()
    return n * loop.n_inner / (time.perf_counter() - t0), losses


def recaptures(loop, model, mode):
    """Set ``mode`` on ``model``, run one chunk of ``loop``: whether it ran
    on a new graph (a capture) and that chunk's losses."""
    before = loop._graph
    model.set_compute_dtype(mode)
    losses, _ = loop.run_chunk()
    return loop._graph is not before, losses


def agent_data(vol):
    """``AgentData`` over ``vol`` with ``examples/tracing3d.py``'s helix, its
    stream seeded from ``SEED``."""
    from elektronn2_tpu_torch.data import AgentData
    ad = AgentData(input_data=[vol], target_data=[
        (vol[0] > 0.5).astype(np.int16)])
    ad.set_geometry(TRACE_PATCH)
    ad.skeletons = [helix_skeleton(vol.shape[1:])]
    ad.rng = np.random.RandomState(SEED)
    return ad


def tracer_trainer(vol, weights, mode, tmp):
    """``TracingTrainerRNN`` with fused chunks of ``TT_K`` on the tracing
    deployment's model (16^3, 64/64) from ``weights`` under ``mode``, run
    for one chunk on seeded batches. Its data source keeps serving tracing
    batches to the loop's later chunks (``TracingTrainer.run`` does so only
    while it runs)."""
    from elektronn2_tpu_torch.training.trainer import TracingTrainerRNN
    m = tracer_model(TRACE_PATCH, batch=TT_B, t=TT_T)
    m.set_params(weights)
    m.set_compute_dtype(mode)
    ad = agent_data(vol)
    ad.getbatch = lambda bs, **kw: ad.get_tracing_batch(bs, n_steps=TT_T)
    tr = TracingTrainerRNN(model=m, data=ad, n_scan_steps=TT_T,
                           batch_size=TT_B, fused_steps=TT_K, n_steps=TT_K,
                           n_workers=0, history_freq=0, save_freq=0,
                           save_path=tmp, optimiser="Adam",
                           optimiser_params={"lr": 1e-3})
    tr.run()
    return tr


def phase_reduced_matmuls(smi):
    """Perceptron, GRU and LSTM matmuls under ``set_compute_dtype``. (a)
    ``examples/mlp_mnist.py``'s net (loaded as the train CLI loads it) in
    ``HostFedFusedLoop`` chunks of ``RM_CHUNK`` on its synthetic digits
    under float32, bf16, float16 and float32 again: each mode's first
    chunk must recapture the graph, then ``RM_TIMED`` chunks are timed
    (it/s), losses finite. (b) The bench's tracer model (16^3, Perceptron
    64 -> GRU 64 -> 3-vector) in ``TracingTrainerRNN`` fused chunks from
    the same weights on the same seeded batches, float32 and bf16: the first chunk's losses'
    max deviation, then ``RM_TIMED`` more chunks each, twice, in turns
    (it/s); the GRU scan's
    output on one batch, bf16 against float32; the bf16 trainer's chunk
    graph recaptures when the dtype goes back to float32, and again when it
    returns to bf16. (c) ``DeviceTracer`` rollouts of that model set to
    bf16, the float32 rollout's graph replayed (its key unchanged) and a
    new tracer's own capture, are bit for bit the float32 rollout."""
    from elektronn2_tpu_torch.config import ExperimentConfig
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    cfg = ExperimentConfig.from_file(os.path.join("examples",
                                                  "mlp_mnist.py"))
    model = cfg.create_model().to("cuda")
    model.set_opt("Adam", lr=1e-3)
    loop = HostFedFusedLoop(model, cfg.data_instance, cfg.batch_size,
                            RM_CHUNK, seed=SEED)
    try:
        for mode in RM_MODES:
            new_graph, first = recaptures(loop, model, mode)
            it_s, last = timed_chunks(loop, RM_TIMED)
            emit("reduced_matmuls_mlp", config="examples/mlp_mnist.py",
                 dtype=mode or "float32", batch=cfg.batch_size,
                 chunk=RM_CHUNK, recaptured=new_graph,
                 capture_seconds=loop.capture_seconds, it_s=it_s,
                 loss_first=float(first[0]), loss_last=float(last[-1]),
                 nvidia_smi=smi)
            if not new_graph:
                raise AssertionError(f"reduced_matmuls: mlp_mnist under "
                                     f"{mode} replayed the old graph")
            if not (np.isfinite(first).all() and np.isfinite(last).all()):
                raise AssertionError(f"reduced_matmuls: mlp_mnist under "
                                     f"{mode}: non-finite losses")
    finally:
        loop.close()
    model.set_compute_dtype(None)
    del loop, model

    rng = np.random.RandomState(SEED + 40)
    vol = rng.rand(*RM_VOL).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        weights = seeded_tracer_params(
            tracer_model(TRACE_PATCH, batch=TT_B, t=TT_T), rng)
        trs = {mode: tracer_trainer(vol, weights, mode, tmp)
               for mode in (None, "bfloat16")}
        first = {k: tr.history.timeline.data[:, 2].copy()
                 for k, tr in trs.items()}
        rates = {k: [] for k in trs}
        for k in (None, "bfloat16", "bfloat16", None):       # in turns
            rates[k].append(timed_chunks(trs[k].fused_loop, RM_TIMED)[0])
        tb = trs["bfloat16"]
        back, _ = recaptures(tb.fused_loop, tb.model, None)
        again, _ = recaptures(tb.fused_loop, tb.model, "bfloat16")
        probe = tracer_model(TRACE_PATCH, batch=TT_B, t=TT_T)
        probe.set_params(weights)
        d, _ = agent_data(vol).get_tracing_batch(TT_B, n_steps=TT_T)
        d = torch.from_numpy(d).cuda()
        scan32 = probe.get_activations(d, ["scan"])["scan"]
        probe.set_compute_dtype("bfloat16")
        scan16 = probe.get_activations(d, ["scan"])["scan"]
        probe.set_compute_dtype(None)
        tracer = make_tracer(probe, torch.from_numpy(vol).cuda(),
                             max_steps=RM_ROLLOUT_K)
        seeds = rng.uniform(20, RM_VOL[1] - 20, (RM_ROLLOUT_B, 3))
        key = tracer.graph_key(probe.params, RM_ROLLOUT_B)
        ref = tracer.trace_batch(seeds)
        probe.set_compute_dtype("bfloat16")
        same_key = tracer.graph_key(probe.params, RM_ROLLOUT_B) == key
        got = tracer.trace_batch(seeds)         # a replay of ref's graph
        fresh = make_tracer(probe, torch.from_numpy(vol).cuda(),
                            max_steps=RM_ROLLOUT_K).trace_batch(seeds)
        rollout_equal = all(np.array_equal(a.coords, b.coords)
                            and np.array_equal(c.coords, b.coords)
                            for a, c, b in zip(got, fresh, ref))
        loss_dev = float(np.abs(first["bfloat16"] - first[None]).max())
        emit("reduced_matmuls_tracer", model="tracer_model",
             patch=list(TRACE_PATCH), batch=TT_B, scan_steps=TT_T,
             fused_steps=TT_K, it_s_float32=rates[None],
             it_s_bfloat16=rates["bfloat16"],
             capture_seconds_bfloat16=tb.fused_loop.capture_seconds,
             loss_first_float32=float(first[None][0]),
             loss_max_abs_dev=loss_dev,
             gru_out_max_abs_dev=(scan16 - scan32).abs().max().item(),
             gru_out_max_abs=scan32.abs().max().item(),
             recaptured_to_float32=back, recaptured_to_bfloat16=again,
             rollout_agents=RM_ROLLOUT_B, rollout_steps=RM_ROLLOUT_K,
             rollout_bit_equal=rollout_equal, rollout_same_key=same_key,
             nvidia_smi=smi)
        if not (back and again):
            raise AssertionError("reduced_matmuls: the tracer's chunk graph "
                                 "did not recapture on a dtype change")
        if not all(np.isfinite(v).all() for v in first.values()):
            raise AssertionError("reduced_matmuls: non-finite tracer loss")
        if torch.equal(scan16, scan32):
            raise AssertionError("reduced_matmuls: bf16 did not reach the "
                                 "GRU's matmuls")
        if not (rollout_equal and same_key):
            raise AssertionError("reduced_matmuls: the bf16-set model's "
                                 "rollout is not its float32 rollout")
        del trs, tb, probe, tracer
    torch.cuda.empty_cache()


# ------------------------------------------- reduced-precision serving

QUANT_F64_PLANES = 4                    # output planes held against float64
QUANT_CASES = [  # name, x shape, weight shape, conv kwargs, upconv
    # the flagship's conv2 and conv3 of one 120x496x496 request (pad_raw)
    ("flagship_conv2", (1, 30, 124, 512, 512), (40, 30, 3, 3, 3),
     dict(dilation=(1, 4, 4)), False),
    ("flagship_conv3", (1, 40, 122, 504, 504), (40, 40, 3, 3, 3),
     dict(dilation=(1, 4, 4)), False),
    # the wide U-Net's widest (3,3,3) conv (d1, 256 -> 128) and its UpConv
    # u0 (128 -> 64, (1,2,2)) at one 128x448x448 slab
    ("unet_d1", (1, 256, 130, 230, 230), (128, 256, 3, 3, 3), {}, False),
    ("unet_u0", (1, 128, 128, 228, 228), (64, 128, 1, 2, 2),
     dict(pool_shape=(1, 2, 2)), True),
]
#: argmax agreement floors of the lossy modes against the float32 route
#: (tests/test_inference_device.py:590-620, :880-925)
ARGMAX_FLOOR = {"bfloat16": 0.95, "int8": 0.97}
SERVE_MODES = [  # name, dtype, activations, calibrated, K1
    ("float32", None, False, False, False),
    ("k1", None, False, False, True),
    ("bf16", "bfloat16", False, False, False),
    ("bf16_act", "bfloat16", True, False, False),
    ("int8", "int8", False, False, False),
    ("int8_act", "int8", True, False, False),
    ("int8_calibrated", "int8", False, True, False),
]
UNET_SERVE_MODES = [("k1", None, False, False, True),
                    ("bf16", "bfloat16", False, False, False),
                    ("int8", "int8", False, False, False)]
UNET_TUNE_STEP = (128, 448, 448)


def int8_operands(x, w):
    """The int8 values and the dequantising scale ``quantized_conv`` uses,
    computed here on their own (per-output-channel weight scales, one
    activation scale, half-to-even rounding, +-127)."""
    c = torch.full((), 127.0, device=x.device)
    s_x = torch.clamp(x.abs().max(), min=1e-12) / c
    red = tuple(range(1, w.ndim))
    s_w = torch.clamp(w.abs().amax(dim=red), min=1e-12) / c
    xq = torch.clamp(torch.round(x / s_x), -127, 127)
    wq = torch.clamp(torch.round(w / s_w.reshape((-1,) + (1,) * (w.ndim - 1))),
                     -127, 127)
    return xq, wq, (s_x * s_w).reshape((1, -1) + (1,) * (x.ndim - 2))


def quant_f64_equal(x, w, got, kw, up):
    """Whether ``got`` (quantized_conv's output) equals, on its first
    ``QUANT_F64_PLANES`` z-planes bit for bit, the float64 conv of the same
    int8 values times the scale; and the largest integer sum there."""
    F = torch.nn.functional
    xq, wq, scale = int8_operands(x, w)
    if up:
        xs = xq[:, :, :QUANT_F64_PLANES].double()
        sums = F.conv_transpose3d(xs, wq.transpose(0, 1).double(),
                                  stride=kw["pool_shape"])
    else:
        xs = xq[:, :, :QUANT_F64_PLANES + w.shape[2] - 1].double()
        sums = F.conv3d(xs, wq.double(), **kw)
    del xq, xs
    want = sums.float() * scale
    n = want.shape[2]
    return (bool(torch.equal(got[:, :, :n], want)),
            bool(torch.equal(sums, torch.round(sums))),
            sums.abs().max().item())


def phase_quant_conv(smi):
    """``ops.conv.quantized_conv`` at the main paths' shapes (the
    flagship's conv2 and conv3, the wide U-Net's widest conv and its
    UpConv): random operands and an adversarial case (every operand +-127,
    signs aligned), each held against a float64 conv of the same int8
    values bit for bit on ``QUANT_F64_PLANES`` output planes, and timed in
    turns against ``F.conv3d`` (``F.conv_transpose3d`` for the UpConv) in
    float32 and bf16 on the same inputs."""
    from elektronn2_tpu_torch.ops.conv import (EXACT_INT8_TERMS,
                                               quantized_conv, upconv)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for name, xs, ws, kw, up in QUANT_CASES:
        taps = 1 if up else int(np.prod(ws[2:]))
        groups = -(-ws[1] // (EXACT_INT8_TERMS // taps))
        for case in ("random", "worst"):
            if case == "random":
                x = torch.rand(xs, device="cuda", generator=g) - 0.5
                w = torch.randn(ws, device="cuda", generator=g)
            else:
                x = torch.ones(xs, device="cuda")
                w = torch.ones(ws, device="cuda")
                x[:, ::2] = -1.0
                w[:, ::2] = -1.0
            kwq = dict(kw, conv_fn=upconv) if up else kw
            got = quantized_conv(x, w, **kwq)
            exact, integral, top = quant_f64_equal(x, w, got, kw, up)
            rec = dict(case=name, operands=case, x=list(xs), w=list(ws),
                       channel_groups=groups, f64_bit_equal=exact,
                       f64_sums_integral=integral, largest_sum=top,
                       past_2_24=top > 2 ** 24)
            if case == "random":
                xb, wb = x.bfloat16(), w.bfloat16()
                if up:
                    fns = [lambda: quantized_conv(x, w, **kwq),
                           lambda: F.conv_transpose3d(
                               x, w.transpose(0, 1), stride=kw["pool_shape"]),
                           lambda: F.conv_transpose3d(
                               xb, wb.transpose(0, 1),
                               stride=kw["pool_shape"])]
                else:
                    fns = [lambda: quantized_conv(x, w, **kwq),
                           lambda: F.conv3d(x, w, **kw),
                           lambda: F.conv3d(xb, wb, **kw)]
                with f32_convs():
                    ref = fns[1]()
                    qerr = (got - ref).abs().max().item()
                    scale = ref.abs().max().item()
                    del ref
                    ms, f32_ms, bf16_ms = palindrome_ms(fns, 1)
                del xb, wb
                rec.update(ms=ms, f32_conv_ms=f32_ms, bf16_conv_ms=bf16_ms,
                           quantisation_max_abs=qerr, f32_max_abs=scale)
            emit("quant_conv", nvidia_smi=smi, **rec)
            if not (exact and integral):
                raise AssertionError(f"quantized_conv {name} ({case}): not "
                                     "equal to the float64 integer sums")
            del x, w, got
            torch.cuda.empty_cache()


def serve_mode(model, vol, mode, convdense):
    """Apply one serving mode ``(name, dtype, activations, calibrated, K1)``
    to ``model``; the calibrated mode calibrates on ``vol``."""
    name, dtype, act, calibrated, k1 = mode
    model.set_compute_dtype(None)
    if convdense:
        model.set_convdense_impl(zfold=True, skipsum=True, ptail=k1)
    else:
        model.set_dilated_impl("direct", zfold=True, pallas_tail=k1)
    model.set_compute_dtype(dtype, activations=act)
    if calibrated:
        model.calibrate_int8(vol)


def deviation(out, ref):
    """(max abs, 99.9th percentile of abs, argmax agreement) of ``out``
    against ``ref`` ((f, ...) maps on the card)."""
    d = (out - ref).abs().flatten()
    k = max(1, int(np.ceil(d.numel() * 1e-3)))
    p999 = torch.topk(d, k).values.min().item()
    agree = (out.argmax(0) == ref.argmax(0)).float().mean().item()
    return d.max().item(), p999, agree


def serve_modes(smi, model, vol, modes, convdense, what):
    """One warm request of ``vol`` under each serving mode: ms, Mvox/s,
    peak GiB, deviation from the float32 route (the first mode), K1's
    launches (2 on the flagship's K1 mode, 4 on the U-Net's, 0 on every
    other); every map finite, each lossy mode at its argmax floor. Returns
    K1's launches in the K1 modes."""
    mvox = np.prod(vol.shape[1:]) / 1e6
    ref, launches = None, 0
    for mode in modes:
        serve_mode(model, vol, mode, convdense)
        model.predict_dense_device(vol, pad_raw=True)           # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = tailconv.launches
        t0 = time.perf_counter()
        out = model.predict_dense_device(vol, pad_raw=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1 = tailconv.launches - before
        rec = dict(model=what, mode=mode[0], dtype=mode[1],
                   activations=mode[2], calibrated=mode[3], seconds=dt,
                   ms=dt * 1e3, mvox_s=mvox / dt, k1_launches=k1,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   finite=bool(torch.isfinite(out).all()),
                   out=list(out.shape), nvidia_smi=smi)
        want_k1 = (4 if convdense else 2) if mode[4] else 0
        if ref is None:
            ref = out
            rec["reference"] = True
        else:
            mx, p999, agree = deviation(out, ref)
            rec.update(max_abs_dev=mx, p999_abs_dev=p999,
                       argmax_agreement=agree,
                       argmax_floor=ARGMAX_FLOOR.get(mode[1]))
        emit("serve_dtypes", **rec)
        if not rec["finite"]:
            raise AssertionError(f"{what} {mode[0]}: non-finite output")
        if k1 != want_k1:
            raise AssertionError(f"{what} {mode[0]}: {k1} K1 launches, "
                                 f"expected {want_k1}")
        floor = ARGMAX_FLOOR.get(mode[1])
        if floor is not None and not rec["argmax_agreement"] > floor:
            raise AssertionError(f"{what} {mode[0]}: argmax agreement "
                                 f"{rec['argmax_agreement']} <= {floor}")
        if mode[4]:
            launches += k1
        del out
    del ref
    model.set_compute_dtype(None)
    torch.cuda.empty_cache()
    return launches


def phase_serve_dtypes(smi):
    """Every serving mode of a warm 120x496x496 flagship request (float32
    cuDNN, K1, bf16, bf16 stored, int8, int8 stored, int8 calibrated) and
    of a 128x448x448 wide U-Net slab (K1, bf16, int8), each against the
    float32 route. Returns K1's launches in the K1 modes."""
    rng = np.random.RandomState(SEED)
    model = flagship_model(mfp=True, patch=[23, 103, 103])
    model.set_params(seeded_params(model, rng))
    vol = torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
    tailconv.launches = 0
    launches = serve_modes(smi, model, vol, SERVE_MODES, False, "flagship")
    del model, vol
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 7)
    model = wide_unet_model()
    model.set_params(seeded_params(model, rng))
    vol = torch.from_numpy(rng.rand(*SLAB_SHAPE).astype(np.float32)).cuda()
    launches += serve_modes(smi, model, vol, UNET_SERVE_MODES, True,
                            "wide_unet")
    del model, vol
    torch.cuda.empty_cache()
    return launches


def tune_rows(smi, what, res, seconds):
    for row in res["table"]:
        emit(f"tune_{what}_row", nvidia_smi=smi, **row)
    emit(f"tune_{what}", best=res["best"], rows=len(res["table"]),
         seconds=seconds, nvidia_smi=smi)
    if res["best"] is None:
        raise AssertionError(f"tune {what}: no contender ran")


def tune_flagship(smi, model, path, outs, walls):
    """``Model.tune_serving(apply=True)`` on the sweep's flagship (every
    contender, ``DEFAULT_TUNE_STEPS_3D`` clamped to the dataset, slab
    batches 1 and 2, K=4), its table one line a row; then the sweep with
    the winner's step and slab batch, timed beside the default sweep's, its
    output held to the default sweep's (1e-5 for a float32 winner, the
    argmax floor of a lossy one). Returns K1's launches in the tune and the
    tuned sweep; the K1 route is put back."""
    steps = [tuple(min(v, r) for v, r in zip(s, SWEEP_SHAPE))
             for s in inference.DEFAULT_TUNE_STEPS_3D]
    before = tailconv.launches
    t0 = time.perf_counter()
    res = model.tune_serving(steps=steps, slab_batches=(1, 2), K=4,
                             apply=True, verbose=False)
    tune_rows(smi, "flagship", res, time.perf_counter() - t0)
    best = res["best"]
    out, rec = timed_sweep(model, path, best["slab_batch"],
                           step=list(best["step"]))
    ref = torch.from_numpy(outs[1]).cuda()
    got = torch.from_numpy(out).cuda()
    del out
    mx, p999, agree = deviation(got, ref)
    emit("tune_flagship_sweep", best=best, dataset=list(SWEEP_SHAPE),
         default_step=list(SWEEP_STEP),
         default_mvox_s={b: float(np.prod(SWEEP_SHAPE)) / 1e6 / np.mean(w)
                         for b, w in walls.items()}, max_abs_vs_default=mx,
         p999_abs_vs_default=p999, argmax_agreement=agree,
         nvidia_smi=smi, **rec)
    del ref, got
    if best["dtype"] is None and mx > SLICE_ATOL:
        raise AssertionError(f"tuned float32 sweep vs default: {mx}")
    floor = ARGMAX_FLOOR.get(best["dtype"])
    if floor is not None and not agree > floor:
        raise AssertionError(f"tuned {best['dtype']} sweep: argmax "
                             f"agreement {agree} <= {floor}")
    model.set_compute_dtype(None)
    model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    torch.cuda.empty_cache()
    return tailconv.launches - before


def tune_unet(smi):
    """The wide U-Net's six conv-dense contenders at one (128, 448, 448)
    slab, slab batch 1, K=2 (dilate against d2s for its transposed convs),
    every contender with ``skipsum``. Returns K1's launches."""
    rng = np.random.RandomState(SEED + 7)
    model = wide_unet_model()
    model.set_params(seeded_params(model, rng))
    model.set_convdense_impl(skipsum=True)
    before = tailconv.launches
    t0 = time.perf_counter()
    res = model.tune_serving(steps=[UNET_TUNE_STEP], slab_batches=(1,), K=2,
                             apply=False, verbose=False)
    tune_rows(smi, "unet", res, time.perf_counter() - t0)
    if len(res["table"]) != 6:
        raise AssertionError(f"tune unet: {len(res['table'])} rows, not 6")
    del model
    torch.cuda.empty_cache()
    return tailconv.launches - before


def cli_maps(kout, n=2):
    return [KnossosArray(os.path.join(kout, f"c{c}"))[:, :, :]
            for c in range(n)]


def phase_cli_modes(smi, mdl, kdir, tmp):
    """The predict CLI with ``--tune``, ``--int8`` and ``--bf16`` over the
    ``sweep_cli`` dataset (``-o ''``: no HDF5 file; the maps through
    ``--knossos-out``): each CLI's uint8 maps equal clip(255 x) of the API's
    sweep under the same settings (for ``--tune``, the winner the CLI's own
    tune picked, recorded), byte for byte; then ``elektronn2-torch-profile``
    on the flagship at two sizes. Returns K1's launches in the CLIs."""
    from elektronn2_tpu_torch.neuromancer.model import Model
    from elektronn2_tpu_torch.scripts import profile
    picked, tune = {}, Model.tune_serving

    def recording(self, *a, **kw):
        res = tune(self, *a, **kw)
        picked.update(res["best"] or {})
        return res
    launches = 0
    for flag in ("--tune", "--int8", "--bf16"):
        kout = os.path.join(tmp, f"cli{flag[2:]}")
        picked.clear()
        before = tailconv.launches
        Model.tune_serving = recording
        try:
            t0 = time.perf_counter()
            rc = predict.main([mdl, kdir, flag, "-o", "",
                               "--knossos-out", kout])
            dt = time.perf_counter() - t0
        finally:
            Model.tune_serving = tune
        launches += tailconv.launches - before
        if rc != 0:
            raise AssertionError(f"predict CLI {flag} exited with {rc}")
        m = modelload(mdl)
        step, sb = None, 1
        if flag == "--tune":
            m.set_dilated_impl(picked["impl"], zfold=picked["zfold"],
                               pallas_tail=picked["ptail"])
            m.set_compute_dtype(picked["dtype"], activations=picked["act"])
            step, sb = list(picked["step"]), picked["slab_batch"]
        else:
            m.set_compute_dtype("int8" if flag == "--int8" else "bfloat16")
        before = tailconv.launches
        api = m.sweep_knossos(KnossosArray(kdir), step=step, slab_batch=sb)
        launches += tailconv.launches - before
        u8 = np.clip(api * 255.0, 0, 255).astype(np.uint8)
        equal = [bool(np.array_equal(g, u8[c]))
                 for c, g in enumerate(cli_maps(kout, u8.shape[0]))]
        emit("cli_modes", flag=flag, seconds=dt, picked=dict(picked) or None,
             maps_equal_api=equal, nvidia_smi=smi)
        if not all(equal):
            raise AssertionError(f"CLI {flag}: maps differ from the API's")
        del m
    torch.cuda.empty_cache()
    csv_path = os.path.join(tmp, "profile.csv")
    t0 = time.perf_counter()
    rc = profile.main([mdl, "--sizes", "55,103", "--out", csv_path])
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    emit("cli_profile", rc=rc, seconds=time.perf_counter() - t0, csv=rows,
         nvidia_smi=smi)
    if rc != 0 or len(rows) != 3:
        raise AssertionError(f"profile CLI: rc {rc}, {len(rows)} lines")
    return launches


def phase_sweep(smi):
    """The dense-serving deployment: KNOSSOS datasets written into a
    temporary directory (removed after the phase) and swept, the flagship
    (``phase_sweep_flagship``, the main measurement), the wide U-Net and
    the predict CLI. Returns K1's launches in the sweeps and the CLI."""
    rng = np.random.RandomState(SEED)
    model = flagship_model(mfp=True, patch=[23, 103, 103])
    model.set_params(seeded_params(model, rng))
    model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_sweep_flagship(smi, model, tmp)
        launches += phase_sweep_cli(smi, model, tmp)
        del model
        torch.cuda.empty_cache()
        launches += phase_cli_modes(smi, os.path.join(tmp, "flagship.mdl"),
                                    os.path.join(tmp, "cli_raw"), tmp)
        launches += phase_sweep_unet(smi, tmp)
    torch.cuda.empty_cache()
    launches += tune_unet(smi)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    k1 = phase_kernel()
    k4 = phase_kernel_k4()
    k2 = phase_kernel_k2()
    k3 = phase_kernel_k3()
    k5 = phase_kernel_k5()
    k1_launches = phase_slice()
    k4_launches, k1_chain = phase_head_chain()
    k1_launches += k1_chain + phase_convdense()
    raw = phase_trace(rotate=False)
    raw_rot = phase_trace(rotate=True)
    prelu = phase_trace(rotate=False, prelu_w=TN_PRELU_W)   # tracing_nodes
    k2_launches = raw["launches"] + prelu["launches"]
    k3_launches = raw_rot["launches"]
    phase_trace_kzip()
    k3b = phase_kernel_k3_bf16()
    k2_launches += phase_trace_pool(raw)
    k3_pool, k3b_launches = phase_trace_rot_pool(raw_rot)
    k3_launches += k3_pool
    phase_tune_batch()
    k2_launches += phase_registry_pool()
    phase_headk_probe()
    k5_launches = phase_k5_main()
    p1_launches, p1 = phase_probe_dot()
    p2_launches, p2 = phase_probe_ablate()
    k1_launches += phase_train(smi)
    phase_train_bn(smi)
    k1_launches += phase_train_lowering(smi)
    k1_launches += phase_train_cli(smi)
    k2_launches += phase_train_tracing(smi)
    phase_tracing_nodes(smi)
    phase_malis(smi)
    phase_reduced_matmuls(smi)
    k1_launches += phase_train_dp(smi)
    phase_quant_conv(smi)
    k1_launches += phase_serve_dtypes(smi)
    k1_launches += phase_sweep(smi)
    emit("wall", seconds=time.perf_counter() - t0)
    rows = [("conv3x3_dilated", "tailconv.cu",
             "elektronn2_tpu/ops/pallas_tailconv.py:318", k1_launches, k1),
            ("conv1x3x3_pool_dilated", "headconv.cu",
             "elektronn2_tpu/ops/pallas_tailconv.py:547", k4_launches, k4),
            ("trilinear_patches", "extract.cu",
             "elektronn2_tpu/ops/pallas_extract.py:75", k2_launches, k2),
            ("rotated_patches", "extract_rot.cu",
             "elektronn2_tpu/ops/pallas_extract_rot.py:106", k3_launches, k3),
            ("rotated_patches_bf16", "extract_rot.cu",
             "elektronn2_tpu/ops/pallas_extract_rot.py:106", k3b_launches,
             k3b),
            ("dilated_conv", "dilated_conv.cu",
             "elektronn2_tpu/ops/experimental/pallas_dilated_conv.py:69",
             k5_launches, k5),
            ("ptail_dot", "ptail_dot.cu", "scripts/exp_ptail_dot.py:26",
             p1_launches, p1),
            ("ptail_ablate", "ptail_ablate.cu",
             "scripts/exp_ptail_ablate.py:72", p2_launches, p2)]
    for n, _, _, launches, _ in rows:
        if launches < 1:
            raise AssertionError(f"{n}: no launch on its main path")
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda",
        "source": f"elektronn2_tpu_torch/csrc/{src}", "replaces": rep,
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": pms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib}
        for n, src, rep, launches, (err, ms, pms, bound, by, lib) in rows]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
