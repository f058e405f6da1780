#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: ResNet-50
serving and training, LSTM-PTB training, SSD-VGG16 serving and training,
DCGAN training, the repository's BASELINE training scripts, and training
windows.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

1. device — the card's name and power limit (``nvidia-smi``) and
   ``torch.cuda.get_device_name(0)``;
2. build — every CUDA kernel of the path, from ``mxnet_tpu_torch/csrc``,
   with the build seconds and the compiler's register report;
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (stated tolerances), with CUDA-event
   times of the kernel, the plain version and one PyTorch library call for
   the same function, beside the bound (the least time the card could take);
4. serving — ResNet-50 at full width (224x224, 1000 classes, float32,
   random He-normal weights from a fixed seed) behind
   ``ModelServer(ServingConfig(buckets=(1, 8, 32), fold_bn=True))``:
   41 single-image requests in waves of 32, 8 and 1, every answer checked
   against the port's own CPU ``Predictor`` (plain versions of the
   kernels), and the launch counters checked at 17 ``bn_act`` and 1
   ``softmax_rows`` per served batch; then the time per batch and the
   images per second at bucket 32, through the server and for the forward
   alone, and a ``torch.profiler`` breakdown of one forward by kernel;
5. training kernels — ``bn_stats``, ``bn_act``, the training forward
   (``bn_stats`` + ``bn_act``), ``bn_act_bwd``, ``softmax_output_bwd`` and
   ``sgd_mom_multi`` against their plain versions at the shapes one
   ResNet-50 training step gives them at batch 32 (50 BatchNorm inputs,
   the (32, 1000) loss layer, 155 parameters) and at odd ones (H*W = 49,
   C not a multiple of 4, N not a multiple of 8, ``fix_gamma``,
   ``use_ignore``, a NaN gradient under the guard), with CUDA-event times
   of the kernel, the plain version and the PyTorch library call for the
   same function, beside the bound;
5b. redesigned kernels — ``bn_act_bwd`` at every border of its regimes
   (``bn_bwd_borders``: each side of the block limit, of a cluster of
   ``BLOCK_TARGET`` blocks and of what a cluster holds, planes of 49 and
   16, C = 3, N = 1, a cluster over images, and views at a float offset of
   1 and 3) for no activation, the ReLU and the leaky ReLU, with and
   without batch statistics and ``fix_gamma`` (``DX_RTOL``/``DX_ATOL``),
   each call's launches as planned and two calls bit for bit the same;
   ``lstm_cell``'s outputs as views of one allocation; the host path of
   the ``lstm_cell`` and ``bn_act_bwd`` wrappers piece by piece
   (``host_breakdown``); ``softmax_rows`` at every regime border of its
   source (``SM_BORDERS``: narrow <= 32 < middle <= 4096 < wide, and a
   row past the card's shared memory) and at the three path shapes
   (``SM_PATHS``), on aligned rows and on views at a float offset of 1-3,
   with inputs at scale 4 and, once per regime, at scale 1 (``SM_ATOL``
   and ``SM_RTOL``); ``sgd_mom_multi`` bit for bit over sizes no multiple
   of 4, over views one float off alignment, over ``CAP`` + 37 tensors (two
   launches) with the guard's skip and restore, and with no host-to-device
   copy in a call (``torch.profiler``); then, at the path shapes
   (ResNet-50's and SSD's parameters for the update), the kernel back to
   back, single launches with the L2 cache cold (``FLUSH_BYTES``
   overwritten before each), the plain version, the PyTorch call for the
   same function (``torch.softmax``, ``torch.optim.SGD(fused=True)``) both
   ways, the bound, and each wrapper's host microseconds per call; the
   same for ``lstm_cell``/``lstm_cell_bwd`` at (32, 4x200) (beside
   ``_thnn_fused_lstm_cell[_backward_impl]``) and for ``bn_act_bwd`` over
   ResNet-50's 12 training shapes as a step runs them and over one DCGAN D
   pass (beside ``native_batch_norm_backward`` + ``threshold_backward`` /
   ``leaky_relu_backward``), with their device time under the profiler;
6. training — full ResNet-50 (random He-normal weights from the seed)
   trained by ``Module.fit`` over an ``NDArrayIter`` of synthetic data on
   ``gpu(0)``, SGD with momentum 0.9, wd 1e-4, ``rescale_grad`` 1/32, at
   batch 32, with the launch counters checked per step (``bn_stats`` 50,
   ``bn_act`` 50, ``bn_act_bwd`` 50 (one a call wherever its planner
   gives the block or cluster regime, as it does at every ResNet-50 shape
   on the H100), ``softmax_rows`` 1,
   ``softmax_output_bwd`` 1, ``sgd_mom_multi`` 1), and ms per step,
   steps/s and images/s of ``fit``'s own steps after the first by the
   host's clock, with the time spent waiting for the input; that fit runs
   with device prefetch on (the default: ``fit`` wraps the iterator in
   ``io.DevicePrefetchIter``), and a second fit from the same weights
   with ``MXNET_DEVICE_PREFETCH=0`` is timed the same way: each fit's
   batches held bit for bit against their sources on the card, the
   weights after two more such fits, prefetch on and off under
   ``cudnn.deterministic``, within ``PARITY_TOL``, and ``fit.data_wait``
   split into the batch's copy (one batch's copy alone by CUDA events,
   from page-locked memory for the prefetcher, pageable without it) and
   the wait; 10 steps on
   one fixed batch must lower the training cross-entropy to at most
   ``LOSS_RATIO`` of its first value; then the compute step alone (one
   batch already on the card) by CUDA events, peak memory, and a
   ``torch.profiler`` breakdown of one step by kernel, with
   ``bn_act_bwd``'s device time read at 16 bytes an element;
7. training parity — two ``fused_train_update`` steps of full ResNet-50 at
   batch 8 on ``gpu(0)`` and on the port's CPU path (plain versions) from
   the same parameters: after each step the loss, every parameter,
   momentum and BatchNorm statistic within the stated tolerances (in norm,
   over all tensors of a kind, and over the BatchNorm gamma and beta
   momenta as a group of their own; see ``PARITY_TOL``);
8. LSTM kernels — ``lstm_cell`` and ``lstm_cell_bwd`` at (32, 4 x 200)
   with and without a forget bias and with ``dnext_c`` None,
   ``adam_multi`` over the LSTM-PTB model's 4.65 M parameters with wd and
   clip on and off and the guard skipping a NaN step, and
   ``softmax_rows``/``softmax_output_bwd`` at the head's (1024, 10000),
   against their plain versions (``LSTM_RTOL``/``LSTM_ATOL``, the softmax
   limits above), timed beside the bound and one PyTorch call each;
9. LSTM training — the LSTM-PTB model (``LSTM``: hidden and embedding
   200, 2 layers, vocabulary 10000, random Xavier weights from the seed)
   trained by ``BucketingModule.fit`` on ``gpu(0)`` with Adam over two
   epochs of ``examples/lstm_bucketing.py``'s synthetic corpus at batch
   32, buckets 8/16/24/32: every bucket visited, every step's launches
   exactly 2T ``lstm_cell``, 2T ``lstm_cell_bwd``, one ``adam_multi``,
   ``softmax_rows`` and ``softmax_output_bwd`` and no plain version, one
   Adam table per bucket executor over one storage, the second epoch's
   Train-Perplexity below ``PPL_LIMIT``; per bucket ms per step by the
   host's clock and CUDA events, tokens/s, and under ``torch.profiler``
   the device's busy share and top operations;
10. LSTM parity — two Adam steps of the T=8 bucket at full width on the
    card and on the port's CPU path, each from the same state, within
    ``LSTM_PARITY_TOL`` in norm, beside the CPU path in float64;
11. SSD kernels (run after phase 3, before the serving phase) — SSD-VGG16
    (``models.ssd.get_symbol(num_classes=20, data_shape=300)``, A = 8096
    anchors, random weights from the seed: He-normal trunk, N(0, 0.01)
    heads) at batch 8 on the card, its detection step's own tensors
    recorded: ``nms`` against its plain version bit for bit on that head
    (force off and on), on grid boxes whose IoUs sit exactly at the
    threshold with tied scores, and on all-equal and paired scores with an
    image that has no valid box; ``multibox_decode`` on the logits (the
    strided view) and on probabilities (``DECODE_RTOL``/``DECODE_ATOL``,
    class ids exact where the best class is clear); ``l2norm_channel`` at
    conv4_3's (8, 512, 37, 37) and odd shapes, scale 1 and 20
    (``L2_RTOL``/``L2_ATOL``); each timed beside its bound and, for the
    normalization, ``F.normalize * 20``;
12. SSD serving — the same model behind ``ModelServer(ServingConfig(
    buckets=(1, 8)))``: 9 requests (a wave of 8, then 1), each served
    batch launching exactly 1 ``multibox_decode``, ``nms`` as its plan
    gives (2 on the H100: the segment and large kernels) and 1
    ``l2norm_channel`` and no plain version on data; the plain
    NMS on the CPU fed the card's own bucket-8 head tensors gives the
    card's rows bit for bit; every answer against the port's CPU
    ``Predictor`` (scores and boxes within ``SSD_SERVE_TOL`` for every
    anchor, class ids equal where both sides kept the anchor and the best
    class is clear, at most ``SSD_KEEP_LIMIT`` keep decisions apart: near
    ties in the scores may reorder the greedy pass); then ms per batch at
    bucket 8 through the server and for the forward alone, and under
    ``torch.profiler`` the device's busy share and top operations;
13. SSD training kernels — one training step of SSD-VGG16
    (``models.ssd.get_symbol_train(num_classes=20, data_shape=300)``,
    random weights from the seed, as in phase 11) at batch 32 on the card
    with its kernel calls recorded: ``multibox_target`` against its plain
    version bit for bit on the step's own tensors and on
    ``MBT_CASES``' edge inputs; ``l2norm_channel_bwd`` at the step's
    (32, 512, 37, 37) x 20 and odd shapes (``BWD_RTOL``/``BWD_ATOL`` of
    ``kernels/l2norm_channel.py``); ``l2norm_channel``, ``softmax_rows`` at
    (259072, 21), ``softmax_output_bwd`` (multi_output, use_ignore, valid),
    ``multibox_decode`` on probabilities, ``nms`` at (32, 8096) and
    ``sgd_mom_multi`` over SSD's parameters with wd 5e-4 at this path's
    shapes; each timed beside its bound and, where there is one, a
    PyTorch call for the same function;
13b. redesigned ``nms`` and ``bn_stats`` — the per-image distribution of
    the (image, class) segment lengths at the serving and training heads
    (largest, median, how many exceed L_max); ``nms`` bit for bit against
    its plain version on both heads by class (the path), with force, as
    whole images and with one class holding every anchor, on a batch at
    the plan's borders (a class of L_max - 1, L_max and L_max + 1 boxes,
    class ids out of range both ways, images taking different routes) and
    at A = 1, 65 and 1000, each call's launches as planned and two calls
    bit for bit; ``bn_stats`` at every regime border and path shape,
    aligned and on views at a float offset of 1 and 3, within
    ``STAT_RTOL``/``STAT_ATOL`` and the variance's cancellation term,
    ``kvar`` exactly (0.5 on a constant channel), one launch a call, two
    calls bit for bit; neither wrapper copies to or from the host or
    synchronises in a call (``host_syncs``); then their times
    (``kernel_times_nms_bn_stats``: ``nms`` on both heads with its device
    time by kernel, ``bn_stats`` over a ResNet-50 step's 50 inputs and a
    DCGAN step's 13 beside ``torch.var_mean`` and
    ``torch.batch_norm_stats``) and ``bn_stats``' host path piece by
    piece;
13c. redesigned ``l2norm_channel_bwd`` and ``softmax_output_bwd`` —
    ``l2norm_channel_bwd`` on the SSD step's recorded (32, 512, 37, 37) x 20
    and at ``l2_bwd_edges`` (C = 1, H*W = 1, rank 2, odd image counts,
    32-position blocks straddling two images, one image at C = 512, each
    side of the two-pass border), scale 1 and 20, within ``bwd_limit``, the
    planned regime, one launch a call, two calls bit for bit;
    ``softmax_output_bwd`` bit for bit (``torch.equal``) against its plain
    version on the CPU on the SSD step's
    recorded call (class-major view, use_ignore, valid), at the LSTM
    head's (1024, 10000) and ResNet's (32, 1000) and at ``so_bwd_edges``
    (C = 1, 2, 3, odd rows, one row, every normalization with and without
    use_ignore, every label ignored, labels out of range, multi_output
    with inner > 1, the class-major view, a view off alignment), one
    launch a call, the gradient in ``p``'s layout; neither copies to or
    from the host or synchronises in a call; then their times
    (``kernel_times_l2norm_softmax_bwd``: warm, L2-cold, device by kernel
    name, plain, bound, host us);
13d. redesigned ``bn_act`` and ``multibox_target`` — ``bn_act`` bit for bit
    (every bit, signed zeros included) against the parent kernel's
    per-element order computed on the CPU (:func:`bn_act_parent_order`) for
    no activation, the ReLU and the leaky ReLU at every path shape
    (ResNet-50 serving's 5 and training's 12, DCGAN's D and G) and at
    ``bn_act_borders`` (each side of the block sizes' thresholds in both
    regimes, planes of 1 to 49 floats, C = 1 and 3, N = 1), aligned and at
    float offsets 1 and 3, each border also forced into the other regimes
    (``run_plan``), within ``BN_RTOL``/``BN_ATOL`` of ``bn_act_plain`` at
    the path shapes, one launch a call with the leaky ones counted;
    ``multibox_target`` bit for bit against its plain version on the SSD
    step's recorded call and on ``MBT_CASES`` and ``MBT_EDGES`` (ties at
    K* across the blocks, the last block's best anchor, max_neg 0 and at
    least A, G = 1 with a tiny A, A no multiple of the blocks' span with G
    past one sweep, a forced anchor that would have been a mining
    candidate), each with the mining on and off, one launch a call; neither
    reads anything back in a call; then their times
    (``kernel_times_bn_act_mbt``: ``bn_act`` over each path's calls beside
    ``F.batch_norm`` + ``relu_``/``F.leaky_relu``, ``multibox_target`` at
    SSD training's call; warm, L2-cold, device time by kernel name, plain,
    bound, host us);
13e. redesigned ``l2norm_channel`` and ``multibox_decode`` — on the
    recorded SSD serving forward (bucket 8, and its first image as bucket
    1) and training step (:func:`path_calls_l2_decode`):
    ``l2norm_channel`` bit for bit against the kernel's order of rounding
    computed on the CPU (:func:`l2norm_order`) there and at
    :func:`l2_edges` (C = 1, 3, 16, 17, 512, 513, 1000; H*W = 1 and odd;
    rank 2; blocks straddling two images), one float off alignment and
    :func:`l2_nan_edges` (a norm of NaN or 0 gives NaN), scale 1 and 20,
    every tile forced on the same inputs giving the same bits, within
    ``L2_RTOL``/``L2_ATOL`` of its plain version, the planned regime, one
    launch a call, two calls bit for bit; ``multibox_decode``
    on the recorded calls (logits, the transposed view; probabilities) and
    on :func:`decode_views` (transposed, class-major, wider rows, padded
    images, off alignment) at A = 1000, 77 and 1 and at 401 classes on
    logits and probabilities, clip on and off, within
    ``DECODE_RTOL``/``DECODE_ATOL`` with class ids equal where the best
    class is clear, the planned body, one launch a call, two calls bit for
    bit; neither reads anything back in a call; the share of zeros in the
    recorded inputs; the decode's host path piece by piece
    (``host_breakdown_decode``); then their times
    (``kernel_times_l2norm_decode``: at SSD serving buckets 1 and 8 and SSD
    training's call, warm, L2-cold, device time by kernel name, plain,
    ``F.normalize * 20`` beside the normalization, bound, host us, and a
    digest of the output bits);
14. SSD training — the same model trained by ``Module.fit`` on ``gpu(0)``
    over an ``NDArrayIter`` of painted-rectangle images (20 classes, 1..6
    objects, mean subtracted) at batch 32, SGD lr 0.002, momentum 0.9, wd
    5e-4, the ``Loss`` metric: every step's launches exactly
    ``SSD_TRAIN_LAUNCHES`` and no plain version on data; 10 steps on one
    fixed batch of 4 must lower the class cross-entropy and the loc loss
    to ``SSD_LOSS_RATIO`` of their first values; ms per step and images/s
    of fit's own steps after the first, with prefetch on (the main path)
    and off, as phase 6 reads them (the weights within
    ``SSD_PARITY_TOL``), the compute step by CUDA events, peak memory, and
    a profile of one step (busy share, convolutions' share, top kernels);
15. SSD training parity — two SGD steps at batch 2 on the card and on the
    port's CPU path, each from the same state, within ``SSD_PARITY_TOL``
    in norm and at most ``SSD_TARGET_LIMIT`` cls_target values apart;
16. DCGAN kernels — ``bn_act`` and ``bn_act_bwd`` with the LeakyReLU
    slope 0.2 at the discriminator's three BatchNorm shapes at batch 64
    and with slope 0 (the ReLU) at the generator's four, over given and
    batch statistics, against their plain versions (``BN_RTOL``/
    ``BN_ATOL``, ``FWD_RTOL``/``FWD_ATOL``, ``DX_RTOL``/``DX_ATOL``), plus
    pre-activations exactly +0.0 and -0.0 (signed zeros as the plain
    version's, +0.0 from the ReLU for a negative input) and a constant
    channel; ``bn_stats`` at all seven shapes (mean, variance, moving
    statistics, ``kvar`` exactly) and ``adam_multi`` over G's and D's
    parameters with beta1 0.5, steps 1 and 2, against their plain versions;
    per D pass the kernel by CUDA events, its device time under
    ``torch.profiler`` in a loop over the three tensors, the plain version,
    ``F.batch_norm`` + ``F.leaky_relu`` (backward: ATen's
    ``native_batch_norm_backward`` + ``leaky_relu_backward``) and the bound
    by bytes;
17. DCGAN training — ``GANModule`` (``examples/train_dcgan.py``'s
    defaults: ngf = ndf = 64, batch 64, z 100, Adam lr 2e-4 beta1 0.5,
    random N(0, 0.02) weights from the seed) trained by ``train_window``
    on ``gpu(0)``: ``DCGAN_WARMUP`` windows of ``DCGAN_K`` steps, then
    ``DCGAN_WINDOWS`` timed ones over the example's synthetic reals, the
    ``CustomMetric(facc)`` read two windows behind as the example does;
    every window's launches exactly ``DCGAN_K`` x ``DCGAN_LAUNCHES`` and
    no plain version on data; D's real accuracy finite; ms per step by the
    host's clock (card drained at both ends) and by CUDA events, samples/s,
    peak memory; the serial loop's rate (``_serial_window``); generation
    through ``Module(g_sym).forward(is_train=False)`` at batch 64; the loss
    check (``DCGAN_LOSS_STEPS`` steps on one batch of ``DCGAN_LOSS_BATCH``
    bring D's logistic loss to ``DCGAN_LOSS_RATIO`` of its first value);
    the same windows without the metric's reads; a profile of one step;
18. DCGAN parity — two steps at full width and batch 8 on the card and on
    the port's CPU path from the same weights, latents and reals: G's and
    D's parameters, BatchNorm statistics, Adam states and the published
    outputs within ``DCGAN_PARITY_TOL`` in norm, and at most a share
    ``DCGAN_FLIP_SHARE`` of the weights whose first update took the other
    sign;
19. baseline scripts — ``softmax_rows`` and ``softmax_output_bwd`` at
    MNIST's (64, 10) and ``sgd_mom_multi`` over the MLP's and LeNet's
    parameters against their plain versions (the path's shapes; limits as
    in phases 5 and 5b), timed beside their bounds and the PyTorch calls;
    then the repository's own training scripts, unchanged,
    each in a subprocess through ``python -m mxnet_tpu_torch.launch``
    (``mxnet_tpu_torch`` bound as ``mxnet_tpu``; numpy's generator seeded
    with ``SEED``): ``examples/train_mnist.py --synthetic 1`` for the MLP
    and LeNet (``--kv-store local``, batch 64, ``MNIST_EPOCHS`` epochs),
    each reaching the validation accuracy of the same command on the
    port's CPU path (``MNIST_CPU_ACC``) within ``MNIST_ACC_MARGIN``, with
    ``softmax_rows``, ``softmax_output_bwd`` and ``sgd_mom_multi`` launched
    once a training step and ``softmax_rows`` once a validation batch;
    then ``examples/train_imagenet.py --network resnet --num-layers 50
    --kv-store device --benchmark 1`` at batch 32 over 640 examples (20
    steps, float32: the canonical ``--dtype bfloat16`` needs the ``Cast``
    op, which is not yet ported) with the six ResNet kernels' launches per
    step as phase 6 checks them, and the script's Speedometer samples/s.
    No process imported ``jax``;
20. windows — training windows under deterministic cuDNN: ResNet-50 at
    batch 32 (phase 6's weights), ``Module.train_window`` over
    ``WINDOW_K`` distinct batches and over one batch ``n_steps=WINDOW_K``,
    each bit for bit ``WINDOW_K`` serial ``forward_backward`` + ``update``
    from the same weights (weights, momenta, BatchNorm statistics, the last
    outputs), its launches ``WINDOW_K`` x phase 6's per step;
    ``publish_grads=False``: ``boundary.grads()`` raises and the weights
    are the publishing window's; under ``MXNET_NONFINITE_GUARD=skip`` a NaN
    batch at step ``WINDOW_NAN_STEP`` + 1 skips that step alone, as the
    serial loop does. Then the main path: ``Module.fit`` over
    ``WINDOW_FIT_STEPS`` batches under ``MXNET_TRAIN_WINDOW=WINDOW_K`` and
    ``MXNET_DISPATCH_DEPTH=WINDOW_DEPTH`` (launches, the ``fit.*`` gauges,
    bit for bit the per-batch fit, ms per step beside it); LSTM-PTB's
    ``BucketingModule.fit`` as in phase 9 under windows (launches,
    Train-Perplexity under ``PPL_LIMIT``) and one mixed-bucket chunk bit
    for bit its serial steps, Adam's counts advanced by the chunk; and
    ``examples/train_mnist.py --network mlp`` under
    ``MXNET_TRAIN_WINDOW=auto`` through the launcher (the chosen K,
    validation accuracy within ``MNIST_ACC_MARGIN``, launches, samples/s).

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Any failed phase exits non-zero before the result
lines. Without CUDA it exits non-zero at once.

    python3 chip_smoke.py --cpu-perplexity 0 1 2

runs the LSTM-PTB fit of phase 9 on the port's CPU path for each
initialization seed given and prints each epoch's Train-Perplexity (the
readings ``PPL_LIMIT`` was fixed from); it needs no card.

    python3 chip_smoke.py --cpu-ssd

serves phase 12's 9 images through the port's CPU ``Predictor`` in float32
and in float64 and prints how far they are apart (the readings
``SSD_SERVE_TOL`` and ``SSD_KEEP_LIMIT`` were fixed from); it needs no
card.

    python3 chip_smoke.py --cpu-ssd-train

runs phase 14's loss check on the port's CPU path for three parameter
seeds and phase 15's two parity steps in float32 and in float64, and
prints the readings ``SSD_LOSS_RATIO``, ``SSD_PARITY_TOL`` and
``SSD_TARGET_LIMIT`` were fixed from (SSD-300 at batches 4 and 2: run it on
a machine with many cores, ~3 minutes on 8); it needs no card.

    python3 chip_smoke.py --cpu-baseline

runs phase 19's MNIST scripts on the port's CPU path (``--cpu``) and
prints each epoch's validation accuracy (the readings ``MNIST_CPU_ACC``
was fixed from); it needs no card.

    python3 chip_smoke.py --kernel-times [ROOT]

prints phase 5b's times, phase 13b's (on the SSD heads recorded by
``ssd_nms_heads``), phase 13c's, phase 13d's and phase 13e's (on the calls
recorded with those heads) alone (after phases 1-2), for the package of
the checkout at ``ROOT`` when given (say, the parent commit unpacked under
``build/``), else for this one's: run both in one call, in turns, to
compare two versions on one card. Each turn keeps a digest of phase 13e's
output bits in ``KERNEL_BITS`` (under ``build/``) and prints whether the
checkouts timed before it in the same call gave the same bits.

    python3 chip_smoke.py --bn-bwd-plans

prints ``bn_act_bwd``'s device time at every ResNet-50 and DCGAN shape for
each planner setting of ``PLAN_TARGETS`` x ``PLAN_PER_THREAD`` (the
readings ``BLOCK_TARGET``, ``ELEMS_PER_THREAD`` and ``GROUP_CAP`` of
``kernels/bn_act_bwd.py`` were chosen from), after phases 1-2.

    python3 chip_smoke.py --nms-plans

prints ``nms``'s device time by kernel on the SSD heads at batches 8 and
32 for each L_max of ``NMS_ONCHIP`` (the readings ``ONCHIP`` of
``kernels/nms.py`` was chosen from), after phases 1-2.

    python3 chip_smoke.py --bn-stats-plans

prints ``bn_stats``' device time at every ResNet-50 and DCGAN shape for
each planner setting of ``STATS_TARGETS`` x ``STATS_PER_THREAD``, and its
wrapper's host path piece by piece, after phases 1-2.

    python3 chip_smoke.py --fit-spread

prints how far apart full ResNet-50 fits from the same weights and
batches end with cuDNN's default algorithms, prefetch on against off and
off against off, after 12, 2 and 1 steps (``fit_spread``: the readings
``prefetch_check`` rests on), after phases 1-2.

    python3 chip_smoke.py --l2norm-bwd-sweep N

holds ``l2norm_channel_bwd`` and its plain version at (2, 3) against a
float64 computation over N seeds (``l2norm_bwd_sweep``; the readings
``l2norm_channel.bwd_limit`` rests on), after phases 1-2.

    python3 chip_smoke.py --cpu-dcgan

runs phase 17's loss check on the port's CPU path for three parameter
seeds and phase 18's two parity steps in float32 and in float64 at full
width, and prints the readings ``DCGAN_LOSS_RATIO``, ``DCGAN_PARITY_TOL``
and ``DCGAN_FLIP_SHARE`` were fixed from, and the readings of the
``DCGAN_FAULTS`` that those limits must catch; it needs no card.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 FLOP/s
# outside the tensor cores. Both kernels work in float32 on CUDA cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
BN_EPS = 2e-5  # the BatchNorm eps of models/resnet.py
BN_RTOL, BN_ATOL = 1e-5, 1e-6  # float32; rsqrt and division may differ by an ulp
SM_ATOL = 1e-6  # float32 probabilities; the sum is reduced in another order
# and, beside it, relative to each probability: at C = 10000 a typical one
# is 3e-8, far below SM_ATOL. A sum in another order moves a float32
# quotient by about 1e-6 of itself.
SM_RTOL = 1e-5
SERVE_ATOL = 1e-4  # probabilities, card vs CPU: 50 conv layers summed in other orders
# At its initial statistics every BatchNorm is the identity and every bias
# is 0, so the network is positively homogeneous: logits scale with the
# input. Unit-variance images give logits in the hundreds and probabilities
# of exactly 0 and 1 on both sides, which would make the comparison empty;
# this scale keeps them in the open interval.
INPUT_SCALE = 1.0 / 128
# the 17 BatchNorms of folded ResNet-50 that cannot fold, by input shape at
# batch 32, with how often each shape occurs in one forward
PATH_BN = [((32, 64, 56, 56), 1), ((32, 256, 56, 56), 3),
           ((32, 512, 28, 28), 4), ((32, 1024, 14, 14), 6),
           ((32, 2048, 7, 7), 3)]
PATH_SOFTMAX = (32, 1000)
TRAIN_BATCH = 32
FIT_STEPS = 12  # Module.fit's steps on the main path; 2..12 are timed
# each port kernel's CUDA function names, as torch.profiler reports them
PORT_KERNELS = {"bn_stats": "bn_stats_kernel", "bn_act": "bn_act_",
                "bn_act_bwd": "bn_bwd_", "softmax_rows": "softmax_rows_",
                "softmax_output_bwd": "softmax_output_bwd_",
                "sgd_mom_multi": "sgd_mom_multi_kernel",
                "lstm_cell": "lstm_cell_kernel",
                "lstm_cell_bwd": "lstm_cell_bwd_kernel",
                "adam_multi": "adam_multi_kernel",
                "multibox_decode": "multibox_decode_kernel",
                "nms": "nms_", "l2norm_channel": "l2norm_channel_kernel",
                "l2norm_channel_bwd": "l2norm_channel_bwd_",
                "multibox_target": "multibox_target_kernel"}
# kernels counted beside another one, in that one's module
BWD_COUNTERS = {"lstm_cell_bwd": ("lstm_cell", "BWD_LAUNCHES"),
                "l2norm_channel_bwd": ("l2norm_channel", "BWD_LAUNCHES")}
PARITY_BATCH = 8
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LOSS_RATIO = 0.7  # cross-entropy after 10 steps on one batch / its first
# training kernels against their plain versions on the card (float32): the
# channel sums are taken in another order than torch.sum, so sums over n
# elements carry up to n * 2**-24 of absolute error; the anchored variance
# loses 8 * 2**-23 * dmean**2 to cancellation (dmean: batch mean - anchor)
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
DX_RTOL, DX_ATOL = 1e-4, 1e-5
# the training forward (bn_stats, then bn_act with the batch statistics):
# the statistics agree to STAT_RTOL, and the output carries their error
# times |x_hat| * gamma (up to ~8 here)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
EXACT_ATOL = 1e-6  # softmax_output_bwd and sgd_mom_multi repeat the plain ops
# card against the port's CPU path, two SGD steps of full ResNet-50 at
# batch 8 at lr 0.01, each from the same state on both sides. Each kind is
# compared over all its tensors at once, in norm: |got - want| <= rtol *
# |want| (step 1, step 2). The forward agrees to
# float32 summation order (the first loss, the statistics). The gradients
# do not to that level: a ReLU or max-pool input within rounding distance
# of its decision boundary takes the other branch on the other device and
# moves a whole gradient term, so the difference grows from the head to the
# stem, to a few percent in norm there, and tensors whose gradient nearly
# cancels (a BatchNorm beta before a convolution) carry more of it. The
# momenta hold lr * grad; a kernel that dropped or mis-signed a term would
# be off by tens of percent. The per-tensor worst case is printed.
# "bn_momentum" is the momenta of the BatchNorm gamma and beta tensors
# alone: the large convolution weights dominate the norm over all momenta,
# so a fault confined to dgamma or dbeta would hide there. A group's
# relative difference in norm is at most its worst tensor's, which read
# 2.4e-2 in earlier runs (stage2_unit2_bn3_beta).
PARITY_LR = 0.01
PARITY_TOL = {"loss": (1e-4, 1e-4), "param": (1e-3, 1e-3),
              "momentum": (5e-2, 5e-2), "bn_momentum": (5e-2, 5e-2),
              "aux": (1e-3, 1e-3)}
# the LSTM-PTB configuration: examples/lstm_bucketing.py's defaults with
# PTB's 10000-word vocabulary, over its synthetic corpus
LSTM = {"num_hidden": 200, "num_layers": 2, "num_embed": 200,
        "vocab_size": 10000}
LSTM_BATCH = 32
LSTM_BUCKETS = (8, 16, 24, 32)
LSTM_OPT = {"learning_rate": 0.01}
LSTM_EPOCHS = 2
# the LSTM cell and Adam against their plain versions (float32): the same
# operations in the same order, but expf/tanhf/sqrtf may round an ulp away
# from torch's own kernels
LSTM_RTOL, LSTM_ATOL = 1e-5, 1e-6
# Train-Perplexity of the second epoch (an average of the batches'
# perplexities) must fall below PPL_LIMIT and below the first epoch's. The
# port's CPU path at this size (``--cpu-perplexity 0 1 ... 9``) reads
# 6058..8396 over ten initialization seeds (mean 7256, sd 808; first epoch
# 10733..12863; guessing uniformly over 10000 words gives 10000). The card
# initializes from its own generator, so the limit sits ~2.8 sd above that
# mean
PPL_LIMIT = 9500.0
# card against the port's CPU path, two Adam steps of the T=8 bucket at
# full width, each from the same state, in norm over all tensors of a kind:
# |card - cpu| <= rtol * |cpu|. No ReLU or max-pool branch can flip here:
# the CPU path in float32 against the same path in float64 differs by at
# most 1.1e-7 (loss), 2.4e-7 (parameters), 3.2e-7 (Adam means) and 3.5e-7
# (variances) over the two steps, so 1e-5 leaves ~30x for the card's other
# summation order
LSTM_PARITY_TOL = {"loss": 1e-5, "param": 1e-5, "mean": 1e-5, "var": 1e-5}
# SSD-VGG16 serving: get_symbol(num_classes=20, data_shape=300), float32
SSD_CLASSES, SSD_SHAPE, SSD_ANCHORS = 20, 300, 8096
SSD_BATCH = 8
SSD_BUCKETS = (1, 8)
SSD_REQUESTS = 9  # a wave of 8, then 1
SSD_SERVE_BATCHES = 100  # bucket-8 batches timed through the server (~3.5 s)
SSD_CONV4_3 = (SSD_BATCH, 512, 37, 37)
SSD_L2_EPS = 1e-10  # L2Normalization's default eps
# multibox_decode against its plain version: the softmax's sum of 21 terms
# runs in another order (a few ulps of the probabilities)
DECODE_RTOL, DECODE_ATOL = 1e-6, 1e-7
# l2norm_channel: the channel sum of 512 squares runs in another order;
# atol times the scale
L2_RTOL, L2_ATOL = 1e-5, 1e-6
NMS_IOU_OPS = 15  # float ops of one IoU and its tests, per-box areas apart
# the card's SSD answers against the port's CPU Predictor, fixed before the
# card ran the SSD path from ``--cpu-ssd``: the port's CPU path in float32
# against float64 on the same 9 images read a worst score or box difference
# of 2.1e-6 (7.1e-6 relative, floor 0.1), 0 keep and 0 class disagreements
# over 72864 anchors. Score and box columns (rtol, atol) for every anchor;
# keep decisions that may differ: a near tie between two scores reorders
# the greedy pass and moves a short chain of decisions, so the limit
# allows a few such chains (16, 0.02 % of the anchors) though 0 was read
SSD_SERVE_TOL = (1e-4, 1e-5)
SSD_KEEP_LIMIT = 16
# SSD-VGG16 training: get_symbol_train(num_classes=20, data_shape=300) and
# the trainer of examples/train_ssd.py (SGD lr 0.002, momentum 0.9, wd
# 5e-4, rescale_grad 1/batch), batch 32 as the reference MXNet
# example/ssd/train.py has it
SSD_TRAIN_BATCH = 32
SSD_OBJECTS = 16  # label rows per image: 1..6 objects, the rest -1
SSD_TRAIN_OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4}
SSD_FIT_STEPS = 10  # Module.fit's steps on the main path; 2..10 are timed
SSD_MEAN = (123.0, 117.0, 104.0)  # the example iterator's mean_r/g/b
# the painted images go in mean subtracted and divided by 58 (about the
# pixels' standard deviation): random He-normal weights carry raw pixel
# scale through the VGG trunk into the unnormalized heads, whose logits
# then saturate the softmax and the first steps' loss jumps by orders of
# magnitude
SSD_INPUT_SCALE = 1.0 / 58
# launches per SSD training step: softmax_output_bwd one a call under
# normalization="valid" too (the count of valid labels in the same
# cooperative launch); nms as its plan gives them on the card (None here:
# ssd_nms_launches, three on the H100, where A = 8096 exceeds L_max)
SSD_TRAIN_LAUNCHES = {"multibox_target": 1, "l2norm_channel": 1,
                      "l2norm_channel_bwd": 1, "softmax_rows": 1,
                      "softmax_output_bwd": 1, "multibox_decode": 1,
                      "nms": None, "sgd_mom_multi": 1}
# the loss check: SSD_LOSS_STEPS steps on one fixed batch of
# SSD_LOSS_BATCH must bring the class cross-entropy over the anchors whose
# target is not ignored, and the loc loss per matched anchor, to at most
# these fractions of their first values. Fixed from ``--cpu-ssd-train``
# on the card machine's CPU before any card ran the phase: over the
# parameter seeds SEED + 30, 31, 32 the last/first ratios read 0.653,
# 0.467, 0.529 (cross-entropy) and 0.602, 0.400, 0.569 (loc loss). The
# card starts from the same numpy parameters as SEED + 30, so its reading
# should sit near that seed's; the limit leaves room for the other seeds'
# spread above it
SSD_LOSS_BATCH = 4
SSD_LOSS_STEPS = 10
SSD_LOSS_RATIO = {"ce": 0.8, "loc": 0.8}
# card against the port's CPU path, two SGD steps of SSD-300 at batch 2,
# each from the same state, in norm over all tensors of a kind, |card -
# cpu| <= rtol * |cpu| (step 1, step 2); and how many anchors' cls_target
# may differ per step. Fixed from ``--cpu-ssd-train`` before any card ran
# the phase: the CPU path in float32 against float64 read at most 1.0e-7
# (loss), 2.2e-7 (parameters) and 2.9e-4 (momenta; worst tensor 8.7e-4)
# over the two steps, and 0 cls_target disagreements of 16192. The card
# sums in other orders, and a ReLU or max-pool input within rounding of
# its boundary moves a whole gradient term (ResNet-50's card-vs-CPU
# momenta read 2.1e-2): 1e-5 leaves ~50x on the loss and parameters, 2e-2
# ~70x on the momenta. A background logit within rounding of the mining
# boundary, or a best IoU within rounding of 0.5, moves one or two
# anchors' targets: up to 4 a step may differ, though 0 was read
SSD_PARITY_BATCH = 2
SSD_PARITY_TOL = {"loss": (1e-5, 1e-5), "param": (1e-5, 1e-5),
                  "momentum": (2e-2, 2e-2)}
SSD_TARGET_LIMIT = 4
# the BASELINE scripts (phase 19): examples/train_mnist.py's synthetic
# MNIST reaches these validation accuracies on the port's CPU path with
# numpy seeded with SEED (``--cpu-baseline``); the card's initial weights
# come from its own generator, so it must come within the margin
MNIST_EPOCHS = 2
MNIST_CPU_ACC = {"mlp": 1.0, "lenet": 1.0}
MNIST_ACC_MARGIN = 0.01
MNIST_BATCH = 64  # examples/train_mnist.py's default --batch-size
BASELINE_STEPS = 20  # --num-examples 640 at --batch-size 32
BASELINE_RESNET = [
    "examples/train_imagenet.py", "--network", "resnet", "--num-layers",
    "50", "--kv-store", "device", "--benchmark", "1", "--batch-size", "32",
    "--num-examples", "640", "--num-epochs", "1", "--disp-batches", "5"]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(nbytes, flops):
    """(ms, 'bytes'|'operations'): the larger of the two rooflines."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want, rtol, atol):
    torch.cuda.synchronize()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    return float(err.max()), ok


def sm_check(torch, what, got, want):
    """``softmax_rows`` against its plain version: within ``SM_ATOL`` and
    within ``SM_RTOL`` of each probability. Returns the largest absolute
    and relative errors."""
    err, ok = max_err(torch, got, want, 0.0, SM_ATOL)
    _, rel_ok = max_err(torch, got, want, SM_RTOL, 1e-30)
    rel = float(((got - want).abs() / (want.abs() + 1e-30)).max())
    if not (ok and rel_ok):
        fail(f"{what}: max abs err {err:g} (atol {SM_ATOL}), max rel err "
             f"{rel:g} (rtol {SM_RTOL})")
    return err, rel


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch.cuda.get_device_name(0)="
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}"
          f" torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    return card


def phase_build():
    from mxnet_tpu_torch.kernels import _lib

    t0 = time.perf_counter()
    path, log = _lib.build()
    _lib.library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} built and loaded in {secs:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")
    return secs


def phase_kernels(torch):
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels.bn_act import bn_act, bn_act_plain
    from mxnet_tpu_torch.kernels.softmax_rows import (
        softmax_rows, softmax_rows_plain)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def bn_inputs(shape):
        c = shape[1]
        return (torch.randn(shape, generator=gen, device=dev),
                0.1 * torch.randn(c, generator=gen, device=dev),
                0.5 + torch.rand(c, generator=gen, device=dev),
                0.5 + torch.rand(c, generator=gen, device=dev),
                0.1 * torch.randn(c, generator=gen, device=dev))

    # --- bn_act: correctness at every path shape, with the ReLU (slope 0)
    # and without, fix_gamma both ways, plus tails where H*W is odd and
    # planes start unaligned
    bn_err = 0.0
    tensors = {}
    shapes = [s for s, _ in PATH_BN] + [(1, 64, 56, 56), (3, 5, 7, 9),
                                        (2, 3, 5, 5), (4, 7, 1, 3)]
    for shape in shapes:
        ins = bn_inputs(shape)
        tensors[shape] = ins
        for slope in (0.0, None):
            for fix_gamma in (False, True):
                got = bn_act(*ins, BN_EPS, fix_gamma, slope)
                want = bn_act_plain(*ins, BN_EPS, fix_gamma, slope)
                err, ok = max_err(torch, got, want, BN_RTOL, BN_ATOL)
                bn_err = max(bn_err, err)
                if not ok:
                    fail(f"bn_act {shape} slope={slope} fix_gamma={fix_gamma}: "
                         f"max abs err {err:g} over rtol {BN_RTOL} atol "
                         f"{BN_ATOL}")
    print(f"[kernels] bn_act matches its plain version at {len(shapes)} "
          f"shapes x ReLU or none x fix_gamma: max abs err {bn_err:g} "
          f"(rtol {BN_RTOL}, atol {BN_ATOL})", flush=True)

    # --- bn_act timing: one forward's 17 launches at batch 32
    def seq(fn):
        def run():
            for shape, mult in PATH_BN:
                x, mean, var, gamma, beta = tensors[shape]
                for _ in range(mult):
                    fn(x, mean, var, gamma, beta)
        return run

    bn_ms = cuda_ms(torch, seq(lambda *t: bn_act(*t, BN_EPS, False, 0.0)))
    bn_plain_ms = cuda_ms(
        torch, seq(lambda *t: bn_act_plain(*t, BN_EPS, False, 0.0)))
    bn_lib_ms = cuda_ms(torch, seq(lambda x, m, v, g, b: F.batch_norm(
        x, m, v, g, b, training=False, eps=BN_EPS).relu_()))
    nbytes = sum(mult * (2 * math.prod(s) + 4 * s[1]) * 4 for s, mult in PATH_BN)
    flops = sum(mult * 5 * math.prod(s) for s, mult in PATH_BN)
    bn_bound, bn_by = bound(nbytes, flops)
    print(f"[kernels] bn_act per forward at batch 32 (17 launches, "
          f"{nbytes / 1e9:.3f} GB): kernel {bn_ms:.4f} ms, plain "
          f"{bn_plain_ms:.4f} ms, F.batch_norm+relu_ {bn_lib_ms:.4f} ms, "
          f"bound {bn_bound * 1e3:.1f} us ({bn_by}), "
          f"{nbytes / (bn_ms * 1e-3) / 1e12:.2f} TB/s achieved", flush=True)

    # --- softmax_rows
    sm_err, sm_rel = 0.0, 0.0
    for shape in (PATH_SOFTMAX, (1, 1000), (7, 1001)):
        x = 4.0 * torch.randn(shape, generator=gen, device=dev)
        err, rel = sm_check(torch, f"softmax_rows {shape}", softmax_rows(x),
                            softmax_rows_plain(x))
        sm_err, sm_rel = max(sm_err, err), max(sm_rel, rel)
    x = 4.0 * torch.randn(PATH_SOFTMAX, generator=gen, device=dev)
    sm_ms = cuda_ms(torch, lambda: softmax_rows(x), reps=100)
    sm_plain_ms = cuda_ms(torch, lambda: softmax_rows_plain(x), reps=100)
    sm_lib_ms = cuda_ms(torch, lambda: torch.softmax(x, dim=1), reps=100)
    n = math.prod(PATH_SOFTMAX)
    sm_bound, sm_by = bound(2 * n * 4, 7 * n)
    print(f"[kernels] softmax_rows matches its plain version at 3 shapes: "
          f"max abs err {sm_err:g} (atol {SM_ATOL}), max rel err {sm_rel:g} "
          f"(rtol {SM_RTOL}); at {PATH_SOFTMAX}: "
          f"kernel {sm_ms:.4f} ms, plain {sm_plain_ms:.4f} ms, torch.softmax "
          f"{sm_lib_ms:.4f} ms, bound {sm_bound * 1e3:.3f} us ({sm_by})",
          flush=True)
    return [
        {"name": "bn_act", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/bn_act.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:394",
         "max_abs_err": bn_err, "ms": bn_ms, "plain_ms": bn_plain_ms,
         "bound_ms": bn_bound, "bound_by": bn_by, "library_ms": bn_lib_ms},
        {"name": "softmax_rows", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/softmax_rows.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:703",
         "max_abs_err": sm_err, "ms": sm_ms, "plain_ms": sm_plain_ms,
         "bound_ms": sm_bound, "bound_by": sm_by, "library_ms": sm_lib_ms},
    ]


def resnet50_params(mx):
    """ResNet-50 parameters from numpy with a fixed seed: He-normal
    weights, gamma 1, beta 0, biases 0, moving_mean 0, moving_var 1."""
    sym = mx.models.resnet(num_classes=1000, num_layers=50,
                                      image_shape="3,224,224")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, 224, 224))
    rng = np.random.default_rng(SEED)
    args, auxs = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            args[name] = (rng.standard_normal(shape, np.float32) * std)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        else:
            args[name] = np.zeros(shape, np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        fill = np.ones if name.endswith("_var") else np.zeros
        auxs[name] = fill(shape, np.float32)
    arg_nd, aux_nd = mx.convert.params_from_numpy(args, auxs, "cpu")
    params = {f"arg:{k}": v for k, v in arg_nd.items()}
    params.update({f"aux:{k}": v for k, v in aux_nd.items()})
    return sym, params


def profile_forward(torch, pred, reps=3):
    """Where one forward at bucket 32 spends the card's time: kernels by
    self device time under torch.profiler, and the device's busy share of
    the wall time. Measurement only; it fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # kernels only: a CPU op also reports the device time of the
        # kernels it launched, which would count them twice
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            rows.append((ev.self_device_time_total / reps, ev.count // reps,
                         ev.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("[profile] torch.profiler recorded no device time")
        return
    print(f"[profile] one forward at bucket 32: device busy {busy / 1e3:.2f} "
          f"ms of {wall_us / reps / 1e3:.2f} ms wall "
          f"({100 * busy * reps / wall_us:.0f}%); top kernels by device time:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / busy:5.1f}% "
              f"x{count:<3d} {key[:90]}")


def phase_serving(torch, mx, card):
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.kernels import bn_act, softmax_rows
    from mxnet_tpu_torch.serving import ModelServer, ServingConfig

    t0 = time.perf_counter()
    sym, params = resnet50_params(mx)
    srv = ModelServer(sym, params, {"data": (3, 224, 224)},
                      config=ServingConfig(buckets=(1, 8, 32), fold_bn=True,
                                           max_delay_ms=200))
    try:
        srv.warmup()
        srv.start()
        fused = len(srv.predictor(32)._exec.graph.fused)
        print(f"[serving] ResNet-50 server up in "
              f"{time.perf_counter() - t0:.1f} s: replicas "
              f"{[r['device'] for r in srv.stats()['replicas']]}, buckets "
              f"(1, 8, 32), {fused} BatchNorm+ReLU pairs routed to bn_act",
              flush=True)
        if fused != 17:
            fail(f"expected 17 unfoldable BatchNorm+ReLU pairs, found {fused}")
        x = INPUT_SCALE * np.random.default_rng(SEED + 1).standard_normal(
            (41, 3, 224, 224), np.float32)
        waves = [(range(0, 32), 32), (range(32, 40), 8), (range(40, 41), 1)]
        answers, buckets = [None] * 41, [None] * 41

        # the main path: every count at 0 just before, read just after
        tm.reset()
        for idx, _want in waves:
            futs = {i: srv.submit(x[i]) for i in idx}
            for i, f in futs.items():
                answers[i] = f.result(timeout=300)[0]
                buckets[i] = f.bucket
        launches = {"bn_act": bn_act.LAUNCHES.value,
                    "softmax_rows": softmax_rows.LAUNCHES.value}
        batches = tm.counter("serving.batches").value

        for idx, want in waves:
            got = {buckets[i] for i in idx}
            if got != {want}:
                fail(f"requests {idx} ran in buckets {got}, expected {want}")
        if batches != len(waves) or launches != {
                "bn_act": 17 * batches, "softmax_rows": batches}:
            fail(f"launch counters {launches} over {batches} served batches; "
                 f"expected 17 bn_act and 1 softmax_rows per batch")
        print(f"[serving] 41 requests served in buckets 32, 8, 1 "
              f"({batches} batches): launches {launches} = 17 bn_act and 1 "
              f"softmax_rows per batch", flush=True)

        # every answer against the port's CPU Predictor (plain versions)
        ref_pred = mx.predictor.Predictor(sym, params, {"data": x.shape},
                                          dev_type="cpu")
        ref = ref_pred.run(data=x)[0]
        got = np.stack(answers)
        diff = float(np.abs(got - ref).max())
        if got.shape != (41, 1000) or not np.isfinite(got).all():
            fail(f"answers: shape {got.shape}, finite {np.isfinite(got).all()}")
        if (got.argmax(1) != ref.argmax(1)).any() or diff > SERVE_ATOL:
            fail(f"answers vs CPU Predictor: argmax equal "
                 f"{(got.argmax(1) == ref.argmax(1)).sum()}/41, max abs diff "
                 f"{diff:g} over {SERVE_ATOL}")
        print(f"[serving] answers match the CPU Predictor: argmax 41/41, max "
              f"abs diff {diff:g} (limit {SERVE_ATOL}) on probabilities; top-1 "
              f"probability {got.max(1).min():.3f}..{got.max(1).max():.3f}",
              flush=True)

        # throughput at bucket 32, end to end through the server (a closed
        # loop: one client submits 32 images and waits for all 32)
        reps = 5
        tm.reset()
        t0 = time.perf_counter()
        for _ in range(reps):
            futs = [srv.submit(x[i]) for i in range(32)]
            for f in futs:
                f.result(timeout=300)
        batch_ms = (time.perf_counter() - t0) / reps * 1e3
        infer = tm.histogram("serving.infer")
        wait = tm.histogram("serving.queue_wait")
        pred = srv.predictor(32)
        fwd_ms = cuda_ms(torch, lambda: pred.forward(), reps=10, warmup=2)
        print(f"[serving] bucket 32 on {card}: {batch_ms:.2f} ms per batch "
              f"through the server ({32e3 / batch_ms:.1f} images/s; "
              f"serving.infer mean {infer.sum / infer.count / 1e3:.2f} ms, "
              f"serving.queue_wait mean {wait.sum / wait.count / 1e3:.2f} ms "
              f"over {infer.count} batches); forward alone {fwd_ms:.2f} ms "
              f"({32e3 / fwd_ms:.1f} images/s)", flush=True)
        profile_forward(torch, pred)
    finally:
        srv.close()
    return launches


def resnet50_shapes(mx, batch):
    """(symbol, the 50 BatchNorm input shapes at ``batch``, the 155
    parameter (name, shape) pairs) of ResNet-50."""
    sym = mx.models.resnet(num_classes=1000, num_layers=50,
                                      image_shape="3,224,224")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(batch, 3, 224, 224))
    shape_of = dict(zip(internals.list_outputs(), outs))
    bn = []
    for node in sym._topo():
        if not node.is_variable and node.op.name == "BatchNorm":
            inode, idx = node.inputs[0]
            bn.append(shape_of[inode.name + ("_output" if idx == 0
                                             else f"_output{idx}")])
    arg_shapes, _, _ = sym.infer_shape(data=(batch, 3, 224, 224))
    params = [(n, s) for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")]
    return sym, bn, params


def check(torch, what, got, want, rtol, atol):
    """``got`` within ``atol + rtol * |want|`` of ``want`` (``atol`` a
    number or a tensor of limits); returns the largest error."""
    err, ok = max_err(torch, got, want, rtol, atol)
    if not ok:
        fail(f"{what}: max abs err {err:g} over rtol {rtol} atol "
             f"{float(torch.as_tensor(atol).max()):g}")
    return err


def phase_train_kernels(torch, mx):
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (
        bn_act as ba, bn_act_bwd as bb, bn_stats as bs,
        sgd_mom_multi as sg, softmax_output_bwd as so)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    _sym, bn_shapes, params = resnet50_shapes(mx, TRAIN_BATCH)
    counts = {}
    for s in bn_shapes:
        counts[s] = counts.get(s, 0) + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # --- bn_stats: every path shape plus odd ones and anchor stress
    odd = [(3, 5, 7, 9), (9, 4, 3, 3), (5, 3), (2, 2048, 7, 7)]
    st_err = 0.0
    for shape in list(counts) + odd:
        for offset in (0.0, 30.0):
            c = shape[1]
            x = randn(*shape) + offset
            mm = 0.1 * randn(c)
            mv = 0.5 + torch.rand(c, generator=gen, device=dev)
            mm2, mv2, anchor = mm.clone(), mv.clone(), mm.clone()
            got = bs.bn_stats(x, mm, mv, 0.9)
            want = bs.bn_stats_plain(x, mm2, mv2, 0.9)
            dmean = float((want[0] - anchor).abs().max())
            cancel = 8 * 2.0 ** -23 * dmean ** 2
            what = f"bn_stats {shape} offset {offset}"
            st_err = max(st_err,
                         check(torch, what + " mean", got[0], want[0],
                               STAT_RTOL, STAT_ATOL),
                         check(torch, what + " var", got[1], want[1],
                               STAT_RTOL, STAT_ATOL + cancel),
                         check(torch, what + " moving_mean", mm, mm2,
                               STAT_RTOL, STAT_ATOL),
                         check(torch, what + " moving_var", mv, mv2,
                               STAT_RTOL, STAT_ATOL + cancel))
            if not offset and not torch.equal(got[2], want[2]):
                fail(f"{what}: the clamp derivative kvar differs")
    print(f"[train-kernels] bn_stats matches its plain version at "
          f"{len(counts) + len(odd)} shapes x anchor offsets 0 and 30: max "
          f"abs err {st_err:g} (rtol {STAT_RTOL}, atol {STAT_ATOL} + "
          f"8*2^-23*dmean^2 on the variance)", flush=True)

    # per-step tensors: one set per distinct shape; bn_act is held against
    # its plain version at each (the serving phase checks other shapes)
    T = {}
    ba_err = 0.0
    for s in counts:
        c = s[1]
        x = randn(*s)
        mm, mv = 0.1 * randn(c), 0.5 + torch.rand(c, generator=gen,
                                                  device=dev)
        gamma = 0.5 + torch.rand(c, generator=gen, device=dev)
        beta = 0.1 * randn(c)
        mean, var, kvar = bs.bn_stats(x, mm.clone(), mv.clone(), 0.9)
        y = ba.bn_act(x, mean, var, gamma, beta, BN_EPS, False, 0.0)
        ba_err = max(ba_err, check(
            torch, f"bn_act {s} (training shape)", y,
            ba.bn_act_plain(x, mean, var, gamma, beta, BN_EPS, False, 0.0),
            BN_RTOL, BN_ATOL))
        T[s] = dict(x=x, mm=mm, mv=mv, gamma=gamma, beta=beta, mean=mean,
                    var=var, kvar=kvar, y=y, dy=randn(*s),
                    invstd=torch.rsqrt(var + BN_EPS))

    def per_step(fn):
        def run():
            for s, mult in counts.items():
                for _ in range(mult):
                    fn(T[s])
        return run

    n_elems = sum(math.prod(s) for s in bn_shapes)
    st_ms = cuda_ms(torch, per_step(lambda t: bs.bn_stats(
        t["x"], t["mm"], t["mv"], 0.9)), reps=10)
    st_plain = cuda_ms(torch, per_step(lambda t: bs.bn_stats_plain(
        t["x"], t["mm"], t["mv"], 0.9)), reps=5)
    st_var_mean = cuda_ms(torch, per_step(lambda t: torch.var_mean(
        t["x"], (0, 2, 3), correction=0)), reps=10)
    # the one ATen call that computes a channel's mean and inverse
    # deviation in one pass (Welford): the closest yardstick
    st_lib = cuda_ms(torch, per_step(lambda t: torch.batch_norm_stats(
        t["x"], BN_EPS)), reps=10)
    st_bound, st_by = bound(n_elems * 4, 4 * n_elems)
    n_bn = len(bn_shapes)
    print(f"[train-kernels] bn_stats per step ({n_bn} launches, "
          f"{n_elems * 4 / 1e9:.3f} GB): kernel {st_ms:.4f} ms, plain "
          f"{st_plain:.4f} ms, torch.batch_norm_stats {st_lib:.4f} ms, "
          f"torch.var_mean {st_var_mean:.4f} ms, bound {st_bound:.4f} ms "
          f"({st_by}), {n_elems * 4 / st_ms / 1e9:.2f} TB/s", flush=True)

    def fwd_kernel(t):
        mean, var, _k = bs.bn_stats(t["x"], t["mm"], t["mv"], 0.9)
        return ba.bn_act(t["x"], mean, var, t["gamma"], t["beta"], BN_EPS,
                         False, 0.0)

    def fwd_plain(t):
        mean, var, _k = bs.bn_stats_plain(t["x"], t["mm"], t["mv"], 0.9)
        return ba.bn_act_plain(t["x"], mean, var, t["gamma"], t["beta"],
                               BN_EPS, False, 0.0)

    # the training forward against its plain version at every shape, each
    # side from the same moving statistics
    fw_err = 0.0
    for s, t in T.items():
        mm, mv = t["mm"].clone(), t["mv"].clone()
        got = fwd_kernel(t)
        got_mm, got_mv = t["mm"].clone(), t["mv"].clone()
        t["mm"].copy_(mm)
        t["mv"].copy_(mv)
        want = fwd_plain(t)
        fw_err = max(fw_err, check(torch, f"training forward {s}", got, want,
                                   FWD_RTOL, FWD_ATOL))
        check(torch, f"training forward {s} moving_mean", got_mm, t["mm"],
              STAT_RTOL, STAT_ATOL)
        check(torch, f"training forward {s} moving_var", got_mv, t["mv"],
              STAT_RTOL, STAT_ATOL)
    print(f"[train-kernels] bn_act matches its plain version at the "
          f"{len(T)} training shapes: max abs err {ba_err:g} (rtol {BN_RTOL}, "
          f"atol {BN_ATOL}); the training forward (bn_stats + bn_act) "
          f"matches its plain version there: max abs err {fw_err:g} (rtol "
          f"{FWD_RTOL}, atol {FWD_ATOL}), moving statistics as bn_stats",
          flush=True)

    fw_ms = cuda_ms(torch, per_step(fwd_kernel), reps=10)
    fw_plain = cuda_ms(torch, per_step(fwd_plain), reps=5)
    fw_lib = cuda_ms(torch, per_step(lambda t: F.batch_norm(
        t["x"], t["mm"], t["mv"], t["gamma"], t["beta"], training=True,
        momentum=0.1, eps=BN_EPS).relu_()), reps=10)
    fw_bound, fw_by = bound(n_elems * 12, 9 * n_elems)
    print(f"[train-kernels] training BatchNorm+ReLU forward per step "
          f"(bn_stats + bn_act, {2 * n_bn} launches): kernels {fw_ms:.4f} ms, plain "
          f"{fw_plain:.4f} ms, F.batch_norm(training=True)+relu_ "
          f"{fw_lib:.4f} ms, bound {fw_bound:.4f} ms ({fw_by})", flush=True)

    # --- bn_act_bwd: every path shape (relu, batch statistics) plus odd
    # shapes, fix_gamma, no ReLU and use_global_stats
    bw_err = 0.0
    cases = [(s, True, False, True) for s in counts]
    for s in odd:
        cases += [(s, True, True, True), (s, False, False, True),
                  (s, True, False, False)]
    for s, relu, fix_gamma, batch_stats in cases:
        t = T.get(s)
        if t is None:
            c = s[1]
            x = randn(*s)
            mean, var, kvar = bs.bn_stats(x, torch.zeros(c, device=dev),
                                          torch.ones(c, device=dev), 0.9)
            gamma = 0.5 + torch.rand(c, generator=gen, device=dev)
            t = dict(x=x, mean=mean, var=var, kvar=kvar, gamma=gamma,
                     y=torch.relu(x), dy=randn(*s))
        args = (t["dy"], t["y"] if relu else None, t["x"], t["mean"],
                t["var"], t["gamma"], t["kvar"] if batch_stats else None,
                BN_EPS, fix_gamma, 0.0 if relu else None)
        got, want = bb.bn_act_bwd(*args), bb.bn_act_bwd_plain(*args)
        n = math.prod(s) // s[1]
        what = f"bn_act_bwd {s} relu={relu} fix_gamma={fix_gamma} " \
               f"batch_stats={batch_stats}"
        bw_err = max(bw_err, check(torch, what + " dx", got[0], want[0],
                                   DX_RTOL, DX_ATOL))
        for name, g, w in (("dgamma", got[1], want[1]),
                           ("dbeta", got[2], want[2])):
            check(torch, f"{what} {name}", g, w, DX_RTOL, n * 2.0 ** -24)
    print(f"[train-kernels] bn_act_bwd matches its plain version in "
          f"{len(cases)} cases: max abs err on dx {bw_err:g} (rtol {DX_RTOL}, "
          f"atol {DX_ATOL}; channel sums atol n*2^-24)", flush=True)

    def bwd_lib(t):
        dyp = torch.ops.aten.threshold_backward(t["dy"], t["y"], 0)
        torch.ops.aten.native_batch_norm_backward(
            dyp, t["x"], t["gamma"], None, None, t["mean"], t["invstd"],
            True, BN_EPS, [True, True, True])

    bw_ms = cuda_ms(torch, per_step(lambda t: bb.bn_act_bwd(
        t["dy"], t["y"], t["x"], t["mean"], t["var"], t["gamma"], t["kvar"],
        BN_EPS, False, 0.0)), reps=10)
    bw_plain = cuda_ms(torch, per_step(lambda t: bb.bn_act_bwd_plain(
        t["dy"], t["y"], t["x"], t["mean"], t["var"], t["gamma"], t["kvar"],
        BN_EPS, False, 0.0)), reps=5)
    bw_lib = cuda_ms(torch, per_step(bwd_lib), reps=10)
    bw_bound, bw_by = bound(n_elems * 16, 12 * n_elems)
    launches = sum(bb.plan_for(T[s]["x"]).launches * k
                   for s, k in counts.items())
    print(f"[train-kernels] bn_act_bwd per step ({launches} launches; "
          f"one-pass minimum {n_elems * 16 / 1e9:.3f} GB at 16 bytes per "
          f"element, {n_elems * 16 / bw_ms / 1e9:.2f} TB/s at that count): "
          f"kernel {bw_ms:.4f} ms, plain {bw_plain:.4f} ms, "
          f"native_batch_norm_backward+threshold_backward {bw_lib:.4f} ms, "
          f"bound {bw_bound:.4f} ms ({bw_by})", flush=True)
    T.clear()

    # --- softmax_output_bwd
    so_err = 0.0
    for shape, kw in [((32, 1000), {}),
                      ((32, 1000), {"normalization": "batch",
                                    "grad_scale": 0.5}),
                      ((7, 11), {"normalization": "valid", "use_ignore": True,
                                 "ignore_label": 3.0}),
                      ((2, 5, 3, 4), {"multi_output": True,
                                      "normalization": "valid"}),
                      ((2, 3, 7), {"use_ignore": True, "ignore_label": 0.0})]:
        multi = kw.get("multi_output", False)
        classes = shape[1] if multi else shape[-1]
        lshape = (shape[0],) + shape[2:] if multi else shape[:-1]
        p = torch.softmax(3 * randn(*shape), dim=1 if multi else -1)
        label = torch.randint(0, classes, lshape, generator=gen,
                              device=dev).float()
        got = so.softmax_output_bwd(p, label, **kw)
        want = so.softmax_output_bwd_plain(
            p, label, kw.get("grad_scale", 1.0), kw.get("ignore_label", -1.0),
            kw.get("use_ignore", False), kw.get("normalization", "null"),
            multi)
        so_err = max(so_err, check(torch, f"softmax_output_bwd {shape} {kw}",
                                   got, want, 0.0, EXACT_ATOL))
    p = torch.softmax(3 * randn(*PATH_SOFTMAX), dim=-1)
    label = torch.randint(0, 1000, (32,), generator=gen, device=dev).float()
    so_ms = cuda_ms(torch, lambda: so.softmax_output_bwd(p, label), reps=100)
    so_plain = cuda_ms(torch, lambda: so.softmax_output_bwd_plain(
        p, label, 1.0, -1.0, False, "null", False), reps=100)
    so_bound, so_by = bound(2 * p.numel() * 4 + 32 * 4, 2 * p.numel())
    print(f"[train-kernels] softmax_output_bwd matches its plain version in 5 "
          f"cases: max abs err {so_err:g} (atol {EXACT_ATOL}); at (32, 1000): "
          f"kernel {so_ms:.4f} ms, plain {so_plain:.4f} ms, no library call, "
          f"bound {so_bound * 1e3:.3f} us ({so_by})", flush=True)

    # --- sgd_mom_multi over ResNet-50's 155 parameters
    def sgd_set():
        ws = [randn(*s) * 0.05 for _n, s in params]
        gs = [randn(*s) * 0.01 for _n, s in params]
        ms = [randn(*s) * 0.001 for _n, s in params]
        return ws, gs, ms

    names = [n for n, _s in params]
    lrs = [0.1] * len(names)
    wds = [0.0 if not n.endswith(("_weight", "_gamma")) else 1e-4
           for n in names]
    sg_err = 0.0
    ws, gs, ms = sgd_set()
    for momentum, clip in ((0.9, -1.0), (0.9, 0.005), (0.0, -1.0)):
        w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
        moms = ms if momentum else None
        sg.sgd_mom_multi(ws, gs, moms, lrs, wds, momentum, 1 / 32, clip)
        sg.sgd_mom_multi_plain(w2, gs, m2 if momentum else None, lrs, wds,
                               momentum, 1 / 32, clip)
        for got, want in zip(ws + (ms if momentum else []),
                             w2 + (m2 if momentum else [])):
            sg_err = max(sg_err, check(torch, f"sgd_mom_multi momentum="
                                       f"{momentum} clip={clip}", got, want,
                                       0.0, EXACT_ATOL))
    # the guard: a NaN gradient skips the step, restores the statistics
    aux = torch.ones(26560, device=dev)
    snap = torch.zeros_like(aux)
    guard = sg.Guard(torch.zeros(2, dtype=torch.int32, device=dev),
                     [(aux, snap)])
    w0, m0 = [t.clone() for t in ws], [t.clone() for t in ms]
    big = max(range(len(gs)), key=lambda i: gs[i].numel())
    gs[big].view(-1)[7] = float("nan")
    sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0, guard=guard)
    torch.cuda.synchronize()
    if guard.counters.tolist() != [1, 1] or not torch.equal(aux, snap) or \
            any(not torch.equal(a, b) for a, b in zip(ws + ms, w0 + m0)):
        fail(f"sgd_mom_multi guard: counters {guard.counters.tolist()}, the "
             f"step was not skipped or the statistics not restored")
    gs[big].view(-1)[7] = 0.0
    aux.fill_(2.0)
    sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0, guard=guard)
    if guard.counters.tolist() != [1, 0] or not bool((aux == 2).all()):
        fail(f"sgd_mom_multi guard after a finite step: counters "
             f"{guard.counters.tolist()}")
    cache = {}
    builds = sg.PACK_BUILDS.value
    sg_ms = cuda_ms(torch, lambda: sg.sgd_mom_multi(
        ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0, cache=cache), reps=50)
    if sg.PACK_BUILDS.value != builds + 1:
        fail(f"sgd_mom_multi packed its launch parameters "
             f"{sg.PACK_BUILDS.value - builds} times for unmoved tensors")
    sg_plain = cuda_ms(torch, lambda: sg.sgd_mom_multi_plain(
        ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0), reps=5)
    tparams = [torch.nn.Parameter(w) for w in ws]
    for p_, g in zip(tparams, gs):
        p_.grad = g
    topt = torch.optim.SGD(tparams, lr=0.1, momentum=0.9, weight_decay=1e-4,
                           fused=True)
    sg_lib = cuda_ms(torch, topt.step, reps=50)
    numel = sum(math.prod(s) for _n, s in params)
    sg_bound, sg_by = bound(20 * numel, 6 * numel)
    print(f"[train-kernels] sgd_mom_multi matches its plain version over "
          f"{len(params)} tensors ({numel / 1e6:.2f} M values) x momentum/clip: "
          f"max abs err {sg_err:g} (atol {EXACT_ATOL}); a NaN gradient under "
          f"the guard skips the step and restores the statistics, counters "
          f"[1, 1] then [1, 0]; per step: kernel {sg_ms:.4f} ms (1 launch, "
          f"packed once), plain {sg_plain:.4f} ms, "
          f"torch.optim.SGD(fused=True).step {sg_lib:.4f} ms (other "
          f"semantics, a yardstick), bound {sg_bound:.4f} ms ({sg_by})",
          flush=True)
    return [
        {"name": "bn_stats", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/bn_stats.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:425",
         "max_abs_err": st_err, "ms": st_ms, "plain_ms": st_plain,
         "bound_ms": st_bound, "bound_by": st_by, "library_ms": st_lib,
         "library": "torch.batch_norm_stats",
         "library_var_mean_ms": st_var_mean,
         "train_forward_max_abs_err": fw_err,
         "train_forward_ms": fw_ms, "train_forward_plain_ms": fw_plain,
         "train_forward_library_ms": fw_lib,
         "train_forward_bound_ms": fw_bound},
        {"name": "bn_act_bwd", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/bn_act_bwd.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:380",
         "max_abs_err": bw_err, "ms": bw_ms, "plain_ms": bw_plain,
         "bound_ms": bw_bound, "bound_by": bw_by, "library_ms": bw_lib},
        {"name": "softmax_output_bwd", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/softmax_output_bwd.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:718",
         "max_abs_err": so_err, "ms": so_ms, "plain_ms": so_plain,
         "bound_ms": so_bound, "bound_by": so_by, "library_ms": None},
        {"name": "sgd_mom_multi", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/sgd_mom_multi.cu",
         "replaces": "mxnet_tpu/executor.py:1606",
         "max_abs_err": sg_err, "ms": sg_ms, "plain_ms": sg_plain,
         "bound_ms": sg_bound, "bound_by": sg_by, "library_ms": sg_lib},
    ], ba_err


# the redesigned kernels' shapes on the main paths
SM_PATHS = {"ssd_train": (259072, 21), "lstm_head": (1024, 10000),
            "resnet": PATH_SOFTMAX}
# softmax_rows' regime borders (narrow <= 32 < middle <= 4096 < wide), a
# row past 48 KB and one past the card's shared memory (the loop)
SM_BORDERS = (1, 2, 21, 31, 32, 33, 1000, 4096, 4097, 10000, 14000, 60000)
FLUSH_BYTES = 256 << 20  # overwritten between cold launches (L2: 50 MB)


def cold_ms(torch, fn, flush, reps=15):
    """Median ms of single calls of ``fn``, each after ``flush`` was
    overwritten (the L2 cache cold), each timed by its own CUDA events.
    The overwrite keeps the card busy ~80 us, so a wrapper whose host path
    is shorter enqueues the timed call behind it; a longer host path shows
    in the reading as a gap."""
    import statistics

    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def host_us(torch, fn, reps=100):
    """Host microseconds per call of ``fn`` back to back with no
    synchronisation: the wrapper's launch path on the host, the card's work
    left queued."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def ssd_param_shapes(mx):
    """The 70 parameter shapes of SSD-VGG16 (20 classes, 300x300)."""
    sym = mx.models.ssd.get_symbol(num_classes=SSD_CLASSES,
                                   data_shape=SSD_SHAPE)
    shapes, _, _ = sym.infer_shape(data=(1, 3, SSD_SHAPE, SSD_SHAPE))
    return [s for n, s in zip(sym.list_arguments(), shapes) if n != "data"]


def sgd_inputs(torch, gen, dev, shapes):
    """Weights, gradients and momenta of ``shapes``; lr 0.1, wd 1e-4 on
    the tensors of rank > 1."""
    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ws = [randn(s, 0.05) for s in shapes]
    gs = [randn(s, 0.01) for s in shapes]
    ms = [randn(s, 0.001) for s in shapes]
    return ws, gs, ms, [0.1] * len(shapes), [
        1e-4 if len(s) > 1 else 0.0 for s in shapes]


def device_ms(torch, fn, marks, reps=10):
    """Device milliseconds per call of ``fn`` under ``torch.profiler``:
    the self time of the kernels whose names hold one of ``marks``."""
    return sum(kernel_split(torch, fn, marks, reps).values())


def timed(torch, fn, plain, library, flush, marks, reps, plain_reps=10):
    """The readings of one kernel call ``fn``: warm by CUDA events back to
    back, cold (median single call after ``flush``), its device time under
    the profiler, the plain version, the library call warm and cold, and
    the wrapper's host microseconds per call."""
    return {"ms": cuda_ms(torch, fn, reps=reps),
            "cold_ms": cold_ms(torch, fn, flush),
            "device_ms": device_ms(torch, fn, marks),
            "plain_ms": cuda_ms(torch, plain, reps=plain_reps, warmup=1),
            "library_ms": cuda_ms(torch, library, reps=reps),
            "library_cold_ms": cold_ms(torch, library, flush),
            "host_us": host_us(torch, fn)}


def bn_bwd_inputs(torch, gen, dev, shape, slope):
    """A BatchNorm backward's tensors at ``shape``: the head gradient, x,
    its batch statistics (``kvar`` 1), gamma, the output ``y`` of the
    (leaky) ReLU and the inverse deviation for ATen's backward."""
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev)
    axes = (0,) + tuple(range(2, len(shape)))
    var, mean = torch.var_mean(x, axes, correction=0)
    gamma = 0.5 + torch.rand(c, generator=gen, device=dev)
    y = torch.where(x > 0, x, slope * x)
    return dict(dy=torch.randn(shape, generator=gen, device=dev), x=x, y=y,
                mean=mean, var=var, kvar=torch.ones(c, device=dev),
                gamma=gamma, invstd=torch.rsqrt(var + BN_EPS))


def kernel_times(torch, mx):
    """The redesigned kernels at their main-path shapes: the kernel back to
    back by CUDA events (warm), single calls with the L2 cache cold
    (median), the device time under the profiler (``bn_act_bwd``,
    ``lstm_cell``), the plain version, one PyTorch call for the same
    function both ways, the bound, and the wrapper's host microseconds per
    call: ``softmax_rows`` and ``sgd_mom_multi`` at their path shapes;
    ``lstm_cell``/``lstm_cell_bwd`` at the LSTM's (32, 4x200);
    ``bn_act_bwd`` over ResNet-50's 12 training shapes at batch 32, each
    as often as a step runs it (ReLU, batch statistics), and over one
    DCGAN D pass (the three leaky shapes at batch 64, fix_gamma). Returns
    ``{kernel: {path: readings}}``. Uses only the wrappers' public calls,
    so it times any checkout's package (``--kernel-times``)."""
    from mxnet_tpu_torch.kernels import bn_act_bwd as bb
    from mxnet_tpu_torch.kernels import lstm_cell as lc
    from mxnet_tpu_torch.kernels import sgd_mom_multi as sg
    from mxnet_tpu_torch.kernels import softmax_rows as sm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {"softmax_rows": {}, "sgd_mom_multi": {}, "lstm_cell": {},
           "lstm_cell_bwd": {}, "bn_act_bwd": {}}
    for path, shape in SM_PATHS.items():
        x = 4.0 * torch.randn(shape, generator=gen, device=dev)
        n = math.prod(shape)
        b_ms, b_by = bound(2 * n * 4, 4 * n)
        reps = 200 if n < 1e6 else 50
        out["softmax_rows"][path] = {
            "what": f"{shape}", "library": "torch.softmax",
            "ms": cuda_ms(torch, lambda: sm.softmax_rows(x), reps=reps),
            "cold_ms": cold_ms(torch, lambda: sm.softmax_rows(x), flush),
            "plain_ms": cuda_ms(torch, lambda: sm.softmax_rows_plain(x),
                                reps=20),
            "library_ms": cuda_ms(torch, lambda: torch.softmax(x, 1),
                                  reps=reps),
            "library_cold_ms": cold_ms(torch, lambda: torch.softmax(x, 1),
                                       flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "host_us": host_us(torch, lambda: sm.softmax_rows(x))}
        del x
    _sym, bn_shapes, rparams = resnet50_shapes(mx, TRAIN_BATCH)
    for path, shapes in (("resnet", [s for _n, s in rparams]),
                         ("ssd_train", ssd_param_shapes(mx))):
        ws, gs, ms, lrs, wds = sgd_inputs(torch, gen, dev, shapes)
        cache = {}

        def run():
            sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0,
                             cache=cache)

        tparams = [torch.nn.Parameter(w) for w in ws]
        for tp, g in zip(tparams, gs):
            tp.grad = g
        topt = torch.optim.SGD(tparams, lr=0.1, momentum=0.9,
                               weight_decay=1e-4, fused=True)
        numel = sum(w.numel() for w in ws)
        b_ms, b_by = bound(20 * numel, 6 * numel)
        out["sgd_mom_multi"][path] = {
            "what": f"{len(ws)} tensors, {numel / 1e6:.2f} M values",
            "library": "torch.optim.SGD(fused=True).step",
            "ms": cuda_ms(torch, run, reps=50),
            "cold_ms": cold_ms(torch, run, flush),
            "plain_ms": cuda_ms(torch, lambda: sg.sgd_mom_multi_plain(
                ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0), reps=3, warmup=1),
            "library_ms": cuda_ms(torch, topt.step, reps=50),
            "library_cold_ms": cold_ms(torch, topt.step, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "host_us": host_us(torch, run)}
        del ws, gs, ms, tparams, topt

    # --- the LSTM cell at the path's (32, 4 x 200), forget bias 1
    n, h = LSTM_BATCH, LSTM["num_hidden"]
    i2h = 2 * torch.randn(n, 4 * h, generator=gen, device=dev)
    h2h = 2 * torch.randn(n, 4 * h, generator=gen, device=dev)
    c, dh, dc = (torch.randn(n, h, generator=gen, device=dev)
                 for _ in range(3))
    bias, zero = torch.zeros(4 * h, device=dev), torch.zeros(4 * h,
                                                             device=dev)
    bias[h:2 * h] = 1.0
    fused = torch.ops.aten._thnn_fused_lstm_cell
    hy, cy, ws_ = fused(i2h, h2h, c, bias, zero)
    _h, next_c, act = lc.lstm_cell_plain(i2h, h2h, c, 1.0)
    b_ms, b_by = bound(15 * n * h * 4, 25 * n * h)
    out["lstm_cell"]["lstm_ptb"] = {
        "what": f"({n}, 4x{h})", "library": "_thnn_fused_lstm_cell",
        "bound_ms": b_ms, "bound_by": b_by, **timed(
            torch, lambda: lc.lstm_cell(i2h, h2h, c, 1.0),
            lambda: lc.lstm_cell_plain(i2h, h2h, c, 1.0),
            lambda: fused(i2h, h2h, c, bias, zero), flush,
            ("lstm_cell_kernel",), reps=200)}
    b_ms, b_by = bound(13 * n * h * 4, 30 * n * h)
    out["lstm_cell_bwd"]["lstm_ptb"] = {
        "what": f"({n}, 4x{h})",
        "library": "_thnn_fused_lstm_cell_backward_impl",
        "bound_ms": b_ms, "bound_by": b_by, **timed(
            torch, lambda: lc.lstm_cell_bwd(dh, dc, act, c, next_c),
            lambda: lc.lstm_cell_bwd_plain(dh, dc, act, c, next_c),
            lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                dh, dc, c, cy, ws_, True), flush,
            ("lstm_cell_bwd_kernel",), reps=200)}
    del i2h, h2h, c, dh, dc, hy, cy, ws_, next_c, act

    # --- bn_act_bwd: ResNet-50's training shapes, a step's worth, and one
    # DCGAN D pass
    counts = {}
    for s in bn_shapes:
        counts[s] = counts.get(s, 0) + 1
    for path, shapes, slope, eps, fix_gamma, lib_act in (
            ("resnet", counts, 0.0, BN_EPS, False, "threshold_backward"),
            ("dcgan_d", {s: 1 for s in DCGAN_D_BN}, DCGAN_SLOPE, DCGAN_EPS,
             True, "leaky_relu_backward")):
        T = [(bn_bwd_inputs(torch, gen, dev, s, slope), k)
             for s, k in shapes.items()]

        def each(fn, T=T):
            def run():
                for t, k in T:
                    for _ in range(k):
                        fn(t)
            return run

        def kern(t, slope=slope, eps=eps, fix_gamma=fix_gamma):
            return bb.bn_act_bwd(t["dy"], t["y"], t["x"], t["mean"],
                                 t["var"], t["gamma"], t["kvar"], eps,
                                 fix_gamma, slope)

        def plain(t, slope=slope, eps=eps, fix_gamma=fix_gamma):
            return bb.bn_act_bwd_plain(t["dy"], t["y"], t["x"], t["mean"],
                                       t["var"], t["gamma"], t["kvar"], eps,
                                       fix_gamma, slope)

        def lib(t, slope=slope, eps=eps, lib_act=lib_act):
            if lib_act == "threshold_backward":
                dyp = torch.ops.aten.threshold_backward(t["dy"], t["y"], 0)
            else:
                dyp = torch.ops.aten.leaky_relu_backward(t["dy"], t["y"],
                                                         slope, True)
            return torch.ops.aten.native_batch_norm_backward(
                dyp, t["x"], t["gamma"], None, None, t["mean"],
                t["invstd"], True, eps, [True, True, True])

        n_el = sum(k * math.prod(s) for s, k in shapes.items())
        c_sum = sum(k * s[1] for s, k in shapes.items())
        calls = sum(shapes.values())
        b_ms, b_by = bound(n_el * 16 + c_sum * 24, 13 * n_el)
        r = out["bn_act_bwd"][path] = {
            "what": f"{calls} calls over {len(shapes)} shapes, "
                    f"{n_el / 1e6:.2f} M elements, slope {slope}",
            "library": f"native_batch_norm_backward + {lib_act}",
            "elements": n_el, "calls": calls,
            "bound_ms": b_ms, "bound_by": b_by, **timed(
                torch, each(kern), each(plain), each(lib), flush,
                ("bn_bwd_",), reps=10, plain_reps=3)}
        r["host_us"] /= calls  # per wrapper call; the times are per set
        T.clear()
    del flush
    return out


def print_kernel_times(times, card, tag):
    for name, paths in times.items():
        for path, r in paths.items():
            dev = (f"; device {r['device_ms']:.4f} ms" if "device_ms" in r
                   else "")
            print(f"[{tag}] {name} {path} {r['what']} on {card}: kernel "
                  f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} ms cold "
                  f"({100 * r['bound_ms'] / r['cold_ms']:.0f}% of the "
                  f"bound){dev}; plain {r['plain_ms']:.4f} ms; "
                  f"{r['library']} {r['library_ms']:.4f} ms warm, "
                  f"{r['library_cold_ms']:.4f} ms cold; bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); wrapper host "
                  f"{r['host_us']:.1f} us per call", flush=True)


def bn_bwd_borders(bb, dev):
    """``bn_act_bwd``'s border shapes on this card: each side of the block
    limit, of the target's cluster limit and of what a cluster holds (N =
    1, C = 3, the plane m long), two-phase planes a multiple of 4 long (N =
    1 and N = 9, two splits), planes of 49 and 16, C = 3 with N = 1, and a
    cluster regime over images."""
    smem, cluster = bb.device_limits(dev.index or 0)
    cap, limit = bb.block_elems(smem), bb.block_limit(smem)
    return [(1, 3, limit - 4), (1, 3, limit), (1, 3, limit + 1),
            (1, 3, limit + 4), (1, 3, cluster * limit + 1),
            (1, 3, cluster * cap - 1), (1, 3, cluster * cap),
            (1, 3, cluster * cap + 1), (1, 3, cluster * cap + 4),
            (9, 2, -(-cluster * cap // 9 // 4) * 4 + 4), (2, 3, 7, 7),
            (4, 5, 4, 4), (1, 3, 5, 5), (3, 7, 1, 1), (8, 6, 57, 64)]


def phase_redesign_bn_lstm(torch, mx):
    """The redesigned ``bn_act_bwd`` against its plain version at every
    regime border (:func:`bn_bwd_borders`) and on views at a float offset of
    1 and 3 (4-byte accesses), for no activation, the ReLU and the leaky
    ReLU, with and without batch statistics, with and without fix_gamma
    (``DX_RTOL``/``DX_ATOL``; the sums ``DX_RTOL`` and ``m * 2**-24``):
    each call's launches as planned, two calls bit for bit the same, a
    zero dx's sign as the plain version's where dx is g * invstd * dy'; and
    ``lstm_cell``'s three outputs views of one allocation."""
    from mxnet_tpu_torch.kernels import bn_act_bwd as bb
    from mxnet_tpu_torch.kernels import lstm_cell as lc

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    t0 = time.perf_counter()
    err, cases, regimes = 0.0, 0, {}
    shapes = [(s, 0) for s in bn_bwd_borders(bb, dev)]
    limit = bb.block_limit(bb.device_limits(0)[0])
    shapes += [(s, off) for s in ((4, 6, 8, 8), (1, 3, 3 * limit))
               for off in (1, 3)]
    for shape, offset in shapes:
        c = shape[1]
        n_el = math.prod(shape)

        def big(scale=1.0, shift=0.0):
            flat = torch.randn(n_el + offset, generator=gen, device=dev)
            return (flat[offset:] * scale + shift).view(shape)

        x, dy = big(1.5, 0.3), big()
        t = x - 0.3
        t.view(-1)[::5] = 0.0  # where the gradient is the slope's
        stats = (0.1 * torch.randn(c, generator=gen, device=dev),
                 0.5 + torch.rand(c, generator=gen, device=dev),
                 0.5 + torch.rand(c, generator=gen, device=dev),
                 torch.tensor([1.0, 0.5, 0.0] * c, device=dev)[:c])
        p = bb.plan_for(x)
        regimes[p.regime] = regimes.get(p.regime, 0) + 1
        m = n_el // c
        for slope in (None, 0.0, DCGAN_SLOPE):
            if slope is None:
                y = None
            else:
                y = big()
                y.copy_(torch.where(t > 0, t, slope * t))
            for batch_stats in (True, False):
                for fix_gamma in (False, True):
                    args = (dy, y, x, *stats[:3],
                            stats[3] if batch_stats else None, BN_EPS,
                            fix_gamma, slope)
                    what = (f"bn_act_bwd {shape} offset {offset} slope "
                            f"{slope} batch_stats={batch_stats} "
                            f"fix_gamma={fix_gamma} ({p.regime}, cluster "
                            f"{p.cluster})")
                    before = bb.LAUNCHES.value, bb.LEAKY_LAUNCHES.value
                    got = bb.bn_act_bwd(*args)
                    if (bb.LAUNCHES.value - before[0],
                            bb.LEAKY_LAUNCHES.value - before[1]) != (
                            p.launches, p.launches if slope else 0):
                        fail(f"{what}: {bb.LAUNCHES.value - before[0]} "
                             f"launches, planned {p.launches}")
                    again = bb.bn_act_bwd(*args)
                    want = bb.bn_act_bwd_plain(*args)
                    err = max(err, check(torch, what + " dx", got[0],
                                         want[0], DX_RTOL, DX_ATOL))
                    for name, g, w in (("dgamma", got[1], want[1]),
                                       ("dbeta", got[2], want[2])):
                        check(torch, f"{what} {name}", g, w, DX_RTOL,
                              m * 2.0 ** -24)
                    if any(not torch.equal(a, b) for a, b in zip(got,
                                                                 again)):
                        fail(f"{what}: two calls differ")
                    if fix_gamma and bool(got[1].any()):
                        fail(f"{what}: dgamma not 0 under fix_gamma")
                    zeros = want[0] == 0
                    if not batch_stats and not torch.equal(
                            torch.signbit(got[0][zeros]),
                            torch.signbit(want[0][zeros])):
                        fail(f"{what}: a zero dx of the other sign")
                    cases += 1
    print(f"[redesign] bn_act_bwd matches its plain version in {cases} "
          f"cases ({len(shapes)} shapes at the regime borders and at float "
          f"offsets 1 and 3 x no activation, ReLU, leaky x batch or global "
          f"statistics x fix_gamma; plans {regimes}): max abs err on dx "
          f"{err:g} (rtol {DX_RTOL}, atol {DX_ATOL}; sums atol m*2^-24), "
          f"launches as planned, repeated calls bit for bit "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    n, h = LSTM_BATCH, LSTM["num_hidden"]
    i2h = torch.randn(n, 4 * h, generator=gen, device=dev)
    c = torch.randn(n, h, generator=gen, device=dev)
    outs = lc.lstm_cell(i2h, i2h, c, 1.0)
    base = outs[0].data_ptr()
    if [t.data_ptr() - base for t in outs] != [0, 4 * n * h, 8 * n * h] or \
            not all(t.is_contiguous() for t in outs):
        fail("lstm_cell's outputs are not contiguous views of one buffer")
    lstm_err = max(check(torch, "lstm_cell (one buffer)", g, w, LSTM_RTOL,
                         LSTM_ATOL)
                   for g, w in zip(outs, lc.lstm_cell_plain(i2h, i2h, c,
                                                            1.0)))
    print(f"[redesign] lstm_cell's next_h, next_c and gates are contiguous "
          f"views of one allocation and match the plain version: max abs "
          f"err {lstm_err:g}", flush=True)
    return err


def host_breakdown(torch):
    """Host microseconds of each piece of ``lstm_cell``'s launch path at
    (32, 4x200), each timed alone over many repetitions: the pieces of the
    earlier heavy path (three ``check_f32``, three ``torch.empty_like``, the
    ``torch.cuda.device`` context, a ``Stream`` object for the handle) and
    of the light path (one compound check, one allocation cut into three
    views, ``library()``, the packed ctypes call through
    ``_lib.launch_packed`` with its kernel launch, the counter), and the
    whole wrapper; then ``bn_act_bwd``'s pieces at DCGAN's (64, 512, 4, 4)."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.kernels import _lib
    from mxnet_tpu_torch.kernels import lstm_cell as lc

    dev = torch.device("cuda", 0)
    n, h = LSTM_BATCH, LSTM["num_hidden"]
    i2h = torch.randn(n, 4 * h, device=dev)
    h2h = torch.randn(n, 4 * h, device=dev)
    c = torch.randn(n, h, device=dev)
    lib = _lib.library()
    outs = lc.cell_outputs(i2h, n, h, True)
    f32 = torch.float32

    def check_f32():
        _lib.check_f32("i2h", i2h, dev)
        _lib.check_f32("h2h", h2h, dev, i2h.shape)
        _lib.check_f32("c_prev", c, dev, (n, h))

    def empty3():
        return (torch.empty_like(c), torch.empty_like(c),
                torch.empty_like(i2h))

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def compound():
        d = i2h.get_device()
        return (i2h.dtype is f32 and h2h.dtype is f32 and c.dtype is f32
                and i2h.is_contiguous() and h2h.is_contiguous()
                and c.is_contiguous() and h2h.get_device() == d
                and c.get_device() == d and h2h.shape == i2h.shape
                and c.shape == (n, h))

    def ctypes_launch():
        return _lib.launch_packed(
            i2h, lib.mxt_lstm_cell_f32, lc._PACK_FWD, i2h.data_ptr(),
            h2h.data_ptr(), c.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), n, h, 1.0)

    pieces = {
        "before: 3 check_f32": check_f32,
        "before: 3 torch.empty_like": empty3,
        "before: torch.cuda.device context": device_ctx,
        "before: stream_of (a Stream object)": lambda: _lib.stream_of(i2h),
        "light: compound check": compound,
        "light: one allocation, 3 views":
            lambda: lc.cell_outputs(i2h, n, h, True),
        "light: library()": _lib.library,
        "light: packed ctypes call through _lib.launch_packed (+ launch)":
            ctypes_launch,
        "light: counter": tm.counter("chip_smoke.host_breakdown").inc,
        "light: the allocation alone":
            lambda: i2h.new_empty((6 * n, h)),
        "the wrapper lstm_cell": lambda: lc.lstm_cell(i2h, h2h, c, 1.0),
        "the wrapper lstm_cell_bwd": lambda: lc.lstm_cell_bwd(
            c, c, outs[2], c, outs[1]),
    }
    out = {name: host_us(torch, fn, reps=2000) for name, fn in pieces.items()}
    print("[redesign] lstm_cell's host path at (32, 4x200), us per call: " +
          "; ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)

    # bn_act_bwd's at DCGAN's (64, 512, 4, 4), leaky, batch statistics
    from mxnet_tpu_torch.kernels import bn_act_bwd as bb

    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    t = bn_bwd_inputs(torch, gen, dev, DCGAN_D_BN[-1], DCGAN_SLOPE)
    x, dy, y = t["x"], t["dy"], t["y"]
    stats = (t["mean"], t["var"], t["gamma"], t["kvar"])
    cc = x.shape[1]
    p = bb.plan_for(x)
    res = bb.bn_act_bwd(dy, y, x, *stats, DCGAN_EPS, True, DCGAN_SLOPE)

    def bn_check():
        d = x.get_device()
        ok = (x.dtype is f32 and dy.dtype is f32 and x.is_contiguous()
              and dy.is_contiguous() and dy.get_device() == d
              and dy.shape == x.shape and y.dtype is f32
              and y.is_contiguous() and y.get_device() == d
              and y.shape == x.shape)
        for s_ in stats:
            ok = ok and (s_.dtype is f32 and s_.is_contiguous()
                         and s_.get_device() == d and s_.shape == (cc,))
        return ok

    def bn_alloc():
        return torch.empty_like(x), x.new_empty((2, cc)).unbind(0)

    bn_pieces = {
        "compound check": bn_check,
        "allocations (dx, one (2, C) buffer, 2 views)": bn_alloc,
        "plan() and device_limits()": lambda: bb.plan(
            *x.shape[:2], 16, *bb.device_limits(0)),
        "run_plan (packed ctypes call + kernel launch, counters)":
            lambda: bb.run_plan(p, dy, y, x, *stats, DCGAN_EPS, True,
                                DCGAN_SLOPE, *res),
        "the wrapper bn_act_bwd": lambda: bb.bn_act_bwd(
            dy, y, x, *stats, DCGAN_EPS, True, DCGAN_SLOPE),
    }
    for name, fn in bn_pieces.items():
        out["bn_act_bwd: " + name] = host_us(torch, fn, reps=2000)
    print(f"[redesign] bn_act_bwd's host path at {tuple(x.shape)} (leaky), "
          f"us per call: " + "; ".join(
              f"{k} {out['bn_act_bwd: ' + k]:.2f}" for k in bn_pieces),
          flush=True)
    return out


def phase_redesign(torch, mx, card):
    """The redesigned ``softmax_rows`` and ``sgd_mom_multi`` against their
    plain versions on their edges: ``softmax_rows`` at every regime border
    and the three path shapes, on aligned tensors and on views at a float
    offset of 1, 2 and 3, each value within ``SM_ATOL`` and ``SM_RTOL``,
    also on unit-scale inputs once per regime; ``sgd_mom_multi`` bit for
    bit over
    sizes that are no multiple of 4, over views whose offset breaks the
    16-byte alignment, over a list longer than one launch holds, and under
    the guard's skip and restore; no host-to-device copy in a call; then
    :func:`kernel_times`."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.kernels import sgd_mom_multi as sg
    from mxnet_tpu_torch.kernels import softmax_rows as sm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    t0 = time.perf_counter()
    sm_err, sm_rel, cases = 0.0, 0.0, 0
    shapes = [(5, c) for c in SM_BORDERS] + [(517, c) for c in (2, 21, 32)] \
        + list(SM_PATHS.values())
    # scale 4 spreads each row's probabilities over decades; scale 1 keeps
    # them near 1/C, one case per regime
    cases_ = [(rows, cols, offset, 4.0) for rows, cols in shapes
              for offset in (0, 1, 2, 3) if not offset or rows * cols <= 4e6]
    cases_ += [(rows, cols, offset, 1.0) for rows, cols in
               ((517, 21), (64, 1000), (8, 10000), (2, 60000))
               for offset in (0, 1)]
    for rows, cols, offset, scale in cases_:
        base = scale * torch.randn(rows * cols + offset, generator=gen,
                                   device=dev)
        x = base[offset:].view(rows, cols)
        err, rel = sm_check(torch, f"softmax_rows ({rows}, {cols}) at a float "
                            f"offset of {offset}, scale {scale}",
                            sm.softmax_rows(x), sm.softmax_rows_plain(x))
        sm_err, sm_rel = max(sm_err, err), max(sm_rel, rel)
        cases += 1
    print(f"[redesign] softmax_rows matches its plain version in {cases} "
          f"cases (columns {SM_BORDERS}, the path shapes, float offsets "
          f"0-3, inputs at scale 4 and 1): max abs err {sm_err:g} (atol "
          f"{SM_ATOL}), max rel err {sm_rel:g} (rtol {SM_RTOL})", flush=True)

    def equal(what, got, want):
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"sgd_mom_multi {what}: not bit for bit its plain version")

    sizes = [1, 3, 5, 4097, 70001, 8191, 2, 40000]
    for momentum, clip in ((0.9, -1.0), (0.9, 0.005), (0.0, -1.0)):
        for offset in (0, 1):
            # offset 1: every tensor a view one float past an aligned start
            def make(scale):
                return [(torch.randn(n + offset, generator=gen, device=dev)
                         * scale)[offset:] for n in sizes]

            ws, gs, ms = make(0.05), make(0.01), make(0.001)
            moms = ms if momentum else None
            lrs, wds = [0.1, 0.05] * 4, [1e-4, 0.0] * 4
            w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
            sg.sgd_mom_multi(ws, gs, moms, lrs, wds, momentum, 1 / 32, clip)
            sg.sgd_mom_multi_plain(w2, gs, m2 if momentum else None, lrs,
                                   wds, momentum, 1 / 32, clip)
            equal(f"momentum {momentum} clip {clip} offset {offset}",
                  ws + ms, w2 + m2)
    # a list longer than one launch's parameters hold, under the guard
    n = sg.CAP + 37
    ws = [torch.randn(100 + i, generator=gen, device=dev) for i in range(n)]
    gs = [torch.randn(100 + i, generator=gen, device=dev) for i in range(n)]
    ms = [torch.randn(100 + i, generator=gen, device=dev) for i in range(n)]
    aux = [torch.ones(600 + i, device=dev) for i in range(5)]
    snap = [torch.zeros_like(a) for a in aux]
    guard = sg.Guard(torch.zeros(2, dtype=torch.int32, device=dev),
                     list(zip(aux, snap)))
    lrs, wds = [0.1] * n, [1e-4] * n
    w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
    before = sg.LAUNCHES.value
    sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1.0, -1.0, guard=guard)
    launches = sg.LAUNCHES.value - before
    sg.sgd_mom_multi_plain(w2, gs, m2, lrs, wds, 0.9, 1.0, -1.0)
    equal(f"over {n} tensors", ws + ms, w2 + m2)
    if launches != 4 or guard.counters.tolist() != [0, 0]:
        fail(f"sgd_mom_multi over {n} tensors under the guard: {launches} "
             f"launches (expected 2 probes and 2 updates), counters "
             f"{guard.counters.tolist()}")
    w0, m0 = [t.clone() for t in ws], [t.clone() for t in ms]
    gs[-1][7] = float("nan")
    sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1.0, -1.0, guard=guard)
    torch.cuda.synchronize()
    if guard.counters.tolist() != [1, 1] or any(
            not torch.equal(a, b) for a, b in zip(ws + ms + aux,
                                                  w0 + m0 + snap)):
        fail(f"sgd_mom_multi over {n} tensors: a NaN in the last launch's "
             f"gradients did not skip the step and restore the statistics "
             f"(counters {guard.counters.tolist()})")
    # no host-to-device copy of metadata in a call
    ws, gs, ms, lrs, wds = sgd_inputs(torch, gen, dev,
                                      [(64, 3, 7, 7), (64,), (1000, 2048)])
    cache = {}
    sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0, cache=cache)
    gs = [g.clone() for g in gs]  # new gradients, as every step has
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0,
                             cache=cache)
        torch.cuda.synchronize()
    copies = sum(ev.count for ev in prof.key_averages() if "HtoD" in ev.key)
    if copies:
        fail(f"sgd_mom_multi copied to the device {copies} times in 3 calls")
    print(f"[redesign] sgd_mom_multi matches its plain version bit for bit "
          f"over sizes {sizes} (aligned and one float off, momentum/clip), "
          f"over {n} tensors in 2 launches with the guard's skip and "
          f"restore, counters [0, 0] then [1, 1]; 0 host-to-device copies "
          f"in 3 calls ({time.perf_counter() - t0:.1f} s)", flush=True)
    bn_err = phase_redesign_bn_lstm(torch, mx)
    breakdown = host_breakdown(torch)
    times = kernel_times(torch, mx)
    times["lstm_cell"]["lstm_ptb"]["host_breakdown_us"] = breakdown
    print_kernel_times(times, card, "redesign")
    return times, bn_err


# --- the redesigned nms and bn_stats (phase 13b and --kernel-times) -------
NMS_MARKS = ("nms_",)  # every nms kernel's name, the parent's and this one's


def kernel_split(torch, fn, marks, reps=10):
    """Device milliseconds per call of ``fn`` under ``torch.profiler``, by
    kernel name, for the kernels whose names hold one of ``marks``."""
    return kernel_events(torch, fn, marks, reps)[0]


def kernel_events(torch, fn, marks, reps=10):
    """:func:`kernel_split` and the number of kernel events of those names
    that the profiler's window recorded for the ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, events = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and any(m in ev.key
                                                      for m in marks):
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").split("::")[-1]
            split[name] = split.get(name, 0.0) + \
                ev.self_device_time_total / reps / 1e3
            events += ev.count
    return split, events


HOST_SYNC_MARKS = ("DtoH", "Synchronize", "_local_scalar_dense", "HtoD")


def host_syncs(torch, fn, reps=3):
    """Device-to-host (and host-to-device) copies, scalar reads and
    synchronisations that ``reps`` calls of ``fn`` add under
    ``torch.profiler``, beyond what an empty window records (the
    profiler's own)."""
    from torch.profiler import ProfilerActivity, profile

    def count(body):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
        return sum(ev.count for ev in prof.key_averages()
                   if any(m in ev.key for m in HOST_SYNC_MARKS))

    fn()
    return count(lambda: [fn() for _ in range(reps)]) - count(lambda: None)


def nms_segments(torch, score, cls_id, threshold, classes):
    """The (image, class) segment lengths: valid anchors of each class."""
    valid = score > torch.tensor(threshold, dtype=score.dtype)
    ones = torch.nn.functional.one_hot(cls_id.long().clamp(0, classes - 1),
                                       classes)
    return (ones * valid[..., None]).sum(1)


def nms_border_inputs(torch, dev, lmax, seed, classes=3):
    """Six images of A = L_max + 130 grid boxes (as ``nms_grid_inputs``),
    every score valid: class 0 holding exactly L_max - 1, L_max and
    L_max + 1 valid anchors in the first three (short, short, long), the
    rest spread over classes 1 and 2; then a valid anchor of class id
    ``classes`` (out of range: the whole image, long), of class id -1 with
    only L_max - 12 valid anchors (the whole image, short), and an image
    of short segments."""
    rng = np.random.default_rng(seed)
    n, a = 6, lmax + 130
    x1 = rng.integers(0, 10, (n, a, 2)) / 16
    wh = rng.integers(1, 6, (n, a, 2)) / 16
    boxes = np.concatenate([x1, x1 + wh], 2).astype(np.float32)
    score = np.asarray([0.2, 0.4, 0.6, 0.8], np.float32)[
        rng.integers(0, 4, (n, a))]
    cls_id = rng.integers(1, classes, (n, a)).astype(np.int32)
    for i, length in enumerate((lmax - 1, lmax, lmax + 1)):
        cls_id[i, rng.permutation(a)[:length]] = 0
    cls_id[3, 17] = classes
    score[4, lmax - 12:] = np.float32(0.01)
    cls_id[4, 7] = -1
    cls_id[5] = rng.integers(0, classes, a)
    return nms_tensors(torch, dev, boxes, score, cls_id)


def bn_stats_borders(bs, dev):
    """``bn_stats``' regime borders on this card: each side of a block's
    target, of a two-block cluster and of the largest cluster at the
    target (N = 1, C = 3, the plane m long), a channel past the largest
    cluster's target (1024-thread blocks), planes of 49 and 16, C = 3 with
    N = 1, H*W = 1 and rank 2."""
    t, k = bs.BLOCK_TARGET, bs.device_limits(dev.index or 0)
    return [(1, 3, t - 1), (1, 3, t), (1, 3, t + 1), (1, 3, 2 * t + 1),
            (1, 3, k * t), (1, 3, k * t + 1), (1, 3, 2 * k * t + 4),
            (2, 3, 7, 7), (4, 5, 4, 4), (1, 3, 5, 5), (3, 7, 1, 1), (5, 3),
            (9, 4, 3, 3)]


def check_bn_stats(torch, bs, what, x, gen):
    """``bn_stats`` on ``x`` against its plain version from the same moving
    statistics (``STAT_RTOL``/``STAT_ATOL``, the variance's cancellation
    term), ``kvar`` exactly, one launch as planned, and a second call on
    the same inputs bit for bit; channel 0 is made constant (1.5 over an
    anchor of 1: every partial sum exact, raw == 0, ``kvar`` 0.5). Returns
    the largest error."""
    c = x.shape[1]
    dev = x.device
    x[:, 0] = 1.5
    mm = 0.1 * torch.randn(c, generator=gen, device=dev)
    mm[0] = 1.0
    mv = 0.5 + torch.rand(c, generator=gen, device=dev)
    mm2, mv2, mm3, mv3 = mm.clone(), mv.clone(), mm.clone(), mv.clone()
    p = bs.plan_for(x)
    before = bs.LAUNCHES.value
    got = bs.bn_stats(x, mm, mv, 0.9)
    if bs.LAUNCHES.value - before != 1 or p.launches != 1:
        fail(f"{what}: {bs.LAUNCHES.value - before} launches, planned "
             f"{p.launches}")
    again = bs.bn_stats(x, mm3, mv3, 0.9)
    anchor = mm2.clone()
    want = bs.bn_stats_plain(x, mm2, mv2, 0.9)
    dmean = float((want[0] - anchor).abs().max())
    cancel = 8 * 2.0 ** -23 * dmean ** 2
    err = max(check(torch, what + " mean", got[0], want[0], STAT_RTOL,
                    STAT_ATOL),
              check(torch, what + " var", got[1], want[1], STAT_RTOL,
                    STAT_ATOL + cancel),
              check(torch, what + " moving_mean", mm, mm2, STAT_RTOL,
                    STAT_ATOL),
              check(torch, what + " moving_var", mv, mv2, STAT_RTOL,
                    STAT_ATOL + cancel))
    if not torch.equal(got[2], want[2]) or float(got[2][0]) != 0.5:
        fail(f"{what}: kvar {got[2][:4].tolist()} against the plain "
             f"version's {want[2][:4].tolist()}")
    if any(not torch.equal(a, b) for a, b in zip(got + (mm, mv),
                                                 again + (mm3, mv3))):
        fail(f"{what}: two calls on the same inputs differ")
    return err, p.regime


def ssd_nms_heads(torch, mx, calls=None):
    """The ``nms`` inputs of the SSD path, recorded: SSD-300's detection at
    serving batch 8 (phase 11's weights and images, nms_threshold 0.5) and
    one training forward at batch 32 (phase 13's, 0.45). Returns ``{path:
    (boxes, score, cls_id, order, threshold, nms_threshold)}``. With a dict
    ``calls``, the same forwards' ``multibox_decode`` and
    ``l2norm_channel`` arguments go into it as ``{"serve": {kernel:
    args}, "train": {kernel: args}}``."""
    from mxnet_tpu_torch.kernels import multibox_decode as dec, nms

    sym, args = ssd_numpy(mx, SEED + 10)
    pred = mx.predictor.Predictor(sym, ssd_params(mx, args, "cuda:0"),
                                  {"data": (SSD_BATCH, 3, SSD_SHAPE,
                                            SSD_SHAPE)})
    heads = {}
    targets = [("nms", nms, "nms"),
               ("multibox_decode", dec, "multibox_decode"), *l2norm_targets()]
    with record_calls(targets) as rec:
        pred.forward(data=ssd_images(SSD_BATCH))
        torch.cuda.synchronize()
    heads["serve"] = rec.calls["nms"][0][0][:6]
    if calls is not None:
        calls["serve"] = {k: rec.calls[k][0][0] for k in
                          ("multibox_decode", "l2norm_channel")}
    del pred
    _sym, args = ssd_numpy(mx, SEED + 20)
    x, y = ssd_train_images(SSD_TRAIN_BATCH, SEED + 21)
    mod = ssd_train_module(mx, ssd_train_symbol(mx), args, mx.gpu(0),
                           SSD_TRAIN_BATCH)
    with record_calls(targets) as rec:
        mod.forward(ssd_batch(mx, x, y, mx.gpu(0)), is_train=True)
        torch.cuda.synchronize()

    def detached(a):
        return tuple(t.detach() if isinstance(t, torch.Tensor) else t
                     for t in a)
    heads["train"] = detached(rec.calls["nms"][0][0][:6])
    if calls is not None:
        calls["train"] = {k: detached(rec.calls[k][0][0]) for k in
                          ("multibox_decode", "l2norm_channel")}
    del mod
    torch.cuda.empty_cache()
    return heads


def print_segments(torch, nms, heads, lmax):
    """The per-image distribution of segment lengths at each head."""
    out = {}
    for path, (boxes, score, cls_id, order, thr, nms_thr) in heads.items():
        seg = nms_segments(torch, score, cls_id, thr, SSD_CLASSES)
        big = seg.max(1).values
        valid = seg.sum(1)
        out[path] = {"largest": int(seg.max()),
                     "median": float(seg.float().median()),
                     "over_lmax": int((seg > lmax).sum()),
                     "valid_per_image": [int(v) for v in valid],
                     "largest_per_image": [int(v) for v in big]}
        print(f"[redesign-nms] segment lengths at the {path} head "
              f"{tuple(score.shape)} (threshold {thr}): per (image, class) "
              f"largest {out[path]['largest']}, median "
              f"{out[path]['median']:g}, {out[path]['over_lmax']} over "
              f"L_max {lmax}; per image valid {valid.min().item()}.."
              f"{valid.max().item()}, largest segment {big.min().item()}.."
              f"{big.max().item()}", flush=True)
    return out


def phase_redesign_nms_bn_stats(torch, mx, card, heads):
    """The redesigned ``nms`` and ``bn_stats`` on the card. ``nms``: the
    segment lengths at the serving and training heads; bit for bit against
    its plain version on both heads (by class as the path runs it, force,
    whole images, one class holding every anchor), at the plan's borders
    (a class of L_max - 1, L_max and L_max + 1 valid anchors, class ids
    out of range both ways, a batch whose images take different routes),
    at A = 1, 65 and 1000; launches as planned and two calls bit for bit.
    ``bn_stats``: at every regime border (:func:`bn_stats_borders`) and
    path shape, aligned and on views at a float offset of 1 and 3
    (:func:`check_bn_stats`). Both: no device-to-host copy or
    synchronisation in a call (``torch.profiler``). Then
    :func:`kernel_times_nms_bn_stats`."""
    from mxnet_tpu_torch.kernels import bn_stats as bs
    from mxnet_tpu_torch.kernels import nms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    t0 = time.perf_counter()
    lmax = nms.plan(1, SSD_ANCHORS, SSD_CLASSES, False,
                    nms.device_limits(0)).lmax
    segments = print_segments(torch, nms, heads, lmax)
    routes = {}

    def held(what, ins, thr, nms_thr, force, classes):
        p = nms.plan_for(ins[1], classes, force)
        before = nms.LAUNCHES.value
        got = nms.nms(*ins, thr, nms_thr, force, classes)
        launches = nms.LAUNCHES.value - before
        again = nms.nms(*ins, thr, nms_thr, force, classes)
        want = nms.nms_plain(*ins, thr, nms_thr, force)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"nms on {what} (force {force}, classes {classes}): "
                 f"{int((got[..., 0] != want[..., 0]).sum())} ids/keep "
                 f"decisions differ from the plain version")
        if not torch.equal(got, again) or launches != p.launches:
            fail(f"nms on {what}: two calls differ, or {launches} launches "
                 f"against the plan's {p.launches}")
        key = f"{p.launches} launch{'es' if p.launches > 1 else ''}"
        routes[key] = routes.get(key, 0) + 1
        return keep_count(got)

    cases = 0
    for path, (boxes, score, cls_id, order, thr, nms_thr) in heads.items():
        ins = (boxes, score, cls_id, order)
        one = (boxes, score, torch.full_like(cls_id, 7), order)
        kept = [held(f"the {path} head", ins, thr, nms_thr, False,
                     SSD_CLASSES),
                held(f"the {path} head", ins, thr, nms_thr, True,
                     SSD_CLASSES),
                held(f"the {path} head", ins, thr, nms_thr, False, None),
                held(f"the {path} head, one class holding every anchor",
                     one, thr, nms_thr, False, SSD_CLASSES)]
        cases += 4
        print(f"[redesign-nms] nms equals its plain version bit for bit on "
              f"the {path} head {tuple(score.shape)}: kept {kept} (by "
              f"class, force, whole images, one class holding every "
              f"anchor)", flush=True)
    border = nms_border_inputs(torch, dev, lmax, SEED + 51)
    for force in (False, True):
        for classes in (3, None):
            held("the border batch", border, 0.01, 0.5, force, classes)
            cases += 1
    for a in (1, 65, 1000):
        ins = nms_grid_inputs(torch, dev, SEED + 52 + a, n=3, a=a)
        for force, classes in ((False, 3), (True, 3), (False, None)):
            held(f"grid boxes at A = {a}", ins, 0.01, 0.5, force, classes)
            cases += 1
    boxes, score, cls_id, order, thr, nms_thr = heads["train"]
    syncs = host_syncs(torch, lambda: nms.nms(
        boxes, score, cls_id, order, thr, nms_thr, False, SSD_CLASSES))
    if syncs:
        fail(f"nms copied to or from the host or synchronised {syncs} "
             f"times in 3 calls")
    print(f"[redesign-nms] nms matches its plain version bit for bit in "
          f"{cases} cases (the two heads, the border batch: a class of "
          f"L_max - 1 = {lmax - 1}, L_max, L_max + 1 valid boxes, class ids "
          f"{{3, -1}} out of range, mixed routes; A = 1, 65, 1000), launches "
          f"as planned {routes}, two calls bit for bit; 0 host copies or "
          f"synchronisations in 3 calls ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # --- bn_stats
    t0 = time.perf_counter()
    _sym, bn_shapes, _params = resnet50_shapes(mx, TRAIN_BATCH)
    path_shapes = list(dict.fromkeys(bn_shapes + DCGAN_D_BN + DCGAN_G_BN))
    err, regimes, n = 0.0, {}, 0
    for shape in bn_stats_borders(bs, dev) + path_shapes:
        x = torch.randn(shape, generator=gen, device=dev) + 0.3
        e, regime = check_bn_stats(torch, bs, f"bn_stats {shape}", x, gen)
        err, n = max(err, e), n + 1
        regimes[regime] = regimes.get(regime, 0) + 1
    t = bs.BLOCK_TARGET
    for shape in ((4, 6, 8, 8), (1, 3, 3 * t), (2, 3, 7, 7),
                  (8, 64, 16, 16)):
        for offset in (1, 3):
            flat = torch.randn(math.prod(shape) + offset, generator=gen,
                               device=dev)
            x = flat[offset:].view(shape)
            e, _regime = check_bn_stats(
                torch, bs, f"bn_stats {shape} at a float offset of {offset}",
                x, gen)
            err, n = max(err, e), n + 1
    x = torch.randn(32, 256, 56, 56, generator=gen, device=dev)
    mm, mv = torch.zeros(256, device=dev), torch.ones(256, device=dev)
    syncs = host_syncs(torch, lambda: bs.bn_stats(x, mm, mv, 0.9))
    if syncs:
        fail(f"bn_stats copied to or from the host or synchronised {syncs} "
             f"times in 3 calls")
    plans = {s: bs.plan(s[0], s[1], math.prod(s[2:]),
                        bs.device_limits(0)).launches for s in path_shapes}
    if set(plans.values()) != {1}:
        fail(f"bn_stats plans more than one launch at a path shape: {plans}")
    print(f"[redesign-bn-stats] bn_stats matches its plain version in {n} "
          f"cases ({len(bn_stats_borders(bs, dev))} regime borders, "
          f"{len(path_shapes)} ResNet-50 and DCGAN shapes, views at float "
          f"offsets 1 and 3; plans {regimes}): max abs err {err:g} (rtol "
          f"{STAT_RTOL}, atol {STAT_ATOL} + 8*2^-23*dmean^2 on the "
          f"variance), kvar exactly (0.5 on a constant channel), one launch "
          f"a call, two calls bit for bit; 0 host copies or "
          f"synchronisations in 3 calls ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    del x
    times = kernel_times_nms_bn_stats(torch, mx, heads)
    times["nms"]["segments"] = segments
    times["bn_stats"]["dcgan"]["host_breakdown_us"] = \
        host_breakdown_bn_stats(torch)
    print_nms_bn_stats_times(times, card, "redesign")
    return times, err


def kernel_times_nms_bn_stats(torch, mx, heads):
    """``nms`` on the SSD path's heads and ``bn_stats`` over a ResNet-50
    step's 50 inputs and a DCGAN step's 13: the kernel back to back by CUDA
    events (warm), single calls with the L2 cache cold (median), its
    device time under the profiler split by kernel name, the launches per
    call, the wrapper's host microseconds per call, the bound and the
    library calls (``bn_stats``: ``torch.var_mean`` and
    ``torch.batch_norm_stats``; ``nms``: none). Uses only the wrappers'
    public calls (``classes`` where ``nms`` takes it), so it times any
    checkout's package (``--kernel-times``)."""
    import inspect

    from mxnet_tpu_torch.kernels import bn_stats as bs
    from mxnet_tpu_torch.kernels import nms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    takes = "classes" in inspect.signature(nms.nms).parameters
    out = {"nms": {}, "bn_stats": {}}
    # beside the heads: 64 classes over grid boxes at (32, 8096), every
    # segment short, so that the long route's launches find no work
    cases = [(path, head, SSD_CLASSES) for path, head in heads.items()]
    cases.append(("short_only", nms_grid_inputs(
        torch, dev, SEED + 55, n=SSD_TRAIN_BATCH, a=SSD_ANCHORS,
        classes=64) + (0.01, 0.45), 64))
    for path, (boxes, score, cls_id, order, thr, nms_thr), classes in cases:
        kw = {"classes": classes} if takes else {}

        def run(boxes=boxes, score=score, cls_id=cls_id, order=order,
                thr=thr, nms_thr=nms_thr, kw=kw):
            return nms.nms(boxes, score, cls_id, order, thr, nms_thr, False,
                           **kw)

        got = run()
        ious = nms_iou_count(torch, got, score, cls_id, order, thr, False)
        n, a = score.shape
        b_ms, b_by = bound(n * a * (16 + 4 + 4 + 8 + 24), ious * NMS_IOU_OPS)
        before = nms.LAUNCHES.value
        run()
        launches = nms.LAUNCHES.value - before
        split = kernel_split(torch, run, NMS_MARKS)
        out["nms"][path] = {
            "what": f"({n}, {a}), nms_threshold {nms_thr}, "
                    f"{keep_count(got)} kept, {ious} same-class IoUs",
            "ms": cuda_ms(torch, run, reps=20),
            "cold_ms": cold_ms(torch, run, flush),
            "device_ms": sum(split.values()), "device_by_kernel": split,
            "launches": launches, "bound_ms": b_ms, "bound_by": b_by,
            "library": None, "library_ms": None,
            "host_us": host_us(torch, run, reps=50)}
    _sym, bn_shapes, _params = resnet50_shapes(mx, TRAIN_BATCH)
    for path, shapes in (("resnet", bn_shapes),
                         ("dcgan", DCGAN_D_BN * 3 + DCGAN_G_BN)):
        T = {}
        for s in shapes:
            if s not in T:
                c = s[1]
                T[s] = (torch.randn(s, generator=gen, device=dev),
                        0.1 * torch.randn(c, generator=gen, device=dev),
                        0.5 + torch.rand(c, generator=gen, device=dev))

        def each(fn, shapes=shapes, T=T):
            def go():
                for s in shapes:
                    fn(*T[s])
            return go

        n_el = sum(math.prod(s) for s in shapes)
        c_sum = sum(s[1] for s in shapes)
        b_ms, b_by = bound(n_el * 4 + c_sum * 28, 3 * n_el)
        kern = each(lambda x, mm, mv: bs.bn_stats(x, mm, mv, 0.9))
        before = bs.LAUNCHES.value
        kern()
        launches = bs.LAUNCHES.value - before
        bns = each(lambda x, mm, mv: torch.batch_norm_stats(x, BN_EPS))
        r = out["bn_stats"][path] = {
            "what": f"{len(shapes)} calls over {len(T)} shapes, "
                    f"{n_el / 1e6:.2f} M elements",
            "library": "torch.var_mean", "launches": launches,
            "bound_ms": b_ms, "bound_by": b_by, **timed(
                torch, kern,
                each(lambda x, mm, mv: bs.bn_stats_plain(x, mm, mv, 0.9)),
                each(lambda x, mm, mv: torch.var_mean(
                    x, (0,) + tuple(range(2, x.dim())), correction=0)),
                flush, ("bn_stats_kernel",), reps=10, plain_reps=3),
            "batch_norm_stats_ms": cuda_ms(torch, bns, reps=10),
            "batch_norm_stats_cold_ms": cold_ms(torch, bns, flush)}
        r["host_us"] /= len(shapes)  # per wrapper call; times are per set
        T.clear()
    del flush
    return out


def print_nms_bn_stats_times(times, card, tag):
    for path, r in times["nms"].items():
        if path == "segments":
            continue
        split = ", ".join(f"{k} {v:.4f}" for k, v in
                          r["device_by_kernel"].items())
        print(f"[{tag}] nms {path} {r['what']} on {card}: kernel "
              f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} ms cold; device "
              f"{r['device_ms']:.4f} ms ({split}); {r['launches']} launches "
              f"a call; bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
              f"wrapper host {r['host_us']:.1f} us per call", flush=True)
    for path, r in times["bn_stats"].items():
        print(f"[{tag}] bn_stats {path} {r['what']} on {card}: kernel "
              f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} ms cold "
              f"({100 * r['bound_ms'] / r['cold_ms']:.0f}% of the bound); "
              f"device {r['device_ms']:.4f} ms; {r['launches']} launches; "
              f"plain {r['plain_ms']:.4f} ms; torch.var_mean "
              f"{r['library_ms']:.4f} ms warm, {r['library_cold_ms']:.4f} "
              f"ms cold; torch.batch_norm_stats "
              f"{r['batch_norm_stats_ms']:.4f} ms warm, "
              f"{r['batch_norm_stats_cold_ms']:.4f} ms cold; bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); wrapper host "
              f"{r['host_us']:.1f} us per call", flush=True)


# --- the redesigned l2norm_channel_bwd and softmax_output_bwd (phase 13c
# and --kernel-times) --------------------------------------------------------
L2_BWD_PATH = (SSD_TRAIN_BATCH, 512, 37, 37)  # conv4_3 in SSD training
L2_BWD_EPS, L2_BWD_SCALE = 1e-10, 20.0  # models/ssd.py's eps and scale
# every kernel name of the two functions, the parent's and this one's
L2_BWD_MARKS = ("l2norm_channel_bwd_",)
SO_BWD_MARKS = ("softmax_output_bwd_", "count_valid_kernel")
SSD_IGNORED = 0.9  # the share of ignored labels in the timed SSD call


def so_path_inputs(torch, gen, dev):
    """SoftmaxOutput's backward at each path's call, as the wrapper's
    arguments: SSD training's class-major view of (32, 8096, 21)
    probabilities, ``multi_output``, ``use_ignore`` and 'valid'
    (``SSD_IGNORED`` of the labels ignored), the LSTM head's (1024, 10000)
    and ResNet's (32, 1000), 'null'."""
    shape = (SSD_TRAIN_BATCH, SSD_ANCHORS, SSD_CLASSES + 1)
    p = torch.softmax(torch.randn(shape, generator=gen, device=dev),
                      -1).transpose(1, 2)
    lab = torch.randint(0, SSD_CLASSES + 1, shape[:2], generator=gen,
                        device=dev).float()
    lab[torch.rand(shape[:2], generator=gen, device=dev) < SSD_IGNORED] = -1.
    out = {"ssd_train": (p, lab, 1.0, -1.0, True, "valid", True)}
    for path in ("lstm_head", "resnet"):
        rows, classes = SM_PATHS[path]
        p = torch.softmax(torch.randn(rows, classes, generator=gen,
                                      device=dev), -1)
        lab = torch.randint(0, classes, (rows,), generator=gen,
                            device=dev).float()
        out[path] = (p, lab, 1.0, -1.0, False, "null", False)
    return out


def timed_call(torch, run, plain, marks, counter, b, flush, what, reps=50,
               library=None, plain_reps=10):
    """One call ``run`` of a redesigned kernel's wrapper (or a set of
    calls): its launches, warm and cold times, device time by kernel name
    (:func:`complete_device_ms`), the plain version, ``library`` (``(name,
    fn)``, one PyTorch call for the same function) when given, the
    wrapper's host microseconds, the bound ``b``."""
    before = counter.value
    run()
    launches = counter.value - before
    split = complete_device_ms(torch, run, marks, launches)
    return {"what": what, "launches": launches,
            "ms": cuda_ms(torch, run, reps=reps),
            "cold_ms": cold_ms(torch, run, flush),
            "device_ms": sum(split.values()) if split else None,
            "device_by_kernel": split,
            "plain_ms": cuda_ms(torch, plain, reps=plain_reps, warmup=1),
            "library": library[0] if library else None,
            "library_ms": cuda_ms(torch, library[1], reps=reps)
            if library else None,
            "bound_ms": b[0], "bound_by": b[1],
            "host_us": host_us(torch, run)}


def complete_device_ms(torch, run, marks, launches, reps=10):
    """Device milliseconds per call of ``run`` by kernel name, from the
    first of five profiler windows that recorded all ``launches`` of each
    of its ``reps`` calls ({} if none did: a window now and then records
    none or only part of them, and then reads low; PERF.md §7)."""
    for _ in range(5):
        got, events = kernel_events(torch, run, marks, reps)
        if events == reps * launches:
            return got
    return {}


def kernel_times_l2norm_softmax_bwd(torch):
    """``l2norm_channel_bwd`` at SSD training's (32, 512, 37, 37) x 20 and
    ``softmax_output_bwd`` at each path's call (:func:`so_path_inputs`): the
    kernel back to back by CUDA events (warm), single calls with the L2
    cache cold (median), the device time under the profiler by kernel name,
    the launches a call, the plain version, the wrapper's host microseconds
    per call and the bound; no single PyTorch call computes either
    function. Uses only the wrappers' public calls, so it times any
    checkout's package (``--kernel-times``)."""
    from mxnet_tpu_torch.kernels import l2norm_channel as l2
    from mxnet_tpu_torch.kernels import softmax_output_bwd as so

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {"l2norm_channel_bwd": {}, "softmax_output_bwd": {}}
    x = torch.randn(L2_BWD_PATH, generator=gen, device=dev)
    g = torch.randn(L2_BWD_PATH, generator=gen, device=dev)
    n = x.numel()
    out["l2norm_channel_bwd"]["ssd_train"] = timed_call(
        torch, lambda: l2.l2norm_channel_bwd(x, g, L2_BWD_EPS, L2_BWD_SCALE),
        lambda: l2.l2norm_channel_bwd_plain(x, g, L2_BWD_EPS, L2_BWD_SCALE),
        L2_BWD_MARKS, l2.BWD_LAUNCHES, bound(12 * n, 8 * n), flush,
        f"{L2_BWD_PATH} x {L2_BWD_SCALE}")
    del x, g
    for path, args in so_path_inputs(torch, gen, dev).items():
        n = args[0].numel()
        out["softmax_output_bwd"][path] = timed_call(
            torch, lambda args=args: so.softmax_output_bwd(*args),
            lambda args=args: so.softmax_output_bwd_plain(*args),
            SO_BWD_MARKS, so.LAUNCHES,
            bound(8 * n + 4 * args[1].numel(), 2 * n), flush,
            f"{tuple(args[0].shape)} {args[5]}"
            f"{', class-major, use_ignore' if args[6] else ''}",
            reps=50 if n > 1e6 else 200)
    del flush
    return out


def print_redesign_times(times, card, tag):
    for name, paths in times.items():
        for path, r in paths.items():
            split = ", ".join(f"{k} {v:.4f}" for k, v in
                              r["device_by_kernel"].items())
            dev = (f"device {r['device_ms']:.4f} ms ({split})"
                   if r["device_ms"] is not None else
                   "device time not measured (no profiler window of five "
                   "recorded every launch)")
            lib = (f"{r['library']} {r['library_ms']:.4f} ms"
                   if r["library"] else "no library call")
            print(f"[{tag}] {name} {path} {r['what']} on {card}: kernel "
                  f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} ms cold "
                  f"({100 * r['bound_ms'] / r['cold_ms']:.0f}% of the "
                  f"bound); {dev}; "
                  f"{r['launches']} launches; plain "
                  f"{r['plain_ms']:.4f} ms; {lib}; bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); wrapper host "
                  f"{r['host_us']:.1f} us per call", flush=True)


def l2_bwd_edges(l2):
    """``l2norm_channel_bwd``'s edge shapes on this card: C = 1, H*W = 1
    and rank 2, odd image counts, 32-position blocks straddling two images
    (H*W = 35, 9), one image at SSD's C, and each side of the two-pass
    border."""
    c2 = l2.ONCHIP_C + 1  # the least C of the two-pass regime
    return [(3, 1, 5, 7), (4, 6, 1, 1), (5, 3), (7, 21, 3, 3), (3, 8, 5, 7),
            (1, 512, 37, 37), (2, c2 - 1, 3, 5), (2, c2, 3, 5),
            (3, 2 * c2 + 3, 1, 1), (5, 17, 13, 11)]


def so_bwd_edges(torch, gen, dev):
    """``softmax_output_bwd``'s edge calls: C = 1, odd row counts (no
    multiple of 4 elements), one row, C = 2 and 3 (chunks across several
    rows), under each normalization with and without ``use_ignore``; every
    label ignored; labels out of the int32 range and fractional;
    ``multi_output`` with ``inner`` > 1; the class-major view; a view one
    float off the 16-byte alignment (the general regime)."""
    def probs(shape, dim=-1):
        return torch.softmax(torch.randn(shape, generator=gen, device=dev),
                             dim)

    def labels(shape, classes):
        return torch.randint(-1, classes, shape, generator=gen,
                             device=dev).float()

    calls = []
    for shape in ((7, 1), (33, 21), (1, 1000), (9, 3), (13, 2), (5, 4)):
        p, lab = probs(shape), labels(shape[:1], shape[1])
        for norm in ("null", "batch", "valid"):
            for ui in (False, True):
                calls.append((f"{shape} {norm} use_ignore={ui}",
                              (p, lab, 0.5, -1.0, ui, norm, False)))
    p = probs((9, 21))
    calls.append(("(9, 21) every label ignored", (
        p, torch.full((9,), 3.0, device=dev), 1.0, 3.0, True, "valid",
        False)))
    wild = torch.tensor([-1.0, 0.0, 2.7, -0.5, 3e9, -3e9, 10.0, 11.0],
                        device=dev)
    calls.append(("(8, 11) labels out of range and fractional", (
        probs((8, 11)), wild, 1.0, -1.0, True, "valid", False)))
    for shape in ((3, 5, 2, 7), (2, 4, 3), (1, 3, 1, 1)):
        p = probs(shape, 1)
        lab = labels((shape[0],) + shape[2:], shape[1])
        for norm in ("null", "batch", "valid"):
            calls.append((f"multi_output {shape} {norm}",
                          (p, lab, 1.0, -1.0, True, norm, True)))
    p = probs((4, 300, 21)).transpose(1, 2)
    lab = labels((4, 300), 21)
    lab[torch.rand(4, 300, generator=gen, device=dev) < 0.75] = -1.0
    for norm in ("null", "batch", "valid"):
        calls.append((f"class-major view (4, 21, 300) {norm}",
                      (p, lab, 1.0, -1.0, True, norm, True)))
    view = torch.empty(33 * 21 + 1, device=dev)[1:].view(33, 21)
    view.copy_(probs((33, 21)))
    calls.append(("(33, 21) one float off alignment", (
        view, labels((33,), 21), 1.0, -1.0, True, "valid", False)))
    return calls


def phase_redesign_l2norm_softmax_bwd(torch, mx, card, recorded):
    """The redesigned ``l2norm_channel_bwd`` and ``softmax_output_bwd`` on
    the card. ``l2norm_channel_bwd``: on the SSD step's recorded tensors and
    at :func:`l2_bwd_edges` (scale 1 and 20), within ``bwd_limit``, the
    regime as planned, one launch a call, two calls bit for bit.
    ``softmax_output_bwd``: on the SSD step's recorded call, at the LSTM
    head's and ResNet's shapes and at :func:`so_bwd_edges`, bit for bit
    against its plain version on the CPU (``torch.equal``), one launch a
    call, the
    gradient in ``p``'s layout. Neither copies to or from the host or
    synchronises in a call. Then :func:`kernel_times_l2norm_softmax_bwd`."""
    from mxnet_tpu_torch.kernels import l2norm_channel as l2
    from mxnet_tpu_torch.kernels import softmax_output_bwd as so

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    t0 = time.perf_counter()
    xl, gl, eps, scale = recorded["l2norm_channel_bwd"]
    cases = [(f"the step's conv4_3 {tuple(xl.shape)}", xl, gl, scale)]
    for shape in l2_bwd_edges(l2):
        x = torch.randn(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        cases += [(str(shape), x, g, 1.0), (str(shape), x, g, 20.0)]
    err, regimes = 0.0, {}
    for what, x, g, sc in cases:
        p = l2.bwd_plan(x.shape[1])
        before = l2.BWD_LAUNCHES.value
        got = l2.l2norm_channel_bwd(x, g, eps, sc)
        launches = l2.BWD_LAUNCHES.value - before
        again = l2.l2norm_channel_bwd(x, g, eps, sc)
        want = l2.l2norm_channel_bwd_plain(x, g, eps, sc)
        err = max(err, check(torch, f"l2norm_channel_bwd {what} x {sc}",
                             got, want, 0.0,
                             l2.bwd_limit(x, g, eps, sc, want)))
        if launches != 1 or not torch.equal(got, again):
            fail(f"l2norm_channel_bwd {what}: {launches} launches, or two "
                 f"calls differ")
        key = f"{p.regime} (k {p.k})"
        regimes[key] = regimes.get(key, 0) + 1
    step_plan = l2.bwd_plan(xl.shape[1])
    if step_plan.regime != "onchip":
        fail(f"l2norm_channel_bwd plans {step_plan} at the SSD step's "
             f"{tuple(xl.shape)}")
    syncs = host_syncs(torch, lambda: l2.l2norm_channel_bwd(xl, gl, eps,
                                                            scale))
    if syncs:
        fail(f"l2norm_channel_bwd copied to or from the host or "
             f"synchronised {syncs} times in 3 calls")
    print(f"[redesign-l2-bwd] l2norm_channel_bwd holds its plain version in "
          f"{len(cases)} cases (the SSD step's tensors, {len(cases) // 2} "
          f"edge shapes x scale 1 and 20; the two-pass border at C = "
          f"{l2.ONCHIP_C + 1}): max abs err {err:g} "
          f"({l2.BWD_RTOL} of the terms + {l2.BWD_ATOL} x max|dx|); plans "
          f"{regimes}; one launch a call, two calls bit for bit; 0 host "
          f"copies or synchronisations in 3 calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    so_args = recorded["softmax_output_bwd"]
    ignored = float((so_args[1] == so_args[3]).float().mean())
    calls = [(f"the SSD step's call {tuple(so_args[0].shape)} (class-major "
              f"view, {100 * ignored:.1f} % ignored)", so_args)]
    for path, args in so_path_inputs(torch, gen, dev).items():
        if path != "ssd_train":
            calls.append((f"the {path} shape {tuple(args[0].shape)}", args))
    calls += so_bwd_edges(torch, gen, dev)
    routes = {}
    for what, args in calls:
        p = args[0]
        moved = (args[6] and p.dim() > 2 and not p.is_contiguous()
                 and p.movedim(1, -1).is_contiguous())
        view = p.movedim(1, -1) if moved else p
        o, c, i = so._view(view, args[6] and not moved)
        aligned = view.data_ptr() % 16 == 0
        route = so.plan(o, c, i, aligned).regime
        before = so.LAUNCHES.value
        got = so.softmax_output_bwd(*args)
        launches = so.LAUNCHES.value - before
        again = so.softmax_output_bwd(*args)
        # the plain version on the CPU, whose divisions are correctly
        # rounded, as the kernel's are (PyTorch's CUDA division by a Python
        # number multiplies by the reciprocal)
        want = so.softmax_output_bwd_plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in args))
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).sum())
            fail(f"softmax_output_bwd {what}: {bad} values differ from the "
                 f"plain version on the CPU (max "
                 f"{float((got.cpu() - want).abs().max()):g})")
        if (launches != 1 or not torch.equal(got, again)
                or got.shape != p.shape or got.stride() != p.stride()):
            fail(f"softmax_output_bwd {what}: {launches} launches, two "
                 f"calls differ, or the layout {got.stride()} is not p's "
                 f"{p.stride()}")
        key = f"{route}{' counting' if args[5] == 'valid' and args[4] else ''}"
        routes[key] = routes.get(key, 0) + 1
    syncs = host_syncs(torch, lambda: so.softmax_output_bwd(*so_args))
    if syncs:
        fail(f"softmax_output_bwd copied to or from the host or "
             f"synchronised {syncs} times in 3 calls")
    print(f"[redesign-so-bwd] softmax_output_bwd equals its plain version "
          f"bit for bit in {len(calls)} calls (the SSD step's, the LSTM "
          f"head's and ResNet's shapes, and edges: C = 1, 2, 3, odd rows, "
          f"one row, null/batch/valid with and without use_ignore, every "
          f"label ignored, labels out of range, multi_output with inner > "
          f"1, the class-major view, a view off alignment; routes "
          f"{routes}); one launch a call, two calls bit for bit, the "
          f"gradient in p's layout; 0 host copies or synchronisations in 3 "
          f"calls ({time.perf_counter() - t0:.1f} s)", flush=True)
    times = kernel_times_l2norm_softmax_bwd(torch)
    print_redesign_times(times, card, "redesign")
    return times, err


# --- 13d: the redesigned bn_act and multibox_target -------------------------
BN_ACT_MARKS = ("bn_act_",)  # every bn_act kernel's name, leaky included
MBT_MARKS = ("multibox_target_kernel",)
SSD_MAPS = (37, 18, 9, 5, 3, 1)  # SSD-300's feature maps: 8096 anchors
# multibox_target's edge inputs beyond MBT_CASES, where a cluster's split of
# an image's anchors between its blocks could go wrong
MBT_EDGES = ("ties at K* across the blocks, signed zeros",
             "an object whose best anchor lies in the last block",
             "max_neg of 0", "max_neg of A or more", "G = 1 and a tiny A",
             "A no multiple of the blocks' span, G past one sweep",
             "a forced candidate, K* at +inf",
             "a forced candidate at K*'s top byte")


def mbt_edge_case(name):
    """``(anchors (1, A, 4), label (n, G, 5), cls_pred (n, 6, A), params)``
    as numpy for one of ``MBT_EDGES``."""
    rng = np.random.default_rng(SEED + 70 + MBT_EDGES.index(name))

    def anchors(a):
        lo = rng.uniform(0, 0.8, (a, 2))
        return np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (a, 2))],
                              1).astype(np.float32)[None]

    def labels(valid_counts, g):
        label = np.full((len(valid_counts), g, 5), -1.0, np.float32)
        for b, k in enumerate(valid_counts):
            for j in range(k):
                x1 = rng.uniform(0, 0.6, 2)
                label[b, j] = [rng.integers(0, 5), *x1,
                               *(x1 + rng.uniform(0.1, 0.4, 2))]
        return label

    def logits(n, a):
        return rng.standard_normal((n, 6, a)).astype(np.float32)

    if name == "ties at K* across the blocks, signed zeros":
        # most keys are +0.0 or -0.0, a few below: K* is 0, every block
        # holds some, and in one image the kept ones end past the first
        # block's span but before the last anchor
        a = 301
        cls = rng.choice(np.asarray([-1.0, -0.0, 0.0, 1.0], np.float32),
                         (3, 6, a), p=[0.01, 0.47, 0.47, 0.05])
        return anchors(a), labels([3, 1, 5], 6), cls, \
            dict(MBT_PARAMS, negative_mining_ratio=25.0)
    if name == "an object whose best anchor lies in the last block":
        a = 300
        anc = anchors(a)
        label = labels([2, 3], 4)
        label[0, 1, 1:] = anc[0, a - 2]  # IoU 1 at anchor A - 2
        label[1, 2, 1:] = anc[0, a - 1]
        return anc, label, logits(2, a), MBT_PARAMS
    if name == "max_neg of 0":
        # ratio * num_pos below 1 in every image, no minimum
        return anchors(300), labels([1, 0, 2], 4), logits(3, 300), \
            dict(MBT_PARAMS, negative_mining_ratio=0.1)
    if name == "max_neg of A or more":
        return anchors(300), labels([1, 3], 4), logits(2, 300), \
            dict(MBT_PARAMS, negative_mining_ratio=1000.0)
    if name == "G = 1 and a tiny A":
        # one anchor: the second block of the cluster has none, and still
        # takes part in the cluster's barriers
        return anchors(1), labels([1, 1, 0], 1), logits(3, 1), \
            dict(MBT_PARAMS, negative_mining_thresh=0.9)
    if name == "A no multiple of the blocks' span, G past one sweep":
        return anchors(1237), labels([33, 17, 5], 33), logits(3, 1237), \
            MBT_PARAMS
    # a tiny object in a corner: its best anchor meets it at an IoU below
    # the mining threshold, so that anchor is forced though it would have
    # been a mining candidate
    corner = [1.0, 0.97, 0.97, 0.99, 0.99]
    if name == "a forced candidate, K* at +inf":
        # candidates (best IoU below 0.2) fewer than max_neg < A: K* is
        # the +inf of the matched and the other anchors
        label = labels([4, 3], 6)
        label[:, 5] = corner
        return anchors(300), label, logits(2, 300), dict(
            MBT_PARAMS, negative_mining_thresh=0.2,
            negative_mining_ratio=30.0)
    if name == "a forced candidate at K*'s top byte":
        # every logit 0.0 or 0.5: K* is one of them, and so is the forced
        # candidate's key
        label = labels([2, 3, 1], 5)
        label[:, 4] = corner
        cls = rng.choice(np.asarray([0.0, 0.5], np.float32), (3, 6, 300),
                         p=[0.9, 0.1])
        return anchors(300), label, cls, MBT_PARAMS
    raise KeyError(name)


def same_bits(torch, got, want):
    """``got`` and ``want`` (float32, any devices) hold the same bits:
    signed zeros told apart, NaNs equal to themselves."""
    return torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))


def bits_apart(torch, got, want):
    return int((got.cpu().view(torch.int32)
                != want.cpu().view(torch.int32)).sum())


def ssd_anchors(torch, mx, dev):
    """SSD-300's 8096 anchors as ``models.ssd``'s MultiBoxPrior layers
    make them (sizes and ratios per feature map, no clip), (1, A, 4)."""
    from mxnet_tpu_torch.ops.defs_contrib import multibox_prior

    ssd = mx.models.ssd
    anc = torch.cat([multibox_prior(m, m, ssd._SIZES[k], ssd._RATIOS[k],
                                    None, (0.5, 0.5), False, device=dev)
                     for k, m in enumerate(SSD_MAPS)], 1)
    if anc.shape[1] != SSD_ANCHORS:
        fail(f"SSD-300's anchors: {anc.shape[1]}, not {SSD_ANCHORS}")
    return anc


def bn_act_parent_order(torch, x, mean, var, gamma, beta, eps, fix_gamma,
                        slope):
    """``bn_act``'s result as the parent kernel rounds it, on the CPU:
    ``inv = 1 / sqrt(var + eps)``, then ``((x - mean) * inv) * gamma +
    beta``, each step one correctly rounded float32 operation, then the
    activation: ``t`` where ``t`` is not below 0 (NaN, -0.0 and +0.0 as
    they are), below it +0.0 (the ReLU, slope 0) or ``slope * t``. The
    square root and the division run in float64 and round once to float32,
    which is the correctly rounded float32 result (53 bits hold more than
    twice 24 + 2); PyTorch's float32 square root on the CPU is not always
    correctly rounded."""
    f32 = torch.float32
    x, mean, var, gamma, beta = (t.cpu() for t in (x, mean, var, gamma,
                                                   beta))
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    root = torch.sqrt((var + torch.tensor(eps, dtype=f32)).double()).to(f32)
    inv = (1.0 / root.double()).to(f32)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    t = (x - mean.reshape(bshape)) * inv.reshape(bshape)
    t = t * gamma.reshape(bshape)
    t = t + beta.reshape(bshape)
    if slope is None:
        return t
    below = (torch.zeros_like(t) if slope == 0
             else t * torch.tensor(slope, dtype=f32))
    return torch.where(t < 0, below, t)


def bn_act_borders(ba):
    """``bn_act``'s shapes at each border of its plan: each side of the
    block sizes' thresholds in both regimes (float4 units, and float units
    with H*W = 1), planes of 1, 2, 3, 4, 8 and 49 floats, C = 1, 3, 1000,
    N = 1, grids that end in a partial block."""
    u, b = ba.UNITS, ba.MIN_BLOCKS - 1
    t256, t128 = b * ba.THREADS[0] * u, b * ba.THREADS[1] * u
    return [(1, 1, 4 * t256), (1, 1, 4 * t256 + 4), (1, 1, 4 * t128),
            (1, 1, 4 * t128 + 4), (1, t256), (1, t256 + 1), (1, t128),
            (1, t128 + 1), (3, 5, 1, 1), (2, 3, 2), (4, 7, 3), (5, 3, 2, 2),
            (2, 6, 2, 4), (2, 1000, 7, 7), (1, 3, 7, 7), (7, 1, 5, 5),
            (3, 5, 7, 9), (1, 2048, 7, 7), (9, 33, 4, 4)]


def bn_act_inputs(torch, gen, dev, shape, offset=0):
    """x (a view at a float ``offset`` into its storage when given) and the
    moving statistics, gamma and beta of a BatchNorm input of ``shape``;
    some of x's elements exact zeros of both signs at channel 0, whose
    mean and beta are 0 and -0.0."""
    c = shape[1]
    n = math.prod(shape)
    x = torch.empty(n + offset, device=dev)[offset:].view(shape)
    x.copy_(torch.randn(shape, generator=gen, device=dev))
    mean = 0.1 * torch.randn(c, generator=gen, device=dev)
    var = 0.5 + torch.rand(c, generator=gen, device=dev)
    gamma = 0.5 + torch.rand(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    if n // c >= 3:
        x0 = x[:, 0].cpu().reshape(-1)
        x0[0::3] = 0.0
        x0[1::3] = -0.0
        x[:, 0] = x0.reshape(x[:, 0].shape).to(dev)
        mean[0], beta[0] = 0.0, -0.0
    return x, mean, var, gamma, beta


def bn_act_path_sets(torch, mx, gen, dev):
    """``bn_act``'s calls on each path: ``{path: (what, [(inputs, count)],
    eps, fix_gamma, slope)}``: ResNet-50 serving's 17 (``PATH_BN``, the
    ReLU), a ResNet-50 training step's 50 (the ReLU), one DCGAN D pass (3,
    leaky 0.2, fix_gamma) and G's pass (4, the ReLU, fix_gamma)."""
    _sym, bn_shapes, _p = resnet50_shapes(mx, TRAIN_BATCH)
    train = {}
    for s in bn_shapes:
        train[s] = train.get(s, 0) + 1
    out = {}
    for path, what, shapes, eps, fix_gamma, slope in (
            ("resnet_serve", "ResNet-50 serving forward, 17 calls",
             dict(PATH_BN), BN_EPS, False, 0.0),
            ("resnet_train", "ResNet-50 training step, 50 calls", train,
             BN_EPS, False, 0.0),
            ("dcgan_d", "DCGAN D pass, 3 leaky calls",
             {s: 1 for s in DCGAN_D_BN}, DCGAN_EPS, True, DCGAN_SLOPE),
            ("dcgan_g", "DCGAN G pass, 4 ReLU calls",
             {s: 1 for s in DCGAN_G_BN}, DCGAN_EPS, True, 0.0)):
        sets = [(bn_act_inputs(torch, gen, dev, s), k)
                for s, k in shapes.items()]
        out[path] = (what, sets, eps, fix_gamma, slope)
    return out


def bn_act_set_times(torch, F, ba, what, sets, eps, fix_gamma, slope,
                     flush):
    """:func:`timed_call` over one path's ``bn_act`` calls back to back,
    beside the library pair (``F.batch_norm`` over the same statistics,
    then ``relu_`` or ``F.leaky_relu``); host us per wrapper call."""
    def each(fn):
        def run():
            for ins, k in sets:
                for _ in range(k):
                    fn(*ins)
        return run

    def lib(x, m, v, g, b):
        y = F.batch_norm(x, m, v, None if fix_gamma else g, b,
                         training=False, eps=eps)
        if slope is None:
            return y
        return F.leaky_relu(y, slope, inplace=True) if slope else y.relu_()

    calls = sum(k for _s, k in sets)
    n_el = sum(k * ins[0].numel() for ins, k in sets)
    c_sum = sum(k * ins[0].shape[1] for ins, k in sets)
    r = timed_call(
        torch, each(lambda *t: ba.bn_act(*t, eps, fix_gamma, slope)),
        each(lambda *t: ba.bn_act_plain(*t, eps, fix_gamma, slope)),
        BN_ACT_MARKS, ba.LAUNCHES, bound(8 * n_el + 16 * c_sum, 5 * n_el),
        flush, what, reps=20, plain_reps=5,
        library=("F.batch_norm + " + ("F.leaky_relu" if slope else "relu_"),
                 each(lib)))
    r["host_us"] /= calls  # per wrapper call; the times are per set
    return r


def mbt_path_inputs(torch, mx, dev, gen):
    """``multibox_target``'s arguments at SSD training's call: SSD-300's
    8096 anchors, the 32 labels of the training phase's batch (1..6
    objects in 16 rows) and N(0, 1) logits through the class-major view of
    class-last memory, as the head hands them, with the symbol's
    parameters."""
    anc = ssd_anchors(torch, mx, dev)
    _x, y = ssd_train_images(SSD_TRAIN_BATCH, SEED + 21)
    label = torch.from_numpy(y).to(dev)
    cls_pred = torch.randn((SSD_TRAIN_BATCH, SSD_ANCHORS, SSD_CLASSES + 1),
                           generator=gen, device=dev).transpose(1, 2)
    return (anc, label, cls_pred, *mbt_args(MBT_PARAMS))


def mbt_times(torch, mbt, args, flush):
    """:func:`timed_call` of ``multibox_target`` at one call ``args``; the
    bound by bytes (a 32-byte sector per strided background logit, the
    anchors and labels once, 9 floats out per anchor) or operations (~12
    per IoU, ~20 per encoded match), whichever is larger."""
    anc, label = args[0], args[1]
    n, g, a = label.shape[0], label.shape[1], anc.numel() // 4
    matched = int((mbt.multibox_target(*args)[2] > 0).sum())
    b = bound(n * a * 32 + a * 16 + label.numel() * 4 + n * a * 9 * 4,
              n * a * g * 12 + matched * 20)
    return timed_call(
        torch, lambda: mbt.multibox_target(*args),
        lambda: mbt.multibox_target_plain(*args), MBT_MARKS, mbt.LAUNCHES,
        b, flush, f"A {a}, G {g}, batch {n}, class-major logits, {matched} "
        f"matched", plain_reps=3)


def kernel_times_bn_act_mbt(torch, mx):
    """``bn_act`` over each path's calls (:func:`bn_act_path_sets`) and
    ``multibox_target`` at SSD training's call (:func:`mbt_path_inputs`):
    the kernel back to back by CUDA events (warm), the L2 cache cold
    (median single runs), the device time under the profiler by kernel
    name, the launches, the plain version, the library pair for
    ``bn_act`` (no single PyTorch call computes ``multibox_target``), the
    bound and the wrapper's host microseconds per call. Uses only the
    wrappers' public calls, so it times any checkout's package
    (``--kernel-times``)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import bn_act as ba
    from mxnet_tpu_torch.kernels import multibox_target as mbt

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {"bn_act": {}, "multibox_target": {}}
    for path, (what, sets, eps, fix_gamma, slope) in bn_act_path_sets(
            torch, mx, gen, dev).items():
        out["bn_act"][path] = bn_act_set_times(
            torch, F, ba, what, sets, eps, fix_gamma, slope, flush)
        sets.clear()
    out["multibox_target"]["ssd_train"] = mbt_times(
        torch, mbt, mbt_path_inputs(torch, mx, dev, gen), flush)
    del flush
    return out


def phase_redesign_bn_act_mbt(torch, mx, card, recorded):
    """The redesigned ``bn_act`` and ``multibox_target`` on the card.
    ``bn_act``: bit for bit against the parent kernel's per-element order
    (:func:`bn_act_parent_order`) for no activation, the ReLU and the leaky
    ReLU, at every path shape (:func:`bn_act_path_sets`) and at
    :func:`bn_act_borders`, aligned and at float offsets 1 and 3 (the
    scalar regime), each border also forced into the other regimes
    (``run_plan``); within ``BN_RTOL``/``BN_ATOL`` of ``bn_act_plain`` at
    the path shapes; one launch a call, the leaky ones counted. Then
    ``multibox_target`` bit for bit against its plain version on the SSD
    step's recorded call and on ``MBT_CASES`` and ``MBT_EDGES``, each with
    the mining on and off, one launch a call. Neither copies to or from the
    host or synchronises in a call. Then :func:`kernel_times_bn_act_mbt`."""
    from mxnet_tpu_torch.kernels import bn_act as ba
    from mxnet_tpu_torch.kernels import multibox_target as mbt

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    t0 = time.perf_counter()
    cases = []
    for path, (what, sets, eps, fix_gamma, slope) in bn_act_path_sets(
            torch, mx, gen, dev).items():
        for ins, _k in sets:
            cases.append((f"{path} {tuple(ins[0].shape)}", ins, eps,
                          fix_gamma, True))
    for shape in bn_act_borders(ba):
        for offset in (0, 1, 3):
            cases.append((f"{shape} offset {offset}",
                          bn_act_inputs(torch, gen, dev, shape, offset),
                          BN_EPS,
                          offset == 1, False))
    regimes, calls, plain_err = {}, 0, 0.0
    for what, ins, eps, fix_gamma, path in cases:
        x = ins[0]
        p = ba.plan(x.shape[0], x.shape[1], x.numel() // math.prod(
            x.shape[:2]), x.data_ptr() % 16 == 0)
        regimes[p.regime] = regimes.get(p.regime, 0) + 1
        for slope in (None, 0.0, DCGAN_SLOPE):
            want = bn_act_parent_order(torch, *ins, eps, fix_gamma, slope)
            before = (ba.LAUNCHES.value, ba.LEAKY_LAUNCHES.value)
            got = ba.bn_act(*ins, eps, fix_gamma, slope)
            launches = (ba.LAUNCHES.value - before[0],
                        ba.LEAKY_LAUNCHES.value - before[1])
            calls += 1
            if launches != (1, 1 if slope else 0):
                fail(f"bn_act {what} slope {slope}: launches {launches}")
            if not same_bits(torch, got, want):
                fail(f"bn_act {what} slope {slope}: "
                     f"{bits_apart(torch, got, want)} values differ from "
                     f"the parent's order in their bits")
            if path:
                plain_err = max(plain_err, check(
                    torch, f"bn_act {what} slope {slope}", got,
                    ba.bn_act_plain(*ins, eps, fix_gamma, slope), BN_RTOL,
                    BN_ATOL))
            elif p.regime != "wide":
                # every other regime on the same inputs: the same bits
                for regime in ("scalar", "wide"):
                    if regime == p.regime:
                        continue
                    q = p._replace(regime=regime, unit=1, d_magic=0,
                                   d_shift=0, c_magic=0, c_shift=0)
                    if regime == "scalar":
                        q = ba.plan(x.shape[0], x.shape[1],
                                    x.numel() // math.prod(x.shape[:2]),
                                    False)
                    got = ba.run_plan(q, *ins, eps, fix_gamma, slope)
                    calls += 1
                    if not same_bits(torch, got, want):
                        fail(f"bn_act {what} slope {slope}: regime "
                             f"{regime} differs from the parent's order")
    ins = cases[0][1]
    syncs = host_syncs(torch, lambda: ba.bn_act(*ins, BN_EPS, False, 0.0))
    if syncs:
        fail(f"bn_act copied to or from the host or synchronised {syncs} "
             f"times in 3 calls")
    print(f"[redesign-bn-act] bn_act equals the parent kernel's order bit "
          f"for bit in {calls} calls ({len(cases)} inputs x no activation, "
          f"the ReLU and leaky {DCGAN_SLOPE}: every path shape of ResNet-50 "
          f"serving and training and DCGAN D and G, and "
          f"{len(bn_act_borders(ba))} border shapes aligned and at float "
          f"offsets 1 and 3, each also forced into the other regimes; "
          f"plans {regimes}); within rtol {BN_RTOL} atol {BN_ATOL} of its "
          f"plain version at the path shapes (max abs err {plain_err:g}); "
          f"one launch a call; 0 host copies or synchronisations in 3 calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del cases

    t0 = time.perf_counter()
    step = recorded["multibox_target"]
    calls = [("the SSD step's call", step[:3], list(step[3:]))]
    for name in MBT_CASES:
        a_np, l_np, c_np, p = mbt_case(name)
        calls.append((name, [torch.from_numpy(t).to(dev)
                             for t in (a_np, l_np, c_np)], mbt_args(p)))
    for name in MBT_EDGES:
        a_np, l_np, c_np, p = mbt_edge_case(name)
        calls.append((name, [torch.from_numpy(t).to(dev)
                             for t in (a_np, l_np, c_np)], mbt_args(p)))
    n_calls = 0
    for what, ins, params in calls:
        for ratio in (params[2], -1.0 if params[2] > 0 else 3.0):
            args = [*ins, *params[:2], ratio, *params[3:]]
            before = mbt.LAUNCHES.value
            got = mbt.multibox_target(*args)
            launches = mbt.LAUNCHES.value - before
            want = mbt.multibox_target_plain(*args)
            n_calls += 1
            if launches != 1:
                fail(f"multibox_target {what}: {launches} launches")
            for out, g_, w_ in zip(("loc_target", "loc_mask", "cls_target"),
                                   got, want):
                if not same_bits(torch, g_, w_):
                    fail(f"multibox_target {what} (mining ratio {ratio}): "
                         f"{bits_apart(torch, g_, w_)} values of {out} "
                         f"differ from the plain version in their bits")
    syncs = host_syncs(torch, lambda: mbt.multibox_target(*step))
    if syncs:
        fail(f"multibox_target copied to or from the host or synchronised "
             f"{syncs} times in 3 calls")
    print(f"[redesign-mbt] multibox_target equals its plain version bit "
          f"for bit in {n_calls} calls (the SSD step's, {len(MBT_CASES)} "
          f"edge cases and {len(MBT_EDGES)} more: ties at K* across the "
          f"blocks, the last block's best anchor, max_neg 0 and >= A, G = 1 "
          f"with A = 1, A = 1237 with G = 33; each with the mining on and "
          f"off); plan at SSD's call {mbt.plan(SSD_ANCHORS, SSD_OBJECTS)}; "
          f"one launch a call; 0 host copies or synchronisations in 3 calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    times = kernel_times_bn_act_mbt(torch, mx)
    print_redesign_times(times, card, "redesign")
    return times, plain_err


# --- 13e: the redesigned l2norm_channel and multibox_decode -----------------
# every kernel name of the two forward functions, the parent's and this
# one's (the backward's names hold "l2norm_channel_bwd_", not these)
L2_MARKS = ("l2norm_channel_kernel",)
DECODE_MARKS = ("multibox_decode_kernel",)
L2_SLICES = 16  # the channel slices whose partial sums the kernel adds
# where a bits digest of each turn's outputs is kept (--kernel-times), so a
# later turn in the same call can say whether its kernels give the bits an
# earlier checkout's gave on the same inputs
KERNEL_BITS = "build/kernel_times_bits.json"


def l2norm_order(torch, x, eps, scale):
    """``l2norm_channel``'s result as its kernel rounds it, on the CPU: the
    thread of slice ``j`` of 16 sums the squares of channels ``j, j + 16,
    ...`` in order, each square and sum one float32 rounding; the 16
    partials are added in slice order; then ``norm = sqrt(total + eps)``,
    ``x / norm`` and ``* scale``, each one correctly rounded float32
    operation (the square root and the quotient run in float64 and round
    once to float32, which is the correctly rounded result: 53 bits hold
    more than twice 24 + 2)."""
    f32 = torch.float32
    x = x.cpu()
    n, c = x.shape[0], x.shape[1]
    xs = x.reshape(n, c, -1)
    part = torch.zeros((n, L2_SLICES, xs.shape[2]), dtype=f32)
    for j0 in range(0, c, L2_SLICES):
        v = xs[:, j0:j0 + L2_SLICES]
        m = v.shape[1]
        part[:, :m] = part[:, :m] + v * v
    total = torch.zeros((n, 1, xs.shape[2]), dtype=f32)
    for j in range(L2_SLICES):
        total = total + part[:, j:j + 1]
    total = total + torch.tensor(eps, dtype=f32)
    norm = torch.sqrt(total.double()).to(f32)
    q = (xs.double() / norm.double()).to(f32)
    return (q * torch.tensor(scale, dtype=f32)).reshape(x.shape)


def l2_edges():
    """``l2norm_channel``'s edge shapes: C = 1, 3, 16, 17, 512 and 513
    (each side of the two-pass border and of the first k border), H*W = 1
    and odd, rank 2, blocks straddling two images (H*W = 35, 9), one image
    at SSD's C (serving bucket 1), each side of the narrow and the wide
    tile's borders, and C = 1000."""
    return [(3, 1, 5, 7), (2, 3, 7, 9), (4, 16, 3, 3), (4, 17, 3, 3),
            (1, 512, 37, 37), (2, 513, 3, 5), (4, 6, 1, 1), (5, 3),
            (3, 8, 5, 7), (7, 21, 3, 3), (2, 512, 45, 45), (3, 512, 37, 37),
            (1, 1000, 1, 1), (23, 512, 37, 37), (24, 512, 37, 37)]


def l2_nan_edges(torch, gen, dev):
    """``l2norm_channel``'s inputs where a position's norm is NaN or 0, in
    each regime (C = 512 on chip, 513 in two passes): one position holds a
    NaN among zeros and another a column of zeros, at eps 0. The reference
    gives NaN in every channel of both positions, zeros included. Returns
    ``[(what, x, eps)]``."""
    cases = []
    for c in (512, 513):
        x = torch.randn((2, c, 3, 5), generator=gen, device=dev)
        x[0, :, 1, 2] = 0.0
        x[0, 7, 1, 2] = float("nan")
        x[1, :, 2, 4] = 0.0
        cases.append((f"(2, {c}, 3, 5) a NaN among zeros and a column of "
                      f"zeros at eps 0", x, 0.0))
    return cases


def same_values(torch, got, want):
    """``got`` holds ``want``'s bits wherever ``want`` is a number and NaN
    wherever it is NaN (NaN payloads are not compared)."""
    g, w = got.cpu(), want.cpu()
    nan = torch.isnan(w)
    return torch.equal(torch.isnan(g), nan) and torch.equal(
        g[~nan].view(torch.int32), w[~nan].view(torch.int32))


def l2_offset_view(torch, gen, dev, shape):
    """A contiguous ``shape`` whose data starts one float past a 16-byte
    boundary."""
    flat = torch.randn(math.prod(shape) + 1, generator=gen, device=dev)
    return flat[1:].view(shape)


def decode_views(torch, gen, dev, n, a, c1=SSD_CLASSES + 1):
    """Class scores ``(n, c1, a)`` in each layout ``multibox_decode`` takes,
    with offsets and anchors: the SSD paths' transposed view of (n, A, C+1)
    logits (body ``rows``), a class-major copy, a view of wider rows
    (``sa`` = C+4), a view of a batch padded past A anchors an image, and
    the transposed view one float off alignment (each ``strided``).
    Returns ``[(what, cls, loc, anchors)]``."""
    logits = torch.randn((n, a, c1), generator=gen, device=dev) * 1.5
    wide = torch.randn((n, a, c1 + 3), generator=gen, device=dev) * 1.5
    padded = torch.randn((n, a + 5, c1), generator=gen, device=dev) * 1.5
    flat = torch.randn(n * a * c1 + 1, generator=gen, device=dev) * 1.5
    loc = torch.randn((n, 4 * a), generator=gen, device=dev)
    lo = torch.rand((1, a, 2), generator=gen, device=dev) * 0.8
    anchors = torch.cat([lo, lo + 0.02 + 0.48 * torch.rand(
        (1, a, 2), generator=gen, device=dev)], 2)
    views = [("transposed", logits.transpose(1, 2)),
             ("class-major", logits.transpose(1, 2).contiguous()),
             ("rows of C+4", wide[..., :c1].transpose(1, 2)),
             ("padded images", padded[:, :a].transpose(1, 2)),
             ("off alignment", flat[1:].view(n, a, c1).transpose(1, 2))]
    return [(what, cls, loc, anchors) for what, cls in views]


def decode_check(torch, dec, what, args):
    """``multibox_decode`` on ``args`` against its plain version: boxes and
    scores within ``DECODE_RTOL``/``DECODE_ATOL``, class ids equal where the
    two best probabilities are further apart than that; one launch a call
    and two calls bit for bit. Returns the outputs and the largest error."""
    before = dec.LAUNCHES.value
    got = dec.multibox_decode(*args)
    launches = dec.LAUNCHES.value - before
    again = dec.multibox_decode(*args)
    want = dec.multibox_decode_plain(*args)
    err = 0.0
    for name, g, w in zip(("boxes", "score"), got[:2], want[:2]):
        err = max(err, check(torch, f"multibox_decode {what} {name}", g, w,
                             DECODE_RTOL, DECODE_ATOL))
    cls, softmax = args[0], args[5]
    fg = (dec.channel_softmax(cls) if softmax else cls)[:, 1:]
    top2 = torch.topk(fg, 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > DECODE_RTOL * top2[:, 0] + DECODE_ATOL
    bad = int(((got[2] != want[2]) & clear).sum())
    if bad:
        fail(f"multibox_decode {what}: {bad} class ids differ where the two "
             f"best probabilities are apart")
    if launches != 1 or not all(torch.equal(g, h)
                                for g, h in zip(got, again)):
        fail(f"multibox_decode {what}: {launches} launches, or two calls "
             f"differ")
    return got, err


def l2_check(torch, l2, what, x, eps, scale):
    """``l2norm_channel`` on ``x``: bit for bit with :func:`l2norm_order`
    (NaN where it is NaN), NaN where the plain version is and within
    ``L2_RTOL``/``L2_ATOL`` x scale of it elsewhere, one launch a call, two
    calls bit for bit. Returns the largest error."""
    before = l2.LAUNCHES.value
    got = l2.l2norm_channel(x, eps, scale)
    launches = l2.LAUNCHES.value - before
    again = l2.l2norm_channel(x, eps, scale)
    if launches != 1 or not same_bits(torch, got, again):
        fail(f"l2norm_channel {what}: {launches} launches, or two calls "
             f"differ")
    want = l2norm_order(torch, x, eps, scale)
    if not same_values(torch, got, want):
        fail(f"l2norm_channel {what} x {scale}: "
             f"{bits_apart(torch, got, want)} values differ from the "
             f"kernel's order in their bits")
    plain = l2.l2norm_channel_plain(x, eps, scale)
    nan = torch.isnan(plain)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"l2norm_channel {what} x {scale}: NaN where the plain "
             f"version is not, or the other way round")
    return check(torch, f"l2norm_channel {what} x {scale}", got[~nan],
                 plain[~nan], L2_RTOL, L2_ATOL * scale)


def path_calls_l2_decode(serve, train):
    """The two kernels' path calls from the recorded ones: ``serve`` the
    SSD-300 forward's at bucket 8 (``{kernel: args}``), its first image as
    bucket 1, and ``train`` the training step's at batch 32. Returns
    ``{kernel: {path: args}}``."""
    x, eps, scale = serve["l2norm_channel"]
    cls, loc, anc, var, clip, sm = serve["multibox_decode"]
    return {
        "l2norm_channel": {"serve_b1": (x[:1], eps, scale),
                           "serve_b8": (x, eps, scale),
                           "ssd_train": train["l2norm_channel"]},
        "multibox_decode": {"serve_b1": (cls[:1], loc[:1], anc, var, clip,
                                         sm),
                            "serve_b8": (cls, loc, anc, var, clip, sm),
                            "ssd_train": train["multibox_decode"]}}


def bits_digest(torch, outs):
    """A digest of the bits of ``outs`` (tensors, on any device)."""
    import hashlib

    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def kernel_times_l2norm_decode(torch, calls):
    """``l2norm_channel`` and ``multibox_decode`` at each path call of
    :func:`path_calls_l2_decode` (SSD serving at buckets 1 and 8, SSD
    training at batch 32): the kernel back to back by CUDA events (warm),
    single calls with the L2 cache cold (median), the device time under the
    profiler by kernel name, the launches a call, the plain version,
    ``F.normalize * scale`` for the normalization (no single PyTorch call
    computes the decode), the bound, the wrapper's host microseconds per
    call, and a digest of each call's output bits. Uses only the wrappers'
    public calls, so it times any checkout's package (``--kernel-times``)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import l2norm_channel as l2
    from mxnet_tpu_torch.kernels import multibox_decode as dec

    dev = torch.device("cuda", 0)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {"l2norm_channel": {}, "multibox_decode": {}}
    for path, (x, eps, scale) in calls["l2norm_channel"].items():
        n = x.numel()
        r = timed_call(
            torch, lambda x=x, eps=eps, scale=scale: l2.l2norm_channel(
                x, eps, scale),
            lambda x=x, eps=eps, scale=scale: l2.l2norm_channel_plain(
                x, eps, scale),
            L2_MARKS, l2.LAUNCHES, bound(8 * n, 4 * n), flush,
            f"{tuple(x.shape)} x {scale}",
            library=(f"F.normalize * {scale}",
                     lambda x=x, scale=scale: F.normalize(x, dim=1) * scale),
            reps=200 if n < 1e7 else 50)
        r["bits"] = bits_digest(torch, [l2.l2norm_channel(x, eps, scale)])
        out["l2norm_channel"][path] = r
    for path, args in calls["multibox_decode"].items():
        cls = args[0]
        nb, c1, a = cls.shape
        r = timed_call(
            torch, lambda args=args: dec.multibox_decode(*args),
            lambda args=args: dec.multibox_decode_plain(*args),
            DECODE_MARKS, dec.LAUNCHES,
            bound(nb * a * (4 * c1 + 16 + 16 + 8) + a * 16,
                  nb * a * (5 * c1 + 20)), flush,
            f"{tuple(cls.shape)} strides {cls.stride()} "
            f"{'logits' if args[5] else 'probabilities'}", reps=200)
        r["bits"] = bits_digest(torch, dec.multibox_decode(*args))
        out["multibox_decode"][path] = r
    del flush
    return out


def compare_bits(times, package):
    """Keep this turn's bits digests under ``package`` in ``KERNEL_BITS``
    and print, for each checkout timed earlier in the same call, whether
    each call's outputs hold the same bits."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        KERNEL_BITS)
    seen = {}
    if os.path.exists(path):
        with open(path) as f:
            seen = json.load(f)
    mine = {f"{k} {p}": r["bits"] for k, paths in times.items()
            for p, r in paths.items()}
    for other, digests in seen.items():
        if other == package:
            continue
        same = sorted(k for k in mine if digests.get(k) == mine[k])
        apart = sorted(k for k in mine if digests.get(k) != mine[k])
        print(f"[kernel-times] bits against {other}: the same at {same}; "
              f"apart at {apart}", flush=True)
    seen[package] = mine
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(seen, f)


def host_breakdown_decode(torch, args, reps=2000):
    """Host microseconds of each piece of ``multibox_decode``'s launch path
    at ``args`` (a cached layout), back to back without a sync: the whole
    call, the layout's key and lookup, the compound check of ``loc`` and
    ``anchors``, the three output views of one allocation, the allocation
    alone, and the launch with the outputs."""
    from mxnet_tpu_torch.kernels import multibox_decode as dec

    cls, loc, anc, var, clip, sm = args
    dec.multibox_decode(*args)
    dv, f32 = cls.get_device(), torch.float32
    lay = dec._layouts[(cls.dtype, cls.shape, cls.stride(), dv,
                        cls.data_ptr() % 16 == 0)]
    n, _c1, a = cls.shape

    def key():
        return dec._layouts.get((cls.dtype, cls.shape, cls.stride(),
                                 cls.get_device(), cls.data_ptr() % 16 == 0))

    def checked():
        return (loc.dtype is f32 and loc.get_device() == dv
                and loc.shape == lay[0] and loc.is_contiguous()
                and anc.dtype is f32 and anc.get_device() == dv
                and anc.shape == lay[1] and anc.is_contiguous()
                and not loc.data_ptr() % 16 and not anc.data_ptr() % 16)

    pieces = {
        "whole call": lambda: dec.multibox_decode(*args),
        "key and lookup": key, "compound check": checked,
        "outputs": lambda: dec.outputs(n, a, cls.device),
        "torch.empty": lambda: torch.empty((6, n, a), device=cls.device),
        "outputs and launch": lambda: dec._launch(
            cls, cls.data_ptr(), loc.data_ptr(), anc.data_ptr(), lay[2],
            lay[3], lay[4], var, clip, sm)}
    return {k: host_us(torch, fn, reps) for k, fn in pieces.items()}


def phase_redesign_l2norm_decode(torch, mx, card, calls):
    """The redesigned ``l2norm_channel`` and ``multibox_decode`` on the
    card. ``l2norm_channel``: on the recorded SSD serving (bucket 8 and its
    first image as bucket 1) and training calls, at :func:`l2_edges`, a
    view one float off alignment and :func:`l2_nan_edges` (norms of NaN
    and 0), scale 1 and 20: bit for bit with the kernel's order
    (:func:`l2norm_order`; NaN where it is NaN), within
    ``L2_RTOL``/``L2_ATOL`` of its plain version, the planned regime, one
    launch a call, two calls bit for bit, and every tile forced on the same
    inputs giving the same bits. ``multibox_decode``: on the recorded
    serving (logits, the transposed view) and training (probabilities)
    calls, bucket 1, and on :func:`decode_views` at A = 1000 and 77 (no
    multiple of a block's anchors) and 1, and at 401 classes (the wide
    body), on logits and probabilities, clip on and off, within
    ``DECODE_RTOL``/``DECODE_ATOL`` with class ids equal where the best
    class is clear, the body as planned, one launch a call, two calls bit
    for bit. Neither copies to or from the host or synchronises in a call.
    Then :func:`kernel_times_l2norm_decode`."""
    from mxnet_tpu_torch.kernels import l2norm_channel as l2
    from mxnet_tpu_torch.kernels import multibox_decode as dec

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    t0 = time.perf_counter()
    cases = [(f"{path} {tuple(x.shape)}", x, eps, scale)
             for path, (x, eps, scale) in calls["l2norm_channel"].items()]
    for shape in l2_edges():
        x = torch.randn(shape, generator=gen, device=dev)
        cases += [(str(shape), x, SSD_L2_EPS, 1.0),
                  (str(shape), x, SSD_L2_EPS, 20.0)]
    x = l2_offset_view(torch, gen, dev, (2, 512, 37, 37))
    cases.append(("(2, 512, 37, 37) one float off alignment", x,
                  SSD_L2_EPS, 20.0))
    for what, x, eps in l2_nan_edges(torch, gen, dev):
        cases += [(what, x, eps, 1.0), (what, x, eps, 20.0)]
    err, plans, forced = 0.0, {}, 0
    for what, x, eps, scale in cases:
        err = max(err, l2_check(torch, l2, what, x, eps, scale))
        c = x.shape[1]
        p = l2.plan(c)
        pos = l2.tile(x.numel() // c)
        key = f"{p.regime} (k {p.k}, {pos} positions)"
        plans[key] = plans.get(key, 0) + 1
        if p.regime == "onchip" and (p.k != next(
                k for k in l2.K_CHOICES if 16 * k >= c) or c > 512):
            fail(f"l2norm_channel plans {p} at C = {c}")
        if p.regime == "two_pass" and c <= 512:
            fail(f"l2norm_channel plans {p} at C = {c}")
        if p.regime == "onchip":
            want = l2.l2norm_channel(x, eps, scale)
            for other in l2.TILES:
                forced += 1
                if not same_bits(torch, l2.run_plan(p, other, x, eps,
                                                    scale), want):
                    fail(f"l2norm_channel {what}: {other} positions a "
                         f"block give other bits")
    x, eps, scale = calls["l2norm_channel"]["ssd_train"]
    if l2.plan(x.shape[1]).regime != "onchip":
        fail(f"l2norm_channel does not plan the on-chip regime at "
             f"{tuple(x.shape)}")
    syncs = host_syncs(torch, lambda: l2.l2norm_channel(x, eps, scale))
    if syncs:
        fail(f"l2norm_channel copied to or from the host or synchronised "
             f"{syncs} times in 3 calls")
    zeros = {path: round(float((x == 0).float().mean()), 4)
             for path, (x, _eps, _scale) in calls["l2norm_channel"].items()}
    print(f"[redesign-l2] the recorded inputs' share of exact zeros (ReLU "
          f"outputs; the kernel skips the division there): {zeros}",
          flush=True)
    print(f"[redesign-l2] l2norm_channel equals the kernel's order bit for "
          f"bit in {len(cases)} cases (SSD serving at buckets 1 and 8, "
          f"training, {len(l2_edges())} edge shapes x scale 1 and 20, a "
          f"view one float off alignment, NaN where a norm is NaN or 0), "
          f"and {forced} more calls forcing "
          f"each tile of {l2.TILES}; within rtol {L2_RTOL} atol {L2_ATOL} x "
          f"scale of its plain version (max abs err {err:g}); plans "
          f"{plans}; one launch a call, two calls bit for bit; 0 host "
          f"copies or synchronisations in 3 calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    dcases = [(f"{path} {tuple(args[0].shape)} "
               f"{'logits' if args[5] else 'probabilities'}", args)
              for path, args in calls["multibox_decode"].items()]
    var = (0.1, 0.1, 0.2, 0.2)
    for n, a, c1 in ((3, 1000, 21), (2, 77, 21), (1, 1, 21), (2, 50, 401)):
        for what, cls, loc, anc in decode_views(torch, gen, dev, n, a, c1):
            probs = dec.channel_softmax(cls)
            for clip in (True, False):
                dcases += [(f"({n}, {c1}, {a}) {what} logits clip {clip}",
                            (cls, loc, anc, var, clip, True)),
                           (f"({n}, {c1}, {a}) {what} probabilities clip "
                            f"{clip}", (probs, loc, anc, var, clip, False))]
    derr, bodies = 0.0, {}
    for what, args in dcases:
        cls = args[0]
        p = dec.plan(*cls.shape, cls.stride(), cls.data_ptr() % 16 == 0)
        bodies[p.body] = bodies.get(p.body, 0) + 1
        derr = max(derr, decode_check(torch, dec, what, args)[1])
    for path, args in calls["multibox_decode"].items():
        cls = args[0]
        if dec.plan(*cls.shape, cls.stride(),
                    cls.data_ptr() % 16 == 0).body != "rows":
            fail(f"multibox_decode does not stage the rows of the {path} "
                 f"call's view, strides {cls.stride()}")
    args = calls["multibox_decode"]["serve_b8"]
    syncs = host_syncs(torch, lambda: dec.multibox_decode(*args))
    if syncs:
        fail(f"multibox_decode copied to or from the host or synchronised "
             f"{syncs} times in 3 calls")
    print(f"[redesign-decode] multibox_decode holds its plain version in "
          f"{len(dcases)} calls (SSD serving at buckets 1 and 8 on logits, "
          f"training on probabilities, and the transposed, class-major, "
          f"wider-row, padded and misaligned views at A = 1000, 77 and 1 "
          f"and at 401 classes on logits and probabilities, clip on and "
          f"off): boxes and scores "
          f"within rtol {DECODE_RTOL} atol {DECODE_ATOL} (max abs err "
          f"{derr:g}), class ids equal where the best class is clear; "
          f"bodies {bodies}; one launch a call, two calls bit for bit; 0 "
          f"host copies or synchronisations in 3 calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    pieces = host_breakdown_decode(torch, args)
    print(f"[redesign-decode] multibox_decode's host path at serving bucket "
          f"8, us a call: " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in pieces.items()),
          flush=True)
    times = kernel_times_l2norm_decode(torch, calls)
    print_redesign_times(times, card, "redesign")
    return times, err, derr


def resnet50_numpy(mx, seed):
    """ResNet-50 parameters as numpy: He-normal weights, gamma 1, beta and
    biases 0, moving_mean 0, moving_var 1."""
    sym, _bn, params = resnet50_shapes(mx, 1)
    rng = np.random.default_rng(seed)
    args = {}
    for name, shape in params:
        if name.endswith("_weight"):
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            args[name] = rng.standard_normal(shape, np.float32) * std
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        else:
            args[name] = np.zeros(shape, np.float32)
    _, _, aux_shapes = sym.infer_shape(data=(1, 3, 224, 224))
    auxs = {n: (np.ones if n.endswith("_var") else np.zeros)(s, np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, args, auxs


def cross_entropy(torch, probs, labels):
    """Mean cross-entropy of (N, K) probabilities against labels, on the
    probabilities' device."""
    p = probs[torch.arange(probs.shape[0], device=probs.device),
              labels.to(torch.int64)]
    return -torch.log(p + 1e-8).mean()


# device kernels of convolutions (cuDNN's implicit GEMM, FFT and Winograd
# kernels and their filter transforms), by name under torch.profiler
CONV_KERNELS = ("xmma", "conv", "fft", "winograd", "implicit", "wgrad",
                "dgrad", "flip_filter", "pointwise_mult_and_sum")


def profile_step(torch, step, reps=2, tag="profile",
                 what=f"one training step at batch {TRAIN_BATCH}"):
    """Kernels of one training step by self device time (kernel events
    only), the device's busy share of the wall time and the convolutions'
    share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total / reps, round(ev.count / reps), ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total]
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"[{tag}] torch.profiler recorded no device time")
        return {}
    conv = sum(us for us, _c, key in rows
               if any(m in key.lower() for m in CONV_KERNELS))
    print(f"[{tag}] {what}: device busy {busy / 1e3:.2f} ms of "
          f"{wall_us / reps / 1e3:.2f} ms wall "
          f"({100 * busy * reps / wall_us:.0f}%), "
          f"{sum(r[1] for r in rows)} launches; convolution kernels "
          f"{conv / 1e3:.2f} ms ({100 * conv / busy:.1f}% of device time); "
          f"top kernels by device time:")
    for us, count, key in sorted(rows, reverse=True)[:14]:
        print(f"[{tag}]   {us / 1e3:8.3f} ms {100 * us / busy:5.1f}% "
              f"x{count:<4d} {key[:90]}")
    # the port's kernels: device time per step, apart from the host's
    # launch path that the CUDA-event times above include
    ours = {}
    for us, count, key in rows:
        for kernel, mark in {**PORT_KERNELS, **LEAKY_MARKS}.items():
            if mark in key:
                ms, n = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms + us / 1e3, n + count)
    for kernel, (ms, n) in sorted(ours.items()):
        print(f"[{tag}]   port kernel {kernel}: {ms:.4f} ms device time in "
              f"{n} launches per step")
    return {k: v[0] for k, v in ours.items()}


def resnet_train_launches(mx):
    """ResNet-50's launches per training step at ``TRAIN_BATCH``:
    ``bn_act_bwd`` one a call in the block and cluster regimes, two in the
    two-phase one, as its planner gives them on this card."""
    from mxnet_tpu_torch.kernels import bn_act_bwd

    shapes = resnet50_shapes(mx, TRAIN_BATCH)[1]
    bwd = sum(bn_act_bwd.plan(s[0], s[1], math.prod(s[2:]),
                              *bn_act_bwd.device_limits(0)).launches
              for s in shapes)
    return {"bn_stats": len(shapes), "bn_act": len(shapes), "bn_act_bwd": bwd,
            "softmax_rows": 1, "softmax_output_bwd": 1, "sgd_mom_multi": 1}


@contextlib.contextmanager
def device_prefetch(on):
    """``MXNET_DEVICE_PREFETCH`` set to ``on`` for the block."""
    old = os.environ.get("MXNET_DEVICE_PREFETCH")
    os.environ["MXNET_DEVICE_PREFETCH"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXNET_DEVICE_PREFETCH"]
        else:
            os.environ["MXNET_DEVICE_PREFETCH"] = old


def batch_sources(torch, x, y, batch):
    """The batches an ``NDArrayIter`` over ``x``, ``y`` gives, as tensors
    on the card (copied here, apart from any fit)."""
    dev = torch.device("cuda", 0)
    return [[torch.from_numpy(np.ascontiguousarray(a[i:i + batch])).to(dev)
             for a in (x, y)] for i in range(0, len(x), batch)]


def fit_timer(torch, steps, sources):
    """A batch-end callback for a ``Module.fit`` of ``steps`` batches and
    its reader. The callback holds each step's batch against its source in
    ``sources`` on the card (a count of the values apart, no host read),
    and drains the card at the end of the first step and of the last,
    reading the host's clock and the fit spans there. ``read()`` gives per
    step over steps 2..``steps``: ms, ``fit.data_wait``, ``fit.dispatch``
    and the prefetcher's consumer wait in ms, and the values apart."""
    from mxnet_tpu_torch import telemetry as tm

    spans = ("fit.data_wait", "fit.dispatch", "io.prefetch.consumer_wait_us")
    marks = {}
    apart = torch.zeros((), dtype=torch.int64, device="cuda")

    def callback(param):
        batch = param.locals["data_batch"]
        for got, want in zip(batch.data + batch.label,
                             sources[param.nbatch]):
            apart.add_((got._data != want).sum())
        if param.nbatch in (0, steps - 1):
            torch.cuda.synchronize()
            marks[param.nbatch] = [time.perf_counter()] + [
                tm.histogram(n).sum for n in spans]

    def read():
        timed = steps - 1
        d = [(b - a) / timed for a, b in zip(marks[0], marks[steps - 1])]
        return {"fit_ms": d[0] * 1e3, "wait_ms": d[1] / 1e3,
                "dispatch_ms": d[2] / 1e3, "consumer_ms": d[3] / 1e3,
                "apart": int(apart)}

    return callback, read


def copy_ms(torch, x, reps=7):
    """One batch's copy to the card alone, the card idle, median of
    ``reps`` by CUDA events: from pageable memory (an unprefetched
    ``NDArrayIter``) and from page-locked memory (the prefetch thread)."""
    dev = torch.device("cuda", 0)
    src = torch.from_numpy(np.ascontiguousarray(x))
    out = {}
    for name, t in (("pageable", src), ("pinned", src.pin_memory())):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t.to(dev, non_blocking=name == "pinned")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = sorted(times)[reps // 2]
    return out


def prefetch_report(tag, card, batch, nbytes, on, off, copy):
    """Print a fit's two timings, prefetch on and off, with
    ``fit.data_wait`` split into the copy and the wait; returns the split
    for the phase's summary."""
    mb = nbytes / 1e6
    print(f"[{tag}] Module.fit at batch {batch} on {card}, steps after the "
          f"first by the host's clock, prefetch on (the default): "
          f"{on['fit_ms']:.2f} ms per step ({batch * 1e3 / on['fit_ms']:.1f} "
          f"images/s); per step fit.data_wait {on['wait_ms']:.3f} ms (the "
          f"wait: of it the prefetcher's queue {on['consumer_ms']:.3f} ms; "
          f"the copy, {mb:.1f} MB from page-locked memory on a side "
          f"stream, {copy['pinned']:.3f} ms alone by CUDA events, runs under "
          f"the step), fit.dispatch {on['dispatch_ms']:.2f} ms", flush=True)
    wait = off["wait_ms"] - copy["pageable"]
    print(f"[{tag}] Module.fit at batch {batch} on {card}, the same, "
          f"MXNET_DEVICE_PREFETCH=0: {off['fit_ms']:.2f} ms per step "
          f"({batch * 1e3 / off['fit_ms']:.1f} images/s); per step "
          f"fit.data_wait {off['wait_ms']:.3f} ms = the copy from pageable "
          f"memory {copy['pageable']:.3f} ms alone by CUDA events + the wait "
          f"behind the card's queue {wait:.3f} ms; fit.dispatch "
          f"{off['dispatch_ms']:.2f} ms", flush=True)
    return {"on": on, "off": off, "copy": copy}


def module_state(mod):
    """A module's parameters and auxiliary states as numpy, by kind."""
    args, auxs = mod.get_params()
    return {"param": {n: a.asnumpy() for n, a in args.items()},
            "aux": {n: a.asnumpy() for n, a in auxs.items()}}


def prefetch_check(torch, tag, steps, on, off, fit, limits):
    """Both timed fits' batches bit for bit their sources; then ``fit(on)``
    (a fresh module's fit from the same weights over the same batches,
    returning the module) run with device prefetch on and off under
    ``cudnn.deterministic``, and the weights (and BatchNorm statistics)
    after the first within ``limits`` (kind -> rtol in norm) of the
    second's. cuDNN's default algorithms sum in another order run to run,
    and at the training rate a few steps make that order's last bits
    grow (``--fit-spread``)."""
    if on["apart"] or off["apart"]:
        fail(f"{tag}: {on['apart']} (prefetch on) and {off['apart']} (off) "
             f"values of the fits' batches differ from their sources")
    torch.backends.cudnn.deterministic = True
    try:
        states = [module_state(fit(prefetch)) for prefetch in (True, False)]
    finally:
        torch.backends.cudnn.deterministic = False
    lines, same = [], True
    for kind, rtol in limits.items():
        got, want = states[0][kind], states[1][kind]
        same = same and all(np.array_equal(got[n], w)
                            for n, w in want.items())
        rel, worst, worst_rel = parity_diff(got, want)
        lines.append(f"{kind} {rel:.3g} (limit {rtol}; worst tensor {worst} "
                     f"{worst_rel:.3g})")
        if not rel <= rtol:
            fail(f"{tag}: the weights after prefetched and unprefetched fits "
                 f"differ: {lines[-1]}")
    print(f"[{tag}] prefetch on and off: every batch of both timed fits bit "
          f"for bit its source ({2 * steps} batches); under "
          f"cudnn.deterministic, after {steps} steps |on - off| / |off| in "
          f"norm: {'; '.join(lines)}; bit for bit: {same}", flush=True)


def run_script(args, cpu=False, timeout=900):
    """Run a repository script through the port's launcher in a subprocess
    from the root of the checkout, numpy seeded with ``SEED``. Returns the
    launcher's counts, the validation accuracy of each epoch, the
    Speedometer's samples/s readings, the seconds the run took and each
    epoch's training seconds (``fit``'s "Time cost")."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = ([sys.executable, "-m", "mxnet_tpu_torch.launch"]
           + (["--cpu"] if cpu else []) + ["--seed", str(SEED)] + args)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{' '.join(args)} exited with {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    counts = [json.loads(line)["launch"] for line in proc.stdout.splitlines()
              if line.startswith('{"launch"')]
    if len(counts) != 1:
        fail(f"{' '.join(args)} printed no launch counts:\n"
             f"{proc.stdout[-2000:]}")
    acc = [float(v) for v in
           re.findall(r"Validation-accuracy=([0-9.]+)", proc.stderr)]
    speeds = [float(v) for v in
              re.findall(r"Speed: ([0-9.]+) samples/sec", proc.stderr)]
    costs = [float(v) for v in
             re.findall(r"Time cost=([0-9.]+)", proc.stderr)]
    return counts[0], acc, speeds, secs, costs


def mnist_command(net):
    return ["examples/train_mnist.py", "--synthetic", "1", "--network", net,
            "--num-epochs", str(MNIST_EPOCHS)]


def epoch_rates(steps, costs):
    """Samples/s of each training epoch of a script: its steps (evenly
    over the epochs) times ``MNIST_BATCH`` over the epoch's Time cost."""
    per_epoch = steps // max(1, len(costs)) * MNIST_BATCH
    return [round(per_epoch / c, 1) for c in costs if c > 0]


def cpu_baseline():
    """Phase 19's MNIST commands on the port's CPU path: each epoch's
    validation accuracy (the readings ``MNIST_CPU_ACC`` was fixed from)."""
    for net in MNIST_CPU_ACC:
        counts, acc, _speeds, secs, _costs = run_script(mnist_command(net),
                                                        cpu=True)
        print(json.dumps({"cpu_baseline": net, "validation_accuracy": acc,
                          "fit_batches": counts["fit_batches"],
                          "score_batches": counts["score_batches"],
                          "seconds": round(secs, 1)}), flush=True)


def phase_mnist_kernels(torch, mx):
    """The three kernels of the MNIST scripts at the shapes their path
    gives them (batch 64, 10 classes; SGD lr 0.05, momentum 0.9, wd 1e-4
    on weights, rescale 1/64 over the MLP's 6 and LeNet's 8 parameters)
    against their plain versions, each timed beside its plain version, its
    bound and the PyTorch call for the same function. Returns the readings
    as ``{kernel: {path: readings}}`` and each kernel's largest error."""
    from mxnet_tpu_torch.kernels import (
        sgd_mom_multi as sg, softmax_output_bwd as so, softmax_rows as sm)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    batch, classes = 64, 10
    x = 3 * torch.randn(batch, classes, generator=gen, device=dev)
    sm_err, _rel = sm_check(torch, "softmax_rows (64, 10)",
                            sm.softmax_rows(x), sm.softmax_rows_plain(x))
    sm_bound, sm_by = bound(2 * x.numel() * 4, 7 * x.numel())
    out = {"softmax_rows": {"mnist": {
        "shape": [batch, classes], "max_abs_err": sm_err,
        "ms": cuda_ms(torch, lambda: sm.softmax_rows(x), reps=100),
        "plain_ms": cuda_ms(torch, lambda: sm.softmax_rows_plain(x),
                            reps=100),
        "library_ms": cuda_ms(torch, lambda: torch.softmax(x, -1), reps=100),
        "bound_ms": sm_bound, "bound_by": sm_by}}}
    prob = torch.softmax(x, -1)
    label = torch.randint(0, classes, (batch,), generator=gen,
                          device=dev).float()
    so_err = check(torch, "softmax_output_bwd (64, 10)",
                   so.softmax_output_bwd(prob, label),
                   so.softmax_output_bwd_plain(prob, label, 1.0, -1.0, False,
                                               "null", False),
                   0.0, EXACT_ATOL)
    so_bound, so_by = bound(2 * prob.numel() * 4 + batch * 4,
                            2 * prob.numel())
    out["softmax_output_bwd"] = {"mnist": {
        "shape": [batch, classes], "max_abs_err": so_err,
        "ms": cuda_ms(torch, lambda: so.softmax_output_bwd(prob, label),
                      reps=100),
        "plain_ms": cuda_ms(torch, lambda: so.softmax_output_bwd_plain(
            prob, label, 1.0, -1.0, False, "null", False), reps=100),
        "library_ms": None, "bound_ms": so_bound, "bound_by": so_by}}
    out["sgd_mom_multi"] = {}
    for net, shape in (("mlp", (batch, 784)), ("lenet", (batch, 1, 28, 28))):
        sym = getattr(mx.models, net)(num_classes=classes)
        arg_shapes, _, _ = sym.infer_shape(data=shape)
        shapes = [sh for n, sh in zip(sym.list_arguments(), arg_shapes)
                  if n not in ("data", "softmax_label")]
        ws, gs, ms, _lrs, wds = sgd_inputs(torch, gen, dev, shapes)
        lrs = [0.05] * len(shapes)
        w2, m2 = [t.clone() for t in ws], [t.clone() for t in ms]
        sg.sgd_mom_multi(ws, gs, ms, lrs, wds, 0.9, 1 / batch, -1.0)
        sg.sgd_mom_multi_plain(w2, gs, m2, lrs, wds, 0.9, 1 / batch, -1.0)
        err = max(check(torch, f"sgd_mom_multi ({net})", got, want, 0.0,
                        EXACT_ATOL) for got, want in zip(ws + ms, w2 + m2))
        tparams = [torch.nn.Parameter(w) for w in ws]
        for p_, g in zip(tparams, gs):
            p_.grad = g
        topt = torch.optim.SGD(tparams, lr=0.05, momentum=0.9,
                               weight_decay=1e-4, fused=True)
        numel = sum(math.prod(sh) for sh in shapes)
        sg_bound, sg_by = bound(20 * numel, 6 * numel)
        cache = {}
        out["sgd_mom_multi"][f"mnist_{net}"] = {
            "tensors": len(shapes), "values": numel, "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: sg.sgd_mom_multi(
                ws, gs, ms, lrs, wds, 0.9, 1 / batch, -1.0, cache=cache),
                reps=100),
            "plain_ms": cuda_ms(torch, lambda: sg.sgd_mom_multi_plain(
                ws, gs, ms, lrs, wds, 0.9, 1 / batch, -1.0), reps=20),
            "library_ms": cuda_ms(torch, topt.step, reps=100),
            "bound_ms": sg_bound, "bound_by": sg_by}
    for name, paths in out.items():
        for path, r in paths.items():
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            print(f"[mnist-kernels] {name} at MNIST's {path} call matches its "
                  f"plain version (max abs err {r['max_abs_err']:g}): kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{lib}, bound {r['bound_ms'] * 1e3:.4f} us "
                  f"({r['bound_by']})", flush=True)
    return out


def phase_baseline_scripts(torch, mx, card):
    """The BASELINE training scripts on the card, each in a subprocess
    through ``mxnet_tpu_torch.launch``: MNIST's MLP and LeNet and the
    ResNet-50 ``--benchmark 1`` command. Returns the launches of all
    three runs by kernel."""
    total = {}
    for net in MNIST_CPU_ACC:
        counts, acc, speeds, secs, costs = run_script(mnist_command(net))
        steps, vals = counts["fit_batches"], counts["score_batches"]
        got = {k: v for k, v in counts["launches"].items() if v}
        want = {"softmax_rows": steps + vals, "softmax_output_bwd": steps,
                "sgd_mom_multi": steps}
        if counts["jax"] or not steps or not vals or got != want:
            fail(f"{net}: launches {got} over {steps} steps and {vals} "
                 f"validation batches; expected {want}, jax "
                 f"{counts['jax']}")
        floor = MNIST_CPU_ACC[net] - MNIST_ACC_MARGIN
        if len(acc) != MNIST_EPOCHS or not acc[-1] >= floor:
            fail(f"{net}: validation accuracy by epoch {acc}; the CPU path "
                 f"reaches {MNIST_CPU_ACC[net]}, the limit is {floor}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        print(f"[baseline] examples/train_mnist.py --synthetic 1 --network "
              f"{net} --num-epochs {MNIST_EPOCHS} (kv-store local, batch 64) "
              f"on {card} in {secs:.1f} s: validation accuracy by epoch "
              f"{acc} (the CPU path's {MNIST_CPU_ACC[net]}, margin "
              f"{MNIST_ACC_MARGIN}); Speedometer samples/s {speeds}; "
              f"samples/s by epoch {epoch_rates(steps, costs)} (its steps "
              f"over fit's Time cost); launches {got} over {steps} steps "
              f"and {vals} validation batches", flush=True)
    counts, _acc, speeds, secs, _costs = run_script(BASELINE_RESNET)
    batch = int(BASELINE_RESNET[BASELINE_RESNET.index("--batch-size") + 1])
    per_step = resnet_train_launches(mx)
    got = {k: v for k, v in counts["launches"].items() if v}
    want = {k: v * BASELINE_STEPS for k, v in per_step.items()}
    if (counts["jax"] or counts["fit_batches"] != BASELINE_STEPS
            or got != want or not speeds):
        fail(f"train_imagenet.py: launches {got} over "
             f"{counts['fit_batches']} steps, Speedometer {speeds}; "
             f"expected {BASELINE_STEPS} steps of {per_step}, jax "
             f"{counts['jax']}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    print(f"[baseline] {' '.join(BASELINE_RESNET)} on {card} in {secs:.1f} "
          f"s (start-up included): {counts['fit_batches']} steps, launches "
          f"per step {per_step}; Speedometer samples/s {speeds} (the last: "
          f"{batch * 1e3 / speeds[-1]:.2f} ms a step); float32, as the "
          f"canonical --dtype bfloat16 needs the Cast op (ROADMAP.md queue "
          f"1 item 4b)", flush=True)
    return total


def fit_spread(torch, mx, steps=(12, 2, 1)):
    """Full ResNet-50 ``Module.fit`` at ``TRAIN_BATCH`` from the same
    weights over the same batches with cuDNN's default algorithms: for
    each count of ``steps``, a fit with device prefetch on and two with it
    off, and the relative differences in norm (``parity_diff``) of the
    parameters and BatchNorm statistics, on - off and off - off (the
    readings ``prefetch_check``'s use of ``cudnn.deterministic`` rests
    on)."""
    sym, args, auxs = resnet50_numpy(mx, SEED)
    arg_nd = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()}
    aux_nd = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in auxs.items()}
    rng = np.random.default_rng(SEED + 3)
    n = max(steps) * TRAIN_BATCH
    x = rng.standard_normal((n, 3, 224, 224), np.float32)
    y = rng.integers(0, 1000, n).astype(np.float32)
    for k in steps:
        states = []
        for prefetch in (True, False, False):
            it = mx.io.NDArrayIter(x[:k * TRAIN_BATCH], y[:k * TRAIN_BATCH],
                                   batch_size=TRAIN_BATCH)
            mod = mx.mod.Module(sym)
            with device_prefetch(prefetch):
                mod.fit(it, num_epoch=1, optimizer="sgd",
                        optimizer_params=TRAIN_OPT, arg_params=arg_nd,
                        aux_params=aux_nd)
            states.append(module_state(mod))
            del mod
        for what, a, b in (("on - off", 0, 1), ("off - off", 2, 1)):
            diffs = {kind: parity_diff(states[a][kind], states[b][kind])
                     for kind in ("param", "aux")}
            print(json.dumps({"fit_spread": {"steps": k, "pair": what,
                                             **diffs}}), flush=True)


def phase_training(torch, mx, card):
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.kernels import (
        bn_act, bn_act_bwd, bn_stats, sgd_mom_multi, softmax_output_bwd,
        softmax_rows)

    t0 = time.perf_counter()
    sym, args, auxs = resnet50_numpy(mx, SEED)
    cpu = mx.cpu()
    arg_nd = {k: mx.nd.array(v, ctx=cpu) for k, v in args.items()}
    aux_nd = {k: mx.nd.array(v, ctx=cpu) for k, v in auxs.items()}
    rng = np.random.default_rng(SEED + 3)
    steps = FIT_STEPS
    x = rng.standard_normal((steps * TRAIN_BATCH, 3, 224, 224), np.float32)
    y = rng.integers(0, 1000, steps * TRAIN_BATCH).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)  # on gpu(0)
    mod = mx.mod.Module(sym)  # on the current context, gpu(0)
    kernels = {"bn_stats": bn_stats, "bn_act": bn_act,
               "bn_act_bwd": bn_act_bwd, "softmax_rows": softmax_rows,
               "softmax_output_bwd": softmax_output_bwd,
               "sgd_mom_multi": sgd_mom_multi}
    per_step = resnet_train_launches(mx)

    # fit's own steps after the first, as a user pays for them: the copy
    # of each batch to the card, the step, the metric. The card is drained
    # at the end of the first step and of the last.
    sources = batch_sources(torch, x, y, TRAIN_BATCH)
    timer, read_on = fit_timer(torch, steps, sources)

    # the main path (device prefetch on, the default): every count at 0
    # just before, read just after
    tm.reset()
    mod.fit(it, num_epoch=1, eval_metric=["acc", "ce"], optimizer="sgd",
            optimizer_params=TRAIN_OPT, arg_params=arg_nd, aux_params=aux_nd,
            batch_end_callback=timer)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES.value for k, m in kernels.items()}
    batches = tm.counter("fit.batches").value
    builds = sgd_mom_multi.PACK_BUILDS.value
    if batches != steps or launches != {k: v * steps
                                        for k, v in per_step.items()}:
        fail(f"training launch counters {launches} over {batches} steps; "
             f"expected per step {per_step}")
    if mod._exec_group._exec.arg_dict["conv0_weight"].context != mx.gpu(0):
        fail("Module.fit did not train on gpu(0)")
    if builds != 1:
        fail(f"the update kernel's launch parameters were validated and "
             f"packed {builds} times over {steps} steps; its weights and "
             f"momenta never move")
    print(f"[training] ResNet-50 Module.fit on {mx.current_context()}: "
          f"{batches} steps at batch {TRAIN_BATCH} in "
          f"{time.perf_counter() - t0:.1f} s (set-up, cuDNN's choices and "
          f"first launches included); launches {launches} = per step "
          f"{per_step}; the update's launch parameters packed {builds} "
          f"time(s), no metadata copied to the device", flush=True)
    on = read_on()

    def fit(prefetch, callback=None):
        with device_prefetch(prefetch):
            m = mx.mod.Module(sym)
            it.reset()
            m.fit(it, num_epoch=1, eval_metric=["acc", "ce"],
                  optimizer="sgd", optimizer_params=TRAIN_OPT,
                  arg_params=arg_nd, aux_params=aux_nd,
                  batch_end_callback=callback)
        return m

    timer, read_off = fit_timer(torch, steps, sources)
    fit(False, timer)
    off = read_off()
    del sources
    split = prefetch_report("training", card, TRAIN_BATCH, x[0].nbytes
                            * TRAIN_BATCH, on, off,
                            copy_ms(torch, x[:TRAIN_BATCH]))
    prefetch_check(torch, "training", steps, on, off, fit,
                   {k: PARITY_TOL[k][1] for k in ("param", "aux")})

    # 10 steps on one fixed batch lower the cross-entropy
    mod2 = mx.mod.Module(sym)
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_params(arg_params=arg_nd, aux_params=aux_nd)
    mod2.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
    it.reset()
    batch = next(iter(it))
    label = batch.label[0]._data

    def step():
        mod2.forward_backward(batch)
        mod2.update()

    losses = []
    for _ in range(10):
        step()
        losses.append(cross_entropy(torch, mod2.get_outputs()[0]._data,
                                    label))
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses) or \
            losses[-1] > LOSS_RATIO * losses[0]:
        fail(f"training cross-entropy over 10 steps on one batch: {losses}; "
             f"expected the last <= {LOSS_RATIO} x the first")
    print(f"[training] cross-entropy over 10 steps on one batch of "
          f"{TRAIN_BATCH}: {' '.join(f'{v:.3f}' for v in losses)} (last/first "
          f"{losses[-1] / losses[0]:.3f}, limit {LOSS_RATIO})", flush=True)

    # the compute step alone (one batch already on the card, no input
    # pipeline, no metric): CUDA events around 10 steps after the warm-up
    torch.cuda.reset_peak_memory_stats()
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - w0) / reps * 1e3
    step_ms = start.elapsed_time(end) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[training] ResNet-50 compute step (forward_backward + update on "
          f"a batch on the card) at batch {TRAIN_BATCH} on {card}: "
          f"{step_ms:.2f} ms per step by CUDA events ({1e3 / step_ms:.2f} "
          f"steps/s, {TRAIN_BATCH * 1e3 / step_ms:.1f} images/s); host wall "
          f"{wall_ms:.2f} ms per step; peak device memory {peak:.2f} GiB; "
          f"fit per step minus the compute step: prefetch on "
          f"{split['on']['fit_ms'] - step_ms:.2f} ms, off "
          f"{split['off']['fit_ms'] - step_ms:.2f} ms", flush=True)
    device_ms = profile_step(torch, step)
    if device_ms.get("bn_act_bwd"):
        n_el = sum(math.prod(s) for s in resnet50_shapes(mx, TRAIN_BATCH)[1])
        bw = device_ms["bn_act_bwd"]
        b_ms, _by = bound(n_el * 16, 13 * n_el)
        print(f"[training] bn_act_bwd in the step: {bw:.4f} ms of device "
              f"time for {n_el / 1e6:.1f} M elements, "
              f"{n_el * 16 / bw / 1e9:.2f} TB/s at 16 bytes per element "
              f"({100 * b_ms / bw:.0f}% of the {b_ms:.4f} ms bound)",
              flush=True)
    return launches, device_ms


def parity_side(mx, sym, args, auxs, ctx, data_shape):
    """``(executor, optimizer, momenta)`` on ``ctx``: ``sym`` bound for
    training at ``data_shape`` with the numpy ``args`` and ``auxs``, SGD with
    momentum 0.9 at ``PARITY_LR`` and wd 1e-4, and zero momenta."""
    names = sorted(args)
    exe = sym.simple_bind(ctx, grad_req="write", data=data_shape,
                          softmax_label=data_shape[:1])
    exe.copy_params_from({k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in args.items()},
                         {k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in auxs.items()})
    opt = mx.optimizer.SGD(momentum=0.9, rescale_grad=1 / data_shape[0],
                           learning_rate=PARITY_LR, wd=1e-4,
                           param_idx2name=dict(enumerate(names)))
    states = [opt.create_state(i, exe.arg_dict[n])
              for i, n in enumerate(names)]
    return exe, opt, states


def parity_step(torch, side, x, y, t):
    """One fused training step (update count ``t``) of ``side`` on the batch
    ``x``, ``y``; after it, each kind of ``PARITY_TOL`` as numpy arrays by
    tensor name."""
    exe, opt, states = side
    names = sorted(n for n in exe.arg_dict if n not in ("data",
                                                        "softmax_label"))
    exe.forward(is_train=True, data=x, softmax_label=y)
    exe.backward()
    exe.fused_train_update(names, opt.torch_apply, states,
                           [opt._get_lr(i) for i in range(len(names))],
                           [opt._get_wd(i) for i in range(len(names))],
                           [t] * len(names))
    out = exe.outputs[0]._data
    loss = cross_entropy(torch, out, torch.from_numpy(y).to(out.device))
    momentum = {n: st.asnumpy() for n, st in zip(names, states)}
    return {"loss": {"loss": np.array([float(loss)])},
            "param": {n: exe.arg_dict[n].asnumpy() for n in names},
            "momentum": momentum,
            "bn_momentum": {n: m for n, m in momentum.items()
                            if n.endswith(("_gamma", "_beta"))},
            "aux": {n: a.asnumpy() for n, a in exe.aux_dict.items()}}


def parity_diff(got, want):
    """``(|got - want| / |want|`` in norm over all tensors of one kind, the
    tensor with the largest difference of its own, that difference)``;
    the first is inf where ``got`` holds a non-finite value."""
    diff = math.sqrt(sum(float(np.sum((got[n] - w) ** 2))
                         for n, w in want.items()))
    norm = math.sqrt(sum(float(np.sum(w ** 2)) for w in want.values()))
    rel = diff / norm if all(np.isfinite(got[n]).all()
                             for n in want) else math.inf
    own = {n: float(np.linalg.norm(got[n] - w)
                    / max(np.linalg.norm(w), 1e-30)) for n, w in want.items()}
    worst = max(own, key=own.get)
    return rel, worst, own[worst]


def phase_train_parity(torch, mx):
    """Two fused steps of full ResNet-50 at batch 8 on the card and on the
    port's CPU path (plain versions). Each step starts both sides from the
    same state — the second from the card's state after the first, copied
    to the CPU — and every quantity is compared after it: free-running
    sides would drift apart (the gradient difference below moves the
    weights, and a ResNet's gradient at initialization is sensitive to
    that)."""
    sym, args, auxs = resnet50_numpy(mx, SEED + 4)
    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((2, PARITY_BATCH, 3, 224, 224), np.float32)
    y = rng.integers(0, 1000, (2, PARITY_BATCH)).astype(np.float32)
    t0 = time.perf_counter()
    sides = {where: parity_side(mx, sym, args, auxs, ctx, x.shape[1:])
             for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu()))}
    results = {"card": [], "cpu": []}
    for s in range(2):
        if s:  # the CPU side takes over the card's state
            card, cpu = sides["card"], sides["cpu"]
            for n in args:
                card[0].arg_dict[n].copyto(cpu[0].arg_dict[n])
            for n in auxs:
                card[0].aux_dict[n].copyto(cpu[0].aux_dict[n])
            for a, b in zip(card[2], cpu[2]):
                a.copyto(b)
        for where in ("card", "cpu"):
            results[where].append(parity_step(torch, sides[where], x[s], y[s],
                                              s + 1))
    lines, bad = [], []
    for s in range(2):
        for kind, rtols in PARITY_TOL.items():
            rtol = rtols[s]
            rel, worst, worst_rel = parity_diff(results["card"][s][kind],
                                                results["cpu"][s][kind])
            lines.append(f"step {s + 1} {kind}: |card - cpu| / |cpu| = "
                         f"{rel:.3g} (rtol {rtol}); worst tensor {worst} "
                         f"{worst_rel:.3g}")
            if not rel <= rtol:
                bad.append(f"step {s + 1} {kind} {rel:.3g} > {rtol}")
    print(f"[parity] two fused steps of ResNet-50 at batch {PARITY_BATCH}, "
          f"card against the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s): losses "
          f"{[float(st['loss']['loss'][0]) for st in results['card']]} vs "
          f"{[float(st['loss']['loss'][0]) for st in results['cpu']]}",
          flush=True)
    for line in lines:
        print(f"[parity]   {line}")
    if bad:
        fail(f"training parity: card and CPU differ beyond the tolerance in "
             f"{bad}")


def synthetic_corpus(vocab_size, n=2000, seed=0):
    """``examples/lstm_bucketing.py``'s synthetic corpus: ``n`` arithmetic
    word sequences of length 8, 16, 24 or 32."""
    rs = np.random.RandomState(seed)
    sents = []
    for _ in range(n):
        length = rs.choice([8, 16, 24, 32])
        start = rs.randint(1, vocab_size - 1)
        step = rs.choice([1, 2])
        sents.append([(start + step * i) % (vocab_size - 1) + 1
                      for i in range(length)])
    return sents


def lstm_param_shapes(mx, seq_len=8):
    """(symbol of the ``seq_len`` bucket, begin-state names, the 11
    parameter (name, shape) pairs) of the LSTM-PTB model."""
    sym_gen, states = mx.models.lstm_lm_sym_gen(**LSTM)
    sym = sym_gen(seq_len)[0]
    shapes = {"data": (LSTM_BATCH, seq_len),
              "softmax_label": (LSTM_BATCH, seq_len)}
    shapes.update({n: (LSTM_BATCH, LSTM["num_hidden"]) for n in states})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = [(n, s) for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes]
    return sym, states, params


def phase_lstm_kernels(torch, mx):
    from mxnet_tpu_torch.kernels import (
        adam_multi as am, lstm_cell as lc, sgd_mom_multi as sg,
        softmax_output_bwd as so, softmax_rows as sr)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def close(what, got, want):
        return check(torch, what, got, want, LSTM_RTOL, LSTM_ATOL)

    # --- lstm_cell / lstm_cell_bwd at the path's (32, 4 x 200)
    n, h = LSTM_BATCH, LSTM["num_hidden"]
    i2h, h2h = 2 * randn(n, 4 * h), 2 * randn(n, 4 * h)
    c, dh, dc = randn(n, h), randn(n, h), randn(n, h)
    fwd_err = bwd_err = 0.0
    for fb in (1.0, 0.0):
        got = lc.lstm_cell(i2h, h2h, c, fb)
        want = lc.lstm_cell_plain(i2h, h2h, c, fb)
        for name, g, w in zip(("next_h", "next_c", "gates"), got, want):
            fwd_err = max(fwd_err, close(f"lstm_cell fb={fb} {name}", g, w))
        for dnext_c in (dc, None):
            got_b = lc.lstm_cell_bwd(dh, dnext_c, want[2], c, want[1])
            want_b = lc.lstm_cell_bwd_plain(dh, dnext_c, want[2], c, want[1])
            for name, g, w in zip(("dgates", "dc_prev"), got_b, want_b):
                bwd_err = max(bwd_err, close(
                    f"lstm_cell_bwd fb={fb} dnext_c="
                    f"{'None' if dnext_c is None else 'given'} {name}", g, w))
    # torch's fused cell computes the same function with the forget bias as
    # a bias vector: a yardstick, checked against the plain version
    fused_cell = torch.ops.aten._thnn_fused_lstm_cell
    fused_cell_bwd = torch.ops.aten._thnn_fused_lstm_cell_backward_impl
    bias, zero = torch.zeros(4 * h, device=dev), torch.zeros(4 * h,
                                                            device=dev)
    bias[h:2 * h] = 1.0
    hy, cy, ws = fused_cell(i2h, h2h, c, bias, zero)
    plain = lc.lstm_cell_plain(i2h, h2h, c, 1.0)
    lib_err = max(float((hy - plain[0]).abs().max()),
                  float((cy - plain[1]).abs().max()))
    fwd_ms = cuda_ms(torch, lambda: lc.lstm_cell(i2h, h2h, c, 1.0), reps=200)
    fwd_plain = cuda_ms(torch, lambda: lc.lstm_cell_plain(i2h, h2h, c, 1.0),
                        reps=100)
    fwd_lib = cuda_ms(torch, lambda: fused_cell(i2h, h2h, c, bias, zero),
                      reps=200)
    act, next_c = plain[2], plain[1]
    bwd_ms = cuda_ms(torch, lambda: lc.lstm_cell_bwd(dh, dc, act, c, next_c),
                     reps=200)
    bwd_plain = cuda_ms(torch, lambda: lc.lstm_cell_bwd_plain(
        dh, dc, act, c, next_c), reps=100)
    bwd_lib = cuda_ms(torch, lambda: fused_cell_bwd(dh, dc, c, cy, ws, True),
                      reps=200)
    # per (n, j): gate sums, bias, 3 sigmoids, 2 tanh, the state update
    fwd_bound, fwd_by = bound(15 * n * h * 4, 25 * n * h)
    bwd_bound, bwd_by = bound(13 * n * h * 4, 30 * n * h)
    print(f"[lstm-kernels] lstm_cell and lstm_cell_bwd match their plain "
          f"versions at ({n}, 4x{h}) with forget bias 1 and 0, dnext_c given "
          f"and None: max abs err {fwd_err:g} / {bwd_err:g} (rtol "
          f"{LSTM_RTOL}, atol {LSTM_ATOL}); torch._thnn_fused_lstm_cell "
          f"computes the same cell to {lib_err:g}", flush=True)
    print(f"[lstm-kernels] per launch: lstm_cell {fwd_ms:.4f} ms, plain "
          f"{fwd_plain:.4f} ms, torch._thnn_fused_lstm_cell {fwd_lib:.4f} ms, "
          f"bound {fwd_bound * 1e3:.3f} us ({fwd_by}); lstm_cell_bwd "
          f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
          f"_thnn_fused_lstm_cell_backward_impl {bwd_lib:.4f} ms, bound "
          f"{bwd_bound * 1e3:.3f} us ({bwd_by})", flush=True)

    # --- adam_multi over the model's 11 tensors (4.65 M values)
    _sym, _states, params = lstm_param_shapes(mx)
    numel = sum(math.prod(s) for _n, s in params)

    def adam_set():
        return ([0.05 * randn(*s) for _n, s in params],
                [randn(*s) for _n, s in params],
                [0.01 * randn(*s) for _n, s in params],
                [1e-3 * torch.rand(s, generator=gen, device=dev)
                 for _n, s in params])

    opt = mx.optimizer.Adam(**LSTM_OPT)
    wds0 = [1.0 if n.endswith("_weight") else 0.0 for n, _s in params]
    ad_err = 0.0
    for wd, clip in ((0.0, -1.0), (1e-4, 0.05), (1e-2, -1.0)):
        ws_, gs, ms, vs = adam_set()
        ref = [[t.clone() for t in x] for x in (ws_, ms, vs)]
        wds = [wd * k for k in wds0]
        for t in (1, 2):
            lrs = [opt.lr_t(0.01, t)] * len(params)
            am.adam_multi(ws_, gs, ms, vs, lrs, wds, 0.9, 0.999, 1e-8,
                          1 / LSTM_BATCH, clip)
            am.adam_multi_plain(ref[0], gs, ref[1], ref[2], lrs, wds, 0.9,
                                0.999, 1e-8, 1 / LSTM_BATCH, clip)
        for got, want in zip(ws_ + ms + vs, ref[0] + ref[1] + ref[2]):
            ad_err = max(ad_err, close(f"adam_multi wd={wd} clip={clip}",
                                       got, want))
    # the guard: a NaN gradient skips the step on the device
    ws_, gs, ms, vs = adam_set()
    guard = sg.Guard(torch.zeros(2, dtype=torch.int32, device=dev))
    before = [t.clone() for t in ws_ + ms + vs]
    lrs = [opt.lr_t(0.01, 1)] * len(params)
    gs[0].view(-1)[11] = float("nan")
    am.adam_multi(ws_, gs, ms, vs, lrs, [0.0] * len(params), 0.9, 0.999,
                  1e-8, 1 / LSTM_BATCH, -1.0, guard=guard)
    torch.cuda.synchronize()
    if guard.counters.tolist() != [1, 1] or any(
            not torch.equal(a, b) for a, b in zip(ws_ + ms + vs, before)):
        fail(f"adam_multi guard: counters {guard.counters.tolist()}, the "
             f"step was not skipped")
    gs[0].view(-1)[11] = 0.0
    am.adam_multi(ws_, gs, ms, vs, lrs, [0.0] * len(params), 0.9, 0.999,
                  1e-8, 1 / LSTM_BATCH, -1.0, guard=guard)
    if guard.counters.tolist() != [1, 0] or torch.equal(ws_[0], before[0]):
        fail(f"adam_multi guard after a finite step: counters "
             f"{guard.counters.tolist()}")
    cache = {}
    builds = am.TABLE_BUILDS.value
    wds = [1e-4 * k for k in wds0]
    ad_ms = cuda_ms(torch, lambda: am.adam_multi(
        ws_, gs, ms, vs, lrs, wds, 0.9, 0.999, 1e-8, 1 / LSTM_BATCH, -1.0,
        cache=cache), reps=50)
    if am.TABLE_BUILDS.value != builds + 1:
        fail(f"adam_multi rebuilt its table {am.TABLE_BUILDS.value - builds} "
             f"times for unmoved tensors")
    ad_plain = cuda_ms(torch, lambda: am.adam_multi_plain(
        ws_, gs, ms, vs, lrs, wds, 0.9, 0.999, 1e-8, 1 / LSTM_BATCH, -1.0),
        reps=5)
    tparams = [torch.nn.Parameter(w) for w in ws_]
    for p_, g in zip(tparams, gs):
        p_.grad = g
    topt = torch.optim.Adam(tparams, lr=0.01, fused=True)
    ad_lib = cuda_ms(torch, topt.step, reps=50)
    ad_bound, ad_by = bound(28 * numel, 15 * numel)
    print(f"[lstm-kernels] adam_multi matches its plain version over "
          f"{len(params)} tensors ({numel / 1e6:.2f} M values) x wd/clip, two "
          f"steps each: max abs err {ad_err:g} (rtol {LSTM_RTOL}, atol "
          f"{LSTM_ATOL}); a NaN gradient under the guard skips the step, "
          f"counters [1, 1] then [1, 0]; per step: kernel {ad_ms:.4f} ms (1 "
          f"launch, table built once), plain {ad_plain:.4f} ms, "
          f"torch.optim.Adam(fused=True).step {ad_lib:.4f} ms (other "
          f"semantics, a yardstick), bound {ad_bound:.4f} ms ({ad_by})",
          flush=True)

    # --- the head's softmax kernels at (32 x 32, 10000)
    rows, vocab = LSTM_BATCH * max(LSTM_BUCKETS), LSTM["vocab_size"]
    x = 4.0 * randn(rows, vocab)
    sm_err, sm_rel = sm_check(torch, "softmax_rows (1024, 10000)",
                              sr.softmax_rows(x), sr.softmax_rows_plain(x))
    sm_ms = cuda_ms(torch, lambda: sr.softmax_rows(x), reps=50)
    sm_plain = cuda_ms(torch, lambda: sr.softmax_rows_plain(x), reps=50)
    sm_lib = cuda_ms(torch, lambda: torch.softmax(x, dim=1), reps=50)
    sm_bound, sm_by = bound(2 * x.numel() * 4, 7 * x.numel())
    p = torch.softmax(x, dim=1)
    label = torch.randint(0, vocab, (rows,), generator=gen,
                          device=dev).float()
    so_err = check(torch, "softmax_output_bwd (1024, 10000)",
                   so.softmax_output_bwd(p, label),
                   so.softmax_output_bwd_plain(p, label, 1.0, -1.0, False,
                                               "null", False),
                   0.0, EXACT_ATOL)
    so_ms = cuda_ms(torch, lambda: so.softmax_output_bwd(p, label), reps=50)
    so_plain = cuda_ms(torch, lambda: so.softmax_output_bwd_plain(
        p, label, 1.0, -1.0, False, "null", False), reps=50)
    so_bound, so_by = bound(2 * p.numel() * 4 + rows * 4, 2 * p.numel())
    print(f"[lstm-kernels] at the head's ({rows}, {vocab}): softmax_rows "
          f"max abs err {sm_err:g} (atol {SM_ATOL}), max rel err {sm_rel:g} "
          f"(rtol {SM_RTOL}), kernel {sm_ms:.4f} ms, "
          f"plain {sm_plain:.4f} ms, torch.softmax {sm_lib:.4f} ms, bound "
          f"{sm_bound:.4f} ms ({sm_by}); softmax_output_bwd max abs err "
          f"{so_err:g} (atol {EXACT_ATOL}), kernel {so_ms:.4f} ms, plain "
          f"{so_plain:.4f} ms, no library call, bound {so_bound:.4f} ms "
          f"({so_by})", flush=True)
    new = [
        {"name": "lstm_cell", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
         "replaces": "mxnet_tpu/rnn/rnn_cell.py:245",
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": fwd_lib},
        {"name": "lstm_cell_bwd", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
         "replaces": "mxnet_tpu/rnn/rnn_cell.py:245",
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": bwd_lib},
        {"name": "adam_multi", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/adam_multi.cu",
         "replaces": "mxnet_tpu/ops/defs_optimizer.py:78",
         "max_abs_err": ad_err, "ms": ad_ms, "plain_ms": ad_plain,
         "bound_ms": ad_bound, "bound_by": ad_by, "library_ms": ad_lib},
    ]
    head = {"softmax_rows": {"lstm_max_abs_err": sm_err, "lstm_ms": sm_ms,
                             "lstm_plain_ms": sm_plain,
                             "lstm_library_ms": sm_lib,
                             "lstm_bound_ms": sm_bound},
            "softmax_output_bwd": {"lstm_max_abs_err": so_err,
                                   "lstm_ms": so_ms,
                                   "lstm_plain_ms": so_plain,
                                   "lstm_library_ms": None,
                                   "lstm_bound_ms": so_bound}}
    return new, head


def count_plain_calls(torch, modules):
    """Wrap every plain version the kernel wrappers of ``modules`` may call
    so that each call on data is counted (shape inference at bind runs the
    plain versions on ``meta`` tensors, which hold no data); returns the
    dict of counts."""
    calls = {}
    for mod in modules:
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.endswith("_plain") and callable(fn):
                def counted(*a, _fn=fn, _name=name, **k):
                    first = next((t for t in a if isinstance(t, torch.Tensor)
                                  or isinstance(t, list)), None)
                    if isinstance(first, list):
                        first = first[0] if first else None
                    if first is None or first.device.type != "meta":
                        calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*a, **k)
                setattr(mod, name, counted)
                calls[name] = 0
    return calls


def lstm_profile(torch, mod, batch, reps=3):
    """One bucket's step (``forward_backward`` + ``update`` on a batch
    already on the card) under torch.profiler: the device's busy share of
    the wall time, the top device operations, and the port's kernels'
    device time per step. Measurement only; it fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        mod.forward_backward(batch)
        mod.update()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total / reps, round(ev.count / reps), ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total]
    busy = sum(r[0] for r in rows)
    ours = {}
    for us, count, key in rows:
        for kernel, mark in PORT_KERNELS.items():
            if mark in key:
                ms, n = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms + us / 1e3, n + count)
    launches = sum(r[1] for r in rows)
    return (busy / 1e3, wall_us / reps / 1e3, launches,
            sorted(rows, reverse=True)[:6], ours)


def launch_counters():
    """Each port kernel's launch counter, by kernel name."""
    from mxnet_tpu_torch import kernels as K

    counters = {name: getattr(K, name).LAUNCHES for name in PORT_KERNELS
                if name not in BWD_COUNTERS}
    for name, (mod, attr) in {**BWD_COUNTERS, **LEAKY_COUNTERS}.items():
        counters[name] = getattr(getattr(K, mod), attr)
    return counters


def kernel_modules():
    """The kernel wrapper modules, one each."""
    from mxnet_tpu_torch import kernels as K

    return [getattr(K, n) for n in PORT_KERNELS if n not in BWD_COUNTERS]


def lstm_fit(mx, seed, **callbacks):
    """``BucketingModule.fit`` of the LSTM-PTB configuration on the current
    context, parameters initialized from ``seed``: ``LSTM_EPOCHS`` epochs of
    ``synthetic_corpus(10000, n=2000)``. Returns ``(iterator, module,
    Train-Perplexity of each epoch)``."""
    it = mx.rnn.BucketSentenceIter(
        synthetic_corpus(LSTM["vocab_size"], n=2000), LSTM_BATCH,
        buckets=list(LSTM_BUCKETS), invalid_label=0)
    sym_gen, states = mx.models.lstm_lm_sym_gen(**LSTM)
    mx.random.seed(seed)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 state_names=states)
    metric = mx.metric.Perplexity(0)
    epochs = []
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params=LSTM_OPT,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=LSTM_EPOCHS,
            epoch_end_callback=lambda *_a: epochs.append(metric.get()[1]),
            **callbacks)
    return it, mod, epochs


def cpu_perplexity(seeds):
    """The LSTM-PTB fit on the port's CPU path for each initialization
    seed, printing each epoch's Train-Perplexity: how ``PPL_LIMIT`` was
    fixed. Needs no card."""
    import mxnet_tpu_torch as mx

    for seed in seeds:
        t0 = time.perf_counter()
        with mx.cpu():
            _it, _mod, epochs = lstm_fit(mx, seed)
        print(f"[cpu-perplexity] seed {seed}: Train-Perplexity by epoch "
              f"{epochs} ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_lstm_training(torch, mx, card):
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch import kernels as K

    t0 = time.perf_counter()
    kernels = launch_counters()
    plain_calls = count_plain_calls(torch, kernel_modules())
    per_step = []  # (epoch, bucket, launches of the step, host s, event)
    last = {}

    def on_batch(param):
        now = {k: c.value for k, c in kernels.items()}
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step = {k: v - last.get(k, 0) for k, v in now.items()}
        last.update(now)
        per_step.append((param.epoch, param.locals["data_batch"].bucket_key,
                         step, time.perf_counter(), ev))

    # the main path (on gpu(0)): every count at 0 just before, read just
    # after
    tm.reset()
    it, mod, epochs = lstm_fit(mx, SEED, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in kernels.items()}
    builds = K.adam_multi.TABLE_BUILDS.value
    batches = tm.counter("fit.batches").value
    fit_s = time.perf_counter() - t0

    def want(seq_len):
        w = {k: 0 for k in kernels}
        w.update(lstm_cell=2 * seq_len, lstm_cell_bwd=2 * seq_len,
                 adam_multi=1, softmax_rows=1, softmax_output_bwd=1)
        return w

    visited = sorted({b for _e, b, _s, _t, _ev in per_step})
    if visited != sorted(LSTM_BUCKETS):
        fail(f"LSTM fit visited buckets {visited}, expected {LSTM_BUCKETS}")
    bad = [(e, b, s) for e, b, s, _t, _ev in per_step if s != want(b)]
    if bad or batches != len(per_step):
        fail(f"LSTM launches per step: {len(bad)} of {len(per_step)} steps "
             f"off, first {bad[:1]}; expected per step {want(8)} at T=8")
    if any(plain_calls.values()):
        fail(f"plain versions ran on the card's main path: {plain_calls}")
    execs = [m._exec_group._exec for m in mod._buckets.values()]
    keys = {e._update_cache.get("key") for e in execs}
    if builds != len(LSTM_BUCKETS) or len(keys) != 1 or None in keys:
        fail(f"Adam tables: {builds} built for {len(execs)} bucket "
             f"executors, {len(keys)} distinct pointer sets; expected one "
             f"build per executor, all over the same storage")
    weight = execs[0].arg_dict["pred_weight"]
    if weight.context != mx.gpu(0):
        fail("BucketingModule.fit did not train on gpu(0)")
    if not (epochs[-1] < PPL_LIMIT and epochs[-1] < epochs[0]):
        fail(f"Train-Perplexity by epoch {epochs}; expected the last below "
             f"{PPL_LIMIT} and below the first")
    print(f"[lstm] BucketingModule.fit on {mx.current_context()}: "
          f"{LSTM_EPOCHS} epochs, {batches} steps over buckets {visited} in "
          f"{fit_s:.1f} s (binding, cuBLAS's choices and first launches "
          f"included); launches exactly 2T lstm_cell, 2T lstm_cell_bwd, 1 "
          f"adam_multi, 1 softmax_rows, 1 softmax_output_bwd per step of "
          f"bucket T, totals {launches}; no plain version ran; Adam tables "
          f"built {builds} times (once per bucket executor, one pointer set); "
          f"Train-Perplexity by epoch {[round(v, 1) for v in epochs]} (limit "
          f"{PPL_LIMIT})", flush=True)

    # ms per step of the last epoch by bucket: between consecutive
    # batch-end callbacks (its first step follows the epoch-end work)
    timed = [r for r in per_step if r[0] == LSTM_EPOCHS - 1]
    by_bucket = {}
    for prev, cur in zip(timed, timed[1:]):
        host = (cur[3] - prev[3]) * 1e3
        dev = prev[4].elapsed_time(cur[4])
        by_bucket.setdefault(cur[1], []).append((host, dev))
    stats = {}
    for b in sorted(by_bucket):
        host = float(np.mean([v[0] for v in by_bucket[b]]))
        dev = float(np.mean([v[1] for v in by_bucket[b]]))
        stats[b] = (host, dev)
        print(f"[lstm] bucket {b} on {card}: {host:.2f} ms per step by the "
              f"host's clock, {dev:.2f} ms by CUDA events "
              f"({LSTM_BATCH * b * 1e3 / host:.0f} tokens/s) over "
              f"{len(by_bucket[b])} steps of fit's last epoch", flush=True)

    # the device's busy share and top operations per bucket
    batches_by_key = {}
    it.reset()
    for batch in it:
        batches_by_key.setdefault(batch.bucket_key, batch)
    device_ms = {}
    for b in sorted(batches_by_key):
        busy, wall, n_kern, top, ours = lstm_profile(torch, mod,
                                                     batches_by_key[b])
        print(f"[lstm-profile] bucket {b}: device busy {busy:.2f} ms of "
              f"{wall:.2f} ms wall ({100 * busy / wall:.0f}%), {n_kern} "
              f"kernel launches per step; top device operations:")
        for us, count, key in top:
            print(f"[lstm-profile]   {us / 1e3:8.3f} ms x{count:<4d} "
                  f"{key[:90]}")
        print("[lstm-profile]   port kernels per step: " + ", ".join(
            f"{k} {ms:.4f} ms in {cnt}" for k, (ms, cnt) in sorted(
                ours.items())), flush=True)
        if b == max(LSTM_BUCKETS):
            device_ms = {k: v[0] for k, v in ours.items()}
    return launches, device_ms


def lstm_numpy(mx, seed):
    """The T=8 bucket's symbol, begin-state names and parameters as numpy:
    Xavier(factor_type="in", magnitude=2.34) uniform weights, zero
    biases."""
    sym, states, params = lstm_param_shapes(mx)
    rng = np.random.default_rng(seed)
    args = {}
    for name, shape in params:
        if name.endswith("_weight"):
            scale = math.sqrt(2.34 / shape[1])
            args[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
        else:
            args[name] = np.zeros(shape, np.float32)
    return sym, states, args


def lstm_parity_side(mx, sym, states, args, ctx, dtype=np.float32):
    """A Module over the T=8 bucket on ``ctx`` with the numpy ``args``
    (cast to ``dtype``) and Adam."""
    mod = mx.mod.Module(sym, state_names=states, context=ctx)
    shape = (LSTM_BATCH, 8)
    mod.bind(data_shapes=[mx.io.DataDesc("data", shape, dtype)],
             label_shapes=[mx.io.DataDesc("softmax_label", shape, dtype)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu(), dtype=dtype)
                                for k, v in args.items()})
    mod.init_optimizer(optimizer="adam", optimizer_params=LSTM_OPT)
    return mod


def lstm_parity_step(torch, mx, mod, x, y, dtype=np.float32):
    """One training step of ``mod`` on ``x``, ``y``; after it, each kind of
    ``LSTM_PARITY_TOL`` as float64 numpy arrays by tensor name."""
    ctx = mod._context[0]
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx, dtype=dtype)],
                            [mx.nd.array(y, ctx=ctx, dtype=dtype)])
    mod.forward_backward(batch)
    mod.update()
    out = mod.get_outputs()[0]._data
    loss = cross_entropy(torch, out, torch.from_numpy(
        y.reshape(-1)).to(out.device))
    names = mod._exec_group.param_names
    arg, _aux = mod.get_params()
    res = {"loss": {"loss": np.array([float(loss)])},
           "param": {n: arg[n].asnumpy().astype(np.float64) for n in names},
           "mean": {}, "var": {}}
    for i, (mean, var) in mod._updater.states.items():
        res["mean"][names[i]] = mean.asnumpy().astype(np.float64)
        res["var"][names[i]] = var.asnumpy().astype(np.float64)
    return res


def lstm_parity_batches(seed):
    """Two (data, label) batches of the T=8 bucket: words 1..vocab-1, the
    labels the next word."""
    rng = np.random.default_rng(seed)
    words = rng.integers(1, LSTM["vocab_size"], (2, LSTM_BATCH, 9))
    return [(w[:, :8].astype(np.float32), w[:, 1:].astype(np.float32))
            for w in words]


def lstm_parity_run(torch, mx, sides, batches, dtypes):
    """Two steps of ``sides`` (name -> Module, whose arrays hold
    ``dtypes[name]``); before the second, every side takes the first
    side's parameters and Adam states. Returns ``{name: [step
    results]}``."""
    names = list(sides)
    results = {n: [] for n in names}
    for s, (x, y) in enumerate(batches):
        if s:
            lead = sides[names[0]]
            arg, _aux = lead.get_params()
            for n in names[1:]:
                mod = sides[n]
                mod.set_params({k: mx.nd.array(v.asnumpy().astype(
                    dtypes[n]), ctx=mx.cpu(), dtype=dtypes[n])
                    for k, v in arg.items()}, {})
                for i, st in lead._updater.states.items():
                    for a, b in zip(st, mod._updater.states[i]):
                        b[:] = a.asnumpy().astype(dtypes[n])
        for n in names:
            results[n].append(lstm_parity_step(torch, mx, sides[n], x, y,
                                               dtypes[n]))
    return results


def phase_lstm_parity(torch, mx):
    """Two Adam steps of the LSTM-PTB model's T=8 bucket at full width on
    the card and on the port's CPU path (plain versions), each from the same
    state, compared in norm over each kind; beside them the same CPU path
    in float64, the yardstick of float32's own rounding."""
    sym, states, args = lstm_numpy(mx, SEED + 7)
    batches = lstm_parity_batches(SEED + 8)
    t0 = time.perf_counter()
    dtypes = {"card": np.float32, "cpu": np.float32, "cpu64": np.float64}
    sides = {"card": lstm_parity_side(mx, sym, states, args, mx.gpu(0)),
             "cpu": lstm_parity_side(mx, sym, states, args, mx.cpu()),
             "cpu64": lstm_parity_side(mx, sym, states, args, mx.cpu(),
                                       np.float64)}
    res = lstm_parity_run(torch, mx, sides, batches, dtypes)
    lines, bad = [], []
    for s in range(2):
        for kind, rtol in LSTM_PARITY_TOL.items():
            rel, worst, worst_rel = parity_diff(res["card"][s][kind],
                                                res["cpu"][s][kind])
            lines.append(f"step {s + 1} {kind}: |card - cpu| / |cpu| = "
                         f"{rel:.3g} (rtol {rtol}); worst tensor {worst} "
                         f"{worst_rel:.3g}")
            if not rel <= rtol:
                bad.append(f"step {s + 1} {kind} {rel:.3g} > {rtol}")
            # the yardstick: the same CPU path in float32 against float64
            rel64, worst64, worst64_rel = parity_diff(res["cpu"][s][kind],
                                                      res["cpu64"][s][kind])
            lines.append(f"step {s + 1} {kind}: |cpu - cpu float64| / "
                         f"|cpu float64| = {rel64:.3g}; worst tensor "
                         f"{worst64} {worst64_rel:.3g}")
    print(f"[lstm-parity] two Adam steps of the T=8 bucket at batch "
          f"{LSTM_BATCH}, card against the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s): losses "
          f"{[float(r['loss']['loss'][0]) for r in res['card']]} vs "
          f"{[float(r['loss']['loss'][0]) for r in res['cpu']]}", flush=True)
    for line in lines:
        print(f"[lstm-parity]   {line}")
    if bad:
        fail(f"LSTM training parity: card and CPU differ beyond the "
             f"tolerance in {bad}")


# --- SSD-VGG16 serving -----------------------------------------------------
def ssd_numpy(mx, seed, dtype=np.float32):
    """SSD-VGG16's inference symbol (20 classes, 300x300) and parameters as
    numpy, from ``seed``: He-normal weights for the VGG trunk and the extra
    scales, N(0, 0.01) for the multibox heads (the usual init of detection
    heads), zero biases."""
    sym = mx.models.ssd.get_symbol(num_classes=SSD_CLASSES,
                                   data_shape=SSD_SHAPE)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 3, SSD_SHAPE, SSD_SHAPE))
    rng = np.random.default_rng(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_weight"):
            std = (0.01 if "_pred_conv_" in name
                   else math.sqrt(2.0 / math.prod(shape[1:])))
            args[name] = rng.standard_normal(shape, np.float32) * std
        else:
            args[name] = np.zeros(shape, np.float32)
    return sym, {k: v.astype(dtype) for k, v in args.items()}


def ssd_params(mx, args, device):
    arg_nd, _ = mx.convert.params_from_numpy(args, {}, device)
    return {f"arg:{k}": v for k, v in arg_nd.items()}


def ssd_images(n, dtype=np.float32):
    return np.random.default_rng(SEED + 11).standard_normal(
        (n, 3, SSD_SHAPE, SSD_SHAPE), np.float32).astype(dtype)


class record_calls:
    """Within the block, keep the arguments and result of every call of
    each ``(key, module, attribute)`` target, by key (the tensors
    themselves; nothing is copied or launched). Keyword arguments are kept
    after the positional ones, in the call's order (``nms``'s ``classes``
    is its eighth parameter)."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {key: [] for key, _mod, _attr in targets}
        self.saved = []

    def __enter__(self):
        for key, mod, attr in self.targets:
            fn = getattr(mod, attr)

            def rec(*a, _fn=fn, _key=key, **kw):
                out = _fn(*a, **kw)
                self.calls[_key].append((a + tuple(kw.values()), out))
                return out
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def record_detection():
    """Record the ``multibox_decode`` and ``nms`` calls of the detection
    step and the forward's ``l2norm_channel``."""
    from mxnet_tpu_torch.kernels import multibox_decode as dec, nms

    return record_calls([("multibox_decode", dec, "multibox_decode"),
                         ("nms", nms, "nms"), *l2norm_targets()])


def l2norm_targets():
    """``l2norm_channel`` where the forward calls it: the op's own name in
    inference, the kernel module's through ``L2NormChannelFn`` in
    training."""
    from mxnet_tpu_torch.kernels import l2norm_channel as l2
    from mxnet_tpu_torch.ops import defs_nn

    return [("l2norm_channel", l2, "l2norm_channel"),
            ("l2norm_channel", defs_nn, "l2norm_channel")]


def ssd_nms_launches(n):
    """``nms``'s launches per detection step of SSD-300 at batch ``n`` on
    this card, as its plan gives them (segments by class)."""
    from mxnet_tpu_torch.kernels import nms

    return nms.plan(n, SSD_ANCHORS, SSD_CLASSES, False,
                    nms.device_limits(0)).launches


def nms_grid_inputs(torch, dev, seed, n=4, a=1000, classes=3):
    """NMS inputs whose boxes lie on a 1/16 grid, so many IoUs are exactly
    1/2, 1/4 or 1/3; scores from four levels (ties), every ninth exactly at
    the 0.01 validity threshold. Returns (boxes, score, cls_id, order)."""
    rng = np.random.default_rng(seed)
    x1 = rng.integers(0, 10, (n, a, 2)) / 16
    wh = rng.integers(1, 6, (n, a, 2)) / 16
    boxes = np.concatenate([x1, x1 + wh], 2).astype(np.float32)
    score = np.asarray([0.2, 0.4, 0.6, 0.8], np.float32)[
        rng.integers(0, 4, (n, a))]
    score[:, ::9] = np.float32(0.01)
    cls_id = rng.integers(0, classes, (n, a)).astype(np.int32)
    return nms_tensors(torch, dev, boxes, score, cls_id)


def nms_tie_inputs(torch, dev, seed, a=777):
    """Three images: every score equal (grid boxes, two classes); scores
    duplicated in pairs over continuous boxes; no valid box (every score
    at or below 0.01)."""
    rng = np.random.default_rng(seed)
    x1 = rng.integers(0, 10, (a, 2)) / 16
    grid = np.concatenate([x1, x1 + rng.integers(1, 6, (a, 2)) / 16], 1)
    lo = rng.uniform(0, 0.7, (a, 2))
    cont = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (a, 2))], 1)
    boxes = np.stack([grid, cont, cont]).astype(np.float32)
    pairs = np.repeat(rng.uniform(0.02, 1, (a + 1) // 2), 2)[:a]
    score = np.stack([np.full(a, 0.5), pairs,
                      rng.uniform(0, 0.01, a)]).astype(np.float32)
    score[2, ::5] = np.float32(0.01)
    cls_id = np.stack([rng.integers(0, 2, a), rng.integers(0, 3, a),
                       rng.integers(0, 3, a)]).astype(np.int32)
    return nms_tensors(torch, dev, boxes, score, cls_id)


def nms_tensors(torch, dev, boxes, score, cls_id):
    boxes, score, cls_id = (torch.from_numpy(t).to(dev)
                            for t in (boxes, score, cls_id))
    return boxes, score, cls_id, torch.argsort(-score, dim=1, stable=True)


def nms_iou_count(torch, out, score, cls_id, order, threshold, force):
    """IoUs greedy NMS needs on these inputs: for each kept box, the valid
    boxes after it in the order that it may suppress — those of its own
    class, or of any class with ``force``."""
    valid = torch.gather(score, 1, order) > threshold
    kept = torch.gather(out[..., 0] >= 0, 1, order)
    group = (torch.zeros_like(order) if force
             else torch.gather(cls_id, 1, order).long())
    ones = torch.nn.functional.one_hot(group, int(group.max()) + 1)
    ones = ones * valid[..., None]
    after = ones.sum(1, keepdim=True) - torch.cumsum(ones, 1)
    own = torch.gather(after, 2, group[..., None])[..., 0]
    return int((own * kept).sum())


def keep_count(out):
    return int((out[..., 0] >= 0).sum())


def phase_ssd_kernels(torch, mx, ssd):
    """``nms``, ``multibox_decode`` and ``l2norm_channel`` against their
    plain versions on the card: NMS bit for bit on three sets of inputs
    (the real SSD-300 head at batch 8, grid boxes with IoUs exactly at the
    threshold, ties and an invalid image), the decode within
    ``DECODE_RTOL``/``DECODE_ATOL``, the normalization within
    ``L2_RTOL``/``L2_ATOL``; each timed beside its bound and the PyTorch
    call for the same function where there is one."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (
        l2norm_channel as l2, multibox_decode as dec, nms)

    dev = torch.device("cuda", 0)
    sym, args = ssd
    t0 = time.perf_counter()
    pred = mx.predictor.Predictor(sym, ssd_params(mx, args, "cuda:0"),
                                  {"data": (SSD_BATCH, 3, SSD_SHAPE,
                                            SSD_SHAPE)})
    with record_detection() as rec:
        pred.forward(data=ssd_images(SSD_BATCH))
        torch.cuda.synchronize()
    (logits, loc, anchors, var, clip, softmax), _ = rec.calls[
        "multibox_decode"][0]
    (boxes, score, cls_id, order, thr, nms_thr, force, classes), head_out = \
        rec.calls["nms"][0]
    print(f"[ssd-kernels] SSD-300 head at batch {SSD_BATCH} "
          f"({time.perf_counter() - t0:.1f} s): logits {tuple(logits.shape)} "
          f"strides {logits.stride()}, loc {tuple(loc.shape)}, anchors "
          f"{tuple(anchors.shape)}; threshold {thr}, nms_threshold {nms_thr}",
          flush=True)
    if (logits.shape != (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS)
            or not softmax):
        fail(f"SSD head: logits {tuple(logits.shape)} softmax={softmax}")

    # --- nms: bit for bit on three sets of inputs, split by class (the
    # path's route) and as whole images
    if classes != SSD_CLASSES:
        fail(f"the detection step passed nms classes={classes}")
    sets = [("SSD-300 head", (boxes, score, cls_id, order), thr,
             [(nms_thr, False, SSD_CLASSES), (nms_thr, True, SSD_CLASSES),
              (nms_thr, False, None)]),
            ("grid boxes, IoU at the threshold",
             nms_grid_inputs(torch, dev, SEED + 12), 0.01,
             [(0.5, False, 3), (0.25, False, 3), (0.5, True, 3),
              (0.5, False, None)]),
            ("ties, force, an invalid image",
             nms_tie_inputs(torch, dev, SEED + 13), 0.01,
             [(0.5, False, 3), (0.5, True, 3), (0.3, False, 3),
              (0.3, False, None)])]
    nms_err = 0.0
    for what, ins, t, cases in sets:
        kept = []
        for nt, fs, cl in cases:
            got = nms.nms(*ins, t, nt, fs, cl)
            want = nms.nms_plain(*ins, t, nt, fs)
            torch.cuda.synchronize()
            nms_err = max(nms_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                diff = int((got[..., 0] != want[..., 0]).sum())
                fail(f"nms on {what} (nms_threshold {nt}, force {fs}, "
                     f"classes {cl}): "
                     f"{diff} ids/keep decisions differ from the plain "
                     f"version")
            kept.append(keep_count(got))
        if what == "SSD-300 head" and not torch.equal(
                head_out, nms.nms_plain(*ins, t, nms_thr, False)):
            fail("nms in the detection step differs from its plain version")
        print(f"[ssd-kernels] nms equals its plain version bit for bit on "
              f"{what} {tuple(ins[0].shape[:2])}: kept {kept} of "
              f"{ins[1].numel()} for (nms_threshold, force, classes) "
              f"{cases}",
              flush=True)

    # --- multibox_decode: softmax on the logits, and on probabilities
    dec_err = 0.0
    probs = dec.channel_softmax(logits)
    for what, cls, sm in (("logits (strided view)", logits, True),
                          ("probabilities", probs.contiguous(), False)):
        got = dec.multibox_decode(cls, loc, anchors, var, clip, sm)
        want = dec.multibox_decode_plain(cls, loc, anchors, var, clip, sm)
        for name, g, w in zip(("boxes", "score"), got[:2], want[:2]):
            dec_err = max(dec_err, check(
                torch, f"multibox_decode {name} from {what}", g, w,
                DECODE_RTOL, DECODE_ATOL))
        fg = (dec.channel_softmax(cls) if sm else cls)[:, 1:]
        top2 = torch.topk(fg, 2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > DECODE_RTOL * top2[:, 0] + \
            DECODE_ATOL
        bad = int(((got[2] != want[2]) & clear).sum())
        if bad:
            fail(f"multibox_decode class ids from {what}: {bad} differ "
                 f"where the two best probabilities are apart")
        print(f"[ssd-kernels] multibox_decode matches its plain version on "
              f"{what}: boxes and scores within rtol {DECODE_RTOL} atol "
              f"{DECODE_ATOL}, class ids equal at {int(clear.sum())} of "
              f"{clear.numel()} anchors with a clear best class (the rest "
              f"within rounding of a tie)", flush=True)

    # --- l2norm_channel: conv4_3's shape and odd ones, scale 1 and 20
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    l2_err = 0.0
    for shape in (SSD_CONV4_3, (3, 5, 7, 9), (2, 3), (1, 1000, 1, 1)):
        x = torch.randn(shape, generator=gen, device=dev)
        for scale in (1.0, 20.0):
            l2_err = max(l2_err, check(
                torch, f"l2norm_channel {shape} scale {scale}",
                l2.l2norm_channel(x, SSD_L2_EPS, scale),
                l2.l2norm_channel_plain(x, SSD_L2_EPS, scale),
                L2_RTOL, L2_ATOL * scale))
    print(f"[ssd-kernels] l2norm_channel matches its plain version at 4 "
          f"shapes x scale 1, 20: max abs err {l2_err:g} (rtol {L2_RTOL}, "
          f"atol {L2_ATOL} x scale)", flush=True)

    # --- times at the serving path's shapes, beside the bounds
    n, c1, a = logits.shape
    dec_ms = cuda_ms(torch, lambda: dec.multibox_decode(
        logits, loc, anchors, var, clip, True), reps=50)
    dec_plain = cuda_ms(torch, lambda: dec.multibox_decode_plain(
        logits, loc, anchors, var, clip, True), reps=10)
    dec_bound, dec_by = bound(n * a * (4 * c1 + 16 + 16 + 8) + a * 16,
                              n * a * (5 * c1 + 20))
    nms_ms = cuda_ms(torch, lambda: nms.nms(boxes, score, cls_id, order, thr,
                                            nms_thr, False, classes), reps=20)
    nms_plain = cuda_ms(torch, lambda: nms.nms_plain(
        boxes, score, cls_id, order, thr, nms_thr, False), reps=1, warmup=0)
    ious = nms_iou_count(torch, head_out, score, cls_id, order, thr, False)
    nms_bound, nms_by = bound(n * a * (16 + 4 + 4 + 8 + 24),
                              ious * NMS_IOU_OPS)
    x = torch.randn(SSD_CONV4_3, generator=gen, device=dev)
    l2_ms = cuda_ms(torch, lambda: l2.l2norm_channel(x, SSD_L2_EPS, 20.0),
                    reps=50)
    l2_plain = cuda_ms(torch, lambda: l2.l2norm_channel_plain(
        x, SSD_L2_EPS, 20.0), reps=20)
    l2_lib = cuda_ms(torch, lambda: F.normalize(x, dim=1) * 20.0, reps=20)
    l2_bound, l2_by = bound(2 * x.numel() * 4, 4 * x.numel())
    print(f"[ssd-kernels] multibox_decode at {tuple(logits.shape)}: kernel "
          f"{dec_ms:.4f} ms, plain {dec_plain:.4f} ms, bound "
          f"{dec_bound * 1e3:.2f} us ({dec_by}); nms at {(n, a)}: kernel "
          f"{nms_ms:.4f} ms, plain {nms_plain:.1f} ms, "
          f"{keep_count(head_out)} kept, {ious} same-class IoUs needed, bound "
          f"{nms_bound * 1e3:.2f} us ({nms_by}); l2norm_channel at "
          f"{SSD_CONV4_3} x 20: kernel {l2_ms:.4f} ms, plain {l2_plain:.4f} "
          f"ms, F.normalize * 20 {l2_lib:.4f} ms (max(norm, eps), not "
          f"+ eps), bound {l2_bound * 1e3:.2f} us ({l2_by})", flush=True)
    del pred
    return [
        {"name": "multibox_decode", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/multibox_decode.cu",
         "replaces": "mxnet_tpu/ops/defs_contrib.py:256",
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain,
         "bound_ms": dec_bound, "bound_by": dec_by, "library_ms": None},
        {"name": "nms", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/nms.cu",
         "replaces": "mxnet_tpu/ops/defs_contrib.py:234",
         "max_abs_err": nms_err, "ms": nms_ms, "plain_ms": nms_plain,
         "bound_ms": nms_bound, "bound_by": nms_by, "library_ms": None},
        {"name": "l2norm_channel", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/l2norm_channel.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:500",
         "max_abs_err": l2_err, "ms": l2_ms, "plain_ms": l2_plain,
         "bound_ms": l2_bound, "bound_by": l2_by, "library_ms": l2_lib},
    ], (boxes, score, cls_id, order, thr, nms_thr), {
        "multibox_decode": rec.calls["multibox_decode"][0][0],
        "l2norm_channel": rec.calls["l2norm_channel"][0][0]}


def ssd_cpu_answers(mx, sym, args, x, dtype=np.float32):
    """The port's CPU Predictor on ``x``: the detections and the class
    probabilities (a Group with ``cls_prob``, so the detection there runs
    op by op, on the probabilities)."""
    internals = sym.get_internals()
    group = mx.sym.Group([sym, internals["cls_prob_output"]])
    pred = mx.predictor.Predictor(
        group, ssd_params(mx, {k: v.astype(dtype) for k, v in args.items()},
                          "cpu"),
        {"data": x.shape}, dev_type="cpu", input_types={"data": dtype})
    det, prob = pred.run(data=x.astype(dtype))
    return det, prob


def ssd_compare(got, want, prob):
    """``got`` against ``want`` (n, A, 6) detections: the worst score and
    box difference over every anchor, the anchors whose keep decision
    differs, and the class ids that differ where both kept the anchor and
    ``prob`` (the reference side's class probabilities) has a clear best
    foreground class."""
    cont = np.abs(got[..., 1:].astype(np.float64) - want[..., 1:])
    scale = np.abs(want[..., 1:]).astype(np.float64)
    worst_rel = float((cont / np.maximum(scale, SSD_SERVE_TOL[1]
                                         / SSD_SERVE_TOL[0])).max())
    over = int((cont > SSD_SERVE_TOL[1] + SSD_SERVE_TOL[0] * scale).sum())
    keep_g, keep_w = got[..., 0] >= 0, want[..., 0] >= 0
    top2 = -np.sort(-prob[:, 1:], axis=1)[:, :2]
    clear = top2[:, 0] - top2[:, 1] > SSD_SERVE_TOL[0] * top2[:, 0]
    both = keep_g & keep_w
    ids = int(((got[..., 0] != want[..., 0]) & both & clear).sum())
    return {"max_abs": float(cont.max()), "worst_rel": worst_rel,
            "over_tol": over, "keep_diff": int((keep_g != keep_w).sum()),
            "id_diff": ids, "kept": int(keep_g.sum()),
            "kept_ref": int(keep_w.sum())}


def ssd_cpu_readings():
    """The readings ``SSD_SERVE_TOL`` and ``SSD_KEEP_LIMIT`` were fixed
    from, made before any card ran the SSD path: the port's CPU Predictor
    in float32 against the same in float64, SSD-300 at the served 9
    images. Needs no card."""
    import torch

    import mxnet_tpu_torch as mx

    sym, args = ssd_numpy(mx, SEED + 10)
    x = ssd_images(SSD_REQUESTS)
    t0 = time.perf_counter()
    det32, _ = ssd_cpu_answers(mx, sym, args, x)
    det64, prob64 = ssd_cpu_answers(mx, sym, args, x, np.float64)
    res = ssd_compare(det32, det64, prob64)
    print(f"[ssd-cpu] float32 against float64, SSD-300 at {SSD_REQUESTS} "
          f"images on the CPU ({torch.get_num_threads()} threads, "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(res)}", flush=True)
    return res


def phase_ssd_serving(torch, mx, card, ssd):
    """SSD-300 behind ``ModelServer(buckets=(1, 8))`` on the card: 9
    requests (a wave of 8, then 1) with the launches of each served batch
    checked exactly and no plain version on data; the answers against the
    port's CPU Predictor (``SSD_SERVE_TOL``, ``SSD_KEEP_LIMIT``) and the
    card's own head tensors through the plain CPU NMS, bit for bit; then
    the time per batch at bucket 8 through the server and for the forward
    alone, and a ``torch.profiler`` breakdown of one forward."""
    from mxnet_tpu_torch import kernels as K
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.serving import ModelServer, ServingConfig

    sym, args = ssd
    names = ("multibox_decode", "nms", "l2norm_channel")
    t0 = time.perf_counter()
    srv = ModelServer(sym, ssd_params(mx, args, "cpu"),
                      {"data": (3, SSD_SHAPE, SSD_SHAPE)},
                      config=ServingConfig(buckets=SSD_BUCKETS,
                                           max_delay_ms=200))
    try:
        srv.warmup()
        srv.start()
        graph = srv.predictor(SSD_BATCH)._exec.graph
        print(f"[ssd-serving] SSD-300 server up in "
              f"{time.perf_counter() - t0:.1f} s: replicas "
              f"{[r['device'] for r in srv.stats()['replicas']]}, buckets "
              f"{SSD_BUCKETS}, routes: {len(graph.detection)} detection, "
              f"{len(graph.l2norm)} l2norm", flush=True)
        if (len(graph.detection), len(graph.l2norm)) != (1, 1):
            fail("the SSD graph did not take the detection and l2norm routes")
        x = ssd_images(SSD_REQUESTS)
        waves = [(range(0, SSD_BATCH), SSD_BATCH),
                 (range(SSD_BATCH, SSD_REQUESTS), 1)]
        answers, buckets = [None] * SSD_REQUESTS, [None] * SSD_REQUESTS
        plain_calls = count_plain_calls(torch, [getattr(K, n) for n in names])

        # the main path: every count at 0 just before, read just after
        tm.reset()
        for k in plain_calls:
            plain_calls[k] = 0
        for idx, _want in waves:
            futs = {i: srv.submit(x[i]) for i in idx}
            for i, f in futs.items():
                answers[i] = f.result(timeout=300)[0]
                buckets[i] = f.bucket
        counters = launch_counters()
        launches = {n: counters[n].value for n in names}
        others = {n: c.value for n, c in counters.items() if n not in names}
        batches = tm.counter("serving.batches").value
        plain = dict(plain_calls)

        for idx, want in waves:
            got = {buckets[i] for i in idx}
            if got != {want}:
                fail(f"requests {idx} ran in buckets {got}, expected {want}")
        per_nms = ssd_nms_launches(SSD_BATCH)
        want_launches = {"multibox_decode": batches,
                         "nms": per_nms * batches, "l2norm_channel": batches}
        if (batches != len(waves) or launches != want_launches
                or any(others.values()) or any(plain.values())
                or ssd_nms_launches(1) != per_nms):
            fail(f"SSD launches {launches} (others {others}) over {batches} "
                 f"served batches, plain calls {plain}; expected per batch 1 "
                 f"multibox_decode, {per_nms} nms (its plan), 1 "
                 f"l2norm_channel and nothing else")
        print(f"[ssd-serving] {SSD_REQUESTS} requests served in buckets 8, 1 "
              f"({batches} batches): launches {launches} = 1 "
              f"multibox_decode, {per_nms} nms (its plan), 1 l2norm_channel "
              f"per batch; plain versions on data {sum(plain.values())}",
              flush=True)

        # the card's own head tensors through the plain NMS on the CPU
        pred = srv.predictor(SSD_BATCH)
        with record_detection() as rec:
            pred.forward(data=x[:SSD_BATCH])
            torch.cuda.synchronize()
        ins, card_out = rec.calls["nms"][0]
        cpu_out = K.nms.nms_plain(*[t.cpu() if hasattr(t, "cpu") else t
                                    for t in ins])
        if not torch.equal(card_out.cpu(), cpu_out):
            fail("the card's NMS rows differ from the plain CPU NMS on the "
                 "card's own head tensors")
        got = np.stack(answers)
        if not np.array_equal(got[:SSD_BATCH], card_out.cpu().numpy()):
            fail("the served answers differ from a forward of the same "
                 "bucket-8 predictor")
        print(f"[ssd-serving] the plain NMS on the CPU, fed the card's own "
              f"head tensors at bucket 8, gives the card's rows bit for bit "
              f"({keep_count(card_out)} kept of {card_out.shape[0]} x "
              f"{card_out.shape[1]})", flush=True)

        # every answer against the port's CPU Predictor
        t1 = time.perf_counter()
        ref, prob = ssd_cpu_answers(mx, sym, args, x)
        res = ssd_compare(got, ref, prob)
        if (got.shape != (SSD_REQUESTS, SSD_ANCHORS, 6)
                or not np.isfinite(got).all()):
            fail(f"answers: shape {got.shape}, finite "
                 f"{np.isfinite(got).all()}")
        print(f"[ssd-serving] answers against the CPU Predictor "
              f"({time.perf_counter() - t1:.1f} s): {json.dumps(res)}; "
              f"limits: score and box rtol {SSD_SERVE_TOL[0]} atol "
              f"{SSD_SERVE_TOL[1]}, keep disagreements <= {SSD_KEEP_LIMIT}, "
              f"class ids 0 where both kept and clear", flush=True)
        if res["over_tol"] or res["id_diff"] or \
                res["keep_diff"] > SSD_KEEP_LIMIT:
            fail(f"SSD answers vs the CPU Predictor: {res}")

        # throughput at bucket 8: a closed loop of 8 requests, batch after
        # batch, over a window of a few seconds
        tm.reset()
        per_batch = []
        for _ in range(SSD_SERVE_BATCHES):
            t0 = time.perf_counter()
            futs = [srv.submit(x[i]) for i in range(SSD_BATCH)]
            for f in futs:
                f.result(timeout=300)
            per_batch.append((time.perf_counter() - t0) * 1e3)
        batch_ms = float(np.mean(per_batch))
        lo, p10, p50, p90, hi = np.percentile(per_batch, (0, 10, 50, 90, 100))
        infer = tm.histogram("serving.infer")
        wait = tm.histogram("serving.queue_wait")
        fwd_ms = cuda_ms(torch, lambda: pred.forward(), reps=20, warmup=2)
        print(f"[ssd-serving] bucket 8 on {card}: {batch_ms:.2f} ms per batch "
              f"through the server ({8e3 / batch_ms:.1f} images/s) over "
              f"{SSD_SERVE_BATCHES} batches in {sum(per_batch) / 1e3:.2f} s; "
              f"per batch min {lo:.2f}, p10 {p10:.2f}, p50 {p50:.2f}, p90 "
              f"{p90:.2f}, max {hi:.2f} ms; serving.infer mean "
              f"{infer.sum / infer.count / 1e3:.2f} ms, serving.queue_wait "
              f"mean {wait.sum / wait.count / 1e3:.2f} ms over {infer.count} "
              f"batches; forward alone {fwd_ms:.2f} ms "
              f"({8e3 / fwd_ms:.1f} images/s)", flush=True)
        device_ms = ssd_profile(torch, pred)
    finally:
        srv.close()
    return launches, device_ms


def ssd_profile(torch, pred, reps=3):
    """One bucket-8 forward under torch.profiler: the device's busy share,
    the top device operations and the port's kernels' device ms per
    forward. Measurement only; it fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total / reps, round(ev.count / reps), ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total]
    busy = sum(r[0] for r in rows)
    if not busy:
        print("[ssd-profile] torch.profiler recorded no device time")
        return {}
    ours = {}
    for us, count, key in rows:
        for kernel, mark in PORT_KERNELS.items():
            if mark in key:
                ours[kernel] = ours.get(kernel, 0.0) + us / 1e3
    print(f"[ssd-profile] one forward at bucket 8: device busy "
          f"{busy / 1e3:.2f} ms of {wall_us / reps / 1e3:.2f} ms wall "
          f"({100 * busy * reps / wall_us:.0f}%), "
          f"{sum(r[1] for r in rows)} launches; the port's kernels "
          f"{ {k: round(v, 4) for k, v in ours.items()} } ms; top by device "
          f"time:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[ssd-profile]   {us / 1e3:8.3f} ms {100 * us / busy:5.1f}% "
              f"x{count:<3d} {key[:90]}")
    return ours


# --- SSD-VGG16 training ------------------------------------------------------
MBT_CASES = ("random", "padded rows and an image without objects",
             "grid: IoU at the threshold, shared best anchors",
             "tied and signed-zero logits at the mining boundary",
             "a padded row after an object whose best anchor is anchor 0",
             "mining off", "minimum negative samples")
MBT_PARAMS = {"overlap_threshold": 0.5, "ignore_label": -1.0,
              "negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5,
              "minimum_negative_samples": 0,
              "variances": (0.1, 0.1, 0.2, 0.2)}


def mbt_case(name, a=300):
    """``(anchors (1, A, 4), label (n, G, 5), cls_pred (n, 6, A), params)``
    as numpy for one of ``MBT_CASES``, MultiBoxTarget's edge inputs."""
    rng = np.random.default_rng(SEED + 50 + MBT_CASES.index(name))

    def grid_anchors():  # many IoUs with grid objects are 1/2, 1/4, 1/3
        x1 = rng.integers(0, 12, (a, 2)) / 16
        wh = rng.integers(1, 5, (a, 2)) / 16
        return np.concatenate([x1, x1 + wh], 1).astype(np.float32)[None]

    def random_anchors():
        lo = rng.uniform(0, 0.8, (a, 2))
        return np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (a, 2))],
                              1).astype(np.float32)[None]

    def labels(valid_counts, g, grid=False):
        label = np.full((len(valid_counts), g, 5), -1.0, np.float32)
        for b, k in enumerate(valid_counts):
            for j in range(k):
                if grid:
                    x1 = rng.integers(0, 10, 2) / 16
                    box = np.concatenate([x1, x1 + rng.integers(2, 6, 2) / 16])
                else:
                    x1 = rng.uniform(0, 0.6, 2)
                    box = np.concatenate([x1, x1 + rng.uniform(0.1, 0.4, 2)])
                label[b, j] = [rng.integers(0, 5), *box]
        return label

    def logits(n, levels=None, p=None):
        if levels is None:
            return rng.standard_normal((n, 6, a)).astype(np.float32)
        return rng.choice(np.asarray(levels, np.float32), (n, 6, a), p=p)

    if name == "random":
        return random_anchors(), labels([6, 3, 1], 6), logits(3), MBT_PARAMS
    if name == "padded rows and an image without objects":
        return random_anchors(), labels([2, 0, 4], 5), logits(3), MBT_PARAMS
    if name == "grid: IoU at the threshold, shared best anchors":
        label = labels([6, 5, 3, 6], 6, grid=True)
        label[0, 1, 1:] = label[0, 0, 1:]  # two objects, one best anchor
        label[1, 2, 1:] = label[1, 0, 1:]
        return grid_anchors(), label, logits(4), MBT_PARAMS
    if name == "tied and signed-zero logits at the mining boundary":
        # a few keys below the signed zeros, so the boundary falls on them
        return grid_anchors(), labels([4, 2, 3], 4, grid=True), \
            logits(3, [-1.0, -0.0, 0.0, 0.5], [0.02, 0.3, 0.3, 0.38]), \
            MBT_PARAMS
    if name == "a padded row after an object whose best anchor is anchor 0":
        # the object's best anchor is anchor 0 at IoU 0.38 (not a match by
        # the threshold); the padded row's best anchor is anchor 0 too, and
        # its write comes last in image 0, first in image 1
        anc = random_anchors()
        anc[0, 0] = [0.0, 0.0, 0.4, 0.4]
        anc[0, 1:, :2] = np.maximum(anc[0, 1:, :2], 0.45)
        anc[0, 1:, 2:] = anc[0, 1:, :2] + 0.1
        obj, pad = [2.0, 0.0, 0.0, 0.2, 0.5], [-1.0, 0.0, 0.0, 0.0, 0.0]
        label = np.array([[obj, pad], [pad, obj]], np.float32)
        return anc, label, logits(2), dict(MBT_PARAMS,
                                           negative_mining_ratio=-1.0)
    if name == "mining off":
        return random_anchors(), labels([3, 1], 4), logits(2), \
            dict(MBT_PARAMS, negative_mining_ratio=-1.0)
    if name == "minimum negative samples":
        # the minimum binds in the first three images; in the last,
        # int(2.9 * num_pos) does (truncated, as the reference's cast)
        return random_anchors(), labels([1, 0, 2, 16], 16), \
            logits(4, [0.0, 1.0, 2.0]), \
            dict(MBT_PARAMS, minimum_negative_samples=40,
                 negative_mining_ratio=2.9)
    raise KeyError(name)


def mbt_args(params):
    """MultiBoxTarget's parameters in the kernel wrapper's order."""
    return [params[k] for k in (
        "overlap_threshold", "ignore_label", "negative_mining_ratio",
        "negative_mining_thresh", "minimum_negative_samples", "variances")]


def ssd_train_symbol(mx):
    return mx.models.ssd.get_symbol_train(num_classes=SSD_CLASSES,
                                          data_shape=SSD_SHAPE)


def ssd_train_images(n, seed):
    """``n`` images and labels as ``examples/train_ssd.py``'s
    ``make_synthetic_rec`` paints them: 1..6 filled rectangles of a colour
    per class (20 classes, colours from the seed) over noise in 0..59,
    each side 1/6 to 1/2 of the image; then the example iterator's mean
    subtracted, times ``SSD_INPUT_SCALE``. Labels (n, SSD_OBJECTS, 5), rows
    ``[cls, x1, y1, x2, y2]`` normalized, -1 padded."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (SSD_CLASSES, 3)).astype(np.float32)
    s = SSD_SHAPE
    mean = np.asarray(SSD_MEAN, np.float32)[:, None, None]
    x = np.empty((n, 3, s, s), np.float32)
    y = np.full((n, SSD_OBJECTS, 5), -1.0, np.float32)
    for i in range(n):
        img = rng.integers(0, 60, (3, s, s)).astype(np.float32)
        for j in range(rng.integers(1, 7)):
            c = rng.integers(0, SSD_CLASSES)
            w, h = rng.integers(s // 6, s // 2, 2)
            x0, y0 = rng.integers(0, s - w), rng.integers(0, s - h)
            img[:, y0:y0 + h, x0:x0 + w] = colors[c][:, None, None]
            y[i, j] = [c, x0 / s, y0 / s, (x0 + w) / s, (y0 + h) / s]
        x[i] = (img - mean) * np.float32(SSD_INPUT_SCALE)
    return x, y


def ssd_train_module(mx, sym, args, ctx, batch, dtype=np.float32):
    """``sym`` bound by ``Module(data_names=("data",),
    label_names=("label",))`` on ``ctx`` at ``batch``, parameters from the
    numpy ``args`` (cast to ``dtype``), SGD as ``SSD_TRAIN_OPT``."""
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[mx.io.DataDesc(
        "data", (batch, 3, SSD_SHAPE, SSD_SHAPE), dtype)],
        label_shapes=[mx.io.DataDesc("label", (batch, SSD_OBJECTS, 5),
                                     dtype)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu(), dtype=dtype)
                                for k, v in args.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SSD_TRAIN_OPT)
    return mod


def ssd_batch(mx, x, y, ctx, dtype=np.float32):
    return mx.io.DataBatch([mx.nd.array(x, ctx=ctx, dtype=dtype)],
                           [mx.nd.array(y, ctx=ctx, dtype=dtype)])


def ssd_losses(torch, outs):
    """``(class cross-entropy over the anchors whose target is not ignored,
    loc loss per matched anchor)`` from the training symbol's outputs
    ``[cls_prob, loc_loss, cls_label, det_out]``."""
    prob, loc, cls_t = (o._data for o in outs[:3])
    keep = cls_t >= 0
    p = torch.gather(prob, 1, cls_t.clamp_min(0).long()[:, None, :])[:, 0]
    ce = -(torch.log(p + 1e-8) * keep).sum() / keep.sum().clamp_min(1)
    return float(ce), float(loc.sum() / (cls_t > 0).sum().clamp_min(1))


def ssd_loss_curve(torch, mx, ctx, seed):
    """``SSD_LOSS_STEPS`` SGD steps of SSD-300 on one fixed batch of
    ``SSD_LOSS_BATCH`` painted images on ``ctx``, parameters from
    ``seed``: ``(cross-entropy, loc loss)`` of each step's forward."""
    _sym, args = ssd_numpy(mx, seed)
    x, y = ssd_train_images(SSD_LOSS_BATCH, seed + 1)
    mod = ssd_train_module(mx, ssd_train_symbol(mx), args, ctx,
                           SSD_LOSS_BATCH)
    batch = ssd_batch(mx, x, y, ctx)
    curve = []
    for _ in range(SSD_LOSS_STEPS):
        mod.forward_backward(batch)
        curve.append(ssd_losses(torch, mod.get_outputs()))
        mod.update()
    return curve


def ssd_parity_step(torch, mx, mod, x, y, dtype=np.float32):
    """One SGD step of ``mod`` on ``x``, ``y``; after it, the kinds of
    ``SSD_PARITY_TOL`` as float64 numpy arrays by name, and the step's
    ``cls_target``."""
    ctx = mod._context[0]
    mod.forward_backward(ssd_batch(mx, x, y, ctx, dtype))
    outs = mod.get_outputs()
    ce, loc = ssd_losses(torch, outs)
    cls_t = outs[2].asnumpy()
    mod.update()
    names = mod._exec_group.param_names
    arg, _aux = mod.get_params()
    return {"loss": {"ce": np.array([ce]), "loc": np.array([loc])},
            "param": {n: arg[n].asnumpy().astype(np.float64) for n in names},
            "momentum": {names[i]: m.asnumpy().astype(np.float64)
                         for i, m in mod._updater.states.items()},
            "cls_target": cls_t}


def ssd_parity_run(torch, mx, sides, dtypes, seed):
    """Two SGD steps at ``SSD_PARITY_BATCH`` of ``sides`` (name -> Module
    holding ``dtypes[name]``) on painted images from ``seed``; before the
    second, every side takes the first side's parameters and momenta.
    Returns ``{name: [step results]}``."""
    b = SSD_PARITY_BATCH
    x, y = ssd_train_images(2 * b, seed)
    names = list(sides)
    results = {n: [] for n in names}
    for s in range(2):
        if s:
            lead = sides[names[0]]
            arg, _aux = lead.get_params()
            for n in names[1:]:
                mod = sides[n]
                mod.set_params({k: mx.nd.array(v.asnumpy().astype(
                    dtypes[n]), ctx=mx.cpu(), dtype=dtypes[n])
                    for k, v in arg.items()}, {})
                for i, m in lead._updater.states.items():
                    mod._updater.states[i][:] = m.asnumpy().astype(dtypes[n])
        for n in names:
            results[n].append(ssd_parity_step(
                torch, mx, sides[n], x[s * b:(s + 1) * b],
                y[s * b:(s + 1) * b], dtypes[n]))
    return results


def ssd_parity_lines(res, got, want):
    """``(lines, {(step, kind): relative difference}, [cls_target
    disagreements per step])`` of side ``got`` against side ``want``."""
    lines, rels, apart = [], {}, []
    for s in range(2):
        for kind in SSD_PARITY_TOL:
            rel, worst, worst_rel = parity_diff(res[got][s][kind],
                                                res[want][s][kind])
            rels[(s, kind)] = rel
            lines.append(f"step {s + 1} {kind}: |{got} - {want}| / |{want}| "
                         f"= {rel:.3g}; worst tensor {worst} {worst_rel:.3g}")
        apart.append(int((res[got][s]["cls_target"]
                          != res[want][s]["cls_target"]).sum()))
    return lines, rels, apart


def ssd_train_cpu_readings(seeds=(0, 1, 2)):
    """The readings ``SSD_LOSS_RATIO``, ``SSD_PARITY_TOL`` and
    ``SSD_TARGET_LIMIT`` were fixed from, made before any card ran the SSD
    training phases, on the port's CPU path: the loss check's curve for
    each seed offset, and two parity steps in float32 against float64.
    Needs no card."""
    import torch

    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    for k in seeds:
        curve = ssd_loss_curve(torch, mx, mx.cpu(), SEED + 30 + k)
        (ce0, loc0), (ce1, loc1) = curve[0], curve[-1]
        print(f"[ssd-train-cpu] loss check, seed SEED + {30 + k}: cross-"
              f"entropy {ce0:.4f} -> {ce1:.4f} ({ce1 / ce0:.4f}), loc loss "
              f"{loc0:.4f} -> {loc1:.4f} ({loc1 / loc0:.4f}); curve "
              f"{[(round(c, 4), round(lo, 4)) for c, lo in curve]}",
              flush=True)
    _sym, args = ssd_numpy(mx, SEED + 40)
    sym = ssd_train_symbol(mx)
    dtypes = {"cpu": np.float32, "cpu64": np.float64}
    sides = {n: ssd_train_module(mx, sym, args, mx.cpu(), SSD_PARITY_BATCH,
                                 d) for n, d in dtypes.items()}
    res = ssd_parity_run(torch, mx, sides, dtypes, SEED + 41)
    lines, _rels, apart = ssd_parity_lines(res, "cpu", "cpu64")
    for line in lines:
        print(f"[ssd-train-cpu] {line}")
    print(f"[ssd-train-cpu] cls_target disagreements float32 vs float64 per "
          f"step {apart} of {SSD_PARITY_BATCH * SSD_ANCHORS} anchors "
          f"({torch.get_num_threads()} threads, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def ssd_train_targets():
    """The kernel calls recorded in an SSD training step."""
    from mxnet_tpu_torch.kernels import (
        l2norm_channel as l2, multibox_decode as dec,
        multibox_target as mbt, nms, softmax_rows as sm)
    from mxnet_tpu_torch.ops import defs_nn

    return [("multibox_target", mbt, "multibox_target"),
            ("l2norm_channel", l2, "l2norm_channel"),
            ("l2norm_channel_bwd", l2, "l2norm_channel_bwd"),
            ("softmax_rows", sm, "softmax_rows"),
            ("softmax_output_bwd", defs_nn, "softmax_output_bwd"),
            ("multibox_decode", dec, "multibox_decode"), ("nms", nms, "nms")]


def phase_ssd_train_kernels(torch, mx):
    """One SSD-300 training step at batch 32 on the card with its kernel
    calls recorded; each kernel against its plain version on the step's own
    tensors (``multibox_target`` and ``nms`` bit for bit), the new kernels
    also on edge inputs and odd shapes; each timed beside its bound and,
    where one PyTorch call computes the same function, that call."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (
        l2norm_channel as l2, multibox_decode as dec,
        multibox_target as mbt, nms, sgd_mom_multi as sg, softmax_rows as sm,
        softmax_output_bwd as so)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _sym, args = ssd_numpy(mx, SEED + 20)
    x, y = ssd_train_images(SSD_TRAIN_BATCH, SEED + 21)
    mod = ssd_train_module(mx, ssd_train_symbol(mx), args, mx.gpu(0),
                           SSD_TRAIN_BATCH)
    with record_calls(ssd_train_targets()) as rec:
        mod.forward_backward(ssd_batch(mx, x, y, mx.gpu(0)))
        torch.cuda.synchronize()
    # the recorded arguments and results, detached from the step's
    # autograd graph
    def detached(v):
        if isinstance(v, tuple):
            return tuple(detached(t) for t in v)
        return v.detach() if isinstance(v, torch.Tensor) else v

    calls = {k: detached(v[0]) for k, v in rec.calls.items()}
    n_calls = {k: len(v) for k, v in rec.calls.items()}
    if any(c != 1 for c in n_calls.values()):
        fail(f"one SSD training step called the kernels {n_calls} times")
    print(f"[ssd-train-kernels] one SSD-300 training step at batch "
          f"{SSD_TRAIN_BATCH} recorded ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    rows, extra = [], {}

    # --- multibox_target: bit for bit on the step and on edge inputs
    (anc, label, cls_pred, *params), got = calls["multibox_target"]
    if (tuple(cls_pred.shape) != (SSD_TRAIN_BATCH, SSD_CLASSES + 1,
                                  SSD_ANCHORS) or cls_pred.is_contiguous()):
        fail(f"multibox_target's cls_pred {tuple(cls_pred.shape)} strides "
             f"{cls_pred.stride()}: expected the class-major view")
    want = mbt.multibox_target_plain(anc, label, cls_pred, *params)
    torch.cuda.synchronize()
    mbt_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for what, g, w in zip(("loc_target", "loc_mask", "cls_target"), got,
                          want):
        if not torch.equal(g, w):
            fail(f"multibox_target {what} on the training step: "
                 f"{int((g != w).sum())} values differ from the plain version")
    cls_t = got[2]
    counts = [int((cls_t > 0).sum()), int((cls_t == 0).sum()),
              int((cls_t == -1).sum())]
    for name in MBT_CASES:
        a_np, l_np, c_np, p = mbt_case(name)
        ins = [torch.from_numpy(t).to(dev) for t in (a_np, l_np, c_np)]
        g_, w_ = (mbt.multibox_target(*ins, *mbt_args(p)),
                  mbt.multibox_target_plain(*ins, *mbt_args(p)))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g_, w_)):
            fail(f"multibox_target on '{name}' differs from its plain "
                 f"version")
    print(f"[ssd-train-kernels] multibox_target equals its plain version "
          f"bit for bit on the step's own tensors (label "
          f"{tuple(label.shape)}, cls_pred {tuple(cls_pred.shape)} strides "
          f"{cls_pred.stride()}: {counts[0]} matched, {counts[1]} mined "
          f"negatives, {counts[2]} ignored) and on {len(MBT_CASES)} edge "
          f"inputs", flush=True)
    n, a, g = label.shape[0], anc.numel() // 4, label.shape[1]
    ms = cuda_ms(torch, lambda: mbt.multibox_target(anc, label, cls_pred,
                                                    *params), reps=20)
    plain = cuda_ms(torch, lambda: mbt.multibox_target_plain(
        anc, label, cls_pred, *params), reps=3, warmup=1)
    # bytes: one 32-byte sector per strided background logit, the anchors
    # and labels once, 9 floats of targets per anchor; operations: the
    # (A, G) IoUs (~12 flops each) and the encoding (~20 per match)
    b_ms, b_by = bound(n * a * 32 + a * 16 + label.numel() * 4
                       + n * a * 9 * 4, n * a * g * 12 + counts[0] * 20)
    print(f"[ssd-train-kernels] multibox_target at A {a}, G {g}, batch {n}: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, no library call, "
          f"bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    rows.append({"name": "multibox_target", "route": "cuda",
                 "source": "mxnet_tpu_torch/csrc/multibox_target.cu",
                 "replaces": "mxnet_tpu/ops/defs_contrib.py:150",
                 "max_abs_err": mbt_err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # --- l2norm_channel_bwd: the step's own tensors and odd shapes
    (xl, gl, eps, scale), _dx = calls["l2norm_channel_bwd"]
    bwd_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    cases = [((xl, gl), scale, "the step's conv4_3")]
    for shape in ((3, 5, 7, 9), (2, 3), (1, 1000, 1, 1), (5, 17, 13, 11)):
        cases.append(((torch.randn(shape, generator=gen, device=dev),
                       torch.randn(shape, generator=gen, device=dev)), 20.0,
                      str(shape)))
        cases.append((cases[-1][0], 1.0, str(shape)))
    for (xc, gc), sc, what in cases:
        want_dx = l2.l2norm_channel_bwd_plain(xc, gc, eps, sc)
        bwd_err = max(bwd_err, check(
            torch, f"l2norm_channel_bwd {what} scale {sc}",
            l2.l2norm_channel_bwd(xc, gc, eps, sc), want_dx, 0.0,
            l2.bwd_limit(xc, gc, eps, sc, want_dx)))
    ms = cuda_ms(torch, lambda: l2.l2norm_channel_bwd(xl, gl, eps, scale),
                 reps=50)
    plain = cuda_ms(torch, lambda: l2.l2norm_channel_bwd_plain(
        xl, gl, eps, scale), reps=20)
    b_ms, b_by = bound(3 * xl.numel() * 4, 8 * xl.numel())
    print(f"[ssd-train-kernels] l2norm_channel_bwd matches its plain version "
          f"at {tuple(xl.shape)} x {scale} and 4 odd shapes x scale 1, 20: "
          f"max abs err {bwd_err:g} ({l2.BWD_RTOL} of the terms' "
          f"magnitudes + {l2.BWD_ATOL} x max|dx|); kernel {ms:.4f} ms, plain {plain:.4f} ms, no "
          f"library call, bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    rows.append({"name": "l2norm_channel_bwd", "route": "cuda",
                 "source": "mxnet_tpu_torch/csrc/l2norm_channel_bwd.cu",
                 "replaces": "mxnet_tpu/ops/defs_nn.py:500",
                 "max_abs_err": bwd_err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # --- the kernels of earlier slices, at this path's shapes
    def reused(name, err, ms, plain, bnd, lib=None):
        extra[name] = {"ssd_train_max_abs_err": err, "ssd_train_ms": ms,
                       "ssd_train_plain_ms": plain,
                       "ssd_train_bound_ms": bnd[0],
                       "ssd_train_bound_by": bnd[1],
                       "ssd_train_library_ms": lib}

    (xf, eps_f, scale_f), yf = calls["l2norm_channel"]
    err = check(torch, "l2norm_channel at the training step", yf,
                l2.l2norm_channel_plain(xf, eps_f, scale_f), L2_RTOL,
                L2_ATOL * scale_f)
    reused("l2norm_channel", err,
           cuda_ms(torch, lambda: l2.l2norm_channel(xf, eps_f, scale_f),
                   reps=50),
           cuda_ms(torch, lambda: l2.l2norm_channel_plain(xf, eps_f,
                                                          scale_f), reps=20),
           bound(2 * xf.numel() * 4, 4 * xf.numel()),
           cuda_ms(torch, lambda: F.normalize(xf, dim=1) * scale_f, reps=20))
    (flat,), pr = calls["softmax_rows"]
    err, _ = sm_check(torch, f"softmax_rows at {tuple(flat.shape)}", pr,
                      sm.softmax_rows_plain(flat))
    reused("softmax_rows", err,
           cuda_ms(torch, lambda: sm.softmax_rows(flat), reps=50),
           cuda_ms(torch, lambda: sm.softmax_rows_plain(flat), reps=20),
           bound(2 * flat.numel() * 4, 4 * flat.numel()),
           cuda_ms(torch, lambda: torch.softmax(flat, 1), reps=50))
    so_args, gso = calls["softmax_output_bwd"]
    err = check(torch, "softmax_output_bwd at the training step", gso,
                so.softmax_output_bwd_plain(*so_args), 0.0, EXACT_ATOL)
    p_ = so_args[0]
    ignored = float((so_args[1] == so_args[3]).float().mean())
    reused("softmax_output_bwd", err,
           cuda_ms(torch, lambda: so.softmax_output_bwd(*so_args), reps=50),
           cuda_ms(torch, lambda: so.softmax_output_bwd_plain(*so_args),
                   reps=20),
           bound(2 * p_.numel() * 4 + so_args[1].numel() * 4,
                 2 * p_.numel()))
    dargs, (dboxes, dscore, did) = calls["multibox_decode"]
    wb, ws, wid = dec.multibox_decode_plain(*dargs)
    err = max(check(torch, "multibox_decode boxes without the softmax",
                    dboxes, wb, DECODE_RTOL, DECODE_ATOL),
              check(torch, "multibox_decode scores without the softmax",
                    dscore, ws, DECODE_RTOL, DECODE_ATOL))
    top2 = torch.topk(dargs[0][:, 1:], 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > DECODE_RTOL * top2[:, 0] + DECODE_ATOL
    if int(((did != wid) & clear).sum()):
        fail("multibox_decode class ids without the softmax differ where "
             "the best class is clear")
    n_, c1, a_ = dargs[0].shape
    reused("multibox_decode", err,
           cuda_ms(torch, lambda: dec.multibox_decode(*dargs), reps=50),
           cuda_ms(torch, lambda: dec.multibox_decode_plain(*dargs), reps=10),
           bound(n_ * a_ * (4 * c1 + 16 + 16 + 8) + a_ * 16,
                 n_ * a_ * (2 * c1 + 20)))
    nargs, nout = calls["nms"]
    nplain = nms.nms_plain(*nargs)
    torch.cuda.synchronize()
    if not torch.equal(nout, nplain):
        fail(f"nms at the training step: "
             f"{int((nout[..., 0] != nplain[..., 0]).sum())} keep decisions "
             f"differ from the plain version")
    boxes, score, cls_id, order, thr, nms_thr, force, _classes = nargs
    ious = nms_iou_count(torch, nout, score, cls_id, order, thr, force)
    t_plain = time.perf_counter()
    nms.nms_plain(*nargs)
    torch.cuda.synchronize()
    reused("nms", 0.0, cuda_ms(torch, lambda: nms.nms(*nargs), reps=10),
           (time.perf_counter() - t_plain) * 1e3,
           bound(n_ * a_ * (16 + 4 + 4 + 8 + 24), ious * NMS_IOU_OPS))
    print(f"[ssd-train-kernels] at the training step: l2norm_channel "
          f"{tuple(xf.shape)} x {scale_f}, softmax_rows {tuple(flat.shape)}, "
          f"softmax_output_bwd {tuple(p_.shape)} (multi_output, use_ignore, "
          f"valid; {100 * ignored:.1f} % of labels ignored), multibox_decode "
          f"{tuple(dargs[0].shape)} on probabilities, nms "
          f"{tuple(score.shape)} threshold {nms_thr} ({keep_count(nout)} "
          f"kept, {ious} same-class IoUs needed) each hold their plain "
          f"versions (nms bit for bit); times {json.dumps(extra)}",
          flush=True)

    # --- sgd_mom_multi over SSD's parameters, with the step's gradients
    exe = mod._exec_group._exec
    names = sorted(args)
    ws_ = [exe.arg_dict[k]._data.clone() for k in names]
    gs_ = [exe.grad_dict[k]._data for k in names]
    ms_ = [torch.randn(w.shape, generator=gen, device=dev) * 1e-4
           for w in ws_]
    lrs = [SSD_TRAIN_OPT["learning_rate"]] * len(names)
    wds = [SSD_TRAIN_OPT["wd"] if k.endswith("_weight") else 0.0
           for k in names]
    w2, m2 = [w.clone() for w in ws_], [m.clone() for m in ms_]
    sg.sgd_mom_multi(ws_, gs_, ms_, lrs, wds, 0.9, 1 / SSD_TRAIN_BATCH, -1.0)
    sg.sgd_mom_multi_plain(w2, gs_, m2, lrs, wds, 0.9, 1 / SSD_TRAIN_BATCH,
                           -1.0)
    err = max(check(torch, "sgd_mom_multi over SSD's parameters", a_, b_,
                    0.0, EXACT_ATOL) for a_, b_ in zip(ws_ + ms_, w2 + m2))
    cache = {}
    sg_ms = cuda_ms(torch, lambda: sg.sgd_mom_multi(
        ws_, gs_, ms_, lrs, wds, 0.9, 1 / SSD_TRAIN_BATCH, -1.0,
        cache=cache), reps=50)
    sg_plain = cuda_ms(torch, lambda: sg.sgd_mom_multi_plain(
        ws_, gs_, ms_, lrs, wds, 0.9, 1 / SSD_TRAIN_BATCH, -1.0), reps=5)
    tparams = [torch.nn.Parameter(w) for w in ws_]
    for tp, gr in zip(tparams, gs_):
        tp.grad = gr
    topt = torch.optim.SGD(tparams, lr=SSD_TRAIN_OPT["learning_rate"],
                           momentum=0.9, weight_decay=SSD_TRAIN_OPT["wd"],
                           fused=True)
    numel = sum(w.numel() for w in ws_)
    reused("sgd_mom_multi", err, sg_ms, sg_plain,
           bound(20 * numel, 6 * numel), cuda_ms(torch, topt.step, reps=50))
    print(f"[ssd-train-kernels] sgd_mom_multi matches its plain version over "
          f"SSD's {len(names)} tensors ({numel / 1e6:.2f} M values, wd "
          f"{SSD_TRAIN_OPT['wd']} on the weights): max abs err {err:g}; "
          f"{json.dumps(extra['sgd_mom_multi'])}", flush=True)
    recorded = {"l2norm_channel_bwd": (xl, gl, eps, scale),
                "softmax_output_bwd": so_args,
                "multibox_target": (anc, label, cls_pred, *params),
                "l2norm_channel": (xf, eps_f, scale_f),
                "multibox_decode": dargs}
    del mod, exe, rec, calls
    return rows, extra, nargs[:6], recorded


def phase_ssd_training(torch, mx, card):
    """SSD-300 trained by ``Module.fit`` at batch 32 on the card over an
    ``NDArrayIter`` of painted images: every step's launches exactly
    ``SSD_TRAIN_LAUNCHES`` and no plain version on data; the loss check;
    ms per step and images/s of fit's own steps after the first, with
    device prefetch on (the main path) and off; the compute step by CUDA
    events, peak memory and a profile of one step."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.kernels import sgd_mom_multi

    t0 = time.perf_counter()
    _sym, args = ssd_numpy(mx, SEED + 20)
    steps = SSD_FIT_STEPS
    x, y = ssd_train_images(steps * SSD_TRAIN_BATCH, SEED + 22)
    it = mx.io.NDArrayIter(x, y, batch_size=SSD_TRAIN_BATCH,
                           label_name="label")  # on gpu(0)
    mod = mx.mod.Module(ssd_train_symbol(mx), data_names=("data",),
                        label_names=("label",))  # on gpu(0)
    arg_nd = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()}
    kernels = launch_counters()
    plain_calls = count_plain_calls(torch, kernel_modules())
    per_step, last = [], {}
    sources = batch_sources(torch, x, y, SSD_TRAIN_BATCH)
    timer, read_on = fit_timer(torch, steps, sources)

    def on_batch(param):
        now = {k: c.value for k, c in kernels.items()}
        per_step.append({k: v - last.get(k, 0) for k, v in now.items()})
        last.update(now)
        timer(param)

    # the main path (device prefetch on, the default): every count at 0
    # just before, read just after
    tm.reset()
    for k in plain_calls:
        plain_calls[k] = 0
    mod.fit(it, num_epoch=1, eval_metric=mx.metric.Loss(name="ssd_loss"),
            optimizer="sgd", optimizer_params=SSD_TRAIN_OPT,
            arg_params=arg_nd, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in kernels.items()}
    batches = tm.counter("fit.batches").value
    builds = sgd_mom_multi.PACK_BUILDS.value
    plain = dict(plain_calls)
    fit_s = time.perf_counter() - t0

    per_plan = dict(SSD_TRAIN_LAUNCHES,
                    nms=ssd_nms_launches(SSD_TRAIN_BATCH))
    want = {k: per_plan.get(k, 0) for k in kernels}
    bad = [i for i, st in enumerate(per_step) if st != want]
    if bad or batches != steps or len(per_step) != steps:
        fail(f"SSD training launches: steps {bad} of {len(per_step)} off, "
             f"first {per_step[bad[0]] if bad else None}; expected per step "
             f"{per_plan} over {steps} steps, {batches} counted")
    if any(plain.values()):
        fail(f"plain versions ran on the card's main path: {plain}")
    if builds != 1:
        fail(f"the update kernel's launch parameters were packed {builds} "
             f"times over {steps} steps")
    exe = mod._exec_group._exec
    if exe.arg_dict["conv4_3_weight"].context != mx.gpu(0):
        fail("Module.fit did not train SSD on gpu(0)")
    outs = mod.get_outputs()
    shapes = [o.shape for o in outs]
    want_shapes = [(SSD_TRAIN_BATCH, SSD_CLASSES + 1, SSD_ANCHORS),
                   (SSD_TRAIN_BATCH, 4 * SSD_ANCHORS),
                   (SSD_TRAIN_BATCH, SSD_ANCHORS),
                   (SSD_TRAIN_BATCH, SSD_ANCHORS, 6)]
    finite = all(bool(torch.isfinite(o._data).all()) for o in outs)
    if shapes != want_shapes or not finite:
        fail(f"SSD training outputs {shapes} finite {finite}; expected "
             f"{want_shapes}")
    print(f"[ssd-training] SSD-300 Module.fit on {mx.current_context()}: "
          f"{batches} steps at batch {SSD_TRAIN_BATCH} in {fit_s:.1f} s "
          f"(binding, cuDNN's choices and first launches included); "
          f"launches exactly {per_plan} per step, totals "
          f"{ {k: v for k, v in launches.items() if v} }; no plain version "
          f"ran; the update's launch parameters packed once; outputs "
          f"{shapes}, finite",
          flush=True)
    on = read_on()

    def fit(prefetch, callback=None):
        with device_prefetch(prefetch):
            m = mx.mod.Module(ssd_train_symbol(mx), data_names=("data",),
                              label_names=("label",))
            it.reset()
            m.fit(it, num_epoch=1,
                  eval_metric=mx.metric.Loss(name="ssd_loss"),
                  optimizer="sgd", optimizer_params=SSD_TRAIN_OPT,
                  arg_params=arg_nd, batch_end_callback=callback)
        return m

    timer, read_off = fit_timer(torch, steps, sources)
    fit(False, timer)
    off = read_off()
    del sources
    split = prefetch_report("ssd-training", card, SSD_TRAIN_BATCH,
                            x[0].nbytes * SSD_TRAIN_BATCH, on, off,
                            copy_ms(torch, x[:SSD_TRAIN_BATCH]))
    prefetch_check(torch, "ssd-training", steps, on, off, fit,
                   {"param": SSD_PARITY_TOL["param"][1]})

    # the loss check: steps on one fixed batch of SSD_LOSS_BATCH
    curve = ssd_loss_curve(torch, mx, mx.gpu(0), SEED + 30)
    ratios = {"ce": curve[-1][0] / curve[0][0],
              "loc": curve[-1][1] / curve[0][1]}
    if not all(math.isfinite(v) and v <= SSD_LOSS_RATIO[k]
               for k, v in ratios.items()):
        fail(f"SSD loss check: last/first {ratios} over {curve}; limits "
             f"{SSD_LOSS_RATIO}")
    print(f"[ssd-training] loss check, {SSD_LOSS_STEPS} steps on one batch "
          f"of {SSD_LOSS_BATCH}: (cross-entropy, loc loss) "
          f"{[(round(c, 4), round(lo, 4)) for c, lo in curve]}; last/first "
          f"{ {k: round(v, 4) for k, v in ratios.items()} } (limits "
          f"{SSD_LOSS_RATIO})", flush=True)

    # the compute step alone (a batch already on the card, no input
    # pipeline, no metric): CUDA events around a few steps after one
    # warm-up step
    it.reset()
    batch = next(iter(it))

    def step():
        mod.forward_backward(batch)
        mod.update()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - w0) / reps * 1e3
    step_ms = start.elapsed_time(end) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[ssd-training] SSD-300 compute step (forward_backward + update "
          f"on a batch on the card) at batch {SSD_TRAIN_BATCH} on {card}: "
          f"{step_ms:.2f} ms per step by CUDA events "
          f"({SSD_TRAIN_BATCH * 1e3 / step_ms:.1f} images/s); host wall "
          f"{wall_ms:.2f} ms per step; peak device memory {peak:.2f} GiB; "
          f"fit per step minus the compute step: prefetch on "
          f"{split['on']['fit_ms'] - step_ms:.2f} ms, off "
          f"{split['off']['fit_ms'] - step_ms:.2f} ms", flush=True)
    device_ms = profile_step(torch, step, tag="ssd-profile",
                             what=f"one SSD-300 training step at batch "
                             f"{SSD_TRAIN_BATCH}")
    return launches, device_ms


def phase_ssd_train_parity(torch, mx):
    """Two SGD steps of SSD-300 at batch 2 on the card and on the port's
    CPU path (plain versions), each from the same state, within
    ``SSD_PARITY_TOL`` in norm, and at most ``SSD_TARGET_LIMIT`` anchors'
    ``cls_target`` apart per step."""
    _sym, args = ssd_numpy(mx, SEED + 40)
    sym = ssd_train_symbol(mx)
    t0 = time.perf_counter()
    sides = {"card": ssd_train_module(mx, sym, args, mx.gpu(0),
                                      SSD_PARITY_BATCH),
             "cpu": ssd_train_module(mx, sym, args, mx.cpu(),
                                     SSD_PARITY_BATCH)}
    res = ssd_parity_run(torch, mx, sides, {"card": np.float32,
                                            "cpu": np.float32}, SEED + 41)
    lines, rels, apart = ssd_parity_lines(res, "card", "cpu")
    bad = [f"step {s + 1} {kind} {rel:.3g} > {SSD_PARITY_TOL[kind][s]}"
           for (s, kind), rel in rels.items()
           if not rel <= SSD_PARITY_TOL[kind][s]]
    bad += [f"step {s + 1}: {n} cls_target values apart > "
            f"{SSD_TARGET_LIMIT}" for s, n in enumerate(apart)
            if n > SSD_TARGET_LIMIT]
    losses = {side: [(float(r["loss"]["ce"][0]), float(r["loss"]["loc"][0]))
                     for r in res[side]] for side in res}
    print(f"[ssd-parity] two SGD steps of SSD-300 at batch "
          f"{SSD_PARITY_BATCH}, card against the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s): losses (ce, loc) "
          f"{losses['card']} vs {losses['cpu']}; cls_target apart per step "
          f"{apart} (limit {SSD_TARGET_LIMIT}); tolerances {SSD_PARITY_TOL}",
          flush=True)
    for line in lines:
        print(f"[ssd-parity]   {line}")
    if bad:
        fail(f"SSD training parity: card and CPU differ beyond the limits "
             f"in {bad}")


# ---------------------------------------------------------------------------
# DCGAN (examples/train_dcgan.py's defaults, which are the reference MXNet
# example/gan/dcgan.py's): GANModule over models.dcgan_generator(ngf=64,
# nc=3) and models.dcgan_discriminator(ndf=64), batch 64, latents (100, 1,
# 1), 64x64x3 images, init.Normal(0.02), Adam lr 2e-4 beta1 0.5 for both
# networks, float32 with TF32 off, over the example's synthetic reals
# (rand * 2 - 1)
# ---------------------------------------------------------------------------
DCGAN_BATCH = 64
DCGAN_Z = 100
DCGAN_NF = 64
DCGAN_OPT = {"learning_rate": 0.0002, "beta1": 0.5}
DCGAN_EPS = 1e-5 + 1e-12  # models/dcgan.py's BatchNorm eps
DCGAN_SLOPE = 0.2
DCGAN_K = 4  # steps per window: the example's --window
DCGAN_WARMUP = 2  # windows before the timed ones
DCGAN_WINDOWS = 10  # timed windows
DCGAN_SERIAL_WINDOWS = 5  # windows of the serial loop, timed the same way
# the BatchNorm inputs at batch 64: D's three (each BatchNorm ->
# LeakyReLU(0.2), 3 passes forward and backward per step) and G's four
# (BatchNorm -> ReLU, one pass)
DCGAN_D_BN = [(64, 128, 16, 16), (64, 256, 8, 8), (64, 512, 4, 4)]
DCGAN_G_BN = [(64, 512, 4, 4), (64, 256, 8, 8), (64, 128, 16, 16),
              (64, 64, 32, 32)]
# launches per GANModule step: G 4 BatchNorms once, D 3 BatchNorms in 3
# passes; bn_act_bwd launches once per call at every DCGAN shape (the block
# regime, G's (64, 64, 32, 32) a 3-block cluster); the leaky launches count
# under bn_act/bn_act_bwd too; one Adam per network
DCGAN_LAUNCHES = {"bn_stats": 13, "bn_act": 13, "bn_act_leaky": 9,
                  "bn_act_bwd": 13, "bn_act_bwd_leaky": 9, "adam_multi": 2}
LEAKY_COUNTERS = {"bn_act_leaky": ("bn_act", "LEAKY_LAUNCHES"),
                  "bn_act_bwd_leaky": ("bn_act_bwd", "LEAKY_LAUNCHES")}
# the leaky routes' CUDA function names (they count under bn_act's and
# bn_act_bwd's marks too, as their launches do)
LEAKY_MARKS = {"bn_act_leaky": "bn_act_leaky_kernel",
               "bn_act_bwd_leaky": "bn_bwd_leaky_"}
# the loss check: DCGAN_LOSS_STEPS GANModule steps on one fixed batch of
# DCGAN_LOSS_BATCH reals, with latents drawn by numpy from the seed, must
# bring D's logistic loss on that batch (its real-pass output, read before
# each step's update) to at most DCGAN_LOSS_RATIO of its first value.
# Fixed from ``--cpu-dcgan`` on the card machine's CPU before any card ran
# the phase: over the parameter seeds SEED + 60, 61, 62 the last/first
# ratios read 0.0274, 0.0535 and 0.0271 (D wins the first steps on these
# synthetic reals; the curves fall in one or two steps and then wander
# between 0.01 and 0.14). The card starts from SEED + 60's numpy state, so
# it should read near 0.0274; the limit leaves room for the other seeds'
# spread and for the wandering
DCGAN_LOSS_BATCH = 16
DCGAN_LOSS_STEPS = 10
DCGAN_LOSS_RATIO = 0.2
# card against the port's CPU path, two GANModule steps at batch 8 from
# the same weights, latents and reals, in norm over all tensors of a kind
# after each step, |card - cpu| <= rtol * |cpu| (after step 1, after step
# 2); and what share of the weights' first updates may take the other
# sign. Adam's first step moves a weight by about +-lr whatever its
# gradient's size, so a gradient near 0 whose sign differs moves that
# weight 2 * lr apart, and the second step's gradients then differ through
# those weights. Fixed from ``--cpu-dcgan`` on the card machine's CPU
# before any card ran the phase: the port's CPU path in float32 against
# float64 read, after steps 1 and 2, parameters 6.1e-5 / 2.7e-4, BatchNorm
# statistics 7.6e-8 / 1.4e-5, Adam means 1.7e-4 / 2.6e-2, Adam variances
# 4.1e-5 / 1.9e-2, outputs 3.0e-7 / 2.2e-6, and 137 of 6342272 first
# updates of another sign. The card sums in other orders and cuDNN picks
# other algorithms, so each limit sits 15-100x above its reading; the sign
# limit is 6000 of those 6342272 weights, kept as a share so that a narrow
# run applies it too. The faults of DCGAN_FAULTS, planted in the leaky
# route's plain versions, must each break a limit (``--cpu-dcgan`` at full
# width, tests/test_torch_parity_limits.py at ngf = ndf = 8): a wrong
# slope, in both directions or in the backward only, down to 0.201 for
# 0.2, and the backward's mask without its slope; a 0.2002 shows only at
# full width
DCGAN_PARITY_BATCH = 8
DCGAN_PARITY_TOL = {"param": (1e-3, 3e-3), "aux": (1e-4, 1e-3),
                    "adam_mean": (1e-2, 0.25), "adam_var": (1e-2, 0.25),
                    "output": (1e-4, 1e-3)}
DCGAN_FLIP_SHARE = 6000 / 6342272
DCGAN_FAULTS = ("slope 0.25", "backward slope 0.25", "backward slope 0.201",
                "backward slope dropped")
# a finer fault that ``--cpu-dcgan`` also reads: at full width it breaks
# the step-1 Adam limits and the sign limit, at ngf = ndf = 8 none
DCGAN_FAULT_FINE = "backward slope 0.2002"


def facc(label, pred):
    """The example's metric: D's accuracy at threshold 0.5."""
    pred = pred.ravel()
    label = label.ravel()
    return ((pred > 0.5) == label).mean()


def dcgan_numpy(mx, seed):
    """``((g_args, g_aux), (d_args, d_aux))`` as numpy from ``seed``, as
    ``init.Normal(0.02)`` makes them: weights N(0, 0.02), gamma 1, beta 0,
    moving mean 0, moving variance 1."""
    rng = np.random.RandomState(seed)
    nf, z = DCGAN_NF, DCGAN_Z
    out = []
    for sym, shapes in (
            (mx.models.dcgan_generator(ngf=nf, nc=3), {"rand": (1, z, 1, 1)}),
            (mx.models.dcgan_discriminator(ndf=nf),
             {"data": (1, 3, 64, 64), "label": (1,)})):
        arg_shapes, _out, aux_shapes = sym.infer_shape(**shapes)
        args = {}
        for n, s in zip(sym.list_arguments(), arg_shapes):
            if n in shapes:
                continue
            if n.endswith("_gamma"):
                args[n] = np.ones(s, np.float32)
            elif n.endswith("_beta"):
                args[n] = np.zeros(s, np.float32)
            else:
                args[n] = (0.02 * rng.standard_normal(s)).astype(np.float32)
        auxs = {n: (np.ones if n.endswith("_var") else np.zeros)(
            s, np.float32) for n, s in zip(sym.list_auxiliary_states(),
                                          aux_shapes)}
        out.append((args, auxs))
    return tuple(out)


def dcgan_module(mx, ctx, batch, params, dtype=np.float32):
    """A bound ``GANModule`` on ``ctx`` at ``batch`` holding ``params``
    (cast to ``dtype``), with Adam as ``DCGAN_OPT`` for both networks."""
    from mxnet_tpu_torch.convert import gan_params_from_numpy

    nf, z = DCGAN_NF, DCGAN_Z
    gan = mx.mod.GANModule(
        mx.models.dcgan_generator(ngf=nf, nc=3),
        mx.models.dcgan_discriminator(ndf=nf), context=ctx,
        batch_size=batch, code_shape=(z, 1, 1), data_shape=(3, 64, 64))
    gan.mod_g.bind(data_shapes=[mx.io.DataDesc("rand", (batch, z, 1, 1),
                                               dtype)])
    gan.mod_d.bind(data_shapes=[mx.io.DataDesc("data", (batch, 3, 64, 64),
                                               dtype)],
                   label_shapes=[mx.io.DataDesc("label", (batch,), dtype)],
                   inputs_need_grad=True)
    gan_params_from_numpy(gan, *[tuple({k: v.astype(dtype) for k, v in
                                        d.items()} for d in p)
                                 for p in params])
    gan.init_optimizer(optimizer="adam", optimizer_params=DCGAN_OPT)
    return gan


def dcgan_reals(n, batch, seed):
    """``n`` batches of the example's synthetic reals (``rand * 2 - 1``)."""
    rs = np.random.RandomState(seed)
    return [rs.rand(batch, 3, 64, 64).astype(np.float32) * 2 - 1
            for _ in range(n)]


def dcgan_latents(n, batch, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((batch, DCGAN_Z, 1, 1)).astype(np.float32)
            for _ in range(n)]


def dcgan_loss(out):
    """D's logistic loss on the real batch from its real-pass output."""
    p = out.asnumpy().astype(np.float64)
    return float(np.mean(-np.log(np.maximum(p, 1e-12))))


def dcgan_loss_curve(mx, ctx, seed):
    """D's logistic loss on one fixed batch over ``DCGAN_LOSS_STEPS``
    steps (parameters, reals and latents from ``seed``)."""
    gan = dcgan_module(mx, ctx, DCGAN_LOSS_BATCH, dcgan_numpy(mx, seed))
    real = mx.nd.array(dcgan_reals(1, DCGAN_LOSS_BATCH, seed + 1)[0],
                       ctx=ctx)
    lats = dcgan_latents(DCGAN_LOSS_STEPS, DCGAN_LOSS_BATCH, seed + 2)
    return [dcgan_loss(gan.train_window(real, latents=[z]).outputs[0])
            for z in lats]


def dcgan_state(gan):
    """After a step: the kinds of ``DCGAN_PARITY_TOL`` as float64 numpy
    arrays by name."""
    st = {"param": {}, "aux": {}, "adam_mean": {}, "adam_var": {}}
    for tag, mod in (("g", gan.mod_g), ("d", gan.mod_d)):
        arg, aux = mod.get_params()
        for n, v in arg.items():
            st["param"][f"{tag}.{n}"] = v.asnumpy().astype(np.float64)
        for n, v in aux.items():
            st["aux"][f"{tag}.{n}"] = v.asnumpy().astype(np.float64)
        names = mod._exec_group.param_names
        for i, (mean, var) in mod._updater.states.items():
            st["adam_mean"][f"{tag}.{names[i]}"] = \
                mean.asnumpy().astype(np.float64)
            st["adam_var"][f"{tag}.{names[i]}"] = \
                var.asnumpy().astype(np.float64)
    return st


def dcgan_parity_run(mx, sides, seed):
    """Two ``train_window`` steps of each side (name -> GANModule) at
    ``DCGAN_PARITY_BATCH`` on the same reals and latents from ``seed``.
    Returns ``{name: [state after step 1, after step 2]}``, each state with
    the step's published ``output``, and the initial parameters."""
    reals = dcgan_reals(2, DCGAN_PARITY_BATCH, seed)
    lats = dcgan_latents(2, DCGAN_PARITY_BATCH, seed + 1)
    init = dcgan_state(next(iter(sides.values())))["param"]
    res = {}
    for name, gan in sides.items():
        ctx = gan.mod_g._context[0]
        res[name] = []
        for real, z in zip(reals, lats):
            b = gan.train_window(mx.nd.array(real, ctx=ctx), latents=[z])
            st = dcgan_state(gan)
            st["output"] = {"d_real": b.outputs[0].asnumpy().astype(
                np.float64)}
            res[name].append(st)
    return res, init


def dcgan_parity_lines(res, init, got, want):
    """``(lines, {(step, kind): relative difference}, first-step weights
    whose update took the other sign, weights)`` of side ``got`` against
    side ``want``."""
    lines, rels = [], {}
    for s in range(2):
        for kind in ("param", "aux", "adam_mean", "adam_var", "output"):
            rel, worst, worst_rel = parity_diff(res[got][s][kind],
                                                res[want][s][kind])
            rels[(s, kind)] = rel
            lines.append(f"step {s + 1} {kind}: |{got} - {want}| / |{want}| "
                         f"= {rel:.3g}; worst tensor {worst} {worst_rel:.3g}")
    flips = total = 0
    for n, w0 in init.items():
        a = np.sign(res[got][0]["param"][n] - w0)
        b = np.sign(res[want][0]["param"][n] - w0)
        flips += int((a != b).sum())
        total += w0.size
    return lines, rels, flips, total


@contextlib.contextmanager
def dcgan_fault(fault):
    """While open, the port's plain ``bn_act``/``bn_act_bwd`` (the CPU
    side of a parity run) carry ``fault`` in their leaky route (slope > 0):
    ``"slope s"`` puts the slope s in place of the model's in both
    directions, ``"backward slope s"`` in the backward only, and
    ``"backward slope dropped"`` gives the backward the ReLU's mask."""
    from mxnet_tpu_torch.kernels import bn_act as ba, bn_act_bwd as bb

    fwd, bwd = ba.bn_act_plain, bb.bn_act_bwd_plain
    words = fault.split()
    b_slope = 0.0 if words[-1] == "dropped" else float(words[-1])
    f_slope = b_slope if words[0] == "slope" else None

    def fwd_fault(x, mean, var, gamma, beta, eps, fix_gamma, slope=None):
        if slope and f_slope is not None:
            slope = f_slope
        return fwd(x, mean, var, gamma, beta, eps, fix_gamma, slope)

    def bwd_fault(dy, y, x, mean, var, gamma, kvar, eps, fix_gamma,
                  slope=None):
        return bwd(dy, y, x, mean, var, gamma, kvar, eps, fix_gamma,
                   b_slope if slope else slope)

    ba.bn_act_plain, bb.bn_act_bwd_plain = fwd_fault, bwd_fault
    try:
        yield
    finally:
        ba.bn_act_plain, bb.bn_act_bwd_plain = fwd, bwd


def dcgan_parity_breaches(rels, flips, total):
    """The limits of ``DCGAN_PARITY_TOL`` and ``DCGAN_FLIP_SHARE`` that the
    readings of ``dcgan_parity_lines`` break (empty when none)."""
    bad = [f"step {s + 1} {kind} {rel:.3g} > {DCGAN_PARITY_TOL[kind][s]}"
           for (s, kind), rel in rels.items()
           if not rel <= DCGAN_PARITY_TOL[kind][s]]
    if flips > DCGAN_FLIP_SHARE * total:
        bad.append(f"{flips} first-step updates of another sign > "
                   f"{DCGAN_FLIP_SHARE} x {total}")
    return bad


def dcgan_fault_run(mx, params, want, init, fault):
    """Two parity steps of a CPU ``GANModule`` under ``fault`` against the
    correct CPU run ``want`` (``dcgan_parity_run``'s result and initial
    parameters): ``(readings, limits broken)``."""
    with dcgan_fault(fault):
        got, _init = dcgan_parity_run(mx, {"fault": dcgan_module(
            mx, mx.cpu(), DCGAN_PARITY_BATCH, params)}, SEED + 71)
    res = {"fault": got["fault"], "cpu": want["cpu"]}
    _lines, rels, flips, total = dcgan_parity_lines(res, init, "fault", "cpu")
    readings = {f"step {s + 1} {kind}": rel for (s, kind), rel in
                rels.items()}
    readings["flips"] = flips
    readings["weights"] = total
    return readings, dcgan_parity_breaches(rels, flips, total)


def dcgan_cpu_readings(seeds=(0, 1, 2)):
    """The readings ``DCGAN_LOSS_RATIO``, ``DCGAN_PARITY_TOL`` and
    ``DCGAN_FLIP_SHARE`` were fixed from, made before any card ran the
    DCGAN phases, on the port's CPU path at full width: the loss check's
    curve for each seed offset, and the two parity steps in float32
    against float64. Needs no card."""
    import torch

    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    for k in seeds:
        curve = dcgan_loss_curve(mx, mx.cpu(), SEED + 60 + k)
        print(f"[dcgan-cpu] loss check, seed SEED + {60 + k}: D's logistic "
              f"loss on the fixed batch {curve[0]:.4f} -> {curve[-1]:.4f} "
              f"({curve[-1] / curve[0]:.4f}); curve "
              f"{[round(v, 4) for v in curve]}", flush=True)
    params = dcgan_numpy(mx, SEED + 70)
    sides = {n: dcgan_module(mx, mx.cpu(), DCGAN_PARITY_BATCH, params, d)
             for n, d in (("cpu", np.float32), ("cpu64", np.float64))}
    res, init = dcgan_parity_run(mx, sides, SEED + 71)
    lines, _rels, flips, total = dcgan_parity_lines(res, init, "cpu",
                                                    "cpu64")
    for line in lines:
        print(f"[dcgan-cpu] {line}")
    print(f"[dcgan-cpu] first-step updates of another sign, float32 vs "
          f"float64: {flips} of {total} weights "
          f"({torch.get_num_threads()} threads, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    # the limits against planted faults of the leaky route: the float32
    # CPU path with the fault against the one without
    for fault in DCGAN_FAULTS + (DCGAN_FAULT_FINE,):
        readings, bad = dcgan_fault_run(mx, params, res, init, fault)
        print(f"[dcgan-cpu] fault {fault!r}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in readings.items())
              + f"; {'caught by ' + '; '.join(bad) if bad else 'NOT CAUGHT'}",
              flush=True)


def bn_leaky_inputs(torch, gen, dev, shape, edge=False):
    """x, moving mean and variance, gamma, beta and a head gradient for a
    BatchNorm input of ``shape``; with ``edge`` channel 0 holds exact
    zeros of both signs with mean 0 and beta -0.0 (pre-activations exactly
    +0.0 and -0.0) and channel 1 is constant at its mean."""
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev)
    mean = 0.1 * torch.randn(c, generator=gen, device=dev)
    var = 0.5 + torch.rand(c, generator=gen, device=dev)
    gamma = 0.5 + torch.rand(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    if edge:
        x0 = x[:, 0].reshape(-1)
        x0[0::3] = 0.0
        x0[1::3] = -0.0
        x[:, 0] = x0.reshape(x[:, 0].shape)
        x[:, 1] = 0.75
        mean[0], beta[0], mean[1] = 0.0, -0.0, 0.75
    return dict(x=x, mean=mean, var=var, gamma=gamma, beta=beta,
                dy=torch.randn(shape, generator=gen, device=dev))


def phase_dcgan_kernels(torch, mx):
    """``bn_act`` and ``bn_act_bwd`` with the LeakyReLU slope 0.2 at D's
    three BatchNorm shapes at batch 64, and with slope 0 at G's four,
    against their plain versions, plus edge inputs (pre-activations
    exactly +-0.0, a constant channel); ``bn_stats`` at all seven shapes
    and ``adam_multi`` over G's and D's parameters as the GANModule step
    calls them, against their plain versions; per D shape the kernel by
    CUDA events, the plain version, the PyTorch library calls and the
    bound. Returns the leaky rows of the kernels line and each kernel's
    largest error here."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.kernels import (
        adam_multi as am, bn_act as ba, bn_act_bwd as bb, bn_stats as bs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    errs = {0.0: [0.0, 0.0], DCGAN_SLOPE: [0.0, 0.0]}  # (fwd, dx)
    cases = [(s, DCGAN_SLOPE, False) for s in DCGAN_D_BN] + \
        [(s, 0.0, False) for s in DCGAN_G_BN] + \
        [(DCGAN_D_BN[0], DCGAN_SLOPE, True), (DCGAN_G_BN[0], 0.0, True),
         ((3, 5, 7, 9), DCGAN_SLOPE, True)]
    for shape, slope, edge in cases:
        t = bn_leaky_inputs(torch, gen, dev, shape, edge)
        what = f"slope {slope} {shape}{' edge' if edge else ''}"
        # over given statistics (fix_gamma, as models/dcgan.py)
        args = (t["x"], t["mean"], t["var"], t["gamma"], t["beta"],
                DCGAN_EPS, True, slope)
        got, want = ba.bn_act(*args), ba.bn_act_plain(*args)
        errs[slope][0] = max(errs[slope][0], check(
            torch, f"bn_act {what}", got, want, BN_RTOL, BN_ATOL))
        pre = ba.bn_act_plain(*args[:7])  # no activation
        if edge:
            signs = torch.signbit(pre[pre == 0])
            if not (signs.any() and not signs.all()):
                fail(f"bn_act {what}: the edge inputs lack a +0.0 or a -0.0 "
                     f"pre-activation")
            # the slope keeps each zero's sign
            if slope and not (
                    torch.equal(torch.signbit(want[pre == 0]), signs)
                    and torch.equal(torch.signbit(got[pre == 0]), signs)):
                fail(f"bn_act {what}: signed zeros differ from the plain "
                     f"version's")
        if not slope and torch.signbit(got[pre < 0]).any():
            fail(f"bn_act {what}: the ReLU gave -0.0 for a negative input")
        # the training forward: bn_stats, then bn_act with the batch stats
        mm, mv = t["mean"].clone(), t["var"].clone()
        mean, var, kvar = bs.bn_stats(t["x"], mm, mv, 0.9)
        y = ba.bn_act(t["x"], mean, var, t["gamma"], t["beta"], DCGAN_EPS,
                      True, slope)
        mean_p, var_p, _kvar_p = bs.bn_stats_plain(
            t["x"], t["mean"].clone(), t["var"].clone(), 0.9)
        y_p = ba.bn_act_plain(t["x"], mean_p, var_p, t["gamma"], t["beta"],
                              DCGAN_EPS, True, slope)
        errs[slope][0] = max(errs[slope][0], check(
            torch, f"training forward {what}", y, y_p, FWD_RTOL, FWD_ATOL))
        # the backward over the kernel's own forward (bn_stats is held
        # against its plain version, kvar exactly, below)
        bargs = (t["dy"], y, t["x"], mean, var, t["gamma"], kvar, DCGAN_EPS,
                 True, slope)
        got, want = bb.bn_act_bwd(*bargs), bb.bn_act_bwd_plain(*bargs)
        errs[slope][1] = max(errs[slope][1], check(
            torch, f"bn_act_bwd {what} dx", got[0], want[0], DX_RTOL,
            DX_ATOL))
        n = math.prod(shape) // shape[1]
        check(torch, f"bn_act_bwd {what} dbeta", got[2], want[2], DX_RTOL,
              n * 2.0 ** -24)
        t.clear()
    print(f"[dcgan-kernels] bn_act and bn_act_bwd with slope {DCGAN_SLOPE} "
          f"at D's {DCGAN_D_BN} and slope 0 at G's {DCGAN_G_BN}, plus edge "
          f"inputs (pre-activations exactly +0.0 and -0.0, a constant "
          f"channel), match their plain versions: bn_act max abs err "
          f"{errs[DCGAN_SLOPE][0]:g} (leaky) / {errs[0.0][0]:g} (ReLU) "
          f"(rtol {BN_RTOL}, atol {BN_ATOL}; the training forward rtol "
          f"{FWD_RTOL}, atol {FWD_ATOL}); bn_act_bwd dx "
          f"{errs[DCGAN_SLOPE][1]:g} / {errs[0.0][1]:g} (rtol {DX_RTOL}, "
          f"atol {DX_ATOL}); signed zeros as the plain version's", flush=True)

    # --- bn_stats at the seven BatchNorm shapes (G's 4x4 plane included),
    # as phase 2 holds it at ResNet's
    st_err = 0.0
    for shape in DCGAN_D_BN + DCGAN_G_BN:
        for offset in (0.0, 30.0):
            c = shape[1]
            x = torch.randn(shape, generator=gen, device=dev) + offset
            mm = 0.1 * torch.randn(c, generator=gen, device=dev)
            mv = 0.5 + torch.rand(c, generator=gen, device=dev)
            mm2, mv2, anchor = mm.clone(), mv.clone(), mm.clone()
            got = bs.bn_stats(x, mm, mv, 0.9)
            want = bs.bn_stats_plain(x, mm2, mv2, 0.9)
            cancel = 8 * 2.0 ** -23 * float(
                (want[0] - anchor).abs().max()) ** 2
            what = f"bn_stats {shape} offset {offset}"
            st_err = max(st_err,
                         check(torch, what + " mean", got[0], want[0],
                               STAT_RTOL, STAT_ATOL),
                         check(torch, what + " var", got[1], want[1],
                               STAT_RTOL, STAT_ATOL + cancel),
                         check(torch, what + " moving_mean", mm, mm2,
                               STAT_RTOL, STAT_ATOL),
                         check(torch, what + " moving_var", mv, mv2,
                               STAT_RTOL, STAT_ATOL + cancel))
            if not offset and not torch.equal(got[2], want[2]):
                fail(f"{what}: the clamp derivative kvar differs")
    print(f"[dcgan-kernels] bn_stats matches its plain version at D's and "
          f"G's {len(DCGAN_D_BN + DCGAN_G_BN)} shapes x anchor offsets 0 "
          f"and 30: max abs err {st_err:g} (rtol {STAT_RTOL}, atol "
          f"{STAT_ATOL} + 8*2^-23*dmean^2 on the variance), kvar exactly",
          flush=True)

    # --- adam_multi over each network's parameters, as Module.update calls
    # it: states from 0, DCGAN_OPT's rate and beta1, no wd, no clip,
    # rescale_grad 1/batch, steps t = 1 and 2
    opt = mx.optimizer.Adam(**DCGAN_OPT)
    ad_err, numel = 0.0, 0
    for net, (args, _auxs) in zip("GD", dcgan_numpy(mx, SEED + 51)):
        shapes = [a.shape for a in args.values()]
        numel += sum(math.prod(s) for s in shapes)
        ws_ = [torch.from_numpy(a).to(dev) for a in args.values()]
        ms = [torch.zeros(s, device=dev) for s in shapes]
        vs = [torch.zeros(s, device=dev) for s in shapes]
        ref = [[t.clone() for t in x] for x in (ws_, ms, vs)]
        for step in (1, 2):
            gs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
            lrs = [opt.lr_t(DCGAN_OPT["learning_rate"], step)] * len(shapes)
            wds = [0.0] * len(shapes)
            am.adam_multi(ws_, gs, ms, vs, lrs, wds, opt.beta1, opt.beta2,
                          opt.epsilon, 1 / DCGAN_BATCH, -1.0)
            am.adam_multi_plain(ref[0], gs, ref[1], ref[2], lrs, wds,
                                opt.beta1, opt.beta2, opt.epsilon,
                                1 / DCGAN_BATCH, -1.0)
        for kind, got, want in (("weight", ws_, ref[0]), ("mean", ms, ref[1]),
                                ("variance", vs, ref[2])):
            for name, g, w in zip(args, got, want):
                ad_err = max(ad_err, check(
                    torch, f"adam_multi {net} {name} {kind}", g, w,
                    LSTM_RTOL, LSTM_ATOL))
    print(f"[dcgan-kernels] adam_multi matches its plain version over G's "
          f"and D's parameters ({numel / 1e6:.2f} M values, one call per "
          f"network), beta1 {opt.beta1}, steps 1 and 2 from zero states: "
          f"max abs err {ad_err:g} on weights and both states (rtol "
          f"{LSTM_RTOL}, atol {LSTM_ATOL})", flush=True)

    # --- timing at D's shapes: one D pass's three launches
    T = []
    for shape in DCGAN_D_BN:
        t = bn_leaky_inputs(torch, gen, dev, shape)
        mean, var, kvar = bs.bn_stats(t["x"], t["mean"].clone(),
                                      t["var"].clone(), 0.9)
        t.update(bmean=mean, bvar=var, kvar=kvar,
                 invstd=torch.rsqrt(var + DCGAN_EPS))
        t["y"] = ba.bn_act(t["x"], mean, var, t["gamma"], t["beta"],
                           DCGAN_EPS, True, DCGAN_SLOPE)
        T.append(t)

    def each(fn):
        def run():
            for t in T:
                fn(t)
        return run

    def fwd(t):
        return ba.bn_act(t["x"], t["bmean"], t["bvar"], t["gamma"],
                         t["beta"], DCGAN_EPS, True, DCGAN_SLOPE)

    def fwd_plain(t):
        return ba.bn_act_plain(t["x"], t["bmean"], t["bvar"], t["gamma"],
                               t["beta"], DCGAN_EPS, True, DCGAN_SLOPE)

    def fwd_lib(t):
        return F.leaky_relu(F.batch_norm(
            t["x"], t["bmean"], t["bvar"], t["gamma"], t["beta"],
            training=False, eps=DCGAN_EPS), DCGAN_SLOPE, inplace=True)

    def bwd(t):
        return bb.bn_act_bwd(t["dy"], t["y"], t["x"], t["bmean"], t["bvar"],
                             t["gamma"], t["kvar"], DCGAN_EPS, True,
                             DCGAN_SLOPE)

    def bwd_plain(t):
        return bb.bn_act_bwd_plain(t["dy"], t["y"], t["x"], t["bmean"],
                                   t["bvar"], t["gamma"], t["kvar"],
                                   DCGAN_EPS, True, DCGAN_SLOPE)

    def bwd_lib(t):
        dyp = torch.ops.aten.leaky_relu_backward(t["dy"], t["y"],
                                                 DCGAN_SLOPE, True)
        return torch.ops.aten.native_batch_norm_backward(
            dyp, t["x"], t["gamma"], None, None, t["bmean"], t["invstd"],
            True, DCGAN_EPS, [True, True, True])

    def device_ms(fn, mark, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and mark in ev.key)
        return us / reps / 1e3

    n_el = sum(math.prod(s) for s in DCGAN_D_BN)
    c_sum = sum(s[1] for s in DCGAN_D_BN)
    rows = []
    for name, k, p, lib, nbytes, flops, lib_name in (
            ("bn_act_leaky", fwd, fwd_plain, fwd_lib,
             n_el * 8 + c_sum * 16, 6 * n_el, "F.batch_norm + F.leaky_relu"),
            ("bn_act_bwd_leaky", bwd, bwd_plain, bwd_lib,
             n_el * 16 + c_sum * 24, 13 * n_el,
             "native_batch_norm_backward + leaky_relu_backward")):
        k_ms = cuda_ms(torch, each(k), reps=20)
        p_ms = cuda_ms(torch, each(p), reps=5)
        lib_ms = cuda_ms(torch, each(lib), reps=20)
        pass_ms = device_ms(each(k), LEAKY_MARKS[name])
        b_ms, b_by = bound(nbytes, flops)
        per_shape = []
        for t in T:
            one = cuda_ms(torch, lambda t=t: k(t), reps=20)
            per_shape.append(f"{tuple(t['x'].shape)} {one:.4f}")
        print(f"[dcgan-kernels] {name} per D pass (3 launches"
              f", {nbytes / 1e6:.2f} MB "
              f"one-pass): kernel {k_ms:.4f} ms (by shape: "
              f"{'; '.join(per_shape)}), device {pass_ms:.4f} ms in a loop "
              f"over these three tensors, plain {p_ms:.4f} ms, {lib_name} "
              f"{lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "mxnet_tpu_torch/csrc/" + (
                         "bn_act_bwd.cu" if "bwd" in name else "bn_act.cu"),
                     "replaces": "mxnet_tpu/ops/defs_nn.py:" + (
                         "380" if "bwd" in name else "394") + "+336",
                     "max_abs_err": errs[DCGAN_SLOPE][1 if "bwd" in name
                                                      else 0],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "d_pass_loop_device_ms": pass_ms})
    T.clear()
    return rows, {"bn_act": errs[0.0][0], "bn_act_bwd": errs[0.0][1],
                  "bn_stats": st_err, "adam_multi": ad_err}


def phase_dcgan_training(torch, mx, card):
    """DCGAN trained by ``GANModule.train_window`` at full width on the
    card: ``DCGAN_WARMUP`` windows of ``DCGAN_K`` steps, then
    ``DCGAN_WINDOWS`` timed ones over the example's synthetic reals, the
    metric read ``depth = 2`` windows behind as the example does; every
    window's launches exactly ``DCGAN_K`` x ``DCGAN_LAUNCHES`` and no plain
    version on data; the metric finite; the loss check; ms per step by the
    host's clock and by CUDA events, peak memory, a profile of one step,
    the serial loop's rate and the generator's inference rate."""
    from collections import deque

    from mxnet_tpu_torch import telemetry as tm

    t0 = time.perf_counter()
    b, k = DCGAN_BATCH, DCGAN_K
    n_win = DCGAN_WARMUP + DCGAN_WINDOWS
    gan = dcgan_module(mx, mx.gpu(0), b, dcgan_numpy(mx, SEED + 52))
    reals = [mx.nd.array(r) for r in dcgan_reals(n_win * k, b, SEED + 53)]
    metric = mx.metric.CustomMetric(facc)
    ones = mx.nd.ones((b,))
    kernels = launch_counters()
    plain_calls = count_plain_calls(torch, kernel_modules())
    per_window, last = [], {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()

    # the main path: every count at 0 just before, read just after
    tm.reset()
    for c in plain_calls:
        plain_calls[c] = 0
    inflight = deque()
    for w in range(n_win):
        if w == DCGAN_WARMUP:
            while inflight:
                metric.update([ones], inflight.popleft().outputs)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start.record()
        boundary = gan.train_window(None, batches=reals[w * k:(w + 1) * k])
        now = {n: c.value for n, c in kernels.items()}
        per_window.append({n: v - last.get(n, 0) for n, v in now.items()})
        last.update(now)
        inflight.append(boundary)
        while len(inflight) >= 2:
            metric.update([ones], inflight.popleft().outputs)
    end.record()
    while inflight:
        metric.update([ones], inflight.popleft().outputs)
    torch.cuda.synchronize()
    h1 = time.perf_counter()
    launches = {n: c.value for n, c in kernels.items()}
    plain = dict(plain_calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _name, acc = metric.get()

    want = {n: k * DCGAN_LAUNCHES.get(n, 0) for n in kernels}
    bad = [i for i, st in enumerate(per_window) if st != want]
    if bad:
        fail(f"DCGAN launches: windows {bad} of {len(per_window)} off, "
             f"first {per_window[bad[0]]}; expected per window {want}")
    if any(plain.values()):
        fail(f"plain versions ran on the card's DCGAN path: {plain}")
    if not math.isfinite(acc):
        fail(f"DCGAN: D's real accuracy is {acc}")
    exe = gan.mod_d._exec_group._exec
    if exe.arg_dict["d2_weight"].context != mx.gpu(0):
        fail("GANModule did not train on gpu(0)")
    steps = DCGAN_WINDOWS * k
    host_ms = (h1 - h0) / steps * 1e3
    event_ms = start.elapsed_time(end) / steps
    print(f"[dcgan-training] GANModule.train_window on {card}: "
          f"{n_win} windows of {k} steps at batch {b} "
          f"({time.perf_counter() - t0:.1f} s with binding); launches "
          f"exactly {k} x {DCGAN_LAUNCHES} per window, totals "
          f"{ {n: v for n, v in launches.items() if v} }; no plain version "
          f"ran; D's real-acc (CustomMetric(facc)) {acc:.4f}", flush=True)
    print(f"[dcgan-training] timed windows {DCGAN_WARMUP + 1}..{n_win} "
          f"({steps} steps): {host_ms:.3f} ms per step by the host's clock, "
          f"card drained at both ends ({b * 1e3 / host_ms:.1f} samples/s); "
          f"{event_ms:.3f} ms per step by CUDA events; peak device memory "
          f"{peak:.2f} GiB", flush=True)

    # the same windows without the metric: each read of a boundary's
    # outputs is a copy on the card's stream, so it also waits for the
    # window dispatched after that boundary
    torch.cuda.synchronize()
    f0 = time.perf_counter()
    for w in range(DCGAN_WARMUP, n_win):
        boundary = gan.train_window(None, batches=reals[w * k:(w + 1) * k])
    boundary.wait()
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - f0) / steps * 1e3
    print(f"[dcgan-training] the same {DCGAN_WINDOWS} windows without the "
          f"metric's reads: {free_ms:.3f} ms per step "
          f"({b * 1e3 / free_ms:.1f} samples/s)", flush=True)

    # the serial loop (the example's --legacy) on the same steps
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for w in range(DCGAN_SERIAL_WINDOWS):
        gan._serial_window(reals[w * k:(w + 1) * k], None)
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - s0) / (DCGAN_SERIAL_WINDOWS * k) * 1e3
    print(f"[dcgan-training] the serial loop (_serial_window, the "
          f"example's --legacy) on {DCGAN_SERIAL_WINDOWS * k} steps: "
          f"{serial_ms:.3f} ms per step ({b * 1e3 / serial_ms:.1f} "
          f"samples/s)", flush=True)

    # generation: Module(g_sym).forward(is_train=False) at batch 64
    from mxnet_tpu_torch.kernels import bn_act as ba

    imod = mx.mod.Module(mx.models.dcgan_generator(ngf=DCGAN_NF, nc=3),
                         data_names=("rand",), label_names=None)
    imod.bind(data_shapes=[mx.io.DataDesc("rand", (b, DCGAN_Z, 1, 1))],
              for_training=False)
    imod.set_params(*gan.mod_g.get_params())
    noise = mx.nd.random_normal(loc=0, scale=1, shape=(b, DCGAN_Z, 1, 1))
    batch = mx.io.DataBatch(data=[noise], label=[])
    imod.forward(batch, is_train=False)
    torch.cuda.synchronize()
    before = ba.LAUNCHES.value
    iters = 20
    g0 = time.perf_counter()
    for _ in range(iters):
        imod.forward(batch, is_train=False)
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - g0) / iters * 1e3
    img = imod.get_outputs()[0]
    per_fwd = (ba.LAUNCHES.value - before) / iters
    ok = (img.shape == (b, 3, 64, 64) and bool(torch.isfinite(
        img._data).all()) and float(img._data.abs().max()) <= 1.0)
    if not ok or per_fwd != len(DCGAN_G_BN):
        fail(f"DCGAN generation: shape {img.shape}, finite in [-1, 1] {ok}, "
             f"bn_act launches per forward {per_fwd} (expected "
             f"{len(DCGAN_G_BN)})")
    print(f"[dcgan-training] generation (Module(g_sym).forward(is_train="
          f"False)) at batch {b}: {infer_ms:.3f} ms per forward "
          f"({b * 1e3 / infer_ms:.1f} samples/s), {per_fwd:g} bn_act "
          f"launches per forward, images in [-1, 1]", flush=True)

    # the loss check
    curve = dcgan_loss_curve(mx, mx.gpu(0), SEED + 60)
    ratio = curve[-1] / curve[0]
    if not (math.isfinite(ratio) and ratio <= DCGAN_LOSS_RATIO):
        fail(f"DCGAN loss check: last/first {ratio} over {curve}; limit "
             f"{DCGAN_LOSS_RATIO}")
    print(f"[dcgan-training] loss check, {DCGAN_LOSS_STEPS} steps on one "
          f"batch of {DCGAN_LOSS_BATCH}: D's logistic loss "
          f"{[round(v, 4) for v in curve]}; last/first {ratio:.4f} (limit "
          f"{DCGAN_LOSS_RATIO})", flush=True)

    device_ms = profile_step(torch, lambda: gan.train_window(reals[0]),
                             reps=4, tag="dcgan-profile",
                             what=f"one GANModule step at batch {b}")
    return launches, device_ms


def phase_dcgan_parity(torch, mx):
    """Two GANModule steps at full width and batch 8 on the card and on
    the port's CPU path from the same weights, latents and reals, within
    ``DCGAN_PARITY_TOL`` in norm and with at most a share
    ``DCGAN_FLIP_SHARE`` of the first-step updates of another sign."""
    t0 = time.perf_counter()
    params = dcgan_numpy(mx, SEED + 70)
    sides = {"card": dcgan_module(mx, mx.gpu(0), DCGAN_PARITY_BATCH, params),
             "cpu": dcgan_module(mx, mx.cpu(), DCGAN_PARITY_BATCH, params)}
    res, init = dcgan_parity_run(mx, sides, SEED + 71)
    lines, rels, flips, total = dcgan_parity_lines(res, init, "card", "cpu")
    bad = dcgan_parity_breaches(rels, flips, total)
    print(f"[dcgan-parity] two GANModule steps at batch "
          f"{DCGAN_PARITY_BATCH}, card against the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s): first-step updates of "
          f"another sign {flips} of {total} weights (limit "
          f"{DCGAN_FLIP_SHARE} x {total} = {DCGAN_FLIP_SHARE * total:.0f}); "
          f"tolerances {DCGAN_PARITY_TOL}", flush=True)
    for line in lines:
        print(f"[dcgan-parity]   {line}")
    if bad:
        fail(f"DCGAN parity: card and CPU differ beyond the limits in {bad}")


# bn_act_bwd's planner: elements per block before a cluster splits a
# channel, and elements per thread, tried by ``--bn-bwd-plans``
PLAN_TARGETS = (None, 16384, 12544, 8192, 6272, 4096)  # None: what fits
PLAN_PER_THREAD = (8, 16, 32)


def bn_bwd_plan_sweep(torch, mx):
    """``bn_act_bwd``'s device time under ``torch.profiler`` at every
    ResNet-50 training shape (batch 32, ReLU, batch statistics) and every
    DCGAN BatchNorm shape (batch 64: D's leaky, G's ReLU, fix_gamma), for
    each planner setting of ``PLAN_TARGETS`` x ``PLAN_PER_THREAD`` (each
    plan checked against the plain version), and per setting the ResNet
    step's total (each shape as often as a step runs it) and the D pass's.
    Returns ``{setting: {shape: ms}}``."""
    from mxnet_tpu_torch.kernels import bn_act_bwd as bb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    smem, cluster = bb.device_limits(0)
    counts = {}
    for s in resnet50_shapes(mx, TRAIN_BATCH)[1]:
        counts[s] = counts.get(s, 0) + 1
    cases = [(s, k, 0.0, BN_EPS, False) for s, k in counts.items()]
    cases += [(s, 1, DCGAN_SLOPE, DCGAN_EPS, True) for s in DCGAN_D_BN]
    cases += [(DCGAN_G_BN[-1], 1, 0.0, DCGAN_EPS, True)]
    out = {}
    for shape, _k, slope, eps, fix_gamma in cases:
        t = bn_bwd_inputs(torch, gen, dev, shape, slope)
        args = (t["dy"], t["y"], t["x"], t["mean"], t["var"], t["gamma"],
                t["kvar"], eps, fix_gamma, slope)
        want = bb.bn_act_bwd_plain(*args)
        n, c, hw = shape[0], shape[1], math.prod(shape[2:])
        for target in PLAN_TARGETS:
            for per_thread in PLAN_PER_THREAD:
                key = f"target {target or 'fit'}, {per_thread}/thread"
                p = bb.plan(n, c, hw, smem, cluster,
                            target=target or 1 << 31, per_thread=per_thread)
                outs = (torch.empty_like(t["x"]), torch.empty(c, device=dev),
                        torch.empty(c, device=dev))

                def run(p=p, outs=outs):
                    bb.run_plan(p, *args, *outs)

                run()
                check(torch, f"bn_act_bwd {shape} {key}", outs[0], want[0],
                      DX_RTOL, DX_ATOL)
                out.setdefault(key, {})[shape] = (
                    device_ms(torch, run, ("bn_bwd_",), reps=5),
                    f"{p.regime} k={p.cluster} group={p.group} "
                    f"chunk={p.chunk}")
        del t, want
    for key, by_shape in out.items():
        step = sum(by_shape[s][0] * k for s, k in counts.items())
        dpass = sum(by_shape[s][0] for s in DCGAN_D_BN)
        print(f"[bn-bwd-plans] {key}: ResNet step {step:.4f} ms, D pass "
              f"{dpass:.4f} ms; by shape " + "; ".join(
                  f"{s} {ms:.4f} ({what})" for s, (ms, what) in
                  by_shape.items()), flush=True)
    return out


STATS_TARGETS = (16384, 32768, 65536, 131072, 262144)
STATS_PER_THREAD = (16, 32, 64)


def bn_stats_plan_sweep(torch, mx):
    """``bn_stats``' device time under ``torch.profiler`` at every
    ResNet-50 training shape (batch 32) and every DCGAN BatchNorm shape
    (batch 64), for each planner setting of ``STATS_TARGETS`` x
    ``STATS_PER_THREAD`` (each plan's mean checked against the plain
    version), and per setting a ResNet step's total (each shape as often as
    a step runs it) and a DCGAN step's (D's three shapes three times, G's
    four once). Returns ``{setting: {shape: ms}}``."""
    from mxnet_tpu_torch.kernels import bn_stats as bs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 54)
    cluster = bs.device_limits(0)
    resnet, dcgan = {}, {}
    for s in resnet50_shapes(mx, TRAIN_BATCH)[1]:
        resnet[s] = resnet.get(s, 0) + 1
    for s in DCGAN_D_BN * 3 + DCGAN_G_BN:
        dcgan[s] = dcgan.get(s, 0) + 1
    out = {}
    for shape in dict.fromkeys(list(resnet) + list(dcgan)):
        c = shape[1]
        x = torch.randn(shape, generator=gen, device=dev)
        mm, mv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        want = bs.bn_stats_plain(x, mm.clone(), mv.clone(), 0.9)
        n, hw = shape[0], math.prod(shape[2:])
        for target in STATS_TARGETS:
            for per_thread in STATS_PER_THREAD:
                key = f"target {target}, {per_thread}/thread"
                p = bs.plan(n, c, hw, cluster, target, per_thread)
                res = torch.empty(3, c, device=dev)

                def run(p=p, res=res, x=x):
                    bs.run_plan(p, x, mm.clone(), mv.clone(), 0.9, res)

                run()
                check(torch, f"bn_stats {shape} {key}", res[0], want[0],
                      STAT_RTOL, STAT_ATOL)
                out.setdefault(key, {})[shape] = (
                    device_ms(torch, run, ("bn_stats_kernel",), reps=5),
                    f"{p.regime} k={p.cluster} cpb={p.channels_per_block} "
                    f"group={p.group} chunk={p.chunk}")
        del x
    for key, by_shape in out.items():
        step = sum(by_shape[s][0] * k for s, k in resnet.items())
        gan = sum(by_shape[s][0] * k for s, k in dcgan.items())
        print(f"[bn-stats-plans] {key}: ResNet step {step:.4f} ms, DCGAN "
              f"step {gan:.4f} ms; by shape " + "; ".join(
                  f"{s} {ms:.4f} ({what})" for s, (ms, what) in
                  by_shape.items()), flush=True)
    return out


NMS_ONCHIP = (256, 384, 512, 768, 1024)


def nms_plan_sweep(torch, mx):
    """``nms``'s device time under ``torch.profiler`` by kernel on the SSD
    path's heads (:func:`ssd_nms_heads`) for each L_max of ``NMS_ONCHIP``
    (each plan's rows checked against the default plan's, bit for bit).
    Returns ``{onchip: {path: {kernel: ms}}}``."""
    from mxnet_tpu_torch.kernels import nms

    heads = ssd_nms_heads(torch, mx)
    smem = nms.device_limits(0)
    out = {}
    for path, (boxes, score, cls_id, order, thr, nms_thr) in heads.items():
        ins = (boxes, score, cls_id, order, thr, nms_thr, False, SSD_CLASSES)
        want = nms.nms(*ins)
        for onchip in NMS_ONCHIP:
            p = nms.plan(*score.shape, SSD_CLASSES, False, smem, onchip)

            def run(p=p):
                return nms.run_plan(p, *ins)

            if not torch.equal(run(), want):
                fail(f"nms at L_max {onchip} on the {path} head differs")
            split = kernel_split(torch, run, NMS_MARKS)
            out.setdefault(onchip, {})[path] = split
            print(f"[nms-plans] L_max {onchip}, {path} "
                  f"{tuple(score.shape)}: device {sum(split.values()):.4f} "
                  f"ms (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                      split.items()) + ")", flush=True)
    return out


def host_breakdown_bn_stats(torch):
    """Host microseconds of each piece of ``bn_stats``' launch path at
    DCGAN's (64, 512, 4, 4), each timed alone over many repetitions: the
    compound check, the (3, C) allocation, its three views, the plan
    lookup, the packed launch with its counter, and the whole wrapper."""
    from mxnet_tpu_torch.kernels import bn_stats as bs

    dev = torch.device("cuda", 0)
    x = torch.randn(DCGAN_D_BN[-1], device=dev)
    c = x.shape[1]
    mm, mv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    res = x.new_empty((3, c))
    f32 = torch.float32
    p = bs.plan_for(x)

    def checks():
        d = x.get_device()
        ok = x.dim() >= 2 and x.dtype is f32 and x.is_contiguous()
        for t in (mm, mv):
            ok = ok and (t.dtype is f32 and t.is_contiguous()
                         and t.get_device() == d and t.shape == (c,))
        return ok

    pieces = {"compound check": checks,
              "allocation (3, C)": lambda: x.new_empty((3, c)),
              "three views (unbind)": res.unbind,
              "plan lookup": lambda: bs._plan_of(x.shape, 0),
              "packed launch + counter (run_plan)":
                  lambda: bs.run_plan(p, x, mm, mv, 0.9, res),
              "the wrapper bn_stats": lambda: bs.bn_stats(x, mm, mv, 0.9)}
    out = {k: host_us(torch, fn, reps=2000) for k, fn in pieces.items()}
    print(f"[redesign-bn-stats] bn_stats' host path at {tuple(x.shape)}, "
          f"us per call: " + "; ".join(f"{k} {v:.2f}" for k, v in
                                        out.items()), flush=True)
    return out


# the l2norm_channel_bwd sweep: the shape whose unseeded test case once
# failed its limit on the card, and the scales it runs at
L2_SWEEP_SHAPE = (2, 3)
L2_SWEEP_SCALES = (1.0, 20.0)


def l2norm_bwd_sweep(torch, seeds):
    """``l2norm_channel_bwd`` and its plain version at ``L2_SWEEP_SHAPE``
    over ``seeds`` (x and g from a ``torch.Generator`` on the card seeded
    with each), each against the same VJP in float64: per scale, how many
    seeds break a limit relative to the values (``BWD_RTOL`` of each value
    plus ``BWD_ATOL`` of the largest, kernel against plain, the limit the
    card test held before) and how many ``bwd_limit``, the worst of them
    under the first,
    and each float32 version's largest distance from float64, absolute and
    relative to the sum of the two terms' magnitudes
    ``|s g| / n + |x| |s sum_c(g x)| / n^3`` (the channel's condition)."""
    from mxnet_tpu_torch.kernels import l2norm_channel as l2

    dev = torch.device("cuda", 0)
    eps = SSD_L2_EPS
    out = {}
    for scale in L2_SWEEP_SCALES:
        breaks, terms_breaks, worst = 0, 0, (0.0, None)
        far = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn(L2_SWEEP_SHAPE, generator=gen, device=dev)
            g = torch.randn(L2_SWEEP_SHAPE, generator=gen, device=dev)
            got = l2.l2norm_channel_bwd(x, g, eps, scale)
            plain = l2.l2norm_channel_bwd_plain(x, g, eps, scale)
            xd, gd = x.double(), g.double()
            ref = l2.l2norm_channel_bwd_plain(xd, gd, eps, scale)
            norm = torch.sqrt((xd * xd).sum(1, keepdim=True) + eps)
            terms = (scale * gd).abs() / norm + xd.abs() * (
                scale * (gd * xd).sum(1, keepdim=True)).abs() / norm ** 3
            limit = l2.BWD_RTOL * plain.abs() + l2.BWD_ATOL * float(
                plain.abs().max())
            over = float(((got - plain).abs() / limit).max())
            if over > 1:
                breaks += 1
            if not bool(((got - plain).abs() <= l2.bwd_limit(
                    x, g, eps, scale, plain)).all()):
                terms_breaks += 1
            if over > worst[0]:
                worst = (over, seed)
            for name, v in (("kernel", got), ("plain", plain)):
                d = (v.double() - ref).abs()
                far[name][0] = max(far[name][0], float(d.max()))
                far[name][1] = max(far[name][1], float((d / terms).max()))
        out[scale] = {"seeds": len(seeds), "breaks": breaks,
                      "bwd_limit_breaks": terms_breaks,
                      "worst_seed": worst[1], "worst_over_limit": worst[0],
                      "kernel_from_f64": far["kernel"],
                      "plain_from_f64": far["plain"]}
        print(f"[l2norm-sweep] l2norm_channel_bwd at {L2_SWEEP_SHAPE} scale "
              f"{scale}, {len(seeds)} seeds: {breaks} break a limit relative "
              f"to the values (|kernel - plain| <= {l2.BWD_RTOL}|plain| + "
              f"{l2.BWD_ATOL} max|plain|), {terms_breaks} the limit relative "
              f"to the terms (bwd_limit); worst seed {worst[1]} at {worst[0]:.3g}x the "
              f"limit; from float64: kernel {far['kernel'][0]:.3g} abs, "
              f"{far['kernel'][1]:.3g} of the terms; plain "
              f"{far['plain'][0]:.3g} abs, {far['plain'][1]:.3g} of the "
              f"terms", flush=True)
        seed = worst[1]
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn(L2_SWEEP_SHAPE, generator=gen, device=dev)
            g = torch.randn(L2_SWEEP_SHAPE, generator=gen, device=dev)
            ref = l2.l2norm_channel_bwd_plain(x.double(), g.double(), eps,
                                              scale)
            print(f"[l2norm-sweep]   seed {seed}: x {x.tolist()} g "
                  f"{g.tolist()}; kernel "
                  f"{l2.l2norm_channel_bwd(x, g, eps, scale).tolist()}; "
                  f"plain {l2.l2norm_channel_bwd_plain(x, g, eps, scale).tolist()}"
                  f"; float64 {ref.tolist()}", flush=True)
    return out


# --- phase 20: training windows ---------------------------------------------
WINDOW_K = 4  # steps per window of the ResNet-50 and LSTM-PTB checks
WINDOW_FIT_STEPS = 20  # ResNet-50 batches of the fits under windows
WINDOW_DEPTH = 2  # MXNET_DISPATCH_DEPTH of the ResNet-50 fit
WINDOW_NAN_STEP = 1  # the window step (from 0) whose batch holds a NaN
WINDOW_IMAGE = (3, 224, 224)


@contextlib.contextmanager
def env_set(**values):
    """The environment variables ``values`` set for the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms for the block (the same launches
    then give the same bits)."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def device_state(mod):
    """A Module's parameters, aux states and optimizer states as the
    tensors on the card, by name."""
    exe = mod._exec_group._exec
    out = {f"arg:{n}": exe.arg_dict[n]._data for n in mod._param_names
           if n in exe.arg_dict}
    out.update({f"aux:{n}": a._data for n, a in exe.aux_dict.items()})
    for i, st in mod._updater.states.items():
        for j, a in enumerate(st if isinstance(st, tuple) else (st,)):
            if a is not None:
                out[f"state:{i}:{j}"] = a._data
    return out


def states_apart(torch, got, want):
    """The names whose tensors are not bit for bit the same."""
    if got.keys() != want.keys():
        return sorted(set(got) ^ set(want))
    return [k for k, v in want.items() if not torch.equal(got[k], v)]


def reset_module(mx, mod, arg_nd, aux_nd, opt, opt_params):
    """``mod`` back to the given weights with a fresh optimizer (new
    states, counts from 0)."""
    mod.set_params(arg_nd, aux_nd, force_init=True)
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_params,
                       force_init=True)
    return mod


def window_fit(torch, mx, sym, arg_nd, aux_nd, x, y, window):
    """A ResNet-50 ``Module.fit`` over ``x``, ``y`` at ``TRAIN_BATCH``
    with ``MXNET_TRAIN_WINDOW=window`` ('' for the per-batch loop); returns
    the module, the ms per step between the end of the first window (the
    first ``WINDOW_K`` steps) and the last, and the most windows in
    flight."""
    from mxnet_tpu_torch import telemetry as tm

    marks, inflight = {}, [0]
    last = len(x) // TRAIN_BATCH - 1

    def on_batch(param):
        inflight[0] = max(inflight[0], tm.gauge("fit.windows_in_flight").value)
        if param.nbatch in (WINDOW_K - 1, last):
            torch.cuda.synchronize()
            marks[param.nbatch] = time.perf_counter()

    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(sym)
    with env_set(MXNET_TRAIN_WINDOW=window,
                 MXNET_DISPATCH_DEPTH=str(WINDOW_DEPTH)):
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
                arg_params=arg_nd, aux_params=aux_nd,
                batch_end_callback=on_batch)
    torch.cuda.synchronize()
    ms = (marks[last] - marks[WINDOW_K - 1]) * 1e3 / (last - WINDOW_K + 1)
    return mod, ms, inflight[0]


def lstm_chunk(it):
    """A mixed-bucket chunk of ``WINDOW_K`` batches from ``it``: two of
    one bucket around one of another, then a third bucket."""
    by_key = {}
    for batch in it:
        by_key.setdefault(batch.bucket_key, []).append(batch)
        if len(by_key) >= 3 and any(len(v) >= 2 for v in by_key.values()):
            break
    a = next(k for k, v in by_key.items() if len(v) >= 2)
    b, c = [k for k in by_key if k != a][:2]
    return [by_key[a][0], by_key[b][0], by_key[a][1], by_key[c][0]]


def phase_windows(torch, mx, card):
    """Phase 20: training windows (``Module.train_window``,
    ``BucketingModule.train_window``, ``fit`` under
    ``MXNET_TRAIN_WINDOW``). Returns the launches of its main path (the
    window fits of ResNet-50, LSTM-PTB and MNIST) by kernel."""
    from mxnet_tpu_torch import telemetry as tm

    t0 = time.perf_counter()
    sym, args, auxs = resnet50_numpy(mx, SEED)
    cpu = mx.cpu()
    arg_nd = {k: mx.nd.array(v, ctx=cpu) for k, v in args.items()}
    aux_nd = {k: mx.nd.array(v, ctx=cpu) for k, v in auxs.items()}
    rng = np.random.default_rng(SEED + 20)
    n = WINDOW_FIT_STEPS * TRAIN_BATCH
    x = rng.standard_normal((n,) + WINDOW_IMAGE, np.float32)
    y = rng.integers(0, 1000, n).astype(np.float32)
    batches = [mx.io.DataBatch(
        [mx.nd.array(x[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])],
        [mx.nd.array(y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])])
        for i in range(WINDOW_K)]
    counters = launch_counters()
    per_step = resnet_train_launches(mx)
    want = {k: WINDOW_K * v for k, v in per_step.items()}

    def module():
        mod = mx.mod.Module(sym)
        mod.bind(data_shapes=[("data", (TRAIN_BATCH,) + WINDOW_IMAGE)],
                 label_shapes=[("softmax_label", (TRAIN_BATCH,))])
        mod.init_params(arg_params=arg_nd, aux_params=aux_nd)
        mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
        return mod

    def reset(*mods):
        for m in mods:
            reset_module(mx, m, arg_nd, aux_nd, "sgd", TRAIN_OPT)

    def serial(mod, bs):
        for b in bs:
            mod.forward_backward(b)
            mod.update()

    serial_mod, win = module(), module()
    with deterministic_cudnn(torch):
        # four distinct batches: serial steps, a publishing window and a
        # window that publishes no gradients
        serial(serial_mod, batches)
        before = {k: counters[k].value for k in want}
        boundary = win.train_window(None, batches=batches)
        torch.cuda.synchronize()
        got = {k: counters[k].value - before[k] for k in want}
        if got != want:
            fail(f"windows: a window of {WINDOW_K} launched {got}; expected "
                 f"{WINDOW_K} x {per_step}")
        apart = states_apart(torch, device_state(win),
                             device_state(serial_mod))
        if apart or not torch.equal(boundary.outputs[0]._data,
                                    serial_mod.get_outputs()[0]._data):
            fail(f"windows: a window of {WINDOW_K} distinct batches is not "
                 f"bit for bit {WINDOW_K} serial steps: {apart[:5]} apart, "
                 f"or the last outputs")
        grads = boundary.grads()
        if set(grads) != {n for n in win._param_names}:
            fail("windows: the publishing window's gradients are not every "
                 "parameter's")
        published = {k: v.clone() for k, v in device_state(win).items()}
        del boundary, grads
        reset(win)
        lazy = win.train_window(None, batches=batches, publish_grads=False)
        try:
            lazy.grads()
            fail("windows: boundary.grads() after publish_grads=False did "
                 "not raise")
        except mx.MXNetError:
            pass
        apart = states_apart(torch, device_state(win), published)
        if apart:
            fail(f"windows: publish_grads=False trained other weights: "
                 f"{apart[:5]}")
        del lazy, published
        # one batch, four steps
        reset(serial_mod, win)
        serial(serial_mod, batches[:1] * WINDOW_K)
        boundary = win.train_window(batches[0], n_steps=WINDOW_K)
        apart = states_apart(torch, device_state(win),
                             device_state(serial_mod))
        if apart or not torch.equal(boundary.outputs[0]._data,
                                    serial_mod.get_outputs()[0]._data):
            fail(f"windows: train_window(batch, n_steps={WINDOW_K}) is not "
                 f"bit for bit {WINDOW_K} serial steps: {apart[:5]}")
        del boundary
        # the guard: a NaN batch at one step of the window
        bad = [mx.io.DataBatch([b.data[0].copy()], b.label) for b in batches]
        bad[WINDOW_NAN_STEP].data[0]._data[0, 0, 0, 0] = float("nan")
        with env_set(MXNET_NONFINITE_GUARD="skip"):
            reset(serial_mod, win)
            serial(serial_mod, bad)
            win.train_window(None, batches=bad)
            skips = (win.nonfinite_stats(), serial_mod.nonfinite_stats())
        apart = states_apart(torch, device_state(win),
                             device_state(serial_mod))
        moved = not torch.equal(device_state(win)["arg:fc1_weight"],
                                arg_nd["fc1_weight"]._data.to(
                                    win._context[0].torch_device()))
        if skips != ((1, 0), (1, 0)) or apart or not moved:
            fail(f"windows: under MXNET_NONFINITE_GUARD=skip a NaN at step "
                 f"{WINDOW_NAN_STEP + 1} of {WINDOW_K} gave skips (window, "
                 f"serial) {skips}, expected one each; {apart[:5]} apart; "
                 f"weights moved {moved}")
    del serial_mod, win
    print(f"[windows] ResNet-50 at batch {TRAIN_BATCH} on {card}, "
          f"deterministic cuDNN: train_window(batches=[{WINDOW_K} "
          f"batches]) and train_window(batch, n_steps={WINDOW_K}) bit for "
          f"bit {WINDOW_K} serial steps (weights, momenta, BatchNorm "
          f"statistics, the last outputs); launches {want} = {WINDOW_K} x a "
          f"step's; publish_grads=False: grads() raises, the same bits; a "
          f"NaN batch at step {WINDOW_NAN_STEP + 1} under "
          f"MXNET_NONFINITE_GUARD=skip: one skip, the other steps applied "
          f"as the serial loop's ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # fit under MXNET_TRAIN_WINDOW=4, MXNET_DISPATCH_DEPTH=2: the main path
    launches = {}
    with deterministic_cudnn(torch):
        tm.reset()
        fitted, win_ms, inflight = window_fit(torch, mx, sym, arg_nd, aux_nd,
                                              x, y, str(WINDOW_K))
        got = {k: counters[k].value for k in per_step}
        gauges = (tm.gauge("fit.train_window_k").value,
                  tm.gauge("fit.dispatch_depth").value, inflight)
        batches_fit = tm.counter("fit.batches").value
        windows_fit = tm.histogram("fit.window").count
        launches.update(got)
        want_fit = {k: WINDOW_FIT_STEPS * v for k, v in per_step.items()}
        if got != want_fit or batches_fit != WINDOW_FIT_STEPS:
            fail(f"windows: fit launched {got} over {batches_fit} steps; "
                 f"expected {WINDOW_FIT_STEPS} x {per_step}")
        if gauges != (WINDOW_K, WINDOW_DEPTH, WINDOW_DEPTH) or \
                windows_fit != WINDOW_FIT_STEPS // WINDOW_K:
            fail(f"windows: fit's (train_window_k, dispatch_depth, most "
                 f"windows in flight) {gauges}, {windows_fit} windows; "
                 f"expected ({WINDOW_K}, {WINDOW_DEPTH}, {WINDOW_DEPTH})")
        per_batch, batch_ms, _n = window_fit(torch, mx, sym, arg_nd, aux_nd,
                                             x, y, "")
        apart = states_apart(torch, device_state(fitted),
                             device_state(per_batch))
    if apart:
        fail(f"windows: fit under MXNET_TRAIN_WINDOW={WINDOW_K} is not bit "
             f"for bit the per-batch fit: {apart[:5]}")
    del fitted, per_batch
    print(f"[windows] ResNet-50 Module.fit over {WINDOW_FIT_STEPS} batches on "
          f"{card}, deterministic cuDNN, device prefetch on: "
          f"MXNET_TRAIN_WINDOW={WINDOW_K} MXNET_DISPATCH_DEPTH={WINDOW_DEPTH} "
          f"{win_ms:.2f} ms per step against the per-batch fit's "
          f"{batch_ms:.2f} (steps {WINDOW_K + 1}..{WINDOW_FIT_STEPS} by the "
          f"host's clock); fit.train_window_k {gauges[0]}, "
          f"fit.dispatch_depth {gauges[1]}, fit.windows_in_flight at most "
          f"{gauges[2]}, {windows_fit} windows; the weights, momenta and "
          f"statistics bit for bit the per-batch fit's", flush=True)

    # LSTM-PTB: BucketingModule.fit under windows, and one mixed chunk
    t1 = time.perf_counter()
    tm.reset()
    with env_set(MXNET_TRAIN_WINDOW=str(WINDOW_K)):
        it, mod, epochs = lstm_fit(mx, SEED)
    torch.cuda.synchronize()
    got = {k: counters[k].value for k in counters}
    steps = tm.counter("fit.batches").value
    it.reset()
    tokens = LSTM_EPOCHS * sum(b.bucket_key for b in it)
    lstm_want = {"lstm_cell": 2 * tokens, "lstm_cell_bwd": 2 * tokens,
                 "adam_multi": steps, "softmax_rows": steps,
                 "softmax_output_bwd": steps}
    if {k: v for k, v in got.items() if v} != lstm_want:
        fail(f"windows: LSTM fit launched {got}; expected {lstm_want}")
    for k, v in lstm_want.items():
        launches[k] = launches.get(k, 0) + v
    if not (epochs[-1] < PPL_LIMIT and epochs[-1] < epochs[0]):
        fail(f"windows: LSTM Train-Perplexity by epoch {epochs} under "
             f"MXNET_TRAIN_WINDOW={WINDOW_K}; expected the last below "
             f"{PPL_LIMIT} and below the first")
    fit_s = time.perf_counter() - t1
    it.reset()
    chunk = lstm_chunk(it)
    sym_gen, states = mx.models.lstm_lm_sym_gen(**LSTM)
    _sym8, _states, lstm_args = lstm_numpy(mx, SEED + 21)
    lstm_nd = {k: mx.nd.array(v, ctx=cpu) for k, v in lstm_args.items()}

    def bucketing():
        m = mx.mod.BucketingModule(sym_gen,
                                   default_bucket_key=it.default_bucket_key,
                                   state_names=states)
        m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        m.init_params(arg_params=lstm_nd, allow_missing=True)
        m.init_optimizer(optimizer="adam", optimizer_params=LSTM_OPT)
        return m

    keys = [b.bucket_key for b in chunk]
    order = [b for b in chunk if b.bucket_key != keys[-1]]
    order = sorted(order, key=lambda b: keys.index(b.bucket_key)) + \
        [b for b in chunk if b.bucket_key == keys[-1]]
    with deterministic_cudnn(torch):
        ref, win = bucketing(), bucketing()
        for b in order:
            ref.forward_backward(b)
            ref.update()
        boundary = win.train_window(None, batches=chunk)
        torch.cuda.synchronize()
    counts = set(win._curr_module._optimizer._index_update_count.values())
    apart = states_apart(torch, device_state(win._curr_module),
                         device_state(ref._curr_module))
    if apart or counts != {WINDOW_K} or boundary.n_steps != WINDOW_K:
        fail(f"windows: BucketingModule.train_window over buckets {keys} is "
             f"not bit for bit the serial steps in its order "
             f"{[b.bucket_key for b in order]}: {apart[:5]} apart; Adam's "
             f"update counts {counts}, expected {{{WINDOW_K}}}")
    del ref, win, mod, boundary
    print(f"[windows] LSTM-PTB BucketingModule.fit on {card} under "
          f"MXNET_TRAIN_WINDOW={WINDOW_K}: {steps} steps in {fit_s:.1f} s, "
          f"Train-Perplexity by epoch {[round(v, 1) for v in epochs]} "
          f"(limit {PPL_LIMIT}); launches {lstm_want}; one chunk over buckets "
          f"{keys} bit for bit the serial steps in its order "
          f"{[b.bucket_key for b in order]}, Adam's counts +{WINDOW_K}",
          flush=True)

    # MNIST MLP through the launcher under MXNET_TRAIN_WINDOW=auto
    with env_set(MXNET_TRAIN_WINDOW="auto"):
        counts, acc, speeds, secs, costs = run_script(mnist_command("mlp"))
    steps, vals = counts["fit_batches"], counts["score_batches"]
    got = {k: v for k, v in counts["launches"].items() if v}
    mnist_want = {"softmax_rows": steps + vals, "softmax_output_bwd": steps,
                  "sgd_mom_multi": steps}
    floor = MNIST_CPU_ACC["mlp"] - MNIST_ACC_MARGIN
    if counts["jax"] or not steps or got != mnist_want or \
            len(acc) != MNIST_EPOCHS or not acc[-1] >= floor:
        fail(f"windows: train_mnist.py under MXNET_TRAIN_WINDOW=auto: "
             f"launches {got}, expected {mnist_want}; validation accuracy "
             f"{acc}, limit {floor}; jax {counts['jax']}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    print(f"[windows] examples/train_mnist.py --synthetic 1 --network mlp "
          f"under MXNET_TRAIN_WINDOW=auto on {card} in {secs:.1f} s: chosen "
          f"K {counts['train_window_k']}, dispatch depth "
          f"{counts['dispatch_depth']}; validation accuracy by epoch {acc} "
          f"(the CPU path's {MNIST_CPU_ACC['mlp']}, margin "
          f"{MNIST_ACC_MARGIN}); Speedometer samples/s {speeds} (it reads "
          f"where a window ends on a multiple of 20 batches); samples/s by "
          f"epoch {epoch_rates(steps, costs)} (its steps over fit's Time "
          f"cost; phase 19 prints the per-batch loop's); launches {got} over "
          f"{steps} steps and {vals} validation batches; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main():
    if sys.argv[1:2] == ["--cpu-perplexity"]:
        cpu_perplexity([int(a) for a in sys.argv[2:]])
        return
    if sys.argv[1:2] == ["--cpu-ssd"]:
        ssd_cpu_readings()
        return
    if sys.argv[1:2] == ["--cpu-ssd-train"]:
        ssd_train_cpu_readings()
        return
    if sys.argv[1:2] == ["--cpu-dcgan"]:
        dcgan_cpu_readings()
        return
    if sys.argv[1:2] == ["--cpu-baseline"]:
        cpu_baseline()
        return
    if sys.argv[1:2] == ["--kernel-times"]:
        # time the package of another checkout (its root first on the path)
        sys.path[:0] = sys.argv[2:3]
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import mxnet_tpu_torch as mx

    if "jax" in sys.modules or "mxnet_tpu" in sys.modules:
        fail("the port imported jax or mxnet_tpu")
    card = phase_device(torch)
    phase_build()
    if sys.argv[1:2] == ["--bn-bwd-plans"]:
        bn_bwd_plan_sweep(torch, mx)
        return
    if sys.argv[1:2] == ["--nms-plans"]:
        nms_plan_sweep(torch, mx)
        return
    if sys.argv[1:2] == ["--bn-stats-plans"]:
        bn_stats_plan_sweep(torch, mx)
        host_breakdown_bn_stats(torch)
        return
    if sys.argv[1:2] == ["--fit-spread"]:
        fit_spread(torch, mx)
        return
    if sys.argv[1:2] == ["--l2norm-bwd-sweep"]:
        sweep = l2norm_bwd_sweep(torch, range(int(sys.argv[2])))
        print(json.dumps({"l2norm_bwd_sweep": sweep}))
        return
    if sys.argv[1:2] == ["--kernel-times"]:
        print(f"[kernel-times] {mx.__file__}", flush=True)
        times = kernel_times(torch, mx)
        print_kernel_times(times, card, "kernel-times")
        calls = {}
        more = kernel_times_nms_bn_stats(torch, mx,
                                         ssd_nms_heads(torch, mx, calls))
        print_nms_bn_stats_times(more, card, "kernel-times")
        bwd = kernel_times_l2norm_softmax_bwd(torch)
        print_redesign_times(bwd, card, "kernel-times")
        fwd = kernel_times_bn_act_mbt(torch, mx)
        print_redesign_times(fwd, card, "kernel-times")
        l2d = kernel_times_l2norm_decode(torch, path_calls_l2_decode(
            calls["serve"], calls["train"]))
        print_redesign_times(l2d, card, "kernel-times")
        compare_bits(l2d, mx.__file__)
        print(json.dumps({"kernel_times": {**times, **more, **bwd, **fwd,
                                           **l2d}}))
        return
    kernels = phase_kernels(torch)
    trained_kernels, bn_act_err = phase_train_kernels(torch, mx)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], bn_act_err)
    kernels += trained_kernels
    redesign, bn_bwd_err = phase_redesign(torch, mx, card)
    lstm_kernels, head = phase_lstm_kernels(torch, mx)
    kernels += lstm_kernels
    for k in kernels:
        if k["name"] in redesign:
            k["paths"] = redesign[k["name"]]
        if k["name"] == "bn_act_bwd":
            k["max_abs_err"] = max(k["max_abs_err"], bn_bwd_err)
    for k in kernels:
        k.update(head.get(k["name"], {}))
    ssd = ssd_numpy(mx, SEED + 10)
    ssd_rows, serve_head, serve_calls = phase_ssd_kernels(torch, mx, ssd)
    kernels += ssd_rows
    served = phase_serving(torch, mx, card)
    trained, device_ms = phase_training(torch, mx, card)
    phase_train_parity(torch, mx)
    lstm_trained, lstm_device_ms = phase_lstm_training(torch, mx, card)
    phase_lstm_parity(torch, mx)
    ssd_served, ssd_device_ms = phase_ssd_serving(torch, mx, card, ssd)
    ssd_train_rows, ssd_train_extra, train_head, recorded = \
        phase_ssd_train_kernels(torch, mx)
    kernels += ssd_train_rows
    for k in kernels:
        k.update(ssd_train_extra.get(k["name"], {}))
    redesigned, stats_err = phase_redesign_nms_bn_stats(
        torch, mx, card, {"serve": serve_head, "train": train_head})
    for k in kernels:
        if k["name"] in redesigned:
            k["paths"] = redesigned[k["name"]]
        if k["name"] == "bn_stats":
            k["max_abs_err"] = max(k["max_abs_err"], stats_err)
    redesigned_bwd, l2_bwd_err = phase_redesign_l2norm_softmax_bwd(
        torch, mx, card, recorded)
    for k in kernels:
        if k["name"] in redesigned_bwd:
            k["paths"] = redesigned_bwd[k["name"]]
        if k["name"] == "l2norm_channel_bwd":
            k["max_abs_err"] = max(k["max_abs_err"], l2_bwd_err)
    redesigned_fwd, bn_act_plain_err = phase_redesign_bn_act_mbt(
        torch, mx, card, recorded)
    l2_calls = path_calls_l2_decode(serve_calls, recorded)
    del recorded, serve_calls
    for k in kernels:
        if k["name"] in redesigned_fwd:
            k["paths"] = redesigned_fwd[k["name"]]
        if k["name"] == "bn_act":
            k["max_abs_err"] = max(k["max_abs_err"], bn_act_plain_err)
    redesigned_l2d, l2_err, dec_err = phase_redesign_l2norm_decode(
        torch, mx, card, l2_calls)
    del l2_calls
    for k in kernels:
        if k["name"] in redesigned_l2d:
            k["paths"] = redesigned_l2d[k["name"]]
        if k["name"] == "l2norm_channel":
            k["max_abs_err"] = max(k["max_abs_err"], l2_err)
        if k["name"] == "multibox_decode":
            k["max_abs_err"] = max(k["max_abs_err"], dec_err)
    ssd_trained, ssd_train_device_ms = phase_ssd_training(torch, mx, card)
    phase_ssd_train_parity(torch, mx)
    dcgan_rows, dcgan_errs = phase_dcgan_kernels(torch, mx)
    for k in kernels:
        if k["name"] in dcgan_errs:
            k["max_abs_err"] = max(k["max_abs_err"], dcgan_errs[k["name"]])
    kernels += dcgan_rows
    dcgan_trained, dcgan_device_ms = phase_dcgan_training(torch, mx, card)
    phase_dcgan_parity(torch, mx)
    mnist_paths = phase_mnist_kernels(torch, mx)
    baseline = phase_baseline_scripts(torch, mx, card)
    windows = phase_windows(torch, mx, card)
    for k in kernels:
        name = k["name"]
        k["launches_serving"] = served.get(name, 0)
        k["launches_training"] = trained.get(name, 0)
        k["launches_lstm"] = lstm_trained.get(name, 0)
        k["launches_ssd"] = ssd_served.get(name, 0)
        k["launches_ssd_train"] = ssd_trained.get(name, 0)
        k["launches_dcgan"] = dcgan_trained.get(name, 0)
        k["launches_baseline"] = baseline.get(name, 0)
        k["launches_windows"] = windows.get(name, 0)
        if name in mnist_paths:
            k.setdefault("paths", {}).update(mnist_paths[name])
            k["max_abs_err"] = max(k["max_abs_err"], *(
                r["max_abs_err"] for r in mnist_paths[name].values()))
        k["launches"] = (k["launches_serving"] + k["launches_training"]
                         + k["launches_lstm"] + k["launches_ssd"]
                         + k["launches_ssd_train"] + k["launches_dcgan"]
                         + k["launches_baseline"] + k["launches_windows"])
        k["step_device_ms"] = device_ms.get(name)
        k["lstm_step_device_ms"] = lstm_device_ms.get(name)
        k["ssd_forward_device_ms"] = ssd_device_ms.get(name)
        k["ssd_step_device_ms"] = ssd_train_device_ms.get(name)
        k["dcgan_step_device_ms"] = dcgan_device_ms.get(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
