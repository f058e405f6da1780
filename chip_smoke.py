#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: ResNet-50
serving and training, LSTM-PTB training, and SSD-VGG16 serving.

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
6. training — full ResNet-50 (random He-normal weights from the seed)
   trained by ``Module.fit`` over an ``NDArrayIter`` of synthetic data on
   ``gpu(0)``, SGD with momentum 0.9, wd 1e-4, ``rescale_grad`` 1/32, at
   batch 32, with the launch counters checked per step (``bn_stats`` 50,
   ``bn_act`` 50, ``bn_act_bwd`` 100, ``softmax_rows`` 1,
   ``softmax_output_bwd`` 1, ``sgd_mom_multi`` 1), and ms per step,
   steps/s and images/s of ``fit``'s own steps after the first by the
   host's clock, with the time spent waiting for the input; 10 steps on
   one fixed batch must lower the training cross-entropy to at most
   ``LOSS_RATIO`` of its first value; then the compute step alone (one
   batch already on the card) by CUDA events, peak memory, and a
   ``torch.profiler`` breakdown of one step by kernel;
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
    batch launching exactly 1 ``multibox_decode``, 2 ``nms`` (mask and
    scan) and 1 ``l2norm_channel`` and no plain version on data; the plain
    NMS on the CPU fed the card's own bucket-8 head tensors gives the
    card's rows bit for bit; every answer against the port's CPU
    ``Predictor`` (scores and boxes within ``SSD_SERVE_TOL`` for every
    anchor, class ids equal where both sides kept the anchor and the best
    class is clear, at most ``SSD_KEEP_LIMIT`` keep decisions apart: near
    ties in the scores may reorder the greedy pass); then ms per batch at
    bucket 8 through the server and for the forward alone, and under
    ``torch.profiler`` the device's busy share and top operations.

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
"""

import json
import math
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
PORT_KERNELS = {"bn_stats": "bn_stats_kernel", "bn_act": "bn_act_kernel",
                "bn_act_bwd": "bn_bwd_", "softmax_rows": "softmax_rows_kernel",
                "softmax_output_bwd": "softmax_output_bwd_kernel",
                "sgd_mom_multi": "sgd_mom_multi_kernel",
                "lstm_cell": "lstm_cell_kernel",
                "lstm_cell_bwd": "lstm_cell_bwd_kernel",
                "adam_multi": "adam_multi_kernel",
                "multibox_decode": "multibox_decode_kernel",
                "nms": "nms_", "l2norm_channel": "l2norm_channel_kernel"}
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

    # --- bn_act: correctness at every path shape, relu and fix_gamma both
    # ways, plus tails where H*W is odd and planes start unaligned
    bn_err = 0.0
    tensors = {}
    shapes = [s for s, _ in PATH_BN] + [(1, 64, 56, 56), (3, 5, 7, 9),
                                        (2, 3, 5, 5), (4, 7, 1, 3)]
    for shape in shapes:
        ins = bn_inputs(shape)
        tensors[shape] = ins
        for relu in (True, False):
            for fix_gamma in (False, True):
                got = bn_act(*ins, BN_EPS, fix_gamma, relu)
                want = bn_act_plain(*ins, BN_EPS, fix_gamma, relu)
                err, ok = max_err(torch, got, want, BN_RTOL, BN_ATOL)
                bn_err = max(bn_err, err)
                if not ok:
                    fail(f"bn_act {shape} relu={relu} fix_gamma={fix_gamma}: "
                         f"max abs err {err:g} over rtol {BN_RTOL} atol "
                         f"{BN_ATOL}")
    print(f"[kernels] bn_act matches its plain version at {len(shapes)} "
          f"shapes x relu x fix_gamma: max abs err {bn_err:g} "
          f"(rtol {BN_RTOL}, atol {BN_ATOL})", flush=True)

    # --- bn_act timing: one forward's 17 launches at batch 32
    def seq(fn):
        def run():
            for shape, mult in PATH_BN:
                x, mean, var, gamma, beta = tensors[shape]
                for _ in range(mult):
                    fn(x, mean, var, gamma, beta)
        return run

    bn_ms = cuda_ms(torch, seq(lambda *t: bn_act(*t, BN_EPS, False, True)))
    bn_plain_ms = cuda_ms(
        torch, seq(lambda *t: bn_act_plain(*t, BN_EPS, False, True)))
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
    sm_err = 0.0
    for shape in (PATH_SOFTMAX, (1, 1000), (7, 1001)):
        x = 4.0 * torch.randn(shape, generator=gen, device=dev)
        got, want = softmax_rows(x), softmax_rows_plain(x)
        err, ok = max_err(torch, got, want, 0.0, SM_ATOL)
        sm_err = max(sm_err, err)
        if not ok:
            fail(f"softmax_rows {shape}: max abs err {err:g} over atol "
                 f"{SM_ATOL}")
    x = 4.0 * torch.randn(PATH_SOFTMAX, generator=gen, device=dev)
    sm_ms = cuda_ms(torch, lambda: softmax_rows(x), reps=100)
    sm_plain_ms = cuda_ms(torch, lambda: softmax_rows_plain(x), reps=100)
    sm_lib_ms = cuda_ms(torch, lambda: torch.softmax(x, dim=1), reps=100)
    n = math.prod(PATH_SOFTMAX)
    sm_bound, sm_by = bound(2 * n * 4, 7 * n)
    print(f"[kernels] softmax_rows matches its plain version at 3 shapes: "
          f"max abs err {sm_err:g} (atol {SM_ATOL}); at {PATH_SOFTMAX}: "
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
    sym = mx.models.resnet.get_symbol(num_classes=1000, num_layers=50,
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
    sym = mx.models.resnet.get_symbol(num_classes=1000, num_layers=50,
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
    err, ok = max_err(torch, got, want, rtol, atol)
    if not ok:
        fail(f"{what}: max abs err {err:g} over rtol {rtol} atol {atol:g}")
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
        y = ba.bn_act(x, mean, var, gamma, beta, BN_EPS, False, True)
        ba_err = max(ba_err, check(
            torch, f"bn_act {s} (training shape)", y,
            ba.bn_act_plain(x, mean, var, gamma, beta, BN_EPS, False, True),
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
    st_lib = cuda_ms(torch, per_step(lambda t: torch.var_mean(
        t["x"], (0, 2, 3), correction=0)), reps=10)
    st_bound, st_by = bound(n_elems * 4, 4 * n_elems)
    n_bn = len(bn_shapes)
    print(f"[train-kernels] bn_stats per step ({n_bn} launches, "
          f"{n_elems * 4 / 1e9:.3f} GB): kernel {st_ms:.4f} ms, plain "
          f"{st_plain:.4f} ms, torch.var_mean {st_lib:.4f} ms, bound "
          f"{st_bound:.4f} ms ({st_by}), {n_elems * 4 / st_ms / 1e9:.2f} TB/s",
          flush=True)

    def fwd_kernel(t):
        mean, var, _k = bs.bn_stats(t["x"], t["mm"], t["mv"], 0.9)
        return ba.bn_act(t["x"], mean, var, t["gamma"], t["beta"], BN_EPS,
                         False, True)

    def fwd_plain(t):
        mean, var, _k = bs.bn_stats_plain(t["x"], t["mm"], t["mv"], 0.9)
        return ba.bn_act_plain(t["x"], mean, var, t["gamma"], t["beta"],
                               BN_EPS, False, True)

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
                BN_EPS, fix_gamma, relu)
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
        BN_EPS, False, True)), reps=10)
    bw_plain = cuda_ms(torch, per_step(lambda t: bb.bn_act_bwd_plain(
        t["dy"], t["y"], t["x"], t["mean"], t["var"], t["gamma"], t["kvar"],
        BN_EPS, False, True)), reps=5)
    bw_lib = cuda_ms(torch, per_step(bwd_lib), reps=10)
    bw_bound, bw_by = bound(n_elems * 16, 12 * n_elems)
    print(f"[train-kernels] bn_act_bwd per step ({2 * n_bn} launches; one-pass "
          f"minimum {n_elems * 16 / 1e9:.3f} GB, the kernels move 28 bytes "
          f"per element): kernel {bw_ms:.4f} ms, plain {bw_plain:.4f} ms, "
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
    builds = sg.TABLE_BUILDS.value
    sg_ms = cuda_ms(torch, lambda: sg.sgd_mom_multi(
        ws, gs, ms, lrs, wds, 0.9, 1 / 32, -1.0, cache=cache), reps=50)
    if sg.TABLE_BUILDS.value != builds + 1:
        fail(f"sgd_mom_multi rebuilt its table "
             f"{sg.TABLE_BUILDS.value - builds} times for unmoved tensors")
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
          f"table built once), plain {sg_plain:.4f} ms, "
          f"torch.optim.SGD(fused=True).step {sg_lib:.4f} ms (other "
          f"semantics, a yardstick), bound {sg_bound:.4f} ms ({sg_by})",
          flush=True)
    return [
        {"name": "bn_stats", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/bn_stats.cu",
         "replaces": "mxnet_tpu/ops/defs_nn.py:425",
         "max_abs_err": st_err, "ms": st_ms, "plain_ms": st_plain,
         "bound_ms": st_bound, "bound_by": st_by, "library_ms": st_lib,
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


def profile_step(torch, step, reps=2):
    """Kernels of one training step by self device time (kernel events
    only), and the device's busy share of the wall time."""
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
        print("[profile] torch.profiler recorded no device time")
        return {}
    print(f"[profile] one training step at batch {TRAIN_BATCH}: device busy "
          f"{busy / 1e3:.2f} ms of {wall_us / reps / 1e3:.2f} ms wall "
          f"({100 * busy * reps / wall_us:.0f}%); top kernels by device time:")
    for us, count, key in sorted(rows, reverse=True)[:14]:
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / busy:5.1f}% "
              f"x{count:<4d} {key[:90]}")
    # the port's kernels: device time per step, apart from the host's
    # launch path that the CUDA-event times above include
    ours = {}
    for us, count, key in rows:
        for kernel, mark in PORT_KERNELS.items():
            if mark in key:
                ms, n = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms + us / 1e3, n + count)
    for kernel, (ms, n) in sorted(ours.items()):
        print(f"[profile]   port kernel {kernel}: {ms:.4f} ms device time in "
              f"{n} launches per step")
    return {k: v[0] for k, v in ours.items()}


def phase_training(torch, mx, card):
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.kernels import (
        bn_act, bn_act_bwd, bn_stats, sgd_mom_multi, softmax_output_bwd,
        softmax_rows)

    t0 = time.perf_counter()
    sym, args, auxs = resnet50_numpy(mx, SEED)
    n_bn = len(resnet50_shapes(mx, TRAIN_BATCH)[1])  # 50 in ResNet-50
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
    per_step = {"bn_stats": n_bn, "bn_act": n_bn, "bn_act_bwd": 2 * n_bn,
                "softmax_rows": 1, "softmax_output_bwd": 1,
                "sgd_mom_multi": 1}

    # fit's own steps after the first, as a user pays for them: the host's
    # copy of each batch to the card, the step, the metric. The card is
    # drained at the end of the first step and of the last.
    marks = {}

    def timer(param):
        if param.nbatch in (0, steps - 1):
            torch.cuda.synchronize()
            marks[param.nbatch] = (time.perf_counter(), tm.histogram(
                "fit.data_wait").sum, tm.histogram("fit.dispatch").sum)

    # the main path: every count at 0 just before, read just after
    tm.reset()
    mod.fit(it, num_epoch=1, eval_metric=["acc", "ce"], optimizer="sgd",
            optimizer_params=TRAIN_OPT, arg_params=arg_nd, aux_params=aux_nd,
            batch_end_callback=timer)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES.value for k, m in kernels.items()}
    batches = tm.counter("fit.batches").value
    builds = sgd_mom_multi.TABLE_BUILDS.value
    if batches != steps or launches != {k: v * steps
                                        for k, v in per_step.items()}:
        fail(f"training launch counters {launches} over {batches} steps; "
             f"expected per step {per_step}")
    if mod._exec_group._exec.arg_dict["conv0_weight"].context != mx.gpu(0):
        fail("Module.fit did not train on gpu(0)")
    if builds != 1:
        fail(f"the update kernel's table was built {builds} times over "
             f"{steps} steps; its weights and momenta never move")
    uploads = sgd_mom_multi.GRAD_UPLOADS.value
    print(f"[training] ResNet-50 Module.fit on {mx.current_context()}: "
          f"{batches} steps at batch {TRAIN_BATCH} in "
          f"{time.perf_counter() - t0:.1f} s (set-up, cuDNN's choices and "
          f"first launches included); launches {launches} = per step "
          f"{per_step}; the update's table built {builds} time(s), the "
          f"gradient pointers uploaded {uploads} time(s)", flush=True)
    timed = steps - 1
    fit_ms = (marks[steps - 1][0] - marks[0][0]) / timed * 1e3
    wait_ms = (marks[steps - 1][1] - marks[0][1]) / timed / 1e3
    dispatch_ms = (marks[steps - 1][2] - marks[0][2]) / timed / 1e3
    print(f"[training] Module.fit at batch {TRAIN_BATCH} on {card}, steps 2.."
          f"{steps} by the host's clock: {fit_ms:.2f} ms per step "
          f"({1e3 / fit_ms:.2f} steps/s, {TRAIN_BATCH * 1e3 / fit_ms:.1f} "
          f"images/s); per step fit.data_wait {wait_ms:.2f} ms (the "
          f"NDArrayIter's batch copied to the card), fit.dispatch "
          f"{dispatch_ms:.2f} ms (forward, backward and update enqueued)",
          flush=True)

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
          f"{wall_ms:.2f} ms per step; peak device memory {peak:.2f} GiB",
          flush=True)
    device_ms = profile_step(torch, step)
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
    sm_err = check(torch, "softmax_rows (1024, 10000)", sr.softmax_rows(x),
                   sr.softmax_rows_plain(x), 0.0, SM_ATOL)
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
          f"max abs err {sm_err:g} (atol {SM_ATOL}), kernel {sm_ms:.4f} ms, "
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
                if name != "lstm_cell_bwd"}
    counters["lstm_cell_bwd"] = K.lstm_cell.BWD_LAUNCHES
    return counters


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
    plain_calls = count_plain_calls(
        torch, [getattr(K, n) for n in PORT_KERNELS if n != "lstm_cell_bwd"])
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


class record_detection:
    """Within the block, keep the inputs and outputs of every
    ``multibox_decode`` and ``nms`` call of the detection step (the tensors
    themselves; nothing is copied or launched)."""

    def __enter__(self):
        from mxnet_tpu_torch.kernels import multibox_decode as dec, nms

        self.mods = [(dec, "multibox_decode", dec.multibox_decode),
                     (nms, "nms", nms.nms)]
        self.calls = {"multibox_decode": [], "nms": []}
        for mod, name, fn in self.mods:
            def rec(*a, _fn=fn, _name=name):
                out = _fn(*a)
                self.calls[_name].append((a, out))
                return out
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.mods:
            setattr(mod, name, fn)


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
    (boxes, score, cls_id, order, thr, nms_thr, force), head_out = rec.calls[
        "nms"][0]
    print(f"[ssd-kernels] SSD-300 head at batch {SSD_BATCH} "
          f"({time.perf_counter() - t0:.1f} s): logits {tuple(logits.shape)} "
          f"strides {logits.stride()}, loc {tuple(loc.shape)}, anchors "
          f"{tuple(anchors.shape)}; threshold {thr}, nms_threshold {nms_thr}",
          flush=True)
    if (logits.shape != (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS)
            or not softmax):
        fail(f"SSD head: logits {tuple(logits.shape)} softmax={softmax}")

    # --- nms: bit for bit on three sets of inputs
    sets = [("SSD-300 head", (boxes, score, cls_id, order), thr,
             [(nms_thr, False), (nms_thr, True)]),
            ("grid boxes, IoU at the threshold",
             nms_grid_inputs(torch, dev, SEED + 12), 0.01,
             [(0.5, False), (0.25, False), (0.5, True)]),
            ("ties, force, an invalid image",
             nms_tie_inputs(torch, dev, SEED + 13), 0.01,
             [(0.5, False), (0.5, True), (0.3, False)])]
    nms_err = 0.0
    for what, ins, t, cases in sets:
        kept = []
        for nt, fs in cases:
            got = nms.nms(*ins, t, nt, fs)
            want = nms.nms_plain(*ins, t, nt, fs)
            torch.cuda.synchronize()
            nms_err = max(nms_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                diff = int((got[..., 0] != want[..., 0]).sum())
                fail(f"nms on {what} (nms_threshold {nt}, force {fs}): "
                     f"{diff} ids/keep decisions differ from the plain "
                     f"version")
            kept.append(keep_count(got))
        if what == "SSD-300 head" and not torch.equal(
                head_out, nms.nms_plain(*ins, t, nms_thr, False)):
            fail("nms in the detection step differs from its plain version")
        print(f"[ssd-kernels] nms equals its plain version bit for bit on "
              f"{what} {tuple(ins[0].shape[:2])}: kept {kept} of "
              f"{ins[1].numel()} for (nms_threshold, force) {cases}",
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
                                            nms_thr, False), reps=20)
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
          f"(mask + scan) {nms_ms:.4f} ms, plain {nms_plain:.1f} ms, "
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
    ]


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
        launches = {n: getattr(K, n).LAUNCHES.value for n in names}
        others = {n: getattr(K, n).LAUNCHES.value for n in PORT_KERNELS
                  if n not in names and n != "lstm_cell_bwd"}
        batches = tm.counter("serving.batches").value
        plain = dict(plain_calls)

        for idx, want in waves:
            got = {buckets[i] for i in idx}
            if got != {want}:
                fail(f"requests {idx} ran in buckets {got}, expected {want}")
        want_launches = {"multibox_decode": batches, "nms": 2 * batches,
                         "l2norm_channel": batches}
        if (batches != len(waves) or launches != want_launches
                or any(others.values()) or any(plain.values())):
            fail(f"SSD launches {launches} (others {others}) over {batches} "
                 f"served batches, plain calls {plain}; expected per batch 1 "
                 f"multibox_decode, 2 nms, 1 l2norm_channel and nothing else")
        print(f"[ssd-serving] {SSD_REQUESTS} requests served in buckets 8, 1 "
              f"({batches} batches): launches {launches} = 1 "
              f"multibox_decode, 2 nms, 1 l2norm_channel per batch; plain "
              f"versions on data {sum(plain.values())}", flush=True)

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


def main():
    if sys.argv[1:2] == ["--cpu-perplexity"]:
        cpu_perplexity([int(a) for a in sys.argv[2:]])
        return
    if sys.argv[1:2] == ["--cpu-ssd"]:
        ssd_cpu_readings()
        return
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import mxnet_tpu_torch as mx

    if "jax" in sys.modules or "mxnet_tpu" in sys.modules:
        fail("the port imported jax or mxnet_tpu")
    card = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    trained_kernels, bn_act_err = phase_train_kernels(torch, mx)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], bn_act_err)
    kernels += trained_kernels
    lstm_kernels, head = phase_lstm_kernels(torch, mx)
    kernels += lstm_kernels
    for k in kernels:
        k.update(head.get(k["name"], {}))
    ssd = ssd_numpy(mx, SEED + 10)
    kernels += phase_ssd_kernels(torch, mx, ssd)
    served = phase_serving(torch, mx, card)
    trained, device_ms = phase_training(torch, mx, card)
    phase_train_parity(torch, mx)
    lstm_trained, lstm_device_ms = phase_lstm_training(torch, mx, card)
    phase_lstm_parity(torch, mx)
    ssd_served, ssd_device_ms = phase_ssd_serving(torch, mx, card, ssd)
    for k in kernels:
        name = k["name"]
        k["launches_serving"] = served.get(name, 0)
        k["launches_training"] = trained.get(name, 0)
        k["launches_lstm"] = lstm_trained.get(name, 0)
        k["launches_ssd"] = ssd_served.get(name, 0)
        k["launches"] = (k["launches_serving"] + k["launches_training"]
                         + k["launches_lstm"] + k["launches_ssd"])
        k["step_device_ms"] = device_ms.get(name)
        k["lstm_step_device_ms"] = lstm_device_ms.get(name)
        k["ssd_forward_device_ms"] = ssd_device_ms.get(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
