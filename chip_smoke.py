#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: serving and
training.

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
   momenta as a group of their own; see ``PARITY_TOL``).

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Any failed phase exits non-zero before the result
lines. Without CUDA it exits non-zero at once.
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
                "sgd_mom_multi": "sgd_mom_multi_kernel"}
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


def main():
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
    served = phase_serving(torch, mx, card)
    trained, device_ms = phase_training(torch, mx, card)
    phase_train_parity(torch, mx)
    for k in kernels:
        k["launches_serving"] = served.get(k["name"], 0)
        k["launches_training"] = trained[k["name"]]
        k["launches"] = k["launches_serving"] + k["launches_training"]
        k["step_device_ms"] = device_ms.get(k["name"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
