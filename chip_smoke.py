#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

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
   alone, and a ``torch.profiler`` breakdown of one forward by kernel.

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
    launches = phase_serving(torch, mx, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
