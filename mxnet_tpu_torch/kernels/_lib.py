"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface. :func:`build` compiles
each source with its own ``nvcc`` (all started together) for ``sm_90a`` and
links the objects into ``build/mxnet_tpu_torch/libkernels-<digest>.so`` at
the root of the checkout; the digest covers the sources and the flags, so
an edited source never loads a stale library. :func:`library` builds on
first CUDA use and loads the result with ``ctypes``. Nothing here runs at
import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..base import MXNetError

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry -> argtypes; every pointer and the stream pass as c_void_p (a
# packed argument struct too: see launch_packed)
_SIGNATURES = {
    "mxt_bn_act_f32": [_P],
    "mxt_softmax_rows_f32": [_P, _P, _LL, _LL, _P],
    "mxt_bn_stats_caps": [_P, _P],
    "mxt_bn_stats_f32": [_P],
    "mxt_bn_bwd_reduce_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                              _LL, _LL, _I, ctypes.c_float, _I,
                              ctypes.c_float, _P],
    "mxt_bn_bwd_dx_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                          ctypes.c_float, _I, ctypes.c_float, _I, _P],
    "mxt_bn_bwd_caps": [_P, _P],
    "mxt_bn_bwd_onepass_f32": [_P],
    "mxt_softmax_output_bwd_f32": [_P],
    "mxt_sgd_pack_bytes": [],
    "mxt_sgd_probe_f32": [_P, _P, _I, _P],
    "mxt_sgd_mom_multi_f32": [_P, ctypes.c_float, _I, ctypes.c_float,
                              ctypes.c_float, _P, _P, _P],
    "mxt_adam_probe_f32": [_P, _P, _P, _I, _I, _LL, _P, _P],
    "mxt_lstm_cell_f32": [_P],
    "mxt_lstm_cell_bwd_f32": [_P],
    "mxt_gru_cell_f32": [_P],
    "mxt_gru_cell_bwd_f32": [_P],
    "mxt_rnn_cell_f32": [_P],
    "mxt_rnn_cell_bwd_f32": [_P],
    "mxt_rmsprop_multi_f32": [_P],
    "mxt_adam_multi_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _LL]
    + [ctypes.c_float] * 7 + [_P, _P, _P],
    "mxt_l2norm_channel_f32": [_P],
    "mxt_l2norm_channel_bwd_f32": [_P],
    "mxt_multibox_target_f32": [_P],
    "mxt_multibox_decode_f32": [_P],
    "mxt_nms_caps": [_P, _P],
    "mxt_nms_f32": [_P],
    "mxt_dropout": [_P],
}

_lock = threading.Lock()
_lib = None
_tickets = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin and PATH): the CUDA kernels "
                     "cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path():
    """Where :func:`build` puts the library for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def build():
    """Compile and link the kernels unless the library for these sources
    exists. Returns ``(path, compiler log)``; raises :class:`MXNetError`
    with the compiler's output when a source does not build."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, proc in jobs:
            text = proc.communicate()[0]
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise MXNetError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = tmp / out.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _s, o, _p in jobs],
             "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise MXNetError(f"linking {out.name} failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
        return out, "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path, _log = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err, name):
    """Raise when a C entry reported a CUDA error (its cudaGetLastError)."""
    if err != 0:
        raise MXNetError(f"{name}: CUDA error {err} at launch")


def tickets(device, n):
    """A zeroed uint32 buffer of at least ``n`` per-channel tickets on
    ``device``, for the reduction that finishes in its last block
    (bn_act_bwd's two-phase regime). The kernel returns every ticket it
    takes to 0, so the buffer stays zeroed between launches; launches that
    share it run in order on one stream."""
    with _lock:
        buf = _tickets.get(device)
        if buf is None or buf.numel() < n:
            import torch

            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            _tickets[device] = buf
        return buf


def stream_of(t):
    """The raw handle of the current CUDA stream of ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch(t, entry, *args):
    """``entry(*args, stream)`` on the current stream of CUDA tensor
    ``t``'s device, with no ``Stream`` object built: the light launch path.
    The current device changes for the call only when ``t``'s is not
    current. Returns the entry's CUDA error code."""
    import torch

    dev = t.get_device()
    if torch._C._cuda_getDevice() == dev:
        return entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return entry(*args, torch._C._cuda_getCurrentRawStream(dev))


def launch_packed(t, entry, pack, *args):
    """``entry(pack(*args, stream))``: :func:`launch` for a C entry that
    takes its arguments as one struct of 8-byte fields, ``pack`` the
    ``struct.Struct(...).pack`` of that struct (the stream its last field).
    One ctypes argument costs less host time than a dozen."""
    import torch

    dev = t.get_device()
    if torch._C._cuda_getDevice() == dev:
        return entry(pack(*args, torch._C._cuda_getCurrentRawStream(dev)))
    with torch.cuda.device(dev):
        return entry(pack(*args, torch._C._cuda_getCurrentRawStream(dev)))


def magic(d):
    """``(m, s)`` with ``q // d == ((q * m >> 32) + q) >> s`` for every
    ``0 <= q <= 2**31 - 1`` (32-bit unsigned arithmetic): ``s`` the least
    with ``2**s >= d``, ``m = 2**32 * (2**s - d) // d + 1``. The kernels
    that divide an index by a size fixed for the launch take these numbers
    from the host."""
    s = max(0, (d - 1).bit_length())
    return (1 << 32) * ((1 << s) - d) // d + 1, s


def quotient(q, m, s):
    """The kernels' ``q // d`` from :func:`magic`'s ``(m, s)``:
    ``(umulhi(q, m) + q) >> s``."""
    return (((q * m) >> 32) + q) >> s


def c_slope(slope):
    """The activation argument of the BatchNorm kernels' C entries: the
    slope (0 for the ReLU), or -1 for ``slope=None``, no activation."""
    return -1.0 if slope is None else float(slope)


def check_f32(name, t, device, shape=None):
    """Raise unless ``t`` is a contiguous float32 tensor on ``device`` (of
    ``shape`` when given) — what every kernel here takes."""
    import torch

    if (t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != device
            or (shape is not None and tuple(t.shape) != tuple(shape))):
        want = f"{tuple(shape)} " if shape is not None else ""
        raise MXNetError(
            f"{name} must be a contiguous float32 {want}tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"contiguous={t.is_contiguous()}")


def refusal(name, args, device):
    """The :class:`MXNetError` for inputs a kernel does not take, naming
    the first of ``args`` (``(argument, tensor or None, shape)``) that is
    not a contiguous float32 tensor of its shape on ``device``: what a
    wrapper raises after its one compound check failed."""
    import torch

    for arg, t, shape in args:
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != device
                              or t.shape != shape):
            return MXNetError(
                f"{name}: {arg} must be a contiguous float32 {tuple(shape)} "
                f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} contiguous={t.is_contiguous()}")
    return MXNetError(f"{name}: inputs the kernel does not take")
