"""``sgd_mom_multi``: the multi-tensor SGD(-momentum) update with the
non-finite guard.

Replaces the optimizer step inside ``mxnet_tpu/executor.py``
``fused_train_update`` (:1381): ``SGD.jax_apply`` over ``_prep_grad`` and
``_sgd_mom_update`` (``mxnet_tpu/ops/defs_optimizer.py:34-72``) unrolled
over every parameter, and the ``MXNET_NONFINITE_GUARD`` select
(:1606,1614-1652), which XLA fuses into the training step and eager
PyTorch would run as about eight launches per parameter (155 parameters
for ResNet-50). Per parameter, in place, following ``_prep_grad`` exactly::

    g = grad * rescale_grad; g = clip(g, -c, c) if c >= 0; g = g + wd * w
    mom = momentum * mom - lr * g; w = w + mom     (w = w - lr * g without)

Under the guard (a :class:`Guard`) a probe first adds every gradient into
one device scalar; when it is not finite the step writes no weight and no
momentum, copies each restore pair's source over its destination (the
executor passes the BatchNorm statistics as they were before the forward)
and advances the ``[total, consecutive]`` skip counters — all on the
device, with no host synchronisation.

Bound on the H100: device-memory bandwidth, 20 bytes per parameter element
(25.55 M for ResNet-50: 511 MB, 0.153 ms). ``csrc/sgd_mom_multi.cu`` takes
all per-step metadata in its launch parameters: a pack of up to
:data:`CAP` entries (14 KB), each the pointers of a weight, its gradient
and its momentum (or a restore's destination and source), its size, its
``(lr, wd)`` and the cumulative count of :data:`CHUNK`-element chunks
before it. Longer lists take several launches (:func:`plan_launches`).
The gradients are checked on every call, by C-level passes over the
list, as the plain version takes them: float32, contiguous, on the
weights' device, of the weight's shape. The packs live in host memory in
the caller's ``cache`` dict (one per executor); the weights, momenta and
restores are validated and packed only when their identity changes
(:data:`PACK_BUILDS`), and each call rewrites the gradients' pointers
(autograd allocates the gradients anew each step) and, when they change,
the ``(lr, wd)`` pairs. Nothing is copied to the device. The kernel writes
through raw pointers, outside autograd.
"""

from __future__ import annotations

import operator
from operator import attrgetter

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): one per pack, two
# under the guard (probe, update)
LAUNCHES = _tm.counter("kernel.sgd_mom_multi.launches")
# validations and packings of the weights, momenta and restores: one per
# identity change, none per step
PACK_BUILDS = _tm.counter("kernel.sgd_mom_multi.pack_builds")
CHUNK = 4096  # elements per chunk (kChunk in the source)
CAP = 320  # entries per launch (kCap in the source)
_DTYPE = attrgetter("dtype")
_SHAPE = attrgetter("shape")
_F32 = {torch.float32}


class Guard:
    """Device state of the non-finite guard: ``counters`` is the int32
    ``[total, consecutive]`` skip count, ``restores`` the ``(dst, src)``
    tensor pairs copied back on a skipped step."""

    def __init__(self, counters, restores=()):
        self.counters = counters
        self.restores = list(restores)
        self.probe = None  # scratch of the CUDA probe


def prep_grad(grad, weight, lr, wd, rescale_grad, clip_gradient):
    """``_prep_grad`` of the reference: rescale, clip, then ``+ wd * w``
    outside the clip."""
    g = grad * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_step_plain(w, g, m, lr, wd, momentum, rescale_grad, clip_gradient):
    """New ``(w, mom)`` of one parameter (``mom`` None without momentum)."""
    g = prep_grad(g, w, lr, wd, rescale_grad, clip_gradient)
    if m is None:
        return w - lr * g, None
    m = momentum * m - lr * g
    return w + m, m


def sgd_mom_multi_plain(weights, grads, moms, lrs, wds, momentum,
                        rescale_grad, clip_gradient, guard=None):
    """The plain PyTorch version: one parameter after the other; the guard
    selects with tensor ops, so it never reads a value on the host."""
    finite = None
    if guard is not None:
        probe = torch.zeros((), dtype=torch.float32,
                            device=guard.counters.device)
        for g in grads:
            probe = probe + g.to(torch.float32).sum()
        finite = torch.isfinite(probe)
    for i, (w, g) in enumerate(zip(weights, grads)):
        m = moms[i] if moms is not None else None
        nw, nm = sgd_step_plain(w, g, m, lrs[i], wds[i], momentum,
                                rescale_grad, clip_gradient)
        if finite is not None:
            nw = torch.where(finite, nw, w)
            nm = torch.where(finite, nm, m) if m is not None else None
        w.copy_(nw)
        if m is not None:
            m.copy_(nm)
    if guard is not None:
        for dst, src in guard.restores:
            dst.copy_(torch.where(finite, dst, src))
        miss = (~finite).to(torch.int32)
        c = guard.counters
        c.copy_(torch.stack([c[0] + miss, (c[1] + miss) * miss]))


def pack_layout(cap=CAP):
    """``(offsets, nbytes)`` of the C ``Pack`` of ``cap`` entries: byte
    offsets of the int64 rows ``p0, p1, p2, numel`` (one block of
    ``4 * cap``), the float32 rows ``lr, wd`` and the int32
    ``first[cap + 1], n_update, n_entries``; ``nbytes`` is the struct's
    size (8-byte aligned)."""
    ints = 40 * cap
    end = ints + 4 * (cap + 3)
    return {"ptrs": 0, "hyper": 32 * cap, "ints": ints}, (end + 7) // 8 * 8


def plan_launches(sizes, n_update, cap=CAP, chunk=CHUNK):
    """Cut entries of ``sizes`` (the ``n_update`` update tensors first, then
    the restores) into launches of at most ``cap`` entries. Returns one
    ``(lo, hi, first)`` per launch: entries ``[lo, hi)`` and the cumulative
    chunk counts ``first`` (``hi - lo + 1`` of them, from 0), each entry
    taking ``ceil(size / chunk)`` chunks."""
    plans = []
    for lo in range(0, len(sizes), cap):
        hi = min(lo + cap, len(sizes))
        first = [0]
        for size in sizes[lo:hi]:
            first.append(first[-1] + -(-int(size) // chunk))
        if first[-1] >= 2 ** 31:
            raise MXNetError(f"sgd_mom_multi: {first[-1]} chunks in one "
                             "launch exceed its int32 counts")
        plans.append((lo, hi, first))
    return plans


class _Pack:
    """One launch's parameters in host memory (the C ``Pack``)."""

    def __init__(self, lo, hi, first, n_update):
        cap = CAP
        offsets, nbytes = pack_layout(cap)
        self.lo, self.hi = lo, hi
        self.buf = np.zeros(nbytes, np.uint8)
        self.ptrs = self.buf[:32 * cap].view(np.int64).reshape(4, cap)
        self.hyper = self.buf[offsets["hyper"]:offsets["ints"]].view(
            np.float32).reshape(2, cap)
        ints = self.buf[offsets["ints"]:offsets["ints"] + 4 * (cap + 3)].view(
            np.int32)
        ints[:len(first)] = first
        self.n_update = max(0, min(hi, n_update) - lo)  # updates in [lo, hi)
        ints[cap + 1] = self.n_update
        ints[cap + 2] = hi - lo
        self.address = self.buf.ctypes.data


def _validate(weights, moms, restores, dev):
    for i, w in enumerate(weights):
        _lib.check_f32(f"sgd_mom_multi: weights[{i}]", w, dev)
        if moms is not None:
            _lib.check_f32(f"sgd_mom_multi: moms[{i}]", moms[i], dev, w.shape)
    for dst, src in restores:
        _lib.check_f32("sgd_mom_multi: restore target", dst, dev)
        _lib.check_f32("sgd_mom_multi: restore source", src, dev, dst.shape)


def _packs(weights, moms, restores, dev, cache):
    """The launch packs for these weights, momenta and restores: validated
    and built only when one of them changed identity (another tensor, or
    the same tensor over other memory)."""
    wptrs = list(map(torch.Tensor.data_ptr, weights))
    mptrs = (list(map(torch.Tensor.data_ptr, moms)) if moms is not None
             else None)
    rkey = [(d.data_ptr(), s.data_ptr(), d.numel()) for d, s in restores]
    same = cache.get("wptrs") == wptrs and cache.get("mptrs") == mptrs \
        and cache.get("rkey") == rkey \
        and all(map(operator.is_, weights, cache["weights"])) \
        and (moms is None or all(map(operator.is_, moms, cache["moms"])))
    if same:
        return cache["packs"]
    _validate(weights, moms, restores, dev)
    nbytes = _lib.library().mxt_sgd_pack_bytes()
    if nbytes != pack_layout()[1]:
        raise MXNetError(f"sgd_mom_multi: the kernel's Pack is {nbytes} "
                         f"bytes, the wrapper packs {pack_layout()[1]}")
    n = len(weights)
    sizes = [w.numel() for w in weights] + [d.numel() for d, _s in restores]
    p0 = wptrs + [k[0] for k in rkey]
    p1 = [0] * n + [k[1] for k in rkey]
    p2 = (mptrs if moms is not None else [0] * n) + [0] * len(rkey)
    packs = []
    for lo, hi, first in plan_launches(sizes, n):
        pk = _Pack(lo, hi, first, n)
        pk.ptrs[0, :hi - lo] = p0[lo:hi]
        pk.ptrs[1, :hi - lo] = p1[lo:hi]
        pk.ptrs[2, :hi - lo] = p2[lo:hi]
        pk.ptrs[3, :hi - lo] = sizes[lo:hi]
        packs.append(pk)
    cache.clear()
    cache.update(weights=list(weights),
                 moms=list(moms) if moms is not None else None,
                 wptrs=wptrs, mptrs=mptrs, rkey=rkey, packs=packs,
                 shapes=list(map(_SHAPE, weights)), lrs=None, wds=None)
    PACK_BUILDS.inc()
    return packs


def _check_grads(grads, dev, shapes):
    """Every gradient a contiguous float32 tensor on ``dev`` of its
    weight's shape (one of ``shapes``): C-level maps over the list, the
    per-tensor message only when one fails."""
    if (set(map(_DTYPE, grads)) == _F32
            and set(map(torch.Tensor.get_device, grads)) == {dev.index}
            and all(map(torch.Tensor.is_contiguous, grads))
            and list(map(_SHAPE, grads)) == shapes):
        return
    for i, (g, shape) in enumerate(zip(grads, shapes)):
        _lib.check_f32(f"sgd_mom_multi: grads[{i}]", g, dev, shape)


def sgd_mom_multi(weights, grads, moms, lrs, wds, momentum, rescale_grad,
                  clip_gradient, guard=None, cache=None):
    """Update every ``weights[i]`` (and ``moms[i]``) in place from
    ``grads[i]`` with learning rate ``lrs[i]`` and weight decay ``wds[i]``;
    ``moms`` is None for SGD without momentum, ``clip_gradient < 0`` turns
    clipping off. ``guard`` (a :class:`Guard`) skips a non-finite step.
    ``cache`` (a dict the caller keeps) holds the launch packs between
    calls.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous float32 tensors on one device; anything else
    raises :class:`MXNetError`.
    """
    if not weights:
        return
    n = len(weights)
    if len(grads) != n or len(lrs) != n or len(wds) != n or \
            (moms is not None and len(moms) != n):
        raise MXNetError("sgd_mom_multi: weights, grads, moms, lrs and wds "
                         "must have one entry per parameter")
    w0 = weights[0]
    if not w0.is_cuda:
        if w0.device.type in ("cpu", "meta"):
            return sgd_mom_multi_plain(weights, grads, moms, lrs, wds,
                                       momentum, rescale_grad, clip_gradient,
                                       guard)
        raise MXNetError(f"sgd_mom_multi: no kernel for device {w0.device}")
    dev = w0.device
    restores = guard.restores if guard is not None else ()
    if guard is not None:
        if (guard.counters.dtype != torch.int32 or guard.counters.device != dev
                or guard.counters.numel() != 2):
            raise MXNetError("sgd_mom_multi: guard counters must be an int32 "
                             f"(2,) tensor on {dev}")
        if guard.probe is None:
            guard.probe = torch.empty(1, device=dev)
    cache = {} if cache is None else cache
    packs = _packs(weights, moms, restores, dev, cache)
    _check_grads(grads, dev, cache["shapes"])
    gptrs = list(map(torch.Tensor.data_ptr, grads))
    fresh = cache["lrs"] != lrs or cache["wds"] != wds
    if fresh:
        cache["lrs"], cache["wds"] = list(lrs), list(wds)
    for pk in packs:
        k = pk.n_update
        if k:
            pk.ptrs[1, :k] = gptrs[pk.lo:pk.lo + k]
            if fresh:
                pk.hyper[0, :k] = lrs[pk.lo:pk.lo + k]
                pk.hyper[1, :k] = wds[pk.lo:pk.lo + k]
    lib = _lib.library()
    if guard is not None:
        probe = guard.probe.data_ptr()
        for i, pk in enumerate(p for p in packs if p.n_update):
            _lib.check(_lib.launch(w0, lib.mxt_sgd_probe_f32, pk.address,
                                   probe, int(i == 0)),
                       "sgd_mom_multi (probe)")
            LAUNCHES.inc()
    counters = guard.counters.data_ptr() if guard is not None else 0
    for pk in packs:
        _lib.check(_lib.launch(
            w0, lib.mxt_sgd_mom_multi_f32, pk.address, float(momentum),
            int(moms is not None), float(rescale_grad), float(clip_gradient),
            probe if guard is not None else 0, counters), "sgd_mom_multi")
        counters = 0  # the first launch advances them
        LAUNCHES.inc()
