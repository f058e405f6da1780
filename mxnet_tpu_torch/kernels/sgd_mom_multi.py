"""``sgd_mom_multi``: the multi-tensor SGD(-momentum) update with the
non-finite guard.

Replaces the optimizer step inside ``mxnet_tpu/executor.py``
``fused_train_update`` (:1381): ``SGD.jax_apply`` over ``_prep_grad`` and
``_sgd_mom_update`` (``mxnet_tpu/ops/defs_optimizer.py:34-72``) unrolled
over every parameter, and the ``MXNET_NONFINITE_GUARD`` select
(:1614-1652), which XLA fuses into the training step and eager PyTorch
would run as about eight launches per parameter (155 parameters for
ResNet-50). Per parameter, in place, following ``_prep_grad`` exactly::

    g = grad * rescale_grad; g = clip(g, -c, c) if c >= 0; g = g + wd * w
    mom = momentum * mom - lr * g; w = w + mom     (w = w - lr * g without)

Under the guard (a :class:`Guard`) a probe first adds every gradient into
one device scalar; when it is not finite the step writes no weight and no
momentum, copies each restore pair's source over its destination (the
executor passes the BatchNorm statistics as they were before the forward)
and advances the ``[total, consecutive]`` skip counters — all on the
device, with no host synchronisation.

Bound on the H100: device-memory bandwidth, 20 bytes per parameter element
(25.55 M for ResNet-50: 511 MB, 0.153 ms). ``csrc/sgd_mom_multi.cu`` runs
one launch over all tensors (two with the guard: the probe, then the
update) from a device table of ``(weight, mom, numel)`` entries, a
``(lr, wd)`` row per entry and a block map that cuts every tensor into
chunks of ``CHUNK`` elements. The caller passes a ``cache`` dict (one per
executor); the table is rebuilt only when a weight or momentum moves, the
``(lr, wd)`` rows are uploaded only when they change. Autograd allocates
the gradients anew each step, so their pointers are one int64 per tensor
beside the table. Both uploads go from pinned memory, without a host
wait. The kernel writes through raw pointers, outside autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): one per call, two
# under the guard
LAUNCHES = _tm.counter("kernel.sgd_mom_multi.launches")
TABLE_BUILDS = _tm.counter("kernel.sgd_mom_multi.table_builds")
GRAD_UPLOADS = _tm.counter("kernel.sgd_mom_multi.grad_uploads")
CHUNK = 32768  # elements per block


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


def block_map(sizes, chunk, name):
    """``(blocks, n_blocks)``: one ``(entry, start)`` row per block of
    ``chunk`` elements over tensors of ``sizes`` (update entries first,
    then restore entries)."""
    blocks = np.array([(e, s) for e, size in enumerate(sizes)
                       for s in range(0, size, chunk)] or [[0, 0]], np.int64)
    n_blocks = sum(-(-size // chunk) for size in sizes)
    if n_blocks >= 2 ** 31:
        raise MXNetError(f"{name}: {n_blocks} blocks exceed the grid")
    return blocks, n_blocks


def _table(weights, moms, restores, device, cache):
    """The device table of ``(weight, mom, numel)`` entries, restore
    entries and the block map; rebuilt only when a tensor moved."""
    key = tuple((w.data_ptr(), moms[i].data_ptr() if moms is not None else 0,
                 w.numel()) for i, w in enumerate(weights))
    key += tuple((d.data_ptr(), s.data_ptr(), d.numel()) for d, s in restores)
    if cache.get("key") == key:
        return cache["table"]
    n_entries = len(weights)
    entries = np.array([list(k) for k in key[:n_entries]], np.int64)
    rest = np.array([list(k) for k in key[n_entries:]] or [[0, 0, 0]],
                    np.int64)
    blocks, n_blocks = block_map([k[2] for k in key], CHUNK, "sgd_mom_multi")
    table = {"entries": torch.from_numpy(entries).to(device),
             "restores": torch.from_numpy(rest).to(device),
             "blocks": torch.from_numpy(blocks).to(device),
             "n_blocks": n_blocks, "n_entries": n_entries}
    cache.clear()
    cache.update(key=key, table=table)
    TABLE_BUILDS.inc()
    return table


def grad_ptrs(grads, device, cache, uploads=GRAD_UPLOADS):
    """The gradients' pointers on the device, uploaded (from pinned memory,
    without a host wait) only when they moved; ``uploads`` counts them."""
    key = tuple(g.data_ptr() for g in grads)
    if cache.get("grad_key") != key:
        host = torch.tensor(key, dtype=torch.int64).pin_memory()
        cache["grads"] = host.to(device, non_blocking=True)
        cache["grad_key"] = key
        uploads.inc()
    return cache["grads"]


def hyper_rows(lrs, wds, device, cache):
    """The ``(lr, wd)`` rows on the device, uploaded (from pinned memory,
    without a host wait) only when they changed."""
    host = np.array([lrs, wds], np.float32).T.copy()
    old = cache.get("hyper_host")
    if old is None or old.shape != host.shape or not np.array_equal(old, host):
        cache["hyper_host"] = host
        cache["hyper"] = torch.from_numpy(host).pin_memory().to(
            device, non_blocking=True)
    return cache["hyper"]


def sgd_mom_multi(weights, grads, moms, lrs, wds, momentum, rescale_grad,
                  clip_gradient, guard=None, cache=None):
    """Update every ``weights[i]`` (and ``moms[i]``) in place from
    ``grads[i]`` with learning rate ``lrs[i]`` and weight decay ``wds[i]``;
    ``moms`` is None for SGD without momentum, ``clip_gradient < 0`` turns
    clipping off. ``guard`` (a :class:`Guard`) skips a non-finite step.
    ``cache`` (a dict the caller keeps) holds the device table between
    calls.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous float32 tensors on one device; anything else
    raises :class:`MXNetError`.
    """
    if not weights:
        return
    if len(grads) != len(weights) or len(lrs) != len(weights) or \
            len(wds) != len(weights) or \
            (moms is not None and len(moms) != len(weights)):
        raise MXNetError("sgd_mom_multi: weights, grads, moms, lrs and wds "
                         "must have one entry per parameter")
    dev = weights[0].device
    if dev.type in ("cpu", "meta"):
        return sgd_mom_multi_plain(weights, grads, moms, lrs, wds, momentum,
                                   rescale_grad, clip_gradient, guard)
    if dev.type != "cuda":
        raise MXNetError(f"sgd_mom_multi: no kernel for device {dev}")
    for i, (w, g) in enumerate(zip(weights, grads)):
        _lib.check_f32(f"sgd_mom_multi: weights[{i}]", w, dev)
        _lib.check_f32(f"sgd_mom_multi: grads[{i}]", g, dev, w.shape)
        if moms is not None:
            _lib.check_f32(f"sgd_mom_multi: moms[{i}]", moms[i], dev, w.shape)
    restores = guard.restores if guard is not None else []
    for dst, src in restores:
        _lib.check_f32("sgd_mom_multi: restore target", dst, dev)
        _lib.check_f32("sgd_mom_multi: restore source", src, dev, dst.shape)
    if guard is not None:
        if (guard.counters.dtype != torch.int32 or guard.counters.device != dev
                or guard.counters.numel() != 2):
            raise MXNetError("sgd_mom_multi: guard counters must be an int32 "
                             f"(2,) tensor on {dev}")
        if guard.probe is None:
            guard.probe = torch.empty(1, device=dev)
    cache = {} if cache is None else cache
    table = _table(weights, moms, restores, dev, cache)
    hyper = hyper_rows(lrs, wds, dev, cache)
    gptrs = grad_ptrs(grads, dev, cache)
    lib = _lib.library()
    stream = _lib.stream_of(weights[0])
    with torch.cuda.device(dev):
        if guard is not None:
            err = lib.mxt_sgd_probe_f32(
                table["entries"].data_ptr(), gptrs.data_ptr(),
                table["blocks"].data_ptr(),
                table["n_blocks"], table["n_entries"], CHUNK,
                guard.probe.data_ptr(), stream)
            _lib.check(err, "sgd_mom_multi (probe)")
            LAUNCHES.inc()
        err = lib.mxt_sgd_mom_multi_f32(
            table["entries"].data_ptr(), gptrs.data_ptr(), hyper.data_ptr(),
            table["restores"].data_ptr(), table["blocks"].data_ptr(),
            table["n_blocks"], table["n_entries"], CHUNK, float(momentum),
            int(moms is not None), float(rescale_grad), float(clip_gradient),
            guard.probe.data_ptr() if guard is not None else 0,
            guard.counters.data_ptr() if guard is not None else 0, stream)
        _lib.check(err, "sgd_mom_multi")
        LAUNCHES.inc()
