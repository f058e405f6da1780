"""``adam_multi``: the multi-tensor Adam update with the non-finite guard.

Replaces the optimizer step inside ``mxnet_tpu/executor.py``
``fused_train_update`` for Adam: ``Adam.jax_apply``
(``mxnet_tpu/optimizer.py:377-391``) over ``_adam_update``
(``mxnet_tpu/ops/defs_optimizer.py:78-87``, ``_prep_grad`` with the weight
decay before the clip) unrolled over every parameter, and the
``MXNET_NONFINITE_GUARD`` select (``executor.py:1539``), which XLA fuses
into the training step and eager PyTorch would run as about a dozen
launches per parameter. Per parameter, in place::

    g = grad * rescale_grad; g = g + wd * w; g = clip(g, -c, c) if c >= 0
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * g * g
    w = w - lr_t * mean / (sqrt(var) + epsilon)

with ``lr_t`` the caller's bias-corrected rate (``Adam.torch_apply``).

Bound on the H100: device-memory bandwidth, 28 bytes per parameter element
(the LSTM-PTB model's 4.65 M values: 130 MB, 0.039 ms). ``csrc/adam_multi.cu``
runs one launch over all tensors (two under the guard: the probe of
``sgd_mom_multi``, then the update) from a device table of ``(weight,
mean, numel)`` entries — the probe's layout — with the variances' pointers
beside it, a ``(lr_t, wd)`` row per entry and a block map of ``CHUNK``
elements per block. The caller passes a ``cache`` dict (one per executor:
every bucket of a ``BucketingModule`` has its own, over the same weights
and states); the table is built only when a weight, mean or variance
moves. The gradients' pointers and the ``(lr_t, wd)`` rows, which change
every step (the bias correction moves with ``t``), are uploaded from
pinned memory without a host wait when they change.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .sgd_mom_multi import block_map, grad_ptrs, hyper_rows

# counts kernel launches only (never the plain version): one per call, two
# under the guard
LAUNCHES = _tm.counter("kernel.adam_multi.launches")
TABLE_BUILDS = _tm.counter("kernel.adam_multi.table_builds")
GRAD_UPLOADS = _tm.counter("kernel.adam_multi.grad_uploads")
CHUNK = 8192  # elements per block: ~570 blocks for the LSTM-PTB model

def adam_step_plain(w, g, m, v, lr, wd, beta1, beta2, epsilon, rescale_grad,
                    clip_gradient):
    """New ``(w, mean, var)`` of one parameter, in the reference's order."""
    g = g * rescale_grad
    g = g + wd * w
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * (g * g)
    return w - lr * m / (torch.sqrt(v) + epsilon), m, v


def adam_multi_plain(weights, grads, means, variances, lrs, wds, beta1,
                     beta2, epsilon, rescale_grad, clip_gradient,
                     guard=None):
    """The plain PyTorch version: one parameter after the other; the guard
    selects with tensor ops, so it never reads a value on the host."""
    finite = None
    if guard is not None:
        probe = torch.zeros((), dtype=torch.float32,
                            device=guard.counters.device)
        for g in grads:
            probe = probe + g.to(torch.float32).sum()
        finite = torch.isfinite(probe)
    for w, g, m, v, lr, wd in zip(weights, grads, means, variances, lrs,
                                  wds):
        nw, nm, nv = adam_step_plain(w, g, m, v, lr, wd, beta1, beta2,
                                     epsilon, rescale_grad, clip_gradient)
        if finite is not None:
            nw = torch.where(finite, nw, w)
            nm = torch.where(finite, nm, m)
            nv = torch.where(finite, nv, v)
        w.copy_(nw)
        m.copy_(nm)
        v.copy_(nv)
    if guard is not None:
        for dst, src in guard.restores:
            dst.copy_(torch.where(finite, dst, src))
        miss = (~finite).to(torch.int32)
        c = guard.counters
        c.copy_(torch.stack([c[0] + miss, (c[1] + miss) * miss]))


def _table(weights, means, variances, restores, device, cache):
    """The device table, the variances' pointers, the restore entries and
    the block map; rebuilt only when a tensor moved."""
    key = tuple((w.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel())
                for w, m, v in zip(weights, means, variances))
    key += tuple((d.data_ptr(), s.data_ptr(), d.numel()) for d, s in restores)
    if cache.get("key") == key:
        return cache["table"]
    n_entries = len(weights)
    entries = np.array([(w, m, n) for w, m, _v, n in key[:n_entries]],
                       np.int64)
    var_ptrs = np.array([k[2] for k in key[:n_entries]], np.int64)
    rest = np.array([list(k) for k in key[n_entries:]] or [[0, 0, 0]],
                    np.int64)
    sizes = [k[3] for k in key[:n_entries]] + [k[2] for k in key[n_entries:]]
    blocks, n_blocks = block_map(sizes, CHUNK, "adam_multi")
    table = {"entries": torch.from_numpy(entries).to(device),
             "vars": torch.from_numpy(var_ptrs).to(device),
             "restores": torch.from_numpy(rest).to(device),
             "blocks": torch.from_numpy(blocks).to(device),
             "n_blocks": n_blocks, "n_entries": n_entries}
    cache.clear()
    cache.update(key=key, table=table)
    TABLE_BUILDS.inc()
    return table


def adam_multi(weights, grads, means, variances, lrs, wds, beta1, beta2,
               epsilon, rescale_grad, clip_gradient, guard=None, cache=None):
    """Update every ``weights[i]``, ``means[i]`` and ``variances[i]`` in
    place from ``grads[i]`` with the bias-corrected rate ``lrs[i]`` and
    weight decay ``wds[i]``; ``clip_gradient < 0`` turns clipping off.
    ``guard`` (an ``sgd_mom_multi.Guard``) skips a non-finite step.
    ``cache`` (a dict the caller keeps) holds the device table between
    calls.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous float32 tensors on one device; anything else
    raises :class:`MXNetError`.
    """
    if not weights:
        return
    n = len(weights)
    if any(len(x) != n for x in (grads, means, variances, lrs, wds)):
        raise MXNetError("adam_multi: weights, grads, means, variances, lrs "
                         "and wds must have one entry per parameter")
    dev = weights[0].device
    if dev.type in ("cpu", "meta"):
        return adam_multi_plain(weights, grads, means, variances, lrs, wds,
                                beta1, beta2, epsilon, rescale_grad,
                                clip_gradient, guard)
    if dev.type != "cuda":
        raise MXNetError(f"adam_multi: no kernel for device {dev}")
    for i, (w, g, m, v) in enumerate(zip(weights, grads, means, variances)):
        _lib.check_f32(f"adam_multi: weights[{i}]", w, dev)
        _lib.check_f32(f"adam_multi: grads[{i}]", g, dev, w.shape)
        _lib.check_f32(f"adam_multi: means[{i}]", m, dev, w.shape)
        _lib.check_f32(f"adam_multi: variances[{i}]", v, dev, w.shape)
    restores = guard.restores if guard is not None else []
    for dst, src in restores:
        _lib.check_f32("adam_multi: restore target", dst, dev)
        _lib.check_f32("adam_multi: restore source", src, dev, dst.shape)
    if guard is not None:
        if (guard.counters.dtype != torch.int32 or guard.counters.device != dev
                or guard.counters.numel() != 2):
            raise MXNetError("adam_multi: guard counters must be an int32 "
                             f"(2,) tensor on {dev}")
        if guard.probe is None:
            guard.probe = torch.empty(1, device=dev)
    cache = {} if cache is None else cache
    table = _table(weights, means, variances, restores, dev, cache)
    hyper = hyper_rows(lrs, wds, dev, cache)
    gptrs = grad_ptrs(grads, dev, cache, GRAD_UPLOADS)
    lib = _lib.library()
    stream = _lib.stream_of(weights[0])
    with torch.cuda.device(dev):
        if guard is not None:
            err = lib.mxt_sgd_probe_f32(
                table["entries"].data_ptr(), gptrs.data_ptr(),
                table["blocks"].data_ptr(), table["n_blocks"],
                table["n_entries"], CHUNK, guard.probe.data_ptr(), stream)
            _lib.check(err, "adam_multi (probe)")
            LAUNCHES.inc()
        err = lib.mxt_adam_multi_f32(
            table["entries"].data_ptr(), table["vars"].data_ptr(),
            gptrs.data_ptr(), hyper.data_ptr(), table["restores"].data_ptr(),
            table["blocks"].data_ptr(), table["n_blocks"],
            table["n_entries"], CHUNK, float(beta1), float(beta2),
            float(1.0 - beta1), float(1.0 - beta2), float(epsilon),
            float(rescale_grad), float(clip_gradient),
            guard.probe.data_ptr() if guard is not None else 0,
            guard.counters.data_ptr() if guard is not None else 0, stream)
        _lib.check(err, "adam_multi")
        LAUNCHES.inc()
