"""``rmsprop_multi``: the multi-tensor RMSProp update, plain and centred
(Graves' ``RMSPropAlex``), with the non-finite guard folded in.

Replaces the optimizer step inside ``mxnet_tpu/executor.py``
``fused_train_update`` for RMSProp: ``RMSProp.jax_apply``
(``mxnet_tpu/optimizer.py:466-486``) over ``_rmsprop_update`` and
``_rmspropalex_update`` (``mxnet_tpu/ops/defs_optimizer.py:104-163``,
``_prep_grad`` with the weight decay after the clip) unrolled over every
parameter, and the ``MXNET_NONFINITE_GUARD`` select (``executor.py:1381``,
``:1614-1652``), which XLA fuses into the training step and eager PyTorch
would run as about a dozen launches per parameter. Per parameter, in
place::

    g = grad * rescale_grad; g = clip(g, -c, c) if c >= 0; g = g + wd * w
    n = (1 - gamma1) * g * g + gamma1 * n
    plain:   w = w - lr * g / sqrt(n + epsilon)
    centred: gm = (1 - gamma1) * g + gamma1 * gm
             delta = gamma2 * delta - lr * g / sqrt(n - gm * gm + epsilon)
             w = w + delta
    w = clip(w, -clip_weights, clip_weights) if clip_weights > 0

Bound on the H100: device-memory bandwidth, 20 bytes per parameter element
(36 centred): the GRU language model's 4.49 M values move 89.8 MB, 0.0268
ms (centred 161.7 MB, 0.0483 ms). ``csrc/rmsprop_multi.cu`` runs one launch
over all tensors from a device table of ``(weight, n, gm, delta, numel)``
entries, a ``(lr, wd)`` row per entry and a block map of :data:`CHUNK`
elements per block, as ``adam_multi`` does; the caller's ``cache`` dict
(one per executor) keeps the table until a tensor moves, and the
gradients' pointers and the rows are uploaded from pinned memory without
a host wait when they change. Under the guard the same one launch is
cooperative: the blocks add the gradients into one device float, the grid
synchronises, and a non-finite sum skips the step (weights and every
state kept, the restore pairs copied back, the skip counters advanced),
with no host synchronisation.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .adam_multi import block_map, grad_ptrs, hyper_rows

# the C entry's packed arguments (csrc/rmsprop_multi.cu Packed): the
# tables' pointers, the counts, the hyperparameters as doubles, the probe,
# the counters and the stream
_PACK = struct.Struct("=5Q5q7d3Q").pack
# counts kernel launches only (never the plain version): one per call,
# under the guard too
LAUNCHES = _tm.counter("kernel.rmsprop_multi.launches")
TABLE_BUILDS = _tm.counter("kernel.rmsprop_multi.table_builds")
CHUNK = 8192  # elements per block: ~550 blocks for the GRU language model


def rmsprop_step_plain(w, g, n, lr, wd, gamma1, epsilon, rescale_grad,
                       clip_gradient, clip_weights, gm=None, delta=None,
                       gamma2=0.9):
    """New ``(w, n, gm, delta)`` of one parameter, in the reference's
    order (``gm`` and ``delta`` None unless centred)."""
    g = g * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * w
    n = (1.0 - gamma1) * (g * g) + gamma1 * n
    if gm is None:
        w = w - lr * g / torch.sqrt(n + epsilon)
    else:
        gm = (1.0 - gamma1) * g + gamma1 * gm
        delta = gamma2 * delta - lr * g / torch.sqrt(n - gm * gm + epsilon)
        w = w + delta
    if clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n, gm, delta


def rmsprop_multi_plain(weights, grads, ns, lrs, wds, gamma1, epsilon,
                        rescale_grad, clip_gradient, clip_weights, gms=None,
                        deltas=None, gamma2=0.9, guard=None):
    """The plain PyTorch version: one parameter after the other; the guard
    selects with tensor ops, so it never reads a value on the host."""
    finite = None
    if guard is not None:
        probe = torch.zeros((), dtype=torch.float32,
                            device=guard.counters.device)
        for g in grads:
            probe = probe + g.to(torch.float32).sum()
        finite = torch.isfinite(probe)
    for i, (w, g, n) in enumerate(zip(weights, grads, ns)):
        gm = gms[i] if gms is not None else None
        delta = deltas[i] if deltas is not None else None
        new = rmsprop_step_plain(w, g, n, lrs[i], wds[i], gamma1, epsilon,
                                 rescale_grad, clip_gradient, clip_weights,
                                 gm, delta, gamma2)
        for old, value in zip((w, n, gm, delta), new):
            if old is None:
                continue
            if finite is not None:
                value = torch.where(finite, value, old)
            old.copy_(value)
    if guard is not None:
        for dst, src in guard.restores:
            dst.copy_(torch.where(finite, dst, src))
        miss = (~finite).to(torch.int32)
        c = guard.counters
        c.copy_(torch.stack([c[0] + miss, (c[1] + miss) * miss]))


def _table(weights, ns, gms, deltas, restores, device, cache):
    """The device tables and the block map; rebuilt only when a tensor
    moved."""
    zeros = [None] * len(weights)
    key = tuple((w.data_ptr(), n.data_ptr(),
                 gm.data_ptr() if gm is not None else 0,
                 d.data_ptr() if d is not None else 0, w.numel())
                for w, n, gm, d in zip(weights, ns, gms or zeros,
                                       deltas or zeros))
    key += tuple((d.data_ptr(), s.data_ptr(), d.numel()) for d, s in restores)
    if cache.get("key") == key:
        return cache["table"]
    n_entries = len(weights)
    entries = np.array(key[:n_entries], np.int64).reshape(n_entries, 5)
    rest = np.array([list(k) for k in key[n_entries:]] or [[0, 0, 0]],
                    np.int64)
    sizes = [k[4] for k in key[:n_entries]] + [k[2] for k in key[n_entries:]]
    blocks, n_chunks = block_map(sizes, CHUNK, "rmsprop_multi")
    n_update = sum(-(-size // CHUNK) for size in sizes[:n_entries])
    table = {"entries": torch.from_numpy(entries).to(device),
             "restores": torch.from_numpy(rest).to(device),
             "blocks": torch.from_numpy(blocks).to(device),
             "n_update": n_update, "n_chunks": n_chunks,
             "n_entries": n_entries}
    cache.clear()
    cache.update(key=key, table=table)
    TABLE_BUILDS.inc()
    return table


def rmsprop_multi(weights, grads, ns, lrs, wds, gamma1, epsilon,
                  rescale_grad, clip_gradient, clip_weights, gms=None,
                  deltas=None, gamma2=0.9, guard=None, cache=None):
    """Update every ``weights[i]`` and ``ns[i]`` (centred, with ``gms`` and
    ``deltas`` given: those too) in place from ``grads[i]`` with learning
    rate ``lrs[i]`` and weight decay ``wds[i]``; ``clip_gradient < 0`` and
    ``clip_weights <= 0`` turn the clips off. ``guard`` (an
    ``sgd_mom_multi.Guard``) skips a non-finite step. ``cache`` (a dict the
    caller keeps) holds the device tables between calls.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous float32 tensors on one device; anything else
    raises :class:`MXNetError`.
    """
    if not weights:
        return
    n = len(weights)
    centered = gms is not None
    if (deltas is not None) != centered or any(
            len(x) != n for x in (grads, ns, lrs, wds, *(
                (gms, deltas) if centered else ()))):
        raise MXNetError("rmsprop_multi: weights, grads, ns, lrs and wds "
                         "(centred: gms and deltas too) must have one entry "
                         "per parameter")
    dev = weights[0].device
    if dev.type in ("cpu", "meta"):
        return rmsprop_multi_plain(weights, grads, ns, lrs, wds, gamma1,
                                   epsilon, rescale_grad, clip_gradient,
                                   clip_weights, gms, deltas, gamma2, guard)
    if dev.type != "cuda":
        raise MXNetError(f"rmsprop_multi: no kernel for device {dev}")
    for i, (w, g, s) in enumerate(zip(weights, grads, ns)):
        _lib.check_f32(f"rmsprop_multi: weights[{i}]", w, dev)
        _lib.check_f32(f"rmsprop_multi: grads[{i}]", g, dev, w.shape)
        _lib.check_f32(f"rmsprop_multi: ns[{i}]", s, dev, w.shape)
        if centered:
            _lib.check_f32(f"rmsprop_multi: gms[{i}]", gms[i], dev, w.shape)
            _lib.check_f32(f"rmsprop_multi: deltas[{i}]", deltas[i], dev,
                           w.shape)
    restores = guard.restores if guard is not None else []
    for dst, src in restores:
        _lib.check_f32("rmsprop_multi: restore target", dst, dev)
        _lib.check_f32("rmsprop_multi: restore source", src, dev, dst.shape)
    if guard is not None:
        if (guard.counters.dtype != torch.int32 or guard.counters.device != dev
                or guard.counters.numel() != 2):
            raise MXNetError("rmsprop_multi: guard counters must be an int32 "
                             f"(2,) tensor on {dev}")
        if guard.probe is None:
            guard.probe = torch.empty(1, device=dev)
    cache = {} if cache is None else cache
    table = _table(weights, ns, gms, deltas, restores, dev, cache)
    hyper = hyper_rows(lrs, wds, dev, cache)
    gptrs = grad_ptrs(grads, dev, cache)
    err = _lib.launch_packed(
        weights[0], _lib.library().mxt_rmsprop_multi_f32, _PACK,
        table["entries"].data_ptr(), gptrs.data_ptr(), hyper.data_ptr(),
        table["restores"].data_ptr(), table["blocks"].data_ptr(),
        table["n_update"], table["n_chunks"], table["n_entries"], CHUNK,
        int(centered), float(gamma1), float(1.0 - gamma1), float(gamma2),
        float(epsilon), float(rescale_grad), float(clip_gradient),
        float(clip_weights),
        guard.probe.data_ptr() if guard is not None else 0,
        guard.counters.data_ptr() if guard is not None else 0)
    _lib.check(err, "rmsprop_multi")
    LAUNCHES.inc()
