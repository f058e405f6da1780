"""``gru_cell`` and ``gru_cell_bwd``: one GRU cell step, forward and
backward.

Replace the gate chain of ``GRUCell.__call__``
(``mxnet_tpu/rnn/rnn_cell.py:301-330``; the same arithmetic as the gru scan
body of ``mxnet_tpu/ops/defs_rnn.py`` ``_run_layer``, :112-125) and its VJP,
which XLA fuses into one pass each and eager PyTorch would run as about
twelve launches per step: two slices, four adds, two multiplies and a
subtraction, two sigmoids and a tanh::

    r = sigmoid(xr + hr); z = sigmoid(xz + hz); o = tanh(xo + r * ho)
    next_h = o + z * (h_prev - o)

with ``[xr, xz, xo]`` the three slices of ``i2h`` and ``[hr, hz, ho]``
those of ``h2h``. The executor routes the unrolled subgraph of each cell
step here (``executor._fused_gru``), and the ``RNN`` op's gru mode runs its
steps here (``ops/defs_rnn.py``).

Bound on the H100: launch latency. At N = 32, H = 200 a training forward
moves 282 KB (205 KB at inference) and a backward 333 KB, ~0.1 us each at
3.35 TB/s. ``csrc/gru_cell.cu`` runs one thread per (n, j), coalesced
across j for each of the three gate reads, in the reference's order of
operations without FMA contraction. In training the forward also writes
the activated gates ``[r, z, o]`` ``(N, 3H)``, which the backward reads
with ``h2h``'s o-slice and ``h_prev``; the backward returns ``di2h`` and
``dh2h`` ``(N, 3H)``, which differ in the o-slice (``dh2h_o = r *
di2h_o``), and the direct part of ``dh_prev`` (``z * dnext_h``); the rest
of ``dh_prev`` comes through the h2h product. Both take the light launch
path (:func:`_lib.launch_packed`) and allocate their outputs as views of
one buffer, as ``lstm_cell`` does.
"""

from __future__ import annotations

import struct

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .lstm_cell import _sigmoid_grad, _tanh_grad

# the C entries' packed arguments (csrc/gru_cell.cu CellArgs, CellBwdArgs):
# pointers, sizes, the stream
_PACK_FWD = struct.Struct("=5Q2qQ").pack
_PACK_BWD = struct.Struct("=7Q2qQ").pack
# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.gru_cell.launches")
BWD_LAUNCHES = _tm.counter("kernel.gru_cell_bwd.launches")


def gru_cell_plain(i2h, h2h, h_prev):
    """The plain PyTorch version: ``(next_h, act)``, ``act`` the activated
    gates ``[r, z, o]`` as one ``(N, 3H)`` tensor."""
    xr, xz, xo = torch.chunk(i2h, 3, dim=1)
    hr, hz, ho = torch.chunk(h2h, 3, dim=1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    o = torch.tanh(xo + r * ho)
    next_h = o + z * (h_prev - o)
    return next_h, torch.cat([r, z, o], dim=1)


def gru_cell_bwd_plain(dnext_h, act, h2h, h_prev):
    """The plain PyTorch version of the VJP: ``(di2h, dh2h, dh_prev)``,
    ``dh_prev`` the part that does not pass through ``h2h``, with the
    derivatives taken as ``jax.vjp`` takes them."""
    r, z, o = torch.chunk(act, 3, dim=1)
    ho = torch.chunk(h2h, 3, dim=1)[2]
    g = torch.zeros_like(h_prev) if dnext_h is None else dnext_h
    zg = z * g
    da_z = _sigmoid_grad(g * (h_prev - o), z)
    da_o = _tanh_grad(g - zg, o)
    da_r = _sigmoid_grad(da_o * ho, r)
    return (torch.cat([da_r, da_z, da_o], dim=1),
            torch.cat([da_r, da_z, r * da_o], dim=1), zg)


def _gates_error(name, shape):
    return MXNetError(f"{name}: gates must be (N, 3H), got {tuple(shape)}")


def gru_cell(i2h, h2h, h_prev, save=True):
    """One GRU cell step from the gate inputs ``i2h``, ``h2h`` ``(N, 3H)``
    and the previous state ``h_prev`` ``(N, H)``: ``(next_h, act)``,
    ``act`` the activated gates for :func:`gru_cell_bwd` (None unless
    ``save``).

    CPU (and shape-only ``meta``) tensors take the plain version. CUDA
    tensors launch the kernel, which takes contiguous float32 tensors on
    one device; anything else raises :class:`MXNetError`. The outputs are
    views of one allocation.
    """
    if not i2h.is_cuda:
        if i2h.device.type in ("cpu", "meta"):
            next_h, act = gru_cell_plain(i2h, h2h, h_prev)
            return next_h, act if save else None
        raise MXNetError(f"gru_cell: no kernel for device {i2h.device}")
    shape = i2h.shape
    if len(shape) != 2 or shape[1] % 3:
        raise _gates_error("gru_cell", shape)
    rows, hidden = shape[0], shape[1] // 3
    dev = i2h.get_device()
    f32 = torch.float32
    if not (i2h.dtype is f32 and h2h.dtype is f32 and h_prev.dtype is f32
            and i2h.is_contiguous() and h2h.is_contiguous()
            and h_prev.is_contiguous() and h2h.get_device() == dev
            and h_prev.get_device() == dev and h2h.shape == shape
            and h_prev.shape == (rows, hidden)):
        raise _lib.refusal("gru_cell", [
            ("i2h", i2h, shape), ("h2h", h2h, shape),
            ("h_prev", h_prev, (rows, hidden))], i2h.device)
    if save:
        next_h, act = i2h.new_empty((4 * rows, hidden)).split_with_sizes(
            (rows, 3 * rows))
        act = act.view(rows, 3 * hidden)
    else:
        next_h, act = i2h.new_empty((rows, hidden)), None
    err = _lib.launch_packed(
        i2h, _lib.library().mxt_gru_cell_f32, _PACK_FWD, i2h.data_ptr(),
        h2h.data_ptr(), h_prev.data_ptr(), next_h.data_ptr(),
        act.data_ptr() if save else 0, rows, hidden)
    _lib.check(err, "gru_cell")
    LAUNCHES.inc()
    return next_h, act


def gru_cell_bwd(dnext_h, act, h2h, h_prev):
    """Gradients ``(di2h, dh2h, dh_prev)`` of one cell step from the output
    gradient (None: zero) and what the forward saved; ``dh_prev`` is the
    part that does not pass through ``h2h``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise :class:`MXNetError`, as :func:`gru_cell`.
    """
    if not act.is_cuda:
        if act.device.type in ("cpu", "meta"):
            return gru_cell_bwd_plain(dnext_h, act, h2h, h_prev)
        raise MXNetError(f"gru_cell_bwd: no kernel for device {act.device}")
    shape = act.shape
    if len(shape) != 2 or shape[1] % 3:
        raise _gates_error("gru_cell_bwd", shape)
    rows, hidden = shape[0], shape[1] // 3
    dev = act.get_device()
    f32 = torch.float32
    ok = act.dtype is f32 and act.is_contiguous() and h_prev is not None
    for t, want in ((h2h, shape), (h_prev, (rows, hidden)),
                    (dnext_h, (rows, hidden))):
        ok = ok and (t is None or (
            t.dtype is f32 and t.is_contiguous() and t.get_device() == dev
            and t.shape == want))
    if not ok:
        state = (rows, hidden)
        raise _lib.refusal("gru_cell_bwd", [
            ("act", act, shape), ("h2h", h2h, shape),
            ("h_prev", h_prev, state), ("dnext_h", dnext_h, state)],
            act.device)
    di2h, dh2h, dh_prev = act.new_empty((7 * rows, hidden)).split_with_sizes(
        (3 * rows, 3 * rows, rows))
    di2h, dh2h = di2h.view(rows, 3 * hidden), dh2h.view(rows, 3 * hidden)
    err = _lib.launch_packed(
        act, _lib.library().mxt_gru_cell_bwd_f32, _PACK_BWD,
        dnext_h.data_ptr() if dnext_h is not None else 0, act.data_ptr(),
        h2h.data_ptr(), h_prev.data_ptr(), di2h.data_ptr(), dh2h.data_ptr(),
        dh_prev.data_ptr(), rows, hidden)
    _lib.check(err, "gru_cell_bwd")
    BWD_LAUNCHES.inc()
    return di2h, dh2h, dh_prev


class GRUCellFn(torch.autograd.Function):
    """One training cell step: forward :func:`gru_cell`, backward
    :func:`gru_cell_bwd`. Returns ``next_h``."""

    @staticmethod
    def forward(ctx, i2h, h2h, h_prev):
        next_h, act = gru_cell(i2h, h2h, h_prev)
        ctx.save_for_backward(act, h2h, h_prev)
        # an output no later step consumes comes back as None
        ctx.set_materialize_grads(False)
        return next_h

    @staticmethod
    def backward(ctx, dnext_h):
        act, h2h, h_prev = ctx.saved_tensors
        if dnext_h is not None:
            dnext_h = dnext_h.contiguous()
        return gru_cell_bwd(dnext_h, act, h2h, h_prev)
