"""``lstm_cell`` and ``lstm_cell_bwd``: one LSTM cell step, forward and
backward.

Replace the gate chain of ``LSTMCell.__call__``
(``mxnet_tpu/rnn/rnn_cell.py:245-279``; the same arithmetic as the scan
body of ``mxnet_tpu/ops/defs_rnn.py`` ``_run_layer``, :98-108) and its VJP,
which XLA fuses into one pass each and eager PyTorch would run as about
eleven launches per step: the gate sum ``i2h + h2h``, the forget bias,
three sigmoids and a tanh on the four slices, ``next_c = f * c + i * g``
and ``next_h = o * tanh(next_c)``. The executor routes the unrolled
subgraph of each cell step here (``executor._fused_lstm``).

Bound on the H100: launch latency. At N = 32, H = 200 a forward moves
384 KB and a backward 333 KB, ~0.1 us each at 3.35 TB/s.
``csrc/lstm_cell.cu`` runs one thread per (n, j), coalesced across j for
each of the four gate reads, in the reference's order of operations
without FMA contraction. In training the forward also writes the four
activated gates ``(N, 4H)``, which the backward reads with ``c_prev`` and
``next_c``; the backward returns one ``dgates`` ``(N, 4H)`` that is the
gradient of both ``i2h`` and ``h2h``, and ``dc_prev``. A state that no
later step consumes (``next_c`` of a sequence's last step) has no gradient:
``None``, which counts as zero.

The device's part is about 1.7 us; the wrappers' host path is the cost.
Both take the light launch path (:func:`_lib.launch`: no device switch
when the tensors' device is current, the raw current stream), check their
inputs in one compound test, and the forward allocates its three outputs
as views of one buffer.
"""

from __future__ import annotations

import struct

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# the C entries' packed arguments (csrc/lstm_cell.cu CellArgs, CellBwdArgs):
# pointers, sizes, the forget bias as a double, the stream
_PACK_FWD = struct.Struct("=6Q2qdQ").pack
_PACK_BWD = struct.Struct("=7Q2qQ").pack
# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.lstm_cell.launches")
BWD_LAUNCHES = _tm.counter("kernel.lstm_cell_bwd.launches")


def _sigmoid_grad(ct, s):
    return ct * (s * (1.0 - s))


def _tanh_grad(ct, t):
    a = ct * (1.0 - t)
    return a + a * t


def lstm_cell_plain(i2h, h2h, c_prev, forget_bias=0.0):
    """The plain PyTorch version: ``(next_h, next_c, act)``, ``act`` the
    activated gates ``[i, f, g, o]`` as one ``(N, 4H)`` tensor."""
    i_g, f_g, g_g, o_g = torch.chunk(i2h + h2h, 4, dim=1)
    i = torch.sigmoid(i_g)
    f = torch.sigmoid(f_g + forget_bias)
    g = torch.tanh(g_g)
    o = torch.sigmoid(o_g)
    next_c = f * c_prev + i * g
    next_h = o * torch.tanh(next_c)
    return next_h, next_c, torch.cat([i, f, g, o], dim=1)


def lstm_cell_bwd_plain(dnext_h, dnext_c, act, c_prev, next_c):
    """The plain PyTorch version of the VJP: ``(dgates, dc_prev)``, with the
    derivatives taken as ``jax.vjp`` takes them."""
    i, f, g, o = torch.chunk(act, 4, dim=1)
    tc = torch.tanh(next_c)
    dh = torch.zeros_like(next_c) if dnext_h is None else dnext_h
    dc = _tanh_grad(dh * o, tc)
    if dnext_c is not None:
        dc = dnext_c + dc
    dgates = torch.cat([_sigmoid_grad(dc * g, i),
                        _sigmoid_grad(dc * c_prev, f),
                        _tanh_grad(dc * i, g),
                        _sigmoid_grad(dh * tc, o)], dim=1)
    return dgates, dc * f


def _gates_error(name, shape):
    return MXNetError(f"{name}: gates must be (N, 4H), got {tuple(shape)}")


def cell_outputs(like, rows, hidden, save):
    """``(next_h, next_c, act)`` for one forward call: contiguous, disjoint
    views of one ``torch.empty`` on ``like``'s device (``act`` None unless
    ``save``), so a call allocates once."""
    if not save:
        next_h, next_c = like.new_empty((2 * rows, hidden)).split_with_sizes(
            (rows, rows))
        return next_h, next_c, None
    next_h, next_c, act = like.new_empty((6 * rows, hidden)).split_with_sizes(
        (rows, rows, 4 * rows))
    return next_h, next_c, act.view(rows, 4 * hidden)


def lstm_cell(i2h, h2h, c_prev, forget_bias=0.0, save=True):
    """One LSTM cell step from the gate inputs ``i2h``, ``h2h`` ``(N, 4H)``
    and the previous cell state ``c_prev`` ``(N, H)``: ``(next_h, next_c,
    act)``, ``act`` the activated gates for :func:`lstm_cell_bwd` (None
    unless ``save``).

    CPU (and shape-only ``meta``) tensors take the plain version. CUDA
    tensors launch the kernel, which takes contiguous float32 tensors on
    one device; anything else raises :class:`MXNetError`. The outputs are
    views of one allocation (:func:`cell_outputs`).
    """
    if not i2h.is_cuda:
        if i2h.device.type in ("cpu", "meta"):
            h, c, act = lstm_cell_plain(i2h, h2h, c_prev, forget_bias)
            return h, c, act if save else None
        raise MXNetError(f"lstm_cell: no kernel for device {i2h.device}")
    shape = i2h.shape
    if len(shape) != 2 or shape[1] % 4:
        raise _gates_error("lstm_cell", shape)
    rows, hidden = shape[0], shape[1] // 4
    dev = i2h.get_device()
    f32 = torch.float32
    if not (i2h.dtype is f32 and h2h.dtype is f32 and c_prev.dtype is f32
            and i2h.is_contiguous() and h2h.is_contiguous()
            and c_prev.is_contiguous() and h2h.get_device() == dev
            and c_prev.get_device() == dev and h2h.shape == i2h.shape
            and c_prev.shape == (rows, hidden)):
        raise _lib.refusal("lstm_cell", [
            ("i2h", i2h, shape), ("h2h", h2h, shape),
            ("c_prev", c_prev, (rows, hidden))], i2h.device)
    next_h, next_c, act = cell_outputs(i2h, rows, hidden, save)
    err = _lib.launch_packed(
        i2h, _lib.library().mxt_lstm_cell_f32, _PACK_FWD, i2h.data_ptr(),
        h2h.data_ptr(), c_prev.data_ptr(), next_h.data_ptr(),
        next_c.data_ptr(), act.data_ptr() if save else 0, rows, hidden,
        float(forget_bias))
    _lib.check(err, "lstm_cell")
    LAUNCHES.inc()
    return next_h, next_c, act


def lstm_cell_bwd(dnext_h, dnext_c, act, c_prev, next_c):
    """Gradients ``(dgates, dc_prev)`` of one cell step from the output
    gradients (either may be None: zero) and what the forward saved.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise :class:`MXNetError`, as :func:`lstm_cell`.
    """
    if not act.is_cuda:
        if act.device.type in ("cpu", "meta"):
            return lstm_cell_bwd_plain(dnext_h, dnext_c, act, c_prev, next_c)
        raise MXNetError(f"lstm_cell_bwd: no kernel for device {act.device}")
    shape = act.shape
    if len(shape) != 2 or shape[1] % 4:
        raise _gates_error("lstm_cell_bwd", shape)
    rows, hidden = shape[0], shape[1] // 4
    dev = act.get_device()
    f32 = torch.float32
    ok = (act.dtype is f32 and act.is_contiguous() and c_prev is not None
          and next_c is not None)
    for t in (c_prev, next_c, dnext_h, dnext_c):
        ok = ok and (t is None or (
            t.dtype is f32 and t.is_contiguous() and t.get_device() == dev
            and t.shape == (rows, hidden)))
    if not ok:
        state = (rows, hidden)
        raise _lib.refusal("lstm_cell_bwd", [
            ("act", act, act.shape), ("c_prev", c_prev, state),
            ("next_c", next_c, state), ("dnext_h", dnext_h, state),
            ("dnext_c", dnext_c, state)], act.device)
    dgates = torch.empty_like(act)
    dc_prev = torch.empty_like(c_prev)
    err = _lib.launch_packed(
        act, _lib.library().mxt_lstm_cell_bwd_f32, _PACK_BWD,
        dnext_h.data_ptr() if dnext_h is not None else 0,
        dnext_c.data_ptr() if dnext_c is not None else 0, act.data_ptr(),
        c_prev.data_ptr(), next_c.data_ptr(), dgates.data_ptr(),
        dc_prev.data_ptr(), rows, hidden)
    _lib.check(err, "lstm_cell_bwd")
    BWD_LAUNCHES.inc()
    return dgates, dc_prev


class LSTMCellFn(torch.autograd.Function):
    """One training cell step: forward :func:`lstm_cell`, backward
    :func:`lstm_cell_bwd`. Returns ``(next_h, next_c)``."""

    @staticmethod
    def forward(ctx, i2h, h2h, c_prev, forget_bias):
        next_h, next_c, act = lstm_cell(i2h, h2h, c_prev, forget_bias)
        ctx.save_for_backward(act, c_prev, next_c)
        # an output no later step consumes comes back as None
        ctx.set_materialize_grads(False)
        return next_h, next_c

    @staticmethod
    def backward(ctx, dnext_h, dnext_c):
        act, c_prev, next_c = ctx.saved_tensors
        if dnext_h is not None:
            dnext_h = dnext_h.contiguous()
        if dnext_c is not None:
            dnext_c = dnext_c.contiguous()
        dgates, dc_prev = lstm_cell_bwd(dnext_h, dnext_c, act, c_prev,
                                        next_c)
        return dgates, dgates, dc_prev, None
