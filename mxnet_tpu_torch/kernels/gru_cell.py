"""``gru_cell`` and ``gru_cell_bwd``: one whole GRU cell step, forward and
backward, the recurrent product included.

Replace one step of ``GRUCell.__call__`` from its h2h ``FullyConnected``
on (``mxnet_tpu/rnn/rnn_cell.py:301-330``; the same arithmetic as the gru
scan body of ``mxnet_tpu/ops/defs_rnn.py`` ``_run_layer``, :112-125) and
its VJP::

    h2h = h_prev @ Wh.T + bh;  [hr, hz, ho] = h2h;  [xr, xz, xo] = i2h
    r = sigmoid(xr + hr); z = sigmoid(xz + hz); o = tanh(xo + r * ho)
    next_h = o + z * (h_prev - o)

The executor routes the unrolled subgraph of each cell step, the h2h
``FullyConnected`` with it, here (``executor._fused_gru``), and the ``RNN``
op's gru mode runs its steps here (``ops/defs_rnn.py``).

Bound on the H100: bytes, 713 KB forward and 813 KB backward at N = 32,
H = 200 (0.21 and 0.24 us at 3.35 TB/s); in practice a launch's fixed
costs. ``csrc/gru_cell.cu`` brings tiles of ``h_prev`` and ``Wh`` into
shared memory by the copy engine (bulk and 2D tensor copies), sums each
output's product over 16 (forward) or 32 (backward) thread groups added in
a fixed order, then runs the gates in the reference's order of operations
without FMA contraction; in training it also writes the planes ``[r, z, o,
ho]``
``(4, N, H)``, ``ho`` the product's o-slice, which the backward reads with
``h_prev`` and ``Wh``. The backward returns ``di2h`` and ``dh2h`` ``(N,
3H)``, which differ in the o-slice (``dh2h_o = r * di2h_o``), and the whole
``dh_prev = z * dnext_h + dh2h @ Wh``. ``dWh = dh2h.T @ h_prev`` and ``dbh
= dh2h.sum(0)`` stay ``torch.mm``/``sum`` in :class:`GRUCellFn`, as the
FC's backward computed them. The products sum in another order than
cuBLAS's, so a result may differ from the plain version's by the rounding
of a sum of H (forward) or 3H (backward) products. Both wrappers take the
light launch path (:func:`_lib.launch_packed`) and allocate their outputs
as views of one buffer.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .lstm_cell import _sigmoid_grad, _tanh_grad

# the C entries' packed arguments (csrc/gru_cell.cu CellArgs, CellBwdArgs):
# pointers, sizes, the stream
_PACK_FWD = struct.Struct("=6Q2qQ").pack
_PACK_BWD = struct.Struct("=7Q2qQ").pack
# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.gru_cell.launches")
BWD_LAUNCHES = _tm.counter("kernel.gru_cell_bwd.launches")


def gru_cell_plain(i2h, h_prev, weight, bias=None):
    """The plain PyTorch version: ``(next_h, saved)``, ``saved`` the planes
    ``[r, z, o, ho]`` as one ``(4, N, H)`` tensor."""
    xr, xz, xo = torch.chunk(i2h, 3, dim=1)
    hr, hz, ho = torch.chunk(F.linear(h_prev, weight, bias), 3, dim=1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    o = torch.tanh(xo + r * ho)
    next_h = o + z * (h_prev - o)
    return next_h, torch.stack([r, z, o, ho])


def gru_cell_bwd_plain(dnext_h, saved, h_prev, weight):
    """The plain PyTorch version of the VJP: ``(di2h, dh2h, dh_prev)``,
    with the derivatives taken as ``jax.vjp`` takes them and ``dh_prev``
    the direct part plus the product's, ``z * dnext_h + dh2h @ Wh``."""
    r, z, o, ho = saved
    g = torch.zeros_like(h_prev) if dnext_h is None else dnext_h
    zg = z * g
    da_z = _sigmoid_grad(g * (h_prev - o), z)
    da_o = _tanh_grad(g - zg, o)
    da_r = _sigmoid_grad(da_o * ho, r)
    dh2h = torch.cat([da_r, da_z, r * da_o], dim=1)
    # the product's part in the product's dtype, as the FC's backward takes
    # it where the state's dtype is not the gate inputs'
    return (torch.cat([da_r, da_z, da_o], dim=1), dh2h,
            zg + torch.mm(dh2h.to(weight.dtype), weight))


def _gates_error(name, shape):
    return MXNetError(f"{name}: gates must be (N, 3H), got {tuple(shape)}")


def gru_cell(i2h, h_prev, weight, bias=None, save=True):
    """One GRU cell step from the input projection ``i2h`` ``(N, 3H)``, the
    previous state ``h_prev`` ``(N, H)`` and the recurrent weight ``(3H,
    H)`` and bias ``(3H,)`` (None: no bias): ``(next_h, saved)``, ``saved``
    the planes for :func:`gru_cell_bwd` (None unless ``save``).

    CPU (and shape-only ``meta``) tensors take the plain version. CUDA
    tensors launch the kernel, which takes contiguous float32 tensors on
    one device; anything else raises :class:`MXNetError`. The outputs are
    views of one allocation.
    """
    if not i2h.is_cuda:
        if i2h.device.type in ("cpu", "meta"):
            next_h, saved = gru_cell_plain(i2h, h_prev, weight, bias)
            return next_h, saved if save else None
        raise MXNetError(f"gru_cell: no kernel for device {i2h.device}")
    shape = i2h.shape
    if len(shape) != 2 or shape[1] % 3:
        raise _gates_error("gru_cell", shape)
    rows, hidden = shape[0], shape[1] // 3
    dev = i2h.get_device()
    f32 = torch.float32
    if not (i2h.dtype is f32 and h_prev.dtype is f32 and weight.dtype is f32
            and i2h.is_contiguous() and h_prev.is_contiguous()
            and weight.is_contiguous() and h_prev.get_device() == dev
            and weight.get_device() == dev
            and h_prev.shape == (rows, hidden)
            and weight.shape == (3 * hidden, hidden)
            and (bias is None or (
                bias.dtype is f32 and bias.is_contiguous()
                and bias.get_device() == dev
                and bias.shape == (3 * hidden,)))):
        raise _lib.refusal("gru_cell", [
            ("i2h", i2h, shape), ("h_prev", h_prev, (rows, hidden)),
            ("weight", weight, (3 * hidden, hidden)),
            ("bias", bias, (3 * hidden,))], i2h.device)
    if save:
        out = i2h.new_empty((5, rows, hidden))
        next_h, saved = out[0], out[1:]
    else:
        next_h = out = i2h.new_empty((rows, hidden))
        saved = None
    err = _lib.launch_packed(
        i2h, _lib.library().mxt_gru_cell_f32, _PACK_FWD, i2h.data_ptr(),
        h_prev.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else 0, out.data_ptr(),
        saved.data_ptr() if save else 0, rows, hidden)
    _lib.check(err, "gru_cell")
    LAUNCHES.inc()
    return next_h, saved


def gru_cell_bwd(dnext_h, saved, h_prev, weight):
    """Gradients ``(di2h, dh2h, dh_prev)`` of one cell step from the output
    gradient (None: zero), the planes the forward saved, ``h_prev`` and the
    recurrent weight; ``dh_prev`` is the whole gradient of the state.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise :class:`MXNetError`, as :func:`gru_cell`.
    """
    if not saved.is_cuda:
        if saved.device.type in ("cpu", "meta"):
            return gru_cell_bwd_plain(dnext_h, saved, h_prev, weight)
        raise MXNetError(f"gru_cell_bwd: no kernel for device {saved.device}")
    shape = saved.shape
    if len(shape) != 3 or shape[0] != 4:
        raise MXNetError(f"gru_cell_bwd: saved planes must be (4, N, H), got "
                         f"{tuple(shape)}")
    rows, hidden = shape[1], shape[2]
    state = (rows, hidden)
    dev = saved.get_device()
    f32 = torch.float32
    ok = saved.dtype is f32 and saved.is_contiguous()
    for t, want in ((h_prev, state), (weight, (3 * hidden, hidden)),
                    (dnext_h, state)):
        ok = ok and (t is None or (
            t.dtype is f32 and t.is_contiguous() and t.get_device() == dev
            and t.shape == want))
    if not ok or h_prev is None or weight is None:
        raise _lib.refusal("gru_cell_bwd", [
            ("saved", saved, shape), ("h_prev", h_prev, state),
            ("weight", weight, (3 * hidden, hidden)),
            ("dnext_h", dnext_h, state)], saved.device)
    out = saved.new_empty((7, rows, hidden))
    di2h, dh2h = out[:6].view(2, rows, 3 * hidden)
    dh_prev = out[6]
    err = _lib.launch_packed(
        saved, _lib.library().mxt_gru_cell_bwd_f32, _PACK_BWD,
        dnext_h.data_ptr() if dnext_h is not None else 0, saved.data_ptr(),
        h_prev.data_ptr(), weight.data_ptr(), di2h.data_ptr(),
        dh2h.data_ptr(), dh_prev.data_ptr(), rows, hidden)
    _lib.check(err, "gru_cell_bwd")
    BWD_LAUNCHES.inc()
    return di2h, dh2h, dh_prev


class GRUCellFn(torch.autograd.Function):
    """One training cell step, the recurrent product included: forward
    :func:`gru_cell`, backward :func:`gru_cell_bwd` and the weight's and
    bias's gradients by ``torch.mm``/``sum``. Returns ``next_h``."""

    @staticmethod
    def forward(ctx, i2h, h_prev, weight, bias):
        next_h, saved = gru_cell(i2h, h_prev, weight, bias)
        ctx.save_for_backward(saved, h_prev, weight)
        ctx.has_bias = bias is not None
        # an output no later step consumes comes back as None
        ctx.set_materialize_grads(False)
        return next_h

    @staticmethod
    def backward(ctx, dnext_h):
        saved, h_prev, weight = ctx.saved_tensors
        if dnext_h is not None:
            dnext_h = dnext_h.contiguous()
        di2h, dh2h, dh_prev = gru_cell_bwd(dnext_h, saved, h_prev, weight)
        need = ctx.needs_input_grad
        dh2h = dh2h.to(h_prev.dtype)
        dweight = torch.mm(dh2h.t(), h_prev) if need[2] else None
        dbias = dh2h.sum(0) if ctx.has_bias and need[3] else None
        return di2h, dh_prev, dweight, dbias
