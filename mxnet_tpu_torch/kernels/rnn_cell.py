"""``rnn_cell`` and ``rnn_cell_bwd``: one whole vanilla-RNN cell step,
forward and backward, the recurrent product included; ``rnn_seq``: every
step of one layer of the ``RNN`` op's rnn modes, both directions, in one
launch.

Replace one step of ``RNNCell.__call__`` from its h2h ``FullyConnected``
on (``mxnet_tpu/rnn/rnn_cell.py:202-217``; the same arithmetic as the
rnn_tanh/rnn_relu scan body of ``mxnet_tpu/ops/defs_rnn.py``
``_run_layer``, :126-134) and its VJP::

    next_h = act(i2h + (h_prev @ Wh.T + bh)),  act = tanh or relu

The executor routes the unrolled subgraph of each cell step, the h2h
``FullyConnected`` with it, here (``executor._fused_rnn``); the ``RNN``
op's rnn_tanh and rnn_relu modes run each layer as one ``rnn_seq`` launch
(layers wider than :data:`SEQ_MAX_HIDDEN` one ``rnn_cell`` launch a step)
and step back through ``rnn_cell_bwd`` (``ops/defs_rnn.py``).

Bound on the H100: bytes, 237.6 KB forward and 262.4 KB backward at N =
32, H = 200 (0.071 and 0.078 us at 3.35 TB/s); in practice a launch's
fixed costs. ``csrc/rnn_cell.cu`` is ``gru_cell.cu``'s layout with one gate:
tiles of ``h_prev`` and ``Wh`` in shared memory by the copy engine (bulk
and 2D tensor copies), each output's product summed over 16 (forward) or
32 (backward) thread groups added in a fixed order, the activation without
FMA contraction. The backward reads the activation from ``next_h`` (the
forward saves nothing else) and returns ``da``, which is both ``di2h`` and
``dh2h``, and ``dh_prev = da @ Wh``, reading ``Wh`` by columns. ``dWh =
da.T @ h_prev`` and ``dbh = da.sum(0)`` stay ``torch.mm``/``sum`` in
:class:`RNNCellFn`, as the FC's backward computed them. The products sum
in another order than cuBLAS's, so ``next_h`` and ``dh_prev`` may differ
from the plain version's by the rounding of a sum of H products. Both
wrappers take the light launch path (:func:`_lib.launch_packed`); the
backward's outputs are views of one buffer.

``rnn_seq`` (``mxt_rnn_seq_f32``) keeps each CTA's rows of ``Wh`` in shared
memory for the whole sequence, in thread-block clusters that own one
direction and a block of batch rows, and passes each step's state between
the cluster's CTAs through distributed shared memory; per output it sums
in the step kernel's order, so ``ys`` equals T launches of ``rnn_cell``
bit for bit. Bound at (32, 32, 200), one direction: operations, 1.22 us;
the steps run one after another, so a step's latency sets the time.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .lstm_cell import _tanh_grad

# the C entries' packed arguments (csrc/rnn_cell.cu CellArgs, CellBwdArgs):
# pointers, sizes, the activation's code, the stream
_PACK = struct.Struct("=5Q3qQ").pack
# the sequence entries' (SeqArgs): per direction i2h, Wh, bh, h0; ys; T,
# N, H, D, the activation's code; the stream
_SEQ_PACK = struct.Struct("=9Q5qQ").pack
_ACT_CODES = {"tanh": 0, "relu": 1}
# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.rnn_cell.launches")
BWD_LAUNCHES = _tm.counter("kernel.rnn_cell_bwd.launches")
SEQ_LAUNCHES = _tm.counter("kernel.rnn_seq.launches")
# The widest layer the sequence kernel takes on the H100: a CTA of a
# 16-CTA cluster at one batch row holds 4 * (round16(H) + 8) *
# (round2(ceil(H / 16)) + 4) bytes (csrc/rnn_cell.cu seq_smem), 232,128 at
# H = 928, within the card's 232,448 (227 KB); 243,712 at 929. Wider layers
# keep one rnn_cell launch a step; the kernel refuses a layer no plan fits.
SEQ_MAX_HIDDEN = 928


def _act_code(name, act):
    code = _ACT_CODES.get(act)
    if code is None:
        raise MXNetError(f"{name}: act must be 'tanh' or 'relu', got {act!r}")
    return code


def rnn_cell_plain(i2h, h_prev, weight, bias=None, act="tanh"):
    """The plain PyTorch version: ``next_h``."""
    x = i2h + F.linear(h_prev, weight, bias)
    return torch.tanh(x) if act == "tanh" else torch.relu(x)


def rnn_cell_bwd_plain(dnext_h, next_h, h_prev, weight, act="tanh"):
    """The plain PyTorch version of the VJP: ``(da, dh_prev)``, ``da`` the
    gradient of the activation's input (``di2h`` and ``dh2h`` both) taken
    from the output as ``jax.vjp`` takes it (relu: 0 at exactly 0), and
    ``dh_prev = da @ Wh`` in the product's dtype. ``h_prev`` is not read:
    ``dWh = da.T @ h_prev`` is the caller's."""
    g = torch.zeros_like(next_h) if dnext_h is None else dnext_h
    if act == "tanh":
        da = _tanh_grad(g, next_h)
    else:
        da = torch.where(next_h > 0, g, torch.zeros((), dtype=g.dtype,
                                                    device=g.device))
    return da, torch.mm(da.to(weight.dtype), weight)


def rnn_cell(i2h, h_prev, weight, bias=None, act="tanh", save=True):
    """One vanilla-RNN cell step from the input projection ``i2h`` ``(N,
    H)``, the previous state ``h_prev`` ``(N, H)``, the recurrent weight
    ``(H, H)`` and bias ``(H,)`` (None: no bias), ``act`` ``"tanh"`` or
    ``"relu"``: ``(next_h, saved)``, ``saved`` what :func:`rnn_cell_bwd`
    reads (``next_h`` itself) or None unless ``save``.

    CPU (and shape-only ``meta``) tensors take the plain version. CUDA
    tensors launch the kernel, which takes contiguous float32 tensors on
    one device; anything else raises :class:`MXNetError`.
    """
    code = _act_code("rnn_cell", act)
    if not i2h.is_cuda:
        if i2h.device.type in ("cpu", "meta"):
            next_h = rnn_cell_plain(i2h, h_prev, weight, bias, act)
            return next_h, next_h if save else None
        raise MXNetError(f"rnn_cell: no kernel for device {i2h.device}")
    shape = i2h.shape
    if len(shape) != 2:
        raise MXNetError(f"rnn_cell: i2h must be (N, H), got {tuple(shape)}")
    rows, hidden = shape
    dev = i2h.get_device()
    f32 = torch.float32
    if not (i2h.dtype is f32 and h_prev.dtype is f32 and weight.dtype is f32
            and i2h.is_contiguous() and h_prev.is_contiguous()
            and weight.is_contiguous() and h_prev.get_device() == dev
            and weight.get_device() == dev and h_prev.shape == shape
            and weight.shape == (hidden, hidden)
            and (bias is None or (
                bias.dtype is f32 and bias.is_contiguous()
                and bias.get_device() == dev and bias.shape == (hidden,)))):
        raise _lib.refusal("rnn_cell", [
            ("i2h", i2h, shape), ("h_prev", h_prev, shape),
            ("weight", weight, (hidden, hidden)), ("bias", bias, (hidden,))],
            i2h.device)
    next_h = i2h.new_empty(shape)
    err = _lib.launch_packed(
        i2h, _lib.library().mxt_rnn_cell_f32, _PACK, i2h.data_ptr(),
        h_prev.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else 0, next_h.data_ptr(), rows,
        hidden, code)
    _lib.check(err, "rnn_cell")
    LAUNCHES.inc()
    return next_h, next_h if save else None


def rnn_cell_bwd(dnext_h, next_h, h_prev, weight, act="tanh"):
    """Gradients ``(da, dh_prev)`` of one cell step from the output
    gradient (None: zero), the step's output, ``h_prev`` and the recurrent
    weight: ``da`` is the gradient of the activation's input, and so of
    ``i2h`` and of the h2h product both; ``dh_prev`` is the whole gradient
    of the state. The kernel does not read ``h_prev``; it is checked as the
    operand of the caller's ``dWh = da.T @ h_prev``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise :class:`MXNetError`, as :func:`rnn_cell`.
    """
    code = _act_code("rnn_cell_bwd", act)
    if not next_h.is_cuda:
        if next_h.device.type in ("cpu", "meta"):
            return rnn_cell_bwd_plain(dnext_h, next_h, h_prev, weight, act)
        raise MXNetError(f"rnn_cell_bwd: no kernel for device "
                         f"{next_h.device}")
    shape = next_h.shape
    if len(shape) != 2:
        raise MXNetError(f"rnn_cell_bwd: next_h must be (N, H), got "
                         f"{tuple(shape)}")
    rows, hidden = shape
    dev = next_h.get_device()
    f32 = torch.float32
    ok = next_h.dtype is f32 and next_h.is_contiguous()
    for t, want in ((h_prev, shape), (weight, (hidden, hidden)),
                    (dnext_h, shape)):
        ok = ok and (t is None or (
            t.dtype is f32 and t.is_contiguous() and t.get_device() == dev
            and t.shape == want))
    if not ok or h_prev is None or weight is None:
        raise _lib.refusal("rnn_cell_bwd", [
            ("next_h", next_h, shape), ("h_prev", h_prev, shape),
            ("weight", weight, (hidden, hidden)),
            ("dnext_h", dnext_h, shape)], next_h.device)
    out = next_h.new_empty((2, rows, hidden))
    da, dh_prev = out
    err = _lib.launch_packed(
        next_h, _lib.library().mxt_rnn_cell_bwd_f32, _PACK,
        dnext_h.data_ptr() if dnext_h is not None else 0, next_h.data_ptr(),
        weight.data_ptr(), da.data_ptr(), dh_prev.data_ptr(), rows, hidden,
        code)
    _lib.check(err, "rnn_cell_bwd")
    BWD_LAUNCHES.inc()
    return da, dh_prev


class RNNCellFn(torch.autograd.Function):
    """One training cell step, the recurrent product included: forward
    :func:`rnn_cell`, backward :func:`rnn_cell_bwd` and the weight's and
    bias's gradients by ``torch.mm``/``sum``. Returns ``next_h``."""

    @staticmethod
    def forward(ctx, i2h, h_prev, weight, bias, act):
        next_h, _saved = rnn_cell(i2h, h_prev, weight, bias, act, save=False)
        ctx.save_for_backward(next_h, h_prev, weight)
        ctx.act = act
        ctx.has_bias = bias is not None
        # an output no later step consumes comes back as None
        ctx.set_materialize_grads(False)
        return next_h

    @staticmethod
    def backward(ctx, dnext_h):
        next_h, h_prev, weight = ctx.saved_tensors
        if dnext_h is not None:
            dnext_h = dnext_h.contiguous()
        da, dh_prev = rnn_cell_bwd(dnext_h, next_h, h_prev, weight, ctx.act)
        need = ctx.needs_input_grad
        dh2h = da.to(h_prev.dtype)
        dweight = torch.mm(dh2h.t(), h_prev) if need[2] else None
        dbias = dh2h.sum(0) if ctx.has_bias and need[3] else None
        return da, dh_prev, dweight, dbias, None


def rnn_seq_plain(xis, weights, biases, h0s, act="tanh"):
    """The plain version of :func:`rnn_seq`: per direction a loop of
    :func:`rnn_cell_plain` (direction 1 from the last step down), ``ys``
    ``(D, T, N, H)``."""
    out = []
    for d, (xi, w, b, h) in enumerate(zip(xis, weights, biases, h0s)):
        steps = xi.shape[0]
        ys = [None] * steps
        for t in (range(steps - 1, -1, -1) if d == 1 else range(steps)):
            h = rnn_cell_plain(xi[t], h, w, b, act)
            ys[t] = h
        out.append(torch.stack(ys))
    return torch.stack(out)


def _seq_args(xis, weights, biases, h0s, code, ys):
    """The packed pointers and sizes of the sequence entries (direction 1's
    pointers repeat direction 0's for one direction)."""
    dirs = len(xis)

    def ptrs(ts):
        got = [t.data_ptr() if t is not None else 0 for t in ts]
        return got + got[:1] * (2 - dirs)

    steps, rows, hidden = xis[0].shape
    return (*ptrs(xis), *ptrs(weights), *ptrs(biases), *ptrs(h0s),
            ys.data_ptr(), steps, rows, hidden, dirs, code)


def _seq_check(xis, weights, biases, h0s, act):
    """The activation's code; raises :class:`MXNetError` unless the inputs
    are one or two directions of contiguous float32 tensors of one shape
    on one CUDA device, ``hidden`` within :data:`SEQ_MAX_HIDDEN`."""
    code = _act_code("rnn_seq", act)
    dirs = len(xis)
    if not 1 <= dirs <= 2 or not (len(weights) == len(biases) == len(h0s)
                                  == dirs):
        raise MXNetError(f"rnn_seq: one or two directions, each with i2h, "
                         f"weight, bias and h0; got {len(xis)}, "
                         f"{len(weights)}, {len(biases)}, {len(h0s)}")
    shape = xis[0].shape
    if len(shape) != 3:
        raise MXNetError(f"rnn_seq: i2h must be (T, N, H), got "
                         f"{tuple(shape)}")
    _steps, rows, hidden = shape
    if hidden > SEQ_MAX_HIDDEN:
        raise MXNetError(f"rnn_seq: H = {hidden} is past the sequence "
                         f"kernel's {SEQ_MAX_HIDDEN}; wider layers run a "
                         f"step a launch (rnn_cell)")
    device = xis[0].device
    args = []
    for d in range(dirs):
        args += [(f"i2h[{d}]", xis[d], shape),
                 (f"weight[{d}]", weights[d], (hidden, hidden)),
                 (f"bias[{d}]", biases[d], (hidden,)),
                 (f"h0[{d}]", h0s[d], (rows, hidden))]
    f32 = torch.float32
    if not all(arg.startswith("bias") if t is None else (
            t.dtype is f32 and t.is_contiguous() and t.device == device
            and t.shape == want) for arg, t, want in args):
        raise _lib.refusal("rnn_seq", args, device)
    return code


def rnn_seq(xis, weights, biases, h0s, act="tanh"):
    """Every step of one layer of the ``RNN`` op's rnn_tanh/rnn_relu modes,
    for one or two directions at once: per direction ``d`` the input
    projection ``xis[d]`` ``(T, N, H)``, the recurrent weight ``(H, H)``,
    its bias ``(H,)`` (None: no bias) and the first state ``(N, H)``;
    direction 1 runs from ``t = T - 1`` down to 0. Returns ``ys`` ``(D, T,
    N, H)``, ``ys[d, t]`` the state after step ``t``; the last state is
    ``ys[0, T - 1]`` forward and ``ys[1, 0]`` backward.

    CPU (and shape-only ``meta``) tensors take the plain version. CUDA
    tensors launch ``mxt_rnn_seq_f32`` once, for contiguous float32 tensors
    on one device with ``H <= SEQ_MAX_HIDDEN``; anything else raises
    :class:`MXNetError`, and so does a launch the card refuses.
    """
    first = xis[0]
    if not first.is_cuda:
        if first.device.type == "meta":
            _act_code("rnn_seq", act)
            return first.new_empty((len(xis), *first.shape))
        if first.device.type == "cpu":
            _act_code("rnn_seq", act)
            return rnn_seq_plain(xis, weights, biases, h0s, act)
        raise MXNetError(f"rnn_seq: no kernel for device {first.device}")
    code = _seq_check(xis, weights, biases, h0s, act)
    ys = first.new_empty((len(xis), *first.shape))
    if first.shape[0] == 0:
        return ys
    err = _lib.launch_packed(first, _lib.library().mxt_rnn_seq_f32,
                             _SEQ_PACK,
                             *_seq_args(xis, weights, biases, h0s, code, ys))
    _lib.check(err, "rnn_seq")
    SEQ_LAUNCHES.inc()
    return ys


class RNNSeqFn(torch.autograd.Function):
    """One training layer of the ``RNN`` op's rnn modes, both directions:
    ``apply(act, dirs, *xis, *weights, *biases, *h0s)`` returns ``ys``
    ``(D, T, N, H)`` by :func:`rnn_seq`. The backward runs
    :func:`rnn_cell_bwd` a step, in the reverse of each direction's order,
    and then forms ``dWh`` as one ``torch.mm`` of every step's ``da``
    against its ``h_prev`` (T * N rows) and ``dbh`` as one sum."""

    @staticmethod
    def forward(ctx, act, dirs, *args):
        xis, weights, biases, h0s = (args[k * dirs:(k + 1) * dirs]
                                     for k in range(4))
        ys = rnn_seq(xis, weights, biases, h0s, act)
        ctx.save_for_backward(ys, *weights, *h0s)
        ctx.act, ctx.dirs = act, dirs
        ctx.has_bias = [b is not None for b in biases]
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, *rest = ctx.saved_tensors
        dirs = ctx.dirs
        weights, h0s = rest[:dirs], rest[dirs:]
        need = ctx.needs_input_grad[2:]
        dys = dys.contiguous()
        steps, rows, hidden = ys.shape[1:]
        grads = [None] * (4 * dirs)
        for d in range(dirs):
            # direction 0 runs t = 0 .. T-1, direction 1 t = T-1 .. 0; hp[t]
            # is step t's h_prev, and the backward walks the other way
            h0 = h0s[d][None]
            if d == 0:
                hp, order = torch.cat((h0, ys[0, :-1])), range(steps - 1,
                                                                -1, -1)
            else:
                hp, order = torch.cat((ys[1, 1:], h0)), range(steps)
            das = [None] * steps
            dh = None
            for t in order:
                g = dys[d, t] if dh is None else dys[d, t] + dh
                das[t], dh = rnn_cell_bwd(g, ys[d, t], hp[t], weights[d],
                                          ctx.act)
            da = torch.stack(das).view(steps * rows, hidden)
            grads[d] = da.view(steps, rows, hidden)
            if need[dirs + d]:
                grads[dirs + d] = torch.mm(da.t(),
                                           hp.view(steps * rows, hidden))
            if ctx.has_bias[d] and need[2 * dirs + d]:
                grads[2 * dirs + d] = da.sum(0)
            grads[3 * dirs + d] = dh
        return (None, None, *grads)
