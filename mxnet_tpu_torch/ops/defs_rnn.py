"""Fused multi-layer RNN operator (``RNN``, alias ``rnn``).

Counterpart of ``mxnet_tpu/ops/defs_rnn.py`` (reference
``src/operator/rnn.cc``, the cuDNN RNN that ``FusedRNNCell`` binds): one
flat parameter blob laid out as ``FusedRNNCell._slice_weights`` cuts it
(every layer's and direction's i2h and h2h weights, then their biases),
``num_layers`` layers, one or two directions, and the modes ``lstm``,
``gru``, ``rnn_tanh`` and ``rnn_relu``.

Inputs: data ``(T, N, C)``, parameters ``(size,)``, state ``(L*D, N, H)``
and, for lstm, state_cell ``(L*D, N, H)``. Outputs: ``(T, N, H*D)`` and
the final states (and cells), visible when ``state_outputs``.

Where the reference scans one jitted step over time (``lax.scan``), the
port computes each layer's input projection for the whole sequence in one
``torch.addmm`` per direction (the reference's ``einsum``) and then runs
the recurrence. In the ``rnn_tanh`` and ``rnn_relu`` modes with ``H <=
SEQ_MAX_HIDDEN`` (928) one ``rnn_seq`` launch runs every step of the
layer, both directions, ``act(xg + (h @ Wh.T + bh))`` (``RNNSeqFn`` in
training, whose backward is one ``rnn_cell_bwd`` launch a step in reverse,
then one ``mm`` for ``dWh`` over every step and one sum for ``dbh``);
wider rnn layers, decided from the shape, keep a Python loop per direction
with one ``rnn_cell`` launch a step (``RNNCellFn`` in training). The
counters ``rnn_op.seq_layers`` and ``rnn_op.step_layers`` count the rnn
layers of each regime. The other modes loop per direction and step: in the
gru mode one ``gru_cell`` launch that computes ``h @ Wh.T + bh`` and the
gates (``GRUCellFn`` in training, whose backward is one ``gru_cell_bwd``
launch plus the weight's and bias's ``mm``/``sum``); in the lstm mode one
``torch.addmm`` for ``h @ Wh.T + bh`` and one ``lstm_cell`` launch
(``LSTMCellFn`` in training; no forget bias, as the op has none). In
training with ``p > 0``, each layer's output but the last, the two
directions joined, goes through one ``dropout`` launch with ``divide``
(``x * kept / keep``, the reference's rounding, ``:176-179``), its bits
from the node's ``OpMode.rng`` with ``stream = 1 + layer``; its backward
draws the same bits again on the gradient (``DivideDropoutFn``).
"""

from __future__ import annotations

import torch

from .. import telemetry as _tm
from ..base import MXNetError, parse_bool, parse_float, parse_int, parse_str
from ..kernels.dropout import DivideDropoutFn
from ..kernels.gru_cell import GRUCellFn, gru_cell
from ..kernels.lstm_cell import LSTMCellFn, lstm_cell
from ..kernels.rnn_cell import (SEQ_MAX_HIDDEN, RNNCellFn, RNNSeqFn,
                                rnn_cell, rnn_seq)
from .registry import Param, register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
# the rnn modes' layers by regime: one rnn_seq launch, or a launch a step
SEQ_LAYERS = _tm.counter("rnn_op.seq_layers")
STEP_LAYERS = _tm.counter("rnn_op.step_layers")


def _rnn_param_size(mode, num_layers, bidirectional, input_size, state_size):
    m = _GATES[mode]
    b = 2 if bidirectional else 1
    h = state_size
    size = 0
    for layer in range(num_layers):
        li = input_size if layer == 0 else h * b
        size += b * (m * h * li + m * h * h)  # i2h + h2h weights
    size += num_layers * b * (2 * m * h)  # biases
    return size


def _slice_rnn_params(arr, mode, num_layers, bidirectional, input_size, h):
    """Views of the blob as ``FusedRNNCell._slice_weights`` cuts it:
    weights (all layers and directions), then biases. Returns per (layer,
    direction) ``[Wi (m*h, li), Wh (m*h, h), bi, bh]``."""
    m = _GATES[mode]
    dirs = 2 if bidirectional else 1
    out = []
    p = 0
    for layer in range(num_layers):
        li = input_size if layer == 0 else h * dirs
        per_dir = []
        for _d in range(dirs):
            wi = arr[p:p + m * h * li].reshape(m * h, li)
            p += m * h * li
            wh = arr[p:p + m * h * h].reshape(m * h, h)
            p += m * h * h
            per_dir.append([wi, wh, None, None])
        out.append(per_dir)
    for layer in range(num_layers):
        for d in range(dirs):
            out[layer][d][2] = arr[p:p + m * h]
            p += m * h
            out[layer][d][3] = arr[p:p + m * h]
            p += m * h
    return out


def _step(mode, xg, hp, cp, wh, bh, train):
    """One time step: ``(next_h, next_c)`` (``next_c`` None but for
    lstm)."""
    if mode == "gru":
        if train:
            return GRUCellFn.apply(xg, hp, wh, bh), None
        return gru_cell(xg, hp, wh, bh, save=False)[0], None
    if mode != "lstm":
        act = "relu" if mode == "rnn_relu" else "tanh"
        if train:
            return RNNCellFn.apply(xg, hp, wh, bh, act), None
        return rnn_cell(xg, hp, wh, bh, act, save=False)[0], None
    h2h = torch.addmm(bh, hp, wh.t())
    if train:
        return LSTMCellFn.apply(xg, h2h, cp, 0.0)
    hn, cn, _act = lstm_cell(xg, h2h, cp, 0.0, save=False)
    return hn, cn


def _run_layer(mode, x, wi, wh, bi, bh, h0, c0, reverse, train):
    """x ``(T, N, li)`` -> outputs ``(T, N, H)``, the last state and cell."""
    steps, n, li = x.shape
    xi = torch.addmm(bi, x.reshape(steps * n, li), wi.t()).view(steps, n, -1)
    hp, cp = h0, c0
    ys = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        hp, cp = _step(mode, xi[t], hp, cp, wh, bh, train)
        ys[t] = hp
    return torch.stack(ys), hp, cp


def _seq_layer(act, x, per_dir, h0s, train, h_last):
    """One rnn_tanh/rnn_relu layer, every direction in one ``rnn_seq``
    launch; appends the last states and returns the layer's output."""
    steps, n, li = x.shape
    x2 = x.reshape(steps * n, li)
    xis = [torch.addmm(bi, x2, wi.t()).view(steps, n, -1)
           for wi, _wh, bi, _bh in per_dir]
    whs = [p[1] for p in per_dir]
    bhs = [p[3] for p in per_dir]
    if train:
        ys = RNNSeqFn.apply(act, len(per_dir), *xis, *whs, *bhs, *h0s)
    else:
        ys = rnn_seq(xis, whs, bhs, h0s, act)
    # direction 1 runs from the last step down: its last state is step 0's
    h_last += [ys[0, -1]] + ([ys[1, 0]] if len(per_dir) == 2 else [])
    return ys[0] if len(per_dir) == 1 else torch.cat(tuple(ys), dim=-1)


def _rnn(ins, params, mode_ctx):
    mode = params["mode"]
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r} (one of "
                         f"{sorted(_GATES)})")
    num_layers = params["num_layers"]
    h = params["state_size"]
    bidir = params["bidirectional"]
    is_lstm = mode == "lstm"
    if is_lstm:
        data, parameters, state, state_cell = ins
    else:
        (data, parameters, state), state_cell = ins, None
    train = mode_ctx.is_train and torch.is_grad_enabled()
    _steps, _n, c = data.shape
    dirs = 2 if bidir else 1
    layers = _slice_rnn_params(parameters, mode, num_layers, bidir, c, h)
    x = data
    h_last, c_last = [], []
    seq = mode.startswith("rnn") and h <= SEQ_MAX_HIDDEN
    if mode.startswith("rnn") and data.device.type != "meta":
        (SEQ_LAYERS if seq else STEP_LAYERS).inc(num_layers)
    for layer in range(num_layers):
        if seq:
            x = _seq_layer(
                "relu" if mode == "rnn_relu" else "tanh", x, layers[layer],
                [state[layer * dirs + d].contiguous() for d in range(dirs)],
                train, h_last)
        else:
            x = _layer_by_steps(mode, x, layers[layer], state, state_cell,
                                layer, dirs, train, h_last, c_last)
        if (params["p"] > 0 and mode_ctx.is_train
                and layer < num_layers - 1):
            if mode_ctx.rng is None:
                raise MXNetError("RNN: dropout between layers in training "
                                 "needs OpMode.rng")
            key, step, serial = mode_ctx.rng
            x = DivideDropoutFn.apply(x.contiguous(), params["p"], key, step,
                                      serial, 1 + layer)
    outputs = [x, torch.stack(h_last)]
    if is_lstm:
        outputs.append(torch.stack(c_last))
    return outputs


def _layer_by_steps(mode, x, per_dir, state, state_cell, layer, dirs, train,
                    h_last, c_last):
    """One layer as a loop per direction and step; appends the last states
    (and cells) and returns the layer's output."""
    is_lstm = mode == "lstm"
    outs = []
    for d in range(dirs):
        wi, wh, bi, bh = per_dir[d]
        sidx = layer * dirs + d
        c0 = state_cell[sidx].contiguous() if is_lstm else None
        ys, ht, ct = _run_layer(mode, x, wi, wh, bi, bh,
                                state[sidx].contiguous(), c0, d == 1, train)
        outs.append(ys)
        h_last.append(ht)
        if is_lstm:
            c_last.append(ct)
    return outs[0] if dirs == 1 else torch.cat(outs, dim=-1)


def _rnn_args(p):
    args = ["data", "parameters", "state"]
    if p["mode"] == "lstm":
        args.append("state_cell")
    return args


def _rnn_fill(shapes, params):
    data = shapes[0]
    if data is None:
        return shapes
    _t, n, c = data
    h = params["state_size"]
    layers = params["num_layers"]
    dirs = 2 if params["bidirectional"] else 1
    if shapes[1] is None:
        shapes[1] = (_rnn_param_size(params["mode"], layers,
                                     params["bidirectional"], c, h),)
    if shapes[2] is None:
        shapes[2] = (layers * dirs, n, h)
    if params["mode"] == "lstm" and shapes[3] is None:
        shapes[3] = (layers * dirs, n, h)
    return shapes


register(
    "RNN",
    _rnn,
    arg_names=_rnn_args,
    param_schema={
        "state_size": Param(parse_int),
        "num_layers": Param(parse_int),
        "mode": Param(parse_str),
        "bidirectional": Param(parse_bool, False),
        "p": Param(parse_float, 0.0),
        "state_outputs": Param(parse_bool, False),
        "pkeep_": Param(parse_float, None),
        "lstm_q_": Param(parse_bool, None),
    },
    fill_in_shapes=_rnn_fill,
    need_rng=True,
    num_outputs=lambda p: 3 if p["mode"] == "lstm" else 2,
    num_visible_outputs=lambda p: (
        (3 if p["mode"] == "lstm" else 2) if p["state_outputs"] else 1
    ),
    aliases=("rnn",),
)
