"""RNN cell toolkit.

A copy of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
``python/mxnet/rnn/rnn_cell.py``): ``RNNCell``/``LSTMCell``/``GRUCell``,
``FusedRNNCell``, ``SequentialRNNCell``, ``BidirectionalCell`` and the
Dropout/Zoneout/Residual modifiers, plus parameter pack/unpack between
fused and unfused layouts. The cells only build symbols.

The port runs every cell as its unrolled graph, as the JAX package does.
Each step of an ``LSTMCell`` is the gate chain that the executor routes to
the hand-written ``lstm_cell``/``lstm_cell_bwd`` kernels; ``RNNCell``,
``ResidualCell``, ``BidirectionalCell`` and ``FusedRNNCell`` (unfused into
the other cells) build from ported ops alone. A cell that needs an op the
port does not have yet (``GRUCell``: ``elemwise_sub``; ``DropoutCell`` and
``ZoneoutCell``: ``Dropout``, ...) raises :class:`MXNetError` naming its
``ROADMAP.md`` item when its symbol is built, before any bind.
"""

from __future__ import annotations

import torch

from .. import symbol
from ..base import MXNetError
from ..ndarray import NDArray, zeros
from ..ops import registry as _reg

# ROADMAP.md items of the ops the other cells need
_ROADMAP = {"elemwise_sub": "queue 1 item 3, the rest of defs_elemwise.py",
            "Dropout": "queue 1 item 12, defs_random.py",
            "ones_like": "queue 1 item 3, the rest of defs_tensor.py",
            "zeros_like": "queue 1 item 3, the rest of defs_tensor.py",
            "where": "queue 1 item 3, the rest of defs_tensor.py"}


def _require_ops(cell, *ops):
    """Raise :class:`MXNetError` naming the ``ROADMAP.md`` item of the
    first op in ``ops`` that the port does not have yet."""
    for op in ops:
        if not _reg.exists(op):
            raise MXNetError(
                f"{type(cell).__name__} needs the op {op!r}, not yet ported "
                f"to mxnet_tpu_torch (ROADMAP.md {_ROADMAP[op]})")


def concatenate(arrays):
    """One NDArray of ``arrays`` joined along axis 0."""
    return NDArray(torch.cat([a._data for a in arrays]))


class RNNParams:
    """Container for hold-and-reuse of cell parameters (reference RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract RNN cell (reference BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        # a cell either owns a fresh parameter container or shares the
        # caller's (weight tying across cells)
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._prefix = prefix
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Create begin-state symbols.

        The reference default is ``sym.zeros`` with batch dim 0, resolved by
        nnvm's bidirectional shape unification. Here shape inference is
        forward-only (jax.eval_shape), so the default creates *Variables* —
        they bind as zero-filled state arguments (list them in Module's
        ``state_names``), which is semantically identical for training and
        lets inference provide their shapes directly. Passing
        ``func=sym.zeros`` with a concrete ``shape`` still works.
        """
        assert not self._modified, (
            "After applying modifier cells (e.g. DropoutCell) the base cell "
            "cannot be called directly. Call the modifier cell instead."
        )
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = f"{self._prefix}begin_state_{self._init_counter}"
            if func is None:
                # carry the partial shape (0 = batch) as a hint; the executor
                # group completes the batch dim at bind time
                state = symbol.Variable(
                    name, shape=(info or {}).get("shape")
                )
            else:
                call_kwargs = dict(kwargs)
                if info is not None:
                    call_kwargs.update(
                        {k: v for k, v in info.items() if k != "__layout__"}
                    )
                state = func(name=name, **call_kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate arrays (reference)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop(f"{self._prefix}{group_name}_weight")
            bias = args.pop(f"{self._prefix}{group_name}_bias")
            for j, gate in enumerate(self._gate_names):
                wname = f"{self._prefix}{group_name}{gate}_weight"
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = f"{self._prefix}{group_name}{gate}_bias"
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = f"{self._prefix}{group_name}{gate}_weight"
                weight.append(args.pop(wname))
                bname = f"{self._prefix}{group_name}{gate}_bias"
                bias.append(args.pop(bname))
            args[f"{self._prefix}{group_name}_weight"] = concatenate(weight)
            args[f"{self._prefix}{group_name}_bias"] = concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll the cell ``length`` steps (reference BaseRNNCell.unroll)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [
                symbol.Variable(f"{input_prefix}t{i}_data") for i in range(length)
            ]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, (
                "unroll doesn't allow grouped symbol as input. Check the layout."
            )
            inputs = symbol.SliceChannel(
                inputs, axis=axis, num_outputs=length, squeeze_axis=1
            )
            inputs = [inputs[i] for i in range(length)]
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs is None:
            merge_outputs = False
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden, name=f"{name}i2h",
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden, name=f"{name}h2h",
        )
        output = self._get_activation(
            i2h + h2h, self._activation, name=f"{name}out"
        )
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
        ]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 4, name=f"{name}i2h",
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 4, name=f"{name}h2h",
        )
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(
            gates, num_outputs=4, name=f"{name}slice",
        )
        in_gate = symbol.Activation(
            slice_gates[0], act_type="sigmoid", name=f"{name}i"
        )
        forget_in = slice_gates[1]
        if self._forget_bias:
            forget_in = forget_in + self._forget_bias
        forget_gate = symbol.Activation(
            forget_in, act_type="sigmoid", name=f"{name}f",
        )
        in_transform = symbol.Activation(
            slice_gates[2], act_type="tanh", name=f"{name}c"
        )
        out_gate = symbol.Activation(
            slice_gates[3], act_type="sigmoid", name=f"{name}o"
        )
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(
            next_c, act_type="tanh", name=f"{name}state"
        )
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW, self._iB, self._hW, self._hB = (
            self.params.get(n)
            for n in ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")
        )

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        _require_ops(self, "elemwise_sub")
        self._counter += 1
        seq_idx = self._counter
        name = f"{self._prefix}t{seq_idx}_"
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 3, name=f"{name}i2h",
        )
        h2h = symbol.FullyConnected(
            data=prev_state_h, weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 3, name=f"{name}h2h",
        )
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name=f"{name}i2h_slice"
        )
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name=f"{name}h2h_slice"
        )
        reset_gate = symbol.Activation(
            i2h_r + h2h_r, act_type="sigmoid", name=f"{name}r_act"
        )
        update_gate = symbol.Activation(
            i2h_z + h2h_z, act_type="sigmoid", name=f"{name}z_act"
        )
        next_h_tmp = symbol.Activation(
            i2h + reset_gate * h2h, act_type="tanh", name=f"{name}h_act"
        )
        next_h = next_h_tmp + update_gate * (prev_state_h - next_h_tmp)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer fused RNN with the reference's single parameter blob.

    Reference FusedRNNCell maps to the cuDNN ``rnn`` op (rnn_cell.py:515);
    here ``unroll`` expands to the equivalent unrolled graph (XLA fuses the
    steps) while keeping the single ``{prefix}parameters`` variable layout so
    fused checkpoints unpack to unfused cells and back identically.
    """

    def __init__(self, num_hidden, num_layers=1, mode="lstm", bidirectional=False,
                 dropout=0.0, get_next_state=False, forget_bias=1.0,
                 prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._mode, self._num_hidden = mode, num_hidden
        self._num_layers, self._bidirectional = num_layers, bidirectional
        self._dropout, self._forget_bias = dropout, forget_bias
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [
            {"shape": (b * self._num_layers, 0, self._num_hidden),
             "__layout__": "LNC"} for _ in range(n)
        ]

    @property
    def _gate_names(self):
        return {
            "rnn_relu": [""], "rnn_tanh": [""],
            "lstm": ["_i", "_f", "_c", "_o"], "gru": ["_r", "_z", "_o"],
        }[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Slice the fused blob into per-layer per-gate arrays (reference
        FusedRNNCell._slice_weights)."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_i2h{gate}_weight"
                    if layer > 0:
                        size = b * lh * lh
                        args[name] = arr[p:p + size].reshape((lh, b * lh))
                    else:
                        size = li * lh
                        args[name] = arr[p:p + size].reshape((lh, li))
                    p += size
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_h2h{gate}_weight"
                    size = lh ** 2
                    args[name] = arr[p:p + size].reshape((lh, lh))
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_i2h{gate}_bias"
                    args[name] = arr[p:p + lh]
                    p += lh
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_h2h{gate}_bias"
                    args[name] = arr[p:p + lh]
                    p += lh
        assert p == arr.size, "Invalid parameters size for FusedRNNCell"
        return args

    def unpack_weights(self, args):
        args = args.copy()
        arr = args.pop(f"{self._prefix}parameters")
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        num_input = int(arr.size // b // h // m - (self._num_layers - 1) * (h + b * h + 2) - h - 2)
        sliced = self._slice_weights(arr, num_input, self._num_hidden)
        args.update((name, nd.copy()) for name, nd in sliced.items())
        return args

    def pack_weights(self, args):
        args = args.copy()
        b = len(self._directions)
        m = self._num_gates
        c = self._gate_names
        h = self._num_hidden
        w0 = args[f"{self._prefix}l0_i2h{c[0]}_weight"]
        num_input = w0.shape[1]
        total = (num_input + h + 2) * h * m * b + \
            (self._num_layers - 1) * m * h * (h + b * h + 2) * b
        arr = zeros((total,), ctx=w0.context, dtype=w0.dtype)
        for name, tensor in self._slice_weights(arr, num_input, h).items():
            tensor[:] = args.pop(name).reshape(tensor.shape)
        args[f"{self._prefix}parameters"] = arr
        return args

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Expand to the unrolled unfused graph using sliced fused weights."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [
                symbol.Variable(f"{input_prefix}t{i}_data") for i in range(length)
            ]
            inputs = [symbol.expand_dims(i, axis=1) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=1)
            axis = 1
        if isinstance(inputs, list):
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
        # Delegate to the unfused stack sharing the fused blob via
        # _slice-compatible naming (weights unpacked at load time).
        stack = self.unfuse()
        return stack.unroll(
            length, inputs=inputs, begin_state=begin_state,
            input_prefix=input_prefix, layout=layout,
            merge_outputs=merge_outputs,
        )

    def unfuse(self):
        """Return the equivalent SequentialRNNCell of unfused cells
        (reference FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="relu", prefix=cell_prefix),
            "rnn_tanh": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="tanh", prefix=cell_prefix),
            "lstm": lambda cell_prefix: LSTMCell(
                self._num_hidden, prefix=cell_prefix,
                forget_bias=self._forget_bias),
            "gru": lambda cell_prefix: GRUCell(
                self._num_hidden, prefix=cell_prefix),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(
                    BidirectionalCell(
                        get_cell(f"{self._prefix}l{i}_"),
                        get_cell(f"{self._prefix}r{i}_"),
                        output_prefix=f"{self._prefix}bi_l{i}_",
                    )
                )
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout, prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (reference SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def reset(self):
        super().reset()
        for cell in getattr(self, "_cells", []):
            cell.reset()

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, (
                "Either specify params for SequentialRNNCell or child cells, not both."
            )
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        out = inputs
        collected = []
        offset = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            width = len(cell.state_info)
            out, st = cell(out, states[offset:offset + width])
            offset += width
            collected.extend(st)
        return out, collected

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        outputs = inputs
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            outputs, states = cell.unroll(
                length, inputs=outputs, begin_state=states,
                layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
            )
            next_states.extend(states)
        return outputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on cell output (reference DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout <= 0:
            return inputs, states
        _require_ops(self, "Dropout")
        return symbol.Dropout(data=inputs, p=self.dropout), states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell
        base_cell._modified = True

    @property
    def params(self):
        # the wrapper owns no parameters of its own
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    # weight (un)packing passes straight through to the wrapped cell
    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), (
            "FusedRNNCell doesn't support zoneout. Use its unfused version instead."
        )
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        _require_ops(self, "Dropout", "ones_like", "zeros_like", "where")
        cell, p_outputs, p_states = (
            self.base_cell, self.zoneout_outputs, self.zoneout_states
        )
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p
        )
        prev_output = self.prev_output if self.prev_output is not None else \
            symbol.zeros_like(next_output)
        output = (
            symbol.where(mask(p_outputs, next_output), next_output, prev_output)
            if p_outputs != 0.0 else next_output
        )
        new_states = (
            [
                symbol.where(mask(p_states, new_s), new_s, old_s)
                for new_s, old_s in zip(next_states, states)
            ]
            if p_states != 0.0 else next_states
        )
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Residual connection around a cell (reference ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over a sequence (reference BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            for cell in (l_cell, r_cell):
                cell.params._params.update(self.params._params)
        for cell in (l_cell, r_cell):
            self.params._params.update(cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll"
        )

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, symbol.Symbol):
            inputs = symbol.SliceChannel(
                inputs, axis=axis, num_outputs=length, squeeze_axis=1
            )
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[: len(l_cell.state_info)],
            layout=layout, merge_outputs=False,
        )
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=False,
        )
        outputs = [
            symbol.Concat(
                l_o, r_o, dim=1, name=f"{self._output_prefix}t{i}",
            )
            for i, (l_o, r_o) in enumerate(
                zip(l_outputs, reversed(r_outputs))
            )
        ]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states
