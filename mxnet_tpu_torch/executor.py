"""Executor — binds a Symbol to arrays and runs it eagerly: forward,
backward and the fused training update.

Counterpart of ``mxnet_tpu/executor.py``. The JAX executor traces the
bound graph into one jitted XLA program per step; here
:meth:`_Graph.evaluate` (the interpreter of ``_CompiledGraph.evaluate``)
walks the graph in topological order and runs each op's PyTorch body:
under ``torch.inference_mode`` at inference, under autograd in training.
``forward(is_train=True)`` records the graph (BatchNorm updates its moving
statistics then, once per forward, as the reference does), ``backward()``
differentiates it at once — loss heads drive it without ``out_grads``, as
``_head_loss_flags`` has it — and ``fused_train_update`` applies the
optimizer to every parameter in one multi-tensor kernel launch, with the
``MXNET_NONFINITE_GUARD`` select on the device. A training window
(``fused_train_update(n_steps=K)``) runs K such steps in a row, eagerly:
where the reference loops inside one XLA program, the port enqueues each
step's forward, backward and update launches on the stream, with no host
wait between them. ``set_monitor_callback`` and ``partial_forward`` run
the graph op by op as written, as the reference's interpret mode does;
``reshape`` and ``debug_str`` are the reference's. The NHWC,
rematerialisation and device-placement branches of the reference
interpreter and small-parameter packing are not yet ported; CUDA-graph
capture of the step is a later performance change (``ROADMAP.md``).

Where XLA would fuse a BatchNorm into the (leaky) ReLU that consumes it,
the interpreter routes the pair to the ``bn_act`` kernel (and in training
its backward to ``bn_act_bwd``) with the activation fused: a BatchNorm
whose visible output has exactly one consumer, an
``Activation(act_type="relu")`` (slope 0) or a
``LeakyReLU(act_type="leaky", slope=s)`` with ``s >= 0``, runs with
the activation at that slope and the activation passes that value through.
A negative slope keeps the two ops apart (the backward reads the sign from
the output, which a negative slope flips). Any other BatchNorm runs
without an activation and its consumers run as written.

In the same way the gate chain of an LSTM cell step (``LSTMCell.__call__``
unrolled: ``_plus(FC, FC)`` -> ``SliceChannel(4)`` -> three sigmoids and a
tanh, with an optional ``_plus_scalar`` forget bias -> ``next_c = f * c +
i * g`` -> ``next_h = o * tanh(next_c)``) runs as one ``lstm_cell`` launch,
and in training its backward as one ``lstm_cell_bwd``, when none of its
intermediates has a consumer outside the chain: ``next_c`` and ``next_h``
take the places of their nodes, the other nodes of the chain run nothing.
A GRU cell step (``GRUCell.__call__`` unrolled: the h2h
``FullyConnected`` of ``h_prev`` -> two ``SliceChannel(3)`` of the i2h and
h2h outputs -> ``r`` and ``z`` as sigmoids of the slices' sums -> ``o =
tanh(i2h_o + r * h2h_o)`` -> ``next_h = o + z * (h_prev - o)``) runs as one
``gru_cell`` launch, the recurrent product inside it, and in training its
backward as one ``gru_cell_bwd``, under the same rule and when the h2h FC
(the one under the slice whose output 2 feeds ``r * h2h_o``) has
``flatten=True``, reads the same ``h_prev`` edge the ``_minus`` reads, and
feeds nothing but that slice: the FC runs nothing and ``next_h`` takes the
place of its node. Any other GRU chain runs op by op. A vanilla-RNN cell
step (``RNNCell.__call__`` unrolled: ``Activation(act_type="tanh" or
"relu")`` over the ``_plus`` of the i2h and h2h ``FullyConnected``
outputs) runs as one ``rnn_cell`` launch, the recurrent product inside it,
and in training its backward as one ``rnn_cell_bwd``, when the ``_plus``
feeds the activation alone and the second operand's FC, the h2h one, has
``flatten=True`` and feeds the ``_plus`` alone: the first operand's output
is the ready ``i2h``, the h2h FC and the ``_plus`` run nothing and
``next_h`` takes the place of the activation's node. Any other activation
or chain runs op by op, and so does a matched step whose h2h FC turns out
at run time not to map an ``(N, H)`` state to ``(N, H)`` (then it is not a
recurrent step).

Two routes serve SSD's head. A channel ``SoftmaxActivation`` whose only
consumer is a ``MultiBoxDetection`` runs nothing, and the detection reads
its logits: one ``multibox_decode`` launch with the softmax inside, a
stable sort of the scores, and ``nms``. A channel ``L2Normalization`` whose
only consumer is a ``_mul_scalar`` runs nothing, and the ``_mul_scalar``
node runs one ``l2norm_channel`` launch with the scale fused (in training,
and its backward one ``l2norm_channel_bwd``). SSD's training symbol feeds
``MultiBoxDetection`` the probabilities of a ``SoftmaxOutput``, so the
detection route does not fire there and the detection reads them
detached. Any other graph runs op by op, as written, and the symbol stays
as it was built.
A ``MultiBoxPrior`` depends only on its input's shape: the graph computes
its anchors once per shape and device and holds them, unless they are a
head of the graph (a caller may write to an output).

Random ops (``need_rng``: ``Dropout``, the ``RNN`` op) draw counter-based
bits, as the reference folds keys (``mxnet_tpu/executor.py:251-258, 449-453,
1189``): each executor takes a key from :func:`random.next_key` at bind,
each ``need_rng`` node a serial in topological order, and every
``forward`` advances the step count, training or not (a window's steps
each run one). A random node runs with ``OpMode.rng = (key, step,
serial)``; the key and step reach the kernel by value, so nothing is
uploaded and the host never waits.
"""

from __future__ import annotations

import functools

import torch

from . import env as _env
from . import random as _random
from .base import MXNetError, np_dtype
from .context import Context
from .kernels.gru_cell import GRUCellFn, gru_cell
from .kernels.lstm_cell import LSTMCellFn, lstm_cell
from .kernels.rnn_cell import RNNCellFn, rnn_cell
from .kernels.sgd_mom_multi import Guard
from .ndarray import NDArray, ones as nd_ones, zeros as nd_zeros
from .ops.defs_contrib import detect
from .ops.defs_nn import _ACTS, _castp, batch_norm, l2norm_channel_op
from .ops.registry import OpMode

_GRAD_REQ = ("null", "write", "add")


class _Unpublished:
    """Stands in for a gradient a training window ran with
    ``publish_grads=False``: the array keeps its shape, dtype and device,
    and any read of its values raises :class:`MXNetError` until a
    publishing step writes the gradient again. The window frees the last
    step's gradient tensors early (the reference dead-codes their
    publication out of its program)."""

    __slots__ = ("name", "shape", "dtype", "device")

    def __init__(self, name, tensor):
        self.name = name
        self.shape = tensor.shape
        self.dtype = tensor.dtype
        self.device = tensor.device

    def numel(self):
        return self.shape.numel()

    def dim(self):
        return len(self.shape)

    def __getattr__(self, attr):
        raise MXNetError(
            f"gradient '{self.name}' was not published: the last training "
            "window ran with publish_grads=False. Run train_window(..., "
            "publish_grads=True) or a single step to read per-step "
            "gradients.")


def _consumers(symbol, topo):
    """``{(id(node), output index): [consumer nodes]}``; a graph head
    counts as a consumer ``None``."""
    consumers = {}
    for node in topo:
        for (inp, idx) in node.inputs:
            consumers.setdefault((id(inp), idx), []).append(node)
    for (node, idx) in symbol._outputs:
        consumers.setdefault((id(node), idx), []).append(None)  # a head
    return consumers


def _fused_slope(node):
    """The slope of a fusable activation node (0.0 for the ReLU), or None
    when ``node`` is neither a ReLU nor a LeakyReLU with a slope >= 0."""
    if _is_op(node, "Activation", act_type="relu"):
        return 0.0
    if _is_op(node, "LeakyReLU", act_type="leaky"):
        slope = node.params()["slope"]
        return slope if slope >= 0 else None
    return None


def _fused_bn_relu(topo, consumers):
    """``{id(activation node): (bn node, slope)}`` for every BatchNorm ->
    Activation(relu) or LeakyReLU(leaky, slope >= 0) pair the interpreter
    may fuse."""
    fused = {}
    for node in topo:
        slope = _fused_slope(node)
        if slope is None:
            continue
        bn, idx = node.inputs[0]
        if (idx == 0 and _is_op(bn, "BatchNorm", output_mean_var=False)
                and consumers.get((id(bn), 0)) == [node]):
            fused[id(node)] = (bn, slope)
    return fused


def _is_op(node, name, **params):
    """True when ``node`` runs op ``name`` with these parameter values."""
    if node is None or node.is_variable or node.op.name != name:
        return False
    p = node.params()
    return all(p[k] == v for k, v in params.items())


class _LSTMStep:
    """One LSTM cell step's gate chain: ``inputs`` are the ``(node, index)``
    edges of ``i2h``, ``h2h`` and ``c_prev``; ``c_node`` (the ``next_c``
    add) runs the fused step and holds ``[next_c, next_h]``, ``h_node``
    (the ``next_h`` multiply) passes ``next_h`` on; ``members`` are the
    chain's nodes."""

    def __init__(self, inputs, forget_bias, c_node, h_node, members):
        self.inputs = inputs
        self.forget_bias = forget_bias
        self.c_node = c_node
        self.h_node = h_node
        self.members = members

    def run(self, ins, mode):
        """``[next_c, next_h]`` of the step, through the cell kernels (their
        wrappers check the shapes and types)."""
        i2h, h2h, c_prev = ins
        if mode.is_train and torch.is_grad_enabled():
            next_h, next_c = LSTMCellFn.apply(i2h, h2h, c_prev,
                                              self.forget_bias)
        else:
            next_h, next_c, _act = lstm_cell(i2h, h2h, c_prev,
                                             self.forget_bias, save=False)
        return [next_c, next_h]


class _GRUStep:
    """One GRU cell step, its h2h product included: ``inputs`` are the
    ``(node, index)`` edges of ``i2h``, ``h_prev``, the h2h weight and (when
    the FC has one) its bias; ``h_node`` (the ``next_h`` add) runs the fused
    step; ``members`` are the step's nodes, the h2h FC among them."""

    def __init__(self, inputs, h_node, members):
        self.inputs = inputs
        self.h_node = h_node
        self.members = members

    @staticmethod
    def run(ins, mode):
        """``[next_h]`` of the step, through the cell kernels (their
        wrappers check the shapes and types)."""
        i2h, h_prev, weight = ins[:3]
        bias = ins[3] if len(ins) > 3 else None
        # as the FC casts its parameters to the activations' dtype
        weight, bias = _castp(weight, h_prev), _castp(bias, h_prev)
        if mode.is_train and torch.is_grad_enabled():
            return [GRUCellFn.apply(i2h, h_prev, weight, bias)]
        return [gru_cell(i2h, h_prev, weight, bias, save=False)[0]]


class _RNNStep:
    """One vanilla-RNN cell step, its h2h product included: ``inputs`` are
    the ``(node, index)`` edges of ``i2h``, ``h_prev``, the h2h weight and
    (when the FC has one) its bias; ``act`` is ``"tanh"`` or ``"relu"``;
    ``h_node`` (the activation) runs the fused step; ``members`` are the
    step's nodes, the h2h FC among them."""

    def __init__(self, inputs, act, h_node, members):
        self.inputs = inputs
        self.act = act
        self.h_node = h_node
        self.members = members

    def run(self, ins, mode):
        """``[next_h]`` of the step, through the cell kernels (their
        wrappers check the types)."""
        i2h, h_prev, weight = ins[:3]
        bias = ins[3] if len(ins) > 3 else None
        # as the FC casts its parameters to the activations' dtype
        weight, bias = _castp(weight, h_prev), _castp(bias, h_prev)
        if (i2h.dim() != 2 or h_prev.shape != i2h.shape
                or weight.shape != (i2h.shape[1], i2h.shape[1])):
            # the h2h FC does not map an (N, H) state to (N, H): not a
            # recurrent step, so the chain as written
            h2h = torch.nn.functional.linear(
                h_prev.reshape(h_prev.shape[0], -1), weight, bias)
            return [_ACTS[self.act](i2h + h2h)]
        if mode.is_train and torch.is_grad_enabled():
            return [RNNCellFn.apply(i2h, h_prev, weight, bias, self.act)]
        return [rnn_cell(i2h, h_prev, weight, bias, self.act, save=False)[0]]


def _pass(ins, mode):
    """``next_h`` of a fused LSTM step, which its ``next_c`` node made."""
    return ins


def _run_detection(params, ins, mode):
    """``SoftmaxActivation(mode="channel")`` -> ``MultiBoxDetection`` as one
    detection step (``defs_contrib.detect`` on the logits)."""
    cls_logits, loc_pred, anchors = ins
    return [detect(cls_logits, loc_pred, anchors, params, softmax=True)]


def _run_l2norm(eps, scale, ins, mode):
    """``L2Normalization(mode="channel")`` -> ``_mul_scalar`` as one
    ``l2norm_channel`` launch with the scale fused (in training, its
    backward one ``l2norm_channel_bwd``)."""
    (x,) = ins
    return [l2norm_channel_op(x, eps, scale)]


def _fused_lstm(topo, consumers):
    """``{id(next_c node): _LSTMStep}`` for every LSTM gate chain the
    interpreter may fuse: the chain of ``LSTMCell.__call__`` from the
    ``_plus`` of two ``FullyConnected`` outputs to ``next_h``, whose
    intermediates feed nothing outside it."""

    def sole(node, idx=0):
        use = consumers.get((id(node), idx), [])
        return use[0] if len(use) == 1 else None

    def other(node, known):
        """The input edge of binary ``node`` that is not ``(known, 0)``."""
        edges = list(node.inputs)
        if (known, 0) not in edges:
            return None
        edges.remove((known, 0))
        return edges[0]

    steps = {}
    for sl in topo:
        if not _is_op(sl, "SliceChannel", num_outputs=4, axis=1,
                      squeeze_axis=False):
            continue
        gates, gidx = sl.inputs[0]
        if gidx or not _is_op(gates, "_plus") or sole(gates) is not sl:
            continue
        if not all(idx == 0 and _is_op(fc, "FullyConnected", flatten=True)
                   for fc, idx in gates.inputs):
            continue
        acts, members, forget_bias = [], [gates, sl], 0.0
        for k, act_type in enumerate(("sigmoid", "sigmoid", "tanh",
                                      "sigmoid")):
            a = sole(sl, k)
            if k == 1 and _is_op(a, "_plus_scalar"):
                forget_bias = a.params()["scalar"]
                members.append(a)
                a = sole(a)
            if not _is_op(a, "Activation", act_type=act_type):
                break
            acts.append(a)
        if len(acts) != 4:
            continue
        i_act, f_act, g_act, o_act = acts
        mul_fc, mul_ig, mul_h = sole(f_act), sole(i_act), sole(o_act)
        if not (_is_op(mul_fc, "_mul") and _is_op(mul_ig, "_mul")
                and _is_op(mul_h, "_mul") and sole(g_act) is mul_ig
                and other(mul_ig, i_act) == (g_act, 0)):
            continue
        c_prev = other(mul_fc, f_act)
        c_node = sole(mul_fc)
        if (c_prev is None or not _is_op(c_node, "_plus")
                or sole(mul_ig) is not c_node
                or other(c_node, mul_fc) != (mul_ig, 0)):
            continue
        tanh_c = other(mul_h, o_act)
        if (tanh_c is None or tanh_c[1]
                or not _is_op(tanh_c[0], "Activation", act_type="tanh")
                or tanh_c[0].inputs != [(c_node, 0)]
                or sole(tanh_c[0]) is not mul_h):
            continue
        members += acts + [mul_fc, mul_ig, c_node, tanh_c[0], mul_h]
        if c_prev[0] in members:
            continue
        steps[id(c_node)] = _LSTMStep(
            list(gates.inputs) + [c_prev], forget_bias, c_node, mul_h,
            members)
    return steps


def _fused_gru(topo, consumers):
    """``{id(next_h node): _GRUStep}`` for every GRU cell step the
    interpreter may fuse: the chain of ``GRUCell.__call__`` from the h2h
    ``FullyConnected`` of ``h_prev`` and the two ``SliceChannel(3)`` to
    ``next_h``, whose intermediates (the h2h FC's output among them) feed
    nothing outside it."""

    def sole(node, idx=0):
        use = consumers.get((id(node), idx), [])
        return use[0] if len(use) == 1 else None

    def slice_of(edge, k):
        """The SliceChannel(3) of a FullyConnected output that ``edge``
        reads as output ``k``, or None."""
        sl, idx = edge
        if idx != k or not _is_op(sl, "SliceChannel", num_outputs=3, axis=1,
                                  squeeze_axis=False):
            return None
        fc, fidx = sl.inputs[0]
        return sl if fidx == 0 and _is_op(fc, "FullyConnected",
                                          flatten=True) else None

    def gate(act, k):
        """``(i2h slice, h2h slice, sum)`` of a sigmoid gate over the sum
        of output ``k`` of two slices, either order, or None."""
        if not _is_op(act, "Activation", act_type="sigmoid"):
            return None
        add, idx = act.inputs[0]
        if idx or not _is_op(add, "_plus") or sole(add) is not act:
            return None
        a, b = (slice_of(e, k) for e in add.inputs)
        return (a, b, add) if a is not None and b is not None else None

    steps = {}
    for o in topo:
        if not _is_op(o, "Activation", act_type="tanh"):
            continue
        add_o, idx = o.inputs[0]
        if idx or not _is_op(add_o, "_plus") or sole(add_o) is not o:
            continue
        # i2h_o + r * h2h_o, the product on either side
        edges = list(add_o.inputs)
        mul_o = next((n for n, i in edges if i == 0 and _is_op(n, "_mul")),
                     None)
        if mul_o is None or sole(mul_o) is not add_o:
            continue
        edges.remove((mul_o, 0))
        sl_i = slice_of(edges[0], 2)
        r_act = next((n for n, i in mul_o.inputs if i == 0
                      and _is_op(n, "Activation", act_type="sigmoid")), None)
        if sl_i is None or r_act is None or sole(r_act) is not mul_o:
            continue
        rest = list(mul_o.inputs)
        rest.remove((r_act, 0))
        sl_h = slice_of(rest[0], 2)
        r_gate = gate(r_act, 0)
        if (sl_h is None or sl_h is sl_i or r_gate is None
                or {r_gate[0], r_gate[1]} != {sl_i, sl_h}):
            continue
        # o feeds h_prev - o and o + z * (h_prev - o), nothing else
        uses = consumers.get((id(o), 0), [])
        sub = next((n for n in uses if _is_op(n, "_minus")
                    and n.inputs[1] == (o, 0)), None)
        if sub is None or len(uses) != 2:
            continue
        h_node = next((n for n in uses if n is not sub), None)
        mul_z = sole(sub)
        if (not _is_op(mul_z, "_mul") or not _is_op(h_node, "_plus")
                or sole(mul_z) is not h_node
                or sorted(i for _n, i in h_node.inputs) != [0, 0]
                or {n for n, _i in h_node.inputs} != {o, mul_z}):
            continue
        z_act = next((n for n, i in mul_z.inputs if i == 0 and n is not sub),
                     None)
        z_gate = gate(z_act, 1)
        if (z_gate is None or sole(z_act) is not mul_z
                or {z_gate[0], z_gate[1]} != {sl_i, sl_h}):
            continue
        if not all(sole(sl, k) is want for sl, k, want in (
                (sl_i, 0, r_gate[2]), (sl_h, 0, r_gate[2]),
                (sl_i, 1, z_gate[2]), (sl_h, 1, z_gate[2]),
                (sl_i, 2, add_o), (sl_h, 2, mul_o))):
            continue
        # the h2h FC: over the same h_prev edge, its output into sl_h alone
        fc = sl_h.inputs[0][0]
        h_prev = sub.inputs[0]
        if (fc.inputs[0] != h_prev
                or consumers.get((id(fc), 0)) != [sl_h]):
            continue
        members = [fc, sl_i, sl_h, r_gate[2], r_act, z_gate[2], z_act, mul_o,
                   add_o, o, sub, mul_z, h_node]
        if h_prev[0] in members:
            continue
        steps[id(h_node)] = _GRUStep(
            [sl_i.inputs[0], h_prev] + list(fc.inputs[1:]), h_node, members)
    return steps


def _fused_rnn(topo, consumers):
    """``{id(activation node): _RNNStep}`` for every vanilla-RNN cell step
    the interpreter may fuse: ``RNNCell.__call__``'s ``Activation(tanh or
    relu)`` over ``_plus(i2h FC, h2h FC)``, whose ``_plus`` and h2h FC
    output feed nothing outside the step."""
    steps = {}
    for act in topo:
        if not (_is_op(act, "Activation", act_type="tanh")
                or _is_op(act, "Activation", act_type="relu")):
            continue
        add, idx = act.inputs[0]
        if (idx or not _is_op(add, "_plus")
                or consumers.get((id(add), 0)) != [act]):
            continue
        (i2h, i_idx), (fc, f_idx) = add.inputs
        if (i_idx or f_idx or not _is_op(i2h, "FullyConnected")
                or not _is_op(fc, "FullyConnected", flatten=True)
                or consumers.get((id(fc), 0)) != [add]):
            continue
        steps[id(act)] = _RNNStep([add.inputs[0]] + list(fc.inputs),
                                  act.params()["act_type"], act,
                                  [fc, add, act])
    return steps


def _fused_producers(topo, consumers, op, producer, **params):
    """``{id(node): (node, producer node)}`` for every node running ``op``
    whose first input is the only use of a ``producer`` op's output with
    these parameter values: the SSD routes (a channel
    ``SoftmaxActivation`` into ``MultiBoxDetection``, a channel
    ``L2Normalization`` into ``_mul_scalar``)."""
    fused = {}
    for node in topo:
        if not _is_op(node, op):
            continue
        prod, idx = node.inputs[0]
        if (idx == 0 and _is_op(prod, producer, **params)
                and consumers.get((id(prod), 0)) == [node]):
            fused[id(node)] = (node, prod)
    return fused


def _head_loss_flags(graph):
    """Which graph heads are loss outputs (drive an implicit backward)."""
    return [not node.is_variable and node.op.is_loss
            for (node, _ix) in graph.heads]


def nonfinite_guard_on():
    """True when ``MXNET_NONFINITE_GUARD`` asks for the guard."""
    return str(_env.get("MXNET_NONFINITE_GUARD") or "").lower() in (
        "skip", "rollback", "raise")


class _Graph:
    """The symbol as an interpretable op list."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.topo = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self._arg_index = {n: i for i, n in enumerate(self.arg_names)}
        self._aux_index = {n: i for i, n in enumerate(self.aux_names)}
        self.heads = symbol._outputs
        # serials of the random nodes, in topological order
        self.rng_serial = {}
        for node in self.topo:
            if not node.is_variable and node.op.need_rng:
                self.rng_serial[id(node)] = len(self.rng_serial)
        consumers = _consumers(symbol, self.topo)
        self.fused = _fused_bn_relu(self.topo, consumers)
        self._fused_bns = {id(bn): slope for bn, slope in self.fused.values()}
        self.lstm = _fused_lstm(self.topo, consumers)
        self.gru = _fused_gru(self.topo, consumers)
        self.rnn = _fused_rnn(self.topo, consumers)
        self.detection = _fused_producers(
            self.topo, consumers, "MultiBoxDetection", "SoftmaxActivation",
            mode="channel")
        self.l2norm = _fused_producers(
            self.topo, consumers, "_mul_scalar", "L2Normalization",
            mode="channel")
        # nodes that run a fused route: {id(node): (the edges it reads,
        # run(ins, mode) -> outputs)}; the other members of a route run
        # nothing. A fused LSTM step reads the chain's inputs at its next_c
        # node, a fused GRU step at its next_h node, a fused RNN step at its
        # activation node; a fused detection
        # reads the softmax's logits; a fused l2norm reads the
        # normalization's input at its _mul_scalar node
        routes, skip = {}, set()
        for st in self.lstm.values():
            routes[id(st.c_node)] = (st.inputs, st.run)
            routes[id(st.h_node)] = ([(st.c_node, 1)], _pass)
            skip.update(id(m) for m in st.members
                        if m is not st.c_node and m is not st.h_node)
        for st in (*self.gru.values(), *self.rnn.values()):
            routes[id(st.h_node)] = (st.inputs, st.run)
            skip.update(id(m) for m in st.members if m is not st.h_node)
        for det, sm in self.detection.values():
            routes[id(det)] = ([sm.inputs[0]] + list(det.inputs[1:]),
                               functools.partial(_run_detection,
                                                 det.params()))
            skip.add(id(sm))
        for mul, l2 in self.l2norm.values():
            routes[id(mul)] = ([l2.inputs[0]], functools.partial(
                _run_l2norm, l2.params()["eps"], mul.params()["scalar"]))
            skip.add(id(l2))
        self._routes = routes
        heads = {id(node) for (node, _idx) in self.heads}
        self._shape_consts = {id(node) for node in self.topo
                              if _is_op(node, "MultiBoxPrior")
                              and id(node) not in heads}
        self._const_vals = {}
        self._reads = {}
        for node in self.topo:
            if id(node) in skip:
                self._reads[id(node)] = None
            elif id(node) in routes:
                self._reads[id(node)] = routes[id(node)][0]
            else:
                self._reads[id(node)] = node.inputs
        # position of each node's last reader: an intermediate value is
        # dropped there, so a forward holds its working set, not every
        # activation of the graph
        self._last_use = {}
        for i, node in enumerate(self.topo):
            for (inode, _idx) in self._reads[id(node)] or ():
                self._last_use[id(inode)] = i
        for (node, _idx) in self.heads:
            self._last_use[id(node)] = len(self.topo)

    def evaluate(self, arg_vals, aux_vals, is_train, device=None,
                 monitor=None, monitor_all=False, limit=None, rng=None):
        """Run the graph on ``device`` (where an op without inputs places
        its output). Returns the head outputs. ``rng`` is the executor's
        ``(key, step)``: each random node runs with ``(key, step,
        serial)``.

        With ``monitor`` (a callback ``(name, tensor)``) or ``limit`` every
        op runs as written, no fused route (the reference's interpret
        mode): ``monitor`` sees each op node's visible outputs as
        ``<node>_output`` (``<node>_output<i>`` past the first) and, with
        ``monitor_all``, each variable's value under its own name;
        ``limit`` runs only the first ``limit`` op nodes and returns the
        last one's outputs (``partial_forward``)."""
        mode = OpMode(is_train=is_train, device=device)
        plain = monitor is not None or limit is not None
        env = {}
        executed, last = 0, []
        for pos, node in enumerate(self.topo):
            if node.is_variable:
                if node.is_aux:
                    env[id(node)] = [aux_vals[self._aux_index[node.name]]]
                else:
                    env[id(node)] = [arg_vals[self._arg_index[node.name]]]
                if monitor is not None and monitor_all:
                    monitor(node.name, env[id(node)][0])
                continue
            if limit is not None and executed >= limit:
                break
            reads = node.inputs if plain else self._reads[id(node)]
            if reads is None:
                continue  # inside a fused cell step
            ins = [env[id(inode)][idx] for (inode, idx) in reads]
            serial = self.rng_serial.get(id(node))
            if serial is not None and rng is not None:
                node_mode = OpMode(is_train=is_train, device=device,
                                   rng=(rng[0], rng[1], serial))
                outs, new_aux = node.op.apply(ins, node.params(), node_mode)
            elif plain:
                outs, new_aux = node.op.apply(ins, node.params(), mode)
            elif id(node) in self._routes:
                outs, new_aux = self._routes[id(node)][1](ins, mode), []
            elif id(node) in self.fused:
                outs, new_aux = ins, []  # its BatchNorm applied the ReLU
            elif id(node) in self._fused_bns:
                outs, new_aux = batch_norm(ins, node.params(), mode,
                                           slope=self._fused_bns[id(node)])
            elif id(node) in self._shape_consts:
                outs, new_aux = self._shape_const(node, ins, mode), []
            else:
                outs, new_aux = node.op.apply(ins, node.params(), mode)
            # an op's new aux values land in the aux arrays (BatchNorm
            # writes its moving statistics in place and returns them)
            n_args = len(node.inputs) - len(new_aux)
            for (inode, idx), value in zip(node.inputs[n_args:], new_aux):
                held = env[id(inode)][idx]
                if value is not held:
                    held.copy_(value)
            env[id(node)] = outs
            executed, last = executed + 1, outs
            if monitor is not None:
                nvis = node.op.num_visible_outputs(node.params())
                for i, o in enumerate(outs[:nvis]):
                    monitor(node.name + ("_output" if i == 0
                                         else f"_output{i}"), o)
            if plain:
                continue  # a debugging run keeps every value
            for (inode, _idx) in reads:
                if self._last_use[id(inode)] == pos:
                    env.pop(id(inode), None)
        if limit is not None:
            return list(last)
        return [env[id(node)][idx] for (node, idx) in self.heads]

    def _shape_const(self, node, ins, mode):
        """The outputs of a node that depends only on its inputs' shapes,
        computed on the first call for these shapes and devices and held."""
        key = (id(node),) + tuple((tuple(t.shape), str(t.device))
                                  for t in ins)
        outs = self._const_vals.get(key)
        if outs is None:
            # plain tensors even inside inference_mode, so a training
            # forward of the same graph may read them too
            with torch.inference_mode(False), torch.no_grad():
                outs, _aux = node.op.apply(ins, node.params(), mode)
            self._const_vals[key] = outs
        return outs


class Executor:
    """A bound computation (reference ``Executor::Bind``).

    ``args``/``args_grad``/``aux_states`` are dicts or name-ordered lists of
    NDArrays; ``grad_req`` is ``"write"``, ``"add"`` or ``"null"``, one for
    all or per argument. An argument with a request but no gradient array
    gets ``"null"``, as in the reference.
    """

    def __init__(self, symbol, ctx, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self.graph = _Graph(symbol)
        self.arg_names = self.graph.arg_names
        self.aux_names = self.graph.aux_names
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._norm_arrays(args, self.arg_names, "args")
        self.aux_dict = self._norm_arrays(aux_states, self.aux_names,
                                          "aux_states")
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}
        else:
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        for n, r in self.grad_req.items():
            if r not in _GRAD_REQ:
                raise MXNetError(f"invalid grad_req {r!r} for {n}")
        self.grad_dict = self._norm_arrays(args_grad, self.arg_names,
                                           "args_grad", allow_missing=True)
        for n in self.arg_names:
            if self.grad_req[n] != "null" and n not in self.grad_dict:
                self.grad_req[n] = "null"
        self._outputs = None
        # (head tensors, {name: leaf}) of a training forward
        self._recorded = None
        self._grads_fresh = False  # a backward no update has consumed yet
        self._head_grads = False  # that backward took explicit out_grads
        self._steps_applied = 0  # updates the last fused call applied
        self._monitor_callback = None
        self._monitor_all = False
        self._aux_snapshot = None  # (flat copy, restore pairs) for the guard
        self._guard_dev = None  # device int32 [total, consecutive] skips
        self._update_cache = {}  # the update kernel's packs or table
        self._torch_device = None
        # the random ops' key, taken from the global chain at bind, and the
        # forward count folded in with it
        self.rng_key = _random.next_key()
        self.rng_step = 0

    @staticmethod
    def _norm_arrays(arrays, names, what, allow_missing=False):
        if arrays is None:
            if names and not allow_missing:
                raise MXNetError(f"{what}: expected arrays for {names}")
            return {}
        if not isinstance(arrays, dict):
            arrays = list(arrays)
            if len(arrays) != len(names):
                raise MXNetError(
                    f"{what}: expected {len(names)} arrays, got {len(arrays)}")
            arrays = dict(zip(names, arrays))
        out = {}
        for n in names:
            if n not in arrays or arrays[n] is None:
                if allow_missing:
                    continue
                raise MXNetError(f"{what}: missing array for {n!r}")
            if not isinstance(arrays[n], NDArray):
                raise MXNetError(f"{what}[{n}] must be NDArray")
            out[n] = arrays[n]
        return out

    # ------------------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("outputs accessed before any forward call")
        return list(self._outputs)

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Write new input values (kwargs) and run the forward pass. The
        kernels are enqueued on the device's current stream; reading an
        output with ``asnumpy`` waits for them. With ``is_train`` the
        forward takes batch statistics, updates the BatchNorm moving
        statistics and is recorded for :meth:`backward`."""
        self._write_inputs(kwargs, "forward")
        self._recorded = None
        self._grads_fresh = False
        self.rng_step += 1
        aux_vals = [self.aux_dict[n]._data for n in self.aux_names]
        monitor = {"monitor": self._monitor_callback,
                   "monitor_all": self._monitor_all}
        rng = (self.rng_key, self.rng_step)
        if not is_train:
            with torch.inference_mode():
                outs = self.graph.evaluate(
                    [self.arg_dict[n]._data for n in self.arg_names],
                    aux_vals, is_train=False, device=self._device(),
                    rng=rng, **monitor)
            self._outputs = [NDArray(o) for o in outs]
            return list(self._outputs)
        if nonfinite_guard_on():
            self._snapshot_aux()
        leaves = {}
        arg_vals = []
        for n in self.arg_names:
            t = self.arg_dict[n]._data
            if self.grad_req[n] != "null":
                # a leaf sharing the array's storage: the update writes the
                # array in place, after the backward that reads the leaf
                t = t.detach().requires_grad_(True)
                leaves[n] = t
            arg_vals.append(t)
        with torch.enable_grad():
            outs = self.graph.evaluate(arg_vals, aux_vals, is_train=True,
                                       device=self._device(), rng=rng,
                                       **monitor)
        self._recorded = (outs, leaves)
        self._outputs = [NDArray(o.detach()) for o in outs]
        return list(self._outputs)

    def _write_inputs(self, kwargs, what):
        """Copy new input values into the bound arrays."""
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"{what}: unknown argument {name!r}")
            tgt = self.arg_dict[name]
            src = arr._data if isinstance(arr, NDArray) \
                else torch.as_tensor(arr)
            if tuple(src.shape) != tgt.shape:
                raise MXNetError(
                    f"{what}: shape mismatch for {name}: bound {tgt.shape}, "
                    f"got {tuple(src.shape)}")
            tgt._data.copy_(src)

    def _device(self):
        """The ``torch.device`` of the bound context."""
        if self._torch_device is None:
            self._torch_device = self._ctx.torch_device()
        return self._torch_device

    def _snapshot_aux(self):
        """Copy the aux arrays (BatchNorm moving statistics) into one flat
        buffer kept across steps, for the guard to restore on a skipped
        step."""
        vals = [self.aux_dict[n]._data for n in self.aux_names
                if self.aux_dict[n]._data.dtype == torch.float32]
        if not vals:
            self._aux_snapshot = (None, [])
            return
        total = sum(v.numel() for v in vals)
        flat = self._aux_snapshot[0] if self._aux_snapshot else None
        if (flat is None or flat.numel() != total
                or flat.device != vals[0].device):
            flat = torch.empty(total, device=vals[0].device)
        torch.cat([v.reshape(-1) for v in vals], out=flat)
        pairs, off = [], 0
        for v in vals:
            pairs.append((v, flat[off:off + v.numel()].view(v.shape)))
            off += v.numel()
        self._aux_snapshot = (flat, pairs)

    def backward(self, out_grads=None, is_train=True):
        """Differentiate the recorded training forward (run one first if
        the last forward was not recorded) and write the gradients.

        Without ``out_grads`` the loss heads (SoftmaxOutput, whose backward
        ignores the head gradient) drive the backward and the other heads
        contribute nothing; a graph without a loss head then raises.
        ``grad_req="write"`` gradients take the new values, ``"add"`` adds
        them in place."""
        if self._outputs is None:
            raise MXNetError("backward called before forward")
        if self._recorded is None:
            self.forward(is_train=True)
        outs, leaves = self._recorded
        self._recorded = None
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        flags = _head_loss_flags(self.graph)
        if out_grads is None and not any(flags):
            raise MXNetError(
                "backward() without out_grads requires a loss output "
                "(SoftmaxOutput/...); pass explicit head gradients for plain "
                "outputs")
        heads, head_grads = [], []
        for j, o in enumerate(outs):
            if not o.requires_grad:
                continue
            if out_grads is not None:
                g = out_grads[j]
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                head_grads.append(g.to(o.device, o.dtype))
            elif flags[j]:
                # the loss layer ignores its head gradient
                head_grads.append(torch.ones((), dtype=o.dtype,
                                             device=o.device).expand_as(o))
            else:
                continue
            heads.append(o)
        names = list(leaves)
        for n in names:
            if self.grad_req[n] == "write":
                # release last step's gradient first, so the allocator can
                # hand its memory to this step's (stable addresses keep
                # adam_multi's uploaded gradient pointers valid)
                self.grad_dict[n]._data = None
        grads = [None] * len(names)
        if heads:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        grad_outputs=head_grads,
                                        allow_unused=True)
        for n, g in zip(names, grads):
            if g is None:
                g = torch.zeros_like(leaves[n])
            if self.grad_req[n] == "add":
                self.grad_dict[n]._data.add_(g)
            else:
                self.grad_dict[n]._data = g
        self._grads_fresh = True
        self._head_grads = out_grads is not None

    # --- the fused training update --------------------------------------
    def nonfinite_guard_stats(self):
        """``(total_skips, consecutive_skips)`` of the fused-step guard.
        Reads the device counters — call at sync points, never per batch."""
        if self._guard_dev is None:
            return (0, 0)
        a = self._guard_dev.cpu().numpy()
        return (int(a[0]), int(a[1]))

    def reset_nonfinite_guard(self, keep_total=True):
        """Zero the consecutive-skip counter (or both counters with
        ``keep_total=False``)."""
        if self._guard_dev is None:
            return
        total = self.nonfinite_guard_stats()[0] if keep_total else 0
        self._guard_dev.copy_(torch.tensor([total, 0], dtype=torch.int32))

    def fused_train_update(self, update_names, apply_fn, states, lrs, wds, ts,
                           cache_token=None, n_steps=1, data_stacks=None,
                           publish_grads=True):
        """Apply the optimizer to every parameter in ``update_names`` after
        a :meth:`backward`, in place (reference ``fused_train_update``).

        ``apply_fn(weights, grads, states, lrs, wds, ts, cache=, guard=)``
        updates lists of tensors at once (``Optimizer.torch_apply``: one
        launch of the multi-tensor kernel) and returns the new states.
        Under ``MXNET_NONFINITE_GUARD`` a step whose gradients are not all
        finite keeps the old parameters, optimizer state and BatchNorm
        statistics, and advances the device skip counters
        (:meth:`nonfinite_guard_stats`).

        ``n_steps > 1`` runs a training window: step 0 is the update of the
        pending backward, then each of steps 1..K-1 runs a training
        forward (on slice ``i`` of every ``data_stacks`` entry, else on the
        bound inputs), the backward and the update, so parameters,
        optimizer state, BatchNorm statistics, the guard's snapshot and
        the random generators advance per step. The hyperparameters are
        the window's first step's: ``lrs`` and ``wds`` stay as given and
        step ``i`` takes the counts ``ts + i``. No host wait enters the
        loop. ``data_stacks`` maps input names to ``(n_steps,) + bound
        shape`` arrays, cast to the bound dtype on the device. A window
        needs ``grad_req="write"`` and loss heads (no explicit head
        gradients). The last step's outputs are published and, with
        ``publish_grads``, its gradients; with ``publish_grads=False``
        they are freed and reading them raises :class:`MXNetError` until
        a publishing step runs.
        """
        n_steps = int(n_steps)
        self._steps_applied = 0
        if not self._grads_fresh:
            raise MXNetError(
                "fused_train_update requires a backward() whose gradients "
                "no update has consumed yet")
        if data_stacks and n_steps <= 1:
            raise MXNetError(
                "data_stacks requires a window (n_steps>1); a single step "
                "trains on the bound inputs")
        stacks = {}
        if n_steps > 1:
            if self._head_grads:
                raise MXNetError(
                    "a training window (n_steps>1) drives loss heads only; "
                    "explicit head gradients change per step: run "
                    "single-step updates instead")
            if any(r == "add" for r in self.grad_req.values()):
                raise MXNetError(
                    "a training window requires grad_req='write' (an 'add' "
                    "accumulation carried across window steps would "
                    "double-count); use single-step updates")
            stacks = self._window_stacks(data_stacks or {}, n_steps)
        publish = bool(publish_grads) or n_steps <= 1
        new_states = states
        for i in range(n_steps):
            if i:
                self.forward(is_train=True, **{n: NDArray(v[i])
                                               for n, v in stacks.items()})
                self.backward()
            new_states = self._apply_update(
                update_names, apply_fn, new_states, lrs, wds,
                [t + i for t in ts])
            self._steps_applied += 1
        if not publish:
            for n, r in self.grad_req.items():
                if r == "write" and n in self.grad_dict:
                    arr = self.grad_dict[n]
                    arr._data = _Unpublished(n, arr._data)
        return new_states

    def _window_stacks(self, data_stacks, n_steps):
        """``data_stacks`` checked against the bound inputs and cast to
        their dtypes on their device: ``{name: tensor}``."""
        out = {}
        for name in sorted(data_stacks):
            if name not in self.arg_dict:
                raise MXNetError(
                    f"data_stacks name '{name}' is not a bound input")
            v = data_stacks[name]
            v = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            tgt = self.arg_dict[name]._data
            want = (n_steps,) + tuple(tgt.shape)
            if tuple(v.shape) != want:
                raise MXNetError(
                    f"data_stacks['{name}'] shape {tuple(v.shape)} != "
                    f"(n_steps,)+bound shape {want}")
            out[name] = v.to(device=tgt.device, dtype=tgt.dtype)
        return out

    def _apply_update(self, update_names, apply_fn, states, lrs, wds, ts):
        """One update of the gradients of the pending backward."""
        guard = None
        if nonfinite_guard_on():
            if self._aux_snapshot is None:
                raise MXNetError(
                    "MXNET_NONFINITE_GUARD was turned on after the forward; "
                    "the step has no BatchNorm statistics to restore")
            if self._guard_dev is None:
                self._guard_dev = torch.zeros(
                    2, dtype=torch.int32, device=self._ctx.torch_device())
            guard = Guard(self._guard_dev, self._aux_snapshot[1])
        weights = [self.arg_dict[n]._data for n in update_names]
        grads = [self.grad_dict[n]._data for n in update_names]
        new_states = apply_fn(weights, grads, states, lrs, wds, ts,
                              cache=self._update_cache, guard=guard)
        self._grads_fresh = False
        return new_states

    # --- debugging: the reference's interpret mode ----------------------
    def debug_str(self):
        """The execution plan (reference ``Executor::DebugStr``): the
        graph's nodes in the order the interpreter runs them."""
        mode = ("interpret(monitor)" if self._monitor_callback is not None
                else "eager")
        lines = [f"Symbol outputs: {', '.join(self.output_names)}",
                 f"ctx: {self._ctx}  mode: {mode}"]
        step = 0  # op-node ordinal: the unit partial_forward counts
        for node in self.graph.topo:
            if node.is_variable:
                kind = "aux" if node.is_aux else "var"
                lines.append(f"  [     ] {kind:8s} {node.name}")
                continue
            step += 1
            lines.append(f"  [{step:4d} ] {node.op.name:20s} {node.name}")
        lines.append(f"Total {step} op nodes "
                     f"({len(self.arg_names)} args, "
                     f"{len(self.aux_names)} aux)")
        return "\n".join(lines)

    def partial_forward(self, is_train=False, num_nodes=None, **kwargs):
        """Run the first ``num_nodes`` op nodes (the ordinals
        :meth:`debug_str` prints; all of them when None) op by op as
        written and return the last one's outputs (reference
        ``PartialForward``). ``kwargs`` write new input values as in
        :meth:`forward`. The aux states are read, never written."""
        self._write_inputs(kwargs, "partial_forward")
        if num_nodes is None:
            num_nodes = len(self.graph.topo)
        aux = [self.aux_dict[n]._data.clone() for n in self.aux_names]
        with torch.inference_mode():
            outs = self.graph.evaluate(
                [self.arg_dict[n]._data for n in self.arg_names], aux,
                is_train=is_train, device=self._device(), limit=num_nodes,
                rng=(self.rng_key, self.rng_step))
        return [NDArray(o) for o in outs]

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every op node's output of
        each forward (reference ``MXExecutorSetMonitorCallback``; with
        ``monitor_all``, on every variable's value too). While it is
        installed the graph runs op by op as written, no fused route;
        ``None`` removes it."""
        def _cb(name, arr):
            callback(name, NDArray(arr.detach()))

        self._monitor_callback = _cb if callback is not None else None
        self._monitor_all = bool(monitor_all) and callback is not None

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for the input shapes in ``kwargs`` (reference
        ``Executor.reshape``): arrays whose shape stays are shared, the
        others allocated anew; an argument outside ``kwargs`` whose shape
        changes raises unless ``partial_shaping`` or ``allow_up_sizing``.
        The aux states are shared."""
        arg_shapes, _out, _aux = self._symbol.infer_shape(**kwargs)
        new_args, new_grads = {}, {}
        for n, shape in zip(self.arg_names, arg_shapes):
            shape = tuple(shape)
            cur = self.arg_dict[n]
            if cur.shape == shape:
                new_args[n] = cur
            elif partial_shaping or allow_up_sizing or n in kwargs:
                new_args[n] = nd_zeros(shape, ctx=cur.context,
                                       dtype=cur.dtype)
            else:
                raise MXNetError(
                    f"reshape: shape of {n} changed {cur.shape}->{shape}; "
                    "set partial_shaping=True")
            g = self.grad_dict.get(n)
            if g is not None:
                new_grads[n] = g if g.shape == shape else nd_zeros(
                    shape, ctx=g.context, dtype=g.dtype)
        return Executor(self._symbol, self._ctx, args=new_args,
                        args_grad=new_grads or None, grad_req=self.grad_req,
                        aux_states=self.aux_dict)

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError(
                    f"Found name {name!r} not in executor arguments")
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                arr.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError(f"Found name {name!r} not in aux states")

    def compile(self, kinds=None):
        """Warm the forward before traffic: one forward over the bound
        values, synchronised, so CUDA module loading, cuDNN's algorithm
        choice and the kernel library's build happen here and not behind
        a request. Eager PyTorch has no program to compile ahead of time.
        Returns the kinds warmed."""
        kinds = list(kinds or ["forward"])
        if kinds != ["forward"]:
            raise MXNetError(f"compile: only 'forward' is ported, got {kinds}")
        self.forward(is_train=False)
        if self._ctx.device_type == "gpu":
            torch.cuda.synchronize(self._ctx.torch_device())
        return kinds

    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        """Infer shapes and dtypes from the input shapes in ``kwargs`` and
        allocate every array on ``ctx`` (reference ``simple_bind``):
        arguments, gradients for the arguments ``grad_req`` asks for, aux
        states (``*moving_var`` at 1, the rest at 0). Arrays of
        ``shared_exec`` whose shape matches are shared."""
        ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        arg_shapes, _out, aux_shapes = symbol.infer_shape(**kwargs)
        arg_dtypes, _odt, aux_dtypes = symbol.infer_type(
            **dict(type_dict or {}))
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(grad_req, str):
            req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            req = dict(zip(arg_names, grad_req))
        else:
            req = {n: grad_req.get(n, "null") for n in arg_names}

        def alloc(pool, name, shape, dtype, make=nd_zeros):
            if shared_exec is not None:
                have = getattr(shared_exec, pool).get(name)
                if have is not None and have.shape == tuple(shape):
                    return have
            return make(shape, ctx=ctx, dtype=np_dtype(dtype))

        args, grads = {}, {}
        for n, s, d in zip(arg_names, arg_shapes, arg_dtypes):
            args[n] = alloc("arg_dict", n, s, d)
            if req.get(n, "null") != "null":
                grads[n] = alloc("grad_dict", n, s, d)
        auxs = {}
        for n, s, d in zip(aux_names, aux_shapes, aux_dtypes):
            make = nd_ones if n.endswith(("moving_var", "running_var")) \
                else nd_zeros
            auxs[n] = alloc("aux_dict", n, s, d, make)
        return Executor(symbol, ctx, args=args, args_grad=grads or None,
                        grad_req=req, aux_states=auxs)
