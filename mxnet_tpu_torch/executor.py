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
``MXNET_NONFINITE_GUARD`` select on the device. The NHWC,
rematerialisation, device-placement and rng branches of the reference
interpreter, training windows (``n_steps > 1``), small-parameter packing
and CUDA-graph capture of the step are not yet ported.

Where XLA would fuse a BatchNorm into the ReLU that consumes it, the
interpreter routes the pair to the ``bn_act`` kernel (and in training its
backward to ``bn_act_bwd``) with the ReLU fused: a BatchNorm whose visible
output has exactly one consumer, an ``Activation(act_type="relu")``, runs
with ``relu=True`` and the Activation passes that value through. Any other
BatchNorm runs with ``relu=False`` and its consumers run as written.

In the same way the gate chain of an LSTM cell step (``LSTMCell.__call__``
unrolled: ``_plus(FC, FC)`` -> ``SliceChannel(4)`` -> three sigmoids and a
tanh, with an optional ``_plus_scalar`` forget bias -> ``next_c = f * c +
i * g`` -> ``next_h = o * tanh(next_c)``) runs as one ``lstm_cell`` launch,
and in training its backward as one ``lstm_cell_bwd``, when none of its
intermediates has a consumer outside the chain: ``next_c`` and ``next_h``
take the places of their nodes, the other nodes of the chain run nothing.

Two routes serve SSD's head. A channel ``SoftmaxActivation`` whose only
consumer is a ``MultiBoxDetection`` runs nothing, and the detection reads
its logits: one ``multibox_decode`` launch with the softmax inside, a
stable sort of the scores, and ``nms``. A channel ``L2Normalization`` whose
only consumer is a ``_mul_scalar`` runs nothing, and the ``_mul_scalar``
node runs one ``l2norm_channel`` launch with the scale fused. Any other
graph runs op by op, as written, and the symbol stays as it was built.
A ``MultiBoxPrior`` depends only on its input's shape: the graph computes
its anchors once per shape and device and holds them, unless they are a
head of the graph (a caller may write to an output).
"""

from __future__ import annotations

import functools

import torch

from . import env as _env
from .base import MXNetError, np_dtype
from .context import Context
from .kernels.lstm_cell import LSTMCellFn, lstm_cell
from .kernels.sgd_mom_multi import Guard
from .ndarray import NDArray, ones as nd_ones, zeros as nd_zeros
from .kernels.l2norm_channel import l2norm_channel
from .ops.defs_contrib import detect
from .ops.defs_nn import batch_norm, no_kernel_grad
from .ops.registry import OpMode

_GRAD_REQ = ("null", "write", "add")
_WINDOWS = ("training windows (n_steps > 1, data_stacks, "
            "publish_grads=False) are not yet ported to mxnet_tpu_torch "
            "(ROADMAP.md queue 1 item 2)")


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


def _fused_bn_relu(topo, consumers):
    """``{id(relu node): bn node}`` for every BatchNorm -> Activation(relu)
    pair the interpreter may fuse."""
    fused = {}
    for node in topo:
        if node.is_variable or node.op.name != "Activation":
            continue
        if node.params()["act_type"] != "relu":
            continue
        bn, idx = node.inputs[0]
        if (idx == 0 and not bn.is_variable and bn.op.name == "BatchNorm"
                and not bn.params()["output_mean_var"]
                and consumers.get((id(bn), 0)) == [node]):
            fused[id(node)] = bn
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
    ``l2norm_channel`` launch with the scale fused."""
    (x,) = ins
    no_kernel_grad(x, "L2Normalization(mode='channel')")
    return [l2norm_channel(x, eps, scale)]


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
        consumers = _consumers(symbol, self.topo)
        self.fused = _fused_bn_relu(self.topo, consumers)
        self._fused_bns = {id(bn) for bn in self.fused.values()}
        self.lstm = _fused_lstm(self.topo, consumers)
        self.detection = _fused_producers(
            self.topo, consumers, "MultiBoxDetection", "SoftmaxActivation",
            mode="channel")
        self.l2norm = _fused_producers(
            self.topo, consumers, "_mul_scalar", "L2Normalization",
            mode="channel")
        # nodes that run a fused route: {id(node): (the edges it reads,
        # run(ins, mode) -> outputs)}; the other members of a route run
        # nothing. A fused LSTM step reads the chain's inputs at its next_c
        # node; a fused detection reads the softmax's logits; a fused
        # l2norm reads the normalization's input at its _mul_scalar node
        routes, skip = {}, set()
        for st in self.lstm.values():
            routes[id(st.c_node)] = (st.inputs, st.run)
            routes[id(st.h_node)] = ([(st.c_node, 1)], _pass)
            skip.update(id(m) for m in st.members
                        if m is not st.c_node and m is not st.h_node)
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

    def evaluate(self, arg_vals, aux_vals, is_train):
        """Run the graph. Returns the head outputs."""
        mode = OpMode(is_train=is_train)
        env = {}
        for pos, node in enumerate(self.topo):
            if node.is_variable:
                if node.is_aux:
                    env[id(node)] = [aux_vals[self._aux_index[node.name]]]
                else:
                    env[id(node)] = [arg_vals[self._arg_index[node.name]]]
                continue
            reads = self._reads[id(node)]
            if reads is None:
                continue  # inside a fused LSTM step
            ins = [env[id(inode)][idx] for (inode, idx) in reads]
            if id(node) in self._routes:
                outs, new_aux = self._routes[id(node)][1](ins, mode), []
            elif id(node) in self.fused:
                outs, new_aux = ins, []  # its BatchNorm applied the ReLU
            elif id(node) in self._fused_bns:
                outs, new_aux = batch_norm(ins, node.params(), mode,
                                           relu=True)
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
            for (inode, _idx) in reads:
                if self._last_use[id(inode)] == pos:
                    env.pop(id(inode), None)
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
        self._aux_snapshot = None  # (flat copy, restore pairs) for the guard
        self._guard_dev = None  # device int32 [total, consecutive] skips
        self._update_cache = {}  # the update kernel's device table

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
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {name!r}")
            tgt = self.arg_dict[name]
            src = arr._data if isinstance(arr, NDArray) \
                else torch.as_tensor(arr)
            if tuple(src.shape) != tgt.shape:
                raise MXNetError(
                    f"forward: shape mismatch for {name}: bound {tgt.shape}, "
                    f"got {tuple(src.shape)}")
            tgt._data.copy_(src)
        self._recorded = None
        self._grads_fresh = False
        aux_vals = [self.aux_dict[n]._data for n in self.aux_names]
        if not is_train:
            with torch.inference_mode():
                outs = self.graph.evaluate(
                    [self.arg_dict[n]._data for n in self.arg_names],
                    aux_vals, is_train=False)
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
            outs = self.graph.evaluate(arg_vals, aux_vals, is_train=True)
        self._recorded = (outs, leaves)
        self._outputs = [NDArray(o.detach()) for o in outs]
        return list(self._outputs)

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
                # hand its memory to this step's (stable addresses keep the
                # update kernel's cached table valid)
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
        a :meth:`backward`, in place (reference ``fused_train_update``,
        single step).

        ``apply_fn(weights, grads, states, lrs, wds, ts, cache=, guard=)``
        updates lists of tensors at once (``Optimizer.torch_apply``: one
        launch of the multi-tensor kernel) and returns the new states.
        Under ``MXNET_NONFINITE_GUARD`` a step whose gradients are not all
        finite keeps the old parameters, optimizer state and BatchNorm
        statistics, and advances the device skip counters
        (:meth:`nonfinite_guard_stats`). Training windows raise
        :class:`MXNetError`."""
        if int(n_steps) != 1 or data_stacks is not None or not publish_grads:
            raise MXNetError(f"fused_train_update: {_WINDOWS}")
        if not self._grads_fresh:
            raise MXNetError(
                "fused_train_update requires a backward() whose gradients "
                "no update has consumed yet")
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
