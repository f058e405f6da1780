"""Executor — binds a Symbol to arrays and runs its forward, eagerly.

Counterpart of ``mxnet_tpu/executor.py``, forward-only. The JAX executor
traces the bound graph into one jitted XLA program; here
:meth:`_Graph.evaluate` (the interpreter of ``_CompiledGraph.evaluate``)
walks the graph in topological order and runs each op's PyTorch body under
``torch.inference_mode``. The NHWC, rematerialisation, device-placement
and rng branches of the reference interpreter, gradients, training mode
and the fused train update are not yet ported.

Where XLA would fuse an inference BatchNorm into the ReLU that consumes
it, the interpreter routes the pair to the ``bn_act`` kernel with the
ReLU fused: a BatchNorm whose visible output has exactly one consumer, an
``Activation(act_type="relu")``, runs with ``relu=True`` and the
Activation passes that value through. Any other BatchNorm runs with
``relu=False`` and its consumers run as written.
"""

from __future__ import annotations

import torch

from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ops.defs_nn import batch_norm
from .ops.registry import OpMode


def _fused_bn_relu(symbol, topo):
    """``{id(relu node): bn node}`` for every BatchNorm -> Activation(relu)
    pair the interpreter may fuse."""
    consumers = {}
    for node in topo:
        for (inp, idx) in node.inputs:
            consumers.setdefault((id(inp), idx), []).append(node)
    for (node, idx) in symbol._outputs:
        consumers.setdefault((id(node), idx), []).append(None)  # a head
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
        self.fused = _fused_bn_relu(symbol, self.topo)
        self._fused_bns = {id(bn) for bn in self.fused.values()}
        # position of each node's last consumer: an intermediate value is
        # dropped there, so a forward holds its working set, not every
        # activation of the graph
        self._last_use = {}
        for i, node in enumerate(self.topo):
            for (inode, _idx) in node.inputs:
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
            ins = [env[id(inode)][idx] for (inode, idx) in node.inputs]
            if id(node) in self.fused:
                outs = ins  # its BatchNorm already applied the ReLU
            elif id(node) in self._fused_bns:
                outs, _aux = batch_norm(ins, node.params(), mode, relu=True)
            else:
                outs, _aux = node.op.apply(ins, node.params(), mode)
            env[id(node)] = outs
            for (inode, _idx) in node.inputs:
                if self._last_use[id(inode)] == pos:
                    env.pop(id(inode), None)
        return [env[id(node)][idx] for (node, idx) in self.heads]


class Executor:
    """A bound forward computation (reference ``Executor::Bind``).

    ``args``/``aux_states`` are dicts or name-ordered lists of NDArrays.
    Gradients are not yet ported: ``args_grad`` with a ``grad_req`` other
    than ``"null"`` raises :class:`MXNetError`.
    """

    def __init__(self, symbol, ctx, args=None, args_grad=None,
                 grad_req="null", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        if args_grad and grad_req != "null":
            raise MXNetError(
                "Executor: gradients are not yet ported to mxnet_tpu_torch "
                "(bind with grad_req='null')")
        self.graph = _Graph(symbol)
        self.arg_names = self.graph.arg_names
        self.aux_names = self.graph.aux_names
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._norm_arrays(args, self.arg_names, "args")
        self.aux_dict = self._norm_arrays(aux_states, self.aux_names,
                                          "aux_states")
        self._outputs = None

    @staticmethod
    def _norm_arrays(arrays, names, what):
        if arrays is None:
            if names:
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
                raise MXNetError(f"{what}: missing array for {n!r}")
            if not isinstance(arrays[n], NDArray):
                raise MXNetError(f"{what}[{n}] must be NDArray")
            out[n] = arrays[n]
        return out

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("outputs accessed before any forward call")
        return list(self._outputs)

    def forward(self, is_train=False, **kwargs):
        """Write new input values (kwargs) and run the forward pass. The
        kernels are enqueued on the device's current stream; reading an
        output with ``asnumpy`` waits for them."""
        if is_train:
            raise MXNetError("Executor.forward(is_train=True) is not yet "
                             "ported to mxnet_tpu_torch")
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {name!r}")
            tgt = self.arg_dict[name]
            src = arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)
            if tuple(src.shape) != tgt.shape:
                raise MXNetError(
                    f"forward: shape mismatch for {name}: bound {tgt.shape}, "
                    f"got {tuple(src.shape)}")
            tgt._data.copy_(src)
        with torch.inference_mode():
            outs = self.graph.evaluate(
                [self.arg_dict[n]._data for n in self.arg_names],
                [self.aux_dict[n]._data for n in self.aux_names],
                is_train=False)
        self._outputs = [NDArray(o) for o in outs]
        return list(self._outputs)

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
