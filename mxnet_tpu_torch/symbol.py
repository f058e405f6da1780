"""Symbol — the symbolic graph IR.

A copy of ``mxnet_tpu/symbol.py`` (host-only): a DAG of ``_Node`` objects
(op + string attrs + input edges), with a ``Symbol`` being an ordered list
of (node, output-index) heads. Composition, naming, shape/dtype inference
at bind time, and MXNet-compatible JSON save/load. The ``sym.<op>``
functions are generated from the port's op registry, so only ported ops
exist; arithmetic sugar other than ``+`` between symbols reaches ops that
are not yet ported and raises :class:`MXNetError`.
"""

from __future__ import annotations

import builtins
import json
import sys

import numpy as np

from .attribute import AttrScope
from .base import MXNetError, np_dtype, string_attrs
from .context import current_context
from .name import NameManager
from .ops import registry as _reg


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux")

    def __init__(self, op, name, attrs=None, inputs=None, is_aux=False):
        self.op = op  # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs or [])  # [(node, out_index)]
        self.is_aux = is_aux

    @property
    def is_variable(self):
        return self.op is None

    def params(self):
        # lenient: node attrs also hold free-form graph attributes (AttrScope
        # user keys, legacy JSON attr sections); strict validation of op
        # kwargs already happened at creation time (_create)
        return self.op.parse_params(self.attrs, strict=False)


class Symbol:
    """An (ordered multi-)output symbolic graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(node, index)]

    # --- graph walking ----------------------------------------------------
    def _topo(self):
        """Topological order of nodes reachable from the heads."""
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for (inode, _idx) in node.inputs:
                visit(inode)
            order.append(node)

        for (node, _idx) in self._outputs:
            visit(node)
        return order

    # --- listing ----------------------------------------------------------
    def list_arguments(self):
        return [n.name for n in self._topo() if n.is_variable and not n.is_aux]

    def list_outputs(self):
        names = []
        for (node, idx) in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                params = node.params()
                nvis = node.op.num_visible_outputs(params)
                if nvis == 1:
                    names.append(f"{node.name}_output")
                else:
                    names.append(f"{node.name}_output{idx}")
        return names

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.is_variable and n.is_aux]

    def list_attr(self, recursive=False):
        if recursive:
            out = {}
            for n in self._topo():
                for k, v in n.attrs.items():
                    out[f"{n.name}_{k}"] = str(v)
            return out
        node = self._outputs[0][0]
        return {k: str(v) for k, v in node.attrs.items()}

    def attr_dict(self):
        out = {}
        for n in self._topo():
            if n.attrs:
                out[n.name] = {k: str(v) for k, v in n.attrs.items()}
        return out

    def attr(self, key):
        node = self._outputs[0][0]
        v = node.attrs.get(key)
        return str(v) if v is not None else None

    def _set_attr(self, **kwargs):
        node = self._outputs[0][0]
        node.attrs.update(kwargs)

    @property
    def name(self):
        if len(self._outputs) != 1:
            return None
        return self._outputs[0][0].name

    # --- composition ------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"cannot find output {index!r} in {names}")
            index = names.index(index)
        if isinstance(index, builtins.slice):
            return Group([Symbol([o]) for o in self._outputs[index]])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def get_internals(self):
        """All intermediate outputs, like reference ``Symbol.get_internals``."""
        outs = []
        for node in self._topo():
            if node.is_variable:
                outs.append((node, 0))
            else:
                nvis = node.op.num_visible_outputs(node.params())
                for i in range(nvis):
                    outs.append((node, i))
        return Symbol(outs)

    def get_children(self):
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol([inp for inp in node.inputs])

    # --- arithmetic sugar -------------------------------------------------
    def _binop(self, other, op_name, scalar_op, reverse_scalar_op=None, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op_name, [a, b], {})
        if isinstance(other, (int, float, np.number)):
            name = reverse_scalar_op if reverse and reverse_scalar_op else scalar_op
            return _create(name, [self], {"scalar": float(other)})
        raise TypeError(f"unsupported operand type {type(other)}")

    def __add__(self, o):
        return self._binop(o, "elemwise_add" if isinstance(o, Symbol) else "", "_plus_scalar")

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar", "_rdiv_scalar", reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, o):
        return self._binop(o, "_power", "_power_scalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    def __eq__(self, o):
        return self._binop(o, "_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binop(o, "_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def __repr__(self):
        name = self.name
        if name is None:
            return f"<Symbol group [{', '.join(self.list_outputs())}]>"
        return f"<Symbol {name}>"

    # --- inference --------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        try:
            res = self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise
        return res

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        shapes = {}  # id(node) -> list of out shapes
        var_shape = {}  # name -> shape
        aux_shape = {}
        for name, s in known.items():
            var_shape[name] = s

        topo = self._topo()
        for node in topo:
            if node.is_variable:
                s = var_shape.get(node.name)
                if s is None and "__shape__" in node.attrs:
                    from .base import parse_shape

                    s = parse_shape(node.attrs["__shape__"])
                    if s is not None and 0 in s:
                        # partial hint (0 = unknown batch, reference 0-dim
                        # convention); needs completion by the binder
                        s = None
                    else:
                        var_shape[node.name] = s
                shapes[id(node)] = [s]
                continue
            params = node.params()
            in_shapes = []
            for (inode, idx) in node.inputs:
                s_list = shapes.get(id(inode))
                in_shapes.append(s_list[idx] if s_list else None)
            try:
                arg_shapes, out_shapes, aux_shapes_n = node.op.infer_shape(
                    in_shapes, params
                )
            except MXNetError:
                if partial:
                    shapes[id(node)] = [None] * node.op.num_outputs(params)
                    continue
                raise
            completed = list(arg_shapes) + list(aux_shapes_n)
            for (inode, _idx), s in zip(node.inputs, completed):
                if inode.is_variable and s is not None:
                    if inode.is_aux:
                        aux_shape[inode.name] = s
                    else:
                        prev = var_shape.get(inode.name)
                        if prev is not None and tuple(prev) != tuple(s):
                            raise MXNetError(
                                f"shape mismatch for {inode.name}: {prev} vs {s}"
                            )
                        var_shape[inode.name] = s
                    shapes[id(inode)] = [s]
            shapes[id(node)] = list(out_shapes)

        arg_res = [var_shape.get(n) for n in self.list_arguments()]
        aux_res = [aux_shape.get(n) for n in self.list_auxiliary_states()]
        out_res = []
        for (node, idx) in self._outputs:
            s_list = shapes.get(id(node))
            out_res.append(s_list[idx] if s_list else None)
        if not partial and any(s is None for s in arg_res):
            missing = [
                n for n, s in zip(self.list_arguments(), arg_res) if s is None
            ]
            raise MXNetError(
                f"infer_shape: cannot determine shapes of {missing}; "
                "provide more input shapes"
            )
        return arg_res, out_res, aux_res

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, dt in zip(arg_names, args):
                if dt is not None:
                    known[name] = np_dtype(dt)
        known.update({k: np_dtype(v) for k, v in kwargs.items() if v is not None})

        dtypes = {}
        var_dtype = dict(known)
        aux_dtype = {}
        for node in self._topo():
            if node.is_variable:
                d = var_dtype.get(node.name)
                if d is None and "__dtype__" in node.attrs:
                    d = np_dtype(node.attrs["__dtype__"])
                    var_dtype[node.name] = d
                dtypes[id(node)] = [d]
                continue
            params = node.params()
            in_dtypes = []
            for (inode, idx) in node.inputs:
                d_list = dtypes.get(id(inode))
                in_dtypes.append(d_list[idx] if d_list else None)
            arg_d, out_d, aux_d = node.op.infer_dtype(in_dtypes, params)
            completed = list(arg_d) + list(aux_d)
            for (inode, _i), d in zip(node.inputs, completed):
                if inode.is_variable and d is not None:
                    if inode.is_aux:
                        aux_dtype[inode.name] = d
                    else:
                        var_dtype.setdefault(inode.name, d)
                    dtypes[id(inode)] = [d]
            dtypes[id(node)] = list(out_d)

        arg_res = [var_dtype.get(n, np_dtype("float32")) for n in self.list_arguments()]
        aux_res = [aux_dtype.get(n, np_dtype("float32")) for n in self.list_auxiliary_states()]
        out_res = []
        for (node, idx) in self._outputs:
            d_list = dtypes.get(id(node))
            out_res.append(d_list[idx] if d_list else np_dtype("float32"))
        return arg_res, out_res, aux_res

    # --- save / load ------------------------------------------------------
    def tojson(self):
        """Serialize to MXNet-style graph JSON (nodes/arg_nodes/heads)."""
        topo = self._topo()
        node_ids = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        arg_nodes = []
        for i, n in enumerate(topo):
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [
                    [node_ids[id(inode)], idx, 0] for (inode, idx) in n.inputs
                ],
            }
            attrs = string_attrs(n.attrs)
            if attrs:
                entry["attrs"] = attrs
            if n.is_aux:
                entry["attrs"] = dict(entry.get("attrs", {}), __is_aux__="true")
            nodes.append(entry)
            if n.is_variable:
                arg_nodes.append(i)
        heads = [[node_ids[id(n)], idx, 0] for (n, idx) in self._outputs]
        return json.dumps(
            {
                "nodes": nodes,
                "arg_nodes": arg_nodes,
                "heads": heads,
                "attrs": {"mxnet_version": ["int", 1001]},
            },
            indent=2,
        )

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self):
        lines = []
        for n in self._topo():
            if n.is_variable:
                lines.append(f"Variable:{n.name}")
            else:
                ins = ", ".join(f"{i.name}[{x}]" for (i, x) in n.inputs)
                lines.append(f"Op:{n.op.name}, Name={n.name}, Inputs: [{ins}]")
        return "\n".join(lines)

    # --- binding ----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        """Infer shapes from the input shapes in ``kwargs``, allocate every
        array on ``ctx`` (default: the current context) and bind."""
        from .executor import Executor

        return Executor.simple_bind(
            self, ctx or current_context(), grad_req=grad_req,
            type_dict=type_dict, shared_exec=shared_exec, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind to an :class:`~mxnet_tpu_torch.executor.Executor` on ``ctx``
        (default: the current context)."""
        from .executor import Executor

        return Executor(
            self,
            ctx or current_context(),
            args=args,
            args_grad=args_grad,
            grad_req=grad_req,
            aux_states=aux_states,
        )

    def eval(self, ctx=None, **kwargs):
        exe = self.bind(ctx or current_context(), args=kwargs)
        return exe.forward()

    # --- misc -------------------------------------------------------------
    def grad(self, wrt):
        raise MXNetError(
            "Symbol.grad was deprecated in the reference; bind with "
            "args_grad and call backward instead"
        )


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a variable symbol (reference ``mx.sym.Variable``)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
    node_attrs = dict(attr or {})
    if shape is not None:
        node_attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        node_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node_attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        node_attrs["__dtype__"] = np_dtype(dtype).name
    if init is not None:
        if not isinstance(init, str):
            init = init.dumps()
        node_attrs["__init__"] = init
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            node_attrs[k] = str(v)
        else:
            raise ValueError(f"Variable {name} does not accept argument {k}")
    return Symbol([(_Node(None, name), 0)]) if not node_attrs else Symbol(
        [(_Node(None, name, node_attrs), 0)]
    )


var = Variable


def Group(symbols):
    outputs = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Expected a list of Symbols")
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load(fname):
    with open(fname) as f:
        return fromjson(f.read())


load_json = None  # set below


def fromjson(json_str):
    """Deserialize a symbol JSON, including reference-era legacy formats.

    Pre-NNVM JSON (the reference's ``save_000800.json`` fixture, upgraded by
    ``src/nnvm/legacy_json_util.cc:1-209``) differs from the modern layout:
    op params live in a separate ``param`` dict next to the free-form
    ``attr`` section, variable training hints (``lr_mult``/``wd_mult``) are
    stored bare, and stateful ops (BatchNorm) omit their auxiliary states
    from ``inputs``. The upgrade below mirrors the reference loader: merge
    param+attr into node attrs, dunder-wrap the variable hints, and
    synthesize the missing aux variable inputs with the standard
    ``{name}_{aux}`` naming so the loaded graph matches one built
    programmatically.
    """
    data = json.loads(json_str)
    nodes_js = data["nodes"]
    built = []
    legacy_ops = []
    for entry in nodes_js:
        legacy = "attrs" not in entry and (
            "param" in entry or "backward_source_id" in entry
        )
        if legacy:
            attrs = dict(entry.get("param", {}))
            attrs.update(entry.get("attr", {}))
            # exact hidden-key match upgrades in place (variable hints);
            # ctx_group stays plain — this framework's internal convention
            for hint in _LEGACY_HIDDEN:
                if hint in attrs:
                    attrs[f"__{hint}__"] = attrs.pop(hint)
        else:
            attrs = dict(
                entry.get("attrs", entry.get("attr", entry.get("param", {})))
            )
        is_aux = attrs.pop("__is_aux__", "false") == "true"
        if entry["op"] == "null":
            node = _Node(None, entry["name"], attrs, is_aux=is_aux)
        else:
            opdef = _reg.get(entry["op"])
            inputs = [
                (built[i], idx) for (i, idx, *_rest) in entry["inputs"]
            ]
            node = _Node(opdef, entry["name"], attrs, inputs)
            if not legacy:
                # typo detection at load time (the reference's attr_parser
                # runs on load and raises on unknown op params); legacy
                # nodes instead go through the upgrade passes below
                opdef.parse_params(attrs, strict=True)
            if legacy:
                params = opdef.parse_params(attrs, strict=False)
                aux_names = opdef.aux_names(params)
                if aux_names and len(inputs) == len(opdef.arg_names(params)):
                    for auxn in aux_names:
                        node.inputs.append((
                            _Node(None, f"{entry['name']}_{auxn}",
                                  is_aux=True), 0,
                        ))
                legacy_ops.append((node, opdef))
        built.append(node)
    for node, opdef in legacy_ops:
        _upgrade_suffixed_hints(node, opdef)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    return Symbol([(built[i], idx) for (i, idx, *_r) in heads])


# the reference's kHiddenKeys minus ctx_group (c_api_symbolic.cc:20): keys
# the legacy upgrade pass dunder-wraps (legacy_json_util.cc UpgradeJSON_
# FixParsing)
_LEGACY_HIDDEN = ("lr_mult", "wd_mult", "force_mirroring", "mirror_stage")


def _upgrade_suffixed_hints(node, opdef):
    """Old-format ``{argname}_{hint}`` attrs on an op node belong to that
    named variable input: move e.g. ``weight_lr_mult`` on ``fc1`` to
    ``__lr_mult__`` on ``fc1_weight`` (legacy_json_util.cc:60-85). The same
    suffixed key sitting on a *variable* node stays as-is, as the reference
    leaves it."""
    params = opdef.parse_params(node.attrs, strict=False)
    arg_names = list(opdef.arg_names(params))
    for key in list(node.attrs):
        for hint in _LEGACY_HIDDEN:
            suf = "_" + hint
            if key.endswith(suf) and len(key) > len(suf):
                prefix = key[: -len(suf)]
                if prefix in arg_names:
                    inp = node.inputs[arg_names.index(prefix)][0]
                    if inp.is_variable:
                        inp.attrs[f"__{hint}__"] = node.attrs.pop(key)
                break


load_json = fromjson


# ---------------------------------------------------------------------------
# op codegen: sym.<op>(...) creating graph nodes
# ---------------------------------------------------------------------------
def _create(op_name, input_syms, attrs, name=None):
    """Create an op node over input symbols; auto-create missing vars."""
    opdef = _reg.get(op_name)
    params_raw = {k: v for k, v in attrs.items() if v is not None}
    if "num_args" in opdef.param_schema and "num_args" not in params_raw:
        params_raw["num_args"] = len(input_syms)
    params = opdef.parse_params(params_raw)
    hint = opdef.name.lower().lstrip("_")
    name = NameManager.current().get(name, hint)
    scope_attrs = AttrScope.current().get({})
    # reference rule (python/mxnet/symbol.py Variable + test_attr.py:52):
    # free-form attributes on an OP node must be dunder-wrapped (__mood__);
    # plain keys are either op params (validated above) or the hidden keys
    # (ctx_group/lr_mult/...). Variables stay permissive.
    from .ops.registry import _GRAPH_ATTRS

    for k in scope_attrs:
        if not (k.startswith("__") and k.endswith("__")) \
                and k not in _GRAPH_ATTRS and k not in opdef.param_schema:
            raise ValueError(
                f"Attribute name={k} is not supported on operator nodes. "
                "Additional attributes must start and end with double "
                "underscores, e.g. __yourattr__"
            )
    node_attrs = dict(scope_attrs)
    node_attrs.update(string_attrs(params_raw))

    arg_names = opdef.arg_names(params)
    aux_names = opdef.aux_names(params)
    inputs = []
    for i, an in enumerate(arg_names):
        if i < len(input_syms) and input_syms[i] is not None:
            s = input_syms[i]
            if len(s._outputs) != 1:
                raise MXNetError(
                    f"{op_name}: input {an} must be a single-output symbol"
                )
            inputs.append(s._outputs[0])
        else:
            inputs.append((_Node(None, f"{name}_{an}"), 0))
    if len(input_syms) > len(arg_names):
        if not callable(opdef._arg_names):
            raise MXNetError(f"{op_name}: too many inputs")
        for s in input_syms[len(arg_names):]:
            inputs.append(s._outputs[0])
    for auxn in aux_names:
        inputs.append((_Node(None, f"{name}_{auxn}", is_aux=True), 0))

    node = _Node(opdef, name, node_attrs, inputs)
    nvis = opdef.num_visible_outputs(params)
    return Symbol([(node, i) for i in range(nvis)])


def _make_symbol_function(opdef, func_name):
    def generic_sym(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        tensor_kwargs = {}
        param_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                tensor_kwargs[k] = v
            else:
                param_kwargs[k] = v
        pos = [a for a in args]
        if any(not isinstance(a, Symbol) for a in pos):
            raise TypeError(
                f"{func_name}: positional arguments must be Symbols; "
                "pass parameters as keywords"
            )
        if "num_args" in opdef.param_schema and "num_args" not in param_kwargs:
            param_kwargs["num_args"] = len(pos) + len(tensor_kwargs)
        params = opdef.parse_params(param_kwargs)
        arg_names = opdef.arg_names(params)
        input_syms = []
        for an in arg_names:
            if an in tensor_kwargs:
                input_syms.append(tensor_kwargs.pop(an))
            elif pos:
                input_syms.append(pos.pop(0))
            else:
                input_syms.append(None)
        input_syms.extend(pos)
        if tensor_kwargs:
            raise MXNetError(
                f"{func_name}: unknown symbol inputs {list(tensor_kwargs)}"
            )
        merged = dict(param_kwargs)
        if attr:
            merged.update({k: v for k, v in attr.items()})
        return _create(opdef.name, input_syms, merged, name=name)

    generic_sym.__name__ = func_name
    generic_sym.__doc__ = opdef.doc or f"{func_name} (op {opdef.name})"
    return generic_sym


def _init_ops():
    module = sys.modules[__name__]
    for op_name in _reg.list_ops():
        opdef = _reg.get(op_name)
        if hasattr(module, op_name):
            continue
        setattr(module, op_name, _make_symbol_function(opdef, op_name))


_init_ops()
