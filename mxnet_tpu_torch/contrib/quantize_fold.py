"""Inference-graph optimizations: BatchNorm folding.

Deployment-time rewrite in the spirit of the reference's inference-only
surface (the predict ABI / amalgamation path and the quantize/dequantize
stubs in ``src/operator/contrib``): at inference, ``y = gamma * (conv(x) -
mean) / sqrt(var + eps) + beta`` is an affine function of the convolution
output, so the BatchNorm collapses into the convolution's weights/bias and
the per-channel normalize pass disappears. A copy of
``mxnet_tpu/contrib/quantize_fold.py`` (host numpy).

Works on Convolution and FullyConnected producers whose output feeds only
the BatchNorm being folded.
"""

from __future__ import annotations

import numpy as np

from ..base import MXNetError


def fold_batchnorm(symbol, arg_params, aux_params):
    """Fold inference-mode BatchNorms into their producer Conv/FC layers.

    Parameters
    ----------
    symbol : the network Symbol (as trained).
    arg_params, aux_params : dicts of NDArray as returned by
        ``Module.get_params`` / ``load_checkpoint``.

    Returns ``(new_symbol, new_arg_params)``: a graph with the foldable
    BatchNorm nodes removed and the producers' weights/bias rewritten;
    unfolded BatchNorms (no conv/fc producer, or producer with other
    consumers) are kept and still read from ``aux_params``.
    """
    from .. import ndarray as nd_mod
    from ..symbol import Symbol, _Node

    # consumer count per node: a producer feeding anything besides its BN
    # cannot be rewritten
    consumers = {}
    for node in symbol._topo():
        for (inp, _ix) in node.inputs:
            consumers[id(inp)] = consumers.get(id(inp), 0) + 1
    for (node, _ix) in symbol._outputs:
        consumers[id(node)] = consumers.get(id(node), 0) + 1

    new_args = {k: v for k, v in arg_params.items()}
    mapped = {}

    def param_val(name):
        if name in new_args:
            return np.asarray(new_args[name].asnumpy(), np.float64)
        if name in aux_params:
            return np.asarray(aux_params[name].asnumpy(), np.float64)
        raise MXNetError(f"fold_batchnorm: missing parameter {name!r}")

    def clone(node):
        if id(node) in mapped:
            return mapped[id(node)]
        if node.is_variable:
            out = node  # variables are shared, not copied
            mapped[id(node)] = out
            return out

        if node.op.name == "BatchNorm":
            folded = _try_fold(node)
            if folded is not None:
                mapped[id(node)] = folded
                return folded
        out = _Node(
            node.op, node.name, dict(node.attrs),
            [(clone(i), ix) for (i, ix) in node.inputs],
        )
        mapped[id(node)] = out
        return out

    def _try_fold(bn):
        prod, prod_ix = bn.inputs[0]
        if prod.is_variable or prod_ix != 0:
            return None
        if prod.op.name not in ("Convolution", "FullyConnected"):
            return None
        if consumers.get(id(prod), 0) != 1:
            return None  # producer output also used elsewhere
        # a SHARED weight/bias variable (tied layers) must not be rewritten:
        # scaling it for this BN would corrupt every other consumer
        for (vin, _vix) in prod.inputs[1:]:
            if consumers.get(id(vin), 0) != 1:
                return None
        p = bn.params()
        if p["axis"] != 1 or p["output_mean_var"]:
            return None
        gamma_n, beta_n = bn.inputs[1][0].name, bn.inputs[2][0].name
        mean_n, var_n = bn.inputs[3][0].name, bn.inputs[4][0].name
        gamma = (np.ones_like(param_val(mean_n)) if p["fix_gamma"]
                 else param_val(gamma_n))
        beta = param_val(beta_n)
        mean, var = param_val(mean_n), param_val(var_n)
        scale = gamma / np.sqrt(var + p["eps"])

        prod_params = prod.params()
        if prod.op.name == "FullyConnected" and \
                not prod_params.get("flatten", True):
            # flatten=False output is (batch, ..., num_hidden): BN axis 1
            # normalizes a sequence dim, not the FC channels — even when
            # the sizes coincide — so the fold is never valid here
            return None
        w_name = prod.inputs[1][0].name
        W = param_val(w_name)
        if W.shape[0] != scale.shape[0]:
            # the BN channel axis is not the producer's output-channel
            # axis — not foldable
            return None
        bshape = (-1,) + (1,) * (W.ndim - 1)
        new_w = W * scale.reshape(bshape)
        if prod_params["no_bias"]:
            b = np.zeros_like(mean)
            b_name = f"{prod.name}_bias"
        else:
            b_name = prod.inputs[2][0].name
            b = param_val(b_name)
        new_b = beta + (b - mean) * scale

        attrs = dict(prod.attrs)
        attrs["no_bias"] = "False"
        inputs = [
            (clone(prod.inputs[0][0]), prod.inputs[0][1]),
            (prod.inputs[1][0], 0),
            (_Node(None, b_name), 0) if prod_params["no_bias"]
            else (prod.inputs[2][0], 0),
        ]
        # the folded arrays stay where the producer's weight lives
        w_ctx = arg_params[w_name].context
        new_args[w_name] = nd_mod.array(
            new_w.astype(np.asarray(arg_params[w_name].asnumpy()).dtype),
            ctx=w_ctx)
        new_args[b_name] = nd_mod.array(new_b.astype(np.float32), ctx=w_ctx)
        return _Node(prod.op, prod.name, attrs, inputs)

    new_outputs = [(clone(n), ix) for (n, ix) in symbol._outputs]
    return Symbol(new_outputs), new_args
