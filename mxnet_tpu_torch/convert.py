"""Carry parameters across from the JAX package.

:func:`params_from_numpy` takes parameters as numpy arrays keyed like
``Module.get_params`` returns them (``arg_params``, ``aux_params``; an
``mxnet_tpu`` NDArray converts with ``.asnumpy()``) and places them on a
device as the port's NDArrays. The other route is a ``.params`` file:
``mxnet_tpu.nd.save`` writes it and :func:`mxnet_tpu_torch.ndarray.load`
reads it, byte for byte. :func:`gan_params_from_numpy` sets a
``GANModule``'s two networks from the JAX ``GANModule``'s
``mod_g.get_params()`` and ``mod_d.get_params()``.

Optimizer states carry across as files: the JAX ``Module``'s
``save_optimizer_states`` pickles numpy arrays (per parameter index, a
state or a tuple of states: SGD's momentum, Adam's ``(mean, var)``,
RMSProp's ``(n,)`` or, centred, ``(n, g, delta)``), and the port's
``Module.load_optimizer_states`` reads that file as it is. The states land
on the current context, and the first update moves each next to its
weight; training then continues as the reference's would.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import Context, context_of
from .ndarray import array


def params_from_numpy(arg_params, aux_params, device):
    """``(arg_params, aux_params)`` as dicts of NDArray on ``device`` (a
    Context, a ``torch.device`` or a device string such as ``"cuda:0"``),
    keeping each array's dtype."""
    ctx = device if isinstance(device, Context) \
        else context_of(torch.device(device))

    def conv(d):
        return {k: array(np.asarray(v), ctx=ctx, dtype=np.asarray(v).dtype)
                for k, v in d.items()}

    return conv(arg_params), conv(aux_params or {})


def gan_params_from_numpy(gan, g_params, d_params):
    """Set the port's ``GANModule`` ``gan`` (bound, parameters initialized)
    from ``g_params`` and ``d_params``, each ``(arg_params, aux_params)``
    of numpy arrays as the JAX ``GANModule``'s ``mod_g.get_params()`` and
    ``mod_d.get_params()`` give them (``.asnumpy()`` of each value); every
    parameter and auxiliary state of both networks must be present."""
    for mod, (args, auxs) in ((gan.mod_g, g_params), (gan.mod_d, d_params)):
        ctx = mod._context[0]
        arg_nd, aux_nd = params_from_numpy(args, auxs, ctx)
        mod.set_params(arg_nd, aux_nd)
