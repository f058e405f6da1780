"""Carry parameters across from the JAX package.

:func:`params_from_numpy` takes parameters as numpy arrays keyed like
``Module.get_params`` returns them (``arg_params``, ``aux_params``; an
``mxnet_tpu`` NDArray converts with ``.asnumpy()``) and places them on a
device as the port's NDArrays. The other route is a ``.params`` file:
``mxnet_tpu.nd.save`` writes it and :func:`mxnet_tpu_torch.ndarray.load`
reads it, byte for byte.
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
