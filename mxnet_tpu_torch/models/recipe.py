"""Precision recipes of the model symbols (the part of
``mxnet_tpu/models/recipe.py`` that models/resnet.py uses).

Only the ``f32`` recipe is ported: the low-precision trunk needs the
``Cast`` op, which is not yet ported.
"""

from ..base import MXNetError


def low_precision_io(x, dtype, out=False):
    """Cast into the low-precision trunk (``out=False``, after data) or
    back to f32 for the classifier head (``out=True``). No-op for f32."""
    if dtype in (None, "float32"):
        return x
    raise MXNetError(f"dtype {dtype!r}: the low-precision recipe needs the "
                     "Cast op, which is not yet ported to mxnet_tpu_torch")
