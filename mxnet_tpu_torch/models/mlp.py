"""MLP for MNIST (reference example/image-classification/symbols/mlp.py).

A copy of ``mxnet_tpu/models/mlp.py``; ``dtype`` other than float32
needs the ``Cast`` op, which is not yet ported.
"""

from .. import symbol as sym
from .recipe import low_precision_io


def get_symbol(num_classes=10, dtype="float32", **kwargs):
    data = sym.Variable("data")
    data = sym.Flatten(data)
    data = low_precision_io(data, dtype)
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(fc2, name="relu2", act_type="relu")
    act2 = low_precision_io(act2, dtype, out=True)
    fc3 = sym.FullyConnected(act2, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(fc3, name="softmax")
