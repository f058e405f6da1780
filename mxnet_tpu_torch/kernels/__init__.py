"""Hand-written CUDA kernels of the port, one module each.

Every module holds the kernel's wrapper, its plain PyTorch version and its
launch counter. A wrapper dispatches on the tensor's device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
Sources are in ``mxnet_tpu_torch/csrc``; :mod:`._lib` builds them.
"""

from . import (  # noqa: F401
    adam_multi, bn_act, bn_act_bwd, bn_stats, dropout, gru_cell,
    l2norm_channel,
    lstm_cell, multibox_decode, multibox_target, nms, rmsprop_multi,
    rnn_cell, sgd_mom_multi, softmax_output_bwd, softmax_rows)
