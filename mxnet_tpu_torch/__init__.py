"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module names and
layout so each module's counterpart is easy to find. It imports torch and
numpy, never ``jax`` and nothing from ``mxnet_tpu``. It trains and serves
models end to end: Symbol graphs (JSON and ``.params`` compatible with the
JAX package), an eager executor with backward and a fused update,
``Module.fit`` and ``BucketingModule.fit`` with SGD and Adam, RNN cells and
``BucketSentenceIter``, initializers, metrics and ``NDArrayIter``,
``Predictor`` and ``ModelServer`` (ResNet classification and SSD
detection). Entry points run on the card (``gpu(0)``) unless the caller
asks for the CPU. BatchNorm (+ReLU) forward and backward, the SoftmaxOutput
forward and loss backward, the LSTM cell step forward and backward, the
multi-tensor SGD and Adam updates, and SSD's channel L2 normalization,
per-anchor decode and NMS run hand-written CUDA kernels (:mod:`.kernels`);
convolutions and matrix products go to cuDNN/cuBLAS through torch.
"""

import torch

# Float32 parity with the reference, which computes f32 contractions at
# precision=HIGHEST (mxnet_tpu/ops/defs_tensor.py matmul_precision): cuDNN
# convolutions default to TF32, which keeps ~3 decimal digits, so both TF32
# switches are cleared for the whole process when the port is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .base import MXNetError, __version__  # noqa: E402
from . import base, context, env, telemetry  # noqa: E402
from .context import Context, cpu, gpu, current_context, num_gpus  # noqa: E402
from . import ops  # noqa: E402
from . import kernels  # noqa: E402
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402
from .executor import Executor  # noqa: E402
from . import random  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import lr_scheduler, optimizer  # noqa: E402
from . import optimizer as opt  # noqa: E402
from .optimizer import Optimizer  # noqa: E402
from . import metric, io, callback, model  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from . import rnn  # noqa: E402
from . import contrib, convert, models, predictor, serving  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from .name import NameManager  # noqa: E402

__all__ = [
    "MXNetError", "Context", "cpu", "gpu", "current_context", "num_gpus",
    "nd", "ndarray", "sym", "symbol", "Executor", "contrib", "convert",
    "models", "predictor", "serving", "kernels", "ops", "base", "context",
    "env", "telemetry", "AttrScope", "NameManager", "random", "init",
    "initializer", "lr_scheduler", "optimizer", "opt", "Optimizer", "metric",
    "io", "callback", "model", "module", "mod", "rnn",
]
