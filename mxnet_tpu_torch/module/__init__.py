"""Module API (reference ``python/mxnet/module/``): ``BaseModule``,
``DataParallelExecutorGroup`` (one device) and ``Module``. The bucketing,
sequential, GAN and Python modules are not yet ported."""

from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
