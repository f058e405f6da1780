"""Module API (reference ``python/mxnet/module/``): ``BaseModule``,
``DataParallelExecutorGroup`` (one device), ``Module`` (with
``WindowBoundary``), ``BucketingModule`` and ``GANModule``. The sequential
and Python modules are not yet ported."""

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .gan_module import GANModule
from .module import Module, WindowBoundary
