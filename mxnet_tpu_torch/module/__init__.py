"""Module API (reference ``python/mxnet/module/``): ``BaseModule``,
``DataParallelExecutorGroup`` (one device), ``Module`` and
``BucketingModule``. The sequential, GAN and Python modules are not yet
ported."""

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
