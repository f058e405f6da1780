"""Contrib namespace: inference-graph optimizations."""

from .quantize_fold import fold_batchnorm  # noqa: F401
