"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference ``python/mxnet/metric.py``)
for ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy``, ``Perplexity`` and :func:`create`.
Metrics consume (labels, preds) NDArray lists each batch; ``get()``
returns (name, value).

Device-resident accumulation, as in the JAX package: ``device_update()``
adds the batch statistic to a device scalar (the kernels stay queued
behind the training step) and only ``get()`` reads it on the host.
``update()`` is the synchronous numpy path. The other metrics of the JAX
package (F1, MAE, MSE, RMSE, Loss, custom callables) are not yet
ported.
"""

from __future__ import annotations

import numpy as _np
import torch

from . import telemetry as _telemetry
from .base import MXNetError
from .ndarray import NDArray

_CNT_DEVICE = _telemetry.counter("metric.device_update")
_CNT_DRAIN = _telemetry.counter("metric.drain_sync")


def _dev_val(x):
    return x._data if isinstance(x, NDArray) else torch.as_tensor(x)


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}"
        )


class EvalMetric:
    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        # device accumulator not yet folded into sum_metric, with its count
        self._dev_sum = None
        self._dev_inst = 0

    def update(self, labels, preds):
        raise NotImplementedError()

    def _device_batch(self, label, pred):
        """``(sum tensor, count)`` of one (label, pred) pair on the device."""
        raise NotImplementedError()

    def device_update(self, labels, preds):
        """Accumulate this batch on the device, without a host sync."""
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            s, n = self._device_batch(_dev_val(label), _dev_val(pred))
            s = s.to(torch.float64)
            self._dev_sum = s if self._dev_sum is None else self._dev_sum + s
            self._dev_inst += n
        _CNT_DEVICE.inc()
        return True

    def _drain_device(self):
        """Fold the device accumulator into the host sums (syncs)."""
        if self._dev_sum is not None:
            _CNT_DRAIN.inc()
            self.sum_metric += float(self._dev_sum)
            self.num_inst += self._dev_inst
            self._dev_sum = None
            self._dev_inst = 0

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite"):
        super().__init__(name)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def device_update(self, labels, preds):
        for metric in self.metrics:
            metric.device_update(labels, preds)
        return True

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            results.append(value)
        return (names, results)


class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def _argmax_axis(self, ndim):
        return -1 if self.axis == 1 and ndim == 2 else self.axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_np = pred_label.asnumpy()
            if pred_np.ndim > 1 and \
                    pred_np.shape[self._argmax_axis(pred_np.ndim)] > 1:
                pred_np = _np.argmax(pred_np, axis=self.axis)
            label_np = label.asnumpy().astype("int32")
            pred_np = pred_np.astype("int32")
            check_label_shapes(label_np.reshape(-1), pred_np.reshape(-1))
            self.sum_metric += (pred_np.flat == label_np.flat).sum()
            self.num_inst += len(pred_np.flat)

    def _device_batch(self, label, pred):
        if pred.dim() > 1 and pred.shape[self._argmax_axis(pred.dim())] > 1:
            pred = torch.argmax(pred, dim=self.axis)
        label = label.to(torch.int32).reshape(-1)
        pred = pred.to(torch.int32).reshape(-1)
        check_label_shapes(label, pred, shape=1)
        return (pred == label).sum(), int(pred.numel())


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name)
        self.top_k = top_k
        if self.top_k <= 1:
            raise MXNetError("Please use Accuracy if top_k is no more than 1")
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_np = _np.argsort(pred_label.asnumpy().astype("float32"),
                                  axis=1)
            label_np = label.asnumpy().astype("int32")
            num_classes = pred_np.shape[1]
            for j in range(min(num_classes, self.top_k)):
                self.sum_metric += (
                    pred_np[:, num_classes - 1 - j].flat == label_np.flat
                ).sum()
            self.num_inst += pred_np.shape[0]

    def _device_batch(self, label, pred):
        if pred.dim() != 2:
            raise MXNetError("TopKAccuracy: predictions must be 2-D")
        top_k = min(pred.shape[1], self.top_k)
        top = torch.topk(pred.to(torch.float32), top_k, dim=1).indices
        label = label.to(torch.int64).reshape(-1, 1)
        return (top == label).sum(), int(pred.shape[0])


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy().ravel()
            pred = pred.asnumpy()
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]

    def _device_batch(self, label, pred):
        label = label.reshape(-1)
        n = label.shape[0]
        prob = pred[torch.arange(n, device=pred.device), label.to(torch.int64)]
        return (-torch.log(prob + self.eps)).sum(), int(n)


def _nll(probs):
    return -torch.sum(torch.log(torch.clamp_min(probs, 1e-10)))


class Perplexity(EvalMetric):
    """Perplexity over a sequence of softmax outputs (reference
    ``Perplexity``): each batch adds ``exp(-sum(log p[label]) / n)`` over
    its ``n`` labels that are not ``ignore_label``; ``get()`` averages the
    batches."""

    def __init__(self, ignore_label, axis=-1, name="Perplexity"):
        super().__init__(name)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError(f"{len(labels)} labels for {len(preds)} "
                             "predictions")
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            if label.size != pred.size / pred.shape[-1]:
                raise ValueError(f"shape mismatch: {label.shape} vs. "
                                 f"{pred.shape}")
            label_np = label.asnumpy().astype("int32").reshape(-1)
            pred_np = pred.asnumpy().reshape(-1, pred.shape[-1])
            probs = pred_np[_np.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label).astype(pred_np.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label_np.shape[0]
        self.sum_metric += _np.exp(loss / num) if num > 0 else 0.0
        self.num_inst += 1

    def _device_batch(self, label, pred):
        # update()'s formula on the device, without a host read
        lab = label.reshape(-1).to(torch.int32)
        p = pred.reshape(lab.shape[0], pred.shape[-1])
        probs = torch.gather(p, 1, lab.to(torch.int64)[:, None])[:, 0]
        if self.ignore_label is None:
            return torch.exp(_nll(probs) / lab.shape[0]), 1
        ignore = (lab == self.ignore_label).to(p.dtype)
        num = lab.shape[0] - ignore.sum()
        loss = _nll(probs * (1 - ignore) + ignore)
        return torch.where(num > 0, torch.exp(loss / num),
                           torch.zeros_like(loss)), 1


def create(metric, **kwargs):
    """Create by name or list (reference ``mx.metric.create``)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, **kwargs))
        return composite_metric
    metrics = {
        "acc": Accuracy,
        "accuracy": Accuracy,
        "ce": CrossEntropy,
        "cross-entropy": CrossEntropy,
        "top_k_accuracy": TopKAccuracy,
        "topkaccuracy": TopKAccuracy,
        "perplexity": Perplexity,
    }
    if not isinstance(metric, str) or metric.lower() not in metrics:
        raise MXNetError(f"metric {metric!r} is not ported to "
                         f"mxnet_tpu_torch (ported: {sorted(metrics)})")
    return metrics[metric.lower()](**kwargs)
