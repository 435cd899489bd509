"""Confusion matrix + IoU metric classes
(XAI_Survey/evaluations/utils/{confusionmatrix,iou,metric}.py): streaming
accumulators used by the segmentation evaluations.

Counterpart of ``xai_tpu/metrics/confusion.py``, host numpy.
"""
from __future__ import annotations

import numpy as np


class Metric:
    """Base streaming metric (utils/metric.py)."""

    def reset(self):
        raise NotImplementedError

    def add(self, predicted, target):
        raise NotImplementedError

    def value(self):
        raise NotImplementedError


class ConfusionMatrix(Metric):
    """Streaming K x K confusion matrix (utils/confusionmatrix.py).
    ``normalized`` divides rows by their sums on read."""

    def __init__(self, num_classes: int, normalized: bool = False):
        self.num_classes = num_classes
        self.normalized = normalized
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self.conf.fill(0)

    def add(self, predicted, target):
        predicted = np.asarray(predicted).reshape(-1)
        target = np.asarray(target).reshape(-1)
        assert predicted.shape == target.shape
        valid = (predicted >= 0) & (predicted < self.num_classes) & \
            (target >= 0) & (target < self.num_classes)
        idx = target[valid] * self.num_classes + predicted[valid]
        self.conf += np.bincount(
            idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def value(self):
        if self.normalized:
            conf = self.conf.astype(np.float64)
            rows = conf.sum(1, keepdims=True)
            return conf / np.clip(rows, 1e-12, None)
        return self.conf


class IoU(Metric):
    """Streaming per-class IoU over a confusion matrix (utils/iou.py)."""

    def __init__(self, num_classes: int, normalized: bool = False,
                 ignore_index=None):
        self.conf_metric = ConfusionMatrix(num_classes, normalized)
        if ignore_index is None:
            self.ignore_index = None
        elif isinstance(ignore_index, int):
            self.ignore_index = (ignore_index,)
        else:
            self.ignore_index = tuple(ignore_index)

    def reset(self):
        self.conf_metric.reset()

    def add(self, predicted, target):
        self.conf_metric.add(predicted, target)

    def value(self):
        conf = self.conf_metric.value().astype(np.float64)
        if self.ignore_index is not None:
            for i in self.ignore_index:
                conf[:, i] = 0
                conf[i, :] = 0
        tp = np.diag(conf)
        fp = conf.sum(0) - tp
        fn = conf.sum(1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn)
        return iou, float(np.nanmean(iou))
