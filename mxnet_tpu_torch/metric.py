"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference ``python/mxnet/
metric.py``): ``EvalMetric`` (``update`` / ``update_dict`` / ``get`` /
``get_name_value``), ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy`` and ``create``, with the reference's
names (``"acc"`` and ``"accuracy"``, ``"ce"``, ``"top_k_accuracy"``).  A
metric reads its labels and predictions on the host with numpy: one
device-to-host copy of each per update.
"""
from __future__ import annotations

import numpy

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "create", "register", "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in (names or (klass.__name__.lower(),)):
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, a list of them, a class or an instance."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        name = metric.lower()
        if name not in _METRIC_REGISTRY:
            raise ValueError("Metric must be either callable or in registry; "
                             "got %s" % metric)
        return _METRIC_REGISTRY[name](*args, **kwargs)
    if isinstance(metric, type):
        return metric(*args, **kwargs)
    raise TypeError("metric must be a name, a list, a class or an "
                    "EvalMetric, not %s" % type(metric).__name__)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless labels and predictions agree in length (or shape)."""
    got = (labels.shape, preds.shape) if shape else (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(*got))
    if wrap:
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
    return labels, preds


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def _pairs(labels, preds):
    """Aligned ``(label, pred)`` pairs as host numpy arrays."""
    labels, preds = check_label_shapes(labels, preds, wrap=True)
    return [(_host(lab), _host(pr)) for lab, pr in zip(labels, preds)]


class EvalMetric:
    """Accumulates ``(sum_metric, num_inst)`` over ``update`` calls.
    Subclasses implement ``_measure(label, pred) -> (sum, count)`` per
    pair, or ``update`` wholesale."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def _select(self, table, wanted):
        if wanted is None:
            return list(table.values())
        return [table[n] for n in wanted if n in table]

    def update_dict(self, label, pred):
        """Update from ``{name: array}`` dicts of labels and outputs."""
        self.update(self._select(label, self.label_names),
                    self._select(pred, self.output_names))

    def _measure(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        for lab, pr in _pairs(labels, preds):
            s, n = self._measure(lab, pr)
            self.sum_metric += s
            self.num_inst += n

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated and read as one."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {k: v for k, v in labels.items()
                      if k in self.label_names}
        if self.output_names is not None:
            preds = {k: v for k, v in preds.items()
                     if k in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


class Accuracy(EvalMetric):
    """The share of predictions (argmax over ``axis``) equal to the
    label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _measure(self, label, pred):
        if pred.ndim > label.ndim:
            pred = pred.argmax(axis=self.axis)
        hits = (pred.astype("int32").ravel()
                == label.astype("int32").ravel())
        check_label_shapes(label.ravel(), pred.ravel())
        return hits.sum(), hits.size


class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += "_%d" % self.top_k

    def _measure(self, label, pred):
        if pred.ndim > 2:
            raise ValueError("Predictions should be no more than 2 dims")
        # a full argsort keeps the reference's tie-breaking order
        order = numpy.argsort(pred.astype("float32"), axis=-1)
        label = label.astype("int32")
        check_label_shapes(label, order)
        if order.ndim == 1:
            return (order.ravel() == label.ravel()).sum(), order.shape[0]
        k = min(order.shape[1], self.top_k)
        in_topk = order[:, order.shape[1] - k:] == label.reshape(-1, 1)
        return in_topk.sum(), order.shape[0]


class CrossEntropy(EvalMetric):
    """``-log(p[label] + eps)`` summed over the examples."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _measure(self, label, pred):
        flat = label.ravel().astype("int64")
        check_label_shapes(flat, pred)
        probs = pred[numpy.arange(flat.shape[0]), flat]
        return -numpy.log(probs + self.eps).sum(), flat.shape[0]


register(Accuracy, "acc", "accuracy")
register(CrossEntropy, "ce", "cross-entropy")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(CompositeEvalMetric, "composite")
