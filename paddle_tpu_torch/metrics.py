"""Streaming metrics (ref: ``paddle_tpu/metrics.py``): the host-side
accumulators the CTR path reads, in numpy as in the reference, and
:func:`ctr_metric_bundle`'s per-batch sums in torch on the batch's
device. ``EditDistance``, ``ChunkEvaluator`` and ``DetectionMAP`` are not
ported."""

import numpy as np
import torch


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """Weighted running mean of batch accuracies (ref: ``metrics.py:26``)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


def _binary(preds, labels):
    preds = np.rint(_np(preds)).astype(np.int64).reshape(-1)
    return preds, _np(labels).astype(np.int64).reshape(-1)


class Precision(MetricBase):
    """Binary precision (ref: ``metrics.py:45``)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += float(np.sum((preds == 1) & (labels == 1)))
        self.fp += float(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1e-12)


class Recall(MetricBase):
    """Binary recall (ref: ``metrics.py:66``)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += float(np.sum((preds == 1) & (labels == 1)))
        self.fn += float(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1e-12)


class Auc(MetricBase):
    """ROC AUC by threshold buckets accumulated over batches (ref:
    ``metrics.py:85``): ``preds`` are probabilities (``[N, 2]`` takes the
    second column), ``labels`` 0/1."""

    def __init__(self, num_thresholds=4096, name=None):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.pos = np.zeros(self.num_thresholds)
        self.neg = np.zeros(self.num_thresholds)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim > 1 and preds.shape[-1] == 2:
            preds = preds[..., 1]
        preds = preds.reshape(-1)
        labels = _np(labels).reshape(-1)
        bucket = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                         self.num_thresholds - 1)
        np.add.at(self.pos, bucket, labels == 1)
        np.add.at(self.neg, bucket, labels == 0)

    def eval(self):
        pos_c = np.cumsum(self.pos[::-1])
        neg_c = np.cumsum(self.neg[::-1])
        tot_pos, tot_neg = pos_c[-1], neg_c[-1]
        pos_prev = np.concatenate([[0], pos_c[:-1]])
        neg_prev = np.concatenate([[0], neg_c[:-1]])
        area = np.sum((neg_c - neg_prev) * (pos_c + pos_prev) / 2.0)
        return float(area / max(tot_pos * tot_neg, 1e-12))


def ctr_metric_bundle(pred, label):
    """Per-batch sums of the CTR metrics (ref: ``metrics.py:313``): pred
    ``[N, 1]`` probabilities, label ``[N, 1]`` 0/1 -> f32 0-d tensors
    ``sqrerr``, ``abserr``, ``prob``, ``q``, ``pos_num`` and ``ins_num``
    on pred's device. The caller accumulates them and finishes MAE =
    abserr / n, RMSE = sqrt(sqrerr / n), predicted CTR = prob / n, q =
    q / n. ``q`` applies sigmoid to ``pred`` although it is already a
    probability: the reference keeps that contract, and so does the
    port."""
    pred = pred.reshape(-1).to(torch.float32)
    label = label.reshape(-1).to(torch.float32)
    err = pred - label
    return {
        "sqrerr": torch.sum(err * err),
        "abserr": torch.sum(torch.abs(err)),
        "prob": torch.sum(pred),
        "q": torch.sum(torch.sigmoid(pred)),
        "pos_num": torch.sum(label),
        "ins_num": torch.tensor(float(pred.shape[0]), device=pred.device),
    }
