"""Streaming metrics (ref: ``paddle_tpu/metrics.py``): the host-side
accumulators the CTR path reads, in numpy as in the reference, and
:func:`ctr_metric_bundle`'s per-batch sums in torch on the batch's
device, :class:`DetectionMAP`'s host pass over the detections, and the
sequence family's :class:`EditDistance` and :class:`ChunkEvaluator`
(host numpy, as in the reference)."""

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


class EditDistance(MetricBase):
    """Running mean Levenshtein distance of hypothesis/reference pairs
    (ref: ``metrics.py:118``), each normalized by its reference's length
    (at least 1) unless ``normalized=False``."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    @staticmethod
    def _levenshtein(a, b):
        m, n = len(a), len(b)
        dp = np.arange(n + 1, dtype=np.float64)
        for i in range(1, m + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, n + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (a[i - 1] != b[j - 1]))
        return dp[n]

    def update(self, hyps, refs, normalized=True):
        for h, r in zip(hyps, refs):
            h, r = list(_np(h).reshape(-1)), list(_np(r).reshape(-1))
            d = self._levenshtein(h, r)
            if normalized:
                d = d / max(len(r), 1)
            self.total += d
            self.count += 1

    def eval(self):
        return self.total / max(self.count, 1)


class ChunkEvaluator(MetricBase):
    """Chunk precision, recall and F1 from accumulated counts (ref:
    ``metrics.py:153``; the counts come from
    :func:`~paddle_tpu_torch.ops.metrics_ops.chunk_eval`)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer = 0.0
        self.num_label = 0.0
        self.num_correct = 0.0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer += float(num_infer_chunks)
        self.num_label += float(num_label_chunks)
        self.num_correct += float(num_correct_chunks)

    def eval(self):
        precision = self.num_correct / max(self.num_infer, 1e-12)
        recall = self.num_correct / max(self.num_label, 1e-12)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return precision, recall, f1


class CompositeMetric(MetricBase):
    """Several metrics updated together (ref: ``metrics.py:177``)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args, **kwargs):
        for m in self._metrics:
            m.update(*args, **kwargs)

    def eval(self):
        return [m.eval() for m in self._metrics]


class DetectionMAP(MetricBase):
    """Detection mean average precision (ref: ``metrics.py:199``), a host
    accumulator over per-image results in numpy, as in the reference:
    ``update(detections, gt_labels, gt_boxes, gt_difficult=None)`` with
    detections ``[M, 6]`` rows (class, score, xmin, ymin, xmax, ymax),
    gt_labels ``[N]``, gt_boxes ``[N, 4]`` (tensors on any device, or
    arrays). ``eval()`` is the mean AP over the classes that have both
    ground truth and detections, by ``ap_version`` "integral" or
    "11point"."""

    def __init__(self, class_num, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral",
                 background_label=0, name=None):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self.class_num = class_num
        self.thresh = overlap_threshold
        self.eval_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.background = background_label
        self.reset()

    def reset(self):
        # per class: (score, is_tp) pairs and the count of counted GTs
        self._scored = {c: [] for c in range(self.class_num)}
        self._npos = np.zeros(self.class_num, np.int64)

    @staticmethod
    def _iou(box, boxes):
        x1 = np.maximum(box[0], boxes[:, 0])
        y1 = np.maximum(box[1], boxes[:, 1])
        x2 = np.minimum(box[2], boxes[:, 2])
        y2 = np.minimum(box[3], boxes[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / np.maximum(a + b - inter, 1e-12)

    def update(self, detections, gt_labels, gt_boxes, gt_difficult=None):
        det = _np(detections).astype(np.float64).reshape(-1, 6)
        gl = _np(gt_labels).reshape(-1).astype(int)
        gb = _np(gt_boxes).astype(np.float64).reshape(-1, 4)
        diff = (np.zeros(len(gl), bool) if gt_difficult is None
                else _np(gt_difficult).reshape(-1).astype(bool))
        for c in np.unique(gl):
            # out-of-range labels (-1 padding) are not ground truth
            if c == self.background or c < 0 or c >= self.class_num:
                continue
            sel = gl == c
            self._npos[c] += int((~diff[sel]).sum()) if not \
                self.eval_difficult else int(sel.sum())
        for c in range(self.class_num):
            if c == self.background:
                continue
            dc = det[det[:, 0] == c]
            gsel = gl == c
            gboxes = gb[gsel]
            gdiff = diff[gsel]
            taken = np.zeros(len(gboxes), bool)
            # high scores match first (detection_map_op.cc sorts by score)
            for row in dc[np.argsort(-dc[:, 1])]:
                score, box = row[1], row[2:6]
                if len(gboxes) == 0:
                    self._scored[c].append((score, False))
                    continue
                ious = self._iou(box, gboxes)
                j = int(np.argmax(ious))
                # strict >, as detection_map_op.cc:395
                if ious[j] > self.thresh:
                    if not self.eval_difficult and gdiff[j]:
                        continue  # a difficult GT is ignored entirely
                    self._scored[c].append((score, not taken[j]))
                    taken[j] = True
                else:
                    self._scored[c].append((score, False))

    def _ap(self, scored, npos):
        # the reference averages only classes with both ground truth and
        # detections (detection_map_op.h skips the others)
        if npos == 0 or not scored:
            return None
        arr = sorted(scored, key=lambda t: -t[0])
        tp = np.cumsum([1 if t else 0 for _, t in arr])
        fp = np.cumsum([0 if t else 1 for _, t in arr])
        recall = tp / npos
        precision = tp / np.maximum(tp + fp, 1)
        if self.ap_version == "11point":
            ap = 0.0
            for r in np.linspace(0, 1, 11):
                p = precision[recall >= r]
                ap += (p.max() if len(p) else 0.0) / 11.0
            return float(ap)
        # integral: precision at each true positive, over npos
        ap = 0.0
        for p, (_, is_tp) in zip(precision, arr):
            if is_tp:
                ap += p
        return float(ap / npos)

    def eval(self):
        aps = [self._ap(self._scored[c], self._npos[c])
               for c in range(self.class_num) if c != self.background]
        aps = [a for a in aps if a is not None]
        return float(np.mean(aps)) if aps else 0.0


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
