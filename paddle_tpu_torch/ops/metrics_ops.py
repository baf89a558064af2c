"""Metric ops (ref: ``paddle_tpu/ops/metrics_ops.py``): top-k
``accuracy``, a one-shot bucketed ``auc`` and per-class
``precision_recall`` on the input's device, and ``chunk_eval``'s chunk
counts on the host in numpy, as the reference (and its CPU-only kernel)
counts them.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.metrics import _np


@register_op("accuracy")
def accuracy(input, label, k=1):
    """Top-k accuracy of scores ``[B, C]`` against labels ``[B]`` or
    ``[B, 1]``; the top k by a stable sort of the negated scores, as
    ``jnp.argsort`` orders ties."""
    if label.ndim > 1:
        label = label.squeeze(-1)
    topk = torch.argsort(-input, dim=-1, stable=True)[:, :k]
    correct = (topk == label[:, None]).any(-1)
    return correct.to(torch.float32).mean()


@register_op("auc")
def auc(predict, label, num_thresholds=4096):
    """AUC of one batch by a bucketed trapezoid (ref:
    ``metrics_ops.py:24``); ``predict`` is ``[B]`` or ``[B, 2]`` (column
    1 the positive score)."""
    if label.ndim > 1:
        label = label.squeeze(-1)
    pos_score = predict[:, 1] if predict.ndim > 1 else predict
    bucket = torch.clamp((pos_score * num_thresholds).to(torch.int32), 0,
                         num_thresholds - 1).long()
    lbl = label.to(torch.float32)
    zeros = torch.zeros(num_thresholds, dtype=torch.float32,
                        device=predict.device)
    pos_c = torch.cumsum(zeros.index_add(0, bucket, lbl).flip(0), 0)
    neg_c = torch.cumsum(zeros.index_add(0, bucket, 1.0 - lbl).flip(0), 0)
    first = zeros[:1]
    pos_prev = torch.cat([first, pos_c[:-1]])
    neg_prev = torch.cat([first, neg_c[:-1]])
    area = torch.sum((neg_c - neg_prev) * (pos_c + pos_prev) / 2.0)
    return area / torch.clamp(pos_c[-1] * neg_c[-1], min=1e-12)


@register_op("precision_recall")
def precision_recall(pred_label, label, num_classes):
    """Per-class ``(precision, recall, f1)``, each ``[num_classes]``."""
    if label.ndim > 1:
        label = label.squeeze(-1)
    if pred_label.ndim > 1:
        pred_label = pred_label.squeeze(-1)
    zeros = torch.zeros(num_classes, dtype=torch.float32,
                        device=pred_label.device)
    correct = (pred_label == label).to(torch.float32)
    tp = zeros.index_add(0, pred_label.long(), correct)
    fp = zeros.index_add(0, pred_label.long(), 1.0 - correct)
    fn = zeros.index_add(0, label.long(), 1.0 - correct)
    precision = tp / torch.clamp(tp + fp, min=1e-12)
    recall = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return precision, recall, f1


def _extract_chunks(tags, chunk_scheme, num_chunk_types):
    """``{(start, end, type)}`` of a tag sequence (ref:
    ``metrics_ops.py:67``): with S tags a chunk type (IOB and IOE 2,
    IOBES 4, plain 1), tag = type * S + index; any tag outside ``[0,
    num_chunk_types * S)`` is Outside."""
    schemes = {"IOB": ("B", "I"), "IOE": ("I", "E"),
               "IOBES": ("B", "I", "E", "S"), "plain": ("U",)}
    names = schemes[chunk_scheme]
    S = len(names)
    chunks = set()
    start = None
    ctype = None

    def close(end):
        nonlocal start, ctype
        if start is not None:
            chunks.add((start, end, ctype))
        start, ctype = None, None

    for i, t in enumerate(tags):
        t = int(t)
        if t < 0 or t >= num_chunk_types * S:
            close(i - 1)
            continue
        ty, ti = divmod(t, S)
        tag = names[ti]
        if chunk_scheme == "plain":
            # a maximal run of one type is one chunk
            if ctype != ty:
                close(i - 1)
                start, ctype = i, ty
        elif chunk_scheme == "IOB":
            if tag == "B" or ctype != ty:
                close(i - 1)
                start, ctype = i, ty
        elif chunk_scheme == "IOE":
            if ctype != ty:
                close(i - 1)
                start, ctype = i, ty
            if tag == "E":
                close(i)
        elif chunk_scheme == "IOBES":
            if tag == "S":
                close(i - 1)
                chunks.add((i, i, ty))
            elif tag == "B" or ctype != ty:
                close(i - 1)
                start, ctype = i, ty
            if tag == "E" and start is not None:
                close(i)
    close(len(tags) - 1)
    return chunks


@register_op("chunk_eval")
def chunk_eval(inference, label, lengths, chunk_scheme="IOB",
               num_chunk_types=1, excluded_chunk_types=()):
    """Chunk-level counts over ``[B, T]`` tag rows with lengths ``[B]``
    (ref: ``metrics_ops.py:126``), on the host: ``(precision, recall,
    f1, num_infer_chunks, num_label_chunks, num_correct_chunks)``."""
    inference, label, lengths = (_np(a) for a in (inference, label,
                                                   lengths))
    excl = set(excluded_chunk_types)
    n_inf = n_lab = n_cor = 0
    for b in range(inference.shape[0]):
        L = int(lengths[b])
        inf_c = {c for c in _extract_chunks(
            inference[b, :L], chunk_scheme, num_chunk_types)
            if c[2] not in excl}
        lab_c = {c for c in _extract_chunks(
            label[b, :L], chunk_scheme, num_chunk_types)
            if c[2] not in excl}
        n_inf += len(inf_c)
        n_lab += len(lab_c)
        n_cor += len(inf_c & lab_c)
    precision = n_cor / max(n_inf, 1e-12)
    recall = n_cor / max(n_lab, 1e-12)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return precision, recall, f1, n_inf, n_lab, n_cor
