"""Metrics (counterpart of paddle_tpu/metric): Accuracy (top-k),
Precision, Recall, Auc and the functional `accuracy`, computed in numpy
on the host as the reference's are; predictions and labels may be
tensors on any device (a bf16 tensor is read as f32) or arrays."""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l.squeeze(-1)
        maxk = max(self.topk)
        topi = np.argsort(-p, axis=-1)[..., :maxk]
        correct = topi == l[..., None]
        return correct

    def update(self, correct):
        c = _np(correct)
        n = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].any(-1).sum())
            self.count[i] += n
        return self.total[0] / max(self.count[0], 1)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).astype(int).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fp += int(((pred_pos == 1) & (l == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).astype(int).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fn += int(((pred_pos == 0) & (l == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        if p.ndim == 2:
            p = p[:, 1]
        l = l.reshape(-1)
        idx = np.minimum((p * self.num_thresholds).astype(int),
                         self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds (descending)
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top k, as an f32 CPU
    tensor."""
    p = _np(input)
    l = _np(label)
    if l.ndim == p.ndim and l.shape[-1] == 1:
        l = l.squeeze(-1)
    topi = np.argsort(-p, axis=-1)[..., :k]
    acc = (topi == l[..., None]).any(-1).mean()
    return torch.from_numpy(np.asarray(acc, "float32"))


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
