"""Length bucketing (counterpart of paddle_tpu/io/bucketing.py).

Each prompt pads up to its bucket and each decode batch to its batch
bucket, so the generation engine runs a fixed, small set of shapes: one
prefill per prompt bucket, one decode step per batch bucket, each run
once on the device before a worker admits traffic. The predict engine
pads each coalesced batch's rows to its batch bucket (`pad_batch_rows`)
and dynamic non-batch axes to their sequence bucket. For training,
`BucketBatchSampler` forms batches of samples of one bucket and
`bucketed_collate` pads each batch's fields to that bucket
(`pad_to_bucket`), as `io.Pipeline.bucket` does; on the card this bounds
the shapes the caching allocator and the kernels see.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


def bucket_boundaries_pow2(min_len: int = 16, max_len: int = 2048
                           ) -> List[int]:
    """Power-of-two boundaries from min_len up to (and including)
    max_len: padding waste under 2x, about log2(max/min) shapes."""
    out = []
    b = max(1, min_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def bucket_for(length: int, boundaries: Sequence[int]) -> int:
    """Smallest boundary >= length (the bucket a sample pads to);
    lengths beyond the largest boundary raise. Accepts boundaries in
    any order."""
    for b in sorted(boundaries):
        if length <= b:
            return b
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket boundary "
        f"{max(boundaries)}; truncate the sample or extend the boundaries")


def pad_batch_rows(stacked: np.ndarray, boundaries: Sequence[int],
                   pad_value=0) -> np.ndarray:
    """Pad a stacked batch along dim 0 up to the bucket boundary of its
    row count (the predict engine's batcher runs one shape per batch
    bucket)."""
    target = bucket_for(stacked.shape[0], boundaries)
    if target == stacked.shape[0]:
        return stacked
    pad = [(0, target - stacked.shape[0])] + [(0, 0)] * (stacked.ndim - 1)
    return np.pad(stacked, pad, constant_values=pad_value)


def pad_to_bucket(arrays: Sequence[np.ndarray],
                  boundaries: Sequence[int], axis: int = 0,
                  pad_value=0) -> np.ndarray:
    """Stack variable-length arrays padded along `axis` to the bucket
    boundary of the longest one."""
    longest = max(a.shape[axis] for a in arrays)
    target = bucket_for(longest, boundaries)
    out = []
    for a in arrays:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, target - a.shape[axis])
        out.append(np.pad(a, pad, constant_values=pad_value))
    return np.stack(out)


class BucketBatchSampler:
    """Batches of samples of one bucket.

    `lengths`: each sample's length (or `dataset` with `length_fn`).
    Batches form within each bucket; `shuffle` permutes the samples of
    each bucket and then the batches, from RandomState(seed + epoch)."""

    def __init__(self, dataset=None, lengths: Optional[Sequence[int]] = None,
                 length_fn: Optional[Callable] = None, batch_size: int = 1,
                 boundaries: Optional[Sequence[int]] = None,
                 shuffle: bool = False, drop_last: bool = False, seed=0):
        if lengths is None:
            if dataset is None or length_fn is None:
                raise ValueError(
                    "pass lengths=, or dataset= with length_fn=")
            lengths = [length_fn(dataset[i]) for i in range(len(dataset))]
        self._lengths = list(map(int, lengths))
        self._bs = int(batch_size)
        if boundaries:
            self._boundaries = sorted(boundaries)
            if self._boundaries[-1] < max(self._lengths):
                # fail at once: extending the boundaries here would part
                # from a collate built on the caller's list
                raise ValueError(
                    f"max sample length {max(self._lengths)} exceeds the "
                    f"largest boundary {self._boundaries[-1]}; extend "
                    f"boundaries= or truncate the samples")
        else:
            self._boundaries = bucket_boundaries_pow2(
                16, max(self._lengths))
        self._shuffle = shuffle
        self._drop_last = drop_last
        self._seed = seed
        self._epoch = 0

    @property
    def boundaries(self):
        return list(self._boundaries)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def __iter__(self):
        buckets: dict = {}
        for i, ln in enumerate(self._lengths):
            buckets.setdefault(bucket_for(ln, self._boundaries),
                               []).append(i)
        rng = np.random.RandomState(self._seed + self._epoch) \
            if self._shuffle else None
        batches = []
        for b in sorted(buckets):
            idxs = buckets[b]
            if rng is not None:
                idxs = [idxs[j] for j in rng.permutation(len(idxs))]
            for k in range(0, len(idxs), self._bs):
                chunk = idxs[k:k + self._bs]
                if len(chunk) < self._bs and self._drop_last:
                    continue
                batches.append(chunk)
        if rng is not None:
            batches = [batches[j] for j in rng.permutation(len(batches))]
        return iter(batches)

    def __len__(self):
        n = 0
        buckets: dict = {}
        for ln in self._lengths:
            b = bucket_for(ln, self._boundaries)
            buckets[b] = buckets.get(b, 0) + 1
        for cnt in buckets.values():
            n += cnt // self._bs if self._drop_last else \
                -(-cnt // self._bs)
        return n


def bucketed_collate(boundaries: Sequence[int], axis: int = 0,
                     pad_value=0, batch_size: Optional[int] = None,
                     scalar_pad_value=-100,
                     pad_values: Optional[Sequence] = None) -> Callable:
    """A collate_fn that pads each field of the samples to the batch's
    bucket boundary (with BucketBatchSampler, a batch is of one bucket).
    `batch_size` also pads a short last batch's rows up to it.

    `pad_values` gives each field its fill (e.g. (0, -100) for
    (input_ids, labels), so that padded label positions carry
    cross_entropy's ignore_index); without it sequence fields fill with
    `pad_value` and scalar fields with `scalar_pad_value`."""

    def pad_rows(stacked, fill):
        if batch_size is None or stacked.shape[0] >= batch_size:
            return stacked
        pad = [(0, batch_size - stacked.shape[0])] + \
            [(0, 0)] * (stacked.ndim - 1)
        return np.pad(stacked, pad, constant_values=fill)

    def collate(samples):
        first = samples[0]
        if isinstance(first, (tuple, list)):
            cols = list(zip(*samples))
            if pad_values is not None and len(pad_values) != len(cols):
                raise ValueError(
                    f"pad_values has {len(pad_values)} entries for "
                    f"{len(cols)} sample fields")
            out = []
            for f, col in enumerate(cols):
                if np.asarray(col[0]).ndim > 0:
                    fill = pad_values[f] if pad_values is not None \
                        else pad_value
                    out.append(pad_rows(pad_to_bucket(
                        [np.asarray(c) for c in col], boundaries,
                        axis=axis, pad_value=fill), fill))
                else:
                    fill = pad_values[f] if pad_values is not None \
                        else scalar_pad_value
                    out.append(pad_rows(
                        np.stack([np.asarray(c) for c in col]), fill))
            return tuple(out)
        if pad_values is not None:
            if len(pad_values) != 1:
                raise ValueError(
                    f"pad_values has {len(pad_values)} entries but samples "
                    f"are single arrays (one field)")
            fill = pad_values[0]
        else:
            fill = pad_value
        return pad_rows(pad_to_bucket(
            [np.asarray(s) for s in samples], boundaries, axis=axis,
            pad_value=fill), fill)

    return collate


__all__ = ["BucketBatchSampler", "bucketed_collate", "pad_to_bucket",
           "pad_batch_rows", "bucket_for", "bucket_boundaries_pow2"]
