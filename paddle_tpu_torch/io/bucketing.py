"""Length bucketing (counterpart of paddle_tpu/io/bucketing.py, cut to
the functions the serving engines use).

Each prompt pads up to its bucket and each decode batch to its batch
bucket, so the generation engine runs a fixed, small set of shapes: one
prefill per prompt bucket, one decode step per batch bucket, each run
once on the device before a worker admits traffic. The predict engine
pads each coalesced batch's rows to its batch bucket (`pad_batch_rows`)
and dynamic non-batch axes to their sequence bucket.
"""
from __future__ import annotations

from typing import List, Sequence

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
