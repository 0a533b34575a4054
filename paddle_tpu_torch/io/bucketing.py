"""Length bucketing (counterpart of paddle_tpu/io/bucketing.py, cut to
the two functions the generation engine uses).

Each prompt pads up to its bucket and each decode batch to its batch
bucket, so the engine runs a fixed, small set of shapes: one prefill
per prompt bucket, one decode step per batch bucket, each run once on
the device before a worker admits traffic.
"""
from __future__ import annotations

from typing import List, Sequence


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
