"""Epoch samplers with streams of their own (counterpart of
paddle_tpu/io/pipeline/sampler.py; numpy only, so the index orders are
bitwise the reference's).

The shuffled order of epoch E is a function of ``(seed, epoch)`` alone,
drawn from a ``np.random.RandomState`` the sampler owns: nothing reads or
writes numpy's global stream, so two pipelines (or a pipeline and a
transform's augmentation) cannot disturb each other, and a restarted
process reproduces the batch order from three integers. A checkpoint's
position is ``(seed, epoch, next batch)``: resume recomputes the
permutation (index arithmetic, no ``__getitem__``) and slices it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    """The sampler's stream for one epoch."""
    return np.random.RandomState((int(seed) * 1000003 + int(epoch))
                                 % (1 << 32))


class EpochSampler:
    """Deterministic batches of dataset indices for one epoch.

    shard_rank/shard_count split the schedule across ranks; two layouts:

    - ``shard_mode="sample"`` (default, the DistributedBatchSampler
      split): the index list is padded to a multiple of shard_count by
      wrapping, then STRIDED — every rank sees the same number of
      batches.
    - ``shard_mode="batch"`` (the mesh-runtime dp layout): the plan is
      built from GLOBAL batches of ``batch_size * shard_count`` rows
      and rank r takes the r-th CONTIGUOUS ``batch_size``-row slice of
      each. Assembling the rank shards in rank order reproduces the
      single-process global batch row for row, which makes a
      multi-process data-parallel run bitwise comparable to the
      single-process one.
    """

    def __init__(self, length: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0,
                 shard_rank: int = 0, shard_count: int = 1,
                 shard_mode: str = "sample"):
        if length <= 0:
            raise ValueError(f"empty dataset (length={length})")
        if not (0 <= shard_rank < shard_count):
            raise ValueError(
                f"shard_rank {shard_rank} outside [0, {shard_count})")
        if shard_mode not in ("sample", "batch"):
            raise ValueError(f"shard_mode {shard_mode!r} not in "
                             f"('sample', 'batch')")
        self.length = int(length)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.shard_rank = int(shard_rank)
        self.shard_count = int(shard_count)
        self.shard_mode = shard_mode

    def _shard_indices(self, epoch: int) -> List[int]:
        if self.shuffle:
            indices = _epoch_rng(self.seed, epoch).permutation(
                self.length).tolist()
        else:
            indices = list(range(self.length))
        if self.shard_count > 1:
            total = -(-self.length // self.shard_count) * self.shard_count
            if len(indices) < total:
                # tile (not a single wrap slice): shard_count can exceed
                # the dataset length, and every rank must still get the
                # same number of batches or per-step collectives hang
                reps = -(-total // len(indices))
                indices = (indices * reps)[:total]
            indices = indices[self.shard_rank::self.shard_count]
        return indices

    def _all_indices(self, epoch: int) -> List[int]:
        if self.shuffle:
            return _epoch_rng(self.seed, epoch).permutation(
                self.length).tolist()
        return list(range(self.length))

    def batches(self, epoch: int) -> List[List[int]]:
        """Every batch of `epoch`, in order. O(n) index arithmetic, zero
        dataset access — resume slices this list."""
        bs = self.batch_size
        if self.shard_mode == "batch" and self.shard_count > 1:
            # contiguous rank slice of each GLOBAL batch (see class doc)
            indices = self._all_indices(epoch)
            g = bs * self.shard_count
            full = [indices[i:i + g] for i in range(0, len(indices), g)]
            if full and len(full[-1]) < g:
                if self.drop_last:
                    full.pop()
                else:
                    # pad the tail by wrapping so every rank still gets
                    # a slice (unequal per-rank rows would desync the
                    # per-step global batch assembly)
                    tail = full[-1]
                    need = -(-len(tail) // self.shard_count) * \
                        self.shard_count
                    reps = -(-need // len(indices)) + 1
                    full[-1] = (tail + indices * reps)[:need]
            out = []
            for b in full:
                k = len(b) // self.shard_count
                out.append(b[self.shard_rank * k:
                             (self.shard_rank + 1) * k])
            return out
        indices = self._shard_indices(epoch)
        out = [indices[i:i + bs] for i in range(0, len(indices), bs)]
        if out and len(out[-1]) < bs and self.drop_last:
            out.pop()
        return out

    def __len__(self) -> int:
        if self.shard_mode == "batch" and self.shard_count > 1:
            g = self.batch_size * self.shard_count
            if self.drop_last:
                return self.length // g
            return -(-self.length // g)
        n = -(-self.length // self.shard_count)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class BucketEpochSampler:
    """Length-bucketed epoch batches through io.bucketing's
    BucketBatchSampler, a function of ``(seed, epoch)``: batches of one
    bucket, so every batch pads to one of len(boundaries) shapes.

    `lengths` is per-sample metadata (ints). Pass it directly when you
    have it; `length_fn` probes every sample ONCE at construction (that
    is a full decode pass — acceptable for metadata-light datasets,
    never repeated on resume).
    """

    def __init__(self, length: int, batch_size: int,
                 lengths: Optional[Sequence[int]] = None,
                 boundaries: Optional[Sequence[int]] = None,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: int = 0, shard_rank: int = 0,
                 shard_count: int = 1):
        from ..bucketing import BucketBatchSampler

        if lengths is None or len(lengths) != length:
            raise ValueError(
                f"bucket sampler needs one length per sample "
                f"(got {0 if lengths is None else len(lengths)} for "
                f"{length} samples)")
        if not (0 <= shard_rank < shard_count):
            raise ValueError(
                f"shard_rank {shard_rank} outside [0, {shard_count})")
        self.length = int(length)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shard_rank = int(shard_rank)
        self.shard_count = int(shard_count)
        self._inner = BucketBatchSampler(
            lengths=list(lengths), batch_size=batch_size,
            boundaries=boundaries, shuffle=shuffle, drop_last=drop_last,
            seed=0)
        self.boundaries = self._inner.boundaries

    def _full_plan(self, epoch: int) -> List[List[int]]:
        # BucketBatchSampler keys its RNG on seed + epoch; feed it the
        # sampler-local fold so the stream stays (seed, epoch)-pure.
        # The FULL plan is a pure function of (seed, epoch) — identical
        # on every rank, which is what makes the shard split below a
        # partition of one global schedule rather than N disagreeing
        # ones (every rank would otherwise train on EVERY sample)
        self._inner._seed = int(_epoch_rng(self.seed, epoch)
                                .randint(1 << 31))
        self._inner.set_epoch(0)
        return [list(b) for b in self._inner]

    def batches(self, epoch: int) -> List[List[int]]:
        plan = self._full_plan(epoch)
        if self.shard_count <= 1:
            return plan
        # shard the BATCH plan (same-bucket batches stay intact, so the
        # pow2 pad-shape policy survives sharding): pad to a multiple of
        # shard_count by wrapping whole batches, then stride — every
        # rank gets the same batch COUNT or per-step collectives hang
        total = -(-len(plan) // self.shard_count) * self.shard_count
        if len(plan) < total:
            reps = -(-total // len(plan))
            plan = (plan * reps)[:total]
        return plan[self.shard_rank::self.shard_count]

    def __len__(self) -> int:
        return -(-len(self._inner) // self.shard_count)


__all__ = ["EpochSampler", "BucketEpochSampler"]
