"""Composable streaming input pipeline (counterpart of
paddle_tpu/io/pipeline/core.py).

Three properties the DataLoader lacks:

- **index-driven stages**: the batch sequence of epoch E is a function
  of (seed, epoch) drawn by the sampler's own stream
  (sampler.EpochSampler), so no stage touches a global RNG;
- **an O(1) checkpoint position**: ``state_dict()`` is
  ``{epoch, batch, seed}``; after ``load_state_dict()`` the next
  ``iter_epoch()`` skips ahead by index arithmetic, and the skipped
  prefix costs no ``__getitem__`` or decode;
- **device prefetch**: a DevicePrefetcher keeps `depth` batches resident
  on the card, copied on a CUDA stream of its own, so step N+1's copy
  runs under step N's kernels and the step loop does not wait for
  input.

Usage::

    pipe = (pipeline.from_dataset(ds, shuffle=True, seed=0)
            .map(decode)                  # per sample, in the workers
            .batch(32, drop_last=True)    # numpy collate
            .workers(4)                   # host decode threads
            .device_prefetch(2))          # on the card, two ahead
    for epoch in range(epochs):
        for x, y in pipe.iter_epoch(epoch):
            train_step(x, y)

Its metrics are the ``"input_pipeline"`` section of
``profiler.summary_dict()`` (metrics.py). Meshes and sharded batches
(`device_prefetch(mesh=, batch_sharding=)`) are ROADMAP queue 5.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from . import metrics as _metrics
from .prefetch import DevicePrefetcher, HostPrefetcher
from .sampler import BucketEpochSampler, EpochSampler

_STATE_VERSION = 1


_QUEUE5 = "ROADMAP queue 5 (meshes, sharding and ZeRO)"


def _default_collate(samples):
    # numpy collate: the stages stay on the host, and the copy to the
    # device is the DevicePrefetcher's
    from .. import _numpy_collate

    return _numpy_collate(samples)


class Pipeline:
    """A dataset + sampler + stage list; build with from_dataset()."""

    def __init__(self, dataset, *, shuffle: bool = False, seed: int = 0,
                 shard_rank: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 shard_mode: str = "sample"):
        self.dataset = dataset
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        # None defaults to this process's slot in torch.distributed's
        # group, resolved at the first plan: the pipeline may be built
        # before the group is initialised
        self._shard = (None if shard_rank is None else int(shard_rank),
                       None if shard_count is None else int(shard_count))
        self._shard_mode = shard_mode
        self._maps: List[Callable] = []
        self._batch_maps: List[Callable] = []
        self._batch_size: Optional[int] = None
        self._drop_last = False
        self._collate: Callable = _default_collate
        self._bucket_cfg = None
        self._workers = 0
        self._prefetch_factor = 2
        self._device_depth = 0
        self._device = None
        self._sampler = None
        self._epoch = 0              # next epoch __iter__ starts
        self._resume = None          # (epoch, batch) from load_state_dict
        self._cur_iter: Optional[PipelineIterator] = None
        self.metrics = _metrics.PipelineMetrics()
        _metrics.track(self)

    # ------------------------------------------------------------ stages --
    def map(self, fn: Callable) -> "Pipeline":
        """Per-sample transform, applied in the decode workers."""
        self._maps.append(fn)
        self._sampler = None
        return self

    def batch(self, batch_size: int, drop_last: bool = False,
              collate_fn: Optional[Callable] = None) -> "Pipeline":
        """Group `batch_size` samples per batch (numpy collate)."""
        self._batch_size = int(batch_size)
        self._drop_last = bool(drop_last)
        if collate_fn is not None:
            self._collate = collate_fn
        self._bucket_cfg = None
        self._sampler = None
        return self

    def bucket(self, batch_size: int,
               lengths: Optional[Sequence[int]] = None,
               length_fn: Optional[Callable] = None,
               boundaries: Optional[Sequence[int]] = None,
               drop_last: bool = False, pad_value=0,
               pad_values: Optional[Sequence] = None) -> "Pipeline":
        """Length-bucketed batches, each field padded to its bucket's
        boundary (io.bucketing's pad_to_bucket; powers of two unless
        `boundaries` are given). Pass `lengths` (one int a sample) when
        known; `length_fn` decodes every sample once here to measure it
        (never again on resume)."""
        if lengths is None:
            if length_fn is None:
                raise ValueError("bucket() needs lengths= or length_fn=")
            lengths = [int(length_fn(self.dataset[i]))
                       for i in range(len(self.dataset))]
        self._batch_size = int(batch_size)
        self._drop_last = bool(drop_last)
        self._bucket_cfg = {"lengths": list(lengths),
                            "boundaries": boundaries,
                            "pad_value": pad_value,
                            "pad_values": pad_values}
        self._sampler = None
        return self

    def batch_map(self, fn: Callable) -> "Pipeline":
        """Post-collate transform on the whole (numpy) batch, still in
        the workers."""
        self._batch_maps.append(fn)
        return self

    def workers(self, num_workers: int,
                prefetch_factor: int = 2) -> "Pipeline":
        """Decode batches `num_workers` wide in a host thread pool
        (delivered in order; 0 decodes inline in next())."""
        self._workers = max(0, int(num_workers))
        self._prefetch_factor = max(1, int(prefetch_factor))
        return self

    def device_prefetch(self, depth: int = 2, device=None, mesh=None,
                        batch_sharding=None) -> "Pipeline":
        """Keep `depth` batches resident on `device` (None: the card),
        copied on a CUDA stream of the prefetcher's own."""
        if mesh is not None or batch_sharding is not None:
            raise NotImplementedError(
                f"device_prefetch(mesh=, batch_sharding=) is not ported: "
                f"{_QUEUE5}")
        self._device_depth = max(0, int(depth))
        self._device = device
        return self

    # ----------------------------------------------------------- plan -----
    def resolved_shard(self):
        """(rank, count), None defaults filled from torch.distributed's
        group ((0, 1) without one). A multi-process launch
        (PADDLE_TRAINERS_NUM > 1) whose group is not initialised yet
        raises rather than plan every rank over every sample."""
        import os

        rank, count = self._shard
        if rank is None or count is None:
            import torch.distributed as dist

            initialised = dist.is_available() and dist.is_initialized()
            if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1 \
                    and not initialised:
                raise RuntimeError(
                    "multi-process launch detected (PADDLE_TRAINERS_NUM > "
                    "1) but torch.distributed is not initialized; call "
                    "init_process_group before planning the pipeline, or "
                    "pass shard_rank/shard_count explicitly")
            prank, pcount = (dist.get_rank(), dist.get_world_size()) \
                if initialised else (0, 1)
            rank = prank if rank is None else rank
            count = pcount if count is None else count
        return int(rank), int(count)

    def _get_sampler(self):
        if self._sampler is not None:
            return self._sampler
        if self._batch_size is None:
            raise ValueError("pipeline has no batch stage: call "
                             ".batch(batch_size) or .bucket(...)")
        n = len(self.dataset)
        rank, count = self.resolved_shard()
        if self._bucket_cfg is not None:
            if self._shard_mode == "batch" and count > 1:
                raise ValueError(
                    "bucket() shards whole same-bucket batches "
                    "(batch-plan striding); shard_mode='batch' "
                    "contiguous-slice layout does not apply — drop "
                    "shard_mode or use batch() for bitwise dp runs")
            cfg = self._bucket_cfg
            # the bucketed batch plan is sharded (whole batches strided
            # over the ranks): the full plan is a function of (seed,
            # epoch), the same on every rank, so the ranks partition it
            self._sampler = BucketEpochSampler(
                n, self._batch_size, lengths=cfg["lengths"],
                boundaries=cfg["boundaries"], shuffle=self._shuffle,
                drop_last=self._drop_last, seed=self._seed,
                shard_rank=rank, shard_count=count)
            from ..bucketing import bucketed_collate

            self._collate = bucketed_collate(
                self._sampler.boundaries, pad_value=cfg["pad_value"],
                pad_values=cfg["pad_values"],
                batch_size=self._batch_size if not self._drop_last
                else None)
        else:
            self._sampler = EpochSampler(
                n, self._batch_size, shuffle=self._shuffle,
                drop_last=self._drop_last, seed=self._seed,
                shard_rank=rank, shard_count=count,
                shard_mode=self._shard_mode)
        return self._sampler

    def plan(self, epoch: int) -> List[List[int]]:
        """Every batch's indices for `epoch`: index arithmetic, no
        dataset access."""
        return self._get_sampler().batches(epoch)

    def __len__(self) -> int:
        return len(self._get_sampler())

    # ------------------------------------------------------ checkpointing --
    def state_dict(self) -> dict:
        """The O(1) position (epoch, next batch, seed), counting batches
        handed to the consumer; batches the workers or the device buffer
        took ahead are not counted (they decode again on resume)."""
        if self._resume is not None:
            # restored but not entered yet (a save can come between
            # load_state_dict and the restored epoch's first batch): the
            # position is the restored one, not batch 0
            epoch, batch = self._resume
            return {"version": _STATE_VERSION, "epoch": epoch,
                    "batch": batch, "seed": self._seed}
        it = self._cur_iter
        if it is not None and not it.done:
            return {"version": _STATE_VERSION, "epoch": it.epoch,
                    "batch": it.consumed, "seed": self._seed}
        return {"version": _STATE_VERSION, "epoch": self._epoch,
                "batch": 0, "seed": self._seed}

    def load_state_dict(self, state: dict) -> None:
        if int(state.get("version", 1)) != _STATE_VERSION:
            raise ValueError(
                f"unsupported pipeline state version "
                f"{state.get('version')}")
        if int(state.get("seed", self._seed)) != self._seed:
            raise ValueError(
                f"pipeline state was saved with seed "
                f"{state.get('seed')} but this pipeline uses seed "
                f"{self._seed}: the shuffled orders would differ")
        self._resume = (int(state["epoch"]), int(state["batch"]))
        self._epoch = int(state["epoch"])
        self.metrics.resumes += 1

    # ------------------------------------------------------------ iterate --
    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def epoch(self) -> int:
        """Next epoch __iter__ would start (the resume epoch after
        load_state_dict)."""
        return self._resume[0] if self._resume is not None else self._epoch

    def iter_epoch(self, epoch: int) -> "PipelineIterator":
        """Iterate epoch `epoch`. After load_state_dict, epochs before the
        restored one yield nothing (they ran; no decode), the restored
        epoch starts at the restored batch, later epochs run whole."""
        epoch = int(epoch)
        start = 0
        if self._resume is not None:
            r_epoch, r_batch = self._resume
            if epoch < r_epoch:
                return PipelineIterator(self, epoch, 0, empty=True)
            if epoch == r_epoch:
                start = r_batch
            self._resume = None
        if self._cur_iter is not None:
            self._cur_iter.close()
        it = PipelineIterator(self, epoch, start)
        self._cur_iter = it
        self._epoch = epoch
        return it

    def __iter__(self):
        return self.iter_epoch(self.epoch)

    def close(self) -> None:
        if self._cur_iter is not None:
            self._cur_iter.close()
            self._cur_iter = None


class PipelineIterator:
    """One epoch's traversal, resumed or not. `consumed` counts the
    batches handed to the consumer: the pipeline's checkpoint
    position."""

    def __init__(self, pipe: Pipeline, epoch: int, start: int,
                 empty: bool = False):
        self.pipe = pipe
        self.epoch = int(epoch)
        self.start = int(start)
        self.consumed = int(start)
        self.done = False
        m = pipe.metrics
        if empty:
            self.done = True
            self._device = None
            self._host = None
            self._inline = iter(())
            return
        batches = pipe.plan(epoch)
        if start > 0:
            m.fast_forwarded_batches += min(start, len(batches))
        todo = batches[start:]
        m.epochs_started += 1
        self._host = None
        self._inline = None
        if pipe._workers > 0:
            self._host = HostPrefetcher(self._fetch, iter(todo),
                                        pipe._workers,
                                        pipe._prefetch_factor, metrics=m)
            src = self._host.__next__
        else:
            it = iter(todo)

            def src():
                try:
                    indices = next(it)
                except StopIteration:
                    raise
                return self._fetch(indices)
        self._src = src
        self._device = None
        if pipe._device_depth > 0:
            self._device = DevicePrefetcher(
                src, depth=pipe._device_depth, device=pipe._device,
                metrics=m)

    def _fetch(self, indices):
        pipe = self.pipe
        t0 = time.perf_counter()
        samples = [pipe.dataset[i] for i in indices]
        for fn in pipe._maps:
            samples = [fn(s) for s in samples]
        batch = pipe._collate(samples)
        for fn in pipe._batch_maps:
            batch = fn(batch)
        pipe.metrics.on_decode(len(indices), time.perf_counter() - t0)
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        if self.done:
            raise StopIteration
        t0 = time.perf_counter()
        try:
            if self._device is not None:
                batch = self._device.__next__()
            else:
                batch = self._src()
        except StopIteration:
            self._finish()
            raise
        except BaseException:
            self.close()
            raise
        self.pipe.metrics.on_next(time.perf_counter() - t0)
        self.consumed += 1
        return batch

    def _finish(self):
        """The epoch ended: the pipeline's next epoch begins."""
        self.done = True
        if self.pipe._cur_iter is self:
            self.pipe._epoch = self.epoch + 1
        self.close()

    def close(self):
        self.done = True
        if self._device is not None:
            self._device.close()
        if self._host is not None:
            self._host.close()


def from_dataset(dataset, *, shuffle: bool = False, seed: int = 0,
                 shard_rank: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 shard_mode: str = "sample") -> Pipeline:
    """A Pipeline over a map-style Dataset (__getitem__, __len__).

    shard_rank/shard_count default to this process's slot in
    torch.distributed's group (resolved at the first plan). shard_mode
    "sample" strides samples (DistributedBatchSampler's layout); "batch"
    gives each rank its contiguous slice of one global batch."""
    return Pipeline(dataset, shuffle=shuffle, seed=seed,
                    shard_rank=shard_rank, shard_count=shard_count,
                    shard_mode=shard_mode)


__all__ = ["Pipeline", "PipelineIterator", "from_dataset"]
