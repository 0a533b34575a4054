"""Datasets, samplers and the DataLoader (counterpart of
paddle_tpu/io/__init__.py).

Batches come out as CPU torch tensors; the step that takes them moves
them to the model's device (jit.TrainStep), or an io.Pipeline with
`device_prefetch` puts them on the card ahead of the step. Samplers draw
from numpy's global stream exactly where the reference does, so a
seeded run visits the same indices in the same order.

DataLoader's workers (num_workers > 0) are threads (io.pipeline's
HostPrefetcher, in-order futures) or, under FLAGS_dataloader_fork_workers,
forked processes. A forked child does no torch work: it fetches and
collates to numpy (`_numpy_collate`), and the parent makes the tensors,
since a child of a process that holds a CUDA context and torch's thread
pools must not touch either. A dataset whose samples hold a torch tensor
is therefore read by threads (`_fork_safe`).
"""
from __future__ import annotations

import itertools
import queue
import time

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "BatchSampler", "DistributedBatchSampler",
    "WeightedRandomSampler", "DataLoader", "get_worker_info",
    "default_collate_fn", "BucketBatchSampler", "bucketed_collate",
    "pad_to_bucket", "bucket_for", "bucket_boundaries_pow2", "pipeline",
    "Pipeline", "from_dataset",
]

from .bucketing import (  # noqa: E402,F401
    BucketBatchSampler, bucket_boundaries_pow2, bucket_for,
    bucketed_collate, pad_to_bucket)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (list, tuple)) else [s])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions) over one permutation
    from numpy's global stream."""
    total = len(dataset)
    if sum(lengths) != total:
        if all(0 < l < 1 for l in lengths):
            lengths = [int(l * total) for l in lengths]
            lengths[-1] = total - sum(lengths[:-1])
        else:
            raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(total).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l]))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype="float64")
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(rank, world size) of the initialised torch.distributed group, or
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches: the index list (shuffled by
    RandomState(epoch)) padded by wrapping to a multiple of the ranks,
    then strided. Ranks default to torch.distributed's group."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            g_rank, g_world = _world()
            num_replicas = num_replicas or g_world
            rank = rank if rank is not None else g_rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            g = np.random.RandomState(self.epoch)
            indices = g.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


def _numpy_collate(batch):
    """Collate to numpy (a forked worker's collate: no torch work)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([b.numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype="int64")
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype="float32")
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _numpy_collate([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(_numpy_collate(list(f)) for f in zip(*batch))
    raise TypeError(f"cannot collate {type(sample)}")


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors (the reference's
    default_collate_fn, whose Tensors are torch tensors here)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype="int64"))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype="float32"))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(f)) for f in zip(*batch))
    raise TypeError(f"cannot collate {type(sample)}")


def _to_tensors(batch):
    """Every numpy array in a collated batch as a CPU tensor (the
    parent's half of a forked worker's collate)."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, dict):
        return {k: _to_tensors(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_tensors(v) for v in batch)
    return batch


def _holds_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, dict):
        return any(_holds_tensor(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_tensor(v) for v in x)
    return False


class DataLoader:
    """Batches of a map-style or iterable dataset.

    num_workers = 0 fetches inline; otherwise `num_workers` threads
    decode `num_workers * prefetch_factor` batches ahead, delivered in
    order (io.pipeline.HostPrefetcher), or, under
    FLAGS_dataloader_fork_workers and for samples that hold no tensor,
    forked processes do (`_iter_multiprocess`)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        # the sample that _fork_safe's dataset[0] probe read, served to
        # the first fetch of index 0, so that a dataset with side effects
        # is not read twice
        self._probe_sample = None
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        samples = []
        for i in indices:
            if i == 0 and self._probe_sample is not None:
                samples.append(self._probe_sample)
                self._probe_sample = None
            else:
                samples.append(self.dataset[i])
        return self.collate_fn(samples)

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        from ..core.flags import flag

        if self.use_shared_memory and flag("dataloader_fork_workers") \
                and self._fork_safe():
            yield from self._iter_multiprocess()
            return
        # threads: a worker's exception anywhere in the window surfaces
        # at once and cancels the queue
        from .pipeline.prefetch import HostPrefetcher

        hp = HostPrefetcher(self._fetch, iter(self.batch_sampler),
                            self.num_workers, self.prefetch_factor)
        try:
            yield from hp
        finally:
            hp.close()

    def _fork_safe(self) -> bool:
        """Whether forked workers may read this dataset: its first sample
        holds no torch tensor (a child does no torch work, on the card or
        off it). Cached per loader; the probed sample is kept for the
        first fetch of index 0 (`_probe_sample`)."""
        cached = getattr(self, "_fork_safe_cache", None)
        if cached is not None:
            return cached
        try:
            sample = self.dataset[0]
        except Exception:
            self._fork_safe_cache = False
            return False
        self._probe_sample = sample
        self._fork_safe_cache = not _holds_tensor(sample)
        return self._fork_safe_cache

    def _iter_multiprocess(self):
        """Forked worker processes fetch and collate to numpy; the parent
        makes the tensors (and runs a custom collate_fn). In-order
        delivery by batch sequence numbers."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        dataset = self.dataset
        default = self.collate_fn is default_collate_fn
        # each child inherits the probe sample; the one that draws index
        # 0 serves it instead of reading the dataset again
        probe = {0: self._probe_sample} if self._probe_sample is not None \
            else {}

        def fetch_one(i):
            if i in probe:
                return probe.pop(i)
            return dataset[i]

        def worker(wid):
            if self.worker_init_fn is not None:
                self.worker_init_fn(wid)
            while True:
                item = index_q.get()
                if item is None:
                    return
                seq, indices = item
                try:
                    samples = [fetch_one(i) for i in indices]
                    payload = _numpy_collate(samples) if default else samples
                    result_q.put((seq, payload, None))
                except Exception as e:  # delivered to the parent
                    result_q.put((seq, None, repr(e)))

        workers = [ctx.Process(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for p in workers:
            p.start()
        # the children own the probe now; later epochs fork afresh
        self._probe_sample = None
        try:
            batches = iter(self.batch_sampler)
            depth = self.num_workers * self.prefetch_factor
            seq_in = 0
            for indices in itertools.islice(batches, depth):
                index_q.put((seq_in, list(indices)))
                seq_in += 1
            seq_out = 0
            hold = {}
            while seq_out < seq_in:
                while seq_out not in hold:
                    try:
                        seq, batch, err = result_q.get(timeout=5)
                    except queue.Empty:
                        dead = [p for p in workers if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker died (exitcode "
                                f"{dead[0].exitcode}) without delivering a "
                                f"batch") from None
                        continue
                    hold[seq] = (batch, err)
                batch, err = hold.pop(seq_out)
                seq_out += 1
                nxt = next(batches, None)
                if nxt is not None:
                    index_q.put((seq_in, list(nxt)))
                    seq_in += 1
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                yield _to_tensors(batch) if default else \
                    self.collate_fn(batch)
        finally:
            for _ in workers:
                index_q.put(None)
            # drain the results while the children exit: a child whose
            # queue still holds batches waits for them to be read before
            # it can end (an epoch left early)
            deadline = time.monotonic() + 5
            for p in workers:
                while p.is_alive() and time.monotonic() < deadline:
                    try:
                        while True:
                            result_q.get_nowait()
                    except queue.Empty:
                        pass
                    p.join(timeout=0.05)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)

    def __call__(self):
        return self.__iter__()


# imported last: pipeline/core.py reaches back into this module for the
# collate functions, which must be defined by then
from . import pipeline  # noqa: E402
from .pipeline import Pipeline, from_dataset  # noqa: E402,F401
