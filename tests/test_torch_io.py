"""The port's io (paddle_tpu_torch/io: datasets, samplers, collate, the
DataLoader's inline, threaded and forked paths, and bucketing) against
the JAX package's paddle_tpu.io on the same seeded numpy inputs. Index
orders come from numpy's global stream, seeded alike on both sides, and
must be equal; batches are compared bitwise (the port's CPU tensors
against the reference's Tensors as numpy)."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.core.flags import set_flags as jset_flags

import paddle_tpu_torch.io as tio
from paddle_tpu_torch.core.flags import set_flags

torch.set_num_threads(1)

N, DIM = 22, 3


def _samples(n=N, seed=0):
    """(float32 vector, int label, float score) samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    y = rng.integers(0, 5, n)
    s = rng.random(n)
    return [(x[i], int(y[i]), float(s[i])) for i in range(n)]


class PortDS(tio.Dataset):
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class RefDS(jio.Dataset):
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _assert_bitwise(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_bitwise(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _both(make, seed):
    """list(make(pkg)) for each package, numpy's stream seeded alike."""
    np.random.seed(seed)
    want = list(make(jio))
    np.random.seed(seed)
    got = list(make(tio))
    return got, want


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["sequence", "random", "random_repl",
                                  "random_n", "weighted", "weighted_norepl",
                                  "batch_shuffle", "batch_drop"])
def test_sampler_orders(kind, seed):
    ds = list(range(N))
    make = {
        "sequence": lambda m: m.SequenceSampler(ds),
        "random": lambda m: m.RandomSampler(ds),
        "random_repl": lambda m: m.RandomSampler(ds, replacement=True,
                                                 num_samples=30),
        "random_n": lambda m: m.RandomSampler(ds, num_samples=9),
        "weighted": lambda m: m.WeightedRandomSampler(
            np.arange(1, N + 1), 15),
        "weighted_norepl": lambda m: m.WeightedRandomSampler(
            np.arange(1, N + 1), 10, replacement=False),
        "batch_shuffle": lambda m: m.BatchSampler(ds, shuffle=True,
                                                  batch_size=4),
        "batch_drop": lambda m: m.BatchSampler(ds, shuffle=False,
                                               batch_size=4,
                                               drop_last=True),
    }[kind]
    got, want = _both(make, seed)
    assert got == want
    assert len(make(tio)) == len(make(jio))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("nranks", [1, 3, 4])
def test_distributed_batch_sampler_shards(shuffle, drop_last, nranks):
    ds = list(range(N))
    for epoch in (0, 3):
        for rank in range(nranks):
            def make(m):
                s = m.DistributedBatchSampler(
                    ds, 4, num_replicas=nranks, rank=rank, shuffle=shuffle,
                    drop_last=drop_last)
                s.set_epoch(epoch)
                return s
            got, want = list(make(tio)), list(make(jio))
            assert got == want, (epoch, rank)
            assert len(make(tio)) == len(make(jio))


def test_distributed_batch_sampler_defaults_to_one_rank():
    s = tio.DistributedBatchSampler(list(range(N)), 5)
    assert (s.nranks, s.local_rank) == (1, 0)


@pytest.mark.parametrize("lengths", [[10, 12], [0.25, 0.75], [5, 5, 12]])
def test_random_split(lengths):
    ds = list(range(N))
    np.random.seed(3)
    want = [list(s) for s in (jio.random_split(ds, lengths))]
    np.random.seed(3)
    got = tio.random_split(ds, lengths)
    assert [list(s.indices) for s in got] == \
        [[int(i) for i in s] for s in want]
    assert [got[0][i] for i in range(len(got[0]))] == want[0]


def test_random_split_refuses_bad_lengths():
    with pytest.raises(ValueError):
        tio.random_split(list(range(N)), [3, 4])


def test_datasets():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    for m in (tio, jio):
        td = m.TensorDataset([x, y])
        assert len(td) == 6
        np.testing.assert_array_equal(td[2][0], x[2])
    cd = tio.ComposeDataset([tio.TensorDataset([x]), tio.TensorDataset([y])])
    assert len(cd) == 6 and cd[1][1] == 1
    chain = tio.ChainDataset([range(2), range(3)])
    assert [v for v in chain] == [0, 1, 0, 1, 2]
    sub = tio.Subset(PortDS(_samples()), [4, 1])
    assert len(sub) == 2 and sub[1][1] == _samples()[1][1]
    with pytest.raises(RuntimeError):
        len(tio.IterableDataset())


@pytest.mark.parametrize("kind", ["tuple", "dict", "arrays", "ints",
                                  "floats", "strings", "tensors"])
def test_collate_outputs(kind):
    samples = _samples(5)
    batch = {
        "tuple": samples,
        "dict": [{"x": x, "y": y} for x, y, _ in samples],
        "arrays": [x for x, _, _ in samples],
        "ints": [y for _, y, _ in samples],
        "floats": [s for _, _, s in samples],
        "strings": ["a", "b"],
        "tensors": [x for x, _, _ in samples],
    }[kind]
    want = jio.default_collate_fn(batch)
    if kind == "tensors":
        got = tio.default_collate_fn([torch.from_numpy(x) for x in batch])
        num = tio._numpy_collate([torch.from_numpy(x) for x in batch])
    else:
        got = tio.default_collate_fn(batch)
        num = tio._numpy_collate(batch)
    if kind == "strings":
        assert got == want == num
        return
    _assert_bitwise(got, want)
    _assert_bitwise(num, jio._numpy_collate(batch))
    for leaf in (got.values() if isinstance(got, dict) else
                 got if isinstance(got, tuple) else [got]):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"


def _loader_batches(m, ds, **kw):
    return list(m.DataLoader(ds, batch_size=4, **kw))


@pytest.fixture
def fork_flag():
    set_flags({"dataloader_fork_workers": True})
    jset_flags({"dataloader_fork_workers": True})
    yield
    set_flags({"dataloader_fork_workers": False})
    jset_flags({"dataloader_fork_workers": False})


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_inline_and_threaded(workers, shuffle):
    samples = _samples()
    np.random.seed(5)
    want = _loader_batches(jio, RefDS(samples), shuffle=shuffle)
    np.random.seed(5)
    got = _loader_batches(tio, PortDS(samples), shuffle=shuffle,
                          num_workers=workers)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    assert len(tio.DataLoader(PortDS(samples), batch_size=4,
                              drop_last=True)) == 5


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_forked_workers(fork_flag, shuffle):
    samples = _samples()
    np.random.seed(9)
    want = _loader_batches(jio, RefDS(samples), shuffle=shuffle,
                           num_workers=2)
    np.random.seed(9)
    loader = tio.DataLoader(PortDS(samples), batch_size=4, shuffle=shuffle,
                            num_workers=2)
    got = list(loader)
    assert loader._fork_safe()
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    # a custom collate_fn runs in the parent, on the children's samples
    loader = tio.DataLoader(PortDS(samples), batch_size=4, num_workers=2,
                            collate_fn=lambda s: len(s))
    assert list(loader) == [4, 4, 4, 4, 4, 2]


def test_forked_workers_refuse_tensor_samples(fork_flag):
    """A sample holding a torch tensor is read by threads: a forked child
    does no torch work."""
    ds = PortDS([(torch.full((2,), float(i)), i) for i in range(8)])
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2)
    got = list(loader)
    assert not loader._fork_safe()
    assert torch.equal(got[1][0][:, 0], torch.tensor([4., 5., 6., 7.]))


def test_fork_probe_sample_is_read_once(fork_flag):
    """_fork_safe's probe of sample 0 is the sample the child that draws
    index 0 serves: the dataset reads it once (a counter shared with the
    children)."""
    import multiprocessing as mp

    reads = mp.get_context("fork").Value("i", 0)

    class Counting(PortDS):
        def __getitem__(self, i):
            if i == 0:
                with reads.get_lock():
                    reads.value += 1
            return super().__getitem__(i)

    ds = Counting(_samples(8))
    got = list(tio.DataLoader(ds, batch_size=4, num_workers=2))
    assert reads.value == 1
    np.testing.assert_array_equal(got[0][0][0].numpy(), ds.samples[0][0])


def test_forked_epoch_left_early_ends_its_workers(fork_flag):
    """A consumer that stops after one batch: the workers, whose queue
    still holds batches, end at once (their results are drained)."""
    import multiprocessing as mp

    big = PortDS([(np.full((64, 64), i, np.float32), i) for i in range(64)])
    it = iter(tio.DataLoader(big, batch_size=4, num_workers=2))
    first = next(it)
    t = time.perf_counter()
    it.close()
    assert time.perf_counter() - t < 4.0
    assert not mp.active_children()
    assert first[1].tolist() == [0, 1, 2, 3]


class _Boom(tio.Dataset):
    def __init__(self):
        self.decoded = 0

    def __len__(self):
        return 40

    def __getitem__(self, i):
        if i == 6:
            raise RuntimeError("bad sample 6")
        self.decoded += 1
        time.sleep(0.002)
        return np.zeros((2,), "float32")


def test_threaded_worker_error_surfaces_promptly():
    ds = _Boom()
    with pytest.raises(RuntimeError, match="bad sample 6"):
        list(tio.DataLoader(ds, batch_size=2, num_workers=2))
    assert ds.decoded < 30


def test_forked_worker_error_surfaces(fork_flag):
    with pytest.raises(RuntimeError, match="bad sample 6"):
        list(tio.DataLoader(_Boom(), batch_size=2, num_workers=2))


def test_iterable_dataset_batches():
    class It(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype=np.int64))

    got = list(tio.DataLoader(It(), batch_size=4))
    assert [b.tolist() for b in got] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    got = list(tio.DataLoader(It(), batch_size=4, drop_last=True))
    assert len(got) == 2


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_bucket_batch_sampler(shuffle, drop_last):
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, 70, 40).tolist()
    for epoch in (0, 1):
        make = [m.BucketBatchSampler(lengths=lengths, batch_size=3,
                                     shuffle=shuffle, drop_last=drop_last,
                                     seed=4)
                for m in (tio, jio)]
        for s in make:
            s.set_epoch(epoch)
        assert list(make[0]) == list(make[1])
        assert len(make[0]) == len(make[1])
        assert make[0].boundaries == make[1].boundaries
    with pytest.raises(ValueError, match="exceeds"):
        tio.BucketBatchSampler(lengths=[100], boundaries=[16, 32])


@pytest.mark.parametrize("pad_values", [None, (0, -100)])
def test_bucketed_collate_and_pad_to_bucket(pad_values):
    rng = np.random.default_rng(3)
    samples = [(rng.integers(1, 9, n), rng.integers(0, 5, n))
               for n in (5, 9, 3)]
    got = tio.bucketed_collate([8, 16], batch_size=4,
                               pad_values=pad_values)(samples)
    want = jio.bucketed_collate([8, 16], batch_size=4,
                                pad_values=pad_values)(samples)
    _assert_bitwise(list(got), list(want))
    arrays = [a for a, _ in samples]
    _assert_bitwise(tio.pad_to_bucket(arrays, [4, 32], pad_value=-1),
                    jio.pad_to_bucket(arrays, [4, 32], pad_value=-1))
    scalars = [(a, 3) for a, _ in samples]
    _assert_bitwise(list(tio.bucketed_collate([16], batch_size=4)(scalars)),
                    list(jio.bucketed_collate([16], batch_size=4)(scalars)))
