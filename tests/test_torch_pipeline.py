"""The port's streaming input pipeline (paddle_tpu_torch/io/pipeline)
against the JAX package's on the same datasets: the epoch plans (shuffled,
sharded by sample and by batch, bucketed) and the batches bitwise; the
bucket stage's padding; the O(1) checkpoint position and its resume with
zero decodes of the skipped prefix (after tests/test_input_pipeline.py's
checkpointable-resume cases); a worker's error surfacing promptly; the
device prefetch on the CPU (the plain copy: bitwise the host batches);
and the "input_pipeline" section of the metrics bus."""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.io import pipeline as jpipe

import paddle_tpu_torch.io as tio
from paddle_tpu_torch import profiler
from paddle_tpu_torch.io import pipeline as tpipe
from paddle_tpu_torch.observability import bus

torch.set_num_threads(1)


class CountingDS:
    """Deterministic by index; counts every decode (numpy only, so one
    instance type serves both packages)."""

    def __init__(self, n=32, dim=4, delay=0.0):
        self.n = n
        self.dim = dim
        self.delay = delay
        self.count = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.count += 1
        if self.delay:
            time.sleep(self.delay)
        rng = np.random.RandomState(777 + i)
        return (rng.randn(self.dim).astype("float32"), np.int64(i))


def _np(batch):
    return [b.numpy() if hasattr(b, "numpy") else np.asarray(b)
            for b in batch]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_np(g), _np(w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3), (2, 3), (5, 40)])
@pytest.mark.parametrize("mode", ["sample", "batch"])
def test_epoch_plans_equal_the_reference(shuffle, drop_last, shard, mode):
    rank, count = shard
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=9,
              shard_rank=rank, shard_count=count, shard_mode=mode)
    got = tpipe.EpochSampler(17, 4, **kw)
    want = jpipe.EpochSampler(17, 4, **kw)
    before = np.random.get_state()[1].copy()
    for epoch in range(3):
        assert got.batches(epoch) == want.batches(epoch)
    assert len(got) == len(want)
    # the sampler's own stream: numpy's global one is untouched
    np.testing.assert_array_equal(before, np.random.get_state()[1])


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_bucket_plans_equal_the_reference(shard):
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 70, 50).tolist()
    kw = dict(lengths=lengths, shuffle=True, seed=3, shard_rank=shard[0],
              shard_count=shard[1])
    got = tpipe.BucketEpochSampler(50, 4, **kw)
    want = jpipe.BucketEpochSampler(50, 4, **kw)
    for epoch in range(2):
        assert got.batches(epoch) == want.batches(epoch)
    assert len(got) == len(want) and got.boundaries == want.boundaries
    with pytest.raises(ValueError, match="one length per sample"):
        tpipe.BucketEpochSampler(50, 4, lengths=lengths[:3])


def _pipes(build, **kw):
    return (build(tpipe.from_dataset(CountingDS(**kw), shuffle=True,
                                     seed=5, shard_rank=0, shard_count=1)),
            build(jpipe.from_dataset(CountingDS(**kw), shuffle=True,
                                     seed=5, shard_rank=0, shard_count=1)))


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_and_plan_equal_the_reference(workers):
    def build(p):
        return p.map(lambda s: (s[0] * 2, s[1])).batch(5) \
            .batch_map(lambda b: (b[0] + 1, b[1])).workers(workers)

    tp, jp = _pipes(build)
    for epoch in range(2):
        assert tp.plan(epoch) == jp.plan(epoch)
        _assert_batches_equal(list(tp.iter_epoch(epoch)),
                              list(jp.iter_epoch(epoch)))
    assert len(tp) == len(jp) == 7
    assert tp.state_dict() == jp.state_dict()


def test_bucket_stage_pads_like_the_reference():
    class Ragged:
        def __len__(self):
            return 24

        def __getitem__(self, i):
            n = 3 + (i * 7) % 29
            return (np.arange(n, dtype=np.int64) + i + 1,
                    np.full(n, i % 5, dtype=np.int64))

    lengths = [3 + (i * 7) % 29 for i in range(24)]
    got = tpipe.from_dataset(Ragged(), shuffle=True, seed=2, shard_rank=0,
                             shard_count=1).bucket(4, lengths=lengths,
                                                   pad_values=(0, -100))
    want = jpipe.from_dataset(Ragged(), shuffle=True, seed=2, shard_rank=0,
                              shard_count=1).bucket(4, lengths=lengths,
                                                    pad_values=(0, -100))
    gb, wb = list(got.iter_epoch(0)), list(want.iter_epoch(0))
    _assert_batches_equal(gb, wb)
    bounds = got._get_sampler().boundaries
    assert bounds == [16, 31]
    for ids, labels in gb:
        assert ids.shape[1] in bounds and ids.shape[0] == 4
        assert (labels[ids == 0] == -100).all()
    # length_fn measures every sample once, to the same plan
    p = tpipe.from_dataset(Ragged(), shuffle=True, seed=2, shard_rank=0,
                           shard_count=1).bucket(
        4, length_fn=lambda s: len(s[0]))
    assert p.plan(0) == got.plan(0)


def test_batch_stage_required():
    p = tpipe.from_dataset(CountingDS(), shard_rank=0, shard_count=1)
    with pytest.raises(ValueError, match="batch"):
        p.plan(0)


def test_worker_error_surfaces_promptly_and_cancels():
    class Boom:
        decoded = 0

        def __len__(self):
            return 40

        def __getitem__(self, i):
            if i == 6:
                raise RuntimeError("bad sample 6")
            Boom.decoded += 1
            time.sleep(0.002)
            return np.zeros((2,), "float32")

    p = tpipe.from_dataset(Boom(), shard_rank=0, shard_count=1) \
        .batch(2).workers(2)
    with pytest.raises(RuntimeError, match="bad sample 6"):
        list(p.iter_epoch(0))
    assert Boom.decoded < 30


def _seeded(ds=None):
    return tpipe.from_dataset(ds or CountingDS(), shuffle=True, seed=11,
                              shard_rank=0, shard_count=1).batch(4)


def test_resume_with_zero_decodes_of_the_skipped_prefix():
    full = list(_seeded())
    p1 = _seeded()
    it = iter(p1)
    for _ in range(3):
        next(it)
    state = p1.state_dict()
    assert state == {"version": 1, "epoch": 0, "batch": 3, "seed": 11}
    ds2 = CountingDS()
    p2 = _seeded(ds2)
    p2.load_state_dict(state)
    rest = list(p2)
    assert ds2.count == 32 - 3 * 4
    _assert_batches_equal(rest, full[3:])
    # the reference resumes from the port's state to the same batches
    jp = jpipe.from_dataset(CountingDS(), shuffle=True, seed=11,
                            shard_rank=0, shard_count=1).batch(4)
    jp.load_state_dict(state)
    _assert_batches_equal(list(jp), rest)


def test_resume_skips_whole_epochs_and_keeps_a_pending_position():
    state = {"version": 1, "epoch": 2, "batch": 1, "seed": 4}
    ds = CountingDS()
    p = tpipe.from_dataset(ds, shuffle=True, seed=4, shard_rank=0,
                           shard_count=1).batch(8)
    p.load_state_dict(state)
    assert p.state_dict() == state
    assert list(p.iter_epoch(0)) == [] and list(p.iter_epoch(1)) == []
    assert ds.count == 0 and p.state_dict() == state
    got = list(p.iter_epoch(2))
    assert len(got) == 3 and ds.count == 24
    assert p.state_dict() == {"version": 1, "epoch": 3, "batch": 0,
                              "seed": 4}
    with pytest.raises(ValueError, match="seed"):
        p.load_state_dict({"version": 1, "epoch": 0, "batch": 0, "seed": 2})
    with pytest.raises(ValueError, match="version"):
        p.load_state_dict({"version": 2, "epoch": 0, "batch": 0, "seed": 4})
    p.set_epoch(5)
    assert p.epoch == 5


@pytest.mark.parametrize("workers", [0, 2])
def test_device_prefetch_on_the_cpu_is_bitwise(workers):
    host = list(_seeded().workers(workers))
    pipe = _seeded().workers(workers).device_prefetch(2, device="cpu")
    dev = list(pipe)
    _assert_batches_equal(dev, host)
    for x, y in dev:
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert pipe.metrics.snapshot()["device_put_s"] > 0


def test_device_prefetch_relays_errors_and_closes():
    class Bad(CountingDS):
        def __getitem__(self, i):
            if i == 10:
                raise KeyError("sample 10")
            return super().__getitem__(i)

    p = tpipe.from_dataset(Bad(), shard_rank=0, shard_count=1).batch(4) \
        .device_prefetch(2, device="cpu")
    with pytest.raises(KeyError, match="sample 10"):
        list(p.iter_epoch(0))
    p = _seeded().device_prefetch(2, device="cpu")
    it = p.iter_epoch(0)
    next(it)
    p.close()
    assert it.done


def test_device_prefetch_defaults_to_the_card(monkeypatch):
    """Without a device the prefetch is the card's, and without a card it
    raises rather than copy to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _seeded().device_prefetch(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(p))


def test_device_prefetch_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="queue 5"):
        _seeded().device_prefetch(2, mesh=object())
    with pytest.raises(NotImplementedError, match="queue 5"):
        _seeded().device_prefetch(2, batch_sharding=[None])


def test_prefetch_hides_decode_cost():
    """Decoding (4 ms a sample) runs in the workers ahead of a consumer
    that takes 40 ms a batch: after the first batch the consumer hardly
    waits."""
    p = tpipe.from_dataset(CountingDS(n=32, delay=0.004), shard_rank=0,
                           shard_count=1).batch(4).workers(4) \
        .device_prefetch(2, device="cpu")
    for _ in p.iter_epoch(0):
        time.sleep(0.04)
    snap = p.metrics.snapshot()
    assert snap["batches"] == 8 and snap["starvation_fraction"] < 0.25


def test_input_pipeline_section_on_the_bus_and_in_summary_dict():
    p = _seeded()
    list(p.iter_epoch(0))
    assert "input_pipeline" in bus.BUS.providers()
    section = bus.collect()["input_pipeline"]
    assert section["batches"] >= 8 and section["pipelines"] >= 1
    assert {"starvation_fraction", "batches_per_sec", "device_put_s",
            "wait_s", "decode_s"} <= set(section)
    with profiler.profiler_guard(timer_only=True) as prof:
        pass
    assert prof.summary_dict()["input_pipeline"]["batches"] >= 8
    assert tpipe.summary_snapshot() == bus.collect()["input_pipeline"]


def test_pipeline_is_exported_by_io():
    assert tio.Pipeline is tpipe.Pipeline
    assert tio.from_dataset is tpipe.from_dataset
