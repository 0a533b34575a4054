"""Streaming input pipeline (counterpart of paddle_tpu/io/pipeline):
checkpointable iterators, the device prefetch on a CUDA stream, and the
loader's metrics. See core.py."""
from .core import Pipeline, PipelineIterator, from_dataset
from .metrics import PipelineMetrics, summary_snapshot
from .prefetch import DevicePrefetcher, HostPrefetcher
from .sampler import BucketEpochSampler, EpochSampler

__all__ = [
    "Pipeline", "PipelineIterator", "from_dataset",
    "EpochSampler", "BucketEpochSampler",
    "HostPrefetcher", "DevicePrefetcher",
    "PipelineMetrics", "summary_snapshot",
]
