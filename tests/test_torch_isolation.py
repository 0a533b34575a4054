"""The port stands alone: no module of paddle_tpu_torch, and neither
chip_smoke.py nor chip_order_checks.py, imports jax, ml_dtypes (the card's
machine has none: bfloat16 checkpoints are read and written without it)
or the reference package paddle_tpu; and its entry points refuse to run
quietly on the CPU when no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_order_checks.py"]
MODULES = ["paddle_tpu_torch", "paddle_tpu_torch.amp",
           "paddle_tpu_torch.autoscale",
           "paddle_tpu_torch.autoscale.policy",
           "paddle_tpu_torch.autoscale.replica",
           "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.flags",
           "paddle_tpu_torch.core.place", "paddle_tpu_torch.core.rng",
           "paddle_tpu_torch.core.tensor",
           "paddle_tpu_torch.distributed",
           "paddle_tpu_torch.distributed.checkpoint",
           "paddle_tpu_torch.distributed.recompute",
           "paddle_tpu_torch.distributed.store",
           "paddle_tpu_torch.callbacks",
           "paddle_tpu_torch.framework_io",
           "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.callbacks",
           "paddle_tpu_torch.hapi.flops", "paddle_tpu_torch.hapi.model",
           "paddle_tpu_torch.hapi.summary",
           "paddle_tpu_torch.inference",
           "paddle_tpu_torch.inference.fabric",
           "paddle_tpu_torch.inference.fabric.__main__",
           "paddle_tpu_torch.inference.fabric._http",
           "paddle_tpu_torch.inference.fabric.client",
           "paddle_tpu_torch.inference.fabric.fleet",
           "paddle_tpu_torch.inference.fabric.frontdoor",
           "paddle_tpu_torch.inference.fabric.handoff",
           "paddle_tpu_torch.inference.fabric.host",
           "paddle_tpu_torch.inference.fabric.membership",
           "paddle_tpu_torch.inference.fabric.metrics",
           "paddle_tpu_torch.inference.fabric.router",
           "paddle_tpu_torch.inference.serve",
           "paddle_tpu_torch.inference.serving",
           "paddle_tpu_torch.inference.serving.engine",
           "paddle_tpu_torch.inference.serving.generate",
           "paddle_tpu_torch.inference.serving.lifecycle",
           "paddle_tpu_torch.inference.serving.metrics",
           "paddle_tpu_torch.inference.serving.server",
           "paddle_tpu_torch.io", "paddle_tpu_torch.io.bucketing",
           "paddle_tpu_torch.io.pipeline",
           "paddle_tpu_torch.io.pipeline.core",
           "paddle_tpu_torch.io.pipeline.metrics",
           "paddle_tpu_torch.io.pipeline.prefetch",
           "paddle_tpu_torch.io.pipeline.sampler",
           "paddle_tpu_torch.metric",
           "paddle_tpu_torch.jit", "paddle_tpu_torch.jit.train_step",
           "paddle_tpu_torch.linalg",
           "paddle_tpu_torch.models", "paddle_tpu_torch.nn",
           "paddle_tpu_torch.nn.functional",
           "paddle_tpu_torch.nn.functional_more",
           "paddle_tpu_torch.nn.layers_common",
           "paddle_tpu_torch.nn.norm",
           "paddle_tpu_torch.ops", "paddle_tpu_torch.ops._build",
           "paddle_tpu_torch.ops.common", "paddle_tpu_torch.ops.creation",
           "paddle_tpu_torch.ops.extras", "paddle_tpu_torch.ops.linalg",
           "paddle_tpu_torch.ops.logic", "paddle_tpu_torch.ops.manipulation",
           "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.reduction",
           "paddle_tpu_torch.observability.bus",
           "paddle_tpu_torch.observability.exporter",
           "paddle_tpu_torch.observability.trace",
           "paddle_tpu_torch.ops.flash_attention",
           "paddle_tpu_torch.optimizer",
           "paddle_tpu_torch.optimizer.clip",
           "paddle_tpu_torch.optimizer.lr",
           "paddle_tpu_torch.profiler", "paddle_tpu_torch.profiler.stats",
           "paddle_tpu_torch.profiler.stats.aggregator",
           "paddle_tpu_torch.profiler.stats.flops",
           "paddle_tpu_torch.profiler.stats.memory",
           "paddle_tpu_torch.quantization",
           "paddle_tpu_torch.quantization.kv",
           "paddle_tpu_torch.regularizer",
           "paddle_tpu_torch.static",
           "paddle_tpu_torch.testing.chaos",
           "paddle_tpu_torch.testing.racecheck",
           "paddle_tpu_torch.vision", "paddle_tpu_torch.vision.datasets",
           "paddle_tpu_torch.vision.transforms"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "paddle_tpu")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Import every module of the port in a fresh interpreter and list the
    modules the import added (whatever the interpreter loaded at start-up
    is left out)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "print(' '.join(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    added = out.stdout.split()
    assert "paddle_tpu_torch.ops.flash_attention" in added
    assert [m for m in added if _forbidden(m)] == []


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=64,
                                 num_layers=1, num_heads=1,
                                 max_seq_len=64))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no card visible chip_smoke.py exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
