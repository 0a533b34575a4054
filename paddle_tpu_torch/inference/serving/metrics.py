"""Serving metrics helpers (counterpart of
paddle_tpu/inference/serving/metrics.py, cut to what the generation
engine uses): the nearest-rank percentile rule and the safe ratio. The
HTTP front reads its one engine's metrics, so the reference's registry
of live engines has no caller here; the predict engine's ServingMetrics
waits for the predict engine's port (ROADMAP queue 4).
"""
from __future__ import annotations

from typing import Dict


def percentiles(vals) -> Dict[str, float]:
    """Nearest-rank p50/p95/p99 over an unsorted value sequence (the
    reference's one rank rule for every serving tier)."""
    lat = sorted(vals)
    if not lat:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}

    def pct(p):
        i = min(int(p * (len(lat) - 1) + 0.5), len(lat) - 1)
        return lat[i]

    return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


def rate(num, den) -> float:
    """Safe ratio for snapshot fields (0.0 on an empty denominator)."""
    return round(num / den, 4) if den else 0.0


__all__ = ["percentiles", "rate"]
