"""Shared-state registry (counterpart of paddle_tpu/testing/racecheck.py,
cut to `shared_state`).

`shared_state(*fields)` marks a class's fields as state that several
threads share under one lock. Here it only records them in `REGISTRY`;
the detector that patches the marked classes and checks every access
(`install`, `_patch_class`, and `lockcheck` beside it) is not ported
yet (ROADMAP queue 6), so the decorator changes nothing at run time.
"""
from __future__ import annotations

from typing import Dict, FrozenSet

REGISTRY: Dict[type, FrozenSet[str]] = {}


def shared_state(*fields: str):
    """Class decorator: record `fields` as the class's shared mutable
    state. Returns the class unchanged."""
    fs = frozenset(fields)

    def deco(cls):
        REGISTRY[cls] = REGISTRY.get(cls, frozenset()) | fs
        return cls

    return deco


__all__ = ["REGISTRY", "shared_state"]
