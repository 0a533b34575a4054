"""Deterministic fault injection (counterpart of
paddle_tpu/testing/chaos.py, cut to the actions the serving path uses).

Code threads named injection points through its hot paths
(`hit("serving.decode_step", replica=..., generation=...)`), and rules
armed from a spec string decide, deterministically, what goes wrong at
which hit. Spec grammar (`FLAGS_chaos_spec` or `configure(spec)`)::

    spec  = rule (";" rule)*
    rule  = site ":" action [":" arg]

    serving.decode_step:raise:0.5   raise ChaosError on ~50% of hits
    serving.decode_step:raise_n:2   raise on the first 2 hits, then heal
    serving.decode_step:timeout     raise TimeoutError on every hit
    serving.decode_step:delay:0.05  sleep 50 ms at every hit
    step:nan:3                      directive "nan" at the 3rd hit (the
                                    train step poisons that batch)

Probabilistic rules draw from a per-rule `random.Random` seeded by
`FLAGS_chaos_seed` and the rule's text, so the same (spec, seed) fires
the same faults at the same hits. `add_rule(..., match={...})` scopes a
rule to hits whose context carries those values (one worker, one worker
generation).

The reference's process-level actions (`kill_after`, `sigterm_after`)
serve its fault-tolerance supervisor, which the port does not have yet;
here they are unknown actions.

Standing sites: serving.decode_step (before every decode step of a
generation worker), serving.execute (before every device batch of a
predict worker), scale.add / scale.drain (replica add and retire in both
engines), step (before every call of jit.TrainStep).
With no rule armed, `hit()` is one truth test.
"""
from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, List, Optional

from ..core import flags as _flags


class ChaosError(ConnectionError):
    """Injected transient failure (a ConnectionError, as a real reset
    would be)."""


_ACTIONS = ("raise", "timeout", "raise_n", "nan", "delay")


class _Rule:
    def __init__(self, site: str, action: str, arg=None, match=None,
                 seed: int = 0):
        if action not in _ACTIONS:
            raise ValueError(
                f"chaos: unknown action {action!r} (known: {_ACTIONS})")
        self.site = site
        self.action = action
        self.arg = arg
        self.match = dict(match or {})
        self.fired = 0
        # this rule's own count of matched hits, so that a scoped rule on
        # a shared site counts only the hits it saw
        self.seen = 0
        text = f"{site}:{action}:{arg}:{sorted(self.match.items())}"
        self._rng = random.Random(seed ^ zlib.crc32(text.encode()))

    def matches(self, ctx: dict) -> bool:
        return all(str(ctx.get(k)) == str(v) for k, v in self.match.items())

    def apply(self, nhit: int) -> Optional[str]:
        """Act on the rule's `nhit`-th matched hit: raise, sleep, or
        return a directive ("nan")."""
        act, arg = self.action, self.arg
        if act == "raise":
            p = 1.0 if arg is None else float(arg)
            if self._rng.random() < p:
                self.fired += 1
                raise ChaosError(f"chaos: injected fault at {self.site} "
                                 f"(hit {nhit})")
        elif act == "timeout":
            p = 1.0 if arg is None else float(arg)
            if self._rng.random() < p:
                self.fired += 1
                raise TimeoutError(f"chaos: injected timeout at "
                                   f"{self.site} (hit {nhit})")
        elif act == "raise_n":
            if nhit <= int(arg):
                self.fired += 1
                raise ChaosError(f"chaos: injected fault at {self.site} "
                                 f"(hit {nhit}/{arg})")
        elif act == "nan":
            if nhit == int(arg):
                self.fired += 1
                return "nan"
        elif act == "delay":
            self.fired += 1
            time.sleep(float(arg or 0.01))
        return None


_LOCK = threading.Lock()
_RULES: List[_Rule] = []
_HITS: Dict[str, int] = {}


def active() -> bool:
    """True iff any rule is armed."""
    return bool(_RULES)


def parse_spec(spec: str, seed: int = 0) -> List[_Rule]:
    rules = []
    for part in (spec or "").replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"chaos: bad rule {part!r} (want site:action[:arg])")
        arg = ":".join(bits[2:]) if len(bits) > 2 else None
        rules.append(_Rule(bits[0], bits[1], arg, seed=seed))
    return rules


def configure(spec: Optional[str] = None, seed: Optional[int] = None):
    """(Re)arm the harness from `spec` (default FLAGS_chaos_spec) with
    `seed` (default FLAGS_chaos_seed), resetting every counter;
    configure(spec="") disarms."""
    global _RULES
    if spec is None:
        spec = _flags.flag("chaos_spec")
    if seed is None:
        seed = int(_flags.flag("chaos_seed"))
    with _LOCK:
        _RULES = parse_spec(spec, seed=seed)
        _HITS.clear()
    return list(_RULES)


def add_rule(site: str, action: str, arg=None, match: Optional[dict] = None,
             seed: Optional[int] = None):
    """Arm one rule; `match={'replica': 0}` scopes it to hits whose
    context carries those values."""
    if seed is None:
        seed = int(_flags.flag("chaos_seed"))
    r = _Rule(site, action, arg, match=match, seed=seed)
    with _LOCK:
        _RULES.append(r)
    return r


def reset():
    """Disarm everything and clear the counters."""
    global _RULES
    with _LOCK:
        _RULES = []
        _HITS.clear()


def counters() -> dict:
    """{'hits': per-site hit counts, 'injected': per-rule fire counts,
    'total_injected': their sum}."""
    with _LOCK:
        injected = {f"{r.site}:{r.action}": r.fired
                    for r in _RULES if r.fired}
        return {"hits": dict(_HITS), "injected": injected,
                "total_injected": sum(r.fired for r in _RULES)}


def hit(site: str, **ctx) -> Optional[str]:
    """Record one pass through `site` and apply every matching rule; may
    raise ChaosError or TimeoutError, sleep, or return a directive
    ("nan"). Returns None when disarmed or nothing fires."""
    if not _RULES:
        return None
    with _LOCK:
        _HITS[site] = _HITS.get(site, 0) + 1
        matched = []
        for r in _RULES:
            if r.site == site and r.matches(ctx):
                r.seen += 1
                matched.append((r, r.seen))
    # apply every matched rule before raising the first exception, so a
    # raising rule does not starve a count-based one of its hit
    directive = None
    first_exc: Optional[BaseException] = None
    for r, n in matched:
        try:
            d = r.apply(n)
        except Exception as e:  # noqa: BLE001 — ChaosError/TimeoutError
            first_exc = first_exc or e
            continue
        directive = directive or d
    if first_exc is not None:
        raise first_exc
    return directive


# a process started with FLAGS_chaos_spec set is armed at import;
# set_flags re-arms it at run time
if _flags.flag("chaos_spec"):
    configure()

__all__ = ["ChaosError", "active", "configure", "add_rule", "reset",
           "counters", "hit", "parse_spec"]
