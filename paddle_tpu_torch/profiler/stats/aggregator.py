"""Event aggregation and summary tables (counterpart of
paddle_tpu/profiler/stats/aggregator.py): the host event stream
(chrome-trace dicts) and the device trace's kernel totals into per-op
and per-layer statistics.

Event kinds (the `cat` field):
- ``Operator``: one aten op seen by the profiler's dispatch mode, or one
  call of the flash attention (``scaled_dot_product_attention``); carries
  ``args.flops`` and ``args.layer`` (the module name stack's path).
- ``Forward``: one module forward, named by its dotted path.
- ``ProfileStep``: one Profiler.step() window.
- anything else (``UserDefined``, ...): user spans, in the op table
  without FLOPs.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

_OP_CATS = ("Operator", "PythonOp", "UserDefined", "ProfileStep",
            "Dataloader", "Communication", "Optimization")


class OpStat:
    """Per-key accumulator: calls, host total/max/min (us), device total
    (us, when a device trace was merged), analytic FLOPs."""

    __slots__ = ("name", "cat", "calls", "total", "max", "min",
                 "device_total", "flops")

    def __init__(self, name: str, cat: str = "Operator"):
        self.name = name
        self.cat = cat
        self.calls = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self.device_total = 0.0
        self.flops = 0

    def add(self, dur_us: float, flops: int = 0):
        self.calls += 1
        self.total += dur_us
        self.max = max(self.max, dur_us)
        self.min = min(self.min, dur_us)
        self.flops += int(flops)

    @property
    def avg(self) -> float:
        return self.total / self.calls if self.calls else 0.0


def op_stats(events: Iterable[dict]) -> Dict[str, OpStat]:
    """Aggregate op-class events by name."""
    out: Dict[str, OpStat] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _OP_CATS:
            continue
        name = e["name"]
        st = out.get(name)
        if st is None:
            st = out[name] = OpStat(name, e.get("cat", "Operator"))
        st.add(float(e.get("dur", 0.0)),
               int((e.get("args") or {}).get("flops", 0)))
    return out


def layer_stats(events: Iterable[dict]) -> Dict[str, OpStat]:
    """Aggregate Layer (Forward) spans by dotted name-stack path, then
    attribute op FLOPs to every enclosing layer (prefix match on the op
    event's ``args.layer``)."""
    out: Dict[str, OpStat] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "Forward":
            continue
        path = e["name"]
        st = out.get(path)
        if st is None:
            st = out[path] = OpStat(path, "Forward")
        st.add(float(e.get("dur", 0.0)))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "Operator":
            continue
        layer = (e.get("args") or {}).get("layer")
        if not layer:
            continue
        flops = int((e.get("args") or {}).get("flops", 0))
        if not flops:
            continue
        for path, st in out.items():
            if layer == path or layer.startswith(path + "."):
                st.flops += flops
    return out


# ------------------------------------------------------- device trace ----
# kernels whose names hold no op's name, credited by the start of an
# identifier in the name: the flash kernels (ops/csrc, in an anonymous
# namespace: "void (anonymous namespace)::flash_fwd_mma_kernel<...>(...)")
# are the attention op's
KERNEL_OPS = {"flash_": "scaled_dot_product_attention"}


def kernel_totals(key_averages) -> Dict[str, dict]:
    """{kernel name: {"us": device time, "count": launches}} of a
    torch.profiler capture's CUDA kernels."""
    from torch.autograd import DeviceType

    out: Dict[str, dict] = {}
    for e in key_averages:
        if e.device_type != DeviceType.CUDA:
            continue
        k = out.setdefault(e.key, {"us": 0.0, "count": 0})
        k["us"] += float(e.device_time_total)
        k["count"] += int(e.count)
    return out


def kernel_op(kname: str) -> Optional[str]:
    """The KERNEL_OPS op of kernel `kname`, or None: one of its
    identifiers (after a non-alphanumeric character or at the start)
    begins with a KERNEL_OPS prefix."""
    for prefix, op in KERNEL_OPS.items():
        if re.search(r"(?<![A-Za-z0-9])" + re.escape(prefix), kname):
            return op
    return None


def merge_device_totals(ops: Dict[str, OpStat],
                        kernels: Dict[str, float]) -> None:
    """Fill OpStat.device_total from {kernel name: device us}: a kernel
    named by a KERNEL_OPS prefix credits that op; any other the longest
    op name its own name contains (unmatched kernels stay in the kernel
    table). Each kernel credits one op."""
    names = sorted((n for n in ops if n), key=len, reverse=True)
    for kname, dur in kernels.items():
        alias = kernel_op(kname)
        if alias is not None:
            if alias in ops:
                ops[alias].device_total += dur
            continue
        for name in names:
            if name in kname:
                ops[name].device_total += dur
                break


# ------------------------------------------------------- table builder --
def build_table(title: str, headers: List[str], rows: List[List],
                widths: Optional[List[int]] = None) -> str:
    """Reference `_build_table`-style fixed-width section."""
    if widths is None:
        widths = []
        for i, h in enumerate(headers):
            w = len(str(h))
            for r in rows:
                w = max(w, len(str(r[i])))
            widths.append(min(w, 60))
    sep = "-" * (sum(widths) + 2 * len(widths))
    pad = max((len(sep) - len(title) - 4) // 2, 2)
    lines = ["-" * pad + f"  {title}  " + "-" * pad]
    fmt_cells = []
    for i, h in enumerate(headers):
        fmt_cells.append(f"{str(h):<{widths[i]}}" if i == 0
                         else f"{str(h):>{widths[i]}}")
    lines.append("  ".join(fmt_cells))
    lines.append(sep)
    for r in rows:
        cells = []
        for i, c in enumerate(r):
            s = str(c)
            if len(s) > 60:
                s = s[:57] + "..."
            cells.append(f"{s:<{widths[i]}}" if i == 0
                         else f"{s:>{widths[i]}}")
        lines.append("  ".join(cells))
    return "\n".join(lines)


def fmt_flops(n: float) -> str:
    n = float(n)
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}"


def fmt_bytes(n: float) -> str:
    n = float(n)
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(n) >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n:.0f}B"
