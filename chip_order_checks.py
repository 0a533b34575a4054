"""Two timing checks on the card that chip_smoke.py does not make.

1. The item order of the f32-storage forward at head_dim 256
   (flash_fwd_mma_kernel<256, kStd, kF32>, which walks its (head, 64-row
   tile) items head by head where all heads' K and V terms pass three
   times L2's 50 MB, else rank by rank): copies of this checkout's
   paddle_tpu_torch under build/order/, one forced rank by rank and one
   head by head, each timed at B*H x L = 64 x 1024, 16 x 1024, 8 x 2048,
   16 x 2048 and 32 x 2048 (causal, from terms split beforehand), in turns
   rank, head, head, rank.
2. The D = 256 dQ (flash_dq, flash_dq_nn at B*H = 64, L = 1024) of this
   checkout and of OTHER (another tree of the repo, e.g. the parent commit
   unpacked by `git archive`), timed alone and right after 150 launches of
   the same tree's f32-dot forward at D = 256 (as `chip_smoke.py
   --compare` times them), with the SM clock and power read after each,
   in turns other, this, this, other.

Each timing runs in a process of its own that builds its tree's kernels.

    python3 chip_order_checks.py OTHER_CHECKOUT
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from chip_smoke import card_line, check, log, median_ms

ORDER_SHAPES = ((4, 16, 1024), (1, 16, 1024), (1, 8, 2048), (1, 16, 2048),
                (2, 16, 2048))
# the kF32 forward's switch between the two orders, and what each copy
# puts in its place
SWITCH = ("  const bool by_head =\n"
          "      (long long)n_items * 64 * D * 2 * 6 > 3 * kL2Bytes;")
FORCED = {"rank": "  const bool by_head = false;",
          "head": "  const bool by_head = true;"}


def _package(root):
    """ops.flash_attention of the package under `root`."""
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.ops import flash_attention as fa

    check(os.path.abspath(fa.__file__).startswith(os.path.abspath(root)),
          f"imported {fa.__file__}, not the package under {root}")
    return fa


def order_worker(root):
    """The kF32 forward's kernel time at ORDER_SHAPES (terms split once)."""
    import torch

    fa = _package(root)
    ms = {}
    for B, H, L in ORDER_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, L, H, 256, device="cuda", generator=g)
                   for _ in range(3))
        terms = fa.split_terms(q, 3)
        fa.flash_fwd_cuda(q, k, v, True, 1 / 16, terms=terms)
        ms[f"{B * H}x{L}"] = median_ms(lambda: fa.flash_fwd_cuda(
            q, k, v, True, 1 / 16, terms=terms, split=False))
    print(json.dumps({"root": root, "ms": ms}), flush=True)


def dq_worker(root):
    """The D = 256 dQ alone, then after 150 f32-dot forwards."""
    import torch

    fa = _package(root)
    B, L, H, D, sc = 4, 1024, 16, 256, 1 / 16
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, L, H, D, device="cuda",
                               dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kt, vt = fa.to_t(k), fa.to_t(v)
    out = {}

    def clock():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()

    out["dq_alone"] = median_ms(
        lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, True, sc))
    out["clock_alone"] = clock()
    out["dq_nn_alone"] = median_ms(
        lambda: fa.flash_dq_nn_cuda(q, k, kt, vt, do, lse, delta, True, sc))
    median_ms(lambda: fa.flash_fwd_f32dot_cuda(q, k, v, True, sc))
    out["dq_after_f32dot"] = median_ms(
        lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, True, sc))
    out["clock_after"] = clock()
    print(json.dumps({"root": root, **out}), flush=True)


def run(mode, root):
    out = subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                          root], capture_output=True, text=True, timeout=900)
    check(out.returncode == 0, f"{mode} {root} failed:\n{out.stderr}")
    line = out.stdout.strip().splitlines()[-1]
    log(line)
    return json.loads(line)


def main(other):
    import torch

    if not torch.cuda.is_available():
        print("chip_order_checks: no CUDA device available", file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    copies = {}
    for order, line in FORCED.items():
        dst = os.path.join("build", "order", order)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree("paddle_tpu_torch", os.path.join(dst,
                                                         "paddle_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(dst, "paddle_tpu_torch", "ops", "csrc",
                           "flash_attention.cu")
        text = open(src).read()
        check(text.count(SWITCH) == 1, "the kF32 forward's switch moved")
        open(src, "w").write(text.replace(SWITCH, line))
        copies[order] = dst
    for order in ("rank", "head", "head", "rank"):
        run("--order-worker", copies[order])
    for root in (other, ".", ".", other):
        run("--dq-worker", root)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--order-worker"]:
        sys.exit(order_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dq-worker"]:
        sys.exit(dq_worker(sys.argv[2]))
    sys.exit(main(sys.argv[1]))
