"""Card smoke test of paddle_tpu_torch: builds the CUDA kernels from this
checkout, holds each against its plain PyTorch version at the training
path's shapes, then trains GPT-350M (gpt3-medium: hidden 1024, 24 layers,
16 heads, vocab 50304; batch 8 x seq 1024, bf16 O2, AdamW with f32
masters, chunked fused LM-head cross-entropy) for a few steps through
those kernels.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, sm_90a) and nvcc. Prints the
card and its power limit, a `kernels` JSON line (time, launches on the
training path, bound, plain and library times, error of each kernel) and,
as the last line, {"ok": true, "device": {...}}. Any failed check exits
non-zero without that line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): tensor-core bf16,
# f32 on the CUDA cores (f32 products run without TF32 here), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain version, as the largest error divided by the RMS of its
# row (the D entries of one position and head), or by the RMS of the whole
# tensor where the row's is smaller: a row that sees many keys has small
# entries, and a wrong tile there must not hide under the rounding of the
# few large rows. f32: the two differ only in the order of f32 sums.
# bf16: outputs carry 8 significant bits (a relative step of 2^-8), the
# kernel rounds P to bf16 against the running row max where the plain
# version uses the final max, and the tensor cores sum in their own order.
# A kernel that skips one off-diagonal tile reads far above the limit;
# `fault_readings` computes that reading in every run.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-1}
LSE_ATOL = 1e-4          # LSE is f32 in both
# Training loss through the kernels vs through the plain einsum attention
# (bf16 softmax) at step 1. A sanity check of the routing only: at
# initialisation (weights of std 0.02) attention moves the loss little,
# so the kernels' numerics are held by the kernel phase, not by this.
LOSS_ATOL = 1e-3

STEPS = 5
SEED = 0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=15, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row_err(a, b):
    """max |a - b| / RMS of its row of b, floored at the RMS of all of b."""
    a, b = a.float(), b.float()
    floor = float(b.pow(2).mean().sqrt())
    scale = b.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=floor)
    return float(((a - b).abs() / scale).max())


def abs_err(a, b):
    return float((a.float() - b.float()).abs().max())


def fault_readings(q, k, v, do, sc, ref):
    """What the error metrics read for kernels that each skip one tile:
    the forward and dQ kernels the keys of K/V tile t for query tile s, the
    dK/dV kernel query tile s for K/V tile t. s is the last 64-row tile and
    t the middle one, off the diagonal: a pair whose loss changes the
    outputs little, since the last queries see the most keys and add the
    least to each key's gradients. The faulty outputs are the plain
    version's less that pair's contribution, rounded as the kernels
    round."""
    import torch

    o, lse, delta, dq, dk, dv = ref
    L, T = q.shape[1], 64
    s0, t0 = L - T, (L // 2 // T) * T
    rows, cols = slice(s0, s0 + T), slice(t0, t0 + T)
    heads = lambda x: x.transpose(1, 2).float()           # noqa: E731
    back = lambda x: x.transpose(1, 2).to(q.dtype)        # noqa: E731
    qs, dos = heads(q[:, rows]), heads(do[:, rows])
    kt, vt = heads(k[:, cols]), heads(v[:, cols])
    p = torch.exp(qs @ kt.transpose(-1, -2) * sc - lse[:, :, rows, None])
    ds = p * (dos @ vt.transpose(-1, -2) - delta[:, :, rows, None]) * sc
    kept = 1 - p.sum(-1, keepdim=True)

    def without(x, sl, part):
        y = x.clone()
        y[:, sl] = back(heads(x[:, sl]) - part)
        return y

    o_f = o.clone()
    o_f[:, rows] = back((heads(o[:, rows]) - p @ vt) / kept)
    lse_f = lse.clone()
    lse_f[:, :, rows] += torch.log(kept.squeeze(-1))
    dq_f = without(dq, rows, ds @ kt)
    dk_f = without(dk, cols, ds.transpose(-1, -2) @ qs)
    dv_f = without(dv, cols, p.transpose(-1, -2) @ dos)
    return ({"O": row_err(o_f, o), "dQ": row_err(dq_f, dq),
             "dK": row_err(dk_f, dk), "dV": row_err(dv_f, dv)},
            abs_err(lse_f, lse))


def kernel_phase(B, L, H, D, dtype_name, causal, timed):
    """Each kernel against its plain version on the card; with `timed`,
    also the CUDA-event medians and bounds. Returns per-kernel results."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(B, L, H, D, device="cuda", dtype=dt,
                               generator=g) for _ in range(4))
    sc = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, sc)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, causal, sc)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, causal, sc)
    torch.cuda.synchronize()
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, do, lse_ref, delta,
                                                causal, sc)
    tol = REL_TOL[dtype_name]
    tag = f"B={B} L={L} H={H} D={D} {dtype_name} causal={causal}"
    errs = {"O": row_err(o, o_ref), "dQ": row_err(dq, dq_ref),
            "dK": row_err(dk, dk_ref), "dV": row_err(dv, dv_ref)}
    lse_err = abs_err(lse, lse_ref)
    faults, lse_fault = fault_readings(
        q, k, v, do, sc, (o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref))
    fmt = lambda d: {n: f"{e:.3e}" for n, e in d.items()}   # noqa: E731
    log(f"kernels vs plain [{tag}]: row-normalised err {fmt(errs)}, LSE abs "
        f"err {lse_err:.3e} (tol {tol} row-normalised, {LSE_ATOL} abs)")
    log(f"  a kernel skipping one tile would read {fmt(faults)}, LSE abs "
        f"err {lse_fault:.3e}")
    for name, e in errs.items():
        check(e <= tol, f"{name} disagrees with its plain version [{tag}]: "
                        f"{e:.3e} > {tol}")
        check(faults[name] > tol, f"the {name} check would pass a kernel "
                                  f"that skips a tile [{tag}]")
    check(lse_err <= LSE_ATOL, f"LSE disagrees [{tag}]: {lse_err:.3e}")
    check(lse_fault > LSE_ATOL, f"the LSE check would pass a kernel that "
                                f"skips a tile [{tag}]")
    if not timed:
        return None

    # work this run's inputs need: causal rows see keys 0..row
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    esz = q.element_size()
    tile = B * L * H * D * esz
    stat = B * H * L * 4
    fwd_b = bound(4 * D * pairs, 3 * tile + tile + stat, dtype_name)
    dq_b = bound(6 * D * pairs, 4 * tile + 2 * stat + tile, dtype_name)
    dkv_b = bound(8 * D * pairs, 4 * tile + 2 * stat + 2 * tile, dtype_name)

    ms_fwd = median_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, sc))
    ms_dq = median_ms(lambda: fa.flash_dq_cuda(q, k, v, do, lse_ref, delta,
                                               causal, sc))
    ms_dkv = median_ms(lambda: fa.flash_dkv_cuda(q, k, v, do, lse_ref,
                                                 delta, causal, sc))
    plain_fwd = median_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, sc),
                          reps=7)
    plain_bwd = median_ms(lambda: fa.flash_bwd_plain(
        q, k, v, do, lse_ref, delta, causal, sc), reps=7)

    # library yardsticks (timed only, never used by the port): PyTorch's
    # fused SDPA forward, and its backward (dQ, dK and dV in one call)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = median_ms(lambda: sdpa(qh, kh, vh, is_causal=causal))
    out = sdpa(qh, kh, vh, is_causal=causal)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))

    src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    ref = "paddle_tpu/ops/pallas/flash_attention.py"
    return [
        {"name": "flash_fwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:83", "max_abs_err": abs_err(o, o_ref),
         "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": fwd_b[0],
         "bound_by": fwd_b[1], "library_ms": lib_fwd},
        {"name": "flash_dq", "route": "cuda", "source": src,
         "replaces": f"{ref}:174", "max_abs_err": abs_err(dq, dq_ref),
         "ms": ms_dq, "plain_ms": plain_bwd, "bound_ms": dq_b[0],
         "bound_by": dq_b[1], "library_ms": lib_bwd},
        {"name": "flash_dkv", "route": "cuda", "source": src,
         "replaces": f"{ref}:233",
         "max_abs_err": max(abs_err(dk, dk_ref), abs_err(dv, dv_ref)),
         "ms": ms_dkv, "plain_ms": plain_bwd, "bound_ms": dkv_b[0],
         "bound_by": dkv_b[1], "library_ms": lib_bwd},
    ]


def reference_layout_weights(cfg, seed):
    """Seeded random weights at full width, laid out under the JAX scan
    model's parameter names and shapes (Linear weights [in, out], stacked
    over layers), as `paddle_tpu` would hand them over."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, D, F, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden, \
        cfg.vocab_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    ones = lambda *s: np.ones(s, np.float32)     # noqa: E731
    zeros = lambda *s: np.zeros(s, np.float32)   # noqa: E731
    return {
        "wte.weight": normal(V, D), "wpe.weight": normal(cfg.max_seq_len, D),
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "qkv_w": normal(L, D, 3 * D), "qkv_b": zeros(L, 3 * D),
        "out_w": normal(L, D, D), "out_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "fc1_w": normal(L, D, F), "fc1_b": zeros(L, F),
        "fc2_w": normal(L, F, D), "fc2_b": zeros(L, D),
        "ln_f.weight": ones(D), "ln_f.bias": zeros(D),
    }


def training_phase():
    """gpt3-medium, bench.py's configuration, STEPS TrainStep steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, PRESETS
    from paddle_tpu_torch.nn.functional_more import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = PRESETS["gpt3-medium"]
    batch, seq = 8, 1024
    t0 = time.time()
    model = GPTForCausalLM(cfg, device="cuda")
    model.load_state_dict(params_from_paddle_tpu(
        reference_layout_weights(cfg, SEED)))
    model.train()
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True)
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(m, ids, labels):
        return fused_linear_cross_entropy(m.hidden(ids), m.head_weight(),
                                          labels, transpose_y=True,
                                          chunk=2048)

    step = TrainStep(model, opt, loss_fn)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    ids_t = torch.as_tensor(ids, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    log(f"gpt3-medium: {n_params} parameters, set-up "
        f"{time.time() - t0:.1f} s")

    # step 1's loss through the plain einsum attention, same weights
    set_flags({"use_flash_attention": False})
    try:
        with torch.no_grad():
            plain_loss = float(loss_fn(model, ids_t, labels_t))
    finally:
        set_flags({"use_flash_attention": True})

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids_t, labels_t)
        losses.append(float(loss))   # waits for the step
        times.append(time.perf_counter() - t)
    launches = dict(fa.LAUNCHES)

    log(f"losses {losses}")
    log(f"step-1 loss: kernels {losses[0]:.6f}, plain attention "
        f"{plain_loss:.6f}, diff {abs(losses[0] - plain_loss):.2e} "
        f"(tol {LOSS_ATOL})")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(abs(losses[0] - plain_loss) <= LOSS_ATOL,
          f"step-1 loss {losses[0]} disagrees with plain attention "
          f"{plain_loss}")
    want = cfg.num_layers * STEPS
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times in {STEPS} steps, "
                         f"expected {want}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    log(f"step times s {times}; median of steps 2-{STEPS}: {step_s:.4f} s, "
        f"{batch * seq / step_s:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step(step, ids_t, labels_t, step_s)
    return launches


def profile_step(step, ids, labels, step_s):
    """One more train step under torch.profiler: the device time of each
    kernel, summed by name, and the device's idle share of an unprofiled
    step (the profiler's own host cost would inflate the profiled one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, labels)
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if not busy_us:
        log("profiled step: the profiler recorded no device time")
        return
    log(f"profiled step: device busy {busy_us / 1e3:.1f} ms; idle share of "
        f"a {step_s * 1e3:.1f} ms step {1 - busy_us / (step_s * 1e6):.3f}")
    for us, n, name in kernels[:12]:
        log(f"  {us / 1e3:8.2f} ms {100 * us / busy_us:5.1f}% x{n:<5d} "
            f"{name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.load("flash_attention")
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, rep in _build.BUILD_LOG.items():
        regs = re.findall(r"Used (\d+) registers", rep)
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                rep))
        log(f"{name}.cu: {len(regs)} kernel instances, registers {regs}, "
            f"spill stores {spill} bytes")

    rows = kernel_phase(8, 1024, 16, 64, "bfloat16", True, timed=True)
    kernel_phase(8, 1024, 16, 64, "bfloat16", False, timed=False)
    kernel_phase(8, 1024, 8, 128, "bfloat16", True, timed=False)
    kernel_phase(2, 256, 4, 64, "float32", True, timed=False)
    launches = training_phase()
    for r in rows:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
