"""FLOPs of aten ops and the MFU denominator (counterpart of
paddle_tpu/profiler/stats/flops.py and of the FLOPs table beside the
reference's dispatcher, paddle_tpu/core/dispatch.py:464-533).

The formulas are the reference's: a product 2*M*N*K (`_matmul_flops`,
dispatch.py:483); addmm, which is what a Linear with a bias runs here,
the reference's `linear` count 2*M*N*K + M*N (dispatch.py:493), so that
a model's Linear layers book what they book there; the attention
4*B*H*L*S*D, halved when causal (`_attention_flops`, dispatch.py:524);
a convolution 2 * out * prod(weight.shape[1:]); and one FLOP an output
element otherwise. Unlike the reference's eager dispatcher, the
profiler's dispatch mode also sees the backward's aten ops: each
product of the backward books its own count.

MFU = achieved FLOP/s / device_peak_flops(): FLAGS_device_peak_flops, or
the card's bf16 dense tensor-core peak from its name (989e12 for an H100
SXM, the peak the kernel bounds of PERF.md use), or a nominal 1e12 on
the CPU.
"""
from __future__ import annotations

from ...core.flags import flag

# bf16 dense tensor-core peaks by card name (NVIDIA's data sheets)
_CARD_PEAK = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
              ("H100", 989e12), ("H200", 989e12), ("A100", 312e12))


def device_peak_flops() -> float:
    """The MFU denominator in FLOP/s."""
    v = float(flag("device_peak_flops"))
    if v > 0:
        return v
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        for key, peak in _CARD_PEAK:
            if key in name:
                return peak
    return 1e12


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _mm(iv, ov, **kw):
    return 2 * _numel(ov[0].shape) * int(iv[0].shape[-1])


def _addmm(iv, ov, **kw):
    out = _numel(ov[0].shape)
    return 2 * out * int(iv[1].shape[-1]) + out


def _conv(iv, ov, **kw):
    return 2 * _numel(ov[0].shape) * _numel(iv[1].shape[1:])


def _conv_backward(iv, ov, **kw):
    # (grad_out, input, weight, ...): each gradient asked for is one
    # product of the forward's size
    fwd = 2 * _numel(iv[0].shape) * _numel(iv[2].shape[1:])
    mask = kw.get("output_mask") or (True, True)
    return fwd * sum(bool(m) for m in mask[:2])


def attention_flops(q_shape, k_shape, causal: bool = False) -> int:
    """q, k: [B, L, H, D]: Q.K^T and P.V, 2*B*H*L*S*D each."""
    b, l, h, d = (int(s) for s in q_shape)
    f = 4 * b * h * l * int(k_shape[1]) * d
    return f // 2 if causal else f


FLOPS = {"mm": _mm, "bmm": _mm, "addmm": _addmm, "baddbmm": _addmm,
         "convolution": _conv, "convolution_backward": _conv_backward}


def flops_for(name: str, invals, outvals, kwargs) -> int:
    """FLOPs of op `name` on tensors `invals` -> `outvals`: its formula,
    else one an output element; 0 where a formula fails."""
    try:
        fn = FLOPS.get(name)
        if fn is not None:
            return int(fn(invals, outvals, **dict(kwargs)))
        return sum(_numel(v.shape) for v in outvals)
    except Exception:  # noqa: BLE001 — profiling only
        return 0
