"""Flash attention forward and backward (counterpart of
paddle_tpu/ops/pallas/flash_attention.py).

The three Pallas TPU kernels of the reference (`_fwd_kernel`, `_dq_kernel`,
`_dkv_kernel`) are CUDA kernels written for Hopper in
csrc/flash_attention.cu. Beside each stands its plain PyTorch version
(`flash_fwd_plain`, `flash_bwd_plain`), which the CPU tests hold against the
reference and which the card run holds the kernels against.

Dispatch: tensors on the CPU take the plain versions; tensors on a CUDA
device launch the kernels, which raise on what they do not take. Nothing
falls back from one to the other.

Layout: q, k, v, o and their gradients are [B, L, H, D] (the public
layout); LSE and delta are [B, H, L] float32 (the reference's [BH, 1, L]).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

# Launches of each CUDA kernel since the last reset; a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

_NEG_INF = -1e30
_KERNEL_TILE = 64          # rows of the CUDA kernels' inner tiles
_KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_supported(q_shape, d_model_last: int, causal: bool,
                              block_q: int = 128, block_k: int = 128) -> bool:
    """Shape gate, the reference's: seq divisible by both blocks, head_dim
    at most 256. The CUDA kernels further take only head_dim 64 or 128 and
    raise on anything else."""
    L = q_shape[1]
    return (L % block_q == 0 and L % block_k == 0 and L >= block_q
            and d_model_last <= 256)


# ---------------------------------------------------------- plain versions --
def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, H, L, D] in float32."""
    return x.transpose(1, 2).float()


def _causal_keep(L: int, device) -> torch.Tensor:
    return torch.ones(L, L, dtype=torch.bool, device=device).tril()


def _scores(qh, kh, causal: bool, sm_scale: float) -> torch.Tensor:
    s = (qh @ kh.transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-1], s.device), _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """(O [B, L, H, D] in q's dtype, LSE [B, H, L] f32): the function of
    `_fwd_kernel`, computed whole in f32, with P rounded to V's dtype before
    P.V as the kernels round it."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    s = _scores(qh, kh, causal, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vh) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """(dQ, dK, dV) in the inputs' dtype: the functions of `_dq_kernel` and
    `_dkv_kernel`. P = exp(S - LSE), dS = P * (dO.V^T - delta) * scale;
    P and dS are rounded to the input dtype where they enter a dot."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    s = _scores(qh, kh, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sm_scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dv = p.transpose(-1, -2) @ doh
    return tuple(x.transpose(1, 2).to(q.dtype).contiguous()
                 for x in (dq, dk, dv))


# ------------------------------------------------------------ CUDA kernels --
@functools.cache
def _lib():
    """The kernels' library (built at first use), with its C signatures."""
    from ._build import load

    lib = load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [I, I, I, I, I, I, F, P]   # B, H, L, D, dtype, causal, scale, stream
    lib.paddle_flash_fwd.argtypes = [P] * 5 + tail
    lib.paddle_flash_dq.argtypes = [P] * 7 + tail
    lib.paddle_flash_dkv.argtypes = [P] * 8 + tail
    for fn in (lib.paddle_flash_fwd, lib.paddle_flash_dq,
               lib.paddle_flash_dkv):
        fn.restype = I
    lib.paddle_cuda_error_string.argtypes = [I]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, like: torch.Tensor, *tensors, stats=()):
    """Validate what a kernel takes: CUDA, one dtype (bf16 or f32),
    contiguous [B, L, H, D] of one shape, head_dim 64 or 128, L a multiple
    of the kernels' tile; stats are contiguous f32 [B, H, L]."""
    if like.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{like.device}")
    if like.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {like.dtype} not supported "
                         f"(bfloat16 or float32)")
    if like.dim() != 4:
        raise ValueError(f"{name}: expected [B, L, H, D], got "
                         f"{tuple(like.shape)}")
    B, L, H, D = like.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not supported by the CUDA "
                         f"kernel (64 or 128)")
    if L % _KERNEL_TILE:
        raise ValueError(f"{name}: sequence length {L} is not a multiple "
                         f"of {_KERNEL_TILE}")
    for t in (like, *tensors):
        if (t.shape != like.shape or t.dtype != like.dtype
                or t.device != like.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: every input must be a contiguous, "
                             f"16-byte aligned {like.dtype} tensor of shape "
                             f"{tuple(like.shape)} on {like.device}")
    for t in stats:
        if (t.shape != (B, H, L) or t.dtype != torch.float32
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"{name}: LSE and delta must be contiguous "
                             f"float32 [B, H, L] on {like.device}")
    return B, L, H, D


def _launch(lib, fn, name: str, ptrs, q, causal, sm_scale):
    B, L, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], B, H, L, D,
                 _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
                 stream)
    if err != 0:
        msg = lib.paddle_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the forward kernel: (O, LSE)."""
    B, L, H, D = _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    lib = _lib()
    _launch(lib, lib.paddle_flash_fwd, "flash_fwd", (q, k, v, o, lse), q,
            causal, sm_scale)
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """Launch the dQ kernel."""
    _check("flash_dq", q, k, v, do, stats=(lse, delta))
    dq = torch.empty_like(q)
    lib = _lib()
    _launch(lib, lib.paddle_flash_dq, "flash_dq",
            (q, k, v, do, lse, delta, dq), q, causal, sm_scale)
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """Launch the dK/dV kernel: (dK, dV)."""
    _check("flash_dkv", q, k, v, do, stats=(lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    _launch(lib, lib.paddle_flash_dkv, "flash_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, causal, sm_scale)
    return dk, dv


# ---------------------------------------------------------------- dispatch --
def flash_fwd(q, k, v, causal: bool, sm_scale: float):
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale)
    return flash_fwd_cuda(q, k, v, causal, sm_scale)


def flash_bwd(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale)
    dq = flash_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the reference's `_flash` custom_vjp: saves
    (q, k, v, o, lse); the backward forms delta = rowsum(dO * O) in f32
    outside the kernels, as `_bwd` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q: int = 128, block_k: int = 128):
    """q, k, v: [B, L, H, D] -> [B, L, H, D]; differentiable.

    Self attention with equal q/k lengths; bf16 or f32 inputs, f32
    accumulation. `block_q`/`block_k` are the reference's tiles, checked by
    the shape gate; the CUDA kernels pick their own inner tiles."""
    D = q.shape[-1]
    if not flash_attention_supported(q.shape, D, causal, block_q, block_k):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} fails the "
                         f"gate for blocks ({block_q}, {block_k})")
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), bool(causal),
                                        sm_scale)
