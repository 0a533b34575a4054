"""Functional ops of the ported path (counterpart of
paddle_tpu/nn/functional.py): attention with the reference's routing,
GELU and layer norm."""
from __future__ import annotations

import math

import torch

from ..core.flags import flag
from ..ops.flash_attention import (flash_attention,
                                   flash_attention_supported,
                                   resolve_dot_impl)


def gelu(x, approximate: bool = False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


class _LayerNorm(torch.autograd.Function):
    """The forward of `layer_norm`; the backward is LayerNorm's own
    gradient from x (in its own dtype), the rounded mean and 1/std, the
    only tensors kept. (Autograd through the forward would keep an f32 copy
    of x for the variance, and x - mean and the normalised x besides, and
    run about ten element-wise kernels.) dx comes from torch's fused
    LayerNorm backward (f32 inside), given g * weight rounded to g's dtype
    as the reference's autodiff rounds it; dweight and dbias are f32 sums
    over the rows (the fused kernel's bf16 path on the CPU sums them in
    bf16)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dims, epsilon):
        var, mean = torch.var_mean(x.float(), dims, correction=0,
                                   keepdim=True)
        mean = mean.to(x.dtype)
        rstd = torch.rsqrt(var.to(x.dtype) + epsilon)
        out = (x - mean) * rstd
        if weight is not None:
            out = out * weight
        if bias is not None:
            out = out + bias
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        ctx.shape = x.shape[dims[0]:]
        return out

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        # the dtype the fused kernel takes statistics in: f32 on a card,
        # x's on the CPU; exact either way, they hold x's dtype's values
        stats = torch.float32 if x.is_cuda else x.dtype
        mean, rstd = mean.to(stats), rstd.to(stats)
        bwd = torch.ops.aten.native_layer_norm_backward
        need = ctx.needs_input_grad
        dx = dw = db = None
        if need[0]:
            gw = g if weight is None else g * weight
            dx = bwd(gw, x, ctx.shape, mean, rstd, None, None,
                     [True, False, False])[0]
        rows = tuple(range(x.dim() - len(ctx.shape)))
        if weight is not None and need[1]:
            xhat = (x - mean.float()) * rstd.float()
            dw = (g * xhat).sum(rows).to(weight.dtype)
        if bias is not None and need[2]:
            db = g.sum(rows, dtype=torch.float32).to(bias.dtype)
        return dx, dw, db, None, None


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """The reference's arithmetic (`_layer_norm_p`, under O2 on bf16
    activations too): mean and variance reduced in f32 and rounded to x's
    dtype, the normalisation, scale and shift in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    return _LayerNorm.apply(x, weight, bias, dims, epsilon)


def _attention_probs(q, k, v, mask, is_causal, scale):
    """Einsum attention core ([B, L, H, D] in): softmax probabilities and
    head-major V. The causal mask is bottom-right aligned (tril with
    k = kl - ql) and masked logits are -inf, as in the reference."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(ql, kl, dtype=torch.bool,
                        device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask
    return torch.softmax(logits, dim=-1), vh


def scaled_dot_product_attention(q, k, v, attn_mask=None, is_causal=False,
                                 scale=None):
    """Attention on the [B, L, H, D] layout, routed as the reference's
    `_sdpa_p`: with FLAGS_use_flash_attention on, no mask, q, k and v of one
    shape and a shape that passes the gate, the flash kernels under the
    dot strategy FLAGS_flash_dot_impl resolves to; otherwise the einsum
    path. The reference's backend gate has no counterpart: the flash path
    runs on the card and, through its plain versions, on the CPU. (The port
    has no attention dropout: the training path runs dropout-free.)"""
    if (flag("use_flash_attention") and attn_mask is None
            and q.shape == k.shape == v.shape):
        bq, bk = int(flag("flash_block_q")), int(flag("flash_block_k"))
        if flash_attention_supported(q.shape, q.shape[-1], bool(is_causal),
                                     block_q=bq, block_k=bk):
            impl = resolve_dot_impl(q.device)
            # as the reference: an "f32" that "auto" picked takes flash only
            # from seq 2048, where the einsum's [L, L] scores would dominate
            # (f32-dot flash measured slower than einsum below that on a
            # TPU); an explicit f32 flag or force_flash_attention always does
            if (impl != "f32" or q.shape[1] >= 2048
                    or flag("flash_dot_impl") == "f32"
                    or flag("force_flash_attention")):
                return flash_attention(q, k, v, causal=bool(is_causal),
                                       sm_scale=scale, block_q=bq,
                                       block_k=bk, impl=impl)
    probs, vh = _attention_probs(q, k, v, attn_mask, is_causal, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)
