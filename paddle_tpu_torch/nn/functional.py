"""Functional ops of the ported path (counterpart of
paddle_tpu/nn/functional.py): attention with the reference's routing,
GELU and layer norm."""
from __future__ import annotations

import math

import torch

from ..core.flags import flag
from ..ops.flash_attention import flash_attention, flash_attention_supported


def gelu(x, approximate: bool = False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return torch.nn.functional.layer_norm(x, tuple(normalized_shape), weight,
                                          bias, epsilon)


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
    shape and a shape that passes the gate, the flash kernels; otherwise
    the einsum path. (The port has no attention dropout: the training path
    runs dropout-free.)"""
    if (flag("use_flash_attention") and attn_mask is None
            and q.shape == k.shape == v.shape):
        bq, bk = int(flag("flash_block_q")), int(flag("flash_block_k"))
        if flash_attention_supported(q.shape, q.shape[-1], bool(is_causal),
                                     block_q=bq, block_k=bk):
            return flash_attention(q, k, v, causal=bool(is_causal),
                                   sm_scale=scale, block_q=bq, block_k=bk)
    probs, vh = _attention_probs(q, k, v, attn_mask, is_causal, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)
