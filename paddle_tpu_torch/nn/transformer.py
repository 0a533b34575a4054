"""Transformer encoder layers (counterpart of paddle_tpu/nn/transformer.py,
cut to MultiHeadAttention, TransformerEncoderLayer and TransformerEncoder;
the decoder waits).

Attention goes through the port's `functional.scaled_dot_product_attention`
on the [B, L, H, D] layout, so it is routed as the reference's: without a
mask or dropout, to the flash kernels (non-causal); with a mask, or with
dropout in training, to the einsum."""
from __future__ import annotations

import copy

import torch

from . import functional as F
from .container import LayerList
from .layers_common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(torch.nn.Module):
    """Separate q, k, v and out projections; input and output
    [batch, seq, embed_dim]. `attn_mask` is added to the scores (or, if
    bool, keeps where True)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        factory = {"device": device, "dtype": dtype,
                   "bias": bias_attr is not False}
        self.q_proj = Linear(embed_dim, embed_dim, **factory)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **factory)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **factory)
        self.out_proj = Linear(embed_dim, embed_dim, **factory)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(b, lq, self.num_heads, self.head_dim)
        k = k.reshape(b, lk, self.num_heads, self.head_dim)
        v = v.reshape(b, lk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(b, lq, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(torch.nn.Module):
    """Self-attention and a feed-forward block, each with dropout and a
    residual; LayerNorm after each (post-norm) or, with
    `normalize_before`, before. `activation` names a function of
    `functional` (relu, gelu, ...)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        factory = {"device": device, "dtype": dtype}
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            bias_attr=bias_attr, **factory)
        self.linear1 = Linear(d_model, dim_feedforward,
                              bias=bias_attr is not False, **factory)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model,
                              bias=bias_attr is not False, **factory)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **factory)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **factory)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    """`num_layers` layers: `encoder_layer` and deep copies of it, so that
    every layer starts from its weights, as in the reference; then `norm`
    if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
