"""BERT encoder and MLM head (counterpart of paddle_tpu/models/bert.py;
BASELINE.md's "BERT-base MLM, bf16 AMP (O2)" row).

The submodule names are the reference's (`bert.embeddings.word_embeddings`,
`bert.encoder.layers.N.self_attn.q_proj`, ..., `transform`, `layer_norm`,
`decoder_bias`), so one state_dict key names one reference parameter;
Linear weights are [out, in] (framework_io transposes the reference's).
The encoder's attention is non-causal: with no mask and no dropout it runs
the flash kernels (forward, dQ, dK/dV); an `attention_mask` or dropout in
training takes the einsum, as in the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..amp import cast_inputs
from ..nn import functional as F
from ..nn.layers_common import Dropout, Embedding, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


class BertConfig:
    """bert-base by default: vocab 30522, hidden 768, 12 layers, 12 heads,
    FFN 3072, 512 positions, dropout 0.1."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.position_embeddings = Embedding(cfg.max_position,
                                             cfg.hidden_size, **factory)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **factory)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    **factory)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1],
                           device=input_ids.device).unsqueeze(0)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **factory)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu",
            layer_norm_eps=cfg.layer_norm_eps, **factory)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(sequence output [B, L, hidden], pooled [B, hidden]).
        `attention_mask` [B, L] (1 keep, 0 pad) becomes the additive f32
        mask (1 - m) * -1e9 of shape [B, 1, 1, L]."""
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            m = (1.0 - attention_mask.to(torch.float32)) * -1e9
            attention_mask = m[:, None, None, :]
        seq = self.encoder(x, src_mask=attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForMaskedLM(nn.Module):
    """BERT with the MLM head: transform, GELU, LayerNorm, then logits
    against the word embeddings (tied) plus `decoder_bias`. `device`
    defaults to the CUDA card (and raises without one); `generator` seeds
    the initial weights, the reference's initializers (XavierNormal for
    Linear and Embedding weights, zero biases, unit LayerNorm scales;
    every encoder layer a copy of the first, as the reference's deepcopy
    makes them)."""

    def __init__(self, cfg: BertConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        factory = {"device": resolve_device(device)}
        self.cfg = cfg
        self.bert = BertModel(cfg, **factory)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **factory)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    **factory)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     **factory))
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for mod in self.modules():
            if isinstance(mod, Linear):
                fan_out, fan_in = mod.weight.shape
                std = math.sqrt(2.0 / (fan_in + fan_out))
                mod.weight.normal_(0.0, std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Embedding):
                mod.reset_parameters(generator)
        first, *rest = self.bert.encoder.layers
        for layer in rest:
            layer.load_state_dict(first.state_dict())

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        h, w = cast_inputs("matmul", h,
                           self.bert.embeddings.word_embeddings.weight)
        return torch.nn.functional.linear(h, w) + self.decoder_bias

    def loss(self, input_ids, labels, ignore_index=-100):
        """Mean cross-entropy of the logits over the labels that are not
        `ignore_index` (the MLM objective: the masked positions)."""
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               labels.reshape(-1), ignore_index=ignore_index)
