"""GPT decoder LM (counterpart of paddle_tpu/models/gpt.py).

The submodule names are the reference's (`gpt.wte`, `gpt.wpe`,
`gpt.blocks.N.attn.qkv_proj`, ..., `gpt.ln_f`), so one state_dict key names
one reference parameter; Linear weights are stored [out, in] as torch
stores them (the reference stores [in, out]; framework_io converts).
PyTorch runs eagerly, so the reference's scan-over-layers model has no
counterpart here: its stacked parameters are unstacked by
`framework_io.params_from_paddle_tpu`.

`cfg.dropout` applies where the reference applies it: after the
embeddings, on each block's attention and MLP outputs, and on the
attention probabilities (which routes attention to the einsum with
dropout, never to flash). Each draws its mask from the default generator
(core/rng.py), in the reference's order; `model.eval()` turns all of it
off (the reference's attention still drops in eval mode: it passes no
`training` to its sdpa).

`generate` is the reference's decoding over a fixed-size KV cache, greedy
or top-k sampled: one prefill pass, then one cached step per token, every
attention through `cached_attention` (plain einsum, as the reference's
`_cached_attn_p`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..amp import cast_inputs
from ..core import rng as _rng
from ..nn import functional as F
from ..nn.layers_common import Dropout, Linear
from ..nn.norm import LayerNorm


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden=None, max_seq_len=1024,
                 dropout=0.0, layer_norm_eps=1e-5, tie_embeddings=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden = ffn_hidden or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.tie_embeddings = tie_embeddings


PRESETS = {
    "gpt3-tiny": GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                           num_heads=8, max_seq_len=256),
    "tiny-draft": GPTConfig(vocab_size=1024, hidden_size=64, num_layers=1,
                            num_heads=4, max_seq_len=256),
    "gpt3-small": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt3-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-large": GPTConfig(hidden_size=1536, num_layers=24, num_heads=16),
    "gpt3-xl": GPTConfig(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_layers=24, num_heads=32,
                           max_seq_len=1024),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                           max_seq_len=1024),
}


_NEG_INF = -1e30


def cached_attention(q, k_new, v_new, k_buf, v_buf, pos: int):
    """Attention over a fixed-size KV cache (the reference's
    `_cached_attn_p`). q, k_new, v_new: [B, Ln, H, D]; k_buf, v_buf:
    [B, max, H, D]; pos: the number of tokens already cached. Writes the
    new K/V at [pos, pos+Ln) of the buffers, in place (a start past
    max - Ln is clamped, as dynamic_update_slice clamps it), attends
    causally over the valid prefix (masked logits -1e30) and returns
    (out [B, Ln, H, D], k_buf, v_buf)."""
    B, Ln, H, D = q.shape
    maxlen = k_buf.shape[1]
    start = min(max(int(pos), 0), maxlen - Ln)
    k_buf[:, start:start + Ln] = k_new.to(k_buf.dtype)
    v_buf[:, start:start + Ln] = v_new.to(v_buf.dtype)
    dt = torch.promote_types(q.dtype, k_buf.dtype)
    qh = q.transpose(1, 2).to(dt)                  # [B, H, Ln, D]
    kh = k_buf.transpose(1, 2).to(dt)              # [B, H, max, D]
    vh = v_buf.transpose(1, 2).to(dt)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(D)
    kpos = torch.arange(maxlen, device=q.device)
    qpos = int(pos) + torch.arange(Ln, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]          # causal over the prefix
    s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return out.transpose(1, 2), k_buf, v_buf


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                               **factory)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size, **factory)
        self.dropout = cfg.dropout

    def forward(self, x, cache=None):
        """`cache` ({"k", "v": [B, max, H, D] buffers, "pos": int}) takes
        the cached path, which updates the buffers in place; without it
        the training path's attention."""
        b, l, h = x.shape
        qkv = self.qkv_proj(x).view(b, l, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            out, cache["k"], cache["v"] = cached_attention(
                q, k, v, cache["k"], cache["v"], cache["pos"])
            return self.out_proj(out.reshape(b, l, h))
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training)
        return self.out_proj(out.reshape(b, l, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_hidden, **factory)
        self.fc2 = Linear(cfg.ffn_hidden, cfg.hidden_size, **factory)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **factory)
        self.attn = GPTAttention(cfg, **factory)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **factory)
        self.mlp = GPTMLP(cfg, **factory)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache=None):
        x = x + self.dropout(self.attn(self.ln1(x), cache=cache))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **factory)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **factory)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              **factory)

    def forward(self, input_ids, caches=None, pos_offset: int = 0):
        """`caches` (one per block, see GPTAttention.forward) and
        `pos_offset` (the position of input_ids' first token) are the
        cached path's."""
        l = input_ids.shape[1]
        pos = torch.arange(pos_offset, pos_offset + l,
                           device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos)[None])
        for i, blk in enumerate(self.blocks):
            x = blk(x, cache=caches[i] if caches is not None else None)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with a causal LM head. `device` defaults to the CUDA card (and
    raises without one); `generator` seeds the initial weights, which
    follow the reference's initializers (XavierNormal for Linear and
    Embedding weights, zero biases, unit LayerNorm scales)."""

    def __init__(self, cfg: GPTConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        factory = {"device": resolve_device(device)}
        self.cfg = cfg
        self.gpt = GPTModel(cfg, **factory)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, **factory)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                fan_out, fan_in = mod.weight.shape
                std = math.sqrt(2.0 / (fan_in + fan_out))
                mod.weight.normal_(0.0, std, generator=generator)
            if isinstance(mod, nn.Linear) and mod.bias is not None:
                mod.bias.zero_()

    def hidden(self, input_ids):
        """Final hidden states [B, L, hidden] (the input of the LM head)."""
        return self.gpt(input_ids)

    def head_weight(self):
        """The LM head's weight as [vocab, hidden]: wte when tied."""
        return (self.gpt.wte.weight if self.cfg.tie_embeddings
                else self.lm_head.weight)

    def forward(self, input_ids):
        return self._logits_from_hidden(self.hidden(input_ids))

    def _logits_from_hidden(self, h):
        """The LM head: the reference's `matmul(h, wte, transpose_y)` when
        tied, else its `lm_head` Linear."""
        if self.cfg.tie_embeddings:
            h, w = cast_inputs("matmul", h, self.head_weight())
            return torch.nn.functional.linear(h, w)
        return self.lm_head(h)

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=0, temperature=1.0, eos_token_id=None):
        """Decoding over a fixed-size KV cache: the whole prompt in one
        prefill pass, then one cached step per token, until
        max_new_tokens, the cache's end (min(max_seq_len, L +
        max_new_tokens)) or, with `eos_token_id`, a step where every row
        emits it. input_ids: [B, L] ids (a tensor, array or list; moved
        to the model's device). Returns [B, L + n] int64 ids. Greedy, or
        with do_sample=True the reference's top-k sampling: the logits
        over `temperature`, those under the k-th largest set to -1e30
        (top_k > 0), then the argmax after float64 Gumbel noise [B, V]
        drawn each step with the default generator's next key
        (core/rng.py; reseed it with `paddle_tpu_torch.seed`)."""
        dev = self.gpt.wte.weight.device
        ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        B, L = ids.shape
        maxlen = min(self.cfg.max_seq_len, L + max_new_tokens)
        H = self.cfg.num_heads
        D = self.cfg.hidden_size // H
        with torch.inference_mode():
            caches = [{"k": torch.zeros(B, maxlen, H, D, device=dev),
                       "v": torch.zeros(B, maxlen, H, D, device=dev),
                       "pos": 0} for _ in self.gpt.blocks]
            # prefill the whole prompt in one pass
            h = self.gpt(ids, caches=caches, pos_offset=0)
            logits = self._logits_from_hidden(h[:, -1:])
            out_ids = [ids]
            cur_len = L
            for _ in range(max_new_tokens):
                if cur_len >= maxlen:
                    break
                step_logits = logits[:, -1] / max(temperature, 1e-6)
                if do_sample:
                    if top_k and top_k > 0:
                        kth = torch.topk(step_logits, top_k).values[:, -1:]
                        step_logits = torch.where(step_logits < kth,
                                                  _NEG_INF, step_logits)
                    # float64 noise, as the reference draws it (its JAX
                    # runs in x64 mode), added to the f32 logits in f64
                    g = _rng.gumbel(_rng.next_key().to(dev),
                                    tuple(step_logits.shape), torch.float64)
                    step_logits = step_logits.double() + g
                nxt = torch.argmax(step_logits, dim=-1).reshape(B, 1)
                out_ids.append(nxt)
                if eos_token_id is not None and bool(
                        (nxt == eos_token_id).all()):
                    break
                for c in caches:
                    c["pos"] = cur_len
                h = self.gpt(nxt, caches=caches, pos_offset=cur_len)
                logits = self._logits_from_hidden(h)
                cur_len += 1
            return torch.cat(out_ids, dim=1)
