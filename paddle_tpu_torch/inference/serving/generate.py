"""Continuous-batching generation (counterpart of
paddle_tpu/inference/serving/generate.py).

Design, as the reference's (Orca-style iteration-level scheduling over
a vLLM-style slot pool):

- **Prefill/decode split.** Each request is one prefill call (prompt
  padded to its pow2 bucket, batch 1) plus repeated fixed-shape decode
  steps over the active rows padded to their pow2 batch bucket:

    prefill[S]  (params, pool_k, pool_v, slot, ids[1, S], len, temp,
                 top_k, top_p, key) -> (first_token, key, pool_k, pool_v)
    decode[b]   (params, pool_k, pool_v, slots[b], tokens[b], lengths[b],
                 temps[b], top_ks[b], top_ps[b], keys[b, 2])
                -> (next_tokens[b], keys[b, 2], pool_k, pool_v)

  The bodies are plain PyTorch (einsum attention, as the reference's:
  no flash kernel runs here), one Python loop over the layers in place
  of the reference's `lax.scan`.

- **KV slot pool.** Each worker owns a pair of buffers [slots + 1 +
  prefix_cache_slots, L, max_context, H, Dh] (quantization/kv.py:
  float32, or int8 with a scale per row and layer); rows are slots
  handed out from a free list, the row after them is scratch for
  decode-batch padding and out-of-cap writes, and the rest are the
  prefix cache's. Prefill stores the prompt's K/V into its slot; each
  decode step writes one new position per row. The buffers are updated
  in place (the reference threads them functionally and donates them).
  The reference's pow2 capacity classes (`kv_slot_buckets`) are not
  ported: one class at max_context.

- **In-flight batching.** Between decode steps the worker admits queued
  requests into free slots (prefilling them right then) and retires
  finished rows (eos or max_new_tokens) without stalling the batch.

- **Streaming.** Tokens go onto each request's stream queue per step
  (GenerateHandle iterates them), with TTFT and tokens/s metrics and
  per-token spans on the tracer.

- **Seeded sampling.** temperature, top-k and top-p are per-row values
  beside slots and lengths; each row carries a threefry key (core/rng.py)
  built from its request's seed and split once per emitted token, row by
  row, so a row's chain does not depend on the batch it runs in: the
  same (prompt, parameters, seed) gives the same tokens on every path
  and after a requeue (the chain replays from the seed). Keys and the
  sampling values live on the host; the Gumbel noise is drawn on the
  logits' device, and only when a row of the call samples. A row at
  temperature 0 takes the argmax of its logits, bitwise the greedy
  head's.

- **Speculative decoding.** With a `draft=` model, each scheduler
  iteration runs one k-step greedy draft burst (`_propose_body`) over
  the draft's own pool and one target pass that scores all k positions
  (`_verify_body`), sampling the target's own token at every position
  with the key chain plain decode would use. The host accepts the
  longest agreed prefix (at least one token: a rejection falls back to
  the target's token), so the tokens are plain decode's.

- **Prefix caching.** Prefill K/V is kept under (pow2 boundary, hash of
  the prompt's first tokens) in a per-worker LRU of extra pool rows. A
  hit copies the cached row into the request's slot (`_copy_row_body`)
  and prefills only the tail (`_extend_body`: the tail's queries attend
  the cached prefix and, causally, the tail); a miss admits the longest
  uncached boundary below the prompt. The cache dies with its pool (a
  revive or a failed step resets it).

- **Quantized serving.** `kv_dtype="int8"` makes the pool int8 with
  quantize-on-scatter and dequantize-on-gather in the bodies; a body's
  own writes are fake-quantized with the row's scale, so it reads what
  the pool will hold. `quantize_weights=True` keeps the stacked matmul
  weights int8 and dequantizes one layer at a time in the layer loop.

- **Warm before admission.** The reference compiles and caches every
  program before a worker admits traffic and counts compile misses
  after. Eager PyTorch compiles nothing; here `warm_up`/`add_replica`
  run every program once on the worker's device before it turns active
  (every prompt-bucket prefill and batch-bucket decode; with the prefix
  cache the row copy and every tail-bucket extend; with a draft every
  draft prefill, and the propose and verify passes by batch bucket),
  `program_report()` lists them, and `first_calls_after_warmup` counts
  calls, after admission, of a program that had not run on its device.

Replica lifecycle is the reference's state machine (lifecycle.py):
warming -> active -> draining -> retired with a generation counter;
`add_replica` warms before admission, `remove_replica(drain=True)`
lets in-flight sequences finish, and `revive_replica` supersedes a hung
worker whose requests requeue: a requeued request re-prefills from its
prompt and its key chain replays from its seed, so the regenerated
prefix is the same and the tokens it already streamed are not emitted
again.

- **KV handoff** (fabric/handoff.py, the reference's wire format). A
  live row leaves its worker as one payload: the pool row pair raw in
  its stored dtype (`_kvget_body`; int8 with its per-layer scales) and
  the metadata that continues the stream bitwise (length, tokens, the
  key-chain cursor as the reference's uint32 pair, sampling values,
  prefix lineage). `submit(prefill_only=True)` finishes with the
  payload (finish_reason "handoff"); `import_handoff` validates a
  payload (400 malformed, 409 another kv_dtype or geometry, 503 a full
  queue) before it touches a slot, then the owning worker scatters the
  row into a free slot (`_kvput_body`) and decodes on; tokens the client
  already holds (`streamed`) are not emitted again.
  `shutdown(migrate=True)` ends every streamed row's stream with a
  ('handoff', payload) event; `submit(resume_from=n)` regenerates and
  emits only tokens n and after. Exports and imports run on the worker
  that owns the pool, never on a caller's thread.

Chaos site: `serving.decode_step` fires on the worker thread before
every decode step (testing/chaos.py).

Not ported: the predict engine (ROADMAP queue 4, after jit.save/load)
and the fabric tiers above one host (router, front door, membership,
fleet, client, host agent: ROADMAP queue 6).
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
from collections import OrderedDict, deque
from contextlib import nullcontext
from queue import Queue
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device
from ...core import rng as _rng
from ...core.flags import flag
from ...io.bucketing import bucket_boundaries_pow2, bucket_for
from ...observability import trace as _tr
from ...quantization import kv as _kvq
from ...testing import chaos as _chaos
from ...testing.racecheck import shared_state as _shared_state
from ..fabric import handoff as _ho
from . import metrics as _sm
from .lifecycle import (Future, ReplicaSlot, ServingError, device_pool,
                        pick_least_loaded_device, validate_sampling)

_NEG_INF = -1e30
# Retry-After of a 503: the queue's drain estimate, clamped to these
_RETRY_AFTER_S, _RETRY_AFTER_MAX_S = 0.5, 30.0
# prefix-cache entries load_report's residency digest lists at most
_PREFIX_DIGEST_MAX = 32


def _prefix_hash(prompt: np.ndarray, n: int) -> str:
    """Content key of the first n prompt tokens (the prefix cache keys
    on (n, hash), so distinct boundaries never collide). The prompt is
    hashed as int32, as the reference holds it; fabric/handoff.py's
    `prefix_hash` is the same function."""
    return hashlib.blake2b(
        np.ascontiguousarray(prompt[:n], dtype=np.int32).tobytes(),
        digest_size=16).hexdigest()


# ===================================================================
# program bodies (params: dict of stacked per-layer tensors, see
# stack_gpt_params; one Python loop over the layers)
# ===================================================================
def _ln(h, w, b, eps):
    """The bodies' own LayerNorm (mean and variance as means), as the
    reference's `_ln`."""
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) / torch.sqrt(var + eps) * w + b


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


_w = _kvq.weight     # a layer's matmul weight, dequantized if int8


def _n_layers(p) -> int:
    return p["ln1_w"].shape[0]


def _logits_head(p, h):
    if "lm_head" in p or "lm_head__q" in p:
        return h @ _w(p, "lm_head")
    return h @ p["wte"].T


def _qkv(p, l, h, eps):
    y = _ln(h, p["ln1_w"][l], p["ln1_b"][l], eps)
    return y @ _w(p, "qkv_w", l) + p["qkv_b"][l]


def _attn_out_mlp(p, l, h, att, eps):
    """Residual attention output, then the residual MLP."""
    h = h + att @ _w(p, "out_w", l) + p["out_b"][l]
    y = _ln(h, p["ln2_w"][l], p["ln2_b"][l], eps)
    return h + _gelu(y @ _w(p, "fc1_w", l) + p["fc1_b"][l]) \
        @ _w(p, "fc2_w", l) + p["fc2_b"][l]


def _filter_logits(logits, temps, topks, topps):
    """The sampled branch's logits [b, V] before the noise: over each
    row's temperature, then -1e30 below the top-k value and outside the
    top-p nucleus of the top-k survivors (the smallest sorted prefix
    that reaches mass top_p; the head token always survives). temps,
    topks, topps: [b], on any device."""
    dev = logits.device
    V = logits.shape[-1]
    t = temps.to(dev, torch.float32)
    scaled = logits / torch.clamp(t, min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, torch.clamp(topks.to(dev) - 1, 0,
                                           V - 1)[:, None].long())
    masked = torch.where(srt < kth, _NEG_INF, srt)
    sp = torch.softmax(masked, -1)
    keep = (torch.cumsum(sp, -1) - sp) < topps.to(dev, torch.float32)[:,
                                                                      None]
    cutoff = torch.amin(torch.where(keep, masked, math.inf), -1,
                        keepdim=True)
    return torch.where(scaled < torch.maximum(kth, cutoff), _NEG_INF,
                       scaled)


def _sample_rows(logits, temps, topks, topps, keys):
    """Each row's next token from its logits [b, V] (the reference's
    `_sample_token` vmapped): the argmax where the row's temperature is 0,
    else a draw from `_filter_logits` by the Gumbel-max trick with the
    row's key. temps, topks, topps: [b] on the host; keys [b, 2]. The
    sampled branch is computed only when a row samples (the host knows),
    so an all-greedy call is the argmax alone. Returns int64 [b] on the
    logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temps > 0).any()):
        return greedy
    sampled = _rng.categorical(keys, _filter_logits(logits, temps, topks,
                                                    topps))
    return torch.where(temps.to(logits.device) > 0.0, sampled, greedy)


def _sample_token(logits, temp, topk, topp, key):
    """One row's next token from its logits [V] (the reference's
    `_sample_token`): scalars temp, topk, topp and its key [2]."""
    return _sample_rows(logits[None], torch.tensor([float(temp)]),
                        torch.tensor([int(topk)]),
                        torch.tensor([float(topp)]), key[None])[0]


def _split_keys(keys):
    """Per-row split of keys [b, 2] -> (carry, use), each [b, 2]: a row's
    chain depends on its own key only."""
    kk = _rng.split(keys)
    return kk[:, 0], kk[:, 1]


def _prefill_core(p, buf_k, buf_v, slot, ids, length, num_heads, eps):
    """One full-prompt pass: causal attention within the (padded) prompt
    ids [1, S], every layer's K/V stored into pool row `slot` (positions
    [length, S) hold the pad's junk, which decode overwrites before its
    mask admits them), and the logits [V] at position length-1. The
    attention runs on the pass's own float K/V; only the pool store
    quantizes (int8 pool), so the first token is the float pool's."""
    S = ids.shape[1]
    D = p["wte"].shape[1]
    H = int(num_heads)
    Dh = D // H
    pos = torch.arange(S, device=ids.device)
    h = p["wte"][ids] + p["wpe"][pos][None]            # [1, S, D]
    causal = pos[None, :] <= pos[:, None]              # [S, S]
    ks, vs = [], []
    for l in range(_n_layers(p)):
        qkv = _qkv(p, l, h, eps).reshape(1, S, 3, H, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2),
                         k.transpose(1, 2)) / math.sqrt(Dh)
        s = torch.where(causal[None, None], s, _NEG_INF)
        att = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                           v.transpose(1, 2))
        h = _attn_out_mlp(p, l, h, att.transpose(1, 2).reshape(1, S, D),
                          eps)
        ks.append(k[0])                                # [S, H, Dh]
        vs.append(v[0])
    buf_k = _kvq.store_block(buf_k, slot, torch.stack(ks))
    buf_v = _kvq.store_block(buf_v, slot, torch.stack(vs))
    h = _ln(h, p["lnf_w"], p["lnf_b"], eps)
    return _logits_head(p, h[0, int(length) - 1]), buf_k, buf_v


def _prefill_body(p, buf_k, buf_v, slot, ids, length, temp, topk, topp,
                  key, num_heads, eps):
    """Prefill plus the sampling head: (first token [] int64, the key
    after one split, pool_k, pool_v)."""
    logits, buf_k, buf_v = _prefill_core(p, buf_k, buf_v, slot, ids,
                                         length, num_heads, eps)
    key, sub = _rng.split(key)
    return _sample_token(logits, temp, topk, topp, sub), key, buf_k, buf_v


def _drop_index(pos, M):
    """(positions clamped into the cap, which of them are in it [b, 1,
    1]) for `_write_positions`, once per call rather than per layer."""
    return torch.clamp(pos, max=M - 1), (pos < M)[:, None, None]


def _write_positions(rows, rowix, index, vals):
    """rows[rowix, pos] = vals [b, H, Dh] for index = _drop_index(pos, M),
    dropping writes at pos >= the rows' cap M (the reference's
    mode="drop"): such entries write back what they read."""
    cpos, inb = index
    rows[rowix, cpos] = torch.where(inb, vals.to(rows.dtype),
                                    rows[rowix, cpos])


def _decode_core(p, buf_k, buf_v, slots, tokens, lengths, scratch,
                 num_heads, eps):
    """The fixed-shape decode pass for `b` rows of the pool: embed each
    row's pending token at its position, attend over the row's cached
    prefix and the token itself, write exactly one new K/V per row back
    into the pool (a position past the pool's cap, which only a draft
    burst reaches, lands in the scratch row), return the logits [b, V].
    slots, tokens, lengths: [b] int64. Rows are independent; padding
    rows target the scratch slot with length 0 and the caller drops
    their outputs."""
    b = tokens.shape[0]
    M = _kvq.cap_of(buf_k)
    D = p["wte"].shape[1]
    H = int(num_heads)
    Dh = D // H
    h = p["wte"][tokens] + p["wpe"][torch.clamp(
        lengths, max=p["wpe"].shape[0] - 1)]           # [b, D]
    k_rows, k_scl = _kvq.gather_rows(buf_k, slots)     # [b, L, M, H, Dh]
    v_rows, v_scl = _kvq.gather_rows(buf_v, slots)
    kpos = torch.arange(M, device=tokens.device)
    mask = kpos[None, :] <= lengths[:, None]           # [b, M]
    rowix = torch.arange(b, device=tokens.device)
    index = _drop_index(lengths, M)
    k_news, v_news = [], []
    for l in range(_n_layers(p)):
        qkv = _qkv(p, l, h, eps).reshape(b, 3, H, Dh)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        k_l, v_l = k_rows[:, l], v_rows[:, l]          # [b, M, H, Dh]
        # fake-quant: the row reads what the int8 pool will hold
        _write_positions(k_l, rowix, index, _kvq.fake_quant(
            k_new, None if k_scl is None else k_scl[:, l]))
        _write_positions(v_l, rowix, index, _kvq.fake_quant(
            v_new, None if v_scl is None else v_scl[:, l]))
        s = torch.einsum("bhd,bmhd->bhm", q, k_l) / math.sqrt(Dh)
        s = torch.where(mask[:, None, :], s, _NEG_INF)
        att = torch.einsum("bhm,bmhd->bhd", torch.softmax(s, -1), v_l)
        h = _attn_out_mlp(p, l, h, att.reshape(b, D), eps)
        k_news.append(k_new)                           # [b, H, Dh]
        v_news.append(v_new)
    h = _ln(h, p["lnf_w"], p["lnf_b"], eps)
    # write only the new position back (the gathered copies die here);
    # an out-of-cap position goes to the scratch row
    safe = lengths < M
    wslot = torch.where(safe, slots, scratch)
    wpos = torch.where(safe, lengths, 0)
    buf_k = _kvq.scatter_rows(buf_k, wslot, wpos, torch.stack(k_news, 1))
    buf_v = _kvq.scatter_rows(buf_v, wslot, wpos, torch.stack(v_news, 1))
    return _logits_head(p, h), buf_k, buf_v


def _decode_body(p, buf_k, buf_v, slots, tokens, lengths, temps, topks,
                 topps, keys, scratch, num_heads, eps):
    """One decode step with the sampling head, one key split per row:
    (next tokens [b] int64, keys [b, 2], pool_k, pool_v)."""
    logits, buf_k, buf_v = _decode_core(p, buf_k, buf_v, slots, tokens,
                                        lengths, scratch, num_heads, eps)
    keys, subs = _split_keys(keys)
    return (_sample_rows(logits, temps, topks, topps, subs), keys, buf_k,
            buf_v)


def _propose_body(p, buf_k, buf_v, slots, tokens, lengths, k, scratch,
                  num_heads, eps):
    """The draft's burst: k greedy decode steps in one call, leaving the
    draft pool's K/V advanced through all k inputs (so a fully accepted
    burst finds every position it needs next time). Returns (proposals
    [b, k], pool_k, pool_v)."""
    props = []
    for _ in range(int(k)):
        logits, buf_k, buf_v = _decode_core(p, buf_k, buf_v, slots, tokens,
                                            lengths, scratch, num_heads,
                                            eps)
        tokens = torch.argmax(logits, dim=-1)
        lengths = lengths + 1
        props.append(tokens)
    return torch.stack(props, 1), buf_k, buf_v


def _verify_body(p, buf_k, buf_v, slots, tokens, lengths, temps, topks,
                 topps, keys, scratch, num_heads, eps):
    """Speculative verification: tokens [b, k] are each row's pending
    token and k-1 draft proposals; one batched pass computes the target's
    own token at every position, sampled with the key chain plain decode
    would use (one split a position), stores the block's K/V (positions
    past the cap land in the scratch row) and returns (tokens [b, k],
    the key after each position's split [b, k, 2], pool_k, pool_v), so
    that the host can accept the longest agreed prefix and carry the key
    as far as the tokens it emits."""
    b, kk = tokens.shape
    M = _kvq.cap_of(buf_k)
    D = p["wte"].shape[1]
    H = int(num_heads)
    Dh = D // H
    dev = tokens.device
    pos = lengths[:, None] + torch.arange(kk, device=dev)[None, :]
    h = p["wte"][tokens] + p["wpe"][torch.clamp(
        pos, max=p["wpe"].shape[0] - 1)]               # [b, k, D]
    k_rows, k_scl = _kvq.gather_rows(buf_k, slots)     # [b, L, M, H, Dh]
    v_rows, v_scl = _kvq.gather_rows(buf_v, slots)
    kpos = torch.arange(M, device=dev)
    mask = kpos[None, None, :] <= pos[:, :, None]      # [b, k, M]
    rowix = torch.arange(b, device=dev)
    index = [_drop_index(pos[:, j], M) for j in range(kk)]
    k_news, v_news = [], []
    for l in range(_n_layers(p)):
        qkv = _qkv(p, l, h, eps).reshape(b, kk, 3, H, Dh)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k_l, v_l = k_rows[:, l], v_rows[:, l]
        sk = None if k_scl is None else k_scl[:, l]
        sv = None if v_scl is None else v_scl[:, l]
        # the block's positions in order, so that a dropped write past
        # the cap never overwrites an earlier position's
        for j in range(kk):
            _write_positions(k_l, rowix, index[j],
                             _kvq.fake_quant(k_new[:, j], sk))
            _write_positions(v_l, rowix, index[j],
                             _kvq.fake_quant(v_new[:, j], sv))
        s = torch.einsum("bqhd,bmhd->bhqm", q, k_l) / math.sqrt(Dh)
        s = torch.where(mask[:, None], s, _NEG_INF)
        att = torch.einsum("bhqm,bmhd->bqhd", torch.softmax(s, -1), v_l)
        h = _attn_out_mlp(p, l, h, att.reshape(b, kk, D), eps)
        k_news.append(k_new)                           # [b, k, H, Dh]
        v_news.append(v_new)
    h = _ln(h, p["lnf_w"], p["lnf_b"], eps)
    logits = _logits_head(p, h)                        # [b, k, V]
    outs, hist = [], []
    cur = keys
    for i in range(kk):
        cur, subs = _split_keys(cur)
        outs.append(_sample_rows(logits[:, i], temps, topks, topps, subs))
        hist.append(cur)
    safe = pos < M
    wslot = torch.where(safe, slots[:, None], scratch)
    wpos = torch.where(safe, pos, 0)
    buf_k = _kvq.scatter_rows(buf_k, wslot, wpos, torch.stack(k_news, 2))
    buf_v = _kvq.scatter_rows(buf_v, wslot, wpos, torch.stack(v_news, 2))
    return torch.stack(outs, 1), torch.stack(hist, 1), buf_k, buf_v


def _extend_body(p, buf_k, buf_v, slot, ids, start, length, temp, topk,
                 topp, key, scratch, num_heads, eps):
    """Prefix-cache tail prefill: row `slot` already holds valid K/V for
    positions [0, start); the T-token tail block ids [1, T] runs in one
    pass (its queries attend the cached prefix and, causally, the
    block), its K/V land at [start, start + T) (a bucket's overshoot
    past the cap lands in the scratch row), and the first token comes
    from the logits at absolute position length-1. An int8 pool keeps
    the row's scale (set by the cached prefix's own prefill): the tail
    quantizes with it, clip semantics. Returns (token, key after one
    split, pool_k, pool_v)."""
    T = ids.shape[1]
    start, length = int(start), int(length)
    M = _kvq.cap_of(buf_k)
    D = p["wte"].shape[1]
    H = int(num_heads)
    Dh = D // H
    dev = ids.device
    pos = start + torch.arange(T, device=dev)          # absolute
    h = p["wte"][ids] + p["wpe"][torch.clamp(
        pos, max=p["wpe"].shape[0] - 1)][None]         # [1, T, D]
    kpos = torch.arange(M, device=dev)
    mask = kpos[None, :] <= pos[:, None]               # [T, M]
    row_k, k_scl = _kvq.gather_rows(buf_k, slot)       # [L, M, H, Dh]
    row_v, v_scl = _kvq.gather_rows(buf_v, slot)
    n_in = max(0, min(T, M - start))                   # writes kept
    ks, vs = [], []
    for l in range(_n_layers(p)):
        qkv = _qkv(p, l, h, eps).reshape(1, T, 3, H, Dh)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k_l, v_l = row_k[l], row_v[l]                  # [M, H, Dh]
        k_l[start:start + n_in] = _kvq.fake_quant(
            k_new[0], None if k_scl is None else k_scl[l])[:n_in]
        v_l[start:start + n_in] = _kvq.fake_quant(
            v_new[0], None if v_scl is None else v_scl[l])[:n_in]
        s = torch.einsum("bhqd,mhd->bhqm", q.transpose(1, 2),
                         k_l) / math.sqrt(Dh)
        s = torch.where(mask[None, None], s, _NEG_INF)
        att = torch.einsum("bhqm,mhd->bhqd", torch.softmax(s, -1), v_l)
        h = _attn_out_mlp(p, l, h, att.transpose(1, 2).reshape(1, T, D),
                          eps)
        ks.append(k_new[0])                            # [T, H, Dh]
        vs.append(v_new[0])
    h = _ln(h, p["lnf_w"], p["lnf_b"], eps)
    key, sub = _rng.split(key)
    tok = _sample_token(_logits_head(p, h[0, length - 1 - start]), temp,
                        topk, topp, sub)
    safe = pos < M
    wslot = torch.where(safe, torch.full_like(pos, int(slot)),
                        scratch)                       # [T]
    wpos = torch.where(safe, pos, 0)
    buf_k = _kvq.scatter_rows(buf_k, wslot, wpos, torch.stack(ks, 1))
    buf_v = _kvq.scatter_rows(buf_v, wslot, wpos, torch.stack(vs, 1))
    return tok, key, buf_k, buf_v


def _copy_row_body(buf_k, buf_v, src, dst):
    """One pool-row copy (a prefix-cache admission or hit): row dst
    becomes row src; an int8 row copies raw with its scales."""
    return (_kvq.copy_row(buf_k, src, dst), _kvq.copy_row(buf_v, src, dst))


def _kvget_body(buf_k, buf_v, slot):
    """The KV handoff's export read: pool row `slot` of both buffers in
    the stored dtype, copied to the host (an int8 row as int8 with its
    per-layer scales, never dequantized). Returns (k, k_scale or None,
    v, v_scale or None), numpy arrays."""
    def host(t):
        return None if t is None else t.to("cpu", copy=True).numpy()

    kd, ks = _kvq.row_raw(buf_k, slot)
    vd, vs = _kvq.row_raw(buf_v, slot)
    return host(kd), host(ks), host(vd), host(vs)


def _kvput_body(buf_k, buf_v, slot, kd, ks, vd, vs):
    """The import write: raw row values (tensors on the pool's device,
    the scales None for the f32 pool) into pool row `slot`, bit-exact
    like a row copy."""
    return (_kvq.set_row_raw(buf_k, slot, kd, ks),
            _kvq.set_row_raw(buf_v, slot, vd, vs))


_STACKED = {
    "ln1_w": lambda b: b.ln1.weight, "ln1_b": lambda b: b.ln1.bias,
    "qkv_w": lambda b: b.attn.qkv_proj.weight.T,
    "qkv_b": lambda b: b.attn.qkv_proj.bias,
    "out_w": lambda b: b.attn.out_proj.weight.T,
    "out_b": lambda b: b.attn.out_proj.bias,
    "ln2_w": lambda b: b.ln2.weight, "ln2_b": lambda b: b.ln2.bias,
    "fc1_w": lambda b: b.mlp.fc1.weight.T, "fc1_b": lambda b: b.mlp.fc1.bias,
    "fc2_w": lambda b: b.mlp.fc2.weight.T, "fc2_b": lambda b: b.mlp.fc2.bias,
}


def stack_gpt_params(model) -> Tuple[dict, object]:
    """Stack a paddle_tpu_torch GPTForCausalLM's weights into the [L, ...]
    dict the program bodies loop over. Returns (params, cfg).

    Layout, the reference's: matmul weights [L, in, out] (qkv_w, out_w,
    fc1_w, fc2_w; torch's Linear stores [out, in], so they are
    transposed), biases and LayerNorm parameters [L, n], wte [V, D], wpe
    [max_seq_len, D], lnf_w and lnf_b [D], and lm_head [D, V] when the
    embeddings are not tied. Every tensor is a new float32 copy on the
    model's device, so training the model on does not change what the
    engine serves."""
    from ...models.gpt import GPTForCausalLM

    if not isinstance(model, GPTForCausalLM):
        raise TypeError(
            f"GenerativeEngine wants a paddle_tpu_torch GPTForCausalLM; got "
            f"{type(model).__name__}")

    def cp(t):
        return t.detach().to(torch.float32, copy=True).contiguous()

    blocks = model.gpt.blocks
    with torch.no_grad():
        p = {name: torch.stack([cp(get(b)) for b in blocks])
             for name, get in _STACKED.items()}
        p.update(wte=cp(model.gpt.wte.weight), wpe=cp(model.gpt.wpe.weight),
                 lnf_w=cp(model.gpt.ln_f.weight),
                 lnf_b=cp(model.gpt.ln_f.bias))
        if not model.cfg.tie_embeddings:
            p["lm_head"] = cp(model.lm_head.weight.T)
    return p, model.cfg


# ===================================================================
# request / handle
# ===================================================================
@_shared_state("tokens", "streamed", "owner", "requeues", "t_first")
class _GenRequest:
    __slots__ = ("prompt", "max_new", "eos", "future", "stream",
                 "deadline", "t_enqueue", "t_enq_ns", "ctx", "requeues",
                 "tokens", "streamed", "owner", "t_first",
                 "temperature", "top_k", "top_p", "seed",
                 "prefill_only", "handoff")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos: Optional[int], deadline: Optional[float],
                 temperature: float = 0.0, top_k: int = 1,
                 top_p: float = 1.0, seed: int = 0):
        self.prompt = prompt                  # np.int64 [P]
        self.max_new = int(max_new)
        self.eos = eos
        # fixed for the request's life: a requeue replays the same key
        # chain from the same seed
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.future = Future()
        self.stream: Queue = Queue()
        self.deadline = deadline
        self.t_enqueue = time.monotonic()
        self.t_enq_ns = time.perf_counter_ns()
        self.ctx = None
        self.requeues = 0
        self.tokens: List[int] = []   # regenerated from scratch on requeue
        self.streamed = 0             # tokens already delivered downstream
        self.owner = None             # (rid, generation) while in a slot
        self.t_first: Optional[float] = None
        # the KV handoff: prefill_only finishes with an export in place
        # of decoding here; handoff holds an imported (meta, arrays)
        # payload, which a worker installs in place of a prefill
        self.prefill_only = False
        self.handoff: Optional[tuple] = None


class GenerateHandle:
    """Client handle for one generation: iterate tokens as they stream,
    or block on `result()` for the whole thing. Events on the stream
    queue are ('tok', id) / ('done', info) / ('handoff', obj) /
    ('err', exc)."""

    def __init__(self, req: _GenRequest):
        self._req = req
        self.future = req.future

    def __iter__(self):
        for kind, val in self.events():
            if kind == "tok":
                yield int(val)

    def events(self):
        """Raw event stream: ('tok', id)*, then ('done', info), or, when
        a drain migrates the stream, ('handoff', {"handoff": base64
        payload, "streamed", "n_tokens"}) for another host to import. An
        ('err', exc) event raises."""
        while True:
            kind, val = self._req.stream.get()
            if kind == "err":
                raise val
            yield kind, val
            if kind in ("done", "handoff"):
                return

    def result(self, timeout: Optional[float] = None) -> dict:
        """{"tokens": [...], "n_tokens": int, "ttft_ms": float,
        "finish_reason": "eos"|"length"|"handoff"|"migrated", ...}; the
        last two carry the payload as base64 under "handoff"."""
        return self.future.result(timeout)


class _Row:
    __slots__ = ("req", "slot", "length", "key")

    def __init__(self, req: _GenRequest, slot: int, length: int,
                 key: torch.Tensor):
        self.req = req
        self.slot = slot
        self.length = length   # cached positions; pending tok = tokens[-1]
        # the row's current key (int64 [2] on the host), split once per
        # emitted token (prefill took the first split)
        self.key = key


@_shared_state("free", "rows", "pcache", "pc_free")
class _PoolState:
    """One worker's device state (the reference's per-class state, for
    its one class): the pool buffer pair (with speculation, a second
    pair in the draft's geometry for the same slots), the slot free
    list, the live rows, and the prefix cache's LRU over its pool rows
    (the owning worker and the admit/finish/fail paths share free, rows,
    pcache and pc_free under the engine lock). A revived worker
    allocates a fresh one; a failed step resets it."""

    __slots__ = ("n_slots", "pc_slots", "buf_k", "buf_v", "dbuf_k",
                 "dbuf_v", "free", "rows", "pcache", "pc_free")

    def __init__(self, n_slots: int, pc_slots: int, bufs: tuple):
        self.n_slots = int(n_slots)
        self.pc_slots = int(pc_slots)
        self.reset(bufs)

    def reset(self, bufs: tuple) -> None:
        """Fresh buffers (buf_k, buf_v, dbuf_k, dbuf_v), every slot free
        and an empty cache."""
        self.buf_k, self.buf_v, self.dbuf_k, self.dbuf_v = bufs
        self.free: List[int] = list(range(self.n_slots))
        self.rows: Dict[int, _Row] = {}
        # (prefix length, blake2b hex) -> pool row; insertion order is
        # recency order (move_to_end on a hit, the first one evicted)
        self.pcache: "OrderedDict[tuple, int]" = OrderedDict()
        self.pc_free: List[int] = list(
            range(self.n_slots + 1, self.n_slots + 1 + self.pc_slots))


# ===================================================================
# metrics
# ===================================================================
@_shared_state("requests_total", "completed_total", "failed_total",
               "shed_total", "rejected_total", "requeues_total",
               "tokens_out_total", "prompt_tokens_total",
               "prefills_total", "steps_total", "step_rows_total",
               "step_padded_rows_total", "occupancy_hist", "_ttft",
               "_latency", "_token_stamps", "_step_s", "_prefill_s",
               "draft_steps_total", "spec_steps_total",
               "spec_proposed_total", "spec_accepted_total",
               "prefix_hits_total", "prefix_misses_total",
               "prefix_evictions_total", "prefix_tokens_reused_total",
               "handoffs_out_total", "handoffs_in_total",
               "migrations_out_total", "handoff_bytes_total")
class GenerativeMetrics:
    """Thread-safe metric store for one GenerativeEngine: tokens/s,
    TTFT, decode slot occupancy and KV-pool utilisation, the request,
    speculation, prefix-cache and handoff counters (`snapshot()`, and
    `prometheus_text()` for /metrics, each with the reference's names),
    and (the port's own, read by `step_ms()`) the host time of each
    decode step by batch bucket and of each prefill by prompt bucket (a
    prefix-cache hit's by tail bucket, as "extend"), from the call to
    its tokens on the host."""

    def __init__(self, ring: int = 4096, window_s: float = 30.0):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._window = float(window_s)
        self.requests_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.shed_total = 0
        self.rejected_total: Dict[str, int] = {}
        self.requeues_total = 0
        self.tokens_out_total = 0
        self.prompt_tokens_total = 0
        self.prefills_total = 0
        self.steps_total = 0
        self.step_rows_total = 0          # real rows over all steps
        self.step_padded_rows_total = 0   # pad rows added by batch bucket
        self.draft_steps_total = 0        # k-step draft bursts
        self.spec_steps_total = 0         # target verify passes
        self.spec_proposed_total = 0      # draft tokens offered (k-1/row)
        self.spec_accepted_total = 0      # draft tokens accepted
        self.prefix_hits_total = 0
        self.prefix_misses_total = 0
        self.prefix_evictions_total = 0
        self.prefix_tokens_reused_total = 0   # prompt tokens not prefilled
        self.handoffs_out_total = 0       # KV slots exported (all causes)
        self.handoffs_in_total = 0        # KV slots imported
        self.migrations_out_total = 0     # exports of a migrating drain
        self.handoff_bytes_total = 0      # payload bytes, both ways
        self.occupancy_hist: Dict[int, int] = {}   # active rows -> steps
        self._ttft = deque(maxlen=int(ring))       # seconds
        self._latency = deque(maxlen=int(ring))    # request total seconds
        self._token_stamps = deque(maxlen=65536)   # (monotonic, n)
        self._step_s: Dict[int, deque] = {}        # batch bucket -> s
        # (kind, bucket) -> s: kind "prefill" by prompt bucket, "extend"
        # by tail bucket
        self._prefill_s: Dict[tuple, deque] = {}
        self._ring = int(ring)
        self.queue_depth_fn = lambda: 0
        self.replicas_fn = lambda: 0
        self.kv_util_fn = lambda: {"slots_used": 0, "slots_total": 0,
                                   "positions_used": 0,
                                   "positions_total": 0}
        self.quant_flags_fn = lambda: (0, 0)   # (kv int8?, weights int8?)

    # ------------------------------------------------------------ record --
    def on_accept(self):
        with self._lock:
            self.requests_total += 1

    def on_reject(self, reason: str):
        with self._lock:
            self.rejected_total[reason] = \
                self.rejected_total.get(reason, 0) + 1

    def on_shed(self):
        with self._lock:
            self.shed_total += 1

    def on_failed(self, n: int = 1):
        with self._lock:
            self.failed_total += n

    def on_requeue(self, n: int = 1):
        with self._lock:
            self.requeues_total += n

    def on_prefill(self, prompt_tokens: int, bucket: int, seconds: float,
                   kind: str = "prefill"):
        with self._lock:
            self.prefills_total += 1
            self.prompt_tokens_total += prompt_tokens
            self._prefill_s.setdefault(
                (kind, bucket), deque(maxlen=self._ring)).append(seconds)

    def on_spec_step(self, proposed: int, accepted: int):
        """One draft burst and one verify pass over the batch: `proposed`
        draft tokens offered ((k-1) a real row), `accepted` kept."""
        with self._lock:
            self.draft_steps_total += 1
            self.spec_steps_total += 1
            self.spec_proposed_total += int(proposed)
            self.spec_accepted_total += int(accepted)

    def on_prefix(self, hit: bool, tokens_reused: int = 0):
        with self._lock:
            if hit:
                self.prefix_hits_total += 1
                self.prefix_tokens_reused_total += int(tokens_reused)
            else:
                self.prefix_misses_total += 1

    def on_prefix_evict(self):
        with self._lock:
            self.prefix_evictions_total += 1

    def on_handoff_out(self, nbytes: int, migrated: bool = False):
        with self._lock:
            self.handoffs_out_total += 1
            self.handoff_bytes_total += int(nbytes)
            if migrated:
                self.migrations_out_total += 1

    def on_handoff_in(self, nbytes: int):
        with self._lock:
            self.handoffs_in_total += 1
            self.handoff_bytes_total += int(nbytes)

    def on_step(self, rows: int, bucket: int, seconds: float):
        with self._lock:
            self.steps_total += 1
            self.step_rows_total += rows
            self.step_padded_rows_total += max(bucket - rows, 0)
            self.occupancy_hist[rows] = \
                self.occupancy_hist.get(rows, 0) + 1
            self._step_s.setdefault(
                bucket, deque(maxlen=self._ring)).append(seconds)

    def _evict_locked(self, now: float):
        horizon = now - self._window
        while self._token_stamps and self._token_stamps[0][0] < horizon:
            self._token_stamps.popleft()

    def on_tokens(self, n: int):
        now = time.monotonic()
        with self._lock:
            self.tokens_out_total += n
            self._evict_locked(now)
            self._token_stamps.append((now, n))

    def on_first_token(self, ttft_s: float):
        with self._lock:
            self._ttft.append(float(ttft_s))

    def on_complete(self, latency_s: float):
        with self._lock:
            self.completed_total += 1
            self._latency.append(float(latency_s))

    # ------------------------------------------------------------- query --
    _pcts = staticmethod(_sm.percentiles)

    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            return self._pcts(self._latency)

    def ttft_percentiles(self) -> Dict[str, float]:
        with self._lock:
            return self._pcts(self._ttft)

    def step_ms(self) -> Dict[str, Dict[int, Dict[str, float]]]:
        """{"decode": {batch bucket: stats}, "prefill": {prompt bucket:
        stats}, "extend": {tail bucket: stats}}, each stats {"n", "p50",
        "p99"} in ms (a speculative step is one draft burst and its
        verify pass)."""
        with self._lock:
            srcs = {"decode": dict(self._step_s), "prefill": {},
                    "extend": {}}
            for (kind, b), vals in self._prefill_s.items():
                srcs[kind][b] = vals
            out = {}
            for name, src in srcs.items():
                out[name] = {}
                for b, vals in sorted(src.items()):
                    pc = self._pcts(vals)
                    out[name][b] = {"n": len(vals),
                                    "p50": pc["p50"] * 1e3,
                                    "p99": pc["p99"] * 1e3}
            return out

    def tokens_per_s(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._evict_locked(now)
            n = sum(c for _, c in self._token_stamps)
        window = min(self._window, max(now - self._t0, 1e-9))
        return n / window

    def max_occupancy(self) -> int:
        with self._lock:
            return max(self.occupancy_hist) if self.occupancy_hist else 0

    def snapshot(self) -> dict:
        ttft = self.ttft_percentiles()
        lat = self.latency_percentiles()
        # gauge callbacks before our lock: replicas_fn takes the engine
        # lock, which the engine holds while calling into us
        queue_depth = int(self.queue_depth_fn())
        replicas = int(self.replicas_fn())
        quant_kv, quant_w = self.quant_flags_fn()
        with self._lock:
            occ_n = sum(k * v for k, v in self.occupancy_hist.items())
            occ_d = sum(self.occupancy_hist.values())
            out = {
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "failed_total": self.failed_total,
                "shed_total": self.shed_total,
                "rejected_total": sum(self.rejected_total.values()),
                "requeues_total": self.requeues_total,
                "tokens_out_total": self.tokens_out_total,
                "prompt_tokens_total": self.prompt_tokens_total,
                "prefills_total": self.prefills_total,
                "steps_total": self.steps_total,
                "step_rows_total": self.step_rows_total,
                "step_padded_rows_total": self.step_padded_rows_total,
                "draft_steps_total": self.draft_steps_total,
                "spec_steps_total": self.spec_steps_total,
                "spec_proposed_total": self.spec_proposed_total,
                "spec_accepted_total": self.spec_accepted_total,
                "spec_accept_rate": _sm.rate(self.spec_accepted_total,
                                             self.spec_proposed_total),
                "prefix_hits_total": self.prefix_hits_total,
                "prefix_misses_total": self.prefix_misses_total,
                "prefix_evictions_total": self.prefix_evictions_total,
                "prefix_tokens_reused_total":
                    self.prefix_tokens_reused_total,
                "handoffs_out_total": self.handoffs_out_total,
                "handoffs_in_total": self.handoffs_in_total,
                "migrations_out_total": self.migrations_out_total,
                "handoff_bytes_total": self.handoff_bytes_total,
                "prefix_hit_rate": _sm.rate(
                    self.prefix_hits_total,
                    self.prefix_hits_total + self.prefix_misses_total),
                "avg_slot_occupancy": round(occ_n / occ_d, 3)
                if occ_d else 0.0,
                "max_slot_occupancy": max(self.occupancy_hist)
                if self.occupancy_hist else 0,
                "occupancy_hist": dict(sorted(self.occupancy_hist.items())),
                "queue_depth": queue_depth,
                "replicas": replicas,
                "quant_kv_enabled": int(quant_kv),
                "quant_weights_enabled": int(quant_w),
            }
        out["kv_pool"] = dict(self.kv_util_fn())
        tot = out["kv_pool"].get("positions_total") or 0
        used = out["kv_pool"].get("positions_used") or 0
        out["kv_pool"]["utilization"] = round(used / tot, 4) if tot else 0.0
        out["ttft_ms"] = {k: round(v * 1e3, 3) for k, v in ttft.items()}
        out["latency_ms"] = {k: round(v * 1e3, 3) for k, v in lat.items()}
        out["tokens_per_s"] = round(self.tokens_per_s(), 3)
        return out

    def prometheus_text(self) -> str:
        """The snapshot in Prometheus' text format (GET /metrics), the
        reference's metric names, types and help strings."""
        s = self.snapshot()
        lines: List[str] = []

        def metric(name, mtype, value, help_):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {value}")

        for name, mtype, value, help_ in (
                ("requests_total", "counter", s["requests_total"],
                 "generation requests accepted"),
                ("completed_total", "counter", s["completed_total"],
                 "generations completed"),
                ("failed_total", "counter", s["failed_total"],
                 "generations failed at runtime"),
                ("shed_total", "counter", s["shed_total"],
                 "generation requests shed by the circuit breaker (503)"),
                ("tokens_total", "counter", s["tokens_out_total"],
                 "tokens generated"),
                ("steps_total", "counter", s["steps_total"],
                 "decode steps executed"),
                ("prefills_total", "counter", s["prefills_total"],
                 "prefill calls executed"),
                ("queue_depth", "gauge", s["queue_depth"],
                 "generation queue depth"),
                ("replicas", "gauge", s["replicas"],
                 "active decode workers"),
                ("tokens_per_s", "gauge", s["tokens_per_s"],
                 "tokens/sec over the sliding window"),
                ("kv_pool_utilization", "gauge",
                 s["kv_pool"]["utilization"],
                 "fraction of KV-pool positions holding live sequences"),
                ("kv_pool_bytes", "gauge",
                 s["kv_pool"].get("pool_bytes", 0),
                 "bytes the KV pools allocate across active replicas"),
                ("quant_kv_enabled", "gauge", s["quant_kv_enabled"],
                 "1 when the engine's KV pool is int8-quantized"),
                ("quant_weights_enabled", "gauge",
                 s["quant_weights_enabled"],
                 "1 when the engine serves weight-only int8 replicas"),
                ("slot_occupancy_avg", "gauge", s["avg_slot_occupancy"],
                 "mean active rows per executed decode step"),
                ("spec_steps_total", "counter", s["spec_steps_total"],
                 "speculative verify passes executed"),
                ("spec_accepted_total", "counter",
                 s["spec_accepted_total"],
                 "draft-proposed tokens accepted by the target"),
                ("spec_accept_rate", "gauge", s["spec_accept_rate"],
                 "accepted / proposed draft tokens (lifetime)"),
                ("prefix_hits_total", "counter", s["prefix_hits_total"],
                 "prefills served from the prefix cache"),
                ("prefix_misses_total", "counter",
                 s["prefix_misses_total"],
                 "prefills with no cached prefix"),
                ("prefix_tokens_reused_total", "counter",
                 s["prefix_tokens_reused_total"],
                 "prompt tokens NOT re-prefilled thanks to the cache"),
                ("handoffs_out_total", "counter", s["handoffs_out_total"],
                 "KV slots exported for cross-host handoff"),
                ("handoffs_in_total", "counter", s["handoffs_in_total"],
                 "KV slots imported from another host"),
                ("migrations_out_total", "counter",
                 s["migrations_out_total"],
                 "in-flight streams migrated out on drain"),
                ("handoff_bytes_total", "counter",
                 s["handoff_bytes_total"],
                 "handoff wire bytes, exports plus imports")):
            metric("paddle_generate_" + name, mtype, value, help_)
        lines.append("# HELP paddle_generate_ttft_seconds time-to-first-"
                     "token quantiles over the recent-sample ring")
        lines.append("# TYPE paddle_generate_ttft_seconds summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'paddle_generate_ttft_seconds{{quantile="{q}"}} '
                         f'{s["ttft_ms"][key] / 1e3:.6f}')
        return "\n".join(lines) + "\n"


# ===================================================================
# the engine
# ===================================================================
@_shared_state("_queue", "_workers", "_warmed", "_live_rows",
               "_params_by_dev", "_draft_by_dev", "_closing", "_abort",
               "_shut", "_next_rid", "_cold_calls", "_migrate_streams",
               "_pc_index")
class GenerativeEngine:
    """Continuous-batching serving of a paddle_tpu_torch GPTForCausalLM
    (its weights are copied out and stacked, see stack_gpt_params).
    `slots` is the decode-batch capacity per worker; prompts are padded
    to pow2 buckets from 8 to `max_context`. `device` is where the
    replicas run: the card by default (raising without one), "cpu" when
    the caller asks; a bare "cuda" spreads replicas over every card.

    `draft` (a GPTForCausalLM sharing the vocab, its max_seq_len covering
    max_context) or `draft_params` (a stacked (params, cfg) pair) turns
    on speculative decoding with `spec_tokens` (>= 2) positions a burst;
    `prefix_cache_slots` extra pool rows cache prompt prefixes;
    `kv_dtype="int8"` quantizes the KV pool and `quantize_weights=True`
    keeps the matmul weights int8 (quantization/kv.py). A request's
    `temperature`, `top_k`, `top_p` and `seed` select seeded sampling.
    `import_handoff`, `submit(prefill_only=True)`, `submit(resume_from=
    n)` and `shutdown(migrate=True)` move live streams between engines
    (the KV handoff, see the module docstring).
    """

    def __init__(self, model, slots: Optional[int] = None,
                 max_context: Optional[int] = None,
                 replicas: int = 1,
                 max_queue_depth: Optional[int] = None,
                 max_new_tokens_cap: Optional[int] = None,
                 auto_start: bool = True,
                 draft=None, draft_params: Optional[tuple] = None,
                 spec_tokens: int = 4,
                 prefix_cache_slots: int = 0,
                 kv_dtype: str = "f32",
                 quantize_weights: bool = False,
                 device=None):
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32' or 'int8' (got {kv_dtype!r})")
        self._device_pool = device_pool(resolve_device(device))
        self._params, self._cfg = stack_gpt_params(model)
        self._H = int(self._cfg.num_heads)
        self._Dh = int(self._cfg.hidden_size) // self._H
        self._L = int(self._cfg.num_layers)
        self._eps = float(self._cfg.layer_norm_eps)
        self._vocab = int(self._cfg.vocab_size)

        self._slots = int(slots if slots is not None
                          else flag("generate_slots"))
        self._max_ctx = int(min(max_context or self._cfg.max_seq_len,
                                self._cfg.max_seq_len))

        # speculative decoding: a cheap draft sharing the vocab
        if draft_params is not None:
            self._draft_params, dcfg = draft_params
        elif draft is not None:
            self._draft_params, dcfg = stack_gpt_params(draft)
        else:
            self._draft_params = dcfg = None
        self._spec = self._draft_params is not None
        if self._spec:
            if int(dcfg.vocab_size) != self._vocab:
                raise ValueError(
                    f"draft vocab {int(dcfg.vocab_size)} != target vocab "
                    f"{self._vocab}: speculative decoding needs a shared "
                    f"tokenizer")
            if int(dcfg.max_seq_len) < self._max_ctx:
                raise ValueError(
                    f"draft max_seq_len {int(dcfg.max_seq_len)} < engine "
                    f"max_context {self._max_ctx}: the draft must cover "
                    f"every cached position")
            if int(spec_tokens) < 2:
                raise ValueError(
                    f"spec_tokens must be >= 2 (got {spec_tokens}); 1 "
                    f"means plain decode, so drop the draft instead")
            self._dH = int(dcfg.num_heads)
            self._dL = int(dcfg.num_layers)
            self._dDh = int(dcfg.hidden_size) // self._dH
            self._deps = float(dcfg.layer_norm_eps)
            self._spec_k = int(spec_tokens)
        else:
            self._spec_k = 1
        self._pc_slots = max(0, int(prefix_cache_slots))
        self._kv_dtype = str(kv_dtype)
        self._quant_w = bool(quantize_weights)
        if self._quant_w:
            # once, where the model lives: the replicas copy the int8
            # tensors, which stay int8 at rest on every device
            self._params = _kvq.quantize_stacked_params(self._params)
            if self._spec:
                self._draft_params = _kvq.quantize_stacked_params(
                    self._draft_params)

        self._prompt_boundaries = bucket_boundaries_pow2(
            min(8, self._max_ctx), self._max_ctx)
        self._batch_buckets = bucket_boundaries_pow2(1, self._slots)
        self._max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else flag("serving_max_queue_depth"))
        self._max_new_cap = int(
            max_new_tokens_cap if max_new_tokens_cap is not None
            else flag("generate_max_new_tokens"))

        self._cv = threading.Condition()
        self._queue: "deque[_GenRequest]" = deque()
        # rid -> {slot: cached positions}: the lock-protected mirror of
        # each worker's row table, for the KV-utilisation gauge
        self._live_rows: Dict[int, Dict[int, int]] = {}
        # the KV handoff: whether a drain migrates streamed rows out, and
        # rid -> the "F:hash8" keys of that worker's prefix cache (the
        # residency digest of load_report)
        self._migrate_streams = False
        self._pc_index: Dict[int, set] = {}
        self._closing = False
        self._abort = False
        self._shut = False
        self._next_rid = 0
        self._params_by_dev: dict = {}
        self._draft_by_dev: dict = {}
        self._warmed: set = set()     # (device_key, kind, bucket)
        # calls after admission of a program not yet run on its device
        self._cold_calls = 0
        self._workers: List[ReplicaSlot] = []

        self.metrics = GenerativeMetrics()
        # approximate gauge: a GIL-atomic len, so a scrape never contends
        self.metrics.queue_depth_fn = lambda: len(self._queue)
        self.metrics.replicas_fn = lambda: len(self._active())
        self.metrics.kv_util_fn = self._kv_utilization
        self.metrics.quant_flags_fn = lambda: (
            int(self._kv_dtype == "int8"), int(self._quant_w))

        for _ in range(max(int(replicas), 1)):
            self._workers.append(self._new_worker())
        self.warm_up()
        self._started = False
        if auto_start:
            self.start()

    def _on_device(self, cache: dict, params: dict, device) -> dict:
        """`params` on `device`, copied there on first use (in the
        warm-up, before any worker on it admits a request)."""
        key = self._device_key(device)
        with self._cv:
            p = cache.get(key)
            if p is None:
                p = {k: v.to(device) for k, v in params.items()}
                cache[key] = p
        return p

    def _params_for(self, device):
        return self._on_device(self._params_by_dev, self._params, device)

    def _draft_params_for(self, device):
        return self._on_device(self._draft_by_dev, self._draft_params,
                               device)

    def _alloc_bufs(self, device) -> tuple:
        """(pool_k, pool_v, draft_k, draft_v) for one worker; the draft's
        pair is None without speculation."""
        mk = lambda shape: _kvq.alloc(shape, device,      # noqa: E731
                                      self._kv_dtype)
        bufs = (mk(self._pool_shape()), mk(self._pool_shape()))
        if self._spec:
            return bufs + (mk(self._draft_pool_shape()),
                           mk(self._draft_pool_shape()))
        return bufs + (None, None)

    def _alloc_pool(self, device) -> _PoolState:
        # rows: [0, slots) live, [slots] scratch (pad/overflow sink),
        # [slots + 1, slots + 1 + prefix_cache_slots) the prefix cache
        return _PoolState(self._slots, self._pc_slots,
                          self._alloc_bufs(device))

    def _pool_shape(self) -> tuple:
        return (self._slots + 1 + self._pc_slots, self._L, self._max_ctx,
                self._H, self._Dh)

    def _draft_pool_shape(self) -> tuple:
        return (self._slots + 1, self._dL, self._max_ctx, self._dH,
                self._dDh)

    def kv_pool_bytes(self) -> int:
        """Bytes ONE worker's KV pools allocate (K and V, the scratch and
        prefix-cache rows included, and the draft's pair with
        speculation)."""
        total = 2 * _kvq.pool_nbytes(self._pool_shape(), self._kv_dtype)
        if self._spec:
            total += 2 * _kvq.pool_nbytes(self._draft_pool_shape(),
                                          self._kv_dtype)
        return total

    def _programs(self) -> List[str]:
        progs = [f"prefill[b={s}]" for s in self._prompt_boundaries] \
            + [f"decode[b={b}]" for b in self._batch_buckets] \
            + ["kvget[b=1]", "kvput[b=1]"]
        if self._pc_slots:
            progs += ["pcopy[b=1]"] + [f"extend[b={s}]"
                                       for s in self._prompt_boundaries]
        if self._spec:
            k = self._spec_k
            progs += [f"dprefill[b={s}]" for s in self._prompt_boundaries]
            progs += [f"{kind}[b={b},k={k}]" for kind in ("dpropose",
                                                          "verify")
                      for b in self._batch_buckets]
        return progs

    def program_report(self) -> dict:
        """The program inventory: one prefill per prompt bucket, one
        decode step per batch bucket and the handoff's row read and
        write, kvget and kvput (with the prefix cache the row copy and
        one extend per tail bucket; with a draft one draft prefill per
        prompt bucket and the propose and verify passes per batch
        bucket), how many (device, program) pairs ran, and how many calls
        after admission found their program not yet run on its device."""
        with self._cv:
            warmed = len(self._warmed)
            cold = self._cold_calls
        return {
            "prefill_buckets": list(self._prompt_boundaries),
            "decode_batch_buckets": list(self._batch_buckets),
            "max_context": self._max_ctx,
            "kv_dtype": self._kv_dtype,
            "quantize_weights": self._quant_w,
            "programs": self._programs(),
            "warmed": warmed,
            "first_calls_after_warmup": cold,
        }

    # ----------------------------------------------------------- workers --
    def _new_worker(self, device=None) -> ReplicaSlot:
        if device is None:
            device = pick_least_loaded_device(self._device_pool,
                                              self._workers)
        w = ReplicaSlot(self._next_rid, device)
        self._next_rid += 1
        return w

    def _active(self) -> List[ReplicaSlot]:
        with self._cv:
            return [w for w in self._workers if w.state == "active"]

    def _device_key(self, device) -> int:
        for i, d in enumerate(self._device_pool):
            if d == torch.device(device):
                return i
        return -1

    def replica_states(self) -> List[dict]:
        now = time.monotonic()
        with self._cv:
            return [w.state_row(now) for w in self._workers]

    def _kv_utilization(self) -> dict:
        """Pool gauge across workers: live slots and positions over the
        pool every started worker allocates."""
        with self._cv:
            pools = sum(1 for w in self._workers
                        if w.state in ("active", "draining"))
            snap = [dict(rows) for rows in self._live_rows.values()]
        slots_used = positions_used = 0
        for rows in snap:
            slots_used += len(rows)
            positions_used += sum(rows.values())
        return {"slots_used": slots_used,
                "slots_total": pools * self._slots,
                "positions_used": positions_used,
                "positions_total": pools * self._slots * self._max_ctx,
                "pool_bytes": pools * self.kv_pool_bytes()}

    # --------------------------------------------------------- elasticity --
    def add_replica(self, device=None, warm: bool = True) -> dict:
        """Grow the worker pool at run time; the new worker runs every
        program on its device before it is admitted (warm=False admits
        it at once, and program_report counts its first calls).
        `warmed_executables` is the programs run before admission."""
        _chaos.hit("scale.add")
        if device is not None:
            device = torch.device(device)
            k = self._device_key(device)
            if k < 0:
                self._device_pool.append(device)
            else:
                device = self._device_pool[k]
        with self._cv:
            if self._closing:
                raise ServingError(503, "server shutting down",
                                   retry_after=_RETRY_AFTER_S)
            w = self._new_worker(device)
            self._workers.append(w)
        t0 = time.perf_counter()
        try:
            warmed = self._warm_device(w.device) if warm else 0
            started = self._started
            if started:
                self._start_worker(w)
        except Exception:
            with self._cv:
                if w in self._workers:
                    self._workers.remove(w)
            raise
        with self._cv:
            w.state = "active"
            self._cv.notify_all()
        return {"rid": w.rid, "device": str(w.device),
                "warmed_executables": warmed,
                "warm_time_s": round(time.perf_counter() - t0, 3),
                "admitted_after_warmup": True, "worker_started": started}

    def remove_replica(self, rid: Optional[int] = None, drain: bool = True,
                       timeout: float = 60.0) -> dict:
        """Retire one worker. drain=True: it stops admitting, its
        in-flight sequences run to completion, then it exits. drain=
        False: it is superseded and its in-flight requests requeue onto
        the other workers (they re-prefill; tokens already streamed are
        not emitted again)."""
        _chaos.hit("scale.drain", rid=rid if rid is not None else -1)
        with self._cv:
            target = None
            if rid is None:
                actives = [w for w in self._workers
                           if w.state == "active"]
                target = actives[-1] if actives else None
            else:
                for w in self._workers:
                    if w.rid == rid and w.state in ("active", "draining"):
                        target = w
            if target is None:
                raise ValueError(f"no removable worker (rid={rid})")
            n_active = sum(1 for w in self._workers
                           if w.state == "active")
            if n_active <= 1 and target.state == "active":
                raise ValueError(
                    "cannot remove the last active worker — the queue "
                    "would starve; add a replacement first")
            target.state = "draining"
            self._cv.notify_all()
        if drain:
            with self._cv:
                self._cv.wait_for(
                    lambda: target.state == "retired", timeout)
                drained = target.state == "retired"
        else:
            self._supersede(target, retire=True)
            drained = False
        with self._cv:
            return {"rid": target.rid, "drained": drained,
                    "state": target.state}

    def revive_replica(self, rid: int) -> dict:
        """Replace a (presumed hung) worker's thread in place: the fresh
        generation gets fresh pool buffers and the stuck in-flight
        requests requeue for re-prefill."""
        with self._cv:
            target = None
            for w in self._workers:
                if w.rid == rid and w.state in ("active", "draining"):
                    target = w
            if target is None:
                raise ValueError(f"no live worker rid={rid}")
        self._supersede(target, retire=False)
        with self._cv:
            return {"rid": rid, "generation": target.generation}

    def _supersede(self, w: ReplicaSlot, retire: bool) -> None:
        with self._cv:
            w.generation += 1
            gen = w.generation
            stuck = list(w.inflight)
            w.inflight = []
            w.busy_since = None
            self._live_rows.pop(w.rid, None)
            self._pc_index.pop(w.rid, None)
            for req in stuck:
                req.owner = None
            if retire:
                w.state = "retired"
                self._cv.notify_all()
        self._requeue(stuck)
        if not retire:
            with self._cv:
                w.last_beat = time.monotonic()
            self._start_worker(w, gen)

    def _requeue(self, reqs: List[_GenRequest], charge: bool = True) -> None:
        """Put incomplete requests back at the front of the queue for
        re-prefill. One charged requeue per request (a second one 503s,
        so bouncing between sick workers cannot mask an outage); the
        regenerated stream is suppressed up to `streamed`."""
        if not reqs:
            return
        failed = 0
        with self._cv:
            dead = self._shut or not any(
                w.state in ("warming", "active") for w in self._workers)
            for req in reversed(reqs):
                if req.future.done():
                    continue
                if (charge and req.requeues >= 1) or dead:
                    msg = ("server shutting down while generation was in "
                           "flight" if dead else
                           "worker replaced twice while generation was "
                           "in flight")
                    err = ServingError(503, msg,
                                       retry_after=self._retry_after())
                    if req.future.set_error(err):
                        req.stream.put(("err", err))
                        failed += 1
                    continue
                if charge:
                    req.requeues += 1
                    self.metrics.on_requeue()
                req.owner = None
                req.tokens = []   # regenerate; stream dedupes on streamed
                self._queue.appendleft(req)
            self._cv.notify_all()
        if failed:
            self.metrics.on_failed(failed)

    # ------------------------------------------------------------ warmup --
    def _device_ctx(self, device):
        device = torch.device(device)
        return torch.cuda.device(device) if device.type == "cuda" \
            else nullcontext()

    def _warm_device(self, device) -> int:
        """Run the whole program inventory once on `device`, on a pool of
        its own, through the scratch row, sampling (temperature 1) so
        that the sampling head's kernels run too: every prompt-bucket
        prefill and batch-bucket decode step, and the handoff's row read
        and write; with the prefix cache the
        row copy and every tail-bucket extend; with a draft every draft
        prefill and the propose and verify passes by batch bucket."""
        p = self._params_for(device)
        devk = self._device_key(device)
        scratch = self._slots
        V, k = self._vocab, self._spec_k
        n = 0

        def ids(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)

        def rows(b):
            """Per-row inputs of a batch-bucket program: (slots, tokens,
            lengths) on the device, (temps, topks, topps, keys) on the
            host."""
            return ((torch.full((b,), scratch, dtype=torch.int64,
                                device=device), ids(b), ids(b)),
                    (torch.ones(b), torch.full((b,), V), torch.ones(b),
                     torch.zeros(b, 2, dtype=torch.int64)))

        def done(kind, bucket, out):
            nonlocal n
            out.cpu()
            with self._cv:
                self._warmed.add((devk, kind, bucket))
            n += 1

        key0 = torch.zeros(2, dtype=torch.int64)
        with torch.inference_mode(), self._device_ctx(device):
            pool = self._alloc_pool(device)
            for s in self._prompt_boundaries:
                tok, _, _, _ = _prefill_body(
                    p, pool.buf_k, pool.buf_v, scratch, ids(1, s), 1, 1.0,
                    V, 1.0, key0, self._H, self._eps)
                done("prefill", s, tok)
            for b in self._batch_buckets:
                dev_in, samp = rows(b)
                nxt, _, _, _ = _decode_body(
                    p, pool.buf_k, pool.buf_v, *dev_in, *samp, scratch,
                    self._H, self._eps)
                done("decode", b, nxt)
            # the handoff's export read and import write, over the
            # scratch row
            kd, ks, vd, vs = _kvget_body(pool.buf_k, pool.buf_v, scratch)
            done("kvget", 1, torch.from_numpy(kd[:1, :1]))
            put = [None if a is None else torch.from_numpy(a).to(device)
                   for a in (kd, ks, vd, vs)]
            _kvput_body(pool.buf_k, pool.buf_v, scratch, *put)
            done("kvput", 1, _kvq.row_raw(pool.buf_k, scratch)[0][0, 0])
            if self._pc_slots:
                _copy_row_body(pool.buf_k, pool.buf_v, scratch, scratch)
                done("pcopy", 1,
                     _kvq.row_raw(pool.buf_k, scratch)[0][0, 0])
                for s in self._prompt_boundaries:
                    tok, _, _, _ = _extend_body(
                        p, pool.buf_k, pool.buf_v, scratch, ids(1, s), 0,
                        1, 1.0, V, 1.0, key0, scratch, self._H, self._eps)
                    done("extend", s, tok)
            if self._spec:
                dp = self._draft_params_for(device)
                for s in self._prompt_boundaries:
                    tok, _, _, _ = _prefill_body(
                        dp, pool.dbuf_k, pool.dbuf_v, scratch, ids(1, s),
                        1, 0.0, 1, 1.0, key0, self._dH, self._deps)
                    done("dprefill", s, tok)
                for b in self._batch_buckets:
                    dev_in, samp = rows(b)
                    props, _, _ = _propose_body(
                        dp, pool.dbuf_k, pool.dbuf_v, *dev_in, k, scratch,
                        self._dH, self._deps)
                    done("dpropose", b, props)
                    ys, _, _, _ = _verify_body(
                        p, pool.buf_k, pool.buf_v, dev_in[0], ids(b, k),
                        dev_in[2], *samp, scratch, self._H, self._eps)
                    done("verify", b, ys)
            del pool
        return n

    def warm_up(self) -> None:
        t0 = time.perf_counter()
        n = 0
        with self._cv:
            warming_devices = [w.device for w in self._workers
                               if w.state == "warming"]
        done_devices = set()
        for device in warming_devices:
            devk = self._device_key(device)
            if devk not in done_devices:
                n += self._warm_device(device)
                done_devices.add(devk)
        with self._cv:
            for w in self._workers:
                if w.state == "warming":
                    w.state = "active"
            self._cv.notify_all()
            warmed_count = len(self._warmed)
            n_workers = len(self._workers)
        self.warmup_report = {
            "time_s": round(time.perf_counter() - t0, 3),
            "programs": warmed_count,
            "warm_passes": n,
            "replicas": n_workers,
            "prefill_buckets": list(self._prompt_boundaries),
            "decode_batch_buckets": list(self._batch_buckets),
            "max_context": self._max_ctx,
            "kv_dtype": self._kv_dtype,
            "quantize_weights": self._quant_w,
            "kv_pool_bytes": self.kv_pool_bytes(),
        }

    # --------------------------------------------------------- lifecycle --
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        with self._cv:
            cold = [w for w in self._workers if w.thread is None]
        for w in cold:
            self._start_worker(w)

    def _start_worker(self, w: ReplicaSlot,
                      gen: Optional[int] = None) -> None:
        with self._cv:
            if gen is None:
                gen = w.generation
            t = threading.Thread(target=self._worker_loop, args=(w, gen),
                                 name=f"generate-worker-{w.rid}",
                                 daemon=True)
            w.thread = t
        t.start()

    def shutdown(self, drain: bool = True, timeout: float = 60.0,
                 migrate: bool = False) -> None:
        """Stop the engine. drain=True finishes in-flight work first;
        drain=False fails the queued requests with 503 and requeues (and
        so fails) the in-flight ones. migrate=True (with drain) exports
        every in-flight streamed row as a KV-handoff payload, ending its
        stream with ('handoff', payload) for another host to import;
        rows not yet streamed decode to the end here (their callers hold
        a result, not a stream to splice)."""
        with self._cv:
            if self._shut:
                return
            self._shut = True
            self._closing = True
            if drain and migrate:
                self._migrate_streams = True
            if not drain:
                self._abort = True
                while self._queue:
                    r = self._queue.popleft()
                    err = ServingError(503, "server shutting down",
                                       retry_after=_RETRY_AFTER_S)
                    if r.future.set_error(err):
                        r.stream.put(("err", err))
            self._cv.notify_all()
        if not self._started:
            self.start()
        with self._cv:
            threads = [w.thread for w in self._workers if w.thread]
        for t in threads:
            t.join(timeout)
        # stragglers that raced the last worker's exit
        with self._cv:
            stranded = list(self._queue)
            self._queue.clear()
        n = 0
        for r in stranded:
            err = ServingError(503, "server shutting down",
                               retry_after=_RETRY_AFTER_S)
            if r.future.set_error(err):
                r.stream.put(("err", err))
                n += 1
        if n:
            self.metrics.on_failed(n)

    def health(self) -> dict:
        with self._cv:
            states = [w.state for w in self._workers]
            return {
                "status": "draining" if self._closing else "ok",
                "replicas": states.count("active"),
                "replica_states": {s: states.count(s)
                                   for s in set(states)},
                "queue_depth": len(self._queue),
                "prefill_buckets": list(self._prompt_boundaries),
                "decode_batch_buckets": list(self._batch_buckets),
                # the reference's capacity classes: one, at max_context
                "kv_classes": [self._max_ctx],
                "kv_dtype": self._kv_dtype,
                "quantize_weights": self._quant_w,
                "warmed_executables": len(self._warmed),
            }

    def load_report(self) -> dict:
        """Few-field load digest: queue depth, replicas, tokens/s, the
        slots in use, the free and total slots of the one capacity class
        ("kv") and a bounded prefix-cache residency digest ("prefix", at
        most 32 "F:hash8" keys), from the lock-protected host-side
        mirrors (no device sync)."""
        util = self._kv_utilization()
        with self._cv:
            depth = len(self._queue)
            replicas = sum(1 for w in self._workers
                           if w.state == "active")
            draining = self._closing
            digest = set().union(*self._pc_index.values())
        return {
            "queue_depth": depth,
            "replicas": replicas,
            "tokens_per_s": round(self.metrics.tokens_per_s(), 3),
            "kv_slots_used": util["slots_used"],
            "status": "draining" if draining else "ok",
            "kv": {str(self._max_ctx): {
                "free": max(util["slots_total"] - util["slots_used"], 0),
                "slots": util["slots_total"]}},
            "prefix": sorted(digest)[:_PREFIX_DIGEST_MAX],
        }

    # ------------------------------------------------------------ submit --
    def _retry_after(self) -> float:
        depth = len(self._queue)
        tps = self.metrics.tokens_per_s()
        if depth <= 0 or tps <= 0.0:
            return _RETRY_AFTER_S
        # rough drain estimate: backlog * expected tokens per request
        per_req = max(self.metrics.tokens_out_total /
                      max(self.metrics.completed_total, 1), 1.0)
        est = depth * per_req / tps
        return min(max(est, _RETRY_AFTER_S), _RETRY_AFTER_MAX_S)

    def _decode_request(self, input_ids, max_new_tokens, eos_token_id,
                        deadline_ms, temperature=None, top_k=None,
                        top_p=None, seed=None) -> _GenRequest:
        try:
            samp = validate_sampling({"temperature": temperature,
                                      "top_k": top_k, "top_p": top_p,
                                      "seed": seed})
        except ServingError:
            self.metrics.on_reject("sampling")
            raise
        try:
            prompt = np.asarray(input_ids)
            if prompt.ndim == 2 and prompt.shape[0] == 1:
                prompt = prompt[0]
            prompt = prompt.astype(np.int64, casting="same_kind")
        except (TypeError, ValueError) as e:
            self.metrics.on_reject("decode")
            raise ServingError(400, f"bad input_ids: {e}") from None
        if prompt.ndim != 1 or prompt.size < 1:
            self.metrics.on_reject("shape")
            raise ServingError(
                400, f"input_ids must be a non-empty 1-D id sequence "
                     f"(got shape {tuple(prompt.shape)})")
        if int(prompt.min()) < 0 or int(prompt.max()) >= self._vocab:
            self.metrics.on_reject("vocab")
            raise ServingError(
                400, f"input_ids out of range [0, {self._vocab})")
        P = int(prompt.size)
        cap = self._max_ctx
        if P > cap - 1:
            self.metrics.on_reject("too_long")
            raise ServingError(
                400, f"prompt length {P} exceeds the usable context "
                     f"{cap - 1} (KV slot {cap} minus one generated "
                     f"token)")
        try:
            want = int(max_new_tokens) if max_new_tokens is not None \
                else self._max_new_cap
            eos = None if eos_token_id is None else int(eos_token_id)
            dl_s = float(deadline_ms) / 1e3 \
                if deadline_ms is not None and float(deadline_ms) > 0 \
                else None
        except (TypeError, ValueError) as e:
            self.metrics.on_reject("decode")
            raise ServingError(
                400, f"bad generation parameters: {e}") from None
        if want < 1:
            self.metrics.on_reject("decode")
            raise ServingError(
                400, f"max_new_tokens must be >= 1 (got {want})")
        max_new = max(1, min(want, self._max_new_cap, cap - P))
        deadline = time.monotonic() + dl_s if dl_s is not None else None
        return _GenRequest(np.ascontiguousarray(prompt), max_new, eos,
                           deadline, **self._sampling(samp))

    def _sampling(self, samp: dict) -> dict:
        """validate_sampling's fields with their defaults: greedy, top_k
        the vocab (clamped to it), top_p 1, seed 0."""
        tk = samp["top_k"]
        return {"temperature": samp["temperature"]
                if samp["temperature"] is not None else 0.0,
                "top_k": min(tk, self._vocab) if tk is not None
                else self._vocab,
                "top_p": samp["top_p"] if samp["top_p"] is not None
                else 1.0,
                "seed": samp["seed"] if samp["seed"] is not None else 0}

    def _shed_check_locked(self, bound: int) -> None:
        if self._closing:
            raise ServingError(503, "server shutting down",
                               retry_after=_RETRY_AFTER_S)
        if len(self._queue) >= bound:
            self.metrics.on_shed()
            raise ServingError(
                503, f"generation queue depth {len(self._queue)} at "
                     f"bound {bound} — load shed",
                retry_after=self._retry_after())

    def submit(self, input_ids, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               prefill_only: bool = False,
               resume_from: int = 0) -> GenerateHandle:
        """Enqueue one generation; returns its streaming handle. Raises
        ServingError for decode rejects (400) and load shedding (503).

        `prefill_only` fills a KV slot, samples the first token and
        finishes with the exported handoff payload (finish_reason
        "handoff", the payload as base64 under "handoff") in place of
        decoding here. `resume_from=n` is the replay resume: the client
        already holds n tokens, so the regenerated stream (the same key
        chain, so the same tokens) emits only those after them."""
        bound = self._max_queue_depth
        # lock-free fast path (a GIL-atomic len); re-checked under _cv
        if self._closing or len(self._queue) >= bound:
            with self._cv:
                self._shed_check_locked(bound)
        with _tr.span("generate.enqueue", "serving") as sp:
            req = self._decode_request(input_ids, max_new_tokens,
                                       eos_token_id, deadline_ms,
                                       temperature, top_k, top_p, seed)
            req.prefill_only = bool(prefill_only)
            if resume_from:
                try:
                    rf = int(resume_from)
                except (TypeError, ValueError):
                    rf = -1
                if rf < 0:
                    self.metrics.on_reject("decode")
                    raise ServingError(
                        400, f"bad resume_from: {resume_from!r}")
                req.streamed = min(rf, req.max_new)
            req.ctx = sp.ctx
            sp.set(prompt_tokens=int(req.prompt.size),
                   max_new=req.max_new)
            self._enqueue(req, bound)
        return GenerateHandle(req)

    def _enqueue(self, req: _GenRequest, bound: int) -> None:
        with self._cv:
            self._shed_check_locked(bound)
            self._queue.append(req)
            self.metrics.on_accept()
            self._cv.notify_all()

    def import_handoff(self, raw: bytes) -> GenerateHandle:
        """Admit one exported KV slot (fabric/handoff.py's wire format,
        from this package's engine or the reference's). The payload's
        kv_dtype and geometry must be this engine's, and its cap this
        engine's one class, max_context: 409 otherwise; a malformed
        payload, a missing or misshapen array or an out-of-vocabulary
        token is 400, a full queue 503, all before any slot is taken.
        The request queues carrying its payload; the worker that admits
        it scatters the row into a free slot and decodes on from the
        payload's key-chain cursor, emitting only the tokens past
        meta["streamed"]."""
        def refuse(status, msg):
            self.metrics.on_reject("handoff")
            return ServingError(status, msg)

        try:
            meta, arrays = _ho.decode(raw)
        except ValueError as e:
            raise refuse(400, f"bad handoff payload: {e}") from None
        try:
            cap = int(meta["cap"])
            dtype = str(meta["kv_dtype"])
            shape = [int(d) for d in meta["shape"]]
            length = int(meta["length"])
            tokens = [int(t) for t in meta["tokens"]]
            streamed = int(meta["streamed"])
            max_new = int(meta["max_new"])
            eos = meta.get("eos")
            eos = None if eos is None else int(eos)
        except (KeyError, TypeError, ValueError) as e:
            raise refuse(400, f"bad handoff meta: {e!r}"[:300]) from None
        if dtype != self._kv_dtype:
            raise refuse(409, f"handoff kv_dtype {dtype!r} != engine "
                              f"{self._kv_dtype!r}")
        geometry = [self._L, self._max_ctx, self._H, self._Dh]
        if cap != self._max_ctx or shape != geometry:
            raise refuse(409, f"handoff geometry cap={cap} shape={shape} "
                              f"does not match this engine (cap "
                              f"{self._max_ctx}, shape {geometry})")
        want = {"prompt", "key", "k", "v"}
        row_dt = "float32"
        if self._kv_dtype == "int8":
            want |= {"k_scale", "v_scale"}
            row_dt = "int8"
        if set(arrays) != want:
            raise refuse(400, f"handoff arrays {sorted(arrays)} != "
                              f"{sorted(want)}")
        bad = any(arrays[nm].shape != tuple(shape) or
                  arrays[nm].dtype.name != row_dt for nm in ("k", "v"))
        if self._kv_dtype == "int8":
            bad = bad or any(arrays[nm].shape != (self._L,) or
                             arrays[nm].dtype.name != "float32"
                             for nm in ("k_scale", "v_scale"))
        prompt = arrays["prompt"]
        P = int(prompt.size)
        bad = bad or prompt.ndim != 1 or P < 1 or \
            prompt.dtype.name != "int32" or \
            arrays["key"].shape != (2,) or \
            arrays["key"].dtype.name != "uint32"
        if not bad:
            bad = int(prompt.min()) < 0 or \
                int(prompt.max()) >= self._vocab or \
                not (1 <= len(tokens) <= max_new) or \
                not (0 <= streamed <= len(tokens)) or \
                length != P + len(tokens) - 1 or length >= cap or \
                any(not (0 <= t < self._vocab) for t in tokens)
        if bad:
            raise refuse(400, "handoff arrays fail validation")
        try:
            samp = validate_sampling(
                {"temperature": meta.get("temperature"),
                 "top_k": meta.get("top_k"), "top_p": meta.get("top_p"),
                 "seed": meta.get("seed")})
        except ServingError:
            self.metrics.on_reject("sampling")
            raise
        req = _GenRequest(np.ascontiguousarray(prompt, dtype=np.int64),
                          max_new, eos, None, **self._sampling(samp))
        req.requeues = int(meta.get("requeues", 0))
        req.streamed = streamed
        req.handoff = (meta, arrays)
        with _tr.span("generate.import", "serving") as sp:
            req.ctx = sp.ctx
            sp.set(prompt_tokens=P, length=length)
            self._enqueue(req, self._max_queue_depth)
        self.metrics.on_handoff_in(len(raw))
        return GenerateHandle(req)

    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = 120.0,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None) -> dict:
        """Synchronous submit + wait; returns the result dict."""
        return self.submit(input_ids, max_new_tokens, eos_token_id,
                           deadline_ms, temperature, top_k, top_p,
                           seed).result(timeout)

    def stream(self, input_ids, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None):
        """Submit and iterate tokens as they are generated."""
        return iter(self.submit(input_ids, max_new_tokens, eos_token_id,
                                deadline_ms, temperature, top_k, top_p,
                                seed))

    # ---------------------------------------------------------- scheduler --
    def _admit_locked(self, w: ReplicaSlot, gen: int,
                      pool: _PoolState) -> List[tuple]:
        """Pop queued requests into free slots, in order (caller holds
        _cv). Expired requests 503 out; owner and slot markers are set
        here so a supersede racing the prefill sees them and requeues."""
        admitted = []
        now = time.monotonic()
        while self._queue and pool.free:
            req = self._queue.popleft()
            if req.deadline is not None and now > req.deadline and \
                    req.streamed == 0:
                err = ServingError(503, "deadline exceeded while queued",
                                   retry_after=_RETRY_AFTER_S)
                if req.future.set_error(err):
                    req.stream.put(("err", err))
                    self.metrics.on_failed(1)
                continue
            slot = pool.free.pop()
            req.owner = (w.rid, gen)
            w.inflight.append(req)
            self._live_rows.setdefault(w.rid, {})[slot] = \
                int(req.prompt.size)
            admitted.append((req, slot))
        return admitted

    def _emit(self, w: ReplicaSlot, gen: int, req: _GenRequest,
              tok: int) -> str:
        """Record one generated token under the lock, owner-checked (a
        zombie that unwedges after a revive must not touch the stream
        its replacement now owns). Returns 'dead' | 'live' | 'done'."""
        with self._cv:
            if w.generation != gen or req.owner != (w.rid, gen) or \
                    req.future.done():
                return "dead"
            req.tokens.append(int(tok))
            fresh = len(req.tokens) > req.streamed
            if fresh:
                req.streamed = len(req.tokens)
                if req.t_first is None:
                    req.t_first = time.monotonic()
                    self.metrics.on_first_token(
                        req.t_first - req.t_enqueue)
                req.stream.put(("tok", int(tok)))
        if fresh:
            self.metrics.on_tokens(1)
            if _tr.enabled():
                now_ns = time.perf_counter_ns()
                _tr.emit_span("generate.token", now_ns, now_ns,
                              parent=req.ctx, cat="serving",
                              args={"index": len(req.tokens),
                                    "token": int(tok)})
        done = (len(req.tokens) >= req.max_new or
                (req.eos is not None and int(tok) == req.eos))
        return "done" if done else "live"

    def _release_locked(self, w: ReplicaSlot, pool: _PoolState, slot: int,
                        req: _GenRequest) -> None:
        """Free `slot` and drop its row from the worker's tables (caller
        holds _cv)."""
        pool.rows.pop(slot, None)
        pool.free.append(slot)
        rows = self._live_rows.get(w.rid)
        if rows is not None:
            rows.pop(slot, None)
        if req in w.inflight:
            w.inflight.remove(req)
        req.owner = None

    def _result_info(self, req: _GenRequest, reason: str,
                     done: float) -> dict:
        return {
            "tokens": list(req.tokens),
            "n_tokens": len(req.tokens),
            "prompt_tokens": int(req.prompt.size),
            "finish_reason": reason,
            "ttft_ms": round((req.t_first - req.t_enqueue) * 1e3, 3)
            if req.t_first is not None else None,
            "latency_ms": round((done - req.t_enqueue) * 1e3, 3),
        }

    def _finish(self, w: ReplicaSlot, gen: int, pool: _PoolState,
                slot: int, req: _GenRequest, reason: str,
                extra: Optional[dict] = None) -> None:
        done = time.monotonic()
        with self._cv:
            self._release_locked(w, pool, slot, req)
        info = self._result_info(req, reason, done)
        if extra:
            info.update(extra)
        if req.future.set_result(info):
            self.metrics.on_complete(done - req.t_enqueue)
            req.stream.put(("done", info))
        if _tr.enabled():
            _tr.emit_span("generate.finish", req.t_enq_ns,
                          time.perf_counter_ns(), parent=req.ctx,
                          cat="serving",
                          args={"n_tokens": len(req.tokens),
                                "reason": reason})

    def _fail_rows(self, w: ReplicaSlot, gen: int,
                   pool: _PoolState) -> None:
        """A failure mid-step: every in-flight row of this worker
        requeues (one charged strike each; a second strike 503s) onto
        fresh buffers and an empty prefix cache: re-prefill is the
        recovery, and the new pool cannot leak a poisoned slot into the
        next batch."""
        with self._cv:
            stuck = list(w.inflight)
            w.inflight = []
            for req in stuck:
                req.owner = None
            self._live_rows.pop(w.rid, None)
            self._pc_index.pop(w.rid, None)
            # free the old buffers before the new ones are allocated
            pool.reset((None,) * 4)
        bufs = self._alloc_bufs(w.device)
        with self._cv:
            pool.reset(bufs)
        self._requeue(stuck)

    def _update_liveness_locked(self, w, pool):
        rows = self._live_rows.setdefault(w.rid, {})
        rows.clear()
        for slot, row in pool.rows.items():
            rows[slot] = row.length

    def _begin_call_locked(self, w: ReplicaSlot, gen: int,
                           keys: List[tuple]) -> bool:
        """Mark the worker busy for one scheduler call (caller holds
        _cv); count each of its programs not yet run on this device.
        False when the worker was superseded."""
        if w.generation != gen:
            return False
        w.busy_since = time.monotonic()
        self._cold_calls += sum(int(k not in self._warmed) for k in keys)
        return True

    def _end_call(self, w: ReplicaSlot, gen: int,
                  keys: List[tuple]) -> None:
        with self._cv:
            if w.generation == gen:
                w.busy_since = None
            if keys[-1][1] in ("decode", "verify"):
                w.batches += 1
            self._warmed.update(keys)

    def _probe_prefix_locked(self, pool: _PoolState, req: _GenRequest):
        """The prefix-cache probe (caller holds _cv): the longest cached
        boundary below the prompt wins (F < P always: the tail samples
        the first token), and the longest uncached boundary longer than
        the hit is admitted on the way out. Returns (hit length, hit row,
        admit length, admit hash), each None where there is none."""
        P = int(req.prompt.size)
        hit_f = hit_row = admit_f = admit_h = None
        for F in reversed(self._prompt_boundaries):
            if F >= P:
                continue
            h = _prefix_hash(req.prompt, F)
            row = pool.pcache.get((F, h))
            if row is not None:
                hit_f, hit_row = F, row
                pool.pcache.move_to_end((F, h))
                break
            if admit_f is None:
                admit_f, admit_h = F, h
        return hit_f, hit_row, admit_f, admit_h

    def _admit_prefix(self, w: ReplicaSlot, pool: _PoolState, slot: int,
                      F: int, h: str) -> None:
        """Copy the prompt's first F positions (the whole of row `slot`)
        into a cache row, evicting the least recently used one when the
        cache is full; the worker's residency digest follows."""
        with self._cv:
            idx = self._pc_index.setdefault(w.rid, set())
            evict = not pool.pc_free
            if evict:
                (ev_f, ev_h), crow = pool.pcache.popitem(last=False)
                idx.discard(f"{ev_f}:{ev_h[:8]}")
            else:
                crow = pool.pc_free.pop()
            pool.pcache[(F, h)] = crow
            idx.add(f"{F}:{h[:8]}")
        pool.buf_k, pool.buf_v = _copy_row_body(pool.buf_k, pool.buf_v,
                                                slot, crow)
        if evict:
            self.metrics.on_prefix_evict()

    def _prefill_one(self, w: ReplicaSlot, gen: int, pool: _PoolState,
                     slot: int, req: _GenRequest) -> None:
        P = int(req.prompt.size)
        S = bucket_for(P, self._prompt_boundaries)
        devk = self._device_key(w.device)
        dev = w.device
        samp = (req.temperature, req.top_k, req.top_p)
        key0 = _rng.key(req.seed)
        hit_f = hit_row = admit_f = admit_h = None
        if pool.pc_slots:
            with self._cv:
                hit_f, hit_row, admit_f, admit_h = \
                    self._probe_prefix_locked(pool, req)
        T = bucket_for(P - hit_f, self._prompt_boundaries) \
            if hit_f is not None else None
        keys = [(devk, "pcopy", 1), (devk, "extend", T)] \
            if hit_f is not None else [(devk, "prefill", S)]
        if self._spec:
            keys.append((devk, "dprefill", S))
        if admit_f is not None:
            keys.append((devk, "pcopy", 1))
        args = None
        if _tr.enabled():
            args = {"replica": w.rid, "bucket": S, "prompt_tokens": P,
                    "prefix_hit": hit_f or 0}
        with self._cv:
            if not self._begin_call_locked(w, gen, keys):
                return
        t0 = time.perf_counter()
        try:
            with _tr.span("generate.prefill", "serving", args,
                          parent=req.ctx):
                p = self._params_for(dev)
                if hit_f is not None:
                    pool.buf_k, pool.buf_v = _copy_row_body(
                        pool.buf_k, pool.buf_v, hit_row, slot)
                    ids = np.zeros((1, T), np.int64)
                    ids[0, :P - hit_f] = req.prompt[hit_f:]
                    tok, kcar, pool.buf_k, pool.buf_v = _extend_body(
                        p, pool.buf_k, pool.buf_v, slot,
                        torch.from_numpy(ids).to(dev), hit_f, P, *samp,
                        key0, self._slots, self._H, self._eps)
                else:
                    ids = np.zeros((1, S), np.int64)
                    ids[0, :P] = req.prompt
                    tok, kcar, pool.buf_k, pool.buf_v = _prefill_body(
                        p, pool.buf_k, pool.buf_v, slot,
                        torch.from_numpy(ids).to(dev), P, *samp, key0,
                        self._H, self._eps)
                if self._spec:
                    # the draft has no prefix cache: it prefills the
                    # whole prompt into its own pool
                    dids = np.zeros((1, S), np.int64)
                    dids[0, :P] = req.prompt
                    _, _, pool.dbuf_k, pool.dbuf_v = _prefill_body(
                        self._draft_params_for(dev), pool.dbuf_k,
                        pool.dbuf_v, slot, torch.from_numpy(dids).to(dev),
                        P, 0.0, 1, 1.0, key0, self._dH, self._deps)
                if admit_f is not None:
                    self._admit_prefix(w, pool, slot, admit_f, admit_h)
                tok = int(tok)
        finally:
            self._end_call(w, gen, keys)
        if hit_f is None:
            self.metrics.on_prefill(P, S, time.perf_counter() - t0)
        else:
            self.metrics.on_prefill(P - hit_f, T, time.perf_counter() - t0,
                                    kind="extend")
        if pool.pc_slots:
            self.metrics.on_prefix(hit_f is not None, hit_f or 0)
        status = self._emit(w, gen, req, tok)
        if status == "dead":
            return
        with self._cv:
            if w.generation != gen:
                return
            pool.rows[slot] = _Row(req, slot, P, kcar)
            self._update_liveness_locked(w, pool)
        if status == "done":
            self._finish(w, gen, pool, slot, req, "eos"
                         if req.eos is not None and tok == req.eos
                         else "length")
        elif req.prefill_only:
            # the slot is filled and the first token sampled: export it
            # for a decode host. streamed=0 in the payload: the client has
            # seen no token (this result is the handoff), so the importer
            # emits the first token as new
            raw = self._export_row(w, gen, pool, slot, streamed=0)
            if raw is not None:
                self.metrics.on_handoff_out(len(raw))
                self._finish(w, gen, pool, slot, req, "handoff",
                             extra={"handoff": _ho.to_b64(raw)})

    def _decode_step(self, w: ReplicaSlot, gen: int,
                     pool: _PoolState) -> None:
        with self._cv:
            if w.generation != gen:
                return
            rows = [pool.rows[s] for s in sorted(pool.rows)]
        if not rows:
            return
        n = len(rows)
        bucket = bucket_for(n, self._batch_buckets)
        scratch = self._slots    # the +1 row: padding lands there
        spec, k = self._spec, self._spec_k
        slots = np.full((bucket,), scratch, np.int64)
        toks = np.zeros((bucket,), np.int64)
        lens = np.zeros((bucket,), np.int64)
        # the sampling values and keys stay on the host (a padding row is
        # greedy with a zero key)
        temps = torch.zeros(bucket)
        topks = torch.ones(bucket, dtype=torch.int64)
        topps = torch.ones(bucket)
        keys = torch.zeros(bucket, 2, dtype=torch.int64)
        for i, row in enumerate(rows):
            slots[i] = row.slot
            toks[i] = row.req.tokens[-1]
            lens[i] = row.length
            temps[i] = row.req.temperature
            topks[i] = row.req.top_k
            topps[i] = row.req.top_p
            keys[i] = row.key
        samp = (temps, topks, topps, keys)
        devk = self._device_key(w.device)
        prog_keys = [(devk, "dpropose", bucket), (devk, "verify", bucket)] \
            if spec else [(devk, "decode", bucket)]
        args = None
        if _tr.enabled():
            args = {"replica": w.rid, "rows": n, "bucket": bucket,
                    "spec_k": k if spec else 0,
                    "traces": [r.req.ctx.trace_id for r in rows
                               if r.req.ctx is not None]}
        with self._cv:
            if not self._begin_call_locked(w, gen, prog_keys):
                return
        t0 = time.perf_counter()
        try:
            # hang/raise injection: a `delay` rule wedges this worker
            # mid-decode as a stuck device would, a `raise` rule takes
            # the requeue ladder; the context scopes a rule to one worker
            # incarnation
            _chaos.hit("serving.decode_step", replica=w.rid,
                       generation=gen)
            with _tr.span("generate.decode_step", "serving", args,
                          parent=rows[0].req.ctx):
                dev = w.device
                slots_d = torch.from_numpy(slots).to(dev)
                toks_d = torch.from_numpy(toks).to(dev)
                lens_d = torch.from_numpy(lens).to(dev)
                if spec:
                    # one k-step draft burst; the draft pool advances
                    # through all k inputs so that a full accept finds
                    # every position it needs next time
                    props, pool.dbuf_k, pool.dbuf_v = _propose_body(
                        self._draft_params_for(dev), pool.dbuf_k,
                        pool.dbuf_v, slots_d, toks_d, lens_d, k, scratch,
                        self._dH, self._deps)
                    tok_mat = torch.cat([toks_d[:, None],
                                         props[:, :k - 1]], 1)
                    ys, khist, pool.buf_k, pool.buf_v = _verify_body(
                        self._params_for(dev), pool.buf_k, pool.buf_v,
                        slots_d, tok_mat, lens_d, *samp, scratch, self._H,
                        self._eps)
                    props = props.cpu().numpy()        # [bucket, k]
                    ys = ys.cpu().numpy()              # [bucket, k]
                else:
                    nxt, nkeys, pool.buf_k, pool.buf_v = _decode_body(
                        self._params_for(dev), pool.buf_k, pool.buf_v,
                        slots_d, toks_d, lens_d, *samp, scratch, self._H,
                        self._eps)
                    nxt = nxt.cpu().numpy()
        finally:
            self._end_call(w, gen, prog_keys)
        self.metrics.on_step(n, bucket, time.perf_counter() - t0)
        if spec:
            # accept the longest agreed prefix of each row: ys[i, j] is
            # the target's own token at position j (plain decode's key
            # chain), valid while every earlier proposal matched; a
            # rejection still yields ys[i, m-1] (>= 1 token a burst)
            ms = []
            for i in range(n):
                m = 1
                while m < k and props[i, m - 1] == ys[i, m - 1]:
                    m += 1
                ms.append(m)
            self.metrics.on_spec_step(proposed=n * (k - 1),
                                      accepted=sum(m - 1 for m in ms))
            emitted = [ys[i, :ms[i]] for i in range(n)]
            new_keys = [khist[i, ms[i] - 1] for i in range(n)]
        else:
            ms = [1] * n
            emitted = [nxt[i:i + 1] for i in range(n)]
            new_keys = [nkeys[i] for i in range(n)]
        with self._cv:
            if w.generation != gen:
                return
            for i, row in enumerate(rows):
                row.length += ms[i]
                row.key = new_keys[i].clone()
            self._update_liveness_locked(w, pool)
        finished = []
        for i, row in enumerate(rows):
            for tok in emitted[i]:
                status = self._emit(w, gen, row.req, int(tok))
                if status == "dead":
                    return
                if status == "done":
                    finished.append(row)
                    break
        for row in finished:
            self._finish(w, gen, pool, row.slot, row.req,
                         "eos" if row.req.eos is not None and
                         row.req.tokens[-1] == row.req.eos else "length")

    # ------------------------------------------------------------ handoff --
    def _export_row(self, w: ReplicaSlot, gen: int, pool: _PoolState,
                    slot: int,
                    streamed: Optional[int] = None) -> Optional[bytes]:
        """One live row's decode state as a handoff payload: the pool row
        pair raw in its stored dtype (`_kvget_body`) and the metadata
        that continues it bitwise. On the owning worker's thread, outside
        the engine lock. None when the row is gone (a supersede)."""
        keys = [(self._device_key(w.device), "kvget", 1)]
        with self._cv:
            row = pool.rows.get(slot)
            if row is None or row.req.owner != (w.rid, gen) or \
                    not self._begin_call_locked(w, gen, keys):
                return None
            req = row.req
            length = int(row.length)
            # int64 words holding uint32 values: the reference's key
            key = row.key.numpy().astype(np.uint32)
            tokens = [int(t) for t in req.tokens]
            sent = int(req.streamed if streamed is None else streamed)
        P = int(req.prompt.size)
        lineage = [[F, _prefix_hash(req.prompt, F)]
                   for F in reversed(self._prompt_boundaries) if F < P][:1]
        meta = {"cap": self._max_ctx, "kv_dtype": self._kv_dtype,
                "shape": [self._L, self._max_ctx, self._H, self._Dh],
                "length": length, "tokens": tokens, "streamed": sent,
                "max_new": int(req.max_new),
                "eos": None if req.eos is None else int(req.eos),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k), "top_p": float(req.top_p),
                "seed": int(req.seed), "requeues": int(req.requeues),
                "lineage": lineage}
        with _tr.span("generate.kv_export", "serving", parent=req.ctx):
            try:
                kd, ks, vd, vs = _kvget_body(pool.buf_k, pool.buf_v, slot)
            finally:
                self._end_call(w, gen, keys)
            arrays = {"prompt": req.prompt.astype(np.int32), "key": key,
                      "k": kd, "v": vd}
            if ks is not None:
                arrays["k_scale"] = ks
                arrays["v_scale"] = vs
            return _ho.encode(meta, arrays)

    def _import_one(self, w: ReplicaSlot, gen: int, pool: _PoolState,
                    slot: int, req: _GenRequest) -> None:
        """Install an imported payload in pool slot `slot` (the twin of
        `_prefill_one`): the raw row through `_kvput_body`, the row's key
        from the payload; with a draft, the draft's pool rebuilt by its
        prefill over the generated history (the draft never travels);
        the payload's prefix lineage admitted into the local cache. The
        tokens past meta["streamed"] are emitted as new."""
        meta, arrays = req.handoff
        P = int(req.prompt.size)
        length = int(meta["length"])
        toks = [int(t) for t in meta["tokens"]]
        devk = self._device_key(w.device)
        dev = w.device
        admit_f = admit_h = None
        if pool.pc_slots:
            with self._cv:
                for ent in meta.get("lineage") or ():
                    try:
                        F, h = int(ent[0]), str(ent[1])
                    except (TypeError, ValueError, IndexError):
                        continue
                    if F in self._prompt_boundaries and F < P and \
                            (F, h) not in pool.pcache:
                        admit_f, admit_h = F, h
                        break
        keys = [(devk, "kvput", 1)]
        S = bucket_for(length, self._prompt_boundaries) if self._spec \
            else 0
        if self._spec:
            keys.append((devk, "dprefill", S))
        if admit_f is not None:
            keys.append((devk, "pcopy", 1))
        args = None
        if _tr.enabled():
            args = {"replica": w.rid, "length": length,
                    "tokens": len(toks)}
        with self._cv:
            if not self._begin_call_locked(w, gen, keys):
                return
        try:
            with _tr.span("generate.kv_import", "serving", args,
                          parent=req.ctx):
                put = [None if nm not in arrays else
                       torch.from_numpy(np.array(arrays[nm])).to(dev)
                       for nm in ("k", "k_scale", "v", "v_scale")]
                pool.buf_k, pool.buf_v = _kvput_body(
                    pool.buf_k, pool.buf_v, slot, *put)
                if self._spec:
                    # the prompt and every token but the pending one
                    hist = np.zeros((1, S), np.int64)
                    hist[0, :P] = req.prompt
                    hist[0, P:length] = toks[:-1]
                    _, _, pool.dbuf_k, pool.dbuf_v = _prefill_body(
                        self._draft_params_for(dev), pool.dbuf_k,
                        pool.dbuf_v, slot, torch.from_numpy(hist).to(dev),
                        length, 0.0, 1, 1.0,
                        torch.zeros(2, dtype=torch.int64), self._dH,
                        self._deps)
                if admit_f is not None:
                    self._admit_prefix(w, pool, slot, admit_f, admit_h)
        finally:
            self._end_call(w, gen, keys)
        with self._cv:
            if w.generation != gen or req.owner != (w.rid, gen) or \
                    req.future.done():
                return
            req.handoff = None
            # re-emit what the exporter had not delivered: a prefill
            # handoff records streamed=0 (the client saw nothing), a
            # migration the delivered count (nothing re-emits)
            pending = toks[req.streamed:]
            req.tokens = toks[:req.streamed]
            pool.rows[slot] = _Row(req, slot, length, torch.from_numpy(
                arrays["key"].astype(np.int64)))
            self._update_liveness_locked(w, pool)
        status = "live"
        for t in pending:
            status = self._emit(w, gen, req, t)
            if status == "dead":
                return
            if status == "done":
                break
        if status == "done":
            self._finish(w, gen, pool, slot, req,
                         "eos" if req.eos is not None and
                         req.tokens[-1] == req.eos else "length")

    def _migrate_rows(self, w: ReplicaSlot, gen: int,
                      pool: _PoolState) -> None:
        """The migrating drain's sweep: export every in-flight streamed
        row and end its stream with ('handoff', {"handoff", "streamed",
        "n_tokens"}) for another host to import. The stream queue is
        FIFO, so every counted token went out before the handoff line
        and the importer emits none again. Rows not yet streamed decode
        to the end here."""
        with self._cv:
            if w.generation != gen:
                return
            victims = [s for s, row in pool.rows.items()
                       if row.req.streamed > 0 and not row.req.prefill_only]
        for slot in victims:
            with self._cv:
                row = pool.rows.get(slot)
            if row is None:
                continue
            req = row.req
            raw = self._export_row(w, gen, pool, slot)
            if raw is None:
                continue
            self.metrics.on_handoff_out(len(raw), migrated=True)
            done = time.monotonic()
            obj = {"handoff": _ho.to_b64(raw),
                   "streamed": int(req.streamed),
                   "n_tokens": len(req.tokens)}
            with self._cv:
                self._release_locked(w, pool, slot, req)
            info = self._result_info(req, "migrated", done)
            info["handoff"] = obj["handoff"]
            if req.future.set_result(info):
                req.stream.put(("handoff", obj))
            if _tr.enabled():
                _tr.emit_span("generate.migrate", req.t_enq_ns,
                              time.perf_counter_ns(), parent=req.ctx,
                              cat="serving",
                              args={"n_tokens": len(req.tokens)})

    def _worker_loop(self, w: ReplicaSlot, gen: int) -> None:
        # grad mode is thread-local: the caller's no_grad or
        # inference_mode does not reach this thread
        with torch.inference_mode(), self._device_ctx(w.device):
            self._serve(w, gen)

    def _serve(self, w: ReplicaSlot, gen: int) -> None:
        # per-generation device state: a revived worker starts from a
        # fresh zeroed pool; the zombie's buffers die with its frame
        pool = self._alloc_pool(w.device)
        while True:
            with self._cv:
                if w.generation != gen:
                    return
                w.last_beat = time.monotonic()
                admit_ok = w.state == "active" and not self._abort
                admitted = self._admit_locked(w, gen, pool) \
                    if admit_ok else []
            try:
                for req, slot in admitted:
                    if req.handoff is not None:
                        self._import_one(w, gen, pool, slot, req)
                    else:
                        self._prefill_one(w, gen, pool, slot, req)
                with self._cv:
                    migrating = self._migrate_streams and \
                        w.generation == gen
                if migrating:
                    self._migrate_rows(w, gen, pool)
                if not pool.rows:
                    with self._cv:
                        if w.generation != gen:
                            return
                        queue_live = bool(self._queue) and not self._abort
                        if w.state in ("draining", "retired") or \
                                (self._closing and not queue_live):
                            w.state = "retired"
                            self._cv.notify_all()
                            return
                        if not queue_live:
                            self._cv.wait(0.05)
                    continue
                with self._cv:
                    aborting = self._abort
                if aborting:
                    self._fail_rows(w, gen, pool)
                    continue
                self._decode_step(w, gen, pool)
            except Exception:  # noqa: BLE001 — the worker thread must
                # never die (its slots would leak and the queue would
                # starve): requeue the in-flight sequences, keep serving
                with self._cv:
                    owned = w.generation == gen
                if owned:
                    self._fail_rows(w, gen, pool)


__all__ = ["GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "stack_gpt_params"]
