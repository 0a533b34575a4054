"""Generation in the port (paddle_tpu_torch/models/gpt.py's cached path
and greedy `generate`, and the program bodies and KV helpers of
paddle_tpu_torch/inference/serving/generate.py and quantization/kv.py:
prefill, decode, the prefix cache's extend and row copy, the draft's
propose and the verify pass) against the reference package on the same
seeded numpy weights and inputs, in f32 on the CPU.

Tolerances: attention outputs and pool rows 1e-5 absolute, logits 1e-4
absolute (the packages differ in the order of f32 sums only); greedy
tokens and buffers the helpers only copy must be identical."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import generate as jgen
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import kv as jkv

from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference.serving import generate as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.quantization import kv as tkv

torch.set_num_threads(1)

OUT_ATOL = 1e-5       # attention outputs and pool rows
LOGIT_ATOL = 1e-4     # logits are O(1)


def _seeded_params(m, seed):
    """Every parameter of the reference model from numpy: weights
    0.05*N(0,1), LayerNorm scales 1 + 0.1*N(0,1), biases 0.02*N(0,1)."""
    rng = np.random.default_rng(seed)
    for n, p in m.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)


def _models(cfg_kw, seed=0):
    """(reference model, port model) on the same weights."""
    cfg = GPTConfig(**cfg_kw)
    jm = GPTForCausalLM(cfg)
    jm.eval()
    _seeded_params(jm, seed)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg_kw), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    tm.eval()
    return jm, tm


TINY = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=8,
            max_seq_len=256)        # gpt3-tiny's widths
SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


@pytest.fixture(scope="module")
def small():
    jm, tm = _models(SMALL, seed=3)
    jp, cfg = jgen.stack_gpt_params(jm)
    tp, _ = tgen.stack_gpt_params(tm)
    return jm, tm, jp, tp, cfg


def _prompt(B=2, L=12, vocab=1024, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, L))


# ------------------------------------------------------- cached attention --
@pytest.mark.parametrize("ln,pos", [(1, 0), (1, 7), (5, 0), (5, 7)])
def test_cached_attention_matches_reference(ln, pos):
    B, M, H, D = 2, 16, 4, 8
    rng = np.random.default_rng(ln * 10 + pos)
    q, kn, vn = (rng.standard_normal((B, ln, H, D)).astype(np.float32)
                 for _ in range(3))
    kb, vb = (rng.standard_normal((B, M, H, D)).astype(np.float32)
              for _ in range(2))
    jo, jk, jv = jgpt._cached_attn_p._pure_fn(
        *(jnp.asarray(x) for x in (q, kn, vn, kb, vb)), jnp.int32(pos))
    to, tk, tv = tgpt.cached_attention(
        *(torch.from_numpy(x.copy()) for x in (q, kn, vn, kb, vb)), pos)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------- kv helpers --
def test_kv_store_gather_scatter_copy_match_reference():
    shape = (5, 2, 8, 2, 4)           # [slots + 1, L, cap, H, Dh]
    rng = np.random.default_rng(0)
    base = rng.standard_normal(shape).astype(np.float32)
    jb, tb = jnp.asarray(base), torch.from_numpy(base.copy())
    block = rng.standard_normal((2, 6, 2, 4)).astype(np.float32)
    jb = jkv.store_block(jb, jnp.int32(1), jnp.asarray(block))
    tb = tkv.store_block(tb, 1, torch.from_numpy(block))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    slots = np.array([1, 3, 4])
    jr, js = jkv.gather_rows(jb, jnp.asarray(slots))
    tr, ts = tkv.gather_rows(tb, torch.from_numpy(slots))
    assert js is None and ts is None
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    tr += 1                            # a gathered row is a copy
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # a write past the cap (8) is redirected to the scratch row (4), as
    # _decode_core redirects it
    lengths, scratch = np.array([2, 8, 5]), shape[0] - 1
    safe = lengths < shape[2]
    wslot = np.where(safe, slots, scratch)
    wpos = np.where(safe, lengths, 0)
    vals = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    jb = jkv.scatter_rows(jb, jnp.asarray(wslot), jnp.asarray(wpos),
                          jnp.asarray(vals))
    tb = tkv.scatter_rows(tb, torch.from_numpy(wslot),
                          torch.from_numpy(wpos), torch.from_numpy(vals))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tb.numpy()[scratch, :, 0], vals[1])
    jb = jkv.copy_row(jb, 3, 0)
    tb = tkv.copy_row(tb, 3, 0)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for dt in ("f32", "int8"):
        assert tkv.pool_nbytes(shape, dt) == jkv.pool_nbytes(shape, dt)
    assert tkv.alloc(shape, "cpu").abs().sum() == 0
    assert tkv.fake_quant(tb, None) is tb and not tkv.is_quantized(tb)
    # the int8 round trip: a block stored into a fresh int8 pool and
    # gathered back is the reference's, and is fake_quant of the block
    # under the row's new scales
    q = tkv.alloc(shape, "cpu", "int8")
    assert tkv.is_quantized(q)
    assert q.nbytes == tkv.pool_nbytes(shape, "int8")
    assert q.data.abs().sum() == 0 and bool((q.scale == 1).all())
    jq = jkv.store_block(jkv.alloc(shape, None, "int8"), jnp.int32(2),
                         jnp.asarray(block))
    q = tkv.store_block(q, 2, torch.from_numpy(block))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(q.data.numpy(), np.asarray(jq.data))
    rows, scl = tkv.gather_rows(q, 2)
    np.testing.assert_array_equal(rows[:, :6].numpy(), tkv.fake_quant(
        torch.from_numpy(block), scl).numpy())
    # weight-only int8 of the stacked float dict and back
    p = {"wte": tb[0, 0, 0], "qkv_w": tb[:, 0]}
    assert tkv.dequant_params(p) is p
    qp = tkv.quantize_stacked_params(p)
    assert set(qp) == {"wte", "qkv_w__q", "qkv_w__s"}
    jp = jkv.dequant_params(jkv.quantize_stacked_params(
        {k: np.asarray(v) for k, v in p.items()}))
    np.testing.assert_array_equal(tkv.dequant_params(qp)["qkv_w"].numpy(),
                                  np.asarray(jp["qkv_w"]))


# --------------------------------------------------------- program bodies --
def test_stacked_params_match_reference_layout(small):
    _, _, jp, tp, _ = small
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("P", [5, 13])
def test_prefill_body_matches_reference(small, P):
    jm, tm, jp, tp, cfg = small
    S, slot, M = 16, 1, 32
    shape = (4, cfg.num_layers, M, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    ids = np.zeros((1, S), np.int64)
    ids[0, :P] = _prompt(1, P, cfg.vocab_size, seed=P)[0]
    jt, jkey, jk, jv = jgen._prefill_body(
        jp, jnp.zeros(shape), jnp.zeros(shape), jnp.int32(slot),
        jnp.asarray(ids, jnp.int32), jnp.int32(P), jnp.float32(0.0),
        jnp.int32(1), jnp.float32(1.0), jnp.zeros(2, jnp.uint32),
        num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    logits, tk, tv = tgen._prefill_core(tp, tk, tv, slot,
                                        torch.from_numpy(ids), P,
                                        cfg.num_heads, cfg.layer_norm_eps)
    assert int(torch.argmax(logits)) == int(jt)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=OUT_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=OUT_ATOL)
    # the logits at length-1 are the reference model's forward logits
    ref = jm(paddle.to_tensor(ids[:, :P])).numpy()[0, -1]
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_ATOL)
    tok, key, _, _ = tgen._prefill_body(
        tp, tk, tv, slot, torch.from_numpy(ids), P, 0.0, 1, 1.0,
        torch.zeros(2, dtype=torch.int64), cfg.num_heads,
        cfg.layer_norm_eps)
    assert int(tok) == int(jt)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))


def test_decode_core_matches_reference(small):
    """Four rows (one at the cap, whose write the scratch row takes, and
    one padding row on the scratch slot) through one decode pass over a
    pool of random contents: logits and the whole pool."""
    _, _, jp, tp, cfg = small
    M, scratch = 32, 4
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    rng = np.random.default_rng(7)
    pool_k, pool_v = (rng.standard_normal(
        (scratch + 1, cfg.num_layers, M, H, Dh)).astype(np.float32)
        for _ in range(2))
    slots = np.array([2, 0, 3, scratch])
    tokens = rng.integers(0, cfg.vocab_size, 4)
    lengths = np.array([9, 0, M, 0])
    jl, jk, jv = jgen._decode_core(
        jp, jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(slots, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(lengths, jnp.int32), scratch,
        num_heads=H, eps=cfg.layer_norm_eps)
    tl, tk, tv = tgen._decode_core(
        tp, torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy()),
        torch.from_numpy(slots), torch.from_numpy(tokens),
        torch.from_numpy(lengths), scratch, H, cfg.layer_norm_eps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=OUT_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=OUT_ATOL)
    # only the scratch row and the new positions changed
    changed = np.argwhere(np.abs(tk.numpy() - pool_k).sum((3, 4)) > 0)
    assert {(int(s), int(p)) for s, _, p in changed} == \
        {(2, 9), (0, 0), (scratch, 0)}
    nxt, _, _, _ = tgen._decode_body(
        tp, torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy()),
        torch.from_numpy(slots), torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.zeros(4),
        torch.ones(4, dtype=torch.int64), torch.ones(4),
        torch.zeros(4, 2, dtype=torch.int64), scratch, H,
        cfg.layer_norm_eps)
    np.testing.assert_array_equal(nxt.numpy(),
                                  np.argmax(np.asarray(jl), -1))


# ------------------------------------- bodies of speculation and the cache --
@pytest.fixture(scope="module")
def bodies(small):
    """Stacked parameters of both packages (the small model and a draft:
    hidden 32, 1 layer, 2 heads) and random pool pairs [slots + 1 + 2
    cache rows, L, 32, H, Dh] and the draft's [slots + 1, ...]."""
    _, _, jp, tp, _ = small
    jd, td = _models(dict(SMALL, hidden_size=32, num_layers=1,
                          num_heads=2), seed=4)
    djp, _ = jgen.stack_gpt_params(jd)
    dtp, _ = tgen.stack_gpt_params(td)
    r = np.random.default_rng(5)
    pool = [r.standard_normal((7, 2, 32, 4, 16)).astype(np.float32)
            for _ in range(2)]
    dpool = [r.standard_normal((5, 1, 32, 2, 16)).astype(np.float32)
             for _ in range(2)]
    return jp, tp, djp, dtp, pool, dpool


def t(x):
    return torch.from_numpy(np.array(x))


def j(x, dt=jnp.int32):
    return jnp.asarray(np.asarray(x), dt)


@pytest.mark.parametrize("start,T,length", [(8, 8, 13), (16, 16, 29),
                                            (24, 16, 31)])
def test_extend_body_matches_reference(bodies, start, T, length):
    """The tail block over a row cached to `start` (T = 16 at 24 runs past
    the cap of 32: its overshoot lands in the scratch row 4)."""
    jp, tp, _, _, pool, _ = bodies
    ids = np.random.default_rng(T).integers(0, 256, (1, T))
    key = np.array([3, 9], np.uint32)
    jt, jk, jbk, jbv = jgen._extend_body(
        jp, j(pool[0], jnp.float32), j(pool[1], jnp.float32), j(2),
        j(ids), j(start), j(length), jnp.float32(0.7), j(20),
        jnp.float32(0.9), jnp.asarray(key), 4, num_heads=4, eps=1e-5)
    tt, tk, tbk, tbv = tgen._extend_body(
        tp, t(pool[0]), t(pool[1]), 2, t(ids), start, length, 0.7, 20, 0.9,
        t(key.astype(np.int64)), 4, 4, 1e-5)
    assert int(tt) == int(jt)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tbk.numpy(), np.asarray(jbk), atol=1e-5)
    np.testing.assert_allclose(tbv.numpy(), np.asarray(jbv), atol=1e-5)


def test_propose_and_verify_bodies_match_reference(bodies):
    """A draft burst of k = 3 then the target's verify pass over 4 rows
    (one 2 positions short of the cap of 32, one padding row): proposals,
    sampled tokens, key history and both pools."""
    jp, tp, djp, dtp, pool, dpool = bodies
    slots = np.array([0, 1, 3, 4])
    toks = np.array([5, 77, 200, 0])
    lens = np.array([3, 12, 30, 0])
    jprops, jdk, jdv = jgen._propose_body(
        djp, j(dpool[0], jnp.float32), j(dpool[1], jnp.float32), j(slots),
        j(toks), j(lens), 3, 4, num_heads=2, eps=1e-5)
    tprops, tdk, tdv = tgen._propose_body(
        dtp, t(dpool[0]), t(dpool[1]), t(slots), t(toks), t(lens), 3, 4, 2,
        1e-5)
    np.testing.assert_array_equal(tprops.numpy(), np.asarray(jprops))
    np.testing.assert_allclose(tdk.numpy(), np.asarray(jdk), atol=1e-5)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), atol=1e-5)
    block = np.concatenate([toks[:, None], tprops.numpy()[:, :2]], 1)
    temps = np.array([0.0, 0.8, 1.2, 0.0], np.float32)
    topks = np.array([256, 50, 8, 1])
    topps = np.array([1.0, 0.9, 0.7, 1.0], np.float32)
    keys = np.random.default_rng(2).integers(0, 2**32, (4, 2),
                                             dtype=np.uint64)
    jys, jh, jbk, jbv = jgen._verify_body(
        jp, j(pool[0], jnp.float32), j(pool[1], jnp.float32), j(slots),
        j(block), j(lens), j(temps, jnp.float32), j(topks),
        j(topps, jnp.float32), j(keys, jnp.uint32), 4, num_heads=4,
        eps=1e-5)
    tys, th, tbk, tbv = tgen._verify_body(
        tp, t(pool[0]), t(pool[1]), t(slots), t(block), t(lens), t(temps),
        t(topks), t(topps), t(keys.astype(np.int64)), 4, 4, 1e-5)
    np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tbk.numpy(), np.asarray(jbk), atol=1e-5)
    np.testing.assert_allclose(tbv.numpy(), np.asarray(jbv), atol=1e-5)


def test_copy_row_body_matches_reference(bodies):
    _, _, _, _, pool, _ = bodies
    jk, jv = jgen._copy_row_body(j(pool[0], jnp.float32),
                                 j(pool[1], jnp.float32), 1, 5)
    tk, tv = tgen._copy_row_body(t(pool[0]), t(pool[1]), 1, 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------- generate --
def _cached_logits_jax(jm, prompt, tokens):
    """The reference's cached path fed `tokens` after `prompt`: the
    logits before each token (teacher forcing)."""
    cfg = jm.cfg
    B, L = prompt.shape
    maxlen = L + tokens.shape[1]
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    caches = [{"k": paddle.zeros([B, maxlen, H, D]),
               "v": paddle.zeros([B, maxlen, H, D]),
               "pos": paddle.to_tensor(np.int32(0))}
              for _ in jm.gpt.blocks]
    with paddle.no_grad():
        h = jm.gpt(paddle.to_tensor(prompt), caches=caches, pos_offset=0)
        out = [jm._logits_from_hidden(h[:, -1:]).numpy()[:, 0]]
        for i in range(tokens.shape[1] - 1):
            for c in caches:
                c["pos"] = paddle.to_tensor(np.int32(L + i))
            h = jm.gpt(paddle.to_tensor(tokens[:, i:i + 1]), caches=caches,
                       pos_offset=L + i)
            out.append(jm._logits_from_hidden(h).numpy()[:, 0])
    return np.stack(out, 1)


def _cached_logits_torch(tm, prompt, tokens):
    cfg = tm.cfg
    B, L = prompt.shape
    maxlen = L + tokens.shape[1]
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    caches = [{"k": torch.zeros(B, maxlen, H, D),
               "v": torch.zeros(B, maxlen, H, D), "pos": 0}
              for _ in tm.gpt.blocks]
    with torch.inference_mode():
        h = tm.gpt(torch.from_numpy(prompt), caches=caches, pos_offset=0)
        out = [tm._logits_from_hidden(h[:, -1:])[:, 0]]
        for i in range(tokens.shape[1] - 1):
            for c in caches:
                c["pos"] = L + i
            h = tm.gpt(torch.from_numpy(tokens[:, i:i + 1]), caches=caches,
                       pos_offset=L + i)
            out.append(tm._logits_from_hidden(h)[:, 0])
    return torch.stack(out, 1).numpy()


def test_generate_matches_reference_tokens_and_logits(tiny):
    jm, tm = tiny
    prompt = _prompt()
    ref = jm.generate(paddle.to_tensor(prompt), max_new_tokens=16).numpy()
    out = tm.generate(torch.from_numpy(prompt), max_new_tokens=16)
    assert out.dtype == torch.int64 and out.shape == (2, 28)
    np.testing.assert_array_equal(out.numpy(), ref)
    new = ref[:, 12:]
    np.testing.assert_allclose(_cached_logits_torch(tm, prompt, new),
                               _cached_logits_jax(jm, prompt, new),
                               atol=LOGIT_ATOL)


def test_generate_stops_at_eos(tiny):
    jm, tm = tiny
    prompt = _prompt(1, 9, seed=4)
    full = tm.generate(prompt, max_new_tokens=10)[0, 9:].tolist()
    k = next(i for i in range(1, 10) if full[i] not in full[:i])
    out = tm.generate(prompt, max_new_tokens=10, eos_token_id=full[k])
    ref = jm.generate(paddle.to_tensor(prompt), max_new_tokens=10,
                      eos_token_id=full[k]).numpy()
    assert out[0, 9:].tolist() == full[:k + 1]
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_stops_at_the_cache_end(tiny):
    """maxlen = min(max_seq_len, L + max_new): a prompt 3 short of
    max_seq_len gets 3 new tokens, as in the reference."""
    jm, tm = tiny
    prompt = _prompt(1, 253, seed=5)
    out = tm.generate(prompt, max_new_tokens=8)
    ref = jm.generate(paddle.to_tensor(prompt), max_new_tokens=8).numpy()
    assert out.shape == (1, 256)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_training_forward_unchanged_without_cache(tiny):
    """No cache: the training path (flash attention's plain version on the
    CPU), the reference's logits; the cached prefill of the same ids gives
    the same last-position logits through the einsum cache attention."""
    jm, tm = tiny
    ids = _prompt(2, 32, seed=6)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids))
        again = tm._logits_from_hidden(
            tm.gpt(torch.from_numpy(ids), caches=None, pos_offset=0))
    assert torch.equal(logits, again)
    np.testing.assert_allclose(logits.numpy(),
                               jm(paddle.to_tensor(ids)).numpy(),
                               atol=LOGIT_ATOL)
    cached = _cached_logits_torch(tm, ids, ids[:, :1])[:, 0]
    np.testing.assert_allclose(cached, logits.numpy()[:, -1],
                               atol=LOGIT_ATOL)


def test_cached_attention_scale_is_head_dim():
    """The cache attention scales by 1/sqrt(D): one key, one query, so the
    softmax is 1 and the output is that key's value whatever the scale;
    with two keys the weights follow exp(q.k / sqrt(D))."""
    q = torch.ones(1, 1, 1, 4)
    kb = torch.zeros(1, 2, 1, 4)
    vb = torch.zeros(1, 2, 1, 4)
    kb[0, 0] = 1.0
    vb[0, 0, 0, 0] = 1.0
    out, _, _ = tgpt.cached_attention(q, torch.zeros(1, 1, 1, 4),
                                      torch.zeros(1, 1, 1, 4), kb, vb, 1)
    w0 = math.exp(4 / 2) / (math.exp(4 / 2) + 1)
    assert abs(float(out[0, 0, 0, 0]) - w0) < 1e-6
