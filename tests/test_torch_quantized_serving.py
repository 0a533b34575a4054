"""The port's quantized serving tier on the CPU (quantization/kv.py and
the int8 paths of inference/serving/generate.py): the int8 KV helpers and
weight-only int8 against the reference package's, the decode, prefill and
extend bodies over an int8 pool against the reference's, the quantized
engines against the reference's quantized engine and against the port's
float engine (the reference tests' thresholds: int8 KV >= 0.9 of tokens
and weight-only int8 >= 0.6 equal to f32's, first tokens exact), and the
contracts that hold among quantized paths: one key chain on every path,
speculation, a requeue, and prefix-cache hits over int8 rows.

Tolerances: on the same inputs, scales, raw int8 rows and weight-only
int8 tensors bitwise, int8 grid values equal except at round-half ties (x
/ s within 1e-5 of a half integer), counted; pools a body wrote from its
own K/V (rounded differently in f32 by the two packages) with scales
within 1e-6 and int8 values one step apart on under 0.1% of entries;
tokens by the margin rule of test_torch_serving_beyond_greedy.py."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.inference.serving import generate as jgen
from paddle_tpu.quantization import kv as jkv

from paddle_tpu_torch.inference import GenerativeEngine
from paddle_tpu_torch.inference.serving import generate as tgen
from paddle_tpu_torch.quantization import kv as tkv
from paddle_tpu_torch.testing import chaos

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_serving_beyond_greedy import (  # noqa: E402
    CFG, DRAFT, RESULT_S, SAMP, assert_margin_rule, mixed_prompts, models,
    shared_prefix_prompts)

torch.set_num_threads(1)

TIE_ATOL = 1e-5


def match_frac(a, b):
    """Mean share of aligned token positions that agree."""
    return float(np.mean([np.mean([x == y for x, y in zip(s, t)])
                          for s, t in zip(a, b)]))


def j(x, dt=jnp.int32):
    return jnp.asarray(np.asarray(x), dt)


def assert_grid_equal(mine, ref, x, s):
    """int8 grid values equal but at round-half ties of x / s."""
    mine, ref = np.asarray(mine), np.asarray(ref)
    differ = mine != ref
    if differ.any():
        ratio = (np.asarray(x, np.float64)
                 / np.broadcast_to(np.asarray(s, np.float64), x.shape))
        frac = np.abs(np.abs(ratio) % 1 - 0.5)
        assert (frac[differ] < TIE_ATOL).all()
        assert np.abs(mine[differ].astype(int)
                      - ref[differ].astype(int)).max() <= 1
    return int(differ.sum())


# ------------------------------------------------------------- primitives --
@pytest.fixture(scope="module")
def blocks():
    r = np.random.default_rng(0)
    ks = r.standard_normal((3, 6, 2, 4)).astype(np.float32)
    ks[1, 2, 0, 0] = 9.0                       # one layer's outlier
    return ks, r.standard_normal((4, 3, 2, 4)).astype(np.float32)


def test_block_scale_quant_fake_quant_match_reference(blocks):
    ks, _ = blocks
    s = tkv.block_scale(torch.from_numpy(ks))
    js = jkv.block_scale(jnp.asarray(ks))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    ties = assert_grid_equal(tkv.quant(torch.from_numpy(ks), s).numpy(),
                             jkv.quant(jnp.asarray(ks), js), ks,
                             s.numpy()[:, None, None, None])
    assert ties <= 1
    np.testing.assert_array_equal(
        tkv.fake_quant(torch.from_numpy(ks), s).numpy(),
        np.asarray(jkv.fake_quant(jnp.asarray(ks), js)))


def test_zero_block_does_not_divide_by_zero():
    z = torch.zeros(2, 4, 1, 2)
    s = tkv.block_scale(z)
    assert torch.isfinite(s).all() and (s > 0).all()
    assert (tkv.quant(z, s) == 0).all()


def test_int8_pool_helpers_match_reference(blocks):
    """store (scale reset), gather (dequantized, with the scales), scatter
    (each row's existing scale, clip at +-127), copy_row and the raw row
    pair, step by step on both packages' int8 pools."""
    ks, vals = blocks
    shape = (5, 3, 8, 2, 4)
    tb, jb = tkv.alloc(shape, "cpu", "int8"), jkv.alloc(shape, None, "int8")
    assert tb.nbytes == jb.nbytes == tkv.pool_nbytes(shape, "int8")
    tb = tkv.store_block(tb, 1, torch.from_numpy(ks))
    jb = jkv.store_block(jb, jnp.int32(1), jnp.asarray(ks))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    assert_grid_equal(tb.data.numpy(), jb.data, np.zeros(shape), 1.0)
    slots = np.array([1, 2, 1, 4])
    rows, scl = tkv.gather_rows(tb, torch.from_numpy(slots))
    jrows, jscl = jkv.gather_rows(jb, jnp.asarray(slots))
    np.testing.assert_array_equal(scl.numpy(), np.asarray(jscl))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    big = vals * np.float32(50)                  # past +-127: clipped
    wslot, wpos = np.array([1, 2, 3, 4]), np.array([6, 0, 7, 3])
    tb = tkv.scatter_rows(tb, torch.from_numpy(wslot),
                          torch.from_numpy(wpos), torch.from_numpy(big))
    jb = jkv.scatter_rows(jb, jnp.asarray(wslot), jnp.asarray(wpos),
                          jnp.asarray(big))
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    assert np.abs(tb.data.numpy()).max() == 127
    tb = tkv.copy_row(tb, 1, 0)
    jb = jkv.copy_row(jb, 1, 0)
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    d, s = tkv.row_raw(tb, 0)
    assert d.dtype == torch.int8 and s.shape == (3,)
    tb = tkv.set_row_raw(tb, 3, d.clone(), s.clone())
    jb = jkv.set_row_raw(jb, 3, *jkv.row_raw(jb, 0))
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))


def test_fake_quant_is_the_scatter_gather_round_trip(blocks):
    """The bodies' in-loop writes read what the pool will hold."""
    ks, vals = blocks
    tb = tkv.store_block(tkv.alloc((3, 3, 8, 2, 4), "cpu", "int8"), 2,
                         torch.from_numpy(ks))
    tb = tkv.scatter_rows(tb, torch.tensor([2]), torch.tensor([7]),
                          torch.from_numpy(vals[:1]))
    rows, scl = tkv.gather_rows(tb, torch.tensor([2]))
    np.testing.assert_array_equal(
        rows[0, :, 7].numpy(),
        tkv.fake_quant(torch.from_numpy(vals[0]), scl[0]).numpy())


@pytest.fixture(scope="module")
def target():
    return models(CFG, 0)


def test_quantize_stacked_params_matches_reference(target):
    """Per-layer scales for the stacked weights, a per-tensor one for an
    untied lm_head; int8 values and scales bitwise; the per-layer
    dequantization the bodies use is the whole dict's."""
    jp, _ = jgen.stack_gpt_params(target[0])
    tp, _ = tgen.stack_gpt_params(target[1])
    r = np.random.default_rng(3)
    head = r.standard_normal((64, 256)).astype(np.float32) * 0.05
    jp = dict(jp, lm_head=jnp.asarray(head))
    tp = dict(tp, lm_head=torch.from_numpy(head))
    jq = jkv.quantize_stacked_params(jp)
    tq = tkv.quantize_stacked_params(tp)
    assert set(tq) == set(jq)
    for k in jq:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]),
                                      err_msg=k)
    assert tq["qkv_w__q"].dtype == torch.int8
    assert tq["qkv_w__s"].shape == (2, 1, 1) and tq["lm_head__s"].dim() == 0
    full = tkv.dequant_params(tq)
    jfull = jkv.dequant_params(jq)
    for k in ("qkv_w", "out_w", "fc1_w", "fc2_w", "lm_head"):
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(jfull[k]))
    for l in range(2):
        assert torch.equal(tkv.weight(tq, "fc1_w", l), full["fc1_w"][l])
    assert tkv.weight(tp, "fc1_w", 1) is not None
    assert torch.equal(tkv.weight(tq, "lm_head"), full["lm_head"])


# ---------------------------------------------------------- int8 bodies --
@pytest.fixture(scope="module")
def int8_pools():
    """Both packages' int8 pools [7, 2, 32, 4, 16] with two rows prefilled
    from random blocks (rows 0 and 2, 20 positions)."""
    r = np.random.default_rng(4)
    tk, tv = (tkv.alloc((7, 2, 32, 4, 16), "cpu", "int8") for _ in range(2))
    for slot in (0, 2):
        for tb in (tk, tv):
            blk = r.standard_normal((2, 20, 4, 16)).astype(np.float32)
            tkv.store_block(tb, slot, torch.from_numpy(blk))
    jk, jv = (jkv.QuantizedKV(jnp.asarray(b.data.numpy()),
                              jnp.asarray(b.scale.numpy())) for b in (tk, tv))
    return tk, tv, jk, jv


def assert_pools_close(mine, ref):
    """Pools a body wrote from its own K/V, which the two packages round
    differently in f32: scales within 1e-6 relative (a block's absmax),
    int8 values one step apart at most, on under 0.1% of entries."""
    np.testing.assert_allclose(mine.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)
    d = np.abs(mine.data.numpy().astype(int)
               - np.asarray(ref.data).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def copy_pools(int8_pools):
    tk, tv, jk, jv = int8_pools
    return (tkv.QuantizedKV(tk.data.clone(), tk.scale.clone()),
            tkv.QuantizedKV(tv.data.clone(), tv.scale.clone()), jk, jv)


def test_decode_core_over_int8_pool_matches_reference(target, int8_pools):
    jp, _ = jgen.stack_gpt_params(target[0])
    tp, _ = tgen.stack_gpt_params(target[1])
    tk, tv, jk, jv = copy_pools(int8_pools)
    slots, toks, lens = np.array([0, 2, 4]), np.array([3, 9, 0]), \
        np.array([20, 20, 0])
    jl, jk2, jv2 = jgen._decode_core(jp, jk, jv, j(slots), j(toks), j(lens),
                                     4, num_heads=4, eps=1e-5)
    tl, tk2, tv2 = tgen._decode_core(
        tp, tk, tv, torch.from_numpy(slots), torch.from_numpy(toks),
        torch.from_numpy(lens), 4, 4, 1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for a, b in ((tk2, jk2), (tv2, jv2)):
        assert_pools_close(a, b)


def test_prefill_and_extend_over_int8_pool_match_reference(target,
                                                           int8_pools):
    """A prefill resets its row's scales; an extend keeps them (the tail
    quantizes with the cached prefix's scale). First tokens and keys
    exact, scales bitwise, rows on the int8 grid."""
    jp, _ = jgen.stack_gpt_params(target[0])
    tp, _ = tgen.stack_gpt_params(target[1])
    tk, tv, jk, jv = copy_pools(int8_pools)
    ids = np.random.default_rng(6).integers(0, 256, (1, 16))
    key = np.array([1, 2], np.uint32)
    jt, jkey, jk, jv = jgen._prefill_body(
        jp, jk, jv, j(1), j(ids), j(13), jnp.float32(0.0), j(1),
        jnp.float32(1.0), jnp.asarray(key), num_heads=4, eps=1e-5)
    tt, tkey, tk, tv = tgen._prefill_body(
        tp, tk, tv, 1, torch.from_numpy(ids), 13, 0.0, 1, 1.0,
        torch.from_numpy(key.astype(np.int64)), 4, 1e-5)
    assert int(tt) == int(jt)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    assert_pools_close(tk, jk)
    jt, _, jk, jv = jgen._extend_body(
        jp, jk, jv, j(2), j(ids[:, :8]), j(20), j(25), jnp.float32(0.8),
        j(40), jnp.float32(0.9), jnp.asarray(key), 4, num_heads=4, eps=1e-5)
    tt, _, tk, tv = tgen._extend_body(
        tp, tk, tv, 2, torch.from_numpy(ids[:, :8]), 20, 25, 0.8, 40, 0.9,
        torch.from_numpy(key.astype(np.int64)), 4, 4, 1e-5)
    assert int(tt) == int(jt)
    for a, b in ((tk, jk), (tv, jv)):
        assert_pools_close(a, b)


# ---------------------------------------------------------------- engines --
def make(model, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_context", 64)
    kw.setdefault("max_new_tokens_cap", 16)
    return GenerativeEngine(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(target, request):
    """Port engines: f32, the int8 pool, the int8 pool with int8 weights,
    and weight-only int8 on a float pool."""
    out = {"f32": make(target[1]),
           "kv": make(target[1], kv_dtype="int8"),
           "kvw": make(target[1], kv_dtype="int8", quantize_weights=True),
           "w": make(target[1], quantize_weights=True)}
    request.addfinalizer(lambda: [e.shutdown(timeout=RESULT_S)
                                  for e in out.values()])
    return out


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def test_int8_engine_tokens_equal_the_reference_int8_engine(target,
                                                            engines):
    """The int8 pool with int8 weights on both packages, greedy and
    sampled."""
    jeng = JaxEngine(target[0], slots=4, max_context=64,
                     max_new_tokens_cap=16, prompt_boundaries=[8, 16, 32],
                     kv_dtype="int8", quantize_weights=True)
    prompts = mixed_prompts(4, seed=5)
    try:
        ref = [jeng.generate(p, 10, timeout=RESULT_S)["tokens"]
               for p in prompts]
        sref = [jeng.generate(p, 10, timeout=RESULT_S, **SAMP)["tokens"]
                for p in prompts]
    finally:
        jeng.shutdown(timeout=RESULT_S)
    eng = engines["kvw"]
    out = [eng.generate(p, 10, timeout=RESULT_S)["tokens"] for p in prompts]
    sout = [eng.generate(p, 10, timeout=RESULT_S, **SAMP)["tokens"]
            for p in prompts]
    # the margins are read on the float model: a loose proxy for the
    # quantized paths, which are equal on these cases
    assert_margin_rule(target, prompts, out, ref)
    assert_margin_rule(target, prompts, sout, sref, SAMP)


@pytest.mark.parametrize("name,floor", [("kv", 0.9), ("w", 0.6),
                                        ("kvw", 0.6)])
def test_quantized_greedy_against_float(engines, name, floor):
    """First tokens exact (a prefill attends its own float K/V; int8
    weights round the same on both), sequences at the reference tests'
    floors."""
    prompts = mixed_prompts(6, seed=5)
    ref = [engines["f32"].generate(p, 12, timeout=RESULT_S)["tokens"]
           for p in prompts]
    out = [engines[name].generate(p, 12, timeout=RESULT_S)["tokens"]
           for p in prompts]
    if name == "kv":
        assert all(a[0] == b[0] for a, b in zip(ref, out))
    assert match_frac(ref, out) >= floor


def test_density_and_reports(target, engines):
    f32, kv = engines["f32"], engines["kv"]
    shape = f32._pool_shape()
    assert f32.kv_pool_bytes() == 2 * tkv.pool_nbytes(shape, "f32")
    assert kv.kv_pool_bytes() == 2 * tkv.pool_nbytes(shape, "int8")
    assert kv.kv_pool_bytes() * 3 < f32.kv_pool_bytes()
    bufs = kv._alloc_bufs("cpu")
    assert bufs[0].nbytes == tkv.pool_nbytes(shape, "int8")
    assert bufs[0].data.dtype == torch.int8 and bufs[2] is None
    snap = engines["kvw"].metrics.snapshot()
    assert snap["quant_kv_enabled"] == 1 and snap["quant_weights_enabled"]
    assert snap["kv_pool"]["pool_bytes"] == kv.kv_pool_bytes()
    assert f32.metrics.snapshot()["quant_kv_enabled"] == 0
    rep = engines["kvw"].program_report()
    assert rep["kv_dtype"] == "int8" and rep["quantize_weights"]
    assert engines["kv"].health()["kv_dtype"] == "int8"
    qp = engines["w"]._params
    assert "qkv_w" not in qp and qp["qkv_w__q"].dtype == torch.int8
    with pytest.raises(ValueError, match="kv_dtype"):
        make(target[1], kv_dtype="fp8")


def test_all_paths_token_identical_among_quantized(engines):
    eng = engines["kvw"]
    prompts = mixed_prompts(4, seed=11)
    seq = [eng.generate(p, 8, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts]
    handles = [eng.submit(p, 8, **SAMP) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == seq
    assert [list(eng.stream(p, 8, **SAMP)) for p in prompts] == seq


def test_spec_on_equals_spec_off_int8(target, engines):
    draft = models(DRAFT, 1)[1]
    spec = make(target[1], kv_dtype="int8", draft=draft, spec_tokens=3)
    try:
        prompts = mixed_prompts(6, seed=5)
        ref = [engines["kv"].generate(p, 12, timeout=RESULT_S)["tokens"]
               for p in prompts]
        out = [spec.generate(p, 12, timeout=RESULT_S)["tokens"]
               for p in prompts]
        assert_margin_rule(target, prompts, out, ref)
        sref = [engines["kv"].generate(p, 10, timeout=RESULT_S,
                                       **SAMP)["tokens"] for p in prompts]
        sout = [spec.generate(p, 10, timeout=RESULT_S, **SAMP)["tokens"]
                for p in prompts]
        assert_margin_rule(target, prompts, sout, sref, SAMP)
        snap = spec.metrics.snapshot()
        assert snap["spec_steps_total"] > 0 and snap["spec_accept_rate"] > 0
        # the draft's pool is int8 too
        assert spec._alloc_bufs("cpu")[2].data.dtype == torch.int8
    finally:
        spec.shutdown(timeout=RESULT_S)


def test_chaos_requeue_replays_with_int8_pool(target):
    eng = make(target[1], slots=2, kv_dtype="int8")
    try:
        prompts = mixed_prompts(3, seed=8)
        ref = [eng.generate(p, 9, timeout=RESULT_S, **SAMP)["tokens"]
               for p in prompts[:2]]
        ref.append(eng.generate(prompts[2], 9, timeout=RESULT_S)["tokens"])
        chaos.add_rule("serving.decode_step", "raise_n", 1)
        handles = [eng.submit(p, 9, **SAMP) for p in prompts[:2]]
        handles.append(eng.submit(prompts[2], 9))
        assert [list(h) for h in handles] == ref
        assert eng.metrics.requeues_total >= 1
        assert eng.metrics.failed_total == 0
    finally:
        eng.shutdown(timeout=RESULT_S)


def test_prefix_cache_over_int8_rows(target, engines):
    """A hit extends a quantized row with the cached prefix's scales
    (clip semantics) where a cold engine re-prefills and rescales: tokens
    agree within the reference test's 0.7, and the cache-on engine is
    self-consistent across its own paths."""
    pc = make(target[1], kv_dtype="int8", prefix_cache_slots=2)
    try:
        prompts = shared_prefix_prompts(6)
        ref = [engines["kv"].generate(p, 8, timeout=RESULT_S)["tokens"]
               for p in prompts]
        out = [pc.generate(p, 8, timeout=RESULT_S)["tokens"]
               for p in prompts]
        assert pc.metrics.snapshot()["prefix_hits_total"] >= 1
        assert match_frac(ref, out) >= 0.7
        s1 = [pc.generate(p, 8, timeout=RESULT_S, **SAMP)["tokens"]
              for p in prompts]
        s2 = [list(pc.stream(p, 8, **SAMP)) for p in prompts]
        assert s1 == s2
    finally:
        pc.shutdown(timeout=RESULT_S)
