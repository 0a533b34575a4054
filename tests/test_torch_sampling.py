"""Sampling in the port against the reference package on the CPU: the
threefry functions of paddle_tpu_torch/core/rng.py against jax.random
(JAX 0.9 with jax_threefry_partitionable on), the serving sampler of
paddle_tpu_torch/inference/serving/generate.py against the reference's
`_sample_token`, `_split_keys` and `_decode_body` on fixed numpy logits,
and GPTForCausalLM.generate(do_sample=True) after seed(s) on both sides.

Tolerances: key words, split, fold_in, the bits and uniform are bitwise;
Gumbel noise within GUMBEL_ATOL (XLA's f32 log and torch's part by an
ulp on some draws); the greedy branch bitwise. A sampled token may part
from the reference's only where both sides' top-2 margin of the logits
it was drawn from (the filtered logits plus the noise) is under MARGIN;
the top-p kept set only where cumsum - p lies within TOP_P_EDGE of top_p.
Each exception is counted and must stay rare."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import rng as jrng
from paddle_tpu.inference.serving import generate as jgen
from paddle_tpu.models import GPTConfig, GPTForCausalLM

import paddle_tpu_torch
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference.serving import generate as tgen
from paddle_tpu_torch.models import gpt as tgpt

torch.set_num_threads(1)

GUMBEL_ATOL = 1e-6
MARGIN = 1e-5
TOP_P_EDGE = 1e-6
NEG = -1e30


def jkey(words):
    return jnp.asarray(np.asarray(words, np.uint32))


def tkey(words):
    return torch.as_tensor(np.asarray(words, np.int64))


def top2(x):
    s = np.sort(np.asarray(x, np.float64))
    return s[-1] - s[-2]


# ------------------------------------------------------------- threefry --
def test_jax_threefry_is_partitionable():
    """The port follows the partitionable threefry; a JAX that turns it
    off changes split and the bits, and must name itself here."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 + 5,
                                  2**40 + 3, -1, -7])
def test_keys_from_seeds(seed):
    """The reference package runs JAX in x64 mode, where a key holds the
    seed's 64 bits, as the engine's `_seed_key` does."""
    assert jax.config.jax_enable_x64
    np.testing.assert_array_equal(
        rng.key(seed).numpy(), jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(rng.key(seed).numpy(),
                                  jgen._seed_key(seed))


@pytest.mark.parametrize("words", [(0, 0), (0, 42), (5, 9),
                                   (0xFFFFFFFF, 0x12345678)])
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_bitwise(words, num):
    np.testing.assert_array_equal(
        rng.split(tkey(words), num).numpy(),
        np.asarray(jax.random.split(jkey(words), num)))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31, 2**32 - 1])
def test_fold_in_bitwise(data):
    k = (3, 0xDEADBEEF)
    np.testing.assert_array_equal(
        rng.fold_in(tkey(k), data).numpy(),
        np.asarray(jax.random.fold_in(jkey(k), data)))


@pytest.mark.parametrize("shape", [(1,), (5,), (4, 7), (3, 1, 1024)])
def test_bits_and_uniform_bitwise(shape):
    """32-bit bits; uniforms in f32 (the engine's) and f64 (generate's:
    the reference draws them in its x64 mode), plain and in [tiny, 1)."""
    k = (11, 0xCAFEF00D)
    np.testing.assert_array_equal(
        rng.random_bits(tkey(k), shape).numpy(),
        np.asarray(jax.random.bits(jkey(k), shape, jnp.uint32))
        .astype(np.int64))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.float64, jnp.float64)):
        np.testing.assert_array_equal(
            rng.uniform(tkey(k), shape, dtype=tdt).numpy(),
            np.asarray(jax.random.uniform(jkey(k), shape, jdt)))
        lo = float(np.finfo(jdt).tiny)
        np.testing.assert_array_equal(
            rng.uniform(tkey(k), shape, lo, 1.0, tdt).numpy(),
            np.asarray(jax.random.uniform(jkey(k), shape, jdt, minval=lo,
                                          maxval=1.0)))


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.float64, jnp.float64)])
def test_gumbel_within_tolerance(tdt, jdt):
    k = (0, 3)
    g = rng.gumbel(tkey(k), (100000,), tdt).numpy()
    ref = np.asarray(jax.random.gumbel(jkey(k), (100000,), jdt))
    assert np.abs(g - ref).max() <= GUMBEL_ATOL
    assert np.mean(g == ref) > 0.5        # most draws are bitwise


def test_batched_keys_are_the_vmapped_chains():
    """Leading dims batch keys: each row's split and bits are its own
    key's, as the reference's vmapped `_split_keys`."""
    keys = np.random.default_rng(0).integers(0, 2**32, (6, 2),
                                             dtype=np.uint64)
    carry, use = tgen._split_keys(tkey(keys))
    jc, ju = jgen._split_keys(jkey(keys))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(use.numpy(), np.asarray(ju))
    bits = rng.random_bits(tkey(keys), (33,)).numpy()
    for i in range(6):
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(jkey(keys[i]), (33,),
                                                jnp.uint32)))


def test_generator_follows_the_reference():
    jrng.seed(11)
    paddle_tpu_torch.seed(11)
    for _ in range(3):
        np.testing.assert_array_equal(
            rng.next_key().numpy(), jax.random.key_data(jrng.next_key()))
    g = rng.Generator(5)
    assert torch.equal(g.next_key(), rng.fold_in(rng.key(5), 1))
    assert g.get_state() == (5, 1) and g.initial_seed() == 5
    g.next_key()
    g.set_state((5, 1))
    assert torch.equal(g.next_key(), rng.fold_in(rng.key(5), 2))


# -------------------------------------------------------------- sampler --
def ref_filter(logits, temp, topk, topp):
    """The reference `_sample_token`'s filter (generate.py:196-206), for
    the kept set and the values the noise is added to."""
    V = logits.shape[-1]
    scaled = logits / jnp.maximum(temp, 1e-6)
    srt = jnp.sort(scaled)[::-1]
    kth = srt[jnp.clip(topk - 1, 0, V - 1)]
    masked_srt = jnp.where(srt < kth, NEG, srt)
    sp = jax.nn.softmax(masked_srt)
    keep = (jnp.cumsum(sp) - sp) < topp
    cutoff = jnp.min(jnp.where(keep, masked_srt, jnp.inf))
    return jnp.where(scaled < jnp.maximum(kth, cutoff), NEG, scaled)


def port_filter_edge(logits, temp, topk, topp):
    """Whether the port's top-p cut lies at an edge: some sorted entry's
    cumsum - p within TOP_P_EDGE of top_p."""
    x = torch.from_numpy(logits)[None] / max(temp, 1e-6)
    srt = torch.sort(x, -1, descending=True).values
    kth = srt[:, min(max(topk - 1, 0), x.shape[-1] - 1)][:, None]
    sp = torch.softmax(torch.where(srt < kth, NEG, srt), -1)
    excl = (torch.cumsum(sp, -1) - sp)[0].numpy()
    return bool(np.any(np.abs(excl - np.float32(topp)) <= TOP_P_EDGE))


GRID = [(t, k, p) for t in (0.0, 0.5, 1.0, 2.0) for k in (1, 5, 50, 256)
        for p in (0.3, 0.9, 1.0)]


@pytest.fixture(scope="module")
def sampler_runs():
    """Every (temperature, top_k, top_p) of GRID on 8 rows of fixed
    logits [256] with 8 keys, through both samplers: a list of (params,
    port tokens, reference tokens, port filtered, reference filtered,
    port noise, reference noise)."""
    r = np.random.default_rng(0)
    logits = (r.standard_normal((8, 256)) * 2).astype(np.float32)
    keys = r.integers(0, 2**32, (8, 2), dtype=np.uint64)
    noise_t = rng.gumbel(tkey(keys), (256,)).numpy()
    noise_j = np.stack([np.asarray(jax.random.gumbel(jkey(k), (256,),
                                                     jnp.float32))
                        for k in keys])
    runs = []
    for t, k, p in GRID:
        b = logits.shape[0]
        mine = tgen._sample_rows(
            torch.from_numpy(logits), torch.full((b,), t),
            torch.full((b,), k), torch.full((b,), p), tkey(keys)).numpy()
        ref = np.asarray(jax.vmap(jgen._sample_token)(
            jnp.asarray(logits), jnp.full((b,), t, jnp.float32),
            jnp.full((b,), k, jnp.int32), jnp.full((b,), p, jnp.float32),
            jkey(keys)))
        ft = tgen._filter_logits(torch.from_numpy(logits),
                                 torch.full((b,), t), torch.full((b,), k),
                                 torch.full((b,), p)).numpy()
        fj = np.stack([np.asarray(ref_filter(jnp.asarray(x), jnp.float32(t),
                                             jnp.int32(k), jnp.float32(p)))
                       for x in logits])
        runs.append(((t, k, p), logits, mine, ref, ft, fj, noise_t,
                     noise_j))
    return runs


def test_greedy_branch_bitwise(sampler_runs):
    for (t, _, _), logits, mine, ref, *_ in sampler_runs:
        if t == 0.0:
            np.testing.assert_array_equal(mine, ref)
            np.testing.assert_array_equal(mine, np.argmax(logits, -1))


def test_kept_sets_equal_but_at_the_top_p_edge(sampler_runs):
    """A kept set may differ only at the top-p edge, and then only by
    tokens whose share of the mass (f64 softmax of the scaled logits) is
    under 1e-5: at top_p = 1.0 without a top-k cut, f32's cumsum reaches
    1 before the last tokens on both sides, at different ones."""
    edges = 0
    for (t, k, p), logits, _, _, ft, fj, _, _ in sampler_runs:
        if t == 0.0:
            continue
        for i in range(ft.shape[0]):
            differ = (ft[i] > -1e29) != (fj[i] > -1e29)
            if differ.any():
                assert port_filter_edge(logits[i], t, k, p)
                x = logits[i].astype(np.float64) / t
                mass = np.exp(x - x.max())
                assert (mass[differ] / mass.sum()).sum() < 1e-5
                edges += 1
    assert edges <= ft.shape[0]      # one grid point's rows at most


def test_sampled_tokens_follow_the_margin_rule(sampler_runs):
    """Equal tokens, or both sides' top-2 margins of (filtered logits +
    noise) under MARGIN; the filtered values within 1e-6 of logits' size
    where both keep them."""
    parted = 0
    for (t, _, _), _, mine, ref, ft, fj, nt, nj in sampler_runs:
        if t == 0.0:
            continue
        both = (ft > -1e29) & (fj > -1e29)
        np.testing.assert_allclose(ft[both], fj[both], rtol=1e-6)
        for i in np.flatnonzero(mine != ref):
            assert max(top2(ft[i] + nt[i]), top2(fj[i] + nj[i])) < MARGIN
            parted += 1
    assert parted <= 1


def test_top_k_one_is_greedy_at_any_temperature(sampler_runs):
    for (t, k, _), logits, mine, *_ in sampler_runs:
        if k == 1:
            np.testing.assert_array_equal(mine, np.argmax(logits, -1))


def test_decode_body_sampling_matches_reference():
    """The sampling decode step on a random pool: each row's token and its
    carried key against the reference's `_decode_body`, rows of every
    kind (greedy, top-k, nucleus, a padding row) in one batch."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=64)
    jm = GPTForCausalLM(GPTConfig(**cfg))
    jm.eval()
    r = np.random.default_rng(1)
    for n, prm in jm.named_parameters():
        prm.set_value((r.standard_normal(prm.shape) * 0.05)
                      .astype(np.float32) + (1.0 if ".ln" in n and
                                             n.endswith("weight") else 0.0))
    jp, _ = jgen.stack_gpt_params(jm)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    tp, _ = tgen.stack_gpt_params(tm)
    M, scratch, H, Dh = 32, 4, 4, 16
    pool = [r.standard_normal((scratch + 1, 2, M, H, Dh)).astype(np.float32)
            for _ in range(2)]
    slots = np.array([0, 1, 2, scratch])
    toks = r.integers(0, 256, 4)
    lens = np.array([5, 17, 9, 0])
    temps = np.array([0.0, 0.8, 1.5, 0.0], np.float32)
    topks = np.array([256, 50, 10, 1])
    topps = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    keys = r.integers(0, 2**32, (4, 2), dtype=np.uint64)
    jn, jk, _, _ = jgen._decode_body(
        jp, *(jnp.asarray(x) for x in pool), jnp.asarray(slots, jnp.int32),
        jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(temps), jnp.asarray(topks, jnp.int32), jnp.asarray(topps),
        jkey(keys), scratch, num_heads=H, eps=1e-5)
    tn, tk, _, _ = tgen._decode_body(
        tp, *(torch.from_numpy(x.copy()) for x in pool),
        torch.from_numpy(slots), torch.from_numpy(toks),
        torch.from_numpy(lens), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(topps), tkey(keys),
        scratch, H, 1e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# ------------------------------------------------------------ generate --
@pytest.fixture(scope="module")
def tiny():
    """gpt3-tiny's widths, the reference model's weights from numpy."""
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=8,
               max_seq_len=256)
    jm = GPTForCausalLM(GPTConfig(**cfg))
    jm.eval()
    r = np.random.default_rng(0)
    for n, prm in jm.named_parameters():
        x = r.standard_normal(prm.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        prm.set_value(x)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("seed,top_k,temperature", [
    (0, 0, 1.0), (3, 40, 0.7), (9, 5, 2.0)])
def test_generate_do_sample_matches_reference(tiny, seed, top_k,
                                              temperature):
    """After seed(s) on both sides, the same Gumbel keys: equal tokens, or
    a first difference where both sides' top-2 margins of (filtered
    logits + noise) are under MARGIN (the reference's cached logits and
    the port's differ in the order of f32 sums)."""
    jm, tm = tiny
    prompt = np.random.default_rng(seed).integers(0, 1024, (2, 9))
    kw = dict(max_new_tokens=12, do_sample=True, top_k=top_k,
              temperature=temperature)
    paddle.seed(seed)
    ref = jm.generate(paddle.to_tensor(prompt), **kw).numpy()
    paddle_tpu_torch.seed(seed)
    out = tm.generate(torch.from_numpy(prompt), **kw).numpy()
    assert out.shape == ref.shape
    diff = np.argwhere(out != ref)
    if diff.size:
        b, j = diff[0]
        assert j > 9        # the prompt is copied
        # the step's noise: the (j - 9 + 1)-th key after seed(s)
        g = rng.Generator(seed)
        for _ in range(j - 9):
            g.next_key()
        noise = rng.gumbel(g.next_key(), (2, 1024),
                           torch.float64).numpy()[b]
        with torch.no_grad():
            lt = tm(torch.from_numpy(out[b:b + 1, :j]))[0, -1].numpy()
        lj = jm(paddle.to_tensor(ref[b:b + 1, :j])).numpy()[0, -1]
        for x in (lt, lj):
            x = x / max(temperature, 1e-6)
            if top_k:
                x = np.where(x < np.sort(x)[-top_k], NEG, x)
            assert top2(x + noise) < MARGIN
    # a different seed draws other tokens
    paddle_tpu_torch.seed(seed + 1)
    other = tm.generate(torch.from_numpy(prompt), **kw).numpy()
    assert not np.array_equal(other, out)


def test_generate_top_k_one_is_greedy(tiny):
    _, tm = tiny
    prompt = np.random.default_rng(4).integers(0, 1024, (1, 7))
    paddle_tpu_torch.seed(1)
    out = tm.generate(prompt, max_new_tokens=8, do_sample=True, top_k=1,
                      temperature=3.0)
    assert torch.equal(out, tm.generate(prompt, max_new_tokens=8))
