"""The port's GenerativeEngine beyond greedy on the CPU: seeded sampling
against the reference engine, speculative decoding and the prefix cache
against the port's own engine without them (and the prefix cache's hits
against the reference engine's), and the scheduler's contracts around
them: one key chain per request across the batched, one-by-one and
streamed paths and across a requeue, the draft's contract checks, the
LRU's eviction, and warm before admission of every program. The program
bodies they add are held against the reference's in
test_torch_generate.py.

The reference serving tests' tiny model (vocab 256, hidden 64, 2 layers,
4 heads, max_seq_len 64; 4 slots, max_context 64) and their draft
(hidden 32, 1 layer, 2 heads), seeded from numpy. Tokens of two paths
may part first only where both paths' top-2 margin of the logits the
token was drawn from (the filtered logits plus the step's noise) is
under MARGIN (test_torch_sampling.py); they are equal on these cases."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.models import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import GenerativeEngine, ServingError
from paddle_tpu_torch.inference.serving import generate as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import chaos

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sampling import MARGIN, ref_filter, top2  # noqa: E402

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
DRAFT = dict(vocab_size=256, hidden_size=32, num_layers=1, num_heads=2,
             max_seq_len=64)
SAMP = {"temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 42}
RESULT_S = 60


def mixed_prompts(n, seed=1, vocab=256, lo=3, hi=30):
    rng_ = np.random.RandomState(seed)
    return [rng_.randint(0, vocab, size=int(l))
            for l in rng_.randint(lo, hi, size=n)]


def shared_prefix_prompts(n, prefix_len=16, seed=2, vocab=256, lo=3,
                          hi=12):
    rng_ = np.random.RandomState(seed)
    head = rng_.randint(0, vocab, size=prefix_len)
    return [np.concatenate([head, rng_.randint(0, vocab, size=int(l))])
            for l in rng_.randint(lo, hi, size=n)]


def models(cfg, seed):
    """(reference model, port model) on the same numpy weights."""
    jm = GPTForCausalLM(GPTConfig(**cfg))
    jm.eval()
    r = np.random.default_rng(seed)
    for n, p in jm.named_parameters():
        x = r.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return models(CFG, 0)


@pytest.fixture(scope="module")
def draft():
    return models(DRAFT, 1)


def make(model, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_context", 64)
    kw.setdefault("max_new_tokens_cap", 16)
    return GenerativeEngine(model, device="cpu", **kw)


@pytest.fixture
def make_engine(target, request):
    """Port engines over the target, each shut down when its test ends."""
    engines = []

    def build(**kw):
        eng = make(target[1], **kw)
        engines.append(eng)
        return eng

    request.addfinalizer(lambda: [e.shutdown(drain=False, timeout=RESULT_S)
                                  for e in engines])
    return build


@pytest.fixture(scope="module")
def plain(target, request):
    eng = make(target[1])
    request.addfinalizer(lambda: eng.shutdown(timeout=RESULT_S))
    return eng


@pytest.fixture(scope="module")
def spec(target, draft, request):
    eng = make(target[1], draft=draft[1], spec_tokens=3)
    request.addfinalizer(lambda: eng.shutdown(timeout=RESULT_S))
    return eng


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def drawn_margins(target, prefix, samp, step):
    """Each side's top-2 margin of the logits the token after `prefix`
    is drawn from (filtered plus the request's `step`-th noise, or the
    logits themselves without `samp`), from a full-prefix pass."""
    jm, tm = target
    tp, cfg = tgen.stack_gpt_params(tm)
    P, H = len(prefix), cfg.num_heads
    pool = torch.zeros(1, cfg.num_layers, P, H, cfg.hidden_size // H)
    lt, _, _ = tgen._prefill_core(tp, pool, pool.clone(), 0,
                                  torch.as_tensor(prefix)[None], P, H, 1e-5)
    lj = jm(paddle.to_tensor(np.asarray(prefix)[None])).numpy()[0, -1]
    if samp is None:
        return top2(lt.numpy()), top2(lj)
    key = rng.key(samp["seed"])
    for _ in range(step + 1):
        key, sub = rng.split(key)
    V = lj.shape[-1]
    ft = tgen._filter_logits(lt[None], torch.tensor([samp["temperature"]]),
                             torch.tensor([samp["top_k"]]),
                             torch.tensor([samp["top_p"]]))[0]
    fj = ref_filter(jnp.asarray(lj), jnp.float32(samp["temperature"]),
                    jnp.int32(samp["top_k"]), jnp.float32(samp["top_p"]))
    nj = jax.random.gumbel(jnp.asarray(sub.numpy().astype(np.uint32)), (V,),
                           jnp.float32)
    return (top2((ft + rng.gumbel(sub[None], (V,))[0]).numpy()),
            top2(np.asarray(fj + nj)))


def assert_margin_rule(target, prompts, got, ref, samp=None):
    """Per prompt: equal tokens, or a first difference where both sides'
    drawn margins are under MARGIN."""
    parted = 0
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b)
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            prefix = np.concatenate([p, a[:j]]).astype(np.int64)
            assert max(drawn_margins(target, prefix, samp, j)) < MARGIN
            parted += 1
    assert parted <= 1


# --------------------------------------------------------------- sampling --
@pytest.fixture(scope="module")
def ref_engine(target, request):
    eng = JaxEngine(target[0], slots=4, max_context=64,
                    max_new_tokens_cap=16, prompt_boundaries=[8, 16, 32])
    request.addfinalizer(lambda: eng.shutdown(timeout=RESULT_S))
    return eng


def test_sampled_tokens_equal_the_reference_engine(target, plain,
                                                   ref_engine):
    """Seeded sampling, batched on both engines, mixed with a greedy
    request in the same batch."""
    prompts = mixed_prompts(4)
    kws = [SAMP, SAMP, {}, dict(SAMP, seed=7, top_k=5, top_p=1.0)]
    ref = [h.result(RESULT_S)["tokens"] for h in
           [ref_engine.submit(p, 10, **kw) for p, kw in zip(prompts, kws)]]
    out = [h.result(RESULT_S)["tokens"] for h in
           [plain.submit(p, 10, **kw) for p, kw in zip(prompts, kws)]]
    for p, a, b, kw in zip(prompts, out, ref, kws):
        assert_margin_rule(target, [p], [a], [b], kw or None)


def test_paths_token_identical_under_sampling(plain):
    """One key chain per request: one by one, batched and streamed give
    the same tokens."""
    prompts = mixed_prompts(4, seed=3)
    seq = [plain.generate(p, 8, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts]
    handles = [plain.submit(p, 8, **SAMP) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == seq
    assert [list(plain.stream(p, 8, **SAMP)) for p in prompts] == seq


def test_seed_changes_output_temperature_zero_is_greedy(plain):
    prompt = mixed_prompts(1, seed=3)[0]
    a = plain.generate(prompt, 12, timeout=RESULT_S, **SAMP)["tokens"]
    b = plain.generate(prompt, 12, timeout=RESULT_S,
                       **dict(SAMP, seed=43))["tokens"]
    assert a != b
    greedy = plain.generate(prompt, 12, timeout=RESULT_S)["tokens"]
    frozen = plain.generate(prompt, 12, timeout=RESULT_S, temperature=0.0,
                            top_k=5, top_p=0.5, seed=7)["tokens"]
    assert frozen == greedy
    k1 = plain.generate(prompt, 12, timeout=RESULT_S, temperature=5.0,
                        top_k=1, seed=9)["tokens"]
    assert k1 == greedy


@pytest.mark.parametrize("kw", [{"top_k": 0}, {"top_p": 1.5},
                                {"top_p": 0.0}, {"seed": "x"},
                                {"temperature": "hot"}])
def test_bad_sampling_values_400(plain, kw):
    with pytest.raises(ServingError) as e:
        plain.submit([1, 2, 3], 4, **kw)
    assert e.value.status == 400


def test_requeue_replays_the_key_chain(make_engine, plain):
    """A raise mid-decode requeues sampled and greedy rows: they re-prefill
    with the chain replayed from the seed, and the streams carry no
    duplicate and no hole."""
    eng = make_engine(slots=2)
    prompts = mixed_prompts(3, seed=8)
    ref = [plain.generate(p, 9, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts[:2]]
    ref.append(plain.generate(prompts[2], 9, timeout=RESULT_S)["tokens"])
    chaos.add_rule("serving.decode_step", "raise_n", 1)
    handles = [eng.submit(p, 9, **SAMP) for p in prompts[:2]]
    handles.append(eng.submit(prompts[2], 9))
    assert [list(h) for h in handles] == ref
    assert eng.metrics.requeues_total >= 1
    assert eng.metrics.failed_total == 0


# ------------------------------------------------------------ speculation --
def test_spec_greedy_equals_spec_off(target, plain, spec):
    prompts = mixed_prompts(6, seed=5)
    ref = [plain.generate(p, 12, timeout=RESULT_S)["tokens"]
           for p in prompts]
    seq = [spec.generate(p, 12, timeout=RESULT_S)["tokens"]
           for p in prompts]
    assert_margin_rule(target, prompts, seq, ref)
    handles = [spec.submit(p, 12) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == seq
    snap = spec.metrics.snapshot()
    assert snap["spec_steps_total"] == snap["draft_steps_total"] > 0
    assert snap["spec_proposed_total"] > 0
    # a different-weight draft neither always agrees nor never
    assert 0.0 < snap["spec_accept_rate"] < 1.0


def test_spec_sampling_equals_spec_off(target, plain, spec):
    """The verify pass samples each position with plain decode's key
    chain, whichever token it keeps."""
    prompts = mixed_prompts(4, seed=6)
    ref = [plain.generate(p, 10, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts]
    out = [spec.generate(p, 10, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts]
    for p, a, b in zip(prompts, out, ref):
        assert_margin_rule(target, [p], [a], [b], SAMP)


@pytest.mark.parametrize("burst", range(3))
def test_self_draft_accepts_everything(make_engine, target, burst):
    """Draft == target: every greedy proposal verifies and each burst
    emits k tokens: 12 tokens in 3 bursts at k = 4."""
    eng = make_engine(slots=2, draft=target[1], spec_tokens=4)
    out = eng.generate(mixed_prompts(3, seed=7)[burst], 12,
                       timeout=RESULT_S)
    assert len(out["tokens"]) == 12
    snap = eng.metrics.snapshot()
    assert snap["spec_accept_rate"] == 1.0
    assert snap["spec_steps_total"] == 3


@pytest.mark.parametrize("cfg_kw,spec_tokens,match", [
    ({"vocab_size": 128}, 3, "vocab"),
    ({"max_seq_len": 32}, 3, "max_seq_len"),
    ({}, 1, "spec_tokens")])
def test_draft_contract_validation(target, cfg_kw, spec_tokens, match):
    bad = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(DRAFT, **cfg_kw)),
                              device="cpu")
    with pytest.raises(ValueError, match=match):
        make(target[1], draft=bad, spec_tokens=spec_tokens)


def test_draft_params_pair_is_a_draft(target, draft, plain):
    params = tgen.stack_gpt_params(draft[1])
    eng = make(target[1], draft_params=params, spec_tokens=2)
    try:
        p = mixed_prompts(1, seed=9)[0]
        assert eng.generate(p, 6, timeout=RESULT_S)["tokens"] == \
            plain.generate(p, 6, timeout=RESULT_S)["tokens"]
        assert eng.metrics.snapshot()["spec_steps_total"] > 0
    finally:
        eng.shutdown(timeout=RESULT_S)


def test_chaos_raise_mid_burst_requeues_without_duplicates(make_engine,
                                                           draft, plain):
    eng = make_engine(draft=draft[1], spec_tokens=3)
    prompts = mixed_prompts(3, seed=8)
    ref = [plain.generate(p, 9, timeout=RESULT_S, **SAMP)["tokens"]
           for p in prompts[:2]]
    ref.append(plain.generate(prompts[2], 9, timeout=RESULT_S)["tokens"])
    chaos.add_rule("serving.decode_step", "raise_n", 1)
    handles = [eng.submit(p, 9, **SAMP) for p in prompts[:2]]
    handles.append(eng.submit(prompts[2], 9))
    assert [list(h) for h in handles] == ref
    assert eng.metrics.requeues_total >= 1
    assert eng.metrics.failed_total == 0


# ----------------------------------------------------------- prefix cache --
def test_prefix_hits_and_tokens_equal_the_reference(target, plain,
                                                    make_engine):
    """Prompts sharing a 16-token head: the first admits, the rest hit and
    prefill their tails. Hits, misses and reused tokens are the
    reference engine's, and so are the tokens (margin rule); greedy and
    sampled, equal to the cache-less engine's."""
    prompts = shared_prefix_prompts(5)
    jeng = JaxEngine(target[0], slots=4, max_context=64,
                     max_new_tokens_cap=16, prompt_boundaries=[8, 16, 32],
                     prefix_cache_slots=2)
    try:
        ref = [jeng.generate(p, 8, timeout=RESULT_S)["tokens"]
               for p in prompts]
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.shutdown(timeout=RESULT_S)
    eng = make_engine(prefix_cache_slots=2)
    out = [eng.generate(p, 8, timeout=RESULT_S)["tokens"] for p in prompts]
    assert_margin_rule(target, prompts, out, ref)
    snap = eng.metrics.snapshot()
    for k in ("prefix_hits_total", "prefix_misses_total",
              "prefix_evictions_total", "prefix_tokens_reused_total",
              "prefix_hit_rate"):
        assert snap[k] == jsnap[k], k
    assert snap["prefix_hits_total"] >= 4
    assert snap["prefix_tokens_reused_total"] >= 4 * 16
    assert out == [plain.generate(p, 8, timeout=RESULT_S)["tokens"]
                   for p in prompts]
    sref = [plain.generate(p, 8, timeout=RESULT_S, **SAMP)["tokens"]
            for p in prompts]
    sout = [eng.generate(p, 8, timeout=RESULT_S, **SAMP)["tokens"]
            for p in prompts]
    assert_margin_rule(target, prompts, sout, sref, SAMP)


def test_lru_eviction_bounded(make_engine):
    """More distinct prefixes than cache rows: the LRU evicts, the
    eviction counter moves, and every output stays the same."""
    eng = make_engine(prefix_cache_slots=1)
    groups = [shared_prefix_prompts(2, seed=s) for s in (3, 4)]
    ref = {}
    for g in groups:
        for p in g:
            ref[id(p)] = eng.generate(p, 6, timeout=RESULT_S)["tokens"]
    for _ in range(2):
        for g in groups:
            for p in g:
                assert eng.generate(p, 6, timeout=RESULT_S)["tokens"] == \
                    ref[id(p)]
    snap = eng.metrics.snapshot()
    assert snap["prefix_evictions_total"] >= 1
    assert snap["kv_pool"]["slots_used"] == 0


def test_batched_prefix_workload_matches_sequential(make_engine):
    eng = make_engine(prefix_cache_slots=2)
    prompts = shared_prefix_prompts(6, seed=5)
    seq = [eng.generate(p, 8, timeout=RESULT_S)["tokens"] for p in prompts]
    handles = [eng.submit(p, 8) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == seq


def test_warm_before_admission_covers_every_program(make_engine, draft):
    eng = make_engine(prefix_cache_slots=2, draft=draft[1], spec_tokens=3)
    rep = eng.program_report()
    b = (8, 16, 32, 64)
    assert rep["programs"] == \
        [f"prefill[b={s}]" for s in b] + \
        [f"decode[b={n}]" for n in (1, 2, 4)] + \
        ["kvget[b=1]", "kvput[b=1]"] + ["pcopy[b=1]"] + [f"extend[b={s}]" for s in b] + \
        [f"dprefill[b={s}]" for s in b] + \
        [f"dpropose[b={n},k=3]" for n in (1, 2, 4)] + \
        [f"verify[b={n},k=3]" for n in (1, 2, 4)]
    assert rep["warmed"] == eng.warmup_report["warm_passes"] == \
        len(rep["programs"])
    for p in shared_prefix_prompts(4) + mixed_prompts(4):
        eng.generate(p, 6, timeout=RESULT_S, **SAMP)
    assert eng.program_report()["first_calls_after_warmup"] == 0
    assert eng.metrics.snapshot()["prefix_hits_total"] >= 3
