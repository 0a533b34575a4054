"""The port's continuous-batching GenerativeEngine
(paddle_tpu_torch/inference/serving/generate.py) on the CPU: against the
reference package's engine on the same seeded numpy weights (the
reference serving tests' tiny model: vocab 256, hidden 64, 2 layers, 4
heads, max_seq_len 64; 4 slots, max_context 64, a cap of 16 new tokens),
against the port's own GPTForCausalLM.generate, and through the
scheduler's contracts: in-flight batching, eos and the max-new cap, the
400 rejects, the 503 queue shed, drain shutdown, the requeue ladder
under an injected fault, warm before admission, and the KV handoff's
entry points (test_torch_handoff.py holds the handoff). Sampling, speculation, the prefix cache and int8
serving have files of their own (test_torch_sampling.py,
test_torch_serving_beyond_greedy.py, test_torch_quantized_serving.py).

Greedy decoding is deterministic, so every path must give identical
tokens: the tests compare exactly."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.models import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import (GenerativeEngine, ServingError,
                                        stack_gpt_params)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import chaos

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
RESULT_S = 60          # every result() waits at most this long


def mixed_prompts(n, seed=1, vocab=256, lo=3, hi=30):
    """The reference serving tests' prompt recipe."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(l))
            for l in rng.randint(lo, hi, size=n)]


@pytest.fixture(scope="module")
def weights():
    """The reference model with every parameter drawn from numpy, and its
    parameters by name."""
    jm = GPTForCausalLM(GPTConfig(**CFG))
    jm.eval()
    rng = np.random.default_rng(0)
    for n, p in jm.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
    return jm, {n: p.numpy() for n, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def model(weights):
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(weights[1]))
    tm.eval()
    return tm


@pytest.fixture
def make_engine(model, request):
    """Build port engines (4 slots, max_context 64, cap 16 unless
    overridden); each is shut down when its test ends."""
    engines = []

    def make(**kw):
        kw.setdefault("slots", 4)
        kw.setdefault("max_context", 64)
        kw.setdefault("max_new_tokens_cap", 16)
        kw.setdefault("device", "cpu")
        eng = GenerativeEngine(model, **kw)
        engines.append(eng)
        return eng

    def close():
        for eng in engines:
            if not eng._started:
                eng.start()
            eng.shutdown(drain=False, timeout=RESULT_S)

    request.addfinalizer(close)
    return make


@pytest.fixture(scope="module")
def shared(model, request):
    eng = GenerativeEngine(model, slots=4, max_context=64,
                           max_new_tokens_cap=16, device="cpu")
    request.addfinalizer(lambda: eng.shutdown(timeout=RESULT_S))
    return eng


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def test_tokens_equal_the_reference_engine(weights, shared):
    jeng = JaxEngine(weights[0], slots=4, max_context=64,
                     max_new_tokens_cap=16, prompt_boundaries=[8, 16, 32])
    try:
        prompts = mixed_prompts(6)
        handles = [jeng.submit(p, 10) for p in prompts]
        ref = [h.result(RESULT_S)["tokens"] for h in handles]
    finally:
        jeng.shutdown(timeout=RESULT_S)
    handles = [shared.submit(p, 10) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == ref


def test_sequential_concurrent_streamed_and_generate_identical(model,
                                                               shared):
    prompts = mixed_prompts(6)
    seq = [shared.generate(p, 10, timeout=RESULT_S)["tokens"]
           for p in prompts]
    handles = [shared.submit(p, 10) for p in prompts]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == seq
    assert shared.metrics.max_occupancy() > 1
    assert list(shared.stream(prompts[0], 10)) == seq[0]
    for p, toks in zip(prompts, seq):
        out = model.generate(torch.from_numpy(p)[None], max_new_tokens=10)
        assert out[0, len(p):].tolist() == toks


def test_eos_retires_early(shared):
    prompt = mixed_prompts(1, seed=5)[0]
    full = shared.generate(prompt, 10, timeout=RESULT_S)["tokens"]
    assert len(full) == 10
    k = next(i for i in range(1, 10) if full[i] not in full[:i])
    out = shared.generate(prompt, 10, eos_token_id=full[k],
                          timeout=RESULT_S)
    assert out["tokens"] == full[:k + 1]
    assert out["finish_reason"] == "eos"


@pytest.mark.parametrize("P,want,expect", [(10, 9999, 16), (60, 10, 4)])
def test_max_new_cap_and_slot_clamp(shared, P, want, expect):
    """The server-side cap (16) and the slot-capacity clamp (64 - P)."""
    out = shared.generate(np.arange(P) % 256, want, timeout=RESULT_S)
    assert out["n_tokens"] == expect
    assert out["finish_reason"] == "length"


@pytest.mark.parametrize("kw", [
    {"input_ids": []}, {"input_ids": [999999]},
    {"input_ids": list(range(1, 70))},
    {"input_ids": [1, 2, 3], "max_new_tokens": 0},
    {"input_ids": [[1, 2], [3, 4]]},
    {"input_ids": [1, 2, 3], "temperature": -1.0}],
    ids=["empty", "vocab", "too_long", "zero_new", "batch", "bad_temp"])
def test_rejects_400(shared, kw):
    with pytest.raises(ServingError) as e:
        shared.submit(**kw)
    assert e.value.status == 400


def test_queue_shed_503_with_retry_after(make_engine):
    eng = make_engine(max_queue_depth=2, auto_start=False)
    handles = [eng.submit([1, 2, 3], 4) for _ in range(2)]
    with pytest.raises(ServingError) as e:
        eng.submit([1, 2, 3], 4)
    assert e.value.status == 503 and e.value.retry_after is not None
    assert eng.metrics.shed_total == 1
    eng.start()
    assert all(len(h.result(RESULT_S)["tokens"]) == 4 for h in handles)


def test_in_flight_admission_reuses_slots(make_engine, shared):
    eng = make_engine(slots=2)
    prompts = mixed_prompts(8, seed=2)
    handles = [eng.submit(p, 6) for p in prompts]
    out = [h.result(RESULT_S)["tokens"] for h in handles]
    assert out == [shared.generate(p, 6, timeout=RESULT_S)["tokens"]
                   for p in prompts]
    snap = eng.metrics.snapshot()
    assert snap["max_slot_occupancy"] == 2
    assert snap["completed_total"] == 8
    assert snap["kv_pool"]["slots_total"] == 2
    assert snap["kv_pool"]["pool_bytes"] == eng.kv_pool_bytes() == \
        2 * 3 * 2 * 64 * 4 * 16 * 4


def test_drain_shutdown_completes_inflight(make_engine):
    eng = make_engine()
    handles = [eng.submit(p, 8) for p in mixed_prompts(4, seed=3)]
    eng.shutdown(drain=True, timeout=RESULT_S)
    for h in handles:
        assert len(h.result(1)["tokens"]) == 8
    with pytest.raises(ServingError) as e:
        eng.submit([1, 2], 4)
    assert e.value.status == 503


def test_decode_raise_requeues_reprefills_without_repeats(make_engine,
                                                          shared):
    eng = make_engine()
    prompts = mixed_prompts(3, seed=9)
    ref = [shared.generate(p, 8, timeout=RESULT_S)["tokens"]
           for p in prompts]
    chaos.add_rule("serving.decode_step", "raise_n", 1)
    handles = [eng.submit(p, 8) for p in prompts]
    assert [list(h) for h in handles] == ref      # no repeats, no holes
    assert eng.metrics.requeues_total >= 1
    assert eng.metrics.failed_total == 0
    assert eng.metrics.prefills_total > len(prompts)


def test_repeated_raise_bounds_at_503(make_engine):
    eng = make_engine()
    chaos.add_rule("serving.decode_step", "raise")     # every step
    h = eng.submit(mixed_prompts(1, seed=10)[0], 8)
    with pytest.raises(ServingError) as e:
        h.result(RESULT_S)
    assert e.value.status == 503 and "replaced twice" in e.value.message


def test_drain_a_replica_under_traffic_loses_nothing(make_engine, shared):
    eng = make_engine(replicas=2)
    prompts = mixed_prompts(6, seed=8)
    ref = [shared.generate(p, 8, timeout=RESULT_S)["tokens"]
           for p in prompts]
    handles = [eng.submit(p, 8) for p in prompts]
    out = eng.remove_replica(eng._active()[0].rid, drain=True,
                             timeout=RESULT_S)
    assert out["drained"]
    assert [h.result(RESULT_S)["tokens"] for h in handles] == ref
    assert eng.metrics.failed_total == 0


def test_revive_requeues_and_completes(make_engine, shared):
    """A worker wedged mid-decode (a chaos delay scoped to its first
    generation) is revived: its requests re-prefill on the fresh
    generation and complete with the same tokens."""
    eng = make_engine()
    prompt = mixed_prompts(1, seed=11)[0]
    ref = shared.generate(prompt, 8, timeout=RESULT_S)["tokens"]
    w = eng._workers[0]
    chaos.add_rule("serving.decode_step", "delay", 0.5,
                   match={"replica": w.rid, "generation": 0})
    h = eng.submit(prompt, 8)
    deadline = time.monotonic() + RESULT_S
    while not chaos.counters()["hits"] and time.monotonic() < deadline:
        time.sleep(0.005)
    eng.revive_replica(w.rid)
    assert list(h) == ref
    assert eng.metrics.requeues_total == 1
    assert w.generation == 1


def test_concurrent_submitters_lose_no_update(make_engine, shared):
    """More submitting threads than cores, two workers, a shortened
    switch interval: every request completes with the tokens the
    single-request path gives, and the shared counters add up exactly."""
    eng = make_engine(replicas=2)
    n_threads = (os.cpu_count() or 2) + 1
    prompts = mixed_prompts(n_threads, seed=12)
    ref = [shared.generate(p, 4, timeout=RESULT_S)["tokens"]
           for p in prompts]
    out = [None] * n_threads

    def client(i):
        out[i] = eng.generate(prompts[i], 4, timeout=RESULT_S)["tokens"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(RESULT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert out == ref
    snap = eng.metrics.snapshot()
    assert snap["requests_total"] == snap["completed_total"] == n_threads
    assert snap["tokens_out_total"] == 4 * n_threads
    assert snap["step_rows_total"] == 3 * n_threads
    assert snap["kv_pool"]["slots_used"] == 0


def test_warm_before_admission(make_engine):
    eng = make_engine()
    rep = eng.program_report()
    assert rep["programs"] == \
        [f"prefill[b={b}]" for b in (8, 16, 32, 64)] + \
        [f"decode[b={b}]" for b in (1, 2, 4)] + ["kvget[b=1]", "kvput[b=1]"]
    assert rep["warmed"] == eng.warmup_report["warm_passes"] == 9
    handles = [eng.submit(p, 8) for p in mixed_prompts(8, seed=7)]
    for h in handles:
        h.result(RESULT_S)
    assert eng.program_report()["first_calls_after_warmup"] == 0
    report = eng.add_replica()
    assert report["admitted_after_warmup"] and \
        report["warmed_executables"] == 9
    assert len(eng._active()) == 2
    # with the warm-up's record wiped, the first calls of the prefill at
    # bucket 8 and of the decode step at batch 1 come after admission
    cold = make_engine()
    with cold._cv:
        cold._warmed.clear()
    cold.generate([1, 2, 3], 4, timeout=RESULT_S)
    assert cold.program_report()["first_calls_after_warmup"] == 2


def test_stacked_params_are_copies(model):
    p, cfg = stack_gpt_params(model)
    assert cfg is model.cfg
    assert p["qkv_w"].shape == (2, 64, 192)
    assert p["qkv_w"].data_ptr() != \
        model.gpt.blocks[0].attn.qkv_proj.weight.data_ptr()
    assert torch.equal(p["qkv_w"][1], model.gpt.blocks[1].attn.qkv_proj
                       .weight.T)
    with pytest.raises(TypeError):
        stack_gpt_params(object())


@pytest.mark.parametrize("kw,item", [
    ({"prefill_only": True}, "handoff"), ({"resume_from": 3}, "length")],
    ids=["prefill_only", "resume_from"])
def test_unported_request_options_raise(shared, kw, item):
    """The handoff's request options, which raised NotImplementedError
    until the KV handoff was ported: prefill_only finishes with the
    payload, resume_from=3 emits the tokens after the first 3, and a bad
    resume_from raises a 400."""
    prompt = [1, 2, 3]
    full = shared.generate(prompt, 6, timeout=RESULT_S)["tokens"]
    h = shared.submit(prompt, 6, **kw)
    out = h.result(RESULT_S)
    assert out["finish_reason"] == item
    assert out["tokens"] == full[:1 if "prefill_only" in kw else 6]
    assert list(h) == (full[:1] if "prefill_only" in kw else full[3:])
    with pytest.raises(ServingError) as e:
        shared.submit(prompt, 6, resume_from="x")
    assert e.value.status == 400


def test_unported_handoff_and_migration_raise(shared, make_engine):
    """import_handoff and shutdown(migrate=True), which raised
    NotImplementedError until the KV handoff was ported: a malformed
    payload raises a 400, and a migrating drain of an idle engine ends
    it like a drain."""
    with pytest.raises(ServingError) as e:
        shared.import_handoff(b"")
    assert e.value.status == 400
    eng = make_engine()
    eng.shutdown(migrate=True, timeout=RESULT_S)
    assert eng.health()["status"] == "draining"
    assert all(w.state == "retired" for w in eng._workers)


def test_engine_defaults_to_the_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerativeEngine(model)


def test_least_loaded_device_counts_devices_by_name():
    """Two explicit cards, the replicas holding device objects of their
    own: the count follows the card each names, not the object."""
    from paddle_tpu_torch.inference.serving.lifecycle import (
        ReplicaSlot, pick_least_loaded_device)

    pool = [torch.device("cuda", 0), torch.device("cuda", 1)]
    reps = [ReplicaSlot(0, torch.device("cuda", 0))]
    assert pick_least_loaded_device(pool, reps) is pool[1]
    reps.append(ReplicaSlot(1, torch.device("cuda:1")))
    reps.append(ReplicaSlot(2, torch.device("cuda", 1)))
    assert pick_least_loaded_device(pool, reps) is pool[0]
    reps[0].state = "retired"
    reps.append(ReplicaSlot(3, torch.device("cuda:0")))
    assert pick_least_loaded_device(pool, reps) is pool[0]


def test_add_replica_on_a_pool_device_reuses_it(make_engine):
    """add_replica(device=...) naming a device already in the pool puts
    the pool's own device object on the new worker and grows no pool."""
    eng = make_engine()
    report = eng.add_replica(device="cpu")
    assert report["admitted_after_warmup"]
    assert len(eng._device_pool) == 1
    assert all(w.device is eng._device_pool[0] for w in eng._workers)
    assert eng.generate([1, 2, 3], 4, timeout=RESULT_S)["n_tokens"] == 4


def test_deadline_expired_in_queue_503(make_engine):
    eng = make_engine(auto_start=False)
    h = eng.submit([1, 2, 3], 4, deadline_ms=1)
    time.sleep(0.01)
    eng.start()
    with pytest.raises(ServingError) as e:
        h.result(RESULT_S)
    assert e.value.status == 503 and "deadline" in e.value.message
    assert eng.metrics.failed_total == 1


def test_spans_and_flag_armed_chaos(make_engine, shared, tmp_path):
    """FLAGS_trace_dir turns the tracer on: one request's spans share its
    trace id and export as chrome-trace JSON. FLAGS_chaos_spec arms the
    harness from a spec string as add_rule does."""
    import json

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.observability import trace

    eng = make_engine()
    prompt = mixed_prompts(1, seed=13)[0]
    ref = shared.generate(prompt, 4, timeout=RESULT_S)["tokens"]
    set_flags({"trace_dir": str(tmp_path),
               "chaos_spec": "serving.decode_step:raise_n:1"})
    try:
        trace.reset()
        out = eng.generate(prompt, 4, timeout=RESULT_S)
        path = trace.export()
    finally:
        set_flags({"trace_dir": "", "chaos_spec": ""})
    assert out["tokens"] == ref
    assert eng.metrics.snapshot()["requeues_total"] == 1
    assert chaos.counters()["total_injected"] == 0   # disarmed again
    spans = [e for e in json.load(open(path))["traceEvents"]
             if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"generate.enqueue", "generate.prefill", "generate.decode_step",
            "generate.token", "generate.finish"} <= names
    enq = next(e for e in spans if e["name"] == "generate.enqueue")
    tid = enq["args"]["trace"]
    assert sum(e["name"] == "generate.token" and e["args"]["trace"] == tid
               for e in spans) == 4
    assert not trace.enabled()
