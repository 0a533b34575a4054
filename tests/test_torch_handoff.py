"""The KV handoff of the port (paddle_tpu_torch/inference/fabric/handoff.py
and the engine's export and import in inference/serving/generate.py) on
the CPU, against the reference package's, on the reference handoff
tests' tiny model (vocab 64, hidden 32, 2 layers, 2 heads, max_seq_len
64) with weights drawn from numpy; engines of 4 slots, max_context 64, a
cap of 16 new tokens and the default prompt buckets (8..64) on both
sides, so the prefix lineage agrees.

- The wire format: bitwise round trips, the same bytes as the
  reference's encoder, malformed payloads refused.
- Across packages, both ways: a prefill_only export of one engine,
  imported into the other package's engine, continues to the tokens of
  the uninterrupted stream, for f32 and int8 pools, greedy and seeded
  sampling. Greedy and seeded decoding are deterministic and the two
  packages' f32 logits differ by rounding only (top-2 margins here are
  above 1e-2), so tokens compare exactly.
- Exports of one stream by both packages: equal meta, bitwise prompt and
  key, K/V within 1e-5 absolute (f32), int8 values at most one step
  apart on under 1% of entries with scales within 1e-6 relative.
- The port alone: no duplicates once `streamed` is set, resume_from, the
  lineage hitting the importer's prefix cache, the refusals (409, 400)
  taking no slot, drain with migration, and the control-plane key sets
  (health, load_report, add_replica, snapshot, Prometheus names) against
  the reference's, `persistent_hits`/`persistent_misses` (the
  reference's compile cache) the one difference."""
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.inference.fabric import handoff as jho
from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.models import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import GenerativeEngine, ServingError
from paddle_tpu_torch.inference.fabric import handoff
from paddle_tpu_torch.inference.serving import generate as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import chaos

torch.set_num_threads(1)

VOCAB = 64
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
SEEDED = {"temperature": 0.9, "top_k": 8, "seed": 3}
ENGINE = dict(slots=4, max_context=64, max_new_tokens_cap=16)
PROMPT = list(range(1, 14))       # 13 tokens: lineage at boundary 8
NEW = 8
RESULT_S = 60
KV_ATOL = 1e-5                    # f32 rows of two packages' prefills
INT8_STEP_SHARE = 1e-2            # int8 entries one step apart, at most
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def models():
    """(reference model, port model) on the same numpy weights."""
    jm = GPTForCausalLM(GPTConfig(**CFG))
    jm.eval()
    r = np.random.default_rng(0)
    for n, p in jm.named_parameters():
        x = r.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.1)
        p.set_value(x)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()}))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def engines(models, request):
    """Per kv_dtype: a reference engine (no warm-up: it compiles what it
    runs) and two port engines, the second the import target."""
    out = {}
    for kv in ("f32", "int8"):
        out[kv] = (JaxEngine(models[0], warmup=False, kv_dtype=kv,
                             **ENGINE),
                   GenerativeEngine(models[1], kv_dtype=kv, device="cpu",
                                    **ENGINE),
                   GenerativeEngine(models[1], kv_dtype=kv, device="cpu",
                                    **ENGINE))
    request.addfinalizer(lambda: [e.shutdown(timeout=RESULT_S)
                                  for trio in out.values() for e in trio])
    return out


@pytest.fixture
def make_engine(models, request):
    made = []

    def make(**kw):
        eng = GenerativeEngine(models[1], device="cpu",
                               **dict(ENGINE, **kw))
        made.append(eng)
        return eng

    request.addfinalizer(lambda: [e.shutdown(drain=False, timeout=RESULT_S)
                                  for e in made])
    return make


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def stream(handle):
    """(tokens, terminal kind, its value) of a handle's events."""
    toks = []
    for kind, val in handle.events():
        if kind == "tok":
            toks.append(int(val))
        else:
            return toks, kind, val
    return toks, None, None


def export(eng, prompt=PROMPT, new=NEW, **samp):
    res = eng.submit(prompt, max_new_tokens=new, prefill_only=True,
                     **samp).result(RESULT_S)
    assert res["finish_reason"] == "handoff"
    return handoff.from_b64(res["handoff"])


# ================================================================ wire --
def _payload():
    meta = {"cap": 64, "tokens": [1, 2], "streamed": 0}
    arrays = {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "q8": (np.arange(12, dtype=np.int8) - 5).reshape(3, 4),
              "prompt": np.array([3, 1, 2], np.int32),
              "key": np.array([7, 9], np.uint32)}
    return meta, arrays


def test_wire_round_trip_is_bitwise_and_the_reference_format():
    meta, arrays = _payload()
    raw = handoff.encode(meta, arrays)
    assert raw == jho.encode(meta, arrays)
    meta2, arrays2 = handoff.decode(raw)
    assert meta2 == meta and list(arrays2) == list(arrays)
    for name, a in arrays.items():
        assert arrays2[name].dtype == a.dtype
        assert arrays2[name].shape == a.shape
        assert arrays2[name].tobytes() == a.tobytes()
    assert handoff.from_b64(handoff.to_b64(raw)) == raw
    assert handoff.to_b64(raw) == jho.to_b64(raw)


def test_wire_rejects_malformed_and_tampered():
    meta, arrays = _payload()
    raw = handoff.encode(meta, arrays)
    hlen = int.from_bytes(raw[6:10], "little")
    header = json.loads(raw[10:10 + hlen].decode())
    header["arrays"][0]["shape"][0] += 1       # claims bytes it lacks
    hb = json.dumps(header, separators=(",", ":")).encode()
    tampered = raw[:6] + len(hb).to_bytes(4, "little") + hb + \
        raw[10 + hlen:]
    for bad in (b"nope" + raw[4:], raw[:-3], raw + b"\x00",
                raw[:4] + b"\x63\x00" + raw[6:], tampered, b"PDKV",
                raw[:6] + (1 << 30).to_bytes(4, "little") + raw[10:]):
        with pytest.raises(ValueError):
            handoff.decode(bad)
    for arr in (np.array([object()]), np.zeros(3)):
        with pytest.raises(ValueError):
            handoff.encode({}, {"x": arr})


def test_prefix_hash_equals_engine_copy_and_reference():
    ids = np.random.RandomState(11).randint(0, 4096, size=40)
    for n in (1, 4, 16, 33):
        want = jho.prefix_hash(ids.tolist(), n)
        assert handoff.prefix_hash(ids.tolist(), n) == want
        assert tgen._prefix_hash(ids.astype(np.int64), n) == want
    assert handoff.prefix_hash(ids, 16) != handoff.prefix_hash(ids[1:], 16)


# ====================================================== across packages --
@pytest.mark.parametrize("samp", [{}, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_reference_export_continues_on_the_port(engines, kv, samp):
    ref, port, _ = engines[kv]
    want = ref.generate(PROMPT, NEW, **samp)["tokens"]
    raw = jho.from_b64(ref.submit(PROMPT, NEW, prefill_only=True, **samp)
                       .result(RESULT_S)["handoff"])
    toks, kind, info = stream(port.import_handoff(raw))
    assert kind == "done" and toks == want and info["tokens"] == want


@pytest.mark.parametrize("samp", [{}, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_port_export_continues_on_the_reference(engines, kv, samp):
    ref, port, _ = engines[kv]
    want = port.generate(PROMPT, NEW, **samp)["tokens"]
    raw = export(port, **samp)
    toks = []
    for kind, val in ref.import_handoff(raw).events():
        if kind == "tok":
            toks.append(int(val))
    assert toks == want == ref.generate(PROMPT, NEW, **samp)["tokens"]


@pytest.mark.parametrize("samp", [{}, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_both_packages_export_the_same_stream(engines, kv, samp):
    ref, port, _ = engines[kv]
    jmeta, jarr = jho.decode(jho.from_b64(
        ref.submit(PROMPT, NEW, prefill_only=True, **samp)
        .result(RESULT_S)["handoff"]))
    meta, arr = handoff.decode(export(port, **samp))
    assert meta == jmeta
    assert meta["lineage"] == [[8, jho.prefix_hash(PROMPT, 8)]]
    assert list(arr) == list(jarr)
    for name in ("prompt", "key"):
        assert arr[name].dtype == jarr[name].dtype
        assert arr[name].tobytes() == jarr[name].tobytes()
    if kv == "f32":
        for name in ("k", "v"):
            np.testing.assert_allclose(arr[name], jarr[name], rtol=0,
                                       atol=KV_ATOL)
        return
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(arr[name], jarr[name], rtol=SCALE_RTOL)
    for name in ("k", "v"):
        d = np.abs(arr[name].astype(np.int16) - jarr[name].astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < INT8_STEP_SHARE


# ============================================================ port alone --
def test_streamed_tokens_are_not_emitted_again(engines):
    _, port, peer = engines["f32"]
    want = port.generate(PROMPT, NEW)["tokens"]
    meta, arrays = handoff.decode(export(port))
    assert meta["streamed"] == 0 and meta["tokens"] == want[:1]
    toks, kind, info = stream(peer.import_handoff(
        handoff.encode(dict(meta, streamed=1), arrays)))
    assert kind == "done" and toks == want[1:] and info["tokens"] == want


def test_resume_from_replays_the_suffix_only(engines):
    _, port, _ = engines["f32"]
    want = port.generate(PROMPT, NEW, **SEEDED)["tokens"]
    toks, kind, info = stream(port.submit(PROMPT, NEW, resume_from=3,
                                          **SEEDED))
    assert kind == "done" and toks == want[3:] and info["tokens"] == want
    with pytest.raises(ServingError) as e:
        port.submit(PROMPT, NEW, resume_from=-2)
    assert e.value.status == 400


def test_lineage_hits_the_importers_prefix_cache(make_engine):
    a = make_engine(prefix_cache_slots=2)
    b = make_engine(prefix_cache_slots=2)
    raw = export(a)
    assert stream(b.import_handoff(raw))[1] == "done"
    digest = f"8:{handoff.prefix_hash(PROMPT, 8)[:8]}"
    assert b.load_report()["prefix"] == [digest]
    b.generate(PROMPT[:12], 2, timeout=RESULT_S)
    snap = b.metrics.snapshot()
    assert snap["prefix_hits_total"] == 1
    assert snap["prefix_tokens_reused_total"] == 8
    assert snap["handoffs_in_total"] == 1
    assert snap["handoff_bytes_total"] == len(raw)


def test_refusals_take_no_slot(engines):
    _, port, peer = engines["f32"]
    _, int8_port, _ = engines["int8"]
    raw = export(port)
    meta, arrays = handoff.decode(raw)
    cap2 = dict(meta, cap=128, shape=[2, 128, 2, 16])
    heads = dict(meta, shape=[2, 64, 4, 8])
    cases = [
        (int8_port, raw, 409),                               # kv_dtype
        (peer, handoff.encode(cap2, arrays), 409),           # cap
        (peer, handoff.encode(heads, arrays), 409),          # geometry
        (peer, b"garbage", 400),
        (peer, b"PDKV" + b"\x00" * 20, 400),
        (peer, handoff.encode(meta, {k: v for k, v in arrays.items()
                                     if k != "key"}), 400),  # missing
        (peer, handoff.encode(meta, dict(arrays, k=arrays["k"][:1])),
         400),                                               # misshapen
        (peer, handoff.encode(dict(meta, tokens=[VOCAB + 5]), arrays),
         400),                                               # vocab
        (peer, handoff.encode(meta, dict(
            arrays, prompt=np.array(PROMPT[:-1] + [VOCAB], np.int32))),
         400),
        (peer, handoff.encode({k: v for k, v in meta.items()
                               if k != "length"}, arrays), 400)]
    for eng, payload, status in cases:
        with pytest.raises(ServingError) as e:
            eng.import_handoff(payload)
        assert e.value.status == status, (status, e.value.message)
    for eng in (peer, int8_port):
        rep = eng.load_report()
        assert rep["kv"] == {"64": {"free": 4, "slots": 4}}
        assert rep["queue_depth"] == 0
    assert peer.metrics.rejected_total["handoff"] >= len(cases) - 1


def test_full_queue_refuses_an_import_503(make_engine, engines):
    raw = export(engines["f32"][1])
    eng = make_engine(max_queue_depth=1, auto_start=False)
    eng.submit(PROMPT, 2)
    with pytest.raises(ServingError) as e:
        eng.import_handoff(raw)
    assert e.value.status == 503
    eng.start()


def test_drain_with_migration_splices_on_another_engine(make_engine,
                                                        engines):
    """Two streams on engine A when a migrating drain starts: each ends in
    a handoff line; imported into B, each continues with no duplicate and
    no gap."""
    peer = engines["f32"][2]
    prompts = [PROMPT, PROMPT[::-1]]
    want = [peer.generate(p, 12, **SEEDED)["tokens"] for p in prompts]
    a = make_engine(slots=2)
    chaos.add_rule("serving.decode_step", "delay", 0.03)
    handles = [a.submit(p, 12, **SEEDED) for p in prompts]
    heads, ends = [[], []], [None, None]
    started = threading.Event()

    def read(i):
        for kind, val in handles[i].events():
            if kind == "tok":
                heads[i].append(int(val))
                if len(heads[i]) == 2:
                    started.set()
            else:
                ends[i] = (kind, val)

    readers = [threading.Thread(target=read, args=(i,)) for i in (0, 1)]
    for t in readers:
        t.start()
    assert started.wait(RESULT_S)
    a.shutdown(drain=True, migrate=True, timeout=RESULT_S)
    for t in readers:
        t.join(RESULT_S)
    assert not any(t.is_alive() for t in readers)
    chaos.reset()
    for i in (0, 1):
        kind, obj = ends[i]
        assert kind == "handoff" and obj["streamed"] == len(heads[i])
        assert obj["n_tokens"] == len(heads[i])
        assert handles[i].result(0)["finish_reason"] == "migrated"
        tail, kind, _ = stream(peer.import_handoff(
            handoff.from_b64(obj["handoff"])))
        assert kind == "done" and heads[i] + tail == want[i]
    assert a.metrics.snapshot()["migrations_out_total"] == 2


# ===================================================== control-plane keys --
def test_control_plane_key_sets_equal_the_reference(engines):
    ref, port, _ = engines["f32"]
    assert set(port.health()) == set(ref.health())
    assert port.health()["kv_classes"] == ref.health()["kv_classes"] == [64]
    rep, jrep = port.load_report(), ref.load_report()
    assert set(rep) == set(jrep) and rep["kv"] == jrep["kv"]
    assert set(port.metrics.snapshot()) == set(ref.metrics.snapshot())
    jadd = ref.add_replica(warm=False)
    add = port.add_replica()
    assert set(jadd) - set(add) == {"persistent_hits", "persistent_misses"}
    assert set(add) <= set(jadd)
    assert add["warmed_executables"] == len(port._programs())
    assert port.add_replica(warm=False)["warmed_executables"] == 0

    def names(text):
        return [ln.split(" ")[2:4] for ln in text.splitlines()
                if ln.startswith("#")]

    assert names(port.metrics.prometheus_text()) == \
        names(ref.metrics.prometheus_text())
    help_ = [ln for ln in port.metrics.prometheus_text().splitlines()
             if ln.startswith("# HELP")]
    assert help_ == [ln for ln in ref.metrics.prometheus_text()
                     .splitlines() if ln.startswith("# HELP")]
