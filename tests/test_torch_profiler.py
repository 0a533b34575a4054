"""The port's profiler (paddle_tpu_torch/profiler and profiler/stats),
its metrics bus (observability/bus.py) and the fit loop's spans
(observability/trace.step_iter), against the JAX package's where both
compute the same thing: the summary tables of a known trace; the FLOPs
formulas exactly on the reference's shapes (tests/test_profiler_stats.py's
matmul and attention cases); the FLOPs a tiny GPT's forward books (the
products and the attention equal to the reference's, the attention one
event a layer, the flash call's own ops not booked apart, forward or
backward); the module name stack; the step records, the scheduler, the
memory series, a valid chrome trace, and the dispatch mode and module
hooks gone after stop(); the bus's providers (a raising one skipped),
its JSONL series and Prometheus textfile; the "serving" section of
summary_dict() while a predict engine lives and gone after (the
reference's tests/test_serving.py:332), and the fabric's, autoscale's
and input pipeline's sections."""
import gc
import json
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprof
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.profiler.stats import aggregator as jagg

from paddle_tpu_torch import io as tio
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.hapi import Model, callbacks
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import bus
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.profiler import stats
from paddle_tpu_torch.profiler.stats import aggregator, flops
from paddle_tpu_torch.static import InputSpec

torch.set_num_threads(1)


def _op(name, dur, fl, layer, cat="Operator"):
    return {"name": name, "ph": "X", "cat": cat, "ts": 0.0, "dur": dur,
            "args": {"flops": fl, "layer": layer}}


def _fwd(path, dur):
    return {"name": path, "ph": "X", "cat": "Forward", "ts": 0.0,
            "dur": dur}


EVENTS = [_op("mm", 100.0, 1000, "net.fc1"), _op("mm", 300.0, 1000,
                                                  "net.fc2"),
          _op("relu", 50.0, 10, "net"), _fwd("net", 500.0),
          _fwd("net.fc1", 150.0), _fwd("net.fc2", 320.0)]


class _FakeProf:
    def __init__(self, events, step_records=()):
        self._evs = events
        self.step_records = list(step_records)
        self._session = None
        self.kernels = {}
        self._jax_dir = None

    def events(self):
        return list(self._evs)


def _stat_tuple(st):
    return (st.name, st.calls, st.total, st.max, st.min, st.flops)


def test_known_trace_tables_equal_the_reference():
    got, want = aggregator.op_stats(EVENTS), jagg.op_stats(EVENTS)
    assert {k: _stat_tuple(v) for k, v in got.items()} == \
        {k: _stat_tuple(v) for k, v in want.items()}
    got, want = aggregator.layer_stats(EVENTS), jagg.layer_stats(EVENTS)
    assert {k: _stat_tuple(v) for k, v in got.items()} == \
        {k: _stat_tuple(v) for k, v in want.items()}
    p = _FakeProf(EVENTS, [{"step": 1, "time_ms": 0.45, "flops": 2010,
                            "flops_per_sec": 2010 / 0.45e-3, "mfu": 0.1}])
    text = stats.build_summary(p)
    for part in ("Operator Summary", "Layer Summary", "Step Summary",
                 "net.fc1", "MFU"):
        assert part in text
    d = stats.build_summary_dict(p, top_ops=2)
    assert (d["steps"], d["flops_per_step"], d["step_mfu"]) == (
        1, 2010, [0.1])
    assert d["top_ops"][0]["name"] == "mm" and d["top_ops"][0]["calls"] == 2


def test_device_merge_credits_one_op_each():
    ops = {n: aggregator.OpStat(n) for n in (
        "convolution", "convolution_backward", "mm",
        "scaled_dot_product_attention")}
    aggregator.merge_device_totals(ops, {
        "void convolution_backward_kernel<float>": 100.0,
        "convolution_fwd": 30.0,
        "void flash_fwd_mma_kernel<64, (Form)0, (Mode)0>(Params)": 7.0,
        "void (anonymous namespace)::flash_dq_mma_kernel<64, 0, 0>("
        "CUtensorMap_st)": 3.0,
        "sm90_xmma_gemm_bf16bf16": 5.0,
        "elementwise_kernel": 1.0})
    assert ops["convolution_backward"].device_total == 100.0
    assert ops["convolution"].device_total == 30.0
    assert ops["scaled_dot_product_attention"].device_total == 10.0
    assert ops["mm"].device_total == 5.0


def test_flops_formulas_on_the_reference_shapes():
    x = np.zeros((4, 8), np.float32)
    y = np.zeros((8, 16), np.float32)
    out = np.zeros((4, 16), np.float32)
    want = jdispatch.flops_for("matmul", [x, y], [out], {})
    assert want == 1024
    assert flops.flops_for("mm", [x, y], [out], {}) == want
    bx, by = np.zeros((3, 4, 8)), np.zeros((3, 8, 16))
    bo = np.zeros((3, 4, 16))
    assert flops.flops_for("bmm", [bx, by], [bo], {}) == \
        jdispatch.flops_for("bmm", [bx, by], [bo], {}) == 3 * 1024
    b = np.zeros(16, np.float32)
    # addmm (a Linear with its bias) books the reference's `linear`
    assert flops.flops_for("addmm", [b, x, y], [out], {}) == \
        jdispatch.flops_for("linear", [x, y, b], [out], {}) == 1024 + 64
    bb, ll, hh, dd = 2, 16, 4, 8
    q = np.zeros((bb, ll, hh, dd), np.float32)
    full = jdispatch.flops_for("scaled_dot_product_attention", [q, q, q],
                               [q], {})
    assert flops.attention_flops(q.shape, q.shape) == full == 65536
    assert flops.attention_flops(q.shape, q.shape, causal=True) == \
        jdispatch.flops_for("scaled_dot_product_attention", [q, q, q], [q],
                            {"is_causal": True}) == full // 2
    assert flops.flops_for("someramp", [out], [np.zeros((3, 5))], {}) == \
        jdispatch.flops_for("someramp", [out], [np.zeros((3, 5))], {}) == 15
    assert flops.flops_for("mm", [object()], [out], {}) == 0
    w = np.zeros((8, 3, 3, 3))
    co = np.zeros((2, 8, 6, 6))
    assert flops.flops_for("convolution", [np.zeros((2, 3, 6, 6)), w], [co],
                           {}) == jdispatch.flops_for(
        "conv2d", [np.zeros((2, 3, 6, 6)), w], [co], {})


def test_real_ops_book_the_counts_and_the_flash_call_is_one_event():
    x, y = torch.rand(4, 8), torch.rand(8, 16)
    q = torch.rand(2, 128, 4, 8, requires_grad=True)
    p = prof.Profiler(timer_only=True, with_flops=True)
    p.start()
    try:
        torch.mm(x, y)
        o = fa.flash_attention(q, q, q, causal=True)
        o.sum().backward()
    finally:
        p.stop()
    ops = aggregator.op_stats(p.events())
    assert ops["mm"].flops == 2 * 4 * 16 * 8 and ops["mm"].calls == 1
    att = ops["scaled_dot_product_attention"]
    assert att.calls == 1 and att.flops == 4 * 2 * 4 * 128 * 128 * 8 // 2
    # the plain version's products (its einsum's bmm) are not booked apart
    assert "bmm" not in ops
    assert q.grad is not None and torch.isfinite(q.grad).all()
    # outside a recording the call books nothing and costs no mode
    assert not stats.mode_installed() and stats.active() is None
    n = len(p.events())
    fa.flash_attention(q, q, q)
    torch.mm(x, y)
    assert len(p.events()) == n


def _gpts():
    cfg = JGPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                     num_heads=8, max_seq_len=128)
    paddle.seed(0)
    jm = JGPT(cfg)
    jm.eval()
    named = {n: np.asarray(v.numpy()) for n, v in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=256, hidden_size=128, num_layers=2, num_heads=8,
        max_seq_len=128), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(named))
    tm.eval()
    return jm, tm


def test_tiny_gpt_forward_flops_equal_the_reference():
    jm, tm = _gpts()
    ids = np.random.default_rng(0).integers(0, 256, (2, 128))
    jp = jprof.Profiler(timer_only=True, with_flops=True)
    jp.start()
    jm(paddle.to_tensor(ids))
    jp.stop()
    tp = prof.Profiler(timer_only=True, with_flops=True)
    tp.start()
    with torch.no_grad():
        tm(torch.from_numpy(ids))
    tp.stop()
    want, got = jagg.op_stats(jp.events()), aggregator.op_stats(tp.events())
    products = sum(got[n].flops for n in ("mm", "addmm", "bmm") if n in got)
    assert products == want["linear"].flops + want["matmul"].flops
    s_got = got["scaled_dot_product_attention"]
    s_want = want["scaled_dot_product_attention"]
    assert (s_got.calls, s_got.flops) == (s_want.calls, s_want.flops) == (
        2, 2 * 4 * 2 * 8 * 128 * 128 * 16 // 2)
    # the module name stack: every op books the path it ran under
    layers = aggregator.layer_stats(tp.events())
    assert {"gptforcausallm", "gptforcausallm.gpt.blocks.0",
            "gptforcausallm.gpt.blocks.1.attn.qkv_proj"} <= set(layers)
    assert layers["gptforcausallm"].flops == sum(
        e["args"]["flops"] for e in tp.events()
        if e.get("cat") == "Operator" and e["args"]["layer"])
    assert layers["gptforcausallm.gpt.blocks.0.attn"].flops > 0


def _mlp_steps(p, n):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    opt = optimizer.SGD(0.1, parameters=net.parameters())
    x, y = torch.rand(32, 8), torch.randint(0, 4, (32,))
    loss_fn = nn.CrossEntropyLoss()
    for _ in range(n):
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        p.step()
    return net


def test_steps_memory_summary_and_hooks_removed_after_stop(tmp_path):
    p = prof.Profiler(timer_only=True, with_flops=True, profile_memory=True,
                      record_shapes=True)
    with p:
        _mlp_steps(p, 3)
    recs = p.step_records
    assert [r["step"] for r in recs] == [1, 2, 3]
    per_step = 3 * 2 * 32 * (8 * 16 + 16 * 4)      # fwd + dX, dW products
    ops = aggregator.op_stats(p.events())
    prods = sum(ops[n].flops for n in ("mm", "addmm") if n in ops)
    assert prods >= per_step * 3 - 3 * 2 * 32 * 8 * 16  # no dX of layer 0
    for r in recs:
        assert r["flops"] > 0 and r["time_ms"] > 0
        assert r["mfu"] == pytest.approx(
            r["flops_per_sec"] / stats.device_peak_flops())
    mem = p._session.memory.steps
    assert len(mem) == 3 and all(m["alloc_bytes"] > 0 for m in mem)
    peaks = [m["peak_bytes"] for m in mem]
    assert peaks == sorted(peaks)
    d = p.summary_dict()
    assert d["memory"]["peak_bytes"] == peaks[-1] and d["steps"] == 3
    assert stats.device_peak_flops() == 1e12      # the CPU's nominal peak
    text = p.summary()
    assert "Memory Summary" in text and "Step Summary" in text
    # chrome trace: valid JSON, every span with ts/dur/pid/tid
    path = p.export(str(tmp_path / "t.json"))
    with open(path) as f:
        obj = json.load(f)
    spans = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert {"ProfileStep#1", "ProfileStep#3", "addmm"} <= \
        {e["name"] for e in spans}
    assert all({"ts", "dur", "pid", "tid"} <= set(e) for e in spans)
    assert any(e["ph"] == "M" for e in obj["traceEvents"])
    # everything is gone after stop()
    assert not stats.mode_installed() and not prof._HOOKS
    assert not prof._enabled and prof.running() is None
    n = len(p.events())
    _mlp_steps(prof.Profiler(), 1)
    assert len(p.events()) == n
    # on_trace_ready and the chrome-trace handler
    q = prof.Profiler(timer_only=True, on_trace_ready=prof.
                      export_chrome_tracing(str(tmp_path / "h"), "w"))
    with q:
        torch.mm(torch.rand(2, 2), torch.rand(2, 2))
    assert prof.load_profiler_result(str(tmp_path / "h" /
                                         "w.chrometrace.json"))


def test_scheduler_records_only_record_steps():
    sched = prof.make_scheduler(closed=1, ready=1, record=2)
    jsched = jprof.make_scheduler(closed=1, ready=1, record=2)
    assert [sched(s).name for s in range(9)] == \
        [jsched(s).name for s in range(9)]
    p = prof.Profiler(scheduler=sched, timer_only=True, with_flops=True)
    with p:
        _mlp_steps(p, 6)
    # states: 0 closed, 1 ready, 2-3 record, 4 closed, 5 ready
    assert [r["step"] for r in p.step_records] == [3, 4]
    names = {e["name"] for e in p.events()}
    assert {"ProfileStep#3", "ProfileStep#4"} <= names
    assert "ProfileStep#1" not in names and not stats.mode_installed()


def test_profiler_callback_in_fit_and_telemetry(tmp_path):
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 3))
    model = Model(net)
    model.prepare(optimizer.Adam(1e-2, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    pcb = callbacks.ProfilerCallback(
        scheduler=prof.make_scheduler(closed=1, ready=1, record=2),
        print_summary=False)
    bus.BUS.reset()
    set_flags({"metrics_dir": str(tmp_path)})
    try:
        model.fit(_ArrayDS(x, y), batch_size=8, epochs=1, verbose=0,
                  callbacks=[pcb])
    finally:
        set_flags({"metrics_dir": ""})
    assert [r["step"] for r in pcb.profiler.step_records] == [3, 4]
    assert "Operator Summary" in pcb.last_summary
    rows = bus.series()
    assert len(rows) == 5 and rows[0]["step"] == 0
    # the TelemetryCallback fit added rode the ProfilerCallback's
    # profiler: FLOPs (and MFU) on the recorded steps only
    assert [r["flops"] > 0 for r in rows] == [False, False, True, True,
                                              False]
    assert all(r["mfu"] >= 0 for r in rows)
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines] == [0, 1, 2, 3, 4]
    prom = (tmp_path / "metrics.prom").read_text()
    assert "paddle_train_steps_total 5" in prom
    assert "paddle_train_loss " in prom
    bus.BUS.reset()


class _ArrayDS(tio.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_telemetry_callback_with_a_profiler_of_its_own(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, 8)).astype(np.float32)
    y = rng.integers(0, 3, 24)
    net = nn.Sequential(nn.Linear(8, 3))
    model = Model(net)
    model.prepare(optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    bus.BUS.reset()
    tel = callbacks.TelemetryCallback(flush_every=2)
    set_flags({"metrics_dir": str(tmp_path)})
    try:
        model.fit(_ArrayDS(x, y), batch_size=8, epochs=1, verbose=0,
                  callbacks=[tel])
    finally:
        set_flags({"metrics_dir": ""})
    rows = bus.series()
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(r["flops"] > 0 and r["loss"] > 0 for r in rows)
    assert {"queue_depth", "starvation_fraction"} <= set(rows[0])
    assert prof.running() is None and not stats.mode_installed()
    assert (tmp_path / "metrics.prom").exists()
    bus.BUS.reset()


def test_bus_providers_series_and_files(tmp_path, caplog):
    b = bus.MetricsBus()
    b.register_provider("good", lambda: {"x": 1})
    b.register_provider("empty", lambda: None)
    b.register_provider("bad", lambda: 1 / 0)
    assert b.collect() == {"good": {"x": 1}}
    assert b.collect() == {"good": {"x": 1}}
    assert b.provider_error_counts() == {"bad": 2}
    assert sum("bad" in r.message for r in caplog.records) == 1
    b.register_provider("good", lambda: {"x": 2})
    assert b.collect()["good"] == {"x": 2}
    b.unregister_provider("bad")
    assert b.provider_error_counts() == {}
    with pytest.raises(TypeError):
        b.register_provider("x", 3)
    row = b.record_step(step=1, loss=float("nan"), name="a", ok=True)
    assert row["loss"] is None and row["name"] == "a" and row["ok"] is True
    assert b.flush() is None
    set_flags({"metrics_dir": str(tmp_path)})
    try:
        b.record_step(step=2, loss=0.5, mfu=0.25)
        path = b.flush()
    finally:
        set_flags({"metrics_dir": ""})
    text = open(path).read()
    assert "paddle_train_steps_total 2" in text
    assert "paddle_train_mfu 0.25" in text
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["step"] == 2
    assert len(b.series()) == 2 and b.last()["loss"] == 0.5
    b.reset()
    assert b.series() == [] and b.last() is None


def test_serving_section_lives_with_its_engine(tmp_path):
    from paddle_tpu_torch.inference import ServingEngine

    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(8, 4)).eval()
    prefix = str(tmp_path / "mlp")
    jit.save(m, prefix, input_spec=[InputSpec([None, 8], "float32")],
             device="cpu")
    eng = ServingEngine(prefix, device="cpu")
    try:
        eng.predict([np.zeros((1, 8), "float32")], timeout=60)
        with prof.profiler_guard(timer_only=True) as p:
            pass
        d = p.summary_dict()
        assert d["serving"]["requests_total"] >= 1
        assert d["serving"]["batches_total"] >= 1
    finally:
        eng.shutdown()
    del eng
    gc.collect()
    assert "serving" not in p.summary_dict()


def test_fabric_and_autoscale_sections():
    from paddle_tpu_torch import autoscale
    from paddle_tpu_torch.inference.fabric import metrics as fmetrics

    class Router:
        class metrics:  # noqa: N801
            @staticmethod
            def snapshot():
                return {"forwards_total": 3}

    class Controller:
        counters = {"scale_ups": 2}

    r, c = Router(), Controller()
    fmetrics.track_router(r)
    autoscale._track(c)
    d = stats.build_summary_dict(_FakeProf([]))
    assert d["fabric"]["forwards_total"] >= 3
    assert d["autoscale"]["scale_ups"] >= 2
    del r, c
    gc.collect()
    d = stats.build_summary_dict(_FakeProf([]))
    assert "fabric" not in d and "autoscale" not in d


def test_fit_steps_run_under_train_step_spans(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 8)).astype(np.float32)
    y = rng.integers(0, 3, 24)
    net = nn.Sequential(nn.Linear(8, 3))
    model = Model(net)
    model.prepare(optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    trace.reset()
    set_flags({"trace_dir": str(tmp_path)})
    try:
        model.fit(_ArrayDS(x, y), batch_size=8, epochs=2, num_iters=5,
                  verbose=0)
        spans = trace.spans()
    finally:
        set_flags({"trace_dir": ""})
        trace.reset()
    roots = [s for s in spans if s["name"] == "train.step"]
    waits = [s for s in spans if s["name"] == "train.data_wait"]
    assert len(roots) == len(waits) == 5
    assert {w["args"]["parent"] for w in waits} == \
        {r["args"]["span"] for r in roots}
    # off, the wrapper passes items through
    assert list(trace.step_iter(iter([1, 2]))) == [1, 2]
    assert math.isfinite(model.evaluate(_ArrayDS(x, y), batch_size=8,
                                        verbose=0)["loss"])
