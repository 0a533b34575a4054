"""The port's dynamic-batching predict engine and its HTTP front
(paddle_tpu_torch.inference.serving.engine, server.py's /predict) on the
CPU, case for case the reference's TestEngine and TestHTTPServer
(tests/test_serving.py), and against the reference engine.

Both packages save the same MLP (Linear(8, 16), GELU, Linear(16, 4), the
same numpy weights); each engine serves its own package's program. Where
a test decides batch membership it builds the engine with
auto_start=False, queues the requests, then starts the batcher, as the
reference's tests do, so that both engines form the same batches: their
outputs agree within 1e-5 and their occupancy histograms are equal.
The control-plane dicts (health, load_report, warmup_report, the scale
reports, replica rows, the metrics snapshot) and the /metrics families
have the reference's key sets, except the persistent compile cache's
keys (`persistent_hits`, `persistent_misses`, `persistent_cache_enabled`),
which the port has no counterpart of (eager PyTorch compiles nothing).
The reference's lockcheck/racecheck module fixture, its profiler
summary_dict test and its warm-restart compile-cache test have no
counterpart (ROADMAP). Every engine is shut down by a finalizer, and every
result() has a timeout.
"""
import base64
import http.client
import io
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import jit as jjit
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.inference.serving import ServingHTTPServer as JServer
from paddle_tpu.static import InputSpec as JInputSpec

from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import (GenerativeEngine, ServingEngine,
                                        ServingError, ServingHTTPServer)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.testing import chaos

from test_torch_inference import mlp_weights, port_mlp, reference_mlp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6     # a batch's row against the eager row
CROSS_ATOL = 1e-5           # the port's engine against the reference's
RESULT_S = 60
CLI_S = 60
# the reference's persistent compile cache: no counterpart in the port
PERSISTENT = {"persistent_hits", "persistent_misses",
              "persistent_cache_enabled"}
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(reference prefix, port prefix, port eager model)."""
    d = tmp_path_factory.mktemp("serving")
    weights = mlp_weights()
    jjit.save(reference_mlp(weights), str(d / "ref"),
              input_spec=[JInputSpec([None, 8], "float32")])
    tm = port_mlp(weights)
    jit.save(tm, str(d / "port"), input_spec=[InputSpec([None, 8],
                                                        "float32")],
             device="cpu")
    return str(d / "ref"), str(d / "port"), tm


@pytest.fixture
def engines(request):
    """make(prefix, reference=False, **kw): an engine shut down (without
    draining) when the test ends."""
    made = []

    def make(prefix, reference=False, **kw):
        kw.setdefault("max_batch_size", 4)
        kw.setdefault("batch_timeout_ms", 20)
        kw.setdefault("replicas", 2)
        eng = JEngine(prefix, **kw) if reference else \
            ServingEngine(prefix, device="cpu", **kw)
        made.append(eng)
        return eng

    request.addfinalizer(lambda: [e.shutdown(drain=False) for e in made])
    return make


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def eager(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(np.asarray(x))).numpy()


def rows(i, n, seed_base=0):
    return np.random.RandomState(seed_base + i).randn(n, 8) \
        .astype("float32")


# ================================================================ engine --
def test_concurrent_clients_order_matched_and_batched(saved, engines):
    """Each client gets its own rows back, the batcher coalesced
    (occupancy > 1), and the reference engine, given the same queue,
    forms the same batches and the same outputs."""
    ref, port, tm = saved
    xs = [rows(i, 1 + i % 3) for i in range(10)]
    outs = {}
    for name, eng in (("port", engines(port, auto_start=False)),
                      ("ref", engines(ref, reference=True,
                                      auto_start=False))):
        futs = [eng.submit([x]) for x in xs]
        eng.start()
        outs[name] = [f.result(RESULT_S)[0] for f in futs]
        outs[name + "_snap"] = eng.metrics.snapshot()
        assert eng.metrics.max_occupancy() > 1
        assert eng.metrics.batches_total < len(xs)
    for x, got, want in zip(xs, outs["port"], outs["ref"]):
        assert got.shape == (x.shape[0], 4)
        np.testing.assert_allclose(got, eager(tm, x), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)
    assert outs["port_snap"]["occupancy_hist"] == \
        outs["ref_snap"]["occupancy_hist"]
    assert outs["port_snap"]["rows_total"] == outs["ref_snap"]["rows_total"]


def test_threaded_submitters(saved, engines):
    _, port, tm = saved
    eng = engines(port, batch_timeout_ms=10)
    results = {}

    def client(i):
        x = rows(100 + i, 1)
        (out,) = eng.predict([x], timeout=RESULT_S)
        results[i] = (x, out)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(RESULT_S)
    assert len(results) == 16
    for x, out in results.values():
        np.testing.assert_allclose(out, eager(tm, x), rtol=RTOL, atol=ATOL)


def test_bad_request_rejected_batchmates_succeed(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    good = [eng.submit([rows(i, 1)]) for i in range(3)]
    for bad in ([np.zeros((1, 5), "float32")],            # feature dim
                [np.zeros((1, 8), "float32")] * 2,        # input count
                [np.zeros((99, 8), "float32")]):          # > max batch
        with pytest.raises(ServingError) as e:
            eng.submit(bad)
        assert e.value.status == 400
    eng.start()
    for f in good:
        (out,) = f.result(RESULT_S)
        assert out.shape == (1, 4)
    assert eng.metrics.snapshot()["rejected_total"] == 3


def test_batch_failure_splits_and_isolates_culprit(saved, engines):
    _, port, tm = saved
    eng = engines(port, auto_start=False)
    orig = eng._run_on_device

    def poisoned(arrays):
        if np.any(arrays[0] == 777.0):
            raise RuntimeError("injected runtime failure")
        return orig(arrays)

    eng._run_on_device = poisoned
    x_good = rows(0, 1)
    f_good = eng.submit([x_good])
    f_bad = eng.submit([np.full((1, 8), 777.0, "float32")])
    eng.start()
    (out,) = f_good.result(RESULT_S)
    np.testing.assert_allclose(out, eager(tm, x_good), rtol=RTOL, atol=ATOL)
    with pytest.raises(ServingError) as e:
        f_bad.result(RESULT_S)
    assert e.value.status == 500
    snap = eng.metrics.snapshot()
    assert snap["batch_splits_total"] == 1 and snap["failed_total"] == 1


def test_transient_batch_failure_retries_halves_ok(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    orig = eng._run_on_device
    state = {"failed": False}

    def flaky(arrays):
        if arrays[0].shape[0] >= 2 and not state["failed"]:
            state["failed"] = True
            raise RuntimeError("transient")
        return orig(arrays)

    eng._run_on_device = flaky
    futs = [eng.submit([rows(i, 1)]) for i in range(4)]
    eng.start()
    for f in futs:
        (out,) = f.result(RESULT_S)
        assert out.shape == (1, 4)
    assert eng.metrics.snapshot()["batch_splits_total"] == 1


def test_worker_survives_assembly_failure(saved, engines):
    _, port, tm = saved
    eng = engines(port, replicas=1, auto_start=False)
    orig = eng._run_group
    state = {"boom": True}

    def exploding(rep, gen, group, allow_split):
        if state["boom"]:
            state["boom"] = False
            raise MemoryError("injected assembly failure")
        return orig(rep, gen, group, allow_split)

    eng._run_group = exploding
    f1 = eng.submit([np.zeros((1, 8), "float32")])
    eng.start()
    with pytest.raises(ServingError) as e:
        f1.result(RESULT_S)
    assert e.value.status == 500
    x = rows(0, 1)
    (out,) = eng.predict([x], timeout=RESULT_S)
    np.testing.assert_allclose(out, eager(tm, x), rtol=RTOL, atol=ATOL)


def test_shutdown_drains_inflight(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    futs = [eng.submit([rows(i, 2)]) for i in range(8)]
    eng.start()
    eng.shutdown(drain=True)
    assert all(f.done() for f in futs)
    for f in futs:
        (out,) = f.result(0)
        assert out.shape == (2, 4)
    with pytest.raises(ServingError) as e:
        eng.submit([np.zeros((1, 8), "float32")])
    assert e.value.status == 503


def test_shutdown_no_drain_fails_queued(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    futs = [eng.submit([np.zeros((1, 8), "float32")]) for _ in range(3)]
    eng.shutdown(drain=False)
    for f in futs:
        with pytest.raises(ServingError) as e:
            f.result(5)
        assert e.value.status == 503


def test_deadline_expiry_503(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    f_dead = eng.submit([np.zeros((1, 8), "float32")], deadline_ms=10)
    f_live = eng.submit([np.ones((1, 8), "float32")])
    time.sleep(0.08)
    eng.start()
    with pytest.raises(ServingError) as e:
        f_dead.result(30)
    assert e.value.status == 503
    (out,) = f_live.result(30)
    assert out.shape == (1, 4)
    assert eng.metrics.snapshot()["deadline_expired_total"] == 1


def test_circuit_breaker_sheds_with_retry_after(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False, max_queue_depth=2)
    f1 = eng.submit([np.zeros((1, 8), "float32")])
    f2 = eng.submit([np.zeros((1, 8), "float32")])
    with pytest.raises(ServingError) as e:
        eng.submit([np.zeros((1, 8), "float32")])
    assert e.value.status == 503
    assert e.value.retry_after is not None and e.value.retry_after > 0
    assert eng.metrics.snapshot()["shed_total"] == 1
    # while an autoscaler reports headroom the bound stretches (2 x 2)
    eng.scale_headroom_fn = lambda: 1
    f3 = eng.submit([np.zeros((1, 8), "float32")])
    eng.start()
    for f in (f1, f2, f3):
        f.result(RESULT_S)


class _RowSum(torch.nn.Module):
    def forward(self, x):
        return x.sum(dim=1)


class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2


def test_seq_bucketing_coalesces_near_lengths(tmp_path, engines):
    """Dynamic non-batch axes pad to seq buckets, so near-length requests
    share one shape (a padding-invariant model: row sums)."""
    prefix = str(tmp_path / "rowsum")
    jit.save(_RowSum(), prefix, input_spec=[InputSpec([None, None],
                                                      "float32")],
             device="cpu")
    eng = engines(prefix, replicas=1, seq_boundaries=[4, 8],
                  auto_start=False)
    xs = [np.random.RandomState(i).randn(n, length).astype("float32")
          for i, (n, length) in enumerate(((1, 3), (1, 4), (2, 7)))]
    futs = [eng.submit([x]) for x in xs]
    eng.start()
    for x, f in zip(xs, futs):
        (out,) = f.result(RESULT_S)
        np.testing.assert_allclose(out, x.sum(axis=1), rtol=1e-5,
                                   atol=1e-6)
    snap = eng.metrics.snapshot()
    assert any(k.endswith(":4") and v["compiles"] + v["hits"] > 0
               for k, v in snap["buckets"].items())
    assert snap["occupancy_hist"].get(2, 0) >= 1
    # every shape was run by the warm-up: no served batch was a first call
    assert all(v["compiles"] == 0 for v in snap["buckets"].values())


def test_static_batch_and_rank0_inputs_rejected(tmp_path):
    """The engine batches along dim 0: a static batch dim and a rank-0
    input are refused, as the reference refuses them."""
    prefix = str(tmp_path / "static_batch")
    jit.save(torch.nn.Sequential(torch.nn.Linear(4, 2)), prefix,
             input_spec=[InputSpec([2, 4], "float32")], device="cpu")
    with pytest.raises(ValueError, match="STATIC batch dim"):
        ServingEngine(prefix, warmup=False, auto_start=False, device="cpu")
    prefix = str(tmp_path / "rank0")
    jit.save(_Double(), prefix, input_spec=[InputSpec([], "float32")],
             device="cpu")
    with pytest.raises(ValueError, match="rank-0"):
        ServingEngine(prefix, warmup=False, auto_start=False, device="cpu")


def test_control_plane_dicts_have_the_reference_keys(saved, engines):
    ref, port, _ = saved
    eng = engines(port)
    jeng = engines(ref, reference=True)
    for e in (eng, jeng):
        e.predict([rows(0, 1)], timeout=RESULT_S)
    assert set(eng.health()) == set(jeng.health())
    # one shape per batch bucket on the port's one device (the
    # reference's replicas sit on two of its eight CPU devices: 6)
    assert eng.health()["warmed_executables"] == 3
    assert set(eng.load_report()) == set(jeng.load_report())
    assert set(jeng.warmup_report) - set(eng.warmup_report) == PERSISTENT
    assert set(eng.warmup_report) <= set(jeng.warmup_report)
    assert set(eng.replica_states()[0]) == set(jeng.replica_states()[0])
    assert set(eng.metrics.snapshot()) == set(jeng.metrics.snapshot())
    add, jadd = eng.add_replica(), jeng.add_replica()
    assert set(jadd) - set(add) == {"persistent_hits", "persistent_misses"}
    assert set(add) <= set(jadd) and add["warmed_executables"] == 3
    assert eng.health()["replicas"] == 3
    rev = eng.revive_replica(add["rid"])
    assert set(rev) == set(jeng.revive_replica(jadd["rid"]))
    assert rev["generation"] == 1
    rem = eng.remove_replica(add["rid"])
    assert set(rem) == set(jeng.remove_replica(jadd["rid"]))
    assert rem["drained"] and rem["state"] == "retired"
    with pytest.raises(ValueError, match="not the Predictor's"):
        eng.add_replica(device="cuda:0")


def test_metrics_families_are_the_reference_ones(saved, engines):
    ref, port, _ = saved
    texts = []
    for eng in (engines(port), engines(ref, reference=True)):
        eng.predict([rows(0, 1)], timeout=RESULT_S)
        texts.append(eng.metrics.prometheus_text())

    def families(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}

    assert families(texts[0]) == families(texts[1])
    assert 'paddle_serving_bucket_executions{bucket="1"' in texts[0]


def test_chaos_at_serving_execute_fails_the_batch(saved, engines):
    """The `serving.execute` site fires before every device batch: an
    error there fails that batch 500 and the worker keeps serving."""
    _, port, _ = saved
    eng = engines(port, replicas=1)
    chaos.add_rule("serving.execute", "raise_n", 1, match={"replica": 0})
    with pytest.raises(ServingError) as e:
        eng.predict([rows(0, 1)], timeout=RESULT_S)
    assert e.value.status == 500
    (out,) = eng.predict([rows(1, 1)], timeout=RESULT_S)
    assert out.shape == (1, 4)
    assert chaos.counters()["hits"]["serving.execute"] == 2


def test_spans_chain_a_request_through_the_predictor_stages(saved, engines,
                                                            tmp_path):
    """FLAGS_trace_dir turns the tracer on: a request's enqueue, queue
    wait, execute and reply spans share its trace id, and the execute
    span holds the Predictor's three stages (inputs to the device, the
    program, outputs to the host) in that order."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.observability import trace

    _, port, tm = saved
    eng = engines(port, replicas=1)
    set_flags({"trace_dir": str(tmp_path)})
    try:
        trace.reset()
        x = rows(0, 2)
        (out,) = eng.predict([x], timeout=RESULT_S)
        spans = trace.spans()
    finally:
        set_flags({"trace_dir": ""})
    np.testing.assert_allclose(out, eager(tm, x), rtol=RTOL, atol=ATOL)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    (enq,) = by_name["serving.enqueue"]
    tid = enq["args"]["trace"]
    (ex,) = by_name["serving.execute"]
    for name in ("serving.queue_wait", "serving.execute", "serving.reply"):
        assert [e["args"]["trace"] for e in by_name[name]] == [tid], name
    stages = [by_name[n][0] for n in ("predictor.h2d", "predictor.forward",
                                      "predictor.d2h")]
    for st in stages:
        assert st["args"]["trace"] == tid
        assert st["args"]["parent"] == ex["args"]["span"]
        assert ex["ts"] <= st["ts"] and \
            st["ts"] + st["dur"] <= ex["ts"] + ex["dur"] + 1e-3
    assert [st["ts"] for st in stages] == sorted(st["ts"] for st in stages)
    # the outputs' bytes: one padded batch bucket of 2 rows x 4 f32
    assert stages[2]["args"]["bytes"] == 2 * 4 * 4
    assert not trace.enabled()


# ================================================================== HTTP --
def _post(url, body, ctype, timeout=RESULT_S):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with OPENER.open(req, timeout=timeout) as r:
        return r.read()


def _get(url, timeout=30):
    with OPENER.open(url, timeout=timeout) as r:
        return r.status, r.read()


def _raw_body(arrays):
    return b"".join(struct.pack("<Q", len(a.tobytes())) + a.tobytes()
                    for a in arrays)


def _raw_reply(reply):
    buf = io.BytesIO(reply)
    (n,) = struct.unpack("<I", buf.read(4))
    outs = []
    for _ in range(n):
        (dl,) = struct.unpack("<Q", buf.read(8))
        dtype = buf.read(dl).decode()
        (nd,) = struct.unpack("<I", buf.read(4))
        dims = struct.unpack(f"<{nd}q", buf.read(8 * nd))
        (nb,) = struct.unpack("<Q", buf.read(8))
        outs.append(np.frombuffer(buf.read(nb), dtype).reshape(dims))
    return outs


@pytest.fixture
def servers(saved, engines, request):
    """(port server, reference server), each over its own engine."""
    ref, port, _ = saved
    srv = ServingHTTPServer(engines(port, batch_timeout_ms=5),
                            admin=True).start()
    jsrv = JServer(engines(ref, reference=True, batch_timeout_ms=5),
                   admin=True).start()
    request.addfinalizer(lambda: (srv.stop(drain=False),
                                  jsrv.stop(drain=False)))
    return srv, jsrv


def test_predict_json_b64_nested_and_raw_equal_the_reference(servers,
                                                             saved):
    srv, jsrv = servers
    tm = saved[2]
    X = rows(0, 3)
    bodies = [
        (json.dumps({"inputs": [{
            "b64": base64.b64encode(X.tobytes()).decode(),
            "dtype": "float32", "shape": [3, 8]}]}).encode(),
         "application/json"),
        (json.dumps({"inputs": [X.tolist()]}).encode(), "application/json"),
        (_raw_body([X]), "application/octet-stream")]
    for body, ctype in bodies:
        got = []
        for s in (srv, jsrv):
            reply = _post(f"http://127.0.0.1:{s.port}/predict", body, ctype)
            if ctype == "application/json":
                out = json.loads(reply)["outputs"][0]
                assert out["dtype"] == "float32" and out["shape"] == [3, 4]
                got.append(np.frombuffer(base64.b64decode(out["b64"]),
                                         out["dtype"]).reshape(out["shape"]))
            else:
                (o,) = _raw_reply(reply)
                got.append(o)
        np.testing.assert_allclose(got[0], eager(tm, X), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[0], got[1], rtol=0, atol=CROSS_ATOL)


def test_bad_json_and_wrong_shape_400(servers):
    srv, _ = servers
    url = f"http://127.0.0.1:{srv.port}/predict"
    for body in (b"{not json",
                 json.dumps({"inputs": [np.zeros((1, 5)).tolist()]})
                 .encode()):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body, "application/json")
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, b"\x01\x00", "application/octet-stream")
    assert e.value.code == 400


def test_oversized_body_413_no_keepalive_desync(saved, engines):
    _, port, _ = saved
    srv = ServingHTTPServer(engines(port, batch_timeout_ms=5),
                            max_body_bytes=1024).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        conn.request("POST", "/predict", body=b"x" * 4096,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 413
        assert r.getheader("Connection") == "close"
        r.read()
        conn.close()
        body = json.dumps({"inputs": [rows(0, 1).tolist()]}).encode()
        out = json.loads(_post(f"http://127.0.0.1:{srv.port}/predict",
                               body, "application/json"))
        assert out["outputs"][0]["shape"] == [1, 4]
    finally:
        srv.stop()


def test_healthz_metrics_admin_and_load_report(servers):
    srv, jsrv = servers
    url = f"http://127.0.0.1:{srv.port}"
    body = json.dumps({"inputs": [rows(0, 1).tolist()]}).encode()
    _post(url + "/predict", body, "application/json")
    status, h = _get(url + "/healthz")
    h = json.loads(h)
    assert status == 200 and h["status"] == "ok" and h["replicas"] == 2
    _, m = _get(url + "/metrics")
    m = m.decode()
    assert "paddle_serving_requests_total" in m
    assert "paddle_serving_latency_seconds" in m
    assert 'paddle_serving_bucket_executions{bucket="1"' in m
    _, reps = _get(url + "/admin/replicas")
    reps = json.loads(reps)["replicas"]
    assert [r["front"] for r in reps] == ["predict", "predict"]
    scale = url + "/admin/scale"
    rep = json.loads(_post(scale, json.dumps({"action": "add"}).encode(),
                           "application/json"))
    assert rep["admitted_after_warmup"] and rep["warmed_executables"] == 3
    with pytest.raises(urllib.error.HTTPError) as e:     # no such replica
        _post(scale, json.dumps({"action": "revive", "rid": 99}).encode(),
              "application/json")
    assert e.value.code == 409
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(scale, json.dumps({"front": "generate",
                                 "action": "add"}).encode(),
              "application/json")
    assert e.value.code == 400
    assert set(srv.load_report()) == set(jsrv.load_report())
    assert set(srv.load_report()["fronts"]["predict"]) == \
        set(jsrv.load_report()["fronts"]["predict"])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", b"{}", "application/json")
    assert e.value.code == 404


def test_metrics_show_occupancy_under_concurrency(saved, engines):
    _, port, _ = saved
    eng = engines(port, auto_start=False)
    srv = ServingHTTPServer(eng).start()
    url = f"http://127.0.0.1:{srv.port}"
    results = []

    def client(i):
        body = json.dumps({"inputs": [rows(i, 1).tolist()]}).encode()
        results.append(_post(url + "/predict", body, "application/json"))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for _ in range(500):
        if eng.metrics.snapshot()["requests_total"] >= 6:
            break
        time.sleep(0.01)
    eng.start()
    for t in threads:
        t.join(RESULT_S)
    assert len(results) == 6
    _, m = _get(url + "/metrics")
    occupancies = [int(line.split('occupancy="')[1].split('"')[0])
                   for line in m.decode().splitlines()
                   if line.startswith("paddle_serving_batch_occupancy_total{")]
    assert occupancies and max(occupancies) > 1
    srv.stop()


def test_both_fronts_on_one_server(saved, engines):
    """A host of both fronts: /predict and /generate answer, /healthz
    nests the generation engine's health, /metrics carries both
    families, the load report sums both fronts, and a drain stops both."""
    _, port, tm = saved
    eng = engines(port, batch_timeout_ms=5)
    gen = GenerativeEngine(
        tgpt.GPTForCausalLM(tgpt.GPTConfig(vocab_size=64, hidden_size=32,
                                           num_layers=1, num_heads=2,
                                           max_seq_len=32), device="cpu",
                            generator=torch.Generator().manual_seed(0)),
        slots=2, max_context=32, device="cpu")
    srv = ServingHTTPServer(eng, generator=gen, admin=True).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        X = rows(3, 2)
        (out,) = _raw_reply(_post(url + "/predict", _raw_body([X]),
                                  "application/octet-stream"))
        np.testing.assert_allclose(out, eager(tm, X), rtol=RTOL, atol=ATOL)
        toks = json.loads(_post(url + "/generate", json.dumps(
            {"input_ids": [1, 2, 3], "max_new_tokens": 2}).encode(),
            "application/json"))["tokens"]
        assert len(toks) == 2
        _, h = _get(url + "/healthz")
        h = json.loads(h)
        assert h["status"] == "ok" and h["generation"]["status"] == "ok"
        _, m = _get(url + "/metrics")
        assert "paddle_serving_requests_total" in m.decode()
        assert "paddle_generate_requests_total" in m.decode()
        rep = srv.load_report()
        assert set(rep["fronts"]) == {"predict", "generate"}
        assert rep["replicas"] == 3 and "kv" in rep
        _, reps = _get(url + "/admin/replicas")
        assert sorted(r["front"] for r in json.loads(reps)["replicas"]) \
            == ["generate", "predict", "predict"]
        srv.drain_async()
        deadline = time.monotonic() + RESULT_S
        while eng.health()["status"] == "ok" or \
                gen.health()["status"] == "ok":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/healthz")
        assert e.value.code == 503
    finally:
        srv.stop(drain=False)


# =================================================================== CLI --
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_engine_http_serves_a_saved_model(saved, tmp_path):
    """`python -m paddle_tpu_torch.inference.serve PREFIX --engine --http
    PORT --device cpu` in a subprocess: /healthz, then raw-binary and JSON
    /predict against the eager model."""
    _, port_prefix, tm = saved
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
         port_prefix, "--engine", "--http", str(port), "--device", "cpu",
         "--max-batch-size", "4", "--batch-timeout-ms", "5",
         "--replicas", "2"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + CLI_S
        while True:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            try:
                if _get(url + "/healthz", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert time.monotonic() < deadline, "the CLI did not answer"
            time.sleep(0.2)
        X = rows(9, 3)
        (out,) = _raw_reply(_post(url + "/predict", _raw_body([X]),
                                  "application/octet-stream"))
        np.testing.assert_allclose(out, eager(tm, X), rtol=RTOL, atol=ATOL)
        body = json.dumps({"inputs": [X.tolist()]}).encode()
        got = json.loads(_post(url + "/predict", body,
                               "application/json"))["outputs"][0]
        np.testing.assert_array_equal(
            np.frombuffer(base64.b64decode(got["b64"]), "float32")
            .reshape(got["shape"]), out)
        _, h = _get(url + "/healthz")
        assert json.loads(h)["replicas"] == 2
    finally:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
