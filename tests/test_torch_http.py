"""The port's HTTP serving front (paddle_tpu_torch/inference/serving/
server.py) and its CLI (paddle_tpu_torch/inference/serve.py) on the CPU:
ServingHTTPServer on 127.0.0.1:0 over a port GenerativeEngine (the
handoff tests' tiny model: vocab 64, hidden 32, 2 layers, 2 heads,
max_seq_len 64, weights drawn from numpy; 4 slots, max_context 64, a cap
of 16 new tokens), against the engine's own tokens and against the
reference server over the reference engine on the same weights: the
/generate bodies and ndjson lines, /healthz, /metrics, the status codes
(400, 404, 409, 413, 503), the admin plane (/admin/kv, /admin/kv/import,
/admin/scale, /admin/drain with migration), and the CLI in a subprocess
serving a checkpoint that the reference's paddle_tpu.save wrote (its
gpt3-tiny), with the reference engine's tokens on the same prompt.
Tokens compare exactly (deterministic decoding; top-2 margins far above
the packages' f32 rounding)."""
import json
import os
import pickle
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.inference.serving import ServingHTTPServer as JaxServer
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.models.gpt import PRESETS as JAX_PRESETS

from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import GenerativeEngine, ServingHTTPServer
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.fabric import handoff
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import chaos

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
ENGINE = dict(slots=4, max_context=64, max_new_tokens_cap=16)
SEEDED = {"temperature": 0.9, "top_k": 8, "seed": 3}
PROMPT = list(range(1, 14))
NEW = 8
RESULT_S = 60
CLI_S = 60            # the CLI's start-up and first answer
# every request goes to 127.0.0.1: consult no proxy
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


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
def served(models, request):
    """(port engine, its admin server's base URL)."""
    eng = GenerativeEngine(models[1], device="cpu", **ENGINE)
    srv = ServingHTTPServer(generator=eng, admin=True).start()
    request.addfinalizer(lambda: srv.stop(drain=False))
    return eng, f"http://127.0.0.1:{srv.port}"


@pytest.fixture
def make_served(models, request):
    """A fresh port engine behind a server of its own (for tests that
    drain or bound it)."""
    made = []

    def make(server_kw=None, **kw):
        eng = GenerativeEngine(models[1], device="cpu",
                               **dict(ENGINE, **kw))
        srv = ServingHTTPServer(generator=eng, admin=True,
                                **(server_kw or {})).start()
        made.append(srv)
        return eng, srv, f"http://127.0.0.1:{srv.port}"

    request.addfinalizer(lambda: [s.stop(drain=False) for s in made])
    return make


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def post(url, obj=None, raw=None, timeout=RESULT_S):
    """(status, parsed JSON body or the ndjson lines) of a POST."""
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with OPENER.open(req, timeout=timeout) as r:
            if r.headers.get("Content-Type") == "application/x-ndjson":
                return r.status, [json.loads(ln) for ln in r]
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url, timeout=RESULT_S):
    try:
        with OPENER.open(url, timeout=timeout) as r:
            body = r.read()
            return r.status, (body.decode() if "text/plain" in
                              r.headers.get("Content-Type") else
                              json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def tokens_of(lines):
    return [ln["token"] for ln in lines if "token" in ln]


# ============================================================ /generate --
@pytest.mark.parametrize("samp", [{}, SEEDED], ids=["greedy", "seeded"])
def test_generate_streamed_and_not_equal_the_engine(served, samp):
    eng, url = served
    want = eng.generate(PROMPT, NEW, **samp)["tokens"]
    status, body = post(url + "/generate", dict(
        samp, input_ids=PROMPT, max_new_tokens=NEW))
    assert status == 200 and body["tokens"] == want
    status, lines = post(url + "/generate", dict(
        samp, input_ids=PROMPT, max_new_tokens=NEW, stream=True))
    assert status == 200 and tokens_of(lines) == want
    assert lines[-1]["done"] is True and lines[-1]["tokens"] == want


def test_ndjson_lines_equal_the_reference_server(models, served):
    eng, url = served
    jeng = JaxEngine(models[0], warmup=False, **ENGINE)
    jsrv = JaxServer(None, generator=jeng).start()
    try:
        req = dict(SEEDED, input_ids=PROMPT, max_new_tokens=NEW,
                   stream=True)
        _, jlines = post(f"http://127.0.0.1:{jsrv.port}/generate", req)
        _, jbody = post(f"http://127.0.0.1:{jsrv.port}/generate",
                        dict(req, stream=False))
        jrep = jsrv.load_report()
    finally:
        jsrv.stop(drain=False)
    _, lines = post(url + "/generate", req)
    _, body = post(url + "/generate", dict(req, stream=False))
    assert lines[:-1] == jlines[:-1]
    assert set(lines[-1]) == set(jlines[-1])
    assert set(body) == set(jbody) and body["tokens"] == jbody["tokens"]
    for key in ("tokens", "n_tokens", "prompt_tokens", "finish_reason",
                "done"):
        assert lines[-1][key] == jlines[-1][key]
    srv = ServingHTTPServer(generator=eng)
    try:
        rep = srv.load_report()
    finally:
        srv.httpd.server_close()
    assert set(rep) == set(jrep) and rep["kv"] == jrep["kv"]
    assert set(rep["fronts"]["generate"]) == set(jrep["fronts"]["generate"])
    with pytest.raises(ValueError, match="need an engine"):
        ServingHTTPServer()


def test_healthz_metrics_and_status_codes(served):
    eng, url = served
    status, h = get(url + "/healthz")
    assert status == 200 and h == eng.health()
    eng.generate(PROMPT, 2)
    status, text = get(url + "/metrics")
    snap = eng.metrics.snapshot()
    assert status == 200
    assert f"paddle_generate_requests_total {snap['requests_total']}" \
        in text.splitlines()
    assert f"paddle_generate_tokens_total {snap['tokens_out_total']}" \
        in text.splitlines()
    assert get(url + "/nope")[0] == 404
    status, body = post(url + "/nope", {})
    assert status == 404
    status, body = post(url + "/predict", {"inputs": []})
    assert status == 404 and body["error"] == \
        "no predict engine attached (generation-only server)"
    for bad in ({"max_new_tokens": 2}, {"input_ids": [99]},
                {"input_ids": PROMPT, "temperature": -1}):
        assert post(url + "/generate", bad)[0] == 400
    assert post(url + "/generate", raw=b"{not json")[0] == 400
    assert post(url + "/generate", {"input_ids": PROMPT,
                                    "resume_from": "x"})[0] == 400


def test_body_bound_413_and_shed_503(make_served):
    _, _, url = make_served(server_kw={"max_body_bytes": 64})
    status, body = post(url + "/generate", {"input_ids": list(range(40))})
    assert status == 413 and "bound" in body["error"]
    eng, _, url = make_served(max_queue_depth=1, auto_start=False)
    eng.submit(PROMPT, 2)
    req = urllib.request.Request(url + "/generate", data=json.dumps(
        {"input_ids": PROMPT}).encode())
    with pytest.raises(urllib.error.HTTPError) as e:
        OPENER.open(req, timeout=RESULT_S)
    assert e.value.code == 503 and \
        float(e.value.headers["Retry-After"]) > 0
    eng.start()


# ============================================================ admin plane --
def test_admin_kv_and_import_stream(served, models):
    eng, url = served
    want = eng.generate(PROMPT, NEW, **SEEDED)["tokens"]
    status, rep = get(url + "/admin/kv")
    assert status == 200 and set(rep) == {"kv", "prefix"}
    assert rep["kv"] == {"64": {"free": 4, "slots": 4}}
    status, res = post(url + "/generate", dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=NEW, prefill_only=True,
        stream=True))
    assert status == 200 and res["finish_reason"] == "handoff"
    raw = handoff.from_b64(res["handoff"])
    status, lines = post(url + "/admin/kv/import", raw=raw)
    assert status == 200 and tokens_of(lines) == want
    assert lines[-1]["done"] and lines[-1]["tokens"] == want
    assert post(url + "/admin/kv/import", raw=b"junk")[0] == 400
    other = GenerativeEngine(models[1], device="cpu", kv_dtype="int8",
                             **ENGINE)
    try:
        status, body = post(url + "/admin/kv/import",
                            raw=handoff.from_b64(other.submit(
                                PROMPT, NEW, prefill_only=True)
                                .result(RESULT_S)["handoff"]))
    finally:
        other.shutdown()
    assert status == 409 and "kv_dtype" in body["error"]


def test_admin_scale_add_remove_revive(make_served):
    eng, _, url = make_served()
    scale = url + "/admin/scale"
    status, add = post(scale, {"front": "generate", "action": "add"})
    assert status == 200 and add["warmed_executables"] == \
        len(eng._programs())
    status, rows = get(url + "/admin/replicas")
    assert [r["front"] for r in rows["replicas"]] == ["generate"] * 2
    status, rev = post(scale, {"front": "generate", "action": "revive",
                               "rid": add["rid"]})
    assert status == 200 and rev["generation"] == 1
    status, rem = post(scale, {"front": "generate", "action": "remove",
                               "rid": add["rid"]})
    assert status == 200 and rem["state"] == "retired"
    # the last active worker: the engine's ValueError is a 409
    assert post(scale, {"front": "generate", "action": "remove"})[0] == 409
    assert post(scale, {"action": "add"})[0] == 400      # predict front
    assert post(scale, {"front": "generate", "action": "grow"})[0] == 400
    assert post(scale, {"front": "generate", "action": "revive",
                        "rid": "x"})[0] == 400
    assert eng.generate(PROMPT, 2)["n_tokens"] == 2


def test_admin_drain_migrates_streams_and_healthz_503(make_served,
                                                      served):
    peer, _ = served
    want = peer.generate(PROMPT, 12, **SEEDED)["tokens"]
    eng, srv, url = make_served(slots=2)
    chaos.add_rule("serving.decode_step", "delay", 0.03)
    req = urllib.request.Request(url + "/generate", data=json.dumps(dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=12,
        stream=True)).encode())
    lines = []
    with OPENER.open(req, timeout=RESULT_S) as r:
        for ln in r:
            lines.append(json.loads(ln))
            if len(lines) == 2:
                assert post(url + "/admin/drain", {"migrate": True}) == \
                    (200, {"draining": True, "migrate": True})
    chaos.reset()
    head, last = tokens_of(lines), lines[-1]
    assert set(last) == {"handoff", "streamed", "n_tokens"}
    assert last["streamed"] == len(head) >= 2
    status, h = get(url + "/healthz")
    assert status == 503 and h["status"] == "draining"
    tail = [int(v) for k, v in peer.import_handoff(handoff.from_b64(
        last["handoff"])).events() if k == "tok"]
    assert head + tail == want


# ==================================================================== CLI --
def test_cli_refuses_unported_modes(capsys):
    for argv, item in ((["--engine", "--http", "1"], "need a model prefix"),
                       (["--http", "1"], "need a model prefix"),
                       (["--generate", "gpt3-tiny"], "--http"),
                       (["--generate", "gpt3-tiny", "--http", "1",
                         "--pool", "decode"], "--pool needs --fabric"),
                       (["--generate", "gpt3-tiny", "--fabric", "h:1"],
                        "--http"),
                       (["--generate", "nope", "--http", "1"], "preset")):
        with pytest.raises(SystemExit) as e:
            serve.main(argv)
        assert e.value.code == 2
        assert item in capsys.readouterr().err


class _FakeFront:
    """An engine stand-in for the CLI's fabric wiring: the server and the
    host agent read only its load report and shut it down."""

    def __init__(self, *a, **kw):
        self.shut = False

    def load_report(self):
        return {"queue_depth": 0, "replicas": 1}

    def shutdown(self, *a, **kw):
        self.shut = True


@pytest.mark.parametrize("argv, pools", [
    (["model_prefix", "--fabric"], ["predict"]),
    (["--generate", "gpt3-tiny", "--fabric"], ["generate"]),
    (["--generate", "gpt3-tiny", "--pool", "decode", "--fabric"],
     ["decode"]),
], ids=["predict", "generate", "pool"])
def test_cli_fabric_flags_start_an_agent(monkeypatch, argv, pools):
    """--fabric and --pool parse, mount the admin plane and lease the host
    into the registry (engines stubbed; serve_forever returns once the
    record is read back)."""
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference import serving

    store = TCPStore(is_master=True)
    seen = {}

    def serve_forever(srv):
        (host_id,) = json.loads(store.get("fabric/hosts"))
        seen.update(rec=json.loads(store.get(f"fabric/host/{host_id}")),
                    admin=srv.admin)
        srv.httpd.server_close()   # the listener never served

    monkeypatch.setattr(serving, "ServingEngine", _FakeFront)
    monkeypatch.setattr(serving, "GenerativeEngine", _FakeFront)
    monkeypatch.setattr(serve, "build_model", lambda *a, **k: None)
    monkeypatch.setattr(ServingHTTPServer, "serve_forever", serve_forever)
    try:
        assert serve.main(argv + [f"127.0.0.1:{store.port}", "--http", "0",
                                  "--device", "cpu"]) == 0
        assert seen["admin"] is True
        assert seen["rec"]["pools"] == pools
        assert seen["rec"]["generation"] == 0
        # the agent's stop on the way out deregisters the host
        assert json.loads(store.get("fabric/hosts")) == []
    finally:
        store.stop()


def test_checkpoint_loader_admits_arrays_only(tmp_path):
    """A bfloat16 checkpoint of the reference loads with the same bits
    (its arrays are ml_dtypes.bfloat16, read without ml_dtypes); a pickle
    that names anything but numpy's arrays is refused."""
    import ml_dtypes

    path = tmp_path / "bf16.pdparams"
    x = np.random.default_rng(0).standard_normal(7).astype(np.float32)
    paddle_tpu.save({"w": paddle_tpu.cast(paddle_tpu.to_tensor(x),
                                          "bfloat16")}, str(path))
    want = np.asarray(pickle.load(open(path, "rb"))["w"]["data"])
    assert want.dtype == ml_dtypes.bfloat16
    got = serve.load_reference_state_dict(str(path))["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
    evil = tmp_path / "evil.pdparams"
    evil.write_bytes(pickle.dumps({"w": os.system}))
    with pytest.raises(pickle.UnpicklingError, match="only numpy"):
        serve.load_reference_state_dict(str(evil))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_a_reference_checkpoint(tmp_path):
    """The reference's gpt3-tiny (vocab 1024, hidden 128, 2 layers, 8
    heads, max_seq_len 256), saved by paddle_tpu.save, served by the CLI
    in a subprocess on the CPU: the reference engine's tokens."""
    paddle_tpu.seed(0)
    jm = GPTForCausalLM(JAX_PRESETS["gpt3-tiny"])
    jm.eval()
    ckpt = tmp_path / "tiny.pdparams"
    paddle_tpu.save(jm.state_dict(), str(ckpt))
    prompt = [int(t) for t in np.random.RandomState(5).randint(0, 1024, 20)]
    jeng = JaxEngine(jm, warmup=False, slots=4)
    try:
        want = jeng.generate(prompt, NEW, **SEEDED)["tokens"]
        want_greedy = jeng.generate(prompt, NEW)["tokens"]
    finally:
        jeng.shutdown(drain=False)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
         "--generate", "gpt3-tiny", "--state-dict", str(ckpt), "--http",
         str(port), "--device", "cpu", "--slots", "4"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + CLI_S
        while True:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            try:
                if get(url + "/healthz", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert time.monotonic() < deadline, "the CLI did not answer"
            time.sleep(0.2)
        status, body = post(url + "/generate", dict(
            SEEDED, input_ids=prompt, max_new_tokens=NEW))
        assert status == 200 and body["tokens"] == want
        status, lines = post(url + "/generate", {
            "input_ids": prompt, "max_new_tokens": NEW, "stream": True})
        assert status == 200 and tokens_of(lines) == want_greedy
    finally:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
