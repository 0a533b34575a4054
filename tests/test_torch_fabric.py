"""The port's serving fabric (paddle_tpu_torch/inference/fabric, the
autoscale controllers and serve.py --fabric) on the CPU, against the
reference's paddle_tpu.inference.fabric.

- Membership: the reference's ladder scenarios (suspect, probe, evict,
  rejoin by generation, re-admission by seq, graceful leave, draining,
  heartbeat chaos) on a dict store; a port lease's record against the
  reference's (same keys and values).
- Router: build_ring and ring_hosts equal to the reference's (also after
  a member leaves); for the same reported loads, KV digests and prefix
  residency the port's picks are the reference's (least-loaded, KV-aware,
  prefix-resident, the ring); the routing rules over stdlib members
  (retry, chaos, 503 with no host, resume on a survivor, a terminal line
  without one); merge_expositions' text equal to the reference's; two
  doors' tables and rings agree and a FleetClient rotates past a dead one.
- Integration: the handoff tests' tiny model (vocab 64, hidden 32, 2
  layers, 2 heads, max_seq_len 64, numpy weights carried across by
  params_from_paddle_tpu) on a port host behind a port door and on a
  reference host behind a reference door: /generate bodies and ndjson
  lines, /healthz keys and the merged /metrics names; a port host under
  the reference's door and a reference host under the port's (tokens
  equal); with two port hosts, a stream cut mid-way (a proxy in front of
  its host drops every connection) resumes on the survivor with no
  duplicate, and a prefill-pool host plus a decode-pool host give one
  prefill handoff with a single host's tokens.
- Fleet: FleetEngine add, revive and remove over /admin; the port's
  HealthWatchdog revives a wedged remote worker; the ReplicaAutoscaler
  drives the fleet (a scale-up through the door's router).
- CLI: the door's CLI prints DOOR=, a `serve.py --generate gpt3-tiny
  --fabric` host registers and answers through it; --embed is refused.

Tokens compare exactly (greedy and seeded decoding are deterministic;
the tiny model's top-2 margins are far above f32 rounding)."""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.inference import fabric as rf
from paddle_tpu.inference.serving import GenerativeEngine as JaxEngine
from paddle_tpu.inference.serving import ServingHTTPServer as JaxServer
from paddle_tpu.models import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.autoscale import HealthWatchdog, ReplicaAutoscaler
from paddle_tpu_torch.autoscale.policy import ScalingPolicy
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.inference import (GenerativeEngine, ServingHTTPServer,
                                        serve)
from paddle_tpu_torch.inference import fabric as pf
from paddle_tpu_torch.inference.fabric import _http, handoff
from paddle_tpu_torch.inference.fabric import __main__ as door_cli
from paddle_tpu_torch.inference.serving.lifecycle import ServingError
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
CLI_S = 60
# every request goes to 127.0.0.1: consult no proxy
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def poll_until(cond, timeout=20.0, desc="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {desc}"
        time.sleep(0.02)


class FakeStore:
    """Dict-backed store with the compare_set contract."""

    def __init__(self, cas: bool = True):
        self.kv = {}
        self._lock = threading.Lock()
        if not cas:
            self.compare_set = None  # the plain get/set path

    def set(self, k, v):
        with self._lock:
            self.kv[k] = v.encode() if isinstance(v, str) else v

    def get(self, k):
        with self._lock:
            return self.kv.get(k)

    def delete_key(self, k):
        with self._lock:
            self.kv.pop(k, None)

    def compare_set(self, k, expected, desired):
        with self._lock:
            cur = self.kv.get(k, b"")
            if cur == expected.encode():
                self.kv[k] = desired.encode()
                return desired.encode()
            return cur


def post(url, obj=None, raw=None, timeout=60):
    """(status, parsed JSON body or the ndjson lines) of a POST."""
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with OPENER.open(req, timeout=timeout) as r:
            if r.headers.get("Content-Type") == "application/x-ndjson":
                return r.status, [json.loads(ln) for ln in r if ln.strip()]
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def get(url, timeout=30):
    try:
        with OPENER.open(url, timeout=timeout) as r:
            body = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode()


def tokens_of(lines):
    return [ln["token"] for ln in lines if "token" in ln]


# ============================================================ membership --
def _lease(pkg, store, hid, ep="127.0.0.1:1", **kw):
    # heartbeats driven by hand: the thread waits an hour
    return pkg.HostLease(store, hid, ep, pools=kw.pop("pools", ["generate"]),
                         heartbeat_s=3600, **kw)


def test_index_helpers_on_a_dict_store():
    from paddle_tpu_torch.distributed.store import (index_add,
                                                    index_discard,
                                                    index_members)
    st = FakeStore()
    assert index_add(st, "idx", "b") == ["b"]
    assert index_add(st, "idx", "a") == ["a", "b"]
    assert index_add(st, "idx", "a") == ["a", "b"]
    assert index_members(st, "idx") == ["a", "b"]
    assert index_discard(st, "idx", "b") == ["a"]
    assert index_discard(st, "idx", "zz") == ["a"]
    plain = FakeStore(cas=False)
    index_add(plain, "idx", "x")
    assert index_members(plain, "idx") == ["x"]


def test_lease_record_matches_reference():
    load = lambda: {"queue_depth": 2, "replicas": 1,  # noqa: E731
                    "kv": {"64": {"free": 3, "slots": 4}}}
    recs = []
    for pkg in (pf, rf):
        s = FakeStore()
        lease = _lease(pkg, s, "h1", "127.0.0.1:9", capacity=2,
                       pools=["generate", "decode"], load_fn=load)
        assert lease.register() == 0
        lease._beat_once()
        lease.mark_draining(True)
        rec = json.loads(s.get("fabric/host/h1"))
        assert abs(rec.pop("ts") - time.time()) < 60
        recs.append((rec, s.get("fabric/hosts"), lease.counters))
        lease.deregister()
        assert s.get("fabric/host/h1") is None
        assert s.get("fabric/hosts") == b"[]"
    assert recs[0] == recs[1]
    assert recs[0][0]["seq"] == 2 and recs[0][0]["draining"] is True


def test_ladder_suspect_probe_evict():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    probes = []
    view = pf.MembershipView(st, lease_s=1.0, drain_s=0.5, max_probes=2,
                             probe_fn=lambda m: probes.append(m.host_id)
                             or False)
    t0 = time.monotonic()
    view.poll_once(t0)
    assert [m.host_id for m in view.alive()] == ["h1"]
    lease._beat_once()
    view.poll_once(t0 + 0.9)
    view.poll_once(t0 + 1.5)
    assert view.get("h1").state == "alive"
    view.poll_once(t0 + 2.8)
    assert view.get("h1").state == "suspect" and view.alive() == []
    assert view.counters["suspects"] == 1
    view.poll_once(t0 + 2.9)
    assert probes == ["h1", "h1"]
    view.poll_once(t0 + 3.2)
    assert probes == ["h1", "h1"]
    view.poll_once(t0 + 4.1)
    assert view.get("h1") is None and view.counters["evictions"] == 1
    lease.deregister()


def test_probe_readmits_store_partitioned_host():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    view = pf.MembershipView(st, lease_s=1.0, drain_s=5.0,
                             probe_fn=lambda m: True)
    t0 = time.monotonic()
    view.poll_once(t0)
    view.poll_once(t0 + 1.5)
    assert view.counters["suspects"] == 1
    assert view.get("h1").state == "alive"
    view.poll_once(t0 + 2.4)
    assert view.get("h1").state == "alive"
    assert view.counters["suspects"] == 1
    lease.deregister()


def test_rejoin_needs_bumped_generation():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    view = pf.MembershipView(st, lease_s=0.5, drain_s=0.2,
                             probe_fn=lambda m: False, max_probes=0)
    t0 = time.monotonic()
    view.poll_once(t0)
    view.poll_once(t0 + 0.8)
    view.poll_once(t0 + 1.0)
    assert view.get("h1") is None
    view.poll_once(t0 + 1.2)          # the corpse record stays out
    assert view.get("h1") is None
    assert lease.register() == 1
    view.poll_once(t0 + 1.4)
    m = view.get("h1")
    assert m is not None and m.generation == 1 and m.state == "alive"
    assert view.counters["rejoins"] == 1
    lease.deregister()


def test_transient_store_blip_readmits_on_seq_advance():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    view = pf.MembershipView(st, lease_s=5.0)
    view.poll_once()
    idx = st.kv.pop("fabric/hosts")
    view.poll_once()
    assert view.get("h1") is None and view.counters["leaves"] == 1
    st.kv["fabric/hosts"] = idx
    view.poll_once()
    assert view.get("h1") is None     # seq frozen: still blocked
    lease._beat_once()
    view.poll_once()
    assert view.get("h1").state == "alive"
    assert view.counters["rejoins"] == 1
    lease.deregister()


def test_graceful_leave_and_draining():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    view = pf.MembershipView(st, lease_s=5.0, drain_s=1.0)
    view.poll_once()
    lease.mark_draining(True)
    view.poll_once()
    assert view.alive() == [] and view.get("h1").state == "alive"
    lease.deregister()
    view.poll_once()
    assert view.get("h1") is None
    assert view.counters["leaves"] == 1 and view.counters["evictions"] == 0


def test_heartbeat_chaos_survives():
    st = FakeStore()
    lease = _lease(pf, st, "h1")
    lease.register()
    chaos.add_rule("fabric.heartbeat", "raise_n", 2)
    for _ in range(2):
        with pytest.raises(chaos.ChaosError):
            lease._beat_once()
    lease._beat_once()
    view = pf.MembershipView(st, lease_s=1.0)
    view.poll_once()
    assert [m.host_id for m in view.alive()] == ["h1"]
    lease.deregister()


# ======================================================= router policy --
@pytest.mark.parametrize("vnodes", [8, 32])
def test_ring_equals_reference(vnodes):
    hosts = [f"host-{i}" for i in range(5)]
    keys = [f"session-{i}".encode() for i in range(48)] + \
        [json.dumps(list(range(i))).encode() for i in range(16)]
    for hs in (hosts, hosts[:2] + hosts[3:], hosts[:1], []):
        ring = pf.build_ring(hs, vnodes)
        assert ring == rf.build_ring(hs, vnodes)
        for k in keys:
            for n in (1, 2, 3):
                assert pf.ring_hosts(ring, k, n) == \
                    rf.router.ring_hosts(ring, k, n)
    # a leave remaps only the keys the leaver owned
    full, cut = pf.build_ring(hosts, vnodes), \
        pf.build_ring(hosts[:2] + hosts[3:], vnodes)
    for k in keys:
        before = pf.ring_hosts(full, k)[0]
        if before != hosts[2]:
            assert pf.ring_hosts(cut, k)[0] == before


def _loads_fleet(loads, pools=("predict", "generate")):
    """Port leases of hosts a, b, c with `loads` (host -> load dict) on
    one dict store, and a port and a reference view of it."""
    st = FakeStore()
    for hid, load in loads.items():
        lease = pf.HostLease(st, hid, f"127.0.0.1:{ord(hid)}",
                             pools=list(pools), heartbeat_s=3600,
                             load_fn=lambda load=load: load)
        lease.register()
        lease._stop.set()
    views = [pkg.MembershipView(st, lease_s=60.0) for pkg in (pf, rf)]
    for v in views:
        v.poll_once()
    return views


PROMPT13 = list(range(1, 14))
DIGEST8 = f"8:{handoff.prefix_hash(PROMPT13, 8)[:8]}"
DIGEST4 = f"4:{handoff.prefix_hash(PROMPT13, 4)[:8]}"
PICKS = {
    "least-loaded": ({"a": {"queue_depth": 50}, "b": {"queue_depth": 0},
                      "c": {"queue_depth": 3}}, {}),
    "least-loaded-tie": ({"a": {"queue_depth": 1}, "b": {"queue_depth": 1},
                          "c": {"queue_depth": 1}}, {}),
    "kv-aware": ({"a": {"queue_depth": 0,
                        "kv": {"64": {"free": 0, "slots": 4}}},
                  "b": {"queue_depth": 0,
                        "kv": {"64": {"free": 4, "slots": 4}}},
                  "c": {"queue_depth": 0,
                        "kv": {"64": {"free": 1, "slots": 4}}}},
                 {"gen_req": {"input_ids": PROMPT13,
                              "max_new_tokens": 8}}),
    "kv-fallback": ({"a": {"queue_depth": 0},
                     "b": {"queue_depth": 9,
                           "kv": {"64": {"free": 4, "slots": 4}}},
                     "c": {"queue_depth": 2,
                           "kv": {"32": {"free": 4, "slots": 4}}}},
                    {"gen_req": {"input_ids": PROMPT13,
                                 "max_new_tokens": 8}}),
    "no-class-fits": ({"a": {"queue_depth": 5,
                             "kv": {"16": {"free": 4, "slots": 4}}},
                       "b": {"queue_depth": 1,
                             "kv": {"16": {"free": 4, "slots": 4}}}},
                      {"gen_req": {"input_ids": PROMPT13,
                                   "max_new_tokens": 8}}),
    "prefix-resident": ({"a": {"prefix": [DIGEST4]},
                         "b": {"prefix": [DIGEST8]}, "c": {}},
                        {"gen_req": {"input_ids": PROMPT13,
                                     "max_new_tokens": 4},
                         "affinity_key": b"session-7"}),
    "prefix-tie": ({"a": {"prefix": [DIGEST8]}, "b": {"prefix": [DIGEST8]},
                    "c": {}},
                   {"gen_req": {"input_ids": PROMPT13,
                                "max_new_tokens": 4},
                    "affinity_key": b"session-7"}),
    "ring": ({"a": {}, "b": {}, "c": {}},
             {"gen_req": {"input_ids": [9, 9, 9], "max_new_tokens": 4},
              "affinity_key": b"session-7"}),
}


@pytest.mark.parametrize("case", sorted(PICKS))
def test_router_picks_equal_reference(case):
    loads, kw = PICKS[case]
    pview, rview = _loads_fleet(loads)
    prt, rrt = pf.FabricRouter(pview), rf.FabricRouter(rview)
    for pool in ("generate", "predict", None):
        for exclude in ((), ("b",), ("a", "b")):
            got = prt.pick(pool, exclude=exclude, **kw)
            want = rrt.pick(pool, exclude=exclude, **kw)
            assert (got and got.host_id) == (want and want.host_id), \
                (pool, exclude)
    # the ring over many sessions, as the streamed path keys it
    for i in range(24):
        key = f"s{i}".encode()
        assert prt.pick("generate", affinity_key=key).host_id == \
            rrt.pick("generate", affinity_key=key).host_id


class _DummyMember:
    """Stdlib HTTP member: /healthz, /predict (echoes which host served),
    /generate with chunked ndjson honouring resume_from."""

    def __init__(self, name, tokens=(1, 2, 3)):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        member = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"status": "ok"}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                member.hits += 1
                if self.path == "/generate" and payload.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(obj):
                        data = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(f"{len(data):X}\r\n".encode() +
                                         data + b"\r\n")

                    toks = member.tokens[int(payload.get("resume_from")
                                             or 0):]
                    for i, t in enumerate(toks):
                        if member.die_after is not None and \
                                i >= member.die_after:
                            self.wfile.flush()
                            try:
                                self.connection.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            self.close_connection = True
                            return
                        chunk({"token": int(t)})
                    chunk({"done": True, "who": member.name})
                    self.wfile.write(b"0\r\n\r\n")
                    return
                body = json.dumps({"who": member.name,
                                   "path": self.path}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.name = name
        self.tokens = list(tokens)
        self.die_after = None
        self.hits = 0
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.srv.daemon_threads = True
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    @property
    def endpoint(self):
        return f"127.0.0.1:{self.srv.server_address[1]}"

    def kill(self):
        self.srv.shutdown()
        self.srv.server_close()


def _fleet_of(st, members, lease_s=5.0):
    leases = []
    for mem in members:
        lease = pf.HostLease(st, mem.name, mem.endpoint,
                             pools=["predict", "generate"],
                             heartbeat_s=3600)
        lease.register()
        leases.append(lease)
    view = pf.MembershipView(st, lease_s=lease_s)
    view.poll_once()
    return view, leases


@pytest.fixture
def dummies(request):
    made = []

    def make(*names, tokens=(1, 2, 3)):
        ms = [_DummyMember(n, tokens) for n in names]
        made.extend(ms)
        return ms

    request.addfinalizer(lambda: [m.kill() for m in made])
    return make


def test_forward_least_loaded_and_retry(dummies):
    a, b = dummies("a", "b")
    st = FakeStore()
    view, (la, lb) = _fleet_of(st, [a, b])
    router = pf.FabricRouter(view, hop_timeout_s=2.0)
    la.load_fn = lambda: {"queue_depth": 50}
    la._beat_once()
    view.poll_once()
    for _ in range(3):
        status, _, data = router.forward("/predict", b"{}",
                                         "application/json")
        assert status == 200 and json.loads(data)["who"] == "b"
    la.load_fn = lambda: {"queue_depth": 0}
    la._beat_once()
    lb.load_fn = lambda: {"queue_depth": 9}
    lb._beat_once()
    view.poll_once()
    b.kill()   # transport faults on b ... but a is picked first now
    a.kill()
    with pytest.raises(ServingError) as ei:
        router.forward("/predict", b"{}", "application/json")
    assert ei.value.status == 503 and router.metrics.retries_total == 1


def test_forward_retries_a_dead_host_and_chaos(dummies):
    a, b = dummies("a", "b")
    view, _ = _fleet_of(FakeStore(), [a, b])
    router = pf.FabricRouter(view, hop_timeout_s=2.0)
    chaos.add_rule("fabric.forward", "raise_n", 1)
    status, _, _ = router.forward("/predict", b"{}", "application/json")
    assert status == 200 and router.metrics.retries_total == 1
    chaos.reset()
    a.kill()
    winners = {json.loads(router.forward("/predict", b"{}",
                                         "application/json")[2])["who"]
               for _ in range(4)}
    assert winners == {"b"}


def test_no_hosts_is_503_with_lease_retry_after():
    router = pf.FabricRouter(pf.MembershipView(FakeStore(), lease_s=2.5))
    with pytest.raises(ServingError) as ei:
        router.forward("/predict", b"{}", "application/json")
    assert ei.value.status == 503 and ei.value.retry_after == 2.5
    assert router.metrics.no_host_total == 1


def test_stream_break_without_survivor_is_terminal(dummies):
    (a,) = dummies("a", tokens=(5, 6, 7, 8))
    a.die_after = 2
    view, _ = _fleet_of(FakeStore(), [a])
    router = pf.FabricRouter(view, stream_idle_timeout_s=5.0)
    lines = []
    router.stream_generate(b'{"stream": true}', b"k", lines.append)
    assert [json.loads(ln)["token"] for ln in lines[:-1]] == [5, 6]
    last = json.loads(lines[-1])
    assert last.get("status") == 503 and "error" in last
    assert router.metrics.streams_broken_total == 1
    assert router.metrics.streams_resumed_total == 1


def test_stream_break_resumes_on_survivor_and_pre_token_retries(dummies):
    a, b = dummies("a", "b", tokens=(5, 6, 7, 8))
    a.die_after = 2
    view, _ = _fleet_of(FakeStore(), [a, b])
    router = pf.FabricRouter(view, stream_idle_timeout_s=5.0)
    got = []
    for key in (b"k0", b"k1", b"k2", b"k3"):
        lines = []
        router.stream_generate(b'{"stream": true}', key, lines.append)
        toks = [json.loads(ln)["token"] for ln in lines[:-1]]
        assert toks == [5, 6, 7, 8]
        got.append(json.loads(lines[-1])["who"])
    assert "b" in got and router.metrics.streams_resumed_total >= 1
    assert router.metrics.streams_broken_total == 0
    a.die_after = 0              # dies before its first token: a retry
    for _ in range(3):
        lines = []
        router.stream_generate(b'{"stream": true}', b"k2", lines.append)
        assert json.loads(lines[-1]) == {"done": True, "who": "b"}


def test_merge_expositions_equal_reference():
    parts = {
        "h2": "# HELP m x\n# TYPE m counter\nm 5\nbad line here {\n",
        "h1": "# HELP m x\n# TYPE m counter\nm 1\n"
              'm2{k="v"} 7\n# TYPE s summary\ns{quantile="0.5"} 0.25\n\n',
        "h3": "",
    }
    merged = pf.merge_expositions(parts)
    assert merged == rf.merge_expositions(parts)
    assert merged.count("# HELP m x") == 1
    assert 'm{host="h1"} 1' in merged and 'm{host="h2"} 5' in merged
    assert 'm2{host="h1",k="v"} 7' in merged
    assert pf.merge_expositions({}) == rf.merge_expositions({}) == ""


def test_two_doors_agree_and_client_rotates(dummies):
    members = dummies("a", "b", "c", tokens=(5, 6, 7, 8))
    st = FakeStore()
    view_a, leases = _fleet_of(st, members)
    view_b = pf.MembershipView(st, lease_s=5.0)
    view_b.poll_once()
    ra, rb = pf.FabricRouter(view_a), pf.FabricRouter(view_b)
    fd_a, fd_b = pf.FabricHTTPServer(ra).start(), \
        pf.FabricHTTPServer(rb).start()
    try:
        keys = [f"session-{i}".encode() for i in range(24)]
        picks = [ra.pick("generate", affinity_key=k).host_id for k in keys]
        assert picks == [rb.pick("generate", affinity_key=k).host_id
                         for k in keys]
        assert len(set(picks)) > 1
        leases[0].deregister()
        view_a.poll_once()
        view_b.poll_once()
        assert [r["host"] for r in view_a.rows()] == \
            [r["host"] for r in view_b.rows()] == ["b", "c"]
        client = pf.FleetClient([f"127.0.0.1:{fd_a.port}",
                                 f"http://127.0.0.1:{fd_b.port}/"],
                                timeout_s=10.0)
        for _ in range(3):
            status, body = client.predict({"x": 1})
            assert status == 200 and body["who"] in ("b", "c")
        recs = list(client.stream_generate({"session": "s1"}))
        assert [r["token"] for r in recs if "token" in r] == [5, 6, 7, 8]
        fd_a.stop()
        for _ in range(3):
            assert client.predict({"x": 1})[0] == 200
        assert client.counters_snapshot()["door_retries"] >= 1
        status, health = client.healthz()
        assert status == 200 and health["hosts_alive"] == 2
        for m in members[1:]:
            m.die_after = 2
        recs = list(client.stream_generate({"session": "s1"}))
        assert [r["token"] for r in recs if "token" in r] == [5, 6, 7, 8]
        assert recs[-1].get("done") is True
    finally:
        fd_b.stop()


# =============================================== real-engine integration --
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


class _Stack:
    """Hosts behind one door, all in this process; stop() tears every
    piece down."""

    def __init__(self, door_pkg, lease_s=2.0, drain_s=1.0):
        self.store = FakeStore()
        self.view = door_pkg.MembershipView(self.store, lease_s=lease_s,
                                            drain_s=drain_s).start()
        self.router = door_pkg.FabricRouter(self.view,
                                            stream_idle_timeout_s=30.0)
        self.door = door_pkg.FabricHTTPServer(self.router).start()
        self.url = f"http://127.0.0.1:{self.door.port}"
        self.agents, self.servers = [], []

    def add_host(self, host_pkg, server, host_id, endpoint=None, **kw):
        agent = host_pkg.HostAgent(server, self.store, host_id=host_id,
                                   endpoint=endpoint, heartbeat_s=0.1,
                                   **kw).start()
        self.agents.append(agent)
        return agent

    def wait_hosts(self, n):
        poll_until(lambda: len(self.view.alive()) >= n, desc=f"{n} hosts")

    def stop(self):
        for a in self.agents:
            a.stop()
        self.door.stop()


@pytest.fixture(scope="module")
def hosts(models):
    """A port host and a reference host (admin servers over the same
    weights), each under four doors: port host / port door, reference
    host / reference door, and the two crossings."""
    peng = GenerativeEngine(models[1], device="cpu", **ENGINE)
    psrv = ServingHTTPServer(generator=peng, admin=True).start()
    jeng = JaxEngine(models[0], warmup=False, **ENGINE)
    jsrv = JaxServer(None, generator=jeng, admin=True).start()
    stacks = {}
    for name, door_pkg, host_pkg, srv in (("pp", pf, pf, psrv),
                                          ("rr", rf, rf, jsrv),
                                          ("rp", rf, pf, psrv),
                                          ("pr", pf, rf, jsrv)):
        s = _Stack(door_pkg)
        s.add_host(host_pkg, srv, "h1")
        stacks[name] = s
    for s in stacks.values():
        s.wait_hosts(1)
    yield {"peng": peng, "psrv": psrv, "jeng": jeng, **stacks}
    for s in stacks.values():
        s.stop()
    psrv.stop(drain=False)
    jsrv.stop(drain=False)


@pytest.mark.parametrize("req", [
    {"input_ids": PROMPT, "max_new_tokens": NEW},
    dict(SEEDED, input_ids=PROMPT, max_new_tokens=NEW),
    {"input_ids": [5, 9, 1], "max_new_tokens": 3, "eos_token_id": 0},
], ids=["greedy", "seeded", "short"])
def test_door_lines_equal_reference_door(hosts, req):
    want = hosts["peng"].generate(
        req["input_ids"], req["max_new_tokens"],
        **{k: v for k, v in req.items()
           if k not in ("input_ids", "max_new_tokens")})["tokens"]
    out = {}
    for name in ("pp", "rr"):
        url = hosts[name].url + "/generate"
        status, body = post(url, req)
        assert status == 200 and body["tokens"] == want
        status, lines = post(url, dict(req, stream=True))
        assert status == 200 and tokens_of(lines) == want
        out[name] = (body, lines)
    (pbody, plines), (jbody, jlines) = out["pp"], out["rr"]
    assert set(pbody) == set(jbody)
    for k in ("tokens", "n_tokens", "prompt_tokens", "finish_reason"):
        assert pbody[k] == jbody[k]
    assert plines[:-1] == jlines[:-1]
    assert set(plines[-1]) == set(jlines[-1])


@pytest.mark.parametrize("name", ["rp", "pr"])
def test_cross_package_host_and_door(hosts, name):
    """rp: the port host under the reference's door; pr: the reference
    host under the port's door. Tokens equal the port engine's."""
    want = hosts["peng"].generate(PROMPT, NEW, **SEEDED)["tokens"]
    url = hosts[name].url
    status, body = post(url + "/generate", dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=NEW))
    assert status == 200 and body["tokens"] == want
    status, lines = post(url + "/generate", dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=NEW, stream=True))
    assert status == 200 and tokens_of(lines) == want
    status, h = get(url + "/healthz")
    assert status == 200 and [r["host"] for r in h["hosts"]] == ["h1"]


def test_door_healthz_and_fleet_keys_equal_reference(hosts):
    (ps, ph), (rs, rh) = get(hosts["pp"].url + "/healthz"), \
        get(hosts["rr"].url + "/healthz")
    assert ps == rs == 200
    assert set(ph) == set(rh) and ph["status"] == rh["status"] == "ok"
    assert set(ph["hosts"][0]) == set(rh["hosts"][0])
    for k in ("host", "state", "generation", "capacity", "pools",
              "draining"):
        assert ph["hosts"][0][k] == rh["hosts"][0][k]
    (_, pfl), (_, rfl) = get(hosts["pp"].url + "/fleet"), \
        get(hosts["rr"].url + "/fleet")
    assert set(pfl) == set(rfl)
    assert set(pfl["router"]) == set(rfl["router"])
    assert pfl["counters"].keys() == rfl["counters"].keys()


def _metric_names(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


def test_door_metrics_names_equal_reference(hosts):
    post(hosts["pp"].url + "/generate", {"input_ids": PROMPT,
                                         "max_new_tokens": 2})
    post(hosts["rr"].url + "/generate", {"input_ids": PROMPT,
                                         "max_new_tokens": 2})
    (_, ptext), (_, rtext) = get(hosts["pp"].url + "/metrics"), \
        get(hosts["rr"].url + "/metrics")
    pn, rn = _metric_names(ptext), _metric_names(rtext)
    assert pn == rn
    assert {n for n in pn if n.startswith("paddle_fabric_")} == \
        {n for n in rn if n.startswith("paddle_fabric_")}
    assert 'paddle_fabric_member_state{host="h1"' in ptext
    assert 'paddle_generate_requests_total{host="h1"}' in ptext
    samples = {ln.split("{")[0] for ln in ptext.splitlines()
               if ln and not ln.startswith("#") and 'host="h1"' in ln}
    assert samples and all(s in pn or s.rsplit("_", 1)[0] in pn
                           for s in samples)


def test_door_refusals(hosts):
    url = hosts["pp"].url
    assert post(url + "/generate", raw=b"[1, 2]")[0] == 400
    assert post(url + "/generate", {"input_ids": PROMPT,
                                    "temperature": -1})[0] == 400
    assert post(url + "/nope", {})[0] == 404
    assert post(url + "/embed/lookup", {})[0] == 404
    assert get(url + "/nope")[0] == 404
    # no host of the fleet serves the predict pool: 503, no hop
    status, body = post(url + "/predict", {"inputs": []})
    assert status == 503 and "fleet forward failed" in body["error"]


class _CutProxy:
    """A TCP relay in front of a host; cut() drops every connection at
    once and stops listening, as a host that dies does."""

    def __init__(self, port):
        self.target = ("127.0.0.1", port)
        self.lsock = socket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(64)
        self.port = self.lsock.getsockname()[1]
        self.socks = []
        self.lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.lsock.accept()
            except OSError:
                return
            try:
                u = socket.create_connection(self.target)
            except OSError:
                c.close()
                continue
            with self.lock:
                self.socks += [c, u]
            for a, b in ((c, u), (u, c)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    @staticmethod
    def _pump(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def cut(self):
        self.lsock.close()
        with self.lock:
            for s in self.socks:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()


@pytest.fixture
def two_port_hosts(models, request):
    """Two fresh port hosts (engines over the same weights) behind a port
    door; host a is reached through a _CutProxy."""
    engs = [GenerativeEngine(models[1], device="cpu", **ENGINE)
            for _ in range(2)]
    srvs = [ServingHTTPServer(generator=e, admin=True).start() for e in engs]
    stack = _Stack(pf, lease_s=1.0, drain_s=0.5)
    proxy = _CutProxy(srvs[0].port)

    def fin():
        stack.stop()
        proxy.cut()
        for s in srvs:
            s.stop(drain=False)

    request.addfinalizer(fin)
    return engs, srvs, stack, proxy


def test_stream_cut_midway_resumes_on_survivor(two_port_hosts):
    engs, srvs, stack, proxy = two_port_hosts
    stack.add_host(pf, srvs[0], "a", endpoint=f"127.0.0.1:{proxy.port}")
    stack.add_host(pf, srvs[1], "b")
    stack.wait_hosts(2)
    want = engs[1].generate(PROMPT, 12, **SEEDED)["tokens"]
    # a session whose ring owner is host a
    ring = pf.build_ring(["a", "b"], stack.router.vnodes)
    session = next(f"s{i}" for i in range(100)
                   if pf.ring_hosts(ring, f"s{i}".encode())[0] == "a")
    chaos.add_rule("serving.decode_step", "delay", 0.05)
    client = pf.FleetClient([stack.url], timeout_s=30.0)
    recs = []
    for rec in client.stream_generate(dict(
            SEEDED, input_ids=PROMPT, max_new_tokens=12, session=session)):
        recs.append(rec)
        if len(recs) == 3:
            proxy.cut()
    chaos.reset()
    toks = [r["token"] for r in recs if "token" in r]
    assert toks == want                       # no duplicate, no gap
    assert recs[-1].get("done") is True and len(recs) == len(want) + 1
    # the door counts a stream once its relay returns, just after the
    # client has read the done line
    m = stack.router.metrics
    poll_until(lambda: m.snapshot()["streams_total"] == 1, desc="relay")
    snap = m.snapshot()
    assert snap["streams_resumed_total"] == 1
    assert snap["streams_broken_total"] == 0
    assert snap["stream_tokens_total"] == len(want)
    assert m.forwards_total == {"b": 1}
    # the cut host is suspected (its lease still beats: the probe of its
    # dead endpoint fails, the lease keeps it) and b keeps serving
    assert post(stack.url + "/generate", dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=12))[1]["tokens"] == want


def test_disaggregated_prefill_handoff(two_port_hosts):
    engs, srvs, stack, _ = two_port_hosts
    stack.add_host(pf, srvs[0], "p", pools=["prefill"])
    stack.add_host(pf, srvs[1], "d", pools=["decode"])
    stack.wait_hosts(2)
    want = engs[1].generate(PROMPT, NEW, **SEEDED)["tokens"]
    status, lines = post(stack.url + "/generate", dict(
        SEEDED, input_ids=PROMPT, max_new_tokens=NEW, stream=True))
    assert status == 200 and tokens_of(lines) == want
    assert lines[-1]["done"] is True
    poll_until(lambda: stack.router.metrics.snapshot()["streams_total"]
               == 1, desc="relay")
    snap = stack.router.metrics.snapshot()
    assert snap["prefill_handoffs_total"] == 1
    assert stack.router.metrics.forwards_total == {"p": 1, "d": 1}
    assert engs[0].metrics.snapshot()["handoffs_out_total"] == 1
    assert engs[1].metrics.snapshot()["handoffs_in_total"] == 1
    # the prefill pool alone cannot decode: with no decode host, 503
    stack.agents[1].stop()
    poll_until(lambda: len(stack.view.alive()) == 1, desc="decode leaves")
    assert post(stack.url + "/generate", dict(
        input_ids=PROMPT, max_new_tokens=2, stream=True))[0] == 503


# ================================================================= fleet --
@pytest.fixture(scope="module")
def fleet_stack(models):
    """One port host behind a port door, and the fleet adapter."""
    eng = GenerativeEngine(models[1], device="cpu", **ENGINE)
    srv = ServingHTTPServer(generator=eng, admin=True).start()
    stack = _Stack(pf)
    stack.add_host(pf, srv, "h1")
    stack.wait_hosts(1)
    fleet = pf.FleetEngine(stack.view, stack.router)
    yield {"eng": eng, "srv": srv, "stack": stack, "fleet": fleet}
    stack.stop()
    srv.stop(drain=False)


def test_fleet_add_revive_remove(fleet_stack):
    fleet, eng = fleet_stack["fleet"], fleet_stack["eng"]

    def active():
        return [r for r in fleet.replica_states() if r["state"] == "active"]

    rows = active()
    assert [r["rid"] for r in rows] == ["h1|generate|0"]
    assert rows[0]["device"] == "h1|generate|cpu" and rows[0]["host"] == "h1"
    report = fleet.add_replica()
    assert report["rid"].startswith("h1|generate|")
    assert report["warmed_executables"] >= 1 and report["host"] == "h1"
    assert len(active()) == 2 and len(eng._active()) == 2
    assert [str(d) for d in fleet._device_pool] == ["h1|generate|cpu"]
    rev = fleet.revive_replica(rows[0]["rid"])
    assert rev["generation"] == 1 and rev["rid"] == rows[0]["rid"]
    rem = fleet.remove_replica(drain=True)
    assert rem["drained"] is True and len(active()) == 1
    with pytest.raises(ValueError):
        fleet.remove_replica(drain=True)         # the last active one
    with pytest.raises(ValueError):
        fleet.revive_replica("h1|generate|999")
    h = fleet.health()
    assert h["status"] == "ok" and h["queue_depth"] == 0
    status, _ = _http.request_json(
        f"127.0.0.1:{fleet_stack['srv'].port}", "POST", "/admin/scale",
        {"front": "generate", "action": "remove", "timeout": "abc"})
    assert status == 400


def test_watchdog_revives_remote_wedge(fleet_stack):
    eng, fleet = fleet_stack["eng"], fleet_stack["fleet"]
    prompts = [[5, 9, 1], [2, 4, 8, 16], [7, 7]]
    ref = [eng.generate(p, 6, timeout=60)["tokens"] for p in prompts]
    w0 = eng._workers[0]
    chaos.add_rule("serving.decode_step", "delay", 2.0,
                   match={"replica": w0.rid, "generation": w0.generation})
    wd = HealthWatchdog(fleet, exec_deadline_s=0.3, beat_deadline_s=60.0,
                        backoff_s=0.1)
    handles = [eng.submit(p, 6) for p in prompts]
    acted, deadline = 0, time.monotonic() + 30
    while time.monotonic() < deadline and not acted:
        acted = wd.poll_once()
        time.sleep(0.05)
    assert acted and wd.counters["watchdog_revives"] >= 1
    assert [h.result(60)["tokens"] for h in handles] == ref
    assert eng.metrics.snapshot()["failed_total"] == 0


def test_autoscaler_drives_the_fleet(fleet_stack):
    fleet, router = fleet_stack["fleet"], fleet_stack["stack"].router
    url, eng = fleet_stack["stack"].url, fleet_stack["eng"]
    n0 = len(eng._active())
    assert len([r for r in fleet.replica_states()
                if r["state"] == "active"]) == n0
    # any hop latency over 1 us reads as overload: one poll scales up
    auto = ReplicaAutoscaler(fleet, policy=ScalingPolicy(
        min_replicas=1, max_replicas=n0 + 1, up_p95_ms=1e-3,
        up_consecutive=1, up_cooldown_s=0.0))
    try:
        assert router.scale_headroom_fn is not None
        assert int(router.scale_headroom_fn()) == 1
        assert post(url + "/generate", {"input_ids": PROMPT,
                                        "max_new_tokens": 2})[0] == 200
        sig = auto._signals()
        assert {"replicas", "queue_depth", "p95_ms"} <= set(sig)
        assert sig["replicas"] == n0 and sig["p95_ms"] > 1e-3
        assert auto.poll_once() == 1
        assert len(eng._active()) == n0 + 1
        assert auto.counters["scale_ups"] == 1
        assert auto.poll_once() == 0            # at max_replicas
        assert int(router.scale_headroom_fn()) == 0
    finally:
        auto.close()
    assert router.scale_headroom_fn is None
    fleet.remove_replica(drain=True)
    assert len(eng._active()) == n0


# =================================================================== CLI --
def test_door_cli_refuses_embed(capsys):
    assert door_cli.main(["--embed", "--store", "127.0.0.1:1"]) == 2
    assert "ROADMAP queue 6" in capsys.readouterr().err
    assert door_cli.main(["--store", ""]) == 2
    assert "--store" in capsys.readouterr().err


def _stop_procs(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate(timeout=10)


def test_cli_door_and_fabric_host():
    store = TCPStore(is_master=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("FABRIC_STORE", None)
    procs = []
    try:
        door = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.fabric",
             "--store", f"127.0.0.1:{store.port}", "--lease_s", "2.0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(door)
        host = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
             "--generate", "gpt3-tiny", "--http", "0", "--device", "cpu",
             "--slots", "4", "--fabric", f"127.0.0.1:{store.port}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(host)
        line = door.stdout.readline().strip()
        assert line.startswith("DOOR="), (line, door.stderr.read()[-2000:])
        client = pf.FleetClient([line.split("=", 1)[1]], timeout_s=30.0)
        # the host builds its model while this process does the same
        model = serve.build_model("gpt3-tiny", None, "cpu")
        prompt = [int(t) for t in np.random.RandomState(5).randint(
            0, 1024, 20)]
        eng = GenerativeEngine(model, device="cpu", slots=4)
        try:
            want = eng.generate(prompt, NEW)["tokens"]
        finally:
            eng.shutdown(drain=False)
        deadline = time.monotonic() + CLI_S
        while client.healthz()[1].get("hosts_alive") != 1:
            assert host.poll() is None, host.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "the host never registered"
            time.sleep(0.2)
        rows = client.rows()
        assert rows[0]["pools"] == ["generate"]
        status, body = client.generate({"input_ids": prompt,
                                        "max_new_tokens": NEW})
        assert status == 200 and body["tokens"] == want
        recs = list(client.stream_generate({"input_ids": prompt,
                                            "max_new_tokens": NEW}))
        assert [r["token"] for r in recs if "token" in r] == want
    finally:
        _stop_procs(procs)
        store.stop()


# ============================================================ registries --
def _snap(batches, occ, lat, hist, buckets, **kw):
    return {"requests_total": batches * 2, "batches_total": batches,
            "avg_batch_occupancy": occ, "max_batch_occupancy": max(hist),
            "latency_ms": {"p50": lat, "p95": 2 * lat, "p99": 3 * lat},
            "occupancy_hist": hist, "buckets": buckets, "qps": 1.5, **kw}


@pytest.mark.parametrize("section", ["serving", "fabric"])
def test_aggregate_snapshot_equals_reference(monkeypatch, section):
    """The registries' merge of several live snapshots, on the same
    snapshots in both packages (each registry's list stubbed)."""
    from paddle_tpu.inference.fabric import metrics as rfm
    from paddle_tpu.inference.serving import metrics as rsm

    from paddle_tpu_torch.inference.fabric import metrics as pfm
    from paddle_tpu_torch.inference.serving import metrics as psm

    if section == "serving":
        snaps = [_snap(4, 1.5, 10.0, {1: 2, 2: 2}, {"1|a": {"compiles": 1,
                                                          "hits": 3}}),
                 _snap(2, 3.0, 25.0, {3: 2}, {"1|a": {"compiles": 0,
                                                     "hits": 2},
                                               "2|a": {"compiles": 1,
                                                       "hits": 1}})]
        mods = (psm, rsm)
    else:
        snaps = [{"requests_total": 3, "forwards_total": 4,
                  "hop_latency_ms": {"p50": 1.0}, "hosts_alive": 2,
                  "streams_total": 1},
                 {"requests_total": 5, "forwards_total": 6,
                  "hop_latency_ms": {"p50": 2.0}, "hosts_alive": 2,
                  "streams_total": 2}]
        mods = (pfm, rfm)
    outs = []
    for mod in mods:
        for n in (0, 1, 2):
            monkeypatch.setattr(mod._REGISTRY, "snapshots",
                                lambda n=n: [dict(s) for s in snaps[:n]])
            outs.append(mod.aggregate_snapshot())
    assert outs[:3] == outs[3:]
    assert outs[0] is None and outs[1] == snaps[0]
    if section == "serving":
        assert outs[2]["batches_total"] == 6 and outs[2]["engines"] == 2
        assert outs[2]["avg_batch_occupancy"] == 2.0
        assert outs[2]["buckets"]["1|a"] == {"compiles": 1, "hits": 5}
    else:
        assert outs[2]["requests_total"] == 8 and outs[2]["routers"] == 2
        assert outs[2]["hosts_alive"] == 2          # not summed


def test_registries_track_live_engines_only():
    import gc

    from paddle_tpu_torch.inference.serving.metrics import (EngineRegistry,
                                                            ServingMetrics)

    class _Eng:
        def __init__(self):
            self.metrics = ServingMetrics()

    reg = EngineRegistry("serving", None)
    a, b = _Eng(), _Eng()
    reg.track(a)
    reg.track(b)
    assert len(reg.snapshots()) == 2
    del b
    gc.collect()
    assert len(reg.snapshots()) == 1 and len(reg._engines) == 1
