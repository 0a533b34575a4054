"""The port's rendezvous store (paddle_tpu_torch/distributed/store.py) on
the CPU: the native TCPStore (cpp/tcpstore.cc built alone into build/store/)
against itself and against the reference's paddle_tpu.distributed.store in
both directions (a port client on a reference server, a reference client
on a port server), the in-process fallback, the CAS-guarded JSON indexes
under a thread race, the bounded retry, ReplicatedStore's failover, and
QuorumStore over three in-process port servers: it keeps writing after one
server stops, and the reference's QuorumStore reads back what the port
wrote (the epoch envelope is one wire format)."""
import threading
import time
from pathlib import Path

import pytest

from paddle_tpu.distributed import store as ref_store

from paddle_tpu_torch.distributed import store as st
from paddle_tpu_torch.testing import chaos

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def _stop(*stores):
    for s in stores:
        try:
            s.stop()
        except Exception:  # noqa: BLE001
            pass


def _surface(client):
    """The TCPStore surface on `client`, whatever server it talks to."""
    client.set("a", "x")
    assert client.get("a") == b"x"
    assert client.get("missing") == b""
    assert client.add("n", 3) == 3
    assert client.add("n", -1) == 2
    assert client.compare_set("a", "x", "y") == b"y"
    assert client.compare_set("a", "x", "z") == b"y"      # lost: current
    assert client.compare_set("new", "", "v") == b"v"     # absent == ""
    assert client.wait("a", timeout=1.0) == b"y"
    client.set("empty", b"")
    assert client.wait("empty", timeout=1.0) == b""       # present, empty
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.2)
    assert time.monotonic() - t0 < 2.0
    assert client.keys() == ["a", "empty", "n", "new"]
    assert client.keys("n") == ["n", "new"]
    client.delete_key("new")
    assert client.keys("n") == ["n"]


def test_library_builds_under_build_store():
    lib = st._load_lib()
    assert lib is not None, "g++ could not build cpp/tcpstore.cc"
    path = st.lib_path()
    assert path.exists() and path.parent == ROOT / "build" / "store"
    assert path.name.startswith("libtcpstore_")
    # the same source and flags name the same file: no rebuild
    assert st.lib_path() == path


def test_port_server_port_client():
    srv = st.TCPStore(is_master=True)
    cli = st.TCPStore("127.0.0.1", srv.port, timeout=5.0)
    try:
        assert srv._py is None and cli._py is None   # native, not fallback
        _surface(cli)
        # the master's own client sees the same table
        assert srv.get("a") == b"y"
    finally:
        _stop(cli, srv)


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_cross_package_client_and_server(server_side):
    """A port client against the reference's server, and the reference's
    client against the port's server: one protocol."""
    if server_side == "reference":
        srv = ref_store.TCPStore(is_master=True)
        cli = st.TCPStore("127.0.0.1", srv.port, timeout=5.0)
        other = ref_store.TCPStore("127.0.0.1", srv.port, timeout=5.0)
    else:
        srv = st.TCPStore(is_master=True)
        cli = ref_store.TCPStore("127.0.0.1", srv.port, timeout=5.0)
        other = st.TCPStore("127.0.0.1", srv.port, timeout=5.0)
    try:
        _surface(cli)
        # what one package wrote, the other reads
        assert other.get("a") == b"y" and other.add("n", 1) == 3
        st.index_add(cli if server_side == "reference" else other,
                     "idx", "h1")
        ref_store.index_add(other if server_side == "reference" else cli,
                            "idx", "h0")
        assert st.index_members(other, "idx") == ["h0", "h1"]
        assert ref_store.index_members(cli, "idx") == ["h0", "h1"]
    finally:
        _stop(cli, other, srv)


def test_fallback_store_surface():
    fb = st._PyFallbackStore()
    fb.set("k", b"v")
    assert fb.get("k") == b"v" and fb.get("x") == b""
    assert fb.add("c", 2) == 2 and fb.add("c", 3) == 5
    assert fb.wait("k", 0.1) == b"v"
    with pytest.raises(TimeoutError):
        fb.wait("never", 0.05)
    assert fb.keys() == ["c", "k"] and fb.keys("k") == ["k"]


@pytest.mark.parametrize("threads", [2, 4])
def test_index_cas_race_converges(threads):
    """Writers racing on the JSON index lose no entry: every add goes
    through compare_set on the native server."""
    srv = st.TCPStore(is_master=True)
    clients = [st.TCPStore("127.0.0.1", srv.port, timeout=10.0)
               for _ in range(threads)]
    errs = []

    def add_many(c, tag):
        try:
            for i in range(15):
                st.index_add(c, "idx", f"{tag}{i}")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=add_many, args=(c, f"t{k}-"))
          for k, c in enumerate(clients)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs
        assert len(st.index_members(srv, "idx")) == 15 * threads
        st.index_discard(clients[0], "idx", "t0-0")
        assert "t0-0" not in st.index_members(srv, "idx")
    finally:
        _stop(*clients, srv)


def test_retry_transient_bounds_and_passes_timeouts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("reset")
        return "ok"

    before = st.COUNTERS["store_retries"]
    assert st.retry_transient(flaky, attempts=3, base=0.001) == "ok"
    assert len(calls) == 3 and st.COUNTERS["store_retries"] == before + 2
    calls.clear()
    with pytest.raises(ConnectionError):
        st.retry_transient(flaky, attempts=2, base=0.001)
    assert len(calls) == 2

    def not_yet():
        calls.append(1)
        raise TimeoutError("not yet")

    calls.clear()
    with pytest.raises(TimeoutError):
        st.retry_transient(not_yet, attempts=5, base=0.001)
    assert len(calls) == 1                     # a "not yet" never retries


def test_store_chaos_site_is_retried_but_add_is_not():
    srv = st.TCPStore(is_master=True)
    try:
        srv.set("k", "v")
        chaos.add_rule("store.get", "raise_n", 2)
        assert srv.get("k") == b"v"            # 2 faults, 3 attempts
        chaos.reset()
        chaos.add_rule("store.add", "raise_n", 1)
        with pytest.raises(chaos.ChaosError):
            srv.add("c", 1)                    # non-idempotent: no replay
        chaos.reset()
        assert srv.add("c", 1) == 1            # the faulted add never ran
    finally:
        _stop(srv)


def test_replicated_store_fails_over():
    a, b = st.TCPStore(is_master=True), st.TCPStore(is_master=True)
    rs = st.ReplicatedStore([f"127.0.0.1:{a.port}", f" 127.0.0.1:{b.port}"],
                            timeout=3.0, probe_interval=60.0)
    try:
        rs.set("k", "v1")
        assert a.get("k") == b"v1" and b.get("k") == b"v1"
        assert rs.compare_set("k", "v1", "v2") == b"v2"
        assert b.get("k") == b"v2"
        a.stop()                               # the primary dies
        assert rs.get("k") == b"v2"            # served by the standby
        rs.set("k2", "w")
        assert b.get("k2") == b"w"
    finally:
        _stop(rs, a, b)


def _quorum(eps, mod=st, **kw):
    kw.setdefault("timeout", 10.0)
    kw.setdefault("member_timeout", 2.0)
    kw.setdefault("probe_interval", 0.5)
    kw.setdefault("epoch_ttl_s", 0.2)
    return mod.QuorumStore(eps, **kw)


def test_make_store_forms():
    ms = [st.TCPStore(is_master=True) for _ in range(3)]
    eps = [f"127.0.0.1:{m.port}" for m in ms]
    single = quorum = None
    try:
        single = st.make_store(eps[0], timeout=3.0)
        assert isinstance(single, st.TCPStore)
        single.set("x", "1")
        quorum = st.make_store(", ".join(eps), timeout=3.0)
        assert isinstance(quorum, st.QuorumStore) and quorum.quorum == 2
        assert quorum.get("x") == b"1"          # raw values pass through
        with pytest.raises(ValueError):
            st.make_store("")
    finally:
        _stop(single, quorum, *ms)


def test_quorum_store_survives_a_member_and_reference_reads_back():
    ms = [st.TCPStore(is_master=True) for _ in range(3)]
    eps = [f"127.0.0.1:{m.port}" for m in ms]
    q = _quorum(eps)
    ref = None
    try:
        q.set("k", "v1")
        assert q.get("k") == b"v1"
        assert q.compare_set("k", "v1", "v2") == b"v2"
        assert q.compare_set("k", "bogus", "v3") == b"v2"
        st.index_add(q, "fabric/hosts", "h1")
        # the envelope is on the wire: a direct member read shows it
        raw = st.TCPStore(port=ms[1].port, timeout=2.0)
        assert raw.get("k").startswith(b"q1|")
        raw.stop()
        # one of three members stops (the primary, endpoint order's first)
        ms[0].stop()
        q.set("k", "v4")                        # quorum 2 of 3 still writes
        st.index_add(q, "fabric/hosts", "h2")
        assert q.get("k") == b"v4"
        assert q.counters_snapshot()["failovers"] >= 1
        assert q.add("cnt", 2) == 2
        # the reference's QuorumStore over the same members reads it back
        ref = _quorum(eps, mod=ref_store)
        assert ref.get("k") == b"v4"
        assert ref_store.index_members(ref, "fabric/hosts") == ["h1", "h2"]
        # and the port reads what the reference writes
        ref.set("r", "from-ref")
        assert q.get("r") == b"from-ref"
        # below quorum: a hard error, never a minority serving
        ms[1].stop()
        with pytest.raises(RuntimeError):
            _quorum(eps, timeout=1.0).set("k", "v5")
    finally:
        _stop(q, ref, *ms)
