"""The port's pipe worker (paddle_tpu_torch.inference.serve.run_worker,
the C deployment ABI's protocol) against the reference worker's, case for
case tests/test_serve_protocol.py.

Both workers run in this process over in-memory stdin/stdout (run_worker
reads sys.stdin.buffer and writes sys.stdout.buffer), on models both
packages saved with the same numpy weights: their handshakes are equal
byte for byte, and so are whole sessions where no float is computed (an
ambiguous spec's ERR_ replies); where outputs are computed, the framing
is equal and the values agree within 1e-5 (the port's equal its eager
model's bitwise). One session runs the worker as `python -m
paddle_tpu_torch.inference.serve PREFIX --device cpu` in a subprocess.
"""
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.export as jex
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.inference import save_inference_model as jsave
from paddle_tpu.inference import serve as jserve
from paddle_tpu.static import InputSpec as JInputSpec

from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import ServingEngine, save_inference_model
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.static import InputSpec

from test_torch_inference import mlp_weights, port_mlp, reference_mlp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_ATOL = 1e-5


class _Std:
    """A stand-in for sys.stdin / sys.stdout: bytes in `.buffer`."""

    def __init__(self, data=b""):
        self.buffer = io.BytesIO(data)


def session(worker, prefix, requests, monkeypatch, **kw):
    """(exit code, every byte the worker wrote) of one session over
    `requests` (bytes) in this process."""
    out = _Std()
    monkeypatch.setattr(sys, "stdin", _Std(requests))
    monkeypatch.setattr(sys, "stdout", out)
    rc = worker(prefix, **kw)
    return rc, out.buffer.getvalue()


def run_msg(arrays=None, blobs=None):
    blobs = blobs if blobs is not None else \
        [np.ascontiguousarray(a).tobytes() for a in arrays]
    return b"RUN_" + b"".join(struct.pack("<Q", len(b)) + b for b in blobs)


class Reader:
    """Parses a worker's output: the handshake, then replies."""

    def __init__(self, data):
        self.buf = io.BytesIO(data)

    def read(self, n):
        b = self.buf.read(n)
        assert len(b) == n, "the worker's output ends mid-message"
        return b

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def blob(self):
        (n,) = struct.unpack("<Q", self.read(8))
        return self.read(n)

    def handshake(self):
        assert self.read(4) == b"PDIS" and self.u32() == 1
        specs = []
        for _ in range(self.u32()):
            dtype = self.blob().decode()
            nd = self.u32()
            specs.append((dtype, list(struct.unpack(f"<{nd}q",
                                                    self.read(8 * nd)))))
        return specs, self.u32()

    def reply(self):
        tag = self.read(4)
        if tag == b"ERR_":
            return "ERR_", self.blob().decode()
        assert tag == b"OUT_", tag
        outs = []
        for _ in range(self.u32()):
            dtype = self.blob().decode()
            nd = self.u32()
            dims = struct.unpack(f"<{nd}q", self.read(8 * nd))
            outs.append(np.frombuffer(self.blob(), dtype).reshape(dims))
        return "OUT_", outs

    def at_end(self):
        return self.buf.read() == b""


@pytest.fixture(scope="module")
def simple(tmp_path_factory):
    """The MLP saved by both packages: (reference prefix, port prefix,
    port eager model)."""
    d = tmp_path_factory.mktemp("simple")
    weights = mlp_weights()
    jjit.save(reference_mlp(weights), str(d / "ref"),
              input_spec=[JInputSpec([None, 8], "float32")])
    tm = port_mlp(weights)
    jit.save(tm, str(d / "port"), input_spec=[InputSpec([None, 8],
                                                        "float32")],
             device="cpu")
    return str(d / "ref"), str(d / "port"), tm


def _port_worker(prefix, **kw):
    return serve.run_worker(prefix, device="cpu", **kw)


def test_handshake_bytes_equal_the_reference_worker(simple, monkeypatch):
    ref, port, _ = simple
    rc, got = session(_port_worker, port, b"BYE_", monkeypatch)
    jrc, want = session(jserve.run_worker, ref, b"BYE_", monkeypatch)
    assert rc == jrc == 0
    assert got == want
    specs, n_out = Reader(got).handshake()
    assert specs == [("float32", [-1, 8])] and n_out == 1


def test_multi_request_session_over_one_pipe(simple, monkeypatch):
    """RUN_ x k then BYE_ on one resident worker, through the dynamic
    batch dim: the port's outputs equal its eager model's bitwise and the
    reference worker's within 1e-5, in the same framing."""
    ref, port, tm = simple
    xs = [np.random.RandomState(k).randn(b, 8).astype("float32")
          for k, b in enumerate((1, 3, 2, 5))]
    msg = b"".join(run_msg([x]) for x in xs) + b"BYE_"
    rc, got = session(_port_worker, port, msg, monkeypatch)
    jrc, want = session(jserve.run_worker, ref, msg, monkeypatch)
    assert rc == jrc == 0
    r, jr = Reader(got), Reader(want)
    assert r.handshake() == jr.handshake()
    for x in xs:
        (tag, (out,)), (jtag, (jout,)) = r.reply(), jr.reply()
        assert tag == jtag == "OUT_"
        assert out.dtype == jout.dtype and out.shape == jout.shape
        with torch.no_grad():
            np.testing.assert_array_equal(out, tm(torch.from_numpy(x))
                                          .numpy())
        np.testing.assert_allclose(out, jout, rtol=0, atol=CROSS_ATOL)
    assert r.at_end() and jr.at_end()


def test_mid_session_decode_error_then_success(simple, monkeypatch):
    """A request whose bytes cannot reshape answers ERR_ and leaves the
    protocol in step: the next request on the same pipe succeeds."""
    _, port, tm = simple
    X = np.random.RandomState(0).randn(2, 8).astype("float32")
    msg = run_msg(blobs=[X.tobytes()[:-4]]) + run_msg([X]) + b"BYE_"
    rc, got = session(_port_worker, port, msg, monkeypatch)
    assert rc == 0
    r = Reader(got)
    r.handshake()
    tag, err = r.reply()
    assert tag == "ERR_" and err
    tag, (out,) = r.reply()
    assert tag == "OUT_"
    with torch.no_grad():
        np.testing.assert_array_equal(out, tm(torch.from_numpy(X)).numpy())
    assert r.at_end()


def test_engine_mode_speaks_same_protocol(simple, monkeypatch):
    """--engine routes the pipe through the dynamic batcher: the same
    wire contract and error isolation."""
    _, port, tm = simple
    eng = ServingEngine(port, max_batch_size=4, device="cpu")
    try:
        X = np.random.RandomState(0).randn(2, 8).astype("float32")
        xs = [np.random.RandomState(k).randn(k + 1, 8).astype("float32")
              for k in range(3)]
        msg = run_msg(blobs=[X.tobytes()[:-4]]) + \
            b"".join(run_msg([x]) for x in xs) + b"BYE_"
        rc, got = session(serve.run_worker, port, msg, monkeypatch,
                          runner=eng.predict, predictor=eng._predictor)
    finally:
        eng.shutdown(drain=True)
    assert rc == 0
    r = Reader(got)
    assert r.handshake() == ([("float32", [-1, 8])], 1)
    assert r.reply()[0] == "ERR_"
    for x in xs:
        tag, (out,) = r.reply()
        assert tag == "OUT_"
        with torch.no_grad():
            np.testing.assert_allclose(out, tm(torch.from_numpy(x)).numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert r.at_end()


class _TwoHeads(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.la = torch.nn.Linear(6, 3)
        self.lb = torch.nn.Linear(3, 2)

    def forward(self, a, b):
        return self.la(a), self.lb(b)


class _JTwoHeads(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.la = jnn.Linear(6, 3)
        self.lb = jnn.Linear(3, 2)

    def forward(self, a, b):
        return self.la(a), self.lb(b)


def test_multiple_inputs_each_with_dynamic_dim(tmp_path, monkeypatch):
    """Two inputs, each with one dynamic axis (announced -1), resolved
    each from its own byte count; the handshake equals the reference's."""
    rng = np.random.default_rng(3)
    jm, tm = _JTwoHeads(), _TwoHeads()
    with torch.no_grad():
        for jl, tl in ((jm.la, tm.la), (jm.lb, tm.lb)):
            w = rng.standard_normal(tuple(tl.weight.shape[::-1])) \
                .astype(np.float32)
            b = rng.standard_normal(tl.bias.shape).astype(np.float32)
            jl.weight.set_value(w)
            jl.bias.set_value(b)
            tl.weight.copy_(torch.from_numpy(w.T))
            tl.bias.copy_(torch.from_numpy(b))
    jm.eval()
    tm.eval()
    d0, d1 = jex.symbolic_shape("d0, d1")
    ref = str(tmp_path / "ref")
    jsave(ref, jm, [jax.ShapeDtypeStruct((d0, 6), jnp.float32),
                    jax.ShapeDtypeStruct((d1, 3), jnp.float32)],
          input_names=["a", "b"], output_names=["oa", "ob"])
    port = str(tmp_path / "port")
    save_inference_model(port, tm, [InputSpec([None, 6]),
                                    InputSpec([None, 3])],
                         input_names=["a", "b"], output_names=["oa", "ob"],
                         device="cpu")
    A = np.random.RandomState(0).randn(2, 6).astype("float32")
    B = np.random.RandomState(1).randn(5, 3).astype("float32")
    msg = run_msg([A, B]) + b"BYE_"
    rc, got = session(_port_worker, port, msg, monkeypatch)
    jrc, want = session(jserve.run_worker, ref, msg, monkeypatch)
    assert rc == jrc == 0
    r, jr = Reader(got), Reader(want)
    hs = r.handshake()
    assert hs == jr.handshake() == ([("float32", [-1, 6]),
                                     ("float32", [-1, 3])], 2)
    tag, outs = r.reply()
    _, jouts = jr.reply()
    assert tag == "OUT_"
    assert outs[0].shape == (2, 3) and outs[1].shape == (5, 2)
    with torch.no_grad():
        wa, wb = tm(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_array_equal(outs[0], wa.numpy())
    np.testing.assert_array_equal(outs[1], wb.numpy())
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o, jo, rtol=0, atol=CROSS_ATOL)


class _RowSum(torch.nn.Module):
    def forward(self, x):
        return x.sum(dim=1)


class _JRowSum(jnn.Layer):
    def forward(self, x):
        return paddle.sum(x, axis=1)


def test_two_dynamic_dims_in_one_input_err_without_desync(tmp_path,
                                                          monkeypatch):
    """A spec with two dynamic axes is ambiguous from a byte count: each
    request answers ERR_ and the session stays usable. No float is
    computed, so the whole session is the reference worker's byte for
    byte."""
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    jm = _JRowSum()
    jm.eval()
    jjit.save(jm, ref, input_spec=[JInputSpec([None, None], "float32")])
    jit.save(_RowSum(), port, input_spec=[InputSpec([None, None],
                                                    "float32")],
             device="cpu")
    X = np.random.RandomState(0).randn(3, 4).astype("float32")
    msg = run_msg([X]) * 2 + b"BYE_"
    rc, got = session(_port_worker, port, msg, monkeypatch)
    jrc, want = session(jserve.run_worker, ref, msg, monkeypatch)
    assert rc == jrc == 0
    assert got == want
    r = Reader(got)
    assert r.handshake() == ([("float32", [-1, -1])], 1)
    for _ in range(2):
        tag, msg = r.reply()
        assert tag == "ERR_"
        assert "dynamic" in msg and "byte count" in msg, msg
    assert r.at_end()


def test_bad_opcode_ends_the_session(simple, monkeypatch):
    ref, port, _ = simple
    rc, got = session(_port_worker, port, b"NOPE", monkeypatch)
    jrc, want = session(jserve.run_worker, ref, b"NOPE", monkeypatch)
    assert rc == jrc == 1 and got == want
    r = Reader(got)
    r.handshake()
    assert r.reply() == ("ERR_", "bad opcode b'NOPE'")


def test_worker_process_session(simple, tmp_path):
    """`python -m paddle_tpu_torch.inference.serve PREFIX --device cpu`:
    the handshake, two RUN_s through one process, BYE_ and exit 0, with
    nothing but the protocol on stdout."""
    _, port, tm = simple
    xs = [np.random.RandomState(k).randn(b, 8).astype("float32")
          for k, b in enumerate((2, 4))]
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", port,
         "--device", "cpu"],
        input=b"".join(run_msg([x]) for x in xs) + b"BYE_",
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = Reader(proc.stdout)
    assert r.handshake() == ([("float32", [-1, 8])], 1)
    for x in xs:
        tag, (out,) = r.reply()
        assert tag == "OUT_"
        with torch.no_grad():
            np.testing.assert_array_equal(out, tm(torch.from_numpy(x))
                                          .numpy())
    assert r.at_end()
