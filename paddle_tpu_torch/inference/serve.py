"""Serve a saved model, or streaming generation (counterpart of
paddle_tpu/inference/serve.py):

    python -m paddle_tpu_torch.inference.serve PREFIX [--device cpu]
    python -m paddle_tpu_torch.inference.serve PREFIX --engine \\
        [--http PORT] [--max-batch-size N] [--batch-timeout-ms T] ...
    python -m paddle_tpu_torch.inference.serve --generate gpt3-medium \\
        --http 8000 [--state-dict CKPT] [--device cuda|cpu] ...
    python -m paddle_tpu_torch.inference.serve [PREFIX --engine] \\
        [--generate PRESET] --http 0 --fabric STORE [--pool prefill]

PREFIX is a model saved by `jit.save(..., input_spec=...)` (or
`inference.save_inference_model`) on the device it is served on. Alone,
this module is the pipe worker behind the C deployment ABI: it speaks a
length-prefixed binary protocol over stdin/stdout, byte for byte the
reference worker's (`cpp/pd_infer.cc` starts the reference's):

  worker -> client on startup:
      magic  b"PDIS"  u32 version
      u32 n_inputs   then per input:  dtype-str blob, u32 ndim,
                                      i64 dims[ndim] (-1 = dynamic)
      u32 n_outputs  (output shapes depend on inputs; sizes travel
                      per run)
  client -> worker per request:
      b"RUN_"  then per input: u64 nbytes + raw bytes (C order, dtype
      and shape per the announced spec; a single dynamic dim is resolved
      by size; two dynamic dims in one input are ambiguous from a byte
      count and fail that request with an ERR_)
  worker -> client per response:
      b"OUT_"  u32 n_outputs  then per output: dtype-str blob, u32 ndim,
      i64 dims[ndim], u64 nbytes + raw bytes
      on failure: b"ERR_"  u64 len + utf-8 message
  client -> worker: b"BYE_" ends the session.

stdout carries the protocol and nothing else. `--engine` routes every
RUN_ through the dynamic-batching ServingEngine; `--http PORT` serves
/predict, /healthz and /metrics over HTTP instead of the pipe (with
--generate, /generate beside them). `--generate PRESET` serves a
GenerativeEngine over a models.gpt preset (HTTP only). Everything runs
on the card unless --device says otherwise.

Without --state-dict the weights are the port's own seeded
initialisation (a torch.Generator seeded 0, drawn on the CPU, so the
same on every device): they are not the reference's demo weights, and
neither are its tokens. --state-dict reads a checkpoint that the
reference's `paddle_tpu.save(model.state_dict(), path)` wrote (a pickle
of {"__tensor__": True, "data": ndarray, ...} per parameter), or the
port's `framework_io.save` of `params_to_paddle_tpu(...)`, through
`framework_io.load` (numpy arrays only, bfloat16 ones included).

`--fabric STORE` joins the serving fabric (inference/fabric): the server
mounts the /admin plane and a HostAgent leases the host into the
registry at STORE (host:port of a TCPStore, or a comma-separated list
for a QuorumStore), where a front door (`python -m
paddle_tpu_torch.inference.fabric --store STORE`) routes to it. `--pool`
overrides the host's pools (comma list; `prefill` or `decode` make it a
member of a disaggregated-serving pool).
"""
from __future__ import annotations

import argparse
import io
import struct
import sys

import numpy as np

MAGIC = b"PDIS"
VERSION = 1


def _w(fh, data: bytes):
    fh.write(data)


def _blob(fh, b: bytes):
    _w(fh, struct.pack("<Q", len(b)) + b)


def _read_exact(fh, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = fh.read(n - len(buf))
        if not chunk:
            raise EOFError("client closed the pipe")
        buf += chunk
    return buf


def decode_input(raw: bytes, spec: dict, index: int) -> np.ndarray:
    """One input array from its raw bytes and announced spec. A single
    dynamic (None) dim resolves from the byte count; more than one in the
    same input is ambiguous (a size factors many ways) and raises."""
    dt = np.dtype(spec["dtype"])
    arr = np.frombuffer(raw, dtype=dt)
    shape = list(spec["shape"])
    dyn = [d for d, v in enumerate(shape) if v is None]
    if len(dyn) > 1:
        raise ValueError(
            f"input {index}: spec {spec['shape']} has {len(dyn)} dynamic "
            f"dims; the pipe protocol ships only a byte count, which "
            f"cannot resolve more than one — export with at most one "
            f"dynamic axis per input, or serve over HTTP JSON "
            f"(--engine --http) where shapes travel explicitly")
    known = 1
    for v in shape:
        if v is not None:
            known *= int(v)
    if dyn:
        if known == 0 or arr.size % max(known, 1):
            raise ValueError(
                f"input {index}: {arr.size} elements do not divide into "
                f"spec {spec['shape']}")
        shape[dyn[0]] = arr.size // max(known, 1)
    return arr.reshape(shape)


def run_worker(prefix: str, runner=None, predictor=None,
               device=None) -> int:
    """Speak the pipe protocol until BYE_ or the end of stdin.
    `runner(inputs) -> outputs` defaults to the Predictor's run, or is the
    ServingEngine's predict under --engine (which passes its loaded
    `predictor`, so the program is not loaded twice). `device`: where a
    Predictor of our own runs (None: the card)."""
    # stdout is the protocol channel: anything else printed must not
    # reach it
    proto_out = sys.stdout.buffer
    sys.stdout = sys.stderr

    from . import Predictor, config_for

    pred = predictor if predictor is not None else \
        Predictor(config_for(prefix, device))
    specs = pred._meta["input_specs"]
    if runner is None:
        runner = pred.run

    _w(proto_out, MAGIC + struct.pack("<I", VERSION))
    _w(proto_out, struct.pack("<I", len(specs)))
    for s in specs:
        _blob(proto_out, s["dtype"].encode())
        dims = [(-1 if d is None else int(d)) for d in s["shape"]]
        _w(proto_out, struct.pack("<I", len(dims)))
        _w(proto_out, struct.pack(f"<{len(dims)}q", *dims))
    _w(proto_out, struct.pack("<I", len(pred._meta["output_names"])))
    proto_out.flush()

    fin = sys.stdin.buffer
    while True:
        try:
            op = _read_exact(fin, 4)
        except EOFError:
            return 0
        if op == b"BYE_":
            return 0
        if op != b"RUN_":
            _w(proto_out, b"ERR_")
            _blob(proto_out, f"bad opcode {op!r}".encode())
            proto_out.flush()
            return 1
        # read every input's bytes before decoding any: a decode error
        # must not leave later blobs unread in the pipe (they would parse
        # as the next opcode)
        raws = []
        for _ in specs:
            (nbytes,) = struct.unpack("<Q", _read_exact(fin, 8))
            raws.append(_read_exact(fin, nbytes))
        try:
            inputs = [decode_input(raw, s, i)
                      for i, (s, raw) in enumerate(zip(specs, raws))]
            outs = runner(inputs)
            # the whole reply is built before any byte of it is written:
            # a failure mid-way must not leave half an OUT_ on the wire
            reply = io.BytesIO()
            _w(reply, b"OUT_" + struct.pack("<I", len(outs)))
            for o in outs:
                o = np.ascontiguousarray(o)
                _blob(reply, str(o.dtype).encode())
                _w(reply, struct.pack("<I", o.ndim))
                _w(reply, struct.pack(f"<{o.ndim}q", *o.shape))
                _blob(reply, o.tobytes())
            _w(proto_out, reply.getvalue())
            proto_out.flush()
        except Exception as e:  # noqa: BLE001 — surface to the client
            _w(proto_out, b"ERR_")
            _blob(proto_out, repr(e)[:4000].encode())
            proto_out.flush()


def load_reference_state_dict(path: str) -> dict:
    """{parameter name: CPU tensor} of a checkpoint that
    `paddle_tpu.save(model.state_dict(), path)` wrote."""
    import torch

    from ..framework_io import load

    obj = load(path)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state_dict (got "
                         f"{type(obj).__name__})")
    for name, ent in obj.items():
        if not isinstance(ent, torch.Tensor):
            raise ValueError(f"{path}: entry {name!r} is not a saved tensor")
    return {str(n): t for n, t in obj.items()}


def build_model(preset: str, state_dict, device):
    """The PRESET's GPTForCausalLM on `device`, in eval mode: the
    seeded initialisation drawn on the CPU, then the checkpoint's
    weights when `state_dict` (a path) is given."""
    import torch

    from ..framework_io import params_from_paddle_tpu
    from ..models import PRESETS, GPTForCausalLM

    model = GPTForCausalLM(PRESETS[preset], device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if state_dict:
        model.load_state_dict(params_from_paddle_tpu(
            load_reference_state_dict(state_dict)))
    return model.to(device).eval()


def main(argv=None) -> int:
    from ..models import PRESETS

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.inference.serve",
        description="serve a saved .pdmodel: the pipe-protocol worker by "
                    "default, the dynamic-batching engine with --engine, "
                    "HTTP with --http PORT; or streaming generation from "
                    "a models.gpt preset with --generate")
    ap.add_argument("prefix", nargs="?", default=None,
                    help="model path prefix (the .pdmodel stem); "
                         "optional with --generate")
    ap.add_argument("--engine", action="store_true",
                    help="route requests through the ServingEngine "
                         "(bucketed dynamic batching, warm replicas)")
    ap.add_argument("--http", type=int, metavar="PORT", default=None,
                    help="serve HTTP on PORT instead of the stdin/stdout "
                         "pipe (implies --engine)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch-size", type=int, default=None)
    ap.add_argument("--batch-timeout-ms", type=float, default=None)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--generate", metavar="PRESET", default=None,
                    help="serve streaming generation (/generate) from a "
                         "models.gpt PRESET (e.g. gpt3-tiny): the port's "
                         "seeded weights (not the reference's demo "
                         "weights, so not its tokens), or --state-dict")
    ap.add_argument("--state-dict", default=None,
                    help="a checkpoint for the --generate model (float32 "
                         "or bfloat16), as paddle_tpu.save(model."
                         "state_dict(), path) writes it")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode-batch capacity per worker")
    ap.add_argument("--draft", metavar="PRESET", default=None,
                    help="speculative decoding: a models.gpt draft preset "
                         "(e.g. tiny-draft, seeded weights) proposing "
                         "tokens the --generate model verifies")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="tokens per speculative burst (with --draft)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="prefix-cache rows per worker")
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default="f32",
                    help="KV pool precision: int8 rows with per-(row, "
                         "layer) absmax scales")
    ap.add_argument("--quantize-weights", action="store_true",
                    help="weight-only int8 for the model (and draft)")
    ap.add_argument("--admin", action="store_true",
                    help="mount the /admin plane (scale, drain, "
                         "/admin/kv handoff import); keep the port "
                         "private")
    ap.add_argument("--fabric", metavar="STORE", default=None,
                    help="join the serving fabric: registry "
                         "endpoint(s) (host:port, comma-separated for "
                         "a quorum); implies --admin")
    ap.add_argument("--pool", default=None,
                    help="fabric role override, comma list: 'prefill' "
                         "or 'decode' makes this host a member of a "
                         "disaggregated-serving pool (default: derived "
                         "from the mounted fronts)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu runs "
                         "it on the host)")
    args = ap.parse_args(argv)

    if args.pool is not None and args.fabric is None:
        ap.error("--pool needs --fabric STORE")
    if args.fabric is not None and args.http is None:
        ap.error("--fabric needs --http PORT (the fleet routes over "
                 "HTTP)")
    if args.generate is None and args.prefix is None:
        ap.error("need a model prefix (or --generate PRESET)")
    if args.generate is not None and args.http is None:
        ap.error("--generate needs --http PORT (streaming rides HTTP)")
    for preset in (args.generate, args.draft):
        if preset is not None and preset not in PRESETS:
            ap.error(f"unknown preset {preset!r}; have {sorted(PRESETS)}")

    import torch

    device = torch.device(args.device)
    if not args.engine and args.http is None:
        return run_worker(args.prefix, device=device)

    from .serving import GenerativeEngine, ServingEngine, ServingHTTPServer

    generator = None
    if args.generate is not None:
        model = build_model(args.generate, args.state_dict, device)
        draft = build_model(args.draft, None, device) if args.draft \
            else None
        generator = GenerativeEngine(
            model, slots=args.slots, replicas=args.replicas or 1,
            max_queue_depth=args.max_queue_depth, draft=draft,
            spec_tokens=args.spec_tokens,
            prefix_cache_slots=args.prefix_cache, kv_dtype=args.kv_dtype,
            quantize_weights=args.quantize_weights, device=device)
    engine = None
    if args.prefix is not None:
        engine = ServingEngine(
            args.prefix, max_batch_size=args.max_batch_size,
            batch_timeout_ms=args.batch_timeout_ms, replicas=args.replicas,
            max_queue_depth=args.max_queue_depth, device=device)
    if args.http is not None:
        admin = bool(args.admin or args.fabric)
        srv = ServingHTTPServer(engine, host=args.host, port=args.http,
                                generator=generator, admin=admin)
        agent = None
        if args.fabric:
            from ..distributed.store import make_store
            from .fabric import HostAgent

            pools = None
            if args.pool:
                pools = [p.strip() for p in args.pool.split(",")
                         if p.strip()]
            agent = HostAgent(srv, make_store(args.fabric),
                              pools=pools).start()
        what = []
        if engine is not None:
            what.append(f"predict[{args.prefix}]")
        if generator is not None:
            what.append(f"generate[{args.generate}]")
        if agent is not None:
            what.append(f"fabric[{','.join(agent.lease.pools)}]")
        print(f"serving {' + '.join(what)} on {device} at "
              f"http://{srv.host}:{srv.port}", file=sys.stderr, flush=True)
        try:
            srv.serve_forever()
        finally:
            if agent is not None:
                agent.stop()
        return 0
    try:
        return run_worker(args.prefix, runner=engine.predict,
                          predictor=engine._predictor)
    finally:
        engine.shutdown(drain=True)


if __name__ == "__main__":
    sys.exit(main())
