"""KV-slot handoff wire format: one live decode stream, serialized
(counterpart of paddle_tpu/inference/fabric/handoff.py, byte for byte
the same format, so a stream exported by either package continues on
the other).

A serving host exports one request's live generation state: the
per-layer K/V pool row raw in its stored dtype (an int8 pool row travels
as int8 data plus its per-layer scale), and the row metadata the
scheduler needs to continue the stream bitwise: position, emitted
tokens, the PRNG key-chain cursor, sampling parameters and prefix-cache
lineage. Another host imports the payload into a free slot over its
`/admin/kv/import` plane and the stream continues token for token (one
key split per emitted token: the cursor is the chain's state).

Layout (all integers little-endian)::

    b"PDKV" | u16 version | u32 header_len | header JSON | raw buffers

The header is ``{"meta": {...}, "arrays": [{name, dtype, shape,
nbytes}, ...]}``; array payloads follow back to back in table order,
C-contiguous. No pickling and no framework types.

Stdlib and numpy only. `prefix_hash` is the prompt-head content key;
the engine's prefix cache keeps its own copy
(`serving.generate._prefix_hash`), which a test holds equal to it.
"""
from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Dict, Tuple

import numpy as np

MAGIC = b"PDKV"
VERSION = 1

# decode-side bound: a malformed header must fail fast, not allocate
_MAX_HEADER_BYTES = 1 << 20

# dtypes a payload may carry: the KV rows (f32, or int8 and f32 scales),
# the prompt ids and the PRNG key. Anything else (object arrays) is
# refused before np.frombuffer runs.
_DTYPES = ("float32", "int8", "int32", "uint32")


def prefix_hash(ids, n: int) -> str:
    """Content key of the first `n` prompt tokens: blake2b-128 hex of the
    int32 id bytes, the engine's prefix-cache key."""
    a = np.ascontiguousarray(np.asarray(ids, np.int32)[: int(n)])
    return hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest()


def to_b64(raw: bytes) -> str:
    """Payload -> JSON-safe string (the prefill handoff's result field
    and the drain migration's terminal stream line)."""
    return base64.b64encode(raw).decode("ascii")


def from_b64(s: str) -> bytes:
    return base64.b64decode(str(s).encode("ascii"), validate=True)


def encode(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize `meta` (a JSON-safe dict) and named numpy arrays, in
    order, raw in their stored dtype."""
    table = []
    chunks = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        if a.dtype.name not in _DTYPES:
            raise ValueError(
                f"handoff array {name!r} has unsupported dtype "
                f"{a.dtype.name!r} (allowed: {_DTYPES})")
        raw = a.tobytes()
        table.append({"name": str(name), "dtype": a.dtype.name,
                      "shape": [int(d) for d in a.shape],
                      "nbytes": len(raw)})
        chunks.append(raw)
    header = json.dumps({"meta": meta, "arrays": table},
                        separators=(",", ":")).encode()
    if len(header) > _MAX_HEADER_BYTES:
        raise ValueError(
            f"handoff header {len(header)} bytes exceeds the "
            f"{_MAX_HEADER_BYTES}-byte bound")
    return b"".join([MAGIC, struct.pack("<H", VERSION),
                     struct.pack("<I", len(header)), header] + chunks)


def decode(raw: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Parse one payload back to `(meta, arrays)`. Every bound is checked
    before any buffer is read; anything malformed raises ValueError
    (callers answer 400)."""
    if len(raw) < 10 or raw[:4] != MAGIC:
        raise ValueError("not a KV-handoff payload (bad magic)")
    (version,) = struct.unpack_from("<H", raw, 4)
    if version != VERSION:
        raise ValueError(f"handoff version {version} != {VERSION}")
    (hlen,) = struct.unpack_from("<I", raw, 6)
    if hlen > _MAX_HEADER_BYTES or 10 + hlen > len(raw):
        raise ValueError(f"handoff header length {hlen} out of bounds")
    try:
        header = json.loads(raw[10:10 + hlen].decode())
        meta = header["meta"]
        table = header["arrays"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"bad handoff header: {e!r}"[:500]) from None
    if not isinstance(meta, dict) or not isinstance(table, list):
        raise ValueError("bad handoff header structure")
    arrays: Dict[str, np.ndarray] = {}
    off = 10 + hlen
    for ent in table:
        try:
            name = str(ent["name"])
            dtype = str(ent["dtype"])
            shape = tuple(int(d) for d in ent["shape"])
            nbytes = int(ent["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad handoff array entry: {e!r}"[:200]) \
                from None
        if dtype not in _DTYPES:
            raise ValueError(f"handoff array {name!r} dtype {dtype!r} "
                             f"not allowed")
        dt = np.dtype(dtype)
        if any(d < 0 for d in shape) or nbytes < 0 or \
                int(np.prod(shape, dtype=np.int64)) * dt.itemsize != nbytes:
            raise ValueError(
                f"handoff array {name!r} shape/size mismatch")
        if off + nbytes > len(raw):
            raise ValueError(f"handoff payload truncated at {name!r}")
        arrays[name] = np.frombuffer(
            raw, dtype=dt, count=nbytes // dt.itemsize,
            offset=off).reshape(shape)
        off += nbytes
    if off != len(raw):
        raise ValueError(
            f"handoff payload has {len(raw) - off} trailing bytes")
    return meta, arrays


__all__ = ["MAGIC", "VERSION", "prefix_hash", "encode", "decode",
           "to_b64", "from_b64"]
