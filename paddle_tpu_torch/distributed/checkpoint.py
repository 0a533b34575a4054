"""Durable single-file writes (counterpart of the reference's
paddle_tpu/distributed/checkpoint, cut to `atomic_write_json`, which the
exported model's metadata is written with)."""
from __future__ import annotations

import json
import os


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # no directory descriptors here: the rename is atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj, indent=None) -> None:
    """Write `obj` as JSON to `path` so that a crash leaves the old file or
    the new one, never a torn one: a temporary file, fsync, os.replace,
    then fsync of the parent directory."""
    tmp = path + ".tmp"
    data = json.dumps(obj, indent=indent)
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


__all__ = ["atomic_write_json"]
