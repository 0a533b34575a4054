"""Device places (counterpart of paddle_tpu/core/place.py): a `Place`
binds a torch.device, and the current place is where creation ops and
`to_tensor` put new tensors and where entry points run when the caller
names no device.

The current place starts as the first card (`gpu:0`). Nothing falls back
to the CPU: a tensor made there with no card present raises, and
`set_device("cpu")` is how a caller asks for the CPU. "tpu" names the card
too, so a program written against the reference runs unchanged.
"""
from __future__ import annotations

import torch

_NO_CARD = ("paddle_tpu_torch: no CUDA device is available; call "
            "set_device('cpu') or pass device='cpu' to run on the CPU")


class Place:
    def __init__(self, device):
        self.device = torch.device(device)

    @property
    def platform(self) -> str:
        return "cpu" if self.device.type == "cpu" else "gpu"

    def is_cpu_place(self) -> bool:
        return self.device.type == "cpu"

    def is_gpu_place(self) -> bool:
        return self.device.type == "cuda"

    def get_device_id(self) -> int:
        return self.device.index or 0

    def __repr__(self):
        if self.is_cpu_place():
            return "Place(cpu)"
        return f"Place(gpu:{self.get_device_id()})"

    def __eq__(self, other):
        return isinstance(other, Place) and self.device == other.device

    def __hash__(self):
        return hash(self.device)


def CPUPlace() -> Place:
    return Place("cpu")


def CUDAPlace(idx: int = 0) -> Place:
    """The card `idx`; raises when there is no card, as the reference's
    TPUPlace raises without a TPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    if not 0 <= int(idx) < torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {idx}: "
                           f"{torch.cuda.device_count()} present")
    return Place(torch.device("cuda", int(idx)))


TPUPlace = CUDAPlace

_current = Place(torch.device("cuda", 0))


def set_device(device: str) -> Place:
    """'cpu', 'gpu', 'gpu:1' ('cuda' and 'tpu' name the card too). Naming
    the card without one raises."""
    global _current
    platform, _, idx = str(device).partition(":")
    if platform == "cpu":
        place = CPUPlace()
    elif platform in ("gpu", "cuda", "tpu"):
        place = CUDAPlace(int(idx) if idx else 0)
    else:
        raise ValueError(f"unknown device {device!r}: expected 'cpu' or "
                         f"'gpu[:N]'")
    _current = place
    return place


def current_place() -> Place:
    return _current


def get_device() -> str:
    p = _current
    return "cpu" if p.is_cpu_place() else f"gpu:{p.get_device_id()}"


def current_device() -> torch.device:
    """The current place's device: where an entry point runs when the
    caller names none. The card's raises when there is none, so nothing
    runs quietly on the CPU."""
    p = _current
    if p.is_gpu_place() and not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    return p.device


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device: a Place, a torch.device or a string
    ("cpu", "gpu:0"; "cuda" and "tpu" name the card too). None means
    the current place's (`current_device()`)."""
    if device is None:
        return current_device()
    if isinstance(device, Place):
        return device.device
    if isinstance(device, str):
        platform, _, idx = device.partition(":")
        if platform in ("gpu", "tpu"):
            device = "cuda" + (f":{idx}" if idx else "")
    return torch.device(device)


def is_compiled_with_cuda() -> bool:
    return True
