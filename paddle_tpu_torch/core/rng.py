"""Threefry random numbers in torch (counterpart of what the reference
takes from `jax.random` and of paddle_tpu/core/rng.py).

A key is an int64 tensor [..., 2] holding the two uint32 words of a JAX
raw key; leading dims batch keys (one chain per serving row). torch's
uint32 lacks most arithmetic and shifts on the CPU and on CUDA, so the
words live in int64 and every add and shift is masked to 32 bits. The
functions follow JAX 0.9 with `jax_threefry_partitionable` on (its
default): `split` and `random_bits` hash the counters of a reshaped
64-bit iota (`iota_2x32_shape`, high words 0 below 2**32 draws); `split`
stacks the two output words, 32-bit `random_bits` XORs them.

Bits are computed on the device of the key tensor; `categorical` moves
its keys to the logits' device first, so the noise is drawn where the
logits are.

`Generator` is the reference's (key, counter) generator: `next_key()`
is `fold_in(base, counter)` after the counter's increment, the base key
being `key(seed)` until `set_key` installs another (and resets the
counter); the module's `seed(s)` and `next_key()` drive the default one,
and `rng_key_scope(k)` rebases it on `k` for a block, as the reference's
train step does for its forward. `bernoulli` draws dropout masks as
`jax.random.bernoulli` does under x64 (float64 uniforms below p).
"""
from __future__ import annotations

import math
import threading

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); int64 tensors holding uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed: int) -> torch.Tensor:
    """The key of a 64-bit seed: its high and low 32-bit words (two's
    complement for a negative seed), as the serving engine's `_seed_key`
    builds a request's key and as `jax.random.key(seed)` builds the
    reference generator's under its x64 mode."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([(s >> 32) & _M32, s & _M32], dtype=torch.int64)


def _hash_iota(keys, n: int):
    """Both Threefry words of counters 0..n-1 (high words 0) under each
    key of `keys` [..., 2]: two tensors [..., n]."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2],
                        torch.zeros_like(lo), lo)


def split(keys, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: [..., 2] keys -> [..., num, 2]."""
    b1, b2 = _hash_iota(keys, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys, data: int) -> torch.Tensor:
    """`jax.random.fold_in` of a uint32 `data` into [..., 2] keys."""
    data = torch.tensor(int(data) & _M32, dtype=torch.int64,
                        device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys, shape, width: int = 32) -> torch.Tensor:
    """`jax.random.bits`: [..., 2] keys -> [..., *shape] int64 tensors of
    uint32 values (width 32: the two words XORed), or of the top 63 bits'
    worth of uint64 values as JAX forms them (width 64: the first word
    over the second), which only `uniform`'s float64 path reads, by
    halves."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    b1, b2 = _hash_iota(keys, n)
    out = keys.shape[:-1] + shape
    if width == 32:
        return (b1 ^ b2).reshape(out)
    return b1.reshape(out), b2.reshape(out)


def uniform(keys, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform`: random mantissa bits under the exponent of
    1.0 (23 from 32 bits in float32, 52 from 64 in float64, 7 from 8 in
    bfloat16, 10 from 16 in float16: the narrow widths are the low bits
    of the 32-bit words), minus 1, scaled into [minval, maxval) in
    `dtype`, then floored at minval."""
    if dtype == torch.float32:
        bits = random_bits(keys, shape)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    elif dtype == torch.float64:
        # the 64-bit bits are hi << 32 | lo; their top 52 bits
        hi, lo = random_bits(keys, shape, 64)
        fbits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    elif dtype == torch.bfloat16:
        bits = random_bits(keys, shape) & 0xFF
        fbits = ((bits >> 1) | 0x3F80).to(torch.int16)
    elif dtype == torch.float16:
        bits = random_bits(keys, shape) & 0xFFFF
        fbits = ((bits >> 6) | 0x3C00).to(torch.int16)
    else:
        raise TypeError(f"uniform: {dtype} is not a float dtype")
    floats = fbits.view(dtype) - 1.0
    lo_v = torch.tensor(minval, dtype=dtype, device=keys.device)
    hi_v = torch.tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(lo_v, floats * (hi_v - lo_v) + lo_v)


def bernoulli(keys, p: float, shape, chunk: int = 1 << 24) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` with a Python float `p` under
    the reference's x64 mode: `uniform(key, shape, float64) < p`, as a
    bool tensor on the key's device. The counters are hashed `chunk` at a
    time, so the int64 words of a large mask never live at once."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    if n >= 1 << 32:
        raise ValueError(f"bernoulli: {n} draws need the high counter "
                         f"words, which this port does not form")
    out = torch.empty(n, dtype=torch.bool, device=keys.device)
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    for lo in range(0, n, chunk):
        ctr = torch.arange(lo, min(n, lo + chunk), dtype=torch.int64,
                           device=keys.device)
        hi, low = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
        # uniform's float64: the top 52 of the 64 bits under 1.0's
        # exponent, minus 1 (scaled by 1 and floored at 0: unchanged)
        fbits = (hi << 20) | (low >> 12) | 0x3FF0000000000000
        out[lo:lo + ctr.numel()] = (fbits.view(torch.float64) - 1.0) < p
    return out.reshape(shape)


def gumbel(keys, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.gumbel`, its "low" mode: -log(-log(u)) with u uniform
    in [tiny, 1) of `dtype`."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(keys, shape, tiny, 1.0, dtype)))


def normal(keys, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal`: sqrt(2) * erfinv(u), u uniform in
    (-1, 1) of `dtype` (its lower bound the float next above -1)."""
    lo = -(1.0 - torch.finfo(dtype).eps / 2)
    u = uniform(keys, shape, lo, 1.0, dtype)
    sqrt2 = torch.tensor(2.0, dtype=torch.float64).sqrt().to(dtype)
    return sqrt2.to(u.device) * torch.erfinv(u)


def _umod(x, span: int):
    """x mod span for int64 tensors holding 64-bit unsigned bit patterns
    (0 < span < 2**62)."""
    low = torch.remainder(x & 0x7FFFFFFFFFFFFFFF, span)
    return torch.where(x < 0, torch.remainder(low + (1 << 63) % span, span),
                       low)


def randint(keys, shape, minval: int, maxval: int,
            dtype=torch.int64) -> torch.Tensor:
    """`jax.random.randint`: two draws of `nbits` random bits (32 or 64;
    narrower dtypes are drawn as int32 and cast) reduced modulo the span
    maxval - minval as JAX reduces them, in wrapping unsigned
    arithmetic."""
    shape = tuple(int(d) for d in shape)
    info = torch.iinfo(dtype)
    if info.bits < 32:
        lo = min(max(int(minval), info.min), info.max)
        hi = min(max(int(maxval), info.min), info.max + 1)
        return randint(keys, shape, lo, hi, torch.int32).to(dtype)
    nbits = info.bits
    lo = max(int(minval), info.min)
    hi = min(int(maxval), info.max)
    # as JAX: span 1 when maxval <= minval, one more when maxval is past
    # the dtype's largest value
    span_v = 1 if hi <= lo else hi - lo + (int(maxval) > info.max)
    if span_v >= 1 << 62:
        raise NotImplementedError(f"randint: a span of {span_v} needs "
                                  f"unsigned 64-bit remainders")
    k = split(keys)
    k1, k2 = k[..., 0, :], k[..., 1, :]
    if nbits == 32:
        higher = random_bits(k1, shape)
        lower = random_bits(k2, shape)
        # JAX squares 2**16 mod span in uint32, which wraps
        mult = ((1 << 16) % span_v) ** 2 % (1 << 32) % span_v
        off = (((higher % span_v) * mult) & _M32) + lower % span_v
        off = (off & _M32) % span_v
    else:
        h1, h2 = random_bits(k1, shape, 64)
        l1, l2 = random_bits(k2, shape, 64)
        higher = (h1 << 32) | h2
        lower = (l1 << 32) | l2
        mult = ((1 << 32) % span_v) ** 2 % (1 << 64) % span_v
        off = _umod(_umod(higher, span_v) * mult + _umod(lower, span_v),
                    span_v)
    return (lo + off).to(dtype)


def permutation(keys, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: arange(n) sorted by fresh 32-bit
    keys, stably, once per round (3 log n / log(2**32 - 1) rounds, at
    least one for n > 1), each round's keys drawn from a split."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        k = split(keys)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def poisson(keys, lam: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """`jax.random.poisson` with rates `lam` (as float32): Knuth's
    product of uniforms where lam < 10, Hormann's transformed rejection
    elsewhere, both drawn from the same key, and 0 where lam is 0. Each
    loop runs while any element still needs a draw."""
    lam = lam.to(torch.float32)
    shape = tuple(lam.shape)
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_k = torch.where(use_knuth, lam, 0.0)
    lam_r = torch.where(use_knuth, 1e5, lam)
    # Knuth
    k = torch.zeros(shape, dtype=dtype, device=lam.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=lam.device)
    rng = keys
    while bool((log_prod > -lam_k).any()):
        s = split(rng)
        rng, sub = s[..., 0, :], s[..., 1, :]
        k = torch.where(log_prod > -lam_k, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, shape))
    knuth = k - 1
    # transformed rejection
    log_lam = torch.log(lam_r)
    b = 0.931 + 2.53 * torch.sqrt(lam_r)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    rng = keys
    while not bool(accepted.all()):
        s = split(rng, 3)
        rng, s0, s1 = s[..., 0, :], s[..., 1, :], s[..., 2, :]
        u = uniform(s0, shape) - 0.5
        v = uniform(s1, shape)
        us = 0.5 - torch.abs(u)
        kk = torch.floor((2 * a / us + b) * u + lam_r + 0.43)
        s_ = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam_r + kk * log_lam - torch.lgamma(kk + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s_ <= t))
        k_out = torch.where(accept, kk, k_out)
        accepted |= accept
    out = torch.where(use_knuth, knuth, k_out.to(dtype))
    return torch.where(lam == 0, torch.zeros_like(out), out)


def categorical(keys, logits) -> torch.Tensor:
    """`jax.random.categorical` over the last axis (the Gumbel-max
    trick): logits [..., V] with one key [..., 2] per row; the noise is
    drawn on the logits' device. Returns int64 [...]."""
    keys = keys.to(logits.device)
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


class Generator:
    """A (key, counter) generator of keys: `next_key()` never returns
    the same key twice."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self._key = None          # key(seed), built when first needed
        self._counter = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def _base_key(self) -> torch.Tensor:
        if self._key is None:
            self._key = key(self._seed)
        return self._key

    def next_key(self) -> torch.Tensor:
        """fold_in(base key, counter) after the counter's increment, on
        the base key's device (the CPU unless set_key gave another)."""
        with self._lock:
            self._counter += 1
            c = self._counter
            base = self._base_key()
        return fold_in(base, c)

    def set_key(self, k: torch.Tensor):
        """Install `k` as the base key and reset the counter to 0."""
        with self._lock:
            self._key = k
            self._counter = 0

    def get_state(self):
        """(seed, counter), the reference's state: a base key that
        set_key installed is not part of it."""
        return (self._seed, self._counter)

    def set_state(self, state):
        seed, counter = state
        self.manual_seed(seed)
        self._counter = int(counter)

    def snapshot(self):
        """(base key, counter): what `restore` puts back, so that a
        replayed forward (recompute) draws the keys the first one drew."""
        with self._lock:
            return self._key, self._counter

    def restore(self, snap):
        with self._lock:
            self._key, self._counter = snap


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """Reseed the default generator (paddle.seed's counterpart for the
    keys that `GPTForCausalLM.generate` samples with)."""
    return _default_generator.manual_seed(s)


def next_key() -> torch.Tensor:
    return _default_generator.next_key()


class rng_key_scope:
    """Rebase the default generator on `k` (counter 0) for the block, and
    put its base key and counter back after it: the train step draws one
    key a step and runs the forward's dropout under it."""

    def __init__(self, k: torch.Tensor):
        self._new_key = k

    def __enter__(self):
        self._saved = _default_generator.snapshot()
        _default_generator.set_key(self._new_key)
        return self

    def __exit__(self, *exc):
        _default_generator.restore(self._saved)
        return False


__all__ = ["threefry2x32", "key", "split", "fold_in",
           "random_bits", "uniform", "bernoulli", "gumbel", "categorical",
           "normal", "randint", "permutation", "poisson",
           "Generator", "default_generator", "seed", "next_key",
           "rng_key_scope"]
