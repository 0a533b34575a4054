"""Flash attention forward and backward (counterpart of
paddle_tpu/ops/pallas/flash_attention.py), under each dot strategy.

Every Pallas TPU kernel of the reference, the capability probe included,
is a CUDA kernel written for Hopper in csrc/flash_attention.cu. The
reference's dot strategies
(FLAGS_flash_dot_impl) each run three kernels, named in STRATEGY_KERNELS:
  bf16  storage-dtype operands into every dot: flash_fwd, flash_dq,
        flash_dkv (`_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`).
  nn    the same function from K^T and V^T ([B, H, D, L], transposed by
        torch outside the kernels): flash_fwd_nn, flash_dq_nn
        (`_dq_kernel_nn`), flash_dkv_nn.
  nn2   nn whose dK/dV kernel also takes Q^T and dO^T and gives dK^T and
        dV^T, transposed back outside: flash_dkv_nn2 (`_dkv_kernel_nn2`).
  f32   every dot in f32, P and dS never rounded, outputs rounded to the
        storage dtype: flash_fwd_f32dot, flash_dq_f32dot, flash_dkv_f32dot.
  auto  the probe's verdict for the card (`resolve_dot_impl`).
Beside each kernel stands its plain PyTorch version (`*_plain`), which the
CPU tests hold against the reference and which the card run holds the
kernel against. nn and nn2 compute bf16's function, so their plain
versions are bf16's, taking and giving the transposed layouts.

Dispatch: tensors on the CPU take the plain versions; tensors on a CUDA
device launch the kernels (`*_cuda`), which raise on what they do not take.
Nothing falls back from one to the other. On f32 storage every strategy's
kernels are f32-dot kernels (the storage dtype's dots are f32 dots there),
which run on the tensor cores at every head_dim from bf16 terms of their
operands (split_terms, works_from_terms): the forward's call splits Q, K
and V into its own scratch, the dQ kernel's call splits Q, K, V and dO
once per backward into scratch that the dK/dV call reads (nn and nn2 split
their transposed operands into the same terms). At head_dim 256 every
kernel of every strategy on both storages runs on the tensor cores too.
LAUNCHES counts
each wrapper's launches, INSTANCE_LAUNCHES each kernel instance's (the
library names the instance it launched), so a run can show which kernel a
head_dim took.

Padding: the kernels take head_dim 64, 128 or 256 and L a multiple of 64;
the reference's gate admits any head_dim up to 256 and L a multiple of its
blocks. `padded_fwd` and `padded_bwd` (what flash_attention runs, on every
device) zero-pad the head_dim up to the next of 64, 128 and 256 and L up
to a multiple of 64, and cut the outputs back: zero columns add exact
zeros to every score, the forward and dQ kernels mask keys at and past the
true length (`kv_len`), and a padded query row, whose dO is 0, adds
nothing to dK or dV.

Layout: q, k, v, o and their gradients are [B, L, H, D] (the public
layout); their transposes are [B, H, D, L]; LSE and delta are [B, H, L]
float32 (the reference's [BH, 1, L]).

While a profiler records, each flash_attention call is booked as one
`scaled_dot_product_attention` op event with the reference's FLOPs
(profiler/stats), since no dispatch mode sees a ctypes launch; the aten
ops inside the call, forward and backward, are not booked apart.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
import threading

import torch

from ..core.flags import flag
from ..profiler import stats as _pstats

# the three kernels (forward, dQ, dK/dV) that each dot strategy launches
STRATEGY_KERNELS = {
    "bf16": ("flash_fwd", "flash_dq", "flash_dkv"),
    "nn": ("flash_fwd_nn", "flash_dq_nn", "flash_dkv_nn"),
    "nn2": ("flash_fwd_nn", "flash_dq_nn", "flash_dkv_nn2"),
    "f32": ("flash_fwd_f32dot", "flash_dq_f32dot", "flash_dkv_f32dot"),
}
# pointer arguments of each flash kernel's C entry point paddle_<name>: the
# operands and outputs, then the f32-storage split terms
_POINTERS = {"flash_fwd": 6, "flash_fwd_nn": 6, "flash_fwd_f32dot": 6,
             "flash_dq": 8, "flash_dq_nn": 9, "flash_dq_f32dot": 8,
             "flash_dkv": 9, "flash_dkv_nn": 9, "flash_dkv_nn2": 11,
             "flash_dkv_f32dot": 9}
# the entry points that take the true key count (forward, dQ) after the
# common arguments; every entry point then takes the split flag
_MASKED = tuple(n for n in _POINTERS if n.startswith(("flash_fwd",
                                                      "flash_dq")))

# Launches of each CUDA kernel since the last reset; a wrapper adds one
# where it launches its kernel and nowhere else. Threads that share a card
# (the serving engines' replicas) launch one at a time under _LAUNCH_LOCK,
# so that each launch reads its own instance name and no count is lost.
LAUNCHES = {name: 0 for name in (*_POINTERS, "flash_probe")}
_LAUNCH_LOCK = threading.Lock()
# Launches of each kernel instance of the flash entry points since the last
# reset, by instance_name(): e.g. "flash_fwd_mma_kernel<256, kStd, kBf16>"
INSTANCE_LAUNCHES: dict = {}
# the names of the kernels' Form and Mode template arguments, in order
_FORMS = ("kStd", "kNN", "kNN2")
_MODES = ("kBf16", "kSplit", "kF32")

_NEG_INF = -1e30
_KERNEL_TILE = 64          # L is a multiple of it (64-row tiles, half tiles)
_KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PROBE_N = 128             # the probe's tiles are 128 x 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    INSTANCE_LAUNCHES.clear()


def instance_name(pretty: str) -> str:
    """The kernel instance in the library's name of its last launch (the
    host compiler's spelling of the launching function, e.g. "... [with
    auto Kernel = flash_fwd_mma_kernel<256, 0>]"), as "kernel<args>" with
    the mma kernels' Form and Mode named and their default Mode filled
    in, or the kernel's name where it is no template; the whole string
    where no kernel is named in it."""
    found = re.search(r"(flash_\w+_kernel)(?:\s*<([^<>]*)>)?", pretty)
    if found is None:
        return pretty
    if found[2] is None:
        return found[1]
    kernel, args = found[1], [a.strip() for a in found[2].split(",")]
    if kernel.endswith("_mma_kernel") and all(a.isdigit() for a in args):
        args += ["0"] * (3 - len(args))
        args = [args[0], _FORMS[int(args[1])], _MODES[int(args[2])]]
    return f"{kernel}<{', '.join(args)}>"


def flash_attention_supported(q_shape, d_model_last: int, causal: bool,
                              block_q: int = 128, block_k: int = 128) -> bool:
    """Shape gate, the reference's: seq divisible by both blocks, head_dim
    at most 256. flash_attention pads head_dims and lengths to what the
    CUDA kernels take (kernel_shape)."""
    L = q_shape[1]
    return (L % block_q == 0 and L % block_k == 0 and L >= block_q
            and d_model_last <= 256)


def to_t(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> contiguous [B, H, D, L]: K^T, V^T, Q^T, dO^T."""
    return x.permute(0, 2, 3, 1).contiguous()


def from_t(xt: torch.Tensor) -> torch.Tensor:
    """[B, H, D, L] -> contiguous [B, L, H, D]."""
    return xt.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------- plain versions --
def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, H, L, D] in float32 (float64 stays float64: the
    plain versions then compute the same function in f64)."""
    return x.transpose(1, 2).to(torch.promote_types(x.dtype, torch.float32))


def _causal_keep(L: int, device) -> torch.Tensor:
    return torch.ones(L, L, dtype=torch.bool, device=device).tril()


def _scores(qh, kh, causal: bool, sm_scale: float,
            kv_len=None) -> torch.Tensor:
    """Scaled scores, -1e30 past the causal diagonal and at keys at and
    past kv_len (the true length of zero-padded inputs)."""
    s = (qh @ kh.transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-1], s.device), _NEG_INF)
    if kv_len is not None and kv_len < s.shape[-1]:
        s[..., kv_len:] = _NEG_INF
    return s


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float,
                    f32_dots: bool = False, kv_len=None):
    """(O [B, L, H, D] in q's dtype, LSE [B, H, L] f32): the function of
    `_fwd_kernel`, computed whole in f32, with P rounded to V's dtype before
    P.V as the kernels round it; with `f32_dots` (strategy f32), P enters
    P.V unrounded. Keys at and past `kv_len` are masked."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    s = _scores(qh, kh, causal, sm_scale, kv_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = ((p if f32_dots else p.to(v.dtype).to(p.dtype)) @ vh) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                    f32_dots: bool = False, kv_len=None):
    """(dQ, dK, dV) in the inputs' dtype: the functions of `_dq_kernel` and
    `_dkv_kernel`. P = exp(S - LSE), dS = P * (dO.V^T - delta) * scale;
    P and dS are rounded to the input dtype where they enter a dot, except
    with `f32_dots` (strategy f32), where they stay f32. Keys at and past
    `kv_len` are masked (as the dQ kernel masks them; the dK/dV kernel
    leaves them, whose rows the caller cuts off)."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    s = _scores(qh, kh, causal, sm_scale, kv_len)
    p = torch.exp(s - lse[..., None])
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sm_scale
    if not f32_dots:
        p, ds = p.to(q.dtype).to(p.dtype), ds.to(q.dtype).to(ds.dtype)
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dv = p.transpose(-1, -2) @ doh
    return tuple(x.transpose(1, 2).to(q.dtype).contiguous()
                 for x in (dq, dk, dv))


def flash_dq_plain(q, k, v, do, lse, delta, causal, sm_scale,
                   f32_dots=False, kv_len=None):
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale,
                           f32_dots, kv_len)[0]


def flash_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale,
                    f32_dots=False):
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale,
                           f32_dots)[1:]


def flash_fwd_nn_plain(q, kt, v, causal, sm_scale, kv_len=None):
    return flash_fwd_plain(q, from_t(kt), v, causal, sm_scale,
                           kv_len=kv_len)


def flash_dq_nn_plain(q, k, kt, vt, do, lse, delta, causal, sm_scale,
                      kv_len=None):
    return flash_dq_plain(q, k, from_t(vt), do, lse, delta, causal, sm_scale,
                          kv_len=kv_len)


def flash_dkv_nn_plain(q, kt, vt, do, lse, delta, causal, sm_scale):
    return flash_dkv_plain(q, from_t(kt), from_t(vt), do, lse, delta, causal,
                           sm_scale)


def flash_dkv_nn2_plain(q, qt, kt, vt, do, dot, lse, delta, causal,
                        sm_scale):
    """(dK^T, dV^T) [B, H, D, L]."""
    dk, dv = flash_dkv_plain(from_t(qt), from_t(kt), from_t(vt), from_t(dot),
                             lse, delta, causal, sm_scale)
    return to_t(dk), to_t(dv)


def flash_probe_plain(a, a32, b):
    """The probe's four 128 x 128 products in f32, [4, 128, 128]: NT
    (A.B^T), TN (A^T.B), NN (A.B), and A32 transposed and cast to bf16,
    then NN with B."""
    af, bf = a.float(), b.float()
    at32 = a32.t().to(torch.bfloat16).float()
    return torch.stack([af @ bf.t(), af.t() @ bf, af @ bf, at32 @ bf])


# ------------------------------------------------------------ CUDA kernels --
@functools.cache
def _lib():
    """The library built from csrc/flash_attention.cu (at first use), with
    its C signatures."""
    from ._build import load

    lib = load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for kernel_name, n in _POINTERS.items():
        fn = getattr(lib, "paddle_" + kernel_name)
        # B, H, L, D, dtype, causal, scale[, kv_len], split, stream
        fn.argtypes = ([P] * n + [I] * 6 + [F]
                       + [I] * (1 + (kernel_name in _MASKED)) + [P])
        fn.restype = I
    lib.paddle_flash_probe.argtypes = [P] * 5
    lib.paddle_flash_probe.restype = I
    lib.paddle_cuda_error_string.argtypes = [I]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    lib.paddle_flash_last_instance.argtypes = []
    lib.paddle_flash_last_instance.restype = ctypes.c_char_p
    return lib


def _check_device(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")


def _check(name: str, q: torch.Tensor, rows=(), cols=(), stats=(),
           kv_len=None):
    """Validate what a kernel takes: CUDA, one dtype (bf16 or f32), q and
    `rows` contiguous [B, L, H, D] of one shape, `cols`
    contiguous [B, H, D, L] of the same sizes; head_dim 64, 128 or 256, L
    a multiple of 64 (the 128-row kernels run a last half tile of 64 rows);
    `stats` (LSE, delta) contiguous f32 [B, H, L]; `kv_len`, the true key
    count of zero-padded inputs, in 1 .. L. Every operand 16-byte
    aligned: the kernels read them with 16-byte loads or bulk copies (LSE
    and delta in 256-byte runs)."""
    _check_device(name, q)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(bfloat16 or float32)")
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, L, H, D], got "
                         f"{tuple(q.shape)}")
    B, L, H, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not supported by the CUDA "
                         f"kernel (64, 128 or 256)")
    if L % _KERNEL_TILE:
        raise ValueError(f"{name}: sequence length {L} is not a multiple "
                         f"of {_KERNEL_TILE}")
    if kv_len is not None and not 0 < kv_len <= L:
        raise ValueError(f"{name}: kv_len {kv_len} outside 1 .. {L}")
    for group, shape in (((q, *rows), (B, L, H, D)), (cols, (B, H, D, L))):
        for t in group:
            if (t.shape != shape or t.dtype != q.dtype
                    or t.device != q.device or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"{name}: every input must be a contiguous,"
                                 f" 16-byte aligned {q.dtype} tensor of shape"
                                 f" {shape} on {q.device}")
    for t in stats:
        if (t.shape != (B, H, L) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: LSE and delta must be contiguous, "
                             f"16-byte aligned float32 [B, H, L] on "
                             f"{q.device}")
    return B, L, H, D


def works_from_terms(q: torch.Tensor) -> bool:
    """Whether the flash kernels work from split terms for q's storage: on
    f32 storage, where every kernel is a kF32 tensor-core instance."""
    return q.dtype == torch.float32


def split_terms(q: torch.Tensor, n_ops: int = 4) -> torch.Tensor:
    """Scratch for the f32-storage kernels: their operands as hi, mid and lo
    bf16 terms, [n_ops, 3, B, L, H, D]: the forward's Q, K and V (n_ops 3),
    or Q, K, V and dO of a backward (written by the dQ kernel's call where
    it splits, read by both)."""
    return torch.empty(n_ops, 3, *q.shape, dtype=torch.bfloat16,
                       device=q.device)


def _terms(name: str, q: torch.Tensor, terms, split: bool):
    """The split terms a kernel on f32 storage works from (None on bf16
    storage, where the kernel reads its operands as they are): `terms` as
    given, to be written by this call where `split` is set, else fresh
    scratch, which this call must split into."""
    if not works_from_terms(q):
        return None
    n_ops = 3 if name.startswith("flash_fwd") else 4
    if terms is None:
        if not split:
            raise ValueError(f"{name}: split=False needs the terms of an "
                             f"earlier split")
        return split_terms(q, n_ops)
    if (terms.shape != (n_ops, 3, *q.shape) or terms.dtype != torch.bfloat16
            or terms.device != q.device or not terms.is_contiguous()
            or terms.data_ptr() % 16):
        raise ValueError(f"{name}: the split terms must be a contiguous, "
                         f"16-byte aligned bfloat16 tensor of shape "
                         f"{(n_ops, 3, *q.shape)} on {q.device}")
    return terms


def _launch(name: str, ptrs, q, causal, sm_scale, kv_len=None, split=True):
    """Launch paddle_<name> on q's card and stream. `kv_len` (forward, dQ;
    None: L) masks keys at and past it; `split` (f32 storage) splits the
    operands into the terms first. A pointer of None is NULL."""
    lib = _lib()
    B, L, H, D = q.shape
    ints = [B, H, L, D, _DTYPE_CODES[q.dtype], int(bool(causal)),
            float(sm_scale)]
    if name in _MASKED:
        ints.append(L if kv_len is None else int(kv_len))
    ints.append(int(bool(split)))
    with torch.cuda.device(q.device), _LAUNCH_LOCK:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, "paddle_" + name)(
            *[None if t is None else t.data_ptr() for t in ptrs], *ints,
            stream)
        if err != 0:
            msg = lib.paddle_cuda_error_string(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: {msg} "
                               f"({err})")
        LAUNCHES[name] += 1
        inst = instance_name(lib.paddle_flash_last_instance().decode())
        INSTANCE_LAUNCHES[inst] = INSTANCE_LAUNCHES.get(inst, 0) + 1


def _options(q, kv_len=None, split=True):
    """The keyword arguments of _launch that differ from its defaults (a
    kv_len of L masks nothing)."""
    opts = {}
    if kv_len is not None and kv_len != q.shape[1]:
        opts["kv_len"] = int(kv_len)
    if not split:
        opts["split"] = False
    return opts


def _stats(q):
    B, L, H, _ = q.shape
    return torch.empty(B, H, L, dtype=torch.float32, device=q.device)


def _fwd_cuda(name, q, k, v, causal, sm_scale, kt_layout=False,
              kv_len=None, terms=None, split=True):
    _check(name, q, rows=(v,) if kt_layout else (k, v),
           cols=(k,) if kt_layout else (), kv_len=kv_len)
    terms = _terms(name, q, terms, split)
    o, lse = torch.empty_like(q), _stats(q)
    _launch(name, (q, k, v, o, lse, terms), q, causal, sm_scale,
            **_options(q, kv_len, split))
    return o, lse


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, kv_len=None,
                   terms=None, split=True):
    """Launch the forward kernel: (O, LSE). Keys at and past `kv_len` are
    masked. On f32 storage (its storage-dtype dots are f32 dots) it works
    from `terms` (split_terms(q, 3)), which it first splits Q, K and V into
    unless `split` is False; fresh scratch where `terms` is None."""
    return _fwd_cuda("flash_fwd", q, k, v, causal, sm_scale, kv_len=kv_len,
                     terms=terms, split=split)


def flash_fwd_nn_cuda(q, kt, v, causal: bool, sm_scale: float, kv_len=None,
                      terms=None, split=True):
    """Launch the forward kernel that reads K^T [B, H, D, L]: (O, LSE)."""
    return _fwd_cuda("flash_fwd_nn", q, kt, v, causal, sm_scale,
                     kt_layout=True, kv_len=kv_len, terms=terms, split=split)


def flash_fwd_f32dot_cuda(q, k, v, causal: bool, sm_scale: float,
                          kv_len=None, terms=None, split=True):
    """Launch the f32-dot forward kernel: (O, LSE)."""
    return _fwd_cuda("flash_fwd_f32dot", q, k, v, causal, sm_scale,
                     kv_len=kv_len, terms=terms, split=split)


def _dq_cuda(name, q, k, v, do, lse, delta, causal, sm_scale, kv_len, terms,
             split):
    _check(name, q, rows=(k, v, do), stats=(lse, delta), kv_len=kv_len)
    terms = _terms(name, q, terms, split)
    dq = torch.empty_like(q)
    _launch(name, (q, k, v, do, lse, delta, dq, terms), q, causal, sm_scale,
            **_options(q, kv_len, split))
    return dq


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                  kv_len=None, terms=None, split=True):
    """Launch the dQ kernel. On f32 storage it works from `terms`
    (split_terms), which it first splits Q, K, V and dO into unless `split`
    is False (the terms of an earlier call); fresh scratch where `terms` is
    None."""
    return _dq_cuda("flash_dq", q, k, v, do, lse, delta, causal, sm_scale,
                    kv_len, terms, split)


def flash_dq_f32dot_cuda(q, k, v, do, lse, delta, causal: bool,
                         sm_scale: float, kv_len=None, terms=None,
                         split=True):
    """Launch the f32-dot dQ kernel (f32 storage: as flash_dq_cuda)."""
    return _dq_cuda("flash_dq_f32dot", q, k, v, do, lse, delta, causal,
                    sm_scale, kv_len, terms, split)


def flash_dq_nn_cuda(q, k, kt, vt, do, lse, delta, causal: bool,
                     sm_scale: float, kv_len=None, terms=None, split=True):
    """Launch `_dq_kernel_nn`'s counterpart: dQ from K, K^T and V^T (f32
    storage: the terms of Q, K^T, V^T and dO, as flash_dq_cuda)."""
    _check("flash_dq_nn", q, rows=(k, do), cols=(kt, vt), stats=(lse, delta),
           kv_len=kv_len)
    terms = _terms("flash_dq_nn", q, terms, split)
    dq = torch.empty_like(q)
    _launch("flash_dq_nn", (q, k, kt, vt, do, lse, delta, dq, terms), q,
            causal, sm_scale, **_options(q, kv_len, split))
    return dq


def _dkv_cuda(name, q, k, v, do, lse, delta, causal, sm_scale, terms, split,
              kv_layout=False):
    _check(name, q, rows=(do,) if kv_layout else (k, v, do),
           cols=(k, v) if kv_layout else (), stats=(lse, delta))
    terms = _terms(name, q, terms, split)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch(name, (q, k, v, do, lse, delta, dk, dv, terms), q, causal,
            sm_scale, **_options(q, split=split))
    return dk, dv


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                   terms=None, split=True):
    """Launch the dK/dV kernel: (dK, dV). On f32 storage it works from
    `terms` as flash_dq_cuda does (split=False: the terms the dQ call of the
    same backward split)."""
    return _dkv_cuda("flash_dkv", q, k, v, do, lse, delta, causal, sm_scale,
                     terms, split)


def flash_dkv_nn_cuda(q, kt, vt, do, lse, delta, causal: bool,
                      sm_scale: float, terms=None, split=True):
    """Launch the dK/dV kernel that reads K^T and V^T: (dK, dV)."""
    return _dkv_cuda("flash_dkv_nn", q, kt, vt, do, lse, delta, causal,
                     sm_scale, terms, split, kv_layout=True)


def flash_dkv_f32dot_cuda(q, k, v, do, lse, delta, causal: bool,
                          sm_scale: float, terms=None, split=True):
    """Launch the f32-dot dK/dV kernel: (dK, dV)."""
    return _dkv_cuda("flash_dkv_f32dot", q, k, v, do, lse, delta, causal,
                     sm_scale, terms, split)


def flash_dkv_nn2_cuda(q, qt, kt, vt, do, dot, lse, delta, causal: bool,
                       sm_scale: float, terms=None, split=True):
    """Launch `_dkv_kernel_nn2`'s counterpart: (dK^T, dV^T) [B, H, D, L]
    from Q, Q^T, K^T, V^T, dO and dO^T (f32 storage: the terms of Q^T, K^T,
    V^T and dO^T)."""
    _check("flash_dkv_nn2", q, rows=(do,), cols=(qt, kt, vt, dot),
           stats=(lse, delta))
    terms = _terms("flash_dkv_nn2", q, terms, split)
    dkt, dvt = torch.empty_like(kt), torch.empty_like(vt)
    _launch("flash_dkv_nn2",
            (q, qt, kt, vt, do, dot, lse, delta, dkt, dvt, terms), q, causal,
            sm_scale, **_options(q, split=split))
    return dkt, dvt


def flash_probe_cuda(a, a32, b):
    """Launch the probe: its four products, [4, 128, 128] f32 (see
    flash_probe_plain). a, b: [128, 128] bf16; a32: [128, 128] f32."""
    n = _PROBE_N
    if a.device.type != "cuda":
        raise ValueError(f"flash_probe: the CUDA kernel needs CUDA tensors, "
                         f"got {a.device}")
    for t, dt in ((a, torch.bfloat16), (a32, torch.float32),
                  (b, torch.bfloat16)):
        if (t.shape != (n, n) or t.dtype != dt or t.device != a.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_probe: expected contiguous [{n}, {n}] "
                             f"tiles (a, b bfloat16, a32 float32) on "
                             f"{a.device}")
    out = torch.empty(4, n, n, dtype=torch.float32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device), _LAUNCH_LOCK:
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.paddle_flash_probe(a.data_ptr(), a32.data_ptr(),
                                     b.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            msg = lib.paddle_cuda_error_string(err).decode()
            raise RuntimeError(f"flash_probe kernel launch failed: {msg} "
                               f"({err})")
        LAUNCHES["flash_probe"] += 1
    return out


# the plain version and the CUDA wrapper of each flash kernel
PLAIN = {
    "flash_fwd": flash_fwd_plain,
    "flash_fwd_nn": flash_fwd_nn_plain,
    "flash_fwd_f32dot": functools.partial(flash_fwd_plain, f32_dots=True),
    "flash_dq": flash_dq_plain,
    "flash_dq_nn": flash_dq_nn_plain,
    "flash_dq_f32dot": functools.partial(flash_dq_plain, f32_dots=True),
    "flash_dkv": flash_dkv_plain,
    "flash_dkv_nn": flash_dkv_nn_plain,
    "flash_dkv_nn2": flash_dkv_nn2_plain,
    "flash_dkv_f32dot": functools.partial(flash_dkv_plain, f32_dots=True),
}
CUDA = {
    "flash_fwd": flash_fwd_cuda, "flash_fwd_nn": flash_fwd_nn_cuda,
    "flash_fwd_f32dot": flash_fwd_f32dot_cuda, "flash_dq": flash_dq_cuda,
    "flash_dq_nn": flash_dq_nn_cuda, "flash_dq_f32dot": flash_dq_f32dot_cuda,
    "flash_dkv": flash_dkv_cuda, "flash_dkv_nn": flash_dkv_nn_cuda,
    "flash_dkv_nn2": flash_dkv_nn2_cuda,
    "flash_dkv_f32dot": flash_dkv_f32dot_cuda,
}


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def kernel(name: str, on: torch.Tensor):
    """Flash kernel `name` for tensors on `on`'s device: its plain version
    on the CPU, its CUDA kernel otherwise."""
    return (CUDA if _on_card(on) else PLAIN)[name]


# ------------------------------------------------------- dot strategies --
# The forward as a custom op, so that torch.export records it in a program
# (inference.save_inference_model). It has a CPU and a CUDA kernel, which
# take `kernel`'s pick (the plain version on the CPU, the CUDA kernel on a
# card); no other device has one. `impl` is a concrete strategy, resolved
# before any trace (the probe cannot run on a trace's fake tensors);
# `kv_len` is the true key count.
@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, sm_scale: float, impl: str,
                 kv_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    fwd = kernel(STRATEGY_KERNELS[impl][0], q)
    if impl in ("nn", "nn2"):
        k = to_t(k)
    return fwd(q, k, v, causal, sm_scale, kv_len=kv_len)


@flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v, causal, sm_scale, impl, kv_len):
    B, L, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, L), dtype=torch.float32)


def flash_fwd(q, k, v, causal: bool, sm_scale: float, impl: str = "bf16",
              kv_len=None):
    """(O, LSE) under dot strategy `impl` (the reference's `_fwd`), through
    flash_fwd_op; nn and nn2 hand the kernel K^T, transposed as XLA does
    at :139. Keys at and past `kv_len` (None: L) are masked."""
    return flash_fwd_op(q, k, v, bool(causal), float(sm_scale), impl,
                        q.shape[1] if kv_len is None else int(kv_len))


def flash_bwd(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
              impl: str = "bf16", kv_len=None):
    """(dQ, dK, dV) under dot strategy `impl` (the reference's `_bwd`, whose
    transposes for nn and nn2, :337-404, are done here). dQ masks keys at
    and past `kv_len`. On a card and f32 storage, where dQ and dK/dV work
    from terms, the dQ kernel's call splits Q, K, V and dO into terms that
    the dK/dV kernel's call reads."""
    _, dq_name, dkv_name = STRATEGY_KERNELS[impl]
    dq_fn, dkv_fn = kernel(dq_name, q), kernel(dkv_name, q)
    rest = (lse, delta, causal, sm_scale)
    split = {}
    if _on_card(q) and works_from_terms(q):
        split = {"terms": split_terms(q)}
    reuse = dict(split, split=False) if split else {}
    if impl not in ("nn", "nn2"):
        return (dq_fn(q, k, v, do, *rest, kv_len=kv_len, **split),
                *dkv_fn(q, k, v, do, *rest, **reuse))
    kt, vt = to_t(k), to_t(v)
    dq = dq_fn(q, k, kt, vt, do, *rest, kv_len=kv_len, **split)
    if impl == "nn":
        return (dq, *dkv_fn(q, kt, vt, do, *rest, **reuse))
    dkt, dvt = dkv_fn(q, to_t(q), kt, vt, do, to_t(do), *rest, **reuse)
    return dq, from_t(dkt), from_t(dvt)


# --------------------------------------------------------------- padding --
def kernel_shape(L: int, D: int):
    """(L, head_dim) as the kernels take them: L up to a multiple of 64, a
    head_dim up to the next of 64, 128 and 256 (above 256 as it is: the
    kernels refuse it, and the gate admits none)."""
    Lp = -(-L // _KERNEL_TILE) * _KERNEL_TILE
    Dp = next((d for d in _KERNEL_HEAD_DIMS if D <= d), D)
    return Lp, Dp


def _pad(x, L: int, D: int):
    """[B, l, H, d] zero-padded to [B, L, H, D] (x itself if it is)."""
    if (x.shape[1], x.shape[3]) == (L, D):
        return x
    return torch.nn.functional.pad(
        x, (0, D - x.shape[3], 0, 0, 0, L - x.shape[1]))


def _cut(x, L: int, D: int):
    """The first L positions and D columns of [B, Lp, H, Dp], contiguous."""
    if (x.shape[1], x.shape[3]) == (L, D):
        return x
    return x[:, :L, :, :D].contiguous()


def padded_fwd(q, k, v, causal: bool, sm_scale: float, impl: str = "bf16"):
    """(O, LSE, saved): flash_fwd on q, k, v zero-padded to kernel_shape,
    the keys past the true length masked; O [B, L, H, D] and LSE [B, H, L]
    cut back to the true shape; `saved` (the padded q, k, v, O and LSE) is
    what padded_bwd takes. `sm_scale` is the caller's, from the true
    head_dim."""
    B, L, H, D = q.shape
    Lp, Dp = kernel_shape(L, D)
    qp, kp, vp = (_pad(x, Lp, Dp) for x in (q, k, v))
    o, lse = flash_fwd(qp, kp, vp, causal, sm_scale, impl, kv_len=L)
    lse_cut = lse if Lp == L else lse[..., :L].contiguous()
    return _cut(o, L, D), lse_cut, (qp, kp, vp, o, lse)


def padded_bwd(saved, do, causal: bool, sm_scale: float,
               impl: str = "bf16"):
    """(dQ, dK, dV) [B, L, H, D] of padded_fwd's call from its `saved` and
    dO [B, L, H, D]. delta = rowsum(dO * O) is formed at the true shape in
    f32, as the reference's `_bwd` forms it, and padded with zeros; the
    padded rows of dO are zeros, so their dS is 0 and they add nothing to
    dK or dV. The rows and columns past the true shape are cut off."""
    qp, kp, vp, o, lse = saved
    do = do.contiguous()
    L, D = do.shape[1], do.shape[3]
    Lp, Dp = o.shape[1], o.shape[3]
    delta = (do.float() * _cut(o, L, D).float()).sum(-1)
    delta = torch.nn.functional.pad(delta, (0, 0, 0, Lp - L))
    delta = delta.transpose(1, 2).contiguous()
    grads = flash_bwd(qp, kp, vp, _pad(do, Lp, Dp), lse, delta, causal,
                      sm_scale, impl, kv_len=L)
    return tuple(_cut(g, L, D) for g in grads)


# ------------------------------------------------- strategy resolution --
_IMPL_MEMO: dict = {}     # card index -> strategy picked by "auto"


def probe_inputs(device):
    """The probe's tiles: small integers, so every product is exact in f32
    whatever the order of its sums. (a bf16, a32 = a in f32, b bf16.)"""
    g = torch.Generator(device=device).manual_seed(0)
    n = _PROBE_N
    a, b = (torch.randint(-4, 5, (n, n), generator=g, device=device)
            .to(torch.bfloat16) for _ in range(2))
    return a, a.float(), b


def probe_caps(device) -> dict:
    """Run the probe kernel on CUDA card `device` and hold each form's
    product against the exact one: {"nt_bf16": NT and TN right, "nn_bf16":
    NN right, "transpose_f32": the f32-transposed form right}. Raises below
    compute capability 9.0, where the sm_90a kernels cannot run, and when
    the probe does not build or launch."""
    device = torch.device(device)
    cap = torch.cuda.get_device_capability(device)
    if cap < (9, 0):
        raise RuntimeError(
            f"flash attention: {torch.cuda.get_device_name(device)} has "
            f"compute capability {cap[0]}.{cap[1]}; the CUDA kernels are "
            f"built for sm_90a and need 9.0")
    a, a32, b = probe_inputs(device)
    got = flash_probe_cuda(a, a32, b)
    right = [bool(torch.equal(x, y))
             for x, y in zip(got, flash_probe_plain(a, a32, b))]
    return {"nt_bf16": right[0] and right[1], "nn_bf16": right[2],
            "transpose_f32": right[3]}


def strategy_from_caps(caps: dict) -> str:
    """bf16 > nn > nn2 > f32, as `_resolve_dot_impl` (:518-525) picks."""
    if caps.get("nt_bf16"):
        return "bf16"
    if caps.get("nn_bf16") and caps.get("transpose_f32"):
        return "nn"
    if caps.get("nn_bf16"):
        return "nn2"
    return "f32"


def resolve_dot_impl(device) -> str:
    """FLAGS_flash_dot_impl as a concrete strategy for tensors on `device`
    (counterpart of `_resolve_dot_impl`). An explicit value is returned as
    it is. "auto" on a CUDA card runs the probe once per process and card
    and keeps the verdict in memory; on the CPU, where the plain versions
    run, it means "bf16", as the reference's does off the TPU."""
    impl = flag("flash_dot_impl")
    if impl != "auto":
        if impl not in STRATEGY_KERNELS:
            raise ValueError(
                f"FLAGS_flash_dot_impl must be auto|bf16|nn|nn2|f32, "
                f"got {impl!r}")
        return impl
    device = torch.device(device)
    if device.type != "cuda":
        return "bf16"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _IMPL_MEMO:
        _IMPL_MEMO[index] = strategy_from_caps(
            probe_caps(torch.device("cuda", index)))
    return _IMPL_MEMO[index]


# ---------------------------------------------------------------- autograd --
class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the reference's `_flash` custom_vjp: saves
    (q, k, v, o, lse), padded to the kernels' shape where the inputs are
    not (padded_fwd); the backward forms delta = rowsum(dO * O) in f32
    outside the kernels, as `_bwd` does. `impl` is a concrete strategy."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, impl):
        o, _, saved = padded_fwd(q, k, v, causal, sm_scale, impl)
        ctx.save_for_backward(*saved)
        ctx.causal, ctx.sm_scale, ctx.impl = causal, sm_scale, impl
        return o

    @staticmethod
    def backward(ctx, do):
        if _pstats.active() is None:
            dq, dk, dv = padded_bwd(ctx.saved_tensors, do, ctx.causal,
                                    ctx.sm_scale, ctx.impl)
        else:
            with _pstats.opaque():
                dq, dk, dv = padded_bwd(ctx.saved_tensors, do, ctx.causal,
                                        ctx.sm_scale, ctx.impl)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q: int = 128, block_k: int = 128,
                    impl: str | None = None):
    """q, k, v: [B, L, H, D] -> [B, L, H, D]; differentiable.

    Self attention with equal q/k lengths; bf16 or f32 inputs, f32
    accumulation. `impl` (bf16, nn, nn2 or f32) overrides the dot strategy
    that FLAGS_flash_dot_impl resolves to (`resolve_dot_impl`).
    `block_q`/`block_k` are the reference's tiles, checked by the shape
    gate; the CUDA kernels pick their own inner tiles."""
    D = q.shape[-1]
    if not flash_attention_supported(q.shape, D, causal, block_q, block_k):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} fails the "
                         f"gate for blocks ({block_q}, {block_k})")
    if impl is None:
        impl = resolve_dot_impl(q.device)
    elif impl not in STRATEGY_KERNELS:
        raise ValueError(f"flash_attention: impl must be bf16|nn|nn2|f32, "
                         f"got {impl!r}")
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    args = (q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
            sm_scale, impl)
    if _pstats.active() is None:
        return FlashAttentionFunction.apply(*args)
    # a recording profiler sees no ctypes launch: book the call as one
    # attention op with the reference's FLOPs
    with _pstats.attention_event(q, k, bool(causal)):
        return FlashAttentionFunction.apply(*args)
