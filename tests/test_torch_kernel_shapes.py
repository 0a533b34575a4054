"""The shape contract of the port's CUDA flash kernels, checked on the CPU.

Each CUDA wrapper in paddle_tpu_torch/ops/flash_attention.py validates its
operands before it launches. Here the device test and the launch are
replaced by stubs, so the wrappers' own validation and output allocation
run on CPU tensors: every wrapper takes L = 192 (a multiple of 64 but not
of 128, which the 128-row forward, dQ and dK/dV kernels run as a last
half tile) and head_dim 64, 128 and 256, and still refuses what it
refused: L not a multiple of 64, another head_dim or dtype, mismatched,
non-contiguous or misaligned operands, and LSE or delta of the wrong
shape or misaligned."""
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# the operands of each wrapper, as chip_smoke.py hands them over
ARGS = {
    "flash_fwd": ("q", "k", "v"),
    "flash_fwd_nn": ("q", "kt", "v"),
    "flash_fwd_f32dot": ("q", "k", "v"),
    "flash_dq": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dq_nn": ("q", "k", "kt", "vt", "do", "lse", "delta"),
    "flash_dq_f32dot": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dkv": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dkv_nn": ("q", "kt", "vt", "do", "lse", "delta"),
    "flash_dkv_nn2": ("q", "qt", "kt", "vt", "do", "dot", "lse", "delta"),
    "flash_dkv_f32dot": ("q", "k", "v", "do", "lse", "delta"),
}


@pytest.fixture
def launches(monkeypatch):
    """Stub out the device test and the launch; record the launches."""
    calls = []
    monkeypatch.setattr(fa, "_check_device", lambda name, q: None)
    monkeypatch.setattr(fa, "_launch",
                        lambda name, ptrs, q, causal, sc: calls.append(name))
    return calls


def _operands(B, L, H, D, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    rows = {n: torch.randn(B, L, H, D, generator=g).to(dtype)
            for n in ("q", "k", "v", "do")}
    t = dict(rows)
    for n in ("q", "k", "v", "do"):
        t[n + "t" if n != "do" else "dot"] = fa.to_t(rows[n])
    t["lse"] = torch.zeros(B, H, L)
    t["delta"] = torch.zeros(B, H, L)
    return t


def _call(name, t, **override):
    args = [override.get(a, t[a]) for a in ARGS[name]]
    return fa.CUDA[name](*args, True, 0.125)


def test_every_cuda_wrapper_is_covered():
    assert set(ARGS) == set(fa.CUDA)


@pytest.mark.parametrize("name", sorted(ARGS))
@pytest.mark.parametrize("L", [64, 192, 1024])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_wrapper_accepts(launches, name, L, D):
    """L a multiple of 64 (192 included) and head_dim 64, 128 or 256: the
    wrapper launches once and returns outputs of the reference's shapes."""
    B, H = 1, 2
    out = _call(name, _operands(B, L, H, D))
    assert launches == [name]
    outs = out if isinstance(out, tuple) else (out,)
    for x in outs:
        assert x.shape in {(B, L, H, D), (B, H, D, L), (B, H, L)}
    if name.startswith("flash_fwd"):
        assert outs[1].shape == (B, H, L) and outs[1].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(ARGS))
def test_wrapper_accepts_f32_storage(launches, name):
    _call(name, _operands(1, 192, 2, 64, torch.float32))
    assert launches == [name]


def _misaligned(x):
    """x's values in a contiguous tensor whose data sits 2 bytes off a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


def _other_length(t):
    """Every operand but q (and LSE, delta) at 128 positions, not 192."""
    out = {n: t[n][:, :128].contiguous() for n in ("k", "v", "do")}
    out.update({n: t[n][..., :128].contiguous()
                for n in ("kt", "vt", "qt", "dot")})
    return out


REFUSALS = {
    "L 96": lambda t: _operands(1, 96, 2, 64),
    "L 160": lambda t: _operands(1, 160, 2, 64),
    "head_dim 32": lambda t: _operands(1, 192, 2, 32),
    "head_dim 192": lambda t: _operands(1, 64, 2, 192),
    "float16": lambda t: {n: (v.half() if v.dtype == torch.bfloat16 else v)
                          for n, v in t.items()},
    "other length": _other_length,
    "non-contiguous": lambda t: {"q": t["q"].transpose(1, 2).contiguous()
                                 .transpose(1, 2)},
    "misaligned": lambda t: {"q": _misaligned(t["q"])},
    "stats shape": lambda t: {"lse": t["lse"][..., :128].contiguous(),
                              "delta": t["delta"][..., :128].contiguous()},
    "misaligned_stats": lambda t: {"lse": _misaligned(t["lse"]),
                                   "delta": _misaligned(t["delta"])},
}
# the cases that alter only LSE and delta
STATS_CASES = ("stats shape", "misaligned_stats")


# every (wrapper, refusal) pair but LSE and delta refusals for the forward
# kernels, which take neither
REFUSAL_CASES = [(name, case) for name in sorted(ARGS)
                 for case in sorted(REFUSALS)
                 if case not in STATS_CASES or "lse" in ARGS[name]]


@pytest.mark.parametrize("name,case", REFUSAL_CASES)
def test_wrapper_refuses(launches, name, case):
    """What the kernels do not take raises ValueError before any launch."""
    t = _operands(1, 192, 2, 64)
    override = REFUSALS[case](t)
    args = {a: override.get(a, t[a]) for a in ARGS[name]}
    assert any(args[a] is not t[a] for a in ARGS[name])
    with pytest.raises(ValueError):
        fa.CUDA[name](*args.values(), True, 0.125)
    assert launches == []


def test_cuda_wrapper_still_needs_a_card():
    """Without the stubs a CPU tensor is refused by the device test."""
    t = _operands(1, 192, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _call("flash_fwd", t)


# ------------------------------------------------ f32-storage split terms --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_terms_predicate_by_direction(D, dtype):
    """On f32 storage every kernel works from split terms at every head_dim
    (its kF32 tensor-core instances): the forward from Q's, K's and V's
    ([3, 3, B, L, H, D]), dQ and dK/dV from those and dO's ([4, 3, ...]);
    bf16 storage never."""
    q = torch.zeros(1, 64, 1, D, dtype=dtype)
    f32 = dtype == torch.float32
    assert fa.works_from_terms(q) == f32
    for name in fa.CUDA:
        terms = fa._terms(name, q, None, True)
        if f32:
            n_ops = 3 if name.startswith("flash_fwd") else 4
            assert terms.shape == (n_ops, 3, 1, 64, 1, D), name
        else:
            assert terms is None, name


@pytest.fixture
def launched_terms(monkeypatch):
    """Stub out the device test and the launch; record each launch's split
    terms (the last pointer) and split flag."""
    calls = []
    monkeypatch.setattr(fa, "_check_device", lambda name, q: None)
    monkeypatch.setattr(
        fa, "_launch", lambda name, ptrs, q, causal, sc, kv_len=None,
        split=True: calls.append((name, ptrs[-1], split)))
    return calls


@pytest.mark.parametrize("name", sorted(ARGS))
@pytest.mark.parametrize("D", [128, 256])
def test_f32_storage_terms_reach_the_launch(launched_terms, name, D):
    """On f32 storage every wrapper hands its launch fresh
    [n, 3, B, L, H, D] bf16 scratch to split into (n = 3 for the forward, 4
    for dQ and dK/dV), at D = 256 as at 128."""
    t = _operands(1, 192, 2, D, torch.float32)
    _call(name, t)
    ((launched, terms, split),) = launched_terms
    assert launched == name and split
    n_ops = 3 if name.startswith("flash_fwd") else 4
    assert terms.shape == (n_ops, 3, 1, 192, 2, D)
    assert terms.dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(ARGS))
def test_split_false_needs_terms_where_the_kernel_reads_them(
        launched_terms, name):
    """split=False without terms raises where the kernel works from terms:
    on f32 storage at D = 256 every forward, dQ and dK/dV; given the terms
    of an earlier split, it launches without splitting."""
    t = _operands(1, 192, 2, 256, torch.float32)
    args = [t[a] for a in ARGS[name]]
    with pytest.raises(ValueError, match="split=False"):
        fa.CUDA[name](*args, True, 0.125, split=False)
    assert launched_terms == []
    terms = fa.split_terms(t["q"], 3 if name.startswith("flash_fwd") else 4)
    fa.CUDA[name](*args, True, 0.125, terms=terms, split=False)
    assert launched_terms == [(name, terms, False)]


@pytest.mark.parametrize("impl", ["bf16", "nn", "nn2", "f32"])
def test_flash_bwd_splits_once_at_d256(monkeypatch, launched_terms, impl):
    """flash_bwd on f32 storage at D = 256, on a card (stubbed): the dQ
    call splits Q, K, V and dO into [4, 3, B, L, H, 256] terms made once,
    and the dK/dV call reads the same terms without splitting."""
    made = []

    def split_terms(q, n_ops=4):
        made.append(torch.empty(n_ops, 3, *q.shape, dtype=torch.bfloat16))
        return made[-1]

    monkeypatch.setattr(fa, "_on_card", lambda x: True)
    monkeypatch.setattr(fa, "split_terms", split_terms)
    t = _operands(1, 128, 2, 256, torch.float32)
    dq, dk, dv = fa.flash_bwd(t["q"], t["k"], t["v"], t["do"], t["lse"],
                              t["delta"], True, 0.0625, impl)
    for g in (dq, dk, dv):
        assert g.shape == (1, 128, 2, 256) and g.dtype == torch.float32
    (terms,) = made
    assert terms.shape == (4, 3, 1, 128, 2, 256)
    dq_name, dkv_name = fa.STRATEGY_KERNELS[impl][1:]
    assert [(n, s) for n, _, s in launched_terms] == [(dq_name, True),
                                                      (dkv_name, False)]
    assert all(x is terms for _, x, _ in launched_terms)
