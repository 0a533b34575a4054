"""The port's flash dot strategies (FLAGS_flash_dot_impl: bf16, nn, nn2,
f32 and auto; paddle_tpu_torch/ops/flash_attention.py) against the
reference's Pallas kernels run in interpret mode on the CPU, and the
strategy resolution against the reference's `_resolve_dot_impl`.

On the CPU each strategy's kernel wrappers take their plain versions, with
the same torch transposes around them (K^T, V^T, Q^T, dO^T in, dK^T and
dV^T out) that surround the CUDA kernels on the card; chip_smoke.py holds
the kernels against the same plain versions there."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.flags import set_flags as jax_set_flags

from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(1)

# B = 1, H = 2, L = 128, D = 32 with 64-row blocks: two tiles per head, so
# the causal diagonal tile and a fully visible tile are both exercised
B, L, H, D = 1, 128, 2, 32
BLOCK = 64
SC = 1.0 / math.sqrt(D)
IMPLS = ("bf16", "nn", "nn2", "f32")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


def _bh(x, dtype):
    """[B, L, H, D] numpy -> the reference kernels' [BH, L, D]."""
    return jnp.swapaxes(jnp.asarray(x, dtype), 1, 2).reshape(B * H, L, D)


def _from_bh(x):
    x = np.asarray(x.astype(jnp.float32))
    return np.swapaxes(x.reshape(B, H, L, D), 1, 2)


def _port(impl, dtype, causal, seed=0):
    """O, LSE, dQ, dK, dV (f32 numpy) through the port's strategy `impl`
    on CPU tensors of `dtype`."""
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _inputs(seed))
    o, lse = fa.flash_fwd(q, k, v, causal, SC, impl)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_bwd(q, k, v, g, lse, delta, causal, SC, impl)
    return [t.float().numpy() for t in (o, lse, *grads)]


def _bf16_step(x):
    """One bf16 step (2^-7 of the leading power of two) at x's largest
    magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


# Share of bf16 outputs that may differ from the reference's bit for bit.
# f32: the two round only their outputs, so only a different order of f32
# sums can flip a rounding (measured at most 0.2%). bf16, nn and nn2 round
# P to bf16 before P.V and P, dS before the gradient dots: the reference
# against the running max of its 64-key blocks, the plain version against
# the row's final max (measured at most 19%). The other rounding scheme
# differs in 35-44% of the entries (test_f32_and_bf16_differ below).
MISMATCH_SHARE = {"f32": 0.01, "bf16": 0.25, "nn": 0.25, "nn2": 0.25}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strategy_matches_pallas_interpret(dtype, causal, impl):
    """O, LSE (the forward residuals of `_flash_fwd`) and dQ, dK, dV (of
    `_flash_bwd`) of strategy `impl`, reference in interpret mode. f32
    inputs: the tolerances of tests/test_pallas.py, atol 2e-5 on O and
    2e-4 of the largest magnitude on the grads. bf16 inputs: every output
    within one bf16 step of its largest magnitude, and no larger a share of
    entries apart than MISMATCH_SHARE. LSE is f32 in both: atol 2e-5."""
    jdt = getattr(jnp, dtype)
    q, k, v, g = _inputs()
    out, res = jfa._flash_fwd(_bh(q, jdt), _bh(k, jdt), _bh(v, jdt), SC,
                              causal, BLOCK, BLOCK, True, impl)
    grads = jfa._flash_bwd(SC, causal, BLOCK, BLOCK, True, impl, res,
                           _bh(g, jdt))
    ref = [_from_bh(out), np.asarray(res[4]).reshape(B, H, L),
           *(_from_bh(x) for x in grads)]
    mine = _port(impl, getattr(torch, dtype), causal)

    np.testing.assert_allclose(mine[1], ref[1], atol=2e-5)
    for name, got, want in zip(("O", "dQ", "dK", "dV"), mine[:1] + mine[2:],
                               ref[:1] + ref[2:]):
        diff = np.abs(got - want)
        if dtype == "float32":
            limit = 2e-5 if name == "O" else 2e-4 * np.abs(want).max()
            assert diff.max() <= limit, (name, diff.max())
        else:
            assert diff.max() <= _bf16_step(want), (name, diff.max())
            share = (diff > 0).mean()
            assert share <= MISMATCH_SHARE[impl], (name, share)


@pytest.mark.parametrize("causal", [False, True])
def test_f32_and_bf16_differ_on_bf16_inputs(causal):
    """On bf16 inputs the f32 strategy computes another function than
    bf16 (P and dS unrounded): the two part in more entries of O and of
    each gradient than the mismatch limits above let through, so the
    interpret-mode comparison tells the strategies apart."""
    f32 = _port("f32", torch.bfloat16, causal)
    bf16 = _port("bf16", torch.bfloat16, causal)
    for name, a, b in zip(("O", "dQ", "dK", "dV"), f32[:1] + f32[2:],
                          bf16[:1] + bf16[2:]):
        assert (a != b).mean() > MISMATCH_SHARE["bf16"], name


def test_nn_forms_give_bf16s_function():
    """nn and nn2 only move operands between layouts: through the plain
    versions they give bitwise bf16's outputs."""
    want = _port("bf16", torch.bfloat16, True)
    for impl in ("nn", "nn2"):
        for got, w in zip(_port(impl, torch.bfloat16, True), want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("impl", IMPLS)
def test_flash_attention_impl_autograd(impl):
    """flash_attention(impl=...) on CPU tensors: the strategy's forward,
    and grads exactly its backward with delta = rowsum(dO * O) in f32."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(1))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qr, kr, vr, causal=True, block_q=BLOCK,
                             block_k=BLOCK, impl=impl)
    out.backward(g)
    o, lse = fa.flash_fwd(q, k, v, True, SC, impl)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    want = fa.flash_bwd(q, k, v, g, lse, delta, True, SC, impl)
    assert torch.equal(out.detach(), o)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want):
        assert torch.equal(got, w)


def test_flash_attention_rejects_unknown_impl():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="bf16|nn|nn2|f32"):
        fa.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK,
                           impl="auto")


CAPS = [dict(zip(("nt_bf16", "nn_bf16", "transpose_f32"), bits))
        for bits in np.ndindex(2, 2, 2)]


@pytest.mark.parametrize("caps", CAPS, ids=lambda c: "-".join(
    k for k, v in c.items() if v) or "none")
def test_resolve_dot_impl_maps_caps_as_reference(caps, monkeypatch):
    """"auto" picks what the reference picks on a TPU backend whose probe
    returned `caps` (its cached caps stand in for the probe), for all 8
    combinations."""
    caps = {k: bool(v) for k, v in caps.items()}
    monkeypatch.setattr(jfa, "_load_caps", lambda backend: caps)
    monkeypatch.setattr(jfa, "_IMPL_MEMO", {})
    monkeypatch.setattr(fa, "probe_caps", lambda device: caps)
    monkeypatch.setattr(fa, "_IMPL_MEMO", {})
    jax_set_flags({"flash_dot_impl": "auto"})
    set_flags({"flash_dot_impl": "auto"})
    assert fa.resolve_dot_impl(torch.device("cuda", 0)) == \
        jfa._resolve_dot_impl("tpu")


def test_resolve_dot_impl_flag_values(monkeypatch):
    """An explicit value comes back as it is; a bad one raises the
    reference's ValueError; "auto" on the CPU means bf16 (nothing to probe)
    and on a card probes once per card."""
    probed = []
    monkeypatch.setattr(fa, "probe_caps",
                        lambda device: probed.append(device) or {})
    monkeypatch.setattr(fa, "_IMPL_MEMO", {})
    try:
        for impl in IMPLS:
            set_flags({"flash_dot_impl": impl})
            assert fa.resolve_dot_impl("cpu") == impl
        for setter in (set_flags, jax_set_flags):
            setter({"flash_dot_impl": "fp8"})
        with pytest.raises(ValueError) as mine:
            fa.resolve_dot_impl("cpu")
        with pytest.raises(ValueError) as ref:
            jfa._resolve_dot_impl("tpu")
        assert str(mine.value) == str(ref.value)
        set_flags({"flash_dot_impl": "auto"})
        assert fa.resolve_dot_impl("cpu") == "bf16"
        for _ in range(2):
            assert fa.resolve_dot_impl(torch.device("cuda", 1)) == "f32"
        assert probed == [torch.device("cuda", 1)]
    finally:
        set_flags({"flash_dot_impl": "auto"})
        jax_set_flags({"flash_dot_impl": "auto"})


def test_probe_plain_products_are_exact():
    """The probe's inputs are small integers, so its four products are
    exact in f32 in any order of summation: the card's result is held to
    them bitwise. Its plain version gives numpy's integer products."""
    a, a32, b = fa.probe_inputs("cpu")
    ai, bi = a.float().numpy().astype(np.int64), b.float().numpy().astype(
        np.int64)
    want = [ai @ bi.T, ai.T @ bi, ai @ bi, ai.T @ bi]
    got = fa.flash_probe_plain(a, a32, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert fa.strategy_from_caps(
        {"nt_bf16": True, "nn_bf16": True, "transpose_f32": True}) == "bf16"


def _wrapper_args(name):
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs())
    lse = delta = torch.zeros(B, H, L)
    qt, kt, vt, dot = (fa.to_t(x) for x in (q, k, v, do))
    rest = (lse, delta, True, SC)
    return {
        "flash_fwd_nn": (q, kt, v, True, SC),
        "flash_fwd_f32dot": (q, k, v, True, SC),
        "flash_dq_nn": (q, k, kt, vt, do, *rest),
        "flash_dq_f32dot": (q, k, v, do, *rest),
        "flash_dkv_nn": (q, kt, vt, do, *rest),
        "flash_dkv_nn2": (q, qt, kt, vt, do, dot, *rest),
        "flash_dkv_f32dot": (q, k, v, do, *rest),
        "flash_probe": fa.probe_inputs("cpu"),
    }[name]


@pytest.mark.parametrize("name", [
    "flash_fwd_nn", "flash_fwd_f32dot", "flash_dq_nn", "flash_dq_f32dot",
    "flash_dkv_nn", "flash_dkv_nn2", "flash_dkv_f32dot", "flash_probe"])
def test_new_cuda_wrappers_refuse_cpu_tensors(name):
    """A wrapper of a CUDA kernel launches or raises: it never computes on
    the CPU itself, and counts no launch."""
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(fa, name + "_cuda")(*_wrapper_args(name))
    assert fa.LAUNCHES == before
