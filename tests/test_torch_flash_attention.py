"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels run in interpret mode on the CPU.

On the CPU the port's wrappers take the plain PyTorch versions of the CUDA
kernels, so these tests hold the plain versions, the autograd.Function and
the attention routing against the reference; chip_smoke.py holds the CUDA
kernels against the same plain versions on the card."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as PF
from paddle_tpu.ops.pallas.flash_attention import (
    _flash_bwd, _flash_fwd, flash_attention_supported as jax_supported)

from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# B = 1, H = 2, L = 128, D = 32 with 64-row blocks: two tiles per head, so
# the causal diagonal tile and a fully visible tile are both exercised
B, L, H, D = 1, 128, 2, 32
BLOCK = 64


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


def _bh(x):
    """[B, L, H, D] numpy -> the reference kernels' [BH, L, D]."""
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(B * H, L, D)


def _from_bh(x):
    return np.swapaxes(np.asarray(x).reshape(B, H, L, D), 1, 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["bf16", "nn", "nn2", "f32"])
def test_plain_fwd_bwd_match_pallas(causal, impl):
    """O and LSE from the reference's `_flash_fwd` residuals, and dQ, dK,
    dV from its `_flash_bwd`, for every dot strategy. f32 tolerances of
    tests/test_pallas.py: atol 2e-5 on O, 2e-4 of the max on the grads;
    LSE (f32 logsumexp of O(1) scores) atol 2e-5."""
    q, k, v, g = _inputs()
    sc = 1.0 / math.sqrt(D)
    out, res = _flash_fwd(_bh(q), _bh(k), _bh(v), sc, causal, BLOCK, BLOCK,
                          True, impl)
    ref_grads = _flash_bwd(sc, causal, BLOCK, BLOCK, True, impl, res,
                           _bh(g))

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal, sc)
    np.testing.assert_allclose(o.numpy(), _from_bh(out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(res[4]).reshape(B, H, L),
                               atol=2e-5)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_bwd_plain(tq, tk, tv, tg, lse, delta, causal, sc)
    for mine, ref in zip(grads, ref_grads):
        ref = _from_bh(ref)
        scale = np.abs(ref).max() + 1e-9
        assert np.abs(mine.numpy() - ref).max() / scale < 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_plain_bwd(dtype):
    """flash_attention's autograd.Function on CPU tensors: its forward is
    the plain forward and its grads are exactly the plain backward's with
    delta = rowsum(dO * O) formed in f32."""
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _inputs(1))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qr, kr, vr, causal=True, block_q=BLOCK,
                             block_k=BLOCK)
    out.backward(g)
    sc = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, True, sc)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    want = fa.flash_bwd_plain(q, k, v, g, lse, delta, True, sc)
    assert torch.equal(out.detach(), o)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want):
        assert got.dtype == dtype
        assert torch.equal(got, w)


@pytest.mark.parametrize("shape,d,causal,bq,bk", [
    ((2, 256, 4, 64), 64, True, 128, 128),
    ((2, 200, 4, 64), 64, True, 128, 128),
    ((2, 256, 4, 512), 512, True, 128, 128),
    ((1, 128, 2, 32), 32, False, 64, 64),
    ((1, 64, 2, 32), 32, True, 128, 128),
    ((1, 192, 2, 256), 256, False, 64, 32),
])
def test_supported_gate_matches_reference(shape, d, causal, bq, bk):
    """The same shapes pass the gate in both packages (the first three are
    tests/test_pallas.py's cases)."""
    assert fa.flash_attention_supported(shape, d, causal, bq, bk) == \
        jax_supported(shape, d, causal, bq, bk)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper of a CUDA kernel launches or raises: it never computes on
    the CPU itself."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_cuda(q, k, v, True, 0.125)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("lq,lk,causal", [
    (128, 128, True), (128, 128, False), (64, 128, True)])
def test_sdpa_routing_matches_reference(use_flash, lq, lk, causal,
                                        monkeypatch):
    """scaled_dot_product_attention against the reference's einsum path
    (the JAX package on the CPU): the flash route for eligible shapes and
    the einsum route otherwise (flag off, or Lq != Lk, where the causal
    mask is bottom-right aligned). f32, atol 2e-5."""
    rng = np.random.RandomState(2)
    q = rng.randn(1, lq, H, D).astype(np.float32)
    k, v = (rng.randn(1, lk, H, D).astype(np.float32) for _ in range(2))
    ref = PF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=causal).numpy()
    routed = []

    def spy(*a, **kw):
        routed.append("flash")
        return fa.flash_attention(*a, **kw)

    monkeypatch.setattr(TF, "flash_attention", spy)
    set_flags({"use_flash_attention": use_flash})
    try:
        out = TF.scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            is_causal=causal)
    finally:
        set_flags({"use_flash_attention": True})
    assert routed == (["flash"] if use_flash and lq == lk else [])
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


class _TPUHost:
    """`jax` as the reference's routing sees it on a TPU host."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


NO_BF16_FORM = {"nt_bf16": False, "nn_bf16": False, "transpose_f32": False}
NN_FORMS = {"nt_bf16": False, "nn_bf16": True, "transpose_f32": True}


@pytest.mark.parametrize("dot_impl,caps,force,seq,flash", [
    ("auto", NO_BF16_FORM, False, 128, False),   # auto-resolved f32, short
    ("auto", NO_BF16_FORM, True, 128, True),     # force_flash_attention
    ("f32", NO_BF16_FORM, False, 128, True),     # an explicit f32 flag
    ("auto", NO_BF16_FORM, False, 2048, True),   # auto f32 from seq 2048
    ("auto", NN_FORMS, False, 128, True),        # auto-resolved nn
    ("nn2", NO_BF16_FORM, False, 128, True),
])
def test_sdpa_strategy_routing_matches_reference(dot_impl, caps, force, seq,
                                                 flash, monkeypatch):
    """Whether attention takes the flash path under each dot strategy, as
    the reference's `_sdpa_p` decides it on a TPU backend whose probe gave
    `caps` (the port's probe on a card stands in the same way): an f32
    that "auto" picked takes flash only from seq 2048, an explicit f32 flag
    or force_flash_attention always. Both flash calls are replaced by spies
    that record the strategy; the einsum paths run."""
    jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    import paddle_tpu.ops.pallas as jpallas
    from paddle_tpu.core.flags import set_flags as jax_set_flags

    routed = {"port": [], "reference": []}

    def port_spy(q, k, v, **kw):
        routed["port"].append(kw["impl"])
        return torch.zeros_like(q)

    def ref_spy(q, k, v, **kw):
        routed["reference"].append(kw["impl"])
        return jnp.zeros_like(q)

    monkeypatch.setattr(TF, "flash_attention", port_spy)
    monkeypatch.setattr(fa, "probe_caps", lambda device: caps)
    monkeypatch.setattr(fa, "_IMPL_MEMO", {})
    monkeypatch.setattr(TF, "resolve_dot_impl",
                        lambda device: fa.resolve_dot_impl(
                            torch.device("cuda", 0)))
    monkeypatch.setattr(jpallas, "flash_attention", ref_spy)
    monkeypatch.setattr(jfa, "_load_caps", lambda backend: caps)
    monkeypatch.setattr(jfa, "_IMPL_MEMO", {})
    monkeypatch.setattr(PF, "jax", _TPUHost())
    flags = {"flash_dot_impl": dot_impl, "force_flash_attention": force}
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, seq, H, D).astype(np.float32) for _ in range(3))
    set_flags(flags)
    jax_set_flags(flags)
    try:
        TF.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
        PF._sdpa_p._pure_fn(*(jnp.asarray(x) for x in (q, k, v)),
                            is_causal=True)
    finally:
        reset = {"flash_dot_impl": "auto", "force_flash_attention": False}
        set_flags(reset)
        jax_set_flags(reset)
    assert routed["port"] == routed["reference"]
    assert bool(routed["port"]) == flash
