"""The premise of the f32-dot forward kernel on bf16 storage
(flash_fwd_mma_kernel's Split instance in
paddle_tpu_torch/ops/csrc/flash_attention.cu), checked on the CPU.

Strategy f32 asks for every dot in f32. On bf16 storage the kernel runs
them as bf16 tensor-core products: S = Q.K^T as one (a product of two bf16
values is exact in f32), and P.V as three, P split into bf16 terms hi, mid
and lo that rebuild it exactly. Here a plain model of that design (the
kernel's 64-key steps, its online softmax in base 2 and its three P.V
products, every sum in f32) is held against the port's f32-dot plain
version and against the reference's f32 strategy in interpret mode, by the
share of bf16 outputs that differ: the limit chip_smoke.py holds the
kernel to on the card. The model is a test helper, not a version of the
port."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import SHARE_TOL
from paddle_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(1)

B, H, L, D = 1, 2, 128, 64
SC = 1.0 / math.sqrt(D)
LOG2E = 1.4426950408889634
STEP = 64                # keys of one softmax step of the kernel


def _inputs(seed=0):
    """q, k, v [B, L, H, D] as bf16 values (numpy f32 from a seed)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _split(p):
    """hi, mid, lo: bf16 terms of f32 p, each from the f32 remainder."""
    hi = p.to(torch.bfloat16)
    mid = (p - hi.float()).to(torch.bfloat16)
    lo = (p - hi.float() - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _split_forward(q, k, v, causal):
    """(O in bf16, LSE) as the split kernel computes them: per 64-key step
    S = Q.K^T from bf16 values with f32 sums, the online softmax against
    the running max in base 2 (scale * log2 e folded in), P kept f32 for
    the row sums, and O += lo.V + mid.V + hi.V, the small terms first."""
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    rows = torch.arange(L)[:, None]
    m = torch.full((B, H, L, 1), -1e30)
    l = torch.zeros(B, H, L, 1)
    o = torch.zeros(B, H, L, D)
    for k0 in range(0, L, STEP):
        s = qh @ kh[:, :, k0:k0 + STEP].transpose(-1, -2)
        if causal:
            keys = torch.arange(k0, k0 + STEP)[None, :]
            s = s.masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * SC)
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * (SC * LOG2E) - m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        vs = vh[:, :, k0:k0 + STEP]
        o = o * alpha
        for term in reversed(_split(p)):
            o = o + term.float() @ vs
        m = m_new
    out = (o / l).transpose(1, 2).to(torch.bfloat16)
    return out, (m + torch.log(l)).squeeze(-1)


def _share(a, b):
    return float((a.float() != b.float()).float().mean())


def test_bf16_products_are_exact_in_f32():
    """The product of two bf16 values (8 significant bits each) equals its
    f64 value rounded to f32: f32's 24 bits hold all 16 of its bits."""
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.randn(4096).astype(np.float32) *
                             np.float32(2.0) ** rng.randint(-20, 20, 4096)
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    f32 = a.float() * b.float()
    f64 = a.double() * b.double()
    assert torch.equal(f32, f64.float())
    assert torch.equal(f32.double(), f64)


def test_split_rebuilds_p_bitwise():
    """hi + mid + lo of f32 P values in [0, 1], exact 0 and 1 included,
    rebuild P bitwise, in f32 and in f64."""
    rng = np.random.RandomState(2)
    p = np.concatenate([np.exp(-rng.uniform(0, 60, 4096)),
                        rng.uniform(0, 1, 4096), [0.0, 1.0]])
    p = torch.from_numpy(p.astype(np.float32))
    hi, mid, lo = _split(p)
    assert torch.equal(hi.float() + mid.float() + lo.float(), p)
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())
    # each term holds what the ones before it left: the split is not a
    # rounding of P to bf16 (which differs from P in almost every entry)
    assert _share(hi, p) > 0.9


@pytest.mark.parametrize("causal", [False, True])
def test_split_model_matches_f32dot_plain(causal):
    """The split model against the port's f32-dot plain version: O's share
    of differing bf16 entries below the kernel's limit, LSE within 1e-5;
    bf16's rounding of P reads far above that share."""
    q, k, v = _inputs()
    o, lse = _split_forward(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, SC, f32_dots=True)
    assert o.shape == o_ref.shape and o.dtype == o_ref.dtype
    assert _share(o, o_ref) < SHARE_TOL
    assert float((lse - lse_ref).abs().max()) <= 1e-5
    o_bf16, _ = fa.flash_fwd_plain(q, k, v, causal, SC)
    assert _share(o_bf16, o_ref) > SHARE_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_split_model_matches_reference_f32(causal):
    """The split model against the reference's f32 strategy in interpret
    mode (`flash_attention(impl="f32")`, which returns O only): the share
    of differing bf16 entries of O below the kernel's limit."""
    q, k, v = _inputs()
    o, _ = _split_forward(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    ref = jfa.flash_attention(jq, jk, jv, causal=causal, sm_scale=SC,
                              interpret=True, impl="f32")
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _share(o, ref) < SHARE_TOL
