"""The premise of the f32-dot kernels on bf16 storage (the Split
instances of flash_fwd_mma_kernel, flash_dq_mma_kernel and
flash_dkv_mma_kernel in paddle_tpu_torch/ops/csrc/flash_attention.cu),
checked on the CPU.

Strategy f32 asks for every dot in f32. On bf16 storage the kernels run
them as bf16 tensor-core products: a dot of two bf16 operands (S = Q.K^T,
dP = dO.V^T) as one, since a product of two bf16 values is exact in f32,
and a dot with an f32 operand (P.V, dS.K, P^T.dO, dS^T.Q) as three, the
f32 operand split into bf16 terms hi, mid and lo that rebuild it exactly.
Here plain models of that design (the forward's 64-key steps and online
softmax in base 2, at D = 64 and, as the D = 256 forward steps, at 256;
dQ's 64-key tiles, dK/dV's 64-query tiles, at D = 64 and 256; every sum
in f32) are held
against the port's f32-dot plain versions and against the reference's f32
strategy in interpret mode, by the share of bf16 outputs that differ: the
limit chip_smoke.py holds the kernels to on the card. The models are test
helpers, not versions of the port."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import SHARE_TOL
from paddle_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(1)

B, H, L, D = 1, 2, 128, 64
SC = 1.0 / math.sqrt(D)
LOG2E = 1.4426950408889634
STEP = 64                # keys of one softmax step, rows of a tile


def _inputs(seed=0, n=3, shape=(B, L, H, D)):
    """q, k, v (and with n = 4, dO) [B, L, H, D] as bf16 values (numpy f32
    from a seed)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(torch.bfloat16) for _ in range(n)]


def _split(p):
    """hi, mid, lo: bf16 terms of f32 p, each from the f32 remainder."""
    hi = p.to(torch.bfloat16)
    mid = (p - hi.float()).to(torch.bfloat16)
    lo = (p - hi.float() - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _split_forward(q, k, v, causal):
    """(O in bf16, LSE) as the split kernel computes them (at any shape;
    the scale from the head_dim): per 64-key step S = Q.K^T from bf16
    values with f32 sums, the online softmax against the running max in
    base 2 (scale * log2 e folded in), P kept f32 for the row sums, and O
    += lo.V + mid.V + hi.V, the small terms first."""
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    nb, nh, n, d = qh.shape
    sc = 1.0 / math.sqrt(d)
    rows = torch.arange(n)[:, None]
    m = torch.full((nb, nh, n, 1), -1e30)
    l = torch.zeros(nb, nh, n, 1)
    o = torch.zeros(nb, nh, n, d)
    for k0 in range(0, n, STEP):
        s = qh @ kh[:, :, k0:k0 + STEP].transpose(-1, -2)
        if causal:
            keys = torch.arange(k0, k0 + STEP)[None, :]
            s = s.masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sc)
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * (sc * LOG2E) - m_new * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        vs = vh[:, :, k0:k0 + STEP]
        o = o * alpha
        for term in reversed(_split(p)):
            o = o + term.float() @ vs
        m = m_new
    out = (o / l).transpose(1, 2).to(torch.bfloat16)
    return out, (m + torch.log(l)).squeeze(-1)


def _tile_p_ds(q, k, v, do, lse, delta, rows, keys, causal, fused):
    """P and dS (f32, [B, H, rows, keys]) of one tile as the kernels form
    them (q, k, v, do [B, H, L, D] in f32; the scale from D): S and dP
    from bf16 values with f32 sums, masked keys at -inf, P = 2^(S scale
    log2 e - LSE log2 e), with the scale folded into one FMA (dQ, `fused`)
    or applied before LSE is taken off (dK/dV), then dS = P (dP - delta)
    scale."""
    n, sc = q.shape[2], 1.0 / math.sqrt(q.shape[3])
    s = q[:, :, rows] @ k[:, :, keys].transpose(-1, -2)
    dp = do[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
    if causal:
        r = torch.arange(n)[rows][:, None]
        c = torch.arange(n)[keys][None, :]
        s = s.masked_fill(c > r, -math.inf)
    lse_t = lse[:, :, rows, None]
    if fused:
        p = torch.exp2(s * (sc * LOG2E) - lse_t * LOG2E)
    else:
        p = torch.exp2((s * sc - lse_t) * LOG2E)
    return p, p * (dp - delta[:, :, rows, None]) * sc


def _split_dot(acc, x, b, rounded=False):
    """acc + x.b with x f32 as the kernels take it: the dots of x's lo, mid
    and hi terms with b, small terms first, each summed into acc in f32.
    `rounded`: x rounded to bf16 instead (bf16's function), one dot."""
    terms = [x.to(torch.bfloat16)] if rounded else reversed(_split(x))
    for term in terms:
        acc = acc + term.float() @ b
    return acc


def _split_backward(q, k, v, do, lse, delta, causal, rounded=False):
    """(dQ, dK, dV) in bf16 as the split kernels compute them (at any shape;
    the scale from the head_dim): dQ over 64-key tiles, dQ += lo.K + mid.K
    + hi.K, each term's passes over the tile's four 16-key k-steps before
    the next term's (at D = 256 each consumer splits its fragments per
    k-step from the f32 dS tile; the split is elementwise, so its terms are
    the whole tile's); dK and dV over 64-query tiles, dV += P^T's terms .
    dO and dK += dS^T's terms . Q; every sum in f32."""
    qh, kh, vh, doh = (x.transpose(1, 2).float() for x in (q, k, v, do))
    n = qh.shape[2]
    dq, dk, dv = (torch.zeros(qh.shape) for _ in range(3))
    every = slice(0, n)
    for t0 in range(0, n, STEP):
        tile = slice(t0, t0 + STEP)
        _, ds = _tile_p_ds(qh, kh, vh, doh, lse, delta, every, tile, causal,
                           fused=True)
        dq = _split_dot(dq, ds, kh[:, :, tile], rounded)
        p, ds = _tile_p_ds(qh, kh, vh, doh, lse, delta, tile, every, causal,
                           fused=False)
        dv = _split_dot(dv, p.transpose(-1, -2), doh[:, :, tile], rounded)
        dk = _split_dot(dk, ds.transpose(-1, -2), qh[:, :, tile], rounded)
    return tuple(x.transpose(1, 2).to(torch.bfloat16) for x in (dq, dk, dv))


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


def _split_operand(kind):
    """f32 values of the operands the kernels split: P in [0, 1], exact 0
    and 1 included; dS signed across magnitudes 2^-100 to 2^10, with 0
    and -0."""
    rng = np.random.RandomState(2)
    if kind == "P":
        x = np.concatenate([np.exp(-rng.uniform(0, 60, 4096)),
                            rng.uniform(0, 1, 4096), [0.0, 1.0]])
    else:
        x = (rng.uniform(1, 2, 8192) * 2.0 ** rng.randint(-100, 11, 8192)
             * rng.choice([-1.0, 1.0], 8192))
        x = np.concatenate([x, [0.0, -0.0]])
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["P", "dS"])
def test_split_rebuilds_p_bitwise(kind):
    """hi + mid + lo of the f32 values rebuild them bitwise, in f32 and in
    f64; -0 is rebuilt as +0 (-0 + 0 = +0), equal by value, which no dot
    can tell apart: the kernels' sums start from +0."""
    x = _split_operand(kind)
    hi, mid, lo = _split(x)
    for dt in (torch.float32, torch.float64):
        back = hi.to(dt) + mid.to(dt) + lo.to(dt)
        assert torch.equal(back, x.to(dt))
    back = (hi.float() + mid.float() + lo.float()).view(torch.int32)
    nonzero = x != 0
    assert torch.equal(back[nonzero], x.view(torch.int32)[nonzero])
    # each term holds what the ones before it left: the split is not a
    # rounding to bf16 (which differs from x in almost every entry)
    assert _share(hi, x) > 0.9


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
    assert _share(o, _reference_f32(q, k, v, causal, SC)) < SHARE_TOL


def _reference_f32(q, k, v, causal, sc):
    """O of the reference's f32 strategy in interpret mode, as f32."""
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    ref = jfa.flash_attention(jq, jk, jv, causal=causal, sm_scale=sc,
                              interpret=True, impl="f32")
    return torch.from_numpy(np.array(ref.astype(jnp.float32)))


# the D = 256 forward's shape here: two heads of 256 columns, four 64-key
# steps (L = 256)
D256_SHAPE = (1, 256, 2, 256)


@pytest.mark.parametrize("causal", [False, True])
def test_d256_split_model_matches_f32dot_plain(causal):
    """The split forward as the D = 256 kernel steps it (64-key tiles, P's
    three terms each times the V tile, small first) against the port's
    f32-dot plain version: O's share of differing bf16 entries below the
    kernel's limit, LSE within 1e-5; bf16's rounding of P reads above that
    share."""
    q, k, v = _inputs(5, shape=D256_SHAPE)
    sc = 1.0 / math.sqrt(D256_SHAPE[-1])
    o, lse = _split_forward(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc, f32_dots=True)
    assert o.shape == o_ref.shape and o.dtype == o_ref.dtype
    assert _share(o, o_ref) < SHARE_TOL
    assert float((lse - lse_ref).abs().max()) <= 1e-5
    o_bf16, _ = fa.flash_fwd_plain(q, k, v, causal, sc)
    assert _share(o_bf16, o_ref) > SHARE_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_d256_split_model_matches_reference_f32(causal):
    """The D = 256 split forward model against the reference's `_fwd` with
    impl="f32" in interpret mode at L = 256: the share of differing bf16
    entries of O below the kernel's limit."""
    q, k, v = _inputs(5, shape=D256_SHAPE)
    o, _ = _split_forward(q, k, v, causal)
    ref = _reference_f32(q, k, v, causal, 1.0 / math.sqrt(D256_SHAPE[-1]))
    assert _share(o, ref) < SHARE_TOL


def _bwd_inputs(causal, shape=(B, L, H, D)):
    """q, k, v, dO (bf16) and the forward's LSE and delta = rowsum(dO * O)
    in f32, from the port's f32-dot plain forward."""
    q, k, v, do = _inputs(3, n=4, shape=shape)
    o, lse = fa.flash_fwd_plain(q, k, v, causal, 1.0 / math.sqrt(shape[-1]),
                                f32_dots=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


# the backward's shapes: the module's (D = 64), and the D = 256 kernels'
# with two heads and four 64-row tiles
BWD_SHAPES = {"D64": (B, L, H, D), "D256": D256_SHAPE}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_split_backward_matches_f32dot_plain(shape, causal):
    """The split backward model against the port's f32-dot plain version on
    the same LSE and delta, at D = 64 and at the D = 256 kernels' head_dim:
    the share of differing bf16 entries of dQ, dK and dV below the
    kernels' limit. P and dS rounded to bf16 (bf16's function, in the same
    model) read above it."""
    shape = BWD_SHAPES[shape]
    args = _bwd_inputs(causal, shape)
    got = _split_backward(*args, causal)
    want = fa.flash_bwd_plain(*args, causal, 1.0 / math.sqrt(shape[-1]),
                              f32_dots=True)
    rounded = _split_backward(*args, causal, rounded=True)
    for name, g, w, r in zip(("dQ", "dK", "dV"), got, want, rounded):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _share(g, w) < SHARE_TOL, name
        assert _share(r, w) > SHARE_TOL, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_split_backward_matches_reference_f32(shape, causal):
    """The split forward and backward models against the gradients of the
    reference's f32 strategy in interpret mode (`jax.vjp` of
    `flash_attention(impl="f32")`), on inputs and dO from a numpy seed, at
    D = 64 and at the D = 256 kernels' head_dim: the share of differing
    bf16 entries of dQ, dK and dV below the kernels' limit."""
    shape = BWD_SHAPES[shape]
    sc = 1.0 / math.sqrt(shape[-1])
    q, k, v, do = _inputs(4, n=4, shape=shape)
    o, lse = _split_forward(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = _split_backward(q, k, v, do, lse, delta, causal)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                            sm_scale=sc, interpret=True,
                                            impl="f32"), jq, jk, jv)
    for name, g, ref in zip(("dQ", "dK", "dV"), got, vjp(jdo)):
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        assert _share(g, ref) < SHARE_TOL, name


def test_dq_share_sits_in_the_first_causal_rows():
    """Why the f32-dot dQ is held to a share of differing entries and not
    bitwise: in a causal head's first rows P is near one-hot and dP - delta
    cancels to a small remainder, so another order of dP's f32 sums (here
    f64 sums rounded to f32, as the tensor cores' order stands in for)
    moves dQ's bf16 rounding in many entries of those rows and in few of
    the rest. At this size the share stays below the kernels' limit."""
    q, k, v, do, lse, delta = _bwd_inputs(True)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, True, SC,
                              f32_dots=True)[0]
    qh, kh, vh, doh = (x.transpose(1, 2).float() for x in (q, k, v, do))
    s = (qh @ kh.transpose(-1, -2) * SC).masked_fill(
        ~torch.ones(L, L, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - lse[..., None])
    dp = (doh.double() @ vh.double().transpose(-1, -2)).float()
    ds = p * (dp - delta[..., None]) * SC
    dq = (ds @ kh).transpose(1, 2).to(torch.bfloat16)
    first = 8
    assert _share(dq[:, :first], want[:, :first]) > 0.02
    assert _share(dq[:, first:], want[:, first:]) < 1e-3
    assert _share(dq, want) < SHARE_TOL
