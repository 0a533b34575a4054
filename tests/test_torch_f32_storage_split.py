"""The premise of the f32-storage forward, dQ and dK/dV kernels (the kF32
instances of flash_fwd_mma_kernel, flash_dq_mma_kernel and
flash_dkv_mma_kernel in paddle_tpu_torch/ops/csrc/flash_attention.cu),
checked on the CPU.

On f32 storage both operands of every product are f32. flash_split_kernel
splits Q, K, V and dO into bf16 terms hi, mid and lo that rebuild them
exactly; P and dS are split alike in registers; and every product runs as
six bf16 passes of term pairs (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
hi.hi, small weights first), each pass exact in its products, the three
pairs of weight under 2^-24 left out. Each tile's O, dQ, dV or dK passes
are summed apart and then added to the output in f32 (promotion; the
forward's after O's rescaling). Here plain models of that design (the
forward's 128-key softmax blocks of two 64-key tiles at D = 64 and 128;
at D = 256 its 64-key softmax steps, S's passes grouped by K's term and
P.V promoted per V term; 64-key tiles for dQ, 64-query tiles for dK/dV,
32 at D = 128; at D = 256 dQ's and dK/dV's resident rows split from f32
and the streamed operand's terms in half-width pieces, every sum in f32)
are held against the port's plain versions, evaluated in f64 on the same
f32 inputs, at depth L = 1024 by the metrics and limits chip_smoke.py
holds the kernels to on f32 storage: the largest error over the RMS of
its row, 1e-5, and LSE within 1e-4. The models are test helpers, not
versions of the port."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import LSE_ATOL, REL_TOL, row_err
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

F32_TOL = REL_TOL["float32"]
# (a term of A, a term of B) of each pass, small weights first
PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _split(x):
    """hi, mid, lo (as f32 values) of f32 x, each bf16 term from the f32
    remainder the ones before it left."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _passes(a, b, passes=PASSES):
    """a @ b as the kernels form it: the term pairs' products (exact in
    f32) summed pass by pass in f32."""
    ta, tb = _split(a), _split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in passes:
        acc = acc + ta[i] @ tb[j]
    return acc


def _inputs(D, L=1024, seed=0, causal=True):
    """q, k, v, dO [1, L, 1, D] f32 from a seed, with the forward's LSE and
    delta = rowsum(dO * O) from the f32 plain version."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, L, 1, D).astype(np.float32))
                   for _ in range(4))
    sc = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal, sc)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _model_forward(q, k, v, causal, passes=PASSES):
    """(O [1, L, 1, D], LSE [1, 1, L]) f32 of the kF32 forward's design: per
    128-key block, S of its two 64-key tiles by the passes, scaled in f32;
    the online softmax against the running max m, P = exp(S scale - m) in
    f32; O rescaled, then each tile's P.V passes summed apart and added."""
    qh, kh, vh = (x[0, :, 0] for x in (q, k, v))               # [L, D]
    L, D = qh.shape
    sc = 1.0 / math.sqrt(D)
    rows = torch.arange(L)
    m, l = torch.full((L,), -1e30), torch.zeros(L)
    o = torch.zeros(L, D)
    for b0 in range(0, L, 128):
        s = torch.cat([_passes(qh, kh[t0:t0 + 64].t(), passes)
                       for t0 in (b0, b0 + 64)], dim=1) * sc
        if causal:
            keys = torch.arange(b0, b0 + 128)
            s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None]
        for t in (0, 64):
            o = o + _passes(p[:, t:t + 64], vh[b0 + t:b0 + t + 64], passes)
        m = m_new
    return (o / l[:, None])[None, :, None], (m + torch.log(l))[None, None]


def _by_term(a, b, passes=PASSES):
    """a @ b as the kF32 forward at D = 256 forms S from one-term slots of
    b: the passes in PASSES's order taken term by term of b, lo, mid, then
    hi, all summed in f32 into one accumulator."""
    ta, tb = _split(a), _split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for term in (2, 1, 0):
        for i, j in passes:
            if j == term:
                acc = acc + ta[i] @ tb[j]
    return acc


def _model_forward_d256(q, k, v, causal, passes=PASSES):
    """(O, LSE) f32 of the kF32 forward's design at D = 256: per 64-key
    tile S by the passes grouped by K's term (_by_term), scaled in f32; the
    online softmax against the running max, P = exp(S scale - m) in f32; O
    rescaled, then per V term (lo, mid, hi) that term's passes of P.V
    summed apart and added to O."""
    qh, kh, vh = (x[0, :, 0] for x in (q, k, v))               # [L, D]
    L, D = qh.shape
    sc = 1.0 / math.sqrt(D)
    rows = torch.arange(L)
    m, l = torch.full((L,), -1e30), torch.zeros(L)
    o = torch.zeros(L, D)
    for t0 in range(0, L, 64):
        s = _by_term(qh, kh[t0:t0 + 64].t(), passes) * sc
        if causal:
            keys = torch.arange(t0, t0 + 64)
            s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None]
        tp, tv = _split(p), _split(vh[t0:t0 + 64])
        for term in (2, 1, 0):
            part = torch.zeros(L, D)
            for i, j in passes:
                if j == term:
                    part = part + tp[i] @ tv[j]
            o = o + part
        m = m_new
    return (o / l[:, None])[None, :, None], (m + torch.log(l))[None, None]


def _model_backward(q, k, v, do, lse, delta, passes=PASSES):
    """(dQ, dK, dV) [1, L, 1, D] f32 of the kF32 kernels' design, causal:
    P = exp(S scale - LSE) and dS = P (dP - delta) scale from S and dP of
    the passes; dQ over 64-key tiles, dK and dV over query tiles of 64
    (32 at D = 128), each tile's product promoted."""
    qh, kh, vh, doh = (x[0, :, 0] for x in (q, k, v, do))      # [L, D]
    L, D = qh.shape
    sc = 1.0 / math.sqrt(D)
    lse, delta = lse[0, 0], delta[0, 0]
    rows = torch.arange(L)

    def p_ds(qs, ks, dos, vs, r, c):
        s = _passes(qs, ks.t(), passes) * sc - lse[r, None]
        s = s.masked_fill(c[None, :] > r[:, None], -math.inf)
        p = torch.exp(s)
        return p, p * (_passes(dos, vs.t(), passes) - delta[r, None]) * sc

    dq = torch.zeros(L, D)
    for k0 in range(0, L, 64):
        t = slice(k0, k0 + 64)
        _, ds = p_ds(qh, kh[t], doh, vh[t], rows, rows[t])
        dq = dq + _passes(ds, kh[t], passes)
    dk, dv = torch.zeros(L, D), torch.zeros(L, D)
    nq = 32 if D == 128 else 64
    for q0 in range(0, L, nq):
        t = slice(q0, q0 + nq)
        p, ds = p_ds(qh[t], kh, doh[t], vh, rows[t], rows)
        dv = dv + _passes(p.t(), doh[t], passes)
        dk = dk + _passes(ds.t(), qh[t], passes)
    return tuple(x[None, :, None] for x in (dq, dk, dv))


def test_split_rebuilds_f32_operands_bitwise():
    """hi + mid + lo rebuild signed f32 values from 2^-100 to 2^10
    bitwise (0 and -0 by value), and the six passes of two split values
    give their product within 2^-22 of it (the pairs left out weigh under
    2^-24; the five sums round)."""
    rng = np.random.RandomState(1)
    x = (rng.uniform(1, 2, 8192) * 2.0 ** rng.randint(-100, 11, 8192)
         * rng.choice([-1.0, 1.0], 8192))
    x = torch.from_numpy(np.concatenate([x, [0.0, -0.0]]).astype(np.float32))
    hi, mid, lo = _split(x)
    assert torch.equal(hi + mid + lo, x)
    y = torch.from_numpy(rng.randn(x.numel()).astype(np.float32))
    ta, tb = _split(x), _split(y)
    six = torch.zeros_like(x)
    for i, j in PASSES:
        six = six + ta[i] * tb[j]
    exact = x.double() * y.double()
    big = exact.abs() > 2.0 ** -90       # lo of the smallest x flushes
    rel = ((six.double() - exact).abs() / exact.abs())[big]
    assert float(rel.max()) <= 2.0 ** -22


def _f64(args):
    return [a.double() for a in args]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_six_pass_forward_matches_f64_plain(D, causal):
    """The forward model's O at L = 1024 (at D = 256 the model of that
    width's kernel) sits within the f32-storage limit of the plain version
    evaluated in f64 on the same inputs, its LSE within LSE_ATOL; one pass
    of the hi terms alone (bf16's rounding of every operand) reads far
    above both."""
    q, k, v = _inputs(D)[:3]
    sc = 1.0 / math.sqrt(D)
    want_o, want_lse = fa.flash_fwd_plain(*_f64((q, k, v)), causal, sc,
                                          f32_dots=True)
    model = _model_forward_d256 if D == 256 else _model_forward
    o, lse = model(q, k, v, causal)
    coarse_o, coarse_lse = model(q, k, v, causal, passes=((0, 0),))
    assert o.shape == want_o.shape and lse.shape == want_lse.shape
    assert row_err(o, want_o) <= F32_TOL, row_err(o, want_o)
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL
    assert row_err(coarse_o, want_o) > 10 * F32_TOL
    assert float((coarse_lse - want_lse).abs().max()) > LSE_ATOL


@pytest.mark.parametrize("D", [64, 128, 256])
def test_six_pass_backward_matches_f64_plain(D):
    """The model's dQ, dK and dV at L = 1024 (at D = 256 the model of that
    width's kernels) sit within the f32-storage limit of the plain version
    evaluated in f64 on the same inputs (the yardstick chip_smoke.py holds
    the kernels to); one pass of the hi terms alone (bf16's rounding of
    every operand) reads far above it."""
    args = _inputs(D)
    sc = 1.0 / math.sqrt(D)
    want = fa.flash_bwd_plain(*_f64(args), True, sc, f32_dots=True)
    model = _model_backward_d256 if D == 256 else _model_backward
    got = model(*args)
    coarse = model(*args, passes=((0, 0),))
    for name, g, w, c in zip(("dQ", "dK", "dV"), got, want, coarse):
        assert g.shape == w.shape
        assert row_err(g, w) <= F32_TOL, (name, row_err(g, w))
        assert row_err(c, w) > 10 * F32_TOL, name


def test_f32_plain_is_no_yardstick_in_the_first_causal_rows():
    """Why the f32-storage kernels are held against the plain version in
    f64: in a causal head's first row P is one-hot and dP - delta cancels
    (the exact dQ there is only delta's own rounding), so the plain
    version's own f32 dQ at D = 128 is f32 noise in row 0 that reads above
    the limit against f64, and under it without that row; the six-pass
    model reads well under it against the same yardstick."""
    args = _inputs(128)
    sc = 1.0 / math.sqrt(128)
    exact = fa.flash_bwd_plain(*_f64(args), True, sc, f32_dots=True)[0]
    plain = fa.flash_bwd_plain(*args, True, sc, f32_dots=True)[0]
    assert row_err(plain, exact) > F32_TOL
    assert row_err(plain[:, 1:], exact[:, 1:]) < F32_TOL
    assert row_err(_model_backward(*args)[0], exact) < F32_TOL / 2


# the P above which the kF32 dQ takes dP - delta in f64 (kExactP)
EXACT_P = 0.25


def test_large_p_entries_take_dp_in_f64():
    """Why the kF32 dQ takes dP - delta in f64 where P exceeds EXACT_P: the
    f32 plain version's dQ at D = 128 reads above the limit in a causal
    head's first rows (test above); the same computation with those
    entries' dP - delta taken in f64 reads under half of it, the rows where
    P is spread untouched."""
    args = _inputs(128)
    q, k, v, do, lse, delta = args
    sc = 1.0 / math.sqrt(128)
    exact = fa.flash_bwd_plain(*_f64(args), True, sc, f32_dots=True)[0]
    qh, kh, vh, doh = (x[0, :, 0] for x in (q, k, v, do))
    lse, delta = lse[0, 0], delta[0, 0]
    L = qh.shape[0]
    keep = torch.ones(L, L, dtype=torch.bool).tril()
    s = ((qh @ kh.t()) * sc).masked_fill(~keep, -1e30)
    p = torch.exp(s - lse[:, None])
    dp = doh @ vh.t() - delta[:, None]
    dp64 = (doh.double() @ vh.double().t() - delta.double()[:, None]).float()
    big = p > EXACT_P
    assert bool(big[:4].any(-1).all()) and float(big[64:].float().mean()) < 1e-3
    dq = (p * torch.where(big, dp64, dp) * sc) @ kh
    assert row_err(dq[None, :, None], exact) < F32_TOL / 2


def _by_piece(a, b, passes=PASSES):
    """a @ b as the kF32 dQ and dK/dV at D = 256 form S and dP (S^T and
    dP^T): a is the item's resident rows, split from f32; b's terms stream
    as pieces of 128 depth columns, lo first, each term's two halves in
    turn, a hi piece's hi.hi pass after its small passes. The first five
    pieces add into one f32 accumulator, the last into a fresh one, and
    the two are added in f32."""
    ta, tb = _split(a), _split(b)
    halves = (slice(0, 128), slice(128, 256))
    order = [(i, j) for i, j in passes if (i, j) != (0, 0)]
    order += [(i, j) for i, j in passes if (i, j) == (0, 0)]
    parts = []
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for q in range(6):
        term, h = 2 - q // 2, halves[q % 2]
        if q == 5:
            parts.append(acc)
            acc = torch.zeros_like(acc)
        for i, j in order:
            if j == term:
                acc = acc + ta[i][:, h] @ tb[j][h]
    return parts[0] + acc


def _add_by_term(out, a, b, passes=PASSES):
    """out + a @ b as those kernels add a tile's share of an output: per
    term of the streamed operand b (lo, mid, hi) and 64-column chunk, that
    term's passes summed apart, then added to out in f32 (promotion)."""
    ta, tb = _split(a), _split(b)
    for term in (2, 1, 0):
        part = torch.zeros_like(out)
        for i, j in passes:
            if j == term:
                part = part + ta[i] @ tb[j]
        out = out + part
    return out


def _model_backward_d256(q, k, v, do, lse, delta, causal=True,
                         passes=PASSES, exact=True):
    """(dQ, dK, dV) [1, L, 1, D] f32 of the kF32 dQ and dK/dV's design at
    D = 256. dQ per 64-key tile: S and dP by pieces (_by_piece), P =
    exp(S scale - LSE), dP - delta in f32 or, where P > EXACT_P (with
    `exact`), in f64 from the f32 operands; dS = P (dP - delta) scale, and
    dQ += dS.K by K term (_add_by_term). dK/dV per 64-query tile: S^T and
    dP^T by pieces, P^T and dS^T in f32, dV += P^T.dO by dO term and dK +=
    dS^T.Q by Q term."""
    qh, kh, vh, doh = (x[0, :, 0] for x in (q, k, v, do))      # [L, D]
    L, D = qh.shape
    sc = 1.0 / math.sqrt(D)
    lse, delta = lse[0, 0], delta[0, 0]
    rows = torch.arange(L)
    dq = torch.zeros(L, D)
    for k0 in range(0, L, 64):
        t = slice(k0, k0 + 64)
        s = _by_piece(qh, kh[t].t(), passes) * sc
        if causal:
            s = s.masked_fill(rows[t][None, :] > rows[:, None], -math.inf)
        p = torch.exp(s - lse[:, None])
        dp = _by_piece(doh, vh[t].t(), passes) - delta[:, None]
        if exact:
            dp64 = (doh.double() @ vh[t].double().t()
                    - delta.double()[:, None]).float()
            dp = torch.where(p > EXACT_P, dp64, dp)
        dq = _add_by_term(dq, p * dp * sc, kh[t], passes)
    dk, dv = torch.zeros(L, D), torch.zeros(L, D)
    for q0 in range(0, L, 64):
        t = slice(q0, q0 + 64)
        pt = torch.exp(_by_piece(kh, qh[t].t(), passes) * sc - lse[t])
        if causal:
            pt = pt.masked_fill(rows[t][None, :] < rows[:, None], 0.0)
        dst = pt * (_by_piece(vh, doh[t].t(), passes) - delta[t]) * sc
        dv = _add_by_term(dv, pt, doh[t], passes)
        dk = _add_by_term(dk, dst, qh[t], passes)
    return tuple(x[None, :, None] for x in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
def test_d256_backward_design_matches_f64_plain(causal):
    """The D = 256 design's dQ, dK and dV at L = 1024, causal and not, read
    under half the f32-storage limit against the plain version in f64 on
    the same inputs; one pass of the hi terms alone reads above ten times
    the limit."""
    args = _inputs(256, causal=causal)
    want = fa.flash_bwd_plain(*_f64(args), causal, 1 / 16, f32_dots=True)
    got = _model_backward_d256(*args, causal)
    coarse = _model_backward_d256(*args, causal, passes=((0, 0),))
    for name, g, w, c in zip(("dQ", "dK", "dV"), got, want, coarse):
        assert row_err(g, w) < F32_TOL / 2, (name, row_err(g, w))
        assert row_err(c, w) > 10 * F32_TOL, name


def test_d256_dq_needs_dp_in_f64_where_p_is_large():
    """Why the D = 256 dQ keeps the f64 dP - delta where P > EXACT_P: with
    dP from the passes alone its dQ reads above half the limit in a causal
    head's first rows; with it, under."""
    args = _inputs(256)
    want = fa.flash_bwd_plain(*_f64(args), True, 1 / 16, f32_dots=True)[0]
    plain_dp = _model_backward_d256(*args, exact=False)[0]
    assert row_err(plain_dp, want) > F32_TOL / 2
    assert row_err(_model_backward_d256(*args)[0], want) < F32_TOL / 2
