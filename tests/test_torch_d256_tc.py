"""The arithmetic of the tensor-core flash kernels at head_dim 256 on bf16
storage (flash_fwd_mma_kernel<256, kStd|kNN>, flash_dq_mma_kernel<256,
kStd|kNN> and flash_dkv_mma_kernel<256, kStd|kNN|kNN2> in
paddle_tpu_torch/ops/csrc/flash_attention.cu, strategies bf16, nn and
nn2), checked on the CPU.

The forward scores a whole 128-key softmax block (the reference's
flash_block_k) as two 64-key tiles, rounds P to bf16 against the block's
running max and multiplies P.V in 64-key halves. dK/dV splits its outputs
between two consumers: one forms S^T and P^T per 64-query tile and runs
dV += bf16(P^T).dO, the other takes P^T in f32 from it, forms dS^T =
P^T (dP^T - delta) scale and runs dK += bf16(dS^T).Q. dQ splits its output
the same way: per 64-key tile one consumer forms S and P in f32, the other
dP and dS = P (dP - delta) scale, rounded to bf16, and each adds its half
of dQ's columns, bf16(dS).K, in f32. Plain models of that arithmetic (every sum in f32) are held against the port's plain versions by
chip_smoke.py's bf16 row error, and against the reference's Pallas kernels
in interpret mode within one bf16 step, at D = 256 and L = 256, causal and
not; the nn and nn2 layouts go through to_t and from_t as the wrappers
take them. Beside them: the instance names the wrappers count launches by,
which instances chip_smoke.py requires at head_dim 256, and which kernels
work from split terms there (every kernel on f32 storage: their kF32
tensor-core instances).
The models are test helpers, not versions of the port."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (D256_F32_INSTANCES, D256_INSTANCES,
                        D256_TC_INSTANCES, REL_TOL, is_instance, mma_instance,
                        row_err)
from paddle_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

BF16_TOL = REL_TOL["bfloat16"]
# tests/test_torch_padding.py's bf16 limits against the reference: within
# one bf16 step of the output's largest magnitude, and no larger a share of
# entries apart (the reference rounds P against the same block maxima, so
# only the order of f32 sums differs)
BF16_SHARE = 0.25
B, L, H, D = 1, 256, 2, 256


def _inputs(seed=0):
    """q, k, v, dO [B, L, H, D] in bf16 from a seed."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]


def _heads(x):
    return x.transpose(1, 2).float()                # [B, H, L, D] f32


def _rows(x, dtype=torch.bfloat16):
    return x.transpose(1, 2).to(dtype).contiguous()   # [B, L, H, D]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def model_fwd(q, k, v, causal, sc, skip=None, block=128):
    """(O, LSE) of the D = 256 forward's arithmetic: per 128-key block S of
    its two 64-key tiles, the online softmax against the block's running
    max, P rounded to bf16, O rescaled and then P.V added tile by tile.
    `skip` (query tile, key tile) of 64 rows leaves out that pair: what a
    kernel that skipped one tile would give; `block` 64: softmax steps of
    one tile, P rounded against a 64-key running max instead."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    rows = torch.arange(L)
    m = torch.full((B, H, L), -1e30)
    l = torch.zeros(B, H, L)
    o = torch.zeros(B, H, L, D)
    for b0 in range(0, L, block):
        s = torch.cat([qh @ kh[:, :, t0:t0 + 64].transpose(-1, -2)
                       for t0 in range(b0, b0 + block, 64)], dim=-1)
        keys = torch.arange(b0, b0 + block)
        if causal:
            s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        if skip is not None:
            qs, ks = skip
            hit = ((rows[:, None] // 64 == qs) & (keys[None, :] // 64 == ks))
            s = s.masked_fill(hit, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * sc)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s * sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        for t in range(0, block, 64):
            o = o + _bf16(p[..., t:t + 64]) @ vh[:, :, b0 + t:b0 + t + 64]
        m = m_new
    return _rows(o / l[..., None]), m + torch.log(l)


def model_dkv(q, k, v, do, lse, delta, causal, sc):
    """(dK, dV) of the D = 256 dK/dV's arithmetic: per 64-key item and
    64-query tile from the causal start, the dV consumer's S^T = K.Q^T,
    P^T = exp(S^T scale - LSE) (0 past the diagonal) and dV +=
    bf16(P^T).dO; the dK consumer's dP^T = V.dO^T, dS^T = P^T (dP^T -
    delta) scale from the exchanged f32 P^T, and dK += bf16(dS^T).Q."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    dk, dv = torch.zeros(B, H, L, D), torch.zeros(B, H, L, D)
    for k0 in range(0, L, 64):
        ks = slice(k0, k0 + 64)
        keys = torch.arange(k0, k0 + 64)
        for q0 in range(k0 if causal else 0, L, 64):
            qs = slice(q0, q0 + 64)
            queries = torch.arange(q0, q0 + 64)
            st = kh[:, :, ks] @ qh[:, :, qs].transpose(-1, -2)
            pt = torch.exp(st * sc - lse[:, :, None, qs])
            if causal:
                pt = pt.masked_fill(queries[None, :] < keys[:, None], 0.0)
            dv[:, :, ks] += _bf16(pt) @ doh[:, :, qs]
            dpt = vh[:, :, ks] @ doh[:, :, qs].transpose(-1, -2)
            dst = pt * (dpt - delta[:, :, None, qs]) * sc
            dk[:, :, ks] += _bf16(dst) @ qh[:, :, qs]
    return _rows(dk), _rows(dv)


def model_dq(q, k, v, do, lse, delta, causal, sc, skip=None):
    """dQ of the D = 256 dQ kernel's arithmetic: per 64-row query tile and
    64-key tile through its diagonal, S = Q.K^T and dP = dO.V^T in f32, P =
    exp(S scale - LSE) (0 past the diagonal), dS = P (dP - delta) scale
    rounded to bf16, and each of dQ's two 128-column halves (one consumer
    each) adds bf16(dS).K[:, half] in f32, tile by tile. `skip` (query
    tile, key tile) leaves out that pair."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    dq = torch.zeros(B, H, L, D)
    for q0 in range(0, L, 64):
        qs = slice(q0, q0 + 64)
        queries = torch.arange(q0, q0 + 64)
        for k0 in range(0, q0 + 64 if causal else L, 64):
            if skip == (q0 // 64, k0 // 64):
                continue
            ks = slice(k0, k0 + 64)
            keys = torch.arange(k0, k0 + 64)
            s = qh[:, :, qs] @ kh[:, :, ks].transpose(-1, -2)
            p = torch.exp(s * sc - lse[:, :, qs, None])
            if causal:
                p = p.masked_fill(keys[None, :] > queries[:, None], 0.0)
            dp = doh[:, :, qs] @ vh[:, :, ks].transpose(-1, -2)
            ds = _bf16(p * (dp - delta[:, :, qs, None]) * sc)
            for half in (slice(0, D // 2), slice(D // 2, D)):
                dq[:, :, qs, half] += ds @ kh[:, :, ks, half]
    return _rows(dq)


def _stats(q, k, v, do, causal, sc):
    """LSE and delta = rowsum(dO * O) from the port's plain forward."""
    o, lse = fa.flash_fwd_plain(q, k, v, causal, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return lse, delta


@pytest.mark.parametrize("causal", [True, False])
def test_forward_model_matches_plain(causal):
    """The forward model's O is within chip_smoke.py's bf16 row error of
    the plain version (which rounds P against the final max), its LSE
    within f32 noise; a model that skips one tile pair reads above the
    limit, so the check would catch a kernel that did."""
    q, k, v, _ = _inputs()
    sc = 1.0 / math.sqrt(D)
    o, lse = model_fwd(q, k, v, causal, sc)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal, sc)
    assert o.shape == want_o.shape and lse.shape == want_lse.shape
    assert row_err(o, want_o) <= BF16_TOL, row_err(o, want_o)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    skipped, _ = model_fwd(q, k, v, causal, sc, skip=(3, 1))
    assert row_err(skipped, want_o) > BF16_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_dkv_model_matches_plain(causal):
    """The dK/dV model is within chip_smoke.py's bf16 row error of the
    plain version on the same LSE and delta."""
    q, k, v, do = _inputs()
    sc = 1.0 / math.sqrt(D)
    lse, delta = _stats(q, k, v, do, causal, sc)
    got = model_dkv(q, k, v, do, lse, delta, causal, sc)
    want = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal, sc)
    for name, g, w in zip(("dK", "dV"), got, want):
        assert g.shape == w.shape
        assert row_err(g, w) <= BF16_TOL, (name, row_err(g, w))


@pytest.mark.parametrize("causal", [True, False])
def test_dq_model_matches_plain(causal):
    """The dQ model is within chip_smoke.py's bf16 row error of the plain
    versions of bf16 (flash_dq_plain) and of nn (flash_dq_nn_plain, fed K^T
    and V^T through to_t) on the same LSE and delta; a model that skips one
    tile pair reads above the limit, so the check would catch a kernel that
    did."""
    q, k, v, do = _inputs()
    sc = 1.0 / math.sqrt(D)
    lse, delta = _stats(q, k, v, do, causal, sc)
    dq = model_dq(q, k, v, do, lse, delta, causal, sc)
    want = fa.flash_dq_plain(q, k, v, do, lse, delta, causal, sc)
    want_nn = fa.flash_dq_nn_plain(q, k, fa.to_t(k), fa.to_t(v), do, lse,
                                   delta, causal, sc)
    assert dq.shape == want.shape == want_nn.shape
    assert row_err(dq, want) <= BF16_TOL, row_err(dq, want)
    assert row_err(dq, want_nn) <= BF16_TOL, row_err(dq, want_nn)
    skipped = model_dq(q, k, v, do, lse, delta, causal, sc, skip=(3, 1))
    assert row_err(skipped, want) > BF16_TOL


def _bf16_step(x):
    """One bf16 step (2^-7 of the leading power of two) at x's largest
    magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _near_reference(mine, ref):
    mine = mine.float().numpy()
    diff = np.abs(mine - ref)
    return (diff.max() <= _bf16_step(ref)
            and (diff > 0).mean() <= BF16_SHARE), float(diff.max())


def _bh(x):
    return jnp.swapaxes(jnp.asarray(x.float().numpy(), jnp.bfloat16), 1,
                        2).reshape(B * H, L, D)


def _from_bh(x):
    return np.swapaxes(np.asarray(x, np.float32).reshape(B, H, L, D), 1, 2)


@pytest.mark.parametrize("causal", [True, False])
def test_models_match_reference(causal):
    """Both models against the reference's Pallas kernels in interpret mode
    (strategy bf16, blocks of 128): O and LSE from the forward, dK and dV
    on the reference's own O and LSE, each within one bf16 step."""
    q, k, v, do = _inputs()
    sc = 1.0 / math.sqrt(D)
    out, res = _flash_fwd(_bh(q), _bh(k), _bh(v), sc, causal, 128, 128, True,
                          "bf16")
    _, ref_dk, ref_dv = _flash_bwd(sc, causal, 128, 128, True, "bf16", res,
                                   _bh(do))
    ref_lse = torch.from_numpy(np.array(res[4]).reshape(B, H, L))
    o, lse = model_fwd(q, k, v, causal, sc)
    ok, diff = _near_reference(o, _from_bh(out))
    assert ok, ("O", diff)
    assert float((lse - ref_lse).abs().max()) <= 2e-5
    ref_o = torch.from_numpy(_from_bh(res[3])).to(torch.bfloat16)
    delta = (do.float() * ref_o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = model_dkv(q, k, v, do, ref_lse, delta, causal, sc)
    for name, mine, ref in (("dK", dk, ref_dk), ("dV", dv, ref_dv)):
        ok, diff = _near_reference(mine, _from_bh(ref))
        assert ok, (name, diff)


@pytest.mark.parametrize("causal", [True, False])
def test_dq_model_matches_reference(causal):
    """The dQ model against the reference's Pallas dQ kernel in interpret
    mode (strategy bf16, blocks of 128), on the reference's own LSE and O,
    within one bf16 step of dQ's largest magnitude and no larger a share of
    entries apart than BF16_SHARE (the rounding points are the reference's;
    only the order of the f32 sums differs)."""
    q, k, v, do = _inputs()
    sc = 1.0 / math.sqrt(D)
    _, res = _flash_fwd(_bh(q), _bh(k), _bh(v), sc, causal, 128, 128, True,
                        "bf16")
    ref_dq, _, _ = _flash_bwd(sc, causal, 128, 128, True, "bf16", res,
                              _bh(do))
    ref_lse = torch.from_numpy(np.array(res[4]).reshape(B, H, L))
    ref_o = torch.from_numpy(_from_bh(res[3])).to(torch.bfloat16)
    delta = (do.float() * ref_o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = model_dq(q, k, v, do, ref_lse, delta, causal, sc)
    ok, diff = _near_reference(dq, _from_bh(ref_dq))
    assert ok, ("dQ", diff)


def test_nn_layouts_give_the_same_results():
    """The nn forms take K^T (forward) and K^T, V^T (dK/dV); nn2's dK/dV
    also Q^T and dO^T and gives dK^T and dV^T, all [B, H, D, L] through
    to_t. Read back through from_t they are the models' operands, so the
    models give bf16's results bitwise, as the kernels do; and the nn
    plain versions, fed those layouts, agree with them as bf16's do."""
    q, k, v, do = _inputs()
    sc = 1.0 / math.sqrt(D)
    lse, delta = _stats(q, k, v, do, True, sc)
    qt, kt, vt, dot = (fa.to_t(x) for x in (q, k, v, do))
    assert kt.shape == (B, H, D, L) and kt.is_contiguous()
    o, lse_m = model_fwd(q, k, v, True, sc)
    o_nn, lse_nn = model_fwd(q, fa.from_t(kt), v, True, sc)
    assert torch.equal(o, o_nn) and torch.equal(lse_m, lse_nn)
    want_o, _ = fa.flash_fwd_nn_plain(q, kt, v, True, sc)
    assert row_err(o_nn, want_o) <= BF16_TOL
    dk, dv = model_dkv(q, k, v, do, lse, delta, True, sc)
    dk_nn, dv_nn = model_dkv(q, fa.from_t(kt), fa.from_t(vt), do, lse, delta,
                             True, sc)
    assert torch.equal(dk, dk_nn) and torch.equal(dv, dv_nn)
    dkt, dvt = (fa.to_t(x) for x in model_dkv(
        fa.from_t(qt), fa.from_t(kt), fa.from_t(vt), fa.from_t(dot), lse,
        delta, True, sc))
    assert torch.equal(fa.from_t(dkt), dk) and torch.equal(fa.from_t(dvt), dv)
    want_t = fa.flash_dkv_nn2_plain(q, qt, kt, vt, do, dot, lse, delta, True,
                                    sc)
    for g, w in zip((dkt, dvt), want_t):
        assert g.shape == (B, H, D, L)
        assert row_err(fa.from_t(g), fa.from_t(w)) <= BF16_TOL


PRETTY = {
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_fwd_mma_kernel<256, 1>]": "flash_fwd_mma_kernel<256, kNN, kBf16>",
    "const char* instance_name() [with auto Kernel = "
    "_GLOBAL__N__x::flash_dkv_mma_kernel<256, 2, 0>]":
        "flash_dkv_mma_kernel<256, kNN2, kBf16>",
    "[with auto Kernel = flash_dq_mma_kernel<64, 0, 2>]":
        "flash_dq_mma_kernel<64, kStd, kF32>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_dq_mma_kernel<256, 1>]": "flash_dq_mma_kernel<256, kNN, kBf16>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "{anonymous}::flash_split_kernel]": "flash_split_kernel",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_dq_mma_kernel<256, 0, 1>]":
        "flash_dq_mma_kernel<256, kStd, kSplit>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_dkv_mma_kernel<256, 0, 1>]":
        "flash_dkv_mma_kernel<256, kStd, kSplit>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_dq_mma_kernel<256, 0, 2>]": "flash_dq_mma_kernel<256, kStd, kF32>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_dkv_mma_kernel<256, 0, 2>]":
        "flash_dkv_mma_kernel<256, kStd, kF32>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_fwd_mma_kernel<256, 0, 1>]":
        "flash_fwd_mma_kernel<256, kStd, kSplit>",
    "const char* {anonymous}::instance_name() [with auto Kernel = "
    "flash_fwd_mma_kernel<256, 0, 2>]":
        "flash_fwd_mma_kernel<256, kStd, kF32>",
    "no kernel here": "no kernel here",
}
# ptxas's mangled names of the D = 256 forward's, dQ's and dK/dV's kSplit
# and kF32 instances (and of the split pass, no mma kernel), as
# build_kernels reads them from its register and spill report
MANGLED = {
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf520flash_fwd_"
    "mma_kernelILi256ELi0ELi1EEEv14CUtensorMap_stS1_S1_S1_PfPviiifii":
        "flash_fwd_mma_kernel<256, kStd, kSplit>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf520flash_fwd_"
    "mma_kernelILi256ELi0ELi2EEEv14CUtensorMap_stS1_S1_S1_PfPviiifii":
        "flash_fwd_mma_kernel<256, kStd, kF32>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf519flash_dq_"
    "mma_kernelILi256ELi0ELi2EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_PfPK13__"
    "nv_bfloat16iiifiii": "flash_dq_mma_kernel<256, kStd, kF32>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf520flash_dkv_"
    "mma_kernelILi256ELi0ELi2EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfS3_PfS4_"
    "iiiifi": "flash_dkv_mma_kernel<256, kStd, kF32>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf519flash_dq_"
    "mma_kernelILi256ELi0ELi1EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_PfPK13__"
    "nv_bfloat16iiifii": "flash_dq_mma_kernel<256, kStd, kSplit>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf520flash_dkv_"
    "mma_kernelILi256ELi0ELi1EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfS3_PfS4_"
    "iiiifi": "flash_dkv_mma_kernel<256, kStd, kSplit>",
    "_ZN51_GLOBAL__N__5121eace_18_flash_attention_cu_837abbf518flash_split_"
    "kernelEPKfS1_S1_S1_iP13__nv_bfloat16iiii": None,
}


@pytest.mark.parametrize("pretty", sorted(PRETTY))
def test_instance_names(pretty):
    """The instance a launch reports, as the launch counts name it: the mma
    kernels' Form and Mode by name, the default Mode filled in."""
    assert fa.instance_name(pretty) == PRETTY[pretty]


@pytest.mark.parametrize("mangled", sorted(MANGLED))
def test_mangled_instance_names(mangled):
    """ptxas's name of an mma kernel instance spelled as the launch counts
    spell it (None for another kernel), so that chip_smoke.py can hold the
    D = 256 tensor-core instances to no spill and no serialized wgmma."""
    assert mma_instance(mangled) == MANGLED[mangled]
    assert (mma_instance(mangled) in D256_TC_INSTANCES) == (
        MANGLED[mangled] is not None)


def test_d256_instances_of_the_tensor_core_strategies():
    """chip_smoke.py requires at head_dim 256 the tensor-core instances of
    the forward, dQ and dK/dV of every strategy on both storages: on bf16
    storage the kBf16 ones of bf16, nn and nn2 and the kSplit ones of f32,
    on f32 storage the kF32 ones of every strategy; no CUDA-core kernel is
    left. reset_launch_counts clears the instance counts."""
    for impl in ("bf16", "nn", "nn2", "f32"):
        for name in fa.STRATEGY_KERNELS[impl]:
            kind = name.split("_")[1]
            for table in (D256_INSTANCES, D256_F32_INSTANCES):
                assert table[name].startswith(
                    f"flash_{kind}_mma_kernel<256, ")
    assert D256_INSTANCES["flash_dq"].endswith("kStd, kBf16>")
    assert D256_INSTANCES["flash_dq_nn"].endswith("kNN, kBf16>")
    assert D256_INSTANCES["flash_dkv_nn2"].endswith("kNN2, kBf16>")
    for name in fa.STRATEGY_KERNELS["f32"]:
        kind = name.split("_")[1]
        assert D256_INSTANCES[name] == (
            f"flash_{kind}_mma_kernel<256, kStd, kSplit>")
    assert set(D256_F32_INSTANCES) == set(D256_INSTANCES) == set(fa.CUDA)
    for name, inst in D256_F32_INSTANCES.items():
        kind = name.split("_")[1]
        assert inst == f"flash_{kind}_mma_kernel<256, kStd, kF32>"
    every = {*D256_INSTANCES.values(), *D256_F32_INSTANCES.values()}
    assert not any("_wide_kernel" in i for i in every)
    assert D256_TC_INSTANCES == every
    inst = D256_INSTANCES["flash_dq_f32dot"]
    assert is_instance(inst, "flash_dq_mma_kernel")
    assert not is_instance(inst, "flash_dq_mma_kernel<256, kStd, kBf16>")
    fa.INSTANCE_LAUNCHES["x"] = 1
    fa.reset_launch_counts()
    assert fa.INSTANCE_LAUNCHES == {}


# Why the forward scores a whole 128-key block before rounding P: the
# reference rounds P against the running max at its flash_block_k (128)
# boundaries, so with 128-key blocks O parts from it only where another
# order of f32 sums flips a rounding, while 64-key softmax steps round P
# against other maxima and move many more entries
SAME_BLOCK_SHARE, STEP64_SHARE = 0.01, 0.05


def test_block_max_rounding_is_the_references():
    """The share of O's entries that differ from the reference at all:
    under SAME_BLOCK_SHARE for the 128-key blocks, over STEP64_SHARE for
    64-key softmax steps (both still within one bf16 step)."""
    q, k, v, _ = _inputs()
    sc = 1.0 / math.sqrt(D)
    out, _ = _flash_fwd(_bh(q), _bh(k), _bh(v), sc, True, 128, 128, True,
                        "bf16")
    ref = _from_bh(out)
    shares = {}
    for block in (128, 64):
        diff = np.abs(model_fwd(q, k, v, True, sc, block=block)[0]
                      .float().numpy() - ref)
        assert diff.max() <= _bf16_step(ref), block
        shares[block] = float((diff > 0).mean())
    assert shares[128] <= SAME_BLOCK_SHARE, shares
    assert shares[64] > STEP64_SHARE, shares
