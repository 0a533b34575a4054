"""Head_dims and lengths that the reference's gate admits but the port's
CUDA kernels do not take as they are (head_dim 64, 128 or 256, L a
multiple of 64), run through the padding of
paddle_tpu_torch/ops/flash_attention.py on the CPU.

`padded_fwd` and `padded_bwd` zero-pad q, k, v and dO up to the kernels'
shape, mask the keys past the true length, and cut the outputs back. Here
they run the kernels' plain versions: O, LSE, dQ, dK and dV are held
against the plain versions at the true shape and against the reference's
Pallas kernels in interpret mode (head_dims 160 and 256, which take the
D = 256 kernels, in bf16 and f32 under every strategy). With the device
test and the launch stubbed (as in tests/test_torch_kernel_shapes.py),
every preset's head_dim, and head_dims 160, 192 and 256, reach CUDA
wrappers whose shape checks accept them."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd

from paddle_tpu_torch.models import PRESETS
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# Padding adds zero columns (exact zeros in every score) and masked keys,
# so the padded flash equals the plain version at the true shape up to the
# order of f32 sums.
PADDED_ATOL = 1e-6
# f32 tolerances of tests/test_torch_flash_attention.py against the
# reference in interpret mode: atol 2e-5 on O and LSE, 2e-4 of the
# largest gradient on each gradient.
REF_ATOL, REF_GRAD_REL = 2e-5, 2e-4
# bf16 inputs, tests/test_torch_dot_strategies.py's limits against the
# reference in interpret mode: every output within one bf16 step of its
# largest magnitude, and no larger a share of entries apart than this
# (the two round P and dS against different row maxima; strategy f32
# rounds only the outputs, so only the order of f32 sums differs).
BF16_SHARE = {"f32": 0.01, "bf16": 0.25, "nn": 0.25, "nn2": 0.25}

# (B, L, H, D, causal, block): gpt3-tiny's head_dim 16, gpt3-large's 96,
# L = 96 with blocks of 32 (the gate admits it; the kernels take it padded
# to 128, the keys past 96 masked), causal and not, and head_dims 160
# (padded to 256) and 256 (as it is), the D = 256 kernels'
CASES = {
    "D16": (1, 128, 2, 16, True, 64),
    "D96": (1, 128, 2, 96, True, 64),
    "L96-causal": (1, 96, 2, 64, True, 32),
    "L96-noncausal": (1, 96, 2, 64, False, 32),
    "D160": (1, 128, 2, 160, True, 64),
    "D256": (1, 128, 2, 256, True, 64),
}
# the (L, head_dim) the kernels take each case at
KERNEL_SHAPES = {"D16": (128, 64), "D96": (128, 128),
                 "L96-causal": (128, 64), "L96-noncausal": (128, 64),
                 "D160": (128, 256), "D256": (128, 256)}
# (case, dtype, strategy): the cases up to D = 128 in f32 under strategy
# bf16; the D = 256 kernels' cases in both dtypes under every strategy
PADDED_CASES = (
    [pytest.param(c, "float32", "bf16", id=c)
     for c in ("D16", "D96", "L96-causal", "L96-noncausal")]
    + [pytest.param(c, dt, impl, id=f"{c}-{dt}-{impl}")
       for c in ("D160", "D256") for dt in ("float32", "bfloat16")
       for impl in ("bf16", "nn", "nn2", "f32")])


def _inputs(B, L, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


def _padded(q, k, v, do, causal, sc, impl="bf16"):
    o, lse, saved = fa.padded_fwd(q, k, v, causal, sc, impl)
    return (o, lse, *fa.padded_bwd(saved, do, causal, sc, impl))


def _bf16_step(x):
    """One bf16 step (2^-7 of the leading power of two) at x's largest
    magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("case,dtype,impl", PADDED_CASES)
def test_padded_matches_plain_and_reference(case, dtype, impl):
    B, L, H, D, causal, block = CASES[case]
    assert fa.flash_attention_supported((B, L, H, D), D, causal, block,
                                        block)
    assert fa.kernel_shape(L, D) == KERNEL_SHAPES[case]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt)
                       for x in _inputs(B, L, H, D))
    sc = 1.0 / math.sqrt(D)
    got = _padded(tq, tk, tv, tdo, causal, sc, impl)
    names = ("O", "LSE", "dQ", "dK", "dV")
    shapes = [(B, L, H, D), (B, H, L)] + [(B, L, H, D)] * 3
    for n, x, shape in zip(names, got, shapes):
        assert tuple(x.shape) == shape and x.is_contiguous(), n

    f32_dots = impl == "f32"
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal, sc, f32_dots)
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    want = (o, lse, *fa.flash_bwd_plain(tq, tk, tv, tdo, lse, delta, causal,
                                        sc, f32_dots))
    for n, x, y in zip(names, got, want):
        assert float((x.float() - y.float()).abs().max()) <= PADDED_ATOL, n

    jdt = getattr(jnp, dtype)

    def bh(x):
        return jnp.swapaxes(jnp.asarray(x.float().numpy(), jdt), 1,
                            2).reshape(B * H, L, D)

    def from_bh(x):
        return np.swapaxes(np.asarray(x, np.float32).reshape(B, H, L, D), 1,
                           2)

    out, res = _flash_fwd(bh(tq), bh(tk), bh(tv), sc, causal, block, block,
                          True, impl)
    ref_grads = _flash_bwd(sc, causal, block, block, True, impl, res,
                           bh(tdo))
    np.testing.assert_allclose(got[1].numpy(),
                               np.asarray(res[4]).reshape(B, H, L),
                               atol=REF_ATOL)
    for n, mine, ref in zip(names[:1] + names[2:], got[:1] + got[2:],
                            (out, *ref_grads)):
        mine, ref = mine.float().numpy(), from_bh(ref)
        diff = np.abs(mine - ref)
        if dtype == "float32":
            limit = (REF_ATOL if n == "O"
                     else REF_GRAD_REL * (np.abs(ref).max() + 1e-9))
            assert diff.max() <= limit, (n, diff.max())
        else:
            assert diff.max() <= _bf16_step(ref), (n, diff.max())
            assert (diff > 0).mean() <= BF16_SHARE[impl], n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_pads(dtype):
    """flash_attention (its autograd.Function) at head_dim 96 gives
    padded_fwd's O and padded_bwd's gradients exactly."""
    B, L, H, D, causal, block = CASES["D96"]
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(B, L, H, D, seed=1))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qr, kr, vr, causal=causal, block_q=block,
                             block_k=block)
    out.backward(do)
    sc = 1.0 / math.sqrt(D)
    want = _padded(q, k, v, do, causal, sc)
    assert torch.equal(out.detach(), want[0])
    for got, w in zip((qr.grad, kr.grad, vr.grad), want[2:]):
        assert got.dtype == dtype and torch.equal(got, w)


@pytest.fixture
def stubbed(monkeypatch):
    """CPU tensors routed to the CUDA wrappers, whose shape checks run; the
    device test and the launch are stubs that record each launch's name and
    options."""
    calls = []
    monkeypatch.setattr(fa, "_check_device", lambda name, q: None)
    monkeypatch.setattr(
        fa, "_launch",
        lambda name, ptrs, q, causal, sc, **opts: calls.append(
            (name, tuple(q.shape), opts)))
    monkeypatch.setattr(fa, "kernel", lambda name, on: fa.CUDA[name])
    return calls


PRESET_DIMS = sorted({c.hidden_size // c.num_heads for c in PRESETS.values()})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", PRESET_DIMS)
def test_every_preset_head_dim_reaches_a_kernel(stubbed, head_dim, dtype):
    """Each preset's head_dim passes the gate and, padded, reaches the
    forward, dQ and dK/dV wrappers, whose checks accept it; the launches
    see the padded head_dim."""
    B, L, H = 1, 128, 2
    assert fa.flash_attention_supported((B, L, H, head_dim), head_dim, True)
    q, k, v = (torch.zeros(B, L, H, head_dim, dtype=dtype,
                           requires_grad=True) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True, impl="bf16")
    out.backward(torch.ones_like(out))
    padded = (B, L, H, fa.kernel_shape(L, head_dim)[1])
    assert [c[:2] for c in stubbed] == [("flash_fwd", padded),
                                        ("flash_dq", padded),
                                        ("flash_dkv", padded)]
    assert all(c[2] == {} for c in stubbed)     # nothing masked
    assert q.grad.shape == q.shape and out.shape == q.shape


@pytest.mark.parametrize("impl", ["bf16", "nn", "nn2", "f32"])
def test_padded_length_reaches_masked_kernels(stubbed, impl):
    """L = 96 (blocks of 32) reaches every strategy's kernels at L = 128,
    the forward and dQ told the true key count."""
    q, k, v = (torch.zeros(1, 96, 2, 64, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=False, block_q=32, block_k=32,
                             impl=impl)
    out.backward(torch.ones_like(out))
    names = fa.STRATEGY_KERNELS[impl]
    assert [c[0] for c in stubbed] == list(names)
    assert all(c[1] == (1, 128, 2, 64) for c in stubbed)
    assert [c[2] for c in stubbed] == [{"kv_len": 96}, {"kv_len": 96}, {}]
    assert q.grad.shape == (1, 96, 2, 64)


def test_wrapper_refuses_a_bad_key_count(stubbed):
    """kv_len outside 1 .. L raises before any launch."""
    t = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    for bad in (0, 129):
        with pytest.raises(ValueError, match="kv_len"):
            fa.flash_fwd_cuda(t, t, t, False, 0.125, kv_len=bad)
    assert stubbed == []


@pytest.mark.parametrize("impl", ["bf16", "nn", "nn2", "f32"])
@pytest.mark.parametrize("head_dim", [160, 192, 256])
def test_large_head_dims_reach_d256_kernels(stubbed, head_dim, impl):
    """Head_dims in (128, 256] reach every strategy's forward, dQ and dK/dV
    wrappers at D = 256 (zero-padded below it), which accept them."""
    B, L, H = 1, 128, 2
    assert fa.flash_attention_supported((B, L, H, head_dim), head_dim, True)
    q, k, v = (torch.zeros(B, L, H, head_dim, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True, impl=impl)
    out.backward(torch.ones_like(out))
    assert [c[:2] for c in stubbed] == [
        (name, (B, L, H, 256)) for name in fa.STRATEGY_KERNELS[impl]]
    assert q.grad.shape == q.shape and out.shape == q.shape
