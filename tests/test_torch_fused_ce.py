"""The port's fused LM-head cross-entropy
(paddle_tpu_torch/nn/functional_more.py) on bf16 operands, against the
reference's `fused_linear_cross_entropy` (its `_fused_linear_ce_p`, run by
JAX on the CPU) on the same bf16 values: the loss and the gradients of the
hidden states and the weight.

On a card the port forms the logits with one bf16 GEMM with f32 output and
the gradients from dlogits split into three bf16 terms (bf16 GEMMs with f32
output); on the CPU, which has no kernel for a bf16 GEMM with f32 output,
the same products run as f32 GEMMs of the same bf16 values. So the CPU
holds the function the card computes: the reference's, whose bf16 dot
with preferred_element_type=f32 has the same exact products."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional_more import _fused_linear_ce_p

from paddle_tpu_torch.nn import functional_more as fm

torch.set_num_threads(1)

T, H, V = 300, 64, 512
CHUNK = 128              # 300 tokens: a ragged last chunk
# The loss sums f32 logsumexps of exact products in another order: rtol of
# tests/test_torch_gpt.py. The gradients are rounded to bf16 once, from f32
# sums in another order: within one bf16 step of the largest element (the
# bound tests/test_torch_train_step.py holds the LayerNorm's gradient to).
LOSS_RTOL = 1e-5


def _operands(transpose_y, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, H)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, H) if transpose_y else (H, V))
         ).astype(np.float32)
    y = rng.integers(0, V, T)
    y[:11] = -100                # ignored tokens
    h, w = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in (h, w))
    return h, w, y


def _one_bf16_step(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("transpose_y", [True, False])
def test_bf16_ce_matches_reference(transpose_y):
    h, w, y = _operands(transpose_y)
    loss, vjp = jax.vjp(
        lambda a, b: _fused_linear_ce_p._pure_fn(
            a, b, jnp.asarray(y), transpose_y=transpose_y, chunk=CHUNK,
            ignore_index=-100),
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    jdh, jdw = (np.asarray(g.astype(jnp.float32))
                for g in vjp(jnp.float32(1.0)))

    th, tw = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (h, w))
    tloss = fm.fused_linear_cross_entropy(th, tw, torch.from_numpy(y),
                                          transpose_y=transpose_y,
                                          chunk=CHUNK)
    tloss.backward()
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=LOSS_RTOL)
    for got, want in ((th.grad, jdh), (tw.grad, jdw)):
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - want).max()
        assert diff <= _one_bf16_step(want)


def test_bf16_gradients_hold_the_split_products():
    """The bf16 backward's gradients are the exact products of f32 dlogits
    and the bf16 operands, rounded once: within one bf16 step of an f64
    product of the same dlogits, and closer to it than gradients from
    dlogits rounded to bf16 first."""
    h, w, y = _operands(True, seed=1)
    th, tw = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (h, w))
    ty = torch.from_numpy(y)
    total, _ = fm._ChunkCE.apply(th, tw, ty, True, -100)
    grads = torch.autograd.grad(total, (th, tw))
    h64, w64 = torch.from_numpy(h).double(), torch.from_numpy(w).double()
    p = torch.softmax(h64 @ w64.t(), -1)
    p[torch.arange(T), ty.clamp(min=0)] -= 1
    dl = (p * (ty != -100)[:, None]).float().double()
    rounded = dl.to(torch.bfloat16).double()
    for got, ref, first in ((grads[0], dl @ w64, rounded @ w64),
                            (grads[1], dl.t() @ h64, rounded.t() @ h64)):
        err = (got.double() - ref).abs().max()
        assert err <= _one_bf16_step(ref.numpy())
        assert (first.to(torch.bfloat16).double() - ref).abs().max() > err


def test_split3_rebuilds_f32_bitwise():
    """lo + mid + hi rebuild dlogits' f32 values bitwise (signed, 2^-100
    to 2^10), small terms first in the [3, ...] result."""
    rng = np.random.RandomState(2)
    x = (rng.uniform(1, 2, 4096) * 2.0 ** rng.randint(-100, 11, 4096)
         * rng.choice([-1.0, 1.0], 4096)).astype(np.float32)
    t = fm._split3(torch.from_numpy(x.copy()))
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4096)
    back = t[2].float() + t[1].float() + t[0].float()
    assert torch.equal(back, torch.from_numpy(x))
    assert (t[0].float().abs() <= t[2].float().abs()).all()

