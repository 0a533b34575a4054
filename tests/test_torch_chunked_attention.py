"""The chunked query scan (`nn.functional._chunked_attention`, the
reference's `_chunked_attention`): the port's against the reference's on
the same inputs, outputs and input gradients, causal and not, f32 and
bf16; and the routing of scaled_dot_product_attention with flash off at
L >= 1024 (chunked when L is a multiple of FLAGS_attention_chunk above
it, the full einsum with the flag at 0), against the reference's sdpa.

Tolerance: f32 within 2e-6 of each tensor's largest element (the order
of f32 sums); bf16 within 2e-2 (the probabilities and outputs rounded to
bf16, 2^-8 relative, where the two packages' f32 sums round apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.flags import set_flags as jax_set_flags

from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_reference(causal, dtype):
    B, H, L, D, chunk = 2, 3, 256, 16, 64
    q, k, v, g = _inputs((B, H, L, D), dtype)
    s = 1.0 / np.sqrt(D)
    jd = getattr(jnp, dtype)
    out, vjp = jax.vjp(
        lambda a, b, c: JF._chunked_attention(a, b, c, causal,
                                              jnp.float32(s), chunk),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    g = g.transpose(0, 2, 1, 3)              # the output is [B, L, H, D]
    jgrads = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    before = TF.CHUNKED_CALLS["chunks"]
    tout = TF._chunked_attention(tq, tk, tv, causal,
                                 float(np.float32(s)), chunk)
    assert TF.CHUNKED_CALLS["chunks"] - before == L // chunk
    tout.backward(torch.from_numpy(np.ascontiguousarray(g)).to(td))
    assert tout.dtype == td
    assert _rel(tout.detach().float(), np.asarray(out, np.float32)) \
        <= TOL[dtype]
    for t, j in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad.float(), np.asarray(j, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("chunk", [256, 0])
def test_sdpa_routes_to_chunks_with_flash_off(chunk):
    """With flash off at L = 1024: attention_chunk 256 runs 4 chunks,
    0 the full einsum; both agree with the reference's sdpa (flash off,
    the same chunk flag) and with each other."""
    q, k, v, _ = _inputs((1, 1024, 2, 16), "float32", seed=1)
    set_flags({"use_flash_attention": False, "attention_chunk": chunk})
    jax_set_flags({"use_flash_attention": False, "attention_chunk": chunk})
    try:
        before = TF.CHUNKED_CALLS["chunks"]
        got = TF.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
        assert TF.CHUNKED_CALLS["chunks"] - before == (4 if chunk else 0)
        want = JF.scaled_dot_product_attention(
            *(paddle_tpu.to_tensor(x) for x in (q, k, v)),
            is_causal=True).numpy()
    finally:
        set_flags({"use_flash_attention": True, "attention_chunk": 256})
        jax_set_flags({"use_flash_attention": True, "attention_chunk": 256})
    assert _rel(got.numpy(), want) <= TOL["float32"]
    full = TF._attention_probs(*(torch.from_numpy(x) for x in (q, k, v)),
                               None, True, None)
    full = torch.einsum("bhqk,bhkd->bhqd", *full).transpose(1, 2)
    assert _rel(got.numpy(), full.numpy()) <= TOL["float32"]
