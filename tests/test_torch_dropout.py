"""Dropout of the port (nn.functional.dropout, dropout2d, dropout3d,
alpha_dropout, the dropout layers, and scaled_dot_product_attention's
dropout path) against the reference's, each side drawing its key from
its default generator after the same seed: outputs bitwise equal (the
masks are threefry float64 uniforms below 1 - p, and the arithmetic is
one product in the input's dtype), in f32 and bf16; the attention's
mask bitwise and its output within 1e-6 (the einsum and softmax around
the mask differ in the order of f32 sums). Also `core.rng.bernoulli`
against jax.random.bernoulli in chunks smaller than the mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import rng as jrng

import paddle_tpu_torch
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

SEED = 11


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (paddle_tpu.cast(paddle_tpu.to_tensor(x), dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _same(jout, tout):
    j = np.asarray(jout._data)
    t = tout.float().numpy() if tout.dtype == torch.bfloat16 \
        else tout.numpy()
    np.testing.assert_array_equal(t, j.astype(np.float32))


def _seed_both():
    paddle_tpu.seed(SEED)
    paddle_tpu_torch.seed(SEED)


CALLS = {
    "dropout": (lambda F, x: F.dropout(x, p=0.3), (4, 5, 6)),
    "dropout-p0.9": (lambda F, x: F.dropout(x, p=0.9), (64, 33)),
    "axis1": (lambda F, x: F.dropout(x, p=0.5, axis=1), (4, 5, 6)),
    "axis02": (lambda F, x: F.dropout(x, p=0.5, axis=[0, 2]), (4, 5, 6)),
    "downscale": (lambda F, x: F.dropout(x, p=0.25,
                                         mode="downscale_in_infer"),
                  (8, 9)),
    "downscale-infer": (lambda F, x: F.dropout(
        x, p=0.25, training=False, mode="downscale_in_infer"), (8, 9)),
    "eval": (lambda F, x: F.dropout(x, p=0.25, training=False), (8, 9)),
    "dropout2d": (lambda F, x: F.dropout2d(x, p=0.4), (2, 3, 4, 5)),
    "dropout2d-nhwc": (lambda F, x: F.dropout2d(x, p=0.4,
                                                data_format="NHWC"),
                       (2, 3, 4, 5)),
    "dropout3d": (lambda F, x: F.dropout3d(x, p=0.4), (2, 3, 2, 4, 5)),
    "alpha": (lambda F, x: F.alpha_dropout(x, p=0.2), (16, 17)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("call", list(CALLS))
def test_functional_dropout_bitwise(call, dtype):
    fn, shape = CALLS[call]
    jx, tx = _x(shape, dtype)
    _seed_both()
    for _ in range(2):              # two draws: the generators advance
        _same(fn(JF, jx), fn(TF, tx))
    assert trng.default_generator().get_state() == \
        jrng.default_generator().get_state()


@pytest.mark.parametrize("layer", ["Dropout", "Dropout2D", "AlphaDropout"])
def test_dropout_layers_bitwise(layer):
    jx, tx = _x((2, 3, 4, 5), "float32", seed=1)
    jl, tl = getattr(jnn, layer)(0.3), getattr(tnn, layer)(0.3)
    _seed_both()
    _same(jl(jx), tl(tx))
    jl.eval()
    tl.eval()
    _same(jl(jx), tl(tx))
    assert torch.equal(tl(tx), tx)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_dropout_matches_reference(causal):
    """The attention's dropout path: the mask of the key it draws equals
    the reference's bitwise, the output agrees within 1e-6, and flash is
    never taken (the reference's routing)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    _seed_both()
    want = JF.scaled_dot_product_attention(
        *(paddle_tpu.to_tensor(a) for a in (q, k, v)), dropout_p=0.2,
        is_causal=causal).numpy()
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=0.2,
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the key either side drew: fold_in(key(SEED), 1)
    key = trng.fold_in(trng.key(SEED), 1)
    jkey = jax.random.fold_in(jax.random.key(SEED), 1)
    np.testing.assert_array_equal(
        trng.bernoulli(key, 0.8, (2, 4, 32, 32)).numpy(),
        np.asarray(jax.random.bernoulli(jkey, 0.8, (2, 4, 32, 32))))
    # out of training, or at p = 0: no key drawn, the deterministic path
    state = trng.default_generator().get_state()
    TF.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    dropout_p=0.2, training=False)
    assert trng.default_generator().get_state() == state


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_bernoulli_chunks_match_jax(p):
    key = trng.fold_in(trng.key(5), 3)
    jkey = jax.random.fold_in(jax.random.key(5), 3)
    want = np.asarray(jax.random.bernoulli(jkey, 1.0 - p, (3, 7, 129)))
    for chunk in (64, 1000, 1 << 24):
        got = trng.bernoulli(key, 1.0 - p, (3, 7, 129), chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)


def test_rng_key_scope_and_set_key():
    """set_key replaces the base key and resets the counter (the
    reference's); rng_key_scope rebases the default generator for a block
    and puts its key and counter back."""
    paddle_tpu_torch.seed(3)
    trng.next_key()
    before = trng.default_generator().get_state()
    k = trng.fold_in(trng.key(9), 4)
    with trng.rng_key_scope(k):
        inner = [trng.next_key() for _ in range(2)]
    assert trng.default_generator().get_state() == before
    assert torch.equal(inner[0], trng.fold_in(k, 1))
    assert torch.equal(inner[1], trng.fold_in(k, 2))
    jk = jax.random.fold_in(jax.random.key(9), 4)
    with jrng.rng_key_scope(jk):
        jinner = jrng.next_key()
    np.testing.assert_array_equal(inner[0].numpy(),
                                  np.asarray(jax.random.key_data(jinner)))
    assert torch.equal(trng.next_key(), trng.fold_in(trng.key(3), 2))
