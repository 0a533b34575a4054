"""Three AdamW TrainStep steps of the port (paddle_tpu_torch/jit,
optimizer, amp) against paddle_tpu.jit.TrainStep on the same weights and
batch: losses, Adam moments and parameters, in f32 and in bf16 O2 with
f32 master weights; and the port's LayerNorm against the reference's in
bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.nn.functional import _layer_norm_p as _jax_layer_norm
from paddle_tpu.nn.functional_more import \
    fused_linear_cross_entropy as jax_fused_ce

from paddle_tpu_torch import amp
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional_more import fused_linear_cross_entropy
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

VOCAB, SEQ, BATCH, STEPS, LR = 256, 128, 2, 3, 1e-3
# Adam normalises each update: an element whose gradient is near zero
# moves by about lr in the direction of its gradient's sign, whatever the
# gradient's size, so where the two packages' sums round that sign
# differently a parameter may part by up to 2*lr per step. The key part of
# the QKV bias has an exact gradient of zero (softmax ignores a constant
# added to a row's scores), so its elements all take that path: the share
# of parameters that must agree closely is counted over the whole model.
PARAM_ATOL = 2 * LR * STEPS
TOL = {
    # f32: the packages differ in the order of f32 sums only
    "float32": {"loss_rtol": 1e-5, "moment_rel": 1e-4, "param_close": 1e-5,
                "close_share": 0.99},
    # bf16 O2: activations and grads carry 8 significant bits; after three
    # steps every moment, the LayerNorms' included, lies within 5% of its
    # largest element. (Before the port's LayerNorm took the reference's
    # arithmetic, its leaves parted by up to 12.5%.)
    "bfloat16": {"loss_rtol": 2e-3, "moment_rel": 0.05, "param_close": 1e-3,
                 "close_share": 0.95},
}
CASES = [*TOL, "bfloat16-reference-ln"]


def _weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    m = GPTForCausalLM(cfg)
    named = {}
    for n, p in m.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
        named[n] = x
    return m, named


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _layer_norm_matches_reference():
    """The LayerNorm those steps run, against the reference's
    `_layer_norm_p` on bf16 inputs at the model's width: the output
    bitwise (mean and variance reduced in f32 and rounded to bf16, the
    normalisation in bf16), where torch's own layer_norm, which works in
    f32 and rounds only its output, is not; the input gradient within one
    bf16 step of its largest element (the port's backward rounds g * weight
    as the reference's autodiff does and computes the rest in f32, where
    the reference rounds its intermediate sums to bf16); and what the
    backward keeps: x, the rounded mean and 1/std, the weight and the bias,
    all bf16, no f32 copy of x."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((BATCH, SEQ, 128)) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.02 * rng.standard_normal(128)).astype(np.float32)
    g = rng.standard_normal((BATCH, SEQ, 128)).astype(np.float32)
    jout, vjp = jax.vjp(
        lambda *a: _jax_layer_norm._pure_fn(*a, epsilon=1e-5),
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)))
    jdx = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], np.float32)
    jout = np.asarray(jout, np.float32)

    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    tx.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = TF.layer_norm(tx, 128, tw, tb, 1e-5)
    assert [tuple(t.shape) for t in saved] == [
        (BATCH, SEQ, 128), (BATCH, SEQ, 1), (BATCH, SEQ, 1), (128,), (128,)]
    assert all(t.dtype == torch.bfloat16 for t in saved)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(out.detach().float().numpy(), jout)
    builtin = torch.nn.functional.layer_norm(tx.detach(), (128,), tw, tb,
                                             1e-5)
    assert not np.array_equal(builtin.float().numpy(), jout)
    step = 2.0 ** (np.floor(np.log2(np.abs(jdx).max())) - 7)
    assert np.abs(tx.grad.float().numpy() - jdx).max() <= step


@pytest.mark.parametrize("case", CASES)
def test_adamw_train_steps_match_reference(case):
    """Losses, Adam moments and parameters after STEPS steps, in f32 and in
    bf16 O2; the "bfloat16-reference-ln" case holds the LayerNorm that the
    bf16 steps run against the reference's arithmetic."""
    if case == "bfloat16-reference-ln":
        _layer_norm_matches_reference()
        return
    tol = TOL[case]
    dtype = case
    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                    num_heads=8, max_seq_len=SEQ)
    jm, named = _weights(cfg)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=8,
        max_seq_len=SEQ), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(named))
    if dtype == "bfloat16":
        jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
        tm = amp.decorate(tm, level="O2", dtype="bfloat16")

    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)

    jstep = JTrainStep(
        jm, jopt.AdamW(LR, parameters=jm.parameters(), weight_decay=0.01,
                       multi_precision=True),
        lambda m, i, y: jax_fused_ce(m.gpt(i), m.gpt.wte.weight, y,
                                     transpose_y=True, chunk=128))
    topt = AdamW(LR, parameters=tm.parameters(), weight_decay=0.01,
                 multi_precision=True)
    tstep = TrainStep(
        tm, topt,
        lambda m, i, y: fused_linear_cross_entropy(
            m.hidden(i), m.head_weight(), y, transpose_y=True, chunk=128))

    jl = [float(np.asarray(jstep(ids, labels).numpy())) for _ in range(STEPS)]
    tl = [float(tstep(ids, labels)) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=tol["loss_rtol"])
    assert tl[-1] < tl[0]

    jstate = jstep._opt_state[0]
    tparams = dict(tm.named_parameters())
    for key in ("moment1", "moment2", "master"):
        if key == "master" and dtype == "float32":
            continue        # no f32 master for an f32 parameter
        want = params_from_paddle_tpu(
            {n: np.asarray(s[key]) for n, s in jstate.items()})
        for n, w in want.items():
            got = topt.state[tparams[n]][key].numpy()
            w = w.numpy()
            if key == "master":
                assert np.abs(got - w).max() <= PARAM_ATOL, n
            else:
                assert _rel(got, w) < tol["moment_rel"], (key, n,
                                                          _rel(got, w))
        if dtype == "float32":
            assert "master" not in topt.state[tparams[n]]

    want = params_from_paddle_tpu(
        {n: np.asarray(v, np.float32) for n, v in jstep._params.items()})
    diffs = []
    for n, p in tparams.items():
        assert p.dtype == getattr(torch, dtype)
        diff = np.abs(p.detach().float().numpy() - want[n].numpy())
        assert diff.max() <= PARAM_ATOL, n
        diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert (diffs <= tol["param_close"]).mean() >= tol["close_share"]
