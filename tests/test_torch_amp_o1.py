"""auto_cast O1 and GradScaler of the port (paddle_tpu_torch/amp) against
the reference's, on the 2-layer narrow GPT of test_torch_trainer.py with
f32 parameters and dropout 0: the lists and their custom additions; the
dtypes each op of the GPT path runs in under O1 (Linear in bf16,
LayerNorm and the residual stream in f32, as the reference's lists and
promotion give); three eager steps of `scaler.scale(loss).backward()`,
`scaler.step(optimizer)` against the reference's, with the scaler's state
after each; and a step whose grads are not finite, which updates nothing
and halves the scale in both.

Tolerance: losses within 2e-3 relative (as the O2 steps of
test_torch_train_step.py: the Linears and attention run in bf16, whose
roundings the two packages place differently, each 2^-9 relative);
after 3 SGD steps (Adam would turn a grad's rounding noise into a whole
step) weight matrices within 2e-3 of their tensor's largest element and
vectors (biases, LayerNorm scales) within 2e-2: a bias's gradient sums
per-token grads rounded to bf16, with cancellation (measured up to 1.3%
here); the scaler's state exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework_io import params_from_paddle_tpu

from test_torch_trainer import (_batches, _jloss, _models, _tloss)

torch.set_num_threads(1)

LOSS_RTOL, MATRIX_REL, VECTOR_REL, LR = 2e-3, 2e-3, 2e-2, 0.5


def test_lists_match_reference():
    assert amp.white_list() == jamp.white_list()
    assert amp.black_list() == jamp.black_list()
    with amp.auto_cast(custom_white_list={"gelu"},
                       custom_black_list={"softmax"}), \
            jamp.auto_cast(custom_white_list={"gelu"},
                           custom_black_list={"softmax"}):
        assert amp.white_list() == jamp.white_list() >= {"gelu"}
        assert amp.black_list() == jamp.black_list() >= {"softmax"}
    assert "gelu" not in amp.white_list() | jamp.white_list()
    assert "softmax" not in amp.black_list() | jamp.black_list()


def test_o1_dtypes_on_the_gpt_path():
    """Under O1 the port's Linears give bf16, its LayerNorms f32, and the
    blocks' residual stream stays f32; outside it everything is f32."""
    _, tm = _models(dropout=0.0)
    seen = {}

    def hook(name):
        def record(mod, args, out):
            seen.setdefault(name, out.dtype)
        return record

    blk = tm.gpt.blocks[0]
    for name, mod in (("qkv", blk.attn.qkv_proj), ("fc2", blk.mlp.fc2),
                      ("ln1", blk.ln1), ("block", blk),
                      ("ln_f", tm.gpt.ln_f)):
        mod.register_forward_hook(hook(name))
    ids = torch.as_tensor(_batches(1)[0][0])
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        logits = tm(ids)
    assert seen == {"qkv": torch.bfloat16, "fc2": torch.bfloat16,
                    "ln1": torch.float32, "block": torch.float32,
                    "ln_f": torch.float32}
    assert logits.dtype == torch.bfloat16        # the tied head's matmul
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    seen.clear()
    assert tm(ids).dtype == torch.float32 and set(seen.values()) == {
        torch.float32}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _ref_step(jm, jo, scaler, batch, poison=False):
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        loss = _jloss(jm, *(paddle_tpu.to_tensor(x) for x in batch))
    scaler.scale(loss).backward()
    if poison:
        p = jo._parameter_list[0]
        p._grad = Tensor(p._grad._data * jnp.float32(float("inf")))
    scaler.step(jo)
    jo.clear_grad()
    return float(loss.numpy())


def _port_step(tm, to, scaler, batch, poison=False):
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = _tloss(tm, *(torch.as_tensor(x) for x in batch))
    scaler.scale(loss).backward()
    if poison:
        to._parameter_list[0].grad.mul_(float("inf"))
    scaler.step(to)
    to.clear_grad()
    return float(loss.detach())


@pytest.mark.parametrize("poison_step", [None, 2])
def test_o1_grad_scaler_steps_match_reference(poison_step):
    jm, tm = _models(dropout=0.0)
    jo = jopt.SGD(LR, parameters=jm.parameters(), weight_decay=0.01)
    to = topt.SGD(LR, parameters=tm.parameters(), weight_decay=0.01)
    js, ts = jamp.GradScaler(), amp.GradScaler()
    before = None
    for i, b in enumerate(_batches(3), start=1):
        poison = i == poison_step
        if poison:
            before = [p.detach().clone() for p in tm.parameters()]
        jl = _ref_step(jm, jo, js, b, poison)
        tl = _port_step(tm, to, ts, b, poison)
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
        assert ts.state_dict() == js.state_dict(), i
        if poison:
            assert ts._found_inf and js._found_inf
            assert all(torch.equal(p, q) for p, q in
                       zip(tm.parameters(), before))
    want = {"scale": 2.0 ** 16, "good_steps": 3, "bad_steps": 0}
    if poison_step:
        want = {"scale": 2.0 ** 15, "good_steps": 1, "bad_steps": 0}
    assert ts.state_dict() == want
    assert float(ts.get_loss_scaling()) == want["scale"]
    want_p = params_from_paddle_tpu(
        {n: np.asarray(q._data) for n, q in jm.named_parameters()})
    for n, p in tm.named_parameters():
        err = _rel(p.detach().numpy(), want_p[n].numpy())
        assert err <= (MATRIX_REL if p.dim() > 1 else VECTOR_REL), (n, err)


def test_minimize_and_disabled_scaler():
    """minimize = scale's backward, step, clear_grad; a disabled scaler
    passes the loss through and always steps."""
    _, tm = _models(dropout=0.0)
    to = topt.SGD(LR, parameters=tm.parameters())
    s = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=1)
    b = [torch.as_tensor(x) for x in _batches(1)[0]]
    loss = _tloss(tm, *b)
    s.minimize(to, s.scale(loss))
    assert s.state_dict() == {"scale": 16.0, "good_steps": 0,
                              "bad_steps": 0}
    assert all(p.grad is None for p in tm.parameters())
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
