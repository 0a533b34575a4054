"""The port's trainer (jit.TrainStep with dropout, accumulation,
skip-bad-steps and FLAGS_check_nan_inf; EvalStep) against the
reference's on a 2-layer narrow GPT with dropout 0.1, the same weights
and batches, and the reference generator's (seed, counter) copied into
the port's before step 1, so that both draw the same step keys and
dropout masks: 3 steps of AdamW under LinearWarmup(CosineAnnealingDecay),
ClipGradByGlobalNorm and a decay gate that spares biases and LayerNorms.

Tolerance, f32: losses within 1e-5 relative; every parameter within 1e-5
of its tensor's largest element, except the key third of the QKV bias,
whose gradient is zero in exact arithmetic (a constant added to a row of
scores leaves its softmax, and so the loss, unchanged): there each
package's Adam normalises f32 noise, moving an element by up to lr a
step in the noise's direction, so it is held to 2 * lr * steps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.core import rng as jrng
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.jit import EvalStep as JEvalStep
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.nn.functional_more import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.testing import chaos as jchaos

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional_more import fused_linear_cross_entropy
from paddle_tpu_torch.testing import chaos as tchaos

torch.set_num_threads(1)

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 256, 64, 2, 4, 64, 2
STEPS, LR = 3, 1e-3
LOSS_RTOL, PARAM_REL = 1e-5, 1e-5
KBIAS_ATOL = 2 * LR * STEPS
CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
           num_heads=HEADS, max_seq_len=SEQ)


def _decay_gate(name):
    return "bias" not in name and ".ln" not in name


def _models(dropout=0.1, seed=7):
    """The reference model with seeded weights, and the port's with the
    same; the port generator takes the reference's state."""
    paddle_tpu.seed(seed)
    jm = GPTForCausalLM(GPTConfig(dropout=dropout, **CFG))
    rng = np.random.default_rng(0)
    named = {}
    for n, p in jm.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        x *= np.float32(0.02 if n.endswith("bias") else 0.1)
        if ".ln" in n and n.endswith("weight"):
            x += np.float32(1)
        p.set_value(x)
        named[n] = x
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(dropout=dropout, **CFG),
                             device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(named))
    trng.default_generator().set_state(jrng.default_generator().get_state())
    return jm, tm


def _optimizers(jm, tm, clip=True):
    def sched(mod):
        return mod.lr.LinearWarmup(
            mod.lr.CosineAnnealingDecay(LR, T_max=4), warmup_steps=2,
            start_lr=0.0, end_lr=LR)

    kw = {"weight_decay": 0.01, "apply_decay_param_fun": _decay_gate}
    jo = jopt.AdamW(sched(jopt), parameters=jm.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(0.5) if clip
                    else None, **kw)
    to = topt.AdamW(sched(topt), parameters=tm.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(0.5) if clip
                    else None, **kw)
    return jo, to


def _batches(n):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
        out.append((ids, np.roll(ids, -1, axis=1),
                    np.ones((BATCH, SEQ), np.float32)))
    return out


def _jloss(m, ids, labels, w):
    return jax_fused_ce(m.gpt(ids), m.gpt.wte.weight, labels,
                        transpose_y=True, chunk=64) * w.mean()


def _tloss(m, ids, labels, w):
    return fused_linear_cross_entropy(m.hidden(ids), m.head_weight(),
                                      labels, transpose_y=True,
                                      chunk=64) * w.mean()


def _compare_params(jstep, tm):
    want = params_from_paddle_tpu(
        {n: np.asarray(v, np.float32) for n, v in jstep._params.items()})
    for n, p in tm.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        if n.endswith("qkv_proj.bias"):
            kpart = slice(HIDDEN, 2 * HIDDEN)
            assert np.abs(got[kpart] - w[kpart]).max() <= KBIAS_ATOL, n
            got, w = np.delete(got, kpart), np.delete(w, kpart)
        err = np.abs(got - w).max() / np.abs(w).max()
        assert err <= PARAM_REL, (n, err)


@pytest.fixture
def chaos_spec():
    """Arms both packages' chaos harness with one spec; disarms after."""
    def arm(spec):
        jchaos.configure(spec)
        tchaos.configure(spec)

    yield arm
    jchaos.reset()
    tchaos.reset()


CASES = {
    # name: (accumulate_steps, skip_bad_steps, chaos spec, calls)
    "dropout": (1, False, "", STEPS),
    "accumulate": (2, False, "", 2 * STEPS),
    "skip-bad": (1, True, "step:nan:2", STEPS),
    "accumulate-skip-micro": (2, True, "step:nan:3", 2 * STEPS),
    "accumulate-skip-window": (2, True, "step:nan:3;step:nan:4",
                               2 * STEPS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_reference(case, chaos_spec):
    acc, skip, spec, calls = CASES[case]
    jm, tm = _models()
    jo, to = _optimizers(jm, tm)
    jstep = JTrainStep(jm, jo, _jloss, accumulate_steps=acc,
                       skip_bad_steps=skip)
    tstep = TrainStep(tm, to, _tloss, accumulate_steps=acc,
                      skip_bad_steps=skip)
    batches = _batches(calls)
    chaos_spec(spec)
    jl, tl, lrs = [], [], []
    snap = None
    for i, b in enumerate(batches):
        if i == 1 and case == "skip-bad":
            snap = ({n: p.detach().clone() for n, p in tm.named_parameters()},
                    {k: v.clone() for k, v in to.state_dict().items()
                     if isinstance(v, torch.Tensor)}, to._global_step)
        jl.append(float(np.asarray(jstep(*b).numpy())))
        tl.append(float(tstep(*b)))
        if (i + 1) % acc == 0:
            lrs.append(to.get_lr())
            jo._learning_rate.step()
            to._learning_rate.step()
        if snap is not None and i == 1:
            assert tstep.bad_step_count == 1 and not tstep.last_step_finite
            for n, p in tm.named_parameters():
                assert torch.equal(p, snap[0][n]), n
            sd = to.state_dict()
            for k, v in snap[1].items():
                assert torch.equal(sd[k], v), k
            assert to._global_step == snap[2]
    finite = [i for i, x in enumerate(jl) if np.isfinite(x)]
    assert [i for i, x in enumerate(tl) if np.isfinite(x)] == finite
    np.testing.assert_allclose(np.asarray(tl)[finite],
                               np.asarray(jl)[finite], rtol=LOSS_RTOL)
    assert tstep.bad_step_count == jstep.bad_step_count
    assert tstep.bad_micro_count == jstep.bad_micro_count
    assert tstep.last_step_finite == jstep.last_step_finite
    want_bad = {"skip-bad": (1, 0), "accumulate-skip-micro": (0, 1),
                "accumulate-skip-window": (1, 2)}.get(case, (0, 0))
    assert (tstep.bad_step_count, tstep.bad_micro_count) == want_bad
    assert lrs[0] == 0.0 and lrs[1] == LR / 2       # the warm-up's
    _compare_params(jstep, tm)


def test_check_nan_inf_raises_as_the_reference(chaos_spec):
    """FLAGS_check_nan_inf without skip_bad_steps: a poisoned batch
    raises FloatingPointError with the reference's message."""
    msgs = []
    for which in ("reference", "port"):
        jm, tm = _models()
        jo, to = _optimizers(jm, tm, clip=False)
        step = (JTrainStep(jm, jo, _jloss) if which == "reference" else
                TrainStep(tm, to, _tloss))
        chaos_spec("step:nan:2")
        (jax_set_flags if which == "reference" else set_flags)(
            {"check_nan_inf": True})
        try:
            b = _batches(2)
            step(*b[0])
            with pytest.raises(FloatingPointError) as e:
                step(*b[1])
            msgs.append(str(e.value))
            assert not step.last_step_finite
        finally:
            (jax_set_flags if which == "reference" else set_flags)(
                {"check_nan_inf": False})
    assert msgs[0] == msgs[1] == ("FLAGS_check_nan_inf: nan/inf in loss "
                                  "or gradients at step 2")


class _LossModel(torch.nn.Module):
    """A model that returns its loss (TrainStep's loss_fn=None)."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids, labels, w):
        return _tloss(self.lm, ids, labels, w)


def test_model_returning_loss_and_eval_step():
    """loss_fn=None takes the model's own loss (the same steps as with
    loss_fn); EvalStep runs the model in eval mode without dropout and
    puts its mode back: the reference's EvalStep on a dropout-free model
    of the same weights gives the same logits (the reference's attention
    would still drop in eval mode, passing no `training` to its sdpa)."""
    b = _batches(2)
    _, tm = _models()
    to = topt.AdamW(LR, parameters=tm.parameters())
    state = trng.default_generator().get_state()
    losses = [float(TrainStep(tm, to, _tloss)(*x)) for x in b]
    _, tm2 = _models()
    trng.default_generator().set_state(state)
    to2 = topt.AdamW(LR, parameters=tm2.parameters())
    step2 = TrainStep(_LossModel(tm2), to2)
    assert [float(step2(*x)) for x in b] == losses

    jm0, tm0 = _models(dropout=0.0)
    _, tm1 = _models(dropout=0.1)
    tm1.train()
    ids = b[0][0]
    want = np.asarray(JEvalStep(jm0)(ids).numpy())
    got = EvalStep(tm1)(ids)
    assert tm1.training
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(EvalStep(tm0)(ids), got)


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"shard_fn": len},
                                    {"batch_sharding": ()},
                                    {"zero_stage": 1},
                                    {"param_sync_every": 2}])
def test_sharded_options_name_their_queue(kwargs):
    """Meshes, ZeRO and LocalSGD are not ported: each raises and names
    ROADMAP queue 5."""
    _, tm = _models(dropout=0.0)
    with pytest.raises(NotImplementedError, match="queue 5"):
        TrainStep(tm, topt.AdamW(LR, parameters=tm.parameters()), _tloss,
                  **kwargs)
