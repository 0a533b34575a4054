"""The port's ResNet (paddle_tpu_torch/models/resnet.py over nn.Conv2D,
BatchNorm2D, pooling and CrossEntropyLoss) against the JAX package's on
the same weights and CIFAR-shaped batches (2 x 3 x 32 x 32, 10 classes):
resnet18(small_input=True) and a Bottleneck ResNet of one block a stage.
In training mode (batch statistics), the logits, the loss and every
parameter's gradient; then 3 dygraph Momentum steps as the baseline row
takes them (loss.backward, opt.step, opt.clear_grad): losses, parameters
and both batch-norm buffers of every layer; then an eval forward on the
running statistics; the same steps through jit.TrainStep (the buffers
advance on every call, every micro-batch's under accumulation, and stay
put on a step skip_bad_steps drops); and the framework_io round trips.
Tolerances as tests/test_torch_train_step.py's f32 ones: loss rtol 1e-5,
gradients relative 1e-4, logits atol 1e-4; what the steps changed in each
buffer relative 1e-4, in each parameter 2e-2 (see TOL)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import resnet as jresnet

from paddle_tpu_torch.framework_io import (params_from_paddle_tpu,
                                           params_to_paddle_tpu)
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.vision import models as tvision

torch.set_num_threads(1)

BATCH, CLASSES, STEPS, LR = 2, 10, 3, 0.01
# Parameters after the steps: what the steps changed, within 2% of that
# change's largest entry. One step's gradients agree within 1e-4 (7e-6
# read), but a ReLU whose input lies within f32 rounding of zero takes the
# other side in one package: at step 3 one activation's gradient then
# parts by 23% of that tensor's largest (read against the port in f64,
# which the reference follows there), and a parameter's change by up to
# 1.1%. The buffers are forward statistics and stay within 1e-4 (2e-6).
TOL = {"loss_rtol": 1e-5, "grad_rel": 1e-4, "logits_atol": 1e-4,
       "param_change_rel": 0.02}
MODELS = {
    "resnet18": lambda m, **kw: m.resnet18(num_classes=CLASSES,
                                           small_input=True, **kw),
    "bottleneck-1111": lambda m, **kw: m.ResNet(
        m.BottleneckBlock, [1, 1, 1, 1], num_classes=CLASSES,
        small_input=True, **kw),
}


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _models(kind):
    """The reference's model (its own initializers, seeded) and the port's
    loaded from its state_dict, running statistics included."""
    paddle.seed(0)
    jm = MODELS[kind](jresnet)
    named = {n: np.asarray(v.numpy()) for n, v in jm.state_dict().items()}
    tm = MODELS[kind](tresnet, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(named))
    return jm, tm, named


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 3, 32, 32)).astype(np.float32),
             rng.integers(0, CLASSES, BATCH).astype(np.int64))
            for _ in range(n)]


def _check_state(jm, tm, init):
    """Every parameter and batch-norm buffer of the two models: what the
    steps changed (from `init`, the reference-layout state before them),
    relative to the largest change of that entry (see TOL)."""
    want = params_from_paddle_tpu({n: np.asarray(v.numpy()) for n, v in
                                   jm.state_dict().items()})
    init = params_from_paddle_tpu(init)
    got = tm.state_dict()
    assert set(got) == set(want)
    for n, w in want.items():
        moved = w.numpy() - init[n].numpy()
        assert np.abs(moved).max() > 0, n
        tol = TOL["grad_rel" if n.endswith(("_mean", "_variance"))
                  else "param_change_rel"]
        assert _rel(got[n].numpy() - init[n].numpy(), moved) <= tol, n


@pytest.mark.parametrize("kind", MODELS)
def test_names_and_framework_io_round_trip(kind):
    jm, tm, named = _models(kind)
    # (the reference's state_dict lists every parameter, then the buffers)
    assert set(tm.state_dict()) == set(named)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    back = params_to_paddle_tpu(tm.state_dict())
    assert set(back) == set(named)
    for n, x in named.items():
        np.testing.assert_array_equal(back[n].numpy(), x)
    # conv weights keep their layout; fc's is transposed
    assert tuple(tm.conv1.weight.shape) == named["conv1.weight"].shape
    assert tuple(tm.fc.weight.shape) == named["fc.weight"].T.shape
    if kind == "resnet18":
        assert tvision.resnet18 is tresnet.resnet18
    with pytest.raises(KeyError):
        params_to_paddle_tpu({"layer9.0.conv1.weight": tm.conv1.weight})


@pytest.mark.parametrize("kind", MODELS)
def test_training_forward_loss_and_grads(kind):
    jm, tm, _ = _models(kind)
    ((x, y),) = _batches(1)
    jl = jnn.CrossEntropyLoss()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    tlogits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(
        tlogits.detach().numpy(), np.asarray(jm(paddle.to_tensor(x)).numpy()),
        atol=TOL["logits_atol"], rtol=0)
    tl = CrossEntropyLoss()(tlogits, torch.from_numpy(y))
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=TOL["loss_rtol"])
    jl.backward()
    tl.backward()
    want = params_from_paddle_tpu({n: np.asarray(p.grad.numpy())
                                   for n, p in jm.named_parameters()})
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), want[n].numpy()) <= TOL["grad_rel"], n


@pytest.mark.parametrize("kind", MODELS)
def test_dygraph_momentum_steps_then_eval(kind):
    """The baseline row's dygraph loop for 3 steps: losses, then every
    parameter and running statistic (each BN buffer moved, as the
    reference's did); then eval logits on the running statistics."""
    jm, tm, named = _models(kind)
    jo = jopt.Momentum(LR, parameters=jm.parameters())
    to = Momentum(LR, parameters=tm.parameters())
    jlossf, tlossf = jnn.CrossEntropyLoss(), CrossEntropyLoss()
    jl, tl = [], []
    for x, y in _batches(STEPS):
        loss = jlossf(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
        loss = tlossf(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=TOL["loss_rtol"])
    _check_state(jm, tm, named)          # every BN buffer moved, too
    jm.eval()
    x = _batches(1, seed=2)[0][0]
    tout = EvalStep(tm)(torch.from_numpy(x))
    assert tm.training                  # EvalStep puts the mode back
    np.testing.assert_allclose(tout.numpy(),
                               np.asarray(jm(paddle.to_tensor(x)).numpy()),
                               atol=TOL["logits_atol"], rtol=0)


def _train_step(tm, accumulate=1, skip=False):
    def loss_fn(m, x, y):
        return CrossEntropyLoss()(m(x), y)

    return TrainStep(tm, Momentum(LR, parameters=tm.parameters()), loss_fn,
                     accumulate_steps=accumulate, skip_bad_steps=skip)


def test_train_step_carries_the_running_statistics():
    """TrainStep over the same 3 batches: the same losses and state as
    the reference's dygraph steps; under accumulate_steps=2 the buffers
    advance on each micro-batch; a step that skip_bad_steps drops (chaos
    step:nan) leaves them as they were."""
    jm, tm, named = _models("bottleneck-1111")
    jo = jopt.Momentum(LR, parameters=jm.parameters())
    jlossf = jnn.CrossEntropyLoss()
    batches = _batches(STEPS)
    jl = []
    for x, y in batches:
        loss = jlossf(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
    step = _train_step(tm)
    tl = [float(step(*map(torch.from_numpy, b))) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=TOL["loss_rtol"])
    _check_state(jm, tm, named)

    _, tm2, _ = _models("bottleneck-1111")
    acc = _train_step(tm2, accumulate=2)
    means = [tm2.bn1._mean.clone()]
    for x, y in batches[:2]:
        acc(torch.from_numpy(x), torch.from_numpy(y))
        means.append(tm2.bn1._mean.clone())
    assert not torch.equal(means[0], means[1])
    assert not torch.equal(means[1], means[2])

    _, tm3, _ = _models("bottleneck-1111")
    skip = _train_step(tm3, skip=True)
    x, y = map(torch.from_numpy, batches[0])
    chaos.configure("step:nan:2")
    try:
        skip(x, y)
        before = {n: b.clone() for n, b in tm3.named_buffers()}
        skip(x, y)
    finally:
        chaos.reset()
    assert skip.bad_step_count == 1
    for n, b in tm3.named_buffers():
        assert torch.equal(b, before[n]), n
