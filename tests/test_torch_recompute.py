"""Recompute (paddle_tpu_torch/distributed/recompute.py) on the 2-layer
narrow GPT with dropout 0.1 of test_torch_trainer.py: every block
wrapped by `recompute_wrap_sublayers` gives the same loss and the same
gradients, bitwise, as the model without it (the replay in backward
draws the dropout keys of the first pass: the generator's key and
counter are restored for it); a segment's body running twice, its keys
the same both times; and two TrainSteps of the recomputed model against
the reference's, its blocks wrapped the same way (tolerances as
test_torch_trainer.py's)."""
import numpy as np
import torch

from paddle_tpu.distributed.recompute import \
    recompute_wrap_sublayers as jax_wrap
from paddle_tpu.jit import TrainStep as JTrainStep

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed import (recompute, recompute_sequential,
                                          recompute_wrap_sublayers)
from paddle_tpu_torch.jit import TrainStep

from test_torch_trainer import (LAYERS, LOSS_RTOL, _batches, _compare_params,
                                _jloss, _models, _optimizers, _tloss)

torch.set_num_threads(1)

BLOCKS = [f"gpt.blocks.{i}" for i in range(LAYERS)]


def _grads(model, key, batch):
    with trng.rng_key_scope(key):
        loss = _tloss(model, *(torch.as_tensor(x) for x in batch))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_recompute_gives_the_same_grads_bitwise():
    _, plain = _models()
    _, wrapped = _models()
    recompute_wrap_sublayers(wrapped, BLOCKS)
    assert all(b._recompute_wrapped for b in wrapped.gpt.blocks)
    assert not getattr(wrapped.gpt, "_recompute_wrapped", False)
    key = trng.fold_in(trng.key(1), 1)
    batch = _batches(1)[0]
    want_loss, want = _grads(plain, key, batch)
    state = trng.default_generator().get_state()
    got_loss, got = _grads(wrapped, key, batch)
    assert trng.default_generator().get_state() == state
    assert torch.equal(got_loss, want_loss)
    for n, g in want.items():
        assert torch.equal(got[n], g), n


def test_replay_runs_and_restores_the_generator():
    """A recomputed segment's body runs twice (forward, replay in
    backward) with the same keys; the generator is left where the first
    pass left it."""
    drawn = []

    def body(x):
        k = trng.next_key()
        drawn.append(k)
        keep = trng.bernoulli(k, 0.5, x.shape)
        return torch.where(keep, x * 2.0, torch.zeros_like(x))

    x = torch.randn(6, 7, requires_grad=True)
    with trng.rng_key_scope(trng.key(4)):
        y = recompute(body, x)
        after = trng.default_generator().snapshot()
    y.sum().backward()
    assert len(drawn) == 2 and torch.equal(drawn[0], drawn[1])
    assert torch.equal(x.grad, (y.detach() != 0).float() * 2.0)
    with trng.rng_key_scope(trng.key(4)):
        assert trng.default_generator().snapshot()[1] == 0
    assert after[1] == 1
    # with grad off the segment just runs
    with torch.no_grad():
        recompute(body, x)
    assert len(drawn) == 3


def test_recompute_sequential():
    torch.manual_seed(0)
    layers = torch.nn.Sequential(*(torch.nn.Linear(8, 8) for _ in range(4)))
    x = torch.randn(3, 8, requires_grad=True)
    want = layers(x)
    want.sum().backward()
    g = x.grad.clone()
    x.grad = None
    got = recompute_sequential({"segments": 2}, layers, x)
    got.sum().backward()
    assert torch.equal(got, want) and torch.equal(x.grad, g)


def test_recompute_train_steps_match_reference():
    jm, tm = _models()
    jax_wrap(jm, BLOCKS)
    recompute_wrap_sublayers(tm, BLOCKS)
    jo, to = _optimizers(jm, tm)
    jstep, tstep = JTrainStep(jm, jo, _jloss), TrainStep(tm, to, _tloss)
    jl, tl = [], []
    for b in _batches(2):
        jl.append(float(np.asarray(jstep(*b).numpy())))
        tl.append(float(tstep(*b)))
        jo._learning_rate.step()
        to._learning_rate.step()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _compare_params(jstep, tm)
    assert isinstance(to, topt.AdamW)
