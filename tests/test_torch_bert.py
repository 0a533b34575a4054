"""The port's BERT (paddle_tpu_torch/models/bert.py, nn/transformer.py)
against the JAX package's on the same seeded weights and batches, at 2
layers, hidden 64, 4 heads (head_dim 16, padded to 64 by the flash path)
and L = 128, so that the flash gate passes and, without a mask, the port's
non-causal flash path runs (its plain versions on the CPU) where the
reference, off the TPU, takes the einsum: logits with and without an
attention mask, the MLM loss and every parameter's gradient in f32; the
routing (flash without a mask, the einsum with one or with dropout);
dropout 0.1 in training with both generators seeded alike; and 3 bf16 O2
AdamW steps (auto_cast bf16, f32 masters), eager and through TrainStep,
against the reference's eager steps; the framework_io round trip of
BERT's names; the encoder layer post-norm and pre-norm, its activation
by name. Tolerances as tests/test_torch_train_step.py's: f32 loss
rtol 1e-5, gradients relative 1e-4, logits atol 1e-4; bf16 loss rtol
2e-3, Adam moments relative 0.05 (the query projection's bias 0.1: see
BF16)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForMaskedLM as JBertForMaskedLM

import paddle_tpu_torch
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework_io import (params_from_paddle_tpu,
                                           params_to_paddle_tpu,
                                           transpose_optimizer_state)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

VOCAB, SEQ, BATCH, STEPS, LR = 256, 128, 2, 3, 1e-3
WIDTHS = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position=SEQ)
F32 = {"loss_rtol": 1e-5, "grad_rel": 1e-4, "logits_atol": 1e-4}
# bf16: one limit looser than the GPT test's, the query projection's bias:
# its gradient sums dQ over the tokens, where each row of dS sums to zero,
# so only the keys' deviations from their mean are left and the sum
# cancels most; rounded to bf16 in both packages its moments read 5.2% and
# 6.2% apart (as much with the einsum attention on both sides), every
# other moment under 4%
BF16 = {"loss_rtol": 2e-3, "moment_rel": 0.05, "q_bias_moment_rel": 0.1}
MASK_ID = 1


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _models(dropout=0.0, seed=0):
    """The reference's model with seeded weights and the port's loaded
    from them (via params_from_paddle_tpu)."""
    jm = JBertForMaskedLM(JBertConfig(dropout=dropout, **WIDTHS))
    rng = np.random.default_rng(seed)
    named = {}
    for n, p in jm.named_parameters():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif "norm" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
        named[n] = x
    tm = BertForMaskedLM(BertConfig(dropout=dropout, **WIDTHS), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(named))
    return jm, tm, named


def _mlm_batch(rng):
    """MLM-shaped ids (15% of positions replaced by MASK_ID, at least
    the first of each row) and labels (the true ids there, -100
    elsewhere), as tests/test_baseline_rows.py makes them."""
    ids = rng.integers(4, VOCAB, (BATCH, SEQ)).astype(np.int64)
    pos = rng.random(ids.shape) < 0.15
    pos[:, 0] = True
    return np.where(pos, MASK_ID, ids), np.where(pos, ids, -100)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the port's calls into the flash path."""
    calls = []
    real = TF.flash_attention

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(TF, "flash_attention", counted)
    return calls


def test_parameter_names_and_framework_io_round_trip():
    jm, tm, named = _models()
    assert [n for n, _ in tm.named_parameters()] == list(named)
    back = params_to_paddle_tpu(tm.state_dict())
    assert set(back) == set(named)
    for n, x in named.items():
        np.testing.assert_array_equal(back[n].numpy(), x)
    # the Linear weights are the transposed ones
    assert tm.state_dict()["bert.encoder.layers.1.self_attn.q_proj.weight"]\
        .shape == (64, 64)
    assert tuple(tm.transform.weight.shape) == named["transform.weight"].T\
        .shape
    t1 = named["bert.encoder.layers.0.linear1.weight"]
    assert torch.equal(tm.bert.encoder.layers[0].linear1.weight,
                       torch.from_numpy(t1.T.copy()))
    names = list(named)
    opt = {"p1.moment1": np.ones((3, 3)), "global_step": 2}
    i = names.index("transform.weight")
    opt[f"p{i}.moment1"] = np.arange(64 * 64, dtype=np.float32).reshape(64,
                                                                       64)
    got = transpose_optimizer_state(opt, names)
    np.testing.assert_array_equal(got[f"p{i}.moment1"].numpy(),
                                  opt[f"p{i}.moment1"].T)
    with pytest.raises(KeyError):
        params_from_paddle_tpu({"bert.encoder.layers.0.bogus.weight": t1})


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_f32_logits_loss_and_grads(masked, flash_calls):
    jm, tm, _ = _models()
    rng = np.random.default_rng(1)
    ids, labels = _mlm_batch(rng)
    mask = None
    if masked:
        mask = np.ones((BATCH, SEQ), np.int64)
        mask[1, 96:] = 0                    # the second row padded
    jlogits = jm(paddle.to_tensor(ids), attention_mask=None if mask is None
                 else paddle.to_tensor(mask))
    tlogits = tm(torch.from_numpy(ids), attention_mask=None if mask is None
                 else torch.from_numpy(mask))
    # without a mask the port's attention is the flash path (once a layer),
    # with one the einsum
    assert len(flash_calls) == (0 if masked else 2)
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits.numpy()),
                               atol=F32["logits_atol"], rtol=0)
    if masked:
        # a padded key changes nothing the kept rows see: drop it and the
        # kept part of the row's logits stays
        short = tm(torch.from_numpy(ids[1:, :96]))
        np.testing.assert_allclose(short[0].detach().numpy(),
                                   tlogits[1, :96].detach().numpy(),
                                   atol=F32["logits_atol"])
        return
    jloss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    tloss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=F32["loss_rtol"])
    jloss.backward()
    tloss.backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    want = params_from_paddle_tpu({n: np.asarray(g.numpy())
                                   for n, g in jgrads.items()
                                   if g is not None})
    # the pooler and the token-type table take no part in the MLM loss
    assert sorted(set(jgrads) - set(want)) == [
        "bert.embeddings.token_type_embeddings.weight", "bert.pooler.bias",
        "bert.pooler.weight"]
    for n, p in tm.named_parameters():
        if n not in want:
            assert p.grad is None, n
        elif n.endswith("k_proj.bias"):
            # exactly zero (softmax ignores a constant added to a row's
            # scores): both sides read f32 rounding noise
            assert np.abs(p.grad.numpy()).max() < 1e-8, n
            assert np.abs(want[n].numpy()).max() < 1e-8, n
        else:
            assert _rel(p.grad.numpy(), want[n].numpy()) <= \
                F32["grad_rel"], n


def test_dropout_in_training_matches_the_reference(flash_calls):
    """dropout 0.1 (the reference's default): every mask drawn from the
    default generator in the reference's order, so the losses agree after
    seeding both generators alike; attention takes the einsum with dropout,
    never flash; in eval no dropout, so the flash path again."""
    jm, tm, _ = _models(dropout=0.1)
    rng = np.random.default_rng(2)
    ids, labels = _mlm_batch(rng)
    paddle_tpu.seed(11)
    paddle_tpu_torch.seed(11)
    jloss = float(jm.loss(paddle.to_tensor(ids),
                          paddle.to_tensor(labels)).numpy())
    tloss = float(tm.loss(torch.from_numpy(ids),
                          torch.from_numpy(labels)).detach())
    np.testing.assert_allclose(tloss, jloss, rtol=F32["loss_rtol"])
    assert not flash_calls
    jm.eval()
    tm.eval()
    with torch.no_grad():
        ev = float(tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert len(flash_calls) == 2
    np.testing.assert_allclose(
        ev, float(jm.loss(paddle.to_tensor(ids),
                          paddle.to_tensor(labels)).numpy()),
        rtol=F32["loss_rtol"])
    assert ev != tloss


@pytest.mark.parametrize("loop", ["eager", "train_step"])
def test_bf16_o2_adamw_steps_match_reference(loop, flash_calls):
    """3 steps of the baseline row's recipe (amp.decorate O2 to bf16,
    AdamW multi_precision, auto_cast bf16, the MLM loss): losses and Adam
    moments against the reference's eager steps; and the loss on a
    held-out batch before and after them (the baseline row's own check,
    there over 6 steps) against the reference's."""
    jm, tm, _ = _models()
    jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    jo = jopt.AdamW(LR, parameters=jm.parameters(), multi_precision=True)
    to = AdamW(LR, parameters=tm.parameters(), multi_precision=True)
    rng = np.random.default_rng(3)
    probe = _mlm_batch(rng)
    batches = [_mlm_batch(rng) for _ in range(STEPS)]

    def tprobe():
        with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
            return float(tm.loss(*map(torch.from_numpy, probe)))

    def jprobe():
        with paddle.no_grad(), jamp.auto_cast(dtype="bfloat16"):
            return float(jm.loss(*map(paddle.to_tensor, probe)).numpy())

    jl, jbefore = [], jprobe()
    for ids, labels in batches:
        with jamp.auto_cast(dtype="bfloat16"):
            loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
    jafter = jprobe()

    before = tprobe()
    if loop == "eager":
        tl = []
        for ids, labels in batches:
            with amp.auto_cast(dtype="bfloat16"):
                loss = tm.loss(torch.from_numpy(ids),
                               torch.from_numpy(labels))
            loss.backward()
            to.step()
            to.clear_grad()
            tl.append(float(loss.detach()))
    else:
        def loss_fn(m, ids, labels):
            with amp.auto_cast(dtype="bfloat16"):
                return m.loss(ids, labels)

        step = TrainStep(tm, to, loss_fn)
        tl = [float(step(ids, labels)) for ids, labels in batches]
    after = tprobe()
    assert len(flash_calls) == 2 * (STEPS + 2)   # steps and both probes
    np.testing.assert_allclose(tl, jl, rtol=BF16["loss_rtol"])
    np.testing.assert_allclose([before, after], [jbefore, jafter],
                               rtol=BF16["loss_rtol"])
    tparams = dict(tm.named_parameters())
    # the pooler and the token-type table get no gradient: no state in the
    # eager steps; TrainStep hands the optimizer zeros for them, as the
    # reference's does, so their moments stay zero
    jstate = {n: jo._accumulators[id(p)] for n, p in jm.named_parameters()
              if id(p) in jo._accumulators}
    assert len(jstate) == len(tparams) - 3
    assert len(to.state) == len(jstate if loop == "eager" else tparams)
    for n, p in tparams.items():
        if n not in jstate and p in to.state:
            assert not to.state[p]["moment1"].any(), n
    for key in ("moment1", "moment2"):
        want = params_from_paddle_tpu({n: np.asarray(s[key])
                                       for n, s in jstate.items()})
        scale = max(np.abs(w.numpy()).max() for w in want.values())
        for n, w in want.items():
            got = to.state[tparams[n]][key].numpy()
            if n.endswith("k_proj.bias"):
                # an exactly zero gradient (see the f32 test): both sides'
                # moments are rounding noise, far under every other's
                assert max(np.abs(got).max(), np.abs(w.numpy()).max()) \
                    < 1e-3 * scale, (key, n)
                continue
            tol = BF16["q_bias_moment_rel" if n.endswith("q_proj.bias")
                       else "moment_rel"]
            assert _rel(got, w.numpy()) < tol, (key, n)


@pytest.mark.parametrize("normalize_before,activation",
                         [(False, "relu"), (True, "gelu")],
                         ids=["post-norm-relu", "pre-norm-gelu"])
def test_encoder_layer_norm_placement_and_activation(normalize_before,
                                                     activation):
    """TransformerEncoderLayer post-norm (the default) and pre-norm, its
    activation looked up by name, under a TransformerEncoder of 2 deep
    copies (the same starting weights in every layer): output and every
    parameter's gradient against the reference's, f32."""
    from paddle_tpu.nn import TransformerEncoder as JEncoder
    from paddle_tpu.nn import TransformerEncoderLayer as JLayer

    from paddle_tpu_torch.nn import TransformerEncoder, \
        TransformerEncoderLayer

    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    jenc = JEncoder(JLayer(32, 4, 64, **kw), 2)
    tenc = TransformerEncoder(TransformerEncoderLayer(32, 4, 64, **kw), 2)
    rng = np.random.default_rng(4)
    named = {}
    for n, p in jenc.layers[0].named_parameters():
        x = (rng.standard_normal(tuple(p.shape)) * 0.1).astype(np.float32)
        if "norm" in n and n.endswith("weight"):
            x += np.float32(1)
        for layer in jenc.layers:
            dict(layer.named_parameters())[n].set_value(x)
        named[n] = x
    layer_sd = params_from_paddle_tpu(
        {f"bert.encoder.layers.0.{n}": x for n, x in named.items()})
    for layer in tenc.layers:
        layer.load_state_dict({n.split("layers.0.")[1]: t
                               for n, t in layer_sd.items()})
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    g = rng.standard_normal((2, 16, 32)).astype(np.float32)
    jout = jenc(paddle.to_tensor(x))
    tout = tenc(torch.from_numpy(x))
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.numpy()),
                               atol=F32["logits_atol"], rtol=0)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    want = params_from_paddle_tpu(
        {f"bert.encoder.{n}": np.asarray(p.grad.numpy())
         for n, p in jenc.named_parameters()})
    for n, p in tenc.named_parameters():
        w = want[f"bert.encoder.{n}"].numpy()
        if n.endswith("k_proj.bias"):
            assert np.abs(p.grad.numpy()).max() < 1e-6, n
            continue
        assert _rel(p.grad.numpy(), w) <= F32["grad_rel"], n
