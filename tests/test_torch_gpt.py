"""The port's GPT (paddle_tpu_torch/models/gpt.py) against the reference
model on the same weights: logits, the fused LM-head cross-entropy and the
gradient of every parameter, in f32 on the CPU. The model is 2 layers,
hidden 128, 8 heads at seq 128, so the port's attention takes the flash
route (its plain versions on the CPU) while the reference's takes its
einsum path."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig, GPTForCausalLM, GPTForCausalLMScan
from paddle_tpu.nn.functional_more import \
    fused_linear_cross_entropy as jax_fused_ce

from paddle_tpu_torch.framework_io import params_from_paddle_tpu
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional_more import fused_linear_cross_entropy

torch.set_num_threads(1)

VOCAB, SEQ, BATCH = 256, 128, 2
# f32 through both packages; they differ in the order of f32 sums only.
LOGIT_ATOL = 1e-4       # logits are O(1)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4         # of each gradient's largest magnitude


def _jax_model(tie=True, seed=0):
    """The reference GPT with every parameter drawn from numpy (weights
    0.05*N(0,1), LayerNorm scales 1 + 0.1*N(0,1), biases 0.02*N(0,1)), so
    transposes and biases are all exercised."""
    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                    num_heads=8, max_seq_len=SEQ, tie_embeddings=tie)
    m = GPTForCausalLM(cfg)
    m.eval()
    rng = np.random.default_rng(seed)
    for n, p in m.named_parameters():
        x = rng.standard_normal(p.shape).astype(np.float32)
        if n.endswith("bias"):
            x *= np.float32(0.02)
        elif ".ln" in n:
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.05)
        p.set_value(x)
    return cfg, m


def _torch_model(cfg, named):
    tcfg = tgpt.GPTConfig(vocab_size=cfg.vocab_size,
                          hidden_size=cfg.hidden_size,
                          num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                          max_seq_len=cfg.max_seq_len,
                          tie_embeddings=cfg.tie_embeddings)
    m = tgpt.GPTForCausalLM(tcfg, device="cpu")
    m.load_state_dict(params_from_paddle_tpu(named))
    return m


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :7] = -100            # ignored tokens
    return ids, labels


def test_logits_loss_and_every_gradient_match_reference():
    cfg, jm = _jax_model()
    named = {n: p.numpy() for n, p in jm.named_parameters()}
    tm = _torch_model(cfg, named)
    ids, labels = _batch()
    jids, jlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)

    with torch.no_grad():
        np.testing.assert_allclose(tm(tids).numpy(), jm(jids).numpy(),
                                   atol=LOGIT_ATOL)

    # chunk 100 does not divide the 256 tokens: the ragged last chunk
    jloss = jax_fused_ce(jm.gpt(jids), jm.gpt.wte.weight, jlab,
                         transpose_y=True, chunk=100)
    jloss.backward()
    tloss = fused_linear_cross_entropy(tm.hidden(tids), tm.head_weight(),
                                       tlab, transpose_y=True, chunk=100)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=LOSS_RTOL)

    want = params_from_paddle_tpu(
        {n: p.grad.numpy() for n, p in jm.named_parameters()})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        ref = want[n].numpy()
        err = np.abs(g.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < GRAD_REL, (n, err)


@pytest.mark.parametrize("tie", [True, False])
def test_scan_and_unrolled_names_load_the_same_model(tie):
    """GPTForCausalLMScan.from_unrolled's stacked parameters unstack into
    the same port model as the unrolled names, and its logits match the
    reference scan model's."""
    cfg, jm = _jax_model(tie=tie)
    scan = GPTForCausalLMScan.from_unrolled(jm)
    scan.eval()
    unrolled = params_from_paddle_tpu(
        {n: p.numpy() for n, p in jm.named_parameters()})
    stacked = params_from_paddle_tpu(
        {n: p.numpy() for n, p in scan.named_parameters()})
    assert set(stacked) == set(unrolled)
    for n in unrolled:
        assert torch.equal(stacked[n], unrolled[n]), n
    ids, _ = _batch()
    tm = _torch_model(cfg, {n: p.numpy() for n, p in
                            scan.named_parameters()})
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(ids)).numpy(),
            scan(paddle.to_tensor(ids)).numpy(), atol=LOGIT_ATOL)


def test_converter_transposes_linears_and_ties_embeddings():
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((8, 24)).astype(np.float32)   # [in, out]
    ln = rng.standard_normal(8).astype(np.float32)
    wte = rng.standard_normal((16, 8)).astype(np.float32)
    head = rng.standard_normal((8, 16)).astype(np.float32)  # [D, V]
    sd = params_from_paddle_tpu({
        "gpt.blocks.0.attn.qkv_proj.weight": qkv,
        "gpt.blocks.0.ln1.weight": ln, "gpt.wte.weight": wte,
        "lm_head.weight": head})
    assert torch.equal(sd["gpt.blocks.0.attn.qkv_proj.weight"],
                       torch.from_numpy(qkv.T.copy()))
    assert torch.equal(sd["gpt.blocks.0.ln1.weight"], torch.from_numpy(ln))
    assert torch.equal(sd["gpt.wte.weight"], torch.from_numpy(wte))
    assert torch.equal(sd["lm_head.weight"], torch.from_numpy(head.T.copy()))
    # stacked: [L, in, out] -> one [out, in] per block
    st = params_from_paddle_tpu({"fc1_w": np.stack([qkv, 2 * qkv])})
    assert torch.equal(st["gpt.blocks.1.mlp.fc1.weight"],
                       torch.from_numpy(2 * qkv.T))
    with pytest.raises(KeyError):
        params_from_paddle_tpu({"gpt.blocks.0.attn.bogus": ln})

    # tied: the head is wte itself, logits = h . wte^T
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(vocab_size=16, hidden_size=8,
                                            num_layers=1, num_heads=2,
                                            max_seq_len=64), device="cpu")
    assert tm.head_weight() is tm.gpt.wte.weight
    assert not hasattr(tm, "lm_head")
    ids = torch.from_numpy(rng.integers(0, 16, (1, 64)))
    with torch.no_grad():
        torch.testing.assert_close(tm(ids), tm.hidden(ids) @
                                   tm.gpt.wte.weight.T)


def test_gelu_and_layer_norm_match_reference():
    """nn.functional's GELU (tanh approximation, as GPT's MLP uses it) and
    layer_norm against the reference's, f32: atol 1e-6 for GELU, 1e-5 for
    layer_norm, whose mean and variance sum in another order."""
    import paddle_tpu.nn.functional as PF

    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    tx = torch.from_numpy(x)
    for approximate in (True, False):
        np.testing.assert_allclose(
            TF.gelu(tx, approximate=approximate).numpy(),
            PF.gelu(paddle.to_tensor(x), approximate=approximate).numpy(),
            atol=1e-6)
    np.testing.assert_allclose(
        TF.layer_norm(tx, 16, torch.from_numpy(w), torch.from_numpy(b),
                      1e-5).numpy(),
        PF.layer_norm(paddle.to_tensor(x), 16, paddle.to_tensor(w),
                      paddle.to_tensor(b), 1e-5).numpy(), atol=1e-5)
