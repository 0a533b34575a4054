"""Fused big-vocab LM head + cross-entropy (counterpart of
paddle_tpu/nn/functional_more.py:fused_linear_cross_entropy)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_ce(h, w, y, transpose_y: bool, ignore_index: int):
    """(sum of CE over the chunk's kept tokens, their count). Logits are
    accumulated in f32: bf16 products are exact in f32, so casting the
    operands first gives the reference's preferred_element_type=f32 dot."""
    wf = w.float()
    logits = h.float() @ (wf.t() if transpose_y else wf)
    lse = torch.logsumexp(logits, dim=-1)
    own = logits.gather(-1, y.clamp(min=0)[:, None])[:, 0]
    keep = (y != ignore_index).float()
    return ((lse - own) * keep).sum(), keep.sum()


def fused_linear_cross_entropy(hidden, weight, labels, transpose_y=True,
                               chunk=2048, ignore_index=-100):
    """Mean CE of linear(hidden, weight) against labels over the tokens that
    are not `ignore_index`, without materialising the [T, vocab] logits:
    each token chunk computes its logits, reduces them to logsumexp and the
    label's logit, and is recomputed in backward (torch.utils.checkpoint).

    hidden: [..., H]; weight: [V, H] when transpose_y (tied wte) else
    [H, V]; labels: the matching integer ids. Returns an f32 scalar."""
    h = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1).to(h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], int(chunk)):
        t, c = checkpoint(_chunk_ce, h[i:i + chunk], weight, y[i:i + chunk],
                          bool(transpose_y), int(ignore_index),
                          use_reentrant=False)
        total = total + t
        count = count + c
    return total / count.clamp(min=1.0)
