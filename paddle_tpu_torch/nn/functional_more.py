"""Fused big-vocab LM head + cross-entropy (counterpart of
paddle_tpu/nn/functional_more.py:fused_linear_cross_entropy)."""
from __future__ import annotations

import torch


def _mm_f32(a, b):
    """a @ b with f32 output. bf16 operands: one bf16 GEMM with f32
    accumulation on a card (the tensor cores; a product of two bf16 values
    is exact in f32), the same products cast to f32 on the CPU, which has no
    kernel for it; f32 operands: an f32 GEMM."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _split3(x):
    """f32 x as three bf16 terms lo, mid, hi (hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid); both subtractions are exact), in
    one [3, ...] tensor, small terms first. lo + mid + hi = x for |x| above
    about 2^-110. x is consumed (it holds the last remainder after)."""
    terms = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    for i in (2, 1, 0):
        terms[i].copy_(x)
        x.sub_(terms[i])
    return terms


class _ChunkCE(torch.autograd.Function):
    """(sum of CE over the chunk's kept tokens, their count) of the logits
    h @ w^T (transpose_y) or h @ w, in f32, as the reference's
    `jnp.dot(hcb, w, preferred_element_type=f32)` (:1134) forms them. The
    forward keeps h, w, y and the rows' logsumexp; the backward recomputes
    the logits (the reference's jax.checkpoint) and forms dlogits =
    (softmax - onehot) * keep * g in f32. With bf16 operands the gradients
    of h and w multiply f32 dlogits by bf16 operands: dlogits is split into
    three bf16 terms (_split3), so every product is exact in f32, and each
    gradient is bf16 GEMMs with f32 accumulation (dh: one per term, summed
    small first; dw: one over the terms stacked along the token axis, with
    h stacked alike), rounded to the operand's dtype once. f32 operands take
    f32 GEMMs throughout."""

    @staticmethod
    def forward(ctx, h, w, y, transpose_y: bool, ignore_index: int):
        wm = w.t() if transpose_y else w                     # [H, V]
        logits = _mm_f32(h, wm)
        lse = torch.logsumexp(logits, dim=-1)
        own = logits.gather(-1, y.clamp(min=0)[:, None])[:, 0]
        keep = (y != ignore_index).float()
        ctx.save_for_backward(h, w, y, lse)
        ctx.transpose_y, ctx.ignore_index = transpose_y, ignore_index
        count = keep.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - own) * keep).sum(), count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        h, w, y, lse = ctx.saved_tensors
        wm = w.t() if ctx.transpose_y else w
        dl = _mm_f32(h, wm)
        dl.sub_(lse[:, None]).exp_()                         # softmax
        keep = y != ctx.ignore_index
        rows = torch.arange(y.shape[0], device=y.device)
        dl[rows, y.clamp(min=0)] -= 1.0
        dl.mul_((keep.float() * g_total)[:, None])
        if h.dtype != torch.bfloat16:
            dh = dl @ wm.t()
            dwm = h.t() @ dl                                 # [H, V]
        else:
            terms = _split3(dl)                              # lo, mid, hi
            dh = _mm_f32(terms[0], wm.t())
            dh += _mm_f32(terms[1], wm.t())
            dh += _mm_f32(terms[2], wm.t())
            dwm = _mm_f32(h.t().repeat(1, 3), terms.flatten(0, 1))
        dw = dwm.t() if ctx.transpose_y else dwm
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, transpose_y=True,
                               chunk=2048, ignore_index=-100):
    """Mean CE of linear(hidden, weight) against labels over the tokens that
    are not `ignore_index`, without materialising the [T, vocab] logits:
    each token chunk computes its logits, reduces them to logsumexp and the
    label's logit, and is recomputed in backward (_ChunkCE).

    hidden: [..., H]; weight: [V, H] when transpose_y (tied wte) else
    [H, V]; labels: the matching integer ids. Returns an f32 scalar."""
    h = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1).to(h.device)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], int(chunk)):
        t, c = _ChunkCE.apply(h[i:i + chunk], weight, y[i:i + chunk],
                              bool(transpose_y), int(ignore_index))
        total = total + t
        count = count + c
    return total / count.clamp(min=1.0)
