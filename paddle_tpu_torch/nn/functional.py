"""Functional ops of the ported path (counterpart of
paddle_tpu/nn/functional.py): attention with the reference's routing
(flash, the chunked query scan, the einsum, and the einsum with dropout
on the probabilities), dropout, the activations (the reference's
formulas, jax.nn's where it calls jax.nn), softmax and log_softmax,
prelu, glu, maxout, one_hot, normalize, sequence_mask, label_smooth,
linear, embedding, layer norm, and what BERT and ResNet run besides:
conv2d, max, average and adaptive average pooling, batch norm and
cross-entropy.

Dropout masks are the reference's bitwise: each call draws one key from
the default generator (core/rng.py; the train step rebases it on the
step's key) and keeps an element where a float64 uniform of that key is
below 1 - p, as `jax.random.bernoulli` under x64. Masks are drawn in
plain PyTorch, as the reference draws them in XLA. `linear`, `conv2d`,
`layer_norm` and `cross_entropy` cast their inputs under `amp.auto_cast`
(O1) as the reference's ops of those names do. Convolutions, pooling and
batch norm are plain PyTorch, as the reference leaves them to XLA; each
takes the reference's padding and statistics where torch's own differ
(SAME at any stride, asymmetric and ceil-mode pads, adaptive windows that
end at the floor, batch norm's momentum and biased running variance).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..amp import cast_inputs
from ..core import rng as _rng
from ..core.dtype import convert_dtype
from ..core.flags import flag
from ..ops.common import to_inexact
# re-exported as the reference's nn.functional re-exports them
from ..ops.creation import diag_embed  # noqa: F401
from ..ops.manipulation import one_hot, pad  # noqa: F401
from ..ops.flash_attention import (flash_attention,
                                   flash_attention_supported,
                                   resolve_dot_impl)

# chunks the chunked attention has run (forward passes, not the
# recomputation in backward): how a caller sees that the path ran
CHUNKED_CALLS = {"chunks": 0}
_SQRT_HALF = math.sqrt(0.5)


# ---------------------------------------------------------- activations --
# Each is the reference's formula (jax.nn's where it calls jax.nn) in
# torch ops, so the values and the gradients at the kinks follow it.
def gelu(x, approximate: bool = False, name=None):
    """x * Phi(x), Phi as jax.nn.gelu forms it: erfc(-x / sqrt 2) / 2
    (exact), or the tanh form."""
    if approximate:
        return torch.nn.functional.gelu(x, approximate="tanh")
    return x * (torch.special.erfc(x * -_SQRT_HALF) / 2)


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return x * torch.sigmoid(x)


swish = silu


def log_sigmoid(x, name=None):
    return -_softplus(-x)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def softsign(x, name=None):
    return x / (torch.abs(x) + 1)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0.0, 6.0) / 6


def hardsigmoid(x, name=None):
    return torch.clamp(x / 6 + 0.5, 0.0, 1.0)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, float(negative_slope) * x)


def elu(x, alpha=1.0, name=None):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, float(alpha) * torch.expm1(safe))


def celu(x, alpha=1.0, name=None):
    alpha = float(alpha)
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return float(scale) * torch.where(x > 0, x,
                                      float(alpha) * torch.expm1(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, float(min), float(max))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > float(threshold), x,
                       torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    t = float(threshold)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t,
                                                 torch.zeros_like(x)))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    bx = float(beta) * x
    return torch.where(bx > float(threshold), x,
                       _softplus(bx) / float(beta))


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > float(threshold), x, torch.zeros_like(x))


def softmax(x, axis=-1, dtype=None, name=None):
    """softmax along axis (an integer input in its inexact type), cast to
    `dtype` after."""
    x = _inexact(x)
    out = torch.softmax(x, int(axis))
    return out if dtype is None else out.to(convert_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _inexact(x)
    out = torch.log_softmax(x, int(axis))
    return out if dtype is None else out.to(convert_dtype(dtype))


def _inexact(x):
    return x.to(to_inexact(x.dtype)) if not (
        x.is_floating_point() or x.is_complex()) else x


def prelu(x, weight, data_format="NCHW", name=None):
    """x where positive, weight * x elsewhere; a weight of more than one
    element is per channel (axis 1)."""
    w = weight
    if w.dim() == 1 and w.shape[0] > 1 and x.dim() > 1:
        w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, w * x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    axis = int(axis) % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // int(groups)
    shape.insert(axis + 1, int(groups))
    return torch.amax(x.reshape(shape), axis + 1)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along axis, epsilon)."""
    p = float(p)
    n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), int(axis),
                            keepdim=True), 1.0 / p)
    return x / torch.clamp(n, min=float(epsilon))


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """[..., maxlen] with 1 where the position is below the length."""
    ml = int(lengths.max()) if maxlen is None else int(maxlen)
    pos = torch.arange(ml, device=lengths.device)
    return (pos < lengths[..., None]).to(convert_dtype(dtype))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    n = label.shape[-1]
    return label * (1 - float(epsilon)) + float(epsilon) / n


def linear(x, weight, bias=None):
    """x @ weight^T + bias (torch's [out, in] weight); under auto_cast
    the reference's `linear` op: f32 inputs in the AMP dtype."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return torch.nn.functional.linear(x, weight, bias)


def scalar_like(x, c: float):
    """A Python scalar as JAX takes it beside `x` (weakly typed): rounded
    to x's dtype, where torch would keep it in f32 for a bf16 product."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def _mask_shape(shape, axis):
    if axis is None:
        return tuple(shape)
    axes = [axis] if isinstance(axis, int) else list(axis)
    return tuple(s if i in axes else 1 for i, s in enumerate(shape))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """The reference's dropout: in training, one key from the default
    generator and a mask over x's shape (over the `axis` dims only,
    broadcast over the rest) keeping where uniform < 1 - p; kept elements
    scaled by 1/(1 - p) ("upscale_in_train") or not ("downscale_in_infer",
    which scales by 1 - p outside training)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * scalar_like(x, 1 - p)
        return x
    key = _rng.next_key().to(x.device)
    keep = _rng.bernoulli(key, 1.0 - p, _mask_shape(x.shape, axis))
    kept = x / scalar_like(x, 1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, scalar_like(x, 0.0))


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    return dropout(x, p=p, axis=[0, 1], training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU-preserving dropout: dropped elements take alpha' = -alpha *
    scale, then a * (...) + b restores mean and variance."""
    if not training or p == 0.0:
        return x
    key = _rng.next_key().to(x.device)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _rng.bernoulli(key, 1.0 - p, x.shape)
    a = (1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))) if p < 1 else 1.0
    b = -a * alpha_p * p
    dropped = torch.where(keep, x, scalar_like(x, alpha_p))
    return scalar_like(x, a) * dropped + scalar_like(x, b)


class _LayerNorm(torch.autograd.Function):
    """The forward of `layer_norm`; the backward is LayerNorm's own
    gradient from x (in its own dtype), the rounded mean and 1/std, the
    only tensors kept. (Autograd through the forward would keep an f32 copy
    of x for the variance, and x - mean and the normalised x besides, and
    run about ten element-wise kernels.) dx comes from torch's fused
    LayerNorm backward (f32 inside), given g * weight rounded to g's dtype
    as the reference's autodiff rounds it; dweight and dbias are f32 sums
    over the rows (the fused kernel's bf16 path on the CPU sums them in
    bf16)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dims, epsilon):
        var, mean = torch.var_mean(x.float(), dims, correction=0,
                                   keepdim=True)
        mean = mean.to(x.dtype)
        rstd = torch.rsqrt(var.to(x.dtype) + epsilon)
        out = (x - mean) * rstd
        if weight is not None:
            out = out * weight
        if bias is not None:
            out = out + bias
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        ctx.shape = x.shape[dims[0]:]
        return out

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        # the dtype the fused kernel takes statistics in: f32 on a card,
        # x's on the CPU; exact either way, they hold x's dtype's values
        stats = torch.float32 if x.is_cuda else x.dtype
        mean, rstd = mean.to(stats), rstd.to(stats)
        bwd = torch.ops.aten.native_layer_norm_backward
        need = ctx.needs_input_grad
        dx = dw = db = None
        if need[0]:
            gw = g if weight is None else g * weight
            dx = bwd(gw, x, ctx.shape, mean, rstd, None, None,
                     [True, False, False])[0]
        rows = tuple(range(x.dim() - len(ctx.shape)))
        if weight is not None and need[1]:
            xhat = (x - mean.float()) * rstd.float()
            dw = (g * xhat).sum(rows).to(weight.dtype)
        if bias is not None and need[2]:
            db = g.sum(rows, dtype=torch.float32).to(bias.dtype)
        return dx, dw, db, None, None


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """The reference's arithmetic (`_layer_norm_p`, under O2 on bf16
    activations too): mean and variance reduced in f32 and rounded to x's
    dtype, the normalisation, scale and shift in x's dtype. Under
    auto_cast (black-listed) its AMP-dtype inputs run in f32."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    return _LayerNorm.apply(x, weight, bias, dims, epsilon)


def _attention_probs(q, k, v, mask, is_causal, scale):
    """Einsum attention core ([B, L, H, D] in): softmax probabilities and
    head-major V. The causal mask is bottom-right aligned (tril with
    k = kl - ql) and masked logits are -inf, as in the reference. An
    additive mask of a wider dtype (BERT's f32 mask on bf16 scores)
    promotes the scores, and then V, as JAX promotes them."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(ql, kl, dtype=torch.bool,
                        device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    dt = torch.promote_types(probs.dtype, vh.dtype)
    return probs.to(dt), vh.to(dt)


def _chunk_out(qc, kh, vh, causal, s, start):
    """One query chunk of `_chunked_attention`: f32 scores (products of
    the inputs' values, summed in f32, as the reference's
    preferred_element_type=f32 einsum), masked to -1e30, softmax, the
    probabilities in V's dtype times V."""
    logits = torch.einsum("bhqd,bhkd->bhqk", qc.float(), kh.float()) * s
    if causal:
        n, L = qc.shape[2], kh.shape[2]
        qpos = start + torch.arange(n, device=qc.device)
        m = torch.arange(L, device=qc.device)[None, :] <= qpos[:, None]
        logits = torch.where(m[None, None], logits,
                             torch.tensor(-1e30, device=qc.device))
    p = torch.softmax(logits, dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vh)


def _chunked_attention(qh, kh, vh, causal, s, chunk):
    """The reference's `_chunked_attention` ([B, H, L, D] in, [B, L, H, D]
    out): exact attention over query chunks of `chunk` rows, each chunk's
    full-row softmax; each chunk is checkpointed (its scores recomputed in
    backward), as the reference's jax.checkpoint per chunk."""
    outs = []
    for start in range(0, qh.shape[2], chunk):
        qc = qh[:, :, start:start + chunk]
        if torch.is_grad_enabled():
            out = checkpoint(_chunk_out, qc, kh, vh, causal, s, start,
                             use_reentrant=False)
        else:
            out = _chunk_out(qc, kh, vh, causal, s, start)
        outs.append(out)
        CHUNKED_CALLS["chunks"] += 1
    return torch.cat(outs, dim=2).transpose(1, 2)


def _sdpa_dropout(q, k, v, key, mask, dropout_p, is_causal, scale):
    """The reference's `_sdpa_dropout_fn`: the einsum probabilities, then
    dropout on them (mask from `key`, kept ones scaled by 1/(1 - p))."""
    probs, vh = _attention_probs(q, k, v, mask, is_causal, scale)
    keep = _rng.bernoulli(key.to(q.device), 1.0 - dropout_p, probs.shape)
    probs = torch.where(keep, probs / scalar_like(probs, 1.0 - dropout_p),
                        scalar_like(probs, 0.0))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True,
                                 scale=None):
    """Attention on the [B, L, H, D] layout, routed as the reference's
    `scaled_dot_product_attention`: with `dropout_p` > 0 in training, the
    einsum with dropout on the probabilities (one key from the default
    generator), never flash. Otherwise as `_sdpa_p`: with
    FLAGS_use_flash_attention on, no mask, q, k and v of one shape and a
    shape that passes the gate, the flash kernels under the dot strategy
    FLAGS_flash_dot_impl resolves to; else, at L >= 1024 with no mask and
    L a multiple of FLAGS_attention_chunk (above it), the chunked query
    scan; else the einsum. The reference's backend gate has no
    counterpart: the flash path runs on the card and, through its plain
    versions, on the CPU."""
    if dropout_p and training:
        return _sdpa_dropout(q, k, v, _rng.next_key(), attn_mask,
                             float(dropout_p), bool(is_causal), scale)
    if (flag("use_flash_attention") and attn_mask is None
            and q.shape == k.shape == v.shape):
        bq, bk = int(flag("flash_block_q")), int(flag("flash_block_k"))
        if flash_attention_supported(q.shape, q.shape[-1], bool(is_causal),
                                     block_q=bq, block_k=bk):
            impl = resolve_dot_impl(q.device)
            # as the reference: an "f32" that "auto" picked takes flash only
            # from seq 2048, where the einsum's [L, L] scores would dominate
            # (f32-dot flash measured slower than einsum below that on a
            # TPU); an explicit f32 flag or force_flash_attention always does
            if (impl != "f32" or q.shape[1] >= 2048
                    or flag("flash_dot_impl") == "f32"
                    or flag("force_flash_attention")):
                return flash_attention(q, k, v, causal=bool(is_causal),
                                       sm_scale=scale, block_q=bq,
                                       block_k=bk, impl=impl)
    chunk = int(flag("attention_chunk"))
    L = q.shape[1]
    if (chunk > 0 and attn_mask is None and L == k.shape[1] and L >= 1024
            and L % chunk == 0 and L > chunk):
        s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        s = float(torch.tensor(s, dtype=torch.float32))
        return _chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), bool(is_causal), s,
                                  chunk)
    probs, vh = _attention_probs(q, k, v, attn_mask, is_causal, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


# ------------------------------------------------------------ embedding --
def embedding(x, weight, padding_idx=None):
    """weight's rows at the ids x; with `padding_idx`, the output at those
    ids is zero (the reference multiplies by the mask, so the row's
    gradient from them is zero too), where torch's embedding returns the
    row."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


# ---------------------------------------------------------- convolution --
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """The reference's padding forms: an int, a list of ints (one a
    dimension), a list of 2*nd ints or of (lo, hi) pairs, or the strings
    SAME and VALID; as [(lo, hi)] * nd or the upper-cased string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _same_pads(spatial, kernel, stride, dilation):
    """XLA's SAME: an output of ceil(in / stride), the padding it needs
    around the dilated kernel split with the odd one at the end."""
    pads = []
    for s, k, st, d in zip(spatial, kernel, stride, dilation):
        out = -(-s // st)
        total = max((out - 1) * st + (k - 1) * d + 1 - s, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """x [N, C, *spatial] padded by [(lo, hi)] per spatial dim."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x
    return torch.nn.functional.pad(x, flat, value=value)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """The reference's `conv2d` (lax.conv_general_dilated): weight
    [out, in / groups, kh, kw], every padding form of `_conv_padding`
    (SAME as XLA pads it, at any stride; uneven pairs padded explicitly,
    which torch's own padding argument cannot take). Under auto_cast its
    f32 inputs run in the AMP dtype (white-listed)."""
    x, weight, bias = cast_inputs("conv2d", x, weight, bias)
    stride, dilation = _pair(stride), _pair(dilation)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    pads = _conv_padding(padding, 2)
    if pads == "VALID":
        pads = [(0, 0), (0, 0)]
    elif pads == "SAME":
        pads = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = torch.nn.functional.conv2d(x, weight, bias, stride,
                                         tuple(lo for lo, _ in pads),
                                         dilation, int(groups))
    else:
        out = torch.nn.functional.conv2d(_pad_spatial(x, pads), weight, bias,
                                         stride, 0, dilation, int(groups))
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


# -------------------------------------------------------------- pooling --
def _pool_pads(spatial, ks, st, padding, ceil_mode):
    """Per-dim (lo, hi) pads (the reference's `_pool_pads`): ceil_mode
    adds the trailing padding that grows the output to
    ceil((s + 2p - k) / st) + 1, less one where the last window would
    start past the input and its left pad."""
    pads = []
    for s_in, k, stp, p in zip(spatial, ks, st, padding):
        hi = p
        if ceil_mode:
            out = -(-(s_in + 2 * p - k) // stp) + 1
            if (out - 1) * stp >= s_in + p:
                out -= 1
            need = (out - 1) * stp + k - (s_in + 2 * p)
            if need > 0:
                hi = p + need
        pads.append((p, hi))
    return pads


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """The reference's max pooling (reduce_window over -inf pads): the
    pads of `_pool_pads` explicitly, then windows that fit."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    pads = _pool_pads(x.shape[2:], ks, st, _pair(padding), bool(ceil_mode))
    init = (float("-inf") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    return torch.nn.functional.max_pool2d(_pad_spatial(x, pads, init), ks,
                                          st)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None):
    """The reference's average pooling: window sums over zero pads,
    divided by `divisor_override`, else (exclusive, with any pad) by each
    window's count of input elements, else by the window's size."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    pads = _pool_pads(x.shape[2:], ks, st, _pair(padding), bool(ceil_mode))

    def sums(t):
        return torch.nn.functional.avg_pool2d(_pad_spatial(t, pads), ks, st,
                                              divisor_override=1)

    summed = sums(x)
    if divisor_override is not None:
        return summed / divisor_override
    if exclusive and any(lo or hi for lo, hi in pads):
        return summed / sums(torch.ones_like(x[:1, :1]))
    return summed / (ks[0] * ks[1])


def adaptive_avg_pool2d(x, output_size):
    """The reference's adaptive average pooling: output cell i averages
    rows floor(i h / oh) to floor((i + 1) h / oh) (torch's windows end at
    the ceiling, so the two differ where oh does not divide h); a reshape
    and mean where it does."""
    n, c, h, w = x.shape
    oh, ow = _pair(output_size)
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    hs = [(i * h) // oh for i in range(oh + 1)]
    ws = [(j * w) // ow for j in range(ow + 1)]
    rows = [torch.stack([x[:, :, hs[i]:hs[i + 1] or h,
                           ws[j]:ws[j + 1] or w].mean(dim=(2, 3))
                         for j in range(ow)], dim=-1) for i in range(oh)]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------- batch norm --
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """The reference's batch norm. In training: the batch's mean and
    biased variance (over every dim but the channel's) normalise x, and
    the running buffers become momentum * running + (1 - momentum) *
    batch, the biased variance included (torch's own batch norm weighs
    the other way round and keeps the unbiased variance, so it is not
    let near the buffers); they are written in place, outside autograd.
    Otherwise (or with `use_global_stats`) the running statistics
    normalise x."""
    if use_global_stats:
        training = False
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = -1
    if training:
        axes = tuple(i for i in range(x.dim()) if i != ch)
        var, mean = torch.var_mean(x, dim=axes, correction=0)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


# -------------------------------------------------------- cross-entropy --
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """The reference's `cross_entropy`: log-softmax over `axis` (or the
    log of `input` floored at 1e-30 without `use_softmax`); hard labels
    (squeezed along `axis` when they keep it) with `ignore_index`, class
    `weight`, `label_smoothing` (a smoothed one-hot target), or
    `soft_label` targets. reduction "mean" divides by the count of kept
    labels, or with `weight` by the sum of their weights; "sum"; or "none".
    Under auto_cast its AMP-dtype inputs run in f32 (black-listed)."""
    input, label, weight = cast_inputs("cross_entropy", input, label,
                                       weight)
    axis = axis % input.dim()
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(input.clamp(min=1e-30)))
    n_classes = input.shape[axis]
    if soft_label:
        tgt = label
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(tgt * logp).sum(dim=axis)
        valid = torch.ones(loss.shape, dtype=torch.bool, device=loss.device)
    else:
        lab = label.squeeze(axis) if label.dim() == input.dim() else label
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        if label_smoothing > 0:
            onehot = torch.nn.functional.one_hot(safe, n_classes).movedim(
                -1, axis).to(logp.dtype)
            tgt = onehot * (1 - label_smoothing) + label_smoothing / n_classes
            loss = -(tgt * logp).sum(dim=axis)
        else:
            loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if weight is not None:
            loss = loss * weight[safe]
        loss = torch.where(valid, loss, scalar_like(loss, 0.0))
    if reduction == "mean":
        if weight is not None and not soft_label:
            wsum = torch.where(valid, weight[safe],
                               scalar_like(weight, 0.0)).sum()
            return loss.sum() / wsum.clamp(min=1e-12)
        return loss.sum() / valid.to(loss.dtype).sum().clamp(min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
