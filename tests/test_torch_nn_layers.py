"""The port's nn ops and layers behind BERT and ResNet (paddle_tpu_torch/nn)
against the JAX package's on the same seeded numpy inputs: outputs and
the gradients of every floating input, through each op's traps (the
embedding's zeroed padding rows, conv2d's padding forms with SAME at
stride 2, ceil-mode pooling, adaptive windows that end at the floor,
batch norm's momentum and biased running variance, cross-entropy's
options), the layers' state_dict keys, the AMP casts of conv2d and
cross_entropy, and that the new modules import neither jax nor the
reference. Tolerances (f32): outputs atol 1e-4, gradients relative 1e-4
of their largest entry, losses rtol 1e-5."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)

OUT_ATOL, GRAD_REL, LOSS_RTOL = 1e-4, 1e-4, 1e-5


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _run_both(jfn, tfn, arrays, seed=0):
    """Output and gradients (of sum(out * g), g seeded) of jfn on paddle
    tensors and of tfn on torch tensors of the same arrays; integer arrays
    get no gradient."""
    jin = [paddle.to_tensor(a, stop_gradient=not np.issubdtype(
        a.dtype, np.floating)) for a in arrays]
    tin = [torch.tensor(a, requires_grad=bool(np.issubdtype(
        a.dtype, np.floating))) for a in arrays]
    jout, tout = jfn(*jin), tfn(*tin)
    g = np.random.default_rng(seed + 100).standard_normal(
        tuple(jout.shape)).astype(np.float32)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    grads = [(np.asarray(j.grad.numpy()), t.grad.numpy())
             for j, t in zip(jin, tin) if t.requires_grad]
    return np.asarray(jout.numpy()), tout.detach().numpy(), grads


def _check(jout, tout, grads):
    assert jout.shape == tout.shape
    np.testing.assert_allclose(tout, jout, atol=OUT_ATOL, rtol=0)
    for jg, tg in grads:
        assert _rel(tg, jg) <= GRAD_REL, _rel(tg, jg)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ embedding --
def test_embedding_zeroes_output_and_gradient_at_padding_idx():
    rng = np.random.default_rng(0)
    w = _normal(rng, 10, 6)
    ids = np.array([[0, 3, 3, 7], [3, 1, 9, 0]], np.int64)
    jout, tout, grads = _run_both(
        lambda i, w_: JF.embedding(i, w_, padding_idx=3),
        lambda i, w_: TF.embedding(i, w_, padding_idx=3), [ids, w])
    _check(jout, tout, grads)
    assert not tout[ids == 3].any()                       # output zero
    ((jg, tg),) = grads
    assert not tg[3].any() and not jg[3].any()            # row 3's grad
    # torch's own embedding returns the row there
    assert torch.nn.functional.embedding(torch.from_numpy(ids),
                                         torch.from_numpy(w))[0, 1].any()
    layer = tnn.Embedding(10, 6, padding_idx=3)
    assert not layer.weight[3].any()                     # zero at init
    assert tuple(layer.weight.shape) == tuple(
        jnn.Embedding(10, 6, padding_idx=3).weight.shape)


# ----------------------------------------------------------------- conv --
CONV_CASES = {
    "int": dict(padding=1),
    "per-dim": dict(padding=[1, 2]),
    "pairs": dict(padding=[(0, 1), (2, 0)]),
    "flat-pairs": dict(padding=[0, 1, 2, 0]),
    "same-stride1": dict(padding="SAME"),
    "same-stride2": dict(padding="same", stride=2),
    "same-stride2-dilated": dict(padding="SAME", stride=2, dilation=2),
    "valid-stride2": dict(padding="VALID", stride=2),
    "groups-bias": dict(padding=1, groups=2, bias=True),
    "stride-dilation": dict(padding=2, stride=(2, 1), dilation=(1, 2)),
}


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_padding_forms(case):
    kw = dict(CONV_CASES[case])
    bias = kw.pop("bias", False)
    groups = kw.get("groups", 1)
    rng = np.random.default_rng(1)
    arrays = [_normal(rng, 2, 4, 9, 8), _normal(rng, 6, 4 // groups, 3, 3)]
    if bias:
        arrays.append(_normal(rng, 6))
    jout, tout, grads = _run_both(lambda *a: JF.conv2d(*a, **kw),
                                  lambda *a: TF.conv2d(*a, **kw), arrays)
    _check(jout, tout, grads)
    if case == "same-stride2":
        # torch's own 'same' refuses any stride but 1
        with pytest.raises(RuntimeError):
            torch.nn.functional.conv2d(torch.from_numpy(arrays[0]),
                                       torch.from_numpy(arrays[1]),
                                       stride=2, padding="same")


def test_conv2d_nhwc():
    rng = np.random.default_rng(2)
    x, w = _normal(rng, 2, 7, 7, 3), _normal(rng, 5, 3, 3, 3)
    jout, tout, grads = _run_both(
        lambda *a: JF.conv2d(*a, padding="SAME", stride=2,
                             data_format="NHWC"),
        lambda *a: TF.conv2d(*a, padding="SAME", stride=2,
                             data_format="NHWC"), [x, w])
    _check(jout, tout, grads)


# -------------------------------------------------------------- pooling --
POOL_CASES = {
    "max": ("max", dict(kernel_size=3, stride=2, padding=1)),
    "max-ceil": ("max", dict(kernel_size=3, stride=2, padding=0,
                             ceil_mode=True)),
    "max-ceil-clamp": ("max", dict(kernel_size=2, stride=2, padding=1,
                                   ceil_mode=True)),
    "avg": ("avg", dict(kernel_size=2)),
    "avg-ceil-exclusive": ("avg", dict(kernel_size=3, stride=2, padding=1,
                                       ceil_mode=True)),
    "avg-inclusive": ("avg", dict(kernel_size=3, stride=2, padding=1,
                                  exclusive=False)),
    "avg-divisor": ("avg", dict(kernel_size=3, stride=1, padding=1,
                                divisor_override=4)),
}


@pytest.mark.parametrize("case", POOL_CASES)
def test_pooling(case):
    kind, kw = POOL_CASES[case]
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 3, 9, 8)
    jfn, tfn = ((JF.max_pool2d, TF.max_pool2d) if kind == "max"
                else (JF.avg_pool2d, TF.avg_pool2d))
    jout, tout, grads = _run_both(lambda a: jfn(a, **kw),
                                  lambda a: tfn(a, **kw), [x])
    _check(jout, tout, grads)
    if case == "max-ceil-clamp":
        # the clamp: a last window that would start in the right pad is
        # dropped, 9 -> 5 rows
        assert tout.shape[2] == 5


@pytest.mark.parametrize("hw,out", [((8, 8), (4, 2)), ((7, 9), (3, 4)),
                                    ((5, 5), (1, 1)), ((5, 6), (2, 3))])
def test_adaptive_avg_pool2d_windows_end_at_the_floor(hw, out):
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 3, *hw)
    jout, tout, grads = _run_both(
        lambda a: JF.adaptive_avg_pool2d(a, out),
        lambda a: TF.adaptive_avg_pool2d(a, out), [x])
    _check(jout, tout, grads)
    layer = tnn.AdaptiveAvgPool2D(out)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(layer, tout)
    mine = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x), out)
    if hw == (7, 9):
        # torch's windows end at the ceiling: another function here
        assert np.abs(mine.numpy() - jout).max() > 1e-3


# ----------------------------------------------------------- batch norm --
def test_batch_norm_three_training_steps_then_eval():
    """BatchNorm2D over 3 training calls (output, input and parameter
    gradients, both buffers after each: 0.9 running + 0.1 batch, the
    variance biased), then an eval call on the running statistics; and
    what torch's own batch norm would have left in the buffers."""
    rng = np.random.default_rng(5)
    jbn, tbn = jnn.BatchNorm2D(4), tnn.BatchNorm2D(4)
    w, b = 1 + _normal(rng, 4) * 0.1, _normal(rng, 4) * 0.1
    jbn.weight.set_value(w)
    jbn.bias.set_value(b)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(w))
        tbn.bias.copy_(torch.from_numpy(b))
    assert set(tbn.state_dict()) == set(jbn.state_dict())
    assert set(tbn.state_dict()) == {"weight", "bias", "_mean", "_variance"}
    for step in range(3):
        x = (3 * _normal(rng, 4, 4, 5, 5) + step).astype(np.float32)
        jout, tout, grads = _run_both(jbn, tbn, [x], seed=step)
        _check(jout, tout, grads)
        for name in ("weight", "bias"):
            jg = np.asarray(getattr(jbn, name).grad.numpy())
            tg = getattr(tbn, name).grad.numpy()
            assert _rel(tg, jg) <= GRAD_REL, name
            getattr(jbn, name).clear_grad()
            getattr(tbn, name).grad = None
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tbn, name).numpy(),
                np.asarray(getattr(jbn, name).numpy()), rtol=1e-6,
                atol=1e-6)
    jbn.eval()
    tbn.eval()
    x = _normal(rng, 2, 4, 5, 5)
    jout, tout, grads = _run_both(jbn, tbn, [x], seed=9)
    _check(jout, tout, grads)


def test_batch_norm_momentum_and_biased_variance():
    rng = np.random.default_rng(6)
    x = (2 * _normal(rng, 3, 2, 4, 4) + 1).astype(np.float32)
    mean, var = torch.zeros(2), torch.ones(2)
    TF.batch_norm(torch.from_numpy(x), mean, var, training=True)
    xb = x.astype(np.float64)
    bm, bv = xb.mean(axis=(0, 2, 3)), xb.var(axis=(0, 2, 3))
    np.testing.assert_allclose(mean.numpy(), 0.1 * bm, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), 0.9 + 0.1 * bv, rtol=1e-5)
    # torch's batch norm: momentum the other way, the unbiased variance
    m2, v2 = torch.zeros(2), torch.ones(2)
    torch.nn.functional.batch_norm(torch.from_numpy(x), m2, v2,
                                   training=True, momentum=0.9)
    assert np.abs(v2.numpy() - var.numpy()).max() > 1e-2


# -------------------------------------------------------- cross-entropy --
CE_CASES = {
    "plain": {},
    "ignore-index": dict(ignore_index=2),
    "weight": dict(weight=True),
    "weight-ignore": dict(weight=True, ignore_index=1),
    "smoothing": dict(label_smoothing=0.1),
    "smoothing-ignore": dict(label_smoothing=0.2, ignore_index=0),
    "soft-label": dict(soft_label=True),
    "soft-label-smoothing": dict(soft_label=True, label_smoothing=0.1),
    "axis1": dict(axis=1),
    "label-keeps-axis": dict(keep_axis=True),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none", ignore_index=3),
    "probabilities": dict(use_softmax=False),
}


@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_options(case):
    kw = dict(CE_CASES[case])
    rng = np.random.default_rng(7)
    C, axis = 5, kw.get("axis", -1)
    shape = (6, C, 3) if axis == 1 else (6, 3, C)
    logits = _normal(rng, *shape)
    if kw.pop("use_softmax", True) is False:
        logits = np.exp(logits) / np.exp(logits).sum(axis, keepdims=True)
        kw["use_softmax"] = False
    if kw.get("soft_label"):
        lab = rng.random(shape).astype(np.float32)
        lab /= lab.sum(axis, keepdims=True)
    else:
        lab = rng.integers(0, C, (6, 3)).astype(np.int64)
        if kw.pop("keep_axis", False):
            lab = lab[..., None]
    weight = (rng.random(C).astype(np.float32) + 0.5
              if kw.pop("weight", False) else None)

    def jfn(x, y):
        w = None if weight is None else paddle.to_tensor(weight)
        return JF.cross_entropy(x, y, weight=w, **kw)

    def tfn(x, y):
        w = None if weight is None else torch.from_numpy(weight)
        return tnn.CrossEntropyLoss(weight=w, **kw)(x, y)

    jout, tout, grads = _run_both(jfn, tfn, [logits, lab])
    np.testing.assert_allclose(tout, jout, rtol=LOSS_RTOL, atol=1e-6)
    jg, tg = grads[0]
    assert _rel(tg, jg) <= GRAD_REL


# ------------------------------------------------------ layers and AMP --
def test_activations_flatten_identity_and_containers():
    rng = np.random.default_rng(8)
    x = _normal(rng, 2, 3, 4)
    for jl, tl in ((jnn.ReLU(), tnn.ReLU()), (jnn.Tanh(), tnn.Tanh()),
                   (jnn.GELU(), tnn.GELU()),
                   (jnn.GELU(approximate=True), tnn.GELU(approximate=True)),
                   (jnn.Flatten(), tnn.Flatten()), (jnn.Identity(),
                                                    tnn.Identity())):
        jout, tout, grads = _run_both(jl, tl, [x])
        _check(jout, tout, grads)
    js = jnn.Sequential(jnn.Conv2D(3, 4, 3, bias_attr=False),
                        jnn.BatchNorm2D(4), jnn.ReLU())
    ts = tnn.Sequential(tnn.Conv2D(3, 4, 3, bias_attr=False),
                        tnn.BatchNorm2D(4), tnn.ReLU())
    assert list(ts.state_dict()) == list(js.state_dict())
    jl = jnn.LayerList([jnn.Linear(2, 2), jnn.Linear(2, 3)])
    tl = tnn.LayerList([tnn.Linear(2, 2), tnn.Linear(2, 3)])
    assert list(tl.state_dict()) == list(jl.state_dict())
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.Tanh()))
    assert [n for n, _ in named.named_children()] == ["a", "b"]


def test_conv_and_cross_entropy_cast_under_auto_cast():
    """conv2d (white list) runs f32 inputs in bf16 and cross_entropy
    (black list) bf16 logits in f32, in both packages; the bf16 conv's
    output within one bf16 step of the reference's."""
    rng = np.random.default_rng(9)
    x, w = _normal(rng, 2, 3, 8, 8), _normal(rng, 4, 3, 3, 3)
    with jamp.auto_cast(dtype="bfloat16"):
        jout = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                         padding=1)
    with amp.auto_cast(dtype="bfloat16"):
        tout = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         padding=1)
    assert "bfloat16" in str(jout.dtype) and tout.dtype == torch.bfloat16
    j = np.asarray(jout.numpy(), np.float32)
    assert np.abs(tout.float().numpy() - j).max() <= 2 ** -7 * np.abs(
        j).max()
    logits = _normal(rng, 4, 6)
    lab = rng.integers(0, 6, 4).astype(np.int64)
    jl = paddle.cast(paddle.to_tensor(logits), "bfloat16")
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    with jamp.auto_cast(dtype="bfloat16"):
        jloss = JF.cross_entropy(jl, paddle.to_tensor(lab))
    with amp.auto_cast(dtype="bfloat16"):
        tloss = TF.cross_entropy(tl, torch.from_numpy(lab))
    assert "float32" in str(jloss.dtype) and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                               rtol=LOSS_RTOL)


NEW_MODULES = ["paddle_tpu_torch.nn.container",
               "paddle_tpu_torch.nn.conv_pool", "paddle_tpu_torch.nn.loss",
               "paddle_tpu_torch.nn.transformer",
               "paddle_tpu_torch.ops.manipulation",
               "paddle_tpu_torch.models.bert",
               "paddle_tpu_torch.models.resnet", "paddle_tpu_torch.vision",
               "paddle_tpu_torch.vision.models"]


def test_new_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ml_dtypes', 'paddle_tpu'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
