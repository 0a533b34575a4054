"""The port's op surface around the ops themselves, against the JAX
package: result dtypes (the promotion table of tensor dtype against
Python bool, int, float and tensor operands, taken from the reference
and held against it live for the Python operands), `to_tensor`'s dtype
rules and copy, dtypes and places (`set_device("cpu")` and its restore,
the card's place raising without a card, creation ops on it raising),
the random ops' streams after `seed(s)` (bitwise but for the normals'
erfinv and a uniform scaled into [min, max), within a few units in the
last place), the package's top-level
names, and name parity: every public name of the reference's op modules
and of its nn.functional exists in the port or waits in WAITING with its
queue item (ROADMAP.md, queue 1)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.core.dtype import convert_dtype, dtype_to_str

torch.set_num_threads(1)

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64"]


@pytest.fixture(autouse=True)
def _cpu_place(monkeypatch):
    # the current place is process state: the CPU for each test, the
    # place it had put back after it (the isolation tests need the card's)
    monkeypatch.setattr(_place, "_current", _place.CPUPlace())


def _name(t):
    if isinstance(t, torch.Tensor):
        return dtype_to_str(t.dtype)
    return np.dtype(t.dtype).name


def _port_tensor(d):
    if d == "bool":
        return port.to_tensor(np.array([True, False]))
    return port.to_tensor(np.array([1, 2])).to(convert_dtype(d))


# -------------------------------------------------------- promotion table --
# add(tensor of the row's dtype, operand), read once from the reference
# (JAX with x64 on: paddle_tpu.add on [1, 2] cast to each dtype): the
# operands are a Python bool, int and float, then a tensor of each of
# DTYPES. The op rows of test_torch_ops.py hold the reference live.
OPERANDS = [True, 2, 1.5] + DTYPES
PROMOTION = {
    "bool": ["bool", "int64", "float64", "bool", "uint8", "int8", "int16",
             "int32", "int64", "float16", "bfloat16", "float32", "float64"],
    "uint8": ["uint8", "uint8", "float64", "uint8", "uint8", "int16",
              "int16", "int32", "int64", "float16", "bfloat16", "float32",
              "float64"],
    "int8": ["int8", "int8", "float64", "int8", "int16", "int8", "int16",
             "int32", "int64", "float16", "bfloat16", "float32", "float64"],
    "int16": ["int16", "int16", "float64", "int16", "int16", "int16",
              "int16", "int32", "int64", "float16", "bfloat16", "float32",
              "float64"],
    "int32": ["int32", "int32", "float64", "int32", "int32", "int32",
              "int32", "int32", "int64", "float16", "bfloat16", "float32",
              "float64"],
    "int64": ["int64", "int64", "float64", "int64", "int64", "int64",
              "int64", "int64", "int64", "float16", "bfloat16", "float32",
              "float64"],
    "float16": ["float16", "float16", "float16", "float16", "float16",
                "float16", "float16", "float16", "float16", "float16",
                "float32", "float32", "float64"],
    "bfloat16": ["bfloat16", "bfloat16", "bfloat16", "bfloat16",
                 "bfloat16", "bfloat16", "bfloat16", "bfloat16",
                 "bfloat16", "float32", "bfloat16", "float32", "float64"],
    "float32": ["float32"] * 12 + ["float64"],
    "float64": ["float64"] * 13,
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_promotion_table(dtype):
    """The port's add over every operand gives the table's dtype."""
    for operand, want in zip(OPERANDS, PROMOTION[dtype]):
        y = _port_tensor(operand) if isinstance(operand, str) else operand
        assert _name(port.add(_port_tensor(dtype), y)) == want, \
            (dtype, operand)


# the result dtype of each op kind by input dtype (bool, int32, int64,
# bfloat16, float32), read from the reference
UNARY_DTYPES = {
    "exp": ["float32", "float32", "float64", "bfloat16", "float32"],
    "square": ["int32", "int32", "int64", "bfloat16", "float32"],
    "floor": ["bool", "int32", "int64", "bfloat16", "float32"],
    "abs": ["bool", "int32", "int64", "bfloat16", "float32"],
    "angle": ["float64", "float64", "float64", "bfloat16", "float32"],
    "logit": ["float64", "float64", "float64", "bfloat16", "float32"],
    "isnan": ["bool"] * 5,
    "sum": ["int64", "int64", "int64", "bfloat16", "float32"],
    "mean": ["float32", "float32", "float64", "bfloat16", "float32"],
    "cumsum": ["int64", "int32", "int64", "bfloat16", "float32"],
    "median": ["float32", "float32", "float64", "bfloat16", "float32"],
    "max": ["bool", "int32", "int64", "bfloat16", "float32"],
}


@pytest.mark.parametrize("op", sorted(UNARY_DTYPES))
def test_result_dtype_by_input_dtype(op):
    for d, want in zip(["bool", "int32", "int64", "bfloat16", "float32"],
                       UNARY_DTYPES[op]):
        assert _name(getattr(port, op)(_port_tensor(d))) == want, (op, d)


def test_the_rules_the_reference_differs_from_torch_by():
    i32 = port.to_tensor([1, 2, 3], dtype="int32")
    assert port.add(i32, 1.5).dtype == torch.float64
    assert port.pow(i32, 2.0).dtype == torch.float64
    assert port.sqrt(i32).dtype == torch.float32
    assert port.mean(i32).dtype == torch.float32
    u8, i8 = _port_tensor("uint8"), _port_tensor("int8")
    assert port.add(u8, i8).dtype == torch.int16
    assert port.sum(port.to_tensor([True, False, True])).item() == 2
    assert port.sum(port.to_tensor([True])).dtype == torch.int64
    assert float(port.median(port.to_tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5
    # argsort descending flips a stable ascending sort; topk's ties come
    # lower index first; mode is the smallest most frequent value
    t = port.to_tensor([2.0, 1.0, 2.0, 1.0])
    assert port.argsort(t, descending=True).tolist() == [2, 0, 3, 1]
    assert port.topk(t, 2)[1].tolist() == [0, 2]
    v, i = port.mode(port.to_tensor([[1, 2, 2, 1]]))
    assert (v.tolist(), i.tolist()) == ([1], [0])


# ---------------------------------------------------------------- to_tensor --
TO_TENSOR_CASES = [
    ("py_float", 1.5, None), ("py_int", 3, None), ("py_bool", True, None),
    ("py_complex", 1 + 2j, None),
    ("float_list", [[1.0, 2.5], [3.0, 4.0]], None),
    ("int_list", [1, 2, 3], None), ("bool_list", [True, False], None),
    ("np_f64", np.arange(4, dtype=np.float64), None),
    ("np_i32", np.arange(4, dtype=np.int32), None),
    ("np_f32_as_f16", np.arange(4, dtype=np.float32), "float16"),
    ("list_as_int32", [1.7, -2.2], "int32"),
    ("np_bf16", np.arange(3, dtype=np.float32).astype(jnp.bfloat16), None),
]


@pytest.mark.parametrize("data,dtype", [c[1:] for c in TO_TENSOR_CASES],
                         ids=[c[0] for c in TO_TENSOR_CASES])
def test_to_tensor_against_the_reference(data, dtype):
    want = ref.to_tensor(data, dtype=dtype)
    got = port.to_tensor(data, dtype=dtype)
    assert _name(got) == _name(want)
    assert got.device.type == "cpu"
    w = np.asarray(want.numpy())
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_to_tensor_copies_and_gradients():
    a = np.ones(3, np.float32)
    t = port.to_tensor(a, stop_gradient=False)
    a[0] = 7.0
    assert t[0].item() == 1.0 and t.requires_grad
    assert not port.to_tensor(a).requires_grad
    # an integer tensor takes no gradient flag (torch refuses one)
    assert not port.to_tensor([1, 2], stop_gradient=False).requires_grad
    # a tensor keeps its device with no place, and is copied
    s = port.to_tensor(t)
    assert s.device == t.device and not s.requires_grad
    assert s.data_ptr() != t.data_ptr()
    assert port.to_tensor([1.0], place=port.CPUPlace()).device.type == "cpu"
    assert port.to_tensor([1.0], place="cpu").device.type == "cpu"


# ------------------------------------------------------------- dtypes ------
SPELLINGS = ["float32", np.float32, np.dtype("int64"), "bool", bool, int,
             float, "bfloat16", jnp.bfloat16, "complex64", np.uint8,
             "int16", "float16", np.float64]


@pytest.mark.parametrize("spelling", SPELLINGS, ids=str)
def test_convert_dtype_spellings(spelling):
    from paddle_tpu.core.dtype import convert_dtype as ref_convert

    want = np.dtype(ref_convert(spelling)).name
    assert dtype_to_str(convert_dtype(spelling)) == want
    assert convert_dtype(convert_dtype(spelling)) == convert_dtype(spelling)


def test_dtype_predicates_and_names():
    from paddle_tpu.core import dtype as rd

    from paddle_tpu_torch.core import dtype as pd

    for d in DTYPES + ["complex64", "complex128"]:
        for f in ("is_floating", "is_integer", "is_complex"):
            assert getattr(pd, f)(d) == bool(getattr(rd, f)(rd.convert_dtype(
                d))), (f, d)
        assert pd.dtype_to_str(d) == d
        assert getattr(port, d if d != "bool" else "bool_") == \
            convert_dtype(d)
    assert port.bool is torch.bool and port.dtype is torch.dtype
    with pytest.raises(ValueError):
        convert_dtype("float31")
    assert port.iinfo("int32").max == np.iinfo(np.int32).max
    assert port.finfo("float32").eps == np.finfo(np.float32).eps
    assert port.finfo(port.bfloat16).eps == 2.0 ** -7


# ------------------------------------------------------------- places ------
def test_set_device_cpu_and_places():
    assert port.set_device("cpu") == port.CPUPlace()
    assert port.get_device() == "cpu"
    assert port.zeros([2]).device.type == "cpu"
    assert port.default_device() == torch.device("cpu")
    assert port.resolve_device(None) == torch.device("cpu")
    assert port.resolve_device("cpu") == torch.device("cpu")
    assert port.is_compiled_with_cuda()
    assert port.CUDAPinnedPlace is port.CPUPlace
    assert repr(port.CPUPlace()) == "Place(cpu)"
    with pytest.raises(ValueError):
        port.set_device("xpu")


@pytest.mark.parametrize("given,want", [
    (None, "cpu"), ("cpu", "cpu"), ("gpu", "cuda"), ("gpu:1", "cuda:1"),
    ("tpu", "cuda"), ("cuda:0", "cuda:0"), (torch.device("cpu"), "cpu"),
    (_place.CPUPlace(), "cpu"), (_place.Place("cuda:2"), "cuda:2")])
def test_one_resolver_for_places_and_entry_points(given, want):
    """to_tensor's place= and the entry points' device= go through one
    resolver, which takes a Place and the reference's names."""
    port.set_device("cpu")
    assert port.resolve_device(given) == torch.device(want)
    from paddle_tpu_torch.core import tensor as ttensor
    from paddle_tpu_torch.models import gpt as tgpt

    assert ttensor.resolve_device is port.resolve_device
    assert tgpt.resolve_device is port.resolve_device
    assert port.default_device is port.current_device


def test_the_card_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("gpu", "gpu:0", "cuda", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.set_device(name)
    assert port.get_device() == "cpu"       # a failed switch changes nothing
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.CUDAPlace(0)
    monkeypatch.setattr(_place, "_current", _place.Place("cuda:0"))
    assert port.get_device() == "gpu:0"
    for make in (lambda: port.zeros([2]), lambda: port.to_tensor([1.0]),
                 lambda: port.randn([2]), lambda: port.arange(3),
                 lambda: port.default_device(),
                 lambda: port.resolve_device(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ----------------------------------------------------------- random streams --
def _draws(P):
    """A mixed sequence of the random ops, as numpy arrays."""
    probs = P.to_tensor(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    rates = P.to_tensor(np.array([0.0, 0.5, 3.0, 9.5, 12.0, 40.0],
                                 np.float32))
    # one shape where the op allows it: the reference compiles each
    # random function once a shape
    out = [P.rand([3, 4]), P.randint(0, 10, [3, 4]),
           P.randint(-5, 1 << 40, [3, 4]),
           P.randperm(2000, "int32"),
           P.bernoulli(P.to_tensor(np.full((3, 4), 0.3, np.float32))),
           P.multinomial(probs, 3), P.multinomial(probs, 5, True),
           P.uniform([3, 4], seed=7),
           P.rand([3, 4], "float64"), P.rand([3, 4], "bfloat16"),
           P.poisson(rates), P.rand([3, 4])]
    # within a few ulps: the normals' erfinv, and a uniform scaled into
    # [min, max), where XLA's CPU code contracts u * (max - min) + min
    # into a fused multiply-add in some lanes
    normals = [P.uniform([3, 4], min=-2.0, max=3.0), P.randn([3, 4]),
               P.normal(P.to_tensor(np.zeros(3, np.float32)),
                        P.to_tensor(np.ones(3, np.float32)))]
    return [_arr(v) for v in out], [_arr(v) for v in normals]


def _arr(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy(), \
            _name(v)
    a = np.asarray(v.numpy())
    name = np.dtype(v.dtype).name
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def _check_streams(got, want):
    (g_exact, g_norm), (w_exact, w_norm) = got, want
    for i, ((g, gn), (w, wn)) in enumerate(zip(g_exact, w_exact)):
        assert gn == wn, (i, gn, wn)
        np.testing.assert_array_equal(g, w, err_msg=f"draw {i}")
    for i, ((g, gn), (w, wn)) in enumerate(zip(g_norm, w_norm)):
        assert gn == wn, (i, gn, wn)
        # sqrt(2) * erfinv(u) through two erfinv series: a few ulps
        np.testing.assert_allclose(g, w, rtol=4 * np.finfo(g.dtype).eps,
                                   atol=4 * np.finfo(g.dtype).eps,
                                   err_msg=f"normal {i}")


def test_seeded_random_streams_are_the_reference():
    ref.seed(1234)
    port.seed(1234)
    _check_streams(_draws(port), _draws(ref))
    # both generators stand at the same counter afterwards
    assert port.get_rng_state() == [tuple(ref.get_rng_state()[0])]


def test_rng_state_replays_the_stream():
    port.seed(5)
    port.rand([2])
    state = port.get_rng_state()
    first = _draws(port)
    port.set_rng_state(state)
    _check_streams(_draws(port), first)


def test_poisson_moments():
    """Beyond the bitwise draws above: the rates' means and variances."""
    port.seed(3)
    lam = port.to_tensor(np.repeat(np.array([0.7, 4.0, 25.0], np.float32),
                                   4000).reshape(3, 4000))
    k = port.poisson(lam).double()
    for row, rate in zip(k, (0.7, 4.0, 25.0)):
        assert abs(row.mean().item() - rate) < 4 * (rate / 4000) ** 0.5
        assert abs(row.var().item() / rate - 1) < 0.12


# ---------------------------------------------------------- top-level names --
def test_top_level_api():
    assert port.Tensor is torch.Tensor
    x = port.to_tensor([1.0, 2.0], stop_gradient=False)
    y = port.sum(port.multiply(x, x))
    (g,) = port.grad(y, x)
    assert g.tolist() == [2.0, 4.0] and x.grad is None
    z = port.to_tensor([3.0], stop_gradient=False)
    with pytest.raises(ValueError, match="unreachable"):
        port.grad(port.sum(port.multiply(x, 2.0)), [x, z])
    assert port.grad(port.sum(port.multiply(x, 2.0)), [x, z],
                     allow_unused=True)[1] is None
    with port.no_grad():
        assert not port.is_grad_enabled()
        assert not port.multiply(x, 2.0).requires_grad
    with port.set_grad_enabled(False):
        with port.enable_grad():
            assert port.is_grad_enabled()
    w = port.create_parameter([4, 3], "float32")
    b = port.create_parameter([3], "float32", is_bias=True)
    assert w.requires_grad and tuple(w.shape) == (4, 3) and \
        not b.abs().sum().item()
    assert port.broadcast_shape([2, 1, 3], [4, 3]) == [2, 4, 3]
    assert list(port.batch(lambda: iter(range(5)), 2)()) == \
        [[0, 1], [2, 3], [4]]
    with port.LazyGuard():
        pass
    port.check_shape([2, -1])
    with pytest.raises(ValueError):
        port.check_shape([2, -3])
    assert port.get_default_dtype() == "float32"
    assert port.in_dynamic_mode()
    port.enable_static()
    assert not port.in_dynamic_mode()
    port.disable_static()
    from paddle_tpu_torch import framework_io

    assert port.save is framework_io.save and port.load is framework_io.load
    # the builtins the ops shadow stay the ops
    assert port.max is port.ops.max and port.abs is port.ops.abs


def test_inplace_variants():
    x = port.to_tensor([1.0, 4.0, 9.0])
    assert port.sqrt_(x) is x and x.tolist() == [1.0, 2.0, 3.0]
    port.exp_(port.zero_(x))
    assert x.tolist() == [1.0, 1.0, 1.0]
    port.masked_fill_(x, port.to_tensor([True, False, False]), 5.0)
    assert x.tolist() == [5.0, 1.0, 1.0]


def test_importing_the_package_stays_light():
    """`import paddle_tpu_torch` loads the op modules, not nn, the kernels
    or the serving stack: neither the package's __init__ nor core/ nor
    ops/ (the kernels' modules aside) imports another subpackage at the
    top level; a subpackage loads when first named."""
    import ast
    from pathlib import Path

    root = Path(port.__file__).parent
    light = [root / "__init__.py", *sorted((root / "core").glob("*.py")),
             *(p for p in sorted((root / "ops").glob("*.py"))
               if p.name not in ("flash_attention.py", "_build.py"))]
    heavy = ("nn", "inference", "optimizer", "io", "jit", "models", "amp",
             "hapi", "distributed", "vision", "profiler", "flash_attention")
    for path in light:
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.level:
                parts = (node.module or "").split(".")
                assert not set(parts) & set(heavy), (path.name, node.module)
    assert port.nn is importlib.import_module("paddle_tpu_torch.nn")


# ------------------------------------------------------------ name parity --
WAITING = {
    "queue 1 item 2: linalg's factorizations and solves": [
        "cholesky", "cholesky_solve", "inverse", "inv", "det", "slogdet",
        "svd", "qr", "eigh", "eigvalsh", "eig", "solve", "triangular_solve",
        "lstsq", "matrix_rank", "pinv", "lu", "lu_unpack",
        "householder_product", "eigvals", "cond"],
    "queue 1 item 2: fft": [
        "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
        "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "fftshift",
        "ifftshift", "fftfreq", "rfftfreq", "hfft2", "ihfft2", "hfftn",
        "ihfftn"],
    "queue 1 item 2: signal": ["stft", "istft"],
    "queue 1 item 2: the rest of nn.functional": [
        "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
        "adaptive_max_pool2d", "adaptive_max_pool3d", "affine_grid",
        "avg_pool1d", "avg_pool3d", "bilinear", "binary_cross_entropy",
        "binary_cross_entropy_with_logits", "channel_shuffle",
        "class_center_sample", "conv1d", "conv1d_transpose",
        "conv2d_transpose", "conv3d", "conv3d_transpose",
        "cosine_embedding_loss", "cosine_similarity", "ctc_loss",
        "dice_loss", "elu_", "flash_attn_unpadded", "fold",
        "fused_linear_cross_entropy", "gather_tree", "gaussian_nll_loss",
        "grid_sample", "group_norm", "gumbel_softmax",
        "hinge_embedding_loss", "hsigmoid_loss", "instance_norm",
        "interpolate", "kl_div", "l1_loss", "local_response_norm",
        "log_loss", "margin_cross_entropy", "margin_ranking_loss",
        "max_pool1d", "max_pool3d", "max_unpool1d", "max_unpool2d",
        "max_unpool3d", "mse_loss", "multi_label_soft_margin_loss",
        "multi_margin_loss", "nll_loss", "npair_loss", "pairwise_distance",
        "pixel_shuffle", "pixel_unshuffle", "poisson_nll_loss", "relu_",
        "rnnt_loss", "rrelu", "sigmoid_focal_loss", "smooth_l1_loss",
        "soft_margin_loss", "softmax_", "softmax_with_cross_entropy",
        "sparse_attention", "square_error_cost", "tanh_", "temporal_shift",
        "triplet_margin_loss", "triplet_margin_with_distance_loss",
        "unfold", "upsample", "zeropad2d"],
}
_WAITING = {n for names in WAITING.values() for n in names}
REF_OP_MODULES = ["common", "creation", "math", "reduction", "logic",
                  "manipulation", "extras", "linalg", "fft", "signal"]


def _public(module, prefixes):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "").startswith(prefixes))


@pytest.mark.parametrize("modname", REF_OP_MODULES)
def test_every_reference_op_is_ported_or_waits(modname):
    mod = importlib.import_module(f"paddle_tpu.ops.{modname}")
    target = port.linalg if modname == "linalg" else port
    names = _public(mod, ("paddle_tpu.ops",))
    assert names
    missing = [n for n in names if not hasattr(target, n)
               and n not in _WAITING]
    assert not missing, f"not ported and not listed as waiting: {missing}"
    ported_waiting = [n for n in names if hasattr(target, n)
                      and n in _WAITING]
    assert not ported_waiting, f"ported: take off WAITING {ported_waiting}"


def test_every_reference_functional_is_ported_or_waits():
    import paddle_tpu.nn.functional as RF

    names = _public(RF, ("paddle_tpu.nn.functional", "paddle_tpu.ops"))
    missing = [n for n in names if not hasattr(PF, n) and n not in _WAITING]
    assert not missing, f"not ported and not listed as waiting: {missing}"
    ported_waiting = [n for n in names if hasattr(PF, n) and n in _WAITING]
    assert not ported_waiting, f"ported: take off WAITING {ported_waiting}"
    # and every waiting name is still one of the reference's
    for item, waiting in WAITING.items():
        for n in waiting:
            assert any(hasattr(importlib.import_module(
                f"paddle_tpu.ops.{m}"), n) for m in REF_OP_MODULES) or \
                hasattr(RF, n), (item, n)
