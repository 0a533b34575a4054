"""The port's op surface (paddle_tpu_torch's top-level ops, its linalg
namespace and nn.functional's activations) against the JAX package's on
the same seeded numpy inputs, one table row per call, after the pattern
of tests/test_op_suite.py with the reference in place of the numpy
golden.

Every row compares output dtypes and shapes. Values:
- "exact" rows (creation, integer, logic, manipulation, index, sort and
  unique ops, ties included) must be bitwise equal;
- "close" rows (float element-wise ops, reductions, products) within
  1e-6 relative in float32: |port - ref| <= 1e-6 * max(|ref|, 1e-3 *
  max|ref|), an element's own size or, near zero, a thousandth of the
  output's scale (products and cancelling forms against the output's
  largest entry);
- bfloat16 rows within one bfloat16 unit in the last place (2**-7
  relative);
- special functions state their own limit where they need more (XLA's
  and torch's series for them differ).
Rows marked `grad` also hold torch autograd's gradient of sum(out * w),
w seeded, against the reference tape's, in float64, within 1e-5 of the
gradient's largest entry.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as _place

torch.set_num_threads(1)

F32, BF16, EXACT = 1e-6, 2.0 ** -7, 0.0


@pytest.fixture(autouse=True)
def _cpu_place(monkeypatch):
    # the current place is process state: set the CPU for this test and
    # put the card back after it
    monkeypatch.setattr(_place, "_current", _place.CPUPlace())


def _u(*shape, lo=-2.0, hi=2.0, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)


def _i(*shape, lo=-5, hi=6, seed=0, dtype=np.int64):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def _b(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape) > 0.5


X = _u(3, 4)
Y = _u(3, 4, seed=1)
POS = _u(3, 4, lo=0.5, hi=2.0)
POS2 = _u(3, 4, lo=0.5, hi=2.0, seed=1)
UNIT = _u(3, 4, lo=-0.9, hi=0.9)
X3 = _u(2, 3, 4)
I = _i(3, 4)
I2 = _i(3, 4, seed=1)
IPOS = _i(3, 4, lo=1, hi=9, seed=2)
I32 = _i(3, 4, dtype=np.int32)
B = _b(3, 4)
B2 = _b(3, 4, seed=1)
TIES = np.array([[3, 1, 2, 1, 3, 3], [0, 5, 5, 0, 2, 2]], np.float32)
NANS = np.array([[1.0, np.nan, 3.0, 0.5], [np.nan, np.nan, 2.0, -1.0],
                 [4.0, 2.0, np.inf, -np.inf]], np.float32)
SQ = _u(4, 4, seed=3)
V4 = _u(4, seed=4)

ROWS = []


def row(rid, fn, *inputs, tol=F32, grad=False, norm=False):
    """`norm`: errors relative to the output's largest entry (products,
    and the cancelling forms), not to each entry."""
    ROWS.append(pytest.param(fn, inputs, tol, grad, norm, id=rid))


def _un(name, dom=(-2.0, 2.0), tol=F32, grad=False):
    row(name, lambda P, x: getattr(P, name)(x),
        _u(3, 4, lo=dom[0], hi=dom[1], seed=5), tol=tol, grad=grad)


# ------------------------------------------------------------ creation ---
row("zeros", lambda P: P.zeros([2, 3]), tol=EXACT)
row("full_float", lambda P: P.full([2, 2], 1.5), tol=EXACT)
row("full_int", lambda P: P.full([2], 3), tol=EXACT)
row("full_bool", lambda P: P.full([2], True), tol=EXACT)
row("full_like", lambda P, x: P.full_like(x, 2.5), I, tol=EXACT)
row("arange_int", lambda P: P.arange(5), tol=EXACT)
row("arange_float", lambda P: P.arange(0.0, 1.0, 0.1), tol=EXACT)
# linspace's values are XLA's formula, but XLA's CPU code contracts some
# lanes of it into fused multiply-adds: within a unit in the last place
row("linspace", lambda P: P.linspace(0, 1, 7), tol=F32)
row("logspace", lambda P: P.logspace(0, 2, 5), tol=F32)
row("eye", lambda P: P.eye(3), tol=EXACT)
row("tril", lambda P, x: P.tril(x), SQ, tol=EXACT)
row("triu", lambda P, x: P.triu(x, 1), SQ, tol=EXACT)
row("diag_vec", lambda P, v: P.diag(v), V4, tol=EXACT)
row("diag_vec_pad", lambda P, v: P.diag(v, 1, padding_value=9), V4,
    tol=EXACT)
row("diagflat", lambda P, m: P.diagflat(m, 1), SQ[:2, :2], tol=EXACT)
row("diag_embed", lambda P, m: P.diag_embed(m), X, tol=EXACT)
row("diagonal", lambda P, m: P.diagonal(m, 1), SQ, tol=EXACT)
row("meshgrid", lambda P, a, b: P.meshgrid(a, b), V4, X[0], tol=EXACT)
row("clone", lambda P, x: P.clone(x), X, tol=EXACT)
row("assign", lambda P, x: P.assign(x), I, tol=EXACT)
row("complex", lambda P, a, b: P.complex(a, b), X, Y, tol=EXACT)
row("as_complex", lambda P, x: P.as_complex(x), X3[..., :2].copy(),
    tol=EXACT)
row("polar", lambda P, a, t: P.polar(a, t), POS, X, tol=F32)
row("tril_indices", lambda P: P.tril_indices(4), tol=EXACT)
row("triu_indices", lambda P: P.triu_indices(3, 5, 1), tol=EXACT)
row("fill_constant", lambda P: P.fill_constant([2, 2], "float32", 3.5),
    tol=EXACT)
row("create_tensor", lambda P: P.create_tensor("int32"), tol=EXACT)

# -------------------------------------------------------- math: binary ---
for _name, _grad in (("add", True), ("subtract", True), ("multiply", True),
                     ("divide", True), ("maximum", False),
                     ("minimum", False), ("fmax", False),
                     ("atan2", True), ("logaddexp", True), ("hypot", True),
                     ("copysign", False), ("heaviside", False),
                     ("nextafter", False), ("pow", False), ("xlogy", False),
                     ("floor_divide", False), ("remainder", False)):
    row(_name, lambda P, a, b, n=_name: getattr(P, n)(a, b), POS, POS2,
        grad=_grad)
for _name in ("floor_divide", "remainder"):
    row(f"{_name}_int", lambda P, a, b, n=_name: getattr(P, n)(a, b),
        I, IPOS, tol=EXACT)
row("remainder_neg", lambda P, a, b: P.remainder(a, b), X, -POS, tol=F32)
row("divide_int", lambda P, a, b: P.divide(a, b), I, IPOS)
row("add_scalar", lambda P, a: P.add(a, 1.5), X)
row("add_int32_float", lambda P, a: P.add(a, 1.5), I32, tol=EXACT)
row("pow_scalar2", lambda P, a: P.pow(a, 2), X)
row("pow_int32_float", lambda P, a: P.pow(a, 2.0), I32, tol=EXACT)
row("add_bf16", lambda P, a, b: P.add(P.cast(a, "bfloat16"),
                                      P.cast(b, "bfloat16")), X, Y, tol=BF16)
row("gcd", lambda P, a, b: P.gcd(a, b), I, IPOS, tol=EXACT)
row("lcm", lambda P, a, b: P.lcm(a, b), I, IPOS, tol=EXACT)
row("ldexp", lambda P, a, e: P.ldexp(a, e), X, _i(3, 4, seed=7), tol=EXACT)
row("inner", lambda P, a, b: P.inner(a, b), X, Y, norm=True)
row("outer", lambda P, a, b: P.outer(a, b), V4, X[0], tol=F32)
row("kron", lambda P, a, b: P.kron(a, b), X[:2, :2].copy(), Y[:2, :3].copy(),
    grad=True)

# --------------------------------------------------------- math: unary ---
for _name, _dom, _grad in (
        ("exp", (-2, 2), True), ("expm1", (-2, 2), True),
        ("log", (0.2, 3), True), ("log2", (0.2, 3), True),
        ("log10", (0.2, 3), True), ("log1p", (-0.5, 3), True),
        ("sqrt", (0.2, 3), True), ("rsqrt", (0.2, 3), True),
        ("square", (-2, 2), True), ("sin", (-2, 2), True),
        ("cos", (-2, 2), True), ("tan", (-1, 1), True),
        ("asin", (-0.9, 0.9), True), ("acos", (-0.9, 0.9), True),
        ("atan", (-2, 2), True), ("sinh", (-2, 2), True),
        ("cosh", (-2, 2), True), ("tanh", (-2, 2), True),
        ("asinh", (-2, 2), True), ("acosh", (1.2, 3), True),
        ("atanh", (-0.9, 0.9), True), ("reciprocal", (0.5, 2), True),
        ("erf", (-2, 2), True), ("deg2rad", (-2, 2), False),
        ("rad2deg", (-2, 2), False), ("sinc", (-2, 2), False),
        ("angle", (-2, 2), False), ("sigmoid", (-2, 2), True)):
    _un(_name, _dom, grad=_grad)
for _name in ("neg", "abs", "floor", "ceil", "round", "trunc", "frac",
              "sign", "sgn", "signbit"):
    _un(_name, tol=EXACT)
for _name in ("isnan", "isinf", "isfinite"):
    row(_name, lambda P, x, n=_name: getattr(P, n)(x), NANS, tol=EXACT)
row("square_int", lambda P, x: P.square(x), I, tol=EXACT)
row("exp_int32", lambda P, x: P.exp(x), IPOS)
row("sgn_complex", lambda P, a, b: P.sgn(P.complex(a, b)), X, Y)
# special functions: XLA's and torch's series differ by more than rounding
row("erfinv", lambda P, x: P.erfinv(x), UNIT, tol=3e-6, grad=True)
# lgamma's roots at 1 and 2 and digamma's at 1.4616 lie in (0.5, 2): there
# the two libraries' float32 series part by about 2e-8 absolute
row("lgamma", lambda P, x: P.lgamma(x), POS, tol=1e-4, grad=True)
row("digamma", lambda P, x: P.digamma(x), POS, tol=1e-4, grad=True)
row("polygamma", lambda P, x: P.polygamma(x, 1), POS, tol=3e-6)
row("i0", lambda P, x: P.i0(x), X, tol=3e-6, grad=True)
row("i0e", lambda P, x: P.i0e(x), X, tol=3e-6, grad=True)
row("i1", lambda P, x: P.i1(x), X, tol=3e-6, grad=True)
row("i1e", lambda P, x: P.i1e(x), X, tol=3e-6, grad=True)
row("igamma", lambda P, x, a: P.igamma(x, a), POS, POS2, tol=1e-5)
row("igammac", lambda P, x, a: P.igammac(x, a), POS, POS2, tol=1e-5)

# ---------------------------------------------------------- math: rest ---
row("clip", lambda P, x: P.clip(x, -0.5, 0.5), X, tol=EXACT)
row("scale", lambda P, x: P.scale(x, 2.0, 1.0), X, tol=EXACT)
row("lerp", lambda P, x, y: P.lerp(x, y, 0.3), X, Y)
row("logit", lambda P, x: P.logit(x), _u(3, 4, lo=0.1, hi=0.9), grad=True)
row("nan_to_num", lambda P, x: P.nan_to_num(x), NANS, tol=EXACT)
row("add_n", lambda P, a, b, c: P.add_n([a, b, c]), X, Y, POS)
row("cumsum", lambda P, x: P.cumsum(x, 1), X, grad=True)
row("cumsum_bool", lambda P, x: P.cumsum(x), B, tol=EXACT)
row("cumprod", lambda P, x: P.cumprod(x, dim=1), POS)
row("cummax", lambda P, x: P.cummax(x, axis=1), TIES, tol=EXACT)
row("cummin", lambda P, x: P.cummin(x, axis=1, dtype="int32"), TIES,
    tol=EXACT)
row("trace", lambda P, x: P.trace(x), SQ, norm=True)
row("logsumexp", lambda P, x: P.logsumexp(x), X, grad=True)
row("stanh", lambda P, x: P.stanh(x), X)
row("increment", lambda P, x: P.increment(P.clone(x), 2.5), X, tol=EXACT)

# ----------------------------------------------------------- reductions ---
# (amax and amin are max and min in both packages)
for _name, _grad in (("sum", True), ("mean", True), ("prod", True),
                     ("max", False), ("min", False)):
    row(_name, lambda P, x, n=_name: getattr(P, n)(x), X, grad=_grad)
for _name in ("sum",):
    row(f"{_name}_axes_keep",
        lambda P, x, n=_name: getattr(P, n)(x, axis=[0, 2], keepdim=True),
        X3)
row("sum_bool", lambda P, x: P.sum(x), B, tol=EXACT)
row("sum_uint8", lambda P, x: P.sum(P.cast(x, "uint8"), 1), IPOS,
    tol=EXACT)
row("prod_uint8", lambda P, x: P.prod(P.cast(x, "uint8")), IPOS[:1],
    tol=EXACT)
row("nansum", lambda P, x: P.nansum(x, axis=1), NANS[:2])
row("nanmean", lambda P, x: P.nanmean(x, axis=1), NANS[:2])
row("all", lambda P, x: P.all(x, axis=1), B, tol=EXACT)
row("any", lambda P, x: P.any(x), B, tol=EXACT)
for _name in ("std", "var"):
    row(_name, lambda P, x, n=_name: getattr(P, n)(x), X, grad=True)
row("var_biased_axis", lambda P, x: P.var(x, 1, unbiased=False,
                                          keepdim=True), X3)
row("median_even", lambda P, x: P.median(x),
    np.array([1.0, 2.0, 3.0, 4.0], np.float32), tol=EXACT)
row("median_axis", lambda P, x: P.median(x, axis=1), X, tol=EXACT)
row("median_nan", lambda P, x: P.median(x, 1), NANS, tol=EXACT)
row("nanmedian", lambda P, x: P.nanmedian(x, 1), NANS, tol=EXACT)
row("quantile", lambda P, x: P.quantile(x, 0.3), X)
row("quantile_list", lambda P, x: P.quantile(x, [0.1, 0.5, 0.9], axis=0),
    X)
row("argmax", lambda P, x: P.argmax(x), TIES, tol=EXACT)
row("count_nonzero", lambda P, x: P.count_nonzero(x), I, tol=EXACT)
row("numel", lambda P, x: P.numel(x), X3, tol=EXACT)

# ----------------------------------------------------------------- logic ---
for _name in ("equal", "not_equal", "less_than", "less_equal",
              "greater_than", "greater_equal"):
    row(_name, lambda P, a, b, n=_name: getattr(P, n)(a, b), I, I2,
        tol=EXACT)
    if _name == "less_than":
        row(f"{_name}_float", lambda P, a, b, n=_name: getattr(P, n)(a, b),
            X, np.round(Y), tol=EXACT)
for _name in ("logical_and", "logical_or", "logical_xor"):
    row(_name, lambda P, a, b, n=_name: getattr(P, n)(a, b), B, B2,
        tol=EXACT)
for _name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    row(_name, lambda P, a, b, n=_name: getattr(P, n)(a, b), I, I2,
        tol=EXACT)
row("logical_not", lambda P, a: P.logical_not(a), I, tol=EXACT)
row("bitwise_not", lambda P, a: P.bitwise_not(a), I32, tol=EXACT)
row("equal_all", lambda P, a, b: P.equal_all(a, b), I, I.copy(), tol=EXACT)
row("allclose", lambda P, a, b: P.allclose(a, b), X, X + 1e-7, tol=EXACT)
row("isclose", lambda P, a, b: P.isclose(a, b, rtol=0.5), X, Y, tol=EXACT)
row("is_empty", lambda P, a: P.is_empty(a), np.zeros((0, 3), np.float32),
    tol=EXACT)
row("is_tensor", lambda P, a: P.is_tensor(a), X, tol=EXACT)
row("is_complex", lambda P, a: P.is_complex(a), X, tol=EXACT)
row("is_floating_point", lambda P, a: P.is_floating_point(a), I, tol=EXACT)
row("is_integer", lambda P, a: P.is_integer(a), I32, tol=EXACT)

# ---------------------------------------------------------- manipulation ---
row("reshape", lambda P, x: P.reshape(x, [4, -1]), X3, tol=EXACT)
row("reshape_", lambda P, x: P.reshape_(P.clone(x), [6, 4]), X3,
    tol=EXACT)
row("flatten", lambda P, x: P.flatten(x, 1), X3, tol=EXACT)
row("squeeze", lambda P, x: P.squeeze(x), X[:, None, :, None], tol=EXACT)
row("unsqueeze", lambda P, x: P.unsqueeze(x, 1), X, tol=EXACT)
row("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), X3, tol=EXACT)
row("t", lambda P, x: P.t(x), X, tol=EXACT)
row("swapaxes", lambda P, x: P.swapaxes(x, 0, 2), X3, tol=EXACT)
row("transpose_", lambda P, x: P.transpose_(P.clone(x), [1, 0]), X,
    tol=EXACT)
row("concat", lambda P, a, b: P.concat([a, b], axis=1), X, Y, tol=EXACT)
row("stack", lambda P, a, b: P.stack([a, b], axis=1), X, Y, tol=EXACT)
row("split", lambda P, x: P.split(x, 2, axis=1), X, tol=EXACT)
row("chunk", lambda P, x: P.chunk(x, 3), X3[:, :3].reshape(3, 2, 4),
    tol=EXACT)
row("unbind", lambda P, x: P.unbind(x, 1), X, tol=EXACT)
row("tile", lambda P, x: P.tile(x, [2, 1]), X, tol=EXACT)
row("expand", lambda P, x: P.expand(x, [2, 3, -1]), X[:1], tol=EXACT)
row("expand_as", lambda P, x, y: P.expand_as(x, y), V4, X, tol=EXACT)
row("broadcast_to", lambda P, x: P.broadcast_to(x, [2, 4]), V4, tol=EXACT)
row("broadcast_tensors", lambda P, x, y: P.broadcast_tensors([x, y]),
    V4, X[:, :1].copy(), tol=EXACT)
row("flip", lambda P, x: P.flip(x, [0, 2]), X3, tol=EXACT)
row("rot90", lambda P, x: P.rot90(x), X, tol=EXACT)
row("roll", lambda P, x: P.roll(x, 2), X, tol=EXACT)
_IDX = np.array([2, 0, -1, 2])
row("gather", lambda P, x, i: P.gather(x, i), X, _IDX, tol=EXACT)
row("gather_nd", lambda P, x, i: P.gather_nd(x, i), X3,
    np.array([[0, 1], [1, -1]]), tol=EXACT)
_TA = np.array([[0, 1, 2, 3], [3, 2, 1, 0], [0, 0, 0, 0]])
row("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1), X, _TA,
    tol=EXACT)
row("put_along_axis", lambda P, x, i, v: P.put_along_axis(x, i, v, 1),
    X, np.array([[1], [3], [0]]), np.ones((3, 1), np.float32), tol=EXACT)
row("index_select", lambda P, x, i: P.index_select(x, i, axis=1), X,
    np.array([3, 0, 0]), tol=EXACT)
row("index_sample", lambda P, x, i: P.index_sample(x, i), X,
    np.array([[0, 3], [1, 1], [2, 0]]), tol=EXACT)
row("index_add", lambda P, x, i, v: P.index_add(x, i, 0, v), X,
    np.array([2, 0, 2]), Y, tol=F32)
row("scatter", lambda P, x, i, u: P.scatter(x, i, u), X,
    np.array([2, 0]), Y[:2].copy(), tol=EXACT)
row("scatter_add_repeat",
    lambda P, x, i, u: P.scatter(x, i, u, overwrite=False), X,
    np.array([2, 0, 2]), Y, tol=F32)
row("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u), X,
    np.array([[0, 1], [2, 3], [0, 1]]), np.array([1.0, 2.0, 3.0],
                                                  np.float32), tol=F32)
row("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [3, 4]),
    np.array([[1], [2]]), Y[:2].copy(), tol=EXACT)
row("where", lambda P, c, x, y: P.where(c, x, y), B, X, Y, tol=EXACT)
row("where_scalar", lambda P, c, x: P.where(c, x, 0.5), B, I32, tol=EXACT)
row("masked_fill", lambda P, x, m: P.masked_fill(x, m, 7.5), X, B,
    tol=EXACT)
row("nonzero", lambda P, x: P.nonzero(x), I, tol=EXACT)
row("masked_select", lambda P, x, m: P.masked_select(x, m), X, B,
    tol=EXACT)
row("sort", lambda P, x: P.sort(x), TIES, tol=EXACT)
row("argsort_ties", lambda P, x: P.argsort(x), TIES, tol=EXACT)
row("argsort_desc_ties", lambda P, x: P.argsort(x, descending=True), TIES,
    tol=EXACT)
row("topk", lambda P, x: P.topk(x, 3), TIES, tol=EXACT)
row("kthvalue", lambda P, x: P.kthvalue(x, 2), TIES, tol=EXACT)
row("mode", lambda P, x: P.mode(x), np.array([[1, 2, 2, 1]]), tol=EXACT)
row("unique_all", lambda P, x: P.unique(x, return_index=True,
                                        return_inverse=True,
                                        return_counts=True), I, tol=EXACT)
row("unique_consecutive",
    lambda P, x: P.unique_consecutive(x, return_inverse=True,
                                      return_counts=True),
    np.array([1, 1, 2, 2, 3, 1, 1, 2]), tol=EXACT)
_P4 = _u(2, 3, 4, 5, seed=8)
row("pad_all_dims", lambda P, x: P.pad(x, [1, 0, 0, 2, 1, 1]), X3,
    tol=EXACT)
row("pad_nchw", lambda P, x: P.pad(x, [1, 2, 0, 1], value=0.5), _P4,
    tol=EXACT)
for _mode in ("reflect",):
    row(f"pad_{_mode}", lambda P, x, m=_mode: P.pad(x, [2, 1, 1, 2], mode=m),
        _P4, tol=EXACT)
row("slice", lambda P, x: P.slice(x, [0, 2], [1, -3], [3, 4]), X3,
    tol=EXACT)
row("strided_slice", lambda P, x: P.strided_slice(x, [1, 2], [0, 3],
                                                  [3, 0], [2, -2]), X3,
    tol=EXACT)
row("one_hot", lambda P, x: P.one_hot(x, 7), _i(3, 4, lo=-1, hi=8),
    tol=EXACT)
row("tensordot", lambda P, x, y: P.tensordot(x, y, 1), X, Y.T.copy(), norm=True)
row("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, 1), X,
    tol=EXACT)
_SEQ = np.array([0.0, 1.0, 1.0, 2.0, 3.5], np.float32)
row("searchsorted", lambda P, s, v: P.searchsorted(s, v), _SEQ,
    np.array([-1.0, 1.0, 1.5, 3.5, 9.0], np.float32), tol=EXACT)
row("bucketize", lambda P, x, s: P.bucketize(x, s), X, _SEQ, tol=EXACT)
row("shard_index", lambda P, x: P.shard_index(x, 20, 2, 1),
    _i(3, 4, lo=0, hi=20), tol=EXACT)
row("crop", lambda P, x: P.crop(x, [2, -1, 2], [0, 1, 1]), X3, tol=EXACT)
row("multiplex", lambda P, a, b, i: P.multiplex([a, b], i), X, Y,
    np.array([[1], [0], [1]], np.int32), tol=EXACT)
row("array_ops", lambda P, x, y: (
    lambda arr: [P.array_read(arr, 1), P.array_length(arr)])(
        P.array_write(y, 1, P.array_write(x, 0, P.create_array()))),
    X, Y, tol=EXACT)

# ---------------------------------------------------------------- extras ---
row("frexp", lambda P, x: P.frexp(x), X * 100, tol=EXACT)
row("logcumsumexp", lambda P, x: P.logcumsumexp(x, axis=1), X, grad=True)
row("vander", lambda P, x: P.vander(x), V4)
row("take", lambda P, x, i: P.take(x, i), X, np.array([[0, 7], [11, 3]]),
    tol=EXACT)
row("take_neg", lambda P, x, i: P.take(x, i), X, np.array([-1, -12]),
    tol=EXACT)
row("renorm", lambda P, x: P.renorm(x, 2.0, 0, 1.0), X, grad=True)
row("histogramdd", lambda P, x: P.histogramdd(x, bins=3), _u(20, 2),
    tol=F32)  # the counts bitwise, the edges (linspace) as linspace's
row("diff", lambda P, x: P.diff(x), X, tol=F32)
row("trapezoid", lambda P, y: P.trapezoid(y), X)
row("cumulative_trapezoid", lambda P, y: P.cumulative_trapezoid(y), X)
row("interp", lambda P, x, xp, fp: P.interp(x, xp, fp), _u(9, lo=-1,
                                                           hi=4),
    _SEQ, _u(5, seed=2))
row("nanquantile", lambda P, x: P.nanquantile(x, 0.4, axis=1), NANS)
row("cartesian_prod", lambda P, a, b: P.cartesian_prod([a, b]), V4, X[0],
    tol=EXACT)
row("combinations", lambda P, x: P.combinations(x), V4, tol=EXACT)

# ---------------------------------------------------------------- linalg ---
row("matmul", lambda P, x, y: P.matmul(x, y), X, Y.T.copy(), grad=True, norm=True)
row("matmul_transposes",
    lambda P, x, y: P.matmul(x, y, transpose_x=True, transpose_y=True),
    X, Y.T.copy(), norm=True)
row("bmm", lambda P, x, y: P.bmm(x, y), X3, _u(2, 4, 3, seed=2), norm=True)
row("dot", lambda P, x, y: P.dot(x, y), X, Y, norm=True)
row("mv", lambda P, x, v: P.mv(x, v), X, V4, norm=True)
row("addmm", lambda P, i, x, y: P.addmm(i, x, y, 0.5, 2.0), SQ[:3, :3],
    X, Y.T.copy(), norm=True)
row("einsum", lambda P, x, y: P.einsum("bij,jk->bik", x, y), X3,
    _u(4, 5, seed=2), norm=True)
row("multi_dot", lambda P, a, b, c: P.linalg.multi_dot([a, b, c]), X,
    Y.T.copy(), SQ[:3], norm=True)
row("matrix_power", lambda P, x: P.linalg.matrix_power(x, 3), SQ, norm=True)
# integer and bool products, bitwise: XLA's dot wraps int32 sums, and a
# bool product is an or of ands
_I32BIG = _i(3, 4, lo=-2 ** 30, hi=2 ** 30, seed=7, dtype=np.int32)
INT_PRODUCTS = []
for _dt, _x, _y in (("int32", _I32BIG, _I32BIG.T.copy()),
                    ("int64", I, I2.T.copy()), ("bool", B, B2.T.copy())):
    INT_PRODUCTS += [
        pytest.param(lambda P, x, y: P.matmul(x, y), (_x, _y),
                     id=f"matmul_{_dt}"),
        pytest.param(lambda P, x, v: P.matmul(x, v), (_x, _y[:, 0].copy()),
                     id=f"mv_{_dt}"),
        pytest.param(lambda P, a, b, c: P.linalg.multi_dot([a, b, c]),
                     (_x, _y, _x), id=f"multi_dot_{_dt}")]
for _p in INT_PRODUCTS:
    row(_p.id, _p.values[0], *_p.values[1], tol=EXACT)
for _p, _axis in (("fro", None), (1, None), (float("inf"), 1)):
    row(f"norm_{_p}_{_axis}",
        lambda P, x, p=_p, a=_axis: P.linalg.norm(x, p=p, axis=a), X)
row("norm_matrix_fro", lambda P, x: P.linalg.norm(x, axis=[0, 2]), X3)
row("dist", lambda P, x, y: P.dist(x, y), X, Y)
row("cross", lambda P, x, y: P.cross(x, y), _u(3, 4), _u(3, 4, seed=1))
row("histogram", lambda P, x: P.histogram(x, bins=4, min=-1, max=1), X,
    tol=EXACT)
row("bincount", lambda P, x: P.bincount(x), _i(10, lo=0, hi=5),
    tol=EXACT)
row("cov", lambda P, x: P.cov(x), X, norm=True)
row("corrcoef", lambda P, x: P.corrcoef(x), X, norm=True)
row("cos_sim", lambda P, x, y: P.cos_sim(x, y), X, Y, norm=True)

# ------------------------------------------------------ nn.functional ---
# (sigmoid and tanh are the top-level rows' functions; swish is silu)
for _name, _grad in (("relu", False), ("relu6", False), ("silu", True),
                     ("log_sigmoid", True), ("mish", True),
                     ("softsign", True), ("tanhshrink", True),
                     ("hardswish", False), ("hardsigmoid", False),
                     ("gelu", True), ("leaky_relu", False), ("elu", True),
                     ("celu", True), ("selu", True), ("hardtanh", False),
                     ("hardshrink", False), ("softshrink", False),
                     ("softplus", True), ("thresholded_relu", False)):
    # x - tanh(x) cancels near 0: its rounding is held to the output's scale
    row(f"F.{_name}", lambda P, x, n=_name: getattr(P.nn.functional, n)(x),
        _u(3, 4, lo=-4, hi=4, seed=6), grad=_grad, norm=_name == "tanhshrink")
row("F.gelu_tanh", lambda P, x: P.nn.functional.gelu(x, approximate=True),
    X)
row("F.softmax", lambda P, x: P.nn.functional.softmax(x), X, grad=True)
row("F.log_softmax", lambda P, x: P.nn.functional.log_softmax(x, 1), X3)
row("F.prelu", lambda P, x, w: P.nn.functional.prelu(x, w), X,
    np.array([0.25], np.float32))
row("F.glu", lambda P, x: P.nn.functional.glu(x), X)
row("F.maxout", lambda P, x: P.nn.functional.maxout(x, 2), _P4[:, :2],
    tol=EXACT)
row("F.normalize", lambda P, x: P.nn.functional.normalize(x), X3)
row("F.sequence_mask", lambda P, x: P.nn.functional.sequence_mask(x),
    np.array([1, 3, 0, 2]), tol=EXACT)
row("F.label_smooth", lambda P, x: P.nn.functional.label_smooth(x),
    np.eye(4, dtype=np.float32))


# ----------------------------------------------------------- the harness ---
def _tensors(P, inputs, f64=False):
    out = []
    for a in inputs:
        if isinstance(a, np.ndarray):
            if f64 and a.dtype == np.float32:
                a = a.astype(np.float64)
            out.append(P.to_tensor(a, stop_gradient=not (
                f64 and a.dtype == np.float64)))
        else:
            out.append(a)
    return out


class _Leaf:
    def __init__(self, value, name):
        self.value, self.name = value, name


def _np(v):
    """A reference or port result as leaves (a numpy array or Python
    value with its dtype name), recursively through lists and tuples."""
    if isinstance(v, (list, tuple)):
        return [_np(e) for e in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        name = str(v.dtype).replace("torch.", "")
        if v.dtype == torch.bfloat16:
            v = v.float()
        return _Leaf(np.asarray(v.numpy()), name)
    if hasattr(v, "_data"):
        a = np.asarray(v.numpy())
        name = np.dtype(v.dtype).name
        if name == "bfloat16":
            a = a.astype(np.float32)
        return _Leaf(a, name)
    return _Leaf(v, type(v).__name__)


def _close(got, want, tol, where, norm=False):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{where}[{i}]", norm)
        return
    g, gname, w, wname = got.value, got.name, want.value, want.name
    assert gname == wname, f"{where}: dtype {gname} != reference {wname}"
    if not isinstance(w, np.ndarray):
        assert g == w, f"{where}: {g} != {w}"
        return
    assert g.shape == w.shape, f"{where}: shape {g.shape} != {w.shape}"
    if tol == EXACT or not np.issubdtype(w.dtype, np.inexact):
        assert np.array_equal(g, w, equal_nan=True), \
            f"{where}: not bitwise equal\n{g}\n{w}"
        return
    if np.iscomplexobj(w):
        g = np.stack([g.real, g.imag], -1)
        w = np.stack([w.real, w.imag], -1)
    fin = np.isfinite(w)
    assert np.array_equal(np.isfinite(g), fin) and np.array_equal(
        g[~fin], w[~fin], equal_nan=True), f"{where}: non-finite entries"
    if not fin.any():
        return
    g, w = g[fin], w[fin]
    top = np.abs(w).max()
    scale = np.full_like(w, top) if norm else np.maximum(np.abs(w),
                                                         1e-3 * top)
    err = (np.abs(g.astype(np.float64) - w) / np.where(scale > 0, scale, 1))
    assert err.max() <= tol, f"{where}: relative error {err.max():.3e} " \
                             f"over {tol:.1e}"


@pytest.mark.parametrize("fn,inputs", INT_PRODUCTS)
def test_integer_products_in_blocks_against_the_reference(fn, inputs,
                                                          monkeypatch):
    """The integer product accumulated over several blocks of K (one
    column of K a block here) is still the reference's, bit for bit."""
    from paddle_tpu_torch.ops import linalg as tlinalg

    monkeypatch.setattr(tlinalg, "_INT_MATMUL_BLOCK", 5)
    want = _np(fn(ref, *_tensors(ref, inputs)))
    got = _np(fn(port, *_tensors(port, inputs)))
    _close(got, want, EXACT, "output")


@pytest.mark.parametrize("fn,inputs,tol,grad,norm", ROWS)
def test_op_against_the_reference(fn, inputs, tol, grad, norm):
    want = _np(fn(ref, *_tensors(ref, inputs)))
    got = _np(fn(port, *_tensors(port, inputs)))
    _close(got, want, tol, "output", norm)
    if not grad:
        return
    rin = _tensors(ref, inputs, f64=True)
    tin = _tensors(port, inputs, f64=True)
    rout, tout = fn(ref, *rin), fn(port, *tin)
    if isinstance(rout, (list, tuple)):
        rout, tout = rout[0], tout[0]
    # the gradient of sum(out * w): w as the output's cotangent
    w = np.random.RandomState(11).standard_normal(
        tuple(rout.shape)).astype(np.float64)
    rout.backward(ref.to_tensor(w))
    tout.backward(torch.from_numpy(w))
    for r, t in zip(rin, tin):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            rg = np.asarray(r.grad.numpy())
            tg = t.grad.numpy()
            err = np.abs(tg - rg).max() / max(np.abs(rg).max(), 1e-30)
            assert err <= 1e-5, f"gradient: relative error {err:.3e}"
