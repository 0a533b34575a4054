"""The port's optimizers (paddle_tpu_torch/optimizer) against the
reference's on the same seeded parameters and gradients: every optimizer
under no decay, L2Decay and L1Decay, with no clip and each clip, 3
updates through the train step's entry (`apply_gradients` against
`functional_update`, grads clipped by sorted name); Adam and AdamW also
on bf16 parameters with f32 masters (multi_precision); the eager `step()`
against the reference's eager step; AdamW's `apply_decay_param_fun`,
Lamb's `exclude_from_weight_decay_fn` and `lr_ratio`; and an optimizer
state_dict carried across the packages both ways (Linear weights
transposed by framework_io).

Tolerance: f32 parameters within 1e-6 of each tensor's largest element
(the packages differ in the order of f32 sums, clip norms and Lamb's
trust ratio included, and in the pow of Adam's bias correction), the
optimizers' state within 2e-6 (XLA's CPU square root is not correctly
rounded: about 1% of its results lie one ulp from torch's, and
Adadelta's avg_sq_update squares a ratio of two roots, 1.1e-6 after 3
steps); bf16 parameters within one bf16 step of the f32 master they are
cast from."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter, Tensor

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import framework_io as fio
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

torch.set_num_threads(1)

REL, STATE_REL = 1e-6, 2e-6
STEPS, LR = 3, 0.05
# a Linear weight of the GPT (the reference stores it [in, out], the port
# [out, in]), a bias, a LayerNorm scale
NAMES = ("gpt.blocks.0.mlp.fc1.weight", "gpt.blocks.0.mlp.fc1.bias",
         "gpt.blocks.0.ln1.weight")
SHAPES = {NAMES[0]: (6, 4), NAMES[1]: (6,), NAMES[2]: (4,)}     # port's
OPTIMIZERS = {
    "SGD": {},
    "Momentum": {"momentum": 0.9},
    "Momentum-nesterov": {"momentum": 0.9, "use_nesterov": True},
    "Adam": {},
    "AdamW": {"weight_decay": 0.1},
    "Adagrad": {},
    "Adadelta": {"rho": 0.9},
    "RMSProp": {"momentum": 0.5},
    "RMSProp-centered": {"centered": True},
    "Adamax": {},
    "Lamb": {"lamb_weight_decay": 0.1},
}
DECAYS = {"none": None, "L2": (L2Decay, jopt.L2Decay),
          "L1": (L1Decay, jopt.L1Decay)}
CLIPS = {"none": None,
         "value": (topt.ClipGradByValue, jopt.ClipGradByValue, 0.3),
         "norm": (topt.ClipGradByNorm, jopt.ClipGradByNorm, 0.5),
         "global": (topt.ClipGradByGlobalNorm, jopt.ClipGradByGlobalNorm,
                    0.8)}


def _ref_layout(name, a):
    return a.T if name == NAMES[0] else a


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _kwargs(opt, decay, clip, which):
    """Constructor arguments of `opt` for package `which` (0 port, 1
    reference)."""
    cls_name = opt.split("-")[0]
    kw = dict(OPTIMIZERS[opt])
    if decay is not None:
        key = "lamb_weight_decay" if cls_name == "Lamb" else "weight_decay"
        kw[key] = DECAYS[decay][which](0.1) if DECAYS[decay] else None
    if clip is not None and CLIPS[clip] is not None:
        kw["grad_clip"] = CLIPS[clip][which](CLIPS[clip][2])
    return cls_name, kw


def _make(opt, decay, clip, which, params, lr=LR, extra=None):
    cls_name, kw = _kwargs(opt, decay, clip, which)
    kw.update(extra or {})
    mod = (topt, jopt)[which]
    cls = getattr(mod, cls_name)
    if cls_name in ("Adagrad", "RMSProp"):
        return cls(lr, parameters=params, **kw)
    return cls(learning_rate=lr, parameters=params, **kw)


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


def _run_train_step_entry(opt, decay, clip, dtype="float32", extra=None,
                          ref_lr=None):
    params, grads = _inputs()
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy()).to(
        getattr(torch, dtype))) for n, a in params.items()}
    ref = {n: jnp.asarray(_ref_layout(n, a), dtype)
           for n, a in params.items()}
    mp = {"multi_precision": True} if dtype != "float32" else {}
    t = _make(opt, decay, clip, 0, list(tparams.items()),
              extra={**mp, **(extra or {})})
    j = _make(opt, decay, clip, 1, [Parameter(v) for v in ref.values()],
              lr=ref_lr or LR, extra=mp)
    state = j.functional_init(ref)
    for s, g in enumerate(grads, start=1):
        t.apply_gradients({n: torch.from_numpy(a).to(getattr(torch, dtype))
                           for n, a in g.items()}, LR, s)
        ref, state = j.functional_update(
            ref, {n: jnp.asarray(_ref_layout(n, a), dtype)
                  for n, a in g.items()},
            state, lr=jnp.asarray(ref_lr or LR, jnp.float32),
            step=jnp.asarray(s, jnp.int32))
    return tparams, t, ref, state[0]


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_updates_match_reference(opt, decay, clip):
    tparams, t, ref, state = _run_train_step_entry(opt, decay, clip)
    for n, p in tparams.items():
        _close(p.detach().numpy(), _ref_layout(n, np.asarray(ref[n])),
               (n, "param"))
        st = t.state[p]
        assert sorted(st) == sorted(state[n]), n
        for k, v in st.items():
            _close(v.numpy(), _ref_layout(n, np.asarray(state[n][k])),
                   (n, k), STATE_REL)


@pytest.mark.parametrize("clip", ["none", "global"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_bf16_with_f32_masters_match_reference(opt, decay, clip):
    tparams, t, ref, state = _run_train_step_entry(opt, decay, clip,
                                                   dtype="bfloat16")
    for n, p in tparams.items():
        master = t.state[p]["master"]
        want = _ref_layout(n, np.asarray(state[n]["master"]))
        _close(master.numpy(), want, (n, "master"), STATE_REL)
        assert p.dtype == torch.bfloat16
        got = p.detach().float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got - want) <= step).all(), n


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_eager_step_matches_reference(opt):
    """`Optimizer.step()` from `.grad` (grads clipped in parameter
    order) against the reference's eager step, with L2 decay and the
    global-norm clip."""
    params, grads = _inputs(1)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()))
               for a in params.values()]
    jparams = [Parameter(jnp.asarray(_ref_layout(n, a)), name=n)
               for n, a in params.items()]
    t = _make(opt, "L2", "global", 0, tparams)
    j = _make(opt, "L2", "global", 1, jparams)
    for g in grads:
        for (n, a), tp, jp in zip(g.items(), tparams, jparams):
            tp.grad = torch.from_numpy(a.copy())
            jp._grad = Tensor(jnp.asarray(_ref_layout(n, a)))
        t.step()
        j.step()
        t.clear_grad()
        j.clear_grad()
    assert t._global_step == j._global_step == STEPS
    for n, tp, jp in zip(params, tparams, jparams):
        _close(tp.detach().numpy(), _ref_layout(n, np.asarray(jp._data)),
               n)
        assert tp.grad is None


@pytest.mark.parametrize("opt", ["AdamW", "Lamb"])
def test_decay_gates_by_name(opt):
    """AdamW's apply_decay_param_fun and Lamb's
    exclude_from_weight_decay_fn, by the reference's parameter names:
    biases and LayerNorm weights undecayed."""
    gate = (lambda n: "bias" not in n and "ln" not in n)
    extra = ({"apply_decay_param_fun": gate} if opt == "AdamW" else
             {"exclude_from_weight_decay_fn": lambda n: not gate(n)})
    params, grads = _inputs(2)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
               for n, a in params.items()}
    ref = {n: jnp.asarray(_ref_layout(n, a)) for n, a in params.items()}
    t = _make(opt, None, "global", 0, list(tparams.items()), extra=extra)
    j = _make(opt, None, "global", 1, [Parameter(v) for v in ref.values()],
              extra=extra)
    assert [t._should_decay(n) for n in NAMES] == [True, False, False]
    state = j.functional_init(ref)
    for s, g in enumerate(grads, start=1):
        t.apply_gradients({n: torch.from_numpy(a) for n, a in g.items()},
                          LR, s)
        ref, state = j.functional_update(
            ref, {n: jnp.asarray(_ref_layout(n, a)) for n, a in g.items()},
            state, lr=jnp.asarray(LR, jnp.float32),
            step=jnp.asarray(s, jnp.int32))
    for n, p in tparams.items():
        _close(p.detach().numpy(), _ref_layout(n, np.asarray(ref[n])), n)


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_adamw_lr_ratio(ratio):
    """lr_ratio(param) scales a parameter's rate, decay included: a
    constant ratio r equals the reference at lr * r (the reference
    accepts lr_ratio and applies none)."""
    tparams, _, ref, state = _run_train_step_entry(
        "AdamW", None, "none", extra={"lr_ratio": lambda p: ratio},
        ref_lr=LR * ratio)
    for n, p in tparams.items():
        _close(p.detach().numpy(), _ref_layout(n, np.asarray(ref[n])), n)


def _eager_pair(opt_name, params, sched=False):
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()))
               for a in params.values()]
    jparams = [Parameter(jnp.asarray(_ref_layout(n, a)), name=n)
               for n, a in params.items()]
    lrs = ((topt.lr.CosineAnnealingDecay(LR, T_max=5),
            jopt.lr.CosineAnnealingDecay(LR, T_max=5)) if sched
           else (LR, LR))
    t = getattr(topt, opt_name)(learning_rate=lrs[0], parameters=tparams,
                                weight_decay=0.1)
    j = getattr(jopt, opt_name)(learning_rate=lrs[1], parameters=jparams,
                                weight_decay=0.1)
    return tparams, jparams, t, j


def _eager_steps(tparams, jparams, t, j, grads, which=(0, 1)):
    for g in grads:
        for (n, a), tp, jp in zip(g.items(), tparams, jparams):
            tp.grad = torch.from_numpy(a.copy())
            jp._grad = Tensor(jnp.asarray(_ref_layout(n, a)))
        if 0 in which:
            t.step()
            t.clear_grad()
            if t._lr_scheduler is not None:
                t._lr_scheduler.step()
        if 1 in which:
            j.step()
            j.clear_grad()
            if j._lr_scheduler is not None:
                j._lr_scheduler.step()


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
@pytest.mark.parametrize("opt_name", ["AdamW", "Momentum"])
def test_state_dict_crosses_packages(tmp_path, opt_name, direction):
    """Two eager steps in one package, its optimizer state_dict (with an
    LR scheduler's) saved, loaded into the other package's optimizer
    (framework_io's save/load and layout converters), and a third step
    there: equal to three steps in one package."""
    params, grads = _inputs(3)
    tp, jp, t, j = _eager_pair(opt_name, params, sched=True)
    path = str(tmp_path / "opt.pdopt")
    if direction == "port-to-reference":
        _eager_steps(tp, jp, t, j, grads[:2], which=(0,))
        fio.save(fio.transpose_optimizer_state(t.state_dict(), NAMES),
                 path)
        # a copy: XLA's CPU client may take the numpy view of the torch
        # parameter without one, and the port updates it in place
        for n, p, q in zip(NAMES, jp, tp):
            p._data = jnp.asarray(_ref_layout(n, q.detach().numpy()).copy())
        j.set_state_dict(paddle_tpu.load(path))
        assert j._global_step == 2
        _eager_steps(tp, jp, t, j, grads[2:])
        # and the uninterrupted port run, for the third step
        tp2, jp2, t2, j2 = _eager_pair(opt_name, params, sched=True)
        _eager_steps(tp2, jp2, t2, j2, grads, which=(0,))
        for n, a, b in zip(NAMES, jp, tp2):
            _close(_ref_layout(n, np.asarray(a._data)), b.detach().numpy(),
                   n)
    else:
        _eager_steps(tp, jp, t, j, grads[:2], which=(1,))
        paddle_tpu.save(j.state_dict(), path)
        with torch.no_grad():
            for n, p, q in zip(NAMES, tp, jp):
                p.copy_(torch.from_numpy(_ref_layout(
                    n, np.asarray(q._data)).copy()))
        t.set_state_dict(fio.transpose_optimizer_state(fio.load(path), NAMES))
        assert t._global_step == 2
        assert t.get_lr() == j.get_lr()
        _eager_steps(tp, jp, t, j, grads[2:])
        for n, a, b in zip(NAMES, tp, jp):
            _close(a.detach().numpy(), _ref_layout(n, np.asarray(b._data)),
                   n)
