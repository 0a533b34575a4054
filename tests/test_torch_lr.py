"""The port's LR schedulers (paddle_tpu_torch/optimizer/lr.py) against
the reference's: every scheduler's lr over 30 steps, exactly (both are
the same Python float arithmetic on the host), and a state_dict taken at
step 12 restored into a fresh scheduler, which then continues as the
uninterrupted one does; where the reference's state_dict is plain data,
the port's is equal to it."""
import pytest

import paddle_tpu.optimizer.lr as jlr

import paddle_tpu_torch.optimizer.lr as tlr

STEPS, CUT = 30, 12


def _decay(e):
    return 0.95 ** e


SCHEDULERS = {
    "NoamDecay": (dict(d_model=64, warmup_steps=5, learning_rate=2.0),
                  None),
    "PiecewiseDecay": (dict(boundaries=[5, 12, 20],
                            values=[0.1, 0.05, 0.01, 0.001]), None),
    "NaturalExpDecay": (dict(learning_rate=0.5, gamma=0.1), None),
    "InverseTimeDecay": (dict(learning_rate=0.5, gamma=0.2), None),
    "PolynomialDecay": (dict(learning_rate=0.5, decay_steps=10,
                             end_lr=0.01, power=2.0), None),
    "PolynomialDecay-cycle": (dict(learning_rate=0.5, decay_steps=7,
                                   end_lr=0.01, cycle=True), None),
    "LinearWarmup": (dict(learning_rate=0.3, warmup_steps=6, start_lr=0.0,
                          end_lr=0.3), None),
    "LinearWarmup-cosine": (dict(warmup_steps=6, start_lr=0.01,
                                 end_lr=0.3), "cosine"),
    "ExponentialDecay": (dict(learning_rate=0.5, gamma=0.9), None),
    "MultiStepDecay": (dict(learning_rate=0.5, milestones=[4, 9, 21],
                            gamma=0.3), None),
    "StepDecay": (dict(learning_rate=0.5, step_size=7, gamma=0.5), None),
    "LambdaDecay": (dict(learning_rate=0.5, lr_lambda=_decay), None),
    "CosineAnnealingDecay": (dict(learning_rate=0.5, T_max=13,
                                  eta_min=0.001), None),
    "CosineAnnealingWarmRestarts": (dict(learning_rate=0.5, T_0=4, T_mult=2,
                                         eta_min=0.01), None),
    "ReduceOnPlateau": (dict(learning_rate=0.5, factor=0.5, patience=2,
                             cooldown=1), None),
    "OneCycleLR": (dict(max_learning_rate=0.5, total_steps=25), None),
    "MultiplicativeDecay": (dict(learning_rate=0.5, lr_lambda=_decay),
                            None),
    "CyclicLR": (dict(base_learning_rate=0.01, max_learning_rate=0.3,
                      step_size_up=4, step_size_down=6), None),
    "CyclicLR-triangular2": (dict(base_learning_rate=0.01,
                                  max_learning_rate=0.3, step_size_up=3,
                                  mode="triangular2"), None),
    "CyclicLR-exp_range": (dict(base_learning_rate=0.01,
                                max_learning_rate=0.3, step_size_up=3,
                                mode="exp_range", exp_gamma=0.9), None),
}
# a plateau-ish metric: falls, then stalls, then falls again
METRICS = [1.0 / (1 + i) if i < 8 or i > 20 else 0.12 for i in range(STEPS)]


def _make(mod, name):
    kw, inner = SCHEDULERS[name]
    cls = getattr(mod, name.split("-")[0])
    if inner == "cosine":
        return cls(mod.CosineAnnealingDecay(0.3, T_max=10), **kw)
    return cls(**kw)


def _run(s, start, stop):
    lrs = []
    for i in range(start, stop):
        lrs.append(s())
        if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            s.step(METRICS[i])
        else:
            s.step()
    return lrs


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    want = _run(_make(jlr, name), 0, STEPS)
    assert _run(_make(tlr, name), 0, STEPS) == want
    # cut at CUT, restore into a fresh one, continue
    t = _make(tlr, name)
    _run(t, 0, CUT)
    sd = t.state_dict()
    t2 = _make(tlr, name)
    t2.set_state_dict(sd)
    assert _run(t2, CUT, STEPS) == want[CUT:]
    j = _make(jlr, name)
    _run(j, 0, CUT)
    plain = {k: v for k, v in j.state_dict().items()
             if not callable(v)}
    assert {k: v for k, v in sd.items() if k in plain} == \
        {k: v for k, v in plain.items() if k in sd}
    assert set(plain) - set(sd) <= {"lr_sched"}
