"""The port's LR schedulers (`optimizer/lr.py`) against the JAX package's.

Every one of the 15 schedulers is built with the same arguments on both
sides and stepped 30 times (ReduceOnPlateau with the same seeded metric
stream); after every step the learning rate `__call__()` returns and
`last_epoch` agree exactly, since both are Python floats from the same
formulas. Halfway, the port's `state_dict()` equals the JAX one and is
loaded into a fresh port scheduler, which then keeps agreeing to the end.
"""
import math

import numpy as np
import pytest

STEPS = 30


def _halve(epoch):
    return 0.5 ** (epoch // 7)


def _shrink(epoch):
    return 0.97


# name -> (factory(lr module), stepped with a metric)
CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=8,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.2),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(2e-4, T_max=9, eta_min=2e-5),
        warmup_steps=4, start_lr=0.0, end_lr=2e-4),
    "LinearWarmup_float": lambda m: m.LinearWarmup(
        0.05, warmup_steps=6, start_lr=0.01, end_lr=0.05),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=13, eta_min=0.001),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 17],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=6, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lr_lambda=_halve),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lr_lambda=_shrink),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-3),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(0.1, total_steps=20,
                                                anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                               mode="exp_range",
                                               exp_gamma=0.95),
}


def _metrics():
    rng = np.random.RandomState(7)
    # falling, then a plateau with noise: the schedule cuts the lr
    return [float(v) for v in np.concatenate(
        [np.linspace(3.0, 2.0, 8), 2.0 + 0.01 * rng.rand(STEPS - 8)])]


def _step(sched, metric, plateau):
    if plateau:
        sched.step(metrics=metric)
    else:
        sched.step()


def test_port_has_all_fifteen_schedulers():
    import paddle_tpu.optimizer.lr as jlr
    import paddle_tpu_torch.optimizer.lr as tlr
    names = {n for n, v in vars(jlr).items()
             if isinstance(v, type) and issubclass(v, jlr.LRScheduler)
             and v is not jlr.LRScheduler}
    assert len(names) == 15
    assert {c.split("_")[0] for c in CASES} == names
    for n in names:
        assert issubclass(getattr(tlr, n), tlr.LRScheduler)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_matches_jax(case):
    import paddle_tpu.optimizer.lr as jlr
    import paddle_tpu_torch.optimizer.lr as tlr
    plateau = case == "ReduceOnPlateau"
    j, t = CASES[case](jlr), CASES[case](tlr)
    metrics = _metrics()
    assert t() == j() and t.last_epoch == j.last_epoch
    for i in range(STEPS):
        _step(j, metrics[i], plateau)
        _step(t, metrics[i], plateau)
        assert t() == j(), (case, i, t(), j())
        assert t.last_epoch == j.last_epoch
        assert math.isfinite(t())
        if i == STEPS // 2:
            state = t.state_dict()
            assert state == j.state_dict()
            fresh = CASES[case](tlr)
            fresh.set_state_dict(state)
            t = fresh
    if plateau:
        assert t() < 0.1            # the plateau did cut the lr


def test_step_with_explicit_epoch_matches_jax():
    import paddle_tpu.optimizer.lr as jlr
    import paddle_tpu_torch.optimizer.lr as tlr
    j = jlr.StepDecay(0.1, step_size=3)
    t = tlr.StepDecay(0.1, step_size=3)
    for epoch in (5, 2, 11):
        j.step(epoch)
        t.step(epoch)
        assert t() == j() and t.last_epoch == j.last_epoch == epoch
