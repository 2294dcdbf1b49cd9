"""The port's optimizers and LR schedules against the JAX package's.

Adam and AdamW run 5 steps from the same float32 params on the same
numpy gradients; every LR schedule is evaluated at steps 0..N.  Both
sides do the same float32 operations in the same order, so params,
moments and learning rates agree to float32 rounding (atol 1e-7,
rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime import optimizers as jax_opt
from deepspeed_tpu_torch.runtime import lr_schedules as sched
from deepspeed_tpu_torch.runtime import optimizers as opt

TOL = dict(atol=1e-7, rtol=1e-6)


def tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((7,)).astype(np.float32)}}


def to_torch(t):
    return opt.tree_map(torch.from_numpy, t)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, weight_decay=0.1)),
    ("adam", dict(lr=1e-2, weight_decay=0.1)),
    ("adam", dict(lr=3e-3, betas=[0.8, 0.99], eps=1e-6)),
    ("adamw", dict(lr=1e-2, weight_decay=0.05, bias_correction=False)),
])
def test_adam_five_steps_match_jax(name, kw):
    rng = np.random.default_rng(0)
    p0 = tree(rng)
    jo = jax_opt.get_optimizer(name, **dict(kw))
    po = opt.get_optimizer(name, **dict(kw))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    pp = to_torch(p0)
    js, ps = jo.init(jp), po.init(pp)
    lr = kw["lr"]
    for _ in range(5):
        g = tree(rng)
        jp, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                          jnp.asarray(lr, jnp.float32))
        pp, ps = po.apply(to_torch(g), ps, pp,
                          torch.tensor(lr, dtype=torch.float32))
        for a, b in ((jp, pp), (js["m"], ps["m"]), (js["v"], ps["v"])):
            jax.tree_util.tree_map(
                lambda x, y: np.testing.assert_allclose(
                    y.numpy(), np.asarray(x), **TOL), a, b)
    assert int(js["step"]) == int(ps["step"]) == 5
    assert ps["step"].dtype == torch.int32


def test_apply_is_out_of_place():
    rng = np.random.default_rng(1)
    po = opt.get_optimizer("adamw", lr=0.1, weight_decay=0.1)
    pp = to_torch(tree(rng))
    before = opt.tree_map(torch.clone, pp)
    st = po.init(pp)
    po.apply(to_torch(tree(rng)), st, pp, torch.tensor(0.1))
    opt.tree_map(lambda a, b: torch.testing.assert_close(a, b, atol=0,
                                                         rtol=0), pp, before)
    assert int(st["step"]) == 0


@pytest.mark.parametrize("name,err", [
    ("lamb", NotImplementedError), ("sgd", NotImplementedError),
    ("adagrad", NotImplementedError), ("onebitadam", NotImplementedError),
    ("nosuch", ValueError),
])
def test_optimizer_dispatch_refuses(name, err):
    with pytest.raises(err):
        opt.get_optimizer(name)


def test_unknown_optimizer_param_message_matches_jax():
    with pytest.raises(ValueError) as je:
        jax_opt.get_optimizer("adamw", lr=1e-3, wd=0.1)
    with pytest.raises(ValueError) as pe:
        opt.get_optimizer("adamw", lr=1e-3, wd=0.1)
    assert str(pe.value) == str(je.value)


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=2e-3, warmup_num_steps=7,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_min_lr=1e-5,
                           warmup_max_lr=1e-3, warmup_num_steps=8)),
    ("WarmupCosineLR", dict(total_num_steps=30, warmup_min_ratio=0.1,
                            warmup_num_steps=6, cos_min_ratio=0.05,
                            warmup_max_lr=6e-4)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=8)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=5, cycle_second_step_size=7,
                      decay_step_size=3, decay_lr_rate=0.5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=4,
                         lr_range_test_step_rate=2.0)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=4,
                         lr_range_test_staircase=True)),
    ("Constant", dict(lr=3e-4)),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_jax_over_steps(name, params):
    js = jax_sched.get_lr_schedule(name, dict(params))
    ps = sched.get_lr_schedule(name, dict(params))
    for step in range(0, 40):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ps(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, **TOL)


def test_unknown_schedule_raises_like_jax():
    with pytest.raises(ValueError) as je:
        jax_sched.get_lr_schedule("Nope", {})
    with pytest.raises(ValueError) as pe:
        sched.get_lr_schedule("Nope", {})
    assert str(pe.value) == str(je.value)
