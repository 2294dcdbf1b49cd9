"""The port's optimizers and LR schedules against the JAX package's.

Adam, AdamW, LAMB, SGD (momentum, Nesterov) and Adagrad run several
steps from the same float32 params on the same numpy gradients; every LR
schedule is evaluated at steps 0..N.  Both sides do the same float32
operations in the same order, so params, moments and learning rates
agree to float32 rounding (atol 1e-7, rtol 1e-6); LAMB's trust ratio
divides two norms summed in another order, so LAMB is held to 1e-5.
The client-optimizer bridge (``wrap_torch``) is held against optax's
own optimizers.
"""
import functools

import optax
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
    ("onebitadam", NotImplementedError), ("onebitlamb", NotImplementedError),
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


def stacked_tree(rng):
    """A params tree with stacked leaves (a layer axis first, as the
    model's blocks), a 2-D and a 1-D leaf, one leaf all zeros (LAMB's
    ratio then falls back to 1)."""
    return {"blocks": {"w": rng.standard_normal((3, 6, 5)).astype(np.float32),
                       "b": rng.standard_normal((3, 5)).astype(np.float32)},
            "embed": rng.standard_normal((9, 4)).astype(np.float32),
            "ln": np.zeros((4,), np.float32)}


OTHER_OPTIMIZERS = [
    ("lamb", dict(lr=1e-2, weight_decay=0.1)),
    ("lamb", dict(lr=3e-3, betas=[0.8, 0.99], max_coeff=2.0,
                  min_coeff=0.5)),
    ("fusedlamb", dict(lr=1e-2)),
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    ("sgd", dict(lr=0.05, momentum=0.9, nesterov=True)),
    ("adagrad", dict(lr=0.1)),
    ("adagrad", dict(lr=0.05, eps=1e-6, weight_decay=0.1)),
    ("cpuadagrad", dict(lr=0.05)),
]


@pytest.mark.parametrize("name,kw", OTHER_OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OTHER_OPTIMIZERS)])
def test_other_optimizers_match_jax_over_steps(name, kw):
    """LAMB (its trust ratio over a whole stacked leaf), SGD and Adagrad:
    six steps of the port against the JAX package's steps, params and
    every state leaf within 1e-5 (LAMB's norms sum in another order)."""
    rng = np.random.default_rng(3)
    p0 = stacked_tree(rng)
    jo = jax_opt.get_optimizer(name, **dict(kw))
    po = opt.get_optimizer(name, **dict(kw))
    assert po.hyperparams == jo.hyperparams
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    pp = to_torch(p0)
    js, ps = jo.init(jp), po.init(pp)
    assert sorted(js) == sorted(ps)
    lr = kw["lr"]
    for _ in range(6):
        g = stacked_tree(rng)
        g["ln"] = rng.standard_normal((4,)).astype(np.float32)
        jp, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                          jnp.asarray(lr, jnp.float32))
        pp, ps = po.apply(to_torch(g), ps, pp,
                          torch.tensor(lr, dtype=torch.float32))
        for key in [k for k in js if k != "step"]:
            jax.tree_util.tree_map(
                lambda x, y: np.testing.assert_allclose(
                    y.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5),
                js[key], ps[key])
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_allclose(
                y.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5), jp, pp)
    assert int(js["step"]) == int(ps["step"]) == 6


def test_lamb_ratio_spans_the_whole_stacked_leaf():
    """One trust ratio per leaf, not per layer: scaling one layer of a
    stacked leaf changes the update of the others, as in the JAX
    package."""
    rng = np.random.default_rng(4)
    p0 = stacked_tree(rng)
    g = stacked_tree(rng)
    po = opt.get_optimizer("lamb", lr=0.1)
    p1 = dict(p0, blocks=dict(p0["blocks"], w=p0["blocks"]["w"].copy()))
    p1["blocks"]["w"][0] *= 50.0
    lr = torch.tensor(0.1)
    a, _ = po.apply(to_torch(g), po.init(to_torch(p0)), to_torch(p0), lr)
    b, _ = po.apply(to_torch(g), po.init(to_torch(p1)), to_torch(p1), lr)
    da = a["blocks"]["w"][1] - torch.from_numpy(p0["blocks"]["w"][1])
    db = b["blocks"]["w"][1] - torch.from_numpy(p1["blocks"]["w"][1])
    assert not torch.allclose(da, db)


@pytest.mark.parametrize("dims", [(0, 0), (1, 0), (None, 0)],
                         ids=["both_rows", "w_columns", "w_whole"])
def test_lamb_on_pieces_with_leaf_sums_equals_whole_leaves(dims):
    """Two simulated ranks, each holding one half of every leaf cut along
    ``dims`` (a leaf left whole is held by both), step LAMB with a
    ``leaf_sums`` that adds the other rank's partial sums where a leaf is
    cut: the halves put back together equal LAMB over the whole leaves,
    step after step, and so do the moments (the JAX package's LAMB: the
    whole-leaf tests above)."""
    rng = np.random.default_rng(6)
    po = opt.get_optimizer("lamb", lr=1e-2, weight_decay=0.01)
    whole = to_torch(tree(rng))
    cut = {"w": dims[0], "blk": {"b": dims[1]}}

    def piece(t, d, r):
        return t if d is None else t.chunk(2, d)[r].clone()

    def join(a, b, d):
        return a if d is None else torch.cat([a, b], d)
    ranks = [opt.tree_map(lambda t, d, r=r: piece(t, d, r), whole, cut)
             for r in range(2)]
    states = [po.init(p) for p in ranks]
    ws = po.init(whole)
    lr = torch.tensor(1e-2)
    for _ in range(3):
        g = to_torch(tree(rng))
        whole, ws = po.apply(g, ws, whole, lr)
        gs = [opt.tree_map(lambda t, d, r=r: piece(t, d, r), g, cut)
              for r in range(2)]
        seen = []

        def record(sums):
            seen.append(opt.tree_map(torch.clone, sums))
            return sums
        # each rank's partial sums first, then the step with both
        for r in range(2):
            po.apply(gs[r], states[r], ranks[r], lr, leaf_sums=record)
        out = []
        for r in range(2):
            other = seen[1 - r]
            out.append(po.apply(
                gs[r], states[r], ranks[r], lr,
                leaf_sums=lambda sums, other=other: opt.tree_map(
                    lambda s, o, d: s if d is None else s + o, sums, other,
                    cut)))
        ranks = [o[0] for o in out]
        states = [o[1] for o in out]
        for kind, a, b in (("params", ranks[0], ranks[1]),
                           ("m", states[0]["m"], states[1]["m"]),
                           ("v", states[0]["v"], states[1]["v"])):
            want = whole if kind == "params" else ws[kind]
            opt.tree_map(lambda x, y, d, w: torch.testing.assert_close(
                join(x, y, d), w, atol=1e-6, rtol=1e-6), a, b, cut, want)


def test_other_optimizers_are_out_of_place():
    rng = np.random.default_rng(5)
    for name in ("lamb", "sgd", "adagrad"):
        po = opt.get_optimizer(name, lr=0.1, **(
            {"momentum": 0.9} if name == "sgd" else {}))
        pp = to_torch(stacked_tree(rng))
        before = opt.tree_map(torch.clone, pp)
        st = po.init(pp)
        st_before = opt.tree_map(torch.clone, st)
        po.apply(to_torch(stacked_tree(rng)), st, pp, torch.tensor(0.1))
        opt.tree_map(lambda a, b: torch.testing.assert_close(
            a, b, atol=0, rtol=0), pp, before)
        opt.tree_map(lambda a, b: torch.testing.assert_close(
            a, b, atol=0, rtol=0), st, st_before)


#: (optax optimizer, the torch.optim factory that computes the same step)
CLIENT_PAIRS = [
    ("sgd", lambda: optax.sgd(0.1),
     functools.partial(torch.optim.SGD, lr=0.1)),
    ("sgd-momentum", lambda: optax.sgd(0.05, momentum=0.9),
     functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9)),
    ("sgd-nesterov", lambda: optax.sgd(0.05, momentum=0.9, nesterov=True),
     functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9,
                       nesterov=True)),
    ("adam", lambda: optax.adam(1e-2),
     functools.partial(torch.optim.Adam, lr=1e-2)),
    ("adam-betas", lambda: optax.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6),
     functools.partial(torch.optim.Adam, lr=3e-3, betas=(0.8, 0.99),
                       eps=1e-6)),
]


@pytest.mark.parametrize("name,make_tx,factory", CLIENT_PAIRS,
                         ids=[c[0] for c in CLIENT_PAIRS])
def test_client_optimizer_bridge_matches_optax(name, make_tx, factory):
    """``wrap_torch`` (the port's ``wrap_optax``) over a torch.optim
    optimizer against the JAX package's ``wrap_optax`` over the optax
    optimizer computing the same step: five steps, params within 1e-5
    (the two libraries round Adam's bias corrections in another order);
    the wrapped step leaves its inputs untouched."""
    rng = np.random.default_rng(6)
    p0 = stacked_tree(rng)
    jo = jax_opt.wrap_optax(make_tx())
    po = opt.wrap_torch(factory)
    assert po.hyperparams["external_lr"] and jo.hyperparams["external_lr"]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    pp = to_torch(p0)
    js, ps = jo.init(jp), po.init(pp)
    for i in range(5):
        g = stacked_tree(rng)
        jp, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                          jnp.asarray(0.0))
        before = opt.tree_map(torch.clone, pp)
        pp_new, ps = po.apply(to_torch(g), ps, pp, torch.tensor(0.0))
        opt.tree_map(lambda a, b: torch.testing.assert_close(
            a, b, atol=0, rtol=0), pp, before)
        pp = pp_new
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_allclose(
                y.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5), jp, pp)
    assert int(ps["step"]) == int(js["step"]) == 5
