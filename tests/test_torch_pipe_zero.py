"""Pipeline parallelism with ZeRO over data: the port's ranks against the
JAX data-parallel engine.

A world of 4 gloo ranks on the CPU (``tests/test_torch_pipe.py``'s
worker and harness) trains tiny GPT-2 at {pipe 4} under ZeRO stages
0-2 and at {pipe 2, data 2} under stages 0-3 (stage 3 gathering a layer
at a time inside each stage), 3 steps each from the same params; the
JAX ``DeepSpeedEngine`` on the matching data mesh ({data 1}, {data 2})
is the oracle: the JAX ``PipelineEngine`` fails at a model axis of 1 on
this JAX (its region specs keep ``model`` there), and the pipeline's
loss is the data-parallel engine's, the equivalence the JAX package's
own pipeline tests assert.  Every rank's loss and grad norm within
1e-5, the gathered masters within 1e-5 (with PR 19's allowance), each
rank's state bytes by kind the plan's count.

The same world runs the compat ``forward``/``backward``/``step`` at
{pipe 2, data 2} stage 1 (held to ``train_step`` there and to the JAX
compat API at {data 2}) and the tiny MoE GPT-2 at {pipe 2, data 2}
under gpipe and stage 1 against the JAX ``PipelineEngine`` at that mesh
(its grad norm over S, as ``tests/test_torch_pipe_moe.py`` holds it),
with ``eval_loss``, and at {pipe 2, expert 2} (each stage's expert
stacks cut over ``expert``, the rows exchanged by ``all_to_all``); and LAMB (its trust ratio over the whole
stage-stacked leaf, each rank's pieces' sums made whole by
``leaf_sums``) at {pipe 2, data 2} with ZeRO stage 1, held to the JAX
data-parallel engine, and at {pipe 2, model 2}, held to the JAX
``PipelineEngine`` there.
"""
import numpy as np
import pytest

from test_torch_pipe import (TP, check_bytes, check_masters, check_no_jax,
                             check_resume, check_steps, launch, zero)

PD = {"pipe": 2, "data": 2}
LAMB = {"optimizer": {"type": "Lamb",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}}}
#: stages 1-3 are held to the JAX data-parallel engine of their mesh's
#: stage 0 case (every JAX stage computes the same function; the masters
#: are compared gathered whole), so one engine's compilation serves them
CASES = {
    **{f"pipe4_s{s}": (4, "gpt2", {"pipe": 4}, zero(s),
                       "dp" if s == 0 else "pipe4_s0")
       for s in (0, 1, 2)},
    **{f"pipe2_data2_s{s}": (4, "gpt2", PD, zero(s),
                             "dp" if s == 0 else "pipe2_data2_s0")
       for s in (0, 1, 2, 3)},
    "compat_pipe2_data2_s1": (4, "gpt2", PD, zero(1), "dp_compat"),
    "moe_pipe2_data2": (4, "moe", PD, zero(1), "pipe"),
    "moe_pipe2_expert2": (4, "moe", {"pipe": 2, "expert": 2}, zero(1),
                          "pipe"),
    "lamb_pipe2_data2_s1": (4, "gpt2", PD, {**LAMB, **zero(1)}, "dp"),
    "lamb_pipe2_model2": (4, "gpt2", TP, LAMB, "pipe"),
}
#: the axis groups of LAMB's one leaf-sum call a step: the blocks' pieces
#: over data (stage 1) or model, and over the stages
LEAF_SUM_AXES = {"lamb_pipe2_data2_s1": ("data", "pipe"),
                 "lamb_pipe2_model2": ("model", "pipe")}
#: the JAX MoE pipeline region's over-count of the gradient (S)
NORM_OVERCOUNT = {"moe_pipe2_data2": 2, "moe_pipe2_expert2": 2}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(str(tmp_path_factory.mktemp("pipe_zero")), CASES)


def test_workers_import_no_jax(world):
    check_no_jax(world)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_every_rank(world, name):
    check_steps(world, name, NORM_OVERCOUNT.get(name, 1))


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_masters_equal_jax(world, name):
    check_masters(world, name)


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_follow_the_plan(world, name):
    check_bytes(world, name)


def test_compat_surface_equals_train_step(world):
    """``forward`` + ``backward`` + ``step`` at {pipe 2, data 2} (the
    schedule's forwards, its backwards, the step's reductions) give what
    ``train_step`` gives from the same state, on every rank, within 1e-5;
    the JAX compat API's result is checked above."""
    for res in world.ranks[4]:
        np.testing.assert_allclose(res["compat_pipe2_data2_s1"]["rows"],
                                   res["pipe2_data2_s1"]["rows"], rtol=1e-5,
                                   atol=0)
    a = {k.split("/", 1)[1]: v for k, v in world.whole[4].items()
         if k.startswith("compat_pipe2_data2_s1/")}
    b = {k.split("/", 1)[1]: v for k, v in world.whole[4].items()
         if k.startswith("pipe2_data2_s1/")}
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_moe_routes_the_whole_micro_batch(world):
    """MoE at {pipe 2, data 2} under gpipe: each MoE layer routes the
    global micro batch (its rows gathered over the data ranks), so every
    rank's losses equal the JAX pipeline's, which routes it whole; its
    ``eval_loss`` routes the whole batch at once, as the JAX engine's
    ``eval_loss`` does, on every rank."""
    want = world.jax["moe_pipe2_data2"]
    assert want["schedule"] == "gpipe"
    for res in world.ranks[4]:
        got = res["moe_pipe2_data2"]
        assert got["schedule"] == "gpipe"
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)


def test_zero3_checkpoint_resumes_bit_equal(world):
    """ZeRO stage 3 at {pipe 2, data 2}: each rank's shards of its
    stage's slice gathered into the JAX layout by rank 0, re-sharded on
    load."""
    check_resume(world, "pipe2_data2_s3")


@pytest.mark.parametrize("name", list(LEAF_SUM_AXES))
def test_lamb_makes_one_leaf_sum_all_reduce_an_axis_group(world, name):
    """LAMB under the pipeline: one ``leaf_sums`` call a step, which makes
    one all-reduce an axis group its leaves are cut along (the tied
    embedding and the final norm, held whole by both stages, cross in
    no pipe sum), on every rank."""
    want = LEAF_SUM_AXES[name]
    for res in world.ranks[4]:
        for calls, axes in res[name]["leaf_sums"]:
            assert calls == 1
            assert len(axes) == len(want)
            for got, axis in zip(axes, want):
                assert axis in got, (axes, want)
