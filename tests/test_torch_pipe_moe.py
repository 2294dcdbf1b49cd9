"""An MoE model under the pipeline: gpipe, picked by ``auto``.

A world of 2 gloo ranks on the CPU (``tests/test_torch_pipe.py``'s
worker and harness) trains the tiny MoE GPT-2 (4 experts on every other
layer) at {pipe 2}, 3 steps from the same params.  Each stage adds its
layers' aux loss, of real micro batches only, to the micro batch's
loss.  Two oracles:

* the JAX ``PipelineEngine`` at {pipe 2}: the losses and the gathered
  masters within 1e-5; its MoE region's gradient is the stage count
  times the true one (its own docstring: the raw psum's transpose
  over-counts by the shard count, which AdamW's scale invariance and the
  clipping hide), so the port's grad norm is held to its norm over S;
* the JAX ``DeepSpeedEngine`` at {data 1}, the same micro batches
  routed alike: loss, grad norm and masters within 1e-5.
"""
import pytest

from test_torch_pipe import (check_bytes, check_masters, check_no_jax,
                             check_steps, launch)

CASES = {"moe": (2, "moe", {"pipe": 2}, {}, "pipe"),
         "moe_dp": (2, "moe", {"pipe": 2}, {}, "dp")}
#: the JAX MoE pipeline region's over-count of the gradient (S)
NORM_OVERCOUNT = {"moe": 2, "moe_dp": 1}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(str(tmp_path_factory.mktemp("pipe_moe")), CASES)


def test_workers_import_no_jax(world):
    check_no_jax(world)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_every_rank(world, name):
    check_steps(world, name, NORM_OVERCOUNT[name])


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_masters_equal_jax(world, name):
    check_masters(world, name)


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_follow_the_plan(world, name):
    check_bytes(world, name)


def test_auto_picks_gpipe_for_moe(world):
    assert world.jax["moe"]["schedule"] == "gpipe"
    for res in world.ranks[2]:
        assert res["moe"]["schedule"] == "gpipe"
