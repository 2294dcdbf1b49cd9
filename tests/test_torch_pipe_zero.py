"""Pipeline parallelism with ZeRO over data: the port's ranks against the
JAX data-parallel engine.

A world of 4 gloo ranks on the CPU (``tests/test_torch_pipe.py``'s
worker and harness) trains tiny GPT-2 at {pipe 4} and {pipe 2, data 2}
under ZeRO stages 0, 1 and 2, 3 steps each from the same params; the
JAX ``DeepSpeedEngine`` on the matching data mesh ({data 1}, {data 2})
is the oracle: the JAX ``PipelineEngine`` fails at a model axis of 1 on
this JAX (its region specs keep ``model`` there), and the pipeline's
loss is the data-parallel engine's, the equivalence the JAX package's
own pipeline tests assert.  Every rank's loss and grad norm within
1e-5, the gathered masters within 1e-5 (with PR 19's allowance), each
rank's state bytes by kind the plan's count.
"""
import pytest

from test_torch_pipe import (check_bytes, check_masters, check_no_jax,
                             check_steps, launch, zero)

CASES = {
    **{f"pipe4_s{s}": (4, "gpt2", {"pipe": 4}, zero(s), "dp")
       for s in (0, 1, 2)},
    **{f"pipe2_data2_s{s}": (4, "gpt2", {"pipe": 2, "data": 2}, zero(s),
                             "dp") for s in (0, 1, 2)},
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(str(tmp_path_factory.mktemp("pipe_zero")), CASES)


def test_workers_import_no_jax(world):
    check_no_jax(world)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_every_rank(world, name):
    check_steps(world, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_masters_equal_jax(world, name):
    check_masters(world, name)


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_follow_the_plan(world, name):
    check_bytes(world, name)
