"""Pipeline, tensor and data parallelism together: world 8 at {pipe 2,
data 2, model 2} under ZeRO stage 1 against the JAX ``PipelineEngine``
at that mesh.

Eight gloo ranks on the CPU (``tests/test_torch_pipe.py``'s worker and
harness; a file of its own, so that xdist places it apart), tiny GPT-2,
3 steps from the same params: every rank's loss and grad norm within
1e-5 of the JAX engine's, the masters gathered over the stages, model
slices and data shards within 1e-5 (with PR 19's allowance), each
rank's state bytes by kind the plan's count.
"""
from test_torch_pipe import (check_bytes, check_masters, check_no_jax,
                             check_steps, launch, zero)
import pytest

CASES = {"3d_s1": (8, "gpt2", {"pipe": 2, "data": 2, "model": 2}, zero(1),
                   "pipe")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(str(tmp_path_factory.mktemp("pipe_3d")), CASES)


def test_workers_import_no_jax(world):
    check_no_jax(world)


def test_steps_match_jax_on_every_rank(world):
    check_steps(world, "3d_s1")


def test_gathered_masters_equal_jax(world):
    check_masters(world, "3d_s1")


def test_state_bytes_follow_the_plan(world):
    check_bytes(world, "3d_s1")
