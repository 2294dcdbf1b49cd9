"""Pipeline, tensor and data parallelism together: world 8 at {pipe 2,
data 2, model 2} under ZeRO stages 1 and 3 against the JAX
``PipelineEngine`` at that mesh; and the tiny MoE at {pipe 2, data 2,
expert 2} (ZeRO-1, gpipe), the JAX ``test_moe_under_pipeline`` mesh,
against the JAX ``DeepSpeedEngine`` at {data 2} over the same global
micro batches (the JAX test's own oracle: "PP x EP x DP matches pure
DP"; the JAX ``PipelineEngine`` at that mesh stalls in a collective
permute rendezvous on the CPU backend).

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

MESH = {"pipe": 2, "data": 2, "model": 2}
CASES = {"3d_s1": (8, "gpt2", MESH, zero(1), "pipe"),
         "3d_s3": (8, "gpt2", MESH, zero(3), "pipe"),
         # 2 micro batches of one row a rank: the batch is 8 rows over
         # the 4 batch ranks
         "3d_moe": (8, "moe", {"pipe": 2, "data": 2, "expert": 2},
                    {**zero(1), "gradient_accumulation_steps": 2}, "dp")}


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


@pytest.mark.parametrize("check", [check_steps, check_masters, check_bytes],
                         ids=["steps", "masters", "bytes"])
def test_zero3_in_three_dimensions(world, check):
    """ZeRO stage 3 at {pipe 2, data 2, model 2}: each rank keeps 1/2 of
    its stage's model slice and gathers a layer's slice over its data
    pair inside the stage, against the JAX PipelineEngine at that
    mesh."""
    check(world, "3d_s3")


@pytest.mark.parametrize("check", [check_steps, check_masters, check_bytes],
                         ids=["steps", "masters", "bytes"])
def test_moe_over_pipe_data_and_expert(world, check):
    """The MoE at {pipe 2, data 2, expert 2}: each stage routes the whole
    micro batch over its four batch ranks and exchanges the rows within
    each expert pair."""
    check(world, "3d_moe")
