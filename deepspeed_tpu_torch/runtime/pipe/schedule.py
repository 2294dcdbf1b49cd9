"""Pipeline instruction schedules.

Counterpart of ``deepspeed_tpu/runtime/pipe/schedule.py`` (the
reference's ``runtime/pipe/schedule.py``), plain Python: a
``PipeSchedule`` yields, for each step of one stage, the list of
instructions it runs (``LoadMicroBatch``, ``ForwardPass``,
``BackwardPass``, ``Send``/``RecvActivation``, ``Send``/``RecvGrad``,
then ``ReduceTiedGrads``, ``ReduceGrads`` and ``OptimizerStep``).  The
JAX package keeps these lists as the semantic specification of its
compiled loop; the port's pipeline engine (``engine.py``) interprets
them, one process a stage, exchanging activations and their gradients
by point-to-point sends on the ``pipe`` axis.
"""
from __future__ import annotations

from typing import Iterator, List

from ..utils import call_to_str


class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        return call_to_str(self.name, **self.kwargs)

    def __eq__(self, other):
        return (self.__class__ is other.__class__
                and self.kwargs == other.kwargs)


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class ForwardPass(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class BackwardPass(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class SendActivation(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class RecvActivation(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class SendGrad(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class RecvGrad(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class PipeSchedule:
    """Base: yields one list of instructions a step (the reference's
    ``schedule.py:7``)."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    @property
    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Fill-drain forward only (the reference's ``schedule.py:129``)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id
            if 0 <= micro_batch_id < self.micro_batches:
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(micro_batch_id % 2))
                else:
                    cmds.append(RecvActivation(micro_batch_id % 2))
                cmds.append(ForwardPass(micro_batch_id % 2))
                if not self.is_last_stage:
                    cmds.append(SendActivation(micro_batch_id % 2))
            yield cmds

    @property
    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B (the reference's ``schedule.py:182``): warm-up forwards, then
    a forward and a backward in turn, cool-down backwards, then the
    reductions and the optimizer step."""

    def steps(self):
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            cmds = []
            if self._valid_micro_batch(micro_batch_id):
                buf = self._buffer_idx(micro_batch_id)
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(buf))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(buf))
                    cmds.append(ForwardPass(buf))
                    if self._valid_stage(self.next_stage):
                        cmds.append(SendActivation(buf))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(buf))
                    cmds.append(BackwardPass(buf))
                    if self._valid_stage(self.prev_stage):
                        cmds.append(SendGrad(buf))
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            yield cmds

    def _valid_micro_batch(self, mb: int) -> bool:
        return 0 <= mb < self.micro_batches

    def _valid_stage(self, stage: int) -> bool:
        return 0 <= stage < self.stages

    @property
    def num_pipe_buffers(self):
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        def _is_even(x):
            return x % 2 == 0

        if _is_even(step_id) and _is_even(self.stage_id):
            return self._even_step_forward_id(step_id), True
        if not _is_even(step_id) and not _is_even(self.stage_id):
            return self._odd_step_forward_id(step_id), True
        if _is_even(step_id) and not _is_even(self.stage_id):
            return self._even_step_backward_id(step_id), False
        return self._odd_step_backward_id(step_id), False

    def _even_step_forward_id(self, step_id):
        return step_id // 2 - self.stage_id // 2

    def _odd_step_forward_id(self, step_id):
        return (step_id - 1) // 2 - self.stage_id // 2

    def _even_step_backward_id(self, step_id):
        return step_id // 2 - self.stages + (self.stage_id + 1) // 2

    def _odd_step_backward_id(self, step_id):
        return (step_id - 1) // 2 - self.stages + 1 + self.stage_id // 2

    def _buffer_idx(self, micro_batch_id):
        return micro_batch_id % self.num_pipe_buffers
