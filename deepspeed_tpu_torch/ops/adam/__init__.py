"""Host optimizers of the offload tiers (``csrc/cpu_adam.cpp``)."""
from .cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam

__all__ = ["DeepSpeedCPUAdam", "DeepSpeedCPUAdagrad"]
