"""fp16 training: dynamic loss scaling (``loss_scaler``)."""
from .loss_scaler import DynamicLossScaler, LossScaleState, static_loss_scaler

__all__ = ["DynamicLossScaler", "LossScaleState", "static_loss_scaler"]
