from .engine import (get_fp32_state_dict_from_zero_checkpoint,
                     load_checkpoint, save_checkpoint, wait_pending)

__all__ = ["get_fp32_state_dict_from_zero_checkpoint", "load_checkpoint",
           "save_checkpoint", "wait_pending"]
