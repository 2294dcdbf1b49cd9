"""Block-sparse attention — counterpart of
``deepspeed_tpu/ops/sparse_attention/``, with the same exports."""
from .blocksparse_flash import (blocksparse_attention,
                                blocksparse_attention_bthd, compress_layout)
from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["blocksparse_attention", "blocksparse_attention_bthd",
           "compress_layout", "SparseSelfAttention", "SparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig"]
