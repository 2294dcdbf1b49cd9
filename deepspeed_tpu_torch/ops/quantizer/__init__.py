"""Quantization ops — counterpart of ``deepspeed_tpu/ops/quantizer/``
(the serving codecs; the fake-quant functions come with compression)."""
from .quantizer import (dequantize, kv_dequantize, kv_quantize, pack_int4,
                        quantize, unpack_int4)

__all__ = ["quantize", "dequantize", "pack_int4", "unpack_int4",
           "kv_quantize", "kv_dequantize"]
