"""Build and load the port's CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``.  Each source
``deepspeed_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled at first use by ``nvcc`` for ``sm_90a`` into its own shared
library under ``deepspeed_tpu_torch/_build/`` (named by a hash of the
sources and flags, so an edited kernel is rebuilt), then loaded with
``ctypes``.  ``build()`` starts one ``nvcc`` per source, all at once.
A failed build raises; nothing falls back.

``launch_counts`` holds one plain integer per kernel: each wrapper adds
one where it launches its kernel, so a run can show which kernels its
path went through.  The quantized variants of B6 and B7 (int8 and packed
int4 pools) are counted under keys of their own (``COUNTERS``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: every kernel source of the port, by library name
KERNELS = ("decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "blocksparse_flash_fwd",
           "blocksparse_flash_bwd_dq", "blocksparse_flash_bwd_dkv")

#: the kernels with quantized-pool variants, and the kv_bits they take
QUANT_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
QUANT_BITS = (8, 4)

#: every launch counter: one per kernel, one per quantized variant
COUNTERS = KERNELS + tuple(f"{name}_int{bits}" for name in QUANT_KERNELS
                           for bits in QUANT_BITS)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last reset (see reset_launch_counts)
launch_counts: Dict[str, int] = {name: 0 for name in COUNTERS}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def counter(kernel: str, kv_bits: int = 0) -> str:
    """The launch counter of ``kernel`` over a pool of ``kv_bits``."""
    return f"{kernel}_int{kv_bits}" if kv_bits else kernel


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by the
    content of every source it includes and the flags."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel library {name!r}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  The compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``<library>.log``."""
    names = list(names)
    targets = {n: library_path(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = tempfile.NamedTemporaryFile(
            dir=BUILD_DIR, prefix=f".{n}-", suffix=".so", delete=False)
        tmp.close()
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp.name,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        Path(f"{targets[n]}.log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({fn(code).decode()})")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_layout(what: str, tensors, head_dim: int, elem_size: int) -> None:
    """What every kernel here needs of its operands: contiguous tensors,
    16-byte aligned data (the kernels load rows with 16-byte vectors), and
    a row of ``head_dim`` elements that a power-of-two group of at most
    32 lanes covers at 16 bytes each."""
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} not 16-byte aligned")
    lanes, rem = divmod(head_dim * elem_size, 16)
    if rem or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"{what} kernel: head_dim {head_dim} x "
                         f"{elem_size} bytes must be 16 x a power of two "
                         f"<= 32")


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the "
                        f"kernel (float32 or bfloat16)")
    return code
