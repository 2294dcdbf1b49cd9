"""Build and load the port's CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``.  Each source
``deepspeed_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled at first use by ``nvcc`` for ``sm_90a`` into its own shared
library under ``deepspeed_tpu_torch/_build/`` (named by a hash of the
sources and flags, so an edited kernel is rebuilt), then loaded with
``ctypes``.  ``build()`` compiles every source to objects, all at once
(one ``nvcc -c`` per source, or per part of a source listed in
``PARTS``: ``-DDSTT_PART=p``, each part a share of its instantiations),
and links each source's objects into its library.  A failed build
raises; nothing falls back.

``launch_counts`` holds one plain integer per kernel: each wrapper adds
one where it launches its kernel, so a run can show which kernels its
path went through.  The quantized variants of B6 and B7 (int8 and packed
int4 pools) and the float16 variants of every kernel are counted under
keys of their own (``COUNTERS``).

The host libraries (``HOST_LIBS``: ``csrc/<name>.cpp``, host C++: the
aio thread pool under the NVMe tier and the offload tiers' CPU Adam) are
built by ``g++`` instead,
as the JAX package's ``ops/op_builder.py`` builds them: one shared
library each, named by a hash of the source, the flags and the host
CPU's fingerprint (``-march=native`` code must not run on a lesser CPU),
loaded with ``ctypes`` by :func:`load_host_library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

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

#: the flash kernels B1-B4
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

_BF16_COUNTERS = KERNELS + tuple(f"{name}_int{bits}" for name in QUANT_KERNELS
                                 for bits in QUANT_BITS)
#: every launch counter: one per kernel and per quantized variant, each
#: also at float16
COUNTERS = _BF16_COUNTERS + tuple(f"{name}_f16" for name in _BF16_COUNTERS)

#: the compile flags (a whole library built in one call adds ``-shared``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: sources compiled as several objects in parallel, and how many: B6's
#: 16-bit kernels at every head dim, kv_bits and dtype are its slowest
#: compile by far (one part per kv_bits; the source says which part holds
#: what)
PARTS = {"paged_decode_attention": 3}

#: launches per kernel since the last reset (see reset_launch_counts)
launch_counts: Dict[str, int] = {name: 0 for name in COUNTERS}

_libs: Dict[str, ctypes.CDLL] = {}

#: the libraries a ``build_in_background()`` thread still compiles, each
#: with the event set once it is linked or its build has failed:
#: ``load_library`` waits for that instead of compiling it a second time
_pending: Dict[str, threading.Event] = {}
#: the compilers running now (``stop_builds`` ends them)
_running: set = set()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def counter(kernel: str, kv_bits: int = 0,
            dtype: Optional[torch.dtype] = None) -> str:
    """The launch counter of ``kernel`` over a pool of ``kv_bits`` on
    operands of ``dtype`` (quantized and float16 launches count apart)."""
    name = f"{kernel}_int{kv_bits}" if kv_bits else kernel
    return f"{name}_f16" if dtype == torch.float16 else name


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
    h.update(f"parts {PARTS.get(name, 1)}".encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _temp(suffix: str, name: str) -> str:
    tmp = tempfile.NamedTemporaryFile(dir=BUILD_DIR, prefix=f".{name}-",
                                      suffix=suffix, delete=False)
    tmp.close()
    return tmp.name


def build(names: Iterable[str] = KERNELS,
          on_built: Optional[Callable[[str, Path], None]] = None
          ) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet: one
    ``nvcc -c`` per source (per part of a source in ``PARTS``), all
    started together, each source's objects linked into its library as
    they are done.  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as
    ``<library>.log``, each part's ending with the compiler's wall time.
    ``on_built(name, path)`` is called for each library as soon as it is
    there (at once for one built before), while the others still
    compile."""
    names = list(names)
    targets = {n: library_path(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if on_built is not None:
        for n in names:
            if n not in todo:
                on_built(n, targets[n])
    if not todo:
        return targets
    try:
        return _compile(todo, targets, on_built)
    finally:
        for n in todo:
            _release(n)


def _release(name: str) -> None:
    """Wake whoever waits in ``load_library`` for ``name``."""
    event = _pending.pop(name, None)
    if event is not None:
        event.set()


def _compile(todo, targets, on_built) -> Dict[str, Path]:
    """``build``'s compile and link of the libraries ``todo``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    started = time.perf_counter()
    for n in todo:
        parts = PARTS.get(n, 1)
        for part in range(parts):
            out = _temp(f".part{part}.o", n)
            flags = [f"-DDSTT_PART={part}"] if parts > 1 else []
            # the report goes straight to a file: through a pipe read in
            # turn, a compiler whose report outgrew the pipe would wait
            # for the ones before it
            log = open(f"{targets[n]}.part{part}.log", "w")
            procs[n, part] = (out, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", *flags, "-I", str(CSRC), "-o", out,
                 str(CSRC / f"{n}.cu")], stdout=log, stderr=subprocess.STDOUT))
            _running.add(procs[n, part][2])
    failed, done = [], {}
    while procs:
        for (n, part), (out, log, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            _running.discard(proc)
            log.write(f"\nnvcc wall time: "
                      f"{time.perf_counter() - started:.1f} s\n")
            log.close()
            del procs[n, part]
            if proc.returncode != 0:
                os.unlink(out)
                failed.append(f"{n}.cu part {part} (exit "
                              f"{proc.returncode}):\n"
                              f"{Path(log.name).read_text()}")
                continue
            done.setdefault(n, {})[part] = (out, log.name)
            if len(done[n]) == PARTS.get(n, 1):
                bad = _link(nvcc, n, done.pop(n), targets[n])
                failed += bad
                if not bad and on_built is not None:
                    on_built(n, targets[n])
                _release(n)
        if procs:
            time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def _link(nvcc: str, name: str, parts: Dict[int, tuple],
          target: Path) -> list:
    """Link a source's objects into its library, their reports joined
    into its log; the failures, if any."""
    objs = [parts[p][0] for p in sorted(parts)]
    out = _temp(".so", name)
    link = subprocess.run([nvcc, "-gencode", NVCC_FLAGS[1], "-shared", "-o",
                           out, *objs], capture_output=True, text=True)
    with open(f"{target}.log", "w") as log:
        for p in sorted(parts):
            log.write(Path(parts[p][1]).read_text())
            os.unlink(parts[p][1])
        log.write(link.stdout + link.stderr)
    for obj in objs:
        os.unlink(obj)
    if link.returncode != 0:
        os.unlink(out)
        return [f"{name}: linking its objects (exit {link.returncode}):\n"
                f"{link.stdout}{link.stderr}"]
    os.replace(out, target)
    return []


def build_in_background(names: Iterable[str] = KERNELS,
                        on_built: Optional[Callable[[str, Path], None]]
                        = None) -> threading.Thread:
    """``build(names, on_built)`` on a thread of its own, started before
    this returns; the thread's ``result`` dict gets ``libs`` (or
    ``error``) and ``seconds``.  Meanwhile ``load_library`` of a library
    still compiling waits until it is linked, so a caller can use each
    kernel as soon as its own library is there."""
    names = list(names)
    for n in names:
        if not library_path(n).exists():
            _pending.setdefault(n, threading.Event())
    result: dict = {}

    def run():
        t0 = time.perf_counter()
        try:
            result["libs"] = build(names, on_built)
        except BaseException as e:      # handed to the joining thread
            result["error"] = e
        finally:
            result["seconds"] = time.perf_counter() - t0
            for n in names:
                _release(n)
    thread = threading.Thread(target=run, name="kernel-build", daemon=True)
    thread.result = result
    thread.start()
    return thread


def stop_builds() -> None:
    """Kill every compiler a build still runs (a caller failing early)."""
    for proc in list(_running):
        if proc.poll() is None:
            proc.kill()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (or,
    while a background build compiles it, once that build has linked
    it)."""
    lib = _libs.get(name)
    if lib is None:
        pending = _pending.get(name)
        if pending is not None:
            pending.wait()
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib


# -- host libraries (g++) -----------------------------------------------------
#: every host C++ source of the port, by library name
HOST_LIBS = ("aio", "cpu_adam")
#: the host compile flags (the JAX package's ``op_builder.py``)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-march=native",
             "-funroll-loops", "-std=c++17", "-pthread")

_host_libs: Dict[str, ctypes.CDLL] = {}


def _cpu_fingerprint() -> bytes:
    """The machine and the first CPU flags line: a ``-march=native``
    library must never be shared with a host of another CPU."""
    out = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features", b"model name")):
                    return out + line
    except OSError:
        pass
    return out


def host_library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cpp`` lives, keyed by its
    source, the flags and the host CPU."""
    if name not in HOST_LIBS:
        raise KeyError(f"unknown host library {name!r}")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    h.update(_cpu_fingerprint())
    return BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:16]}.so"


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cpp``, compiled by
    ``g++`` at first use into ``_build/``; a failed build raises."""
    lib = _host_libs.get(name)
    if lib is not None:
        return lib
    target = host_library_path(name)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the host library "
                               f"{name} is built from source at first use")
        out = _temp(".so", name)
        proc = subprocess.run([gxx, *GXX_FLAGS, str(CSRC / f"{name}.cpp"),
                               "-o", out], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(out)
            raise RuntimeError(f"g++ failed for {name}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(out, target)   # atomic: no torn library on a race
    lib = ctypes.CDLL(str(target))
    _host_libs[name] = lib
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


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# -- the kernels' shape gate ----------------------------------------------------
#: head dims of the flash (B1-B4) and block-sparse (B8-B10) kernels: the
#: multiples of 16 up to 256 (``csrc`` DSTT_FLASH_HEAD_DIMS)
FLASH_HEAD_DIMS = tuple(range(16, 257, 16))
#: head dims of the decode kernels B5, B6, B7 at bf16 and f16: the multiples of 8
#: up to 256, the reference's ``head_dim % 8`` gate (DSTT_DECODE_HEAD_DIMS)
DECODE_HEAD_DIMS = tuple(range(8, 257, 8))
#: dynamic shared memory one block can use on sm_90 (``csrc`` kMaxSmem)
MAX_SMEM = 232448

SPARSE_KERNELS = ("blocksparse_flash_fwd", "blocksparse_flash_bwd_dq",
                  "blocksparse_flash_bwd_dkv")
DECODE_KERNELS = ("decode_attention", "paged_decode_attention",
                  "paged_prefill_attention")

#: (f32 tiles of [64, D + 1], [64, 65] probability tiles, [64] row
#: statistics) of each f32 CUDA-core kernel's shared memory
_F32_TILES = {"flash_attention_fwd": (3, 1, 0),
              "flash_attention_bwd": (4, 2, 2),
              "flash_attention_bwd_dq": (4, 1, 2),
              "flash_attention_bwd_dkv": (4, 2, 2),
              "blocksparse_flash_fwd": (3, 1, 0),
              "blocksparse_flash_bwd_dq": (4, 1, 2),
              "blocksparse_flash_bwd_dkv": (4, 2, 2)}

#: the ROADMAP queue C items that name what stays refused
C1_REST = ("ROADMAP queue C item C1's remainder: flash head dims that are "
           "not a multiple of 16, and any head dim above 256")
C1_F32 = ("ROADMAP queue C item C1's remainder: the float32 kernels keep "
          "their first designs")


def _f32_smem(name: str, d: int) -> int:
    tiles, probs, stats = _F32_TILES[name]
    return 4 * (tiles * 64 * (d + 1) + probs * 64 * 65 + stats * 64)


def _pow2_lanes(d: int, elem_bytes: int) -> bool:
    lanes, rem = divmod(d * elem_bytes, 16)
    return not rem and 0 < lanes <= 32 and not lanes & (lanes - 1)


def kernel_supports(name: str, d: int, g: int = 1,
                    dtype: torch.dtype = torch.bfloat16, kv_bits: int = 0,
                    block: Optional[int] = None) -> Optional[str]:
    """None when kernel library ``name`` takes head dim ``d``, kv group
    ``g`` (query heads per kv head), ``dtype``, a pool of ``kv_bits`` and
    a block-sparse layout ``block``; else why not.  Pure Python: the
    wrappers raise with this reason, and the model's paged path
    (``TransformerLM._paged_supported``) reads the same rule, so a server
    is never built at a shape its kernels refuse."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel library {name!r}")
    if dtype not in DTYPE_CODES:
        return f"{name}: dtype {dtype} (float32, bfloat16 or float16)"
    if g < 1:
        return f"{name}: kv group {g} < 1"
    if name in FLASH_KERNELS or name in SPARSE_KERNELS:
        if d not in FLASH_HEAD_DIMS:
            return f"{name}: head_dim {d} ({C1_REST})"
        if dtype == torch.float32 and _f32_smem(name, d) > MAX_SMEM:
            return (f"{name}: float32 at head_dim {d} needs "
                    f"{_f32_smem(name, d)} bytes of shared memory "
                    f"(> {MAX_SMEM}); bfloat16 takes it ({C1_F32})")
        if name in SPARSE_KERNELS and block is not None and (
                block < 16 or block % 16):
            return f"{name}: layout block {block} is not a multiple of 16"
        return None
    if kv_bits not in (0, 8, 4):
        return f"{name}: kv_bits {kv_bits} not in (0, 8, 4)"
    if name == "decode_attention" and kv_bits:
        return f"{name}: a dense cache holds no quantized rows"
    if dtype != torch.float32 or name == "paged_prefill_attention":
        if d not in DECODE_HEAD_DIMS:
            return (f"{name}: head_dim {d} is not a multiple of 8 up to 256"
                    + (f" ({C1_REST})" if d % 8 == 0 else ""))
        return None
    # float32 B5 and B6 keep their first designs: a warp's power-of-two
    # lane group over a row of 16-byte vectors (8 features a lane when
    # quantized), and B6's query group in (1, 2, 4, 8)
    if not _pow2_lanes(d, 2 if kv_bits else 4):
        return (f"{name}: float32 head_dim {d} is not 16 bytes x a power "
                f"of two <= 32 ({'8 features' if kv_bits else '4'} a lane); "
                f"bfloat16 takes every multiple of 8 up to 256 ({C1_F32})")
    if name == "paged_decode_attention" and g not in (1, 2, 4, 8):
        return (f"{name}: float32 kv group {g} not in (1, 2, 4, 8); "
                f"bfloat16 takes any ({C1_F32})")
    return None


def check_supports(name: str, d: int, g: int = 1,
                   dtype: torch.dtype = torch.bfloat16, kv_bits: int = 0,
                   block: Optional[int] = None) -> None:
    """Raise ``ValueError`` with :func:`kernel_supports`'s reason."""
    why = kernel_supports(name, d, g, dtype, kv_bits, block)
    if why is not None:
        raise ValueError(f"{why} (the kernel does not take it)")


def group_parts(g: int, d: int, max_group_dim: int) -> int:
    """Blocks the decode kernels B5 and B6 split a kv head's group of ``g``
    query heads into: the fewest parts whose heads (a divisor of g) hold at
    most ``max_group_dim`` output features.  Each part reads the kv head's
    rows again; nothing is copied at query-head width."""
    parts = max(1, -(-g * d // max_group_dim))
    while g % parts:
        parts += 1
    return parts


def check_layout(what: str, tensors) -> None:
    """What every kernel here needs of its operands: contiguous tensors
    and 16-byte aligned data (the kernels load rows with 16-byte
    vectors)."""
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} not 16-byte aligned")


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the "
                        f"kernel (float32, bfloat16 or float16)")
    return code
