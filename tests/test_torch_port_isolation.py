"""The PyTorch port stands alone: it never imports ``jax``, ``pydantic``,
``orbax``, ``optax``, ``transformers`` or anything of ``deepspeed_tpu``
(importing any ``deepspeed_tpu`` submodule runs the package
``__init__``, which pulls in jax and the training engine; the card's
machine has no ``transformers``, so the policies read Hugging Face
configs and state dicts by duck typing)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pydantic", "orbax", "optax",
             "deepspeed_tpu", "flax", "ml_dtypes", "transformers")


def port_modules():
    for path in sorted(PORT.rglob("*.py")):
        if "_build" in path.parts:
            continue
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("module,path", list(port_modules()),
                         ids=[m for m, _ in port_modules()])
def test_source_has_no_forbidden_import(module, path):
    """Top-level and function-level imports alike (``ml_dtypes`` is the
    one lazy exception: it is reached only to hand a bf16 tree back to
    numpy for the JAX side)."""
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if _forbidden(n) and n != "ml_dtypes"]
    assert not bad, f"{module} imports {bad}"


def test_importing_every_module_loads_no_forbidden_package():
    mods = [m for m, _ in port_modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}"
        " and m != 'deepspeed_tpu_torch' and not m.startswith("
        "'deepspeed_tpu_torch.')]\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


@pytest.mark.parametrize("script", ["b5_variants.py", "paged_variants.py",
                                    "drain_profile.py"])
def test_card_scripts_import_nothing_of_jax(script):
    """The root scripts that run on the card's machine (which has no jax)
    import neither jax nor the JAX package."""
    tree = ast.parse((REPO / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


@pytest.mark.parametrize("module", [
    "deepspeed_tpu_torch.moe", "deepspeed_tpu_torch.moe.layer",
    "deepspeed_tpu_torch.moe.sharded_moe",
    "deepspeed_tpu_torch.models.diffusion",
    "deepspeed_tpu_torch.module_inject.diffusion_policies"])
def test_moe_and_diffusion_modules_are_checked(module):
    """The MoE and diffusion modules are among the modules whose imports
    the checks above read, and import alone: loading one in a fresh
    interpreter loads no forbidden package."""
    assert module in dict(port_modules())
    code = (f"import importlib, json, sys\n"
            f"importlib.import_module({module!r})\n"
            f"print(json.dumps(sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


#: the modules of the tiered host cache and the fleet
HOST_TIER_AND_FLEET = (
    "deepspeed_tpu_torch.ops.aio", "deepspeed_tpu_torch.ops.aio.aio_handle",
    "deepspeed_tpu_torch.runtime.swap_tensor",
    "deepspeed_tpu_torch.runtime.swap_tensor.slot_store",
    "deepspeed_tpu_torch.inference.serving.host_cache",
    "deepspeed_tpu_torch.inference.serving.fleet",
    "deepspeed_tpu_torch.inference.serving.fleet.replica",
    "deepspeed_tpu_torch.inference.serving.fleet.router",
    "deepspeed_tpu_torch.inference.serving.fleet.autoscaler",
    "deepspeed_tpu_torch.elasticity",
    "deepspeed_tpu_torch.elasticity.serving_fleet",
    "deepspeed_tpu_torch.observability.fleet_metrics",
    "deepspeed_tpu_torch.observability.fleet_trace")


#: what builds or loads a library
BUILDERS = {"build", "load_library", "load_host_library", "_lib"}


def _import_time_calls(tree):
    """Names called by the statements a module runs at import (its body
    outside functions), class bodies included."""
    stack, names = list(tree.body), []
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            f = node.func
            names.append(f.id if isinstance(f, ast.Name)
                         else getattr(f, "attr", ""))
        stack.extend(ast.iter_child_nodes(node))
    return names


@pytest.mark.parametrize("module", HOST_TIER_AND_FLEET)
def test_host_tier_and_fleet_modules_are_checked(module):
    """The host tier's and the fleet's modules are among the modules
    whose imports the checks above read, and none builds or loads a
    library while it is imported (``csrc/aio.cpp`` is compiled at first
    use, not at import)."""
    modules = dict(port_modules())
    assert module in modules
    calls = _import_time_calls(ast.parse(modules[module].read_text()))
    assert not BUILDERS & set(calls), f"{module} builds at import"


def test_host_tier_and_fleet_import_alone():
    """Importing the host tier's and the fleet's modules in a fresh
    interpreter loads no forbidden package and builds or loads no
    library."""
    code = (f"import importlib, json, sys\n"
            f"for m in {HOST_TIER_AND_FLEET!r}:\n"
            f"    importlib.import_module(m)\n"
            f"from deepspeed_tpu_torch.ops import build\n"
            f"print(json.dumps([sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}), sorted(build._host_libs),"
            f" sorted(build._libs)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], [], []]


def test_aio_host_library_builds_from_its_source(tmp_path):
    """``csrc/aio.cpp`` is the port's own copy, built by g++ through
    ``ops/build.py`` into ``_build/`` under a name keyed by its source,
    its flags and the host CPU; the handle reads back what it wrote."""
    import numpy as np
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.aio import (AsyncIOHandle, PinnedBuffer,
                                             aio_available,
                                             odirect_fallbacks)
    assert (PORT / "csrc" / "aio.cpp").is_file()
    assert "-march=native" in build.GXX_FLAGS
    path = build.host_library_path("aio")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libaio")
    assert aio_available() and path.exists()
    assert build.load_host_library("aio") is build.load_host_library("aio")
    with pytest.raises(KeyError):
        build.host_library_path("nope")
    before = odirect_fallbacks()
    h = AsyncIOHandle()
    src, dst = PinnedBuffer(8192), PinnedBuffer(8192)
    src.array[:] = np.arange(8192) % 251
    f = tmp_path / "slots.swp"
    f.write_bytes(b"\0" * 16384)
    h.sync_pwrite(src.array, str(f), 4096)
    h.sync_pread(dst.array, str(f), 4096)
    assert (dst.array == src.array).all()
    assert odirect_fallbacks() >= before
    with pytest.raises(OSError):
        h.sync_pread(dst.array, str(tmp_path / "missing.swp"), 0)
    h.close()


#: the offload slice's modules
OFFLOAD = (
    "deepspeed_tpu_torch.ops.adam", "deepspeed_tpu_torch.ops.adam.cpu_adam",
    "deepspeed_tpu_torch.runtime.zero",
    "deepspeed_tpu_torch.runtime.zero.offload",
    "deepspeed_tpu_torch.runtime.zero.infinity",
    "deepspeed_tpu_torch.runtime.zero.wire_codec",
    "deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper")


@pytest.mark.parametrize("module", OFFLOAD)
def test_offload_modules_are_checked(module):
    """The offload modules are among the modules whose imports the checks
    above read, and none builds or loads a library while it is imported
    (``csrc/cpu_adam.cpp`` is compiled at first use)."""
    modules = dict(port_modules())
    assert module in modules
    calls = _import_time_calls(ast.parse(modules[module].read_text()))
    assert not BUILDERS & set(calls), f"{module} builds at import"


def test_offload_modules_import_alone():
    """Importing the offload modules in a fresh interpreter loads no
    forbidden package and builds or loads no library."""
    code = (f"import importlib, json, sys\n"
            f"for m in {OFFLOAD!r}:\n"
            f"    importlib.import_module(m)\n"
            f"from deepspeed_tpu_torch.ops import build\n"
            f"print(json.dumps([sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}), sorted(build._host_libs),"
            f" sorted(build._libs)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], [], []]


def test_cpu_adam_source_is_the_ports_own_copy():
    """``csrc/cpu_adam.cpp`` lives in the port, and its code (everything
    after the header comment) is the JAX package's source, so both
    libraries give the same bits; it is built from the port's file."""
    from deepspeed_tpu_torch.ops import build
    mine = (PORT / "csrc" / "cpu_adam.cpp").read_text()
    ref = (REPO / "deepspeed_tpu" / "ops" / "csrc" / "cpu_adam.cpp").read_text()
    start = "#include <cmath>"
    assert mine[mine.index(start):] == ref[ref.index(start):]
    assert "cpu_adam" in build.HOST_LIBS
    path = build.host_library_path("cpu_adam")
    assert path.parent == build.BUILD_DIR


#: the modules tensor parallelism runs through
TENSOR_PARALLEL = (
    "deepspeed_tpu_torch.comm.comm", "deepspeed_tpu_torch.parallel.topology",
    "deepspeed_tpu_torch.parallel.collectives",
    "deepspeed_tpu_torch.module_inject.auto_tp",
    "deepspeed_tpu_torch.models.convert",
    "deepspeed_tpu_torch.models.transformer",
    "deepspeed_tpu_torch.inference.engine",
    "deepspeed_tpu_torch.inference.serving.engine",
    "deepspeed_tpu_torch.inference.serving.block_allocator",
    "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.runtime.zero.partitioned",
    "deepspeed_tpu_torch.runtime.dataloader",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.engine")


@pytest.mark.parametrize("module", TENSOR_PARALLEL)
def test_tensor_parallel_modules_are_checked(module):
    """The modules of tensor parallelism are among the modules whose
    imports the checks above read, and none builds or loads a library or
    starts ``torch.distributed`` while it is imported."""
    modules = dict(port_modules())
    assert module in modules
    calls = _import_time_calls(ast.parse(modules[module].read_text()))
    assert not (BUILDERS | {"init_distributed", "init_process_group"}) \
        & set(calls), f"{module} builds or starts a world at import"


def test_tensor_parallel_modules_import_alone():
    """Importing them in a fresh interpreter loads no forbidden package
    and leaves ``torch.distributed`` uninitialized."""
    code = (f"import importlib, json, sys\n"
            f"for m in {TENSOR_PARALLEL!r}:\n"
            f"    importlib.import_module(m)\n"
            f"import torch.distributed as dist\n"
            f"print(json.dumps([sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}), dist.is_initialized()]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False]


#: the modules pipeline parallelism runs through
PIPELINE = (
    "deepspeed_tpu_torch.runtime.pipe",
    "deepspeed_tpu_torch.runtime.pipe.engine",
    "deepspeed_tpu_torch.runtime.pipe.module",
    "deepspeed_tpu_torch.runtime.pipe.schedule",
    "deepspeed_tpu_torch.runtime.pipe.topology",
    "deepspeed_tpu_torch.comm.comm", "deepspeed_tpu_torch.parallel.topology",
    "deepspeed_tpu_torch.runtime.config")


@pytest.mark.parametrize("module", PIPELINE)
def test_pipeline_modules_are_checked(module):
    """The pipeline's modules are among the modules whose imports the
    checks above read, and none builds or loads a library or starts
    ``torch.distributed`` while it is imported."""
    modules = dict(port_modules())
    assert module in modules
    calls = _import_time_calls(ast.parse(modules[module].read_text()))
    assert not (BUILDERS | {"init_distributed", "init_process_group"}) \
        & set(calls), f"{module} builds or starts a world at import"


def test_pipeline_modules_import_alone():
    """Importing them in a fresh interpreter loads no forbidden package
    and leaves ``torch.distributed`` uninitialized."""
    code = (f"import importlib, json, sys\n"
            f"for m in {PIPELINE!r}:\n"
            f"    importlib.import_module(m)\n"
            f"import torch.distributed as dist\n"
            f"print(json.dumps([sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}), dist.is_initialized()]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False]


def _worker_source(test_file: str, name: str) -> str:
    """The string a test file assigns to ``name`` (a worker's source),
    read without importing the file (the test files import jax)."""
    tree = ast.parse((REPO / "tests" / test_file).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"{test_file} assigns no {name}")


@pytest.mark.parametrize("test_file,name", [
    ("test_torch_pipe.py", "WORKER"), ("test_torch_tp_training.py",
                                       "WORKER")])
def test_rank_worker_sources_import_nothing_of_jax(test_file, name):
    """The sources the gloo ranks of the parity tests run import neither
    jax nor the JAX package (the pipeline's files share the first)."""
    tree = ast.parse(_worker_source(test_file, name))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert names and not [n for n in names if _forbidden(n)], names
