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
