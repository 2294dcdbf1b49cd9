"""The port's comm layer (``comm/``, ``parallel/topology.py``) at world 4.

Four ranks run on ``gloo`` on the CPU, started once for the module
(``comm/local_ranks.py``: torchrun's environment, a deadline that kills
every rank).  Each rank's inputs come from a seed of its rank, so the
parent recomputes every collective with numpy: ``all_reduce`` (sum,
mean, max, min, product), ``all_gather`` along each dim, tiled and
stacked, ``reduce_scatter`` along each dim, ``all_to_all_single`` with
every split and concat pair, ``broadcast`` from a member, in float32 and
bfloat16; the comms log's op counts and bytes; a ``dcn_data=2 x data=2``
``ProcessMesh`` (its coordinates, its groups, collectives over each axis
and over both jointly); and the bandwidth sweep.  In-process: the JAX
package's ``calc_bw_factor`` and ``resolve_mesh_spec`` against the
port's, the backend refusals, and the launcher's deadline.
"""
import json
import os
import types

import numpy as np
import pytest

from deepspeed_tpu.comm.comms_logging import calc_bw_factor as jax_bw
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.comms_logging import calc_bw_factor
from deepspeed_tpu_torch.comm.local_ranks import RanksFailed, run_ranks
from deepspeed_tpu_torch.parallel import topology as ptopo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SHAPE = (4, 8, 12)

WORKER = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.benchmarks import run_benchmark
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime.config import MeshConfig

dt.init_distributed("gloo", timeout=60)
rank, world = comm.get_rank(), comm.get_world_size()
shape = tuple(json.loads(os.environ["COMM_SHAPE"]))
out = {"rank": rank, "world": world, "backend": comm.get_backend(),
       "local_rank": comm.get_local_rank()}

def x_of(r, dtype):
    a = np.random.RandomState(r).randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)

def rec(key, t):
    out[key] = t.float().tolist()

cl = comm.configure(enabled=True)
for dn, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    x = x_of(rank, dtype)
    for op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
        rec(f"{dn}/all_reduce/{op}",
            comm.all_reduce(x.clone(), getattr(comm.ReduceOp, op)))
    for ax in range(3):
        rec(f"{dn}/all_gather/{ax}", comm.all_gather(x, axis=ax))
        rec(f"{dn}/all_gather_stacked/{ax}",
            comm.all_gather(x, axis=ax, tiled=False))
        rec(f"{dn}/reduce_scatter/{ax}",
            comm.reduce_scatter(x.clone(), scatter_dimension=ax))
    rec(f"{dn}/reduce_scatter/avg",
        comm.reduce_scatter(x.clone(), comm.ReduceOp.AVG))
    for s in range(3):
        for c in range(3):
            rec(f"{dn}/all_to_all/{s}{c}", comm.all_to_all_single(
                x, "data", split_axis=s, concat_axis=c))
    rec(f"{dn}/broadcast", comm.broadcast(x.clone(), src=2))
out["log"] = cl.totals()
cl.reset()
cl.configure(enabled=False)
comm.barrier()

mesh = build_mesh(MeshConfig(dcn_data=2, data=2))
comm.set_mesh(mesh)
out["coords"] = mesh.coords
out["groups"] = {str(k): mesh.axis_ranks(k) for k in
                 ("data", "dcn_data", ("dcn_data", "data"))}
x = x_of(rank, torch.float32)
for name, axes in (("data", "data"), ("dcn", "dcn_data"),
                   ("joint", ("dcn_data", "data"))):
    rec(f"mesh/{name}/all_reduce", comm.all_reduce(x.clone(),
                                                   axis_name=axes))
    rec(f"mesh/{name}/all_gather", comm.all_gather(x, axes, axis=1))
    out[f"mesh/{name}/index"] = comm.axis_index(axes)
comm.set_mesh(None)
rows = run_benchmark("all_reduce", [0.01], trials=2, warmups=1)
out["bench"] = rows
json.dump(out, open(os.path.join(os.environ["COMM_DIR"], f"rank{rank}.json"), "w"))
comm.destroy_process_group()
'''


def inputs(dtype):
    xs = [np.random.RandomState(r).randn(*SHAPE).astype(np.float32)
          for r in range(WORLD)]
    if dtype == "bf16":
        import torch
        xs = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
              for x in xs]
    return xs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("comm"))
    run_ranks(WORKER, WORLD, timeout=120, cwd=REPO, log_dir=tmp,
              env={"COMM_DIR": tmp, "COMM_SHAPE": json.dumps(SHAPE)})
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _close(got, want, dtype, reduced=False):
    """Moved data is exact; a reduction carries the rounding of each of
    its three adds (float32: 1e-6; bfloat16: 8 bits, on partial sums up
    to the four inputs' magnitude)."""
    if not reduced:
        tol = dict(rtol=0, atol=0)
    elif dtype == "f32":
        tol = dict(rtol=1e-6, atol=1e-6)
    else:
        tol = dict(rtol=2 ** -6, atol=2 ** -4)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_reduce_ops(ranks, dtype):
    xs = np.stack(inputs(dtype))
    want = {"SUM": xs.sum(0), "AVG": xs.sum(0) / WORLD, "MAX": xs.max(0),
            "MIN": xs.min(0), "PRODUCT": xs.prod(0)}
    for res in ranks:
        for op, w in want.items():
            _close(res[f"{dtype}/all_reduce/{op}"], w, dtype,
                   reduced=op in ("SUM", "AVG", "PRODUCT"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_gather_and_reduce_scatter_along_each_dim(ranks, dtype):
    xs = inputs(dtype)
    total = np.sum(xs, 0)
    for r, res in enumerate(ranks):
        for ax in range(3):
            _close(res[f"{dtype}/all_gather/{ax}"],
                   np.concatenate(xs, axis=ax), dtype)
            _close(res[f"{dtype}/all_gather_stacked/{ax}"],
                   np.stack(xs, axis=ax), dtype)
            _close(res[f"{dtype}/reduce_scatter/{ax}"],
                   np.split(total, WORLD, axis=ax)[r], dtype, reduced=True)
        _close(res[f"{dtype}/reduce_scatter/avg"],
               np.split(total, WORLD, axis=0)[r] / WORLD, dtype,
               reduced=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_to_all_and_broadcast(ranks, dtype):
    """``all_to_all_single`` as ``lax.all_to_all(tiled=True)``: chunk j
    of the split axis goes to member j, arrivals concatenate along the
    concat axis in the senders' order."""
    xs = inputs(dtype)
    for r, res in enumerate(ranks):
        for s in range(3):
            for c in range(3):
                want = np.concatenate(
                    [np.split(xs[src], WORLD, axis=s)[r]
                     for src in range(WORLD)], axis=c)
                _close(res[f"{dtype}/all_to_all/{s}{c}"], want, dtype)
        _close(res[f"{dtype}/broadcast"], xs[2], dtype)


def test_comms_log_counts_and_bytes(ranks):
    """Every op is logged once a call with the bytes one rank passes it
    (the JAX logger's convention: the input tensor), and timed."""
    n = int(np.prod(SHAPE))
    calls = {"all_reduce": 5, "all_gather": 6, "reduce_scatter": 4,
             "all_to_all": 9, "broadcast": 1}
    for res in ranks:
        log = res["log"]
        assert set(log) == set(calls)
        for op, k in calls.items():
            assert log[op]["count"] == 2 * k, op
            assert log[op]["bytes"] == k * n * (4 + 2), op
            assert log[op]["seconds"] > 0 and log[op]["algbw_GBps"] > 0
        # the bus rate is the algorithmic one times calc_bw_factor
        for op in ("all_reduce", "all_gather", "reduce_scatter"):
            np.testing.assert_allclose(
                log[op]["busbw_GBps"],
                log[op]["algbw_GBps"] * calc_bw_factor(op, WORLD),
                rtol=1e-9)


def test_process_mesh_lays_ranks_out_as_build_mesh(ranks):
    """dcn_data=2 x data=2: rank r sits where device r sits in the JAX
    mesh (row-major over AXIS_ORDER); the data groups are {0,1},{2,3},
    the dcn_data groups {0,2},{1,3}, the joint group all four in their
    joint order."""
    jm = np.arange(WORLD).reshape(2, 1, 2, 1, 1, 1)   # JAX device layout
    xs = inputs("f32")
    for r, res in enumerate(ranks):
        coord = res["coords"]
        assert jm[coord["dcn_data"], 0, coord["data"], 0, 0, 0] == r
        d, c = coord["data"], coord["dcn_data"]
        assert res["groups"]["data"] == [2 * c, 2 * c + 1]
        assert res["groups"]["dcn_data"] == [d, d + 2]
        assert res["groups"][str(("dcn_data", "data"))] == [0, 1, 2, 3]
        data_peers = [xs[p] for p in (2 * c, 2 * c + 1)]
        dcn_peers = [xs[p] for p in (d, d + 2)]
        _close(res["mesh/data/all_reduce"], np.sum(data_peers, 0), "f32",
               reduced=True)
        _close(res["mesh/dcn/all_reduce"], np.sum(dcn_peers, 0), "f32",
               reduced=True)
        _close(res["mesh/joint/all_reduce"], np.sum(xs, 0), "f32",
               reduced=True)
        _close(res["mesh/data/all_gather"],
               np.concatenate(data_peers, axis=1), "f32")
        _close(res["mesh/joint/all_gather"], np.concatenate(xs, axis=1),
               "f32")
        assert (res["mesh/data/index"], res["mesh/dcn/index"],
                res["mesh/joint/index"]) == (d, c, 2 * c + d)


def test_ranks_see_torchruns_contract_and_sweep(ranks):
    for r, res in enumerate(ranks):
        assert (res["rank"], res["world"], res["backend"],
                res["local_rank"]) == (r, WORLD, "gloo", r)
        (row,) = res["bench"]
        assert row["collective"] == "all_reduce" and row["timer"] == "host"
        assert row["latency_ms"] > 0 and row["busbw_GBps"] > 0


# -- in-process ---------------------------------------------------------------
@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter",
                                "all_to_all", "broadcast", "ppermute"])
@pytest.mark.parametrize("n", [0, 1, 2, 8])
def test_bw_factor_equals_jax(op, n):
    assert calc_bw_factor(op, n) == jax_bw(op, n)


@pytest.mark.parametrize("sizes,n", [
    (dict(data=-1), 8), (dict(data=2, dcn_data=-1), 8),
    (dict(data=4, model=2), 8), (dict(data=-1, pipe=3), 8),
    (dict(data=-1, model=-1), 8), (dict(data=3), 4)])
def test_resolve_mesh_spec_equals_jax(sizes, n):
    cfg = types.SimpleNamespace(**{a: sizes.get(a, 1)
                                   for a in jtopo.AXIS_ORDER})
    try:
        want = jtopo.resolve_mesh_spec(cfg, n).sizes
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ptopo.resolve_mesh_spec(cfg, n)
        assert str(got.value) == str(e)
        return
    assert ptopo.resolve_mesh_spec(cfg, n).sizes == want
    assert ptopo.AXIS_ORDER == jtopo.AXIS_ORDER


def test_world_of_one_needs_no_process_group():
    mesh = ptopo.build_mesh()
    assert mesh.shape["data"] == 1 and mesh.coords["data"] == 0
    assert mesh.group("data") is None
    assert (ptopo.dp_world_size(mesh), ptopo.mp_world_size(mesh),
            ptopo.pp_world_size(mesh)) == (1, 1, 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        ptopo.ProcessMesh(ptopo.MeshSpec(data=2), rank=1)


def test_backends_are_checked():
    """An unknown backend raises ValueError as the JAX function does for
    its own list; ``nccl`` with more ranks than visible cards names
    ``gloo`` and never switches."""
    with pytest.raises(ValueError, match="unknown dist_backend 'mpi'"):
        comm.init_distributed("mpi")
    with pytest.raises(ValueError, match="Ranks that share a card run on "
                                         "'gloo'"):
        comm.init_distributed("nccl", init_method="tcp://127.0.0.1:1",
                              rank=0, world_size=2)
    assert not comm.is_initialized()


def test_a_hung_rank_fails_the_world_within_its_deadline(tmp_path):
    """A rank that never arrives at a collective makes the world fail
    at its deadline, every rank stopped."""
    src = ("import os, time\n"
           "if os.environ['RANK'] == '1':\n"
           "    time.sleep(60)\n")
    with pytest.raises(RanksFailed, match=r"ranks \[1\] of 2"):
        run_ranks(src, 2, timeout=3, log_dir=str(tmp_path))


#: the rank programs run as ``python -c`` sources: in these files, every
#: module-level string assigned to a name ending in WORKER or _RANK
RANK_SOURCES = ("tests/test_torch_comm.py", "tests/test_torch_zero.py",
                "tests/test_torch_cuda.py", "chip_smoke.py")


def _rank_sources():
    import ast
    for rel in RANK_SOURCES:
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) and (
                            t.id.endswith("WORKER") or t.id.endswith("_RANK")):
                        yield f"{rel}::{t.id}", node.value.value


def test_rank_sources_import_no_jax():
    """The ranks' programs import torch and the port only: no ``jax``,
    nothing of ``deepspeed_tpu`` (the card's machine has no JAX)."""
    import ast
    found = dict(_rank_sources())
    assert set(found) >= {"tests/test_torch_comm.py::WORKER",
                          "tests/test_torch_zero.py::WORKER",
                          "tests/test_torch_cuda.py::_ZERO_RANK",
                          "tests/test_torch_cuda.py::_COLLECTIVES_RANK",
                          "chip_smoke.py::ZERO_WORKER"}
    for name, src in found.items():
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "deepspeed_tpu"), (name, m)
