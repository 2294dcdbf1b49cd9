"""Pipeline parallelism: the port's ranks against the JAX engines.

The port runs its ranks as child processes on ``gloo`` on the CPU
(``comm/local_ranks.py``), each world started once for the module and
running every case of its size in turn; the worker source imports no
JAX.  The JAX side runs in this process on the conftest's 8-device
virtual CPU mesh while the ranks run.  Cases (f32, tiny models: 4
layers, d 32, 4 heads, seq 16, micro 2, 4 micro batches a step,
clipping at 0.25 so that it bites):

* world 4 at {pipe 2, model 2}, against the JAX ``PipelineEngine`` at
  that mesh: GPT-2 under 1F1B and under gpipe (the JAX 1F1B's numbers:
  the two schedules are one function), a GQA LLaMA with an untied head,
  a GPT-Neo-like model with per-layer windows (each stage its slice of
  the windows), ``eval_loss``, and a checkpoint that resumes bit-equal
  and holds the JAX engine's stage-stacked tree; fp16 at
  ``initial_scale_power`` 0 and 8 takes the same trajectory with no
  skipped step (the JAX ``test_pp_fp16_scale_invariant``);
* world 4: ``ppermute`` and the ring shifts against numpy's, f32 and
  bf16;
* in process: the schedules' instruction lists, ``partition_layers``,
  ``PipelineModule``, the topology and ``PipelineParallelGrid``,
  ``PipelinedLM``'s stack and specs, ``chunked_ce`` and the
  constructor's refusals, each equal to the JAX package's.

Every rank's loss and grad norm are within 1e-5 of the JAX engine's,
and the gathered masters within 1e-5 but for the allowance PR 19's
tests state (at most 1 element in 10^4, each within Adam's bound).
``launch`` and the ``check_*`` functions are the harness of
``test_torch_pipe_zero.py`` ({pipe 4} and {pipe 2, data 2} under ZeRO
0-2), ``test_torch_pipe_moe.py`` (MoE under gpipe) and
``test_torch_pipe_3d.py`` (world 8) too: one file each keeps each one's
time within a minute.
"""
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.parallel import topology as jax_topo
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.pipe import engine as jax_pe
from deepspeed_tpu.runtime.pipe import module as jax_pm
from deepspeed_tpu.runtime.pipe import schedule as jax_sched
from deepspeed_tpu.runtime.pipe import topology as jax_grid
from deepspeed_tpu_torch.comm.local_ranks import run_ranks
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel import topology as port_topo
from deepspeed_tpu_torch.runtime.pipe import engine as pe
from deepspeed_tpu_torch.runtime.pipe import module as pm
from deepspeed_tpu_torch.runtime.pipe import schedule as sched
from deepspeed_tpu_torch.runtime.pipe import topology as grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
             max_seq_len=16, attn_impl="xla", remat="full", loss_chunk=8)
FAMILIES = {
    "gpt2": SMALL,
    "llama": dict(SMALL, num_kv_heads=2, d_ff=48, pos_embedding="rotary",
                  rotary_interleaved=False, norm_type="rmsnorm",
                  activation="silu", gated_mlp=True, tie_embeddings=False,
                  use_bias=False),
    "neo": dict(SMALL, attention_layers=["global", "local"] * 2,
                local_attention_window=4),
    "moe": dict(SMALL, moe_num_experts=4),
}
BASE = {"train_batch_size": 8, "gradient_accumulation_steps": 4,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-3, "weight_decay": 0.1}},
        "gradient_clipping": 0.25, "steps_per_print": 0}
LR = BASE["optimizer"]["params"]["lr"]
STEPS = 3


def zero(stage):
    return {"zero_optimization": {"stage": stage}}


def fp16(power):
    return {"fp16": {"enabled": True, "initial_scale_power": power,
                     "loss_scale_window": 1000}}


TP = {"pipe": 2, "model": 2}
#: name → (world, family, mesh, config, oracle): the oracle is "pipe"
#: (the JAX PipelineEngine at the same mesh), "dp" (the JAX
#: DeepSpeedEngine on the matching data mesh), another case's name (the
#: same numbers), or None (checked against another case below)
CASES = {
    "gpt2": (4, "gpt2", TP, {}, "pipe"),
    "gpt2_gpipe": (4, "gpt2", TP, {"pipeline": {"schedule": "gpipe"}},
                   "gpt2"),
    "llama": (4, "llama", TP, {}, "pipe"),
    "neo": (4, "neo", TP, {}, "pipe"),
    "fp16_0": (4, "gpt2", TP, fp16(0), None),
    "fp16_8": (4, "gpt2", TP, fp16(8), None),
}


def jax_model(family):
    return jax_tf.TransformerLM(jax_tf.gpt2_config(
        "125m", dtype=jnp.float32, **FAMILIES[family]))


def port_model(family):
    return tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, **FAMILIES[family]))


def global_batch(i):
    return np.random.RandomState(100 + i).randint(
        0, 64, (BASE["train_batch_size"], 16)).astype(np.int32)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unstack_flat(tree):
    """A flat stage-stacked tree with its blocks' leaves unstacked."""
    return {k: (v.reshape((-1,) + v.shape[2:]) if k.startswith("blocks/")
                else v) for k, v in tree.items()}


WORKER = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime.config import MeshConfig
from deepspeed_tpu_torch.runtime.dataloader import rank_slice
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves

d = os.environ["PIPE_TEST_DIR"]
dt.init_distributed("gloo", timeout=90)
rank, world = comm.get_rank(), comm.get_world_size()
spec = json.load(open(os.path.join(d, "cases.json")))
batches = np.load(os.path.join(d, "batches.npz"))

def unflat(npz):
    tree = {}
    for k in npz.files:
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[k]
    return tree

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix + "/" + k if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v.detach().cpu().numpy()
    return out

def model(family):
    return tt.TransformerLM(tt.gpt2_config(
        "125m", dtype=torch.float32, **spec["families"][family]))

def engine(family, mesh, config, p=True):
    m = model(family)
    params = params_from_jax(unflat(np.load(os.path.join(
        d, f"init_{family}.npz"))), m) if p else None
    return dt.initialize(model=m, config={**spec["base"], **config,
                                          "mesh": mesh},
                         params=params, device="cpu")[0]

def step(eng, i):
    b = rank_slice({"input_ids": batches[str(i)]},
                   eng.gradient_accumulation_steps, eng.dp_world_size,
                   eng.dp_rank)
    m = eng.train_step(b)
    return [float(m["loss"]), float(m["grad_norm"])]

out, whole = {}, {}
for name, (w, family, mesh, config, _) in spec["cases"].items():
    if w != world:
        continue
    eng = engine(family, mesh, config)
    rows = [step(eng, i) for i in range(spec["steps"])]
    full = eng.full_state()
    whole.update({name + "/" + k: v for k, v in flat(
        eng.adapter.unstack(full["params"])).items()})
    out[name] = {"rows": rows, "bytes": eng.zero_state_bytes(),
                 "planned": eng._zero.planned_bytes(eng._param_shapes, 4),
                 "n_params": eng.num_parameters(), "type": type(eng).__name__,
                 "schedule": eng.schedule, "skipped": eng.skipped_steps,
                 "stage": eng.stage_id, "dp_rank": eng.dp_rank}
    if name == "gpt2":
        out[name]["eval"] = float(eng.eval_loss(rank_slice(
            {"input_ids": batches["eval"]}, eng.gradient_accumulation_steps,
            eng.dp_world_size, eng.dp_rank)))
        # a checkpoint at {pipe 2, model 2}: a fresh engine resumes it
        ck = os.path.join(d, "ckpt")
        eng.save_checkpoint(ck)
        fresh = engine(family, mesh, config, p=False)
        fresh.load_checkpoint(ck)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(eng.state), tree_leaves(fresh.state)))
        out[name]["resume"] = {"leaves_equal": same,
                               "next": [step(eng, spec["steps"]),
                                        step(fresh, spec["steps"])]}
    del eng

if world == 4 and spec["ring"]:
    # the loader at {pipe 2, data 2}: the rows of the data coordinate
    data = [{"input_ids": np.full((16,), i, np.int32)} for i in range(32)]
    _, _, loader, _ = dt.initialize(
        model=model("gpt2"), config={**spec["base"],
                                     "mesh": {"pipe": 2, "data": 2}},
        training_data=data, device="cpu")
    out["loader"] = next(iter(loader))["input_ids"][:, 0].tolist()
    # the ring shifts and a permutation against numpy's
    comm.set_mesh(build_mesh(MeshConfig(pipe=4)))
    perm = [(0, 2), (2, 0), (1, 3)]
    got = {}
    for dtype in ("float32", "bfloat16"):
        x = torch.from_numpy(np.random.RandomState(rank).randn(3, 5).astype(
            np.float32)).to(getattr(torch, dtype))
        got[dtype] = [comm.send_recv_next(x).float().tolist(),
                      comm.send_recv_prev(x).float().tolist(),
                      comm.ppermute(x, perm).float().tolist()]
    out["ring"] = got
out["jax_loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "deepspeed_tpu"))
json.dump(out, open(os.path.join(d, f"w{world}_rank{rank}.json"), "w"))
if rank == 0:
    np.savez(os.path.join(d, f"whole{world}.npz"), **whole)
comm.destroy_process_group()
'''


def jax_engine(family, mesh, config):
    n = int(np.prod(list(mesh.values())))
    jm = build_mesh(MeshConfig(**mesh), devices=jax.devices()[:n])
    cfg = json.loads(json.dumps({**BASE, **config, "mesh": mesh}))
    return ds.initialize(model=jax_model(family), config=cfg, mesh=jm,
                         rng=jax.random.PRNGKey(0))[0]


def oracle_mesh(mesh, oracle):
    """The JAX engine's mesh: the same one, or its data axis alone."""
    return mesh if oracle == "pipe" else {"data": mesh.get("data", 1)}


def launch(tmp, cases, ring=False):
    """Run ``cases``: each world's ranks (``WORKER``, started once a world,
    in threads) while the JAX oracles run here; returns the results.
    ``ring``: world 4 also runs the ring shifts."""
    families = sorted({c[1] for c in cases.values()})
    inits = {}
    for family in families:
        inits[family] = jax.device_get(jax_model(family).init(
            jax.random.PRNGKey(0)))
        np.savez(os.path.join(tmp, f"init_{family}.npz"),
                 **flat(inits[family]))
    batches = {str(i): global_batch(i) for i in range(STEPS + 1)}
    batches["eval"] = global_batch(50)
    np.savez(os.path.join(tmp, "batches.npz"), **batches)
    with open(os.path.join(tmp, "cases.json"), "w") as fh:
        json.dump({"cases": cases, "families": FAMILIES, "base": BASE,
                   "steps": STEPS, "ring": ring}, fh)
    worlds = sorted({c[0] for c in cases.values()})
    box = {}

    def ranks(n):
        os.makedirs(os.path.join(tmp, f"logs{n}"))
        try:
            run_ranks(WORKER, n, timeout=240, env={"PIPE_TEST_DIR": tmp},
                      cwd=REPO, log_dir=os.path.join(tmp, f"logs{n}"))
        except Exception as e:   # noqa: BLE001 - raised in the test below
            box[n] = e
    threads = [threading.Thread(target=ranks, args=(n,)) for n in worlds]
    for t in threads:
        t.start()
    runs, states, extra = {}, {}, {}
    for name, (_, family, mesh, config, oracle) in cases.items():
        if oracle not in ("pipe", "dp"):
            continue
        je = jax_engine(family, oracle_mesh(mesh, oracle), config)
        runs[name] = [{k: float(v) for k, v in je.train_step(
            {"input_ids": batches[str(i)]}).items()} for i in range(STEPS)]
        st = flat(jax.device_get(je.state["params"]))
        states[name] = unstack_flat(st) if oracle == "pipe" else st
        extra[name] = {"schedule": getattr(je, "schedule", None)}
        if name == "gpt2":
            extra[name]["eval"] = float(je.eval_loss(
                {"input_ids": batches["eval"]}))
            extra[name]["stacked"] = jax.device_get(je.state["params"])
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "the ranks outlived their deadline"
    for n, e in box.items():
        raise e
    ranks_out = {n: [json.load(open(os.path.join(tmp, f"w{n}_rank{r}.json")))
                     for r in range(n)] for n in worlds}
    whole = {n: dict(np.load(os.path.join(tmp, f"whole{n}.npz")))
             for n in worlds}
    return types.SimpleNamespace(runs=runs, states=states, ranks=ranks_out,
                                 whole=whole, inits=inits, jax=extra,
                                 cases=cases, tmp=tmp)


def source(cases, name):
    """The case whose JAX run holds ``name``'s numbers."""
    o = cases[name][4]
    return name if o in ("pipe", "dp") else source(cases, o)


def check_steps(world, name, overcount=1):
    """Every rank's loss and grad norm against the JAX engine's, each
    step (the norm over ``overcount``, the JAX MoE region's factor);
    ``initialize`` built a PipelineEngine under the schedule the config
    (or ``auto``) names."""
    w, family, _, config, _ = world.cases[name]
    want = world.runs[source(world.cases, name)]
    for res in world.ranks[w]:
        got = res[name]
        assert got["type"] == "PipelineEngine"
        want_sched = config.get("pipeline", {}).get("schedule") or (
            "gpipe" if family == "moe" else "1f1b")
        assert got["schedule"] == want_sched
        assert len(got["rows"]) == len(want)
        for (loss, gnorm), w_ in zip(got["rows"], want):
            np.testing.assert_allclose(loss, w_["loss"], rtol=1e-5, atol=0)
            np.testing.assert_allclose(gnorm, w_["grad_norm"] / overcount,
                                       rtol=1e-5, atol=0)
    assert max(w_["grad_norm"] for w_ in want) / overcount > \
        BASE["gradient_clipping"]                        # clipping bites


def check_masters(world, name):
    """The masters gathered from every stage, model slice and data shard
    equal the JAX engine's state within 1e-5, but for at most 1 in 10^4
    elements, each within Adam's bound on one element's move over the
    run (2 x lr x steps): the stages' sums run in another order than
    XLA's, and Adam divides each element's gradient by its own scale."""
    w = world.cases[name][0]
    got = {k.split("/", 1)[1]: v for k, v in world.whole[w].items()
           if k.startswith(name + "/")}
    want = world.states[source(world.cases, name)]
    assert set(got) == set(want)
    bound = 2 * LR * STEPS
    for k, v in want.items():
        off = ~np.isclose(got[k], v, **TOL)
        assert off.sum() <= max(1, v.size // 10**4), (k, int(off.sum()))
        np.testing.assert_allclose(got[k], v, rtol=0, atol=bound,
                                   err_msg=k)


def check_bytes(world, name):
    """Each rank's bytes by kind, counted from its tensors, are the
    plan's count over its stage's slice (blocks / S beside the
    replicated leaves, over its model slice and data shard); the
    parameter count is the whole model's."""
    w, family = world.cases[name][0], world.cases[name][1]
    for res in world.ranks[w]:
        assert res[name]["bytes"] == res[name]["planned"]
        assert res[name]["n_params"] == sum(
            v.size for v in flat(world.inits[family]).values())


def check_no_jax(world):
    for ranks in world.ranks.values():
        for res in ranks:
            assert res["jax_loaded"] == []


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(str(tmp_path_factory.mktemp("pipe")), CASES, ring=True)


def test_workers_import_no_jax(world):
    check_no_jax(world)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[4] is not None])
def test_steps_match_jax_on_every_rank(world, name):
    check_steps(world, name)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[4] is not None])
def test_gathered_masters_equal_jax(world, name):
    check_masters(world, name)


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_follow_the_plan(world, name):
    check_bytes(world, name)


def test_schedules_agree_and_fp16_is_scale_invariant(world):
    """gpipe and 1F1B are one function (losses within 1e-5 of each
    other); fp16 at loss scale 1 and 256 takes the same trajectory with
    no skipped step (a missing scale multiply would show as a 256x
    smaller update by step 2)."""
    for res in world.ranks[4]:
        np.testing.assert_allclose(res["gpt2_gpipe"]["rows"],
                                   res["gpt2"]["rows"], rtol=1e-5)
        a, b = res["fp16_0"], res["fp16_8"]
        assert a["skipped"] == b["skipped"] == 0
        np.testing.assert_allclose([r[0] for r in a["rows"]],
                                   [r[0] for r in b["rows"]], rtol=5e-3)
        assert a["rows"] == world.ranks[4][0]["fp16_0"]["rows"]


def test_eval_loss_matches_jax(world):
    """``eval_loss`` through the fill-drain ``InferenceSchedule`` equals
    the JAX PipelineEngine's at {pipe 2, model 2}, on every rank."""
    for res in world.ranks[4]:
        np.testing.assert_allclose(res["gpt2"]["eval"],
                                   world.jax["gpt2"]["eval"], rtol=1e-5)


def test_checkpoint_resumes_bit_equal(world):
    """Saved at {pipe 2, model 2} and loaded into a fresh engine at that
    mesh: every param and optimizer leaf of every rank bit-equal, and
    the next step's loss and grad norm identical."""
    for res in world.ranks[4]:
        r = res["gpt2"]["resume"]
        assert r["leaves_equal"]
        assert r["next"][0] == r["next"][1]


def test_checkpoint_holds_the_jax_stage_stacked_tree(world):
    """The file holds the stage-stacked tree the JAX engine keeps at
    that mesh: ``params_from_jax`` maps the JAX state onto it (same
    paths and shapes, blocks ``[2, 2, ...]``), values within 1e-5 (the
    allowance above)."""
    adapter = pe.PipelinedLM(port_model("gpt2"), 2)
    want = params_from_jax(world.jax["gpt2"]["stacked"], adapter)
    got = torch.load(os.path.join(world.tmp, "ckpt", f"global_step{STEPS}",
                                  "state.pt"), weights_only=True)["params"]
    assert tuple(got["blocks"]["attn"]["qkv"]["kernel"].shape)[:2] == (2, 2)
    fw, fg = flat(want), flat(got)
    assert set(fw) == set(fg)
    for k in fw:
        off = ~np.isclose(fg[k], fw[k], **TOL)
        assert off.sum() <= max(1, fw[k].size // 10**4), k
        np.testing.assert_allclose(fg[k], fw[k], rtol=0,
                                   atol=2 * LR * STEPS, err_msg=k)


def test_loader_cuts_by_the_data_coordinate(world):
    """At {pipe 2, data 2} ranks (p, d) take data coordinate d's rows
    whatever their stage: the first stage embeds them, the last reads
    them as labels (a cut by the global rank would give every rank other
    rows)."""
    got = [res["loader"] for res in world.ranks[4]]
    assert got[0] == got[2] and got[1] == got[3] and got[0] != got[1]
    assert sorted(got[0] + got[1]) == sorted(set(got[0] + got[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_shifts_match_numpy(world, dtype):
    xs = [np.random.RandomState(r).randn(3, 5).astype(np.float32)
          for r in range(4)]
    if dtype == "bfloat16":
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    for r, res in enumerate(world.ranks[4]):
        nxt, prv, per = (np.asarray(a) for a in res["ring"][dtype])
        np.testing.assert_array_equal(nxt, xs[(r - 1) % 4])
        np.testing.assert_array_equal(prv, xs[(r + 1) % 4])
        src = {0: 2, 2: 0, 3: 1}.get(r)
        np.testing.assert_array_equal(
            per, xs[src] if src is not None else np.zeros((3, 5)))


# -- in process ---------------------------------------------------------------
def _lists(steps):
    return [[repr(c) for c in step] for step in steps]


@pytest.mark.parametrize("m,s", [(4, 2), (6, 4), (8, 3), (3, 3), (1, 2)])
def test_schedules_equal_jax(m, s):
    for sid in range(s):
        for name in ("TrainSchedule", "InferenceSchedule"):
            a = getattr(sched, name)(m, s, sid)
            b = getattr(jax_sched, name)(m, s, sid)
            assert _lists(a.steps()) == _lists(b.steps())
            assert a.num_pipe_buffers == b.num_pipe_buffers
    assert sched.ForwardPass(1) == sched.ForwardPass(1) != \
        sched.BackwardPass(1)


def test_gpipe_steps_run_each_micro_batch_once():
    """The gpipe lists: every forward in order, every backward in reverse,
    the sends and receives of a stage's neighbours, then the step."""
    for s in (2, 3):
        for sid in range(s):
            steps = list(pe.gpipe_steps(4, s, sid))
            kinds = [type(c).__name__ for st in steps for c in st]
            assert kinds.count("ForwardPass") == 4
            assert [c.buffer_id for st in steps for c in st
                    if isinstance(c, sched.BackwardPass)] == [3, 2, 1, 0]
            assert ("RecvActivation" in kinds) == (sid > 0)
            assert ("SendGrad" in kinds) == (sid > 0)
            assert ("SendActivation" in kinds) == (sid < s - 1)
            assert kinds[-1] == "OptimizerStep"


def _specs(kind):
    sizes = [4, 4, 1, 1, 1, 1, 3, 2]
    names = ["Embed", "Block", "Block", "Norm", "Block", "Block", "Head",
             "Block"]
    port = [pm.LayerSpec(lambda g, n=n: {"w": torch.zeros(n)},
                         lambda p, x: x, typename=t)
            for n, t in zip(sizes, names)]
    jx = [jax_pm.LayerSpec(lambda r, n=n: {"w": jnp.zeros((n,))},
                           lambda p, x: x, typename=t)
          for n, t in zip(sizes, names)]
    return port, jx


@pytest.mark.parametrize("method,stages", [
    ("uniform", 4), ("uniform", 3), ("parameters", 2), ("parameters", 3),
    ("type:block", 2), ("type:^(embed|head)$", 2)])
def test_partition_layers_equal_jax(method, stages):
    port, jx = _specs(method)
    assert pm.partition_layers(port, stages, method) == \
        jax_pm.partition_layers(jx, stages, method)
    assert [s.param_count() for s in port] == \
        [s.param_count() for s in jx]
    with pytest.raises(ValueError, match="Unknown partition method"):
        pm.partition_layers(port, stages, "bogus")


def test_pipeline_module_equal_jax():
    port, jx = _specs("parameters")
    port[0] = pm.TiedLayerSpec("emb", lambda g: {"w": torch.zeros(4)},
                               lambda p, x: x)
    jx[0] = jax_pm.TiedLayerSpec("emb", lambda r: {"w": jnp.zeros((4,))},
                                 lambda p, x: x)
    port[6] = pm.TiedLayerSpec("emb", lambda g: {"w": torch.zeros(4)},
                               lambda p, x: x)
    jx[6] = jax_pm.TiedLayerSpec("emb", lambda r: {"w": jnp.zeros((4,))},
                                 lambda p, x: x)
    a = pm.PipelineModule(port, 2)
    b = jax_pm.PipelineModule(jx, 2)
    assert a.boundaries == b.boundaries and a.tied_keys == b.tied_keys
    ta = a.init(torch.Generator())
    tb = b.init(jax.random.PRNGKey(0))
    assert list(ta["tied"]) == list(tb["tied"])
    assert [[sorted(p) for p in s] for s in ta["stages"]] == \
        [[sorted(p) for p in s] for s in tb["stages"]]
    assert [len(a.stage_layers(i)) for i in range(2)] == \
        [len(b.stage_layers(i)) for i in range(2)]


@pytest.mark.parametrize("pp,dp,mp", [(2, 2, 2), (4, 1, 2), (2, 4, 1),
                                      (8, 1, 1)])
def test_grid_and_topology_equal_jax(pp, dp, mp):
    jmesh = build_mesh(MeshConfig(pipe=pp, data=dp, model=mp),
                       devices=jax.devices()[:8])
    fake = types.SimpleNamespace(shape=dict(jmesh.shape))
    assert grid.grid_sizes_from_mesh(fake) == \
        jax_grid.grid_sizes_from_mesh(jmesh)
    a = grid.PipelineParallelGrid(mesh=fake)
    b = jax_grid.PipelineParallelGrid(mesh=jmesh)
    assert str(a) == str(b) and a.world_size == b.world_size
    for r in range(8):
        for f in ("get_stage_id", "get_data_parallel_id",
                  "get_model_parallel_id", "is_first_stage",
                  "is_last_stage"):
            assert getattr(a, f)(r) == getattr(b, f)(r), (f, r)
    for f in ("pipe_groups", "data_groups", "model_groups"):
        assert getattr(a, f)() == getattr(b, f)()
    for s in range(pp):
        assert a.stage_to_ranks(s) == b.stage_to_ranks(s)
        assert a.stage_neighbors(s) == b.stage_neighbors(s)
    for shift in (1, -1):
        assert a.ppermute_ring(shift) == b.ppermute_ring(shift)
    ta = port_topo.PipeModelDataParallelTopology(pp, dp, mp)
    tb = jax_topo.PipeModelDataParallelTopology(pp, dp, mp)
    assert str(ta) == str(tb)
    for r in range(8):
        assert ta.get_coord(r) == tb.get_coord(r)
        assert ta.get_rank(**ta.get_coord(r)) == r
    for axis in ("pipe", "data", "model"):
        assert ta.get_axis_comm_lists(axis) == tb.get_axis_comm_lists(axis)
        assert ta.get_axis_list(axis, 0) == tb.get_axis_list(axis, 0)
    assert ta.filter_match(pipe=0) == tb.filter_match(pipe=0)
    with pytest.raises(ValueError):
        ta.get_rank(stage=0)


def _tuples(tree):
    return jax.tree_util.tree_map(
        lambda s: tuple(s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("family,onehot", [("gpt2", False), ("gpt2", True),
                                           ("llama", True)])
def test_pipelined_lm_stack_and_specs_equal_jax(family, onehot):
    init = jax.device_get(jax_model(family).init(jax.random.PRNGKey(0)))
    ja = jax_pe.PipelinedLM(jax_model(family), 2)
    pa = pe.PipelinedLM(port_model(family), 2)
    ja.use_onehot_embed = pa.use_onehot_embed = onehot
    want = flat(jax.device_get(ja._stack(init)))
    got = flat(pa.stack(params_from_jax(init, port_model(family))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = flat(pa.unstack(pa.stack(params_from_jax(
        init, port_model(family)))))
    for k, v in flat(init).items():
        np.testing.assert_array_equal(back[k], v)
    assert flat(pa.param_shapes()).keys() == want.keys()
    for k, v in flat(pa.param_shapes()).items():
        assert tuple(v) == want[k].shape
    jspecs = _tuples(ja.partition_specs())
    pspecs = pa.partition_specs()

    def leaves(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(leaves(v, pre + "/" + k))
            else:
                out[pre + "/" + k] = tuple(v)
        return out
    assert leaves(pspecs) == leaves(jspecs)


def test_pipelined_lm_refuses_indivisible_layers():
    with pytest.raises(ValueError) as got:
        pe.PipelinedLM(tt.TransformerLM(tt.gpt2_config(
            "125m", **dict(SMALL, num_layers=3))), 2)
    with pytest.raises(ValueError) as want:
        jax_pe.PipelinedLM(jax_tf.TransformerLM(jax_tf.gpt2_config(
            "125m", **dict(SMALL, num_layers=3))), 2)
    assert str(got.value) == str(want.value)


def test_chunked_ce_equals_jax():
    """The head loss (the final norm, then the chunked next-token
    cross-entropy) and its (sum, count) against the JAX function."""
    from deepspeed_tpu.models import layers as JL
    rs = np.random.RandomState(4)
    y = rs.randn(2, 16, 8).astype(np.float32)
    w = rs.randn(8, 24).astype(np.float32)
    ln = {"scale": rs.rand(8).astype(np.float32) + 0.5,
          "bias": rs.randn(8).astype(np.float32)}
    tok = rs.randint(0, 24, (2, 16)).astype(np.int32)
    for chunk in (4, 16):
        jt, jc = jax_pe.chunked_ce(
            lambda x: jnp.einsum("...d,dv->...v", x, jnp.asarray(w)),
            lambda p, x: JL.layernorm_apply(p, x, eps=1e-5),
            jax.tree_util.tree_map(jnp.asarray, ln), jnp.asarray(y),
            jnp.asarray(tok), chunk, False)
        from deepspeed_tpu_torch.models import layers as PL
        tw = torch.from_numpy(w)
        pt, pc = pe.chunked_ce(
            lambda x: x @ tw, lambda p, x: PL.layernorm_apply(p, x, eps=1e-5),
            {k: torch.from_numpy(v) for k, v in ln.items()},
            torch.from_numpy(y), torch.from_numpy(tok).long(), chunk)
        np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)
        assert float(pc) == float(jc) == 30.0


def _mesh(**axes):
    """A mesh's sizes alone: the constructor's checks read nothing
    else before they pass."""
    return types.SimpleNamespace(shape={a: axes.get(a, 1)
                                        for a in port_topo.AXIS_ORDER})


REFUSALS = {
    "pipe1": ("gpt2", {}, {"data": 8}),
    "schedule_moe_1f1b": ("moe", {"pipeline": {"schedule": "1f1b"}},
                          {"pipe": 2, "data": 4}),
    "rsample": ("moe_rsample", {}, {"pipe": 2, "data": 4}),
    "stages": ("gpt2", {"pipeline": {"stages": 4}}, {"pipe": 2, "data": 4}),
    "micro_batches": ("gpt2", {"pipeline": {"micro_batches": 2}},
                      {"pipe": 2, "data": 4}),
    "vocab": ("gpt2_vocab66", {}, {"pipe": 2, "model": 4}),
}


def _family_kw(family):
    if family == "moe_rsample":
        return dict(FAMILIES["moe"], moe_noisy_gate_policy="RSample")
    if family == "gpt2_vocab66":
        return dict(SMALL, vocab_size=66)
    return FAMILIES[family]


@pytest.mark.parametrize("case", list(REFUSALS))
def test_constructor_refusals_word_for_word(case):
    family, config, mesh = REFUSALS[case]
    kw = _family_kw(family)
    cfg = {**BASE, **config, "mesh": mesh}
    jm = build_mesh(MeshConfig(**mesh), devices=jax.devices()[:8])
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jax_pe.PipelineEngine(
            model=jax_tf.TransformerLM(jax_tf.gpt2_config(
                "125m", dtype=jnp.float32, **kw)),
            config=json.loads(json.dumps(cfg)), mesh=jm)
    with pytest.raises(type(want.value)) as got:
        pe.PipelineEngine(
            model=tt.TransformerLM(tt.gpt2_config(
                "125m", dtype=torch.float32, **kw)),
            config=json.loads(json.dumps(cfg)), mesh=_mesh(**mesh),
            device="cpu")
    assert str(got.value) == str(want.value)


def test_pipe_mesh_with_zero_3_stays_refused():
    """ZeRO stage 3 with a pipe axis is the 3D composition's (queue A item
    7's third part), before any rank is needed."""
    with pytest.raises(NotImplementedError, match="3D composition"):
        pe.PipelineEngine(model=port_model("gpt2"), config={
            **BASE, "mesh": {"pipe": 2, "data": 4}, **zero(3)},
            mesh=_mesh(pipe=2, data=4), device="cpu")
