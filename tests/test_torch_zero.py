"""ZeRO stages 0-3 over data parallelism: the port's ranks against the
JAX engine on a 4-device ``data`` mesh.

The port runs four ranks, child processes on ``gloo`` on the CPU
(``comm/local_ranks.py``: torchrun's environment, one deadline that
kills every rank, ``init_process_group`` with a timeout), started once
for the module: one worker runs every case in turn.  The worker source
below imports no JAX.  The JAX side is ``deepspeed_tpu.initialize`` on
``build_mesh(MeshConfig(data=4), devices=jax.devices()[:4])`` of the
conftest's virtual CPU mesh, from the same initial params (written to
``.npz`` by the parent, read by every rank through
``models/convert.py::params_from_jax``) and the same global batches,
each rank taking its ``rank_slice``.  The JAX trajectories are computed
once, in the parent, while the ranks run.

Cases, all float32 but the fp16 one (gas 2, micro 2 a rank, global batch
16, 3 steps, clipping at 0.25 so that it bites):

* tiny GPT-2 (2 layers, d 64) at stages 0-3: each step's loss and grad
  norm within 1e-5 of the JAX engine at the same stage, on every rank,
  and at the end rank r's master and moment shards equal the JAX state's
  shard on device r (its ``addressable_shards``) within 1e-5;
* stage 3 with a ``param_persistence_threshold`` that keeps the small
  leaves resident; a tiny LLaMA (GQA, untied head) and a tiny MoE at
  stage 3 (the MoE without aux loss, routing noise or dropped tokens:
  the JAX layer gates the global batch, the port, as the reference,
  each rank's tokens, and only then do the two route alike);
* fp16 with a scale that overflows at first (2^24, four times and more
  above where this model's gradients overflow float16): the same
  skipped steps and scale trajectory on every rank as in JAX, and the
  masters kept.  Near that boundary the two may part: the port, as the
  reference, reduces each rank's float16 gradients in float32;
* a checkpoint saved at world 4 stage 3 that resumes bit-equal at
  world 4 and loads at world 1, and a world-1 checkpoint that loads at
  world 4;
* in-process: ``ZeroShardingPolicy``'s dims against the JAX policy's
  specs, ``grad_reduce_plan``, ``TiledLinear``, the dataloader's rank
  slices and the config gate's refusals, word for word.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.zero import sharding as jsh
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu_torch.comm.local_ranks import run_ranks
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    rank_slice)
from deepspeed_tpu_torch.runtime.zero import sharding as psh
from deepspeed_tpu_torch.runtime.zero import tiling as ptiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
GPT2 = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=256,
            max_seq_len=64, attn_impl="xla", remat="full", loss_chunk=16)
LLAMA = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=96, vocab_size=64, max_seq_len=64,
             pos_embedding="rotary", rotary_interleaved=False,
             norm_type="rmsnorm", activation="silu", gated_mlp=True,
             tie_embeddings=False, use_bias=False, attn_impl="xla",
             remat="full", loss_chunk=16)
MOE = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
           max_seq_len=64, moe_num_experts=4, moe_freq=2,
           moe_capacity_factor=4.0, moe_min_capacity=1, moe_use_rts=False,
           moe_aux_loss_coef=0.0, attn_impl="xla", remat="full",
           loss_chunk=16)
FAMILIES = {"gpt2": GPT2, "llama": LLAMA, "moe": MOE}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 6e-4, "weight_decay": 0.1}},
        "gradient_clipping": 0.25, "steps_per_print": 0}
STEPS = 3
GLOBAL = 2 * 2 * WORLD
#: one rank over the same global batch: micro 8 = 4 ranks x 2
W1 = {**BASE, "train_micro_batch_size_per_gpu": 2 * WORLD}


def zero(stage, threshold=0):
    return {"zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": threshold}}


#: name → (family, config, batch seed); every case runs STEPS steps
CASES = {
    "s0": ("gpt2", {**BASE, **zero(0)}, 1),
    "s1": ("gpt2", {**BASE, **zero(1)}, 1),
    "s2": ("gpt2", {**BASE, **zero(2)}, 1),
    "s3": ("gpt2", {**BASE, **zero(3)}, 1),
    "s3_persist": ("gpt2", {**BASE, **zero(3, threshold=5000)}, 2),
    "llama": ("llama", {**BASE, **zero(3)}, 3),
    "moe": ("moe", {**BASE, **zero(3)}, 4),
    "fp16": ("gpt2", {**BASE, **zero(2),
                      "fp16": {"enabled": True, "initial_scale_power": 24,
                               "hysteresis": 1}}, 5),
}


#: stages 1 and 2 are held to the JAX engine at stage 3: at threshold 0
#: its master and moment specs are theirs (test_policy_dims_equal_jax_
#: specs), and every JAX stage computes the same function
JAX_REF = {name: "s3" if name in ("s1", "s2") else name for name in CASES}


def jax_model(family, fp16=False):
    dtype = jnp.float16 if fp16 else jnp.float32
    if family == "gpt2":
        return jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=dtype,
                                                       **GPT2))
    kw = FAMILIES[family]
    cfg = (jax_tf.gpt2_config("125m", dtype=dtype, **kw) if family == "moe"
           else jax_tf.TransformerConfig(dtype=dtype, **kw))
    return jax_tf.TransformerLM(cfg)


def port_model(family):
    kw = FAMILIES[family]
    cfg = (tt.TransformerConfig(dtype=torch.float32, **kw)
           if family == "llama"
           else tt.gpt2_config("125m", dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)


def global_batches(family, seed, n):
    rs = np.random.RandomState(seed)
    v = FAMILIES[family]["vocab_size"]
    return [rs.randint(0, v, (GLOBAL, 64)).astype(np.int32)
            for _ in range(n)]


def flat(tree, prefix="", conv=np.asarray):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key, conv))
        else:
            out[key] = conv(v)
    return out


def flat_specs(tree):
    """Path → spec as a tuple of entries (names, tuples of names, None)
    of a JAX ``PartitionSpec`` tree or the port's tuple specs."""
    return flat(tree, conv=lambda s: tuple(
        tuple(e) if isinstance(e, (list, tuple)) else e for e in s))


def unflat(d):
    tree = {}
    for k, v in d.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


#: the ranks' program: every case in turn, then a world-4 checkpoint
#: resumed at world 4 and a world-1 checkpoint loaded at world 4
WORKER = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.dataloader import rank_slice

d = os.environ["ZERO_TEST_DIR"]
dt.init_distributed("gloo", timeout=90)
rank = dt.comm.get_rank()
spec = json.load(open(os.path.join(d, "cases.json")))

def unflat(npz):
    tree = {}
    for k in npz.files:
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[k]
    return tree

def flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + "/" + k, out)
        else:
            out[prefix + "/" + k] = v.detach().cpu().numpy()

def model(family):
    kw = dict(spec["families"][family])
    cfg = (tt.TransformerConfig(dtype=torch.float32, **kw) if family == "llama"
           else tt.gpt2_config("125m", dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)

def engine(name, params=None):
    family, config, _ = spec["cases"][name]
    m = model(family)
    p = None
    if params is not None:
        p = params_from_jax(unflat(np.load(os.path.join(d, params))), m)
    eng, _, _, _ = dt.initialize(model=m, config=config, params=p,
                                 device="cpu")
    return eng

def steps(eng, name, which):
    out = []
    batches = np.load(os.path.join(d, f"batches_{name}.npz"))
    for i in which:
        b = rank_slice({"input_ids": batches[str(i)]},
                       eng.gradient_accumulation_steps, eng.dp_world_size,
                       rank)
        m = eng.train_step(b)
        out.append({k: float(v) for k, v in m.items()})
    return out

results, shards = {}, {}
for name in spec["cases"]:
    eng = engine(name, f"init_{name}.npz")
    results[name] = {"steps": steps(eng, name, range(spec["steps"])),
                     "bytes": eng.zero_state_bytes(),
                     "planned": eng._zero.planned_bytes(
                         eng._param_shapes,
                         torch.finfo(eng.compute_dtype).bits // 8),
                     "counters": [int(eng.state["step"]),
                                  int(eng.state["skipped"])]}
    flat(eng.state["params"], name + "/params", shards)
    for k in ("m", "v"):
        flat(eng.state["opt"][k], f"{name}/{k}", shards)
    if name == "s3":
        eng.save_checkpoint(os.path.join(d, "ckpt4"))
        more = steps(eng, name, [spec["steps"]])
        again = engine(name)
        again.load_checkpoint(os.path.join(d, "ckpt4"))
        results["resume"] = {"cont": more,
                             "resumed": steps(again, name, [spec["steps"]])}
    del eng

w1 = engine("s3")
w1.load_checkpoint(os.path.join(d, "ckpt1"))
results["w1_load"] = steps(w1, "w1", range(2))
results["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "deepspeed_tpu"))
json.dump(results, open(os.path.join(d, f"rank{rank}.json"), "w"))
np.savez(os.path.join(d, f"rank{rank}.npz"), **shards)
dt.comm.destroy_process_group()
'''


def jax_engine(family, config, fp16=False):
    mesh = build_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    eng, _, _, _ = ds.initialize(model=jax_model(family, fp16),
                                 config=json.loads(json.dumps(config)),
                                 mesh=mesh)
    return eng


def device_shard(arr, r):
    dev = jax.devices()[r]
    return np.asarray([s for s in arr.addressable_shards
                       if s.device == dev][0].data)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the ranks, run the JAX engines meanwhile, then gather the
    ranks' results: ``(jax, ranks, tmp)``."""
    tmp = str(tmp_path_factory.mktemp("zero"))
    engines = {name: jax_engine(family, config, fp16="fp16" in config)
               for name, (family, config, _) in CASES.items()
               if JAX_REF[name] == name}
    for name, (family, config, seed) in CASES.items():
        np.savez(os.path.join(tmp, f"init_{name}.npz"), **flat(
            jax.device_get(engines[JAX_REF[name]].state["params"])))
        bs = global_batches(family, seed, STEPS + 1)
        np.savez(os.path.join(tmp, f"batches_{name}.npz"),
                 **{str(i): b for i, b in enumerate(bs)})
    # a world-1 checkpoint of the port (stage 0, one step) for the ranks
    # to load at stage 3
    w1 = dt.initialize(model=port_model("gpt2"),
                       config=json.loads(json.dumps(W1)),
                       params=params_from_jax(
                           jax.device_get(engines["s0"].state["params"]),
                           port_model("gpt2")), device="cpu")[0]
    w1_batches = global_batches("gpt2", 6, 3)
    w1.train_step({"input_ids": w1_batches[0]})
    w1.save_checkpoint(os.path.join(tmp, "ckpt1"))
    np.savez(os.path.join(tmp, "batches_w1.npz"),
             **{str(i): b for i, b in enumerate(w1_batches[1:])})
    w1_ref = [{k: float(v) for k, v in w1.train_step(
        {"input_ids": b}).items()} for b in w1_batches[1:]]
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": CASES, "families": FAMILIES, "steps": STEPS}, f)

    import threading
    box = {}

    def ranks():
        try:
            box["outs"] = run_ranks(WORKER, WORLD, timeout=240,
                                    env={"ZERO_TEST_DIR": tmp}, cwd=REPO,
                                    log_dir=tmp)
        except Exception as e:   # noqa: BLE001 - raised in the test below
            box["error"] = e
    t = threading.Thread(target=ranks)
    t.start()
    jax_runs = {}
    for name, je in engines.items():
        bs = np.load(os.path.join(tmp, f"batches_{name}.npz"))
        jax_runs[name] = [{k: float(v) for k, v in je.train_step(
            {"input_ids": bs[str(i)]}).items()} for i in range(STEPS)]
    t.join(timeout=300)
    assert not t.is_alive(), "the ranks outlived their deadline"
    if "error" in box:
        raise box["error"]
    for name, ref in JAX_REF.items():
        jax_runs[name] = jax_runs[ref]
        engines[name] = engines[ref]
    ranks_out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res = json.load(f)
        res["shards"] = dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
        ranks_out.append(res)
    return types.SimpleNamespace(engines=engines, runs=jax_runs,
                                 ranks=ranks_out, tmp=tmp, w1_ref=w1_ref)


def test_worker_imports_no_jax(world):
    for res in world.ranks:
        assert res["jax_loaded"] == []


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_every_rank(world, name):
    """Every rank's losses and grad norms (the global mean and the global
    norm) against the JAX engine's, step by step; fp16 also its skipped
    steps and loss scales exactly."""
    want = world.runs[name]
    fp16 = name == "fp16"
    for res in world.ranks:
        got = res[name]["steps"]
        assert len(got) == len(want) == STEPS
        for g, w in zip(got, want):
            assert g["overflow"] == w["overflow"]
            assert g["loss_scale"] == w["loss_scale"]
            if w["overflow"]:
                continue
            np.testing.assert_allclose(g["loss"], w["loss"],
                                       rtol=1e-5, atol=0)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-3 if fp16 else 1e-5, atol=0)
        assert res[name]["counters"] == [int(world.engines[name].state[k])
                                         for k in ("step", "skipped")]
    if fp16:
        # 2^24 halves to 2^22 over three skipped steps
        assert [w["overflow"] for w in want] == [1, 1, 1]
        assert [w["loss_scale"] for w in want] == [2.0 ** 24, 2.0 ** 23,
                                                   2.0 ** 22]
    else:
        assert max(w["grad_norm"] for w in want) > 0.25  # clipping bites


@pytest.mark.parametrize("name", list(CASES))
def test_shards_equal_jax_device_shards(world, name):
    """Rank r's float32 master and moment shards are the JAX state's
    shards on device r, leaf by leaf (stage 0 holds whole leaves; the
    fp16 case's are its initial ones, every step skipped)."""
    st = world.engines[name].state
    keep = lambda a: a    # noqa: E731 - the jax.Arrays, with shards
    trees = {"params": flat(st["params"], conv=keep),
             "m": flat(st["opt"]["m"], conv=keep),
             "v": flat(st["opt"]["v"], conv=keep)}
    for r, res in enumerate(world.ranks):
        for kind, leaves in trees.items():
            for path, arr in leaves.items():
                got = res["shards"][f"{name}/{kind}/{path}"]
                want = device_shard(arr, r)
                assert got.shape == want.shape, (name, kind, path)
                np.testing.assert_allclose(got, want, **TOL)


def test_stage3_state_bytes_follow_the_plan(world):
    """Each rank's state bytes, counted from its tensors, equal the plan's
    count; stage 3 holds at most a quarter of stage 0's bytes plus its
    resident leaves'."""
    for res in world.ranks:
        for name in ("s0", "s1", "s2", "s3", "s3_persist"):
            b, p = res[name]["bytes"], res[name]["planned"]
            assert b == p, name
        total = {n: sum(res[n]["bytes"].values())
                 for n in ("s0", "s1", "s2", "s3")}
        assert total["s0"] > total["s1"] > total["s2"] > total["s3"]
        assert total["s3"] <= total["s0"] / 4 + 1


def test_checkpoint_resumes_across_world_sizes(world):
    """A stage-3 save at world 4 resumes bit-equal at world 4 and loads
    at world 1 into the JAX state's values; a world-1 save loads at
    world 4 and trains as the world-1 engine does."""
    for res in world.ranks:
        assert res["resume"]["resumed"] == res["resume"]["cont"]
        for g, w in zip(res["w1_load"], world.w1_ref):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)
    one = dt.initialize(model=port_model("gpt2"),
                        config=json.loads(json.dumps({**W1, **zero(3)})),
                        device="cpu")[0]
    one.load_checkpoint(os.path.join(world.tmp, "ckpt4"))
    want = jax.device_get(world.engines["s3"].state)
    for path, arr in flat(want["params"]).items():
        node = one.state["params"]
        for k in path.split("/"):
            node = node[k]
        np.testing.assert_allclose(node.numpy(), arr, **TOL)
    assert int(one.state["step"]) == STEPS
    bs = np.load(os.path.join(world.tmp, "batches_s3.npz"))
    m = one.train_step({"input_ids": bs[str(STEPS)]})
    cont = world.ranks[0]["resume"]["cont"][0]
    np.testing.assert_allclose(float(m["loss"]), cont["loss"], rtol=1e-5)


# -- in-process ---------------------------------------------------------------
def _dims_of(spec):
    for d, e in enumerate(spec):
        names = e if isinstance(e, tuple) else (e,)
        if "data" in names or "dcn_data" in names:
            return d
    return None


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("threshold", [0, 5000])
@pytest.mark.parametrize("axes", [dict(data=4), dict(dcn_data=2, data=2)])
def test_policy_dims_equal_jax_specs(family, threshold, axes):
    """For every leaf and stage 1-3, the port's sharded dim is the dim
    the JAX policy's spec names the data axes on (and the spec itself is
    the JAX one)."""
    jm = jax_model(family)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:WORLD])
    pshapes = port_model(family).param_shapes()
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    for stage in (1, 2, 3):
        jp = jsh.ZeroShardingPolicy(
            stage, mesh, jax.tree_util.tree_map(
                lambda s: jax.sharding.PartitionSpec(*([None] * len(s.shape))),
                shapes), shapes, param_persistence_threshold=threshold)
        pp = psh.ZeroShardingPolicy(stage, fake, pshapes,
                                    param_persistence_threshold=threshold)
        for jt, pt, dims in ((jp.master_param_specs(),
                              pp.master_param_specs(),
                              pp.master_param_dims()),
                             (jp.grad_specs(), pp.grad_specs(),
                              pp.grad_dims()),
                             (jp.model_param_specs(), pp.model_param_specs(),
                              pp.model_param_dims())):
            jflat = flat_specs(jax.tree_util.tree_map(
                tuple, jt,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
            pflat = flat_specs(pt)
            dflat = flat(dims, conv=lambda d: d)
            assert jflat == pflat, stage
            for path, js in jflat.items():
                assert dflat[path] == _dims_of(js), (stage, path)


def test_grad_reduce_plan_equals_jax():
    jm = jax_model("gpt2")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    mesh = build_mesh(MeshConfig(data=4), devices=jax.devices()[:WORLD])
    P = jax.sharding.PartitionSpec
    region = jax.tree_util.tree_map(lambda s: P(*([None] * len(s.shape))),
                                    shapes)
    jp = jsh.ZeroShardingPolicy(2, mesh, region, shapes)
    jplan, jout = jsh.grad_reduce_plan(region, jp.grad_specs(), ("data",))
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    pp = psh.ZeroShardingPolicy(2, fake, port_model("gpt2").param_shapes())
    pplan, pout = psh.grad_reduce_plan(pp.param_specs, pp.grad_specs(),
                                       ("data",))
    assert flat(pplan, conv=int) == flat(jplan, conv=int)
    assert flat_specs(pout) == flat_specs(jax.tree_util.tree_map(
        tuple, jout, is_leaf=lambda x: isinstance(x, P)))


@pytest.mark.parametrize("splits", [(1, 1), (2, 4), (4, 2)])
def test_tiled_linear_matches_jax(splits):
    jl = jtiling.TiledLinear(32, 48, *splits)
    pl = ptiling.TiledLinear(32, 48, *splits)
    params = jax.device_get(jl.init(jax.random.PRNGKey(1)))
    params["bias"] = np.linspace(-1, 1, 48).astype(np.float32)
    x = np.random.RandomState(0).randn(3, 5, 32).astype(np.float32)
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    got = pl.apply({k: torch.tensor(v) for k, v in params.items()},
                   torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    assert pl.init(g)["kernel"].shape == params["kernel"].shape
    with pytest.raises(ValueError, match="splits must divide"):
        ptiling.TiledLinear(30, 48, 4, 1)


def test_rank_slices_are_the_jax_device_rows():
    """``rank_slice`` gives rank r the rows device r holds when the JAX
    engine shards ``[gas, micro * dp]`` over ``data``; the loader draws
    them from the same global index stream."""
    gas, dp, micro = 2, 4, 3
    glob = np.arange(gas * dp * micro * 2).reshape(gas * dp * micro, 2)
    as_jax = glob.reshape(gas, dp * micro, 2)
    for r in range(dp):
        mine = rank_slice(glob, gas, dp, r).reshape(gas, micro, 2)
        np.testing.assert_array_equal(
            mine, as_jax[:, r * micro:(r + 1) * micro])
    data = [{"x": np.int64(i)} for i in range(48)]
    whole = next(iter(DeepSpeedDataLoader(data, batch_size=24, seed=3)))
    for r in range(dp):
        loader = DeepSpeedDataLoader(data, batch_size=24, seed=3,
                                     data_parallel_rank=r,
                                     data_parallel_world_size=dp,
                                     gradient_accumulation_steps=gas)
        np.testing.assert_array_equal(next(iter(loader))["x"],
                                      rank_slice(whole["x"], gas, dp, r))


#: configs the slice refuses, each with the message that names its part
REFUSED = [
    # tensor parallelism runs at stages 0-2 (tests/test_torch_tp_training.py);
    # stage 3 over a model-sharded mesh is the 3D composition's
    ({"mesh": {"model": 2}, "zero_optimization": {"stage": 3}},
     "mesh axis model=2: ZeRO stage 3 over a model-sharded mesh, the 3D "
     "composition (queue A item 7)"),
    # the pipeline runs at stages 0-2 (tests/test_torch_pipe*.py); stage
    # 3 with a pipe axis, or pipeline stages, is the 3D composition's
    ({"mesh": {"pipe": 2}, "zero_optimization": {"stage": 3}},
     "mesh axis pipe=2: ZeRO stage 3 over a pipe mesh, the 3D composition "
     "(queue A item 7)"),
    ({"mesh": {"sequence": 2}},
     "mesh axis sequence=2: ring and Ulysses sequence parallelism "
     "(queue A item 7)"),
    ({"mesh": {"expert": 2}},
     "mesh axis expert=2: moe.ep_size above 1, expert parallelism "
     "(queue A item 7)"),
    ({"tensor_parallel": {"enabled": True, "tp_size": 2},
      "zero_optimization": {"stage": 3}},
     "tensor_parallel: ZeRO stage 3 at tp_size 2, the 3D composition "
     "(queue A item 7)"),
    ({"pipeline": {"stages": 2}, "zero_optimization": {"stage": 3}},
     "pipeline.stages 2: ZeRO stage 3 under the pipeline, the 3D "
     "composition (queue A item 7)"),
    ({"mesh": {"pipe": 2}, "zero_optimization": {"stage": 1,
      "offload_optimizer": {"device": "cpu"}}},
     "offload over a pipe mesh (pipe=2): the 3D composition (queue A "
     "item 7)"),
    ({"sequence_parallel": {"enabled": True}},
     "sequence_parallel: ring and Ulysses sequence parallelism "
     "(queue A item 7)"),
    ({"optimizer": {"type": "OneBitAdam"}},
     "optimizer OneBitAdam: the 1-bit optimizers (queue A item 7)"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu"}}, "mesh": {"data": 2}},
     "offload at a data-parallel size of 2: ZeRO-Infinity's dp-sharded "
     "part (queue A item 7)"),
]


@pytest.mark.parametrize("block,message", REFUSED,
                         ids=[m.split(":")[0] for _, m in REFUSED])
def test_config_gate_refusals_word_for_word(block, message):
    with pytest.raises(NotImplementedError) as err:
        dt.initialize(model=port_model("gpt2"),
                      config={"train_batch_size": 4, **block}, device="cpu")
    assert str(err.value) == ("not in the training slice of the PyTorch "
                              f"port: {message} (see ROADMAP.md queue A)")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_gate_admits_zero_stages_at_world_one(stage):
    eng = dt.initialize(model=port_model("gpt2"), config={
        "train_batch_size": 4, **zero(stage)}, device="cpu")[0]
    assert eng.zero_stage == stage and eng.dp_world_size == 1
    with pytest.raises(NotImplementedError, match="compat forward"):
        eng.forward({"input_ids": np.zeros((4, 64), np.int32)})


@pytest.mark.parametrize("weights,parts", [
    ([1.0] * 10, 3), ([5, 1, 1, 1, 8, 2, 2], 3), ([3, 3, 3], 5),
    (list(range(1, 13)), 4)])
def test_runtime_utils_equal_jax(weights, parts):
    """The partitioning math of ``runtime/utils.py`` (pipeline stage
    balancing) and its small helpers, against the JAX package's."""
    from deepspeed_tpu.runtime import utils as ju
    from deepspeed_tpu_torch.runtime import utils as pu
    assert pu.partition_uniform(len(weights), parts) == \
        ju.partition_uniform(len(weights), parts)
    assert pu.partition_balanced(weights, parts) == \
        ju.partition_balanced(weights, parts)
    assert pu.prefix_sum_inc(weights) == ju.prefix_sum_inc(weights)
    assert pu.call_to_str("f", 1, x=2) == ju.call_to_str("f", 1, x=2)
    tree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}}
    assert pu.tree_param_count(tree) == ju.tree_param_count(
        {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5)}}) == 17
