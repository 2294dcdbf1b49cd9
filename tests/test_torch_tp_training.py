"""Tensor-parallel training: the port's ranks against the JAX engine on a
mesh of the same shape.

The port runs its ranks as child processes on ``gloo`` on the CPU
(``comm/local_ranks.py``): a world of 4 ({data 2, model 2}) and a world
of 2 ({model 2}), each started once for the module and running every
case of its size in turn; the worker source imports no JAX.  The JAX
side runs in this process on the conftest's 8-device virtual CPU mesh
while the ranks run: its engine on ``build_mesh(MeshConfig(data=2,
model=2))`` lays the params out by the model's ``partition_specs`` and
lets GSPMD place the collectives; the port's ranks run Megatron's
``copy_to`` / ``reduce_from`` pair, the vocab-parallel loss and the
exit reduction of the partial leaves.  Cases (f32):

* tiny GPT-2 (2 layers, d 64, 4 heads) at {data 2, model 2}, ZeRO stages
  0, 1 and 2, 3 steps from the same params (micro 2 a data rank, gas 2,
  clipping at 0.25 so that it bites): every rank's loss and grad norm
  within 1e-5 of the JAX engine's, the whole masters gathered from the
  ranks within 1e-5 of its state, and each rank's state bytes by kind
  the plan's count;
* tiny LLaMA (GQA 8 over 2 kv heads, untied head, rotary) at {model 2},
  2 steps, the same checks;
* the traps: the global norm (a model-sharded leaf's squares summed over
  the model ranks, a replicated one counted once: the grad norm above),
  the dataloader (the model ranks of one data coordinate take the same
  rows), ALiBi (a BLOOM-like model's logits at model 2 equal its logits
  at one rank);
* ``copy_to`` / ``reduce_from`` forward and backward, and
  ``psum_tp_partials``, against the JAX ``custom_vjp`` pair under
  ``shard_map``; ``qkv_shard_columns``, ``partition_specs`` and
  ``auto_tp_specs`` equal to JAX's;
* a checkpoint saved at {data 1, model 2}, loaded at {data 2, model 1}
  (the next step as a run of one rank takes it), and served at
  ``tensor_parallel.tp_size`` 2 (``generate()`` as one rank serves it).
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
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.module_inject.auto_tp import auto_tp_specs as jax_auto_tp
from deepspeed_tpu.parallel import collectives as jc
from deepspeed_tpu.parallel.shard_map_compat import shard_map
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.comm.local_ranks import run_ranks
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.module_inject.auto_tp import auto_tp_specs
from deepspeed_tpu_torch.parallel import collectives as pc
from deepspeed_tpu_torch.runtime.dataloader import rank_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
GPT2 = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=256,
            max_seq_len=64, attn_impl="xla", remat="full", loss_chunk=16)
LLAMA = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=96, vocab_size=64, max_seq_len=64,
             pos_embedding="rotary", rotary_interleaved=False,
             norm_type="rmsnorm", activation="silu", gated_mlp=True,
             tie_embeddings=False, use_bias=False, attn_impl="xla",
             remat="full", loss_chunk=16)
BLOOM = dict(num_layers=2, d_model=48, num_heads=6, vocab_size=64,
             max_seq_len=64, pos_embedding="alibi", embed_layernorm=True,
             attn_impl="xla")
FAMILIES = {"gpt2": GPT2, "llama": LLAMA, "bloom": BLOOM}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 6e-4, "weight_decay": 0.1}},
        "gradient_clipping": 0.25, "steps_per_print": 0}


def zero(stage):
    return {"zero_optimization": {"stage": stage}}


#: name → (world, family, mesh, config, batch seed, steps)
CASES = {
    "s0": (4, "gpt2", {"data": 2, "model": 2}, zero(0), 1, 3),
    "s1": (4, "gpt2", {"data": 2, "model": 2}, zero(1), 1, 3),
    "s2": (4, "gpt2", {"data": 2, "model": 2}, zero(2), 1, 3),
    "llama": (2, "llama", {"model": 2}, zero(0), 3, 2),
}


def jax_model(family):
    kw = FAMILIES[family]
    cfg = (jax_tf.gpt2_config("125m", dtype=jnp.float32, **kw)
           if family == "gpt2" else
           jax_tf.TransformerConfig(dtype=jnp.float32, **kw))
    return jax_tf.TransformerLM(cfg)


def port_model(family):
    kw = FAMILIES[family]
    cfg = (tt.gpt2_config("125m", dtype=torch.float32, **kw)
           if family == "gpt2" else
           tt.TransformerConfig(dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)


def global_batch(family, mesh, seed, i):
    rs = np.random.RandomState(seed * 100 + i)
    n = 2 * 2 * mesh.get("data", 1)
    return rs.randint(0, FAMILIES[family]["vocab_size"],
                      (n, 64)).astype(np.int32)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


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
from deepspeed_tpu_torch.parallel import collectives as pc
from deepspeed_tpu_torch.runtime.dataloader import rank_slice

d = os.environ["TP_TEST_DIR"]
dt.init_distributed("gloo", timeout=90)
rank, world = comm.get_rank(), comm.get_world_size()
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
    kw = spec["families"][family]
    cfg = (tt.gpt2_config("125m", dtype=torch.float32, **kw)
           if family == "gpt2"
           else tt.TransformerConfig(dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)

def zero(stage):
    return {"zero_optimization": {"stage": stage}}

def params(family, m):
    return params_from_jax(unflat(np.load(os.path.join(
        d, f"init_{family}.npz"))), m)

def engine(family, mesh_block, config, p=True, **kw):
    m = model(family)
    cfg = {**spec["base"], **config, "mesh": mesh_block}
    return dt.initialize(model=m, config=cfg,
                         params=params(family, m) if p else None,
                         device="cpu", **kw)

out, whole = {}, {}
for name, (w, family, mesh, config, seed, steps) in spec["cases"].items():
    if w != world:
        continue
    eng = engine(family, mesh, config)[0]
    batches = np.load(os.path.join(d, f"batches_{name}.npz"))
    rows = []
    for i in range(steps):
        b = rank_slice({"input_ids": batches[str(i)]},
                       eng.gradient_accumulation_steps, eng.dp_world_size,
                       eng.dp_rank)
        m = eng.train_step(b)
        rows.append([float(m["loss"]), float(m["grad_norm"])])
    full = eng.full_state()
    whole.update({name + "/" + k: v for k, v in flat(full["params"]).items()})
    out[name] = {"rows": rows, "bytes": eng.zero_state_bytes(),
                 "planned": eng._zero.planned_bytes(eng._param_shapes, 4),
                 "n_params": eng.num_parameters(),
                 "dp_rank": eng.dp_rank}

if world == 4:
    # the dataloader: every rank's first batch
    data = [{"input_ids": np.full((64,), i, np.int32)} for i in range(32)]
    # initialize takes the mesh (the config's mesh block is the default)
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.config import MeshConfig
    _, _, loader, _ = engine("gpt2", {"data": -1}, {}, training_data=data,
                             mesh=build_mesh(MeshConfig(data=2, model=2)))
    out["loader"] = next(iter(loader))["input_ids"][:, 0].tolist()

if world == 2:
    # Megatron's pair and the exit reduction against JAX's
    io = np.load(os.path.join(d, "pair.npz"))
    x = torch.tensor(io["x"][rank], requires_grad=True)
    w = torch.tensor(io["w"][rank], requires_grad=True)
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.config import MeshConfig
    comm.set_mesh(build_mesh(MeshConfig(model=2)))
    y = pc.reduce_from(pc.copy_to(x, "model") * w, "model")
    gx, gw = torch.autograd.grad((y * torch.tensor(io["c"])).sum(), [x, w])
    tree = {"blocks": {"attn": {"qkv": {"kernel": torch.tensor(
        io["g"][rank])}, "out": {"kernel": torch.tensor(io["g"][rank])}}}}
    red = pc.psum_tp_partials(tree, "model")
    out["pair"] = {"y": y.tolist(), "gx": gx.tolist(), "gw": gw.tolist(),
                   "qkv": red["blocks"]["attn"]["qkv"]["kernel"].tolist(),
                   "out": red["blocks"]["attn"]["out"]["kernel"].tolist()}
    # ALiBi: a BLOOM-like model's logits at tp_size 2
    m = model("bloom")
    ieng = dt.init_inference(m, {"dtype": "float32",
                                 "tensor_parallel": {"tp_size": 2}},
                             params=params("bloom", m), device="cpu")
    ids = np.load(os.path.join(d, "bloom_ids.npy"))
    out["bloom"] = ieng.forward(ids).tolist()
    # a checkpoint saved at {data 1, model 2}, loaded at {data 2, model 1}
    # and served at tp_size 2
    ck = os.path.join(d, "ckpt")
    batches = np.load(os.path.join(d, "batches_ckpt.npz"))
    a = engine("gpt2", {"data": 1, "model": 2},
               {**zero(1), "train_micro_batch_size_per_gpu": 4})[0]
    a.train_step(rank_slice({"input_ids": batches["0"]}, 2, 1, 0))
    a.save_checkpoint(ck)
    b = engine("gpt2", {"data": 2, "model": 1}, zero(2), p=False)[0]
    b.load_checkpoint(ck)
    m = b.train_step(rank_slice({"input_ids": batches["1"]}, 2, 2,
                                b.dp_rank))
    out["ckpt_step"] = [float(m["loss"]), float(m["grad_norm"])]
    m = model("gpt2")
    ieng = dt.init_inference(m, {"dtype": "float32", "checkpoint": ck,
                                 "tensor_parallel": {"tp_size": 2}},
                             device="cpu")
    out["ckpt_gen"] = ieng.generate(np.arange(1, 9)[None],
                                    max_new_tokens=6).tolist()
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
    cfg = json.loads(json.dumps({**BASE, **config}))
    return ds.initialize(model=jax_model(family), config=cfg, mesh=jm)[0]


def pair_inputs():
    rs = np.random.RandomState(7)
    return {k: rs.randn(*s).astype(np.float32) for k, s in
            (("x", (2, 3, 4)), ("w", (2, 3, 4)), ("c", (3, 4)),
             ("g", (2, 5, 6)))}


def jax_pair(io):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))
    c = jnp.asarray(io["c"])

    def body(x, w, g):
        def f(x, w):
            y = jc.reduce_from("model")(jc.copy_to("model")(x[0]) * w[0])
            return jnp.sum(y * c), y
        (_, y), (gx, gw) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(x, w)
        tree = {"blocks": {"attn": {"qkv": {"kernel": g[0]},
                                    "out": {"kernel": g[0]}}}}
        red = jc.psum_tp_partials(tree, "model")
        return (y[None], gx, gw, red["blocks"]["attn"]["qkv"]["kernel"][None],
                red["blocks"]["attn"]["out"]["kernel"][None])
    sm = shard_map(body, mesh, in_specs=(P("model"),) * 3,
                   out_specs=(P("model"),) * 5)
    return [np.asarray(a) for a in jax.jit(sm)(
        jnp.asarray(io["x"]), jnp.asarray(io["w"]), jnp.asarray(io["g"]))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_training"))
    inits = {}
    for family in FAMILIES:
        inits[family] = jax.device_get(jax_model(family).init(
            jax.random.PRNGKey(0)))
        np.savez(os.path.join(tmp, f"init_{family}.npz"),
                 **flat(inits[family]))
    for name, (_, family, mesh, _, seed, steps) in CASES.items():
        np.savez(os.path.join(tmp, f"batches_{name}.npz"),
                 **{str(i): global_batch(family, mesh, seed, i)
                    for i in range(steps)})
    ck_batches = [global_batch("gpt2", {"data": 2}, 9, i) for i in range(2)]
    np.savez(os.path.join(tmp, "batches_ckpt.npz"),
             **{str(i): b for i, b in enumerate(ck_batches)})
    io = pair_inputs()
    np.savez(os.path.join(tmp, "pair.npz"), **io)
    ids = np.random.RandomState(3).randint(0, 64, (2, 12))
    np.save(os.path.join(tmp, "bloom_ids.npy"), ids)
    with open(os.path.join(tmp, "cases.json"), "w") as fh:
        json.dump({"cases": CASES, "families": FAMILIES, "base": BASE}, fh)
    box = {}

    def ranks(n):
        os.makedirs(os.path.join(tmp, f"logs{n}"))
        try:
            run_ranks(WORKER, n, timeout=240, env={"TP_TEST_DIR": tmp},
                      cwd=REPO, log_dir=os.path.join(tmp, f"logs{n}"))
        except Exception as e:   # noqa: BLE001 - raised in the test below
            box[n] = e
    threads = [threading.Thread(target=ranks, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    runs, states = {}, {}
    for name, (_, family, mesh, config, seed, steps) in CASES.items():
        je = jax_engine(family, mesh, config)
        bs = np.load(os.path.join(tmp, f"batches_{name}.npz"))
        runs[name] = [{k: float(v) for k, v in je.train_step(
            {"input_ids": bs[str(i)]}).items()} for i in range(steps)]
        states[name] = flat(jax.device_get(je.state["params"]))
    pair = jax_pair(io)
    # one rank of the port: the ALiBi model's logits
    pm = port_model("bloom")
    one = dt.init_inference(pm, {"dtype": "float32"},
                            params=params_from_jax(inits["bloom"], pm),
                            device="cpu")
    bloom = one.forward(ids).numpy()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "the ranks outlived their deadline"
    for n, e in box.items():
        raise e
    ranks_out = {n: [json.load(open(os.path.join(tmp, f"w{n}_rank{r}.json")))
                     for r in range(n)] for n in (2, 4)}
    whole = {n: dict(np.load(os.path.join(tmp, f"whole{n}.npz")))
             for n in (2, 4)}
    # the checkpoint's references: one rank loads it, takes the next
    # step at the same global batch and serves it
    ck = os.path.join(tmp, "ckpt")
    one = dt.initialize(model=port_model("gpt2"), config={
        **BASE, "train_micro_batch_size_per_gpu": 4, **zero(0)},
        device="cpu")[0]
    one.load_checkpoint(ck)
    m = one.train_step({"input_ids": ck_batches[1]})
    ck_step = [float(m["loss"]), float(m["grad_norm"])]
    ieng = dt.init_inference(port_model("gpt2"), {"dtype": "float32",
                                                  "checkpoint": ck},
                             device="cpu")
    ck_gen = ieng.generate(np.arange(1, 9)[None], max_new_tokens=6).tolist()
    return types.SimpleNamespace(runs=runs, states=states, ranks=ranks_out,
                                 whole=whole, pair=pair, io=io, bloom=bloom,
                                 ck_step=ck_step, ck_gen=ck_gen,
                                 inits=inits, ids=ids)


def test_workers_import_no_jax(world):
    for n in (2, 4):
        for res in world.ranks[n]:
            assert res["jax_loaded"] == []


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_every_rank(world, name):
    """Every rank's loss and grad norm (the global ones: the norm sums a
    model-sharded leaf's squares over the model ranks and counts a
    replicated one once) against the JAX engine's on the same mesh."""
    n = CASES[name][0]
    want = world.runs[name]
    for res in world.ranks[n]:
        got = res[name]["rows"]
        assert len(got) == len(want)
        for (loss, gnorm), w in zip(got, want):
            np.testing.assert_allclose(loss, w["loss"], rtol=1e-5, atol=0)
            np.testing.assert_allclose(gnorm, w["grad_norm"], rtol=1e-5,
                                       atol=0)
    if name == "s0":
        assert max(w["grad_norm"] for w in want) > 0.25  # clipping bites


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_masters_equal_jax(world, name):
    """The whole masters gathered from the ranks equal the JAX engine's
    state within 1e-5, but for at most 1 in 10^4 elements, each within
    Adam's bound on one element's move over the run (2 x lr x steps):
    the shards' products sum in another order than GSPMD's, and Adam
    divides each element's gradient by its own scale, so an element
    whose gradient is rounding noise can move by up to lr a step either
    way."""
    n, steps = CASES[name][0], CASES[name][5]
    got = {k.split("/", 1)[1]: v for k, v in world.whole[n].items()
           if k.startswith(name + "/")}
    want = world.states[name]
    assert set(got) == set(want)
    bound = 2 * BASE["optimizer"]["params"]["lr"] * steps
    for k, v in want.items():
        off = ~np.isclose(got[k], v, **TOL)
        assert off.sum() <= max(1, v.size // 10**4), (k, int(off.sum()))
        np.testing.assert_allclose(got[k], v, rtol=0, atol=bound,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_follow_the_plan(world, name):
    """Each rank's bytes by kind, counted from its tensors, are the
    plan's count over its model slice; the parameter count is the whole
    model's."""
    n, family = CASES[name][0], CASES[name][1]
    for res in world.ranks[n]:
        assert res[name]["bytes"] == res[name]["planned"]
        assert res[name]["n_params"] == sum(
            v.size for v in flat(world.inits[family]).values())


def test_dataloader_cuts_by_the_data_coordinate(world):
    """Ranks (d, 0) and (d, 1) take the same rows, data coordinate d's
    ``rank_slice`` of the global batch (a cut by the global rank would
    give four different slices, two of them past the data axis)."""
    got = [res["loader"] for res in world.ranks[4]]
    assert [res["s0"]["dp_rank"] for res in world.ranks[4]] == [0, 0, 1, 1]
    assert got[0] == got[1] and got[2] == got[3] and got[0] != got[2]
    assert sorted(got[0] + got[2]) == sorted(set(got[0] + got[2]))


def test_copy_to_and_reduce_from_equal_jax_pair(world):
    y, gx, gw, qkv, out = world.pair
    for r, res in enumerate(world.ranks[2]):
        p = res["pair"]
        np.testing.assert_allclose(np.asarray(p["y"]), y[r], **TOL)
        np.testing.assert_allclose(np.asarray(p["gx"]), gx[r], **TOL)
        np.testing.assert_allclose(np.asarray(p["gw"]), gw[r], **TOL)
        # the partial leaf summed over the model ranks, the other kept
        np.testing.assert_allclose(np.asarray(p["qkv"]), qkv[r], **TOL)
        np.testing.assert_allclose(np.asarray(p["out"]), out[r], **TOL)
    np.testing.assert_allclose(qkv[0], world.io["g"].sum(0), **TOL)
    np.testing.assert_allclose(out[1], world.io["g"][1], **TOL)


def test_alibi_logits_at_model_2_equal_one_rank(world):
    """Each shard takes its slice of the whole model's slopes (6 heads:
    the slopes of 3 heads alone differ), so the logits at model 2 are
    those of one rank, and of the JAX model."""
    jm = jax_model("bloom")
    want = np.asarray(jm.apply(world.inits["bloom"], jnp.asarray(world.ids)))
    np.testing.assert_allclose(world.bloom, want, **TOL)
    for res in world.ranks[2]:
        np.testing.assert_allclose(np.asarray(res["bloom"]), world.bloom,
                                   **TOL)


def test_checkpoint_across_meshes(world):
    """Saved at {data 1, model 2} (whole, in the JAX layout), loaded at
    {data 2, model 1}: the next step equals one rank's from the same
    file; served at tp_size 2, generate() equals one rank's."""
    for res in world.ranks[2]:
        np.testing.assert_allclose(res["ckpt_step"], world.ck_step,
                                   rtol=1e-5)
        assert res["ckpt_gen"] == world.ck_gen


# -- in process ---------------------------------------------------------------
@pytest.mark.parametrize("heads,kv,mp", [(4, 4, 2), (8, 2, 2), (12, 12, 4),
                                         (32, 4, 4)])
def test_qkv_shard_columns_equal_jax(heads, kv, mp):
    np.testing.assert_array_equal(pc.qkv_shard_columns(heads, kv, 16, mp),
                                  jc.qkv_shard_columns(heads, kv, 16, mp))
    assert pc.TP_PARTIAL_SUFFIXES == jc.TP_PARTIAL_SUFFIXES


def _tuples(tree):
    return jax.tree_util.tree_map(
        lambda s: tuple(s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("family", ["gpt2", "llama", "bloom"])
def test_partition_and_auto_tp_specs_equal_jax(family):
    jm = jax_model(family)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    pm = port_model(family)
    want = _tuples(jm.partition_specs())
    got = pm.partition_specs()

    def leaves(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(leaves(v, pre + "/" + k))
            else:
                out[pre + "/" + k] = tuple(v)
        return out
    assert leaves(got) == leaves(want)
    mesh = build_mesh(MeshConfig(data=4, model=2),
                      devices=jax.devices()[:8])
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    assert leaves(auto_tp_specs(pm.param_shapes(), fake)) == \
        leaves(_tuples(jax_auto_tp(shapes, mesh)))


def test_rank_slice_takes_the_data_coordinate():
    """``rank_slice`` cuts by the data coordinate: dp 2 has coordinates 0
    and 1 only."""
    glob = np.arange(16).reshape(16, 1)
    assert rank_slice(glob, 2, 2, 1).ravel().tolist() == [4, 5, 6, 7, 12,
                                                          13, 14, 15]
    with pytest.raises(IndexError):
        rank_slice(glob, 2, 2, 3)
