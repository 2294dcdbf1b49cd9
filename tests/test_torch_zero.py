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
  stage 3;
* the MoE with drops (capacity factor 1.0) and an aux loss (0.01), top-1
  and top-2, at stages 0 and 2: the JAX layer gates the whole global
  micro batch (capacity from the global token count, slots in the
  global batch's order), and so does every rank of the port, from the
  logits all-gathered over the batch axes; RTS is off (the two packages
  draw their noise from other generators); after the steps, the top-1
  stage-2 case's and {expert 4} stage 2's ``eval_loss`` at gas 2 (the
  whole batch routed at once, in the JAX layout ``[gas, micro * dp]``);
* expert parallelism, the same MoE at {expert 4} (stages 0 and 2) and at
  {data 2, expert 2} (top-2, stages 0, 2 and 3), each held to the JAX
  engine at that mesh: losses, grad norms and master shards, every
  rank's ``exp_counts`` and kept tokens equal to one rank's over the
  same global batches, the expert stacks' bytes 1/ep (and 1/dp above
  stage 0) of the whole; with RTS on and one ``moe_rng`` seed, the
  routing at {expert 4} equals one rank's; a checkpoint saved at
  {expert 4} loads at world 1 and one saved at world 1 loads at
  {expert 4}, each taking the other's next step;
* fp16 with a scale that overflows at first (2^24, four times and more
  above where this model's gradients overflow float16): the same
  skipped steps and scale trajectory on every rank as in JAX, and the
  masters kept.  Near that boundary the two may part: the port, as the
  reference, reduces each rank's float16 gradients in float32;
* LAMB at stages 1 and 3 (held to one JAX LAMB engine at stage 3: its
  trust ratio over the whole leaf, from each rank's pieces' sums in one
  ``leaf_sums`` call a step, one all-reduce over data, pinned), and
  client ``torch.optim`` optimizers on the master shards (AdamW at
  stage 2 against ``optax.adamw``, SGD with momentum at stage 3 against
  ``optax.sgd``, every hyperparameter explicit); ``torch.optim.Adafactor``
  (factored state) at stage 1 raises on every rank at its first step;
* a checkpoint saved at world 4 stage 3 that resumes bit-equal at
  world 4 and loads at world 1, and a world-1 checkpoint that loads at
  world 4; the client AdamW's stage-2 checkpoint likewise (its state in
  the world-1 layout);
* in-process: ``ZeroPartition.leaf_sums`` and the global norm sum each
  leaf over the axes the JAX policy cuts it along (a fake mesh, each
  axis group's all-reduce a distinct factor); ``ZeroShardingPolicy``'s
  dims against the JAX policy's specs, ``grad_reduce_plan``,
  ``TiledLinear``, the dataloader's rank slices and the config gate's
  refusals, word for word.
"""
import functools
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
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
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
#: the MoE with dropped tokens and an aux loss, top-1 and top-2
MOE_DROP = dict(MOE, moe_capacity_factor=1.0, moe_aux_loss_coef=0.01)
MOE_DROP2 = dict(MOE_DROP, moe_k=2)
FAMILIES = {"gpt2": GPT2, "llama": LLAMA, "moe": MOE, "moe_drop": MOE_DROP,
            "moe_drop2": MOE_DROP2,
            "moe_rts": dict(MOE_DROP, moe_use_rts=True)}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 6e-4, "weight_decay": 0.1}},
        "gradient_clipping": 0.25, "steps_per_print": 0}
#: LAMB in the config, and the client optimizers (``"client"``: a
#: torch.optim class and its arguments, popped before ``initialize``; the
#: JAX engine takes the optax transformation of the same step, every
#: hyperparameter explicit, as the two libraries' defaults differ)
LAMB = {"optimizer": {"type": "Lamb",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}}}
NO_OPT = {k: v for k, v in BASE.items() if k != "optimizer"}
CLIENT_ADAMW = {"client": {"type": "AdamW", "params": {
    "lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01}}}
CLIENT_SGD = {"client": {"type": "SGD", "params": {"lr": 0.05,
                                                    "momentum": 0.9}}}
STEPS = 3
GLOBAL = 2 * 2 * WORLD
#: one rank over the same global batch: micro 8 = 4 ranks x 2
W1 = {**BASE, "train_micro_batch_size_per_gpu": 2 * WORLD}


def zero(stage, threshold=0):
    return {"zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": threshold}}


EP4 = {"mesh": {"expert": 4}}
D2E2 = {"mesh": {"data": 2, "expert": 2}}


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
    "lamb_s1": ("gpt2", {**BASE, **LAMB, **zero(1)}, 1),
    "lamb_s3": ("gpt2", {**BASE, **LAMB, **zero(3)}, 1),
    "client_s2": ("gpt2", {**NO_OPT, **CLIENT_ADAMW, **zero(2)}, 1),
    "client_sgd_s3": ("gpt2", {**NO_OPT, **CLIENT_SGD, **zero(3)}, 1),
    "moe_drop_s0": ("moe_drop", {**BASE, **zero(0)}, 4),
    "moe_drop_s2": ("moe_drop", {**BASE, **zero(2)}, 4),
    "moe_drop2_s0": ("moe_drop2", {**BASE, **zero(0)}, 4),
    "moe_drop2_s2": ("moe_drop2", {**BASE, **zero(2)}, 4),
    "ep4_s0": ("moe_drop", {**BASE, **zero(0), **EP4}, 5),
    "ep4_s2": ("moe_drop", {**BASE, **zero(2), **EP4}, 5),
    "d2e2_s0": ("moe_drop2", {**BASE, **zero(0), **D2E2}, 6),
    "d2e2_s2": ("moe_drop2", {**BASE, **zero(2), **D2E2}, 6),
    "d2e2_s3": ("moe_drop2", {**BASE, **zero(3), **D2E2}, 6),
}
#: the MoE cases: every rank's routing is held to one rank's too
MOE_CASES = [n for n, c in CASES.items() if c[0].startswith("moe_")]
#: the MoE cases whose ``eval_loss`` (gas 2) after the steps is held to
#: the JAX engine's
EVALS = ("moe_drop_s2", "ep4_s2")
#: RTS at {expert 4} with one moe_rng seed, held to one rank (port only:
#: the JAX engine draws its noise from another generator)
RTS = ("moe_rts", {**BASE, **zero(2), **EP4}, 7)
CLIENTS = ("client_s2", "client_sgd_s3")
#: a client optimizer whose state is not shaped like its leaf (factored
#: row and column statistics) at stage 1: refused on shards
ADAFACTOR = {**NO_OPT, **zero(1),
             "client": {"type": "Adafactor", "params": {"lr": 1e-2}}}


#: stages 1 and 2 are held to the JAX engine at stage 3: at threshold 0
#: its master and moment specs are theirs (test_policy_dims_equal_jax_
#: specs), and every JAX stage computes the same function
JAX_REF = {name: {"s1": "s3", "s2": "s3", "lamb_s1": "lamb_s3",
                  "moe_drop_s0": "moe_drop_s2",
                  "moe_drop2_s0": "moe_drop2_s2", "ep4_s0": "ep4_s2",
                  "d2e2_s0": "d2e2_s3", "d2e2_s2": "d2e2_s3"}.get(name, name)
           for name in CASES}


def optax_of(client):
    """The optax transformation that takes the step of ``client``'s
    torch.optim optimizer."""
    import optax
    p = client["params"]
    if client["type"] == "AdamW":
        return optax.adamw(p["lr"], b1=p["betas"][0], b2=p["betas"][1],
                           eps=p["eps"], weight_decay=p["weight_decay"])
    return optax.sgd(p["lr"], momentum=p["momentum"])


def jax_model(family, fp16=False):
    dtype = jnp.float16 if fp16 else jnp.float32
    if family == "gpt2":
        return jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=dtype,
                                                       **GPT2))
    kw = FAMILIES[family]
    cfg = (jax_tf.gpt2_config("125m", dtype=dtype, **kw)
           if family.startswith("moe")
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
import functools, json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.dataloader import rank_slice
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves

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

# the all-reduces made inside ZeroPartition.leaf_sums, by axis group
_all_reduce, AR = comm.all_reduce, {"on": False, "axes": []}

def counted_all_reduce(t, op=comm.ReduceOp.SUM, axis_name="data"):
    if AR["on"]:
        AR["axes"].append(str(axis_name))
    return _all_reduce(t, op, axis_name)
comm.all_reduce = counted_all_reduce

def count_leaf_sums(eng):
    real = eng._zero.leaf_sums

    def leaf_sums(tree):
        AR["on"] = True
        try:
            return real(tree)
        finally:
            AR["on"] = False
            AR["calls"] = AR.get("calls", 0) + 1
    eng._zero.leaf_sums = leaf_sums

def engine(name, params=None, config=None):
    family, cfg, _ = (spec["rts"] if name == "moe_rts"
                      else spec["cases"][name])
    config = dict(config or cfg)
    client = config.pop("client", None)
    opt = None
    if client is not None:
        opt = functools.partial(getattr(torch.optim, client["type"]), **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in client["params"].items()})
    m = model(family)
    p = None
    if params is not None:
        p = params_from_jax(unflat(np.load(os.path.join(d, params))), m)
    eng, _, _, _ = dt.initialize(model=m, config=config, params=p,
                                 optimizer=opt, device="cpu")
    count_leaf_sums(eng)
    return eng

def steps(eng, name, which):
    out = []
    batches = np.load(os.path.join(d, f"batches_{name}.npz"))
    for i in which:
        b = rank_slice({"input_ids": batches[str(i)]},
                       eng.gradient_accumulation_steps, eng.dp_world_size,
                       rank)
        if name == "moe_rts":
            b["moe_rng"] = 1000 + i
        AR.update(axes=[], calls=0)
        m = eng.train_step(b)
        out.append({k: float(v) for k, v in m.items()})
        out[-1]["leaf_sums"] = [AR["calls"], AR["axes"]]
        if eng._moe:
            # each MoE layer's routing of the step's last micro batch
            out[-1]["moe"] = [[c.tolist(), int(k), cap] for c, k, cap
                              in eng._runner.moe_stats]
    return out

def expert_bytes(eng):
    out = {}
    flat(eng.state["params"], "", out)
    return int(sum(v.nbytes for k, v in out.items() if "/experts/" in k))

results, shards = {}, {}
for name in spec["cases"]:
    eng = engine(name, f"init_{name}.npz")
    results[name] = {"steps": steps(eng, name, range(spec["steps"])),
                     "expert_bytes": expert_bytes(eng),
                     "bytes": eng.zero_state_bytes(),
                     "planned": eng._zero.planned_bytes(
                         eng._param_shapes,
                         torch.finfo(eng.compute_dtype).bits // 8),
                     "counters": [int(eng.state["step"]),
                                  int(eng.state["skipped"])]}
    if name in spec["evals"]:
        # after the steps: the whole batch at once, gas 2 runs a rank
        b = np.load(os.path.join(d, f"batches_{name}.npz"))
        results[name]["eval"] = float(eng.eval_loss(rank_slice(
            {"input_ids": b[str(spec["steps"])]},
            eng.gradient_accumulation_steps, eng.dp_world_size, rank)))
    flat(eng.state["params"], name + "/params", shards)
    for k in ("m", "v"):
        if k in eng.state["opt"]:
            flat(eng.state["opt"][k], f"{name}/{k}", shards)
    if name in ("s3", "client_s2"):
        ck = os.path.join(d, "ckpt4" if name == "s3" else "ckpt4_client")
        eng.save_checkpoint(ck)
        more = steps(eng, name, [spec["steps"]])
        again = engine(name)
        again.load_checkpoint(ck)
        resumed = steps(again, name, [spec["steps"]])
        results["resume" if name == "s3" else "resume_client"] = {
            "cont": more, "resumed": resumed,
            "leaves_equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(eng.state), tree_leaves(again.state)))}
        if name == "client_s2":
            full = eng.full_state()
            flat(full["params"], "client_cont/params", shards)
    if name == "ep4_s2":
        # saved at {expert 4} (rank 0 gathers the expert stacks into the
        # world-1 layout), loaded at world 1 by the test
        eng.save_checkpoint(os.path.join(d, "ckpt_ep4"))
        results["resume_ep4"] = {"cont": steps(eng, name,
                                               [spec["steps"]])}
    del eng

# RTS at {expert 4}: every rank draws the whole batch's noise from the
# micro batch's seed
results["moe_rts"] = {"steps": steps(engine("moe_rts", "init_moe_rts.npz"),
                                     "moe_rts", range(spec["steps"]))}
# a world-1 MoE checkpoint loaded at {expert 4}
ep4 = engine("ep4_s2")
ep4.load_checkpoint(os.path.join(d, "ckpt1_moe"))
results["w1_moe_load"] = steps(ep4, "w1_moe", range(2))
del ep4

# a client optimizer whose state is not shaped like its leaf, on shards
try:
    steps(engine("client_s2", config=spec["adafactor"]), "client_s2", [0])
    results["adafactor"] = None
except NotImplementedError as e:
    results["adafactor"] = str(e)

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
    mesh = build_mesh(MeshConfig(**config.get("mesh", {"data": WORLD})),
                      devices=jax.devices()[:WORLD])
    config = json.loads(json.dumps(config))
    client = config.pop("client", None)
    eng, _, _, _ = ds.initialize(model=jax_model(family, fp16),
                                 config=config, mesh=mesh,
                                 optimizer=client and optax_of(client))
    return eng


def device_shard(arr, r):
    dev = jax.devices()[r]
    return np.asarray([s for s in arr.addressable_shards
                       if s.device == dev][0].data)


def device_piece(arr, r):
    """Device r's piece of ``arr`` over every mesh axis but the data
    axes (a stage-0 rank's masters where the JAX reference runs a
    sharded stage: the expert stacks cut over ``expert`` only)."""
    mesh, spec = arr.sharding.mesh, arr.sharding.spec
    pos = dict(zip(mesh.axis_names, np.argwhere(
        mesh.devices == jax.devices()[r])[0]))
    x = np.asarray(arr)
    for dim, e in enumerate(spec):
        for name in (() if e is None else e if isinstance(e, tuple)
                     else (e,)):
            if name in ("data", "dcn_data"):
                break                    # the data axes come innermost
            x = np.split(x, mesh.shape[name], axis=dim)[int(pos[name])]
    return x


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
    # the RTS case's init and batches, and a world-1 MoE checkpoint (one
    # step) for the ranks to load at {expert 4}
    moe_init = jax.device_get(engines["ep4_s2"].state["params"])
    np.savez(os.path.join(tmp, "init_moe_rts.npz"), **flat(moe_init))
    np.savez(os.path.join(tmp, "batches_moe_rts.npz"), **{
        str(i): b for i, b in enumerate(global_batches("moe_rts", RTS[2],
                                                       STEPS))})
    w1_moe = port_w1("moe_drop", moe_init, zero(2))
    w1_moe_batches = global_batches("moe_drop", 8, 3)
    w1_moe.train_step({"input_ids": w1_moe_batches[0]})
    w1_moe.save_checkpoint(os.path.join(tmp, "ckpt1_moe"))
    np.savez(os.path.join(tmp, "batches_w1_moe.npz"),
             **{str(i): b for i, b in enumerate(w1_moe_batches[1:])})
    w1_moe_ref = [{k: float(v) for k, v in w1_moe.train_step(
        {"input_ids": b}).items()} for b in w1_moe_batches[1:]]
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": CASES, "families": FAMILIES, "steps": STEPS,
                   "adafactor": ADAFACTOR, "rts": RTS, "evals": EVALS}, f)

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
    jax_runs, jax_evals = {}, {}
    for name, je in engines.items():
        bs = np.load(os.path.join(tmp, f"batches_{name}.npz"))
        jax_runs[name] = [{k: float(v) for k, v in je.train_step(
            {"input_ids": bs[str(i)]}).items()} for i in range(STEPS)]
        if name in EVALS:
            jax_evals[name] = float(je.eval_loss(
                {"input_ids": bs[str(STEPS)]}))
    # one rank of the port over each MoE case's global batches (and the
    # RTS case's, with its seeds): the routing every rank must hold
    one_rank = {}
    for name in MOE_CASES + ["moe_rts"]:
        family, config, seed = RTS if name == "moe_rts" else CASES[name]
        key = (family, seed)
        if key not in one_rank:
            init = np.load(os.path.join(tmp, f"init_{name}.npz"))
            one_rank[key] = w1_routing(
                port_w1(family, unflat(dict(init)), zero(0)),
                np.load(os.path.join(tmp, f"batches_{name}.npz")),
                rts=name == "moe_rts")
        one_rank[name] = one_rank[key]
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
                                 ranks=ranks_out, tmp=tmp, w1_ref=w1_ref,
                                 w1_moe_ref=w1_moe_ref, one_rank=one_rank,
                                 moe_init=moe_init, evals=jax_evals)


def port_w1(family, params, stage):
    """One rank of the port over the global batch (micro 8 = 4 ranks x
    2), from ``params`` (the JAX tree)."""
    m = port_model(family)
    return dt.initialize(model=m, config=json.loads(json.dumps(
        {**W1, **stage})), params=params_from_jax(params, m),
        device="cpu")[0]


def w1_routing(eng, batches, rts=False):
    """Each step's loss and grad norm and each MoE layer's routing of its
    last micro batch, at one rank."""
    out = []
    for i in range(STEPS):
        b = {"input_ids": batches[str(i)]}
        if rts:
            b["moe_rng"] = 1000 + i
        m = eng.train_step(b)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "moe": [[c.tolist(), int(k), cap] for c, k, cap
                            in eng.model.moe_stats]})
    return out


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


@pytest.mark.parametrize("name", EVALS)
def test_moe_eval_loss_matches_jax(world, name):
    """``eval_loss`` of a batch after the steps, at gas 2 with drops:
    every rank routes the whole batch at once in the JAX layout ``[gas,
    micro * dp]`` (run 0 of every rank, then run 1: the slot order
    decides which tokens drop), so its loss is the JAX engine's within
    2e-6 on every rank.  Routed in each rank's own order (run 0 and run
    1 of rank 0, then of rank 1, ...) the losses part from JAX's by
    2.3e-5 and 8.4e-6 relative on these batches; in its order by 1.1e-7
    and 0."""
    for res in world.ranks:
        np.testing.assert_allclose(res[name]["eval"], world.evals[name],
                                   rtol=2e-6, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_shards_equal_jax_device_shards(world, name):
    """Rank r's float32 master and moment shards are the JAX state's
    shards on device r, leaf by leaf (stage 0 holds whole leaves, or
    under an expert axis its experts' slices of the expert stacks; the
    fp16 case's are its initial ones, every step skipped)."""
    st = world.engines[name].state
    stage0 = CASES[name][1]["zero_optimization"]["stage"] == 0
    piece = device_piece if stage0 else device_shard
    keep = lambda a: a    # noqa: E731 - the jax.Arrays, with shards
    trees = {"params": flat(st["params"], conv=keep)}
    if name not in CLIENTS:
        # an optax state is not the port's: the client cases hold their
        # masters here and their whole state in the checkpoint test
        trees.update(m=flat(st["opt"]["m"], conv=keep),
                     v=flat(st["opt"]["v"], conv=keep))
    for r, res in enumerate(world.ranks):
        for kind, leaves in trees.items():
            for path, arr in leaves.items():
                got = res["shards"][f"{name}/{kind}/{path}"]
                want = piece(arr, r)
                assert got.shape == want.shape, (name, kind, path)
                np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_lamb_makes_one_leaf_sum_all_reduce_a_step(world, name):
    """LAMB's two whole-leaf sums of every leaf cross in one call of
    ``ZeroPartition.leaf_sums`` a step, which makes one all-reduce over
    the data axes (the only axis group here), on every rank; no other
    optimizer calls it."""
    lamb = name.startswith("lamb")
    for res in world.ranks:
        for row in res[name]["steps"]:
            calls, axes = row["leaf_sums"]
            assert calls == (1 if lamb else 0), name
            assert len(axes) == calls and len(set(axes)) <= 1, axes
    if lamb:
        assert "data" in world.ranks[0][name]["steps"][0]["leaf_sums"][1][0]


@pytest.mark.parametrize("name", MOE_CASES + ["moe_rts"])
def test_moe_routing_equals_one_rank(world, name):
    """Every rank routes the whole global micro batch: each MoE layer's
    ``exp_counts``, kept tokens and capacity, every step, equal one
    rank's over the same global batches; at {expert 4} with RTS and one
    ``moe_rng`` seed a step, also its losses and grad norms (the noise
    is drawn for the whole batch from the micro batch's seed)."""
    want = world.one_rank[name]
    for res in world.ranks:
        got = res[name]["steps"]
        assert [g["moe"] for g in got] == [w["moe"] for w in want]
        if name == "moe_rts":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
                np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                           rtol=1e-5)
    # tokens dropped: the capacity bites (a micro batch routes 8 x 64
    # tokens, k choices each)
    family = RTS[0] if name == "moe_rts" else CASES[name][0]
    k = FAMILIES[family].get("moe_k", 1)
    assert any(kept < GLOBAL // 2 * 64 * k
               for row in want for _, kept, _ in row["moe"])


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith(("ep4", "d2e2"))])
def test_expert_stacks_follow_the_plan(world, name):
    """Each rank's state bytes by kind equal the plan's count, and its
    expert stacks are 1/ep of the whole (and 1/dp of that above stage
    0, ZeRO's data shard of its experts)."""
    mesh = CASES[name][1]["mesh"]
    stage = CASES[name][1]["zero_optimization"]["stage"]
    whole = sum(v.nbytes for k, v in flat(world.moe_init).items()
                if "/experts/" in k)
    cut = mesh["expert"] * (mesh.get("data", 1) if stage else 1)
    for res in world.ranks:
        assert res[name]["bytes"] == res[name]["planned"]
        assert res[name]["expert_bytes"] * cut == whole


def test_expert_checkpoint_resumes_across_world_sizes(world):
    """Saved at {expert 4} (the expert stacks gathered whole), loaded at
    world 1: its next step is the ranks' next step; a world-1 save
    loaded at {expert 4} trains as the world-1 engine does."""
    one = port_w1("moe_drop", world.moe_init, zero(2))
    one.load_checkpoint(os.path.join(world.tmp, "ckpt_ep4"))
    assert int(one.state["step"]) == STEPS
    bs = np.load(os.path.join(world.tmp, "batches_ep4_s2.npz"))
    m = one.train_step({"input_ids": bs[str(STEPS)]})
    cont = world.ranks[0]["resume_ep4"]["cont"][0]
    np.testing.assert_allclose(float(m["loss"]), cont["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), cont["grad_norm"],
                               rtol=1e-5)
    for res in world.ranks:
        for g, w in zip(res["w1_moe_load"], world.w1_moe_ref):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)


def test_client_checkpoint_resumes_across_world_sizes(world):
    """A client AdamW's stage-2 save at world 4 (the torch.optim state's
    moments gathered into the world-1 layout, its step counters kept)
    resumes bit-equal at world 4, and loads at world 1: the next step
    there leaves the params the world-4 run's next step left."""
    for res in world.ranks:
        r = res["resume_client"]
        assert r["leaves_equal"]
        assert r["resumed"] == r["cont"]
    config = {**json.loads(json.dumps(CASES["client_s2"][1])),
              "train_micro_batch_size_per_gpu": 2 * WORLD}
    client = config.pop("client")
    one = dt.initialize(
        model=port_model("gpt2"), config=config, device="cpu",
        optimizer=functools.partial(torch.optim.AdamW, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in client["params"].items()}))[0]
    one.load_checkpoint(os.path.join(world.tmp, "ckpt4_client"))
    leaves = list(tree_leaves(one.state["params"]))
    for i, ent in one.state["opt"]["torch"].items():
        assert ent["exp_avg"].shape == leaves[int(i)].shape
        assert int(ent["step"]) == STEPS
    bs = np.load(os.path.join(world.tmp, "batches_client_s2.npz"))
    m = one.train_step({"input_ids": bs[str(STEPS)]})
    cont = world.ranks[0]["resume_client"]["cont"][0]
    np.testing.assert_allclose(float(m["loss"]), cont["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), cont["grad_norm"],
                               rtol=1e-5)
    want = world.ranks[0]["shards"]
    for path, got in flat(one.state["params"], conv=np.asarray).items():
        np.testing.assert_allclose(got, want[f"client_cont/params/{path}"],
                                   **TOL)


def test_factored_client_state_on_shards_raises(world):
    """torch.optim.Adafactor keeps row and column statistics of a matrix,
    shaped like neither the rank's piece of it nor a scalar: at stage 1
    over 4 ranks its first step raises on every rank, naming the leaf,
    the state entry and the part of queue A that would lift it."""
    for res in world.ranks:
        msg = res["adafactor"]
        assert msg is not None
        assert "queue A item 7 part 4" in msg
        assert "'row_var'" in msg or "'col_var'" in msg
        assert "of leaf " in msg and "/" in msg.split("of leaf ")[1]


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


@pytest.mark.parametrize("axes", [dict(expert=4), dict(data=2, expert=2),
                                  dict(data=2, expert=2, model=2)],
                         ids=["expert4", "data2_expert2", "d2e2m2"])
@pytest.mark.parametrize("stage", [1, 3])
def test_policy_dims_on_expert_cut_leaves_equal_jax(axes, stage):
    """An MoE model's specs (the expert stacks over ``expert``, their FFN
    over ``model``) through the port's policy and the JAX policy at the
    same mesh (``model`` stripped where the mesh has none: at size 1 it
    moves no dim): the same master spec trees at stages 1 and 3, and
    the expert dims the engine cuts (``tp_dims(specs, "expert")``) where
    the JAX specs name ``expert``, on the expert stacks alone (the model
    specs themselves: ``test_torch_tp_training.py``)."""
    from deepspeed_tpu_torch.models.convert import tp_dims
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:n])
    jm = jax_model("moe_drop")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    pm = port_model("moe_drop")
    pspecs = psh._map(lambda _p, sp: tuple(
        None if (e == "model" and "model" not in axes) else e
        for e in sp), pm.partition_specs())
    jspecs = jax.tree_util.tree_map(
        lambda sp: jax.sharding.PartitionSpec(*sp), pspecs,
        is_leaf=lambda x: isinstance(x, tuple))
    jp = jsh.ZeroShardingPolicy(stage, mesh, jspecs, shapes,
                                param_persistence_threshold=0)
    pp = psh.ZeroShardingPolicy(stage, types.SimpleNamespace(
        shape=dict(mesh.shape)), pm.param_shapes(), pspecs,
        param_persistence_threshold=0)
    jflat = flat_specs(jax.tree_util.tree_map(
        tuple, jp.master_param_specs(),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert jflat == flat_specs(pp.master_param_specs())
    edims = flat(tp_dims(pspecs, "expert"), conv=lambda d: d)
    for path, spec in jflat.items():
        names = [set(e if isinstance(e, tuple) else (e,)) for e in spec]
        want = next((d for d, ns in enumerate(names) if "expert" in ns),
                    None)
        assert edims[path] == want, path
        assert (want is not None) == ("/experts/" in "/" + path), path


@pytest.mark.parametrize("axes", [dict(data=2, model=2), dict(pipe=2, data=2),
                                  dict(pipe=2, data=2, model=2)],
                         ids=["data2_model2", "pipe2_data2", "3d"])
def test_stage3_dims_on_model_and_pipe_cut_leaves_equal_jax(axes):
    """Stage 3 over leaves already cut over ``model`` (the TP slice) or
    ``pipe`` (the stage-stacked blocks): from the same spec tree, the
    port's policy adds the data axes where the JAX policy does, never on
    the layer dim, so a layer's gather runs over ``data`` only."""
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelinedLM
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:n])
    model = port_model("gpt2")
    if "pipe" in axes:
        model = PipelinedLM(model, 2)
        model.use_onehot_embed = "model" in axes
    pshapes = model.param_shapes()
    pspecs = psh._map(lambda _p, sp: tuple(
        None if (e == "model" and "model" not in axes) else e
        for e in sp), model.partition_specs())
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    jp = jsh.ZeroShardingPolicy(
        3, mesh, jax.tree_util.tree_map(
            lambda sp: jax.sharding.PartitionSpec(*sp), pspecs,
            is_leaf=is_spec),
        jax.tree_util.tree_map(
            lambda sh: jax.ShapeDtypeStruct(sh, jnp.float32), pshapes,
            is_leaf=is_spec), param_persistence_threshold=0)
    pp = psh.ZeroShardingPolicy(3, types.SimpleNamespace(
        shape=dict(mesh.shape)), pshapes, pspecs,
        param_persistence_threshold=0)
    jflat = flat_specs(jax.tree_util.tree_map(
        tuple, jp.model_param_specs(),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert jflat == flat_specs(pp.model_param_specs())
    lead = 2 if "pipe" in axes else 1
    for path, d in flat(pp.model_param_dims(), conv=lambda d: d).items():
        if path.startswith("blocks/") and d is not None:
            assert d >= lead, path


class _FakeMesh:
    """Axis sizes without processes: rank 0 of every axis."""

    def __init__(self, **axes):
        from deepspeed_tpu_torch.parallel.topology import AXIS_ORDER
        self.shape = {a: axes.get(a, 1) for a in AXIS_ORDER}

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        return 0


#: a factor each axis group's all-reduce multiplies by, so a leaf's sum
#: names the axes it was summed over
_AXIS_FACTOR = {"data": 3.0, "model": 5.0, "pipe": 7.0}


@pytest.mark.parametrize("axes", [dict(data=3), dict(data=2, model=2),
                                  dict(pipe=2, data=3),
                                  dict(pipe=2, data=2, model=2)],
                         ids=["data3", "data2_model2", "pipe2_data3", "3d"])
@pytest.mark.parametrize("stage", [1, 3])
def test_leaf_sums_sum_each_leaf_over_its_cut_axes(monkeypatch, axes,
                                                   stage):
    """``ZeroPartition.leaf_sums`` (and the global norm, which shares its
    classification) sums a leaf's partial sums over exactly the axes the
    JAX policy's master spec cuts it along, from the port's training
    specs: over data where a dim divides (at data 3 only the fused qkv's
    96 columns do: the others count once), over model where Megatron
    cuts it (not the fused qkv, gathered in the step), over the stages
    for ``blocks`` only (the tied embedding and the final norm, which
    both stages hold, count once); one all-reduce an axis group."""
    from deepspeed_tpu_torch import comm as pcomm
    from deepspeed_tpu_torch.models.convert import tp_dims
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelinedLM
    from deepspeed_tpu_torch.runtime.zero.partitioned import ZeroPartition
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:n])
    model = port_model("gpt2")
    if "pipe" in axes:
        model = PipelinedLM(model, 2)
        model.use_onehot_embed = "model" in axes
    shapes = model.param_shapes()
    specs = psh._map(lambda _p, sp: tuple(
        None if (e == "model" and "model" not in axes) else e
        for e in sp), DeepSpeedEngine._tp_train_specs(
            types.SimpleNamespace(model=model), shapes))
    fake = _FakeMesh(**axes)
    z = ZeroPartition(psh.ZeroShardingPolicy(
        stage, fake, shapes, specs, param_persistence_threshold=0), fake,
        tp_dims=tp_dims(specs) if "model" in axes else None)
    calls = []

    def all_reduce(t, op=pcomm.ReduceOp.SUM, axis_name="data"):
        key = "data" if "data" in axis_name else axis_name
        calls.append(key)
        return t * _AXIS_FACTOR[key]
    monkeypatch.setattr(pcomm, "all_reduce", all_reduce)
    got = flat(z.leaf_sums(psh._map(lambda _p, sh: torch.ones(2), shapes)),
               conv=lambda t: float(t[0]))
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    jp = jsh.ZeroShardingPolicy(
        stage, mesh, jax.tree_util.tree_map(
            lambda sp: jax.sharding.PartitionSpec(*sp), specs,
            is_leaf=is_spec),
        jax.tree_util.tree_map(
            lambda sh: jax.ShapeDtypeStruct(sh, jnp.float32), shapes,
            is_leaf=is_spec), param_persistence_threshold=0)
    want_specs = flat_specs(jax.tree_util.tree_map(
        tuple, jp.master_param_specs(),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    groups = set()
    for path, spec in want_specs.items():
        names = set()
        for e in spec:
            names.update(e if isinstance(e, tuple) else (e,))
        cut = [a for a in ("data", "model", "pipe")
               if a in names or (a == "data" and "dcn_data" in names)]
        groups.update(cut)
        assert got[path] == np.prod([_AXIS_FACTOR[a] for a in cut]), path
    assert calls == [a for a in ("data", "model", "pipe") if a in groups]
    if "pipe" in axes:
        assert got["embed/embedding"] % _AXIS_FACTOR["pipe"]
    if axes == dict(data=3):
        assert got["blocks/attn/qkv/kernel"] == _AXIS_FACTOR["data"]
        assert got["ln_f/scale"] == 1.0
    # the global norm: the same classification, one all-reduce a group
    calls.clear()
    grads = psh._map(lambda _p, sh: torch.ones(sh), shapes)
    whole = sum(float(np.prod(sh)) * got[path] for path, sh in
                flat(shapes, conv=lambda x: x).items())
    np.testing.assert_allclose(float(z.global_norm(grads)) ** 2, whole,
                               rtol=1e-6)
    assert calls == [a for a in ("data", "model", "pipe") if a in groups]


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
    ({"mesh": {"sequence": 2}},
     "mesh axis sequence=2: ring and Ulysses sequence parallelism "
     "(queue A item 7 part 6)"),
    ({"sequence_parallel": {"enabled": True}},
     "sequence_parallel: ring and Ulysses sequence parallelism "
     "(queue A item 7 part 6)"),
    ({"optimizer": {"type": "OneBitAdam"}},
     "optimizer OneBitAdam: the 1-bit optimizers (queue A item 7 part 7)"),
    ({"optimizer": {"type": "OneBitLamb"}, "zero_optimization": {
        "stage": 3}, "mesh": {"model": 2}},
     "optimizer OneBitLamb: the 1-bit optimizers (queue A item 7 part 7)"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu"}}, "mesh": {"data": 2}},
     "offload at a data-parallel size of 2: ZeRO-Infinity's dp-sharded "
     "part (queue A item 7 part 8)"),
    # ZeRO-Offload over a pipe or model axis runs at a data-parallel
    # size of 1 (tests/test_torch_pipe_moe.py, test_torch_tp_training.py)
    ({"mesh": {"pipe": 2, "data": 2}, "zero_optimization": {"stage": 1,
      "offload_optimizer": {"device": "cpu"}}},
     "offload at a data-parallel size of 2: ZeRO-Infinity's dp-sharded "
     "part (queue A item 7 part 8)"),
    ({"csv_monitor": {"enabled": True}, "mesh": {"pipe": 2},
      "zero_optimization": {"stage": 3}},
     "tensorboard / wandb / csv_monitor: monitors (queue A item 9's "
     "auxiliary subsystems)"),
    ({"mesh": {"expert": 2, "sequence": 2}},
     "mesh axis sequence=2: ring and Ulysses sequence parallelism "
     "(queue A item 7 part 6)"),
    ({"optimizer": {"type": "ZeroOneAdam"}, "tensor_parallel": {
        "enabled": True, "tp_size": 2}, "zero_optimization": {"stage": 3}},
     "optimizer ZeroOneAdam: the 1-bit optimizers (queue A item 7 part 7)"),
]


@pytest.mark.parametrize("block,message", REFUSED,
                         ids=[m.split(":")[0] for _, m in REFUSED])
def test_config_gate_refusals_word_for_word(block, message):
    with pytest.raises(NotImplementedError) as err:
        dt.initialize(model=port_model("gpt2"),
                      config={"train_batch_size": 4, **block}, device="cpu")
    assert str(err.value) == ("not in the training slice of the PyTorch "
                              f"port: {message} (see ROADMAP.md queue A)")


#: the compositions the gate admits since they came: ZeRO stage 3 over a
#: model axis, a pipe axis or pipeline stages, ZeRO-Offload over a model
#: or pipe axis at a data-parallel size of 1, and the expert axis
ADMITTED = {
    "expert": {"mesh": {"expert": 2}},
    "zero3_model": {"mesh": {"model": 2}, "zero_optimization": {"stage": 3}},
    "zero3_tp": {"tensor_parallel": {"enabled": True, "tp_size": 2},
                 "zero_optimization": {"stage": 3}},
    "zero3_pipe": {"mesh": {"pipe": 2}, "zero_optimization": {"stage": 3}},
    "zero3_stages": {"pipeline": {"stages": 2},
                     "zero_optimization": {"stage": 3}},
    "offload_pipe": {"mesh": {"pipe": 2}, "zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}},
    "offload_model": {"mesh": {"model": 2}, "zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}},
}


@pytest.mark.parametrize("name", list(ADMITTED))
def test_gate_admits_the_3d_compositions(name):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    DeepSpeedConfig({"train_batch_size": 4,
                     **ADMITTED[name]}).refuse_out_of_slice()


@pytest.mark.parametrize("axis", ["model", "pipe"])
def test_infinity_over_model_or_pipe_refuses_with_jax_words(axis):
    """ZeRO-Infinity (``offload_param``) over a model or pipe axis: the
    JAX engine's own refusal, word for word."""
    from deepspeed_tpu.runtime.zero.infinity import InfinityStepper
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = {"train_batch_size": 4, "mesh": {axis: 2}, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}
    jeng = types.SimpleNamespace(mesh=types.SimpleNamespace(
        shape={"model": 1, "pipe": 1, "sequence": 1, axis: 2}))
    with pytest.raises(NotImplementedError) as want:
        InfinityStepper._validate(jeng, jax_model("gpt2"), None)
    with pytest.raises(NotImplementedError) as got:
        DeepSpeedConfig(cfg).refuse_out_of_slice()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_gate_admits_zero_stages_at_world_one(stage):
    """ZeRO stages 1-3 at world 1, through the compat surface too:
    ``forward`` + ``backward`` per micro batch then ``step`` give what
    ``train_step`` gives from the same params and batch."""
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "gradient_clipping": 0.25, **zero(stage)}
    eng = dt.initialize(model=port_model("gpt2"), config=cfg,
                        device="cpu")[0]
    ref = dt.initialize(model=port_model("gpt2"), config=cfg,
                        device="cpu")[0]
    assert eng.zero_stage == stage and eng.dp_world_size == 1
    ids = np.random.RandomState(stage).randint(0, 256, (4, 64))
    losses = []
    for mb in ids.reshape(2, 2, 64):
        losses.append(float(eng.forward({"input_ids": mb})))
        eng.backward()
    assert eng.is_gradient_accumulation_boundary()
    eng.step()
    m = ref.train_step({"input_ids": ids})
    np.testing.assert_allclose(np.mean(losses), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(eng._last_metrics["grad_norm"]),
                               float(m["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(eng.state["params"]),
                    tree_leaves(ref.state["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


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
