"""Tensor-parallel serving: the port's ranks against the JAX package's
serving mesh.

The port runs its ranks as child processes on ``gloo`` on the CPU
(``comm/local_ranks.py``), one world of 2 ranks ({model 2}, and
``generate()`` at ``tensor_parallel.tp_size`` 2) and one of 4 ({data 2,
model 2}), each started once for the module and running every case of
its size in turn; the worker source imports no JAX.  The JAX side runs
in this process on the conftest's 8-device virtual CPU mesh, with its
paged kernels through the package's plain references (interpreted inside
the shard_mapped step they would take minutes to compile), while the
ranks run.

The model is ``test_serving_tp.py``'s tiny f32 GPT-2 (4 layers, d 32, 4
heads, vocab 64) from the JAX init with its kernels scaled by 30 and the
``out``/``fc_in``/``fc_out`` biases drawn non-zero (so the greedy
streams vary, and the row-parallel bias division counts), and a tiny
LLaMA with GQA (8 query heads over 2 kv heads).  Cases:

* {model 2} and {data 2, model 2} at ``kv_cache_bits`` 0 and 8: every
  stream equal to the JAX server's on the same mesh, the first step's
  chunk logits within 1e-5 of the JAX ``forward()``, every rank's
  streams equal, the pool bytes equal to ``kv_block_bytes(model_shards=
  2)``'s count, ``tp_psum_bytes_per_token_layer`` and the mesh gauges
  as the JAX engine has them;
* int8 weights on {data 2, model 2}: the channel-mode leaves and scales
  equal to the JAX engine's (in process), the streams equal to the JAX
  server's; a pool too small for the load on {data 2, model 2}: the
  JAX server's preemptions and streams;
* the spec lane and the fleet refused on a mesh, naming queue A item 7;
* ``generate()`` at ``tp_size`` 2 equal to the JAX engine's at
  ``tp_size`` 2 and to the port's at one rank;
* in process: the validation messages word for word, and
  ``kv_block_bytes`` / ``blocks_for_budget`` with ``model_shards``.
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
import deepspeed_tpu_torch as dt
from deepspeed_tpu.inference.serving import block_allocator as jax_alloc
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import paged_decode_attention as jax_pa
from deepspeed_tpu_torch.comm.local_ranks import run_ranks
from deepspeed_tpu_torch.inference.serving import block_allocator as alloc
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = dict(num_layers=4, d_model=32, num_heads=4, vocab_size=64,
            max_seq_len=64)
LLAMA = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=96, vocab_size=64, max_seq_len=64,
             pos_embedding="rotary", rotary_interleaved=False,
             norm_type="rmsnorm", activation="silu", gated_mlp=True,
             tie_embeddings=False, use_bias=False)
FAMILIES = {"gpt2": GPT2, "llama": LLAMA}
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
           "max_batch_slots": 8, "prefill_chunk_tokens": 16}
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0,
        "replace_with_kernel_inject": False}
NEW = 8


def serving(mesh, **kw):
    return {**BASE, "serving": {**SERVING, "mesh": mesh, **kw}}


#: name → (world, family, inference config); the JAX reference of a
#: serving case is its own config on the JAX package
CASES = {
    "m2": (2, "gpt2", serving({"model": 2})),
    "m2_kv8": (2, "gpt2", serving({"model": 2}, kv_cache_bits=8)),
    "m2_llama": (2, "llama", serving({"model": 2})),
    "gen_tp2": (2, "gpt2", {**BASE, "tensor_parallel": {"tp_size": 2}}),
    "d2m2": (4, "gpt2", serving({"data": 2, "model": 2})),
    "d2m2_kv8": (4, "gpt2", serving({"data": 2, "model": 2},
                                    kv_cache_bits=8)),
    "d2m2_int8": (4, "gpt2", {**serving({"data": 2, "model": 2}),
                              "quant": {"enabled": True, "bits": 8}}),
    # a pool too small for the load: recompute preemption while the
    # slots are data-sharded (8 usable blocks of 8 tokens; four prompts
    # admit at 7 blocks and need 13 once grown by 12 tokens)
    "d2m2_preempt": (4, "gpt2", serving({"data": 2, "model": 2},
                                        num_kv_blocks=9)),
}
#: the preemption case's prompts (seed, lengths) and new tokens
PREEMPT = (5, (9, 13, 11, 7), 12)


def prompts(name=""):
    seed, lens = (PREEMPT[:2] if name.endswith("_preempt")
                  else (11, (5, 9, 12, 16, 3, 7)))
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 64, (n,)).tolist() for n in lens]


def new_tokens(name=""):
    return PREEMPT[2] if name.endswith("_preempt") else NEW


def jax_params(family):
    """The JAX init with kernels x 30 and non-zero out/fc biases (the
    qkv bias stays 0: the JAX engine's TP prep permutes an int8 qkv
    bias but not its channel scale)."""
    kw = FAMILIES[family]
    cfg = (jax_tf.gpt2_config("125m", dtype=jnp.float32, **kw)
           if family == "gpt2" else
           jax_tf.TransformerConfig(dtype=jnp.float32, **kw))
    tree = jax.device_get(jax_tf.TransformerLM(cfg).init(
        jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)

    def amp(node, parent=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = amp(v, k)
            elif k == "kernel":
                out[k] = np.asarray(v) * 30.0
            elif k == "bias" and parent in ("out", "fc_in", "fc_out"):
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return amp(tree)


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
from deepspeed_tpu_torch.observability import get_registry
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime.config import MeshConfig

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

def model(family):
    kw = spec["families"][family]
    cfg = (tt.gpt2_config("125m", dtype=torch.float32, **kw)
           if family == "gpt2"
           else tt.TransformerConfig(dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)

out = {}
for name, (w, family, config) in spec["cases"].items():
    if w != world:
        continue
    prompts, new = spec["prompts"][name], spec["new"][name]
    m = model(family)
    tree = unflat(np.load(os.path.join(d, f"params_{family}.npz")))
    # one case hands init_inference its mesh instead of building it
    mesh = (build_mesh(MeshConfig(data=2, model=2)) if name == "d2m2_kv8"
            else None)
    eng = dt.init_inference(m, config, params=params_from_jax(tree, m),
                            device="cpu", mesh=mesh)
    if "tensor_parallel" in config:
        out[name] = {"gen": [eng.generate(np.asarray(p)[None],
                                          max_new_tokens=new).tolist()[0]
                             for p in prompts]}
        continue
    srv = eng.serving_engine()
    first, kv_heads = [], []
    mixed = srv.model._apply_paged_mixed

    def record(*a, **k):
        r = mixed(*a, **k)
        kv_heads.append(int(a[1]["k"].shape[3]))
        if not first:
            first.append(r[1].tolist())
        return r
    srv.model._apply_paged_mixed = record
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=new) for p in prompts[3:]]
    srv.run(max_steps=400)
    reg = get_registry()
    out[name] = {"streams": [r.output for r in reqs], "first": first[0],
                 "status": [r.status.value for r in reqs],
                 "pool": srv.kv_pool_bytes,
                 "psum": srv.tp_psum_bytes_per_token_layer,
                 "kv_heads": sorted(set(kv_heads)),
                 "gauges": [reg.gauge("dstpu_mesh_data_size").value,
                            reg.gauge("dstpu_mesh_model_size").value,
                            reg.gauge("dstpu_serving_kv_pool_bytes").value],
                 "qmode": eng._qmode, "used": srv.allocator.num_used,
                 "preemptions": srv.counts["preemptions"]}
if world == 2:
    # the paths a mesh refuses, naming their part of queue A item 7
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    m = model("gpt2")
    tree = unflat(np.load(os.path.join(d, "params_gpt2.npz")))
    eng = dt.init_inference(m, spec["cases"]["m2"][2],
                            params=params_from_jax(tree, m), device="cpu")
    out["refused"] = []
    for kw in ({"draft_model": m}, {"role": "prefill"}):
        try:
            ServingEngine(eng, **kw)
        except NotImplementedError as e:
            out["refused"].append(str(e))
out["jax_loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "deepspeed_tpu"))
json.dump(out, open(os.path.join(d, f"w{world}_rank{rank}.json"), "w"))
comm.destroy_process_group()
'''


def jax_reference(monkeypatch):
    monkeypatch.setattr(
        jax_pa, "paged_decode_attention",
        lambda q, pk, pv, lens, tables, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_attention_reference(
            q, pk, pv, lens, tables, k_scale, v_scale, kv_bits))
    monkeypatch.setattr(
        jax_pa, "paged_prefill_attention",
        lambda q, pk, pv, base, n, table, sm_scale=None, k_scale=None,
        v_scale=None, kv_bits=0, **_: jax_pa.paged_prefill_reference(
            q, pk, pv, base, n, table, k_scale, v_scale, kv_bits))


def jax_engine(family, config, params):
    return ds.init_inference(jax_model(family), params=params,
                             config=json.loads(json.dumps(config)))


def jax_run(name, family, config, params):
    """The JAX package's streams for one case (the first step's logits
    from its ``forward()`` of prompt 0)."""
    eng = jax_engine(family, config, params)
    ps, new = prompts(name), new_tokens(name)
    if "tensor_parallel" in config:
        return {"gen": [np.asarray(eng.generate(
            np.asarray(p, np.int32)[None], max_new_tokens=new))[0].tolist()
            for p in ps]}
    srv = eng.serving_engine()
    reqs = [srv.submit(p, max_new_tokens=new) for p in ps[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=new) for p in ps[3:]]
    srv.run(max_steps=400)
    first = np.asarray(eng.forward(np.asarray(ps[0], np.int32)[None]))
    return {"streams": [r.output for r in reqs], "first": first[0, -1],
            "pool": srv.kv_pool_bytes,
            "psum": srv.tp_psum_bytes_per_token_layer,
            "qmode": getattr(eng, "_qmode", None),
            "preemptions": srv.scheduler.preemption_count}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_serving"))
    params = {f: jax_params(f) for f in FAMILIES}
    for f, tree in params.items():
        np.savez(os.path.join(tmp, f"params_{f}.npz"), **flat(tree))
    with open(os.path.join(tmp, "cases.json"), "w") as fh:
        json.dump({"cases": CASES, "families": FAMILIES,
                   "prompts": {n: prompts(n) for n in CASES},
                   "new": {n: new_tokens(n) for n in CASES}}, fh)
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
    jax_runs = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_reference(mp)
        for name, (_, family, config) in CASES.items():
            jax_runs[name] = jax_run(name, family, config, params[family])
        # the port at one rank, for generate() at tp_size 2
        pm = port_model("gpt2")
        one = dt.init_inference(pm, BASE, params=params_from_jax(
            params["gpt2"], pm), device="cpu")
        jax_runs["gen_tp1_port"] = {"gen": [one.generate(
            np.asarray(p)[None], max_new_tokens=NEW).tolist()[0]
            for p in prompts()]}
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "the ranks outlived their deadline"
    for n, e in box.items():
        raise e
    ranks_out = {}
    for n in (2, 4):
        ranks_out[n] = []
        for r in range(n):
            with open(os.path.join(tmp, f"w{n}_rank{r}.json")) as fh:
                ranks_out[n].append(json.load(fh))
    return types.SimpleNamespace(jax=jax_runs, ranks=ranks_out,
                                 params=params)


def test_workers_import_no_jax(world):
    for n in (2, 4):
        for res in world.ranks[n]:
            assert res["jax_loaded"] == []


SERVED = [n for n, c in CASES.items() if "tensor_parallel" not in c[2]]


@pytest.mark.parametrize("name", SERVED)
def test_streams_equal_jax_server_on_every_rank(world, name):
    """Every rank's greedy streams are the JAX server's on the same mesh,
    token for token, and every rank's are the same."""
    n = CASES[name][0]
    want = world.jax[name]["streams"]
    for res in world.ranks[n]:
        got = res[name]
        assert got["status"] == ["ok"] * len(want)
        assert got["streams"] == want, name
        assert got["used"] == 0
    assert len({json.dumps(r[name]["streams"]) for r in world.ranks[n]}) == 1


def test_mesh_refuses_spec_lane_host_tier_and_fleet(world):
    for res in world.ranks[2]:
        assert res["refused"] == [
            f"{what} on a serving mesh beyond 1x1 (data=1, model=2): not "
            f"in the PyTorch port yet (ROADMAP.md queue A item 7)"
            for what in ("the speculative lane", "the fleet")]


def test_preemption_on_a_data_sharded_mesh(world):
    """The small pool forces recompute preemptions, the same number on
    every rank as in the JAX server, and the streams stay exact (the
    streams test above)."""
    want = world.jax["d2m2_preempt"]["preemptions"]
    assert want > 0
    for res in world.ranks[4]:
        assert res["d2m2_preempt"]["preemptions"] == want


def test_streams_are_not_degenerate(world):
    """The weights give streams that change token (so an off-by-one in
    the vocab gather or a shard's heads would show)."""
    streams = world.jax["d2m2"]["streams"]
    assert sum(len(set(s)) > 2 for s in streams) >= 3


@pytest.mark.parametrize("name", [n for n in SERVED if "kv_cache_bits"
                                  not in CASES[n][2]["serving"]])
def test_first_step_logits_match_jax(world, name):
    """The first dispatch's chunk logits (prompt 0 whole in one chunk)
    on every rank are the JAX ``forward()``'s at its last position (an
    unquantized pool: an int8 pool's chunk attends quantized rows)."""
    want = world.jax[name]["first"]
    for res in world.ranks[CASES[name][0]]:
        np.testing.assert_allclose(np.asarray(res[name]["first"]), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", SERVED)
def test_pool_bytes_psum_and_gauges(world, name):
    """Each rank's pool holds ``kv_heads / model`` heads of every block:
    its bytes are ``kv_block_bytes(model_shards=model)`` x blocks x
    layers, the JAX engine's per-chip count; the all-reduce payload per
    token and layer and the mesh gauges as the JAX engine has them."""
    n, family, config = CASES[name]
    mesh = config["serving"]["mesh"]
    mp, dp = mesh["model"], mesh.get("data", 1)
    kw = FAMILIES[family]
    kv = kw.get("num_kv_heads") or kw["num_heads"]
    hd = kw["d_model"] // kw["num_heads"]
    bits = config["serving"].get("kv_cache_bits", 0)
    per_block = alloc.kv_block_bytes(8, kv, hd, bits, cache_itemsize=4,
                                     model_shards=mp)
    want_pool = (per_block * config["serving"]["num_kv_blocks"]
                 * kw["num_layers"])
    assert world.jax[name]["pool"] == want_pool
    assert world.jax[name]["psum"] == kw["d_model"] * 4 * 2
    for res in world.ranks[n]:
        got = res[name]
        assert got["pool"] == want_pool
        assert got["psum"] == world.jax[name]["psum"]
        assert got["gauges"] == [dp, mp, want_pool]
        assert got["kv_heads"] == [kv // mp]


def test_int8_channel_mode_on_every_rank(world):
    for res in world.ranks[4]:
        assert res["d2m2_int8"]["qmode"] == "channel"
    assert world.jax["d2m2_int8"]["qmode"] == "channel"


def test_int8_channel_leaves_and_scales_equal_jax(world):
    """The channel-mode int8 leaves and their scales, whole, equal the
    JAX engine's (the quantization a TP engine runs before it cuts its
    slice)."""
    params = world.params["gpt2"]
    cfg = {**serving({"data": 2, "model": 2}),
           "quant": {"enabled": True, "bits": 8}}
    je = jax_engine("gpt2", cfg, params)
    assert je._qmode == "channel"
    pm = port_model("gpt2")
    pe = dt.init_inference(pm, {**BASE, "quant": {"enabled": False}},
                           params=params_from_jax(params, pm), device="cpu")
    pe.config.quant.enabled = True
    pe._qmode = "channel"
    pe._quantize_weights()
    jq = flat(jax.device_get(je.params))
    js = flat(jax.device_get(je._scales))
    pq = flat(_np(pe.params))
    ps = flat(_np(pe._scales))
    assert set(pq) == set(jq)
    for k in jq:
        np.testing.assert_array_equal(pq[k], jq[k], err_msg=k)
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def test_generate_at_tp2_equals_jax_and_one_rank(world):
    want = world.jax["gen_tp2"]["gen"]
    assert world.jax["gen_tp1_port"]["gen"] == want
    for res in world.ranks[2]:
        assert res["gen_tp2"]["gen"] == want


# -- in process ---------------------------------------------------------------
def test_validation_messages_word_for_word():
    """The JAX engine's checks, in its order: the model axis must divide
    the heads, MLP columns and vocab, then the world must hold the mesh
    (the port's world here is one process; the JAX one 8 devices)."""
    params = jax_params("gpt2")
    cfg = serving({"data": 1, "model": 8})
    with pytest.raises(ValueError) as jerr:
        jax_engine("gpt2", cfg, params).serving_engine()
    pm = port_model("gpt2")
    with pytest.raises(ValueError) as perr:
        dt.init_inference(pm, cfg, params=params_from_jax(params, pm),
                          device="cpu")
    assert str(perr.value) == str(jerr.value) == (
        "serving.mesh.model (8) must divide kv_heads (4) — heads/MLP "
        "columns/vocab partition evenly over the model axis")
    cfg = serving({"data": 4, "model": 4}, max_batch_slots=8)
    with pytest.raises(ValueError) as jerr:
        jax_engine("gpt2", cfg, params).serving_engine()
    with pytest.raises(ValueError) as perr:
        dt.init_inference(pm, cfg, params=params_from_jax(params, pm),
                          device="cpu")
    assert str(jerr.value) == ("serving.mesh (data=4, model=4) needs 16 "
                               "devices, have 8")
    assert str(perr.value) == ("serving.mesh (data=4, model=4) needs 16 "
                               "devices, have 1")
    # no rank quietly serves a smaller mesh: two ranks asked, one present
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        dt.init_inference(pm, serving({"model": 2}),
                          params=params_from_jax(params, pm), device="cpu")
    with pytest.raises(ValueError,
                       match="tp_size 2 x ep_size 1 does not divide 1"):
        dt.init_inference(pm, {**BASE, "tensor_parallel": {"tp_size": 2}},
                          params=params_from_jax(params, pm), device="cpu")


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_sharded_capacity_planning_equals_jax(bits):
    for mp in (1, 2, 4):
        assert alloc.kv_block_bytes(8, 4, 32, bits, model_shards=mp) == \
            jax_alloc.kv_block_bytes(8, 4, 32, bits, model_shards=mp) == \
            alloc.kv_block_bytes(8, 4, 32, bits) // mp
    budget = 24 * alloc.kv_block_bytes(4, 4, 32, bits)
    assert alloc.blocks_for_budget(budget, 4, 4, 32, bits,
                                   model_shards=2) == \
        jax_alloc.blocks_for_budget(budget, 4, 4, 32, bits,
                                    model_shards=2) == 48
    for bad in (3, 0):
        with pytest.raises(ValueError, match="model_shards"):
            alloc.kv_block_bytes(8, 4, 32, bits, model_shards=bad)
