"""Tensor-parallel serving: the port's ranks against the JAX package's
serving mesh.

The port runs its ranks as child processes on ``gloo`` on the CPU
(``comm/local_ranks.py``), one world of 2 ranks ({model 2}, and
``generate()`` / ``forward()`` at ``tensor_parallel.tp_size`` 2) and one
of 4 ({data 2, model 2}), each started once for the module and running
every case of its size in turn; the worker source imports no JAX.  The
JAX side runs in this process on the conftest's 8-device virtual CPU
mesh, with its paged kernels through the package's plain references
(interpreted inside the shard_mapped step they would take minutes to
compile), while the ranks run.

The model is ``test_serving_tp.py``'s tiny f32 GPT-2 (4 layers, d 32, 4
heads, vocab 64) from the JAX init with its kernels scaled by 30 and the
``out``/``fc_in``/``fc_out`` biases drawn non-zero (so the greedy
streams vary, and the row-parallel bias division counts), a tiny LLaMA
with GQA (8 query heads over 2 kv heads), a 1-layer draft (the GPT-2's
first layer) and a tiny BERT (post-norm encoder, MLM head, tied
embeddings).  Cases:

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
* the speculative lane (the 1-layer draft, ``spec_k`` 2) on {model 2}
  and {data 2, model 2}, also at ``kv_cache_bits`` 8: the JAX spec
  server's streams and ``spec_counts``;
* the host tier on {data 2, model 2}: a small pool that spills, then a
  prefix hit that promotes: the JAX server's streams, spills, DRAM hits
  and promoted blocks, each rank's host bytes 1/2 of the JAX engine's;
  and a fatal ``serving.spill`` fault planted on rank 1 alone (at the
  first prompt's last block), which every rank degrades alike (the JAX
  server's counts under the same fault);
* ``FleetRouter.from_engine`` on {model 2} (2 replicas) and
  disaggregated on {data 2, model 2} (1 prefill + 1 decode): each
  request's stream once, its placements, the handoffs and the fabric
  counts of the JAX fleet; and with each replica on its own thread on
  {data 2, model 2}: each stream once, equal to the JAX fleet's, the
  same placements on every rank, then the autoscaler draining and
  retiring one replica alike on every rank;
* a request whose deadline expires mid-stream while rank 1's serving
  clock runs ahead of the others', also under the multi-tenant front end
  whose TTFT-at-risk boosts read that clock: every rank times it out at
  the same iteration and boosts the same requests (rank 0 decides), and
  every rank's statuses, streams and first-token steps are equal;
* BERT's ``forward()`` at ``tp_size`` 2 (the MLM head's vocab bias cut
  beside the vocab-sharded decoder): within 1e-5 of the JAX engine's
  at ``tp_size`` 2 and at one device;
* a tiny MoE (``tests/unit/test_moe.py``'s serving shapes: 2 layers, d
  32, 4 experts on every other layer, top-1) at ``moe.ep_size`` 2 (each
  rank E / 2 experts, the partial combine summed over ``expert``) and at
  ``tp_size`` 2 (each expert's FFN cut over ``model``): ``generate()``'s
  greedy tokens equal the JAX engine's at the same config, and
  ``forward()``'s logits within 1e-5, on both ranks;
* ``generate()`` at ``tp_size`` 2 equal to the JAX engine's at
  ``tp_size`` 2 and to the port's at one rank;
* in process: the validation messages word for word,
  ``kv_block_bytes`` / ``blocks_for_budget`` with ``model_shards``, and
  a one-rank server that broadcasts nothing.
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
from deepspeed_tpu.inference.serving import FleetRouter as JaxFleetRouter
from deepspeed_tpu.inference.serving import block_allocator as jax_alloc
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import paged_decode_attention as jax_pa
from deepspeed_tpu.runtime.resilience import \
    FaultInjector as JaxFaultInjector
from deepspeed_tpu.runtime.resilience import \
    install_fault_injector as jax_install
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
#: the draft: the target's first layer alone (its weights too)
DRAFT = dict(GPT2, num_layers=1)
MOE = dict(num_layers=2, d_model=32, num_heads=4, vocab_size=64,
           max_seq_len=64, loss_chunk=0, moe_num_experts=4, moe_freq=2,
           moe_k=1, moe_use_rts=False)
BERT = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=64,
            max_seq_len=64, causal=False, norm_position="post",
            final_layernorm=False, embed_layernorm=True, mlm_head=True,
            activation="gelu_exact", d_ff=96, token_type_vocab=2)
FAMILIES = {"gpt2": GPT2, "llama": LLAMA, "draft": DRAFT, "bert": BERT,
            "moe": MOE}
#: the families built by ``gpt2_config`` (the others by
#: ``TransformerConfig``)
GPT2_LIKE = ("gpt2", "draft", "moe")
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 48,
           "max_batch_slots": 8, "prefill_chunk_tokens": 16}
BASE = {"dtype": "float32", "max_out_tokens": 64, "temperature": 0.0,
        "replace_with_kernel_inject": False}
NEW = 8
HOST = {"enabled": True, "dram_budget_bytes": 1 << 20}
D2M2 = {"data": 2, "model": 2}


def serving(mesh, **kw):
    return {**BASE, "serving": {**SERVING, "mesh": mesh, **kw}}


#: name → (world, family, inference config, kind); the JAX reference of
#: a case is its own config on the JAX package.  Kinds: "serve" (the
#: staggered drain), "gen" (``generate()``), "spec" (the drain with the
#: draft), "host" (spill, then a promoted hit), "fleet"
#: (``FleetRouter.from_engine``), "bert" (``forward()``), "moe"
#: (``generate()`` and ``forward()``), "skew" (a deadline under a skewed
#: clock, port only)
CASES = {
    "m2": (2, "gpt2", serving({"model": 2}), "serve"),
    "m2_kv8": (2, "gpt2", serving({"model": 2}, kv_cache_bits=8), "serve"),
    "m2_llama": (2, "llama", serving({"model": 2}), "serve"),
    "gen_tp2": (2, "gpt2", {**BASE, "tensor_parallel": {"tp_size": 2}},
                "gen"),
    "d2m2": (4, "gpt2", serving(D2M2), "serve"),
    "d2m2_kv8": (4, "gpt2", serving(D2M2, kv_cache_bits=8), "serve"),
    "d2m2_int8": (4, "gpt2", {**serving(D2M2),
                              "quant": {"enabled": True, "bits": 8}},
                  "serve"),
    # a pool too small for the load: recompute preemption while the
    # slots are data-sharded (8 usable blocks of 8 tokens; four prompts
    # admit at 7 blocks and need 13 once grown by 12 tokens)
    "d2m2_preempt": (4, "gpt2", serving(D2M2, num_kv_blocks=9), "serve"),
    "m2_spec": (2, "gpt2", serving({"model": 2}, spec_k=2), "spec"),
    "d2m2_spec": (4, "gpt2", serving(D2M2, spec_k=2), "spec"),
    "d2m2_spec_kv8": (4, "gpt2", serving(D2M2, spec_k=2, kv_cache_bits=8),
                      "spec"),
    # 11 usable blocks: the flood evicts the first prompt's cached chain
    # into the host tier, the resubmission promotes it back
    "d2m2_host": (4, "gpt2", serving(D2M2, num_kv_blocks=12,
                                     kv_cache_bits=8, host_cache=HOST),
                  "host"),
    # the same with the first spill failing fatally on rank 1 alone
    "d2m2_host_fault": (4, "gpt2", serving(D2M2, num_kv_blocks=12,
                                           kv_cache_bits=8,
                                           host_cache=HOST), "host"),
    "m2_fleet": (2, "gpt2", serving({"model": 2}, fleet={
        "enabled": True, "replicas": 2}), "fleet"),
    "d2m2_disagg": (4, "gpt2", serving(D2M2, host_cache=HOST, fleet={
        "enabled": True, "replicas": 2, "prefill_replicas": 1}), "fleet"),
    # each replica on its own thread, then the autoscaler drains one
    "d2m2_fleet_threaded": (4, "gpt2", serving(D2M2, fleet={
        "enabled": True, "replicas": 2}), "fleet"),
    "m2_bert": (2, "bert", {**BASE, "tensor_parallel": {"tp_size": 2}},
                "bert"),
    "moe_ep2": (2, "moe", {**BASE, "moe": {"enabled": True, "ep_size": 2}},
                "moe"),
    "moe_tp2": (2, "moe", {**BASE, "moe": {"enabled": True},
                           "tensor_parallel": {"tp_size": 2}}, "moe"),
    # int8 weights at ep_size 2: every rank keeps the whole int8 stacks
    "moe_ep2_int8": (2, "moe", {**BASE, "moe": {"enabled": True,
                                                "ep_size": 2},
                                "quant": {"enabled": True, "bits": 8}},
                     "moe"),
    "d2m2_skew": (4, "gpt2", serving(D2M2), "skew"),
    # the same clocks under the multi-tenant front end, with 4 slots for
    # 7 requests, so its at-risk boosts order the waiting queue
    "d2m2_skew_front": (4, "gpt2", serving(D2M2, max_batch_slots=4),
                        "skew"),
}
#: the preemption case's prompts (seed, lengths) and new tokens
PREEMPT = (5, (9, 13, 11, 7), 12)
#: the fleet cases' prompts: most hold full blocks to hand over
FLEET_LENS = (17, 9, 25, 12, 30, 20)
#: the skew case: the deadline request (prompt length, new tokens,
#: deadline in seconds), the serving clock's advance each step and rank
#: 1's lead over it; rank 0 times the request out at step 11 (of its
#: ~40), rank 1 alone would at step 6
SKEW = (8, 40, 0.105, 0.01, 0.05)


def prompts(name=""):
    seed, lens = (PREEMPT[:2] if name.endswith("_preempt")
                  else (13, FLEET_LENS)
                  if name in CASES and CASES[name][3] == "fleet"
                  else (11, (5, 9, 12, 16, 3, 7)))
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 64, (n,)).tolist() for n in lens]


def new_tokens(name=""):
    return PREEMPT[2] if name.endswith("_preempt") else NEW


#: the spill that fails in the host fault case (the first prompt's chain
#: spills first, so the fourth is its last block: the three before it
#: still promote)
FAULT_AT = 4


def spill_prompts():
    """The host cases' prompt, then the six that flood the pool."""
    rs = np.random.RandomState(0)
    return ([rs.randint(0, 64, (28,)).tolist()]
            + [rs.randint(0, 64, (30,)).tolist() for _ in range(6)])


def jax_params(family):
    """The JAX init with kernels x 30 and non-zero out/fc biases and MLM
    vocab bias (the qkv bias stays 0: the JAX engine's TP prep permutes
    an int8 qkv bias but not its channel scale).  The draft's are the
    target's with the first layer alone."""
    if family == "draft":
        tree = jax_params("gpt2")
        tree["blocks"] = jax.tree_util.tree_map(lambda a: a[:1],
                                                tree["blocks"])
        return tree
    tree = jax.device_get(jax_model(family).init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)

    def amp(node, parent=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = amp(v, k)
            elif k == "kernel":
                out[k] = np.asarray(v) * 30.0
            elif k == "bias" and parent in ("out", "fc_in", "fc_out",
                                            "mlm_head"):
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return amp(tree)


def jax_model(family):
    kw = FAMILIES[family]
    cfg = (jax_tf.gpt2_config("125m", dtype=jnp.float32, **kw)
           if family in GPT2_LIKE else
           jax_tf.TransformerConfig(dtype=jnp.float32, **kw))
    return jax_tf.TransformerLM(cfg)


def port_model(family):
    kw = FAMILIES[family]
    cfg = (tt.gpt2_config("125m", dtype=torch.float32, **kw)
           if family in GPT2_LIKE else
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
import json, os, sys, time, types
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.serving import (FleetAutoscaler,
                                                   FleetRouter,
                                                   ServingFrontend,
                                                   TenantSpec)
from deepspeed_tpu_torch.inference.serving import engine as engine_mod
from deepspeed_tpu_torch.inference.serving import scheduler as sched_mod
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.observability import get_registry
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime.config import MeshConfig
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    install_fault_injector)

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
           if family in spec["gpt2_like"]
           else tt.TransformerConfig(dtype=torch.float32, **kw))
    return tt.TransformerLM(cfg)

def weights(family, m):
    tree = unflat(np.load(os.path.join(d, f"params_{family}.npz")))
    return params_from_jax(tree, m)

def engine(name, family, config):
    m = model(family)
    # one case hands init_inference its mesh instead of building it
    mesh = (build_mesh(MeshConfig(data=2, model=2)) if name == "d2m2_kv8"
            else None)
    return dt.init_inference(m, config, params=weights(family, m),
                             device="cpu", mesh=mesh)

def drain(srv, prompts, new):
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=new) for p in prompts[3:]]
    srv.run(max_steps=400)
    return reqs

def served(eng, prompts, new):
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
    reqs = drain(srv, prompts, new)
    reg = get_registry()
    return {"streams": [r.output for r in reqs], "first": first[0],
            "status": [r.status.value for r in reqs],
            "pool": srv.kv_pool_bytes,
            "psum": srv.tp_psum_bytes_per_token_layer,
            "kv_heads": sorted(set(kv_heads)),
            "gauges": [reg.gauge("dstpu_mesh_data_size").value,
                       reg.gauge("dstpu_mesh_model_size").value,
                       reg.gauge("dstpu_serving_kv_pool_bytes").value],
            "qmode": eng._qmode, "used": srv.allocator.num_used,
            "preemptions": srv.counts["preemptions"],
            "decisions": srv.lockstep.broadcasts}

def speculated(eng, prompts, new):
    dm = model("draft")
    srv = eng.serving_engine(draft_model=dm,
                             draft_params=weights("draft", dm))
    reqs = drain(srv, prompts, new)
    return {"streams": [r.output for r in reqs],
            "status": [r.status.value for r in reqs],
            "spec": dict(srv.spec_counts), "used": srv.allocator.num_used}

def hosted(name, eng):
    if name.endswith("_fault") and rank == 1:
        fi = FaultInjector()
        fi.add_plan("serving.spill", "fatal", at=spec["fault_at"], count=1)
        install_fault_injector(fi)
    srv = eng.serving_engine()
    first, *flood = spec["spill"]
    r1 = srv.submit(first, max_new_tokens=6)
    srv.run()
    for p in flood:
        srv.submit(p, max_new_tokens=4)
    srv.run()
    r2 = srv.submit(first, max_new_tokens=6)
    srv.run()
    install_fault_injector(FaultInjector())
    hc = srv.host_cache
    srv.allocator.assert_consistent()
    return {"streams": [r1.output, r2.output],
            "status": [r1.status.value, r2.status.value],
            "stats": dict(srv.host_counts, spills=hc.spills_total,
                          hits=dict(hc.hits_total),
                          host_hit_tokens=srv.allocator
                          .host_hit_tokens_total),
            "host_bytes": hc.resident_bytes("dram"),
            "gauge": get_registry().gauge(
                "dstpu_serving_host_dram_bytes").value,
            "used": srv.allocator.num_used}

def fleet_run(name, eng, prompts, new):
    fleet = FleetRouter.from_engine(eng, seed=0)
    threaded = name.endswith("_threaded")
    if threaded:
        for r in fleet.replicas:
            r.start()
    freqs = [fleet.submit(p, max_new_tokens=new) for p in prompts]
    if threaded:
        while fleet.pump():
            time.sleep(0.002)
        for r in fleet.replicas:
            r.stop(timeout_s=60)
    else:
        fleet.run()
    scaled = []
    if threaded:
        # the fleet idle and quiet: one tick drains a replica, the next
        # retires it
        scaler = FleetAutoscaler(fleet, spawn_fn=None, quiet_s=0.0,
                                 scale_down_cooldown_s=0.0)
        for _ in range(2):
            scaled += [[e["action"], e["replica"]] for e in scaler.tick()]
        scaled.append([r.state.value for r in fleet.replicas])
    return {"streams": [f.output for f in freqs], "scaled": scaled,
            "status": [f.status.value for f in freqs],
            "placed": [[f.prefill_replica_id,
                        f.replica.replica_id if f.replica else None]
                       for f in freqs],
            "fleet": dict(fleet.fleet_counts),
            "fabric": {r.replica_id: dict(r.srv.fabric_counts)
                       for r in fleet.replicas},
            "used": [r.srv.allocator.num_used for r in fleet.replicas]}

def skewed(name, eng, prompts, new):
    # the serving modules' clock advances a fixed step each iteration;
    # rank 1's runs ahead of the others'
    plen, pnew, deadline, tick, lead = spec["skew"]
    real = time.perf_counter
    base, steps = [real()], [0]

    class Clock:
        def __getattr__(self, n):
            return getattr(time, n)

        def perf_counter(self):
            return base[0] + tick * steps[0] + (lead if rank == 1 else 0.0)
    for mod in (engine_mod, sched_mod):
        mod.time = Clock()
    try:
        srv = eng.serving_engine()
        step = srv.step

        def counted():
            steps[0] += 1
            return step()
        srv.step = counted
        submit, late = srv.submit, []
        if name.endswith("_front"):
            # an interactive tenant whose TTFT target its requests outlive
            # while they wait: rank 0's clock says which are late
            fe = ServingFrontend(srv, slo=None)
            fe.register(TenantSpec("interactive", weight=4.0,
                                   ttft_slo_s=3 * tick))
            fe.register(TenantSpec("batch"))
            apply = fe._apply

            def applying(decision, live):
                late.append(len(decision["late"]))
                apply(decision, live)
            srv.lockstep_hooks["frontend"] = (fe._propose, applying)

            def submit(p, i=[0], **kw):
                i[0] += 1
                return fe.submit(p, tenant=("interactive", "batch")[
                    i[0] % 2], **kw)
        firsts = {}

        def first(ev):
            firsts.setdefault(id(ev.request), steps[0])
        long = np.random.RandomState(3).randint(0, 64, (plen,)).tolist()
        # a request's submit time is the real clock's (the scheduler's
        # default factory holds the real function): the serving clock
        # starts from it, so building the server under a loaded host
        # does not move the deadline's step
        base[0] = real()
        reqs = [submit(long, max_new_tokens=pnew, deadline_s=deadline,
                       on_token=first)]
        reqs += [submit(p, max_new_tokens=new, on_token=first)
                 for p in prompts]
        srv.run(max_steps=400)
    finally:
        for mod in (engine_mod, sched_mod):
            mod.time = time
    return {"streams": [r.output for r in reqs],
            "status": [r.status.value for r in reqs],
            "first_step": [firsts.get(id(r)) for r in reqs],
            "late": max(late, default=0), "used": srv.allocator.num_used}

out = {}
for name, (w, family, config, kind) in spec["cases"].items():
    if w != world:
        continue
    prompts, new = spec["prompts"][name], spec["new"][name]
    try:
        eng = engine(name, family, config)
        if kind == "gen":
            out[name] = {"gen": [eng.generate(
                np.asarray(p)[None], max_new_tokens=new).tolist()[0]
                for p in prompts]}
        elif kind == "bert":
            ids = np.asarray(spec["bert_ids"])
            out[name] = {"logits": eng.forward(ids).tolist()}
        elif kind == "moe":
            ids = np.asarray(spec["bert_ids"])
            out[name] = {"gen": [eng.generate(
                np.asarray(p)[None], max_new_tokens=new).tolist()[0]
                for p in prompts], "logits": eng.forward(ids).tolist(),
                "experts": None if eng._quantized else int(
                    eng.params["blocks"]["moe_blk"]["moe"]["experts"][
                        "fc_in"]["kernel"].shape[1])}
        elif kind == "serve":
            out[name] = served(eng, prompts, new)
        elif kind == "spec":
            out[name] = speculated(eng, prompts, new)
        elif kind == "host":
            out[name] = hosted(name, eng)
        elif kind == "fleet":
            out[name] = fleet_run(name, eng, prompts, new)
        elif kind == "skew":
            out[name] = skewed(name, eng, prompts, new)
    except Exception as e:
        out[name] = {"error": repr(e)}
        print(f"rank {rank} case {name}: {e!r}", file=sys.stderr,
              flush=True)
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


#: BERT's input ids, batch 2 x 12
BERT_IDS = np.random.RandomState(7).randint(0, 64, (2, 12)).tolist()


def jax_drain(srv, ps, new):
    reqs = [srv.submit(p, max_new_tokens=new) for p in ps[:3]]
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=new) for p in ps[3:]]
    srv.run(max_steps=400)
    return reqs


def jax_run(name, family, config, kind, params):
    """The JAX package's results for one case (for a served case also
    the first step's logits, from its ``forward()`` of prompt 0)."""
    eng = jax_engine(family, config, params[family])
    ps, new = prompts(name), new_tokens(name)
    if kind == "gen":
        return {"gen": [np.asarray(eng.generate(
            np.asarray(p, np.int32)[None], max_new_tokens=new))[0].tolist()
            for p in ps]}
    if kind == "bert":
        one = jax_engine(family, BASE, params[family])
        ids = np.asarray(BERT_IDS, np.int32)
        return {"logits": np.asarray(eng.forward(ids)),
                "logits_one": np.asarray(one.forward(ids))}
    if kind == "moe":
        return {"gen": [np.asarray(eng.generate(
            np.asarray(p, np.int32)[None], max_new_tokens=new))[0].tolist()
            for p in ps],
            "logits": np.asarray(eng.forward(np.asarray(BERT_IDS,
                                                        np.int32)))}
    if kind == "spec":
        srv = eng.serving_engine(draft_model=jax_model("draft"),
                                 draft_params=params["draft"])
        reqs = jax_drain(srv, ps, new)
        return {"streams": [r.output for r in reqs],
                "spec": dict(srv.spec_counts)}
    if kind == "host":
        fi = JaxFaultInjector()
        if name.endswith("_fault"):
            fi.add_plan("serving.spill", "fatal", at=FAULT_AT, count=1)
        jax_install(fi)
        try:
            srv = eng.serving_engine()
            first, *flood = spill_prompts()
            r1 = srv.submit(first, max_new_tokens=6)
            srv.run()
            for p in flood:
                srv.submit(p, max_new_tokens=4)
            srv.run()
            r2 = srv.submit(first, max_new_tokens=6)
            srv.run()
        finally:
            jax_install(JaxFaultInjector())
        hc = srv.host_cache
        return {"streams": [r1.output, r2.output],
                "stats": dict(srv.host_counts, spills=hc.spills_total,
                              hits=dict(hc.hits_total),
                              host_hit_tokens=srv.allocator
                              .host_hit_tokens_total),
                "host_bytes": hc.resident_bytes("dram")}
    if kind == "fleet":
        fleet = JaxFleetRouter.from_engine(eng)
        freqs = [fleet.submit(p, max_new_tokens=new) for p in ps]
        fleet.run()
        return {"streams": [f.output for f in freqs],
                "placed": [[f.prefill_replica_id,
                            f.replica.replica_id if f.replica else None]
                           for f in freqs],
                "fleet": dict(fleet.fleet_counts),
                "fabric": {r.replica_id: dict(r.srv.fabric_counts)
                           for r in fleet.replicas}}
    srv = eng.serving_engine()
    reqs = jax_drain(srv, ps, new)
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
                   "gpt2_like": GPT2_LIKE,
                   "prompts": {n: prompts(n) for n in CASES},
                   "new": {n: new_tokens(n) for n in CASES},
                   "spill": spill_prompts(), "skew": SKEW,
                   "fault_at": FAULT_AT,
                   "bert_ids": BERT_IDS}, fh)
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
        for name, (_, family, config, kind) in CASES.items():
            if kind != "skew":
                jax_runs[name] = jax_run(name, family, config, kind, params)
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


def case(world, name):
    """Every rank's result of case ``name`` (each one run to its end)."""
    res = [r[name] for r in world.ranks[CASES[name][0]]]
    for got in res:
        assert "error" not in got, got.get("error")
    return res


def test_workers_import_no_jax(world):
    for n in (2, 4):
        for res in world.ranks[n]:
            assert res["jax_loaded"] == []


SERVED = [n for n, c in CASES.items() if c[3] == "serve"]


@pytest.mark.parametrize("name", SERVED)
def test_streams_equal_jax_server_on_every_rank(world, name):
    """Every rank's greedy streams are the JAX server's on the same mesh,
    token for token, and every rank's are the same; rank 0 took the
    host decisions of every iteration."""
    want = world.jax[name]["streams"]
    res = case(world, name)
    for got in res:
        assert got["status"] == ["ok"] * len(want)
        assert got["streams"] == want, name
        assert got["used"] == 0
        assert got["decisions"] > 0
    assert len({json.dumps(r["streams"]) for r in res}) == 1


SPEC = [n for n, c in CASES.items() if c[3] == "spec"]


@pytest.mark.parametrize("name", SPEC)
def test_spec_lane_equals_jax_on_every_rank(world, name):
    """The speculative lane on a mesh (the draft whole on every rank, its
    spec rows data-sharded by slot): the JAX spec server's streams and
    proposal and acceptance counts on every rank."""
    want = world.jax[name]
    assert want["spec"]["proposed"] > want["spec"]["accepted"] > 0
    for got in case(world, name):
        assert got["status"] == ["ok"] * len(want["streams"])
        assert got["streams"] == want["streams"], name
        assert got["spec"] == want["spec"]
        assert got["used"] == 0


@pytest.mark.parametrize("name", ["d2m2_host", "d2m2_host_fault"])
def test_host_tier_equals_jax_on_every_rank(world, name):
    """Spill, then a promoted prefix hit, on {data 2, model 2}: the JAX
    server's streams, spills, DRAM hits, host-hit tokens and promoted
    blocks on every rank, each rank holding its kv-head slice of every
    entry (half the JAX engine's host bytes).  With a fatal spill
    planted on rank 1 alone, every rank degrades that spill (the JAX
    server's counts under the same fault) and the streams stay the
    same."""
    want = world.jax[name]
    fault = name.endswith("_fault")
    assert want["stats"]["promoted_blocks"] >= 3 - fault
    assert want["stats"]["spill_failures"] == int(fault)
    for got in case(world, name):
        assert got["status"] == ["ok", "ok"]
        assert got["streams"] == want["streams"]
        assert got["streams"][0] == got["streams"][1]
        assert got["stats"] == want["stats"]
        assert got["host_bytes"] * 2 == want["host_bytes"] > 0
        assert got["gauge"] == got["host_bytes"]
        assert got["used"] == 0


def test_threaded_fleet_on_a_mesh(world):
    """Each replica on its own thread (``ReplicaHandle.start``) over {data
    2, model 2}: rank 0 decides each step's inbox drain, the stop, every
    placement and whether work remains, so every rank delivers each
    stream once, equal to the JAX fleet's, with the same placements;
    then the autoscaler's ticks (rank 0's time and load) drain one idle
    replica and retire it on every rank."""
    want = world.jax["d2m2_fleet_threaded"]
    res = case(world, "d2m2_fleet_threaded")
    for got in res:
        assert got["status"] == ["ok"] * len(want["streams"])
        assert got["streams"] == want["streams"]
        assert got["placed"] == res[0]["placed"]
        assert got["scaled"] == res[0]["scaled"]
        assert got["used"] == [0, 0]
    down = res[0]["scaled"]
    assert down[0][0] == "down" and sorted(down[-1]) == ["healthy",
                                                         "retired"]


@pytest.mark.parametrize("name", ["m2_fleet", "d2m2_disagg"])
def test_fleet_equals_jax_on_every_rank(world, name):
    """``FleetRouter.from_engine`` on a mesh: each request's stream
    delivered once and equal to the JAX fleet's, the same placements
    (prefill and decode replicas), handoffs and fabric counts, on every
    rank."""
    want = world.jax[name]
    if name == "d2m2_disagg":
        assert want["fleet"]["handoffs"] > 0
        assert want["fabric"]["p0"]["published_blocks"] > 0
    for got in case(world, name):
        assert got["status"] == ["ok"] * len(want["streams"])
        assert got["streams"] == want["streams"]
        assert got["placed"] == want["placed"]
        assert got["fleet"] == want["fleet"]
        assert got["fabric"] == want["fabric"]
        assert got["used"] == [0, 0]


def test_bert_forward_at_tp2_equals_jax(world):
    """BERT's MLM head under a model axis (dense and LN replicated, the
    tied decoder and its vocab bias cut by vocab rows): ``forward()``'s
    logits within 1e-5 of the JAX engine's at ``tp_size`` 2 and at one
    device, on both ranks."""
    want = world.jax["m2_bert"]
    np.testing.assert_allclose(want["logits"], want["logits_one"],
                               rtol=1e-5, atol=1e-5)
    for got in case(world, "m2_bert"):
        for ref in (want["logits"], want["logits_one"]):
            np.testing.assert_allclose(np.asarray(got["logits"]), ref,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["moe_ep2", "moe_tp2", "moe_ep2_int8"])
def test_moe_serving_equals_jax(world, name):
    """MoE served on a mesh of 2: ``generate()``'s greedy tokens equal
    the JAX engine's at the same config (its mesh over the 8 virtual
    devices: {data 4, expert 2} or {data 4, model 2}; int8 weights in
    its grouped mode at ep_size 2) and ``forward()``'s logits are within
    1e-5 of its, on both ranks."""
    want = world.jax[name]
    assert sum(len(set(g)) > 1 for g in want["gen"]) >= 3   # not degenerate
    for got in case(world, name):
        assert got["gen"] == want["gen"]
        np.testing.assert_allclose(np.asarray(got["logits"]),
                                   want["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["d2m2_skew", "d2m2_skew_front"])
def test_deadline_under_a_skewed_clock_is_rank_0s(world, name):
    """Rank 1's serving clock runs ahead of the others' (its own sweep
    would time the long request out at step 6, rank 0's at step 11):
    rank 0 decides, so every rank times it out at the same iteration,
    mid-stream, and every rank's statuses, streams and first-token steps
    are equal; under the front end with 4 slots for 7 requests, rank 0
    also says which waiting requests are late for their TTFT target."""
    res = case(world, name)
    plen, pnew = SKEW[:2]
    assert res[0]["status"] == ["timed_out"] + ["ok"] * 6
    assert 0 < len(res[0]["streams"][0]) < pnew
    if name.endswith("_front"):
        assert res[0]["late"] > 0
    for got in res:
        assert got["status"] == res[0]["status"]
        assert got["streams"] == res[0]["streams"]
        assert got["first_step"] == res[0]["first_step"]
        assert got["late"] == res[0]["late"]
        assert got["used"] == 0


def test_mesh_refuses_moe_and_bert_tp_training(world):
    """Neither is refused any more.  MoE serving on a mesh (part 5): at
    ``tp_size`` 2 and at ``moe.ep_size`` 2 every rank of the world of 2
    serves (each holding E / 2 experts at ep_size 2, all 4 at tp_size 2;
    ``test_moe_serving_equals_jax`` holds the results).  BERT's MLM head
    in tensor-parallel training (part 3c): its training view is built
    (``tests/test_torch_tp_training.py`` holds its steps to the JAX
    engine at {model 2} and {data 2, model 2})."""
    for res in world.ranks[2]:
        assert res["moe_ep2"]["experts"] == 2
        assert res["moe_tp2"]["experts"] == 4
    view = port_model("bert").tp_train_view(2, "model")
    assert view._tp_axis == "model" and view._tp_exact_bwd
    assert view.config.num_heads * 2 == port_model("bert").config.num_heads


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
    n, family, config, _ = CASES[name]
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


def test_one_rank_server_broadcasts_nothing():
    """At mesh 1 x 1 the decider is off (no process group of its own,
    nothing broadcast or agreed, the proposal never called), and the
    deadline sweep reads this process's clock."""
    params = jax_params("gpt2")
    pm = port_model("gpt2")
    srv = dt.init_inference(pm, {**BASE, "serving": SERVING},
                            params=params_from_jax(params, pm),
                            device="cpu").serving_engine()
    reqs = [srv.submit(p, max_new_tokens=4) for p in prompts()[:2]]
    late = srv.submit(prompts()[2], max_new_tokens=4, deadline_s=1e-9)
    srv.run()
    assert not srv.lockstep.active and srv.lockstep.mesh is None
    assert srv.lockstep.decide(lambda: 1 / 0) is None
    assert srv.lockstep.agree(0) == 0 and srv.lockstep.agree(2) == 2
    assert srv.lockstep.broadcasts == srv.lockstep.agreements == 0
    assert late.status.value == "timed_out"
    assert [r.status.value for r in reqs] == ["ok", "ok"]


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
