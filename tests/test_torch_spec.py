"""The port's speculative serving lane against the JAX package's and
against its own plain server.

Target: GPT-2 shaped, 2 layers, d_model 32, 4 heads, vocab 64; draft: 1
layer, d_model 16, 2 heads of 8; both float32 with weights from the JAX
``init`` carried by ``params_from_jax`` (for the servers scaled by
``SPREAD``, so that greedy streams do not collapse onto one repeated
token).  The mixed step's spec lane (``_apply_paged_mixed(...,
spec_tokens=, spec_active=)``) is held to the JAX model's at 1e-5 for
kv_bits 0/8/4 with and without a prompt chunk; the port's greedy spec
streams equal the JAX spec server's, with equal ``spec_counts``.  On the
JAX side the paged kernels run through the package's plain references
(``paged_attention_reference``, ``paged_prefill_reference``), as its own
serving tests pin them.  The spec streams also equal the port's no-draft
streams, greedy and seeded at temperature > 0, when ``try_grow`` fails,
under preemption, with a quarantined spec slot and across a transient
``serving.dispatch`` fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dt
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.transformer import paged_decode_attention as jax_pa
from deepspeed_tpu_torch.inference.serving import RequestStatus, ServingError
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.resilience import (FaultInjector,
                                                    install_fault_injector)

TOL = dict(atol=1e-5, rtol=1e-5)
TARGET = dict(num_layers=2, d_model=32, num_heads=4, vocab_size=64,
              max_seq_len=128)
DRAFT = dict(num_layers=1, d_model=16, num_heads=2, vocab_size=64,
             max_seq_len=128)
#: the JAX init's N(0, 0.02) weights times this: logits far enough apart
#: that greedy streams move between tokens
SPREAD = 12.0
BASE = {"dtype": "float32", "max_out_tokens": 128, "temperature": 0.0}
SERVING = {"enabled": True, "kv_block_size": 8, "num_kv_blocks": 64,
           "max_batch_slots": 4, "prefill_chunk_tokens": 16, "spec_k": 3}
PROMPT_LENS = (5, 3, 21, 9, 30)
SAMPLED = [dict(temperature=0.0), dict(temperature=0.8, seed=7),
           dict(temperature=0.6, top_k=12, seed=9),
           dict(temperature=1.0, top_p=0.9, seed=3),
           dict(temperature=0.7, seed=1)]


def spread(tree):
    """Every matrix (and stacked matrix) leaf times ``SPREAD``."""
    if isinstance(tree, dict):
        return {k: spread(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a * SPREAD if a.ndim >= 2 and a.shape[-1] > 1 else a


def jax_cfg(kw):
    return jax_tf.gpt2_config("125m", dtype=jnp.float32, **kw)


def port_cfg(kw):
    return tt.gpt2_config("125m", dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def raw_target():
    """The target's JAX init as numpy (the mixed-step parity's weights:
    the serving suites' logit scale, where 1e-5 is f32 rounding)."""
    return jax.device_get(jax_tf.TransformerLM(jax_cfg(TARGET)).init(
        jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def weights(raw_target):
    """(target tree, draft tree) as numpy, JAX layout, spread."""
    tp = spread(raw_target)
    dp = spread(jax.device_get(jax_tf.TransformerLM(jax_cfg(DRAFT)).init(
        jax.random.PRNGKey(1))))
    return tp, dp


@pytest.fixture(autouse=True)
def fresh_injector():
    install_fault_injector(FaultInjector())
    yield
    install_fault_injector(FaultInjector())


def prompts(seed=3, lens=PROMPT_LENS):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 64, (n,)).tolist() for n in lens]


def port_server(weights, draft=True, serving=None, self_draft=False):
    tp, dp = weights
    pm = tt.TransformerLM(port_cfg(TARGET))
    eng = dt.init_inference(pm, {**BASE, "serving": {**SERVING,
                                                     **(serving or {})}},
                            params=params_from_jax(tp, pm), device="cpu")
    if self_draft:
        return eng.serving_engine(draft_model=eng.module,
                                  draft_params=eng.params)
    if not draft:
        return eng.serving_engine()
    dm = tt.TransformerLM(port_cfg(DRAFT))
    return eng.serving_engine(draft_model=dm,
                              draft_params=params_from_jax(dp, dm))


def serve(srv, ps, new=10, samp=None):
    reqs = [srv.submit(p, max_new_tokens=new, **(samp[i] if samp else {}))
            for i, p in enumerate(ps)]
    srv.run()
    return reqs


@pytest.fixture
def jax_reference_kernels(monkeypatch):
    """The JAX paged kernels through the package's plain references
    (``paged_attention_reference``, ``paged_prefill_reference``: what
    the JAX serving tests pin the kernels to, and what
    ``test_torch_attention.py`` holds the port's B6/B7 plain versions to
    beside the interpreted kernels).  Interpreted inside the spec
    program, they would take minutes to compile on the CPU."""
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


# ---------------------------------------------------------------------------
# the mixed step's spec lane
# ---------------------------------------------------------------------------
def _ints(pool, kv_bits):
    x = pool.astype(np.int32)
    if kv_bits == 4:
        x = np.concatenate([((x & 0xF) ^ 8) - 8, x >> 4], axis=-1)
    return x


@pytest.mark.parametrize("chunk", [True, False], ids=["chunk", "nochunk"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_spec_mixed_step_matches_jax(raw_target, jax_reference_kernels,
                                     kv_bits, chunk):
    """Both sides' pools seeded with the same random rows (values and,
    quantized, scales) where slots 0-2 hold 13, 10 and 7 rows; then one
    step where slot 1 decodes plainly, slots 0 and 2 verify 4 spec rows
    each (spec_k 3; slot 2's rows cross into its second page) and, with
    ``chunk``, slot 3 prefills 11 tokens of a 16-wide chunk.  Decode, spec and chunk logits within 1e-5 of the
    jitted JAX step's, the new lens equal, the pools but the null block
    equal (kv_bits 0: within 1e-5; quantized: scales within 1e-6 relative, integer values
    off by at most 1 on at most 0.1 %)."""
    tp = raw_target
    jm = jax_tf.TransformerLM(jax_cfg(TARGET))
    pm = tt.TransformerLM(port_cfg(TARGET))
    pp = params_from_jax(tp, pm)
    nb, blk, nslots, npages, S = 24, 8, 4, 6, 4
    rng = np.random.default_rng(10 + kv_bits)
    shapes = {k: tuple(v.shape) for k, v in pm.init_paged_cache(
        nb, blk, kv_bits=kv_bits, device="cpu").items()}
    seeded = {}
    for key, shape in shapes.items():
        if key.endswith("scale"):
            seeded[key] = rng.uniform(0.002, 0.02, shape).astype(np.float32)
        elif kv_bits:
            seeded[key] = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            seeded[key] = rng.normal(0.0, 1.0, shape).astype(np.float32)
    jc = {k: jnp.asarray(v) for k, v in seeded.items()}
    pc = {k: torch.from_numpy(v.copy()) for k, v in seeded.items()}
    tables = np.zeros((nslots, npages), np.int32)
    tables[0, :3], tables[1, :2], tables[2, :2], tables[3, :2] = \
        [4, 9, 2], [7, 11], [3, 15], [5, 6]
    lens = np.array([13, 10, 7, 0], np.int32)
    dec_tokens = rng.integers(0, 64, nslots).astype(np.int32)
    dec_active = np.array([0, 1, 0, 0], np.int32)
    spec_active = np.array([1, 0, 1, 0], np.int32)
    spec_tokens = rng.integers(0, 64, (nslots, S)).astype(np.int32)
    width = 16 if chunk else 0
    ids = np.zeros(width, np.int32)
    n = 11 if chunk else 0
    ids[:n] = rng.integers(0, 64, n)
    args = (dec_tokens, dec_active, ids, 3, 0, n)
    jd, js, jcl, jc = jax.jit(jm._apply_paged_mixed)(
        tp, {**jc, "block_tables": jnp.asarray(tables),
             "lens": jnp.asarray(lens)},
        *(jnp.asarray(a, jnp.int32) for a in args),
        spec_tokens=jnp.asarray(spec_tokens),
        spec_active=jnp.asarray(spec_active))
    pd, ps, pcl, pcache = pm._apply_paged_mixed(
        pp, {**pc, "block_tables": torch.from_numpy(tables),
             "lens": torch.from_numpy(lens)},
        *(torch.as_tensor(a, dtype=torch.int32) for a in args),
        spec_tokens=torch.from_numpy(spec_tokens),
        spec_active=torch.from_numpy(spec_active))
    assert tuple(ps.shape) == (nslots, S, 64)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(ps.numpy()[spec_active > 0],
                               np.asarray(js)[spec_active > 0], **TOL)
    if chunk:
        np.testing.assert_allclose(pcl.numpy(), np.asarray(jcl), **TOL)
    else:
        assert pcl is None
    assert pcache["lens"].tolist() == np.asarray(jc["lens"]).tolist()
    # block 0 is the null block every inactive and padded row writes to
    # (in an unspecified order): junk never attended, left out
    if kv_bits == 0:
        for key in ("k", "v"):
            np.testing.assert_allclose(pcache[key].numpy()[:, 1:],
                                       np.asarray(jc[key])[:, 1:], **TOL)
    else:
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(pcache[key].numpy()[:, 1:],
                                       np.asarray(jc[key])[:, 1:],
                                       rtol=1e-6, atol=0)
        for key in ("k", "v"):
            diff = (_ints(pcache[key].numpy()[:, 1:], kv_bits)
                    - _ints(np.asarray(jc[key])[:, 1:], kv_bits))
            assert np.abs(diff).max() <= 1
            assert (diff == 0).mean() >= 0.999


def test_no_spec_step_launches_what_it_did(weights, monkeypatch):
    """Without ``spec_tokens`` the step calls B6 once a layer for the
    decode lane and B7 once a layer for the chunk, and returns the
    three-tuple; with them B6 runs once more a layer per spec depth."""
    tp, _ = weights
    pm = tt.TransformerLM(port_cfg(TARGET))
    pp = params_from_jax(tp, pm)
    calls = []
    real_d, real_p = tt.paged_decode_attention, tt.paged_prefill_attention
    monkeypatch.setattr(tt, "paged_decode_attention",
                        lambda *a, **k: calls.append("B6") or real_d(*a, **k))
    monkeypatch.setattr(tt, "paged_prefill_attention",
                        lambda *a, **k: calls.append("B7") or real_p(*a, **k))
    cache = {**pm.init_paged_cache(16, 8, device="cpu"),
             "block_tables": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
             "lens": torch.tensor([5, 0], dtype=torch.int32)}
    one = torch.tensor([7, 0], dtype=torch.int32)
    act = torch.tensor([1, 0], dtype=torch.int32)
    chunk = torch.tensor([1, 2, 3], dtype=torch.int32)
    out = pm._apply_paged_mixed(pp, cache, one, act, chunk, 1, 0, 3)
    assert len(out) == 3 and calls == ["B6", "B7"] * 2
    calls.clear()
    out = pm._apply_paged_mixed(
        pp, cache, one[:0], act[:0], chunk[:0], 0, 0, 0,
        spec_tokens=torch.tensor([[7, 8, 9], [0, 0, 0]], dtype=torch.int32),
        spec_active=act)
    assert len(out) == 4 and calls == ["B6"] * 6


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------
def test_spec_server_matches_jax_server(weights, jax_reference_kernels):
    """Greedy spec streams token for token equal to the JAX spec
    server's on the same weights, with equal ``spec_counts``, and to
    the port's no-draft streams."""
    tp, dp = weights
    jm = jax_tf.TransformerLM(jax_cfg(TARGET))
    jd = jax_tf.TransformerLM(jax_cfg(DRAFT))
    jeng = ds.init_inference(jm, config={
        **BASE, "replace_with_kernel_inject": False,
        "serving": SERVING}, params=tp)
    jsrv = jeng.serving_engine(draft_model=jd, draft_params=dp)
    ps = prompts()
    jreqs = serve(jsrv, ps)
    psrv = port_server(weights)
    preqs = serve(psrv, ps)
    plain = serve(port_server(weights, draft=False), ps)
    for j, p, q in zip(jreqs, preqs, plain):
        assert p.status is RequestStatus.OK
        assert p.output == j.output == q.output
    assert len({tuple(r.output) for r in preqs}) > 1
    assert psrv.spec_counts == jsrv.spec_counts
    assert 0 < psrv.spec_counts["accepted"] < psrv.spec_counts["proposed"]


@pytest.mark.parametrize("samp", [None, SAMPLED], ids=["greedy", "seeded"])
def test_spec_streams_equal_plain_streams(weights, samp):
    """Greedy and per-request seeded sampling (temperature, top-k, top-p
    mixed in one batch): every spec stream equals the no-draft stream,
    and the spec lane ran and rejected something."""
    ps = prompts()
    spec = port_server(weights)
    got = serve(spec, ps, samp=samp)
    want = serve(port_server(weights, draft=False), ps, samp=samp)
    assert [r.output for r in got] == [r.output for r in want]
    assert spec.spec_counts["proposed"] > spec.spec_counts["accepted"] > 0
    assert spec.allocator.num_used == 0


def test_self_draft_accepts_every_proposal(weights):
    """The target as its own draft (its module and its params, no copy)
    accepts every proposal in f32, so the drain takes fewer dispatches
    than plain decode."""
    ps = prompts()
    srv = port_server(weights, self_draft=True)

    def leaves(tree):
        return ([x for v in tree.values() for x in leaves(v)]
                if isinstance(tree, dict) else [tree])
    assert all(a is b for a, b in zip(leaves(srv._draft_params),
                                      leaves(srv.engine.params)))
    got = serve(srv, ps)
    plain_srv = port_server(weights, draft=False)
    want = serve(plain_srv, ps)
    assert [r.output for r in got] == [r.output for r in want]
    assert srv.spec_counts["accepted"] == srv.spec_counts["proposed"] > 0
    assert srv.counts["dispatches"] < plain_srv.counts["dispatches"]


def test_try_grow_failure_falls_back_to_plain(weights):
    """Two slots over 6 usable blocks: each 13-token prompt with 11 new
    tokens fits its 3 blocks, but the spec rows of its last tokens would
    need a fourth, so ``try_grow`` refuses there without preempting, the
    slot decodes plainly, and the streams stay equal to the no-draft
    server's."""
    serving = {"num_kv_blocks": 7, "max_batch_slots": 2}
    ps = prompts(lens=(13, 13, 13))
    srv = port_server(weights, serving=serving)
    refused = []
    grow = srv.scheduler.try_grow

    def spy(slot, extra):
        ok = grow(slot, extra)
        refused.append(not ok)
        return ok
    srv.scheduler.try_grow = spy
    got = serve(srv, ps, new=11)
    want = serve(port_server(weights, draft=False, serving=serving), ps,
                 new=11)
    assert [r.output for r in got] == [r.output for r in want]
    assert any(refused) and not all(refused)
    assert srv.counts["preemptions"] == 0


def test_preemption_during_speculation(weights):
    """A pool small enough that growing tables preempts: the victims
    re-queue and recompute, and every stream still equals the no-draft
    server's on the same pool."""
    serving = {"num_kv_blocks": 8, "max_batch_slots": 3,
               "max_preemptions": 4}
    ps = prompts(seed=5, lens=(12, 15, 10, 7))
    srv = port_server(weights, serving=serving)
    got = serve(srv, ps, new=14)
    plain = port_server(weights, draft=False, serving=serving)
    want = serve(plain, ps, new=14)
    assert all(r.status is RequestStatus.OK for r in got)
    assert [r.output for r in got] == [r.output for r in want]
    assert srv.counts["preemptions"] > 0
    assert srv.spec_counts["proposed"] > 0


def test_nonfinite_spec_slot_is_quarantined_alone(weights):
    """NaN spec logits in one slot of one dispatch: that request FAILS
    (quarantined, its blocks discarded), every other stream equals the
    no-draft server's, and the pool drains clean."""
    ps = prompts()
    srv = port_server(weights)
    mixed = srv.model._apply_paged_mixed
    victim = {}

    def poisoned(*args, **kw):
        out = mixed(*args, **kw)
        if kw.get("spec_tokens") is not None and not victim:
            slot = int(torch.nonzero(kw["spec_active"])[0])
            victim["req"] = srv.scheduler.running[slot]
            out[1][slot, 2, 5] = float("nan")
        return out
    srv.model._apply_paged_mixed = poisoned
    got = serve(srv, ps)
    want = serve(port_server(weights, draft=False), ps)
    bad = victim["req"]
    assert bad.status is RequestStatus.FAILED and "spec decode" in bad.error
    assert srv.lifecycle_counts["quarantined"] == 1
    for r, w in zip(got, want):
        if r is not bad:
            assert r.status is RequestStatus.OK and r.output == w.output
    assert srv.allocator.num_used == 0


@pytest.mark.parametrize("kind", ["fail", "fatal"])
def test_dispatch_fault_site(weights, kind):
    """``serving.dispatch``: a transient fault skips the iteration with
    nothing charged and the streams are unchanged; a fatal one raises
    ``ServingError``."""
    ps = prompts()
    want = serve(port_server(weights, draft=False), ps)
    fi = install_fault_injector(FaultInjector())
    fi.add_plan("serving.dispatch", kind, at=3, count=2)
    srv = port_server(weights)
    if kind == "fatal":
        with pytest.raises(ServingError, match="fatal fault"):
            serve(srv, ps)
        return
    got = serve(srv, ps)
    assert fi.fire_count("serving.dispatch") == 2
    assert [r.output for r in got] == [r.output for r in want]


def test_draft_checks_and_refusals(weights):
    """The JAX engine's draft checks (paged support, vocab, max_seq_len),
    an untrained draft from seed 1 when no params are given, and the
    options of the next slice refused naming it."""
    tp, _ = weights
    pm = tt.TransformerLM(port_cfg(TARGET))

    def eng(serving=None):
        return dt.init_inference(pm, {**BASE, "serving": {
            **SERVING, **(serving or {})}}, params=params_from_jax(tp, pm),
            device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        eng().serving_engine(draft_model=tt.TransformerLM(
            port_cfg({**DRAFT, "vocab_size": 32})))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng().serving_engine(draft_model=tt.TransformerLM(
            port_cfg({**DRAFT, "max_seq_len": 64})))
    with pytest.raises(NotImplementedError, match="draft model cannot"):
        eng().serving_engine(draft_model=tt.TransformerLM(
            port_cfg({**DRAFT, "causal": False})))
    srv = eng().serving_engine(draft_model=tt.TransformerLM(port_cfg(DRAFT)))
    assert srv._draft_params["embed"]["embedding"].dtype == torch.float32
    reqs = serve(srv, prompts()[:2], new=4)
    assert all(r.status is RequestStatus.OK for r in reqs)
    for serving in ({"host_cache": {"enabled": True}},
                    {"fleet": {"enabled": True}}):
        with pytest.raises(NotImplementedError,
                           match="queue A item 4, second part"):
            eng(serving).serving_engine()
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        eng({"mesh": {"model": 2}}).serving_engine()
    from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
    for kw in ({"role": "prefill"}, {"shared_host_cache": object()}):
        with pytest.raises(NotImplementedError,
                           match="queue A item 4, second part"):
            ServingEngine(eng(), **kw)
    with pytest.raises(NotImplementedError, match="second part"):
        eng().serving_engine().submit([1, 2], prefill_only=True)
