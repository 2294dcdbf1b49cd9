"""Checkpoint save, load and resume of the port's training engine
(``runtime/checkpoint_engine``) against the JAX package's engine.

The model is the tiny GPT-2 of ``test_torch_training.py`` (2 layers,
d_model 64, 4 heads, T 64, vocab 256, float32, flash attention, the
fused loss head at chunk 16).  A state the port saves and loads takes the
JAX engine's next step from that state (crossed with
``convert.state_to_jax``) within the training parity limits (loss and
grad norm 1e-5 relative, state 1e-5); a run resumed from a checkpoint is
bit-equal to the run that never stopped.  The commit contract is held as
``tests/unit/test_train_chaos.py`` holds the JAX one: a torn save never
moves ``latest``, a corrupt tag falls back to the newest verified one, an
async save publishes only after its write commits.
"""
import json
import os

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
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import state_to_jax
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    get_fp32_state_dict_from_zero_checkpoint, wait_pending)
from deepspeed_tpu_torch.runtime.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.resilience import (
    CheckpointCorruptionError, FatalIOError, FaultInjector,
    TransientIOError, install_fault_injector, verify_manifest)

SMALL = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=256,
             max_seq_len=64, attn_impl="flash", remat="full", loss_chunk=16)
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 6e-4, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 0}
REL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-5)

#: the optimizers of the resume parity case, by config name
OPTIMIZERS = {
    "AdamW": {"lr": 6e-4, "weight_decay": 0.1},
    "Lamb": {"lr": 2e-3, "weight_decay": 0.01},
    "SGD": {"lr": 0.05, "momentum": 0.9, "nesterov": True},
    # eps 1e-4: the key bias's gradient is zero but for rounding (softmax
    # ignores a shift of every score), and with the default eps 1e-10
    # Adagrad moves such an element by lr x the sign of that rounding
    # noise, which the two packages draw differently
    "Adagrad": {"lr": 0.02, "eps": 1e-4},
}


def port_model(**kw):
    return tt.TransformerLM(tt.gpt2_config("125m", dtype=torch.float32,
                                           **{**SMALL, **kw}))


def port_engine(config=CONFIG, params=None, seed=0, **model_kw):
    eng, _, _, _ = dt.initialize(model=port_model(**model_kw),
                                 config=json.loads(json.dumps(config)),
                                 params=params, device="cpu", seed=seed)
    return eng


def batches(n, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, (4, 64)).astype(np.int32)}
            for _ in range(n)]


def assert_trees_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_reloaded_state_takes_the_jax_engines_next_step(opt_name, tmp_path):
    """The port trains 2 steps, saves, and a fresh engine (another seed)
    loads the checkpoint; the JAX engine is given that state through
    ``state_to_jax``.  Both take step 3 on the same batch: loss and grad
    norm within 1e-5 relative, the new states within 1e-5 (AdamW, LAMB,
    SGD with Nesterov momentum, Adagrad, each by its config name)."""
    config = dict(CONFIG, optimizer={"type": opt_name,
                                     "params": OPTIMIZERS[opt_name]})
    pe = port_engine(config)
    for b in batches(2, seed=1):
        pe.train_step(b)
    pe.save_checkpoint(str(tmp_path))
    fresh = port_engine(config, seed=7)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client == {}
    assert fresh.global_steps == 2 and fresh.micro_steps == 4
    assert_trees_equal(fresh.state, pe.state)

    jm = jax_tf.TransformerLM(jax_tf.gpt2_config("125m", dtype=jnp.float32,
                                                 **SMALL))
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    je, _, _, _ = ds.initialize(model=jm, config=json.loads(
        json.dumps(config)), mesh=mesh)
    want = jax.device_get(je.state)
    got = state_to_jax(fresh.state)
    assert sorted(got["opt"]) == sorted(want["opt"])
    je.state = jax.tree_util.tree_map(jnp.asarray, got)
    b = batches(1, seed=2)[0]
    jmet, pmet = je.train_step(b), fresh.train_step(b)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                   rtol=REL, atol=0)
    after = state_to_jax(fresh.state)
    jax.tree_util.tree_map(
        lambda x, y: np.testing.assert_allclose(x, np.asarray(y),
                                                **STATE_TOL),
        after, jax.device_get(je.state))


@pytest.mark.parametrize("remat", ["dots_no_batch", "full"])
def test_resumed_run_is_bit_equal(remat, tmp_path):
    """GPT-2 with LAMB, fp16 with dynamic loss scaling and a selective
    remat policy: 4 steps straight against 2 steps, a save, a fresh
    engine, a load and 2 more steps.  The later losses, the final params,
    optimizer state and scaler are bit-equal."""
    config = dict(CONFIG, optimizer={"type": "Lamb",
                                     "params": {"lr": 2e-3}},
                  fp16={"enabled": True, "initial_scale_power": 8,
                        "loss_scale_window": 2})
    bs = batches(4, seed=3)
    straight = port_engine(config, remat=remat)
    want = [float(straight.train_step(b)["loss"]) for b in bs]
    first = port_engine(config, remat=remat)
    got = [float(first.train_step(b)["loss"]) for b in bs[:2]]
    first.save_checkpoint(str(tmp_path), tag="half")
    second = port_engine(config, seed=11, remat=remat)
    second.load_checkpoint(str(tmp_path))
    got += [float(second.train_step(b)["loss"]) for b in bs[2:]]
    assert got == want
    assert second.loss_scale == straight.loss_scale == 2.0 ** 10
    assert_trees_equal({k: v for k, v in second.state.items()
                        if k != "scaler"},
                       {k: v for k, v in straight.state.items()
                        if k != "scaler"})
    for a, b in zip(second.state["scaler"], straight.state["scaler"]):
        assert torch.equal(a, b)


def test_client_state_module_only_and_scaler_round_trip(tmp_path):
    """``client_state`` comes back from ``meta.json``; the fp16 scaler's
    state (scale, good steps, hysteresis) is restored as a
    ``LossScaleState``; ``load_module_only`` takes params and step and
    keeps the loading engine's optimizer state and scaler; the
    ``global_step<N>`` default tag and ``get_fp32_state_dict_from_zero_
    checkpoint`` give the params."""
    config = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 5,
                                "loss_scale_window": 1})
    pe = port_engine(config)
    for b in batches(3, seed=4):
        pe.train_step(b)
    assert pe.loss_scale == 2.0 ** 8
    path = pe.save_checkpoint(str(tmp_path),
                              client_state={"epoch": 3, "note": "x"})
    assert os.path.basename(path) == "global_step3"
    assert (tmp_path / "latest").read_text() == "global_step3"
    meta = json.loads((tmp_path / "global_step3" / "meta.json").read_text())
    assert meta["global_steps"] == 3 and meta["skipped_steps"] == 0

    full = port_engine(config, seed=5)
    _, client = full.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3, "note": "x"}
    assert full.loss_scale == 2.0 ** 8
    assert type(full.state["scaler"]).__name__ == "LossScaleState"
    for a, b in zip(full.state["scaler"], pe.state["scaler"]):
        assert torch.equal(a, b)

    partial = port_engine(config, seed=5)
    opt_before = [t.clone() for t in tree_leaves(partial.state["opt"])]
    partial.load_checkpoint(str(tmp_path), load_module_only=True)
    assert_trees_equal(partial.state["params"], pe.state["params"])
    assert int(partial.state["step"]) == 3
    for a, b in zip(tree_leaves(partial.state["opt"]), opt_before):
        assert torch.equal(a, b)
    assert partial.loss_scale == 2.0 ** 5

    fp32 = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert_trees_equal(fp32, pe.state["params"])


def test_corrupt_tag_falls_back_to_newest_verified(tmp_path):
    """A bit flipped in the newest tag's state fails its crc32 manifest:
    a load through ``latest`` falls back to the newest tag that verifies,
    and a load that names the corrupt tag raises."""
    pe = port_engine()
    bs = batches(2, seed=5)
    pe.train_step(bs[0])
    pe.save_checkpoint(str(tmp_path))
    good = [t.clone() for t in tree_leaves(pe.state["params"])]
    pe.train_step(bs[1])
    pe.save_checkpoint(str(tmp_path))
    blob = tmp_path / "global_step2" / "state.pt"
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    assert not verify_manifest(str(tmp_path / "global_step2"))[0]

    fresh = port_engine(seed=3)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and fresh.global_steps == 1
    for a, b in zip(tree_leaves(fresh.state["params"]), good):
        assert torch.equal(a, b)
    with pytest.raises(CheckpointCorruptionError):
        port_engine(seed=3).load_checkpoint(str(tmp_path),
                                            tag="global_step2")


def test_torn_save_never_moves_latest(tmp_path):
    """A fatal fault at ``checkpoint.publish`` (the commit of meta.json,
    the manifest and ``latest``) fails the save and leaves ``latest`` on
    the previous committed tag, which still loads; a transient fault
    there is absorbed by the retried publish."""
    pe = port_engine(dict(CONFIG, resilience={"io_retry_base_delay_s": 0.0,
                                              "io_retry_max_delay_s": 0.0}))
    bs = batches(3, seed=6)
    pe.train_step(bs[0])
    pe.save_checkpoint(str(tmp_path))
    pe.train_step(bs[1])
    fi = FaultInjector()
    fi.add_plan("checkpoint.publish", "fatal")
    install_fault_injector(fi)
    try:
        with pytest.raises(FatalIOError):
            pe.save_checkpoint(str(tmp_path))
        assert fi.fire_count("checkpoint.publish") == 1
        assert (tmp_path / "latest").read_text() == "global_step1"
        assert not (tmp_path / "global_step2" / "meta.json").exists()
        fi.reset()
        fi.add_plan("checkpoint.publish", "fail", count=2)
        pe.train_step(bs[2])
        pe.save_checkpoint(str(tmp_path))
        assert fi.fire_count("checkpoint.publish") == 2
    finally:
        install_fault_injector(FaultInjector())
    assert (tmp_path / "latest").read_text() == "global_step3"
    fresh = port_engine(seed=2)
    path, _ = fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    assert fresh.global_steps == 1


@pytest.mark.parametrize("kind", ["fail", "fatal", "truncate", "delay"])
def test_fault_injector_kinds_from_env(kind, tmp_path):
    """``DSTPU_FAULTS`` (site=kind:at:count:arg) fires the kinds the port
    keeps at the planned call only: ``fail`` raises the retriable error,
    ``fatal`` the final one, ``truncate`` cuts the site's file to ``arg``
    bytes.  A kind of a subsystem still to port is refused."""
    spec = {"DSTPU_FAULTS": f"checkpoint.artifact={kind}:2:1:3"}
    if kind == "delay":
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultInjector.from_env(spec)
        return
    fi = FaultInjector.from_env(spec)
    f = tmp_path / "artifact.pt"
    f.write_bytes(b"0123456789")
    fi.check("checkpoint.artifact", path=str(f))
    assert f.read_bytes() == b"0123456789"
    if kind == "truncate":
        fi.check("checkpoint.artifact", path=str(f))
        assert f.read_bytes() == b"012"
    else:
        error = TransientIOError if kind == "fail" else FatalIOError
        with pytest.raises(error, match="call 2"):
            fi.check("checkpoint.artifact", path=str(f))
    fi.check("checkpoint.artifact", path=str(f))
    fi.check("checkpoint.publish", path=str(f))
    assert fi.fire_count("checkpoint.artifact") == 1
    assert fi.fire_count("checkpoint.publish") == 0


def test_async_save_publishes_only_after_commit(tmp_path):
    """With ``checkpoint.async_save`` the state is copied to the host and
    written by a writer thread: ``meta.json`` and ``latest`` appear only
    when ``wait_pending`` has seen the write commit, and the next load
    waits for it.  Training on after the call leaves the saved state as
    it was at the call."""
    config = dict(CONFIG, checkpoint={"async_save": True})
    pe = port_engine(config)
    bs = batches(2, seed=7)
    pe.train_step(bs[0])
    saved = [t.clone() for t in tree_leaves(pe.state["params"])]
    pe.save_checkpoint(str(tmp_path))
    assert not (tmp_path / "latest").exists()
    assert not (tmp_path / "global_step1" / "meta.json").exists()
    pe.train_step(bs[1])
    wait_pending()
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert verify_manifest(str(tmp_path / "global_step1"))[0]
    fresh = port_engine(config, seed=4)
    fresh.load_checkpoint(str(tmp_path))
    for a, b in zip(tree_leaves(fresh.state["params"]), saved):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,raises", [("Fail", True), ("Warn", False),
                                         ("Ignore", False)])
def test_tag_validation_without_latest(mode, raises, tmp_path):
    pe = port_engine(dict(CONFIG, checkpoint={"tag_validation": mode}))
    if raises:
        with pytest.raises(FileNotFoundError, match="latest"):
            pe.load_checkpoint(str(tmp_path))
    else:
        assert pe.load_checkpoint(str(tmp_path)) == (None, {})


def test_inference_serves_a_training_checkpoint(tmp_path):
    """``init_inference(checkpoint=..., checkpoint_tag=...)`` serves the
    params of a training checkpoint (cast to the engine's dtype), as the
    JAX engine's ``_load_checkpoint`` does: the same logits as an engine
    given those params, the same greedy tokens; ``latest`` by default."""
    pe = port_engine()
    for b in batches(2, seed=8):
        pe.train_step(b)
    pe.save_checkpoint(str(tmp_path), tag="served")
    model = port_model(attn_impl="xla", remat="none")
    ids = np.random.RandomState(9).randint(0, 256, (2, 16))
    for cfg in ({"checkpoint": str(tmp_path)},
                {"checkpoint": str(tmp_path), "checkpoint_tag": "served"}):
        ie = dt.init_inference(model, {"dtype": "float32", **cfg},
                               device="cpu")
        ref = dt.init_inference(model, {"dtype": "float32"},
                                params=pe.state["params"], device="cpu")
        assert torch.equal(ie.forward(ids), ref.forward(ids))
        assert torch.equal(ie.generate(ids, max_new_tokens=4),
                           ref.generate(ids, max_new_tokens=4))
    ie = dt.init_inference(model, {"dtype": "float16",
                                   "checkpoint": str(tmp_path)},
                           device="cpu")
    assert all(t.dtype == torch.float16 for t in tree_leaves(ie.params))


def test_failed_async_write_publishes_nothing(tmp_path, monkeypatch):
    """An async save whose write fails raises at ``wait_pending`` and
    leaves ``latest`` on the previous committed tag."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ce
    pe = port_engine(dict(CONFIG, checkpoint={"async_save": True}))
    bs = batches(2, seed=9)
    pe.train_step(bs[0])
    pe.save_checkpoint(str(tmp_path))
    wait_pending()

    def broken(tree, path):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ce, "_write_state", broken)
    pe.train_step(bs[1])
    pe.save_checkpoint(str(tmp_path))
    with pytest.raises(FatalIOError, match="global_step2"):
        wait_pending()
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert not (tmp_path / "global_step2" / "meta.json").exists()
