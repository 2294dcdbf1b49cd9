"""Checkpoint save and load of the port's training engine.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/engine.py`` on
torch serialization instead of orbax (the card's machine has no orbax;
this format is the port's own and reads no orbax directory).  Layout of
a save directory, as the JAX package's:

    save_dir/latest                  the newest committed tag
    save_dir/<tag>/state.pt          the engine's state tree
    save_dir/<tag>/meta.json         counters, client_state
    save_dir/<tag>/manifest.json     size + crc32 of every artifact

``state.pt`` holds the engine's state tree (``step``, ``skipped``,
``params``, ``opt``, and with fp16 ``scaler`` as a dict of its fields)
written by ``torch.save`` and read back with ``torch.load(weights_only=
True)``: tensors, dicts, numbers and strings only, no pickled objects.
A tag commits in ``_publish``: ``meta.json``, then the manifest (read
back when ``resilience.verify_on_save``), then ``latest``, each written
to a temporary file, fsynced and renamed, the whole retried on transient
I/O errors.  So a crash at any point leaves ``latest`` on the previous
committed tag.  A load verifies the tag's manifest and, when the tag came
from ``latest``, falls back to the newest tag that verifies.

``checkpoint.async_save`` copies the state to host memory at the call
and writes it on a writer thread; ``meta.json`` and ``latest`` wait for
that write to commit (``wait_pending``: at the next save or load, or at
exit).  Saves and loads bump ``dstpu_checkpoint_saves_total`` /
``dstpu_checkpoint_loads_total`` and record the ``checkpoint/save_state``,
``checkpoint/publish``, ``checkpoint/verify`` and ``checkpoint/load_state``
spans (``observability/``); the engine beats its heartbeat around a save.

Under ZeRO, data or tensor parallelism a save writes the files a
world-1 run writes: every rank takes part in gathering the whole state
(``engine.full_state()``: the data shards, then the model slices;
collectives), rank 0 alone writes and commits it, and the ranks meet at
a barrier.  A load reads the whole state on every rank and each keeps
its model slice's shards (``engine.adopt_state``), so a save at one
(data, model) mesh loads at any other, and serves at any
``tensor_parallel.tp_size``, as the JAX engine restores into the current
shardings.

The offload engines save beside ``state.pt`` (synchronously, also under
``async_save``, as the JAX engine does): ZeRO-Infinity streams its host
stores into ``<tag>/infinity/`` in the JAX package's layout
(``runtime/zero/infinity.py::save_to_dir``, the
``checkpoint/infinity_stream`` span), and ZeRO-Offload's host optimizer
writes its masters and moments to ``<tag>/host_opt.pt``; there the host
masters are the float32 truth (``get_fp32_state_dict_from_zero_
checkpoint`` reads them, not the device's compute-dtype params).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ... import comm
from ...models.convert import check_params
from ...observability import get_registry, trace_span
from ...utils.logging import logger
from ..fp16.loss_scaler import LossScaleState
from ..resilience import (CheckpointCorruptionError, FatalIOError,
                          atomic_write_json, atomic_write_text,
                          find_newest_verified_tag, fsync_dir,
                          get_fault_injector, has_manifest,
                          policy_from_config, retry_call, verify_manifest,
                          write_manifest)

STATE_FILE = "state.pt"
HOST_OPT_FILE = "host_opt.pt"
INFINITY_DIR = "infinity"
FORMAT = "deepspeed_tpu_torch-1"

#: async saves whose state is being written: (writer thread, the error it
#: met if any, the publish arguments); published in order by wait_pending
_PENDING: list = []
_ATEXIT_REGISTERED = False


def _tag_path(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), str(tag))


def _state_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """The engine's state as plain containers: the scaler's named tuple
    as a dict of its fields (``weights_only`` loads no named tuple)."""
    tree = dict(state)
    if "scaler" in tree:
        tree["scaler"] = dict(tree["scaler"]._asdict())
    return tree


def _to_host(tree):
    """A copy of ``tree`` whose tensors live in host memory."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write_state(tree: Dict[str, Any], path: str) -> None:
    """``torch.save`` to a temporary file, fsync, rename."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    fsync_dir(path)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None) -> str:
    """Save the engine's state under ``save_dir/tag`` (default
    ``global_step<N>``) and commit the tag."""
    os.makedirs(save_dir, exist_ok=True)
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    path = _tag_path(save_dir, tag)
    async_save = engine._config.checkpoint_config.async_save
    if async_save:
        wait_pending()   # publish the previous async save first
    get_registry().counter("dstpu_checkpoint_saves_total").inc()
    sharded = getattr(engine, "_zero", None) is not None
    tree = _state_tree(engine.full_state() if sharded else engine.state)
    if comm.get_rank() != 0:
        # the whole state was gathered with every rank; rank 0 writes it
        comm.barrier()
        return path
    meta = {
        "tag": tag,
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
        "client_state": client_state or {},
        "ds_version": FORMAT,
    }
    resilience = getattr(engine._config, "resilience", None)
    if async_save:
        global _ATEXIT_REGISTERED
        if not _ATEXIT_REGISTERED:
            import atexit
            atexit.register(wait_pending)
            _ATEXIT_REGISTERED = True
        # the host copy is taken now, so training may go on updating the
        # state while the thread writes
        with trace_span("checkpoint/save_state", tag=str(tag),
                        async_save=True):
            host, failed = _to_host(tree), []

        def write():
            try:
                _write_state(host, path)
            except BaseException as e:  # noqa: BLE001 - raised at publish
                failed.append(e)
        writer = threading.Thread(target=write, name=f"checkpoint-{tag}",
                                  daemon=True)
        writer.start()
        _PENDING.append((writer, failed, (os.path.abspath(save_dir), tag,
                                          meta, resilience)))
    else:
        with trace_span("checkpoint/save_state", tag=str(tag),
                        async_save=False):
            _write_state(tree, path)
    _save_offload(engine, path, tag)
    if not async_save:
        _publish(os.path.abspath(save_dir), tag, meta, resilience)
    comm.barrier()
    logger.info(f"saved checkpoint {path}" +
                (" (async)" if async_save else ""))
    return path


def _save_offload(engine, path: str, tag) -> None:
    """The offload engines' host state beside ``state.pt``."""
    if getattr(engine, "_infinity", None) is not None:
        # the whole model lives in the host/NVMe stores: streamed slot by
        # slot into the tag dir (constant memory)
        with trace_span("checkpoint/infinity_stream", tag=str(tag)):
            engine._infinity.save_to_dir(os.path.join(path, INFINITY_DIR))
    if getattr(engine, "_host_opt", None) is not None:
        sd = engine._host_opt.state_dict()
        host = {"arrays": {k: [torch.from_numpy(a) for a in arrs]
                           for k, arrs in sd["arrays"].items()},
                "step_count": int(sd["step_count"])}
        hs = engine._host_scaler
        if hs is not None:
            host["scaler"] = {"scale": float(hs.scale),
                              "good_steps": int(hs.good_steps),
                              "hysteresis": int(hs.hysteresis)}
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, HOST_OPT_FILE)
        tmp = f"{final}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)


def _load_offload(engine, path: str, load_optimizer_states: bool,
                  load_module_only: bool) -> None:
    """The offload engines' host state, with the JAX engine's
    messages."""
    if getattr(engine, "_infinity", None) is not None:
        inf_path = os.path.join(path, INFINITY_DIR)
        if not os.path.isdir(inf_path):
            raise FileNotFoundError(
                f"engine runs ZeRO-Infinity but {inf_path} is missing — "
                f"this checkpoint was saved by a non-infinity engine")
        engine._infinity.load_from_dir(
            inf_path, load_optimizer_states=(load_optimizer_states
                                             and not load_module_only))
    if getattr(engine, "_host_opt", None) is not None:
        host_path = os.path.join(path, HOST_OPT_FILE)
        if load_optimizer_states and not load_module_only:
            if not os.path.exists(host_path):
                raise FileNotFoundError(
                    f"engine runs with optimizer offload but {host_path} is "
                    f"missing — checkpoint was saved without offload (load "
                    f"with load_module_only=True to take params only)")
            host = torch.load(host_path, weights_only=True,
                              map_location="cpu")
            engine._host_opt.load_state_dict(
                {"arrays": {k: [t.numpy() for t in arrs]
                            for k, arrs in host["arrays"].items()},
                 "step_count": host["step_count"]})
            hs = engine._host_scaler
            if hs is not None and "scaler" in host:
                hs.scale = float(host["scaler"]["scale"])
                hs.good_steps = int(host["scaler"]["good_steps"])
                hs.hysteresis = int(host["scaler"]["hysteresis"])
        else:
            # params-only load: masters from the restored device params
            # (fresh moments), else step 1 would blend new params with
            # stale masters
            from ..optimizers import tree_leaves
            engine._host_opt.reset_from_params(
                list(tree_leaves(engine.state["params"])))


def _publish(save_dir: str, tag: str, meta: dict, resilience=None) -> None:
    """Commit a tag: meta.json and the integrity manifest, then point
    ``latest`` at it, each file written atomically; ``latest`` moves only
    after the manifest exists (and, with verify_on_save, verifies)."""
    path = _tag_path(save_dir, tag)
    os.makedirs(path, exist_ok=True)
    integrity = resilience is None or resilience.checkpoint_integrity
    verify = resilience is None or resilience.verify_on_save

    def commit():
        get_fault_injector().check("checkpoint.publish", path=path)
        atomic_write_json(os.path.join(path, "meta.json"), meta,
                          indent=2, default=str)
        if integrity:
            write_manifest(path, extra={"tag": str(tag)})
            if verify:
                ok, problems = verify_manifest(path)
                if not ok:
                    raise FatalIOError(
                        f"checkpoint {path} failed post-commit "
                        f"verification: {'; '.join(problems[:5])}")
        atomic_write_text(os.path.join(save_dir, "latest"), str(tag))
        fsync_dir(save_dir)

    with trace_span("checkpoint/publish", tag=str(tag),
                    integrity=integrity, verify=verify):
        retry_call(commit, policy=policy_from_config(resilience),
                   what=f"checkpoint publish '{tag}'")


def wait_pending() -> None:
    """Block until every async save's state is written, then publish its
    meta.json and ``latest``, in the order the saves were made.  A write
    that failed publishes nothing: ``latest`` stays where it was and the
    error is raised."""
    while _PENDING:
        writer, failed, args = _PENDING.pop(0)
        writer.join()
        if failed:
            raise FatalIOError(
                f"async checkpoint write of tag {args[1]!r} failed: "
                f"{failed[0]}") from failed[0]
        _publish(*args)


def _validate_tag(engine, save_dir: str, tag: Optional[str]):
    """The tag to load: as given, else the ``latest`` file's (none:
    ``checkpoint.tag_validation`` Fail raises, else a warning)."""
    if tag is None:
        latest = os.path.join(save_dir, "latest")
        if not os.path.exists(latest):
            mode = engine._config.checkpoint_config.tag_validation.lower()
            msg = f"no 'latest' file in {save_dir}"
            if mode == "fail":
                raise FileNotFoundError(msg)
            logger.warning(msg)
            return None
        with open(latest) as f:
            tag = f.read().strip()
    return tag


def _resolve_verified_tag(engine, load_dir: str, tag: str,
                          explicit: bool) -> str:
    """Integrity gate on load: verify the tag's manifest; a corrupt or
    partial tag that came from ``latest`` falls back to the newest tag
    that still verifies (a named tag never does: loading another one
    silently would be worse than failing)."""
    rz = getattr(engine._config, "resilience", None)
    if rz is not None and not rz.checkpoint_integrity:
        return tag
    path = _tag_path(load_dir, tag)
    if not os.path.isdir(path):
        ok, problems = False, [f"tag dir {path} is missing"]
    else:
        ok, problems = verify_manifest(path)
    if ok:
        return tag
    if os.path.isdir(path) and not has_manifest(path) and \
            os.path.exists(os.path.join(path, "meta.json")):
        logger.warning(f"checkpoint tag {tag!r} has no integrity manifest "
                       f"— loading unverified")
        return tag
    logger.error(f"checkpoint tag {tag!r} in {load_dir} FAILED integrity "
                 f"verification: {'; '.join(problems[:5])}")
    if not explicit and (rz is None or rz.fallback_to_last_good):
        fb = find_newest_verified_tag(load_dir, exclude=(tag,),
                                      require_manifest=False)
        if fb is not None:
            logger.warning(
                f"FALLING BACK to newest verified checkpoint tag {fb!r} "
                f"(the run loses the steps between {fb!r} and the corrupt "
                f"{tag!r})")
            return fb
    if explicit and not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    raise CheckpointCorruptionError(
        f"checkpoint tag {tag!r} in {load_dir} is corrupt/partial "
        f"({'; '.join(problems[:5])}) and no verified fallback tag "
        f"{'was allowed' if explicit else 'exists'}")


def read_state(path: str) -> Dict[str, Any]:
    """The state tree saved under tag directory ``path``, on the host,
    with ``torch.load(weights_only=True)``."""
    return torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                      map_location="cpu")


def _to_device(tree, device, host_scalars: bool = False):
    """``tree``'s tensors on ``device``; with ``host_scalars`` its 0-d
    tensors stay on the host, where ``torch.optim`` keeps its step
    counters (a client optimizer's state)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, host_scalars or k == "torch")
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or (host_scalars
                                              and tree.dim() == 0):
        return tree
    return tree.to(device)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False, **_kw
                    ) -> Tuple[Optional[str], dict]:
    """Restore the engine's state from ``load_dir`` (tag as given, else
    ``latest``); ``load_module_only`` or ``not load_optimizer_states``
    takes params and step only and keeps the engine's optimizer state.
    Returns ``(path, client_state)``, or ``(None, {})`` when there is no
    tag to load."""
    del load_lr_scheduler_states  # the schedule is a function of step
    wait_pending()
    comm.barrier()     # rank 0's async save is published for every rank
    get_registry().counter("dstpu_checkpoint_loads_total").inc()
    explicit = tag is not None
    tag = _validate_tag(engine, load_dir, tag)
    if tag is None:
        return None, {}
    with trace_span("checkpoint/verify", tag=str(tag)):
        tag = _resolve_verified_tag(engine, load_dir, tag, explicit)
    path = _tag_path(load_dir, tag)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"checkpoint {path} exists but has no meta.json — it was never "
            f"committed (crashed mid-save?); pick a committed tag")
    with open(meta_path) as f:
        meta = json.load(f)

    partial = load_module_only or not load_optimizer_states
    with trace_span("checkpoint/load_state", tag=str(tag), partial=partial):
        restored = read_state(path)
        if hasattr(engine.model, "param_shapes") and "params" in restored:
            check_params(engine.model, restored["params"])
        dev = engine.device
        sharded = getattr(engine, "_zero", None) is not None
        if partial and sharded:
            engine.adopt_state({"params": _to_device(restored["params"], dev),
                                "step": restored["step"].to(dev)},
                               partial=True)
        elif partial:
            if "params" in restored:
                engine.state["params"] = _to_device(restored["params"], dev)
            engine.state["step"] = restored["step"].to(dev)
        else:
            scaler = restored.pop("scaler", None)
            restored = _to_device(restored, dev)
            if scaler is not None and engine.loss_scaler is not None:
                restored["scaler"] = LossScaleState(
                    **{k: v.to(dev) for k, v in scaler.items()})
            if sharded:
                engine.adopt_state(restored, partial=False)
            else:
                engine.state = restored
    _load_offload(engine, path, load_optimizer_states, load_module_only)
    engine.global_steps = meta.get("global_steps", 0)
    engine.micro_steps = meta.get("micro_steps", 0)
    logger.info(f"loaded checkpoint {path}")
    return path, meta.get("client_state", {})


def latest_tag(load_dir: str) -> str:
    with open(os.path.join(load_dir, "latest")) as f:
        return f.read().strip()


def get_fp32_state_dict_from_zero_checkpoint(load_dir: str,
                                             tag: Optional[str] = None):
    """The params tree of a checkpoint of the port as float32 tensors on
    the host, with no engine (the reference's ``zero_to_fp32``)."""
    if tag is None:
        tag = latest_tag(load_dir)
    path = _tag_path(load_dir, tag)
    if os.path.isdir(os.path.join(path, INFINITY_DIR)):
        from ..zero.infinity import infinity_fp32_state_dict
        return infinity_fp32_state_dict(os.path.join(path, INFINITY_DIR))
    state = read_state(path)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.to(torch.float32)
    params = f32(state["params"])
    host_path = os.path.join(path, HOST_OPT_FILE)
    if os.path.exists(host_path):
        # an offload checkpoint: the true float32 masters live on the
        # host side; the device tree holds their compute-dtype copies
        masters = iter(torch.load(host_path, weights_only=True,
                                  map_location="cpu")["arrays"]["master"])

        def take(tree):
            if isinstance(tree, dict):
                return {k: take(v) for k, v in tree.items()}
            return next(masters).reshape(tree.shape)
        params = take(params)
    return params
