"""Checkpoint integrity: atomic publishes, per-artifact checksums, and
last-good-tag discovery.

Role-equivalent of the reference's checkpoint tag validation
(`runtime/engine.py:3045` _checkpoint_tag_validation — which only checks
that every rank AGREES on the tag string) plus the commit semantics of
the Nebula engine (`checkpoint_engine/nebula_checkpoint_engine.py` —
a tag is only visible once fully persisted). Here both are strengthened:

  - every artifact file under a tag dir is fingerprinted (size + crc32)
    into ``manifest.json``, written atomically AFTER the artifacts;
  - ``latest`` is updated only after the manifest (optionally verified
    back) exists, via write-tmp → fsync → rename → fsync(dir), so a
    crash at any instant leaves either the old or the new committed
    state, never a torn one;
  - loads verify the manifest and can walk back to the newest tag that
    still verifies (`find_newest_verified_tag`).

crc32 (zlib) rather than sha256: the threat model is torn writes and
bit-rot detection, not adversarial tampering, and checkpoint artifacts
are GBs — checksum throughput matters.

Copy of ``deepspeed_tpu/runtime/resilience/integrity.py`` for the
PyTorch port (it imports no JAX); the manifests of both packages are the
same format.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

from ...utils.logging import logger
from .fault_injection import get_fault_injector

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1

#: files never listed in a manifest (the manifest itself; 'latest' lives
#: one level up in the save dir)
_MANIFEST_EXCLUDE = frozenset({MANIFEST_NAME})

_CHUNK = 1 << 20


# ---------------------------------------------------------------------------
# atomic filesystem primitives
# ---------------------------------------------------------------------------
def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss.
    Best-effort on filesystems that refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """write-tmp → fsync → rename → fsync(dir): readers see the old
    content or the new content, never a prefix."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj, **json_kw) -> None:
    atomic_write_bytes(path, json.dumps(obj, **json_kw).encode("utf-8"))


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------
def file_checksum(path: str) -> Tuple[int, int]:
    """(size_bytes, crc32) of a file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return size, crc & 0xFFFFFFFF


def _walk_artifacts(tag_dir: str) -> List[str]:
    """Relative (posix) paths of every regular file under the tag dir,
    manifest excluded, sorted for a stable manifest."""
    out = []
    for root, _dirs, files in os.walk(tag_dir):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), tag_dir)
            rel = rel.replace(os.sep, "/")
            if rel in _MANIFEST_EXCLUDE or fn.startswith(".tmp") or \
                    ".tmp." in fn:
                continue
            out.append(rel)
    return sorted(out)


def write_manifest(tag_dir: str, extra: Optional[Dict] = None) -> Dict:
    """Fingerprint every artifact currently under ``tag_dir`` into an
    atomically-written ``manifest.json``; returns the manifest dict."""
    fi = get_fault_injector()
    entries = {}
    for rel in _walk_artifacts(tag_dir):
        full = os.path.join(tag_dir, rel)
        fi.check("checkpoint.artifact", path=full)
        size, crc = file_checksum(full)
        entries[rel] = {"size": size, "crc32": crc}
    manifest = {"version": MANIFEST_VERSION, "files": entries}
    if extra:
        manifest.update(extra)
    atomic_write_json(os.path.join(tag_dir, MANIFEST_NAME), manifest,
                      indent=2, sort_keys=True)
    return manifest


def verify_manifest(tag_dir: str) -> Tuple[bool, List[str]]:
    """Re-fingerprint the tag dir against its manifest.

    Returns (ok, problems). A tag with no manifest is NOT ok (either it
    predates the integrity layer — the caller may choose leniency — or
    the commit never finished); the problem list says which.
    """
    mpath = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return False, [f"no {MANIFEST_NAME} in {tag_dir} (uncommitted or "
                       f"pre-integrity checkpoint)"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"unreadable manifest {mpath}: {e}"]
    problems = []
    files = manifest.get("files", {})
    if not isinstance(files, dict):
        return False, [f"malformed manifest {mpath}: 'files' is "
                       f"{type(files).__name__}, not a dict"]
    for rel, want in files.items():
        try:
            want_size, want_crc = int(want["size"]), int(want["crc32"])
        except (TypeError, KeyError, ValueError):
            # bit-rot that kept the JSON valid: report, don't crash — a
            # damaged manifest is exactly what the fallback path is for
            problems.append(f"{rel}: malformed manifest entry {want!r}")
            continue
        full = os.path.join(tag_dir, rel)
        if not os.path.exists(full):
            problems.append(f"missing artifact {rel}")
            continue
        size, crc = file_checksum(full)
        if size != want_size:
            problems.append(f"{rel}: size {size} != recorded {want_size} "
                            f"(truncated/partial write)")
        elif crc != want_crc:
            problems.append(f"{rel}: crc32 {crc:#010x} != recorded "
                            f"{want_crc:#010x} (corrupt)")
    # artifacts that appeared after the commit are suspicious but not
    # corruption — the recorded set is what the load will read
    return not problems, problems


def has_manifest(tag_dir: str) -> bool:
    return os.path.exists(os.path.join(tag_dir, MANIFEST_NAME))


# ---------------------------------------------------------------------------
# tag discovery
# ---------------------------------------------------------------------------
def _tag_sort_key(save_dir: str, tag: str):
    """Newest-first ordering: recorded global_steps, then meta mtime."""
    meta = os.path.join(save_dir, tag, "meta.json")
    steps = -1
    try:
        with open(meta) as f:
            steps = int(json.load(f).get("global_steps", -1))
    except (OSError, ValueError, TypeError):
        pass
    try:
        mtime = os.path.getmtime(meta)
    except OSError:
        mtime = 0.0
    return (steps, mtime)


def list_tags(save_dir: str) -> List[str]:
    """Tag dirs under save_dir that at least have a meta.json, newest
    first by recorded step then mtime."""
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if os.path.exists(os.path.join(save_dir, d, "meta.json"))]
    return sorted(tags, key=lambda t: _tag_sort_key(save_dir, t),
                  reverse=True)


def find_newest_verified_tag(save_dir: str,
                             exclude: Tuple[str, ...] = (),
                             require_manifest: bool = True
                             ) -> Optional[str]:
    """Walk tags newest-first, return the first that verifies.

    Two passes: manifest-VERIFIED tags always win, even over newer
    manifest-less ones — a tag with meta.json but no manifest is either
    a pre-integrity legacy save or a commit that crashed between the
    meta and manifest writes, and the two are indistinguishable, so an
    unverifiable tag must never shadow an older verified one. With
    ``require_manifest=False`` a second pass accepts the newest
    manifest-less tag when NO tag verifies (legacy-only save dirs)."""
    candidates = [t for t in list_tags(save_dir) if t not in exclude]
    for tag in candidates:
        tag_dir = os.path.join(save_dir, tag)
        ok, problems = verify_manifest(tag_dir)
        if ok:
            return tag
        logger.warning(f"checkpoint tag {tag!r} failed verification "
                       f"({'; '.join(problems[:3])}) — continuing search")
    if not require_manifest:
        for tag in candidates:
            if not has_manifest(os.path.join(save_dir, tag)):
                logger.warning(
                    f"no tag in {save_dir} verifies; accepting "
                    f"manifest-less tag {tag!r} (legacy save) unverified")
                return tag
    return None
