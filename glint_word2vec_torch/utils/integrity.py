"""Checkpoint integrity manifests (own copy of ``glint_word2vec_tpu/utils/integrity.py``,
trimmed to what saving and loading a model directory, resuming a
training run and resuming a bulk transform need).

A snapshot directory carries ``manifest.json``: sha256 and byte size of
every small file, plus (version 2) the names of the table shard files,
each of which has its own ``<shard>.manifest.json`` sidecar. The format is
the JAX package's, so either package verifies what the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

MANIFEST_NAME = "manifest.json"
SHARD_MANIFEST_SUFFIX = ".manifest.json"

logger = logging.getLogger(__name__)


class CheckpointCorruptError(RuntimeError):
    """A snapshot directory failed integrity verification (missing
    files, size/hash mismatch, unparseable manifest, or partial dir)."""


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def build_manifest(
    dirpath: str, fnames: List[str], table_version: Optional[int] = None,
    table_dtype: Optional[str] = None,
) -> dict:
    """Hash and size every named file in ``dirpath`` into a manifest.
    ``table_dtype`` records the storage dtype the fp32 ``.npy`` payloads
    were rounded to."""
    files: Dict[str, dict] = {}
    for fname in fnames:
        p = os.path.join(dirpath, fname)
        files[fname] = {"sha256": _sha256_file(p), "size": os.path.getsize(p)}
    return {
        "version": 1,
        "table_version": table_version,
        "table_dtype": table_dtype,
        "files": files,
    }


def _write_json(out: str, obj: dict, fsync: bool) -> None:
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, out)


def write_manifest(dirpath: str, manifest: dict, *, fsync: bool = True) -> None:
    """Write ``manifest.json`` into ``dirpath`` (atomic replace)."""
    _write_json(os.path.join(dirpath, MANIFEST_NAME), manifest, fsync)


def build_shard_manifest(dirpath: str, fname: str,
                         table_version: Optional[int] = None) -> dict:
    """Hash and size ONE shard file into its sidecar manifest."""
    p = os.path.join(dirpath, fname)
    return {
        "version": 1,
        "table_version": table_version,
        "file": {"sha256": _sha256_file(p), "size": os.path.getsize(p)},
    }


def write_shard_manifest(dirpath: str, fname: str, manifest: dict, *,
                         fsync: bool = True) -> None:
    """Write ``<fname>.manifest.json`` next to its shard."""
    _write_json(os.path.join(dirpath, fname + SHARD_MANIFEST_SUFFIX),
                manifest, fsync)


def _check_entry(path: str, fname: str, ent: dict, what: str,
                 deep: bool = True) -> None:
    fp = os.path.join(path, fname)
    if not os.path.exists(fp):
        raise CheckpointCorruptError(f"{path}: missing {what} {fname}")
    size = os.path.getsize(fp)
    if size != ent["size"]:
        raise CheckpointCorruptError(
            f"{path}: {what} {fname} is {size} bytes, its manifest says "
            f"{ent['size']}"
        )
    if deep and _sha256_file(fp) != ent["sha256"]:
        raise CheckpointCorruptError(
            f"{path}: {what} {fname} sha256 mismatch (bit rot or torn write)"
        )


def _verify_shard(path: str, fname: str, *, deep: bool = True) -> None:
    mp = os.path.join(path, fname + SHARD_MANIFEST_SUFFIX)
    if not os.path.exists(os.path.join(path, fname)):
        raise CheckpointCorruptError(f"{path}: missing shard {fname}")
    if not os.path.exists(mp):
        raise CheckpointCorruptError(
            f"{path}: shard {fname} has no sidecar manifest"
        )
    try:
        with open(mp) as f:
            ent = json.load(f)["file"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable shard manifest for {fname} ({e})"
        )
    _check_entry(path, fname, ent, "shard", deep)


def verify_shard(path: str, fname: str, *, deep: bool = True) -> None:
    """One shard file against its sidecar manifest, raising
    :class:`CheckpointCorruptError` on any mismatch. ``deep=False`` checks
    existence and byte size only; ``deep=True`` re-hashes the payload. The
    bulk transform's resume scan (``batch/transform.py``) trusts exactly
    the committed-shard prefix that verifies."""
    _verify_shard(path, fname, deep=deep)


def verify_snapshot_dir(path: str) -> bool:
    """Verify a snapshot directory against its manifest.

    Checks the size and sha256 of every file the manifest and the shard
    sidecars name. True when the manifest exists and every entry
    matches; False for a legacy directory with no manifest (loadable,
    unverifiable). Raises :class:`CheckpointCorruptError` on any
    mismatch or a partial directory."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(f"{path}: not a directory")
    if not os.path.exists(os.path.join(path, "engine.json")):
        raise CheckpointCorruptError(f"{path}: partial snapshot (no engine.json)")
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        entries = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest ({e})")
    checks = ([lambda f=f: _verify_shard(path, f)
               for f in manifest.get("shard_files", ())]
              + [lambda f=f, e=e: _check_entry(path, f, e, "file")
                 for f, e in entries.items()])
    # One thread a file: sha256 releases the interpreter lock, so a
    # table's files hash side by side. The first failing file (in this
    # order) raises.
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(checks)))) as pool:
        for _ in pool.map(lambda check: check(), checks):
            pass
    return True


def resolve_train_state(checkpoint_dir: str) -> Optional[dict]:
    """The newest committed training state whose snapshot verifies.

    Reads ``train_state.json`` and tries the current record, then the
    previous committed one it carries under ``"prev"`` (keep-last-2
    retention). Returns the first record (without ``"prev"``) whose
    snapshot directory passes :func:`verify_snapshot_dir`, logging one
    line per rejected candidate; ``None`` when there is no state file.
    Raises :class:`CheckpointCorruptError` when a state file exists but
    no candidate verifies: a silent restart from scratch would train
    over committed progress."""
    state_path = os.path.join(checkpoint_dir, "train_state.json")
    if not os.path.exists(state_path):
        return None
    with open(state_path) as f:
        state = json.load(f)
    candidates = [state]
    prev = state.get("prev")
    if prev and prev.get("ckpt"):
        candidates.append(prev)
    reasons = []
    for i, rec in enumerate(candidates):
        try:
            verify_snapshot_dir(os.path.join(checkpoint_dir, rec["ckpt"]))
        except (CheckpointCorruptError, KeyError) as e:
            reasons.append(str(e))
            logger.error(
                "checkpoint %s failed integrity verification (%s)%s",
                rec.get("ckpt"), e,
                "; falling back to the previous committed snapshot"
                if i + 1 < len(candidates) else "",
            )
            continue
        if i > 0:
            logger.warning(
                "resuming from fallback checkpoint %s (epoch %s): the "
                "newest committed snapshot did not verify",
                rec["ckpt"], rec.get("epochs_completed"),
            )
        return {k: v for k, v in rec.items() if k != "prev"}
    raise CheckpointCorruptError(
        f"no verifiable committed checkpoint in {checkpoint_dir}: "
        + " | ".join(reasons)
    )
