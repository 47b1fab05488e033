"""Crash-durable sketch checkpoints: atomic snapshot files for arenas.

Counterpart of `veneur_tpu.core.checkpoint`, byte-compatible with it
both ways: a checkpoint either package writes restores into the other.
Every sampler family is a mergeable summary (t-digest centroids, HLL
registers, exact counter sums), so a periodic snapshot composes exactly
on restart: restore the arenas, resume the interval, and a crash loses
at most one checkpoint period of ingest instead of everything.

File format: one numpy .npz (zip container, per-entry CRC32) holding
the flattened state arrays plus a single `__meta__` entry, the
JSON-encoded key tables, scalar counts and the cardinality guard's quota
ledger.  Writes are atomic: serialize into `<name>.tmp` in the same
directory, flush and fsync, then os.replace onto the final name, so a
crash mid-write leaves the previous checkpoint intact.  `read_checkpoint`
treats an unreadable, corrupt or foreign-version file as absent (logged,
never fatal): a cold start.  Every path that opens the tempfile
(`open_checkpoint_tmp`) ends in `commit_checkpoint` or
`discard_checkpoint`.
"""

from __future__ import annotations

import io
import json
import logging
import os
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("veneur_tpu_torch.core.checkpoint")

CHECKPOINT_NAME = "checkpoint.ckpt"
MARKER_NAME = "last_flush"
_META_KEY = "__meta__"
FORMAT_VERSION = 1


def checkpoint_path(directory: str) -> str:
    return os.path.join(directory, CHECKPOINT_NAME)


def write_flush_marker(directory: str, flush_count: int) -> None:
    """Stamp that flush `flush_count` completed (its sink and forward
    hand-off happened and the arenas were reset).  A checkpoint whose
    interval is older than the marker must not restore its arenas: the
    data was already delivered, and a revived sender would re-forward
    it under a fresh boot nonce the dedup ledger cannot recognize.  A
    small atomic-rename write per flush, without fsync: the threat is
    process death, which keeps OS-buffered writes."""
    tmp = os.path.join(directory, MARKER_NAME + ".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps({"flush_count": int(flush_count),
                            "unix": time.time()}))
    os.replace(tmp, os.path.join(directory, MARKER_NAME))


def read_flush_marker(directory: str) -> Optional[dict]:
    path = os.path.join(directory, MARKER_NAME)
    try:
        with open(path) as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def open_checkpoint_tmp(directory: str):
    """Create the checkpoint tempfile for writing; pair it with
    commit_checkpoint or discard_checkpoint on every path."""
    os.makedirs(directory, exist_ok=True)
    tmp_path = checkpoint_path(directory) + ".tmp"
    return open(tmp_path, "wb"), tmp_path


def commit_checkpoint(f, tmp_path: str, final_path: str) -> None:
    """Flush and fsync the tempfile, close it, and rename it onto the
    live checkpoint: the only way checkpoint bytes become visible to a
    restart."""
    try:
        f.flush()
        os.fsync(f.fileno())
    finally:
        f.close()
    os.replace(tmp_path, final_path)


def discard_checkpoint(f, tmp_path: str) -> None:
    """Error path: close and remove the tempfile, so a failed write is
    never mistaken for a checkpoint."""
    try:
        f.close()
    finally:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass


def write_checkpoint(directory: str, meta: dict,
                     arrays: dict[str, np.ndarray]) -> int:
    """Serialize (meta, arrays) atomically into `directory`; returns the
    bytes written.  Raises OSError on a disk failure (the server counts
    it and keeps the previous checkpoint)."""
    meta = dict(meta)
    meta["format_version"] = FORMAT_VERSION
    meta["written_unix"] = time.time()
    payload = dict(arrays)
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    data = buf.getvalue()
    f, tmp_path = open_checkpoint_tmp(directory)
    try:
        f.write(data)
    except BaseException:
        discard_checkpoint(f, tmp_path)
        raise
    commit_checkpoint(f, tmp_path, checkpoint_path(directory))
    return len(data)


def read_checkpoint(directory: str) -> Optional[tuple[dict, dict]]:
    """Load the live checkpoint: (meta, arrays), or None when it is
    absent, unreadable or of another format version (logged; a damaged
    checkpoint must never wedge a boot)."""
    path = checkpoint_path(directory)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            if meta.get("format_version") != FORMAT_VERSION:
                logger.warning(
                    "checkpoint %s has format %s (want %s); ignoring",
                    path, meta.get("format_version"), FORMAT_VERSION)
                return None
            arrays = {k: z[k] for k in z.files if k != _META_KEY}
    except Exception as e:   # noqa: BLE001 - any damage is a cold start
        logger.error("checkpoint %s is unreadable (%s); cold start",
                     path, e)
        return None
    return meta, arrays
