"""Metric arenas: batched per-family state instead of per-key samplers.

Counterpart of `veneur_tpu.core.arena`.  Each sampler family is an
arena: a key dictionary mapping (MetricKey, scope) -> row, plus columnar
state where row i is that key's sampler.  Counters, gauges, status
checks and, unmeshed, sets (HLL registers) live on the host; digests
stage their interval's weighted points on the host and evaluate on the
device once per flush (`DigestArena.build_dense` -> `put_dense*` ->
`parallel/serving.py`).  With a mesh (`parallel/mesh.py`) the counters
keep one host lane per replica, uploaded as (hi, lo) float32 planes at
each flush, the sets keep device register lanes (rows over the shard
axis, lanes over the replica axis), and the digest dense build takes
the mesh's shard-ordered row layout.  The moments family
(`MomentsArena`) stages the same way and evaluates through
`ops/moments_eval.py`, and the compactor family (`CompactorArena`)
folds its staged samples into per-row ladders through kernel B6
(`ops/compactor_eval.py`).

Rows persist across intervals; `end_interval` resets the touched mask
and recycles rows idle for IDLE_GC_INTERVALS flushes.  The checkpoint
arrays (`checkpoint_state` / `restore_state`) use the JAX package's
names and layouts, so either package restores the other's cut.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from veneur_tpu_torch.parallel import serving
from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
from veneur_tpu_torch.sketches import compactor as cs
from veneur_tpu_torch.sketches import hll as hll_mod
from veneur_tpu_torch.sketches import moments as mo
from veneur_tpu_torch.sketches import tdigest as td

# staged depth beyond which a row pre-reduces into <= C weighted points
# (bounds the flush dense matrix width)
DENSE_DEPTH_CAP = 512
# staged points above which the dense build fills through the native
# single-pass fill (`ingest.fill_dense`) instead of numpy's argsort and
# scatter (`_NATIVE_FILL_MIN` of the JAX package)
_NATIVE_FILL_MIN = 65536
# per-row column bound inside one pre-reduction launch
HOT_CHUNK_WIDTH = 16_384
# dense-matrix element bound per pre-reduction launch
HOT_DENSE_BUDGET = 1 << 23
# flush intervals a key may stay untouched before its row is recycled
IDLE_GC_INTERVALS = 10
_INITIAL_CAPACITY = 1024


class CheckpointIncompatible(ValueError):
    """The checkpoint was written under a different sketch configuration
    (set precision, digest compression); raised before any arena
    mutates."""


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


@dataclass
class RowMeta:
    key: MetricKey
    tags: list[str]
    scope: MetricScope


class _ArenaBase:
    """Key dictionary + row lifecycle shared by all arenas."""

    _TRACK_KIND = False  # DigestArena opts in (kind_col)

    def __init__(self, capacity: int = _INITIAL_CAPACITY):
        self.capacity = capacity
        self.kdict: dict[tuple[MetricKey, MetricScope], int] = {}
        self.meta: list[Optional[RowMeta]] = [None] * capacity
        self.name_col = np.empty(capacity, object)
        self.tags_col = np.empty(capacity, object)
        # per-row hash(name): the query plane's window slots find a key
        # by ONE vectorized int64 compare over this column.  Python's
        # str hash is salted per process, so the column is compared
        # within one process only and never serialized
        self.name_hash_col = np.zeros(capacity, np.int64)
        self.kind_col = (np.empty(capacity, object)
                         if self._TRACK_KIND else None)
        self.scope_col = np.zeros(capacity, np.int8)
        self.touched = np.zeros(capacity, bool)
        self.idle = np.zeros(capacity, np.int32)
        self._free: list[int] = list(range(capacity - 1, -1, -1))

    def _grow(self) -> None:
        old = self.capacity
        self.capacity = old * 2
        self.meta.extend([None] * old)
        self.name_col = np.concatenate([self.name_col,
                                        np.empty(old, object)])
        self.tags_col = np.concatenate([self.tags_col,
                                        np.empty(old, object)])
        self.name_hash_col = np.concatenate([self.name_hash_col,
                                             np.zeros(old, np.int64)])
        if self.kind_col is not None:
            self.kind_col = np.concatenate([self.kind_col,
                                            np.empty(old, object)])
        self.scope_col = np.concatenate([self.scope_col,
                                         np.zeros(old, np.int8)])
        self.touched = np.concatenate([self.touched, np.zeros(old, bool)])
        self.idle = np.concatenate([self.idle, np.zeros(old, np.int32)])
        self._free.extend(range(self.capacity - 1, old - 1, -1))
        self._grow_state(old)

    def _grow_state(self, old_capacity: int) -> None:
        raise NotImplementedError

    def _init_mesh_lanes(self, mesh, family: str) -> int:
        """Mesh plumbing shared by the meshed arenas (`arena.py:144-160`
        of the JAX package): check that the key shards divide the
        capacity, keep the mesh, and return the replica count (the lane
        count of the families whose lanes feed the replica axis)."""
        from veneur_tpu_torch.parallel.mesh import REPLICA_AXIS, SHARD_AXIS
        self.mesh = mesh
        if mesh is None:
            return 1
        if self.capacity % mesh.shape[SHARD_AXIS]:
            raise ValueError(
                f"{family} arena capacity {self.capacity} not divisible "
                f"by {mesh.shape[SHARD_AXIS]} key shards")
        return mesh.shape[REPLICA_AXIS]

    def _register(self, key: MetricKey, scope: MetricScope,
                  tags: list[str], row: int) -> None:
        self.kdict[(key, scope)] = row
        self.meta[row] = RowMeta(key=key, tags=tags, scope=scope)
        self.name_col[row] = key.name
        self.tags_col[row] = tags
        self.name_hash_col[row] = hash(key.name)
        if self.kind_col is not None:
            self.kind_col[row] = key.type
        self.scope_col[row] = int(scope)

    def row_for(self, key: MetricKey, scope: MetricScope,
                tags: list[str]) -> int:
        """Upsert: find or allocate the row for (key, scope)."""
        row = self.kdict.get((key, scope))
        if row is None:
            if not self._free:
                self._grow()
            row = self._free.pop()
            self._register(key, scope, tags, row)
            self.idle[row] = 0
        self.touched[row] = True
        return row

    def touched_rows(self) -> np.ndarray:
        return np.nonzero(self.touched)[0]

    def end_interval(self) -> None:
        """Reset touched state and recycle idle rows (after flush)."""
        self.idle[self.touched] = 0
        self.idle[~self.touched] += 1
        dead = np.nonzero((self.idle >= IDLE_GC_INTERVALS)
                          & (self.name_col != None))[0]  # noqa: E711
        for row in dead:
            m = self.meta[row]
            self._clear_row(row)
            del self.kdict[(m.key, m.scope)]
            self._free.append(int(row))
        self.touched[:] = False

    def _clear_row(self, row: int) -> None:
        self.meta[row] = None
        self.name_col[row] = None
        self.tags_col[row] = None
        self.name_hash_col[row] = 0
        if self.kind_col is not None:
            self.kind_col[row] = None
        self.scope_col[row] = 0
        self.idle[row] = 0

    def release_keys(self, dks: list) -> int:
        """Recycle the rows of the given (MetricKey, scope) pairs now
        (cube group eviction): clear their metadata, zero their state in
        ONE batched `reset_rows` and return them to the free list; the
        eager form of the idle GC in end_interval.  Call under the
        aggregator lock, after the flush snapshot has copied what it
        needs.  (The JAX package also folds the key fingerprints of its
        multi-controller lockstep check out here; this package keeps no
        fingerprints.)  Returns the number of rows released."""
        rows: list[int] = []
        for dk in dks:
            row = self.kdict.pop(dk, None)
            if row is None:
                continue
            self._clear_row(row)
            self.touched[row] = False
            self._free.append(int(row))
            rows.append(int(row))
        if rows:
            self.reset_rows(np.asarray(rows, np.int64))
        return len(rows)

    # -- checkpoint ----------------------------------------------------------

    def checkpoint_state(self) -> tuple[dict, dict]:
        """(meta, arrays) of the key table + family state (call under the
        aggregator lock, after sync()).  Same keys as the JAX package's
        arenas write."""
        return self.checkpoint_render(self.checkpoint_capture())

    def checkpoint_capture(self) -> dict:
        """The lock-held half of a checkpoint (`arena.py:272-292` of the
        JAX package): copies only (the key table's items, fancy-indexed
        columns, the family's state arrays), so the ingest path never
        queues behind the per-key rendering."""
        items = list(self.kdict.items())
        rows = np.fromiter((r for _, r in items), np.int64, len(items))
        extra: dict = {}
        self._checkpoint_extra(extra)
        return {"items": items, "tags": self.tags_col[rows].copy(),
                "rows": rows, "idle": self.idle[rows].copy(),
                "touched": self.touched[rows].copy(),
                "capacity": int(self.capacity),
                "arrays": self._checkpoint_arrays(), "extra": extra}

    @staticmethod
    def checkpoint_render(cap: dict) -> tuple[dict, dict]:
        """The lock-free half: render the captured key table to numpy
        string and int arrays.  MetricKeys are immutable and a row's
        tags list is never mutated in place, so the captured references
        stay coherent after the lock is released."""
        items = cap["items"]

        def strs(lst):
            return (np.asarray(lst, dtype=np.str_) if lst
                    else np.zeros(0, "<U1"))

        arrays = dict(cap["arrays"])
        arrays.update({
            "key_names": strs([k.name for (k, _), _ in items]),
            "key_types": strs([k.type for (k, _), _ in items]),
            "key_jtags": strs([k.joined_tags for (k, _), _ in items]),
            "key_tags": strs([",".join(t or []) for t in cap["tags"]]),
            "key_scopes": np.asarray([int(s) for (_, s), _ in items],
                                     np.int8),
            "key_rows": cap["rows"],
            "key_idle": cap["idle"],
            "key_touched": cap["touched"],
        })
        meta = {"capacity": cap["capacity"]}
        meta.update(cap["extra"])
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> None:
        """Rebuild from a checkpoint into this (fresh) arena: rows land at
        their recorded indices and the free list excludes them."""
        if self.kdict:
            raise RuntimeError(
                "checkpoint restore requires a fresh arena "
                f"({len(self.kdict)} keys already registered)")
        while self.capacity < int(meta["capacity"]):
            self._grow()
        used = set()
        for name, mtype, jtags, scope_i, row, tags_joined, idle, \
                touched in zip(arrays["key_names"], arrays["key_types"],
                               arrays["key_jtags"], arrays["key_scopes"],
                               arrays["key_rows"], arrays["key_tags"],
                               arrays["key_idle"], arrays["key_touched"]):
            key = MetricKey(str(name), str(mtype), str(jtags))
            row = int(row)
            tags = str(tags_joined).split(",") if tags_joined else []
            self._register(key, MetricScope(int(scope_i)), tags, row)
            self.idle[row] = int(idle)
            self.touched[row] = bool(touched)
            used.add(row)
        self._free = [r for r in range(self.capacity - 1, -1, -1)
                      if r not in used]
        self._restore_arrays(meta, arrays)

    def _checkpoint_arrays(self) -> dict:
        raise NotImplementedError

    def _checkpoint_extra(self, meta: dict) -> None:
        """Hook for family-specific JSON-able state."""

    def restore_precheck(self, meta: dict, arrays: dict) -> None:
        """Raise CheckpointIncompatible before any mutation when the
        checkpoint cannot restore into this configuration."""

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        raise NotImplementedError

    @staticmethod
    def _restore_into(dst: np.ndarray, src: np.ndarray) -> None:
        """Copy a checkpointed array into the (possibly larger) live array
        along the capacity (last) axis."""
        if src.ndim == 1:
            dst[:len(src)] = src
        else:
            dst[:, :src.shape[1]] = src


class CounterArena(_ArenaBase):
    """int64 counters (samplers/samplers.go:97-150), accumulated on the
    host in float64 (integer-exact below 2^53) as `[lanes, capacity]`
    stripes, lane = row % lanes: one lane unmeshed, one per replica
    with a mesh.  At a meshed flush the lanes upload as (hi, lo) float32
    planes (value = hi * 2^24 + lo, each plane exact below 2^24, so the
    device total is exact below 2^48) and the flush program sums them
    over the replica axis, the collective form of Counter.Merge
    (`samplers/samplers.go:143-145`)."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY, mesh=None):
        super().__init__(capacity)
        self.n_lanes = self._init_mesh_lanes(mesh, "counter")
        self.values = np.zeros((self.n_lanes, capacity), np.float64)

    def _grow_state(self, old: int) -> None:
        self.values = np.concatenate(
            [self.values, np.zeros((self.n_lanes, old), np.float64)], axis=1)

    def sample(self, row: int, value: float, sample_rate: float) -> None:
        # Sample divides by rate at ingest (samplers.go:109-111)
        self.values[row % self.n_lanes, row] += int(value / sample_rate)

    def sample_batch(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Columnar counter increments already divided by their sample
        rates (the native drain, `ingest.NativeIngest`)."""
        np.add.at(self.values, (rows % self.n_lanes, rows), vals)

    def merge(self, row: int, value: int) -> None:
        self.values[row % self.n_lanes, row] += value

    def merge_batch(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Vectorized merges (duplicate rows accumulate); marks the rows
        touched."""
        np.add.at(self.values, (rows % self.n_lanes, rows), vals)
        self.touched[rows] = True

    def snapshot_values(self) -> np.ndarray:
        """Host copy of the lane stripes (under the aggregator lock,
        before reset zeroes them)."""
        return self.values.copy()

    def planes_from(self, vals: np.ndarray) -> list:
        """The (hi, lo) split of snapshotted lane stripes as `[lanes,
        capacity, 2]` float32, placed on the mesh (lane r's rows of
        shard s on mesh.devices[s][r]): the flush program's counter
        operand.  Meshed only."""
        hi = np.floor(vals / serving.COUNTER_SPLIT)
        lo = vals - hi * serving.COUNTER_SPLIT
        planes = np.stack([hi, lo], axis=-1).astype(np.float32)
        return serving.place_rows(self.mesh, planes)

    def reset_rows(self, rows: np.ndarray) -> None:
        self.values[:, rows] = 0

    def _checkpoint_arrays(self) -> dict:
        return {"values": self.values.copy()}

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        src = arrays["values"]
        if src.shape[0] != self.n_lanes:
            # the lane layout changed across the restart (mesh
            # reconfiguration): counter lanes are additive, so fold
            folded = np.zeros((self.n_lanes, src.shape[1]), np.float64)
            for lane in range(src.shape[0]):
                folded[lane % self.n_lanes] += src[lane]
            src = folded
        self._restore_into(self.values, src)


class GaugeArena(_ArenaBase):
    """Last-write-wins gauges (samplers/samplers.go:152-202)."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY):
        super().__init__(capacity)
        self.values = np.zeros(capacity, np.float64)

    def _grow_state(self, old: int) -> None:
        self.values = np.concatenate([self.values, np.zeros(old)])

    def sample(self, row: int, value: float) -> None:
        self.values[row] = value

    merge = sample  # Merge overwrites (samplers.go:200-202)

    def merge_batch(self, rows: np.ndarray, vals: np.ndarray) -> None:
        """Vectorized merges, last write wins; marks the rows touched.
        NumPy leaves fancy assignment with repeated indices unspecified,
        so each row keeps its last occurrence first."""
        if len(rows) > 1:
            # np.unique over the reversed rows keeps each row's first
            # reversed occurrence, the last original one
            uniq, rev_first = np.unique(rows[::-1], return_index=True)
            if len(uniq) != len(rows):
                rows = uniq
                vals = vals[len(vals) - 1 - rev_first]
        self.values[rows] = vals
        self.touched[rows] = True

    def reset_rows(self, rows: np.ndarray) -> None:
        self.values[rows] = 0

    def _checkpoint_arrays(self) -> dict:
        return {"values": self.values.copy()}

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        self._restore_into(self.values, arrays["values"])


class StatusArena(_ArenaBase):
    """Service-check state: last value + message + hostname
    (samplers/samplers.go:210-231)."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY):
        super().__init__(capacity)
        self.values = np.zeros(capacity, np.float64)
        self.messages: dict[int, str] = {}
        self.hostnames: dict[int, str] = {}

    def _grow_state(self, old: int) -> None:
        self.values = np.concatenate([self.values, np.zeros(old)])

    def sample(self, row: int, value: float, message: str,
               hostname: str) -> None:
        self.values[row] = value
        self.messages[row] = message
        self.hostnames[row] = hostname

    def reset_rows(self, rows: np.ndarray) -> None:
        self.values[rows] = 0
        for r in rows:
            self.messages.pop(int(r), None)
            self.hostnames.pop(int(r), None)

    def _checkpoint_arrays(self) -> dict:
        return {"values": self.values.copy()}

    def _checkpoint_extra(self, meta: dict) -> None:
        meta["messages"] = {str(r): m for r, m in self.messages.items()}
        meta["hostnames"] = {str(r): h for r, h in self.hostnames.items()}

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        self._restore_into(self.values, arrays["values"])
        self.messages = {int(r): str(m)
                         for r, m in (meta.get("messages") or {}).items()}
        self.hostnames = {int(r): str(h)
                          for r, h in (meta.get("hostnames") or {}).items()}


class SetArena(_ArenaBase):
    """Unique-count sets as HLL register rows (Set sampler,
    `samplers/samplers.go:242-311`).

    Unmeshed, the registers live on the host (`[capacity, m]` uint8):
    inserts are one vectorized `np.maximum.at`, merges a register-wise
    max, estimates the batched numpy LogLog-Beta.

    With a mesh they are device lanes (`lanes_regs`, a grid: lane r's
    registers of shard s's row block on mesh.devices[s][r]); staged
    inserts scatter-max into a round-robin lane at each sync, and the
    flush program unions the lanes over the replica axis and estimates
    every row at once, the collective form of Set.Merge
    (`samplers/samplers.go:299-311`).  The flush reads a copy of the
    lanes taken at the cut (`snapshot_lanes`); see the lane operations
    in `parallel/serving.py`."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY,
                 precision: int = hll_mod.DEFAULT_PRECISION,
                 legacy_migration: bool = False, mesh=None):
        super().__init__(capacity)
        self.precision = precision
        self.m = 1 << precision
        self.n_lanes = self._init_mesh_lanes(mesh, "set")
        if mesh is None:
            self.host_regs = np.zeros((capacity, self.m), np.uint8)
            self.lanes_regs = None
        else:
            self.host_regs = None
            self.lanes_regs = serving.place_rows(
                mesh, np.zeros((self.n_lanes, capacity, self.m), np.uint8))
        # rolling-upgrade lane for legacy 'VH' (blake2b-hashed) imports:
        # kept apart on the host, the estimate is max(primary, legacy)
        self.legacy_migration = legacy_migration
        self._legacy_regs: dict[int, np.ndarray] = {}
        self._seq = 0
        self._stage_rows: list[int] = []
        self._stage_hashes: list[int] = []
        # (rows, uint64 member hashes) batches staged already hashed
        self._stage_chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self._merge_rows: dict[int, np.ndarray] = {}

    def _grow_state(self, old: int) -> None:
        if self.host_regs is not None:
            self.host_regs = np.concatenate(
                [self.host_regs, np.zeros((old, self.m), np.uint8)], axis=0)
            return
        # the shard blocks move with the capacity: re-place every lane
        lanes = np.zeros((self.n_lanes, self.capacity, self.m), np.uint8)
        lanes[:, :old] = serving.lanes_to_host(self.lanes_regs)
        self.lanes_regs = serving.place_rows(self.mesh, lanes)

    def sample(self, row: int, member: str) -> None:
        self._stage_rows.append(row)
        self._stage_hashes.append(hll_mod.hash64(member.encode()))

    def stage_hash_batch(self, rows: np.ndarray, hashes: np.ndarray) -> None:
        """Stage members already metro-hashed (uint64), one per row."""
        self._stage_chunks.append((np.asarray(rows, np.int64),
                                   np.asarray(hashes, np.uint64)))

    def staged_count(self) -> int:
        return (len(self._stage_rows)
                + sum(len(r) for r, _ in self._stage_chunks)
                + len(self._merge_rows))

    def merge(self, row: int, payload: bytes) -> None:
        other, legacy = hll_mod.unmarshal_ex(payload)
        lane = (self._legacy_regs if legacy and self.legacy_migration
                else self._merge_rows)
        mine = lane.get(row)
        if mine is None:
            lane[row] = other.copy()
        else:
            np.maximum(mine, other, out=mine)

    def legacy_estimates(self, rows: np.ndarray) -> "np.ndarray | None":
        """Per-row estimates of the migration lane (0 where a row has no
        legacy imports), or None when the lane is idle."""
        if not self._legacy_regs:
            return None
        out = np.zeros(len(rows), np.float64)
        hits = [(i, self._legacy_regs[int(r)]) for i, r in enumerate(rows)
                if int(r) in self._legacy_regs]
        if hits:
            ests = hll_mod.estimate_np_rows(
                np.stack([regs for _, regs in hits]))
            for (i, _), e in zip(hits, ests):
                out[i] = e
        return out

    def sync(self) -> None:
        """Fold staged inserts and imported rows into the registers (a
        meshed arena: each batch into the next lane, round-robin)."""
        if self._stage_rows or self._stage_chunks:
            parts = self._stage_chunks + [
                (np.asarray(self._stage_rows, np.int64),
                 np.asarray(self._stage_hashes, np.uint64))]
            self._stage_rows, self._stage_hashes = [], []
            self._stage_chunks = []
            rows = np.concatenate([r for r, _ in parts])
            idx, rank = hll_mod.split_hashes(
                np.concatenate([h for _, h in parts]), self.precision)
            if self.host_regs is not None:
                np.maximum.at(self.host_regs, (rows, idx), rank)
            else:
                serving.set_lane_scatter(self.lanes_regs, rows, idx, rank,
                                         self._next_lane())
        if self._merge_rows:
            items = sorted(self._merge_rows.items())
            self._merge_rows = {}
            if self.host_regs is not None:
                for row, regs in items:
                    np.maximum(self.host_regs[row], regs,
                               out=self.host_regs[row])
            else:
                serving.set_lane_merge_rows(
                    self.lanes_regs, np.asarray([r for r, _ in items]),
                    np.stack([regs for _, regs in items]),
                    self._next_lane())

    def _next_lane(self) -> int:
        lane = self._seq % self.n_lanes
        self._seq += 1
        return lane

    def snapshot_lanes(self) -> list:
        """Meshed only, under the aggregator lock: sync, then a copy of
        the lane grid for the flush program to read.  Later updates
        write the live lanes in place and never this copy."""
        self.sync()
        return [[t.clone() for t in row] for row in self.lanes_regs]

    def host_estimates(self, rows: np.ndarray) -> np.ndarray:
        """Unmeshed only: estimates of the given rows (sync first)."""
        self.sync()
        return hll_mod.estimate_np_rows(self.host_regs[rows])

    def host_regs_copy(self, rows: np.ndarray) -> np.ndarray:
        return self.host_regs[rows].copy()

    def reset_rows(self, rows: np.ndarray) -> None:
        self.sync()
        for r in rows:
            self._legacy_regs.pop(int(r), None)
        if self.host_regs is not None:
            if len(rows):
                self.host_regs[rows] = 0
        else:
            serving.set_reset_rows(self.lanes_regs, rows)

    def _checkpoint_arrays(self) -> dict:
        # only live rows serialize (16 KiB a row per lane at p = 14)
        live = np.asarray(sorted(self.kdict.values()), np.int64)
        out = {"reg_rows": live}
        if self.host_regs is not None:
            out["host_regs"] = self.host_regs[live].copy()
        else:
            out["lanes_regs"] = serving.lanes_to_host(
                self.lanes_regs)[:, live]
        if self._legacy_regs:
            rows = sorted(self._legacy_regs)
            out["legacy_rows"] = np.asarray(rows, np.int64)
            out["legacy_regs"] = np.stack(
                [self._legacy_regs[r] for r in rows])
        return out

    def _checkpoint_extra(self, meta: dict) -> None:
        meta["precision"] = int(self.precision)

    def restore_precheck(self, meta: dict, arrays: dict) -> None:
        if int(meta.get("precision", self.precision)) != self.precision:
            raise CheckpointIncompatible(
                f"set checkpoint precision {meta.get('precision')} != "
                f"configured {self.precision}")

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        rows = arrays.get("reg_rows")
        if rows is not None and len(rows):
            rows = rows.astype(np.int64, copy=False)
            if self.host_regs is not None:
                if "host_regs" in arrays:
                    self.host_regs[rows] = arrays["host_regs"]
                elif "lanes_regs" in arrays:
                    # a meshed or device-resident cut: union the lanes
                    self.host_regs[rows] = arrays["lanes_regs"].max(axis=0)
            else:
                # onto device lanes (`arena.py:905-925` of the JAX
                # package): an unmeshed cut lands in lane 0, a meshed
                # one folds lane by lane (the flush unions them anyway)
                if "host_regs" in arrays:
                    src = arrays["host_regs"][None]
                elif "lanes_regs" in arrays:
                    src = arrays["lanes_regs"]
                else:
                    src = np.zeros((0, len(rows), self.m), np.uint8)
                lanes = serving.lanes_to_host(self.lanes_regs)
                for lane in range(src.shape[0]):
                    tgt = lane % self.n_lanes
                    lanes[tgt, rows] = np.maximum(lanes[tgt, rows],
                                                  src[lane])
                self.lanes_regs = serving.place_rows(self.mesh, lanes)
        if "legacy_rows" in arrays:
            self._legacy_regs = {
                int(r): regs.copy() for r, regs in
                zip(arrays["legacy_rows"], arrays["legacy_regs"])}


class DigestArena(_ArenaBase):
    """All histogram/timer digests as host-staged weighted points plus
    host scalar accumulators; one device launch per flush evaluates every
    touched key (parallel/serving.py).

    An interval's samples — and imported digest centroids (`Histo.Merge`,
    `samplers/samplers.go:539-543`), which are just weighted points —
    accumulate in host COO staging; the flush uploads one compact dense
    `[K_t, D]` matrix (touched rows only, D = pow2 of the deepest row)
    and reads back one evaluation.  Keys whose staged depth outgrows
    DENSE_DEPTH_CAP pre-reduce on the device into <= C weighted points
    (`serving.partial_digests`) and re-stage.

    The host tracks the true digest scalars (min/max/rsum, exact f64
    totals) and the local-samples-only accumulators behind the
    mixed-scope flush duality (`samplers/samplers.go:315-342`)."""

    _TRACK_KIND = True  # forwarding needs histogram-vs-timer per row

    def __init__(self, capacity: int = _INITIAL_CAPACITY,
                 compression: float = td.DEFAULT_COMPRESSION,
                 device=None, bf16_staging: bool = False, mesh=None):
        from veneur_tpu_torch import resolve_device
        from veneur_tpu_torch.parallel.mesh import SHARD_AXIS
        super().__init__(capacity)
        if mesh is not None and bf16_staging:
            raise ValueError(
                "digest_bf16_staging is unsupported with a device mesh "
                "(the meshed flush program is f32-native); drop one")
        # the meshed dense build: rows in shard order, each shard's block
        # a replica multiple, depth a replica multiple (put_dense_sharded)
        self.n_replicas = self._init_mesh_lanes(mesh, "digest")
        self.n_shards = 1 if mesh is None else mesh.shape[SHARD_AXIS]
        self.device = mesh.home if mesh is not None else resolve_device(
            device)
        self.compression = compression
        self.ccap = td.centroid_capacity(compression)
        # bf16 staging (digest_bf16_staging): the dense VALUE matrix
        # uploads as bfloat16, half the flush's largest upload, bounding
        # quantile values to bf16's ~2^-8 relative rounding; weights and
        # min/max stay float32 (they feed exact accumulations), and the
        # host staging and checkpoints stay float64
        self.stage_dtype = torch.bfloat16 if bf16_staging else torch.float32
        # general (weighted) builds stage bf16 values too, which routes
        # rows of depth <= 64 to B4 (serving.digest_eval); the JAX
        # package does so on unmeshed tiers only, and this one is
        self.compact_general = bool(bf16_staging)
        self.d_min = np.full(capacity, np.inf)
        self.d_max = np.full(capacity, -np.inf)
        self.d_rsum = np.zeros(capacity)
        self.d_weight = np.zeros(capacity)
        self.d_sum = np.zeros(capacity)
        self.l_weight = np.zeros(capacity)
        self.l_min = np.full(capacity, np.inf)
        self.l_max = np.full(capacity, -np.inf)
        self.l_sum = np.zeros(capacity)
        self.l_rsum = np.zeros(capacity)
        # raw COO staging (scalars not yet applied)
        self._rows: list[int] = []
        self._vals: list[float] = []
        self._wts: list[float] = []
        self._local: list[bool] = []
        # columnar batches of local samples (sample_batch)
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # consolidated interval accumulator + per-row staged depth
        self._acc: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._depth = np.zeros(capacity, np.int64)
        # False while every staged weight this interval is exactly 1.0:
        # the flush then takes the depth-vector program (B3)
        self._staged_nonuniform = False
        # dense builds through the native fill, and native fills that
        # dropped a point (a broken invariant) and went to numpy instead
        self.dense_fill_native = 0
        self.dense_fill_fallbacks = 0

    def _grow_state(self, old: int) -> None:
        def pad(a, fill):
            return np.concatenate([a, np.full(old, fill, a.dtype)])
        self.d_min = pad(self.d_min, np.inf)
        self.d_max = pad(self.d_max, -np.inf)
        self.d_rsum = pad(self.d_rsum, 0)
        self.d_weight = pad(self.d_weight, 0)
        self.d_sum = pad(self.d_sum, 0)
        self.l_weight = pad(self.l_weight, 0)
        self.l_min = pad(self.l_min, np.inf)
        self.l_max = pad(self.l_max, -np.inf)
        self.l_sum = pad(self.l_sum, 0)
        self.l_rsum = pad(self.l_rsum, 0)
        self._depth = pad(self._depth, 0)

    # -- staging -------------------------------------------------------------

    def sample(self, row: int, value: float, sample_rate: float) -> None:
        """A locally observed sample (Histo.Sample, samplers.go:331-342)."""
        w = 1.0 / sample_rate
        if w != 1.0:
            self._staged_nonuniform = True
        self._rows.append(row)
        self._vals.append(value)
        self._wts.append(w)
        self._local.append(True)

    def merge_digest(self, row: int, means, weights, dmin: float,
                     dmax: float, drsum: float) -> None:
        """Fold a forwarded digest into a row (Histo.Merge,
        samplers.go:539-543): centroids re-stage as weighted points,
        scalars merge exactly from the wire values."""
        self._rows.extend([row] * len(means))
        self._vals.extend(float(m) for m in means)
        self._wts.extend(float(w) for w in weights)
        self._local.extend([False] * len(means))
        if not self._staged_nonuniform and any(
                float(w) != 1.0 for w in weights):
            self._staged_nonuniform = True
        self.d_min[row] = min(self.d_min[row], dmin)
        self.d_max[row] = max(self.d_max[row], dmax)
        self.d_rsum[row] += drsum

    def sample_batch(self, rows: np.ndarray, vals: np.ndarray,
                     wts: np.ndarray) -> None:
        """Stage a columnar batch of locally observed samples."""
        if not self._staged_nonuniform and not np.all(wts == 1.0):
            self._staged_nonuniform = True
        self._chunks.append((rows, vals, wts))

    def staged_count(self) -> int:
        return len(self._rows) + sum(len(r) for r, _, _ in self._chunks)

    # -- consolidation / hot-key pre-reduction -------------------------------

    def sync(self) -> None:
        """Consolidate raw staging into the interval accumulator: apply
        the host scalar updates, track per-row depth, and pre-reduce any
        row whose backlog outgrew DENSE_DEPTH_CAP."""
        if not self._rows and not self._chunks:
            return
        parts = []
        if self._rows:
            parts.append((np.asarray(self._rows, np.int64),
                          np.asarray(self._vals, np.float64),
                          np.asarray(self._wts, np.float64),
                          np.asarray(self._local, bool)))
            self._rows, self._vals, self._wts, self._local = [], [], [], []
        for r, v, w in self._chunks:
            parts.append((r.astype(np.int64, copy=False),
                          v.astype(np.float64, copy=False),
                          w.astype(np.float64, copy=False),
                          np.ones(len(r), bool)))
        self._chunks = []
        rows, vals, wts, local = (np.concatenate([p[i] for p in parts])
                                  for i in range(4))
        np.minimum.at(self.d_min, rows, vals)
        np.maximum.at(self.d_max, rows, vals)
        np.add.at(self.d_weight, rows, wts)
        np.add.at(self.d_sum, rows, vals * wts)
        lr, lv, lw = rows[local], vals[local], wts[local]
        with np.errstate(divide="ignore"):
            np.add.at(self.d_rsum, lr, lw / lv)
            np.add.at(self.l_rsum, lr, lw / lv)
        np.add.at(self.l_weight, lr, lw)
        np.minimum.at(self.l_min, lr, lv)
        np.maximum.at(self.l_max, lr, lv)
        np.add.at(self.l_sum, lr, lv * lw)
        self._sync_extra(rows, vals, wts)
        self._acc.append((rows, vals, wts))
        np.add.at(self._depth, rows, 1)
        # each pass collapses a row ~HOT_CHUNK_WIDTH -> ccap points, so
        # this converges in O(log) passes even for absurd backlogs
        while int(self._depth.max()) > DENSE_DEPTH_CAP:
            before = int(self._depth.max())
            self._pre_reduce()
            if int(self._depth.max()) >= before:
                break

    def _sync_extra(self, rows: np.ndarray, vals: np.ndarray,
                    wts: np.ndarray) -> None:
        """Family hook: extra host-scalar accumulation over one sync
        batch (MomentsArena tracks the positive-sample mass here)."""

    def _consolidated(self):
        """Collapse _acc into single (rows, vals, wts) arrays."""
        if not self._acc:
            z = np.zeros(0)
            return z.astype(np.int64), z, z
        if len(self._acc) > 1:
            self._acc = [tuple(np.concatenate([p[i] for p in self._acc])
                               for i in range(3))]
        return self._acc[0]

    def _pre_reduce(self) -> None:
        """Collapse rows deeper than DENSE_DEPTH_CAP into <= ccap weighted
        points each: group deep rows under a padded-element budget, run
        one batched device compress per group and re-stage the centroids
        (scalars were applied by the original samples)."""
        rows, vals, wts = self._consolidated()
        deep = np.nonzero(self._depth > DENSE_DEPTH_CAP)[0]
        if len(deep) == 0:
            return
        self._staged_nonuniform = True
        is_deep = np.zeros(self.capacity, bool)
        is_deep[deep] = True
        sel = is_deep[rows]
        keep = (rows[~sel], vals[~sel], wts[~sel])
        drows, dvals, dwts = rows[sel], vals[sel], wts[sel]
        order = np.argsort(drows, kind="stable")
        drows, dvals, dwts = drows[order], dvals[order], dwts[order]
        # split each row into HOT_CHUNK_WIDTH-deep virtual rows, so one
        # pathological key never builds an unbounded-width matrix
        rstarts = np.searchsorted(drows, drows)
        rpos = np.arange(len(drows)) - rstarts
        vrows = (drows << np.int64(20)) | (rpos // HOT_CHUNK_WIDTH)
        urows, counts = np.unique(vrows, return_counts=True)
        row_starts = np.concatenate([[0], np.cumsum(counts)])
        out_r, out_v, out_w = [], [], []
        g0 = 0
        while g0 < len(urows):
            g1 = g0 + 1
            wmax = int(counts[g0])
            while g1 < len(urows):
                nw = max(wmax, int(counts[g1]))
                if _pow2(g1 + 1 - g0) * _pow2(nw) > HOT_DENSE_BUDGET:
                    break
                wmax = nw
                g1 += 1
            slo, shi = int(row_starts[g0]), int(row_starts[g1])
            group_rows = urows[g0:g1]
            dv = np.zeros((_pow2(g1 - g0), _pow2(wmax)), np.float32)
            dw = np.zeros_like(dv)
            ridx = np.searchsorted(group_rows, vrows[slo:shi])
            pos = np.arange(slo, shi) - row_starts[ridx + g0]
            dv[ridx, pos] = dvals[slo:shi]
            dw[ridx, pos] = dwts[slo:shi]
            pm, pw = serving.fetch(serving.partial_digests(
                serving.put(dv, self.device), serving.put(dw, self.device),
                self.compression, self.ccap))
            pm, pw = pm[:len(group_rows)], pw[:len(group_rows)]
            occ = pw > 0
            out_r.append(np.repeat(group_rows >> np.int64(20),
                                   occ.sum(axis=1)))
            out_v.append(pm[occ].astype(np.float64))
            out_w.append(pw[occ].astype(np.float64))
            g0 = g1
        new = tuple(np.concatenate([keep[i]] + out)
                    for i, out in enumerate((out_r, out_v, out_w)))
        self._acc = [new]
        self._depth[:] = 0
        np.add.at(self._depth, new[0], 1)

    # -- flush ---------------------------------------------------------------

    @property
    def staged_uniform(self) -> bool:
        """True iff every weight staged this interval equals exactly 1.0
        (capture BEFORE take_staged resets the tracking)."""
        return not self._staged_nonuniform

    def take_staged(self):
        """Consume the interval accumulator (under the aggregator lock,
        after sync()): returns (rows, vals, wts) COO arrays."""
        staged = self._consolidated()
        self._acc = []
        self._staged_nonuniform = False
        return staged

    def dense_block_per_shard(self, n_rows: int) -> int:
        """Row-block size each mesh shard owns in the dense build for
        `n_rows` touched keys (`arena.py:1521-1540` of the JAX package):
        the pow2 ceiling of n_rows / S, rounded up to a replica multiple
        so the flush's all_to_all splits it evenly.  Dense row r
        (touched order) lives on shard r // block.  Unmeshed: the pow2
        of n_rows."""
        per_shard = _pow2(-(-max(int(n_rows), 1) // self.n_shards))
        if per_shard % self.n_replicas:
            per_shard = self.n_replicas * _pow2(
                -(-per_shard // self.n_replicas))
        return per_shard

    def build_dense(self, staged, touched: np.ndarray,
                    d_min_t: np.ndarray, d_max_t: np.ndarray,
                    uniform: bool = False):
        """Map the staged COO onto touched-row-ordered dense matrices
        `[U, D]` plus the stacked [2, U] min/max.  Pure host numpy
        (`arena.py:1625-1658` of the JAX package).  Unmeshed, U is the
        pow2 of the touched count and D the pow2 of the deepest row (at
        least 2); with a mesh, U is S shard blocks of
        `dense_block_per_shard` rows and D the deepest row rounded up to
        R times a power of two.

        uniform=True (legal only when every staged weight is exactly 1):
        the middle return is an int16 per-row DEPTH VECTOR `[U]` instead
        of the weight matrix — staged points pack from column 0, so
        `col < depth[row]` is the occupancy — and min/max is None.

        With bf16 staging the values come back as a CPU bfloat16 tensor
        instead (numpy has no bfloat16): the float32 matrix converts on
        the host, so only half its bytes cross to the device.  Weights,
        depths and min/max keep their types.

        Above _NATIVE_FILL_MIN staged points the matrices fill in one
        pass through the native engine (`ingest.fill_dense`,
        `arena.py:1577-1609` of the JAX package), bitwise what the numpy
        scatter builds; a fill that drops a point (a staged row outside
        `touched`) is counted in dense_fill_fallbacks and rebuilt by
        numpy."""
        rows, vals, wts = staged
        if len(rows) and (int(rows.min()) < 0
                          or int(rows.max()) >= self.capacity):
            bad = (rows < 0) | (rows >= self.capacity)
            logging.getLogger("veneur_tpu_torch.core.arena").error(
                "dropping %d staged digest points with out-of-bounds "
                "row ids (corrupt staging)", int(bad.sum()))
            rows, vals, wts = rows[~bad], vals[~bad], wts[~bad]
        nd = len(touched)
        u_pad = self.n_shards * self.dense_block_per_shard(nd)
        dense_id = np.full(self.capacity, -1, np.int64)
        dense_id[touched] = np.arange(nd)
        r = dense_id[rows]
        if len(r) >= _NATIVE_FILL_MIN:
            built = self._fill_native(rows, vals, wts, r, dense_id, nd,
                                      u_pad, uniform, d_min_t, d_max_t)
            if built is not None:
                return built
            self.dense_fill_fallbacks += 1
        order = np.argsort(r, kind="stable")
        r, v = r[order], vals[order]
        first = np.searchsorted(r, np.arange(nd))
        pos = np.arange(len(r)) - first[r]
        depth = int(pos.max()) + 1 if len(r) else 1
        d_pad = max(2, self.n_replicas * _pow2(-(-depth // self.n_replicas)))
        dv = np.zeros((u_pad, d_pad), np.float32)
        dv[r, pos] = v
        if self.stage_dtype != torch.float32 and (
                uniform or self.compact_general):
            # f64 -> f32 -> bf16, the rounding of the JAX package's
            # ml_dtypes staging (it rounds through float32 too)
            dv = torch.from_numpy(dv).to(self.stage_dtype)
        if uniform:
            # int16 is exact (depths <= DENSE_DEPTH_CAP < 2^15)
            depths_vec = np.zeros(u_pad, np.int16)
            if len(r):
                depths_vec[:nd] = np.bincount(r, minlength=nd)[:nd]
            return dv, depths_vec, None
        minmax = np.zeros((2, u_pad), np.float32)
        minmax[0, :nd] = d_min_t
        minmax[1, :nd] = d_max_t
        dw = np.zeros((u_pad, d_pad), np.float32)
        dw[r, pos] = wts[order]
        return dv, dw, minmax

    def _fill_native(self, rows, vals, wts, rid, dense_id, nd, u_pad,
                     uniform, d_min_t, d_max_t):
        """build_dense through the native fill; None when a staged row
        is outside `touched` or the fill dropped a point."""
        from veneur_tpu_torch import ingest
        if int(rid.min()) < 0:
            return None
        depth = max(int(np.bincount(rid, minlength=nd).max()), 1)
        d_pad = max(2, self.n_replicas * _pow2(-(-depth // self.n_replicas)))
        dv = np.zeros((u_pad, d_pad), np.float32)
        depths_vec = np.zeros(u_pad, np.int16)
        dw = None if uniform else np.zeros((u_pad, d_pad), np.float32)
        dropped = ingest.fill_dense(
            np.ascontiguousarray(rows, np.int64),
            np.ascontiguousarray(vals, np.float64),
            None if uniform else np.ascontiguousarray(wts, np.float64),
            dense_id, dv, dw, depths_vec)
        if dropped:
            return None
        self.dense_fill_native += 1
        if self.stage_dtype != torch.float32 and (
                uniform or self.compact_general):
            dv = torch.from_numpy(dv).to(self.stage_dtype)
        if uniform:
            return dv, depths_vec, None
        minmax = np.zeros((2, u_pad), np.float32)
        minmax[0, :nd] = d_min_t
        minmax[1, :nd] = d_max_t
        return dv, dw, minmax

    def put_dense(self, dv: np.ndarray, dw: np.ndarray,
                  minmax: np.ndarray):
        """Upload the general dense build."""
        return (serving.put(dv, self.device), serving.put(dw, self.device),
                serving.put(minmax, self.device))

    def put_dense_uniform(self, dv: np.ndarray, depths: np.ndarray):
        """Upload the uniform (depth-vector) dense build."""
        return serving.put(dv, self.device), serving.put(depths, self.device)

    def put_dense_sharded(self, dv: np.ndarray, dw: np.ndarray,
                          minmax: np.ndarray):
        """Pre-sharded staging of the meshed dense build: each device's
        row block and depth slice placed directly on it
        (`serving.place_dense_blocks`; `arena.py:1667-1680` of the JAX
        package) -> (dense_v, dense_w, minmax) grids."""
        return serving.place_dense_blocks(self.mesh, dv, dw, minmax)

    _CKPT_SCALARS = ("d_min", "d_max", "d_rsum", "d_weight", "d_sum",
                     "l_weight", "l_min", "l_max", "l_sum", "l_rsum",
                     "_depth")

    def _checkpoint_arrays(self) -> dict:
        out = {name: getattr(self, name).copy()
               for name in self._CKPT_SCALARS}
        rows, vals, wts = self._consolidated()
        out["acc_rows"] = rows.copy()
        out["acc_vals"] = vals.copy()
        out["acc_wts"] = wts.copy()
        return out

    def _checkpoint_extra(self, meta: dict) -> None:
        meta["staged_nonuniform"] = bool(self._staged_nonuniform)
        meta["compression"] = float(self.compression)
        meta["resident"] = False
        meta["resident_stage_dtype"] = str(self.stage_dtype).removeprefix(
            "torch.")

    def restore_precheck(self, meta: dict, arrays: dict) -> None:
        if float(meta.get("compression",
                          self.compression)) != self.compression:
            raise CheckpointIncompatible(
                f"digest checkpoint compression {meta.get('compression')}"
                f" != configured {self.compression}")

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        for name in self._CKPT_SCALARS:
            self._restore_into(getattr(self, name), arrays[name])
        rows = arrays["acc_rows"].astype(np.int64, copy=False)
        if len(rows):
            self._acc = [(rows,
                          arrays["acc_vals"].astype(np.float64, copy=False),
                          arrays["acc_wts"].astype(np.float64, copy=False))]
        self._staged_nonuniform = bool(meta.get("staged_nonuniform", False))

    def reset_rows(self, rows: np.ndarray) -> None:
        if len(rows) == 0:
            return
        self.d_min[rows] = np.inf
        self.d_max[rows] = -np.inf
        self.d_rsum[rows] = 0
        self.d_weight[rows] = 0
        self.d_sum[rows] = 0
        self.l_weight[rows] = 0
        self.l_min[rows] = np.inf
        self.l_max[rows] = -np.inf
        self.l_sum[rows] = 0
        self.l_rsum[rows] = 0
        self._depth[rows] = 0


class MomentsArena(DigestArena):
    """The moments sketch family (sketches/moments.py): each row is one
    fixed-size f64 moments vector instead of a centroid set, and the
    flush's merge is a dense segmented sum (kernel B5) followed by the
    batched maxent solver (ops/moments_eval.py), with no sort network.
    Family choice per key is the aggregator's (`sketch_family_*`).

    Shares DigestArena's staging (COO buffers, interval consolidation,
    the dense build with its depth-vector variant) and its exact host
    scalars, and adds:

      d_logn   per-row weight over strictly-positive samples (the mass
               the log-domain power sums cover)
      ivec     `[capacity, 2(k+1)]` f64 accumulator of NON-STAGED
               power-sum mass (imported vectors and hot-row
               pre-reductions) as range-scaled monomial sums in the
               row's own ivec domain (iv_a/iv_b).  Layout:
               [count, U_1..U_k, logn, V_1..V_k].

    The interval's staged samples reduce on the device at flush; the
    host converts ivec to Chebyshev contributions in the authoritative
    [d_min, d_max] domain (`import_contrib`) and the program adds the
    two before solving.  Rows deeper than DENSE_DEPTH_CAP fold into
    ivec on the host (exact f64) instead of a device compress."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY,
                 k: int = mo.DEFAULT_K, device=None):
        super().__init__(capacity=capacity, device=device)
        self.k = int(k)
        self.d_logn = np.zeros(self.capacity)
        self.ivec = np.zeros((self.capacity, 2 * (self.k + 1)), np.float64)
        self.iv_a = np.full(self.capacity, np.inf)
        self.iv_b = np.full(self.capacity, -np.inf)

    def _grow_state(self, old: int) -> None:
        super()._grow_state(old)
        self.d_logn = np.concatenate([self.d_logn, np.zeros(old)])
        self.ivec = np.concatenate(
            [self.ivec, np.zeros((old, self.ivec.shape[1]))], axis=0)
        self.iv_a = np.concatenate([self.iv_a, np.full(old, np.inf)])
        self.iv_b = np.concatenate([self.iv_b, np.full(old, -np.inf)])

    def _sync_extra(self, rows, vals, wts) -> None:
        pos = vals > 0
        if pos.any():
            np.add.at(self.d_logn, rows[pos], wts[pos])

    # -- imports (vector merge: the elementwise-add path) --------------------

    def checked_vector(self, vec) -> np.ndarray:
        """A wire moments vector as f64, or ValueError when its length is
        not this arena's k (vectors of another k do not merge)."""
        vec = np.asarray(vec, np.float64)
        if vec.shape != (mo.vector_len(self.k),):
            raise ValueError(
                f"moments vector length {vec.shape[-1] if vec.ndim else 0}"
                f" does not match k={self.k} (len {mo.vector_len(self.k)});"
                " mixed-k fleets are not mergeable")
        return vec

    def merge_moments(self, row: int, vec) -> None:
        """Fold one wire moments vector into a row: exact scalar merges
        plus a domain-rebased add of the power-sum blocks."""
        self.merge_moments_batch(np.asarray([row], np.int64),
                                 self.checked_vector(vec)[None, :])

    def merge_moments_batch(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        """`merge_moments` over distinct rows at once: checked vectors
        `[n, M]` into `rows` `[n]`.  Every step is elementwise per row,
        so the result is bit-identical to n single merges.  min/max
        keep Python's `min`/`max` order: an incoming NaN bound leaves
        the row's bound as it was."""
        k = self.k
        if len(rows) > 1 and len(np.unique(rows)) != len(rows):
            raise ValueError("merge_moments_batch: rows must be distinct")
        sa, sb = vecs[:, mo.IDX_MIN], vecs[:, mo.IDX_MAX]
        cur_a, cur_b = self.d_min[rows], self.d_max[rows]
        self.d_min[rows] = np.where(sa < cur_a, sa, cur_a)
        self.d_max[rows] = np.where(sb > cur_b, sb, cur_b)
        self.d_weight[rows] += vecs[:, mo.IDX_COUNT]
        self.d_sum[rows] += vecs[:, mo.IDX_SUM]
        self.d_rsum[rows] += vecs[:, mo.IDX_RSUM]
        self.d_logn[rows] += vecs[:, mo.IDX_LOGN]
        # rebase-add the (raw, log) monomial sums into the rows' ivec,
        # growing each ivec domain to cover the incoming vector's
        a0, b0 = self.iv_a[rows], self.iv_b[rows]
        a1, b1 = np.where(sa < a0, sa, a0), np.where(sb > b0, sb, b0)
        new_lab = mo.log_domain(a1, b1)
        cur_raw = self.ivec[rows, :k + 1]
        cur_log = self.ivec[rows, k + 1:]
        # a row whose domain already covers the vector keeps its sums
        # (the rebase would be an exact identity)
        steady = ((a1 == a0) & (b1 == b0))[:, None]
        old_lab = mo.log_domain(np.where(np.isfinite(a0), a0, 0.0),
                                np.where(np.isfinite(b0), b0, 0.0))
        raw = np.where(steady, cur_raw,
                       mo.rebase_sums(cur_raw, (a0, b0), (a1, b1)))
        log = np.where(steady, cur_log,
                       mo.rebase_sums(cur_log, old_lab, new_lab))
        src_raw = np.concatenate([vecs[:, mo.IDX_COUNT:mo.IDX_COUNT + 1],
                                  vecs[:, mo.SUMS_OFF:mo.SUMS_OFF + k]], 1)
        src_log = np.concatenate([vecs[:, mo.IDX_LOGN:mo.IDX_LOGN + 1],
                                  vecs[:, mo.SUMS_OFF + k:]], 1)
        raw = raw + mo.rebase_sums(src_raw, (sa, sb), (a1, b1))
        log = log + mo.rebase_sums(src_log, mo.log_domain(sa, sb), new_lab)
        self.ivec[rows, :k + 1] = raw
        self.ivec[rows, k + 1:] = log
        self.iv_a[rows], self.iv_b[rows] = a1, b1

    # -- hot-row pre-reduction (host fold, no device compress) ---------------

    def _pre_reduce(self) -> None:
        """Collapse rows deeper than DENSE_DEPTH_CAP by folding their
        staged points into the ivec accumulator (exact f64 host fold,
        `mo.fold_values`): a moments "compress" is the merge itself, so
        nothing re-stages.  Scalars are not re-applied (sync did)."""
        rows, vals, wts = self._consolidated()
        deep = np.nonzero(self._depth > DENSE_DEPTH_CAP)[0]
        if len(deep) == 0:
            return
        sel = np.zeros(self.capacity, bool)
        sel[deep] = True
        sel = sel[rows]
        drows, dvals, dwts = rows[sel], vals[sel], wts[sel]
        ridx = np.searchsorted(deep, drows)
        k = self.k
        # per-deep-row fold domain: the union of the row's ivec domain
        # and the staged subset's own range
        order = np.argsort(drows, kind="stable")
        starts = np.searchsorted(drows[order], deep)
        sub_a = np.minimum.reduceat(dvals[order], starts)
        sub_b = np.maximum.reduceat(dvals[order], starts)
        iv_a, iv_b = self.iv_a[deep], self.iv_b[deep]
        a1 = np.minimum(np.where(np.isfinite(iv_a), iv_a, np.inf), sub_a)
        b1 = np.maximum(np.where(np.isfinite(iv_b), iv_b, -np.inf), sub_b)
        lab1 = mo.log_domain(a1, b1)
        old_lab = mo.log_domain(np.where(np.isfinite(iv_a), iv_a, 0.0),
                                np.where(np.isfinite(iv_b), iv_b, 0.0))
        raw = mo.rebase_sums(self.ivec[deep, :k + 1], (iv_a, iv_b), (a1, b1))
        log = mo.rebase_sums(self.ivec[deep, k + 1:], old_lab, lab1)
        mo.fold_values(raw, log, ridx, dvals, dwts, (a1, b1), lab1)
        self.ivec[deep, :k + 1] = raw
        self.ivec[deep, k + 1:] = log
        self.iv_a[deep], self.iv_b[deep] = a1, b1
        keep = ~sel
        self._acc = [(rows[keep], vals[keep], wts[keep])]
        self._depth[deep] = 0

    # -- forwarding export ---------------------------------------------------

    def assemble_vectors(self, part: dict, staged, sel: np.ndarray
                         ) -> np.ndarray:
        """Wire vectors `[F, M]` for the selected snapshot rows: exact
        scalars from the snapshot copies, power sums = the ivec
        contribution rebased to the authoritative [d_min, d_max] plus a
        host f64 fold of the interval's staged points of those rows.
        Call at emit time on the SNAPSHOT part (the live arrays are
        already reset)."""
        k = self.k
        f = len(sel)
        a = np.where(np.isfinite(part["d_min"][sel]), part["d_min"][sel], 0.0)
        b = np.where(np.isfinite(part["d_max"][sel]), part["d_max"][sel], 0.0)
        lab = mo.log_domain(a, b)
        old_a, old_b = part["iv_a"][sel], part["iv_b"][sel]
        old_lab = mo.log_domain(np.where(np.isfinite(old_a), old_a, 0.0),
                                np.where(np.isfinite(old_b), old_b, 0.0))
        raw = mo.rebase_sums(part["ivec"][sel, :k + 1], (old_a, old_b),
                             (a, b))
        log = mo.rebase_sums(part["ivec"][sel, k + 1:], old_lab, lab)
        srows, svals, swts = staged
        if len(srows):
            lut = np.full(self.capacity, -1, np.int64)
            lut[part["rows"][sel]] = np.arange(f)
            m = lut[srows] >= 0
            if m.any():
                mo.fold_values(raw, log, lut[srows[m]], svals[m], swts[m],
                               (a, b), lab)
        vecs = np.zeros((f, mo.vector_len(k)), np.float64)
        vecs[:, mo.IDX_COUNT] = part["d_weight"][sel]
        vecs[:, mo.IDX_MIN] = part["d_min"][sel]
        vecs[:, mo.IDX_MAX] = part["d_max"][sel]
        vecs[:, mo.IDX_SUM] = part["d_sum"][sel]
        vecs[:, mo.IDX_RSUM] = part["d_rsum"][sel]
        vecs[:, mo.IDX_LOGN] = part["d_logn"][sel]
        vecs[:, mo.SUMS_OFF:mo.SUMS_OFF + k] = raw[:, 1:]
        vecs[:, mo.SUMS_OFF + k:] = log[:, 1:]
        return vecs

    # -- flush conversion ----------------------------------------------------

    def import_contrib(self, part: dict, u_pad: int):
        """The flush program's `imp` operand: Chebyshev contributions of
        the snapshot rows' ivec accumulators in the authoritative
        domain, f64-converted on the host, zero-padded to the dense row
        count.  Returns (imp [u_pad, 2(k+1)] f32, ab [2, u_pad] f32,
        lab [2, u_pad] f32)."""
        from veneur_tpu_torch.ops import moments_eval as me
        k = self.k
        n = len(part["rows"])
        a = np.where(np.isfinite(part["d_min"]), part["d_min"], 0.0)
        b = np.where(np.isfinite(part["d_max"]), part["d_max"], 0.0)
        la, lb = mo.log_domain(a, b)
        old_a, old_b = part["iv_a"], part["iv_b"]
        old_lab = mo.log_domain(np.where(np.isfinite(old_a), old_a, 0.0),
                                np.where(np.isfinite(old_b), old_b, 0.0))
        raw = mo.rebase_sums(part["ivec"][:, :k + 1], (old_a, old_b), (a, b))
        log = mo.rebase_sums(part["ivec"][:, k + 1:], old_lab, (la, lb))
        c = me._mono_to_cheb(k).T
        imp = np.zeros((u_pad, 2 * (k + 1)), np.float32)
        imp[:n, :k + 1] = raw @ c
        imp[:n, k + 1:] = log @ c
        ab = np.zeros((2, u_pad), np.float32)
        ab[0, :n] = a
        ab[1, :n] = b
        lab = np.zeros((2, u_pad), np.float32)
        lab[1, :] = -1.0          # sentinel: lb < la = log invalid
        lab[0, :n] = la
        lab[1, :n] = lb
        return imp, ab, lab

    # -- lifecycle -----------------------------------------------------------

    def reset_rows(self, rows: np.ndarray) -> None:
        super().reset_rows(rows)
        if len(rows) == 0:
            return
        self.d_logn[rows] = 0
        self.ivec[rows] = 0
        self.iv_a[rows] = np.inf
        self.iv_b[rows] = -np.inf

    # -- checkpoint ----------------------------------------------------------

    def _checkpoint_arrays(self) -> dict:
        out = super()._checkpoint_arrays()
        out["d_logn"] = self.d_logn.copy()
        # ivec serializes live rows only
        live = np.asarray(sorted(self.kdict.values()), np.int64)
        out["ivec_rows"] = live
        out["ivec"] = self.ivec[live].copy()
        out["iv_a"] = self.iv_a[live].copy()
        out["iv_b"] = self.iv_b[live].copy()
        return out

    def _checkpoint_extra(self, meta: dict) -> None:
        from veneur_tpu_torch.ops import moments_eval as me
        super()._checkpoint_extra(meta)
        meta["moments_k"] = int(self.k)
        meta["solver"] = [int(me.QUAD_POINTS), int(me.NEWTON_ITERS)]

    def restore_precheck(self, meta: dict, arrays: dict) -> None:
        from veneur_tpu_torch.ops import moments_eval as me
        super().restore_precheck(meta, arrays)
        if int(meta.get("moments_k", self.k)) != self.k:
            raise CheckpointIncompatible(
                f"moments checkpoint k {meta.get('moments_k')} != "
                f"configured {self.k}; power-sum blocks are not "
                "mergeable across orders")
        solver = [int(x) for x in (meta.get("solver")
                                   or [me.QUAD_POINTS, me.NEWTON_ITERS])]
        if solver != [me.QUAD_POINTS, me.NEWTON_ITERS]:
            raise CheckpointIncompatible(
                f"moments checkpoint solver config {solver} != current "
                f"[{me.QUAD_POINTS}, {me.NEWTON_ITERS}]; restored "
                "quantiles would not replay bit-identically")

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        super()._restore_arrays(meta, arrays)
        self._restore_into(self.d_logn, arrays["d_logn"])
        rows = arrays.get("ivec_rows")
        if rows is not None and len(rows):
            rows = rows.astype(np.int64, copy=False)
            self.ivec[rows] = arrays["ivec"]
            self.iv_a[rows] = arrays["iv_a"]
            self.iv_b[rows] = arrays["iv_b"]


class CompactorArena(DigestArena):
    """The relative-error compactor family (sketches/compactor.py): each
    row is one fixed ladder of `levels` compactor buffers of `cap` slots,
    the provable-rank-error tier next to the t-digest (DigestArena) and
    the moments family (MomentsArena).

    Shares DigestArena's staging (COO buffers, interval consolidation,
    the exact host scalar accumulators) and adds the per-row ladder
    state:

      cvals   `[capacity, levels, cap]` f32 level items (occupied prefix
              per level, zero padding beyond `ccnt`)
      ccnt    `[capacity, levels]` per-level occupancies
      ccomps / cclip   per-row compaction / clip counters (the coin
              schedule position, which makes merges replayable)

    The interval's staged samples fold into the ladders in ROUNDS of
    `ops/compactor_eval.compact_batch`: each round is one B6 launch over
    every pending row, and the host assembles the level staging and
    plans the coins (`compactor.plan_pass`) between rounds.  The fold
    runs mid-interval when a row's backlog outgrows DENSE_DEPTH_CAP
    (`_pre_reduce`) and at flush on the snapshot (`fold_flush`); values
    round to f32 on entry, as in the JAX package.  Imports merge on the
    host (`merge_compactor`, `compactor.apply_pass`), as the JAX package
    merges them.  Unmeshed only, like the JAX package's arena."""

    def __init__(self, capacity: int = _INITIAL_CAPACITY, cap: int = 0,
                 levels: int = 0, seed: int = 0, device=None, mesh=None):
        if mesh is not None:
            raise ValueError(
                "the compactor sketch family serves unmeshed tiers "
                "only (its fold/flush programs are single-device; "
                "drop mesh_devices or the sketch_family_* rules)")
        super().__init__(capacity=capacity, device=device)
        self.cc_cap = int(cap) if cap else cs.DEFAULT_CAP
        self.cc_levels = int(levels) if levels else cs.DEFAULT_LEVELS
        self.cc_seed = int(seed) if seed else cs.DEFAULT_SEED
        if (self.cc_cap < 8 or self.cc_cap & (self.cc_cap - 1)
                or self.cc_levels < 2):
            raise ValueError(
                f"bad compactor params cap={self.cc_cap} "
                f"levels={self.cc_levels} (cap must be a power of two "
                ">= 8, levels >= 2)")
        self.cvals = np.zeros((capacity, self.cc_levels, self.cc_cap),
                              np.float32)
        self.ccnt = np.zeros((capacity, self.cc_levels), np.int64)
        self.ccomps = np.zeros(capacity, np.int64)
        self.cclip = np.zeros(capacity, np.int64)

    def _grow_state(self, old: int) -> None:
        super()._grow_state(old)
        self.cvals = np.concatenate(
            [self.cvals, np.zeros((old,) + self.cvals.shape[1:], np.float32)])
        self.ccnt = np.concatenate(
            [self.ccnt, np.zeros((old, self.cc_levels), np.int64)])
        self.ccomps = np.concatenate([self.ccomps, np.zeros(old, np.int64)])
        self.cclip = np.concatenate([self.cclip, np.zeros(old, np.int64)])

    # -- the batched fold (rounds of one compact_batch launch) ---------------

    def _compact(self, stage_v: np.ndarray, stage_n: np.ndarray,
                 off: np.ndarray, timing: Optional[dict]) -> np.ndarray:
        """One B6 launch on the arena's device (the plain version on the
        CPU), read back to the host.  `timing`, when given, collects the
        launch's CUDA events under "events", its upload and readback
        wall time under "io_s" and its upload bytes under "bytes"."""
        from veneur_tpu_torch.ops import compactor_eval as ce
        t0 = time.perf_counter()
        sv = serving.put(stage_v, self.device)
        sn = serving.put(stage_n.astype(np.int32), self.device)
        so = serving.put(off.astype(np.int32), self.device)
        timed = timing is not None and self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        out = ce.compact_batch(sv, sn, so)
        if timed:
            ev1.record()
            timing.setdefault("events", []).append((ev0, ev1))
        host = serving.fetch(out)
        if timing is not None:
            timing["io_s"] = timing.get("io_s", 0.0) + (
                time.perf_counter() - t0)
            timing["bytes"] = timing.get("bytes", 0) + (
                stage_v.nbytes + 4 * stage_n.size + 4 * off.size)
        return host

    def _fold_state(self, st: dict, srows: np.ndarray, svals: np.ndarray,
                    swts: np.ndarray, timing: Optional[dict] = None) -> None:
        """Fold staged weighted points into ladder state arrays `st =
        {cvals, ccnt, comps, clip}` (row space = whatever `srows`
        indexes: the live capacity-sized arrays or a compact snapshot).
        Points enter in staged order per row; each round feeds every
        pending row's level staging up to 2*cap and runs one
        compact_batch over all of them, so the launch count is
        O(max backlog / cap), never O(rows)."""
        if len(srows) == 0:
            return
        levels, cap = self.cc_levels, self.cc_cap
        s2 = cs.STAGE_MUL * cap
        # f32 value resolution on entry: the device fold and the host
        # reference then agree bit for bit
        v32 = np.clip(svals, -cs._FCLAMP, cs._FCLAMP).astype(
            np.float32).astype(np.float64)
        order = np.argsort(srows, kind="stable")
        r_s, v_s = srows[order], v32[order]
        w_s = np.asarray(swts, np.float64)[order]
        uniq, starts = np.unique(r_s, return_index=True)
        ends = np.append(starts[1:], len(r_s))
        pending = []
        for u0, s0, e0 in zip(uniq, starts, ends):
            q = cs.split_levels(v_s[s0:e0], w_s[s0:e0], levels)
            pending.append((int(u0), q, np.zeros(levels, np.int64)))
        slot = np.arange(cap)[None, :]
        while pending:
            n = len(pending)
            stage_v = np.full((n, levels, s2), np.inf, np.float32)
            stage_n = np.zeros((n, levels), np.int64)
            comps = np.zeros(n, np.int64)
            clip = np.zeros(n, np.int64)
            for i, (r, q, pos) in enumerate(pending):
                comps[i] = st["comps"][r]
                clip[i] = st["clip"][r]
                for lvl in range(levels):
                    occ = int(st["ccnt"][r, lvl])
                    stage_v[i, lvl, :occ] = st["cvals"][r, lvl, :occ]
                    take = min(s2 - occ, len(q[lvl]) - int(pos[lvl]))
                    if take > 0:
                        stage_v[i, lvl, occ:occ + take] = \
                            q[lvl][pos[lvl]:pos[lvl] + take]
                        pos[lvl] += take
                    stage_n[i, lvl] = occ + take
            off, cnt_out, comps_out, clip_out = cs.plan_pass(
                stage_n, comps, clip, self.cc_seed, cap)
            out = self._compact(stage_v, stage_n, off, timing)
            # zero the +inf padding back out (live-state convention)
            out = np.where(slot[None, :, :] < cnt_out[:, :, None],
                           out, 0.0).astype(np.float32)
            nxt = []
            for i, (r, q, pos) in enumerate(pending):
                st["cvals"][r] = out[i]
                st["ccnt"][r] = cnt_out[i]
                st["comps"][r] = comps_out[i]
                st["clip"][r] = clip_out[i]
                if any(int(pos[lvl]) < len(q[lvl])
                       for lvl in range(levels)):
                    nxt.append((r, q, pos))
            pending = nxt

    def _live_state(self) -> dict:
        return {"cvals": self.cvals, "ccnt": self.ccnt,
                "comps": self.ccomps, "clip": self.cclip}

    def _pre_reduce(self) -> None:
        """Collapse rows deeper than DENSE_DEPTH_CAP by folding their
        staged points into the ladder state: a compactor "compress" is
        the fold itself, so nothing re-stages.  Scalars are not
        re-applied (sync did)."""
        rows, vals, wts = self._consolidated()
        deep = np.nonzero(self._depth > DENSE_DEPTH_CAP)[0]
        if len(deep) == 0:
            return
        is_deep = np.zeros(self.capacity, bool)
        is_deep[deep] = True
        sel = is_deep[rows]
        self._fold_state(self._live_state(), rows[sel], vals[sel], wts[sel])
        keep = ~sel
        self._acc = [(rows[keep], vals[keep], wts[keep])]
        self._depth[deep] = 0

    # -- imports (ladder merge: concatenate-then-compact) --------------------

    def merge_compactor(self, row: int, vec) -> None:
        """Fold one wire compactor vector into a row: exact scalar merges
        plus a level-wise concatenate and ONE host compaction pass (the
        coin continues from the summed counters, so import order cannot
        change the bits).  Param (cap/levels/seed) mismatches are
        refused, never coerced."""
        vec = np.asarray(vec, np.float64)
        params = cs.params_from_vector(vec)
        if params != (self.cc_cap, self.cc_levels, self.cc_seed):
            raise ValueError(
                f"compactor vector params {params} do not match "
                f"configured ({self.cc_cap}, {self.cc_levels}, "
                f"{self.cc_seed}); mixed-param fleets are not mergeable")
        self.d_min[row] = min(self.d_min[row], vec[cs.IDX_MIN])
        self.d_max[row] = max(self.d_max[row], vec[cs.IDX_MAX])
        self.d_weight[row] += vec[cs.IDX_COUNT]
        self.d_sum[row] += vec[cs.IDX_SUM]
        self.d_rsum[row] += vec[cs.IDX_RSUM]
        vb, cb, qb, lb = cs.state_from_vector(vec)
        if not cb.any():
            return
        levels, cap = self.cc_levels, self.cc_cap
        s2 = cs.STAGE_MUL * cap
        stage_v = np.full((1, levels, s2), np.inf)
        ca = self.ccnt[row]
        for lvl in range(levels):
            stage_v[0, lvl, :ca[lvl]] = self.cvals[row, lvl, :ca[lvl]]
            stage_v[0, lvl, ca[lvl]:ca[lvl] + cb[lvl]] = \
                vb[lvl, :cb[lvl]].astype(np.float32)
        stage_n = (ca + cb)[None, :]
        off, cnt_out, comps, clip = cs.plan_pass(
            stage_n, np.asarray([self.ccomps[row] + qb]),
            np.asarray([self.cclip[row] + lb]), self.cc_seed, cap)
        out = cs.apply_pass(stage_v, stage_n, off, cap)[0]
        live = np.arange(cap)[None, :] < cnt_out[0][:, None]
        self.cvals[row] = np.where(live, out, 0.0).astype(np.float32)
        self.ccnt[row] = cnt_out[0]
        self.ccomps[row] = int(comps[0])
        self.cclip[row] = int(clip[0])

    # -- flush (fold, then read off, on the snapshot) ------------------------

    def fold_flush(self, part: dict, staged):
        """Fold the interval's staged points into the SNAPSHOT ladder
        states; call once at dispatch time.  The result is cached in the
        part, so the flush's read-off and the forwarding export read the
        same fold.  Returns `(cvals [n, levels, cap] f32, ccnt [n,
        levels], comps [n], clip [n])` in snapshot row order; the fold's
        B6 launches leave their CUDA events and I/O time in
        `part["cfold_timing"]`."""
        cached = part.get("cfold")
        if cached is not None:
            return cached
        grows = np.asarray(part["rows"], np.int64)
        n = len(grows)
        st = {"cvals": part["cvals"].copy(), "ccnt": part["ccnt"].copy(),
              "comps": part["ccomps"].copy(), "clip": part["cclip"].copy()}
        timing = part.setdefault("cfold_timing", {})
        srows, svals, swts = staged
        if len(srows):
            lut = np.full(self.capacity, -1, np.int64)
            lut[grows] = np.arange(n)
            m = lut[srows] >= 0
            if m.any():
                self._fold_state(st, lut[srows[m]], svals[m], swts[m],
                                 timing)
        part["cfold"] = (st["cvals"], st["ccnt"], st["comps"], st["clip"])
        return part["cfold"]

    def flush_operands(self, part: dict, staged, u_pad: int):
        """Operands of `ops/compactor_eval.make_compactor_flush` from the
        folded snapshot state: `(cvals [u_pad, levels*cap] f32, ccnt
        [u_pad, levels] i32, cscale [u_pad] f32, mm [2, u_pad] f32)`.
        `cscale` renormalizes the implied item mass to the exact header
        count (identity while counts are integral and the ladder never
        clipped)."""
        cvals, ccnt, comps, clip = self.fold_flush(part, staged)
        n = len(part["rows"])
        levels, cap = self.cc_levels, self.cc_cap
        cv = np.zeros((u_pad, levels * cap), np.float32)
        cv[:n] = cvals.reshape(n, levels * cap)
        cc = np.zeros((u_pad, levels), np.int32)
        cc[:n] = ccnt
        mass = (ccnt * 2.0 ** np.arange(levels)[None, :]).sum(axis=1)
        cnt = np.asarray(part["d_weight"][:n], np.float64)
        cscale = np.ones(u_pad, np.float32)
        nz = (mass > 0) & (cnt > 0)
        cscale[:n][nz] = (cnt[nz] / mass[nz]).astype(np.float32)
        mm = np.zeros((2, u_pad), np.float32)
        mm[0, :n] = np.where(np.isfinite(part["d_min"][:n]),
                             part["d_min"][:n], 0.0)
        mm[1, :n] = np.where(np.isfinite(part["d_max"][:n]),
                             part["d_max"][:n], 0.0)
        return cv, cc, cscale, mm

    # -- forwarding export ---------------------------------------------------

    def assemble_vectors(self, part: dict, staged, sel: np.ndarray
                         ) -> np.ndarray:
        """Wire vectors `[F, M]` for the selected snapshot rows: exact
        scalars from the snapshot copies, ladder state from the flush's
        folded snapshot (`fold_flush`, shared, not recomputed).  Call at
        emit time on the SNAPSHOT part."""
        cvals, ccnt, comps, clip = self.fold_flush(part, staged)
        vecs = np.zeros((len(sel), cs.vector_len(self.cc_cap,
                                                 self.cc_levels)))
        for j, i in enumerate(sel):
            vec = cs.empty_vector(self.cc_cap, self.cc_levels, self.cc_seed)
            vec[cs.IDX_COUNT] = part["d_weight"][i]
            vec[cs.IDX_SUM] = part["d_sum"][i]
            vec[cs.IDX_RSUM] = part["d_rsum"][i]
            vec[cs.IDX_MIN] = part["d_min"][i]
            vec[cs.IDX_MAX] = part["d_max"][i]
            cs._encode(vec, cvals[i].astype(np.float64), ccnt[i],
                       int(comps[i]), int(clip[i]))
            vecs[j] = vec
        return vecs

    # -- lifecycle -----------------------------------------------------------

    def reset_rows(self, rows: np.ndarray) -> None:
        super().reset_rows(rows)
        if len(rows) == 0:
            return
        self.cvals[rows] = 0.0
        self.ccnt[rows] = 0
        self.ccomps[rows] = 0
        self.cclip[rows] = 0

    # -- checkpoint ----------------------------------------------------------

    def _checkpoint_arrays(self) -> dict:
        out = super()._checkpoint_arrays()
        # ladder state serializes live rows only
        live = np.asarray(sorted(self.kdict.values()), np.int64)
        out["compactor_rows"] = live
        out["cvals"] = self.cvals[live].copy()
        out["ccnt"] = self.ccnt[live].copy()
        out["ccomps"] = self.ccomps[live].copy()
        out["cclip"] = self.cclip[live].copy()
        return out

    def _checkpoint_extra(self, meta: dict) -> None:
        super()._checkpoint_extra(meta)
        meta["compactor_params"] = [int(self.cc_cap), int(self.cc_levels),
                                    int(self.cc_seed)]

    def restore_precheck(self, meta: dict, arrays: dict) -> None:
        super().restore_precheck(meta, arrays)
        want = [int(self.cc_cap), int(self.cc_levels), int(self.cc_seed)]
        got = [int(x) for x in (meta.get("compactor_params") or want)]
        if got != want:
            raise CheckpointIncompatible(
                f"compactor checkpoint params {got} != configured {want}; "
                "ladder states and coin schedules are not mergeable "
                "across (cap, levels, seed)")

    def _restore_arrays(self, meta: dict, arrays: dict) -> None:
        super()._restore_arrays(meta, arrays)
        rows = arrays.get("compactor_rows")
        if rows is not None and len(rows):
            rows = rows.astype(np.int64, copy=False)
            self.cvals[rows] = arrays["cvals"]
            self.ccnt[rows] = arrays["ccnt"]
            self.ccomps[rows] = arrays["ccomps"]
            self.cclip[rows] = arrays["cclip"]
