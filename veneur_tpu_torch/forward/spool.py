"""Durable forward spool: crash-safe buffering of undelivered chunks.

Counterpart of `veneur_tpu.forward.spool`, whose segment files it reads
and writes byte for byte: a spool directory written by either package
recovers in the other.  When the forward client's bounded RetryPolicy
(forward/client.py) is exhausted against a down destination, the
provably undelivered V1 chunks are not dropped: they are serialized
into an on-disk segment spool and replayed oldest-first once the
destination recovers.  With the chunk identity each payload carries on
gRPC metadata and the global tier's dedup ledger (sources/proxy.py),
delivery is exactly-once across a crash on either side of the edge:

  * sender crash: the segments survive on disk; the revived client
    replays them under their recorded identities, so a chunk that was
    delivered before the crash (an ambiguous timeout) merges once;
  * receiver crash: the global's ledger rides its checkpoint
    (core/checkpoint.py), so a chunk imported before the crash and
    replayed after the restore is recognized and skipped.

Only provably undelivered chunks (retry-safe failure codes) enter the
spool: a proxy peer re-shards batches without a dedup ledger, so
re-delivering an ambiguous failure through it could double-count.

Disk format (one segment file = `spool-<seq>.seg`, records appended):

    u32 payload_len | u32 crc32(payload) | payload
    payload: u16 version | u64 ts_ms | u64 epoch | u32 chunk_idx
             | u32 n_metrics | u64 trace_id | u64 span_id
             | u16 src_len | src | body (serialized MetricList)

The CRC and length framing make torn writes detectable: a reopen scan
skips a truncated final record (counted, then truncated back to the
last good boundary so later appends cannot interleave with it) and
rejects CRC-damaged records one by one.  Bodies are not held in memory:
replay reads them back from disk, so the spool's RAM cost is one small
index entry per pending record.

Bounds are visible loss, never silent: a record older than `max_age_s`
or evicted to keep the spool under `max_bytes` lands in the `expired`
counters (records and metric points).  A disk error on append drops the
record and counts it (`io_errors`; the caller counts the metrics); one
on a replay read drops that record and counts it.  (The JAX package's
`spool.io` failpoint on these two edges is not ported: ROADMAP A16.)
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

logger = logging.getLogger("veneur_tpu_torch.forward.spool")

SEGMENT_PREFIX = "spool-"
SEGMENT_SUFFIX = ".seg"
_FRAME = struct.Struct("<II")                  # payload_len, crc32
_HEADER = struct.Struct("<HQQIIQQH")           # version..src_len
_VERSION = 1

# fsync policies: every append / on segment rotation+close / never
FSYNC_POLICIES = ("always", "rotate", "never")

# bound on waiting out the replayer thread at close (it sleeps in
# replay_interval_s ticks, so one tick plus slack always suffices)
REPLAYER_JOIN_TIMEOUT_S = 2.0


def open_segment(path: str):
    """Open (create) a spool segment for appending — paired with
    close_segment on every path."""
    return open(path, "ab")


def close_segment(f, fsync: bool = False) -> None:
    """Flush (optionally fsync) and close a spool segment handle."""
    try:
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    finally:
        f.close()


@dataclass
class SpoolRecord:
    """One spooled chunk's index entry; the body stays on disk."""
    ident: tuple            # (source, epoch, chunk_idx)
    ts_ms: int
    n_metrics: int
    trace_id: int
    span_id: int
    seg_seq: int
    offset: int             # body offset within the segment file
    body_len: int
    disk_bytes: int         # full framed record size


def encode_record(ident: tuple, body: bytes, n_metrics: int,
                  trace_id: int = 0, span_id: int = 0,
                  ts_ms: Optional[int] = None) -> bytes:
    source, epoch, chunk_idx = ident
    src = source.encode()
    ts = int(ts_ms if ts_ms is not None else time.time() * 1e3)
    payload = _HEADER.pack(_VERSION, ts, int(epoch), int(chunk_idx),
                           int(n_metrics), int(trace_id), int(span_id),
                           len(src)) + src + body
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class ForwardSpool:
    def __init__(self, directory: str, max_bytes: int = 64 << 20,
                 max_age_s: float = 600.0,
                 fsync: str = "rotate",
                 segment_max_bytes: int = 4 << 20,
                 replay_interval_s: float = 0.5):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown spool fsync policy {fsync!r} "
                             f"(want one of {FSYNC_POLICIES})")
        self.dir = directory
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_s)
        self.fsync = fsync
        self.segment_max_bytes = int(segment_max_bytes)
        self.replay_interval_s = float(replay_interval_s)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._records: deque[SpoolRecord] = deque()
        # seg_seq -> records still pending in that segment (a segment
        # file is deleted only once every record it holds is settled)
        self._seg_pending: dict[int, int] = {}
        self._active = None          # (seq, file handle, bytes written)
        self._next_seq = 0
        self.pending_bytes = 0
        self.pending_points = 0      # metric points in pending records
        # ledger counters: spilled + recovered == replayed + expired +
        # dropped + pending at all times — the accounting closure the
        # crash tests assert.  `recovered` counts records a reopen
        # re-indexed from disk: they were spilled by a PREVIOUS
        # process, so this instance's spilled counters never saw them.
        self.spilled_records = 0
        self.spilled_points = 0
        self.recovered_records = 0
        self.recovered_points = 0
        self.replayed_records = 0
        self.replayed_points = 0
        self.expired_records = 0
        self.expired_points = 0
        self.dropped_records = 0
        self.dropped_points = 0
        self.torn_records = 0
        self.crc_rejected = 0
        self.io_errors = 0
        self.replay_attempts = 0
        self._replayer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._recover()

    # -- recovery (reopen after a crash) -----------------------------------

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{SEGMENT_PREFIX}{seq}{SEGMENT_SUFFIX}")

    def _recover(self) -> None:
        """Rebuild the pending index from on-disk segments: every valid
        record re-enters the replay queue (its recorded identity makes
        re-delivery of an already-imported chunk idempotent at the
        global), a truncated final record is skipped with a counter and
        truncated away, CRC-damaged records are rejected individually."""
        seqs = []
        for name in os.listdir(self.dir):
            if name.startswith(SEGMENT_PREFIX) and \
                    name.endswith(SEGMENT_SUFFIX):
                try:
                    seqs.append(int(
                        name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]))
                except ValueError:
                    continue
        for seq in sorted(seqs):
            path = self._segment_path(seq)
            try:
                good_end = self._scan_segment(seq, path)
            except OSError as e:
                self.io_errors += 1
                logger.error("spool: cannot recover segment %s: %s",
                             path, e)
                continue
            if good_end is not None:
                # torn tail: drop the partial record so appends to a
                # recovered active segment cannot interleave with it
                try:
                    with open(path, "r+b") as f:
                        f.truncate(good_end)
                except OSError:
                    self.io_errors += 1
            if self._seg_pending.get(seq, 0) == 0:
                self._unlink_segment(seq)
        self._next_seq = max(seqs, default=-1) + 1

    def _scan_segment(self, seq: int, path: str) -> Optional[int]:
        """Index one segment's records; returns the truncation offset
        when a torn tail was found, else None."""
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            if off + _FRAME.size > len(data):
                self.torn_records += 1
                return off
            plen, crc = _FRAME.unpack_from(data, off)
            start = off + _FRAME.size
            if start + plen > len(data):
                self.torn_records += 1
                return off
            payload = data[start:start + plen]
            next_off = start + plen
            if zlib.crc32(payload) != crc:
                self.crc_rejected += 1
                off = next_off
                continue
            try:
                (ver, ts_ms, epoch, chunk_idx, n_metrics, tid, sid,
                 src_len) = _HEADER.unpack_from(payload, 0)
                src = payload[_HEADER.size:_HEADER.size + src_len]
                body_off = _HEADER.size + src_len
                rec = SpoolRecord(
                    ident=(src.decode(), epoch, chunk_idx),
                    ts_ms=ts_ms, n_metrics=n_metrics,
                    trace_id=tid, span_id=sid, seg_seq=seq,
                    offset=start + body_off,
                    body_len=plen - body_off,
                    disk_bytes=_FRAME.size + plen)
            except (struct.error, UnicodeDecodeError):
                self.crc_rejected += 1
                off = next_off
                continue
            if ver != _VERSION:
                self.crc_rejected += 1
                off = next_off
                continue
            self._records.append(rec)
            self._seg_pending[seq] = self._seg_pending.get(seq, 0) + 1
            self.pending_bytes += rec.disk_bytes
            self.pending_points += rec.n_metrics
            self.recovered_records += 1
            self.recovered_points += rec.n_metrics
            off = next_off
        return None

    # -- append (the forward client's spill path) --------------------------

    def append(self, ident: tuple, body: bytes, n_metrics: int,
               trace_id: int = 0, span_id: int = 0) -> bool:
        """Spill one undelivered chunk.  Returns False (after counting
        the loss in dropped_*) when disk I/O fails — the caller's
        contract is drop-with-accounting, never a wedged forward
        thread."""
        ts_ms = int(time.time() * 1e3)
        frame = encode_record(ident, body, n_metrics, trace_id, span_id,
                              ts_ms)
        with self._lock:
            try:
                seq, f = self._active_segment_locked(len(frame))
                off = f.tell()
                f.write(frame)
                f.flush()
                if self.fsync == "always":
                    os.fsync(f.fileno())
            except Exception as e:
                # the CALLER accounts the drop (forward.dropped) — the
                # spool only records the I/O failure, so the loss is
                # counted exactly once
                self.io_errors += 1
                logger.error("spool: append failed, caller drops %d "
                             "metrics with accounting: %s", n_metrics, e)
                return False
            body_off = (off + _FRAME.size + _HEADER.size
                        + len(ident[0].encode()))
            rec = SpoolRecord(ident=ident, ts_ms=ts_ms,
                              n_metrics=n_metrics, trace_id=trace_id,
                              span_id=span_id, seg_seq=seq,
                              offset=body_off, body_len=len(body),
                              disk_bytes=len(frame))
            self._records.append(rec)
            self._seg_pending[seq] = self._seg_pending.get(seq, 0) + 1
            self.pending_bytes += rec.disk_bytes
            self.pending_points += n_metrics
            self.spilled_records += 1
            self.spilled_points += n_metrics
            self._enforce_bytes_locked()
        self._wake.set()
        return True

    def _close_active_locked(self, fsync: bool = False) -> None:
        if self._active is None:
            return
        _, f, _ = self._active
        self._active = None
        try:
            close_segment(f, fsync=fsync)
        except OSError:
            self.io_errors += 1

    def _active_segment_locked(self, need: int):
        if self._active is not None:
            seq, f, written = self._active
            if written + need <= self.segment_max_bytes:
                self._active = (seq, f, written + need)
                return seq, f
            self._close_active_locked(fsync=self.fsync != "never")
        seq = self._next_seq
        self._next_seq += 1
        f = open_segment(self._segment_path(seq))
        self._active = (seq, f, need)
        self._seg_pending.setdefault(seq, 0)
        return seq, f

    def _enforce_bytes_locked(self) -> None:
        """Evict oldest records while over the byte budget — bounded
        spool, visibly-accounted loss."""
        while self.pending_bytes > self.max_bytes and self._records:
            self._settle_locked(self._records.popleft(), "expired")

    def _settle_locked(self, rec: SpoolRecord, outcome: str) -> None:
        self.pending_bytes -= rec.disk_bytes
        self.pending_points -= rec.n_metrics
        if outcome == "replayed":
            self.replayed_records += 1
            self.replayed_points += rec.n_metrics
        elif outcome == "expired":
            self.expired_records += 1
            self.expired_points += rec.n_metrics
        else:
            self.dropped_records += 1
            self.dropped_points += rec.n_metrics
        left = self._seg_pending.get(rec.seg_seq, 0) - 1
        if left > 0:
            self._seg_pending[rec.seg_seq] = left
            return
        self._seg_pending.pop(rec.seg_seq, None)
        if self._active is not None and self._active[0] == rec.seg_seq:
            # fully-settled ACTIVE segment: rotate it out now, or a
            # restart would re-index (and re-replay) its records —
            # harmless under the dedup ledger, but pending accounting
            # must mean pending
            self._close_active_locked()
        self._unlink_segment(rec.seg_seq)

    def _unlink_segment(self, seq: int) -> None:
        try:
            os.unlink(self._segment_path(seq))
        except OSError:
            pass
        self._seg_pending.pop(seq, None)

    # -- replay ------------------------------------------------------------

    def read_body(self, rec: SpoolRecord) -> bytes:
        """Read one record's chunk bytes back from disk (the replay
        path)."""
        # the record may live in the still-open active segment: flushed
        # on append, so a plain read-only open sees it
        with open(self._segment_path(rec.seg_seq), "rb") as f:
            f.seek(rec.offset)
            body = f.read(rec.body_len)
        if len(body) != rec.body_len:
            raise OSError(f"short read ({len(body)}/{rec.body_len}) "
                          f"from spool segment {rec.seg_seq}")
        return body

    def peek(self, n: int = 1) -> list[SpoolRecord]:
        """Oldest n pending records (a test captures one to
        prove duplicate delivery merges once)."""
        with self._lock:
            return list(self._records)[:n]

    def pending_records(self) -> int:
        with self._lock:
            return len(self._records)

    def expire_now(self) -> int:
        """Expire every record older than max_age_s; returns records
        expired.  Runs on each replay tick and is callable directly."""
        cutoff_ms = (time.time() - self.max_age_s) * 1e3
        n = 0
        with self._lock:
            while self._records and self._records[0].ts_ms < cutoff_ms:
                self._settle_locked(self._records.popleft(), "expired")
                n += 1
        return n

    def start_replayer(self, send_fn: Callable[[SpoolRecord, bytes],
                                               None]) -> None:
        """Background oldest-first drain.  `send_fn(rec, body)` raises
        RetryableReplayError to keep the record for the next tick (the
        destination is still down); any other exception drops the
        record with accounting (an UNIMPLEMENTED peer, a poisoned
        chunk)."""
        if self._replayer is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                self._wake.wait(self.replay_interval_s)
                self._wake.clear()
                if self._stop.is_set():
                    return
                try:
                    self.replay_once(send_fn)
                except Exception:
                    logger.exception("spool replay tick failed")

        self._replayer = threading.Thread(target=loop, daemon=True,
                                          name="spool-replay")
        self._replayer.start()

    def replay_once(self, send_fn) -> int:
        """One drain pass: expire, then deliver oldest-first until the
        spool is empty or the destination fails retry-safely.  Returns
        records delivered."""
        self.expire_now()
        delivered = 0
        while not self._stop.is_set():
            with self._lock:
                if not self._records:
                    return delivered
                rec = self._records[0]
            self.replay_attempts += 1
            try:
                body = self.read_body(rec)
            except Exception as e:
                # unreadable record (a disk fault):
                # drop with accounting rather than wedge the queue head
                self.io_errors += 1
                logger.error("spool: replay read failed for %s: %s",
                             rec.ident, e)
                with self._lock:
                    if self._records and self._records[0] is rec:
                        self._settle_locked(self._records.popleft(),
                                            "dropped")
                continue
            try:
                send_fn(rec, body)
            except RetryableReplayError:
                return delivered      # destination still down; next tick
            except Exception as e:
                if self._stop.is_set():
                    # the spool is closing under the send (its channel
                    # torn down by a crash): keep the record for the
                    # revived process (ROADMAP C20)
                    return delivered
                logger.error("spool: replay of %s failed terminally, "
                             "dropping with accounting: %s", rec.ident, e)
                with self._lock:
                    if self._records and self._records[0] is rec:
                        self._settle_locked(self._records.popleft(),
                                            "dropped")
                continue
            delivered += 1
            with self._lock:
                if self._records and self._records[0] is rec:
                    self._settle_locked(self._records.popleft(),
                                        "replayed")
        return delivered

    def close(self, drain: bool = False) -> None:
        """Stop the replayer and close the active segment.  `drain`
        fsyncs the tail out (graceful shutdown); a simulated crash
        passes False and relies on the per-append flush."""
        self._stop.set()
        self._wake.set()
        t = self._replayer
        if t is not None:
            t.join(timeout=REPLAYER_JOIN_TIMEOUT_S)
            self._replayer = None
        with self._lock:
            self._close_active_locked(
                fsync=drain and self.fsync != "never")

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending_records": len(self._records),
                "pending_bytes": self.pending_bytes,
                "pending_points": self.pending_points,
                "spilled": self.spilled_records,
                "spilled_points": self.spilled_points,
                "recovered": self.recovered_records,
                "recovered_points": self.recovered_points,
                "replayed": self.replayed_records,
                "replayed_points": self.replayed_points,
                "expired": self.expired_records,
                "expired_points": self.expired_points,
                "dropped": self.dropped_records,
                "dropped_points": self.dropped_points,
                "torn_records": self.torn_records,
                "crc_rejected": self.crc_rejected,
                "io_errors": self.io_errors,
                "replay_attempts": self.replay_attempts,
            }


class RetryableReplayError(Exception):
    """The replay destination is still down (retry-safe failure): keep
    the record at the queue head for the next tick."""
