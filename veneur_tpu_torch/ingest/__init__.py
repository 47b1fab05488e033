"""Native ingest data plane: ctypes binding and arena drain adapter.

Counterpart of `veneur_tpu.ingest`.  The edge hot path (UDP read ->
DogStatsD parse -> staging) runs in C++ (`ingest/csrc/ingest_engine.cpp`,
this package's own copy of the JAX package's engine, built by
`ingest/_build.py`): SO_REUSEPORT reader threads on io_uring multishot
receive or recvmmsg and a zero-alloc parser (`networking.go:54-107`,
`samplers/parser.go:349-503`).  The engine interns each metric identity
to a dense u32 id and stages columnar batches; `NativeIngest.drain_into()`
applies a drain to the arenas with a handful of vectorized numpy calls
under one aggregator-lock hold.

Events and service checks punt to the Python slow path
(`Server.handle_metric_packet`); malformed metric lines are counted and
dropped, as the reference logs and drops them (`server.go:956-993`).

The same library serves the host halves of the flush, the import and
the proxy: `fill_dense` is the single-pass COO -> dense fill of
`DigestArena.build_dense`, `import_scan` the columnar wire scan of a V1
MetricList behind `MetricAggregator.import_payload`, and
`route_metric_list` the proxy's parse-free ring router behind
`Proxy.handle_metrics_raw`.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from veneur_tpu_torch.ingest import _build
from veneur_tpu_torch.samplers.metric_key import (MetricKey, MetricScope,
                                                  metric_digest)

_TYPE_NAMES = ("counter", "gauge", "histogram", "timer", "set")

# vn_engine_opt enum mirrors (ingest_engine.cpp VnSimd / VnBackend)
SIMD_MODES = {"auto": 0, "scalar": 1, "sse2": 2, "avx2": 3}
SIMD_NAMES = {v: k for k, v in SIMD_MODES.items()}
BACKEND_MODES = {"auto": 0, "recvmmsg": 1, "io_uring": 2}
BACKEND_NAMES = {0: "none", 1: "recvmmsg", 2: "io_uring"}

# data-plane stage names in pipeline order (`veneur_tpu/profiling`): the
# first four are per reader thread, drain is engine-level (the drainer
# thread); each counts in its STAGE_UNITS unit beside "ns"
STAGES = ("recvmmsg", "parse", "intern", "stage", "drain")
STAGE_UNITS = {"recvmmsg": "packets", "parse": "packets",
               "intern": "calls", "stage": "values", "drain": "packets"}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U64P = ctypes.POINTER(ctypes.c_ulonglong)
# (name, restype, argtypes) of every bound C entry point
_SIGNATURES = (
    ("vn_engine_new", _P, [ctypes.c_int, ctypes.c_char_p]),
    ("vn_engine_free", None, [_P]),
    ("vn_thread_new", ctypes.c_int, [_P]),
    ("vn_ingest", None, [_P, ctypes.c_int, ctypes.c_char_p, ctypes.c_long]),
    ("vn_add_udp_reader_pinned", ctypes.c_int, [_P, ctypes.c_int,
                                                ctypes.c_int]),
    ("vn_engine_opt", ctypes.c_int, [_P, ctypes.c_char_p, _I64]),
    ("vn_reader_backend", ctypes.c_int, [_P, ctypes.c_int]),
    ("vn_simd_mode", ctypes.c_int, [_P]),
    ("vn_simd_supported", ctypes.c_int, [ctypes.c_int]),
    ("vn_key_hash", ctypes.c_ulonglong, [ctypes.c_char_p, ctypes.c_long,
                                         ctypes.c_int]),
    ("vn_scan_tokens", _I64, [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                              ctypes.POINTER(_I64),
                              ctypes.POINTER(ctypes.c_ubyte), _I64]),
    ("vn_stop", None, [_P]),
    ("vn_drain", _P, [_P]),
    ("vn_drain_clear", _P, [_P]),
    ("vn_drain_section", _I64, [_P, ctypes.c_int, ctypes.POINTER(_P),
                                ctypes.POINTER(_P), ctypes.POINTER(_P)]),
    ("vn_drain_stats", None, [_P, _U64P]),
    ("vn_drain_free", None, [_P]),
    ("vn_totals", None, [_P, _U64P]),
    ("vn_intern_count", ctypes.c_ulonglong, [_P]),
    ("vn_stage_thread_count", _I64, [_P]),
    ("vn_stage_stats", _I64, [_P, _U64P, _I64]),
    ("vn_stage_drain", None, [_P, _U64P]),
    ("vn_metro64", ctypes.c_ulonglong, [ctypes.c_char_p, ctypes.c_long]),
    ("vn_blast_udp", _I64, [ctypes.c_char_p, ctypes.c_int, _I64,
                            ctypes.c_char_p, ctypes.POINTER(_I64),
                            ctypes.c_int]),
    ("vn_fill_dense", _I64, [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _I64,
                             _I64, ctypes.c_int]),
    ("vn_import_scan", _P, [ctypes.c_char_p, _I64]),
    ("vn_import_scan_n", _I64, [_P]),
    ("vn_import_scan_arrays", None, [_P] + [ctypes.POINTER(_P)] * 8),
    ("vn_import_scan_free", None, [_P]),
    ("vn_route", _P, [ctypes.c_char_p, _I64, _P, _P, _I64, ctypes.c_int,
                      ctypes.c_int]),
    ("vn_route_dest", None, [_P, ctypes.c_int, ctypes.POINTER(_P),
                             ctypes.POINTER(_I64), ctypes.POINTER(_I64)]),
    ("vn_route_chunks", None, [_P, ctypes.c_int, ctypes.POINTER(_P),
                               ctypes.POINTER(_I64)]),
    ("vn_route_free", None, [_P]),
)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the engine, its entry points typed;
    raises when the build or the load fails."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load()
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def import_scan(payload: bytes) -> Optional[dict]:
    """Columnar scan of a serialized MetricList (vn_import_scan): a dict
    of numpy arrays {h_lo, h_hi (u64 identity hashes), which (u8: 1
    counter, 2 gauge, 3 set, 4 histogram, 0 none), mtype, scope (u8),
    value (f64), rec_off, rec_len (i64 Metric submessage ranges)} and
    "n", copied out before the scan is freed; None if the payload failed
    the wire scan."""
    lib = load_library()
    handle = lib.vn_import_scan(payload, len(payload))
    if not handle:
        return None
    try:
        n = int(lib.vn_import_scan_n(handle))
        if n == 0:
            return {"n": 0}
        ptrs = [ctypes.c_void_p() for _ in range(8)]
        lib.vn_import_scan_arrays(handle, *map(ctypes.byref, ptrs))

        def arr(ptr, dtype):
            return np.frombuffer(ctypes.string_at(
                ptr.value, np.dtype(dtype).itemsize * n), dtype).copy()

        return {"n": n,
                "h_lo": arr(ptrs[0], np.uint64),
                "h_hi": arr(ptrs[1], np.uint64),
                "which": arr(ptrs[2], np.uint8),
                "mtype": arr(ptrs[3], np.uint8),
                "scope": arr(ptrs[4], np.uint8),
                "value": arr(ptrs[5], np.float64),
                "rec_off": arr(ptrs[6], np.int64),
                "rec_len": arr(ptrs[7], np.int64)}
    finally:
        lib.vn_import_scan_free(handle)


def route_metric_list(payload: bytes, ring_hashes, ring_dests,
                      n_dests: int, chunk_max: int = 2000):
    """Parse-free consistent-hash routing of a serialized MetricList
    (vn_route): each metric's routing key (name + type name + its tags
    joined by ",", `handlers.go:111-112`) is hashed with CRC-32 and
    bisected on the ring, and the raw records regroup into one region a
    destination.  Returns a list with one entry a destination index,
    each (chunks, chunk_counts, count): chunks a list of bytes, each a
    valid MetricList body of at most chunk_max metrics in payload
    order, chunk_counts their metric counts; or None if the router
    rejected the payload (the caller takes the protobuf path).
    ring_hashes: sorted uint32 ndarray; ring_dests: the parallel int32
    destination indices."""
    lib = load_library()
    hashes = np.ascontiguousarray(ring_hashes, np.uint32)
    dests = np.ascontiguousarray(ring_dests, np.int32)
    handle = lib.vn_route(payload, len(payload),
                          hashes.ctypes.data_as(ctypes.c_void_p),
                          dests.ctypes.data_as(ctypes.c_void_p),
                          len(hashes), n_dests, chunk_max)
    if not handle:
        return None
    try:
        out = []
        for d in range(n_dests):
            ptr, nbytes, count = ctypes.c_void_p(), _I64(), _I64()
            lib.vn_route_dest(handle, d, ctypes.byref(ptr),
                              ctypes.byref(nbytes), ctypes.byref(count))
            offs_ptr, n_bounds = ctypes.c_void_p(), _I64()
            lib.vn_route_chunks(handle, d, ctypes.byref(offs_ptr),
                                ctypes.byref(n_bounds))
            chunks: list = []
            chunk_counts: list = []
            n = count.value
            if n:
                region = ctypes.string_at(ptr.value, nbytes.value)
                offs = np.frombuffer(ctypes.string_at(
                    offs_ptr.value, 8 * n_bounds.value), np.int64)
                chunks = [region[offs[i]:offs[i + 1]]
                          for i in range(len(offs) - 1)]
                chunk_counts = [min(chunk_max, n - i * chunk_max)
                                for i in range(len(chunks))]
            out.append((chunks, chunk_counts, n))
        return out
    finally:
        lib.vn_route_free(handle)


def fill_dense(rows, vals, wts, dense_id, dv, dw, depths,
               n_threads: int = 4) -> int:
    """Single-pass COO -> dense fill (vn_fill_dense): staged point i goes
    to dense row dense_id[rows[i]] at that row's next free column, in
    staged order.  Arrays are C-contiguous int64 / float64 / float64
    (None on the uniform path) / int64 / float32 [u_pad, d_pad] /
    float32 (None on the uniform path) / int16 [u_pad].  Returns the
    count of dropped points (a row id outside [0, len(dense_id)), an
    untouched row, or a row deeper than d_pad); rows outside the
    capacity are counted here, before the call, so no bad index reaches
    the native code."""
    lib = load_library()

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    assert rows.dtype == np.int64 and vals.dtype == np.float64
    assert dv.dtype == np.float32 and dense_id.dtype == np.int64
    assert depths is None or depths.dtype == np.int16
    capacity = len(dense_id)
    if len(rows) and (int(rows.min()) < 0 or int(rows.max()) >= capacity):
        return int(((rows < 0) | (rows >= capacity)).sum())
    u_pad, d_pad = dv.shape
    return int(lib.vn_fill_dense(
        ptr(rows), ptr(vals), ptr(wts), len(rows), ptr(dense_id), capacity,
        ptr(dv), ptr(dw), ptr(depths), u_pad, d_pad, n_threads))


def metro64(data: bytes) -> int:
    """MetroHash64 with seed 1337 (the engine's set-member hash, equal
    to `sketches.hll.hash64`)."""
    return int(load_library().vn_metro64(data, len(data)))


def simd_supported(mode: str) -> bool:
    """Whether this CPU supports a SIMD dispatch mode, by name."""
    return bool(load_library().vn_simd_supported(SIMD_MODES[mode]))


def key_hash(data: bytes, mode: str) -> int:
    """The intern-key hash under an explicit SIMD mode (every mode
    computes the same function)."""
    return int(load_library().vn_key_hash(data, len(data), SIMD_MODES[mode]))


def scan_tokens(data: bytes, mode: str) -> list[tuple[int, str]]:
    """One tokenizer pass under an explicit SIMD mode: [(position,
    delimiter), ...] by position."""
    lib = load_library()
    cap = max(len(data), 1)
    pos = (ctypes.c_longlong * cap)()
    cls = (ctypes.c_ubyte * cap)()
    n = int(lib.vn_scan_tokens(data, len(data), SIMD_MODES[mode], pos, cls,
                               cap))
    if n < 0:
        raise ValueError(f"unsupported SIMD mode {mode!r}")
    chars = ("\n", ":", "|")
    return [(int(pos[i]), chars[cls[i]]) for i in range(min(n, cap))]


def blast_udp(host: str, port: int, n_packets: int,
              payloads: list[bytes]) -> int:
    """Send `n_packets` datagrams to (host, port) with sendmmsg, cycling
    through `payloads`; returns the datagrams handed to the kernel."""
    lib = load_library()
    blob = b"".join(payloads)
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    return int(lib.vn_blast_udp(
        host.encode(), port, n_packets, blob,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(payloads)))


@dataclass
class NewKey:
    id: int
    mtype: str
    scope: MetricScope
    name: str
    joined_tags: str


@dataclass
class DrainBatch:
    c_ids: np.ndarray
    c_vals: np.ndarray
    g_ids: np.ndarray
    g_vals: np.ndarray
    h_ids: np.ndarray
    h_vals: np.ndarray
    h_wts: np.ndarray
    s_ids: np.ndarray
    s_hashes: np.ndarray
    new_keys: list[NewKey]
    other: list[bytes]
    processed: int
    malformed: int
    packets: int
    too_long: int

    @property
    def empty(self) -> bool:
        return (len(self.c_ids) == 0 and len(self.g_ids) == 0
                and len(self.h_ids) == 0 and len(self.s_ids) == 0
                and not self.new_keys and not self.other)

    @classmethod
    def void(cls) -> "DrainBatch":
        z = np.empty(0, np.uint32)
        f = np.empty(0, np.float64)
        return cls(c_ids=z, c_vals=f, g_ids=z, g_vals=f, h_ids=z, h_vals=f,
                   h_wts=f, s_ids=z, s_hashes=np.empty(0, np.uint64),
                   new_keys=[], other=[], processed=0, malformed=0,
                   packets=0, too_long=0)


_CTYPES = {np.uint32: ctypes.c_uint32, np.float64: ctypes.c_double,
           np.uint64: ctypes.c_uint64}


def _copy_array(ptr, n, dtype):
    if n == 0 or not ptr:
        return np.empty(0, dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(_CTYPES[dtype])),
        shape=(n,)).astype(dtype, copy=True)


class IngestEngine:
    """One engine: reader threads, staging and the intern table.

    `simd` / `backend` / `batch` / `ring_slots` are the `ingest_*`
    options (0 / "auto": the engine's default); an explicit SIMD mode
    the CPU lacks raises."""

    def __init__(self, max_packet: int = 4096,
                 implicit_tags: Optional[list[str]] = None,
                 simd: str = "auto", backend: str = "auto",
                 batch: int = 0, ring_slots: int = 0):
        self.lib = load_library()
        tags_nl = "\n".join(implicit_tags or [])
        self.handle = ctypes.c_void_p(self.lib.vn_engine_new(
            max_packet, tags_nl.encode()))
        self._closed = False
        self._reader_tids: list[int] = []
        if simd != "auto":
            self._set_opt("simd", SIMD_MODES[simd])
        if backend != "auto":
            self._set_opt("backend", BACKEND_MODES[backend])
        if batch:
            self._set_opt("batch", batch)
        if ring_slots:
            self._set_opt("ring_slots", ring_slots)

    def _set_opt(self, key: str, val: int) -> None:
        if int(self.lib.vn_engine_opt(self.handle, key.encode(), val)) != 0:
            raise ValueError(f"engine rejected option {key}={val}")

    # -- feeding -------------------------------------------------------------

    def new_thread(self) -> int:
        return int(self.lib.vn_thread_new(self.handle))

    def ingest(self, tid: int, datagram: bytes) -> None:
        """Parse and stage one datagram on thread id `tid` (one feeding
        thread per id)."""
        self.lib.vn_ingest(self.handle, tid, datagram, len(datagram))

    def add_udp_reader(self, fd: int, pin_cpu: int = -1) -> int:
        """Start a C++ reader loop on a bound UDP socket's fd (io_uring
        multishot receive where the kernel allows it, recvmmsg
        otherwise), pinned to a CPU if pin_cpu >= 0.  The fd must stay
        open until stop() has joined the reader."""
        tid = int(self.lib.vn_add_udp_reader_pinned(self.handle, fd,
                                                    pin_cpu))
        self._reader_tids.append(tid)
        return tid

    def reader_backend(self, tid: int) -> str:
        """The receive backend a reader thread resolved to."""
        return BACKEND_NAMES.get(
            int(self.lib.vn_reader_backend(self.handle, tid)), "none")

    def simd_mode(self) -> str:
        """The resolved SIMD dispatch mode."""
        return SIMD_NAMES.get(int(self.lib.vn_simd_mode(self.handle)),
                              "scalar")

    def stop(self) -> None:
        """Stop and join every reader thread (each sees the stop within
        its 100 ms poll)."""
        if not self._closed:
            self.lib.vn_stop(self.handle)

    def close(self) -> None:
        if not self._closed:
            self.lib.vn_engine_free(self.handle)
            self._closed = True

    # -- draining ------------------------------------------------------------

    def drain(self, clear_intern: bool = False) -> DrainBatch:
        lib = self.lib
        d = ctypes.c_void_p(
            (lib.vn_drain_clear if clear_intern else lib.vn_drain)(
                self.handle))
        try:
            a, b, c = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()

            def sec(which):
                return lib.vn_drain_section(d, which, ctypes.byref(a),
                                            ctypes.byref(b), ctypes.byref(c))

            n = sec(0)
            c_ids = _copy_array(a.value, n, np.uint32)
            c_vals = _copy_array(b.value, n, np.float64)
            n = sec(1)
            g_ids = _copy_array(a.value, n, np.uint32)
            g_vals = _copy_array(b.value, n, np.float64)
            n = sec(2)
            h_ids = _copy_array(a.value, n, np.uint32)
            h_vals = _copy_array(b.value, n, np.float64)
            h_wts = _copy_array(c.value, n, np.float64)
            n = sec(3)
            s_ids = _copy_array(a.value, n, np.uint32)
            s_hashes = _copy_array(b.value, n, np.uint64)

            n_keys = sec(4)
            keys_blob = (ctypes.string_at(a.value, b.value or 0)
                         if n_keys else b"")
            new_keys = []
            off = 0
            for _ in range(n_keys):
                kid, mt, sc, nlen, tlen = struct.unpack_from(
                    "<IBBII", keys_blob, off)
                off += 14
                name = keys_blob[off:off + nlen].decode(errors="replace")
                off += nlen
                joined = keys_blob[off:off + tlen].decode(errors="replace")
                off += tlen
                new_keys.append(NewKey(
                    id=kid, mtype=_TYPE_NAMES[mt], scope=MetricScope(sc),
                    name=name, joined_tags=joined))

            nbytes = sec(5)
            other = []
            if nbytes:
                oblob = ctypes.string_at(a.value, nbytes)
                off = 0
                while off < nbytes:
                    (ln,) = struct.unpack_from("<I", oblob, off)
                    off += 4
                    other.append(oblob[off:off + ln])
                    off += ln

            stats = (ctypes.c_ulonglong * 4)()
            lib.vn_drain_stats(d, stats)
            return DrainBatch(
                c_ids=c_ids, c_vals=c_vals, g_ids=g_ids, g_vals=g_vals,
                h_ids=h_ids, h_vals=h_vals, h_wts=h_wts,
                s_ids=s_ids, s_hashes=s_hashes,
                new_keys=new_keys, other=other,
                processed=int(stats[0]), malformed=int(stats[1]),
                packets=int(stats[2]), too_long=int(stats[3]))
        finally:
            lib.vn_drain_free(d)

    def totals(self) -> tuple[int, int, int, int]:
        """(processed, malformed, packets, too_long) summed over every
        past drain: the engine updates them at drain time, so they never
        run ahead of what has been drained."""
        out = (ctypes.c_ulonglong * 4)()
        self.lib.vn_totals(self.handle, out)
        return tuple(int(x) for x in out)

    def intern_count(self) -> int:
        return int(self.lib.vn_intern_count(self.handle))

    def thread_counts(self) -> list[tuple[int, int, int]]:
        """(datagrams received, datagrams parsed, values staged) of each
        thread id: a reader thread counts a datagram received when it
        comes off the socket, and parsed, with its values, once its
        burst is published (drainable); a thread fed through ingest()
        counts no datagram received."""
        n = int(self.lib.vn_stage_thread_count(self.handle))
        if n <= 0:
            return []
        buf = (ctypes.c_ulonglong * (n * 8))()
        n = int(self.lib.vn_stage_stats(self.handle, buf, n))
        return [(int(buf[t * 8]), int(buf[t * 8 + 2]), int(buf[t * 8 + 6]))
                for t in range(n)]

    def stage_stats(self) -> dict:
        """Per-stage data-plane counters: {"threads": [...], "totals":
        {...}, "readers": {tid: backend}, "simd": mode}.  Each thread
        row and the totals carry a monotonic count (STAGE_UNITS) and
        nanoseconds per stage: recvmmsg is the receive syscalls and the
        wait for packets (reader threads only), parse the line scanning
        less the intern and stage shares, intern the identity interning,
        stage the value parse and columnar append, drain the
        consolidation pass on the drainer thread."""
        n = int(self.lib.vn_stage_thread_count(self.handle))
        threads = []
        if n > 0:
            buf = (ctypes.c_ulonglong * (n * 8))()
            n = int(self.lib.vn_stage_stats(self.handle, buf, n))
            for t in range(n):
                row = buf[t * 8:(t + 1) * 8]
                threads.append({
                    "recvmmsg": {"packets": int(row[0]), "ns": int(row[1])},
                    "parse": {"packets": int(row[2]), "ns": int(row[3])},
                    "intern": {"calls": int(row[4]), "ns": int(row[5])},
                    "stage": {"values": int(row[6]), "ns": int(row[7])},
                })
        d3 = (ctypes.c_ulonglong * 3)()
        self.lib.vn_stage_drain(self.handle, d3)
        totals: dict = {
            name: {k: sum(t[name][k] for t in threads)
                   for k in (STAGE_UNITS[name], "ns")}
            for name in STAGES[:-1]}
        totals["drain"] = {"calls": int(d3[0]), "packets": int(d3[1]),
                           "ns": int(d3[2])}
        readers = {str(t): self.reader_backend(t)
                   for t in self._reader_tids}
        return {"threads": threads, "totals": totals, "readers": readers,
                "simd": self.simd_mode()}


@dataclass
class _IdInfo:
    key: MetricKey
    row_scope: MetricScope   # the arena row class (per-family mapping)
    tags: list[str]
    uts_bytes: Optional[bytes]   # unique-timeseries HLL insert, if counted
    row: int = -1
    meta: object = None      # the row's RowMeta, to revalidate after GC
    # histogram family dispatch: the arena this id's row lives in
    arena: object = None
    # the cardinality guard's epoch this binding was made under; an
    # interval-end eviction bumps it, and the id re-resolves
    card_epoch: int = -1


class NativeIngest:
    """Applies engine drains to a MetricAggregator's arenas
    (`veneur_tpu/ingest/__init__.py:608`).

    Keeps the engine id -> arena row mapping, revalidated against the
    row GC: a row idle for IDLE_GC_INTERVALS flushes is recycled while
    the engine id outlives it, so a stale entry re-upserts through
    `row_for`.  With the aggregator's cardinality guard armed, each
    drained id goes through `guard.resolve` with its staged-sample
    count (the touch counts its eviction orders by), and a binding made
    under an older guard epoch re-resolves, since the key may have moved
    between its exact row and its tenant's rollup row
    (`veneur_tpu/ingest/__init__.py:649-735`)."""

    # the flush's cut waits at most this long for the readers to publish
    # what they have taken off their sockets
    CUT_TIMEOUT_S = 10.0

    def __init__(self, aggregator, max_packet: int = 4096,
                 implicit_tags: Optional[list[str]] = None,
                 on_other: Optional[Callable[[bytes], None]] = None,
                 simd: str = "auto", backend: str = "auto",
                 batch: int = 0, ring_slots: int = 0):
        self.agg = aggregator
        self.engine = IngestEngine(max_packet, implicit_tags, simd=simd,
                                   backend=backend, batch=batch,
                                   ring_slots=ring_slots)
        self.on_other = on_other
        self._info: list[Optional[_IdInfo]] = []
        # engine ids whose identity can never produce a cube rollup (no
        # dimension matches, or the key is itself a cube row): static per
        # identity, so the drain skips them without rescanning tags
        self._cube_inert: set = set()
        self.malformed = 0
        self.too_long = 0
        self._drain_lock = threading.Lock()

    # -- key registration ----------------------------------------------------

    def _register(self, nk: NewKey) -> None:
        while len(self._info) <= nk.id:
            self._info.append(None)
        tags = nk.joined_tags.split(",") if nk.joined_tags else []
        key = MetricKey(nk.name, nk.mtype, nk.joined_tags)
        t = nk.mtype
        if t in ("counter", "gauge"):
            row_scope = (MetricScope.GLOBAL_ONLY
                         if nk.scope == MetricScope.GLOBAL_ONLY
                         else MetricScope.MIXED)
        elif t == "set":
            row_scope = (MetricScope.LOCAL_ONLY
                         if nk.scope == MetricScope.LOCAL_ONLY
                         else MetricScope.MIXED)
        else:
            row_scope = nk.scope
        uts = None
        if self.agg.count_unique_timeseries:
            # worker.go:301-345's locality rules
            # (MetricAggregator._sample_timeseries)
            if not self.agg.is_local:
                counted = True
            elif t in ("counter", "gauge"):
                counted = nk.scope != MetricScope.GLOBAL_ONLY
            else:       # histogram / timer / set
                counted = nk.scope == MetricScope.LOCAL_ONLY
            if counted:
                uts = metric_digest(
                    nk.name, nk.mtype, nk.joined_tags).to_bytes(8, "little")
        self._info[nk.id] = _IdInfo(key=key, row_scope=row_scope, tags=tags,
                                    uts_bytes=uts)

    def _resolve(self, ids: np.ndarray, arena_of) -> tuple:
        """Engine ids -> (rows, arenas of the unique ids, inverse index):
        each unique id resolves once through the cache, `row_for` only on
        first sight, after the row GC or after a guard epoch change;
        `arena_of(key, tags)` names the arena of an identity whose
        binding must be (re)made."""
        guard = self.agg.cardinality
        uids, inverse, counts = np.unique(ids, return_inverse=True,
                                          return_counts=True)
        urows = np.empty(len(uids), np.int64)
        arenas = []
        uts = self.agg.unique_ts
        for i, (uid, count) in enumerate(zip(uids.tolist(),
                                             counts.tolist())):
            info = self._info[uid]
            arena = info.arena
            stale = (info.row < 0 or arena is None
                     or arena.meta[info.row] is not info.meta)
            rolled = None
            if guard is not None:
                rolled = guard.resolve(info.key, info.row_scope, info.tags,
                                       count)
                if info.card_epoch != guard.epoch:
                    info.card_epoch = guard.epoch
                    stale = True
            if stale:
                key, scope, tags = (rolled if rolled is not None
                                    else (info.key, info.row_scope,
                                          info.tags))
                arena = arena_of(key, tags)
                info.row = arena.row_for(key, scope, tags)
                info.meta = arena.meta[info.row]
                info.arena = arena
            else:
                arena.touched[info.row] = True
            urows[i] = info.row
            arenas.append(arena)
            if uts is not None and info.uts_bytes is not None:
                uts.insert(info.uts_bytes)
        return urows[inverse], arenas, inverse

    def _rows_for(self, arena, ids: np.ndarray) -> np.ndarray:
        """Engine ids -> rows of one fixed arena."""
        return self._resolve(ids, lambda key, tags: arena)[0]

    def _hrows_for(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Histogram/timer ids under sketch-family dispatch -> (rows, fam)
        aligned with `ids`, fam coding the target arena: 0 digests, 1
        moments, 2 compactors."""
        agg = self.agg
        rows, arenas, inverse = self._resolve(ids, agg._histo_arena)
        codes = np.asarray([1 if a is agg.moments
                            else 2 if a is agg.compactors else 0
                            for a in arenas], np.int8)
        return rows, codes[inverse]

    # -- drain application ---------------------------------------------------

    def drain_into(self) -> DrainBatch:
        """Drain the engine and fold the batch into the arenas (one
        aggregator-lock hold); events and service checks then replay
        through on_other."""
        return self._drain(clear_intern=False)

    def reset_interning(self) -> DrainBatch:
        """A final drain, then clear the engine's intern table and the id
        cache (the intern map would otherwise grow with every identity
        ever seen); the engine restarts its ids at 0."""
        return self._drain(clear_intern=True)

    def drain_or_gc(self, intern_threshold: int) -> DrainBatch:
        """One drainer tick: a plain drain, or a drain and intern GC when
        the identity table has outgrown `intern_threshold`."""
        return self._drain(clear_intern=False,
                           intern_threshold=intern_threshold)

    def drain_cut(self) -> list[DrainBatch]:
        """The flush's drain: everything the readers have taken off their
        sockets before this call, and everything fed through ingest(),
        lands in the arenas before it returns.  A reader publishes its
        burst when it has parsed it, so this drains until the datagrams
        drained reach the datagrams received (or parsed, on a fed
        thread) at the call; raises TimeoutError after CUT_TIMEOUT_S."""
        batches = []
        with self._drain_lock:
            if self.engine._closed:
                return batches
            target = sum(max(r, p)
                         for r, p, _ in self.engine.thread_counts())
        deadline = time.monotonic() + self.CUT_TIMEOUT_S
        while True:
            with self._drain_lock:
                if self.engine._closed:
                    break
                batches.append(self._drain_apply(False))
                if self.engine.totals()[2] >= target:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"the flush's cut drained {self.engine.totals()[2]} of "
                    f"{target} datagrams received")
            time.sleep(0.0005)
        self._replay(batches)
        return batches

    def _drain(self, clear_intern: bool,
               intern_threshold: Optional[int] = None) -> DrainBatch:
        """The drain path: under the drain lock consolidate and apply
        (optionally wiping the intern table and the id cache), then
        replay punted events and service checks.  close() takes the same
        lock, so teardown cannot free the engine mid-call."""
        with self._drain_lock:
            if intern_threshold is not None and not self.engine._closed:
                clear_intern = self.engine.intern_count() > intern_threshold
            batch = self._drain_apply(clear_intern)
            if clear_intern:
                self._info = []
                self._cube_inert.clear()
        self._replay([batch])
        return batch

    def _replay(self, batches) -> None:
        if self.on_other:
            for batch in batches:
                for line in batch.other:
                    self.on_other(line)

    def _drain_apply(self, clear_intern: bool = False) -> DrainBatch:
        if self.engine._closed:
            return DrainBatch.void()
        batch = self.engine.drain(clear_intern)
        self.malformed += batch.malformed
        self.too_long += batch.too_long
        if batch.empty:
            return batch
        agg = self.agg
        with agg.lock:
            for nk in batch.new_keys:
                self._register(nk)
            agg.processed += batch.processed
            if len(batch.c_ids):
                rows = self._rows_for(agg.counters, batch.c_ids)
                agg.counters.sample_batch(rows, batch.c_vals)
            if len(batch.g_ids):
                rows = self._rows_for(agg.gauges, batch.g_ids)
                agg.gauges.merge_batch(rows, batch.g_vals)
            if len(batch.h_ids):
                if agg.family_dispatch:
                    rows, fam = self._hrows_for(batch.h_ids)
                    for code, arena in ((1, agg.moments),
                                        (2, agg.compactors),
                                        (0, agg.digests)):
                        sel = fam == code
                        if sel.any():
                            arena.sample_batch(rows[sel], batch.h_vals[sel],
                                               batch.h_wts[sel])
                else:
                    rows = self._rows_for(agg.digests, batch.h_ids)
                    agg.digests.sample_batch(rows, batch.h_vals,
                                             batch.h_wts)
                if agg.cubes is not None:
                    self._apply_cube_rollups(agg, agg.cubes, batch)
            if len(batch.s_ids):
                rows = self._rows_for(agg.sets, batch.s_ids)
                agg.sets.stage_hash_batch(rows, batch.s_hashes)
        return batch

    def _apply_cube_rollups(self, agg, cubes, batch) -> None:
        """Mirror the batch's histogram/timer samples into their cube
        rollup rows, the twin of what `_process_locked` does on the
        Python edge (under the same aggregator lock).  `rollups` runs per
        unique id per drain with the staged-sample count: budget
        admission and the conservation counters live there, so only the
        never-cubes verdict (static per identity) is cached."""
        ids = batch.h_ids
        order = np.argsort(ids, kind="stable")
        sids = ids[order]
        svals = batch.h_vals[order]
        swts = batch.h_wts[order]
        uids = np.unique(sids)
        bounds = np.searchsorted(sids, uids, side="left")
        ends = np.searchsorted(sids, uids, side="right")
        for uid, lo, hi in zip(uids.tolist(), bounds, ends):
            if uid in self._cube_inert:
                continue
            info = self._info[uid]
            targets = cubes.rollups(info.key, info.row_scope, info.tags,
                                    n=int(hi - lo))
            if not targets:
                self._cube_inert.add(uid)
                continue
            vals = svals[lo:hi]
            wts = swts[lo:hi]
            for ck, cs, ctags in targets:
                arena = agg._histo_arena(ck, ctags)
                row = arena.row_for(ck, cs, ctags)
                arena.sample_batch(np.full(len(vals), row, np.int64), vals,
                                   wts)

    def stats(self) -> Optional[dict]:
        """Totals and intern size, under the drain lock (None once
        closed)."""
        with self._drain_lock:
            if self.engine._closed:
                return None
            lines, malformed, packets, too_long = self.engine.totals()
            return {"lines": lines, "malformed": malformed,
                    "packets": packets, "too_long": too_long,
                    "intern_count": self.engine.intern_count()}

    def stage_stats(self) -> Optional[dict]:
        """`IngestEngine.stage_stats` under the drain lock (None once
        closed)."""
        with self._drain_lock:
            if self.engine._closed:
                return None
            return self.engine.stage_stats()

    def stop(self) -> None:
        self.engine.stop()

    def close(self) -> None:
        # serialized with an in-flight drain (the drainer thread may be
        # mid-apply while the server tears down)
        with self._drain_lock:
            self.engine.close()
