"""The server: DogStatsD listeners, flush ticker, sink fan-out, gRPC
forwarding and import, and the lifecycle the command line drives.

Counterpart of `veneur_tpu.core.server` (the reference `Server`,
`server.go:106-174,462-868`) for what this package serves: UDP statsd
listeners (SO_REUSEPORT sockets, `networking.go:54-107`) read by the
native ingest engine's C++ readers (`native_ingest`, the default;
`ingest/`) or by Python threads, TCP statsd listeners on Python
threads, events and service checks (`server.go:942-993`), the interval
flush ticker and the egress plane (`egress/`), which takes each flush's
metrics and events to the sinks on per-sink lanes, off the flush: with
`enable_metric_sink_routing` the flush computes each metric's sink
allowlist first, and each lane filters by it, by its sink's limits and
by `tags_exclude` before it delivers.  `egress.settle()` waits for the
lanes; `shutdown()` drains them, `crash()` does not.  With the
engine, a drainer thread folds its staged batches into the aggregator
every `ingest_drain_interval`, and each flush drains everything the
readers took off their sockets before it began; an engine that fails
to build or load makes start() raise.  `start()` runs the ticker;
`serve()` blocks until `stop_serving()`, `request_graceful_restart()` (SIGUSR2)
or `shutdown()`; `graceful_restart_drain()` hands the UDP ports to a
replacement that joined their SO_REUSEPORT groups without losing a
datagram (`server.go:1365-1413`).  A global tier (`grpc_address`)
serves the gRPC import source (`sources/proxy.py`); a local tier
(`forward_address`) hands each interval's forwardable metrics to its
forwarder, the gRPC `ForwardClient` unless the caller passes a
callable, on a pool of at most FORWARD_MAX_IN_FLIGHT concurrent
forwards (`wait_forwards` waits for them).  `query` is the live query
plane's engine; `http_api.HttpApi(server, address)` serves it over
HTTP, started by the caller.

Crash durability (`core/checkpoint.py`, `forward/spool.py`): with
`checkpoint_dir`, start() restores the last checkpoint before any
listener, import server or drain thread runs; `checkpoint_now()` writes
one coherent cut (the engine's staged lines drained first, then the
aggregator and the dedup ledger inside the ledger's pause gate, then
the file outside every lock), every `checkpoint_interval` and at
shutdown; each flush stamps a marker, so a checkpoint older than a
delivered flush does not restore its arenas.  With `spool_dir`, a
local's exhausted forwards spill to the durable spool and replay.
`crash()` is a simulated kill -9: no final flush, no shutdown
checkpoint, no spool drain.

The aggregation core is the batched MetricAggregator; its t-digest,
moments and compactor flushes run on `device` (CUDA unless the caller
names the CPU).  With `mesh_devices` the t-digest, set, counter and
unique-timeseries flush runs meshed (`parallel/mesh.py`) over that many
devices of `device`'s type: CUDA cards, or logical handles of the CPU.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import os
import select
import socket
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch import config as config_mod
from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.core import checkpoint as ckpt_mod
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.arena import CheckpointIncompatible
from veneur_tpu_torch.egress import EgressPlane
from veneur_tpu_torch.forward.client import ForwardClient, RetryPolicy
from veneur_tpu_torch.forward.spool import ForwardSpool
from veneur_tpu_torch.parallel import mesh as mesh_mod
from veneur_tpu_torch.query.engine import QueryEngine
from veneur_tpu_torch.samplers import parser as parser_mod
from veneur_tpu_torch.samplers import samplers as sm
from veneur_tpu_torch.sources.proxy import DedupLedger, GrpcImportServer
from veneur_tpu_torch.util import matcher as matcher_mod
from veneur_tpu_torch.util import tagging

logger = logging.getLogger("veneur_tpu_torch.server")


def parse_listen_addr(addr: str) -> tuple[str, str, int]:
    """'udp://host:port' -> (scheme, host, port); bare 'host:port' is
    udp.  IPv6 hosts are bracketed ('udp://[::1]:0')."""
    scheme, rest = addr.split("://", 1) if "://" in addr else ("udp", addr)
    host, _, port = rest.rpartition(":")
    return scheme, host.strip("[]"), int(port)


class Server:
    STREAM_IDLE_TIMEOUT_S = 600.0
    # a UDP reader wakes this often to see whether it should stop, and
    # takes at most this many queued datagrams under its lock at once
    READER_POLL_MS = 200
    READER_BATCH = 64
    # concurrent forwards; a flush that finds every slot taken drops its
    # interval's batch and counts it in forward_dropped
    FORWARD_MAX_IN_FLIGHT = 4

    def __init__(self, cfg: config_mod.Config,
                 extra_metric_sinks: Optional[list] = None,
                 forwarder: Optional[
                     Callable[[list[sm.ForwardMetric]], None]] = None,
                 device=None):
        self.config = cfg
        self.parser = parser_mod.Parser(tagging.ExtendTags(cfg.extend_tags))
        # the sharded serving flush over (shard, replica)
        # (`veneur_tpu/core/server.py:188-198`)
        self.mesh = None
        if cfg.mesh_devices > 0:
            self.mesh = mesh_mod.make_mesh(cfg.mesh_devices,
                                           cfg.mesh_replicas or None,
                                           device=device)
        self.aggregator = MetricAggregator(
            percentiles=list(cfg.percentiles),
            aggregates=sm.parse_aggregates(cfg.aggregates),
            compression=cfg.tdigest_compression,
            set_precision=cfg.set_precision,
            count_unique_timeseries=cfg.count_unique_timeseries,
            is_local=cfg.is_local,
            initial_capacity=cfg.arena_initial_capacity,
            set_initial_capacity=cfg.set_arena_initial_capacity,
            hll_legacy_migration=cfg.hll_legacy_migration,
            sketch_family_default=cfg.sketch_family_default,
            sketch_family_rules=list(cfg.sketch_family_rules),
            sketch_moments_k=cfg.sketch_moments_k,
            sketch_compactor_cap=cfg.sketch_compactor_cap,
            sketch_compactor_levels=cfg.sketch_compactor_levels,
            sketch_compactor_seed=cfg.sketch_compactor_seed,
            digest_bf16_staging=cfg.digest_bf16_staging,
            query_window_slots=cfg.query_window_slots,
            query_slot_seconds=cfg.query_slot_seconds or cfg.interval,
            cube_dimensions=list(cfg.cube_dimensions),
            cube_group_budget=cfg.cube_group_budget,
            cube_seed=cfg.cube_seed,
            cardinality_key_budget=cfg.cardinality_key_budget,
            cardinality_tenant_tag=cfg.cardinality_tenant_tag,
            cardinality_seed=cfg.cardinality_seed,
            cardinality_rollup_family=cfg.cardinality_rollup_family,
            mesh=self.mesh,
            ingest_lanes=cfg.ingest_lanes or None,
            device=device)
        # the live query plane's read path over the aggregator's window
        # rings; it exists with the rings off too, so /query answers a
        # clean 404
        self.query = QueryEngine(
            self.aggregator, tier="local" if cfg.is_local else "global",
            hostname=cfg.hostname)
        if cfg.is_local and forwarder is None:
            # the persistent forward connection (server.go:810-828).
            # At most FORWARD_MAX_IN_FLIGHT forwards run at once, so the
            # deadline may floor at the reference's default interval.
            # With spool_dir, exhausted forwards spill to the durable
            # spool, whose replayer the client starts
            spool = None
            if cfg.spool_dir:
                spool = ForwardSpool(
                    os.path.expanduser(cfg.spool_dir),
                    max_bytes=cfg.spool_max_bytes,
                    max_age_s=cfg.spool_max_age, fsync=cfg.spool_fsync,
                    segment_max_bytes=cfg.spool_segment_max_bytes,
                    replay_interval_s=cfg.spool_replay_interval)
            forwarder = ForwardClient(
                cfg.forward_address,
                timeout_s=cfg.forward_timeout or max(cfg.interval, 10.0),
                max_streams=cfg.forward_streams,
                retry=RetryPolicy(
                    attempts=cfg.forward_max_retries + 1,
                    backoff_base_s=cfg.forward_retry_backoff),
                spool=spool, source=cfg.hostname,
                deadline_retry_safe=cfg.forward_deadline_retry_safe)
        self.forwarder = forwarder
        self._forward_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.FORWARD_MAX_IN_FLIGHT + 2,
            thread_name_prefix="forward")
        self._forward_slots = threading.BoundedSemaphore(
            self.FORWARD_MAX_IN_FLIGHT)
        self._forward_lock = threading.Lock()
        self.forward_dropped = 0
        # the import source of a global tier (started by start()) and
        # its dedup ledger; proto_received counts imports by transport
        self.grpc_import: Optional[GrpcImportServer] = None
        self.dedup = (DedupLedger(cfg.spool_dedup_window)
                      if cfg.grpc_address else None)
        self.proto_received: collections.Counter = collections.Counter()
        self._proto_lock = threading.Lock()
        # crash durability: the checkpoint ledger (the JAX package's
        # /debug/vars -> checkpoint keys, and the durations of the last
        # write, its lock hold and the restore), the checkpoint writers'
        # lock, and crash()'s flag
        self.checkpoint_stats = {
            "enabled": bool(cfg.checkpoint_dir),
            "writes": 0, "restores": 0, "errors": 0,
            # checkpoints whose arenas a later delivered flush made stale
            "stale_skips": 0,
            "last_bytes": 0, "last_unix": 0.0,
            # age of the restored checkpoint at boot, 0 on a cold start
            "age_ms": 0.0,
            "last_ms": 0.0, "last_capture_ms": 0.0, "restore_ms": 0.0,
        }
        self._checkpoint_write_lock = threading.Lock()
        self._crashed = False
        # sinks: the configured kinds, then the injected instances, each
        # with the spec its lane filters by
        specs = list(cfg.metric_sinks) + [
            sink_mod.SinkSpec(kind=s.kind(), name=s.name())
            for s in (extra_metric_sinks or [])]
        self.metric_sinks = [sink_mod.create_metric_sink(spec, cfg)
                             for spec in cfg.metric_sinks]
        self.metric_sinks.extend(extra_metric_sinks or [])
        # tags_exclude rules: "key" (every sink) or "key|sink1|sink2"
        # (those sinks only) — setSinkExcludedTags, server.go:660,1456-1463
        self._tags_exclude_global: set[str] = set()
        self._tags_exclude_by_sink: dict[str, set[str]] = {}
        for rule in cfg.tags_exclude:
            parts = str(rule).split("|")
            key = parts[0]
            if not key:
                continue
            if len(parts) > 1:
                for sink_name in parts[1:]:
                    if sink_name:
                        self._tags_exclude_by_sink.setdefault(
                            sink_name, set()).add(key)
            else:
                self._tags_exclude_global.add(key)
        # the self-metrics client the egress lanes emit through; None is
        # the no-op client (stats_address comes with ROADMAP A16)
        self.statsd = None
        # the egress plane: bounded per-sink queues and worker lanes
        # that take the sink fan-out (filtering, serialization, HTTP,
        # retries, spool spill) off the flush; flush() only enqueues
        self.egress = EgressPlane(
            interval_s=cfg.interval,
            queue_depth=cfg.egress_queue_depth,
            retry=RetryPolicy(
                attempts=cfg.egress_max_retries + 1,
                backoff_base_s=cfg.egress_retry_backoff,
                seed=cfg.egress_retry_seed),
            breaker_threshold=cfg.egress_breaker_threshold,
            breaker_reset_s=cfg.egress_breaker_reset,
            spool_dir=(os.path.expanduser(cfg.egress_spool_dir)
                       if cfg.egress_spool_dir else ""),
            spool_max_bytes=cfg.egress_spool_max_bytes,
            spool_max_age_s=cfg.egress_spool_max_age,
            spool_fsync=cfg.spool_fsync,
            spool_replay_interval_s=cfg.egress_spool_replay_interval,
            routing_enabled=cfg.enable_metric_sink_routing,
            excluded_tags_for=self._excluded_tags_for,
            statsd_fn=lambda: self.statsd)
        for spec, sink in zip(specs, self.metric_sinks):
            self.egress.add_metric_sink(spec, sink)
        # events accumulate between flushes (EventWorker, worker.go:491-536)
        self._events: list[parser_mod.SSFSample] = []
        self._events_lock = threading.Lock()
        self.parse_errors = 0
        self.too_long = 0
        self.forward_errors = 0
        # the native ingest engine (start() builds it when native_ingest
        # is on and a UDP listener is configured)
        self.native = None
        self.flush_count = 0
        self.last_flush = None      # FlushResult of the last flush
        self._flush_serial = threading.Lock()
        # _shutdown stops the ticker, serve() and the TCP accept loop;
        # the readers stop on _readers_stop, which only shutdown() sets:
        # after SIGUSR2 they go on reading the queued tail
        self._shutdown = threading.Event()
        self._readers_stop = threading.Event()
        self._graceful_restart = False      # set by SIGUSR2
        self._intake_stopped = False
        self._closed = False
        self._close_lock = threading.Lock()
        self._listeners: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        # the UDP and stream readers, joined before the final flush, and
        # the UDP readers' locks, which flush() takes in turn
        self._reader_threads: list[threading.Thread] = []
        self._reader_locks: list[threading.Lock] = []
        self._stream_conns: set = set()
        self._conns_lock = threading.Lock()
        self.statsd_addrs: list[tuple[str, tuple]] = []

    @property
    def is_local(self) -> bool:
        return self.config.is_local

    def resolved_ports(self) -> dict:
        """The bound addresses after start(), for a supervisor when the
        listeners bound port 0 (the CLI writes this to `port_file`)."""
        return {
            "statsd": [[scheme, list(addr)]
                       for scheme, addr in self.statsd_addrs],
            "grpc": (self.grpc_import.port
                     if self.grpc_import is not None else 0),
            "hostname": self.config.hostname,
        }

    # -- ingestion handlers (server.go:942-1011) -----------------------------

    def handle_metric_packet(self, packet: bytes) -> None:
        """Dispatch one line: event / service check / metric."""
        if not packet:
            return
        try:
            if packet.startswith(b"_e{"):
                sample = self.parser.parse_event(packet)
                with self._events_lock:
                    self._events.append(sample)
            elif packet.startswith(b"_sc"):
                self.aggregator.process_metric(
                    self.parser.parse_service_check(packet))
            else:
                self.parser.parse_metric(packet,
                                         self.aggregator.process_metric)
        except (parser_mod.ParseError, UnicodeDecodeError) as e:
            # a line that is not UTF-8 costs that line alone, as in the
            # reference (ROADMAP C17): the parser raises
            # UnicodeDecodeError for it (C16), which must neither end a
            # reader thread nor fail the flush that replays the line
            with self._events_lock:
                self.parse_errors += 1
            logger.debug("could not parse packet %r: %s", packet[:64], e)

    def process_packet_buffer(self, buf: bytes) -> None:
        """Newline-split a datagram (processMetricPacket,
        server.go:1109-1133)."""
        if len(buf) > self.config.metric_max_length:
            logger.debug("packet too long (%d bytes)", len(buf))
            with self._events_lock:
                self.too_long += 1
            return
        for line in buf.split(b"\n"):
            if line:
                self.handle_metric_packet(line)

    # -- listeners (networking.go) -------------------------------------------

    def start(self) -> None:
        """Bind the statsd listeners, start their readers and the flush
        ticker (one flush every `interval` seconds).  With native_ingest
        and a UDP listener, the native engine reads UDP (C++ readers)
        and a drainer thread folds its batches in; a failed build or
        load of the engine raises.  With checkpoint_dir the checkpoint
        restores first, before anything can race the arena rebuild."""
        cfg = self.config
        if cfg.checkpoint_dir:
            self._maybe_restore_checkpoint()
        if cfg.native_ingest and any(
                parse_listen_addr(a)[0] == "udp"
                for a in cfg.statsd_listen_addresses):
            from veneur_tpu_torch.ingest import NativeIngest
            self.native = NativeIngest(
                self.aggregator, max_packet=cfg.metric_max_length,
                implicit_tags=list(cfg.extend_tags),
                on_other=self.handle_metric_packet, simd=cfg.ingest_simd,
                backend=cfg.ingest_backend, batch=cfg.ingest_reader_batch,
                ring_slots=cfg.ingest_ring_slots)
        for sink in self.metric_sinks:
            sink.start(None)
        # the lanes start once the sinks have (they may replay at once
        # what a crash left in their spools)
        self.egress.start()
        for addr in self.config.statsd_listen_addresses:
            self._start_statsd(addr)
        if self.config.grpc_address:
            # global tier: the gRPC import source (server.go:673-682)
            self.grpc_import = GrpcImportServer(
                self.config.grpc_address, self._import_counted,
                self._import_payload_counted,
                handle_packet=self._grpc_packet_counted, dedup=self.dedup)
            self.grpc_import.start()
        if self.native is not None:
            self._spawn(self._native_drain_loop, "ingest-drain")
        self._spawn(self._ticker, "flush-ticker")
        if cfg.checkpoint_dir and cfg.checkpoint_interval > 0:
            self._spawn(self._checkpoint_loop, "checkpoint-loop")

    def _count_drained(self, batch) -> None:
        """Account a native drain: its datagrams as received over udp,
        its malformed lines and oversized datagrams as the Python path
        counts them."""
        if batch.packets:
            self._count_proto("udp", batch.packets)
        if batch.malformed or batch.too_long:
            with self._events_lock:
                self.parse_errors += batch.malformed
                self.too_long += batch.too_long

    def _drain_native(self) -> None:
        """Fold what the native engine has staged into the aggregator."""
        if self.native is not None:
            self._count_drained(self.native.drain_into())

    def _native_drain_loop(self) -> None:
        iv = self.config.ingest_drain_interval or min(
            self.config.interval / 10.0, 0.5)
        while not self._shutdown.wait(iv):
            try:
                self._count_drained(self.native.drain_or_gc(
                    self.config.intern_gc_threshold))
            except Exception:
                logger.exception("native ingest drain failed")

    def _count_proto(self, proto: str, n: int) -> None:
        with self._proto_lock:
            self.proto_received[proto] += n

    def _import_counted(self, fm: sm.ForwardMetric) -> None:
        self.aggregator.import_metric(fm)
        self._count_proto("grpc", 1)

    def _import_payload_counted(self, payload: bytes) -> tuple[int, int]:
        ok, failed = self.aggregator.import_payload(payload)
        self._count_proto("grpc", ok)
        return ok, failed

    def _grpc_packet_counted(self, buf: bytes) -> None:
        """DogStatsD bytes over gRPC (networking.go:347)."""
        self._count_proto("dogstatsd-grpc", 1)
        self.process_packet_buffer(buf)

    def _spawn(self, target, name: str, *args) -> threading.Thread:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name)
        t.start()
        self._threads.append(t)
        return t

    def _start_statsd(self, addr: str) -> None:
        scheme, host, port = parse_listen_addr(addr)
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        if scheme == "udp":
            bound = None
            n_socks = max(1, self.config.num_readers)
            if self.native is not None and self.config.ingest_reader_shards:
                n_socks = self.config.ingest_reader_shards
            n_cpus = os.cpu_count() or 1
            for i in range(n_socks):
                sock = socket.socket(family, socket.SOCK_DGRAM)
                # SO_REUSEPORT kernel load balancing (socket_linux.go:26-28)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                self.config.read_buffer_size_bytes)
                sock.bind((host, port))
                if bound is None:
                    bound = sock.getsockname()
                    port = bound[1]          # resolve port 0
                self._listeners.append(sock)
                if self.native is not None:
                    # a C++ reader owns this socket until native.stop()
                    self.native.engine.add_udp_reader(
                        sock.fileno(), pin_cpu=(
                            i % n_cpus if self.config.ingest_reader_pinning
                            else -1))
                    continue
                lock = threading.Lock()
                self._reader_locks.append(lock)
                self._reader_threads.append(self._spawn(
                    self._read_udp, f"statsd-udp-{i}", sock, lock))
            self.statsd_addrs.append(("udp", bound))
        elif scheme == "tcp":
            sock = socket.socket(family, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            sock.listen(128)
            self._listeners.append(sock)
            self._spawn(self._accept_tcp, "statsd-tcp", sock)
            self.statsd_addrs.append(("tcp", sock.getsockname()))
        else:
            raise NotImplementedError(
                f"statsd listener scheme {scheme!r} is not supported "
                "(udp and tcp are)")

    def _read_udp(self, sock: socket.socket, lock: threading.Lock) -> None:
        """Read one UDP socket until _readers_stop.  A datagram is taken
        off the socket and processed under `lock`, which flush() takes
        before its cut: whatever a reader has received before a flush
        began is in that flush's interval."""
        # +1 so an oversized datagram trips the too-long guard instead of
        # truncating into a parseable prefix (server.go:734)
        bufsize = self.config.metric_max_length + 1
        poller = select.poll()
        poller.register(sock, select.POLLIN)
        while not self._readers_stop.is_set():
            if not poller.poll(self.READER_POLL_MS):
                continue
            with lock:
                for _ in range(self.READER_BATCH):
                    try:
                        data = sock.recv(bufsize, socket.MSG_DONTWAIT)
                    except BlockingIOError:
                        break
                    except OSError:
                        return
                    if not data:    # an empty datagram, or shut down
                        break
                    self.process_packet_buffer(data)

    def _accept_tcp(self, sock: socket.socket) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            self._reader_threads.append(
                self._spawn(self._read_stream, "statsd-tcp-conn", conn))

    def _read_stream(self, conn: socket.socket) -> None:
        max_line = max(65536, self.config.metric_max_length)
        with self._conns_lock:
            self._stream_conns.add(conn)
        try:
            conn.settimeout(self.STREAM_IDLE_TIMEOUT_S)
            buf = b""
            while not self._readers_stop.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                buf += data
                *lines, buf = buf.split(b"\n")
                for line in lines:
                    self.handle_metric_packet(line)
                if len(buf) > max_line:
                    return      # a line that never ends: drop the stream
            self.handle_metric_packet(buf)
        except OSError as e:
            logger.debug("stream connection error: %s", e)
        finally:
            with self._conns_lock:
                self._stream_conns.discard(conn)
            conn.close()

    # -- flush ---------------------------------------------------------------

    def flush(self):
        """One flush interval: evaluate, hand the metrics and events to
        the egress plane's lanes (egress.settle() waits for their
        delivery), and on a local tier submit the forwardable metrics to
        the forward pool (wait_forwards waits for them).  Serialized
        across callers.  Whatever a UDP reader has taken off its socket
        before the flush began is in its interval (the native engine's
        cut, or each Python reader's lock).  Returns the FlushResult."""
        with self._flush_serial:
            if self.native is not None:
                for batch in self.native.drain_cut():
                    self._count_drained(batch)
            for lock in self._reader_locks:
                with lock:      # the datagram a reader holds goes first
                    pass
            res = self.aggregator.flush(is_local=self.is_local)
            self.flush_count += 1
            with self._events_lock:
                events, self._events = self._events, []
            # sink routing (flusher.go:97-113)
            if self.config.enable_metric_sink_routing:
                res.metrics.apply_routing(self.config.metric_sink_routing,
                                          matcher_mod.match)
            if self.is_local and res.forward:
                self._submit_forward(res.forward)
            # the sink fan-out: hand the rendered interval to the egress
            # lanes and return; a slow or dead backend costs its own
            # lane, never the flush
            self.egress.submit_interval(res.metrics, events, self.statsd,
                                        self.flush_count)
            self.last_flush = res
            if self.config.checkpoint_dir:
                # the flush is delivered: a checkpoint older than this
                # marker must not restore its arenas
                try:
                    ckpt_mod.write_flush_marker(
                        os.path.expanduser(self.config.checkpoint_dir),
                        self.flush_count)
                except OSError as e:
                    logger.warning("flush marker write failed: %s", e)
            return res

    def _excluded_tags_for(self, sink_name: str):
        """tags_exclude keys applying to this sink (global ∪ sink-scoped);
        None when no rules are configured (fast path)."""
        per_sink = self._tags_exclude_by_sink.get(sink_name)
        if per_sink is None:
            return self._tags_exclude_global or None
        return self._tags_exclude_global | per_sink

    def _submit_forward(self, forward: list) -> None:
        """Run one interval's forward on the pool under a slot; with
        every slot taken (stalled forwards), drop the batch rather than
        queue without bound (`veneur_tpu/core/server.py:1615-1645`)."""
        if self._forward_slots.acquire(blocking=False):
            try:
                self._forward_pool.submit(self._forward_safely, forward,
                                          self.flush_count)
                return
            except RuntimeError:        # the pool shut down mid-flush
                self._forward_slots.release()
        else:
            logger.warning("%d forwards in flight; dropped %d forward "
                           "metrics", self.FORWARD_MAX_IN_FLIGHT,
                           len(forward))
        with self._forward_lock:
            self.forward_dropped += len(forward)

    def _forward_safely(self, forward: list, epoch: int) -> None:
        """One forward on the pool; `epoch` (the flush count) is the
        interval half of each V1 chunk's identity."""
        try:
            if getattr(self.forwarder, "accepts_epoch", False):
                self.forwarder(forward, epoch=epoch)
            else:
                self.forwarder(forward)
        except Exception:
            with self._forward_lock:
                self.forward_errors += 1
            logger.exception("forward of %d metrics failed", len(forward))
        finally:
            self._forward_slots.release()

    def wait_forwards(self, timeout_s: float = 10.0) -> bool:
        """Wait until no forward is in flight; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while self._forward_slots._value < self.FORWARD_MAX_IN_FLIGHT:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def _ticker(self) -> None:
        """One flush an interval (server.go:830-867), on a schedule that
        the flushes' own time does not shift; with
        synchronize_with_interval the first waits for the next
        wall-clock multiple of the interval."""
        interval = self.config.interval
        if self.config.synchronize_with_interval:
            if self._shutdown.wait(interval - time.time() % interval):
                return
        next_tick = time.time() + interval
        while not self._shutdown.wait(max(0.0, next_tick - time.time())):
            next_tick += interval
            try:
                self.flush()
            except Exception:
                logger.exception("flush failed")

    # -- crash durability (core/checkpoint.py) -------------------------------

    def _maybe_restore_checkpoint(self) -> None:
        """Boot-time restore (`server.py:1240-1306` of the JAX package):
        rebuild the arenas, resume the interval count and refill the
        dedup ledger from the last committed checkpoint.  A missing or
        corrupt file is a cold start; so is a checkpoint written under
        other sketch parameters (prechecked before any arena mutates).
        A checkpoint older than the last delivered flush restores the
        count and the ledger but not the arenas.  A restore that fails
        mid-rebuild raises: no half-restored server runs."""
        t0 = time.perf_counter()
        ckpt_dir = os.path.expanduser(self.config.checkpoint_dir)
        loaded = ckpt_mod.read_checkpoint(ckpt_dir)
        if loaded is None:
            return
        meta, arrays = loaded
        marker = ckpt_mod.read_flush_marker(ckpt_dir)
        if (marker is not None and int(marker.get("flush_count", 0))
                > int(meta.get("flush_count", 0))):
            # its arenas hold data a later flush delivered, which a
            # revived sender would re-forward under a fresh boot nonce
            self.flush_count = int(marker["flush_count"])
            if self.dedup is not None and meta.get("dedup") is not None:
                self.dedup.restore(meta["dedup"])
            self.checkpoint_stats["stale_skips"] += 1
            logger.warning(
                "checkpoint (interval %s) predates the last completed "
                "flush (interval %s): arenas not restored; interval "
                "count and dedup ledger resumed",
                meta.get("flush_count"), marker["flush_count"])
            return
        try:
            self.aggregator.restore_state(meta["aggregator"], arrays)
            self.flush_count = int(meta.get("flush_count", 0))
            if self.dedup is not None and meta.get("dedup") is not None:
                self.dedup.restore(meta["dedup"])
        except CheckpointIncompatible as e:
            logger.warning("checkpoint incompatible with the current "
                           "configuration (%s); cold start", e)
            return
        except Exception:
            logger.critical("checkpoint restore failed mid-rebuild; "
                            "refusing to run half-restored (delete %s "
                            "to cold-start)", self.config.checkpoint_dir)
            raise
        age_ms = max(0.0, (time.time()
                           - float(meta.get("written_unix", 0.0))) * 1e3)
        self.checkpoint_stats["restores"] += 1
        self.checkpoint_stats["age_ms"] = round(age_ms, 1)
        self.checkpoint_stats["restore_ms"] = (time.perf_counter()
                                               - t0) * 1e3
        logger.info("restored checkpoint: interval %d, %d processed / %d "
                    "imported, %.0f ms old", self.flush_count,
                    self.aggregator.processed, self.aggregator.imported,
                    age_ms)

    def checkpoint_now(self) -> bool:
        """Write one checkpoint (`server.py:1308-1358` of the JAX
        package): the native engine's staged lines are drained into the
        aggregator first; then, inside the dedup ledger's pause gate
        (imports in flight drain and new ones wait), the aggregator's
        cut and the ledger's snapshot, so a chunk's data and its
        identity land on the same side; then the atomic write, outside
        every lock.  Returns False, counted in errors, when the write
        fails; the previous checkpoint stays live either way."""
        t0 = time.perf_counter()
        self._drain_native()
        with self._checkpoint_write_lock:
            gate = (self.dedup.paused() if self.dedup is not None
                    else contextlib.nullcontext())
            with gate:
                agg_meta, arrays = self.aggregator.checkpoint_state()
                meta = {
                    "aggregator": agg_meta,
                    "flush_count": self.flush_count,
                    "hostname": self.config.hostname,
                    "dedup": (self.dedup.snapshot()
                              if self.dedup is not None else None),
                }
            try:
                nbytes = ckpt_mod.write_checkpoint(
                    os.path.expanduser(self.config.checkpoint_dir),
                    meta, arrays)
            except Exception as e:   # noqa: BLE001 - counted, reported
                self.checkpoint_stats["errors"] += 1
                logger.error("checkpoint write failed (previous "
                             "checkpoint stays live): %s", e)
                return False
        st = self.checkpoint_stats
        st["writes"] += 1
        st["last_bytes"] = nbytes
        st["last_unix"] = time.time()
        st["last_ms"] = (time.perf_counter() - t0) * 1e3
        st["last_capture_ms"] = self.aggregator.last_capture_s * 1e3
        return True

    def _checkpoint_loop(self) -> None:
        iv = self.config.checkpoint_interval
        while not self._shutdown.wait(iv):
            try:
                self.checkpoint_now()
            except Exception:
                logger.exception("periodic checkpoint failed")

    def crash(self) -> None:
        """A simulated kill -9: tear down without the graceful exits (no
        final flush, no shutdown checkpoint, no spool drain).  What was
        in memory is gone; what reached the checkpoint and spool
        directories is what a revived server gets."""
        self._crashed = True
        self.shutdown()

    # -- lifecycle -----------------------------------------------------------

    def serve(self) -> None:
        """Block until stop_serving(), request_graceful_restart() or
        shutdown().  The flushes run on the ticker that start() spawned,
        so start() alone and start() + serve() both flush once an
        interval."""
        while not self._shutdown.wait(1.0):
            pass

    def stop_serving(self) -> None:
        """Unblock serve() without tearing down (signal-handler safe: it
        takes no lock, so it may run while a flush is mid-flight)."""
        self._shutdown.set()

    def request_graceful_restart(self) -> None:
        """The SIGUSR2 entry, signal-handler safe: unblock serve() and
        flag it for graceful_restart_drain()."""
        self._graceful_restart = True
        self._shutdown.set()

    def graceful_restart_drain(self, grace_s: float = 0.5) -> None:
        """Zero-drop restart handoff (server.go:1365-1413 SIGUSR2,
        re-imagined on SO_REUSEPORT).  The replacement has bound the
        same UDP addresses, so it is in their reuseport groups; this
        process then

          1. connect()s each UDP socket to a silent loopback port
             (_stop_intake), which steers every new datagram to the
             replacement's sockets while the queued tail stays
             readable;
          2. keeps its readers running for `grace_s`;
          3. shuts down, which takes what is still queued into the
             final flush (flush_on_shutdown)."""
        self._stop_intake()
        time.sleep(grace_s)
        self.shutdown()

    def _stop_intake(self) -> None:
        """connect() every UDP listener to a port of the loopback that
        sends nothing (9, discard, and up): the kernel then queues no
        new datagram on it (they go to the other sockets of its
        reuseport group, if any), and what is queued stays readable.
        Each socket of a group takes its own port, since some network
        stacks refuse two sockets the same four-tuple."""
        if self._intake_stopped:
            return
        self._intake_stopped = True
        udp = [s for s in self._listeners if s.type == socket.SOCK_DGRAM]
        for i, sock in enumerate(udp):
            host = "127.0.0.1" if sock.family == socket.AF_INET else "::1"
            try:
                sock.connect((host, 9 + i))
            except OSError:
                logger.exception("connect() of a UDP listener failed")

    def _drain_udp(self) -> None:
        """Process every datagram still queued on the UDP listeners;
        after _stop_intake and after the readers stopped, so the queues
        only shrink.  With the native engine they go through it, on a
        thread id of their own."""
        bufsize = self.config.metric_max_length + 1
        tid = (self.native.engine.new_thread() if self.native is not None
               else None)
        for sock in self._listeners:
            if sock.type != socket.SOCK_DGRAM:
                continue
            while True:
                try:
                    data = sock.recv(bufsize, socket.MSG_DONTWAIT)
                except OSError:     # BlockingIOError: the queue is empty
                    break
                if tid is not None:
                    self.native.engine.ingest(tid, data)
                elif data:
                    self.process_packet_buffer(data)

    def shutdown(self) -> None:
        """server.go:1417-1435: stop the ticker; stop the UDP intake
        (_stop_intake), the readers (each finishes what it holds; the
        native engine joins its C++ readers) and process what is still
        queued, so the final flush, if configured, holds every datagram
        that reached a listener before the shutdown; a bounded wait for
        the forwards in flight; the shutdown checkpoint (with
        checkpoint_dir); then stop the import source, close the forward
        client (draining its spool), the engine and every socket.  After
        crash() the final flush, the wait, the checkpoint and the spool
        drain are skipped.  Idempotent: a second call (the CLI's, after
        POST /quitquitquit) waits for the first and returns."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._shutdown.set()
            self._stop_intake()
            self._readers_stop.set()
            for sock in self._listeners:
                if sock.type == socket.SOCK_STREAM:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
            with self._conns_lock:
                conns = list(self._stream_conns)
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            if self.native is not None:
                self.native.stop()
            for t in self._reader_threads:
                t.join(timeout=2.0)
            self._drain_udp()
            if not self._crashed:
                if self.config.flush_on_shutdown:
                    try:
                        self.flush()
                    except Exception:
                        logger.exception("final flush failed")
                self.wait_forwards(max(2.0, self.config.interval))
                if self.config.checkpoint_dir:
                    # the SIGTERM / graceful-exit snapshot a supervisor's
                    # restart resumes from
                    try:
                        self.checkpoint_now()
                    except Exception:
                        logger.exception("shutdown checkpoint failed")
            # the lanes drain before the forwarder and the sinks close;
            # after crash() queued jobs die with the process and the
            # lanes' spools keep their records for the revived server
            try:
                self.egress.close(drain=not self._crashed,
                                  timeout_s=max(2.0, self.config.interval))
            except Exception:
                logger.exception("egress close failed")
            self._forward_pool.shutdown(wait=False)
            if self.grpc_import is not None:
                self.grpc_import.stop()
            if isinstance(self.forwarder, ForwardClient):
                self.forwarder.close(drain_spool=not self._crashed)
            for sink in self.metric_sinks:
                if hasattr(sink, "close"):
                    try:
                        sink.close()
                    except Exception:
                        logger.exception("sink close failed")
            # native.stop() joined the C++ readers above, so no reader
            # can see a closed (or recycled) fd
            for sock in self._listeners:
                sock.close()
            for t in self._threads:
                t.join(timeout=2.0)
            if self.native is not None:
                self.native.close()
