"""Per-destination connection: batched V1 fast path + V2 stream fallback.

Counterpart of `veneur_tpu.proxy.connect`, which mirrors
`proxy/connect/connect.go`: each destination owns a gRPC channel, a
bounded send buffer drained by sender threads (`sendMetrics`,
connect.go:141-227), and close detection that notifies the destinations
manager so in-flight metrics are counted as dropped (`listenForClose`,
connect.go:231-245).

Transport: at connect time the destination probes `SendMetrics` (V1,
`forwardrpc.MetricList`) with an empty batch.  This framework's globals
implement it (sources/proxy.py), so coalesced batches travel as unary
RPCs through ONE sender, whatever the item kind (single metrics, routed
groups, the native router's pre-serialized chunks), so same-key updates
keep a total order.  A reference veneur global answers the probe
UNIMPLEMENTED (sources/proxy/server.go:138-142) and the destination
falls back to the reference's own long-lived `SendMetricsV2` streams,
`n_streams` of them, each metric name pinned to one.

A coalesced V1 batch is cut into RPCs by `forward.client.chunk_pbs`: at
most BATCH_MAX metrics and BATCH_BYTES of serialized MetricList each, so
a batch of deep digests stays under the peer's 4 MiB receive limit.
(ROADMAP C18: the JAX sender cuts by count alone, and a batch of 2,000
digests of 152 centroids, 6.2 MB, is refused RESOURCE_EXHAUSTED and
dropped whole.)  The native router's chunks are slices of one inbound
MetricList, which the proxy's own 4 MiB receive limit bounds.

The buffer bound counts METRICS (not queue items), so a wedged
destination backpressures at `send_buffer_size` metrics however they
were enqueued; a graceful close() lets every sender drain its own
backlog, while a broken stream/RPC counts all buffered and in-flight
metrics as dropped.

Not here yet: the `proxy.connect`, `proxy.send_batch` and `proxy.stream`
failpoints, and the trace contexts a V1 batch carries onward as
metadata (ROADMAP A16).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

import grpc
from google.protobuf import empty_pb2

from veneur_tpu_torch.forward.client import (BATCH_MAX, SEND_METRICS,
                                             SEND_METRICS_V2, chunk_pbs)
from veneur_tpu_torch.protocol import forward_pb2, metric_pb2

logger = logging.getLogger("veneur_tpu_torch.proxy.connect")

_CLOSE = object()  # sentinel terminating a sender


def _closed_channel_error(e: BaseException) -> bool:
    """grpc raises a bare ValueError("Cannot invoke RPC on closed
    channel!") when the channel is torn down mid-send (a reshard
    retire); ONLY that condition may take the dropped-accounting path —
    any other ValueError is a programming defect and must stay loud."""
    return "closed channel" in str(e)


def _reraise_unless_closed_channel(e: BaseException) -> None:
    """The one shared gate in front of every sender's dropped-accounting
    path: tolerated transport-teardown exceptions pass through; a
    foreign ValueError re-raises."""
    if isinstance(e, ValueError) and not _closed_channel_error(e):
        raise e


class _Raw:
    """A pre-serialized routed group from the native wire router
    (ingest.route_metric_list): `chunks` are VALID MetricList bodies
    (chunk_counts holds their per-chunk metric counts), sent verbatim
    (no re-serialization) and SEQUENTIALLY by one sender so ordering
    within the inbound payload holds."""

    __slots__ = ("chunks", "chunk_counts", "count")

    def __init__(self, chunks: list, chunk_counts: list, count: int):
        self.chunks = chunks
        self.chunk_counts = chunk_counts
        self.count = count

    def __len__(self) -> int:   # buffer accounting treats items by size
        return self.count


class Destination:
    def __init__(self, address: str, send_buffer_size: int = 1024,
                 on_closed: Optional[Callable[["Destination"], None]] = None,
                 dial_timeout_s: float = 5.0, n_streams: int = 8,
                 send_timeout_s: float = 30.0,
                 stream_timeout_s: float = 0.0):
        self.address = address
        # per-RPC send deadline (config: proxy_send_timeout)
        self.send_timeout_s = send_timeout_s
        # V2 stream lifetime deadline (config: proxy_stream_timeout).
        # 0 = reference semantics: the long-lived stream has NO
        # deadline, so a frozen reference global wedges its sender until
        # the buffer backpressures.  Nonzero bounds every stream: a
        # frozen peer surfaces as DEADLINE_EXCEEDED — the destination
        # closes with its buffer counted dropped and the ring routes
        # around — at the cost of re-dialing healthy streams every
        # stream_timeout_s.
        self.stream_timeout_s = stream_timeout_s
        self.closed = threading.Event()
        self._closing = threading.Event()     # graceful close() marker
        self.on_closed = on_closed
        self._closed_once = threading.Lock()
        self._close_notified = False
        self.sent = 0
        self.dropped = 0
        self._sent_lock = threading.Lock()
        self._swept: list = []   # items reclaimed by close-time drains
        # metric-count buffer bound (send_buffer_size metrics total,
        # whatever the queue-item granularity)
        self._buf_cap = max(1, send_buffer_size)
        self._buffered = 0
        self._buf_cv = threading.Condition()
        # local subchannel pool: grpc's GLOBAL pool would hand a fresh
        # Destination the previous (dead) connection's subchannel, still
        # in TRANSIENT_FAILURE backoff — a circuit breaker's half-open
        # probe must dial for real, not inherit the failure it is probing
        self.channel = grpc.insecure_channel(
            address, options=[("grpc.use_local_subchannel_pool", 1)])
        try:
            grpc.channel_ready_future(self.channel).result(
                timeout=dial_timeout_s)
        except BaseException:
            self.channel.close()
            raise
        self._v2 = self.channel.stream_unary(
            SEND_METRICS_V2,
            request_serializer=metric_pb2.Metric.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString)
        self._v1 = self.channel.unary_unary(
            SEND_METRICS,
            request_serializer=forward_pb2.MetricList.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString)
        # passthrough stub for pre-serialized MetricList bodies from the
        # native router — the bytes ship verbatim
        self._v1_raw = self.channel.unary_unary(
            SEND_METRICS,
            request_serializer=lambda b: b,
            response_deserializer=empty_pb2.Empty.FromString)
        self.batch_mode = self._probe_v1(dial_timeout_s)
        self.n_streams = 1 if self.batch_mode else max(1, n_streams)
        self.queues: list[queue.Queue] = [
            queue.Queue() for _ in range(self.n_streams)]
        self._senders = []
        for i in range(self.n_streams):
            t = threading.Thread(
                target=(self._batch_loop if self.batch_mode
                        else self._stream_loop),
                args=(self.queues[i],),
                daemon=True, name=f"dest-{address}-{i}")
            t.start()
            self._senders.append(t)

    def _probe_v1(self, timeout_s: float) -> bool:
        """One empty MetricList decides the transport: OK -> fleet-
        internal batch RPCs; UNIMPLEMENTED -> reference V2 streams."""
        try:
            self._v1(forward_pb2.MetricList(), timeout=timeout_s)
            return True
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                logger.info("destination %s has no V1 batch import; "
                            "using V2 streams", self.address)
            else:
                # transiently unavailable at probe time: serve it via V2
                # streams, whose own failure handling covers a genuinely
                # broken peer
                logger.warning("destination %s V1 probe failed (%s); "
                               "using V2 streams", self.address,
                               e.code())
            return False

    # -- buffer accounting -------------------------------------------------

    def _reserve(self, n: int, block_poll_s: float) -> bool:
        """Block until n metrics fit the buffer (an oversized group is
        admitted whenever the buffer is not already full) or the
        destination closes."""
        while not self.closed.is_set():
            with self._buf_cv:
                # waiting for exactly-empty would let smaller sends
                # starve an oversized group; the bound is therefore cap
                # + one oversized group per concurrent producer — still
                # finite backpressure, never an unbounded queue
                if (self._buffered + n <= self._buf_cap
                        or (n > self._buf_cap
                            and self._buffered < self._buf_cap)):
                    self._buffered += n
                    return True
                self._buf_cv.wait(timeout=block_poll_s)
        return False

    def _release(self, n: int) -> None:
        with self._buf_cv:
            self._buffered -= n
            self._buf_cv.notify_all()

    def _queue_for(self, name: str) -> queue.Queue:
        """Key-affine queue choice: every metric of a given name rides
        the same sender, so same-timeseries updates (gauges are
        last-write-wins) are never reordered across parallel senders."""
        return self.queues[hash(name) % self.n_streams]

    def _count_dropped(self, n: int) -> None:
        with self._sent_lock:
            self.dropped += n

    # -- the V1 batch sender -----------------------------------------------

    def _batch_loop(self, q: queue.Queue) -> None:
        """Coalesce queued metrics and groups up to BATCH_MAX metrics
        into one batch; a raw routed group goes on its own, in queue
        order."""
        graceful = False
        try:
            while True:
                item = q.get()
                if item is _CLOSE:
                    graceful = True
                    return
                if isinstance(item, _Raw):
                    self._send_and_release_raw(item)
                    continue
                batch = list(item) if isinstance(item, list) else [item]
                raw_after = None
                while len(batch) < BATCH_MAX:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if item is _CLOSE:
                        try:
                            self._send_batch(batch)
                        finally:
                            self._release(len(batch))
                        graceful = True
                        return
                    if isinstance(item, _Raw):
                        # keep queue order: finish the batch, then send
                        # the raw group before draining further
                        raw_after = item
                        break
                    if isinstance(item, list):
                        batch.extend(item)
                    else:
                        batch.append(item)
                # release AFTER the send: the buffer bound covers
                # in-flight batches too, so a wedged destination
                # backpressures at ~cap metrics
                batch_ok = False
                try:
                    self._send_batch(batch)
                    batch_ok = True
                finally:
                    self._release(len(batch))
                    if raw_after is not None and not batch_ok:
                        # the parked raw group is no longer in the
                        # queue, so the close-time sweep cannot see it
                        self._count_dropped(raw_after.count)
                        self._release(raw_after.count)
                if raw_after is not None:
                    self._send_and_release_raw(raw_after)
        except (grpc.RpcError, ValueError) as e:
            _reraise_unless_closed_channel(e)
            logger.warning("destination %s batch send failed: %s",
                           self.address, e)
        finally:
            self._mark_closed(graceful)

    def _send_and_release_raw(self, item: "_Raw") -> None:
        try:
            self._send_raw_item(item)
        finally:
            self._release(item.count)

    def _send_batch(self, batch: list) -> None:
        """Send a coalesced batch as V1 RPCs of at most BATCH_MAX metrics
        and BATCH_BYTES each (chunk_pbs; ROADMAP C18), with sent counted
        per RPC; a failed RPC counts itself and everything after it as
        dropped (in-flight-counted-as-dropped, connect.go:231-245)."""
        remaining = len(batch)
        for chunk in chunk_pbs(batch):
            try:
                self._v1(forward_pb2.MetricList(metrics=chunk),
                         timeout=self.send_timeout_s)
            except (grpc.RpcError, ValueError) as e:
                # closed-channel ValueError = the destination was
                # retired while this batch was in flight: same
                # accounting as a broken RPC; other ValueErrors re-raise
                # un-accounted (they are bugs, not transport loss)
                _reraise_unless_closed_channel(e)
                self._count_dropped(remaining)
                raise
            with self._sent_lock:
                self.sent += len(chunk)
            remaining -= len(chunk)

    def _send_raw_item(self, item: "_Raw") -> None:
        """Send a routed raw group chunk by chunk (each chunk is already
        a valid MetricList body; counts travel with the group)."""
        remaining = item.count
        for chunk, n in zip(item.chunks, item.chunk_counts):
            try:
                self._v1_raw(chunk, timeout=self.send_timeout_s)
            except (grpc.RpcError, ValueError) as e:
                _reraise_unless_closed_channel(e)
                self._count_dropped(remaining)
                raise
            with self._sent_lock:
                self.sent += n
            remaining -= n

    def _enqueue_checked(self, qq: queue.Queue, items: list) -> int:
        """Put reserved items on `qq`; if the destination died around
        the put, sweep what is left and return the metric count of OUR
        items the sweep reclaimed (already counted dropped)."""
        for item in items:
            qq.put(item)
        if not self.closed.is_set():
            return 0
        self._drain_dropped()
        with self._sent_lock:
            return sum(len(it) if isinstance(it, (list, _Raw)) else 1
                       for it in items
                       if any(s is it for s in self._swept))

    def _refuse_if_closing(self, n: int) -> bool:
        """A closing/closed destination refuses new work upfront: a
        graceful close() drains sender backlogs for seconds, and items
        enqueued behind the sentinels would only be swept at the end."""
        if self._closing.is_set() or self.closed.is_set():
            self._count_dropped(n)
            return True
        return False

    def send_raw(self, chunks: list, chunk_counts: list, count: int,
                 block_poll_s: float = 0.05) -> int:
        """Enqueue a native-routed raw group.  Returns metrics DROPPED
        (0 = buffered).  Batch-mode destinations run ONE sender, so the
        group keeps a total order with every other item kind."""
        if not count:
            return 0
        if self._refuse_if_closing(count):
            return count
        if not self._reserve(count, block_poll_s):
            self._count_dropped(count)
            return count
        return self._enqueue_checked(
            self.queues[0], [_Raw(chunks, chunk_counts, count)])

    # -- V2 stream senders (reference-global fallback) ---------------------

    def _request_iter(self, q: queue.Queue):
        while True:
            item = q.get()
            if item is _CLOSE:
                return
            self._release(1)
            with self._sent_lock:
                self.sent += 1
            yield item

    def _stream_loop(self, q: queue.Queue) -> None:
        """One long-lived stream; when it breaks, mark the DESTINATION
        closed and drain every buffer as dropped (connect.go:196-227)."""
        ok = [False]

        def it():
            yield from self._request_iter(q)
            ok[0] = True    # iterator exhausted = _CLOSE consumed

        try:
            self._v2(it(), timeout=self.stream_timeout_s or None)
        except (grpc.RpcError, ValueError) as e:
            _reraise_unless_closed_channel(e)
            logger.warning("destination %s stream closed: %s",
                           self.address, e)
        finally:
            self._mark_closed(ok[0])

    def _mark_closed(self, graceful: bool) -> None:
        """Sender-exit cleanup.  `graceful` = this sender consumed its
        _CLOSE sentinel during close(): siblings are still draining
        their OWN backlogs, so nothing may be stolen.  Any OTHER exit
        (stream break, failed RPC — even mid-close()) closes the whole
        destination: drain every buffer as dropped (connect.go:231-245),
        wake sibling senders with sentinels so their threads and streams
        do not leak, and notify the manager once."""
        if graceful and self._closing.is_set():
            return
        self.closed.set()
        self._drain_dropped()
        for qq in self.queues:
            # wake any sibling blocked in q.get(); extra sentinels are
            # harmless (consumers treat _CLOSE as final)
            qq.put(_CLOSE)
        notify = False
        with self._closed_once:
            if not self._close_notified:
                self._close_notified = True
                notify = True
        if notify and self.on_closed is not None:
            self.on_closed(self)

    def _drain_dropped(self) -> None:
        """Sweep undelivered queue items into the dropped count.  Swept
        items are recorded on self._swept (bounded by the buffer cap,
        since sweeps only happen at close) so a producer racing close()
        can tell by identity whether its just-enqueued item was
        reclaimed."""
        for qq in self.queues:
            saw_close = False
            while True:
                try:
                    item = qq.get_nowait()
                except queue.Empty:
                    break
                if item is _CLOSE:
                    saw_close = True
                    continue
                n = len(item) if isinstance(item, (list, _Raw)) else 1
                self._release(n)
                with self._sent_lock:
                    self.dropped += n
                    self._swept.append(item)
            if saw_close:
                # a sender may still be mid-RPC and come back for its
                # sentinel; consuming it would strand that thread in
                # q.get() forever
                qq.put(_CLOSE)

    def take_swept(self) -> list:
        """Consume the close-sweep's undelivered items as a flat Metric
        list (the reshard drain-and-forward handoff,
        proxy/destinations.py): raw routed chunks parse back into
        Metrics; call only after close() has run its final sweep."""
        with self._sent_lock:
            items, self._swept = self._swept, []
        out: list = []
        for item in items:
            if isinstance(item, _Raw):
                for ch in item.chunks:
                    out.extend(
                        forward_pb2.MetricList.FromString(ch).metrics)
            elif isinstance(item, list):
                out.extend(item)
            else:
                out.append(item)
        return out

    # -- enqueue -----------------------------------------------------------

    def send(self, metric: metric_pb2.Metric,
             block_poll_s: float = 0.05) -> str:
        """Backpressured enqueue with closed-destination escape
        (handlers.go:134-163).  Returns 'ok'|'dropped', which agrees
        with `dropped` in every interleaving but one: a close that
        begins only after the checks here and sweeps the item just
        reported 'ok' (a handful of sends at a close's instant)."""
        if self._refuse_if_closing(1):
            return "dropped"
        if not self._reserve(1, block_poll_s):
            self._count_dropped(1)
            return "dropped"
        if self._enqueue_checked(self._queue_for(metric.name), [metric]):
            return "dropped"
        return "ok"

    def send_many(self, metrics: list,
                  block_poll_s: float = 0.05) -> int:
        """Enqueue a routed group (batch mode: one queue item; stream
        mode: per-metric fan-out).  Returns how many metrics were
        DROPPED (0 = all buffered)."""
        if not metrics:
            return 0
        if self._refuse_if_closing(len(metrics)):
            return len(metrics)
        if not self.batch_mode:
            return sum(1 for m in metrics
                       if self.send(m, block_poll_s) == "dropped")
        if not self._reserve(len(metrics), block_poll_s):
            self._count_dropped(len(metrics))
            return len(metrics)
        return self._enqueue_checked(self.queues[0], [list(metrics)])

    def close(self, drain_timeout_s: float = 5.0) -> None:
        """Graceful: stop accepting, let each sender drain its own
        backlog, close the channel."""
        self._closing.set()
        for q in self.queues:
            q.put(_CLOSE)
        for t in self._senders:
            t.join(timeout=drain_timeout_s)
        self.closed.set()
        # a producer racing close() may have enqueued behind a sentinel
        # after its sender exited: sweep the leftovers into the dropped
        # count so sent + dropped always equals what was accepted
        self._drain_dropped()
        self.channel.close()
