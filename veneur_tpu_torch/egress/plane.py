"""The egress data plane: async sink fan-out off the flush critical path.

Counterpart of `veneur_tpu.egress.plane`.  The reference fans each flush
out to its sinks inside the flush goroutine (`flusher.go:97-113`), where
one slow or blackholed backend holds the flush serialization lock.  Here
`Server.flush` hands the rendered interval to the plane and returns:

  * a bounded per-sink queue (filtering, serialization and HTTP all run
    on per-sink lane workers; a full queue drops whole intervals with
    accounting),
  * per-sink circuit breakers (egress/breaker.py) and bounded retries
    with seeded backoff (the forward client's `RetryPolicy`),
  * durable spill: when a sink's retries exhaust (or its breaker is
    open), the filtered payload is serialized into that sink's own
    `ForwardSpool` segment (forward/spool.py) and a background replayer
    re-delivers oldest-first once the backend recovers; the spool's
    ledger closure (`spilled + recovered == replayed + expired +
    dropped + pending`) is in `stats()`.

The spool payload codec (`encode_metrics`) and the spool's segment files
are the JAX package's byte for byte, so an egress spool directory
written by either package replays in the other.

Not ported yet (ROADMAP A16): the `egress.sink` failpoint, the
`flush.sink.<name>`, `egress.attempt` and `egress.replay` spans and the
breaker's event spans, and the emission of the poster's HTTP phase
records.  The lanes' self-metrics go to the statsd client the flush
hands them, the no-op client when there is none; the accounting those
calls mirror is in `stats()`.  Span lanes come with the span pipeline
(ROADMAP A15).

Job lifetime contract: a job claimed from a lane queue (`claim_job`)
is settled (`settle_job`) on every path — delivered, spilled, or dropped
with accounting — so `settle()` (and the flush-on-shutdown drain) can
wait on the pending count.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import random
import re
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.egress.breaker import CircuitBreaker
from veneur_tpu_torch.forward.client import RetryPolicy
from veneur_tpu_torch.forward.spool import ForwardSpool, RetryableReplayError
from veneur_tpu_torch.samplers.samplers import InterMetric

logger = logging.getLogger("veneur_tpu_torch.egress")

# egress spool payload version (the codec below, one record per job)
_PAYLOAD_VERSION = 1


class NoopClient:
    """The self-metrics client when none is configured
    (scopedstatsd.Ensure, client.go:24-30)."""

    def count(self, *a, **kw): ...
    def incr(self, *a, **kw): ...
    def gauge(self, *a, **kw): ...
    def histogram(self, *a, **kw): ...
    def timing(self, *a, **kw): ...
    def set(self, *a, **kw): ...
    def close(self): ...


def ensure(client) -> object:
    """Return a usable client: the given one, or a no-op."""
    return client if client is not None else NoopClient()


def encode_metrics(metrics) -> bytes:
    """Serialize a filtered metric payload for the durable spool.  The
    sink re-delivery path needs full InterMetric rows back, so the
    codec is a plain JSON row list (routing allowlists are dropped —
    filtering already happened before the spill)."""
    rows = [[m.name, m.timestamp, m.value, list(m.tags), m.type,
             m.message, m.hostname] for m in metrics]
    return json.dumps([_PAYLOAD_VERSION, rows],
                      separators=(",", ":")).encode()


def decode_metrics(body: bytes) -> list[InterMetric]:
    version, rows = json.loads(body.decode())
    if version != _PAYLOAD_VERSION:
        raise ValueError(f"unknown egress payload version {version}")
    return [InterMetric(name=r[0], timestamp=r[1], value=r[2],
                        tags=list(r[3]), type=r[4], message=r[5],
                        hostname=r[6]) for r in rows]


class EgressJob:
    """One sink's share of one flush interval."""

    __slots__ = ("metrics", "events", "statsd", "interval")

    def __init__(self, metrics, events, statsd, interval: int):
        self.metrics = metrics
        self.events = events
        self.statsd = statsd
        self.interval = interval


def _safe_dirname(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name) or "sink"


class SinkLane:
    """One sink's bounded queue, worker thread, breaker and spool."""

    def __init__(self, plane: "EgressPlane", kind: str, spec, sink,
                 spool: Optional[ForwardSpool] = None):
        self.plane = plane
        self.kind = kind                 # "metric"
        self.spec = spec
        self.sink = sink
        self.name = sink.name()
        self.label = f"{kind}:{self.name}"
        self.sink_tags = [f"sink_name:{self.name}",
                          f"sink_kind:{spec.kind if spec else sink.kind()}"]
        self.queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=plane.queue_depth)
        self.breaker = CircuitBreaker(plane.breaker_threshold,
                                      plane.breaker_reset_s)
        self.spool = spool
        self._rng = random.Random(plane.retry.seed)
        self._spill_seq = 0
        self._stats_lock = threading.Lock()
        self.enqueued = 0            # jobs accepted onto the queue
        self.delivered = 0           # jobs fully delivered
        self.flushed_points = 0      # metric points delivered
        self.retried = 0             # retry attempts taken
        self.errors = 0              # failed delivery attempts
        self.queue_dropped_points = 0  # points dropped on a full queue
        self.dropped_points = 0      # exhausted + spool-less drops
        self.stragglers = 0          # deliveries slower than an interval
        self.busy_since = 0.0        # perf_counter at claim; 0 = idle
        # the last delivery's wall seconds
        self.last_delivery_s = 0.0
        self._thread: Optional[threading.Thread] = None

    def _count(self, field: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self, field, getattr(self, field) + n)

    # -- enqueue (the flush path's handoff; never blocks) ------------------

    def submit(self, job: EgressJob) -> bool:
        """Hand one interval's job to this lane.  Returns False (after
        accounting the loss) when the queue is full — a sink that
        cannot keep up drops whole intervals VISIBLY instead of
        wedging the flush ticker."""
        self.plane.job_opened()
        try:
            self.queue.put_nowait(job)
        except queue_mod.Full:
            self.plane.job_closed()
            pts = len(job.metrics)
            if pts:
                self._count("queue_dropped_points", pts)
            job.statsd.count("egress.queue_full_total", 1,
                             tags=self.sink_tags)
            logger.warning(
                "egress %s: queue full (%d deep); dropped interval %d "
                "(%d points, accounted)", self.label,
                self.plane.queue_depth, job.interval, pts)
            return False
        self._count("enqueued")
        return True

    # -- worker ------------------------------------------------------------

    def start(self, replayers: bool = True) -> None:
        if replayers and self.spool is not None:
            # the replayer starts HERE (not at construction, and not
            # on a pre-start() lazy submit) so a recovered spool never
            # re-delivers into a sink that has not been start()ed yet;
            # start_replayer is idempotent, so the full start() after
            # a lazy one still arms it
            self.spool.start_replayer(self._replay_deliver)
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"egress-{self.label}")
        self._thread.start()

    def claim_job(self) -> Optional[EgressJob]:
        """Pop the next job (None on an empty poll).  Pairs with
        settle_job on every path."""
        try:
            return self.queue.get(timeout=0.1)
        except queue_mod.Empty:
            return None

    def settle_job(self, job: Optional[EgressJob]) -> None:
        """Close one claimed job's lifetime (delivered, spilled or
        dropped — the outcome was accounted by the delivery path)."""
        if job is not None:
            self.plane.job_closed()

    def _run(self) -> None:
        while not self.plane.stopping.is_set():
            job = self.claim_job()
            try:
                if job is not None:
                    self._deliver_job(job)
            except Exception:
                # the backstop that keeps the lane alive on a delivery
                # BUG — counted as an error episode.  The points are NOT
                # added to dropped_points here: the delivery path may
                # have already accounted them (flushed or spilled)
                # before the crash, and a double count would break the
                # ledger.
                self._count("errors")
                logger.exception("egress %s: delivery crashed",
                                 self.label)
            finally:
                self.settle_job(job)

    # -- delivery ----------------------------------------------------------

    def _deliver_job(self, job: EgressJob) -> None:
        t0 = time.perf_counter()
        with self._stats_lock:
            self.busy_since = t0
        try:
            self._deliver_metric(job, job.statsd)
        finally:
            wall = time.perf_counter() - t0
            with self._stats_lock:
                self.busy_since = 0.0
                self.last_delivery_s = wall
                if wall > self.plane.interval_s:
                    self.stragglers += 1

    def _deliver_metric(self, job: EgressJob, statsd) -> None:
        filtered, counts = sink_mod.filter_metrics_for_sink(
            self.spec, self.plane.routing_enabled, job.metrics,
            excluded_tags=self.plane.excluded_tags_for(self.name))
        start = time.perf_counter()
        try:
            # status counts are emitted whether or not delivery lands
            # (a raising sink must not hide what filtering decided)
            for status in ("skipped", "max_name_length", "max_tags",
                           "max_tag_length", "flushed"):
                statsd.count("flushed_metrics", counts.get(status, 0),
                             tags=self.sink_tags + [f"status:{status}"])
            try:
                self.sink.flush_other_samples(job.events)
            except Exception as e:
                self._count("errors")
                statsd.count("flush.sink_errors_total", 1,
                             tags=self.sink_tags)
                logger.error("sink %s flush_other_samples failed: %s",
                             self.name, e)
            self._attempt_flush(filtered, job, statsd)
        finally:
            statsd.timing("sink.metric_flush_total_duration_ms",
                          (time.perf_counter() - start) * 1e3,
                          tags=self.sink_tags)

    def _attempt_flush(self, filtered, job: EgressJob, statsd) -> None:
        """Bounded-retry delivery under the breaker; exhaustion (or an
        open breaker) spills to the durable spool."""
        retry_idx = 0
        while True:
            if not self.breaker.admit():
                self._spill_or_drop(filtered, job, statsd, "breaker_open")
                return
            try:
                result = (self.sink.flush(filtered)
                          or sink_mod.MetricFlushResult())
                self._record_delivered(result, statsd)
                return
            except Exception as e:
                self._count("errors")
                tripped = self.breaker.record_failure()
                if tripped:
                    self._breaker_opened()
                if (tripped or self.breaker.state() != "closed"
                        or retry_idx >= self.plane.retry.attempts - 1):
                    statsd.count("flush.sink_errors_total", 1,
                                 tags=self.sink_tags)
                    logger.error("sink %s flush failed after %d "
                                 "attempt(s): %s", self.name,
                                 retry_idx + 1, e)
                    self._spill_or_drop(filtered, job, statsd,
                                        "retries_exhausted")
                    return
                self._count("retried")
                statsd.count("egress.retries_total", 1,
                             tags=self.sink_tags)
                delay = self.plane.retry.delay_s(retry_idx, self._rng)
                logger.info("sink %s flush attempt %d failed (%s); "
                            "retrying in %.0f ms", self.name,
                            retry_idx + 1, e, delay * 1e3)
                time.sleep(delay)
                retry_idx += 1

    def _record_delivered(self, result, statsd) -> None:
        statsd.count(sink_mod.METRICS_FLUSHED_TOTAL, result.flushed,
                     tags=self.sink_tags)
        statsd.count(sink_mod.METRICS_DROPPED_TOTAL, result.dropped,
                     tags=self.sink_tags)
        self._count("delivered")
        self._count("flushed_points", result.flushed)
        if self.breaker.record_success():
            logger.info("sink %s circuit CLOSED (delivery succeeded)",
                        self.name)

    def _breaker_opened(self) -> None:
        snap = self.breaker.snapshot()
        logger.warning(
            "sink %s circuit OPEN (%s consecutive failures, trip "
            "#%s, retry in %.1fs); spilling to the egress spool",
            self.name, snap["failures"], snap["trips"],
            snap["retry_in_s"])

    def _spill_or_drop(self, filtered, job: EgressJob, statsd,
                       cause: str) -> None:
        """Exhausted (or breaker-refused) payload: spill to this sink's
        durable spool when one is configured, else drop with
        accounting — never silent."""
        pts = len(filtered)
        if pts == 0:
            return
        if self.spool is not None:
            with self._stats_lock:
                self._spill_seq += 1
                seq = self._spill_seq
            body = encode_metrics(list(filtered))
            if self.spool.append((self.name, job.interval, seq), body,
                                 pts):
                statsd.count("egress.spilled_total", pts,
                             tags=self.sink_tags + [f"cause:{cause}"])
                logger.info(
                    "egress %s: spilled %d points of interval %d to "
                    "the spool (%s); background replay will "
                    "re-deliver", self.label, pts, job.interval, cause)
                return
        self._count("dropped_points", pts)
        statsd.count("egress.dropped_total", pts,
                     tags=self.sink_tags + [f"cause:{cause}"])
        logger.warning("egress %s: dropping %d points of interval %d "
                       "(%s, no spool)", self.label, pts,
                       job.interval, cause)

    def _replay_deliver(self, rec, body: bytes) -> None:
        """Spool replay: decode the recorded payload and re-flush it
        under the breaker's half-open discipline.  A sink failure
        keeps the record for the next tick (RetryableReplayError);
        records leave the spool only via delivery or visible expiry —
        except an undecodable payload, which propagates plainly so the
        spool drops it with accounting instead of wedging the queue
        head until expiry."""
        # decode BEFORE the breaker admit: a decode failure must not
        # strand the half-open probe flag
        metrics = decode_metrics(body)
        if not self.breaker.admit():
            raise RetryableReplayError(
                f"egress sink {self.name}: breaker open")
        try:
            result = (self.sink.flush(metrics)
                      or sink_mod.MetricFlushResult())
        except Exception as e:
            self._count("errors")
            if self.breaker.record_failure():
                self._breaker_opened()
            raise RetryableReplayError(str(e)) from e
        self._count("flushed_points", result.flushed)
        # the per-sink delivery series counts replayed deliveries too,
        # or an outage leaves a permanent hole in
        # sink.metrics_flushed_total
        statsd = self.plane.statsd()
        statsd.count(sink_mod.METRICS_FLUSHED_TOTAL, result.flushed,
                     tags=self.sink_tags)
        statsd.count(sink_mod.METRICS_DROPPED_TOTAL, result.dropped,
                     tags=self.sink_tags)
        if self.breaker.record_success():
            logger.info("sink %s circuit CLOSED (replay delivered)",
                        self.name)

    def stats(self) -> dict:
        with self._stats_lock:
            out = {
                "kind": self.kind,
                "queued": self.queue.qsize(),
                "enqueued": self.enqueued,
                "delivered": self.delivered,
                "flushed_points": self.flushed_points,
                "retried": self.retried,
                "errors": self.errors,
                "queue_dropped_points": self.queue_dropped_points,
                "dropped_points": self.dropped_points,
                "stragglers": self.stragglers,
                # wall seconds the CURRENT delivery has been running
                # (0 = idle): a hung sink.flush shows up here even
                # though it never completes
                "busy_for_s": round(
                    (time.perf_counter() - self.busy_since)
                    if self.busy_since else 0.0, 3),
            }
        out["breaker"] = self.breaker.snapshot()
        if self.spool is not None:
            out["spool"] = self.spool.stats()
        return out

    def close(self, drain: bool) -> None:
        if self.spool is not None:
            self.spool.close(drain=drain)


class EgressPlane:
    """All of a server's sink lanes plus the shared handoff contract.

    `submit_interval` is the only flush-path entry point: it enqueues
    one job per lane and returns — no filtering, serialization or I/O
    happens under the caller's lock.  `settle` waits for the pending
    job count to hit zero (tests and the graceful-shutdown drain);
    `stats` is the JAX package's `/debug/vars -> egress` payload, whose
    spool ledger closes exactly (`spilled == replayed + expired +
    dropped + pending`)."""

    def __init__(self, interval_s: float = 10.0, queue_depth: int = 128,
                 retry: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0,
                 spool_dir: str = "",
                 spool_max_bytes: int = 64 << 20,
                 spool_max_age_s: float = 600.0,
                 spool_fsync: str = "rotate",
                 spool_replay_interval_s: float = 0.5,
                 routing_enabled: bool = False,
                 excluded_tags_for: Optional[Callable] = None,
                 statsd_fn: Optional[Callable] = None):
        self.interval_s = float(interval_s)
        self.queue_depth = max(1, int(queue_depth))
        self.retry = retry or RetryPolicy()
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.spool_dir = spool_dir
        self.spool_max_bytes = spool_max_bytes
        self.spool_max_age_s = spool_max_age_s
        self.spool_fsync = spool_fsync
        self.spool_replay_interval_s = spool_replay_interval_s
        self.routing_enabled = routing_enabled
        self.excluded_tags_for = excluded_tags_for or (lambda name: None)
        # self-metrics client for deliveries with no flush-path job to
        # carry one (spool replays); defaults to a no-op client
        self._statsd_fn = statsd_fn
        self.lanes: list[SinkLane] = []
        self.stopping = threading.Event()
        self._start_lock = threading.Lock()
        self._started = False
        # open jobs across every lane (incremented on submit, closed by
        # settle_job / a queue-full bounce); settle() waits on it
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._pending_zero = threading.Condition(self._pending_lock)

    def statsd(self):
        return ensure(self._statsd_fn() if self._statsd_fn is not None
                      else None)

    # -- registration ------------------------------------------------------

    def add_metric_sink(self, spec, sink) -> SinkLane:
        spool = None
        if self.spool_dir:
            # keyed by registration ORDER as well as name: two sinks
            # with a colliding name (e.g. two datadog sinks to
            # different endpoints) must never interleave appends into
            # one segment dir or cross-replay each other's payloads.
            # Registration order is config order, so a revived server
            # with the same config maps each lane back to its dir.
            idx = sum(1 for lane in self.lanes if lane.kind == "metric")
            spool = ForwardSpool(
                os.path.join(self.spool_dir,
                             f"{idx}-{_safe_dirname(sink.name())}"),
                max_bytes=self.spool_max_bytes,
                max_age_s=self.spool_max_age_s,
                fsync=self.spool_fsync,
                replay_interval_s=self.spool_replay_interval_s)
        lane = SinkLane(self, "metric", spec, sink, spool=spool)
        self.lanes.append(lane)
        return lane

    # -- lifecycle ---------------------------------------------------------

    def start(self, replayers: bool = True) -> None:
        """Start the lane workers.  `replayers=False` is the lazy
        pre-`Server.start()` form: queued jobs drain, but recovered
        spool records wait for the full start (sinks may not be
        start()ed yet); the full start arms the replayers even when
        the workers were lazily started."""
        with self._start_lock:
            if self._started and not replayers:
                return
            self._started = True
            for lane in self.lanes:
                lane.start(replayers=replayers)

    def job_opened(self) -> None:
        with self._pending_lock:
            self._pending += 1

    def job_closed(self) -> None:
        with self._pending_zero:
            self._pending -= 1
            if self._pending <= 0:
                self._pending_zero.notify_all()

    # -- the flush path's handoff ------------------------------------------

    def submit_interval(self, metrics, events, statsd,
                        interval: int) -> None:
        """Enqueue one job per lane and return immediately.  Lanes are
        lazily started so a pre-`start()` flush (tests, tooling) still
        delivers — asynchronously, like every other flush."""
        if not self.lanes:
            return
        if not self._started:
            self.start(replayers=False)
        statsd = ensure(statsd)
        for lane in self.lanes:
            lane.submit(EgressJob(metrics, events, statsd, interval))

    # -- quiescence / teardown ---------------------------------------------

    def settle(self, timeout_s: float = 10.0) -> bool:
        """Wait until every submitted job has been settled (delivered,
        spilled or dropped-with-accounting).  Does NOT wait for spool
        replay — a blackholed backend's pending records drain on their
        own clock.  Returns False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._pending_zero:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._pending_zero.wait(remaining)
        return True

    def close(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the lanes.  `drain` settles queued jobs first and
        fsyncs the spool tails (graceful shutdown); a simulated crash
        passes False — queued jobs die with the process and the spools
        keep their on-disk pending records for the revived instance."""
        if drain:
            self.settle(timeout_s=timeout_s)
        self.stopping.set()
        for lane in self.lanes:
            t = lane._thread
            if t is not None:
                t.join(timeout=1.0)
        for lane in self.lanes:
            lane.close(drain=drain)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Per-sink lanes plus the aggregated ledger.  The spool ledger
        closure — in metric POINTS, `spilled + recovered == replayed +
        expired + spool_dropped + pending_points` — holds by
        construction (each lane's ForwardSpool maintains it; `pending`
        counts records, `pending_points` the points inside them)."""
        per_sink = {}
        agg = {"flushed": 0, "retried": 0, "errors": 0,
               "queue_dropped": 0, "dropped": 0, "stragglers": 0,
               "spilled": 0, "recovered": 0, "replayed": 0,
               "expired": 0, "spool_dropped": 0, "pending": 0,
               "pending_points": 0}
        breakers = {}
        ledger_closed = True
        for lane in self.lanes:
            st = lane.stats()
            per_sink[lane.label] = st
            agg["flushed"] += st["flushed_points"]
            agg["retried"] += st["retried"]
            agg["errors"] += st["errors"]
            agg["queue_dropped"] += st["queue_dropped_points"]
            agg["dropped"] += st["dropped_points"]
            agg["stragglers"] += st["stragglers"]
            if lane.kind == "metric":
                breakers[lane.name] = st["breaker"]
            sp = st.get("spool")
            if sp is not None:
                agg["spilled"] += sp["spilled_points"]
                agg["recovered"] += sp["recovered_points"]
                agg["replayed"] += sp["replayed_points"]
                agg["expired"] += sp["expired_points"]
                agg["spool_dropped"] += sp["dropped_points"]
                agg["pending"] += sp["pending_records"]
                agg["pending_points"] += sp["pending_points"]
                # per-lane closure over ONE consistent spool snapshot;
                # records a reopen recovered from a previous process's
                # spill are part of the inflow side
                ledger_closed = ledger_closed and (
                    sp["spilled_points"] + sp["recovered_points"]
                    == sp["replayed_points"] + sp["expired_points"]
                    + sp["dropped_points"] + sp["pending_points"])
        agg["ledger_closed"] = ledger_closed
        agg["breakers"] = breakers
        agg["per_sink"] = per_sink
        return agg
