"""gRPC forwarding client: local tier -> global tier.

Counterpart of `veneur_tpu.forward.client` (the reference's
`Server.forward`/`forwardGrpc`, flusher.go:516-591): a persistent
channel dialed once, and per flush the interval's forwardable metrics
sent as batched V1 `SendMetrics` MetricList RPCs to a global of this
framework, or over the reference's V2 `SendMetricsV2` client streams
(forwardrpc/forward.proto:12) to a global that answers V1
UNIMPLEMENTED.  The methods are invoked through explicit method paths
and serializers, which is wire-identical to generated stubs.

Retries cover only what is provably undelivered, under a bounded
RetryPolicy (exponential backoff with seeded jitter): a V1 chunk is one
unary RPC, so the failed chunks are known exactly and only they are
re-sent, each under the identity it was given when the payload was
chunked (the global's dedup ledger merges a re-delivered chunk once);
a V2 stream retries only when gRPC pulled no message from it before the
failure.  With a durable spool (`spool=`, forward/spool.py), the
exhausted remainder's provably undelivered, identified chunks spill to
disk and the spool's replayer re-delivers them under their recorded
identities; everything else (an ambiguous failure, an anonymous V2
remainder, a disk error) is counted in `dropped` and re-raised.

A V1 chunk closes at BATCH_MAX metrics or at BATCH_BYTES of serialized
MetricList, whichever comes first, so a chunk of deep digests stays
under gRPC's default 4 MiB receive limit at the peer (ROADMAP C14: the
JAX client bounds a chunk by count alone, and a peer refuses a chunk of
2,000 digests of 300 centroids, 12 MB, which the client then drops).

A spool record larger than BATCH_BYTES (a JAX client's chunk, bounded
by count alone, C14) replays in parts of at most BATCH_BYTES, each under
an identity derived from the recorded one, where the JAX client would
resend it whole and be refused until the record expires (ROADMAP C19).

Not here yet: TLS channel credentials (A15), failpoints and the flight
recorder's spans, the replay's `forward.replay` span included (A16).
"""

from __future__ import annotations

import concurrent.futures
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

import grpc
from google.protobuf import empty_pb2

from veneur_tpu_torch.forward import convert
from veneur_tpu_torch.forward import spool as spool_mod
from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
from veneur_tpu_torch.samplers import samplers as sm

logger = logging.getLogger("veneur_tpu_torch.forward")

SEND_METRICS = "/forwardrpc.Forward/SendMetrics"
SEND_METRICS_V2 = "/forwardrpc.Forward/SendMetricsV2"

# gRPC metadata key carrying one V1 chunk's (source, interval_epoch,
# chunk_id) identity, the handle the global's dedup ledger
# (sources/proxy.py) keys on.  It is minted once when the chunk is
# formed and reused by every retry, so an ambiguous failure re-delivers
# under the same identity and merges once.
CHUNK_ID_KEY = "veneur-chunk-id"

# minimum spacing between fresh-channel redials after exhausted
# transport failures; a replaced channel lingers this many timeouts
# before close(), since concurrent forwards may hold RPCs on it
REDIAL_MIN_INTERVAL_S = 1.0
REDIAL_OLD_CHANNEL_LINGER_X = 2.0

# one python-grpc client stream tops out near 20k messages/s, so a big
# V2 payload fans out over parallel streams of at least STREAM_CHUNK
STREAM_CHUNK = 2048
# a V1 chunk closes at BATCH_MAX metrics or BATCH_BYTES serialized,
# whichever comes first: 3.5 MiB leaves headroom under gRPC's default
# 4 MiB receive limit, which JAX and port globals both keep
BATCH_MAX = 2000
BATCH_BYTES = 3584 * 1024
# gRPC's default receive limit, which the import servers keep
PEER_RECEIVE_LIMIT = 4 * 1024 * 1024

# codes where gRPC guarantees (UNAVAILABLE) or strongly implies
# (RESOURCE_EXHAUSTED, ABORTED) that the peer imported nothing
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
    grpc.StatusCode.ABORTED,
})
# DEADLINE_EXCEEDED is ambiguous (a frozen peer may import after the
# client gives up): retried only when the deployment says the peer is a
# ledger-bearing global (forward_deadline_retry_safe)
DEADLINE_CODES = frozenset({grpc.StatusCode.DEADLINE_EXCEEDED})


def chunk_id_value(ident: tuple) -> str:
    source, epoch, idx = ident
    return f"{source}:{epoch:x}:{idx:x}"


def parse_chunk_id(value: str) -> Optional[tuple]:
    """Inverse of chunk_id_value; None on malformed input (a foreign
    sender's bad header must never fault the import path)."""
    try:
        source, epoch_s, idx_s = str(value).rsplit(":", 2)
        if not source:
            return None
        return source, int(epoch_s, 16), int(idx_s, 16)
    except (ValueError, AttributeError):
        return None


def _framing(n: int) -> int:
    """Bytes a MetricList adds around one metric of n serialized bytes:
    the field tag and the length varint."""
    varint = 1
    while n >= 0x80:
        n >>= 7
        varint += 1
    return 1 + varint


def chunk_pbs(pbs: list) -> list[list]:
    """Split a payload into V1 chunks of at most BATCH_MAX metrics and
    BATCH_BYTES serialized bytes each; a metric larger than the budget
    goes alone."""
    out: list[list] = []
    cur: list = []
    size = 0
    for pb in pbs:
        n = pb.ByteSize()
        n += _framing(n)
        if cur and (len(cur) == BATCH_MAX or size + n > BATCH_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(pb)
        size += n
    if cur:
        out.append(cur)
    return out


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    attempts counts total tries (1 = no retry).  The sleep before retry
    k (k = 1..) is min(backoff_max_s, backoff_base_s * 2**(k-1)) * (1 +
    jitter * U[0,1)), U drawn from a Random(seed) stream, so a seeded
    run replays the same schedule."""
    attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def delay_s(self, retry_idx: int, rng: random.Random) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** retry_idx))
        return base * (1.0 + self.jitter * rng.random())


class _V1Unsupported(Exception):
    """The first V1 chunk answered UNIMPLEMENTED before anything was
    imported: the same metrics may go over V2."""


@dataclass
class _Chunk:
    """One V1 MetricList chunk with its identity; `ident` is None for
    a V2 remainder, which has lost chunk atomicity."""
    pbs: list
    ident: Optional[tuple] = None


class _SendFailure(Exception):
    """An attempt failed with `undelivered` chunks known (or assumed)
    not imported; `retry_safe` means re-sending them cannot
    double-count."""

    def __init__(self, undelivered: list, cause: BaseException,
                 retry_safe: bool):
        super().__init__(str(cause))
        self.undelivered = undelivered
        self.cause = cause
        self.retry_safe = retry_safe


def _code_of(exc: BaseException):
    if not isinstance(exc, grpc.RpcError):
        return None
    try:
        return exc.code()
    except Exception:   # noqa: BLE001 - code() can fail on odd errors
        return None


def _retry_safe(exc: BaseException, deadline_safe: bool = False) -> bool:
    code = _code_of(exc)
    return code is not None and (
        code in RETRYABLE_CODES
        or (deadline_safe and code in DEADLINE_CODES))


class ForwardClient:
    """The forwarder a local `Server` builds for `forward_address`.
    Call it with an interval's ForwardMetric list; `epoch` (the
    server's flush count) is the interval half of each chunk's
    identity."""

    # the server passes its flush count as the chunk-identity epoch
    accepts_epoch = True

    def __init__(self, address: str, timeout_s: float = 10.0,
                 max_streams: int = 8,
                 retry: Optional[RetryPolicy] = None,
                 spool: Optional[spool_mod.ForwardSpool] = None,
                 source: str = "", deadline_retry_safe: bool = False):
        """`spool` makes exhausted retries crash-durable: identified V1
        chunks spill to disk and its replayer, started here, re-delivers
        them oldest-first once the destination recovers.  `source` names
        this sender in chunk identities; a per-boot nonce is appended so
        a restart never collides with a previous boot's epochs at the
        global's dedup ledger (a spooled record keeps its recorded
        identity: that is the exactly-once handle)."""
        self.address = address
        self.timeout_s = timeout_s
        self.max_streams = max(1, max_streams)
        self.deadline_retry_safe = bool(deadline_retry_safe)
        self.retry = retry or RetryPolicy()
        self._retry_rng = random.Random(self.retry.seed)
        self._dial()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_streams,
            thread_name_prefix=f"fwd-{address}")
        self._use_v1: Optional[bool] = None   # None: not yet probed
        self.spool = spool
        self.source = (f"{source or 'veneur'}"
                       f"#{time.time_ns() & 0xFFFFFFFF:08x}")
        self._epoch_seq = 0
        self._stats_lock = threading.Lock()
        self.sent = 0        # metrics delivered
        self.retries = 0     # retry attempts taken
        self.dropped = 0     # metrics given up on after exhausted retries
        self.spilled = 0     # metrics spilled to the durable spool
        self.redials = 0     # fresh channels dialed after exhaustion
        self.chunks = 0      # V1 chunks delivered
        self.bytes_sent = 0  # serialized MetricList bytes of those chunks
        self.encode_s = 0.0  # seconds in to_pb (the forward's encode)
        self._last_redial = 0.0
        if self.spool is not None:
            self.spool.start_replayer(self._replay_send)

    def _dial(self) -> None:
        """(Re)build the channel and its method stubs.  Call sites read
        the stubs as attributes, so an in-flight send on the old channel
        keeps its stubs while new sends take the fresh ones."""
        self.channel = grpc.insecure_channel(self.address)
        self._v2 = self.channel.stream_unary(
            SEND_METRICS_V2,
            request_serializer=metric_pb2.Metric.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString)
        self._v1 = self.channel.unary_unary(
            SEND_METRICS, request_serializer=lambda b: b,
            response_deserializer=empty_pb2.Empty.FromString)

    def _maybe_redial(self, cause: BaseException) -> None:
        """After exhausted retries on a transport failure, swap in a
        fresh channel, so later flushes never inherit a subchannel
        wedged in TRANSIENT_FAILURE by a peer that died under it.
        Rate-limited; the old channel lingers before close()."""
        if not isinstance(cause, grpc.RpcError):
            return
        now = time.monotonic()
        with self._stats_lock:
            if now - self._last_redial < REDIAL_MIN_INTERVAL_S:
                return
            self._last_redial = now
            self.redials += 1
            old = self.channel
        logger.info("forward to %s: redialing a fresh channel after "
                    "exhausted retries (%s)", self.address, cause)
        self._dial()
        timer = threading.Timer(
            REDIAL_OLD_CHANNEL_LINGER_X * self.timeout_s, old.close)
        timer.daemon = True
        timer.start()

    def __call__(self, metrics: list[sm.ForwardMetric],
                 epoch: Optional[int] = None) -> None:
        self.send(metrics, epoch=epoch)

    def stats(self) -> dict[str, int]:
        with self._stats_lock:
            return {"sent": self.sent, "retries": self.retries,
                    "dropped": self.dropped, "spilled": self.spilled,
                    "redials": self.redials,
                    "chunks": self.chunks, "bytes_sent": self.bytes_sent,
                    "encode_s": self.encode_s}

    def spool_stats(self) -> Optional[dict]:
        return None if self.spool is None else self.spool.stats()

    def _count(self, field: str, n: int) -> None:
        with self._stats_lock:
            setattr(self, field, getattr(self, field) + n)

    def _rsafe(self, exc: BaseException) -> bool:
        return _retry_safe(exc, self.deadline_retry_safe)

    def send(self, metrics: list[sm.ForwardMetric],
             epoch: Optional[int] = None) -> None:
        """One flush's forward: batched V1 against this framework's
        globals, the reference's V2 streams otherwise, under the bounded
        RetryPolicy."""
        if metrics:
            t0 = time.perf_counter()
            pbs = [convert.to_pb(fm) for fm in metrics]
            self._count("encode_s", time.perf_counter() - t0)
            self.send_pbs(pbs, epoch=epoch)

    def _mint_epoch(self) -> int:
        with self._stats_lock:
            self._epoch_seq += 1
            return self._epoch_seq

    def send_pbs(self, pbs: list, epoch: Optional[int] = None) -> None:
        """The payload is chunked once, and each chunk's identity
        (source, epoch, chunk index) minted here; retries reuse it.
        `epoch` None mints a client-local epoch."""
        epoch = self._mint_epoch() if epoch is None else int(epoch)
        remaining = [_Chunk(c, ident=(self.source, epoch, i))
                     for i, c in enumerate(chunk_pbs(pbs))]
        retry_idx = 0
        while True:
            try:
                self._send_attempt(remaining)
                return
            except _SendFailure as f:
                remaining = f.undelivered
                if (not f.retry_safe
                        or retry_idx >= self.retry.attempts - 1):
                    self._spill_or_drop(remaining, f, retry_idx + 1)
                    return
                self._count("retries", 1)
                delay = self.retry.delay_s(retry_idx, self._retry_rng)
                logger.info(
                    "forward to %s: attempt %d failed (%s); retrying %d "
                    "chunks in %.0f ms", self.address, retry_idx + 1,
                    f.cause, len(remaining), delay * 1e3)
                time.sleep(delay)
                retry_idx += 1

    def _spill_or_drop(self, chunks: list, f: _SendFailure,
                       attempts: int) -> None:
        """The exhausted remainder (`client.py:405-442` of the JAX
        package): redial after a transport failure; provably undelivered
        identified chunks spill to the spool; everything else (an
        ambiguous failure, whose peer may be a proxy that re-shards
        without a ledger; an anonymous V2 remainder; no spool; a disk
        error) is counted in `dropped` and the cause re-raised."""
        self._maybe_redial(f.cause)
        spilled = dropped = 0
        for c in chunks:
            if (self.spool is not None and c.ident is not None
                    and f.retry_safe):
                body = forward_pb2.MetricList(
                    metrics=c.pbs).SerializeToString()
                if self.spool.append(c.ident, body, len(c.pbs)):
                    spilled += len(c.pbs)
                    continue
            dropped += len(c.pbs)
        if spilled:
            self._count("spilled", spilled)
            logger.info("forward to %s: spilled %d metrics to the spool "
                        "after %d attempt(s) (%s)", self.address, spilled,
                        attempts, f.cause)
        if dropped:
            self._count("dropped", dropped)
            logger.warning("forward to %s: dropping %d metrics after %d "
                           "attempt(s) (%s%s)", self.address, dropped,
                           attempts, f.cause,
                           "" if f.retry_safe else "; not retry-safe")
            raise f.cause

    def _replay_send(self, rec: spool_mod.SpoolRecord, body: bytes) -> None:
        """The spool replayer's delivery (`client.py:444-495` of the JAX
        package): the recorded MetricList bytes go out as one V1 RPC
        under the recorded chunk identity.  A retry-safe failure raises
        RetryableReplayError (the spool keeps the record at its head);
        any other failure raises as it is (the spool drops the record
        with accounting).  A body above BATCH_BYTES goes in parts
        (ROADMAP C19).

        The RPC waits for the channel to be ready: a fail-fast RPC on a
        channel whose peer died leaves the subchannel in
        TRANSIENT_FAILURE, and every later tick would fail UNAVAILABLE
        after the peer came back; the deadline still bounds each
        attempt."""
        if len(body) > BATCH_BYTES:
            parts = chunk_pbs(list(
                forward_pb2.MetricList.FromString(body).metrics))
            if len(parts) > 1:
                source, epoch, idx = rec.ident
                for j, part in enumerate(parts):
                    self._replay_rpc(
                        forward_pb2.MetricList(
                            metrics=part).SerializeToString(),
                        (f"{source}~{idx:x}", epoch, j), len(part))
                return
        self._replay_rpc(body, rec.ident, rec.n_metrics)

    def _replay_rpc(self, body: bytes, ident: tuple, n_metrics: int) -> None:
        try:
            self._v1(body, timeout=self.timeout_s,
                     metadata=((CHUNK_ID_KEY, chunk_id_value(ident)),),
                     wait_for_ready=True)
        except grpc.RpcError as e:
            # a lone metric above the peer's receive limit is refused
            # on every attempt: not worth keeping at the spool's head
            if self._rsafe(e) and not (
                    _code_of(e) == grpc.StatusCode.RESOURCE_EXHAUSTED
                    and len(body) > PEER_RECEIVE_LIMIT):
                raise spool_mod.RetryableReplayError(str(e)) from e
            raise
        with self._stats_lock:
            self.sent += n_metrics
            self.chunks += 1
            self.bytes_sent += len(body)

    def _send_attempt(self, chunks: list) -> None:
        """One try at delivering `chunks`; raises _SendFailure carrying
        what is still undelivered."""
        if self._use_v1 is not False:
            try:
                self._send_v1_batches(chunks)
                # a later chunk's UNIMPLEMENTED turns V1 off: keep that
                if self._use_v1 is not False:
                    self._use_v1 = True
                return
            except _V1Unsupported:
                # the first chunk, sent alone, imported nothing: the
                # whole payload goes over V2 below, and so do later
                # flushes
                logger.info("global %s has no V1 batch import; "
                            "using V2 streams", self.address)
                self._use_v1 = False
        pbs = [pb for c in chunks for pb in c.pbs]
        try:
            self._send_v2_fanout(pbs)
        except _SendFailure as f:
            # V2 loses chunk atomicity: the remainder is one anonymous
            # chunk
            raise _SendFailure([_Chunk(f.undelivered)], f.cause,
                               f.retry_safe) from f.cause

    def _send_v2_fanout(self, pbs: list) -> None:
        """V2 streams, split round-robin over up to max_streams for a
        big payload.  The import server applies V2 messages as they
        arrive, so a stream is retry-safe only if gRPC pulled none of
        its messages before it failed."""
        n_streams = min(self.max_streams, max(1, len(pbs) // STREAM_CHUNK))
        slices = [pbs[i::n_streams] for i in range(n_streams)]
        pulled = [0] * n_streams

        def run(i: int) -> None:
            def it():
                for pb in slices[i]:
                    pulled[i] += 1
                    yield pb
            self._v2(it(), timeout=self.timeout_s)

        if n_streams == 1:
            futs = [None]
        else:
            futs = [self._pool.submit(run, i) for i in range(n_streams)]
        undelivered: list = []
        errs = []
        safe = True
        for i, fut in enumerate(futs):
            try:
                run(i) if fut is None else fut.result()
                self._count("sent", len(slices[i]))
            except Exception as e:   # noqa: BLE001 - re-raised below
                undelivered.extend(slices[i])
                errs.append(e)
                safe = safe and pulled[i] == 0 and self._rsafe(e)
        if errs:
            raise _SendFailure(undelivered, errs[0], safe) from errs[0]
        logger.debug("forwarded %d metrics to %s over %d streams",
                     len(pbs), self.address, n_streams)

    def _send_v1_chunk(self, chunk: _Chunk) -> None:
        body = forward_pb2.MetricList(metrics=chunk.pbs).SerializeToString()
        self._v1(body, timeout=self.timeout_s, metadata=(
            (CHUNK_ID_KEY, chunk_id_value(chunk.ident)),))
        with self._stats_lock:
            self.sent += len(chunk.pbs)
            self.chunks += 1
            self.bytes_sent += len(body)

    def _send_v1_batches(self, chunks: list) -> None:
        """One MetricList RPC per chunk, each with its identity.  The
        first chunk goes alone: if it answers UNIMPLEMENTED nothing was
        imported, and the V2 fall-back double-sends nothing.  A later
        chunk's UNIMPLEMENTED (a mixed-version load balancer) re-sends
        exactly those chunks over V2 and turns V1 off.  Any other
        failure raises _SendFailure with exactly the failed chunks."""
        try:
            self._send_v1_chunk(chunks[0])
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                raise _V1Unsupported() from e
            raise _SendFailure(list(chunks), e, self._rsafe(e)) from e
        futs = [(c, self._pool.submit(self._send_v1_chunk, c))
                for c in chunks[1:]]
        errs = []
        undelivered: list = []
        v2_retry: list = []
        for c, fut in futs:
            try:
                fut.result()
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                    v2_retry.extend(c.pbs)
                else:
                    errs.append(e)
                    undelivered.append(c)
            except Exception as e:   # noqa: BLE001 - re-raised below
                errs.append(e)
                undelivered.append(c)
        if v2_retry:
            logger.info(
                "global %s answered UNIMPLEMENTED on later V1 chunk(s); "
                "re-sending %d metrics over V2 and turning V1 off",
                self.address, len(v2_retry))
            self._use_v1 = False
            try:
                self._send_v2_fanout(v2_retry)
            except _SendFailure as f:
                # the V2 remainder joins this attempt's failure, so the
                # bounded retry loop re-sends it
                undelivered.append(_Chunk(f.undelivered))
                raise _SendFailure(
                    undelivered, f.cause,
                    f.retry_safe and all(self._rsafe(e) for e in errs)
                ) from f.cause
        if errs:
            raise _SendFailure(
                undelivered, errs[0],
                all(self._rsafe(e) for e in errs)) from errs[0]

    def close(self, drain_spool: bool = True) -> None:
        """Stop the spool's replayer and close the channel.  A graceful
        close fsyncs the spool's tail; a simulated crash
        (`Server.crash`) passes drain_spool=False and relies on the
        per-append flush and the recovery scan."""
        if self.spool is not None:
            self.spool.close(drain=drain_spool)
        self._pool.shutdown(wait=False)
        self.channel.close()
