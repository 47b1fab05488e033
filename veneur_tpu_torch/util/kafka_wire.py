"""Dependency-free Kafka wire-protocol producer.

The port's copy of `veneur_tpu.util.kafka_wire`.

The reference produces through sarama (`sinks/kafka/kafka.go:48,74`); the
port uses no Kafka client library, so the real-backend path speaks the public
Kafka protocol directly (KIP-98 RecordBatch v2, the format every broker
since 0.11 accepts):

  * Metadata v1 (ApiKey 3) — discover partition leaders;
  * Produce v3 (ApiKey 0)  — one RecordBatch v2 per (topic, partition),
    CRC32C (Castagnoli) over the batch body, acks=1;
  * murmur2 key partitioning, matching the Java client's default
    partitioner so keyed messages land on the same partitions a
    reference fleet's would.

Scope is deliberately a *producer*: flush-cadence batching, leader
reconnect on error, no consumer/transactions/compression.  The fake
broker in tests/test_torch_sinks.py parses the produced batches back
(including CRC verification) as the protocol contract.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Optional

logger = logging.getLogger("veneur_tpu_torch.util.kafka_wire")

API_PRODUCE = 0
API_METADATA = 3

# transport/protocol failures that invalidate a connection or metadata
# (struct.error/IndexError = truncated or desynced responses)
_PROTO_ERRORS = (OSError, IOError, struct.error, IndexError, ValueError)


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected, poly 0x1EDC6F41) — RecordBatch checksum
# ---------------------------------------------------------------------------

def _make_crc32c_tables() -> list[list[int]]:
    """Slicing-by-8 tables: ~6x faster than the per-byte loop in pure
    Python (batches can be megabytes per flush)."""
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        t0.append(crc)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8)
                       for i in range(256)])
    return tables


_T = _make_crc32c_tables()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        lo = crc ^ int.from_bytes(data[i:i + 4], "little")
        hi = int.from_bytes(data[i + 4:i + 8], "little")
        crc = (t7[lo & 0xFF] ^ t6[(lo >> 8) & 0xFF]
               ^ t5[(lo >> 16) & 0xFF] ^ t4[lo >> 24]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
    for b in data[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# murmur2 (the Java client's default partitioner hash)
# ---------------------------------------------------------------------------

def murmur2(data: bytes) -> int:
    m = 0x5BD1E995
    mask = 0xFFFFFFFF
    h = (0x9747B28C ^ len(data)) & mask
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * m) & mask
        k ^= k >> 24
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
    rem = len(data) & 3
    if rem == 3:
        h ^= data[n + 2] << 16
    if rem >= 2:
        h ^= data[n + 1] << 8
    if rem >= 1:
        h ^= data[n]
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def partition_for(key: Optional[bytes], n_partitions: int,
                  counter: int = 0) -> int:
    """Java default partitioner: murmur2(key) with the sign bit masked;
    round-robin only when the key is absent (an EMPTY key still hashes,
    as in the Java client)."""
    if key is None:
        return counter % n_partitions
    return (murmur2(key) & 0x7FFFFFFF) % n_partitions


# ---------------------------------------------------------------------------
# Primitive encoding
# ---------------------------------------------------------------------------

def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _varint(n: int) -> bytes:
    """Zigzag varint (record fields)."""
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while (z & ~0x7F) != 0:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


def read_varint(buf: bytes, off: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (result >> 1) ^ -(result & 1), off


# ---------------------------------------------------------------------------
# RecordBatch v2
# ---------------------------------------------------------------------------

def encode_record_batch(records: list[tuple[Optional[bytes], bytes]],
                        base_ts_ms: Optional[int] = None) -> bytes:
    """[(key, value), ...] -> one RecordBatch v2 (magic 2, uncompressed)."""
    base_ts = base_ts_ms if base_ts_ms is not None else int(
        time.time() * 1000)
    recs = bytearray()
    for i, (key, value) in enumerate(records):
        body = bytearray()
        body += b"\x00"                      # attributes
        body += _varint(0)                   # timestamp delta
        body += _varint(i)                   # offset delta
        if key is None:
            body += _varint(-1)
        else:
            body += _varint(len(key))
            body += key
        body += _varint(len(value))
        body += value
        body += _varint(0)                   # headers count
        recs += _varint(len(body))
        recs += body

    n = len(records)
    # everything after the crc field participates in the crc
    after_crc = (
        struct.pack(">hiqqqhi", 0, n - 1, base_ts, base_ts, -1, -1, -1)
        + struct.pack(">i", n) + bytes(recs))
    # attributes=0, lastOffsetDelta, firstTs, maxTs, producerId=-1,
    # producerEpoch=-1, baseSequence=-1
    crc = crc32c(after_crc)
    body = struct.pack(">iBI", -1, 2, crc) + after_crc
    # partitionLeaderEpoch=-1, magic=2, crc
    return struct.pack(">qi", 0, len(body)) + body  # baseOffset, batchLength


def parse_record_batch(buf: bytes) -> list[tuple[Optional[bytes], bytes]]:
    """Decode one RecordBatch v2 back to [(key, value)], verifying the
    CRC (the test broker's side of the contract)."""
    base_offset, batch_len = struct.unpack_from(">qi", buf, 0)
    _, magic, crc = struct.unpack_from(">iBI", buf, 12)
    if magic != 2:
        raise ValueError(f"unsupported magic {magic}")
    after_crc = buf[21:12 + batch_len]
    if crc32c(after_crc) != crc:
        raise ValueError("RecordBatch CRC mismatch")
    (_, _, _, _, _, _, _) = struct.unpack_from(">hiqqqhi", after_crc, 0)
    (count,) = struct.unpack_from(">i", after_crc, 36)
    off = 40
    out = []
    for _ in range(count):
        length, off = read_varint(after_crc, off)
        end = off + length
        off += 1  # attributes
        _, off = read_varint(after_crc, off)   # ts delta
        _, off = read_varint(after_crc, off)   # offset delta
        klen, off = read_varint(after_crc, off)
        key = None
        if klen >= 0:
            key = after_crc[off:off + klen]
            off += klen
        vlen, off = read_varint(after_crc, off)
        value = after_crc[off:off + vlen]
        off += vlen
        nh, off = read_varint(after_crc, off)
        for _ in range(nh):
            raise ValueError("headers unsupported in this parser")
        off = end
        out.append((key, value))
    return out


# ---------------------------------------------------------------------------
# Broker connection
# ---------------------------------------------------------------------------

class _Conn:
    def __init__(self, host: str, port: int, client_id: str,
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        self.client_id = client_id
        self.correlation = 0

    def request(self, api_key: int, api_version: int, body: bytes) -> bytes:
        self.correlation += 1
        header = struct.pack(">hhi", api_key, api_version,
                             self.correlation) + _str(self.client_id)
        msg = header + body
        self.sock.sendall(struct.pack(">i", len(msg)) + msg)
        (length,) = struct.unpack(">i", self._read(4))
        resp = self._read(length)
        (corr,) = struct.unpack_from(">i", resp, 0)
        if corr != self.correlation:
            raise IOError(f"correlation mismatch {corr}")
        return resp[4:]

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("broker closed connection")
            buf += chunk
        return buf

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _read_str(buf: bytes, off: int) -> tuple[Optional[str], int]:
    (n,) = struct.unpack_from(">h", buf, off)
    off += 2
    if n < 0:
        return None, off
    return buf[off:off + n].decode(), off + n


class KafkaProducer:
    """Minimal synchronous producer: metadata-driven leader routing,
    per-flush batches, acks=1, reconnect-and-refresh on error."""

    # stay under the broker's default message.max.bytes (~1MB) with room
    # for batch/framing overhead
    MAX_BATCH_BYTES = 900_000

    def __init__(self, brokers: list[str], client_id: str = "veneur-tpu",
                 timeout_s: float = 10.0,
                 max_batch_bytes: int = MAX_BATCH_BYTES):
        self.brokers = []
        for addr in brokers:
            host, _, port = addr.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"kafka broker address {addr!r} must be host:port")
            self.brokers.append((host, int(port)))
        self.client_id = client_id
        self.timeout_s = timeout_s
        self.max_batch_bytes = max_batch_bytes
        self._lock = threading.Lock()
        self._conns: dict[tuple[str, int], _Conn] = {}
        # topic -> {partition: (host, port)}
        self._leaders: dict[str, dict[int, tuple[str, int]]] = {}
        self._rr = 0
        self.produced = 0
        self.errors = 0

    # -- metadata ----------------------------------------------------------

    def _bootstrap_conn(self) -> _Conn:
        last: Optional[Exception] = None
        for host, port in self.brokers:
            try:
                return self._conn(host, port)
            except OSError as e:
                last = e
        raise ConnectionError(f"no bootstrap broker reachable: {last}")

    def _conn(self, host: str, port: int) -> _Conn:
        key = (host, port)
        conn = self._conns.get(key)
        if conn is None:
            conn = _Conn(host, port, self.client_id, self.timeout_s)
            self._conns[key] = conn
        return conn

    def _drop_conn(self, host: str, port: int) -> None:
        conn = self._conns.pop((host, port), None)
        if conn is not None:
            conn.close()

    def refresh_metadata(self, topic: str) -> None:
        conn = self._bootstrap_conn()
        body = struct.pack(">i", 1) + _str(topic)
        resp = conn.request(API_METADATA, 1, body)
        off = 0
        (n_brokers,) = struct.unpack_from(">i", resp, off)
        off += 4
        nodes: dict[int, tuple[str, int]] = {}
        for _ in range(n_brokers):
            (node_id,) = struct.unpack_from(">i", resp, off)
            off += 4
            host, off = _read_str(resp, off)
            (port,) = struct.unpack_from(">i", resp, off)
            off += 4
            _, off = _read_str(resp, off)  # rack
            nodes[node_id] = (host, port)
        off += 4  # controller id
        (n_topics,) = struct.unpack_from(">i", resp, off)
        off += 4
        for _ in range(n_topics):
            (err,) = struct.unpack_from(">h", resp, off)
            off += 2
            name, off = _read_str(resp, off)
            off += 1  # is_internal
            (n_parts,) = struct.unpack_from(">i", resp, off)
            off += 4
            parts: dict[int, tuple[str, int]] = {}
            for _ in range(n_parts):
                perr, pid, leader = struct.unpack_from(">hii", resp, off)
                off += 10
                (n_rep,) = struct.unpack_from(">i", resp, off)
                off += 4 + 4 * n_rep
                (n_isr,) = struct.unpack_from(">i", resp, off)
                off += 4 + 4 * n_isr
                if perr == 0 and leader in nodes:
                    parts[pid] = nodes[leader]
            if err == 0 and name == topic and parts:
                self._leaders[topic] = parts
        if topic not in self._leaders:
            raise IOError(f"no leaders for topic {topic!r}")

    # -- produce -----------------------------------------------------------

    def produce_batch(self, topic: str,
                      messages: list[tuple[Optional[bytes], bytes]]) -> int:
        """Produce keyed messages; returns how many were acked.

        Partition by murmur2(key), one Produce request per leader.  A
        failure (transport error, malformed response, or a per-partition
        error code) fails only THAT subset of messages; the failed subset
        gets one retry after a metadata refresh, so messages acked on
        healthy leaders are never re-sent (no duplicate writes from a
        partial failure)."""
        with self._lock:
            acked, failed = self._produce_once(topic, messages)
            if failed:
                logger.warning(
                    "kafka produce to %s: %d messages failed; refreshing "
                    "metadata and retrying them", topic, len(failed))
                self._leaders.pop(topic, None)
                for conn in self._conns.values():
                    conn.close()
                self._conns.clear()
                acked2, failed2 = self._produce_once(topic, failed)
                acked += acked2
                self.errors += len(failed2)
            self.produced += acked
            return acked

    def _produce_once(self, topic, messages
                      ) -> tuple[int, list]:
        """One produce pass: returns (acked_count, failed_messages)."""
        try:
            if topic not in self._leaders:
                self.refresh_metadata(topic)
            parts = self._leaders[topic]
        except _PROTO_ERRORS as e:
            logger.warning("kafka metadata for %s failed: %s", topic, e)
            return 0, list(messages)
        n_parts = max(parts) + 1
        by_leader: dict[tuple[str, int], dict[int, list]] = {}
        for key, value in messages:
            pid = partition_for(key, n_parts, self._rr)
            self._rr += 1
            if pid not in parts:
                pid = sorted(parts)[pid % len(parts)]
            by_leader.setdefault(parts[pid], {}).setdefault(
                pid, []).append((key, value))

        acked = 0
        failed: list = []
        for (host, port), partitions in by_leader.items():
            # split each partition's messages so no RecordBatch exceeds
            # the broker's message size limit (MESSAGE_TOO_LARGE would
            # fail the whole partition every interval otherwise); one
            # Produce request per chunk round
            chunked = {pid: self._chunk(msgs)
                       for pid, msgs in partitions.items()}
            rounds = max(len(c) for c in chunked.values())
            for r in range(rounds):
                round_parts = {pid: chunks[r]
                               for pid, chunks in chunked.items()
                               if r < len(chunks)}
                topic_data = _str(topic) + struct.pack(
                    ">i", len(round_parts))
                for pid, msgs in sorted(round_parts.items()):
                    batch = encode_record_batch(msgs)
                    topic_data += struct.pack(">i", pid) + _bytes(batch)
                body = (_str(None)                  # transactional_id
                        + struct.pack(">hi", 1, int(self.timeout_s * 1000))
                        + struct.pack(">i", 1) + topic_data)
                try:
                    resp = self._conn(host, port).request(
                        API_PRODUCE, 3, body)
                    part_errors = self._parse_produce_response(resp)
                except _PROTO_ERRORS as e:
                    logger.warning("kafka produce to %s:%d failed: %s",
                                   host, port, e)
                    self._drop_conn(host, port)
                    for msgs in round_parts.values():
                        failed.extend(msgs)
                    continue
                for pid, msgs in round_parts.items():
                    err = part_errors.get(pid, -1)
                    if err == 0:
                        acked += len(msgs)
                    else:
                        logger.warning("kafka partition %d error code %d",
                                       pid, err)
                        failed.extend(msgs)
        return acked, failed

    def _chunk(self, msgs: list) -> list[list]:
        """Split messages into runs whose encoded size stays under
        max_batch_bytes (~70B/record framing overhead bound)."""
        chunks: list[list] = []
        cur: list = []
        size = 0
        for key, value in msgs:
            rec = len(value) + (len(key) if key else 0) + 70
            if cur and size + rec > self.max_batch_bytes:
                chunks.append(cur)
                cur, size = [], 0
            cur.append((key, value))
            size += rec
        if cur:
            chunks.append(cur)
        return chunks

    @staticmethod
    def _parse_produce_response(resp: bytes) -> dict[int, int]:
        """Produce v3 response -> {partition: error_code}."""
        off = 0
        (n_topics,) = struct.unpack_from(">i", resp, off)
        off += 4
        errors: dict[int, int] = {}
        for _ in range(n_topics):
            _, off = _read_str(resp, off)
            (n_parts,) = struct.unpack_from(">i", resp, off)
            off += 4
            for _ in range(n_parts):
                # partition(i32) error(i16) base_offset(i64) log_ts(i64)
                pid, err, _base, _ts = struct.unpack_from(">ihqq", resp,
                                                          off)
                off += 22
                errors[pid] = err
        return errors

    def close(self) -> None:
        with self._lock:
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()
