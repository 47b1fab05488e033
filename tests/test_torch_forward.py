"""The port's forward / import layer held against the JAX package over
real loopback gRPC (every server binds 127.0.0.1:0 and stops in a
`finally`; every wait polls with a deadline):

  * `forward.convert.to_pb` serializes to the JAX package's bytes for
    every kind and family, and `from_pb` reads back what the JAX
    package's does;
  * the port's client against a JAX import server and the JAX client
    against the port's deliver every metric in V1 chunks that carry
    their identities; a chunk delivered twice merges once at the port's
    dedup ledger; the V2 fall-back on UNIMPLEMENTED; nil and
    type/oneof-mismatched metrics fail alone;
  * the mixed fleet (ROADMAP A7): the same DogStatsD lines through a
    JAX local -> port global, a port local -> JAX global and a JAX local
    -> JAX global, compared under the rules of test_torch_server.py:
    counters, gauges, sets and aggregates exact, percentiles bitwise on
    integer samples and within 1e-6 relative on float samples, and,
    where each package's local compressed its own digests, forwarded
    digests at equal weight with percentiles within the t-digest
    tolerance (2% relative, as test_torch_server.py allows a global
    evaluating its own local's compressed digests);
  * ROADMAP C14: 2,000 digests of 300 centroids (12 MB in one
    count-bounded chunk) reach a global with gRPC's default 4 MiB
    receive limit from the port's client, which bounds a chunk's bytes,
    and are dropped by the JAX client, which does not;
  * a port local forwarding to a port global over gRPC emits, value for
    value, what the same interval forwarded in process emits.
"""

import dataclasses
import socket
import time
from concurrent import futures as cf

import grpc
import numpy as np
import pytest
from google.protobuf import empty_pb2

from veneur_tpu import config as jconfig
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import client as jclient
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu.sketches import hll as jhll
from veneur_tpu.sources import proxy as jproxy
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward import client as tclient
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.protocol import (dogstatsd_grpc_pb2, forward_pb2,
                                       metric_pb2, tdigest_pb2)
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.sketches import compactor as tcomp
from veneur_tpu_torch.sketches import moments as tmo
from veneur_tpu_torch.sources import proxy as tproxy
from tests.test_torch_server import (AGGS, PCTS, _assert_same_metrics,
                                     _by_key, _drain, _forward_fields,
                                     _lines)

FAMILY_RULES = [{"match": "mom.*", "family": "moments"},
                {"match": "c.*", "family": "compactor"}]


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the wire: to_pb / from_pb
# ---------------------------------------------------------------------------

def _every_kind(rng) -> list[dict]:
    """A ForwardMetric's fields for every kind, scope and family."""
    sk = jhll.HLLSketch()
    sk.insert_batch([b"m%d" % i for i in range(200)])
    means = np.sort(rng.gamma(2.0, 20.0, 40))
    wts = rng.integers(1, 9, 40).astype(np.float64)
    mvec = tmo.MomentsSketch(8)
    mvec.add_batch(rng.gamma(2.0, 10.0, 300))
    mvec4 = tmo.MomentsSketch(4)
    mvec4.add_batch(rng.gamma(2.0, 10.0, 30), np.full(30, 2.0))
    csk = tcomp.CompactorSketch()
    csk.add_batch(rng.gamma(2.0, 10.0, 3000))
    digest = dict(digest_means=means.tolist(), digest_weights=wts.tolist(),
                  digest_min=float(means[0]), digest_max=float(means[-1]),
                  digest_sum=float(means @ wts),
                  digest_rsum=float((wts / means).sum()),
                  digest_compression=100.0)
    return [
        dict(name="c", tags=["a:1", "b:2"], kind="counter", scope=2,
             counter_value=-41),
        dict(name="g", tags=[], kind="gauge", scope=2, gauge_value=2.5e-7),
        dict(name="s", tags=["x"], kind="set", scope=0, hll=sk.marshal()),
        dict(name="h", tags=["az:a"], kind="histogram", scope=0, **digest),
        dict(name="t", tags=[], kind="timer", scope=2, **digest),
        dict(name="h0", tags=[], kind="histogram", scope=0,
             digest_means=[], digest_weights=[]),
        dict(name="mom.h", tags=["az:b"], kind="histogram", scope=0,
             moments=list(mvec.vec)),
        dict(name="mom.t", tags=[], kind="timer", scope=2,
             moments=list(mvec4.vec)),
        dict(name="c.h", tags=[], kind="histogram", scope=0,
             compactor=list(csk.to_vector())),
        dict(name="c.t", tags=["q"], kind="timer", scope=2,
             compactor=list(csk.to_vector())),
    ]


def test_to_pb_bytes_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    fields = _every_kind(rng)
    for f in fields:
        got = tconvert.to_pb(tsm.ForwardMetric(**f)).SerializeToString()
        want = jconvert.to_pb(jsm.ForwardMetric(**f)).SerializeToString()
        assert got == want, f["name"]
    assert {f["kind"] for f in fields} == {"counter", "gauge", "set",
                                           "histogram", "timer"}


def test_from_pb_round_trip_equals_the_jax_packages():
    rng = np.random.default_rng(2)
    for f in _every_kind(rng):
        pb = metric_pb2.Metric.FromString(
            jconvert.to_pb(jsm.ForwardMetric(**f)).SerializeToString())
        got = dataclasses.asdict(tconvert.from_pb(pb))
        want = dataclasses.asdict(jconvert.from_pb(pb))
        assert got == want, f["name"]
    with pytest.raises(ValueError, match="nil"):
        tconvert.from_pb(metric_pb2.Metric(name="nil"))


# ---------------------------------------------------------------------------
# chunks: identities and the byte budget
# ---------------------------------------------------------------------------

def test_chunk_ids_round_trip_and_malformed_ids_read_as_none():
    for ident in (("host#0a", 3, 0), ("a:b:c", 2 ** 40, 17)):
        value = tclient.chunk_id_value(ident)
        assert value == jclient.chunk_id_value(ident)
        assert tclient.parse_chunk_id(value) == ident
    for bad in ("", ":1:2", "a:1", "a:x:1", None):
        assert tclient.parse_chunk_id(bad) is None


def _counter_pbs(n, prefix="f"):
    return [tconvert.to_pb(tsm.ForwardMetric(
        name=f"{prefix}{i}", tags=[], kind="counter", scope=2,
        counter_value=1)) for i in range(n)]


def _deep_digest_fields(rng, n_keys, n_centroids) -> list[dict]:
    means = np.sort(rng.gamma(2.0, 20.0, (n_keys, n_centroids)), axis=1)
    wts = rng.integers(1, 9, (n_keys, n_centroids)).astype(np.float64)
    return [dict(name=f"deep.k{i}", tags=["svc:api", "region:us-east-1"],
                 kind="histogram", scope=0, digest_means=means[i].tolist(),
                 digest_weights=wts[i].tolist(),
                 digest_min=float(means[i, 0]),
                 digest_max=float(means[i, -1]),
                 digest_rsum=float((wts[i] / means[i]).sum()))
            for i in range(n_keys)]


def test_chunks_close_at_the_count_or_the_byte_budget():
    """BATCH_MAX small metrics a chunk; deep digests close a chunk at
    BATCH_BYTES of serialized MetricList; a metric above the budget goes
    alone."""
    sizes = [len(c) for c in tclient.chunk_pbs(_counter_pbs(4100))]
    assert sizes == [tclient.BATCH_MAX, tclient.BATCH_MAX, 100]
    rng = np.random.default_rng(3)
    deep = [tconvert.to_pb(tsm.ForwardMetric(**f))
            for f in _deep_digest_fields(rng, 1000, 300)]
    chunks = tclient.chunk_pbs(deep)
    assert len(chunks) > 1 and sum(map(len, chunks)) == 1000
    for c in chunks:
        body = forward_pb2.MetricList(metrics=c).SerializeToString()
        assert len(body) <= tclient.BATCH_BYTES
    huge = tconvert.to_pb(tsm.ForwardMetric(**_deep_digest_fields(
        rng, 1, tclient.BATCH_BYTES // 16)[0]))
    assert huge.ByteSize() > tclient.BATCH_BYTES
    small = _counter_pbs(3)
    assert [len(c) for c in tclient.chunk_pbs(small[:1] + [huge]
                                              + small[1:])] == [1, 1, 2]


# ---------------------------------------------------------------------------
# both clients against both import servers
# ---------------------------------------------------------------------------

class _ImportEdge:
    """One package's import server over its own aggregator and dedup
    ledger, the global tier's receive edge."""

    def __init__(self, pkg: str):
        if pkg == "jax":
            self.agg = JAggregator(percentiles=PCTS, is_local=False)
            # the JAX package's Python import path: its native wire
            # scan needs the native engine, which does not build here
            self.agg._native_import = False
            self.dedup = jproxy.DedupLedger()
            self.server = jproxy.GrpcImportServer(
                "127.0.0.1:0", self.agg.import_metric,
                import_payload=self.agg.import_payload, dedup=self.dedup)
        else:
            self.agg = MetricAggregator(percentiles=PCTS, is_local=False,
                                        device="cpu")
            self.dedup = tproxy.DedupLedger()
            self.server = tproxy.GrpcImportServer(
                "127.0.0.1:0", self.agg.import_metric,
                self.agg.import_payload, dedup=self.dedup)
        self.address = f"127.0.0.1:{self.server.port}"
        self.server.start()

    def stop(self):
        if isinstance(self.server, tproxy.GrpcImportServer):
            self.server.stop()
        else:
            self.server.server.stop(1.0).wait()


def _client(pkg: str, address: str, **kw):
    if pkg == "jax":
        return jclient.ForwardClient(address, timeout_s=10.0, **kw)
    return tclient.ForwardClient(address, timeout_s=10.0, **kw)


def _fm(pkg: str, **fields):
    return (jsm if pkg == "jax" else tsm).ForwardMetric(**fields)


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
def test_clients_deliver_every_metric_in_identified_v1_chunks(
        client_pkg, server_pkg):
    edge = _ImportEdge(server_pkg)
    client = _client(client_pkg, edge.address)
    try:
        n = 2 * tclient.BATCH_MAX + 100
        client.send([_fm(client_pkg, name=f"f{i % 700}", tags=[],
                         kind="counter", scope=2, counter_value=i)
                     for i in range(n)], epoch=7)
        assert client._use_v1 is True
        assert client.stats()["sent"] == n
        assert client.stats()["dropped"] == 0
        assert edge.server.imported_count == n
        # one ledger entry per chunk: every chunk carried its identity
        assert edge.dedup.stats()["recorded"] == 3
        assert edge.dedup.stats()["duplicates"] == 0
        res = edge.agg.flush(is_local=False, now=5)
        got = {m.name: m.value for m in res.metrics}
        want = {f"f{k}": float(sum(range(k, n, 700))) for k in range(700)}
        assert got == want
    finally:
        client.close()
        edge.stop()


def test_a_chunk_delivered_twice_merges_once_at_the_port_ledger():
    edge = _ImportEdge("torch")
    channel = grpc.insecure_channel(edge.address)
    try:
        v1 = channel.unary_unary(
            tclient.SEND_METRICS, request_serializer=lambda b: b,
            response_deserializer=empty_pb2.Empty.FromString)
        body = forward_pb2.MetricList(
            metrics=_counter_pbs(5)).SerializeToString()
        ident = tclient.chunk_id_value(("local#1", 3, 0))
        for _ in range(2):
            v1(body, timeout=10.0,
               metadata=((tclient.CHUNK_ID_KEY, ident),))
        # an unidentified sender always imports
        v1(body, timeout=10.0)
        assert edge.dedup.stats()["duplicates"] == 1
        assert edge.server.imported_count == 10
        res = edge.agg.flush(is_local=False, now=5)
        assert {m.name: m.value for m in res.metrics} == {
            f"f{i}": 2.0 for i in range(5)}
    finally:
        channel.close()
        edge.stop()


def _fake_global(v1, v2):
    handlers = grpc.method_handlers_generic_handler(
        "forwardrpc.Forward", {
            "SendMetrics": grpc.unary_unary_rpc_method_handler(
                v1, request_deserializer=forward_pb2.MetricList.FromString,
                response_serializer=empty_pb2.Empty.SerializeToString),
            "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                v2, request_deserializer=metric_pb2.Metric.FromString,
                response_serializer=empty_pb2.Empty.SerializeToString)})
    server = grpc.server(cf.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


def test_client_falls_back_to_v2_on_unimplemented():
    """Against a reference-shaped global (V1 UNIMPLEMENTED) the first
    send probes once, falls back to V2 and delivers every metric; later
    sends skip the probe (tests/test_forwarding.py:167)."""
    got = []

    def v1(request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "no V1 here")

    def v2(request_iterator, context):
        got.extend(pb.name for pb in request_iterator)
        return empty_pb2.Empty()

    server, address = _fake_global(v1, v2)
    client = tclient.ForwardClient(address, timeout_s=10.0)
    try:
        fms = [tsm.ForwardMetric(name=f"f{i}", tags=[], kind="counter",
                                 scope=2, counter_value=1)
               for i in range(10)]
        client.send(fms)
        assert client._use_v1 is False
        assert sorted(got) == sorted(f"f{i}" for i in range(10))
        client.send(fms)
        assert len(got) == 20
        assert client.stats()["sent"] == 20
    finally:
        client.close()
        server.stop(0).wait()


def test_client_resends_later_unimplemented_chunks_over_v2():
    """A mixed-version load balancer: the first V1 chunk lands, later
    ones answer UNIMPLEMENTED and go over V2, each metric once, and V1
    is off afterwards (tests/test_forwarding.py:213)."""
    import threading
    v1_batches, v2_names, calls = [], [], [0]
    lock = threading.Lock()

    def v1(request, context):
        with lock:
            calls[0] += 1
            mine = calls[0]
        if mine > 1:
            context.abort(grpc.StatusCode.UNIMPLEMENTED,
                          "reference backend: no V1")
        v1_batches.append([m.name for m in request.metrics])
        return empty_pb2.Empty()

    def v2(request_iterator, context):
        names = [pb.name for pb in request_iterator]
        with lock:
            v2_names.extend(names)
        return empty_pb2.Empty()

    server, address = _fake_global(v1, v2)
    client = tclient.ForwardClient(address, timeout_s=10.0)
    try:
        n = tclient.BATCH_MAX * 2 + 10
        fms = [tsm.ForwardMetric(name=f"f{i}", tags=[], kind="counter",
                                 scope=2, counter_value=1)
               for i in range(n)]
        client.send(fms)
        assert len(v1_batches) == 1
        assert sorted(v1_batches[0] + v2_names) == sorted(
            f"f{i}" for i in range(n))
        assert client._use_v1 is False
        client.send(fms[:5])
        assert calls[0] == 3
        assert client.stats()["dropped"] == 0
    finally:
        client.close()
        server.stop(0).wait()


def test_client_retries_unavailable_then_drops_and_counts():
    """Nothing listens: UNAVAILABLE is retry-safe, so the client retries
    up to its policy, then drops the metrics with accounting and
    raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = "127.0.0.1:%d" % s.getsockname()[1]
    client = tclient.ForwardClient(
        address, timeout_s=5.0,
        retry=tclient.RetryPolicy(attempts=3, backoff_base_s=0.01, seed=1))
    try:
        with pytest.raises(grpc.RpcError):
            client.send([tsm.ForwardMetric(name="x", tags=[], kind="gauge",
                                           scope=2, gauge_value=1.0)])
        st = client.stats()
        assert (st["retries"], st["dropped"], st["sent"]) == (2, 1, 0)
        assert st["redials"] == 1
    finally:
        client.close()


def test_forwards_beyond_the_slots_drop_and_count():
    """A local runs at most FORWARD_MAX_IN_FLIGHT forwards at once: with
    every slot held by a stalled forward, the next interval's batch is
    dropped and counted in forward_dropped, not queued; the stalled
    forwards land once released, each under its flush count as epoch."""
    import threading
    gate, got = threading.Event(), []

    def stalled(fms, epoch=None):
        gate.wait(10.0)
        got.append((epoch, len(fms)))

    stalled.accepts_epoch = True
    srv = Server(tconfig.Config(forward_address="in-process",
                                interval=3600.0),
                 forwarder=stalled, device="cpu")
    try:
        n = srv.FORWARD_MAX_IN_FLIGHT
        for i in range(n + 1):
            srv.process_packet_buffer(b"h:%d|h" % i)
            srv.flush()
        assert srv.forward_dropped == 1
        assert not srv.wait_forwards(0.05)
        gate.set()
        assert srv.wait_forwards(10.0)
        assert sorted(got) == [(e, 1) for e in range(1, n + 1)]
        assert srv.forward_errors == 0
    finally:
        gate.set()
        srv.shutdown()


# ---------------------------------------------------------------------------
# malformed metrics fail alone
# ---------------------------------------------------------------------------

def _global_port_server(**kw):
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(grpc_address="127.0.0.1:0", percentiles=PCTS,
                                aggregates=AGGS, hostname="g",
                                interval=3600.0, **kw),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    return srv, sink


def test_import_bad_metric_does_not_kill_the_stream():
    """A nil-valued metric mid-stream is counted and skipped; the rest of
    the stream imports (tests/test_forwarding.py:278)."""
    glob, sink = _global_port_server()
    client = tclient.ForwardClient(f"127.0.0.1:{glob.grpc_import.port}",
                                   timeout_s=10.0)
    try:
        good = tconvert.to_pb(tsm.ForwardMetric(
            name="ok", tags=[], kind="counter", scope=2, counter_value=5))
        bad = metric_pb2.Metric(name="nil", type=metric_pb2.Counter)
        client._v2(iter([bad, good]), timeout=10.0)
        assert glob.grpc_import.import_errors == 1
        assert glob.grpc_import.imported_count == 1
        assert glob.proto_received["grpc"] == 1
        glob.flush()
        assert {m.name: m.value for m in sink.queue.get(timeout=5)} == {
            "ok": 5.0}
    finally:
        client.close()
        glob.shutdown()


def test_import_server_takes_packets_answers_health_and_not_spans():
    """dogstatsd `SendPacket` feeds the global's parser; the health check
    answers SERVING for "" and "veneur" and NOT_FOUND for another name;
    `SendSpan` answers UNIMPLEMENTED until SSF ingest (ROADMAP A15)."""
    glob, sink = _global_port_server()
    channel = grpc.insecure_channel(f"127.0.0.1:{glob.grpc_import.port}")
    try:
        raw = {name: channel.unary_unary(
            name, request_serializer=lambda b: b,
            response_deserializer=lambda b: b) for name in (
                "/dogstatsd.DogstatsdGRPC/SendPacket",
                "/grpc.health.v1.Health/Check", "/ssf.SSFGRPC/SendSpan")}
        raw["/dogstatsd.DogstatsdGRPC/SendPacket"](
            dogstatsd_grpc_pb2.DogstatsdPacket(
                packetBytes=b"p.c:3|c\np.c:4|c").SerializeToString(),
            timeout=10.0)
        check = raw["/grpc.health.v1.Health/Check"]
        assert check(b"", timeout=10.0) == b"\x08\x01"
        assert check(b"\x0a\x06veneur", timeout=10.0) == b"\x08\x01"
        for name, code in (("/grpc.health.v1.Health/Check",
                            grpc.StatusCode.NOT_FOUND),
                           ("/ssf.SSFGRPC/SendSpan",
                            grpc.StatusCode.UNIMPLEMENTED)):
            with pytest.raises(grpc.RpcError) as info:
                raw[name](b"\x0a\x03foo", timeout=10.0)
            assert info.value.code() == code, name
        assert glob.proto_received["dogstatsd-grpc"] == 1
        glob.flush()
        got = {m.name: m.value for m in sink.queue.get(timeout=5)}
        assert got == {"p.c": 7.0}
    finally:
        channel.close()
        glob.shutdown()


def _mismatched_and_good():
    def td():
        return tdigest_pb2.MergingDigestData(
            main_centroids=[tdigest_pb2.Centroid(mean=1.0, weight=1.0)],
            compression=100.0, min=1.0, max=1.0, reciprocalSum=1.0)

    good = [
        metric_pb2.Metric(name="okc", type=metric_pb2.Counter,
                          counter=metric_pb2.CounterValue(value=5)),
        metric_pb2.Metric(name="okg", type=metric_pb2.Gauge,
                          gauge=metric_pb2.GaugeValue(value=2.5)),
        metric_pb2.Metric(name="okt", type=metric_pb2.Timer,
                          histogram=metric_pb2.HistogramValue(
                              t_digest=td())),
    ]
    bad = [
        metric_pb2.Metric(name="t.as.c", type=metric_pb2.Timer,
                          counter=metric_pb2.CounterValue(value=9)),
        metric_pb2.Metric(name="s.as.g", type=metric_pb2.Set,
                          gauge=metric_pb2.GaugeValue(value=7.0)),
        metric_pb2.Metric(name="c.as.h", type=metric_pb2.Counter,
                          histogram=metric_pb2.HistogramValue(
                              t_digest=td())),
        metric_pb2.Metric(name="nil", type=metric_pb2.Counter),
        metric_pb2.Metric(name="loc", type=metric_pb2.Histogram,
                          scope=metric_pb2.Local,
                          histogram=metric_pb2.HistogramValue(
                              t_digest=td())),
    ]
    return good, bad


@pytest.mark.parametrize("payload", [False, True])
def test_import_rejects_type_value_oneof_mismatch_as_jax_does(payload):
    """A metric whose `type` contradicts its value oneof, a nil one and
    a local-scoped one each fail alone, on the port's batched import as
    on the JAX package's (tests/test_forwarding.py:461); the rest
    imports and flushes alike."""
    good, bad = _mismatched_and_good()
    ms = good[:2] + bad + good[2:]
    port = MetricAggregator(percentiles=[0.5], is_local=False, device="cpu")
    ref = JAggregator(percentiles=[0.5], is_local=False)
    if payload:
        got = port.import_payload(
            forward_pb2.MetricList(metrics=ms).SerializeToString())
    else:
        got = port.import_pb_batch(ms)
    assert got == ref.import_pb_batch(ms) == (len(good), len(bad))
    got = sorted((m.name, m.value) for m in port.flush(False, 5).metrics)
    want = sorted((m.name, m.value) for m in ref.flush(False, 5).metrics)
    assert got == want
    assert {n for n, _ in got} >= {"okc", "okg"}
    assert not any(n.startswith(("t.as", "s.as", "c.as", "nil", "loc"))
                   for n, _ in got)


def test_batched_import_equals_one_import_metric_each():
    """import_pb_batch (cached rows, vectorized counters and gauges,
    bulk moments) flushes what import_metric of each metric flushes,
    over every kind and family, with repeated keys and two intervals
    (the row cache is cleared at the cut)."""
    rng = np.random.default_rng(4)
    # (the moments vector of another k fails alone on both paths,
    # test_torch_moments.py)
    fields = [f for f in _every_kind(rng) if f["name"] != "mom.t"] * 2
    fields += [dict(name="c", tags=["b:2", "a:1"], kind="counter", scope=2,
                    counter_value=3),
               dict(name="g", tags=[], kind="gauge", scope=2,
                    gauge_value=-1.0)]
    pbs = [tconvert.to_pb(tsm.ForwardMetric(**f)) for f in fields]
    kw = dict(percentiles=PCTS, aggregates=tsm.parse_aggregates(AGGS),
              is_local=False, sketch_family_rules=FAMILY_RULES,
              device="cpu")
    batched, single = MetricAggregator(**kw), MetricAggregator(**kw)
    for interval in range(2):
        assert batched.import_pb_batch(pbs) == (len(pbs), 0)
        for f in fields:
            single.import_metric(tsm.ForwardMetric(**f))
        got = batched.flush(False, 5 + interval)
        want = single.flush(False, 5 + interval)
        assert _by_key(got.metrics) == _by_key(want.metrics)
        assert got.imported == want.imported == len(pbs)


# ---------------------------------------------------------------------------
# C14: V1 chunks bounded by bytes
# ---------------------------------------------------------------------------

_DEEP_KEYS, _DEEP_CENTROIDS = 2000, 300


@pytest.fixture(scope="module")
def deep_fields():
    return _deep_digest_fields(np.random.default_rng(5), _DEEP_KEYS,
                               _DEEP_CENTROIDS)


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_c14_port_client_delivers_deep_digests(server_pkg, deep_fields):
    """2,000 digests of 300 centroids are 12 MB, three times gRPC's
    default 4 MiB receive limit, which both globals keep: the port's
    client closes its chunks at BATCH_BYTES and delivers them all."""
    edge = _ImportEdge(server_pkg)
    client = _client("torch", edge.address)
    try:
        client.send([tsm.ForwardMetric(**f) for f in deep_fields])
        st = client.stats()
        assert st["dropped"] == 0 and st["sent"] == _DEEP_KEYS
        assert st["chunks"] > 1
        assert st["bytes_sent"] > 4 * 1024 * 1024
        assert edge.server.imported_count == _DEEP_KEYS
        assert edge.dedup.stats()["recorded"] == st["chunks"]
    finally:
        client.close()
        edge.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_c14_jax_client_drops_deep_digests(server_pkg, deep_fields):
    """The JAX client bounds a chunk by count alone: its one chunk of
    2,000 deep digests exceeds the peer's 4 MiB limit, RESOURCE_EXHAUSTED
    is retry-safe, so it re-sends the same chunk until its retries run
    out, then drops all 2,000."""
    edge = _ImportEdge(server_pkg)
    client = _client("jax", edge.address, retry=jclient.RetryPolicy(
        attempts=3, backoff_base_s=0.01, seed=1))
    try:
        with pytest.raises(grpc.RpcError) as info:
            client.send([jsm.ForwardMetric(**f) for f in deep_fields])
        assert info.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        st = client.stats()
        assert (st["dropped"], st["sent"], st["retries"]) == (
            _DEEP_KEYS, 0, 2)
        assert edge.server.imported_count == 0
    finally:
        client.close()
        edge.stop()


# ---------------------------------------------------------------------------
# A7: the mixed fleet
# ---------------------------------------------------------------------------

def _boot_global(pkg: str):
    common = dict(grpc_address="127.0.0.1:0", percentiles=PCTS,
                  aggregates=AGGS, hostname="g", interval=3600.0)
    if pkg == "jax":
        sink = jsimple.ChannelMetricSink()
        srv = JServer(jconfig.Config(native_ingest=False, **common),
                      extra_metric_sinks=[sink])
        srv.start()
        srv.aggregator._native_import = False
    else:
        sink = tsimple.ChannelMetricSink()
        srv = Server(tconfig.Config(**common), extra_metric_sinks=[sink],
                     device="cpu")
        srv.start()
    return srv, sink


def _boot_local(pkg: str, address: str):
    common = dict(forward_address=address, percentiles=PCTS,
                  aggregates=AGGS, hostname="l", interval=3600.0,
                  forward_timeout=10.0)
    if pkg == "jax":
        srv = JServer(jconfig.Config(native_ingest=False, **common),
                      extra_metric_sinks=[jsimple.ChannelMetricSink()])
        srv.start()
    else:
        srv = Server(tconfig.Config(**common), device="cpu")
    return srv


def _fleet(local_pkg: str, global_pkg: str, lines, fwd_fields):
    """One interval through a local of `local_pkg` forwarding over gRPC
    to a global of `global_pkg`; the local's client also sends the
    forwarded fields.  Returns the global's InterMetrics."""
    glob, sink = _boot_global(global_pkg)
    local = None
    try:
        local = _boot_local(local_pkg, f"127.0.0.1:{glob.grpc_import.port}")
        for i in range(0, len(lines), 20):
            local.process_packet_buffer(b"\n".join(lines[i:i + 20]))
        local.flush()
        _wait(lambda: local._forward_slots._value
              == local.FORWARD_MAX_IN_FLIGHT, "forward never landed")
        # an epoch of its own: the flush's forward took epoch 1, and a
        # chunk identity seen twice merges once
        local.forwarder.send([_fm(local_pkg, **f) for f in fwd_fields],
                             epoch=1000)
        assert local.forwarder.stats()["dropped"] == 0
        assert glob.grpc_import.import_errors == 0
        glob.flush()
        assert glob.egress.settle(timeout_s=10.0)
        return [m for batch in _drain(sink) for m in batch]
    finally:
        if local is not None:
            local.shutdown()
        glob.shutdown()


def _assert_same_after_own_compression(got, want):
    """A port local and a JAX local compress their digests each in its
    own order (test_torch_tdigest.py): the global's percentiles of those
    keys agree within the t-digest tolerance, their sums and means
    within 1e-6 relative, everything else exactly."""
    got, want = ({k: v for k, v in _by_key(ms).items()
                  if k[0].startswith("t.")} for ms in (got, want))
    assert set(got) == set(want) and got
    for key, w in want.items():
        name, g = key[0], got[key]
        compressed = name.startswith(("t.lat", "t.sampled"))
        if compressed and name.endswith(("percentile", ".median")):
            assert g == pytest.approx(w, rel=0.02), key
        elif compressed and name.endswith((".sum", ".avg")):
            assert g == pytest.approx(w, rel=1e-6), key
        else:
            assert g == w, (key, g, w)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("local_pkg,global_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_mixed_fleet_emits_what_the_jax_fleet_does(local_pkg, global_pkg,
                                                   integer):
    rng = np.random.default_rng(30 + integer)
    lines = _lines(rng, integer)
    fwd = _forward_fields(rng, integer)
    want = _fleet("jax", "jax", lines, fwd)
    got = _fleet(local_pkg, global_pkg, lines, fwd)
    assert any(m.name == "t.fwd0.50percentile" for m in want)
    if local_pkg == "jax":
        # the same JAX local's digests, evaluated by the port's global
        _assert_same_metrics(got, want, integer)
    else:
        _assert_same_after_own_compression(got, want)


# ---------------------------------------------------------------------------
# the port's two tiers over gRPC
# ---------------------------------------------------------------------------

def _family_lines(rng) -> list[bytes]:
    out = []
    for k in range(4):
        out += [b"h.lat%d:%.4f|h|#svc:a" % (k, x)
                for x in rng.gamma(2.0, 20.0, 200)]
    out += [b"mom.lat:%.4f|ms" % x for x in rng.gamma(2.0, 20.0, 400)]
    out += [b"c.lat:%.4f|h" % x for x in rng.gamma(2.0, 20.0, 600)]
    out += [b"c.glat:%.4f|h|#veneurglobalonly" % x
            for x in rng.gamma(2.0, 20.0, 100)]
    out += [b"hits:1|c|@0.5"] * 30
    out += [b"gbytes:%d|c|#veneurglobalonly" % i for i in range(10)]
    out += [b"gtemp:%d|g|#veneurglobalonly" % i for i in range(4)]
    out += [b"users:u%d|s" % i for i in range(300)]
    return out


def test_port_local_forwards_to_port_global_over_grpc():
    """Real UDP into a port local, its forward over gRPC to a port
    global: the global emits, value for value, what a global fed the
    same interval in process emits, for every family; the forward went
    out in identified V1 chunks and nothing dropped."""
    rng = np.random.default_rng(6)
    lines = _family_lines(rng)
    kw = dict(percentiles=PCTS, aggregates=AGGS, interval=3600.0,
              sketch_family_rules=FAMILY_RULES)
    gsink, isink = tsimple.ChannelMetricSink(), tsimple.ChannelMetricSink()
    glob = Server(tconfig.Config(grpc_address="127.0.0.1:0", hostname="g",
                                 **kw),
                  extra_metric_sinks=[gsink], device="cpu")
    inproc = Server(tconfig.Config(hostname="g", **kw),
                    extra_metric_sinks=[isink], device="cpu")
    glob.start()
    local = twin = None
    try:
        local = Server(tconfig.Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"], hostname="l",
            forward_address=f"127.0.0.1:{glob.grpc_import.port}",
            forward_timeout=10.0, **kw), device="cpu")
        twin = Server(tconfig.Config(forward_address="in-process",
                                     hostname="l", **kw),
                      forwarder=inproc.aggregator.import_metrics,
                      device="cpu")
        local.start()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(0, len(lines), 20):
                s.sendto(b"\n".join(lines[i:i + 20]),
                         local.statsd_addrs[0][1])
                _wait(lambda: local.aggregator.processed
                      >= min(i + 20, len(lines)), "UDP lines not read")
        for i in range(0, len(lines), 20):
            twin.process_packet_buffer(b"\n".join(lines[i:i + 20]))
        res = local.flush()
        twin.flush()
        assert local.wait_forwards(10.0) and twin.wait_forwards(10.0)
        st = local.forwarder.stats()
        assert st["sent"] == len(res.forward) and st["dropped"] == 0
        assert st["chunks"] == glob.dedup.stats()["recorded"] == 1
        assert glob.proto_received["grpc"] == len(res.forward)
        glob.flush()
        inproc.flush()
        got = _by_key(gsink.queue.get(timeout=5))
        want = _by_key(isink.queue.get(timeout=5))
        assert got == want
        names = {k[0] for k in got}
        assert {"h.lat0.99percentile", "mom.lat.50percentile",
                "c.lat.90percentile", "c.glat.count", "gbytes", "gtemp",
                "users"} <= names
    finally:
        for srv in (local, twin, glob, inproc):
            if srv is not None:
                srv.shutdown()
