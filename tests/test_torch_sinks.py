"""The port's metric sinks held against the JAX package's.

Every metric case of tests/test_sinks.py and tests/test_kafka_wire.py,
run through the port's sink and the JAX sink against the same kind of
local capture (an HTTP server, a UDP socket, a recording callable, a fake
Kafka broker): the decoded bodies and the headers each sink sets are
equal, and each side meets the JAX test's own assertions.  Plus the
published AWS SigV4 vector, the snappy round trip, the Kafka wire
vectors, and the port's standard-library `ParallelPoster`.  The span
halves of the datadog, kafka, mock and newrelic sinks and the span-only
kinds wait for the span pipeline (ROADMAP A15).
"""

import gzip
import json
import socket
import struct
import threading
import urllib.parse
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)

import numpy as np
import pytest

from tests.test_kafka_wire import FakeBroker
from tests.test_sinks import _parse_write_request, _SigV4Handler
from veneur_tpu import sinks as jsinks
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.util import awsauth as jawsauth
from veneur_tpu.util import kafka_wire as jkw
from veneur_tpu.util import snappy as jsnappy
from veneur_tpu_torch import sinks as tsinks
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.util import awsauth as tawsauth
from veneur_tpu_torch.util import kafka_wire as tkw
from veneur_tpu_torch.util import snappy as tsnappy

PKGS = {"port": (tsinks, tsm, tparser), "jax": (jsinks, jsm, jparser)}

# request headers the HTTP client library sets, not the sink
TRANSPORT_HEADERS = {"host", "user-agent", "accept-encoding", "accept",
                     "connection", "content-length"}


def _sink_module(pkg: str, kind: str):
    import importlib
    root = "veneur_tpu_torch" if pkg == "port" else "veneur_tpu"
    return importlib.import_module(f"{root}.sinks.{kind}")


def _spec(pkg, kind, **cfg):
    return PKGS[pkg][0].SinkSpec(kind=kind, config=cfg)


def im(pkg, name="a.b.c", value=1.0, mtype="gauge", tags=(),
       ts=1700000000, hostname="testhost"):
    return PKGS[pkg][1].InterMetric(name=name, timestamp=ts, value=value,
                                    tags=list(tags), type=mtype,
                                    hostname=hostname)


class _Capture(BaseHTTPRequestHandler):
    """Records every request; answers the next code of `responses`
    (200 when none is left)."""

    def _handle(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        with self.server.lock:
            self.server.captured.append({
                "method": self.command, "path": self.path,
                "headers": dict(self.headers), "body": body})
            code = (self.server.responses.pop(0) if self.server.responses
                    else 200)
        self.send_response(code)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    do_POST = do_PUT = do_GET = _handle

    def log_message(self, *a):
        pass


def _serve(handler=_Capture):
    srv = HTTPServer(("127.0.0.1", 0), handler)
    srv.captured, srv.responses, srv.lock = [], [], threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def captures():
    """One capture server a package, so both packages' requests are
    held side by side."""
    srvs = {pkg: _serve() for pkg in PKGS}
    yield srvs
    for srv in srvs.values():
        srv.shutdown()
        srv.server_close()


def _url(srv, path=""):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def _sink_headers(req) -> dict:
    return {k: v for k, v in req["headers"].items()
            if k.lower() not in TRANSPORT_HEADERS}


def _same_requests(captures, decode):
    """Both packages' requests equal: path, the headers the sink set,
    and the decoded body; in arrival order unless the sink posts in
    parallel (then sorted by the decoded body)."""
    out = {}
    for pkg, srv in captures.items():
        out[pkg] = sorted(
            [(r["method"], r["path"].split("?")[0],
              sorted(_sink_headers(r).items()),
              json.dumps(decode(r["body"]), sort_keys=True))
             for r in srv.captured], key=repr)
    assert out["port"] == out["jax"]
    assert out["port"]
    return out["port"]


def _gunzip_json(body):
    return json.loads(gzip.decompress(body))


# -- registry ----------------------------------------------------------------

def test_registry_has_every_jax_metric_sink_kind():
    assert set(tsinks.METRIC_SINK_TYPES) == set(jsinks.METRIC_SINK_TYPES)
    for kind in tsinks.METRIC_SINK_TYPES:
        sink = tsinks.create_metric_sink(tsinks.SinkSpec(kind=kind))
        assert sink.kind() == kind and sink.name() == kind
    with pytest.raises(ValueError, match="unknown metric sink kind"):
        tsinks.create_metric_sink(tsinks.SinkSpec(kind="splunk"))
    with pytest.raises(ValueError, match="unknown metric sink kind"):
        jsinks.create_metric_sink(jsinks.SinkSpec(kind="splunk"))


# -- datadog -----------------------------------------------------------------

def test_datadog_series_rate_conversion_and_host_tag(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(pkg, "datadog", api_key="k",
                                           api_hostname=_url(srv)))
        sink.interval_s = 10.0
        res = sink.flush([
            im(pkg, "req.count", 50.0, "counter"),
            im(pkg, "mem.used", 3.5, "gauge",
               tags=["host:other", "device:sda"])])
        assert (res.flushed, res.dropped) == (2, 0)
        payload = _gunzip_json(srv.captured[0]["body"])
        by_name = {s["metric"]: s for s in payload["series"]}
        rate = by_name["req.count"]
        assert rate["type"] == "rate" and rate["interval"] == 10
        assert rate["points"][0][1] == 5.0
        gauge = by_name["mem.used"]
        assert gauge["host"] == "other" and gauge["device"] == "sda"
        assert gauge["tags"] == []
        sink.close()
    reqs = _same_requests(captures, _gunzip_json)
    assert dict(reqs[0][2])["DD-API-KEY"] == "k"
    assert dict(reqs[0][2])["Content-Encoding"] == "gzip"


def test_datadog_events_and_checks(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(pkg, "datadog", api_key="k",
                                           api_hostname=_url(srv)))
        if pkg == "port":
            ev = tparser.SSFSample(
                name="deploy", message="went fine", timestamp=1700000000,
                tags={tparser.EVENT_IDENTIFIER_KEY: "",
                      tparser.EVENT_PRIORITY_TAG: "low", "env": "prod"})
            check = tparser.SSFSample(
                name="db.up", message="ok", status=0,
                timestamp=1700000000, tags={"env": "prod"})
        else:
            from veneur_tpu.protocol import ssf_pb2
            ev = ssf_pb2.SSFSample(
                name="deploy", message="went fine", timestamp=1700000000,
                tags={jparser.EVENT_IDENTIFIER_KEY: "",
                      jparser.EVENT_PRIORITY_TAG: "low", "env": "prod"})
            check = ssf_pb2.SSFSample(
                name="db.up", message="ok", status=ssf_pb2.SSFSample.OK,
                timestamp=1700000000, tags={"env": "prod"})
        sink.flush_other_samples([ev, check])
        paths = sorted(c["path"] for c in srv.captured)
        assert paths[0].startswith("/api/v1/check_run")
        assert paths[1].startswith("/intake")
        for c in srv.captured:
            body = _gunzip_json(c["body"])
            if c["path"].startswith("/intake"):
                e = body["events"]["api"][0]
                assert e["title"] == "deploy" and e["priority"] == "low"
                assert "env:prod" in e["tags"]
            else:
                assert body[0]["check"] == "db.up"
                assert body[0]["status"] == 0
        sink.close()
    _same_requests(captures, _gunzip_json)


def test_datadog_status_metrics_become_service_checks(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(pkg, "datadog", api_key="k",
                                           api_hostname=_url(srv)))
        status = im(pkg, "db.up", 1.0, "status", tags=["host:db7", "az:a"])
        status.message = "replica lag"
        res = sink.flush([status, im(pkg, "api.hits", 5, "counter")])
        assert res.flushed == 2
        by_path = {c["path"].split("?")[0]: c for c in srv.captured}
        checks = _gunzip_json(by_path["/api/v1/check_run"]["body"])
        assert checks == [{"check": "db.up", "status": 1,
                           "host_name": "db7", "timestamp": 1700000000,
                           "tags": ["az:a"], "message": "replica lag"}]
        series = _gunzip_json(by_path["/api/v1/series"]["body"])["series"]
        assert [s["metric"] for s in series] == ["api.hits"]
        sink.close()
    _same_requests(captures, _gunzip_json)


def test_datadog_retries_transient_then_succeeds(captures):
    for pkg, srv in captures.items():
        srv.responses[:] = [503, 429]  # two transient errors, then 200
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(
            pkg, "datadog", api_key="k", flush_retries=3,
            api_hostname=_url(srv)))
        res = sink.flush([im(pkg, "dd.retry", 1.0, "counter")])
        assert (res.flushed, res.dropped) == (1, 0)
        assert len(srv.captured) == 3
        sink.close()
    _same_requests(captures, _gunzip_json)


def test_datadog_no_retry_on_client_error(captures):
    for pkg, srv in captures.items():
        srv.responses[:] = [403]
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(
            pkg, "datadog", api_key="bad", flush_retries=3,
            api_hostname=_url(srv)))
        res = sink.flush([im(pkg, "dd.permfail", 1.0)])
        assert res.dropped == 1
        assert len(srv.captured) == 1  # permanent 4xx never retries
        sink.close()


def test_datadog_validate_on_start(captures, caplog):
    import logging
    for pkg, srv in captures.items():
        srv.responses[:] = [403]
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(
            pkg, "datadog", api_key="bad", validate_on_start=True,
            api_hostname=_url(srv)))
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger=mod.logger.name):
            sink.start(None)
        assert len(srv.captured) == 1
        assert srv.captured[0]["method"] == "GET"
        assert srv.captured[0]["path"] == "/api/v1/validate"
        assert any("rejected" in r.message for r in caplog.records)
        sink.close()
    _same_requests(captures, lambda b: b.decode())


def test_datadog_parallel_chunk_posts(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(
            pkg, "datadog", api_key="k", flush_max_per_body=10,
            api_hostname=_url(srv)))
        res = sink.flush([im(pkg, f"dd.par.{i}", float(i))
                          for i in range(55)])
        assert (res.flushed, res.dropped) == (55, 0)
        assert len(srv.captured) == 6  # ceil(55/10) bodies
        sink.close()
    _same_requests(captures, _gunzip_json)


def test_datadog_unreachable_drops_with_accounting():
    """A refused connection is a transport error for the port's client
    as for `requests`: the chunk is dropped and counted."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for pkg in PKGS:
        mod = _sink_module(pkg, "datadog")
        sink = mod.DatadogMetricSink(_spec(
            pkg, "datadog", api_key="k", flush_retries=0,
            api_hostname=f"http://127.0.0.1:{port}"))
        res = sink.flush([im(pkg, "dd.down", 1.0)])
        assert (res.flushed, res.dropped) == (0, 1)
        sink.close()


# -- signalfx ----------------------------------------------------------------

def _sfx_decode(body):
    from veneur_tpu_torch.protocol.gen.signalfxpb import signalfx_pb2 as sfx
    msg = sfx.DataPointUploadMessage()
    msg.ParseFromString(body)
    return [(d.metric, d.timestamp, d.value.doubleValue, d.metricType,
             [(x.key, x.value) for x in d.dimensions])
            for d in msg.datapoints]


def test_signalfx_protobuf_datapoints_and_vary_key_by(captures):
    from veneur_tpu_torch.protocol.gen.signalfxpb import signalfx_pb2 as sfx
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "signalfx")
        sink = mod.SignalFxMetricSink(_spec(
            pkg, "signalfx", api_key="default-key", endpoint_base=_url(srv),
            vary_key_by="customer", per_tag_api_keys={"acme": "acme-key"}))
        res = sink.flush([
            im(pkg, "api.hits", 5, "counter", tags=["customer:acme"]),
            im(pkg, "api.lat", 2.5, "gauge", tags=["region:us"])])
        assert res.flushed == 2
        by_token = {}
        for c in srv.captured:
            assert c["headers"]["Content-Type"] == "application/x-protobuf"
            msg = sfx.DataPointUploadMessage()
            msg.ParseFromString(c["body"])
            by_token[c["headers"]["X-SF-Token"]] = msg
        assert set(by_token) == {"default-key", "acme-key"}
        acme = by_token["acme-key"].datapoints[0]
        assert acme.metric == "api.hits" and acme.metricType == sfx.COUNTER
        assert acme.value.doubleValue == 5.0
        assert acme.timestamp == 1700000000 * 1000
        assert {d.key: d.value for d in acme.dimensions}["customer"] == "acme"
        other = by_token["default-key"].datapoints[0]
        assert other.metricType == sfx.GAUGE
    _same_requests(captures, _sfx_decode)
    # the serialized bytes themselves are equal too
    bodies = {pkg: sorted(c["body"] for c in srv.captured)
              for pkg, srv in captures.items()}
    assert bodies["port"] == bodies["jax"]


def test_signalfx_json_protocol_and_name_prefix_drops(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "signalfx")
        sink = mod.SignalFxMetricSink(_spec(
            pkg, "signalfx", api_key="k", protocol="json",
            metric_name_prefix_drops=["internal."], endpoint_base=_url(srv)))
        res = sink.flush([im(pkg, "api.lat", 2.5, "gauge", tags=["region:us"]),
                          im(pkg, "internal.debug", 1, "counter")])
        assert res.flushed == 1 and res.skipped == 1
        body = json.loads(srv.captured[0]["body"])
        assert body["gauge"][0]["metric"] == "api.lat"
        assert body["gauge"][0]["dimensions"]["region"] == "us"
    _same_requests(captures, json.loads)


def test_signalfx_events(captures):
    from veneur_tpu_torch.protocol.gen.signalfxpb import signalfx_pb2 as sfx

    def decode(body):
        msg = sfx.EventUploadMessage()
        msg.ParseFromString(body)
        return [(e.eventType, e.category, e.timestamp,
                 [(d.key, d.value) for d in e.dimensions],
                 [(p.key, p.value.strValue) for p in e.properties])
                for e in msg.events]

    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "signalfx")
        sink = mod.SignalFxMetricSink(_spec(pkg, "signalfx", api_key="k",
                                            endpoint_base=_url(srv)))
        if pkg == "port":
            ev = tparser.SSFSample(name="deploy", message="ok",
                                   timestamp=1700000000,
                                   tags={tparser.EVENT_IDENTIFIER_KEY: "",
                                         "env": "prod"})
        else:
            from veneur_tpu.protocol import ssf_pb2
            ev = ssf_pb2.SSFSample(name="deploy", message="ok",
                                   timestamp=1700000000,
                                   tags={jparser.EVENT_IDENTIFIER_KEY: "",
                                         "env": "prod"})
        sink.flush_other_samples([ev])
        assert srv.captured[0]["path"] == "/v2/event"
    reqs = _same_requests(captures, decode)
    assert "deploy" in reqs[0][3]


# -- cortex ------------------------------------------------------------------

def test_cortex_remote_write(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "cortex")
        sink = mod.CortexMetricSink(_spec(
            pkg, "cortex", url=_url(srv, "/api/prom/push"),
            headers={"X-Scope-OrgID": "t1"},
            basic_auth={"username": "u", "password": "p"}))
        res = sink.flush([im(pkg, "http.requests.count", 42.0, "counter",
                             tags=["code:200", "bad-label!:x"])])
        assert res.flushed == 1
        cap = srv.captured[0]
        assert cap["headers"]["Content-Encoding"] == "snappy"
        snappy = tsnappy if pkg == "port" else jsnappy
        series = _parse_write_request(snappy.decompress(cap["body"]))
        labels, samples = series[0]
        assert labels["__name__"] == "http_requests_count"
        assert labels["code"] == "200" and labels["bad_label_"] == "x"
        assert samples[0] == (42.0, 1700000000 * 1000)
    reqs = _same_requests(captures,
                          lambda b: repr(_parse_write_request(
                              jsnappy.decompress(b))))
    hdrs = dict(reqs[0][2])
    assert hdrs["X-Scope-OrgID"] == "t1"
    assert hdrs["Authorization"] == "Basic dTpw"
    bodies = {pkg: [c["body"] for c in srv.captured]
              for pkg, srv in captures.items()}
    assert bodies["port"] == bodies["jax"]


def test_cortex_labels_sorted_before_name_and_batches():
    from veneur_tpu.sinks.cortex import encode_write_request as jenc
    from veneur_tpu_torch.sinks.cortex import encode_write_request as tenc
    rng = np.random.default_rng(7)
    for pkg, enc in (("port", tenc), ("jax", jenc)):
        data = enc([im(pkg, "m", 1.0, tags=["Foo:bar"], hostname="")], {})
        labels = _parse_write_request(data)[0][0]
        assert list(labels) == sorted(labels)
        assert labels["Foo"] == "bar" and labels["__name__"] == "m"
    rows = [(f"c.{i}", float(v), [f"k{i % 3}:v{i}", "flag"], t)
            for i, (v, t) in enumerate(zip(rng.normal(0, 1e6, 40),
                                           rng.choice(["counter", "gauge"],
                                                      40)))]
    got = tenc([im("port", n, v, t, tags) for n, v, tags, t in rows],
               {"env": "x"})
    want = jenc([im("jax", n, v, t, tags) for n, v, tags, t in rows],
                {"env": "x"})
    assert got == want


# -- snappy and filtering ----------------------------------------------------

def test_snappy_roundtrip_and_copy_decode():
    rng = np.random.default_rng(3)
    for data in (b"abcdefgh" * 500 + b"tail", b"",
                 rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()):
        enc = tsnappy.compress(data)
        assert enc == jsnappy.compress(data)
        assert tsnappy.decompress(enc) == data
    # hand-built stream with a copy element: "abcd" + copy(off=4, len=4)
    stream = bytes([8]) + bytes([(4 - 1) << 2]) + b"abcd" \
        + bytes([((4 - 4) << 2) | (0 << 5) | 1, 4])
    assert tsnappy.decompress(stream) == b"abcdabcd"


def test_add_tags_not_suppressed_by_prefix_sibling():
    for pkg in PKGS:
        sinks = PKGS[pkg][0]
        spec = sinks.SinkSpec(kind="mock", add_tags={"region": "us"})
        out, _ = sinks.filter_metrics_for_sink(
            spec, False, [im(pkg, tags=["region_id:5"])])
        assert "region:us" in out[0].tags
        out2, _ = sinks.filter_metrics_for_sink(
            spec, False, [im(pkg, tags=["region:eu"])])
        assert out2[0].tags.count("region:eu") == 1
        assert "region:us" not in out2[0].tags


# -- kafka -------------------------------------------------------------------

def test_kafka_encoding_and_producer_injection():
    produced = {}
    for pkg in PKGS:
        mod = _sink_module(pkg, "kafka")
        out = produced[pkg] = []
        for ser in ("json", "protobuf"):
            sink = mod.KafkaMetricSink(
                _spec(pkg, "kafka", metric_topic="t",
                      metric_serializer=ser),
                producer=lambda t, k, v, out=out: out.append((t, k, v)))
            res = sink.flush([im(pkg, "a", 1, "counter", tags=["x:y"]),
                              im(pkg, "b", 2.5, "gauge")])
            assert res.flushed == 2
        rec = json.loads(out[0][2])
        assert rec["Name"] == "a" and rec["Type"] == "counter"
        nosink = mod.KafkaMetricSink(_spec(pkg, "kafka"))
        nosink.start()
        assert nosink.flush([im(pkg)]).dropped == 1
    assert produced["port"] == produced["jax"]


def test_kafka_sink_native_path_end_to_end():
    got = {}
    for pkg in PKGS:
        broker = FakeBroker(n_partitions=3)
        try:
            mod = _sink_module(pkg, "kafka")
            sink = mod.KafkaMetricSink(_spec(
                pkg, "kafka", kafka_brokers=f"127.0.0.1:{broker.port}",
                metric_topic="veneur-metrics", metric_serializer="json"))
            sink.start(None)
            res = sink.flush([im(pkg, f"m{i}", float(i), "counter",
                                 tags=["a:b"], ts=1) for i in range(20)])
            assert (res.flushed, res.dropped) == (20, 0)
            got[pkg] = {pid: sorted(recs)
                        for pid, recs in broker.records.items()}
            assert sum(len(v) for v in got[pkg].values()) == 20
        finally:
            broker.stop()
    assert got["port"] == got["jax"]


# -- kafka wire --------------------------------------------------------------

def test_kafka_wire_known_vectors_match_jax():
    assert tkw.crc32c(b"") == 0
    assert tkw.crc32c(b"123456789") == 0xE3069283
    assert tkw.crc32c(b"\x00" * 32) == 0x8A9136AA
    cases = {b"21": -973932308, b"foobar": -790332482,
             b"a-little-bit-long-string": -985981536,
             b"a-little-bit-longer-string": -1486304829,
             b"lkjh234lh9fiuh90y23oiuhsafujhadof229phr9h19h89h8": -58897971}
    for data, signed in cases.items():
        assert tkw.murmur2(data) == signed & 0xFFFFFFFF
    for n in (0, 1, -1, 5, -5, 127, 128, -128, 300, -300, 2 ** 31):
        buf = tkw._varint(n)
        assert buf == jkw._varint(n)
        assert tkw.read_varint(buf, 0) == (n, len(buf))
    rng = np.random.default_rng(5)
    for _ in range(20):
        data = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        assert tkw.crc32c(data) == jkw.crc32c(data)
        assert tkw.murmur2(data) == jkw.murmur2(data)
        assert tkw.partition_for(data, 7) == jkw.partition_for(data, 7)
    assert (tkw.partition_for(b"", 4)
            == (tkw.murmur2(b"") & 0x7FFFFFFF) % 4)


def test_record_batch_roundtrip_equal_bytes_and_crc():
    msgs = [(b"k1", b"v1"), (None, b"keyless"), (b"", b"empty-key"),
            (b"k2", b"x" * 500)]
    batch = tkw.encode_record_batch(msgs, base_ts_ms=1_700_000_000_000)
    assert batch == jkw.encode_record_batch(msgs,
                                            base_ts_ms=1_700_000_000_000)
    assert tkw.parse_record_batch(batch) == msgs
    bad = bytearray(batch)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tkw.parse_record_batch(bytes(bad))


def test_produce_partitions_retries_and_splits():
    broker = FakeBroker(n_partitions=4)
    try:
        p = tkw.KafkaProducer([f"127.0.0.1:{broker.port}"])
        msgs = [(b"key-%d" % i, b"value-%d" % i) for i in range(100)]
        assert p.produce_batch("metrics", msgs) == 100
        got = [m for pid in broker.records for m in broker.records[pid]]
        assert sorted(got) == sorted(msgs)
        for pid, recs in broker.records.items():
            for key, _ in recs:
                assert tkw.partition_for(key, 4) == pid
        assert len(broker.records) > 1
        p.close()
    finally:
        broker.stop()
    broker = FakeBroker(n_partitions=2, fail_first_produces=1)
    try:
        p = tkw.KafkaProducer([f"127.0.0.1:{broker.port}"])
        assert p.produce_batch("t", [(b"k", b"v")]) == 1
        assert p.errors == 0
        p.close()
    finally:
        broker.stop()
    broker = FakeBroker(n_partitions=1)
    try:
        p = tkw.KafkaProducer([f"127.0.0.1:{broker.port}"],
                              max_batch_bytes=10_000)
        msgs = [(b"k%d" % i, b"v" * 500) for i in range(100)]
        assert p.produce_batch("t", msgs) == 100
        assert broker.produce_requests >= 6
        assert sorted(broker.records[0]) == sorted(msgs)
        p.close()
    finally:
        broker.stop()


def test_partial_failure_does_not_duplicate():
    broker = FakeBroker(n_partitions=2)
    orig = broker._produce
    state = {"first": True}

    def flaky_produce(body):
        resp = orig(body)
        if state["first"]:
            state["first"] = False
            out = bytearray(resp)
            off = 4
            (tlen,) = struct.unpack_from(">h", out, off)
            off += 2 + tlen
            (n_parts,) = struct.unpack_from(">i", out, off)
            off += 4
            for _ in range(n_parts):
                (pid,) = struct.unpack_from(">i", out, off)
                if pid == 1:
                    struct.pack_into(">h", out, off + 4, 6)
                    broker.records.pop(1, None)
                off += 22
            return bytes(out)
        return resp

    broker._produce = flaky_produce
    try:
        p = tkw.KafkaProducer([f"127.0.0.1:{broker.port}"])
        msgs = [(b"key-%d" % i, b"v%d" % i) for i in range(40)]
        by_part = {}
        for k, v in msgs:
            by_part.setdefault(tkw.partition_for(k, 2), []).append((k, v))
        assert p.produce_batch("t", msgs) == 40
        assert sorted(broker.records[0]) == sorted(by_part[0])
        assert sorted(broker.records[1]) == sorted(by_part[1])
        p.close()
    finally:
        broker.stop()


def test_bad_and_unreachable_brokers():
    with pytest.raises(ValueError, match="host:port"):
        tkw.KafkaProducer(["broker-without-port"])
    p = tkw.KafkaProducer(["127.0.0.1:1"])
    assert p.produce_batch("t", [(b"k", b"v")]) == 0 and p.errors == 1
    p.close()


# -- newrelic ----------------------------------------------------------------

def test_newrelic_metric_payload(captures):
    for pkg, srv in captures.items():
        mod = _sink_module(pkg, "newrelic")
        sink = mod.NewRelicMetricSink(_spec(
            pkg, "newrelic", account_insert_key="ik", tags=["team:x", "y"],
            metric_url=_url(srv, "/metric/v1")))
        sink.interval_s = 10.0
        assert sink.flush([im(pkg, "c", 30, "counter", tags=["a:b"]),
                           im(pkg, "g", 1.5)]).flushed == 2
        cap = srv.captured[0]
        assert cap["headers"]["Api-Key"] == "ik"
        batch = json.loads(cap["body"])[0]
        assert batch["metrics"][0]["type"] == "count"
        assert batch["metrics"][0]["interval.ms"] == 10_000
        assert batch["common"]["attributes"] == {"team": "x", "y": "true"}
    _same_requests(captures, json.loads)


# -- aws ---------------------------------------------------------------------

def test_cloudwatch_datum_and_batching():
    calls = {}
    for pkg in PKGS:
        mod = _sink_module(pkg, "cloudwatch")
        out = calls[pkg] = []
        sink = mod.CloudWatchMetricSink(
            _spec(pkg, "cloudwatch", cloudwatch_namespace="ns",
                  cloudwatch_standard_unit_tag_name="unit"),
            put_metric_data=lambda ns, data, out=out: out.append(
                (ns, data)))
        sink.interval_s = 10.0
        ms = [im(pkg, "lat", 5.0, "gauge", tags=["unit:Milliseconds",
                                                 "az:a"]),
              im(pkg, "hits", 100.0, "counter")]
        ms += [im(pkg, f"bulk.{i}", float(i)) for i in range(1200)]
        res = sink.flush(ms)
        assert res.flushed == 1202
        assert [len(d) for _, d in out] == [1000, 202]
        ns, data = out[0]
        assert ns == "ns" and data[0]["Unit"] == "Milliseconds"
        assert data[0]["Dimensions"] == [{"Name": "az", "Value": "a"}]
        assert data[1]["Value"] == 10.0 and data[1]["Unit"] == "Count/Second"
    assert calls["port"] == calls["jax"]


def test_s3_tsv_object():
    puts = {}
    for pkg in PKGS:
        mod = _sink_module(pkg, "s3")
        out = puts[pkg] = []
        sink = mod.S3MetricSink(
            _spec(pkg, "s3", aws_s3_bucket="b", compress=True),
            put_object=lambda b, k, body, out=out: out.append((b, k, body)))
        sink.hostname, sink.interval_s = "h1", 10.0
        assert sink.flush([im(pkg, "x", 20.0, "counter", tags=["a:b"]),
                           im(pkg, "y", 0.1)]).flushed == 2
        bucket, key, body = out[0]
        assert bucket == "b" and key.startswith("veneur/h1/")
        assert key.endswith(".tsv.gz")
        row = gzip.decompress(body).decode().strip().split("\n")[0]
        assert row.split("\t")[0] == "x" and float(row.split("\t")[5]) == 2.0
    dec = {pkg: gzip.decompress(p[0][2]) for pkg, p in puts.items()}
    assert dec["port"] == dec["jax"]
    assert puts["port"][0][1].rsplit("/", 1)[0] == \
        puts["jax"][0][1].rsplit("/", 1)[0]


@pytest.fixture
def sigv4_servers():
    srvs = {}
    for pkg in PKGS:
        srv = HTTPServer(("127.0.0.1", 0), _SigV4Handler)
        srv.captured = []
        srv.secret_key = "test-secret-key"
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        srvs[pkg] = srv
    yield srvs
    for srv in srvs.values():
        srv.shutdown()
        srv.server_close()


def test_s3_sigv4_native_upload(sigv4_servers, monkeypatch):
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    tsvs = {}
    for pkg, srv in sigv4_servers.items():
        mod = _sink_module(pkg, "s3")
        sink = mod.S3MetricSink(_spec(
            pkg, "s3", aws_s3_bucket="metrics-bucket",
            aws_region="us-west-2", aws_access_key_id="AKIATEST",
            aws_secret_access_key=srv.secret_key,
            aws_endpoint=_url(srv)))
        sink.start(None)
        res = sink.flush([im(pkg, "s3.sig", 7.0, "counter", tags=("a:b",))])
        assert (res.flushed, res.dropped) == (1, 0)
        (req,) = srv.captured
        assert req["verified"], "SigV4 signature did not verify"
        assert req["path"].startswith("/metrics-bucket/veneur/")
        assert req["headers"]["content-type"] == "application/octet-stream"
        tsvs[pkg] = gzip.decompress(req["body"]).decode()
        assert "s3.sig" in tsvs[pkg] and "a:b" in tsvs[pkg]
    assert tsvs["port"] == tsvs["jax"]
    keys = {pkg: sorted(k.lower() for k in srv.captured[0]["headers"]
                        if k.lower() not in TRANSPORT_HEADERS)
            for pkg, srv in sigv4_servers.items()}
    assert keys["port"] == keys["jax"]


def test_s3_sigv4_bad_secret_rejected(sigv4_servers):
    for pkg, srv in sigv4_servers.items():
        mod = _sink_module(pkg, "s3")
        sink = mod.S3MetricSink(_spec(
            pkg, "s3", aws_s3_bucket="b", aws_region="us-west-2",
            aws_access_key_id="AKIATEST", aws_secret_access_key="WRONG",
            aws_endpoint=_url(srv)))
        sink.start(None)
        assert sink.flush([im(pkg, "s3.bad", 1.0)]).dropped == 1


def test_cloudwatch_sigv4_native_upload(sigv4_servers, monkeypatch):
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    params = {}
    for pkg, srv in sigv4_servers.items():
        mod = _sink_module(pkg, "cloudwatch")
        sink = mod.CloudWatchMetricSink(_spec(
            pkg, "cloudwatch", cloudwatch_namespace="ns",
            aws_region="eu-west-1", aws_access_key_id="AKIATEST",
            aws_secret_access_key=srv.secret_key, aws_endpoint=_url(srv)))
        sink.start(None)
        res = sink.flush([im(pkg, "cw.sig", 30.0, "counter",
                             tags=("az:a",))])
        assert res.flushed == 1
        (req,) = srv.captured
        assert req["verified"], "SigV4 signature did not verify"
        params[pkg] = dict(urllib.parse.parse_qsl(req["body"].decode()))
        p = params[pkg]
        assert p["Action"] == "PutMetricData" and p["Namespace"] == "ns"
        assert p["MetricData.member.1.MetricName"] == "cw.sig"
        assert p["MetricData.member.1.Dimensions.member.1.Name"] == "az"
        assert float(p["MetricData.member.1.Value"]) == 3.0
        assert p["MetricData.member.1.Unit"] == "Count/Second"
    assert params["port"] == params["jax"]


def test_sigv4_against_published_aws_vector():
    """The documented AWS SigV4 example (General Reference, 'Signature
    Version 4 signing process', IAM ListUsers @ 20150830T123600Z)."""
    import datetime
    creds = tawsauth.Credentials(
        "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
    now = datetime.datetime(2015, 8, 30, 12, 36, 0,
                            tzinfo=datetime.timezone.utc)
    args = ("GET",
            "https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08",
            {"content-type":
             "application/x-www-form-urlencoded; charset=utf-8"},
            b"", creds, "us-east-1", "iam")
    headers = tawsauth.sign_request(*args, now=now,
                                    sign_payload_header=False)
    assert headers["Authorization"] == (
        "AWS4-HMAC-SHA256 "
        "Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request, "
        "SignedHeaders=content-type;host;x-amz-date, "
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06"
        "b5924a6f2b5d7")
    jcreds = jawsauth.Credentials(creds.access_key, creds.secret_key)
    for payload in (False, True):
        assert tawsauth.sign_request(*args, now=now,
                                     sign_payload_header=payload) == \
            jawsauth.sign_request(*args[:4], jcreds, *args[5:], now=now,
                                  sign_payload_header=payload)


# -- prometheus and mock -----------------------------------------------------

def test_prometheus_repeater_udp():
    lines = {}
    for pkg in PKGS:
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(2.0)
        port = recv.getsockname()[1]
        mod = _sink_module(pkg, "prometheus")
        sink = mod.PrometheusMetricSink(PKGS[pkg][0].SinkSpec(
            kind="prometheus",
            config={"repeater_address": f"udp://127.0.0.1:{port}"}))
        ms = [im(pkg, "a.b", 1.5, "gauge", tags=["x:y"]),
              im(pkg, "c", 2, "counter")]
        ms += [im(pkg, f"bulk.{i}", 0.1 * i) for i in range(250)]
        assert sink.flush(ms).flushed == 252
        got = []
        for _ in range(2):      # 200 lines a datagram
            data, _ = recv.recvfrom(65536)
            got += data.decode().strip().split("\n")
        recv.close()
        assert got[0] == "a.b:1.5|g|#x:y" and got[1] == "c:2|c"
        lines[pkg] = got
    assert lines["port"] == lines["jax"]


def test_mock_sink_records():
    from veneur_tpu.sinks.mock import MockMetricSink as JMock
    from veneur_tpu_torch.sinks.mock import MockMetricSink as TMock
    for pkg, cls in (("port", TMock), ("jax", JMock)):
        ms = cls()
        ms.start()
        ms.flush([im(pkg)])
        ms.flush_other_samples(["ev"])
        assert ms.started and len(ms.metrics) == 1
        assert ms.other_samples == ["ev"]
        failing = cls(fail=True)
        assert failing.flush([im(pkg)]).dropped == 1


# -- the standard-library poster ---------------------------------------------

def test_parallel_poster_phase_tracing():
    """Every poster session records connect/TTFB/total per POST: the
    first request opens a connection (connect_ms present), keep-alive
    reuse omits it."""

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"   # keep-alive so reuse happens

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            self.rfile.read(n)
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, fmt, *args):
            pass

    # threaded: a worker's idle keep-alive connection must not hold
    # the accept loop
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/x"

    def post(item, session):
        return session.post(url, data=item).status_code

    try:
        for pkg in PKGS:
            poster = PKGS[pkg][0].ParallelPoster(max_workers=2)
            try:
                assert poster.map(post, [b"one"]) == [200]
                assert poster.map(post, [b"two"]) == [200]
                recs = poster.drain_phase_stats()
                assert len(recs) == 2
                first, second = recs
                assert set(first) == {"total_ms", "ttfb_ms", "connect_ms",
                                      "reused"}
                assert not first["reused"] and first["connect_ms"] > 0
                assert second["reused"] and second["connect_ms"] is None
                for r in recs:
                    assert r["total_ms"] >= r["ttfb_ms"] > 0
                assert poster.drain_phase_stats() == []
                assert len(poster.map(post, [b"a", b"b", b"c"])) == 3
            finally:
                poster.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_session_reconnects_after_a_server_close(captures):
    """A connection the server closed (an HTTP/1.0 answer closes each
    one) is reopened for the next request."""
    srv = captures["port"]
    phases = []
    s = tsinks.HttpSession(on_phases=phases.append)
    for i in range(3):
        r = s.post(_url(srv, f"/p{i}"), data=f"body{i}",
                   headers={"X-T": str(i)})
        assert r.status_code == 200 and r.content == b"{}"
    s.close()
    assert [c["path"] for c in srv.captured] == ["/p0", "/p1", "/p2"]
    assert [c["body"] for c in srv.captured] == [b"body0", b"body1",
                                                 b"body2"]
    assert [c["headers"]["X-T"] for c in srv.captured] == ["0", "1", "2"]
    assert [p["reused"] for p in phases] == [False, False, False]
