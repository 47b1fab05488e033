"""The port's egress plane held against the JAX package's.

The plane cases of tests/test_egress.py through the port (the failpoint
cases driven by sinks that fail instead): async per-sink fan-out off the
flush, bounded retries under per-sink breakers, spool-backed durable
delivery and the ledger closure in `EgressPlane.stats()`.  Then the
parity cases: the spool codec and the spool's segment bytes equal the
JAX package's, an egress spool directory written by either package
replays through the other's lane, central filtering and routing give the
same metrics and counts on seeded columnar batches, and a port server
and a JAX server with the same config deliver the same metrics to every
capture.  Left out until their features are ported: the
`flush.sink.<name>` spans and `/debug/vars` (ROADMAP A16), and the
dry-run report and chaos arm (A18).
"""

import gzip
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from tests.test_sinks import _parse_write_request
from veneur_tpu import config as jconfig
from veneur_tpu import scopedstatsd as jstatsd
from veneur_tpu import sinks as jsinks
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.egress import EgressPlane as JEgressPlane
from veneur_tpu.egress import encode_metrics as jencode
from veneur_tpu.forward import spool as jspool
from veneur_tpu.forward.client import RetryPolicy as JRetryPolicy
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.util import matcher as jmatcher
from veneur_tpu.util import snappy as jsnappy
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import sinks as tsinks
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.egress import (CircuitBreaker, EgressPlane,
                                     decode_metrics, encode_metrics)
from veneur_tpu_torch.forward import spool as tspool
from veneur_tpu_torch.forward.client import RetryPolicy
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks.mock import MockMetricSink
from veneur_tpu_torch.sinks.simple import ChannelMetricSink
from veneur_tpu_torch.util import matcher as tmatcher


class _CapturingStatsd:
    def __init__(self):
        self.counts = []
        self.timings = []

    def count(self, name, value, tags=None, rate=1.0):
        self.counts.append((name, value, tuple(tags or ())))

    def timing(self, name, value, tags=None, rate=1.0):
        self.timings.append((name, value, tuple(tags or ())))

    def gauge(self, name, value, tags=None, rate=1.0):
        pass

    def close(self):
        pass


def _failing_sink_class(sinks):
    class _FailingSink(sinks.BaseMetricSink):
        """Raises on its first `fail_times` flushes (every flush when
        None) and while `down` is set; records the rest."""
        KIND = "failing"

        def __init__(self, fail_times=None, name="failing"):
            super().__init__(name)
            self.fail_times = fail_times
            self.down = False
            self.calls = 0
            self.flushes = []

        def flush(self, metrics):
            self.calls += 1
            if self.down or self.fail_times is None \
                    or self.calls <= self.fail_times:
                raise RuntimeError("backend down")
            self.flushes.append(list(metrics))
            return sinks.MetricFlushResult(flushed=len(metrics))
    return _FailingSink


_FailingSink = _failing_sink_class(tsinks)
_JFailingSink = _failing_sink_class(jsinks)


class _SlowSink(tsinks.BaseMetricSink):
    KIND = "slow"

    def __init__(self, delay_s: float):
        super().__init__("slow")
        self.delay_s = delay_s
        self.flushed = 0

    def flush(self, metrics):
        time.sleep(self.delay_s)
        self.flushed += len(metrics)
        return tsinks.MetricFlushResult(flushed=len(metrics))


def _server(tmp_path=None, extra_sinks=(), **overrides):
    # the port's start() runs the flush ticker (the JAX package's serve()
    # does), so the interval is long: each test flushes by hand
    kw = dict(interval=3600.0, hostname="eg-test",
              egress_max_retries=1, egress_retry_backoff=0.01,
              egress_breaker_threshold=2, egress_breaker_reset=0.1,
              egress_spool_replay_interval=0.02)
    if tmp_path is not None:
        kw["egress_spool_dir"] = str(tmp_path / "egress-spool")
    kw.update(overrides)
    srv = Server(tconfig.Config(**kw), extra_metric_sinks=list(extra_sinks),
                 device="cpu")
    srv.start()
    return srv


def _ingest(srv, lines):
    for line in lines:
        srv.handle_metric_packet(line)


def _metric_lane(srv, name):
    return next(lane for lane in srv.egress.lanes
                if lane.kind == "metric" and lane.name == name)


def _queued(sink):
    out = []
    while not sink.queue.empty():
        out.extend(sink.queue.get())
    return out


def _wait(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


# -- the codec and the breaker ----------------------------------------------

def _seeded_metrics(mod, rng, n=60):
    types = ["counter", "gauge", "status"]
    return [mod.InterMetric(
        name=f"m.{i}.{rng.integers(0, 1 << 30)}",
        timestamp=int(rng.integers(0, 2 ** 40)),
        value=float(rng.normal(0, 10.0 ** rng.integers(-8, 12))),
        tags=[f"k{j}:v{rng.integers(0, 99)}"
              for j in range(int(rng.integers(0, 4)))],
        type=types[i % 3], message="m" * (i % 2),
        hostname=("h" if i % 5 else "")) for i in range(n)]


def test_payload_codec_roundtrip():
    ms = [tsm.InterMetric(name="a.b", timestamp=123, value=4.5,
                          tags=["k:v", "t:u"], type="counter",
                          message="m", hostname="h"),
          tsm.InterMetric(name="c", timestamp=0, value=-1.0, tags=[],
                          type="gauge")]
    assert decode_metrics(encode_metrics(ms)) == ms


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_bytes_equal_the_jax_codec(seed):
    port = _seeded_metrics(tsm, np.random.default_rng(seed))
    jax = _seeded_metrics(jsm, np.random.default_rng(seed))
    body = encode_metrics(port)
    assert body == jencode(jax)
    assert decode_metrics(body) == port
    # a columnar batch's rows (numpy-backed values) encode alike
    tb, jb = _batches(np.random.default_rng(seed))
    assert encode_metrics(list(tb)) == jencode(list(jb))


def test_codec_rejects_unknown_version():
    with pytest.raises(ValueError):
        decode_metrics(json.dumps([99, []]).encode())


def test_breaker_trip_halfopen_probe_and_close():
    from veneur_tpu.egress import CircuitBreaker as JBreaker
    b = CircuitBreaker(threshold=2, reset_s=0.05)
    assert b.admit() and b.state() == "closed"
    assert set(b.snapshot()) == set(JBreaker().snapshot())
    assert not b.record_failure()          # 1 of 2
    assert b.record_failure()              # trips
    assert b.state() == "open"
    assert not b.admit()                   # open: refused
    time.sleep(0.06)
    assert b.admit()                       # half-open probe
    assert b.state() == "half_open"
    assert not b.admit()                   # one probe at a time
    assert b.record_failure()              # probe failed: re-trip,
    assert b.retry_in_s() > 0.05           # longer cooldown (2x)
    time.sleep(0.21)
    assert b.admit()
    assert b.record_success()              # probe delivered: closed
    assert b.state() == "closed"
    assert b.admit()


# -- the plane through a port server ----------------------------------------

def test_flush_returns_without_waiting_on_slow_sink():
    slow = _SlowSink(2.0)
    chan = ChannelMetricSink()
    srv = _server(extra_sinks=[slow, chan])
    try:
        _ingest(srv, [b"eg.fast:3|c"])
        t0 = time.perf_counter()
        srv.flush()
        wall = time.perf_counter() - t0
        assert wall < 1.5, f"flush waited on the slow sink: {wall:.2f}s"
        assert srv.egress.settle(timeout_s=5.0)
        assert any(m.name == "eg.fast" for m in _queued(chan))
        assert slow.flushed > 0
    finally:
        srv.shutdown()


def test_transient_failure_retries_then_delivers():
    sink = _FailingSink(fail_times=1)
    srv = _server(extra_sinks=[sink])
    try:
        _ingest(srv, [b"eg.retry:7|c"])
        srv.flush()
        assert srv.egress.settle(timeout_s=5.0)
        lane = _metric_lane(srv, "failing")
        assert lane.retried == 1 and lane.errors == 1
        assert sink.flushes and any(
            m.name == "eg.retry" for m in sink.flushes[0])
        assert lane.breaker.state() == "closed"
    finally:
        srv.shutdown()


def test_exhausted_retries_without_spool_drop_with_accounting():
    sink = _FailingSink()       # always fails; no egress spool dir
    srv = _server(extra_sinks=[sink])
    try:
        _ingest(srv, [b"eg.doomed:1|c"])
        srv.flush()
        assert srv.egress.settle(timeout_s=5.0)
        lane = _metric_lane(srv, "failing")
        assert lane.dropped_points > 0
        assert lane.breaker.trips >= 1
        eg = srv.egress.stats()
        assert eg["dropped"] > 0 and eg["spilled"] == 0
        assert eg["ledger_closed"]
    finally:
        srv.shutdown()


def test_blackhole_spills_then_replays_on_recovery(tmp_path):
    """Backend down -> retries exhaust -> breaker opens -> spool absorbs
    -> recovery -> replay drains -> exact delivery, ledger closed."""
    sink = _FailingSink(fail_times=0, name="channel")
    sink.down = True
    srv = _server(tmp_path, extra_sinks=[sink])
    lane = _metric_lane(srv, "channel")
    try:
        _ingest(srv, [b"eg.bh:5|c", b"eg.bh2:6|c"])
        srv.flush()
        assert srv.egress.settle(timeout_s=5.0)
        assert sink.calls >= 2                    # both attempts
        assert lane.breaker.trips >= 1
        sp = lane.spool.stats()
        assert sp["spilled_points"] == 2 and sp["pending_records"] == 1
        assert srv.egress.stats()["ledger_closed"]
        sink.down = False                         # recovery
        _wait(lambda: lane.spool.stats()["pending_records"] == 0
              and lane.spool.stats()["replayed"] > 0, "the replay")
        sp = lane.spool.stats()
        assert sp["replayed_points"] == 2 and sp["pending_records"] == 0
        got = {m.name: m.value for fl in sink.flushes for m in fl
               if m.name.startswith("eg.")}
        assert got == {"eg.bh": 5.0, "eg.bh2": 6.0}
        eg = srv.egress.stats()
        assert eg["ledger_closed"] and eg["replayed"] == 2
        assert lane.breaker.state() == "closed"
    finally:
        sink.down = False
        srv.shutdown()


def test_egress_spool_survives_crash_and_replays_on_revive(tmp_path):
    sink = _FailingSink(name="channel")
    srv = _server(tmp_path, extra_sinks=[sink])
    try:
        _ingest(srv, [b"eg.crash:9|c"])
        srv.flush()
        assert srv.egress.settle(timeout_s=5.0)
        assert _metric_lane(srv, "channel").spool.stats()[
            "pending_records"] == 1
    finally:
        srv.crash()     # no drain: the spool keeps its on-disk record
    chan2 = ChannelMetricSink()
    srv2 = _server(tmp_path, extra_sinks=[chan2])
    try:
        got = []

        def delivered():
            got.extend(_queued(chan2))
            return any(m.name == "eg.crash" for m in got)
        _wait(delivered, "the revived replay")
        assert any(m.name == "eg.crash" and m.value == 9.0 for m in got)
        sp = _metric_lane(srv2, "channel").spool.stats()
        assert sp["replayed_points"] == 1 and sp["pending_records"] == 0
        assert sp["recovered_points"] == 1 and sp["spilled_points"] == 0
        assert srv2.egress.stats()["ledger_closed"]
    finally:
        srv2.shutdown()


def test_corrupt_replay_payload_drops_instead_of_wedging(tmp_path):
    from veneur_tpu_torch.forward.spool import (RetryableReplayError,
                                                SpoolRecord)
    srv = _server(tmp_path, extra_sinks=[ChannelMetricSink()])
    try:
        lane = _metric_lane(srv, "channel")
        rec = SpoolRecord(ident=("channel", 1, 1), ts_ms=0, n_metrics=1,
                          trace_id=0, span_id=0, seg_seq=0, offset=0,
                          body_len=7, disk_bytes=7)
        with pytest.raises(Exception) as exc:
            lane._replay_deliver(rec, b"garbage")
        assert not isinstance(exc.value, RetryableReplayError)
        assert lane.breaker.admit()      # probe flag not stranded
    finally:
        srv.shutdown()


def test_queue_full_drops_whole_interval_with_accounting():
    slow = _SlowSink(1.0)
    srv = _server(extra_sinks=[slow], egress_queue_depth=1)
    try:
        stats = _CapturingStatsd()
        srv.statsd = stats
        for i in range(4):
            _ingest(srv, [f"eg.qf{i}:1|c".encode()])
            srv.flush()
        lane = _metric_lane(srv, "slow")
        assert lane.queue_dropped_points > 0
        assert any(n == "egress.queue_full_total"
                   for n, _, _ in stats.counts)
        assert srv.egress.settle(timeout_s=5.0)
        st = srv.egress.stats()
        assert st["queue_dropped"] == lane.queue_dropped_points
    finally:
        srv.shutdown()


def test_sink_error_accounting_and_isolation():
    """A sink whose flush() raises still emits the per-status
    flushed_metrics counts and flush.sink_errors_total, and does not
    poison the other sinks' deliveries."""
    bad = _FailingSink()
    good = MockMetricSink()
    srv = _server(extra_sinks=[bad, good], egress_max_retries=0)
    try:
        stats = _CapturingStatsd()
        srv.statsd = stats
        _ingest(srv, [b"eg.iso:2|c"])
        srv.flush()
        assert srv.egress.settle(timeout_s=5.0)
        assert any(m.name == "eg.iso" for m in good.metrics)
        bad_tags = ("sink_name:failing", "sink_kind:failing")
        statuses = {t for n, _, tags in stats.counts
                    if n == "flushed_metrics"
                    and all(bt in tags for bt in bad_tags)
                    for t in tags if t.startswith("status:")}
        assert statuses == {"status:skipped", "status:max_name_length",
                            "status:max_tags", "status:max_tag_length",
                            "status:flushed"}
        assert [n for n, _, tags in stats.counts
                if n == "flush.sink_errors_total"
                and all(bt in tags for bt in bad_tags)]
        assert any(n == "sink.metric_flush_total_duration_ms"
                   and all(bt in tags for bt in bad_tags)
                   for n, _, tags in stats.timings)
    finally:
        srv.shutdown()


def test_events_reach_every_lane_and_shutdown_drains():
    mock = MockMetricSink()
    srv = _server(extra_sinks=[mock])
    srv.handle_metric_packet(b"_e{5,4}:title|text")
    srv.handle_metric_packet(b"eg.ev:1|c")
    srv.flush()
    srv.shutdown()                         # drains the queued job
    assert len(mock.other_samples) == 1
    assert [m.name for m in mock.metrics] == ["eg.ev"]
    assert srv.egress.stats()["pending"] == 0


# -- the spool across the packages ------------------------------------------

class _FakeTime:
    def __init__(self, real, now):
        self._real, self._now = real, now

    def time(self):
        return self._now

    def __getattr__(self, name):
        return getattr(self._real, name)


def _plane(pkg, d, sink, **kw):
    cls, rp = ((EgressPlane, RetryPolicy) if pkg == "port"
               else (JEgressPlane, JRetryPolicy))
    sinks = tsinks if pkg == "port" else jsinks
    plane = cls(interval_s=10.0, retry=rp(attempts=1, backoff_base_s=0.0),
                breaker_threshold=1, breaker_reset_s=0.05, spool_dir=d,
                spool_replay_interval_s=0.02, **kw)
    plane.add_metric_sink(sinks.SinkSpec(kind="failing", name=sink.name()),
                          sink)
    plane.start()
    return plane


def _spill(pkg, d, metrics):
    sink = (_FailingSink if pkg == "port" else _JFailingSink)()
    plane = _plane(pkg, d, sink)
    plane.submit_interval(metrics, [], jstatsd.ensure(None), 3)
    assert plane.settle(timeout_s=5.0)
    assert plane.stats()["pending"] == 1
    plane.close(drain=True)


def test_spool_segments_equal_the_jax_planes(tmp_path, monkeypatch):
    monkeypatch.setattr(tspool, "time", _FakeTime(tspool.time, 1.7e9))
    monkeypatch.setattr(jspool, "time", _FakeTime(jspool.time, 1.7e9))
    rng = np.random.default_rng(4)
    tb, jb = _batches(rng)
    _spill("port", str(tmp_path / "p"), tb)
    _spill("jax", str(tmp_path / "j"), jb)
    for sub in ("p", "j"):
        assert os.listdir(tmp_path / sub) == ["0-failing"]
    segs = sorted(os.listdir(tmp_path / "p" / "0-failing"))
    assert segs == sorted(os.listdir(tmp_path / "j" / "0-failing"))
    assert segs
    for seg in segs:
        assert ((tmp_path / "p" / "0-failing" / seg).read_bytes()
                == (tmp_path / "j" / "0-failing" / seg).read_bytes())


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_egress_spool_replays_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(11)
    tb, jb = _batches(rng)
    d = str(tmp_path / "spool")
    _spill(writer, d, tb if writer == "port" else jb)
    sink = (_FailingSink if reader == "port" else _JFailingSink)(
        fail_times=0)
    plane = _plane(reader, d, sink)
    try:
        lane = plane.lanes[0]
        _wait(lambda: lane.spool.stats()["pending_records"] == 0,
              "the replay")
        st = plane.stats()
        assert st["recovered"] == len(tb) == st["replayed"]
        assert st["ledger_closed"] and st["dropped"] == 0
        got = [_row(m) for fl in sink.flushes for m in fl]
        assert got == [_row(m) for m in tb]
    finally:
        plane.close(drain=True)


# -- filtering and routing ---------------------------------------------------

def _row(m):
    return (m.name, m.timestamp, m.value, list(m.tags), m.type, m.message,
            m.hostname)


def _batches(rng, n_rows=40, routed=False):
    """The same seeded MetricBatch in both packages: two families of
    shared name/tag columns, dense and `sel` segments, optional routing
    allowlists, and loose rows."""
    keys = ["region", "host_env", "nonce", "svc", "team_long_tag_key"]
    state = rng.bit_generator.state
    batches = []
    for mod in (tsm, jsm):
        rng.bit_generator.state = state
        batch = mod.MetricBatch()
        for fam in range(2):
            bases = [f"f{fam}.metric_{i}" + "x" * int(rng.integers(0, 30))
                     for i in range(n_rows)]
            tags = [[f"{keys[k]}:{rng.integers(0, 5)}"
                     + "v" * int(rng.integers(0, 20))
                     for k in sorted(rng.choice(5, int(rng.integers(0, 5)),
                                                replace=False))]
                    for _ in range(n_rows)]
            for si, suffix in enumerate(("", ".max", ".count")):
                sel = (None if si == 0 else
                       np.sort(rng.choice(n_rows, n_rows // 2,
                                          replace=False)))
                n = n_rows if sel is None else len(sel)
                vals = rng.normal(0, 100, n)
                sinks = None
                if routed:
                    sinks = [None if rng.random() < 0.2 else
                             set(rng.choice(["a", "b", "c"],
                                            int(rng.integers(0, 3)),
                                            replace=False).tolist())
                             for _ in range(n)]
                batch.add_segment(mod.MetricSegment(
                    bases, tags, suffix, vals,
                    "counter" if si == 2 else "gauge", 1700000000,
                    sel=sel, sinks=sinks))
        for i in range(8):
            m = mod.InterMetric(
                name=f"loose.{i}" + "y" * int(rng.integers(0, 30)),
                timestamp=1700000000, value=float(rng.normal()),
                tags=[f"{keys[k]}:{k}" for k in range(i % 5)],
                type="status", message="msg", hostname="h")
            if routed and i % 3:
                m.sinks = {"a"} if i % 2 else {"b", "c"}
            batch.append(m)
        batches.append(batch)
    return batches


SPECS = [
    dict(),
    dict(max_name_length=30),
    dict(max_tag_length=12),
    dict(max_tags=2),
    dict(strip_tags=[{"kind": "prefix", "value": "svc:"},
                     {"kind": "regex", "value": "^team.*"}]),
    dict(add_tags={"region": "us", "added": "1"}),
    dict(max_name_length=40, max_tag_length=20, max_tags=3,
         strip_tags=[{"kind": "exact", "value": "svc:1"}],
         add_tags={"zone": "z"}),
]


@pytest.mark.parametrize("spec_kw", SPECS)
@pytest.mark.parametrize("routing", [False, True])
@pytest.mark.parametrize("excluded", [None, {"nonce"}, {"nonce", "region"}])
def test_filter_metrics_for_sink_equals_jax(spec_kw, routing, excluded):
    tb, jb = _batches(np.random.default_rng(21), routed=routing)
    d = {"kind": "datadog", "name": "a", **spec_kw}
    tspec = tsinks.SinkSpec.from_dict(d)
    jspec = jsinks.SinkSpec.from_dict(d)
    tout, tcounts = tsinks.filter_metrics_for_sink(tspec, routing, tb,
                                                   excluded_tags=excluded)
    jout, jcounts = jsinks.filter_metrics_for_sink(jspec, routing, jb,
                                                   excluded_tags=excluded)
    assert tcounts == jcounts
    assert [_row(m) for m in tout] == [_row(m) for m in jout]
    assert len(tout) == tcounts["flushed"]
    # the loose-list path agrees with the columnar one
    lout, lcounts = tsinks.filter_metrics_for_sink(
        tspec, routing, list(tb), excluded_tags=excluded)
    assert lcounts == tcounts
    assert [_row(m) for m in lout] == [_row(m) for m in tout]


def test_apply_routing_gives_the_jax_allowlists():
    rules = [{"name": "r1", "match": [{"name": {"kind": "prefix",
                                                "value": "f0."}}],
              "sinks": {"matched": ["a"], "not_matched": ["b"]}},
             {"name": "r2", "match": [{"name": {"kind": "any"},
                                       "tags": [{"kind": "prefix",
                                                 "value": "region:1"}]}],
              "sinks": {"matched": ["c"], "not_matched": []}}]
    tb, jb = _batches(np.random.default_rng(5))
    tb.apply_routing([tconfig.SinkRoutingConfig.from_dict(r) for r in rules],
                     tmatcher.match)
    jb.apply_routing([jconfig.SinkRoutingConfig.from_dict(r) for r in rules],
                     jmatcher.match)
    assert [seg.sinks for seg in tb.segments] == \
        [seg.sinks for seg in jb.segments]
    assert [m.sinks for m in tb.loose] == [m.sinks for m in jb.loose]
    assert [m.sinks for m in tb] == [m.sinks for m in jb]
    assert any(s == {"a", "c"} for seg in tb.segments for s in seg.sinks)


# -- a port server and a JAX server with one config -------------------------

class _Capture(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        with self.server.lock:
            self.server.captured.append((self.path, body))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


def _serve():
    srv = HTTPServer(("127.0.0.1", 0), _Capture)
    srv.captured, srv.lock = [], threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _series(srv):
    out = []
    for path, body in srv.captured:
        if path.startswith("/api/v1/series"):
            for s in json.loads(gzip.decompress(body))["series"]:
                s["points"] = [[0, p[1]] for p in s["points"]]
                out.append(json.dumps(s, sort_keys=True))
    return sorted(out)


def _write_requests(srv):
    out = []
    for _, body in srv.captured:
        for labels, samples in _parse_write_request(
                jsnappy.decompress(body)):
            out.append((sorted(labels.items()), [v for v, _ in samples]))
    return sorted(out)


def test_port_and_jax_servers_deliver_the_same_metrics():
    rng = np.random.default_rng(8)
    lines = []
    for i in range(40):
        tags = f"nonce:{rng.integers(1 << 20)},host_env:prod,svc:s{i % 4}"
        lines.append(f"rt.c{i}:{rng.integers(1, 50)}|c|#{tags}".encode())
        lines.append(f"gz.g{i}:{rng.integers(-9, 9)}|g|#{tags}".encode())
        lines.append(f"st.s{i % 5}:m{i}|s|#svc:s{i % 3}".encode())
    caps = {pkg: {"dd": _serve(), "cx": _serve()} for pkg in ("port", "jax")}
    servers, chans = {}, {}
    try:
        for pkg in ("port", "jax"):
            cfg = dict(
                hostname="box", interval=3600.0, percentiles=[0.5],
                tags_exclude=["nonce", "host_env|datadog"],
                enable_metric_sink_routing=True,
                metric_sink_routing=[
                    {"name": "rt", "match": [{"name": {"kind": "prefix",
                                                       "value": "rt."}}],
                     "sinks": {"matched": ["datadog", "channel"],
                               "not_matched": ["cortex", "channel"]}}],
                metric_sinks=[
                    {"kind": "datadog", "name": "datadog", "config": {
                        "api_key": "k", "flush_max_per_body": 17,
                        "api_hostname":
                            f"http://127.0.0.1:{caps[pkg]['dd'].server_port}"}},
                    {"kind": "cortex", "name": "cortex", "max_tags": 2,
                     "max_name_length": 10,
                     "strip_tags": [{"kind": "prefix", "value": "svc:s1"}],
                     "config": {"url": f"http://127.0.0.1:"
                                f"{caps[pkg]['cx'].server_port}/push"}}])
            if pkg == "port":
                cfg["metric_sinks"] = [tsinks.SinkSpec.from_dict(s)
                                       for s in cfg["metric_sinks"]]
                chans[pkg] = ChannelMetricSink()
                srv = Server(tconfig.Config(**cfg),
                             extra_metric_sinks=[chans[pkg]], device="cpu")
            else:
                from veneur_tpu.sinks.simple import ChannelMetricSink as JC
                cfg["metric_sinks"] = [jsinks.SinkSpec.from_dict(s)
                                       for s in cfg["metric_sinks"]]
                cfg["metric_sink_routing"] = [
                    jconfig.SinkRoutingConfig.from_dict(r)
                    for r in cfg["metric_sink_routing"]]
                chans[pkg] = JC()
                srv = JServer(jconfig.Config(native_ingest=False, **cfg),
                              extra_metric_sinks=[chans[pkg]])
            srv.start()
            servers[pkg] = srv
            for i in range(0, len(lines), 16):
                srv.process_packet_buffer(b"\n".join(lines[i:i + 16]))
            srv.flush()
            assert srv.egress.settle(timeout_s=20.0)
        for key, read in (("dd", _series), ("cx", _write_requests)):
            got, want = read(caps["port"][key]), read(caps["jax"][key])
            assert got == want and got, key
        dd = _series(caps["port"]["dd"])
        assert not any("nonce" in s or "host_env" in s for s in dd)
        assert all(json.loads(s)["metric"].startswith("rt.") for s in dd)
        cx = _write_requests(caps["port"]["cx"])
        assert not any(k == "nonce" for labels, _ in cx for k, _ in labels)
        assert any(k == "host_env" for labels, _ in cx for k, _ in labels)
        rows = {pkg: sorted((m.name, tuple(m.tags), m.value)
                            for m in _queued(chans[pkg]))
                for pkg in chans}
        assert rows["port"] == rows["jax"] and rows["port"]
        eg = servers["port"].egress.stats()
        assert eg["ledger_closed"] and eg["dropped"] == 0
    finally:
        for srv in servers.values():
            srv.shutdown()
        for pair in caps.values():
            for s in pair.values():
                s.shutdown()
                s.server_close()
