"""The port's flush slice held against the JAX package end to end: a
`veneur_tpu` Server and a `veneur_tpu_torch` Server(device="cpu") fed
the same DogStatsD lines and the same forwarded metrics must emit the
same InterMetrics (name, tags, type), with

  * counters, gauges, sets and the count/sum/min/max/avg/hmean
    aggregates exact (both sides compute them from the same float64
    host accumulators);
  * percentiles and medians bitwise on integer-valued samples, and
    within 1e-6 relative on float samples (the summation order of the
    weighted prefix sums);
  * forwarded digests of equal total weight and with quantiles within
    the t-digest tolerance (compress may place one cluster boundary
    differently, see test_torch_tdigest.py), forwarded sets
    byte-identical.

Also here: a real-UDP drive of the port server, the restore of a JAX
checkpoint, the import hygiene of the port (in a subprocess, because
this test process imports JAX), and the refusal to run without CUDA
unless asked for the CPU.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from veneur_tpu import config as jconfig
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import sorted_eval as se
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "median", "hmean"]
DIGEST_Q = np.asarray([0.1, 0.5, 0.9], np.float32)


def _lines(rng, integer: bool) -> list[bytes]:
    """One interval of DogStatsD traffic over every family and scope."""
    def v(x):
        return b"%d" % int(x) if integer else b"%.4f" % x

    out = []
    for i in range(6):
        kind = b"h" if i % 2 == 0 else b"ms"
        n = int(rng.integers(1, 300))
        scope = (b"", b",veneurlocalonly", b",veneurglobalonly")[i % 3]
        for x in rng.gamma(2.0, 30.0, n):
            out.append(b"t.lat%d:%s|%s|#svc:a%s" % (i, v(x), kind, scope))
    # sampled histogram: weight 2 makes the interval non-uniform (B1)
    out += [b"t.sampled:%s|h|@0.5" % v(x) for x in rng.gamma(2.0, 9.0, 40)]
    out += [b"t.hits:%d|c|#route:r%d" % (rng.integers(1, 9), i % 3)
            for i in range(50)]
    out += [b"t.hits:3|c|@0.25|#route:r9"] * 4
    out += [b"t.gbytes:%d|c|#veneurglobalonly" % i for i in range(20)]
    out += [b"t.temp:%d|g" % i for i in range(5)]
    out += [b"t.gtemp:%d|g|#veneurglobalonly" % i for i in range(5)]
    out += [b"t.users:u%d|s" % rng.integers(0, 400) for _ in range(500)]
    out += [b"t.lusers:u%d|s|#veneurlocalonly" % i for i in range(30)]
    out.append(b"_sc|t.check|1|h:box|m:degraded")
    out.append(b"_e{5,4}:title|text|#t:1")
    return out


def _uniform_lines(rng) -> list[bytes]:
    """All-weight-1 histogram traffic: the local flush takes B3."""
    return [b"t.u%d:%d|h" % (i % 5, x)
            for i, x in enumerate(rng.integers(0, 10_000, 700))]


def _forward_fields(rng, integer: bool) -> list[dict]:
    """Forwarded metrics as a global tier imports them."""
    from veneur_tpu.sketches import hll as jhll
    out = []
    for i in range(5):
        n = int(rng.integers(1, 120))
        means = np.sort(rng.gamma(2.0, 20.0, n))
        if integer:
            means = np.floor(means)
        w = rng.integers(1, 30, n).astype(np.float64)
        out.append(dict(
            name=f"t.fwd{i}", tags=["az:a"],
            kind="histogram" if i % 2 == 0 else "timer",
            scope=(0, 2)[i % 2], digest_means=means.tolist(),
            digest_weights=w.tolist(), digest_min=float(means[0]),
            digest_max=float(means[-1]),
            digest_sum=float((means * w).sum()),
            digest_rsum=float((w / np.maximum(means, 1.0)).sum()),
            digest_compression=100.0))
    out.append(dict(name="t.fcount", tags=["x:1"], kind="counter",
                    scope=2, counter_value=41))
    out.append(dict(name="t.fgauge", tags=[], kind="gauge", scope=2,
                    gauge_value=2.5))
    sk = jhll.HLLSketch()
    sk.insert_batch([b"m%d" % i for i in range(300)])
    out.append(dict(name="t.users", tags=[], kind="set", scope=0,
                    hll=sk.marshal()))
    return out


def _by_key(metrics):
    out = {}
    for m in metrics:
        key = (m.name, tuple(m.tags), m.type)
        assert key not in out, key
        out[key] = m.value
    return out


def _assert_same_metrics(got, want, integer: bool):
    got = {k: v for k, v in _by_key(got).items() if k[0].startswith("t.")}
    want = {k: v for k, v in _by_key(want).items() if k[0].startswith("t.")}
    assert set(got) == set(want)
    assert got, "no metrics emitted"
    for key, w in want.items():
        g = got[key]
        name = key[0]
        quantile = name.endswith(("percentile", ".median"))
        if quantile and not integer:
            assert g == pytest.approx(w, rel=1e-6, abs=1e-9), key
        else:
            assert g == w or (np.isnan(g) and np.isnan(w)), (key, g, w)


def _assert_same_forwards(got, want):
    assert sorted((f.name, f.kind) for f in got) == \
        sorted((f.name, f.kind) for f in want)
    jby = {(f.name, f.kind): f for f in want}
    for f in got:
        j = jby[(f.name, f.kind)]
        assert (f.tags, int(f.scope)) == (j.tags, int(j.scope))
        if f.kind == "counter":
            assert f.counter_value == j.counter_value
        elif f.kind == "gauge":
            assert f.gauge_value == j.gauge_value
        elif f.kind == "set":
            assert f.hll == j.hll
        else:
            assert (f.digest_min, f.digest_max, f.digest_sum,
                    f.digest_rsum) == (j.digest_min, j.digest_max,
                                       j.digest_sum, j.digest_rsum)
            assert len(f.digest_means) <= 160
            assert sum(f.digest_weights) == sum(j.digest_weights)
            assert np.dot(f.digest_means, f.digest_weights) == pytest.approx(
                np.dot(j.digest_means, j.digest_weights), rel=1e-6)
            span = j.digest_max - j.digest_min
            qa = _midpoint(f.digest_means, f.digest_weights)
            qb = _midpoint(j.digest_means, j.digest_weights)
            assert np.all(np.abs(qa - qb) <= 0.01 * span + 1e-6), f.name


def _midpoint(means, weights):
    """Weighted midpoint quantiles of one digest (float64 numpy)."""
    m, w = np.asarray(means, np.float64), np.asarray(weights, np.float64)
    cum = np.cumsum(w)
    cmid = cum - w / 2
    return np.interp(DIGEST_Q * cum[-1], cmid, m)


class _Pair:
    """A JAX server and a port server, booted alike."""

    def __init__(self, local: bool, **cfg):
        common = dict(percentiles=PCTS, aggregates=AGGS, hostname="box",
                      interval=3600.0, **cfg)
        if local:
            common["forward_address"] = "in-process"
        self.jfwd, self.tfwd = [], []
        self.jsink = jsimple.ChannelMetricSink()
        self.tsink = tsimple.ChannelMetricSink()
        self.jsrv = JServer(jconfig.Config(native_ingest=False, **common),
                            extra_metric_sinks=[self.jsink],
                            forwarder=self.jfwd.extend if local else None)
        self.tsrv = Server(tconfig.Config(**common),
                           extra_metric_sinks=[self.tsink],
                           forwarder=self.tfwd.extend if local else None,
                           device="cpu")
        self.jsrv.start()

    def feed(self, lines, forwards=()):
        for i in range(0, len(lines), 20):
            buf = b"\n".join(lines[i:i + 20])
            self.jsrv.process_packet_buffer(buf)
            self.tsrv.process_packet_buffer(buf)
        for f in forwards:
            self.jsrv.aggregator.import_metric(jsm.ForwardMetric(**f))
            self.tsrv.aggregator.import_metric(tsm.ForwardMetric(**f))

    def flush(self):
        self.jsrv.flush()
        self.jsrv.egress.settle(timeout_s=10.0)
        deadline = time.time() + 10.0
        while (self.jsrv._forward_slots._value
               != self.jsrv.FORWARD_MAX_IN_FLIGHT):
            assert time.time() < deadline, "JAX forward never landed"
            time.sleep(0.01)
        self.tsrv.flush()
        assert self.tsrv.egress.settle(timeout_s=10.0)
        assert self.tsrv.wait_forwards(10.0), "port forward never landed"
        jm = [m for batch in _drain(self.jsink) for m in batch]
        tm = [m for batch in _drain(self.tsink) for m in batch]
        return jm, tm

    def close(self):
        self.jsrv.shutdown()
        self.tsrv.shutdown()


def _drain(sink):
    out = []
    while not sink.queue.empty():
        out.append(sink.queue.get())
    return out


@pytest.mark.parametrize("integer", [True, False])
def test_global_tier_emits_what_jax_emits(integer):
    rng = np.random.default_rng(10 + integer)
    pair = _Pair(local=False)
    try:
        se.reset_launches()
        pair.feed(_lines(rng, integer), _forward_fields(rng, integer))
        jm, tm = pair.flush()
        _assert_same_metrics(tm, jm, integer)
        assert len(pair.tsink.other_samples) == 1        # the event
    finally:
        pair.close()


@pytest.mark.parametrize("integer", [True, False])
def test_local_tier_emits_and_forwards_what_jax_does(integer):
    rng = np.random.default_rng(20 + integer)
    pair = _Pair(local=True)
    try:
        pair.feed(_lines(rng, integer))
        jm, tm = pair.flush()
        _assert_same_metrics(tm, jm, integer)
        assert pair.tfwd and pair.jfwd
        _assert_same_forwards(pair.tfwd, pair.jfwd)
    finally:
        pair.close()


def test_uniform_local_interval_then_global_import():
    """An all-weight-1 local interval (the depth-vector program, B3)
    whose forwards then merge at a global tier (B1), on both sides."""
    rng = np.random.default_rng(30)
    local = _Pair(local=True)
    glob = _Pair(local=False)
    try:
        local.feed(_uniform_lines(rng))
        jm, tm = local.flush()
        _assert_same_metrics(tm, jm, integer=True)
        _assert_same_forwards(local.tfwd, local.jfwd)
        # each side's global imports its own local's forwards
        for f in local.jfwd:
            glob.jsrv.aggregator.import_metric(f)
        for f in local.tfwd:
            glob.tsrv.aggregator.import_metric(f)
        jm, tm = glob.flush()
        got, want = _by_key(tm), _by_key(jm)
        assert set(got) == set(want)
        for key, w in want.items():
            if key[0].endswith("percentile"):
                # each side evaluates its own compressed digests
                assert got[key] == pytest.approx(w, rel=0.02), key
            else:
                assert got[key] == w, key
    finally:
        local.close()
        glob.close()


def test_hot_key_pre_reduction_matches_jax():
    """A key deeper than DENSE_DEPTH_CAP pre-reduces into weighted
    centroids (compress) before the flush: exact count/sum/min/max on
    both sides, percentiles within the t-digest tolerance."""
    rng = np.random.default_rng(50)
    pair = _Pair(local=False)
    try:
        hot = [b"t.hot:%d|h" % x for x in rng.integers(0, 5000, 1500)]
        cold = [b"t.cold:%d|h" % x for x in rng.integers(0, 50, 30)]
        pair.feed(hot + cold)
        pair.jsrv.aggregator.sync_staged(min_samples=1)
        pair.tsrv.aggregator.sync_staged(min_samples=1)
        jm, tm = pair.flush()
        got, want = _by_key(tm), _by_key(jm)
        assert set(got) == set(want)
        for key, w in want.items():
            if key[0].endswith(("percentile", ".median")):
                assert abs(got[key] - w) <= 0.01 * 5000, key
            else:
                assert got[key] == w, key
    finally:
        pair.close()


def test_flush_routes_uniform_to_b3_and_weighted_to_b1():
    """The port's dispatch: an all-weight-1 interval calls the depth
    variant, any other weight the general program."""
    calls = []
    agg = MetricAggregator(percentiles=PCTS, device="cpu")
    real_u, real_w = agg.flush_fn.depth_variant, agg.flush_fn

    def dv(*a):
        calls.append("B3")
        return real_u(*a)

    def gen(*a):
        calls.append("B1")
        return real_w(*a)

    gen.depth_variant = dv
    agg.flush_fn = gen
    srv = Server(tconfig.Config(percentiles=PCTS), device="cpu")
    srv.aggregator = agg
    srv.process_packet_buffer(b"a:1|h\na:2|h\nb:3|ms")
    srv.flush()
    srv.process_packet_buffer(b"a:1|h|@0.5\na:2|h")
    srv.flush()
    srv.flush()                         # nothing staged: no launch
    assert calls == ["B3", "B1"]


# valid lines of every kind, and the malformed cases the reference's
# parser_test.go rejects
_PARSER_CORPUS = [
    b"a.b.c:1|c", b"a.b.c:1|g", b"a.b.c:1.234|h", b"a.b.c:1.234|d",
    b"a.b.c:1.234|ms", b"a.b.c:foo|s", b"a.b.c:1|c|#z:1,a:2,m",
    b"a.b.c:1|c|@0.1", b"a.b.c:1|c|@0.5|#foo:bar", b"a.b.c:1:2:3|h|#t:v",
    b"a.b.c:1|h|#veneurlocalonly,tag2:quacks",
    b"a.b.c:1|h|#veneurglobalonly,tag2:quacks", b"a:-3|g", b"a:1e3|ms",
    b"foo", b"foo:1", b"foo:1||", b"foo:|c|", b"bad:nan|g|#shell",
    b"bad:-inf|g", b"foo:1|foo|", b"foo:1|c||", b"foo:1|c|foo",
    b"foo:1|c|@-0.1", b"foo:1|c|@1.1", b"foo:1|c|@0.5|@0.2",
    b"foo:1|c|#foo|#bar", b":1|c", b"foo:1_0|c",
    b"_e{3,3}:foo|bar|k:foos|s:test|t:success|p:low|#foo:bar,baz:qux"
    b"|d:1136239445|h:example.com", b"_e{3,3}:foo|bar",
    b"_e{3,15}:foo|foo\\nbar\\nbaz\\n", b"_e{4,3}:foo|bar",
    b"_e{3,4}:foo|bar", b"_e{3,3}:foo|bar|d:abc", b"_e{3,3}:foo|bar|p:baz",
    b"_e{3,3}:foo|bar|t:baz", b"_e{3,3}:foo|bar|t:info|t:info",
    b"_e{3,3}:foo|bar||", b"_e{3,0}:foo||", b"_e{3,3}:foo", b"_e{3,3}",
    b"_sc|foo.bar|0|#foo:bar,qux:dor|d:1136239445|h:example.com",
    b"_sc|foo|0|m:foo\\nbar\\nbaz\\n", b"_sc|foo|1|m:foo",
    b"_sc|foo|0|m:msg|h:host", b"foo.bar|0", b"_sc|foo.bar",
    b"_sc|foo.bar|5", b"_sc|foo.bar|0||", b"_sc|foo.bar|0|d:abc",
]


def _parse(parser_mod, line, extend):
    """(kind, fields) of one line through a package's Parser, or
    ("error", message)."""
    from dataclasses import asdict
    p = parser_mod.Parser(extend)
    try:
        if line.startswith(b"_e{"):
            ev = asdict(p.parse_event(line))
            if b"|d:" not in line:
                ev.pop("timestamp")        # the parse time
            return "event", ev
        if line.startswith(b"_sc"):
            m = p.parse_service_check(line)
            return "check", [m.name, m.type, m.value, m.tags, int(m.scope),
                             m.message, m.hostname, m.digest]
        out = []
        p.parse_metric(line, out.append)
        return "metric", [[m.name, m.type, m.joined_tags, m.digest, m.value,
                           m.sample_rate, m.tags, int(m.scope)]
                          for m in out]
    except parser_mod.ParseError as e:
        return "error", str(e)


@pytest.mark.parametrize("extend", [[], ["env:dev", "region:x"]])
def test_parser_matches_jax_parser(extend):
    """The port's DogStatsD parser (its own copy) accepts, rejects and
    fields every line exactly as the JAX package's does."""
    from veneur_tpu.samplers import parser as jparser
    from veneur_tpu.util import tagging as jtagging
    from veneur_tpu_torch.samplers import parser as tparser
    from veneur_tpu_torch.util import tagging as ttagging
    kinds = set()
    for line in _PARSER_CORPUS:
        got = _parse(tparser, line, ttagging.ExtendTags(extend))
        want = _parse(jparser, line, jtagging.ExtendTags(extend))
        assert got == want, line
        kinds.add(got[0])
    assert kinds == {"metric", "event", "check", "error"}


def test_port_server_over_real_udp():
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                percentiles=PCTS, hostname="box",
                                interval=3600.0),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    try:
        kind, addr = srv.statsd_addrs[0]
        assert kind == "udp"
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"u.c:42|c|#x:y\nu.g:70|g\nu.h:1|h\nu.h:3|h\nu.s:a|s", addr)
        s.close()
        deadline = time.time() + 10.0
        while srv.aggregator.processed < 5:
            assert time.time() < deadline, srv.aggregator.processed
            time.sleep(0.01)
        srv.flush()
        by = {m.name: m for m in sink.queue.get(timeout=5)}
        assert by["u.c"].value == 42.0 and by["u.c"].tags == ["x:y"]
        assert by["u.g"].value == 70.0
        assert by["u.h.count"].value == 2.0
        assert by["u.h.50percentile"].value == 2.0
        assert by["u.s"].value == 1.0
    finally:
        srv.shutdown()


def test_port_server_over_real_tcp():
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                                interval=3600.0),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    try:
        c = socket.create_connection(srv.statsd_addrs[0][1])
        c.sendall(b"tcp.m:7|c\ntcp.m:1|c\n")
        c.close()
        deadline = time.time() + 10.0
        while srv.aggregator.processed < 2:
            assert time.time() < deadline
            time.sleep(0.01)
        srv.flush()
        by = {m.name: m.value for m in sink.queue.get(timeout=5)}
        assert by["tcp.m"] == 8.0
    finally:
        srv.shutdown()


@pytest.mark.parametrize("is_local", [False, True])
def test_restore_of_jax_checkpoint_flushes_identically(is_local):
    rng = np.random.default_rng(40 + is_local)
    kw = dict(percentiles=PCTS,
              aggregates=jsm.parse_aggregates(AGGS), is_local=is_local)
    src, ref = JAggregator(**kw), JAggregator(**kw)
    from veneur_tpu.samplers import parser as jparser
    p = jparser.Parser()

    def feed(lines, fwds):
        for agg in (src, ref):
            for line in lines:
                if line.startswith(b"_e"):
                    continue
                if line.startswith(b"_sc"):
                    agg.process_metric(p.parse_service_check(line))
                else:
                    p.parse_metric(line, agg.process_metric)
            for f in fwds:
                agg.import_metric(jsm.ForwardMetric(**f))

    # one flushed interval first, whose extra keys go untouched in the
    # second, so the cut carries untouched rows too
    feed(_lines(rng, integer=True) + [b"t.once:4|c", b"t.onceh:5|h"], [])
    src.flush(is_local=is_local)
    ref.flush(is_local=is_local)
    feed(_lines(rng, integer=True),
         [] if is_local else _forward_fields(rng, integer=True))
    meta, arrays = src.checkpoint_state()
    assert not arrays["counters/key_touched"].all()
    assert not arrays["digests/key_touched"].all()
    port = MetricAggregator(percentiles=PCTS,
                            aggregates=tsm.parse_aggregates(AGGS),
                            is_local=is_local, device="cpu")
    port.restore_state(meta, arrays)
    now = 1_700_000_000
    want = ref.flush(is_local=is_local, now=now)
    got = port.flush(is_local=is_local, now=now)
    _assert_same_metrics(list(got.metrics), list(want.metrics),
                         integer=True)
    if is_local:
        _assert_same_forwards(got.forward, want.forward)
    # and the port's own cut restores into a fresh port aggregator
    again = MetricAggregator(percentiles=PCTS, device="cpu",
                             is_local=is_local)
    again.restore_state(*port.checkpoint_state())


@pytest.mark.parametrize("is_local", [False, True])
def test_unique_timeseries_count_matches_jax(is_local):
    """count_unique_timeseries: the same series sampled into the
    interval's HLL on both sides (worker.go:301-345 scope rules), the
    same estimate in the FlushResult; metrics fed through
    process_batch."""
    rng = np.random.default_rng(60 + is_local)
    from veneur_tpu.samplers import parser as jparser
    from veneur_tpu_torch.samplers import parser as tparser
    jm, tm = [], []
    jp, tp = jparser.Parser(), tparser.Parser()
    for line in _lines(rng, integer=True):
        if line.startswith((b"_e", b"_sc")):
            continue
        jp.parse_metric(line, jm.append)
        tp.parse_metric(line, tm.append)
    ja = JAggregator(percentiles=PCTS, count_unique_timeseries=True,
                     is_local=is_local)
    ta = MetricAggregator(percentiles=PCTS, count_unique_timeseries=True,
                          is_local=is_local, device="cpu")
    ja.process_batch(jm)
    ta.process_batch(tm)
    want = ja.flush(is_local=is_local)
    got = ta.flush(is_local=is_local)
    assert got.unique_ts == want.unique_ts and got.unique_ts > 0
    assert (got.processed, got.imported) == (want.processed, want.imported)


def test_restore_refuses_unported_families():
    """A cut holding the state of a feature still unported (the
    retention tiers, ROADMAP A14) raises before anything restores: alone,
    and beside the cardinality guard's quota ledger, which a port
    aggregator with a guard would restore (neither the arenas nor the
    ledger restore)."""
    tiers = {"retention_tiers": [{"seconds": 60.0, "buckets": 10}]}
    for feature, kw, port_kw in (
            ("retention", {**tiers, "cardinality_key_budget": 100},
             {"cardinality_key_budget": 100}),
            ("retention", tiers, {})):
        src = JAggregator(percentiles=PCTS, **kw)
        src.process_metric(_one_histogram())
        meta, arrays = src.checkpoint_state()
        assert feature in meta
        port = MetricAggregator(percentiles=PCTS, device="cpu", **port_kw)
        with pytest.raises(NotImplementedError, match=feature):
            port.restore_state(meta, arrays)
        assert not port.digests.kdict and not port.compactors.kdict
        if port.cardinality is not None:
            assert "cardinality" in meta
            assert port.cardinality.tenants == {}


def _one_histogram():
    from veneur_tpu.samplers import parser as jparser
    out = []
    jparser.Parser().parse_metric(b"m.h:3|h", out.append)
    return out[0]


@pytest.mark.parametrize("option", [
    {"distributed_coordinator": "127.0.0.1:1"}, {"digest_float64": True},
    {"retention_tiers": [{"step": "1m", "slots": 60}]},
    {"retention_dir": "retention"},
    {"sentry_dsn": "https://k@sentry.example/1"},
    {"retention_max_age": 60.0},
    {"flush_delta_chunk_keys": 4}, {"flush_resident_arenas": True},
    {"grpc_listen_addresses": ["127.0.0.1:0"]}])
def test_config_refuses_options_outside_the_port(option):
    with pytest.raises(NotImplementedError):
        tconfig.Config(**option)


def test_config_has_no_native_ingest_switch():
    """The native ingest switch is served now, on by default as in the
    JAX package, with its tuning options; an option still outside the
    port (device-resident arenas, ROADMAP A12) refuses."""
    assert tconfig.Config().native_ingest is True
    assert jconfig.Config().native_ingest is True
    cfg = tconfig.Config(native_ingest=False, ingest_backend="recvmmsg",
                         ingest_reader_shards=2, intern_gc_threshold=10)
    assert (cfg.native_ingest, cfg.ingest_backend) == (False, "recvmmsg")
    with pytest.raises(NotImplementedError, match="flush_resident_arenas"):
        tconfig.Config(flush_resident_arenas=True)


def test_local_tier_needs_an_in_process_forwarder():
    """A local tier forwards over gRPC without a callable now, with the
    durable spool too; a forward that asks for TLS (ROADMAP A15) is
    still refused, by its key or by its CA."""
    with pytest.raises(NotImplementedError, match="TLS"):
        Server(tconfig.Config(forward_address="127.0.0.1:8128",
                              tls_authority_certificate="ca.pem"),
               device="cpu")
    with pytest.raises(NotImplementedError, match="TLS"):
        Server(tconfig.Config(forward_address="127.0.0.1:8128",
                              tls_certificate="cert.pem"), device="cpu")


def test_entry_points_refuse_cpu_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(tconfig.Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        MetricAggregator()
    from veneur_tpu_torch.core.arena import DigestArena
    from veneur_tpu_torch.parallel.serving import make_serving_flush
    with pytest.raises(RuntimeError, match="CUDA"):
        DigestArena()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_flush()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import the port, boot a server, ingest and flush on the CPU (a
    t-digest and a moments histogram), then boot a server with cubes and
    the query plane and serve one /query over HTTP, then a meshed server
    on two logical CPU devices, import every kernel module and run the
    three profiling entry points at a tiny shape, then forward from a
    port local to a port global over gRPC, then read a YAML config and
    validate it through the command line, then boot a proxy that routes
    one batch to a global and validate a proxy config through its
    command line, then import the egress plane and every metric sink
    module and flush through a routed, tag-excluding lane beside one
    sink of each kind: no jax* and no veneur_tpu
    module (its generated protos included, nor the JAX package's
    scripts) may load, nor requests, urllib3, boto3 or a snappy
    package (checked in a fresh process, since this one already
    imported both)."""
    code = textwrap.dedent("""
        import sys
        import veneur_tpu_torch
        from veneur_tpu_torch.config import Config
        from veneur_tpu_torch.core.server import Server
        from veneur_tpu_torch.sinks.simple import ChannelMetricSink
        sink = ChannelMetricSink()
        srv = Server(Config(percentiles=[0.5, 0.99],
                            sketch_family_rules=[{"match": "m.*"}]),
                     extra_metric_sinks=[sink], device="cpu")
        srv.process_packet_buffer(
            b"a:1|h\\na:2|h|@0.5\\nb:1|c\\nc:x|s\\nm.h:3|h\\nm.h:5|h")
        srv.flush()
        got = {m.name for m in sink.queue.get()}
        assert {"a.50percentile", "m.h.99percentile"} <= got, got
        import json, urllib.request
        from veneur_tpu_torch.http_api import HttpApi
        srv = Server(Config(percentiles=[0.5], query_window_slots=2,
                            cube_dimensions=[["r"]], cube_group_budget=4,
                            sketch_family_rules=[{"match": "m.*"}]),
                     device="cpu")
        srv.process_packet_buffer(b"m.h:3|h|#r:a,e:1\\nm.h:5|h|#r:a,e:2")
        srv.flush()
        api = HttpApi(srv, "127.0.0.1:0")
        api.start()
        with urllib.request.urlopen("http://127.0.0.1:%d/query?name=m.h"
                                    "&group_by=r" % api.address[1]) as r:
            body = json.loads(r.read())
        api.stop()
        assert body["groups"][0]["count"] == 2.0, body
        srv = Server(Config(percentiles=[0.5], mesh_devices=2),
                     extra_metric_sinks=[sink], device="cpu")
        srv.process_packet_buffer(b"a:1|h\\na:2|h\\nb:1|c\\nc:x|s")
        srv.flush()
        got = {m.name for m in sink.queue.get()}
        assert {"a.50percentile", "b", "c"} <= got, got
        import veneur_tpu_torch.ops.hll_estimate
        import veneur_tpu_torch.ops.moments_eval
        import veneur_tpu_torch.ops.quantile_eval
        import veneur_tpu_torch.ops.segmented_reduce
        import veneur_tpu_torch.ops.sort_variants
        from veneur_tpu_torch.scripts import profile_flush_kernel
        from veneur_tpu_torch.scripts import profile_kernel_inloop
        from veneur_tpu_torch.scripts import sort_variants
        for script in (profile_flush_kernel, profile_kernel_inloop,
                       sort_variants):
            script.main(["16", "8", "1", "1"], device="cpu")
        glob = Server(Config(grpc_address="127.0.0.1:0", percentiles=[0.5],
                             interval=3600.0),
                      extra_metric_sinks=[sink], device="cpu")
        glob.start()
        local = Server(Config(forward_address="127.0.0.1:%d"
                              % glob.grpc_import.port, interval=3600.0,
                              forward_timeout=5.0), device="cpu")
        try:
            local.process_packet_buffer(
                b"f.h:1|h\\nf.h:3|h\\nf.c:2|c|#veneurglobalonly")
            local.flush()
            assert local.wait_forwards(10.0)
            stats = local.forwarder.stats()
            assert stats["sent"] == 2, stats
            glob.flush()
            got = {m.name: m.value for m in sink.queue.get(timeout=5)}
            assert got["f.c"] == 2.0, got
            assert got["f.h.50percentile"] == 2.0, got
        finally:
            local.shutdown()
            glob.shutdown()
        import socket, time
        srv = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                            interval=3600.0), extra_metric_sinks=[sink],
                     device="cpu")
        srv.start()
        try:
            assert srv.native is not None
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.sendto(b"n.c:3|c\\nn.h:1|h", srv.statsd_addrs[0][1])
            deadline = time.time() + 10.0
            while srv.native.stats()["packets"] < 1:
                assert time.time() < deadline
                time.sleep(0.01)
                srv._drain_native()
            srv.flush()
            got = {m.name: m.value for m in sink.queue.get(timeout=5)}
            assert got["n.c"] == 3.0, got
        finally:
            srv.shutdown()
        from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
        ml = forward_pb2.MetricList(metrics=[metric_pb2.Metric(
            name="p.c", type=metric_pb2.Counter,
            counter=metric_pb2.CounterValue(value=4))])
        agg = srv.aggregator
        assert agg.import_payload(ml.SerializeToString()) == (1, 0)
        import os, tempfile
        from veneur_tpu_torch.cli import veneur as cli
        from veneur_tpu_torch.config import read_config
        path = os.path.join(tempfile.mkdtemp(), "cli.yaml")
        with open(path, "w") as f:
            f.write("interval: 5s\\nhttp_address: 127.0.0.1:0\\n"
                    "metric_sinks: [{kind: jsonl}]\\n")
        assert read_config(path, environ={}).interval == 5.0
        assert cli.main(["-f", path, "-validate-config"]) == 0
        from veneur_tpu_torch.cli import veneur_proxy
        from veneur_tpu_torch.proxy.proxy import Proxy, ProxyConfig
        glob = Server(Config(grpc_address="127.0.0.1:0", interval=3600.0),
                      device="cpu")
        glob.start()
        proxy = Proxy(ProxyConfig(static_destinations=[
            "127.0.0.1:%d" % glob.grpc_import.port]), device="cpu")
        try:
            proxy.start()
            proxy.handle_metrics_raw(ml.SerializeToString())
            deadline = time.time() + 10.0
            while glob.grpc_import.imported_count < 1:
                assert time.time() < deadline, proxy.stats
                time.sleep(0.01)
            assert proxy.stats["routed"] == 1, proxy.stats
        finally:
            proxy.stop()
            glob.shutdown()
        with open(path, "w") as f:
            f.write("static_destinations: [127.0.0.1:1]\\n")
        assert veneur_proxy.main(["-f", path, "-validate-config"]) == 0
        import veneur_tpu_torch.egress
        from veneur_tpu_torch.protocol.gen.signalfxpb import signalfx_pb2
        from veneur_tpu_torch.sinks import (cloudwatch, cortex, datadog,
                                            kafka, mock, newrelic,
                                            prometheus, s3, signalfx)
        from veneur_tpu_torch.util import awsauth, kafka_wire, snappy
        msink = mock.MockMetricSink()
        srv = Server(Config(
            interval=3600.0, egress_spool_dir=tempfile.mkdtemp(),
            tags_exclude=["n"], enable_metric_sink_routing=True,
            metric_sink_routing=[{"name": "r", "match": [
                {"name": {"kind": "any"}}], "sinks": {"matched": ["mock"]}}],
            # every endpoint on the loopback (routing leaves these
            # sinks nothing to send anyway)
            metric_sinks=[{"kind": k, "name": k, "config": {
                "api_hostname": "http://127.0.0.1:9",
                "url": "http://127.0.0.1:9/push",
                "metric_url": "http://127.0.0.1:9/metric",
                "endpoint_base": "http://127.0.0.1:9",
                "repeater_address": "udp://127.0.0.1:9",
                "aws_endpoint": "http://127.0.0.1:9"}} for k in (
                "cloudwatch", "cortex", "datadog", "kafka", "newrelic",
                "prometheus", "s3", "signalfx")]),
            extra_metric_sinks=[msink], device="cpu")
        srv.start()
        srv.process_packet_buffer(b"e.c:2|c|#n:1,k:v")
        srv.flush()
        assert srv.egress.settle(10.0)
        assert [(m.name, m.tags) for m in msink.metrics] == [
            ("e.c", ["k:v"])], msink.metrics
        srv.shutdown()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "veneur_tpu" or m.startswith("veneur_tpu.")
                     or m == "scripts" or m.startswith("scripts.")
                     or m.split(".")[0] in ("requests", "urllib3", "boto3",
                                            "snappy"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
