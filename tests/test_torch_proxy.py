"""The port's proxy tier (`veneur_tpu_torch/proxy/`, `discovery/`,
`util/matcher.py`, `cli/veneur_proxy.py` and the query plane's
`merge_*responses`) held against the JAX package on the CPU, over real
loopback gRPC and HTTP (every server binds 127.0.0.1:0 and stops in a
`finally`; every wait polls with a deadline):

  * the consistent-hash ring: owners and `moved_keys` equal the JAX
    ring's over 10,000 keys on rings of 1-8 members, with adds and
    removes; `routing_key` and the tag matchers equal the JAX proxy's on
    a corpus, with and without `ignore_tags`;
  * the bound native router (`ingest.route_metric_list`) gives each
    destination the records, and the chunks, that the port's and the
    JAX proxy's Python routing give it (the JAX engine does not build
    here, so the JAX side is its Python path);
  * the fan-in: two locals through a proxy (the port's, or the JAX
    package's) to two port globals put every key on exactly one global,
    the ring's owner, and the union equals one global that imports both
    locals' forwards; a JAX local through the port proxy to a JAX global
    and a port global emits what the JAX local emits through a JAX
    global alone (integer samples: bitwise, as the mixed fleet's rule);
  * the JAX `test_proxy.py` and `test_reshard.py` cases that need no
    failpoint: the healthcheck, the gated HTTP routes, the buffer bound
    and its drop accounting, an oversized group not starved, a dead
    destination rerouting with no double landing, discovery
    reconciliation, the two-phase reshard record and its handoff, a
    tripped breaker surviving a membership flap; the V2 fall-back when
    the probe is answered UNIMPLEMENTED;
  * the scatter-gather /query: `merge_*responses` equal the JAX codec
    on the same answers, and the port proxy's `handle_query` equals the
    JAX proxy's in front of the same two globals (everything exactly
    but moments quantiles, within 1e-3 of the answer's span: the maxent
    solver in float32, as tests/test_torch_query.py; staleness is read
    off the clock at each fetch and left out);
  * the Consul and Kubernetes discoverers against a local fake HTTP
    endpoint, as the JAX package's read it;
  * ROADMAP C18: 2,000 digests of 152 centroids coalesced into one
    batch are delivered by the port's proxy, which cuts a batch's RPCs
    by bytes, and dropped by the JAX proxy, whose 6.2 MB RPC the peer's
    4 MiB receive limit refuses;
  * the config: `example_proxy.yaml` refuses on its TLS listener (A15)
    and, stripped of it, loads field by field as the JAX loader does;
    the options this package does not serve refuse; the command line.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent import futures as cf

import grpc
import numpy as np
import pytest
import torch
import yaml
from google.protobuf import empty_pb2

from veneur_tpu import config as jconfig
from veneur_tpu import discovery as jdiscovery
from veneur_tpu import ingest as jingest
from veneur_tpu.cli import veneur_proxy as jcli
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import forward_pb2 as jforward_pb2
from veneur_tpu.protocol import metric_pb2 as jmetric_pb2
from veneur_tpu.proxy import connect as jconnect
from veneur_tpu.proxy import consistent as jcons
from veneur_tpu.proxy import proxy as jproxy
from veneur_tpu.query import engine as jengine
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu.util import matcher as jmatcher
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import discovery as tdiscovery
from veneur_tpu_torch import ingest
from veneur_tpu_torch.cli import veneur_proxy as tcli
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward import client as tclient
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.http_api import HttpApi
from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
from veneur_tpu_torch.proxy import connect as tconnect
from veneur_tpu_torch.proxy import consistent as tcons
from veneur_tpu_torch.proxy import proxy as tproxy
from veneur_tpu_torch.proxy.destinations import Destinations
from veneur_tpu_torch.query import engine as tengine
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.util import matcher as tmatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum"]
MOMENTS_RULE = 1e-3
RULES = [{"match": "mom.*", "family": "moments"},
         {"match": "c.*", "family": "compactor"}]
DIMS = [{"tags": ["endpoint"], "match": "cq.*"}]
_TYPE_NAMES = {0: "counter", 1: "gauge", 2: "histogram", 3: "set",
               4: "timer"}


@pytest.fixture(autouse=True)
def _no_jax_engine(monkeypatch):
    """The JAX package's engine fails to build here: its proxy and
    globals take their Python paths without a g++ attempt each."""
    def refuse():
        raise RuntimeError("the JAX engine is not built in these tests")
    monkeypatch.setattr(jingest, "load_library", refuse)


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _tglobal(**kw):
    cfg = dict(grpc_address="127.0.0.1:0", percentiles=PCTS,
               aggregates=AGGS, hostname="g", interval=3600.0)
    cfg.update(kw)
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(**cfg), extra_metric_sinks=[sink],
                 device="cpu")
    srv.start()
    return srv, sink


def _jglobal():
    sink = jsimple.ChannelMetricSink()
    srv = JServer(jconfig.Config(
        grpc_address="127.0.0.1:0", percentiles=PCTS, aggregates=AGGS,
        hostname="g", interval=3600.0, native_ingest=False),
        extra_metric_sinks=[sink])
    srv.start()
    srv.aggregator._native_import = False
    return srv, sink


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.grpc_import.port}"


def _proxy(pkg: str, **cfg):
    cfg.setdefault("discovery_interval", 3600.0)
    if pkg == "jax":
        p = jproxy.Proxy(jproxy.ProxyConfig(**cfg))
    else:
        p = tproxy.Proxy(tproxy.ProxyConfig(**cfg), device="cpu")
    p.start()
    return p


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _counter_pb(name, value=1, tags=()):
    return metric_pb2.Metric(name=name, tags=list(tags),
                             type=metric_pb2.Counter,
                             counter=metric_pb2.CounterValue(value=value))


# ---------------------------------------------------------------------------
# the ring, the routing key, the matchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_ring_owners_and_moved_keys_equal_the_jax_ring(n):
    keys = [f"svc.m{i % 613}histogram" + ",".join(
        f"t{j}:{i % (j + 3)}" for j in range(i % 4)) for i in range(10_000)]
    members = [f"10.0.{n}.{i}:8128" for i in range(n)]
    t, j = tcons.ConsistentHash(members), jcons.ConsistentHash(members)

    def same():
        assert [t.get(k) for k in keys] == [j.get(k) for k in keys]
        assert t.members() == j.members() and len(t) == len(j)

    same()
    for ring in (t, j):
        ring.add("10.1.0.1:8128")
        ring.add(members[0])            # already a member: no change
    same()
    for ring in (t, j):
        ring.remove(members[-1])
        ring.remove("not-a-member:1")
    same()
    grown = members + ["10.1.0.1:8128"]
    assert tcons.moved_keys(members, grown, 2048) == \
        jcons.moved_keys(members, grown, 2048)
    assert tcons.moved_keys(grown, members[1:], 512, "x-") == \
        jcons.moved_keys(grown, members[1:], 512, "x-")
    assert tcons.moved_keys([], members, 10) == (0, 0)
    with pytest.raises(LookupError):
        tcons.ConsistentHash().get("x")


_TAG_CORPUS = [[], ["host:h1"], ["host:h1", "env:p"], ["env:p", "host:h2"],
               ["az:us-east-1a", "hostname:x", "env:dev"], ["h:1"],
               ["host"], ["env:dev", "region:x", "host:a", "host:b"]]
_IGNORES = {"none": [],
            "prefix": [{"kind": "prefix", "value": "host"}],
            "regex_exact": [{"kind": "regex", "value": "^(host|az):"},
                            {"kind": "exact", "value": "env:dev"}]}


@pytest.mark.parametrize("ignore", sorted(_IGNORES))
def test_routing_key_and_matchers_equal_the_jax_proxy(ignore):
    specs = _IGNORES[ignore]
    t = tproxy.Proxy(tproxy.ProxyConfig(ignore_tags=[
        tmatcher.TagMatcher(**s) for s in specs]), device="cpu")
    j = jproxy.Proxy(jproxy.ProxyConfig(ignore_tags=[
        jmatcher.TagMatcher(**s) for s in specs]))
    try:
        for typ in range(5):
            for tags in _TAG_CORPUS:
                body = metric_pb2.Metric(name="a.b", type=typ,
                                         tags=tags).SerializeToString()
                assert t.routing_key(metric_pb2.Metric.FromString(body)) \
                    == j.routing_key(jmetric_pb2.Metric.FromString(body))
                assert t._query_routing_key("a.b", tags, "timer") == \
                    j._query_routing_key("a.b", tags, "timer")
    finally:
        t.stop()
        j.stop()
    cfgs = [{"name": {"kind": "prefix", "value": "a."},
             "tags": [{"kind": "prefix", "value": "host", "unset": True}]},
            {"name": {"kind": "regex", "value": "b$"},
             "tags": [{"kind": "exact", "value": "env:p"}]},
            {}] + [{"tags": [s]} for s in specs]
    for cfg in cfgs:
        tm = [tmatcher.matcher_from_config(cfg)]
        jm = [jmatcher.matcher_from_config(cfg)]
        for name in ("a.b", "a.c", "x.b", "q"):
            for tags in _TAG_CORPUS:
                assert tmatcher.match(tm, name, tags) == \
                    jmatcher.match(jm, name, tags), (cfg, name, tags)
    with pytest.raises(tmatcher.MatcherError):
        tmatcher.TagMatcher(kind="glob")


def _route_corpus(rng, n=500) -> list:
    out = []
    for i in range(n):
        typ = int(rng.integers(0, 5))
        m = metric_pb2.Metric(
            name=f"svc.metric.{i % 97}", type=typ,
            tags=["env:prod", f"shard:{i % 7}", "host:h%d" % (i % 3)][
                : int(rng.integers(0, 4))])
        if typ == 0:
            m.counter.value = i
        elif typ == 1:
            m.gauge.value = float(i)
        elif typ in (2, 4):
            m.histogram.t_digest.compression = 100.0
        out.append(m)
    return out


def test_native_router_routes_as_the_python_paths():
    """Each destination gets, in payload order, the records the port's
    and the JAX proxy's Python routing (routing_key on the ring) give
    it, in chunks of at most chunk_max metrics that parse back to them;
    a payload that is not a MetricList is rejected (None)."""
    members = ["a:1", "b:1", "c:1"]
    ring = tcons.ConsistentHash(members)
    jring = jcons.ConsistentHash(members)
    ms = _route_corpus(np.random.default_rng(3))
    payload = forward_pb2.MetricList(metrics=ms).SerializeToString()
    hashes = np.asarray([h for h, _ in ring._ring], np.uint32)
    didx = np.asarray([members.index(m) for _, m in ring._ring], np.int32)
    routed = ingest.route_metric_list(payload, hashes, didx, len(members),
                                      chunk_max=64)
    t = tproxy.Proxy(tproxy.ProxyConfig(), device="cpu")
    j = jproxy.Proxy(jproxy.ProxyConfig())
    try:
        want_t = {i: [] for i in range(len(members))}
        want_j = {i: [] for i in range(len(members))}
        for m in ms:
            body = m.SerializeToString()
            want_t[members.index(ring.get(t.routing_key(m)))].append(body)
            jm = jmetric_pb2.Metric.FromString(body)
            want_j[members.index(jring.get(j.routing_key(jm)))].append(body)
    finally:
        t.stop()
        j.stop()
    assert want_t == want_j
    assert sum(map(len, want_t.values())) == len(ms)
    for d, (chunks, counts, count) in enumerate(routed):
        got = []
        for ch, n in zip(chunks, counts):
            parsed = forward_pb2.MetricList.FromString(ch).metrics
            assert len(parsed) == n <= 64
            got += [p.SerializeToString() for p in parsed]
        assert got == want_t[d] and count == len(got)
        want_counts = [min(64, count - i) for i in range(0, count, 64)]
        assert counts == want_counts, d
    assert ingest.route_metric_list(b"\x0a\xff", hashes, didx, 3) is None
    assert ingest.route_metric_list(b"", hashes, didx, 3) == \
        [([], [], 0)] * 3


# ---------------------------------------------------------------------------
# the fan-in
# ---------------------------------------------------------------------------

def _fleet_lines(rng, li: int) -> list[bytes]:
    """One local's interval: integer histogram samples (even on local
    0, odd on local 1, so the globals' merges do not depend on which
    local's digest lands first), global-only counters, sets."""
    out = []
    for k in range(40):
        out += [b"fl.h%d:%d|h" % (k, 2 * x + li)
                for x in rng.integers(0, 500, 30)]
    out += [b"fl.c%d:%d|c|#veneurglobalonly" % (k, k + li)
            for k in range(25)]
    out += [b"fl.s%d:m%d|s" % (k % 10, k) for k in range(li, 200, 2)]
    return out


def _routing_key_of(f, ignore=()) -> str:
    tags = [t for t in f.tags if not t.startswith(tuple(ignore))]
    return f"{f.name}{f.kind}{','.join(tags)}"


def _owner_of_metric(name: str) -> str:
    """The routing key of an InterMetric of _fleet_lines' keys."""
    base = name.rsplit(".", 1)[0] if name.startswith("fl.h") else name
    kind = {"fl.h": "histogram", "fl.c": "counter", "fl.s": "set"}
    return base + kind[name[:4]]


def _metrics(sink, timeout=5.0) -> list:
    return sink.queue.get(timeout=timeout)


def _key(ms):
    return sorted((m.name, tuple(m.tags), m.type, m.value) for m in ms)


@pytest.mark.parametrize("proxy_pkg", ["torch", "jax"])
def test_fan_in_puts_every_key_on_its_owner_and_sums_to_one_global(
        proxy_pkg, monkeypatch):
    """Two port locals forward through a proxy to two port globals: each
    key lands on exactly one global, the one the ring names (the same
    partition whichever package's proxy routes), both globals take keys,
    and the two globals' InterMetrics together equal those of one
    global importing both locals' forwarded lists.  The port's proxy
    routes every payload through the native router."""
    routed = []
    route = ingest.route_metric_list

    def counted(payload, *a, **k):
        out = route(payload, *a, **k)
        routed.append(out is not None)
        return out

    monkeypatch.setattr(ingest, "route_metric_list", counted)
    rng = np.random.default_rng(21)
    (g1, s1), (g2, s2) = _tglobal(), _tglobal()
    addrs = [_addr(g1), _addr(g2)]
    proxy = _proxy(proxy_pkg, static_destinations=addrs)
    ref, rsink = _tglobal(grpc_address="")
    locs = []
    try:
        for li in range(2):
            loc = Server(tconfig.Config(
                forward_address=f"127.0.0.1:{proxy.grpc_port}",
                percentiles=PCTS, aggregates=AGGS, hostname=f"l{li}",
                interval=3600.0, forward_timeout=10.0), device="cpu")
            locs.append(loc)
            lines = _fleet_lines(rng, li)
            for i in range(0, len(lines), 25):
                loc.process_packet_buffer(b"\n".join(lines[i:i + 25]))
        res = [loc.flush() for loc in locs]
        assert all(loc.wait_forwards(10.0) for loc in locs)
        fwd = res[0].forward + res[1].forward
        ring = tcons.ConsistentHash(addrs)
        want = [0, 0]
        for f in fwd:
            want[addrs.index(ring.get(_routing_key_of(f)))] += 1
        _wait(lambda: [g1.grpc_import.imported_count,
                       g2.grpc_import.imported_count] == want,
              "the globals' imports")
        assert proxy.stats["received"] == proxy.stats["routed"] == len(fwd)
        assert proxy.stats["dropped"] == proxy.stats["no_destination"] == 0
        if proxy_pkg == "torch":
            assert routed and all(routed)
        got = []
        for gi, (g, s) in enumerate(((g1, s1), (g2, s2))):
            g.flush()
            ms = _metrics(s)
            assert ms, gi
            for m in ms:
                assert ring.get(_owner_of_metric(m.name)) == addrs[gi], m
            got += ms
        ok, bad = ref.aggregator.import_metrics(fwd)
        assert (ok, bad) == (len(fwd), 0)
        ref.flush()
        assert _key(got) == _key(_metrics(rsink))
    finally:
        for loc in locs:
            loc.shutdown()
        proxy.stop()
        for g in (g1, g2, ref):
            g.shutdown()


def _jax_local_interval(address: str, lines) -> None:
    loc = JServer(jconfig.Config(
        forward_address=address, percentiles=PCTS, aggregates=AGGS,
        hostname="jl", interval=3600.0, forward_timeout=10.0,
        native_ingest=False), extra_metric_sinks=[jsimple.ChannelMetricSink()])
    loc.start()
    try:
        for i in range(0, len(lines), 25):
            loc.process_packet_buffer(b"\n".join(lines[i:i + 25]))
        loc.flush()
        _wait(lambda: loc._forward_slots._value
              == loc.FORWARD_MAX_IN_FLIGHT, "the JAX local's forward")
    finally:
        loc.shutdown()


def _drain_jax(srv, sink) -> list:
    srv.flush()
    srv.egress.settle(timeout_s=10.0)
    out = []
    while not sink.queue.empty():
        out += [m for m in sink.queue.get() if m.name.startswith("fl.")]
    return out


def test_jax_local_through_the_port_proxy_to_a_jax_and_a_port_global():
    """The mixed fleet at the proxy hop: a JAX local forwards through the
    port's proxy to a JAX global and a port global; together they emit,
    value for value, what the same JAX local emits through one JAX
    global, each key on the global the ring names."""
    rng = np.random.default_rng(22)
    lines = _fleet_lines(rng, 0)
    jg, jsink = _jglobal()
    try:
        _jax_local_interval(_addr(jg), lines)
        want = _drain_jax(jg, jsink)
    finally:
        jg.shutdown()
    (jg, jsink), (tg, tsink) = _jglobal(), _tglobal()
    addrs = [_addr(jg), _addr(tg)]
    proxy = _proxy("torch", static_destinations=addrs)
    try:
        _jax_local_interval(f"127.0.0.1:{proxy.grpc_port}", lines)
        _wait(lambda: proxy.destinations.totals()["sent"]
              == proxy.stats["routed"] > 0, "the proxy's sends")
        n_fwd = proxy.stats["routed"]
        _wait(lambda: jg.grpc_import.imported_count
              + tg.grpc_import.imported_count == n_fwd, "the imports")
        got_j = _drain_jax(jg, jsink)
        tg.flush()
        got_t = [m for m in _metrics(tsink) if m.name.startswith("fl.")]
        ring = tcons.ConsistentHash(addrs)
        assert got_j and got_t
        for owner, ms in ((addrs[0], got_j), (addrs[1], got_t)):
            for m in ms:
                assert ring.get(_owner_of_metric(m.name)) == owner, m.name
        assert _key(got_j + got_t) == _key(want)
    finally:
        proxy.stop()
        jg.shutdown()
        tg.shutdown()


# ---------------------------------------------------------------------------
# the JAX proxy's and reshard's cases that need no failpoint
# ---------------------------------------------------------------------------

def test_healthcheck_answers_503_at_zero_destinations():
    proxy = _proxy("torch", static_destinations=[])
    g, _ = _tglobal()
    try:
        assert _get(proxy.http_port, "/healthcheck") == (
            503, b"no destinations\n")
        proxy.discoverer.destinations = [_addr(g)]
        proxy.handle_discovery()
        assert _get(proxy.http_port, "/healthcheck") == (200, b"ok\n")
    finally:
        proxy.stop()
        g.shutdown()


@pytest.mark.parametrize("gates", [False, True])
def test_http_routes_gated_as_jax_and_the_a16_routes_404(gates):
    """/version and /builddate always; /config/{json,yaml} (redacted)
    and /debug/vars (the JAX keys but trace_recorded, with the reshard
    record) behind their gates, as the JAX proxy; /debug/trace,
    /debug/spans and /debug/threads answer 404 citing A16."""
    from veneur_tpu_torch.util.build import BUILD_DATE, VERSION
    g, _ = _tglobal()
    kw = dict(static_destinations=[_addr(g)], http_enable_config=gates,
              http_enable_profiling=gates)
    proxy, jp = _proxy("torch", **kw), _proxy("jax", **kw)
    try:
        port = proxy.http_port
        assert _get(port, "/version") == (200, VERSION.encode())
        assert _get(port, "/builddate") == (200, BUILD_DATE.encode())
        for path in ("/debug/trace", "/debug/spans?drain=1",
                     "/debug/threads"):
            code, body = _get(port, path)
            assert code == 404 and b"A16" in body, path
        for path in ("/config/json", "/config/yaml", "/debug/vars"):
            code, body = _get(port, path)
            jcode, _ = _get(jp.http_port, path)
            assert code == jcode == (200 if gates else 404), path
        if not gates:
            return
        cfg = json.loads(_get(port, "/config/json")[1])
        assert cfg == tproxy.redacted_proxy_dict(proxy.cfg)
        assert set(cfg) == set(json.loads(_get(jp.http_port,
                                               "/config/json")[1]))
        assert yaml.safe_load(_get(port, "/config/yaml")[1]) == cfg
        dv = json.loads(_get(port, "/debug/vars")[1])
        jdv = json.loads(_get(jp.http_port, "/debug/vars")[1])
        assert set(dv) == set(jdv) - {"trace_recorded"}
        assert dv["reshard"]["epochs"] == 1
        assert dv["reshard"]["last"]["members_after"] == [_addr(g)]
        assert dv["destinations"] == 1 and dv["breakers"] == {}
        assert set(dv["query"]) == set(jdv["query"])
        assert set(dv["reshard"]["last"]) == set(jdv["reshard"]["last"])
    finally:
        proxy.stop()
        jp.stop()
        g.shutdown()


def _fake_global(v1=None, v2=None):
    """A Forward service with the given raw-bytes handlers; an
    unregistered method answers UNIMPLEMENTED."""
    handlers = {}
    if v1 is not None:
        handlers["SendMetrics"] = grpc.unary_unary_rpc_method_handler(
            v1, request_deserializer=lambda b: b,
            response_serializer=empty_pb2.Empty.SerializeToString)
    if v2 is not None:
        handlers["SendMetricsV2"] = grpc.stream_unary_rpc_method_handler(
            v2, request_deserializer=lambda b: b,
            response_serializer=empty_pb2.Empty.SerializeToString)
    server = grpc.server(cf.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "forwardrpc.Forward", handlers),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


class _Gated:
    """A V1 peer that holds every non-empty batch until `gate` opens and
    counts the metrics it took."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.batches: list[int] = []
        self.lock = threading.Lock()

    def __call__(self, body, context):
        n = len(forward_pb2.MetricList.FromString(body).metrics)
        if n:
            self.entered.set()
            self.gate.wait(30)
            with self.lock:
                self.batches.append(n)
        return empty_pb2.Empty()

    @property
    def taken(self) -> int:
        with self.lock:
            return sum(self.batches)


def test_destination_buffer_bound_and_drop_accounting():
    """The buffer bounds METRICS, in flight included: a wedged peer
    backpressures the producer at ~send_buffer_size, a graceful close
    drains the backlog, and sent + dropped equals what was accepted."""
    peer = _Gated()
    server, address = _fake_global(v1=peer)
    try:
        d = tconnect.Destination(address, send_buffer_size=100)
        assert d.batch_mode
        for i in range(98):
            assert d.send(_counter_pb(f"b{i}"), block_poll_s=0.01) == "ok"

        def produce_more():
            for i in range(30):
                d.send(_counter_pb(f"b{100 + i}"), block_poll_s=0.01)

        t = threading.Thread(target=produce_more)
        t.start()
        t.join(timeout=0.7)
        assert t.is_alive()             # backpressured, not accepted
        assert d._buffered <= 100 + 1
        peer.gate.set()
        t.join(timeout=15)
        assert not t.is_alive()
        _wait(lambda: d.sent == 128, "the backlog")
        d.close()
        assert (d.sent, d.dropped, d._buffered) == (128, 0, 0)
        assert peer.taken == 128
        # a closed destination refuses, and counts it
        assert d.send(_counter_pb("late")) == "dropped"
        assert d.send_many([_counter_pb("l1"), _counter_pb("l2")]) == 2
        assert d.dropped == 3
    finally:
        peer.gate.set()
        server.stop(0)


def test_destination_oversized_group_not_starved():
    server, address = _fake_global(
        v1=lambda body, ctx: empty_pb2.Empty())
    try:
        d = tconnect.Destination(address, send_buffer_size=50)
        big = [_counter_pb(f"o{i}") for i in range(500)]
        assert d.send_many(big, block_poll_s=0.01) == 0
        _wait(lambda: d.sent == 500, "the oversized group")
        d.close()
        assert (d.sent, d.dropped) == (500, 0)
    finally:
        server.stop(0)


def _keys_of(proxy, dest, n, prefix):
    out, i = [], 0
    while len(out) < n:
        name = f"{prefix}{i}"
        if proxy.destinations.get(proxy.routing_key(_counter_pb(name))) \
                is dest:
            out.append(name)
        i += 1
    return out


def _names(srv, sink, prefix) -> set:
    srv.flush()
    return {m.name for m in _metrics(sink) if m.name.startswith(prefix)}


def test_dead_destination_reroutes_to_the_survivor_no_double_landing():
    """A global dies: its destination's next batch fails, the breaker
    (threshold 1) takes it out of the ring and counts the loss; later
    keys all land on the survivor and none on both; the healthcheck
    stays 200 at one destination."""
    (g1, s1), (g2, s2) = _tglobal(), _tglobal()
    a1, a2 = _addr(g1), _addr(g2)
    proxy = _proxy("torch", static_destinations=[a1, a2],
                   breaker_failure_threshold=1, breaker_reset_timeout=60.0)
    try:
        d1 = proxy.destinations.get("victim")     # one of the two
        names = [f"rr1.{i}" for i in range(40)]
        proxy.handle_metrics([_counter_pb(n) for n in names])
        _wait(lambda: proxy.destinations.totals()["sent"] == 40, "phase 1")
        first = (_names(g1, s1, "rr1."), _names(g2, s2, "rr1."))
        assert first[0] | first[1] == set(names)
        assert first[0] and first[1] and not first[0] & first[1]
        victim = d1.address
        (vg, vs), (sg, ss) = ((g1, s1), (g2, s2)) if victim == a1 else \
            ((g2, s2), (g1, s1))
        vg.shutdown()
        doomed = _keys_of(proxy, d1, 1, "rr.sacrifice")[0]
        deadline = time.monotonic() + 20
        while proxy.destinations.size() > 1:
            assert time.monotonic() < deadline, "the victim stayed"
            proxy.handle_metric(_counter_pb(doomed))
            time.sleep(0.05)
        assert proxy.destinations.breaker_stats()[victim]["state"] == "open"
        _wait(lambda: proxy.destinations.totals()["dropped"] >= 1,
              "the victim's loss accounted")
        assert _get(proxy.http_port, "/healthcheck")[0] == 200
        names2 = [f"rr2.{i}" for i in range(40)]
        sent0 = proxy.destinations.totals()["sent"]
        proxy.handle_metrics([_counter_pb(n) for n in names2])
        _wait(lambda: proxy.destinations.totals()["sent"] == sent0 + 40,
              "phase 2")
        assert _names(sg, ss, "rr2.") == set(names2)
        assert proxy.stats["no_destination"] == 0
    finally:
        proxy.stop()
        g1.shutdown()
        g2.shutdown()


def test_discovery_reconciliation_and_close_removal():
    (g1, _), (g2, _) = _tglobal(), _tglobal()
    a1, a2 = _addr(g1), _addr(g2)
    proxy = _proxy("torch", static_destinations=[a1])
    try:
        assert proxy.destinations.size() == 1
        proxy.discoverer.destinations = [a2]
        proxy.handle_discovery()
        assert set(proxy.destinations.stats()) == {a2}
        last = proxy.destinations.reshard_stats()["last"]
        assert (last["added"], last["removed"]) == ([a2], [a1])
        g2.shutdown()
        deadline = time.monotonic() + 20
        while proxy.destinations.size() > 0:
            assert time.monotonic() < deadline, "the closed one stayed"
            proxy.handle_metric(_counter_pb("x"))
            time.sleep(0.05)
        assert _get(proxy.http_port, "/healthcheck")[0] == 503
    finally:
        proxy.stop()
        g1.shutdown()
        g2.shutdown()


def test_set_members_two_phase_record():
    globs = [_tglobal()[0] for _ in range(3)]
    a1, a2, a3 = map(_addr, globs)
    d = Destinations(reshard_sample_keys=512)
    try:
        d.set_members([a1, a2])
        rs = d.reshard_stats()
        assert rs["epochs"] == 1 and rs["last"]["committed"]
        assert rs["last"]["added"] == sorted([a1, a2])
        d.set_members([a1, a2, a3])
        last = d.reshard_stats()["last"]
        assert last["added"] == [a3] and last["removed"] == []
        assert last["members_after"] == sorted([a1, a2, a3])
        moved, sampled = tcons.moved_keys(sorted([a1, a2]),
                                          sorted([a1, a2, a3]), 512)
        assert (last["keys_moved"], last["sample_keys"]) == (moved, sampled)
        assert 0 < moved <= 1.5 * sampled / 2
        assert last["duration_s"] >= 0.0
        d.set_members([a1, a2])
        assert d.reshard_stats()["last"]["removed"] == [a3]
        assert d.size() == 2
        epochs = d.reshard_stats()["epochs"]
        d.set_members([a1, a2])         # an idle poll: no new epoch
        assert d.reshard_stats()["epochs"] == epochs
    finally:
        d.clear()
        for g in globs:
            g.shutdown()


def test_reshard_handoff_reroutes_buffered_metrics():
    """Scale-down with a wedged leaver: the metrics queued behind its
    stalled sender re-route through the new ring (the handoff) instead
    of dying in the close sweep; the survivor takes them, the record
    counts them, and they are not counted dropped."""
    peer = _Gated()
    server, wedged = _fake_global(v1=peer)
    g2, s2 = _tglobal()
    a2 = _addr(g2)
    proxy = _proxy("torch", static_destinations=[wedged, a2],
                   reshard_handoff_timeout=0.2)
    try:
        dest = proxy.destinations._dests[wedged]
        keys = _keys_of(proxy, dest, 6, "ho.k")
        proxy.handle_metric(_counter_pb(keys[0]))
        assert peer.entered.wait(10)    # the sender is in its RPC
        for name in keys[1:]:
            proxy.handle_metric(_counter_pb(name))
        proxy.destinations.set_members([a2])
        rs = proxy.destinations.reshard_stats()
        assert rs["last"]["removed"] == [wedged]
        assert rs["last"]["handoff_metrics"] == len(keys) - 1
        assert rs["handoff_total"] == len(keys) - 1
        assert proxy.stats["rerouted"] == len(keys) - 1
        _wait(lambda: g2.grpc_import.imported_count == len(keys) - 1,
              "the handed-off keys")
        assert _names(g2, s2, "ho.") == set(keys[1:])
        # the in-flight batch counts dropped; the handed-off ones do not
        assert proxy.destinations.totals()["dropped"] <= 1
    finally:
        peer.gate.set()
        proxy.stop()
        server.stop(0)
        g2.shutdown()


def test_tripped_breaker_survives_a_reshard_flap():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{probe.getsockname()[1]}"
    probe.close()
    d = Destinations(dial_timeout_s=0.3, breaker_threshold=1,
                     breaker_reset_s=30.0)
    try:
        d.set_members([dead])           # the dial fails: OPEN
        st = d.breaker_stats()[dead]
        assert st["state"] == "open" and st["trips"] == 1
        d.set_members([])               # flap out: the breaker stays
        assert d.breaker_stats()[dead]["trips"] == 1
        d.set_members([dead])           # flap in while open: no dial
        st = d.breaker_stats()[dead]
        assert st["state"] == "open" and st["trips"] == 1
        assert d.size() == 0
        with d._lock:
            d._breakers[dead].open_until = time.monotonic() - 0.01
        srv, _ = _tglobal(grpc_address=dead)
        try:
            d.set_members([dead])       # the half-open probe restores it
            assert d.size() == 1 and dead not in d.breaker_stats()
        finally:
            srv.shutdown()
    finally:
        d.clear()


def test_v2_fallback_when_the_probe_is_unimplemented():
    """A reference global has no V1 import: the probe answers
    UNIMPLEMENTED, the destination (as the JAX package's) streams over
    SendMetricsV2, and a routed raw payload reaches it whole."""
    got, lock = [], threading.Lock()

    def v2(it, context):
        for body in it:
            with lock:
                got.append(metric_pb2.Metric.FromString(body).name)
        return empty_pb2.Empty()

    server, address = _fake_global(v2=v2)
    proxy = None
    try:
        jd = jconnect.Destination(address)
        assert not jd.batch_mode
        jd.close()
        proxy = _proxy("torch", static_destinations=[address],
                       send_streams=3)
        dest = proxy.destinations._dests[address]
        assert not dest.batch_mode and dest.n_streams == 3
        ms = [_counter_pb(f"v2.{i}") for i in range(300)]
        proxy.handle_metrics_raw(
            forward_pb2.MetricList(metrics=ms).SerializeToString())
        assert proxy.stats["routed"] == 300
        proxy.stop()
        proxy = None
        assert sorted(got) == sorted(m.name for m in ms)
    finally:
        if proxy is not None:
            proxy.stop()
        server.stop(0)


# ---------------------------------------------------------------------------
# the scatter-gather /query
# ---------------------------------------------------------------------------

def _strip_clock(x):
    """An answer without its staleness, read off the clock at each
    fetch."""
    if isinstance(x, dict):
        return {k: _strip_clock(v) for k, v in x.items()
                if k != "staleness_ms"}
    if isinstance(x, list):
        return [_strip_clock(v) for v in x]
    return x


def _assert_same_answer(got, want, where="answer"):
    """Equal, but moments quantiles within MOMENTS_RULE of the entry's
    [min, max] span."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k, w in want.items():
            if k == "quantiles" and want.get("family") == "moments":
                span = want["max"] - want["min"]
                assert set(got[k]) == set(w), where
                for p, v in w.items():
                    assert abs(got[k][p] - v) <= MOMENTS_RULE * span, \
                        (where, p, got[k][p], v)
            else:
                _assert_same_answer(got[k], w, f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_answer(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _query_lines(rng, li: int) -> list[bytes]:
    """Every family and a cube dimension; `q.lat` tagged `env:`."""
    out = [b"q.lat:%d|h|#env:e%d" % (v, li % 2)
           for v in rng.integers(1, 900, 300)]
    out += [b"q.big:%.4f|h" % v for v in rng.gamma(2.0, 20.0, 1500)]
    out += [b"q.big:%d|ms" % v for v in rng.integers(1, 90, 50)]
    out += [b"mom.q:%.4f|h" % v for v in rng.gamma(2.0, 20.0, 400)]
    out += [b"c.q:%.4f|h" % v for v in rng.gamma(2.0, 9.0, 600)]
    for e in range(5):
        out += [b"cq.g:%d|h|#endpoint:e%d,host:l%d" % (v, e, li)
                for v in rng.integers(1, 300, 40 + 10 * e)]
    return out


def _query_servers(n=2):
    """Port servers with the query plane, every family rule and DIMS,
    each fed its own interval (after an empty first cut) and an HttpApi;
    -> [(server, api)]."""
    rng = np.random.default_rng(40)
    out = []
    for i in range(n):
        srv = Server(tconfig.Config(
            percentiles=PCTS, interval=3600.0, hostname=f"q{i}",
            query_window_slots=4, sketch_family_rules=RULES,
            cube_dimensions=DIMS, cube_group_budget=32), device="cpu")
        srv.flush()
        for line in _query_lines(rng, i):
            srv.handle_metric_packet(line)
        srv.flush()
        api = HttpApi(srv, "127.0.0.1:0")
        api.start()
        out.append((srv, api))
    return out


_QUERIES = {
    "tdigest": {"name": ["q.lat"], "tags": ["env:e0"], "q": ["0.5,0.99"]},
    "compressed": {"name": ["q.big"], "q": ["0.1,0.5,0.9"]},
    "moments": {"name": ["mom.q"], "q": ["0.5,0.9"]},
    "compactor": {"name": ["c.q"], "q": ["0.5,0.9"]},
    "group": {"name": ["cq.g"], "group_by": ["endpoint"],
              "q": ["0.5,0.99"], "top": ["3"], "by": ["q99"]},
    "range": {"name": ["q.lat"], "q": ["0.5"], "step": ["60"],
              "since": [repr(time.time() - 120.0)],
              "until": [repr(time.time() + 600.0)]},
}


@pytest.fixture(scope="module")
def query_servers():
    servers = _query_servers()
    yield servers
    for srv, api in servers:
        api.stop()
        srv.shutdown()


@pytest.mark.parametrize("form", sorted(_QUERIES))
def test_merge_responses_equal_the_jax_codec(query_servers, form):
    """Two tiers' answers for the same query, merged by the port's and
    the JAX package's codec: equal but moments quantiles."""
    q = dict(_QUERIES[form])
    answers = []
    for srv, _ in query_servers:
        code, body = srv.query.serve(q)
        assert code == 200, body
        answers.append(body)
    spec = tengine.parse_query_params(q)
    if form == "group":
        got = tengine.merge_group_responses(answers, spec["qs"],
                                            top=spec["top"], by=spec["by"],
                                            device="cpu")
        want = jengine.merge_group_responses(answers, spec["qs"],
                                             top=spec["top"], by=spec["by"])
        assert len(got["groups"]) == 3 and got["groups_total"] == 10
    elif form == "range":
        got = tengine.merge_range_responses(answers, spec["qs"],
                                            device="cpu")
        want = jengine.merge_range_responses(answers, spec["qs"])
        assert got["bins"] >= 1
    else:
        got = tengine.merge_responses(answers, spec["qs"], device="cpu")
        want = jengine.merge_responses(answers, spec["qs"])
        assert got["count"] == sum(a["count"] for a in answers) > 0
    _assert_same_answer(got, want)


def test_handle_query_equals_the_jax_proxy_in_front_of_two_globals():
    """Two port locals forward through the port proxy (ignore_tags
    `host`) to two port globals with the query plane; the port's and the
    JAX package's proxies, configured alike, answer the same /query
    forms: a single key (one hop to its owner, and over both kinds when
    type= is open), each family, the group-by over both globals with
    top=/by=, the range form, payload=0, locals=, and the errors."""
    rng = np.random.default_rng(41)
    kw = dict(percentiles=PCTS, interval=3600.0, query_window_slots=4,
              sketch_family_rules=RULES, cube_dimensions=DIMS,
              cube_group_budget=32)
    globs = [_tglobal(**kw) for _ in range(2)]
    apis = []
    for g, _ in globs:
        g.flush()                       # an empty first cut
        apis.append(HttpApi(g, "127.0.0.1:0"))
        apis[-1].start()
    addrs = [_addr(g) for g, _ in globs]
    cfg = dict(static_destinations=addrs,
               query_destinations={a: f"127.0.0.1:{api.address[1]}"
                                   for a, api in zip(addrs, apis)})
    ignore = [{"kind": "prefix", "value": "host"}]
    tp = _proxy("torch", ignore_tags=[tmatcher.TagMatcher(**t)
                                      for t in ignore], **cfg)
    locs, lapis = [], []
    jp = None
    try:
        for li in range(2):
            loc = Server(tconfig.Config(
                forward_address=f"127.0.0.1:{tp.grpc_port}",
                hostname=f"l{li}", forward_timeout=10.0, **kw),
                device="cpu")
            loc.flush()
            for line in _query_lines(rng, li):
                loc.handle_metric_packet(line)
            locs.append(loc)
        res = [loc.flush() for loc in locs]
        assert all(loc.wait_forwards(10.0) for loc in locs)
        n_fwd = sum(len(r.forward) for r in res)
        _wait(lambda: sum(g.grpc_import.imported_count for g, _ in globs)
              == n_fwd, "the imports")
        for g, _ in globs:
            g.flush()
        for loc in locs:
            lapis.append(HttpApi(loc, "127.0.0.1:0"))
            lapis[-1].start()
        local_addr = f"127.0.0.1:{lapis[0].address[1]}"
        jp = _proxy("jax", ignore_tags=[jmatcher.TagMatcher(**t)
                                        for t in ignore],
                    query_local_addresses=[local_addr], **cfg)
        tp.cfg.query_local_addresses = [local_addr]
        forms = [
            {"name": ["q.lat"], "tags": ["env:e1"], "q": ["0.5,0.99"],
             "type": ["histogram"]},
            {"name": ["q.big"], "q": ["0.1,0.5,0.9"]},
            {"name": ["mom.q"], "q": ["0.5,0.9"], "slots": ["1"]},
            {"name": ["c.q"], "q": ["0.5,0.9"], "payload": ["0"]},
            {"name": ["cq.g"], "group_by": ["endpoint"], "q": ["0.5"],
             "top": ["3"], "by": ["q99"]},
            {"name": ["cq.g"], "group_by": ["endpoint"], "q": ["0.99"],
             "payload": ["0"]},
            {"name": ["q.lat"], "q": ["0.5"], "step": ["60"],
             "since": [repr(time.time() - 120.0)],
             # past at every fetch, so no bin is cut at the clock
             "until": [repr(time.time())], "tags": ["env:e0"]},
            {"name": ["q.lat"], "tags": ["env:e0"], "q": ["0.5"],
             "locals": ["all"]},
            {"name": ["q.lat"], "q": ["0.5"], "locals": ["10.9.9.9:1"]},
            {"name": ["q.lat"], "q": ["2"]},
            {"q": ["0.5"]},
        ]
        codes = []
        for q in forms:
            tcode, tbody = tp.handle_query(dict(q))
            jcode, jbody = jp.handle_query(dict(q))
            assert tcode == jcode, (q, tbody, jbody)
            codes.append(tcode)
            _assert_same_answer(_strip_clock(tbody), _strip_clock(jbody),
                                str(q))
        assert codes == [200] * 8 + [400] * 3
        body = tp.handle_query(dict(forms[4]))[1]
        assert len(body["upstreams"]) == 2 and len(body["groups"]) == 3
        assert tp.query_stats == {"served": 9, "errors": 3,
                                  "upstream_errors": 0}
        code, body = tp.handle_query({"name": ["q.big"], "q": ["0.5"]})
        assert code == 200 and body["count"] == 2 * 1550
        # over HTTP, as the JAX proxy's handler serves it
        code, raw = _get(tp.http_port, "/query?name=mom.q&q=0.5")
        assert code == 200 and json.loads(raw)["family"] == "moments"
        tp.cfg.query_destinations = {}
        assert tp.handle_query(dict(forms[0]))[0] == 502
    finally:
        for api in apis + lapis:
            api.stop()
        for loc in locs:
            loc.shutdown()
        tp.stop()
        if jp is not None:
            jp.stop()
        for g, _ in globs:
            g.shutdown()


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------

class _FakeDirectory:
    """A local HTTP endpoint answering Consul's health API and the
    Kubernetes pod list for the service "veneur-global"."""

    CONSUL = [
        {"Service": {"Address": "10.0.0.1", "Port": 8128}, "Node": {}},
        {"Service": {"Address": "", "Port": 8129},
         "Node": {"Address": "10.0.0.2"}},
        {"Service": {"Address": "10.0.0.3"}, "Node": {}},    # no port
    ]
    PODS = {"items": [
        {"status": {"phase": "Running", "podIP": "10.1.0.1"},
         "spec": {"containers": [{"ports": [
             {"name": "http", "containerPort": 8127},
             {"name": "grpc", "containerPort": 8128}]}]}},
        {"status": {"phase": "Running", "podIP": "10.1.0.2"},
         "spec": {"containers": [{"ports": [
             {"name": "http", "containerPort": 9127}]}]}},
        {"status": {"phase": "Pending", "podIP": "10.1.0.3"},
         "spec": {"containers": [{"ports": [
             {"name": "grpc", "containerPort": 8128}]}]}},
        {"status": {"phase": "Running"}, "spec": {}},
    ]}

    def __init__(self):
        import http.server
        outer = self
        self.paths: list[str] = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                outer.paths.append(self.path)
                if self.path == "/v1/health/service/veneur-global?passing":
                    body = outer.CONSUL
                elif self.path == ("/api/v1/namespaces/default/pods"
                                   "?labelSelector=app%3Dveneur-global"):
                    body = outer.PODS
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                raw = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("kind", ["consul", "kubernetes", "static"])
def test_discoverers_read_what_the_jax_discoverers_read(kind):
    fake = _FakeDirectory()
    try:
        if kind == "consul":
            t = tdiscovery.ConsulDiscoverer(fake.url + "/")
            j = jdiscovery.ConsulDiscoverer(fake.url + "/")
            want = ["10.0.0.1:8128", "10.0.0.2:8129"]
        elif kind == "kubernetes":
            t = tdiscovery.KubernetesDiscoverer(api_url=fake.url)
            j = jdiscovery.KubernetesDiscoverer(api_url=fake.url)
            want = ["10.1.0.1:8128", "10.1.0.2:9127"]
        else:
            t = tdiscovery.StaticDiscoverer(["a:1", "b:2"])
            j = jdiscovery.StaticDiscoverer(["a:1", "b:2"])
            want = ["a:1", "b:2"]
        got = t.get_destinations_for_service("veneur-global")
        assert got == want
        assert got == j.get_destinations_for_service("veneur-global")
        if kind != "static":
            with pytest.raises(urllib.error.HTTPError):
                t.get_destinations_for_service("other")
    finally:
        fake.close()


def test_the_cli_builds_the_discoverer_its_config_names():
    assert tcli.discoverer_from({}) is None
    c = tcli.discoverer_from({"discoverer": "consul",
                              "consul_url": "http://10.9.0.1:8500"})
    assert isinstance(c, tdiscovery.ConsulDiscoverer)
    assert c.base_url == "http://10.9.0.1:8500"
    assert isinstance(tcli.discoverer_from({"discoverer": "kubernetes"}),
                      tdiscovery.KubernetesDiscoverer)


# ---------------------------------------------------------------------------
# ROADMAP C18: a coalesced batch bounded by bytes
# ---------------------------------------------------------------------------

_C18_KEYS, _C18_CENTROIDS = 2000, 152


@pytest.fixture(scope="module")
def c18_bodies():
    """2,000 serialized digests of 152 centroids (centroid_capacity(100),
    a busy key's forward at the default compression), about 3 KB each:
    6.2 MB together, half again gRPC's default 4 MiB receive limit."""
    rng = np.random.default_rng(18)
    means = np.sort(rng.gamma(2.0, 20.0, (_C18_KEYS, _C18_CENTROIDS)), 1)
    wts = rng.integers(1, 9, means.shape).astype(np.float64)
    out = [tconvert.to_pb(tsm.ForwardMetric(
        name=f"c18.k{i}", tags=["svc:api", f"host:h{i % 7}"],
        kind="histogram", scope=0, digest_means=means[i].tolist(),
        digest_weights=wts[i].tolist(), digest_min=float(means[i, 0]),
        digest_max=float(means[i, -1]),
        digest_rsum=float((wts[i] / means[i]).sum()))).SerializeToString()
        for i in range(_C18_KEYS)]
    assert sum(map(len, out)) > 6_000_000
    return out


def _metric_list(bodies) -> bytes:
    return forward_pb2.MetricList(metrics=[
        metric_pb2.Metric.FromString(b) for b in bodies]).SerializeToString()


def _c18_through_a_proxy(pkg: str, inbound: str, bodies):
    """A proxy with ignore_tags (the protobuf path) in front of a V1 peer
    that keeps gRPC's 4 MiB receive limit.  One counter wedges the
    destination's sender in its first RPC; meanwhile the 2,000 digests
    arrive as three V1 groups or as one V2 stream and queue up; then the
    peer opens, and the sender coalesces them into one batch.  -> (the
    metric counts of the batches the peer took, the proxy's totals)."""
    peer = _Gated()
    server, address = _fake_global(v1=peer)
    tag = (jmatcher if pkg == "jax" else tmatcher).TagMatcher(
        kind="prefix", value="host")
    proxy = _proxy(pkg, static_destinations=[address], ignore_tags=[tag],
                   send_buffer_size=4096)
    ch = grpc.insecure_channel(f"127.0.0.1:{proxy.grpc_port}")
    try:
        v1 = ch.unary_unary(tclient.SEND_METRICS,
                            request_serializer=lambda b: b,
                            response_deserializer=empty_pb2.Empty.FromString)
        v1(_metric_list([_counter_pb("c18.wedge").SerializeToString()]),
           timeout=10)
        assert peer.entered.wait(10)
        if inbound == "v1":
            for lo, hi in ((0, 700), (700, 1400), (1400, _C18_KEYS)):
                v1(_metric_list(bodies[lo:hi]), timeout=30)
        else:
            ch.stream_unary(
                tclient.SEND_METRICS_V2, request_serializer=lambda b: b,
                response_deserializer=empty_pb2.Empty.FromString)(
                    iter(bodies), timeout=60)
        assert proxy.stats["received"] == _C18_KEYS + 1
        assert proxy.stats["routed"] == _C18_KEYS + 1
        peer.gate.set()
        totals = proxy.destinations.totals
        _wait(lambda: sum(totals().values()) == _C18_KEYS + 1,
              "the batch's fate", timeout=30)
        return list(peer.batches), totals()
    finally:
        peer.gate.set()
        ch.close()
        proxy.stop()
        server.stop(0)


@pytest.mark.parametrize("inbound", ["v1", "v2"])
def test_c18_port_proxy_delivers_deep_digests(inbound, c18_bodies):
    """The port's sender cuts the coalesced batch into RPCs of at most
    BATCH_BYTES: the peer takes all 2,000 digests in two RPCs after the
    wedge's."""
    batches, totals = _c18_through_a_proxy("torch", inbound, c18_bodies)
    assert totals == {"sent": _C18_KEYS + 1, "dropped": 0}
    assert batches[0] == 1 and sum(batches) == _C18_KEYS + 1
    assert len(batches) >= 3


@pytest.mark.parametrize("inbound", ["v1", "v2"])
def test_c18_jax_proxy_drops_deep_digests(inbound, c18_bodies):
    """The JAX sender cuts the coalesced batch at BATCH_MAX metrics
    alone: one 6.2 MB RPC, which the peer refuses (RESOURCE_EXHAUSTED),
    and the destination drops all 2,000."""
    batches, totals = _c18_through_a_proxy("jax", inbound, c18_bodies)
    assert batches == [1]
    assert totals == {"sent": 1, "dropped": _C18_KEYS}


# ---------------------------------------------------------------------------
# the config, the command line, the boot
# ---------------------------------------------------------------------------

_A15_KEYS = ("grpc_tls_address", "tls_certificate", "tls_key",
             "tls_authority_certificate")


def _example_proxy() -> dict:
    with open(os.path.join(REPO, "example_proxy.yaml")) as f:
        return yaml.safe_load(f)


def test_example_proxy_yaml_refuses_tls_then_matches_jax_once_stripped():
    data = _example_proxy()
    with pytest.raises(NotImplementedError,
                       match=r"grpc_tls_address.*A15"):
        tproxy.proxy_config_from_dict(data)
    for k in _A15_KEYS:
        data.pop(k)
    got = tproxy.proxy_config_from_dict(data)
    want = jproxy.proxy_config_from_dict(data)
    assert [f.name for f in dataclasses.fields(tproxy.ProxyConfig)] == \
        [f.name for f in dataclasses.fields(jproxy.ProxyConfig)]
    for f in dataclasses.fields(jproxy.ProxyConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "ignore_tags":
            g = [dataclasses.asdict(m) for m in g]
            w = [dataclasses.asdict(m) for m in w]
        assert g == w, f.name
    assert got.ignore_tags[0].match("host:a")
    assert got.discovery_interval == 10.0 and got.query_timeout == 2.0
    assert tproxy.redacted_proxy_dict(got) == \
        jproxy.redacted_proxy_dict(want)
    assert dataclasses.asdict(tproxy.ProxyConfig()) == \
        dataclasses.asdict(jproxy.ProxyConfig())


@pytest.mark.parametrize("field,value,item", [
    ("grpc_tls_address", "127.0.0.1:0", "A15"),
    ("tls_certificate", "/etc/p.crt", "A15"),
    ("tls_key", "/etc/p.key", "A15"),
    ("tls_authority_certificate", "/etc/ca.crt", "A15"),
    ("trace_ring_capacity", 64, "A16"),
    ("mesh_fanout", True, "A18"),
])
def test_proxy_config_refuses_options_outside_the_port(field, value, item):
    with pytest.raises(NotImplementedError, match=f"{field}.*{item}"):
        tproxy.ProxyConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=f"{field}.*{item}"):
        tproxy.proxy_config_from_dict({field: value})
    default = getattr(tproxy.ProxyConfig(), field)
    assert getattr(tproxy.proxy_config_from_dict({field: default}),
                   field) == default


def test_proxy_cli_validates_by_loading_and_refuses_sentry(tmp_path,
                                                           capsys):
    """-validate-config runs the loader (the JAX CLI prints "config
    valid" without parsing, so it passes example_proxy.yaml, which the
    port refuses on its TLS listener); a sentry_dsn refuses (A16)."""
    example = os.path.join(REPO, "example_proxy.yaml")
    assert jcli.main(["-f", example, "-validate-config"]) == 0
    capsys.readouterr()
    assert tcli.main(["-f", example, "-validate-config"]) == 1
    assert "grpc_tls_address" in capsys.readouterr().err
    data = _example_proxy()
    for k in _A15_KEYS:
        data.pop(k)
    ok = tmp_path / "ok.yaml"
    ok.write_text(yaml.safe_dump(data))
    assert tcli.main(["-f", str(ok), "-validate-config"]) == 0
    assert capsys.readouterr().out == "config valid\n"
    bad = tmp_path / "sentry.yaml"
    bad.write_text(yaml.safe_dump(dict(data, sentry_dsn="https://x@y/1")))
    assert tcli.main(["-f", str(bad), "-validate-config"]) == 1
    assert "sentry_dsn" in capsys.readouterr().err
    assert tcli.main(["-f", str(tmp_path / "missing.yaml"),
                      "-validate-config"]) == 1


def test_proxy_wants_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproxy.Proxy(tproxy.ProxyConfig())
    p = tproxy.Proxy(tproxy.ProxyConfig(), device="cpu")
    assert p.device == torch.device("cpu")
    p.stop()
    with pytest.raises(NotImplementedError, match="A16"):
        tproxy.Proxy(tproxy.ProxyConfig(), statsd=object(), device="cpu")


def test_a_failed_engine_build_raises_from_start(monkeypatch):
    """No fallback hides a router that does not build: start() raises,
    as Server.start() does under native_ingest."""
    def broken():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(ingest, "_lib", None)
    monkeypatch.setattr(ingest._build, "load", broken)
    p = tproxy.Proxy(tproxy.ProxyConfig(), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            p.start()
    finally:
        p.stop()


def test_proxy_cli_process_routes_and_stops_on_sigterm(tmp_path):
    """`python -m veneur_tpu_torch.cli.veneur_proxy -f <yaml> -device
    cpu`: boots, writes its port file, routes a V1 batch through the
    native router to a global, and exits 0 on SIGTERM."""
    g, _ = _tglobal()
    ports = tmp_path / "ports.json"
    cfg = tmp_path / "proxy.yaml"
    cfg.write_text(yaml.safe_dump({
        "grpc_address": "127.0.0.1:0", "http_address": "127.0.0.1:0",
        "static_destinations": [_addr(g)], "port_file": str(ports),
        "http_enable_profiling": True}))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur_proxy", "-f",
         str(cfg), "-device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait(lambda: ports.exists() or proc.poll() is not None,
              "the port file", timeout=120)
        assert proc.poll() is None, proc.stdout.read()
        p = json.loads(ports.read_text())
        assert p["pid"] == proc.pid
        ch = grpc.insecure_channel(f"127.0.0.1:{p['grpc']}")
        ch.unary_unary(tclient.SEND_METRICS,
                       request_serializer=lambda b: b,
                       response_deserializer=empty_pb2.Empty.FromString)(
            _metric_list([_counter_pb(f"cli.{i}").SerializeToString()
                          for i in range(50)]), timeout=10)
        ch.close()
        _wait(lambda: g.grpc_import.imported_count == 50, "the import")
        dv = json.loads(_get(p["http"], "/debug/vars")[1])
        assert (dv["received"], dv["routed"], dv["dropped"]) == (50, 50, 0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        g.shutdown()
