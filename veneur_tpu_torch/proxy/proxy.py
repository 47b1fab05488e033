"""The veneur-proxy equivalent: consistent-hash fan-in tier.

Counterpart of `veneur_tpu.proxy.proxy`, which mirrors `proxy/proxy.go`
+ `proxy/handlers/handlers.go`: hosts the Forward gRPC service, routes
each incoming metric by key = name + lower(type) + joined(filtered tags)
to a consistent-hash destination (`handleMetric`, handlers.go:99-164),
polls discovery every `discovery_interval` to rebuild the ring
(`pollDiscovery`, proxy.go:345-387), and serves an HTTP healthcheck
that fails at zero destinations (`handlers.go:30-38`).

A V1 `SendMetrics` payload routes without being parsed: the ingest
engine's router (`ingest.route_metric_list`, C++) hashes each record's
key on the ring and regroups the raw records into per-destination
MetricList bodies, which batch-mode destinations send verbatim.  The
engine is built at `start()`, and a failed build raises there, as
`Server.start()` does under `native_ingest`.  The protobuf path is
taken where the routing needs parsed metrics: with `ignore_tags` (the
key drops matching tags), for a destination that speaks V2 streams, for
a payload the router rejects, and with an empty ring (each metric is
counted `no_destination`).

`GET /query` is the live query plane's scatter-gather: the key routes
to the one global that owns it (a group-by read asks every member),
each upstream answers over HTTP, and `query.engine.merge_*responses`
merge the family payloads, a moments vector solving on the proxy's
`device` (CUDA unless the caller names another).

Not here yet, and refused at any value but the default: the TLS
listener (`grpc_tls_address`, `tls_*`, ROADMAP A15), the flight
recorder (`trace_ring_capacity`, A16) and the meshed global group
(`mesh_fanout`, A18).  `/debug/trace`, `/debug/spans` and
`/debug/threads` answer 404 (A16), as do the failpoints and the
`proxy.route` and `query` spans of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import http.server
import json
import logging
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import MISSING, dataclass, field, fields
from typing import Optional

import grpc
from google.protobuf import empty_pb2

from veneur_tpu_torch import config as config_mod
from veneur_tpu_torch import http_api, ingest, resolve_device
from veneur_tpu_torch.discovery import Discoverer, StaticDiscoverer
from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
from veneur_tpu_torch.proxy.destinations import Destinations
from veneur_tpu_torch.proxy.grpcstats import GrpcStats
from veneur_tpu_torch.query import engine as qengine
from veneur_tpu_torch.util import netaddr
from veneur_tpu_torch.util.build import BUILD_DATE, VERSION
from veneur_tpu_torch.util.matcher import TagMatcher

logger = logging.getLogger("veneur_tpu_torch.proxy")

_TYPE_NAMES = {
    metric_pb2.Counter: "counter",
    metric_pb2.Gauge: "gauge",
    metric_pb2.Histogram: "histogram",
    metric_pb2.Set: "set",
    metric_pb2.Timer: "timer",
}

# ProxyConfig fields this package does not serve: each raises
# NotImplementedError at any value but its default
UNSUPPORTED = {
    **dict.fromkeys(("grpc_tls_address", "tls_certificate", "tls_key",
                     "tls_authority_certificate"),
                    "the TLS listener, ROADMAP A15"),
    "trace_ring_capacity": "the flight recorder, ROADMAP A16",
    "mesh_fanout": "the meshed global group, ROADMAP A18",
}

# the JAX package's debug routes that wait for self-telemetry
_A16_ROUTES = ("/debug/trace", "/debug/spans", "/debug/threads")


@dataclass
class ProxyConfig:
    """proxy/config.go essentials: every field of the JAX package's
    ProxyConfig, with its default."""
    grpc_address: str = "127.0.0.1:0"
    http_address: str = "127.0.0.1:0"
    forward_service: str = "veneur-global"
    discovery_interval: float = 10.0
    # per-destination buffer bound, in metrics
    send_buffer_size: int = 1024
    # parallel SendMetricsV2 streams per destination (V2 destinations
    # only; a single python-grpc stream caps at ~20k msgs/s)
    send_streams: int = 8
    # per-RPC deadline for destination sends and the dial/probe deadline
    proxy_send_timeout: float = 30.0
    proxy_dial_timeout: float = 5.0
    # V2 stream lifetime deadline (0 = reference semantics: none).
    # Batch-mode (V1) destinations always run per-RPC deadlines
    proxy_stream_timeout: float = 0.0
    # per-destination circuit breaker (proxy/destinations.py): after
    # breaker_failure_threshold consecutive failures the address is
    # tripped out of the ring until a half-open probe succeeds; the
    # cooldown starts at breaker_reset_timeout and doubles per trip
    breaker_failure_threshold: int = 3
    breaker_reset_timeout: float = 5.0
    # elastic ring reshard (Destinations.set_members): how long a
    # retiring destination may drain before its undelivered buffer is
    # handed onto the new ring, and how many sample keys the committed
    # reshard record routes through both rings
    reshard_handoff_timeout: float = 2.0
    reshard_sample_keys: int = 2048
    # inbound gRPC handler pool width, and how long stop() lets
    # in-flight RPCs finish before cancelling them
    grpc_workers: int = 16
    shutdown_grace: float = 1.0
    ignore_tags: list[TagMatcher] = field(default_factory=list)
    static_destinations: list[str] = field(default_factory=list)
    # a second, TLS-authenticated listener (UNSUPPORTED)
    grpc_tls_address: str = ""
    tls_certificate: str = ""
    tls_key: str = ""
    tls_authority_certificate: str = ""
    # /config/{json,yaml} behind http_enable_config, /debug/vars behind
    # http_enable_profiling (cmd/veneur-proxy/main.go:84-102)
    http_enable_config: bool = False
    http_enable_profiling: bool = False
    # the flight recorder's ring (UNSUPPORTED)
    trace_ring_capacity: int = 512
    # after the listeners bind, the entry point writes {grpc: N, http: N}
    # of the resolved ports here; "" = no file
    port_file: str = ""
    # live query plane: each ring member's gRPC address -> its HTTP
    # address; the local-tier HTTP addresses a `locals=` query may ask;
    # the end-to-end scatter-gather deadline
    query_destinations: dict = field(default_factory=dict)
    query_local_addresses: list[str] = field(default_factory=list)
    query_timeout: float = 2.0
    # one meshed global group instead of a ring (UNSUPPORTED)
    mesh_fanout: bool = False

    def __post_init__(self):
        for f in fields(ProxyConfig):
            if f.name not in UNSUPPORTED:
                continue
            want = (f.default if f.default_factory is MISSING
                    else f.default_factory())
            if getattr(self, f.name) != want:
                raise NotImplementedError(
                    f"proxy option {f.name}={getattr(self, f.name)!r} is "
                    f"not supported here ({UNSUPPORTED[f.name]})")


def proxy_config_from_dict(data: dict) -> ProxyConfig:
    """The one YAML -> ProxyConfig loader (the CLI and the tests share
    it), Go-style durations included."""
    parse_duration = config_mod.parse_duration
    return ProxyConfig(
        grpc_address=data.get("grpc_address", "0.0.0.0:8128"),
        http_address=data.get("http_address", "0.0.0.0:8127"),
        forward_service=data.get("forward_service", "veneur-global"),
        discovery_interval=parse_duration(
            data.get("discovery_interval", 10.0)),
        send_buffer_size=int(data.get("send_buffer_size", 1024)),
        send_streams=int(data.get("send_streams", 8)),
        proxy_send_timeout=parse_duration(
            data.get("proxy_send_timeout", 30.0)),
        proxy_dial_timeout=parse_duration(
            data.get("proxy_dial_timeout", 5.0)),
        proxy_stream_timeout=parse_duration(
            data.get("proxy_stream_timeout", 0.0)),
        breaker_failure_threshold=int(
            data.get("breaker_failure_threshold", 3)),
        breaker_reset_timeout=parse_duration(
            data.get("breaker_reset_timeout", 5.0)),
        reshard_handoff_timeout=parse_duration(
            data.get("reshard_handoff_timeout", 2.0)),
        reshard_sample_keys=int(data.get("reshard_sample_keys", 2048)),
        grpc_workers=int(data.get("grpc_workers", 16)),
        shutdown_grace=parse_duration(data.get("shutdown_grace", 1.0)),
        ignore_tags=[TagMatcher(**t) for t in data.get("ignore_tags", [])],
        static_destinations=list(data.get("static_destinations", [])),
        grpc_tls_address=data.get("grpc_tls_address", ""),
        tls_certificate=data.get("tls_certificate", ""),
        tls_key=data.get("tls_key", ""),
        tls_authority_certificate=data.get(
            "tls_authority_certificate", ""),
        http_enable_config=bool(data.get("http_enable_config", False)),
        http_enable_profiling=bool(
            data.get("http_enable_profiling", False)),
        trace_ring_capacity=int(data.get("trace_ring_capacity", 512)),
        port_file=data.get("port_file", ""),
        query_destinations=dict(data.get("query_destinations") or {}),
        query_local_addresses=list(
            data.get("query_local_addresses") or []),
        query_timeout=parse_duration(data.get("query_timeout", 2.0)),
        mesh_fanout=bool(data.get("mesh_fanout", False)))


def redacted_proxy_dict(cfg: ProxyConfig, redact: bool = True) -> dict:
    """ProxyConfig dump with secrets redacted, through the server's
    redaction helper (util/config/config.go:65-96)."""
    return config_mod.redacted_fields(cfg, {"tls_key"}, redact)


def debug_vars(proxy) -> dict:
    """The proxy's `/debug/vars` payload: the JAX package's keys but
    `trace_recorded` (the flight recorder, ROADMAP A16)."""
    with proxy._stats_lock:
        stats = dict(proxy.stats)
        stats["query"] = dict(proxy.query_stats)
    stats["destinations"] = proxy.destinations.size()
    stats["destination_stats"] = proxy.destinations.stats()
    # cumulative incl. removed destinations: a dead destination's drop
    # accounting must stay visible
    stats["destination_totals"] = proxy.destinations.totals()
    stats["breakers"] = proxy.destinations.breaker_stats()
    stats["reshard"] = proxy.destinations.reshard_stats()
    stats["threads"] = threading.active_count()
    return stats


class Proxy:
    def __init__(self, cfg: ProxyConfig,
                 discoverer: Optional[Discoverer] = None,
                 statsd=None, device=None):
        self.cfg = cfg
        # the /query merge's device (a moments solve, a digest compress)
        self.device = resolve_device(device)
        self.discoverer = discoverer or StaticDiscoverer(
            cfg.static_destinations)
        # connection open/close accounting (grpcstats/stats.go:1-49)
        self.grpc_stats = GrpcStats(statsd=statsd)
        self.destinations = Destinations(
            cfg.send_buffer_size,
            n_streams=cfg.send_streams,
            grpc_stats=self.grpc_stats,
            send_timeout_s=cfg.proxy_send_timeout,
            dial_timeout_s=cfg.proxy_dial_timeout,
            stream_timeout_s=cfg.proxy_stream_timeout,
            breaker_threshold=cfg.breaker_failure_threshold,
            breaker_reset_s=cfg.breaker_reset_timeout,
            # reshard drain-and-forward: a retiring destination's
            # undelivered buffer re-routes through the NEW ring
            handoff=self._reshard_handoff,
            handoff_timeout_s=cfg.reshard_handoff_timeout,
            reshard_sample_keys=cfg.reshard_sample_keys)
        self.stats = {"received": 0, "routed": 0, "dropped": 0,
                      "no_destination": 0, "rerouted": 0}
        # scatter-gather accounting (/debug/vars -> query): answers
        # served, request errors, upstream fetch failures (an upstream
        # error degrades the merge; it fails the request only when
        # every upstream failed)
        self.query_stats = {"served": 0, "errors": 0,
                            "upstream_errors": 0}
        # long-lived scatter-gather pool, made on first use
        self._query_pool = None
        self._query_pool_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._started = False

        self.grpc_server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(
                max_workers=cfg.grpc_workers,
                thread_name_prefix="proxy-grpc"),
            interceptors=[self.grpc_stats.interceptor()])
        self.grpc_server.add_generic_rpc_handlers([self._handlers()])
        self.grpc_port = self.grpc_server.add_insecure_port(
            cfg.grpc_address)
        if self.grpc_port == 0:
            raise OSError(f"could not bind proxy to {cfg.grpc_address}")

        hhost, hport = netaddr.split_hostport(cfg.http_address)

        class _HttpServer(http.server.ThreadingHTTPServer):
            address_family = netaddr.family(hhost)

        self.httpd = _HttpServer((hhost, hport), self._http_handler())
        self.httpd.daemon_threads = True
        self.http_port = self.httpd.server_address[1]

    # -- gRPC Forward service ---------------------------------------------

    def _handlers(self):
        def send_metrics_raw(request_bytes, context):
            # fleet-internal batch inbound, kept as raw bytes for the
            # native router
            self.handle_metrics_raw(bytes(request_bytes))
            return empty_pb2.Empty()

        def send_metrics_v2(request_iterator, context):
            for m in request_iterator:
                self.handle_metric(m)
            return empty_pb2.Empty()

        return grpc.method_handlers_generic_handler(
            "forwardrpc.Forward", {
                "SendMetrics": grpc.unary_unary_rpc_method_handler(
                    send_metrics_raw,
                    request_deserializer=lambda b: b,
                    response_serializer=empty_pb2.Empty.SerializeToString),
                "SendMetricsV2": grpc.stream_unary_rpc_method_handler(
                    send_metrics_v2,
                    request_deserializer=metric_pb2.Metric.FromString,
                    response_serializer=empty_pb2.Empty.SerializeToString),
            })

    def _kept_tags(self, tags) -> list:
        return [t for t in tags
                if not any(tm.match(t) for tm in self.cfg.ignore_tags)]

    def routing_key(self, m: metric_pb2.Metric) -> str:
        """name + lower(type) + joined(filtered tags)
        (handlers.go:111-112)."""
        return (f"{m.name}{_TYPE_NAMES.get(m.type, '')}"
                f"{','.join(self._kept_tags(m.tags))}")

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def handle_metric(self, m: metric_pb2.Metric) -> None:
        try:
            dest = self.destinations.get(self.routing_key(m))
        except LookupError:
            self._count(received=1, no_destination=1)
            return
        if dest.send(m) == "dropped":
            self._count(received=1, dropped=1)
        else:
            self._count(received=1, routed=1)

    def handle_metrics_raw(self, payload: bytes) -> None:
        """Route a serialized MetricList without deserializing it
        (`ingest.route_metric_list`); batch-mode destinations send the
        routed chunks verbatim, a V2 destination parses its own share.
        Takes the protobuf path with `ignore_tags`, an empty ring, or a
        payload the router rejects."""
        if not payload:
            return      # the V1 probe
        ring = (None if self.cfg.ignore_tags
                else self.destinations.ring_arrays())
        routed = None
        if ring is not None:
            hashes, didx, dests = ring
            routed = ingest.route_metric_list(payload, hashes, didx,
                                              len(dests))
        if routed is None:
            self.handle_metrics(
                forward_pb2.MetricList.FromString(payload).metrics)
            return
        received = routed_n = dropped = 0
        for (chunks, chunk_counts, count), dest in zip(routed, dests):
            if not count:
                continue
            received += count
            if dest.batch_mode:
                n_drop = dest.send_raw(chunks, chunk_counts, count)
            else:
                n_drop = dest.send_many(
                    [m for ch in chunks
                     for m in forward_pb2.MetricList.FromString(ch).metrics])
            dropped += n_drop
            routed_n += count - n_drop
        self._count(received=received, routed=routed_n, dropped=dropped)

    def handle_metrics(self, ms, rerouted: bool = False) -> None:
        """Batched routing: group by destination, enqueue each group as
        one unit, take the stats lock once.  `rerouted` marks a reshard
        handoff replay: those metrics were counted received AND routed
        when they first arrived, so the replay bumps only `rerouted` plus
        any NEW outcome — drops and no-owner at the new destination are
        fresh, real losses."""
        ms = list(ms)
        groups: dict = {}
        no_dest = 0
        for m in ms:
            try:
                dest = self.destinations.get(self.routing_key(m))
            except LookupError:
                no_dest += 1
                continue
            groups.setdefault(id(dest), (dest, []))[1].append(m)
        routed = dropped = 0
        for dest, batch in groups.values():
            n_drop = dest.send_many(batch)
            dropped += n_drop
            routed += len(batch) - n_drop
        if rerouted:
            self._count(rerouted=routed + dropped + no_dest,
                        no_destination=no_dest, dropped=dropped)
        else:
            self._count(received=len(ms), routed=routed,
                        no_destination=no_dest, dropped=dropped)

    def _reshard_handoff(self, ms) -> None:
        """Drain-and-forward target for Destinations: re-route a
        retiring destination's undelivered buffer through the new
        ring."""
        self.handle_metrics(ms, rerouted=True)

    # -- live query plane: scatter-gather /query ---------------------------

    def _query_routing_key(self, name: str, tags: list,
                           kind: str) -> str:
        """The metric routing key of a queried key: tags join SORTED,
        as every forwarded metric's wire tags are (the parser sorts
        them), so the query lands on the global that owns the key."""
        return f"{name}{kind}{','.join(sorted(self._kept_tags(tags)))}"

    @staticmethod
    def _query_fetch(addr: str, params: str, timeout_s: float) -> dict:
        """One upstream /query fetch; raises on transport errors or a
        non-200 answer (the caller accounts it as an upstream
        error)."""
        with urllib.request.urlopen(f"http://{addr}/query?{params}",
                                    timeout=timeout_s) as resp:
            return json.loads(resp.read())

    def handle_query(self, q: dict) -> tuple[int, dict]:
        """Scatter-gather one windowed query: ring-route to the owning
        global (one hop, by the one-global-per-key invariant), fan out
        to any requested locals, merge the self-describing family
        payloads, and answer with the fused quantiles plus per-upstream
        diagnostics.  Bounded by cfg.query_timeout end to end."""
        deadline = time.perf_counter() + self.cfg.query_timeout
        try:
            code, body = self._handle_query_inner(q, deadline)
        except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
            # a malformed or version-skewed upstream body comes back as
            # an accounted JSON 500, not an aborted connection
            code, body = 500, {"error": f"{type(e).__name__}: {e}"}
        with self._stats_lock:
            self.query_stats["served" if code == 200 else "errors"] += 1
        return code, body

    def _global_targets(self, spec) -> tuple:
        """(HTTP addresses of the globals to ask, None) or (None, the
        error answer)."""
        if spec["group_by"]:
            # every cube group row ring-routes by its own tags, so the
            # groups of one metric scatter across the whole ring
            members = self.destinations.all_members()
            if not members:
                return None, (503, {"error": "no destinations"})
        else:
            # histogram and timer keys of one name may live on different
            # globals: a query that does not pin type= asks both owners
            members = []
            for kind in ([spec["kind"]] if spec["kind"]
                         else ["histogram", "timer"]):
                try:
                    members.append(self.destinations.get(
                        self._query_routing_key(spec["name"],
                                                spec["tags"], kind)))
                except LookupError:
                    return None, (503, {"error": "no destinations"})
        addrs: list = []
        for m in members:
            http_addr = self.cfg.query_destinations.get(m.address)
            if http_addr is None:
                return None, (502, {"error": "no query_destinations "
                                    "mapping for ring member "
                                    f"{m.address}"})
            if http_addr not in addrs:
                addrs.append(http_addr)
        return addrs, None

    @staticmethod
    def _upstream_params(spec) -> str:
        """The validated spec re-encoded for the upstreams.  top= is not
        forwarded: a member's top-k would clip groups whose merged mass
        only clears the bar once every member's share lands."""
        params = {"name": spec["name"],
                  "q": ",".join(repr(float(p)) for p in spec["qs"])}
        if spec["slots"] is not None:
            params["slots"] = str(spec["slots"])
        elif spec["window_s"] is not None:
            params["window_s"] = repr(spec["window_s"])
        if spec.get("since") is not None:
            # range form: bins align upstream, since every member grids
            # the same since/step
            params["since"] = repr(spec["since"])
            params["step"] = repr(spec["step"])
            if spec.get("until") is not None:
                params["until"] = repr(spec["until"])
        if spec["tags"]:
            params["tags"] = ",".join(spec["tags"])
        if spec["kind"]:
            params["type"] = spec["kind"]
        if spec["group_by"]:
            params["group_by"] = ",".join(sorted(spec["group_by"]))
            if spec["by"]:
                params["by"] = spec["by"]
        return urllib.parse.urlencode(params)

    def _handle_query_inner(self, q, deadline) -> tuple[int, dict]:
        try:
            spec = qengine.parse_query_params(q)
        except qengine.QueryError as e:
            return e.code, {"error": str(e)}
        locals_param = (q.get("locals") or [""])[0]
        if locals_param == "all":
            local_addrs = list(self.cfg.query_local_addresses)
        else:
            local_addrs = [a for a in locals_param.split(",") if a]
            unknown = [a for a in local_addrs
                       if a not in self.cfg.query_local_addresses]
            if unknown:
                return 400, {"error": "unknown local address(es) "
                             f"{unknown}; the proxy only queries "
                             "configured query_local_addresses"}
        global_addrs, err = self._global_targets(spec)
        if err is not None:
            return err
        encoded = self._upstream_params(spec)
        targets = ([("global", a) for a in global_addrs]
                   + [("local", a) for a in local_addrs])

        def fetch(tier_addr):
            budget = deadline - time.perf_counter()
            if budget <= 0:
                raise TimeoutError("query deadline exhausted")
            return self._query_fetch(tier_addr[1], encoded, budget)

        if len(targets) == 1:
            results = [(targets[0], self._try(fetch, targets[0]))]
        else:
            pool = self._ensure_query_pool()
            futs = [(t, pool.submit(fetch, t)) for t in targets]
            results = [(t, self._try(f.result)) for t, f in futs]
        responses: list[dict] = []
        upstreams: list[dict] = []
        for (tier, addr), (resp, error) in results:
            row = {"tier": tier, "address": addr}
            if error is not None:
                row["error"] = error
            else:
                responses.append(resp)
                row.update(slots_fused=resp.get("slots_fused"),
                           count=resp.get("count"),
                           staleness_ms=resp.get("staleness_ms"),
                           fresh=resp.get("fresh"))
            upstreams.append(row)
        if len(responses) < len(results):
            with self._stats_lock:
                self.query_stats["upstream_errors"] += (
                    len(results) - len(responses))
        if not responses:
            return 502, {"error": "every upstream failed",
                         "upstreams": upstreams}
        if spec["group_by"]:
            merged = qengine.merge_group_responses(
                responses, spec["qs"], top=spec["top"], by=spec["by"],
                device=self.device)
        elif spec.get("since") is not None:
            merged = qengine.merge_range_responses(
                responses, spec["qs"], device=self.device)
        else:
            merged = qengine.merge_responses(responses, spec["qs"],
                                             device=self.device)
        merged["upstreams"] = upstreams
        merged["tier"] = "proxy"
        if not spec.get("payload", True):
            # payload=0: upstreams still ship their mergeable payloads
            # (the scatter-gather currency); the client asked for
            # quantiles only
            merged["payload"] = None
            for e in merged.get("groups") or []:
                e["payload"] = None
            for b in merged.get("series") or []:
                b["payload"] = None
            if merged.get("other"):
                merged["other"]["payload"] = None
        if local_addrs and len(responses) > 1:
            # `locals=` is for LOCAL_ONLY-scope keys that never forward;
            # for mixed-scope keys the owning global already holds every
            # local's forwarded samples, so this merge counts them twice
            merged["double_count_risk"] = True
        return 200, merged

    def _ensure_query_pool(self):
        with self._query_pool_lock:
            if self._query_pool is None:
                if self._shutdown.is_set():
                    # a request racing stop() must not resurrect the
                    # pool stop() just tore down
                    raise RuntimeError("proxy is stopping")
                self._query_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.cfg.grpc_workers,
                    thread_name_prefix="proxy-query")
            return self._query_pool

    @staticmethod
    def _try(fn, *a) -> tuple:
        """(result, None) or (None, error string): an upstream fetch
        failure degrades the merge and is accounted, never silent."""
        try:
            return fn(*a), None
        except Exception as e:  # noqa: BLE001 - stringified upstream error
            return None, f"{type(e).__name__}: {e}"

    # -- HTTP surface (handlers.go:30-38 healthcheck +
    #    cmd/veneur-proxy/main.go:84-102 version/builddate/config/debug) --

    def _http_handler(self):
        proxy = self
        cfg = self.cfg
        reply = http_api.reply

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                path = self.path
                if path == "/healthcheck":
                    if proxy.destinations.size() > 0:
                        reply(self, 200, b"ok\n")
                    else:
                        reply(self, 503, b"no destinations\n")
                elif path == "/version":
                    reply(self, 200, VERSION.encode())
                elif path == "/builddate":
                    reply(self, 200, BUILD_DATE.encode())
                elif path == "/config/json" and cfg.http_enable_config:
                    reply(self, 200, http_api.config_json_body(
                        redacted_proxy_dict(cfg)), "application/json")
                elif path == "/config/yaml" and cfg.http_enable_config:
                    reply(self, 200, http_api.config_yaml_body(
                        redacted_proxy_dict(cfg)), "application/x-yaml")
                elif path.startswith("/query"):
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(path).query)
                    code, body = proxy.handle_query(q)
                    reply(self, code, json.dumps(body, indent=2).encode(),
                          "application/json")
                elif path == "/debug/vars" and cfg.http_enable_profiling:
                    reply(self, 200, json.dumps(
                        debug_vars(proxy), indent=2).encode(),
                        "application/json")
                elif path.startswith(_A16_ROUTES):
                    reply(self, 404,
                          b"not found: not ported yet (ROADMAP A16)\n")
                else:
                    reply(self, 404, b"not found\n")

        return Handler

    # -- discovery loop (proxy.go:345-387) ---------------------------------

    def handle_discovery(self) -> None:
        try:
            dests = self.discoverer.get_destinations_for_service(
                self.cfg.forward_service)
        except Exception as e:
            logger.warning("discovery failed: %s", e)
            return
        self.destinations.set_members(dests)

    def _poll_discovery(self) -> None:
        while not self._shutdown.wait(self.cfg.discovery_interval):
            self.handle_discovery()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Build the native router (a failed build raises), connect the
        discovered destinations, then serve gRPC and HTTP and poll
        discovery."""
        ingest.load_library()
        self.handle_discovery()
        self.grpc_server.start()
        self._started = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True, name="proxy-http").start()
        threading.Thread(target=self._poll_discovery,
                         daemon=True, name="proxy-discovery").start()

    def stop(self) -> None:
        self._shutdown.set()
        self.grpc_server.stop(grace=self.cfg.shutdown_grace)
        if self._started:
            # shutdown() blocks forever unless serve_forever is running
            self.httpd.shutdown()
        self.httpd.server_close()
        with self._query_pool_lock:
            pool, self._query_pool = self._query_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        self.destinations.clear()
