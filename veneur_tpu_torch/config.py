"""Server configuration: every field of `veneur_tpu.config.Config`, and
its YAML loader.

The same field names and defaults as the JAX package's `Config`
(`config.go:12-134`), so one configuration describes both servers.  The
fields this package serves come first; every other field is accepted
at its default and raises NotImplementedError at any other value
(UNSUPPORTED below says what each needs), whether it comes from a
`Config(...)` call, a YAML file or a `VENEUR_*` environment override.
`native_ingest` (on by default, as there) reads UDP through the native
ingest engine's C++ readers (`ingest/`), tuned by the `ingest_*`
options; false keeps the Python readers.

The loader is the JAX package's (`util/config/config.go:16-63`): the file
is template-expanded (`$NAME` / `${NAME}` from the environment), parsed
as YAML (optionally rejecting unknown fields), overridden by `VENEUR_*`
environment variables, and completed by `Config.apply_defaults`.
"""

from __future__ import annotations

import os
import re
import socket
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Optional

import yaml

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.util.matcher import Matcher, matcher_from_config


def parse_duration(v: Any) -> float:
    """Go-style duration ("10s", "50ms", "1m30s") -> seconds.

    Raises ValueError on anything that isn't a number or a duration
    string (time.ParseDuration errors on malformed input too).
    """
    if isinstance(v, bool) or not isinstance(v, (int, float, str)):
        raise ValueError(f"invalid duration: {v!r}")
    if isinstance(v, (int, float)):
        return float(v)
    s = v.strip()
    if re.fullmatch(r"[0-9.]+", s):
        return float(s)
    units = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
             "s": 1.0, "m": 60.0, "h": 3600.0}
    if not re.fullmatch(r"(?:[0-9.]+(?:ns|us|µs|ms|s|m|h))+", s):
        raise ValueError(f"invalid duration: {v!r}")
    total = 0.0
    for num, unit in re.findall(r"([0-9.]+)(ns|us|µs|ms|s|m|h)", s):
        total += float(num) * units[unit]
    return total


@dataclass
class SinkRoutingConfig:
    """metric_sink_routing entry (config.go:78-87)."""
    name: str = ""
    match: list[Matcher] = field(default_factory=list)
    matched: list[str] = field(default_factory=list)
    not_matched: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "SinkRoutingConfig":
        sinks = d.get("sinks", {})
        return cls(
            name=d.get("name", ""),
            match=[matcher_from_config(m) for m in d.get("match", [])],
            matched=sinks.get("matched", []),
            not_matched=sinks.get("not_matched", []))


@dataclass
class Config:
    """Server configuration (config.go:12-112)."""
    # listeners
    statsd_listen_addresses: list[str] = field(default_factory=list)
    grpc_address: str = ""          # gRPC import (global tier)
    forward_address: str = ""       # set => this is a LOCAL instance

    # forwarding (forward/client.py): each forward's deadline (0: the
    # interval, at least 10 s), the V2 streams a big payload fans out
    # over, retries of what is provably undelivered after a base
    # backoff that doubles, and whether DEADLINE_EXCEEDED counts as
    # undelivered (only against a global with a dedup ledger)
    forward_timeout: float = 0.0
    forward_streams: int = 8
    forward_max_retries: int = 2
    forward_retry_backoff: float = 0.05
    forward_deadline_retry_safe: bool = False
    # chunk identities a global's dedup ledger keeps per sender
    spool_dedup_window: int = 4096
    # the durable forward spool (forward/spool.py): with spool_dir, a
    # local's provably undelivered V1 chunks spill to segment files
    # when the retries are exhausted and a replayer re-delivers them
    # under their recorded identities; bounded by spool_max_bytes and
    # spool_max_age (visibly accounted expiry)
    spool_dir: str = ""
    spool_max_bytes: int = 64 * 1024 * 1024
    spool_max_age: float = 600.0
    spool_fsync: str = "rotate"          # always | rotate | never
    spool_replay_interval: float = 0.5
    spool_segment_max_bytes: int = 4 * 1024 * 1024
    # crash checkpoints (core/checkpoint.py): with checkpoint_dir, the
    # server restores at start, checkpoints every checkpoint_interval
    # (0: only at shutdown, POST /checkpoint or checkpoint_now) and
    # stamps a flush marker after each flush
    checkpoint_dir: str = ""
    checkpoint_interval: float = 0.0
    # the per-tenant key budget (core/cardinality.py): 0 is off; keys
    # carrying `<cardinality_tenant_tag>:<t>` count against tenant t's
    # budget, and an over-budget tail folds into rollup keys whose
    # histogram family is cardinality_rollup_family
    cardinality_key_budget: int = 0
    cardinality_tenant_tag: str = "tenant"
    cardinality_seed: int = 0
    cardinality_rollup_family: str = "tdigest"

    # aggregation
    interval: float = 10.0
    percentiles: list[float] = field(default_factory=list)
    aggregates: list[str] = field(
        default_factory=lambda: ["min", "max", "count"])
    tdigest_compression: float = 100.0
    set_precision: int = 14
    hll_legacy_migration: bool = False
    count_unique_timeseries: bool = False
    # the histogram/timer sketch: "tdigest" (default), "moments"
    # (fixed-size moment vectors, B5 + maxent flush) or "compactor"
    # (relative-error compactor ladders, B6 + the ladder read-off);
    # rules match at ingest, first hit wins, each {match: <name glob>,
    # family: ...} or {tenant: <tenant-tag value>, family: ...}
    sketch_family_default: str = "tdigest"
    sketch_family_rules: list = field(default_factory=list)
    # power-sum order k of the moments vector (6 + 2k doubles per key;
    # every tier of a fleet must agree)
    sketch_moments_k: int = 8
    # compactor ladder geometry (sketches/compactor.py): cap is the
    # per-level buffer (a power of two in [8, 256]), levels the ladder
    # height ([4, 32]), seed the stride-select coin seed; 0 = the
    # built-in default.  Every tier of a fleet must agree on all three
    sketch_compactor_cap: int = 0
    sketch_compactor_levels: int = 0
    sketch_compactor_seed: int = 0
    # stage the t-digest flush's dense VALUE matrix as bfloat16: half
    # its upload, quantile values rounded to bf16's ~2^-8 relative step;
    # weights, min/max, counts, sums and forwarded centroids stay exact.
    # General rows of depth <= 64 then take B4 (the stable packed-key
    # network), deeper ones B1 and uniform intervals B3 on bf16 values
    digest_bf16_staging: bool = False
    arena_initial_capacity: int = 0
    set_arena_initial_capacity: int = 0
    # device mesh of the meshed flush (parallel/mesh.py): mesh_devices
    # devices (0: one device, unmeshed) as (shard, replica);
    # mesh_replicas 0 = auto (2 when the device count is even), else any
    # count dividing it.  ingest_lanes is accepted as the JAX package
    # accepts it and has no effect (its digest staging has no ingest
    # lanes either).  The t-digest, moments, set, counter and
    # unique-timeseries families run meshed; the compactor family
    # refuses a mesh (check_mesh_families)
    mesh_devices: int = 0
    mesh_replicas: int = 0
    ingest_lanes: int = 0
    # group-by cubes: each dimension (a tag-name list, or {tags: [...],
    # match: <name glob(s)>}) mirrors every histogram/timer sample that
    # carries all its tags into a per-group rollup row, at most
    # cube_group_budget groups per dimension (required > 0 with
    # dimensions); over-budget groups land in the accounted
    # veneur.cube.other row.  cube_seed seeds the rank tie-breaks
    cube_dimensions: list = field(default_factory=list)
    cube_group_budget: int = 0
    cube_seed: int = 0
    # the live query plane (GET /query): a ring of query_window_slots
    # per-interval sub-sketches per histogram family, rotated at every
    # flush cut; 0 turns it off.  query_slot_seconds is one slot's
    # nominal span for window_s= reads (0: the flush interval)
    query_window_slots: int = 0
    query_slot_seconds: float = 0.0

    # ingest: num_readers UDP sockets a listener (SO_REUSEPORT), read by
    # the native engine's C++ readers (native_ingest, ingest/) or by
    # Python threads.  The engine's tuning (its defaults when 0 /
    # "auto"): ingest_reader_shards sockets and readers instead of
    # num_readers, ingest_reader_pinning pins reader i to CPU i, the
    # datagrams a receive burst takes, the tokenizer's SIMD mode
    # (auto|scalar|sse2|avx2), the receive backend (auto|recvmmsg|
    # io_uring; auto probes io_uring), the staging ring's slots a
    # reader, the drain cadence (0: min(interval / 10, 0.5 s)), and the
    # interned identities past which a drain clears the intern table
    num_readers: int = 1
    native_ingest: bool = True
    ingest_reader_shards: int = 0
    ingest_reader_pinning: bool = False
    ingest_reader_batch: int = 0
    ingest_simd: str = "auto"
    ingest_backend: str = "auto"
    ingest_ring_slots: int = 0
    ingest_drain_interval: float = 0.0
    intern_gc_threshold: int = 1_000_000
    metric_max_length: int = 4096
    read_buffer_size_bytes: int = 2 * 1024 * 1024

    # identity/tags
    hostname: str = ""
    extend_tags: list[str] = field(default_factory=list)

    # behavior: a final flush at shutdown; flushes at wall-clock
    # multiples of the interval; no hostname derived when it is empty
    flush_on_shutdown: bool = False
    synchronize_with_interval: bool = False
    omit_empty_hostname: bool = False
    # declared by the JAX package and read nowhere there either
    num_workers: int = 1

    # the command line (cli/veneur.py): the HTTP API's address, the file
    # its resolved ports go to, the gated POST /quitquitquit, GET
    # /config/{json,yaml} and POST /flush routes, and DEBUG logging
    http_address: str = ""
    port_file: str = ""
    http_quit: bool = False
    http_config_endpoint: bool = False
    http_flush_endpoint: bool = False
    debug: bool = False

    # plugins
    metric_sinks: list[sink_mod.SinkSpec] = field(default_factory=list)

    # the JAX package's other fields, in its order: those in UNSUPPORTED
    # are accepted at their defaults and rejected at any other value;
    # those marked "served" are served
    grpc_listen_addresses: list[str] = field(default_factory=list)
    ssf_listen_addresses: list[str] = field(default_factory=list)
    stats_address: str = ""
    # the egress plane (egress/, served): sink fan-out runs on per-sink
    # lanes with a bounded queue (egress_queue_depth intervals), a
    # circuit breaker (egress_breaker_threshold consecutive failures
    # trip it; cooldown egress_breaker_reset, doubling per trip),
    # bounded retries with seeded backoff, and a durable spool under
    # egress_spool_dir ("" drops with accounting instead)
    egress_queue_depth: int = 128
    egress_max_retries: int = 2
    egress_retry_backoff: float = 0.05
    egress_retry_seed: int = 0
    egress_breaker_threshold: int = 3
    egress_breaker_reset: float = 5.0
    egress_spool_dir: str = ""
    egress_spool_max_bytes: int = 64 * 1024 * 1024
    egress_spool_max_age: float = 600.0
    egress_spool_replay_interval: float = 0.5
    retention_tiers: list = field(default_factory=list)
    retention_dir: str = ""
    retention_max_bytes: int = 256 * 1024 * 1024
    retention_max_age: float = 0.0
    distributed_coordinator: str = ""
    distributed_num_processes: int = 0
    distributed_process_id: int = -1
    digest_float64: bool = False
    eager_device_sync: bool = True
    num_span_workers: int = 1
    trace_max_length_bytes: int = 16 * 1024 * 1024
    span_channel_capacity: int = 100
    # served: tag keys dropped before the sinks see a flush, "key" for
    # every sink or "key|sink1|sink2" for those sinks only
    tags_exclude: list[str] = field(default_factory=list)
    flush_watchdog_missed_flushes: int = 0
    compilation_cache_dir: str = "~/.cache/veneur-tpu-xla"
    prewarm_flush_shapes: bool = False
    prewarm_depths: list[int] = field(default_factory=lambda: [4, 32])
    flush_upload_chunks: int = 2
    flush_presharded_staging: bool = True
    flush_resident_arenas: bool = False
    flush_delta_chunk_keys: int = 0
    flush_delta_nbuf: int = 2
    flush_resident_device_assembly: Optional[bool] = None
    enable_profiling: bool = False
    profiling_cpu_hz: int = 100
    profiling_cpu_max_seconds: float = 60.0
    profiling_timeline_capacity: int = 512
    profiling_use_pyspy: bool = True
    trace_flush_enabled: bool = True
    trace_flush_sample_rate: float = 1.0
    trace_seed: int = 0
    trace_ring_capacity: int = 512
    mutex_profile_fraction: int = 0
    block_profile_rate: int = 0
    sentry_dsn: str = ""
    indicator_span_timer_name: str = ""
    objective_span_timer_name: str = ""
    tls_key: str = ""
    tls_certificate: str = ""
    tls_authority_certificate: str = ""
    diagnostics_metrics_enabled: bool = False
    span_sinks: list = field(default_factory=list)
    sources: list = field(default_factory=list)
    # served: per-metric sink allowlists from name/tag matchers
    # (features.enable_metric_sink_routing turns them on)
    enable_metric_sink_routing: bool = False
    metric_sink_routing: list[SinkRoutingConfig] = field(
        default_factory=list)
    veneur_metrics_scopes: dict = field(default_factory=dict)
    veneur_metrics_additional_tags: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Refuse every UNSUPPORTED option away from its default
        (NotImplementedError naming it), check the served ones as the
        JAX package does (ValueError) and apply its clamps.  Runs on
        construction and again at the end of each loader, after the
        file, the environment overrides and apply_defaults."""
        self.metric_sinks = [
            s if isinstance(s, sink_mod.SinkSpec)
            else sink_mod.SinkSpec.from_dict(s) for s in self.metric_sinks]
        self.metric_sink_routing = [
            r if isinstance(r, SinkRoutingConfig)
            else SinkRoutingConfig.from_dict(r)
            for r in self.metric_sink_routing]
        for f in fields(Config):
            if f.name not in UNSUPPORTED:
                continue
            want = (f.default if f.default_factory is MISSING
                    else f.default_factory())
            if getattr(self, f.name) != want:
                raise NotImplementedError(
                    f"config option {f.name}={getattr(self, f.name)!r} "
                    f"is not supported here ({UNSUPPORTED[f.name]})")
        # the JAX package's contradictions (digest_float64 is unsupported
        # above, which raises first)
        if self.digest_bf16_staging and self.digest_float64:
            raise ValueError(
                "digest_bf16_staging contradicts digest_float64 "
                "(half- vs double-precision staging); drop one")
        if self.digest_bf16_staging and self.mesh_devices:
            raise ValueError(
                "digest_bf16_staging is unsupported with a device mesh "
                "(the meshed flush program is f32-native); drop one")
        fams = parse_family_rules(self.sketch_family_default,
                                  self.sketch_family_rules)
        if self.cardinality_rollup_family not in SKETCH_FAMILIES:
            raise ValueError(
                f"unknown sketch family "
                f"{self.cardinality_rollup_family!r} "
                "(tdigest | moments | compactor)")
        if not 2 <= self.sketch_moments_k <= 16:
            raise ValueError(
                f"sketch_moments_k {self.sketch_moments_k} out of range "
                "[2, 16] (the maxent solve conditions past 16)")
        cap = self.sketch_compactor_cap
        if cap and (cap < 8 or cap > 256 or cap & (cap - 1)):
            raise ValueError(
                f"sketch_compactor_cap {cap} must be a power of two "
                "in [8, 256] (or 0 for the built-in default)")
        lv = self.sketch_compactor_levels
        if lv and (lv < 4 or lv > 32):
            raise ValueError(
                f"sketch_compactor_levels {lv} out of range [4, 32] "
                "(or 0 for the built-in default)")
        if self.mesh_devices:
            # the families in play: the default, the rules', and the
            # rollup family while the guard is on
            check_mesh_families(
                {self.sketch_family_default} | {f for _, _, f in fams}
                | ({self.cardinality_rollup_family}
                   if self.cardinality_key_budget > 0 else set()))

        # the JAX package's clamps and boot-time cube validation
        if self.forward_timeout < 0:
            self.forward_timeout = 0.0
        if self.forward_max_retries < 0:
            self.forward_max_retries = 0
        if self.forward_retry_backoff < 0:
            self.forward_retry_backoff = 0.0
        if self.query_window_slots < 0:
            self.query_window_slots = 0
        if self.query_slot_seconds < 0:
            self.query_slot_seconds = 0.0
        if self.cube_group_budget < 0:
            self.cube_group_budget = 0
        if self.cube_dimensions:
            from veneur_tpu_torch.cubes import parse_dimensions
            parse_dimensions(self.cube_dimensions)
            if self.cube_group_budget <= 0:
                raise ValueError(
                    "cube_dimensions requires cube_group_budget > 0: "
                    "an unbounded cube is a cardinality explosion by "
                    "construction (set a budget; overflow degrades "
                    "into the accounted veneur.cube.other row)")

    def apply_defaults(self) -> None:
        """The JAX package's derived defaults and clamps
        (`config.go:114-134`): the aggregates, this host's name unless
        omit_empty_hostname, a positive interval.  Only the loaders call
        it, as in the JAX package; validate() then checks the result."""
        if not self.aggregates:
            self.aggregates = ["min", "max", "count"]
        if not self.hostname and not self.omit_empty_hostname:
            self.hostname = socket.gethostname()
        if self.interval <= 0:
            self.interval = 10.0
        if self.spool_fsync not in ("always", "rotate", "never"):
            raise ValueError(
                f"spool_fsync must be always|rotate|never, "
                f"got {self.spool_fsync!r}")
        if self.egress_queue_depth <= 0:
            self.egress_queue_depth = 128
        if self.egress_max_retries < 0:
            self.egress_max_retries = 0
        if self.egress_retry_backoff < 0:
            self.egress_retry_backoff = 0.0
        if self.egress_breaker_threshold < 1:
            self.egress_breaker_threshold = 1
        if self.egress_breaker_reset < 0:
            self.egress_breaker_reset = 0.0
        if self.egress_spool_replay_interval <= 0:
            self.egress_spool_replay_interval = 0.5
        if self.retention_max_bytes <= 0:
            self.retention_max_bytes = 256 * 1024 * 1024
        if self.retention_max_age < 0:
            self.retention_max_age = 0.0
        if self.metric_max_length <= 0:
            self.metric_max_length = 4096
        if self.ingest_reader_shards < 0:
            self.ingest_reader_shards = 0
        if self.ingest_reader_batch < 0:
            self.ingest_reader_batch = 0
        if self.ingest_ring_slots < 0:
            self.ingest_ring_slots = 0
        if self.ingest_simd not in ("auto", "scalar", "sse2", "avx2"):
            raise ValueError(
                f"ingest_simd must be auto|scalar|sse2|avx2, "
                f"got {self.ingest_simd!r}")
        if self.ingest_backend not in ("auto", "recvmmsg", "io_uring"):
            raise ValueError(
                f"ingest_backend must be auto|recvmmsg|io_uring, "
                f"got {self.ingest_backend!r}")
        if self.read_buffer_size_bytes <= 0:
            self.read_buffer_size_bytes = 2 * 1024 * 1024
        if self.span_channel_capacity <= 0:
            self.span_channel_capacity = 100

    @property
    def is_local(self) -> bool:
        """Server.IsLocal (server.go:1440-1442): local iff forwarding."""
        return self.forward_address != ""


SKETCH_FAMILIES = ("tdigest", "moments", "compactor")


def check_mesh_families(fams) -> None:
    """The sketch families a meshed tier serves: the t-digest and the
    moments family (whose maxent solve splits over the key axis, as in
    the JAX package).  The compactor family refuses a mesh (ValueError,
    as in the JAX package: its programs are single-device)."""
    if "compactor" in fams:
        raise ValueError(
            "the compactor sketch family is unsupported with a device "
            "mesh (mesh_devices > 0): its batched compaction program is "
            "single-device; drop one")


def parse_family_rules(default: str, rules) -> list[tuple]:
    """The family rules as (match glob, tenant, family) tuples, after
    checking them and the default: ValueError for an unknown family or
    a rule with neither `match` nor `tenant`."""
    out = []
    for fam in [default] + [r.get("family", "moments")
                            for r in rules if isinstance(r, dict)]:
        if fam not in SKETCH_FAMILIES:
            raise ValueError(f"unknown sketch family {fam!r} "
                             "(tdigest | moments | compactor)")
    for rule in rules:
        if not isinstance(rule, dict) \
                or not (rule.get("match") or rule.get("tenant")):
            raise ValueError(
                f"bad sketch_family rule {rule!r}: need "
                "{match: <glob> | tenant: <t>, family: "
                "tdigest|moments|compactor}")
        out.append((rule.get("match"), rule.get("tenant"),
                    rule.get("family", "moments")))
    return out


# option -> what it needs that this package does not have
_JAX = "JAX compilation, which this package does not use"
_PROFILING = "the profiling endpoints"
_TRACING = "flush tracing"
_SPANS = "SSF span ingest"
UNSUPPORTED = {
    "grpc_listen_addresses": "gRPC ingest listeners",
    "ssf_listen_addresses": _SPANS,
    "stats_address": "self-telemetry",
    **dict.fromkeys(("retention_tiers", "retention_dir",
                     "retention_max_bytes", "retention_max_age"),
                    "multi-resolution retention"),
    **dict.fromkeys(("distributed_coordinator", "distributed_num_processes",
                     "distributed_process_id"), "multi-host meshes"),
    "digest_float64": "float64 digest evaluation",
    **dict.fromkeys(("eager_device_sync", "compilation_cache_dir",
                     "prewarm_flush_shapes", "prewarm_depths"), _JAX),
    **dict.fromkeys(("num_span_workers", "trace_max_length_bytes",
                     "span_channel_capacity", "span_sinks",
                     "indicator_span_timer_name",
                     "objective_span_timer_name"), _SPANS),
    "flush_watchdog_missed_flushes": "the flush watchdog",
    "flush_upload_chunks": "chunked flush uploads",
    # the meshed flush always places each device's blocks directly
    "flush_presharded_staging": "the funnel placement of the meshed "
                                "dense build",
    **dict.fromkeys(("flush_resident_arenas", "flush_delta_chunk_keys",
                     "flush_delta_nbuf", "flush_resident_device_assembly"),
                    "device-resident arenas"),
    **dict.fromkeys(("enable_profiling", "profiling_cpu_hz",
                     "profiling_cpu_max_seconds",
                     "profiling_timeline_capacity", "profiling_use_pyspy",
                     "mutex_profile_fraction", "block_profile_rate"),
                    _PROFILING),
    **dict.fromkeys(("trace_flush_enabled", "trace_flush_sample_rate",
                     "trace_seed", "trace_ring_capacity"), _TRACING),
    "sentry_dsn": "crash reports to Sentry",
    **dict.fromkeys(("tls_key", "tls_certificate",
                     "tls_authority_certificate"),
                    "TLS listeners and forwarding"),
    "diagnostics_metrics_enabled": "self-telemetry",
    "sources": "openmetrics sources",
    "veneur_metrics_scopes": "self-telemetry",
    "veneur_metrics_additional_tags": "self-telemetry",
}


# -- the loader (`util/config/config.go:16-63`) -----------------------------

_LIST_FIELDS_OF_FLOAT = {"percentiles"}
# fields accepting Go-style duration strings ("10s", "500ms")
_DURATION_FIELDS = {"interval", "forward_timeout", "ingest_drain_interval",
                    "forward_retry_backoff", "spool_max_age",
                    "spool_replay_interval", "checkpoint_interval",
                    "egress_retry_backoff", "egress_breaker_reset",
                    "egress_spool_max_age",
                    "egress_spool_replay_interval",
                    "query_slot_seconds", "retention_max_age"}
_ENV_PREFIX = "VENEUR_"


def _coerce(key: str, value: Any) -> Any:
    if key in _DURATION_FIELDS:
        return parse_duration(value)
    if key in _LIST_FIELDS_OF_FLOAT:
        return [float(x) for x in value]
    return value


def _load(data: dict, strict: bool) -> Config:
    """YAML mapping -> Config, before the overrides, the defaults and
    validate()."""
    cfg = Config()
    known = {f.name for f in fields(Config)}
    for key, value in (data or {}).items():
        if key == "features":
            for fk, fv in (value or {}).items():
                if fk in ("enable_metric_sink_routing",
                          "diagnostics_metrics_enabled"):
                    setattr(cfg, fk, bool(fv))
                elif strict:
                    raise ValueError(f"unknown config field features.{fk}")
        elif key == "http":
            cfg.http_config_endpoint = bool((value or {}).get("config"))
        elif key in ("metric_sinks", "span_sinks"):
            setattr(cfg, key, [sink_mod.SinkSpec.from_dict(d)
                               for d in value])
        elif key == "metric_sink_routing":
            cfg.metric_sink_routing = [
                SinkRoutingConfig.from_dict(d) for d in value]
        elif key in known:
            setattr(cfg, key, _coerce(key, value))
        elif strict:
            raise ValueError(f"unknown config field {key!r}")
    return cfg


def load_config_dict(data: dict, strict: bool = False,
                     apply_defaults: bool = True) -> Config:
    """A parsed YAML mapping -> Config.  strict rejects unknown fields
    (ValueError); an unsupported option raises NotImplementedError."""
    cfg = _load(data, strict)
    if apply_defaults:
        cfg.apply_defaults()
    cfg.validate()
    return cfg


def _env_overrides(cfg: Config, environ: dict[str, str]) -> None:
    """envconfig-style overrides: VENEUR_<FIELDNAME> or
    VENEUR_<FIELD_NAME> (util/config:57-60)."""
    for f in fields(Config):
        env_key = _ENV_PREFIX + f.name.replace("_", "").upper()
        alt_key = _ENV_PREFIX + f.name.upper()
        raw = environ.get(env_key, environ.get(alt_key))
        if raw is None:
            continue
        cur = getattr(cfg, f.name)
        if isinstance(cur, bool):
            setattr(cfg, f.name, raw.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(cfg, f.name, int(raw))
        elif isinstance(cur, float):
            setattr(cfg, f.name, parse_duration(raw)
                    if f.name in _DURATION_FIELDS else float(raw))
        elif isinstance(cur, list):
            items = [x for x in raw.split(",") if x]
            if f.name in _LIST_FIELDS_OF_FLOAT:
                setattr(cfg, f.name, [float(x) for x in items])
            else:
                setattr(cfg, f.name, items)
        elif isinstance(cur, str):
            setattr(cfg, f.name, raw)


def read_config(path: str, strict: bool = False,
                environ: Optional[dict[str, str]] = None) -> Config:
    """File -> template expansion -> YAML -> env overrides -> defaults
    -> validate() (util/config/config.go:16-63)."""
    environ = environ if environ is not None else dict(os.environ)
    with open(path) as f:
        raw = f.read()
    data = yaml.safe_load(_expand(raw, environ)) or {}
    # the overrides land before the defaults, so that flags like
    # VENEUR_OMITEMPTYHOSTNAME take part in deriving them
    cfg = _load(data, strict)
    _env_overrides(cfg, environ)
    cfg.apply_defaults()
    cfg.validate()
    return cfg


def _expand(text: str, environ: dict[str, str]) -> str:
    """The template pass: $NAME / ${NAME} from the environment; an unset
    name stays as written."""
    def repl(m):
        name = m.group(1) or m.group(2)
        return environ.get(name, m.group(0))
    return re.sub(r"\$(?:\{(\w+)\}|(\w+))", repl, text)


def redacted_fields(cfg_obj, secret_fields: set, redact: bool = True) -> dict:
    """Dataclass config dump with the named secret fields redacted
    (util/string_secret.go:13-36); lists of objects dump as their
    strings."""
    out = {}
    for f in fields(type(cfg_obj)):
        v = getattr(cfg_obj, f.name)
        if redact and f.name in secret_fields and v:
            v = "REDACTED"
        if isinstance(v, list) and v and not isinstance(
                v[0], (str, int, float)):
            v = [str(x) for x in v]
        out[f.name] = v
    return out


def redacted_dict(cfg: Config, redact: bool = True) -> dict:
    """Server config dump; redact=False is the -print-secrets escape
    hatch."""
    return redacted_fields(cfg, {"sentry_dsn", "tls_key"}, redact)
