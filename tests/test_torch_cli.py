"""The port's command line held against the JAX package's.

  * the loaders: `read_config` and `load_config_dict` give the same
    field values as the JAX package's on the same YAML (durations as
    strings, `$VAR` / `${VAR}` expansion, `VENEUR_*` overrides of every
    field type, `features`, `http`, sinks), strict and not; the sink
    specs compare by kind, name and config.  An unsupported option
    raises NotImplementedError from the file, from the environment and
    from `Config(...)`; `native_ingest` loads either way, as there;
  * the two example configs refuse as they are and, with the options
    they name removed, load to the JAX package's values;
  * `apply_defaults` as the JAX package's;
  * `cli/veneur.py`'s flags, exit codes and config dump (the JAX CLI's
    dump);
  * the lifecycle: one flush an interval from `start()` alone or with
    `serve()`, on wall-clock multiples with `synchronize_with_interval`,
    an idempotent `shutdown()`, the gated HTTP routes, the zero-drop
    SIGUSR2 handoff with the Python readers (with the native readers:
    `test_torch_ingest.py`);
  * the jsonl, localfile and debug sinks' output equal to the JAX sinks';
  * one run of `python -m veneur_tpu_torch.cli.veneur -device cpu`: port
    file, UDP lines, POST /flush, jsonl rows equal to a JAX `Server` fed
    the same lines (counters, gauges, sets and aggregates exact,
    percentiles bitwise on integer samples, as in
    `test_torch_server.py::test_global_tier_emits_what_jax_emits`), then
    SIGTERM, exit 0 and the final flush written.

Waits are on counts (lines processed, queued bytes, files written), each
with a deadline; every subprocess has its own timeout.
"""

import dataclasses
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import yaml

from chip_smoke import _datagrams, _jsonl_frames, udp_queues

from veneur_tpu import config as jconfig
from veneur_tpu import http_api as jhttp
from veneur_tpu.cli import veneur as jcli
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import crash
from veneur_tpu_torch.cli import veneur as tcli
from veneur_tpu_torch.cli.portfile import write_port_file
from veneur_tpu_torch.core import server as server_mod
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.http_api import HttpApi
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_ENV = {"DATADOG_API_KEY": "k", "SPLUNK_HEC_TOKEN": "t"}

SERVED_YAML = """\
statsd_listen_addresses: ["udp://127.0.0.1:0", "tcp://${BIND}:0"]
interval: "$IVL"
forward_timeout: 1m30s
forward_retry_backoff: 250ms
query_window_slots: 4
query_slot_seconds: "2s"
percentiles: [0.5, 0.99]
aggregates: [min, max, count, sum]
hostname: "h-${HOSTTAG}"
extend_tags: ["a:b"]
http_address: "127.0.0.1:0"
port_file: /tmp/ports.json
http: {config: true}
http_quit: true
http_flush_endpoint: true
omit_empty_hostname: true
synchronize_with_interval: true
num_workers: 3
debug: true
flush_on_shutdown: true
read_buffer_size_bytes: 8388608
num_readers: 2
sketch_family_rules: [{match: "m.*", family: moments}]
metric_sinks:
  - kind: jsonl
    name: frames
    config: {path: "${OUT}/frames.jsonl"}
  - kind: localfile
    config: {flush_file: /tmp/flush.tsv}
features:
  enable_metric_sink_routing: false
  diagnostics_metrics_enabled: false
native_ingest: false
"""
SERVED_ENV = {
    "IVL": "5s", "BIND": "127.0.0.1", "HOSTTAG": "x", "OUT": "/tmp/out",
    # one override of each field type: bool, int, float, duration, list
    # of floats, list (by its underscored name), str
    "VENEUR_FLUSHONSHUTDOWN": "false", "VENEUR_NUMREADERS": "3",
    "VENEUR_TDIGESTCOMPRESSION": "50", "VENEUR_FORWARDTIMEOUT": "2s",
    "VENEUR_PERCENTILES": "0.25,0.75", "VENEUR_EXTEND_TAGS": "c:d,e:f",
    "VENEUR_HTTPADDRESS": "127.0.0.1:9"}


def _sinks(specs):
    return [(s.kind, s.name, s.config) for s in specs]


def _specs(specs):
    """Sink specs with their per-sink limits (the tag matchers as
    fields)."""
    return [(s.kind, s.name, s.config, s.max_name_length, s.max_tag_length,
             s.max_tags, [(t.kind, t.value, t.unset) for t in s.strip_tags],
             s.add_tags) for s in specs]


def _matchers(ms):
    return [((m.name.kind, m.name.value),
             [(t.kind, t.value, t.unset) for t in m.tags]) for m in ms]


def _routing(rules):
    return [(r.name, _matchers(r.match), r.matched, r.not_matched)
            for r in rules]


def _assert_same_fields(tcfg, jcfg):
    """Every field of the port's Config equal to the JAX Config's."""
    for f in dataclasses.fields(tconfig.Config):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("metric_sinks", "span_sinks"):
            got, want = _specs(got), _specs(want)
        elif f.name == "metric_sink_routing":
            got, want = _routing(got), _routing(want)
        assert got == want, (f.name, got, want)


def _read_both(tmp_path, text, strict, environ):
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    return (tconfig.read_config(str(path), strict=strict, environ=environ),
            jconfig.read_config(str(path), strict=strict, environ=environ))


# -- the loaders -------------------------------------------------------------

@pytest.mark.parametrize("strict", [True, False])
def test_read_config_matches_jax(tmp_path, strict):
    tcfg, jcfg = _read_both(tmp_path, SERVED_YAML, strict, SERVED_ENV)
    _assert_same_fields(tcfg, jcfg)
    assert tcfg.interval == 5.0 and tcfg.forward_timeout == 2.0
    assert tcfg.forward_retry_backoff == 0.25
    assert tcfg.statsd_listen_addresses[1] == "tcp://127.0.0.1:0"
    assert tcfg.hostname == "h-x"
    assert tcfg.percentiles == [0.25, 0.75]
    assert tcfg.extend_tags == ["c:d", "e:f"]
    assert (tcfg.num_readers, tcfg.tdigest_compression) == (3, 50.0)
    assert not tcfg.flush_on_shutdown
    assert tcfg.http_address == "127.0.0.1:9"
    assert tcfg.http_config_endpoint and tcfg.debug
    assert _sinks(tcfg.metric_sinks) == [
        ("jsonl", "frames", {"path": "/tmp/out/frames.jsonl"}),
        ("localfile", "localfile", {"flush_file": "/tmp/flush.tsv"})]


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("extra", [{"bogus": 1},
                                   {"features": {"bogus": True}}])
def test_load_config_dict_matches_jax(strict, extra):
    data = {**yaml.safe_load(jconfig._expand(SERVED_YAML, SERVED_ENV)),
            **extra}
    if strict:
        with pytest.raises(ValueError) as want:
            jconfig.load_config_dict(data, strict=True)
        with pytest.raises(ValueError) as got:
            tconfig.load_config_dict(data, strict=True)
        assert str(got.value) == str(want.value)
        assert "unknown config field" in str(got.value)
        return
    _assert_same_fields(tconfig.load_config_dict(data),
                        jconfig.load_config_dict(data))
    for defaults in (True, False):
        tcfg = tconfig.load_config_dict(data, apply_defaults=defaults)
        jcfg = jconfig.load_config_dict(data, apply_defaults=defaults)
        _assert_same_fields(tcfg, jcfg)


@pytest.mark.parametrize("option,text,env,kwargs", [
    ("indicator_span_timer_name", "indicator_span_timer_name: ind",
     {"VENEUR_INDICATORSPANTIMERNAME": "ind"},
     {"indicator_span_timer_name": "ind"}),
    ("stats_address", "stats_address: 127.0.0.1:8126",
     {"VENEUR_STATS_ADDRESS": "127.0.0.1:8126"},
     {"stats_address": "127.0.0.1:8126"}),
    ("flush_delta_chunk_keys", "flush_delta_chunk_keys: 5",
     {"VENEUR_FLUSHDELTACHUNKKEYS": "5"}, {"flush_delta_chunk_keys": 5}),
    ("retention_max_age", "retention_max_age: 60s",
     {"VENEUR_RETENTIONMAXAGE": "1m"}, {"retention_max_age": 60.0}),
    ("sentry_dsn", "sentry_dsn: https://k@sentry.example/1",
     {"VENEUR_SENTRYDSN": "https://k@sentry.example/1"},
     {"sentry_dsn": "https://k@sentry.example/1"}),
    ("diagnostics_metrics_enabled",
     "features: {diagnostics_metrics_enabled: true}",
     {"VENEUR_DIAGNOSTICSMETRICSENABLED": "true"},
     {"diagnostics_metrics_enabled": True}),
    ("ssf_listen_addresses", "ssf_listen_addresses: [udp://0.0.0.0:8128]",
     {"VENEUR_SSFLISTENADDRESSES": "udp://0.0.0.0:8128"},
     {"ssf_listen_addresses": ["udp://0.0.0.0:8128"]})])
def test_unsupported_options_refuse_from_file_env_and_code(
        tmp_path, option, text, env, kwargs):
    path = tmp_path / "cfg.yaml"
    path.write_text(text + "\n")
    with pytest.raises(NotImplementedError, match=option):
        tconfig.read_config(str(path), environ={})
    path.write_text("interval: 10s\n")
    with pytest.raises(NotImplementedError, match=option):
        tconfig.read_config(str(path), environ=env)
    with pytest.raises(NotImplementedError, match=option):
        tconfig.Config(**kwargs)
    with pytest.raises(NotImplementedError, match=option):
        tconfig.load_config_dict(yaml.safe_load(text))
    # the JAX package takes each of them
    jconfig.read_config(str(path), environ=env)


@pytest.mark.parametrize("text,env,native", [
    ("native_ingest: true", {}, True),
    ("interval: 10s", {"VENEUR_NATIVEINGEST": "true"}, True),
    ("interval: 10s", {"VENEUR_NATIVE_INGEST": "1"}, True),
    ("native_ingest: false", {}, False),
    ("interval: 10s", {"VENEUR_NATIVEINGEST": "false"}, False),
    ("interval: 10s", {}, True)])
def test_native_ingest_passes_only_when_false(tmp_path, text, env, native):
    """native_ingest (the native ingest engine, served since it was
    ported) loads from the file and from either override as the JAX
    package loads it; an option still outside the port refuses from
    both (device-resident arenas, ROADMAP A12)."""
    path = tmp_path / "cfg.yaml"
    path.write_text(text + "\n")
    for strict in (True, False):
        tcfg, jcfg = _read_both(tmp_path, text + "\n", strict, env)
        _assert_same_fields(tcfg, jcfg)
        assert tcfg.native_ingest is native
        with pytest.raises(NotImplementedError,
                           match="flush_resident_arenas"):
            tconfig.read_config(
                str(path), strict=strict,
                environ={**env, "VENEUR_FLUSHRESIDENTARENAS": "true"})
    assert tconfig.Config(native_ingest=False).native_ingest is False


def _strip_until_it_loads(text: str, strict: bool) -> tuple[str, list]:
    """Remove the option each NotImplementedError names until the port
    loads the text; -> (the stripped YAML, the options in order)."""
    data = yaml.safe_load(text)
    removed = []
    for _ in range(200):
        stripped = yaml.safe_dump(data, sort_keys=False)
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"strip-{os.getpid()}.yaml")
        with open(path, "w") as f:
            f.write(stripped)
        try:
            tconfig.read_config(path, strict=strict, environ=EXAMPLE_ENV)
            return stripped, removed
        except NotImplementedError as e:
            name = re.search(r"option (\w+)=", str(e)).group(1)
        finally:
            os.unlink(path)
        removed.append(name)
        if name in data:
            del data[name]
        else:
            del data["features"][name]
    raise AssertionError(f"still refused after removing {removed}")


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("name,expect", [
    ("example.yaml", {"grpc_listen_addresses", "ssf_listen_addresses",
                      "stats_address", "diagnostics_metrics_enabled",
                      "flush_watchdog_missed_flushes", "span_sinks",
                      "sources"}),
    ("example_host.yaml", {"ssf_listen_addresses", "stats_address",
                           "flush_watchdog_missed_flushes"})])
def test_example_configs_refuse_then_match_jax_once_stripped(
        tmp_path, strict, name, expect):
    with open(os.path.join(REPO, name)) as f:
        text = f.read()
    path = tmp_path / name
    path.write_text(text)
    with pytest.raises(NotImplementedError) as e:
        tconfig.read_config(str(path), strict=strict, environ=EXAMPLE_ENV)
    assert re.search(r"option (\w+)=", str(e.value)).group(1) in expect
    stripped, removed = _strip_until_it_loads(text, strict)
    assert expect <= set(removed), removed
    tcfg, jcfg = _read_both(tmp_path, stripped, strict, EXAMPLE_ENV)
    _assert_same_fields(tcfg, jcfg)
    assert tcfg.http_config_endpoint == (name == "example.yaml")
    if name == "example.yaml":
        # the egress options load as the JAX package loads them: the
        # four sinks, the routing rule and the tag exclusions
        assert [s.name for s in tcfg.metric_sinks] == [
            "datadog", "cortex", "s3-archive", "blackhole"]
        assert tcfg.enable_metric_sink_routing
        assert [r.name for r in tcfg.metric_sink_routing] == [
            "archive-everything"]
        assert tcfg.tags_exclude == ["nonce", "host_env|datadog"]


@pytest.mark.parametrize("omit", [True, False])
def test_apply_defaults_matches_jax(omit):
    tcfg = tconfig.Config(omit_empty_hostname=omit)
    jcfg = jconfig.Config(omit_empty_hostname=omit)
    assert tcfg.hostname == "" and tcfg.aggregates == jcfg.aggregates
    tcfg.apply_defaults()
    jcfg.apply_defaults()
    _assert_same_fields(tcfg, jcfg)
    assert tcfg.hostname == ("" if omit else socket.gethostname())
    # the clamps, through the loader
    data = {"omit_empty_hostname": omit, "interval": 0, "aggregates": [],
            "metric_max_length": 0, "read_buffer_size_bytes": 0,
            "query_window_slots": -1, "egress_queue_depth": 0,
            "span_channel_capacity": 0, "forward_timeout": -1,
            "retention_max_bytes": 0, "egress_spool_replay_interval": 0}
    tcfg = tconfig.load_config_dict(data)
    _assert_same_fields(tcfg, jconfig.load_config_dict(data))
    assert (tcfg.interval, tcfg.egress_queue_depth) == (10.0, 128)
    with pytest.raises(ValueError, match="spool_fsync"):
        tconfig.load_config_dict({"spool_fsync": "sometimes"})


# -- the command line --------------------------------------------------------

def test_cli_version(capsys):
    assert tcli.main(["-version"]) == 0
    assert capsys.readouterr().out.startswith("veneur-tpu-torch ")


@pytest.mark.parametrize("argv,message", [
    ([], "You must specify a config file"),
    (["-f", "/nonexistent/veneur.yaml"], "error reading config file:"),
    (["-f", "{bad}"], "error reading config file: invalid duration"),
    (["-f", "{bad}", "-validate-config"],
     "error reading config file: invalid duration")])
def test_cli_refuses_a_missing_or_bad_config(tmp_path, capsys, argv,
                                             message):
    bad = tmp_path / "bad.yaml"
    bad.write_text("interval: [not, a, duration]\n")
    argv = [str(bad) if a == "{bad}" else a for a in argv]
    assert jcli.main(argv) == 1
    want = capsys.readouterr().err
    assert tcli.main(argv) == 1
    got = capsys.readouterr().err
    assert got.startswith(message) and got == want


@pytest.mark.parametrize("flag", ["-validate-config",
                                  "-validate-config-strict"])
@pytest.mark.parametrize("secrets", [False, True])
def test_cli_validate_dumps_what_the_jax_cli_dumps(tmp_path, capsys,
                                                   monkeypatch, flag,
                                                   secrets):
    for k, v in SERVED_ENV.items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "cfg.yaml"
    path.write_text(SERVED_YAML)
    argv = ["-f", str(path), flag] + (["-print-secrets"] if secrets else [])
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv) == 0
    got = capsys.readouterr().out
    assert got.endswith("config valid\n")
    assert "native_ingest: false\n" in want
    assert got == want


def test_cli_refuses_an_unported_option_and_a_missing_card(tmp_path,
                                                           capsys):
    """example.yaml refuses (grpc_listen_addresses first, since
    native_ingest is served); without
    `-device` the boot wants a CUDA device and, lacking one, exits 1
    without writing its port file (in a subprocess: a boot installs
    the crash hooks)."""
    assert tcli.main(["-f", os.path.join(REPO, "example.yaml"),
                      "-validate-config"]) == 1
    assert "option grpc_listen_addresses=" in capsys.readouterr().err
    assert tcli.build_parser().parse_args([]).device == "cuda"
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default boots")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"port_file: {tmp_path / 'ports.json'}\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f",
         str(cfg)], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "server boot failed" in proc.stderr
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "ports.json").exists()


def test_port_file_is_written_whole(tmp_path):
    path = str(tmp_path / "ports.json")
    write_port_file(path, {"statsd": [["udp", ["127.0.0.1", 5]]]})
    assert json.load(open(path)) == {"statsd": [["udp", ["127.0.0.1", 5]]],
                                     "pid": os.getpid()}
    assert os.listdir(tmp_path) == ["ports.json"]


def test_crash_hook_reports_a_dying_thread():
    seen = []
    before = crash.panics_detected
    crash.install(terminate=False, on_panic=seen.append)
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="doomed")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        crash.uninstall()
    assert crash.panics_detected == before + 1
    assert seen[0]["thread"] == "doomed"
    assert seen[0]["type"] == "ZeroDivisionError"
    assert threading.excepthook is not None


# -- the lifecycle -----------------------------------------------------------

class _FakeClock:
    """time.time() for the ticker, advanced by the waits and flushes."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now


class _FakeEvent(threading.Event):
    def __init__(self, clock):
        super().__init__()
        self.clock = clock
        self.waits = []

    def wait(self, timeout=None):
        self.waits.append(timeout)
        self.clock.now += timeout
        return self.is_set()


def test_ticker_synchronizes_with_the_interval(monkeypatch):
    """synchronize_with_interval: the ticker first waits for the next
    wall-clock multiple of the interval, then flushes once an interval
    on that grid, however long a flush takes."""
    srv = Server(tconfig.Config(interval=1.0, synchronize_with_interval=True),
                 device="cpu")
    clock = _FakeClock(1000.75)
    monkeypatch.setattr(server_mod, "time", clock)
    srv._shutdown = _FakeEvent(clock)
    flushed = []

    def flush():
        flushed.append(clock.now)
        clock.now += 0.3            # the flush's own time
        if len(flushed) == 3:
            srv._shutdown.set()

    srv.flush = flush
    srv._ticker()
    assert srv._shutdown.waits[0] == pytest.approx(0.25)
    assert flushed == pytest.approx([1002.0, 1003.0, 1004.0])
    assert srv._shutdown.waits[1:] == pytest.approx([1.0, 0.7, 0.7, 0.7])


def test_start_and_serve_flush_once_an_interval():
    """start() runs the ticker and serve() blocks on it: the k-th flush
    comes k intervals after start() at the earliest, which a second
    flush loop would break."""
    interval = 0.2
    srv = Server(tconfig.Config(interval=interval), device="cpu")
    stamps = []
    inner = srv.flush

    def flush():
        stamps.append(time.monotonic())
        return inner()

    srv.flush = flush
    t0 = time.monotonic()
    srv.start()
    server = threading.Thread(target=srv.serve, daemon=True)
    server.start()
    try:
        deadline = time.monotonic() + 30
        while len(stamps) < 5:
            assert time.monotonic() < deadline, stamps
            time.sleep(0.01)
    finally:
        srv.stop_serving()
        server.join(timeout=10)
        srv.shutdown()
    assert not server.is_alive()
    for k, stamp in enumerate(stamps[:5], 1):
        assert stamp - t0 >= k * interval - 1e-3, (k, stamps)


def _udp_lines(srv, lines, per=20):
    port = srv.statsd_addrs[0][1][1]
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(0, len(lines), per):
        sock.sendto(b"\n".join(lines[i:i + per]), ("127.0.0.1", port))
    sock.close()


def _wait_processed(srv, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while srv.aggregator.processed < n:
        assert time.monotonic() < deadline, (srv.aggregator.processed, n)
        time.sleep(0.005)


def test_shutdown_is_idempotent_after_quitquitquit():
    """POST /quitquitquit shuts down on a thread and the CLI's finally
    shuts down again: the interval reaches the sink exactly once."""
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"], interval=3600.0,
        http_quit=True, flush_on_shutdown=True), extra_metric_sinks=[sink],
        device="cpu")
    srv.start()
    api = HttpApi(srv, "127.0.0.1:0")
    api.start()
    try:
        _udp_lines(srv, [b"q.hits:1|c"] * 100)
        _wait_processed(srv, 100)
        req = urllib.request.Request(
            f"http://127.0.0.1:{api.address[1]}/quitquitquit", data=b"",
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.read() == b"terminating\n"
        srv.serve()             # returns once the shutdown began
        srv.shutdown()
        srv.shutdown()
    finally:
        api.stop()
    batches = []
    while not sink.queue.empty():
        batches.append(sink.queue.get())
    assert [[(m.name, m.value) for m in b] for b in batches] == [
        [("q.hits", 100.0)]]
    assert srv.flush_count == 1


def _http(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("on", [True, False])
def test_gated_http_routes(on):
    kw = dict(percentiles=[0.5], hostname="h", http_quit=on,
              http_config_endpoint=on, http_flush_endpoint=on,
              metric_sinks=[{"kind": "blackhole", "name": "bh"}])
    srv = Server(tconfig.Config(**kw), device="cpu")
    jcfg = jconfig.Config(**kw)
    api = HttpApi(srv, "127.0.0.1:0")
    api.start()
    port = api.address[1]
    try:
        for path, body in (
                ("/config/json", jhttp.config_json_body),
                ("/config/yaml", jhttp.config_yaml_body)):
            code, got = _http(port, path)
            assert code == (200 if on else 404)
            if on:
                want = body(jconfig.redacted_dict(jcfg)).decode()
                if path == "/config/json":
                    want = json.loads(want)
                    assert want["native_ingest"] is True
                    assert json.loads(got) == want
                else:
                    assert got.decode() == want
        srv.process_packet_buffer(b"g.hits:2|c")
        code, got = _http(port, "/flush", "POST")
        assert code == (200 if on else 404)
        if on:
            assert json.loads(got) == {"flush_count": 1}
        for path, method in (("/debug/trace", "GET"), ("/debug/vars", "GET"),
                             ("/config/json", "POST")):
            assert _http(port, path, method)[0] == 404
        # POST /checkpoint is gated as POST /flush; without a
        # checkpoint_dir the write fails and answers 500, as in the JAX
        # package
        code, got = _http(port, "/checkpoint", "POST")
        assert code == (500 if on else 404)
        if on:
            assert json.loads(got) == {"ok": False, "writes": 0}
        code, got = _http(port, "/quitquitquit", "POST")
        assert (code, got) == ((200, b"terminating\n") if on
                               else (404, b"not found\n"))
        if on:
            deadline = time.monotonic() + 30
            while not srv._closed:
                assert time.monotonic() < deadline
                time.sleep(0.01)
    finally:
        api.stop()
        srv.shutdown()


def test_graceful_restart_zero_drop_python_readers():
    """tests/test_restart.py's handoff with the port: under a steady
    UDP stream the replacement joins the SO_REUSEPORT group, the old
    server drains by the SIGUSR2 path (request, then drain) and
    final-flushes; every sent increment lands on exactly one of the
    two."""
    cfg = dict(interval=600.0, flush_on_shutdown=True,
               read_buffer_size_bytes=8 << 20, num_readers=2,
               native_ingest=False)
    sink_a, sink_b = tsimple.ChannelMetricSink(), tsimple.ChannelMetricSink()
    srv_a = Server(tconfig.Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"], hostname="a", **cfg),
        extra_metric_sinks=[sink_a], device="cpu")
    srv_a.start()
    port = srv_a.statsd_addrs[0][1][1]
    sent = 0
    stop = threading.Event()
    lock = threading.Lock()

    def sender():
        nonlocal sent
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not stop.is_set():
            for _ in range(10):
                s.sendto(b"grp.hits:1|c", ("127.0.0.1", port))
            with lock:
                sent += 10
            time.sleep(0.002)       # paced: measure the handoff, not shed

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    srv_b = None
    try:
        _wait_processed(srv_a, 200)
        srv_b = Server(tconfig.Config(
            statsd_listen_addresses=[f"udp://127.0.0.1:{port}"],
            hostname="b", **cfg), extra_metric_sinks=[sink_b], device="cpu")
        srv_b.start()
        srv_a.request_graceful_restart()
        srv_a.graceful_restart_drain(grace_s=0.2)
        _wait_processed(srv_b, 200)     # the stream now lands on b
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    with lock:
        total = sent
    got_a = sum(m.value for batch in _drain(sink_a) for m in batch
                if m.name == "grp.hits")
    try:
        _wait_processed(srv_b, total - got_a)
        srv_b.flush()
    finally:
        srv_b.shutdown()
    got_b = sum(m.value for batch in _drain(sink_b) for m in batch
                if m.name == "grp.hits")
    assert got_a > 0 and got_b > 0
    assert got_a + got_b == total, (got_a, got_b, total)


def _drain(sink):
    out = []
    while not sink.queue.empty():
        out.append(sink.queue.get())
    return out


# -- the sinks ---------------------------------------------------------------

def _inter_metrics(mod):
    return [mod.InterMetric(name="s.hits", timestamp=1700000000,
                            value=12.5, tags=["a:b", "c"], type="counter"),
            mod.InterMetric(name="s.temp", timestamp=1700000000,
                            value=-0.25, tags=[], type="gauge",
                            hostname="box"),
            mod.InterMetric(name="s.lat.50percentile", timestamp=1700000001,
                            value=3.0, tags=["x:y"], type="gauge")]


def test_file_and_log_sinks_write_what_the_jax_sinks_write(tmp_path,
                                                           caplog):
    kw = dict(hostname="cfg-host", interval=4.0)
    tcfg = tconfig.Config(**kw)
    jcfg = jconfig.Config(native_ingest=False, **kw)
    for kind, key in (("jsonl", "path"), ("localfile", "flush_file")):
        out = {}
        for side, simple, cfg, mod in (("port", tsimple, tcfg, tsm),
                                       ("jax", jsimple, jcfg, jsm)):
            spec_mod = (tconfig.sink_mod if side == "port"
                        else jconfig.sink_mod)
            path = str(tmp_path / f"{side}.{kind}")
            spec = spec_mod.SinkSpec(kind=kind, config={key: path})
            sink = {"jsonl": simple.JsonLinesMetricSink,
                    "localfile": simple.LocalFileMetricSink}[kind](spec, cfg)
            for _ in range(2):
                res = sink.flush(_inter_metrics(mod))
                assert res.flushed == 3
            out[side] = open(path).read()
        assert out["port"] == out["jax"], kind
        assert out["port"].count("\n") == (8 if kind == "jsonl" else 6)
    assert tsimple.encode_tsv_row(_inter_metrics(tsm)[0], "h", 4.0,
                                  "2024-01-01") == \
        jsimple.encode_tsv_row(_inter_metrics(jsm)[0], "h", 4.0,
                               "2024-01-01")
    logs = {}
    for side, simple, mod, name in (
            ("port", tsimple, tsm, "veneur_tpu_torch.sinks"),
            ("jax", jsimple, jsm, "veneur_tpu.sinks")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            sink = simple.DebugMetricSink()
            sink.flush(_inter_metrics(mod))
            sink.flush_other_samples(["an event"])
        logs[side] = [r.getMessage() for r in caplog.records
                      if r.name == name]
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 4


def test_server_builds_the_simple_sinks_from_the_config(tmp_path):
    path = str(tmp_path / "frames.jsonl")
    srv = Server(tconfig.load_config_dict({
        "hostname": "h", "metric_sinks": [
            {"kind": "jsonl", "config": {"path": path}},
            {"kind": "debug"},
            {"kind": "localfile",
             "config": {"flush_file": str(tmp_path / "f.tsv")}}]}),
        device="cpu")
    assert [s.kind() for s in srv.metric_sinks] == ["jsonl", "debug",
                                                    "localfile"]
    srv.process_packet_buffer(b"k.hits:3|c")
    srv.flush()
    assert srv.egress.settle(timeout_s=10.0)
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["name"] == "k.hits" and rows[0]["value"] == 3.0
    assert rows[-1] == {"flush": True, "metrics": 1}
    # a sink's limits load (the egress lanes apply them); a span sink
    # is still outside the port (ROADMAP A15)
    assert tconfig.load_config_dict({"metric_sinks": [
        {"kind": "jsonl", "max_tags": 3}]}).metric_sinks[0].max_tags == 3
    with pytest.raises(NotImplementedError, match="span_sinks"):
        tconfig.load_config_dict({"span_sinks": [{"kind": "debug"}]})


# -- the command line end to end --------------------------------------------

def _e2e_lines(rng) -> list[bytes]:
    """Integer-valued histograms (every sample of a key at the same
    rate), counters (some sampled), gauges written once, sets."""
    lines = []
    for k in range(24):
        rate = b"|@0.5" if k % 3 == 0 else b""
        kind = b"h" if k % 2 == 0 else b"ms"
        for v in rng.integers(0, 1000, 64):
            lines.append(b"e.h%d:%d|%s%s|#svc:w" % (k, v, kind, rate))
    for k in range(30):
        rate = b"|@0.25" if k % 5 == 0 else b""
        lines += [b"e.c%d:%d|c%s" % (k, rng.integers(1, 9), rate)] * 8
    lines += [b"e.g%d:%d|g" % (k, rng.integers(-50, 50)) for k in range(10)]
    for k in range(5):
        lines += [b"e.s%d:m%d|s" % (k, m) for m in range(40)]
    return [lines[i] for i in rng.permutation(len(lines))]


def _wait_for(pred, proc, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if proc.poll() is not None:
            out, err = proc.communicate(timeout=30)
            raise AssertionError(f"the CLI exited {proc.returncode} while "
                                 f"waiting for {what}:\n{out}\n{err}")
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_cli_end_to_end_matches_the_jax_server(tmp_path):
    pcts, aggs = [0.5, 0.9, 0.99], ["min", "max", "count", "sum", "avg"]
    ports, frames_path = tmp_path / "ports.json", tmp_path / "frames.jsonl"
    cfg_path = tmp_path / "cli.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "statsd_listen_addresses": ["udp://127.0.0.1:0"], "num_readers": 2,
        "read_buffer_size_bytes": 8 << 20, "http_address": "127.0.0.1:0",
        "port_file": str(ports), "http_flush_endpoint": True,
        "interval": "3600s", "flush_on_shutdown": True, "hostname": "cli",
        "percentiles": pcts, "aggregates": aggs,
        "metric_sinks": [{"kind": "jsonl",
                          "config": {"path": str(frames_path)}}]}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f",
         str(cfg_path), "-device", "cpu"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(ports.exists, proc, "the port file")
        info = json.loads(ports.read_text())
        assert info["pid"] == proc.pid and info["hostname"] == "cli"
        (scheme, (host, udp_port)), = info["statsd"]
        http_port = info["http"][1]
        rng = np.random.default_rng(42)
        dgrams = _datagrams(_e2e_lines(rng), limit=1400)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for d in dgrams:
            _wait_for(lambda: udp_queues(udp_port)[0] < 64 << 10, proc,
                      "room in the receive queues")
            sock.sendto(d, (host, udp_port))
        _wait_for(lambda: udp_queues(udp_port)[0] == 0, proc,
                  "empty receive queues")
        assert udp_queues(udp_port)[1] == 0, "datagrams dropped"
        code, body = _http(http_port, "/flush", "POST")
        assert (code, json.loads(body)) == (200, {"flush_count": 1})
        # the final flush's interval
        sock.sendto(b"e.last:7|c", (host, udp_port))
        _wait_for(lambda: udp_queues(udp_port)[0] == 0, proc,
                  "the last datagram")
        sock.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    frames = _jsonl_frames(frames_path)
    assert len(frames) == 2, [len(f) for f in frames]
    assert frames[1] == {("e.last", (), "counter"): 7.0}
    got = frames[0]

    sink = jsimple.ChannelMetricSink()
    jsrv = JServer(jconfig.Config(native_ingest=False, hostname="cli",
                                  interval=3600.0, percentiles=pcts,
                                  aggregates=aggs),
                   extra_metric_sinks=[sink])
    jsrv.start()
    try:
        for d in dgrams:
            jsrv.process_packet_buffer(d)
        jsrv.flush()
        jsrv.egress.settle(timeout_s=10.0)
        want = {(m.name, tuple(m.tags), m.type): m.value
                for batch in _drain(sink) for m in batch}
    finally:
        jsrv.shutdown()
    assert set(got) == set(want)
    assert any(k[0].endswith("99percentile") for k in got)
    for key, w in want.items():
        assert got[key] == w, (key, got[key], w)
