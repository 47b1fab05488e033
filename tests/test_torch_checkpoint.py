"""Crash durability in the port (`core/checkpoint.py`, `forward/spool.py`,
the dedup ledger's cut, the server's lifecycle) held against the JAX
package on the CPU:

  * the checkpoint file: the same (meta, arrays) written at the same
    clock make the same bytes in both packages; a file either package
    writes reads and restores in the other; a crash mid-write keeps the
    previous file; a corrupt or foreign-version file is a cold start;
  * `tests/test_checkpoint.py`'s cases through the port: every family's
    cut restores exactly (flushes compared value for value, percentiles
    bitwise on integer samples as test_torch_server.py compares them),
    mid-interval staged points survive, a restore needs a fresh arena;
    the server's checkpoint, crash and resume, the stale-marker skip,
    the shutdown checkpoint and the crash that skips it, the periodic
    loop, POST /checkpoint, SIGTERM through the command line; a port
    server restored after a crash flushes what a JAX server restored
    after the same crash flushes;
  * the dedup ledger: its window, snapshot and restore (the JAX
    ledger's snapshot for the same deliveries), the pause gate and the
    wait on an import in flight;
  * the spool: segment bytes equal to `veneur_tpu.forward.spool.
    encode_record`, a directory either package writes recovers in the
    other, `tests/test_spool.py`'s cases (its two failpoint cases as a
    monkeypatched OSError, with the same accounting), a client's spill
    and its replay exactly once against a port and a JAX global, a local
    that crashes with spooled chunks and revives, and ROADMAP C19: a
    JAX-written record above BATCH_BYTES replays in parts through the
    port where the JAX client is refused.
"""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import grpc
import numpy as np
import pytest

from tests.test_torch_forward import _deep_digest_fields
from tests.test_torch_server import (AGGS, PCTS, _assert_same_forwards,
                                     _assert_same_metrics, _forward_fields,
                                     _lines)
from veneur_tpu import config as jconfig
from veneur_tpu import ingest as jingest
from veneur_tpu.core import checkpoint as jckpt
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import client as jclient
from veneur_tpu.forward import spool as jspool
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sources import proxy as jproxy
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core import checkpoint as tckpt
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward import client as tclient
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward import spool as tspool
from veneur_tpu_torch.http_api import HttpApi
from veneur_tpu_torch.protocol import forward_pb2
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.sources import proxy as tproxy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_700_000_000


@pytest.fixture(autouse=True)
def _no_jax_engine(monkeypatch):
    """The JAX package's engine fails to build here; keep its build_dense
    and import_payload on their Python paths without a g++ attempt
    each."""
    def refuse():
        raise RuntimeError("the JAX engine is not built in these tests")
    monkeypatch.setattr(jingest, "load_library", refuse)


def _wait(cond, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _feed(agg, lines, fwds=(), pkg="torch"):
    p = (jparser if pkg == "jax" else tparser).Parser()
    smod = jsm if pkg == "jax" else tsm
    for line in lines:
        if line.startswith(b"_e"):
            continue
        if line.startswith(b"_sc"):
            agg.process_metric(p.parse_service_check(line))
        else:
            p.parse_metric(line, agg.process_metric)
    for f in fwds:
        agg.import_metric(smod.ForwardMetric(**f))


def _aggs(is_local, **kw):
    kw = dict(percentiles=PCTS, is_local=is_local,
              count_unique_timeseries=True, **kw)
    return (JAggregator(aggregates=jsm.parse_aggregates(AGGS), **kw),
            MetricAggregator(aggregates=tsm.parse_aggregates(AGGS),
                             device="cpu", **kw))


def _assert_flushes_equal(got, want, is_local):
    _assert_same_metrics(list(got.metrics), list(want.metrics),
                         integer=True)
    assert got.unique_ts == want.unique_ts
    if is_local:
        _assert_same_forwards(got.forward, want.forward)


# ---------------------------------------------------------------------------
# the checkpoint file
# ---------------------------------------------------------------------------

def test_the_same_cut_makes_the_same_file_in_both_packages(
        tmp_path, monkeypatch):
    """At a fixed clock (the meta's written_unix and the zip entries'
    dates), the JAX package's cut written by either package's
    write_checkpoint gives identical bytes, and each reads the other's
    file to the same meta and arrays."""
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    jagg, _ = _aggs(True)
    _feed(jagg, _lines(np.random.default_rng(1), True), pkg="jax")
    meta, arrays = jagg.checkpoint_state()
    wrote = {}
    for name, mod in (("jax", jckpt), ("torch", tckpt)):
        d = str(tmp_path / name)
        wrote[name] = mod.write_checkpoint(d, {"aggregator": meta}, arrays)
    blobs = [open(tckpt.checkpoint_path(str(tmp_path / n)), "rb").read()
             for n in ("jax", "torch")]
    assert blobs[0] == blobs[1] and wrote["jax"] == wrote["torch"]
    for reader, writer in ((tckpt, "jax"), (jckpt, "torch")):
        m2, a2 = reader.read_checkpoint(str(tmp_path / writer))
        assert m2["aggregator"] == json.loads(json.dumps(meta))
        assert m2["format_version"] == 1 and m2["written_unix"] == NOW
        assert set(a2) == set(arrays)
        for k, v in arrays.items():
            assert a2[k].dtype == v.dtype and np.array_equal(a2[k], v), k


@pytest.mark.parametrize("is_local", [True, False])
def test_files_restore_across_packages_both_ways(tmp_path, is_local):
    """A port aggregator's cut, written by the port, restores into a JAX
    aggregator; a JAX cut written by the JAX package restores into the
    port; all four flush what the uncut aggregators flush."""
    rng = np.random.default_rng(3 + is_local)
    jagg, tagg = _aggs(is_local)
    lines = _lines(rng, True)
    fwds = [] if is_local else _forward_fields(rng, True)
    _feed(jagg, lines, fwds, "jax")
    _feed(tagg, lines, fwds, "torch")
    tmeta, tarr = tagg.checkpoint_state()
    tckpt.write_checkpoint(str(tmp_path / "t"), {"aggregator": tmeta}, tarr)
    jmeta, jarr = jagg.checkpoint_state()
    jckpt.write_checkpoint(str(tmp_path / "j"), {"aggregator": jmeta}, jarr)
    jfrom_t, tfrom_j = _aggs(is_local)
    m, a = jckpt.read_checkpoint(str(tmp_path / "t"))
    jfrom_t.restore_state(m["aggregator"], a)
    m, a = tckpt.read_checkpoint(str(tmp_path / "j"))
    tfrom_j.restore_state(m["aggregator"], a)
    want = jagg.flush(is_local=is_local, now=NOW)
    for agg in (tagg, jfrom_t, tfrom_j):
        _assert_flushes_equal(agg.flush(is_local=is_local, now=NOW), want,
                              is_local)


def test_snapshot_restore_bit_parity_all_families(tmp_path):
    rng = np.random.default_rng(7)
    _, agg = _aggs(True)
    _feed(agg, _lines(rng, True), pkg="torch")
    agg.import_metric(tsm.ForwardMetric(
        name="t.imp", tags=[], kind="histogram", scope=0,
        digest_means=[1.0, 5.0, 9.0], digest_weights=[2.0, 1.0, 4.0],
        digest_min=0.5, digest_max=9.5, digest_rsum=3.25))
    meta, arrays = agg.checkpoint_state()
    tckpt.write_checkpoint(str(tmp_path), {"aggregator": meta}, arrays)
    m2, a2 = tckpt.read_checkpoint(str(tmp_path))
    _, fresh = _aggs(True)
    fresh.restore_state(m2["aggregator"], a2)
    assert (fresh.processed, fresh.imported) == (agg.processed,
                                                 agg.imported)
    for fam in MetricAggregator._FAMILIES:
        assert getattr(fresh, fam).kdict == getattr(agg, fam).kdict, fam
    _assert_flushes_equal(fresh.flush(is_local=True, now=NOW),
                          agg.flush(is_local=True, now=NOW), True)


def test_capture_under_the_lock_renders_what_the_arenas_cut():
    """The aggregator's cut is each arena's capture (under the lock)
    rendered after the lock: the same meta and arrays as each arena's
    one-step checkpoint_state, and the lock's hold is measured."""
    _, agg = _aggs(False)
    _feed(agg, _lines(np.random.default_rng(2), True), pkg="torch")
    meta, arrays = agg.checkpoint_state()
    assert agg.last_capture_s > 0.0
    for name in MetricAggregator._FAMILIES:
        fmeta, farr = getattr(agg, name).checkpoint_state()
        assert meta["families"][name] == fmeta
        for k, v in farr.items():
            assert np.array_equal(arrays[f"{name}/{k}"], v), (name, k)


def test_restore_requires_fresh_arena(tmp_path):
    _, agg = _aggs(True)
    _feed(agg, _lines(np.random.default_rng(4), True)[:40])
    meta, arrays = agg.checkpoint_state()
    _, dirty = _aggs(True)
    _feed(dirty, [b"other.c:1|c"])
    with pytest.raises(RuntimeError, match="fresh arena"):
        dirty.restore_state(meta, arrays)


def test_mid_interval_staged_digest_points_survive(tmp_path):
    """Staged but unflushed samples checkpoint as consolidated COO and
    restore exactly: the forwarded digests equal the uncut ones."""
    rng = np.random.default_rng(3)
    _, agg = _aggs(True)
    _feed(agg, [b"t.mid:%.4f|h" % v for v in rng.gamma(2.0, 10.0, 500)])
    meta, arrays = agg.checkpoint_state()
    tckpt.write_checkpoint(str(tmp_path), {"aggregator": meta}, arrays)
    m2, a2 = tckpt.read_checkpoint(str(tmp_path))
    _, fresh = _aggs(True)
    fresh.restore_state(m2["aggregator"], a2)
    got, want = fresh.flush(is_local=True), agg.flush(is_local=True)
    assert [(f.name, f.digest_means, f.digest_weights)
            for f in got.forward] == [(f.name, f.digest_means,
                                       f.digest_weights)
                                      for f in want.forward]


def test_crash_mid_write_keeps_previous_checkpoint(tmp_path):
    _, agg = _aggs(True)
    _feed(agg, _lines(np.random.default_rng(5), True)[:60])
    meta, arrays = agg.checkpoint_state()
    tckpt.write_checkpoint(str(tmp_path), {"aggregator": meta, "gen": 1},
                           arrays)
    # a crash mid-write of generation 2: the tempfile holds part of it
    # and was never renamed
    f, tmp = tckpt.open_checkpoint_tmp(str(tmp_path))
    f.write(b"partial garbage that never got renamed")
    f.close()
    for mod in (tckpt, jckpt):
        loaded = mod.read_checkpoint(str(tmp_path))
        assert loaded is not None and loaded[0]["gen"] == 1
    # a write that fails mid-way removes its tempfile
    f2, tmp2 = tckpt.open_checkpoint_tmp(str(tmp_path))
    tckpt.discard_checkpoint(f2, tmp2)
    assert not os.path.exists(tmp2)


def test_corrupt_or_foreign_checkpoint_is_a_cold_start(tmp_path,
                                                       monkeypatch):
    os.makedirs(str(tmp_path / "bad"))
    with open(tckpt.checkpoint_path(str(tmp_path / "bad")), "wb") as f:
        f.write(b"not an npz at all")
    assert tckpt.read_checkpoint(str(tmp_path / "bad")) is None
    assert tckpt.read_checkpoint(str(tmp_path / "missing")) is None
    monkeypatch.setattr(jckpt, "FORMAT_VERSION", 2)
    jckpt.write_checkpoint(str(tmp_path / "v2"), {"x": 1},
                           {"a": np.zeros(3)})
    assert tckpt.read_checkpoint(str(tmp_path / "v2")) is None


def test_flush_marker_round_trips_across_packages(tmp_path):
    tckpt.write_flush_marker(str(tmp_path), 7)
    assert jckpt.read_flush_marker(str(tmp_path))["flush_count"] == 7
    jckpt.write_flush_marker(str(tmp_path), 9)
    assert tckpt.read_flush_marker(str(tmp_path))["flush_count"] == 9
    assert tckpt.read_flush_marker(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the server: checkpoint, crash, resume
# ---------------------------------------------------------------------------

def _boot(pkg, ckpt, **kw):
    kw = dict(interval=3600.0, percentiles=PCTS, aggregates=AGGS,
              checkpoint_dir=str(ckpt), hostname="ckpt-test", **kw)
    if pkg == "jax":
        srv = JServer(jconfig.Config(native_ingest=False, **kw))
    else:
        srv = Server(tconfig.Config(**kw), device="cpu")
    srv.start()
    return srv


def _counters(res, prefix):
    return {m.name: m.value for m in res.metrics
            if m.type == "counter" and m.name.startswith(prefix)}


def test_server_checkpoint_and_crash_resume(tmp_path):
    a = _boot("torch", tmp_path / "ckpt")
    try:
        a.process_packet_buffer(b"\n".join([b"srv.c0:1|c"] * 20))
        a.flush()
        a.process_packet_buffer(b"\n".join([b"srv.c1:1|c"] * 7))
        assert a.checkpoint_now()
        st = a.checkpoint_stats
        assert st["writes"] == 1 and st["last_bytes"] > 0
        assert st["last_ms"] >= st["last_capture_ms"] > 0.0
    finally:
        a.crash()       # no shutdown checkpoint, no final flush
    assert a.checkpoint_stats["writes"] == 1
    b = _boot("torch", tmp_path / "ckpt")
    try:
        assert b.checkpoint_stats["restores"] == 1
        assert b.checkpoint_stats["age_ms"] >= 0.0
        assert b.flush_count == 1                   # the interval resumed
        res = b.aggregator.flush(is_local=False)
        assert _counters(res, "srv.") == {"srv.c1": 7.0}
    finally:
        b.shutdown()


def test_stale_checkpoint_skipped_after_later_flush(tmp_path):
    """A checkpoint written before a flush that completed does not
    restore its arenas (the flush delivered them); the interval count
    resumes from the marker and the skip is counted."""
    a = _boot("torch", tmp_path / "ckpt")
    try:
        a.process_packet_buffer(b"\n".join([b"st.c0:1|c"] * 9))
        assert a.checkpoint_now()          # checkpoint at interval 0
        a.flush()                          # flush 1 delivers st.c0
    finally:
        a.crash()
    b = _boot("torch", tmp_path / "ckpt")
    try:
        assert b.checkpoint_stats["restores"] == 0
        assert b.checkpoint_stats["stale_skips"] == 1
        assert b.flush_count == 1
        res = b.aggregator.flush(is_local=False)
        assert not [m for m in res.metrics if m.name == "st.c0"]
    finally:
        b.shutdown()


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_restored_flush_equals_the_jax_servers_after_the_same_crash(
        tmp_path, writer, reader):
    """One flushed interval, a second half-ingested, checkpoint, crash:
    the server revived from that directory flushes what a JAX server
    given the same traffic and the same crash flushes (its revival from
    its own checkpoint)."""
    rng = np.random.default_rng(11)
    first = _lines(rng, True) + [b"t.once:4|c"]
    second = _lines(rng, True)
    fwds = _forward_fields(rng, True)
    ref = _boot("jax", tmp_path / "ref")
    src = _boot(writer, tmp_path / "src")
    try:
        for srv, pkg in ((ref, "jax"), (src, writer)):
            _feed(srv.aggregator, first, pkg=pkg)
            srv.flush()
            _feed(srv.aggregator, second, fwds, pkg)
            assert srv.checkpoint_now()
    finally:
        ref.crash()
        src.crash()
    ref2 = _boot("jax", tmp_path / "ref")
    got2 = _boot(reader, tmp_path / "src")
    try:
        assert got2.checkpoint_stats["restores"] == 1
        assert got2.flush_count == ref2.flush_count == 1
        want = ref2.aggregator.flush(is_local=False, now=NOW)
        got = got2.aggregator.flush(is_local=False, now=NOW)
        _assert_same_metrics(list(got.metrics), list(want.metrics),
                             integer=True)
    finally:
        ref2.shutdown()
        got2.shutdown()


def test_shutdown_checkpoints_after_the_final_flush(tmp_path):
    """shutdown() flushes, then checkpoints the (empty) cut after it; a
    revival restores the flush count and emits nothing twice.  (The
    flush marker goes into an existing directory, as in the JAX
    package: it is created by the first checkpoint.)"""
    os.makedirs(str(tmp_path / "ckpt"))
    a = _boot("torch", tmp_path / "ckpt", flush_on_shutdown=True)
    a.process_packet_buffer(b"sd.c:5|c")
    a.shutdown()
    assert a.flush_count == 1 and a.checkpoint_stats["writes"] == 1
    assert tckpt.read_flush_marker(str(tmp_path / "ckpt"))[
        "flush_count"] == 1
    b = _boot("torch", tmp_path / "ckpt")
    try:
        assert b.checkpoint_stats["restores"] == 1 and b.flush_count == 1
        assert not _counters(b.aggregator.flush(is_local=False), "sd.")
    finally:
        b.shutdown()


def test_checkpoint_loop_writes_every_interval(tmp_path):
    a = _boot("torch", tmp_path / "ckpt", checkpoint_interval=0.05)
    try:
        _wait(lambda: a.checkpoint_stats["writes"] >= 2, "periodic writes")
    finally:
        a.crash()


def test_an_incompatible_checkpoint_cold_starts_and_a_failed_restore_raises(
        tmp_path, monkeypatch):
    a = _boot("torch", tmp_path / "ckpt")
    try:
        a.process_packet_buffer(b"in.h:3|h\nin.s:a|s")
        assert a.checkpoint_now()
    finally:
        a.crash()
    b = _boot("torch", tmp_path / "ckpt", tdigest_compression=50.0)
    try:
        assert b.checkpoint_stats["restores"] == 0
        assert not b.aggregator.digests.kdict
    finally:
        b.crash()

    def broken(self, meta, arrays):
        raise ValueError("disk returned garbage mid-rebuild")
    from veneur_tpu_torch.core import arena as tarena
    monkeypatch.setattr(tarena.SetArena, "_restore_arrays", broken)
    c = Server(tconfig.Config(interval=3600.0,
                              checkpoint_dir=str(tmp_path / "ckpt")),
               device="cpu")
    with pytest.raises(ValueError, match="mid-rebuild"):
        c.start()
    c.shutdown()


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def test_post_checkpoint_and_quitquitquit_write_checkpoints(tmp_path):
    srv = _boot("torch", tmp_path / "ckpt", http_flush_endpoint=True,
                http_quit=True)
    api = HttpApi(srv, "127.0.0.1:0")
    api.start()
    try:
        srv.process_packet_buffer(b"http.c:2|c")
        code, body = _post(api.address[1], "/checkpoint")
        assert (code, json.loads(body)) == (200, {"ok": True, "writes": 1})
        assert _post(api.address[1], "/quitquitquit")[0] == 200
        _wait(lambda: srv._closed and srv.checkpoint_stats["writes"] == 2,
              "the shutdown checkpoint after /quitquitquit")
    finally:
        api.stop()
        srv.shutdown()


def test_graceful_restart_drain_writes_the_shutdown_checkpoint(tmp_path):
    """SIGUSR2's handoff (request, then drain) ends in shutdown(), which
    checkpoints, as the JAX package's handoff does."""
    srv = _boot("torch", tmp_path / "ckpt",
                statsd_listen_addresses=["udp://127.0.0.1:0"],
                native_ingest=False)
    srv.process_packet_buffer(b"g.c:1|c")
    srv.request_graceful_restart()
    srv.graceful_restart_drain(grace_s=0.05)
    assert srv.checkpoint_stats["writes"] == 1
    m, _ = tckpt.read_checkpoint(str(tmp_path / "ckpt"))
    assert m["aggregator"]["processed"] == 1


def test_sigterm_through_the_command_line_writes_the_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    port_file = tmp_path / "ports.json"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "statsd_listen_addresses: [\"udp://127.0.0.1:0\"]\n"
        "native_ingest: false\ninterval: 3600s\nhostname: cli\n"
        f"checkpoint_dir: {ckpt}\nport_file: {port_file}\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f",
         str(cfg), "-device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        _wait(lambda: port_file.exists() and port_file.read_text(),
              "the port file", timeout=60.0)
        udp = json.loads(port_file.read_text())["statsd"][0][1]
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"cli.c:3|c", (udp[0], udp[1]))
        s.close()
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    meta, arrays = tckpt.read_checkpoint(str(ckpt))
    names = list(arrays["counters/key_names"])
    assert meta["hostname"] == "cli" and "cli.c" in names


# ---------------------------------------------------------------------------
# the dedup ledger
# ---------------------------------------------------------------------------

def test_dedup_duplicate_waits_for_inflight_original():
    """A duplicate delivery is not acked while the original import of
    the same chunk is in flight; if the original fails, the duplicate
    performs the import."""
    led = tproxy.DedupLedger()
    release = threading.Event()
    outcome = {}

    def slow_failing_import():
        release.wait(5.0)
        raise RuntimeError("original import dies")

    def original():
        try:
            led.run_once(("s", 1, 0), slow_failing_import)
        except RuntimeError:
            outcome["original"] = "failed"

    t = threading.Thread(target=original)
    t.start()
    time.sleep(0.1)
    done = []

    def duplicate():
        outcome["dup_flag"] = led.run_once(("s", 1, 0),
                                           lambda: done.append(1))[1]

    t2 = threading.Thread(target=duplicate)
    t2.start()
    time.sleep(0.1)
    assert not done
    release.set()
    t.join(5.0)
    t2.join(5.0)
    assert outcome["original"] == "failed"
    assert outcome["dup_flag"] is False and done == [1]
    assert led.duplicates == 0


def test_dedup_ledger_window_snapshot_and_restore_match_jax():
    leds = {"jax": jproxy.DedupLedger(window=16),
            "torch": tproxy.DedupLedger(window=16)}
    for led in leds.values():
        hits = []
        for i in range(5):
            led.run_once(("src", 1, i), lambda: hits.append(1))
        assert led.run_once(("src", 1, 2), lambda: hits.append(1))[1]
        led.run_once(None, lambda: hits.append(1))
        led.run_once(None, lambda: hits.append(1))
        for i in range(30):
            led.run_once(("other", 3, i), lambda: None)
        assert len(hits) == 7
    snap = leds["torch"].snapshot()
    assert snap == leds["jax"].snapshot()
    assert leds["torch"].stats() == leds["jax"].stats()
    # either package's snapshot restores into the other's ledger
    for cls, state in ((tproxy.DedupLedger, leds["jax"].snapshot()),
                       (jproxy.DedupLedger, snap)):
        led2 = cls(window=16)
        led2.restore(json.loads(json.dumps(state)))
        assert led2.run_once(("src", 1, 4), lambda: 1 / 0)[1]
        for i in range(40):
            led2.run_once(("src", 2, i), lambda: None)
        assert not led2.run_once(("src", 1, 4), lambda: None)[1]


def test_paused_gate_drains_imports_in_flight_and_holds_new_ones():
    led = tproxy.DedupLedger()
    started, release = threading.Event(), threading.Event()
    order = []

    def slow():
        started.set()
        release.wait(5.0)
        order.append("inflight")

    t = threading.Thread(target=led.run_once, args=(("s", 1, 0), slow))
    t.start()
    started.wait(5.0)
    def take_cut():
        with led.paused():
            order.append("cut")
            time.sleep(0.1)
    cut = threading.Thread(target=take_cut)
    cut.start()
    time.sleep(0.1)
    assert order == []                 # the cut waits for the import
    release.set()
    t.join(5.0)
    time.sleep(0.02)
    late = threading.Thread(target=led.run_once,
                            args=(None, lambda: order.append("late")))
    late.start()
    cut.join(5.0)
    late.join(5.0)
    assert order == ["inflight", "cut", "late"]


# ---------------------------------------------------------------------------
# the spool
# ---------------------------------------------------------------------------

def _mk(tmp_path, name="spool", **kw):
    kw.setdefault("max_age_s", 60.0)
    kw.setdefault("replay_interval_s", 0.02)
    return tspool.ForwardSpool(str(tmp_path / name), **kw)


def _drain(sp, sink):
    return sp.replay_once(lambda rec, body: sink.append((rec, body)))


@pytest.mark.parametrize("ident,body,n,tid,sid,ts", [
    (("host#aa", 7, 3), b"payload-bytes", 42, 5, 9, 1_700_000_000_123),
    (("", 0, 0), b"", 0, 0, 0, 0),
    (("héte#ff", 2**63, 2**32 - 1), bytes(range(256)) * 9, 2000,
     2**64 - 1, 1, 2**40)])
def test_segment_record_bytes_equal_the_jax_packages(ident, body, n, tid,
                                                     sid, ts):
    want = jspool.encode_record(ident, body, n, tid, sid, ts)
    assert tspool.encode_record(ident, body, n, tid, sid, ts) == want
    plen, crc = struct.unpack_from("<II", want, 0)
    assert plen == len(want) - 8 and crc == zlib.crc32(want[8:])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_spool_directory_recovers_in_the_other_package(tmp_path, writer,
                                                         monkeypatch):
    """Appends in one package, a crash (no drain), recovery in the
    other: the same records, identities, trace ids and bodies in order,
    and the segment files byte-equal to those the other package writes
    for the same records at the same clock."""
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    mods = {"jax": jspool, "torch": tspool}
    reader = "torch" if writer == "jax" else "jax"
    recs = [(("s#1", 1, i), b"body%d" % i * (i + 1), i + 1)
            for i in range(12)]
    dirs = {}
    for pkg in (writer, reader):
        sp = mods[pkg].ForwardSpool(str(tmp_path / pkg), max_age_s=60.0,
                                    segment_max_bytes=96)
        for ident, body, n in recs:
            assert sp.append(ident, body, n, trace_id=n, span_id=2 * n)
        sp.close(drain=False)
        dirs[pkg] = sp.dir
    segs = sorted(os.listdir(dirs[writer]))
    assert len(segs) > 1 and segs == sorted(os.listdir(dirs[reader]))
    for seg in segs:
        a = open(os.path.join(dirs[writer], seg), "rb").read()
        b = open(os.path.join(dirs[reader], seg), "rb").read()
        assert a == b, seg
    sp2 = mods[reader].ForwardSpool(dirs[writer], max_age_s=60.0)
    assert sp2.pending_records() == len(recs)
    assert sp2.stats()["recovered_points"] == sum(n for _, _, n in recs)
    got = []
    sp2.replay_once(lambda rec, body: got.append((rec, body)))
    assert [(r.ident, b, r.n_metrics, r.trace_id, r.span_id)
            for r, b in got] == [(i, b, n, n, 2 * n) for i, b, n in recs]
    assert sp2.pending_records() == 0
    sp2.close()
    assert not [f for f in os.listdir(dirs[writer]) if f.endswith(".seg")]


def test_append_peek_read_roundtrip(tmp_path):
    sp = _mk(tmp_path)
    ident = ("host#aa", 7, 3)
    assert sp.append(ident, b"payload-bytes", 42, trace_id=5, span_id=9)
    rec = sp.peek(1)[0]
    assert rec.ident == ident and rec.n_metrics == 42
    assert (rec.trace_id, rec.span_id) == (5, 9)
    assert sp.read_body(rec) == b"payload-bytes"
    st = sp.stats()
    assert st["spilled"] == 1 and st["spilled_points"] == 42
    assert st["pending_records"] == 1 and st["pending_bytes"] > 0
    js = jspool.ForwardSpool(str(tmp_path / "j"), max_age_s=60.0)
    assert set(js.stats()) == set(st)
    js.close()
    sp.close()


def test_recovery_reindexes_pending_records(tmp_path):
    sp = _mk(tmp_path)
    for i in range(5):
        sp.append(("s#1", 1, i), f"body{i}".encode(), i + 1)
    sp.close(drain=False)
    sp2 = _mk(tmp_path)
    assert sp2.pending_records() == 5
    got = []
    _drain(sp2, got)
    assert [r.ident for r, _ in got] == [("s#1", 1, i) for i in range(5)]
    assert [b for _, b in got] == [f"body{i}".encode() for i in range(5)]
    assert sp2.pending_records() == 0
    sp2.close()


def test_replayed_segments_are_deleted_from_disk(tmp_path):
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"x", 1)
    _drain(sp, [])
    sp.close()
    assert [f for f in os.listdir(sp.dir) if f.endswith(".seg")] == []
    sp2 = _mk(tmp_path)
    assert sp2.pending_records() == 0
    sp2.close()


def _one_segment(sp):
    segs = [f for f in os.listdir(sp.dir) if f.endswith(".seg")]
    assert len(segs) == 1
    return os.path.join(sp.dir, segs[0])


def test_crc_damage_rejects_record_not_file(tmp_path):
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"first-record", 1)
    sp.append(("s#1", 1, 1), b"second-record", 1)
    path = _one_segment(sp)
    sp.close(drain=False)
    with open(path, "r+b") as f:
        data = f.read()
        plen, _ = struct.unpack_from("<II", data, 0)
        f.seek(8 + plen - 3)
        f.write(b"\xff")
    sp2 = _mk(tmp_path)
    assert sp2.crc_rejected == 1 and sp2.pending_records() == 1
    assert sp2.peek(1)[0].ident == ("s#1", 1, 1)
    sp2.close()


def test_torn_final_record_is_skipped_and_truncated(tmp_path):
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"good-record", 3)
    path = _one_segment(sp)
    sp.close(drain=False)
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(struct.pack("<II", 4096, 0) + b"partial")
    sp2 = _mk(tmp_path)
    assert sp2.torn_records == 1 and sp2.pending_records() == 1
    assert os.path.getsize(path) == good_size
    got = []
    _drain(sp2, got)
    assert got[0][1] == b"good-record"
    sp2.close()


def test_max_bytes_evicts_oldest_with_accounting(tmp_path):
    sp = _mk(tmp_path, max_bytes=512, segment_max_bytes=128)
    for i in range(8):
        sp.append(("s#1", 1, i), b"x" * 100, 10)
    st = sp.stats()
    assert st["pending_bytes"] <= 512 and st["expired"] > 0
    assert st["expired_points"] == st["expired"] * 10
    assert sp.peek(1)[0].ident[2] > 0
    sp.close()


def test_max_age_expiry_accounts_every_point(tmp_path):
    sp = _mk(tmp_path, max_age_s=0.05)
    sp.append(("s#1", 1, 0), b"x", 7)
    sp.append(("s#1", 1, 1), b"y", 5)
    time.sleep(0.08)
    assert sp.expire_now() == 2
    st = sp.stats()
    assert st["expired"] == 2 and st["expired_points"] == 12
    assert st["pending_records"] == 0
    assert st["spilled"] == st["replayed"] + st["expired"] + st["dropped"]
    sp.close()


def test_retry_safe_failure_keeps_record_at_head(tmp_path):
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"x", 1)

    def down(rec, body):
        raise tspool.RetryableReplayError("still down")

    assert sp.replay_once(down) == 0 and sp.pending_records() == 1
    got = []
    _drain(sp, got)
    assert len(got) == 1 and sp.pending_records() == 0
    sp.close()


def test_terminal_replay_failure_drops_with_accounting(tmp_path):
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"x", 4)
    sp.append(("s#1", 1, 1), b"y", 2)

    def poisoned(rec, body):
        if rec.ident[2] == 0:
            raise ValueError("UNIMPLEMENTED peer")

    assert sp.replay_once(poisoned) == 1
    st = sp.stats()
    assert st["dropped"] == 1 and st["dropped_points"] == 4
    assert st["replayed"] == 1 and st["replayed_points"] == 2
    sp.close()


def test_disk_error_on_append_drops_with_accounting(tmp_path, monkeypatch):
    """The JAX package's `spool.io` failpoint on the append, as a real
    OSError: the append reports the loss (the caller counts the
    metrics), nothing half-written stays pending, and the spool works
    once the fault clears."""
    sp = _mk(tmp_path)
    real = tspool.open_segment
    fail = [True]

    def flaky(path):
        if fail.pop() if fail else False:
            raise OSError(28, "No space left on device")
        return real(path)

    monkeypatch.setattr(tspool, "open_segment", flaky)
    assert not sp.append(("s#1", 1, 0), b"x", 9)
    assert sp.io_errors == 1 and sp.pending_records() == 0
    assert sp.append(("s#1", 1, 1), b"y", 1)
    st = sp.stats()
    assert (st["spilled"], st["io_errors"], st["dropped"]) == (1, 1, 0)
    sp.close()


def test_disk_error_on_replay_read_drops_that_record(tmp_path,
                                                     monkeypatch):
    """The replay half of the same edge: an unreadable head record is
    dropped with accounting and the queue does not wedge."""
    sp = _mk(tmp_path)
    sp.append(("s#1", 1, 0), b"x", 3)
    sp.append(("s#1", 1, 1), b"y", 2)
    real = sp.read_body
    fail = [True]

    def flaky(rec):
        if fail.pop() if fail else False:
            raise OSError(5, "Input/output error")
        return real(rec)

    monkeypatch.setattr(sp, "read_body", flaky)
    got = []
    _drain(sp, got)
    st = sp.stats()
    assert st["dropped"] == 1 and st["dropped_points"] == 3
    assert st["io_errors"] == 1
    assert [r.ident for r, _ in got] == [("s#1", 1, 1)]
    sp.close()


# ---------------------------------------------------------------------------
# the client's spill and replay
# ---------------------------------------------------------------------------

def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class _Edge:
    """One package's import server on a given port, over its own
    aggregator and dedup ledger."""

    def __init__(self, pkg, port):
        if pkg == "jax":
            self.agg = JAggregator(percentiles=PCTS, is_local=False)
            self.agg._native_import = False
            self.dedup = jproxy.DedupLedger()
            self.server = jproxy.GrpcImportServer(
                f"127.0.0.1:{port}", self.agg.import_metric,
                import_payload=self.agg.import_payload, dedup=self.dedup)
        else:
            self.agg = MetricAggregator(percentiles=PCTS, is_local=False,
                                        device="cpu")
            self.dedup = tproxy.DedupLedger()
            self.server = tproxy.GrpcImportServer(
                f"127.0.0.1:{port}", self.agg.import_metric,
                self.agg.import_payload, dedup=self.dedup)
        self.server.start()

    def stop(self):
        if isinstance(self.server, tproxy.GrpcImportServer):
            self.server.stop()
        else:
            self.server.server.stop(1.0).wait()


def _counter_fms(n):
    return [tsm.ForwardMetric(name=f"sp.c{i}", tags=[], kind="counter",
                              scope=2, counter_value=i + 1)
            for i in range(n)]


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_client_spills_then_replays_exactly_once(tmp_path, server_pkg):
    """A client facing a dead address spills its chunk (no exception:
    deferred, not dropped); the replayer delivers it once the import
    server appears; the same chunk re-delivered under its recorded
    identity merges once at the ledger."""
    port = _free_port()
    spool = _mk(tmp_path)
    client = tclient.ForwardClient(
        f"127.0.0.1:{port}", timeout_s=5.0,
        retry=tclient.RetryPolicy(attempts=2, backoff_base_s=0.01),
        spool=spool, source="tst-local")
    edge = None
    try:
        client.send(_counter_fms(5), epoch=1)
        assert client.stats()["spilled"] == 5
        assert client.stats()["dropped"] == 0
        assert client.spool_stats()["pending_records"] == 1
        rec = spool.peek(1)[0]
        assert rec.ident[0].startswith("tst-local#") and rec.ident[1] == 1
        dup_body = spool.read_body(rec)
        edge = _Edge(server_pkg, port)
        _wait(lambda: spool.stats()["pending_records"] == 0, "the replay")
        st = spool.stats()
        assert st["replayed"] == 1 and st["replayed_points"] == 5
        assert edge.server.imported_count == 5
        client._replay_send(rec, dup_body)
        assert edge.dedup.stats()["duplicates"] == 1
        assert edge.server.imported_count == 5
        res = edge.agg.flush(is_local=False)
        assert {m.name: m.value for m in res.metrics} == {
            f"sp.c{i}": float(i + 1) for i in range(5)}
    finally:
        client.close()
        if edge is not None:
            edge.stop()


def test_an_ambiguous_failure_or_no_spool_still_drops(tmp_path):
    """Only provably undelivered, identified chunks spill: a client
    without a spool drops and raises as before."""
    client = tclient.ForwardClient(
        f"127.0.0.1:{_free_port()}", timeout_s=2.0,
        retry=tclient.RetryPolicy(attempts=1))
    try:
        with pytest.raises(grpc.RpcError):
            client.send(_counter_fms(3), epoch=1)
        assert (client.stats()["dropped"], client.stats()["spilled"]) == (
            3, 0)
        assert client.spool_stats() is None
    finally:
        client.close()


def test_c19_a_jax_record_above_the_byte_budget_replays_in_parts(tmp_path):
    """ROADMAP C19.  The JAX client bounds a chunk by count alone (C14),
    so its spool can hold a record above the peer's 4 MiB receive
    limit: 2,000 digests of 300 centroids, 12 MB.  Replayed verbatim,
    the JAX client is refused RESOURCE_EXHAUSTED, which it counts
    retry-safe, so the record stays at the head and blocks the records
    behind it until it expires.  The port's replay sends it in
    BATCH_BYTES parts under identities derived from the recorded one:
    all 2,000 arrive, and a second replay merges once."""
    fields = _deep_digest_fields(np.random.default_rng(5), 2000, 300)
    pbs = [tconvert.to_pb(tsm.ForwardMetric(**f)) for f in fields]
    body = forward_pb2.MetricList(metrics=pbs).SerializeToString()
    assert len(body) > 2.5 * tclient.PEER_RECEIVE_LIMIT
    jsp = jspool.ForwardSpool(str(tmp_path / "spool"), max_age_s=600.0)
    assert jsp.append(("jax-local#01", 4, 0), body, len(pbs))
    jsp.append(("jax-local#01", 4, 1), forward_pb2.MetricList(
        metrics=[tconvert.to_pb(f) for f in _counter_fms(2)]
    ).SerializeToString(), 2)
    jsp.close(drain=False)
    edge = _Edge("torch", _free_port())
    addr = f"127.0.0.1:{edge.server.port}"
    try:
        jc = jclient.ForwardClient(addr, timeout_s=10.0)
        rec = jspool.ForwardSpool(str(tmp_path / "spool"),
                                  max_age_s=600.0)
        head = rec.peek(1)[0]
        with pytest.raises(jspool.RetryableReplayError,
                           match="RESOURCE_EXHAUSTED"):
            jc._replay_send(head, rec.read_body(head))
        assert rec.replay_once(jc._replay_send) == 0
        assert rec.pending_records() == 2          # the head wedges
        rec.close(drain=False)
        jc.close()
        assert edge.server.imported_count == 0
        spool = _mk(tmp_path)
        client = tclient.ForwardClient(addr, timeout_s=10.0, spool=spool)
        try:
            _wait(lambda: spool.stats()["pending_records"] == 0,
                  "the replay in parts", timeout=60.0)
            st = spool.stats()
            assert (st["replayed"], st["replayed_points"],
                    st["dropped"]) == (2, 2002, 0)
            assert edge.server.imported_count == 2002
            parts = len(tclient.chunk_pbs(pbs))
            assert edge.dedup.stats()["recorded"] == parts + 1
            # the same record replayed again merges once
            client._replay_send(head, body)
            assert edge.dedup.stats()["duplicates"] == parts
            assert edge.server.imported_count == 2002
        finally:
            client.close()
    finally:
        edge.stop()


def test_a_crashed_local_revives_its_spool_and_the_global_merges_once(
        tmp_path):
    """A port local with spool_dir forwards to a global that is not up:
    its interval spills.  It crashes; a new local on the same spool_dir
    recovers the records; the global comes up and the replayer delivers
    them.  The global's flush equals the same interval forwarded in
    process, the spool ends empty and without segment files, and the
    ledger merged each chunk once."""
    rng = np.random.default_rng(21)
    lines = _lines(rng, True)
    port = _free_port()
    kw = dict(forward_address=f"127.0.0.1:{port}", interval=3600.0,
              percentiles=PCTS, aggregates=AGGS, hostname="loc",
              spool_dir=str(tmp_path / "spool"), forward_max_retries=1,
              forward_retry_backoff=0.01, forward_timeout=5.0,
              forward_deadline_retry_safe=True, spool_replay_interval=0.05)
    a = Server(tconfig.Config(**kw), device="cpu")
    a.start()
    try:
        _feed(a.aggregator, lines)
        a.flush()
        assert a.wait_forwards(30.0)
        st = a.forwarder.spool_stats()
        assert st["spilled"] > 0 and st["pending_records"] >= 1
        assert a.forwarder.stats()["dropped"] == 0
        spilled = st["spilled_points"]
    finally:
        a.crash()
    ref = MetricAggregator(percentiles=PCTS, is_local=False, device="cpu",
                           aggregates=tsm.parse_aggregates(AGGS))
    direct = MetricAggregator(percentiles=PCTS, is_local=True, device="cpu",
                              aggregates=tsm.parse_aggregates(AGGS))
    _feed(direct, lines)
    ref.import_metrics(direct.flush(is_local=True).forward)
    b = Server(tconfig.Config(**kw), device="cpu")
    sink = tsimple.ChannelMetricSink()
    glob = Server(tconfig.Config(grpc_address=f"127.0.0.1:{port}",
                                 interval=3600.0, percentiles=PCTS,
                                 aggregates=AGGS, hostname="g"),
                  extra_metric_sinks=[sink], device="cpu")
    try:
        b.start()
        assert b.forwarder.spool_stats()["recovered_points"] == spilled
        glob.start()
        _wait(lambda: b.forwarder.spool_stats()["pending_records"] == 0,
              "the revived local's replay", timeout=60.0)
        st = b.forwarder.spool_stats()
        assert st["replayed_points"] == spilled and st["dropped"] == 0
        assert not [f for f in os.listdir(str(tmp_path / "spool"))
                    if f.endswith(".seg")]
        assert glob.dedup.stats()["duplicates"] == 0
        assert glob.dedup.stats()["recorded"] == st["replayed"]
        got = glob.aggregator.flush(is_local=False, now=NOW)
        want = ref.flush(is_local=False, now=NOW)
        _assert_same_metrics(list(got.metrics), list(want.metrics),
                             integer=True)
    finally:
        b.shutdown()
        glob.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_c20_a_replay_cut_off_by_close_keeps_its_record(tmp_path, pkg):
    """ROADMAP C20.  A crash closes the spool while its replayer is in
    an RPC (a replay waits for the channel to be ready, up to the
    forward timeout), then closes the channel under it: the RPC fails
    CANCELLED, which is not retry-safe.  The JAX spool then drops the
    record (and deletes its segment), so the revived process has
    nothing to replay; the port's keeps it."""
    mod = jspool if pkg == "jax" else tspool
    sp = mod.ForwardSpool(str(tmp_path / "spool"), max_age_s=60.0)
    sp.append(("s#1", 1, 0), b"x", 4)

    def cut_off(rec, body):
        sp._stop.set()                  # close() began under the send
        raise ValueError("Channel closed!")

    sp.replay_once(cut_off)
    sp.close(drain=False)
    revived = mod.ForwardSpool(str(tmp_path / "spool"), max_age_s=60.0)
    kept = 0 if pkg == "jax" else 1
    assert (sp.stats()["dropped"], revived.pending_records()) == (
        1 - kept, kept)
    revived.close()
