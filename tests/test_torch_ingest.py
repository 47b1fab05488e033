"""The port's native ingest engine (`veneur_tpu_torch/ingest/`) held
against the JAX package's Python chain, on the CPU.

The JAX package's own engine does not build here, so the reference is
its Python chain: its `Parser` and `MetricAggregator.process_metric`,
its `build_dense` (numpy) and its `import_pb_batch`.

  * the port's copy of the engine builds (g++ and the io_uring probe)
    and differs from `native/ingest_engine.cpp` only in its io_uring
    guard; `metro64` is `sketches.hll.hash64`; the intern-key hash and
    the tokenizer agree across every SIMD mode the CPU has;
  * parser parity: every line of `test_torch_server._PARSER_CORPUS`,
    valid, invalid, multi-value and implicit-tag lines and a seeded fuzz
    through the engine (`ingest` + `drain`) against the JAX `Parser`,
    under each SIMD mode;
  * the drain adapter: flushes equal to the JAX Python path (t-digest
    percentiles bitwise on integer samples, moments and compactor
    quantiles within the family tests' rules, everything else exact)
    and to the port's own Python path bitwise, local and global, with
    family dispatch, cube rollups and unique timeseries; intern GC and
    row-GC revalidation;
  * `build_dense`'s native fill bitwise the port's numpy builder and the
    JAX `build_dense`, weighted and uniform, f32 and bf16 staging, on
    2 x 2 and 2 x 3 meshes, above and below the fill's threshold;
  * `import_payload` through the wire scan equal to `import_pb_batch`
    and to the JAX import on JAX-encoded payloads, and a malformed
    payload refused as the protobuf path refuses it;
  * `route_metric_list`, the proxy's router, as the JAX binding returns
    it from the same engine;
  * the server over real UDP through the C++ readers (and through the
    Python readers with `native_ingest: false`), the flush's cut, the
    reader options, a shutdown that loses no queued datagram, the
    SIGUSR2 handoff, a failed build that makes start() raise, and a
    line that is not UTF-8 costing that line alone (ROADMAP C17).
"""

import difflib
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_server import _PARSER_CORPUS
from veneur_tpu import config as jconfig
from veneur_tpu import ingest as jingest
from veneur_tpu.core import arena as jarena
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.protocol import forward_pb2 as jforward_pb2
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu.util import tagging as jtagging
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import ingest
from veneur_tpu_torch.core import arena as tarena
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ingest import _build
from veneur_tpu_torch.parallel.mesh import make_mesh
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.sketches import hll as thll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum"]
# the family tests' rules: a moments quantile within FLUSH_RULE of its
# key's span (test_torch_moments.py), a compactor read-off within
# READOFF_REL relative (test_torch_compactor.py)
FLUSH_RULE = 1e-3
READOFF_REL = 1e-6
RULES = [{"match": "mom.*", "family": "moments"},
         {"match": "c.*", "family": "compactor"}]
DIMS = [{"tags": ["endpoint"], "match": "cq.*"}]
SIMD = [m for m in ("scalar", "sse2", "avx2") if ingest.simd_supported(m)]


@pytest.fixture(autouse=True)
def _no_jax_engine(monkeypatch):
    """The JAX package's engine fails to build here; keep its
    build_dense and import_payload on their Python paths without a g++
    attempt each."""
    def refuse():
        raise RuntimeError("the JAX engine is not built in these tests")
    monkeypatch.setattr(jingest, "load_library", refuse)


# -- the build ----------------------------------------------------------------

def test_engine_builds_with_the_probe_and_metro64_is_hash64():
    rec = _build.build()
    assert rec["path"].exists() and rec["probe"] == _build.probe_pbuf_ring()
    rng = np.random.default_rng(7)
    cases = [b"", b"a", b"ab", b"abc", b"user@example.com"]
    cases += [bytes(rng.integers(0, 256, n, dtype=np.uint8))
              for n in (1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 100)]
    for m in cases:
        assert ingest.metro64(m) == thll.hash64(m)


def test_copy_differs_from_the_jax_engine_only_in_the_io_uring_guard():
    with open(os.path.join(REPO, "native", "ingest_engine.cpp")) as f:
        orig = f.read().splitlines()
    with open(_build.SRC) as f:
        copy = f.read().splitlines()
    guard = (orig.index("#ifndef IORING_REGISTER_PBUF_RING"),
             orig.index("#endif  // IORING_REGISTER_PBUF_RING"))
    ops = difflib.SequenceMatcher(a=orig, b=copy,
                                  autojunk=False).get_opcodes()
    changed = [(i1, i2) for tag, i1, i2, _, _ in ops if tag != "equal"]
    assert changed
    for i1, i2 in changed:
        assert guard[0] <= i1 and i2 <= guard[1] + 1, (i1, i2)


def test_key_hash_and_tokenizer_agree_across_simd_modes():
    rng = np.random.default_rng(3)
    blobs = [b"", b"a", b"a:1|c", b"x" * 31, b"x" * 32, b"x" * 33]
    blobs += [bytes(rng.choice(list(b"ab:|\n,#@.1"), n))
              for n in (5, 16, 31, 32, 33, 63, 64, 65, 200)]
    for b in blobs:
        assert len({ingest.key_hash(b, m) for m in SIMD}) == 1, b
        want = sorted((i, chr(c)) for i, c in enumerate(b)
                      if c in b"\n:|")
        for m in SIMD:
            assert ingest.scan_tokens(b, m) == want, (m, b)


# -- parser parity ------------------------------------------------------------

VALID = [b"a.b.c:1|c", b"x:2.5|g", b"lat:3.5|h", b"lat2:9|d", b"t:12|ms",
         b"s1:member|s", b"s1:|s", b"multi:1:2:3|c", b"rate:10|c|@0.1",
         b"rh:4.5|h|@0.25|#svc:web", b"tagged:1|c|#b:2,a:1,c",
         b"scoped:1|h|#veneurlocalonly,x:y",
         b"scoped2:1|h|#x:y,veneurglobalonly", b"gauge.rated:7|g|@0.5",
         b"neg:-42.5|g", b"exp:1e3|c", b"m1:1|c|#svc:web,b:2",
         b"env.over:1|c|#env:prod"]
INVALID = [b"foo", b"foo:1", b"foo:1||", b"foo:|c|", b"bad:nan|g|#shell",
           b"bad:NaN|g", b"bad:-inf|g", b"bad:+inf|g", b"foo:1|foo|",
           b"foo:1|c||", b"foo:1|c|foo", b"foo:1|c|@-0.1", b"foo:1|c|@1.1",
           b"foo:1|c|@0.5|@0.2", b"foo:1|c|#foo|#bar", b":1|c",
           b"foo:1_0|c", b"foo:0x10|c", b"x:1:2:bad:4|c"]


def _fuzz_lines(seed: int, n: int) -> list[bytes]:
    """Seeded DogStatsD-shaped lines with mutations: odd values, types,
    rates, tag lists and separators; UTF-8 throughout (a line that is
    not is ROADMAP C16, below)."""
    rng = np.random.default_rng(seed)
    names = [b"a", b"a.b", b"svc.lat", b"x-y_z", b"", b"n\xc3\xa9"]
    values = [b"1", b"-3", b"2.5", b"1e3", b"-0", b"0", b"nan", b"inf",
              b"0x10", b"1_0", b" 5", b"+5", b"", b"abc", b"1:2", b"7:x",
              b"1e400", b".5", b"5."]
    types = [b"c", b"g", b"h", b"ms", b"d", b"s", b"x", b""]
    rates = [b"", b"|@0.5", b"|@1", b"|@0", b"|@1.5", b"|@-1", b"|@abc",
             b"|@0.25|@0.5"]
    tags = [b"", b"|#a:b", b"|#b:2,a:1,c", b"|#veneurlocalonly",
            b"|#veneurglobalonly,x:y", b"|#", b"|#a,,b", b"|#env:prod",
            b"|#a:b|#c:d"]
    tails = [b"", b"", b"", b"|", b"||", b"|zz"]
    out = []
    for _ in range(n):
        line = (names[rng.integers(len(names))] + b":"
                + values[rng.integers(len(values))] + b"|"
                + types[rng.integers(len(types))]
                + rates[rng.integers(len(rates))]
                + tags[rng.integers(len(tags))]
                + tails[rng.integers(len(tails))])
        if rng.random() < 0.1:      # drop or double one byte
            i = int(rng.integers(len(line)))
            line = line[:i] + line[i + 1:] if rng.random() < 0.5 \
                else line[:i] + line[i:i + 1] + line[i:]
        try:
            line.decode()
        except UnicodeDecodeError:
            continue
        out.append(line)
    return out


def _jax_line(line: bytes, extend):
    """One line through the JAX Python chain: ("other",) for an event or
    service check (the server hands those to their own parsers), else
    (emitted samples, failed) with each sample as the engine stages it."""
    if line.startswith((b"_e{", b"_sc")):
        return ("other",)
    out = []
    failed = False
    try:
        jparser.Parser(extend).parse_metric(line, out.append)
    except jparser.ParseError:
        failed = True
    samples = []
    for m in out:
        if m.type == "counter":
            v = float(int(m.value / m.sample_rate))
        elif m.type == "gauge":
            v = float(m.value)
        elif m.type == "set":
            v = thll.hash64(str(m.value).encode())
        else:
            v = (float(m.value), 1.0 / m.sample_rate)
        samples.append((m.name, m.type, m.joined_tags, int(m.scope), v))
    return samples, failed


def _engine_line(eng, tid, line: bytes):
    """One line through the engine, its intern table cleared after it
    (so no earlier line's identity stands in, ROADMAP C15)."""
    eng.ingest(tid, line)
    b = eng.drain(clear_intern=True)
    if b.other:
        assert b.other == [line] and not b.malformed
        return ("other",)
    keys = {k.id: k for k in b.new_keys}
    samples = []
    for ids, vals, kind in ((b.c_ids, b.c_vals, None),
                            (b.g_ids, b.g_vals, None),
                            (b.h_ids, None, None), (b.s_ids, None, "set")):
        for i, kid in enumerate(ids.tolist()):
            k = keys[kid]
            if ids is b.h_ids:
                v = (float(b.h_vals[i]), float(b.h_wts[i]))
            elif ids is b.s_ids:
                v = int(b.s_hashes[i])
            else:
                v = float(vals[i])
            samples.append((k.name, k.mtype, k.joined_tags, int(k.scope), v))
    return samples, bool(b.malformed)


@pytest.mark.parametrize("simd", SIMD)
@pytest.mark.parametrize("extend", [[], ["env:dev", "region:x"]])
def test_engine_parses_what_the_jax_parser_parses(simd, extend):
    eng = ingest.IngestEngine(4096, extend, simd=simd)
    assert eng.simd_mode() == simd
    tid = eng.new_thread()
    lines = (list(_PARSER_CORPUS) + VALID + INVALID
             + _fuzz_lines(17 + len(extend), 600))
    try:
        kinds = set()
        for line in lines:
            want = _jax_line(line, jtagging.ExtendTags(extend))
            got = _engine_line(eng, tid, line)
            assert got == want, line
            kinds.add("other" if got == ("other",)
                      else "error" if got[1] else "metric")
        assert kinds == {"other", "error", "metric"}
    finally:
        eng.close()


def test_engine_divergences_from_the_python_parser_c15_c16():
    """ROADMAP C15: with implicit tags, the engine interns a line with an
    empty tag section (`|#`) and a line with none as one identity (its
    intern key holds the raw tag bytes, empty in both), where the Python
    parser keeps two keys; the first line seen names the row.  C16: a
    line that is not UTF-8 raises UnicodeDecodeError (not a ParseError)
    from the Python parser, and the engine stages it with U+FFFD."""
    eng = ingest.IngestEngine(4096, ["a:z"])
    tid = eng.new_thread()
    eng.ingest(tid, b"x:1|h\nx:2|h|#")
    b = eng.drain()
    assert [(k.name, k.joined_tags) for k in b.new_keys] == [("x", "a:z")]
    assert b.h_ids.tolist() == [0, 0]
    out = []
    p = jparser.Parser(jtagging.ExtendTags(["a:z"]))
    p.parse_metric(b"x:1|h", out.append)
    p.parse_metric(b"x:2|h|#", out.append)
    assert [m.joined_tags for m in out] == ["a:z", ",a:z"]
    eng.ingest(tid, b"\xff:1|c")
    b = eng.drain()
    assert [k.name for k in b.new_keys] == ["\ufffd"] and not b.malformed
    with pytest.raises(UnicodeDecodeError):
        jparser.Parser().parse_metric(b"\xff:1|c", out.append)
    eng.close()


def test_engine_punts_events_and_service_checks_and_counts_too_long():
    eng = ingest.IngestEngine(64)
    tid = eng.new_thread()
    eng.ingest(tid, b"_e{5,4}:title|text\n_sc|svc|0|m:ok\nok:1|c")
    eng.ingest(tid, b"x:1|c\n" * 20)
    b = eng.drain()
    assert b.other == [b"_e{5,4}:title|text", b"_sc|svc|0|m:ok"]
    assert (b.processed, b.packets, b.too_long) == (1, 2, 1)
    assert eng.totals() == (1, 0, 2, 1)
    eng.close()


# -- the drain adapter against the Python paths -------------------------------

def _drain_lines(rng) -> list[bytes]:
    """Integer samples (so t-digest percentiles compare bitwise), every
    family, scope and type, sampled rates, sets and gauges."""
    lines = []
    for k in range(12):
        kind = (b"h", b"ms")[k % 2]
        rate = b"|@0.5" if k % 3 == 0 else b""
        scope = (b"", b",veneurglobalonly", b",veneurlocalonly")[k % 3]
        lines += [b"d.k%d:%d|%s%s|#endpoint:/e%d%s" % (
            k, v, kind, rate, k % 2, scope)
            for v in rng.integers(0, 500, 40)]
        lines += [b"mom.k%d:%d|h|#t:%d" % (k % 4, v, k)
                  for v in rng.integers(1, 900, 40)]
        lines += [b"c.k%d:%d|ms" % (k % 3, v)
                  for v in rng.integers(0, 300, 40)]
        lines += [b"cq.k%d:%d|h|#endpoint:/e%d" % (k % 2, v, k % 3)
                  for v in rng.integers(0, 100, 20)]
    for k in range(20):
        lines.append(b"ctr%d:%d|c%s" % (k % 7, k + 1,
                                        b"|@0.5" if k % 4 == 0 else b""))
        lines.append(b"g%d:%d|g" % (k, k))    # once a key: the readers
        # keep no order between them, so a gauge written twice may land
        # either way
        lines.append(b"s%d:m%d|s%s" % (k % 3, k % 11,
                                       b"|#veneurlocalonly" if k % 5 == 0
                                       else b""))
    rng.shuffle(lines)
    return lines


def _aggs(is_local, **extra):
    kw = dict(percentiles=PCTS, is_local=is_local, sketch_family_rules=RULES,
              cube_dimensions=DIMS, cube_group_budget=8,
              count_unique_timeseries=True, **extra)
    return (JAggregator(**kw), MetricAggregator(device="cpu", **kw),
            MetricAggregator(device="cpu", **kw))


def _by_key(res) -> dict:
    out: dict = {}
    for m in res.metrics:
        out.setdefault((m.name, tuple(m.tags), m.type), []).append(m.value)
    return {k: sorted(v) for k, v in out.items()}


def _assert_flush_like_jax(got, want, spans):
    g, w = _by_key(got), _by_key(want)
    assert g and set(g) == set(w)
    for key, wv in w.items():
        gv = g[key]
        name = key[0]
        quantile = name.endswith(("percentile", ".median"))
        if quantile and name.startswith("mom."):
            span = spans[(name.rsplit(".", 1)[0], key[1])]
            assert np.allclose(gv, wv, rtol=0, atol=FLUSH_RULE * span), key
        elif quantile and name.startswith("c."):
            assert np.allclose(gv, wv, rtol=READOFF_REL, atol=0), key
        else:
            assert gv == wv, (key, gv, wv)
    assert got.unique_ts == want.unique_ts


def _spans(res) -> dict:
    """(name, tags) -> the key's max - min, from its .max and .min rows
    (a local flush emits them)."""
    spans: dict = {}
    for m in res.metrics:
        if m.name.endswith((".max", ".min")):
            key = (m.name[:-4], tuple(m.tags))
            sign = 1 if m.name.endswith(".max") else -1
            spans[key] = spans.get(key, 0) + sign * m.value
    return spans


def _forward_view(res):
    return sorted((f.name, tuple(f.tags), f.kind, int(f.scope),
                   f.counter_value, f.gauge_value,
                   tuple(f.digest_means or ()), tuple(f.digest_weights or ()),
                   tuple(f.moments or ()), tuple(f.compactor or ()))
                  for f in res.forward)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("is_local", [True, False])
def test_drain_flushes_what_the_python_paths_flush(is_local, threads):
    """Two intervals through the engine, drained as they come.  Fed in
    line order on one thread id, the flush and the forwards are bitwise
    the port's Python path.  On three thread ids a drain concatenates
    each thread's batches, so the arrival order changes: the moments
    sums round differently (within FLUSH_RULE of JAX) and the compactor
    ladders, whose fold depends on order, are left out of that case."""
    rng = np.random.default_rng(5 + is_local + threads)
    jagg, tagg, nagg = _aggs(is_local)
    nat = ingest.NativeIngest(nagg)
    tids = [nat.engine.new_thread() for _ in range(threads)]
    for interval in range(2):
        lines = [line for line in _drain_lines(rng)
                 if threads == 1 or not line.startswith(b"c.")]
        jp, tp = jparser.Parser(), tparser.Parser()
        for line in lines:
            jp.parse_metric(line, jagg.process_metric)
            tp.parse_metric(line, tagg.process_metric)
        for n, i in enumerate(range(0, len(lines), 50)):
            nat.engine.ingest(tids[n % threads], b"\n".join(lines[i:i + 50]))
            if n % 8 == 7:
                nat.drain_into()
        nat.drain_into()
        assert nagg.processed == tagg.processed == jagg.processed
        want = jagg.flush(is_local=is_local, now=100 + interval)
        port = tagg.flush(is_local=is_local, now=100 + interval)
        got = nagg.flush(is_local=is_local, now=100 + interval)
        _assert_flush_like_jax(got, want, _spans(want))
        assert got.unique_ts == port.unique_ts
        if threads == 1:
            assert _by_key(got) == _by_key(port)
            assert _forward_view(got) == _forward_view(port)
        if is_local:
            assert len(got.forward) == len(want.forward) > 0
    assert len(nagg.moments.kdict) == 12
    assert len(nagg.compactors.kdict) == (3 if threads == 1 else 0)
    assert any(m.name.startswith("cq.") and "veneur_cube:true" in m.tags
               for m in got.metrics)
    nat.close()


def test_intern_gc_keeps_samples_and_restarts_ids():
    agg = MetricAggregator(device="cpu")
    nat = ingest.NativeIngest(agg)
    tid = nat.engine.new_thread()
    nat.engine.ingest(tid, b"k1:1|c\nk2:5|c")
    nat.drain_or_gc(intern_threshold=10)        # under: a plain drain
    assert nat.engine.intern_count() == 2
    nat.engine.ingest(tid, b"k1:4|c")
    nat.drain_or_gc(intern_threshold=1)         # over: drain, then clear
    assert nat.engine.intern_count() == 0 and nat._info == []
    nat.engine.ingest(tid, b"k1:2|c\nk3:7|c")   # k1 interns anew
    batch = nat.drain_into()
    assert min(k.id for k in batch.new_keys) == 0
    res = agg.flush(is_local=False)
    nat.close()
    assert {m.name: m.value for m in res.metrics} == {
        "k1": 7.0, "k2": 5.0, "k3": 7.0}


def test_row_gc_revalidates_a_recycled_row():
    agg = MetricAggregator(device="cpu")
    nat = ingest.NativeIngest(agg)
    tid = nat.engine.new_thread()
    nat.engine.ingest(tid, b"gc.me:1|c\ngc.h:3|h")
    nat.drain_into()
    agg.flush(is_local=False)
    for _ in range(tarena.IDLE_GC_INTERVALS + 1):
        agg.flush(is_local=False)
    # another key takes the freed rows, then the old ids come back
    tparser.Parser().parse_metric(b"squatter:9|c", agg.process_metric)
    tparser.Parser().parse_metric(b"squat.h:8|h", agg.process_metric)
    nat.engine.ingest(tid, b"gc.me:4|c\ngc.h:5|h")
    nat.drain_into()
    res = agg.flush(is_local=False)
    nat.close()
    by = {m.name: m.value for m in res.metrics}
    assert (by["gc.me"], by["squatter"]) == (4.0, 9.0)
    assert (by["gc.h.50percentile"], by["squat.h.50percentile"]) == (5.0, 8.0)


# -- build_dense's native fill ------------------------------------------------

def _staged(rng, n_rows, n_points, uniform):
    rows = rng.integers(0, n_rows, n_points).astype(np.int64)
    vals = rng.gamma(2.0, 30.0, n_points)
    wts = (np.ones(n_points) if uniform
           else rng.integers(1, 9, n_points).astype(np.float64))
    return rows, vals, wts


def _bits(x):
    """bfloat16 values (a port CPU tensor, a JAX ml_dtypes array) as
    int16; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    if x is not None and str(x.dtype) == "bfloat16":
        return x.view(np.int16)
    return x


def _same(a, b):
    a, b = _bits(a), _bits(b)
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _dense_pair(arena, staged, touched, uniform, monkeypatch):
    dmin = arena.d_min[touched]
    dmax = arena.d_max[touched]
    native = arena.build_dense(staged, touched, dmin, dmax, uniform=uniform)
    with monkeypatch.context() as m:
        m.setattr(tarena, "_NATIVE_FILL_MIN", 1 << 62)
        plain = arena.build_dense(staged, touched, dmin, dmax,
                                  uniform=uniform)
    return native, plain


@pytest.mark.parametrize("n_points", [5000, 70_000])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
def test_native_fill_is_bitwise_numpy_and_jax(monkeypatch, n_points, bf16,
                                              uniform):
    rng = np.random.default_rng(n_points + 2 * bf16 + uniform)
    n_rows = 3000
    staged = _staged(rng, n_rows, n_points, uniform)
    touched = np.unique(staged[0])
    arena = tarena.DigestArena(capacity=4096, device="cpu",
                               bf16_staging=bf16)
    arena.d_min[:] = rng.normal(size=4096)
    arena.d_max[:] = arena.d_min + 1.0
    native, plain = _dense_pair(arena, staged, touched, uniform, monkeypatch)
    assert all(_same(a, b) for a, b in zip(native, plain))
    assert arena.dense_fill_native == (n_points >= tarena._NATIVE_FILL_MIN)
    assert arena.dense_fill_fallbacks == 0
    jar = jarena.DigestArena(capacity=4096, bf16_staging=bf16)
    want = jar.build_dense(staged, touched, arena.d_min[touched],
                           arena.d_max[touched], uniform=uniform)
    assert all(_same(a, b) for a, b in zip(native, want))


@pytest.mark.parametrize("n_points", [5000, 70_000])
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("devices,replicas", [(4, 2), (6, 3)])
def test_native_fill_is_bitwise_numpy_on_a_mesh(monkeypatch, n_points,
                                                uniform, devices, replicas):
    rng = np.random.default_rng(n_points + devices + uniform)
    mesh = make_mesh(devices, replicas, device="cpu")
    arena = tarena.DigestArena(capacity=6144, mesh=mesh)
    staged = _staged(rng, 5000, n_points, uniform)
    touched = np.unique(staged[0])
    native, plain = _dense_pair(arena, staged, touched, uniform, monkeypatch)
    assert native[0].shape[0] % (devices // replicas) == 0
    assert native[0].shape[1] % replicas == 0
    assert all(_same(a, b) for a, b in zip(native, plain))
    assert arena.dense_fill_native == (n_points >= tarena._NATIVE_FILL_MIN)


def test_native_fill_counts_a_broken_invariant_and_rebuilds_in_numpy(
        monkeypatch):
    rng = np.random.default_rng(9)
    arena = tarena.DigestArena(capacity=4096, device="cpu")
    staged = _staged(rng, 3000, 70_000, False)
    touched = np.unique(staged[0])[1:]      # a staged row left untouched
    args = (staged, touched, arena.d_min[touched], arena.d_max[touched])
    # the numpy builder is the one that reports it, as in the JAX package
    with pytest.raises(IndexError):
        arena.build_dense(*args)
    assert arena.dense_fill_native == 0 and arena.dense_fill_fallbacks == 1
    with monkeypatch.context() as m:
        m.setattr(tarena, "_NATIVE_FILL_MIN", 1 << 62)
        with pytest.raises(IndexError):
            arena.build_dense(*args)
    assert arena.dense_fill_fallbacks == 1
    # out-of-range rows never reach the native code
    dense_id = np.arange(8, dtype=np.int64)
    dv = np.zeros((8, 4), np.float32)
    rows = np.array([0, 9, -1, 3], np.int64)
    assert ingest.fill_dense(rows, np.ones(4), None, dense_id, dv, None,
                             np.zeros(8, np.int16)) == 2
    assert not dv.any()


# -- import_payload on the wire scan ------------------------------------------

def _jax_forwards(rng) -> list:
    """JAX ForwardMetrics of every kind: counters, gauges, sets,
    digests (histogram and timer, mixed and global-only), moments
    vectors and compactor ladders, as a JAX local tier exports them."""
    jagg = JAggregator(percentiles=PCTS, is_local=True,
                       sketch_family_rules=RULES)
    p = jparser.Parser()
    for line in _drain_lines(rng):
        p.parse_metric(line, jagg.process_metric)
    for k in range(6):
        p.parse_metric(b"gctr%d:%d|c|#veneurglobalonly,k:%d" % (k, k + 2, k),
                       jagg.process_metric)
        p.parse_metric(b"gg%d:%d|g|#veneurglobalonly" % (k, 3 * k),
                       jagg.process_metric)
    res = jagg.flush(is_local=True, now=50)
    fwd = res.forward
    kinds = {f.kind for f in fwd}
    assert kinds >= {"counter", "gauge", "set", "histogram", "timer"}
    assert any(f.moments is not None for f in fwd)
    assert any(f.compactor is not None for f in fwd)
    return fwd, _spans(res)


def _payload(fms, extra=()) -> bytes:
    ml = jforward_pb2.MetricList(metrics=[jconvert.to_pb(f) for f in fms])
    ml.metrics.extend(extra)
    return ml.SerializeToString()


def test_import_payload_scans_what_the_pb_path_and_jax_import():
    rng = np.random.default_rng(21)
    fms, spans = _jax_forwards(rng)
    from veneur_tpu.protocol import metric_pb2 as jmetric_pb2
    bad = [jmetric_pb2.Metric(name="nil", type=jmetric_pb2.Counter),
           jmetric_pb2.Metric(name="mismatch", type=jmetric_pb2.Timer,
                              counter=jmetric_pb2.CounterValue(value=3)),
           jmetric_pb2.Metric(name="g.mismatch", type=jmetric_pb2.Counter,
                              gauge=jmetric_pb2.GaugeValue(value=1.5)),
           jmetric_pb2.Metric(name="local", type=jmetric_pb2.Histogram,
                              scope=jmetric_pb2.Local,
                              histogram=jmetric_pb2.HistogramValue())]
    payloads = [_payload(fms[:len(fms) // 2], bad), _payload(fms),
                _payload(fms[len(fms) // 3:])]
    kw = dict(percentiles=PCTS, is_local=False, sketch_family_rules=RULES)
    jagg = JAggregator(aggregates=jsm.parse_aggregates(AGGS), **kw)
    scan, pb = (MetricAggregator(device="cpu", aggregates=tsm.parse_aggregates(
        AGGS), **kw) for _ in range(2))
    from veneur_tpu_torch.protocol import forward_pb2
    for payload in payloads:
        want = jagg.import_payload(payload)
        assert scan.import_payload(payload) == want
        assert pb.import_pb_batch(
            forward_pb2.MetricList.FromString(payload).metrics) == want
    assert want[0] > 0 and jagg.imported == scan.imported == pb.imported
    assert scan._import_row_cache      # the counters' identities cached
    jres = jagg.flush(is_local=False, now=60)
    sres, pres = (a.flush(is_local=False, now=60) for a in (scan, pb))
    assert _by_key(sres) == _by_key(pres)
    _assert_flush_like_jax(sres, jres, spans)
    # moments quantiles: the in-process import is bitwise the pb path's
    assert [v for k, v in _by_key(sres).items() if k[0].startswith("mom.")]


def test_import_payload_refuses_a_malformed_payload_as_the_pb_path():
    fms, _ = _jax_forwards(np.random.default_rng(4))
    good = _payload(fms[:5])
    agg = MetricAggregator(device="cpu", percentiles=PCTS, is_local=False)
    from veneur_tpu_torch.protocol import forward_pb2
    for bad in (good[:-3], good + b"\x0a\xff", b"\x0b\x01\x02"):
        assert ingest.import_scan(bad) is None
        with pytest.raises(Exception) as pb_err:
            forward_pb2.MetricList.FromString(bad)
        with pytest.raises(type(pb_err.value)):
            agg.import_payload(bad)
    assert agg.import_payload(b"") == (0, 0)


# -- the proxy's router -------------------------------------------------------

@pytest.mark.parametrize("chunk_max", [1, 7, 2000])
def test_route_metric_list_binds_vn_route_as_the_jax_binding(monkeypatch,
                                                              chunk_max):
    """The port's binding of vn_route, vn_route_dest, vn_route_chunks and
    vn_route_free returns what the JAX package's binding returns from
    the same engine (the JAX one does not build here, so its wrapper
    runs on the port's copy, whose C interface is the same): per
    destination the routed chunks, their counts and the total."""
    from veneur_tpu_torch.protocol import forward_pb2, metric_pb2
    from veneur_tpu_torch.proxy.consistent import ConsistentHash

    monkeypatch.setattr(jingest, "load_library", ingest.load_library)
    ms = [metric_pb2.Metric(name=f"r.m{i % 41}", type=int(i % 5),
                            tags=[f"t:{j}" for j in range(i % 3)])
          for i in range(300)]
    payload = forward_pb2.MetricList(metrics=ms).SerializeToString()
    members = [f"g{i}:8128" for i in range(4)]
    ring = ConsistentHash(members)
    hashes = np.asarray([h for h, _ in ring._ring], np.uint32)
    didx = np.asarray([members.index(m) for _, m in ring._ring], np.int32)
    got = ingest.route_metric_list(payload, hashes, didx, 4, chunk_max)
    assert got == jingest.route_metric_list(payload, hashes, didx, 4,
                                            chunk_max)
    assert sum(count for _, _, count in got) == len(ms)
    # a ring that names a destination past n_dests is refused
    assert ingest.route_metric_list(payload, hashes, didx, 2) is None


# -- the server ---------------------------------------------------------------

def _udp_lines(rng) -> list[bytes]:
    lines = [b"u.h%d:%d|h" % (k % 20, v) for k, v in
             enumerate(rng.integers(0, 1000, 1500))]
    lines += [b"u.t%d:%d|ms|@0.5" % (k % 5, v) for k, v in
              enumerate(rng.integers(0, 100, 200))]
    lines += [b"u.c%d:%d|c|#a:b" % (k % 9, k) for k in range(300)]
    lines += [b"u.g%d:%d|g" % (k % 4, k) for k in range(40)]
    lines += [b"u.s:m%d|s" % (k % 50) for k in range(200)]
    lines += [b"_e{2,3}:ab|cde", b"_sc|chk|1|m:warn", b"bad line", b"x:1|q"]
    rng.shuffle(lines)
    return lines


def _dgrams(lines, limit=1400):
    out, buf = [], b""
    for line in lines:
        if buf and len(buf) + len(line) + 1 > limit:
            out.append(buf)
            buf = b""
        buf = buf + b"\n" + line if buf else line
    return out + [buf]


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _received(srv) -> int:
    return sum(r for r, _, _ in srv.native.engine.thread_counts())


@pytest.mark.parametrize("native", [True, False])
def test_server_over_udp_flushes_what_the_jax_server_flushes(native):
    rng = np.random.default_rng(31)
    lines = _udp_lines(rng)
    dgrams = _dgrams(lines)
    # metric lines and the service check reach process_metric
    processed = sum(1 for line in lines if not line.startswith(b"_e{")
                    and line not in (b"bad line", b"x:1|q"))
    common = dict(percentiles=PCTS, aggregates=AGGS, hostname="h",
                  interval=3600.0)
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                num_readers=2, native_ingest=native,
                                read_buffer_size_bytes=8 << 20, **common),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    try:
        assert (srv.native is not None) == native
        addr = srv.statsd_addrs[0][1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in dgrams:
                s.sendto(d, addr)
        if native:
            # parsed: published, so the drain below takes them all
            _wait(lambda: sum(p for _, p, _ in
                              srv.native.engine.thread_counts())
                  == len(dgrams), "datagrams")
            readers = srv.native.stage_stats()["readers"]
            assert len(readers) == 2
            assert set(readers.values()) <= {"io_uring", "recvmmsg"}
            srv._drain_native()
        else:
            _wait(lambda: srv.aggregator.processed >= processed, "lines")
        assert srv.aggregator.processed == processed
        res = srv.flush()
        got = _by_key(res)
        if native:
            assert srv.proto_received["udp"] == len(dgrams)
        assert srv.parse_errors == 2
    finally:
        srv.shutdown()
    jsink = jsimple.ChannelMetricSink()
    jsrv = JServer(jconfig.Config(native_ingest=False, **common),
                   extra_metric_sinks=[jsink])
    jsrv.start()
    try:
        for d in dgrams:
            jsrv.process_packet_buffer(d)
        jsrv.flush()
        jsrv.egress.settle(timeout_s=10.0)
        want: dict = {}
        while not jsink.queue.empty():
            for m in jsink.queue.get():
                want.setdefault((m.name, tuple(m.tags), m.type),
                                []).append(m.value)
        want = {k: sorted(v) for k, v in want.items()}
    finally:
        jsrv.shutdown()
    assert got == {k: v for k, v in want.items()
                   if k[0].startswith(("u.", "chk"))}
    assert any(k[0] == "chk" for k in got)     # the service check


def test_flush_cut_takes_what_the_readers_received():
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                num_readers=3, interval=3600.0,
                                ingest_drain_interval=3600.0,
                                read_buffer_size_bytes=8 << 20),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    try:
        addr = srv.statsd_addrs[0][1]
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for _ in range(4)]
        for i in range(2000):
            socks[i % 4].sendto(b"cut.c:1|c\ncut.h:%d|h" % (i % 97), addr)
        _wait(lambda: _received(srv) == 2000, "datagrams received")
        # the drainer never ran (an hour's cadence): the cut drains it all
        assert srv.native.engine.totals()[2] == 0
        res = srv.flush()
        by = {m.name: m.value for m in res.metrics}
        assert by["cut.c"] == 2000.0 and by["cut.h.count"] == 2000.0
        for s in socks:
            s.close()
    finally:
        srv.shutdown()


_C17_DGRAM = b"a:1|c\n_e{3,3}:\xff\xfe\xfd|abc\nb:2|c"


@pytest.mark.parametrize("path", ["native-cut", "native-drainer", "python"])
def test_c17_a_line_that_is_not_utf8_costs_that_line_alone(path):
    """ROADMAP C17: an event that is not UTF-8 makes the parser raise
    UnicodeDecodeError (C16).  Through the C++ readers it is replayed in
    the flush's cut or in a drainer tick, through the Python readers on
    the reader thread; on every path the server counts it as a parse
    error, the flush emits the datagram's two counters, and a later
    datagram is still staged."""
    native = path != "python"
    drain_s = 0.02 if path == "native-drainer" else 3600.0
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                native_ingest=native, interval=3600.0,
                                ingest_drain_interval=drain_s),
                 device="cpu")
    srv.start()
    try:
        addr = srv.statsd_addrs[0][1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(_C17_DGRAM, addr)
            if path == "native-cut":
                _wait(lambda: _received(srv) == 1, "the datagram")
                assert srv.native.engine.totals()[2] == 0
            elif path == "native-drainer":
                _wait(lambda: srv.native.engine.totals()[2] == 1,
                      "a drainer tick")
                assert srv.parse_errors == 1
            else:
                _wait(lambda: srv.parse_errors == 1, "the bad line")
            res = srv.flush()
            assert {m.name: m.value for m in res.metrics} == {"a": 1.0,
                                                               "b": 2.0}
            assert srv.parse_errors == 1
            s.sendto(b"c:3|c", addr)
            if native:
                _wait(lambda: _received(srv) == 2, "the later datagram")
            else:
                # processed restarts at each flush
                _wait(lambda: srv.aggregator.processed == 1,
                      "the later datagram")
            res = srv.flush()
        assert {m.name: m.value for m in res.metrics} == {"c": 3.0}
        assert srv.parse_errors == 1
    finally:
        srv.shutdown()


def test_reader_options_shards_backend_and_simd():
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                num_readers=1, ingest_reader_shards=3,
                                ingest_reader_pinning=True,
                                ingest_backend="recvmmsg",
                                ingest_simd="scalar", ingest_reader_batch=8,
                                ingest_ring_slots=4, interval=3600.0),
                 device="cpu")
    srv.start()
    try:
        udp = [s for s in srv._listeners if s.type == socket.SOCK_DGRAM]
        assert len(udp) == 3 and not srv._reader_threads
        _wait(lambda: set(srv.native.stage_stats()["readers"].values())
              == {"recvmmsg"}, "the readers' backend")
        assert srv.native.engine.simd_mode() == "scalar"
        addr = srv.statsd_addrs[0][1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(300):
                s.sendto(b"o.c:1|c", addr)
        _wait(lambda: _received(srv) == 300, "datagrams")
        res = srv.flush()
        assert {m.name: m.value for m in res.metrics}["o.c"] == 300.0
    finally:
        srv.shutdown()


def test_shutdown_takes_every_queued_datagram_into_the_final_flush():
    """The readers stop first (as at a shutdown); datagrams that reached
    the sockets after that are still queued there, and the shutdown's
    sweep feeds them through the engine into the final flush."""
    sink = tsimple.ChannelMetricSink()
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                num_readers=2, interval=3600.0,
                                flush_on_shutdown=True,
                                read_buffer_size_bytes=8 << 20),
                 extra_metric_sinks=[sink], device="cpu")
    srv.start()
    addr = srv.statsd_addrs[0][1]
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(200):
            s.sendto(b"q.c:1|c", addr)
        _wait(lambda: _received(srv) == 200, "the first datagrams")
        srv.native.stop()                       # the C++ readers are joined
        for i in range(300):
            s.sendto(b"q.c:2|c\nq.h:%d|h" % i, addr)
    srv.shutdown()
    res = srv.last_flush
    by = {m.name: m.value for m in res.metrics}
    assert by["q.c"] == 200.0 + 600.0 and by["q.h.count"] == 300.0
    assert srv.native.stats() is None           # closed after the flush


def test_graceful_restart_zero_drop_native_readers():
    """The SIGUSR2 handoff with the C++ readers on both sides: every
    increment sent lands on exactly one of the two servers."""
    cfg = dict(interval=600.0, flush_on_shutdown=True,
               read_buffer_size_bytes=8 << 20, num_readers=2)
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
            time.sleep(0.002)

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    srv_b = None
    try:
        _wait(lambda: _received(srv_a) >= 200, "a's first datagrams")
        srv_b = Server(tconfig.Config(
            statsd_listen_addresses=[f"udp://127.0.0.1:{port}"],
            hostname="b", **cfg), extra_metric_sinks=[sink_b], device="cpu")
        srv_b.start()
        srv_a.request_graceful_restart()
        srv_a.graceful_restart_drain(grace_s=0.2)
        _wait(lambda: _received(srv_b) >= 200, "the stream on b")
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    with lock:
        total = sent
    got_a = sum(m.value for m in srv_a.last_flush.metrics
                if m.name == "grp.hits")
    try:
        _wait(lambda: _received(srv_b) >= total - got_a, "the rest on b")
        res = srv_b.flush()
    finally:
        srv_b.shutdown()
    got_b = sum(m.value for m in res.metrics if m.name == "grp.hits")
    got_b += sum(m.value for m in srv_b.last_flush.metrics
                 if m.name == "grp.hits" and srv_b.last_flush is not res)
    assert got_a > 0 and got_b > 0
    assert got_a + got_b == total, (got_a, got_b, total)


def test_a_failed_build_makes_start_and_import_raise(tmp_path, monkeypatch):
    bad = tmp_path / "ingest_engine.cpp"
    bad.write_text("#error the engine does not compile\n")
    monkeypatch.setattr(_build, "SRC", bad)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(ingest, "_lib", None)
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                interval=3600.0), device="cpu")
    with pytest.raises(RuntimeError, match="does not compile"):
        srv.start()
    assert not srv._listeners
    agg = MetricAggregator(device="cpu")
    with pytest.raises(RuntimeError, match="does not compile"):
        agg.import_payload(b"")
    # native_ingest: false needs no engine for UDP
    srv = Server(tconfig.Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                                interval=3600.0, native_ingest=False),
                 device="cpu")
    srv.start()
    try:
        assert srv.native is None and srv._reader_threads
    finally:
        srv.shutdown()
