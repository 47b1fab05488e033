"""The query engine: window fusion + quantile evaluation on read.

The port's copy of `veneur_tpu.query.engine`.  One `QueryEngine` per
server answers `GET /query` from the arenas' window rings
(query/rings.py):

  digest family   fuse = concatenate the covered slots' staged weighted
                  point clouds for the key (raw samples, imported
                  centroids and hot-row pre-reduction centroids alike),
                  then evaluate with the numpy mirror of the serving
                  flush's evaluation core (sketches/tdigest.py
                  weighted_eval: stable sort, cumulative-weight midpoint
                  interpolation, clamp to the exact [min, max]).

  moments family  fuse = elementwise vector add (sketches/moments.py
                  merge_vectors rebases and adds the power-sum blocks),
                  then ONE maxent solve (ops/moments_eval.py
                  quantiles_from_vectors, on the aggregator's device) —
                  the arXiv 1803.01969 window story: fusion cost
                  independent of the window's sample count.  A
                  group-by that coarsens a cube dimension merges its
                  fine group vectors with one launch of kernel B7
                  (ops/segmented_reduce.py).

  compactor family  fuse = level-wise concat-then-compact
                  (sketches/compactor.py merge_vectors; order-free
                  bit-for-bit), then the rank/quantile read-off
                  (quantiles_from_vectors) — the relative-error
                  guarantee survives the window fusion because the
                  merge IS the sketch's own merge.

Every answer carries a self-describing mergeable PAYLOAD (a centroid
list for digests — the forwarding wire shape — or the moments /
compactor vector), so an upper tier (the proxy's scatter-gather) can
merge answers through the same family codecs it already speaks:
`merge_responses`, `merge_range_responses` and `merge_group_responses`
at the end of this module, which `proxy/proxy.py` calls.

Telemetry per request: the `served` and `errors` counts and a ring of
recent latencies (`stats()`).  The JAX package also sends
query.served_total / query.errors_total / query.latency_ms to its
self-telemetry and records a `query` span; this package has neither
yet.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from veneur_tpu_torch.cubes import cube as cb
from veneur_tpu_torch.ops import moments_eval as me
from veneur_tpu_torch.ops.segmented_reduce import coarsen_moments_vectors
from veneur_tpu_torch.samplers.metric_key import fnv1a_64
from veneur_tpu_torch.sketches import compactor as cs
from veneur_tpu_torch.sketches import moments as mo
from veneur_tpu_torch.sketches import tdigest as td

_PCT_MIN, _PCT_MAX = 0.0, 1.0
# answers whose fused digest point cloud exceeds this compress down to
# the wire centroid shape (bounded payload; the reference's
# MergingDigest.Data form) before serialization
PAYLOAD_POINT_CAP = 2048
# recent per-request latencies kept for stats()/bench percentiles
_LATENCY_RING = 512
# bound on ?since=&step= range answers: a request asking more bins is
# a 400, not an unbounded fuse-and-solve loop
MAX_RANGE_BINS = 2048
# a retention bucket's digest point cloud compresses past this size
BUCKET_POINT_CAP = 2048


class QueryError(ValueError):
    """A request error with its HTTP status (400 bad params, 404
    disabled/unknown, 503 upstream)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = int(code)


def weighted_quantiles_np(vals: np.ndarray, wts: np.ndarray,
                          d_min: float, d_max: float,
                          qs) -> Optional[np.ndarray]:
    """Numpy mirror of the flush evaluation core
    (sketches/tdigest.py weighted_eval, single row): stable sort by
    value, cumulative-weight midpoint interpolation, clamp to the
    authoritative [min, max].  Returns None for an empty cloud."""
    wts = np.asarray(wts, np.float64)
    occ = wts > 0
    v = np.asarray(vals, np.float64)[occ]
    w = wts[occ]
    if len(v) == 0:
        return None
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w)
    total = cum[-1]
    qs = np.asarray(qs, np.float64)
    if len(v) == 1:
        out = np.full(len(qs), v[0])
        return np.clip(out, d_min, d_max)
    cmid = cum - 0.5 * w
    tq = qs * total
    # rank = count of cmid strictly below the target (the twin's fused
    # comparison-count), then clamp into [1, n-1] for interpolation
    idx = np.searchsorted(cmid, tq, side="left")
    ii = np.clip(idx, 1, len(v) - 1)
    m_lo, m_hi = v[ii - 1], v[ii]
    c_lo, c_hi = cmid[ii - 1], cmid[ii]
    t = np.where(c_hi > c_lo,
                 (tq - c_lo) / np.maximum(c_hi - c_lo, 1e-30), 0.0)
    out = m_lo + (m_hi - m_lo) * np.clip(t, 0.0, 1.0)
    return np.clip(out, d_min, d_max)


def weighted_quantiles_np_batch(vals_list, wts_list, mins, maxs,
                                qs) -> list:
    """Batched ``weighted_quantiles_np`` over many point clouds: ONE
    global stable lexsort + reduceat ranking instead of a python loop
    of per-cloud sort pipelines — the group-by cube read's hot path
    (hundreds of groups per query; the per-group numpy call overhead
    dominates at that width).  Returns one array per cloud (None for
    an empty cloud), matching the per-group twin to float rounding
    (the cumulative weights rebase off a global cumsum, so the
    addition order differs — ranks at an exact boundary may shift one
    interpolation step, which moves the answer continuously)."""
    qs = np.asarray(qs, np.float64)
    n_g = len(vals_list)
    out: list = [None] * n_g
    vs, ws = [], []
    sizes = np.zeros(n_g, np.int64)
    for g in range(n_g):
        w = np.asarray(wts_list[g], np.float64)
        occ = w > 0
        v = np.asarray(vals_list[g], np.float64)[occ]
        vs.append(v)
        ws.append(w[occ])
        sizes[g] = len(v)
    if not sizes.sum():
        return out
    v = np.concatenate(vs)
    w = np.concatenate(ws)
    seg = np.repeat(np.arange(n_g), sizes)
    order = np.lexsort((v, seg))    # stable: by group, then value
    v, w, seg = v[order], w[order], seg[order]
    starts = np.zeros(n_g, np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    cumg = np.cumsum(w)
    base = np.where(starts > 0, cumg[starts - 1], 0.0)
    base[sizes == 0] = 0.0
    ends = starts + sizes
    tot = np.where(sizes > 0, cumg[np.maximum(ends - 1, 0)] - base,
                   0.0)
    cmid = (cumg - base[seg]) - 0.5 * w

    nz = np.flatnonzero(sizes > 0)
    tq = tot[nz, None] * qs[None, :]            # [Gnz, Q]
    # rank = per-group count of cmid strictly below the target
    # (the searchsorted(side="left") twin), via one reduceat over the
    # nonzero segments' starts
    cmp = cmid[:, None] < tq[np.searchsorted(nz, seg), :]
    idx = np.add.reduceat(cmp, starts[nz], axis=0)
    ii = np.clip(idx, 1, np.maximum(sizes[nz, None] - 1, 1))
    # single-point clouds land on ii=1 past their only point; clamp
    # into the buffer (their answer is overwritten just below)
    gi = np.minimum(starts[nz, None] + ii, len(v) - 1)
    m_lo, m_hi = v[gi - 1], v[gi]
    c_lo, c_hi = cmid[gi - 1], cmid[gi]
    t = np.where(c_hi > c_lo,
                 (tq - c_lo) / np.maximum(c_hi - c_lo, 1e-30), 0.0)
    ans = m_lo + (m_hi - m_lo) * np.clip(t, 0.0, 1.0)
    # single-point clouds answer their one value (the twin's
    # special case); then clamp to each cloud's authoritative domain
    one = sizes[nz] == 1
    if one.any():
        ans[one] = v[starts[nz][one], None]
    mins = np.asarray(mins, np.float64)[nz, None]
    maxs = np.asarray(maxs, np.float64)[nz, None]
    ans = np.clip(ans, mins, maxs)
    for j, g in enumerate(nz):
        out[int(g)] = ans[j]
    return out


def _compress_payload(vals: np.ndarray, wts: np.ndarray,
                      compression: float, device) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """Bound a fused point cloud to wire-centroid size via the serving
    compress (sketches/tdigest.py compress on `device`, one [1, M] row
    padded to a power of two)."""
    m = 1 << (len(vals) - 1).bit_length()
    dv = np.zeros((1, m), np.float32)
    dw = np.zeros((1, m), np.float32)
    dv[0, :len(vals)] = vals
    dw[0, :len(wts)] = wts
    ccap = td.centroid_capacity(compression)
    cm, cw = td.compress(torch.from_numpy(dv).to(device),
                         torch.from_numpy(dw).to(device), compression, ccap)
    cm = cm[0].cpu().numpy().astype(np.float64)
    cw = cw[0].cpu().numpy().astype(np.float64)
    occ = cw > 0
    return cm[occ], cw[occ]


def _merge_cloud(a: dict, b: dict, compression: float, device) -> dict:
    """Digest bucket merge of the retention tiers (the JAX package's
    `retention.timeline.merge_cloud`): weighted point-cloud concat,
    compressed only past BUCKET_POINT_CAP points."""
    v = np.concatenate([a["v"], b["v"]])
    w = np.concatenate([a["w"], b["w"]])
    if len(v) > BUCKET_POINT_CAP:
        v, w = _compress_payload(v, w, compression, device)
    return {"v": v, "w": w,
            "min": min(a["min"], b["min"]),
            "max": max(a["max"], b["max"]),
            "count": a["count"] + b["count"],
            "sum": a["sum"] + b["sum"],
            "rsum": a["rsum"] + b["rsum"]}


# -- parameter parsing (shared by server and proxy HTTP handlers) --------

def parse_query_params(q: dict) -> dict:
    """urllib parse_qs dict -> validated query spec.  Raises
    QueryError(400) on anything malformed."""
    name = (q.get("name") or [""])[0]
    if not name:
        raise QueryError(400, "missing name=")
    try:
        qs = [float(x) for x in
              (q.get("q") or ["0.5"])[0].split(",") if x]
    except ValueError:
        raise QueryError(400, "bad q= (comma-separated floats)")
    if not qs or any(not (_PCT_MIN < p < _PCT_MAX) for p in qs):
        raise QueryError(400, "q= values must be in (0, 1)")
    window_s = None
    slots = None
    if "slots" in q:
        try:
            slots = int(q["slots"][0])
        except ValueError:
            raise QueryError(400, "bad slots=")
        if slots < 1:
            raise QueryError(400, "slots= must be >= 1")
    elif "window_s" in q:
        try:
            window_s = float(q["window_s"][0])
        except ValueError:
            raise QueryError(400, "bad window_s=")
        # `not (x > 0)` also rejects nan; isfinite rejects +inf (a
        # window reaching past every ring is a malformed request, not
        # an everything-window)
        if not (window_s > 0 and math.isfinite(window_s)):
            raise QueryError(400, "window_s= must be a positive "
                                  "finite number of seconds")
    tags = [t for t in (q.get("tags") or [""])[0].split(",") if t]
    kind = (q.get("type") or [None])[0]
    if kind is not None and kind not in ("histogram", "timer"):
        raise QueryError(400, "type= must be histogram or timer")
    # group-by cube queries: ?group_by=tag1,tag2[&top=K&by=q99]
    group_by = [t for t in (q.get("group_by") or [""])[0].split(",")
                if t]
    for t in group_by:
        if ":" in t:
            raise QueryError(400, f"group_by= takes tag NAMES, got "
                             f"{t!r} (a tag:value filter belongs in "
                             "tags=)")
    top = None
    if "top" in q:
        if not group_by:
            raise QueryError(400, "top= requires group_by=")
        try:
            top = int(q["top"][0])
        except ValueError:
            raise QueryError(400, "bad top=")
        if top < 1:
            raise QueryError(400, "top= must be >= 1")
    by = (q.get("by") or [None])[0]
    if by is not None and not group_by:
        raise QueryError(400, "by= requires group_by=")
    parse_rank_by(by)   # validate eagerly (raises QueryError(400))
    # payload=0 answers quantiles/counts only — the dashboard read.
    # Mergeable family payloads are the proxy's scatter-gather
    # currency, not something every client wants on the wire (a
    # group-by answer carries one payload PER GROUP)
    pay = (q.get("payload") or ["1"])[0]
    if pay not in ("0", "1", "true", "false"):
        raise QueryError(400, "payload= must be 0 or 1")
    # range form: ?since=<unix>&step=<seconds>[&until=<unix>] asks a
    # bucketed timeline instead of one point answer (the retention
    # tiers' read surface).  Validation is strict-400, never a silent
    # clamp: a future since=, step<=0, or a bin count past
    # MAX_RANGE_BINS are caller bugs the server must say out loud.
    since = until = step = None
    if "since" in q or "until" in q or "step" in q:
        if "since" not in q or "step" not in q:
            raise QueryError(400, "range form needs both since= and "
                                  "step=")
        try:
            since = float(q["since"][0])
            step = float(q["step"][0])
            until = float(q["until"][0]) if "until" in q else None
        except ValueError:
            raise QueryError(400, "bad since=/until=/step= "
                                  "(unix seconds)")
        if not (math.isfinite(since) and math.isfinite(step)
                and (until is None or math.isfinite(until))):
            raise QueryError(400, "since=/until=/step= must be "
                                  "finite")
        if step <= 0:
            raise QueryError(400, "step= must be > 0")
        now = time.time()
        if since > now:
            raise QueryError(400, "since= is in the future")
        if until is not None and until <= since:
            raise QueryError(400, "until= must be > since=")
        if slots is not None or window_s is not None:
            raise QueryError(400, "range form (since=/step=) "
                                  "excludes slots= and window_s=")
        if group_by:
            raise QueryError(400, "range form does not take "
                                  "group_by=")
        if ((until if until is not None else now) - since) / step \
                > MAX_RANGE_BINS:
            raise QueryError(400, f"range asks more than "
                                  f"{MAX_RANGE_BINS} bins — raise "
                                  "step= or narrow the range")
    return {"name": name, "qs": qs, "window_s": window_s,
            "slots": slots, "tags": tags, "kind": kind,
            "group_by": group_by or None, "top": top, "by": by,
            "payload": pay in ("1", "true"),
            "since": since, "until": until, "step": step}


def parse_rank_by(by: Optional[str]) -> tuple:
    """``by=`` ranking mode -> ("count", None) or ("quantile", p).
    ``q99`` / ``q99.9`` are percent forms; ``q0.99`` the fraction
    form."""
    if by in (None, "", "count"):
        return "count", None
    if isinstance(by, str) and by.startswith("q"):
        try:
            p = float(by[1:])
        except ValueError:
            raise QueryError(400, f"bad by={by!r} (count | q<pct>)")
        if p >= 1.0:
            p = p / 100.0
        if not (_PCT_MIN < p < _PCT_MAX):
            raise QueryError(400, f"by={by!r} quantile out of (0, 1)")
        return "quantile", p
    raise QueryError(400, f"bad by={by!r} (count | q<pct>)")


def rank_groups(entries: list, mode: str, p: Optional[float],
                seed: int, top: Optional[int]) -> list:
    """Order group entries for the top-k answer: descending by the
    ranking stat (count, or the ``by=`` quantile read from the entry's
    evaluated quantiles), with the DETERMINISTIC seeded fnv1a rank of
    the canonical group key as the tie-break — the same
    identity-hash ordering the cube budget machinery uses, so equal
    groups order identically on every tier."""
    qkey = repr(float(p)) if mode == "quantile" else None

    def stat(e):
        if mode == "count":
            return float(e.get("count") or 0.0)
        v = (e.get("quantiles") or {}).get(qkey)
        return float(v) if v is not None else float("-inf")

    entries.sort(key=lambda e: (-stat(e),
                                fnv1a_64(e["key"], seed), e["key"]))
    return entries[:top] if top else entries


class QueryEngine:
    """Per-server windowed-quantile read path over the aggregator's
    window rings.  Thread-safe; holds no aggregator or arena lock —
    reads touch only immutable flush snapshots."""

    def __init__(self, aggregator, tier: str = "local", hostname: str = ""):
        self.agg = aggregator
        self.tier = tier
        self.hostname = hostname
        self.served = 0
        self.errors = 0
        self._lock = threading.Lock()
        self._latencies_ms: list[float] = []

    @property
    def enabled(self) -> bool:
        return self.agg.query_rings is not None

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._latencies_ms)
        out = {"enabled": self.enabled, "served": self.served,
               "errors": self.errors}
        if lat:
            out["latency_p50_ms"] = float(np.percentile(lat, 50))
            out["latency_p99_ms"] = float(np.percentile(lat, 99))
        if self.enabled:
            rings = self.agg.query_rings
            out["rings"] = {fam: r.stats() for fam, r in rings.items()}
        return out

    # -- HTTP entry --------------------------------------------------------

    def serve(self, q: dict) -> tuple[int, dict]:
        """parse_qs dict -> (http status, JSON-able body), counting
        served and failed requests and keeping the latency ring."""
        t0 = time.perf_counter()
        code = 200
        try:
            spec = parse_query_params(q)
            body = self.query(**spec)
        except QueryError as e:
            code, body = e.code, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
            code, body = 500, {"error": f"{type(e).__name__}: {e}"}
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            if code == 200:
                self.served += 1
            else:
                self.errors += 1
            self._latencies_ms.append(dt_ms)
            if len(self._latencies_ms) > _LATENCY_RING:
                del self._latencies_ms[:-_LATENCY_RING]
        return code, body

    # -- the windowed read -----------------------------------------------

    def _covering(self, window_s, slots, now) -> tuple:
        """Every family ring's covering slots + CONSERVATIVELY merged
        coverage metadata.  The family rings rotate back to back (not
        atomically); a read landing between the appends would see one
        ring a cut ahead of another, so the answer never claims
        coverage one fused family lacks: fresh/partial only hold when
        all hold, and the covered window is the intersection's
        bounds."""
        rings = self.agg.query_rings
        td_slots, td_info = rings["tdigest"].covering(
            window_s=window_s, slots=slots, now=now)
        mo_slots, mo_info = rings["moments"].covering(
            window_s=window_s, slots=slots, now=now)
        cc_slots, cc_info = rings["compactor"].covering(
            window_s=window_s, slots=slots, now=now)
        infos = (td_info, mo_info, cc_info)
        info = dict(td_info)
        info["fresh"] = all(i["fresh"] for i in infos)
        info["partial"] = any(i["partial"] for i in infos)
        info["slots_fused"] = min(i["slots_fused"] for i in infos)
        # intersection bounds: [max(from), min(to)] — min(from) would
        # claim coverage one of the fused families lacks
        for k, pick in (("covered_from_unix", max),
                        ("covered_to_unix", min)):
            vals = [i[k] for i in infos if i[k] is not None]
            info[k] = pick(vals) if vals else None
        return td_slots, mo_slots, cc_slots, info

    def query(self, name: str, tags: Optional[list] = None,
              qs=(0.5,), window_s: Optional[float] = None,
              slots: Optional[int] = None,
              kind: Optional[str] = None,
              payload: bool = True,
              group_by: Optional[list] = None,
              top: Optional[int] = None,
              by: Optional[str] = None,
              since: Optional[float] = None,
              until: Optional[float] = None,
              step: Optional[float] = None) -> dict:
        """Fuse the ring slots covering the window and evaluate the
        requested quantiles for one key.  A key absent from every
        covered slot answers count=0 (not an error: absence of samples
        is a legitimate windowed answer).  With ``group_by`` the read
        answers per cube group instead (query_groups); with ``since``
        it answers the bucketed range form instead (query_range)."""
        rings = self.agg.query_rings
        if rings is None:
            raise QueryError(
                404, "query plane disabled (query_window_slots: 0)")
        if since is not None:
            return self.query_range(
                name, tags=tags, qs=qs, since=since, until=until,
                step=step, kind=kind, payload=payload)
        if group_by:
            return self.query_groups(
                name, group_by, qs=qs, window_s=window_s, slots=slots,
                kind=kind, top=top, by=by, payload=payload)
        jtags = ",".join(sorted(tags)) if tags else ""
        now = time.time()
        td_slots, mo_slots, cc_slots, info = self._covering(
            window_s, slots, now)

        td = self._fuse_tdigest(td_slots, name, jtags, kind)
        mo = self._fuse_moments(mo_slots, name, jtags, kind)
        cc = self._fuse_compactor(cc_slots, name, jtags, kind)

        qarr = np.asarray(list(qs), np.float64)
        out = {
            "name": name, "tags": sorted(tags) if tags else [],
            "tier": self.tier, "host": self.hostname,
            "staleness_ms": (
                round((now - info["covered_to_unix"]) * 1e3, 3)
                if info["covered_to_unix"] else None),
            "quantiles": {}, "count": 0.0, "sum": 0.0,
            "min": None, "max": None, "family": "none",
            "mixed_families": sum(
                f["count"] > 0 for f in (td, mo, cc)) > 1,
            "payload": None,
        }
        out.update(info)
        # a key can legitimately live in SEVERAL families across a
        # window (a cross-tier sketch_family_rules mismatch is the
        # documented degradation); the families cannot merge exactly,
        # so the answer follows the family holding most mass, flagged
        fam = max((td, mo, cc), key=lambda f: f["count"])
        if fam["count"] > 0:
            out["family"] = fam["family"]
            out["count"] = fam["count"]
            out["sum"] = fam["sum"]
            out["min"] = fam["min"]
            out["max"] = fam["max"]
            quants = fam["eval"](qarr)
            if quants is not None:
                out["quantiles"] = {
                    repr(float(p)): float(v)
                    for p, v in zip(qarr, quants)}
            if payload:
                out["payload"] = fam["payload"]()
        return out

    def _fuse_tdigest(self, slots_list, name, jtags, kind) -> dict:
        vparts: list[np.ndarray] = []
        wparts: list[np.ndarray] = []
        mn, mx = np.inf, -np.inf
        cnt = sm = rs = 0.0
        for slot in slots_list:
            pos = slot.positions(name, jtags, kind)
            if not pos:
                continue
            prt = slot.part
            if len(pos) == 1:
                # the common case: one position per key per slot —
                # scalar item reads beat five fancy-index+reduce
                # numpy round-trips (~8 us each) on the query path
                i = pos[0]
                mn = min(mn, float(prt["d_min"][i]))
                mx = max(mx, float(prt["d_max"][i]))
                cnt += float(prt["d_weight"][i])
                sm += float(prt["d_sum"][i])
                rs += float(prt["d_rsum"][i])
                rows_sel = prt["rows"][i:i + 1]
            else:
                parr = np.asarray(pos, np.int64)
                mn = min(mn, float(prt["d_min"][parr].min()))
                mx = max(mx, float(prt["d_max"][parr].max()))
                cnt += float(prt["d_weight"][parr].sum())
                sm += float(prt["d_sum"][parr].sum())
                rs += float(prt["d_rsum"][parr].sum())
                rows_sel = prt["rows"][parr]
            v, w = slot.points_for(rows_sel)
            if len(v):
                vparts.append(v)
                wparts.append(w)

        def _eval(qarr):
            if not vparts:
                return None
            return weighted_quantiles_np(
                np.concatenate(vparts), np.concatenate(wparts),
                mn, mx, qarr)

        def _payload():
            if not vparts:
                return None
            v = np.concatenate(vparts)
            w = np.concatenate(wparts)
            if len(v) > PAYLOAD_POINT_CAP:
                v, w = _compress_payload(
                    v, w, self.agg.digests.compression, self.agg.device)
            return {"family": "tdigest",
                    "means": [float(x) for x in v],
                    "weights": [float(x) for x in w],
                    "min": float(mn), "max": float(mx),
                    "count": cnt, "sum": sm, "rsum": rs}

        def _cloud():
            if not vparts:
                return np.zeros(0, np.float64), np.zeros(0, np.float64)
            return np.concatenate(vparts), np.concatenate(wparts)

        return {"family": "tdigest", "count": cnt, "sum": sm,
                "min": (float(mn) if cnt > 0 else None),
                "max": (float(mx) if cnt > 0 else None),
                "rsum": rs,
                "eval": _eval, "payload": _payload, "cloud": _cloud}

    def _fuse_moments(self, slots_list, name, jtags, kind) -> dict:
        marena = self.agg.moments
        vec = None
        for slot in slots_list:
            pos = slot.positions(name, jtags, kind)
            if not pos:
                continue

            def _compute(slot=slot, pos=pos):
                # REDUCED staged view: assemble_vectors' per-point
                # mask walks only the key's own points, and the
                # result memoizes per slot, so repeat queries are a
                # dict hit + vector add
                parr = np.asarray(pos, np.int64)
                sub = slot.staged_rows_for(slot.part["rows"][parr])
                vecs = marena.assemble_vectors(slot.part, sub, parr)
                out = vecs[0].copy()
                for row in vecs[1:]:
                    out = mo.merge_vectors(out[None, :],
                                           row[None, :])[0]
                return out
            svec = slot.vector_memo((name, jtags, kind), _compute)
            vec = (svec.copy() if vec is None
                   else mo.merge_vectors(vec[None, :],
                                         svec[None, :])[0])
        cnt = float(vec[mo.IDX_COUNT]) if vec is not None else 0.0

        def _eval(qarr):
            if vec is None or cnt <= 0:
                return None
            return me.quantiles_from_vectors(
                vec[None, :], qarr, device=self.agg.device)[0]

        def _payload():
            if vec is None:
                return None
            return {"family": "moments", "k": marena.k,
                    "vector": [float(x) for x in vec]}

        return {"family": "moments", "count": cnt,
                "sum": (float(vec[mo.IDX_SUM]) if vec is not None
                        else 0.0),
                "min": (float(vec[mo.IDX_MIN]) if cnt > 0 else None),
                "max": (float(vec[mo.IDX_MAX]) if cnt > 0 else None),
                "eval": _eval, "payload": _payload, "vector": vec}

    def _fuse_compactor(self, slots_list, name, jtags, kind) -> dict:
        carena = self.agg.compactors
        vec = None
        for slot in slots_list:
            pos = slot.positions(name, jtags, kind)
            if not pos:
                continue

            def _compute(slot=slot, pos=pos):
                # same REDUCED staged view + per-slot memo as the
                # moments fusion; compactor merges are concat-then-
                # compact (order-free, the ladder geometry makes them
                # associative) so cross-slot fusion is a fold
                parr = np.asarray(pos, np.int64)
                sub = slot.staged_rows_for(slot.part["rows"][parr])
                vecs = carena.assemble_vectors(slot.part, sub, parr)
                out = vecs[0].copy()
                for row in vecs[1:]:
                    out = cs.merge_vectors(out[None, :],
                                           row[None, :])[0]
                return out
            svec = slot.vector_memo((name, jtags, kind), _compute)
            vec = (svec.copy() if vec is None
                   else cs.merge_vectors(vec[None, :],
                                         svec[None, :])[0])
        cnt = float(vec[cs.IDX_COUNT]) if vec is not None else 0.0

        def _eval(qarr):
            if vec is None or cnt <= 0:
                return None
            return cs.quantiles_from_vectors(vec[None, :], qarr)[0]

        def _payload():
            if vec is None:
                return None
            return {"family": "compactor",
                    "vector": [float(x) for x in vec]}

        return {"family": "compactor", "count": cnt,
                "sum": (float(vec[cs.IDX_SUM]) if vec is not None
                        else 0.0),
                "min": (float(vec[cs.IDX_MIN]) if cnt > 0 else None),
                "max": (float(vec[cs.IDX_MAX]) if cnt > 0 else None),
                "eval": _eval, "payload": _payload, "vector": vec}

    # -- the range read (the retention timeline's query surface) ---------

    @staticmethod
    def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
        return max(0.0, min(a1, b1) - max(a0, b0))

    def _fuse_buckets(self, buckets: list, keys: list) -> tuple:
        """Fuse one key's payloads across retention buckets: digest
        clouds concat (merge_cloud), moments vectors add, compactor
        ladders merge — the same family merges that built the
        buckets.  Returns (td entry | None, mo vec | None,
        cc vec | None)."""
        td_e = mo_v = cc_v = None
        for bk in buckets:
            for k in keys:
                e = bk.td.get(k)
                if e is not None:
                    td_e = e if td_e is None else _merge_cloud(
                        td_e, e, self.agg.digests.compression,
                        self.agg.device)
                v = bk.mo.get(k)
                if v is not None:
                    mo_v = v.copy() if mo_v is None else \
                        mo.merge_vectors(mo_v[None, :], v[None, :])[0]
                v = bk.cc.get(k)
                if v is not None:
                    cc_v = v.copy() if cc_v is None else \
                        cs.merge_vectors(cc_v[None, :], v[None, :])[0]
        return td_e, mo_v, cc_v

    def query_range(self, name: str, tags: Optional[list] = None,
                    qs=(0.5,), since: float = 0.0,
                    until: Optional[float] = None,
                    step: Optional[float] = None,
                    kind: Optional[str] = None,
                    payload: bool = True) -> dict:
        """The `?since=&step=` range read: plan which sources cover
        each step bin — the window ring (finest), then the in-memory
        retention tiers finest-first, then the on-disk tier segments —
        fuse the winning source's buckets per bin, and evaluate every
        bin's quantiles in ONE batch per family (a range of moments
        bins costs one maxent solve, not one per bin).  Each bin
        carries its coverage metadata (source, covered span), and each
        bin's payload stays mergeable so the proxy scatter-gathers
        ranges exactly like point queries.  The retention sources come
        from `agg.retention` (its `sources_overlapping`) when the
        aggregator has one; this package's has none yet, so its ranges
        plan over the ring alone."""
        rings = self.agg.query_rings
        now = time.time()
        t_lo = float(since)
        t_hi = min(float(until), now) if until is not None else now
        step = float(step) if step else max(t_hi - t_lo, 1e-9)
        # Bin edges via multiplication, not accumulation: at unix-timestamp
        # magnitude one float64 ulp is ~2.4e-7 s, so `t += step` drifts off
        # the floor-aligned bucket grid and manufactures spurious overlaps.
        bins: list[tuple[float, float]] = []
        i = 0
        while len(bins) < MAX_RANGE_BINS:
            b0 = t_lo + i * step
            if b0 >= t_hi - 1e-9:
                break
            bins.append((b0, min(t_lo + (i + 1) * step, t_hi)))
            i += 1
        # Overlap slack: edges of bins vs. buckets come from different float
        # computations and can disagree by a few ulp of the absolute time.
        ov_eps = max(1e-9, step * 1e-4)
        jtags = ",".join(sorted(tags)) if tags else ""
        keys = ([(name, jtags, kind)] if kind is not None
                else [(name, jtags, "histogram"),
                      (name, jtags, "timer")])

        # sources, finest first (order breaks coverage ties)
        sources: list = []
        last_cut = 0.0
        if rings is not None:
            td_sl = rings["tdigest"].slots_between(t_lo, t_hi)
            mo_sl = rings["moments"].slots_between(t_lo, t_hi)
            cc_sl = rings["compactor"].slots_between(t_lo, t_hi)
            last_cut = rings["tdigest"].last_cut
            sources.append(("ring", "ring",
                            (td_sl, mo_sl, cc_sl)))
        retention = getattr(self.agg, "retention", None)
        if retention is not None:
            for tname, _bs, buckets in \
                    retention.sources_overlapping(t_lo, t_hi):
                sources.append((tname, "tier", buckets))
        if not sources:
            raise QueryError(
                404, "range form needs the query plane "
                     "(query_window_slots > 0)")

        series: list[dict] = []
        td_pending: list = []
        mo_pending: list = []
        cc_pending: list = []
        used_sources: set = set()
        cov_from = cov_to = None
        for b0, b1 in bins:
            best = None
            best_cov = 0.0
            for label, skind, data in sources:
                if skind == "ring":
                    # conservative across the three family rings (they
                    # rotate back to back, not atomically)
                    cov = min(
                        sum(self._overlap(s.t_start, s.t_end, b0, b1)
                            for s in sl)
                        for sl in data)
                else:
                    cov = sum(self._overlap(
                        bk.t_start, min(bk.filled_to, bk.t_end),
                        b0, b1) for bk in data)
                if cov > best_cov + ov_eps:
                    best, best_cov = (label, skind, data), cov
            ent = {"t_start": b0, "t_end": b1, "source": None,
                   "coverage_s": 0.0, "covered_from_unix": None,
                   "covered_to_unix": None, "family": "none",
                   "count": 0.0, "sum": 0.0, "min": None, "max": None,
                   "mixed_families": False, "quantiles": {},
                   "payload": None}
            series.append(ent)
            if best is None:
                continue
            label, skind, data = best
            used_sources.add(label)
            if skind == "ring":
                sel = [[s for s in sl
                        if self._overlap(s.t_start, s.t_end,
                                         b0, b1) > ov_eps]
                       for sl in data]
                spans = [(s.t_start, s.t_end)
                         for sl in sel for s in sl]
                td = self._fuse_tdigest(sel[0], name, jtags, kind)
                mof = self._fuse_moments(sel[1], name, jtags, kind)
                ccf = self._fuse_compactor(sel[2], name, jtags, kind)
                td_e = None
                if td["count"] > 0:
                    v, w = td["cloud"]()
                    td_e = {"v": v, "w": w, "min": td["min"],
                            "max": td["max"], "count": td["count"],
                            "sum": td["sum"], "rsum": td["rsum"]}
                mo_v, cc_v = mof["vector"], ccf["vector"]
            else:
                sel_b = [bk for bk in data
                         if self._overlap(bk.t_start,
                                          min(bk.filled_to, bk.t_end),
                                          b0, b1) > ov_eps]
                spans = [(bk.t_start, min(bk.filled_to, bk.t_end))
                         for bk in sel_b]
                td_e, mo_v, cc_v = self._fuse_buckets(sel_b, keys)
            ent["source"] = label
            ent["coverage_s"] = round(best_cov, 6)
            if spans:
                ent["covered_from_unix"] = max(
                    min(s[0] for s in spans), b0)
                ent["covered_to_unix"] = min(
                    max(s[1] for s in spans), b1)
                cov_from = ent["covered_from_unix"] if cov_from is \
                    None else min(cov_from, ent["covered_from_unix"])
                cov_to = ent["covered_to_unix"] if cov_to is None \
                    else max(cov_to, ent["covered_to_unix"])
            td_cnt = td_e["count"] if td_e is not None else 0.0
            mo_cnt = float(mo_v[mo.IDX_COUNT]) if mo_v is not None \
                else 0.0
            cc_cnt = float(cc_v[cs.IDX_COUNT]) if cc_v is not None \
                else 0.0
            ent["mixed_families"] = sum(
                c > 0 for c in (td_cnt, mo_cnt, cc_cnt)) > 1
            if td_cnt <= 0 and mo_cnt <= 0 and cc_cnt <= 0:
                continue
            # same larger-mass family pick as the point read
            if td_cnt >= mo_cnt and td_cnt >= cc_cnt:
                ent.update(family="tdigest", count=td_cnt,
                           sum=td_e["sum"], min=float(td_e["min"]),
                           max=float(td_e["max"]))
                td_pending.append((ent, td_e))
                if payload:
                    pv, pw = td_e["v"], td_e["w"]
                    if len(pv) > PAYLOAD_POINT_CAP:
                        pv, pw = _compress_payload(
                            pv, pw, self.agg.digests.compression,
                            self.agg.device)
                    ent["payload"] = {
                        "family": "tdigest",
                        "means": [float(x) for x in pv],
                        "weights": [float(x) for x in pw],
                        "min": float(td_e["min"]),
                        "max": float(td_e["max"]),
                        "count": td_cnt, "sum": td_e["sum"],
                        "rsum": td_e["rsum"]}
            elif mo_cnt >= cc_cnt:
                ent.update(family="moments", count=mo_cnt,
                           sum=float(mo_v[mo.IDX_SUM]),
                           min=float(mo_v[mo.IDX_MIN]),
                           max=float(mo_v[mo.IDX_MAX]))
                mo_pending.append((ent, mo_v))
                if payload:
                    ent["payload"] = {
                        "family": "moments",
                        "k": mo.k_from_len(len(mo_v)),
                        "vector": [float(x) for x in mo_v]}
            else:
                ent.update(family="compactor", count=cc_cnt,
                           sum=float(cc_v[cs.IDX_SUM]),
                           min=float(cc_v[cs.IDX_MIN]),
                           max=float(cc_v[cs.IDX_MAX]))
                cc_pending.append((ent, cc_v))
                if payload:
                    ent["payload"] = {
                        "family": "compactor",
                        "vector": [float(x) for x in cc_v]}

        qarr = np.asarray(list(qs), np.float64)
        if td_pending:
            allq = weighted_quantiles_np_batch(
                [e["v"] for _, e in td_pending],
                [e["w"] for _, e in td_pending],
                [e["min"] for _, e in td_pending],
                [e["max"] for _, e in td_pending], qarr)
            for (ent, _), quants in zip(td_pending, allq):
                if quants is not None:
                    ent["quantiles"] = {repr(float(p)): float(x)
                                        for p, x in zip(qarr, quants)}
        if mo_pending:
            # one batched maxent solve for the WHOLE range — the
            # per-bin eager path costs hundreds of ms per solve
            allq = me.quantiles_from_vectors(
                np.stack([v for _, v in mo_pending]), qarr,
                device=self.agg.device)
            for (ent, _), quants in zip(mo_pending, allq):
                ent["quantiles"] = {repr(float(p)): float(x)
                                    for p, x in zip(qarr, quants)}
        if cc_pending:
            allq = cs.quantiles_from_vectors(
                np.stack([v for _, v in cc_pending]), qarr)
            for (ent, _), quants in zip(cc_pending, allq):
                ent["quantiles"] = {repr(float(p)): float(x)
                                    for p, x in zip(qarr, quants)}

        partial = any(
            e["coverage_s"] + 1e-6 < (e["t_end"] - e["t_start"])
            for e in series)
        return {
            "name": name, "tags": sorted(tags) if tags else [],
            "tier": self.tier, "host": self.hostname,
            "range": True, "since": t_lo, "until": t_hi,
            "step": step, "bins": len(series), "series": series,
            "sources": sorted(used_sources),
            "covered_from_unix": cov_from,
            "covered_to_unix": cov_to,
            "partial": partial,
            "fresh": (cov_to is not None and last_cut > 0
                      and cov_to >= min(t_hi, last_cut) - 1e-6),
            "staleness_ms": (round((now - cov_to) * 1e3, 3)
                             if cov_to is not None else None),
        }

    # -- the group-by cube read ------------------------------------------

    def query_groups(self, name: str, group_by: list, qs=(0.5,),
                     window_s: Optional[float] = None,
                     slots: Optional[int] = None,
                     kind: Optional[str] = None,
                     top: Optional[int] = None,
                     by: Optional[str] = None,
                     payload: bool = True) -> dict:
        """Per-group windowed answer from the cube rows
        (veneur_tpu/cubes/): resolve ``group_by`` against the
        configured dimensions (an exact dimension answers directly; a
        SUPERSET dimension answers via the segmented-reduce
        coarsening), fuse each group's rows across the covered slots,
        and rank for ``top=K&by=``.  The accounted overflow row rides
        along as ``other`` so degraded mass stays visible."""
        cubes = getattr(self.agg, "cubes", None)
        gb = sorted(set(group_by))
        md = cb.match_dimension(cubes.dims if cubes else [], gb,
                                name=name)
        if md is None:
            # no configured dimension covers the request (or no cube
            # plane at all — a global tier can hold forwarded cube
            # rows without local dimensions): serve whatever cube
            # rows carry EXACTLY the requested tag names
            dim, exact = cb.CubeDimension(gb), True
        else:
            dim, exact = md
        seed = cubes.seed if cubes is not None else 0
        mode, rank_p = parse_rank_by(by)
        qarr = np.asarray(list(qs), np.float64)
        qeval = list(qarr)
        if mode == "quantile" and rank_p not in qeval:
            qeval.append(rank_p)
        qeval = np.asarray(qeval, np.float64)

        now = time.time()
        td_slots, mo_slots, cc_slots, info = self._covering(
            window_s, slots, now)
        td_groups = self._fuse_group_clouds(td_slots, name, dim, kind)
        mo_groups = self._fuse_group_vectors(mo_slots, name, dim, kind)
        cc_groups = self._fuse_group_ladders(cc_slots, name, dim, kind)
        launch = 0
        if not exact:
            td_groups = self._coarsen_clouds(td_groups, gb)
            mo_groups, launch = self._coarsen_vectors(
                mo_groups, gb, seed)
            cc_groups = self._coarsen_ladders(cc_groups, gb)

        entries = []
        td_pending = []        # (entry, v, w, min, max): ONE batch
        mo_pending = []        # (entry, vector): solved in ONE batch
        cc_pending = []        # (entry, vector): read off in ONE batch
        for gkey in set(td_groups) | set(mo_groups) | set(cc_groups):
            td_g = td_groups.get(gkey)
            mo_v = mo_groups.get(gkey)
            cc_v = cc_groups.get(gkey)
            td_cnt = td_g["count"] if td_g else 0.0
            mo_cnt = float(mo_v[mo.IDX_COUNT]) if mo_v is not None \
                else 0.0
            cc_cnt = float(cc_v[cs.IDX_COUNT]) if cc_v is not None \
                else 0.0
            if td_cnt <= 0 and mo_cnt <= 0 and cc_cnt <= 0:
                continue
            e = {"key": gkey,
                 "group": cb.group_of(gkey.split(",")),
                 "mixed_families": sum(
                     c > 0 for c in (td_cnt, mo_cnt, cc_cnt)) > 1,
                 "quantiles": {}, "payload": None}
            # per-group family pick: same larger-mass rule as the
            # single-key read (families cannot merge exactly)
            if td_cnt >= mo_cnt and td_cnt >= cc_cnt:
                v = np.concatenate(td_g["v"]) if td_g["v"] else \
                    np.zeros(0)
                w = np.concatenate(td_g["w"]) if td_g["w"] else \
                    np.zeros(0)
                e.update(family="tdigest", count=td_cnt,
                         sum=td_g["sum"], min=float(td_g["min"]),
                         max=float(td_g["max"]))
                td_pending.append((e, v, w, float(td_g["min"]),
                                   float(td_g["max"])))
                if payload:
                    pv, pw = v, w
                    if len(pv) > PAYLOAD_POINT_CAP:
                        pv, pw = _compress_payload(
                            pv, pw, self.agg.digests.compression,
                            self.agg.device)
                    e["payload"] = {
                        "family": "tdigest",
                        "means": [float(x) for x in pv],
                        "weights": [float(x) for x in pw],
                        "min": float(td_g["min"]),
                        "max": float(td_g["max"]),
                        "count": td_cnt, "sum": td_g["sum"],
                        "rsum": td_g["rsum"]}
            elif mo_cnt >= cc_cnt:
                e.update(family="moments", count=mo_cnt,
                         sum=float(mo_v[mo.IDX_SUM]),
                         min=float(mo_v[mo.IDX_MIN]),
                         max=float(mo_v[mo.IDX_MAX]))
                mo_pending.append((e, mo_v))
                if payload:
                    e["payload"] = {"family": "moments",
                                    "k": self.agg.moments.k,
                                    "vector": [float(x) for x in mo_v]}
            else:
                e.update(family="compactor", count=cc_cnt,
                         sum=float(cc_v[cs.IDX_SUM]),
                         min=float(cc_v[cs.IDX_MIN]),
                         max=float(cc_v[cs.IDX_MAX]))
                cc_pending.append((e, cc_v))
                if payload:
                    e["payload"] = {"family": "compactor",
                                    "vector": [float(x) for x in cc_v]}
            entries.append(e)

        if td_pending:
            # one batched rank-and-interpolate for every digest group
            # (one global lexsort instead of G per-cloud sorts)
            allq = weighted_quantiles_np_batch(
                [p[1] for p in td_pending], [p[2] for p in td_pending],
                [p[3] for p in td_pending], [p[4] for p in td_pending],
                qeval)
            for (e, *_), quants in zip(td_pending, allq):
                if quants is not None:
                    e["quantiles"] = {repr(float(p)): float(x)
                                      for p, x in zip(qeval, quants)}
        if mo_pending:
            # one batched maxent solve for every moments group — the
            # per-group eager path costs hundreds of ms per call
            allq = me.quantiles_from_vectors(
                np.stack([v for _, v in mo_pending]), qeval,
                device=self.agg.device)
            for (e, _), quants in zip(mo_pending, allq):
                e["quantiles"] = {repr(float(p)): float(x)
                                  for p, x in zip(qeval, quants)}
        if cc_pending:
            allq = cs.quantiles_from_vectors(
                np.stack([v for _, v in cc_pending]), qeval)
            for (e, _), quants in zip(cc_pending, allq):
                e["quantiles"] = {repr(float(p)): float(x)
                                  for p, x in zip(qeval, quants)}

        groups_total = len(entries)
        entries = rank_groups(entries, mode, rank_p, seed, top)

        # the dimension's accounted overflow row (budget degradation):
        # fused like any single key, reported out loud next to the
        # exact groups so windowed cube answers reconcile
        ojtags = ",".join(sorted([cb.CUBE_TAG,
                                  cb.DIM_TAG_PREFIX + dim.dim_id]))
        otd = self._fuse_tdigest(td_slots, cb.OTHER_NAME, ojtags, kind)
        omo = self._fuse_moments(mo_slots, cb.OTHER_NAME, ojtags, kind)
        occ = self._fuse_compactor(cc_slots, cb.OTHER_NAME, ojtags,
                                   kind)
        ofam = max((otd, omo, occ), key=lambda f: f["count"])
        other = None
        if ofam["count"] > 0:
            other = {"family": ofam["family"], "count": ofam["count"],
                     "sum": ofam["sum"], "min": ofam["min"],
                     "max": ofam["max"], "quantiles": {},
                     "payload": (ofam["payload"]() if payload
                                 else None)}
            oq = ofam["eval"](qarr)
            if oq is not None:
                other["quantiles"] = {repr(float(p)): float(x)
                                      for p, x in zip(qarr, oq)}

        out = {
            "name": name, "group_by": gb,
            "dimension": list(dim.tags), "coarsened": not exact,
            "tier": self.tier, "host": self.hostname,
            "groups": entries, "groups_total": groups_total,
            "other": other, "top": top, "by": by,
            "cube_groups_per_launch": launch,
            "staleness_ms": (
                round((now - info["covered_to_unix"]) * 1e3, 3)
                if info["covered_to_unix"] else None),
        }
        out.update(info)
        return out

    def _fuse_group_clouds(self, slots_list, name, dim, kind) -> dict:
        """Digest-family cube fusion: canonical group key -> the fused
        accumulators + point-cloud parts across the covered slots."""
        groups: dict = {}
        for slot in slots_list:
            prt = slot.part
            for pos, gkey, _ in slot.cube_positions(
                    name, tuple(dim.tags), kind):
                g = groups.get(gkey)
                if g is None:
                    g = groups[gkey] = {
                        "count": 0.0, "sum": 0.0, "rsum": 0.0,
                        "min": np.inf, "max": -np.inf,
                        "v": [], "w": []}
                g["min"] = min(g["min"], float(prt["d_min"][pos]))
                g["max"] = max(g["max"], float(prt["d_max"][pos]))
                g["count"] += float(prt["d_weight"][pos])
                g["sum"] += float(prt["d_sum"][pos])
                g["rsum"] += float(prt["d_rsum"][pos])
                v, w = slot.points_for(prt["rows"][pos:pos + 1])
                if len(v):
                    g["v"].append(v)
                    g["w"].append(w)
        return groups

    def _fuse_group_vectors(self, slots_list, name, dim, kind) -> dict:
        """Moments-family cube fusion: ONE assemble_vectors walk per
        slot covers every group row (memoized per slot), then groups
        merge across slots by vector add."""
        marena = self.agg.moments
        groups: dict = {}
        for slot in slots_list:
            hits = slot.cube_positions(name, tuple(dim.tags), kind)
            if not hits:
                continue

            def _compute(slot=slot, hits=hits):
                parr = np.asarray([p for p, _, _ in hits], np.int64)
                sub = slot.staged_rows_for(slot.part["rows"][parr])
                vecs = marena.assemble_vectors(slot.part, sub, parr)
                return tuple(g for _, g, _ in hits), vecs
            gkeys, vecs = slot.vector_memo(
                ("\x00cube", name, tuple(dim.tags), kind), _compute)
            for gkey, vec in zip(gkeys, vecs):
                cur = groups.get(gkey)
                groups[gkey] = (
                    vec.copy() if cur is None
                    else mo.merge_vectors(cur[None, :],
                                          vec[None, :])[0])
        return groups

    def _fuse_group_ladders(self, slots_list, name, dim, kind) -> dict:
        """Compactor-family cube fusion: ONE assemble_vectors walk per
        slot covers every group row (memoized per slot), then groups
        merge across slots by concat-then-compact."""
        carena = self.agg.compactors
        groups: dict = {}
        for slot in slots_list:
            hits = slot.cube_positions(name, tuple(dim.tags), kind)
            if not hits:
                continue

            def _compute(slot=slot, hits=hits):
                parr = np.asarray([p for p, _, _ in hits], np.int64)
                sub = slot.staged_rows_for(slot.part["rows"][parr])
                vecs = carena.assemble_vectors(slot.part, sub, parr)
                return tuple(g for _, g, _ in hits), vecs
            gkeys, vecs = slot.vector_memo(
                ("\x00cube", name, tuple(dim.tags), kind), _compute)
            for gkey, vec in zip(gkeys, vecs):
                cur = groups.get(gkey)
                groups[gkey] = (
                    vec.copy() if cur is None
                    else cs.merge_vectors(cur[None, :],
                                          vec[None, :])[0])
        return groups

    @staticmethod
    def _coarsen_ladders(groups: dict, keep: list) -> dict:
        """Compactor sub-cube roll-up: fine group ladders merge under
        their projected coarse key on the host (the concat-then-
        compact merge is a per-pair host op — no batched kernel form,
        and cube group counts stay small enough that it doesn't earn
        one)."""
        out: dict = {}
        for gkey, vec in groups.items():
            ck = cb.project_group(gkey, keep)
            cur = out.get(ck)
            out[ck] = (vec if cur is None
                       else cs.merge_vectors(cur[None, :],
                                             vec[None, :])[0])
        return out

    @staticmethod
    def _coarsen_clouds(groups: dict, keep: list) -> dict:
        """Digest sub-cube roll-up: concatenate the fine groups' point
        clouds under their projected coarse key (host — clouds are
        already materialized lists)."""
        out: dict = {}
        for gkey, g in groups.items():
            ck = cb.project_group(gkey, keep)
            c = out.get(ck)
            if c is None:
                out[ck] = g
                continue
            c["count"] += g["count"]
            c["sum"] += g["sum"]
            c["rsum"] += g["rsum"]
            c["min"] = min(c["min"], g["min"])
            c["max"] = max(c["max"], g["max"])
            c["v"].extend(g["v"])
            c["w"].extend(g["w"])
        return out

    def _coarsen_vectors(self, groups: dict, keep: list, seed: int) -> tuple:
        """Moments sub-cube roll-up on the segmented-reduce kernel:
        the fine group vectors stack to ``[U, M]``, segment ids come
        from the SORTED fnv1a hash column of the projected coarse
        identities, and every coarse group reduces in one launch
        (ops/segmented_reduce.py).  Returns (coarse groups,
        groups_per_launch)."""
        if not groups:
            return {}, 0
        keys = sorted(groups)
        cks = [cb.project_group(k, keep) for k in keys]
        hs = np.array([fnv1a_64(c, seed) for c in cks], np.uint64)
        vecs = np.stack([groups[k] for k in keys])
        uniq, gvecs, launch = coarsen_moments_vectors(
            vecs, hs, device=self.agg.device)
        by_hash = {int(fnv1a_64(c, seed)): c for c in cks}
        return ({by_hash[int(h)]: gvecs[i]
                 for i, h in enumerate(uniq)}, launch)


# -- cross-tier merge (the proxy's scatter-gather codec) -----------------

def merge_responses(responses: list[dict], qs,
                    compression: float = 100.0, device=None) -> dict:
    """Merge tier /query answers through their self-describing
    payloads: digest payloads concatenate as weighted point clouds and
    re-evaluate through the same twin; moments payloads vector-add and
    re-solve.  Families that cannot merge exactly follow the
    larger-mass family with `mixed_families` flagged (the same
    degradation contract as a cross-tier sketch_family_rules
    mismatch).  Coverage metadata merges conservatively: staleness is
    the WORST upstream's, `partial`/`fresh` only hold if they hold
    everywhere.  A merged digest cloud past PAYLOAD_POINT_CAP points
    compresses, and a moments vector solves, on `device` (None:
    CUDA)."""
    qarr = np.asarray(list(qs), np.float64)
    td_v: list[np.ndarray] = []
    td_w: list[np.ndarray] = []
    td = {"count": 0.0, "sum": 0.0, "rsum": 0.0,
          "min": np.inf, "max": -np.inf}
    mo_vec = None
    cc_vec = None
    mixed = False
    for r in responses:
        mixed = mixed or bool(r.get("mixed_families"))
        p = r.get("payload")
        if not p:
            continue
        if p["family"] == "tdigest":
            td_v.append(np.asarray(p["means"], np.float64))
            td_w.append(np.asarray(p["weights"], np.float64))
            td["count"] += float(p["count"])
            td["sum"] += float(p["sum"])
            td["rsum"] += float(p.get("rsum", 0.0))
            td["min"] = min(td["min"], float(p["min"]))
            td["max"] = max(td["max"], float(p["max"]))
        elif p["family"] == "moments":
            vec = np.asarray(p["vector"], np.float64)
            mo_vec = (vec if mo_vec is None
                      else mo.merge_vectors(mo_vec[None, :],
                                            vec[None, :])[0])
        elif p["family"] == "compactor":
            vec = np.asarray(p["vector"], np.float64)
            cc_vec = (vec if cc_vec is None
                      else cs.merge_vectors(cc_vec[None, :],
                                            vec[None, :])[0])
    mo_count = float(mo_vec[mo.IDX_COUNT]) if mo_vec is not None else 0.0
    cc_count = float(cc_vec[cs.IDX_COUNT]) if cc_vec is not None else 0.0
    out = {
        "name": responses[0]["name"] if responses else "",
        "tags": responses[0].get("tags", []) if responses else [],
        "quantiles": {}, "count": 0.0, "sum": 0.0,
        "min": None, "max": None, "family": "none",
        "mixed_families": mixed or sum(
            c > 0 for c in (td["count"], mo_count, cc_count)) > 1,
        "slots_fused": sum(r.get("slots_fused") or 0
                           for r in responses),
        "partial": any(r.get("partial") for r in responses),
        "fresh": bool(responses) and all(r.get("fresh")
                                         for r in responses),
        "staleness_ms": max(
            (r["staleness_ms"] for r in responses
             if r.get("staleness_ms") is not None), default=None),
        "payload": None,
    }
    if (td["count"] >= mo_count and td["count"] >= cc_count
            and td["count"] > 0):
        v = np.concatenate(td_v)
        w = np.concatenate(td_w)
        quants = weighted_quantiles_np(v, w, td["min"], td["max"],
                                       qarr)
        out.update(family="tdigest", count=td["count"], sum=td["sum"],
                   min=float(td["min"]), max=float(td["max"]))
        if quants is not None:
            out["quantiles"] = {repr(float(p)): float(x)
                                for p, x in zip(qarr, quants)}
        if len(v) > PAYLOAD_POINT_CAP:
            v, w = _compress_payload(v, w, compression, device)
        out["payload"] = {"family": "tdigest",
                          "means": [float(x) for x in v],
                          "weights": [float(x) for x in w],
                          "min": float(td["min"]),
                          "max": float(td["max"]),
                          "count": td["count"], "sum": td["sum"],
                          "rsum": td["rsum"]}
    elif mo_count >= cc_count and mo_count > 0:
        quants = me.quantiles_from_vectors(mo_vec[None, :], qarr,
                                           device=device)[0]
        out.update(family="moments", count=mo_count,
                   sum=float(mo_vec[mo.IDX_SUM]),
                   min=float(mo_vec[mo.IDX_MIN]),
                   max=float(mo_vec[mo.IDX_MAX]))
        out["quantiles"] = {repr(float(p)): float(x)
                            for p, x in zip(qarr, quants)}
        out["payload"] = {"family": "moments",
                          "k": mo.k_from_len(len(mo_vec)),
                          "vector": [float(x) for x in mo_vec]}
    elif cc_count > 0:
        quants = cs.quantiles_from_vectors(cc_vec[None, :], qarr)[0]
        out.update(family="compactor", count=cc_count,
                   sum=float(cc_vec[cs.IDX_SUM]),
                   min=float(cc_vec[cs.IDX_MIN]),
                   max=float(cc_vec[cs.IDX_MAX]))
        out["quantiles"] = {repr(float(p)): float(x)
                            for p, x in zip(qarr, quants)}
        out["payload"] = {"family": "compactor",
                          "vector": [float(x) for x in cc_vec]}
    return out


def merge_range_responses(responses: list[dict], qs,
                          compression: float = 100.0,
                          device=None) -> dict:
    """Merge tier range answers bin by bin: upstream bins align on
    their [t_start, t_end) bounds (every upstream answered the same
    validated spec, so the bin grid is shared), and each aligned
    bucket of bins runs through the same self-describing payload codec
    as the point merge (merge_responses per bin).  Coverage stays
    conservative: a bin's covered span is the union the upstreams
    report, `partial`/`fresh`/staleness merge exactly like the point
    form."""
    by_bin: dict = {}
    for r in responses:
        for b in r.get("series") or ():
            kb = (round(float(b["t_start"]), 6),
                  round(float(b["t_end"]), 6))
            by_bin.setdefault(kb, []).append(b)
    series = []
    for kb in sorted(by_bin):
        bl = by_bin[kb]
        pseudo = [{"name": "", "payload": b.get("payload"),
                   "mixed_families": b.get("mixed_families"),
                   "slots_fused": None, "partial": False,
                   "fresh": True, "staleness_ms": None} for b in bl]
        m = merge_responses(pseudo, qs, compression, device)
        froms = [b["covered_from_unix"] for b in bl
                 if b.get("covered_from_unix") is not None]
        tos = [b["covered_to_unix"] for b in bl
               if b.get("covered_to_unix") is not None]
        series.append({
            "t_start": kb[0], "t_end": kb[1],
            "source": "merged",
            "coverage_s": max((b.get("coverage_s") or 0.0
                               for b in bl), default=0.0),
            "covered_from_unix": min(froms) if froms else None,
            "covered_to_unix": max(tos) if tos else None,
            "family": m["family"], "count": m["count"],
            "sum": m["sum"], "min": m["min"], "max": m["max"],
            "mixed_families": m["mixed_families"],
            "quantiles": m["quantiles"], "payload": m["payload"]})
    first = responses[0] if responses else {}
    tos = [b["covered_to_unix"] for b in series
           if b["covered_to_unix"] is not None]
    return {
        "name": first.get("name", ""),
        "tags": first.get("tags", []),
        "range": True,
        "since": first.get("since"), "until": first.get("until"),
        "step": first.get("step"), "bins": len(series),
        "series": series,
        "sources": sorted({s for r in responses
                           for s in (r.get("sources") or ())}),
        "covered_from_unix": min(
            (b["covered_from_unix"] for b in series
             if b["covered_from_unix"] is not None), default=None),
        "covered_to_unix": max(tos) if tos else None,
        "partial": any(r.get("partial") for r in responses),
        "fresh": bool(responses) and all(r.get("fresh")
                                         for r in responses),
        "staleness_ms": max(
            (r["staleness_ms"] for r in responses
             if r.get("staleness_ms") is not None), default=None),
    }


def merge_group_responses(responses: list[dict], qs,
                          compression: float = 100.0,
                          top: Optional[int] = None,
                          by: Optional[str] = None,
                          device=None) -> dict:
    """Merge tier group-by /query answers: bucket every upstream's
    group entries by canonical group key, run each bucket through the
    same self-describing payload codec as the single-key merge
    (merge_responses per group), then re-rank for ``top=K&by=`` over
    the MERGED stats — top-k must apply after the merge, since a group
    inside one tier's top-k can fall out of (or into) the global top-k
    once the other tiers' mass lands.  The accounted ``other`` rows
    merge the same way, and coverage metadata stays conservative."""
    mode, rank_p = parse_rank_by(by)
    qeval = [float(x) for x in qs]
    if mode == "quantile" and rank_p not in qeval:
        qeval.append(rank_p)

    def _pseudo(r, g):
        return {"name": r.get("name", ""),
                "payload": g.get("payload"),
                "mixed_families": g.get("mixed_families"),
                "slots_fused": r.get("slots_fused"),
                "partial": r.get("partial"),
                "fresh": r.get("fresh"),
                "staleness_ms": r.get("staleness_ms")}

    buckets: dict = {}
    others: list[dict] = []
    groups_total = 0
    launch = 0
    for r in responses:
        groups_total += int(r.get("groups_total") or 0)
        launch = max(launch, int(r.get("cube_groups_per_launch") or 0))
        for g in r.get("groups") or ():
            buckets.setdefault(g["key"], []).append(_pseudo(r, g))
        if r.get("other"):
            others.append(_pseudo(r, r["other"]))

    entries = []
    for gkey, pseudo in buckets.items():
        m = merge_responses(pseudo, qeval, compression, device)
        if m["count"] <= 0:
            continue
        entries.append({
            "key": gkey, "group": cb.group_of(gkey.split(",")),
            "family": m["family"], "count": m["count"],
            "sum": m["sum"], "min": m["min"], "max": m["max"],
            "quantiles": m["quantiles"], "payload": m["payload"],
            "mixed_families": m["mixed_families"]})
    # proxies rank with seed 0: the scatter-gather answer must not
    # depend on which member's cube seed the proxy happens to know
    entries = rank_groups(entries, mode, rank_p, 0, top)

    other = None
    if others:
        m = merge_responses(others, qeval, compression, device)
        if m["count"] > 0:
            other = {"family": m["family"], "count": m["count"],
                     "sum": m["sum"], "min": m["min"], "max": m["max"],
                     "quantiles": m["quantiles"],
                     "payload": m["payload"]}

    first = responses[0] if responses else {}
    return {
        "name": first.get("name", ""),
        "group_by": first.get("group_by") or [],
        "coarsened": any(r.get("coarsened") for r in responses),
        "groups": entries, "groups_total": groups_total,
        "other": other, "top": top, "by": by,
        "cube_groups_per_launch": launch,
        "slots_fused": sum(r.get("slots_fused") or 0
                           for r in responses),
        "partial": any(r.get("partial") for r in responses),
        "fresh": bool(responses) and all(r.get("fresh")
                                         for r in responses),
        "staleness_ms": max(
            (r["staleness_ms"] for r in responses
             if r.get("staleness_ms") is not None), default=None),
    }
