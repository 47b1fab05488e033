"""The port's compactor family held against the JAX package on the CPU.

The same numpy-seeded inputs go through `veneur_tpu` and through
`veneur_tpu_torch` (device="cpu", where kernel B6's wrapper runs its plain
PyTorch version).  The rules, each with its reason:

  * sketch math (sketches/compactor.py: the coin, the pass planner, the
    host pass, the sketch and its wire vectors): bitwise — the port
    keeps its own copy of the same numpy code;
  * B6's plain version against the host pass `apply_pass`, the JAX
    package's XLA twin and its Pallas kernel in interpret mode: bitwise
    on rows without zeros of both signs.  All of them sort values and
    select by position; the port sorts under the IEEE total order (-0
    below +0), the JAX sorts leave -0 and +0 in no fixed order, so on
    rows with both the outputs agree by value (-0 == +0) only;
  * the ladder read-off (`make_compactor_flush`) against the JAX
    read-off: within READOFF_REL relative, because XLA and PyTorch add
    the f32 prefix sums of the weights in their own orders;
  * arenas, aggregators and servers: ladder state, wire vectors, counts,
    sums, min and max bitwise; quantiles within READOFF_REL relative.

Also here: the `Config` field repair (every JAX field exists in the
port with the same default, served or refused), and the new entry points' refusal to run without CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from veneur_tpu import config as jconfig
from veneur_tpu.core import arena as jarena
from veneur_tpu.core.aggregator import MetricAggregator as JAggregator
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.ops import compactor_eval as jce
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.samplers import samplers as jsm
from veneur_tpu.samplers.metric_key import MetricKey as JKey
from veneur_tpu.samplers.metric_key import MetricScope as JScope
from veneur_tpu.sinks import simple as jsimple
from veneur_tpu.sketches import compactor as jcs
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.core import arena as tarena
from veneur_tpu_torch.core.aggregator import MetricAggregator
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import compactor_eval as ce
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.samplers import samplers as tsm
from veneur_tpu_torch.samplers.metric_key import MetricKey, MetricScope
from veneur_tpu_torch.sinks import simple as tsimple
from veneur_tpu_torch.sketches import compactor as cs

READOFF_REL = 1e-6
PCTS = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "count", "sum", "avg", "median", "hmean"]
RULES = [{"match": "c.*", "family": "compactor"}]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# sketch math: bitwise
# ---------------------------------------------------------------------------

def test_constants_and_vector_layout_match_jax():
    names = ("DEFAULT_CAP", "DEFAULT_LEVELS", "DEFAULT_SEED", "STAGE_MUL",
             "BUF_MUL", "CLIP_ROUNDS", "IDX_COUNT", "IDX_SUM", "IDX_RSUM",
             "IDX_MIN", "IDX_MAX", "IDX_CAP", "IDX_LEVELS", "IDX_SEED",
             "IDX_COMPS", "IDX_CLIP", "HDR", "_FCLAMP")
    assert [getattr(cs, n) for n in names] == [getattr(jcs, n)
                                               for n in names]
    for cap, levels in ((8, 4), (128, 14), (256, 32)):
        assert cs.vector_len(cap, levels) == jcs.vector_len(cap, levels)
        np.testing.assert_array_equal(cs.empty_vector(cap, levels, 7),
                                      jcs.empty_vector(cap, levels, 7))
        assert cs.keep_of(cap) == jcs.keep_of(cap)
    for n in (0.0, 100.0, 128.0, 5e4, 1e6, 1e9):
        assert cs.rank_error_bound(n) == jcs.rank_error_bound(n)


def test_coin_bits_and_plan_pass_are_bitwise():
    """The splitmix64 coin (uint64 arithmetic with wraparound, counters
    up to 2^62) and the pass planner on seeded batches, at three
    geometries and seeds."""
    rng = np.random.default_rng(0)
    comps = np.concatenate([rng.integers(0, 1 << 62, 200),
                            np.arange(50)])
    for seed in (0, jcs.DEFAULT_SEED, (1 << 64) - 1):
        for lvl in (0, 5, 33):
            np.testing.assert_array_equal(cs.coin_bits(seed, lvl, comps),
                                          jcs.coin_bits(seed, lvl, comps))
    for cap, levels, seed in ((8, 4, 1), (32, 14, jcs.DEFAULT_SEED),
                              (128, 14, 99)):
        stage_n = rng.integers(0, 2 * cap + 1, (300, levels))
        stage_n[:20] = 2 * cap                      # both clip rounds
        comps = rng.integers(0, 1 << 40, 300)
        clip = rng.integers(0, 3, 300)
        for got, want in zip(cs.plan_pass(stage_n, comps, clip, seed, cap),
                             jcs.plan_pass(stage_n, comps, clip, seed, cap)):
            np.testing.assert_array_equal(got, want)
        off, cnt, _, clip_out = cs.plan_pass(stage_n, comps, clip, seed, cap)
        assert (cnt <= cap).all() and (clip_out[:20] == clip[:20] + 2).all()


def _staged(rng, u, cap, levels, zeros=False):
    """Level staging of seeded rows: gamma floats (f32-exact), tied
    integers, and every 5th row full on every level (which drives the
    top level through both clip rounds); zeros=True puts -0 and +0
    among ties.  Returns (stage_v f32, stage_n, off, cnt_out)."""
    s2 = 2 * cap
    stage_n = rng.integers(0, s2 + 1, (u, levels))
    stage_n[::5] = s2
    stage_n[1::7] = 0
    stage_v = np.full((u, levels, s2), np.inf, np.float32)
    for i in range(u):
        for lvl in range(levels):
            k = stage_n[i, lvl]
            if zeros:
                v = rng.choice([-0.0, 0.0, -1.0, 1.0, 3.0], k)
            elif i % 2:
                v = np.floor(rng.gamma(1.0, 3.0, k))
            else:
                v = rng.gamma(2.0, 10.0, k)
            stage_v[i, lvl, :k] = v
    off, cnt, _, _ = jcs.plan_pass(stage_n, rng.integers(0, 1 << 30, u),
                                   np.zeros(u, np.int64), jcs.DEFAULT_SEED,
                                   cap)
    return stage_v, stage_n, off, cnt


def _plain(stage_v, stage_n, off) -> np.ndarray:
    return ce.compact_batch(torch.from_numpy(stage_v),
                            torch.from_numpy(stage_n.astype(np.int32)),
                            torch.from_numpy(off.astype(np.int32))).numpy()


def test_apply_pass_and_sketch_are_bitwise():
    """The host pass, the single-key sketch (add, merge, wire vector,
    quantiles, rank) and the batched vector merge of the port's copy,
    against the JAX package's."""
    rng = np.random.default_rng(1)
    stage_v, stage_n, off, _ = _staged(rng, 40, 16, 6)
    np.testing.assert_array_equal(
        _bits(cs.apply_pass(stage_v, stage_n, off, 16)),
        _bits(jcs.apply_pass(stage_v, stage_n, off, 16)))
    for cap, levels in ((16, 6), (128, 14)):
        ours, theirs = (cs.CompactorSketch(cap, levels),
                        jcs.CompactorSketch(cap, levels))
        data = [rng.gamma(2.0, 10.0, 3000), rng.normal(0, 5, 700)]
        wts = [None, rng.integers(1, 5, 700).astype(np.float64)]
        for v, w in zip(data, wts):
            ours.add_batch(v, w)
            theirs.add_batch(v, w)
        np.testing.assert_array_equal(ours.to_vector(), theirs.to_vector())
        other = jcs.CompactorSketch(cap, levels)
        other.add_batch(rng.gamma(3.0, 4.0, 900))
        ours.merge(other.to_vector())
        theirs.merge(other)
        np.testing.assert_array_equal(ours.to_vector(), theirs.to_vector())
        np.testing.assert_array_equal(ours.quantiles(PCTS),
                                      theirs.quantiles(PCTS))
        vec = ours.to_vector()
        assert cs.rank_of(vec, 12.5) == jcs.rank_of(vec, 12.5)
        pair = np.stack([vec, other.to_vector()])
        np.testing.assert_array_equal(
            cs.merge_vectors(pair, pair[::-1]),
            jcs.merge_vectors(pair, pair[::-1]))


# ---------------------------------------------------------------------------
# B6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,levels,u", [(8, 4, 30), (16, 5, 8),
                                          (32, 14, 25), (128, 3, 6)])
def test_b6_plain_matches_apply_pass_and_the_twin(cap, levels, u):
    """Bitwise on rows without zeros, at four geometries, with rows
    that take both clip rounds and rows of tied integers."""
    rng = np.random.default_rng(cap + levels)
    stage_v, stage_n, off, cnt = _staged(rng, u, cap, levels)
    got = _plain(stage_v, stage_n, off)
    host = jcs.apply_pass(stage_v, stage_n, off, cap).astype(np.float32)
    twin = jce.compact_batch(stage_v, stage_n, off)
    np.testing.assert_array_equal(_bits(got), _bits(host))
    np.testing.assert_array_equal(_bits(got), _bits(twin))
    live = np.arange(cap)[None, None, :] < cnt[:, :, None]
    assert np.isfinite(got[live]).all() and np.isposinf(got[~live]).all()


def test_b6_plain_matches_pallas_interpret_mode():
    """The JAX package's kernel itself, in interpret mode, at its own
    test's shape (cap 16, levels 5, U 8): bitwise."""
    rng = np.random.default_rng(5)
    stage_v, stage_n, off, _ = _staged(rng, 8, 16, 5)
    interp = jce.compact_batch(stage_v, stage_n, off, interpret=True)
    np.testing.assert_array_equal(_bits(_plain(stage_v, stage_n, off)),
                                  _bits(interp))


def test_b6_plain_orders_signed_zeros_by_the_total_order():
    """Rows of -0, +0 and ties: equal by value to the host pass and to
    the twin, and every level's live prefix is sorted under the total
    order (each -0 before each +0), so the kernel and its plain version
    can be held to each other bitwise."""
    rng = np.random.default_rng(6)
    stage_v, stage_n, off, cnt = _staged(rng, 30, 8, 5, zeros=True)
    got = _plain(stage_v, stage_n, off)
    for ref in (jcs.apply_pass(stage_v, stage_n, off, 8),
                jce.compact_batch(stage_v, stage_n, off)):
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32))
    keys = _bits(got)
    keys = np.where(keys < 0, keys ^ 0x7FFFFFFF, keys)     # total order
    live = np.arange(8)[None, None, :] < cnt[:, :, None]
    steps = np.diff(keys, axis=2) >= 0
    assert steps[live[:, :, 1:]].all()
    assert (np.signbit(got) & (got == 0)).any()


def test_b6_plain_reads_the_occupied_prefix_and_the_coin_bit():
    """What lies past each level's occupancy, and the bits of an offset
    above the lowest, do not reach the output (the kernel reads the
    same)."""
    rng = np.random.default_rng(7)
    stage_v, stage_n, off, _ = _staged(rng, 12, 8, 4)
    want = _plain(stage_v, stage_n, off)
    junk = stage_v.copy()
    junk[np.isinf(junk)] = -5.0
    np.testing.assert_array_equal(_bits(_plain(junk, stage_n, off + 2)),
                                  _bits(want))


def test_b6_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(8)
    stage_v, stage_n, off, _ = _staged(rng, 4, 8, 4)
    args = (torch.from_numpy(stage_v),
            torch.from_numpy(stage_n.astype(np.int32)),
            torch.from_numpy(off.astype(np.int32)))
    ce.reset_launches()
    np.testing.assert_array_equal(
        _bits(ce.compact_batch(*args).numpy()),
        _bits(ce.compact_batch_plain(*args).numpy()))
    assert ce.launches["compact_batch"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ce.compact_batch(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="several devices"):
        ce.compact_batch(args[0].to("meta"), *args[1:])


# ---------------------------------------------------------------------------
# a numpy model of B6's kernel (ops/csrc/compactor_eval.cu)
# ---------------------------------------------------------------------------

_PAD = np.uint32(0xFF800000)          # the key of +inf


def _to_key(v) -> np.ndarray:
    """float32 -> the kernel's unsigned key (the IEEE total order)."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _from_key(k) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(
        np.uint32).view(np.float32)


def _b6_model(stage_v, stage_n, off) -> np.ndarray:
    """B6's formulation, a key at a time: per level, sort only the 2cap
    staged keys (+inf padding; a positive NaN keys above it, "big");
    the buffer is the sorted staging when nothing is carried (big keys
    read +inf), the carry when nothing is staged, else the rank merge of
    the sorted staging with the sorted carry padded to 2cap (staged key
    i at i + #(carry < key), carry key j at j + #(staged <= key)); then
    the next carry (item 2j + offset, clamped to +inf), the retained
    items m .. occ-1 (clamped) and the top level's two clip rounds by
    index arithmetic, each round's big kept keys behind 4cap - kept
    +inf, as the plain version's re-sort puts them."""
    u, levels, s2 = stage_v.shape
    cap = s2 // cs.STAGE_MUL
    keep, nbuf = cs.keep_of(cap), cs.BUF_MUL * cap
    idx = np.arange(s2)
    out = np.empty((u, levels, cap), np.float32)
    for row in range(u):
        below, carry_n, carry_o = None, 0, 0
        for lvl in range(levels):
            n = int(np.clip(stage_n[row, lvl], 0, s2))
            occ = n + carry_n
            if occ == 0:
                out[row, lvl] = np.inf
                continue
            staged = np.full(s2, _PAD)
            staged[:n] = _to_key(stage_v[row, lvl, :n])
            staged = np.sort(staged)
            carry = np.full(s2, _PAD)
            if carry_n:
                carry[:carry_n] = np.minimum(
                    below[carry_o:carry_o + 2 * carry_n:2], _PAD)
            if carry_n == 0:
                buf = np.minimum(staged[:n], _PAD)
            elif n == 0:
                buf = carry[:carry_n]
            else:
                merged = np.empty(2 * s2, np.uint32)
                merged[idx + np.searchsorted(carry, staged, "left")] = staged
                merged[idx + np.searchsorted(staged, carry, "right")] = carry
                buf = merged[:occ]
            if lvl < levels - 1:
                sec = occ - keep
                m = sec - (sec & 1) if occ > cap else 0
                ret = np.full(cap, _PAD)
                ret[:occ - m] = np.minimum(buf[m:occ], _PAD)
                out[row, lvl] = _from_key(ret)
                below, carry_n = buf, m // 2
                carry_o = int(off[row, lvl]) & 1
            else:
                top = occ
                for r in range(cs.CLIP_ROUNDS):
                    m = top - (top & 1) if top > cap else 0
                    o = int(off[row, levels + r]) & 1
                    kept = np.concatenate([buf[o:m:2], buf[m:top]])
                    ks = int((kept <= _PAD).sum())
                    buf = np.full(nbuf, _PAD)
                    buf[:ks] = kept[:ks]
                    buf[nbuf - (len(kept) - ks):] = kept[ks:]
                    top -= m // 2
                out[row, lvl] = _from_key(buf[:cap])
    return out


def _b6_kernel_rows(rng, cap, levels, kind):
    """Staged rows for the model: `ties` (_staged's gamma floats and tied
    integers, rows full on every level, rows empty), `zeros` (-0, +0,
    -1, 1, 3 at every level, so staging and carry share keys), `carry`
    (level 0 full, then every other level empty: levels with n == 0
    and a carry, beside levels with both) and `nan` (positive NaNs of
    several payloads and +inf as 6 in 10 staged items, every other row
    full on every level, so more than cap of them reach a buffer and
    some are promoted)."""
    stage_v, stage_n, off, _ = _staged(rng, 24, cap, levels,
                                       zeros=kind == "zeros")
    s2 = 2 * cap
    if kind == "carry":
        stage_n[:, 0] = s2
        stage_n[:, 1::2] = 0
        stage_n[::3, 2::2] = s2
    if kind == "nan":
        bits = np.asarray([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0x7F800000,
                           0xFFC00000], np.uint32)
        pick = bits[rng.integers(0, len(bits), stage_v.shape)]
        hit = rng.random(stage_v.shape) < 0.6
        stage_v = np.where(hit, pick.view(np.float32), stage_v)
        stage_n[::2] = s2
    off, _, _, _ = jcs.plan_pass(stage_n, rng.integers(0, 1 << 30, 24),
                                 np.zeros(24, np.int64), jcs.DEFAULT_SEED,
                                 cap)
    return (np.ascontiguousarray(stage_v, np.float32), stage_n, off)


@pytest.mark.parametrize("kind", ["ties", "zeros", "carry", "nan"])
@pytest.mark.parametrize("cap,levels", chip_smoke.B6_GEOMETRIES)
def test_b6_kernel_formulation_is_bitwise_plain(cap, levels, kind):
    """The kernel's formulation (sort the staging alone, merge the
    sorted carry by rank, select by index, clip the top) gives the plain
    version's bits at every geometry `chip_smoke.py` holds the kernel
    to, on tied integers, on +-0 in staging and carry, on levels with
    nothing staged but a carry, and on positive NaNs, which the plain
    version sorts behind its +inf padding."""
    rng = np.random.default_rng(cap * 100 + levels + len(kind))
    stage_v, stage_n, off = _b6_kernel_rows(rng, cap, levels, kind)
    want = _plain(stage_v, stage_n, off)
    np.testing.assert_array_equal(_bits(_b6_model(stage_v, stage_n, off)),
                                  _bits(want))
    if kind == "nan":
        assert np.isnan(want).any()
    if kind == "zeros":
        assert (np.signbit(want) & (want == 0)).any()


def test_b6_kernel_formulation_on_c4s_smallest_input():
    """ROADMAP C4's smallest input (cap 8, levels 2, level 0 staged
    [1, -0, 0, -0, -0, 0, 0, 0, -0], coin offsets [1, 0, 0, 0]): the
    model and the plain version give level 0 [0, 0, 0, 0, 1] and level 1
    [-0, -0], bit for bit."""
    stage_v = np.full((1, 2, 16), np.inf, np.float32)
    stage_v[0, 0, :9] = [1, -0.0, 0, -0.0, -0.0, 0, 0, 0, -0.0]
    stage_n = np.asarray([[9, 0]])
    off = np.asarray([[1, 0, 0, 0]])
    got = _b6_model(stage_v, stage_n, off)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_plain(stage_v, stage_n, off)))
    want0 = np.asarray([0, 0, 0, 0, 1, np.inf, np.inf, np.inf], np.float32)
    want1 = np.asarray([-0.0, -0.0] + [np.inf] * 6, np.float32)
    np.testing.assert_array_equal(_bits(got[0, 0]), _bits(want0))
    np.testing.assert_array_equal(_bits(got[0, 1]), _bits(want1))


def test_b6_source_runs_the_shared_warp_network_without_barriers():
    """B6 sorts with sort_network.cuh's warp_bitonic (no second network
    of its own) and its warps never wait for each other: no
    __syncthreads, only __syncwarp."""
    import re
    from pathlib import Path
    src = (Path(ce.__file__).parent / "csrc" / "compactor_eval.cu"
           ).read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert '#include "sort_network.cuh"' in code
    assert "warp_bitonic<" in code and "__syncwarp()" in code
    assert "__syncthreads" not in code and "bitonic_sort" not in code


# ---------------------------------------------------------------------------
# the read-off
# ---------------------------------------------------------------------------

def _ladders(rng, u, cap, levels):
    """Folded ladder states of seeded sketches, as the arena hands them
    to the read-off (zero padding beyond each occupancy), with the
    exact-count scales and bounds; rows 0 and 1 empty."""
    cvals = np.zeros((u, levels, cap), np.float32)
    ccnt = np.zeros((u, levels), np.int32)
    cscale = np.ones(u, np.float32)
    mm = np.zeros((2, u), np.float32)
    for i in range(2, u):
        sk = cs.CompactorSketch(cap, levels)
        n = int(rng.integers(1, 40 * cap))
        sk.add_batch(rng.gamma(2.0, 10.0, n).astype(np.float32),
                     rng.integers(1, 4, n).astype(np.float64))
        live = np.arange(cap)[None, :] < sk.cnt[:, None]
        cvals[i] = np.where(live, sk.vals, 0.0)
        ccnt[i] = sk.cnt
        mass = (sk.cnt * 2.0 ** np.arange(levels)).sum()
        cscale[i] = sk.count / mass
        mm[:, i] = sk.min, sk.max
    return cvals.reshape(u, levels * cap), ccnt, cscale, mm


def test_readoff_matches_jax():
    rng = np.random.default_rng(9)
    cap, levels = 16, 6
    ops = _ladders(rng, 40, cap, levels)
    pct = np.asarray([0.5] + PCTS + [0.0, 1.0], np.float32)
    want = np.asarray(jce.make_compactor_flush(cap, levels)(*ops, pct))
    got = ce.make_compactor_flush(cap, levels, device="cpu")(
        *(torch.from_numpy(x) for x in ops), torch.from_numpy(pct)).numpy()
    assert got.shape == want.shape == (40, len(pct))
    np.testing.assert_allclose(got, want, rtol=READOFF_REL, atol=0)
    assert (got[:2] == 0).all()


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

def _arena_pair(cap=16, levels=6):
    return (jarena.CompactorArena(cap=cap, levels=levels),
            tarena.CompactorArena(cap=cap, levels=levels, device="cpu"))


def test_arena_fold_merge_and_vectors_match_jax():
    """The same staged points (one row past DENSE_DEPTH_CAP, so the
    mid-interval fold runs at sync) and the same imported ladders into
    the JAX arena and the port's: ladder state after sync, the flush's
    folded snapshot and the assembled wire vectors are bitwise equal."""
    rng = np.random.default_rng(10)
    ja, ta = _arena_pair()
    n_rows = 6
    rows = {}
    for arena, key, scope in ((ja, JKey, JScope), (ta, MetricKey,
                                                   MetricScope)):
        rows[id(arena)] = [arena.row_for(key(f"c.k{i}", "histogram", ""),
                                         scope.MIXED, [])
                           for i in range(n_rows)]
    depth = [tarena.DENSE_DEPTH_CAP + 90, 300, 40, 1, 0, 700]
    imports = {3: jcs.CompactorSketch(16, 6), 4: jcs.CompactorSketch(16, 6)}
    for sk in imports.values():
        sk.add_batch(rng.gamma(2.0, 10.0, int(rng.integers(50, 900))))
    for i, d in enumerate(depth):
        vals = rng.gamma(2.0, 10.0, d)
        wts = np.where(rng.random(d) < 0.2, 2.0, 1.0)
        for arena in (ja, ta):
            r = rows[id(arena)][i]
            arena.sample_batch(np.full(d, r, np.int64), vals, wts)
            if i in imports:
                arena.merge_compactor(r, imports[i].to_vector())
    for arena in (ja, ta):
        arena.sync()
    for name in ("cvals", "ccnt", "ccomps", "cclip", "d_weight", "d_sum",
                 "d_min", "d_max", "d_rsum", "_depth"):
        np.testing.assert_array_equal(getattr(ta, name)[:n_rows],
                                      getattr(ja, name)[:n_rows],
                                      err_msg=name)
    assert ta.ccnt[0].any() and ta._depth[0] == 0     # folded at sync
    vecs = []
    for arena in (ja, ta):
        prows = np.asarray(rows[id(arena)], np.int64)
        part = {"rows": prows, "staged": arena.take_staged(),
                **{n: getattr(arena, n)[prows].copy()
                   for n in ("cvals", "ccnt", "ccomps", "cclip", "d_min",
                             "d_max", "d_weight", "d_sum", "d_rsum")}}
        vecs.append(arena.assemble_vectors(part, part["staged"],
                                           np.arange(n_rows)))
    np.testing.assert_array_equal(vecs[1], vecs[0])
    for i, d in enumerate(depth):
        assert vecs[1][i, cs.IDX_COUNT] == ta.d_weight[i]


def test_arena_refuses_a_mesh_bad_geometry_and_other_params():
    with pytest.raises(ValueError, match="unmeshed"):
        tarena.CompactorArena(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="bad compactor params"):
        tarena.CompactorArena(cap=12, device="cpu")
    ta = tarena.CompactorArena(device="cpu")
    other = jcs.CompactorSketch(cap=32, levels=8)
    other.add_batch(np.arange(1.0, 100.0))
    with pytest.raises(ValueError, match="do not match"):
        ta.merge_compactor(0, other.to_vector())


# ---------------------------------------------------------------------------
# the aggregator and the server
# ---------------------------------------------------------------------------

def _lines(rng, integer: bool) -> tuple[list[bytes], dict]:
    """Compactor keys of 1..3000 samples (one local-only, one
    global-only, one sampled, one timer) beside a t-digest key and a
    counter."""
    out, vals = [], {}
    shapes = (("c.h0", 3000, b""), ("c.h1", 700, b"|#az:b"),
              ("c.h2", 130, b"|#veneurglobalonly"),
              ("c.h3", 90, b"|#veneurlocalonly"), ("c.h4", 1, b""),
              ("c.s", 400, b"|@0.5"))
    for name, n, suffix in shapes:
        v = (np.floor(rng.gamma(2.0, 20.0, n)) + 1 if integer
             else np.round(rng.gamma(2.0, 20.0, n), 4))
        vals[name] = v
        kind = b"ms" if name == "c.h1" else b"h"
        fmt = b"%s:%d|%s%s" if integer else b"%s:%.4f|%s%s"
        out += [fmt % (name.encode(), x, kind, suffix) for x in v]
    out += [b"d.h:%d|h" % x for x in rng.integers(1, 100, 50)]
    out += [b"t.hits:%d|c" % x for x in rng.integers(1, 9, 20)]
    return out, vals


def _aggs(is_local, **kw):
    common = dict(percentiles=PCTS, is_local=is_local,
                  sketch_family_rules=RULES, **kw)
    return (JAggregator(aggregates=jsm.parse_aggregates(AGGS), **common),
            MetricAggregator(aggregates=tsm.parse_aggregates(AGGS),
                             device="cpu", **common))


def _feed(pair, lines):
    for agg, p in zip(pair, (jparser.Parser(), tparser.Parser())):
        for line in lines:
            p.parse_metric(line, agg.process_metric)


def _by_key(metrics):
    return {(m.name, tuple(m.tags), m.type): m.value for m in metrics}


def _assert_same(got, want):
    """Quantiles within READOFF_REL, everything else exact."""
    got, want = _by_key(got), _by_key(want)
    assert set(got) == set(want) and got
    for key, w in want.items():
        g = got[key]
        if key[0].endswith(("percentile", ".median")):
            assert abs(g - w) <= READOFF_REL * abs(w), (key, g, w)
        else:
            assert g == w or (np.isnan(g) and np.isnan(w)), (key, g, w)


def _assert_same_forwards(got, want) -> int:
    assert sorted((f.name, f.kind) for f in got) == \
        sorted((f.name, f.kind) for f in want)
    by = {(f.name, f.kind): f for f in want}
    n = 0
    for f in got:
        j = by[(f.name, f.kind)]
        assert (f.tags, int(f.scope)) == (j.tags, int(j.scope))
        assert (f.compactor is None) == (j.compactor is None)
        if f.compactor is not None:
            assert f.compactor == j.compactor, f.name          # bitwise
            n += 1
    return n


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("is_local", [False, True])
def test_aggregator_emits_and_forwards_what_jax_does(is_local, integer):
    rng = np.random.default_rng(11 + 2 * is_local + integer)
    pair = _aggs(is_local)
    lines, _ = _lines(rng, integer)
    _feed(pair, lines)
    want = pair[0].flush(is_local=is_local, now=100)
    got = pair[1].flush(is_local=is_local, now=100)
    _assert_same(got.metrics, want.metrics)
    if is_local:
        # every compactor key but the local-only one forwards a ladder
        assert _assert_same_forwards(got.forward, want.forward) == 5
    assert len(pair[1].compactors.kdict) == 6
    assert len(pair[1].digests.kdict) == 1
    seg = pair[1].last_flush_segments
    assert seg["keys_compactor"] == 6 and seg["c_fold_s"] > 0


def test_ladder_imports_match_jax_one_by_one_and_batched():
    """Forwarded ladders (several per key, and one of other params that
    fails alone) through import_metric and import_metrics: the ladder
    state is bitwise JAX's and the global flush the same."""
    rng = np.random.default_rng(12)
    fms = []
    for i in range(9):
        sk = jcs.CompactorSketch()
        sk.add_batch(rng.gamma(2.0, 10.0, int(rng.integers(1, 4000))))
        fms.append(dict(name=f"c.i{i % 4}", tags=["az:a"], kind="histogram",
                        scope=2 if i % 4 == 3 else 0,
                        compactor=list(sk.to_vector())))
    bad = jcs.CompactorSketch(cap=64)
    bad.add_batch(np.arange(1.0, 9.0))
    fms.insert(3, dict(name="c.i1", tags=["az:a"], kind="histogram",
                       scope=0, compactor=list(bad.to_vector())))
    jagg, one = _aggs(False)
    many = _aggs(False)[1]
    for f in fms:
        for agg, cls in ((jagg, jsm), (one, tsm)):
            if f is fms[3]:
                with pytest.raises(ValueError, match="do not match"):
                    agg.import_metric(cls.ForwardMetric(**f))
            else:
                agg.import_metric(cls.ForwardMetric(**f))
    assert many.import_metrics(
        [tsm.ForwardMetric(**f) for f in fms]) == (len(fms) - 1, 1)
    for name in ("cvals", "ccnt", "ccomps", "cclip", "d_weight", "d_sum",
                 "d_min", "d_max"):
        for port in (one, many):
            np.testing.assert_array_equal(
                getattr(port.compactors, name)[:4],
                getattr(jagg.compactors, name)[:4], err_msg=name)
    want = jagg.flush(is_local=False, now=3)
    for port in (one, many):
        _assert_same(port.flush(is_local=False, now=3).metrics,
                     want.metrics)


class _Pair:
    """A JAX server and a port server with the compactor rule."""

    def __init__(self, local: bool):
        common = dict(percentiles=PCTS, aggregates=AGGS, hostname="box",
                      interval=3600.0, sketch_family_rules=RULES)
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

    def run(self, lines):
        for i in range(0, len(lines), 20):
            buf = b"\n".join(lines[i:i + 20])
            self.jsrv.process_packet_buffer(buf)
            self.tsrv.process_packet_buffer(buf)
        self.jsrv.flush()
        self.jsrv.egress.settle(timeout_s=10.0)
        self.tsrv.flush()
        assert self.tsrv.egress.settle(timeout_s=10.0)
        assert self.tsrv.wait_forwards(10.0), "port forward never landed"
        return ([m for b in _drain(self.jsink) for m in b],
                [m for b in _drain(self.tsink) for m in b])

    def close(self):
        self.jsrv.shutdown()
        self.tsrv.shutdown()


def _drain(sink):
    out = []
    while not sink.queue.empty():
        out.append(sink.queue.get())
    return out


@pytest.mark.parametrize("is_local", [False, True])
def test_server_slice_emits_what_the_jax_server_does(is_local):
    """The slice end to end: the same packets into a JAX Server and a
    port Server with the compactor rule; the InterMetrics agree (and a
    local's forwarded ladders are bitwise the JAX one's)."""
    rng = np.random.default_rng(13 + is_local)
    lines, _ = _lines(rng, integer=False)
    pair = _Pair(local=is_local)
    try:
        jm, tm = pair.run(lines)
        _assert_same(tm, jm)
        if is_local:
            import time
            deadline = time.time() + 10.0
            while not pair.jfwd and time.time() < deadline:
                time.sleep(0.01)
            assert _assert_same_forwards(pair.tfwd, pair.jfwd) == 5
    finally:
        pair.close()


def test_local_to_global_hop_conserves_counts():
    """Port servers wired local -> global in-process: the global's
    counts of forwarded keys equal what the local saw, and its
    quantiles are the JAX global's after the same hop."""
    rng = np.random.default_rng(15)
    lines, vals = _lines(rng, integer=True)
    glob = Server(tconfig.Config(percentiles=PCTS, aggregates=AGGS,
                                 sketch_family_rules=RULES),
                  device="cpu")
    local = Server(tconfig.Config(percentiles=PCTS, aggregates=AGGS,
                                  sketch_family_rules=RULES,
                                  forward_address="in-process"),
                   forwarder=glob.aggregator.import_metrics, device="cpu")
    jl, _ = _aggs(True)
    jg, _ = _aggs(False)
    _feed((jl, local.aggregator), lines)
    for f in jl.flush(is_local=True).forward:
        jg.import_metric(f)
    local.flush()
    assert local.wait_forwards(10.0)
    cp = glob.aggregator.compactors
    row = cp.kdict[(MetricKey("c.h2", "histogram", ""),
                    MetricScope.GLOBAL_ONLY)]
    assert cp.d_weight[row] == len(vals["c.h2"])
    want = jg.flush(is_local=False, now=5)
    got = glob.aggregator.flush(is_local=False, now=5)
    _assert_same(got.metrics, want.metrics)
    gm = {m.name: m.value for m in got.metrics}
    assert gm["c.h2.count"] == len(vals["c.h2"])


@pytest.mark.parametrize("is_local", [False, True])
def test_restore_of_jax_checkpoint_with_compactor_rows(is_local):
    """A JAX cut holding compactor rows (staged samples, a ladder folded
    mid-interval, an imported ladder, an untouched row) restores into
    the port, whose next flush emits what the JAX aggregator's does; the
    port's own cut restores too."""
    rng = np.random.default_rng(16 + is_local)
    src, ref = _aggs(is_local)[0], _aggs(is_local)[0]
    lines, _ = _lines(rng, integer=True)
    sk = jcs.CompactorSketch()
    sk.add_batch(rng.gamma(2.0, 10.0, 2000))
    p = jparser.Parser()
    for agg in (src, ref):
        for line in lines + [b"c.once:4|h"]:
            p.parse_metric(line, agg.process_metric)
        agg.flush(is_local=is_local)
        for line in lines:
            p.parse_metric(line, agg.process_metric)
        agg.import_metric(jsm.ForwardMetric(
            name="c.imp", tags=["x:1"], kind="histogram", scope=0,
            compactor=list(sk.to_vector())))
        agg.sync_staged(min_samples=1)
    meta, arrays = src.checkpoint_state()
    assert len(arrays["compactors/key_rows"]) == 8
    assert not arrays["compactors/key_touched"].all()
    port = MetricAggregator(percentiles=PCTS, is_local=is_local,
                            aggregates=tsm.parse_aggregates(AGGS),
                            sketch_family_rules=RULES, device="cpu")
    port.restore_state(meta, arrays)
    want = ref.flush(is_local=is_local, now=9)
    got = port.flush(is_local=is_local, now=9)
    _assert_same(got.metrics, want.metrics)
    if is_local:
        assert _assert_same_forwards(got.forward, want.forward) == 6
    again = MetricAggregator(percentiles=PCTS, sketch_family_rules=RULES,
                             device="cpu")
    again.restore_state(*port.checkpoint_state())


# ---------------------------------------------------------------------------
# Config (ROADMAP C3) and the entry points
# ---------------------------------------------------------------------------

def _default(f):
    return (f.default if f.default_factory is dataclasses.MISSING
            else f.default_factory())


def _other_value(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 3
    if isinstance(value, str):
        return value + "x"
    if isinstance(value, list):
        return value + ["x"]
    if isinstance(value, dict):
        return {"x": "y"}
    return 1                                      # None


def test_config_has_every_jax_field_served_or_refused():
    """Every field of the JAX Config exists in the port's with the same
    default (native_ingest and its ingest_* options served); each is
    served or listed in UNSUPPORTED, and an unsupported one raises
    NotImplementedError at any value but its default."""
    port = {f.name: f for f in dataclasses.fields(tconfig.Config)}
    jax_fields = dataclasses.fields(jconfig.Config)
    assert "native_ingest" not in tconfig.UNSUPPORTED
    assert "cardinality_key_budget" not in tconfig.UNSUPPORTED
    assert "retention_tiers" in tconfig.UNSUPPORTED
    for f in jax_fields:
        assert f.name in port, f.name
        assert _default(port[f.name]) == _default(f), f.name
    assert set(tconfig.UNSUPPORTED) <= set(port)
    served = set(port) - set(tconfig.UNSUPPORTED)
    assert {"sketch_compactor_cap", "sketch_compactor_levels",
            "sketch_compactor_seed", "sketch_family_default"} <= served
    tconfig.Config(**{f.name: _default(f) for f in jax_fields
                      if f.name in port})
    for name in tconfig.UNSUPPORTED:
        with pytest.raises(NotImplementedError, match=name):
            tconfig.Config(**{name: _other_value(_default(port[name]))})


@pytest.mark.parametrize("field,value", [
    ("sketch_compactor_cap", 0), ("sketch_compactor_cap", 4),
    ("sketch_compactor_cap", 8), ("sketch_compactor_cap", 12),
    ("sketch_compactor_cap", 256), ("sketch_compactor_cap", 512),
    ("sketch_compactor_levels", 0), ("sketch_compactor_levels", 3),
    ("sketch_compactor_levels", 4), ("sketch_compactor_levels", 32),
    ("sketch_compactor_levels", 33)])
def test_config_compactor_geometry_matches_jax(field, value):
    """The ladder geometry's ranges (cap a power of two in [8, 256],
    levels in [4, 32], 0 for the default) and messages are the JAX
    package's."""
    def outcome(make, **kw):
        try:
            make(**kw)
            return None
        except ValueError as e:
            return str(e)

    def jax_config(**kw):
        # the JAX package validates in apply_defaults
        jconfig.Config(native_ingest=False, **kw).apply_defaults()

    want = outcome(jax_config, **{field: value})
    assert outcome(tconfig.Config, **{field: value}) == want
    assert outcome(tconfig.Config, sketch_family_default="compactor",
                   sketch_family_rules=RULES) is None


def test_server_routes_compactor_geometry_to_the_arena():
    srv = Server(tconfig.Config(sketch_family_default="compactor",
                                sketch_compactor_cap=32,
                                sketch_compactor_levels=8,
                                sketch_compactor_seed=5), device="cpu")
    cp = srv.aggregator.compactors
    assert (cp.cc_cap, cp.cc_levels, cp.cc_seed) == (32, 8, 5)
    srv.process_packet_buffer(b"a:1|h\na:4|h\na:9|h")
    res = srv.flush()
    assert {m.name: m.value for m in res.metrics}["a.count"] == 3.0
    assert len(cp.kdict) == 1 and not srv.aggregator.digests.kdict


def test_compactor_entry_points_refuse_cpu_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ce.make_compactor_flush()
    with pytest.raises(RuntimeError, match="CUDA"):
        tarena.CompactorArena()
    with pytest.raises(RuntimeError, match="CUDA"):
        MetricAggregator(sketch_family_default="compactor")


def test_compactor_slice_imports_neither_jax_nor_the_jax_package():
    """A local tier folds compactor keys and forwards their ladders to a
    global in a fresh process: no jax* and no veneur_tpu module loads."""
    import os
    import subprocess
    import sys
    import textwrap
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        from veneur_tpu_torch.config import Config
        from veneur_tpu_torch.core.server import Server
        rules = [{"match": "c.*", "family": "compactor"}]
        glob = Server(Config(sketch_family_rules=rules,
                             percentiles=[0.5]), device="cpu")
        local = Server(Config(sketch_family_rules=rules,
                              forward_address="in-process"),
                       forwarder=glob.aggregator.import_metrics,
                       device="cpu")
        local.process_packet_buffer(b"\\n".join(
            b"c.h:%d|h" % i for i in range(300)))
        local.flush()
        assert local.wait_forwards(10.0)
        got = {m.name: m.value for m in glob.flush().metrics}
        assert got["c.h.50percentile"] > 0, got
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "veneur_tpu" or m.startswith("veneur_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
