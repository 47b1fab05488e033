"""Per-tenant cardinality defense: key budgets and mergeable tail rollups.

Counterpart of `veneur_tpu.core.cardinality`, decision for decision:
the same resolve results, epochs, eviction order and checkpoint state
on the same sightings.  One tenant emitting millions of unique series
grows the arenas without bound and blows the flush interval; the guard
bounds that:

  - every tenanted metric key (a key carrying the configured tenant tag,
    `tenant:<t>` by default) counts against its tenant's key budget;
  - while a tenant is under budget its keys get exact arena rows;
  - once the budget is full, the long tail rewrites to one reserved
    per-(tenant, type, scope) rollup key, `veneur.rollup.<type>` tagged
    `veneur_rollup:true` and with the tenant tag, so the tail's samples
    fold into one sketch per family instead of a row per key.

The rollup state is whatever the family's arena keeps, so it composes
across tiers: counters add, sets union, histogram digests merge, and a
gauge keeps an arbitrary tail member's last value (the reserved tag
tells downstream it is degraded).

Eviction is deterministic (seeded, count-ordered): per flush interval
the guard tracks touch counts of the exact set and of a bounded
space-saving table of rolled keys (capacity = budget); at interval end
a rolled candidate that strictly out-touched the coldest exact key
swaps with it, the cold key's arena row is released at once and the hot
key gets an exact row from its next sample on.  Ties break on a seeded
fnv1a of the key identity, so replays are bit-stable.  Exact keys idle
for IDLE_EXACT_INTERVALS flushes leave the budget the same way.  Every
swap bumps `epoch`, which the native drain's id cache uses to
invalidate its row bindings.  (The JAX package's `arena.evict`
failpoint on the release, and its `/debug/vars` and `cardinality.*`
self-metrics, are ROADMAP A16; `snapshot()` is the observer they read.)

Budgets are per tenant, so a workload whose tenant tag itself explodes
is not defended; the guard's own memory stays bounded regardless, since
a tenant whose exact set and candidate table are both empty is pruned
at the interval boundary.

Thread-safety: every mutating method (resolve, end_interval) runs under
the owning aggregator's lock; the guard takes no lock.  snapshot() and
over_budget_tenants() are read-only observers that iterate list()
copies, safe without the lock.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from veneur_tpu_torch.samplers.metric_key import (MetricKey, MetricScope,
                                            fnv1a_64, identity_string)

# reserved marker tag: downstream consumers can tell degraded (rolled-up)
# series from exact ones by its presence
ROLLUP_TAG = "veneur_rollup:true"
# reserved name prefix of the per-(tenant, type) rollup series
ROLLUP_NAME_PREFIX = "veneur.rollup."

# flush intervals an exact key may stay untouched before its budget slot
# (and arena row) is reclaimed — mirrors the arenas' IDLE_GC_INTERVALS
IDLE_EXACT_INTERVALS = 10


class _Tenant:
    __slots__ = ("exact", "idle", "candidates", "ranks", "cand_heap",
                 "seq", "evicted_total", "rollup_points")

    def __init__(self):
        # (MetricKey, scope) -> touches this interval, for admitted keys
        self.exact: dict = {}
        # (MetricKey, scope) -> consecutive untouched intervals
        self.idle: dict = {}
        # bounded space-saving table of rolled keys' interval touches:
        # dk -> [count, rank] (rank = seeded identity hash, computed
        # ONCE per membership, never per comparison)
        self.candidates: dict = {}
        # dk -> rank memo, held only for current exact + candidate
        # members (bounded at ~2x budget; pruned with the entries)
        self.ranks: dict = {}
        # lazy min-heap over candidates: (count, rank, seq, dk) entries
        # pushed on insert AND on count update; stale entries (count no
        # longer matching the table) discard at pop time.  Replaces the
        # O(budget) min() scan per new over-budget key with O(log H)
        self.cand_heap: list = []
        self.seq = 0
        self.evicted_total = 0
        self.rollup_points = 0


class CardinalityGuard:
    def __init__(self, budget: int, tenant_tag: str = "tenant",
                 seed: int = 0):
        if budget <= 0:
            raise ValueError("cardinality budget must be positive "
                             "(leave the guard off instead)")
        self.budget = int(budget)
        self.tenant_tag = tenant_tag
        self._prefix = tenant_tag + ":"
        self.seed = int(seed)
        # bumped whenever a key's exact/rolled bucket changes (interval-
        # end swaps only); row caches keyed on it revalidate lazily
        self.epoch = 0
        self.tenants: dict[str, _Tenant] = {}
        self.keys_evicted_total = 0
        self.rollup_points_total = 0
        # (type, scope, tenant) -> (rollup MetricKey, scope, tags)
        self._rollup_cache: dict = {}

    # -- classification (hot path, under the aggregator lock) -------------

    def tenant_of(self, tags: list[str]) -> Optional[str]:
        for t in tags:
            if t.startswith(self._prefix):
                return t[len(self._prefix):]
        return None

    def resolve(self, key: MetricKey, scope: MetricScope,
                tags: list[str], n: int = 1):
        """Classify one key sighting carrying `n` samples.  Returns None
        to keep the original identity (untenanted, or exact under
        budget), or the (rollup_key, scope, rollup_tags) rewrite for the
        folded tail.  Also the ONLY place touch counts accrue, so
        callers must invoke it once per staged batch even on cached
        rows."""
        tenant = self.tenant_of(tags)
        if tenant is None:
            return None
        st = self.tenants.get(tenant)
        if st is None:
            st = self.tenants[tenant] = _Tenant()
        dk = (key, scope)
        cnt = st.exact.get(dk)
        if cnt is not None:
            st.exact[dk] = cnt + n
            return None
        if len(st.exact) < self.budget:
            st.exact[dk] = n
            self._rank_of(st, dk)
            return None
        # over budget: the tail folds into the rollup sketch
        cand = st.candidates
        entry = cand.get(dk)
        if entry is not None:
            entry[0] += n
            self._heap_push(st, entry[0], entry[1], dk)
        elif len(cand) < self.budget:
            rank = self._rank_of(st, dk)
            cand[dk] = [n, rank]
            self._heap_push(st, n, rank, dk)
            self.keys_evicted_total += 1
            st.evicted_total += 1
        else:
            # space-saving replacement: the new key inherits the
            # smallest candidate's count (deterministic victim via the
            # seeded tie-break, found through the lazy heap), so a
            # genuinely hot newcomer can still earn promotion while the
            # table stays budget-bounded
            vcount, _, vdk = self._heap_min(st)
            del cand[vdk]
            if vdk not in st.exact:
                st.ranks.pop(vdk, None)
            heapq.heappop(st.cand_heap)
            rank = self._rank_of(st, dk)
            cand[dk] = [vcount + n, rank]
            self._heap_push(st, vcount + n, rank, dk)
            self.keys_evicted_total += 1
            st.evicted_total += 1
        st.rollup_points += n
        self.rollup_points_total += n
        return self._rollup_identity(key.type, scope, tenant)

    @staticmethod
    def _heap_push(st: _Tenant, count: int, rank: int, dk) -> None:
        # lazy updates leave stale tuples behind; COMPACT once the heap
        # outgrows a small multiple of the live table, so a high-rate
        # stable tail (every sample an update-push) cannot grow the
        # heap unboundedly within an interval — the tracking must never
        # itself become the explosion it defends against
        if len(st.cand_heap) > 4 * len(st.candidates) + 64:
            st.seq = len(st.candidates)
            st.cand_heap = [
                (e[0], e[1], i, cdk)
                for i, (cdk, e) in enumerate(st.candidates.items())]
            heapq.heapify(st.cand_heap)
            if dk in st.candidates:
                return   # the rebuild already carries the fresh count
        st.seq += 1
        heapq.heappush(st.cand_heap, (count, rank, st.seq, dk))

    @staticmethod
    def _heap_min(st: _Tenant):
        """Current space-saving minimum: pop stale heap entries (their
        key left the table or its count moved on) until the top matches
        the live table.  Amortized O(log H) — every entry is discarded
        at most once."""
        while st.cand_heap:
            count, rank, _, dk = st.cand_heap[0]
            entry = st.candidates.get(dk)
            if entry is not None and entry[0] == count:
                return count, rank, dk
            heapq.heappop(st.cand_heap)
        raise RuntimeError("space-saving heap empty with a full "
                           "candidate table")  # unreachable by invariant

    def _rank_hash(self, dk) -> int:
        # the canonical identity encoding (samplers/metric_key.py),
        # seeded: the JAX guard's ranks, byte for byte
        return fnv1a_64(identity_string(*dk), self.seed)

    def _rank_of(self, st: _Tenant, dk) -> int:
        """Memoized seeded tie-break rank, computed once per exact/
        candidate membership (never per comparison — the hot path stays
        off the per-byte identity hash)."""
        r = st.ranks.get(dk)
        if r is None:
            r = st.ranks[dk] = self._rank_hash(dk)
        return r

    def _rollup_identity(self, mtype: str, scope: MetricScope,
                         tenant: str):
        ck = (mtype, scope, tenant)
        rolled = self._rollup_cache.get(ck)
        if rolled is None:
            tags = sorted([ROLLUP_TAG, f"{self.tenant_tag}:{tenant}"])
            rkey = MetricKey(ROLLUP_NAME_PREFIX + mtype, mtype,
                             ",".join(tags))
            rolled = self._rollup_cache[ck] = (rkey, scope, tags)
        return rolled

    # -- interval-end eviction (under the aggregator lock, at snapshot) ----

    def end_interval(self,
                     evict_cb: Optional[Callable[[list], None]] = None
                     ) -> int:
        """Seeded count-ordered eviction: promote rolled candidates that
        strictly out-touched the coldest exact keys, retire exact keys
        idle for IDLE_EXACT_INTERVALS, and reset the interval counters.

        `evict_cb(evicted_dks)` runs ONCE with the full planned eviction
        list BEFORE any guard state mutates (it is the arena row
        release); if it raises, the pass aborts with the quota state
        untouched — a fault mid-eviction can delay reclamation, never
        corrupt it.  Returns keys evicted."""
        planned: list[tuple] = []   # (tenant, evicted dk, promoted dk|None)
        for tenant, st in self.tenants.items():
            # idle decay first: an exact key untouched for the window
            # frees its budget slot (its arena row is released too)
            exact_live: dict = {}
            for dk, cnt in st.exact.items():
                idle = st.idle.get(dk, 0) + 1 if cnt == 0 else 0
                st.idle[dk] = idle
                if idle >= IDLE_EXACT_INTERVALS:
                    planned.append((tenant, dk, None))
                else:
                    exact_live[dk] = cnt
            if not st.candidates:
                continue
            # one sort each way (ranks are memoized per membership, so
            # no identity re-hashing here), then a two-pointer walk:
            # hottest candidates vs coldest exact keys.  Equivalent to
            # repeated max/min extraction — candidates are consumed
            # hottest-first, so a promoted key can never be displaced
            # by a LATER (colder) candidate in the same pass — without
            # the O(swaps x budget) rescans
            cand_desc = sorted(
                ((e[0], e[1], dk) for dk, e in st.candidates.items()),
                reverse=True)
            exact_asc = sorted(
                ((cnt, self._rank_of(st, dk), dk)
                 for dk, cnt in exact_live.items()))
            n_live = len(exact_live)
            ci = xi = 0
            while ci < len(cand_desc):
                hot_cnt, _, hot_dk = cand_desc[ci]
                if n_live < self.budget:
                    # headroom (idle decay, or a raised budget): the
                    # hottest candidates claim the free slots
                    planned.append((tenant, None, hot_dk))
                    ci += 1
                    n_live += 1
                    continue
                if xi >= len(exact_asc):
                    break
                cold_cnt, _, cold_dk = exact_asc[xi]
                if hot_cnt <= cold_cnt:
                    break   # strict: promotion must be earned
                planned.append((tenant, cold_dk, hot_dk))
                ci += 1
                xi += 1

        evicted = [(t, dk) for t, dk, _ in planned if dk is not None]
        if evicted and evict_cb is not None:
            evict_cb([dk for _, dk in evicted])

        changed = False
        for tenant, cold_dk, hot_dk in planned:
            st = self.tenants[tenant]
            if cold_dk is not None:
                st.exact.pop(cold_dk, None)
                st.idle.pop(cold_dk, None)
                st.evicted_total += 1
                self.keys_evicted_total += 1
                changed = True
            if hot_dk is not None:
                st.candidates.pop(hot_dk, None)
                st.exact[hot_dk] = 0
                st.idle[hot_dk] = 0
                changed = True
        for st in self.tenants.values():
            for dk in st.exact:
                st.exact[dk] = 0
            st.candidates.clear()
            st.cand_heap.clear()
            st.seq = 0
            # the rank memo follows the membership: exact keys only at
            # the interval boundary (candidates re-memoize on re-sight)
            st.ranks = {dk: st.ranks[dk] for dk in st.exact
                        if dk in st.ranks}
        # prune tenants that hold nothing: a fleet with ephemeral tenant
        # values (one key per tenant, never over budget) must not grow
        # the guard's own state without bound — the very hazard it
        # exists to defend the arenas against
        empty = [t for t, st in self.tenants.items()
                 if not st.exact and not st.candidates]
        for t in empty:
            del self.tenants[t]
        if changed:
            self.epoch += 1
        return len(evicted)

    # -- crash checkpoint (core/checkpoint.py) -----------------------------

    @staticmethod
    def _dk_list(d: dict) -> list:
        return [[k.name, k.type, k.joined_tags, int(s), int(v)]
                for (k, s), v in d.items()]

    @staticmethod
    def _dk_dict(rows: list) -> dict:
        return {(MetricKey(str(n), str(t), str(j)),
                 MetricScope(int(s))): int(v)
                for n, t, j, s, v in rows}

    def checkpoint_state(self) -> dict:
        """JSON-able quota ledger (call under the aggregator lock):
        budgets, per-tenant exact sets and candidate counts, epoch and
        totals — restoring it means an over-budget tenant's tail keeps
        folding into the SAME rollup identity after a crash, so the
        degraded-data contract (rollup name + reserved tag) survives
        the restart exactly."""
        return {
            "epoch": self.epoch,
            "keys_evicted_total": self.keys_evicted_total,
            "rollup_points_total": self.rollup_points_total,
            "tenants": {
                t: {"exact": self._dk_list(st.exact),
                    "idle": self._dk_list(st.idle),
                    "candidates": [
                        [dk[0].name, dk[0].type, dk[0].joined_tags,
                         int(dk[1]), int(e[0])]
                        for dk, e in st.candidates.items()],
                    "evicted_total": st.evicted_total,
                    "rollup_points": st.rollup_points}
                for t, st in self.tenants.items()},
        }

    def restore_state(self, state: dict) -> None:
        """Rebuild the ledger (fresh guard, under the aggregator lock).
        Ranks are recomputed from the seeded identity hash — a pure
        function, so eviction order replays bit-identically — and the
        candidate heap is rebuilt from the restored table."""
        self.epoch = int(state.get("epoch", 0))
        self.keys_evicted_total = int(state.get("keys_evicted_total", 0))
        self.rollup_points_total = int(
            state.get("rollup_points_total", 0))
        for t, ts in (state.get("tenants") or {}).items():
            st = self.tenants[t] = _Tenant()
            st.exact = self._dk_dict(ts.get("exact") or [])
            st.idle = self._dk_dict(ts.get("idle") or [])
            st.evicted_total = int(ts.get("evicted_total", 0))
            st.rollup_points = int(ts.get("rollup_points", 0))
            for n, ty, j, s, cnt in (ts.get("candidates") or []):
                dk = (MetricKey(str(n), str(ty), str(j)),
                      MetricScope(int(s)))
                st.candidates[dk] = [int(cnt), self._rank_of(st, dk)]
            for dk in st.exact:
                self._rank_of(st, dk)
            st.cand_heap = [(e[0], e[1], i, dk) for i, (dk, e)
                            in enumerate(st.candidates.items())]
            heapq.heapify(st.cand_heap)
            st.seq = len(st.cand_heap)

    # -- observability -----------------------------------------------------

    def over_budget_tenants(self) -> int:
        # list() copy: safe against a concurrent first-sight insert on
        # the ingest path (observers run without the aggregator lock)
        return sum(1 for st in list(self.tenants.values())
                   if len(st.exact) >= self.budget)

    def snapshot(self) -> dict:
        """Global totals plus the per-tenant quota ledger (the JAX
        package's /debug/vars payload).  Lock-free observer: it
        iterates list() copies, so a racing tenant insert can skew a
        count by one, never raise."""
        return {
            "budget": self.budget,
            "tenant_tag": self.tenant_tag,
            "keys_evicted": self.keys_evicted_total,
            "rollup_points": self.rollup_points_total,
            "tenants_over_budget": self.over_budget_tenants(),
            "epoch": self.epoch,
            "tenants": {
                t: {"exact_keys": len(st.exact),
                    "evicted_total": st.evicted_total,
                    "rollup_points": st.rollup_points,
                    "over_budget": len(st.exact) >= self.budget}
                for t, st in list(self.tenants.items())},
        }
