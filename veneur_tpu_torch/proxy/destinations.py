"""Destination set + consistent-hash routing + per-destination breaker.

Counterpart of `veneur_tpu.proxy.destinations`, which mirrors
`proxy/destinations/destinations.go`: Add connects new addresses in
parallel (`Add`, destinations.go:47-81), Get routes a key through the
hash ring (`:129-142`), closed connections self-remove
(`ConnectionClosed`, `:100-126`), Clear tears everything down.

On top of the reference semantics, each address carries a CIRCUIT BREAKER:
`breaker_threshold` consecutive failures (abrupt close, failed dial) TRIP
it — the address is removed from the ring, so every key that hashed to it
reroutes to the survivors (consistent-hash route-around), and re-adds are
refused while the breaker is open.  After `breaker_reset_s` (doubling per
consecutive trip, capped at 8x) the next add() for the address becomes the
HALF-OPEN probe: one real dial — success closes the breaker and restores
the member to the ring; failure re-opens it with a longer cooldown.  The
discovery poll (proxy.go:345-387 -> set_members) drives the probes: every
poll re-offers the wanted membership, and the breaker decides which offers
turn into dials.

Membership changes run as a TWO-PHASE ELASTIC RESHARD (set_members):
joiners connect while the old ring still serves, then each leaver drains
its undelivered buffer through the proxy's handoff back onto the new ring
(drain-and-forward) instead of dropping it.  Consistent hashing bounds
movement at ~K/N keys per node joining an N-ring; every reshard commits a
record (epoch, members, sampled keys moved, handoff counts, duration) at
/debug/vars -> reshard.  An engaged (open/half-open) breaker survives the
flap, so a reshard can never resurrect a tripped destination without a
successful probe.

Not here yet: the `destinations.add` and `destinations.reshard`
failpoints, and the breaker and reshard spans of the flight recorder
(ROADMAP A16).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time

import numpy as np

from veneur_tpu_torch.proxy import consistent
from veneur_tpu_torch.proxy.connect import Destination
from veneur_tpu_torch.proxy.consistent import ConsistentHash

logger = logging.getLogger("veneur_tpu_torch.proxy.destinations")


class _Breaker:
    """Per-address failure state.  Guarded by the Destinations lock."""

    __slots__ = ("failures", "trips", "open_until", "half_open")

    def __init__(self):
        self.failures = 0       # consecutive failures since last success
        self.trips = 0          # times the breaker has opened
        self.open_until = 0.0   # monotonic deadline; 0 = not open
        self.half_open = False  # a probe dial is in flight

    def state(self, now: float) -> str:
        if self.half_open:
            return "half_open"
        if self.open_until > now:
            return "open"
        if self.open_until:
            return "probe_due"
        return "closed"


class Destinations:
    # cooldown doubles per consecutive trip, capped at this multiple
    BREAKER_MAX_BACKOFF_X = 8

    def __init__(self, send_buffer_size: int = 1024, grpc_stats=None,
                 n_streams: int = 8, send_timeout_s: float = 30.0,
                 dial_timeout_s: float = 5.0,
                 stream_timeout_s: float = 0.0,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0,
                 handoff=None,
                 handoff_timeout_s: float = 2.0,
                 reshard_sample_keys: int = 2048):
        self.send_buffer_size = send_buffer_size
        self.n_streams = n_streams
        self.grpc_stats = grpc_stats
        self.send_timeout_s = send_timeout_s
        self.dial_timeout_s = dial_timeout_s
        self.stream_timeout_s = stream_timeout_s
        self.breaker_threshold = max(1, breaker_threshold)
        self.breaker_reset_s = breaker_reset_s
        # reshard drain-and-forward: `handoff(metrics)` re-routes a
        # retiring destination's undelivered buffer through the NEW ring
        # (the proxy wires handle_metrics in); None = legacy behavior,
        # swept items stay accounted as dropped
        self.handoff = handoff
        self.handoff_timeout_s = handoff_timeout_s
        self.reshard_sample_keys = reshard_sample_keys
        self._lock = threading.Lock()
        self._ring = ConsistentHash()
        self._dests: dict[str, Destination] = {}
        self._breakers: dict[str, _Breaker] = {}
        # sent/dropped totals of destinations that have been removed —
        # without this, a dead destination's drop accounting would vanish
        # from stats() with it (silent loss in the chaos arithmetic)
        self._retired_sent = 0
        self._retired_dropped = 0
        self._ring_cache = None   # (hashes, didx, dests); see ring_arrays
        # elastic-reshard bookkeeping: one reshard window at a time
        # (reshard_begin acquires, reshard_commit releases), the last
        # committed record for /debug/vars, and cumulative totals
        self._reshard_serial = threading.Lock()
        self._reshard_epoch = 0
        self._reshard_moved_total = 0
        self._reshard_handoff_total = 0
        self._last_reshard: dict | None = None

    # -- breaker bookkeeping (all under self._lock) ------------------------

    def _record_failure(self, address: str) -> None:
        with self._lock:
            b = self._breakers.setdefault(address, _Breaker())
            b.failures += 1
            b.half_open = False
            if b.failures >= self.breaker_threshold or b.trips:
                # past the threshold (or re-failing a half-open probe):
                # open with exponential cooldown
                b.trips += 1
                backoff = min(2 ** (b.trips - 1), self.BREAKER_MAX_BACKOFF_X)
                b.open_until = time.monotonic() + self.breaker_reset_s * backoff
                logger.warning(
                    "destination %s circuit OPEN (%d consecutive "
                    "failures, trip #%d, retry in %.1fs); routing around "
                    "via the ring", address, b.failures, b.trips,
                    self.breaker_reset_s * backoff)

    def _record_success(self, address: str) -> None:
        """A dial succeeded.  Only a post-trip (half-open) probe closes
        the breaker — a mere successful dial must NOT reset the
        consecutive-failure count, or a half-broken peer that accepts
        dials but kills every RPC would flap connect/fail/reconnect
        forever without ever reaching the threshold."""
        with self._lock:
            b = self._breakers.get(address)
            if b is None:
                return
            if b.trips or b.half_open:
                logger.info("destination %s circuit CLOSED "
                            "(probe succeeded); restored to the ring",
                            address)
                del self._breakers[address]

    def _admit(self, address: str) -> bool:
        """May we dial this address now?  False while its breaker is
        open; an expired breaker admits ONE dial (the half-open probe)."""
        with self._lock:
            b = self._breakers.get(address)
            if b is None:
                return True
            now = time.monotonic()
            if b.half_open:
                return False            # a probe is already in flight
            if b.open_until > now:
                return False
            if b.open_until:
                b.half_open = True      # this dial is the probe
            return True

    def breaker_stats(self) -> dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            return {a: {"state": b.state(now), "failures": b.failures,
                        "trips": b.trips,
                        "retry_in_s": round(max(0.0, b.open_until - now), 3)}
                    for a, b in self._breakers.items()}

    # -- membership --------------------------------------------------------

    def add(self, addresses: list[str]) -> None:
        """Connect any new addresses in parallel; keep existing ones.
        Open-breaker addresses are skipped (route-around); an expired
        breaker turns its address's dial into the half-open probe."""
        with self._lock:
            new = [a for a in addresses if a not in self._dests]
        new = [a for a in new if self._admit(a)]
        if not new:
            return
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(4, len(new))) as pool:
            futures = {pool.submit(self._connect, a): a for a in new}
            for fut in concurrent.futures.as_completed(futures):
                addr = futures[fut]
                try:
                    dest = fut.result()
                except Exception as e:
                    logger.warning("could not connect to %s: %s", addr, e)
                    self._record_failure(addr)
                    continue
                self._record_success(addr)
                duplicate = None
                with self._lock:
                    if addr in self._dests:
                        # a concurrent add() won the race; close the
                        # duplicate connection (destinations.go:90-94)
                        duplicate = dest
                    else:
                        self._dests[addr] = dest
                        self._ring.add(addr)
                        self._ring_cache = None
                if duplicate is not None:
                    threading.Thread(target=duplicate.close,
                                     daemon=True).start()

    def _connect(self, address: str) -> Destination:
        dest = Destination(address, self.send_buffer_size,
                           on_closed=self._connection_closed,
                           n_streams=self.n_streams,
                           send_timeout_s=self.send_timeout_s,
                           dial_timeout_s=self.dial_timeout_s,
                           stream_timeout_s=self.stream_timeout_s)
        if self.grpc_stats is not None:
            self.grpc_stats.watch_channel(dest.channel)
        return dest

    def _connection_closed(self, dest: Destination) -> None:
        # an ABRUPT close (broken stream / failed RPC) — graceful closes
        # never notify (connect.py _mark_closed).  A connection that
        # DELIVERED traffic before dying is real progress: reset the
        # consecutive-failure history first, so only genuinely
        # back-to-back failures (dials or zero-delivery lives) trip.
        if dest.sent > 0:
            with self._lock:
                b = self._breakers.get(dest.address)
                if b is not None and not b.trips:
                    del self._breakers[dest.address]
        self._record_failure(dest.address)
        self.remove(dest.address, expected=dest)

    def remove(self, address: str, expected=None, handoff=None) -> None:
        """Remove a destination; with `expected`, only if the registered
        object is that same instance (so a stale connection's close
        callback cannot tear down a re-added healthy destination).

        `handoff` (a reshard record) switches to the SYNCHRONOUS
        drain-and-forward retire: the destination's undelivered buffer
        re-routes through the new ring instead of counting as dropped,
        and the record accumulates the handoff accounting."""
        with self._lock:
            dest = self._dests.get(address)
            if dest is None or (expected is not None and dest is not expected):
                return
            del self._dests[address]
            self._ring.remove(address)
            self._ring_cache = None
            # fold the current counts into the retired totals UNDER THE
            # SAME LOCK that removes the destination, so totals() never
            # dips (monotonic for rate() scrapers); the drain may keep
            # counting for seconds, so _retire adds the post-snapshot
            # delta once close() completes
            base = (dest.sent, dest.dropped)
            self._retired_sent += base[0]
            self._retired_dropped += base[1]
        if handoff is not None:
            # synchronous: the reshard record must carry final counts at
            # commit, and set_members' caller (the discovery loop) is
            # the natural place to pay the bounded drain
            self._retire(dest, base, handoff)
        else:
            threading.Thread(target=self._retire, args=(dest, base),
                             daemon=True).start()

    def _retire(self, dest: Destination, base: tuple[int, int],
                handoff: dict | None = None) -> None:
        try:
            # a reshard drain is bounded by the handoff timeout; an
            # ordinary retire keeps the destination's own default
            dest.close(**({"drain_timeout_s": self.handoff_timeout_s}
                          if handoff is not None else {}))
        finally:
            rerouted = 0
            if handoff is not None and self.handoff is not None:
                metrics = dest.take_swept()
                if metrics:
                    handoff["handoff_inflight"] = len(metrics)
                    try:
                        self.handoff(metrics)
                        rerouted = len(metrics)
                    # already accounted: the swept metrics were counted
                    # into the retiring destination's dropped total at
                    # close, and rerouted subtracts from it only on
                    # success, so a failed handoff leaves them dropped
                    except Exception:
                        logger.exception(
                            "reshard handoff re-route failed; %d "
                            "metrics stay accounted as dropped",
                            len(metrics))
                    handoff["handoff_inflight"] = 0
                    handoff["handoff_metrics"] += rerouted
            with self._lock:
                self._retired_sent += dest.sent - base[0]
                # the close sweep counted the swept items dropped on the
                # destination; the ones the handoff re-routed MOVED, they
                # did not die (any that the NEW owner drops are counted
                # there) — keep the visible totals truthful
                self._retired_dropped += dest.dropped - base[1] - rerouted
                self._reshard_handoff_total += rerouted

    # -- elastic reshard ---------------------------------------------------

    def reshard_begin(self, want: list[str]) -> dict:
        """Open a reshard window (one at a time; every begin pairs with
        a reshard_commit, which releases it).  Returns the mutable record
        the phases fill in."""
        self._reshard_serial.acquire()
        with self._lock:
            before = sorted(self._ring.members())
            self._reshard_epoch += 1
            epoch = self._reshard_epoch
        return {
            "epoch": epoch,
            "started_unix": time.time(),
            "_t0": time.monotonic(),
            "members_before": before,
            "wanted": sorted(want),
            "members_after": None,
            "added": [],
            "removed": [],
            "keys_moved": 0,
            "sample_keys": self.reshard_sample_keys,
            "moved_frac": 0.0,
            "handoff_metrics": 0,
            "handoff_inflight": 0,
            "duration_s": None,
            "committed": False,
        }

    def reshard_commit(self, rec: dict) -> None:
        """Close a reshard window: record the achieved membership, the
        sampled key movement (bounded-movement evidence), and the
        duration; publish as the /debug/vars reshard record."""
        try:
            with self._lock:
                after = sorted(self._ring.members())
            before = rec["members_before"]
            rec["members_after"] = after
            rec["added"] = sorted(set(after) - set(before))
            rec["removed"] = sorted(set(before) - set(after))
            moved, sampled = consistent.moved_keys(
                before, after, self.reshard_sample_keys)
            rec["keys_moved"] = moved
            rec["sample_keys"] = sampled
            rec["moved_frac"] = moved / sampled if sampled else 0.0
            rec["duration_s"] = round(
                time.monotonic() - rec.pop("_t0"), 6)
            rec["committed"] = True
            with self._lock:
                self._reshard_moved_total += moved
                self._last_reshard = rec
        finally:
            self._reshard_serial.release()

    def reshard_stats(self) -> dict:
        """Cumulative reshard accounting + the last committed record
        (/debug/vars -> reshard)."""
        with self._lock:
            return {
                "epochs": self._reshard_epoch,
                "moved_total": self._reshard_moved_total,
                "handoff_total": self._reshard_handoff_total,
                "last": (dict(self._last_reshard)
                         if self._last_reshard is not None else None),
            }

    def set_members(self, addresses: list[str]) -> None:
        """Reconcile with a discovery result (proxy.go:345-387
        HandleDiscovery), grown into a TWO-PHASE RESHARD when the ring
        membership actually changes:

          phase 1 (grow)   joiners connect while the old ring still
                           serves — no window where keys have no owner;
          phase 2 (drain)  leavers retire one by one, each draining its
                           undelivered buffer through the handoff back
                           onto the NEW ring (drain-and-forward) so a
                           scale-down moves queued metrics instead of
                           dropping them.

        Consistent hashing bounds the movement to ~K/N keys for one node
        joining an N-ring; the committed record (reshard_stats) carries
        a sampled measurement of exactly that, plus the handoff counts
        and duration.  Breaker and sent/dropped-totals state of
        SURVIVING destinations is untouched.

        Breaker interplay: a LEAVING address sheds its breaker state
        only when the breaker is not engaged (a deliberate removal is
        not a failure) — an OPEN or HALF-OPEN breaker survives the
        membership flap, so a reshard that drops and re-adds a tripped
        destination can never resurrect it without a successful probe.
        Wanted-but-tripped addresses keep being offered to add() every
        poll; the breaker decides which offers become dials."""
        want = set(addresses)
        now = time.monotonic()
        with self._lock:
            have = set(self._dests)
            engaged = set()
            for addr in list(self._breakers):
                b = self._breakers[addr]
                if b.half_open or b.open_until > now:
                    # engaged breaker: state survives even if the
                    # address leaves the wanted set (the satellite fix:
                    # no probe-free resurrection through a reshard)
                    engaged.add(addr)
                    continue
                if addr not in want:
                    del self._breakers[addr]
        to_add = sorted(want - have)
        to_remove = sorted(have - want)
        if not to_remove and not (want - have - engaged):
            # no ring change on offer: every new wanted address is
            # breaker-gated (add() runs anyway — it is the half-open
            # probe once cooldowns expire).  No reshard record;
            # a probe restoring a member is breaker telemetry, not an
            # operator reshard.
            self.add(to_add)
            return
        rec = self.reshard_begin(sorted(want))
        try:
            # phase 1: joiner dials are SYNCHRONOUS under the window, so
            # the old ring serves until every joiner is connected
            # (bounded by dial_timeout_s; only the discovery loop waits)
            self.add(to_add)
            for addr in to_remove:
                # phase 2: the drain-and-forward retire is synchronous,
                # so the committed record carries final handoff counts
                # (bounded by handoff_timeout_s a leaver)
                self.remove(addr, handoff=rec)
        finally:
            self.reshard_commit(rec)

    def get(self, key: str) -> Destination:
        with self._lock:
            addr = self._ring.get(key)
            return self._dests[addr]

    def all_members(self) -> list:
        """Every live destination in a STABLE order (sorted by
        address): the mesh_fanout path sends each batch to all of them
        identically, so the iteration order must not depend on
        insertion/discovery timing."""
        with self._lock:
            return [self._dests[a] for a in sorted(self._dests)]

    def ring_arrays(self):
        """Snapshot of the ring as flat arrays for the native router
        (vn_route): (sorted uint32 ring hashes, parallel int32
        destination indices, list of Destination objects).  Returns
        None when the ring is empty.  Cached per membership (rebuilt by
        add/remove/clear) — this runs once per inbound payload on the
        routing hot path."""
        with self._lock:
            if self._ring_cache is not None:
                return self._ring_cache
            if not self._ring._ring:
                return None
            dests = list(self._dests.values())
            index = {d.address: i for i, d in enumerate(dests)}
            hashes = np.asarray([h for h, _ in self._ring._ring],
                                np.uint32)
            didx = np.asarray([index[m] for _, m in self._ring._ring],
                              np.int32)
            self._ring_cache = (hashes, didx, dests)
            return self._ring_cache

    def size(self) -> int:
        with self._lock:
            return len(self._dests)

    def clear(self) -> None:
        with self._lock:
            dests = list(self._dests.values())
            bases = []
            for d in dests:
                bases.append((d.sent, d.dropped))
                self._retired_sent += d.sent
                self._retired_dropped += d.dropped
            self._dests.clear()
            self._ring = ConsistentHash()
            self._breakers.clear()
            self._ring_cache = None
        for d, base in zip(dests, bases):
            self._retire(d, base)   # close + fold the drain delta in

    def stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {a: {"sent": d.sent, "dropped": d.dropped,
                        "queued": d._buffered}
                    for a, d in self._dests.items()}

    def totals(self) -> dict[str, int]:
        """Cumulative sent/dropped including REMOVED destinations, so a
        dead destination's losses stay visible (/debug/vars + the chaos
        matrix's no-silent-loss arithmetic)."""
        with self._lock:
            return {
                "sent": self._retired_sent
                + sum(d.sent for d in self._dests.values()),
                "dropped": self._retired_dropped
                + sum(d.dropped for d in self._dests.values()),
            }
