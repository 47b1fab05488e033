"""Per-sink circuit breaker for the egress data plane.

The port's copy of `veneur_tpu.egress.breaker`.

The same state machine the proxy's destination set runs per address
(the JAX package's `proxy/destinations.py` `_Breaker` + its
`_admit`/`_record_*` logic),
packaged as a self-contained class so the egress lanes can reuse the
CONTRACT without dragging in the ring: `threshold` consecutive failures
trip the breaker OPEN; while open, `admit()` refuses work (the lane
spills straight to its durable spool instead of burning attempts
against a dead backend); after `reset_s` (doubling per consecutive
trip, capped at 8x) the next `admit()` becomes the HALF-OPEN probe —
one real delivery attempt.  Probe success closes the breaker; probe
failure re-opens it with a longer cooldown.

One deliberate divergence from the proxy's dial breaker: there a mere
successful dial must NOT reset the consecutive-failure count (a
half-broken peer can accept dials and kill every RPC).  An egress
success IS a delivered flush — real progress — so `record_success`
always resets the failure run.
"""

from __future__ import annotations

import threading
import time


class CircuitBreaker:
    """Failure state for one egress sink.  Thread-safe: the lane worker
    and the spool replayer both consult it."""

    # cooldown doubles per consecutive trip, capped at this multiple
    # (the proxy's BREAKER_MAX_BACKOFF_X contract)
    MAX_BACKOFF_X = 8

    def __init__(self, threshold: int = 3, reset_s: float = 5.0):
        self.threshold = max(1, int(threshold))
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self.failures = 0       # consecutive failures since last success
        self.trips = 0          # times the breaker has opened
        self.open_until = 0.0   # monotonic deadline; 0 = not open
        self.half_open = False  # a probe delivery is in flight

    def state(self, now: float | None = None) -> str:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.half_open:
                return "half_open"
            if self.open_until > now:
                return "open"
            if self.open_until:
                return "probe_due"
            return "closed"

    def admit(self) -> bool:
        """May this delivery run now?  False while open; an expired
        cooldown admits ONE delivery (the half-open probe)."""
        with self._lock:
            now = time.monotonic()
            if self.half_open:
                return False            # a probe is already in flight
            if self.open_until > now:
                return False
            if self.open_until:
                self.half_open = True   # this delivery is the probe
            return True

    def record_failure(self) -> bool:
        """One failed delivery attempt.  Returns True when this failure
        tripped (or re-tripped) the breaker open."""
        with self._lock:
            self.failures += 1
            self.half_open = False
            if self.failures >= self.threshold or self.trips:
                # past the threshold (or re-failing a half-open probe):
                # open with exponential cooldown
                self.trips += 1
                backoff = min(2 ** (self.trips - 1), self.MAX_BACKOFF_X)
                self.open_until = (time.monotonic()
                                   + self.reset_s * backoff)
                return True
            return False

    def record_success(self) -> bool:
        """One delivered flush.  Returns True when this success CLOSED
        an engaged (tripped/half-open) breaker."""
        with self._lock:
            engaged = bool(self.trips or self.half_open)
            self.failures = 0
            self.trips = 0
            self.open_until = 0.0
            self.half_open = False
            return engaged

    def retry_in_s(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return max(0.0, self.open_until - now)

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {"state": self.state(now), "failures": self.failures,
                "trips": self.trips,
                "retry_in_s": round(self.retry_in_s(now), 3)}
