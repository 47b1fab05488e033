"""Consistent hash ring for the proxy fan-in tier.

The port's copy of `veneur_tpu.proxy.consistent`, so that a key has the
same owner whichever package's proxy routes it.  It mirrors the role of
stathat.com/c/consistent in the reference
(`proxy/destinations/destinations.go:129-142`): every metric key maps to
exactly one member even as membership changes, with 20 virtual replicas
per member (stathat's default) hashed with CRC-32/IEEE onto a sorted
ring.  The native router (`ingest.route_metric_list`) bisects the same
ring (`Destinations.ring_arrays`).
"""

from __future__ import annotations

import bisect
import zlib


def moved_keys(old_members: list[str], new_members: list[str],
               n_keys: int = 2048,
               prefix: str = "reshard-sample-") -> tuple[int, int]:
    """Deterministic ownership-movement estimate between two ring
    memberships: route `n_keys` fixed sample keys through both rings and
    count the ones whose owner changed.  Consistent hashing bounds the
    true movement at ~K/N for one node joining an N-ring; the reshard
    record reports this sample so operators can see the bound holding.
    Returns (moved, sampled); (0, 0) when either ring is empty."""
    if not old_members or not new_members or n_keys <= 0:
        return 0, 0
    old = ConsistentHash(list(old_members))
    new = ConsistentHash(list(new_members))
    moved = sum(1 for i in range(n_keys)
                if old.get(f"{prefix}{i}") != new.get(f"{prefix}{i}"))
    return moved, n_keys


class ConsistentHash:
    REPLICAS = 20

    def __init__(self, members: list[str] | None = None):
        self._ring: list[tuple[int, str]] = []
        self._hashes: list[int] = []
        self._members: set[str] = set()
        for m in members or []:
            self.add(m)

    @staticmethod
    def _hash(key: str) -> int:
        return zlib.crc32(key.encode()) & 0xFFFFFFFF

    def _rebuild(self) -> None:
        self._ring.sort()
        self._hashes = [h for h, _ in self._ring]

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self.REPLICAS):
            self._ring.append((self._hash(f"{member}{i}"), member))
        self._rebuild()

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._ring = [(h, m) for h, m in self._ring if m != member]
        self._rebuild()

    def members(self) -> set[str]:
        return set(self._members)

    def get(self, key: str) -> str:
        if not self._ring:
            raise LookupError("empty consistent hash ring")
        h = self._hash(key)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]

    def __len__(self) -> int:
        return len(self._members)
