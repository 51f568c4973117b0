"""Seeded consistent-hash ring: the fleet router's placement function.

Why consistent hashing (and not round-robin or least-connections alone):
the cross-stream batcher gets its win from per-model buckets being
DENSE — frames of one model coalescing into full tiles on one device.
A router that sprays a model's connections uniformly across N workers
splits that model's arrival stream N ways and every worker's bucket
runs at 1/N fill.  Hashing the *model identity* onto a ring instead
concentrates each model's connections on a small, stable replica set of
workers, and — the property this structure exists for — a membership
change (worker spawned, drained, crashed) moves only the keys whose arc
the change touches: ~1/N of the key space, never a full reshuffle that
would cold-start every bucket in the fleet at once.

Determinism is part of the contract (the port places every key exactly
as the JAX package's ring does): the ring hashes with keyed
``blake2b`` (not Python's per-process-salted ``hash()``), so every
process that builds a ring from the same member set — the router, a
standby router, a test asserting placement — computes the SAME
placement, regardless of member insertion order.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

#: virtual nodes per member: enough that per-member arc variance stays
#: small (the "moves <= ~1/N" property test bounds the observed
#: movement at 2/N with this default), few enough that membership
#: changes stay O(vnodes log ring)
DEFAULT_VNODES = 64


class ConsistentHashRing:
    """Hash ring over string members with virtual nodes.

    Not thread-safe by itself — the router serializes membership
    changes under its own lock and ``lookup`` runs on an immutable
    snapshot (``_points`` is rebuilt, never mutated in place, so a
    racing reader sees either the old or the new list, both valid).
    """

    def __init__(self, members: Iterable[str] = (),
                 vnodes: int = DEFAULT_VNODES,
                 seed: str = "nns-fleet") -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        # blake2b 'key' keeps the ring deterministic across processes
        # AND lets two independent fleets (distinct seeds) disagree on
        # placement so a misdirected client cannot collide by accident
        self._seed = str(seed).encode("utf-8")[:64]
        self._members: Dict[str, List[int]] = {}
        #: sorted (position, member) pairs — rebuilt on change
        self._points: List[Tuple[int, str]] = []
        for m in members:
            self.add(m)

    # -- hashing -------------------------------------------------------------
    def _hash(self, data: str) -> int:
        digest = hashlib.blake2b(data.encode("utf-8"), digest_size=8,
                                 key=self._seed).digest()
        return int.from_bytes(digest, "big")

    # -- membership ----------------------------------------------------------
    @property
    def members(self) -> List[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def add(self, member: str) -> bool:
        """Add ``member``; False when already present."""
        member = str(member)
        if member in self._members:
            return False
        self._members[member] = [
            self._hash(f"{member}#{i}") for i in range(self.vnodes)]
        self._rebuild()
        return True

    def remove(self, member: str) -> bool:
        if self._members.pop(str(member), None) is None:
            return False
        self._rebuild()
        return True

    def _rebuild(self) -> None:
        points = [(pos, m) for m, positions in self._members.items()
                  for pos in positions]
        points.sort()
        self._points = points

    # -- lookup --------------------------------------------------------------
    def lookup(self, key: str) -> Optional[str]:
        """Member owning ``key`` (first point clockwise), or None on an
        empty ring."""
        points = self._points
        if not points:
            return None
        idx = bisect.bisect_right(points, (self._hash(key), ""))
        return points[idx % len(points)][1]

    def lookup_n(self, key: str, n: int) -> List[str]:
        """First ``n`` DISTINCT members clockwise from ``key`` — the
        key's replica/candidate set, in stable preference order.  Fewer
        than ``n`` members returns them all."""
        points = self._points
        if not points or n < 1:
            return []
        idx = bisect.bisect_right(points, (self._hash(key), ""))
        out: List[str] = []
        for off in range(len(points)):
            member = points[(idx + off) % len(points)][1]
            if member not in out:
                out.append(member)
                if len(out) >= n:
                    break
        return out

    def assignment(self, keys: Iterable[str]) -> Dict[str, Optional[str]]:
        """Bulk ``{key: owner}`` map (the property tests' surface)."""
        return {k: self.lookup(k) for k in keys}
