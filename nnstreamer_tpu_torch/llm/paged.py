"""Block-paged KV cache: memory-proportional session state with
content-hash prefix reuse — the vLLM/PagedAttention layout over the
dense pool's contract.

The PyTorch counterpart of ``nnstreamer_tpu/llm/paged.py``: the host
bookkeeping is the JAX package's, and the arena is two zero-filled torch
tensors on the pool's device (``cuda:0`` unless the caller asks for the
CPU), which the decode engine writes in place.  Zeros, not
uninitialised memory: a masked score gives p = 0, but ``0 * NaN`` in
``p @ v`` is NaN, so a page holding garbage bits would poison any lane
whose padding table entries point at it.

The dense :class:`~nnstreamer_tpu_torch.llm.pool.KVCachePool` reserves one
``max_seq`` lane per session, so a 30-token chat pins the same cache
memory as a 2048-token one.  Here the arena is ONE fixed ``(num_pages
+ 1, layers, page_size, heads, head_dim)`` K/V allocation (the last
page is scratch for padding lanes), and a session's cache is a chain
of pages named by its BLOCK TABLE — page ``j`` holds positions
``[j*page_size, (j+1)*page_size)``.  Memory now scales with what a
session actually uses: ``ceil((prompt + max_new)/page_size)`` pages,
not ``max_seq``, which is the whole ≥2×-resident-sessions headline.

**Admission is commitment-based** (the no-unbounded-memory doctrine,
page-grained): a session admits only when the arena can
cover its worst case — ``ceil((prompt_len + max_new)/page_size)``
pages minus whatever a prefix hit shares — against every live
session's outstanding commitment.  Pages then allocate LAZILY as the
stream crosses page boundaries, and the reservation guarantees the
tail-page allocation can never fail mid-stream (no vLLM-style
preemption needed: an admitted stream always runs to completion).

**Prefix caching**: full prompt pages are content-addressed by a CHAIN
hash (``h_j = H(h_{j-1} || tokens[j*ps:(j+1)*ps])``), so a hash hit
certifies the page's entire history, not just its own tokens —
position embeddings bake absolute positions into K/V, which is exactly
why only position-0-anchored chains are shareable.  Sessions sharing a
system prompt map the registered pages copy-on-write (shared pages are
FULL prompt pages and therefore never written again — the only writes
a paged stream makes land at ``pos >= prompt_len``), refcounted; a
released prefix stays registered at refcount 0 as a RECLAIMABLE page
(free for allocation, still a future hit until reclaimed LRU-first).
At least one suffix token is always left to compute, so a 100 % prefix
hit still produces the last-position logits the first emitted token is
argmaxed from.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..analysis.sanitizer import make_lock
from ..device import DeviceLike, resolve_device
from ..query.overload import AdmissionController
from .pool import Session, slot_admission_controller


def chain_hashes(prompt: np.ndarray, page_size: int) -> List[bytes]:
    """Chain hash per FULL prompt page: ``h_j`` digests pages ``0..j``'s
    tokens, so equal ``h_j`` ⇒ equal position-anchored history (the
    prefix-share safety proof).  Only full pages hash — a partial tail
    page will still be written by this session's own suffix/decode."""
    ps = int(page_size)
    out: List[bytes] = []
    prev = b""
    arr = np.asarray(prompt, np.int32)
    for j in range(int(arr.shape[0]) // ps):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(arr[j * ps:(j + 1) * ps].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


@dataclasses.dataclass
class PagedSession(Session):
    """A :class:`~nnstreamer_tpu_torch.llm.pool.Session` whose cache is a
    block table instead of a slot (``slot`` stays ``-1``)."""

    table: List[int] = dataclasses.field(default_factory=list)
    plen: int = 0                 # prompt length (positions 0..plen-1)
    prefill_pos: int = 0          # prompt positions already computed
    prompt: Optional[np.ndarray] = None   # dropped when prefill ends
    reserve: int = 0              # pages this session may still take
    n_reg: int = 0                # leading table pages we hold refs on
    hashes: List[bytes] = dataclasses.field(default_factory=list)
    shared_tokens: int = 0        # prefix-hit tokens (never re-prefilled)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.plen


class PagedKVCachePool:
    """Bounded page arena + block-table bookkeeping + prefix registry.

    Same consumer contract as the dense pool (``live`` / ``occupancy``
    / ``sessions()`` / ``admit`` / ``acquire`` / ``release`` / ``touch``
    / ``lru_key`` / ``aged_keys`` / ``cache_bytes``), so the element,
    engine and observability tier swap pools without forking; the
    paged-only surface (``grow`` / ``note_prefill`` / ``free_pages``)
    is what the decode engine's paged executables drive.  Array access
    stays single-decode-threaded and lock-free; bookkeeping rides one
    small lock like the dense pool.
    """

    def __init__(self, cfg, pages: int, page_size: int, slots: int,
                 admission: Optional[AdmissionController] = None,
                 clock=None, prefix_cache: bool = True,
                 device: DeviceLike = None) -> None:
        import time as _time

        ps = int(page_size)
        if ps < 1:
            raise ValueError(f"page_size must be >= 1 (got {page_size})")
        if cfg.max_seq % ps != 0 or ps > cfg.max_seq:
            raise ValueError(
                f"page_size={ps} must tile max_seq={cfg.max_seq} evenly "
                "(block tables map position j to page j//page_size; a "
                "ragged last page would alias positions)")
        if int(pages) < 1:
            raise ValueError(f"need >= 1 page (got {pages})")
        if int(slots) < 1:
            raise ValueError(f"need >= 1 session slot (got {slots})")
        self.cfg = cfg
        self.page_size = ps
        self.pages = int(pages)
        self.slots = int(slots)            # max resident SESSIONS
        self.table_max = cfg.max_seq // ps
        self.scratch = self.pages          # scratch PAGE id
        self.prefix_cache = bool(prefix_cache)
        self.admission = (admission if admission is not None
                          else slot_admission_controller())
        self._clock = clock if clock is not None else _time.monotonic
        shape = (self.pages + 1, cfg.layers, ps, cfg.heads, cfg.head_dim)
        self.device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._free: List[int] = list(range(self.pages))
        self._live: Dict[Any, PagedSession] = {}
        self._order = 0
        self._reserved = 0                 # sum of live sess.reserve
        self._page_refs = [0] * self.pages
        self._page_hash: List[Optional[bytes]] = [None] * self.pages
        self._reg: Dict[bytes, int] = {}   # chain hash -> page id
        #: registered pages at refcount 0 — allocatable, LRU-first
        self._reclaim: "OrderedDict[bytes, int]" = OrderedDict()
        self._lock = make_lock("llm.pool")
        # prefix accounting (the soak's hit evidence)
        self.prefix_hits = 0               # sessions admitted onto a hit
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0      # prompt tokens never prefilled
        self.pages_reclaimed = 0           # cached pages repurposed

    # -- sizing ----------------------------------------------------------
    def cache_bytes(self) -> int:
        """Device bytes of the page arena — CONSTANT for the pool's
        life (the bounded-memory evidence the soak gates on), and with
        the element's default sizing EQUAL to the dense pool's bytes at
        the same ``slots`` — the apples-to-apples residency claim."""
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def free_pages(self) -> int:
        """Pages allocatable RIGHT NOW: the free list plus reclaimable
        (refcount-0 registered) prefix pages.  Equals ``pages`` when no
        session is live and nothing leaked — the fragmentation-churn
        invariant the property test pins."""
        with self._lock:
            return len(self._free) + len(self._reclaim)

    @property
    def occupancy(self) -> float:
        """Committed fraction of the arena: allocated + pinned +
        outstanding reservations over total pages — what the watermark
        shed policy watches (the real resource is pages, not slots)."""
        with self._lock:
            usable = len(self._free) + len(self._reclaim)
            return (self.pages - usable + self._reserved) / self.pages

    def sessions(self) -> List[PagedSession]:
        with self._lock:
            return sorted(self._live.values(), key=lambda s: s.order)

    def get(self, key) -> Optional[PagedSession]:
        with self._lock:
            return self._live.get(key)

    # -- prefix matching -------------------------------------------------
    def _match(self, hashes: List[bytes], plen: int):
        """Longest registered chain usable for a ``plen``-token prompt
        (capped so >= 1 suffix token remains to compute).  Returns
        ``(n_pages, resurrect)`` — ``resurrect`` counts hit pages
        currently reclaimable (a hit pins them, shrinking the
        allocatable set).  Lock held by caller."""
        if not self.prefix_cache:
            return 0, 0
        cap = (plen - 1) // self.page_size
        n = 0
        resurrect = 0
        for h in hashes[:cap]:
            pg = self._reg.get(h)
            if pg is None:
                break
            if self._page_refs[pg] == 0:
                resurrect += 1
            n += 1
        return n, resurrect

    def _need_pages(self, plen: int, max_new: int) -> int:
        # positions written: prompt 0..plen-1 plus at most max_new - 1
        # consumed continuation tokens (the final emitted token is
        # never fed back) — ceil((plen + max_new)/ps) covers it
        total = plen + max(1, int(max_new))
        return -(-total // self.page_size)

    # -- admission -------------------------------------------------------
    def admit(self, qos: str, no_slot_retry_s: float = 0.25,
              prompt: Optional[np.ndarray] = None,
              max_new: int = 0) -> Optional[float]:
        """Page-admission decision BEFORE allocation: ``None`` admits,
        a float sheds with that retry-after hint.  Policy first (QoS
        watermarks over page commitment + drain mode), then the two
        hard boundaries: the session-count bound and the page
        commitment bound (this request's worst-case private pages, net
        of its prefix hit, against what the arena still has)."""
        plen = int(np.asarray(prompt).shape[0]) if prompt is not None \
            else 1
        with self._lock:
            usable = len(self._free) + len(self._reclaim)
            depth = self.pages - usable + self._reserved
            n_live = len(self._live)
            hashes = chain_hashes(prompt, self.page_size) \
                if prompt is not None else []
            hit, resurrect = self._match(hashes, plen)
        verdict = self.admission.admit(qos or "silver", depth, self.pages)
        if verdict is not None:
            return verdict
        need = self._need_pages(plen, max_new) - hit
        if n_live >= self.slots \
                or usable - resurrect - self._reserved < need:
            return max(float(no_slot_retry_s), 0.01)
        return None

    def acquire(self, key, qos: str = "silver",
                extra: Optional[Dict[str, Any]] = None,
                prompt: Optional[np.ndarray] = None,
                max_new: int = 0) -> PagedSession:
        """Admit ``key``: pin its prefix-hit pages (refcount++), seed
        the block table with them, and reserve the private remainder.
        Caller must have gotten ``None`` from :meth:`admit` (both run
        on the single decode thread, so the check cannot go stale)."""
        if prompt is None:
            raise ValueError("paged acquire needs the prompt "
                             "(prefix match + page reservation)")
        arr = np.asarray(prompt, np.int32)
        plen = int(arr.shape[0])
        now = self._clock()
        with self._lock:
            if key in self._live:
                raise ValueError(f"session {key!r} already live")
            if len(self._live) >= self.slots:
                raise RuntimeError("no free session slot")
            hashes = chain_hashes(arr, self.page_size)
            hit, _ = self._match(hashes, plen)
            need = self._need_pages(plen, max_new) - hit
            usable = len(self._free) + len(self._reclaim)
            if usable - self._reserved < need + sum(
                    1 for h in hashes[:hit]
                    if self._page_refs[self._reg[h]] == 0):
                raise RuntimeError("no free cache pages")
            table: List[int] = []
            for h in hashes[:hit]:
                pg = self._reg[h]
                if self._page_refs[pg] == 0:
                    self._reclaim.pop(h, None)
                self._page_refs[pg] += 1
                table.append(pg)
            self._order += 1
            sess = PagedSession(
                key=key, slot=-1, qos=qos or "silver",
                extra=dict(extra or {}), born_s=now, last_step_s=now,
                order=self._order, table=table, plen=plen,
                prefill_pos=hit * self.page_size, prompt=arr,
                reserve=need, n_reg=hit, hashes=hashes,
                shared_tokens=hit * self.page_size)
            self._reserved += need
            self._live[key] = sess
            if hit:
                self.prefix_hits += 1
                self.prefix_tokens_reused += hit * self.page_size
            else:
                self.prefix_misses += 1
            return sess

    # -- page allocation -------------------------------------------------
    def _take_page(self) -> int:
        """Pop a free page, reclaiming the LRU refcount-0 prefix page
        when the free list is dry (its registry entry drops — orphaned
        chain descendants age out the same way).  Lock held."""
        if self._free:
            return self._free.pop()
        if self._reclaim:
            h, pg = self._reclaim.popitem(last=False)
            self._reg.pop(h, None)
            self._page_hash[pg] = None
            self.pages_reclaimed += 1
            return pg
        raise RuntimeError(
            "page arena exhausted despite commitment accounting "
            "(reservation invariant breached)")

    def grow(self, sess: PagedSession, positions: int) -> None:
        """Ensure ``sess``'s table covers cache positions
        ``[0, positions)`` — the lazy tail-page allocation the decode
        step and each prefill chunk call before dispatch.  Draws on the
        session's reservation, which admission guaranteed."""
        with self._lock:
            while len(sess.table) * self.page_size < positions:
                if sess.reserve < 1:
                    raise RuntimeError(
                        f"session {sess.key!r} outgrew its page "
                        f"reservation ({len(sess.table)} pages, "
                        f"needs position {positions})")
                sess.table.append(self._take_page())
                sess.reserve -= 1
                self._reserved -= 1

    def note_prefill(self, sess: PagedSession, upto: int) -> None:
        """Record prefill progress through position ``upto`` and
        REGISTER any prompt page that just became full (content-hash →
        page, refcount 1 held by the owner) so later — or concurrent —
        sessions with the same position-0 chain hit it.  A hash already
        registered to a DIFFERENT page (two identical prompts racing
        their prefills) leaves this session's copy private."""
        sess.prefill_pos = max(sess.prefill_pos, int(upto))
        if not self.prefix_cache:
            if not sess.prefilling:
                sess.prompt = None
            return
        with self._lock:
            while sess.n_reg < len(sess.hashes) \
                    and (sess.n_reg + 1) * self.page_size \
                    <= sess.prefill_pos:
                h = sess.hashes[sess.n_reg]
                pg = sess.table[sess.n_reg]
                if h not in self._reg and self._page_hash[pg] is None:
                    self._reg[h] = pg
                    self._page_hash[pg] = h
                    self._page_refs[pg] = 1
                # else: raced duplicate (two identical prompts
                # prefilling concurrently) — our copy stays private;
                # release tells them apart by the page's hash mark
                sess.n_reg += 1
        if not sess.prefilling:
            sess.prompt = None   # slab-free: the prompt copy served

    # -- release ---------------------------------------------------------
    def release(self, key) -> Optional[PagedSession]:
        """Return ``key``'s pages: registered prefix pages decref (at 0
        they become reclaimable but STAY registered — the next session
        with this system prompt still hits), private pages go straight
        to the free list, the unspent reservation returns to the arena.
        Device memory is untouched, stale positions masked as ever."""
        with self._lock:
            sess = self._live.pop(key, None)
            if sess is None:
                return None
            for i, pg in enumerate(sess.table):
                h = self._page_hash[pg]
                if i < sess.n_reg and h is not None:
                    self._page_refs[pg] -= 1
                    if self._page_refs[pg] == 0:
                        self._reclaim[h] = pg
                        self._reclaim.move_to_end(h)
                else:
                    self._free.append(pg)
            self._reserved -= sess.reserve
            sess.reserve = 0
            sess.table = []
            sess.prompt = None
            return sess

    def reset_prefix_cache(self) -> int:
        """Drop every RECLAIMABLE registered page back to the free list
        (live sessions' pinned prefixes stay).  Returns pages freed —
        the cold-run lever benches use."""
        with self._lock:
            n = 0
            while self._reclaim:
                h, pg = self._reclaim.popitem(last=False)
                self._reg.pop(h, None)
                self._page_hash[pg] = None
                self._free.append(pg)
                n += 1
            return n

    # -- liveness --------------------------------------------------------
    def touch(self, key) -> None:
        sess = self.get(key)
        if sess is not None:
            sess.last_step_s = self._clock()

    def lru_key(self):
        with self._lock:
            if not self._live:
                return None
            return min(self._live.values(),
                       key=lambda s: s.last_step_s).key

    def aged_keys(self, max_age_s: float) -> List[Any]:
        if max_age_s <= 0:
            return []
        cutoff = self._clock() - max_age_s
        with self._lock:
            return [s.key for s in self._live.values()
                    if s.born_s < cutoff]

    # -- diagnostics -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pages": self.pages,
                "page_size": self.page_size,
                "free": len(self._free),
                "reclaimable": len(self._reclaim),
                "registered": len(self._reg),
                "reserved": self._reserved,
                "live": len(self._live),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "pages_reclaimed": self.pages_reclaimed,
            }

    def check_leaks(self) -> List[str]:
        """Invariant audit (the fragmentation test's oracle): with no
        live sessions, every page must be free or reclaimable, every
        refcount zero, and the reservation ledger empty."""
        out = []
        with self._lock:
            if self._live:
                out.append(f"{len(self._live)} sessions still live")
            usable = len(self._free) + len(self._reclaim)
            if not self._live and usable != self.pages:
                out.append(f"free_pages={usable} != pages={self.pages}")
            if not self._live and self._reserved:
                out.append(f"reserved={self._reserved} with no sessions")
            for pg, r in enumerate(self._page_refs):
                if self._live:
                    break
                if r != 0:
                    out.append(f"page {pg} refcount {r} leaked")
            for h, pg in self._reg.items():
                if self._page_hash[pg] != h:
                    out.append(f"registry/page hash mismatch on {pg}")
        return out
