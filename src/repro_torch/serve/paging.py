"""Host-side page allocator for the paged KV cache (a stdlib-only copy of
the reference's ``serve/paging.py``; the port imports nothing of it).

The device holds one physical page pool per model — KV-cache leaves
shaped ``[..., page_count, page_size, kv_heads, head_dim]`` instead of
per-bucket ``[..., batch, max_len, ...]`` slabs (see
``docs/memory_model.md``). Everything that decides WHICH pages a slot
reads and writes is plain host bookkeeping and lives here:

* a free list plus per-page reference counts (a page is recycled the
  moment its count hits zero);
* a chained-hash **prefix cache**: when a slot finishes feeding a full
  page worth of prompt tokens, that page is published under the hash of
  the token prefix it encodes, and later requests whose prompt starts
  with the same tokens map the published page read-only into their own
  page table — skipping prefill for the shared span;
* **copy-on-write by allocation**: sharing is whole-page and capped at
  the last full prompt page, so a shared page is never written by any
  slot — the first divergent (or partial) page is simply allocated
  private and recomputed, which is the COW fork;
* per-lane **scratch pages** that absorb the writes of empty or
  self-masked schedule lanes, so the device step never needs a branch.

Pages in the pool are content-addressed only through this allocator;
the device kernels see nothing but int32 page tables. The allocator is
dependency-free and fully deterministic, so the port's tests hold its
stats and page ids equal to the reference allocator's on the same
sequences.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


def _page_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


def prefix_page_hashes(prompt: Sequence[int], page_size: int) -> List[bytes]:
    """Chained hash per FULL prompt page: hash[i] covers prompt[:(i+1)*ps]."""
    out, h = [], b"\x00"
    for i in range(len(prompt) // page_size):
        h = _page_hash(h, prompt[i * page_size:(i + 1) * page_size])
        out.append(h)
    return out


@dataclasses.dataclass
class SlotPages:
    """One slot's page-table lease, returned by :meth:`PageAllocator.admit`.

    ``pages[i]`` is the physical page holding local positions
    ``[i*page_size, (i+1)*page_size)``; the first ``shared`` entries are
    read-only prefix-cache hits, the rest are private to this slot.
    ``draft`` continues the run past ``pages``: revocable pages absorbing
    one micro-run's speculative writes, resolved at the boundary by
    :meth:`PageAllocator.resolve_draft` (committed pages splice into
    ``pages``, the rest roll back to the free list).
    """

    pages: List[int]
    shared: int                  # leading read-only (prefix-hit) pages
    prompt: Tuple[int, ...]
    published: int               # prompt pages already in the prefix cache
    shared_len: int = 0          # prefix tokens whose prefill is skipped
    draft: List[int] = dataclasses.field(default_factory=list)
    released: bool = False


class PageAllocator:
    """Free list + refcounts + prefix cache over ``page_count`` pages.

    Invariants (property-tested):
      * every page is free, scratch, or refcounted > 0 — counts conserve;
      * a page with refcount > 1 is never any slot's writable page
        (writable == private == the slot holds its only lease);
      * publishing moves a page to refcount >= 2 (slot + cache) and it
        survives the slot's release at refcount 1 until evicted.
    """

    def __init__(self, page_count: int, page_size: int):
        if page_count <= 0 or page_size <= 0:
            raise ValueError(f"bad pool geometry {page_count}x{page_size}")
        self.page_count = int(page_count)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(page_count - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._scratch: List[int] = []
        # prefix cache: chained page hash -> physical page (LRU ordered)
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        # stats
        self.peak_pages = 0
        self.prefix_hits = 0          # admissions that reused >= 1 page
        self.shared_pages_served = 0
        self.skipped_tokens = 0
        self.prompt_tokens = 0
        self.evictions = 0
        self.draft_pages_committed = 0
        self.draft_pages_rolled_back = 0

    # -- accounting ---------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.page_count - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def _take(self) -> int:
        page = self._free.pop()
        self._refs[page] = self._refs.get(page, 0) + 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return page

    def _incref(self, page: int) -> None:
        self._refs[page] += 1

    def _decref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)

    def _evictable(self) -> int:
        return sum(1 for p in self._prefix.values() if self._refs[p] == 1)

    def _evict_one(self) -> bool:
        for h, p in self._prefix.items():       # oldest first (LRU)
            if self._refs[p] == 1:
                del self._prefix[h]
                self._decref(p)
                self.evictions += 1
                return True
        return False

    # -- scratch ------------------------------------------------------------

    def scratch(self, n: int) -> List[int]:
        """First ``n`` scratch pages (pinned forever; grows on demand)."""
        while len(self._scratch) < n:
            if not self._free and not self._evict_one():
                raise RuntimeError("page pool exhausted allocating scratch")
            self._scratch.append(self._take())
        return self._scratch[:n]

    # -- admission ----------------------------------------------------------

    def probe(self, prompt: Sequence[int]) -> int:
        """Longest reusable prefix of ``prompt`` in TOKENS (page-aligned,
        capped at ``len(prompt) - 1`` so a slot always feeds at least one
        prompt token — the result-slicing/feed-lane contract)."""
        ps = self.page_size
        cap = (len(prompt) - 1) // ps
        hit = 0
        for h in prefix_page_hashes(prompt, ps)[:cap]:
            if h not in self._prefix:
                break
            hit += 1
        return hit * ps

    def spec_demand(self, k: int) -> int:
        """Worst-case transient draft pages one speculative lane holds
        mid-micro-run: the ``k`` draft/verify positions can straddle a
        page boundary, so one extra page on top of the span."""
        return -(-k // self.page_size) + 1

    def can_admit(self, prompt: Sequence[int], need: int, *,
                  reserve: int = 0, lazy: bool = False) -> bool:
        ps = self.page_size
        cap = (len(prompt) - 1) // ps
        shared: List[int] = []
        for h in prefix_page_hashes(prompt, ps)[:cap]:
            if h not in self._prefix:
                break
            shared.append(self._prefix[h])
        span = min(need, len(prompt)) if lazy else need
        n_pages = -(-span // ps)
        private = n_pages - len(shared)
        # the shared hits get pinned at admit, so they must not count
        # toward the evictable budget even when only the cache holds them
        shared_set = set(shared)
        evictable = sum(1 for p in self._prefix.values()
                        if self._refs[p] == 1 and p not in shared_set)
        return private + reserve <= len(self._free) + evictable

    def admit(self, prompt: Sequence[int], need: int, *,
              lazy: bool = False) -> Optional[SlotPages]:
        """Lease pages covering local positions ``[0, need)``.

        With ``lazy=True`` (speculative mode) only the prompt span is
        leased up front; the run grows at each dispatch through
        :meth:`draft_lease` / :meth:`resolve_draft`, so rejected drafts
        never hold pages past the micro-run boundary.

        Returns None if the pool cannot cover the private span even
        after evicting unpinned prefix pages (caller skips admission).
        """
        ps = self.page_size
        cap = (len(prompt) - 1) // ps
        hashes = prefix_page_hashes(prompt, ps)
        shared: List[int] = []
        for h in hashes[:cap]:
            if h not in self._prefix:
                break
            shared.append(self._prefix[h])
        for h, p in zip(hashes, shared):
            self._incref(p)                     # pin before any eviction
            self._prefix.move_to_end(h)         # LRU touch
        span = min(need, len(prompt)) if lazy else need
        n_pages = -(-span // ps)
        private_needed = n_pages - len(shared)  # always >= 1: sharing is
        # capped at the last FULL prompt page, and span > len(prompt) - 1
        while private_needed > len(self._free):
            if not self._evict_one():
                for p in shared:                # roll back the pins
                    self._decref(p)
                return None
        pages = list(shared) + [self._take() for _ in range(private_needed)]
        self.prompt_tokens += len(prompt)
        if shared:
            self.prefix_hits += 1
            self.shared_pages_served += len(shared)
            self.skipped_tokens += len(shared) * ps
        return SlotPages(pages=pages, shared=len(shared),
                         prompt=tuple(int(t) for t in prompt),
                         published=len(shared),
                         shared_len=len(shared) * ps)

    # -- publish / release ---------------------------------------------------

    def publish(self, lease: SlotPages, fed: int) -> int:
        """Register prompt pages fully fed so far into the prefix cache.

        ``fed`` is the number of prompt tokens whose KV the slot has
        written. A page enters the cache with its own reference (so it
        outlives the slot); pages whose content hash is already cached
        stay private. Returns the number of pages newly published.
        """
        if lease.released:
            return 0
        ps = self.page_size
        hashes = prefix_page_hashes(lease.prompt, ps)
        done = 0
        while (lease.published < len(hashes)
               and (lease.published + 1) * ps <= fed
               and lease.published < len(lease.pages)):
            i = lease.published
            h = hashes[i]
            if h not in self._prefix:
                self._prefix[h] = lease.pages[i]
                self._incref(lease.pages[i])
                done += 1
            lease.published += 1
        return done

    # -- draft leases (speculative lanes) ------------------------------------

    def draft_lease(self, lease: SlotPages, hi: int) -> bool:
        """Extend the lease's page run with revocable draft pages so that
        local positions ``[0, hi)`` are all mapped for one micro-run's
        draft + verify writes. Returns False — lease untouched — when the
        pool cannot cover the span even after LRU eviction; the caller
        must then park the slot instead of dispatching it."""
        if lease.released:
            raise ValueError("draft_lease on a released lease")
        ps = self.page_size
        grow = -(-hi // ps) - (len(lease.pages) + len(lease.draft))
        if grow <= 0:
            return True
        while grow > len(self._free):
            if not self._evict_one():
                return False
        for _ in range(grow):
            lease.draft.append(self._take())
        return True

    def resolve_draft(self, lease: SlotPages, committed_local: int) -> None:
        """Boundary resolution of a draft lease: every draft page holding
        at least one committed local position (``< committed_local``)
        splices into the committed run and follows the normal
        publish/refcount lifecycle; rejected pages roll back to the free
        list. The scheduler's ``slot.start`` bump already rewinds the
        local clock, so a later micro-run re-covers the freed span with
        fresh draft pages."""
        if lease.released or not lease.draft:
            lease.draft = []
            return
        ps = self.page_size
        keep: List[int] = []
        for j, p in enumerate(lease.draft, start=len(lease.pages)):
            if j * ps < committed_local:
                keep.append(p)
            else:
                self._decref(p)
                self.draft_pages_rolled_back += 1
        lease.pages.extend(keep)
        self.draft_pages_committed += len(keep)
        lease.draft = []

    def release(self, lease: SlotPages) -> None:
        """Drop the slot's reference on every leased page (boundary-time
        reclaim on finish/cancel/shed). Published pages survive at
        refcount >= 1 under the prefix cache; purely private pages go
        straight back to the free list. Idempotent: a finish and a
        boundary cancel/shed landing on the same lease must not
        double-decref."""
        if lease.released:
            return
        lease.released = True
        for p in lease.pages:
            self._decref(p)
        for p in lease.draft:
            self._decref(p)
        lease.pages = []
        lease.draft = []

    # -- stats ----------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        total = self.prompt_tokens or 1
        return {
            "page_size": self.page_size,
            "page_count": self.page_count,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "peak_pages": self.peak_pages,
            "scratch_pages": len(self._scratch),
            "prefix_entries": len(self._prefix),
            "prefix_hits": self.prefix_hits,
            "shared_pages_served": self.shared_pages_served,
            "skipped_prefill_tokens": self.skipped_tokens,
            "prefill_skip_rate": self.skipped_tokens / total,
            "evictions": self.evictions,
            "draft_pages_committed": self.draft_pages_committed,
            "draft_pages_rolled_back": self.draft_pages_rolled_back,
        }
