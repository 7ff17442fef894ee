"""Paged packed-KV pool: block tables, prefix caching, COW, LRU eviction.

Counterpart of ``repro/serving/kvpool.py``, ported verbatim: the same
admissions, prefix tree and counters for the same call sequence.

The fixed-slot engine ties one ``max_len`` cache stripe to each batch lane,
so concurrency is capped at ``batch_size`` and every admission re-prefills
shared system prompts from scratch.  This module is the host-side
bookkeeping for the paged alternative: the packed KV cache becomes a pool
of physical *pages* — ``(P, page_len, Hkv, ...)`` payload/scale slabs, a
page being ``page_len`` packed rows — and each request holds a block table
mapping its logical page order to slab rows.  MixFP4's wire format makes
this unusually cheap: a page is raw payload + scale bytes that move with
zero requantization, and the pinned ``KV_SCALE32`` contract makes a page's
bytes *write-order independent*, so a page prefilled by one request is
bit-for-bit the page any other request would have produced for the same
tokens — the property that makes prefix sharing exact.

What lives here is pure Python accounting: the device-side pieces — the
page-slab cache layout, the block-table scatter/gather, the paged decode
kernel — live in ``models.transformer`` / ``models.base`` / ``kernels``.

Sharing model
-------------
* **Prefix tree.**  Nodes are pages keyed by token-id chunks: a *full*
  chunk is ``page_len`` prompt tokens; the prompt's tail registers as a
  terminal *partial* chunk.  ``acquire`` walks the tree root-down matching
  full chunks exactly, then takes the longest common prefix with a child
  for the tail.  Matched full pages are mapped into the new request's
  block table directly (refcount++, zero prefill work).
* **Copy-on-write, taken eagerly.**  A partial hit copies the source
  page's bytes into a fresh page *at admission* (the engine issues the
  device copy).  Eager COW means no shared page is ever written after
  registration: full-chunk pages hold only immutable prompt rows, and
  partial-chunk pages are only ever *read* (rows ``[0, len(chunk))``,
  written before registration) by sharers.  Decode therefore needs no
  write barrier — every write lands in a page owned by exactly one
  request.
* **LRU eviction, recompute-on-miss.**  Pages whose refcount drops to
  zero but that are tree-registered park in an LRU instead of the free
  list.  When the free list runs dry, the oldest *leaf* (no tree
  children) is evicted and its node removed — a later admission with that
  prefix simply misses and re-prefills (the quantized bytes it recomputes
  are bitwise the evicted ones, by the pinned-scale contract).

``enable_prefix=False`` degenerates to a plain page allocator: no prefix
match, nothing registered, every admission prefills from position 0.  The
engine serves the MoE family so, whose capacity router couples a prompt's
rows (a suffix would compete for other expert capacity than the whole
prompt did).

Page 0 is the **trash page**: never allocated, the target of every unused
block-table entry (so a zeroed table row is valid), and the scatter sink
for inactive batch lanes.  Its bytes are junk; every read of it is masked
by per-request lengths.
"""
from __future__ import annotations

import collections
import dataclasses

__all__ = ["KVPool", "Admission"]

_ROOT = -1  # parent id of top-level prefix-tree nodes


@dataclasses.dataclass
class Admission:
    """What ``acquire`` grants: the request's block table in logical page
    order, how many leading prompt tokens are already cached (the engine
    prefills only ``tokens[shared_len:]``), and an optional eager-COW
    device copy the engine must issue before prefill."""
    pages: list[int]
    shared_len: int = 0
    cow: tuple[int, int] | None = None  # (src_page, dst_page) byte copy


class KVPool:
    """Reference-counted pool of packed KV pages with prefix caching."""

    def __init__(self, num_pages: int, page_len: int,
                 *, enable_prefix: bool = True):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the trash "
                             f"page), got {num_pages}")
        if page_len < 1:
            raise ValueError(f"page_len must be >= 1, got {page_len}")
        self.num_pages = num_pages
        self.page_len = page_len
        self.enable_prefix = enable_prefix
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> page 1 first
        self._ref = [0] * num_pages
        # prefix tree: page -> (parent, chunk); (parent, chunk) -> page
        self._parent: dict[int, int] = {}
        self._chunk: dict[int, tuple] = {}
        self._children: dict[tuple, int] = {}
        self._kids: dict[int, set] = {}
        self._lru = collections.OrderedDict()  # ref-0 tree pages, old first
        self.prefix_hits = 0        # pages served from cache
        self.prefix_hit_tokens = 0  # prompt tokens whose prefill was skipped
        self.evictions = 0
        self.cow_copies = 0
        self.alloc_failures = 0

    # -- capacity ----------------------------------------------------------
    @property
    def pages_total(self) -> int:
        return self.num_pages - 1  # page 0 reserved

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        return len(self._lru)

    @property
    def pages_active(self) -> int:
        return self.pages_total - self.pages_free - self.pages_cached

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request writes: rows 0..prompt+max_new-2 (the engine's
        highest written position)."""
        rows = prompt_len + max(max_new_tokens, 1) - 1
        return -(-rows // self.page_len)

    # -- allocation --------------------------------------------------------
    def _evict_one(self) -> int | None:
        """Evict the LRU tree page with no children; recompute-on-miss."""
        for page in self._lru:
            if not self._kids.get(page):
                break
        else:
            return None
        del self._lru[page]
        parent = self._parent.pop(page)
        chunk = self._chunk.pop(page)
        del self._children[(parent, chunk)]
        kids = self._kids.get(parent)
        if kids is not None:
            kids.discard(page)
        self._kids.pop(page, None)
        self.evictions += 1
        return page

    def _alloc(self) -> int | None:
        if self._free:
            return self._free.pop()
        return self._evict_one()

    # -- prefix matching ---------------------------------------------------
    def _match(self, tokens: tuple):
        """Walk the tree over ``tokens[:-1]`` (at least one suffix token
        always prefills, so the admission has logits to sample from).
        Returns (full_pages, shared_len, partial=(src_page, rows)|None)."""
        limit = len(tokens) - 1
        full, pos, node = [], 0, _ROOT
        while pos + self.page_len <= limit:
            page = self._children.get(
                (node, tuple(tokens[pos:pos + self.page_len])))
            if page is None:
                break
            full.append(page)
            pos += self.page_len
            node = page
        best = None
        for kid in self._kids.get(node, ()):  # longest common partial tail
            chunk = self._chunk[kid]
            r = 0
            cap = min(len(chunk), limit - pos)
            while r < cap and chunk[r] == tokens[pos + r]:
                r += 1
            if r > 0 and (best is None or r > best[1]):
                best = (kid, r)
        return full, pos, best

    # -- request lifecycle -------------------------------------------------
    def acquire(self, tokens, max_new_tokens: int) -> Admission | None:
        """Admit a request: map cached prefix pages, allocate the rest.
        Returns None (and counts an alloc failure) if the pool cannot
        cover the request even after eviction — nothing is consumed."""
        tokens = tuple(int(t) for t in tokens)
        n_total = self.pages_needed(len(tokens), max_new_tokens)
        full, shared, partial = (self._match(tokens) if self.enable_prefix
                                 else ([], 0, None))
        # Pin matched pages first so eviction during allocation below can
        # never reclaim them out from under this admission.
        for page in full:
            self._ref[page] += 1
            self._lru.pop(page, None)
        fresh = []
        while len(fresh) < n_total - len(full):
            page = self._alloc()
            if page is None:
                for p in fresh:
                    self._ref[p] = 0
                    self._free.append(p)
                for p in full:
                    self._ref[p] -= 1
                    if self._ref[p] == 0:
                        self._lru[p] = None
                self.alloc_failures += 1
                return None
            self._ref[page] = 1
            fresh.append(page)
        cow = None
        if partial is not None and fresh:
            src, rows = partial
            cow = (src, fresh[0])
            shared += rows
            self.cow_copies += 1
        if shared:
            self.prefix_hits += len(full) + (1 if cow else 0)
            self.prefix_hit_tokens += shared
        return Admission(pages=full + fresh, shared_len=shared, cow=cow)

    def insert(self, tokens, pages: list[int]) -> None:
        """Register a prefilled prompt's pages in the prefix tree (full
        chunks plus the terminal partial).  Existing nodes win: a page
        whose (parent, chunk) is already claimed stays untracked and is
        simply freed on release."""
        if not self.enable_prefix:
            return
        tokens = tuple(int(t) for t in tokens)
        node, pos, idx = _ROOT, 0, 0
        while pos < len(tokens):
            chunk = tuple(tokens[pos:pos + self.page_len])
            page = pages[idx]
            have = self._children.get((node, chunk))
            if have is not None:
                node = have
            elif page not in self._parent and self._ref[page] > 0:
                self._children[(node, chunk)] = page
                self._parent[page] = node
                self._chunk[page] = chunk
                self._kids.setdefault(node, set()).add(page)
                node = page
            else:  # page already registered under another chunk, or freed
                break
            pos += self.page_len
            idx += 1

    def release(self, pages: list[int]) -> None:
        """Drop a finished request's references.  Tree-registered pages
        park in the LRU (still servable as prefix hits); anonymous pages
        return to the free list."""
        for page in pages:
            self._ref[page] -= 1
            assert self._ref[page] >= 0, f"double release of page {page}"
            if self._ref[page] == 0:
                if page in self._parent:
                    self._lru[page] = None
                    self._lru.move_to_end(page)
                else:
                    self._free.append(page)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        return {
            "pages_total": self.pages_total,
            "page_len": self.page_len,
            "pages_free": self.pages_free,
            "pages_cached": self.pages_cached,
            "pages_active": self.pages_active,
            "occupancy": 1.0 - self.pages_free / max(self.pages_total, 1),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "alloc_failures": self.alloc_failures,
        }
