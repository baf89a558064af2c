"""Content-hashed, refcounted prefix page cache for the serving engine —
the port's own copy of ``paddle_tpu/serving/prefix_cache.py`` (host-side,
hashlib only).

Shared prompt prefixes (system prompts, few-shot headers) hash to the
same leading KV pages, so admitting a request whose prefix was already
prefilled maps those pages read-only into the new slot's page table
instead of recomputing them:

  * Chain keys — page i of a prompt is keyed by
    ``page_key(key_{i-1}, tokens[i*ps:(i+1)*ps])``, a rolling hash over
    the whole prefix, so two prompts share page i only when they agree
    on every token up to and including it. Only full pages are cached; a
    partial trailing page is always private.
  * Collision verification — each entry stores the page's token content
    and ``match()`` compares it against the probe, so a hash collision
    (injectable through the ``serve.prefix_cache`` fault point and by
    monkeypatching ``page_key``) degrades to a miss, never to wrong K/V.
  * Refcounts — an entry's refcount is the number of live slots whose
    page table maps it. The engine never writes into a page with
    refcount > 0 (copy-on-write diverges first, and the prefill's write
    floor drops writes below the match), so shared pages are immutable
    while mapped.
  * LRU-by-refcount-zero eviction — a released entry stays cached
    (refcount 0) so the next same-prefix admission still hits; when the
    engine needs a page and the free list is dry it evicts the
    least-recently-released refcount-zero entry. ``max_idle_pages``
    (``ServeConfig.prefix_pages``; 0 = bounded only by the pool) also
    trims idle entries eagerly on release.

The cache holds page ids only; the content lives in the paged KV pools
(``ops/attention.py``), whose page ids are common to every layer, so one
cache serves every layer's pool. An int8 pool's per-row scales are keyed
by the same page ids and travel with them.
"""

import hashlib

_ROOT_KEY = b"paddle-tpu/prefix-root"


def page_key(parent_key, tokens):
    """Rolling chain key for one full page: hashes the parent page's key
    plus this page's token content, so the key commits to the entire
    prefix. Module-level so tests can monkeypatch it to force
    collisions."""
    h = hashlib.sha256()
    h.update(parent_key)
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


class _Entry:
    __slots__ = ("page", "tokens", "refs", "tick")

    def __init__(self, page, tokens, refs, tick):
        self.page = page
        self.tokens = tokens
        self.refs = refs
        self.tick = tick


class PrefixCache:
    """Refcounted chain-hash index from full prompt pages to KV page ids."""

    def __init__(self, page_size, max_idle_pages=0):
        self.page_size = int(page_size)
        self.max_idle_pages = int(max_idle_pages)
        self._entries = {}     # chain key -> _Entry
        self._by_page = {}     # page id -> chain key
        self._tick = 0         # LRU clock (bumped on release-to-idle)
        self.hits = 0          # full pages served from the cache
        self.misses = 0        # full probe pages not in the cache
        self.collisions = 0    # key present but token content mismatched
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def keys_for(self, tokens):
        """[(chain_key, page_tokens)] for each FULL page of `tokens`."""
        ps = self.page_size
        out = []
        parent = _ROOT_KEY
        for i in range(len(tokens) // ps):
            content = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            parent = page_key(parent, content)
            out.append((parent, content))
        return out

    def match(self, tokens, cap):
        """Longest cached run of leading full pages of `tokens`, bounded
        so at most `cap` tokens are treated as already-prefilled (the
        engine passes total-1: the final position must still be
        prefilled to produce first-token logits). Returns
        ``(page_ids, matched_tokens)``; the last page is included even
        when only partially covered by `cap` — the engine copy-on-writes
        it before use. Takes NO references: call acquire() on the pages
        actually mapped."""
        pages, matched = [], 0
        probed = 0
        for key, content in self.keys_for(tokens):
            probed += 1
            ent = self._entries.get(key)
            if ent is None:
                break
            if ent.tokens != content:
                self.collisions += 1   # verified mismatch -> miss
                break
            if matched >= cap:
                break
            pages.append(ent.page)
            matched = min(matched + self.page_size, cap)
        self.hits += len(pages)
        self.misses += len(tokens) // self.page_size - len(pages)
        return pages, matched

    def lookup_depth(self, tokens):
        """Number of leading full pages of `tokens` present (verified) in
        the cache. Read-only: no refcounts, no LRU touch, no hit/miss
        accounting. No caller in the port yet (the reference's fleet
        router reads it); kept so this module stays the reference's
        whole, and held against it by the CPU tests."""
        depth = 0
        for key, content in self.keys_for(tokens):
            ent = self._entries.get(key)
            if ent is None or ent.tokens != content:
                break
            depth += 1
        return depth

    def acquire(self, pages):
        """Take one reference per page id in `pages` (pages just mapped
        into a slot's table by a match)."""
        for pid in pages:
            self._entries[self._by_page[int(pid)]].refs += 1

    def release(self, pages):
        """Drop one reference per page id. Entries hitting refcount zero
        stay cached (LRU-recent) unless `max_idle_pages` forces a trim.
        Returns the page ids the cache no longer owns — the engine must
        put those back on its free list. Ids the cache does not know
        (cleared meanwhile) are returned as free too."""
        freed = []
        for pid in pages:
            pid = int(pid)
            key = self._by_page.get(pid)
            if key is None:
                freed.append(pid)
                continue
            ent = self._entries[key]
            ent.refs -= 1
            if ent.refs <= 0:
                ent.refs = 0
                self._tick += 1
                ent.tick = self._tick
        if self.max_idle_pages:
            while self.evictable() > self.max_idle_pages:
                freed.extend(self.evict(1))
        return freed

    def insert(self, tokens, row_pages):
        """Register the full pages of a just-prefilled prompt, whose
        page-table row maps them to `row_pages` (index order). Ownership
        of newly-registered pages moves to the cache (refcount 1 — the
        inserting slot maps them); the engine moves those ids from the
        request's private list to its shared list. A page whose key is
        already cached under the SAME id was shared by match() — skipped.
        A key cached under a DIFFERENT id means this row holds a private
        duplicate (copy-on-write divergence or a degraded match): stop
        there so the shared run stays a contiguous row prefix. Returns
        the newly-owned page ids."""
        out = []
        for (key, content), pid in zip(self.keys_for(tokens), row_pages):
            pid = int(pid)
            ent = self._entries.get(key)
            if ent is not None:
                if ent.page == pid:
                    continue
                break
            self._tick += 1
            self._entries[key] = _Entry(pid, content, 1, self._tick)
            self._by_page[pid] = key
            out.append(pid)
        return out

    def evictable(self):
        """How many cached pages could be evicted right now (refcount 0)."""
        return sum(1 for e in self._entries.values() if e.refs == 0)

    def evict(self, n=1):
        """Evict up to `n` least-recently-released refcount-zero entries;
        returns their page ids (now engine-owned)."""
        idle = sorted((e.tick, k) for k, e in self._entries.items()
                      if e.refs == 0)
        out = []
        for _, key in idle[:n]:
            ent = self._entries.pop(key)
            del self._by_page[ent.page]
            self.evictions += 1
            out.append(ent.page)
        return out

    def pages_shared(self):
        """Cached pages currently mapped by at least one slot. No caller
        in the port yet (the reference's metrics read it); kept as
        ``lookup_depth`` is."""
        return sum(1 for e in self._entries.values() if e.refs > 0)

    def clear(self):
        """Forget everything: crash recovery rebuilds the page pools, so
        every cached page id points at zeroed K/V. The engine resets its
        free list wholesale alongside this."""
        self._entries.clear()
        self._by_page.clear()
