"""Runtime paged-cache sanitizer: ASan for the block allocator (copy of
``repro/analysis/sanitizer.py``, against the port's ``PagedKVCache``).

Refcount pairing across functions — the prefix index holding exactly one
reference per committed block, block tables and the LRU partitioning
ownership, release() retiring shared blocks instead of freeing them — is
checked at run time: in sanitize mode every engine step cross-validates
the allocator's refcounts against the *independent* ground truth (live
block tables + content index + LRU), and every allocation records the
host stack that made it, so a violation reports WHERE the blocks came
from, not just that counts disagree.

Detected bug classes (each one has a test that injects it and
asserts the report fires):

  double-free / foreign free    ``decref`` on a block with no refcount —
                                reported with the allocation site AND the
                                site of the earlier free.
  invalid incref                referencing the null block or a freed
                                block (a stale table row about to share
                                garbage).
  refcount/table mismatch       allocator refcount != (#tables holding
                                the block) + (1 if content-indexed) —
                                a stranded or lost reference.
  null-block write              a slot's resident-token position exceeds
                                its table capacity, so the next device
                                write lands in reserved block 0.
  leaked blocks at drain        allocated blocks neither LRU-cached nor
                                owned by any table once the engine is
                                empty.

Zero-cost when off: the allocator's ``observer`` is None in production
and every hook is behind one attribute check; nothing here imports until
the engine is constructed with ``sanitizer=`` or REPRO_SANITIZE=1.
"""
from __future__ import annotations

import traceback
from typing import Optional

from repro_torch.serving.paged_cache import NULL_BLOCK, PagedKVCache

# frames from these files are machinery, not the interesting caller
_INTERNAL_FRAMES = ("analysis/sanitizer.py", "serving/paged_cache.py")


def _capture_site(depth: int) -> tuple:
    frames = traceback.extract_stack()
    keep = [f for f in frames
            if not f.filename.replace("\\", "/").endswith(_INTERNAL_FRAMES)]
    return tuple(f"{f.filename}:{f.lineno} in {f.name}"
                 for f in keep[-depth:])


def _fmt_site(site: Optional[tuple]) -> str:
    if not site:
        return "<unknown>"
    return "\n    ".join(site)


class SanitizerError(RuntimeError):
    """A paged-cache invariant violation, with allocation backtraces."""


class CacheSanitizer:
    """Attachable invariant checker for one PagedKVCache.

    ``attach(cache)`` installs this object as the BlockAllocator's
    observer; the engine then calls ``check_engine_step`` after every
    step and ``check_drained`` when run_until_drained empties.  All
    checks raise :class:`SanitizerError` with every violation found and
    the recorded allocation sites.
    """

    def __init__(self, *, site_depth: int = 5):
        self.site_depth = site_depth
        self.cache: Optional[PagedKVCache] = None
        self._alloc_site: dict[int, tuple] = {}   # block -> host stack
        self._free_site: dict[int, tuple] = {}    # block -> last rc->0 stack
        self.counters = {"allocs": 0, "increfs": 0, "decrefs": 0,
                         "frees": 0, "step_checks": 0, "violations": 0}

    def attach(self, cache: PagedKVCache) -> "CacheSanitizer":
        self.cache = cache
        cache.allocator.observer = self
        return self

    # -- allocator observer hooks (see BlockAllocator) -------------------
    def on_alloc(self, blocks: list) -> None:
        site = _capture_site(self.site_depth)
        for b in blocks:
            self._alloc_site[b] = site
            self._free_site.pop(b, None)
        self.counters["allocs"] += len(blocks)

    def on_incref(self, block: int, refcount: int) -> None:
        self.counters["increfs"] += 1

    def on_decref(self, block: int, refcount: int) -> None:
        self.counters["decrefs"] += 1
        if refcount == 0:
            self.counters["frees"] += 1
            self._free_site[block] = _capture_site(self.site_depth)

    def on_invalid_free(self, block: int) -> None:
        if block == NULL_BLOCK:
            self._fail([f"free of the reserved null block {NULL_BLOCK}"])
        self._fail([
            f"double free / foreign free of block {block}\n"
            f"  allocated at:\n    {_fmt_site(self._alloc_site.get(block))}\n"
            f"  previously freed at:\n"
            f"    {_fmt_site(self._free_site.get(block))}\n"
            f"  second free at:\n"
            f"    {_fmt_site(_capture_site(self.site_depth))}"])

    def on_invalid_incref(self, block: int) -> None:
        if block == NULL_BLOCK:
            self._fail([f"incref of the reserved null block {NULL_BLOCK}"])
        self._fail([
            f"incref of unallocated block {block} (stale reference)\n"
            f"  last freed at:\n"
            f"    {_fmt_site(self._free_site.get(block))}\n"
            f"  incref at:\n    {_fmt_site(_capture_site(self.site_depth))}"])

    def _fail(self, problems: list) -> None:
        self.counters["violations"] += len(problems)
        head = f"paged-cache sanitizer: {len(problems)} invariant " \
               f"violation{'s' if len(problems) != 1 else ''}"
        raise SanitizerError("\n".join([head] + [f"- {p}" for p in problems]))

    def _where(self, block: int) -> str:
        return f" (allocated at:\n    " \
               f"{_fmt_site(self._alloc_site.get(block))})"

    # -- invariant checks -------------------------------------------------
    def check_cache(self, cache: Optional[PagedKVCache] = None) -> None:
        """Cross-validate the allocator against its independent ground
        truth: block tables, content index, and LRU.  The refcount of
        every allocated block must equal the number of tables holding it
        plus one if the content index does — any other value is a
        stranded or lost reference that will surface later as a leak or
        a shared-garbage read."""
        cache = cache if cache is not None else self.cache
        if cache is None:
            raise RuntimeError("sanitizer not attached to a cache")
        alloc = cache.allocator
        free, ref = alloc._free, alloc._ref
        problems: list = []

        if NULL_BLOCK in ref or NULL_BLOCK in free:
            problems.append(f"reserved null block {NULL_BLOCK} entered the "
                            f"allocator")
        if len(set(free)) != len(free):
            dups = sorted(b for b in set(free) if free.count(b) > 1)
            problems.append(f"free list holds duplicates: {dups}")
        both = set(free) & set(ref)
        if both:
            problems.append(f"blocks simultaneously free and allocated: "
                            f"{sorted(both)}")
        if len(free) + len(ref) != alloc.num_blocks - 1:
            problems.append(
                f"block conservation broken: {len(free)} free + "
                f"{len(ref)} allocated != {alloc.num_blocks - 1} usable")

        # ground-truth reference ownership per block
        expected: dict[int, int] = {}
        for rid, table in cache.tables.items():
            if NULL_BLOCK in table:
                problems.append(f"request {rid} table contains the null "
                                f"block")
            if len(set(table)) != len(table):
                problems.append(f"request {rid} table holds duplicate "
                                f"physical blocks: {table}")
            for b in table:
                expected[b] = expected.get(b, 0) + 1
                if b != NULL_BLOCK and b not in ref:
                    problems.append(f"request {rid} table references freed "
                                    f"block {b}{self._where(b)}")
        for b in cache._block_to_hash:
            expected[b] = expected.get(b, 0) + 1

        for b, rc in ref.items():
            exp = expected.get(b, 0)
            if rc != exp:
                holders = [rid for rid, t in cache.tables.items() if b in t]
                problems.append(
                    f"refcount mismatch on block {b}: allocator says {rc}, "
                    f"tables {holders} + "
                    f"{'the content index' if b in cache._block_to_hash else 'no index entry'}"
                    f" account for {exp}{self._where(b)}")

        for b in cache._lru:
            if b not in cache._block_to_hash:
                problems.append(f"LRU-cached block {b} is not content-"
                                f"indexed{self._where(b)}")
            if alloc.refcount(b) != 1:
                problems.append(f"LRU-cached block {b} has refcount "
                                f"{alloc.refcount(b)}, expected exactly the "
                                f"index's 1{self._where(b)}")
            holders = [rid for rid, t in cache.tables.items() if b in t]
            if holders:
                problems.append(f"LRU-cached block {b} still held by live "
                                f"requests {holders}{self._where(b)}")

        for key, b in cache._hash_to_block.items():
            if cache._block_to_hash.get(b) != key:
                problems.append(f"content index asymmetry: hash->block {b} "
                                f"but block->hash disagrees")
            if b not in ref:
                problems.append(f"content index references freed block "
                                f"{b}{self._where(b)}")
        for b, key in cache._block_to_hash.items():
            if cache._hash_to_block.get(key) != b:
                problems.append(f"content index asymmetry: block {b} -> key "
                                f"not mapping back")

        for rid in cache._committed:
            if rid not in cache.tables:
                problems.append(f"commit cursor for request {rid} survives "
                                f"its table (release() missed it)")

        if problems:
            self._fail(problems)

    def check_engine_step(self, engine) -> None:
        """Per-step engine-level checks layered over check_cache: every
        busy slot's resident position must fit its block table (one token
        past the end means the next device write scatters into reserved
        block 0 — the null-block-write class)."""
        self.check_cache(engine.cache)
        bs = engine.cache.cfg.block_size
        problems: list = []
        for slot in engine.slots:
            if not slot.busy:
                continue
            rid = slot.req.id
            table = engine.cache.tables.get(rid)
            if table is None:
                problems.append(f"slot {slot.idx} runs request {rid} which "
                                f"owns no block table")
            elif slot.pos > len(table) * bs:
                problems.append(
                    f"null-block write: slot {slot.idx} (request {rid}) is "
                    f"at position {slot.pos} but its table covers only "
                    f"{len(table) * bs} tokens ({len(table)} blocks x {bs}) "
                    f"— the next cache write lands in reserved block "
                    f"{NULL_BLOCK}")
            if rid not in engine._states:
                problems.append(f"slot {slot.idx} runs request {rid} which "
                                f"the engine no longer tracks")
        self.counters["step_checks"] += 1
        if problems:
            self._fail(problems)

    def check_drained(self, engine) -> None:
        """After run_until_drained: no request may own blocks, and every
        still-allocated block must be an LRU-cached prefix block (exactly
        the content index's single reference).  Anything else leaked —
        reported with the stack that allocated it.  The drain checks run
        BEFORE the generic cross-validation: a leaked block also shows up
        as a refcount mismatch, and "leaked at drain + allocation site"
        is the actionable report."""
        cache = engine.cache
        problems: list = []
        if cache.tables:
            problems.append(f"drained engine still owns block tables for "
                            f"requests {sorted(cache.tables)}")
        for b in sorted(cache.allocator._ref):
            if b not in cache._lru:
                problems.append(
                    f"leaked block {b} (refcount "
                    f"{cache.allocator.refcount(b)}): allocated but neither "
                    f"freed nor LRU-cached at drain{self._where(b)}")
        if problems:
            self._fail(problems)
        self.check_cache(cache)

    def report(self) -> dict:
        """JSON-able activity summary (surfaced by launch/serve.py
        --sanitize and the tests)."""
        return dict(self.counters,
                    attached=self.cache is not None,
                    tracked_blocks=len(self._alloc_site))
