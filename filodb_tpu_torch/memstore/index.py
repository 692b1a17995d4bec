"""Part-key tag index: label -> value -> sorted numpy posting arrays.

Re-scoped inverted index with the feature set the reference gets from
Lucene (reference: core/src/main/scala/filodb.core/memstore/
PartKeyLuceneIndex.scala:70 — partIdsFromFilters, partIdsOrderedByEndTime,
startTimeFromPartIds, labelValues faceting, __startTime__/__endTime__
fields), deliberately not a Lucene port (SURVEY.md §7 "Deliberately not
ported").

Round-3 redesign for Lucene-class lookup throughput (VERDICT r2 weak #2 /
do-this #4 — the round-2 Python-set postings walked per-id dicts on every
lookup, ~150 ms cold at 1M series):

- postings are **sorted int32 numpy arrays** (append-buffered, merged
  lazily); per-value postings within one label are DISJOINT (a series
  carries one value per label), so unions are concat+sort with no
  dedup pass, and the result feeds batch gathers directly;
- each label also keeps a **dense pid -> value-code array** (the
  Lucene doc-values analog): a multi-filter lookup walks ONE base
  posting (the narrowest) and evaluates every other filter as a code
  gather + tiny value-table probe — no posting intersections at all;
- series lifetimes live in **dense numpy arrays** indexed by part id
  (ids are dense ints assigned by the shard), so the
  ``__endTime__ >= start && __startTime__ <= end`` clause is one
  vectorized mask instead of a per-id dict walk;
- regex filters match the label's *value dictionary*, never documents
  (the trick Lucene's RegexpQuery enables): one compiled regex runs
  over the newline-joined value corpus in a single C-level pass; the
  matched-value facet is memoized per (pattern, value generation) and
  the unioned posting per (pattern, label mutation counter), so
  repeated dashboard regexes skip both the matching and the sort;
- removals flip an ``alive`` bit and decrement per-value refcounts;
  postings are filtered by the alive mask at read time and fully
  compacted once removals exceed 25% of the index — amortized O(1).

Missing-label semantics follow ColumnFilter.matches (absent label reads
as ""): a filter that matches "" also selects series WITHOUT the label
(e.g. ``{a=~".*"}`` or ``{a!="x"}`` match series lacking ``a``).  Such
filters are never chosen as the base posting; as code predicates the
absent-label slot of the value table carries ``matches("")``, so the
semantics hold uniformly.
"""

from __future__ import annotations

import re
import threading
from typing import Iterable, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.filters import (ColumnFilter, Equals, EqualsRegex, In,
                                     NotEquals, NotEqualsRegex, NotIn)

_NO_END = np.iinfo(np.int64).max
_EMPTY = np.empty(0, np.int32)
_EMPTY.setflags(write=False)


class _Posting:
    """Sorted int32 id array + append buffer.  Shard-assigned part ids
    are (near-)monotone, so merging the buffer is usually a concat."""

    __slots__ = ("arr", "pending")

    def __init__(self) -> None:
        self.arr = _EMPTY
        self.pending: list[int] = []

    def add(self, pid: int) -> None:
        self.pending.append(pid)

    def __len__(self) -> int:
        return len(self.arr) + len(self.pending)

    def ids(self) -> np.ndarray:
        if self.pending:
            tail = np.asarray(self.pending, np.int32)
            if len(tail) > 1 and (np.diff(tail) <= 0).any():
                tail = np.unique(tail)
            if len(self.arr) and len(tail) and self.arr[-1] >= tail[0]:
                merged = np.union1d(self.arr, tail).astype(np.int32)
            else:
                merged = np.concatenate([self.arr, tail])
            # lookups may return this array uncopied; a mutating caller
            # must fail loudly instead of corrupting the index
            merged.setflags(write=False)
            self.arr = merged
            self.pending.clear()
        return self.arr


# constructs whose line-wise corpus behavior DIFFERS from per-value
# fullmatch: absolute anchors only succeed at the corpus's own ends
# (missing matches on interior lines) and lookarounds can observe the
# joining newlines (spurious matches the value-dictionary guard can't
# catch, because they return real values for the wrong reason)
_CORPUS_UNSAFE = ("\\A", "\\Z", "\\z", "(?=", "(?!", "(?<")


def _corpus_unsafe(pattern: str) -> bool:
    return any(tok in pattern for tok in _CORPUS_UNSAFE)


class _Label:
    """All per-label state in one object (one dict hop on the hot
    ingest path): value postings, the dense pid->value-code array,
    per-value alive refcounts, and the regex corpus.

    ``codes`` is the Lucene-doc-values analog that makes multi-filter
    lookups O(base posting): any additional filter on another label is
    ONE gather of that label's codes plus a tiny value-table probe —
    no posting intersection at all."""

    __slots__ = ("by_val", "vcount", "code_of", "codes", "vgen",
                 "gen", "_corpus", "_regex_memo", "_union_memo")

    def __init__(self) -> None:
        self.by_val: dict[str, _Posting] = {}
        self.vcount: dict[str, int] = {}
        self.code_of: dict[str, int] = {}
        self.codes = np.full(1024, -1, np.int32)   # pid -> code; -1 absent
        self.vgen = 0          # bumps when a NEW value appears
        self.gen = 0           # bumps on EVERY add (union memo key)
        self._corpus: Optional[tuple[int, str, list[str]]] = None
        self._regex_memo: dict[str, tuple[int, list[str]]] = {}
        # regex -> (gen, sorted union ids): repeated dashboard regexes
        # skip the concat+sort while the label is unchanged
        self._union_memo: dict[str, tuple[int, np.ndarray]] = {}

    def ensure(self, n: int) -> None:
        if n <= len(self.codes):
            return
        new = np.full(max(n, len(self.codes) * 2), -1, np.int32)
        new[:len(self.codes)] = self.codes
        self.codes = new

    def add(self, v: str, pid: int) -> None:
        p = self.by_val.get(v)
        if p is None:
            p = self.by_val[v] = _Posting()  # filolint: disable=bounded-cache — the index IS the data; cardinality is bounded by the series-quota subsystem
            self.code_of[v] = self.vgen  # filolint: disable=bounded-cache — index value-code table, same bound as by_val
            self.vgen += 1
        # inlined _Posting.add: this runs once per (series, label)
        p.pending.append(pid)
        self.vcount[v] = self.vcount.get(v, 0) + 1  # filolint: disable=bounded-cache — index refcounts, same bound as by_val
        self.gen += 1
        if pid >= len(self.codes):
            self.ensure(pid + 1)
        self.codes[pid] = self.code_of[v]

    def add_many(self, pairs: list[tuple[str, int]]) -> None:
        """Batched :meth:`add` (the deferred-apply path): one ensure,
        one vectorized code scatter, Counter-merged value counts."""
        from collections import Counter
        by_val = self.by_val
        code_of = self.code_of
        self.ensure(max(pid for _v, pid in pairs) + 1)
        code_list: list[int] = []
        for v, pid in pairs:
            p = by_val.get(v)
            if p is None:
                p = by_val[v] = _Posting()
                code_of[v] = self.vgen
                self.vgen += 1
            p.pending.append(pid)
            code_list.append(code_of[v])
        self.codes[np.fromiter((pid for _v, pid in pairs), np.int64,
                               len(pairs))] = \
            np.asarray(code_list, np.int32)
        vcount = self.vcount
        for v, c in Counter(v for v, _pid in pairs).items():
            vcount[v] = vcount.get(v, 0) + c
        self.gen += len(pairs)

    def matching_values(self, flt) -> list[str]:
        """Values of this label matching a regex filter, via one pass of
        the compiled pattern over the newline-joined value corpus;
        memoized per (pattern, value generation)."""
        memo = self._regex_memo.get(flt.pattern)
        if memo is not None and memo[0] == self.vgen:
            return memo[1]
        if self._corpus is None or self._corpus[0] != self.vgen:
            vals = list(self.by_val.keys())
            if any("\n" in v for v in vals):
                self._corpus = (self.vgen, "", vals)   # corpus unusable
            else:
                self._corpus = (self.vgen, "\n".join(vals), vals)
        _, joined, vals = self._corpus
        if (joined == "" and len(vals) > 1) or _corpus_unsafe(flt.pattern):
            out = [v for v in vals if flt.matches(v)]
        else:
            try:
                rx = re.compile(rf"(?m)^(?:{flt.pattern})$")
                out = rx.findall(joined) if len(vals) > 1 else \
                    [v for v in vals if flt.matches(v)]
                # fall back to per-value matching when the corpus trick
                # is unsound: patterns with a capture group (findall
                # returns group contents) and patterns that can match
                # newlines (e.g. [\s\S]*) whose matches span adjacent
                # corpus lines — detectable as results that are not
                # actual dictionary values
                if rx.groups or any(v not in self.by_val for v in out):
                    out = [v for v in vals if flt.matches(v)]
            except re.error:
                out = [v for v in vals if flt.matches(v)]
        if len(self._regex_memo) > 256:
            self._regex_memo.clear()
        self._regex_memo[flt.pattern] = (self.vgen, out)
        return out


class PartKeyIndex:
    """One index per shard; partition ids are dense ints assigned by the shard."""

    def __init__(self, auto_apply: bool = True) -> None:
        # auto_apply=False suppresses the background applier (bulk
        # loads / benches that drain explicitly via apply_pending)
        self._auto_apply = auto_apply
        self._labels: dict[str, _Label] = {}
        self._tags: dict[int, dict[str, str]] = {}
        self._partkeys: dict[int, bytes] = {}
        # dense per-pid arrays, grown by doubling
        self._start_arr = np.zeros(1024, np.int64)
        self._end_arr = np.full(1024, _NO_END, np.int64)
        self._alive = np.zeros(1024, bool)
        self._max_pid = -1
        self._removed = 0
        # ONE lock serializes writers with the lazy structures reads
        # materialize (posting pending-merges, code-array growth, memo
        # fills): reads MUTATE shared state in this design, unlike the
        # copy-on-read set postings it replaced, so the single-writer /
        # many-reader shard discipline alone is not enough
        self._lock = threading.Lock()
        # monotone mutation counter: lookup caches key on it so repeated
        # dashboard filters skip the postings walk until the index changes
        self.version = 0
        # DEFERRED label writes (reference: PartKeyLuceneIndex.scala:151
        # — documents land on a background Lucene flush thread, not the
        # ingest path): add_partkey records only the O(1) lifetime state
        # and queues the posting/value-code work; an applier thread (or
        # the next lookup) drains it under the same lock
        self._pending_adds: list[tuple[int, dict]] = []
        self._pending_cv = threading.Condition(self._lock)
        self._applier_alive = False

    def __len__(self) -> int:
        return len(self._tags)

    # -- write path ---------------------------------------------------------

    def _grow(self, pid: int) -> None:
        n = len(self._start_arr)
        if pid < n:
            return
        m = max(n * 2, pid + 1)
        for name, fill in (("_start_arr", 0), ("_end_arr", _NO_END),
                           ("_alive", False)):
            old = getattr(self, name)
            new = np.full(m, fill, old.dtype)
            new[:n] = old
            setattr(self, name, new)

    def add_partkey(self, part_id: int, partkey: bytes, tags: dict[str, str],
                    start_time: int, end_time: int = _NO_END) -> None:
        """INGEST-THREAD cost is O(1): lifetime arrays + tag/partkey maps
        are written immediately (the ingest path reads them right back);
        the per-label posting/value-code writes — the expensive part —
        are queued for the applier thread / next lookup."""
        with self._lock:
            self.version += 1
            self._grow(part_id)
            self._tags[part_id] = tags
            self._partkeys[part_id] = partkey
            self._start_arr[part_id] = start_time
            self._end_arr[part_id] = end_time
            self._alive[part_id] = True
            if part_id > self._max_pid:
                self._max_pid = part_id
            self._pending_adds.append((part_id, tags))
            n = len(self._pending_adds)
            if n > 256 and not self._applier_alive and self._auto_apply:
                # spawn lazily past a real backlog so short-lived test
                # indexes never pay a thread; exits again when idle
                self._applier_alive = True
                threading.Thread(target=self._applier_loop,
                                 name="pkindex-applier",
                                 daemon=True).start()
            if n & 1023 == 0:          # amortize the notify cost
                self._pending_cv.notify()

    def _apply_chunk_locked(self, chunk) -> None:
        labels = self._labels
        tags_map = self._tags
        per_label: dict[str, list] = {}
        for pid, tags in chunk:
            if tags_map.get(pid) is not tags:
                continue       # removed/replaced before its labels landed
            for k, v in tags.items():
                lst = per_label.get(k)
                if lst is None:
                    lst = per_label[k] = []
                lst.append((v, pid))
        for k, pairs in per_label.items():
            lab = labels.get(k)
            if lab is None:
                lab = labels[k] = _Label()
            lab.add_many(pairs)

    def _drain_pending_locked(self) -> None:
        """Apply EVERY queued label write; caller holds the lock.  Every
        posting/label read path runs this first, so lookups always see
        the full index regardless of applier progress."""
        if self._pending_adds:
            chunk = self._pending_adds
            self._pending_adds = []
            self._apply_chunk_locked(chunk)

    def apply_pending(self) -> None:
        """Drain queued label writes now (flush-executor hook; tests)."""
        with self._lock:
            self._drain_pending_locked()

    def _applier_loop(self) -> None:
        """Background writer (the Lucene flush-thread analog): drains in
        bounded chunks so a 1M-series burst never starves the ingest
        thread on the lock; exits after sustained idleness."""
        idle = 0
        while True:
            with self._pending_cv:
                if not self._pending_adds:
                    if not self._pending_cv.wait(timeout=5.0):
                        idle += 1
                        if idle >= 6:          # ~30s idle: retire
                            self._applier_alive = False
                            return
                        continue
                idle = 0
                chunk = self._pending_adds[:8192]
                del self._pending_adds[:8192]
                self._apply_chunk_locked(chunk)

    def mark_active(self, part_id: int) -> None:
        with self._lock:
            if self._end_arr[part_id] != _NO_END:
                self.version += 1
            self._end_arr[part_id] = _NO_END

    def remove(self, part_ids: Iterable[int]) -> None:
        with self._lock:
            self._remove_locked(part_ids)

    def _remove_locked(self, part_ids) -> None:
        # settle queued label writes first: a pending add for a pid we
        # are about to remove would otherwise land AFTER the removal
        # (ghost postings), and _compact rebuilding from _tags would
        # double-apply whatever is still queued
        self._drain_pending_locked()
        self.version += 1
        for pid in part_ids:
            tags = self._tags.pop(pid, None)
            if tags is None:
                continue
            self._partkeys.pop(pid, None)
            self._alive[pid] = False
            self._end_arr[pid] = _NO_END
            self._removed += 1
            for k, v in tags.items():
                lab = self._labels.get(k)
                if lab is not None and v in lab.vcount:
                    lab.vcount[v] -= 1
                    if lab.vcount[v] <= 0:
                        del lab.vcount[v]
        if self._removed * 4 > max(len(self._tags), 64):
            self._compact()

    def _compact(self) -> None:
        """Rebuild postings from live tags, dropping dead ids.  Runs once
        per ~25% turnover, so the per-remove cost stays amortized O(1)."""
        self._labels.clear()
        self._removed = 0
        for pid in sorted(self._tags):
            for k, v in self._tags[pid].items():
                lab = self._labels.get(k)
                if lab is None:
                    lab = self._labels[k] = _Label()
                lab.add(v, pid)

    # -- read path ----------------------------------------------------------

    def _live(self, ids: np.ndarray) -> np.ndarray:
        if self._removed == 0 or len(ids) == 0:
            return ids
        return ids[self._alive[ids]]

    def _all_ids(self) -> np.ndarray:
        ids = np.flatnonzero(self._alive[:self._max_pid + 1])
        return ids.astype(np.int32)

    def _value_posting(self, column: str, value: str) -> np.ndarray:
        lab = self._labels.get(column)
        if lab is None:
            return _EMPTY
        p = lab.by_val.get(value)
        return p.ids() if p is not None else _EMPTY

    def _union(self, column: str, values: Iterable[str]) -> np.ndarray:
        """Union of one label's value postings.  A series carries ONE
        value per label, so the postings are disjoint: concat + sort,
        no dedup pass."""
        parts = [self._value_posting(column, v) for v in values]
        parts = [p for p in parts if len(p)]
        if not parts:
            return _EMPTY
        if len(parts) == 1:
            return parts[0]
        return np.sort(np.concatenate(parts))

    def _base_size(self, f: ColumnFilter) -> Optional[int]:
        """Result-size estimate when this positive filter is served from
        postings; None = not usable as the base (negative filters, and
        filters matching "" — those also select series WITHOUT the
        label, which only the code predicate handles)."""
        flt = f.filter
        lab = self._labels.get(f.column)
        if isinstance(flt, Equals):
            if flt.value == "":
                return None
            if lab is None:
                return 0
            p = lab.by_val.get(flt.value)
            return len(p) if p is not None else 0
        if isinstance(flt, In):
            if "" in flt.values:
                return None
            if lab is None:
                return 0
            return sum(len(p) for v in flt.values
                       if (p := lab.by_val.get(v)) is not None)
        if isinstance(flt, EqualsRegex):
            if flt.matches(""):
                return None
            if lab is None:
                return 0
            return sum(len(lab.by_val[v]) for v in lab.matching_values(flt))
        return None

    def _base_ids(self, f: ColumnFilter) -> np.ndarray:
        flt = f.filter
        if isinstance(flt, Equals):
            return self._value_posting(f.column, flt.value)
        if isinstance(flt, In):
            return self._union(f.column, flt.values)
        lab = self._labels.get(f.column)
        if lab is None:
            return _EMPTY
        memo = lab._union_memo.get(flt.pattern)
        if memo is not None and memo[0] == lab.gen:
            return memo[1]
        out = self._union(f.column, lab.matching_values(flt))
        if out.flags.writeable:        # same fail-loudly guard as postings
            out = out.copy()
            out.setflags(write=False)
        if len(lab._union_memo) > 64:
            lab._union_memo.clear()
        lab._union_memo[flt.pattern] = (lab.gen, out)
        return out

    def _predicate(self, f: ColumnFilter, ids64: np.ndarray) -> np.ndarray:
        """Boolean mask of ``ids64`` satisfying the filter, via one
        gather of the label's code array + a value-table probe.  Codes
        are shifted by +1 so slot 0 is 'label absent', which matches
        the filter against "" (ColumnFilter.matches semantics)."""
        flt = f.filter
        lab = self._labels.get(f.column)
        if lab is None:
            # label absent everywhere: every id reads ""
            return np.full(len(ids64), flt.matches(""), bool)
        lab.ensure(self._max_pid + 1)
        sh = lab.codes.take(ids64) + 1
        table = np.zeros(lab.vgen + 1, bool)
        table[0] = flt.matches("")
        if isinstance(flt, Equals):
            c = lab.code_of.get(flt.value)
            if c is not None:
                table[c + 1] = True
        elif isinstance(flt, In):
            for v in flt.values:
                c = lab.code_of.get(v)
                if c is not None:
                    table[c + 1] = True
        elif isinstance(flt, EqualsRegex):
            for v in lab.matching_values(flt):
                table[lab.code_of[v] + 1] = True
        elif isinstance(flt, (NotEquals, NotIn, NotEqualsRegex)):
            table[1:] = True
            if isinstance(flt, NotEquals):
                bad = (flt.value,)
            elif isinstance(flt, NotIn):
                bad = flt.values
            else:     # values the PATTERN matches fail the negation;
                      # reuses the memoized positive-regex facet
                bad = lab.matching_values(EqualsRegex(flt.pattern))
            for v in bad:
                c = lab.code_of.get(v)
                if c is not None:
                    table[c + 1] = False
        else:
            # unknown filter type: per-id fallback keeps semantics
            return np.fromiter(
                (f.matches(self._tags.get(int(pid), {})) for pid in ids64),
                bool, count=len(ids64))
        return table.take(sh)

    def _candidate_ids(self, filters: Sequence[ColumnFilter]) -> np.ndarray:
        """Sorted alive ids matching all filters (no time clause):
        narrowest usable posting as the base, every other filter a
        code-gather predicate over it."""
        base = None
        base_est = None
        for f in filters:
            est = self._base_size(f)
            if est is not None and (base_est is None or est < base_est):
                base, base_est = f, est
        if base is not None:
            if base_est == 0:
                return _EMPTY
            ids = self._live(np.asarray(self._base_ids(base), np.int32))
        else:
            ids = self._all_ids()
        rest = [f for f in filters if f is not base]
        if rest and len(ids):
            ids64 = ids.astype(np.int64)
            keep = None
            for f in rest:
                m = self._predicate(f, ids64)
                keep = m if keep is None else keep & m
            if not keep.all():
                ids = ids[keep]
        return np.asarray(ids, np.int32)

    def part_ids_from_filters(self, filters: Sequence[ColumnFilter],
                              start_time: int = 0,
                              end_time: int = _NO_END,
                              limit: Optional[int] = None) -> np.ndarray:
        """Sorted part ids whose tags match all filters and whose [start,end]
        life overlaps the query range (reference: partIdsFromFilters +
        __endTime__ >= start && __startTime__ <= end clauses)."""
        with self._lock:
            self._drain_pending_locked()
            ids = self._candidate_ids(filters)
        if len(ids):
            # .take with a pre-cast int64 index is ~2x a plain fancy
            # index here; this pair of gathers bounds wide lookups
            idx64 = ids.astype(np.int64)
            mask = (self._end_arr.take(idx64) >= start_time) & \
                (self._start_arr.take(idx64) <= end_time)
            if not mask.all():
                ids = ids[mask]
        if limit is not None:
            ids = ids[:limit]
        return ids

    def start_time(self, part_id: int) -> int:
        if part_id not in self._tags:
            raise KeyError(part_id)
        return int(self._start_arr[part_id])

    def end_time(self, part_id: int) -> int:
        if part_id not in self._tags:
            raise KeyError(part_id)
        return int(self._end_arr[part_id])

    def tags(self, part_id: int) -> dict[str, str]:
        return self._tags[part_id]

    def partkey(self, part_id: int) -> bytes:
        return self._partkeys[part_id]

