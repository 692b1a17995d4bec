"""Column filters for tag/label matching.

Equivalent of the reference's ``ColumnFilter`` + ``Filter`` ADT
(reference: core/src/main/scala/filodb.core/query/KeyFilter.scala) used by
the part-key index lookups and by the query planners for shard pruning.
"""

from __future__ import annotations

import dataclasses
import re


class Filter:
    def matches(self, value: str) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Equals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value == self.value


@dataclasses.dataclass(frozen=True)
class NotEquals(Filter):
    value: str

    def matches(self, value: str) -> bool:
        return value != self.value


@dataclasses.dataclass(frozen=True)
class In(Filter):
    values: frozenset

    def matches(self, value: str) -> bool:
        return value in self.values


@dataclasses.dataclass(frozen=True)
class NotIn(Filter):
    values: frozenset

    def matches(self, value: str) -> bool:
        return value not in self.values


@dataclasses.dataclass(frozen=True)
class EqualsRegex(Filter):
    pattern: str

    def matches(self, value: str) -> bool:
        return _full_match(self.pattern, value)


@dataclasses.dataclass(frozen=True)
class NotEqualsRegex(Filter):
    pattern: str

    def matches(self, value: str) -> bool:
        return not _full_match(self.pattern, value)


_regex_cache: dict[str, re.Pattern] = {}


def _full_match(pattern: str, value: str) -> bool:
    rx = _regex_cache.get(pattern)
    if rx is None:
        rx = re.compile(pattern)
        if len(_regex_cache) > 4096:
            _regex_cache.clear()
        _regex_cache[pattern] = rx
    return rx.fullmatch(value) is not None


@dataclasses.dataclass(frozen=True)
class ColumnFilter:
    """A (label, filter) pair, e.g. ColumnFilter("job", Equals("api"))."""

    column: str
    filter: Filter

    def matches(self, tags: dict) -> bool:
        return self.filter.matches(tags.get(self.column, ""))


