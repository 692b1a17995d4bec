"""Dataset / schema metadata.

Capability match for the reference's config-driven schema system (reference:
core/src/main/scala/filodb.core/metadata/Schemas.scala:170,258,374,
Column.scala, Dataset.scala:36 and the ``filodb.schemas`` section of
core/src/main/resources/filodb-defaults.conf:52-107):

- ``DataSchema``: column 0 is the timestamp; one column is the designated
  value column; a 16-bit schema hash distinguishes multi-schema records;
  downsampler specs and a downsample-period marker ride along.
- ``PartitionSchema``: the tag map + predefined keys shared by every dataset.
- ``Schema``: a (partition, data) pair plus optional downsample schema.
- ``Dataset``/``DatasetOptions``: a named dataset bound to one schema with
  shard-key options (metric column, shard key columns, ...).

Built-in schemas replicate the reference defaults: gauge, untyped,
prom-counter, prom-histogram, ds-gauge.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import zlib
from typing import Mapping, Optional, Sequence


class ColumnType(enum.Enum):
    TIMESTAMP = "ts"      # int64 epoch millis
    LONG = "long"
    DOUBLE = "double"
    INT = "int"
    STRING = "string"
    HISTOGRAM = "hist"
    MAP = "map"           # partition-key tag map


@dataclasses.dataclass(frozen=True)
class Column:
    id: int
    name: str
    ctype: ColumnType
    # detectDrops=true marks Prometheus counter semantics (reset correction
    # applied at query time); mirrors the reference's column param
    # `detectDrops` (filodb-defaults.conf:80) and DoubleCounterAppender.
    detect_drops: bool = False
    counter: bool = False  # hist:counter=true

    @staticmethod
    def parse(col_id: int, spec: str) -> "Column":
        parts = spec.split(":")
        name, ctype = parts[0], ColumnType(parts[1])
        params = dict(p.split("=") for p in parts[2:])
        return Column(col_id, name, ctype,
                      detect_drops=params.get("detectDrops", "false") == "true",
                      counter=params.get("counter", "false") == "true")


def _hash16(text: str) -> int:
    return zlib.crc32(text.encode()) & 0xFFFF


@dataclasses.dataclass(frozen=True)
class DataSchema:
    """Columns of one time-series sample; column 0 must be the timestamp
    (reference: Schemas.scala DataSchema validation)."""

    name: str
    columns: tuple[Column, ...]
    value_column: str
    downsamplers: tuple[str, ...] = ()
    downsample_period_marker: str = "time(0)"
    downsample_schema: Optional[str] = None

    def __post_init__(self):
        if not self.columns or self.columns[0].ctype not in (ColumnType.TIMESTAMP, ColumnType.LONG):
            raise ValueError(f"schema {self.name}: first column must be ts/long")

    @functools.cached_property
    def schema_hash(self) -> int:
        """16-bit hash over name + column defs, embedded in ingest records so
        multi-schema streams are self-describing (reference: per-schema 16-bit
        hash, Schemas.scala:170).  Cached — the serving hot path compares
        it once per partition per query."""
        sig = self.name + "|" + ",".join(f"{c.name}:{c.ctype.value}" for c in self.columns)
        return _hash16(sig)

    @property
    def value_column_id(self) -> int:
        return next(c.id for c in self.columns if c.name == self.value_column)

    def column(self, name: str) -> Column:
        return next(c for c in self.columns if c.name == name)

@dataclasses.dataclass(frozen=True)
class PartitionSchema:
    """Partition-key layout: a tag map plus predefined keys whose names are
    stored as small indexes (reference: PartitionSchema, Schemas.scala:258;
    predefined-keys in filodb-defaults.conf)."""

    predefined_keys: tuple[str, ...] = ("_ws_", "_ns_", "_metric_")

@dataclasses.dataclass(frozen=True)
class Schema:
    partition: PartitionSchema
    data: DataSchema
    downsample: Optional["Schema"] = None

    @property
    def name(self) -> str:
        return self.data.name

    @property
    def schema_hash(self) -> int:
        return self.data.schema_hash


@dataclasses.dataclass(frozen=True)
class DatasetOptions:
    """Reference: Dataset.scala:108 DatasetOptions."""

    shard_key_columns: tuple[str, ...] = ("_ws_", "_ns_", "_metric_")
    metric_column: str = "_metric_"
    ignore_shard_key_column_suffixes: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {"_metric_": ("_bucket", "_count", "_sum")})
    ignore_tags_on_partition_key_hash: tuple[str, ...] = ("le",)


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    schema: Schema
    options: DatasetOptions = dataclasses.field(default_factory=DatasetOptions)


class Schemas:
    """Registry of all known schemas, looked up by name or 16-bit hash
    (reference: Schemas object, Schemas.scala:374 fromConfig)."""

    def __init__(self, partition: PartitionSchema, schemas: Mapping[str, Schema]):
        self.part = partition
        self._by_name = dict(schemas)
        self._by_hash = {s.schema_hash: s for s in schemas.values()}
        if len(self._by_hash) != len(self._by_name):
            raise ValueError("schema hash conflict")

    def __getitem__(self, name: str) -> Schema:
        return self._by_name[name]

    def get(self, name: str) -> Optional[Schema]:
        return self._by_name.get(name)

    def by_hash(self, h: int) -> Schema:
        return self._by_hash[h]

    @property
    def all(self) -> Sequence[Schema]:
        return list(self._by_name.values())

    @staticmethod
    def from_config(config: Mapping[str, Mapping]) -> "Schemas":
        """Build from a dict mirroring the ``filodb.schemas`` HOCON section."""
        part = PartitionSchema()
        datas: dict[str, DataSchema] = {}
        for name, sc in config.items():
            cols = tuple(Column.parse(i, spec) for i, spec in enumerate(sc["columns"]))
            datas[name] = DataSchema(
                name=name, columns=cols, value_column=sc["value-column"],
                downsamplers=tuple(sc.get("downsamplers", ())),
                downsample_period_marker=sc.get("downsample-period-marker", "time(0)"),
                downsample_schema=sc.get("downsample-schema"))
        schemas: dict[str, Schema] = {}
        for name, d in datas.items():
            ds = None
            if d.downsample_schema and d.downsample_schema != name:
                dd = datas[d.downsample_schema]
                ds = Schema(part, dd)
            elif d.downsample_schema == name:
                ds = None  # self-downsampling (counter/hist): same schema
            schemas[name] = Schema(part, d, downsample=ds)
        return Schemas(part, schemas)


# Built-in schema registry replicating filodb-defaults.conf:52-107.
DEFAULT_SCHEMA_CONFIG: dict[str, dict] = {
    "gauge": {
        "columns": ["timestamp:ts", "value:double:detectDrops=false"],
        "value-column": "value",
        "downsamplers": ["tTime(0)", "dMin(1)", "dMax(1)", "dSum(1)", "dCount(1)", "dAvg(1)"],
        "downsample-period-marker": "time(0)",
        "downsample-schema": "ds-gauge",
    },
    "untyped": {
        "columns": ["timestamp:ts", "number:double"],
        "value-column": "number",
        "downsamplers": [],
    },
    "prom-counter": {
        "columns": ["timestamp:ts", "count:double:detectDrops=true"],
        "value-column": "count",
        "downsamplers": ["tTime(0)", "dLast(1)"],
        "downsample-period-marker": "counter(1)",
        "downsample-schema": "prom-counter",
    },
    "prom-histogram": {
        "columns": ["timestamp:ts", "sum:double:detectDrops=true",
                    "count:double:detectDrops=true", "h:hist:counter=true"],
        "value-column": "h",
        "downsamplers": ["tTime(0)", "dLast(1)", "dLast(2)", "hLast(3)"],
        "downsample-period-marker": "counter(2)",
        "downsample-schema": "prom-histogram",
    },
    "ds-gauge": {
        "columns": ["timestamp:ts", "min:double", "max:double", "sum:double",
                    "count:double", "avg:double"],
        "value-column": "avg",
        "downsamplers": [],
    },
    # histogram with an extra max column: queries pair the hist kernel
    # with the max plane so histogram_max_quantile can cap the top bucket
    # (reference: SelectRawPartitionsExec.histMaxColumn + the hist-max
    # test schemas; rewrites in query/dsrewrite.py)
    "prom-hist-max": {
        "columns": ["timestamp:ts", "sum:double:detectDrops=true",
                    "count:double:detectDrops=true", "max:double",
                    "h:hist:counter=true"],
        "value-column": "h",
        "downsamplers": ["tTime(0)", "dLast(1)", "dLast(2)", "dMax(3)",
                         "hLast(4)"],
        "downsample-period-marker": "counter(2)",
        "downsample-schema": "prom-hist-max",
    },
}

DEFAULT_SCHEMAS = Schemas.from_config(DEFAULT_SCHEMA_CONFIG)
