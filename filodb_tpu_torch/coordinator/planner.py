"""SingleClusterPlanner: LogicalPlan -> ExecPlan with shard pruning.

Mirrors the reference's planner walk (reference: coordinator/.../queryplanner/
SingleClusterPlanner.scala:36): shard pruning via shard-key filters + spread
(:106-136), per-shard MultiSchemaPartitionsExec leaves (:338-361),
hierarchical aggregation reduce with sqrt grouping at >=16 children
(:223-258), transformers attached per logical node.  Every plan runs
in-process against one memstore.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from filodb_tpu_torch.core.filters import ColumnFilter, equals_value
from filodb_tpu_torch.core.record import stable_hash32
from filodb_tpu_torch.core.schemas import DatasetOptions
from filodb_tpu_torch.parallel.shardmap import ShardMapper
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec import (BinaryJoinExec, DistConcatExec,
                                         ExecPlan, MultiSchemaPartitionsExec,
                                         ReduceAggregateExec,
                                         ScalarBinaryOperationExec,
                                         ScalarFixedDoubleExec,
                                         SetOperatorExec,
                                         TimeScalarGeneratorExec)
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.query.transformers import (AbsentFunctionMapper,
                                                 AggregateMapReduce,
                                                 AggregatePresenter,
                                                 InstantVectorFunctionMapper,
                                                 MiscellaneousFunctionMapper,
                                                 PeriodicSamplesMapper,
                                                 ScalarFunctionMapper,
                                                 ScalarOperationMapper,
                                                 SortFunctionMapper,
                                                 VectorFunctionMapper)


# aggregations over this many shard children or more reduce in sqrt-sized
# groups first (reference: SingleClusterPlanner.scala:244-258)
HIERARCHICAL_REDUCE_AT = 16


class SingleClusterPlanner:
    def __init__(self, dataset: str, shard_mapper: ShardMapper,
                 options: Optional[DatasetOptions] = None,
                 spread_default: int = 1):
        self.dataset = dataset
        self.mapper = shard_mapper
        self.options = options or DatasetOptions()
        self.spread_default = spread_default

    # -- shard pruning (reference :106-136) ---------------------------------

    def shards_from_filters(self, filters: Sequence[ColumnFilter],
                            qctx: QueryContext) -> list[int]:
        values = {}
        for col in self.options.shard_key_columns:
            v = equals_value(filters, col)
            if col == self.options.metric_column:
                v = v if v is not None else equals_value(filters, "_metric_")
            if v is None:
                return self._all_shards()
            values[col] = v
        # a per-query spread override wins (reference: QueryActor.scala:
        # 70-85 spreadOverride)
        spread = self.spread_default if qctx.spread is None else qctx.spread
        shards = self.mapper.query_shards(self._shard_key_hash(values),
                                          spread)
        active = set(self.mapper.active_shards())
        if active:
            shards = [s for s in shards if s in active] or shards
        return sorted(set(shards))

    def _shard_key_hash(self, values: dict) -> int:
        parts = []
        for col in self.options.shard_key_columns:
            v = values.get(col, "")
            for suffix in self.options.ignore_shard_key_column_suffixes.get(
                    col, ()):
                if v.endswith(suffix):
                    v = v[: -len(suffix)]
                    break
            parts.append(v)
        return stable_hash32("\x00".join(parts).encode())

    def _all_shards(self) -> list[int]:
        return self.mapper.active_shards() or list(
            range(self.mapper.num_shards))

    # -- materialization ----------------------------------------------------

    def materialize(self, plan, qctx=None) -> ExecPlan:
        return self._walk(plan, qctx or QueryContext())

    def _walk(self, plan, qctx) -> ExecPlan:
        if isinstance(plan, lp.PeriodicSeries):
            return self._periodic(plan.raw_series, qctx, plan.start_ms,
                                  plan.step_ms, plan.end_ms,
                                  offset=plan.offset_ms or 0)
        if isinstance(plan, lp.PeriodicSeriesWithWindowing):
            return self._periodic(plan.series, qctx, plan.start_ms,
                                  plan.step_ms, plan.end_ms,
                                  window=plan.window_ms,
                                  function=plan.function,
                                  args=plan.function_args,
                                  offset=plan.offset_ms or 0)
        if isinstance(plan, lp.Aggregate):
            return self._aggregate(plan, qctx)
        if isinstance(plan, lp.BinaryJoin):
            return self._binary_join(plan, qctx)
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            inner = self._walk(plan.vector, qctx)
            scalar = self._scalar_operand(plan.scalar_arg, qctx)
            inner.add_transformer(ScalarOperationMapper(
                plan.operator.name, scalar, plan.scalar_is_lhs,
                plan.bool_mode))
            return inner
        if isinstance(plan, lp.ApplyInstantFunction):
            inner = self._walk(plan.vectors, qctx)
            args = tuple(self._scalar_operand(a, qctx)
                         if isinstance(a, lp.LogicalPlan) else a
                         for a in plan.function_args)
            inner.add_transformer(InstantVectorFunctionMapper(plan.function,
                                                              args))
            return inner
        if isinstance(plan, lp.ApplyMiscellaneousFunction):
            inner = self._walk(plan.vectors, qctx)
            inner.add_transformer(MiscellaneousFunctionMapper(
                plan.function, plan.string_args))
            return inner
        if isinstance(plan, lp.ApplySortFunction):
            inner = self._walk(plan.vectors, qctx)
            inner.add_transformer(SortFunctionMapper(plan.function))
            return inner
        if isinstance(plan, lp.ApplyAbsentFunction):
            inner = self._walk(plan.vectors, qctx)
            inner.add_transformer(AbsentFunctionMapper(
                plan.filters, plan.start_ms, plan.step_ms, plan.end_ms))
            return inner
        if isinstance(plan, lp.ScalarVaryingDoublePlan):
            inner = self._walk(plan.vectors, qctx)
            inner.add_transformer(ScalarFunctionMapper())
            return inner
        if isinstance(plan, lp.ScalarTimeBasedPlan):
            return TimeScalarGeneratorExec(plan.function, plan.start_ms,
                                           plan.step_ms, plan.end_ms,
                                           query_context=qctx)
        if isinstance(plan, lp.ScalarFixedDoublePlan):
            return ScalarFixedDoubleExec(plan.scalar, plan.start_ms,
                                         plan.step_ms, plan.end_ms,
                                         query_context=qctx)
        if isinstance(plan, lp.ScalarBinaryOperation):
            lhs = plan.lhs if isinstance(plan.lhs, (int, float)) \
                else self._walk(plan.lhs, qctx)
            rhs = plan.rhs if isinstance(plan.rhs, (int, float)) \
                else self._walk(plan.rhs, qctx)
            return ScalarBinaryOperationExec(plan.operator, lhs, rhs,
                                             plan.start_ms, plan.step_ms,
                                             plan.end_ms, query_context=qctx)
        if isinstance(plan, lp.VectorPlan):
            inner = self._walk(plan.scalars, qctx)
            inner.add_transformer(VectorFunctionMapper())
            return inner
        if isinstance(plan, lp.RawSeries):
            # bare raw selector: per-shard leaf scans with no periodic
            # mapper, concatenated (reference: SelectRawPartitionsExec
            # without transformers)
            column = plan.columns[0] if plan.columns else None
            return DistConcatExec(
                [MultiSchemaPartitionsExec(
                    self.dataset, s, plan.filters,
                    plan.range_selector.from_ms, plan.range_selector.to_ms,
                    column=column, query_context=qctx)
                 for s in self.shards_from_filters(plan.filters, qctx)],
                qctx)
        raise ValueError(f"cannot materialize {type(plan).__name__}")

    def _scalar_operand(self, plan, qctx):
        """Scalar argument: plain float for fixed scalars, an ExecPlan
        evaluated at run time otherwise (reference: FuncArgs/
        ExecPlanFuncArgs, ExecPlan.scala:287-335)."""
        if isinstance(plan, (int, float)):
            return float(plan)
        if isinstance(plan, lp.ScalarFixedDoublePlan):
            return plan.scalar
        return self._walk(plan, qctx)

    def _periodic(self, raw: lp.RawSeries, qctx, start, step, end,
                  window=None, function=None, args=(),
                  offset=0) -> ExecPlan:
        column = raw.columns[0] if raw.columns else None
        children = []
        for s in self.shards_from_filters(raw.filters, qctx):
            leaf = MultiSchemaPartitionsExec(
                self.dataset, s, raw.filters,
                raw.range_selector.from_ms, raw.range_selector.to_ms,
                column=column, query_context=qctx)
            leaf.add_transformer(PeriodicSamplesMapper(
                start, step, end, window_ms=window, function=function,
                function_args=args, offset_ms=offset))
            children.append(leaf)
        return DistConcatExec(children, qctx)

    def _aggregate(self, plan: lp.Aggregate, qctx) -> ExecPlan:
        inner = self._walk(plan.vectors, qctx)
        mapred = AggregateMapReduce(plan.operator, plan.params, plan.by,
                                    plan.without)
        if isinstance(inner, DistConcatExec):
            # push map-reduce into each shard-child; reduce above (reference
            # :223-258 removes the DistConcat and reduces directly)
            children = list(inner.children)
            for c in children:
                c.add_transformer(mapred)
            children = self._hierarchical_reduce(children, plan, qctx)
            root = ReduceAggregateExec(children, plan.operator, plan.params,
                                       qctx)
        else:
            inner.add_transformer(mapred)
            root = ReduceAggregateExec([inner], plan.operator, plan.params,
                                       qctx)
        root.add_transformer(AggregatePresenter(plan.operator, plan.params))
        return root

    def _hierarchical_reduce(self, children, plan, qctx):
        """sqrt-group intermediate reduces for wide fan-outs (reference
        SingleClusterPlanner.scala:244-258)."""
        if len(children) < HIERARCHICAL_REDUCE_AT:
            return children
        groups = max(int(math.sqrt(len(children))), 1)
        size = math.ceil(len(children) / groups)
        return [ReduceAggregateExec(children[i:i + size], plan.operator,
                                    plan.params, qctx)
                for i in range(0, len(children), size)]

    def _binary_join(self, plan: lp.BinaryJoin, qctx) -> ExecPlan:
        lhs = self._walk(plan.lhs, qctx)
        rhs = self._walk(plan.rhs, qctx)
        lhs_children = list(lhs.children) if isinstance(lhs, DistConcatExec) \
            else [lhs]
        rhs_children = list(rhs.children) if isinstance(rhs, DistConcatExec) \
            else [rhs]
        children = lhs_children + rhs_children
        if plan.operator.is_set_op:
            return SetOperatorExec(children, len(lhs_children), plan.operator,
                                   plan.on, plan.ignoring, qctx)
        return BinaryJoinExec(children, len(lhs_children), plan.operator,
                              plan.cardinality, plan.on, plan.ignoring,
                              plan.include, qctx, bool_mode=plan.bool_mode)
