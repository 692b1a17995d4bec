"""PromQL front-end (reference: prometheus/src/main/scala/filodb/prometheus/
parse/Parser.scala + ast/)."""

from filodb_tpu_torch.promql.parser import (parse_query, query_to_logical_plan,
                                            query_range_to_logical_plan)

__all__ = ["parse_query", "query_to_logical_plan",
           "query_range_to_logical_plan"]
