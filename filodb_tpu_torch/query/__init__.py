"""Query engine: logical plans, exec plans, transformers, aggregators
(reference: query/src/main/scala/filodb/query/ + filodb.query.exec)."""
