"""Cluster-side pieces the query engine reads: shard mapping."""
