"""Workload limits: active-series quotas applied at ingest
(:mod:`.quota`) and end-to-end query deadlines (:mod:`.deadline`)."""
