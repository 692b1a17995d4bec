"""Workload limits applied at ingest."""
