"""Immutable core data model: schemas, filters, records, chunks."""
