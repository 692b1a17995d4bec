"""Chunk sink and checkpoint store."""
