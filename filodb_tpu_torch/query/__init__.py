"""Query model pieces the device grid needs (range function ids)."""
