"""Fault-tolerant drivers (``repro.runtime``'s counterpart; the elastic
mesh moves are not ported)."""
