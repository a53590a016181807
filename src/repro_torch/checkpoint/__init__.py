"""Checkpoints of tensors, arrays and filters (``repro.checkpoint``'s
counterpart; the same on-disk layout)."""
