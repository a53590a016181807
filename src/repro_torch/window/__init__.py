"""``repro_torch.window`` — sliding-window membership state.

Counterpart of ``repro.window``: :class:`WindowedFilter` is a generation
ring of G same-spec Bloom sub-filters; inserts land in the head
generation, queries OR the whole ring in one kernel pass, and ``advance()``
retires the oldest generation in O(1). (Per-key forgetting is the counting
filter, ``variant="countingbf"``.)
"""
from repro_torch.window.ring import (WindowedFilter, ring_add, ring_advance,
                                     ring_contains_dispatch, ring_init)

__all__ = ["WindowedFilter", "ring_init", "ring_add", "ring_advance",
           "ring_contains_dispatch"]
