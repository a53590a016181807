"""Shared test fixtures + a dependency-light ``hypothesis`` fallback.

The property tests use a tiny subset of hypothesis (``given``/``settings``
with ``integers``/``lists``/``sampled_from`` strategies). When the real
package is installed it is used verbatim; otherwise a deterministic stub is
registered in ``sys.modules`` *before* test modules import, replaying each
property over seeded pseudo-random examples. The stub does no shrinking —
it exists so the tier-1 suite runs hermetically in minimal containers.
"""
from __future__ import annotations

import random
import sys
import types
import zlib


def _install_hypothesis_stub():
    class _Strategy:
        def __init__(self, sample):
            self.sample = sample  # Random -> value

    def integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(seq):
        elems = list(seq)
        return _Strategy(lambda rng: elems[rng.randrange(len(elems))])

    def lists(elements, min_size=0, max_size=None):
        hi = min_size + 20 if max_size is None else max_size

        def sample(rng):
            n = rng.randint(min_size, hi)
            return [elements.sample(rng) for _ in range(n)]

        return _Strategy(sample)

    def given(*strategies):
        def deco(fn):
            # NB: no functools.wraps — pytest must see a zero-arg signature,
            # not the original one (strategy params would look like fixtures).
            def wrapper():
                n_examples = getattr(wrapper, "_stub_max_examples", 10)
                base = zlib.adler32(fn.__module__.encode()
                                    + fn.__qualname__.encode())
                for i in range(n_examples):
                    rng = random.Random(base + 7919 * i)
                    fn(*[s.sample(rng) for s in strategies])

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__module__ = fn.__module__
            wrapper.__doc__ = fn.__doc__
            return wrapper

        return deco

    def settings(max_examples=10, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.lists = lists
    st_mod.sampled_from = sampled_from

    hyp_mod = types.ModuleType("hypothesis")
    hyp_mod.given = given
    hyp_mod.settings = settings
    hyp_mod.strategies = st_mod
    hyp_mod.__stub__ = True

    sys.modules["hypothesis"] = hyp_mod
    sys.modules["hypothesis.strategies"] = st_mod


try:  # pragma: no cover - exercised implicitly by every property test
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where none is present")
