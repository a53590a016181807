"""The immutable ``Filter``: one interface over every engine.

Counterpart of ``repro.api.filter``. A ``Filter`` holds its spec, its words
(the engine's int32 storage on the filter's device: ``(n_words,)`` bits,
``(storage_words,)`` counters for the counting engine, a ``(G, n_words)``
ring for the windowed engine, or the slot table of the cuckoo or quotient
engine), its engine name, its engine options and its engine state (the
windowed engine's ring head, a Python ``int``; a fingerprint engine's
cumulative count of failed inserts, a 0-d int64 tensor on the words'
device; ``None`` elsewhere). Every operation that looks like a mutation
returns a new ``Filter`` and leaves the old one as it was: the engines
clone the words before an update, as JAX's immutable arrays behave.

``remove`` runs on the engines that support it (``counting``, ``cuckoo``,
``quotient``), ``decay`` on ``counting``, ``advance`` on the ``windowed``
engine, ``resize`` on ``quotient``, and each raises the JAX package's
error elsewhere. A stateful engine (``cuckoo``, ``quotient``) takes
``valid=`` on a scalar add or remove too, since its inserts are not
idempotent; a cuckoo filter cannot be merged, a quotient filter merges and
resizes losslessly.

**Banks.** A filter may carry leading bank dims: ``bank_shape`` is
``words.shape[:words.ndim - engine.words_ndim]``, so ``(B, n_words)``
words are a bank of B same-spec filters (``make_filter_bank``). Bank ops
take per-member batches (``bank_shape + (n, 2)`` keys, optional
``valid bank_shape + (n,)``) or routed flat keys ``(n, 2)`` with
``tenants (n,)`` member ids in ``[0, B)`` (optional ``valid (n,)``); an
engine with a native bank path runs the whole bank in one launch. A
windowed bank's state is one head per member, a tuple of ints in
row-major member order (JAX: a bank-shaped head array); a cuckoo or
quotient bank's is a ``bank_shape`` int64 tensor of failure counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fingerprint as F
from repro_torch.core import hashing as H
from repro_torch.core import quotient as Q
from repro_torch.core import variants as V
from repro_torch.core.partition import check_ids
from repro_torch.core.variants import FilterSpec
from repro_torch.api import registry
from repro_torch.window.ring import ring_merge_dense


@dataclasses.dataclass(frozen=True)
class BackendOptions:
    """Kernel parameters carried by a filter. ``layout``/``tile``/``probe``/
    ``depth``/``coop``/``mix`` are validated and passed to
    ``kernels.ops``, which resolves ``"auto"`` and ``None`` through the
    autotuner (``core.tuning.tune_plan``) for the words' device;
    ``api.tuned_options`` pins a plan eagerly."""

    layout: Optional[object] = None    # kernels.sbf.Layout
    tile: Optional[int] = None
    probe: str = "auto"                # "loop" | "gather" | "auto"
    depth: Optional[int] = None        # DRAM-regime keys per thread
    coop: str = "auto"                 # "none" | "subtile" | "auto"
    mix: str = "auto"                  # "full" | "cheap" | "auto"
    generations: Optional[int] = None  # windowed engine: ring size G
    impl: Optional[str] = None         # fingerprint engines: jnp|pallas|None

    def ctx(self, device=None, bank: Optional[int] = None
            ) -> registry.SelectionContext:
        return registry.SelectionContext.current(
            device=device, generations=self.generations, bank=bank)


def _int32_bits(x) -> torch.Tensor:
    """A tensor or array of u32 values as an int32 tensor of the same bits
    (torch cannot wrap a read-only array, such as a JAX array's view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32)
        return x if x.dtype == torch.int32 else H.to_i32(H.u32(x))
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32))


def as_keys(keys, device=None, batch_shape: Tuple[int, ...] = ()
            ) -> torch.Tensor:
    """Keys as a contiguous ``batch_shape + (n, 2)`` int32 ``[hi, lo]``
    tensor on ``device`` (``None`` keeps a tensor's own device, and puts
    arrays on the CPU); ``batch_shape`` is a bank's, for per-member batches.

    Accepts ``np.uint64`` keys ``batch_shape + (n,)``, u32 arrays, and torch
    tensors of int32, uint32 or int64 u32 values."""
    if isinstance(keys, np.ndarray) and keys.dtype == np.uint64:
        keys = H.u64x2_from_u64(keys)
    keys = _int32_bits(keys)
    nd = len(batch_shape)
    if (keys.ndim != nd + 2 or keys.shape[-1] != 2
            or tuple(keys.shape[:nd]) != tuple(batch_shape)):
        raise ValueError(f"keys must be {tuple(batch_shape) + ('n', 2)} "
                         f"[hi, lo] words or {tuple(batch_shape) + ('n',)} "
                         f"np.uint64; got shape {tuple(keys.shape)}")
    if device is not None:
        keys = keys.to(device)
    return keys.contiguous()


def _members(tenants, bank: int, n: int, device) -> torch.Tensor:
    """Routed tenant ids as an (n,) int32 tensor on ``device``, each in
    ``[0, bank)`` (``ValueError`` otherwise). Ids already on the card for a
    bank on the card are checked once downstream, by the bank kernel's
    wrapper or by ``route_by_id`` on the generic path (one host sync a
    call); all other ids are checked here, host ids before the upload."""
    ids = (tenants if isinstance(tenants, torch.Tensor)
           else torch.as_tensor(np.asarray(tenants, dtype=np.int64)))
    if ids.shape != (n,):
        raise ValueError(f"tenants must be ({n},), got {tuple(ids.shape)}")
    if ids.is_cuda and torch.device(device).type == "cuda":
        if ids.dtype != torch.int32:
            ids = ids.clamp(-1, bank)   # out of range stays so in int32
    else:
        check_ids(ids, bank)
    return ids.to(device=device, dtype=torch.int32).contiguous()


def _valid(valid, shape, device) -> Optional[torch.Tensor]:
    """A validity mask as a uint8 tensor of ``shape`` on ``device``."""
    if valid is None:
        return None
    v = (valid if isinstance(valid, torch.Tensor)
         else torch.as_tensor(np.asarray(valid)))
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"valid must be {tuple(shape)}, got "
                         f"{tuple(v.shape)}")
    return (v != 0).to(device=device, dtype=torch.uint8)


def _prod(shape) -> int:
    return int(math.prod(shape))


def bank_state(state, bank_shape: Tuple[int, ...]):
    """One engine state per member of a bank: a tuple of the scalar state
    (the windowed heads), or a ``bank_shape`` tensor of a tensor state (the
    cuckoo failure counts); None stays None."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.expand(bank_shape).clone()
    return (state,) * _prod(bank_shape)


def as_words(words, device=None) -> torch.Tensor:
    """Filter words (u32 array or int32/uint32 tensor) as a contiguous int32
    tensor on ``device``, bits unchanged."""
    words = _int32_bits(words)
    if device is not None:
        words = words.to(device)
    return words.contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class Filter:
    """Immutable Bloom filter (or filter bank) bound to a registry engine.

    Build one with :func:`repro_torch.api.make_filter`,
    :func:`repro_torch.api.make_filter_bank`,
    :func:`repro_torch.api.filter_for_n_items`, or :meth:`from_state`.
    ``eq=False``: compare ``dense_words()`` to test equality."""

    spec: FilterSpec
    words: torch.Tensor
    backend: str = "torch"
    options: BackendOptions = BackendOptions()
    state: Optional[object] = None     # ring head(s), or failure counts

    @property
    def engine(self) -> registry.Backend:
        return registry.get(self.backend)

    @property
    def head(self):
        """Windowed engine: the generation that takes inserts (a tuple of
        one head per member for a bank)."""
        return self.state

    @property
    def device(self) -> torch.device:
        return self.words.device

    def replace(self, **kw) -> "Filter":
        return dataclasses.replace(self, **kw)

    # -- bank geometry -------------------------------------------------------
    @property
    def bank_shape(self) -> Tuple[int, ...]:
        """Leading bank dims of the words; ``()`` for a scalar filter."""
        nd = self.words.ndim - self.engine.words_ndim
        return tuple(int(d) for d in self.words.shape[:max(nd, 0)])

    @property
    def bank_size(self) -> int:
        """Total member count (1 for a scalar filter)."""
        return _prod(self.bank_shape)

    def _flat(self):
        """(words (B, *base), state: B heads, a (B,) tensor of failure
        counts, or None) for bank dispatch."""
        base = tuple(self.words.shape[len(self.bank_shape):])
        state = self.state
        if isinstance(state, torch.Tensor):
            state = state.reshape(self.bank_size)
        return self.words.reshape((self.bank_size,) + base), state

    def _heads(self) -> np.ndarray:
        return np.asarray(self.state, dtype=np.int64).reshape(
            self.bank_shape)

    @staticmethod
    def _index(idx):
        return idx.cpu().numpy() if isinstance(idx, torch.Tensor) else idx

    def select(self, idx) -> "Filter":
        """Index the bank axis: ``select(3)`` is member 3 as a scalar
        filter; a slice or an index tensor gives a sub-bank."""
        if not self.bank_shape:
            raise ValueError("select() needs a bank; this is a scalar filter")
        state = self.state
        if isinstance(state, torch.Tensor):
            state = state[idx]
        elif state is not None:
            heads = self._heads()[self._index(idx)]
            state = (int(heads) if heads.ndim == 0
                     else tuple(int(h) for h in heads.reshape(-1)))
        return self.replace(words=self.words[idx], state=state)

    def scatter_update(self, idx, sub: "Filter") -> "Filter":
        """Replace member(s) ``idx`` with ``sub``'s words (and heads): the
        write half of :meth:`select`; spec and backend must match. Members
        of a windowed bank may end up with different heads."""
        if not self.bank_shape:
            raise ValueError("scatter_update() needs a bank")
        if sub.spec != self.spec or sub.backend != self.backend:
            raise ValueError("scatter_update: spec/backend mismatch")
        words = self.words.clone()
        words[idx] = sub.words.to(self.device)
        state = self.state
        if isinstance(state, torch.Tensor):
            state = state.clone()
            state[idx] = sub.state.to(self.device)
        elif state is not None:
            heads = self._heads().copy()
            at = self._index(idx)
            heads[at] = np.asarray(sub.state, np.int64).reshape(
                heads[at].shape)
            state = tuple(int(h) for h in heads.reshape(-1))
        return self.replace(words=words, state=state)

    # -- bulk ops ------------------------------------------------------------
    def _check_routed(self) -> None:
        if not self.bank_shape:
            raise ValueError(
                "routed (keys, tenants) ops need a bank; build one with "
                "repro_torch.api.make_filter_bank(...)")
        if len(self.bank_shape) != 1:
            raise ValueError("routed ops address a 1-D bank axis; "
                             f"bank_shape={self.bank_shape}")

    def _repack(self, new) -> "Filter":
        """A bank op's result in the filter's bank shape; a stateful
        engine's ``(words, states)`` repack both."""
        if self.engine.stateful_ops:
            words, st = new
            return self.replace(words=words.reshape(self.words.shape),
                                state=st.reshape(self.bank_shape))
        return self.replace(words=new.reshape(self.words.shape))

    def _update(self, op: str, keys, tenants, valid) -> "Filter":
        """The routed, batched and scalar forms of add/remove."""
        eng = self.engine
        if tenants is not None:
            self._check_routed()
            keys = as_keys(keys, self.device)
            n = keys.shape[0]
            if n == 0:
                return self
            member = _members(tenants, self.bank_size, n, self.device)
            wf, st = self._flat()
            run = getattr(eng, f"{op}_bank_routed")
            return self._repack(run(
                self.spec, wf, keys, member, self.options,
                valid=_valid(valid, (n,), self.device), state=st))
        if self.bank_shape:
            keys = as_keys(keys, self.device, self.bank_shape)
            n = keys.shape[-2]
            if n == 0:
                return self
            B = self.bank_size
            vf = _valid(valid, self.bank_shape + (n,), self.device)
            wf, st = self._flat()
            run = getattr(eng, f"{op}_bank")
            return self._repack(run(
                self.spec, wf, keys.reshape(B, n, 2), self.options,
                valid=None if vf is None else vf.reshape(B, n), state=st))
        if valid is not None and not eng.stateful_ops:
            raise ValueError(f"valid= masks apply to bank ops only; filter "
                             f"the keys instead for a scalar {op}")
        keys = as_keys(keys, self.device)
        n = keys.shape[0]
        if n == 0:
            return self
        if eng.stateful_ops:
            # non-idempotent inserts take a mask even in scalar form
            new, st = getattr(eng, op)(
                self.spec, self.words, keys, self.options, state=self.state,
                valid=_valid(valid, (n,), self.device))
            return self.replace(words=new, state=st)
        if self.state is None:
            new = getattr(eng, op)(self.spec, self.words, keys, self.options)
        else:
            new = getattr(eng, op)(self.spec, self.words, keys, self.options,
                                   state=self.state)
        return self.replace(words=new)

    def add(self, keys, tenants=None, valid=None) -> "Filter":
        """Insert keys (OR the bits, or increment the counters); returns the
        updated filter (self unchanged). Scalar filter: ``keys (n, 2)``.
        Bank: per-member batches ``bank_shape + (n, 2)`` (optionally
        ``valid bank_shape + (n,)``), or routed flat ``keys (n, 2)`` with
        ``tenants (n,)`` member ids (optionally ``valid (n,)``). A cuckoo
        filter also takes ``valid (n,)`` on a scalar add, and counts the
        keys its kick chains could not place in ``insert_failures``."""
        return self._update("add", keys, tenants, valid)

    def contains(self, keys, tenants=None) -> torch.Tensor:
        """Membership on the filter's device: (n,) bool for a scalar filter
        or routed keys (each tested against its tenant's member only),
        ``bank_shape + (n,)`` for per-member batches. No false negatives;
        false positives at about ``fpr_theory``."""
        if tenants is not None:
            self._check_routed()
            keys = as_keys(keys, self.device)
            n = keys.shape[0]
            if n == 0:
                return torch.zeros((0,), dtype=torch.bool, device=self.device)
            member = _members(tenants, self.bank_size, n, self.device)
            wf, st = self._flat()
            return self.engine.contains_bank_routed(
                self.spec, wf, keys, member, self.options, state=st)
        if self.bank_shape:
            keys = as_keys(keys, self.device, self.bank_shape)
            n = keys.shape[-2]
            if n == 0:
                return torch.zeros(self.bank_shape + (0,), dtype=torch.bool,
                                   device=self.device)
            wf, st = self._flat()
            out = self.engine.contains_bank(
                self.spec, wf, keys.reshape(self.bank_size, n, 2),
                self.options, state=st)
            return out.reshape(self.bank_shape + (n,))
        keys = as_keys(keys, self.device)
        if keys.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.bool, device=self.device)
        return self.engine.contains(self.spec, self.words, keys, self.options)

    def remove(self, keys, tenants=None, valid=None) -> "Filter":
        """Delete keys (counting engine; the shapes of :meth:`add`):
        guarded decrements (a counter at 0 stays 0, one at 15 stays 15).
        Removing keys that were added leaves no false negative among the
        keys still present; removing a key that was never added can clear
        a counter it shares with one. Cuckoo: each key clears one slot
        holding its fingerprint; remove only keys that were inserted, or a
        colliding key's fingerprint may be cleared."""
        if not self.engine.supports_remove:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot remove keys; build the "
                f"filter with variant='countingbf' (engine 'counting'), "
                f"variant='cuckoo' or variant='quotient' (~1x storage)")
        return self._update("remove", keys, tenants, valid)

    def decay(self, steps: int = 1) -> "Filter":
        """Age the filter (or every bank member): ``steps`` uniform
        decrements of every nonzero counter (counting engine). Keys
        inserted once disappear after one step; keys re-inserted every step
        persist."""
        if not self.engine.supports_decay:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot decay; build the filter "
                f"with variant='countingbf' (engine 'counting')")
        out = self
        for _ in range(steps):
            if out.bank_shape:
                wf, _ = out._flat()
                new = out.engine.decay_bank(out.spec, wf, out.options)
                out = out.replace(words=new.reshape(out.words.shape))
            else:
                out = out.replace(words=out.engine.decay(
                    out.spec, out.words, out.options))
        return out

    def advance(self) -> "Filter":
        """Slide the window one generation (windowed engine only): the
        oldest generation is cleared in O(1) in keys and becomes the new
        insert target. A bank advances every member by its own head."""
        if not self.engine.supports_advance:
            raise NotImplementedError(
                f"backend {self.backend!r} cannot advance; build the filter "
                f"with generations=G (engine 'windowed')")
        if self.bank_shape:
            wf, st = self._flat()
            words, state = self.engine.advance_bank(self.spec, wf,
                                                    self.options, st)
            return self.replace(words=words.reshape(self.words.shape),
                                state=state)
        words, state = self.engine.advance(self.spec, self.words,
                                           self.options, state=self.state)
        return self.replace(words=words, state=state)

    def _check_merge_supported(self) -> None:
        """Engines whose slots hold values rather than OR-able bits (cuckoo)
        cannot union: say so before any engine dispatch."""
        if not self.engine.supports_merge:
            raise ValueError(
                f"engine {self.backend!r} does not support merge(); the "
                f"nearest deletable engine with lossless union is "
                f"'quotient' (variant='quotient') — or rebuild from the "
                f"combined key stream")

    def _merge_windowed(self, other: "Filter") -> torch.Tensor:
        """OR the other window's dense union into my head generation (each
        member's own head for a bank). Rings cannot be merged slot by slot:
        slot g is a different age class in each, and a later advance would
        retire merged keys early (a false negative inside the window)."""
        dense = other.dense_words().to(self.device)
        if not self.bank_shape:
            return ring_merge_dense(self.words, self.state, dense)
        wf, heads = self._flat()
        new = wf.clone()
        rows = torch.arange(wf.shape[0], device=wf.device)
        head = torch.tensor(heads, dtype=torch.int64, device=wf.device)
        new[rows, head] |= dense.reshape(wf.shape[0], -1)
        return new.reshape(self.words.shape)

    def merge(self, other: "Filter") -> "Filter":
        """Union. Same spec required; engines and devices may differ (the
        result lives on self's engine and device). A windowed self lands
        the other filter's dense union in its own head generation(s). Same
        engine and shape: the engine's own merge (OR for bits, a saturating
        counter add for the counting engine; member-wise for banks); else,
        for scalar filters, the OR of the dense words re-homed into self's
        engine."""
        if other.spec != self.spec:
            raise ValueError(f"cannot merge {other.spec} into {self.spec}")
        self._check_merge_supported()
        if self.engine.supports_advance:
            if other.bank_shape != self.bank_shape:
                raise ValueError(
                    "windowed merge needs matching bank shapes; got "
                    f"{other.bank_shape} vs {self.bank_shape}")
            new = self._merge_windowed(other)
        elif (other.backend == self.backend
                and other.words.shape == self.words.shape):
            new = self.engine.merge(self.spec, self.words,
                                    other.words.to(self.device), self.options)
        elif self.bank_shape or other.bank_shape:
            raise ValueError(
                "cross-engine/shape merge is not defined for banks; use "
                "bank_merge on same-backend banks, or select() members")
        else:
            dense = other.dense_words().to(self.device)
            new = self.engine.from_dense(self.spec,
                                         self.dense_words() | dense,
                                         self.options)
        return self.replace(words=new)

    __or__ = merge

    def resize(self, new_m_bits: int) -> "Filter":
        """Lossless capacity change (``supports_resize`` engines: the
        quotient filter): every stored fingerprint re-homes at the new size
        with the p = q + r split moved, no keys needed; membership is kept
        exactly. A bank resizes member by member (one new spec); a shrink
        below a member's stored count raises. The failure count carries
        over."""
        if not self.engine.supports_resize:
            raise ValueError(
                f"engine {self.backend!r} does not support resize(); the "
                f"nearest engine with lossless grow-in-place is 'quotient' "
                f"(variant='quotient') — other variants must be rebuilt "
                f"from their key stream")
        new_spec, new_words = self.engine.resize(
            self.spec, self.words, int(new_m_bits), self.options)
        return self.replace(spec=new_spec, words=new_words)

    def bank_merge(self, other: "Filter") -> "Filter":
        """Member-wise union of two same-shape banks (member i with member
        i): bit banks OR, counting banks saturating-add their counters,
        windowed banks land the other union in each member's head."""
        if not self.bank_shape:
            raise ValueError("bank_merge() needs banks; use merge()")
        if (other.spec != self.spec or other.backend != self.backend
                or other.bank_shape != self.bank_shape):
            raise ValueError(
                f"bank_merge needs matching (spec, backend, bank_shape); "
                f"got {other.spec}/{other.backend}/{other.bank_shape} vs "
                f"{self.spec}/{self.backend}/{self.bank_shape}")
        self._check_merge_supported()
        if self.engine.supports_advance:
            new = self._merge_windowed(other)
        else:
            new = self.engine.merge(self.spec, self.words,
                                    other.words.to(self.device), self.options)
        return self.replace(words=new)

    # -- introspection -------------------------------------------------------
    def dense_words(self) -> torch.Tensor:
        """Canonical int32 words (u32 bits): (n_words,) for a scalar filter,
        ``bank_shape + (n_words,)`` for a bank."""
        if not self.bank_shape:
            return self.engine.to_dense(self.spec, self.words, self.options)
        wf, _ = self._flat()
        dense = self.engine.to_dense(self.spec, wf, self.options)
        return dense.reshape(self.bank_shape + (self.spec.n_words,))

    def fill_fraction(self) -> float:
        """Fill of the canonical bit view (over the whole bank)."""
        return V.fill_fraction(self.dense_words())

    def fpr_theory(self, n: int) -> float:
        """Analytic FPR at load n (per member, for banks)."""
        return V.fpr_theory(self.spec, n)

    def measure_fpr(self, n_probe: int = 1 << 16, seed: int = 1234) -> float:
        """Empirical FPR against probes from the reserved keyspace
        (``hashing.probe_u64x2``), disjoint from every insert set; a bank
        probes every member and reports the mean."""
        probes = as_keys(H.probe_u64x2(n_probe, seed=seed), self.device)
        if self.bank_shape:
            probes = probes.expand(self.bank_shape + tuple(probes.shape))
        hits = self.contains(probes)
        return float(hits.to(torch.float64).mean().item())

    @property
    def insert_failures(self) -> torch.Tensor:
        """Fingerprint engines: the cumulative count of inserts that were
        not stored (a cuckoo kick chain ran out, a quotient table was full;
        a 0-d int64 tensor on the words' device, bank-shaped for a bank).
        Nonzero means keys were not stored: resize the filter or shed load.
        No op resets it."""
        if not self.engine.stateful_ops:
            raise NotImplementedError(
                f"backend {self.backend!r} has no insert-failure state; "
                f"only fingerprint engines (variant='cuckoo'/'quotient') "
                f"can fail an insert")
        return self.state

    def load_factor(self):
        """Fingerprint engines: occupied fraction of all slots (a float; a
        bank-shaped float32 tensor for a bank)."""
        if not self.spec.is_fingerprint:
            raise NotImplementedError(
                f"load_factor() is a fingerprint-filter metric; "
                f"{self.spec.variant!r} filters report fill_fraction()")
        lf = self._load_factors()
        return float(lf) if not self.bank_shape else lf

    def _load_factors(self) -> torch.Tensor:
        if self.spec.is_quotient:
            return Q.quotient_load_factor(self.spec, self.words)
        return F.cuckoo_load_factor(self.spec, self.words)

    def _occupied(self) -> torch.Tensor:
        if self.spec.is_quotient:
            return Q.occupied_slots(self.spec, self.words)
        return F.occupied_slots(self.spec, self.words)

    def health(self) -> dict:
        """One JSON-able operational-health dict: engine, variant, bank
        shape, bytes and ``approx_count``; Bloom-family filters add
        ``fill_fraction``, fingerprint filters ``load_factor`` (the worst
        member) and the summed ``insert_failures``, windowed filters
        ``generations`` and ``head``."""
        out = {"backend": self.backend, "variant": self.spec.variant,
               "bank_shape": list(self.bank_shape), "nbytes": self.nbytes,
               "approx_count": self.approx_count()}
        if self.spec.is_fingerprint:
            out["load_factor"] = float(self._load_factors().max())
            out["insert_failures"] = int(self.state.sum())
        else:
            out["fill_fraction"] = self.fill_fraction()
        if self.engine.supports_advance and self.state is not None:
            out["generations"] = int(self.options.generations)
            out["head"] = (list(self.state) if self.bank_shape
                           else int(self.state))
        return out

    def approx_count(self) -> float:
        """Estimated distinct keys inserted: a fingerprint filter's occupied
        slots (exact, failed inserts excluded), else the Swamidass-Baldi
        estimate over the whole bank's bits."""
        if self.spec.is_fingerprint:
            return float(self._occupied().sum())
        fill = min(self.fill_fraction(), 1.0 - 1e-12)
        m_total = self.spec.m_bits * self.bank_size
        return max(0.0, -(m_total / self.spec.k) * math.log(1.0 - fill))

    @property
    def nbytes(self) -> int:
        """Backing storage (summed over a bank's members)."""
        return int(self.words.numel()) * self.words.element_size()

    # -- checkpointing -------------------------------------------------------
    def to_state(self) -> dict:
        """Engine-independent state: dense words (occupancy bits for the
        counting engine, the ring's union for the windowed engine; the bank
        dims lead) + spec fields + engine, a bank's ``"bank_shape"``, and a
        windowed filter's ring size under ``"options"``. The head is not
        recorded: the dense form collapses the age classes, so
        :meth:`from_state` restores the union into generation 0 with head
        0."""
        state = {"words": self.dense_words(),
                 "spec": dataclasses.asdict(self.spec),
                 "backend": self.backend}
        if self.engine.stateful_ops and self.state is not None:
            # a fingerprint table is canonical and its failure count real
            # state: both round-trip exactly
            state["engine_state"] = self.state
        if self.bank_shape:
            state["bank_shape"] = list(self.bank_shape)
        if self.options.generations is not None:
            state["options"] = {"generations": self.options.generations}
        return state

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = None,
                   options: BackendOptions = BackendOptions(),
                   device=None) -> "Filter":
        """Rebuild a filter or bank from :meth:`to_state` output (or the
        JAX package's, whose engine names are registered as aliases).
        ``device=None`` is the card. A windowed state comes back windowed,
        with its ring size, unless ``backend=`` names another engine (which
        then takes the dense union). A fingerprint state's ``engine_state``
        (its failure count) comes back when it is restored into the same
        engine."""
        spec = FilterSpec(**{k: (v if isinstance(v, str) else int(v))
                             for k, v in state["spec"].items()})
        name = backend or state.get("backend", "auto")
        bank_shape = tuple(int(d) for d in state.get("bank_shape") or ())
        st_opts = state.get("options") or {}
        if (name == "windowed" and options.generations is None
                and "generations" in st_opts):
            options = dataclasses.replace(
                options, generations=int(st_opts["generations"]))
        ctx = options.ctx(device, bank=_prod(bank_shape) if bank_shape
                          else None)
        eng = registry.select(spec, name, ctx)
        words = as_words(state["words"], ctx.device)
        if tuple(words.shape) != bank_shape + (spec.n_words,):
            raise ValueError(f"state words {tuple(words.shape)} do not match "
                             f"{spec} ({spec.n_words} dense words) in bank "
                             f"{bank_shape}")
        st = eng.init_state(spec, options, ctx.device)
        if bank_shape:
            flat = words.reshape(-1, spec.n_words)
            new = eng.from_dense(spec, flat, options)
            words = new.reshape(bank_shape + tuple(new.shape[1:]))
            st = bank_state(st, bank_shape)
        else:
            words = eng.from_dense(spec, words, options)
        if (eng.stateful_ops and "engine_state" in state
                and eng.name == state.get("backend")):
            es = state["engine_state"]
            es = (es.cpu().numpy() if isinstance(es, torch.Tensor)
                  else np.asarray(es))
            st = torch.from_numpy(es.astype(np.int64).reshape(bank_shape)
                                  ).to(ctx.device)
        return cls(spec=spec, words=words, backend=eng.name, options=options,
                   state=st)

    def __repr__(self):
        bank = f", bank={self.bank_shape}" if self.bank_shape else ""
        return (f"Filter({self.spec}, backend={self.backend!r}, "
                f"words={tuple(self.words.shape)}{bank}, "
                f"device={self.device})")
