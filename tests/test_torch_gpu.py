"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no card is present (the
``cuda`` fixture decides). This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Comparisons are exact (tolerance 0): words as u32 bits, results as bool.
The bank cases hold the four bank kernels against their plain versions
for B in 1/7/64, uniform and skewed member mixes, both regimes' depths and
valid-masked, ragged batches. The warp-cooperative cases hold the blocked
add and contains at every Θ (lanes a key) each spec takes, every load width
and every depth, both bank forms at B = 1/7/64, ragged batches (below a
warp, around one, not a multiple of a CTA's keys), the default path
(``sbf.card_layout``) and a filter pinned by ``api.tuned_options``, which
must run ``card_layout``'s geometry, against the plain versions. The last
cases hold the
partitioned kernels (both paths forced: a segment a CTA staged in shared
memory, and the warp-cooperative global atomics; a slot
in a foreign segment; the rule's path) and the
cuckoo kernels (u8/u16 slots, 2 to 16 slots a bucket, multi-tile,
masked, duplicate and over-full batches; the update at windows 1, 2, 32
and the default, adversarial batches, and its counters against the CPU
model of its schedule) against theirs, and the quotient
kernels (u8/u16/u32 lanes over several remainder widths, loads 0.5, 0.9
and past capacity, duplicates, valid masks, removes of absent keys,
clusters that wrap past the last slot, tiles 256 / 2048 / the whole batch,
empty and full tables, a 2^25-slot table whose scans take many blocks,
and the quotient ``Filter`` path with merge and resize) against theirs.
The ring contains is held against its plain version on both paths
forced (one-pass at every Θ; binned over several internal batches and bin
sizes) at G = 1 ... 9, and
on the rule's path. The classical filter's add and contains are held
against their plain
versions on both paths (one-pass and binned) at m = 2^16 ... 2^32 for k =
1 ... 32, over several internal batches, in small bins, with keys in one
bin and one key repeated. The partitioned counting update is held against
its plain version on each path forced (grouped, global) at n_segments 1
... 256, with a row of 80 increments and invalid slots. The calibration
kernels (step, chain, gather) are held against their plain versions, and a
calibration measured on the card must have five finite, positive
constants. The binned counting update at most ``COLUMN_SCAN_BINS`` bins
(the count kernel's last CTA does the column and the scan) is held
against the plain version on two streams, and the profiler must see no
column or scan kernel launched. The filter
service on a card bank (sbf in both regimes, counting, windowed, cuckoo,
quotient) is held flush for flush against the same stream on the CPU;
``member_fill`` on the card against numpy; the recovery drill on the card
against an uninterrupted run.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.filter import as_keys
from repro_torch.core import hashing as H
from repro_torch.core import variants as V
from repro_torch.kernels import cbf
from repro_torch.kernels import countingbf as cnt
from repro_torch.kernels import cuckoofilter as ckoo
from repro_torch.kernels import quotientfilter as qf
from repro_torch.kernels import ops, ring, sbf
from repro_torch.kernels import calibrate as kc
from repro_torch.perfmodel import calibrate as PC
from repro_torch.core import fingerprint as F
from repro_torch.core import partition as P
from repro_torch.core import quotient as Q

M = 1 << 16

SPECS = [
    V.FilterSpec("sbf", M, 8, block_bits=256),
    V.FilterSpec("sbf", M, 16, block_bits=512),
    V.FilterSpec("sbf", M, 4, block_bits=128),
    V.FilterSpec("sbf", M, 2, block_bits=64),
    V.FilterSpec("rbbf", M, 4),
    V.FilterSpec("bbf", M, 8, block_bits=256),
    V.FilterSpec("csbf", M, 8, block_bits=512, z=2),
    V.FilterSpec("csbf", M, 16, block_bits=1024, z=4),
    V.FilterSpec("sbf", 1 << 20, 32, block_bits=1024),
    V.FilterSpec("sbf", 1 << 20, 3, block_bits=256),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(n, seed, device):
    return as_keys(H.random_u64x2(n, seed=seed), device)


def _probes(n, seed, device):
    return as_keys(H.probe_u64x2(n, seed=seed), device)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _filled(spec, n, device, seed=0):
    return sbf.add_plain(spec, V.init(spec, device), _keys(n, seed, device))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 65537])
def test_add_kernels_match_plain(cuda, spec, n):
    keys = _keys(n, n + 1, cuda)
    want = sbf.add_plain(spec, V.init(spec, cuda), keys)
    lay = sbf.default_layout(spec, "add")
    got_l2 = sbf.add_vmem(spec, V.init(spec, cuda), keys, lay)
    got_dram = sbf.add_hbm(spec, V.init(spec, cuda), keys)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_u32(got_l2), _u32(want))
    np.testing.assert_array_equal(_u32(got_dram), _u32(want))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 65537])
def test_contains_kernels_match_plain(cuda, spec, n):
    filt = _filled(spec, 4096, cuda)
    keys = torch.cat([_keys(n // 2, 0, cuda), _probes(n - n // 2, n, cuda)])
    want = sbf.contains_plain(spec, filt, keys)
    lay = sbf.default_layout(spec, "contains")
    got_l2 = sbf.contains_vmem(spec, filt, keys, lay)
    got_dram = sbf.contains_hbm(spec, filt, keys)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_l2.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got_dram.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_schedule_axes_never_change_results(cuda, spec):
    """Every phi, depth, probe, coop and mix value gives the plain result."""
    filt = _filled(spec, 8192, cuda)
    keys = torch.cat([_keys(3000, 0, cuda), _probes(3000, 1, cuda)])
    want = sbf.contains_plain(spec, filt, keys).cpu().numpy()
    for phi in (1, 2, 4, 8):
        got = sbf.contains_vmem(spec, filt, keys, sbf.Layout(1, phi),
                                probe="gather", coop="subtile", mix="cheap")
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    for depth in sbf.DMA_DEPTHS:
        got = sbf.contains_hbm(spec, filt, keys, depth=depth, coop="subtile",
                               mix="cheap")
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    add_keys = _keys(5000, 9, cuda)
    words = _u32(sbf.add_plain(spec, filt, add_keys))
    got = sbf.add_vmem(spec, filt.clone(), add_keys, sbf.Layout(1, 1),
                       probe="gather", coop="subtile", mix="cheap")
    np.testing.assert_array_equal(_u32(got), words)
    got = sbf.add_hbm(spec, filt.clone(), add_keys, coop="subtile",
                      mix="cheap")
    np.testing.assert_array_equal(_u32(got), words)


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches_only(cuda):
    spec = SPECS[0]
    filt = V.init(spec, cuda)
    keys = _keys(1000, 3, cuda)
    sbf.reset_launches()
    sbf.add_vmem(spec, filt, keys, sbf.default_layout(spec, "add"))
    sbf.add_hbm(spec, filt, keys)
    sbf.contains_vmem(spec, filt, keys, sbf.default_layout(spec, "contains"))
    sbf.contains_hbm(spec, filt, keys)
    sbf.contains_hbm(spec, filt, keys[:0])        # n == 0 launches nothing
    sbf.contains_plain(spec, filt, keys)          # the plain path counts none
    assert sbf.LAUNCHES == {"contains_vmem": 1, "add_vmem": 1,
                            "contains_hbm": 1, "add_hbm": 1,
                            "bank_contains_vmem": 0, "bank_add_vmem": 0,
                            "add_partitioned": 0}


@pytest.mark.gpu
def test_ops_regimes_and_inplace(cuda):
    spec = V.FilterSpec("sbf", 1 << 18, 16, block_bits=256)
    keys = _keys(20000, 5, cuda)
    want = _u32(sbf.add_plain(spec, V.init(spec, cuda), keys))
    for regime in ("vmem", "hbm", "auto"):
        base = V.init(spec, cuda)
        new = ops.bloom_add(spec, base, keys, regime=regime)
        assert not base.any()                     # inplace=False clones
        np.testing.assert_array_equal(_u32(new), want)
        same = ops.bloom_add(spec, base, keys, regime=regime, inplace=True)
        assert same.data_ptr() == base.data_ptr()
        np.testing.assert_array_equal(_u32(base), want)
        assert ops.bloom_contains(spec, new, keys, regime=regime).all()


@pytest.mark.gpu
def test_wrappers_refuse_bad_tensors(cuda):
    spec = SPECS[0]
    filt = V.init(spec, cuda)
    keys = _keys(64, 0, cuda)
    misaligned = keys.reshape(-1)[1:-1].reshape(-1, 2)   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        sbf.contains_vmem(spec, filt, misaligned, sbf.Layout(1, 8))
    with pytest.raises(ValueError, match="device|cpu"):
        sbf.add_hbm(spec, filt, keys.cpu())
    with pytest.raises(ValueError, match="int32"):
        sbf.contains_hbm(spec, filt, keys.to(torch.int64))


@pytest.mark.gpu
def test_api_defaults_to_the_card(cuda):
    import repro_torch.api as api
    f = api.filter_for_n_items(50000, bits_per_key=16)
    assert f.device.type == "cuda" and f.backend == "cuda-l2"
    keys = H.random_u64x2(50000, seed=4)
    g = f.add(keys)
    assert not f.dense_words().any()              # f is unchanged
    assert g.contains(keys).all()
    big = api.make_filter("sbf", m_bits=1 << 30, k=16, backend="jnp")
    assert big.backend == "cuda-dram"
    small = api.make_filter("sbf", m_bits=1 << 20, k=16, backend="pallas-hbm")
    assert small.backend == "cuda-dram"
    with pytest.raises(ValueError):
        api.make_filter("sbf", m_bits=1 << 20, k=16, backend="torch")


# ---------------------------------------------------------------------------
# Counting filter kernels (kernels/countingbf.py, csrc/counting.cu)
# ---------------------------------------------------------------------------

CSPECS = [V.FilterSpec("countingbf", M, 8, block_bits=256),
          V.FilterSpec("countingbf", M, 16, block_bits=512),
          V.FilterSpec("countingbf", M, 4, block_bits=128),
          V.FilterSpec("countingbf", M, 2, block_bits=64)]


def _multiset(n, seed, device):
    """n keys, each 1-3 times, plus one key 20 times (it saturates)."""
    keys = _keys(n, seed, device)
    g = torch.Generator().manual_seed(seed)
    reps = torch.randint(1, 4, (n,), generator=g).to(device)
    batch = torch.cat([keys.repeat_interleave(reps, dim=0),
                       keys[:1].expand(20 if n else 0, 2)])
    perm = torch.randperm(batch.shape[0], generator=g).to(device)
    return batch[perm].contiguous()


def _valid_mask(n, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) > 0.25).to(torch.uint8).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 65537])
def test_counting_update_kernels_match_plain(cuda, spec, n):
    batch = _multiset(n, n + 1, cuda)
    valid = _valid_mask(batch.shape[0], n, cuda)
    gone = torch.cat([batch[: batch.shape[0] // 2], _probes(100, n, cuda)])
    for vmask in (None, valid):
        want = cnt.update_plain(spec, V.init(spec, cuda), batch, vmask, "add")
        want_rm = cnt.update_plain(spec, want, gone, None, "remove")
        for update in (cnt.update_vmem, cnt.update_hbm):
            words = update(spec, V.init(spec, cuda), batch, vmask, "add")
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(words), _u32(want))
            update(spec, words, gone, None, "remove")
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(words), _u32(want_rm))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 65537])
def test_counting_contains_and_decay_kernels_match_plain(cuda, spec, n):
    words = cnt.update_plain(spec, V.init(spec, cuda),
                             _multiset(2048, 7, cuda), None, "add")
    keys = torch.cat([_keys(n // 2, 7, cuda), _probes(n - n // 2, n, cuda)])
    for _ in range(3):                                  # down to empty
        want = cnt.contains_plain(spec, words, keys).cpu().numpy()
        for phi in (1, 2, 4, 8, 32):
            got = cnt.contains_vmem(spec, words, keys, sbf.Layout(1, phi),
                                    probe="gather", coop="subtile",
                                    mix="cheap")
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        for depth in sbf.DMA_DEPTHS:
            got = cnt.contains_hbm(spec, words, keys, depth=depth)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        want_words = _u32(cnt.decay_plain(spec, words))
        assert cnt.decay(spec, words) is words
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(words), want_words)


@pytest.mark.gpu
def test_counting_launch_counters_and_filter_path(cuda):
    import repro_torch.api as api
    f = api.filter_for_n_items(50000, bits_per_key=16, variant="countingbf")
    assert f.device.type == "cuda" and f.backend == "counting"
    keys = _keys(50000, 4, cuda)
    cnt.reset_launches()
    g = f.add(keys).add(keys[:1000])
    assert not f.words.any()                      # f is unchanged
    h = g.remove(keys[:25000])
    assert h.contains(keys[25000:]).all()
    d = h.decay(2)
    assert cnt.LAUNCHES == {"update_vmem": 3, "contains_vmem": 1,
                            "update_hbm": 0, "contains_hbm": 0, "decay": 2,
                            "bank_update_vmem": 0, "bank_contains_vmem": 0,
                            "update_partitioned": 0}
    want = cnt.update_plain(f.spec, V.init(f.spec, cuda), keys, None, "add")
    want = cnt.update_plain(f.spec, want, keys[:1000], None, "add")
    want = cnt.update_plain(f.spec, want, keys[:25000], None, "remove")
    want = cnt.decay_plain(f.spec, cnt.decay_plain(f.spec, want))
    np.testing.assert_array_equal(_u32(d.words), _u32(want))
    big = api.make_filter("countingbf", m_bits=1 << 28, k=8)
    assert not ops.fits_l2(big.spec)
    cnt.reset_launches()
    big.add(keys).remove(keys[:10]).contains(keys)
    assert cnt.LAUNCHES["update_hbm"] == 2 and cnt.LAUNCHES["contains_hbm"] == 1


_UPDATE_PATHS = {
    "one-pass": {"path": "one-pass"},
    "binned": {"path": "binned"},
    "binned-batches": {"path": "binned", "cap": 1000},
    "binned-small-bins": {"path": "binned", "bin_row_bits": "least",
                          "cap": 4097},
    "binned-parts": {"path": "binned", "bin_row_bits": "most"},
    "rule": {},
}


def _update(name, spec, words, keys, valid, op, member=None, **kw):
    """One update call; ``bin_row_bits="least"`` is the smallest bins the
    kernels take for these counters (at most 8192 bins), ``"most"`` the
    largest (one bin where the rows allow: its run splits into parts that
    update shared rows by CAS)."""
    rows = words.numel() // spec.counter_row_words
    if kw.get("bin_row_bits") == "least":
        kw = dict(kw, bin_row_bits=cnt.binned_bin_row_bits(rows, 1 << 40))
    elif kw.get("bin_row_bits") == "most":
        kw = dict(kw, bin_row_bits=min(cnt.MAX_BIN_ROW_BITS,
                                       (rows - 1).bit_length()))
    return cnt._launch_update(name, spec, words, keys, valid, op, member,
                              **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("case", list(_UPDATE_PATHS))
def test_counting_update_paths_match_plain(cuda, spec, case):
    """Each update path forced (one-pass; binned at the default bins, over
    several internal batches, in the smallest bins, in the largest bins,
    whose runs split into parts) and the rule's path, against the plain version bit for bit: a multiset
    with a key 21 times (saturation), valid-masked, then removes of present
    and absent keys."""
    kw = _UPDATE_PATHS[case]
    for n in (1, 257, 65537):
        batch = _multiset(n, n + 3, cuda)
        valid = _valid_mask(batch.shape[0], n, cuda)
        gone = torch.cat([batch[: batch.shape[0] // 2], _probes(100, n, cuda)])
        for vmask in (None, valid):
            want = cnt.update_plain(spec, V.init(spec, cuda), batch, vmask,
                                    "add")
            want_rm = cnt.update_plain(spec, want, gone, None, "remove")
            words = _update("update_hbm", spec, V.init(spec, cuda), batch,
                            vmask, "add", **kw)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(words), _u32(want))
            plan = cnt.LAST_UPDATE_PLAN["update_hbm"]
            assert plan["path"] == kw.get("path", cnt.choose_update_path(
                batch.shape[0], spec.storage_words, spec.counter_row_words,
                sbf.partition_smem_bytes(cuda)))
            _update("update_hbm", spec, words, gone, None, "remove", **kw)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(words), _u32(want_rm))


@pytest.mark.gpu
@pytest.mark.parametrize("m_bits", [1 << 17, 1 << 20],
                         ids=["summed", "by-chunk"])
@pytest.mark.parametrize("block_bits, k", [(64, 2), (256, 8), (512, 16)])
def test_counting_split_bins_match_plain(cuda, block_bits, k, m_bits):
    """One bin of a filter's rows takes a batch of ~131K keys: the bin is
    cut into parts that run at once and apply their counts by CAS, summed
    over a part's chunks in shared memory (2^17 bits: the rows fit there)
    or a chunk at a time (2^20 bits: they do not). Valid-masked add with a
    key 21 times, then removes, bit for bit."""
    spec = V.FilterSpec("countingbf", m_bits, k, block_bits=block_bits)
    batch = _multiset(65537, 7, cuda)
    valid = _valid_mask(batch.shape[0], 8, cuda)
    gone = torch.cat([batch[:40000], _probes(100, 9, cuda)])
    for vmask in (None, valid):
        want = cnt.update_plain(spec, V.init(spec, cuda), batch, vmask, "add")
        words = _update("update_hbm", spec, V.init(spec, cuda), batch, vmask,
                        "add", path="binned", bin_row_bits="most")
        plan = cnt.LAST_UPDATE_PLAN["update_hbm"]
        assert plan["n_bins"] <= 2 and plan["split_parts"] > 0
        np.testing.assert_array_equal(_u32(words), _u32(want))
        _update("update_hbm", spec, words, gone, None, "remove",
                path="binned", bin_row_bits="most")
        np.testing.assert_array_equal(
            _u32(words),
            _u32(cnt.update_plain(spec, want, gone, None, "remove")))


def _kernel_names(fn):
    """The names of the CUDA kernels ``fn()`` launched (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("log2n,bits,bank", [
    (14, 11, 1), (14, 8, 1), (15, 0, 1), (15, 5, 1), (14, 4, 33)],
    ids=["1-bin", "2-bins", "512-bins", "16-bins", "bank-1056-bins"])
def test_counting_fused_column_scan_matches_plain(cuda, log2n, bits, bank):
    """The binned update at most COLUMN_SCAN_BINS bins, whose count
    kernel's last CTA does the column and the scan, against the plain
    version, counters exact, over two internal batches, on the current
    stream and on a side stream (each stream has its own arrival counter);
    past that many bins the column and scan kernels. The profiler sees no
    column, scan or parts kernel where the count kernel scans (its last
    CTA also cuts over-full bins into parts)."""
    spec = V.FilterSpec("countingbf", 1 << 17, 8, block_bits=256)
    rows = bank * spec.n_blocks
    keys = _multiset(1 << log2n, log2n + bits, cuda)
    valid = _valid_mask(keys.shape[0], bits, cuda)
    member = (torch.arange(keys.shape[0], device=cuda, dtype=torch.int32)
              * 7919 % bank) if bank > 1 else None
    base = V.init(spec, cuda).repeat(bank, 1) if bank > 1 else V.init(spec,
                                                                     cuda)
    want = (cnt.bank_update_plain(spec, base, keys, member, valid, "add")
            if bank > 1 else cnt.update_plain(spec, base, keys, valid, "add"))
    name = "bank_update_vmem" if bank > 1 else "update_vmem"

    def run(words):
        return _update(name, spec, words, keys, valid, "add", member,
                       path="binned", bin_row_bits=bits,
                       cap=(keys.shape[0] + 1) // 2)
    words = base.clone()
    names = _kernel_names(lambda: run(words))
    plan = cnt.LAST_UPDATE_PLAN[name]
    assert plan["n_bins"] == -(-rows // (1 << bits)) and plan["batches"] == 2
    np.testing.assert_array_equal(_u32(words), _u32(want))
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        again = run(base.clone())
        twice = run(base.clone())
    side.synchronize()
    np.testing.assert_array_equal(_u32(again), _u32(want))
    np.testing.assert_array_equal(_u32(twice), _u32(want))
    np.testing.assert_array_equal(_u32(run(base.clone())), _u32(want))
    count = sum("counting_bin_count_kernel" in n for n in names)
    column = sum("bin_column_kernel" in n for n in names)
    scan = sum("bin_scan_kernel" in n for n in names)
    parts = sum("counting_bin_parts_kernel" in n for n in names)
    assert count == 2
    if plan["n_bins"] <= cnt.COLUMN_SCAN_BINS:
        assert plan["column_scan"] == "fused"
        assert (column, scan, parts) == (0, 0, 0)
    else:
        assert plan["column_scan"] == "two" and (column, scan) == (2, 2)


@pytest.mark.gpu
def test_counting_binned_update_on_the_rule_path_and_memory(cuda,
                                                            monkeypatch):
    """A batch the rule sends binned (2^22 keys into 128 MiB of counters)
    through ``ops``; and a workspace that does not allocate lowers the cap
    (more internal batches, the same counters)."""
    spec = V.FilterSpec("countingbf", 1 << 28, 8, block_bits=256)
    keys = _keys(1 << 22, 9, cuda)
    smem = sbf.partition_smem_bytes(cuda)
    assert cnt.choose_update_path(keys.shape[0], spec.storage_words, 32,
                                  smem) == "binned"
    want = cnt.update_plain(spec, V.init(spec, cuda), keys, None, "add")
    got = ops.counting_add(spec, V.init(spec, cuda), keys)
    assert cnt.LAST_UPDATE_PLAN["update_hbm"]["path"] == "binned"
    np.testing.assert_array_equal(_u32(got), _u32(want))
    real, calls = cnt._workspace, []

    def tight(nbytes, device):
        calls.append(nbytes)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("a test's refusal")
        return real(nbytes, device)
    monkeypatch.setattr(cnt, "_workspace", tight)
    plan = cnt.update_plan(spec, keys.shape[0], "binned",
                           chunks=cnt.binned_chunks(spec.s, spec.n_blocks, 11,
                                                    cuda))
    monkeypatch.setattr(cnt, "free_device_bytes", lambda device: (
        cnt.WORKSPACE_MARGIN + plan["workspace_bytes"] // 3))
    got = cnt.update_hbm(spec, V.init(spec, cuda), keys, None, "add",
                         path="binned", bin_row_bits=11)
    assert cnt.LAST_UPDATE_PLAN["update_hbm"]["batches"] >= 4
    assert len(calls) == 2 and calls[1] < calls[0]
    np.testing.assert_array_equal(_u32(got), _u32(want))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS + [V.FilterSpec(
    "countingbf", 1 << 18, 32, block_bits=1024)], ids=str)
def test_counting_contains_every_theta_and_depth(cuda, spec):
    """The contains at every Θ (lanes a key, s/16 ... s), every load width
    at depth 1 and every depth, on members and probes, ragged sizes; and
    the wrappers at the card's layout."""
    words = cnt.update_plain(spec, V.init(spec, cuda),
                             _multiset(4096, 7, cuda), None, "add")
    keys = torch.cat([_keys(5000, 7, cuda), _probes(5001, 8, cuda)])
    want = cnt.contains_plain(spec, words, keys).cpu().numpy()
    thetas = [t for t in (1, 2, 4, 8, 16, 32) if t <= spec.s]
    for theta in thetas:
        for phi in (1, 2, 4):
            got = cnt.contains_vmem(spec, words, keys, sbf.Layout(theta, phi))
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        for depth in sbf.DMA_DEPTHS:
            geo = cnt.contains_geometry(spec, sbf.Layout(theta, 4), depth)
            for m in (1, 31, 33, 257, keys.shape[0]):
                got = cnt._launch_contains("contains_hbm", spec, words,
                                           keys[:m], geo)
                np.testing.assert_array_equal(got.cpu().numpy(), want[:m])
    for depth in sbf.DMA_DEPTHS:
        got = cnt.contains_hbm(spec, words, keys, depth=depth)
        assert cnt.LAST_GEOMETRY["contains_hbm"] == cnt.contains_geometry(
            spec, cnt.card_layout(spec), depth)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_counting_wrappers_refuse_bad_tensors(cuda):
    spec = CSPECS[0]
    words = V.init(spec, cuda)
    keys = _keys(64, 0, cuda)
    with pytest.raises(ValueError, match="aligned"):
        cnt.update_vmem(spec, words, keys.reshape(-1)[1:-1].reshape(-1, 2),
                        None, "add")
    with pytest.raises(ValueError, match="aligned"):
        cnt.decay(spec, torch.zeros(spec.storage_words + 1, dtype=torch.int32,
                                    device=cuda)[1:])
    with pytest.raises(ValueError, match="device|cpu"):
        cnt.contains_hbm(spec, words, keys.cpu())
    with pytest.raises(ValueError, match="valid"):
        cnt.update_hbm(spec, words, keys, _valid_mask(64, 0, cuda).cpu(),
                       "add")
    with pytest.raises(ValueError, match="counting"):
        ops.bloom_add(spec, words, keys)


# ---------------------------------------------------------------------------
# The classical filter (cbf) and the generation ring (windowed filter)
# ---------------------------------------------------------------------------

CBF_SPECS = [V.FilterSpec("cbf", m, k) for m in (1 << 16, 1 << 20)
             for k in (1, 7, 11, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CBF_SPECS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 65537])
def test_cbf_kernels_match_plain(cuda, spec, n):
    keys = _keys(n, n + 3, cuda)
    want = cbf.add_plain(spec, V.init(spec, cuda), keys)
    words = V.init(spec, cuda)
    assert cbf.add_vmem(spec, words, keys) is words
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_u32(words), _u32(want))
    q = torch.cat([keys, _probes(n, n, cuda)])
    got = cbf.contains_vmem(spec, want, q)
    torch.cuda.synchronize()
    want_hits = cbf.contains_plain(spec, want, q)
    np.testing.assert_array_equal(got.cpu().numpy(), want_hits.cpu().numpy())
    assert got[:n].all()


@pytest.mark.gpu
def test_cbf_kernels_keep_all_32_bits_at_m_2_32(cuda):
    spec = V.FilterSpec("cbf", 1 << 32, 11)
    keys = _keys(1 << 20, 5, cuda)
    words = cbf.add_vmem(spec, V.init(spec, cuda), keys)
    want = cbf.add_plain(spec, V.init(spec, cuda), keys)
    torch.cuda.synchronize()
    assert torch.equal(words, want)
    assert bool(words[spec.n_words // 2:].any())       # the top half is used
    q = torch.cat([keys[:4096], _probes(4096, 6, cuda)])
    assert torch.equal(cbf.contains_vmem(spec, words, q),
                       cbf.contains_plain(spec, words, q))
    del words, want
    torch.cuda.empty_cache()


CBF_PATH_SIZES = [1 << 16, 1 << 20, 1 << 30, 1 << 32]


@pytest.mark.gpu
@pytest.mark.parametrize("path", cbf.PATHS)
@pytest.mark.parametrize("m", CBF_PATH_SIZES,
                         ids=["m2^16", "m2^20", "m2^30", "m2^32"])
@pytest.mark.parametrize("k", [1, 7, 11, 32])
def test_cbf_add_paths_match_plain(cuda, path, m, k):
    """Each add path forced, words equal to the plain version's in full;
    at m = 2^32 the top half of the filter (positions with bit 31) is
    written."""
    spec = V.FilterSpec("cbf", m, k)
    n = 65537 if m < 1 << 30 else 1 << 20
    keys = _keys(n, 31 + k, cuda)
    want = cbf.add_plain(spec, V.init(spec, cuda), keys)
    words = cbf.add_vmem(spec, V.init(spec, cuda), keys, path=path)
    torch.cuda.synchronize()
    assert torch.equal(words, want)
    assert cbf.LAST_ADD_PLAN["path"] == path
    assert cbf.LAST_ADD_PLAN["positions"] == n * k
    if m == 1 << 32:
        assert bool(words[spec.n_words // 2:].any())
    del words, want
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1 << 5, 1 << 16, 1 << 20, 1 << 32],
                         ids=["m2^5", "m2^16", "m2^20", "m2^32"])
def test_cbf_binned_add_batches_and_bins(cuda, m):
    """The binned add over several internal batches (a lowered cap), in bins
    smaller than the default, on a filter smaller than a bin (m = 2^5),
    and into words that already hold keys."""
    spec = V.FilterSpec("cbf", m, 11)
    keys = _keys(100003, 41, cuda)
    base = cbf.add_plain(spec, V.init(spec, cuda), _keys(5000, 42, cuda))
    want = cbf.add_plain(spec, base, keys)
    log2m = m.bit_length() - 1
    for bin_bits, cap in ((None, 11 * 9999), (max(5, log2m - 13), 11 * 70001),
                          (20, 11)):
        if cap == 11 and m > 1 << 20:
            continue                        # one key a batch: 10^5 batches
        words = cbf.add_vmem(spec, base.clone(), keys[: 2000 if cap == 11
                                                     else None],
                             path="binned", bin_bits=bin_bits, cap=cap)
        torch.cuda.synchronize()
        expect = (want if cap != 11
                  else cbf.add_plain(spec, base, keys[:2000]))
        assert torch.equal(words, expect), (bin_bits, cap)
        plan = cbf.LAST_ADD_PLAN
        assert plan["batches"] == -(-(2000 if cap == 11 else 100003)
                                    // (cap // 11))
        assert plan["chunks"] >= 1
        assert plan["n_bins"] == 1 << max(0, log2m - plan["bin_bits"])


@pytest.mark.gpu
def test_cbf_binned_add_one_bin_and_repeated_keys(cuda):
    """Keys whose positions all fall in one bin of a two-bin filter, and a
    batch of one key repeated: every chunk's run lands in one or k bins."""
    spec = V.FilterSpec("cbf", 1 << 20, 3)
    cand = _keys(1 << 21, 43, cuda)
    h1, h2 = H.hash_keys(cand)
    pos = V.cbf_positions(spec, h1, h2)
    one_bin = cand[(pos < 1 << 19).all(dim=1)].contiguous()
    assert one_bin.shape[0] > 100000
    repeated = cand[:1].expand(300000, 2).contiguous()
    for keys in (one_bin, repeated):
        for path in cbf.PATHS:
            words = cbf.add_vmem(spec, V.init(spec, cuda), keys, path=path)
            torch.cuda.synchronize()
            assert torch.equal(words, cbf.add_plain(spec, V.init(spec, cuda),
                                                    keys))
            if keys is one_bin:                  # the second bin untouched
                assert not bool(words[spec.n_words // 2:].any())
    assert cbf.LAST_ADD_PLAN["n_bins"] == 2


@pytest.mark.gpu
def test_cbf_add_takes_the_rule_path(cuda):
    """With no path given, the wrapper runs choose_path's path with the
    card's shared memory; small adds into a bank-sized member stay
    one-pass."""
    smem = sbf.partition_smem_bytes(cuda)
    for m, n in ((1 << 16, 3000), (1 << 30, 1 << 16), (1 << 30, 1 << 22)):
        spec = V.FilterSpec("cbf", m, 11)
        keys = _keys(n, 44, cuda)
        words = cbf.add_vmem(spec, V.init(spec, cuda), keys)
        torch.cuda.synchronize()
        assert cbf.LAST_ADD_PLAN["path"] == cbf.choose_path(n, m, 11, smem)
        assert torch.equal(words, cbf.add_plain(spec, V.init(spec, cuda),
                                                keys))
    assert cbf.choose_path(3000, 1 << 16, 11, smem) == "one-pass"


@pytest.mark.gpu
@pytest.mark.parametrize("path", cbf.PATHS)
@pytest.mark.parametrize("m", CBF_PATH_SIZES,
                         ids=["m2^16", "m2^20", "m2^30", "m2^32"])
@pytest.mark.parametrize("k", [1, 7, 11, 32])
def test_cbf_contains_paths_match_plain(cuda, path, m, k):
    """Each contains path forced, results equal to the plain version's on
    members, keys never added and one member repeated."""
    spec = V.FilterSpec("cbf", m, k)
    n = 65537 if m < 1 << 30 else 1 << 20
    keys = _keys(n, 51 + k, cuda)
    words = cbf.add_plain(spec, V.init(spec, cuda), keys)
    q = torch.cat([keys, _probes(n, 52 + k, cuda),
                   keys[:1].expand(300, 2)]).contiguous()
    got = cbf.contains_vmem(spec, words, q, path=path)
    torch.cuda.synchronize()
    assert torch.equal(got, cbf.contains_plain(spec, words, q))
    assert bool(got[:n].all())
    assert cbf.LAST_CONTAINS_PLAN["path"] == path
    assert cbf.LAST_CONTAINS_PLAN["positions"] == q.shape[0] * k
    del words
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1 << 5, 1 << 16, 1 << 20, 1 << 32],
                         ids=["m2^5", "m2^16", "m2^20", "m2^32"])
def test_cbf_binned_contains_batches_and_bins(cuda, m):
    """The binned contains over several internal batches (a lowered cap),
    in bins smaller than the default, on a filter smaller than a bin, and
    n of 0, 1 and 2."""
    spec = V.FilterSpec("cbf", m, 11)
    keys = _keys(50003, 61, cuda)
    words = cbf.add_plain(spec, V.init(spec, cuda), keys[:20000])
    want = cbf.contains_plain(spec, words, keys)
    log2m = m.bit_length() - 1
    small = max(5, log2m - 13)                     # 8192 bins at most
    for bin_bits, cap, n in ((None, 11 * 9999, 50003),
                             (small, 11 * 7001, 50003), (small, 11 * 3, 300)):
        got = cbf.contains_vmem(spec, words, keys[:n], path="binned",
                                bin_bits=bin_bits, cap=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want[:n]), (bin_bits, cap)
        plan = cbf.LAST_CONTAINS_PLAN
        assert plan["batches"] == -(-n // (cap // 11))
        assert plan["n_bins"] == 1 << max(0, log2m - plan["bin_bits"])
    for n in (0, 1, 2):
        got = cbf.contains_vmem(spec, words, keys[:n], path="binned")
        assert torch.equal(got, want[:n])
    del words
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cbf_contains_takes_the_rule_path(cuda):
    """With no path given, the wrapper runs choose_contains_path's path;
    small calls and filters in L2 stay one-pass."""
    smem = sbf.partition_smem_bytes(cuda)
    for m, n in ((1 << 16, 3000), (1 << 27, 1 << 20), (1 << 30, 1 << 16),
                 (1 << 30, 1 << 22), (1 << 32, 1 << 22), (1 << 32, 1 << 23)):
        spec = V.FilterSpec("cbf", m, 11)
        keys = _keys(n, 62, cuda)
        words = cbf.add_plain(spec, V.init(spec, cuda), keys[: n // 2])
        got = cbf.contains_vmem(spec, words, keys)
        torch.cuda.synchronize()
        assert cbf.LAST_CONTAINS_PLAN["path"] == cbf.choose_contains_path(
            n, m, 11, smem)
        assert torch.equal(got, cbf.contains_plain(spec, words, keys))
    assert cbf.choose_contains_path(1 << 23, 1 << 32, 11, smem) == "binned"
    assert cbf.choose_contains_path(1 << 22, 1 << 32, 11, smem) == "one-pass"
    assert cbf.choose_contains_path(3000, 1 << 16, 11, smem) == "one-pass"


def _plug_free_blocks(index: int) -> list:
    """Tensors that take the free blocks of the caching allocator's segments
    that still hold live tensors (``empty_cache`` releases only whole free
    segments), largest first, so that each takes its own block. A later
    allocation then needs a new segment, which the per-process memory
    fraction bounds; a free block inside a segment would serve it
    unbounded."""
    torch.cuda.empty_cache()
    sizes = sorted((block["size"] for seg in torch.cuda.memory_snapshot()
                    if seg["device"] == index for block in seg["blocks"]
                    if block["state"] == "inactive"), reverse=True)
    return [torch.empty(size, dtype=torch.uint8, device=f"cuda:{index}")
            for size in sizes]


@pytest.mark.gpu
def test_cbf_binned_workspace_is_bounded_by_free_memory(cuda, monkeypatch):
    """Where the process may not allocate a binned call's workspace at the
    default cap, the add and the contains lower their caps (more internal
    batches; the same words and results); with no room for any workspace
    (a fake allocation that fails past 1 MiB) a binned call raises
    MemoryError, forced or the rule's."""
    spec = V.FilterSpec("cbf", 1 << 30, 11)
    keys = _keys(1 << 22, 71, cuda)
    words = cbf.add_plain(spec, V.init(spec, cuda), keys)
    want = cbf.contains_plain(spec, words, keys)
    target = V.init(spec, cuda)
    full = {planner: planner(keys.shape[0], spec.m_bits, 11, "binned",
                             chunks=cbf.binned_chunks(
                                 spec, cbf.BIN_BITS, cuda,
                                 keys=planner is cbf.contains_plan))
            for planner in (cbf.add_plan, cbf.contains_plan)}
    gc.collect()                            # no garbage frees room later
    torch.cuda.synchronize()
    index = torch.cuda.current_device()
    plugs = _plug_free_blocks(index)
    total = torch.cuda.get_device_properties(index).total_memory
    # the room: a 20 MiB segment (the result's) and a third of a workspace
    room = (torch.cuda.memory_reserved(index) + (20 << 20)
            + min(plan["workspace_bytes"] for plan in full.values()) // 3)
    try:
        torch.cuda.set_per_process_memory_fraction(room / total, index)
        got = cbf.contains_vmem(spec, words, keys, path="binned")
        contains_plan = dict(cbf.LAST_CONTAINS_PLAN)
        cbf.add_vmem(spec, target, keys, path="binned")
        add_plan = dict(cbf.LAST_ADD_PLAN)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, index)
    del plugs
    assert torch.equal(got, want)
    assert torch.equal(target, words)
    assert contains_plan["batches"] > full[cbf.contains_plan]["batches"]
    assert add_plan["batches"] > full[cbf.add_plan]["batches"]
    torch.cuda.synchronize()

    def tight(nbytes, device):
        if nbytes > 1 << 20:
            raise torch.cuda.OutOfMemoryError("past the test's 1 MiB")
        return torch.empty(nbytes // 4, dtype=torch.int32, device=device)

    monkeypatch.setattr(cbf, "_workspace", tight)
    monkeypatch.setattr(cbf, "free_device_bytes", lambda device: 1 << 20)
    del words, target
    big = V.FilterSpec("cbf", 1 << 32, 11)
    words = V.init(big, cuda)
    many = _keys(1 << 24, 72, cuda)          # the rules pick binned
    smem = sbf.partition_smem_bytes(cuda)
    assert cbf.choose_contains_path(many.shape[0], big.m_bits, 11,
                                    smem) == "binned"
    assert cbf.choose_path(many.shape[0], big.m_bits, 11, smem) == "binned"
    for path in ("binned", None):           # forced, and the rule's
        with pytest.raises(MemoryError):
            cbf.contains_vmem(big, words, many, path=path)
        with pytest.raises(MemoryError):
            cbf.add_vmem(big, words, many, path=path)


def _ring(spec, G, device):
    return torch.stack([sbf.add_plain(spec, V.init(spec, device),
                                      _keys(3000, 20 + g, device))
                        for g in range(G)])


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 9])
def test_ring_kernel_matches_plain(cuda, spec, G):
    """Both paths of the ring contains forced, against the plain version:
    one-pass at every Θ (and every accepted depth); binned at the default
    bins, over several internal batches, and in bins of one row and of a
    few rows."""
    rings = _ring(spec, G, cuda)
    for n in (0, 1, 255, 257, 65537):
        q = torch.cat([_keys(3000, 20, cuda)[: n // 2],
                       _probes(n - min(n // 2, 3000), n, cuda)])
        want = ring.ring_contains_ref(spec, rings, q).cpu().numpy()
        got = ring.ring_contains_vmem(spec, rings, q)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        for depth in sbf.DMA_DEPTHS:
            got = ring.ring_contains_hbm(spec, rings, q, depth=depth,
                                         path="one-pass")
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        for theta in (t for t in (1, 2, 4, 8, 16, 32) if t <= spec.s):
            got = ring.ring_contains_vmem(spec, rings, q, path="one-pass",
                                          theta=theta)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        for bits, cap in ((None, ring.CONTAINS_KEY_CAP), (None, 1000),
                          (0, 65536), (3, 4097)):
            got = ring.ring_contains_hbm(spec, rings, q, path="binned",
                                         bin_row_bits=bits, cap=cap)
            assert ring.LAST_CONTAINS_PLAN.get("path", "binned") == "binned"
            np.testing.assert_array_equal(got.cpu().numpy(), want)
    live = _keys(3000, 20 + G - 1, cuda)
    assert ring.ring_contains_vmem(spec, rings, live).all()
    assert ring.ring_contains_vmem(spec, rings, live, path="binned").all()


@pytest.mark.gpu
def test_ring_contains_takes_the_rule_path(cuda):
    """With no path given, both wrappers run choose_contains_path's path
    for their regime: one-pass in the L2 wrapper and for small batches,
    binned for a large batch against a ring in the DRAM wrapper; the plan
    records it."""
    smem = sbf.partition_smem_bytes(cuda)
    spec = V.FilterSpec("sbf", 1 << 27, 8, block_bits=256)    # 16 MiB
    rings = torch.zeros((8, spec.n_words), dtype=torch.int32, device=cuda)
    rings[3] = sbf.add_plain(spec, rings[3], _keys(1 << 16, 4, cuda))
    for n in (1000, 1 << 22):
        q = torch.cat([_keys(1 << 16, 4, cuda), _probes(n, 5, cuda)])
        for fn, l2 in ((ring.ring_contains_vmem, True),
                       (ring.ring_contains_hbm, False)):
            path = ring.choose_contains_path(q.shape[0], spec.n_words, 8,
                                             spec.s, smem, l2)
            assert path == ("binned" if n > 1000 and not l2 else "one-pass")
            got = fn(spec, rings, q)
            torch.cuda.synchronize()
            assert ring.LAST_CONTAINS_PLAN["path"] == path
            assert torch.equal(got, ring.ring_contains_ref(spec, rings, q))
            assert got[: 1 << 16].all()
    small = rings[:2, : spec.n_words // 16].contiguous()
    sspec = V.FilterSpec("sbf", spec.m_bits // 16, 8, block_bits=256)
    assert ring.choose_contains_path(1 << 22, sspec.n_words, 2, 8,
                                     smem, False) == "one-pass"


@pytest.mark.gpu
def test_windowed_and_cbf_filter_paths_on_the_card(cuda):
    import repro_torch.api as api
    w = api.filter_for_n_items(50000, bits_per_key=16, generations=4)
    assert w.device.type == "cuda" and w.backend == "windowed"
    batches = [_keys(12500, 40 + i, cuda) for i in range(5)]
    sbf.reset_launches()
    ring.reset_launches()
    plain = V.init(w.spec, cuda).expand(4, -1).clone()
    head = 0
    for i, b in enumerate(batches):
        w = w.add(b)
        plain[head] = sbf.add_plain(w.spec, plain[head], b)
        if i < 4:
            w = w.advance()
            head = (head + 1) % 4
            plain[head] = 0
        assert w.head == head and torch.equal(w.words, plain)
    assert w.contains(torch.cat(batches[1:])).all()
    q = torch.cat([batches[0], _probes(50000, 8, cuda)])
    assert torch.equal(w.contains(q), ring.ring_contains_ref(w.spec, plain, q))
    assert sbf.LAUNCHES["add_vmem"] == 5
    assert ring.LAUNCHES == {"ring_contains_vmem": 2, "ring_contains_hbm": 0}
    c = api.filter_for_n_items(50000, bits_per_key=16, variant="cbf")
    assert c.backend == "cuda-l2"
    keys = _keys(50000, 9, cuda)
    cbf.reset_launches()
    g = c.add(keys)
    assert not c.words.any() and g.contains(keys).all()
    assert torch.equal(g.words, cbf.add_plain(c.spec, c.words, keys))
    big = api.make_filter("cbf", m_bits=1 << 30, k=11)
    assert big.backend == "cuda-dram"
    big.add(keys).contains(keys)
    assert cbf.LAUNCHES == {"contains_vmem": 2, "add_vmem": 2}


@pytest.mark.gpu
def test_cbf_and_ring_wrappers_refuse_bad_tensors(cuda):
    spec = CBF_SPECS[0]
    words = V.init(spec, cuda)
    keys = _keys(64, 0, cuda)
    misaligned = keys.reshape(-1)[1:-1].reshape(-1, 2)
    with pytest.raises(ValueError, match="aligned"):
        cbf.contains_vmem(spec, words, misaligned)
    with pytest.raises(ValueError, match="device|cpu"):
        cbf.add_vmem(spec, words, keys.cpu())
    with pytest.raises(ValueError, match="words"):
        cbf.add_vmem(spec, words[:-1], keys)
    rspec = SPECS[0]
    rings = _ring(rspec, 3, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ring.ring_contains_vmem(rspec, rings.t().contiguous().t(), keys)
    with pytest.raises(ValueError, match="G, n_words"):
        ring.ring_contains_hbm(rspec, rings[0], keys)
    with pytest.raises(ValueError, match="s <= 32"):
        ring.ring_contains_vmem(V.FilterSpec("sbf", M, 64, block_bits=2048),
                                V.init(V.FilterSpec("sbf", M, 64,
                                                    block_bits=2048),
                                       cuda).expand(2, -1).contiguous(),
                                keys)


# ---------------------------------------------------------------------------
# Bank kernels (bank forms of bloom.cu and counting.cu)
# ---------------------------------------------------------------------------

BANK_SPECS = [V.FilterSpec("sbf", 1 << 14, 8, block_bits=256),
              V.FilterSpec("bbf", 1 << 14, 8, block_bits=256),
              V.FilterSpec("rbbf", 1 << 14, 4),
              V.FilterSpec("csbf", 1 << 14, 8, block_bits=512, z=2)]


def _routed(B, n, seed, device, skewed=False):
    """(keys, member int32, valid uint8 with about a quarter zeros)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    member = torch.randint(0, B, (n,), generator=g, dtype=torch.int32)
    if skewed:
        member[torch.rand(n, generator=g) < 0.5] = 0
    valid = (torch.rand(n, generator=g) > 0.25).to(torch.uint8)
    return (_keys(n, seed, device), member.to(device), valid.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", BANK_SPECS, ids=str)
@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
def test_bank_kernels_match_plain(cuda, spec, B, skewed):
    for n in (0, 1, 257, 65537):
        keys, member, valid = _routed(B, n, n + B, cuda, skewed)
        empty = torch.zeros((B, spec.n_words), dtype=torch.int32, device=cuda)
        want = sbf.bank_add_plain(spec, empty, keys, member, valid)
        got = sbf.bank_add_vmem(spec, empty.clone(), keys, member, valid,
                                sbf.default_layout(spec, "add"))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        q = torch.cat([keys, _probes(n, n, cuda)])
        qm = torch.cat([member, member.flip(0)])
        hits = sbf.bank_contains_plain(spec, want, q, qm)
        lay = sbf.default_layout(spec, "contains")
        for depth in (1, 2, 4):
            got = sbf.bank_contains_vmem(spec, want, q, qm, lay, depth=depth)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          hits.cpu().numpy())


# ---------------------------------------------------------------------------
# The warp-cooperative geometry: every Θ, depth and load width (csrc/bloom.cu)
# ---------------------------------------------------------------------------

def _thetas(spec):
    return [t for t in (1, 2, 4, 8, 16, 32) if t <= spec.s]


SPEC_THETAS = [(spec, t) for spec in SPECS for t in _thetas(spec)]
# ragged sizes: below a warp, around one, and not a multiple of a CTA's
# keys at any depth (256 to 2048)
RAGGED = (1, 5, 31, 33, 2053, 65537)


@pytest.mark.gpu
@pytest.mark.parametrize("spec,theta", SPEC_THETAS,
                         ids=[f"{s}-theta{t}" for s, t in SPEC_THETAS])
def test_coop_add_matches_plain_at_every_theta(cuda, spec, theta):
    for n in RAGGED:
        keys = _keys(n, n + theta, cuda)
        want = _u32(sbf.add_plain(spec, V.init(spec, cuda), keys))
        got = sbf.add_vmem(spec, V.init(spec, cuda), keys,
                           sbf.Layout(theta, 1))
        np.testing.assert_array_equal(_u32(got), want)
        geo = sbf.launch_geometry(spec, "add", sbf.Layout(theta, 1))
        got = sbf._launch_add("add_hbm", spec, V.init(spec, cuda), keys, geo)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("spec,theta", SPEC_THETAS,
                         ids=[f"{s}-theta{t}" for s, t in SPEC_THETAS])
def test_coop_contains_matches_plain_at_every_theta(cuda, spec, theta):
    filt = _filled(spec, 8192, cuda)
    for n in RAGGED:
        q = torch.cat([_keys(n - n // 2, 0, cuda), _probes(n // 2, n, cuda)])
        want = sbf.contains_plain(spec, filt, q).cpu().numpy()
        for phi in (1, 2, 4):
            got = sbf.contains_vmem(spec, filt, q, sbf.Layout(theta, phi))
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        for depth in sbf.DMA_DEPTHS:
            geo = sbf.launch_geometry(spec, "contains",
                                      sbf.Layout(theta, 4), depth)
            got = sbf._launch_contains("contains_hbm", spec, filt, q, geo)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
            assert sbf.LAST_GEOMETRY["contains_hbm"].theta == theta


@pytest.mark.gpu
@pytest.mark.parametrize("spec", BANK_SPECS, ids=str)
@pytest.mark.parametrize("B", [1, 7, 64])
def test_coop_bank_kernels_match_plain_at_every_theta(cuda, spec, B):
    for n in (1, 33, 2053):
        keys, member, valid = _routed(B, n, n + 7 * B, cuda)
        empty = torch.zeros((B, spec.n_words), dtype=torch.int32, device=cuda)
        want = sbf.bank_add_plain(spec, empty, keys, member, valid)
        q = torch.cat([keys, _probes(n, n, cuda)])
        qm = torch.cat([member, member.flip(0)])
        hits = sbf.bank_contains_plain(spec, want, q, qm).cpu().numpy()
        for theta in _thetas(spec):
            got = sbf.bank_add_vmem(spec, empty.clone(), keys, member, valid,
                                    sbf.Layout(theta, 1))
            np.testing.assert_array_equal(_u32(got), _u32(want))
            for depth in sbf.DMA_DEPTHS:
                got = sbf.bank_contains_vmem(spec, want, q, qm,
                                             sbf.Layout(theta, 4),
                                             depth=depth)
                np.testing.assert_array_equal(got.cpu().numpy(), hits)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_default_path_runs_card_layout(cuda, spec):
    """ops without a layout runs card_layout in both regimes (the DRAM
    contains at the tuned depth), with the plain version's results."""
    keys = _keys(5000, 11, cuda)
    want = _u32(sbf.add_plain(spec, V.init(spec, cuda), keys))
    q = torch.cat([keys, _probes(5000, 12, cuda)])
    for regime, add_name, con_name in (("vmem", "add_vmem", "contains_vmem"),
                                       ("hbm", "add_hbm", "contains_hbm")):
        words = ops.bloom_add(spec, V.init(spec, cuda), keys, regime=regime)
        np.testing.assert_array_equal(_u32(words), want)
        got = ops.bloom_contains(spec, words, q, regime=regime)
        want_hits = sbf.contains_plain(spec, words, q)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      want_hits.cpu().numpy())
        for op, name in (("add", add_name), ("contains", con_name)):
            geo = sbf.LAST_GEOMETRY[name]
            lay = sbf.card_layout(spec, op)
            assert geo.theta == min(lay.theta, spec.s)
            assert geo == sbf.launch_geometry(spec, op, lay, geo.depth)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [SPECS[0], SPECS[1], SPECS[5], SPECS[6]],
                         ids=str)
def test_tuned_options_run_card_layout(cuda, spec, tmp_path, monkeypatch):
    """A filter made with ``api.tuned_options(spec, op)`` on the card runs
    ``card_layout(spec, op)``'s geometry for that op, with the plain
    version's words and results."""
    from repro_torch import api
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    keys = _keys(5000, 13, cuda)
    want = _u32(sbf.add_plain(spec, V.init(spec, cuda), keys))
    for op, name in (("add", "add_vmem"), ("contains", "contains_vmem")):
        opts = api.tuned_options(spec, op, "vmem", device=cuda)
        assert opts.layout == sbf.card_layout(spec, op)
        f = api.make_filter(
            spec.variant, m_bits=spec.m_bits, k=spec.k,
            block_bits=spec.block_bits, z=spec.z, backend="cuda-l2",
            layout=opts.layout, tile=opts.tile, probe=opts.probe,
            depth=opts.depth, coop=opts.coop, mix=opts.mix, device=cuda)
        g = f.add(keys)
        np.testing.assert_array_equal(_u32(g.words), want)
        assert bool(g.contains(keys).all())
        assert sbf.LAST_GEOMETRY[name] == sbf.launch_geometry(
            spec, op, opts.layout)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS[:2], ids=str)
@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
def test_counting_bank_kernels_match_plain(cuda, spec, B, skewed):
    for n in (0, 1, 257, 65537):
        keys, member, valid = _routed(B, n, n + B, cuda, skewed)
        keys = torch.cat([keys, keys[: n // 3]])           # counts of 2
        member = torch.cat([member, member[: n // 3]])
        valid = torch.cat([valid, valid[: n // 3]])
        empty = torch.zeros((B, spec.storage_words), dtype=torch.int32,
                            device=cuda)
        want = cnt.bank_update_plain(spec, empty, keys, member, valid, "add")
        got = cnt.bank_update_vmem(spec, empty.clone(), keys, member, valid,
                                   "add")
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        half = keys.shape[0] // 2
        want_rm = cnt.bank_update_plain(spec, want, keys[:half],
                                        member[:half], None, "remove")
        cnt.bank_update_vmem(spec, got, keys[:half], member[:half], None,
                             "remove")
        np.testing.assert_array_equal(_u32(got), _u32(want_rm))
        q = torch.cat([keys, _probes(keys.shape[0], n, cuda)])
        qm = torch.cat([member, member.flip(0)])
        hits = cnt.bank_contains_plain(spec, want_rm, q, qm)
        for depth in (1, 2, 4):
            out = cnt.bank_contains_vmem(spec, want_rm, q, qm, depth=depth)
            np.testing.assert_array_equal(out.cpu().numpy(),
                                          hits.cpu().numpy())
        decayed = cnt.decay(spec, want_rm.clone())
        np.testing.assert_array_equal(
            _u32(decayed), _u32(cnt.decay_plain(spec, want_rm)))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("case", ["one-pass", "binned", "binned-small-bins",
                                  "binned-parts"])
def test_counting_bank_update_paths_and_contains_match_plain(
        cuda, spec, B, skewed, case):
    """The bank update on each path forced (bins cross member boundaries),
    valid-masked, with counts of 2, then a remove; and the bank contains at
    every Θ and depth."""
    kw = _UPDATE_PATHS[case]
    keys, member, valid = _routed(B, 65537, B + 1, cuda, skewed)
    keys = torch.cat([keys, keys[:20000]])
    member = torch.cat([member, member[:20000]])
    valid = torch.cat([valid, valid[:20000]])
    empty = torch.zeros((B, spec.storage_words), dtype=torch.int32,
                        device=cuda)
    want = cnt.bank_update_plain(spec, empty, keys, member, valid, "add")
    got = _update("bank_update_vmem", spec, empty.clone(), keys, valid,
                  "add", member, **kw)
    np.testing.assert_array_equal(_u32(got), _u32(want))
    assert cnt.LAST_UPDATE_PLAN["bank_update_vmem"]["members"] == B
    want_rm = cnt.bank_update_plain(spec, want, keys[:30000],
                                    member[:30000], None, "remove")
    _update("bank_update_vmem", spec, got, keys[:30000], None, "remove",
            member[:30000], **kw)
    np.testing.assert_array_equal(_u32(got), _u32(want_rm))
    if case != "one-pass":
        return
    q = torch.cat([keys[:5000], _probes(5000, B, cuda)])
    qm = torch.cat([member[:5000], member[-5000:]])
    hits = cnt.bank_contains_plain(spec, want_rm, q, qm).cpu().numpy()
    for theta in (1, 2, 4, 8, 16, 32):
        for depth in sbf.DMA_DEPTHS:
            geo = cnt.contains_geometry(spec, sbf.Layout(theta, 4), depth)
            out = cnt._launch_contains("bank_contains_vmem", spec, want_rm,
                                       q, geo, qm)
            np.testing.assert_array_equal(out.cpu().numpy(), hits)


@pytest.mark.gpu
def test_bank_filter_paths_are_one_launch_per_routed_op(cuda):
    import repro_torch.api as api
    B = 64
    keys, member, valid = _routed(B, 50000, 3, cuda, skewed=True)
    for variant in ("sbf", "countingbf"):
        t = api.filter_for_n_items(2048, bits_per_key=16, variant=variant,
                                   bank=B)
        assert t.device.type == "cuda" and t.bank_shape == (B,)
        assert t.backend == ("cuda-l2" if variant == "sbf" else "counting")
        sbf.reset_launches()
        cnt.reset_launches()
        g = t.add(keys, tenants=member, valid=valid)
        hits = g.contains(keys, tenants=member)
        mod = sbf if variant == "sbf" else cnt
        add_name = ("bank_add_vmem" if variant == "sbf"
                    else "bank_update_vmem")
        assert mod.LAUNCHES[add_name] == 1
        assert mod.LAUNCHES["bank_contains_vmem"] == 1
        assert hits[valid.bool()].all()
        plain = (sbf.bank_add_plain(t.spec, t.words, keys, member, valid)
                 if variant == "sbf" else cnt.bank_update_plain(
                     t.spec, t.words, keys, member, valid, "add"))
        assert torch.equal(g.words, plain) and not t.words.any()
    cnt.reset_launches()
    d = g.remove(keys[:20000], tenants=member[:20000]).decay(1)
    assert cnt.LAUNCHES["bank_update_vmem"] == 1 and cnt.LAUNCHES["decay"] == 1
    want = cnt.decay_plain(g.spec, cnt.bank_update_plain(
        g.spec, g.words, keys[:20000], member[:20000], None, "remove"))
    assert torch.equal(d.words, want)
    big = api.make_filter_bank(B, "sbf", m_bits=1 << 24, k=8)   # 2x the L2
    assert not ops.bank_l2_resident(big.spec, B)
    assert big.backend == "cuda-dram"
    sbf.reset_launches()
    big.add(keys, tenants=member).contains(keys, tenants=member)
    assert (sbf.LAUNCHES["bank_add_vmem"], sbf.LAUNCHES["bank_contains_vmem"]
            ) == (1, 1)
    # cbf and windowed banks: the generic path, one scalar launch a member
    c = api.make_filter_bank(8, "cbf", m_bits=1 << 16, k=7)
    cbf.reset_launches()
    c2 = c.add(keys[:4000], tenants=member[:4000] % 8)
    assert cbf.LAUNCHES["add_vmem"] == 8
    assert c2.contains(keys[:4000], tenants=member[:4000] % 8).all()
    w = api.make_filter_bank(8, "sbf", m_bits=1 << 16, k=8, generations=3)
    w2 = w.add(keys[:4000], tenants=member[:4000] % 8).advance()
    assert w2.head == (1,) * 8
    assert w2.contains(keys[:4000], tenants=member[:4000] % 8).all()


@pytest.mark.gpu
def test_bank_filter_refuses_out_of_range_card_tenants(cuda):
    import repro_torch.api as api
    keys, member, _ = _routed(4, 64, 0, cuda)
    wide = member.to(torch.int64)
    wide[5] = 1 << 32                  # 0 after a bare cast to int32
    for bad in (member + 1, member - 1, wide):
        for variant, g in (("sbf", None), ("countingbf", None),
                           ("cbf", None), ("sbf", 3)):
            t = api.make_filter_bank(4, variant, m_bits=1 << 16, k=8,
                                     generations=g)
            for call in (lambda: t.add(keys, tenants=bad),
                         lambda: t.contains(keys, tenants=bad)):
                with pytest.raises(ValueError, match=r"\[0, 4\)"):
                    call()


@pytest.mark.gpu
def test_bank_wrappers_refuse_bad_tensors(cuda):
    spec = BANK_SPECS[0]
    bank = torch.zeros((4, spec.n_words), dtype=torch.int32, device=cuda)
    keys, member, valid = _routed(4, 64, 0, cuda)
    lay = sbf.default_layout(spec, "add")
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        sbf.bank_add_vmem(spec, bank, keys, member + 1, valid, lay)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        sbf.bank_contains_vmem(spec, bank, keys, member - 1, lay)
    with pytest.raises(ValueError, match="member on"):
        sbf.bank_contains_vmem(spec, bank, keys, member.cpu(), lay)
    with pytest.raises(ValueError, match="aligned"):
        sbf.bank_contains_vmem(spec, bank,
                               keys.reshape(-1)[1:-1].reshape(-1, 2),
                               member[:63], lay)
    cspec = CSPECS[0]
    cbank = torch.zeros((4, cspec.storage_words), dtype=torch.int32,
                        device=cuda)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        cnt.bank_update_vmem(cspec, cbank, keys, member + 1, None, "add")
    with pytest.raises(ValueError, match="valid"):
        cnt.bank_update_vmem(cspec, cbank, keys, member, valid.cpu(), "add")
    assert not bank.any() and not cbank.any()


# ---------------------------------------------------------------------------
# Partitioned updates and the cuckoo filter
# ---------------------------------------------------------------------------

PSPECS = [V.FilterSpec("sbf", 1 << 20, 8, block_bits=256),
          V.FilterSpec("csbf", 1 << 20, 8, block_bits=512, z=2),
          V.FilterSpec("rbbf", 1 << 20, 4),
          V.FilterSpec("bbf", 1 << 20, 8, block_bits=256)]


def _global_atomics(monkeypatch):
    """Send the partitioned kernels down their global-atomic path: no
    segment fits a shared-memory budget of 0."""
    monkeypatch.setattr(sbf, "partition_smem_bytes", lambda device: 0)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", PSPECS, ids=str)
@pytest.mark.parametrize("n_segments", [1, 8, 64])
def test_partitioned_add_kernel_matches_plain(cuda, spec, n_segments,
                                              monkeypatch):
    """Both paths of the partitioned add forced (shared, global), with a
    slot placed in a
    foreign segment and a segment of invalid slots; then through ``ops``
    on the rule's path and with global atomics forced."""
    keys = _keys(30001, n_segments, cuda)
    want = _u32(sbf.add_plain(spec, V.init(spec, cuda), keys))
    seg_words = spec.n_words // n_segments
    assert sbf.segment_fits(seg_words, cuda)
    part = P.partition_jit(spec, keys, n_segments, 4 * 30001 // n_segments
                           + 64)
    foreign = part.keys_by_seg.clone()
    fvalid = part.valid.clone()
    owner = (n_segments - 1) // 2
    slot = int((fvalid[owner] == 0).nonzero()[0])
    foreign[owner, slot] = _keys(1, 99, cuda)[0]
    fvalid[owner, slot] = 1
    if n_segments > 1:
        fvalid[n_segments - 1] = 0
    for kb, v in ((part.keys_by_seg, part.valid), (foreign, fvalid)):
        plain = sbf.add_partitioned_plain(spec, V.init(spec, cuda), kb, v)
        for path in sbf.PARTITIONED_PATHS:
            got = sbf.add_partitioned(spec, V.init(spec, cuda), kb, v,
                                      n_segments, path=path)
            torch.cuda.synchronize()
            assert sbf.LAST_PARTITIONED_PLAN["path"] == path
            np.testing.assert_array_equal(_u32(got), _u32(plain))
    for path in ("rule", "global"):
        if path == "global":
            _global_atomics(monkeypatch)
        for cap in (None, 64):
            got = ops.bloom_add_partitioned(spec, V.init(spec, cuda), keys,
                                            n_segments=n_segments,
                                            capacity=cap)
            np.testing.assert_array_equal(_u32(got), want)
        got = ops.bloom_add_partitioned(spec, V.init(spec, cuda), keys,
                                        n_segments=n_segments,
                                        partition="host")
        np.testing.assert_array_equal(_u32(got), want)
        # a batch in one segment: the default capacity escalates
        skew = keys[P.segment_ids(spec, keys, n_segments) == 0]
        got = ops.bloom_add_partitioned(spec, V.init(spec, cuda), skew,
                                        n_segments=n_segments)
        np.testing.assert_array_equal(
            _u32(got), _u32(sbf.add_plain(spec, V.init(spec, cuda), skew)))


@pytest.mark.gpu
def test_partitioned_add_takes_the_rule_path(cuda, monkeypatch):
    """With no path given, add_partitioned runs choose_partitioned_path's
    path for the regime ``ops`` passes: shared for a filter in L2 cut into
    small segments, global for larger segments and past L2."""
    spec = V.FilterSpec("sbf", 1 << 24, 8, block_bits=256)     # 2 MiB
    keys = _keys(50000, 6, cuda)
    want = sbf.add_plain(spec, V.init(spec, cuda), keys)
    smem = sbf.partition_smem_bytes(cuda)
    seen = set()
    for l2 in (True, False):
        if not l2:
            monkeypatch.setattr(ops, "L2_FILTER_BYTES", 1 << 20)
        for n_seg in (8, 16, 64, 128):
            seg_words = spec.n_words // n_seg
            path = sbf.choose_partitioned_path(n_seg, seg_words, 4096, smem,
                                               l2)
            assert path == ("shared" if l2 and seg_words * 4 <= (
                sbf.SHARED_MAX_SEGMENT_BYTES) else "global")
            seen.add(path)
            got = ops.bloom_add_partitioned(spec, V.init(spec, cuda), keys,
                                            n_segments=n_seg)
            torch.cuda.synchronize()
            plan = sbf.LAST_PARTITIONED_PLAN
            assert plan["path"] == path
            assert plan["ctas"] == (n_seg if path == "shared"
                                    else -(-n_seg * plan["capacity"]
                                           // sbf.THREADS))
            assert torch.equal(got, want)
    assert seen == set(sbf.PARTITIONED_PATHS)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("n_segments", [1, 8, 64])
def test_partitioned_counting_kernel_matches_plain(cuda, spec, n_segments,
                                                   monkeypatch):
    big = V.FilterSpec("countingbf", 1 << 20, spec.k,
                       block_bits=spec.block_bits)
    batch = _multiset(20000, n_segments, cuda)
    gone = torch.cat([batch[: batch.shape[0] // 2], _probes(100, 3, cuda)])
    want = cnt.update_plain(big, V.init(big, cuda), batch, None, "add")
    want_rm = cnt.update_plain(big, want, gone, None, "remove")
    # 512 KiB of counters: one segment does not fit, 8 and 64 do
    assert sbf.segment_fits(big.storage_words // n_segments,
                            cuda) == (n_segments > 1)
    for path in ("auto", "global"):
        if path == "global":
            _global_atomics(monkeypatch)
        for cap in (None, 64):
            got = ops.counting_update_partitioned(
                big, V.init(big, cuda), batch, "add", n_segments=n_segments,
                capacity=cap)
            np.testing.assert_array_equal(_u32(got), _u32(want))
            got = ops.counting_update_partitioned(
                big, got, gone, "remove", n_segments=n_segments,
                capacity=cap)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(got), _u32(want_rm))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CSPECS, ids=str)
@pytest.mark.parametrize("n_segments", [1, 8, 64, 256])
@pytest.mark.parametrize("path", cnt.PARTITIONED_PATHS)
def test_partitioned_counting_paths_match_plain(cuda, spec, n_segments,
                                                path):
    """Each path of the partitioned counting update forced, against the
    plain version: an add of a multiset (a key 21 times), a remove of half
    of it and of absent keys, an add of 40 keys on one row twice over, and
    a quarter of the slots invalid."""
    big = V.FilterSpec("countingbf", 1 << 20, spec.k,
                       block_bits=spec.block_bits)
    rows = cnt.grouped_rows(big.storage_words, n_segments,
                            big.counter_row_words)
    if path == "grouped" and rows > cnt.GROUPED_MAX_ROWS:
        pytest.skip("the grouped histogram holds at most 8192 rows")
    batch = _multiset(20000, n_segments + 7, cuda)
    cand = _keys(1 << 16, 9, cuda)
    blk = H.block_index(H.hash_keys(cand)[1], big.n_blocks)
    row = cand[blk == blk[0]][:40]
    for keys in (batch, torch.cat([row, row]).contiguous()):
        cap = 4 * keys.shape[0] // n_segments + 64
        part = P.partition_jit(big, keys, n_segments, cap)
        valid = part.valid * _valid_mask(part.valid.numel(), 3,
                                         cuda).reshape(part.valid.shape)
        gone = P.partition_jit(big, torch.cat([keys[: keys.shape[0] // 2],
                                               _probes(100, 4, cuda)]),
                               n_segments, cap)
        for v in (part.valid, valid):
            want = cnt.update_partitioned_plain(big, V.init(big, cuda),
                                                part.keys_by_seg, v, "add")
            got = cnt.update_partitioned(big, V.init(big, cuda),
                                         part.keys_by_seg, v, n_segments,
                                         "add", path=path)
            assert cnt.LAST_PARTITIONED_PLAN["path"] == path
            np.testing.assert_array_equal(_u32(got), _u32(want))
            want = cnt.update_partitioned_plain(big, want, gone.keys_by_seg,
                                                gone.valid, "remove")
            got = cnt.update_partitioned(big, got, gone.keys_by_seg,
                                         gone.valid, n_segments, "remove",
                                         path=path)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(_u32(got), _u32(want))


@pytest.mark.gpu
def test_partitioned_counting_takes_the_rule_path(cuda):
    """With no path given, the wrapper runs choose_partitioned_path's path
    with the card's shared memory: grouped from GROUPED_MIN_SEGMENTS up
    where the rows fit, global at JAX's default n_segments = 8."""
    spec = V.FilterSpec("countingbf", 1 << 22, 8, block_bits=256)
    keys = _keys(50000, 5, cuda)
    smem = sbf.partition_smem_bytes(cuda)
    for n_seg, path in ((8, "global"), (cnt.GROUPED_MIN_SEGMENTS, "grouped"),
                        (1024, "grouped")):
        assert cnt.choose_partitioned_path(n_seg, spec.storage_words,
                                           spec.counter_row_words,
                                           smem) == path
        got = ops.counting_update_partitioned(spec, V.init(spec, cuda), keys,
                                              "add", n_segments=n_seg)
        torch.cuda.synchronize()
        assert cnt.LAST_PARTITIONED_PLAN["path"] == path
        assert torch.equal(got, cnt.update_plain(spec, V.init(spec, cuda),
                                                 keys, None, "add"))


@pytest.mark.gpu
def test_partitioned_launch_counts_and_refusals(cuda):
    spec = PSPECS[0]
    keys = _keys(5000, 1, cuda)
    sbf.reset_launches()
    ops.bloom_add_partitioned(spec, V.init(spec, cuda), keys, capacity=8)
    assert sbf.LAUNCHES["add_partitioned"] == 1
    assert sbf.LAUNCHES["add_vmem"] == 1          # the residual pass
    part = P.partition_jit(spec, keys, 8, 2048)
    with pytest.raises(ValueError, match="divide"):
        sbf.add_partitioned(spec, V.init(spec, cuda), part.keys_by_seg,
                            part.valid, 7)
    big = V.FilterSpec("sbf", 1 << 24, 8)           # one 2 MiB segment
    assert not sbf.segment_fits(big.n_words, cuda)
    assert sbf.segment_fits(big.n_words // 16, cuda)
    with pytest.raises(ValueError, match="valid"):
        sbf.add_partitioned(spec, V.init(spec, cuda), part.keys_by_seg,
                            part.valid.cpu(), 8)


KSPECS = [V.FilterSpec("cuckoo", nb * spb * sb, 2, slot_bits=sb,
                       slots_per_bucket=spb)
          for sb, spb, nb in ((8, 4, 1 << 12), (16, 4, 1 << 12),
                              (16, 2, 1 << 13), (8, 8, 1 << 11),
                              (16, 8, 1 << 10), (16, 16, 1 << 9),
                              (8, 16, 1 << 9), (8, 4, 1))]


def _cuckoo_batch(spec, load, seed, device):
    """Keys to fill ``load`` of the slots, a few duplicated, and a valid
    mask with about a quarter zeros."""
    n = max(int(spec.n_slots * load), 1)
    keys = _keys(n, seed, device)
    keys = torch.cat([keys, keys[: n // 20]])
    return keys, _valid_mask(keys.shape[0], seed, device)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", KSPECS, ids=str)
@pytest.mark.parametrize("load", [0.5, 1.3])
def test_cuckoo_kernels_match_plain(cuda, spec, load):
    keys, valid = _cuckoo_batch(spec, load, int(load * 10), cuda)
    for vmask, tile in ((None, 256), (valid, 256), (valid, None)):
        t = tile or F.CUCKOO_ADD_TILE
        want, ok = ckoo.update_plain(spec, F.init(spec, cuda), keys, vmask,
                                     "add", t)
        got, got_ok = ckoo.add_vmem(spec, F.init(spec, cuda), keys, vmask,
                                    tile=t)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(got_ok.cpu().numpy(), ok.cpu().numpy())
        if load > 1 and vmask is None:
            assert not bool(ok.all())                 # kicks ran out
        queries = torch.cat([keys, _probes(4000, 5, cuda)])
        hit = ckoo.contains_plain(spec, want, queries).cpu().numpy()
        for coop in ("none", "subtile"):
            np.testing.assert_array_equal(
                ckoo.contains_vmem(spec, want, queries, coop=coop)
                .cpu().numpy(), hit)
        gone = torch.cat([keys[: keys.shape[0] // 2], _probes(50, 6, cuda)])
        want_rm, found = ckoo.update_plain(spec, want, gone, None, "remove",
                                           t)
        got_rm, got_found = ckoo.remove_vmem(spec, got, gone, None, tile=t)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got_rm), _u32(want_rm))
        np.testing.assert_array_equal(got_found.cpu().numpy(),
                                      found.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("spec", KSPECS, ids=str)
def test_cuckoo_contains_matches_plain_at_shares(cuda, spec):
    """The contains (both coop values) against the plain version at load
    0.9, with none, half or all of the keys members."""
    keys, _ = _cuckoo_batch(spec, 0.9, 21, cuda)
    table, _ = ckoo.add_vmem(spec, F.init(spec, cuda), keys, None)
    probes = _probes(3000, 22, cuda)
    for share in (0.0, 0.5, 1.0):
        m = int(share * keys.shape[0])
        queries = torch.cat([keys[:m], probes])
        want = ckoo.contains_plain(spec, table, queries).cpu().numpy()
        for coop in ckoo.COOPS:
            np.testing.assert_array_equal(ckoo.contains_vmem(
                spec, table, queries, coop).cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 7, 2048, 2049, 5000])
def test_cuckoo_ops_tiles_match_plain(cuda, n):
    spec = KSPECS[1]
    keys = _keys(n, n, cuda)
    for tile in (None, 256, 1000):
        eff = ops._cuckoo_tile(max(n, 1), tile)
        want, ok = ckoo.update_plain(spec, F.init(spec, cuda), keys, None,
                                     "add", eff)
        got, got_ok = ops.cuckoo_add(spec, F.init(spec, cuda), keys,
                                     tile=tile)
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(got_ok.cpu().numpy(), ok.cpu().numpy())
        np.testing.assert_array_equal(
            ops.cuckoo_contains(spec, got, keys).cpu().numpy(),
            ckoo.contains_plain(spec, want, keys).cpu().numpy())


@pytest.mark.gpu
def test_cuckoo_filter_path_and_launches(cuda):
    import repro_torch.api as api
    f = api.filter_for_n_items(20000, variant="cuckoo", bits_per_key=16)
    assert f.backend == "cuckoo" and f.device.type == "cuda"
    keys = _keys(20000, 2, cuda)
    ckoo.reset_launches()
    g = f.add(keys)
    assert int(g.insert_failures) == 0 and bool(g.contains(keys).all())
    h = g.remove(keys[:5000])
    assert bool(h.contains(keys[5000:]).all())
    assert ckoo.LAUNCHES == {"contains_vmem": 2, "add_vmem": 1,
                             "remove_vmem": 1}
    want, _ = ckoo.update_plain(f.spec, F.init(f.spec, cuda), keys, None,
                                "add")
    want, _ = ckoo.update_plain(f.spec, want, keys[:5000], None, "remove")
    np.testing.assert_array_equal(_u32(h.words), _u32(want))
    with pytest.raises(ValueError, match="jnp"):
        api.make_filter("cuckoo", m_bits=1 << 16, k=2, impl="jnp").add(keys)


def _cuckoo_windows(spec, table, keys, vmask, op, tile, step_cap=None):
    """The update at windows 1, 2, 32 and the default against the plain
    version's words and flags."""
    want, flags = ckoo.update_plain(spec, table, keys, vmask, op, tile)
    fn = ckoo.add_vmem if op == "add" else ckoo.remove_vmem
    for w in (1, 2, 32, ckoo.WINDOW):
        got, got_flags = fn(spec, table.clone(), keys, vmask, tile,
                            window=w, step_cap=step_cap)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(got_flags.cpu().numpy(),
                                      flags.cpu().numpy())
    return want, flags


@pytest.mark.gpu
@pytest.mark.parametrize("spec", KSPECS, ids=str)
def test_cuckoo_windows_match_plain(cuda, spec):
    """Every window, fresh to load 0.9 (masked), on past capacity, then a
    remove of half."""
    keys, valid = _cuckoo_batch(spec, 1.3, 13, cuda)
    cut = int(keys.shape[0] * 0.7)
    want, _ = _cuckoo_windows(spec, F.init(spec, cuda), keys[:cut],
                              valid[:cut], "add", 256)
    want, _ = _cuckoo_windows(spec, want, keys[cut:], None, "add", 2048)
    _cuckoo_windows(spec, want, keys[: keys.shape[0] // 2], None, "remove",
                    256)


def _pair_keys(spec, n, device):
    keys = _keys(1 << 20, 17, device)
    b1, fp, _ = F.cuckoo_hashes(spec, keys)
    alt = F.alt_bucket(spec, b1, fp)
    i = int(torch.nonzero(b1 != alt)[0])
    x, y = int(b1[i]), int(alt[i])
    out = keys[((b1 == x) & (alt == y)) | ((b1 == y) & (alt == x))][:n]
    assert out.shape[0] == n
    return out.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["copies", "pair", "tile1", "tile8",
                                  "tile2048", "tile8192", "cap1"])
def test_cuckoo_adversarial_batches_match_plain(cuda, case):
    spec = KSPECS[1]                                  # u16 x 4, 4096 buckets
    keys = _keys(int(spec.n_slots * 0.9), 19, cuda)
    tile, cap = 2048, None
    if case == "copies":                              # 512 copies of one key
        keys = torch.cat([keys[:3000], keys[9:10].expand(512, 2),
                          keys[3000:6000]]).contiguous()
    elif case == "pair":                              # one bucket pair
        spec = V.FilterSpec("cuckoo", 64 * 4 * 16, 2, slot_bits=16,
                            slots_per_bucket=4)
        keys = _pair_keys(spec, 64, cuda)
    elif case.startswith("tile"):
        tile = int(case[4:])
    else:
        cap = 1
    vmask = _valid_mask(keys.shape[0], 23, cuda) if tile in (8, 8192) \
        else None
    want, _ = _cuckoo_windows(spec, F.init(spec, cuda), keys, vmask, "add",
                              tile, cap)
    _cuckoo_windows(spec, want, keys[::2].contiguous(), None, "remove", tile,
                    cap)


@pytest.mark.gpu
@pytest.mark.parametrize("window, step_cap, tile", [
    (1, ckoo.STEP_CAP, 256), (2, 1, 256), (32, ckoo.STEP_CAP, 2048),
    (ckoo.WINDOW, ckoo.STEP_CAP, 256), (ckoo.WINDOW, 1, 2048)])
def test_cuckoo_counters_match_the_model(cuda, window, step_cap, tile):
    """The apply kernel's counters equal the CPU model's, round for round,
    for an add to load 0.95 and a remove."""
    spec = V.FilterSpec("cuckoo", 1024 * 4 * 16, 2, slot_bits=16,
                        slots_per_bucket=4)
    keys = _keys(int(spec.n_slots * 0.95), 29, cuda)
    table = F.init(spec, cuda)
    for op, k in (("add", keys), ("remove", keys[::3].contiguous())):
        want, flags, model = ckoo.update_windowed(
            spec, table.cpu(), k.cpu(), None, op, tile, window, step_cap)
        fn = ckoo.add_vmem if op == "add" else ckoo.remove_vmem
        table, got_flags = fn(spec, table, k, None, tile, window=window,
                              step_cap=step_cap)
        stats = ckoo.LAST_UPDATE_STATS[fn.__name__]
        assert (stats.n, stats.tile, stats.window, stats.step_cap) == (
            k.shape[0], tile, window, step_cap)
        assert stats.counters.device.type == "cuda"
        assert stats.read() == model
        np.testing.assert_array_equal(_u32(table), _u32(want))
        np.testing.assert_array_equal(got_flags.cpu().numpy(),
                                      flags.numpy())


@pytest.mark.gpu
def test_cuckoo_wrappers_refuse_bad_tensors(cuda):
    spec = KSPECS[0]
    table = F.init(spec, cuda)
    keys = _keys(64, 0, cuda)
    with pytest.raises(ValueError, match="aligned"):
        ckoo.contains_vmem(spec, table, keys.reshape(-1)[1:-1].reshape(-1, 2))
    with pytest.raises(ValueError, match="tile"):
        ckoo.add_vmem(spec, table, keys, None, tile=ckoo.MAX_TILE + 1)
    with pytest.raises(ValueError, match="window"):
        ckoo.add_vmem(spec, table, keys, None, window=ckoo.WINDOW + 1)
    with pytest.raises(ValueError, match="step_cap"):
        ckoo.remove_vmem(spec, table, keys, None, step_cap=0)
    with pytest.raises(ValueError, match="valid"):
        ckoo.add_vmem(spec, table, keys, _valid_mask(64, 0, cuda).cpu())
    wide = V.FilterSpec("cuckoo", 1 << 16, 2, slot_bits=8,
                        slots_per_bucket=32)
    with pytest.raises(ValueError, match="serve"):
        ckoo.contains_vmem(wide, F.init(wide, cuda), keys)


QSPECS = [V.FilterSpec("quotient", (1 << q) * sb, 1, slot_bits=sb, r_bits=r)
          for sb, r, q in ((8, 5, 12), (8, 2, 11), (16, 9, 11),
                           (16, 13, 10), (32, 20, 10), (32, 27, 4))]


def _quotient_batch(spec, load, seed, device):
    """Keys to fill ``load`` of the slots, some two and three times, and a
    valid mask with about a quarter zeros."""
    n = max(int(spec.n_slots * load), 1)
    keys = _keys(n, seed, device)
    keys = torch.cat([keys, keys[: n // 20], keys[:3]])
    return keys, _valid_mask(keys.shape[0], seed, device)


def _quotient_matches_plain(spec, table, keys, valid, gone, probes):
    """Add, contains (both coop values) and remove against the plain
    versions, words and flags bit for bit; returns the table after the
    add."""
    for tile in (256, 2048, None):
        want, ok = qf.update_plain(spec, table, keys, valid, "add", tile)
        got, got_ok = qf.add_vmem(spec, table.clone(), keys, valid, tile=tile)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(got_ok.cpu().numpy(), ok.cpu().numpy())
    queries = torch.cat([keys, probes])
    hit = qf.contains_plain(spec, want, queries).cpu().numpy()
    for coop in ("none", "subtile"):
        np.testing.assert_array_equal(
            qf.contains_vmem(spec, want, queries, coop=coop).cpu().numpy(),
            hit)
    for path in qf.CONTAINS_PATHS:                   # every contains path
        np.testing.assert_array_equal(
            qf._launch_contains(spec, want, queries, path).cpu().numpy(),
            hit)
    want_rm, found = qf.update_plain(spec, want, gone, None, "remove")
    got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone, None)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_u32(got_rm), _u32(want_rm))
    np.testing.assert_array_equal(got_found.cpu().numpy(),
                                  found.cpu().numpy())
    return want, ok


@pytest.mark.gpu
@pytest.mark.parametrize("spec", QSPECS, ids=str)
@pytest.mark.parametrize("load", [0.5, 0.9, 1.3])
def test_quotient_kernels_match_plain(cuda, spec, load):
    keys, valid = _quotient_batch(spec, load, int(load * 10), cuda)
    gone = torch.cat([keys[: keys.shape[0] // 2], keys[:30], keys[:30],
                      _probes(50, 6, cuda)])
    probes = _probes(4000, 5, cuda)
    for vmask in (None, valid):
        table, ok = _quotient_matches_plain(spec, Q.init(spec, cuda), keys,
                                            vmask, gone, probes)
        if load > 1 and vmask is None:
            assert not bool(ok.all())                 # past capacity
            assert int(Q.occupied_slots(spec, table)) == spec.n_slots - 1
    # a second batch into the filled table (the old runs are decoded)
    more = _keys(spec.n_slots // 4, 7, cuda)
    _quotient_matches_plain(spec, table, more, None, more[::2].contiguous(),
                            probes)


# lowered bins, windows and caps of the binned quotient contains
QLOW = (dict(bin_bits=0, window=4, cap=97), dict(bin_bits=3, window=4,
                                                  cap=1000),
        dict(bin_bits=5))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", QSPECS, ids=str)
@pytest.mark.parametrize("load", [0.5, 0.9, 0.95, 1.3])
def test_quotient_contains_paths_match_plain(cuda, spec, load):
    """Both contains paths (the walk, binned) at the card's bins, binned at
    a quotient a bin, 8 and 32 quotients a bin with 4-word windows and
    small caps, and the rule's path at the sampled load, against the plain
    version; load 1.3 leaves one empty slot. The sampled load is kept
    until an update changes the table."""
    keys, _ = _quotient_batch(spec, load, 23, cuda)
    table, _ = qf.add_vmem(spec, Q.init(spec, cuda), keys, None)
    queries = torch.cat([keys, _probes(3000, 24, cuda)])
    want = qf.contains_plain(spec, table, queries).cpu().numpy()
    for path in qf.CONTAINS_PATHS:
        np.testing.assert_array_equal(
            qf._launch_contains(spec, table, queries, path).cpu().numpy(),
            want)
        assert qf.LAST_CONTAINS_PLAN["path"] == path
    smem = sbf.partition_smem_bytes(cuda)
    for kw in QLOW:
        ww = kw.get("window", qf.contains_window_words(spec, kw["bin_bits"]))
        if not qf.binned_fits(spec, kw["bin_bits"], ww, smem):
            continue
        np.testing.assert_array_equal(qf._launch_contains(
            spec, table, queries, "binned", **kw).cpu().numpy(), want)
    stored = int(Q.occupied_slots(spec, table))
    sampled = qf.table_load(spec, table)
    if spec.n_slots <= qf.LOAD_SAMPLE_SLOTS:          # sampled in full
        assert sampled == stored / spec.n_slots
    many = queries.repeat(-(-qf.LOAD_MIN_KEYS // queries.shape[0]), 1)
    np.testing.assert_array_equal(qf.contains_vmem(
        spec, table, many).cpu().numpy(), np.tile(want, many.shape[0]
                                                  // queries.shape[0]))
    assert qf.LAST_CONTAINS_PLAN["load"] == sampled
    assert qf.LAST_CONTAINS_PLAN["path"] == qf.contains_mode(
        spec, many.shape[0], sampled, smem)
    qf.remove_vmem(spec, table, keys[:1], None)
    assert table._quotient_rule[0] != table._version


@pytest.mark.gpu
@pytest.mark.parametrize("spec", QSPECS[:3], ids=str)
def test_quotient_wrapping_clusters_match_plain(cuda, spec):
    cand = _keys(spec.n_slots * 16, 8, cuda)
    q = Q.split_fp(spec, Q.quotient_hashes(spec, cand))[0]
    keys = cand[q >= spec.n_slots * 7 // 8][: spec.n_slots // 4]
    table, _ = _quotient_matches_plain(spec, Q.init(spec, cuda), keys, None,
                                       keys[::3].contiguous(),
                                       _probes(1000, 9, cuda))
    lanes = Q.unpack_slots(spec, table)
    assert int(lanes[0]) >> (spec.slot_bits - 3) & 1   # slot 0 is shifted


@pytest.mark.gpu
def test_quotient_empty_full_and_large_tables(cuda):
    spec = QSPECS[1]
    empty = Q.init(spec, cuda)
    keys = _keys(spec.n_slots, 10, cuda)
    got, ok = qf.add_vmem(spec, empty.clone(), keys, None)
    assert ok.cpu().tolist() == [True] * (spec.n_slots - 1) + [False]
    want, _ = qf.update_plain(spec, empty, keys, None, "add")
    assert torch.equal(got, want)
    gone, found = qf.remove_vmem(spec, got.clone(), keys[:-1], None)
    assert bool(found.all()) and not bool(gone.any())
    _, found = qf.remove_vmem(spec, empty.clone(), keys, None)
    assert not bool(found.any())
    # 2^25 slots: 8192 table tiles, 2048-4096 bins, thousands of merge tiles
    big = V.FilterSpec("quotient", (1 << 25) * 8, 1, slot_bits=8, r_bits=5)
    table = Q.init(big, cuda)
    for seed, n in ((11, 1 << 24), (12, 1 << 23)):
        keys = _keys(n, seed, cuda)
        want, ok = qf.update_plain(big, table, keys, None, "add")
        got, got_ok = qf.add_vmem(big, table.clone(), keys, None)
        assert torch.equal(got, want) and torch.equal(got_ok, ok)
        table = want
    probes = torch.cat([keys, _probes(1 << 20, 13, cuda)])
    assert torch.equal(qf.contains_vmem(big, table, probes),
                       qf.contains_plain(big, table, probes))
    gone = keys[::2].contiguous()
    want, found = qf.update_plain(big, table, gone, None, "remove")
    got, got_found = qf.remove_vmem(big, table.clone(), gone, None)
    assert torch.equal(got, want) and torch.equal(got_found, found)


def _longest_cluster(spec, table) -> int:
    in_use = Q._fields(spec, Q.unpack_slots(spec, table))[3].cpu().numpy()
    run = best = 0
    for u in np.concatenate([in_use, in_use]):        # clusters may wrap
        run = run + 1 if u else 0
        best = max(best, run)
    return min(best, spec.n_slots)


QKNOBS = [dict(tile_slots=32, merge_tile=7, bin_bits=3, bin_cap=5,
               key_chunks=3),
          dict(tile_slots=64, merge_tile=1, bin_bits=0, bin_cap=1,
               key_chunks=1),
          dict(tile_slots=4096, merge_tile=4096, bin_bits=9)]


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", QKNOBS, ids=["t32", "t64-m1", "b9"])
@pytest.mark.parametrize("spec", QSPECS, ids=str)
def test_quotient_stream_knobs_match_plain(cuda, spec, knobs):
    """The update's schedule at lowered tiles and bins (clusters longer
    than a tile, bins sorted in device memory past a cap of 5 or 1 keys):
    add, remove, merge and resize equal to the plain versions."""
    keys, valid = _quotient_batch(spec, 0.9, 21, cuda)
    for vmask in (None, valid):
        want, ok = qf.update_plain(spec, Q.init(spec, cuda), keys, vmask,
                                   "add")
        got, got_ok = qf.add_vmem(spec, Q.init(spec, cuda), keys, vmask,
                                  **knobs)
        assert torch.equal(got, want) and torch.equal(got_ok, ok)
    if knobs["tile_slots"] == 32 and spec.n_slots >= 1 << 10:
        assert _longest_cluster(spec, want) > knobs["tile_slots"]
    gone = torch.cat([keys[::2], keys[:40], _probes(30, 22, cuda)])
    gmask = _valid_mask(gone.shape[0], 26, cuda)
    want_rm, found = qf.update_plain(spec, want, gone, gmask, "remove")
    got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone, gmask,
                                       **knobs)
    assert torch.equal(got_rm, want_rm) and torch.equal(got_found, found)
    tk = {k: v for k, v in knobs.items() if k in ("tile_slots", "merge_tile")}
    fit = keys[: spec.n_slots - 1]           # the union fits the capacity
    half = fit.shape[0] // 3
    a, _ = qf.update_plain(spec, Q.init(spec, cuda), fit[:half], None, "add")
    b, _ = qf.update_plain(spec, Q.init(spec, cuda), fit[half:], None, "add")
    assert torch.equal(qf.merge_vmem(spec, a, b, **tk),
                       qf.merge_plain(spec, a, b))
    if spec.r_bits > 1:
        grown = Q.spec_for_resize(spec, 2 * spec.m_bits)
        up = qf.resize_vmem(spec, want, grown, **tk)
        assert torch.equal(up, qf.resize_plain(spec, want, grown))
        assert torch.equal(qf.resize_vmem(grown, up, spec, **tk), want)


@pytest.mark.gpu
def test_quotient_key_past_the_bin_cap_and_passes(cuda, monkeypatch):
    """A key 20,000 times (its bin past the shared-memory cap: the sort in
    device memory; one run of 20,000 slots), added, 15,000 and 25,000 of
    it removed; an add in
    several passes of the pipeline; the workspace the plan names."""
    spec = V.FilterSpec("quotient", (1 << 15) * 16, 1, slot_bits=16,
                        r_bits=9)
    one = _keys(1, 23, cuda).repeat(20000, 1)
    keys = torch.cat([one, _keys(2000, 24, cuda)])
    keys = keys[torch.from_numpy(np.random.RandomState(25).permutation(
        keys.shape[0])).to(cuda)]
    want, ok = qf.update_plain(spec, Q.init(spec, cuda), keys, None, "add")
    got, got_ok = qf.add_vmem(spec, Q.init(spec, cuda), keys, None)
    assert torch.equal(got, want) and torch.equal(got_ok, ok)
    assert _longest_cluster(spec, got) >= 20000
    more = _keys(1, 23, cuda).repeat(25000, 1)     # more than are stored
    for gone in (one[:15000].contiguous(), more):
        want_rm, found = qf.update_plain(spec, want, gone, None, "remove")
        got_rm, got_found = qf.remove_vmem(spec, want.clone(), gone, None)
        assert torch.equal(got_rm, want_rm) and torch.equal(got_found, found)
    monkeypatch.setattr(qf, "KEY_BATCH", 700)
    got, got_ok = qf.add_vmem(spec, Q.init(spec, cuda), keys[:2500], None)
    want, ok = qf.update_plain(spec, Q.init(spec, cuda), keys[:2500], None,
                               "add")
    assert torch.equal(got, want) and torch.equal(got_ok, ok)
    assert qf.LAST_PLAN["passes"] == 4
    monkeypatch.undo()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()           # fresh blocks: counted as requested
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    table = Q.init(spec, cuda)
    flags = qf.add_vmem(spec, table, keys, None)[1]
    torch.cuda.synchronize()
    used = torch.cuda.max_memory_allocated() - before
    plan = qf.update_plan(spec, keys.shape[0], "add")
    assert qf.LAST_PLAN == plan
    assert used <= table.numel() * 4 + plan["workspace_bytes"] + \
        flags.numel() + 1024


@pytest.mark.gpu
@pytest.mark.parametrize("spec", QSPECS, ids=str)
def test_quotient_merge_and_resize_kernels_match_plain(cuda, spec):
    keys = _keys(int(spec.n_slots * 0.8), 15, cuda)
    half = keys.shape[0] // 3
    a, _ = qf.update_plain(spec, Q.init(spec, cuda), keys[:half], None, "add")
    b, _ = qf.update_plain(spec, Q.init(spec, cuda), keys[half:], None, "add")
    got = qf.merge_vmem(spec, a, b)
    assert torch.equal(got, qf.merge_plain(spec, a, b))
    assert torch.equal(got, qf.merge_vmem(spec, b, a))
    assert torch.equal(qf.merge_vmem(spec, a, Q.init(spec, cuda)), a)
    for factor in (2, 4, 0.5):
        m = int(spec.m_bits * factor)
        try:
            new_spec = Q.spec_for_resize(spec, m)
        except ValueError:
            continue
        if new_spec.n_slots - 1 < int(Q.occupied_slots(spec, got)):
            continue
        want = qf.resize_plain(spec, got, new_spec)
        assert torch.equal(qf.resize_vmem(spec, got, new_spec), want)


@pytest.mark.gpu
def test_quotient_filter_path_launches_merge_and_resize(cuda):
    import repro_torch.api as api
    f = api.filter_for_n_items(20000, variant="quotient")
    assert f.backend == "quotient" and f.device.type == "cuda"
    keys = _keys(20000, 14, cuda)
    qf.reset_launches()
    g = f.add(keys)
    assert int(g.insert_failures) == 0 and bool(g.contains(keys).all())
    h = g.remove(keys[:5000])
    assert bool(h.contains(keys[5000:]).all())
    assert qf.LAUNCHES == {"contains_vmem": 2, "add_vmem": 1,
                           "remove_vmem": 1, "merge_vmem": 0,
                           "resize_vmem": 0}
    want, _ = qf.update_plain(f.spec, Q.init(f.spec, cuda), keys, None, "add")
    want, _ = qf.update_plain(f.spec, want, keys[:5000], None, "remove")
    np.testing.assert_array_equal(_u32(h.words), _u32(want))
    merged = f.add(keys[:9000]).merge(f.add(keys[9000:]))
    assert torch.equal(merged.words, g.words)
    assert qf.LAUNCHES["merge_vmem"] == 1
    grown = g.resize(2 * f.spec.m_bits)
    assert qf.LAUNCHES["resize_vmem"] == 1
    assert grown.device.type == "cuda" and bool(grown.contains(keys).all())
    rebuilt = api.make_filter("quotient", m_bits=grown.spec.m_bits,
                              slot_bits=grown.spec.slot_bits,
                              r_bits=grown.spec.r_bits).add(keys)
    assert torch.equal(grown.words, rebuilt.words)
    assert torch.equal(grown.resize(f.spec.m_bits).words, g.words)
    with pytest.raises(ValueError, match="jnp"):
        api.make_filter("quotient", m_bits=1 << 16, slot_bits=8, r_bits=5,
                        impl="jnp").add(keys)


@pytest.mark.gpu
def test_quotient_wrappers_refuse_bad_tensors(cuda):
    spec = QSPECS[0]
    table = Q.init(spec, cuda)
    keys = _keys(64, 0, cuda)
    with pytest.raises(ValueError, match="aligned"):
        qf.contains_vmem(spec, table, keys.reshape(-1)[1:-1].reshape(-1, 2))
    with pytest.raises(ValueError, match="valid"):
        qf.add_vmem(spec, table, keys, _valid_mask(64, 0, cuda).cpu())
    huge = V.FilterSpec("quotient", (1 << 30) * 8, 1, slot_bits=8, r_bits=1)
    assert not qf.kernel_supported(huge)
    with pytest.raises(ValueError, match="serve"):
        qf.contains_vmem(huge, torch.zeros(huge.n_words, dtype=torch.int32,
                                           device=cuda), keys)


# ---------------------------------------------------------------------------
# The calibration kernels and a measured calibration
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 16, 1000])
def test_calibrate_step_matches_plain(cuda, g):
    gen = torch.Generator(device=cuda).manual_seed(g)
    x = torch.randint(-(1 << 31), 1 << 31, (8 * g, 128), dtype=torch.int32,
                      device=cuda, generator=gen)
    x[0, :2] = torch.tensor([-1, 0x7FFFFFFF], dtype=torch.int32)
    before = kc.LAUNCHES["step"]
    out = kc.step(x, torch.empty_like(x))
    assert kc.LAUNCHES["step"] == before + 1
    np.testing.assert_array_equal(_u32(out), _u32(kc.step_plain(x)))


@pytest.mark.gpu
@pytest.mark.parametrize("n,iters", [(1, 16), (257, 512), (70000, 64)])
def test_calibrate_chain_matches_plain(cuda, n, iters):
    out = kc.chain(torch.empty((n,), dtype=torch.int32, device=cuda), iters)
    np.testing.assert_array_equal(_u32(out),
                                  _u32(kc.chain_plain(n, iters, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("words,n,per", [(1, 1, 1), (1024, 1000, 3),
                                         (1 << 20, 70000, 17)])
def test_calibrate_gather_matches_plain(cuda, words, n, per):
    table = kc.gather_table(words, cuda)
    out = kc.gather(table, torch.empty((n,), dtype=torch.int32, device=cuda),
                    per)
    np.testing.assert_array_equal(_u32(out),
                                  _u32(kc.gather_plain(table, n, per)))


@pytest.mark.gpu
def test_calibrate_wrappers_refuse_bad_args(cuda):
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kc.step(x, torch.empty((8, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        kc.step(x[:, :64], torch.empty_like(x[:, :64]))
    with pytest.raises(ValueError):
        kc.chain(torch.empty((4,), dtype=torch.int32, device=cuda), 10)
    with pytest.raises(ValueError):
        kc.gather(torch.zeros((3,), dtype=torch.int32, device=cuda),
                  torch.empty((4,), dtype=torch.int32, device=cuda), 1)
    assert kc.blocks_per_sm("step", cuda) >= 1 and kc.sm_count(cuda) >= 1


@pytest.mark.gpu
def test_measured_calibration_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    for name, probe in PC.PROBES.items():
        v = probe(device=cuda)
        assert np.isfinite(v) and v > 0, (name, v)
    calib = PC.get_calibration(measure=True, device=cuda)
    assert calib.measured
    assert calib.backend == "cuda:" + torch.cuda.get_device_name(cuda)
    for name in PC.PROBES:
        v = getattr(calib, name)
        assert np.isfinite(v) and v > 0, (name, v)
    assert PC.get_calibration(device=cuda) == calib        # from the cache
    assert PC.get_calibration(device="cpu").backend == "cpu"


# ---------------------------------------------------------------------------
# The filter service on the card
# ---------------------------------------------------------------------------

SERVICE_BANKS = {
    "sbf-l2": lambda d: api.filter_for_n_items(1 << 12, bank=8, device=d),
    "sbf-dram": lambda d: api.make_filter_bank(
        8, m_bits=1 << 16, backend="cuda-dram", device=d)
    if d != "cpu" else api.make_filter_bank(8, m_bits=1 << 16, device=d),
    "countingbf": lambda d: api.filter_for_n_items(
        1 << 12, variant="countingbf", bank=8, device=d),
    "windowed": lambda d: api.filter_for_n_items(1 << 12, generations=3,
                                                 bank=8, device=d),
    "cuckoo": lambda d: api.make_filter_bank(8, variant="cuckoo",
                                             m_bits=1 << 13, device=d),
    "quotient": lambda d: api.filter_for_n_items(300, variant="quotient",
                                                 bank=8, device=d),
}


def _service_run(make, device, remove: bool):
    """A short seeded stream through a service on ``device``: every
    flush's words (host copies) and results, the seq ids and shed counts."""
    from repro_torch import service as S
    clock = {"t": 0.0}
    svc = S.FilterService(make(device), S.ServiceConfig(
        max_batch=512, flush_deadline=2.0,
        admission=S.AdmissionPolicy(health_every=2)),
        clock=lambda: clock["t"])
    log = []
    inner = svc._flush_op

    def flush(op, trigger):
        inner(op, trigger)
        log.append(svc.take_results() if op == "contains"
                   else svc.filt.words.cpu())
    svc._flush_op = flush
    rng = np.random.RandomState(77)
    seqs = []
    for step in range(6):
        clock["t"] = float(step)
        keys = H.random_u64x2(700, seed=700 + step)
        ten = rng.randint(0, 8, 700)
        seqs.append(svc.submit_many("add", keys, ten))
        if remove and step:
            seqs.append(svc.submit_many("remove", keys[:200], ten[:200]))
        seqs.append(svc.submit_many("contains", np.concatenate(
            [keys[:300], H.probe_u64x2(300, seed=step)]), ten[:600]))
        svc.pump()
    svc.drain()
    return log, np.concatenate(seqs), svc.admission.shed_by_tenant, svc


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SERVICE_BANKS))
def test_service_flushes_match_the_plain_versions(cuda, name):
    """Every flush of a service on a card bank (routed, valid-masked bank
    calls) against the same stream on the CPU (the plain versions): words
    bit for bit, results, seq ids and shed counts."""
    make = SERVICE_BANKS[name]
    remove = name in ("countingbf", "cuckoo", "quotient")
    card = _service_run(make, cuda, remove)
    plain = _service_run(make, "cpu", remove)
    assert card[3].filt.device.type == "cuda"
    assert len(card[0]) == len(plain[0])
    for a, b in zip(card[0], plain[0]):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(_u32(a), _u32(b))
    np.testing.assert_array_equal(card[1], plain[1])
    np.testing.assert_array_equal(card[2], plain[2])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["sbf", "cbf", "countingbf"])
def test_member_fill_on_the_card_matches_numpy(cuda, variant):
    from repro_torch import service as S
    kw = {"k": 5} if variant == "cbf" else {}
    bank = api.make_filter_bank(5, variant=variant, m_bits=1 << 17,
                                device=cuda, **kw)
    keys = _keys(40000, 3, cuda)
    member = torch.randint(0, 5, (40000,), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(3))
    bank = bank.add(keys, tenants=member)
    dense = bank.dense_words().cpu().numpy().view(np.uint32)
    want = np.unpackbits(dense.reshape(5, -1).view(np.uint8),
                         axis=-1).mean(axis=-1)
    got = S.member_fill(bank)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_service_recovery_drill_on_the_card(cuda, tmp_path):
    """ServiceDriver with a SimulatedFailure midway: restored on the card
    from the flush-barrier checkpoint and replayed, it ends with the clean
    run's words, results and deterministic counters."""
    from repro_torch import service as S
    from repro_torch.runtime.fault_tolerance import SimulatedFailure

    def stream_fn(step):
        rng = np.random.RandomState(900 + step)
        return [(op, rng.randint(0, 2 ** 31, (300, 2)).astype(np.uint32),
                 rng.randint(0, 4, 300)) for op in ("add", "contains")]

    out = []
    for fail_at in (None, 5):
        bank = api.make_filter_bank(4, variant="cuckoo", m_bits=1 << 12,
                                    device=cuda)
        svc = S.FilterService(bank, S.ServiceConfig(max_batch=256,
                                                    flush_deadline=2.5))
        maint = S.MaintenanceLoop(S.MaintenanceConfig(
            checkpoint_every=3, ckpt_dir=str(tmp_path / str(fail_at))))
        fired = []

        def hook(step, fail_at=fail_at, fired=fired):
            if fail_at is not None and step == fail_at and not fired:
                fired.append(step)
                raise SimulatedFailure("injected")

        drv = S.ServiceDriver(svc, stream_fn, maint,
                              S.ServiceDriverConfig(virtual_dt=1.0),
                              failure_hook=hook)
        results = {}
        feed = drv._feed

        def fed(step, feed=feed, svc=svc, results=results):
            feed(step)
            results.update(svc.take_results())
        drv._feed = fed
        final = drv.run(9)
        results.update(drv.service.take_results())
        out.append((final, results, drv))
    (a, ra, da), (b, rb, db) = out
    assert b.device.type == "cuda" and "restore" in [e["kind"]
                                                     for e in db.events]
    np.testing.assert_array_equal(_u32(a.words), _u32(b.words))
    assert torch.equal(a.state, b.state) and ra == rb
    assert (da.service.telemetry.registry.snapshot_state(
        deterministic_only=True)
        == db.service.telemetry.registry.snapshot_state(
            deterministic_only=True))
