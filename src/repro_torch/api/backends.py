"""Single-host engines: the plain PyTorch engine and the two CUDA regimes.

Counterpart of ``repro.api.backends`` (``jnp``, ``pallas-vmem``,
``pallas-hbm``). The device decides first: ``torch`` serves CPU devices
only, and the CUDA engines serve CUDA devices only, so a CUDA tensor never
reaches a plain version. The CUDA engines take the blocked variants with
``s <= 32`` words per block and decline ``cbf``, so ``"auto"`` never picks
an engine that would raise. Among the CUDA engines the L2-resident one wins
while the filter fits ``ops.L2_FILTER_BYTES``.
"""
from __future__ import annotations

from repro_torch.core import variants as V
from repro_torch.core.variants import FilterSpec
from repro_torch.api.registry import Backend, SelectionContext, register
from repro_torch.kernels import ops


class TorchBackend(Backend):
    """The plain PyTorch versions on the CPU: one row gather per lookup
    (``contains``) and the sorted segmented-OR bulk insert (``add_rows``).
    The semantic oracle of the port."""

    name = "torch"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return ctx.device.type == "cpu" and spec.variant in V.BLOCKED

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 1.0

    def init(self, spec, options, device):
        return V.init(spec, device)

    def add(self, spec, words, keys, options):
        return V.add_rows(spec, words, keys)

    def contains(self, spec, words, keys, options):
        return V.contains(spec, words, keys)


class _CudaBackend(Backend):
    regime = "auto"

    def _runs(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return ctx.device.type == "cuda" and ops.kernel_supported(spec)

    def init(self, spec, options, device):
        return V.init(spec, device)

    def _kw(self, options):
        kw = {"regime": self.regime, "probe": options.probe,
              "coop": options.coop, "mix": options.mix}
        if options.layout is not None:
            kw["layout"] = options.layout
        if options.tile is not None:
            kw["tile"] = options.tile
        return kw

    def add(self, spec, words, keys, options):
        return ops.bloom_add(spec, words, keys, inplace=False,
                             **self._kw(options))

    def contains(self, spec, words, keys, options):
        return ops.bloom_contains(spec, words, keys, depth=options.depth,
                                  **self._kw(options))


class CudaL2Backend(_CudaBackend):
    """CUDA kernels for a filter that fits the L2 cache (the paper's
    cache-resident regime; ``pallas-vmem``'s counterpart)."""

    name = "cuda-l2"
    regime = "vmem"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return self._runs(spec, ctx) and ops.fits_l2(spec)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        return 0.4


class CudaDramBackend(_CudaBackend):
    """CUDA kernels for a filter in device memory (the DRAM-resident
    regime; ``pallas-hbm``'s counterpart)."""

    name = "cuda-dram"
    regime = "hbm"

    def supports(self, spec: FilterSpec, ctx: SelectionContext) -> bool:
        return self._runs(spec, ctx)

    def cost(self, spec: FilterSpec, ctx: SelectionContext) -> float:
        # dispreferred while the filter still fits the L2
        return 1.2 if ops.fits_l2(spec) else 0.7


def register_all():
    register(TorchBackend())
    register(CudaL2Backend())
    register(CudaDramBackend())
