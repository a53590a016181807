"""``repro_torch.serving`` — the serve loop and the n-gram guard
(counterpart of ``repro.serving``)."""
