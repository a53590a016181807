"""``repro_torch.launch`` — entry points (counterpart of ``repro.launch``;
``serve`` so far)."""
