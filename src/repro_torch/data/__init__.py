"""``repro_torch.data`` — the dedup stages and the data pipeline
(counterpart of ``repro.data``)."""
