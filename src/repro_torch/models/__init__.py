"""``repro_torch.models`` — the decoder-only transformer stack (counterpart
of ``repro.models``; dense ``attn`` / ``local_attn`` families so far)."""
