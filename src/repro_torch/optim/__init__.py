"""``repro_torch.optim`` — the optimizer (AdamW) and the gradient
compressions of the port (``repro.optim``'s counterparts)."""
