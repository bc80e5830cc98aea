"""``repro_torch.data`` — the synthetic training data of the port."""
