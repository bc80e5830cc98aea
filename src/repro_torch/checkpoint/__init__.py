"""``repro_torch.checkpoint`` — the train state's checkpointer."""
