"""Model configuration, loader and forward pass (llama family)."""
