"""Host-side dequantization and repacking of ggml quant blocks (numpy only)."""
