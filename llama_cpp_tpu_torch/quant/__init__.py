"""Host-side dequantization, repacking and quantization of ggml quant blocks (numpy only)."""
