"""GGUF file format: constants, reader and writer (numpy only)."""
