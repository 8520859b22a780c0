"""Inference runtime: paged KV pool and context."""
