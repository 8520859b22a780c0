"""Utilities shared by the entry points: logging, device timing."""
