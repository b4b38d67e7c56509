"""Serving stack of the PyTorch port (paged, packed-prefill, greedy)."""
