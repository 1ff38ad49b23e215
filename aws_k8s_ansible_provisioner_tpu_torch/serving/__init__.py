"""Paged KV cache, step programs, engine and HTTP server of the PyTorch port."""
