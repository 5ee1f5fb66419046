"""Serving: request scheduler, paged KV cache, padded and continuous
engines."""
