"""Serving runtime of the port: requests, paged KV cache, scheduler,
sampler, model engine and the continuous-batching executor."""
