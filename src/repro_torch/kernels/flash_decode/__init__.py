"""Single-token attention over a KV cache, emitting (acc, m, l)
partials."""
