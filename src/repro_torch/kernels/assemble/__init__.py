"""Single-pass feature assembly: local shard > hot cache > pulled rows."""
