"""The plain reference the benchmark judges the program against: the
partition, the deterministic schedule and hot sets, the residual-miss
rows of the exchange, and GraphSAGE training with AdamW, each worked
out again from the benchmark's own inputs and the seed. Plain numpy and
PyTorch; nothing of the program is imported here."""
