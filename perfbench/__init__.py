"""The benchmark of the PyTorch/CUDA port of RapidGNN (``repro_torch``).

One command runs one cell once (``python perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``) and prints one JSON
line. Everything that measures or judges the program lives here: the
dataset generator, the reference, the readers of the per-layer metrics
and the arithmetic of their operations and bytes. The program under
test is ``repro_torch`` alone; nothing here imports JAX or the JAX
package ``repro``.
"""
