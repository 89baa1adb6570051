"""The benchmark's plain reference: the simulator's semantics in plain
PyTorch and NumPy, rebuilt from the cells' ``ExpSpec`` fields and seed.

Frozen copies of the port's plain path (topology, paths, scenarios,
traffic generation, both engines' steps with every decision as plain
torch ops, the merge of a grid's cells and FCT scoring), taken when the
benchmark was written and held apart from the program: nothing here
imports ``repro_torch``, ``repro`` or JAX, and nothing takes a tensor
the program made. The copies' docstrings keep their origin's wording
where they name the JAX reference's modules. ``SimConfig.sum_dtype``
sets the per-link sums' precision: float64 as the configurations
state, float32 for the control (``portbench/control.py``).
"""
