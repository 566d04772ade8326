"""The reference the benchmark holds the program to, written from the
semantics of the robot's nodes in plain PyTorch and NumPy (the keys and
orchards, the perception's grids and rows, the cached rollout), and for
each driver the comparison that decides ``correct``
(``<driver>_check.py``). Nothing here imports the program or JAX."""
