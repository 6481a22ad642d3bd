"""Multi-sequence fleets (parallel/batch.py) and the landmark-sharded solve
step (parallel/tp_solver.py)."""
