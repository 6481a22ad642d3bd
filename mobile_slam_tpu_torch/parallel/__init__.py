"""Multi-sequence fleets (parallel/batch.py: one card, or SPMD over the ranks
of a process group through its ``RankMesh``), the rank launcher
(parallel/launch.py), the multi-rank dry run (parallel/dryrun.py) and the
landmark-sharded solve step (parallel/tp_solver.py)."""
