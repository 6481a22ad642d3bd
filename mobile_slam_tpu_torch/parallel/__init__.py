"""Multi-sequence fleets (parallel/batch.py)."""
