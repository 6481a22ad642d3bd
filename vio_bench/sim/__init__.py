"""The benchmark's traffic generator: a frozen copy of the port's synthetic
world (``eval/simulation.py``), its camera models and a torch renderer of
its frames, so that the yardstick does not move when the program's copy
does."""
