"""The plain reference that decides ``correct``: the ground truth of the
benchmark's own simulator, and numpy to compare the program's outputs with
it. Imports nothing of the port (``mobile_slam_tpu_torch``) and nothing of
JAX; the harness's tests check that."""
