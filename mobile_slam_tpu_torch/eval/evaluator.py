"""Trajectory metrics (ATE/RPE): the JAX package's numpy evaluator, shared
unchanged by the port."""

from mobile_slam_tpu.eval.evaluator import compute_ate, compute_rpe  # noqa: F401
