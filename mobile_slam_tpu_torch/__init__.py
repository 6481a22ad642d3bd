"""mobile_slam_tpu_torch — the PyTorch + CUDA port of mobile_slam_tpu.

The streaming image path (frame + IMU in, pose out) on one NVIDIA GPU:
KLT frontend with hand-written CUDA LK kernels (ops/lk.py,
csrc/lk_kernels.cu), IMU preintegration, sliding-window LM with a
square-root marginalization prior, and the synchronous VIOEngine loop.

The framework-free modules of the JAX package (config, solver.layout,
init.*, eval.evaluator) are imported from ``mobile_slam_tpu`` rather than
copied; nothing here imports JAX.
"""

__version__ = "0.1.0"
