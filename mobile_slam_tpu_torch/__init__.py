"""mobile_slam_tpu_torch — the PyTorch + CUDA port of mobile_slam_tpu.

The image path (frame + IMU in, pose out) on one NVIDIA GPU: KLT frontend
with hand-written CUDA LK kernels (ops/lk.py, csrc/lk_kernels.cu), IMU
preintegration, sliding-window LM with a square-root marginalization
prior, the synchronous VIOEngine loop, the chunked frame step
(engine/chunked.py) and the chunked image server with recovery
(engine/serving.py), plus the two measurement probes of the frame loop
(probes/, csrc/probe_kernels.cu), the flagship step unit (entry.py) and
the user tools (tools/).

The package imports torch and numpy only: the framework-free modules of
the JAX package (config, solver.layout, init.*, eval.evaluator) are copied
here, not imported. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
