"""The flagship per-frame step unit and the multi-rank dry run (the port's
counterpart of the repo's ``__graft_entry__.py``).

``entry()`` returns ``(step, (state, inp))``: one feature-level tracking
step at ``tiny_config`` in float32. ``step(state, inp)`` runs IMU
preintegration, feature ingestion and the keyframe decision
(``bookkeeping_step``), then triangulation, the sliding-window LM solve,
the FEJ marginalization and the window slide (``solve_and_slide``), and
returns ``(state, p, q)``. The keyframe flag stays the () tensor that
``bookkeeping_step`` returns, so ``solve_and_slide`` computes both branches
and selects on the device, as the fleet does; the reference's flag is
traced under ``jax.jit`` the same way. ``dryrun_multichip`` is
``parallel/dryrun.py``'s.

    python -m mobile_slam_tpu_torch.entry

runs the step once on the card and prints its position, then
``dryrun_multichip(min(cards, 2))``. The step runs on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

import torch

from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine.example import make_example_state, tiny_config
from mobile_slam_tpu_torch.engine.vio_engine import require_device
from mobile_slam_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]


def entry(device="cuda", dtype=torch.float32):
    """(step, (state, inp)) of the tiny configuration on ``device``."""
    dev = require_device(device)
    cfg = tiny_config()
    params = est.make_params(cfg, dtype, device=dev)
    state, inp = make_example_state(cfg, params, dtype, device=dev)
    num_iterations = cfg.estimator.num_iterations

    def step(state, inp):
        state, is_kf = est.bookkeeping_step(state, inp, params)
        state, p, q, _ = est.solve_and_slide(state, is_kf, params, num_iterations)
        return state, p, q

    return step, (state, inp)


def main() -> None:
    step, (state, inp) = entry()
    _, p, _ = step(state, inp)
    torch.cuda.synchronize()
    print("entry OK:", p)
    dryrun_multichip(min(torch.cuda.device_count(), 2))


if __name__ == "__main__":
    main()
