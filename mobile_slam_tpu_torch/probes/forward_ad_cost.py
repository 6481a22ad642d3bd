"""What one elementwise product costs under forward-mode AD, the mode the
solver's Jacobians use (``torch.func.jacfwd`` in solver/assembly.py).

    python -m mobile_slam_tpu_torch.probes.forward_ad_cost [--device cuda]

Times, per call of ``torch.func.jvp``, a product of two differentiated
inputs, a product of a constant and a differentiated input (the common case
in the residuals: a state or measurement times a perturbation) and the plain
product, each on a (64,) tensor, and counts the calls into PyTorch's Python
reference implementations (``torch._refs``) each one makes. A constant has
no tangent; the forward formula of ``mul`` then stands an efficient zero
tensor in for it, and the zero tensor's kernel takes its output's shape from
the op's Python meta function. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _per_call_us(fn, n: int, device: torch.device) -> float:
    for _ in range(10):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 1e6 * (time.perf_counter() - t0) / n


def _ref_calls(fn) -> int:
    """Calls into torch._refs' shape broadcasting (every Python reference
    elementwise op passes it) during one call of ``fn``."""
    import torch._refs as refs

    count, inner = [0], refs._broadcast_shapes

    def counted(*a, **k):
        count[0] += 1
        return inner(*a, **k)

    refs._broadcast_shapes = counted
    try:
        fn()
    finally:
        refs._broadcast_shapes = inner
    return count[0]


def run(device="cuda", n: int = 2000) -> dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: give --device cpu")
    a = torch.randn(64, dtype=torch.float32, device=device)
    b = torch.randn(64, dtype=torch.float32, device=device)
    t = torch.ones_like(a)
    cases = {
        "dual * dual": lambda: torch.func.jvp(lambda x, y: x * y, (a, b), (t, t)),
        "constant * dual": lambda: torch.func.jvp(lambda x: b * x, (a,), (t,)),
        "plain": lambda: a * b,
    }
    out = {name: dict(us_per_call=_per_call_us(fn, n, device), ref_calls=_ref_calls(fn))
           for name, fn in cases.items()}
    return dict(device=str(device), torch=torch.__version__, cases=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
