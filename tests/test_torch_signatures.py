"""Every public function of the JAX package against its namesake in the port,
by parameter list: a call written for the reference binds the same way in
the port.

An ``ast`` walk of both source trees (nothing is imported). For each module
of ``mobile_slam_tpu/`` with public names, and for the repo's user tools
and entry points beside it, the port's counterpart file has every public
top-level function and every public method (``__init__`` included) of the
reference's public classes, and

- its positional parameters begin with the reference's, in order (extras
  may follow them or be keyword-only);
- every keyword-only parameter of the reference is a parameter of the port.

``DEPARTURES`` holds the recorded exceptions, each with the port's positional
parameters it fixes and the reason; a departure that no longer departs fails
too, so the list holds only live ones. ``DROPPED`` holds the reference's names
the port left out on purpose, each with the reason; a dropped name the port
has again fails.
"""

from __future__ import annotations

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "mobile_slam_tpu", "mobile_slam_tpu_torch"
# Files outside the reference package and their counterparts in the port.
EXTRA = {
    "__graft_entry__.py": "mobile_slam_tpu_torch/entry.py",
    "scripts/evaluation/compare_trajectories.py": "mobile_slam_tpu_torch/tools/compare_trajectories.py",
    "scripts/export_replay_dataset.py": "mobile_slam_tpu_torch/tools/export_replay_dataset.py",
    "scripts/make_synthetic_dataset.py": "mobile_slam_tpu_torch/io/synthetic.py",
}
_RANSAC = ("RANSAC's jax.random key: torch cannot reproduce its draws, so the port takes "
           "raw draws or a torch.Generator as keyword-only parameters")
_MESH = ("tp_solver's (mesh, axis) of a JAX device mesh: the port shards over the ranks "
         "of a torch.distributed process group (PR 8)")
# (port file, qualified name) -> (the port's positional parameters, reason)
DEPARTURES = {
    ("mobile_slam_tpu_torch/ops/ransac.py", "find_fundamental_ransac"):
        (["pts1", "pts2", "valid", "threshold"], _RANSAC),
    ("mobile_slam_tpu_torch/frontend/tracker.py", "detect_and_track"):
        (["state", "img", "ts", "camera", "cfg", "focal"], _RANSAC),
    ("mobile_slam_tpu_torch/parallel/tp_solver.py", "tp_damped_step"):
        (["x", "table", "pre", "imu_sqrt_info", "imu_valid", "prior", "prior_H0", "ex_t",
          "ex_q", "sp", "proj_valid", "lam_mask", "mu", "group"], _MESH),
    ("mobile_slam_tpu_torch/parallel/tp_solver.py", "shard_landmarks"):
        (["tree", "rank", "world"], _MESH),
}
_SPANS = "the program's spans (utils/logging.py: span, tracing, drain) time its stages"
# (port file, public name of the reference: a function, class or method) -> why
# the port has none
DROPPED = {
    ("mobile_slam_tpu_torch/utils/logging.py", "FrameProfiler"): _SPANS,
    ("mobile_slam_tpu_torch/engine/serving.py", "ChunkedImageServer.chunked_fps"): _SPANS,
}


def _dropped(port: str, name: str) -> bool:
    return any(p == port and (name == d or name.startswith(d + ".")) for p, d in DROPPED)


def _public(path: str) -> dict:
    """Qualified name -> ast.arguments of each public function and method;
    a name the port's module imports from another of its modules (a
    re-export) is looked up there."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PORT + "."):
            mod = node.module.replace(".", "/")
            source = _public(mod + ".py" if os.path.exists(os.path.join(REPO, mod + ".py"))
                             else os.path.join(mod, "__init__.py"))
            out.update({a.name: source[a.name] for a in node.names if a.name in source
                        and not (a.asname or a.name).startswith("_")})
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = node.args
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (not sub.name.startswith("_") or sub.name == "__init__")):
                    out[f"{node.name}.{sub.name}"] = sub.args
    return out


def _positional(args: ast.arguments) -> list[str]:
    return [a.arg for a in args.posonlyargs + args.args]


def _pairs() -> list[tuple[str, str]]:
    pairs = []
    for root, _, files in os.walk(os.path.join(REPO, REF)):
        for name in sorted(files):
            if name.endswith(".py"):
                ref = os.path.relpath(os.path.join(root, name), REPO)
                pairs.append((ref, PORT + ref[len(REF):]))
    return sorted(pairs) + sorted(EXTRA.items())


PAIRS = _pairs()


@pytest.mark.parametrize("ref,port", PAIRS, ids=[r for r, _ in PAIRS])
def test_public_parameters_match_reference(ref, port):
    want = _public(ref)
    if not want:
        return          # e.g. ops/lk_pallas.py: its kernels are private (ops/lk.py holds the port's)
    assert os.path.exists(os.path.join(REPO, port)), f"{ref} has no counterpart {port}"
    have = _public(port)
    faults = []
    for name, args in want.items():
        if _dropped(port, name):
            continue
        if name not in have:
            faults.append(f"{name}: missing")
            continue
        r, p = _positional(args), _positional(have[name])
        departure = DEPARTURES.get((port, name))
        if departure is not None:
            if p != departure[0]:
                faults.append(f"{name}: recorded departure {departure[0]}, found {p}")
        elif p[:len(r)] != r:
            faults.append(f"{name}: positional {p}, the reference's {r}")
        names = set(p) | {a.arg for a in have[name].kwonlyargs}
        lost = [a.arg for a in args.kwonlyargs if a.arg not in names]
        if lost:
            faults.append(f"{name}: keyword-only {lost} missing")
    assert not faults, f"{port}: " + "; ".join(faults)


def test_dropped_names_are_gone():
    """Each recorded drop names a public name of the reference that the
    port no longer has."""
    refs = {port: ref for ref, port in PAIRS}
    for (port, name), reason in DROPPED.items():
        assert reason
        assert any(_dropped(port, n) for n in _public(refs[port])), (port, name)
        assert not any(_dropped(port, n) for n in _public(port)), (port, name)


def test_departures_are_live():
    """Each recorded departure names a function that exists in both trees
    and still departs from the reference's positional parameters."""
    refs = {port: ref for ref, port in PAIRS}
    for (port, name), (params, reason) in DEPARTURES.items():
        assert reason
        assert _positional(_public(refs[port])[name]) != params, (port, name)
        assert _positional(_public(port)[name]) == params, (port, name)
