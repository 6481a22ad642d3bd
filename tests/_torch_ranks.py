"""What each spawned rank of tests/test_torch_fleet_mesh.py and
tests/test_torch_tp_solver.py runs. Kept apart from the test modules so that
the ranks import torch and the port only, not JAX or the JAX package."""

import torch

from mobile_slam_tpu_torch.parallel import batch, dryrun, tp_solver


def rank_checks(rank: int, world: int, path: str) -> dict:
    """Every check of the test file on this rank, from the inputs the test
    saved at ``path``; returns what the tests assert on."""
    torch.set_num_threads(1)
    d = torch.load(path, weights_only=False)
    mesh = batch.make_mesh(["cpu"] * world)
    out = {"mesh": (type(mesh).__name__, mesh.rank, mesh.world, str(mesh.device), mesh.axis)}

    step = batch.make_batched_chunked_step(d["params"], d["n_it"], mesh=mesh)
    state, out["feature"] = step(batch.shard_batched(d["feature_state"], mesh),
                                 d["feature_inputs"])
    out["feature_state_p"] = state.window.p

    istep = batch.make_batched_image_step(*d["image_args"], mesh=mesh)
    carry, out["image"] = istep(batch.shard_batched(d["image_carry"], mesh), d["image_inputs"])
    out["image_carry_p"] = carry.est_state.window.p
    out["image_gens"] = [g.initial_seed() for g in carry.gen]

    try:
        batch.make_mesh(["cpu"] * (world + 1))
        out["mesh_size"] = None
    except ValueError as e:
        out["mesh_size"] = str(e)
    out["shard"] = batch.shard_batched(d["shard_tree"], mesh)
    try:
        batch.shard_batched(torch.zeros(2 * world + 1, 2), mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    try:
        step(d["feature_state"], d["feature_inputs"])     # the global state: refused
        out["global_state"] = None
    except ValueError as e:
        out["global_state"] = str(e)

    p, gt = (batch.shard_batched(x, mesh) for x in d["metric"])
    out["metric"] = float(batch.fleet_metrics(p, gt, mesh=mesh))

    out["dryrun"] = dryrun.run_checks(rank, world, "cpu", reps=1)
    return out


def fail_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def tp_local_step(port: dict, rank: int, world: int, mu: float):
    """This rank's inputs (its landmark slice) through tp_damped_step."""
    x = port["x"]._replace(lam=tp_solver.shard_landmarks(port["x"].lam, rank, world))
    return tp_solver.tp_damped_step(
        x, tp_solver.shard_landmarks(port["table"], rank, world), port["pre"], port["sqrt"],
        port["imu_valid"], port["prior"], port["prior_H0"], port["ex_t"], port["ex_q"],
        port["sp"], tp_solver.shard_landmarks(port["proj_valid"], rank, world),
        tp_solver.shard_landmarks(port["lam_mask"], rank, world),
        torch.tensor(mu, dtype=port["x"].p.dtype))


def tp_step(rank: int, world: int, path: str, mu: float):
    torch.set_num_threads(1)
    return tp_local_step(torch.load(path, weights_only=False), rank, world, mu)
