"""Estimator checkpoint/resume (torch twin of
mobile_slam_tpu.engine.checkpoint).

The estimator and tracker states are fixed-shape NamedTuples of tensors, so
a whole engine snapshots into one ``.npz``: ``est:`` / ``trk:`` keys from
each leaf's field path, written as ``jax.tree_util`` renders a key path
(``.window/.pre/.dp``, ``.pyr/[0]``), plus the engine's host fields under
``x:``. The layout is the JAX package's, so a snapshot it saved for a
same-shaped config loads here field for field. A resume continues the
sequence bit-exactly given the same inputs and device.

The JAX package's PRNG key (``x:key``) has no torch meaning: the port saves
its ``torch.Generator`` state under ``x:torch_generator`` and, loading a
snapshot that holds only a JAX key, warns that the key was not carried
across.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

GENERATOR_KEY = "torch_generator"


def _flatten_with_paths(tree, path=()):
    """(key, leaf) pairs of a NamedTuple/tuple tree; ``None`` has no leaf."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _flatten_with_paths(v, path + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def _numpy(tree) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in _flatten_with_paths(tree)}


def _fill(tree, data, prefix: str, path=()):
    """``tree`` with every leaf replaced by ``data[prefix + key]``, in the
    leaf's dtype and on its device; raises on a shape mismatch."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*[_fill(v, data, prefix, path + (f".{n}",))
                            for n, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fill(v, data, prefix, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    key = prefix + "/".join(path)
    arr = np.asarray(data[key])
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(tree.shape)}")
    return torch.as_tensor(arr).to(dtype=tree.dtype, device=tree.device)


def save_state(path: str, state, tracker_state=None, extra: dict | None = None) -> None:
    """``extra`` holds engine host-side arrays/scalars (prefixed ``x:``)
    needed for a full resumable engine snapshot (save_engine)."""
    payload = {f"est:{k}": v for k, v in _numpy(state).items()}
    if tracker_state is not None:
        payload.update({f"trk:{k}": v for k, v in _numpy(tracker_state).items()})
    for k, v in (extra or {}).items():
        payload[f"x:{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_state(path: str, template, tracker_template=None):
    """Restore states saved by save_state. Templates give the structure,
    dtypes and device (shapes must match the saved config)."""
    with np.load(path) as data:
        state = _fill(template, data, "est:")
        if tracker_template is not None:
            return state, _fill(tracker_template, data, "trk:")
    return state


def load_extra(path: str) -> dict:
    """The ``extra`` dict saved by save_state (``x:``-prefixed entries)."""
    with np.load(path) as data:
        return {k[2:]: data[k] for k in data.files if k.startswith("x:")}


# ---------------------------------------------------------------------------
# Full engine snapshot (CLI --checkpoint / --resume)
# ---------------------------------------------------------------------------

def save_engine(path: str, engine) -> None:
    """Snapshot a VIOEngine into one .npz: estimator and tracker states plus
    the host fields a bit-exact resume needs (generator state, EMAs,
    pending IMU queue, timestamps). Restore with load_engine into a fresh
    engine built from the same config."""
    host = {
        "t0": engine._t0,
        "first_frame_time": engine._first_frame_time,
        "last_frame_ts": engine._last_frame_ts,
        "status": int(engine.status.value),
        "frame_index": int(engine.frame_index),
        "consecutive_failures": int(engine._consecutive_failures),
        "cooldown_remaining": int(engine._cooldown_remaining),
        "depth_ema": engine._depth_ema,
        "vel_ema": engine._vel_ema,
    }
    extra = {
        "host_json": np.frombuffer(json.dumps(host).encode(), dtype=np.uint8),
        # The static parameters change at run time (initialization refines
        # gravity): a resume with the config's defaults diverges at once.
        **{f"par/{k}": v for k, v in _numpy(engine.params).items()},
        "gravity_np": np.asarray(engine._gravity_np),
        "window_ts": np.asarray(engine.window_ts),
        "banned_ids": engine._banned_ids.cpu().numpy(),
        GENERATOR_KEY: engine._gen.get_state().numpy(),
        "pending_imu": (np.stack(engine._pending_imu)
                        if engine._pending_imu else np.zeros((0, 7))),
        "last_imu": (engine._last_imu if engine._last_imu is not None
                     else np.full(7, np.nan)),
        "last_imu_tail": np.asarray(engine._last_imu_tail),
        "last_pose": (engine._last_pose if engine._last_pose is not None
                      else np.full((4, 4), np.nan)),
    }
    save_state(path, engine.state, engine.tracker_state, extra=extra)


def load_engine(path: str, engine) -> None:
    """Restore a save_engine snapshot (the port's or the JAX package's)
    into ``engine`` (fresh, same config). After this the engine continues
    the sequence where the saved one stopped."""
    from mobile_slam_tpu_torch.engine.vio_engine import Status

    engine.state, engine.tracker_state = load_state(
        path, engine.state, engine.tracker_state)
    x = load_extra(path)
    host = json.loads(bytes(x["host_json"]).decode())
    engine.params = _fill(engine.params, x, "par/")
    engine._gravity_np = np.asarray(x["gravity_np"])
    engine._t0 = host["t0"]
    engine._first_frame_time = host["first_frame_time"]
    engine._last_frame_ts = host["last_frame_ts"]
    engine.status = Status(host["status"])
    engine.frame_index = host["frame_index"]
    engine._consecutive_failures = host["consecutive_failures"]
    engine._cooldown_remaining = host["cooldown_remaining"]
    engine._depth_ema = host["depth_ema"]
    engine._vel_ema = host["vel_ema"]
    engine.window_ts = np.asarray(x["window_ts"])
    engine._banned_ids = torch.as_tensor(x["banned_ids"], dtype=torch.int32,
                                         device=engine.device)
    if GENERATOR_KEY in x:
        engine._gen.set_state(torch.as_tensor(x[GENERATOR_KEY], dtype=torch.uint8))
    elif "key" in x:
        warnings.warn(f"{path} holds a JAX PRNG key (x:key), which has no torch "
                      "meaning: it was not carried across, and the engine's RANSAC "
                      "draws continue from its own generator", stacklevel=2)
    engine._pending_imu = [s for s in np.asarray(x["pending_imu"])]
    li = np.asarray(x["last_imu"])
    engine._last_imu = None if np.isnan(li).all() else li
    engine._last_imu_tail = np.asarray(x["last_imu_tail"])
    lp = np.asarray(x["last_pose"])
    engine._last_pose = None if np.isnan(lp).all() else lp
