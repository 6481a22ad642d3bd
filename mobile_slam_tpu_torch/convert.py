"""Conversion between the JAX package's state pytrees and the port's.

The input is the reference structure with numpy leaves — a NamedTuple (as
``jax.tree.map(np.asarray, x)`` returns it) or a nested dict with the same
field names. Floating leaves become ``dtype`` tensors on ``device``;
integer and bool leaves keep their type (int32 stays int32). ``to_numpy``
goes back to the port's structure with numpy leaves. ``camera`` carries a
reference camera (its model, size, focal length and parameters: a vector,
or Scaramuzza's dict of four) into the port's ``Camera``.
"""

from __future__ import annotations

import numpy as np
import torch

from mobile_slam_tpu_torch.engine.estimator import (EstimatorState, FrameInput,
                                                    StaticParams)
from mobile_slam_tpu_torch.frontend.tracker import TrackerState
from mobile_slam_tpu_torch.imu.preintegration import Preintegration
from mobile_slam_tpu_torch.models.cameras import base as cam_base
from mobile_slam_tpu_torch.models.state import FeatureTable, WindowState
from mobile_slam_tpu_torch.solver.assembly import Prior

# Fields whose value is itself a NamedTuple of the port.
_NESTED = {"window": WindowState, "table": FeatureTable, "prior": Prior,
           "pre": Preintegration}


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _leaf(x, device, dtype) -> torch.Tensor:
    a = np.array(x)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def to_torch(obj, cls, *, device, dtype=torch.float32):
    """Convert a reference structure into the port's NamedTuple ``cls``."""
    out = {}
    for name in cls._fields:
        val = _field(obj, name)
        if name in _NESTED:
            out[name] = to_torch(val, _NESTED[name], device=device, dtype=dtype)
        elif isinstance(val, (tuple, list)):
            out[name] = tuple(_leaf(v, device, dtype) for v in val)
        else:
            out[name] = _leaf(val, device, dtype)
    return cls(**out)


def estimator_state(obj, **kw) -> EstimatorState:
    return to_torch(obj, EstimatorState, **kw)


def static_params(obj, **kw) -> StaticParams:
    return to_torch(obj, StaticParams, **kw)


def frame_input(obj, **kw) -> FrameInput:
    return to_torch(obj, FrameInput, **kw)


def tracker_state(obj, **kw) -> TrackerState:
    return to_torch(obj, TrackerState, **kw)


def camera_params(params, *, device, dtype=torch.float32):
    """A camera's parameters: a vector, or a dict of vectors (Scaramuzza)."""
    if isinstance(params, dict):
        return {k: _leaf(v, device, dtype) for k, v in params.items()}
    return _leaf(params, device, dtype)


def camera(ref, *, device, dtype=torch.float32) -> cam_base.Camera:
    """The port's Camera over a reference camera's parameters (any object
    with the reference Camera's ``model_type``, ``params``, ``width``,
    ``height`` and ``focal``)."""
    return cam_base.from_params(
        ref.model_type, camera_params(ref.params, device=device, dtype=dtype),
        ref.width, ref.height, ref.focal)


def to_numpy(obj):
    """The port's structure with numpy leaves (same NamedTuple classes)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(v) for v in obj])
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    return obj
