"""Camera factory + uniform interface (torch twin of
mobile_slam_tpu.models.cameras.base).

A ``Camera`` bundles a parameter tensor with vectorized ``lift``/``project``
functions. Pinhole and Kannala-Brandt are ported; Mei and Scaramuzza raise
``NotImplementedError`` until their modules are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mobile_slam_tpu_torch import config as cfgmod
from mobile_slam_tpu_torch.models.cameras import equidistant, pinhole


@dataclasses.dataclass(frozen=True)
class Camera:
    model_type: str
    params: torch.Tensor
    width: int
    height: int
    focal: float
    _lift: Callable = dataclasses.field(repr=False, default=None)
    _project: Callable = dataclasses.field(repr=False, default=None)

    def _promote(self, x: torch.Tensor) -> torch.Tensor:
        # JAX promotes float32 points against float64 parameters; torch
        # would not (the parameters enter as 0-dim tensors), so do it here.
        return x.to(torch.promote_types(x.dtype, self.params.dtype))

    def lift(self, uv: torch.Tensor) -> torch.Tensor:
        return self._lift(self.params, self._promote(uv))

    def lift_normalized(self, uv: torch.Tensor) -> torch.Tensor:
        ray = self._lift(self.params, self._promote(uv))
        z = ray[..., 2:3]
        small = torch.where(z < 0, torch.full_like(z, -1e-8),
                            torch.full_like(z, 1e-8))
        safe_z = torch.where(torch.abs(z) < 1e-8, small, z)
        return ray / safe_z

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        return self._project(self.params, self._promote(pts))


def make_camera(cam_cfg: cfgmod.CameraConfig, *, dtype=torch.float32,
                device) -> Camera:
    mt = cam_cfg.model_type.upper()
    if mt == cfgmod.MODEL_PINHOLE:
        mod = pinhole
    elif mt == cfgmod.MODEL_KANNALA_BRANDT:
        mod = equidistant
    elif mt in (cfgmod.MODEL_MEI, cfgmod.MODEL_SCARAMUZZA):
        raise NotImplementedError(f"camera model {mt} is not ported yet")
    else:
        raise ValueError(f"unknown camera model type: {cam_cfg.model_type}")
    params = mod.make_params(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
                             *cam_cfg.dist, dtype=dtype, device=device)
    return Camera(model_type=mt, params=params, width=cam_cfg.width,
                  height=cam_cfg.height, focal=float(cam_cfg.focal_length),
                  _lift=mod.lift, _project=mod.project)
