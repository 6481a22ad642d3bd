"""Camera factory + uniform interface (torch twin of
mobile_slam_tpu.models.cameras.base).

A ``Camera`` bundles its parameters (a tensor, or for Scaramuzza a dict of
tensors) with vectorized ``lift``/``project`` functions for the four
models: pinhole, Kannala-Brandt, Mei and Scaramuzza.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mobile_slam_tpu_torch import config as cfgmod
from mobile_slam_tpu_torch.models.cameras import equidistant, mei, pinhole, scaramuzza


def _leaf(params) -> torch.Tensor:
    """A tensor of the parameters, for their dtype and device."""
    return next(iter(params.values())) if isinstance(params, dict) else params


@dataclasses.dataclass(frozen=True)
class Camera:
    model_type: str
    params: torch.Tensor | dict
    width: int
    height: int
    focal: float
    _lift: Callable = dataclasses.field(repr=False, default=None)
    _project: Callable = dataclasses.field(repr=False, default=None)

    @property
    def dtype(self) -> torch.dtype:
        return _leaf(self.params).dtype

    @property
    def device(self) -> torch.device:
        return _leaf(self.params).device

    def _promote(self, x: torch.Tensor) -> torch.Tensor:
        # JAX promotes float32 points against float64 parameters; torch
        # would not (the parameters enter as 0-dim tensors), so do it here.
        return x.to(torch.promote_types(x.dtype, self.dtype))

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


# Model type -> the module with its lift / project / make_params.
MODELS = {cfgmod.MODEL_PINHOLE: pinhole, cfgmod.MODEL_KANNALA_BRANDT: equidistant,
          cfgmod.MODEL_MEI: mei, cfgmod.MODEL_SCARAMUZZA: scaramuzza}


def from_params(model_type: str, params, width: int, height: int,
                focal: float) -> Camera:
    """A Camera of a model over given parameters (a tensor, or the dict of
    tensors of a Scaramuzza camera)."""
    mt = model_type.upper()
    if mt not in MODELS:
        raise ValueError(f"unknown camera model type: {model_type}")
    return Camera(model_type=mt, params=params, width=width, height=height,
                  focal=float(focal), _lift=MODELS[mt].lift,
                  _project=MODELS[mt].project)


def make_camera(cam_cfg: cfgmod.CameraConfig, dtype=torch.float32, *,
                device) -> Camera:
    """Build a Camera from config; a Scaramuzza config without an inverse
    polynomial gets one fitted over half the image diagonal."""
    mt = cam_cfg.model_type.upper()
    kw = dict(dtype=dtype, device=device)
    if mt == cfgmod.MODEL_SCARAMUZZA:
        poly = np.asarray(cam_cfg.ocam_poly, dtype=np.float64)
        inv_poly = np.asarray(cam_cfg.ocam_inv_poly, dtype=np.float64)
        if inv_poly.size == 0 and poly.size > 0:
            max_rho = 0.5 * float(np.hypot(cam_cfg.width, cam_cfg.height))
            inv_poly = scaramuzza.fit_inverse_poly(poly, max_rho)
        params = scaramuzza.make_params(poly, inv_poly, cam_cfg.ocam_center,
                                        cam_cfg.ocam_affine, **kw)
    elif mt == cfgmod.MODEL_MEI:
        params = mei.make_params(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
                                 *cam_cfg.dist, xi=cam_cfg.xi, **kw)
    elif mt in MODELS:
        params = MODELS[mt].make_params(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx,
                                        cam_cfg.cy, *cam_cfg.dist, **kw)
    else:
        raise ValueError(f"unknown camera model type: {cam_cfg.model_type}")
    return from_params(mt, params, cam_cfg.width, cam_cfg.height,
                       cam_cfg.focal_length)
