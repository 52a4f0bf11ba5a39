"""Camera rays (presight_tpu/data/cameras.py): perspective, fisheye and
equirectangular cameras with optional OpenCV distortion, in the nerfstudio
convention (image y down, camera looking along -z, pixel centres at +0.5)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.rays import RayBundle

PERSPECTIVE = 1
FISHEYE = 2
EQUIRECTANGULAR = 3


@dataclasses.dataclass
class CameraParams:
    """Per-camera parameters, all (C, ...)."""

    c2w: torch.Tensor  # (C, 3, 4)
    fx: torch.Tensor  # (C,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    video_ids: Optional[torch.Tensor] = None  # (C,) int32
    camera_type: Optional[torch.Tensor] = None  # (C,) int32; None = perspective
    distortion_params: Optional[torch.Tensor] = None  # (C, 6) [k1 k2 k3 k4 p1 p2]

    @property
    def num_cameras(self) -> int:
        return self.c2w.shape[0]

    def to(self, device) -> "CameraParams":
        return CameraParams(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _undistort_newton(coords: torch.Tensor, dist: torch.Tensor,
                      eps: float = 1e-3, iters: int = 10) -> torch.Tensor:
    """Invert the OpenCV radial + tangential model by 10 Newton steps."""
    k1, k2, k3, k4, p1, p2 = (dist[..., i] for i in range(6))
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
        d_x = 2.0 * x * d_r
        d_y = 2.0 * y * d_r
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
        fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
        fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
        fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
        fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
        den = fy_x * fx_y - fx_x * fy_y
        ok = torch.abs(den) > eps
        step_x = torch.where(ok, (fx * fy_y - fy * fx_y) / den, 0.0)
        step_y = torch.where(ok, (fy * fx_x - fx * fy_x) / den, 0.0)
        x, y = x + step_x, y + step_y
    return torch.stack([x, y], dim=-1)


def generate_rays(cameras: CameraParams, ray_index: torch.Tensor,
                  pixel_offset: float = 0.5) -> RayBundle:
    """(camera, row, col) int32 triples (R, 3) -> world-space rays."""
    cam = ray_index[:, 0].long()
    y = ray_index[:, 1].to(torch.float32) + pixel_offset
    x = ray_index[:, 2].to(torch.float32) + pixel_offset

    fx, fy = cameras.fx[cam], cameras.fy[cam]
    cx, cy = cameras.cx[cam], cameras.cy[cam]
    c2w = cameras.c2w[cam]  # (R, 3, 4)

    u = (x - cx) / fx
    v = -(y - cy) / fy

    ctype = None if cameras.camera_type is None else cameras.camera_type[cam]
    if cameras.distortion_params is not None:
        und = _undistort_newton(torch.stack([u, v], dim=-1),
                                cameras.distortion_params[cam])
        if ctype is not None:
            keep = ctype == EQUIRECTANGULAR
            u = torch.where(keep, u, und[..., 0])
            v = torch.where(keep, v, und[..., 1])
        else:
            u, v = und[..., 0], und[..., 1]

    dir_cam = torch.stack([u, v, -torch.ones_like(u)], dim=-1)
    if ctype is not None:
        theta = torch.clamp(torch.sqrt(u * u + v * v), 1e-9, math.pi)
        sinc = torch.sin(theta) / theta
        dir_fish = torch.stack([u * sinc, v * sinc, -torch.cos(theta)], dim=-1)
        th = -math.pi * u
        phi = math.pi * (0.5 - v)
        dir_eq = torch.stack(
            [-torch.sin(th) * torch.sin(phi), torch.cos(phi), -torch.cos(th) * torch.sin(phi)],
            dim=-1)
        dir_cam = torch.where(
            (ctype == FISHEYE)[:, None], dir_fish,
            torch.where((ctype == EQUIRECTANGULAR)[:, None], dir_eq, dir_cam))

    dir_world = torch.einsum("rij,rj->ri", c2w[:, :3, :3], dir_cam)
    dir_world = dir_world / torch.linalg.norm(dir_world, dim=-1, keepdim=True)
    origins = c2w[:, :3, 3]
    n = ray_index.shape[0]
    return RayBundle(
        origins=origins,
        directions=dir_world,
        nears=torch.zeros((n,), dtype=origins.dtype, device=origins.device),
        fars=torch.full((n,), 1e6, dtype=origins.dtype, device=origins.device),
        camera_indices=cam.to(torch.int32),
        video_ids=None if cameras.video_ids is None else cameras.video_ids[cam],
    )
