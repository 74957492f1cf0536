"""Synthetic BOP-like scene (counterpart of data/synthetic.py).

An analytic blobby object (union of four colored spheres) rendered through
the pipeline's camera model: images, silhouettes and BOP-convention
(R, t, K).  Random draws take a ``torch.Generator``; tests pass the
reference's draws in explicitly instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch

_CENTERS = ((0.0, 0.0, 0.0), (0.45, 0.1, 0.0), (-0.15, 0.42, 0.12), (0.0, -0.2, -0.45))
_RADII = (0.45, 0.28, 0.22, 0.25)
_COLORS = ((0.9, 0.2, 0.1), (0.1, 0.8, 0.2), (0.2, 0.3, 0.9), (0.9, 0.8, 0.1))
_SHARPNESS = 80.0


def _const(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32, device=like.device)


def _blob_sdf(pts: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., K) signed distance to each blob."""
    return torch.linalg.vector_norm(pts[..., None, :] - _const(_CENTERS, pts), dim=-1) - _const(_RADII, pts)


def analytic_density(pts: torch.Tensor) -> torch.Tensor:
    """Soft union-of-spheres opacity in [0, 1), (..., 3) -> (..., 1)."""
    sdf = _blob_sdf(pts).amin(-1)
    return torch.sigmoid(-_SHARPNESS * sdf)[..., None]


def analytic_color(pts: torch.Tensor) -> torch.Tensor:
    """Softmin-weighted blob colors with positional shading."""
    w = torch.softmax(-12.0 * _blob_sdf(pts), dim=-1)
    base = w @ _const(_COLORS, pts)
    shade = 0.25 * torch.sin(6.0 * pts) + 0.75
    return (base * shade).clamp(0.0, 1.0)


def analytic_surface_points(n: int, generator: torch.Generator | None = None, which=None, dirs=None,
                            device=None):
    """Points on the blob spheres, and a mask of those on the outer surface,
    on ``device`` (the card unless named).

    ``which`` (n,) blob ids and ``dirs`` (n, 3) normal draws may be passed
    in; otherwise they are drawn from ``generator``."""
    device = resolve_device(device)
    if which is None:
        which = torch.randint(0, len(_RADII), (n,), generator=generator, device=device)
    if dirs is None:
        dirs = torch.randn((n, 3), generator=generator, device=device)
    which = torch.as_tensor(which, device=device)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    pts = _const(_CENTERS, d)[which] + d * _const(_RADII, d)[which][:, None]
    outside_others = _blob_sdf(pts).amin(-1) > -1e-3
    return pts, outside_others


class SyntheticScene(NamedTuple):
    images: torch.Tensor      # (N, S, S, 3) in [0, 1]
    sils: torch.Tensor        # (N, S, S)
    R_bop: torch.Tensor       # (N, 3, 3) OpenCV column convention
    t_bop: torch.Tensor       # (N, 3)
    K: torch.Tensor           # (N, 3, 3)
    diameter: float


def random_bop_poses(n_views: int, generator: torch.Generator | None = None, dist: float = 4.0,
                     uniforms=None, device=None):
    """Cameras on a sphere of radius ``dist`` looking at the origin, on
    ``device`` (the card unless named).

    ``uniforms`` (3, n_views) in [0, 1) may be passed in (z, phi, roll draws
    before scaling); otherwise they come from ``generator``."""
    device = resolve_device(device)
    if uniforms is None:
        uniforms = torch.rand((3, n_views), generator=generator, device=device)
    u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
    z = -0.95 + 1.9 * u[0]
    phi = 2 * math.pi * u[1]
    roll = -0.3 + 0.6 * u[2]
    r = torch.sqrt(1 - z**2)
    eye = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1) * dist
    fwd = -eye / torch.linalg.vector_norm(eye, dim=-1, keepdim=True)
    up0 = torch.where(fwd[:, 2:3].abs() > 0.9, _const((1.0, 0.0, 0.0), u), _const((0.0, 0.0, 1.0), u))
    right = torch.linalg.cross(fwd, up0)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=-2)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cr), torch.ones_like(cr)
    Rz = torch.stack(
        [torch.stack([cr, -sr, zero], -1), torch.stack([sr, cr, zero], -1), torch.stack([zero, zero, one], -1)],
        dim=-2,
    )
    R = Rz @ R
    t = -(R @ eye[..., None])[..., 0]
    return R, t


def make_scene(
    n_views: int = 16,
    image_size: int = 64,
    generator: torch.Generator | None = None,
    n_pts_per_ray: int = 96,
    dist: float = 4.0,
    poses=None,
    device=None,
) -> SyntheticScene:
    """Render the analytic object from ``n_views`` random cameras (or from
    ``poses`` = (R_bop, t_bop) when given) on ``device`` (the card unless
    named)."""
    device = resolve_device(device)
    if poses is None:
        R_bop, t_bop = random_bop_poses(n_views, generator, dist, device=device)
    else:
        R_bop, t_bop = (torch.as_tensor(p, dtype=torch.float32, device=device) for p in poses)
    n_views = R_bop.shape[0]
    S = image_size
    f = 2.1 * S
    K = torch.tensor([[f, 0.0, S / 2], [0.0, f, S / 2], [0.0, 0.0, 1.0]], device=device)
    K = K.expand(n_views, 3, 3).contiguous()
    cam = cam_lib.camera_from_bop(R_bop, t_bop, K, S)
    images, sils = [], []
    for v in range(n_views):
        bundle = cam_lib.grid_rays(cam[v], S, n_pts_per_ray, dist - 1.5, dist + 1.5)
        pts = cam_lib.ray_points(bundle)
        img, _ = raymarch.composite(analytic_density(pts)[..., 0], analytic_color(pts))
        rgb = img[..., :3].reshape(S, S, 3)
        sil = (img[..., 3] > 0.5).to(torch.float32).reshape(S, S)
        images.append(rgb * sil[..., None])
        sils.append(sil)
    extent = torch.linalg.vector_norm(torch.tensor(_CENTERS), dim=-1) + torch.tensor(_RADII)
    return SyntheticScene(torch.stack(images), torch.stack(sils), R_bop, t_bop, K, float(2 * extent.max()))
