"""Camera model and ray generation (counterpart of geometry/cameras.py).

Same conventions as the reference: BOP ground truth is OpenCV column
form ``x_cam = R x + t``; the render convention is ``R' = R^T @ rot180_z``,
``t'[0:2] = -t[0:2]`` with ``x_cam = x_world @ R' + t'``; NDC for a square
screen of S pixels is ``1 - 2 * x_pix / S``; ray lengths are camera-space
z depths (directions have z_cam == 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device

_ROT180_Z = ((-1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0))


class Camera(NamedTuple):
    """Render-convention camera batch: R (..., 3, 3), T (..., 3),
    focal (..., 2), principal (..., 2), image_size (float S)."""

    R: torch.Tensor
    T: torch.Tensor
    focal: torch.Tensor
    principal: torch.Tensor
    image_size: float

    def __getitem__(self, idx):
        return Camera(self.R[idx], self.T[idx], self.focal[idx], self.principal[idx], self.image_size)


class RayBundle(NamedTuple):
    """origins/directions: (..., 3); lengths: (..., P); xys: (..., 2) NDC."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: torch.Tensor


def camera_from_bop(R_bop: torch.Tensor, t_bop: torch.Tensor, K: torch.Tensor, image_size) -> Camera:
    """BOP (cam_R_m2c, cam_t_m2c, K) -> render convention."""
    rot = torch.tensor(_ROT180_Z, dtype=R_bop.dtype, device=R_bop.device)
    R = R_bop.transpose(-1, -2) @ rot
    T = t_bop * torch.tensor([-1.0, -1.0, 1.0], dtype=t_bop.dtype, device=t_bop.device)
    focal = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    principal = K[..., 0:2, 2]
    return Camera(R=R, T=T, focal=focal, principal=principal, image_size=float(image_size))


def camera_center(cam: Camera) -> torch.Tensor:
    """World-space camera origin: C @ R + T = 0  =>  C = -T @ R^T."""
    return -(cam.R @ cam.T[..., None])[..., 0]


def pixel_to_ndc(xy_pix: torch.Tensor, S) -> torch.Tensor:
    return 1.0 - 2.0 * xy_pix / S


def ndc_to_pixel(xy_ndc: torch.Tensor, S) -> torch.Tensor:
    return (1.0 - xy_ndc) * S / 2.0


def ndc_directions(cam: Camera, xys_ndc: torch.Tensor) -> torch.Tensor:
    """World-space unnormalized ray directions with camera z == 1;
    xys_ndc (..., N, 2) against a camera batch (...)."""
    S = cam.image_size
    f_ndc = 2.0 * cam.focal / S
    p_ndc = 1.0 - 2.0 * cam.principal / S
    dxy = (xys_ndc - p_ndc[..., None, :]) / f_ndc[..., None, :]
    d_cam = torch.cat([dxy, torch.ones_like(dxy[..., :1])], dim=-1)
    # directions carry no translation: d_world = d_cam @ R^T
    return d_cam @ cam.R.transpose(-1, -2)


def project_points(cam: Camera, pts_world: torch.Tensor):
    """World points (..., N, 3) -> (xy_ndc (..., N, 2), z_cam (..., N)) for a
    camera batch (...)."""
    x_cam = pts_world @ cam.R + cam.T[..., None, :]
    z = x_cam[..., 2]
    S = cam.image_size
    f_ndc = 2.0 * cam.focal / S
    p_ndc = 1.0 - 2.0 * cam.principal / S
    return f_ndc[..., None, :] * x_cam[..., :2] / z[..., None] + p_ndc[..., None, :], z


def grid_rays(cam: Camera, image_size: int, n_pts: int, min_depth, max_depth) -> RayBundle:
    """Full-image grid rays at pixel centers, row-major (y outer, x inner):
    (..., S*S, 3) / (..., S*S, P) / (..., S*S, 2)."""
    S = image_size
    dev = cam.R.device
    centers = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
    ndc_1d = 1.0 - 2.0 * centers / S
    yy, xx = torch.meshgrid(ndc_1d, ndc_1d, indexing="ij")
    xys = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    xys = xys.expand(cam.R.shape[:-2] + xys.shape)
    dirs = ndc_directions(cam, xys)
    origins = camera_center(cam)[..., None, :].expand(dirs.shape)
    lengths = torch.linspace(min_depth, max_depth, n_pts, dtype=torch.float32, device=dev)
    lengths = lengths.expand(dirs.shape[:-1] + (n_pts,))
    return RayBundle(origins=origins, directions=dirs, lengths=lengths, xys=xys)


def rays_at_pixels(cam: Camera, pix_idx: torch.Tensor, image_size: int, n_pts: int, min_depth: float,
                   max_depth: float) -> RayBundle:
    """Rays through the centers of the flat row-major pixels ``pix_idx``
    (N,) of one camera, with ``n_pts`` depths spread evenly over [min_depth,
    max_depth] (the reference's ``linspace``): (N, 3) / (N, P) / (N, 2)."""
    S = image_size
    row = torch.div(pix_idx, S, rounding_mode="floor").to(torch.float32)
    col = (pix_idx % S).to(torch.float32)
    xys = torch.stack([1.0 - 2.0 * (col + 0.5) / S, 1.0 - 2.0 * (row + 0.5) / S], dim=-1)
    dirs = ndc_directions(cam, xys)
    origins = camera_center(cam)[..., None, :].expand(dirs.shape)
    lengths = depth_edges(min_depth, max_depth, n_pts - 1, pix_idx.device).expand(dirs.shape[:-1] + (n_pts,))
    return RayBundle(origins=origins, directions=dirs, lengths=lengths, xys=xys)


def depth_edges(min_depth: float, max_depth: float, n_pts: int, device=None) -> torch.Tensor:
    """The n_pts + 1 stratification edges of [min_depth, max_depth] in f32,
    by the reference's own ``linspace`` formula: ``start * (1 - i/n) +
    stop * (i/n)``, then ``stop`` itself, on ``device`` (the card unless
    named).  ``torch.linspace`` steps from both ends instead and lands up to
    an ulp away on most edges."""
    device = resolve_device(device)
    step = torch.arange(n_pts, dtype=torch.float32, device=device) / n_pts
    # filled on the device: a tensor made from a host value is a copy that
    # waits for everything queued there
    start = torch.full((), min_depth, dtype=torch.float32, device=device)
    stop = torch.full((), max_depth, dtype=torch.float32, device=device)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def monte_carlo_rays(cam: Camera, n_rays: int, n_pts: int, min_depth: float, max_depth: float,
                     generator: torch.Generator | None = None, xys: torch.Tensor | None = None,
                     u: torch.Tensor | None = None) -> RayBundle:
    """Uniform ray xys in [-1, 1)^2 per camera and stratified jittered
    depths.  ``xys`` (..., n_rays, 2) in [-1, 1) and the depth jitter ``u``
    (..., n_rays, n_pts) in [0, 1) may be passed in; otherwise they are
    drawn from ``generator`` on the camera's device."""
    batch = cam.R.shape[:-2]
    dev = cam.R.device
    if xys is None:
        xys = torch.rand(batch + (n_rays, 2), generator=generator, device=dev) * 2.0 - 1.0
    if u is None:
        u = torch.rand(batch + (n_rays, n_pts), generator=generator, device=dev)
    dirs = ndc_directions(cam, xys)
    origins = camera_center(cam)[..., None, :].expand(dirs.shape)
    edges = depth_edges(min_depth, max_depth, n_pts, dev)
    lo, hi = edges[:-1], edges[1:]
    return RayBundle(origins=origins, directions=dirs, lengths=lo + (hi - lo) * u, xys=xys)


def ray_points(bundle: RayBundle) -> torch.Tensor:
    """(..., P, 3) world points o + d * length."""
    return bundle.origins[..., None, :] + bundle.directions[..., None, :] * bundle.lengths[..., :, None]


def downsample_K(K: torch.Tensor, factor: int) -> torch.Tensor:
    """Pixel-center-correct K downsample for (..., 3, 3) intrinsics."""
    K = K.to(torch.float32).clone()
    K[..., 0:2, 2] += 0.5
    K[..., 0:2, :] /= factor
    K[..., 0:2, 2] -= 0.5
    return K


def crop_K(K: torch.Tensor, x2, y2, hs1, hw, hh, square_size, max_b) -> torch.Tensor:
    """Bounding-box crop and resize of (..., 3, 3) intrinsics: ``x2, y2`` the
    bbox's top-left, ``hs1`` half the padded square's size, ``hw, hh`` half
    the bbox's width and height, ``square_size`` the padded square's edge,
    ``max_b`` the resized edge."""
    K = K.to(torch.float32).clone()
    K[..., 0, 2] += -x2 + hs1 - hw
    K[..., 1, 2] += -y2 + hs1 - hh
    K = K * (max_b / square_size)
    K[..., 2, 2] = 1.0
    return K


def surfemb_crop_M(x, y, w, h, crop_res: int = 224, pad: float = 1.2, device=None):
    """SurfEmb-style affine crop of the box (x, y, w, h): the 2x3 affine M
    mapping full-frame pixels to the ``crop_res`` crop and its 3x3 form Ms,
    f32 on ``device`` (the card unless named)."""
    center_x = x + w / 2.0
    center_y = y + h / 2.0
    size = crop_res / max(w, h) / pad
    Ms = torch.tensor([[size, 0.0, -center_x * size + crop_res / 2.0],
                       [0.0, size, -center_y * size + crop_res / 2.0],
                       [0.0, 0.0, 1.0]], dtype=torch.float32, device=resolve_device(device))
    return Ms[:2], Ms
