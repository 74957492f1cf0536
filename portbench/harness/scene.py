"""The benchmark's analytic object and its views, made on the device from
the seed.

The object is a union of four spheres, coloured by position.  A view is a
camera on a sphere of radius ``dist`` looking at the origin with a small
roll (BOP convention: x_cam = R x + t), focal length 2.1 S, and the exact
ray-sphere hits of its pixel centres: the image (black off the object) and
the silhouette.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.nerf import camera_centers, ray_directions, render_camera

CENTERS = ((0.0, 0.0, 0.0), (0.45, 0.1, 0.0), (-0.15, 0.42, 0.12), (0.0, -0.2, -0.45))
RADII = (0.45, 0.28, 0.22, 0.25)
DIST = 4.0


def poses(gen: torch.Generator, n: int, dist: float = DIST):
    """(R_bop (n, 3, 3), t_bop (n, 3)) of n cameras looking at the origin."""
    u = torch.rand((3, n), generator=gen, device=gen.device)
    z = -0.95 + 1.9 * u[0]
    phi = 2 * math.pi * u[1]
    roll = -0.3 + 0.6 * u[2]
    r = torch.sqrt(1 - z**2)
    eye = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1) * dist
    fwd = -eye / dist
    up = torch.zeros_like(eye)
    polar = fwd[:, 2].abs() > 0.9
    up[:, 0], up[:, 2] = polar.float(), (~polar).float()
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], -2)
    c, s = torch.cos(roll), torch.sin(roll)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, o], -1), torch.stack([s, c, o], -1), torch.stack([o, o, i], -1)], -2)
    R = Rz @ R
    return R, -(R @ eye[..., None])[..., 0]


def intrinsics(n: int, S: int, device):
    f = 2.1 * S
    K = torch.tensor([[f, 0.0, S / 2], [0.0, f, S / 2], [0.0, 0.0, 1.0]], device=device)
    return K.expand(n, 3, 3).contiguous()


def hit(o: torch.Tensor, d: torch.Tensor):
    """First hits of rays o + t d (unit d) with the spheres: (t, hit mask)."""
    c = torch.tensor(CENTERS, device=o.device)
    r = torch.tensor(RADII, device=o.device)
    oc = o[..., None, :] - c                                   # (..., 4, 3)
    b = (oc * d[..., None, :]).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    t = -b - torch.sqrt(disc.clamp_min(0))
    t = torch.where((disc > 0) & (t > 0), t, torch.full_like(t, float("inf")))
    t = t.amin(-1)
    return t, torch.isfinite(t)


def color(p: torch.Tensor) -> torch.Tensor:
    """A smooth colour of the surface point, in (0, 1)."""
    phase = torch.tensor((0.0, 2.1, 4.2), device=p.device)
    return 0.5 + 0.4 * torch.sin(3.0 * p.sum(-1, keepdim=True) + phase) * torch.cos(2.0 * p[..., :1] - p[..., 2:])


def views(gen: torch.Generator, n: int, S: int, chunk: int = 128, hits: bool = False) -> dict:
    """n views of S x S: images (n, S, S, 3), sils (n, S, S), R, t, K; with
    ``hits`` also each pixel's surface point (n, S, S, 3) and the pixel
    centres' NDC xys (S * S, 2), row-major."""
    dev = gen.device
    R_bop, t_bop = poses(gen, n)
    K = intrinsics(n, S, dev)
    R, T, focal, principal = render_camera(R_bop, t_bop, K)
    centers = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
    ndc = 1.0 - 2.0 * centers / S
    yy, xx = torch.meshgrid(ndc, ndc, indexing="ij")
    xys = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    images = torch.empty((n, S, S, 3), device=dev)
    sils = torch.empty((n, S, S), device=dev)
    points = torch.empty((n, S, S, 3), device=dev) if hits else None
    for a in range(0, n, chunk):
        b = slice(a, min(a + chunk, n))
        d = ray_directions(R[b], focal[b], principal[b], S, xys.expand(R[b].shape[0], -1, -1))
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = camera_centers(R[b], T[b])[:, None].expand(d.shape)
        t, m = hit(o, d)
        p = o + d * torch.where(m, t, torch.zeros_like(t))[..., None]
        images[b] = (color(p) * m[..., None]).reshape(-1, S, S, 3)
        sils[b] = m.float().reshape(-1, S, S)
        if hits:
            points[b] = p.reshape(-1, S, S, 3)
    out = {"images": images, "sils": sils, "R": R_bop, "t": t_bop, "K": K}
    if hits:
        out.update(points=points, xys=xys)
    return out


def ray_bank(v: dict, bucket: int = 2048) -> dict:
    """Each view's front hits as the program's ray bank holds them: the
    object's pixels first, padded to the largest view's count rounded up to
    ``bucket``: pos_vec (n, M, 3), xys (n, M, 2), valid (n, M)."""
    n, S = v["sils"].shape[:2]
    valid = v["sils"].reshape(n, S * S) > 0.5
    M = int(-(-int(valid.sum(1).max()) // bucket) * bucket)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :M]
    return {"pos_vec": torch.gather(v["points"].reshape(n, S * S, 3), 1, order[..., None].expand(-1, -1, 3)),
            "xys": v["xys"][order], "valid": torch.gather(valid, 1, order)}


def surface_points(gen: torch.Generator, n: int) -> torch.Tensor:
    """n points on the object's outer surface, spread by area."""
    c = torch.tensor(CENTERS, device=gen.device)
    r = torch.tensor(RADII, device=gen.device)
    m = 3 * n
    which = torch.multinomial(r * r, m, replacement=True, generator=gen)
    d = torch.randn((m, 3), generator=gen, device=gen.device)
    p = c[which] + d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * r[which][:, None]
    outer = (torch.linalg.vector_norm(p[:, None] - c, dim=-1) - r).amin(-1) > -1e-3
    return p[outer][:n]
