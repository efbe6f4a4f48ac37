"""Plain 3D Gaussian splatting (Kerbl et al. 2023, in gsplat's conventions)
for the benchmark's comparisons: EWA projection with the 0.3-pixel
dilation, real spherical harmonics to degree 3, and front-to-back
compositing per pixel in blocks of 128 Gaussians of each tile's
depth-sorted list.

The semantics are those the program under test states for its kernels:
``alpha = min(op * exp(-sigma), 0.999)`` where ``sigma >= 0`` and
``alpha >= 1/255``, zero elsewhere; a Gaussian reaches the tiles of its
radius square (``ceil(3 * sqrt(lambda_max))`` pixels); a tile stops before
a block once the largest transmittance over its pixels is at most
``trans_eps``. A tile's list leaves out the Gaussians whose alpha is
below the clip over the whole tile (``reaches``), as the program's plan
does: they add nothing, but they would move where the blocks break and so
where a tile exits.

Everything is float32; the walk runs over all tiles at once, one block
index at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
BLOCK = 128

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def rotation(quats: torch.Tensor) -> torch.Tensor:
    q = quats / (torch.linalg.vector_norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(means, quats, scales, opacities, viewmat, K, width: int, height: int,
            eps2d: float = 0.3, near: float = 0.01, far: float = 1e10) -> dict:
    """Screen-space means ``xy``, ``conic`` (a, b, c of the inverse 2D
    covariance), ``depth``, pixel ``radius``, ``opac`` and ``valid``."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    pc = means @ R.T + t
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = pc[:, 0] / zs, pc[:, 1] / zs
    xy = torch.stack([fx * u + cx, fy * v + cy], -1)
    lx, ly = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    tx = zs * torch.clamp(u, -lx, lx)
    ty = zs * torch.clamp(v, -ly, ly)
    M = rotation(quats) * scales[:, None, :]
    cov = R @ (M @ M.transpose(1, 2)) @ R.T
    J = torch.stack([
        torch.stack([fx / zs, torch.zeros_like(zs), -fx * tx / (zs * zs)], -1),
        torch.stack([torch.zeros_like(zs), fy / zs, -fy * ty / (zs * zs)], -1)], -2)
    c2 = J @ cov @ J.transpose(1, 2)
    a = c2[:, 0, 0] + eps2d
    b = c2[:, 0, 1]
    c = c2[:, 1, 1] + eps2d
    det = a * c - b * b
    inv = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    x, y = xy[:, 0].detach(), xy[:, 1].detach()
    valid = ((z > near) & (z < far) & (det > 0) & (radius > 0)
             & (x + radius > 0) & (x - radius < width) & (y + radius > 0) & (y - radius < height)
             & (opacities >= ALPHA_MIN)).detach()
    return {"xy": xy, "conic": conic, "depth": z, "radius": torch.where(valid, radius, 0 * radius),
            "opac": opacities, "valid": valid}


def sh_colors(coeffs: torch.Tensor, means: torch.Tensor, viewmat: torch.Tensor,
              degree: int) -> torch.Tensor:
    """(N, 3) colours ``max(basis . coeffs + 0.5, 0)`` seen from the camera."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    d = means - (-R.T @ t)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d.unbind(-1)
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    B = torch.stack(basis, -1)
    return torch.clamp(torch.einsum("nk,nkc->nc", B, coeffs[:, :B.shape[1]]) + 0.5, min=0.0)


@dataclasses.dataclass
class Tiles:
    """Each tile's Gaussians in depth order: ids ``gid`` (n_isects,) and
    each tile's ``start`` and ``count``."""

    ts: int
    ntx: int
    nty: int
    width: int
    height: int
    gid: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.ntx * self.nty


def tile_lists(proj: dict, width: int, height: int, ts: int) -> Tiles:
    xy, r, valid = proj["xy"].detach(), proj["radius"], proj["valid"]
    n = xy.shape[0]
    dev = xy.device
    ntx, nty = -(-width // ts), -(-height // ts)
    order = torch.sort(torch.where(valid, proj["depth"].detach(), torch.full_like(r, float("inf"))),
                       stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    x0 = torch.clamp(torch.floor((xy[:, 0] - r) / ts), 0, ntx).long()
    y0 = torch.clamp(torch.floor((xy[:, 1] - r) / ts), 0, nty).long()
    x1 = torch.clamp(torch.floor((xy[:, 0] + r) / ts) + 1, 0, ntx).long()
    y1 = torch.clamp(torch.floor((xy[:, 1] + r) / ts) + 1, 0, nty).long()
    x1 = torch.where(valid, x1, x0)
    y1 = torch.where(valid, y1, y0)
    wdt = x1 - x0
    cnt = wdt * (y1 - y0)
    g = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    j = torch.arange(g.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[g]
    tx = x0[g] + j % wdt[g].clamp(min=1)
    ty = y0[g] + j // wdt[g].clamp(min=1)
    keep = reaches(xy[g], proj["conic"].detach()[g], proj["opac"].detach()[g], tx, ty, ts)
    g, tile = g[keep], (ty * ntx + tx)[keep]
    perm = torch.sort(tile * n + rank[g]).indices
    count = torch.bincount(tile, minlength=ntx * nty)
    return Tiles(ts, ntx, nty, width, height, g[perm], torch.cumsum(count, 0) - count, count)


def reaches(xy, conic, opac, tx, ty, ts: int) -> torch.Tensor:
    """Whether a Gaussian can reach the 1/255 clip anywhere on the tile's
    square [tx ts, (tx + 1) ts] x [ty ts, (ty + 1) ts]: the least of
    sigma over the square (0 with the mean inside; else the least over its
    four edges, each the quadratic's minimum along the edge clamped to
    it) at most ln(255 opacity) + 1e-3. A pair that fails has alpha 0 at
    every pixel; dropping it moves only where the blocks break, which the
    program's plan does the same way."""
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    lx = tx.float() * ts - xy[:, 0]
    ly = ty.float() * ts - xy[:, 1]
    ux, uy = lx + ts, ly + ts

    def sigma(dx, dy):
        return 0.5 * a * dx * dx + 0.5 * c * dy * dy + b * dx * dy

    def along_x(dx):
        return sigma(dx, torch.minimum(torch.maximum(-b * dx / torch.clamp(c, min=1e-12), ly), uy))

    def along_y(dy):
        return sigma(torch.minimum(torch.maximum(-b * dy / torch.clamp(a, min=1e-12), lx), ux), dy)

    least = torch.minimum(torch.minimum(along_x(lx), along_x(ux)),
                          torch.minimum(along_y(ly), along_y(uy)))
    inside = (lx <= 0) & (ux >= 0) & (ly <= 0) & (uy >= 0)
    least = torch.where(inside, torch.zeros_like(least), least)
    return least <= torch.log(torch.clamp(255.0 * opac, min=1.0)) + 1e-3


@dataclasses.dataclass
class Step:
    """One block index of the walk over the tiles still running."""

    active: torch.Tensor  # (k,) tile ids
    gid: torch.Tensor  # (k, B) Gaussian ids (0 where ``lane`` is False)
    lane: torch.Tensor  # (k, B) slot holds a Gaussian
    alpha: torch.Tensor  # (k, P, B)
    w: torch.Tensor  # (k, P, B) alpha * transmittance before the pair
    t_before: torch.Tensor  # (k, P, B) transmittance before the pair
    inside: torch.Tensor  # (k, P) pixel lies inside the image


def _pixels(tiles: Tiles, dev):
    ts = tiles.ts
    t = torch.arange(tiles.n_tiles, device=dev)
    lp = torch.arange(ts * ts, device=dev)
    px = (t % tiles.ntx)[:, None] * ts + (lp % ts)[None, :]
    py = (t // tiles.ntx)[:, None] * ts + (lp // ts)[None, :]
    return px.float() + 0.5, py.float() + 0.5, (px < tiles.width) & (py < tiles.height)


def _block(px, py, mx, my, ca, cb, cc, op, lane, trans):
    dx = px[:, :, None] - mx[:, None, :]
    dy = py[:, :, None] - my[:, None, :]
    sigma = 0.5 * (ca[:, None] * dx * dx + cc[:, None] * dy * dy) + cb[:, None] * dx * dy
    alpha = torch.clamp(op[:, None] * torch.exp(-torch.clamp(sigma, min=0.0)), max=ALPHA_MAX)
    keep = (sigma >= 0) & (alpha >= ALPHA_MIN) & lane[:, None, :]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    incl = torch.cumprod(1.0 - alpha, -1)
    t_before = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], -1) * trans[..., None]
    return alpha, t_before, trans * incl[..., -1]


def walk(proj: dict, tiles: Tiles, trans_eps: float, visit: Callable[[Step], None]) -> None:
    """The walk without gradients: ``visit`` sees every block step."""
    dev = proj["xy"].device
    px, py, inside = _pixels(tiles, dev)
    geo = torch.cat([proj["xy"], proj["conic"], proj["opac"][:, None]], -1).detach()
    trans = torch.ones_like(px)
    lane_ids = torch.arange(BLOCK, device=dev)
    nb = (tiles.count + BLOCK - 1) // BLOCK
    max_t = torch.ones((tiles.n_tiles,), device=dev)
    for b in range(int(nb.max()) if tiles.n_tiles else 0):
        active = torch.nonzero((b < nb) & (max_t > trans_eps)).squeeze(1)
        if active.numel() == 0:
            break
        lane = lane_ids[None, :] < (tiles.count[active, None] - b * BLOCK)
        rows = torch.clamp(tiles.start[active, None] + b * BLOCK + lane_ids[None, :],
                           max=max(tiles.gid.shape[0] - 1, 0))
        gid = torch.where(lane, tiles.gid[rows], torch.zeros_like(rows))
        g = geo[gid]
        alpha, t_before, t_new = _block(px[active], py[active], *g.unbind(-1), lane, trans[active])
        visit(Step(active, gid, lane, alpha, alpha * t_before, t_before, inside[active]))
        trans[active] = t_new
        max_t[active] = t_new.max(dim=1).values


def tiles_image(out: torch.Tensor, tiles: Tiles) -> torch.Tensor:
    """(n_tiles, ts*ts, C) -> (H, W, C), the pixels past the image dropped."""
    ts, C = tiles.ts, out.shape[-1]
    img = out.reshape(tiles.nty, tiles.ntx, ts, ts, C).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles.nty * ts, tiles.ntx * ts, C)[:tiles.height, :tiles.width]


def image_tiles(image: torch.Tensor, tiles: Tiles) -> torch.Tensor:
    """(H, W, C) -> (n_tiles, ts*ts, C), zero past the image."""
    ts = tiles.ts
    H, W, C = image.shape
    pad = image.new_zeros((tiles.nty * ts, tiles.ntx * ts, C))
    pad[:H, :W] = image
    return pad.reshape(tiles.nty, ts, tiles.ntx, ts, C).permute(0, 2, 1, 3, 4).reshape(
        tiles.n_tiles, ts * ts, C)


def scene_colors(scene: dict, viewmat: torch.Tensor, degree: int) -> torch.Tensor:
    coeffs = torch.cat([scene["sh0"], scene["shN"]], 1)
    return sh_colors(coeffs, scene["means"], viewmat, degree)


def project_scene(scene: dict, viewmat, K, width: int, height: int) -> dict:
    return project(scene["means"], scene["quats"], torch.exp(scene["log_scales"]),
                   torch.sigmoid(scene["logit_opacities"]), viewmat, K, width, height)
