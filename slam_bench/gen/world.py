"""The generator `world`: a textured wall world rendered on the device.

A traffic file names its generator (`"generator": "world"`), a module of
this folder that the harness finds by that name. Each such module has
`params(d)` (the file's parameters, with `warmup_frames` and
`check_frames`), `generate(...)` (the run's frames and their ground truth)
and `map_error_percent(points, surface)` (the map check against its world).

A plain-PyTorch rewrite of the port's `io/synthetic.py` wall world
(`SyntheticStereoWorld.render` and `render_rgbd`): a wall at depth z(x, y),
piecewise smooth over a coarse grid, carrying multi-octave value noise with
small bright and dark blocks for corners; a camera ray meets it by a
fixed-point solve on the depth field. What differs from that file:

- every random number comes from one `torch.Generator` on the render
  device, seeded by `--seed`;
- the world is as wide as the whole path needs: its extent is worked out
  from the frames' corner rays at the nearest and farthest depth, so the
  texture never repeats and the camera never sees past its edge;
- the corner blocks sit one to a 16-pixel cell, so they never overlap and
  the texture is the same on every run of a seed;
- frames are rendered in batches on the device, then handed over as host
  uint8 arrays (and uint16 depth maps in DepthMapFactor units), as a camera
  hands them over.

The trajectory is a sideways dolly with an optional vertical bob and a
sinusoidal yaw, all from the traffic file.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..reference.checks import map_error_percent  # noqa: F401  (the map check of this world)

DOT_CELL = 16          # one corner block of 3x3 texels per 16x16-texel cell
NOISE_OCTAVES = 4
RAY_ITERS = 4          # fixed-point steps of the ray-wall solve
LENS_ITERS = 30        # steps of the inverse lens model (float64)


@dataclass(frozen=True)
class Traffic:
    """A traffic file's parameters (see traffic/*.json)."""
    z_min_m: float
    z_max_m: float
    depth_cell_m: float
    texels_per_px_at_z_min: float
    step_m: float
    bob_m: float
    bob_period_frames: int
    yaw_deg: float
    yaw_period_frames: int
    warmup_frames: int
    check_frames: int

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})


def trajectory(tr: Traffic, n_frames: int) -> np.ndarray:
    """[n, 4, 4] float64 camera-to-world poses: x advances `step_m` a frame,
    y bobs, the camera yaws about its y axis; frame 0 is the identity."""
    i = np.arange(n_frames, dtype=np.float64)
    yaw = np.zeros(n_frames)
    y = np.zeros(n_frames)
    if tr.yaw_period_frames > 0:
        yaw = np.deg2rad(tr.yaw_deg) * np.sin(2 * np.pi * i / tr.yaw_period_frames)
    if tr.bob_period_frames > 0:
        y = tr.bob_m * np.sin(2 * np.pi * i / tr.bob_period_frames)
    T = np.tile(np.eye(4), (n_frames, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0], T[:, 0, 2], T[:, 2, 0], T[:, 2, 2] = c, s, -s, c
    T[:, 0, 3], T[:, 1, 3] = tr.step_m * i, y
    return T


def pixel_rays(cam, device, dist_coef=None) -> torch.Tensor:
    """[H, W, 3] float32 camera-frame ray directions (z = 1) of each pixel;
    through the radial-tangential lens when `dist_coef` is non-zero (the
    ideal ray a distorting camera's pixel sees, solved in float64)."""
    h, w = cam.height, cam.width
    vs, us = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    xd, yd = (us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy
    x, y = xd, yd
    if dist_coef is not None and any(dist_coef):
        k1, k2, p1, p2, k3 = dist_coef
        x, y = xd.copy(), yd.copy()
        for _ in range(LENS_ITERS):
            r2 = x * x + y * y
            rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
            x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / rad
            y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / rad
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    return torch.from_numpy(rays.astype(np.float32)).to(device)


def _extent(poses: np.ndarray, rays: torch.Tensor, baseline: float, tr: Traffic):
    """(x0, x1, y0, y1): the world rectangle every frame's corner rays meet
    between the nearest and farthest depth, with a 5% margin."""
    h, w = rays.shape[:2]
    corners = rays[[0, 0, h - 1, h - 1], [0, w - 1, 0, w - 1]].double().cpu().numpy()   # [4, 3]
    pts = []
    for eye in (0.0, baseline):
        c = poses[:, :3, 3] + poses[:, :3, 0] * eye                                   # [n, 3]
        d = np.einsum("nij,kj->nki", poses[:, :3, :3], corners)                      # [n, 4, 3]
        for z in (tr.z_min_m, tr.z_max_m):
            lam = (z - c[:, None, 2]) / np.maximum(d[..., 2], 1e-3)
            pts.append(c[:, None, :2] + lam[..., None] * d[..., :2])
    p = np.concatenate([q.reshape(-1, 2) for q in pts])
    lo, hi = p.min(0), p.max(0)
    pad = 0.05 * (hi - lo) + 0.5
    return lo[0] - pad[0], hi[0] + pad[0], lo[1] - pad[1], hi[1] + pad[1]


def _value_noise(g: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """[h, w] float32 multi-octave value noise in [0, 1] with a 3x3 block of
    random grey in each 16x16 cell (the FAST corners)."""
    img = torch.zeros((h, w), dtype=torch.float32, device=device)
    for o in range(NOISE_OCTAVES):
        step = 1 << (NOISE_OCTAVES - o + 2)
        gh, gw = h // step + 2, w // step + 2
        grid = torch.rand((gh, gw), generator=g, device=device)
        ys = torch.linspace(0, gh - 1.001, h, device=device)
        xs = torch.linspace(0, gw - 1.001, w, device=device)
        y0, x0 = ys.long(), xs.long()
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        img += (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0][:, x0 + 1] * (1 - fy) * fx
                + grid[y0 + 1][:, x0] * fy * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fy * fx) * 0.5 ** o
    img -= img.min()
    img /= img.max() + 1e-9
    ch, cw = h // DOT_CELL, w // DOT_CELL
    off = torch.randint(1, DOT_CELL - 1, (2, ch, cw), generator=g, device=device)
    val = torch.rand((ch, cw), generator=g, device=device)
    cy = torch.arange(ch, device=device)[:, None] * DOT_CELL + off[0]
    cx = torch.arange(cw, device=device)[None, :] * DOT_CELL + off[1]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[(cy + dy).clamp(0, h - 1), (cx + dx).clamp(0, w - 1)] = val
    return img * 255.0


class WallWorld:
    """The wall world of one seed, sized for `poses` seen through `rays`."""

    def __init__(self, tr: Traffic, cam, seed: int, poses: np.ndarray, rays: torch.Tensor,
                 baseline: float, device):
        self.tr, self.device = tr, torch.device(device)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) % (1 << 63))
        x0, x1, y0, y1 = _extent(poses, rays, baseline, tr)
        self.ppm = cam.fx / tr.z_min_m * tr.texels_per_px_at_z_min   # texels per metre
        self.x0, self.y0, self.cell = x0, y0, tr.depth_cell_m
        self.tex_w = int(math.ceil((x1 - x0) * self.ppm)) + 2
        self.tex_h = int(math.ceil((y1 - y0) * self.ppm)) + 2
        self.texture = _value_noise(g, self.tex_h, self.tex_w, self.device)
        gw = int(math.ceil((x1 - x0) / self.cell)) + 2
        gh = int(math.ceil((y1 - y0) / self.cell)) + 2
        d = tr.z_min_m + (tr.z_max_m - tr.z_min_m) * torch.rand((gh, gw), generator=g, device=self.device)
        for _ in range(2):
            p = torch.nn.functional.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
            d = (p[1:-1, 1:-1] + p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) / 5.0
        self.depth_grid = d

    def surface(self) -> dict:
        """What the correctness check needs of the world: the depth grid on
        the host and where it lies."""
        return {"depth_grid": self.depth_grid.double().cpu().numpy(), "x0": self.x0, "y0": self.y0,
                "cell": self.cell}

    def _bilinear(self, a, gx, gy):
        h, w = a.shape
        gx = gx.clamp(0.0, w - 1.001)
        gy = gy.clamp(0.0, h - 1.001)
        ix, iy = gx.long(), gy.long()
        fx, fy = gx - ix, gy - iy
        return (a[iy, ix] * (1 - fy) * (1 - fx) + a[iy, ix + 1] * (1 - fy) * fx
                + a[iy + 1, ix] * fy * (1 - fx) + a[iy + 1, ix + 1] * fy * fx)

    def depth_at(self, x, y):
        return self._bilinear(self.depth_grid, (x - self.x0) / self.cell, (y - self.y0) / self.cell)

    def trace(self, c, dirs):
        """Rays from centres c [B, 3] along dirs [B, H, W, 3] (camera z = 1):
        (lam, grey) where lam is the camera-frame depth of the hit."""
        cx, cy, cz = (c[:, i, None, None] for i in range(3))
        dz = dirs[..., 2].clamp_min(1e-3)
        lam = (0.5 * (self.tr.z_min_m + self.tr.z_max_m) - cz) / dz
        for _ in range(RAY_ITERS):
            lam = (self.depth_at(cx + lam * dirs[..., 0], cy + lam * dirs[..., 1]) - cz) / dz
        px, py = cx + lam * dirs[..., 0], cy + lam * dirs[..., 1]
        grey = self._bilinear(self.texture, (px - self.x0) * self.ppm, (py - self.y0) * self.ppm)
        return lam, grey


def render(world: WallWorld, poses: np.ndarray, rays: torch.Tensor, sensor: str, baseline: float,
           depth_factor: float, batch: int = 16):
    """Host arrays of every frame: stereo -> [n, 2, H, W] uint8 pairs;
    rgbd -> ([n, H, W] uint8 grey, [n, H, W] uint16 depth in DepthMapFactor
    units); mono -> ([n, H, W] uint8 grey, None)."""
    n = len(poses)
    h, w = rays.shape[:2]
    dev = world.device
    imgs = np.empty((n, 2 if sensor == "stereo" else 1, h, w), np.uint8)
    depth = np.empty((n, h, w), np.uint16) if sensor == "rgbd" else None
    P = torch.from_numpy(poses.astype(np.float32)).to(dev)
    for s in range(0, n, batch):
        R, t = P[s:s + batch, :3, :3], P[s:s + batch, :3, 3]
        dirs = torch.einsum("bij,hwj->bhwi", R, rays)
        eyes = (0.0, baseline) if sensor == "stereo" else (0.0,)
        for e, off in enumerate(eyes):
            lam, grey = world.trace(t + R[:, :, 0] * off, dirs)
            imgs[s:s + batch, e] = grey.clamp(0, 255).to(torch.uint8).cpu().numpy()
            if depth is not None:
                depth[s:s + batch] = (lam * depth_factor).round().clamp(0, 65535).to(
                    torch.int32).cpu().numpy().astype(np.uint16)
    return (imgs, None) if sensor == "stereo" else (imgs[:, 0], depth)


def params(d: dict) -> Traffic:
    """A traffic file's parameters (the other keys are notes)."""
    return Traffic.from_dict(d)


def generate(tr: Traffic, settings, sensor: str, seed: int, n_frames: int, device):
    """The frames of a run and their ground truth: (poses [n, 4, 4]
    camera-to-world, images and depth maps as `render` gives them, the
    surface for `map_error_percent`)."""
    poses = trajectory(tr, n_frames)
    baseline = settings.bf / settings.fx
    rays = pixel_rays(settings, device, settings.dist_coef)
    world = WallWorld(tr, settings, seed, poses, rays, baseline, device)
    imgs, depth = render(world, poses, rays, sensor, baseline, settings.depth_map_factor)
    return poses, imgs, depth, world.surface()
