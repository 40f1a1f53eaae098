"""The port's own copy of orb_slam2_2021_tpu/io/synthetic.py: plain Python and
numpy, the same behaviour.

Synthetic stereo/monocular sequence generator for tests and benches.

The reference validates end-to-end on KITTI sequences
(/root/reference/scripts/stereo_kitti_full.sh); no dataset ships in this
environment, so we render our own: a textured fronto-visible world made of
random smooth texture planes at varying depth, viewed by a calibrated stereo
rig moving along a known trajectory. Ground-truth poses give exact ATE for
integration tests; the imagery has dense FAST-detectable texture.

Rendering model: the world is a height-textured "wall" at depth z(x, y)
piecewise constant over a coarse grid; each camera pixel ray samples the
texture via plane-induced homography (per-pixel projective warp computed in
closed form from depth). This produces geometrically consistent stereo pairs
with true disparity = bf / z.
"""

from __future__ import annotations

import numpy as np

from ..config import SlamConfig


def _smooth_texture(rng, h, w, octaves=4):
    """Multi-octave value noise in [0, 255] with lots of corners."""
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        step = 1 << (octaves - o + 2)
        gh, gw = h // step + 2, w // step + 2
        g = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        v = (
            g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += v * (0.5 ** o)
    img -= img.min()
    img /= img.max() + 1e-9
    # add salt-and-pepper blocks for strong FAST corners
    n_dots = (h * w) // 256
    ys = rng.integers(2, h - 3, n_dots)
    xs = rng.integers(2, w - 3, n_dots)
    for y, x in zip(ys, xs):
        img[y - 1 : y + 2, x - 1 : x + 2] = rng.uniform(0, 1)
    return (img * 255.0).astype(np.float32)


class SyntheticStereoWorld:
    """A textured wall world at z in [z_min, z_max] with ground-truth poses."""

    def __init__(self, cfg: SlamConfig, seed=0, tex_scale=4, z_min=4.0, z_max=28.0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        h, w = cfg.height, cfg.width
        # world texture covers a field of view much larger than one frame
        self.tex_h, self.tex_w = h * tex_scale, w * tex_scale
        self.texture = _smooth_texture(rng, self.tex_h, self.tex_w)
        # depth field: coarse piecewise-smooth depth over texture coords
        gh, gw = 24, 24
        depth_grid = rng.uniform(z_min, z_max, (gh, gw)).astype(np.float32)
        # smooth it
        for _ in range(2):
            depth_grid = (
                depth_grid
                + np.roll(depth_grid, 1, 0) + np.roll(depth_grid, -1, 0)
                + np.roll(depth_grid, 1, 1) + np.roll(depth_grid, -1, 1)
            ) / 5.0
        self.depth_grid = depth_grid
        # texture plane: world plane z = depth(x, y) sampled over world x/y
        # world->texture mapping: texture pixel per world meter
        self.ppm = cfg.fx / z_min * 0.55  # keeps texture resolution >= image

    def _depth_at(self, wx, wy):
        """Depth (z) at world (x, y) — bilinear over the coarse grid."""
        gh, gw = self.depth_grid.shape
        # map world coords (meters) into grid; world window ~ [-S, S]
        S = self.tex_w / self.ppm / 2.0
        gx = np.clip((wx / (2 * S) + 0.5) * (gw - 1), 0, gw - 1.001)
        gy = np.clip((wy / (2 * S) + 0.5) * (gh - 1), 0, gh - 1.001)
        x0 = gx.astype(int); y0 = gy.astype(int)
        fx = gx - x0; fy = gy - y0
        d = self.depth_grid
        return (
            d[y0, x0] * (1 - fy) * (1 - fx)
            + d[y0, x0 + 1] * (1 - fy) * fx
            + d[y0 + 1, x0] * fy * (1 - fx)
            + d[y0 + 1, x0 + 1] * fy * fx
        )

    def _sample_texture(self, wx, wy):
        tx = np.clip(wx * self.ppm + self.tex_w / 2.0, 0, self.tex_w - 1.002)
        ty = np.clip(wy * self.ppm + self.tex_h / 2.0, 0, self.tex_h - 1.002)
        x0 = tx.astype(int); y0 = ty.astype(int)
        fx = tx - x0; fy = ty - y0
        t = self.texture
        return (
            t[y0, x0] * (1 - fy) * (1 - fx)
            + t[y0, x0 + 1] * (1 - fy) * fx
            + t[y0 + 1, x0] * fy * (1 - fx)
            + t[y0 + 1, x0 + 1] * fy * fx
        )

    def render(self, R_wc, t_wc):
        """Render a stereo pair from camera-to-world pose (R_wc, t_wc).

        Iterative ray-depth intersection: z along ray solved by fixed-point on
        the smooth depth field (2 iterations suffice for near-frontal views).
        Returns (left, right) float32 [H, W] images.
        """
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))

        out = []
        for eye in (0, 1):
            # right eye offset along camera x by +baseline
            baseline = cfg.bf / cfg.fx
            c = t_wc + R_wc @ np.array([eye * baseline, 0, 0], np.float32)
            # ray directions in world frame (unnormalized, z-forward pinhole)
            dx = (us - cfg.cx) / cfg.fx
            dy = (vs - cfg.cy) / cfg.fy
            dirs = np.stack([dx, dy, np.ones_like(dx)], axis=-1) @ R_wc.T
            dz = np.maximum(dirs[..., 2], 1e-3)
            # fixed point on lam: c_z + lam*d_z = depth_surface(x(lam), y(lam))
            lam = (8.0 - c[2]) / dz
            for _ in range(4):
                px = c[0] + lam * dirs[..., 0]
                py = c[1] + lam * dirs[..., 1]
                lam = (self._depth_at(px, py) - c[2]) / dz
            px = c[0] + lam * dirs[..., 0]
            py = c[1] + lam * dirs[..., 1]
            img = self._sample_texture(px, py)
            out.append(img.astype(np.float32))
        return out[0], out[1]


    def render_rgbd(self, R_wc, t_wc, dist_coef=None):
        """Render (image, depth_map) for the RGB-D path.

        With dist_coef=(k1,k2,p1,p2,k3) the image and depth map are rendered
        through the radial-tangential lens model: output pixel u_d sees the
        scene along the IDEAL ray of its undistorted position, which is what a
        physical distorting camera produces. The inverse model here is a
        float64 host-side fixed-point solve independent of the engine's f32
        undistortion op (ops/undistort.py), so the e2e test is not circular."""
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        xd = (us - cfg.cx) / cfg.fx
        yd = (vs - cfg.cy) / cfg.fy
        if dist_coef is not None and any(dist_coef):
            k1, k2, p1, p2, k3 = dist_coef
            x, y = xd.copy(), yd.copy()
            for _ in range(30):
                r2 = x * x + y * y
                rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
                ddx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                ddy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                x = (xd - ddx) / rad
                y = (yd - ddy) / rad
        else:
            x, y = xd, yd
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.asarray(R_wc, np.float64).T
        c = np.asarray(t_wc, np.float64)
        dz = np.maximum(dirs[..., 2], 1e-3)
        lam = (8.0 - c[2]) / dz
        for _ in range(4):
            px = c[0] + lam * dirs[..., 0]
            py = c[1] + lam * dirs[..., 1]
            lam = (self._depth_at(px, py) - c[2]) / dz
        px = c[0] + lam * dirs[..., 0]
        py = c[1] + lam * dirs[..., 1]
        img = self._sample_texture(px, py).astype(np.float32)
        # depth = camera-frame z of the hit point = lam (ray dir has z=1 in
        # the ideal camera frame before rotation)
        return img, lam.astype(np.float32)


class SyntheticCylinderWorld:
    """Texture on the inside of a cylinder of radius R(theta, y), camera near
    the axis looking radially outward.

    A full-orbit trajectory genuinely revisits its start sector after 360 deg
    of heading change — the loop-closure situation (KITTI-00-style circuit)
    the flat wall world cannot produce: keyframes more than one field of view
    apart in yaw share no scenery, so the return pass builds fresh duplicate
    geometry and the only way to reconnect it to the start is the
    DetectLoop -> ComputeSim3 -> CorrectLoop chain
    (/root/reference/src/LoopClosing.cc:72-103)."""

    def __init__(self, cfg: SlamConfig, seed=0, radius=8.0, radius_jitter=0.18,
                 y_span=12.0):
        self.cfg = cfg
        self.radius = radius
        rng = np.random.default_rng(seed)
        # texture over (theta, y): one wrap of the cylinder
        ppm = cfg.fx / radius * 1.3     # texture px per meter >= image res
        self.tex_w = int(2 * np.pi * radius * ppm)
        self.tex_h = int(y_span * ppm)
        self.y_span = y_span
        self.texture = _smooth_texture(rng, self.tex_h, self.tex_w)
        # radius field R(theta, y): piecewise-smooth bumps for depth variance
        gh, gw = 16, 48
        rg = rng.uniform(radius * (1 - radius_jitter), radius * (1 + radius_jitter),
                         (gh, gw)).astype(np.float32)
        for _ in range(2):
            rg = (rg + np.roll(rg, 1, 0) + np.roll(rg, -1, 0)
                  + np.roll(rg, 1, 1) + np.roll(rg, -1, 1)) / 5.0
        self.radius_grid = rg

    def _radius_at(self, theta, wy):
        gh, gw = self.radius_grid.shape
        gx = (theta / (2 * np.pi) % 1.0) * gw        # wraps in theta
        gy = np.clip((wy / self.y_span + 0.5) * (gh - 1), 0, gh - 1.001)
        x0 = gx.astype(int) % gw
        y0 = gy.astype(int)
        fx = gx - gx.astype(int)
        fy = gy - y0
        r = self.radius_grid
        x1 = (x0 + 1) % gw
        return (
            r[y0, x0] * (1 - fy) * (1 - fx) + r[y0, x1] * (1 - fy) * fx
            + r[y0 + 1, x0] * fy * (1 - fx) + r[y0 + 1, x1] * fy * fx
        )

    def _sample_texture(self, theta, wy):
        tx = (theta / (2 * np.pi) % 1.0) * self.tex_w
        ty = np.clip((wy / self.y_span + 0.5) * (self.tex_h - 1), 0, self.tex_h - 1.002)
        x0 = tx.astype(int) % self.tex_w
        x1 = (x0 + 1) % self.tex_w
        y0 = ty.astype(int)
        fx = tx - tx.astype(int)
        fy = ty - y0
        t = self.texture
        return (
            t[y0, x0] * (1 - fy) * (1 - fx) + t[y0, x1] * (1 - fy) * fx
            + t[y0 + 1, x0] * fy * (1 - fx) + t[y0 + 1, x1] * fy * fx
        )

    def _trace(self, c, dirs):
        """Ray-cylinder intersection: lam s.t. |(c + lam d)_{xz}| = R(hit).
        Closed-form quadratic for the mean radius, then fixed-point on the
        radius field."""
        dx, dy_, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        a = dx * dx + dz * dz
        b = 2.0 * (c[0] * dx + c[2] * dz)
        R0 = self.radius
        lam = None
        for _ in range(4):
            Rr = R0 if lam is None else self._radius_at(
                np.arctan2(c[0] + lam * dx, c[2] + lam * dz),
                c[1] + lam * dy_,
            )
            c0 = c[0] * c[0] + c[2] * c[2] - Rr * Rr
            disc = np.maximum(b * b - 4 * a * c0, 1e-12)
            lam = (-b + np.sqrt(disc)) / (2 * np.maximum(a, 1e-12))
        px = c[0] + lam * dx
        py = c[1] + lam * dy_
        pz = c[2] + lam * dz
        theta = np.arctan2(px, pz)
        return lam, theta, py

    def render(self, R_wc, t_wc):
        """Stereo pair from camera-to-world pose; camera z points outward."""
        cfg = self.cfg
        h, w = cfg.height, cfg.width
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        out = []
        baseline = cfg.bf / cfg.fx
        for eye in (0, 1):
            c = t_wc + R_wc @ np.array([eye * baseline, 0, 0], np.float32)
            dxp = (us - cfg.cx) / cfg.fx
            dyp = (vs - cfg.cy) / cfg.fy
            dirs = np.stack([dxp, dyp, np.ones_like(dxp)], axis=-1) @ R_wc.T
            lam, theta, py = self._trace(c, dirs)
            out.append(self._sample_texture(theta, py).astype(np.float32))
        return out[0], out[1]


def orbit_trajectory(n_frames, total_deg=440.0, r_orbit=1.5):
    """Camera orbiting the cylinder axis facing outward: yaw sweeps
    `total_deg` (beyond 360 so the start sector is re-observed over a long
    arc). Ground-truth camera-to-world poses (R_wc, t_wc)."""
    poses = []
    for i in range(n_frames):
        yaw = np.deg2rad(total_deg) * i / max(n_frames - 1, 1)
        R = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float32,
        )
        t = np.array([r_orbit * np.sin(yaw), 0.0, r_orbit * np.cos(yaw)],
                     np.float32)
        poses.append((R, t))
    return poses


def forward_trajectory(n_frames, step=0.08, yaw_rate=0.0, lateral_amp=0.0):
    """Ground-truth camera-to-world poses: mostly lateral dolly with optional
    yaw. Returns list of (R_wc [3,3], t_wc [3]) float32."""
    poses = []
    yaw = 0.0
    pos = np.zeros(3, np.float32)
    for i in range(n_frames):
        R = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float32,
        )
        poses.append((R.copy(), pos.copy()))
        # move sideways (keeps the textured wall in view) + slight dolly
        pos = pos + R @ np.array(
            [step, lateral_amp * np.sin(i * 0.15), step * 0.15], np.float32
        )
        yaw += yaw_rate
    return poses
