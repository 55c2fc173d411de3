"""Frame sources for the port, numpy only.

- :func:`render_scene`: the JAX package's synthetic actuator scene
  (``training/synthetic.render_scene``), copied: a curved band over a
  textured background with its exact mask and a z16 depth frame.
- :class:`SyntheticSource`: a deterministic stream of those scenes, as a
  camera delivers them (BGR color, z16 depth), with RealSense-like
  intrinsics (``io/frames.SyntheticSource``).
- :func:`load_calibration`: the calibration npz reader.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def render_scene(rng: np.random.Generator, h: int = 480, w: int = 640):
    """One (image_u8 [h,w,3], mask_u8 [h,w], depth_u16 [h,w]) sample.

    The actuator is a band of pixels between two vertical offsets of a random
    circular arc -- matching the soft-actuator silhouettes the reference
    pipeline segments, with randomized radius (hence curvature), pose,
    thickness, color, lighting, and background clutter.
    """
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))

    # --- background: low-frequency color gradient + speckle
    base = rng.uniform(40, 160, size=3).astype(np.float32)
    gx = rng.uniform(-40, 40, size=3).astype(np.float32)
    gy = rng.uniform(-40, 40, size=3).astype(np.float32)
    img = (
        base[None, None, :]
        + gx[None, None, :] * (uu / w)[..., None]
        + gy[None, None, :] * (vv / h)[..., None]
    )
    img += rng.normal(0, 8, size=(h, w, 3)).astype(np.float32)

    # distractor blobs
    for _ in range(rng.integers(0, 4)):
        bx, by = rng.uniform(0, w), rng.uniform(0, h)
        br = rng.uniform(10, 60)
        blob = ((uu - bx) ** 2 + (vv - by) ** 2) < br ** 2
        img[blob] = rng.uniform(0, 255, size=3)

    # --- actuator band along a random arc (parameters relative to frame
    # size; the arc apex is anchored inside the image so masks are nonempty
    # at any resolution)
    r_px = rng.uniform(0.5, 2.5) * w
    cx = rng.uniform(0.3 * w, 0.7 * w)
    v_apex = rng.uniform(0.35, 0.85) * h  # lowest arc point, at u == cx
    cy_top = v_apex - r_px
    thickness = rng.uniform(0.12, 0.3) * h
    half_span = rng.uniform(0.25, 0.45) * w
    inside = np.abs(uu - cx) <= min(half_span, 0.95 * r_px)
    v_edge = cy_top + np.sqrt(np.maximum(r_px ** 2 - (uu - cx) ** 2, 0.0))
    mask = inside & (vv <= v_edge) & (vv >= v_edge - thickness)

    color = rng.uniform(0, 255, size=3).astype(np.float32)
    shade = 1.0 - 0.4 * np.clip((v_edge - vv) / max(thickness, 1), 0, 1)
    img[mask] = color[None, :] * shade[mask][:, None]
    img = np.clip(img, 0, 255).astype(np.uint8)

    # --- depth: flat backdrop, actuator slightly closer, mm units (z16)
    z_back = rng.uniform(700, 1200)
    z_act = z_back - rng.uniform(80, 250)
    depth = np.full((h, w), z_back, np.float32)
    depth[mask] = z_act
    depth += rng.normal(0, 2, size=(h, w))
    depth = np.clip(depth, 0, 65535).astype(np.uint16)

    return img, mask.astype(np.uint8) * 255, depth


class SyntheticSource:
    """Deterministic stream of rendered actuator scenes."""

    def __init__(self, width: int = 640, height: int = 480, seed: int = 0,
                 n_frames: int | None = None):
        self.width, self.height = width, height
        self.seed = seed
        self.n_frames = n_frames
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def start(self) -> None:
        self._count = 0
        self._rng = np.random.default_rng(self.seed)

    def stop(self) -> None:
        pass

    @property
    def depth_scale(self) -> float:
        return 0.001

    def get_frames(self):
        """(color_bgr [H, W, 3] u8, depth [H, W] u16), or (None, None)
        after ``n_frames``."""
        if self.n_frames is not None and self._count >= self.n_frames:
            return None, None
        self._count += 1
        img_rgb, _, depth = render_scene(self._rng, self.height, self.width)
        return img_rgb[..., ::-1].copy(), depth  # BGR like a real camera

    def intrinsics(self) -> np.ndarray:
        f = 0.94 * self.width  # RealSense-like FOV
        return np.array(
            [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1]],
            np.float64,
        )


def load_calibration(path: str | Path
                     ) -> tuple[np.ndarray, np.ndarray, float | None]:
    """Read (intrinsics 3x3, distortion, depth_scale|None) from the
    calibration npz (keys mtx/dist/depth_scale)."""
    data = np.load(path)
    if "mtx" not in data or "dist" not in data:
        raise KeyError(f"{path} missing 'mtx'/'dist' calibration keys")
    scale = float(data["depth_scale"]) if "depth_scale" in data else None
    return data["mtx"], data["dist"], scale
