"""Frame sources for the port (the JAX package's ``io/frames.py``).

Every consumer (the client, tests, tools) takes a :class:`FrameSource`:

- :func:`render_scene`: the JAX package's synthetic actuator scene
  (``training/synthetic.render_scene``), copied: a curved band over a
  textured background with its exact mask and a z16 depth frame.
- :class:`SyntheticSource`: a deterministic stream of those scenes, as a
  camera delivers them (BGR color, z16 depth), with RealSense-like
  intrinsics.
- :class:`ReplaySource`: replays the collector's ``color/*.png`` +
  ``depth/*.npy`` pairs (``cv2`` reads the PNGs, imported when a frame is
  read).
- :class:`RealSenseSource`: the live D4XX camera; ``pyrealsense2`` is
  imported at construction, so the module imports without it.
- :func:`iter_frames` over a started source, and :func:`load_calibration`,
  the calibration npz reader.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Iterator, Protocol

import numpy as np

from robotic_discovery_platform_tpu_torch.resilience import RetryPolicy
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class FrameSource(Protocol):
    """A source of aligned (color_bgr_u8 [H,W,3], depth_u16 [H,W]) pairs."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def get_frames(self) -> tuple[np.ndarray, np.ndarray] | tuple[None, None]: ...

    @property
    def depth_scale(self) -> float: ...


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


class ReplaySource:
    """Replays a collection directory: ``color/*.png`` + ``depth/*.npy``
    pairs, the collector tool's layout."""

    def __init__(self, root: str | Path, loop: bool = True,
                 depth_scale: float = 0.001):
        self.root = Path(root)
        self.loop = loop
        self._depth_scale = depth_scale
        color_dir = self.root / "color"
        depth_dir = self.root / "depth"
        if not color_dir.is_dir() or not depth_dir.is_dir():
            raise FileNotFoundError(
                f"{self.root} needs color/ and depth/ subdirs")
        self.stems = sorted(
            p.stem for p in color_dir.glob("*.png")
            if (depth_dir / f"{p.stem}.npy").exists()
        )
        if not self.stems:
            raise FileNotFoundError(f"no replayable pairs under {self.root}")
        self._idx = 0

    def start(self) -> None:
        self._idx = 0

    def stop(self) -> None:
        pass

    @property
    def depth_scale(self) -> float:
        return self._depth_scale

    def get_frames(self):
        import cv2

        if self._idx >= len(self.stems):
            if not self.loop:
                return None, None
            self._idx = 0
        stem = self.stems[self._idx]
        self._idx += 1
        color = cv2.imread(str(self.root / "color" / f"{stem}.png"),
                           cv2.IMREAD_COLOR)
        depth = np.load(self.root / "depth" / f"{stem}.npy")
        return color, depth.astype(np.uint16)


class RealSenseSource:
    """Live Intel RealSense D4XX capture. ``pyrealsense2`` is imported at
    construction. A daemon thread blocks on the camera, aligns depth to
    color, and publishes the latest fully copied pair under a lock; a
    disconnect backs off on a :class:`~resilience.RetryPolicy` (unlimited
    attempts, jittered, capped at 2 s) and reconnects."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30,
                 retry: RetryPolicy | None = None):
        import pyrealsense2 as rs  # the camera's library, where installed

        self._rs = rs
        self._retry = retry or RetryPolicy(
            max_attempts=None, base_delay_s=0.1, max_delay_s=2.0,
        )
        self.width, self.height, self.fps = width, height, fps
        self._pipeline = rs.pipeline()
        self._config = rs.config()
        self._config.enable_stream(rs.stream.depth, width, height,
                                   rs.format.z16, fps)
        self._config.enable_stream(rs.stream.color, width, height,
                                   rs.format.bgr8, fps)
        self._align = None
        self._depth_scale = 0.001
        self._latest: tuple[np.ndarray, np.ndarray] | None = None  # guarded_by: _lock
        self._lock = checked_lock("frames.realsense")
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        rs = self._rs
        profile = self._pipeline.start(self._config)
        self._align = rs.align(rs.stream.color)
        self._depth_scale = float(
            profile.get_device().first_depth_sensor().get_depth_scale()
        )
        self._stopped.clear()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        backoff = None
        while not self._stopped.is_set():
            try:
                frames = self._pipeline.wait_for_frames()
                aligned = self._align.process(frames)
                depth = aligned.get_depth_frame()
                color = aligned.get_color_frame()
                if not depth or not color:
                    continue
                pair = (
                    np.asanyarray(color.get_data()).copy(),
                    np.asanyarray(depth.get_data()).copy(),
                )
                with self._lock:
                    self._latest = pair
                backoff = None  # healthy: the next outage starts from base
            except RuntimeError as exc:
                # a camera disconnect: back off on the stop event, so
                # stop() answers during the wait
                if backoff is None:
                    backoff = self._retry.delays()
                delay = next(backoff)
                log.warning("camera read failed (%s); reconnecting in %.2fs",
                            exc, delay)
                self._stopped.wait(delay)

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._pipeline.stop()

    @property
    def depth_scale(self) -> float:
        return self._depth_scale

    def get_frames(self):
        with self._lock:
            if self._latest is None:
                return None, None
            return self._latest  # already copied in the reader thread


def iter_frames(source: FrameSource, max_frames: int | None = None,
                poll_s: float = 0.005
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Iterate a started source; stops on (None, None) or after
    ``max_frames`` (a live camera with no frame yet is polled)."""
    n = 0
    while max_frames is None or n < max_frames:
        color, depth = source.get_frames()
        if color is None:
            if isinstance(source, RealSenseSource):
                time.sleep(poll_s)
                continue
            return
        yield color, depth
        n += 1


def load_calibration(path: str | Path
                     ) -> tuple[np.ndarray, np.ndarray, float | None]:
    """Read (intrinsics 3x3, distortion, depth_scale|None) from the
    calibration npz (keys mtx/dist/depth_scale)."""
    data = np.load(path)
    if "mtx" not in data or "dist" not in data:
        raise KeyError(f"{path} missing 'mtx'/'dist' calibration keys")
    scale = float(data["depth_scale"]) if "depth_scale" in data else None
    return data["mtx"], data["dist"], scale
