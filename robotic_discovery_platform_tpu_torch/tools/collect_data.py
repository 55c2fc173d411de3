"""Raw data collection (operator tool; the JAX package's
``tools/collect_data.py``).

The reference collector's capture layout: a directory per run,
``<root>/capture_<unix>/{color,depth}``, color saved as PNG and depth as
raw ``.npy`` z16 arrays, one pair every ``capture_interval_s``. The
capture core is headless and takes any frame source
(``io/frames.ReplaySource`` plays these directories back); the
interactive 's'-toggle / 'q'-quit window wraps it where a display exists.
cv2 (and, for the camera, ``pyrealsense2``) is imported where it is used.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from robotic_discovery_platform_tpu_torch.io.frames import (
    FrameSource,
    iter_frames,
)
from robotic_discovery_platform_tpu_torch.utils.config import CollectConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def new_capture_dir(root: str | Path) -> Path:
    run = Path(root) / f"capture_{int(time.time())}"
    (run / "color").mkdir(parents=True, exist_ok=True)
    (run / "depth").mkdir(parents=True, exist_ok=True)
    return run


def save_pair(run_dir: Path, index: int, color_bgr: np.ndarray,
              depth: np.ndarray) -> str:
    import cv2

    stem = f"frame_{index:06d}"
    cv2.imwrite(str(run_dir / "color" / f"{stem}.png"), color_bgr)
    np.save(run_dir / "depth" / f"{stem}.npy", depth)
    return stem


def collect(source: FrameSource, cfg: CollectConfig = CollectConfig(),
            n_frames: int = 10, interval_s: float | None = None) -> Path:
    """Headless collection: save ``n_frames`` pairs at the configured
    cadence. Returns the run directory (replayable by ReplaySource)."""
    interval = cfg.capture_interval_s if interval_s is None else interval_s
    run_dir = new_capture_dir(cfg.output_root)
    source.start()
    saved = 0
    try:
        last = 0.0
        for color, depth in iter_frames(source):
            now = time.monotonic()
            if now - last < interval:
                continue
            last = now
            save_pair(run_dir, saved, color, depth)
            saved += 1
            if saved >= n_frames:
                break
    finally:
        source.stop()
    log.info("saved %d pairs under %s", saved, run_dir)
    return run_dir


def main(cfg: CollectConfig = CollectConfig(), source=None) -> None:
    """Interactive loop: 's' toggles saving, 'q' quits."""
    import cv2

    from robotic_discovery_platform_tpu_torch.io.frames import (
        RealSenseSource,
    )

    source = source or RealSenseSource()
    run_dir = new_capture_dir(cfg.output_root)
    source.start()
    saving = False
    saved = 0
    last = 0.0
    try:
        for color, depth in iter_frames(source):
            now = time.monotonic()
            if saving and now - last >= cfg.capture_interval_s:
                last = now
                save_pair(run_dir, saved, color, depth)
                saved += 1
            vis = color.copy()
            status = f"SAVING ({saved})" if saving else f"paused ({saved})"
            cv2.putText(vis, f"{status}  (s=toggle q=quit)", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                        (0, 0, 255) if saving else (0, 255, 0), 2)
            cv2.imshow("data collection", vis)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("s"):
                saving = not saving
            elif key == ord("q"):
                break
    finally:
        source.stop()
        cv2.destroyAllWindows()
    log.info("collection finished: %d pairs in %s", saved, run_dir)


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.utils.config import (
        parse_config,
    )

    main(parse_config().collect)
