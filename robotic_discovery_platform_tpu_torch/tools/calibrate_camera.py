"""Camera intrinsics calibration (operator tool; the JAX package's
``tools/calibrate_camera.py``).

The reference's algorithm: a 9x7 checkerboard of 27 mm squares,
``findChessboardCorners`` and ``cornerSubPix`` per view,
``calibrateCamera`` over at least 5 views, the mean reprojection error
reported, and the result saved as an npz with keys ``mtx``/``dist``/
``rvecs``/``tvecs`` at ``CalibrationConfig.output_path``, the path the
server reads (``io/frames.load_calibration``). The corner detection and
the solve are a pure function of images, testable without a camera or a
display. cv2 (and, for the camera, ``pyrealsense2``) is imported where it
is used.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from robotic_discovery_platform_tpu_torch.utils.config import CalibrationConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class CalibrationResult:
    camera_matrix: np.ndarray
    dist_coeffs: np.ndarray
    mean_reprojection_error: float
    n_views: int
    output_path: str | None


def detect_corners(gray: np.ndarray, cfg: CalibrationConfig):
    """Find + subpixel-refine checkerboard corners; None when not found."""
    import cv2

    pattern = (cfg.checkerboard_cols, cfg.checkerboard_rows)
    found, corners = cv2.findChessboardCorners(gray, pattern, None)
    if not found:
        return None
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    return cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1), criteria)


def object_grid(cfg: CalibrationConfig) -> np.ndarray:
    """Planar 3D checkerboard grid in millimeters."""
    cols, rows = cfg.checkerboard_cols, cfg.checkerboard_rows
    grid = np.zeros((cols * rows, 3), np.float32)
    grid[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    return grid * cfg.square_size_mm


def calibrate_from_images(
    images, cfg: CalibrationConfig = CalibrationConfig(), save: bool = True
) -> CalibrationResult:
    """Pure calibration core: grayscale/BGR views -> intrinsics."""
    import cv2

    obj = object_grid(cfg)
    obj_points, img_points = [], []
    shape = None
    for img in images:
        gray = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        shape = gray.shape[::-1]
        corners = detect_corners(gray, cfg)
        if corners is not None:
            obj_points.append(obj)
            img_points.append(corners)
    if len(obj_points) < cfg.min_captures:
        raise ValueError(
            f"found the checkerboard in only {len(obj_points)} of "
            f"{len(images)} views (need >= {cfg.min_captures})"
        )
    rms, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
        obj_points, img_points, shape, None, None
    )

    total_err = 0.0
    for i in range(len(obj_points)):
        proj, _ = cv2.projectPoints(obj_points[i], rvecs[i], tvecs[i], mtx, dist)
        residual = np.asarray(img_points[i], np.float64).reshape(-1, 2) \
            - np.asarray(proj, np.float64).reshape(-1, 2)
        total_err += float(np.linalg.norm(residual)) / len(proj)
    mean_err = total_err / len(obj_points)

    out_path = None
    if save:
        out = Path(cfg.output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, mtx=mtx, dist=dist, rvecs=rvecs, tvecs=tvecs)
        out_path = str(out)
        log.info("calibration saved to %s (reproj err %.4f px)", out, mean_err)
    return CalibrationResult(mtx, dist, float(mean_err), len(obj_points), out_path)


def main(cfg: CalibrationConfig = CalibrationConfig(), source=None) -> None:
    """Interactive capture loop: 'c' captures a view when the checkerboard is
    visible, 'q' finishes and solves."""
    import cv2

    from robotic_discovery_platform_tpu_torch.io.frames import (
        RealSenseSource,
        iter_frames,
    )

    source = source or RealSenseSource()
    source.start()
    captures = []
    try:
        for color, _ in iter_frames(source):
            gray = cv2.cvtColor(color, cv2.COLOR_BGR2GRAY)
            vis = color.copy()
            corners = detect_corners(gray, cfg)
            if corners is not None:
                cv2.drawChessboardCorners(
                    vis, (cfg.checkerboard_cols, cfg.checkerboard_rows),
                    corners, True,
                )
            cv2.putText(vis, f"captures: {len(captures)}  (c=capture q=solve)",
                        (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2)
            cv2.imshow("calibration", vis)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("c") and corners is not None:
                captures.append(gray.copy())
                log.info("captured view %d", len(captures))
            elif key == ord("q"):
                break
    finally:
        source.stop()
        cv2.destroyAllWindows()
    result = calibrate_from_images(captures, cfg)
    log.info("camera matrix:\n%s", result.camera_matrix)


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.utils.config import (
        parse_config,
    )

    main(parse_config().calibration)
