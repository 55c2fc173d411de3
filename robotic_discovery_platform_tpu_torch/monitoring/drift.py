"""Drift detection over the serving metrics CSV (the port of the JAX
package's ``monitoring/drift.py``).

Same data contract and decision rule as the JAX detector: consume the CSV
that ``serving/metrics.MetricsWriter`` writes, require >= ``min_rows``
valid rows, treat the first ``baseline_fraction`` of the log as the
baseline, and flag drift when the recent mean ``mask_coverage_percent``
deviates from the baseline mean by more than ``threshold`` (relative) OR
when the baseline and recent halves, compared as distributions with the
online monitor's scoring code (``monitoring/profile.score_sketches`` over
:class:`~..observability.sketch.StreamingSketch` histograms), score a PSI
above ``psi_threshold`` plus its noise floor. A malformed or truncated
row (a half-written last line from a killed server, a non-numeric cell)
is dropped and counted in ``DriftReport.n_dropped``; the min-rows gate
applies to the valid rows.

What differs from the JAX module: the CSV is read with the standard
library instead of pandas, and the report figure (raw series, rolling
mean, shaded baseline and recent spans) is drawn with numpy into a PNG
instead of with matplotlib, since the port needs neither package. The
report's numbers are the JAX module's.
"""

from __future__ import annotations

import csv
import math
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from robotic_discovery_platform_tpu_torch.monitoring import (
    profile as profile_lib,
)
from robotic_discovery_platform_tpu_torch.observability.sketch import (
    StreamingSketch,
)
from robotic_discovery_platform_tpu_torch.utils.config import DriftConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: The CSV column's declared range, matching the online monitor's
#: ``SERVING_SIGNALS["mask_coverage"]`` so both paths bin identically.
_COVERAGE_SPEC = profile_lib.SERVING_SIGNALS["mask_coverage"]
_COLUMN = "mask_coverage_percent"


@dataclass
class DriftReport:
    analyzed: bool  # False when the log is too short
    drifted: bool
    baseline_mean: float
    recent_mean: float
    relative_change: float
    n_rows: int
    report_path: str | None
    reason: str
    # distribution scores (shared with the online monitor)
    psi: float = 0.0
    js: float = 0.0
    n_dropped: int = 0


def _number(cell: str | None) -> float:
    """A cell as a float, NaN when missing or not a number (pandas'
    ``to_numeric(errors="coerce")``)."""
    try:
        return float(cell)
    except (TypeError, ValueError):
        return math.nan


def _read_column(path: Path) -> tuple[list[str], np.ndarray]:
    """The CSV's header and its coverage column as float64 (NaN where a
    row lacks the cell or it is not a number); blank lines are skipped,
    as pandas skips them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return [], np.zeros(0)
    header, body = rows[0], rows[1:]
    if _COLUMN not in header:
        return header, np.full(len(body), math.nan)
    j = header.index(_COLUMN)
    return header, np.asarray(
        [_number(r[j] if j < len(r) else None) for r in body], np.float64)


def analyze_drift(cfg: DriftConfig = DriftConfig(),
                  render: bool = True) -> DriftReport:
    path = Path(cfg.metrics_csv)
    if not path.exists():
        return DriftReport(False, False, 0.0, 0.0, 0.0, 0, None,
                           f"no metrics log at {path}")
    header, col = _read_column(path)
    n_raw = len(col)
    if _COLUMN not in header:
        return DriftReport(
            False, False, 0.0, 0.0, 0.0, 0, None,
            f"{path} has no {_COLUMN} column", n_dropped=n_raw,
        )
    # a truncated last line or a non-numeric cell must not poison the
    # means (NaN) or raise: keep only finite rows
    col = col[np.isfinite(col)]
    n = len(col)
    n_dropped = n_raw - n
    dropped_note = (
        f" ({n_dropped} malformed/non-finite row(s) dropped)"
        if n_dropped else ""
    )
    if n < cfg.min_rows:
        return DriftReport(
            False, False, 0.0, 0.0, 0.0, n, None,
            f"only {n} valid rows (< {cfg.min_rows}); not enough "
            f"data{dropped_note}",
            n_dropped=n_dropped,
        )

    split = int(n * cfg.baseline_fraction)
    baseline = col[:split]
    recent = col[split:]
    b_mean = float(baseline.mean())
    r_mean = float(recent.mean())
    change = abs(r_mean - b_mean) / max(abs(b_mean), 1e-9)
    # the same scoring code the online DriftMonitor runs per window:
    # baseline-vs-recent as distributions over the shared binning
    lo, hi, bins = _COVERAGE_SPEC
    score = profile_lib.score_sketches(
        StreamingSketch.from_values(lo, hi, bins, baseline),
        StreamingSketch.from_values(lo, hi, bins, recent),
    )
    drifted = change > cfg.threshold or score.exceeds(cfg.psi_threshold)

    report_path = None
    if render:
        report_path = _render_report(cfg, col, split)

    reason = (
        f"mask coverage mean moved {change:.1%} "
        f"({b_mean:.2f} -> {r_mean:.2f}); threshold {cfg.threshold:.0%}; "
        f"psi {score.psi:.3f} (threshold {cfg.psi_threshold} + noise "
        f"floor {score.noise_floor:.3f}), js {score.js:.3f}{dropped_note}"
    )
    if drifted:
        log.warning("DRIFT DETECTED: %s -- recommend running the retraining "
                    "pipeline (workflows.retraining)", reason)
    else:
        log.info("no drift: %s", reason)
    return DriftReport(True, drifted, b_mean, r_mean, change, n, report_path,
                       reason, psi=score.psi, js=score.js,
                       n_dropped=n_dropped)


def _rolling_mean(series: np.ndarray, window: int) -> np.ndarray:
    """pandas' ``rolling(window, min_periods=1).mean()``."""
    c = np.concatenate([[0.0], np.cumsum(series)])
    i = np.arange(1, len(series) + 1)
    lo = np.maximum(i - window, 0)
    return (c[i] - c[lo]) / (i - lo)


def _png_rgb(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> an RGB PNG (filter 0 on every row)."""
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _render_report(cfg: DriftConfig, series: np.ndarray, split: int) -> str:
    """The report figure: the baseline span shaded green and the recent
    span orange, the raw coverage series in light blue and its rolling
    mean in dark blue, on a 0-100 % vertical axis; (50 s) x (100 s)
    pixels with s = ``report_dpi // 15``."""
    scale = max(1, cfg.report_dpi // 15)
    h, w = 50 * scale, 100 * scale
    img = np.full((h, w, 3), 255, np.uint8)
    n = len(series)
    x_split = int(round(split / max(n, 1) * (w - 1)))
    img[:, :x_split] = (225, 240, 225)
    img[:, x_split:] = (250, 232, 215)

    def plot(values: np.ndarray, color: tuple, thick: int) -> None:
        xs = np.linspace(0, w - 1, num=max(w, n)).round().astype(int)
        ys = np.interp(np.linspace(0, n - 1, num=len(xs)), np.arange(n),
                       values)
        rows = ((1.0 - np.clip(ys, 0.0, 100.0) / 100.0) * (h - 1)).round()
        rows = rows.astype(int)
        for d in range(-(thick // 2), thick - thick // 2):
            img[np.clip(rows + d, 0, h - 1), xs] = color

    plot(series, (160, 190, 230), 1)
    plot(_rolling_mean(series, cfg.rolling_window), (31, 80, 160),
         max(2, scale // 2))
    out = Path(cfg.report_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(_png_rgb(img))
    return str(out)


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.utils.config import parse_config

    analyze_drift(parse_config().drift)
