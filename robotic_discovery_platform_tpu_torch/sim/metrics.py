"""LOADBENCH-shaped row summaries for twin runs and card legs (the port's
copy of the JAX package's ``sim/metrics.py``).

Key for key identical to ``bench_load.summarize_level`` (same
percentiles, same rounding, same violation arithmetic) so the twin's
rows, the card's legs and the calibration gate speak one schema --
restated here because the package imports no repo-root script.
``tests/test_torch_port_sim.py`` pins the parity against the real
function.
"""

from __future__ import annotations

import numpy as np

PERCENTILES = ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms"),
               (99.9, "p999_ms"))


def summarize_level(lat_ms: list[float], errors: int, offered_rps: float,
                    wall_s: float, slo_ms: float | None) -> dict:
    """One LOADBENCH.json row: tail percentiles + violation rate +
    goodput for one offered-load level."""
    arr = np.asarray(sorted(lat_ms), dtype=float)
    n_total = int(arr.size) + errors
    row = {
        "offered_rps": round(offered_rps, 3),
        "arrivals": n_total,
        "n": int(arr.size),
        "errors": errors,
        "achieved_rps": round(n_total / wall_s, 3) if wall_s > 0 else 0.0,
        "goodput_rps": round(arr.size / wall_s, 3) if wall_s > 0 else 0.0,
        "wall_s": round(wall_s, 3),
    }
    for pct, key in PERCENTILES:
        row[key] = (round(float(np.percentile(arr, pct)), 3)
                    if arr.size else None)
    if slo_ms is not None:
        violations = int(np.count_nonzero(arr > slo_ms)) + errors
        row["slo_ms"] = slo_ms
        row["violations"] = violations
        row["violation_rate"] = (round(violations / n_total, 4)
                                 if n_total else 0.0)
    return row
