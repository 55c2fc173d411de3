"""Geometry parity corpus: the port's curvature error against the oracle.

The JAX package's ``tools/geometry_parity.py`` for the port's geometry
(``ops/geometry.compute_curvature_profile``) on a chosen device: over a
randomized corpus of arc scenes (radius, focal length, depth, band
thickness, arc placement, depth noise and mask speckle all vary), each
scene is scored against the reference-semantics scipy oracle
(``tests/oracle.py``, numpy and scipy only) and the analytic curvature,
at geometry stride 1 (the reference's dense semantics) and stride 2 (the
serving fast path). The distribution is written to ``--out``, by default
under the git-ignored ``reports/``.

Usage: python -m robotic_discovery_platform_tpu_torch.tools.geometry_parity
       [--scenes N] [--seed S] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO / "tests"))

DEFAULT_OUT = REPO / "reports" / "geometry_parity_torch.json"


def random_scene(rng: np.random.Generator):
    """A randomized arc scene and its analytic curvature: the JAX tool's
    draws, in its order, so one seed gives both tools the same scenes."""
    from oracle import make_arc_scene

    params = dict(
        h=480,
        w=640,
        f=float(rng.uniform(450.0, 750.0)),
        z0=float(rng.uniform(0.3, 0.8)),
        r_px=float(rng.uniform(150.0, 380.0)),
        band_px=int(rng.integers(30, 120)),
        arc_cy_px=float(rng.uniform(40.0, 160.0)),
    )
    mask, depth, k, scale, true_k = make_arc_scene(**params)

    # depth noise: +-2 mm gaussian, quantized to the z16 grid
    noise_mm = float(rng.uniform(0.0, 2.0))
    if noise_mm > 0:
        depth = depth.astype(np.int64) + np.round(
            rng.normal(0.0, noise_mm, depth.shape)
        ).astype(np.int64)
        depth = np.clip(depth, 0, 65535).astype(np.uint16)

    # mask speckle: drop a small fraction of mask pixels (sensor dropouts)
    drop = float(rng.uniform(0.0, 0.05))
    if drop > 0:
        mask = mask * (rng.random(mask.shape) > drop).astype(np.uint8)

    params.update(noise_mm=noise_mm, drop=drop)
    return mask, depth, k, scale, true_k, params


def profile_fn(stride: int, device):
    """``(mask u8, depth u16, intrinsics, scale) -> (valid, mean, max)``
    through the port's geometry at ``stride`` on ``device`` (the fused
    kernels on the card, their plain versions on the CPU)."""
    import torch

    from robotic_discovery_platform_tpu_torch.ops import geometry
    from robotic_discovery_platform_tpu_torch.utils.config import (
        GeometryConfig,
    )
    from robotic_discovery_platform_tpu_torch.utils.device import (
        resolve_device,
    )

    cfg = GeometryConfig(stride=stride)
    dev = resolve_device(device)

    def run(mask, depth, k, scale):
        with torch.no_grad():
            p = geometry.compute_curvature_profile(
                torch.from_numpy(np.ascontiguousarray(mask)).to(dev),
                torch.from_numpy(depth.astype(np.float32)).to(dev),
                torch.as_tensor(np.asarray(k, np.float32), device=dev),
                torch.tensor(scale, dtype=torch.float32, device=dev), cfg)
            return (bool(p.valid), float(p.mean_curvature),
                    float(p.max_curvature))

    return run


def run_corpus(n_scenes: int, seed: int = 0, device="cuda") -> dict:
    """Score ``n_scenes`` scenes (drawn from ``seed``; a draw the oracle
    declines is drawn again) at stride 1 and 2 on ``device``."""
    from oracle import oracle_curvature

    fns = {s: profile_fn(s, device) for s in (1, 2)}
    rng = np.random.default_rng(seed)
    scenes = []
    while len(scenes) < n_scenes:
        mask, depth, k, scale, true_k, params = random_scene(rng)
        o_mean, o_max, _ = oracle_curvature(mask, depth, k, scale)
        if o_mean == 0.0:  # the oracle declined (degenerate draw)
            continue
        rec = {"params": params, "true_curvature": true_k,
               "oracle": {"mean": o_mean, "max": o_max}}
        for s, fn in fns.items():
            valid, mean, mx = fn(mask, depth, k, scale)
            rec[f"stride{s}"] = {
                "valid": valid,
                "mean": mean,
                "max": mx,
                "rel_err_mean": abs(mean - o_mean) / o_mean,
                "rel_err_max": abs(mx - o_max) / o_max,
            }
        scenes.append(rec)

    def dist(errs):
        errs = np.asarray(errs)
        return {
            "mean": float(errs.mean()),
            "p50": float(np.percentile(errs, 50)),
            "p90": float(np.percentile(errs, 90)),
            "max": float(errs.max()),
        }

    def agg(key: str, field: str):
        return dist([sc[key][field] for sc in scenes])

    def truth_err(key: str, field: str):
        return dist([
            abs(sc[key][field] - sc["true_curvature"]) / sc["true_curvature"]
            for sc in scenes
        ])

    summary = {}
    for key in ("oracle", "stride1", "stride2"):
        entry = {
            "mean_curvature_vs_truth": truth_err(key, "mean"),
            "max_curvature_vs_truth": truth_err(key, "max"),
        }
        if key != "oracle":
            entry["valid_frac"] = float(np.mean(
                [sc[key]["valid"] for sc in scenes]))
            entry["mean_curvature_vs_oracle"] = agg(key, "rel_err_mean")
            entry["max_curvature_vs_oracle"] = agg(key, "rel_err_max")
        summary[key] = entry

    return {
        "n_scenes": len(scenes),
        "seed": seed,
        "device": str(device),
        "oracle": "tests/oracle.py (reference semantics: 50 bins, top-5%, "
                  "splprep s=0.1 k=3)",
        "notes": (
            "vs_truth: relative error against the analytic arc curvature. "
            "Max-curvature is dominated by endpoint artefacts in both "
            "implementations and is reported, not used as a parity gate."
        ),
        "summary": summary,
        "scenes": scenes,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    result = run_corpus(args.scenes, args.seed, args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"n_scenes": result["n_scenes"],
                      "summary": result["summary"]}, indent=2))


if __name__ == "__main__":
    main()
