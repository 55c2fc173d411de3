"""Dataset construction: the raw -> labeled step of the collect, label,
retrain loop (the JAX package's ``tools/make_dataset.py``).

- :func:`synthesize`: a fully labeled synthetic dataset
  (``training/synthetic.generate_dataset``), no hardware needed;
- :func:`pseudo_label`: a registered model's own masks over a raw capture
  directory, saved as labels (model-assisted labeling), computed by the
  port's frame analyzer on the device, over the unfolded module (the
  JAX tool applies the Flax module).

Both write the trainer's ``{images,masks}`` layout; image files go
through cv2, imported where a file is written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from robotic_discovery_platform_tpu_torch.utils.config import TrainConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def synthesize(out_dir: str | Path, n: int = 200, width: int = 640,
               height: int = 480, seed: int = 0) -> Path:
    from robotic_discovery_platform_tpu_torch.training.synthetic import (
        generate_dataset,
    )

    out = generate_dataset(out_dir, n, h=height, w=width, seed=seed)
    log.info("synthesized %d labeled pairs under %s", n, out)
    return out


def pseudo_label(
    capture_dir: str | Path,
    out_dir: str | Path,
    model_uri: str = "models:/Actuator-Segmenter@staging",
    img_size: int = 256,
    min_coverage_pct: float = 0.5,
    device="cuda",
) -> int:
    """Label a collector run with a registered model's own predictions
    (the frame analyzer's mask on ``device``). Frames whose predicted mask
    covers less than ``min_coverage_pct`` of the image are skipped
    (nothing to learn from). Returns the pairs written."""
    import cv2

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.io.frames import ReplaySource
    from robotic_discovery_platform_tpu_torch.ops import pipeline
    from robotic_discovery_platform_tpu_torch.models.unet import (
        eval_on_kernels,
    )
    from robotic_discovery_platform_tpu_torch.serving.ingest import (
        default_intrinsics,
    )

    _, net = tracking.load_model(model_uri, device=device)
    # the unfolded module, as the JAX tool applies the Flax module
    analyze = pipeline.make_frame_analyzer(eval_on_kernels(net),
                                           img_size=img_size, device=device)
    source = ReplaySource(capture_dir, loop=False)
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "masks").mkdir(parents=True, exist_ok=True)

    written = 0
    source.start()
    i = -1
    while True:
        color, depth = source.get_frames()
        if color is None:
            break
        i += 1
        h, w = color.shape[:2]
        mask = analyze(np.ascontiguousarray(color[..., ::-1]), depth,
                       default_intrinsics(w, h),
                       source.depth_scale).mask.cpu().numpy()
        coverage = 100.0 * mask.mean()
        if coverage < min_coverage_pct:
            continue
        stem = f"labeled_{i:06d}.png"
        cv2.imwrite(str(out / "images" / stem), color)
        cv2.imwrite(str(out / "masks" / stem), mask * 255)
        written += 1
    log.info("pseudo-labeled %d frames from %s into %s", written,
             capture_dir, out)
    return written


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    syn = sub.add_parser("synthesize")
    syn.add_argument("--out", default=TrainConfig().dataset_dir)
    syn.add_argument("--n", type=int, default=200)
    lab = sub.add_parser("pseudo-label")
    lab.add_argument("capture_dir")
    lab.add_argument("--out", default=TrainConfig().dataset_dir)
    lab.add_argument("--model", default="models:/Actuator-Segmenter@staging")
    lab.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.cmd == "synthesize":
        synthesize(args.out, args.n)
    else:
        pseudo_label(args.capture_dir, args.out, args.model,
                     device=args.device)
