"""Synthetic training data: rendered actuator scenes with exact masks.

The JAX package's ``training/synthetic.py`` (numpy only; cv2 is imported
by :func:`generate_dataset` alone). Scenes come from
``io/frames.render_scene``, the port's copy of that module's
``render_scene``, so one seed gives both packages the same arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from robotic_discovery_platform_tpu_torch.io.frames import render_scene


def generate_arrays(n: int, h: int = 256, w: int = 256, seed: int = 0):
    """In-memory dataset: (images [n,h,w,3] u8, masks [n,h,w,1] u8/255)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, h, w, 3), np.uint8)
    masks = np.zeros((n, h, w, 1), np.uint8)
    for i in range(n):
        img, mask, _ = render_scene(rng, h, w)
        imgs[i] = img
        masks[i, ..., 0] = mask
    return imgs, masks


def generate_dataset(out_dir: str | Path, n: int, h: int = 480, w: int = 640,
                     seed: int = 0, with_depth: bool = False) -> Path:
    """Write ``{images,masks}[,depth]`` file pairs with identical stems,
    the pairing convention the trainer's file loader requires."""
    import cv2

    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "masks").mkdir(parents=True, exist_ok=True)
    if with_depth:
        (out / "depth").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask, depth = render_scene(rng, h, w)
        stem = f"sample_{i:05d}.png"
        cv2.imwrite(str(out / "images" / stem), img[..., ::-1])  # RGB -> BGR
        cv2.imwrite(str(out / "masks" / stem), mask)
        if with_depth:
            np.save(out / "depth" / f"sample_{i:05d}.npy", depth)
    return out
