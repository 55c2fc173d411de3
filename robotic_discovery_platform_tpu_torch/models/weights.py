"""Weights carried across from the JAX package.

- :func:`from_flax_variables` maps a Flax ``{"params", "batch_stats"}``
  variable tree (numpy leaves) onto the state of :class:`models.unet.UNet`:
  the module tree carries the Flax names, so each leaf's path joined by
  ``.`` is its state-dict key.
- :func:`load_model_dir` reads a model artifact directory written by the
  JAX package's ``tracking.save_model``: ``model_config.json`` plus the
  Flax-serialized ``variables.msgpack``, decoded here with ``msgpack``
  (Flax's ndarray extension type), without Flax or JAX.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    from_dict,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

MODEL_CONFIG_FILE = "model_config.json"
MODEL_WEIGHTS_FILE = "variables.msgpack"

# Flax's msgpack extension code for an ndarray leaf
# (flax/serialization.py _MsgpackExtType.ndarray)
_EXT_NDARRAY = 1


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, f"{name}."))
        else:
            out[name] = np.asarray(value)
    return out


def from_flax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """Flax ``{"params": ..., "batch_stats": ...}`` tree with numpy
    leaves -> a :class:`UNet` state dict of float32 tensors."""
    state = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    overlap = set(state) & set(stats)
    if overlap:
        raise ValueError(f"params and batch_stats share keys: {sorted(overlap)}")
    state.update(stats)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}


def unet_from_flax_variables(cfg: ModelConfig, variables: dict) -> UNet:
    """A :class:`UNet` for ``cfg`` holding the Flax ``variables`` (CPU);
    every parameter and statistic must be present, with its shape."""
    net = UNet(cfg)
    net.load_state_dict(from_flax_variables(variables), strict=True)
    return net.eval()


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    dtype = np.dtype(dtype_name.decode())
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    return msgpack.ExtType(code, data)


def read_flax_msgpack(blob: bytes) -> dict:
    """Decode Flax ``serialization.to_bytes`` output into a tree of dicts
    with numpy leaves."""
    import msgpack

    return msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False)


def load_model_dir(path: str | Path, device: str | torch.device = "cuda"
                   ) -> tuple[ModelConfig, UNet]:
    """Load ``(ModelConfig, UNet)`` from an artifact directory written by
    the JAX package's ``tracking.save_model``; the module is moved to
    ``device`` in eval mode."""
    device = resolve_device(device)
    path = Path(path)
    cfg = from_dict(ModelConfig,
                    json.loads((path / MODEL_CONFIG_FILE).read_text()))
    variables = read_flax_msgpack((path / MODEL_WEIGHTS_FILE).read_bytes())
    return cfg, unet_from_flax_variables(cfg, variables).to(device)
