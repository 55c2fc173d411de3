"""Configuration of the port: the fields of the JAX package's
``ModelConfig``, ``GeometryConfig`` and ``ServerConfig`` that the
single-frame serving path reads, with the same names and defaults, plus
``from_dict`` and ``--section.field`` flag parsing for them.

Deliberate differences, each raising ``NotImplementedError`` in
:func:`check_supported` until the ROADMAP item that brings it lands:

- ``GeometryConfig.kernel_impl`` defaults to ``"xla"`` here (the geometry
  reference ops; the JAX package defaults to ``"auto"``). ``"auto"`` and
  ``"pallas"`` need the three geometry kernels, ROADMAP queue 2 items 3-5;
  the PR that ports them restores ``"auto"`` as the default.
- ``ServerConfig.precision`` other than ``"f32"`` (ROADMAP queue 1 item 6,
  precision tiers) and ``ServerConfig.batch_window_ms`` other than 0
  (ROADMAP queue 1 item 7, batched serving).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """U-Net architecture: channel ladder base_features x (1, 2, 4, 8,
    16 // factor), factor 2 when ``bilinear`` (the deployed default)."""

    in_channels: int = 3
    num_classes: int = 1
    bilinear: bool = True
    base_features: int = 64
    compute_dtype: str = "bfloat16"  # activations; params stay float32
    norm: str = "batch"
    # weight-init family: "torch" = Conv2d's kaiming_uniform_(a=sqrt(5)),
    # "lecun" = truncated-normal lecun (the Flax default)
    init: str = "torch"
    # training-path conv implementation in the JAX package; read back from
    # model_config.json files, not used by the inference port
    conv_impl: str = "auto"


@dataclass(frozen=True)
class GeometryConfig:
    """Edge extraction, spline fit and curvature sampling."""

    num_bins: int = 50
    top_k_percent: float = 0.05
    # "xla" = the geometry reference ops (the only implementation in this
    # slice). The JAX package defaults to "auto", which runs three Pallas
    # geometry kernels; the PR that ports them restores "auto" here.
    kernel_impl: str = "xla"
    stride: int = 1
    spline_degree: int = 3
    spline_smoothing: float = 1e-3
    num_samples: int = 100
    min_cloud_points: int = 100
    min_edge_points: int = 20
    max_per_bin: int = 128
    num_ctrl: int = 16


@dataclass(frozen=True)
class ServerConfig:
    """The single-frame server's settings."""

    address: str = "[::]:50051"
    max_workers: int = 10
    model_img_size: int = 256
    default_depth_scale: float = 0.001
    calibration_path: str = "ml/configs/calibration_data.npz"
    metrics_csv: str = "logs/vision_service_metrics.csv"
    metrics_flush_every: int = 32
    batch_window_ms: float = 0.0
    geometry_stride: int = 1
    precision: str = "f32"


@dataclass(frozen=True)
class PlatformConfig:
    """Root of the sections the port reads."""

    model: ModelConfig = field(default_factory=ModelConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    server: ServerConfig = field(default_factory=ServerConfig)


def check_supported(cfg: Any) -> None:
    """Raise ``NotImplementedError`` for a setting this slice of the port
    does not implement (see the module docstring)."""
    if isinstance(cfg, GeometryConfig) and cfg.kernel_impl != "xla":
        raise NotImplementedError(
            f"GeometryConfig.kernel_impl={cfg.kernel_impl!r}: the geometry "
            "kernels (deproject_edge_stats, bspline_design, "
            "bspline_curvature) are ROADMAP queue 2 items 3-5; use 'xla'"
        )
    if isinstance(cfg, ServerConfig):
        if cfg.precision != "f32":
            raise NotImplementedError(
                f"ServerConfig.precision={cfg.precision!r}: precision tiers "
                "are ROADMAP queue 1 item 6; use 'f32'"
            )
        if cfg.batch_window_ms != 0:
            raise NotImplementedError(
                f"ServerConfig.batch_window_ms={cfg.batch_window_ms}: "
                "batched serving is ROADMAP queue 1 item 7; use 0"
            )
    if isinstance(cfg, ModelConfig):
        if not cfg.bilinear:
            raise NotImplementedError(
                "ModelConfig.bilinear=False needs the conv_transpose2x2 "
                "kernel, ROADMAP queue 2 item 8"
            )
        if cfg.norm != "batch":
            raise NotImplementedError(
                f"ModelConfig.norm={cfg.norm!r}: the folded forward folds "
                "BatchNorm; only 'batch' is ported"
            )


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def _resolve(f: dataclasses.Field) -> type:
    t = f.type
    if isinstance(t, str):
        import builtins

        resolved = getattr(builtins, t, None) or globals().get(t)
        if resolved is None:
            raise TypeError(
                f"config field {f.name!r} has unresolvable annotation {t!r}"
            )
        t = resolved
    return t


def from_dict(cls: type, data: dict) -> Any:
    """Rebuild a (possibly nested) config dataclass from a plain dict.
    Unknown keys raise ``ValueError``."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, dict) and dataclasses.is_dataclass(_resolve(f)):
            kwargs[f.name] = from_dict(_resolve(f), v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def add_flags(parser: argparse.ArgumentParser, cls: type,
              prefix: str = "") -> None:
    """Register ``--section.field`` flags for every leaf of a config tree."""
    for f in dataclasses.fields(cls):
        t = _resolve(f)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            add_flags(parser, t, prefix=f"{name}.")
        else:
            parser.add_argument(f"--{name}", type=str, default=None,
                                help=f"({t.__name__})")


def apply_flags(cfg: Any, args: argparse.Namespace) -> Any:
    """Apply parsed ``--section.field`` overrides onto a frozen config."""

    def _apply(node: Any, prefix: str) -> Any:
        updates = {}
        for f in dataclasses.fields(node):
            t = _resolve(f)
            name = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(t):
                updates[f.name] = _apply(getattr(node, f.name), f"{name}.")
            else:
                raw = getattr(args, name, None)
                if raw is not None:
                    updates[f.name] = _coerce(raw, t)
        return dataclasses.replace(node, **updates)

    return _apply(cfg, "")


def parse_config(argv: Sequence[str] | None = None,
                 cls: type = PlatformConfig) -> Any:
    """Defaults, then an optional ``--config`` JSON file, then
    ``--section.field`` overrides."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file")
    add_flags(parser, cls)
    args = parser.parse_args(argv)
    cfg = cls()
    if args.config:
        cfg = from_dict(cls, json.loads(Path(args.config).read_text()))
    return apply_flags(cfg, args)
