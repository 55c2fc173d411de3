"""Configuration of the port: the fields of the JAX package's
``ModelConfig``, ``GeometryConfig`` and ``ServerConfig`` that the serving
paths read, with the same names and defaults, plus ``from_dict`` and
``--section.field`` flag parsing for them.

Settings the port does not implement yet raise ``NotImplementedError`` in
:func:`check_supported`, naming the ROADMAP item that brings them:

- ``ServerConfig.precision`` other than ``"f32"`` (precision tiers);
- on the batched path (``batch_window_ms > 0``): ``batch_impl="scan"``,
  ``serving_mesh > 1`` (the multi-device router), ``egress_pack=False``,
  ``egress_workers > 0`` (the encode pool) and the JAX package's
  ``RDP_*`` environment overrides of those settings;
- ``ModelConfig.bilinear=False`` and ``norm`` other than ``"batch"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
import os
from typing import Any, Sequence

#: ``GeometryConfig.kernel_impl`` values, the JAX package's names
KERNEL_IMPLS = ("auto", "pallas", "xla", "interpret")

#: the JAX package's environment overrides of batched-serving settings
#: (``RDP_PRECISION`` is refused with the precision tiers)
_BATCH_ENV_OVERRIDES = ("RDP_INFLIGHT", "RDP_SERVING_CHIPS",
                        "RDP_DISPATCH_MODE", "RDP_EGRESS_WORKERS")


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
    # a single frame's geometry path: "auto" (default), "pallas" and
    # "interpret" run the fused geometry kernels, "xla" the reference ops
    # (resolve_kernel_impl)
    kernel_impl: str = "auto"
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
    """The server's settings: the direct path's, and the batched path's
    (``batch_window_ms > 0``, ``serving/batching.py``)."""

    address: str = "[::]:50051"
    max_workers: int = 10
    model_img_size: int = 256
    default_depth_scale: float = 0.001
    calibration_path: str = "ml/configs/calibration_data.npz"
    metrics_csv: str = "logs/vision_service_metrics.csv"
    metrics_flush_every: int = 32
    # > 0 turns on cross-stream micro-batching: frames of concurrent
    # streams that arrive within this window share one dispatch
    batch_window_ms: float = 0.0
    max_batch: int = 8  # per-dispatch cap when micro-batching
    batch_impl: str = "dense"  # one [B, ...] forward per dispatch
    # launched-but-not-completed dispatches: 1 = serial, 2 = batch N+1
    # stages and computes while batch N's result comes back
    max_inflight_dispatches: int = 2
    serving_mesh: int = 0  # devices the dispatcher routes over (0/1: one)
    egress_pack: bool = True  # one packed [B, P] D2H per dispatch
    egress_workers: int = 0  # 0 = encode response masks inline
    submit_deadline_s: float = 30.0  # per-frame wait on the dispatcher
    max_backlog: int = 64  # queued frames before submits are shed
    watchdog_interval_s: float = 1.0  # <= 0 disables the watchdog
    # backlog overflow policy: "deadline" evicts the least-headroom frame,
    # "fifo" rejects the newcomer (serving/admission.py)
    admission_policy: str = "deadline"
    geometry_stride: int = 1
    precision: str = "f32"


@dataclass(frozen=True)
class PlatformConfig:
    """Root of the sections the port reads."""

    model: ModelConfig = field(default_factory=ModelConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    server: ServerConfig = field(default_factory=ServerConfig)


def resolve_kernel_impl(configured: str) -> str:
    """The geometry path one frame takes for ``GeometryConfig.
    kernel_impl``: ``"fused"`` (the three geometry functions of
    ``ops/geometry_kernels.py``: their kernels for tensors on the card,
    their plain versions on the CPU) for ``"auto"`` and ``"pallas"``, and
    for ``"interpret"``, the JAX package's off-chip run of its kernels,
    whose counterpart here is the plain versions on the CPU; ``"xla"``
    (the reference ops) for ``"xla"``. The JAX package's per-shape
    PALLAS_TUNE table is not ported (ROADMAP queue 1 item 17)."""
    if configured not in KERNEL_IMPLS:
        raise ValueError(
            f"unknown kernel_impl {configured!r} (choose from {KERNEL_IMPLS})"
        )
    return "xla" if configured == "xla" else "fused"


def check_supported(cfg: Any) -> None:
    """Raise for a setting the port does not implement (see the module
    docstring): ``NotImplementedError`` naming its ROADMAP item, or
    ``ValueError`` for a value no package knows."""
    if isinstance(cfg, GeometryConfig):
        resolve_kernel_impl(cfg.kernel_impl)
    if isinstance(cfg, ServerConfig):
        if cfg.precision != "f32":
            raise NotImplementedError(
                f"ServerConfig.precision={cfg.precision!r}: precision tiers "
                "are ROADMAP queue 1 item 8; use 'f32'"
            )
        if cfg.batch_window_ms > 0:
            _check_batched(cfg)
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


def _check_batched(cfg: ServerConfig) -> None:
    if cfg.batch_impl != "dense":
        if cfg.batch_impl == "scan":
            raise NotImplementedError(
                "ServerConfig.batch_impl='scan' is ROADMAP queue 1 item 16; "
                "use 'dense'"
            )
        raise ValueError(f"unknown batch_impl {cfg.batch_impl!r}")
    if cfg.serving_mesh not in (0, 1):
        raise NotImplementedError(
            f"ServerConfig.serving_mesh={cfg.serving_mesh}: the multi-device "
            "router (DeviceRouter) is ROADMAP queue 1 item 16; use 0"
        )
    if not cfg.egress_pack:
        raise NotImplementedError(
            "ServerConfig.egress_pack=False (the unpacked per-leaf fetch) is "
            "ROADMAP queue 1 item 16; the port's dispatcher packs"
        )
    if cfg.egress_workers > 0:
        raise NotImplementedError(
            f"ServerConfig.egress_workers={cfg.egress_workers}: the encode "
            "pool is ROADMAP queue 1 item 16; use 0"
        )
    set_env = [k for k in _BATCH_ENV_OVERRIDES if os.environ.get(k)]
    if set_env:
        raise NotImplementedError(
            f"environment overrides {set_env} of the batched-serving "
            "settings are ROADMAP queue 1 item 16; set the ServerConfig "
            "fields instead"
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
