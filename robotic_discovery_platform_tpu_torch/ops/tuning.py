"""Per-shape tuning table: measured overrides for the 3x3 conv's analytic
split count.

The port of the JAX package's ``ops/pallas/tuning.py``. The bf16
:func:`ops.conv.conv3x3_bn_relu` kernel has no tiles to tune: its one
launch parameter is how many blocks split its K (``splits``), which
:func:`ops.conv.fwd_plan` chooses from a formula that fills one wave of
SMs. ``python tools/tune_kernels.py`` (on the card) times every split the
launch takes for each 3x3 shape of the serving forward and records the
winners here; the folded forward (``ops/unet_infer.py``) passes the
measured split to each launch.

The table lives at ``CUDA_TUNE.json`` at the root of the checkout. It is
the port's own: the JAX package's ``PALLAS_TUNE.json`` holds Pallas tiles,
which mean nothing to this kernel, and is never read. A missing or stale
table means the analytic plan runs: tuning is an overlay, never a
correctness dependency. An entry records the tuned and the heuristic
split's measured ms, so the table is its own evidence:
``{"splits": n, "ms": ..., "heuristic_ms": ...}``.

Two deliberate differences from the JAX table:

- the conv key has no batch (``conv3x3:{h}x{w}:{cin}->{cout}:{dtype}``).
  The split fixes each output's order of summation, so a split keyed by
  batch would give a frame other bits inside a batch than alone, and the
  port holds its batched dispatch equal to the direct frame bit for bit.
  :func:`key` and :func:`lookup` take ``batch=`` and ignore it;
- no launch consults a per-(op, shape) path entry (the JAX table's
  ``deproject``, ``bspline_*``, ``mask_pack`` and ``jpeg_idct`` keys):
  ``GeometryConfig.kernel_impl`` is the one switch of the geometry
  stages, and the mask pack and the IDCT have one path on the card. No
  tool here measures both paths of a stage, so such an entry is logged
  once when the table is read and ignored. :func:`op_key` and
  :func:`lookup_impl` keep the JAX strings and answers, so one entry
  reads the same in both tables.
"""

from __future__ import annotations

import json
from pathlib import Path

from robotic_discovery_platform_tpu_torch.ops.conv import (
    FWD_CAP_BATCH,
    FWD_WORKSPACE_CAP,
    fwd_k_chunks,
    fwd_plan,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_TUNE_PATH = Path(__file__).resolve().parents[2] / "CUDA_TUNE.json"
_cache: dict | None = None


def key(h: int, w: int, cin: int, cout: int, batch: int = 1,
        dtype: str = "bfloat16") -> str:
    """The conv entry's key; ``batch`` is ignored (see the module
    docstring)."""
    del batch
    return f"conv3x3:{h}x{w}:{cin}->{cout}:{dtype}"


def _table() -> dict:
    global _cache
    if _cache is None:
        try:
            entries = json.loads(_TUNE_PATH.read_text()).get("entries", {})
            _cache = entries if isinstance(entries, dict) else {}
        except (FileNotFoundError, json.JSONDecodeError, AttributeError):
            _cache = {}
        for k in sorted(_cache):
            if not k.startswith("conv3x3:"):
                log.info("tuning: ignoring %s: no launch of the port "
                         "consults a path entry", k)
    return _cache


def invalidate_cache() -> None:
    """Forget the table read so far. A captured CUDA graph keeps the
    split that was in force at its capture: a change takes effect at the
    next capture (a reload), not in graphs already captured."""
    global _cache
    _cache = None


def _workspace_fits(splits: int, h: int, w: int, cout: int) -> bool:
    """The split partials at ``FWD_CAP_BATCH`` frames stay within
    ``FWD_WORKSPACE_CAP`` (one split has no workspace)."""
    return splits == 1 or (splits * FWD_CAP_BATCH * h * w * cout * 4
                           <= FWD_WORKSPACE_CAP)


def lookup(h: int, w: int, cin: int, cout: int, batch: int = 1,
           dtype: str = "bfloat16") -> int | None:
    """The measured split count for this shape, or None to let
    :func:`ops.conv.fwd_plan` decide. An entry the launch could not take
    (splits not an integer, below 1, above the K chunks, a workspace over
    the cap, or a float32 key: that path has no split) is ignored rather
    than trusted: a bad table must never turn into a serving crash."""
    entry = _table().get(key(h, w, cin, cout, batch, dtype))
    if not isinstance(entry, dict) or dtype != "bfloat16":
        return None
    splits = entry.get("splits")
    if isinstance(splits, bool) or not isinstance(splits, int):
        return None
    if not 1 <= splits <= fwd_k_chunks(cin):
        return None
    if not _workspace_fits(splits, h, w, cout):
        return None
    return splits


def candidates(h: int, w: int, cin: int, cout: int) -> list[int]:
    """Every split count the bf16 launch takes for this shape within the
    workspace cap, :func:`ops.conv.fwd_plan`'s choice first (index 0 is
    the baseline of the sweep)."""
    heuristic = fwd_plan(1, h, w, cin, cout)[0]
    out = [heuristic]
    for splits in range(1, fwd_k_chunks(cin) + 1):
        if splits != heuristic and _workspace_fits(splits, h, w, cout):
            out.append(splits)
    return out


def op_key(op: str, **dims) -> str:
    """Generic table key of the other kernels: the op name plus its sorted
    shape dims, e.g. ``deproject:h480:s1:w640`` or
    ``bspline_design:c16:n6400`` (the JAX package's strings)."""
    parts = [f"{k}{v}" for k, v in sorted(dims.items())]
    return ":".join([op] + parts)


def lookup_impl(op: str, **dims) -> str | None:
    """The path entry of one (op, shape) as the JAX package reads it:
    ``"pallas"`` or ``"xla"``, or None (no entry, or any other value).
    No launch of the port consults it (see the module docstring)."""
    entry = _table().get(op_key(op, **dims))
    if not isinstance(entry, dict):
        return None
    impl = entry.get("impl")
    return impl if impl in ("pallas", "xla") else None


def save_entries(entries: dict, meta: dict) -> Path:
    """Write the table (the tuning tool only); invalidates the read
    cache."""
    _TUNE_PATH.write_text(json.dumps(
        {"meta": meta, "entries": entries}, indent=2, sort_keys=True))
    invalidate_cache()
    return _TUNE_PATH


__all__ = [
    "key", "lookup", "candidates", "op_key", "lookup_impl",
    "save_entries", "invalidate_cache",
]
