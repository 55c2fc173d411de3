"""Capture budgets for the port's hot entries.

The port's copy of the JAX-free parts of the JAX package's
``analysis/recompile.py``. Where the JAX package counts traces (each
``jax.jit`` cache miss compiles a new program), the port counts CUDA graph
captures: each new static shape of a hot entry is one capture
(``ops/graphs.GraphCache``), and an unplanned one costs a warm-up and a
capture on the serving path. The names and budgets are the JAX package's:
``pipeline.frame_analyzer`` 2, ``pipeline.batch_analyzer`` 8,
``pipeline.coef_batch_analyzer`` 8, ``trainer.train_epoch`` 2 and
``trainer.eval_epoch`` 2.

Each :func:`capture_guard` call creates one :class:`GuardStats` and
registers it under ``name`` (several may share a name: every analyzer
instance has its own cache). Budgets hold per instance. On the CPU the
analyzers run eagerly but count a capture for each new static shape all
the same, so their counts equal those of the card and of the JAX package.

When an instance exceeds its budget the guard logs a warning with the
shapes it saw; under strict mode (``RDP_RECOMPILE_STRICT=1`` or
:func:`strict`) it raises :class:`RecompileBudgetExceeded` instead, at the
call that would capture.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from contextlib import contextmanager

log = logging.getLogger(__name__)

#: Captures allowed for a guard that declared no explicit budget.
DEFAULT_BUDGET = 1

_lock = threading.Lock()
_registry: dict[str, list["GuardStats"]] = {}  # guarded_by: _lock
_strict_override: bool | None = None


class RecompileBudgetExceeded(RuntimeError):
    """A guarded hot path captured beyond its declared budget."""


@dataclasses.dataclass
class GuardStats:
    name: str
    budget: int | None
    traces: int = 0  # captures: the port's counterpart of a trace
    shapes: list = dataclasses.field(default_factory=list)

    @property
    def effective_budget(self) -> int:
        return self.budget if self.budget is not None else DEFAULT_BUDGET


def _resolve_strict() -> bool:
    """RDP_RECOMPILE_STRICT resolver: test-hook override wins, then env."""
    if _strict_override is not None:
        return _strict_override
    return os.environ.get("RDP_RECOMPILE_STRICT", "0") not in (
        "0", "false", "off", "",
    )


@contextmanager
def strict(enabled: bool = True):
    """Force strict (raise-on-exceed) mode within a scope -- test hook."""
    global _strict_override
    prev = _strict_override
    _strict_override = enabled
    try:
        yield
    finally:
        _strict_override = prev


class CaptureGuard:
    """One registered budget: :meth:`count` is called once per capture."""

    def __init__(self, name: str, budget: int | None):
        self.name = name
        self.stats = GuardStats(name=name, budget=budget)
        with _lock:
            _registry.setdefault(name, []).append(self.stats)

    def count(self, signature: str) -> None:
        """Record one capture of ``signature`` (the static shapes); warn,
        or raise in strict mode, past the budget."""
        stats = self.stats
        with _lock:
            stats.traces += 1
            stats.shapes.append(signature)
            n = stats.traces
            recent = stats.shapes[-min(n, 4):]
        seen = "; ".join(recent)
        limit = stats.effective_budget
        if n > limit:
            msg = (
                f"hot path {self.name!r} recaptured: capture {n} > budget "
                f"{limit}. Shapes seen: {seen}. Every capture is a warm-up "
                "and a CUDA graph capture on the serving path -- stabilize "
                "the input shapes (or raise the declared budget if this "
                "shape set is intended)."
            )
            if _resolve_strict():
                raise RecompileBudgetExceeded(msg)
            log.warning(msg)


def capture_guard(name: str, budget: int | None = None) -> CaptureGuard:
    """A new :class:`CaptureGuard` registered under ``name``: the
    counterpart of the JAX package's ``trace_guard``."""
    return CaptureGuard(name, budget)


def stats_for(name: str) -> list[GuardStats]:
    with _lock:
        return list(_registry.get(name, []))


def total_traces(name: str) -> int:
    """Captures under ``name`` over every instance."""
    return sum(s.traces for s in stats_for(name))


def snapshot() -> dict[str, list[dict]]:
    """Registry state as plain data (diagnostics / metrics export)."""
    with _lock:
        return {
            name: [
                {
                    "traces": s.traces,
                    "budget": s.effective_budget,
                    "shapes": list(s.shapes),
                }
                for s in entries
            ]
            for name, entries in _registry.items()
        }


def over_budget() -> dict[str, int]:
    """name -> worst per-instance overshoot, for every guard over budget."""
    out: dict[str, int] = {}
    with _lock:
        for name, entries in _registry.items():
            worst = max(
                (s.traces - s.effective_budget for s in entries), default=0
            )
            if worst > 0:
                out[name] = worst
    return out


def reset() -> None:
    """Drop every registered guard's counters (test isolation)."""
    with _lock:
        _registry.clear()
