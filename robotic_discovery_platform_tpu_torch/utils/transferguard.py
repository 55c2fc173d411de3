"""Transfer guard: make a hidden host-device synchronisation on a hot path
fail loudly (the JAX package's ``utils/transferguard.py``).

A hot entry (the pipeline's analyzers, the trainer's steps) must never
wait on the card by accident: an ``.item()``, a ``.cpu()``, a blocking
copy or a stream's ``synchronize`` stalls the host until the device
drains. ``torch.cuda.set_sync_debug_mode`` makes PyTorch report such
calls; this module sets it around the hot entries behind one switch,
``RDP_TRANSFER_GUARD``:

- ``strict``: a synchronising call inside a guarded call raises
  (``set_sync_debug_mode("error")``);
- ``log``: it warns and goes on (``"warn"``);
- unset or ``off``: :func:`apply` returns the function unchanged, so the
  default adds nothing to a call.

The first call per argument signature is exempt: it warms up, builds
kernels and captures CUDA graphs, which synchronise by design; what the
guard holds to its word is every call after warm-up.

The mode is process-wide, not per thread: it is on while any guarded call
runs and no exempt call does (an exempt call turns it off until it
returns, so a warm-up on one thread never fails for another's guard). So
the port reads results back without a synchronising call: a pinned,
``non_blocking`` copy and an event's ``synchronize``
(``ops/graphs.read_back``), which the mode does not report.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

_ENV_VAR = "RDP_TRANSFER_GUARD"

MODES = ("off", "log", "strict")

#: what each mode sets ``torch.cuda.set_sync_debug_mode`` to
_DEBUG_MODE = {"log": "warn", "strict": "error"}


def resolve_transfer_guard() -> str:
    """The effective guard mode: ``RDP_TRANSFER_GUARD`` normalized to
    ``off``/``log``/``strict`` (unknown values mean ``off``)."""
    raw = os.environ.get(_ENV_VAR, "").strip().lower()
    if raw in ("strict", "disallow", "1", "true", "on"):
        return "strict"
    if raw in ("log", "warn"):
        return "log"
    return "off"


def _signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable abstract signature of a call: dtype and shape per array
    or tensor, the type's name otherwise."""

    def one(a: Any):
        shape = getattr(a, "shape", None)
        if shape is not None:
            return (str(getattr(a, "dtype", "?")), tuple(shape))
        if isinstance(a, (list, tuple)):
            return tuple(one(e) for e in a)
        if isinstance(a, dict):
            return tuple(sorted((k, one(v)) for k, v in a.items()))
        return type(a).__name__

    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kwargs.items())))


def _set_mode(value: str) -> None:
    """``torch.cuda.set_sync_debug_mode``, where a card exists."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(value)


class _ProcessMode:
    """The process-wide sync debug mode: the strictest of the guarded calls
    in flight, ``"default"`` while none is or while an exempt call runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._guarded = {"warn": 0, "error": 0}
        self._exempt = 0
        self._current = "default"

    def _refresh(self) -> None:
        want = "default"
        if not self._exempt:
            if self._guarded["error"]:
                want = "error"
            elif self._guarded["warn"]:
                want = "warn"
        if want != self._current:
            _set_mode(want)
            self._current = want

    def enter(self, value: str | None) -> None:
        """A call begins: guarded at ``value``, or exempt (None)."""
        with self._lock:
            if value is None:
                self._exempt += 1
            else:
                self._guarded[value] += 1
            self._refresh()

    def exit(self, value: str | None) -> None:
        with self._lock:
            if value is None:
                self._exempt -= 1
            else:
                self._guarded[value] -= 1
            self._refresh()

    @property
    def current(self) -> str:
        return self._current


_MODE = _ProcessMode()


class _Guarded:
    """``fn`` with the guard around every call after the first per
    signature; its other attributes are ``fn``'s."""

    def __init__(self, fn: Callable, mode: str,
                 key: Callable[[tuple, dict], Any]):
        self._fn = fn
        self._value = _DEBUG_MODE[mode]
        self._key = key
        self._seen: set = set()
        self._lock = threading.Lock()
        self.__transfer_guard__ = mode  # introspection for tests
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        sig = self._key(args, kwargs)
        with self._lock:
            cold = sig not in self._seen
        value = None if cold else self._value
        _MODE.enter(value)
        try:
            out = self._fn(*args, **kwargs)
        finally:
            _MODE.exit(value)
        if cold:
            with self._lock:
                self._seen.add(sig)
        return out

    def __getattr__(self, name: str):
        return getattr(self._fn, name)


def apply(fn: Callable, mode: str | None = None,
          key: Callable[[tuple, dict], Any] | None = None) -> Callable:
    """Wrap a hot entry with the transfer guard.

    With the guard off (the default) ``fn`` is returned unchanged. Else
    every call after the first per signature (``key(args, kwargs)``,
    default the arguments' dtypes and shapes) runs under
    ``torch.cuda.set_sync_debug_mode``: ``strict`` raises on a
    synchronising call, ``log`` warns. The wrapper passes attribute
    reads through to ``fn``."""
    mode = resolve_transfer_guard() if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"unknown transfer guard mode {mode!r}")
    if mode == "off":
        return fn
    return _Guarded(fn, mode, key or _signature)
