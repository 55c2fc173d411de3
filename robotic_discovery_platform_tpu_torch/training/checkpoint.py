"""Checkpoint and resume on ``torch.save`` / ``torch.load``, with the JAX
package's ``CheckpointManager`` surface: ``save``, ``save_async``,
``wait``, ``latest_step``, ``restore``, ``close(raise_errors=)`` and
``keep`` retention.

A checkpoint is ``<directory>/<step>/state.pt``: a tree of dicts, lists
and tensors (the trainer saves the module's and the optimizer's state
dicts, the epoch, the best validation loss and the best-so-far state).
The card's capturable Adam keeps its step count as a device tensor; it is
saved on the host like every tensor, and the trainer's
``restore_optimizer`` puts it back where this device's Adam keeps it.
The format is the port's own; the registry artifact
(``models/weights.save_model``) is the format both packages share.

``save_async`` first copies the state to host memory (the copy waits for
the device), then writes it on one background thread, so the next
epoch's steps may update the live tensors while the file is written. One
save is in flight at a time; ``wait`` and ``close`` drain it and re-raise
its error.
"""

from __future__ import annotations

import logging
import shutil
import threading
from pathlib import Path
from typing import Any

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and copied to host
    memory (numbers and strings are kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Numbered checkpoints under ``directory``, the newest ``keep``
    kept."""

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._pending_error: BaseException | None = None

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def _write(self, step: int, host_state: Any) -> None:
        final = self.directory / str(step)
        tmp = self.directory / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(host_state, tmp / STATE_FILE)
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as checkpoint ``step`` before returning."""
        self.wait()
        self._write(step, to_host(state))

    def save_async(self, step: int, state: Any) -> None:
        """Snapshot ``state`` to host memory now and write it on a
        background thread; the caller may update the live tensors as soon
        as this returns."""
        self.wait()  # one save in flight; surfaces the previous error
        host = to_host(state)

        def work():
            try:
                self._write(step, host)
            except Exception as exc:  # surfaced by the next wait()
                self._pending_error = exc

        self._pending = threading.Thread(target=work, name="checkpoint-save",
                                         daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Block until an in-flight save lands; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            exc, self._pending_error = self._pending_error, None
            raise exc

    def latest_step(self) -> int | None:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> Any:
        """The state of checkpoint ``step`` (default: the latest), tensors
        on the CPU."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.directory / str(step) / STATE_FILE,
                          map_location="cpu", weights_only=True)

    def close(self, raise_errors: bool = True) -> None:
        """Drain an in-flight save. ``raise_errors=False`` logs its failure
        instead of raising, for cleanup paths that must not mask an
        exception already on its way."""
        try:
            self.wait()
        except Exception:
            if raise_errors:
                raise
            log.exception("async checkpoint save failed during close")
