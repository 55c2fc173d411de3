"""Supervised, preemption-tolerant training (the port of the JAX
package's ``training/supervisor.py``).

- ``run_supervised`` executes ``train_model`` in a child process and, when
  the child dies for any reason (host OOM, a lost card, preemption,
  SIGKILL), relaunches it with ``resume=True`` so training continues from
  the latest checkpoint instead of from scratch -- up to ``max_restarts``
  times. A resumed child puts the optimizer back in this device's Adam
  form (``trainer.restore_optimizer``).
- Fault injection (``fault_epoch``): the first child arms a watchdog that
  hard-kills the process right after the given epoch's checkpoint has
  landed (its directory renamed into place with its state file in it, not
  merely submitted to the background writer), simulating a mid-run
  preemption. A marker file makes the fault one-shot so the restarted
  child runs to completion.

The child process is a fresh interpreter (``python -m
robotic_discovery_platform_tpu_torch.training.supervisor <spec.json>``),
so a wedged CUDA context or corrupted process state cannot leak across
restarts; on the card it loads the kernels its parent built from
``build/torch_kernels/`` (keyed on the same source hash).

What differs from the JAX module: ``device`` (the card unless the caller
asks for the CPU) takes the place of the JAX platform pin, and ``arrays``
passes ``train_model``'s in-memory dataset to the child (written once to
the work directory), since the file loader needs OpenCV.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from robotic_discovery_platform_tpu_torch.training.checkpoint import STATE_FILE
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    TrainConfig,
    from_dict,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: exit code the injected fault uses; distinct from real crash codes so
#: logs are unambiguous
_FAULT_EXIT = 113


@dataclass
class SupervisedResult:
    """Final TrainResult fields plus how many restarts recovery needed."""

    run_id: str
    registry_version: int | None
    best_val_loss: float
    final_metrics: dict
    epochs_run: int
    restarts: int


def run_supervised(
    cfg: TrainConfig,
    model_cfg: ModelConfig = ModelConfig(),
    register: bool = True,
    max_restarts: int = 3,
    fault_epoch: int | None = None,
    device: str = "cuda",
    attempt_timeout_s: float | None = None,
    arrays: tuple | None = None,
) -> SupervisedResult:
    """Train to completion across child-process crashes.

    Every attempt (including the first) runs with ``resume=True``: with no
    checkpoint present that is a fresh start, with one present it continues
    from the last completed epoch, so the supervisor needs no special-casing
    between "first run" and "recovery run".

    ``attempt_timeout_s`` is a per-attempt watchdog: a child that exceeds it
    is killed and treated like a signal death (retryable, resumes from the
    last checkpoint).
    """
    workdir = Path(tempfile.mkdtemp(prefix="rdp-supervise-"))
    result_path = workdir / "result.json"
    spec = {
        "train": dataclasses.asdict(cfg),
        "model": dataclasses.asdict(model_cfg),
        "register": register,
        "device": str(device),
        "result_path": str(result_path),
    }
    if arrays is not None:
        import numpy as np

        spec["arrays"] = str(workdir / "arrays.npz")
        np.savez(spec["arrays"], xs=arrays[0], ys=arrays[1])
    if fault_epoch is not None:
        spec["fault"] = {
            "epoch": int(fault_epoch),
            "marker": str(workdir / "fault-fired"),
        }
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))

    restarts = 0
    clean_failures = 0  # CONSECUTIVE rc=1-style exits; reset by signal death
    while True:
        try:
            rc = subprocess.run(
                [sys.executable, "-m",
                 "robotic_discovery_platform_tpu_torch.training.supervisor",
                 str(spec_path)],
                timeout=attempt_timeout_s,
            ).returncode
        except subprocess.TimeoutExpired:
            # subprocess.run already killed the child; model it as a signal
            # death so a hang is accounted exactly like a preemption
            rc = -9
            log.warning(
                "training child exceeded the %.0fs watchdog; killed",
                attempt_timeout_s,
            )
        if rc == 0:
            if not result_path.exists():
                raise RuntimeError(
                    "training child exited 0 without writing its result"
                )
            payload = json.loads(result_path.read_text())
            return SupervisedResult(restarts=restarts, **payload)
        restarts += 1
        # Fail fast on pre-training errors: a child that raises a clean
        # Python exception (rc == 1: bad dataset path, invalid config)
        # without a completed checkpoint is almost certainly deterministic.
        # One clean-exit retry is allowed first (a transient failure before
        # the first checkpoint also exits rc=1); a second consecutive one
        # with still no checkpoint is non-retryable. Signal deaths and the
        # injected fault always stay retryable and reset the count.
        has_completed_step = _has_completed_step(Path(cfg.checkpoint_dir))
        died_by_signal = rc < 0 or rc >= 128 or rc == _FAULT_EXIT
        clean_failures = 0 if died_by_signal else clean_failures + 1
        if not has_completed_step and clean_failures >= 2:
            raise RuntimeError(
                f"training child failed twice before its first checkpoint "
                f"(rc={rc}); treating as a non-retryable startup error"
            )
        if restarts > max_restarts:
            raise RuntimeError(
                f"training failed {restarts} times (last rc={rc}); "
                f"last checkpoint retained under {cfg.checkpoint_dir}"
            )
        log.warning(
            "training child died (rc=%d); restart %d/%d resuming from the "
            "latest checkpoint in %s",
            rc, restarts, max_restarts, cfg.checkpoint_dir,
        )


def _completed_steps(ckpt_root: Path) -> list[int]:
    """The checkpoints that have landed: ``training/checkpoint.py`` writes
    ``.<step>.tmp/`` and renames it to ``<step>/`` once its state file is
    written, so digit-named directories holding that file are exactly the
    durable steps."""
    try:
        return [int(p.name) for p in ckpt_root.iterdir()
                if p.name.isdigit() and (p / STATE_FILE).is_file()]
    except FileNotFoundError:
        return []


def _has_completed_step(ckpt_root: Path) -> bool:
    return bool(_completed_steps(ckpt_root))


def _arm_fault(fault: dict, checkpoint_dir: str) -> None:
    """One-shot preemption: hard-kill this process once the checkpoint for
    ``fault['epoch']`` has landed (that epoch's work is durably saved)."""
    marker = Path(fault["marker"])
    if marker.exists():
        return
    marker.touch()
    target = int(fault["epoch"])
    ckpt_root = Path(checkpoint_dir).absolute()

    def watch() -> None:
        while True:
            steps = _completed_steps(ckpt_root)
            if steps and max(steps) >= target:
                os._exit(_FAULT_EXIT)
            time.sleep(0.05)

    # deliberately unowned: this watcher's whole job is to os._exit the
    # process -- there is no shutdown path left to join it from
    threading.Thread(target=watch, daemon=True).start()


def _child(spec_path: str) -> None:
    from robotic_discovery_platform_tpu_torch.training.trainer import (
        train_model,
    )

    spec = json.loads(Path(spec_path).read_text())
    cfg = from_dict(TrainConfig, spec["train"])
    model_cfg = from_dict(ModelConfig, spec["model"])
    arrays = None
    if "arrays" in spec:
        import numpy as np

        with np.load(spec["arrays"]) as data:
            arrays = (data["xs"], data["ys"])
    if "fault" in spec:
        _arm_fault(spec["fault"], cfg.checkpoint_dir)
    res = train_model(cfg, model_cfg, arrays=arrays, resume=True,
                      register=spec["register"], device=spec["device"])
    payload = res.to_jsonable()
    # SupervisedResult carries exactly the JAX package's result surface
    payload.pop("wall_clock_s")
    Path(spec["result_path"]).write_text(json.dumps(payload))


if __name__ == "__main__":
    _child(sys.argv[1])
