"""The port's supervised training (``training/supervisor.py``) on the CPU:
a child interpreter killed right after its epoch-1 checkpoint lands,
restarted once with ``resume=True``, finishing with a registered version.

Tolerance: bit for bit. The killed attempt's epoch-1 checkpoint, the
restarted attempt's final checkpoint and the registered weights equal an
unbroken run's: the checkpoint carries the epoch order's state, so the
restart takes the batches the unbroken run takes (the JAX package's
resumed run would start the order over; ROADMAP queue 3). Every process
trains on one intra-op thread (the children through ``OMP_NUM_THREADS``,
this one through the module's fixture), so float sums split alike in all
of them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.training import (
    checkpoint,
    supervisor,
    synthetic,
    trainer,
)
from robotic_discovery_platform_tpu_torch.utils import config

NAME = "Actuator-Segmenter"
TINY = config.ModelConfig(base_features=8, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs in
    several worker processes at once, and torch's pool of one thread per
    core, oversubscribed, waits on itself at every small op
    (tests/test_torch_port_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(root, **fields) -> config.TrainConfig:
    return config.TrainConfig(
        epochs=2, batch_size=4, img_size=32, learning_rate=1e-3,
        validation_split=0.25, tracking_uri=f"file:{root}/mlruns",
        checkpoint_dir=str(root / "ckpt"), **fields)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_supervised_restart_resumes_from_the_landed_checkpoint(
        tmp_path, monkeypatch):
    arrays = synthetic.generate_arrays(16, 32, 32, seed=0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sup_cfg = _cfg(tmp_path / "supervised")
    res = supervisor.run_supervised(
        sup_cfg, TINY, fault_epoch=1, max_restarts=2, device="cpu",
        attempt_timeout_s=300, arrays=arrays)
    unbroken_cfg = _cfg(tmp_path / "unbroken")
    trainer.train_model(unbroken_cfg, TINY, arrays=arrays, register=False,
                        device="cpu")

    # one kill, one restart that ran the second epoch and registered
    assert res.restarts == 1
    assert res.epochs_run == 1 and res.registry_version == 1
    assert np.isfinite(res.best_val_loss)
    history = tracking.store_for(sup_cfg.tracking_uri).get_metric_history(
        res.run_id, "train_loss")
    assert [h["step"] for h in history] == [1]

    def restore(cfg, step):
        return checkpoint.CheckpointManager(cfg.checkpoint_dir).restore(step)

    # nothing lost before the kill, and the restart continues the
    # unbroken run: its epochs, its batches, its state
    for step in (1, 2):
        assert _equal(restore(sup_cfg, step), restore(unbroken_cfg, step)), step
    final = restore(sup_cfg, 2)
    assert {float(s["step"]) for s in
            final["optimizer"]["state"].values()} == {6.0}
    _, registered = tracking.load_model(
        f"models:/{NAME}/1", store=tracking.store_for(sup_cfg.tracking_uri),
        device="cpu")
    for key, value in registered.state_dict().items():
        assert torch.equal(value, final["best"][key]), key


def test_startup_failure_fails_fast(tmp_path):
    """A child that fails before any checkpoint (a missing dataset) fails
    twice and the supervisor gives up instead of burning every restart,
    as the JAX supervisor does."""
    cfg = dataclasses.replace(_cfg(tmp_path),
                              dataset_dir=str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="before its first checkpoint"):
        supervisor.run_supervised(cfg, TINY, max_restarts=5, device="cpu",
                                  attempt_timeout_s=120)
