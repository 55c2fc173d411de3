"""The port's whole-epoch scan (``TrainConfig.epoch_mode="scan"``,
``training/trainer.ScanEpochs``) on the CPU: the mode chosen and refused
by the JAX package's rule, a scan run against the JAX package's scan run,
the scan against the port's per-batch loop, and resume.

On the card the scan's step is one captured CUDA graph replayed per batch
(chip_smoke.py holds its replay against the same capturable Adam step run
eagerly, bit for bit); here the same resident-array epoch runs eagerly.

Tolerances, fixed before measuring:
- the scan against the JAX package's scan, two epochs from the JAX init
  (tiny model, float32): per-epoch train and validation losses and the
  validation metrics rtol 1e-4, the bar of
  tests/test_torch_port_training.py's two-epoch test;
- the scan against the port's per-batch loop: the same batches, equal;
  per-epoch losses and metrics rtol 1e-6 (the same float32 steps; only
  the batch's gather differs);
- a resumed scan run against an unbroken one: equal, bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.models import losses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.training import checkpoint
from robotic_discovery_platform_tpu_torch.training import data as tdata
from robotic_discovery_platform_tpu_torch.training import synthetic, trainer
from robotic_discovery_platform_tpu_torch.utils import config

TRAIN_MODEL = config.ModelConfig(base_features=8, compute_dtype="float32")
KEYS = ("train_loss", "val_loss", "val_miou", "val_dice")


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


def _cfgs(root, **kw):
    fields = dict(epochs=2, batch_size=4, img_size=32, learning_rate=1e-4,
                  validation_split=0.25, async_checkpointing=False,
                  epoch_mode="scan")
    fields.update(kw)
    port = config.TrainConfig(
        tracking_uri=f"file:{root}/port/mlruns",
        checkpoint_dir=f"{root}/port/ckpt", **fields)
    ref = jconfig.TrainConfig(
        tracking_uri=f"file:{root}/jax/mlruns",
        checkpoint_dir=f"{root}/jax/ckpt", **fields)
    return port, ref


def _history(store, run_id: str) -> dict:
    return {key: [h["value"] for h in store.get_metric_history(run_id, key)]
            for key in KEYS}


@pytest.fixture(scope="module")
def arrays():
    return synthetic.generate_arrays(16, 32, 32, seed=3)


# -- the mode ---------------------------------------------------------------------


class _Chose(Exception):
    pass


def _chosen(run) -> str:
    try:
        run()
    except _Chose as exc:
        return str(exc)
    except ValueError as exc:
        return f"ValueError: {exc}"
    raise AssertionError("the run chose no epoch form")


def _raise(mode: str):
    def make(*args, **kwargs):
        raise _Chose(mode)

    return make


CASES = [  # (epoch_mode, data: "fits" | "edge" | "over" | "dir", mesh)
    ("auto", "fits", False), ("auto", "edge", False), ("auto", "over", False),
    ("scan", "fits", False), ("scan", "over", False), ("stream", "fits", False),
    ("auto", "dir", False), ("stream", "dir", False), ("scan", "dir", False),
    ("scan", "fits", True),
]


def test_epoch_mode_is_chosen_and_refused_as_the_jax_package_does(
        tmp_path, monkeypatch):
    """Each (epoch_mode, data, mesh) through both packages' train_model,
    stopped where it builds its epoch form: the same form, or the same
    ValueError, in every case, including ``scan_max_bytes`` at the data's
    exact size (it fits) and one byte under it."""
    xs = np.random.default_rng(0).random((6, 8, 8, 3), np.float32)
    ys = (xs[..., :1] > 0.5).astype(np.float32)
    data_bytes = xs.nbytes + ys.nbytes
    synthetic.generate_dataset(tmp_path / "ds", n=6, h=8, w=8, seed=1)
    max_bytes = {"fits": 2 * data_bytes, "edge": data_bytes,
                 "over": data_bytes - 1, "dir": data_bytes}
    monkeypatch.setattr(jtrainer, "create_state", lambda *a, **kw: None)
    monkeypatch.setattr(jtrainer, "make_epoch_runners", _raise("scan"))
    monkeypatch.setattr(jtrainer, "make_train_step", _raise("stream"))
    monkeypatch.setattr(trainer, "ScanEpochs", _raise("scan"))
    monkeypatch.setattr(trainer, "StreamEpochs", _raise("stream"))
    tiny = dict(base_features=4, compute_dtype="float32")
    for mode, data, mesh in CASES:
        fields = dict(epochs=1, batch_size=2, img_size=8, epoch_mode=mode,
                      scan_max_bytes=max_bytes[data],
                      dataset_dir=str(tmp_path / "ds"),
                      tracking_uri=f"file:{tmp_path}/mlruns",
                      checkpoint_dir=str(tmp_path / "ckpt"), loader_workers=1)
        arrays = None if data == "dir" else (xs, ys)
        jmesh = object() if mesh else None
        want = _chosen(lambda: jtrainer.train_model(
            jconfig.TrainConfig(**fields), jconfig.ModelConfig(**tiny),
            arrays=arrays, mesh=jmesh, register=False))
        got = _chosen(lambda: trainer.train_model(
            config.TrainConfig(**fields), config.ModelConfig(**tiny),
            arrays=arrays, mesh=jmesh, register=False, device="cpu"))
        assert got == want, (mode, data, mesh)
        rule = _chosen(lambda: _raise(trainer.resolve_epoch_mode(
            config.TrainConfig(**fields),
            None if data == "dir" else data_bytes, jmesh))())
        assert rule == want, (mode, data, mesh)


# -- against the JAX package --------------------------------------------------------


def _jax_init(model_cfg, seed: int, img: int) -> dict:
    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(model_cfg)))
    return jax.device_get(jax.jit(lambda key: init_unet(model, key, img))(
        jax.random.key(seed)))


def test_scan_run_matches_the_jax_scan_run(tmp_path, arrays, monkeypatch):
    """Both packages' ``epoch_mode="scan"`` over two epochs from the JAX
    init: per-epoch train and validation losses, mIoU and Dice."""
    def init_model(model_cfg, seed, device):
        net = tunet.UNet(model_cfg)
        net.load_state_dict(from_flax_variables(_jax_init(model_cfg, seed,
                                                          32)))
        return net.to(device)

    monkeypatch.setattr(trainer, "init_model", init_model)
    port_cfg, ref_cfg = _cfgs(tmp_path)
    port = trainer.train_model(port_cfg, TRAIN_MODEL, arrays=arrays,
                               register=False, device="cpu")
    ref = jtrainer.train_model(
        ref_cfg, jconfig.ModelConfig(**dataclasses.asdict(TRAIN_MODEL)),
        arrays=arrays, register=False)
    got = _history(tracking.store_for(port_cfg.tracking_uri), port.run_id)
    want = _history(jtracking.store_for(ref_cfg.tracking_uri), ref.run_id)
    for key in KEYS:
        assert len(got[key]) == 2, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    for key in ("loss", "miou", "dice", "accuracy"):
        np.testing.assert_allclose(port.final_metrics[key],
                                   ref.final_metrics[key], rtol=1e-4,
                                   err_msg=key)


# -- against the port's per-batch loop -------------------------------------------------


def _run(root, arrays, monkeypatch, batches: list, **kw):
    """One port run, recording each train step's batch."""
    step = trainer.train_step

    def recording(net, opt, loss_fn, x, y):
        batches.append((x.clone(), y.clone()))
        return step(net, opt, loss_fn, x, y)

    monkeypatch.setattr(trainer, "train_step", recording)
    cfg, _ = _cfgs(root, **kw)
    result = trainer.train_model(cfg, TRAIN_MODEL, arrays=arrays,
                                 register=False, device="cpu")
    monkeypatch.setattr(trainer, "train_step", step)
    return result, _history(tracking.store_for(cfg.tracking_uri),
                            result.run_id)


def test_scan_and_stream_take_the_same_batches(tmp_path, arrays,
                                               monkeypatch):
    """The scan epoch and the per-batch loop draw the same order from the
    seed, so every step sees the same batch, and their per-epoch losses
    and metrics agree."""
    scan_batches, stream_batches = [], []
    scan, got = _run(tmp_path / "scan", arrays, monkeypatch, scan_batches,
                     epoch_mode="scan")
    stream, want = _run(tmp_path / "stream", arrays, monkeypatch,
                        stream_batches, epoch_mode="stream")
    assert len(scan_batches) == len(stream_batches) == 2 * 3
    for (x, y), (x2, y2) in zip(scan_batches, stream_batches):
        assert torch.equal(x, x2) and torch.equal(y, y2)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    assert scan.epochs_run == stream.epochs_run == 2


def test_scan_epoch_fetches_rows_of_every_step(arrays):
    """One scan epoch writes each step's loss to its row and each
    validation batch's metrics to theirs (the epoch's two fetches)."""
    net = trainer.init_model(TRAIN_MODEL, 0, torch.device("cpu"))
    opt = trainer.make_optimizer(net, 1e-4)
    xs, ys = trainer.normalize_arrays(*arrays)
    epochs = trainer.ScanEpochs(
        net, opt, losses.bce_with_logits, (xs[:12], ys[:12]),
        (xs[12:], ys[12:]), 4, np.random.default_rng(0), torch.device("cpu"))
    loss = epochs.train()
    assert int(epochs.slot) == 3 and epochs.order.shape == (3, 4)
    assert torch.isfinite(epochs.losses).all()
    assert loss == float(np.mean(epochs.losses.numpy()))
    assert sorted(epochs.order.flatten().tolist()) == list(range(12))
    val = epochs.validate()
    assert int(epochs.val_slot) == 1 and set(val) == set(trainer.METRICS)
    assert val["loss"] == float(epochs.metrics[0, 0])


# -- resume -------------------------------------------------------------------------


def _fix_epoch_order(monkeypatch) -> None:
    """Every shuffled epoch takes one fixed order of the 12 training
    samples, so runs that start apart take the same batches."""
    fixed = tdata.epoch_order(12, 4, True, np.random.default_rng(7))

    def epoch_order(n, batch_size, shuffle, rng):
        if shuffle:
            return fixed.copy()
        return np.arange(n).reshape(-1, batch_size)

    monkeypatch.setattr(tdata, "epoch_order", epoch_order)


def test_resumed_scan_run_equals_an_unbroken_one(tmp_path, arrays,
                                                 monkeypatch):
    """One epoch, then resume to three, against three epochs unbroken:
    equal per-epoch losses and final state, bit for bit, with the
    optimizer's foreach-form Adam state (step, moments) and the epoch
    order's generator round-tripped through the checkpoint (the resumed
    run takes the unbroken run's batches; the JAX package's would start
    the order over, ROADMAP queue 3)."""
    unbroken_cfg, _ = _cfgs(tmp_path / "unbroken", epochs=3)
    unbroken = trainer.train_model(unbroken_cfg, TRAIN_MODEL, arrays=arrays,
                                   register=False, device="cpu")
    first_cfg, _ = _cfgs(tmp_path / "resumed", epochs=1)
    trainer.train_model(first_cfg, TRAIN_MODEL, arrays=arrays,
                        register=False, device="cpu")
    saved = checkpoint.CheckpointManager(first_cfg.checkpoint_dir).restore()
    group, = saved["optimizer"]["param_groups"]
    assert group["foreach"] and not group["capturable"]
    assert all(set(s) == {"step", "exp_avg", "exp_avg_sq"}
               and float(s["step"]) == 3.0
               for s in saved["optimizer"]["state"].values())
    resumed_cfg = dataclasses.replace(first_cfg, epochs=3)
    resumed = trainer.train_model(resumed_cfg, TRAIN_MODEL, arrays=arrays,
                                  resume=True, register=False, device="cpu")
    assert resumed.epochs_run == 2
    got = _history(tracking.store_for(resumed_cfg.tracking_uri),
                   resumed.run_id)
    want = _history(tracking.store_for(unbroken_cfg.tracking_uri),
                    unbroken.run_id)
    for key in KEYS:
        assert got[key] == want[key][1:], key
    a = checkpoint.CheckpointManager(resumed_cfg.checkpoint_dir).restore()
    b = checkpoint.CheckpointManager(unbroken_cfg.checkpoint_dir).restore()
    for part in ("model", "best"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for pid, state in a["optimizer"]["state"].items():
        for k, v in state.items():
            assert torch.equal(v, b["optimizer"]["state"][pid][k]), (pid, k)
    assert a["epoch"] == b["epoch"] == 3
    assert a["best_val_loss"] == b["best_val_loss"]


#: optimizer group forms of checkpoints written elsewhere: the card's
#: capturable Adam, and the single-tensor Adam of older checkpoints
FORMS = {"card": dict(foreach=True, capturable=True),
         "single_tensor": dict(foreach=False, capturable=False)}


@pytest.mark.parametrize("written_by", sorted(FORMS))
def test_resume_keeps_this_devices_adam_form(tmp_path, arrays, monkeypatch,
                                             written_by):
    """A checkpoint whose optimizer groups carry another Adam form resumes
    into this device's (on the CPU: foreach, not capturable, ``step`` a
    float32 host tensor) and continues as an unbroken run does, bit for
    bit; the checkpoint the resumed run writes carries this device's
    form. ``load_state_dict`` alone would keep the file's flags: a
    capturable Adam refuses CPU parameters."""
    net = trainer.init_model(TRAIN_MODEL, 0, torch.device("cpu"))
    opt = trainer.make_optimizer(net, 1e-4)
    x, y = (torch.from_numpy(a[:4]) for a in
            trainer.normalize_arrays(*arrays))
    trainer.train_step(net, opt, losses.make_loss_fn("bce"), x, y)
    state = opt.state_dict()
    state["param_groups"][0].update(FORMS[written_by])
    fresh = trainer.make_optimizer(net, 1e-4)
    trainer.restore_optimizer(fresh, state)
    group, = fresh.param_groups
    assert group["foreach"] and not group["capturable"]
    assert all(s["step"].dtype == torch.float32 and not s["step"].is_cuda
               and float(s["step"]) == 1.0 for s in fresh.state.values())

    _fix_epoch_order(monkeypatch)
    unbroken_cfg, _ = _cfgs(tmp_path / "unbroken", epochs=2)
    unbroken = trainer.train_model(unbroken_cfg, TRAIN_MODEL, arrays=arrays,
                                   register=False, device="cpu")
    first_cfg, _ = _cfgs(tmp_path / "resumed", epochs=1)
    trainer.train_model(first_cfg, TRAIN_MODEL, arrays=arrays,
                        register=False, device="cpu")
    manager = checkpoint.CheckpointManager(first_cfg.checkpoint_dir)
    saved = manager.restore()
    saved["optimizer"]["param_groups"][0].update(FORMS[written_by])
    manager.save(1, saved)
    resumed_cfg = dataclasses.replace(first_cfg, epochs=2)
    resumed = trainer.train_model(resumed_cfg, TRAIN_MODEL, arrays=arrays,
                                  resume=True, register=False, device="cpu")
    got = _history(tracking.store_for(resumed_cfg.tracking_uri),
                   resumed.run_id)
    want = _history(tracking.store_for(unbroken_cfg.tracking_uri),
                    unbroken.run_id)
    for key in KEYS:
        assert got[key] == want[key][1:], key
    written = checkpoint.CheckpointManager(resumed_cfg.checkpoint_dir)
    group, = written.restore()["optimizer"]["param_groups"]
    assert group["foreach"] and not group["capturable"]
