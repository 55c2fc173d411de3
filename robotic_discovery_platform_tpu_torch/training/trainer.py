"""The trainer: ``train_model()``, the JAX package's
``training/trainer.py`` on the card.

Same observable surface: the experiment "Actuator Segmentation", the
reference's params (learning_rate, batch_size, epochs, validation_split,
image_size, ...), per-epoch ``train_loss`` / ``val_loss`` / ``val_miou``
/ ``val_dice``, a final ``best_val_loss``, checkpoints every
``checkpoint_every`` epochs (the final epoch always) with ``resume``, and
a new registry version of the best-by-validation-loss variables.

A train step is the training forward (``UNet.forward(train=True)``: under
a kernel ``conv_impl`` the DoubleConv convs are the custom-VJP
``ops/conv.conv3x3``, 18 forward, 17 dx and 18 dw kernel launches at the
default width), the loss, ``backward()`` and one Adam step. Adam is
``optax.adam(lr)`` of the JAX package (b1 0.9, b2 0.999, eps 1e-8 outside
the root) as ``torch.optim.Adam`` in its single-tensor form. An eval step
runs the inference forward (plain convs, no kernel launches, as in JAX)
and the metrics. Epochs are per-batch loops; the JAX package's
whole-epoch scan and its mesh are refused (``utils/config.
check_supported``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.models import losses as losses_lib
from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.models.weights import (
    to_flax_variables,
)
from robotic_discovery_platform_tpu_torch.training import data as data_lib
from robotic_discovery_platform_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    TrainConfig,
    check_supported,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def init_model(model_cfg: ModelConfig, seed: int,
               device: torch.device) -> UNet:
    """The initial network: weights drawn from a ``torch.Generator``
    seeded with ``seed`` (not the JAX package's values: another
    generator), on ``device``."""
    net = UNet(model_cfg).init_weights(torch.Generator().manual_seed(seed))
    return net.to(device)


def make_optimizer(net: UNet, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``: the same update, per tensor."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=False,
                            fused=False)


def train_step(net: UNet, optimizer: torch.optim.Optimizer,
               loss_fn: Callable, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """One optimizer step on a batch (BatchNorm's running statistics
    update in the forward); returns the loss, still on the device."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(net(x, train=True), y)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_step(net: UNet, loss_fn: Callable, x: torch.Tensor,
              y: torch.Tensor) -> dict:
    """Loss and metrics of the inference forward on a batch, on the
    device."""
    logits = net(x)
    return {
        "loss": loss_fn(logits, y),
        "miou": losses_lib.mean_iou(logits, y),
        "dice": losses_lib.dice_coefficient(logits, y),
        "accuracy": losses_lib.pixel_accuracy(logits, y),
    }


def normalize_arrays(xs, ys) -> tuple[np.ndarray, np.ndarray]:
    """In-memory arrays as the file loader leaves them: integer images
    /255; integer masks /255 when coded {0, 255}, cast when {0, 1}, and
    any other integer coding refused (it would train against ~K/255
    targets)."""
    xs = xs if hasattr(xs, "nbytes") else np.asarray(xs)
    ys = ys if hasattr(ys, "nbytes") else np.asarray(ys)
    if not np.issubdtype(xs.dtype, np.floating):
        xs = np.asarray(xs, np.float32) / 255.0
    if not np.issubdtype(ys.dtype, np.floating):
        if np.max(ys, initial=0) > 1:
            if not ((ys == 0) | (ys == 255)).all():
                raise ValueError(
                    "integer masks must be coded {0,1} or {0,255}; got "
                    f"values {np.unique(ys)[:8].tolist()}"
                )
            ys = np.asarray(ys, np.float32) / 255.0
        else:
            ys = np.asarray(ys, np.float32)
    return xs, ys


@dataclass
class TrainResult:
    run_id: str
    registry_version: int | None
    best_val_loss: float
    final_metrics: dict
    epochs_run: int
    wall_clock_s: float
    # per-epoch wall seconds (train + validation, without checkpoint IO)
    epoch_seconds: list = field(default_factory=list)

    def to_jsonable(self) -> dict:
        """Plain-JSON form, the JAX package's keys."""
        return {
            "run_id": self.run_id,
            "registry_version": self.registry_version,
            "best_val_loss": float(self.best_val_loss),
            "final_metrics": {k: float(v)
                              for k, v in self.final_metrics.items()},
            "epochs_run": int(self.epochs_run),
            "wall_clock_s": round(float(self.wall_clock_s), 2),
        }


def _state_copy(net: UNet) -> dict:
    """Independent copies of the parameters and BatchNorm statistics."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def train_model(cfg: TrainConfig = TrainConfig(),
                model_cfg: ModelConfig = ModelConfig(),
                arrays: tuple | None = None, resume: bool = False,
                mesh=None, register: bool = True,
                device: str | torch.device = "cuda") -> TrainResult:
    """Train, track, checkpoint and register.

    Args:
        cfg / model_cfg: configuration (defaults: the reference's).
        arrays: optional in-memory ``(xs, ys)`` dataset, NHWC, in place of
            ``cfg.dataset_dir``.
        resume: restore the latest checkpoint under ``cfg.checkpoint_dir``
            and continue from its epoch.
        mesh: must be None; the mesh trainer is ROADMAP queue 1 item 14.
        register: register the best variables under
            ``cfg.registered_model_name``.
        device: where the network trains.
    """
    t_start = time.time()
    if mesh is not None:
        raise NotImplementedError(
            "train_model(mesh=...): the mesh trainer is ROADMAP queue 1 "
            "item 14; the port trains on one device"
        )
    check_supported(cfg)
    check_supported(model_cfg)
    if cfg.checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {cfg.checkpoint_every}")
    device = resolve_device(device)

    if arrays is not None:
        xs, ys = normalize_arrays(*arrays)
        n_samples, ds = len(xs), None
    else:
        ds = data_lib.PairedSegmentationData(cfg.dataset_dir, cfg.img_size)
        n_samples = len(ds)
    train_idx, val_idx = data_lib.train_val_split(
        n_samples, cfg.validation_split, cfg.seed)
    if len(val_idx) == 0:
        raise ValueError("dataset too small for a validation split")

    net = init_model(model_cfg, cfg.seed, device)
    optimizer = make_optimizer(net, cfg.learning_rate)
    loss_fn = losses_lib.make_loss_fn(cfg.loss, cfg.dice_weight)
    epoch, best_val_loss, best_state = 0, float("inf"), None

    ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
    if resume and ckpt.latest_step() is not None:
        restored = ckpt.restore()
        net.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        epoch = int(restored["epoch"])
        best_val_loss = float(restored["best_val_loss"])
        if np.isfinite(best_val_loss):
            best_state = {k: v.to(device)
                          for k, v in restored["best"].items()}
        log.info("resumed from checkpoint at epoch %d", epoch)

    batch_size = cfg.batch_size
    if ds is not None:
        train_batches = data_lib.StreamingBatches(
            ds, train_idx, batch_size, shuffle=True, seed=cfg.seed,
            workers=cfg.loader_workers)
        val_batches = data_lib.StreamingBatches(
            ds, val_idx, batch_size, shuffle=False,
            workers=cfg.loader_workers)
    else:
        train_batches = data_lib.Batches(xs[train_idx], ys[train_idx],
                                         batch_size, shuffle=True,
                                         seed=cfg.seed)
        val_batches = data_lib.Batches(xs[val_idx], ys[val_idx], batch_size,
                                       shuffle=False)

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if device.type == "cuda":  # staged through pinned memory, async
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def run_val() -> dict:
        agg: dict[str, list] = {}
        for bx, by in val_batches:
            for k, v in eval_step(net, loss_fn, to_device(bx),
                                  to_device(by)).items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(torch.stack(v).cpu().numpy()))
                for k, v in agg.items()}

    tracking.set_tracking_uri(cfg.tracking_uri)
    tracking.set_experiment(cfg.experiment_name)
    registry_version = None
    final_metrics: dict = {}
    epoch_seconds: list = []
    start_epoch = min(epoch, cfg.epochs)
    # close() on both exits: a failure mid-training still drains the
    # in-flight save without masking the original error
    try:
        with tracking.start_run() as run:
            tracking.log_params({
                "learning_rate": cfg.learning_rate,
                "batch_size": batch_size,
                "epochs": cfg.epochs,
                "validation_split": cfg.validation_split,
                "image_size": cfg.img_size,
                "optimizer": "adam",
                "loss": cfg.loss,
                "model": "UNet",
                "bilinear": model_cfg.bilinear,
                "base_features": model_cfg.base_features,
                "backend": device.type,
                "num_devices": 1,
            })
            if epoch >= cfg.epochs:
                log.warning("checkpoint epoch %d >= cfg.epochs %d; nothing to "
                            "train, evaluating only", epoch, cfg.epochs)
                final_metrics = run_val()
            for epoch in range(start_epoch, cfg.epochs):
                t_epoch = time.time()
                losses = [train_step(net, optimizer, loss_fn, to_device(bx),
                                     to_device(by))
                          for bx, by in train_batches]
                train_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
                val = final_metrics = run_val()
                tracking.log_metric("train_loss", train_loss, step=epoch)
                tracking.log_metric("val_loss", val["loss"], step=epoch)
                tracking.log_metric("val_miou", val["miou"], step=epoch)
                tracking.log_metric("val_dice", val["dice"], step=epoch)
                epoch_seconds.append(time.time() - t_epoch)
                log.info("epoch %d/%d train_loss=%.4f val_loss=%.4f "
                         "miou=%.4f (%.1fs)", epoch + 1, cfg.epochs,
                         train_loss, val["loss"], val["miou"],
                         epoch_seconds[-1])
                if val["loss"] < best_val_loss:
                    best_val_loss = val["loss"]
                    best_state = _state_copy(net)
                if ((epoch + 1) % cfg.checkpoint_every
                        and epoch + 1 < cfg.epochs):
                    continue
                payload = {
                    "model": net.state_dict(),
                    "optimizer": optimizer.state_dict(),
                    "epoch": epoch + 1,
                    "best_val_loss": best_val_loss,
                    "best": (best_state if best_state is not None
                             else net.state_dict()),
                }
                if cfg.async_checkpointing:
                    ckpt.save_async(epoch + 1, payload)
                else:
                    ckpt.save(epoch + 1, payload)
            tracking.log_metric("best_val_loss", best_val_loss)
            if register and best_state is not None:
                best = UNet(model_cfg)
                best.load_state_dict({k: v.cpu()
                                      for k, v in best_state.items()})
                registry_version = tracking.log_model(
                    to_flax_variables(best), model_cfg,
                    registered_model_name=cfg.registered_model_name)
                log.info("registered %s version %s",
                         cfg.registered_model_name, registry_version)
            run_id = run.info.run_id
    except BaseException:
        ckpt.close(raise_errors=False)
        raise
    ckpt.close()
    return TrainResult(
        run_id=run_id,
        registry_version=registry_version,
        best_val_loss=best_val_loss,
        final_metrics=final_metrics,
        epochs_run=cfg.epochs - start_epoch,
        wall_clock_s=time.time() - t_start,
        epoch_seconds=epoch_seconds,
    )
