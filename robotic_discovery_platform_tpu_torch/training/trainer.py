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
the root) as ``torch.optim.Adam`` in its multi-tensor (foreach) form,
capturable on the card (its step count a device tensor). An eval step
runs the inference forward (plain convs, no kernel launches, as in JAX)
and the metrics.

Two epoch forms, chosen by the JAX package's rule
(:func:`resolve_epoch_mode`):

- ``"scan"`` (:class:`ScanEpochs`, the JAX package's whole-epoch
  ``lax.scan`` of ``make_epoch_runners``): the training and validation
  arrays live on the device, each epoch's ``[n_batches, batch]`` order is
  one host-to-device copy, and one step -- the gather of a batch by the
  order's row at a device counter, the train step, the loss written to a
  device row -- is captured as a CUDA graph (``ops/graphs.StepGraph``,
  capture guard ``trainer.train_epoch``) and replayed once per batch: one
  host launch per step. The validation step likewise
  (``trainer.eval_epoch``). An epoch makes one host fetch of the losses
  and one of the validation metrics. On the CPU the same epoch runs
  eagerly.
- ``"stream"`` (:class:`StreamEpochs`): the per-batch loop over a
  prefetching iterator, for a dataset directory or arrays past
  ``scan_max_bytes``.

A checkpoint carries the epoch order's generator state (``order_rng``),
and a resumed run puts it back, so it takes the batches an unbroken run
would: a deliberate divergence from the JAX package, whose resumed run
draws the order from the seed afresh and so repeats the first epoch's
batches (ROADMAP queue 3). A checkpoint without that state (one the JAX
package's was converted from) resumes as the JAX package does.

With a ``mesh`` (``parallel/mesh.make_mesh``) the run is split over the
mesh's "data", "spatial" and "model" axes, one rank of the default
process group per position (:class:`MeshEpochs` around
``parallel/dp.parallelize_training``, ``TrainConfig.tp_min_channels``
choosing the kernels split over "model"), with the JAX package's rules:
the convs are the plain ones (``conv_impl="flax"``: the custom-VJP conv
carries no collectives), the batch is rounded up to a multiple of the
data axis, ``epoch_mode="scan"`` is refused, and only rank 0 writes
checkpoints, tracking and the registry (every rank restores). Every rank
of the model group gathers the kernels' slices and their Adam moments
before rank 0 writes, so a checkpoint and a registered version hold the
full-shaped state dict of the unwrapped network: they load into the
single-device trainer and servicer, and a resumed mesh run slices them
again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.analysis import recompile
from robotic_discovery_platform_tpu_torch.models import losses as losses_lib
from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.models.weights import (
    to_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops import graphs
from robotic_discovery_platform_tpu_torch.training import data as data_lib
from robotic_discovery_platform_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from robotic_discovery_platform_tpu_torch.utils import transferguard
from robotic_discovery_platform_tpu_torch.utils.config import (
    PLAIN_CONV_IMPLS,
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
    """``optax.adam(learning_rate)``: the same update in the multi-tensor
    (foreach) form. On the card it is capturable: the step count lives on
    the device and the bias corrections are computed there, so a CUDA
    graph can capture the update (checkpoints carry ``step`` as a tensor;
    :func:`restore_optimizer` puts it back)."""
    capturable = next(net.parameters()).is_cuda
    return torch.optim.Adam(net.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=True,
                            capturable=capturable)


def restore_optimizer(optimizer: torch.optim.Adam, state: dict) -> None:
    """Load a checkpoint's optimizer ``state`` and keep the form that
    :func:`make_optimizer` chose for this device. ``load_state_dict``
    takes each group's ``foreach`` and ``capturable`` from the file, which
    may come from the other device or from the single-tensor Adam of
    older checkpoints: a non-capturable Adam cannot be captured on the
    card, and a capturable one refuses CPU parameters. So each group gets
    its own flags back, and each ``step`` becomes a float32 tensor on the
    parameters' device when capturable, on the host otherwise."""
    forms = [{k: g[k] for k in ("foreach", "capturable")}
             for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, form in zip(optimizer.param_groups, forms):
        group.update(form)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = torch.as_tensor(st["step"]).to(
                    p.device if form["capturable"] else "cpu", torch.float32)


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


def _state_copy(net: UNet, state=None) -> dict:
    """Independent copies of the parameters and BatchNorm statistics, at
    full shape: a mesh run's ``state`` (``parallel/dp.ReplicatedState``)
    gathers its ``model`` slices, on every rank of the model group."""
    if state is not None:
        from robotic_discovery_platform_tpu_torch.parallel import dp

        return dp.full_state_dict(state)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def resolve_epoch_mode(cfg: TrainConfig, data_bytes: int | None,
                       mesh=None) -> str:
    """``"scan"`` or ``"stream"`` by the JAX package's rule
    (``training/trainer.py``): ``"scan"``, or ``"auto"`` with in-memory
    arrays of at most ``cfg.scan_max_bytes``, takes the scan epoch when
    the arrays are in memory and there is no mesh; ``"scan"`` over a
    dataset directory (``data_bytes`` None) or a mesh raises ValueError.
    ``data_bytes`` is the normalized arrays' size."""
    in_memory = data_bytes is not None
    fits = (data_bytes or 0) <= cfg.scan_max_bytes
    if cfg.epoch_mode == "scan" and (not in_memory or mesh is not None):
        raise ValueError(
            "epoch_mode='scan' needs an in-memory dataset and no mesh")
    use_scan = in_memory and mesh is None and (
        cfg.epoch_mode == "scan" or (cfg.epoch_mode == "auto" and fits))
    if cfg.epoch_mode == "auto" and in_memory and mesh is None and not fits:
        log.info("dataset is %.1f GiB > scan_max_bytes; using the streamed "
                 "per-batch path", data_bytes / 2**30)
    return "scan" if use_scan else "stream"


#: the validation metrics, in the order of a metrics row
METRICS = ("loss", "miou", "dice", "accuracy")


class StreamEpochs:
    """The per-batch epoch: each batch staged from the prefetching
    iterator, one train step (or eval step) dispatched per batch, the
    losses fetched at the epoch's end."""

    def __init__(self, net: UNet, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, train_batches, val_batches,
                 device: torch.device):
        self.net, self.optimizer, self.loss_fn = net, optimizer, loss_fn
        self.train_batches, self.val_batches = train_batches, val_batches
        self.device = device
        # the hot entries, behind RDP_TRANSFER_GUARD (the JAX package's
        # make_train_step / make_eval_step)
        self._train_step = transferguard.apply(train_step)
        self._eval_step = transferguard.apply(eval_step)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type == "cuda":  # staged through pinned memory
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @property
    def order_rng(self) -> np.random.Generator:
        """The generator each epoch's training order is drawn from."""
        return self.train_batches.rng

    def train(self) -> float:
        losses = [self._train_step(self.net, self.optimizer, self.loss_fn,
                                   self._to_device(bx), self._to_device(by))
                  for bx, by in self.train_batches]
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    def validate(self) -> dict:
        agg: dict[str, list] = {}
        for bx, by in self.val_batches:
            for k, v in self._eval_step(self.net, self.loss_fn,
                                        self._to_device(bx),
                                        self._to_device(by)).items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(torch.stack(v).cpu().numpy()))
                for k, v in agg.items()}


class MeshEpochs:
    """The per-batch epoch over a mesh's data axis: every rank draws the
    same global batches (seed-deterministic) and the data-parallel steps
    (``parallel/dp.parallelize_training``) take this rank's rows; the
    losses and metrics are the global batch's."""

    def __init__(self, train_step: Callable, eval_step: Callable, state,
                 train_batches, val_batches):
        self._train_step = transferguard.apply(train_step)
        self._eval_step = transferguard.apply(eval_step)
        self.state = state
        self.train_batches, self.val_batches = train_batches, val_batches

    @property
    def order_rng(self) -> np.random.Generator:
        return self.train_batches.rng

    def train(self) -> float:
        losses = [self._train_step(self.state, bx, by)[1]
                  for bx, by in self.train_batches]
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    def validate(self) -> dict:
        agg: dict[str, list] = {}
        for bx, by in self.val_batches:
            for k, v in self._eval_step(self.state, bx, by).items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(torch.stack(v).cpu().numpy()))
                for k, v in agg.items()}


class ScanEpochs:
    """The JAX package's whole-epoch scan (``make_epoch_runners``) on one
    device: the arrays resident there, one captured step replayed per
    batch, one host fetch per epoch for the losses and one for the
    validation metrics (see the module docstring).

    ``rng`` is the epoch order's generator (``order_rng``),
    ``np.random.default_rng(seed)`` as in the JAX package: each
    :meth:`train` draws one shuffled
    ``[n_batches, batch]`` order (``data.epoch_order``); the validation
    order is drawn once, unshuffled. The steps read the module's own
    parameters and BatchNorm buffers and the optimizer's state, and update
    them in place, so checkpoints and the registry read the trained
    values."""

    def __init__(self, net: UNet, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, train: tuple, val: tuple,
                 batch_size: int, rng: np.random.Generator,
                 device: torch.device):
        self.net, self.optimizer, self.loss_fn = net, optimizer, loss_fn
        self.batch_size, self.order_rng = batch_size, rng
        self.device = device

        def resident(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                device)

        self.xs, self.ys = (resident(a) for a in train)
        self.xv, self.yv = (resident(a) for a in val)
        self.n_train = len(train[0])
        n_batches = max(1, -(-self.n_train // batch_size))
        self.order = torch.zeros((n_batches, batch_size), dtype=torch.int64,
                                 device=device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=device)
        self.losses = torch.zeros((n_batches,), dtype=torch.float32,
                                  device=device)
        self.val_order = torch.from_numpy(data_lib.epoch_order(
            len(val[0]), batch_size, False, rng)).to(device)
        self.val_slot = torch.zeros((1,), dtype=torch.int64, device=device)
        self.metrics = torch.zeros((self.val_order.shape[0], len(METRICS)),
                                   dtype=torch.float32, device=device)
        # behind RDP_TRANSFER_GUARD, as the JAX package's epoch runners:
        # the warm-up step and the capture are exempt, every replay guarded
        self._train_graph = self._guarded(graphs.StepGraph(
            self._train_body, recompile.capture_guard("trainer.train_epoch",
                                                      2), device))
        self._eval_graph = self._guarded(graphs.StepGraph(
            self._eval_body, recompile.capture_guard("trainer.eval_epoch", 2),
            device))

    @staticmethod
    def _guarded(step: graphs.StepGraph):
        return transferguard.apply(step, key=lambda args, kwargs: step.stage)

    def _train_body(self) -> None:
        idx = self.order.index_select(0, self.slot).view(-1)
        loss = train_step(self.net, self.optimizer, self.loss_fn,
                          self.xs.index_select(0, idx),
                          self.ys.index_select(0, idx))
        self.losses.index_copy_(0, self.slot, loss.view(1))
        self.slot.add_(1)

    def _eval_body(self) -> None:
        idx = self.val_order.index_select(0, self.val_slot).view(-1)
        m = eval_step(self.net, self.loss_fn, self.xv.index_select(0, idx),
                      self.yv.index_select(0, idx))
        self.metrics.index_copy_(0, self.val_slot,
                                 torch.stack([m[k] for k in METRICS])[None])
        self.val_slot.add_(1)

    def train(self) -> float:
        order = data_lib.epoch_order(self.n_train, self.batch_size, True,
                                     self.order_rng)
        self.order.copy_(torch.from_numpy(order))
        self.slot.zero_()
        for _ in range(order.shape[0]):
            self._train_graph()
        return float(np.mean(self.losses.cpu().numpy()))

    def close(self) -> None:
        """Drop the captured steps, and the gradients that the captured
        backward left in the train graph's pool, now rather than when the
        collector breaks this object's cycle with its steps: the graphs'
        memory can then go back to the card at once
        (``graphs.release_dead_pools``), as a process that trains and
        serves needs."""
        self.optimizer.zero_grad(set_to_none=True)
        self._train_graph = self._eval_graph = None

    def validate(self) -> dict:
        self.val_slot.zero_()
        for _ in range(self.val_order.shape[0]):
            self._eval_graph()
        rows = self.metrics.cpu().numpy()
        return {k: float(np.mean(np.ascontiguousarray(rows[:, j])))
                for j, k in enumerate(METRICS)}


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
        mesh: a ``parallel/mesh.Mesh``: train over its axes on this
            rank's device of it (``device`` is then unused; see the module
            docstring).
        register: register the best variables under
            ``cfg.registered_model_name``.
        device: where the network trains.
    """
    t_start = time.time()
    check_supported(cfg)
    check_supported(model_cfg)
    if cfg.checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {cfg.checkpoint_every}")
    device = resolve_device(device)

    if arrays is not None:
        xs, ys = normalize_arrays(*arrays)
        n_samples, ds = len(xs), None
        data_bytes = int(xs.nbytes) + int(ys.nbytes)
    else:
        ds = data_lib.PairedSegmentationData(cfg.dataset_dir, cfg.img_size)
        n_samples, data_bytes = len(ds), None
    train_idx, val_idx = data_lib.train_val_split(
        n_samples, cfg.validation_split, cfg.seed)
    if len(val_idx) == 0:
        raise ValueError("dataset too small for a validation split")
    mode = resolve_epoch_mode(cfg, data_bytes, mesh)
    divisor, rank = 1, 0
    if mesh is not None:
        from robotic_discovery_platform_tpu_torch.parallel import dp
        from robotic_discovery_platform_tpu_torch.parallel import (
            mesh as mesh_lib,
        )

        mesh_lib.mesh_groups(mesh)  # ValueError unless one rank a position
        divisor = mesh.shape.get("data", 1)
        rank, _ = mesh_lib.data_rank()
        device = mesh_lib.local_device(mesh)
        if model_cfg.conv_impl not in PLAIN_CONV_IMPLS:
            # the custom-VJP kernel conv carries no collectives; under a
            # mesh the plain convs are the data-parallel ones (the JAX
            # trainer's rule)
            model_cfg = dataclasses.replace(model_cfg, conv_impl="flax")
    is_main = rank == 0

    net = init_model(model_cfg, cfg.seed, device)
    optimizer = make_optimizer(net, cfg.learning_rate)
    loss_fn = losses_lib.make_loss_fn(cfg.loss, cfg.dice_weight)
    epoch, best_val_loss, best_state = 0, float("inf"), None
    restored = None

    ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
    if resume and ckpt.latest_step() is not None:
        restored = ckpt.restore()
        net.load_state_dict(restored["model"])
        restore_optimizer(optimizer, restored["optimizer"])
        epoch = int(restored["epoch"])
        best_val_loss = float(restored["best_val_loss"])
        if np.isfinite(best_val_loss):
            best_state = {k: v.to(device)
                          for k, v in restored["best"].items()}
        log.info("resumed from checkpoint at epoch %d", epoch)

    # the global batch, rounded up to a multiple of the data axis
    batch_size = -(-max(cfg.batch_size, divisor) // divisor) * divisor
    # the epochs read the restored state: a scan epoch's graphs are
    # captured on its first epoch, after the restore; a mesh run slices it
    mesh_state = None
    if mesh is not None:
        train, evals, mesh_state = dp.parallelize_training(
            mesh, net, optimizer, loss_fn,
            tp_min_channels=cfg.tp_min_channels)
        if ds is not None:
            train_batches = data_lib.StreamingBatches(
                ds, train_idx, batch_size, shuffle=True, seed=cfg.seed,
                divisor=divisor, workers=cfg.loader_workers)
            val_batches = data_lib.StreamingBatches(
                ds, val_idx, batch_size, shuffle=False, divisor=divisor,
                workers=cfg.loader_workers)
        else:
            train_batches = data_lib.Batches(
                xs[train_idx], ys[train_idx], batch_size, shuffle=True,
                seed=cfg.seed, divisor=divisor)
            val_batches = data_lib.Batches(
                xs[val_idx], ys[val_idx], batch_size, shuffle=False,
                divisor=divisor)
        epochs = MeshEpochs(train, evals, mesh_state, train_batches,
                            val_batches)
    elif mode == "scan":
        epochs = ScanEpochs(net, optimizer, loss_fn,
                            (xs[train_idx], ys[train_idx]),
                            (xs[val_idx], ys[val_idx]), batch_size,
                            np.random.default_rng(cfg.seed), device)
    elif ds is not None:
        epochs = StreamEpochs(
            net, optimizer, loss_fn,
            data_lib.StreamingBatches(ds, train_idx, batch_size,
                                      shuffle=True, seed=cfg.seed,
                                      workers=cfg.loader_workers),
            data_lib.StreamingBatches(ds, val_idx, batch_size, shuffle=False,
                                      workers=cfg.loader_workers),
            device)
    else:
        epochs = StreamEpochs(
            net, optimizer, loss_fn,
            data_lib.Batches(xs[train_idx], ys[train_idx], batch_size,
                             shuffle=True, seed=cfg.seed),
            data_lib.Batches(xs[val_idx], ys[val_idx], batch_size,
                             shuffle=False),
            device)
    if restored is not None and "order_rng" in restored:
        # the batches an unbroken run takes from here (see the module
        # docstring)
        epochs.order_rng.bit_generator.state = restored["order_rng"]

    if is_main:
        tracking.set_tracking_uri(cfg.tracking_uri)
        tracking.set_experiment(cfg.experiment_name)
        run_ctx = tracking.start_run()
    else:
        # the other ranks train the same steps and write nothing
        run_ctx = contextlib.nullcontext(
            tracking.ActiveRun(f"process-{rank}"))
    registry_version = None
    final_metrics: dict = {}
    epoch_seconds: list = []
    start_epoch = min(epoch, cfg.epochs)
    # close() on both exits: a failure mid-training still drains the
    # in-flight save without masking the original error
    try:
        with run_ctx as run:
            log_params = tracking.log_params if is_main else (lambda p: None)
            log_metric = (tracking.log_metric if is_main
                          else (lambda *a, **k: None))
            log_params({
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
                "num_devices": divisor,
            })
            if epoch >= cfg.epochs:
                log.warning("checkpoint epoch %d >= cfg.epochs %d; nothing to "
                            "train, evaluating only", epoch, cfg.epochs)
                final_metrics = epochs.validate()
            for epoch in range(start_epoch, cfg.epochs):
                t_epoch = time.time()
                train_loss = epochs.train()
                val = final_metrics = epochs.validate()
                log_metric("train_loss", train_loss, step=epoch)
                log_metric("val_loss", val["loss"], step=epoch)
                log_metric("val_miou", val["miou"], step=epoch)
                log_metric("val_dice", val["dice"], step=epoch)
                epoch_seconds.append(time.time() - t_epoch)
                log.info("epoch %d/%d train_loss=%.4f val_loss=%.4f "
                         "miou=%.4f (%.1fs)", epoch + 1, cfg.epochs,
                         train_loss, val["loss"], val["miou"],
                         epoch_seconds[-1])
                if val["loss"] < best_val_loss:
                    best_val_loss = val["loss"]
                    best_state = _state_copy(net, mesh_state)
                if ((epoch + 1) % cfg.checkpoint_every
                        and epoch + 1 < cfg.epochs):
                    continue
                # gathered on every rank of the model group, before rank 0
                # alone writes
                if mesh_state is not None:
                    model_state = dp.full_state_dict(mesh_state)
                    optimizer_state = dp.full_optimizer_state(mesh_state)
                else:
                    model_state = net.state_dict()
                    optimizer_state = optimizer.state_dict()
                if not is_main:
                    continue
                payload = {
                    "model": model_state,
                    "optimizer": optimizer_state,
                    "epoch": epoch + 1,
                    "best_val_loss": best_val_loss,
                    "best": (best_state if best_state is not None
                             else model_state),
                    "order_rng": epochs.order_rng.bit_generator.state,
                }
                if cfg.async_checkpointing:
                    ckpt.save_async(epoch + 1, payload)
                else:
                    ckpt.save(epoch + 1, payload)
            log_metric("best_val_loss", best_val_loss)
            if register and best_state is not None and is_main:
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
    finally:
        if mode == "scan":
            epochs.close()
    ckpt.close()
    if mesh_state is not None:
        # rank 0's checkpoint and registry writes are done when any rank
        # returns: a resumed run on another rank reads them
        from robotic_discovery_platform_tpu_torch.parallel import collectives

        collectives.barrier(mesh_state.groups.world, device)
    return TrainResult(
        run_id=run_id,
        registry_version=registry_version,
        best_val_loss=best_val_loss,
        final_metrics=final_metrics,
        epochs_run=cfg.epochs - start_epoch,
        wall_clock_s=time.time() - t_start,
        epoch_seconds=epoch_seconds,
    )
