"""Import a trained reference (PyTorch) U-Net checkpoint into the port.

The reference trains ``UNet(3, 1)`` and saves its ``state_dict()`` as a
``.pth`` file before registering it in MLflow. This tool reads that file
straight into the port's :class:`models.unet.UNet`, with no Flax tree in
between, and can register the result:

    python -m robotic_discovery_platform_tpu_torch.tools.import_torch_weights \\
        best_segmentation_model.pth --register --tracking-uri http://host:5000

The mapping is structural, not by name, as in the JAX package's tool:
both networks define their layers in the same order (inc, down1-4, up1-4,
outc; each DoubleConv conv, bn, conv, bn), so the checkpoint's tensors
are taken in ``state_dict`` order against a fixed walk of the port's
parameters, with a shape check at every step. When the checkpoint uses the
reference's module names, each tensor's stage is also checked against the
slot it lands in.

Layouts: conv weights OIHW -> the port's HWIO kernels; a transposed
conv's ``[Cin, Cout, kH, kW]`` weight -> the port's ``[2, 2, Cin, Cout]``
kernel, whose taps are stored flipped (the JAX package's Flax layout,
which the port keeps so that registry artifacts carry across);
BatchNorm's (weight, bias, running_mean, running_var) -> (scale, bias,
mean, var); ``num_batches_tracked`` is dropped. The file is read with
``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _slot_order(cfg: ModelConfig):
    """The port's module tree walked in the reference's ``state_dict``
    order: ``(path, kind)``, kind one of conv / convt / bn / head."""

    def double_conv(*prefix):
        yield (*prefix, "Conv_0"), "conv"
        yield (*prefix, "BatchNorm_0"), "bn"
        yield (*prefix, "Conv_1"), "conv"
        yield (*prefix, "BatchNorm_1"), "bn"

    yield from double_conv("DoubleConv_0")  # inc
    for i in range(4):  # down1..down4
        yield from double_conv(f"Down_{i}", "DoubleConv_0")
    for i in range(4):  # up1..up4
        if not cfg.bilinear:
            yield (f"Up_{i}", "ConvTranspose_0"), "convt"
        yield from double_conv(f"Up_{i}", "DoubleConv_0")
    yield ("Conv_0",), "head"


def _stage_of_path(path: tuple) -> str:
    """The reference's top-level module name for a slot path."""
    head = path[0]
    if head == "DoubleConv_0":
        return "inc"
    if head.startswith("Down_"):
        return f"down{int(head.split('_')[1]) + 1}"
    if head.startswith("Up_"):
        return f"up{int(head.split('_')[1]) + 1}"
    return "outc"


_REFERENCE_STAGES = frozenset(
    ["inc", "outc"]
    + [f"down{i}" for i in range(1, 5)]
    + [f"up{i}" for i in range(1, 5)]
)


def _make_stage_check(tensor_names):
    """Structural order survives renames but not a swap of two slots of one
    shape; a checkpoint with the reference's module names has each
    tensor's stage checked against its slot. Other names skip the check
    (with a log line)."""
    tops = {n.split(".", 1)[0] for n in tensor_names}
    if not tops <= _REFERENCE_STAGES:
        log.info(
            "state_dict does not use reference module names (%s); "
            "name/slot cross-check disabled, trusting structural order",
            sorted(tops - _REFERENCE_STAGES)[:3],
        )
        return lambda name, path: None

    def check_stage(name: str, path: tuple) -> None:
        want = _stage_of_path(path)
        got = name.split(".", 1)[0]
        if got != want:
            raise ValueError(
                f"tensor {name!r} is about to be mapped into stage "
                f"{want!r} -- structural order and checkpoint names "
                "disagree (reordered or architecture-mismatched "
                "state_dict)"
            )

    return check_stage


def _as_array(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def convert_state_dict(state_dict: dict,
                       cfg: ModelConfig = ModelConfig()) -> UNet:
    """A reference ``state_dict`` (name -> tensor or array) -> the port's
    :class:`UNet` for ``cfg`` holding it, on the CPU in eval mode."""
    if cfg.norm != "batch":
        raise ValueError(
            f"the reference checkpoint has BatchNorm layers; got "
            f"norm={cfg.norm!r}")
    tensors = [(name, _as_array(t)) for name, t in state_dict.items()
               if not name.endswith("num_batches_tracked")]
    queue = list(tensors)

    def take(n: int):
        nonlocal queue
        if len(queue) < n:
            raise ValueError(
                f"checkpoint exhausted: needed {n} more tensors "
                f"(wrong architecture or truncated state_dict?)"
            )
        head, queue = queue[:n], queue[n:]
        return head

    net = UNet(cfg)
    target = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    state: dict[str, torch.Tensor] = {}
    check_stage = _make_stage_check([n for n, _ in tensors])

    def mismatch(key: str, name: str, value: np.ndarray, slot):
        return ValueError(
            f"shape mismatch at {slot}: checkpoint tensor {name!r} has "
            f"{tuple(value.shape)}, model expects {target[key]}")

    def put(key: str, name: str, value: np.ndarray, slot,
            axes: tuple | None = None) -> None:
        """``value`` (its axes permuted by ``axes``) into ``key``."""
        if axes is not None:
            if value.ndim != len(axes):
                raise mismatch(key, name, value, slot)
            value = value.transpose(axes)
        if tuple(value.shape) != target[key]:
            raise mismatch(key, name, value, slot)
        state[key] = torch.from_numpy(np.ascontiguousarray(value))

    for path, kind in _slot_order(cfg):
        prefix = ".".join(path)
        if kind in ("conv", "head"):
            got = take(1 if kind == "conv" else 2)  # the head has a bias
            for tname, _ in got:
                check_stage(tname, path)
            name, w = got[0]
            put(f"{prefix}.kernel", name, w, path, (2, 3, 1, 0))
            if kind == "head":
                put(f"{prefix}.bias", *got[1], path)
        elif kind == "convt":
            (name, w), (bname, b) = take(2)
            check_stage(name, path)
            check_stage(bname, path)
            # [Cin, Cout, kH, kW] -> [kH, kW, Cin, Cout], taps flipped: the
            # port's kernel layout is the Flax one (models/unet.py)
            put(f"{prefix}.kernel", name,
                w[:, :, ::-1, ::-1] if w.ndim == 4 else w, path, (2, 3, 0, 1))
            put(f"{prefix}.bias", bname, b, path)
        else:  # bn: weight, bias, running_mean, running_var
            got = take(4)
            for tname, _ in got:
                check_stage(tname, path)
            for leaf, (name, value) in zip(("scale", "bias", "mean", "var"),
                                           got):
                put(f"{prefix}.{leaf}", name, value, path)
    if queue:
        raise ValueError(
            f"{len(queue)} unconsumed checkpoint tensors (first: "
            f"{queue[0][0]!r}) -- architecture mismatch"
        )
    net.load_state_dict(state, strict=True)
    return net.eval()


def import_checkpoint(path: str | Path, cfg: ModelConfig = ModelConfig(),
                      register: bool = False,
                      registered_model_name: str = "Actuator-Segmenter"
                      ) -> tuple[UNet, int | None]:
    """Load a reference ``.pth`` state_dict into the port's :class:`UNet`
    and, with ``register``, log it as a new version of
    ``registered_model_name`` through the port's tracking API (the
    current tracking URI: a ``file:`` store or an MLflow server). Returns
    ``(net, version)``, version None unless registered."""
    state_dict = torch.load(str(path), map_location="cpu",
                            weights_only=True)
    net = convert_state_dict(state_dict, cfg)
    if not register:
        return net, None
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models.weights import (
        to_flax_variables,
    )

    with tracking.start_run(run_name="torch-import"):
        tracking.log_params({"imported_from": str(path)})
        version = tracking.log_model(
            to_flax_variables(net), cfg,
            registered_model_name=registered_model_name)
    log.info("imported %s as %s version %s", path, registered_model_name,
             version)
    return net, version


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="reference state_dict .pth file")
    ap.add_argument("--register", action="store_true",
                    help="register the imported model in the registry")
    ap.add_argument("--tracking-uri", default=None)
    args = ap.parse_args(argv)
    if args.tracking_uri:
        from robotic_discovery_platform_tpu_torch import tracking

        tracking.set_tracking_uri(args.tracking_uri)
    _, version = import_checkpoint(args.checkpoint, register=args.register)
    print(f"imported {args.checkpoint}"
          + (f" -> registry version {version}" if version else ""))


if __name__ == "__main__":
    main()
