"""Training CLI, the JAX package's ``python -m
robotic_discovery_platform_tpu.training`` on the card.

Usage:
    python -m robotic_discovery_platform_tpu_torch.training \\
        --train.dataset_dir ml/datasets/processed \\
        --train.epochs 50 [--resume] [--no-register] [--device cpu]

Defaults, then an optional ``--config`` JSON file (the ``PlatformConfig``
shape), then ``--section.field`` overrides. Prints the run's
``TrainResult.to_jsonable()`` as one JSON line. Any ``--mesh.*`` override
builds the mesh (``parallel/mesh.make_mesh`` over ``--device``'s type) and
trains data-parallel over it, as the JAX package's CLI does; a
multi-process run joins its process group first
(``parallel/mesh.initialize_distributed``). ``--mesh.model`` or
``--mesh.spatial`` > 1 raises ``NotImplementedError`` (ROADMAP item 34).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    from robotic_discovery_platform_tpu_torch.utils import config as config_lib

    parser = argparse.ArgumentParser(
        prog="python -m robotic_discovery_platform_tpu_torch.training",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file (PlatformConfig shape)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--no-register", action="store_true",
                        help="skip model-registry registration")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    config_lib.add_flags(parser, config_lib.PlatformConfig)
    args = parser.parse_args(argv)
    cfg = config_lib.PlatformConfig()
    if args.config:
        cfg = config_lib.from_dict(config_lib.PlatformConfig,
                                   json.loads(Path(args.config).read_text()))
    cfg = config_lib.apply_flags(cfg, args)
    config_lib.check_supported(cfg.mesh)

    from robotic_discovery_platform_tpu_torch.training.trainer import (
        train_model,
    )

    mesh = None
    if cfg.mesh != config_lib.MeshConfig():
        # any explicit --mesh.* override builds the mesh, as in the JAX
        # package's CLI
        from robotic_discovery_platform_tpu_torch.parallel import mesh as m

        mesh = m.make_mesh(cfg.mesh,
                           device_type=torch_device_type(args.device))
    try:
        res = train_model(cfg.train, cfg.model, resume=args.resume,
                          mesh=mesh, register=not args.no_register,
                          device=args.device)
    except (FileNotFoundError, ValueError) as e:
        # config and dataset problems get a one-line error, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(res.to_jsonable()))
    return 0


def torch_device_type(device: str) -> str:
    """``"cuda"`` or ``"cpu"`` of a ``--device`` value."""
    return device.split(":")[0]


if __name__ == "__main__":
    sys.exit(main())
