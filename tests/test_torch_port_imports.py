"""The port's boundaries: it imports no JAX and nothing of the JAX package,
its entry points run on the card unless asked for the CPU, its config
refuses what this slice does not implement, and chip_smoke.py refuses to
run without a card."""

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops import build, pipeline
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils import config
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "robotic_discovery_platform_tpu")


def _forbidden(name: str) -> bool:
    # robotic_discovery_platform_tpu_torch is the port itself, not a match
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import json, sys\n"
        "import robotic_discovery_platform_tpu_torch\n"
        "import robotic_discovery_platform_tpu_torch.serving.server\n"
        "import robotic_discovery_platform_tpu_torch.serving.grpc_service\n"
        "import robotic_discovery_platform_tpu_torch.ops.build\n"
        "import robotic_discovery_platform_tpu_torch.ops.geometry_kernels\n"
        "import robotic_discovery_platform_tpu_torch.ops.pack\n"
        "import robotic_discovery_platform_tpu_torch.serving.batching\n"
        "import robotic_discovery_platform_tpu_torch.serving.admission\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("serving.server", "serving.batching", "ops.pack",
                   "ops.geometry_kernels"):
        assert f"robotic_discovery_platform_tpu_torch.{module}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []

    imported = set()
    for node in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    assert imported and not [m for m in imported if _forbidden(m)]
    for path in (REPO / "robotic_discovery_platform_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not [m for m in names if _forbidden(m)], path


def _tiny_net():
    cfg = config.ModelConfig(base_features=4)
    return tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("entry", ["resolve_device", "FoldedUNet",
                                   "make_frame_analyzer",
                                   "VisionAnalysisService", "load_model_dir",
                                   "make_batch_analyzer", "BatchDispatcher"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """With no CUDA device, the default device raises; ``device="cpu"``
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = _tiny_net()
    folded = FoldedUNet(net, device="cpu")
    if entry == "load_model_dir":
        from flax import serialization

        (tmp_path / "model_config.json").write_text(
            json.dumps({"base_features": 4}))
        tree = {"params": {}, "batch_stats": {}}
        for key, value in net.state_dict().items():
            kind = ("batch_stats" if key.rsplit(".", 1)[1] in ("mean", "var")
                    else "params")
            node = tree[kind]
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value.numpy()
        (tmp_path / "variables.msgpack").write_bytes(
            serialization.msgpack_serialize(tree))
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "FoldedUNet": lambda **kw: FoldedUNet(net, **kw),
        "make_frame_analyzer": lambda **kw: pipeline.make_frame_analyzer(
            folded, img_size=32, **kw),
        "VisionAnalysisService": lambda **kw: VisionAnalysisService(
            folded, cfg=config.ServerConfig(
                metrics_csv=str(tmp_path / "m.csv")), **kw),
        "load_model_dir": lambda **kw: weights.load_model_dir(tmp_path, **kw),
        "make_batch_analyzer": lambda **kw: pipeline.make_batch_analyzer(
            folded, img_size=32, pack=True, **kw),
        "BatchDispatcher": lambda **kw: BatchDispatcher(
            lambda *a: None, watchdog_interval_s=0.0, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    made = calls[entry](device="cpu")
    assert made is not None
    if entry == "BatchDispatcher":
        made.stop()
    if entry == "load_model_dir":
        _, loaded = calls[entry](device="cpu")
        for key, value in net.state_dict().items():
            assert torch.equal(loaded.state_dict()[key], value), key


@pytest.mark.parametrize("case", ["kernel_impl_default", "kernel_impl_auto",
                                  "kernel_impl_pallas", "precision_bf16",
                                  "batch_window", "bilinear_false",
                                  "norm_group", "flags", "batch_impl_scan",
                                  "serving_mesh", "egress_pack_off",
                                  "egress_workers", "env_override"])
def test_config_refuses_what_the_slice_lacks(case, tmp_path, monkeypatch):
    if case == "kernel_impl_default":
        assert config.GeometryConfig().kernel_impl == "auto"
        config.check_supported(config.GeometryConfig())
    elif case.startswith("kernel_impl_"):
        # the fused geometry path, accepted; an unknown name is refused
        impl = case.split("_")[-1]
        assert pipeline.make_frame_analyzer(
            lambda x: x, geom_cfg=config.GeometryConfig(kernel_impl=impl),
            device="cpu") is not None
        with pytest.raises(ValueError, match="unknown kernel_impl"):
            config.check_supported(config.GeometryConfig(kernel_impl="cuda"))
    elif case == "precision_bf16":
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            VisionAnalysisService(lambda x: x,
                                  cfg=config.ServerConfig(precision="bf16"),
                                  device="cpu")
    elif case == "batch_window":
        # batched serving builds (and stops) with the JAX package's defaults
        cfg = config.ServerConfig(batch_window_ms=2.0,
                                  metrics_csv=str(tmp_path / "m.csv"))
        assert (cfg.max_batch, cfg.batch_impl, cfg.max_inflight_dispatches,
                cfg.serving_mesh, cfg.egress_pack, cfg.submit_deadline_s,
                cfg.max_backlog, cfg.watchdog_interval_s,
                cfg.admission_policy) == (8, "dense", 2, 0, True, 30.0, 64,
                                          1.0, "deadline")
        service = VisionAnalysisService(lambda x: x, cfg=cfg, device="cpu")
        assert service.dispatcher is not None
        assert service.dispatcher.max_inflight == 2
        service.close()
    elif case in ("batch_impl_scan", "serving_mesh", "egress_pack_off",
                  "egress_workers", "env_override"):
        fields = {"batch_impl_scan": {"batch_impl": "scan"},
                  "serving_mesh": {"serving_mesh": 2},
                  "egress_pack_off": {"egress_pack": False},
                  "egress_workers": {"egress_workers": 2},
                  "env_override": {}}[case]
        if case == "env_override":
            monkeypatch.setenv("RDP_INFLIGHT", "4")
        cfg = config.ServerConfig(batch_window_ms=2.0, **fields)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 16"):
            VisionAnalysisService(lambda x: x, cfg=cfg, device="cpu")
        # the direct path reads none of these settings
        config.check_supported(dataclasses.replace(cfg, batch_window_ms=0.0))
    elif case in ("bilinear_false", "norm_group"):
        cfg = (config.ModelConfig(bilinear=False) if case == "bilinear_false"
               else config.ModelConfig(norm="group"))
        with pytest.raises(NotImplementedError):
            tunet.UNet(cfg)
    else:
        (tmp_path / "c.json").write_text(json.dumps(
            {"model": {"base_features": 16}}))
        cfg = config.parse_config(["--config", str(tmp_path / "c.json"),
                                   "--server.model_img_size", "128",
                                   "--geometry.stride", "2",
                                   "--model.bilinear", "true"])
        assert cfg.model.base_features == 16
        assert cfg.server.model_img_size == 128
        assert cfg.geometry.stride == 2 and cfg.model.bilinear is True
        with pytest.raises(ValueError, match="unknown config keys"):
            config.from_dict(config.ModelConfig, {"widths": 3})


def test_kernel_build_is_keyed_on_the_sources():
    """Each kernel's library name carries a hash of its source and flags;
    nothing is built at import time, and where no nvcc exists the build
    says so."""
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-")
        assert (build.CSRC / build.SOURCES[name]).is_file()
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: exit non-zero, no result line. A directory holding
    chip_smoke.py and nothing else of the repo fails the same way."""
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
        assert np.all([not line.startswith("{") for line in
                       out.stdout.splitlines()])
