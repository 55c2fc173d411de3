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
from robotic_discovery_platform_tpu_torch.monitoring.profile import (
    capture_feature_profile,
)
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops import build, pipeline
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
    build_service,
)
from robotic_discovery_platform_tpu_torch.training.synthetic import (
    generate_arrays,
)
from robotic_discovery_platform_tpu_torch.training.trainer import (
    resolve_epoch_mode,
    train_model,
)
from robotic_discovery_platform_tpu_torch.utils import config
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "robotic_discovery_platform_tpu")


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
        "import robotic_discovery_platform_tpu_torch.ops.decode\n"
        "import robotic_discovery_platform_tpu_torch.serving.batching\n"
        "import robotic_discovery_platform_tpu_torch.serving.admission\n"
        "import robotic_discovery_platform_tpu_torch.training.trainer\n"
        "import robotic_discovery_platform_tpu_torch.training.__main__\n"
        "import robotic_discovery_platform_tpu_torch.tracking\n"
        "import robotic_discovery_platform_tpu_torch.resilience\n"
        "import robotic_discovery_platform_tpu_torch.observability.instruments\n"
        "import robotic_discovery_platform_tpu_torch.observability.exposition\n"
        "import robotic_discovery_platform_tpu_torch.observability.sketch\n"
        "import robotic_discovery_platform_tpu_torch.serving.health\n"
        "import robotic_discovery_platform_tpu_torch.serving.proto.health_pb2\n"
        "import robotic_discovery_platform_tpu_torch.monitoring.profile\n"
        "import robotic_discovery_platform_tpu_torch.monitoring.drift\n"
        "import robotic_discovery_platform_tpu_torch.workflows.retraining\n"
        "import robotic_discovery_platform_tpu_torch.training.supervisor\n"
        "import robotic_discovery_platform_tpu_torch.serving.client\n"
        "import robotic_discovery_platform_tpu_torch.serving.controller\n"
        "import robotic_discovery_platform_tpu_torch.serving.zoo\n"
        "import robotic_discovery_platform_tpu_torch.serving.rollout\n"
        "import robotic_discovery_platform_tpu_torch.models.variants\n"
        "import robotic_discovery_platform_tpu_torch.serving.proto.vision_grpc\n"
        "import robotic_discovery_platform_tpu_torch.tracking.rest_backend\n"
        "import robotic_discovery_platform_tpu_torch.tools.import_torch_weights\n"
        "import robotic_discovery_platform_tpu_torch.tools.geometry_parity\n"
        "import robotic_discovery_platform_tpu_torch.tools.make_dataset\n"
        "import robotic_discovery_platform_tpu_torch.tools.collect_data\n"
        "import robotic_discovery_platform_tpu_torch.tools.calibrate_camera\n"
        "import robotic_discovery_platform_tpu_torch.utils.flops\n"
        "import robotic_discovery_platform_tpu_torch.utils.transferguard\n"
        "import robotic_discovery_platform_tpu_torch.ops.tuning\n"
        "import robotic_discovery_platform_tpu_torch.serving.fleet\n"
        "import robotic_discovery_platform_tpu_torch.serving.frontend\n"
        "import robotic_discovery_platform_tpu_torch.serving.planner\n"
        "import robotic_discovery_platform_tpu_torch.serving.replica\n"
        "import robotic_discovery_platform_tpu_torch.observability.federation\n"
        "import robotic_discovery_platform_tpu_torch.sim\n"
        "import robotic_discovery_platform_tpu_torch.sim.calibrate\n"
        "import robotic_discovery_platform_tpu_torch.sim.sweep\n"
        "import robotic_discovery_platform_tpu_torch.analysis.explore\n"
        "import robotic_discovery_platform_tpu_torch.analysis.statecheck\n"
        "import robotic_discovery_platform_tpu_torch.parallel\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("serving.server", "serving.batching", "ops.pack",
                   "ops.geometry_kernels", "training.trainer",
                   "training.checkpoint", "tracking.store", "models.losses",
                   "ops.decode", "serving.entropy", "serving.health",
                   "serving.proto.health_pb2", "resilience.breaker",
                   "resilience.faults", "resilience.policy",
                   "resilience.sites", "observability.registry",
                   "observability.exposition", "observability.instruments",
                   "observability.journal", "observability.recorder",
                   "observability.slo", "observability.sketch",
                   "observability.trace", "observability.events",
                   "observability.families", "utils.logging",
                   "utils.lockcheck", "utils.profiling",
                   "monitoring.profile", "monitoring.drift",
                   "workflows.retraining", "training.supervisor",
                   "serving.client", "serving.proto.vision_grpc",
                   "serving.ingest", "serving.egress", "io.frames",
                   "serving.controller", "serving.zoo", "serving.rollout",
                   "models.variants", "tracking.rest_backend",
                   "tools.import_torch_weights", "tools.geometry_parity",
                   "tools.make_dataset", "tools.collect_data",
                   "tools.calibrate_camera", "utils.flops",
                   "utils.transferguard", "ops.tuning", "serving.fleet",
                   "serving.frontend", "serving.planner", "serving.replica",
                   "observability.federation", "sim.engine", "sim.model",
                   "sim.workload", "sim.metrics", "sim.scenario",
                   "sim.cluster", "sim.calibrate", "sim.sweep",
                   "analysis.explore", "analysis.statecheck",
                   "parallel.mesh"):
        assert f"robotic_discovery_platform_tpu_torch.{module}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # the REST store speaks HTTP through the standard library: the card's
    # machine has no requests
    assert "requests" not in loaded

    # chip_smoke, the port's serving cost harness and its tuning tool
    for script in ("chip_smoke.py", "tools/torch_serving_cost.py",
                   "tools/tune_kernels.py"):
        imported = set()
        for node in ast.walk(ast.parse((REPO / script).read_text())):
            if isinstance(node, ast.Import):
                imported.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                imported.add(node.module)
        assert imported and not [m for m in imported if _forbidden(m)], (
            script)
    for path in (REPO / "robotic_discovery_platform_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not [m for m in names if _forbidden(m)
                        or m == "requests"], path


def _tiny_net():
    cfg = config.ModelConfig(base_features=4)
    return tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("entry", ["resolve_device", "FoldedUNet",
                                   "make_frame_analyzer",
                                   "VisionAnalysisService", "load_model_dir",
                                   "make_batch_analyzer", "BatchDispatcher",
                                   "train_model", "build_service",
                                   "capture_feature_profile"])
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
        "train_model": lambda **kw: train_model(
            config.TrainConfig(epochs=1, img_size=16, batch_size=2,
                               tracking_uri=f"file:{tmp_path}/mlruns",
                               checkpoint_dir=str(tmp_path / "ckpt")),
            config.ModelConfig(base_features=4),
            arrays=generate_arrays(4, 16, 16), register=False, **kw),
        "build_service": lambda **kw: build_service(
            config.ServerConfig(metrics_csv=str(tmp_path / "m.csv"),
                                calibration_path=str(tmp_path / "none.npz")),
            folded, **kw),
        "capture_feature_profile": lambda **kw: capture_feature_profile(
            net, [(np.zeros((24, 32, 3), np.uint8),
                   np.zeros((24, 32), np.uint16))], img_size=32, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    made = calls[entry](device="cpu")
    assert made is not None
    if entry == "BatchDispatcher":
        made.stop()
    if entry == "build_service":
        made.close()
    if entry == "load_model_dir":
        _, loaded = calls[entry](device="cpu")
        for key, value in net.state_dict().items():
            assert torch.equal(loaded.state_dict()[key], value), key


@pytest.mark.parametrize("case", ["kernel_impl_default", "kernel_impl_auto",
                                  "kernel_impl_pallas", "precision_bf16",
                                  "batch_window", "bilinear_false",
                                  "norm_group", "flags", "batch_impl_scan",
                                  "serving_mesh", "egress_pack_off",
                                  "egress_workers", "env_override",
                                  "conv_impl", "train_defaults",
                                  "mesh_section", "drift_fields",
                                  "zoo_controller_rollout_fields"])
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
        # the tiers are served (tests/test_torch_port_quant.py), but only
        # with the untransformed net for the warm-up gate; an unknown tier
        # is refused
        monkeypatch.delenv("RDP_PRECISION", raising=False)
        with pytest.raises(ValueError, match="untransformed net"):
            VisionAnalysisService(lambda x: x,
                                  cfg=config.ServerConfig(precision="bf16"),
                                  device="cpu")
        config.check_supported(config.ServerConfig(precision="bf16"))
        with pytest.raises(ValueError, match="unknown precision"):
            config.check_supported(config.ServerConfig(precision="fp4"))
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
    elif case in ("batch_impl_scan", "egress_pack_off", "egress_workers",
                  "env_override"):
        # batched serving takes these (tests/test_torch_port_host_path.py
        # serves with each); an unknown batch_impl is refused
        fields = {"batch_impl_scan": {"batch_impl": "scan"},
                  "egress_pack_off": {"egress_pack": False},
                  "egress_workers": {"egress_workers": 2},
                  "env_override": {}}[case]
        if case == "env_override":
            for var in ("RDP_INFLIGHT", "RDP_EGRESS_WORKERS",
                        "RDP_DECODE_WORKERS"):
                monkeypatch.setenv(var, "3")
        cfg = config.ServerConfig(batch_window_ms=2.0, model_img_size=32,
                                  metrics_csv=str(tmp_path / "m.csv"),
                                  **fields)
        service = VisionAnalysisService(lambda x: x, cfg=cfg, device="cpu")
        try:
            if case == "env_override":
                assert (service.dispatcher.max_inflight,
                        service.egress.workers, service.ingest.workers) == (
                            3, 3, 3)
            if case == "egress_workers":
                assert service.egress.workers == 2
        finally:
            service.close()
        with pytest.raises(ValueError, match="unknown batch_impl"):
            config.check_supported(dataclasses.replace(cfg,
                                                       batch_impl="loop"))
    elif case == "serving_mesh":
        # the multi-device router is ported (tests/test_torch_port_mesh_
        # routing.py): a ring wider than the devices is refused with the
        # JAX package's words, one device builds no mesh, and an unknown
        # dispatch mode (field or RDP_DISPATCH_MODE) is refused
        cfg = config.ServerConfig(batch_window_ms=2.0, serving_mesh=2)
        with pytest.raises(ValueError, match="only 1 devices"):
            VisionAnalysisService(lambda x: x, cfg=cfg, device="cpu")
        config.check_supported(dataclasses.replace(cfg, batch_window_ms=0.0))
        service = VisionAnalysisService(
            lambda x: x, cfg=dataclasses.replace(cfg, serving_mesh=-1),
            device="cpu")
        try:
            assert service.serving_chips == 1
            assert service.dispatcher.router is None
        finally:
            service.close()
        with monkeypatch.context() as m:
            m.setenv("RDP_DISPATCH_MODE", "diagonal")
            with pytest.raises(ValueError, match="unknown dispatch mode"):
                VisionAnalysisService(lambda x: x, cfg=dataclasses.replace(
                    cfg, serving_mesh=0), device="cpu")
    elif case == "conv_impl":
        for impl in config.CONV_IMPLS:
            config.check_supported(config.ModelConfig(conv_impl=impl))
        with pytest.raises(ValueError, match="unknown conv_impl"):
            tunet.UNet(config.ModelConfig(conv_impl="cudnn"))
    elif case == "train_defaults":
        # the JAX package's names and defaults; every epoch mode taken
        cfg = config.parse_config(["--train.epochs", "3",
                                   "--train.loss", "bce_dice"])
        assert (cfg.train.epochs, cfg.train.loss) == (3, "bce_dice")
        assert (config.TrainConfig().learning_rate,
                config.TrainConfig().batch_size,
                config.TrainConfig().registered_model_name,
                config.ServerConfig().model_alias) == (
                    1e-4, 4, "Actuator-Segmenter", "staging")
        config.check_supported(config.TrainConfig(epoch_mode="stream"))
        scan = config.TrainConfig(epoch_mode="scan")
        config.check_supported(scan)
        # and taken: in-memory data trains in the scan epoch
        assert resolve_epoch_mode(scan, data_bytes=1 << 20) == "scan"
    elif case == "drift_fields":
        # the eight drift_* fields and the drift section, the JAX
        # package's names and defaults; the monitor is on by default
        cfg = config.ServerConfig()
        assert cfg.drift_enabled is True
        assert (cfg.drift_profile_path, cfg.drift_window,
                cfg.drift_baseline_frames, cfg.drift_score_every,
                cfg.drift_psi_threshold, cfg.drift_sustain_s,
                cfg.drift_cooldown_s) == ("", 256, 64, 16, 0.25, 5.0, 300.0)
        assert config.from_dict(config.ServerConfig, {
            "drift_enabled": False, "drift_window": 32}).drift_window == 32
        parsed = config.parse_config(["--drift.min_rows", "10",
                                      "--server.drift_sustain_s", "0.5"])
        assert parsed.drift.min_rows == 10
        assert parsed.server.drift_sustain_s == 0.5
        # all 85 of the JAX package's: the seven controller_* and seven
        # zoo_* fields joined the 47, then the 21 fleet_*, autoscaler_*
        # and planner_* fields, then the router's three
        assert len(dataclasses.fields(config.ServerConfig)) == 85
    elif case == "zoo_controller_rollout_fields":
        # the seven controller_* and seven zoo_* fields and the rollout
        # section: the JAX package's names and defaults, taken by from_dict
        from robotic_discovery_platform_tpu.utils import config as jconfig

        for prefix in ("controller_", "zoo_"):
            names = [f.name for f in dataclasses.fields(jconfig.ServerConfig)
                     if f.name.startswith(prefix)]
            assert len(names) == 7
            for name in names:
                assert (getattr(config.ServerConfig(), name)
                        == getattr(jconfig.ServerConfig(), name)), name
        cfg = config.from_dict(config.ServerConfig, {
            "zoo_models": "multi,aux", "zoo_eager_warm": -1,
            "controller_enabled": True})
        assert cfg.zoo_models == "multi,aux" and cfg.controller_enabled
        assert (dataclasses.asdict(config.RolloutConfig())
                == dataclasses.asdict(jconfig.RolloutConfig()))
        platform = config.from_dict(config.PlatformConfig, {
            "rollout": {"candidate_alias": "cand"}})
        assert platform.rollout.candidate_alias == "cand"
        # a roster with an unknown variant refuses to build a servicer
        with pytest.raises(ValueError, match="unknown zoo model"):
            VisionAnalysisService(lambda x: x, cfg=config.ServerConfig(
                zoo_models="bogus"), device="cpu")
    elif case == "mesh_section":
        # every mesh shape is taken, and a train step runs over any of them
        # (tests/test_torch_port_parallel.py, test_torch_port_tp_spatial.py)
        config.check_supported(config.MeshConfig())
        config.check_supported(config.MeshConfig(data=2, model=2))
    elif case == "bilinear_false":
        # the transposed-conv decoder builds: a ConvTranspose_0 in each Up,
        # the ladder ending at 16x the base width
        config.check_supported(config.ModelConfig(bilinear=False))
        net = tunet.UNet(config.ModelConfig(bilinear=False, base_features=4))
        assert tuple(net.Up_0.ConvTranspose_0.kernel.shape) == (2, 2, 64, 32)
        assert tuple(net.Down_3.DoubleConv_0.Conv_1.kernel.shape) == (
            3, 3, 64, 64)
    elif case == "norm_group":
        # group norm is ported: the net builds with Flax's GroupNorm_0 and
        # GroupNorm_1 in each DoubleConv, gcd(32, C) groups, no statistics
        config.check_supported(config.ModelConfig(norm="group"))
        net = tunet.UNet(config.ModelConfig(norm="group", base_features=4))
        gn = net.Down_3.DoubleConv_0.GroupNorm_0
        assert isinstance(gn, tunet.GroupNorm) and gn.groups == 32
        assert net.DoubleConv_0.GroupNorm_1.groups == 4
        assert not any(k.endswith((".mean", ".var"))
                       for k in net.state_dict())
        assert not hasattr(net.DoubleConv_0, "BatchNorm_0")
        with pytest.raises(ValueError, match="unknown norm"):
            config.check_supported(config.ModelConfig(norm="layer"))
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


def test_kernel_build_is_keyed_on_the_shared_headers(tmp_path):
    """Editing a header of csrc/ (which any source may include) changes
    every kernel's library path; an unrelated file does not."""
    csrc = Path(shutil.copytree(build.CSRC, tmp_path / "csrc"))
    before = {n: build.library_path(n, csrc) for n in build.SOURCES}
    assert before == {n: build.library_path(n) for n in build.SOURCES}
    (csrc / "notes.txt").write_text("not a source")
    assert {n: build.library_path(n, csrc) for n in build.SOURCES} == before
    header = csrc / "conv_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, csrc) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_kernel_build_keeps_the_ptxas_report_beside_the_library(
        tmp_path, monkeypatch):
    """nvcc's output is written beside the library it built, so a later
    process that only loads the library still reads its ptxas report; a
    library whose report is missing is built again."""
    report = "ptxas info    : Used 40 registers, 0 bytes stack frame"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n"
        f"print({report!r})\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    assert build.build_log("conv1x1") is None
    assert build.build(["conv1x1"]) > 0
    assert build.library_path("conv1x1").read_bytes() == b"lib"
    assert build.log_path("conv1x1") == build.library_path(
        "conv1x1").with_suffix(".log")
    assert build.build_log("conv1x1").strip() == report
    assert build.build(["conv1x1"]) == 0.0  # built: nothing to do
    build.log_path("conv1x1").unlink()
    assert build.build(["conv1x1"]) > 0
    assert build.build_log("conv1x1").strip() == report
    assert sorted(p.suffix for p in build.BUILD_DIR.iterdir()) == [
        ".log", ".so"]


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
