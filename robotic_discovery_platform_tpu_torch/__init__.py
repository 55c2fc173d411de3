"""PyTorch/CUDA port of the robotic discovery vision platform for one
NVIDIA H100.

The JAX package ``robotic_discovery_platform_tpu`` is the reference; this
package computes the same functions in PyTorch, with every TPU kernel of
its path rewritten by hand for Hopper (``csrc/``, built at first use by
``ops/build.py``). It imports neither JAX nor the JAX package. Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.

Package map:

- ``utils/config.py``: the configuration fields the serving and training
  paths read;
- ``models/unet.py``, ``models/weights.py``: the unfolded U-Net module
  (the forward's plain reference and the training forward) and weights
  shared with the JAX package's Flax trees and artifact directories;
  ``models/losses.py``: the losses and metrics;
- ``ops/conv.py``: the conv kernels' wrappers and plain versions, and the
  training conv (custom VJP); ``ops/unet_infer.py``: the folded forward
  on those kernels; ``ops/tuning.py``: the per-shape tuning table
  (``CUDA_TUNE.json``) of the 3x3 conv's K splits and the geometry
  stages' paths;
- ``ops/bspline.py``, ``ops/geometry.py``: the curvature profile;
  ``ops/geometry_kernels.py``: the geometry kernels of one frame;
- ``ops/pack.py``: the mask bitpack kernel and the packed row layout;
- ``ops/pipeline.py``: the single-frame and batched (dense and scan)
  analyzers;
  ``ops/quant.py``: the serving precision tiers (bf16 activations, int8
  weight grids) and their parity metrics;
- ``io/frames.py``: frame sources (synthetic scenes, replayed
  collections, the RealSense camera) and calibration files;
- ``serving/``: wire messages, ingest (the decode pool and geometry
  cache), egress (the encode pool), metrics CSV, the servicer
  (built from the registry when given no forward; hot reload, readiness
  and drain) and its gRPC adapter and entry point (``python -m
  robotic_discovery_platform_tpu_torch.serving.server``), the
  grpc.health.v1 service, the batch dispatcher and its admission queue,
  the streaming client (``serving/client.py``), and the serving fleet:
  the front-end (``serving/frontend.py``, ``python -m
  robotic_discovery_platform_tpu_torch.serving.frontend``), its router,
  leases and gossip (``serving/fleet.py``), the capacity planner and
  autoscaler (``serving/planner.py``) and the replica bootstrap
  (``serving/replica.py``);
- ``resilience/``, ``observability/``: the circuit breaker, retry policy
  and fault sites; the metrics registry, ``/metrics`` and ``/debug/*``
  endpoint, spans, event journal, SLO tracker and the fleet's
  ``/federate`` (copies of the JAX package's); ``utils/profiling.py``: stage timers and the
  ``torch.profiler`` capture behind ``/debug/profile``;
- ``training/``: ``train_model`` (and ``python -m
  robotic_discovery_platform_tpu_torch.training``), the data pipeline,
  synthetic data, checkpoints and the restarting supervisor;
  ``tracking/``: the file-backed experiment store and model registry
  shared with the JAX package;
- ``monitoring/``, ``workflows/``: the drift loop -- reference profiles
  and the servicer's drift monitor, the offline detector over the
  metrics CSV, and the retraining workflow that registers, promotes and
  profiles a new version.
"""

from robotic_discovery_platform_tpu_torch.version import __version__

#: public name -> the module that defines it, imported at first use: the
#: fleet front-end (``serving/frontend.py``) imports this package and must
#: load nothing of ``ops/`` or ``models/``
_LAZY = {
    "BatchNorm": "robotic_discovery_platform_tpu_torch.models.unet",
    "FoldedUNet": "robotic_discovery_platform_tpu_torch.ops.unet_infer",
    "GeometryConfig": "robotic_discovery_platform_tpu_torch.utils.config",
    "ModelConfig": "robotic_discovery_platform_tpu_torch.utils.config",
    "ServerConfig": "robotic_discovery_platform_tpu_torch.utils.config",
    "SyntheticSource": "robotic_discovery_platform_tpu_torch.io.frames",
    "TrainConfig": "robotic_discovery_platform_tpu_torch.utils.config",
    "UNet": "robotic_discovery_platform_tpu_torch.models.unet",
    "VisionAnalysisService": "robotic_discovery_platform_tpu_torch.serving.server",
    "build_service": "robotic_discovery_platform_tpu_torch.serving.server",
    "compute_curvature_profile": "robotic_discovery_platform_tpu_torch.ops.geometry",
    "decode_mask_wire": "robotic_discovery_platform_tpu_torch.serving.egress",
    "decode_spline_wire": "robotic_discovery_platform_tpu_torch.serving.egress",
    "default_intrinsics": "robotic_discovery_platform_tpu_torch.serving.ingest",
    "from_flax_variables": "robotic_discovery_platform_tpu_torch.models.weights",
    "iter_frames": "robotic_discovery_platform_tpu_torch.io.frames",
    "load_calibration": "robotic_discovery_platform_tpu_torch.io.frames",
    "load_model_dir": "robotic_discovery_platform_tpu_torch.models.weights",
    "make_frame_analyzer": "robotic_discovery_platform_tpu_torch.ops.pipeline",
    "preprocess": "robotic_discovery_platform_tpu_torch.ops.pipeline",
    "raw_request": "robotic_discovery_platform_tpu_torch.serving.ingest",
    "render_scene": "robotic_discovery_platform_tpu_torch.io.frames",
    "train_model": "robotic_discovery_platform_tpu_torch.training.trainer",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


__all__ = [
    "__version__", "BatchNorm", "FoldedUNet", "GeometryConfig", "ModelConfig",
    "ServerConfig", "SyntheticSource", "TrainConfig", "UNet",
    "VisionAnalysisService", "build_service", "compute_curvature_profile",
    "decode_mask_wire", "decode_spline_wire", "default_intrinsics",
    "from_flax_variables", "iter_frames", "load_calibration", "load_model_dir", "make_frame_analyzer",
    "preprocess", "raw_request", "render_scene", "train_model",
]
