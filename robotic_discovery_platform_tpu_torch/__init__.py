"""PyTorch/CUDA port of the robotic discovery vision platform for one
NVIDIA H100.

The JAX package ``robotic_discovery_platform_tpu`` is the reference; this
package computes the same functions in PyTorch, with every TPU kernel of
its path rewritten by hand for Hopper (``csrc/``, built at first use by
``ops/build.py``). It imports neither JAX nor the JAX package. Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.

Package map:

- ``utils/config.py``: the configuration fields the serving path reads;
- ``models/unet.py``, ``models/weights.py``: the unfolded U-Net module
  (the forward's plain reference) and weights carried from the JAX
  package's Flax trees and artifact directories;
- ``ops/conv.py``: the conv kernels' wrappers and plain versions;
  ``ops/unet_infer.py``: the folded forward on those kernels;
- ``ops/bspline.py``, ``ops/geometry.py``: the curvature profile;
- ``ops/pipeline.py``: the single-frame analyzer;
- ``io/frames.py``: synthetic scenes and calibration files;
- ``serving/``: wire messages, ingest, egress, metrics CSV, the servicer
  and its gRPC adapter.
"""

from robotic_discovery_platform_tpu_torch.io.frames import (
    SyntheticSource,
    load_calibration,
    render_scene,
)
from robotic_discovery_platform_tpu_torch.models.unet import BatchNorm, UNet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
    load_model_dir,
)
from robotic_discovery_platform_tpu_torch.ops.geometry import (
    compute_curvature_profile,
)
from robotic_discovery_platform_tpu_torch.ops.pipeline import (
    make_frame_analyzer,
    preprocess,
)
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving.egress import decode_mask_wire
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
    raw_request,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ModelConfig,
    ServerConfig,
)

__all__ = [
    "BatchNorm", "FoldedUNet", "GeometryConfig", "ModelConfig",
    "ServerConfig", "SyntheticSource", "UNet", "VisionAnalysisService",
    "compute_curvature_profile", "decode_mask_wire", "default_intrinsics",
    "from_flax_variables", "load_calibration", "load_model_dir",
    "make_frame_analyzer", "preprocess", "raw_request", "render_scene",
]
