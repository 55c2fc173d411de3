"""The model zoo's variant catalog: the named model generations a serving
process can hold side by side (``serving/zoo.py``), the port's copy of the
JAX package's ``models/variants.py``.

The catalog is declarations and builders only; config resolution reads it
before any device exists.

Variants:

- ``seg``: the binary actuator segmenter, the default model. An empty
  ``AnalysisRequest.model`` resolves here, so clients that name no model
  are served as by a server without a zoo. Registry entry: the server's
  configured ``model_name`` ("Actuator-Segmenter").
- ``multi``: the multi-actuator variant, the same U-Net with a 4-channel
  multi-label head (``ModelConfig.num_classes = 4``; a pixel joins the
  union mask when any class fires, ``ops/pipeline.logits_to_native_masks``).
- ``aux``: the defect/anomaly head, a quarter-width U-Net whose per-frame
  anomaly score is read off the confidence margin the frame already
  computes (mean |sigmoid - 0.5|).

``ServerConfig.zoo_models`` / ``RDP_ZOO_MODELS`` pick the set ("" = the
default single-model server, bit for bit the path without a zoo).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig

_ZOO_ENV_VAR = "RDP_ZOO_MODELS"

#: the variant an empty wire ``model`` field resolves to
DEFAULT_MODEL = "seg"

#: head semantics: "segment" serves the mask/curvature contract as it is;
#: "anomaly" also derives a per-frame anomaly score from the confidence
#: margin and reports it in the response status
HEADS = ("segment", "anomaly")


@dataclass(frozen=True)
class ModelVariant:
    """One zoo catalog entry (a declaration; the serving layer builds its
    analyzers per generation)."""

    name: str
    #: registered-model name in the tracking registry; None = the server's
    #: configured ``ServerConfig.model_name``
    registered_name: str | None
    #: output channels of the 1x1 head (1 = binary; K > 1 = multi-label)
    num_classes: int
    #: channel-width multiplier on ``ModelConfig.base_features``
    width_scale: float
    head: str
    description: str

    def model_config(self, base: ModelConfig) -> ModelConfig:
        """The variant's ModelConfig derived from the serving base config
        (dtype, norm and init ride along unchanged)."""
        from robotic_discovery_platform_tpu_torch.utils.config import replace

        features = max(4, int(round(base.base_features * self.width_scale)))
        return replace(base, num_classes=self.num_classes,
                       base_features=features)


VARIANTS: dict[str, ModelVariant] = {
    "seg": ModelVariant(
        name="seg", registered_name=None, num_classes=1, width_scale=1.0,
        head="segment",
        description="seed binary actuator segmenter (the default model)",
    ),
    "multi": ModelVariant(
        name="multi", registered_name="Actuator-Segmenter-Multi",
        num_classes=4, width_scale=1.0, head="segment",
        description="multi-actuator segmenter: 4-channel multi-label "
                    "head, union mask over classes",
    ),
    "aux": ModelVariant(
        name="aux", registered_name="Actuator-AuxHead", num_classes=1,
        width_scale=0.25, head="anomaly",
        description="cheap defect/anomaly head scoring off the "
                    "confidence margin",
    ),
}


def resolve_zoo_models(configured: str) -> tuple[str, ...]:
    """The zoo roster: ``RDP_ZOO_MODELS`` when set, else
    ``ServerConfig.zoo_models``; a comma-separated list of variant names.
    Empty = the default model alone. The default model is always first
    and always present (the empty wire ``model`` field resolves to it)."""
    raw = os.environ.get(_ZOO_ENV_VAR)
    spec = raw if raw is not None else configured
    names = [n.strip() for n in (spec or "").split(",") if n.strip()]
    if not names:
        return (DEFAULT_MODEL,)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(
            f"unknown zoo model(s) {unknown}; catalog: "
            f"{sorted(VARIANTS)}"
        )
    ordered = [DEFAULT_MODEL] + [n for n in names if n != DEFAULT_MODEL]
    # request order after the pinned default, duplicates dropped
    seen: set[str] = set()
    return tuple(n for n in ordered if not (n in seen or seen.add(n)))


def registered_name(variant: ModelVariant, default_model_name: str) -> str:
    """The registry entry this variant's generations resolve through."""
    return (variant.registered_name if variant.registered_name is not None
            else default_model_name)


def build_variant_model(variant: ModelVariant, base: ModelConfig):
    """The variant's :class:`~models.unet.UNet` (weights not drawn: call
    ``init_weights`` or load a state)."""
    from robotic_discovery_platform_tpu_torch.models.unet import UNet

    return UNet(variant.model_config(base))


def anomaly_score(confidence_margin: float) -> float:
    """Per-frame defect/anomaly score off the confidence margin: the margin
    is mean |sigmoid(logit) - 0.5| in [0, 0.5] (0: every pixel on the
    decision boundary; 0.5: saturated confidence). The score flips it to
    [0, 1], 1 = most anomalous."""
    m = min(max(float(confidence_margin), 0.0), 0.5)
    return 1.0 - 2.0 * m
