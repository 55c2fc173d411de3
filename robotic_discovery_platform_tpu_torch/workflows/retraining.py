"""Automated retraining pipeline (the port of the JAX package's
``workflows/retraining.py``).

Run the trainer (``training/trainer.train_model``), look up the version
the registry just assigned, promote it to the ``staging`` alias (the alias
the server loads and its reload poller watches), and ship the new
version's **drift reference profile** with it: the serving signals of
synthetic eval scenes through the new model's frame analyzer
(``monitoring/profile.capture_feature_profile``), stored as
``drift_profile.json`` next to the version's weights, where the server's
drift monitor finds it at start-up and at hot reload. Failures are logged,
not raised (a failed profile capture is counted in
``rdp_drift_profile_failures_total`` and the version is promoted all the
same: its servers self-baseline). ``run_if_drifted`` runs the pipeline
when the offline detector (``monitoring/drift.analyze_drift``) flags the
metrics CSV.

Training and the capture run on ``device`` (the card unless the caller
asks for the CPU). The mesh trainer is ROADMAP queue 1 item 14: a
``mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.monitoring import (
    profile as profile_lib,
)
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    DriftConfig,
    ModelConfig,
    TrainConfig,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class PipelineResult:
    succeeded: bool
    version: int | None
    promoted_alias: str | None
    message: str
    drift_profile_path: str | None = None


def capture_drift_profile(
    version: int,
    model_name: str = "Actuator-Segmenter",
    tracking_uri: str | None = None,
    n_frames: int = 16,
    height: int = 120,
    width: int = 160,
    img_size: int = 256,
    seed: int = 0,
    device="cuda",
) -> str:
    """Capture a :class:`~..monitoring.profile.FeatureProfile` for a
    registered model version over synthetic eval scenes on ``device`` and
    store it as ``drift_profile.json`` inside the version's artifact
    directory -- the training-time half of the online drift loop. Returns
    the saved path."""
    import numpy as np

    from robotic_discovery_platform_tpu_torch.io.frames import render_scene
    from robotic_discovery_platform_tpu_torch.tracking.api import _store

    store = (tracking.store_for(tracking_uri) if tracking_uri is not None
             else _store())
    _, net = tracking.load_model(f"models:/{model_name}/{version}",
                                 store=store, device=device)
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        img, _, depth = render_scene(rng, height, width)
        frames.append((img, depth))
    profile = profile_lib.capture_feature_profile(
        net, frames, img_size=img_size, generation=version, device=device,
    )
    dest = (store.version_path(model_name, version)
            / profile_lib.DRIFT_PROFILE_FILE)
    profile.save(dest)
    log.info(
        "drift reference profile for %s v%s captured over %d eval "
        "frames -> %s", model_name, version, profile.n_frames, dest,
    )
    return str(dest)


def _cancelled(cancel) -> bool:
    return cancel is not None and cancel.is_set()


def run_retraining_pipeline(
    cfg: TrainConfig = TrainConfig(),
    model_cfg: ModelConfig = ModelConfig(),
    arrays=None,
    mesh=None,
    alias: str = "staging",
    cancel=None,
    device="cuda",
) -> PipelineResult:
    """``cancel`` is a cooperative stop flag (any object with
    ``is_set()``, usually a ``threading.Event``). It is checked at stage
    boundaries -- before training, before promotion, before profile
    capture -- so a caller that has given up on the cycle stops paying for
    work whose result it will discard. A cancelled run never promotes."""
    from robotic_discovery_platform_tpu_torch.training.trainer import (
        train_model,
    )

    if mesh is not None:
        raise NotImplementedError(
            "run_retraining_pipeline(mesh=...): the mesh trainer is ROADMAP "
            "queue 1 item 14; the port trains on one device"
        )
    log.info("=== automated retraining pipeline starting ===")
    try:
        if _cancelled(cancel):
            return PipelineResult(False, None, None,
                                  "cancelled before training started")
        result = train_model(cfg, model_cfg, arrays=arrays, device=device)
        if result.registry_version is None:
            return PipelineResult(False, None, None,
                                  "training completed but registered no model")
        if _cancelled(cancel):
            # the version exists in the registry but is never aliased:
            # nothing serves it, and the next successful cycle's
            # promotion supersedes it
            return PipelineResult(
                False, result.registry_version, None,
                f"cancelled after training: version "
                f"{result.registry_version} registered but NOT promoted")
        store = tracking.store_for(cfg.tracking_uri)
        latest = int(store.latest_version(cfg.registered_model_name)["version"])
        store.set_alias(cfg.registered_model_name, alias, latest)
        # ship the drift reference with the promotion. Failure is
        # non-fatal (the server self-baselines when a version has no
        # profile) but never silent: rdp_drift_profile_failures_total
        profile_path = None
        if _cancelled(cancel):
            msg = (f"version {latest} promoted to @{alias}, then "
                   "cancelled before drift-profile capture")
            log.info(msg)
            return PipelineResult(True, latest, alias, msg)
        try:
            profile_path = capture_drift_profile(
                latest,
                model_name=cfg.registered_model_name,
                tracking_uri=cfg.tracking_uri,
                img_size=cfg.img_size,
                device=device,
            )
        except Exception as exc:
            obs.DRIFT_PROFILE_FAILURES.inc()
            log.warning(
                "drift-profile capture for %s v%s failed (%s: %s); every "
                "server adopting this version will self-baseline "
                "(counted in rdp_drift_profile_failures_total)",
                cfg.registered_model_name, latest,
                type(exc).__name__, exc, exc_info=True,
            )
        msg = (
            f"version {latest} of {cfg.registered_model_name!r} "
            f"promoted to @{alias} (val_loss {result.best_val_loss:.4f})"
        )
        log.info(msg)
        return PipelineResult(True, latest, alias, msg,
                              drift_profile_path=profile_path)
    except Exception as exc:
        # the JAX package's behaviour: log, do not raise
        log.exception("retraining pipeline failed")
        return PipelineResult(False, None, None, f"{type(exc).__name__}: {exc}")


def run_if_drifted(
    drift_cfg: DriftConfig = DriftConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    model_cfg: ModelConfig = ModelConfig(),
    arrays=None,
    mesh=None,
    device="cuda",
) -> PipelineResult | None:
    """Drift-gated retraining: the autonomous loop. Returns None when no
    retraining was needed."""
    from robotic_discovery_platform_tpu_torch.monitoring.drift import (
        analyze_drift,
    )

    report = analyze_drift(drift_cfg)
    if not (report.analyzed and report.drifted):
        log.info("no retraining: %s", report.reason)
        return None
    log.warning("drift detected (%s); launching retraining", report.reason)
    result = run_retraining_pipeline(train_cfg, model_cfg, arrays=arrays,
                                     mesh=mesh, device=device)
    if not result.succeeded:
        # a drift-gated run failing means the loop detected a problem and
        # could not fix it: louder than a log.info
        log.error("drift-gated retraining FAILED: %s -- the drifted "
                  "model keeps serving", result.message)
    return result


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.utils.config import parse_config

    pc = parse_config()
    run_retraining_pipeline(pc.train, pc.model)
