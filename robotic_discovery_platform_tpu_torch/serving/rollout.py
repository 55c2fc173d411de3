"""The drift-triggered rollout: the state machine that turns a drift
recommendation into a retrained, gated and promoted generation, the
port's copy of the JAX package's ``serving/rollout.py``.

The :class:`RolloutManager` drives one supervised cycle per accepted
recommendation::

    IDLE -> DRAINING -> RETRAINING -> SHADOW -> CANARY -> PROMOTING
                                                        -> REJOINING -> IDLE

- **DRAINING**: the least-loaded replica's draining flag goes up
  (``VisionAnalysisService.set_draining``; health stays SERVING), new
  streams go elsewhere, and the stage waits for its stream count to reach
  zero.
- **RETRAINING**: ``workflows/retraining.run_retraining_pipeline`` runs
  on the manager's device, registering the candidate under
  ``RolloutConfig.candidate_alias``, never under the serving alias.
- **SHADOW**: the serving replicas mirror ``shadow_fraction`` of their
  live frames to the candidate (a bounded queue the handler threads never
  wait on; the candidate's results never reach a caller). Each mirrored
  frame is diffed against the serving generation's own output: mask IoU,
  |delta curvature| and the five drift signals.
- **CANARY**: the promotion gates, fail-closed: the parity fixtures
  (candidate against the live generation over ``ops/quant.
  golden_frames``), the shadow diff and the candidate-against-serving
  drift scores. Every verdict is counted
  (``rdp_rollout_gate_verdicts_total``); any failure rejects the
  candidate.
- **PROMOTING**: the serving alias moves to the candidate and every
  replica promotes through its hot-reload swap, which adopts the new
  drift reference in the same critical section as the engine.
- **REJOINING**: the drained replica accepts streams again.

Every unhappy path -- a failed or crashed retrain, a failed gate, a dead
replica, a stage past its ``RolloutConfig`` timeout -- rolls back: the
candidate is discarded, the replica un-drains, every replica keeps the
old generation and the machine lands in IDLE.

Every transition is counted (``rdp_rollout_transitions_total``), pinned
in the flight recorder and journaled; ``GET /debug/rollout`` serves
:meth:`RolloutManager.snapshot`. The clock and sleep are injectable, so
the whole ladder runs on a fake clock in the tests.

On the card the candidate is trained on the card the servers share, and
its analyzer and the fixture reference capture and replay their graphs on
streams of their own (``ops/graphs``), under live traffic, as a hot
reload's do; after each cycle their graph memory goes back to the card.
"""

from __future__ import annotations

import contextlib
import inspect
import math
import os
import queue
import threading
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.monitoring import (
    profile as profile_lib,
)
from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    RolloutConfig,
    ServerConfig,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# -- states ------------------------------------------------------------------

IDLE = "idle"
DRAINING = "draining"
RETRAINING = "retraining"
SHADOW = "shadow"
CANARY = "canary"
PROMOTING = "promoting"
REJOINING = "rejoining"

#: every stage, in cycle order (the gauge publishes one label per state)
STATES = (IDLE, DRAINING, RETRAINING, SHADOW, CANARY, PROMOTING, REJOINING)

_ROLLOUT_ENV_VAR = "RDP_ROLLOUT"


def resolve_rollout_enabled(configured: bool) -> bool:
    """``RDP_ROLLOUT`` overrides ``RolloutConfig.enabled`` (1/true/on)."""
    raw = os.environ.get(_ROLLOUT_ENV_VAR, "").strip().lower()
    if not raw:
        return bool(configured)
    return raw in ("1", "true", "yes", "on")


class StageError(RuntimeError):
    """A rollout stage failed; ``stage`` names where the cycle died."""

    def __init__(self, stage: str, message: str):
        super().__init__(message)
        self.stage = stage


class StageTimeout(StageError):
    """A rollout stage exceeded its RolloutConfig timeout."""


def _device_scope(device: torch.device):
    """``device`` as the current CUDA device (a null context on the CPU):
    the kernel wrappers take tensors on the current device only."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# -- shadow mirroring --------------------------------------------------------


class ShadowSample(NamedTuple):
    """One live frame mirrored to the candidate: the decoded inputs and
    the serving generation's own outputs to diff against (the mask
    unpacked, at the frame's resolution)."""

    rgb: object
    depth: object
    k: object  # float32 intrinsics (the geometry cache's copy)
    depth_scale: float
    mask: object  # the live generation's binary mask
    coverage: float
    mean_curvature: float
    max_curvature: float
    valid: bool
    confidence_margin: float
    depth_valid_fraction: float

    def live_signals(self) -> dict[str, float]:
        """The serving generation's drift-signal values for this frame
        (as ``monitoring/profile.frame_signals`` gives them)."""
        return {
            "mask_coverage": self.coverage,
            "mean_curvature": (self.mean_curvature if self.valid
                               else math.nan),
            "max_curvature": (self.max_curvature if self.valid
                              else math.nan),
            "depth_valid_fraction": self.depth_valid_fraction,
            "confidence_margin": self.confidence_margin,
        }


class ShadowRunner:
    """Mirrors a fraction of live frames to the candidate and gathers the
    diff the CANARY gates read.

    :meth:`hook` runs on serving handler threads and never waits: it
    samples by fraction and puts into a bounded queue without blocking
    (overflow is dropped and counted). :meth:`process_one` runs on the
    cycle's thread: it takes a sample, runs the candidate analyzer
    (``analyze(rgb, depth, k, scale) -> FrameAnalysis``) on ``device`` and
    scores the diff. The candidate has its own graph cache, stream and
    lock: the shadow never takes a serving analyzer's lock.

    Concurrency: the sampling counters are guarded by ``_lock``; the diff
    lists are written by the cycle's thread only."""

    def __init__(self, analyze: Callable, *, fraction: float = 0.5,
                 max_queue: int = 64, device: str | torch.device = "cpu"):
        self._analyze = analyze
        self._device = torch.device(device)
        self.fraction = min(max(float(fraction), 0.0), 1.0)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self._lock = checked_lock("rollout.shadow")
        self._seen = 0  # guarded_by: _lock
        self._taken = 0  # guarded_by: _lock
        self.mirrored = 0  # guarded_by: _lock
        self.dropped = 0  # guarded_by: _lock
        self.errors = 0
        self.ious: list[float] = []
        self.curv_errs: list[float] = []
        self._live_signals: dict[str, list[float]] = {
            name: [] for name in profile_lib.SERVING_SIGNALS
        }
        self._cand_signals: dict[str, list[float]] = {
            name: [] for name in profile_lib.SERVING_SIGNALS
        }

    # -- handler-thread side ----------------------------------------------------

    def hook(self, sample: ShadowSample) -> None:
        """The tap the serving replicas call per analyzed frame."""
        with self._lock:
            self._seen += 1
            take = self._seen * self.fraction >= self._taken + 1
            if take:
                self._taken += 1
        if not take:
            return
        try:
            self._q.put_nowait(sample)
        except queue.Full:
            with self._lock:
                self.dropped += 1
            obs.ROLLOUT_SHADOW_FRAMES.labels(outcome="dropped").inc()
            return
        with self._lock:
            self.mirrored += 1
        obs.ROLLOUT_SHADOW_FRAMES.labels(outcome="mirrored").inc()

    # -- cycle-thread side ------------------------------------------------------

    def process_one(self, timeout_s: float = 0.1) -> bool:
        """Take and diff one mirrored frame; False when none arrived
        within ``timeout_s``."""
        from robotic_discovery_platform_tpu_torch.ops import quant

        try:
            sample = self._q.get(timeout=timeout_s)
        except queue.Empty:
            return False
        try:
            with _device_scope(self._device):
                out = self._analyze(sample.rgb, sample.depth, sample.k,
                                    np.float32(sample.depth_scale))
                cand_mask = quant._np(out.mask)
                cand_signals = profile_lib.frame_signals(out, sample.depth)
        except Exception as exc:  # a failing candidate is evidence
            self.errors += 1
            obs.ROLLOUT_SHADOW_FRAMES.labels(outcome="error").inc()
            log.warning("shadow candidate failed on a mirrored frame "
                        "(%s: %s)", type(exc).__name__, exc)
            return True
        self.ious.append(quant.mask_iou(sample.mask, cand_mask))
        cand_valid = not math.isnan(cand_signals["mean_curvature"])
        if sample.valid and cand_valid:
            self.curv_errs.append(abs(
                cand_signals["mean_curvature"] - sample.mean_curvature))
        elif sample.valid != cand_valid:
            # a validity flip scores as in quant.parity_report: the worst
            # curvature outcome, visible to the gate
            self.curv_errs.append(
                abs(sample.mean_curvature if sample.valid
                    else cand_signals["mean_curvature"]))
        live = sample.live_signals()
        for name in self._live_signals:
            lv, cv = live.get(name), cand_signals.get(name)
            if lv is not None and math.isfinite(lv):
                self._live_signals[name].append(lv)
            if cv is not None and math.isfinite(cv):
                self._cand_signals[name].append(cv)
        obs.ROLLOUT_SHADOW_FRAMES.labels(outcome="diffed").inc()
        return True

    @property
    def diffed(self) -> int:
        return len(self.ious) + self.errors

    def report(self) -> dict:
        """The shadow evidence the gates read: the per-frame diff's
        aggregates and the worst candidate-against-serving PSI over the
        drift signals (over the same mirrored frames, so both sides share
        their sampling noise)."""
        psi_by_signal: dict[str, float] = {}
        for name, spec in profile_lib.SERVING_SIGNALS.items():
            live = self._live_signals[name]
            cand = self._cand_signals[name]
            if len(live) < 2 or len(cand) < 2:
                continue
            score = profile_lib.score_value_lists(spec, live, cand)
            psi_by_signal[name] = score.psi - score.noise_floor
        with self._lock:
            mirrored, dropped = self.mirrored, self.dropped
        return {
            "frames": len(self.ious),
            "errors": self.errors,
            "mirrored": mirrored,
            "dropped": dropped,
            "mask_iou_mean": (float(np.mean(self.ious))
                              if self.ious else 0.0),
            "mask_iou_min": (float(np.min(self.ious))
                             if self.ious else 0.0),
            "curvature_err_mean": (float(np.mean(self.curv_errs))
                                   if self.curv_errs else 0.0),
            "curvature_err_max": (float(np.max(self.curv_errs))
                                  if self.curv_errs else 0.0),
            "psi": psi_by_signal,
            "psi_max": (max(psi_by_signal.values())
                        if psi_by_signal else 0.0),
        }


# -- targets -----------------------------------------------------------------


class RolloutTarget:
    """The rollout's control surface over one in-process replica servicer
    (``serving/server.VisionAnalysisService``). Duck-typed: the tests
    drive the manager with fakes of the same members."""

    def __init__(self, name: str, servicer):
        self.name = name
        self.servicer = servicer

    @property
    def active_streams(self) -> int:
        return self.servicer.active_streams

    @property
    def draining(self) -> bool:
        return self.servicer.is_draining

    @property
    def current_version(self):
        return self.servicer.current_version

    def set_draining(self, draining: bool) -> None:
        self.servicer.set_draining(draining)

    def set_shadow(self, hook) -> None:
        self.servicer.set_shadow(hook)

    def promote(self) -> bool:
        """One hot-reload check now (the poller would get there on its own
        tick; a promotion need not wait for it)."""
        return bool(self.servicer.maybe_reload())

    def reference_analyzer(self):
        """The fixture gate's reference: the current generation's
        untransformed net at the f32 tier, folded, as a frame analyzer on
        the servicer's device, run eagerly (no capture). A servicer at
        f32 does not keep its net, so it is loaded again from the
        registry version it serves; the servicer's own objects are never
        touched."""
        from robotic_discovery_platform_tpu_torch import tracking
        from robotic_discovery_platform_tpu_torch.ops import pipeline
        from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
            reference_forward,
        )

        sv = self.servicer
        net = sv._pristine
        if net is None:
            version = sv.current_version
            if version is None:
                raise RuntimeError(
                    f"replica {self.name} serves a caller's forward: no "
                    "registered net to hold a candidate against")
            _, net = tracking.load_model(
                f"models:/{sv.cfg.model_name}/{version}",
                store=sv._registry_store, device=sv.device)
        analyze = pipeline.make_frame_analyzer(
            reference_forward(net, device=sv.device),
            img_size=sv.cfg.model_img_size, geom_cfg=sv.geom_cfg,
            device=sv.device)
        return analyze.eager

    def training_mesh(self):
        """The drained replica's device mesh for the retraining run: None,
        since the port trains on one device (the mesh trainer is ROADMAP
        queue 1 item 14). The JAX package also returns None when no mesh
        can be built."""
        return None


# -- gates -------------------------------------------------------------------


def evaluate_gates(cfg: RolloutConfig, fixture_report: dict,
                   shadow_report: dict) -> tuple[bool, dict]:
    """The fail-closed promotion verdict: every gate must pass. Returns
    ``(passed, verdicts)``, ``verdicts`` mapping each gate to
    ``{"value", "threshold", "pass"}``; each verdict is also counted in
    ``rdp_rollout_gate_verdicts_total``."""
    verdicts = {
        "fixture_iou": {
            "value": fixture_report["mask_iou_mean"],
            "threshold": cfg.gate_fixture_min_iou,
            "pass": (fixture_report["mask_iou_mean"]
                     >= cfg.gate_fixture_min_iou),
        },
        "fixture_curv": {
            "value": fixture_report["curvature_err_max"],
            "threshold": cfg.gate_fixture_max_curv_err,
            "pass": (fixture_report["curvature_err_max"]
                     <= cfg.gate_fixture_max_curv_err),
        },
        "shadow_frames": {
            "value": shadow_report["frames"],
            "threshold": cfg.shadow_min_frames,
            "pass": shadow_report["frames"] >= cfg.shadow_min_frames,
        },
        "shadow_iou": {
            "value": shadow_report["mask_iou_mean"],
            "threshold": cfg.gate_shadow_min_iou,
            "pass": (shadow_report["mask_iou_mean"]
                     >= cfg.gate_shadow_min_iou),
        },
        "shadow_curv": {
            "value": shadow_report["curvature_err_max"],
            "threshold": cfg.gate_shadow_max_curv_err,
            "pass": (shadow_report["curvature_err_max"]
                     <= cfg.gate_shadow_max_curv_err),
        },
        "shadow_psi": {
            "value": shadow_report["psi_max"],
            "threshold": cfg.gate_shadow_max_psi,
            "pass": shadow_report["psi_max"] <= cfg.gate_shadow_max_psi,
        },
    }
    for gate, v in verdicts.items():
        obs.ROLLOUT_GATE_VERDICTS.labels(
            gate=gate, verdict="pass" if v["pass"] else "fail").inc()
    return all(v["pass"] for v in verdicts.values()), verdicts


# -- the manager -------------------------------------------------------------


class RolloutManager:
    """Consumes retrain recommendations and drives the drain -> retrain
    -> shadow -> gate -> promote/rollback cycle over a set of
    :class:`RolloutTarget`-shaped replicas.

    ``train_fn(target) -> PipelineResult`` (or ``train_fn(target,
    cancel)``) is injectable (tests and chip_smoke register crafted
    candidates); the default runs ``workflows/retraining`` on ``device``
    with the ``train_cfg``/``model_cfg`` given at construction.
    ``device`` is where the candidate is trained, loaded and run ("cuda"
    by default: the card the servers share). ``clock`` and ``sleep`` are
    injectable for fake-clock tests. ``run_cycle`` is public and
    synchronous, so tests drive the ladder deterministically; ``start()``
    adds the worker thread that serves live recommendations.

    Concurrency: the state, the current cycle, the history and the cycle
    count are guarded by ``_lock``; the worker thread alone runs cycles,
    and the inbox is a one-slot queue."""

    #: completed cycles kept for /debug/rollout
    HISTORY = 16

    def __init__(
        self,
        targets: Sequence,
        cfg: RolloutConfig = RolloutConfig(),
        server_cfg: ServerConfig = ServerConfig(),
        *,
        train_fn: Callable | None = None,
        train_cfg=None,
        model_cfg=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        device: str | torch.device = "cuda",
    ):
        self.targets = list(targets)
        self._device = resolve_device(device)
        self.cfg = cfg
        self.server_cfg = server_cfg
        self._train_fn = train_fn
        self._train_cfg = train_cfg
        self._model_cfg = model_cfg
        self._clock = clock
        self._sleep = sleep
        self._lock = checked_lock("rollout.manager")
        self._state = IDLE  # guarded_by: _lock
        self._current: dict | None = None  # guarded_by: _lock
        self.history: list[dict] = []  # guarded_by: _lock
        self._cycles = 0  # guarded_by: _lock
        self._inbox: queue.Queue = queue.Queue(maxsize=1)
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._publish_state(IDLE)

    # -- wiring --------------------------------------------------------------

    def add_target(self, target) -> None:
        self.targets.append(target)

    def on_recommendation(self, rec) -> bool:
        """The drift monitor's callback (serving/server.py forwards it).
        Does not block: queues the recommendation for the worker when the
        machine is idle, else counts it skipped; at most one cycle runs at
        a time, and the monitor's hysteresis already gives one
        recommendation per excursion."""
        with self._lock:
            busy = self._state != IDLE
        if busy:
            obs.ROLLOUT_SKIPPED.labels(reason="busy").inc()
            log.info("rollout busy (%s); recommendation skipped",
                     self.state)
            return False
        try:
            self._inbox.put_nowait(rec)
        except queue.Full:
            obs.ROLLOUT_SKIPPED.labels(reason="busy").inc()
            return False
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    rec = self._inbox.get(timeout=0.2)
                except queue.Empty:
                    continue
                if rec is None:
                    return
                try:
                    self.run_cycle(rec)
                except Exception:  # pragma: no cover - cycle self-guards
                    log.exception("rollout cycle crashed")

        self._thread = threading.Thread(target=loop, name="rollout-manager",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            try:
                self._inbox.put_nowait(None)
            except queue.Full:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _publish_state(self, state: str) -> None:
        for s in STATES:
            obs.ROLLOUT_STATE.labels(state=s).set(1.0 if s == state else 0.0)

    def _transition(self, to: str, cycle: dict | None = None,
                    **labels) -> None:
        with self._lock:
            frm, self._state = self._state, to
            if cycle is not None:
                cycle["stages"].append(
                    {"stage": to, "at_s": round(self._clock(), 3)})
        self._publish_state(to)
        obs.ROLLOUT_TRANSITIONS.labels(to=to).inc()
        # pinned: a rollout transition is promotion-audit evidence that
        # must survive ring wrap-around
        recorder_lib.RECORDER.pin(recorder_lib.RECORDER.record_event(
            "serving.rollout.transition", frm=frm, to=to,
            **{k: str(v) for k, v in labels.items()},
        ))
        journal_lib.JOURNAL.append(
            events.ROLLOUT_TRANSITION, frm=frm, to=to,
            **{k: str(v) for k, v in labels.items()},
        )
        log.info("rollout: %s -> %s%s", frm, to,
                 f" {labels}" if labels else "")

    # -- the cycle -----------------------------------------------------------

    def _pick_target(self):
        """The least-loaded drainable replica, only when at least one
        other replica keeps serving."""
        candidates = [t for t in self.targets
                      if not getattr(t, "draining", False)]
        if len(candidates) < 2:
            return None
        return min(candidates, key=lambda t: t.active_streams)

    def _wait(self, stage: str, deadline: float, done: Callable[[], bool],
              what: str) -> None:
        while not done():
            if self._clock() >= deadline:
                raise StageTimeout(stage, f"{stage}: timed out waiting "
                                          f"for {what}")
            self._sleep(0.05)

    def _retrain(self, target) -> object:
        """Run the training function bounded by the stage timeout. The
        thread cannot be killed mid-train; on timeout the cooperative
        cancel flag is set, and the retraining pipeline checks it at its
        stage boundaries and stops."""
        result_box: list = []
        cancel = threading.Event()

        def run():
            try:
                result_box.append(self._train(target, cancel))
            except Exception as exc:  # noqa: BLE001 - surfaced below
                result_box.append(exc)

        t = threading.Thread(target=run, name="rollout-retrain",
                             daemon=True)
        t.start()
        deadline = self._clock() + self.cfg.retrain_timeout_s
        while t.is_alive():
            if self._clock() >= deadline:
                cancel.set()
                obs.ROLLOUT_RETRAIN_CANCELS.inc()
                journal_lib.JOURNAL.append(
                    events.ROLLOUT_RETRAIN_CANCEL,
                    timeout_s=self.cfg.retrain_timeout_s,
                )
                raise StageTimeout(
                    RETRAINING,
                    f"retraining exceeded {self.cfg.retrain_timeout_s:.0f}s"
                    "; candidate (if any) is discarded and the pipeline "
                    "is asked to stop at its next stage boundary")
            t.join(timeout=0.05)
            if t.is_alive():
                # the injectable sleep advances a fake clock; join()
                # alone would spin a fake-clock test forever
                self._sleep(0.05)
        if not result_box:
            raise StageError(RETRAINING, "retraining returned nothing")
        result = result_box[0]
        if isinstance(result, BaseException):
            raise StageError(
                RETRAINING,
                f"retraining raised {type(result).__name__}: {result}")
        return result

    def _train(self, target, cancel: threading.Event | None = None):
        if self._train_fn is not None:
            # a train_fn may take the target alone; pass the cancel flag
            # to one that declares a second parameter
            try:
                params = inspect.signature(self._train_fn).parameters
                takes_cancel = ("cancel" in params
                                or len(params) >= 2)
            except (TypeError, ValueError):
                takes_cancel = False
            if takes_cancel and cancel is not None:
                return self._train_fn(target, cancel)
            return self._train_fn(target)
        if self._train_cfg is None:
            raise StageError(
                RETRAINING,
                "no train_fn and no train_cfg configured; the rollout "
                "manager cannot launch the retraining pipeline")
        from robotic_discovery_platform_tpu_torch.workflows.retraining import (
            run_retraining_pipeline,
        )

        mesh = target.training_mesh() if hasattr(target, "training_mesh") \
            else None
        kwargs = {"mesh": mesh, "alias": self.cfg.candidate_alias,
                  "cancel": cancel, "device": self._device}
        if self._model_cfg is not None:
            kwargs["model_cfg"] = self._model_cfg
        return run_retraining_pipeline(self._train_cfg, **kwargs)

    def _load_candidate(self, version):
        """The candidate's frame analyzer: the registered version loaded on
        ``device`` and folded at the f32 tier (the JAX package's candidate
        runs the registered model as it is). Its graph cache captures on a
        stream of its own (``ops/graphs.dedicated_stream``), under live
        traffic, as a hot reload's does, and the shadow thread replays it
        there without any serving analyzer's lock."""
        from robotic_discovery_platform_tpu_torch import tracking
        from robotic_discovery_platform_tpu_torch.ops import pipeline
        from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
            reference_forward,
        )

        store = tracking.store_for(self.server_cfg.tracking_uri)
        _, net = tracking.load_model(
            f"models:/{self.server_cfg.model_name}/{version}", store=store,
            device=self._device)
        return pipeline.make_frame_analyzer(
            reference_forward(net, device=self._device),
            img_size=self.server_cfg.model_img_size,
            geom_cfg=GeometryConfig(stride=self.server_cfg.geometry_stride),
            device=self._device)

    #: the fixture scenes' camera geometry, also the candidate's warm-up
    #: shape
    FIXTURE_H, FIXTURE_W = 120, 160

    def _fixture_camera(self):
        h, w = self.FIXTURE_H, self.FIXTURE_W
        f = 0.94 * w
        return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                        np.float32)

    def _warm_candidate(self, cand_analyze) -> None:
        """One golden frame through the candidate, so its graph is
        captured before mirroring starts. A failure here shows again as
        shadow-frame errors, which the gates see."""
        from robotic_discovery_platform_tpu_torch.ops import quant

        try:
            rgb, depth = quant.golden_frames(1, self.FIXTURE_H,
                                             self.FIXTURE_W)[0]
            with _device_scope(self._device):
                cand_analyze(rgb, depth, self._fixture_camera(),
                             np.float32(self.server_cfg.default_depth_scale))
        except Exception as exc:
            log.warning("candidate warm-up failed (%s: %s); the shadow "
                        "stage will show it", type(exc).__name__, exc)

    def _fixture_report(self, reference_analyzer, cand_analyze) -> dict:
        """The parity fixtures, candidate against the live generation:
        ``gate_fixture_frames`` golden scenes through both analyzers,
        scored by ``ops/quant.parity_report``."""
        from robotic_discovery_platform_tpu_torch.ops import quant

        k = self._fixture_camera()
        scale = np.float32(self.server_cfg.default_depth_scale)
        refs, gots = [], []
        with _device_scope(self._device):
            for rgb, depth in quant.golden_frames(
                    self.cfg.gate_fixture_frames, self.FIXTURE_H,
                    self.FIXTURE_W):
                refs.append(reference_analyzer(rgb, depth, k, scale))
                gots.append(cand_analyze(rgb, depth, k, scale))
        return quant.parity_report(refs, gots)

    def _promote(self, cycle: dict, version) -> None:
        """Move the staging alias and drive every replica through its
        hot-reload swap; on partial failure the alias is restored and the
        already-promoted replicas are reloaded back -- fail-closed, the
        fleet converges on ONE generation either way."""
        from robotic_discovery_platform_tpu_torch import tracking

        store = tracking.store_for(self.server_cfg.tracking_uri)
        name = self.server_cfg.model_name
        previous = store.get_alias(name, self.server_cfg.model_alias)
        cycle["previous_version"] = previous
        store.set_alias(name, self.server_cfg.model_alias, int(version))
        try:
            deadline = self._clock() + self.cfg.promote_timeout_s
            for t in self.targets:
                t.promote()
                self._wait(
                    PROMOTING, deadline,
                    lambda t=t: t.current_version == int(version),
                    f"replica {t.name} to adopt version {version}",
                )
        except Exception:
            if previous is not None:
                log.error("promotion failed mid-swap; reverting %s alias "
                          "to version %s", self.server_cfg.model_alias,
                          previous)
                store.set_alias(name, self.server_cfg.model_alias,
                                int(previous))
                for t in self.targets:
                    try:
                        t.promote()
                    except Exception:  # noqa: BLE001 - best-effort revert
                        log.exception("revert reload failed on %s", t.name)
            raise

    def run_cycle(self, rec) -> dict:
        """One full supervised rollout for ``rec``; returns the cycle
        record (also appended to :attr:`history`). Never raises: every
        failure is a recorded rollback landing back in IDLE."""
        t0 = self._clock()
        cand_analyze = runner = reference = None
        cycle: dict = {
            "reason": getattr(rec, "reason", str(rec)),
            "signals": list(getattr(rec, "signals", []) or []),
            "started_s": round(t0, 3),
            "stages": [],
            "outcome": None,
            "candidate_version": None,
            "gates": None,
            "shadow": None,
            "fixture": None,
        }
        with self._lock:
            self._current = cycle
        target = self._pick_target()
        if target is None:
            obs.ROLLOUT_SKIPPED.labels(reason="no_spare_replica").inc()
            cycle["outcome"] = "skipped"
            cycle["error"] = ("no spare replica: draining one would leave "
                              "nothing serving")
            log.warning("rollout skipped: %s", cycle["error"])
            self._record_cycle(cycle, t0)
            return cycle
        cycle["replica"] = target.name
        stage = DRAINING
        drained = False
        try:
            # -- DRAINING --------------------------------------------------
            self._transition(DRAINING, cycle, replica=target.name)
            target.set_draining(True)
            drained = True
            self._wait(DRAINING, self._clock() + self.cfg.drain_timeout_s,
                       lambda: target.active_streams == 0,
                       "in-flight streams to finish")

            # -- RETRAINING ------------------------------------------------
            stage = RETRAINING
            self._transition(RETRAINING, cycle, replica=target.name)
            result = self._retrain(target)
            if result is None or not getattr(result, "succeeded", False) \
                    or getattr(result, "version", None) is None:
                raise StageError(
                    RETRAINING,
                    "retraining pipeline failed: "
                    f"{getattr(result, 'message', result)}")
            version = int(result.version)
            cycle["candidate_version"] = version
            cand_analyze = self._load_candidate(version)
            # capture the candidate's graph before the shadow stage opens,
            # or the first mirrored frame pays it inside the stage's budget
            self._warm_candidate(cand_analyze)

            # -- SHADOW ----------------------------------------------------
            stage = SHADOW
            self._transition(SHADOW, cycle, candidate=version)
            runner = ShadowRunner(
                cand_analyze, fraction=self.cfg.shadow_fraction,
                max_queue=self.cfg.shadow_queue, device=self._device,
            )
            live_targets = [t for t in self.targets if t is not target]
            for t in live_targets:
                t.set_shadow(runner.hook)
            try:
                deadline = self._clock() + self.cfg.shadow_timeout_s
                while runner.diffed < self.cfg.shadow_min_frames:
                    if self._clock() >= deadline:
                        break
                    if not runner.process_one(timeout_s=0.0):
                        # idle tap: wait through the injectable sleep, so
                        # a fake clock can expire the stage
                        self._sleep(0.05)
            finally:
                for t in live_targets:
                    try:
                        t.set_shadow(None)
                    except Exception:  # noqa: BLE001 - replica died
                        log.exception("clearing shadow tap on %s failed",
                                      t.name)
            # then diff what the tap mirrored before it closed. The JAX
            # package drains before it closes the tap, which never ends
            # while live frames arrive faster than the candidate runs
            while runner.process_one(timeout_s=0.0):
                pass
            shadow_report = runner.report()
            cycle["shadow"] = shadow_report

            # -- CANARY ----------------------------------------------------
            stage = CANARY
            self._transition(CANARY, cycle, candidate=version)
            reference = None
            for t in live_targets:
                try:
                    reference = t.reference_analyzer()
                    break
                except Exception:  # noqa: BLE001 - try the next replica
                    log.exception("reference analyzer from %s failed",
                                  t.name)
            if reference is None:
                raise StageError(CANARY, "no live replica could provide "
                                         "the fixture reference analyzer")
            fixture_report = self._fixture_report(reference, cand_analyze)
            cycle["fixture"] = fixture_report
            passed, verdicts = evaluate_gates(
                self.cfg, fixture_report, shadow_report)
            cycle["gates"] = verdicts
            if not passed:
                failed = sorted(g for g, v in verdicts.items()
                                if not v["pass"])
                raise StageError(
                    CANARY,
                    f"candidate v{version} rejected by gate(s) "
                    f"{', '.join(failed)}")

            # -- PROMOTING -------------------------------------------------
            stage = PROMOTING
            self._transition(PROMOTING, cycle, candidate=version)
            self._promote(cycle, version)

            # -- REJOINING -------------------------------------------------
            stage = REJOINING
            self._transition(REJOINING, cycle, replica=target.name)
            target.set_draining(False)
            drained = False
            cycle["outcome"] = "promoted"
            obs.ROLLOUT_CYCLES.labels(outcome="promoted").inc()
            log.info("rollout promoted version %s (replica %s rejoining)",
                     version, target.name)
        except Exception as exc:  # noqa: BLE001 - every failure rolls back
            failed_stage = exc.stage if isinstance(exc, StageError) \
                else stage
            cycle["outcome"] = "rolled_back"
            cycle["rolled_back_at"] = failed_stage
            cycle["error"] = f"{type(exc).__name__}: {exc}"
            obs.ROLLOUT_ROLLBACKS.labels(stage=failed_stage).inc()
            obs.ROLLOUT_CYCLES.labels(outcome="rolled_back").inc()
            recorder_lib.RECORDER.pin(recorder_lib.RECORDER.record_event(
                "serving.rollout.rollback", stage=failed_stage,
                error=cycle["error"],
            ))
            log.warning(
                "rollout ROLLBACK at %s: %s -- candidate discarded, fleet "
                "keeps serving the old generation", failed_stage,
                cycle["error"],
            )
            if drained:
                # the replica must never stay stuck draining
                self._transition(REJOINING, cycle, replica=target.name)
                try:
                    target.set_draining(False)
                except Exception:  # noqa: BLE001 - replica died entirely
                    log.exception("un-drain of %s failed; the membership "
                                  "poll owns its fate now", target.name)
        finally:
            # the candidate, its runner and the reference go with this
            # frame; on the card their graph pools go back to the device
            cand_analyze = runner = reference = None
            self._release_graphs()
            self._record_cycle(cycle, t0)
        return cycle

    def _release_graphs(self) -> None:
        """Return the memory of the cycle's analyzers and training to the
        card once they are collected: the cuBLAS workspaces their streams
        and threads keep (``ops/graphs.release_workspaces``) and their
        graph pools (``ops/graphs.release_dead_pools``)."""
        if self._device.type != "cuda":
            return
        import gc

        from robotic_discovery_platform_tpu_torch.ops import graphs

        gc.collect()
        graphs.release_workspaces()
        graphs.release_dead_pools()

    def _record_cycle(self, cycle: dict, t0: float) -> None:
        cycle["duration_s"] = round(self._clock() - t0, 3)
        with self._lock:
            self._cycles += 1
            self._current = None
            self.history.append(cycle)
            del self.history[:-self.HISTORY]
            already_idle = self._state == IDLE
        if not already_idle:
            self._transition(IDLE)

    # -- /debug/rollout ------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "state": self._state,
                "cycles_total": self._cycles,
                "current": dict(self._current) if self._current else None,
                "replicas": [
                    {
                        "name": t.name,
                        "active_streams": t.active_streams,
                        "version": t.current_version,
                    }
                    for t in self.targets
                ],
                "config": {
                    "shadow_fraction": self.cfg.shadow_fraction,
                    "shadow_min_frames": self.cfg.shadow_min_frames,
                    "candidate_alias": self.cfg.candidate_alias,
                    "gates": {
                        "fixture_min_iou": self.cfg.gate_fixture_min_iou,
                        "fixture_max_curv_err":
                            self.cfg.gate_fixture_max_curv_err,
                        "shadow_min_iou": self.cfg.gate_shadow_min_iou,
                        "shadow_max_curv_err":
                            self.cfg.gate_shadow_max_curv_err,
                        "shadow_max_psi": self.cfg.gate_shadow_max_psi,
                    },
                    "timeouts_s": {
                        "drain": self.cfg.drain_timeout_s,
                        "retrain": self.cfg.retrain_timeout_s,
                        "shadow": self.cfg.shadow_timeout_s,
                        "promote": self.cfg.promote_timeout_s,
                    },
                },
                "history": list(self.history),
            }



def attach_rollout(manager: RolloutManager, servicers,
                   names: Sequence[str] | None = None) -> list[RolloutTarget]:
    """Wire in-process replica servicers to one shared manager: each
    becomes a :class:`RolloutTarget`, and each servicer's drift
    recommendations go to :meth:`RolloutManager.on_recommendation`."""
    targets = []
    for i, servicer in enumerate(servicers):
        name = names[i] if names is not None else f"replica-{i}"
        target = RolloutTarget(name, servicer)
        manager.add_target(target)
        servicer.rollout = manager
        targets.append(target)
    return targets
