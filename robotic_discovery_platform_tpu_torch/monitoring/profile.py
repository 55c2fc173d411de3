"""Reference feature profiles, divergence scoring, and the online
drift monitor (the port of the JAX package's ``monitoring/profile.py``).

The offline detector (monitoring/drift.py) answers "did mask coverage
drift" from a CSV, hours after the fact. Serving a model behind an SLO
needs the Clipper-style online version of that question (PAPERS.md): the
serving layer itself scores the distributions of its inputs and
predictions against a *reference profile* -- captured over the eval set
when the model was trained -- and turns a sustained divergence into a
structured retrain recommendation the MLOps loop can act on in real time.

Three pieces:

- **Scoring** -- ``psi`` (population stability index) and ``js_distance``
  (Jensen-Shannon distance, base-2, in [0, 1]) between two
  :class:`~..observability.sketch.StreamingSketch` histograms that share a
  binning. PSI is the primary gate (industry convention: < 0.1 stable,
  0.1-0.25 moderate, > 0.25 major shift); JS rides along as a bounded,
  symmetric second opinion.
- **FeatureProfile** -- named per-signal reference sketches plus
  provenance (model generation, creation time), JSON round-trippable so a
  profile persists as a registry artifact next to the model weights
  (``drift_profile.json``) and rides promotions/hot-reloads with them.
- **DriftMonitor** -- the serving-side consumer: per-signal sliding live
  windows scored against the reference on a stride, with a
  sustain + cooldown hysteresis ladder (the shape of the JAX package's
  brownout controller: a score must hold above threshold for ``sustain_s`` before
  anything fires, one recommendation per excursion, re-armed only after
  every signal has recovered AND ``cooldown_s`` elapsed). When no
  reference profile exists the monitor self-baselines on its first
  ``baseline_frames`` frames -- a cold-started server still gets
  change-detection, just anchored to its own early traffic instead of the
  eval set.

Like observability/slo.py, this module is import-clean of the metrics
registry: the monitor takes injected callbacks (``on_score``,
``on_recommendation``) and the serving layer wires them to the
``rdp_drift_*`` families (observability/instruments.py).

What differs from the JAX module: :func:`capture_feature_profile` runs
the port's analyzer (``ops/pipeline.make_frame_analyzer``) over a port
model on ``device`` (the card unless the caller asks for the CPU), and
:func:`frame_signals` reads the port's ``FrameAnalysis``. Everything else,
the JSON of a profile included, is the JAX module's, so a profile written
by either package loads in the other.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Mapping, NamedTuple, Sequence

from robotic_discovery_platform_tpu_torch.observability.sketch import StreamingSketch
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_PROFILE_ENV_VAR = "RDP_DRIFT_PROFILE"

#: File name a reference profile is stored under inside a registry model
#: version's artifact directory (next to variables.msgpack).
DRIFT_PROFILE_FILE = "drift_profile.json"


class SignalSpec(NamedTuple):
    """Declared range + resolution of one monitored signal. Reference and
    live sketches are both built from this, so they always compare."""

    lo: float
    hi: float
    bins: int = 32


#: The serving signals the platform monitors, with their natural ranges.
#: All five are free at serving time: the fused graph already computes
#: them (ops/pipeline.FrameAnalysis) or they fall out of the raw depth
#: frame on the host. Curvature ranges are generous -- the overflow slot
#: catches outliers, and a mass migration INTO overflow is itself drift.
SERVING_SIGNALS: dict[str, SignalSpec] = {
    "mask_coverage": SignalSpec(0.0, 100.0),
    "mean_curvature": SignalSpec(0.0, 25.0),
    "max_curvature": SignalSpec(0.0, 50.0),
    "depth_valid_fraction": SignalSpec(0.0, 1.0),
    "confidence_margin": SignalSpec(0.0, 0.5),
}


def resolve_drift_profile_path(configured: str) -> str | None:
    """The effective reference-profile path: ``RDP_DRIFT_PROFILE`` when
    set, else the configured value; None (registry lookup / self-baseline)
    when both are empty."""
    raw = os.environ.get(_PROFILE_ENV_VAR, "").strip()
    path = raw or str(configured or "").strip()
    return path or None


# -- divergence scoring ------------------------------------------------------


def psi(ref_counts: Sequence[float], live_counts: Sequence[float],
        pseudo: float = 0.5) -> float:
    """Population stability index between two aligned COUNT vectors:
    ``sum((q - p) * ln(q / p))`` with ``p`` the reference and ``q`` the
    live distribution, both Laplace-smoothed (``pseudo`` added to every
    cell before normalizing). >= 0, unbounded above. Laplace smoothing --
    not an epsilon floor -- matters at streaming sample sizes: a cell
    empty in a 64-frame reference floored at 1e-4 against a live cell at
    1/64 contributes ~0.1 of pure sampling noise PER CELL; the
    pseudo-count keeps the log ratios of sparse cells bounded."""
    if len(ref_counts) != len(live_counts):
        raise ValueError(
            f"misaligned distributions: {len(ref_counts)} vs "
            f"{len(live_counts)}"
        )
    m = len(ref_counts)
    na, nb = sum(ref_counts), sum(live_counts)
    p = [(c + pseudo) / (na + pseudo * m) for c in ref_counts]
    q = [(c + pseudo) / (nb + pseudo * m) for c in live_counts]
    return float(sum(
        (b - a) * math.log(b / a) for a, b in zip(p, q)
    ))


def psi_noise_floor(ref_counts: Sequence[float],
                    live_counts: Sequence[float]) -> float:
    """Expected same-distribution PSI from sampling noise alone: the
    chi-square asymptotic ``(m_occupied - 1) * (1/n_ref + 1/n_live)``.
    Finite windows make PSI biased upward -- at 32 samples over 30 cells
    the bias alone can exceed the conventional 0.25 "major shift" line --
    so every threshold comparison in this module gates on
    ``psi > threshold + noise_floor``. Empirically (tests/test_drift.py)
    this holds same-distribution false flags to a few percent per scoring
    pass while a genuine mean shift scores an order of magnitude above
    the gate."""
    n_ref = max(sum(ref_counts), 1)
    n_live = max(sum(live_counts), 1)
    occupied = sum(1 for a, b in zip(ref_counts, live_counts) if a or b)
    return max(occupied - 1, 1) * (1.0 / n_ref + 1.0 / n_live)


def js_distance(p: Sequence[float], q: Sequence[float],
                eps: float = 1e-12) -> float:
    """Jensen-Shannon *distance* (sqrt of the base-2 divergence): a
    bounded [0, 1] metric -- 0 for identical distributions, 1 for
    disjoint support."""
    if len(p) != len(q):
        raise ValueError(f"misaligned distributions: {len(p)} vs {len(q)}")

    def _kl(a: Sequence[float], m: Sequence[float]) -> float:
        return sum(
            ai * math.log2(ai / mi)
            for ai, mi in zip(a, m) if ai > eps
        )

    mid = [(a + b) / 2 for a, b in zip(p, q)]
    jsd = 0.5 * _kl(p, mid) + 0.5 * _kl(q, mid)
    return float(math.sqrt(max(jsd, 0.0)))


class DriftScore(NamedTuple):
    """One signal's live-vs-reference divergence. ``noise_floor`` is the
    expected same-distribution PSI at these sample sizes; consumers gate
    on ``psi > threshold + noise_floor`` (``exceeds``)."""

    psi: float
    js: float
    n_ref: int
    n_live: int
    noise_floor: float

    def exceeds(self, threshold: float) -> bool:
        return self.psi > threshold + self.noise_floor


def score_sketches(ref: StreamingSketch,
                   live: StreamingSketch) -> DriftScore:
    """Score a live sketch against a reference of the same binning."""
    if not ref.compatible(live):
        raise ValueError(
            f"sketch binnings differ: ref [{ref.lo}, {ref.hi})x{ref.bins} "
            f"vs live [{live.lo}, {live.hi})x{live.bins}"
        )
    ref_counts, live_counts = ref.counts(), live.counts()
    return DriftScore(
        psi=psi(ref_counts, live_counts),
        js=js_distance(ref.probabilities(), live.probabilities()),
        n_ref=ref.count, n_live=live.count,
        noise_floor=psi_noise_floor(ref_counts, live_counts),
    )


def score_value_lists(spec: SignalSpec, ref_values: Sequence[float],
                      live_values: Sequence[float]) -> DriftScore:
    """Score two raw value sequences under one declared binning -- the
    shadow gate's comparison (serving/rollout.py): candidate-vs-serving
    signal values over the SAME mirrored frames, so the two sides share
    their sampling noise."""
    return score_sketches(
        StreamingSketch.from_values(spec.lo, spec.hi, spec.bins,
                                    ref_values),
        StreamingSketch.from_values(spec.lo, spec.hi, spec.bins,
                                    live_values),
    )


# -- reference profiles ------------------------------------------------------


class FeatureProfile:
    """Named per-signal reference sketches + provenance.

    The training side captures one over eval-set predictions
    (:func:`capture_feature_profile`) and logs it as a registry artifact;
    the serving side loads it (or self-baselines) and scores live windows
    against it. ``generation`` records which model version the profile
    describes, so a hot-reload can tell a stale reference from a fresh
    one."""

    def __init__(self, signals: Mapping[str, SignalSpec] | None = None,
                 generation: str | int | None = None,
                 source: str = "capture",
                 created_unix: float | None = None):
        spec = dict(signals if signals is not None else SERVING_SIGNALS)
        self.spec = {k: SignalSpec(*v) for k, v in spec.items()}
        self.sketches: dict[str, StreamingSketch] = {
            name: StreamingSketch(s.lo, s.hi, s.bins)
            for name, s in self.spec.items()
        }
        self.generation = generation
        self.source = source
        self.created_unix = (time.time() if created_unix is None
                             else float(created_unix))

    def observe(self, signals: Mapping[str, float]) -> None:
        """Feed one frame's signal values (unknown names are ignored, so
        a caller can pass its full signal dict)."""
        for name, value in signals.items():
            sketch = self.sketches.get(name)
            if sketch is not None:
                sketch.observe(value)

    @property
    def n_frames(self) -> int:
        """Frames observed (the max across signals: a signal absent on
        some frames has a smaller count)."""
        return max((s.count for s in self.sketches.values()), default=0)

    @property
    def age_s(self) -> float:
        return max(0.0, time.time() - self.created_unix)

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "generation": self.generation,
            "source": self.source,
            "created_unix": self.created_unix,
            "signals": {
                name: sketch.snapshot()
                for name, sketch in self.sketches.items()
            },
        }

    @classmethod
    def from_dict(cls, data: dict) -> "FeatureProfile":
        signals = data.get("signals", {})
        spec = {
            name: SignalSpec(s["lo"], s["hi"], s["bins"])
            for name, s in signals.items()
        }
        profile = cls(spec, generation=data.get("generation"),
                      source=data.get("source", "capture"),
                      created_unix=data.get("created_unix", 0.0))
        profile.sketches = {
            name: StreamingSketch.restore(s) for name, s in signals.items()
        }
        return profile

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path

    @classmethod
    def load(cls, path: str | Path) -> "FeatureProfile":
        return cls.from_dict(json.loads(Path(path).read_text()))


def capture_feature_profile(
    model,
    frames: Sequence[tuple],
    img_size: int = 256,
    geom_cfg=None,
    depth_scale: float = 0.001,
    intrinsics=None,
    generation: str | int | None = None,
    signals: Mapping[str, SignalSpec] | None = None,
    device="cuda",
) -> FeatureProfile:
    """Run ``(rgb_u8, depth_u16)`` frames through the port's frame
    analyzer on ``device`` and record the five serving signals into a
    reference profile -- the training-time half of the drift loop
    (workflows/retraining.py calls this over eval-set scenes after
    registering a new version). ``model`` is a forward
    (``ops/unet_infer.FoldedUNet``) or a ``models/unet.UNet``, which is
    put on the kernels here (``ops/unet_infer.reference_forward``).

    On the card the analyzer captures one CUDA graph per frame shape, as
    the JAX analyzer traces once per shape; the analyzer, its graphs and
    their memory pool are dropped before this returns
    (``ops/graphs.release_dead_pools``)."""
    import numpy as np

    from robotic_discovery_platform_tpu_torch.models.unet import UNet
    from robotic_discovery_platform_tpu_torch.ops import graphs, pipeline
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
        reference_forward,
    )
    from robotic_discovery_platform_tpu_torch.utils.config import (
        GeometryConfig,
    )
    from robotic_discovery_platform_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(device)
    geom_cfg = geom_cfg if geom_cfg is not None else GeometryConfig()
    forward = (reference_forward(model, device=device)
               if isinstance(model, UNet) else model)
    analyze = pipeline.make_frame_analyzer(
        forward, img_size=img_size, geom_cfg=geom_cfg, device=device
    )
    profile = FeatureProfile(signals, generation=generation,
                             source="capture")
    try:
        for rgb, depth in frames:
            h, w = rgb.shape[:2]
            if intrinsics is None:
                f = 0.94 * w
                k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                             np.float32)
            else:
                k = np.asarray(intrinsics, np.float32)
            out = analyze(rgb, depth, k, np.float32(depth_scale))
            profile.observe(frame_signals(out, depth))
    finally:
        del analyze, forward
        if device.type == "cuda":
            graphs.release_dead_pools()
    return profile


def frame_signals(analysis, depth) -> dict[str, float]:
    """One frame's monitored signal values from a FrameAnalysis + the raw
    depth frame (shared by serving and profile capture so both sides
    measure identically). Curvatures are only meaningful on valid
    profiles; invalid frames report them as NaN, which the sketches count
    separately instead of folding into the distribution. The fields are
    the port's tensors (read to the host here) or numbers."""
    import numpy as np

    prof = analysis.profile
    valid = bool(prof.valid)
    return {
        "mask_coverage": float(analysis.mask_coverage),
        "mean_curvature": (
            float(prof.mean_curvature) if valid else math.nan
        ),
        "max_curvature": (
            float(prof.max_curvature) if valid else math.nan
        ),
        "depth_valid_fraction": (
            float(np.count_nonzero(depth)) / max(depth.size, 1)
        ),
        "confidence_margin": float(analysis.confidence_margin),
    }


# -- the online monitor ------------------------------------------------------


@dataclass
class RetrainRecommendation:
    """A structured "this model should be retrained" event, the input of
    workflows/retraining."""

    signals: list[str]  # the sustained-over-threshold signals
    scores: dict[str, float]  # signal -> PSI at fire time
    generation: str | int | None
    reference_source: str
    fired_unix: float = field(default_factory=time.time)

    @property
    def reason(self) -> str:
        worst = ", ".join(
            f"{s} psi={self.scores.get(s, 0.0):.3f}" for s in self.signals
        )
        return (f"sustained input/prediction drift on {worst} vs "
                f"{self.reference_source} reference "
                f"(model generation {self.generation})")

    def to_dict(self) -> dict:
        return {
            "signals": list(self.signals),
            "scores": dict(self.scores),
            "generation": self.generation,
            "reference_source": self.reference_source,
            "fired_unix": self.fired_unix,
            "reason": self.reason,
        }


class DriftMonitor:
    """Per-signal sliding live windows scored against a reference profile,
    with sustain + cooldown hysteresis around the recommendation.

    Strictly host-side bookkeeping: ``observe_frame`` appends five floats
    to deques and, every ``score_every`` frames, rebuilds five small
    histograms and computes PSI/JS -- no device work, no jit, nothing on
    the compute path.

    Hysteresis (mirrors the JAX package's brownout ladder):

    - a signal's PSI must stay above ``psi_threshold`` *plus its
      sampling-noise floor* (:func:`psi_noise_floor`) for ``sustain_s``
      before it counts as drifted (one weird scoring window moves
      nothing);
    - at most ONE recommendation per excursion: firing disarms the
      monitor, and it re-arms only after every signal has dropped back
      below threshold AND ``cooldown_s`` has elapsed -- a flapping signal
      cannot machine-gun retraining runs.

    ``clock`` is injectable (fake-clock tests).
    """

    def __init__(
        self,
        reference: FeatureProfile | None = None,
        signals: Mapping[str, SignalSpec] | None = None,
        window: int = 256,
        baseline_frames: int = 64,
        score_every: int = 16,
        min_live: int = 16,
        psi_threshold: float = 0.25,
        sustain_s: float = 5.0,
        cooldown_s: float = 60.0,
        generation: str | int | None = None,
        on_score: Callable[[str, DriftScore], None] | None = None,
        on_recommendation: (
            Callable[[RetrainRecommendation], None] | None) = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = dict(signals if signals is not None
                         else (reference.spec if reference is not None
                               else SERVING_SIGNALS))
        self.window = max(2, int(window))
        self.baseline_frames = max(2, int(baseline_frames))
        self.score_every = max(1, int(score_every))
        self.min_live = max(2, int(min_live))
        self.psi_threshold = float(psi_threshold)
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.generation = generation
        self._on_score = on_score
        self._on_recommendation = on_recommendation
        self._clock = clock
        self._lock = checked_lock("drift.monitor")
        self._windows: dict[str, deque[float]] = {  # guarded_by: _lock
            name: deque(maxlen=self.window) for name in self.spec
        }
        self._reference: FeatureProfile | None = None  # guarded_by: _lock
        self._baseline: FeatureProfile | None = None  # guarded_by: _lock
        self._frames = 0  # guarded_by: _lock
        self._scores: dict[str, DriftScore] = {}  # guarded_by: _lock
        self._above_since: dict[str, float] = {}  # guarded_by: _lock
        self._armed = True  # guarded_by: _lock
        self._last_fire: float | None = None  # guarded_by: _lock
        self._fired_total = 0  # guarded_by: _lock
        self.recommendations: list[RetrainRecommendation] = []
        if reference is not None:
            self.set_reference(reference)

    # -- reference lifecycle ------------------------------------------------

    def set_reference(self, profile: FeatureProfile) -> None:
        """Adopt a reference profile (registry artifact or explicit path);
        resets the live windows and the hysteresis state -- scores against
        the old reference say nothing about the new one."""
        with self._lock:
            self._reference = profile
            if profile.generation is not None:
                # the monitor's own stamp follows the adopted reference,
                # so snapshot()["generation"] is single-sourced
                self.generation = profile.generation
            self.spec = dict(profile.spec)
            self._reset_live_locked()
        log.info(
            "drift reference adopted: %s profile for generation %s "
            "(%d frames, %.0fs old)", profile.source, profile.generation,
            profile.n_frames, profile.age_s,
        )

    def rebaseline(self, generation: str | int | None = None) -> None:
        """Drop the current reference and self-baseline on the next
        ``baseline_frames`` frames, re-stamped for ``generation`` -- the
        hot-reload path when the promoted version ships no profile."""
        with self._lock:
            self.generation = generation
            self._reference = None
            self._baseline = None
            self._reset_live_locked()
        log.info("drift monitor re-baselining for generation %s over the "
                 "next %d frames", generation, self.baseline_frames)

    def _reset_live_locked(self) -> None:
        for dq in self._windows.values():
            dq.clear()
        self._windows = {
            name: deque(maxlen=self.window) for name in self.spec
        }
        self._frames = 0
        self._scores = {}
        self._above_since = {}
        self._armed = True

    @property
    def reference(self) -> FeatureProfile | None:
        with self._lock:
            return self._reference

    @property
    def reference_age_s(self) -> float | None:
        ref = self.reference
        return None if ref is None else ref.age_s

    @property
    def frames_observed(self) -> int:
        with self._lock:
            return self._frames

    @property
    def scores(self) -> dict[str, DriftScore]:
        with self._lock:
            return dict(self._scores)

    # -- the per-frame hook -------------------------------------------------

    def observe_frame(self, signals: Mapping[str, float]) -> (
            RetrainRecommendation | None):
        """Feed one frame's signals; returns a recommendation iff this
        frame's scoring pass fired one."""
        fired: RetrainRecommendation | None = None
        callbacks: list[tuple[str, DriftScore]] = []
        with self._lock:
            self._frames += 1
            if self._reference is None:
                # self-baselining: the first baseline_frames frames BUILD
                # the reference; scoring starts after it freezes
                if self._baseline is None:
                    self._baseline = FeatureProfile(
                        self.spec, generation=self.generation,
                        source="self-baseline",
                    )
                self._baseline.observe(signals)
                if self._baseline.n_frames >= self.baseline_frames:
                    self._reference = self._baseline
                    self._baseline = None
                    self._frames = 0
                    log.info(
                        "drift monitor self-baselined over %d frames "
                        "(generation %s)", self._reference.n_frames,
                        self.generation,
                    )
                return None
            for name, dq in self._windows.items():
                value = signals.get(name)
                if value is not None and math.isfinite(float(value)):
                    dq.append(float(value))
            if self._frames % self.score_every == 0:
                fired = self._rescore_locked(callbacks)
        # callbacks run outside the lock: a gauge set / recorder pin must
        # never hold up (or re-enter) the monitor
        if self._on_score is not None:
            for name, score in callbacks:
                self._on_score(name, score)
        if fired is not None and self._on_recommendation is not None:
            self._on_recommendation(fired)
        return fired

    def _rescore_locked(self, callbacks: list) -> (
            RetrainRecommendation | None):
        now = self._clock()
        sustained: list[str] = []
        any_above = False
        for name, spec in self.spec.items():
            ref_sketch = self._reference.sketches.get(name)
            dq = self._windows[name]
            if ref_sketch is None or len(dq) < self.min_live:
                continue
            live = StreamingSketch.from_values(
                spec.lo, spec.hi, spec.bins, dq
            )
            score = score_sketches(ref_sketch, live)
            self._scores[name] = score
            callbacks.append((name, score))
            if score.exceeds(self.psi_threshold):
                any_above = True
                since = self._above_since.setdefault(name, now)
                if now - since >= self.sustain_s:
                    sustained.append(name)
            else:
                self._above_since.pop(name, None)
        if not any_above:
            # full recovery: every signal back under threshold re-arms the
            # monitor once the cooldown has also passed
            if (not self._armed and self._last_fire is not None
                    and now - self._last_fire >= self.cooldown_s):
                self._armed = True
        if not (sustained and self._armed):
            return None
        if (self._last_fire is not None
                and now - self._last_fire < self.cooldown_s):
            return None
        self._armed = False
        self._last_fire = now
        rec = RetrainRecommendation(
            signals=sorted(sustained),
            scores={s: self._scores[s].psi for s in sustained},
            generation=(self._reference.generation
                        if self._reference.generation is not None
                        else self.generation),
            reference_source=self._reference.source,
        )
        self._fired_total += 1
        self.recommendations.append(rec)
        del self.recommendations[:-16]  # bound the history
        return rec

    @property
    def recommendations_total(self) -> int:
        with self._lock:
            return self._fired_total

    # -- the /debug/drift payload -------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready state: per-signal live vs reference histograms and
        scores, the reference's provenance, and the recommendation
        state -- what ``GET /debug/drift`` serves."""
        with self._lock:
            ref = self._reference
            per_signal = {}
            for name, spec in self.spec.items():
                dq = self._windows[name]
                live = StreamingSketch.from_values(
                    spec.lo, spec.hi, spec.bins, dq
                )
                score = self._scores.get(name)
                ref_sketch = (ref.sketches.get(name)
                              if ref is not None else None)
                per_signal[name] = {
                    "range": [spec.lo, spec.hi],
                    "bins": spec.bins,
                    "reference": (ref_sketch.snapshot()
                                  if ref_sketch is not None else None),
                    "live": live.snapshot(),
                    "psi": score.psi if score else None,
                    "js": score.js if score else None,
                    "noise_floor": score.noise_floor if score else None,
                    "above_threshold": (
                        score.exceeds(self.psi_threshold)
                        if score else False
                    ),
                }
            state = ("scoring" if ref is not None else "baselining")
            return {
                "enabled": True,
                "state": state,
                # the generation this monitor is currently anchored to:
                # the reference's when one exists, else the stamp the
                # next self-baseline will carry. Promotion swaps this
                # together with the engine generation (serving/server.py
                # maybe_reload), and /debug/drift consumers assert the
                # pair never mixes.
                "generation": (ref.generation if ref is not None
                               and ref.generation is not None
                               else self.generation),
                "frames_observed": self._frames,
                "baseline_frames": self.baseline_frames,
                "thresholds": {
                    "psi": self.psi_threshold,
                    "sustain_s": self.sustain_s,
                    "cooldown_s": self.cooldown_s,
                },
                "reference": (None if ref is None else {
                    "source": ref.source,
                    "generation": ref.generation,
                    "created_unix": ref.created_unix,
                    "age_s": ref.age_s,
                    "n_frames": ref.n_frames,
                }),
                "signals": per_signal,
                "recommendations": {
                    "count": self._fired_total,
                    "armed": self._armed,
                    "last": (self.recommendations[-1].to_dict()
                             if self.recommendations else None),
                },
            }
