"""Configuration of the port: the fields of the JAX package's
``ModelConfig``, ``TrainConfig``, ``GeometryConfig``, ``ServerConfig``,
``RolloutConfig``, ``ClientConfig`` and ``MeshConfig`` that the serving,
rollout, client and training paths read, with the same names and
defaults, the offline drift detector's ``DriftConfig``, and the operator
tools' ``CameraConfig``, ``CalibrationConfig`` and ``CollectConfig``,
plus ``from_dict`` and ``--section.field`` flag parsing for them.

:func:`check_supported` raises ``ValueError`` for a value no package
knows. Every ``MeshConfig`` is taken; a train step over ``spatial`` or
``model`` > 1 raises ``NotImplementedError`` there (ROADMAP item 34,
``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

#: ``GeometryConfig.kernel_impl`` values, the JAX package's names
KERNEL_IMPLS = ("auto", "pallas", "xla", "interpret")

#: ``ModelConfig.conv_impl`` values: the first three train through the
#: hand-written conv kernels (``ops/conv.conv3x3``), the last two through
#: plain torch convs with autograd
CONV_IMPLS = ("auto", "pallas", "interpret", "flax", "xla")
PLAIN_CONV_IMPLS = ("flax", "xla")

#: ``TrainConfig.epoch_mode`` values, the JAX package's names
EPOCH_MODES = ("auto", "scan", "stream")

#: ``ServerConfig.precision`` tiers, the JAX package's names
#: (``ops/quant.py``; ``RDP_PRECISION`` overrides the field on either path,
#: ``ops/quant.resolve_precision``)
PRECISIONS = ("f32", "bf16", "int8")

#: ``ServerConfig.batch_impl`` values, the JAX package's names
BATCH_IMPLS = ("dense", "scan")

#: ``ServerConfig.model_forward`` values, the JAX package's names
MODEL_FORWARDS = ("auto", "pallas", "flax")

#: ``ModelConfig.norm`` values, the JAX package's names: BatchNorm (the
#: reference's, folded by the served forward) and GroupNorm (unfolded)
NORMS = ("batch", "group")



@dataclass(frozen=True)
class CameraConfig:
    """The camera stream: 640x480 at 30 FPS, depth z16 and color bgr8."""

    width: int = 640
    height: int = 480
    fps: int = 30


@dataclass(frozen=True)
class ModelConfig:
    """U-Net architecture: channel ladder base_features x (1, 2, 4, 8,
    16 // factor), factor 2 when ``bilinear`` (the deployed default), 1
    for the transposed-conv decoder."""

    in_channels: int = 3
    num_classes: int = 1
    bilinear: bool = True
    base_features: int = 64
    compute_dtype: str = "bfloat16"  # activations; params stay float32
    norm: str = "batch"
    # weight-init family: "torch" = Conv2d's kaiming_uniform_(a=sqrt(5)),
    # "lecun" = truncated-normal lecun (the Flax default)
    init: str = "torch"
    # the training forward's 3x3 convs (UNet.forward(train=True)): "auto",
    # "pallas" and "interpret" run the custom-VJP ops/conv.conv3x3 on the
    # hand-written kernels (their plain versions for CPU tensors); "flax"
    # and "xla" run plain torch convs with autograd. Inference ignores it.
    conv_impl: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    """The trainer's settings (``training/trainer.train_model``), the JAX
    package's names and defaults. ``epoch_mode`` picks the epoch form by
    the JAX package's rule (``trainer.resolve_epoch_mode``): "scan", or
    "auto" with in-memory arrays of at most ``scan_max_bytes``, runs the
    whole-epoch scan (on the card one captured step replayed per batch);
    "stream", or "auto" over a dataset directory, the per-batch loop.
    ``donate_state`` (XLA buffer donation of the train state) and
    ``tp_min_channels`` (tensor parallelism) are accepted and have no
    effect on the card: the port updates the state in place."""

    learning_rate: float = 1e-4
    batch_size: int = 4
    epochs: int = 50
    validation_split: float = 0.2
    img_size: int = 256
    seed: int = 0
    loss: str = "bce"  # "bce", "dice" or "bce_dice"
    dice_weight: float = 0.5
    tracking_uri: str = "file:ml/mlruns"
    experiment_name: str = "Actuator Segmentation"
    registered_model_name: str = "Actuator-Segmenter"
    dataset_dir: str = "ml/datasets/processed"
    checkpoint_dir: str = "ml/checkpoints"
    keep_checkpoints: int = 3
    # checkpoint every N epochs; the final epoch always saves
    checkpoint_every: int = 1
    # write checkpoints on a background thread from a host snapshot
    async_checkpointing: bool = True
    donate_state: bool = True
    log_every: int = 1
    tp_min_channels: int = 256
    loader_workers: int = 4  # decode threads of the file-backed loader
    epoch_mode: str = "auto"
    scan_max_bytes: int = 4 * 1024**3


@dataclass(frozen=True)
class GeometryConfig:
    """Edge extraction, spline fit and curvature sampling."""

    num_bins: int = 50
    top_k_percent: float = 0.05
    # a single frame's geometry path: "auto" (default), "pallas" and
    # "interpret" run the fused geometry kernels, "xla" the reference ops
    # (resolve_kernel_impl)
    kernel_impl: str = "auto"
    stride: int = 1
    spline_degree: int = 3
    spline_smoothing: float = 1e-3
    num_samples: int = 100
    min_cloud_points: int = 100
    min_edge_points: int = 20
    max_per_bin: int = 128
    num_ctrl: int = 16
    default_depth_scale: float = 0.001


@dataclass(frozen=True)
class ServerConfig:
    """The server's settings: the direct path's, and the batched path's
    (``batch_window_ms > 0``, ``serving/batching.py``)."""

    address: str = "[::]:50051"
    max_workers: int = 10
    model_img_size: int = 256
    default_depth_scale: float = 0.001
    # the registry a server with no forward loads its model from: the
    # model_alias version first, else the latest (serving/server.py
    # resolve_serving_model)
    tracking_uri: str = "file:ml/mlruns"
    model_name: str = "Actuator-Segmenter"
    model_alias: str = "staging"
    calibration_path: str = "ml/configs/calibration_data.npz"
    metrics_csv: str = "logs/vision_service_metrics.csv"
    metrics_flush_every: int = 32
    # > 0 turns on cross-stream micro-batching: frames of concurrent
    # streams that arrive within this window share one dispatch
    batch_window_ms: float = 0.0
    max_batch: int = 8  # per-dispatch cap when micro-batching
    # "dense": one [B, ...] forward per dispatch; "scan": one dispatch
    # that runs the single-frame path once per frame (the frame's working
    # set, the geometry kernels on every frame)
    batch_impl: str = "dense"
    # launched-but-not-completed dispatches: 1 = serial, 2 = batch N+1
    # stages and computes while batch N's result comes back
    max_inflight_dispatches: int = 2
    # devices the batch dispatcher routes its in-flight window across
    # (serving/batching.DeviceRouter): 0/1 = one device, N > 1 the first
    # N, -1 every card. Only on the batched path; RDP_SERVING_CHIPS
    # overrides it
    serving_mesh: int = 0
    # "round_robin": each bucket whole onto the least-loaded device;
    # "sharded": each bucket split evenly over the ring. RDP_DISPATCH_MODE
    # overrides it
    dispatch_mode: str = "round_robin"
    egress_pack: bool = True  # one packed [B, P] D2H per dispatch
    # response mask encode pool (serving/egress.EncodePool): 0 = inline in
    # the handler thread, N > 0 = N worker threads, negative = one per
    # CPU. The RDP_EGRESS_WORKERS environment variable overrides it.
    egress_workers: int = 0
    # request decode pool (serving/ingest.DecodePool): 0 = inline in the
    # handler thread, N > 0 = N worker threads with per-stream read-ahead
    # (frames whose deadline passes in the queue are shed before their
    # decode), negative = one per CPU. RDP_DECODE_WORKERS overrides it.
    decode_workers: int = 0
    # requests each stream reads ahead into the decode pool
    ingest_prefetch: int = 2
    # the served forward of a registered model: "auto" and "pallas" fold
    # it onto the hand-written kernels (ops/unet_infer.FoldedUNet);
    # "flax" serves the unfolded models/unet.UNet in eval mode
    model_forward: str = "auto"
    submit_deadline_s: float = 30.0  # per-frame wait on the dispatcher
    max_backlog: int = 64  # queued frames before submits are shed
    watchdog_interval_s: float = 1.0  # <= 0 disables the watchdog
    # backlog overflow policy: "deadline" evicts the least-headroom frame,
    # "fifo" rejects the newcomer (serving/admission.py)
    admission_policy: str = "deadline"
    # the reactive SLO controller (serving/controller.py): retunes
    # max_inflight, the batch window, the bucket floor and the admission
    # safety online from the error-budget burn, with a brownout ladder
    # under sustained burn > 1. Needs slo_ms > 0 and batch_window_ms > 0.
    # The RDP_CONTROLLER environment variable overrides it.
    controller_enabled: bool = False
    # tick period; every decision also passes the sustain and cooldown
    controller_interval_s: float = 0.5
    # how long burn must hold beyond a threshold before it counts
    controller_sustain_s: float = 1.0
    # minimum spacing between actions (one rung or AIMD step at a time)
    controller_cooldown_s: float = 2.0
    # hysteresis around burn = 1: escalate above high, de-escalate or
    # tune below low, dead band between
    controller_burn_high: float = 1.0
    controller_burn_low: float = 0.5
    # AIMD ceiling of the controller's additive max_inflight increases
    controller_inflight_cap: int = 8
    geometry_stride: int = 1
    # serving precision tier (ops/quant.py): "f32" serves the model as
    # configured; "bf16" computes activations in bfloat16; "int8" also
    # puts every conv kernel on a per-output-channel int8 grid. The
    # RDP_PRECISION environment variable overrides it.
    precision: str = "f32"
    # warm-up parity gate of a bf16/int8 tier (ignored at f32): golden
    # frames through an f32 reference and the tier's path; the server
    # refuses to come up below the mean mask IoU floor or above the worst
    # |delta curvature| (1/m) ceiling
    quant_parity_frames: int = 4
    quant_parity_min_iou: float = 0.90
    quant_parity_max_curv_err: float = 0.5
    # on-chip split JPEG decode: baseline-JPEG color payloads are
    # entropy-decoded on the host (serving/entropy.py) and ride the
    # coefficient lane; the RDP_ONCHIP_DECODE environment variable
    # overrides it (serving/ingest.resolve_onchip_decode)
    onchip_decode: bool = False
    # Prometheus exposition (observability/exposition.py): port of the
    # stdlib `GET /metrics` and `/debug/*` endpoint, started and stopped
    # with the gRPC server. 0 = off; negative = an ephemeral port (read it
    # back from servicer.metrics_server.port). RDP_METRICS_PORT overrides.
    metrics_port: int = 0
    # hot reload: how often a running server polls the registry; when the
    # alias (or the latest version) moves, the new model is built, warmed
    # and its CUDA graphs captured off the serving path, then swapped in
    # without dropping streams. <= 0 disables polling.
    reload_poll_s: float = 10.0
    # after a swap, how long the old generation's batch dispatcher stays
    # up for its in-flight frames before its drain-safe stop
    reload_grace_s: float = 10.0
    # registry circuit breaker (resilience/breaker.py): after this many
    # consecutive resolve failures the reload poll fast-fails (serving
    # keeps its current model) until one half-open probe succeeds
    registry_breaker_failures: int = 3
    # how long the open breaker fast-fails before admitting a probe
    registry_breaker_reset_s: float = 60.0
    # per-device dispatch breaker of a routed ring: after this many
    # consecutive failures a device is quarantined until a probe dispatch
    # succeeds (0 disables; the last healthy device never is)
    chip_breaker_failures: int = 3
    # how long a quarantined device fast-fails before a probe
    chip_breaker_reset_s: float = 15.0
    # graceful shutdown: how long drain() waits for in-flight streams
    # after readiness flips to NOT_SERVING
    drain_grace_s: float = 5.0
    # end-to-end latency objective in ms (observability/slo.py): slower,
    # shed or errored frames count as violations and burn the error
    # budget. 0 = off. RDP_SLO_MS overrides.
    slo_ms: float = 0.0
    # the fraction of frames allowed to miss the objective
    slo_budget: float = 0.01
    # sliding window (frames) of the burn-rate estimate
    slo_window: int = 512
    # online drift monitoring (monitoring/profile.py): every served frame's
    # signals (mask coverage, curvatures, depth-validity fraction,
    # confidence margin) feed per-signal sliding windows scored (PSI /
    # Jensen-Shannon) against a reference profile; host-side bookkeeping
    # after the response is built
    drift_enabled: bool = True
    # reference profile JSON (monitoring/profile.FeatureProfile). Empty =
    # drift_profile.json next to the served registry version's weights,
    # else a self-baseline over the first drift_baseline_frames frames.
    # The RDP_DRIFT_PROFILE environment variable overrides it
    # (monitoring/profile.resolve_drift_profile_path).
    drift_profile_path: str = ""
    # sliding live window (frames) each signal is scored over
    drift_window: int = 256
    # self-baseline size when no reference profile is available
    drift_baseline_frames: int = 64
    # rescore every N observed frames
    drift_score_every: int = 16
    # PSI above this (plus its noise floor) counts a signal as drifted
    drift_psi_threshold: float = 0.25
    # hysteresis: a signal must hold above threshold this long before a
    # retrain recommendation fires; after one fires the monitor re-arms
    # only once every signal has recovered and this cooldown has passed
    drift_sustain_s: float = 5.0
    drift_cooldown_s: float = 300.0
    # -- cross-host serving fleet (serving/fleet.py, serving/frontend.py) ---
    # Comma-separated replica endpoints ("host:port,host:port") the fleet
    # front-end fans AnalyzeActuatorPerformance streams out to. Each
    # endpoint is a full per-host replica server (its own chip mesh,
    # reached over localhost/DCN gRPC). Empty = this process is a plain
    # single-host server, exactly today's behavior. The
    # RDP_FLEET_REPLICAS env var overrides this value.
    fleet_replicas: str = ""
    # Membership poll period: every tick each replica's grpc.health.v1
    # status is checked and its stats RPC scraped; a replica reporting
    # NOT_SERVING (or unreachable) drops out of the placement ring
    # exactly like a chip drops out of the chip ring.
    fleet_poll_s: float = 1.0
    # Per-probe deadline for the health check / stats scrape RPCs.
    fleet_probe_timeout_s: float = 1.0
    # Per-replica circuit breaker (resilience/breaker.py): after this
    # many consecutive failed probes or stream-level failures the
    # replica is quarantined out of the ring until a half-open health
    # probe succeeds after fleet_breaker_reset_s.
    fleet_breaker_failures: int = 2
    fleet_breaker_reset_s: float = 5.0
    # How many times one client stream may fail over to another replica
    # (in-flight frames are re-sent to the new replica) before its
    # remaining in-flight frames error-complete instead.
    fleet_max_failovers: int = 3
    # Fleet-level SLO controller: consumes each replica's error-budget
    # burn (scraped via the stats RPC) and de-weights replicas whose
    # burn approaches 1 so new streams shift away BEFORE the replica
    # browns out (the reactive SLO control loop lifted one level).
    fleet_controller_enabled: bool = True
    # De-weighting starts when a replica's burn exceeds this (kept below
    # the replica's own brownout trigger at burn = 1).
    fleet_burn_high: float = 0.8
    # Weight floor: a burning replica keeps at least this share of its
    # idle placement weight (0 would starve its burn signal, the same
    # reason brownout rung 3 duty-cycles instead of refusing all).
    fleet_weight_floor: float = 0.1
    # -- elastic membership (lease registration, serving/fleet.py) ----------
    # Elastic membership master switch for the FRONT-END: when on, the
    # front-end runs a LeaseRegistry, accepts Register/Renew/Leave RPCs
    # from self-announcing replicas, and tolerates an empty static
    # replica list (members arrive by lease). Off = static membership,
    # exactly today's behavior. The RDP_FLEET_ELASTIC env var overrides.
    fleet_elastic: bool = False
    # Comma-separated front-end endpoints this REPLICA registers its
    # membership lease with on boot and renews on a TTL ("" = static
    # membership only, exactly today's behavior). The
    # RDP_FLEET_REGISTRARS env var overrides this value.
    fleet_registrars: str = ""
    # Endpoint this replica advertises in its lease ("" = derive
    # localhost:<bound port> at boot). The RDP_FLEET_ADVERTISE env var
    # overrides this value.
    fleet_advertise: str = ""
    # Lease TTL: a member that misses renewals for this long is expired
    # through the health drop-out path (renew cadence is ttl/3). Also
    # the TTL the FRONT-END's LeaseRegistry grants.
    fleet_lease_ttl_s: float = 10.0
    # Comma-separated sibling front-end endpoints this FRONT-END gossips
    # placement + lease state with over the stats RPC ("" = standalone
    # front-end, no gossip). The RDP_FLEET_PEERS env var overrides this.
    fleet_peers: str = ""
    # -- autoscaler (serving/planner.py) ------------------------------------
    # Master switch: when on, the front-end runs the capacity planner
    # against the live /federate roll-ups and acts on its scale-up/down
    # recommendations (spawn a self-registering replica / drain the
    # least-loaded member). Off = static fleet, exactly today's
    # behavior. The RDP_AUTOSCALER env var overrides this value.
    autoscaler_enabled: bool = False
    # Replica-count bounds the autoscaler may move between.
    autoscaler_min_replicas: int = 1
    autoscaler_max_replicas: int = 4
    # Hysteresis: a scale signal must hold for sustain_s before an
    # action fires, and after any action the scaler sleeps cooldown_s
    # (one action at a time, never a flap).
    autoscaler_sustain_s: float = 5.0
    autoscaler_cooldown_s: float = 30.0
    # Planner headroom: plan capacity so the fleet runs at no more than
    # this fraction of its measured per-replica goodput.
    planner_headroom: float = 0.7
    # Optional LOADBENCH.json path the planner fits per-replica capacity
    # from ("" = the conservative default; the port never reads
    # ./LOADBENCH.json).
    planner_capacity_path: str = ""
    # the model zoo (serving/zoo.py, models/variants.py): a comma-separated
    # roster from the variant catalog ("seg,multi,aux"), each model with
    # its own registry entry, parity gate, drift reference and SLO
    # tracker, sharing one dispatcher. "" = the single default model, the
    # path bit for bit as without a zoo. A request's ``model`` field picks
    # the entry per frame ("" = default). RDP_ZOO_MODELS overrides it.
    zoo_models: str = ""
    # "shared" (the placer co-locates models whose arrival-rate peaks
    # anti-correlate) or "dedicated" (a static contiguous partition).
    # RDP_ZOO_PLACEMENT overrides it. On one device every model has chip 0.
    zoo_placement: str = "shared"
    # the placer's rate windows: arrivals counted per zoo_rate_interval_s
    # over a zoo_rate_window-interval sliding window
    zoo_rate_interval_s: float = 1.0
    zoo_rate_window: int = 60
    # how often a recorded arrival may trigger a re-placement
    zoo_rebalance_s: float = 5.0
    # a model extends onto a chip only when every resident's rate
    # correlation with it is below this
    zoo_corr_cap: float = 0.25
    # warm-up of each extra zoo model: how many placements capture the
    # one-frame bucket (the default model captures every bucket); the
    # other buckets capture at their first dispatch. Negative = every
    # bucket of every extra model at warm-up.
    zoo_eager_warm: int = 1


@dataclass(frozen=True)
class RolloutConfig:
    """The drift-triggered rollout (``serving/rollout.py``): a drift
    recommendation drains the least-loaded replica, retrains on it,
    shadows the candidate behind the live generation and promotes it
    through the hot-reload swap only when every gate passes; any failure
    or stage timeout rolls back. The JAX package's names and defaults."""

    # master switch; the RDP_ROLLOUT environment variable overrides it
    enabled: bool = False
    # registry alias the candidate is parked under while it is gated
    # (never the serving alias)
    candidate_alias: str = "shadow"
    # fraction of live frames the serving replicas mirror to the candidate
    shadow_fraction: float = 0.5
    # mirrored frames the shadow diff must cover before the gate may pass
    shadow_min_frames: int = 16
    # cap on queued-but-undiffed shadow frames (overflow is dropped)
    shadow_queue: int = 64
    # promotion gates, all of which must pass: the parity fixtures
    # (candidate against the live generation over ops/quant.golden_frames)
    gate_fixture_frames: int = 4
    gate_fixture_min_iou: float = 0.80
    gate_fixture_max_curv_err: float = 1.0
    # the live shadow diff over the same mirrored frames
    gate_shadow_min_iou: float = 0.50
    gate_shadow_max_curv_err: float = 1.0
    # worst noise-floor-adjusted PSI between the candidate's and the live
    # generation's signals over the mirrored frames
    gate_shadow_max_psi: float = 1.0
    # per-stage timeouts; a stage past its budget rolls the cycle back
    drain_timeout_s: float = 30.0
    retrain_timeout_s: float = 1800.0
    shadow_timeout_s: float = 120.0
    promote_timeout_s: float = 60.0


@dataclass(frozen=True)
class ClientConfig:
    """The streaming client's settings (``serving/client.py``)."""

    server_address: str = "localhost:50051"
    calibration_path: str = "ml/configs/calibration_data.npz"
    smoothing_window: int = 10
    frame_queue_len: int = 20


@dataclass(frozen=True)
class DriftConfig:
    """The offline drift detector's settings (``monitoring/drift.py``)."""

    metrics_csv: str = "logs/vision_service_metrics.csv"
    baseline_fraction: float = 0.5
    threshold: float = 0.25
    min_rows: int = 50
    report_path: str = "reports/drift_report.png"
    rolling_window: int = 20
    report_dpi: int = 150
    # baseline-vs-recent PSI above this (plus its noise floor) also flags
    # drift, so a variance blowup with a stable mean is caught
    psi_threshold: float = 0.25


@dataclass(frozen=True)
class CalibrationConfig:
    """The camera calibration tool (``tools/calibrate_camera.py``): a 9x7
    checkerboard of 27 mm squares, at least 5 views, the intrinsics saved
    where the server reads them."""

    checkerboard_cols: int = 9
    checkerboard_rows: int = 7
    square_size_mm: float = 27.0
    min_captures: int = 5
    output_path: str = "ml/configs/calibration_data.npz"


@dataclass(frozen=True)
class CollectConfig:
    """The raw data collector (``tools/collect_data.py``)."""

    output_root: str = "ml/raw_data"
    capture_interval_s: float = 0.5


@dataclass(frozen=True)
class MeshConfig:
    """The device-mesh sizes (``parallel/mesh.make_mesh``): ``data``
    (data parallelism over a process group's ranks), ``model`` and
    ``spatial`` (ROADMAP item 34 in a train step). Sizes <= 0 are
    inferred from the available devices."""

    data: int = -1
    model: int = 1
    spatial: int = 1


@dataclass(frozen=True)
class PlatformConfig:
    """Root of the sections the port reads."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    drift: DriftConfig = field(default_factory=DriftConfig)
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    collect: CollectConfig = field(default_factory=CollectConfig)


def replace(cfg: Any, **updates: Any) -> Any:
    """``dataclasses.replace`` (the configs are frozen)."""
    return dataclasses.replace(cfg, **updates)


def resolve_kernel_impl(configured: str) -> str:
    """The geometry path one frame takes for ``GeometryConfig.
    kernel_impl``: ``"fused"`` (the three geometry functions of
    ``ops/geometry_kernels.py``: their kernels for tensors on the card,
    their plain versions on the CPU) for ``"auto"`` and ``"pallas"``, and
    for ``"interpret"``, the JAX package's off-chip run of its kernels,
    whose counterpart here is the plain versions on the CPU; ``"xla"``
    (the reference ops) for ``"xla"``. It is the one switch: the port's
    tuning table (``ops/tuning``, ``CUDA_TUNE.json``) moves no stage."""
    if configured not in KERNEL_IMPLS:
        raise ValueError(
            f"unknown kernel_impl {configured!r} (choose from {KERNEL_IMPLS})"
        )
    return "xla" if configured == "xla" else "fused"


def check_supported(cfg: Any) -> None:
    """Raise ``ValueError`` for a setting no package knows (see the
    module docstring)."""
    if isinstance(cfg, GeometryConfig):
        resolve_kernel_impl(cfg.kernel_impl)
    if isinstance(cfg, ServerConfig):
        if cfg.precision.strip().lower() not in PRECISIONS:
            raise ValueError(
                f"unknown precision {cfg.precision!r} (choose from "
                f"{PRECISIONS})"
            )
        if cfg.model_forward not in MODEL_FORWARDS:
            raise ValueError(f"unknown model_forward {cfg.model_forward!r}")
        if cfg.batch_window_ms > 0:
            _check_batched(cfg)
    if isinstance(cfg, TrainConfig):
        if cfg.epoch_mode not in EPOCH_MODES:
            raise ValueError(
                f"epoch_mode must be one of {EPOCH_MODES}, got "
                f"{cfg.epoch_mode!r}"
            )
    if isinstance(cfg, ModelConfig):
        if cfg.conv_impl not in CONV_IMPLS:
            raise ValueError(
                f"unknown conv_impl {cfg.conv_impl!r} (choose from "
                f"{CONV_IMPLS})"
            )
        if cfg.norm not in NORMS:
            raise ValueError(f"unknown norm {cfg.norm!r}")


def _check_batched(cfg: ServerConfig) -> None:
    if cfg.batch_impl not in BATCH_IMPLS:
        raise ValueError(f"unknown batch_impl {cfg.batch_impl!r}")


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def _resolve(f: dataclasses.Field) -> type:
    t = f.type
    if isinstance(t, str):
        import builtins

        resolved = getattr(builtins, t, None) or globals().get(t)
        if resolved is None:
            raise TypeError(
                f"config field {f.name!r} has unresolvable annotation {t!r}"
            )
        t = resolved
    return t


def from_dict(cls: type, data: dict) -> Any:
    """Rebuild a (possibly nested) config dataclass from a plain dict.
    Unknown keys raise ``ValueError``."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, dict) and dataclasses.is_dataclass(_resolve(f)):
            kwargs[f.name] = from_dict(_resolve(f), v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def add_flags(parser: argparse.ArgumentParser, cls: type,
              prefix: str = "") -> None:
    """Register ``--section.field`` flags for every leaf of a config tree."""
    for f in dataclasses.fields(cls):
        t = _resolve(f)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            add_flags(parser, t, prefix=f"{name}.")
        else:
            parser.add_argument(f"--{name}", type=str, default=None,
                                help=f"({t.__name__})")


def apply_flags(cfg: Any, args: argparse.Namespace) -> Any:
    """Apply parsed ``--section.field`` overrides onto a frozen config."""

    def _apply(node: Any, prefix: str) -> Any:
        updates = {}
        for f in dataclasses.fields(node):
            t = _resolve(f)
            name = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(t):
                updates[f.name] = _apply(getattr(node, f.name), f"{name}.")
            else:
                raw = getattr(args, name, None)
                if raw is not None:
                    updates[f.name] = _coerce(raw, t)
        return dataclasses.replace(node, **updates)

    return _apply(cfg, "")


def parse_config(argv: Sequence[str] | None = None,
                 cls: type = PlatformConfig) -> Any:
    """Defaults, then an optional ``--config`` JSON file, then
    ``--section.field`` overrides."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file")
    add_flags(parser, cls)
    args = parser.parse_args(argv)
    cfg = cls()
    if args.config:
        cfg = from_dict(cls, json.loads(Path(args.config).read_text()))
    return apply_flags(cfg, args)
