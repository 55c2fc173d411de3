"""The canonical ``rdp_*`` metric families, defined once.

Every instrumented subsystem (serving, batching, tracking, training)
imports its instruments from here, so the full metric surface is readable
in one place and two call sites can never register conflicting schemas for
the same family. The README "Observability" section's table mirrors this
module.

Resilience is the one subsystem that must stay import-clean of
observability (it sits below everything, including this package's logging)
-- it exposes injectable observer hooks instead, and importing this module
installs them (idempotent: re-installation is a no-op assignment of the
same functions).
"""

from __future__ import annotations

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    families,
    journal as journal_lib,
)
from robotic_discovery_platform_tpu_torch.observability.registry import (
    REGISTRY,
)

# -- serving -----------------------------------------------------------------

FRAMES = REGISTRY.counter(
    families.FRAMES,
    "Frames handled by the analysis server, by terminal status "
    "(ok, degraded, error, deadline, shed) and served zoo model "
    "(models/variants.py; 'seg' is the default binary segmenter, "
    "'unknown' counts requests naming an unregistered model).",
    ("status", "model"),
)
STAGE_LATENCY = REGISTRY.histogram(
    families.STAGE_LATENCY,
    "Per-frame serving stage latency (decode, device, encode, total).",
    ("stage",),
)
INFLIGHT_STREAMS = REGISTRY.gauge(
    families.INFLIGHT_STREAMS,
    "gRPC analysis streams currently open.",
)
STAGE_LATENCY_SUMMARY = REGISTRY.summary(
    families.STAGE_LATENCY_SUMMARY,
    "Streaming-quantile companion to rdp_stage_latency_seconds: "
    "P^2-estimated p50/p95/p99/p99.9 per serving stage (decode, device, "
    "encode, total), with no histogram bucket-resolution floor.",
    ("stage",),
)
FRAME_LATENCY_SUMMARY = REGISTRY.summary(
    families.FRAME_LATENCY_SUMMARY,
    "End-to-end per-frame latency quantiles (request read to response "
    "write) -- the SLO tracker's signal.",
)

# -- precision tiers (ops/pallas/quant.py; ServerConfig.precision) -----------

SERVING_PRECISION = REGISTRY.gauge(
    families.SERVING_PRECISION,
    "Info gauge: 1 on the label of the active serving precision tier "
    "(f32, bf16, int8), 0 on the others.",
    ("precision",),
)
QUANT_PARITY_IOU = REGISTRY.gauge(
    families.QUANT_PARITY_IOU,
    "Mean mask IoU of the reduced-precision serving engine against the "
    "f32 goldens, measured at the warm-up parity check (1.0 at the f32 "
    "tier by definition; serving refuses to start below "
    "ServerConfig.quant_parity_min_iou), per served zoo model.",
    ("model",),
)
QUANT_PARITY_CURV = REGISTRY.gauge(
    families.QUANT_PARITY_CURV,
    "Absolute curvature delta (1/m) of the reduced-precision engine vs "
    "the f32 goldens at the warm-up parity check, by stat (mean, max) "
    "and served zoo model; the max drives the startup gate "
    "(ServerConfig.quant_parity_max_curv_err).",
    ("stat", "model"),
)

# -- SLO (observability/slo.py; ServerConfig.slo_ms / RDP_SLO_MS) ------------

SLO_OBJECTIVE = REGISTRY.gauge(
    families.SLO_OBJECTIVE,
    "Configured latency objective per tracked signal (absent families "
    "mean SLO tracking is off).",
    ("objective",),
)
SLO_VIOLATIONS = REGISTRY.counter(
    families.SLO_VIOLATIONS,
    "Frames that missed their latency objective (slower than the "
    "objective, shed, or errored), per tracked signal.",
    ("objective",),
)
SLO_BURN = REGISTRY.gauge(
    families.SLO_BURN,
    "Error-budget burn rate: sliding-window violation fraction divided "
    "by the budgeted fraction (ServerConfig.slo_budget). Sustained "
    "values > 1 mean the objective is being breached -- the adaptive "
    "scheduler's retune trigger. The model label splits the burn per "
    "served zoo model (model=\"\" is the aggregate the controller and "
    "fleet consume).",
    ("objective", "model"),
)

# -- drift observability (monitoring/profile.py; ServerConfig.drift_*) -------

DRIFT_SCORE = REGISTRY.gauge(
    families.DRIFT_SCORE,
    "Live-vs-reference population stability index (PSI) per monitored "
    "serving signal (mask_coverage, mean_curvature, max_curvature, "
    "depth_valid_fraction, confidence_margin) and served zoo model "
    "(each zoo entry runs its own DriftMonitor against its own "
    "reference), rescored every ServerConfig.drift_score_every frames "
    "over the sliding live window. Sustained values above "
    "ServerConfig.drift_psi_threshold fire a retrain recommendation.",
    ("signal", "model"),
)
DRIFT_RECOMMENDATIONS = REGISTRY.counter(
    families.DRIFT_RECOMMENDATIONS,
    "Structured retrain recommendations fired by the online drift "
    "monitor (hysteresis-gated: one per sustained excursion; each is "
    "also pinned in the flight recorder and visible in /debug/drift).",
)
DRIFT_REFERENCE_AGE = REGISTRY.gauge(
    families.DRIFT_REFERENCE_AGE,
    "Age of the drift monitor's reference profile (registry artifact or "
    "self-baseline); re-stamped when a hot-reload adopts a new "
    "generation's profile. -1 while no reference exists yet "
    "(self-baselining in progress).",
)
MODEL_CONFIDENCE_MARGIN = REGISTRY.histogram(
    families.MODEL_CONFIDENCE_MARGIN,
    "Per-frame segmentation confidence margin: mean |sigmoid(logit) - "
    "0.5| over the model-resolution output (0 = maximally uncertain, "
    "0.5 = saturated). A drop is the classic early signal of the model "
    "leaving its training distribution.",
    buckets=(0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5),
)
METRICS_ROWS_SKIPPED = REGISTRY.counter(
    families.METRICS_ROWS_SKIPPED,
    "Non-finite per-frame metric rows (nan/inf curvature or coverage) "
    "skipped by the CSV MetricsWriter instead of being written into the "
    "log the offline drift detector consumes.",
)
DRIFT_PROFILE_FAILURES = REGISTRY.counter(
    families.DRIFT_PROFILE_FAILURES,
    "Retraining-pipeline drift-profile captures that failed (the "
    "promoted version shipped no reference artifact, so every server "
    "adopting it silently self-baselines on its own early traffic "
    "instead of the eval set -- non-fatal, but a fleet doing it "
    "repeatedly is flying blind).",
)

# -- drift-triggered rollout (serving/rollout.py; RolloutConfig) --------------

ROLLOUT_STATE = REGISTRY.gauge(
    families.ROLLOUT_STATE,
    "Info gauge: 1 on the label of the rollout state machine's current "
    "stage (idle, draining, retraining, shadow, canary, promoting, "
    "rejoining), 0 on the others.",
    ("state",),
)
ROLLOUT_TRANSITIONS = REGISTRY.counter(
    families.ROLLOUT_TRANSITIONS,
    "Rollout state-machine transitions, by destination stage (each is "
    "also pinned in the flight recorder).",
    ("to",),
)
ROLLOUT_SHADOW_FRAMES = REGISTRY.counter(
    families.ROLLOUT_SHADOW_FRAMES,
    "Live frames mirrored to the shadow candidate, by outcome: "
    "'mirrored' (sampled into the shadow queue), 'diffed' (candidate "
    "ran it and the diff was scored), 'dropped' (shadow queue full -- "
    "the mirror never blocks serving), 'error' (candidate raised on the "
    "frame; counts against the gate).",
    ("outcome",),
)
ROLLOUT_GATE_VERDICTS = REGISTRY.counter(
    families.ROLLOUT_GATE_VERDICTS,
    "Promotion-gate evaluations, by gate (fixture_iou, fixture_curv, "
    "shadow_iou, shadow_curv, shadow_psi, shadow_frames) and verdict "
    "(pass, fail). Promotion requires every gate to pass -- fail-closed.",
    ("gate", "verdict"),
)
ROLLOUT_ROLLBACKS = REGISTRY.counter(
    families.ROLLOUT_ROLLBACKS,
    "Rollout cycles rolled back, by the stage that failed or timed out "
    "(the candidate is discarded, the drained replica rejoins, and the "
    "fleet keeps serving the old generation).",
    ("stage",),
)
ROLLOUT_CYCLES = REGISTRY.counter(
    families.ROLLOUT_CYCLES,
    "Completed rollout cycles, by outcome (promoted, rolled_back).",
    ("outcome",),
)
ROLLOUT_SKIPPED = REGISTRY.counter(
    families.ROLLOUT_SKIPPED,
    "Retrain recommendations the rollout manager did NOT act on, by "
    "reason: 'busy' (a cycle is already running), 'no_spare_replica' "
    "(draining one would leave nothing serving -- the loop never trades "
    "availability for freshness).",
    ("reason",),
)
ROLLOUT_RETRAIN_CANCELS = REGISTRY.counter(
    families.ROLLOUT_RETRAIN_CANCELS,
    "RETRAINING stages the manager actively cancelled after they blew "
    "RolloutConfig.retrain_timeout_s (cooperative cancel flag threaded "
    "through workflows/retraining -- the job stops, not just the wait).",
)

# -- model zoo + statistical multiplexing (serving/zoo.py) -------------------

ZOO_MODELS = REGISTRY.gauge(
    families.ZOO_MODELS,
    "Model-zoo entries this server holds (1 = the legacy single-model "
    "server; the default binary segmenter is always one of them).",
)
MODEL_ARRIVAL_RATE = REGISTRY.gauge(
    families.MODEL_ARRIVAL_RATE,
    "Mean per-model arrival rate (frames/sec) over the ZooPlacer's "
    "sliding rate window -- the statistical-multiplexing placement "
    "signal, and the capacity planner's per-model demand input.",
    ("model",),
)
MODEL_CHIPS = REGISTRY.gauge(
    families.MODEL_CHIPS,
    "Mesh chips each zoo model is currently placed on (AlpaServe-style "
    "shared placement co-locates anti-correlated models, so the per-"
    "model counts sum to MORE than the mesh width under multiplexing; "
    "a dedicated partition sums exactly to it).",
    ("model",),
)
MODEL_DISPATCHES = REGISTRY.counter(
    families.MODEL_DISPATCHES,
    "Batched dispatches launched per zoo model (each dispatch carries "
    "exactly one model's frames).",
    ("model",),
)
ZOO_REBALANCES = REGISTRY.counter(
    families.ZOO_REBALANCES,
    "ZooPlacer re-placements that CHANGED the model->chips assignment "
    "(recomputed every ServerConfig.zoo_rebalance_s from the measured "
    "per-model rate correlations).",
)
MODEL_ANOMALY_SCORE = REGISTRY.histogram(
    families.MODEL_ANOMALY_SCORE,
    "Per-frame defect/anomaly score from the aux head (1 - 2 * "
    "confidence margin: 0 = the model is saturated-confident, 1 = every "
    "pixel sits on the decision boundary -- the model has never seen "
    "anything like this frame).",
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
)

# -- host-path ingest (serving/ingest.py) ------------------------------------

DECODE_SECONDS = REGISTRY.histogram(
    families.DECODE_SECONDS,
    "Actual per-frame image-decode work (wherever it ran: decode worker "
    "or inline handler thread), by wire payload format (encoded = "
    "JPEG/PNG imdecode, raw = zero-copy frombuffer view, coef = "
    "split-decode coefficient unpack -- frombuffer views only, the "
    "pixel half runs on-device, mixed).",
    ("format",),
)
DECODE_QUEUE_DEPTH = REGISTRY.gauge(
    families.DECODE_QUEUE_DEPTH,
    "Frames waiting in the decode worker pool's queue (0 with inline "
    "decode, ServerConfig.decode_workers = 0).",
)
GEOMETRY_CACHE_HITS = REGISTRY.counter(
    families.GEOMETRY_CACHE_HITS,
    "Frames whose camera geometry (intrinsics + depth scale) was served "
    "from the per-stream geometry cache -- no per-frame float32 "
    "conversion, no re-staging.",
)
GEOMETRY_CACHE_MISSES = REGISTRY.counter(
    families.GEOMETRY_CACHE_MISSES,
    "Geometry-cache misses (first sight of an intrinsics content / "
    "frame geometry / depth-scale combination; a stream changing "
    "intrinsics mid-stream misses into a fresh entry).",
)
HOST_STAGE_SPLIT = REGISTRY.histogram(
    families.HOST_STAGE_SPLIT,
    "Per-frame host/device split the --host-profile bench reads: decode "
    "(actual decode work), entropy (split-decode host half: coefficient "
    "unpack or host entropy decode, observed alongside decode for "
    "format=coef frames), admit (submit to collected), stage_host "
    "(pooled-buffer fill), h2d (explicit device_put staging), launch "
    "(async jit dispatch), device (launch to completer pop), d2h "
    "(blocking host fetch + fan-out), encode (response mask encode).",
    ("stage",),
)

# -- host-path egress (serving/egress.py) ------------------------------------

ENCODE_SECONDS = REGISTRY.histogram(
    families.ENCODE_SECONDS,
    "Actual per-frame response-mask encode work (wherever it ran: "
    "encode worker or inline handler thread), by response wire format "
    "(png = legacy cv2.imencode, bits = packed-bits header+rows, rle = "
    "run-length).",
    ("format",),
)
EGRESS_BYTES = REGISTRY.counter(
    families.EGRESS_BYTES,
    "Response mask payload bytes put on the wire, by mask_format "
    "(png/bits/rle) -- the fleet-wide relay-bandwidth meter the packed "
    "formats exist to shrink.",
    ("format",),
)
EGRESS_QUEUE_DEPTH = REGISTRY.gauge(
    families.EGRESS_QUEUE_DEPTH,
    "Frames waiting in the encode worker pool's queue (0 with inline "
    "encode, ServerConfig.egress_workers = 0).",
)
EGRESS_POOL_SIZE = REGISTRY.gauge(
    families.EGRESS_POOL_SIZE,
    "Free pooled egress staging buffers (packed-dispatch D2H landing "
    "rows) across all payload shapes; capped like the batch staging "
    "pool, sustained shrink means lost PackedResult releases.",
)

# -- batching ----------------------------------------------------------------

BATCH_QUEUE_DEPTH = REGISTRY.gauge(
    families.BATCH_QUEUE_DEPTH,
    "Frames waiting in the batch dispatcher's collector queue.",
)
BATCH_SIZE = REGISTRY.histogram(
    families.BATCH_SIZE,
    "Frames coalesced into one batched device dispatch.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
WATCHDOG_RESTARTS = REGISTRY.counter(
    families.WATCHDOG_RESTARTS,
    "Times the watchdog restarted a dead batch collector/completer thread.",
)
INFLIGHT_DISPATCHES = REGISTRY.gauge(
    families.INFLIGHT_DISPATCHES,
    "Batched dispatches launched on the device but not yet completed "
    "(bounded by ServerConfig.max_inflight_dispatches / RDP_INFLIGHT).",
)
DISPATCH_OVERLAP = REGISTRY.histogram(
    families.DISPATCH_OVERLAP,
    "Per-dispatch pipeline overlap: how long the previous dispatch was "
    "still completing (D2H + fan-out) after this one had already "
    "launched. Identically 0 in serial mode (max_inflight_dispatches=1).",
)
BATCH_STAGE_LATENCY = REGISTRY.histogram(
    families.BATCH_STAGE_LATENCY,
    "Pipelined dispatcher stage latency: stage (host buffer fill + H2D), "
    "launch (async jit dispatch), complete (blocking D2H + fan-out).",
    ("stage",),
)
SERVING_CHIPS = REGISTRY.gauge(
    families.SERVING_CHIPS,
    "Mesh chips the batch dispatcher routes dispatches across (1 = "
    "single-device dispatch).",
)
CHIP_DISPATCHES = REGISTRY.counter(
    families.CHIP_DISPATCHES,
    "Batched dispatches launched, by mesh chip (chip '0' covers the "
    "single-device and data-sharded windows); the per-chip counts sum "
    "to the dispatcher's total.",
    ("chip",),
)
CHIP_FRAMES = REGISTRY.counter(
    families.CHIP_FRAMES,
    "Frames carried by launched dispatches, by mesh chip (padding rows "
    "excluded).",
    ("chip",),
)
CHIP_INFLIGHT = REGISTRY.gauge(
    families.CHIP_INFLIGHT,
    "Launched-but-not-completed dispatches per mesh chip; each chip's "
    "window is independently bounded by max_inflight_dispatches.",
    ("chip",),
)
BATCH_POOL_SIZE = REGISTRY.gauge(
    families.BATCH_POOL_SIZE,
    "Free pooled host staging buffer sets across all bucket keys "
    "(capped per key at max_inflight * chips + 1; sustained growth "
    "here means a leak).",
)

# -- overload control (serving/admission.py + serving/controller.py) ---------

SHED_BY_DEADLINE = REGISTRY.counter(
    families.SHED_BY_DEADLINE,
    "Frames shed by deadline-aware admission, by shed point: 'evicted' "
    "(lost its backlog slot to a newer frame with more headroom), "
    "'stale' (deadline unmeetable given the per-frame service-time "
    "estimate; dropped before staging), 'abandoned' (submitter timed "
    "out before the collector reached the frame).",
    ("point",),
)
CONTROLLER_LEVEL = REGISTRY.gauge(
    families.CONTROLLER_LEVEL,
    "Reactive controller brownout ladder position: 0 normal, 1 batch "
    "window shrunk + in-flight window halved, 2 shedding earlier at "
    "admission, 3 refusing new streams.",
)
CONTROLLER_INFLIGHT = REGISTRY.gauge(
    families.CONTROLLER_INFLIGHT,
    "The in-flight-dispatch cap as currently tuned by the reactive "
    "controller (AIMD around ServerConfig.max_inflight_dispatches).",
)
CONTROLLER_WINDOW_MS = REGISTRY.gauge(
    families.CONTROLLER_WINDOW_MS,
    "The batch window as currently tuned by the reactive controller.",
)
CONTROLLER_ACTIONS = REGISTRY.counter(
    families.CONTROLLER_ACTIONS,
    "Reactive controller actions taken, by action (inflight_up, "
    "inflight_down, window_down, window_up, admission_tighten, "
    "admission_relax, refuse_streams, accept_streams, floor_up, "
    "floor_down, mode_sharded, mode_round_robin).",
    ("action",),
)

# -- chip quarantine (serving/batching.DeviceRouter) -------------------------

QUARANTINED_CHIPS = REGISTRY.gauge(
    families.QUARANTINED_CHIPS,
    "Mesh chips currently quarantined (removed from the dispatch ring "
    "by their per-chip circuit breaker; reinstated via half-open probe "
    "dispatches).",
)
CHIP_QUARANTINES = REGISTRY.counter(
    families.CHIP_QUARANTINES,
    "Times each mesh chip entered quarantine.",
    ("chip",),
)
CHIP_FAILOVER_FRAMES = REGISTRY.counter(
    families.CHIP_FAILOVER_FRAMES,
    "Frames requeued onto healthy chips after their dispatch failed on "
    "a quarantining chip (each bounded to chips+1 attempts).",
)

# -- serving fleet (serving/fleet.py + serving/frontend.py) ------------------

FLEET_REPLICAS_LIVE = REGISTRY.gauge(
    families.FLEET_REPLICAS_LIVE,
    "Replica servers currently placeable by the fleet front-end (health "
    "SERVING and replica breaker closed).",
)
FLEET_REPLICAS_QUARANTINED = REGISTRY.gauge(
    families.FLEET_REPLICAS_QUARANTINED,
    "Replicas held out of the placement ring by an open/half-open "
    "per-replica circuit breaker while their health endpoint still "
    "answers (stream-level failures quarantine faster than the health "
    "poll notices).",
)
FLEET_REPLICAS_DRAINING = REGISTRY.gauge(
    families.FLEET_REPLICAS_DRAINING,
    "Replicas reporting draining=true over the stats RPC: held out of "
    "NEW-stream placement while still healthy (graceful drain -- "
    "in-flight streams finish normally, nothing fails over), e.g. a "
    "rollout cycle borrowing the replica's chips for retraining.",
)
FLEET_REPLICA_STREAMS = REGISTRY.gauge(
    families.FLEET_REPLICA_STREAMS,
    "Client streams the front-end currently has placed on each replica "
    "(the least-loaded pick's signal).",
    ("replica",),
)
FLEET_REPLICA_FRAMES = REGISTRY.counter(
    families.FLEET_REPLICA_FRAMES,
    "Frames relayed through each replica by the fleet front-end.",
    ("replica",),
)
FLEET_REPLICA_BURN = REGISTRY.gauge(
    families.FLEET_REPLICA_BURN,
    "Each replica's rdp_slo_error_budget_burn as last scraped over the "
    "replica stats RPC -- the fleet controller's rebalance signal.",
    ("replica",),
)
FLEET_REPLICA_WEIGHT = REGISTRY.gauge(
    families.FLEET_REPLICA_WEIGHT,
    "Fleet-controller placement weight per replica (1.0 = full share; "
    "burning replicas decay toward ServerConfig.fleet_weight_floor).",
    ("replica",),
)
FLEET_PLACEMENTS = REGISTRY.counter(
    families.FLEET_PLACEMENTS,
    "New-stream placement decisions, by chosen replica.",
    ("replica",),
)
FLEET_FAILOVERS = REGISTRY.counter(
    families.FLEET_FAILOVERS,
    "Stream-level replica failures the front-end handled (the stream was "
    "re-routed to another replica or its in-flight frames were "
    "error-completed).",
)
FLEET_FAILOVER_FRAMES = REGISTRY.counter(
    families.FLEET_FAILOVER_FRAMES,
    "In-flight frames on a dead replica, by outcome: 'rerouted' (re-sent "
    "to a healthy replica under the caller's deadline) or "
    "'error_completed' (answered with an ERROR status -- never silently "
    "dropped).",
    ("outcome",),
)
FLEET_CONTROLLER_ACTIONS = REGISTRY.counter(
    families.FLEET_CONTROLLER_ACTIONS,
    "Fleet controller weight rebalances, by action (deweight, reweight).",
    ("action",),
)

# -- elastic membership (serving/fleet.py lease registry) --------------------

FLEET_LEASE_MEMBERS = REGISTRY.gauge(
    families.FLEET_LEASE_MEMBERS,
    "Membership leases the front-end's registry currently holds, by "
    "lease state (active / expired / left). Static RDP_FLEET_REPLICAS "
    "seeds never appear here.",
    ("state",),
)
FLEET_LEASE_TRANSITIONS = REGISTRY.counter(
    families.FLEET_LEASE_TRANSITIONS,
    "Lease state-machine transitions, by destination state (expired = "
    "missed TTL renewals, the breaker drop-out path; left = graceful "
    "Leave, the drain path; active = re-register after either).",
    ("state",),
)
FLEET_LEASE_REGISTRATIONS = REGISTRY.counter(
    families.FLEET_LEASE_REGISTRATIONS,
    "Register RPCs accepted (fresh endpoints and re-registrations of "
    "expired/left/double-registered ones).",
)
FLEET_LEASE_RENEWALS = REGISTRY.counter(
    families.FLEET_LEASE_RENEWALS,
    "Renew RPCs that extended an active lease (a renew that loses the "
    "race with expiry is refused and counts as an expiry, not here).",
)
FLEET_LEASE_EXPIRIES = REGISTRY.counter(
    families.FLEET_LEASE_EXPIRIES,
    "Leases the TTL sweep expired (member stopped renewing: SIGKILL, "
    "partition, or wedged renew loop).",
)

# -- capacity planner / autoscaler (serving/planner.py) ----------------------

PLANNER_PLANS = REGISTRY.counter(
    families.PLANNER_PLANS,
    "Capacity plans emitted, by the planner's recommendation relative "
    "to the current fleet (scale_up, scale_down, hold).",
    ("recommendation",),
)
PLANNER_TARGET_REPLICAS = REGISTRY.gauge(
    families.PLANNER_TARGET_REPLICAS,
    "Replica count the newest capacity plan asked for (the cheapest "
    "config meeting the SLO at the observed arrival rate).",
)
AUTOSCALER_ACTIONS = REGISTRY.counter(
    families.AUTOSCALER_ACTIONS,
    "Autoscaler actions actually taken (scale_up = spawn a "
    "self-registering replica, scale_down = drain the least-loaded "
    "member) or refused (hold_cooldown, hold_bounds, hold_sustain).",
    ("action",),
)

# -- fleet observability plane (observability/federation.py + journal.py) ----

REPLICA_UP = REGISTRY.gauge(
    families.REPLICA_UP,
    "Per-replica scrape health on the front-end's federated metrics "
    "endpoint (GET /federate): 1 = this render scraped the replica's "
    "/metrics live, 0 = unreachable (its last good families are "
    "re-served stale; see rdp_replica_scrape_age_seconds).",
    ("replica",),
)
REPLICA_SCRAPE_AGE = REGISTRY.gauge(
    families.REPLICA_SCRAPE_AGE,
    "Age of the newest /metrics+/debug/spans scrape the federator holds "
    "for each replica (staleness marker for dead or draining members; "
    "-1 = never scraped).",
    ("replica",),
)
REPLICA_DRAINING = REGISTRY.gauge(
    families.REPLICA_DRAINING,
    "Per-replica draining flag as last scraped over the stats RPC "
    "(1 = healthy but out of new-stream placement; the aggregate count "
    "is rdp_fleet_replicas_draining).",
    ("replica",),
)
FLEET_BURN = REGISTRY.gauge(
    families.FLEET_BURN,
    "Fleet-level error-budget burn roll-up over the live replicas' "
    "scraped rdp_slo_error_budget_burn readings (stat = mean, max) -- "
    "the capacity planner's aggregate demand-vs-capacity signal.",
    ("stat",),
)
FLEET_FRAMES = REGISTRY.gauge(
    families.FLEET_FRAMES,
    "Total frames served across the fleet (sum of each replica's "
    "frames_total as last scraped over the stats RPC).",
)
FLEET_MODEL_ARRIVAL_RATE = REGISTRY.gauge(
    families.FLEET_MODEL_ARRIVAL_RATE,
    "Per-model arrival rate summed across replicas (frames/sec over "
    "each replica's ZooPlacer rate window) -- the capacity planner's "
    "fleet-wide per-model demand input.",
    ("model",),
)
JOURNAL_EVENTS = REGISTRY.counter(
    families.JOURNAL_EVENTS,
    "Structured events appended to the observability journal "
    "(GET /debug/events), by kind -- the full vocabulary is "
    "observability/events.py (events.ALL_KINDS).",
    ("kind",),
)
JOURNAL_DROPPED = REGISTRY.counter(
    families.JOURNAL_DROPPED,
    "Events the bounded journal ring evicted to make room (a consumer "
    "tailing /debug/events?since= sees the gap as a non-zero 'dropped' "
    "field; size the ring with RDP_JOURNAL_RING).",
)
JOURNAL_PERSISTED = REGISTRY.counter(
    families.JOURNAL_PERSISTED,
    "Events appended to the RDP_JOURNAL_PATH JSONL file (the SIGKILL "
    "post-mortem record; rotation bounded by "
    "RDP_JOURNAL_ROTATE_BYTES).",
)
JOURNAL_PERSIST_ERRORS = REGISTRY.counter(
    families.JOURNAL_PERSIST_ERRORS,
    "Journal file appends that failed (persistence is best-effort: the "
    "in-memory ring and /debug/events stay authoritative).",
)

# -- resilience --------------------------------------------------------------

#: closed=0 / open=1 / half_open=2 (alert on `rdp_breaker_state == 1`).
BREAKER_STATE = REGISTRY.gauge(
    families.BREAKER_STATE,
    "Circuit breaker state: 0 closed, 1 open, 2 half-open.",
    ("breaker",),
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    families.BREAKER_TRANSITIONS,
    "Circuit breaker state transitions, by destination state.",
    ("breaker", "to"),
)
RETRIES = REGISTRY.counter(
    families.RETRIES,
    "Retry attempts (attempt N+1 scheduled after a transient failure), "
    "by call site.",
    ("site",),
)

# -- tracking ----------------------------------------------------------------

HTTP_REQUESTS = REGISTRY.histogram(
    families.HTTP_REQUESTS,
    "Tracking/registry HTTP round-trip latency, by outcome (one sample "
    "per attempt, retries included).",
    ("outcome",),
)

# -- training ----------------------------------------------------------------

TRAIN_STEP = REGISTRY.histogram(
    families.TRAIN_STEP,
    "Mean optimizer-step wall time, observed once per epoch (whole-epoch "
    "scan dispatches have no per-step boundary to time).",
)
TRAIN_RATE = REGISTRY.gauge(
    families.TRAIN_RATE,
    "Training throughput over the last epoch's train phase.",
)

_BREAKER_STATE_VALUES = {"closed": 0, "open": 1, "half_open": 2}


def _on_breaker_transition(name: str, old: str | None, new: str) -> None:
    BREAKER_STATE.labels(breaker=name).set(
        _BREAKER_STATE_VALUES.get(new, -1)
    )
    if old is not None:  # creation announces state without a transition
        BREAKER_TRANSITIONS.labels(breaker=name, to=new).inc()
        # every breaker transition (registry, per-chip quarantine,
        # per-replica fleet quarantine) is a journal event: an open
        # breaker IS the quarantine record incident reconstruction reads
        journal_lib.JOURNAL.append(
            events.BREAKER_TRANSITION, breaker=name, frm=old, to=new)


def _on_retry(site: str | None, attempt: int) -> None:
    RETRIES.labels(site=site or "unnamed").inc()


def install_resilience_hooks() -> None:
    from robotic_discovery_platform_tpu_torch.resilience import breaker, policy

    breaker.set_observer(_on_breaker_transition)
    policy.set_retry_observer(_on_retry)


def install_journal_hooks() -> None:
    """Route the journal's per-event counting into the registry (the
    journal stays import-clean of it, same pattern as resilience)."""
    journal_lib.set_observer(
        lambda kind: JOURNAL_EVENTS.labels(kind=kind).inc(),
        lambda n: JOURNAL_DROPPED.inc(n),
    )
    journal_lib.set_persist_observer(
        lambda n: JOURNAL_PERSISTED.inc(n),
        lambda n: JOURNAL_PERSIST_ERRORS.inc(n),
    )


install_resilience_hooks()
install_journal_hooks()
