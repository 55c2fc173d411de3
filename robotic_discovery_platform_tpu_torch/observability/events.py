"""Central registry of journal event kinds.

One constant per structured-event kind the platform appends to the
:mod:`robotic_discovery_platform_tpu_torch.observability.journal` ring. The
instrumentation convention says every control-plane state
change both bumps its counter and journals an event; this module is the
vocabulary of those events, the single source of truth
``tools/fleet_obs_smoke.py`` asserts against and statecheck's SC004
lints against: a string-literal kind used anywhere else in the package
that is absent here is operational-surface drift (an event no
incident-reconstruction query can have heard of). Import the constant,
never retype the string.

Zero imports on purpose: the journal itself stays import-light, and so
must its vocabulary.
"""

from __future__ import annotations

# -- resilience --------------------------------------------------------------

#: a circuit breaker changed state (registry, per-chip, per-replica);
#: emitted by the observer hook instruments.py installs
BREAKER_TRANSITION = "breaker.transition"

# -- serving control plane ---------------------------------------------------

#: the reactive controller applied a knob action (window_down,
#: admission_tighten, refuse_streams, ...)
CONTROLLER_ACTION = "controller.action"
#: the reactive controller's brownout level moved (0..3)
CONTROLLER_LEVEL = "controller.level"
#: the rollout state machine moved (idle -> draining -> ... -> idle)
ROLLOUT_TRANSITION = "rollout.transition"
#: a RETRAINING stage blew its timeout and the manager actively
#: cancelled the training job (cooperative cancel flag)
ROLLOUT_RETRAIN_CANCEL = "rollout.retrain_cancel"
#: a chip's quarantine breaker opened: the chip left the dispatch ring
CHIP_QUARANTINE = "chip.quarantine"
#: a quarantined chip's half-open probe succeeded: back in the ring
CHIP_REINSTATE = "chip.reinstate"
#: the dispatcher watchdog restarted a dead collector/completer stage
WATCHDOG_RESTART = "watchdog.restart"
#: the zoo placer moved chip assignments between models
ZOO_REBALANCE = "zoo.rebalance"

# -- fleet -------------------------------------------------------------------

#: a pinned stream failed over to another replica mid-flight
FLEET_FAILOVER = "fleet.failover"
#: a replica entered or left NEW-stream placement (health/breaker)
FLEET_MEMBERSHIP = "fleet.membership"
#: a replica's graceful-drain flag flipped (stays healthy, leaves
#: placement)
FLEET_DRAIN = "fleet.drain"
#: a membership lease moved (register / renew-refused / active ->
#: expired / active -> left) -- the elastic fleet's join/leave record
FLEET_LEASE = "fleet.lease"
#: the capacity planner emitted a (replicas, chips, precision,
#: dispatch-mode, window) plan for the current demand
PLANNER_PLAN = "planner.plan"
#: the autoscaler acted on a plan (scale_up / scale_down) or refused to
#: (cooldown, bounds)
AUTOSCALER_ACTION = "autoscaler.action"

# -- lifecycle / drift -------------------------------------------------------

#: the drift monitor fired a sustained retrain recommendation
DRIFT_RECOMMENDATION = "drift.recommendation"
#: the server finished warm-up and entered the serving state
SERVER_READY = "server.ready"
#: the server began graceful drain (SIGTERM / stop())
SERVER_DRAIN = "server.drain"

#: every kind above -- the journal's whole vocabulary
ALL_KINDS = tuple(
    v for k, v in sorted(globals().items())
    if k.isupper() and isinstance(v, str)
)
