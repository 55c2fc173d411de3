"""The drift-triggered retraining pipeline (the JAX package's
``workflows/retraining.py``: capture a drift profile, retrain, register,
move the ``staging`` alias) is not ported: ROADMAP queue 1 item 13. It
needs the drift monitor (``monitoring/profile.py``) and observability.
``training.trainer.train_model`` registers a version, and
``tracking.store_for(uri).set_alias(name, "staging", version)`` points a
server at it.
"""

from __future__ import annotations

_MESSAGE = ("the retraining workflow is ROADMAP queue 1 item 13 (it needs "
            "the drift monitor); use train_model and set the staging alias")


def capture_drift_profile(*args, **kwargs):
    raise NotImplementedError(_MESSAGE)


def run_retraining_pipeline(*args, **kwargs):
    raise NotImplementedError(_MESSAGE)


def run_if_drifted(*args, **kwargs):
    raise NotImplementedError(_MESSAGE)
