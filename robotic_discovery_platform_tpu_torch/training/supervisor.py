"""Supervised, preemption-tolerant training (the JAX package's
``training/supervisor.py``: ``train_model`` in a child process, relaunched
with ``resume=True`` when it dies) is not ported: ROADMAP queue 1 item 13.
``train_model(resume=True)`` resumes from the latest checkpoint by hand.
"""

from __future__ import annotations


def run_supervised(*args, **kwargs):
    raise NotImplementedError(
        "run_supervised (the restarting training supervisor) is ROADMAP "
        "queue 1 item 13; call train_model(..., resume=True) instead"
    )
