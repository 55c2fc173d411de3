"""Uniform logging setup.

Every reference entry point repeats the same ``logging.basicConfig`` idiom
(server.py:56, client.py:78, train_segmenter.py:107, retraining_pipeline.py:46,
drift_detector.py:28, 01_calibrate_camera.py:39); here it is once -- plus
trace correlation: every record carries ``%(trace_id)s`` (the current
observability span's W3C trace ID, or "-" outside any span), so one grep
follows a frame across the client and server processes.
"""

from __future__ import annotations

import logging

_FORMAT = (
    "%(asctime)s - %(name)s - %(levelname)s - [trace=%(trace_id)s] "
    "%(message)s"
)


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    # record-factory install, not a handler filter: the trace_id attribute
    # must exist on records no matter which handler formats them (ours,
    # pytest's caplog, a user's). Lazy import; observability.trace is
    # stdlib-only and imports nothing back from utils.
    from robotic_discovery_platform_tpu_torch.observability.trace import (
        install_log_correlation,
    )

    install_log_correlation()
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=level, format=_FORMAT)
    logger = logging.getLogger(name)
    logger.setLevel(level)
    return logger
