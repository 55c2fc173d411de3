"""Experiment tracking and the model registry: a file store, or an MLflow
tracking server over its REST API."""

from robotic_discovery_platform_tpu_torch.tracking.api import (
    ActiveRun,
    Client,
    ModelVersionInfo,
    active_run,
    get_metric_history,
    get_tracking_uri,
    load_model,
    log_metric,
    log_metrics,
    log_model,
    log_param,
    log_params,
    resolve_model_uri,
    set_experiment,
    set_tracking_uri,
    start_run,
    store_for,
)
from robotic_discovery_platform_tpu_torch.tracking.store import FileStore

__all__ = [
    "ActiveRun", "Client", "FileStore", "ModelVersionInfo", "active_run", "get_metric_history",
    "get_tracking_uri", "load_model", "log_metric", "log_metrics",
    "log_model", "log_param", "log_params", "resolve_model_uri",
    "set_experiment", "set_tracking_uri", "start_run", "store_for",
]
