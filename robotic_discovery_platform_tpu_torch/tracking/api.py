"""MLflow-shaped tracking API: the JAX package's ``tracking/api.py``.

``set_tracking_uri`` / ``set_experiment`` / ``start_run`` / ``log_params``
/ ``log_metric`` for runs, ``log_model`` to save an artifact and register
a version, ``resolve_model_uri`` / ``load_model`` for
``models:/Name/latest``, ``models:/Name/3`` and ``models:/Name@alias``,
and :class:`Client` with the registry calls the reference's
``MlflowClient`` makes. Artifacts are the JAX package's format
(``models/weights.save_model``), so either package loads what the other
registered.

The tracking URI picks the store, as the JAX package's ``_make_store``
does without the ``mlflow`` client installed: ``file:`` URIs and plain
paths the file store (:class:`tracking.store.FileStore`),
``http(s)://`` and ``mlflow-rest+http(s)://`` an MLflow tracking server
over its REST API (:class:`tracking.rest_backend.RestMlflowStore`).
``mlflow+...`` and ``databricks...`` need the mlflow client, which the
port does not use: they raise the JAX package's ``ImportError``.
"""

from __future__ import annotations

import contextlib
import re
import threading
from pathlib import Path
from types import SimpleNamespace

import torch

from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.tracking.store import FileStore

_DEFAULT_URI = "file:ml/mlruns"

# process-global, as in MLflow: handler threads see the URI the main
# thread configured; guarded for concurrent mutation
_state = SimpleNamespace(uri=_DEFAULT_URI, store=None, experiment_id="0",
                         active_run=None)
_state_lock = threading.Lock()


def store_for(tracking_uri: str):
    """A store for ``tracking_uri`` that leaves the process-global tracking
    state alone (for callers that must not re-point it, such as the
    server's reload poller): a :class:`FileStore` or a
    :class:`~tracking.rest_backend.RestMlflowStore` (module docstring)."""
    scheme = tracking_uri.split(":", 1)[0]
    if tracking_uri.startswith("mlflow-rest+"):
        from robotic_discovery_platform_tpu_torch.tracking.rest_backend import (
            RestMlflowStore,
        )

        return RestMlflowStore(tracking_uri[len("mlflow-rest+"):])
    if scheme in ("http", "https"):
        from robotic_discovery_platform_tpu_torch.tracking.rest_backend import (
            RestMlflowStore,
        )

        return RestMlflowStore(tracking_uri)
    _refuse_mlflow_client(tracking_uri)
    return FileStore(tracking_uri)


def _refuse_mlflow_client(uri: str) -> None:
    """A URI that needs the mlflow client raises the JAX package's
    ``ImportError`` for a missing client."""
    if uri.startswith(("databricks", "mlflow+")):
        raise ImportError(
            "the real-MLflow tracking backend needs the 'mlflow' extra (pip "
            "install robotic-discovery-platform-tpu[mlflow]); the default "
            "file: backend has no such dependency"
        )


def set_tracking_uri(uri: str) -> None:
    _refuse_mlflow_client(uri)  # now, not at first use
    with _state_lock:
        _state.uri = uri
        _state.store = None


def get_tracking_uri() -> str:
    return _state.uri


def _store():
    with _state_lock:
        if _state.store is None:
            _state.store = store_for(_state.uri)
        return _state.store


def set_experiment(name: str) -> str:
    _state.experiment_id = _store().get_or_create_experiment(name)
    return _state.experiment_id


class ActiveRun:
    """Mimics ``mlflow.ActiveRun``: has ``.info.run_id``."""

    class _Info:
        def __init__(self, run_id: str):
            self.run_id = run_id

    def __init__(self, run_id: str):
        self.info = self._Info(run_id)


@contextlib.contextmanager
def start_run(run_name: str | None = None):
    """A run of the current experiment, ended FINISHED on a clean exit and
    FAILED when the block raises."""
    run_id = _store().create_run(_state.experiment_id, run_name)
    _state.active_run = ActiveRun(run_id)
    try:
        yield _state.active_run
        _store().end_run(run_id, "FINISHED")
    except Exception:
        _store().end_run(run_id, "FAILED")
        raise
    finally:
        _state.active_run = None


def active_run() -> ActiveRun | None:
    return _state.active_run


def _require_run() -> str:
    run = active_run()
    if run is None:
        raise RuntimeError("no active run; wrap calls in tracking.start_run()")
    return run.info.run_id


def log_params(params: dict) -> None:
    _store().log_params(_require_run(), params)


def log_param(key: str, value) -> None:
    log_params({key: value})


def log_metric(key: str, value: float, step: int | None = None) -> None:
    _store().log_metric(_require_run(), key, value, step)


def log_metrics(metrics: dict, step: int | None = None) -> None:
    for k, v in metrics.items():
        log_metric(k, v, step)


def get_metric_history(run_id: str, key: str) -> list[dict]:
    return _store().get_metric_history(run_id, key)


def log_model(variables: dict, model_cfg, artifact_path: str = "model",
              registered_model_name: str | None = None) -> int | None:
    """Save a Flax variable tree (numpy leaves) under the active run's
    artifacts (a remote store stages them locally, then uploads them to
    the run) and, given a name, register it as a new version; returns
    that version."""
    run_id = _require_run()
    store = _store()
    dest = weights.save_model(variables, model_cfg,
                              store.artifact_dir(run_id) / artifact_path)
    if hasattr(store, "publish_artifacts"):
        store.publish_artifacts(run_id, dest)
    if registered_model_name is None:
        return None
    return store.create_model_version(registered_model_name, run_id, dest)


_MODEL_URI = re.compile(
    r"^models:/(?P<name>[^/@]+)(?:/(?P<version>latest|\d+)|@(?P<alias>[\w-]+))?$"
)


def resolve_model_uri(uri: str, store=None) -> Path:
    """``models:/Name/latest`` | ``models:/Name/3`` | ``models:/Name@alias``
    -> the registered artifact directory. ``store`` defaults to the
    process-global one."""
    m = _MODEL_URI.match(uri)
    if not m:
        raise ValueError(f"unsupported model uri: {uri!r}")
    name = m.group("name")
    store = _store() if store is None else store
    if m.group("alias"):
        version = store.get_alias(name, m.group("alias"))
        if version is None:
            raise KeyError(f"model {name!r} has no alias {m.group('alias')!r}")
    elif m.group("version") and m.group("version") != "latest":
        version = int(m.group("version"))
    else:
        version = store.latest_version(name)["version"]
    return store.version_path(name, version)


def load_model(uri: str, store=None,
               device: str | torch.device = "cuda"):
    """``(ModelConfig, UNet)`` from a ``models:/`` uri or an artifact
    directory, the module on ``device`` in eval mode."""
    path = (resolve_model_uri(uri, store) if uri.startswith("models:/")
            else Path(uri))
    return weights.load_model_dir(path, device=device)


class ModelVersionInfo:
    """Mimics mlflow's ModelVersion for the fields the reference reads
    (``.version``)."""

    def __init__(self, name: str, version: int, run_id: str | None):
        self.name = name
        self.version = version
        self.run_id = run_id


class Client:
    """Registry client with the reference's ``MlflowClient`` call shapes,
    on the process-global store."""

    def get_latest_versions(self, name: str,
                            stages=None) -> list[ModelVersionInfo]:
        """MLflow semantics: the latest version per requested stage. A
        version's stage is "None" unless its record carries another (the
        reference promotes through aliases, so stages stay "None")."""
        if stages is None:
            v = _store().latest_version(name)
            return [ModelVersionInfo(name, v["version"], v.get("run_id"))]
        versions = _store().list_model_versions(name)
        if not versions:
            raise KeyError(f"registered model {name!r} has no versions")
        out = []
        for stage in stages:
            staged = [v for v in versions if v.get("stage", "None") == stage]
            if staged:
                v = max(staged, key=lambda v: v["version"])
                out.append(ModelVersionInfo(name, v["version"],
                                            v.get("run_id")))
        return out

    def set_registered_model_alias(self, name: str, alias: str,
                                   version) -> None:
        _store().set_alias(name, alias, int(version))

    def get_model_version_by_alias(self, name: str,
                                   alias: str) -> ModelVersionInfo:
        version = _store().get_alias(name, alias)
        if version is None:
            raise KeyError(f"model {name!r} has no alias {alias!r}")
        return ModelVersionInfo(name, version, None)

    def list_versions(self, name: str) -> list[dict]:
        return _store().list_model_versions(name)
