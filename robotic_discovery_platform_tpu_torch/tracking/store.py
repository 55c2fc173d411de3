"""File-backed experiment tracking and model registry store: the JAX
package's ``tracking/store.py``, so that both packages read and write one
store directory (runs, params, metrics, artifacts, model versions and
aliases), with the MLflow-shaped names the reference uses ("Actuator
Segmentation", "Actuator-Segmenter", train_loss/val_loss, the "staging"
alias).

Layout::

    <root>/
      experiments.json                  {name: experiment_id}
      runs/<run_id>/meta.json           run status/times/experiment
      runs/<run_id>/params.json
      runs/<run_id>/metrics/<key>.jsonl lines: {"step": s, "value": v, "ts": t}
      runs/<run_id>/artifacts/...
      registry/<model>/versions.json    [{"version": n, "run_id": ..., ...}]
      registry/<model>/aliases.json     {alias: version}
      registry/<model>/<version>/       model artifact directory
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path


def _resolve_uri(uri: str) -> Path:
    if uri.startswith("file://"):
        return Path(uri[len("file://"):])
    if uri.startswith("file:"):
        return Path(uri[len("file:"):])
    return Path(uri)


class FileStore:
    """All mutating operations are guarded by a process-local lock and use
    atomic JSON rewrites (tmp + rename); metric appends are O(1) JSONL."""

    def __init__(self, uri: str):
        self.root = _resolve_uri(uri)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    # -- json helpers -------------------------------------------------------

    def _read(self, path: Path, default):
        try:
            return json.loads(path.read_text())
        except FileNotFoundError:
            return default

    def _write(self, path: Path, obj) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(obj, indent=2, sort_keys=True))
        tmp.replace(path)

    # -- experiments --------------------------------------------------------

    def get_or_create_experiment(self, name: str) -> str:
        with self._lock:
            path = self.root / "experiments.json"
            exps = self._read(path, {})
            if name not in exps:
                exps[name] = str(len(exps))
                self._write(path, exps)
            return exps[name]

    def list_experiments(self) -> dict:
        return dict(self._read(self.root / "experiments.json", {}))

    # -- runs ---------------------------------------------------------------

    def _run_dir(self, run_id: str) -> Path:
        return self.root / "runs" / run_id

    def create_run(self, experiment_id: str, run_name: str | None = None) -> str:
        run_id = uuid.uuid4().hex
        meta = {
            "run_id": run_id,
            "run_name": run_name or run_id[:8],
            "experiment_id": experiment_id,
            "status": "RUNNING",
            "start_time": time.time(),
            "end_time": None,
        }
        with self._lock:
            self._write(self._run_dir(run_id) / "meta.json", meta)
        return run_id

    def end_run(self, run_id: str, status: str = "FINISHED") -> None:
        with self._lock:
            path = self._run_dir(run_id) / "meta.json"
            meta = self._read(path, {})
            meta.update(status=status, end_time=time.time())
            self._write(path, meta)

    def get_run(self, run_id: str) -> dict:
        meta = self._read(self._run_dir(run_id) / "meta.json", None)
        if meta is None:
            raise KeyError(f"no such run: {run_id}")
        return meta

    def log_params(self, run_id: str, params: dict) -> None:
        with self._lock:
            path = self._run_dir(run_id) / "params.json"
            cur = self._read(path, {})
            cur.update({k: str(v) for k, v in params.items()})
            self._write(path, cur)

    def get_params(self, run_id: str) -> dict:
        return self._read(self._run_dir(run_id) / "params.json", {})

    def log_metric(self, run_id: str, key: str, value: float,
                   step: int | None = None) -> None:
        path = self._run_dir(run_id) / "metrics" / f"{key}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps(
            {"step": step, "value": float(value), "ts": time.time()}
        )
        with self._lock, open(path, "a") as f:
            f.write(line + "\n")

    def get_metric_history(self, run_id: str, key: str) -> list[dict]:
        path = self._run_dir(run_id) / "metrics" / f"{key}.jsonl"
        try:
            return [json.loads(l) for l in path.read_text().splitlines() if l]
        except FileNotFoundError:
            return []

    def artifact_dir(self, run_id: str) -> Path:
        d = self._run_dir(run_id) / "artifacts"
        d.mkdir(parents=True, exist_ok=True)
        return d

    # -- model registry -----------------------------------------------------

    def _model_dir(self, name: str) -> Path:
        return self.root / "registry" / name

    def create_model_version(self, name: str, run_id: str | None,
                             source_dir: Path | None = None) -> int:
        """Register a new integer version (MLflow semantics: versions count up
        per model name, reference: workflows/retraining_pipeline.py:60-66).
        Copies ``source_dir`` into the registry as the durable artifact."""
        with self._lock:
            vpath = self._model_dir(name) / "versions.json"
            versions = self._read(vpath, [])
            version = 1 + max((v["version"] for v in versions), default=0)
            dest = self._model_dir(name) / str(version)
            if source_dir is not None:
                if dest.exists():
                    shutil.rmtree(dest)
                shutil.copytree(source_dir, dest)
            versions.append(
                {
                    "version": version,
                    "run_id": run_id,
                    "created": time.time(),
                    "path": str(dest),
                }
            )
            self._write(vpath, versions)
            return version

    def list_model_versions(self, name: str) -> list[dict]:
        return self._read(self._model_dir(name) / "versions.json", [])

    def latest_version(self, name: str) -> dict:
        versions = self.list_model_versions(name)
        if not versions:
            raise KeyError(f"registered model {name!r} has no versions")
        return max(versions, key=lambda v: v["version"])

    def set_alias(self, name: str, alias: str, version: int) -> None:
        """reference: workflows/retraining_pipeline.py:69-75
        (set_registered_model_alias(name, "staging", version))."""
        with self._lock:
            known = {v["version"] for v in self.list_model_versions(name)}
            if int(version) not in known:
                raise KeyError(f"model {name!r} has no version {version}")
            apath = self._model_dir(name) / "aliases.json"
            aliases = self._read(apath, {})
            aliases[alias] = int(version)
            self._write(apath, aliases)

    def get_alias(self, name: str, alias: str) -> int | None:
        aliases = self._read(self._model_dir(name) / "aliases.json", {})
        return aliases.get(alias)

    def version_path(self, name: str, version: int) -> Path:
        path = self._model_dir(name) / str(version)
        if not path.exists():
            raise KeyError(f"model {name!r} version {version} has no artifacts")
        return path
