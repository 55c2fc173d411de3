"""MLflow REST tracking and registry store over the standard library.

The JAX package's ``tracking/rest_backend.py``: the same store surface as
:class:`tracking.store.FileStore`, spoken as MLflow's documented REST
calls (``/api/2.0/mlflow/...``, and the ``mlflow-artifacts`` proxy that
``mlflow server --serve-artifacts`` exposes for artifact upload and
download), so a trainer or a server logs to and loads from a real MLflow
tracking server with no mlflow client installed. The requests and their
bodies are the JAX store's; they go out through ``http.client`` instead
of ``requests``, one connection per request.

Every round trip passes the ``tracking.rest.request`` fault site
(``RDP_FAULTS``), lands one sample in ``rdp_http_request_seconds`` by
outcome, and retries transient failures (connection errors, timeouts, 429
and 5xx) with jittered backoff (``RDP_HTTP_RETRIES``,
``RDP_HTTP_BACKOFF_S``) inside one overall deadline per logical call
(``RDP_HTTP_DEADLINE_S``, twice the per-request timeout by default).
A failed call raises :class:`MlflowRestError` with the server's
``error_code``.

Selected by ``tracking/api`` for ``http(s)://`` and
``mlflow-rest+http(s)://`` tracking URIs.
"""

from __future__ import annotations

import http.client
import json
import os
import posixpath
import shutil
import tempfile
import time
import weakref
from pathlib import Path
from urllib.parse import quote, urlencode, urlsplit

from robotic_discovery_platform_tpu_torch.observability import (
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    Deadline,
    RetryPolicy,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_API = "/api/2.0/mlflow"
_ARTIFACTS = "/api/2.0/mlflow-artifacts/artifacts"

#: the fault site of every HTTP round trip this store makes
FAULT_SITE = fault_sites.TRACKING_REST_REQUEST


def _resolve_retry() -> RetryPolicy:
    """``RDP_HTTP_RETRIES`` / ``RDP_HTTP_BACKOFF_S``: the retry schedule of
    transient failures."""
    return RetryPolicy(
        max_attempts=int(os.environ.get("RDP_HTTP_RETRIES", "3")),
        base_delay_s=float(os.environ.get("RDP_HTTP_BACKOFF_S", "0.2")),
        max_delay_s=5.0,
    )


def _resolve_deadline_s(timeout_s: float) -> float:
    """``RDP_HTTP_DEADLINE_S``: one logical call's budget, retries
    included; twice the single-request timeout by default."""
    return float(os.environ.get("RDP_HTTP_DEADLINE_S",
                                str(2.0 * timeout_s)))


class MlflowRestError(RuntimeError):
    """An MLflow REST call failed; carries the server's ``error_code``
    and the HTTP ``status`` (which retry classification reads)."""

    def __init__(self, status: int, error_code: str, message: str):
        super().__init__(f"{error_code} (HTTP {status}): {message}")
        self.status = status
        self.error_code = error_code


class _Response:
    """What a request returned: status, body bytes, and the body as JSON
    (``{}`` for an empty body)."""

    def __init__(self, status: int, content: bytes):
        self.status_code = status
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content) if self.content else {}


class RestMlflowStore:
    """FileStore-protocol adapter speaking MLflow's REST API directly."""

    def __init__(self, uri: str, timeout_s: float = 30.0,
                 retry: RetryPolicy | None = None,
                 deadline_s: float | None = None):
        self.uri = uri.rstrip("/")
        parts = urlsplit(self.uri)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) tracking URI: {uri!r}")
        self._scheme, self._netloc = parts.scheme, parts.netloc
        self._prefix = parts.path.rstrip("/")
        self.timeout_s = timeout_s
        # timeout_s bounds one request; deadline_s one logical call with
        # its retries, so a flaky server cannot stretch a call to
        # retries x timeout
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _resolve_deadline_s(timeout_s))
        self._retry = retry if retry is not None else _resolve_retry()
        self._make_scratch()

    def _make_scratch(self) -> None:
        self._scratch = Path(tempfile.mkdtemp(prefix="rdp-mlflow-rest-"))
        self._cleanup = weakref.finalize(
            self, shutil.rmtree, str(self._scratch), True)

    def _ensure_scratch(self) -> Path:
        if not self._scratch.exists():
            self._make_scratch()
        return self._scratch

    def close(self) -> None:
        """Remove the artifact staging directory; the store stays usable
        (the directory is made again when needed)."""
        self._cleanup()

    # -- transport ----------------------------------------------------------

    def _request(self, method: str, path: str, *, params=None,
                 body: bytes | None = None,
                 content_type: str | None = None) -> _Response:
        """One HTTP request on a fresh connection."""
        target = self._prefix + path
        if params:
            target += "?" + urlencode(params)
        conn_cls = (http.client.HTTPSConnection if self._scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(self._netloc, timeout=self.timeout_s)
        try:
            headers = {"Accept": "application/json"}
            if content_type is not None:
                headers["Content-Type"] = content_type
            conn.request(method, target, body=body, headers=headers)
            resp = conn.getresponse()
            return _Response(resp.status, resp.read())
        finally:
            conn.close()

    def _retrying(self, what: str, fn):
        """One logical REST operation: every attempt shares a Deadline,
        transient failures back off and retry, and the error surfaces
        unchanged once the policy gives up. Every attempt lands one sample
        in ``rdp_http_request_seconds``, by outcome."""
        deadline = Deadline.after(self.deadline_s, self._retry.clock)

        def on_retry(attempt: int, exc: BaseException, delay: float):
            log.warning(
                "transient failure on %s (%s: %s); retry %d in %.2fs",
                what, type(exc).__name__, exc, attempt, delay,
            )

        def timed_attempt():
            t0 = time.perf_counter()
            try:
                out = fn()
            except BaseException:
                obs.HTTP_REQUESTS.labels(outcome="error").observe(
                    time.perf_counter() - t0)
                raise
            obs.HTTP_REQUESTS.labels(outcome="ok").observe(
                time.perf_counter() - t0)
            return out

        return self._retry.call(timed_attempt, deadline=deadline,
                                on_retry=on_retry, name=FAULT_SITE)

    def _call(self, method: str, endpoint: str, *, params=None, body=None):
        def attempt():
            inject(FAULT_SITE)
            resp = self._request(
                method, f"{_API}/{endpoint}", params=params,
                body=(None if body is None
                      else json.dumps(body, allow_nan=False).encode()),
                content_type=None if body is None else "application/json",
            )
            if resp.status_code >= 400:
                try:
                    err = resp.json()
                except ValueError:
                    err = {}
                if not isinstance(err, dict):
                    err = {}
                raise MlflowRestError(
                    resp.status_code,
                    err.get("error_code", "INTERNAL_ERROR"),
                    err.get("message", resp.text[:200]),
                )
            return resp.json()

        return self._retrying(f"{method} {endpoint}", attempt)

    # -- experiments / runs -------------------------------------------------

    def get_or_create_experiment(self, name: str) -> str:
        try:
            out = self._call("GET", "experiments/get-by-name",
                             params={"experiment_name": name})
            return out["experiment"]["experiment_id"]
        except MlflowRestError as e:
            if e.error_code != "RESOURCE_DOES_NOT_EXIST":
                raise
        return self._call("POST", "experiments/create",
                          body={"name": name})["experiment_id"]

    def create_run(self, experiment_id: str,
                   run_name: str | None = None) -> str:
        tags = ([{"key": "mlflow.runName", "value": run_name}]
                if run_name else [])
        out = self._call("POST", "runs/create", body={
            "experiment_id": experiment_id,
            "start_time": int(time.time() * 1e3),
            "tags": tags,
        })
        return out["run"]["info"]["run_id"]

    def end_run(self, run_id: str, status: str = "FINISHED") -> None:
        self._call("POST", "runs/update", body={
            "run_id": run_id, "status": status,
            "end_time": int(time.time() * 1e3),
        })

    def _get_run_raw(self, run_id: str) -> dict:
        return self._call("GET", "runs/get",
                          params={"run_id": run_id})["run"]

    def get_run(self, run_id: str) -> dict:
        """The run's meta in FileStore's key shape (times in seconds)."""
        info = self._get_run_raw(run_id)["info"]
        return {
            "run_id": run_id,
            "run_name": info.get("run_name"),
            "experiment_id": info["experiment_id"],
            "status": info.get("status"),
            "start_time": int(info.get("start_time") or 0) / 1e3,
            "end_time": (int(info["end_time"]) / 1e3
                         if info.get("end_time") else None),
        }

    # -- params / metrics ---------------------------------------------------

    def log_params(self, run_id: str, params: dict) -> None:
        self._call("POST", "runs/log-batch", body={
            "run_id": run_id,
            "params": [{"key": str(k), "value": str(v)}
                       for k, v in params.items()],
        })

    def get_params(self, run_id: str) -> dict:
        data = self._get_run_raw(run_id).get("data", {})
        return {p["key"]: p["value"] for p in data.get("params", [])}

    def log_metric(self, run_id: str, key: str, value: float,
                   step: int | None = None) -> None:
        self._call("POST", "runs/log-metric", body={
            "run_id": run_id, "key": key, "value": float(value),
            "timestamp": int(time.time() * 1e3),
            "step": 0 if step is None else int(step),
        })

    def get_metric_history(self, run_id: str, key: str) -> list[dict]:
        out = self._call("GET", "metrics/get-history",
                         params={"run_id": run_id, "metric_key": key})
        # "ts" in seconds, as FileStore.log_metric writes it
        return [
            {"step": int(m.get("step", 0)), "value": m["value"],
             "ts": int(m.get("timestamp", 0)) / 1e3}
            for m in out.get("metrics", [])
        ]

    # -- artifacts ----------------------------------------------------------

    def artifact_dir(self, run_id: str) -> Path:
        """Local staging directory; :meth:`publish_artifacts` uploads it."""
        d = self._ensure_scratch() / run_id
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _artifact_http_path(self, artifact_uri: str, *parts: str) -> str:
        """An ``mlflow-artifacts:/...`` run artifact root (what a tracking
        server with ``--serve-artifacts`` hands out) as the proxy's path."""
        if not artifact_uri.startswith("mlflow-artifacts:/"):
            raise MlflowRestError(
                400, "INVALID_PARAMETER_VALUE",
                f"artifact uri {artifact_uri!r} is not served over the "
                "mlflow-artifacts REST proxy; run the tracking server "
                "with --serve-artifacts",
            )
        rel = artifact_uri[len("mlflow-artifacts:/"):].strip("/")
        return posixpath.join(rel, *parts)

    def _artifact_url(self, path: str) -> str:
        return f"{_ARTIFACTS}/{quote(path)}"

    def publish_artifacts(self, run_id: str, local_dir: Path) -> None:
        """Upload every file under ``local_dir`` to the run's artifacts,
        under ``local_dir``'s name."""
        local_dir = Path(local_dir)
        root = self._get_run_raw(run_id)["info"]["artifact_uri"]
        for f in sorted(local_dir.rglob("*")):
            if not f.is_file():
                continue
            rel = posixpath.join(local_dir.name,
                                 f.relative_to(local_dir).as_posix())
            path = self._artifact_http_path(root, rel)
            data = f.read_bytes()

            def put_attempt(path=path, data=data):
                inject(FAULT_SITE)
                resp = self._request("PUT", self._artifact_url(path),
                                     body=data,
                                     content_type="application/octet-stream")
                if resp.status_code >= 400:
                    raise MlflowRestError(resp.status_code, "INTERNAL_ERROR",
                                          resp.text[:200])

            # the same bytes to the same path: a retry after a lost
            # response is safe
            self._retrying(f"PUT artifact {path}", put_attempt)

    def _artifact_get(self, what: str, path: str, params=None) -> _Response:
        def attempt():
            inject(FAULT_SITE)
            resp = self._request("GET", path, params=params)
            if resp.status_code >= 400:
                raise MlflowRestError(resp.status_code, "INTERNAL_ERROR",
                                      resp.text[:200])
            return resp

        return self._retrying(what, attempt)

    def _download_tree(self, http_root: str, dest: Path) -> None:
        listing = self._artifact_get(f"LIST artifacts {http_root}",
                                     _ARTIFACTS, params={"path": http_root})
        for entry in listing.json().get("files", []):
            # entry["path"] is relative to the listed directory
            sub = posixpath.join(http_root, entry["path"])
            if entry.get("is_dir"):
                self._download_tree(sub, dest / entry["path"])
                continue
            resp = self._artifact_get(f"GET artifact {sub}",
                                      self._artifact_url(sub))
            out = dest / entry["path"]
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(resp.content)

    # -- registry -----------------------------------------------------------

    def create_model_version(self, name: str, run_id: str | None,
                             artifact_dir: Path) -> int:
        source = posixpath.join(
            self._get_run_raw(run_id)["info"]["artifact_uri"],
            Path(artifact_dir).name,
        )
        try:
            self._call("POST", "registered-models/create",
                       body={"name": name})
        except MlflowRestError as e:
            if e.error_code != "RESOURCE_ALREADY_EXISTS":
                raise
        out = self._call("POST", "model-versions/create", body={
            "name": name, "source": source, "run_id": run_id,
        })
        return int(out["model_version"]["version"])

    def list_model_versions(self, name: str) -> list[dict]:
        out = self._call("GET", "model-versions/search",
                         params={"filter": f"name='{name}'"})
        return sorted(
            (
                {
                    "version": int(v["version"]),
                    "run_id": v.get("run_id"),
                    "stage": v.get("current_stage") or "None",
                }
                for v in out.get("model_versions", [])
            ),
            key=lambda v: v["version"],
        )

    def latest_version(self, name: str) -> dict:
        versions = self.list_model_versions(name)
        if not versions:
            raise KeyError(f"registered model {name!r} has no versions")
        return versions[-1]

    def set_alias(self, name: str, alias: str, version: int) -> None:
        self._call("POST", "registered-models/alias", body={
            "name": name, "alias": alias, "version": str(version),
        })

    def get_alias(self, name: str, alias: str) -> int | None:
        try:
            out = self._call("GET", "registered-models/alias",
                             params={"name": name, "alias": alias})
        except MlflowRestError as e:
            # only "no such alias or model" means None; connectivity and
            # auth failures surface
            if e.error_code in ("RESOURCE_DOES_NOT_EXIST",
                                "INVALID_PARAMETER_VALUE"):
                return None
            raise
        return int(out["model_version"]["version"])

    def version_path(self, name: str, version: int) -> Path:
        """Download the registry version's model artifacts to a local
        directory and return it."""
        out = self._call("GET", "model-versions/get",
                         params={"name": name, "version": str(version)})
        source = out["model_version"]["source"]
        dest = self._ensure_scratch() / "downloads" / name / str(version)
        dest.mkdir(parents=True, exist_ok=True)
        self._download_tree(self._artifact_http_path(source), dest)
        return dest
