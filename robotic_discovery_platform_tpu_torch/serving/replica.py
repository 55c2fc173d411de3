"""Per-host replica bootstrap: one full server process per fleet member,
plus the subprocess-cluster helpers that boot a local fleet for tests and
``chip_smoke.py``'s fleet phase.

The port's copy of the JAX package's module: a worker ``main`` that boots
the real entry point (``serving/grpc_service.build_server``) and prints
exactly ONE JSON line the parent parses (the bound port and pid), plus
parent-side spawn / wait-serving / stop helpers. The replica itself is
just ``build_server`` -- same engine, admission, controller, health, and
stats surface as a standalone server; "replica" is a deployment role, not
a code path.

One difference from the JAX package: the worker takes ``--device {cuda,
cpu}`` in place of ``--force-cpu N``, and both it and
:func:`spawn_local_replicas` default to ``"cuda"``, by the port's rule
(the JAX spawner defaults to the CPU). A replica that cannot reach CUDA
fails its spawn; it does not serve on the CPU. Several replicas on one
card are processes with their own CUDA contexts, time-sliced by the card.
Build the kernels (``ops/build.build``) before spawning several:
concurrent builds are safe (each library is renamed into place) but
repeat the work.

Worker usage (what ``spawn_local_replicas`` runs):

    python -m robotic_discovery_platform_tpu_torch.serving.replica \\
        --tracking-uri file:/tmp/mlruns --img-size 64 --window-ms 2 \\
        --slo-ms 250 --port 0 [--device cuda|cpu] [--warmup WxH]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: how long spawn_local_replicas waits for each child's port line
_SPAWN_TIMEOUT_S = 180.0

#: directory containing the package -- prepended to each child's
#: PYTHONPATH so `-m ...serving.replica` resolves even when the parent
#: imported the package off sys.path (uninstalled checkout driven from
#: elsewhere), the same hermeticity multihost_worker gets from its
#: explicit sys.path insert
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


def register_tiny_model(root: Path, *, img_size: int = 64,
                        base_features: int = 8, seed: int = 0,
                        models: tuple[str, ...] = ("seg",)) -> str:
    """Create a file-store registry under ``root`` holding tiny
    registered models (staging-aliased) every replica of a local fleet
    serves -- shared weights are what make the 1-replica fleet path
    bitwise-comparable to a direct server. Returns the tracking URI.

    ``models`` picks zoo variants from the models/variants.py catalog;
    each gets its own registry entry under its registered name. The nets
    are the port's ``UNet``, drawn from ``torch.Generator().manual_seed(
    seed + i)`` (``img_size`` is the JAX signature's: a torch net needs
    no input shape to initialise)."""
    del img_size
    import torch

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import (
        variants as variants_lib,
    )
    from robotic_discovery_platform_tpu_torch.models import weights
    from robotic_discovery_platform_tpu_torch.models.unet import UNet
    from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    uri = f"file:{root}"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    base = ModelConfig(base_features=base_features,
                       compute_dtype="float32")
    for i, name in enumerate(models):
        variant = variants_lib.VARIANTS[name]
        mcfg = variant.model_config(base)
        reg_name = variants_lib.registered_name(
            variant, "Actuator-Segmenter")
        net = UNet(mcfg).init_weights(torch.Generator().manual_seed(seed + i))
        with tracking.start_run():
            version = tracking.log_model(
                weights.to_flax_variables(net), mcfg,
                registered_model_name=reg_name
            )
        tracking.Client().set_registered_model_alias(
            reg_name, "staging", version
        )
    return uri


def replica_config(tracking_uri: str, *, port: int = 0,
                   img_size: int = 64, window_ms: float = 2.0,
                   max_batch: int = 4, slo_ms: float = 250.0,
                   workdir: str | None = None, metrics_port: int = 0,
                   **overrides):
    """The smoke-scale ServerConfig a local replica boots: the model
    at ``img_size``, micro-batching ON (so the dispatcher, flight
    recorder, and serving.batch.* fault sites are live), SLO tracking on
    (the burn gauge is what the fleet controller scrapes), hot-reload
    polling off, and a 4 s arrival-rate horizon (the planner's demand
    input; the JAX package's keeps the 60 s default, where its
    single-model replicas report no rate at all)."""
    from robotic_discovery_platform_tpu_torch.utils.config import ServerConfig

    workdir = workdir or tempfile.mkdtemp(prefix="rdp-replica-")
    return ServerConfig(
        address=f"localhost:{port}",
        tracking_uri=tracking_uri,
        model_img_size=img_size,
        metrics_csv=str(Path(workdir) / "metrics.csv"),
        metrics_flush_every=64,
        calibration_path=str(Path(workdir) / "missing.npz"),
        batch_window_ms=window_ms,
        max_batch=max_batch,
        metrics_port=metrics_port,
        reload_poll_s=0.0,
        slo_ms=slo_ms,
        slo_window=128,
        slo_budget=0.05,
        # a 4 s arrival-rate horizon (8 x 0.5 s): the fleet planner's
        # demand follows a local fleet's load within seconds
        zoo_rate_interval_s=0.5,
        zoo_rate_window=8,
        **overrides,
    )


@dataclass
class LocalReplica:
    """One spawned replica subprocess and how to reach / restart it."""

    proc: subprocess.Popen
    endpoint: str
    port: int
    argv: list[str] = field(default_factory=list)
    env: dict = field(default_factory=dict)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Abrupt death (SIGKILL): the failure mode the fleet's failover
        path is built for."""
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=30)

    def terminate(self, timeout_s: float = 15.0) -> None:
        if self.alive():
            self.proc.terminate()
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:  # pragma: no cover
            self.proc.kill()
            self.proc.wait(timeout=10)


def _spawn_one(argv: list[str], env: dict,
               timeout_s: float) -> tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        argv, env=env, stdout=subprocess.PIPE, stderr=sys.stderr,
        text=True,
    )
    deadline = time.monotonic() + timeout_s
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.strip():
            break
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica exited rc={proc.returncode} before reporting "
                "its port"
            )
    try:
        port = int(json.loads(line)["port"])
    except Exception as exc:
        proc.kill()
        raise RuntimeError(
            f"replica did not report a port (got {line!r})"
        ) from exc
    return proc, port


def spawn_local_replicas(
    n: int,
    tracking_uri: str,
    *,
    img_size: int = 64,
    window_ms: float = 2.0,
    slo_ms: float = 250.0,
    warmup: tuple[int, int] | None = None,
    device: str = "cuda",
    per_replica_env: dict[int, dict] | None = None,
    metrics_port: int = 0,
    registrars: str = "",
    lease_ttl_s: float = 0.0,
    timeout_s: float = _SPAWN_TIMEOUT_S,
) -> list[LocalReplica]:
    """Boot ``n`` replica subprocesses against one shared registry and
    return them once each has printed its bound port (use
    :func:`wait_serving` to additionally wait for health SERVING).
    ``per_replica_env`` overlays extra env vars onto single replicas --
    how the CI fault leg arms ``RDP_FAULTS`` on exactly one fleet member
    without touching the others. ``metrics_port=-1`` gives each replica
    an ephemeral metrics endpoint (advertised back over the stats RPC),
    which the front-end's federation + trace stitching scrape.
    ``registrars`` (comma-separated front-end endpoints) makes each
    replica self-register a membership lease on boot -- the elastic
    path: the front-end needs no endpoint list for these members.
    ``device`` is where every replica serves (``"cuda"`` by default)."""
    replicas: list[LocalReplica] = []
    try:
        for i in range(n):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p
            )
            env.update((per_replica_env or {}).get(i, {}))
            argv = [
                sys.executable, "-m",
                "robotic_discovery_platform_tpu_torch.serving.replica",
                "--tracking-uri", tracking_uri,
                "--img-size", str(img_size),
                "--window-ms", str(window_ms),
                "--slo-ms", str(slo_ms),
                "--port", "0",
                "--device", device,
            ]
            if metrics_port:
                argv += ["--metrics-port", str(metrics_port)]
            if registrars:
                argv += ["--registrars", registrars]
            if lease_ttl_s:
                argv += ["--lease-ttl", str(lease_ttl_s)]
            if warmup is not None:
                argv += ["--warmup", f"{warmup[0]}x{warmup[1]}"]
            proc, port = _spawn_one(argv, env, timeout_s)
            replicas.append(LocalReplica(
                proc=proc, endpoint=f"localhost:{port}", port=port,
                argv=argv, env=env,
            ))
            log.info("replica %d up at localhost:%d (pid %d)",
                     i, port, proc.pid)
    except Exception:
        stop_replicas(replicas)
        raise
    return replicas


def respawn_replica(replica: LocalReplica,
                    timeout_s: float = _SPAWN_TIMEOUT_S) -> LocalReplica:
    """Restart a killed replica ON ITS OLD PORT (the fleet's static
    endpoint list does not change), returning the refreshed handle --
    how the kill legs prove health-gated rejoin."""
    argv = list(replica.argv)
    i = argv.index("--port")
    argv[i + 1] = str(replica.port)
    proc, port = _spawn_one(argv, replica.env, timeout_s)
    if port != replica.port:  # pragma: no cover - bind raced
        proc.kill()
        raise RuntimeError(
            f"respawn bound port {port}, wanted {replica.port}")
    return LocalReplica(proc=proc, endpoint=replica.endpoint,
                        port=port, argv=argv, env=replica.env)


def wait_serving(endpoints: list[str],
                 timeout_s: float = _SPAWN_TIMEOUT_S) -> None:
    """Block until every endpoint's grpc.health.v1 overall status reads
    SERVING (warm-up done, readiness up)."""
    import grpc

    from robotic_discovery_platform_tpu_torch.serving import health as health_lib
    from robotic_discovery_platform_tpu_torch.serving.proto import health_pb2

    deadline = time.monotonic() + timeout_s
    for ep in endpoints:
        channel = grpc.insecure_channel(ep)
        try:
            stub = health_lib.HealthStub(channel)
            while True:
                try:
                    resp = stub.Check(
                        health_pb2.HealthCheckRequest(service=""),
                        timeout=2.0,
                    )
                    if resp.status == health_lib.SERVING:
                        break
                except grpc.RpcError:
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {ep} not SERVING after {timeout_s:.0f}s")
                time.sleep(0.1)
        finally:
            channel.close()


def stop_replicas(replicas: list[LocalReplica]) -> None:
    for r in replicas:
        try:
            r.terminate()
        except Exception:  # pragma: no cover - teardown best-effort
            log.exception("replica %s teardown failed", r.endpoint)


# -- worker entry ------------------------------------------------------------


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Boot one fleet replica (a full serving/server.py "
                    "process) and print its bound port as one JSON line."
    )
    parser.add_argument("--tracking-uri", required=True)
    parser.add_argument("--img-size", type=int, default=64)
    parser.add_argument("--window-ms", type=float, default=2.0)
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--slo-ms", type=float, default=250.0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--metrics-port", type=int, default=0)
    parser.add_argument("--registrars", default="",
                        help="comma-separated front-end endpoints to "
                             "register a membership lease with (elastic "
                             "fleet; empty = static membership only)")
    parser.add_argument("--advertise", default="",
                        help="endpoint to advertise in the lease "
                             "(default: localhost:<bound port>)")
    parser.add_argument("--lease-ttl", type=float, default=0.0,
                        help="lease TTL seconds (0 = server default)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where this replica serves (the card unless "
                             "the caller asks for the CPU)")
    parser.add_argument("--warmup", default=None, metavar="WxH",
                        help="pre-compile for a WxH camera before "
                             "readiness flips (skipped by default so an "
                             "armed RDP_FAULTS one-shot cannot abort "
                             "boot; the fleet's warm phase absorbs it)")
    cli = parser.parse_args(argv)

    from robotic_discovery_platform_tpu_torch.serving import grpc_service

    warmup_shape = None
    if cli.warmup:
        w, h = cli.warmup.lower().split("x")
        warmup_shape = (int(w), int(h))
    overrides = {}
    if cli.registrars:
        overrides["fleet_registrars"] = cli.registrars
    if cli.advertise:
        overrides["fleet_advertise"] = cli.advertise
    if cli.lease_ttl:
        overrides["fleet_lease_ttl_s"] = cli.lease_ttl
    cfg = replica_config(
        cli.tracking_uri, port=cli.port, img_size=cli.img_size,
        window_ms=cli.window_ms, max_batch=cli.max_batch,
        slo_ms=cli.slo_ms, metrics_port=cli.metrics_port,
        **overrides,
    )
    server, servicer = grpc_service.build_server(
        cfg, warmup_shape=warmup_shape, device=cli.device)
    # build_server already bound cfg.address (":0" included) and recorded
    # the OS-assigned port; report that one instead of binding a second
    port = servicer.bound_port or cli.port
    server.start()
    print(json.dumps({"port": port, "pid": os.getpid()}), flush=True)

    stopping = []

    def on_term(signum, frame):  # graceful drain on SIGTERM
        if not stopping:
            stopping.append(signum)
            server.stop(grace=cfg.drain_grace_s)

    signal.signal(signal.SIGTERM, on_term)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=None)
    finally:
        servicer.close()


if __name__ == "__main__":
    main()
