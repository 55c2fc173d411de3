#!/usr/bin/env python
"""Where the port's serving host time goes: the servicer's frames/s with
parts of its stream and frame path switched off, in turns, on one card.

Each variant builds a direct and a batched ``VisionAnalysisService`` over
the full-width default model (chip_smoke's seeded, BatchNorm-calibrated
net; 480x640 synthetic frames), then measures
  * one stream of 8 frames, ``--reps`` times: frames/s, and the
    milliseconds of each stream spent outside ``proc_time_ms`` (opening
    and closing the stream);
  * 8 concurrent direct streams of 8 frames, and 8 batched
    (``batch_window_ms`` 2, ``max_batch`` 8), ``--reps`` times each;
the first one-stream and batched runs after each warm-up are reported
apart ("first") and left out of the medians. Every variant also reports
a frame's host time in its parts over the one-stream runs (``Parts``:
the request decode, the packed row, the response fields, and the rest
of ``proc_time_ms``), timed by the same wrappers in any checkout, and
the garbage collector's pauses in each phase.
A variant switches off, in this process only, any of
  ``log``          the server module's INFO lines (logger level WARNING),
  ``instruments``  the frame instruments (``obs`` sites and the stage
                   observer become no-ops),
  ``span``         the ``serving.stream`` span,
  ``stream``       the cache's own stream (``graphs.dedicated_stream``
                   becomes PyTorch's pooled ``torch.cuda.Stream``),
  ``drift``        the drift monitor (the servicers are built with
                   ``ServerConfig.drift_enabled = False``; the confidence
                   margin histogram and the depth count stay).
The variants run in the order given and then in reverse. A package
without those parts (an older checkout, ``--root``) runs "base" only.

Run on the card from a checkout's root:
  python tools/torch_serving_cost.py [--root DIR] [--reps N]
      [--variants base,log,instruments,span,stream,drift,all]
Prints one JSON line per variant and turn, and the card's name and
power limit. ``--instruments-only`` times one frame's instrument calls
on the host (``instruments_us``) and ``--drift-only`` one frame's drift
monitoring (``drift_us``), and prints that alone (no card needed).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib
import json
import logging
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

PKG = "robotic_discovery_platform_tpu_torch"
OFF = {"base": (), "log": ("log",), "instruments": ("instruments",),
       "span": ("span",), "stream": ("stream",), "drift": ("drift",),
       "all": ("log", "instruments", "span", "stream", "drift")}

#: ServerConfig fields every servicer of a measurement takes (a variant
#: sets them)
CFG_FIELDS: dict = {}


class _Null:
    """An instrument that records nothing."""

    def labels(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class _NullObs:
    def __getattr__(self, name):
        return _Null()


class _NoSpan:
    """The trace module with ``span`` a null context."""

    def __init__(self, trace):
        self._trace = trace

    def span(self, name, parent=None):
        return contextlib.nullcontext()

    def __getattr__(self, name):
        return getattr(self._trace, name)


@contextlib.contextmanager
def switched_off(torch, parts: tuple):
    server = importlib.import_module(f"{PKG}.serving.server")
    graphs = importlib.import_module(f"{PKG}.ops.graphs")
    with contextlib.ExitStack() as stack:
        def patch(obj, name, value):
            old = getattr(obj, name)
            setattr(obj, name, value)
            stack.callback(setattr, obj, name, old)

        if "log" in parts:
            logger = logging.getLogger(server.__name__)
            stack.callback(logger.setLevel, logger.level)
            logger.setLevel(logging.WARNING)
        if "instruments" in parts:
            patch(server, "obs", _NullObs())
            patch(server, "_observe_stage", lambda stage, dt: None)
        if "span" in parts:
            patch(server, "trace", _NoSpan(server.trace))
        if "stream" in parts:
            patch(graphs, "dedicated_stream",
                  lambda device, owner: torch.cuda.Stream(device))
        if "drift" in parts:
            stack.callback(CFG_FIELDS.pop, "drift_enabled", None)
            CFG_FIELDS["drift_enabled"] = False
        yield


def supports(parts: tuple) -> bool:
    server = importlib.import_module(f"{PKG}.serving.server")
    graphs = importlib.import_module(f"{PKG}.ops.graphs")
    need = {"log": True, "instruments": hasattr(server, "obs"),
            "span": hasattr(server, "trace"),
            "stream": hasattr(graphs, "dedicated_stream"),
            "drift": hasattr(server.VisionAnalysisService, "_observe_drift")}
    return all(need[p] for p in parts)


class Parts:
    """Host time of a frame's parts, timed alike in any checkout: the
    request decode (``ingest.decode_request``), the packed row
    (``VisionAnalysisService._packed``: the replay and read-back, or the
    dispatcher's answer) and the response fields (``server._fields``);
    and the garbage collector's pauses, by phase."""

    def __init__(self):
        self.phase = None  # timed while set
        self.ms: dict = collections.defaultdict(float)
        self.gc: dict = collections.defaultdict(lambda: [0.0, 0, 0, 0])
        self._lock = threading.Lock()
        self._gc_t0 = 0.0

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                phase = self.phase
                if phase is not None:
                    with self._lock:
                        self.ms[phase, name] += (
                            time.perf_counter() - t0) * 1e3
        return timed

    def on_gc(self, event: str, info: dict) -> None:
        if event == "start":
            self._gc_t0 = time.perf_counter()
        elif self.phase is not None:
            row = self.gc[self.phase]
            row[0] += (time.perf_counter() - self._gc_t0) * 1e3
            row[1 + info["generation"]] += 1

    @contextlib.contextmanager
    def installed(self):
        server = importlib.import_module(f"{PKG}.serving.server")
        cls = server.VisionAnalysisService
        olds = ((server.ingest, "decode_request"), (cls, "_packed"),
                (server, "_fields"))
        saved = [getattr(obj, name) for obj, name in olds]
        for (obj, name), fn in zip(olds, saved):
            setattr(obj, name, self.wrap(name, fn))
        gc.callbacks.append(self.on_gc)
        try:
            yield self
        finally:
            gc.callbacks.remove(self.on_gc)
            for (obj, name), fn in zip(olds, saved):
                setattr(obj, name, fn)


def measure(port, smoke, folded, requests, reps: int,
            device: str = "cuda") -> dict:
    with Parts().installed() as parts:
        got = _measure(port, smoke, folded, requests, reps, device, parts)
    frames = reps * len(requests)
    names = ("decode_request", "_packed", "_fields")
    split = {name: parts.ms["one", name] / frames for name in names}
    split["rest"] = got.pop("one_proc_ms") / frames - sum(split.values())
    got["one_stream_frame_ms"] = split
    got["gc"] = {phase: {"ms": row[0], "collections": row[1:]}
                 for phase, row in parts.gc.items()}
    return got


def _measure(port, smoke, folded, requests, reps: int, device: str,
             parts: Parts) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="serving_cost_"))
    # the servicer phase's settings (chip_smoke.servicer_phase)
    cfg = port.ServerConfig(address="localhost:0",
                            metrics_csv=str(tmp / "direct.csv"),
                            metrics_flush_every=1,
                            calibration_path=str(tmp / "none.npz"),
                            **CFG_FIELDS)
    out: dict = {"one_stream_fps": [], "one_stream_outside_ms": [],
                 "direct8_fps": [], "batched8_fps": []}
    service = port.VisionAnalysisService(folded, cfg=cfg, device=device)
    service.warmup(smoke.FRAME_W, smoke.FRAME_H)
    proc_ms = 0.0
    for rep in range(reps + 1):
        parts.phase = "one" if rep else None
        t0 = time.perf_counter()
        got = list(service.analyze_stream(iter(requests)))
        wall = time.perf_counter() - t0
        parts.phase = None
        out["one_stream_fps"].append(len(got) / wall)
        out["one_stream_outside_ms"].append(
            wall * 1e3 - sum(r.proc_time_ms for r in got))
        if rep:
            proc_ms += sum(r.proc_time_ms for r in got)
    n = len(requests)
    streams = [[requests[(s * 2 + j) % n] for j in range(n)]
               for s in range(smoke.STREAMS)]
    parts.phase = "direct8"
    for _ in range(reps):
        _, wall = smoke.concurrent_streams(service, streams)
        out["direct8_fps"].append(smoke.STREAMS * n / wall)
    parts.phase = None
    service.close()
    bcfg = port.ServerConfig(address="localhost:0",
                             metrics_csv=str(tmp / "batched.csv"),
                             metrics_flush_every=1,
                             calibration_path=str(tmp / "none.npz"),
                             batch_window_ms=2.0, max_batch=smoke.MAX_BATCH,
                             **CFG_FIELDS)
    batched = port.VisionAnalysisService(folded, cfg=bcfg, device=device)
    batched.warmup(smoke.FRAME_W, smoke.FRAME_H)
    for rep in range(reps + 1):
        parts.phase = "batched8" if rep else None
        _, wall = smoke.concurrent_streams(batched, streams)
        parts.phase = None
        out["batched8_fps"].append(smoke.STREAMS * n / wall)
    batched.close()
    # the first run after a warm-up apart (chip_smoke's servicer phase
    # measures that one)
    first = {k: v[0] for k, v in out.items() if k != "direct8_fps"}
    summary = {k: float(np.median(v[1:] if k in first else v))
               for k, v in out.items()}
    return {"median": summary, "first": first, "runs": out,
            "one_proc_ms": proc_ms}


def instruments_us(frames: int = 5000, repeats: int = 5) -> float:
    """Host microseconds of one frame's instrument calls, as the
    checkout's ``_respond`` makes them (three stages through the stage
    timer and its observer, the frame counter, the total stage, the
    end-to-end summary), on latency-like values; the least of
    ``repeats`` rounds. None for a checkout without instruments."""
    server = importlib.import_module(f"{PKG}.serving.server")
    if not hasattr(server, "obs"):
        return None
    obs, label = server.obs, server.MODEL_LABEL
    values = [float(v) for v in np.random.default_rng(0).lognormal(
        -6.0, 0.5, 4 * frames)]
    timer = server.StageTimer(observer=server._observe_stage)
    if hasattr(server, "_child"):
        def count():
            server._child(obs.FRAMES, "ok", label).inc()
    else:
        def count():
            obs.FRAMES.labels(status="ok", model=label).inc()

    def run() -> float:
        it = iter(values)
        t0 = time.perf_counter()
        for _ in range(frames):
            for stage in ("decode", "device", "encode"):
                timer.observe(stage, next(it))
            total = next(it)
            count()
            server._observe_stage("total", total)
            obs.FRAME_LATENCY_SUMMARY.observe(total)
        return (time.perf_counter() - t0) / frames * 1e6

    run()  # the children and the estimators' first samples
    return min(run() for _ in range(repeats))


def drift_us(frames: int = 4096, repeats: int = 5) -> dict | None:
    """Host microseconds of one frame's drift monitoring, as the
    checkout's servicer makes it: the depth-valid count over a 480x640
    depth frame (``depth_count``), and ``_observe_drift`` (the margin
    histogram and ``DriftMonitor.observe_frame`` under the default
    ``ServerConfig.drift_*`` settings, its rescoring every
    ``drift_score_every`` frames included) on synthetic signals after the
    self-baseline; the least of ``repeats`` rounds. None for a checkout
    without the monitor."""
    server = importlib.import_module(f"{PKG}.serving.server")
    if not hasattr(server.VisionAnalysisService, "_observe_drift"):
        return None
    profile = importlib.import_module(f"{PKG}.monitoring.profile")
    cfg = server.ServerConfig()
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 2000, (480, 640)).astype(np.uint16)
    results = [server.FrameResult(
        float(rng.uniform(2, 8)), float(rng.uniform(8, 30)),
        np.zeros((0, 3), np.float32), b"", float(rng.uniform(10, 40)),
        bool(rng.random() < 0.9), b"", float(rng.uniform(0.2, 0.45)),
        float(rng.uniform(0.6, 1.0))) for _ in range(frames)]

    class Service:
        drift = profile.DriftMonitor(
            window=cfg.drift_window, baseline_frames=cfg.drift_baseline_frames,
            score_every=cfg.drift_score_every,
            psi_threshold=cfg.drift_psi_threshold,
            sustain_s=cfg.drift_sustain_s, cooldown_s=cfg.drift_cooldown_s)

    observe = server.VisionAnalysisService._observe_drift
    for res in results[:cfg.drift_baseline_frames]:
        observe(Service, res)  # the self-baseline

    def run() -> float:
        t0 = time.perf_counter()
        for res in results:
            observe(Service, res)
        return (time.perf_counter() - t0) / frames * 1e6

    def count() -> float:
        t0 = time.perf_counter()
        for _ in range(256):
            float(np.count_nonzero(depth)) / max(depth.size, 1)
        return (time.perf_counter() - t0) / 256 * 1e6

    return {"observe_drift": min(run() for _ in range(repeats)),
            "depth_count": min(count() for _ in range(repeats))}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package and chip_smoke.py to use")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default="base,log,instruments,span,"
                    "stream,drift,all")
    ap.add_argument("--instruments-only", action="store_true",
                    help="time a frame's instrument calls on the host "
                    "and stop (no card needed)")
    ap.add_argument("--drift-only", action="store_true",
                    help="time a frame's drift monitoring on the host and "
                    "stop (no card needed)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    if args.instruments_only:
        print(json.dumps({"root": args.root,
                          "instruments_us_per_frame": instruments_us()}))
        return 0
    if args.drift_only:
        print(json.dumps({"root": args.root,
                          "drift_us_per_frame": drift_us()}))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    port = importlib.import_module(PKG)
    from robotic_discovery_platform_tpu_torch.ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    build.build()
    rng = np.random.default_rng(smoke.SEED)
    frames = [port.render_scene(rng, smoke.FRAME_H, smoke.FRAME_W)
              for _ in range(8)]
    requests = [port.raw_request(rgb, depth, mask_format=i % 3)
                for i, (rgb, _, depth) in enumerate(frames)]
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    folded = port.FoldedUNet(smoke.seeded_model(torch, port, x0),
                             device="cuda")
    names = [v for v in args.variants.split(",") if supports(OFF[v])]
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            with switched_off(torch, OFF[name]):
                got = measure(port, smoke, folded, requests, args.reps)
            print(json.dumps({"root": args.root, "variant": name,
                              "turn": turn, **got}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
