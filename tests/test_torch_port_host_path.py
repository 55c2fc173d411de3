"""The port's serving host path on the CPU against the JAX package's: the
decode pool and geometry cache (serving/ingest.py), the encode pool
(serving/egress.py), the environment overrides of the pools and the
dispatch window, ``ServerConfig.model_forward``, the servicer's use of the
encode pool on the direct path, and the dispatcher's instruments after a
fixed submission sequence.

Tolerances, fixed before measuring: none but one. Decoded frames, encoded
payloads, hit and miss counts, shed and restart counts, resolved widths
and instrument counts are compared exactly; the "flax" forward's logits
against the JAX package's Flax forward and against the folded forward are
held to rtol 1e-4, atol 1e-5 (float32, base 4: two summation orders of
the same products).
"""

import threading
import time

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.observability import (
    instruments as jobs,
)
from robotic_discovery_platform_tpu.resilience import (
    configure_faults as jconfigure_faults,
)
from robotic_discovery_platform_tpu.serving import batching as jbatching
from robotic_discovery_platform_tpu.serving import client as jclient
from robotic_discovery_platform_tpu.serving import egress as jegress
from robotic_discovery_platform_tpu.serving import ingest as jingest
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as tobs,
)
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.resilience import (
    configure_faults,
)
from robotic_discovery_platform_tpu_torch.serving import batching
from robotic_discovery_platform_tpu_torch.serving import client as tclient
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
    tier_forward,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    ServerConfig,
)

H, W = 48, 64
WATCHDOG_S = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs in
    several worker processes at once, and torch's pool of one thread per
    core, oversubscribed, waits on itself at every small op
    (tests/test_torch_port_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_faults():
    configure_faults(None)
    jconfigure_faults(None)
    yield
    configure_faults(None)
    jconfigure_faults(None)


def _frame(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (H, W, 3)).astype(np.uint8),
            rng.integers(0, 5000, (H, W)).astype(np.uint16))


def _requests(fmts, mask_formats=(0,)):
    """The same request sequence as the port's and the JAX package's
    protobuf messages (each client's ``encode_request``)."""
    ours, theirs = [], []
    for i, fmt in enumerate(fmts):
        bgr, depth = _frame(i)
        mf = mask_formats[i % len(mask_formats)]
        ours.append(tclient.encode_request(bgr, depth, fmt=fmt,
                                           mask_format=mf))
        theirs.append(jclient.encode_request(bgr, depth, fmt=fmt,
                                             mask_format=mf))
    return ours, theirs


def _wait_for(cond, what: str, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    ready = threading.Event()
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        ready.wait(0.005)


def _same_frame(a, b) -> None:
    """A decoded color frame (pixels or a CoefficientFrame), bitwise."""
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        return
    for f in ("height", "width", "subsampling", "y", "cb", "cr", "qy", "qc"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


# -- the decode pool ------------------------------------------------------------


@pytest.mark.parametrize("workers", [0, 2])
def test_decode_pool_matches_jax(workers):
    """Raw, encoded (cv2) and coefficient requests through both packages'
    pools: the same frames bit for bit, formats, selectors and order."""
    ours, theirs = _requests(["raw", "encoded", "coef", "raw", "coef",
                              "encoded"], mask_formats=(0, 1, 2))
    tpool = ingest.DecodePool(workers, prefetch=2,
                              watchdog_interval_s=WATCHDOG_S)
    jpool = jingest.DecodePool(workers, prefetch=2,
                               watchdog_interval_s=WATCHDOG_S)
    try:
        got = list(tpool.iter_decoded(iter(ours)))
        want = list(jpool.iter_decoded(iter(theirs)))
    finally:
        tpool.stop()
        jpool.stop()
    assert len(got) == len(want) == len(ours)
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        _same_frame(g.rgb, w.rgb)
        np.testing.assert_array_equal(g.depth, w.depth)
        assert (g.fmt, g.model, g.mask_format, g.time_remaining) == (
            w.fmt, w.model, w.mask_format, w.time_remaining)
    assert [g.fmt for g in got] == ["raw", "encoded", "coef", "raw", "coef",
                                    "encoded"]


def test_decode_pool_counts_its_decodes_as_jax():
    """``rdp_decode_seconds{format}`` and the host split's decode and
    entropy stages count the same decodes in both packages."""
    ours, theirs = _requests(["raw", "coef", "encoded"])

    def counts(obs):
        return ([obs.DECODE_SECONDS.labels(format=f).count
                 for f in ("raw", "coef", "encoded")]
                + [obs.HOST_STAGE_SPLIT.labels(stage=s).count
                   for s in ("decode", "entropy")])

    deltas = []
    for pool_cls, reqs, obs in ((ingest.DecodePool, ours, tobs),
                                (jingest.DecodePool, theirs, jobs)):
        before = counts(obs)
        pool = pool_cls(2, watchdog_interval_s=WATCHDOG_S)
        try:
            assert all(f.error is None for f in pool.iter_decoded(iter(reqs)))
        finally:
            pool.stop()
        deltas.append([a - b for a, b in zip(counts(obs), before)])
    assert deltas[0] == deltas[1] == [1, 1, 1, 3, 1]


def test_decode_pool_sheds_before_decode_as_jax():
    ours, theirs = _requests(["raw"])
    for mod, obs, req in ((ingest, tobs, ours[0]), (jingest, jobs, theirs[0])):
        shed0 = obs.SHED_BY_DEADLINE.labels(point="decode").value
        pool = mod.DecodePool(1, watchdog_interval_s=WATCHDOG_S)
        try:
            p = pool.submit(req, deadline_t=time.monotonic() - 1.0)
            pool.wait(p, timeout_s=5.0)
            assert type(p.error).__name__ == "DeadlineExceeded"
            assert p.rgb is None and pool.sheds == 1
            assert obs.SHED_BY_DEADLINE.labels(point="decode").value == (
                shed0 + 1)
        finally:
            pool.stop()
    p = ingest.DecodePool(0).submit(ours[0], deadline_t=0.0)
    assert p.error is None  # inline decode never sheds


@pytest.mark.parametrize("site", ["serving.ingest.decode",
                                  "serving.ingest.loop"])
def test_decode_faults_as_jax(site):
    """The per-frame site fails that frame only; the loop site kills the
    worker, whose frame fails, and the watchdog restarts it: in both
    packages, with the same outcomes and restart counts."""
    ours, theirs = _requests(["raw", "raw", "raw"])
    outcomes = []
    for mod, configure, reqs in ((ingest, configure_faults, ours),
                                 (jingest, jconfigure_faults, theirs)):
        configure(f"{site}:exc:1")
        pool = mod.DecodePool(1, watchdog_interval_s=WATCHDOG_S)
        try:
            first = pool.submit(reqs[0])
            pool.wait(first, timeout_s=10.0)
            if site.endswith("loop"):
                _wait_for(lambda: pool.worker_restarts >= 1, "a restart")
            rest = list(pool.iter_decoded(iter(reqs[1:])))
            outcomes.append((first.error is not None,
                             [f.error is None for f in rest],
                             pool.worker_restarts))
        finally:
            pool.stop()
            configure(None)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == (True, [True, True],
                           1 if site.endswith("loop") else 0)


def test_decode_pool_stop_leaves_no_waiter_blocked():
    """Waiters on a frame a dead worker held and on a frame still queued:
    ``stop`` fails both at once, in both packages."""
    ours, theirs = _requests(["raw", "raw"])
    for mod, configure, reqs in ((ingest, configure_faults, ours),
                                 (jingest, jconfigure_faults, theirs)):
        configure("serving.ingest.loop:exc:1")
        pool = mod.DecodePool(1, watchdog_interval_s=0.0)  # no restart
        held = pool.submit(reqs[0])
        _wait_for(lambda: not pool._threads[0].is_alive(), "the worker")
        queued = pool.submit(reqs[1])
        errors = []
        waiters = [threading.Thread(
            target=lambda p=p: (pool.wait(p, 30.0), errors.append(p.error)))
            for p in (held, queued)]
        for t in waiters:
            t.start()
        t0 = time.monotonic()
        pool.stop()
        for t in waiters:
            t.join(timeout=10.0)
        configure(None)
        assert time.monotonic() - t0 < 10.0
        assert [str(e) for e in errors] == ["decode pool stopped"] * 2
        p = pool.submit(reqs[0])
        assert p.done.is_set() and str(p.error) == "decode pool stopped"


def test_iter_decoded_honours_activity_and_deadline():
    ours, _ = _requests(["raw"] * 4)
    pool = ingest.DecodePool(0)
    checks = iter([True, True, False])
    assert len(list(pool.iter_decoded(iter(ours),
                                      active=lambda: next(checks)))) == 2
    # grpc's deadline-less sentinel (INT64_MAX ns) reads as no deadline
    frames = list(pool.iter_decoded(iter(ours), time_remaining=lambda: 9e18))
    assert [f.time_remaining for f in frames] == [None] * 4
    assert list(pool.iter_decoded(iter(ours), time_remaining=lambda: 0.0)) == []
    assert ingest.normalize_remaining(1.5) == jingest.normalize_remaining(1.5)


# -- the geometry cache ---------------------------------------------------------


def test_geometry_cache_counts_as_jax():
    k = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    k2 = k.copy()
    k2[0, 0] = 120.0
    lookups = [(k, 64, 48, 0.001), (k.copy(), 64, 48, 0.001),
               (k2, 64, 48, 0.001), (k, 64, 48, 0.002), (None, 64, 48, 0.001),
               (None, 64, 48, 0.001), (k, 128, 96, 0.001), (k, 64, 48, 0.001)]
    got = []
    for cache, obs in ((ingest.GeometryCache(capacity=4), tobs),
                       (jingest.GeometryCache(capacity=4), jobs)):
        h0, m0 = obs.GEOMETRY_CACHE_HITS.value, obs.GEOMETRY_CACHE_MISSES.value
        entries = [cache.lookup(*args) for args in lookups]
        got.append((obs.GEOMETRY_CACHE_HITS.value - h0,
                    obs.GEOMETRY_CACHE_MISSES.value - m0, len(cache),
                    [e.k_f32.tobytes() for e in entries],
                    [entries.index(e) for e in entries]))
    assert got[0] == got[1]
    assert got[0][:3] == (2, 6, 4)
    bounded = ingest.GeometryCache(capacity=4)
    for i in range(10):
        bounded.lookup(None, 32 + i, 32, 0.001)
    assert len(bounded) == 4


def test_geometry_entry_stages_once_under_its_lock():
    entry = ingest.GeometryCache().lookup(None, W, H, 0.001)
    staged = []
    threads = [threading.Thread(target=lambda: staged.append(entry.staged()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(s[0] is staged[0][0] and s[1] is staged[0][1] for s in staged)
    assert np.array_equal(staged[0][0].numpy(), entry.k_f32)
    assert staged[0][1].dtype == torch.float32


# -- the encode pool ------------------------------------------------------------


def _mask(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((H, W)) > 0.6).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["png", "bits", "rle"])
def test_encode_pool_bytes_equal_inline_and_jax(fmt):
    masks = [_mask(i) for i in range(4)]
    pools = [egress.EncodePool(0), egress.EncodePool(2),
             jegress.EncodePool(0), jegress.EncodePool(2)]
    try:
        outs = []
        for pool in pools:
            row = []
            for m in masks:
                kw = ({"bits": np.packbits(m, axis=-1), "shape": m.shape}
                      if fmt == "bits" else {"mask": m})
                row.append(pool.encode(fmt, **kw))
            outs.append(row)
    finally:
        for pool in pools:
            pool.stop()
    assert outs[0] == outs[1] == outs[2] == outs[3]
    for m, payload in zip(masks, outs[0]):
        decoded = egress.decode_mask_wire(payload)
        if fmt == "png":
            # the card's machine has no cv2: the stdlib writer gives the
            # same pixels
            assert decoded is None
            import cv2

            for png in (payload, egress.png_gray8(m * np.uint8(255))):
                np.testing.assert_array_equal(
                    cv2.imdecode(np.frombuffer(png, np.uint8),
                                 cv2.IMREAD_GRAYSCALE), m * 255)
        else:
            np.testing.assert_array_equal(decoded, m)
    if fmt == "rle":
        # from the packed bits, as a dispatcher's row gives them
        assert egress.EncodePool(0).encode(
            "rle", bits=np.packbits(masks[0], axis=-1),
            shape=(H, W)) == outs[0][0]


def test_encode_fault_fails_one_frame_only():
    for mod, configure in ((egress, configure_faults),
                           (jegress, jconfigure_faults)):
        configure("serving.egress.encode:exc:1")
        pool = mod.EncodePool(1, watchdog_interval_s=WATCHDOG_S)
        try:
            with pytest.raises(RuntimeError, match="injected"):
                pool.encode("png", mask=_mask(0))
            assert pool.encode("png", mask=_mask(0))
            assert all(t.is_alive() for t in pool._threads)
        finally:
            pool.stop()
            configure(None)
    configure_faults("serving.egress.loop:exc:1")
    pool = egress.EncodePool(1, watchdog_interval_s=WATCHDOG_S)
    try:
        with pytest.raises(RuntimeError, match="worker died"):
            pool.encode("bits", bits=np.packbits(_mask(1), axis=-1),
                        shape=(H, W), timeout_s=10.0)
        _wait_for(lambda: pool.worker_restarts == 1, "a restart")
        assert pool.encode("png", mask=_mask(1), timeout_s=10.0)
    finally:
        pool.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        pool.encode("png", mask=_mask(1))


def test_encode_counts_as_jax():
    def counts(obs):
        return ([obs.ENCODE_SECONDS.labels(format=f).count
                 for f in ("png", "bits", "rle")]
                + [obs.EGRESS_BYTES.labels(format=f).value
                   for f in ("png", "bits", "rle")])

    deltas = []
    for mod, obs in ((egress, tobs), (jegress, jobs)):
        before = counts(obs)
        pool = mod.EncodePool(2, watchdog_interval_s=WATCHDOG_S)
        try:
            for fmt in ("png", "bits", "rle", "rle"):
                kw = ({"bits": np.packbits(_mask(2), axis=-1),
                       "shape": (H, W)} if fmt == "bits"
                      else {"mask": _mask(2)})
                pool.encode(fmt, **kw)
        finally:
            pool.stop()
        deltas.append([a - b for a, b in zip(counts(obs), before)])
    assert deltas[0] == deltas[1]
    assert deltas[0][:3] == [1, 1, 2]


# -- the environment overrides --------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "0", "1", "3", "-1"])
def test_environment_overrides_resolve_as_jax(value, monkeypatch):
    pairs = (("RDP_INFLIGHT", batching.resolve_max_inflight,
              jbatching.resolve_max_inflight),
             ("RDP_EGRESS_WORKERS", egress.resolve_egress_workers,
              jegress.resolve_egress_workers),
             ("RDP_DECODE_WORKERS", ingest.resolve_decode_workers,
              jingest.resolve_decode_workers))
    for var, ours, theirs in pairs:
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        for configured in (-2, 0, 1, 2, 5):
            assert ours(configured) == theirs(configured), (var, configured)


# -- the servicer's pools -------------------------------------------------------


def _blank_forward(x):
    return torch.zeros((*x.shape[:3], 1), dtype=torch.float32) + (
        x[..., :1] - 0.5)


@pytest.mark.parametrize("how", ["field", "env"])
def test_direct_path_encodes_through_the_pool(how, tmp_path, monkeypatch):
    """A direct-path servicer (``batch_window_ms`` 0) with two encode
    workers, set in the field or by ``RDP_EGRESS_WORKERS``, encodes every
    mask on a pool thread, as the JAX servicer does: the setting is not
    ignored."""
    monkeypatch.delenv("RDP_EGRESS_WORKERS", raising=False)
    if how == "env":
        monkeypatch.setenv("RDP_EGRESS_WORKERS", "2")
    cfg = ServerConfig(model_img_size=32, metrics_csv=str(tmp_path / "m.csv"),
                       egress_workers=2 if how == "field" else 0)
    threads = []
    real = egress.encode_png_mask

    def recording(mask):
        threads.append(threading.current_thread().name)
        return real(mask)

    monkeypatch.setattr(egress, "encode_png_mask", recording)
    service = VisionAnalysisService(_blank_forward, cfg=cfg, device="cpu")
    try:
        before = tobs.ENCODE_SECONDS.labels(format="png").count
        requests = [ingest.raw_request(*_frame(i)) for i in range(3)]
        out = list(service.analyze_stream(iter(requests)))
        assert all(r.status.startswith(("OK", "DEGRADED")) for r in out)
        assert tobs.ENCODE_SECONDS.labels(format="png").count == before + 3
    finally:
        service.close()
    assert len(threads) == 3
    assert all(name.startswith("egress-encode-") for name in threads), threads


def test_pooled_servicer_answers_as_the_inline_one(tmp_path):
    """Decode and encode pools on the direct and the batched path: every
    response equal to the inline direct servicer's, in every format."""
    requests = [ingest.raw_request(*_frame(i), mask_format=i % 3)
                for i in range(6)]
    base = dict(model_img_size=32, calibration_path=str(tmp_path / "no.npz"))

    def serve(name, **kw):
        service = VisionAnalysisService(
            _blank_forward, cfg=ServerConfig(
                metrics_csv=str(tmp_path / f"{name}.csv"), **base, **kw),
            device="cpu")
        try:
            return list(service.analyze_stream(iter(requests)))
        finally:
            service.close()

    want = serve("inline")
    for name, kw in (("pooled", dict(decode_workers=2, ingest_prefetch=2,
                                     egress_workers=2)),
                     ("batched", dict(batch_window_ms=1.0, egress_workers=2,
                                      decode_workers=2))):
        got = serve(name, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.status, g.mask, g.mask_coverage, g.packed_spline,
                    g.mean_curvature, g.max_curvature) == (
                        w.status, w.mask, w.mask_coverage, w.packed_spline,
                        w.mean_curvature, w.max_curvature), name
            assert g.spline_points == w.spline_points


def test_a_shed_frame_answers_deadline_exceeded(tmp_path):
    """A frame whose stream deadline is already spent when a pool worker
    takes it is shed before its decode and answered per frame."""
    cfg = ServerConfig(model_img_size=32, metrics_csv=str(tmp_path / "m.csv"),
                       decode_workers=1)
    service = VisionAnalysisService(_blank_forward, cfg=cfg, device="cpu")
    try:
        # a nanosecond of budget: spent before a worker takes the frame
        out = list(service.analyze_stream(
            iter([ingest.raw_request(*_frame(0))]),
            time_remaining=lambda: 1e-9))
    finally:
        service.close()
    assert len(out) == 1 and out[0].status.startswith(
        "ERROR: DeadlineExceeded")


# -- model_forward ----------------------------------------------------------------


def test_model_forward_values_read_as_jax():
    import jax

    from robotic_discovery_platform_tpu.models.unet import (
        build_unet,
        init_unet,
    )
    from robotic_discovery_platform_tpu.serving.server import (
        VisionAnalysisService as JaxService,
    )
    from robotic_discovery_platform_tpu.utils.config import (
        ModelConfig as JaxModelConfig,
        ServerConfig as JaxServerConfig,
    )
    from robotic_discovery_platform_tpu_torch.models.weights import (
        unet_from_flax_variables,
    )
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
        FoldedUNet,
    )
    from robotic_discovery_platform_tpu_torch.utils import config

    jcfg = JaxModelConfig(base_features=4, compute_dtype="float32")
    model = build_unet(jcfg)
    variables = jax.tree.map(np.asarray,
                             jax.jit(lambda k: init_unet(model, k, 32))(
                                 jax.random.key(0)))
    net = unet_from_flax_variables(
        ModelConfig(base_features=4, compute_dtype="float32"), variables)
    x = np.random.default_rng(0).random((1, 32, 32, 3), np.float32)
    want = np.asarray(model.apply(variables, x))
    for mode in ("auto", "pallas", "flax", "xla", "cudnn"):
        jerr = terr = None
        try:
            jfwd = JaxService._build_forward(
                model, variables, JaxServerConfig(model_forward=mode))
        except ValueError as exc:
            jerr = exc
        try:
            config.check_supported(ServerConfig(model_forward=mode))
            forward, _ = tier_forward(net, "f32", torch.device("cpu"), mode)
        except ValueError as exc:
            terr = exc
        assert (jerr is None) == (terr is None), mode
        if terr is not None:
            continue
        assert isinstance(forward, FoldedUNet) == (mode != "flax"), mode
        if mode == "flax":
            assert jfwd is None  # the JAX servicer's unfolded Flax forward
        with torch.no_grad():
            got = forward(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- the dispatcher's instruments ------------------------------------------------


def _rows(frames) -> np.ndarray:
    """Packed rows whose coverage is each frame's first pixel."""
    f = np.asarray(frames)
    b = f.shape[0]
    zero = torch.zeros(b)
    prof = tgeom.CurvatureProfile(
        mean_curvature=zero, max_curvature=zero,
        spline_points=torch.zeros(b, 2, 3),
        valid=torch.ones(b, dtype=torch.bool),
        num_cloud_points=torch.zeros(b, dtype=torch.int32),
        num_edge_points=torch.zeros(b, dtype=torch.int32),
        truncated=torch.zeros(b, dtype=torch.bool))
    return tpipe.pack_analysis(tpipe.FrameAnalysis(
        mask=torch.from_numpy((f[..., 0] > 0).astype(np.uint8)),
        mask_coverage=torch.from_numpy(f[:, 0, 0, 0].astype(np.float32)),
        profile=prof, confidence_margin=zero), n_pts=2).numpy()


def _instrument_values(obs) -> dict:
    stages = ("admit", "stage_host", "h2d", "launch", "device", "d2h")
    return {
        "batch_size": (obs.BATCH_SIZE.count, obs.BATCH_SIZE.sum),
        "overlap": (obs.DISPATCH_OVERLAP.count, obs.DISPATCH_OVERLAP.sum),
        "stage": [obs.BATCH_STAGE_LATENCY.labels(stage=s).count
                  for s in ("stage", "launch", "complete")],
        "split": [obs.HOST_STAGE_SPLIT.labels(stage=s).count for s in stages],
        "sheds": [obs.SHED_BY_DEADLINE.labels(point=p).value
                  for p in ("evicted", "abandoned", "stale")],
        "restarts": obs.WATCHDOG_RESTARTS.value,
        "dispatches": obs.MODEL_DISPATCHES.labels(model="seg").value,
    }


def test_dispatcher_instruments_as_jax():
    """The same submissions, one at a time at ``max_inflight=1``, through
    both packages' dispatchers over a fake analyzer: the same instrument
    counts, and both gauges back at 0. (The JAX dispatcher stages a
    one-frame dispatch as views without a pooled set, so the staging
    pool's gauge is compared with the port's own free sets.)"""
    import jax.numpy as jnp

    k = np.eye(3, dtype=np.float32)
    frames = [np.full((8, 8, 3), v, np.uint8) for v in (3, 5, 7, 9)]
    frames.append(np.full((4, 8, 3), 11, np.uint8))  # another geometry
    deltas = []
    for mod, obs, analyze in (
            (batching, tobs, lambda f, d, i, s: torch.from_numpy(_rows(f))),
            (jbatching, jobs, lambda f, d, i, s: jnp.asarray(_rows(f)))):
        kw = {"device": "cpu"} if mod is batching else {}
        before = _instrument_values(obs)
        d = mod.BatchDispatcher(analyze, window_ms=1.0, max_batch=4,
                                max_inflight=1, watchdog_interval_s=0.0,
                                model_label="seg", **kw)
        try:
            for f in frames:
                res = d.submit(f, np.zeros(f.shape[:2], np.uint16), k, 0.001)
                assert int(res.scalars()[0]) == f[0, 0, 0]
                res.release()
            _wait_for(lambda: obs.INFLIGHT_DISPATCHES.value == 0,
                      "the window to empty")
            assert obs.BATCH_QUEUE_DEPTH.value == 0
            assert obs.EGRESS_POOL_SIZE.value == 2  # one per row shape
            if mod is batching:
                with d._pool_lock:
                    assert obs.BATCH_POOL_SIZE.value == sum(
                        len(v) for v in d._pool.values())
        finally:
            d.stop()
        after = _instrument_values(obs)
        deltas.append({key: (np.subtract(after[key], before[key]).tolist()
                             if key not in ("restarts", "dispatches")
                             else after[key] - before[key])
                       for key in after})
    assert deltas[0] == deltas[1]
    assert deltas[0]["batch_size"] == [5, 5]
    assert deltas[0]["overlap"] == [5, 0.0]
    assert deltas[0]["split"] == [5] * 6
