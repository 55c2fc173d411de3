"""The port's streaming client (serving/client.py) and frame sources
(io/frames.py) on the CPU against the JAX package's: ``encode_request``
bytes for the three request wires, ``run_client`` over the same recorded
response stream through a fake channel (every ``FrameResult`` field, the
traceparent on the call metadata), the setup retry that restarts the
source from frame 0, and the replay source and ``iter_frames``.

Tolerances, fixed before measuring: none. Request bytes, results and
frames are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.io import frames as jframes
from robotic_discovery_platform_tpu.resilience import (
    RetryPolicy as JaxRetryPolicy,
)
from robotic_discovery_platform_tpu.resilience import (
    configure_faults as jconfigure_faults,
)
from robotic_discovery_platform_tpu.serving import client as jclient
from robotic_discovery_platform_tpu.utils.config import (
    ClientConfig as JaxClientConfig,
)
from robotic_discovery_platform_tpu_torch.io import frames as tframes
from robotic_discovery_platform_tpu_torch.resilience import (
    RetryPolicy,
    configure_faults,
)
from robotic_discovery_platform_tpu_torch.serving import client as tclient
from robotic_discovery_platform_tpu_torch.serving import egress
from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2
from robotic_discovery_platform_tpu_torch.utils import config

grpc = pytest.importorskip("grpc")
H, W, N = 48, 64, 6


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


class _Unavailable(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE


class _Channel:
    """A fake channel: the stream answers its i-th request with the i-th
    recorded response (serialized bytes, read back by the stub's own
    deserializer); the first ``fail_after`` requests of the first call end
    in UNAVAILABLE before any response."""

    def __init__(self, responses: list, fail_after: int | None = None):
        self.responses, self.fail_after = responses, fail_after
        self.calls: list = []  # (requests sent, metadata) per call

    def stream_stream(self, path, request_serializer, response_deserializer):
        def call(request_iterator, metadata=None):
            attempt = len(self.calls)
            sent: list = []
            self.calls.append((sent, metadata))

            def responses():
                for i, request in enumerate(request_iterator):
                    sent.append(request_serializer(request))
                    if (attempt == 0 and self.fail_after is not None
                            and i + 1 == self.fail_after):
                        raise _Unavailable()
                    if (attempt == 0 and self.fail_after is not None):
                        continue
                    yield response_deserializer(self.responses[i])

            return responses()

        return call

    def close(self):
        pass


def _responses(mask_format: int) -> list:
    """A recorded response stream in ``mask_format``'s wire: masks, and the
    spline as points (format 0) or ``packed_spline``; one degraded frame."""
    rng = np.random.default_rng(10 + mask_format)
    out = []
    for i in range(N):
        mask = (rng.random((H, W)) > 0.5).astype(np.uint8)
        spline = rng.normal(size=(5, 3)).astype(np.float32)
        valid = i != 3
        msg = vision_pb2.AnalysisResponse(
            mean_curvature=float(rng.random()) if valid else 0.0,
            max_curvature=float(rng.random()) if valid else 0.0,
            status="OK" if valid else "DEGRADED: insufficient geometry",
            mask=egress.encode_mask(mask, mask_format),
            mask_coverage=float(mask.mean() * 100),
            proc_time_ms=float(rng.random() * 10))
        if valid and mask_format:
            msg.packed_spline = spline.astype("<f4").tobytes()
        elif valid:
            msg.spline_points.extend(vision_pb2.Point3D(
                x=float(p[0]), y=float(p[1]), z=float(p[2])) for p in spline)
        out.append(msg.SerializeToString())
    return out


def _same_results(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
                assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            else:
                assert a == b, f.name


def _run(mod, channel, tmp_path, **kw):
    cfg_cls = config.ClientConfig if mod is tclient else JaxClientConfig
    policy = RetryPolicy if mod is tclient else JaxRetryPolicy
    source_cls = (tframes.SyntheticSource if mod is tclient
                  else jframes.SyntheticSource)
    return mod.run_client(
        cfg_cls(calibration_path=str(tmp_path / "none.npz")),
        source=source_cls(W, H, seed=1, n_frames=N), channel=channel,
        retry=policy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                     sleep=lambda s: None), **kw)


def test_client_config_is_the_jax_section():
    assert dataclasses.asdict(config.ClientConfig()) == dataclasses.asdict(
        JaxClientConfig())
    cfg = config.parse_config(["--client.smoothing_window", "3"])
    assert cfg.client.smoothing_window == 3
    assert config.from_dict(config.PlatformConfig, {
        "client": {"server_address": "h:1"}}).client.server_address == "h:1"


@pytest.mark.parametrize("fmt", ["encoded", "raw", "coef"])
def test_encode_request_bytes_equal_jax(fmt):
    for seed in range(2):
        rng = np.random.default_rng(seed)
        bgr = rng.integers(0, 255, (H, W, 3), np.uint8)
        depth = rng.integers(0, 5000, (H, W)).astype(np.uint16)
        for mask_format in (0, 1, 2):
            got = tclient.encode_request(bgr, depth, fmt=fmt,
                                         mask_format=mask_format)
            want = jclient.encode_request(bgr, depth, fmt=fmt,
                                          mask_format=mask_format)
            assert got.SerializeToString() == want.SerializeToString()
    with pytest.raises(ValueError, match="unknown request format"):
        tclient.encode_request(bgr, depth, fmt="png")


@pytest.mark.parametrize("mask_format", [0, 1, 2])
def test_run_client_results_equal_jax(mask_format, tmp_path):
    """The same recorded responses through both clients (the JAX client
    sends its "encoded" wire; the port's sends it too by default, and
    "raw" on request): equal results, and requests equal to the wire's."""
    recorded = _responses(mask_format)
    results = []
    for mod in (tclient, jclient):
        channel = _Channel(recorded)
        results.append(_run(mod, channel, tmp_path, mask_format=mask_format))
        (sent, metadata), = channel.calls
        assert len(sent) == N
        assert any(k == "traceparent" for k, _ in metadata)
        results.append([vision_pb2.AnalysisRequest.FromString(s)
                        for s in sent])
    got, got_sent, want, want_sent = results
    _same_results(got, want)
    assert got_sent == want_sent
    assert [r.mask is None for r in got] == [mask_format == 0] * N
    raw = _Channel(recorded)
    _same_results(_run(tclient, raw, tmp_path, mask_format=mask_format,
                       fmt="raw"), want)
    sent = [vision_pb2.AnalysisRequest.FromString(s) for s in raw.calls[0][0]]
    assert {(r.color_image.format, r.depth_image.format) for r in sent} == {
        (1, 1)}


def test_setup_retry_restarts_from_frame_zero(tmp_path):
    """UNAVAILABLE before the first response: the stream reopens with the
    source restarted, and the results are those of an unbroken stream, in
    both clients."""
    recorded = _responses(1)
    unbroken = _run(tclient, _Channel(recorded), tmp_path, mask_format=1)
    for mod in (tclient, jclient):
        channel = _Channel(recorded, fail_after=2)
        got = _run(mod, channel, tmp_path, mask_format=1)
        assert len(channel.calls) == 2
        first, second = channel.calls[0][0], channel.calls[1][0]
        assert second[:2] == first  # the reopened stream starts at frame 0
        _same_results(got, unbroken)
    # a failure after the first response goes to the caller
    broken = _Channel(recorded)

    def failing(path, request_serializer, response_deserializer):
        def call(request_iterator, metadata=None):
            def responses():
                for i, request in enumerate(request_iterator):
                    if i == 1:
                        raise _Unavailable()
                    yield response_deserializer(recorded[i])
            return responses()
        return call

    broken.stream_stream = failing
    with pytest.raises(grpc.RpcError):
        _run(tclient, broken, tmp_path, mask_format=1)


def test_a_failed_call_draws_no_frame_after_the_retry(tmp_path):
    """A failed call's request thread that pulls from its generator after
    the retry restarted the source gets nothing: the reopened stream
    gets every frame from 0, and each result pairs with its own frame."""
    recorded = _responses(2)
    stale: list = []

    class Racing(_Channel):
        def stream_stream(self, path, request_serializer,
                          response_deserializer):
            inner = super().stream_stream(path, request_serializer,
                                          response_deserializer)

            def call(request_iterator, metadata=None):
                if not self.calls:
                    stale.append(request_iterator)
                    next(request_iterator)  # one frame drawn, then down
                    self.calls.append(([], metadata))
                    raise _Unavailable()
                # the dead call's thread pulls again, now the retry ran
                stale.append(list(stale[0]))
                return inner(request_iterator, metadata)

            return call

    got = _run(tclient, Racing(recorded), tmp_path, mask_format=2)
    assert stale[1] == []
    source = tframes.SyntheticSource(W, H, seed=1, n_frames=N)
    source.start()
    frames = [color for color, _ in tframes.iter_frames(source)]
    assert len(got) == N
    for result, color in zip(got, frames):
        np.testing.assert_array_equal(result.frame_bgr, color)


def test_client_stream_fault_site(tmp_path):
    """``client.stream`` fires before each stream: an UNAVAILABLE-like
    connection fault there is retried as a setup failure."""
    configure_faults("client.stream:conn:1")
    channel = _Channel(_responses(0))
    got = _run(tclient, channel, tmp_path)
    assert len(got) == N and len(channel.calls) == 1


def test_frame_sources_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    ours = tframes.SyntheticSource(W, H, seed=2, n_frames=3)
    theirs = jframes.SyntheticSource(W, H, seed=2, n_frames=3)
    for src in (ours, theirs):
        src.start()
    got = list(tframes.iter_frames(ours))
    want = list(jframes.iter_frames(theirs))
    assert len(got) == len(want) == 3
    for (gc, gd), (wc, wd) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gd, wd)
    # a collection directory, replayed by both sources
    (tmp_path / "color").mkdir()
    (tmp_path / "depth").mkdir()
    for i, (color, depth) in enumerate(got):
        cv2.imwrite(str(tmp_path / "color" / f"{i:03d}.png"), color)
        np.save(tmp_path / "depth" / f"{i:03d}.npy", depth)
    for loop in (False, True):
        replays = [mod.ReplaySource(tmp_path, loop=loop)
                   for mod in (tframes, jframes)]
        for r in replays:
            r.start()
        a, b = (list(mod.iter_frames(r, max_frames=5))
                for mod, r in zip((tframes, jframes), replays))
        assert len(a) == len(b) == (5 if loop else 3)
        for (ac, ad), (bc, bd), (c, d) in zip(a, b, got + got):
            np.testing.assert_array_equal(ac, bc)
            np.testing.assert_array_equal(ad, bd)
            np.testing.assert_array_equal(ac, c)
            assert ad.dtype == np.uint16
    with pytest.raises(FileNotFoundError):
        tframes.ReplaySource(tmp_path / "color")
    # the camera's library is imported at construction, as in JAX
    for mod in (tframes, jframes):
        with pytest.raises(ImportError):
            mod.RealSenseSource()
