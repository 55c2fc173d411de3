"""Streaming client: a :class:`~io.frames.FrameSource` -> gRPC -> results
(the port of the JAX package's ``serving/client.py``).

It streams frames over the bidirectional ``AnalyzeActuatorPerformance``
call, smooths the curvature over a window of ``smoothing_window`` frames,
decodes packed mask payloads (``mask_format`` 1 and 2) and the
``packed_spline`` wire, and with ``display=True`` shows the returned mask
and the reprojected spline over each frame. Results come back as a list,
so tests, benchmarks and batch jobs use the same path headless.

Two differences from the JAX client:

- (a) ``cv2`` is imported only in the branches that need it: the
  ``"encoded"`` and ``"coef"`` request formats, :func:`overlay` and
  ``display``. The JAX client imports it before it looks at the format,
  so its ``"raw"`` wire needs ``cv2`` too.
- (b) :func:`run_client` and :func:`generate_requests` take ``fmt``
  (default ``"encoded"``, the JAX client's bytes) and pass it to
  :func:`encode_request`; ``fmt="raw"`` streams without ``cv2`` (a machine
  with a card but no ``cv2``).

And one repair: after a setup retry, the JAX client's failed call can
still draw a frame from the source and queue it after the retry cleared
the queue, so the reopened stream's results pair with the wrong frames
(``FrameResult.frame_bgr``, the overlay). Here each attempt draws and
queues its frames under a lock and only while it is the live attempt.

``grpc`` and the protobuf messages are imported where they are used, as in
``serving/grpc_service.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

from robotic_discovery_platform_tpu_torch.io.frames import (
    FrameSource,
    SyntheticSource,
    iter_frames,
    load_calibration,
)
from robotic_discovery_platform_tpu_torch.observability import trace
from robotic_discovery_platform_tpu_torch.resilience import (
    RetryPolicy,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
from robotic_discovery_platform_tpu_torch.utils.config import ClientConfig
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class FrameResult:
    mean_curvature: float
    max_curvature: float
    smoothed_mean: float
    smoothed_max: float
    status: str
    mask_coverage: float
    proc_time_ms: float
    #: the raw response ``mask`` payload (PNG bytes for mask_format 0; the
    #: packed-bits or RLE payload when the request asked for one)
    mask_png: bytes
    spline_points: np.ndarray  # [N, 3]
    frame_bgr: np.ndarray | None = None
    #: the decoded [H, W] uint8 0/1 mask of a packed payload
    #: (:func:`serving.egress.decode_mask_wire`); None for a PNG
    mask: np.ndarray | None = None


def encode_request(color_bgr: np.ndarray, depth: np.ndarray,
                   fmt: str = "encoded", model: str = "",
                   mask_format: int = 0):
    """One wire request (``vision_pb2.AnalysisRequest``) from a BGR frame
    and a z16 depth frame.

    ``fmt="encoded"``: a JPEG of the color and a PNG of the depth (lossy
    color, lossless depth), through ``cv2``. ``fmt="raw"``: RGB8 and
    little-endian z16 payloads (``Image.format = 1``), which the server
    maps as views of the wire bytes; no ``cv2``. ``fmt="coef"``: the color
    JPEG-encoded once (``cv2``), entropy-decoded here
    (``serving/entropy.py``) and sent as coefficient blocks
    (``Image.format = 2``), depth raw: the server decodes the pixels on
    the device, bit for bit what ``cv2.imdecode`` gives of that JPEG.

    ``model`` names a model of the server's zoo ("" = the default model:
    no extra wire bytes). ``mask_format`` selects the response's mask
    payload: 0 = PNG, 1 = packed bits, 2 = run lengths (the last two
    decode to the exact mask, and the spline rides ``packed_spline``)."""
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

    h, w = color_bgr.shape[:2]
    z16 = np.ascontiguousarray(depth, dtype="<u2")
    if fmt in ("raw", "coef"):
        if fmt == "raw":
            # BGR -> RGB: a channel permutation, equal to cv2.cvtColor's
            color = vision_pb2.Image(
                data=np.ascontiguousarray(color_bgr[..., ::-1]).tobytes(),
                width=w, height=h, format=ingest.FORMAT_RAW)
        else:
            import cv2

            from robotic_discovery_platform_tpu_torch.serving import entropy

            ok, jpg = cv2.imencode(".jpg", color_bgr)
            if not ok:
                raise ValueError("frame encode failed")
            color = vision_pb2.Image(
                data=entropy.pack_coefficients(
                    entropy.parse_jpeg(jpg.tobytes())),
                width=w, height=h, format=ingest.FORMAT_COEF)
        return vision_pb2.AnalysisRequest(
            color_image=color,
            depth_image=vision_pb2.Image(data=z16.tobytes(), width=w,
                                         height=h, format=ingest.FORMAT_RAW),
            model=model, mask_format=mask_format)
    if fmt != "encoded":
        raise ValueError(f"unknown request format {fmt!r}; "
                         "expected 'encoded', 'raw', or 'coef'")
    import cv2

    ok_c, jpg = cv2.imencode(".jpg", color_bgr)
    ok_d, png = cv2.imencode(".png", depth)
    if not (ok_c and ok_d):
        raise ValueError("frame encode failed")
    return vision_pb2.AnalysisRequest(
        color_image=vision_pb2.Image(data=jpg.tobytes(), width=w, height=h),
        depth_image=vision_pb2.Image(data=png.tobytes(), width=w, height=h),
        model=model, mask_format=mask_format)


def generate_requests(source: FrameSource, frame_queue: deque,
                      max_frames: int | None = None, mask_format: int = 0,
                      fmt: str = "encoded", lock=None,
                      live=lambda: True):
    """The requests of a started source's frames; each frame is queued in
    ``frame_queue`` for pairing with its response. With ``lock`` and
    ``live`` (:func:`run_client`'s attempts), a frame is drawn and queued
    under the lock and only while ``live()``."""
    lock = contextlib.nullcontext() if lock is None else lock
    frames = iter_frames(source, max_frames)
    while True:
        with lock:
            if not live():
                return
            pair = next(frames, None)
            if pair is None:
                return
            frame_queue.append(pair[0])
        yield encode_request(*pair, fmt=fmt, mask_format=mask_format)


def overlay(frame_bgr: np.ndarray, result: FrameResult,
            intrinsics: np.ndarray | None,
            dist: np.ndarray | None) -> np.ndarray:
    """Red mask blend, green reprojected spline, smoothed curvature text
    (``cv2``)."""
    import cv2

    vis = frame_bgr.copy()
    mask = None
    if result.mask is not None:
        mask = result.mask * np.uint8(255)
    elif result.mask_png:
        mask = cv2.imdecode(np.frombuffer(result.mask_png, np.uint8),
                            cv2.IMREAD_GRAYSCALE)
    if mask is not None and mask.shape == vis.shape[:2]:
        red = np.zeros_like(vis)
        red[..., 2] = mask
        vis = cv2.addWeighted(vis, 1.0, red, 0.4, 0)
    if intrinsics is not None and len(result.spline_points):
        pts, _ = cv2.projectPoints(
            result.spline_points.astype(np.float64), np.zeros(3),
            np.zeros(3), intrinsics, dist if dist is not None else np.zeros(5))
        cv2.polylines(vis, [pts.astype(np.int32).reshape(-1, 1, 2)], False,
                      (0, 255, 0), 2)
    cv2.putText(
        vis,
        f"mean k: {result.smoothed_mean:.3f}  max k: {result.smoothed_max:.3f}",
        (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
    return vis


def run_client(cfg: ClientConfig = ClientConfig(),
               source: FrameSource | None = None,
               max_frames: int | None = None,
               display: bool = False,
               channel=None,
               retry: RetryPolicy | None = None,
               mask_format: int = 0,
               fmt: str = "encoded") -> list[FrameResult]:
    """Stream frames and return one :class:`FrameResult` per response
    (``display=True`` opens the overlay window; 'q' quits).

    ``mask_format`` selects the response's mask payload (0 = PNG, 1 =
    packed bits, 2 = run lengths; the packed ones decode to
    ``FrameResult.mask``, and the spline is read off ``packed_spline``).
    ``fmt`` is the request wire of :func:`encode_request`. ``channel``
    defaults to an insecure channel to ``cfg.server_address``.

    The stream's setup retries through ``retry``: a retryable failure
    (UNAVAILABLE: the server restarting, its port not up yet) before the
    first response backs off and reopens the stream from frame 0 (the
    source restarted, the pairing queue and smoothing windows cleared).
    Once a response has arrived, a failure goes to the caller."""
    import grpc

    from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc

    source = source or SyntheticSource()
    retry = retry or RetryPolicy(max_attempts=3, base_delay_s=0.2,
                                 max_delay_s=2.0)
    intrinsics = dist = None
    try:
        intrinsics, dist, _ = load_calibration(cfg.calibration_path)
    except (FileNotFoundError, KeyError):
        if isinstance(source, SyntheticSource):
            intrinsics = source.intrinsics()
        log.warning("no calibration file at %s", cfg.calibration_path)

    own_channel = channel is None
    if channel is None:
        channel = grpc.insecure_channel(cfg.server_address)
    stub = vision_grpc.VisionAnalysisServiceStub(channel)

    frame_queue: deque = deque(maxlen=cfg.frame_queue_len)
    mean_window: deque = deque(maxlen=cfg.smoothing_window)
    max_window: deque = deque(maxlen=cfg.smoothing_window)
    results: list[FrameResult] = []
    # the live attempt: a failed call's request thread may still pull from
    # its generator, which then draws nothing once a retry moved this on
    live_attempt = [0]
    attempt_lock = threading.Lock()

    source.start()

    def stream_once():
        inject(fault_sites.CLIENT_STREAM)
        # one stream, one trace: the span's traceparent rides the call
        # metadata and the server adopts it (a retried stream gets a new
        # trace)
        with trace.span("client.stream") as sp:
            log.info("streaming to %s", cfg.server_address)
            this = live_attempt[0]
            responses = stub.AnalyzeActuatorPerformance(
                generate_requests(source, frame_queue, max_frames,
                                  mask_format=mask_format, fmt=fmt,
                                  lock=attempt_lock,
                                  live=lambda: live_attempt[0] == this),
                metadata=trace.to_metadata(sp.context))
            for response in responses:
                frame = frame_queue.popleft() if frame_queue else None
                mean_window.append(response.mean_curvature)
                max_window.append(response.max_curvature)
                if response.packed_spline:
                    spline = egress.decode_spline_wire(response.packed_spline)
                else:
                    spline = np.array(
                        [[p.x, p.y, p.z] for p in response.spline_points]
                    ).reshape(-1, 3)
                result = FrameResult(
                    mean_curvature=response.mean_curvature,
                    max_curvature=response.max_curvature,
                    smoothed_mean=float(np.mean(mean_window)),
                    smoothed_max=float(np.mean(max_window)),
                    status=response.status,
                    mask_coverage=response.mask_coverage,
                    proc_time_ms=response.proc_time_ms,
                    mask_png=response.mask,
                    spline_points=spline,
                    frame_bgr=frame,
                    mask=egress.decode_mask_wire(response.mask),
                )
                results.append(result)
                if display and frame is not None:
                    import cv2

                    cv2.imshow("Actuator Analysis",
                               overlay(frame, result, intrinsics, dist))
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break

    def setup_retryable(exc: BaseException) -> bool:
        # only failures before the first response, and only those the
        # policy itself would retry
        return not results and retry.retryable(exc)

    def on_retry(attempt: int, exc: BaseException, delay: float) -> None:
        code = exc.code() if hasattr(exc, "code") else exc
        log.warning("stream setup to %s failed (%s); retry %d in %.2fs",
                    cfg.server_address, code, attempt, delay)
        # the reopened stream starts again from frame 0
        with attempt_lock:
            live_attempt[0] += 1
            frame_queue.clear()
            mean_window.clear()
            max_window.clear()
            source.start()

    try:
        dataclasses.replace(retry, retryable=setup_retryable).call(
            stream_once, on_retry=on_retry, name="client.stream")
    except grpc.RpcError as exc:
        log.error("rpc failed (%s) -- is the server running at %s?",
                  exc.code() if hasattr(exc, "code") else exc,
                  cfg.server_address)
        raise
    finally:
        source.stop()
        if display:
            import cv2

            cv2.destroyAllWindows()
        if own_channel:
            channel.close()
    return results


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.utils.config import parse_config

    run_client(parse_config().client, display=True)
