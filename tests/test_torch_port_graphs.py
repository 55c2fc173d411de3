"""The port's one-program dispatch on the CPU: the capture guard
(``analysis/recompile.py``) against the JAX package's ``trace_guard``, the
capture helper's launch arithmetic (``ops/graphs.py``), and the direct
servicer's fields off one packed readback.

A CUDA graph captures only on the card (chip_smoke.py holds replays
against eager runs there, bit for bit); here the analyzers run eagerly and
count one capture per new static shape, as the card does.

Tolerances: none. Counts, over-budget reports and launch counts are
integers and compared exactly; the servicer's fields come from one
float32 computation and are compared bit for bit.
"""

import contextlib
import logging
import threading

import jax
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.analysis import recompile as jrecompile
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from robotic_discovery_platform_tpu_torch.analysis import recompile
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models.weights import (
    unet_from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops import conv, decode, graphs
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import egress
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ModelConfig,
    ServerConfig,
)

SIZE = 16
# frame shapes (H, W) in call order: A, A, B, A, then a third geometry
SHAPES = [(24, 32), (24, 32), (32, 24), (24, 32), (16, 40)]


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


@pytest.fixture(scope="module")
def model():
    jmodel = build_unet(JaxModelConfig(base_features=4,
                                       compute_dtype="float32"))
    variables = jax.device_get(jax.jit(
        lambda key: init_unet(jmodel, key, SIZE))(jax.random.key(0)))
    net = unet_from_flax_variables(
        ModelConfig(base_features=4, compute_dtype="float32"), variables)
    return jmodel, variables, FoldedUNet(net, device="cpu")


def _frame(shape, seed):
    rgb, _, depth = render_scene(np.random.default_rng(seed), *shape)
    return rgb, depth, default_intrinsics(shape[1], shape[0]).astype(
        np.float32)


def _counts(snapshot: dict, name: str) -> list:
    return [e["traces"] for e in snapshot.get(name, [])]


def test_capture_guard_counts_as_the_trace_guard(model):
    """The same frame shapes through the port's CPU analyzer and the JAX
    package's jitted analyzer: equal capture and trace counts after every
    call, and equal over-budget reports (the third geometry passes the
    budget of 2 in both)."""
    jmodel, variables, folded = model
    jrecompile.reset()
    recompile.reset()
    janalyze = jpipe.make_frame_analyzer(
        jmodel, img_size=SIZE, geom_cfg=JaxGeometryConfig(kernel_impl="xla"))
    tanalyze = tpipe.make_frame_analyzer(
        folded, img_size=SIZE, geom_cfg=GeometryConfig(kernel_impl="xla"),
        device="cpu")
    got, want = [], []
    for i, shape in enumerate(SHAPES):
        rgb, depth, k = _frame(shape, i)
        janalyze(variables, rgb, depth, k, np.float32(0.001))
        tanalyze(rgb, depth, k, 0.001)
        want.append(_counts(jrecompile.snapshot(), "pipeline.frame_analyzer"))
        got.append(_counts(recompile.snapshot(), "pipeline.frame_analyzer"))
    assert got == want == [[1], [1], [2], [2], [3]]
    assert recompile.over_budget() == jrecompile.over_budget() == {
        "pipeline.frame_analyzer": 1}
    assert recompile.total_traces("pipeline.frame_analyzer") == 3
    stats, = recompile.stats_for("pipeline.frame_analyzer")
    assert stats.effective_budget == 2
    assert stats.shapes[0] == "(uint8[1, 24, 32, 3], int16[1, 24, 32], " \
        "float32[1, 3, 3], float32[1])"
    jrecompile.reset()
    recompile.reset()


@pytest.mark.parametrize("strict", [False, True])
def test_capture_guard_warns_or_raises_past_its_budget(strict, caplog):
    """Past its budget a guard warns, or under strict mode raises, at the
    capture that passes it; the counts and report are the JAX guard's."""
    recompile.reset()
    guard = recompile.capture_guard("pipeline.batch_analyzer", budget=2)
    caplog.set_level(logging.WARNING)
    ctx = recompile.strict() if strict else contextlib.nullcontext()
    with ctx:
        guard.count("(a)")
        guard.count("(b)")
        assert recompile.over_budget() == {}
        if strict:
            with pytest.raises(recompile.RecompileBudgetExceeded,
                               match="capture 3 > budget 2"):
                guard.count("(c)")
        else:
            guard.count("(c)")
            assert "capture 3 > budget 2" in caplog.text
    assert recompile.over_budget() == {"pipeline.batch_analyzer": 1}
    assert recompile.snapshot()["pipeline.batch_analyzer"] == [
        {"traces": 3, "budget": 2, "shapes": ["(a)", "(b)", "(c)"]}]
    recompile.reset()
    assert recompile.snapshot() == {} and recompile.over_budget() == {}


def test_analyzers_declare_the_jax_budgets(model):
    """Each analyzer's guard carries the JAX package's name and budget."""
    _, _, folded = model
    made = {
        "pipeline.frame_analyzer": [
            tpipe.make_frame_analyzer(folded, img_size=SIZE, device="cpu"),
            tpipe.make_coef_frame_analyzer(folded, img_size=SIZE,
                                           device="cpu")],
        "pipeline.batch_analyzer": [
            tpipe.make_batch_analyzer(folded, img_size=SIZE, device="cpu")],
        "pipeline.coef_batch_analyzer": [
            tpipe.make_coef_batch_analyzer(folded, img_size=SIZE,
                                           device="cpu", height=16,
                                           width=16)],
    }
    budgets = {"pipeline.frame_analyzer": 2, "pipeline.batch_analyzer": 8,
               "pipeline.coef_batch_analyzer": 8}
    for name, analyzers in made.items():
        for a in analyzers:
            assert a.graphs.guard.name == name
            assert a.graphs.guard.stats.effective_budget == budgets[name]


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeStream:
    """Stands in for a ``torch.cuda.Stream``: its handle."""

    def __init__(self, handle: int):
        self.cuda_stream = handle


#: the capture stream of the fake captures
CAPTURE = _FakeStream(1)


@pytest.fixture
def fake_capture(monkeypatch):
    """``torch.cuda.graph`` as a plain context (the body runs once, as a
    capture records it once), a fake graph, and each thread's current
    stream a handle it sets in ``stream.handle`` (default: the capture
    stream's): the capture helper's arithmetic on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    for fn in graphs.launch_counters():
        monkeypatch.setattr(fn, "launches", 0)
    stream = threading.local()
    monkeypatch.setattr(graphs, "_current_stream_key",
                        lambda: getattr(stream, "handle", 1))
    return stream


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_capture_launches_are_the_capture_delta_times_replays(fake_capture,
                                                              replays):
    """The wrappers' counts during a capture are taken back (nothing ran),
    and every replay adds each wrapper's launches of the captured call:
    after N replays each count is N times its capture delta."""
    conv.conv1x1.launches = 7  # launches before the capture stay

    def step():
        for _ in range(18):
            graphs.count_launch(conv.conv3x3_bn_relu)
        graphs.count_launch(conv.conv1x1)
        for _ in range(3):
            graphs.count_launch(decode.dequant_idct)
        return "out"

    cap = graphs.Capture(step, CAPTURE)
    assert conv.conv3x3_bn_relu.launches == 0 and conv.conv1x1.launches == 7
    assert cap.outputs == "out"
    for _ in range(replays):
        assert cap.replay() == "out"
    assert cap.graph.replays == replays
    assert conv.conv3x3_bn_relu.launches == 18 * replays
    assert conv.conv1x1.launches == 7 + replays
    assert decode.dequant_idct.launches == 3 * replays
    assert conv.conv_transpose2x2.launches == 0


def test_failed_capture_raises_and_takes_its_launches_back(fake_capture):
    def step():
        for _ in range(18):
            graphs.count_launch(conv.conv3x3_bn_relu)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.Capture(step, CAPTURE)
    assert conv.conv3x3_bn_relu.launches == 0
    graphs.count_launch(conv.conv1x1)  # the record closed with the capture
    assert conv.conv1x1.launches == 1 and graphs._recording == {}


def test_capture_delta_holds_the_launches_onto_its_stream(fake_capture):
    """Launches onto the capture stream are the graph's from any thread
    (a captured backward runs on autograd's thread, on the forward's
    stream); another thread's launches onto its own stream during the
    capture ran: they stay in the counts and out of the delta."""
    started = threading.Event()

    def other_stream():
        fake_capture.handle = 2
        started.wait()
        for _ in range(5):
            graphs.count_launch(conv.conv1x1)

    def capture_stream():  # autograd's thread, on the forward's stream
        started.wait()
        graphs.count_launch(conv.conv3x3_grad_weights)

    def step():
        started.set()
        for t in threads:
            t.join()  # the other threads launch mid-capture
        graphs.count_launch(conv.conv3x3_bn_relu)
        return "out"

    threads = [threading.Thread(target=fn)
               for fn in (other_stream, capture_stream)]
    for t in threads:
        t.start()
    cap = graphs.Capture(step, CAPTURE)
    assert dict(cap.launches) == {conv.conv3x3_grad_weights: 1,
                                  conv.conv3x3_bn_relu: 1}
    assert conv.conv1x1.launches == 5 and conv.conv3x3_bn_relu.launches == 0
    assert conv.conv3x3_grad_weights.launches == 0
    cap.replay()
    assert (conv.conv1x1.launches, conv.conv3x3_bn_relu.launches,
            conv.conv3x3_grad_weights.launches) == (5, 1, 1)


def test_graph_cache_on_the_cpu_counts_one_capture_per_key():
    """On the CPU the cache runs ``fn`` eagerly on every call, counts one
    capture per new (static, shapes, dtypes) key, and returns ``finish``
    of its outputs."""
    recompile.reset()
    cache = graphs.GraphCache("pipeline.batch_analyzer", 8,
                              torch.device("cpu"))
    calls = []

    def fn(x, y):
        calls.append(x.shape)
        return x.to(torch.float32) + y

    a = np.ones((2, 3), np.uint8)
    out = cache(fn, a, torch.zeros(3), finish=graphs.clone)
    assert torch.equal(out, torch.ones(2, 3))
    cache(fn, a, torch.zeros(3), finish=graphs.clone)
    cache(fn, np.ones((4, 3), np.uint8), torch.zeros(3), finish=graphs.clone)
    cache(fn, np.ones((4, 3), np.int16), torch.zeros(3), finish=graphs.clone)
    cache(fn, a, torch.zeros(3), static=("420",), finish=graphs.clone)
    row = cache(fn, a, torch.zeros(3), finish=graphs.read_back)
    assert isinstance(row, np.ndarray) and row.shape == (2, 3)
    assert len(calls) == 6
    assert recompile.total_traces("pipeline.batch_analyzer") == 4
    recompile.reset()


def test_step_graph_on_the_cpu_runs_every_step_and_counts_once():
    recompile.reset()
    guard = recompile.capture_guard("trainer.train_epoch", 2)
    steps = []
    step = graphs.StepGraph(lambda: steps.append(1), guard,
                            torch.device("cpu"))
    for _ in range(4):
        step()
    assert len(steps) == 4 and guard.stats.traces == 1
    recompile.reset()


@pytest.mark.parametrize("mask_format", [0, 1, 2])
def test_direct_servicer_fields_equal_one_packed_readback(model, tmp_path,
                                                          mask_format):
    """The direct path's response fields are those read off the frame's
    packed row, and equal the fields the unpacked analyzer gives (the
    values the old three device-to-host reads took)."""
    _, _, folded = model
    h, w = 48, 64
    rgb, depth, k = _frame((h, w), 3)
    service = VisionAnalysisService(
        folded, cfg=ServerConfig(model_img_size=SIZE,
                                 metrics_csv=str(tmp_path / "m.csv")),
        device="cpu")
    got = service.analyze_frame(rgb, depth, mask_format)
    service.close()

    row = tpipe.make_frame_analyzer(folded, img_size=SIZE, device="cpu",
                                    pack=True)(rgb, depth, k, 0.001)
    assert row.ndim == 1 and row.dtype == np.uint8
    packed = egress.PackedResult(row)
    coverage, mean_k, max_k, valid, _ = packed.scalars()
    assert (got.coverage, got.mean_k, got.max_k, got.valid) == (
        coverage, mean_k, max_k, valid)

    out = tpipe.make_frame_analyzer(folded, img_size=SIZE,
                                    device="cpu")(rgb, depth, k, 0.001)
    prof = out.profile
    scalars = torch.stack([out.mask_coverage, prof.mean_curvature,
                           prof.max_curvature,
                           prof.valid.to(torch.float32)]).numpy()
    want_valid = bool(scalars[3])
    assert got.valid == want_valid
    assert got.coverage == float(scalars[0])
    assert (got.mean_k, got.max_k) == ((float(scalars[1]), float(scalars[2]))
                                       if want_valid else (0.0, 0.0))
    spline = (prof.spline_points.numpy() if want_valid
              else np.zeros((0, 3), np.float32))
    assert got.mask_bytes == egress.encode_mask(out.mask.numpy(),
                                                mask_format)
    if mask_format:
        assert got.spline_wire == np.ascontiguousarray(spline,
                                                       "<f4").tobytes()
        assert got.spline.shape == (0, 3)
    else:
        assert got.spline_wire == b""
        np.testing.assert_array_equal(got.spline, spline)
