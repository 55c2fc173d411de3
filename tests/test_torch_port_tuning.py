"""The port's tuning table (ops/tuning.py), what consults it (the folded
forward's 3x3 launches) and what does not (the geometry stages, the mask
pack and the IDCT), and the tuning tool's pure parts
(tools/tune_kernels.py), on the CPU.

- ``key`` and ``op_key`` give the JAX package's strings (the conv key
  without its batch: a split keyed by batch would give a frame other
  bits in a batch than alone);
- ``lookup`` ignores, and never raises for, any entry the launch could
  not take; ``candidates`` lists every split the launch takes, within the
  workspace cap, ``fwd_plan``'s first;
- ``lookup_impl`` reads a path entry as the JAX package does, but no
  launch of the port consults one: the geometry stages keep
  ``kernel_impl`` as their one switch, and every path entry is logged
  once when the table is read;
- with no table file every launch of the folded forward takes
  ``fwd_plan``'s split (the wrapper is handed None), and a table's valid
  entries reach the launches of their shapes.

Tolerances, fixed before measuring: none. Keys, splits, paths and the
profiles of the forced paths are compared exactly.
"""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops.pallas import tuning as jtuning
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.ops import conv, geometry, pack
from robotic_discovery_platform_tpu_torch.ops import decode, tuning
from robotic_discovery_platform_tpu_torch.ops import unet_infer
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ModelConfig,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import tune_kernels  # noqa: E402

SERVING = tune_kernels.serving_shapes()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def table(monkeypatch, tmp_path):
    """Point the table at a temporary file (as the JAX package's tests
    do); yields a writer of its entries."""
    monkeypatch.setattr(tuning, "_TUNE_PATH", tmp_path / "CUDA_TUNE.json")
    tuning.invalidate_cache()

    def write(entries):
        tuning.save_entries(entries, meta={"test": True})

    yield write
    tuning.invalidate_cache()


def test_key_strings_against_jax():
    for h, w, cin, cout in SERVING:
        for batch in (1, 4, 8):
            for dtype in ("bfloat16", "float32"):
                jkey = jtuning.key(h, w, cin, cout, batch=batch, dtype=dtype)
                assert tuning.key(h, w, cin, cout, batch=batch,
                                  dtype=dtype) == jkey.replace(
                                      f"b{batch}:", "")
    assert tuning.key(32, 32, 512, 512) == "conv3x3:32x32:512->512:bfloat16"
    for op, dims in (("deproject", dict(h=480, w=640, stride=1)),
                     ("bspline_design", dict(n=6400, c=16)),
                     ("bspline_curvature", dict(n=100, c=16)),
                     ("mask_pack", dict(b=8, h=480, w=640)),
                     ("jpeg_idct", dict(b=1, n=4800))):
        assert tuning.op_key(op, **dims) == jtuning.op_key(op, **dims)


def test_the_table_is_the_ports_own_and_not_committed():
    assert tuning._TUNE_PATH == REPO / "CUDA_TUNE.json"
    assert tuning._TUNE_PATH.name != jtuning._TUNE_PATH.name
    assert not (REPO / "CUDA_TUNE.json").exists()


# the bad entries of one shape, (32, 32, 512, 512): 4 K-split candidates
# within the cap at FWD_CAP_BATCH frames, 32 K chunks
BAD_ENTRIES = {
    "zero": {"splits": 0},
    "negative": {"splits": -2},
    "over_the_chunks": {"splits": 33},
    "over_the_workspace": {"splits": 5},
    "float": {"splits": 2.0},
    "string": {"splits": "2"},
    "bool": {"splits": True},
    "missing": {"ms": 1.0},
    "not_a_dict": 2,
}


@pytest.mark.parametrize("kind", sorted(BAD_ENTRIES))
def test_lookup_ignores_bad_entries(table, kind):
    k = tuning.key(32, 32, 512, 512)
    table({k: BAD_ENTRIES[kind]})
    assert tuning.lookup(32, 32, 512, 512) is None


def test_lookup_takes_a_valid_entry_for_any_batch(table):
    table({tuning.key(32, 32, 512, 512): {"splits": 3, "ms": 0.01},
           tuning.key(32, 32, 512, 512, dtype="float32"): {"splits": 2}})
    for batch in (1, 4, 8):
        assert tuning.lookup(32, 32, 512, 512, batch=batch) == 3
    # the float32 path has no split: its entry is ignored
    assert tuning.lookup(32, 32, 512, 512, dtype="float32") is None
    assert tuning.lookup(16, 16, 512, 512) is None  # no entry


def test_a_broken_table_file_is_no_table(table):
    tuning._TUNE_PATH.write_text("{not json")
    tuning.invalidate_cache()
    assert tuning.lookup(32, 32, 512, 512) is None
    tuning._TUNE_PATH.write_text(json.dumps({"entries": [1, 2]}))
    tuning.invalidate_cache()
    assert tuning.lookup(32, 32, 512, 512) is None
    assert tuning.lookup_impl("deproject", h=1, w=1, stride=1) is None


@pytest.mark.parametrize("shape", SERVING + [(37, 53, 3, 24), (8, 8, 40, 8)])
def test_candidates_are_feasible_with_the_heuristic_first(shape):
    h, w, cin, cout = shape
    cands = tuning.candidates(h, w, cin, cout)
    assert cands[0] == conv.fwd_plan(1, h, w, cin, cout)[0]
    assert len(cands) == len(set(cands))
    per_split = conv.FWD_CAP_BATCH * h * w * cout * 4
    feasible = [s for s in range(1, conv.fwd_k_chunks(cin) + 1)
                if s == 1 or s * per_split <= conv.FWD_WORKSPACE_CAP]
    assert sorted(cands) == feasible
    for s in cands:  # every candidate is an entry lookup takes
        tuning._cache = {tuning.key(h, w, cin, cout): {"splits": s}}
        assert tuning.lookup(h, w, cin, cout) == s
    tuning.invalidate_cache()


@pytest.mark.parametrize("entry,want", [
    ({"impl": "pallas"}, "pallas"), ({"impl": "xla"}, "xla"),
    ({"impl": "gpu"}, None), ("pallas", None), ({}, None)])
def test_lookup_impl_matches_jax(monkeypatch, entry, want):
    key = tuning.op_key("deproject", h=480, stride=1, w=640)
    monkeypatch.setattr(tuning, "_cache", {key: entry})
    monkeypatch.setattr(jtuning, "_cache", {key: entry})
    got = tuning.lookup_impl("deproject", h=480, stride=1, w=640)
    assert got == want == jtuning.lookup_impl("deproject", h=480, stride=1,
                                              w=640)


def _profile_inputs():
    rng = np.random.default_rng(4)
    _, mask, depth = render_scene(rng, 120, 160)
    return (torch.from_numpy(np.asarray(mask, np.uint8)),
            torch.from_numpy(np.asarray(depth, np.float32)),
            torch.from_numpy(default_intrinsics(160, 120)), 0.001)


def test_geometry_stages_ignore_the_table(table, monkeypatch):
    """Path entries for every stage move none: under "auto" the
    deprojection, the design contractions and the curvature each run
    their kernel function, and "xla" runs none, as with no table; the
    profiles are those of the tableless runs."""
    from robotic_discovery_platform_tpu_torch.ops import geometry_kernels

    calls = []
    for name in ("deproject_edge_stats", "bspline_design",
                 "bspline_curvature"):
        fn = getattr(geometry_kernels, name)
        monkeypatch.setattr(geometry_kernels, name,
                            lambda *a, _n=name, _f=fn, **k: (
                                calls.append(_n), _f(*a, **k))[1])
    cfg = GeometryConfig()
    mask, depth, k, scale = _profile_inputs()

    def run(impl="auto"):
        calls.clear()
        out = geometry.compute_curvature_profile(
            mask, depth, k, scale, GeometryConfig(kernel_impl=impl))
        return [t.numpy() for t in out], sorted(calls)

    everything = ["bspline_curvature", "bspline_design",
                  "deproject_edge_stats"]
    fused, got = run()
    assert got == everything
    plain, got = run("xla")
    assert got == []
    for impl in ("xla", "pallas"):
        table({tuning.op_key("deproject", h=120, w=160, stride=cfg.stride):
               {"impl": impl},
               tuning.op_key("bspline_design",
                             n=cfg.num_bins * cfg.max_per_bin,
                             c=cfg.num_ctrl): {"impl": impl},
               tuning.op_key("bspline_curvature", n=cfg.num_samples,
                             c=cfg.num_ctrl): {"impl": impl}})
        auto, got = run()
        assert got == everything
        assert all(np.array_equal(a, b) for a, b in zip(auto, fused))
        pinned, got = run("xla")
        assert got == []
        assert all(np.array_equal(a, b) for a, b in zip(pinned, plain))


def test_path_entries_are_logged_once_when_read(table, caplog):
    """Every path entry (a geometry stage, the mask pack, the IDCT) is
    logged once when the table is read, none when the cached table is
    used again, and the mask pack and the IDCT give what they give with
    no table; a conv entry is not logged."""
    mask = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (2, 9, 13), dtype=np.uint8))
    coefs = torch.from_numpy(np.random.default_rng(2).integers(
        -50, 50, (1, 6, 64), dtype=np.int16))
    q = torch.ones((1, 64), dtype=torch.int32)
    want_bits = pack.bitpack_mask(mask)
    want_idct = decode.dequant_idct(coefs, q)
    path_keys = [tuning.op_key("mask_pack", b=2, h=9, w=13),
                 tuning.op_key("jpeg_idct", b=1, n=6),
                 tuning.op_key("deproject", h=120, w=160, stride=1)]
    conv_key = tuning.key(32, 32, 512, 512)
    table({path_keys[0]: {"impl": "xla"}, path_keys[1]: {"impl": "pallas"},
           path_keys[2]: {"impl": "xla"}, conv_key: {"splits": 2}})
    with caplog.at_level(logging.INFO, logger=tuning.log.name):
        for _ in range(3):
            assert tuning.lookup(32, 32, 512, 512) == 2
            assert tuning.lookup_impl("mask_pack", b=2, h=9, w=13) == "xla"
            assert torch.equal(pack.bitpack_mask(mask), want_bits)
            assert torch.equal(decode.dequant_idct(coefs, q), want_idct)
    lines = [r.getMessage() for r in caplog.records]
    for k in path_keys:
        assert sum(k in line for line in lines) == 1, k
    assert not any(conv_key in line for line in lines)


def _recorded_splits(monkeypatch, net, x):
    """(shape, splits handed to the wrapper) of each 3x3 launch of the
    folded forward of ``net`` on ``x``, and its logits."""
    seen = []
    real = unet_infer.conv3x3_bn_relu

    def spy(y, w, scale, bias, **kw):
        seen.append((tuple(y.shape[1:3]) + (y.shape[3], w.shape[3]),
                     kw.get("splits")))
        return real(y, w, scale, bias, **kw)

    monkeypatch.setattr(unet_infer, "conv3x3_bn_relu", spy)
    with torch.no_grad():
        logits = FoldedUNet(net, device="cpu")(x)
    return seen, logits


def _small_net():
    cfg = ModelConfig(base_features=8)
    return UNet(cfg).init_weights(torch.Generator().manual_seed(0)).eval()


def test_no_table_every_launch_takes_fwd_plan(table, monkeypatch):
    """With no table file the folded forward hands every launch None, and
    the wrapper's None is fwd_plan's split; a table's valid entries reach
    the launches of their shapes (bf16 only), invalid ones do not, and
    the plain versions the CPU runs ignore the split."""
    net = _small_net()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    assert not tuning._TUNE_PATH.exists()
    seen, want = _recorded_splits(monkeypatch, net, x)
    shapes = tune_kernels.launch_shapes(net, 32)
    assert [s for s, _ in seen] == shapes and len(shapes) == 18
    assert {splits for _, splits in seen} == {None}
    table({tuning.key(8, 8, 32, 32): {"splits": 2},
           tuning.key(16, 16, 16, 16): {"splits": 99}})
    seen, got = _recorded_splits(monkeypatch, net, x)
    assert torch.equal(got, want)
    for shape, splits in seen:
        assert splits == (2 if shape == (8, 8, 32, 32) else None), shape
    assert (8, 8, 32, 32) in shapes and (16, 16, 16, 16) in shapes


def test_tuning_tool_shapes_and_rule():
    """The tool sweeps the folded forward's 3x3 shapes (chip_smoke's
    MAIN_PATH_3X3, distinct), records only a gain over GAIN, and refuses
    the CPU."""
    import chip_smoke

    main = [(s, s, cin, cout) for s, cin, cout in chip_smoke.MAIN_PATH_3X3]
    assert SERVING == sorted(set(main), key=main.index)
    assert tune_kernels.launch_shapes(UNet(ModelConfig()), 256) == main
    records = [
        {"shape": [1, 16, 16, 512, 512], "heuristic": 8, "heuristic_ms": 1.0,
         "best": 4, "best_ms": 0.9},
        {"shape": [1, 32, 32, 512, 512], "heuristic": 2, "heuristic_ms": 1.0,
         "best": 3, "best_ms": 0.98},
        {"shape": [1, 64, 64, 128, 256], "heuristic": 1, "heuristic_ms": 1.0,
         "best": 1, "best_ms": 1.0},
    ]
    assert tune_kernels.entries(records) == {
        tuning.key(16, 16, 512, 512): {"splits": 4, "ms": 0.9,
                                       "heuristic_ms": 1.0}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune_kernels.sweep(torch, SERVING[:1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune_kernels.main(["--dry-run"])
