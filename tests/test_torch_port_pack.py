"""The port's egress pack (ops/pack.py, ops/pipeline.pack_analysis,
serving/egress.PackedResult) against the JAX package's, on the CPU.

Tolerances, fixed before measuring: none. The bitpack is integer only, so
it is bitwise against ``np.packbits`` and the JAX package's
``bitpack_mask(impl="interpret")``; the row layout helpers and the packed
rows are byte-equal to the JAX package's for the same leaves; a parsed row
gives back exactly the values packed into it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.ops.pallas import pack as jpack
from robotic_discovery_platform_tpu.serving import egress as jegress
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import pack as tpack
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.serving import egress


@pytest.mark.parametrize("b,h,w", [(1, 5, 1), (2, 7, 7), (3, 4, 8),
                                   (2, 6, 9), (1, 11, 13), (2, 3, 160),
                                   (1, 2, 641)])
def test_bitpack_matches_packbits_and_jax(b, h, w):
    rng = np.random.default_rng(b * h * w)
    values = np.array([0, 1, 7, 255], np.uint8)
    mask = values[rng.integers(0, 4, (b, h, w))]
    want = np.packbits(mask != 0, axis=-1)
    launches = tpack.bitpack_mask.launches
    got = tpack.bitpack_mask(torch.from_numpy(mask))
    assert tpack.bitpack_mask.launches == launches  # plain on the CPU
    assert got.dtype == torch.uint8 and got.shape == (b, h, (w + 7) // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpack.bitpack_mask(jnp.asarray(mask), impl="interpret")))
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=-1)[..., :w], (mask != 0))


@pytest.mark.parametrize("h,w,n", [(480, 640, 100), (7, 13, 3), (1, 1, 0),
                                   (120, 161, 100)])
def test_row_layout_matches_jax(h, w, n):
    for name in ("N_SCALARS", "HEADER_BYTES", "ROW_MAGIC", "ROW_ALIGN"):
        assert getattr(tpack, name) == getattr(jpack, name), name
    assert tpack.sidecar_floats(n) == jpack.sidecar_floats(n)
    assert tpack.packed_row_bytes(w) == jpack.packed_row_bytes(w)
    assert tpack.frame_payload_bytes(h, w, n) == jpack.frame_payload_bytes(
        h, w, n)
    assert tpack.frame_payload_bytes(h, w, n) % tpack.ROW_ALIGN == 0
    assert (tpack.payload_header(h, w, n).tobytes()
            == jpack.payload_header(h, w, n).tobytes())


def _leaves(b: int, h: int, w: int, n_pts: int, seed: int):
    """Analysis leaves for a batch: frame 1 invalid with non-finite
    curvature (packs as 0.0), the rest valid."""
    rng = np.random.default_rng(seed)
    valid = np.ones(b, bool)
    valid[1] = False
    mean = rng.random(b).astype(np.float32)
    mean[1] = np.nan
    maxk = (mean + 1).astype(np.float32)
    maxk[1] = np.inf
    return dict(
        mask=(rng.random((b, h, w)) < 0.3).astype(np.uint8),
        coverage=(rng.random(b) * 100).astype(np.float32),
        mean=mean, maxk=maxk, valid=valid,
        spline=rng.normal(size=(b, n_pts, 3)).astype(np.float32),
        margin=rng.random(b).astype(np.float32),
        counts=np.full(b, 7, np.int32),
    )


def _analysis(mod, geom, leaves, to):
    prof = geom.CurvatureProfile(
        mean_curvature=to(leaves["mean"]), max_curvature=to(leaves["maxk"]),
        spline_points=to(leaves["spline"]), valid=to(leaves["valid"]),
        num_cloud_points=to(leaves["counts"]),
        num_edge_points=to(leaves["counts"]),
        truncated=to(~leaves["valid"]))
    return mod.FrameAnalysis(mask=to(leaves["mask"]),
                             mask_coverage=to(leaves["coverage"]),
                             profile=prof,
                             confidence_margin=to(leaves["margin"]))


@pytest.mark.parametrize("b,h,w", [(3, 120, 160), (2, 9, 13)])
def test_pack_analysis_rows_match_jax_and_parse_back(b, h, w):
    n_pts = 100
    leaves = _leaves(b, h, w, n_pts, b + h)
    want = np.asarray(jpipe.pack_analysis(
        _analysis(jpipe, jgeom, leaves, jnp.asarray), n_pts=n_pts,
        impl="interpret"))
    got = tpipe.pack_analysis(
        _analysis(tpipe, tgeom, leaves, torch.from_numpy), n_pts=n_pts)
    assert got.dtype == torch.uint8
    assert got.shape == (b, tpack.frame_payload_bytes(h, w, n_pts))
    np.testing.assert_array_equal(got.numpy(), want)

    released = []
    for i, row in enumerate(got.numpy()):
        pr = egress.PackedResult(row, release=lambda: released.append(1))
        theirs = jegress.PackedResult(row)
        assert (pr.h, pr.w, pr.n_pts) == (h, w, n_pts)
        coverage, mean_k, max_k, valid, margin = pr.scalars()
        assert pr.scalars() == theirs.scalars()
        assert valid == bool(leaves["valid"][i])
        assert coverage == float(leaves["coverage"][i])
        assert margin == float(leaves["margin"][i])
        if valid:
            assert (mean_k, max_k) == (float(leaves["mean"][i]),
                                       float(leaves["maxk"][i]))
            np.testing.assert_array_equal(pr.spline(), leaves["spline"][i])
            assert pr.spline_wire() == leaves["spline"][i].astype(
                "<f4").tobytes()
        else:  # the direct path's convention for an invalid frame
            assert (mean_k, max_k) == (0.0, 0.0)
            assert pr.spline().shape == (0, 3) and pr.spline_wire() == b""
        np.testing.assert_array_equal(pr.unpack_mask(), leaves["mask"][i])
        np.testing.assert_array_equal(pr.mask_bits, theirs.mask_bits)
        assert (egress.encode_bits_wire(pr.mask_bits, h, w)
                == egress.encode_mask(leaves["mask"][i], 1))
        pr.release()
        pr.release()  # idempotent
    assert released == [1] * b


def test_packed_result_validates_its_row():
    with pytest.raises(ValueError, match="1-D uint8"):
        egress.PackedResult(np.zeros((2, 64), np.uint8))
    bad = np.zeros(tpack.frame_payload_bytes(4, 8, 2), np.uint8)
    with pytest.raises(ValueError, match="magic"):
        egress.PackedResult(bad)
    short = np.zeros(tpack.HEADER_BYTES, np.uint8)
    short[:] = tpack.payload_header(4, 8, 2)
    with pytest.raises(ValueError, match="bytes"):
        egress.PackedResult(short)
    with pytest.raises(ValueError, match="n_pts=5"):
        tpipe.pack_analysis(_analysis(
            tpipe, tgeom, _leaves(2, 4, 8, 3, 0), torch.from_numpy), n_pts=5)
