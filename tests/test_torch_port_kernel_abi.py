"""The C interfaces of the port's CUDA kernels against their ctypes
bindings.

Each ``csrc/*.cu`` exports ``extern "C"`` functions, loaded through ctypes
with the argument types in a ``_SIGNATURES`` table of ``ops/conv.py``,
``ops/geometry_kernels.py``, ``ops/pack.py`` or ``ops/decode.py``. A
binding whose count or kinds differ from the source passes a truncated
pointer or a shifted argument on the card, where nothing reports it: this
checks every binding against the source's parameter list, on the CPU.
"""

from __future__ import annotations

import ctypes
import re

import pytest

from robotic_discovery_platform_tpu_torch.ops import (
    build,
    conv,
    decode,
    geometry_kernels,
    pack,
)

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _kind(param: str):
    """The ctypes type that carries one C parameter."""
    param = " ".join(param.split())
    if "*" in param:
        return ctypes.c_void_p
    if param.startswith("long long"):
        return ctypes.c_longlong
    if param.startswith("int "):
        return ctypes.c_int
    raise AssertionError(f"no ctypes kind for C parameter {param!r}")


def _exports() -> dict:
    """(kernel name, C function) -> [ctypes kind per parameter], parsed
    from every source in ``build.SOURCES``."""
    out = {}
    for name, source in build.SOURCES.items():
        text = (build.CSRC / source).read_text()
        for symbol, params in _EXTERN.findall(text):
            out[(name, symbol)] = [_kind(p) for p in params.split(",")]
    return out


def _bindings() -> dict:
    """(kernel name, C function) -> ctypes argument types of every binding.
    ``conv`` and ``geometry_kernels`` key their tables by C function (a
    kernel library there may export more than one), ``pack`` and
    ``decode`` by kernel name."""
    out = {}
    for module in (pack, decode):
        for name, (symbol, argtypes) in module._SIGNATURES.items():
            out[(name, symbol)] = list(argtypes)
    for module in (conv, geometry_kernels):
        for symbol, (name, argtypes) in module._SIGNATURES.items():
            out[(name, symbol)] = list(argtypes)
    return out


def test_every_export_has_a_binding_and_every_binding_an_export():
    assert set(_exports()) == set(_bindings())


@pytest.mark.parametrize("key", sorted(_bindings()), ids="/".join)
def test_binding_matches_the_c_parameter_list(key):
    """Same count, and a pointer where the source has one, a 32-bit int
    where it has ``int``, a 64-bit int where it has ``long long``."""
    want = _exports()[key]
    got = _bindings()[key]
    assert len(got) == len(want), f"{key}: {len(got)} ctypes args, C has {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"{key}: argument {i} bound as {g.__name__}, C wants {w.__name__}"


def test_the_parser_sees_the_redesigned_conv_interfaces():
    """The forward conv takes a workspace and a split count (6 pointers, 8
    ints, the stream); the weight gradient x, g, workspace, dw, 7 ints and
    the stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    assert _exports()[("conv3x3_bn_relu", "conv3x3_bn_relu_launch")] == (
        [p] * 6 + [i] * 8 + [p])
    assert _exports()[("conv3x3_grad_weights",
                       "conv3x3_grad_weights_launch")] == [p] * 4 + [i] * 7 + [p]


def test_the_parser_sees_the_convt_path_and_the_one_launch_design():
    """The transposed conv exports its launch (x, w, bias, out, 6 ints, the
    stream) and its path rule (Cin, Cout, dtypes); the design contractions
    take no scratch and export no block count (one launch: pts, w, u,
    knots, gram, rhs, N, D, K, degree, the stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    exports = _exports()
    assert exports[("conv_transpose2x2", "conv_transpose2x2_launch")] == (
        [p] * 4 + [i] * 6 + [p])
    assert exports[("conv_transpose2x2", "conv_transpose2x2_path")] == [i] * 3
    assert exports[("bspline_design", "bspline_design_launch")] == (
        [p] * 6 + [i] * 4 + [p])
    assert ("bspline_design", "bspline_design_blocks") not in exports


def test_the_parser_sees_the_conv1x1_path_and_the_banded_curvature():
    """conv1x1 exports its launch (x, w, scale, bias, out, P as long long,
    Cin, Cout, relu, dtypes, the stream) and its path rule, which reads
    the alignment of x (x, Cin, Cout, dtypes); the curvature
    takes the derivative matrices' bands in the place of the matrices and
    ctrl's strides (ctrl, u, knots, m1 band, m2 band, kappa, valid, r, N,
    K, degree, two strides, the stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    exports = _exports()
    assert exports[("conv1x1", "conv1x1_launch")] == (
        [p] * 5 + [ctypes.c_longlong] + [i] * 4 + [p])
    assert exports[("conv1x1", "conv1x1_path")] == [p, i, i, i]
    assert exports[("bspline_curvature", "bspline_curvature_launch")] == (
        [p] * 8 + [i] * 5 + [p])


def test_the_parser_sees_the_one_launch_deprojection_and_the_separable_idct():
    """The deprojection takes its five scalars as device pointers and a
    ticket counter, with no parameter row and one scratch of partial rows
    (mask, depth, fx, fy, cx, cy, depth_scale, x, y, z, valid, part,
    stats_f, stats_n, ticket, H, W, stride, the stream); the IDCT takes no
    pass matrices (coefs, q, out, B, N, the stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    exports = _exports()
    assert exports[("deproject_edge_stats", "deproject_edge_stats_launch")] == (
        [p] * 15 + [i] * 3 + [p])
    assert exports[("deproject_edge_stats", "deproject_edge_stats_blocks")] == (
        [i, i])
    assert exports[("dequant_idct", "dequant_idct_launch")] == (
        [p] * 3 + [i, i] + [p])
