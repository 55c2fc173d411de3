"""The port's ``analysis/contracts.py`` against the JAX package's, on the
CPU: the decorator's cases of tests/test_contracts.py that need neither
``jit`` nor ``vmap``, on torch tensors and numpy arrays; the error texts
against the JAX ones; the specs of the 17 decorated sites; ``mapped()``
(the port's stand-in for a vmapped call); and the contracts leaving an
analyzer's output unchanged.

Tolerances, fixed before measuring: none. Texts are compared exactly,
apart from the inner reason of a rank or literal mismatch, which the JAX
package takes from chex (the port's module docstring says so); outputs
are compared bit for bit.
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.analysis import contracts as jcontracts
from robotic_discovery_platform_tpu.models import unet as junet
from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.ops.pallas import conv as jconv
from robotic_discovery_platform_tpu.serving import batching as jbatching
from robotic_discovery_platform_tpu_torch import analysis as tanalysis
from robotic_discovery_platform_tpu_torch.analysis import contracts as tcontracts
from robotic_discovery_platform_tpu_torch.analysis.contracts import (
    ContractError,
    shape_contract,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.ops import bspline as tbspline
from robotic_discovery_platform_tpu_torch.ops import conv as tconv
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.serving import batching as tbatching
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_port_pipeline.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _contracts_on(monkeypatch):
    monkeypatch.delenv("RDP_CONTRACTS", raising=False)


KINDS = ("numpy", "torch")


def _arr(kind, shape, dtype="float64"):
    a = np.zeros(shape, dtype)
    return a if kind == "numpy" else torch.from_numpy(a)


@shape_contract(x="b h w 3", k="3 3", out="b h w")
def _demo(x, k):
    return x[..., 0]


# -- the decorator's cases (tests/test_contracts.py) ---------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_contract_passes_on_conforming_args(kind):
    out = _demo(_arr(kind, (2, 4, 6, 3)), _arr(kind, (3, 3)))
    assert tuple(out.shape) == (2, 4, 6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case,x_shape,match", [
    ("rank", (4, 6, 3), "'x'.*b h w 3"),
    ("literal", (2, 4, 6, 4), "'x'"),
])
def test_mismatch_names_the_argument(kind, case, x_shape, match):
    with pytest.raises(ContractError, match=match):
        _demo(_arr(kind, x_shape), _arr(kind, (3, 3)))


@pytest.mark.parametrize("kind", KINDS)
def test_cross_argument_axis_consistency(kind):
    @shape_contract(a="n d", b="n")
    def f(a, b):
        return a, b

    f(_arr(kind, (5, 3)), _arr(kind, 5))
    with pytest.raises(ContractError, match="axis 'n'"):
        f(_arr(kind, (5, 3)), _arr(kind, 4))


@pytest.mark.parametrize("kind", KINDS)
def test_return_contract_shares_the_axis_environment(kind):
    @shape_contract(a="n d", out="n")
    def bad(a):
        return _arr(kind, a.shape[0] + 1)

    with pytest.raises(ContractError, match="'return'"):
        bad(_arr(kind, (5, 3)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("spec,good,bad,match", [
    ("uint8", ["uint8"], ["float32"], "uint8"),
    ("floating", ["float32", "float64", "float16"], ["int32"], "floating"),
    ("integer", ["int32", "uint8", "int16"], ["float32", "bool"], "integer"),
    ("signedinteger", ["int64", "int8"], ["uint8"], "signedinteger"),
    ("unsignedinteger", ["uint8"], ["int32"], "unsignedinteger"),
])
def test_dtype_constraint(kind, spec, good, bad, match):
    @shape_contract(img=("h w 3", spec))
    def f(img):
        return img

    for dt in good:
        f(_arr(kind, (4, 4, 3), dt))
    for dt in bad:
        with pytest.raises(ContractError, match=match):
            f(_arr(kind, (4, 4, 3), dt))


def test_bfloat16_is_floating():
    @shape_contract(x=("n", "floating"))
    def f(x):
        return x

    f(torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(ContractError, match="got bfloat16"):
        shape_contract(x=("n", "float32"))(lambda x: x)(
            torch.zeros(3, dtype=torch.bfloat16))


@pytest.mark.parametrize("kind", KINDS)
def test_ellipsis_tolerates_leading_axes(kind):
    @shape_contract(x="... h w")
    def f(x):
        return x

    f(_arr(kind, (4, 6)))
    f(_arr(kind, (2, 3, 4, 6)))
    with pytest.raises(ContractError):
        f(_arr(kind, 4))


@pytest.mark.parametrize("kind", KINDS)
def test_wildcard_axis(kind):
    @shape_contract(x="n _")
    def f(x):
        return x

    f(_arr(kind, (3, 7)))
    f(_arr(kind, (3, 1)))


def test_unknown_parameter_rejected_at_decoration_time():
    with pytest.raises(ValueError, match="unknown"):
        @shape_contract(nope="n")
        def f(x):
            return x


@pytest.mark.parametrize("kind", KINDS)
def test_env_kill_switch(kind, monkeypatch):
    monkeypatch.setenv("RDP_CONTRACTS", "0")
    # the violation passes through to the function untouched
    assert tuple(_demo(_arr(kind, (4, 6, 3)), _arr(kind, (3, 3))).shape) \
        == (4, 6)


def test_scalar_python_value_vs_array_spec():
    @shape_contract(x="n")
    def f(x):
        return x

    with pytest.raises(ContractError, match="no .shape"):
        f(3.0)


def test_keyword_and_default_arguments_are_found():
    """Arguments are found by position or keyword; a parameter left at
    its default is not checked, as ``Signature.bind`` leaves it out."""
    @shape_contract(a="n", b="n")
    def f(a, b=None, *, c=0):
        return a

    f(np.zeros(3))
    f(a=np.zeros(3), b=np.zeros(3))
    with pytest.raises(ContractError, match="'b'"):
        f(np.zeros(3), b=np.zeros(4))
    assert f.__shape_contract__ == {"a": "n", "b": "n", "out": None}
    assert tanalysis.shape_contract is shape_contract


# -- the same texts as the JAX package ----------------------------------------


def _both(specs, fn):
    """``fn`` decorated by each package's ``shape_contract``."""
    return (jcontracts.shape_contract(**specs)(fn),
            tcontracts.shape_contract(**specs)(fn))


def _messages(specs, fn, kind, *args):
    """Each package's ContractError text for ``fn(*args)``; the JAX
    package reads numpy arrays, the port ``kind``'s arrays."""
    out = []
    for wrapped, err, k in zip(_both(specs, fn),
                               (jcontracts.ContractError, ContractError),
                               ("numpy", kind)):
        with pytest.raises(err) as info:
            wrapped(*(_arr(k, *a) if isinstance(a, tuple) else a
                      for a in args))
        out.append(str(info.value))
    return out


def _ident(x):
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("specs,shapes,chex", [
    ({"a": "n d", "b": "n"}, [(5, 3), (4,)], False),
    ({"x": "... h w"}, [(4,)], False),
    ({"x": "b h w 3"}, [(4, 6, 3)], True),
    ({"x": "b h w 3"}, [(2, 4, 6, 4)], True),
    ({"x": "n _ 2"}, [(3, 1, 5)], True),
])
def test_error_text_equals_jax(kind, specs, shapes, chex):
    def fn(a=None, b=None, x=None):
        return a

    names = list(specs)
    args = [(s,) for s in shapes]
    jmsg, tmsg = _messages(specs, fn, kind, *(
        [None] * 2 + args if names == ["x"] else args))
    if chex:  # equal up to chex's own wording of the reason
        cut = jmsg.index("violates contract")
        cut = jmsg.index(": ", cut) + 2
        assert tmsg[:cut] == jmsg[:cut]
        assert tmsg[cut:] and "[Chex]" not in tmsg
    else:
        assert tmsg == jmsg


@pytest.mark.parametrize("kind", KINDS)
def test_return_dtype_and_shape_texts_equal_jax(kind):
    def grow(a):
        return np.zeros(a.shape[0] + 1)

    assert len(set(_messages({"a": "n d", "out": "n"}, grow, kind,
                             ((5, 3),)))) == 1
    assert len(set(_messages({"x": ("h w 3", "uint8")}, _ident, kind,
                             ((4, 4, 3), "float32")))) == 1
    assert len(set(_messages({"x": ("n", "floating")}, _ident, kind,
                             (3, "int32")))) == 1
    assert len(set(_messages({"x": "n"}, _ident, kind, 3.0))) == 1


# -- the 17 sites --------------------------------------------------------------


def _decorator_specs(factory, name: str = "analyze") -> dict:
    """The ``@shape_contract(...)`` keywords on the function ``name``
    defined inside ``factory``, read from its source (a jitted JAX
    analyzer does not expose them)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(factory)))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            for dec in node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and getattr(dec.func, "id", "") == "shape_contract"):
                    specs = {k.arg: ast.literal_eval(k.value)
                             for k in dec.keywords}
                    specs.setdefault("out", None)
                    return specs
    raise AssertionError(f"no shape_contract on {name} in {factory}")


def _port_analyzer(factory, **kw):
    return factory(lambda x: x[..., :1], img_size=32, device="cpu", **kw)


SITES = {
    "conv3x3_bn_relu": (jconv.conv3x3_bn_relu, tconv.conv3x3_bn_relu),
    "conv1x1": (jconv.conv1x1, tconv.conv1x1),
    "conv_transpose2x2": (jconv.conv_transpose2x2, tconv.conv_transpose2x2),
    "deproject": (jgeom.deproject, tgeom.deproject),
    "compute_curvature_profile": (jgeom.compute_curvature_profile,
                                  tgeom.compute_curvature_profile),
    "chord_length_params": (jbspline.chord_length_params,
                            tbspline.chord_length_params),
    "fit_bspline": (jbspline.fit_bspline, tbspline.fit_bspline),
    "evaluate_bspline": (jbspline.evaluate_bspline,
                         tbspline.evaluate_bspline),
    "curvature_profile": (jbspline.curvature_profile,
                          tbspline.curvature_profile),
    "upsample_align_corners": (junet.upsample_align_corners,
                               tunet.upsample_align_corners),
    "preprocess": (jpipe.preprocess, tpipe.preprocess),
    "logits_to_native_masks": (jpipe.logits_to_native_masks,
                               tpipe.logits_to_native_masks),
    "BatchDispatcher.submit": (jbatching.BatchDispatcher.submit,
                               tbatching.BatchDispatcher.submit),
}
ANALYZERS = {
    "make_frame_analyzer": {},
    "make_batch_analyzer": {},
    "make_coef_batch_analyzer": {"height": 16, "width": 16},
    "make_scan_batch_analyzer": {},
}


@pytest.mark.parametrize("site", sorted(SITES) + sorted(ANALYZERS))
def test_each_site_carries_the_jax_spec(site):
    if site in SITES:
        jfn, tfn = SITES[site]
        want = jfn.__shape_contract__
        got = tfn.__shape_contract__
    else:
        want = _decorator_specs(getattr(jpipe, site))
        got = _port_analyzer(getattr(tpipe, site),
                             **ANALYZERS[site]).__shape_contract__
    assert got == want
    assert len(SITES) + len(ANALYZERS) == 17


def test_preprocess_rejects_an_unbatched_frame():
    frame = np.zeros((48, 64, 3), np.uint8)
    with pytest.raises(ContractError, match="frames_rgb"):
        tpipe.preprocess(torch.from_numpy(frame), 32)


def test_submit_rejects_a_misshaped_frame():
    d = tbatching.BatchDispatcher(lambda *a: None, device="cpu",
                                  watchdog_interval_s=0.0)
    try:
        k = np.eye(3, dtype=np.float32)
        depth = np.zeros((8, 8), np.uint16)
        with pytest.raises(ContractError, match="'frame_rgb'"):
            d.submit(np.zeros((8, 8, 4), np.uint8), depth, k, 0.001)
        with pytest.raises(ContractError, match="dtype uint8"):
            d.submit(np.zeros((8, 8, 3), np.float32), depth, k, 0.001)
        with pytest.raises(ContractError, match="'depth'"):
            d.submit(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 9)), k,
                     0.001)
    finally:
        d.stop()


# -- mapped(): the port's vmap --------------------------------------------------


def test_mapped_checks_each_example():
    @shape_contract(a="n d", k="k", out="n")
    def f(a, k):
        return a[..., 0]

    a, k = torch.zeros(4, 5, 3), torch.zeros(7)
    with pytest.raises(ContractError, match="rank 3 != 2"):
        f(a, k)
    with tcontracts.mapped():
        assert tuple(f(a, k).shape) == (4, 5)  # k unmapped, a mapped
        with pytest.raises(ContractError, match="mapped axes"):
            f2 = shape_contract(a="n d", b="n")(lambda a, b: a)
            f2(torch.zeros(4, 5, 3), torch.zeros(2, 5))
    with pytest.raises(ContractError):
        f(a, k)  # the block ended


def _scene_batch(b: int, h: int = 96, w: int = 128):
    rng = np.random.default_rng(3)
    scenes = [render_scene(rng, h, w) for _ in range(b)]
    frames = np.stack([s[0] for s in scenes])
    depths = np.stack([s[2] for s in scenes])
    k = np.stack([default_intrinsics(w, h).astype(np.float32)] * b)
    return frames, depths, k, np.full((b,), 0.001, np.float32)


def _run(kind, monkeypatch, on: bool):
    monkeypatch.setenv("RDP_CONTRACTS", "1" if on else "0")

    def forward(x):
        return (x[..., :1] - 0.45) * 20.0

    frames, depths, k, scales = _scene_batch(2)
    if kind == "frame":
        a = tpipe.make_frame_analyzer(forward, img_size=64, device="cpu")
        out = a(frames[0], depths[0], k[0], scales[0])
    else:
        a = getattr(tpipe, f"make_{kind}_analyzer")(
            forward, img_size=64, device="cpu")
        out = a(frames, depths, k, scales)
    return [t.numpy() for t in (out.mask, out.mask_coverage,
                                out.confidence_margin, *out.profile)]


@pytest.mark.parametrize("kind", ["frame", "batch", "scan_batch"])
def test_contracts_leave_the_analyzer_output_unchanged(kind, monkeypatch):
    on = _run(kind, monkeypatch, True)
    off = _run(kind, monkeypatch, False)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert bool(on[3].any())  # a real profile (valid on some frame)
