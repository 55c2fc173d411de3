"""``@shape_contract``: declarative shape/dtype contracts on array APIs
(the port's copy of the JAX package's ``analysis/contracts.py``, without
chex).

A contract names each array parameter's axes einops-style; named axes
must agree ACROSS parameters (and with the returned value), integer
literals must match exactly, ``_`` matches anything, and a leading
``...`` tolerates extra leading axes::

    @shape_contract(mask="h w", depth="h w", intrinsics="3 3")
    def compute_curvature_profile(mask, depth, intrinsics, ...): ...

A dtype constraint rides along as a ``(spec, dtype)`` tuple, where dtype
is a concrete name (``"uint8"``) or a kind (``"floating"``,
``"integer"``, ``"signedinteger"``, ``"unsignedinteger"``)::

    @shape_contract(frames=("b h w 3", "uint8"))

The checks read ``.shape`` and ``.dtype`` of ``torch.Tensor``s and numpy
arrays (host callers pass numpy) and nothing else: no value is read, so
a check never synchronizes with the device and runs the same inside a
CUDA-graph capture. A torch dtype's kind comes from
``is_floating_point`` and ``is_signed`` (``bfloat16`` and ``float16``
are "floating"; ``bool`` is no integer, as in numpy). Arguments are
found by a positional index per spec computed at decoration time, not by
``inspect.Signature.bind``, since the analyzers' entries check every
frame. Set ``RDP_CONTRACTS=0`` to disable every contract at once.

Where the JAX package batches a per-frame function with ``jax.vmap``,
the port passes leading axes instead (``ops/pipeline``'s batched
geometry). :func:`mapped` is the port's stand-in for vmap's per-example
view: inside ``with mapped():`` an argument (or result) whose rank
exceeds its spec's by one has that leading axis checked against the
other mapped arguments' and stripped before the spec applies; one at its
spec's rank is an unmapped argument (``in_axes=None``).

Violations raise :class:`ContractError` naming the function, the
parameter, the spec, and the observed shape/dtype, in the JAX package's
words. The one difference: the inner reason for a rank or literal
mismatch, which in the JAX package is chex's assertion text, is the
port's own (``rank 3 != 4``, ``axis 3 is 4, expected 3``).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import threading

import numpy as np
import torch

_RESERVED_OUT = "out"
_MISSING = object()
_mapping = threading.local()


class ContractError(TypeError):
    """A shape/dtype contract violation at a public API boundary."""


def _resolve_enabled() -> bool:
    """RDP_CONTRACTS resolver: contracts default on; 0/false/off kill."""
    return os.environ.get("RDP_CONTRACTS", "1") not in ("0", "false", "off")


@contextlib.contextmanager
def mapped():
    """Check the contracts called in this block per example, as under
    ``jax.vmap`` (see the module docstring). Nests; per thread."""
    depth = getattr(_mapping, "depth", 0)
    _mapping.depth = depth + 1
    try:
        yield
    finally:
        _mapping.depth = depth


#: a dtype kind's numpy kind codes (bool, 'b', is no integer)
_KIND_CODES = {"floating": "f", "integer": "iu", "signedinteger": "i",
               "unsignedinteger": "u"}


class _Spec:
    __slots__ = ("tokens", "ellipsis", "dtype", "raw", "checks", "want")

    def __init__(self, raw):
        self.dtype = None
        if isinstance(raw, tuple):
            raw, self.dtype = raw
        self.raw = raw
        tokens = raw.split()
        self.ellipsis = bool(tokens) and tokens[0] == "..."
        if self.ellipsis:
            tokens = tokens[1:]
        if any(t == "..." for t in tokens):
            raise ValueError(f"'...' is only allowed leading: {raw!r}")
        self.tokens = tokens
        # (index, literal or None, name or None) of every checked axis
        self.checks = tuple(
            (i, int(t), None) if t.lstrip("-").isdigit() else (i, None, t)
            for i, t in enumerate(tokens) if t != "_")
        # a concrete dtype's name, or a kind's numpy codes
        self.want = (None if self.dtype is None
                     else _KIND_CODES[self.dtype] if self.dtype in _KIND_CODES
                     else str(np.dtype(self.dtype)))


_TORCH_NAMES: dict = {}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        name = _TORCH_NAMES.get(dtype)
        if name is None:
            name = _TORCH_NAMES[dtype] = str(dtype).rpartition(".")[2]
        return name
    return str(np.dtype(dtype))


def _kind_code(dtype) -> str:
    """The numpy kind code of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return "f"
        if dtype.is_complex:
            return "c"
        if dtype == torch.bool:
            return "b"
        return "i" if dtype.is_signed else "u"
    return np.dtype(dtype).kind


def _check_dtype(name: str, value, spec: _Spec, where: str) -> None:
    got = getattr(value, "dtype", None)
    if got is None:
        got = np.dtype(type(value))
    if spec.dtype in _KIND_CODES:
        ok = _kind_code(got) in spec.want
    elif isinstance(got, torch.dtype):
        ok = _dtype_name(got) == spec.want
    else:
        ok = got == spec.want
    if not ok:
        raise ContractError(
            f"{where}: argument {name!r} must have dtype {spec.dtype}, got "
            f"{_dtype_name(got)}"
        )


def _violation(name, shape, spec: _Spec, where: str, reason: str):
    return ContractError(
        f"{where}: argument {name!r} with shape {shape} "
        f"violates contract {spec.raw!r}: {reason}"
    )


def _check(name: str, value, spec: _Spec, env: dict, where: str,
           mapped_axes: int = 0) -> None:
    shape = getattr(value, "shape", None)
    if shape is None:
        if spec.tokens:  # scalar-typed python value vs array spec
            raise ContractError(
                f"{where}: argument {name!r} has no .shape but the "
                f"contract requires {spec.raw!r}"
            )
        return
    shape = tuple(shape)
    dims, rank = shape, len(spec.tokens)
    if (mapped_axes and not spec.ellipsis
            and len(dims) == rank + mapped_axes):
        lead = dims[:mapped_axes]
        bound = env.setdefault("...mapped", (lead, name))
        if bound[0] != lead:
            raise _violation(name, shape, spec, where,
                             f"mapped axes {bound[0]} (bound by "
                             f"{bound[1]!r}) but {lead} here")
        dims = dims[mapped_axes:]
    if spec.ellipsis:
        if len(dims) < rank:
            raise _violation(name, shape, spec, where,
                             f"rank {len(dims)} < {rank}")
        dims = dims[len(dims) - rank:]
    elif len(dims) != rank:
        raise _violation(name, shape, spec, where,
                         f"rank {len(dims)} != {rank}")
    for i, literal, tok in spec.checks:
        if literal is not None:
            if dims[i] != literal:
                raise _violation(
                    name, shape, spec, where,
                    f"axis {len(shape) - rank + i} is {dims[i]}, "
                    f"expected {literal}")
            continue
        bound = env.setdefault(tok, (dims[i], name))
        if bound[0] != dims[i]:
            raise _violation(name, shape, spec, where,
                             f"axis {tok!r} is {bound[0]} (bound by "
                             f"{bound[1]!r}) but {dims[i]} here")
    if spec.want is not None:
        _check_dtype(name, value, spec, where)


def shape_contract(**specs):
    """Decorator factory: keyword args map parameter names to specs; the
    reserved keyword ``out`` constrains the return value (for tuple /
    NamedTuple returns, ``out`` applies to the first element unless the
    return is a bare array)."""
    out_spec = specs.pop(_RESERVED_OUT, None)
    parsed = {name: _Spec(s) for name, s in specs.items()}
    parsed_out = _Spec(out_spec) if out_spec is not None else None

    def decorator(fn):
        sig = inspect.signature(fn)
        unknown = set(parsed) - set(sig.parameters)
        if unknown:
            raise ValueError(
                f"shape_contract on {fn.__qualname__}: unknown "
                f"parameter(s) {sorted(unknown)}"
            )
        where = fn.__qualname__
        names = list(sig.parameters)
        # (name, positional index or None, keyword name or None, spec):
        # where a call's argument for each spec is found
        lookups = []
        for name, spec in parsed.items():
            p = sig.parameters[name]
            positional = p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)
            keyword = p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            lookups.append((name, names.index(name) if positional else None,
                            name if keyword else None, spec))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _resolve_enabled():
                return fn(*args, **kwargs)
            axes = getattr(_mapping, "depth", 0)
            env: dict = {}
            for name, index, key, spec in lookups:
                if index is not None and index < len(args):
                    value = args[index]
                elif key is not None:
                    value = kwargs.get(key, _MISSING)
                    if value is _MISSING:
                        continue
                else:
                    continue
                _check(name, value, spec, env, where, axes)
            result = fn(*args, **kwargs)
            if parsed_out is not None:
                target = result
                if not hasattr(target, "shape") and isinstance(
                    target, tuple
                ) and target:
                    target = target[0]
                _check("return", target, parsed_out, env, where, axes)
            return result

        wrapper.__shape_contract__ = dict(specs, out=out_spec)
        return wrapper

    return decorator
