"""Weights shared with the JAX package.

- :func:`from_flax_variables` maps a Flax ``{"params", "batch_stats"}``
  variable tree (numpy leaves; a group-norm net's has ``params`` alone)
  onto the state of :class:`models.unet.UNet`:
  the module tree carries the Flax names, so each leaf's path joined by
  ``.`` is its state-dict key. :func:`to_flax_variables` is its inverse.
- :func:`save_model` and :func:`load_model_dir` write and read a model
  artifact directory, the JAX package's ``tracking.save_model`` format:
  ``model_config.json`` plus the Flax-serialized ``variables.msgpack``.
  The msgpack subset that Flax writes (maps, strings, Flax's ndarray
  extension type) is encoded and decoded here with the standard library
  alone, byte for byte as ``flax.serialization.to_bytes`` writes it.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    from_dict,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

MODEL_CONFIG_FILE = "model_config.json"
MODEL_WEIGHTS_FILE = "variables.msgpack"

# Flax's msgpack extension codes (flax/serialization.py _MsgpackExtType):
# an ndarray leaf, and a numpy scalar packed as a 0-d ndarray
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, f"{name}."))
        else:
            out[name] = np.asarray(value)
    return out


def from_flax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """Flax ``{"params": ..., "batch_stats": ...}`` tree with numpy
    leaves -> a :class:`UNet` state dict of float32 tensors."""
    state = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    overlap = set(state) & set(stats)
    if overlap:
        raise ValueError(f"params and batch_stats share keys: {sorted(overlap)}")
    state.update(stats)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}


def unet_from_flax_variables(cfg: ModelConfig, variables: dict) -> UNet:
    """A :class:`UNet` for ``cfg`` holding the Flax ``variables`` (CPU);
    every parameter and statistic must be present, with its shape."""
    net = UNet(cfg)
    net.load_state_dict(from_flax_variables(variables), strict=True)
    return net.eval()


def to_flax_variables(net: UNet) -> dict:
    """:class:`UNet` -> the Flax ``{"params", "batch_stats"}`` tree with
    float32 numpy leaves: BatchNorm's ``mean``/``var`` under
    ``batch_stats``, everything else under ``params``; keys sorted at
    every level, as a JAX tree operation leaves them. A group-norm net
    has no ``batch_stats`` collection, as Flax's init gives none."""
    tree: dict = {"batch_stats": {}, "params": {}}
    for key, value in sorted(net.state_dict().items()):
        *path, leaf = key.split(".")
        kind = "batch_stats" if leaf in ("mean", "var") else "params"
        node = tree[kind]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()

    def ordered(node):
        return ({k: ordered(node[k]) for k in sorted(node)}
                if isinstance(node, dict) else node)

    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return ordered(tree)


# -- msgpack, the subset Flax writes ---------------------------------------------


def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes((n,))
    for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_sized(n: int, fix: tuple[int, int] | None, codes: tuple) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form
    (``(base, limit)``) when it fits, else 8/16/32-bit lengths."""
    if fix is not None and n < fix[1]:
        return bytes((fix[0] | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of length {n} is too long")


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_pack_sized(len(obj), (0x80, 16), (None, 0xDE, 0xDF)))
        for key, value in obj.items():
            _pack(str(key), out)
            _pack(value, out)
    elif isinstance(obj, str):
        data = obj.encode()
        out.append(_pack_sized(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB)))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_sized(len(obj), None, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, (tuple, list)):
        out.append(_pack_sized(len(obj), (0x90, 16), (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, bool) or not isinstance(obj, (int, np.ndarray,
                                                       np.generic)):
        raise TypeError(f"msgpack writer: unsupported leaf {type(obj)}")
    elif isinstance(obj, int):
        if obj < 0:
            raise TypeError("msgpack writer: negative integers unsupported")
        out.append(_pack_uint(obj))
    else:
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        arr = np.asarray(obj)
        payload = _msgpack_bytes((tuple(int(d) for d in arr.shape),
                                  arr.dtype.name, arr.tobytes("C")))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes((fixext[n], code)))
        else:
            out.append(_pack_sized(n, None, (0xC7, 0xC8, 0xC9)))
            out.append(bytes((code,)))
        out.append(payload)


def _msgpack_bytes(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def write_flax_msgpack(variables: dict) -> bytes:
    """A tree of dicts with numpy leaves -> the bytes
    ``flax.serialization.to_bytes`` writes for it: msgpack maps in the
    tree's key order, each leaf Flax's ndarray extension (code 1) whose
    payload packs ``[shape, dtype name, C-order bytes]``. Leaves of 1 GiB
    or more, which Flax splits into chunks, are refused."""
    def check(node):
        for value in node.values():
            if isinstance(value, dict):
                check(value)
            elif np.asarray(value).nbytes > 2**30:
                raise ValueError("leaves over 1 GiB are chunked by Flax; "
                                 "not supported")

    check(variables)
    return _msgpack_bytes(variables)


class _Reader:
    """Decoder of the msgpack that Flax and msgpack-python write: maps,
    arrays, str, bin, ext, integers, floats, nil and booleans."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                   0xDC: ">H", 0xDD: ">I",  # array
                   0xDE: ">H", 0xDF: ">I",  # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.read_ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"msgpack type byte {b:#x} not supported")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b >= 0xD9 and b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.read_map(n)
        return self.read_ext(n)

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int):
        code = self.take(1)[0]
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} not supported")
        shape, dtype_name, buffer = _Reader(data).read()
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def read_flax_msgpack(blob: bytes) -> dict:
    """Decode Flax ``serialization.to_bytes`` output into a tree of dicts
    with numpy leaves."""
    reader = _Reader(blob)
    tree = reader.read()
    if reader.pos != len(blob):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def save_model(variables: dict, cfg: ModelConfig, path: str | Path) -> Path:
    """Write a model artifact directory (``model_config.json`` and
    ``variables.msgpack``), byte for byte as the JAX package's
    ``tracking.save_model`` writes it for the same tree and config."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / MODEL_CONFIG_FILE).write_text(
        json.dumps(dataclasses.asdict(cfg), indent=2))
    (path / MODEL_WEIGHTS_FILE).write_bytes(write_flax_msgpack(variables))
    return path


def load_model_dir(path: str | Path, device: str | torch.device = "cuda"
                   ) -> tuple[ModelConfig, UNet]:
    """Load ``(ModelConfig, UNet)`` from an artifact directory written by
    the JAX package's ``tracking.save_model``; the module is moved to
    ``device`` in eval mode."""
    device = resolve_device(device)
    path = Path(path)
    cfg = from_dict(ModelConfig,
                    json.loads((path / MODEL_CONFIG_FILE).read_text()))
    variables = read_flax_msgpack((path / MODEL_WEIGHTS_FILE).read_bytes())
    return cfg, unet_from_flax_variables(cfg, variables).to(device)
