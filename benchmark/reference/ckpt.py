"""A frozen copy of the program's ``.skoots`` reader (``checkpoint.py``, the
msgpack subset flax writes, and the flax-tree-to-``state_dict`` names), so
the reference reads the checkpoint file itself and takes nothing the program
made from it."""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

MAGIC = b"SKOOTSTPU1"


class _Reader:
    """Decoder for the msgpack subset flax writes."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack document")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if t in sized:
            fmt, kind = sized[t]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            code = self._unpack(">b")
            return _ext(code, bytes(self._take(n)))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self._unpack(scalars[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._unpack(">b")
            return _ext(code, bytes(self._take(1 << (t - 0xD4))))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(data).value()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # upper half of an f32
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == 1:  # flax ndarray
        return _ndarray(data)
    if code == 3:  # flax numpy scalar
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_decode(buf: bytes) -> Any:
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def _flat(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# modules whose flax counterpart is a 1x1 ``nn.Conv`` (kernel [1,1,1,Cin,
# Cout]) rather than an ``nn.Dense`` ([din, dout])
_CONV1X1 = ("head_conv", "vector_head", "skeleton_head", "semantic_head")


def torch_params_from_flax(params_np: dict) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> state dict of ``models.SpatialEmbedding``.

    Accepts the checkpoint's ``params`` entry (with or without its top-level
    ``'params'`` key). Leaf names: ``kernel`` -> ``weight``, LayerNorm and
    GroupNorm ``scale`` -> ``weight``, ``bias`` and ``gamma`` keep theirs.
    Shapes: depthwise/stem ``[k,k,k,1,C]`` -> ``[k,k,k,C]``; the 1x1 head
    convs ``[1,1,1,Cin,Cout]`` -> ``[Cin,Cout]``; Dense ``[din,dout]``, the
    strided ``[2,2,2,Cin,Cout]`` Downsample kernels and dense k^3 convs
    (UNet3D's, a multi-channel stem) unchanged."""
    tree = params_np.get("params", params_np)
    out = {}
    for path, arr in _flat(tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        if leaf == "kernel" and arr.ndim == 5:
            if arr.shape[3] == 1 and parts[-2] in ("dwconv", "stem"):
                arr = arr[:, :, :, 0, :]
            elif parts[-2] in _CONV1X1:
                arr = arr[0, 0, 0]
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    return out


def read(path: str) -> Dict[str, Any]:
    """``{'cfg', 'params', 'dataset_mean', 'dataset_std', ...}`` of a
    ``.skoots`` file, as written (the cfg a plain dict, not merged with
    defaults)."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head != MAGIC:
            raise RuntimeError(f"{path} is not a .skoots checkpoint")
        return msgpack_decode(f.read())


def state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The file's parameters, f32, keyed as the model's ``state_dict``."""
    return torch_params_from_flax(read(path)["params"])
