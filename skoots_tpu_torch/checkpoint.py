""".skoots checkpoints, read and written without JAX, flax or the msgpack
package.

Port of ``skoots_tpu/train/checkpoint.py:37-84``. A checkpoint is the magic
``SKOOTSTPU1`` followed by one msgpack document, the flax state dict
``{'cfg', 'params', 'opt_state', 'dataset_mean', 'dataset_std', 'extra'}``.
Arrays are flax's msgpack ext type 1: a nested msgpack ``[shape, dtype
name, raw bytes]`` (ext type 3 is the same for a numpy scalar). The small
decoder and encoder below cover exactly what those files use; ``cfg`` is
read back as a :class:`~skoots_tpu_torch.config.CfgNode`. :func:`save_checkpoint` writes a file that the JAX package's
``load_checkpoint`` + ``restore_params`` read; ``opt_state`` is the flax
state dict of JAX's optax state (``train/engine.py::flax_opt_state``) or
``None``.

:func:`torch_params_from_flax` maps the flax parameter tree onto the port's
modules (``models/unext.py``), e.g. ``params/backbone/enc0_block0/dwconv/
kernel`` ``[k, k, k, 1, C]`` -> ``backbone.enc0_block0.dwconv.weight``
``[k, k, k, C]``. The port keeps JAX's channels-last layouts, so besides
squeezing the singleton axes of depthwise and 1x1 kernels every array keeps
its shape. :func:`flax_params_from_torch` is its inverse.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional

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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a ``.skoots`` checkpoint: ``{'cfg': CfgNode (the defaults merged
    leniently with the file's cfg, as JAX's), 'params': nested dict of numpy
    arrays, 'opt_state', 'dataset_mean', 'dataset_std', 'extra'}``."""
    from skoots_tpu_torch.config import cfg_from_dict

    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head != MAGIC:
            raise RuntimeError(
                f"{path} is not a skoots-tpu checkpoint (bad magic {head!r}); "
                "PyTorch .trch files need skoots_tpu_torch.utils.torch_compat."
                "convert_trch")
        state = msgpack_decode(f.read())
    state["cfg"] = cfg_from_dict(state["cfg"])
    return state


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




def flax_params_from_torch(state_dict: Dict[str, torch.Tensor]) -> dict:
    """State dict of ``models.SpatialEmbedding`` -> the flax parameter tree
    ``{'params': {...}}`` of numpy f32 arrays that the JAX model's
    ``model.init`` builds (the inverse of :func:`torch_params_from_flax`)."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        owner, leaf = parts[-2], parts[-1]
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        if leaf == "weight":  # a norm's scale is the only 1-D weight
            leaf = "scale" if arr.ndim == 1 else "kernel"
        if leaf == "kernel":
            if owner in ("dwconv", "stem") and arr.ndim == 4:
                arr = arr[:, :, :, None, :]
            elif owner in _CONV1X1:
                arr = arr[None, None, None]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {"params": tree}


class _Writer:
    """Encoder for the msgpack subset :class:`_Reader` decodes."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n: int, fix: Optional[int], fix_max: int, codes) -> None:
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt in codes:
            if n < (1 << (8 * struct.calcsize(fmt))):
                self.out.append(code)
                self.out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def value(self, obj: Any) -> None:
        out = self.out
        if obj is None:
            out.append(0xC0)
        elif obj is True or obj is False:
            out.append(0xC3 if obj else 0xC2)
        elif isinstance(obj, np.ndarray):
            self._ext(1, obj)
        elif isinstance(obj, np.generic):
            self._ext(3, np.asarray(obj))
        elif isinstance(obj, int):
            self._int(obj)
        elif isinstance(obj, float):
            out.append(0xCB)
            out += struct.pack(">d", obj)
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            self._head(len(raw), 0xA0, 31,
                       ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            out += raw
        elif isinstance(obj, (bytes, bytearray)):
            self._head(len(obj), None, 0,
                       ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
            out += obj
        elif isinstance(obj, (list, tuple)):
            self._head(len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
            for v in obj:
                self.value(v)
        elif isinstance(obj, dict):
            self._head(len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
            for k in sorted(obj):  # flax writes maps in key order
                self.value(k)
                self.value(obj[k])
        else:
            raise TypeError(f"cannot msgpack {type(obj)}")

    def _int(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        fmts = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 \
            else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for code, fmt in fmts:
            try:
                packed = struct.pack(fmt, v)
            except struct.error:
                continue
            self.out.append(code)
            self.out += packed
            return
        raise ValueError(f"integer {v} out of msgpack range")

    def _ext(self, code: int, arr: np.ndarray) -> None:
        """flax's array extension: msgpack ``[shape, dtype name, bytes]``."""
        inner = _Writer()
        inner.value([list(arr.shape), arr.dtype.name,
                     np.ascontiguousarray(arr).tobytes()])
        data = bytes(inner.out)
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(fixed[n])
        else:
            self._head(n, None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        self.out += struct.pack(">b", code)
        self.out += data


def msgpack_encode(obj: Any) -> bytes:
    w = _Writer()
    w.value(obj)
    return bytes(w.out)


def save_checkpoint(
    path: str,
    cfg: dict,
    state_dict: Dict[str, torch.Tensor],
    opt_state: Optional[dict] = None,
    dataset_mean: float = 0.0,
    dataset_std: float = 1.0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a ``.skoots`` checkpoint of a ``SpatialEmbedding`` state dict
    and an optimizer state (a flax state dict of numpy leaves, or None),
    atomically: a crash never truncates the file."""
    from skoots_tpu_torch.config import to_plain

    state = {
        "cfg": to_plain(cfg),
        "params": flax_params_from_torch(state_dict),
        "opt_state": opt_state,
        "dataset_mean": float(dataset_mean),
        "dataset_std": float(dataset_std),
        "extra": to_plain(extra or {}),
    }
    blob = msgpack_encode(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(blob)
    os.replace(tmp, path)
