"""Reference SKOOTS ``.trch`` checkpoints to ``.skoots`` (port of
``skoots_tpu/utils/torch_compat.py``).

The reference checkpoint is a ``torch.save`` dict with keys 'cfg' (yacs),
'model_state_dict', 'optimizer_state_dict', 'dataset_mean', 'dataset_std'.
:func:`convert_trch` reads it, rebuilds the cfg and re-expresses the weights
in the flax parameter tree that ``.skoots`` files hold, which both packages
load.

Mapping, as JAX's: a NAME-based pass first (:func:`role_from_torch_key`:
the bism / upstream-ConvNeXt naming families), then the leftovers zipped in
network order (:func:`ordered_flax_roles`, the module-registration order of
bism's ``SpatialEmbedding(UNeXT_3D)``), aligned by the longest common
subsequence of their shape signatures where the two sequences differ. Every
pair is shape-checked. Conventions:

- torch Conv3d ``[O, I, kx, ky, kz]`` -> flax ``[kx, ky, kz, I, O]``
  (depthwise ``[C, 1, k, k, k]`` and dense convs);
- torch 1x1x1 Conv3d ``[O, I, 1, 1, 1]`` -> flax Dense ``[I, O]`` where the
  flax side is a Dense kernel (the pointwise layers);
- torch Linear ``[O, I]`` -> flax Dense ``[I, O]``;
- 1-D vectors (biases, LayerNorm weight/bias, layer-scale gamma) verbatim.

Without flax, the parameter tree the mapper fills is the port's own model's
(``checkpoint.flax_params_from_torch`` of ``models.init_model(cfg, 0)``),
a nested dict of numpy f32 arrays keyed as flax's.
"""

from __future__ import annotations

import copy
import difflib
import logging
from typing import Any, Dict, List, Tuple

import numpy as np

from skoots_tpu_torch.config import cfg_from_dict, get_cfg_defaults

log = logging.getLogger(__name__)

Path = Tuple[str, ...]


def ordered_flax_roles(cfg) -> List[Path]:
    """Flax parameter paths of ``SpatialEmbedding(UNeXT3D(cfg))`` in network
    (= torch registration) order. Mirrors ``models/unext.py``."""
    m = cfg["MODEL"]
    if m["ARCHITECTURE"] not in ("bism_unext", "unext"):
        raise NotImplementedError(
            f"ordered mapping only implemented for unext, got {m['ARCHITECTURE']!r}")
    dims = list(m["DIMS"])
    depths = list(m["DEPTHS"])
    k_down = len(dims) // 2
    bb = ("params", "backbone")
    roles: List[Path] = [bb + ("stem", "kernel"), bb + ("stem", "bias")]

    def block(name: str) -> List[Path]:
        # torch state_dict order: direct parameters precede submodules, so a
        # ConvNeXt block's layer-scale gamma (a bare nn.Parameter) comes first
        p = bb + (name,)
        return [
            p + ("gamma",),
            p + ("dwconv", "kernel"), p + ("dwconv", "bias"),
            p + ("norm", "scale"), p + ("norm", "bias"),
            p + ("pw1", "kernel"), p + ("pw1", "bias"),
            p + ("pw2", "kernel"), p + ("pw2", "bias"),
        ]

    for s in range(k_down):
        for i in range(depths[s]):
            roles += block(f"enc{s}_block{i}")
        d = bb + (f"down{s}",)
        roles += [d + ("norm", "scale"), d + ("norm", "bias"),
                  d + ("conv", "kernel"), d + ("conv", "bias")]
    for i in range(depths[k_down]):
        roles += block(f"bottleneck_block{i}")
    for s in range(k_down):
        c = bb + (f"concat{s}",)
        roles += [c + ("fuse", "kernel"), c + ("fuse", "bias")]
        for i in range(depths[k_down + 1 + s]):
            roles += block(f"dec{s}_block{i}")
    roles += [bb + ("final_norm", "scale"), bb + ("final_norm", "bias"),
              bb + ("head_conv", "kernel"), bb + ("head_conv", "bias")]
    for head in ("vector_head", "skeleton_head", "semantic_head"):
        roles += [("params", head, "kernel"), ("params", head, "bias")]
    return roles


_HEAD_KEYWORDS = (
    ("vector_head", ("vector", "embed")),
    ("skeleton_head", ("skel",)),
    ("semantic_head", ("semantic", "prob", "mask")),
)


def role_from_torch_key(key: str, cfg) -> Path | None:
    """Classify a torch state-dict key by NAME into a flax parameter path.

    Name-based classification is robust to module-REGISTRATION order — the
    failure mode order-alignment cannot protect against (a bism variant
    registering e.g. all downsample layers before all stages, the upstream
    ConvNeXt convention, would silently shift an order-zip). Recognized
    naming families (upstream-ConvNeXt + bism conventions):

    - ``downsample_layers.0.*`` / ``stem.*`` — the stem conv (a trailing
      LayerNorm inside the stem Sequential has no flax counterpart and is
      reported unmapped rather than guessed);
    - ``downsample_layers.{i>=1}.{0,1}`` — Downsample norm + strided conv;
    - ``stages.{s}.{b}`` or ``stages.{s}.blocks.{b}`` — ConvNeXt blocks
      (encoder / bottleneck / decoder split by position);
    - ``up_stages.{s}.{b}`` / ``decode_stages.{s}.{b}`` — decoder blocks;
    - ``concat*.{s}.*`` — skip-fusion convs;
    - top-level ``norm.*`` / ``final_norm.*`` — the final LayerNorm;
    - ``head*`` / ``out_conv*`` / ``final_conv*`` — the backbone head;
    - head modules whose names contain vector/embed, skel, semantic/prob —
      the SpatialEmbedding output convs.

    Returns None for unrecognized keys (the caller falls back to
    LCS order alignment for those).
    """
    k = key
    for prefix in ("module.", "model.", "_orig_mod."):
        while k.startswith(prefix):
            k = k[len(prefix):]
    if k.startswith("backbone."):
        k = k[len("backbone."):]
        in_backbone = True
    else:
        in_backbone = None  # unknown: heads match by keyword below

    k_down = len(list(cfg["MODEL"]["DIMS"])) // 2
    bb = ("params", "backbone")
    parts = k.split(".")
    leaf = parts[-1]
    body = parts[:-1]

    def block_path(stage_name: str, inner: List[str]) -> Path | None:
        trans = {"dwconv": "dwconv", "norm": "norm", "pwconv1": "pw1",
                 "pwconv2": "pw2", "pw1": "pw1", "pw2": "pw2"}
        if leaf == "gamma" and not inner:
            return bb + (stage_name, "gamma")
        if len(inner) == 1 and inner[0] in trans:
            mod = trans[inner[0]]
            if mod == "norm":
                return bb + (stage_name, "norm",
                             "scale" if leaf == "weight" else "bias")
            return bb + (stage_name, mod,
                         "kernel" if leaf == "weight" else "bias")
        return None

    def stage_name_for(s: int, b: int, decoder_attr: bool) -> str | None:
        if decoder_attr:
            return f"dec{s}_block{b}" if s < k_down else None
        if s < k_down:
            return f"enc{s}_block{b}"
        if s == k_down:
            return f"bottleneck_block{b}"
        if s - k_down - 1 < k_down:
            return f"dec{s - k_down - 1}_block{b}"
        return None

    if body and body[0] in ("downsample_layers", "stem", "init_conv"):
        if body[0] == "downsample_layers":
            if len(body) < 2 or not body[1].isdigit():
                return None
            i = int(body[1])
            inner = body[2:]
            if i == 0:  # stem Sequential: [conv, (optional LayerNorm)]
                if inner in ([], ["0"]):
                    return bb + ("stem", "kernel" if leaf == "weight" else "bias")
                return None  # stem norm etc: no flax counterpart
            if inner and inner[0] in ("0", "norm"):
                return bb + (f"down{i - 1}", "norm",
                             "scale" if leaf == "weight" else "bias")
            if inner and inner[0] in ("1", "conv"):
                return bb + (f"down{i - 1}", "conv",
                             "kernel" if leaf == "weight" else "bias")
            return None
        # stem.* / init_conv.*
        inner = body[1:]
        if inner in ([], ["0"], ["conv"]):
            return bb + ("stem", "kernel" if leaf == "weight" else "bias")
        return None

    if body and body[0] in ("stages", "up_stages", "decode_stages",
                            "dec_stages"):
        decoder_attr = body[0] != "stages"
        rest = body[1:]
        if len(rest) >= 2 and rest[0].isdigit():
            s = int(rest[0])
            rest = rest[1:]
            if rest and rest[0] == "blocks":
                rest = rest[1:]
            if rest and rest[0].isdigit():
                b = int(rest[0])
                name = stage_name_for(s, b, decoder_attr)
                if name is None:
                    return None
                return block_path(name, rest[1:])
        return None

    if body and body[0].startswith("concat"):
        rest = body[1:]
        if rest and rest[0].isdigit():
            s = int(rest[0])
            return bb + (f"concat{s}", "fuse",
                         "kernel" if leaf == "weight" else "bias")
        return None

    if body and body[0] in ("norm", "final_norm", "out_norm", "final_layer_norm"):
        if len(body) == 1:
            return bb + ("final_norm", "scale" if leaf == "weight" else "bias")
        return None

    if body and (body[0].startswith("head") or body[0] in
                 ("out_conv", "final_conv", "out")):
        if in_backbone is not False:
            return bb + ("head_conv", "kernel" if leaf == "weight" else "bias")
        return None

    if in_backbone is not True and body:
        low = ".".join(body).lower()
        for head, words in _HEAD_KEYWORDS:
            if any(w in low for w in words):
                return ("params", head, "kernel" if leaf == "weight" else "bias")
    return None


def _to_flax_convention(arr: np.ndarray, want_shape: Tuple[int, ...]) -> np.ndarray | None:
    """Re-express a torch tensor in flax convention such that it matches
    ``want_shape``; None if impossible."""
    shape = tuple(arr.shape)
    if len(shape) == 5:
        cand = np.transpose(arr, (2, 3, 4, 1, 0))  # conv kernel
        if cand.shape == tuple(want_shape):
            return cand
        if shape[2:] == (1, 1, 1) and len(want_shape) == 2:  # 1^3 conv -> Dense
            cand = arr[:, :, 0, 0, 0].T
            if cand.shape == tuple(want_shape):
                return cand
        return None
    if len(shape) == 2:
        return arr.T if arr.T.shape == tuple(want_shape) else None
    return arr if shape == tuple(want_shape) else None


def _signature(shape: Tuple[int, ...]) -> str:
    """Orientation-independent shape signature for LCS alignment. A 1^3 conv
    and a Dense/Linear of the same channel counts signature identically (the
    torch side may implement pointwise layers either way)."""
    if len(shape) == 5:
        if tuple(shape[2:]) == (1, 1, 1):  # torch 1^3 conv
            return f"mat{sorted(shape[:2])}"
        if tuple(shape[:3]) == (1, 1, 1):  # flax 1^3 conv kernel
            return f"mat{sorted(shape[3:])}"
        return f"conv{sorted(shape)}"
    if len(shape) == 2:
        return f"mat{sorted(shape)}"
    return f"vec{list(shape)}"


def _leaves(tree: dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """Every leaf of a nested dict by its key path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _align(f_sigs: List[str], t_sigs: List[str]) -> List[Tuple[int, int]]:
    """Index pairs of the two signature sequences: zipped when equal, else
    the blocks of their longest common subsequence."""
    if f_sigs == t_sigs:
        return list(zip(range(len(f_sigs)), range(len(t_sigs))))
    sm = difflib.SequenceMatcher(a=f_sigs, b=t_sigs, autojunk=False)
    pairs = []
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            pairs += list(zip(range(i1, i2), range(j1, j2)))
    return pairs


def _float_items(torch_state: Dict[str, np.ndarray]):
    """The state dict's floating tensors in registration order (integer
    buffers such as ``num_batches_tracked`` dropped)."""
    return [(k, v) for k, v in torch_state.items() if np.issubdtype(v.dtype, np.floating)]


def map_torch_state(params: dict, torch_state: Dict[str, np.ndarray], cfg):
    """Map torch tensors (numpy, in state-dict order) onto the flax tree
    ``params`` (``{'params': {...}}`` of numpy arrays).

    Two passes: names first (:func:`role_from_torch_key`), then the
    remaining keys and roles in network order (LCS alignment on shape
    signatures when the sequences differ). Every pair is shape-checked.
    Returns ``(new_params, mapped_count, unmapped_torch_keys,
    unfilled_paths)``; ``params`` itself is not changed."""
    flat = _leaves(params)
    # a role the tree lacks raises KeyError
    role_leaves = [(path, flat[path]) for path in ordered_flax_roles(cfg)]
    path_index = dict(role_leaves)
    t_items = _float_items(torch_state)
    updates: Dict[Path, np.ndarray] = {}
    used = set()

    def try_pair(path: Path, leaf, name: str, arr: np.ndarray) -> None:
        cand = _to_flax_convention(arr, tuple(leaf.shape))
        if cand is None:
            log.warning("shape mismatch at %s <- %s %s", "/".join(path), name, arr.shape)
            return
        updates[path] = cand.astype(np.asarray(leaf).dtype)
        used.add(name)

    # pass 1: name-based
    for name, arr in t_items:
        path = role_from_torch_key(name, cfg)
        if path is None or path not in path_index or path in updates:
            continue
        try_pair(path, path_index[path], name, arr)

    # pass 2: order alignment of the leftovers
    rest_roles = [(p, leaf) for p, leaf in role_leaves if p not in updates]
    rest_items = [(k, v) for k, v in t_items if k not in used]
    for fi, ti in _align([_signature(tuple(leaf.shape)) for _, leaf in rest_roles],
                         [_signature(tuple(v.shape)) for _, v in rest_items]):
        try_pair(*rest_roles[fi], *rest_items[ti])

    new_params = copy.deepcopy(params)
    for path, arr in updates.items():
        node = new_params
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = arr
    unmapped = [k for k, _ in t_items if k not in used]
    unfilled = ["/".join(p) for p, _ in role_leaves if p not in updates]
    return new_params, len(updates), unmapped, unfilled


def _from_flax_convention(
    arr: np.ndarray, want_shape: Tuple[int, ...]
) -> np.ndarray | None:
    """Inverse of :func:`_to_flax_convention`: re-express a flax leaf in the
    torch convention matching ``want_shape``; None if impossible."""
    shape = tuple(arr.shape)
    if len(want_shape) == 5:
        if len(shape) == 5:  # conv kernel [kx,ky,kz,I,O] -> [O,I,kx,ky,kz]
            cand = np.transpose(arr, (4, 3, 0, 1, 2))
            return cand if cand.shape == tuple(want_shape) else None
        if len(shape) == 2 and tuple(want_shape[2:]) == (1, 1, 1):
            cand = arr.T[:, :, None, None, None]  # Dense -> 1^3 conv
            return cand if cand.shape == tuple(want_shape) else None
        return None
    if len(want_shape) == 2:
        return arr.T if arr.T.shape == tuple(want_shape) else None
    return arr if shape == tuple(want_shape) else None


def export_torch_state(params: dict, torch_state: Dict[str, np.ndarray], cfg):
    """The reverse of :func:`map_torch_state`: fill a torch ``state_dict``
    template (numpy values, e.g. from a freshly built twin) with the flax
    parameter values, pairing tensors by the same name and order logic.

    Returns ``(new_state: Dict[str, np.ndarray], exported_count,
    skipped_torch_keys, unused_flax_paths)``."""
    flat = _leaves(params)
    role_leaves = [(path, flat[path]) for path in ordered_flax_roles(cfg)]
    path_index = dict(role_leaves)
    t_items = _float_items(torch_state)
    new_state = dict(torch_state)
    used_paths = set()
    filled_keys = set()

    def try_pair(path: Path, leaf, name: str, want: np.ndarray) -> None:
        cand = _from_flax_convention(np.asarray(leaf, np.float32), tuple(want.shape))
        if cand is None:
            log.warning("export shape mismatch %s -> %s %s", "/".join(path), name,
                        want.shape)
            return
        new_state[name] = cand.astype(want.dtype)
        used_paths.add(path)
        filled_keys.add(name)

    for name, want in t_items:
        path = role_from_torch_key(name, cfg)
        if path is None or path not in path_index or path in used_paths:
            continue
        try_pair(path, path_index[path], name, want)

    rest_roles = [(p, leaf) for p, leaf in role_leaves if p not in used_paths]
    rest_items = [(k, v) for k, v in t_items if k not in filled_keys]
    for fi, ti in _align([_signature(tuple(np.shape(leaf))) for _, leaf in rest_roles],
                         [_signature(tuple(v.shape)) for _, v in rest_items]):
        try_pair(*rest_roles[fi], *rest_items[ti])

    skipped = [k for k, _ in t_items if k not in filled_keys]
    unused = ["/".join(p) for p, _ in role_leaves if p not in used_paths]
    return new_state, len(filled_keys), skipped, unused


def _to_numpy_state(state_dict) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in state_dict.items()}


def _yacs_to_dict(node) -> Dict[str, Any]:
    out = {}
    for k in node:
        v = node[k]
        out[k] = _yacs_to_dict(v) if hasattr(v, "keys") and not isinstance(
            v, (str, list, tuple)) else v
    return out


def convert_trch(path: str, output_path: str | None = None) -> str:
    """Convert a reference ``.trch`` checkpoint to ``.skoots`` (by default
    beside it) and return the output path.

    The file is read with ``torch.load(..., weights_only=False)``: its cfg
    may be a dict or a pickled yacs node (which needs ``yacs`` to unpickle,
    as the JAX package's converter does); a file without a cfg gets the
    defaults. The output carries the translated cfg, the dataset stats, the
    mapped parameters and, in ``extra``, ``converted_from``, ``mapped``,
    ``unmapped_torch_keys``, ``unfilled_params`` and
    ``torch_state_dict_keys``, as JAX's does. Parameters no tensor filled
    keep the port's own initialisation (``models.init_model(cfg, 0)``),
    which differs from the JAX converter's flax ``PRNGKey(0)`` init: only a
    fully mapped checkpoint converts to the same parameters in both."""
    import torch

    from skoots_tpu_torch.checkpoint import (flax_params_from_torch, save_checkpoint,
                                             torch_params_from_flax)
    from skoots_tpu_torch.models import init_model

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "cfg" in ckpt:
        cfg = cfg_from_dict(_yacs_to_dict(ckpt["cfg"]))
    else:
        log.warning("legacy checkpoint without cfg; using defaults")
        cfg = get_cfg_defaults()

    state = _to_numpy_state(ckpt.get("model_state_dict", ckpt))
    mean = float(ckpt.get("dataset_mean", 0.0))
    std = float(ckpt.get("dataset_std", 1.0))

    params = flax_params_from_torch(init_model(cfg, 0, device="cpu").state_dict())
    params, mapped, unmapped, unfilled = map_torch_state(params, state, cfg)
    if unmapped or unfilled:
        log.warning(
            "%d torch tensors unmapped (%s...); %d flax params left at init (%s...)",
            len(unmapped), unmapped[:5], len(unfilled), unfilled[:5])
    out = output_path or path.rsplit(".", 1)[0] + ".skoots"
    save_checkpoint(
        out, cfg, torch_params_from_flax(params), dataset_mean=mean, dataset_std=std,
        extra={
            "converted_from": path,
            "mapped": mapped,
            "unmapped_torch_keys": sorted(unmapped),
            "unfilled_params": sorted(unfilled),
            "torch_state_dict_keys": [k for k in state],
        },
    )
    log.info("converted %s -> %s (%d/%d tensors mapped)", path, out, mapped, len(state))
    return out
