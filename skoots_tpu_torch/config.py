"""Configuration as plain nested dicts (port of ``skoots_tpu/config.py``).

The same sections and keys as the JAX package (and the reference SKOOTS
yacs schema), so one YAML file drives either package. A cfg is a dict of
section dicts: ``cfg["TRAIN"]["SEED"]``.

* :func:`get_cfg_defaults` -- a fresh copy of the defaults;
* :func:`merge_from_dict` / :func:`load_cfg_from_file` -- the strict merge:
  an unknown key raises (PyYAML is imported only inside the file loader);
* :func:`cfg_from_dict` -- the lenient merge of a checkpoint's embedded cfg,
  which keeps unknown keys so checkpoints of other versions still load;
* :func:`validate_cfg` -- the reference validators, raising ``ValueError``.
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Dict

_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "SYSTEM": {
        "NUM_GPUS": 1,
        "NUM_CPUS": 1,
        "MESH_DATA": -1,
        "MESH_SPACE": 1,
    },
    "MODEL": {
        "ARCHITECTURE": "bism_unext",
        "IN_CHANNELS": 1,
        "OUT_CHANNELS": 32,
        "DIMS": [32, 64, 128, 64, 32],
        "DEPTHS": [2, 2, 2, 2, 2],
        "KERNEL_SIZE": 7,
        "DROP_PATH_RATE": 0.0,
        "LAYER_SCALE_INIT_VALUE": 1.0,
        "ACTIVATION": "gelu",
        "BLOCK": "block3d",
        "CONCAT_BLOCK": "concatconv3d",
        "UPSAMPLE_BLOCK": "upsamplelayer3d",
        "NORMALIZATION": "layernorm",
        "COMPILE": True,
        "DTYPE": "bfloat16",
        "DWCONV_IMPL": "auto",
    },
    "TRAIN": {
        "TARGET": "skoots",
        "DISTRIBUTED": True,
        "PRETRAINED_MODEL_PATH": [],
        "LOAD_PRETRAINED_OPTIMIZER": False,
        "TRANSFORM_DEVICE": "default",
        "DATALOADER_OUTPUT_DEVICE": "default",
        "DATALOADER_NUM_WORKERS": 0,
        "DATALOADER_PREFETCH_FACTOR": 2,
        "LOSS_EMBED": "tversky",
        "LOSS_EMBED_KEYWORDS": ["alpha", "beta", "eps"],
        "LOSS_EMBED_VALUES": [0.25, 0.75, 1e-8],
        "LOSS_PROBABILITY": "tversky",
        "LOSS_PROBABILITY_KEYWORDS": ["alpha", "beta", "eps"],
        "LOSS_PROBABILITY_VALUES": [0.5, 0.5, 1e-8],
        "LOSS_SKELETON": "tversky",
        "LOSS_SKELETON_KEYWORDS": ["alpha", "beta", "eps"],
        "LOSS_SKELETON_VALUES": [0.5, 1.5, 1e-8],
        "LOSS_EMBED_RELATIVE_WEIGHT": 1.0,
        "LOSS_PROBABILITY_RELATIVE_WEIGHT": 1.0,
        "LOSS_SKELETON_RELATIVE_WEIGHT": 1.0,
        "LOSS_EMBED_START_EPOCH": -1,
        "LOSS_PROBABILITY_START_EPOCH": -1,
        "LOSS_SKELETON_START_EPOCH": 10,
        "TRAIN_DATA_DIR": [],
        "TRAIN_SAMPLE_PER_IMAGE": [],
        "TRAIN_BATCH_SIZE": 1,
        "VALIDATION_DATA_DIR": [],
        "VALIDATION_SAMPLE_PER_IMAGE": [],
        "VALIDATION_BATCH_SIZE": 1,
        "BACKGROUND_DATA_DIR": [],
        "BACKGROUND_SAMPLE_PER_IMAGE": [],
        "BACKGROUND_MASK_MODE": "zeros",
        "TRAIN_STORE_DATA_ON_GPU": [],
        "VALIDATION_STORE_DATA_ON_GPU": [],
        "BACKGROUND_STORE_DATA_ON_GPU": [],
        "STORE_DATA_ON_GPU": [],
        "INITIAL_SIGMA": [20.0, 20.0, 20.0],
        "SIGMA_DECAY": [[0.66, 200], [0.66, 800], [0.66, 1500], [0.5, 20000],
                        [0.5, 20000]],
        "NUM_EPOCHS": 10000,
        "LEARNING_RATE": 5e-4,
        "WEIGHT_DECAY": 1e-6,
        "OPTIMIZER": "adamw",
        "OPTIMIZER_KEYWORD_ARGUMENTS": [],
        "OPTIMIZER_KEYWORD_VALUES": [],
        "OPTIMIZER_EPS": 1e-8,
        "SCHEDULER": "cosine_annealing_warm_restarts",
        "SCHEDULER_T0": 10000 + 1,
        "MIXED_PRECISION": True,
        "N_WARMUP": 3,
        "SAVE_PATH": "./models",
        "SKELETON_MASK_RADIUS": 9,
        "SKELETON_MASK_FLANK_RADIUS": 3,
        "SAVE_INTERVAL": 100,
        "VALIDATE_EPOCH_SKIP": 10,
        "CUDNN_BENCHMARK": True,
        "AUTOGRAD_PROFILE": False,
        "AUTOGRAD_EMIT_NVTX": False,
        "AUTOGRAD_DETECT_ANOMALY": False,
        "SEED": 101196,
        "MAX_INSTANCES_PER_CROP": 32,
        "MAX_SKELETON_POINTS": 512,
    },
    "AUGMENTATION": {
        "CROP_WIDTH": 300,
        "CROP_HEIGHT": 300,
        "CROP_DEPTH": 20,
        "FLIP_RATE": 0.5,
        "BRIGHTNESS_RATE": 0.4,
        "BRIGHTNESS_RANGE": [-0.1, 0.1],
        "NOISE_GAMMA": 0.1,
        "NOISE_RATE": 0.2,
        "CONTRAST_RATE": 0.33,
        "CONTRAST_RANGE": [0.75, 2.0],
        "AFFINE_RATE": 0.66,
        "AFFINE_SCALE": [0.85, 1.1],
        "AFFINE_YAW": [-180, 180],
        "AFFINE_SHEAR": [-7, 7],
        "SMOOTH_SKELETON_KERNEL_SIZE": (3, 3, 1),
        "BAKE_SKELETON_ANISOTROPY": (1.0, 1.0, 3.0),
        "N_SKELETON_MASK_DILATE": 1,
        "ELASTIC_GRID_SHAPE": (6, 6, 2),
        "ELASTIC_GRID_MAGNITUDE": (0.05, 0.05, 0.01),
        "ELASTIC_RATE": 0.33,
        "INVERT_RATE": 0.4,
    },
    "SKOOTS": {
        "VECTOR_SCALING": (60, 60, 60 // 5),
        "ANISOTROPY": (1.0, 1.0, 3.0),
        "NOTES": "",
    },
    "EXPERIMENTAL": {
        "DIST_THR": 10.0,
        "IS_SPARSE": False,
        "SPARSE_BACKGROUND_PENALTY_MULTIPLIER": 10,
        "BACKGROUND_N_ERODE": 0.0,
        "BACKGROUND_SLICE_PERCENTAGE": 1.0,
    },
}


def get_cfg_defaults() -> Dict[str, Dict[str, Any]]:
    """A fresh deep copy of the default cfg."""
    return copy.deepcopy(_DEFAULTS)


def _coerce(value: Any, template: Any) -> Any:
    """Light type coercion on merge (list -> tuple, int -> float)."""
    if isinstance(template, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(template, float) and isinstance(value, int) \
            and not isinstance(value, bool):
        return float(value)
    return value


def merge_from_dict(cfg: dict, other: dict, _path: str = "") -> dict:
    """Strict merge of ``other`` into ``cfg`` (in place): an unknown key
    raises ``KeyError``, a section given a non-dict raises ``TypeError``."""
    for k, v in other.items():
        full = f"{_path}.{k}" if _path else k
        if k not in cfg:
            raise KeyError(f"Unknown config key: {full}")
        if isinstance(cfg[k], dict):
            if not isinstance(v, dict):
                raise TypeError(f"Config key {full} expects a section, got {type(v)}")
            merge_from_dict(cfg[k], v, full)
        else:
            cfg[k] = _coerce(v, cfg[k])
    return cfg


def _merge_lenient(node: dict, d: dict) -> None:
    for k, v in d.items():
        if k not in node:
            node[k] = copy.deepcopy(v)
        elif isinstance(node[k], dict) and isinstance(v, dict):
            _merge_lenient(node[k], v)
        else:
            node[k] = _coerce(v, node[k])


def cfg_from_dict(d: dict) -> dict:
    """Defaults merged with ``d`` (a checkpoint's embedded cfg), keeping
    unknown keys."""
    cfg = get_cfg_defaults()
    _merge_lenient(cfg, d)
    return cfg


_VALID_ARCHITECTURES = ("bism_unext", "unext", "bism_unet", "unet")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def validate_cfg(cfg: dict) -> None:
    """The reference validators (``skoots_tpu/config.py:271-318``)."""
    cm = cfg["MODEL"]
    _require(cm["ARCHITECTURE"] in _VALID_ARCHITECTURES,
             f"unsupported MODEL.ARCHITECTURE {cm['ARCHITECTURE']!r}; "
             f"valid: {_VALID_ARCHITECTURES}")
    _require(cm["IN_CHANNELS"] == 1,
             f"only greyscale input supported; IN_CHANNELS={cm['IN_CHANNELS']} != 1")
    _require(cm["OUT_CHANNELS"] == cm["DIMS"][-1],
             f"OUT_CHANNELS={cm['OUT_CHANNELS']} != DIMS[-1]={cm['DIMS'][-1]}")
    _require(len(cm["DIMS"]) == len(cm["DEPTHS"]),
             "MODEL.DIMS and MODEL.DEPTHS length mismatch")
    _require(len(cm["DIMS"]) % 2 == 1, "MODEL.DIMS must describe a symmetric U (odd length)")
    _require(cm["KERNEL_SIZE"] >= 3 and cm["KERNEL_SIZE"] % 2 == 1,
             "kernel size must be odd and >=3")
    if cm["KERNEL_SIZE"] >= 9:
        warnings.warn("kernel size >= 9 is unusually large")
    for val in (cm["BLOCK"], cm["CONCAT_BLOCK"], cm["UPSAMPLE_BLOCK"]):
        _require("3d" in val, f"model part must be 3d, not {val!r}")

    x, y, _ = cfg["SKOOTS"]["VECTOR_SCALING"]
    if x < 5 or y < 5:
        warnings.warn("SKOOTS.VECTOR_SCALING below a reasonable value (default (60,60,12))")
    if not any(v == 1 for v in cfg["SKOOTS"]["ANISOTROPY"]):
        warnings.warn("SKOOTS.ANISOTROPY should be relative (default (1,1,3))")

    ct = cfg["TRAIN"]
    _require(ct["TARGET"] == "skoots", 'cfg.TRAIN.TARGET must be "skoots"')
    for name in ("LOSS_EMBED", "LOSS_PROBABILITY", "LOSS_SKELETON"):
        _require(len(ct[f"{name}_KEYWORDS"]) == len(ct[f"{name}_VALUES"]),
                 f"TRAIN.{name}_KEYWORDS and _VALUES length mismatch")
        _require(ct[f"{name}_RELATIVE_WEIGHT"] >= 0, f"TRAIN.{name}_RELATIVE_WEIGHT < 0")
    _require(len(ct["TRAIN_DATA_DIR"]) == len(ct["TRAIN_SAMPLE_PER_IMAGE"]),
             "each TRAIN_DATA_DIR needs a TRAIN_SAMPLE_PER_IMAGE entry")
    _require(len(ct["VALIDATION_DATA_DIR"]) == len(ct["VALIDATION_SAMPLE_PER_IMAGE"]),
             "each VALIDATION_DATA_DIR needs a VALIDATION_SAMPLE_PER_IMAGE entry")
    _require(ct["TRAIN_BATCH_SIZE"] >= 1 and ct["VALIDATION_BATCH_SIZE"] >= 1,
             "batch sizes must be >= 1")
    _require(len(ct["OPTIMIZER_KEYWORD_ARGUMENTS"]) == len(ct["OPTIMIZER_KEYWORD_VALUES"]),
             "TRAIN.OPTIMIZER_KEYWORD_ARGUMENTS and _VALUES length mismatch")
    _require(ct["VALIDATE_EPOCH_SKIP"] >= 1, "cannot skip negative numbers")


def load_cfg_from_file(path: str) -> dict:
    """Defaults strictly merged with a YAML file, then validated."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    cfg = merge_from_dict(get_cfg_defaults(), data)
    validate_cfg(cfg)
    return cfg


def to_plain(obj: Any) -> Any:
    """Tuples -> lists, recursively (msgpack and YAML have no tuple)."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj
