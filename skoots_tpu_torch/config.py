"""Configuration as plain nested dicts (port of ``skoots_tpu/config.py``).

The same sections and keys as the JAX package (and the reference SKOOTS
yacs schema), so one YAML file drives either package. A cfg is a dict of
section dicts: ``cfg["TRAIN"]["SEED"]``.

* :func:`get_cfg_defaults` -- a fresh copy of the defaults;
* :func:`merge_from_dict` / :func:`load_cfg_from_file` -- the strict merge:
  an unknown key raises; the file is read by :func:`load_yaml`, the YAML
  subset cfg files use, so no PyYAML is needed;
* :func:`cfg_from_dict` -- the lenient merge of a checkpoint's embedded cfg,
  which keeps unknown keys so checkpoints of other versions still load;
* :func:`validate_cfg` -- the reference validators, raising ``ValueError``;
* :func:`dump_yaml` -- ``yaml.safe_dump``'s text for what :func:`load_yaml`
  reads, so a tool can write a cfg without PyYAML.
"""

from __future__ import annotations

import copy
import re
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


class YamlSubsetError(ValueError):
    """The text uses YAML beyond what :func:`load_yaml` reads."""


# PyYAML's YAML 1.1 implicit resolvers (``yaml/resolver.py``): a plain
# scalar takes the first tag whose pattern matches, in this order
_RESOLVERS = (
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("merge", re.compile(r"^(?:<<)$")),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$")),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("value", re.compile(r"^(?:=)$")),
)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED_START = "&*!|>%@`"


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _plain_scalar(text: str, line: int, flow: bool = False) -> Any:
    """A plain scalar resolved and constructed as ``yaml.safe_load`` does."""
    if text[:1] in _UNSUPPORTED_START:
        raise YamlSubsetError(f"line {line}: anchors, aliases, tags and block "
                              f"scalars are not read ({text!r})")
    # what may start a plain scalar (PyYAML's scanner, check_plain)
    first, second = text[:1], text[1:2]
    if first in ",[]{}#'\"" or (first in "-:?" and (second in ("", " ")
                                                   or (flow and first != "-"))):
        raise YamlSubsetError(f"line {line}: an indicator where a value belongs ({text!r})")
    tag = next(t for t, pattern in _RESOLVERS + (("str", re.compile("")),)
               if pattern.match(text))
    if tag in ("merge", "timestamp", "value"):
        raise YamlSubsetError(f"line {line}: a {tag} scalar is not read ({text!r})")
    if tag == "str":
        return text
    if tag == "null":
        return None
    if tag == "bool":
        return text.lower() in ("yes", "true", "on")
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if tag == "int":
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    value = value.lower()
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * (_sexagesimal(value, float) if ":" in value else float(value))


class _Flow:
    """Cursor over one flow collection or quoted scalar (possibly joined
    from several lines)."""

    def __init__(self, text: str, line: int):
        self.text, self.pos, self.line = text, 0, line

    def fail(self, what: str):
        raise YamlSubsetError(f"line {self.line}: {what} in {self.text!r}")

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos:self.pos + 1]

    def quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                self.fail("unterminated quoted scalar")
            ch = self.text[self.pos]
            if quote == "'" and ch == "'":
                if self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == '"':
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == "\\":
                esc = self.text[self.pos + 1:self.pos + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.pos += 2
                elif esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = self.text[self.pos + 2:self.pos + 2 + n]
                    if len(digits) != n or not all(c in "0123456789abcdefABCDEF"
                                                   for c in digits):
                        self.fail(f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                else:
                    self.fail(f"unknown escape \\{esc}")
                continue
            out.append(ch)
            self.pos += 1

    def scalar(self) -> Any:
        if self.peek() in ("'", '"'):
            return self.quoted()
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch in ",[]{}":
                break
            if ch == ":" and self.text[self.pos + 1:self.pos + 2] in ("", " ", ",", "[",
                                                                      "]", "{", "}"):
                break
            self.pos += 1
        text = self.text[start:self.pos].rstrip()
        if not text:
            self.fail("empty flow entry")
        return _plain_scalar(text, self.line, flow=True)

    def node(self) -> Any:
        self.skip_space()
        ch = self.peek()
        if ch not in ("[", "{"):
            return self.scalar()
        close = "]" if ch == "[" else "}"
        self.pos += 1
        items: Any = [] if ch == "[" else {}
        while True:
            self.skip_space()
            if self.peek() == close:
                self.pos += 1
                return items
            if ch == "[":
                items.append(self.node())
            else:
                key = self.node()
                self.skip_space()
                if self.peek() != ":":
                    self.fail("expected ':' in a flow mapping")
                self.pos += 1
                items[key] = self.node()
            self.skip_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != close:
                self.fail(f"expected ',' or {close!r}")


def _outside_quotes(text: str):
    """``(i, ch)`` for every character of a line outside its quoted scalars
    (a quote opens at the start or after a space, ``[``, ``{``, ``,`` or
    ``:``; ``''`` and backslash escapes stay inside)."""
    quote, i = None, 0
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'" and text[i + 1:i + 2] == "'":
            i += 2
            continue
        if quote == '"' and ch == "\\":
            i += 2
            continue
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or text[i - 1] in " [{,:"):
            quote = ch
        else:
            yield i, ch
        i += 1


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` at the start or
    after a space, outside quotes)."""
    for i, ch in _outside_quotes(text):
        if ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
    return text.rstrip()


def _key_split(text: str):
    """``(key, rest)`` at the first ``: `` (or a final ``:``) outside quotes,
    or None when the line holds no key (a line that opens a flow
    collection holds none)."""
    if text[:1] in "[{":
        return None
    for i, ch in _outside_quotes(text):
        if ch == ":" and text[i + 1:i + 2] in ("", " "):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


def load_yaml(text: str) -> Any:
    """``yaml.safe_load(text)`` for the YAML that cfg files use, without
    PyYAML: block mappings, block sequences (also indentless ones and
    ``- -`` nesting), flow sequences and mappings (also over several lines),
    plain and quoted scalars resolved by YAML 1.1 as PyYAML resolves them
    (``1e-3`` stays a string, ``1.0e-3`` is a float, ``yes`` is True, ``~``
    None), and comments. Anything else (anchors, aliases, tags, block or
    multi-line scalars, complex keys, tabs in indentation, several
    documents) raises :class:`YamlSubsetError` with its line number."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        stripped = raw.lstrip(" ")
        if stripped.startswith("\t") or (stripped and raw[:len(raw) - len(stripped)]
                                          .count("\t")):
            raise YamlSubsetError(f"line {n}: a tab in the indentation")
        content = _strip_comment(stripped)
        if content:
            lines.append([n, len(raw) - len(stripped), content])
    if lines and lines[0][2] == "---":
        lines.pop(0)
    if lines and lines[-1][2] == "...":
        lines.pop()
    for n, _, content in lines:
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            raise YamlSubsetError(f"line {n}: directives and several documents "
                                  "are not read")
    if not lines:
        return None
    pos = 0

    def inline(n: int, content: str) -> Any:
        """The value written on one line after ``key:`` or ``- ``."""
        nonlocal pos
        if content[0] in "[{'\"":
            joined = content
            flow = _Flow(joined, n)
            while True:  # a flow collection may continue on the next lines
                try:
                    flow.pos = 0
                    value = flow.node()
                    break
                except YamlSubsetError:
                    if content[0] in "'\"" or pos >= len(lines):
                        raise
                    joined += " " + lines[pos][2]
                    pos += 1
                    flow = _Flow(joined, n)
            flow.skip_space()
            if flow.pos != len(joined):
                flow.fail("text after the value")
            return value
        if _key_split(content) is not None:
            raise YamlSubsetError(f"line {n}: a mapping on the line of its key "
                                  "is not read")
        return _plain_scalar(content, n)

    def block(indent: int) -> Any:
        nonlocal pos
        n, ind, content = lines[pos]
        if ind != indent:
            raise YamlSubsetError(f"line {n}: unexpected indentation")
        is_seq = content == "-" or content.startswith("- ")
        out: Any = [] if is_seq else {}
        while pos < len(lines):
            n, ind, content = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"line {n}: unexpected indentation "
                                      "(multi-line scalars are not read)")
            if is_seq:
                if not (content == "-" or content.startswith("- ")):
                    break
                rest = content[1:].lstrip(" ")
                if rest and (rest == "-" or rest.startswith("- ")
                             or _key_split(rest) is not None):
                    # "- - x" or "- key: v": the rest opens a block one level in
                    lines[pos] = [n, ind + len(content) - len(rest), rest]
                    out.append(block(lines[pos][1]))
                    continue
                pos += 1
                out.append(inline(n, rest) if rest else nested(indent, seq=True))
                continue
            split = _key_split(content)
            if split is None:
                if content == "-" or content.startswith("- "):
                    break
                raise YamlSubsetError(f"line {n}: expected 'key: value'")
            key_text, rest = split
            if not key_text:
                raise YamlSubsetError(f"line {n}: complex keys are not read")
            key = inline(n, key_text)
            pos += 1
            out[key] = inline(n, rest) if rest else nested(indent, seq=False)
        return out

    def nested(indent: int, seq: bool) -> Any:
        """The block under a ``key:`` or ``-`` that ends its line."""
        if pos >= len(lines):
            return None
        _, ind, content = lines[pos]
        if ind > indent:
            return block(ind)
        if not seq and ind == indent and (content == "-" or content.startswith("- ")):
            return block(ind)  # an indentless sequence under a key
        return None

    first = lines[0]
    if _key_split(first[2]) is None and not (first[2] == "-" or first[2].startswith("- ")):
        pos = 1  # a document of one scalar or flow collection
        value = inline(first[0], first[2])
    else:
        value = block(first[1])
    if pos < len(lines):
        raise YamlSubsetError(f"line {lines[pos][0]}: text after the document's value "
                              "(or an unexpected indentation)")
    return value


# what ends a plain scalar's indicator test (PyYAML's emitter,
# analyze_scalar): the end of the text or whitespace
_BLANK = "\0 \t\r\n\x85\u2028\u2029"


def _plain_allowed(text: str) -> bool:
    """Whether PyYAML's emitter writes ``text`` as a block plain scalar: not
    empty, printable ASCII on one line, no leading or trailing space, no
    indicator that would end or change it, and it reads back as a string."""
    if not text or text[0] == " " or text[-1] == " " or text.startswith(("---", "...")):
        return False
    if any(not " " <= ch <= "~" for ch in text):
        return False
    for i, ch in enumerate(text):
        followed = i + 1 == len(text) or text[i + 1] in _BLANK
        if i == 0 and (ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed)):
            return False
        if i > 0 and ((ch == ":" and followed) or (ch == "#" and text[i - 1] in _BLANK)):
            return False
    return not any(pattern.match(text) for _, pattern in _RESOLVERS)


_DUMP_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n",
                 "\x0b": "v", "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"',
                 "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _dump_scalar(value: Any) -> str:
    """One scalar as ``yaml.safe_dump`` writes it (PyYAML's representer and
    emitter at their defaults: plain where allowed, else single quotes, or
    double quotes with escapes for what is not printable ASCII)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if not isinstance(value, str):
        raise YamlSubsetError(f"dump_yaml: cannot write a {type(value).__name__}")
    if _plain_allowed(value):
        return value
    if all(" " <= ch <= "~" for ch in value):
        return "'" + value.replace("'", "''") + "'"
    out = []
    for ch in value:
        if ch in _DUMP_ESCAPES:
            out.append("\\" + _DUMP_ESCAPES[ch])
        elif " " <= ch <= "~":
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02X}")
        elif ord(ch) <= 0xFFFF:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _dump_block(node: Any, indent: int) -> list:
    """The lines of a non-empty mapping or sequence at ``indent``: keys
    sorted, a sequence under a key not indented, an item that is itself a
    collection opening on its ``- `` line, as PyYAML's emitter writes them."""
    pad = " " * indent
    lines = []
    if isinstance(node, dict):
        for key in sorted(node):
            value = node[key]
            head = pad + _dump_scalar(key) + ":"
            if isinstance(value, dict) and value:
                lines += [head, *_dump_block(value, indent + 2)]
            elif isinstance(value, (list, tuple)) and value:
                lines += [head, *_dump_block(value, indent)]
            else:
                lines.append(head + " " + _dump_inline(value))
        return lines
    for item in node:
        if isinstance(item, (dict, list, tuple)) and item:
            sub = _dump_block(item, indent + 2)
            sub[0] = pad + "- " + sub[0][indent + 2:]
            lines += sub
        else:
            lines.append(pad + "- " + _dump_inline(item))
    return lines


def _dump_inline(value: Any) -> str:
    if isinstance(value, dict) and not value:
        return "{}"
    if isinstance(value, (list, tuple)) and not value:
        return "[]"
    return _dump_scalar(value)


def dump_yaml(obj: Any) -> str:
    """``yaml.safe_dump(obj)``'s text without PyYAML, for what
    :func:`load_yaml` reads: nested dicts with scalar keys, lists (also of
    lists, and tuples written as lists), ints, floats, bools, strings and
    None, in block style with sorted keys, so ``load_yaml(dump_yaml(x)) ==
    x``. Strings are never folded across lines (PyYAML folds scalars longer
    than 80 columns at their spaces); anything else raises
    :class:`YamlSubsetError`."""
    if isinstance(obj, (dict, list, tuple)) and obj:
        return "\n".join(_dump_block(obj, 0)) + "\n"
    text = _dump_inline(obj)
    # PyYAML ends a document that is one plain scalar with an explicit end
    return text + ("\n...\n" if text[:1] not in "{['\"" else "\n")


def load_cfg_from_file(path: str) -> dict:
    """Defaults strictly merged with a YAML file (read by :func:`load_yaml`,
    no PyYAML needed), then validated."""
    with open(path) as f:
        data = load_yaml(f.read()) or {}
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
