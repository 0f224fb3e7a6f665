"""Configuration system: yaml-backed frozen config nodes.

Re-creates the workflow of the reference's yacs-based config
(``/root/reference/QFA/config.py``) without the yacs dependency: a nested
``ConfigNode`` with attribute access, recursive ``BASE`` yaml inheritance,
``KEY.SUBKEY value`` list overrides, CLI merging and freezing. Key names are
identical (``DATA.*``, ``MODEL.*``, ``TRAIN.*``) so reference yaml configs
port over unchanged; keys the reference lacks live under ``MESH.*`` and
``RUNTIME.*``.

The files are read and written by a small reader for the YAML subset the
configs use — nested mappings of scalars, lists of scalars (flow
``[a, b]`` or block ``- a`` style), comments — so the CLI needs no YAML
package.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

__all__ = [
    "ConfigNode",
    "REMOVED_KEYS",
    "default_config",
    "load_config",
    "get_config",
]

#: keys of the removed hand-written kernel engines. A config that still
#: sets one fails by name rather than being silently ignored.
REMOVED_KEYS = frozenset({
    "TRAIN.ENGINE",
    "TRAIN.MXU_BF16",
    "TRAIN.BWD_WIDE",
    "TRAIN.EPOCHS_PER_LAUNCH",
    "TRAIN.DP_EXACT",
    "TRAIN.BATCHES_PER_LAUNCH",
})


def _check_removed(path: str) -> None:
    if path in REMOVED_KEYS:
        raise ValueError(
            f"config key {path} was removed with the hand-written kernel "
            "engines; the XLA path is the only engine — delete the key"
        )


class ConfigNode(dict):
    """A dict with attribute access, freezing, and yaml merge support."""

    _FROZEN = "_ConfigNode__frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value):
        if getattr(self, ConfigNode._FROZEN):
            raise AttributeError(f"config is frozen; cannot set {name!r}")
        super().__setitem__(name, value)

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    # -- merging ------------------------------------------------------------
    def merge_dict(self, other: dict, prefix: str = "") -> None:
        for k, v in other.items():
            _check_removed(prefix + k)
            if (
                k in self
                and isinstance(self[k], ConfigNode)
                and isinstance(v, dict)
            ):
                self[k].merge_dict(v, prefix=f"{prefix}{k}.")
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        """Merge a yaml file, honoring recursive ``BASE`` inheritance
        (paths relative to the including file, like the reference)."""
        with open(path) as f:
            loaded = parse_yaml(f.read())
        for base in loaded.pop("BASE", []) or []:
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(path), base))
        self.merge_dict(loaded)

    def merge_from_list(self, opts: list) -> None:
        """Merge ``[KEY.SUBKEY, value, ...]`` pairs (CLI ``--opts``)."""
        if len(opts) % 2:
            raise ValueError(f"--opts needs KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            _check_removed(key)
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf)
            node[leaf] = _coerce(value, old)

    # -- io -----------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v
            for k, v in self.items()
        }

    def dump(self) -> str:
        return dump_yaml(self.to_dict())


# -- the YAML subset ---------------------------------------------------------

_INT = re.compile(r"[-+]?[0-9]+\Z")
_FLOAT = re.compile(
    r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?\Z"
)
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts a line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return tok[1:-1].encode().decode("unicode_escape")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _split_flow(body: str) -> list:
    """Split the inside of a flow list ``[a, 'b, c']`` at top-level commas."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip() or items:
        items.append(cur)
    return [_scalar(t) for t in items]


def _value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        return _split_flow(tok[1:-1])
    return _scalar(tok)


def parse_yaml(text: str) -> dict:
    """Parse the YAML subset the configs use into nested dicts.

    Supported: ``key: value`` mappings nested by indentation, scalars
    (null, booleans, ints, floats, plain or quoted strings), lists of
    scalars in flow (``[a, b]``) or block (``- a``) style, and comments.
    Anything else raises ``ValueError`` naming the line.
    """
    root: dict = {}
    # (indent of the container's entries, container); a key whose value is
    # on later lines waits in ``pending`` until its first child line
    # decides between a mapping and a list
    stack: list = []
    pending: tuple | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith("\t"):
            raise ValueError(f"line {lineno}: tab indentation: {raw!r}")
        is_item = body == "-" or body.startswith("- ")
        if not stack:
            stack.append((indent, root))
        if pending is not None:
            p_indent, p_parent, p_key = pending
            pending = None
            if is_item and indent >= p_indent:
                p_parent[p_key] = []
                stack.append((indent, p_parent[p_key]))
            elif indent > p_indent:
                p_parent[p_key] = {}
                stack.append((indent, p_parent[p_key]))
            else:
                p_parent[p_key] = None
        while True:
            top_indent, top = stack[-1]
            if isinstance(top, list) and not (is_item and indent == top_indent):
                stack.pop()
            elif isinstance(top, dict) and indent < top_indent and len(stack) > 1:
                stack.pop()
            else:
                break
        top_indent, top = stack[-1]
        if indent != top_indent:
            raise ValueError(f"line {lineno}: bad indentation: {raw!r}")
        if is_item:
            if not isinstance(top, list):
                raise ValueError(f"line {lineno}: unexpected list item: {raw!r}")
            top.append(_value(body[1:]))
            continue
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'key: value': {raw!r}")
        key = _scalar(key)
        if rest.strip():
            top[key] = _value(rest)
        else:
            pending = (indent, top, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        text = repr(v)
        # keep a dot in the mantissa so YAML 1.1 readers see a float too
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} in the config subset")


def dump_yaml(data: dict, indent: int = 0) -> str:
    """Write nested dicts of scalars and scalar lists in the subset that
    :func:`parse_yaml` reads (and that any YAML reader reads alike)."""
    out = []
    pad = " " * indent
    for k, v in data.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}:\n" + dump_yaml(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            items = ", ".join(_dump_scalar(x) for x in v)
            out.append(f"{pad}{k}: [{items}]\n")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a string override to the type of the existing value."""
    if not isinstance(value, str) or old is None:
        return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return value


def default_config() -> ConfigNode:
    """Defaults mirroring the reference key-for-key
    (``/root/reference/QFA/config.py:14-63``) plus this package's own
    ``MESH``/``RUNTIME`` keys."""
    return ConfigNode(
        {
            "BASE": [""],
            "TYPE": "train",
            "SEED": 0,
            "DATA": {
                "DATA_DIR": "",
                "VALIDATION_DIR": "",
                "OUTPUT_DIR": "output",
                "CATALOG": "",
                "VALIDATION_CATALOG": "",
                "DATA_NUM": 10000,
                "VALIDATION_NUM": 1000,
                "BATCH_SIZE": 500,
                "SNR_MIN": 2.0,
                "SNR_MAX": 100.0,
                "Z_MIN": 2.0,
                "Z_MAX": 3.5,
                "NUM_MASK": 0,
                "LAMMIN": 1030.0,
                "LAMMAX": 1600.0,
                "LOGLAM_DELTA": 1e-4,
                "NPROCS": 16,
                "VALIDATION": False,
                #: strict reference workflow parity: the reference loader
                #: CONCATENATES the "validation" spectra into the training
                #: arrays (/root/reference/QFA/dataloader.py:81-85) — they
                #: are trained on and shape the mu estimate, never
                #: evaluated. Default False keeps the held-out behavior
                #: (validation spectra only scored after each epoch).
                #: Requires DATA.VALIDATION (the reference gates the
                #: concat on it); the contradictory combination raises.
                "VALIDATION_CONCAT_COMPAT": False,
            },
            "MODEL": {
                "NH": 8,
                "TAU": "becker",
                "RESUME": "",
                "COMPAT_C0_BUG": False,
            },
            "TRAIN": {
                "NEPOCHS": 500,
                "LEARNING_RATE": 1e-3,
                "WEIGHT_DECAY": 1e-1,
                "DECAY_ALPHA": 0.9,
                "DECAY_STEP": 10,
                "WINDOW_LENGTH_FOR_MU": 16,
                "SMOOTH_INTERVAL": 5,
                "SAVE_INTERVAL": 5,
                "REFERENCE_NORM": True,
                #: resume from the newest full-state checkpoint (params +
                #: Adam moments + epoch) found in OUTPUT_DIR/checkpoints.
                "AUTO_RESUME": True,
                #: capacity mode: store the resident delta/error planes as
                #: bfloat16 (half the device-memory footprint; arithmetic
                #: stays f32).
                "BF16_PLANES": False,
            },
            # extensions beyond the reference's keys
            "MESH": {
                "DATA_AXIS": -1,  #: -1 = all local devices on the data axis
            },
            "RUNTIME": {
                "DEBUG_NANS": False,
                "PROFILE_DIR": "",
                #: predict mode: write one consolidated predictions.npz
                #: (stacked arrays + source paths) instead of the
                #: reference's one-file-per-spectrum layout — millions of
                #: files at survey scale.
                "CONSOLIDATED_PREDICT": False,
            },
        }
    )


def load_config(
    cfg_file: str | None = None, opts: list | None = None
) -> ConfigNode:
    """Build the frozen run config from defaults + yaml + overrides."""
    cfg = default_config()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg.freeze()


def get_config(args) -> ConfigNode:
    """argparse-namespace entry point mirroring the reference
    (``/root/reference/QFA/config.py:80-150``): yaml first, then ``--opts``,
    then individual CLI flags."""
    cfg = default_config()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        cfg.merge_from_list(list(args.opts))

    flag_map = {
        "type": ("TYPE",),
        "seed": ("SEED",),
        "n_epochs": ("TRAIN", "NEPOCHS"),
        "learning_rate": ("TRAIN", "LEARNING_RATE"),
        "weight_decay": ("TRAIN", "WEIGHT_DECAY"),
        "decay_alpha": ("TRAIN", "DECAY_ALPHA"),
        "decay_step": ("TRAIN", "DECAY_STEP"),
        "data_dir": ("DATA", "DATA_DIR"),
        "validation_dir": ("DATA", "VALIDATION_DIR"),
        "output_dir": ("DATA", "OUTPUT_DIR"),
        "catalog": ("DATA", "CATALOG"),
        "validation_catalog": ("DATA", "VALIDATION_CATALOG"),
        "data_num": ("DATA", "DATA_NUM"),
        "validation_num": ("DATA", "VALIDATION_NUM"),
        "batch_size": ("DATA", "BATCH_SIZE"),
        "snr_min": ("DATA", "SNR_MIN"),
        "snr_max": ("DATA", "SNR_MAX"),
        "z_min": ("DATA", "Z_MIN"),
        "z_max": ("DATA", "Z_MAX"),
        "num_mask": ("DATA", "NUM_MASK"),
        "nprocs": ("DATA", "NPROCS"),
        "validation": ("DATA", "VALIDATION"),
        "nh": ("MODEL", "NH"),
        "tau": ("MODEL", "TAU"),
        "resume": ("MODEL", "RESUME"),
    }
    for flag, path in flag_map.items():
        value = getattr(args, flag, None)
        # `is not None` (not truthiness): explicit falsy values like
        # --snr_min 0 or --z_min 0 must override the defaults too.
        if value is not None:
            node = cfg
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = value
    return cfg.freeze()
