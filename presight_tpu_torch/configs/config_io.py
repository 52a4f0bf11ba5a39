"""config.yml and CLI overrides for the nested frozen config dataclasses
(presight_tpu/configs/config_io.py), without a YAML library.

``save_config`` writes exactly what ``yaml.safe_dump(to_dict(config),
sort_keys=False)`` writes for a config tree, and ``load_config`` reads that
subset of YAML back: block mappings and sequences, plain and single-quoted
strings, null, true and false, ints, floats (``1.0e-15``, ``.inf``), and
``[]`` and ``{}``. Anything else raises ValueError.

``__dataclass__`` tags name the JAX package's classes
(``presight_tpu.engine.trainer.TrainerConfig``, ...): the port writes those
names and maps them to its own mirrors when it reads, so either package
loads a run directory written by the other. They are strings only; nothing
of the JAX package is imported.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple, get_args, get_origin, get_type_hints

from .. import configs as C

_JAX_NAMES = {
    C.TrainerConfig: "presight_tpu.engine.trainer.TrainerConfig",
    C.PipelineConfig: "presight_tpu.engine.trainer.PipelineConfig",
    C.DataParserConfig: "presight_tpu.data.dataparser.DataParserConfig",
    C.DataManagerConfig: "presight_tpu.data.datamanager.DataManagerConfig",
    C.OptimizerGroupConfig: "presight_tpu.engine.optimizers.OptimizerGroupConfig",
    C.NerfactoNuscMSConfig: "presight_tpu.models.nerfacto_ms.NerfactoNuscMSConfig",
}
_CLASSES = {name: cls for cls, name in _JAX_NAMES.items()}


def to_dict(obj: Any) -> Any:
    """Nested dataclass -> plain python, tagged with the JAX class names."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj) not in _JAX_NAMES:
            raise TypeError(f"no config.yml name for {type(obj).__qualname__}")
        out = {"__dataclass__": _JAX_NAMES[type(obj)]}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    if isinstance(obj, (tuple, list)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def from_dict(data: Any) -> Any:
    """Inverse of to_dict; lists in dataclass fields come back as tuples."""
    if isinstance(data, dict):
        if "__path__" in data:
            return Path(data["__path__"])
        if "__dataclass__" in data:
            name = data["__dataclass__"]
            if name not in _CLASSES:
                raise ValueError(f"config.yml names an unknown config class {name!r}")
            kwargs = {k: from_dict(v) for k, v in data.items() if k != "__dataclass__"}
            for k, v in list(kwargs.items()):
                if isinstance(v, list):
                    kwargs[k] = tuple(v)
            return _CLASSES[name](**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    return data


# ---------------------------------------------------------------- YAML writer

# PyYAML's implicit resolvers (resolver.py): a plain scalar matching one of
# these is read back as something other than a string.
_IMPLICIT = re.compile(r"""^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
  | \.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
  | [-+]?\.(?:inf|Inf|INF) | \.(?:nan|NaN|NAN)
  | [-+]?0b[0-1_]+ | [-+]?0[0-7_]+ | [-+]?(?:0|[1-9][0-9_]*) | [-+]?0x[0-9a-fA-F_]+
  | [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
  | << | ~ | null|Null|NULL | = | [0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
  | [0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[\ \t]+)[0-9][0-9]?
    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?
)$""", re.X)


def _plain_allowed(s: str) -> bool:
    """PyYAML's analyze_scalar verdict for a printable ASCII string in block
    context: may it be written unquoted?"""
    if not s or s[0] in " #,[]{}&*!|>'\"%@`" or s[-1] == " ":
        return False
    if s[0] in "?:-" and (len(s) == 1 or s[1] == " "):
        return False
    if ": " in s or " #" in s or s.endswith(":"):
        return False
    return not s.startswith("---") and not s.startswith("...")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        if any(not (" " <= ch <= "~") for ch in v):
            raise ValueError(f"config.yml holds printable ASCII strings only, got {v!r}")
        if _plain_allowed(v) and not _IMPLICIT.match(v):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to config.yml")


def _emit(node: Any, indent: int, out: List[str]) -> None:
    """A block mapping or sequence at ``indent``; sequences under a mapping
    key sit at the key's own indent, as PyYAML writes them."""
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            key = _scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            elif isinstance(v, list) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent, out)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                sub: List[str] = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(v)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dumps(data: Dict) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` of a to_dict tree."""
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------- YAML reader

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")


def _parse_scalar(text: str, where: str) -> Any:
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'") or "'" in text[1:-1].replace("''", ""):
            raise ValueError(f"{where}: bad single-quoted string {text!r}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"') or text.startswith(("&", "*", "!", "|", ">", "[", "{")):
        if text == "[]":
            return []
        if text == "{}":
            return {}
        raise ValueError(f"{where}: unsupported YAML {text!r}")
    if text in ("null", "Null", "NULL", "~", ""):
        return None
    if text in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"):
        return True
    if text in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    low = text.lower()
    if low in (".inf", "+.inf", "-.inf"):
        return -math.inf if low.startswith("-") else math.inf
    if low == ".nan":
        return math.nan
    if _IMPLICIT.match(text):
        raise ValueError(f"{where}: unsupported YAML scalar {text!r}")
    return text


def _split_key(text: str) -> Tuple[str, str]:
    """'key: value' or 'key:' -> (key, value text); else ('', '')."""
    if text.startswith(("'", '"')):
        return "", ""
    m = re.match(r"^([^\s:#][^:]*?):(?:\s+(.*))?$", text)
    if m is None:
        return "", ""
    return m.group(1), (m.group(2) or "")


def loads(text: str) -> Any:
    """Read the YAML subset ``dumps`` writes."""
    lines: List[Tuple[int, str, int]] = []
    for no, raw in enumerate(text.splitlines(), 1):
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"config.yml line {no}: tab indentation")
        lines.append((len(raw) - len(raw.lstrip(" ")), raw.strip(), no))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"config.yml line {lines[i][2]}: unexpected indentation")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _parse_block(lines, i: int, indent: int):
    if _is_item(lines[i][1]):
        return _parse_sequence(lines, i, indent)
    if not _split_key(lines[i][1])[0]:
        value = _parse_scalar(lines[i][1], f"config.yml line {lines[i][2]}")
        return value, i + 1
    return _parse_mapping(lines, i, indent)


def _parse_mapping(lines, i: int, indent: int):
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        ind, text, no = lines[i]
        key, rest = _split_key(text)
        if not key:
            raise ValueError(f"config.yml line {no}: expected 'key: value', got {text!r}")
        key = _parse_scalar(key, f"config.yml line {no}")
        i += 1
        if rest:
            out[key] = _parse_scalar(rest, f"config.yml line {no}")
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _parse_block(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            out[key], i = _parse_sequence(lines, i, indent)
        else:
            out[key] = None
    return out, i


def _parse_sequence(lines, i: int, indent: int):
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        _, text, no = lines[i]
        rest = text[1:].lstrip(" ")
        if not rest:
            i += 1
            if i < len(lines) and lines[i][0] > indent:
                value, i = _parse_block(lines, i, lines[i][0])
            else:
                value = None
            out.append(value)
            continue
        # The item's node starts on this line at the column after '- '.
        col = indent + (len(text) - len(rest))
        sub = [(col, rest, no)] + lines[i + 1:]
        value, j = _parse_block(sub, 0, col)
        out.append(value)
        i += j
    return out, i


# ---------------------------------------------------------------- files

def save_config(config: Any, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dumps(to_dict(config)))


def load_config(path: Path) -> Any:
    return from_dict(loads(Path(path).read_text()))


# ---------------------------------------------------------------- CLI overrides

def _coerce(value: str, typ) -> Any:
    origin = get_origin(typ)
    if typ in (int,) or typ == "int":
        return int(value)
    if typ in (float,) or typ == "float":
        return float(value)
    if typ in (bool,) or typ == "bool":
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (Path,) or typ == "Path" or typ == "pathlib.Path":
        return Path(value)
    if origin in (tuple, list):
        args = get_args(typ)
        elem = args[0] if args else str
        parts = [p for p in value.replace(",", " ").split() if p]
        return tuple(_coerce(p, elem) for p in parts)
    if origin is not None:  # Optional[...] etc.
        args = [a for a in get_args(typ) if a is not type(None)]
        if args:
            return _coerce(value, args[0])
    return value


def apply_overrides(config: Any, overrides: Dict[str, str]) -> Any:
    """Apply {'pipeline.model.num_levels': '8'} style overrides to a nested
    frozen dataclass (dotted paths; '-' and '_' both accepted)."""
    for dotted, raw in overrides.items():
        parts = dotted.replace("-", "_").split(".")
        config = _apply_one(config, parts, raw)
    return config


def _apply_one(obj: Any, parts, raw: str) -> Any:
    name = parts[0]
    if dataclasses.is_dataclass(obj):
        field_map = {f.name: f for f in dataclasses.fields(obj)}
        if name not in field_map:
            raise KeyError(f"unknown config field: {name} on {type(obj).__name__}")
        current = getattr(obj, name)
        if len(parts) == 1:
            try:
                typ = get_type_hints(type(obj)).get(name, str)
            except (NameError, TypeError):
                typ = type(current) if current is not None else str
            new = _coerce(raw, typ)
        else:
            new = _apply_one(current, parts[1:], raw)
        return dataclasses.replace(obj, **{name: new})
    if isinstance(obj, dict):
        key = name
        if key not in obj and name.isdigit():
            key = int(name)
        new_inner = _apply_one(obj[key], parts[1:], raw) if len(parts) > 1 else raw
        out = dict(obj)
        out[key] = new_inner
        return out
    raise TypeError(f"cannot override into {type(obj)}")


def parse_cli_overrides(argv) -> Dict[str, str]:
    """['--a.b', '1', '--c', '2'] -> {'a.b': '1', 'c': '2'}"""
    out: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --key, got {tok}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            out[key] = val
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {tok}")
            out[key] = argv[i + 1]
            i += 2
    return out
