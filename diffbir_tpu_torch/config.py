"""Config system: YAML files and ``target:``/``params:`` instantiation.

Counterpart of ``diffbir_tpu/config.py`` (``register``, ``resolve``,
``instantiate``, ``load_yaml``) with two differences:

- ``load_yaml`` is a reader of its own, since PyYAML is not installed beside
  the port on the GPU machine. It reads the YAML the repository's train
  configs use: block mappings and block sequences by indentation, flow
  sequences and mappings (``[a, b]``, ``{}``, ``{k: v}``) on one line,
  single- and double-quoted and plain scalars, and ``#`` comments. Plain
  scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1): ``null``
  and ``~``; ``true``/``false``/``yes``/``no``/``on``/``off`` in their three
  cases; ints (decimal, ``0b``, ``0x``, a leading 0 octal, ``_``
  separators, base 60 with ``:``); floats only with a dot, ``.inf`` or
  ``.nan``, an exponent only with its sign (``1e-4`` stays a string,
  ``1.0e-4`` is a float). Anything else (anchors, aliases, tags, block
  scalars, documents, dates, multi-line flow) raises ValueError naming the
  line.
- ``resolve`` maps a ``diffbir_tpu.*`` target (the train configs name the
  JAX package's classes) to its counterpart under ``diffbir_tpu_torch.*``
  and imports that; it never imports the JAX package. Registered short
  names stay short names; any other root is refused.
"""

from __future__ import annotations

import importlib
import math
import re
from typing import Any, Callable, Dict, List, Tuple

_REGISTRY: Dict[str, Any] = {}
JAX_ROOT, ROOT = "diffbir_tpu", "diffbir_tpu_torch"


def register(name: str) -> Callable[[Any], Any]:
    """Class/function decorator adding ``name`` to the config registry."""

    def deco(obj: Any) -> Any:
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise ValueError(f"duplicate registry name: {name}")
        _REGISTRY[name] = obj
        return obj

    return deco


def resolve(target: str) -> Any:
    """A registered short name, or a dotted path under ``diffbir_tpu_torch``
    or ``diffbir_tpu`` (read as its counterpart in this package) -> the
    object."""
    if target in _REGISTRY:
        return _REGISTRY[target]
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise KeyError(f"unknown registry name: {target!r}")
    root, _, rest = module_name.partition(".")
    if root not in (JAX_ROOT, ROOT):
        raise ValueError(f"config target {target!r} must be a registered name or live under "
                         f"{ROOT}.* (or {JAX_ROOT}.*, read as its counterpart there)")
    module_name = ".".join(p for p in (ROOT, rest) if p)
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name and (module_name == e.name or module_name.startswith(e.name + ".")):
            raise NotImplementedError(f"config target {target!r}: {module_name} is not "
                                      "ported") from e
        raise
    return getattr(module, attr)


def instantiate(cfg: Dict[str, Any], **extra: Any) -> Any:
    """Instantiate ``{"target": ..., "params": {...}}``; extra kwargs override."""
    if "target" not in cfg:
        raise KeyError(f"config has no 'target' key: {list(cfg)}")
    cls = resolve(cfg["target"])
    params = dict(cfg.get("params") or {})
    params.update(extra)
    return cls(**params)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        cfg = parse_yaml(f.read(), path)
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: expected a YAML mapping, got {type(cfg).__name__}")
    return cfg


# --------------------------------------------------------------------------- #
# the YAML reader
# --------------------------------------------------------------------------- #
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {v: b for b, vs in ((True, "yes true on"), (False, "no false off"))
         for w in vs.split() for v in (w, w.capitalize(), w.upper())}
_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
                      |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                        |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""", re.X)
_DATE = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt ].*)?")
_INDICATORS = "&*!|>%@`"
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}


class _Line:
    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _error(where: str, no: int, msg: str) -> ValueError:
    return ValueError(f"{where}:{no}: {msg}")


def _base60(digits: str, parse) -> Any:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + parse(part)
    return value


def _resolve_scalar(text: str, where: str = "<yaml>", no: int = 0) -> Any:
    """A plain scalar's value by the YAML 1.1 rules of ``yaml.safe_load``."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_base60(v, int) if ":" in v else int(v))
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_base60(v, float) if ":" in v else float(v))
    if text in ("<<", "="):
        raise _error(where, no, f"the {text!r} key is not read")
    if _DATE.fullmatch(text):
        raise _error(where, no, f"a timestamp ({text!r}) is not read")
    if text[0] in _INDICATORS or text in ("-", "?") or text.startswith(
            ("- ", "? ", "---", "...")):
        raise _error(where, no, f"{text!r}: anchors, aliases, tags, block scalars, "
                                "directives and documents are not read")
    return text


def _quoted(s: str, pos: int, where: str, no: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[pos] -> (its text, the position after it)."""
    q, out, i = s[pos], [], pos + 1
    while i < len(s):
        c = s[i]
        if c == q:
            if q == "'" and s[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = s[i + 1: i + 2]
            if esc not in _ESCAPES:
                raise _error(where, no, f"escape \\{esc} is not read")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise _error(where, no, "unterminated quoted scalar (multi-line scalars are not read)")


def _strip_comment(s: str) -> str:
    """The line without its ``#`` comment (quotes respected)."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:-"):
            j = s.find(c, i + 1)
            while c == "'" and j != -1 and s[j + 1: j + 2] == "'":
                j = s.find(c, j + 2)
            i = len(s) if j == -1 else j + 1
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


class _Flow:
    """One line's flow collection or scalar: ``[a, b]``, ``{k: v}``, 'x'."""

    def __init__(self, s: str, where: str, no: int):
        self.s, self.where, self.no, self.i = s, where, no, 0

    def _skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _peek(self) -> str:
        self._skip()
        return self.s[self.i: self.i + 1]

    def _expect(self, c: str) -> None:
        if self._peek() != c:
            raise _error(self.where, self.no, f"expected {c!r} at column {self.i + 1}")
        self.i += 1

    def value(self, stops: str) -> Any:
        c = self._peek()
        if c == "[":
            self.i += 1
            items: List[Any] = []
            while self._peek() != "]":
                items.append(self.value(",]"))
                if self._peek() == ",":
                    self.i += 1
                elif self._peek() != "]":
                    raise _error(self.where, self.no, "unterminated flow sequence")
            self.i += 1
            return items
        if c == "{":
            self.i += 1
            mapping: Dict[Any, Any] = {}
            while self._peek() != "}":
                key = self.value(":,}")
                self._expect(":")
                mapping[key] = self.value(",}")
                if self._peek() == ",":
                    self.i += 1
                elif self._peek() != "}":
                    raise _error(self.where, self.no, "unterminated flow mapping")
            self.i += 1
            return mapping
        if c in ("'", '"'):
            text, self.i = _quoted(self.s, self.i, self.where, self.no)
            return text
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            c, after = self.s[self.i], self.s[self.i + 1: self.i + 2]
            if c in "[]{}" and stops:
                raise _error(self.where, self.no, f"unexpected {c!r}")
            if c == ":" and after in ("", " ", "\t"):
                raise _error(self.where, self.no, "a mapping value is not allowed here")
            self.i += 1
        text = self.s[start: self.i].strip()
        if not text and stops:
            raise _error(self.where, self.no, "empty entry in a flow collection")
        return _resolve_scalar(text, self.where, self.no)

    def whole(self) -> Any:
        v = self.value("")
        if self._peek():
            raise _error(self.where, self.no, f"unexpected text after the value: "
                                              f"{self.s[self.i:]!r}")
        return v


def _split_key(text: str, where: str, no: int):
    """'key: value' -> (key, value text) or None when the line is no entry."""
    i = 0
    if text[:1] in ("'", '"'):
        key, i = _quoted(text, 0, where, no)
        rest = text[i:].lstrip()
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    if text[:1] in "[{":
        return None
    while i < len(text):
        if text[i] == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return _resolve_scalar(text[:i].rstrip(), where, no), text[i + 1:].strip()
        i += 1
    return None


class _Reader:
    def __init__(self, source: str, where: str):
        self.where = where
        self.lines: List[_Line] = []
        for no, raw in enumerate(source.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise _error(where, no, "tabs do not indent YAML")
            text = _strip_comment(body)
            if text:
                self.lines.append(_Line(no, len(raw) - len(body), text))

    def _inline(self, line: _Line, text: str) -> Any:
        if text[0] in "[{":
            depth = sum(text.count(c) for c in "[{") - sum(text.count(c) for c in "]}")
            if depth > 0:
                raise _error(self.where, line.no, "a flow collection over several lines is "
                                                  "not read")
        return _Flow(text, self.where, line.no).whole()

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if line.text == "-" or line.text.startswith("- "):
            return self._sequence(i, indent)
        if _split_key(line.text, self.where, line.no) is None:
            value = self._inline(line, line.text)
            if i + 1 < len(self.lines) and self.lines[i + 1].indent >= indent:
                raise _error(self.where, self.lines[i + 1].no, "text after a scalar")
            return value, i + 1
        return self._mapping(i, indent)

    def _nested(self, i: int, indent: int, seq_same_indent: bool) -> Tuple[Any, int]:
        """The value of an entry with nothing after its indicator: the block
        indented below it (or a sequence at its own indent), else null."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent:
                return self.block(i, nxt.indent)
            if seq_same_indent and nxt.indent == indent and (
                    nxt.text == "-" or nxt.text.startswith("- ")):
                return self._sequence(i, indent)
        return None, i

    def _mapping(self, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            entry = _split_key(line.text, self.where, line.no)
            if entry is None:
                raise _error(self.where, line.no, f"expected 'key: value', got {line.text!r}")
            key, rest = entry
            if rest:
                out[key], i = self._inline(line, rest), i + 1
            else:
                out[key], i = self._nested(i + 1, indent, True)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise _error(self.where, self.lines[i].no, "unexpected indentation")
        return out, i

    def _sequence(self, i: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while i < len(self.lines) and self.lines[i].indent == indent and (
                self.lines[i].text == "-" or self.lines[i].text.startswith("- ")):
            line = self.lines[i]
            item = line.text[1:].lstrip(" ")
            if not item:
                value, i = self._nested(i + 1, indent, False)
            else:
                # the item's text as a line of its own, at its column
                col = indent + len(line.text) - len(item)
                self.lines[i] = _Line(line.no, col, item)
                value, i = self.block(i, col)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise _error(self.where, self.lines[i].no, "unexpected indentation")
        return out, i


def parse_yaml(source: str, where: str = "<yaml>") -> Any:
    """One YAML document's value (None when empty); see the module's notes
    for what is read."""
    reader = _Reader(source, where)
    if not reader.lines:
        return None
    first = reader.lines[0]
    if first.text.startswith(("---", "...", "%")):
        raise _error(where, first.no, "directives and document markers are not read")
    value, i = reader.block(0, first.indent)
    if i < len(reader.lines):
        raise _error(where, reader.lines[i].no, "text after the document's top value")
    return value
