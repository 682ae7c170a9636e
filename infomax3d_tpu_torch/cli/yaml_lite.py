"""A reader and a writer for the subset of YAML the configs use.

The port runs where PyYAML is not installed, so it reads `configs/*.yml`
and writes `train_arguments.yaml` itself.  The subset:

* block mappings and block sequences (a sequence may sit at its key's
  indent, an item may be a mapping: ``- key: value``), flow sequences
  (``[mean, max]``, nested) and flow mappings (``{num: 512}``);
* plain, single-quoted and double-quoted scalars, and comments.

Plain scalars resolve as PyYAML's YAML 1.1 `safe_load` resolves them (its
implicit resolvers, copied below): ``yes`` / ``off`` are booleans,
``8.0e-5`` is a float but ``1e-3`` (no dot) and ``1.0e5`` (no exponent
sign) are strings, ``0o17`` is a string and ``017`` octal.  Anchors, tags,
block scalars (``|``, ``>``), multi-line plain scalars, timestamps and
multiple documents are outside the subset and raise `ValueError`.

`dump` writes block style that both `load` and PyYAML read back to the
same object: dicts, lists, strings, ints, floats, booleans and None.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _int(v: str) -> int:
    """PyYAML's `construct_yaml_int`."""
    v = v.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * int(_sexagesimal(v))
    return sign * int(v)


def _float(v: str) -> float:
    """PyYAML's `construct_yaml_float`."""
    v = v.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v)
    return sign * float(v)


def resolve(plain: str) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    if _NULL.match(plain):
        return None
    if _BOOL.match(plain):
        return plain in _TRUE
    if _INT.match(plain):
        return _int(plain)
    if _FLOAT.match(plain):
        return _float(plain)
    if _TIMESTAMP.match(plain) or plain in ("<<", "="):
        raise ValueError(f"YAML scalar {plain!r} is outside the subset")
    return plain


def _strip_comment(line: str) -> str:
    """`line` without its comment: a '#' at the start or after whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Parser of one inline value: a quoted or plain scalar, or a flow
    collection."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, flow: bool) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            return self._quoted()
        if ch in "&*!|>%@`":
            raise ValueError(f"YAML construct {ch!r} is outside the subset: "
                             f"{self.s!r}")
        stop = ",[]{}" if flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop:
            if flow and self.s[j] == ":" and (
                    j + 1 == len(self.s) or self.s[j + 1] in " ,]}"):
                break
            j += 1
        plain, self.i = self.s[self.i:j].strip(), j
        return resolve(plain)

    def _quoted(self) -> str:
        q, out = self.s[self.i], []
        self.i += 1
        while True:
            if self.i >= len(self.s):
                raise ValueError(f"unterminated quoted scalar: {self.s!r}")
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                simple = {"n": "\n", "t": "\t", "\\": "\\", '"': '"',
                          "/": "/", "0": "\0", " ": " ", "r": "\r"}
                if esc in simple:
                    out.append(simple[esc])
                    self.i += 2
                    continue
                if esc in ("x", "u", "U"):
                    width = {"x": 2, "u": 4, "U": 8}[esc]
                    out.append(chr(int(self.s[self.i + 2:
                                              self.i + 2 + width], 16)))
                    self.i += 2 + width
                    continue
                raise ValueError(f"escape \\{esc} is outside the subset")
            out.append(ch)
            self.i += 1

    def _seq(self) -> list:
        self.i += 1
        out: List[Any] = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(flow=True))
            self._ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise ValueError(f"bad flow sequence: {self.s!r}")

    def _map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(flow=True)
            self._ws()
            val = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                val = self.value(flow=True)
            out[key] = val
            self._ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise ValueError(f"bad flow mapping: {self.s!r}")

    def done(self) -> bool:
        self._ws()
        return self.i >= len(self.s)


def _inline(text: str) -> Any:
    p = _Flow(text)
    v = p.value(flow=False)
    if not p.done():
        raise ValueError(f"trailing text after YAML value: {text!r}")
    return v


def _split_key(text: str):
    """(key text, rest) when `text` is ``key: value`` / ``key:``, else
    None.  The key may be quoted."""
    if text[:1] in "'\"":
        p = _Flow(text)
        key = p._quoted()
        rest = text[p.i:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    m = re.match(r"^([^#]*?):(?:[ \t]+(.*))?$", text)
    if not m:
        return None
    return resolve(m.group(1).strip()), (m.group(2) or "").strip()


class _Block:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tab indentation is outside the subset")
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            if body.strip() in ("---", "...") and not body.startswith(" "):
                raise ValueError("YAML document markers are outside the "
                                 "subset")
            self.lines.append((len(body) - len(body.lstrip(" ")),
                               body.strip()))
        self.k = 0

    def _peek(self):
        return self.lines[self.k] if self.k < len(self.lines) else None

    def node(self, indent: int) -> Any:
        """The block node whose lines start at `indent`."""
        ind, text = self._peek()
        if text == "-" or text.startswith("- "):
            return self._seq(ind)
        if _split_key(text) is not None:
            return self._map(ind)
        self.k += 1
        nxt = self._peek()
        if nxt is not None and nxt[0] > ind:
            raise ValueError("multi-line plain scalars are outside the "
                             f"subset: {text!r}")
        return _inline(text)

    def _value_after(self, rest: str, indent: int, seq_ok: bool) -> Any:
        """The value of a ``key:`` / ``-`` whose inline part is `rest`."""
        if rest:
            nxt = self._peek()
            if nxt is not None and nxt[0] > indent:
                raise ValueError("multi-line plain scalars are outside the "
                                 f"subset: {rest!r}")
            return _inline(rest)
        nxt = self._peek()
        if nxt is None:
            return None
        if nxt[0] > indent:
            return self.node(nxt[0])
        if seq_ok and nxt[0] == indent and (nxt[1] == "-" or
                                            nxt[1].startswith("- ")):
            return self._seq(indent)
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while True:
            cur = self._peek()
            if cur is None or cur[0] < indent:
                return out
            if cur[0] > indent:
                raise ValueError(f"bad indentation at {cur[1]!r}")
            kv = _split_key(cur[1])
            if kv is None:
                return out if cur[1].startswith("-") else self._bad(cur)
            self.k += 1
            key, rest = kv
            out[key] = self._value_after(rest, indent, seq_ok=True)

    def _seq(self, indent: int) -> list:
        out = []
        while True:
            cur = self._peek()
            if cur is None or cur[0] < indent:
                return out
            if cur[0] > indent or not (cur[1] == "-" or
                                       cur[1].startswith("- ")):
                if cur[0] == indent:
                    return out
                raise ValueError(f"bad indentation at {cur[1]!r}")
            rest = cur[1][1:].strip()
            if rest and (rest == "-" or rest.startswith("- ")
                         or _split_key(rest) is not None):
                # an item that is itself a block node, on the dash's line:
                # re-read it as lines at the column after "- "
                col = cur[0] + len(cur[1]) - len(rest)
                self.lines[self.k] = (col, rest)
                out.append(self.node(col))
                continue
            self.k += 1
            out.append(self._value_after(rest, indent, seq_ok=False))

    @staticmethod
    def _bad(cur):
        raise ValueError(f"unexpected YAML line {cur[1]!r}")


def load(text: str) -> Any:
    """The object `yaml.safe_load(text)` gives, for the subset."""
    b = _Block(text)
    if not b.lines:
        return None
    out = b.node(b.lines[0][0])
    if b._peek() is not None:
        raise ValueError(f"unexpected YAML line {b._peek()[1]!r}")
    return out


def safe_load(stream) -> Any:
    """`load` of a string or of a file object's text."""
    return load(stream if isinstance(stream, str) else stream.read())


# --------------------------------------------------------------- writer

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./()+-][A-Za-z0-9_ ./()+=-]*$")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:          # PyYAML's represent_float
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        plain_ok = (_PLAIN_SAFE.match(v) is not None and v == v.strip()
                    and not v.startswith("- ") and v != "-")
        if plain_ok:
            try:
                plain_ok = resolve(v) == v
            except ValueError:
                plain_ok = False
        if plain_ok:
            return v
        if all(c.isprintable() for c in v):
            return "'" + v.replace("'", "''") + "'"
        return '"' + "".join(
            c if c.isprintable() and c not in '"\\' else
            {"\n": "\\n", "\t": "\\t", "\\": "\\\\", '"': '\\"'}.get(
                c, f"\\x{ord(c):02x}" if ord(c) < 256 else f"\\u{ord(c):04x}")
            for c in v) + '"'
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _lines(obj: Any, indent: int) -> List[str]:
    pad = " " * indent
    out: List[str] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _scalar(k)
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{key}:")
                out += _lines(v, indent + 2)
            else:
                out.append(f"{pad}{key}: {_empty_or_scalar(v)}")
    else:
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                out += _lines(v, indent + 2)
            else:
                out.append(f"{pad}- {_empty_or_scalar(v)}")
    return out


def _empty_or_scalar(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump(obj: Any, stream=None) -> str:
    """Block-style YAML text of `obj` (dicts, lists, str, int, float,
    bool, None); written to `stream` too when given."""
    if isinstance(obj, (dict, list)) and obj:
        text = "\n".join(_lines(obj, 0)) + "\n"
    else:
        text = _empty_or_scalar(obj) + "\n"
    if stream is not None:
        stream.write(text)
    return text
