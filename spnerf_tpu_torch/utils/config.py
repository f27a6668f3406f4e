"""Config loading and merging (``spnerf_tpu/utils/config.py``) with the
port's own YAML reader: the card's machine has no ``yaml`` package.

``loads`` reads the subset of YAML that the configs use and gives what
``yaml.safe_load`` gives for it:

- block mappings nested by indentation (spaces only);
- flow sequences and flow mappings, nested, spanning lines;
- comments, on a line of their own or after a value (``#`` after a
  space);
- plain, single- and double-quoted scalars, resolved as PyYAML resolves
  YAML 1.1: ``true``/``yes``/``on`` and their other cases are bools,
  ``null``/``~``/empty are None, ints (decimal, ``0x``, ``0b``, octal
  ``0..``, ``_`` separators, base 60), floats only with a dot (so
  ``1e-4`` stays a string) or ``.inf``/``.nan``.

Anything else (block sequences, anchors and aliases, tags, block
scalars, multi-line plain or quoted scalars, directives and document
markers, complex keys, timestamps) raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

# PyYAML's implicit resolvers for YAML 1.1 (yaml/resolver.py)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"
_NOT_PLAIN_START = "-?:,[]{}#&*!|>'\"%@`"


def _base60(text: str, number) -> float | int:
    value = 0
    for part in text.split(":"):
        value = value * 60 + number(part)
    return value


def _resolve(text: str, line: int):
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        sign = -1.0 if t.startswith("-") else 1.0
        t = t.lstrip("+-")
        if t == ".inf":
            return sign * math.inf
        if t == ".nan":
            return math.nan
        return sign * (_base60(t, float) if ":" in t else float(t))
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if ":" in t:
            return sign * _base60(t, int)
        if t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"line {line}: timestamps are outside the YAML "
                         f"subset read here: {text!r}")
    if text in ("<<", "="):
        raise ValueError(f"line {line}: {text!r} keys are outside the YAML "
                         "subset read here")
    return text


class _Parser:
    def __init__(self, text: str):
        self.lines = text.split("\n")
        self.row = 0  # current line (0-based)
        self.col = 0
        self.flow_start = 0  # line of the open flow collection

    # ------------------------------------------------------------ helpers

    def fail(self, msg: str):
        raise ValueError(f"line {self.row + 1}: {msg}")

    @property
    def line(self) -> str:
        return self.lines[self.row] if self.row < len(self.lines) else ""

    def at_comment(self, col: int) -> bool:
        """``#`` at ``col`` opens a comment (line start or after a space)."""
        s = self.line
        return s[col] == "#" and (col == 0 or s[col - 1] in " \t")

    def skip_spaces(self) -> None:
        s = self.line
        while self.col < len(s) and s[self.col] in " \t":
            self.col += 1

    def rest_is_empty(self, col: int) -> bool:
        s = self.line
        while col < len(s) and s[col] in " \t":
            col += 1
        return col >= len(s) or self.at_comment(col)

    def next_content_row(self, row: int) -> int:
        """The first row at or after ``row`` that holds more than spaces
        and a comment; ``len(lines)`` if none."""
        while row < len(self.lines):
            s = self.lines[row]
            stripped = s.strip(" \t")
            if stripped and not stripped.startswith("#"):
                if "\t" in s[:len(s) - len(s.lstrip(" \t"))]:
                    self.row = row
                    self.fail("tabs in indentation are outside the YAML "
                              "subset read here")
                return row
            row += 1
        return row

    def check_unsupported(self, s: str, col: int) -> None:
        c = s[col]
        if c in "&*":
            self.fail("anchors and aliases are outside the YAML subset read "
                      "here")
        if c == "!":
            self.fail("tags are outside the YAML subset read here")
        if c in "|>":
            self.fail("block scalars are outside the YAML subset read here")
        if c == "-" and (col + 1 == len(s) or s[col + 1] in " \t"):
            self.fail("block sequences are outside the YAML subset read here")
        if c == "?" and (col + 1 == len(s) or s[col + 1] in " \t"):
            self.fail("complex keys are outside the YAML subset read here")
        if c in "%@`":
            self.fail(f"{c!r} cannot start a plain scalar")

    # ------------------------------------------------------------ scalars

    def quoted(self) -> str:
        """The quoted scalar at the cursor; the cursor moves past it."""
        s, q = self.line, self.line[self.col]
        i, out = self.col + 1, []
        while True:
            if i >= len(s):
                self.fail("a quoted scalar must end on its line in the YAML "
                          "subset read here")
            c = s[i]
            if q == "'" and c == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            if q == '"' and c == '"':
                break
            if q == '"' and c == "\\":
                if i + 1 >= len(s):
                    self.fail("escaped line breaks are outside the YAML "
                              "subset read here")
                e = s[i + 1]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = s[i + 2:i + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                self.fail(f"unknown escape \\{e}")
            out.append(c)
            i += 1
        self.col = i + 1
        return "".join(out)

    def plain(self, flow: bool) -> str:
        """The plain scalar at the cursor, up to a comment, the line's end,
        ``: `` and, in flow context, a flow indicator; stripped."""
        s, i = self.line, self.col
        if s[i] in _NOT_PLAIN_START and not (
                s[i] in "-?:" and i + 1 < len(s) and s[i + 1] not in " \t"
                and not (flow and s[i + 1] in _FLOW_END)):
            self.check_unsupported(s, i)
            self.fail(f"unexpected {s[i]!r}")
        start = i
        while i < len(s):
            c = s[i]
            if c == "#" and i > start and s[i - 1] in " \t":
                break
            if c == ":" and (i + 1 == len(s) or s[i + 1] in " \t"
                             or (flow and s[i + 1] in _FLOW_END)):
                break
            if flow and c in _FLOW_END:
                break
            i += 1
        self.col = i
        return s[start:i].rstrip(" \t")

    def scalar(self, flow: bool):
        """The value of the quoted or plain scalar at the cursor."""
        if self.line[self.col] in "'\"":
            return self.quoted()
        return _resolve(self.plain(flow), self.row + 1)

    # --------------------------------------------------------------- flow

    def flow_skip(self) -> None:
        """Move past spaces, comments and line breaks inside a flow
        collection."""
        while True:
            self.skip_spaces()
            if self.col < len(self.line) and not self.at_comment(self.col):
                return
            self.row += 1
            self.col = 0
            if self.row >= len(self.lines):
                self.row = self.flow_start
                self.fail("unclosed flow collection")

    def flow_node(self):
        self.flow_skip()
        c = self.line[self.col]
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        return self.scalar(flow=True)

    def flow_seq(self) -> list:
        self.col += 1
        out = []
        while True:
            self.flow_skip()
            if self.line[self.col] == "]":
                self.col += 1
                return out
            item = self.flow_node()
            self.flow_skip()
            if self.line[self.col] == ":":
                self.fail("single-pair mappings in a flow sequence are "
                          "outside the YAML subset read here")
            out.append(item)
            self.flow_sep("]")

    def flow_map(self) -> dict:
        self.col += 1
        out = {}
        while True:
            self.flow_skip()
            if self.line[self.col] == "}":
                self.col += 1
                return out
            if self.line[self.col] in "[{":
                self.fail("collection keys are outside the YAML subset read "
                          "here")
            key = self.scalar(flow=True)
            self.flow_skip()
            value = None
            if self.line[self.col] == ":":
                self.col += 1
                self.flow_skip()
                if self.line[self.col] not in ",}":
                    value = self.flow_node()
            out[key] = value
            self.flow_sep("}")

    def flow_sep(self, close: str) -> None:
        self.flow_skip()
        c = self.line[self.col]
        if c == ",":
            self.col += 1
        elif c != close:
            self.fail(f"expected ',' or {close!r}, found {c!r}")

    # -------------------------------------------------------------- block

    def end_of_line(self) -> None:
        """Nothing but a comment may follow on the current line."""
        if not self.rest_is_empty(self.col):
            self.fail(f"unexpected text {self.line[self.col:].strip()!r}")
        self.row += 1
        self.col = 0

    def value(self, indent: int):
        """The value after ``key:`` (the cursor just past the colon): inline
        on this line, a block mapping on deeper lines, or None."""
        self.skip_spaces()
        if self.rest_is_empty(self.col):
            row = self.next_content_row(self.row + 1)
            if row < len(self.lines):
                deeper = len(self.lines[row]) - len(self.lines[row].lstrip(" "))
                if deeper > indent:
                    self.row, self.col = row, deeper
                    return self.block_map(deeper) if self.is_key() \
                        else self.inline()
            self.row += 1
            self.col = 0
            return None
        return self.inline()

    def inline(self):
        """A flow collection or scalar starting at the cursor and ending on
        this line or, for a flow collection, a later one."""
        s = self.line
        if s[self.col] in "[{":
            self.flow_start = self.row
            node = self.flow_node()
        else:
            node = self.scalar(flow=False)
            if self.col < len(s) and s[self.col] == ":":
                self.fail("mapping values are not allowed here")
        self.end_of_line()
        return node

    def block_map(self, indent: int) -> dict:
        out = {}
        while True:
            row = self.next_content_row(self.row)
            if row >= len(self.lines):
                self.row = row
                return out
            s = self.lines[row]
            here = len(s) - len(s.lstrip(" "))
            if here < indent:
                self.row = row
                return out
            self.row, self.col = row, here
            if here > indent:
                self.fail("unexpected indentation")
            if s[here] in "[{":
                self.fail("collection keys are outside the YAML subset read "
                          "here")
            key = self.scalar(flow=False)
            if self.col >= len(s) or s[self.col] != ":":
                self.fail("expected 'key: value' (multi-line plain scalars "
                          "are outside the YAML subset read here)")
            self.col += 1
            out[key] = self.value(indent)

    def document(self):
        for i, s in enumerate(self.lines):
            if s.startswith(("---", "...", "%")):
                self.row = i
                self.fail("directives and document markers are outside the "
                          "YAML subset read here")
        row = self.next_content_row(0)
        if row >= len(self.lines):
            return None
        s = self.lines[row]
        self.row, self.col = row, len(s) - len(s.lstrip(" "))
        if self.is_key():
            node = self.block_map(self.col)
        else:
            node = self.inline()
        if self.next_content_row(self.row) < len(self.lines):
            self.row = self.next_content_row(self.row)
            self.fail("unexpected content after the document's node")
        return node

    def is_key(self) -> bool:
        """Whether the line at the cursor starts with ``key:``."""
        s, col = self.line, self.col
        if s[col] in "[{":
            return False
        try:
            self.scalar(flow=False)
        except ValueError:
            self.col = col
            return False
        found = self.col < len(s) and s[self.col] == ":"
        self.col = col
        return found


def loads(text: str):
    """``yaml.safe_load(text)`` for the subset described above."""
    return _Parser(text.replace("\r\n", "\n")).document()


def dict_update(base: dict, updates: dict) -> dict:
    """Recursive nested-dict merge; ``updates`` wins. Returns a new dict."""
    out = dict(base)
    for k, v in (updates or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = dict_update(out[k], v)
        else:
            out[k] = v
    return out


def parse_primitives(names, all_primitives):
    """'all' or a validated list of primitive names."""
    if names == "all" or names is None:
        return list(all_primitives)
    if isinstance(names, str):
        names = [names]
    unknown = [n for n in names if n not in all_primitives]
    if unknown:
        raise ValueError(f"Unknown primitives: {unknown}")
    return list(names)


def load_config(path: str | Path) -> dict:
    """The config file at ``path``; a ``ValueError`` names the file and
    line of anything outside the subset."""
    try:
        return loads(Path(path).read_text())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def set_by_dotted_key(config: dict, dotted: str, value) -> dict:
    """Apply one ``a.b.c=value`` override onto a nested config (new dict).

    A string value is parsed by the same reader, so ``--set
    train.num_iters=500``, ``--set model.vgg_cn=[8,8,16,16]`` and ``--set
    pretrained=null`` all give typed values; a string that YAML 1.1
    leaves a string but ``float`` reads (``1e-4``) becomes a float.
    """
    keys = dotted.split(".")
    update = loads(value) if isinstance(value, str) else value
    if isinstance(update, str):
        try:
            update = float(update)
        except ValueError:
            pass
    for k in reversed(keys):
        update = {k: update}
    return dict_update(config, update)


def apply_overrides(config: dict, overrides) -> dict:
    """Apply a list of ``dotted.key=value`` strings onto a config."""
    for item in overrides or ():
        if "=" not in item:
            raise ValueError(
                f"--set expects dotted.key=value, got {item!r}"
            )
        dotted, value = item.split("=", 1)
        config = set_by_dotted_key(config, dotted.strip(), value)
    return config
