"""Reader for the subset of YAML that scene files use.

Supported: block mappings, block sequences (of scalars, mappings or
sequences), flow lists and flow mappings (nestable, and free to continue
on following lines), plain / single- /
double-quoted scalars, and `#` comments. Plain scalars resolve like
PyYAML's `safe_load` (YAML 1.1): null, booleans, decimal ints and floats
(including .inf / .nan); anything else stays a string.

Unsupported YAML (block scalars `|` / `>`, anchors, aliases, tags,
multi-line plain scalars, several documents) and malformed input raise
`YamlError` with the offending line number.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


class YamlError(ValueError):
    """Malformed or unsupported YAML."""


def resolve_scalar(text: str) -> Any:
    """A plain (unquoted) scalar's value, as PyYAML's safe_load gives it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(raw: str, no: int) -> str:
    """Drop a `#` comment (one that starts the line or follows a space)
    outside quotes."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote == "'":
            if c == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    if quote is not None:
        raise YamlError(f"line {no}: unterminated quoted string")
    return raw


def _flow_depth(text: str) -> int:
    """Open [ / { brackets left at the end of text (outside quotes)."""
    depth = 0
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote and not (quote == '"' and text[i - 1] == "\\"):
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> List[_Line]:
    out = []
    raw_lines = text.splitlines()
    it = iter(enumerate(raw_lines, start=1))
    for no, raw in it:
        body = _strip_comment(raw, no).rstrip()
        # a flow collection may continue on the following lines
        while _flow_depth(body) > 0:
            nxt = next(it, None)
            if nxt is None:
                raise YamlError(f"line {no}: unclosed flow collection")
            body += " " + _strip_comment(nxt[1], nxt[0]).strip()
        stripped = body.lstrip(" ")
        if not stripped:
            continue
        if stripped[0] == "\t" or "\t" in body[:len(body) - len(stripped)]:
            raise YamlError(f"line {no}: tab in indentation")
        if no == 1 and stripped == "---":
            continue
        if stripped in ("---", "...") or stripped.startswith("--- "):
            raise YamlError(f"line {no}: several documents are unsupported")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _split_key(text: str, no: int):
    """'key: rest' -> (key, rest) for a mapping entry, or None."""
    depth = 0
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and i == 0:
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif (c == ":" and depth == 0
              and (i + 1 == len(text) or text[i + 1] == " ")):
            key = text[:i].rstrip()
            if not key:
                raise YamlError(f"line {no}: empty mapping key")
            return _scalar(key, no), text[i + 1:].strip()
        i += 1
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Flow:
    """Parser for one flow value: a scalar, [list] or {mapping}."""

    def __init__(self, text: str, no: int):
        self.s, self.i, self.no = text, 0, no

    def error(self, what: str):
        raise YamlError(f"line {self.no}: {what} in {self.s!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.skip()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        if c in ("&", "*", "!", "|", ">", "%", "@", "`"):
            self.error(f"unsupported YAML syntax {c!r}")
        stop = ",]}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop:
            if in_flow and self.s[j] == ":" and self.s[j + 1:j + 2] in (
                    " ", ",", "]", "}", ""):
                break
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        if in_flow and not text:
            self.error("empty flow entry")
        if re.search(r":( |$)", text):
            self.error("mapping value not allowed here")
        return resolve_scalar(text)

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                         "/": "/", "0": "\0", " ": " "}
                if esc not in table:
                    self.error(f"unsupported escape \\{esc}")
                out.append(table[esc])
                self.i += 2
                continue
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1
        self.error("unterminated quoted string")

    def seq(self) -> list:
        self.i += 1
        out = []
        self.skip()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(True))
            self.skip()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        self.skip()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value(True)
            self.skip()
            if self.s[self.i:self.i + 1] != ":":
                self.error("expected ':' in flow mapping")
            self.i += 1
            out[key] = self.value(True)
            self.skip()
            c = self.s[self.i:self.i + 1]
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                self.error("expected ',' or '}'")

    def whole(self) -> Any:
        v = self.value(False)
        self.skip()
        if self.i != len(self.s):
            self.error("trailing characters")
        return v


def _scalar(text: str, no: int) -> Any:
    return _Flow(text, no).whole()


class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines = lines

    def node(self, i: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if _is_item(line.text):
            return self.seq(i, line.indent)
        if _split_key(line.text, line.no) is not None:
            return self.mapping(i, line.indent)
        value = _scalar(line.text, line.no)
        i += 1
        if i < len(self.lines) and self.lines[i].indent >= line.indent:
            raise YamlError(f"line {self.lines[i].no}: multi-line plain "
                            "scalars are unsupported")
        return value, i

    def child(self, i: int, parent_indent: int, same_level_seq: bool):
        """The block value below a 'key:' / '-' line at index i - 1."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > parent_indent:
                return self.node(i)
            if (same_level_seq and nxt.indent == parent_indent
                    and _is_item(nxt.text)):
                return self.seq(i, parent_indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            kv = _split_key(line.text, line.no)
            if kv is None:
                raise YamlError(f"line {line.no}: expected 'key: value', "
                                f"got {line.text!r}")
            key, rest = kv
            if rest:
                out[key] = _scalar(rest, line.no)
                i += 1
            else:
                out[key], i = self.child(i + 1, indent, True)
        self.check_dedent(i, indent)
        return out, i

    def seq(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and _is_item(self.lines[i].text)):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                value, i = self.child(i + 1, indent, False)
            elif _is_item(rest) or _split_key(rest, line.no) is not None:
                # "- key: v" / "- - v": the item's block starts at the
                # column of `rest`, continued by lines indented to match
                self.lines[i] = _Line(line.no,
                                      indent + len(line.text) - len(rest),
                                      rest)
                value, i = self.node(i)
            else:
                value = _scalar(rest, line.no)
                i += 1
            out.append(value)
        self.check_dedent(i, indent)
        return out, i

    def check_dedent(self, i: int, indent: int):
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YamlError(f"line {self.lines[i].no}: unexpected "
                            "indentation")


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0].indent != 0:
        raise YamlError(f"line {lines[0].no}: document must start at "
                        "column 0")
    value, i = _Block(lines).node(0)
    if i != len(lines):
        raise YamlError(f"line {lines[i].no}: unexpected content "
                        f"{lines[i].text!r}")
    return value
