"""A reader for the YAML subset that ``Options/*.yml`` use (the card's
machine has no PyYAML).

``load(text)`` gives what ``yaml.safe_load`` gives for: block mappings
nested by indentation; flow lists and maps, also across lines; plain,
single- and double-quoted scalars; ``# comments``; ``&anchor`` /
``*alias`` (an alias is the anchored object itself, as PyYAML shares it);
the tags ``!!float`` / ``!!int`` / ``!!str`` / ``!!bool`` / ``!!null``.
Plain scalars resolve by PyYAML's YAML 1.1 rules, so a bare ``1e-4`` is
the string '1e-4' and ``!!float 1e-4`` the float. Block sequences, block
scalars (``|``, ``>``), multi-line plain scalars, merge keys, timestamps
and other tags raise a ``ValueError`` naming the line.
"""

from __future__ import annotations

import re

# PyYAML's implicit resolvers (yaml/resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _to_bool(value: str) -> bool:
    return value.lower() in ("yes", "true", "on")


def _resolve(text: str, where: str):
    """A plain scalar's value by PyYAML's implicit resolvers."""
    if _BOOL.match(text):
        return _to_bool(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"{where}: timestamps are not supported ({text!r})")
    return text


_TAGS = {"!!float": _to_float, "!!int": _to_int, "!!str": str, "!!bool": _to_bool,
         "!!null": lambda s: None}


def _strip_comment(line: str) -> str:
    """Cut a ``#`` comment that stands outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.anchors = {}
        self.lines = []  # (line number, indent, content without comment)
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped[0] == "\t":
                raise ValueError(f"{self._at(n)}: tabs in indentation")
            self.lines.append((n, len(body) - len(stripped), stripped))

    def _at(self, n) -> str:
        return f"{self.name}:{n}"

    # ---- block context ---------------------------------------------------
    def document(self):
        if not self.lines:
            return None
        value, i = self._block(0)
        if i != len(self.lines):
            raise ValueError(f"{self._at(self.lines[i][0])}: unexpected indentation")
        return value

    def _block(self, i):
        n, indent, content = self.lines[i]
        if content == "-" or content.startswith("- "):
            raise ValueError(f"{self._at(n)}: block sequences are not supported")
        if self._split_key(content, n) is None:  # a lone node
            value, i = self._inline(content, i + 1, n)
            return value, i
        return self._mapping(i, indent)

    def _split_key(self, content, n):
        """(key, rest) of a ``key: value`` line, or None."""
        if content[0] in "'\"":
            key, p = self._quoted(content, 0, n)
            rest = content[p:].lstrip()
            if not rest.startswith(":"):
                return None
            return key, rest[1:].strip()
        if content[0] in "[{&*!|>":
            return None
        m = re.search(r":(?:\s|$)", content)
        if m is None:
            return None
        key = content[:m.start()].rstrip()
        if key == "<<":
            raise ValueError(f"{self._at(n)}: merge keys are not supported")
        return _resolve(key, self._at(n)), content[m.end():].strip()

    def _mapping(self, i, indent):
        out = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            n, _, content = self.lines[i]
            entry = self._split_key(content, n)
            if entry is None:
                raise ValueError(f"{self._at(n)}: expected 'key: value'")
            key, rest = entry
            i += 1
            anchor = None
            if rest.startswith("&"):
                anchor, _, rest = rest[1:].partition(" ")
                rest = rest.strip()
            if rest:
                value, i = self._inline(rest, i, n)
                if i < len(self.lines) and self.lines[i][1] > indent:
                    raise ValueError(f"{self._at(self.lines[i][0])}: multi-line plain "
                                     f"scalars are not supported")
            elif i < len(self.lines) and self.lines[i][1] > indent:
                value, i = self._block(i)
            else:
                value = None
            if anchor is not None:
                self.anchors[anchor] = value
            out[key] = value
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise ValueError(f"{self._at(self.lines[i][0])}: unexpected indentation")
        return out, i

    def _inline(self, text, i, n):
        """The node that ``text`` (the rest of line n) starts; a flow
        collection may go on over the next lines, which it consumes."""
        if text[0] in "|>":
            raise ValueError(f"{self._at(n)}: block scalars are not supported")
        if text[0] in "[{" or (text[0] in "&!" and re.match(r"[&!]\S*\s+[\[{]", text)):
            while True:
                try:
                    value, p = self._flow(text, 0, n)
                    break
                except _Incomplete:
                    if i >= len(self.lines):
                        raise ValueError(f"{self._at(n)}: unterminated flow collection")
                    text += " " + self.lines[i][2]
                    i += 1
        else:
            try:
                value, p = self._flow(text, 0, n, plain_to_end=True)
            except _Incomplete:
                raise ValueError(f"{self._at(n)}: unterminated scalar") from None
        if text[p:].strip():
            raise ValueError(f"{self._at(n)}: unexpected text {text[p:].strip()!r}")
        return value, i

    # ---- flow context ------------------------------------------------------
    def _flow(self, s, p, n, plain_to_end=False):
        """Parse one node of ``s`` from ``p``; returns (value, end)."""
        p = _skip_ws(s, p)
        if p >= len(s):
            raise _Incomplete()
        c = s[p]
        if c == "&":
            m = re.compile(r"&(\S+)").match(s, p)
            name = m.group(1).rstrip(_FLOW_END)
            value, p = self._flow(s, p + 1 + len(name), n, plain_to_end)
            self.anchors[name] = value
            return value, p
        if c == "*":
            m = re.compile(r"\*([^\s,\[\]{}]+)").match(s, p)
            if m is None or m.group(1) not in self.anchors:
                raise ValueError(f"{self._at(n)}: unknown alias {s[p:].split()[0]!r}")
            return self.anchors[m.group(1)], m.end()
        if c == "!":
            m = re.compile(r"!\S*").match(s, p)
            tag = m.group(0).rstrip(_FLOW_END)
            if tag not in _TAGS:
                raise ValueError(f"{self._at(n)}: tag {tag!r} is not supported")
            q = _skip_ws(s, p + len(tag))
            if q < len(s) and s[q] in "'\"":
                text, p = self._quoted(s, q, n)
            else:
                text, p = self._plain(s, q, plain_to_end)
            return _TAGS[tag](text), p
        if c == "[":
            out, p = [], p + 1
            while True:
                p = _skip_ws(s, p)
                if p >= len(s):
                    raise _Incomplete()
                if s[p] == "]":
                    return out, p + 1
                item, p = self._flow(s, p, n)
                out.append(item)
                p = self._sep(s, p, "]", n)
        if c == "{":
            out, p = {}, p + 1
            while True:
                p = _skip_ws(s, p)
                if p >= len(s):
                    raise _Incomplete()
                if s[p] == "}":
                    return out, p + 1
                k, p = self._flow(s, p, n)
                p = _skip_ws(s, p)
                if p < len(s) and s[p] == ":":
                    p = _skip_ws(s, p + 1)
                    if p < len(s) and s[p] in ",}":
                        v = None
                    else:
                        v, p = self._flow(s, p, n)
                else:
                    v = None
                out[k] = v
                p = self._sep(s, p, "}", n)
        if c in "'\"":
            return self._quoted(s, p, n)
        text, p = self._plain(s, p, plain_to_end)
        return _resolve(text, self._at(n)), p

    def _sep(self, s, p, close, n):
        p = _skip_ws(s, p)
        if p >= len(s):
            raise _Incomplete()
        if s[p] == ",":
            return p + 1
        if s[p] == close:
            return p
        raise ValueError(f"{self._at(n)}: expected ',' or {close!r} at {s[p:]!r}")

    @staticmethod
    def _plain(s, p, to_end):
        if to_end:
            return s[p:].strip(), len(s)
        q = p
        while q < len(s):
            c = s[q]
            if c in _FLOW_END or (c == ":" and (q + 1 == len(s) or s[q + 1] in " ,[]{}")):
                break
            q += 1
        return s[p:q].strip(), q

    def _quoted(self, s, p, n):
        quote, q, out = s[p], p + 1, []
        while q < len(s):
            c = s[q]
            if quote == "'" and c == "'":
                if s[q + 1:q + 2] == "'":
                    out.append("'")
                    q += 2
                    continue
                return "".join(out), q + 1
            if quote == '"' and c == '"':
                return "".join(out), q + 1
            if quote == '"' and c == "\\":
                e = s[q + 1:q + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    q += 2
                    continue
                if e in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[e]
                    out.append(chr(int(s[q + 2:q + 2 + width], 16)))
                    q += 2 + width
                    continue
                raise ValueError(f"{self._at(n)}: unknown escape \\{e}")
            out.append(c)
            q += 1
        raise _Incomplete()


class _Incomplete(Exception):
    """A flow node runs past the end of the text read so far."""


def _skip_ws(s, p):
    while p < len(s) and s[p] in " \t":
        p += 1
    return p


def load(text: str, name: str = "<yaml>"):
    """Parse YAML text of the supported subset (see the module docstring)."""
    return _Reader(text, name).document()
