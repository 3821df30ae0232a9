"""rules.yaml / targets.yaml parsing + template machinery (paper Fig. 1),
the port's copy of the JAX package's `repro.core.pmake.rules`.

Substitution uses Python format() semantics, staged in the paper's order:
 i) target members (loop excluded), ii) loop variables, iii) rule members
 (script excluded), iv) the script (which also receives {mpirun}).
Unresolved keys survive each stage (SafeDict), so later stages can fill
them; literal braces must be escaped ({{ }}), as in the paper.

The files are read by `load_yaml`, a reader of the YAML subset pmake's
files use, so the port needs no YAML package: block mappings by
indentation, one-line flow mappings (`{time: 10, nrs: 1}`), `|` literal
block scalars, single- and double-quoted scalars, plain scalars typed as
YAML 1.1's resolver (PyYAML's `safe_load`) types them — int, float, bool,
null, else str — and `#` comments.  Anything else (sequences, anchors,
tags, folded scalars, multi-line plain or quoted scalars, timestamps,
several documents) raises `ValueError`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional


class SafeDict(dict):
    def __missing__(self, key):
        return "{" + key + "}"


def staged_format(text: str, ctx: dict) -> str:
    try:
        return text.format_map(SafeDict(ctx))
    except (IndexError, KeyError, ValueError):
        return text


# ---------------------------------------------------------------- YAML subset

# YAML 1.1's implicit types, as PyYAML's resolver spells them
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN)""", re.X)
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign, value = 1, text
    if value[0] in "+-":
        sign, value = (-1 if value[0] == "-" else 1), value[1:]
    total, base = 0, 1
    for digit in reversed(value.split(":")):
        total += cast(digit) * base
        base *= 60
    return sign * total


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = 1
    if v[0] in "+-":
        sign, v = (-1 if v[0] == "-" else 1), v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    if v[0] == "0":
        return sign * int(v, 8)
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = 1.0
    if v[0] in "+-":
        sign, v = (-1.0 if v[0] == "-" else 1.0), v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _resolve(text: str) -> Any:
    """A plain scalar typed as YAML 1.1's resolver types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return _int(text)
    if _FLOAT.fullmatch(text):
        return _float(text)
    if _TIMESTAMP.fullmatch(text) or text in ("<<", "="):
        raise ValueError(f"YAML subset: {text!r} is a timestamp, merge key "
                         f"or value key, which pmake's files do not use")
    return text


class _Reader:
    """One pass over the lines; raises ValueError with the line number on
    anything outside the subset."""

    def __init__(self, text: str):
        self.lines = text.split("\n")
        self.i = 0

    def fail(self, why: str, line: Optional[int] = None):
        n = self.i if line is None else line
        raise ValueError(f"YAML subset, line {n + 1}: {why}")

    # -- lines -----------------------------------------------------------
    def _indent(self, line: str) -> int:
        stripped = line.lstrip(" ")
        if stripped.startswith("\t"):
            self.fail("a tab in the indentation")
        return len(line) - len(stripped)

    def _skip_blank(self):
        """Move to the next line with content; returns its indent or None at
        the end."""
        while self.i < len(self.lines):
            line = self.lines[self.i]
            body = line.strip()
            if body and not body.startswith("#"):
                return self._indent(line)
            self.i += 1
        return None

    # -- scalars ---------------------------------------------------------
    def _quoted(self, s: str, pos: int) -> tuple[str, int]:
        """The quoted scalar starting at s[pos]; returns (value, end)."""
        q, out, j = s[pos], [], pos + 1
        while j < len(s):
            c = s[j]
            if q == "'" and c == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                e = s[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                if e in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[e]
                    digits = s[j + 2:j + 2 + k]
                    if len(digits) != k or not re.fullmatch(
                            r"[0-9a-fA-F]+", digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    j += 2 + k
                    continue
                self.fail(f"escape \\{e} at the end of a line or unknown "
                          f"(multi-line quoted scalars are outside the "
                          f"subset)")
            out.append(c)
            j += 1
        self.fail("a quoted scalar that does not end on its line")

    def _rest_is_comment(self, s: str, pos: int):
        rest = s[pos:]
        if rest.strip() and not re.match(r"\s+#", rest):
            self.fail(f"text after a complete value: {rest.strip()!r}")

    def _plain(self, text: str, flow: bool) -> Any:
        if not text:
            return None
        if text[0] in "&*!%@`|>,[]{}'\"#" or (
                text[0] in "-?:" and (len(text) == 1 or text[1] == " ")):
            self.fail(f"{text!r} starts with a YAML indicator outside the "
                      f"subset")
        if ": " in text or text.endswith(":") or (flow and any(
                c in text for c in ",[]{}")):
            self.fail(f"{text!r}: a mapping value where none is allowed")
        return _resolve(text)

    def _strip_comment(self, s: str) -> str:
        m = re.search(r"(^|\s)#", s)
        return (s[:m.start()] if m else s).rstrip()

    # -- flow mapping (one line) -----------------------------------------
    def _flow_mapping(self, s: str, pos: int) -> tuple[dict, int]:
        out: dict = {}
        j = pos + 1

        def ws(k):
            while k < len(s) and s[k] in " \t":
                k += 1
            return k

        def plain_end(k, stop):
            while k < len(s) and s[k] not in stop and not (
                    s[k] == ":" and s[k + 1:k + 2] in (" ", ",", "}", "")):
                k += 1
            return k

        j = ws(j)
        if s[j:j + 1] == "}":
            return out, j + 1
        while True:
            j = ws(j)
            if j >= len(s):
                self.fail("a flow mapping that does not end on its line")
            if s[j] in "'\"":
                key, j = self._quoted(s, j)
            else:
                e = plain_end(j, ",{}[]#")
                key = self._plain(s[j:e].strip(), flow=True)
                j = e
            j = ws(j)
            if s[j:j + 1] != ":":
                self.fail("a flow mapping entry without ': value'")
            j = ws(j + 1)
            if s[j:j + 1] == "{":
                value, j = self._flow_mapping(s, j)
            elif s[j:j + 1] in ("'", '"'):
                value, j = self._quoted(s, j)
            elif s[j:j + 1] == "[":
                self.fail("flow sequences are outside the subset")
            else:
                e = plain_end(j, ",{}[]#")
                value = self._plain(s[j:e].strip(), flow=True)
                j = e
            out[key] = value
            j = ws(j)
            c = s[j:j + 1]
            if c == ",":
                j = ws(j + 1)
                if s[j:j + 1] == "}":
                    return out, j + 1
            elif c == "}":
                return out, j + 1
            else:
                self.fail("a flow mapping that does not end on its line")

    # -- block structure -------------------------------------------------
    def _block_scalar(self, parent: int) -> str:
        """A `|` literal with clip chomping: the lines indented past
        `parent`, the indentation of the first one removed, one final line
        break."""
        body: list[str] = []
        indent = None
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if not line.strip():
                body.append(line[indent:] if indent is not None
                            and len(line) > indent else "")
                self.i += 1
                continue
            ind = len(line) - len(line.lstrip(" "))
            if indent is None:
                if ind <= parent:
                    break
                indent = ind
            if ind < indent:
                break
            body.append(line[indent:])
            self.i += 1
        while body and not body[-1]:
            body.pop()
        return "\n".join(body) + "\n" if body else ""

    def _split_key(self, content: str) -> tuple[Any, str]:
        if content[0] in "'\"":
            key, j = self._quoted(content, 0)
            rest = content[j:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                self.fail("a quoted key without ':'")
            return key, rest[1:]
        m = re.search(r":( |$)", content)
        comment = re.search(r"\s#", content)
        if m is None or (comment is not None and comment.start() < m.start()):
            self.fail(f"{content.strip()!r} is not a 'key: value' line "
                      f"(sequences and multi-line plain scalars are outside "
                      f"the subset)")
        return self._plain(content[:m.start()].strip(), flow=False), \
            content[m.end():]

    def _block_mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            ind = self._skip_blank()
            if ind is None or ind < indent:
                return out
            if ind > indent:
                self.fail("unexpected indentation")
            line_no = self.i
            content = self.lines[self.i][ind:]
            if content.startswith("---") or content.startswith("..."):
                self.fail("document markers are outside the subset")
            if content == "-" or content.startswith("- "):
                self.fail("block sequences are outside the subset")
            key, rest = self._split_key(content)
            self.i += 1
            rest = rest.strip()
            if rest[:1] in ("'", '"'):
                value, j = self._quoted(rest, 0)
                self._rest_is_comment(rest, j)
            elif rest[:1] == "{":
                value, j = self._flow_mapping(rest, 0)
                self._rest_is_comment(rest, j)
            elif rest[:1] == "|":
                if self._strip_comment(rest) != "|":
                    self.fail("only the plain '|' block scalar header is in "
                              "the subset", line_no)
                value = self._block_scalar(indent)
            else:
                rest = self._strip_comment(rest)
                if rest:
                    value = self._plain(rest, flow=False)
                else:
                    nxt = self._skip_blank()
                    value = (self._block_mapping(nxt)
                             if nxt is not None and nxt > indent else None)
                    out[key] = value
                    continue
            nxt = self._skip_blank()
            if nxt is not None and nxt > indent:
                self.fail("a value continued on a more indented line "
                          "(multi-line scalars are outside the subset)")
            out[key] = value

    def read(self) -> Any:
        ind = self._skip_blank()
        if ind is None:
            return None
        value = self._block_mapping(ind)
        if self._skip_blank() is not None:
            self.fail("a line indented less than the document")
        return value


def load_yaml(text: str) -> Any:
    """The YAML subset of pmake's files (module docstring): a nested dict,
    or None for an empty text, equal to `yaml.safe_load(text)`."""
    return _Reader(text).read()


# ---------------------------------------------------------------- rules


@dataclass
class Resources:
    time: float = 10.0            # minutes
    nrs: int = 1                  # resource sets (~nodes)
    cpu: int = 1
    gpu: int = 0
    ranks: int = 1                # MPI ranks per resource set

    @property
    def node_hours(self) -> float:
        return self.time / 60.0 * self.nrs


@dataclass
class Rule:
    name: str
    resources: Resources
    inp: dict = field(default_factory=dict)     # key -> filename template
    out: dict = field(default_factory=dict)
    setup: str = ""
    script: str = ""
    loop: dict = field(default_factory=dict)    # var -> python iterable expr

    def template_var(self) -> Optional[str]:
        """The single allowed template variable, from the out section."""
        for t in self.out.values():
            m = re.findall(r"\{(\w+)(?:\[[^]]*\])?\}", t)
            for v in m:
                if v not in ("inp", "out", "mpirun"):
                    return v
        return None


@dataclass
class Target:
    name: str
    dirname: str = "."
    out: dict = field(default_factory=dict)
    tgt: dict = field(default_factory=dict)
    loop: dict = field(default_factory=dict)
    attrs: dict = field(default_factory=dict)   # arbitrary members


def parse_rules(text: str) -> dict[str, Rule]:
    raw = load_yaml(text) or {}
    rules = {}
    for name, spec in raw.items():
        res = Resources(**(spec.get("resources") or {}))
        rules[name] = Rule(
            name=name, resources=res,
            inp=dict(spec.get("inp") or {}),
            out=dict(spec.get("out") or {}),
            setup=spec.get("setup", "") or "",
            script=spec.get("script", "") or "",
            loop=dict(spec.get("loop") or {}),
        )
    return rules


_RESERVED = {"dirname", "out", "tgt", "loop"}


def parse_targets(text: str) -> dict[str, Target]:
    raw = load_yaml(text) or {}
    targets = {}
    for name, spec in raw.items():
        targets[name] = Target(
            name=name,
            dirname=spec.get("dirname", "."),
            out=dict(spec.get("out") or {}),
            tgt=dict(spec.get("tgt") or {}),
            loop=dict(spec.get("loop") or {}),
            attrs={k: v for k, v in spec.items() if k not in _RESERVED},
        )
    return targets


def expand_loop(loop: dict, ctx: dict) -> list[dict]:
    """loop: {var: "range(1,11)"} -> [{var: 1}, ..., {var: 10}] (cartesian)."""
    combos = [dict()]
    for var, expr in loop.items():
        if isinstance(expr, str):
            vals = list(eval(expr, {"range": range}, dict(ctx)))  # noqa: S307
        else:
            vals = list(expr)
        combos = [dict(c, **{var: v}) for c in combos for v in vals]
    return combos


def template_regex(template: str) -> re.Pattern:
    """Out-template -> regex extracting the template variable."""
    pat = ""
    for piece in re.split(r"(\{\w+\})", template):
        m = re.fullmatch(r"\{(\w+)\}", piece)
        if m:
            pat += f"(?P<{m.group(1)}>.+?)"
        else:
            pat += re.escape(piece)
    return re.compile("^" + pat + "$")


def match_output(rule: Rule, filename: str) -> Optional[dict]:
    """If `filename` matches one of the rule's out templates, return the
    extracted variable bindings (possibly empty)."""
    for t in rule.out.values():
        m = template_regex(t).match(filename)
        if m:
            return m.groupdict()
    return None
