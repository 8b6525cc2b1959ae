"""HCL2-subset parser (no third-party deps).

Reference: jobspec2/ parses the job DSL with hashicorp/hcl/v2; this is a
from-scratch subset covering what jobspecs actually use:

  * attributes `key = expr` and blocks `type "label" ... { body }`
  * strings with escapes and `${var.name}` interpolation, heredocs
  * numbers, bools, null, lists, objects
  * line (`#`, `//`) and block (`/* */`) comments
  * `variable "name" { default = ... }` declarations with caller
    overrides (the jobspec2 variables feature; NOMAD_VAR_* env between
    defaults and explicit -var, with type conversion to the default)
  * `locals { ... }` evaluated in declaration order against vars
  * the HCL2 expression layer: function calls (~30 stdlib functions),
    arithmetic/comparison/logic operators, `cond ? a : b`, indexing
  * `dynamic "type" { for_each / iterator / labels / content }` blocks

Runtime references (`${attr.x}`, `${meta.x}`, `${node.x}`) pass through
as literal text only when BARE — using one inside an expression is an
error, since it resolves at placement/task time, after evaluation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional


class HCLParseError(Exception):
    def __init__(self, msg: str, line: int) -> None:
        super().__init__(f"line {line}: {msg}")
        self.line = line


@dataclass
class Attr:
    key: str
    value: Any
    line: int


@dataclass
class Block:
    type: str
    labels: list[str]
    body: "Body"
    line: int


@dataclass
class Body:
    items: list = field(default_factory=list)

    def attrs(self) -> dict[str, Any]:
        return {i.key: i.value for i in self.items if isinstance(i, Attr)}

    def blocks(self, btype: Optional[str] = None) -> list[Block]:
        out = [i for i in self.items if isinstance(i, Block)]
        if btype is not None:
            out = [b for b in out if b.type == btype]
        return out

    def block(self, btype: str) -> Optional[Block]:
        bs = self.blocks(btype)
        return bs[0] if bs else None


class RuntimePassthrough(str):
    """A `${...}` reference deferred to runtime (scheduler/taskenv).
    Legal as a whole attr value or template part; ILLEGAL inside an
    expression, where it would silently compute on the literal text."""


# Sentinel for `${...}` references resolved at evaluation time.
@dataclass
class Ref:
    path: str  # e.g. "var.region"
    line: int


@dataclass
class Template:
    """A string with interpolation parts: list of str | Ref | expr."""

    parts: list


# Expression AST (the jobspec2/HCL2 expression subset: functions,
# operators, conditionals — reference jobspec2/parse.go + hcl/v2).
@dataclass
class Call:
    fn: str
    args: list
    line: int


@dataclass
class BinOp:
    op: str
    left: Any
    right: Any
    line: int


@dataclass
class Unary:
    op: str  # "-" | "!"
    operand: Any
    line: int


@dataclass
class Cond:
    cond: Any
    then: Any
    other: Any
    line: int


@dataclass
class Index:
    obj: Any
    key: Any
    line: int


_SIMPLE_REF_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")


def _match_brace(src: str, open_pos: int, line: int) -> int:
    """Index of the '}' matching src[open_pos]=='{', honoring nested
    braces and string literals."""
    depth = 0
    i = open_pos
    in_str = False
    while i < len(src):
        ch = src[i]
        # Inner strings appear either bare (`"a"`, HCL2 template style)
        # or outer-escaped (`\"a\"`); both toggle string state.
        if ch == "\\" and src[i + 1 : i + 2] == '"':
            in_str = not in_str
            i += 2
            continue
        if in_str:
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    raise HCLParseError("unterminated interpolation", line)


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<nl>\n)
  | (?P<heredoc><<-?(?P<htag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<num>\d+(\.\d+)?(?![A-Za-z_]))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.-]*)
  | (?P<string>")
  | (?P<punct>==|!=|<=|>=|&&|\|\||[{}\[\]=,:()?<>!+\-*/%])
    """,
    re.VERBOSE | re.DOTALL,
)


class _Lexer:
    def __init__(self, src: str) -> None:
        self.src = src
        self.pos = 0
        self.line = 1
        self.tokens: list[tuple[str, Any, int]] = []
        self._lex()
        self.i = 0

    def _lex(self) -> None:
        src = self.src
        while self.pos < len(src):
            m = _TOKEN_RE.match(src, self.pos)
            if m is None:
                raise HCLParseError(
                    f"unexpected character {src[self.pos]!r}", self.line
                )
            kind = m.lastgroup
            if kind == "htag":
                kind = "heredoc"
            text = m.group(0)
            if kind == "ws":
                pass
            elif kind == "comment":
                self.line += text.count("\n")
            elif kind == "nl":
                self.tokens.append(("nl", None, self.line))
                self.line += 1
            elif kind == "heredoc":
                self.pos = m.end()
                self._lex_heredoc(m.group("htag"), text.startswith("<<-"))
                continue
            elif kind == "num":
                n = float(text) if "." in text else int(text)
                self.tokens.append(("num", n, self.line))
            elif kind == "ident":
                self.tokens.append(("ident", text, self.line))
            elif kind == "string":
                self.pos = m.end()
                self._lex_string()
                continue
            else:
                self.tokens.append(("punct", text, self.line))
            self.pos = m.end()
        self.tokens.append(("eof", None, self.line))

    def _lex_heredoc(self, tag: str, indent: bool) -> None:
        self.line += 1
        lines = []
        while True:
            end = self.src.find("\n", self.pos)
            if end == -1:
                raise HCLParseError(f"unterminated heredoc {tag}", self.line)
            ln = self.src[self.pos : end]
            self.pos = end + 1
            self.line += 1
            if ln.strip() == tag:
                break
            lines.append(ln)
        if indent and lines:
            pad = min(
                (len(l) - len(l.lstrip()) for l in lines if l.strip()),
                default=0,
            )
            lines = [l[pad:] for l in lines]
        self.tokens.append(("str", "\n".join(lines) + "\n", self.line))

    def _lex_string(self) -> None:
        """From after the opening quote: handle escapes + ${...}."""
        parts: list = []
        buf: list[str] = []
        src = self.src
        while True:
            if self.pos >= len(src):
                raise HCLParseError("unterminated string", self.line)
            ch = src[self.pos]
            if ch == '"':
                self.pos += 1
                break
            if ch == "\\":
                esc = src[self.pos + 1 : self.pos + 2]
                buf.append(
                    {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc)
                )
                self.pos += 2
                continue
            if ch == "$" and src[self.pos + 1 : self.pos + 2] == "{":
                end = _match_brace(src, self.pos + 1, self.line)
                expr = src[self.pos + 2 : end].strip()
                if buf:
                    parts.append("".join(buf))
                    buf = []
                # simple dotted path stays a Ref (runtime refs like
                # ${attr.cpu} pass through); anything else is a full
                # expression parsed by the sub-lexer
                if _SIMPLE_REF_RE.fullmatch(expr):
                    parts.append(Ref(expr, self.line))
                else:
                    # outer-escaped inner quotes normalize to bare for
                    # the sub-parse
                    sub = _Lexer(expr.replace('\\"', '"'))
                    node = _parse_expr(sub)
                    k, v, l = sub.peek()
                    if k != "eof":
                        raise HCLParseError(
                            f"trailing {v!r} in interpolation", self.line
                        )
                    parts.append(node)
                self.pos = end + 1
                continue
            if ch == "\n":
                self.line += 1
            buf.append(ch)
            self.pos += 1
        if buf or not parts:
            parts.append("".join(buf))
        if len(parts) == 1 and isinstance(parts[0], str):
            self.tokens.append(("str", parts[0], self.line))
        else:
            self.tokens.append(("str", Template(parts), self.line))

    # -- token stream --------------------------------------------------

    def peek(self, skip_nl: bool = True):
        i = self.i
        while skip_nl and self.tokens[i][0] == "nl":
            i += 1
        return self.tokens[i]

    def next(self, skip_nl: bool = True):
        while skip_nl and self.tokens[self.i][0] == "nl":
            self.i += 1
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_punct(self, p: str):
        kind, val, line = self.next()
        if kind != "punct" or val != p:
            raise HCLParseError(f"expected {p!r}, got {val!r}", line)


def _parse_body(lx: _Lexer, outermost: bool = False) -> Body:
    body = Body()
    while True:
        kind, val, line = lx.peek()
        if kind == "eof":
            if not outermost:
                raise HCLParseError("unexpected EOF in block", line)
            return body
        if kind == "punct" and val == "}":
            lx.next()
            return body
        if kind != "ident" and kind != "str":
            raise HCLParseError(f"expected identifier, got {val!r}", line)
        name = lx.next()[1]
        # attribute or block?
        kind2, val2, line2 = lx.peek()
        if kind2 == "punct" and val2 == "=":
            lx.next()
            body.items.append(Attr(name, _parse_expr(lx), line))
            continue
        labels: list[str] = []
        while True:
            kind2, val2, line2 = lx.peek()
            if kind2 in ("str", "ident"):
                labels.append(lx.next()[1])
                continue
            break
        lx.expect_punct("{")
        body.items.append(Block(name, labels, _parse_body(lx), line))


def _parse_expr(lx: _Lexer):
    """Full expression: ternary over binary operators over primaries
    (the HCL2 expression subset jobspec2 exposes)."""
    return _parse_ternary(lx)


def _parse_ternary(lx: _Lexer):
    cond = _parse_or(lx)
    k, v, line = lx.peek()
    if k == "punct" and v == "?":
        lx.next()
        then = _parse_ternary(lx)
        kk, vv, ll = lx.next()
        if kk != "punct" or vv != ":":
            raise HCLParseError(f"expected ':' in conditional, got {vv!r}", ll)
        other = _parse_ternary(lx)
        return Cond(cond, then, other, line)
    return cond


def _parse_binop(lx, ops, next_level):
    left = next_level(lx)
    while True:
        k, v, line = lx.peek()
        if k == "punct" and v in ops:
            lx.next()
            left = BinOp(v, left, next_level(lx), line)
        else:
            return left


def _parse_or(lx):
    return _parse_binop(lx, ("||",), _parse_and)


def _parse_and(lx):
    return _parse_binop(lx, ("&&",), _parse_cmp)


def _parse_cmp(lx):
    return _parse_binop(
        lx, ("==", "!=", "<", "<=", ">", ">="), _parse_add
    )


def _parse_add(lx):
    return _parse_binop(lx, ("+", "-"), _parse_mul)


def _parse_mul(lx):
    return _parse_binop(lx, ("*", "/", "%"), _parse_unary)


def _parse_unary(lx):
    k, v, line = lx.peek()
    if k == "punct" and v in ("-", "!"):
        lx.next()
        return Unary(v, _parse_unary(lx), line)
    return _parse_postfix(lx)


def _parse_postfix(lx):
    node = _parse_primary(lx)
    while True:
        k, v, line = lx.peek(skip_nl=False)
        if k == "punct" and v == "[":
            lx.next()
            key = _parse_expr(lx)
            kk, vv, ll = lx.next()
            if kk != "punct" or vv != "]":
                raise HCLParseError(f"expected ']', got {vv!r}", ll)
            node = Index(node, key, line)
        else:
            return node


def _parse_primary(lx):
    kind, val, line = lx.next()
    if kind in ("num", "str"):
        return val
    if kind == "ident":
        if val == "true":
            return True
        if val == "false":
            return False
        if val == "null":
            return None
        # function call?
        k2, v2, l2 = lx.peek(skip_nl=False)
        if k2 == "punct" and v2 == "(":
            lx.next()
            args = []
            while True:
                k3, v3, l3 = lx.peek()
                if k3 == "punct" and v3 == ")":
                    lx.next()
                    break
                args.append(_parse_expr(lx))
                k3, v3, l3 = lx.peek()
                if k3 == "punct" and v3 == ",":
                    lx.next()
            return Call(val, args, line)
        return Ref(val, line)  # bare reference, e.g. var.count
    if kind == "punct" and val == "(":
        node = _parse_expr(lx)
        k2, v2, l2 = lx.next()
        if k2 != "punct" or v2 != ")":
            raise HCLParseError(f"expected ')', got {v2!r}", l2)
        return node
    if kind == "punct" and val == "[":
        items = []
        while True:
            k, v, l = lx.peek()
            if k == "punct" and v == "]":
                lx.next()
                return items
            items.append(_parse_expr(lx))
            k, v, l = lx.peek()
            if k == "punct" and v == ",":
                lx.next()
    if kind == "punct" and val == "{":
        obj = {}
        while True:
            k, v, l = lx.peek()
            if k == "punct" and v == "}":
                lx.next()
                return obj
            key = lx.next()
            if key[0] not in ("ident", "str"):
                raise HCLParseError(f"bad object key {key[1]!r}", l)
            sep = lx.next()
            if sep[0] != "punct" or sep[1] not in ("=", ":"):
                raise HCLParseError("expected = or : in object", l)
            obj[key[1]] = _parse_expr(lx)
            k, v, l = lx.peek()
            if k == "punct" and v == ",":
                lx.next()
    raise HCLParseError(f"unexpected token {val!r}", line)


def _resolve(value, variables: dict):
    """Evaluate expression nodes against the variable map. Non-`var.`/
    `local.` references (`${attr.kernel.name}`, `${node.datacenter}`,
    `${meta.x}`) are RUNTIME interpolations — the scheduler and taskenv
    resolve them later — so a bare Ref to one passes through as literal
    `${...}` text, exactly like the reference jobspec."""
    if isinstance(value, Ref):
        return _lookup(value.path, variables, value.line)
    if isinstance(value, Template):
        out = []
        for p in value.parts:
            if isinstance(p, str):
                out.append(p)
            else:
                v = _resolve(p, variables)
                if isinstance(v, bool):
                    v = "true" if v else "false"
                out.append(v if isinstance(v, str) else str(v))
        return "".join(out)
    if isinstance(value, Call):
        fn = _FUNCTIONS.get(value.fn)
        if fn is None:
            raise HCLParseError(f"unknown function {value.fn!r}", value.line)
        args = [_resolve(a, variables) for a in value.args]
        _no_runtime(args, value.line)
        try:
            return fn(*args)
        except HCLParseError:
            raise
        except Exception as e:
            raise HCLParseError(
                f"{value.fn}(...): {e}", value.line
            ) from e
    if isinstance(value, BinOp):
        left = _resolve(value.left, variables)
        _no_runtime([left], value.line)
        if value.op == "&&":
            if not left:
                return False
            right = _resolve(value.right, variables)
            _no_runtime([right], value.line)
            return bool(right)
        if value.op == "||":
            if left:
                return True
            right = _resolve(value.right, variables)
            _no_runtime([right], value.line)
            return bool(right)
        right = _resolve(value.right, variables)
        _no_runtime([right], value.line)
        try:
            if value.op == "==":
                return left == right
            if value.op == "!=":
                return left != right
            if value.op == "<":
                return left < right
            if value.op == "<=":
                return left <= right
            if value.op == ">":
                return left > right
            if value.op == ">=":
                return left >= right
            if value.op == "+":
                return left + right
            if value.op == "-":
                return left - right
            if value.op == "*":
                return left * right
            if value.op == "/":
                return left / right
            if value.op == "%":
                return left % right
        except TypeError as e:
            raise HCLParseError(
                f"operator {value.op!r}: {e}", value.line
            ) from e
        raise HCLParseError(f"unknown operator {value.op!r}", value.line)
    if isinstance(value, Unary):
        v = _resolve(value.operand, variables)
        _no_runtime([v], value.line)
        if value.op == "-":
            return -v
        return not v
    if isinstance(value, Cond):
        cond = _resolve(value.cond, variables)
        _no_runtime([cond], value.line)
        return (
            _resolve(value.then, variables)
            if cond
            else _resolve(value.other, variables)
        )
    if isinstance(value, Index):
        obj = _resolve(value.obj, variables)
        key = _resolve(value.key, variables)
        _no_runtime([obj, key], value.line)
        try:
            if isinstance(obj, list):
                return obj[int(key)]
            return obj[key]
        except (KeyError, IndexError, TypeError, ValueError) as e:
            raise HCLParseError(f"index {key!r}: {e}", value.line) from e
    if isinstance(value, list):
        return [_resolve(v, variables) for v in value]
    if isinstance(value, dict):
        return {k: _resolve(v, variables) for k, v in value.items()}
    return value


def _no_runtime(values, line: int) -> None:
    """Deep-scan for runtime passthroughs (containers included: a list
    element feeding join() is just as wrong as a direct operand)."""
    for v in values:
        if isinstance(v, list):
            _no_runtime(v, line)
            continue
        if isinstance(v, dict):
            _no_runtime(list(v.values()), line)
            continue
        if isinstance(v, RuntimePassthrough):
            raise HCLParseError(
                f"runtime reference {v} cannot be used inside an "
                f"expression — it resolves at placement/task time, after "
                f"the jobspec is evaluated; only a bare ${{...}} "
                f"interpolation may defer", line,
            )


def _lookup(path: str, variables: dict, line: int):
    parts = path.split(".")
    if parts[0] not in ("var", "local") and parts[0] not in variables.get(
        "__iterators__", ()
    ):
        # runtime interpolation: pass through as literal text
        return RuntimePassthrough("${" + path + "}")
    if parts[0] == "var":
        cur: Any = variables
        parts = parts[1:]
    elif parts[0] == "local":
        cur = variables.get("__locals__", {})
        parts = parts[1:]
    else:
        cur = variables["__iterators__"]
    for p in parts:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            raise HCLParseError(f"unknown variable {path!r}", line)
    return cur


# -- function table (reference: jobspec2/functions.go / go-cty stdlib) --

def _format(fmt, *args):
    # Go-style verbs → Python: %s %d %f %q cover real jobspecs
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            verb = fmt[i + 1]
            if verb == "%":
                out.append("%")
            elif verb in "sdfvq":
                a = args[ai]
                ai += 1
                if verb == "d":
                    out.append(str(int(a)))
                elif verb == "f":
                    out.append(str(float(a)))
                elif verb == "q":
                    out.append('"%s"' % a)
                else:
                    out.append(
                        ("true" if a else "false")
                        if isinstance(a, bool)
                        else str(a)
                    )
            else:
                raise ValueError(f"unsupported format verb %{verb}")
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


_FUNCTIONS = {
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "title": lambda s: str(s).title(),
    "trimspace": lambda s: str(s).strip(),
    "format": _format,
    "replace": lambda s, a, b: str(s).replace(str(a), str(b)),
    "split": lambda sep, s: str(s).split(str(sep)),
    "join": lambda sep, xs: str(sep).join(str(x) for x in xs),
    "length": lambda x: len(x),
    "concat": lambda *ls: [x for l in ls for x in l],
    "contains": lambda xs, v: v in xs,
    "distinct": lambda xs: list(dict.fromkeys(xs)),
    "flatten": lambda xs: [
        y for x in xs for y in (x if isinstance(x, list) else [x])
    ],
    "compact": lambda xs: [x for x in xs if x not in ("", None)],
    "reverse": lambda xs: list(reversed(xs)),
    "sort": lambda xs: sorted(xs),
    "merge": lambda *ds: {k: v for d in ds for k, v in d.items()},
    "keys": lambda d: sorted(d.keys()),
    "values": lambda d: [d[k] for k in sorted(d.keys())],
    "lookup": lambda d, k, *default: d.get(k, default[0] if default else None),
    "min": lambda *xs: min(xs[0] if len(xs) == 1 else xs),
    "max": lambda *xs: max(xs[0] if len(xs) == 1 else xs),
    "abs": lambda x: abs(x),
    "floor": lambda x: int(__import__("math").floor(x)),
    "ceil": lambda x: int(__import__("math").ceil(x)),
    "range": lambda *a: list(range(*[int(x) for x in a])),
    "coalesce": lambda *xs: next(
        (x for x in xs if x not in (None, "")), None
    ),
    "tonumber": lambda x: float(x) if "." in str(x) else int(x),
    "tostring": lambda x: (
        ("true" if x else "false") if isinstance(x, bool) else str(x)
    ),
    "substr": lambda s, off, ln: str(s)[off : off + ln if ln >= 0 else None],
    "base64encode": lambda s: __import__("base64").b64encode(
        str(s).encode()
    ).decode(),
    "base64decode": lambda s: __import__("base64").b64decode(
        str(s)
    ).decode(),
    "regex_replace": lambda s, pat, rep: __import__("re").sub(
        pat, rep, str(s)
    ),
    "trimprefix": lambda s, p: (
        str(s)[len(p):] if str(s).startswith(p) else str(s)
    ),
    "trimsuffix": lambda s, p: (
        str(s)[: -len(p)] if p and str(s).endswith(p) else str(s)
    ),
}


def parse(src: str, variables: Optional[dict] = None) -> Body:
    """Parse HCL source; resolve `variable`/`locals` blocks, functions,
    conditionals, and dynamic blocks (the jobspec2 feature set).

    Variable precedence (reference jobspec2): defaults < NOMAD_VAR_*
    env < explicit `variables` (CLI -var)."""
    import os as _os

    lx = _Lexer(src)
    body = _parse_body(lx, outermost=True)
    # collect variable defaults (jobspec2 Variables)
    var_map: dict[str, Any] = {}
    locals_blocks: list[Body] = []
    rest = Body()
    for item in body.items:
        if isinstance(item, Block) and item.type == "variable":
            name = item.labels[0] if item.labels else ""
            var_map[name] = _resolve(item.body.attrs().get("default"), {})
        elif isinstance(item, Block) and item.type == "locals":
            locals_blocks.append(item.body)
        else:
            rest.items.append(item)
    defaults = dict(var_map)
    for name in list(var_map):
        env_val = _os.environ.get(f"NOMAD_VAR_{name}")
        if env_val is not None:
            var_map[name] = env_val
    var_map.update(variables or {})
    # CLI -var / env overrides arrive as strings: convert to the
    # default's type (the jobspec2 variable-type conversion)
    for name, val in list(var_map.items()):
        default = defaults.get(name)
        if not isinstance(val, str) or isinstance(default, str):
            continue
        try:
            if isinstance(default, bool):
                var_map[name] = val.lower() in ("1", "true", "yes")
            elif isinstance(default, int):
                var_map[name] = int(val)
            elif isinstance(default, float):
                var_map[name] = float(val)
        except ValueError:
            raise HCLParseError(
                f"variable {name!r}: cannot convert {val!r} to "
                f"{type(default).__name__}", 0,
            ) from None
    # locals may reference vars and earlier locals (reference: HCL2
    # evaluates locals in dependency order; declaration order suffices
    # for the jobspec2 subset)
    locals_map: dict[str, Any] = {}
    scope = dict(var_map)
    scope["__locals__"] = locals_map
    for lb in locals_blocks:
        for a in (i for i in lb.items if isinstance(i, Attr)):
            locals_map[a.key] = _resolve(a.value, scope)
    return _resolve_body(rest, scope)


def _expand_dynamic(block: Block, variables: dict) -> list[Block]:
    """dynamic "target" { for_each = ...; iterator = name;
    labels = [...]; content { ... } } → N target blocks (reference
    jobspec2 dynamic blocks / hcl2 dynblock)."""
    target = block.labels[0] if block.labels else ""
    attrs = block.body.attrs()
    if "for_each" not in attrs:
        raise HCLParseError(
            f'dynamic "{target}": missing for_each', block.line
        )
    for_each = _resolve(attrs["for_each"], variables)
    iterator = attrs.get("iterator") or target
    if isinstance(iterator, Ref):
        # `iterator = v` names the loop variable, it doesn't reference one
        iterator = iterator.path
    elif isinstance(iterator, Template):
        iterator = _resolve(iterator, variables)
    content = block.body.block("content")
    if content is None:
        raise HCLParseError(
            f'dynamic "{target}": missing content block', block.line
        )
    if isinstance(for_each, dict):
        pairs = list(for_each.items())
    elif isinstance(for_each, list):
        pairs = list(enumerate(for_each))
    else:
        raise HCLParseError(
            f'dynamic "{target}": for_each must be a list or map',
            block.line,
        )
    out: list[Block] = []
    for key, val in pairs:
        scope = dict(variables)
        iters = dict(scope.get("__iterators__", {}))
        iters[iterator] = {"key": key, "value": val}
        scope["__iterators__"] = iters
        labels = attrs.get("labels", [])
        labels = [
            x if isinstance(x, str) else str(x)
            for x in (_resolve(labels, scope) or [])
        ]
        out.append(
            Block(target, labels, _resolve_body(content.body, scope),
                  block.line)
        )
    return out


def _resolve_body(body: Body, variables: dict) -> Body:
    out = Body()
    for item in body.items:
        if isinstance(item, Attr):
            out.items.append(
                Attr(item.key, _resolve(item.value, variables), item.line)
            )
        elif item.type == "dynamic":
            out.items.extend(_expand_dynamic(item, variables))
        else:
            out.items.append(
                Block(
                    item.type,
                    [
                        _resolve(l, variables) if not isinstance(l, str) else l
                        for l in item.labels
                    ],
                    _resolve_body(item.body, variables),
                    item.line,
                )
            )
    return out


def parse_duration(v) -> float:
    """'30s' / '5m' / '1h' / '250ms' / bare number → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)?", s)
    if m is None:
        raise ValueError(f"bad duration {v!r}")
    n = float(m.group(1))
    unit = m.group(2) or "s"
    return n * {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[unit]
