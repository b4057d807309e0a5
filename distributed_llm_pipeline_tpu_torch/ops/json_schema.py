"""JSON-schema → GBNF conversion (llama-server ``json_schema`` parity).

The port's copy of ``distributed_llm_pipeline_tpu/ops/json_schema.py``.

llama.cpp converts a JSON schema into its GBNF grammar and then samples
under that grammar (llama-server accepts ``json_schema`` on /completion and
OpenAI ``response_format: {"type": "json_schema", ...}``; reference N10/N13
— SURVEY.md §2.2). This module is that converter targeting ops/gbnf.py's
dialect; the produced grammar drives the same per-slot constrained decoding
as a hand-written one.

Supported schema subset (the practically-used core of llama.cpp's own
converter):
- ``type``: object / array / string / number / integer / boolean / null,
  or a list of those (alternation)
- ``enum`` / ``const`` (literal JSON values)
- objects: ``properties`` (emitted in declaration order — required ones
  mandatory, optional ones as ordered optional tails), ``required``,
  ``additionalProperties`` (absent/false → closed object; true/schema →
  extra properties allowed after the declared ones)
- arrays: ``items``, ``minItems``/``maxItems`` (bounded counts unroll —
  our GBNF has no {n,m} repetition, matching older llama.cpp)
- ``anyOf`` / ``oneOf`` → alternation; single-element ``allOf`` inlined
- ``$ref`` to ``#/$defs/...`` or ``#/definitions/...``

Anything outside the subset raises ValueError — a silently-ignored
constraint would hand clients malformed "validated" output.
"""

from __future__ import annotations

import json
from typing import Any

MAX_UNROLL = 32  # bounded-count arrays unroll up to this many items

# shared terminal rules (emitted once, referenced by generated rules)
_PRIMITIVES = {
    # ONE optional whitespace char, like llama.cpp's SPACE_RULE (" "?):
    # an unbounded ws rule lets a model emit whitespace forever without the
    # constraint ever failing, burning the whole token budget
    "ws": 'ws ::= [ \\t\\n\\r]?',
    "string": ('string ::= "\\"" chartext "\\""\n'
               'chartext ::= char chartext | ""\n'
               'char ::= [^"\\\\\\x00-\\x1f] | "\\\\" escape\n'
               'escape ::= ["\\\\/bfnrt] | "u" hex hex hex hex\n'
               'hex ::= [0-9a-fA-F]'),
    "number": ('number ::= integer frac? exp?\n'
               'frac ::= "." [0-9]+\n'
               'exp ::= [eE] [-+]? [0-9]+'),
    "integer": 'integer ::= "-"? ("0" | [1-9] [0-9]*)',
    "boolean": 'boolean ::= "true" | "false"',
    "null": 'null ::= "null"',
}
# which primitive rules each one depends on
_PRIM_DEPS = {
    "string": (), "integer": (), "boolean": (), "null": (), "ws": (),
    "number": ("integer",),
}


def _quote(text: str) -> str:
    """A GBNF literal matching ``text`` exactly."""
    out = text.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
    return f'"{out}"'


def _literal(value: Any) -> str:
    """Grammar fragment matching one literal JSON value."""
    return _quote(json.dumps(value, ensure_ascii=True))


class _Converter:
    def __init__(self, schema: dict):
        self.root = schema
        self.rules: dict[str, str] = {}
        self.prims: set[str] = {"ws"}
        self.count = 0
        self.ref_cache: dict[str, str] = {}

    def fresh(self, hint: str) -> str:
        self.count += 1
        return f"{hint}{self.count}"

    def resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local $ref supported, got {ref!r}")
        node: Any = self.root
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"$ref {ref!r} does not resolve")
            node = node[part]
        if not isinstance(node, dict):
            raise ValueError(f"$ref {ref!r} is not a schema object")
        return node

    # ---- schema node → grammar EXPRESSION (may add helper rules) ----------

    def visit(self, schema: Any) -> str:
        if schema is True or schema == {}:
            return self.any_value()
        if not isinstance(schema, dict):
            raise ValueError(f"unsupported schema node {schema!r}")
        if "$ref" in schema:
            ref = schema["$ref"]
            if ref not in self.ref_cache:
                name = self.fresh("ref")
                self.ref_cache[ref] = name  # placeholder first: cycles OK
                self.rules[name] = self.visit(self.resolve_ref(ref))
            return self.ref_cache[ref]
        for key in ("anyOf", "oneOf"):
            if key in schema:
                alts = [self.visit(s) for s in schema[key]]
                return "(" + " | ".join(alts) + ")"
        if "allOf" in schema:
            if len(schema["allOf"]) != 1:
                raise ValueError("allOf with multiple schemas is unsupported")
            return self.visit(schema["allOf"][0])
        if "const" in schema:
            return _literal(schema["const"])
        if "enum" in schema:
            return "(" + " | ".join(_literal(v) for v in schema["enum"]) + ")"
        t = schema.get("type")
        if isinstance(t, list):
            return "(" + " | ".join(
                self.visit({**schema, "type": one}) for one in t) + ")"
        if t == "object" or (t is None and "properties" in schema):
            return self.object_rule(schema)
        if t == "array":
            return self.array_rule(schema)
        if t in ("string", "number", "integer", "boolean", "null"):
            self.use_prim(t)
            return t
        if t is None:
            return self.any_value()
        raise ValueError(f"unsupported schema type {t!r}")

    def use_prim(self, name: str) -> None:
        self.prims.add(name)
        for dep in _PRIM_DEPS[name]:
            self.use_prim(dep)

    def any_value(self) -> str:
        """Any JSON value (the json_mode grammar, as a rule)."""
        if "value" not in self.rules:
            for p in ("string", "number", "boolean", "null"):
                self.use_prim(p)
            self.rules["value"] = (
                'string | number | boolean | null | anyobj | anyarr')
            self.rules["anyobj"] = (
                '"{" ws ( string ws ":" ws value ( ws "," ws string ws ":" '
                'ws value )* )? ws "}"')
            self.rules["anyarr"] = (
                '"[" ws ( value ( ws "," ws value )* )? ws "]"')
        return "value"

    def object_rule(self, schema: dict) -> str:
        props: dict = schema.get("properties", {})
        required = set(schema.get("required", ()))
        unknown = required - set(props)
        if unknown:
            raise ValueError(f"required names missing from properties: "
                             f"{sorted(unknown)}")
        addl = schema.get("additionalProperties", False)
        if not props:
            if "additionalProperties" in schema and addl is False:
                # EXPLICITLY closed empty object
                return '"{" ws "}"'
            # bare {"type": "object"}: any object (JSON Schema semantics —
            # absent additionalProperties constrains nothing here)
            return self._generic_object(
                True if addl in (False, True, {}) else addl)
        if addl is not False:
            raise ValueError(
                "additionalProperties alongside declared properties is "
                "unsupported (declared-only objects are closed, like "
                "llama.cpp's converter)")
        # one kv rule per property, in declaration order (llama.cpp emits
        # properties in order: required ones mandatory, optional ones as
        # ordered optional tails)
        pairs = []
        for name, sub in props.items():
            expr = self.visit(sub)
            r = self.fresh("kv")
            self.rules[r] = f'{_quote(json.dumps(name))} ws ":" ws ({expr})'
            pairs.append((name in required, r))
        # alternation over which property appears FIRST (no leading comma);
        # everything after it hangs off as a comma-prefixed tail chain where
        # optional properties wrap their ", kv" in ( )?. A required property
        # cannot be skipped, so head choices stop at the first required one.
        heads = []
        for i, (req, r) in enumerate(pairs):
            heads.append(f'{r}{self._tail_chain(pairs[i + 1:])}')
            if req:
                break
        body = "( " + " | ".join(heads) + " )"
        if not any(req for req, _ in pairs):
            body += "?"
        return f'"{{" ws {body} ws "}}"'

    def _tail_chain(self, rest: list) -> str:
        """Flat optional tails: every later property carries ITS OWN
        comma-prefixed piece, optionals wrapped in ( )? independently — any
        subset of optionals composes (a nested form would only allow prefix
        subsets: {name, tags} with age skipped must parse)."""
        out = ""
        for req, r in rest:
            if req:
                out += f' ws "," ws {r}'
            else:
                out += f' ( ws "," ws {r} )?'
        return out

    def _generic_object(self, value_schema: Any) -> str:
        self.use_prim("string")
        v = self.visit(value_schema)
        r = self.fresh("obj")
        self.rules[r] = (f'"{{" ws ( string ws ":" ws ({v}) ( ws "," ws '
                         f'string ws ":" ws ({v}) )* )? ws "}}"')
        return r

    def array_rule(self, schema: dict) -> str:
        item = self.visit(schema.get("items", True))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is None:
            if lo == 0:
                return f'"[" ws ( ({item}) ( ws "," ws ({item}) )* )? ws "]"'
            if lo == 1:
                return f'"[" ws ({item}) ( ws "," ws ({item}) )* ws "]"'
            head = f'({item})' + f' ws "," ws ({item})' * (lo - 1)
            return f'"[" ws {head} ( ws "," ws ({item}) )* ws "]"'
        hi = int(hi)
        if hi < lo:
            raise ValueError(f"maxItems {hi} < minItems {lo}")
        if hi > MAX_UNROLL:
            raise ValueError(f"maxItems {hi} exceeds unroll bound "
                             f"{MAX_UNROLL} (bounded repetition unsupported)")
        alts = []
        for n in range(lo, hi + 1):
            if n == 0:
                alts.append('""')
            else:
                alts.append(f'({item})' + f' ws "," ws ({item})' * (n - 1))
        body = "( " + " | ".join(alts) + " )"
        return f'"[" ws {body} ws "]"'


def schema_to_gbnf(schema: dict | bool) -> str:
    """Convert a JSON schema (dict, or True for 'any value') to GBNF text
    whose root matches exactly one conforming JSON value."""
    if schema is False:
        raise ValueError("schema 'false' matches no value — nothing can be "
                         "generated under it")
    conv = _Converter(schema if isinstance(schema, dict) else {})
    expr = conv.visit(schema if isinstance(schema, dict) else True)
    lines = [f"root ::= ws {expr} ws"]
    for name, body in conv.rules.items():
        lines.append(f"{name} ::= {body}")
    for name in sorted(conv.prims):
        lines.append(_PRIMITIVES[name])
    return "\n".join(lines) + "\n"
