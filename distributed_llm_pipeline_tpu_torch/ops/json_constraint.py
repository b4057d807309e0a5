"""Incremental JSON-prefix validation for constrained decoding.

llama.cpp constrains generation with GBNF grammars applied to the sampler's
candidate list (its shipped ``json.gbnf`` being the headline use); this module
is the port's copy of ``distributed_llm_pipeline_tpu/ops/json_constraint.py``,
the counterpart for the JSON case: a pushdown acceptor that
answers, in O(new characters), whether a text is a valid PREFIX of a JSON
value, and whether it is a COMPLETE value.

The engine's constrained decode path (runtime/engine.py) reads the top-k
candidate tokens back each step, keeps those whose decoded text extends a
valid prefix, renormalizes, and samples — exactly llama.cpp's
candidates-then-grammar ordering.

The acceptor is deliberately strict-JSON (RFC 8259): no comments, no trailing
commas, double-quoted keys. Leading whitespace is allowed; trailing content
after the closing value ends the match (``complete`` becomes True and any
non-whitespace afterwards is invalid).
"""

from __future__ import annotations

WS = " \t\n\r"
DIGITS = "0123456789"


class JsonPrefixValidator:
    """Character-incremental acceptor for prefixes of one JSON value.

    ``feed(text)`` consumes characters and returns False as soon as the
    accumulated text cannot be extended into valid JSON (the instance is then
    dead). ``copy()`` is O(stack) — the engine probes candidate tokens on
    copies. ``complete`` is True once exactly one whole value has closed.
    """

    __slots__ = ("stack", "state", "complete", "dead")

    # states: "value"  — expecting a value
    #         "string" — inside a string       "escape" — after backslash
    #         "u0".."u3" — unicode escape hex digits remaining
    #         "num:<part>" — inside a number; part ∈ int, frac, exp, ...
    #         "lit:<rest>" — inside true/false/null, rest = chars still due
    #         "post"   — a value just closed (container punctuation next)
    #         "key"    — object expecting a key string or '}'
    #         "colon"  — object expecting ':'
    # stack entries: "obj" / "arr" (open containers); "key?" marks that the
    # enclosing obj just opened (so '}' is allowed before any key)

    def __init__(self):
        self.stack: list[str] = []
        self.state = "value"
        self.complete = False
        self.dead = False

    def copy(self) -> "JsonPrefixValidator":
        c = JsonPrefixValidator.__new__(JsonPrefixValidator)
        c.stack = self.stack.copy()
        c.state = self.state
        c.complete = self.complete
        c.dead = self.dead
        return c

    def feed(self, text: str) -> bool:
        if self.dead:
            return False
        for ch in text:
            if not self._step(ch):
                self.dead = True
                return False
        return True

    # -- single-character transition ----------------------------------------

    def _step(self, ch: str) -> bool:
        s = self.state
        if s == "string" or s == "keystr":
            if ch == '"':
                self.state = "colon" if s == "keystr" else "post"
                if self.state == "post":
                    self._maybe_done()
            elif ch == "\\":
                self.state = "escape" if s == "string" else "kescape"
            elif ch < " ":  # RFC 8259: raw U+0000..U+001F invalid in strings
                return False
            return True
        if s == "escape" or s == "kescape":
            back = "string" if s == "escape" else "keystr"
            if ch in '"\\/bfnrt':
                self.state = back
                return True
            if ch == "u":
                self.state = ("u3" if back == "string" else "ku3")
                return True
            return False
        if s.startswith("u") or s.startswith("ku"):
            if ch not in "0123456789abcdefABCDEF":
                return False
            n = int(s.lstrip("ku"))
            if n == 0:
                self.state = "string" if s[0] == "u" else "keystr"
            else:
                self.state = ("u" if s[0] == "u" else "ku") + str(n - 1)
            return True
        if s.startswith("lit:"):
            rest = s[4:]
            if not rest or ch != rest[0]:
                return False
            self.state = f"lit:{rest[1:]}" if len(rest) > 1 else "post"
            if self.state == "post":
                self._maybe_done()
            return True
        if s.startswith("num:"):
            return self._num(ch, s[4:])
        if s == "value":
            if ch in WS:
                return True
            return self._open_value(ch)
        if s == "key":
            if ch in WS:
                return True
            if ch == '"':
                self.state = "keystr"
                return True
            if ch == "}" and self.stack and self.stack[-1] == "obj0":
                self.stack.pop()
                self.state = "post"
                self._maybe_done()
                return True
            return False
        if s == "colon":
            if ch in WS:
                return True
            if ch == ":":
                self.state = "value"
                return True
            return False
        if s == "post":
            return self._post(ch)
        return False

    def _open_value(self, ch: str) -> bool:
        if ch == "{":
            self.stack.append("obj0")
            self.state = "key"
            return True
        if ch == "[":
            self.stack.append("arr0")  # arr0: ']' may close it with no items
            self.state = "value"
            return True
        if ch == "]":
            # only legal immediately after '[' (empty array)
            if self.stack and self.stack[-1] == "arr0":
                self.stack.pop()
                self.state = "post"
                self._maybe_done()
                return True
            return False
        if ch == '"':
            self.state = "string"
            return True
        if ch == "-":
            self.state = "num:-"
            return True
        if ch in DIGITS:
            self.state = "num:0" if ch == "0" else "num:int"
            return True
        for lit in ("true", "false", "null"):
            if ch == lit[0]:
                self.state = f"lit:{lit[1:]}"
                return True
        return False

    def _num(self, ch: str, part: str) -> bool:
        # parts: '-' (just a sign), '0' (leading zero), 'int', '.', 'frac',
        # 'e', 'e+', 'exp'
        if part == "-":
            if ch == "0":
                self.state = "num:0"
                return True
            if ch in "123456789":
                self.state = "num:int"
                return True
            return False
        if part in ("0", "int"):
            if part == "int" and ch in DIGITS:
                return True
            if ch == ".":
                self.state = "num:."
                return True
            if ch in "eE":
                self.state = "num:e"
                return True
            return self._end_number(ch)
        if part == ".":
            if ch in DIGITS:
                self.state = "num:frac"
                return True
            return False
        if part == "frac":
            if ch in DIGITS:
                return True
            if ch in "eE":
                self.state = "num:e"
                return True
            return self._end_number(ch)
        if part == "e":
            if ch in "+-":
                self.state = "num:e+"
                return True
            if ch in DIGITS:
                self.state = "num:exp"
                return True
            return False
        if part == "e+":
            if ch in DIGITS:
                self.state = "num:exp"
                return True
            return False
        if part == "exp":
            if ch in DIGITS:
                return True
            return self._end_number(ch)
        return False

    def _end_number(self, ch: str) -> bool:
        """A number has no terminator: it ends at the first non-number char,
        which must itself be valid in the 'post' state."""
        self.state = "post"
        self._maybe_done()
        return self._post(ch)

    def _post(self, ch: str) -> bool:
        if ch in WS:
            return True
        if not self.stack:
            return False  # trailing content after the closed top-level value
        top = self.stack[-1]
        if top.startswith("arr"):
            if ch == ",":
                self.stack[-1] = "arr"
                self.state = "value"
                return True
            if ch == "]":
                self.stack.pop()
                self.state = "post"
                self._maybe_done()
                return True
            return False
        if top.startswith("obj"):
            if ch == ",":
                self.stack[-1] = "obj"
                self.state = "key"
                return True
            if ch == "}":
                self.stack.pop()
                self.state = "post"
                self._maybe_done()
                return True
            return False
        return False

    def _maybe_done(self) -> None:
        if not self.stack and self.state == "post":
            self.complete = True

    # -- whole-value classification -----------------------------------------

    @property
    def in_string(self) -> bool:
        """True inside string content — the only place where an arbitrary
        (e.g. non-ASCII multibyte) character is guaranteed acceptable, so
        partial UTF-8 token bytes may be admitted on faith there."""
        return self.state in ("string", "keystr")


def prefix_ok(text: str) -> bool:
    """Convenience: is ``text`` a valid prefix of a JSON value?"""
    v = JsonPrefixValidator()
    return v.feed(text)


def is_complete(text: str) -> bool:
    v = JsonPrefixValidator()
    return v.feed(text) and (v.complete or _number_at_eof(v))


def _number_at_eof(v: JsonPrefixValidator) -> bool:
    """A bare top-level number is complete at end-of-input even though no
    terminator character ever arrived (e.g. the text "42")."""
    return (not v.stack and v.state.startswith("num:")
            and v.state[4:] in ("0", "int", "frac", "exp"))
