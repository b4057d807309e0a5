"""GBNF grammar engine: parser + incremental prefix acceptor.

llama.cpp's flagship constrained-decoding feature is GBNF (`--grammar`,
`grammars/*.gbnf`): a BNF dialect whose productions gate the sampler's
candidate list. This module is the port's copy of
``distributed_llm_pipeline_tpu/ops/gbnf.py``, its equivalent, with the same
validator protocol as ops/json_constraint.py so the engine's constrained
decode path drives either:

- ``parse_gbnf(text)`` → rule table. Supported syntax: ``name ::= ...``,
  quoted literals with escapes, char classes ``[a-z0-9]`` / negated
  ``[^...]``, grouping ``( )``, alternation ``|``, repetition ``? * +``,
  rule references, ``#`` comments. (Bounded repetition ``{n,m}`` — a late
  llama.cpp addition — is not supported.)
- ``GrammarValidator(rules)`` — the acceptor llama.cpp implements as parse
  STACKS: a set of element stacks tracks every live derivation; feeding a
  character advances each stack whose top terminal matches, with rule
  references epsilon-expanded so stack tops are always terminals. A text is
  a valid prefix while any stack survives; the grammar is satisfied when an
  empty stack exists.
"""

from __future__ import annotations

from functools import lru_cache

# element kinds -------------------------------------------------------------
# ("char", ((lo, hi), ...), negated)  — terminal: char-code ranges
# ("ref", rule_name)                  — nonterminal reference

MAX_STACKS = 2048  # runaway-ambiguity bound; beyond this the text is rejected


class GBNFError(ValueError):
    pass


# ---------------------------------------------------------------------------
# parser


def parse_gbnf(text: str) -> dict[str, list[list[tuple]]]:
    """GBNF source → {rule: [alternate, ...]} where an alternate is a list of
    elements. Repetitions desugar into generated helper rules (as llama.cpp
    does): ``x*`` → ``R ::= x R | ε``."""
    rules: dict[str, list[list[tuple]]] = {}
    gen_count = [0]

    src = _strip_comments(text)
    pos = [0]

    def peek():
        return src[pos[0]] if pos[0] < len(src) else ""

    def skip_ws(newlines: bool):
        while pos[0] < len(src) and (src[pos[0]] in " \t"
                                     or (newlines and src[pos[0]] in "\r\n")):
            pos[0] += 1

    def read_name():
        start = pos[0]
        while pos[0] < len(src) and (src[pos[0]].isalnum() or src[pos[0]] in "-_"):
            pos[0] += 1
        if pos[0] == start:
            raise GBNFError(f"expected rule name at {src[start:start+20]!r}")
        return src[start:pos[0]]

    def read_char_escape() -> int:
        ch = peek()
        if ch == "":
            raise GBNFError("unexpected end of grammar")
        pos[0] += 1
        if ch != "\\":
            return ord(ch)
        esc = peek()
        if esc == "":
            raise GBNFError("unexpected end of grammar after backslash")
        pos[0] += 1
        table = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "'": 39,
                 "[": 91, "]": 93, "^": 94, "-": 45}
        if esc in table:
            return table[esc]
        if esc in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[esc]
            hexs = src[pos[0]: pos[0] + n]
            try:
                code = int(hexs, 16)
            except ValueError:
                raise GBNFError(f"bad \\{esc} escape {hexs!r}") from None
            if len(hexs) != n:
                raise GBNFError(f"bad \\{esc} escape")
            pos[0] += n
            return code
        raise GBNFError(f"unknown escape \\{esc}")

    def repeat(rule_name: str, unit: list[tuple], op: str) -> tuple:
        """Desugar a repetition of a whole SYMBOL (element sequence) into a
        generated rule — llama.cpp repeats the full last symbol (e.g. the
        entire quoted literal), not just its final character."""
        rname = f"{rule_name}__r{gen_count[0]}"
        gen_count[0] += 1
        if op == "?":
            rules[rname] = [list(unit), []]
        elif op == "*":
            rules[rname] = [list(unit) + [("ref", rname)], []]
        else:  # +
            rules[rname] = [list(unit) + [("ref", rname)], list(unit)]
        return ("ref", rname)

    def parse_sequence(rule_name: str, nested: bool) -> list[list[tuple]]:
        """ONE alternate's element list. ``nested`` (inside parentheses)
        allows newlines between symbols, as llama.cpp does — its shipped
        multi-line grammars (json.gbnf) depend on it."""
        seq: list[tuple] = []
        while True:
            skip_ws(nested)
            ch = peek()
            if ch == "" or ch in "|)" or (not nested and ch in "\r\n"):
                break
            last_start = len(seq)  # repetition applies to the WHOLE symbol
            if ch == '"':
                pos[0] += 1
                while peek() != '"':
                    if peek() == "":
                        raise GBNFError("unterminated literal")
                    c = read_char_escape()
                    seq.append(("char", ((c, c),), False))
                pos[0] += 1
            elif ch == "[":
                pos[0] += 1
                negated = peek() == "^"
                if negated:
                    pos[0] += 1
                ranges = []
                while peek() != "]":
                    if peek() == "":
                        raise GBNFError("unterminated char class")
                    lo = read_char_escape()
                    hi = lo
                    if peek() == "-" and src[pos[0] + 1: pos[0] + 2] != "]":
                        pos[0] += 1
                        hi = read_char_escape()
                    ranges.append((lo, hi))
                pos[0] += 1
                seq.append(("char", tuple(ranges), negated))
            elif ch == "(":
                pos[0] += 1
                sub = parse_alternates(rule_name, nested=True)
                skip_ws(True)
                if peek() != ")":
                    raise GBNFError("expected ')'")
                pos[0] += 1
                gname = f"{rule_name}__g{gen_count[0]}"
                gen_count[0] += 1
                rules[gname] = sub
                seq.append(("ref", gname))
            else:
                seq.append(("ref", read_name()))
            if peek() in "?*+" and len(seq) > last_start:
                op = peek()
                pos[0] += 1
                unit = seq[last_start:]
                del seq[last_start:]
                seq.append(repeat(rule_name, unit, op))
        return seq

    def parse_alternates(rule_name: str, nested: bool) -> list[list[tuple]]:
        alts = [parse_sequence(rule_name, nested)]
        while True:
            skip_ws(nested)
            if peek() == "|":
                pos[0] += 1
                skip_ws(True)  # a newline may follow '|' even at top level
                alts.append(parse_sequence(rule_name, nested))
            else:
                return alts

    while True:
        skip_ws(True)
        if pos[0] >= len(src):
            break
        name = read_name()
        skip_ws(False)
        if src[pos[0]: pos[0] + 3] != "::=":
            raise GBNFError(f"expected '::=' after rule {name!r}")
        pos[0] += 3
        skip_ws(True)  # the body may start on the next line (json.gbnf style)
        rules[name] = parse_alternates(name, nested=False)

    if "root" not in rules:
        raise GBNFError("grammar must define a 'root' rule")
    for alts in list(rules.values()):
        for alt in alts:
            for el in alt:
                if el[0] == "ref" and el[1] not in rules:
                    raise GBNFError(f"undefined rule {el[1]!r}")
    return rules


def _strip_comments(text: str) -> str:
    out = []
    for line in text.split("\n"):
        in_str = False
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"':
                # escaped only when preceded by an ODD number of backslashes
                # ('"\\\\"' ends the literal: the backslashes escape each other)
                j = i - 1
                n = 0
                while j >= 0 and line[j] == "\\":
                    n += 1
                    j -= 1
                if n % 2 == 0:
                    in_str = not in_str
            if c == "#" and not in_str:
                line = line[:i]
                break
            i += 1
        out.append(line)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# acceptor


class GrammarValidator:
    """Incremental prefix acceptor over parsed GBNF rules — the same
    feed/copy/complete/in_string protocol as JsonPrefixValidator, so the
    engine's constrained decode path uses either interchangeably."""

    __slots__ = ("rules", "stacks", "complete", "dead")

    def __init__(self, rules: dict[str, list[list[tuple]]],
                 _stacks: frozenset | None = None):
        self.rules = rules
        if _stacks is None:
            init = self._expand((("ref", "root"),))
            self.stacks = init
        else:
            self.stacks = _stacks
        self.complete = any(len(s) == 0 for s in self.stacks)
        self.dead = not self.stacks

    def copy(self) -> "GrammarValidator":
        c = GrammarValidator.__new__(GrammarValidator)
        c.rules = self.rules
        c.stacks = self.stacks
        c.complete = self.complete
        c.dead = self.dead
        return c

    def feed(self, text: str) -> bool:
        if self.dead:
            return False
        stacks = self.stacks
        for ch in text:
            code = ord(ch)
            nxt = set()
            for st in stacks:
                if not st:
                    continue  # completed derivation consumes nothing more
                kind, ranges, neg = st[0]
                if _match(code, ranges, neg):
                    for e in self._expand(st[1:]):
                        nxt.add(e)
                        if len(nxt) > MAX_STACKS:
                            self.dead = True
                            self.stacks = frozenset()
                            return False
            if not nxt:
                self.dead = True
                self.stacks = frozenset()
                return False
            stacks = frozenset(nxt)
        self.stacks = stacks
        self.complete = any(len(s) == 0 for s in stacks)
        return True

    @property
    def in_string(self) -> bool:
        """Partial-multibyte admission policy (the generic analogue of JSON's
        inside-a-string test): True when some live stack's next terminal
        accepts a char ≥ U+0080, i.e. a dangling UTF-8 lead byte could still
        complete into an acceptable character."""
        for st in self.stacks:
            if st:
                kind, ranges, neg = st[0]
                if _accepts_above_ascii(ranges, neg):
                    return True
        return False

    # -- internals ----------------------------------------------------------

    def _expand(self, stack: tuple) -> frozenset:
        """Epsilon-expand rule references until every stack top is a terminal
        (or the stack is empty). Returns the set of normalized stacks."""
        rules = self.rules
        out: set = set()
        work = [tuple(stack)]
        seen = set()
        while work:
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st or st[0][0] == "char":
                out.add(st)
                continue
            _, name = st[0]
            for alt in rules[name]:
                work.append(tuple(alt) + st[1:])
            if len(seen) > 4 * MAX_STACKS:
                raise GBNFError("grammar expansion explodes (left recursion?)")
        return frozenset(out)


def _match(code: int, ranges: tuple, neg: bool) -> bool:
    hit = any(lo <= code <= hi for lo, hi in ranges)
    return hit != neg


def _accepts_above_ascii(ranges: tuple, neg: bool) -> bool:
    if not neg:
        return any(hi >= 0x80 for _, hi in ranges)
    # negated class: accepts everything outside the ranges — some char
    # ≥ 0x80 is outside unless the ranges cover [0x80, 0x10FFFF] entirely
    covered = sorted((max(lo, 0x80), hi) for lo, hi in ranges if hi >= 0x80)
    need = 0x80
    for lo, hi in covered:
        if lo > need:
            return True
        need = max(need, hi + 1)
    return need <= 0x10FFFF


@lru_cache(maxsize=32)
def compile_grammar(text: str) -> dict:
    """Parse AND construct a validator once per distinct grammar text: the
    construction epsilon-expands the root, so left-recursive grammars (which
    parse fine but explode at decode time) fail here — callers validating a
    request can map the GBNFError to a clean client error."""
    rules = parse_gbnf(text)
    GrammarValidator(rules)  # raises GBNFError on expansion explosion
    return rules
