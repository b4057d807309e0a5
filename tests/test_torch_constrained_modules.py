"""The port's copies of the pure-Python constraint modules against the JAX
package's originals, on the reference's own cases (``tests/test_gbnf.py``,
``tests/test_json_constraint.py``, ``tests/test_json_schema.py``): the
GBNF parser and acceptor, the JSON prefix acceptor and the JSON-schema →
GBNF converter give the same rule tables, the same schema grammars (text
for text), the same errors, and the same verdict, ``complete`` and
``in_string`` after every character of every string."""

import json
import random

import pytest

from distributed_llm_pipeline_tpu.ops import gbnf as jax_gbnf
from distributed_llm_pipeline_tpu.ops import json_constraint as jax_jc
from distributed_llm_pipeline_tpu.ops import json_schema as jax_js
from distributed_llm_pipeline_tpu_torch.ops import gbnf, json_constraint, json_schema

LIST_GRAMMAR = r'''
# a bullet list of one or more lowercase items
root  ::= item+
item  ::= "- " word "\n"
word  ::= [a-z]+
'''

EXPR = r'''
root ::= expr
expr ::= term (("+" | "-") term)*
term ::= num | "(" expr ")"
num  ::= [0-9]+
'''

# (grammar, texts) of tests/test_gbnf.py
GBNF_CASES = {
    "list": (LIST_GRAMMAR, ["- abc\n", "- abc\n- de\n", "- ab", "* ab", "- Abc\n"]),
    "expr": (EXPR, ["1", "12+3", "(1+2)-3", "((1))", "1+2+3-4", "+1", "1+", "(1",
                    "()", "1++2", "(1+2"]),
    "char_class": (r'root ::= [^a-c"] [\x41-\x43] [-x]', ["dB-", "aBx", "dBx"]),
    "escapes_unicode": ('root ::= "a\\nb" [à-ÿ]', ["a\nbé", "a\nbz"]),
    "optional_plus": (r'root ::= "a"? "b"+', ["b", "abbb", "aab"]),
    "ascii_only": (r'root ::= [a-z]+', ["abc", "aé"]),
    "wide_class": ('root ::= [ -￿]', ["é", "x"]),
    "negated_ascii": (r'root ::= [^a-z]', ["é", "a"]),
    "trailing": (r'root ::= "ab"', ["ab", "abc"]),
    "yes_no": ('root ::= "yes" | "no"', ["yes", "no", "ye", "nope"]),
    "top_missing": ('top ::= "x"', []),
    "undefined": ('root ::= missing', []),
    "no_assign": ('root "x"', []),
}


def _walk(v, text):
    """The verdict, ``complete`` and ``in_string`` after each character."""
    out = [(True, v.complete, v.in_string)]
    for ch in text:
        out.append((v.feed(ch), v.complete, v.in_string))
    return out


def _parse(mod, text):
    try:
        return "ok", mod.parse_gbnf(text)
    except mod.GBNFError as e:
        return "error", str(e)


@pytest.mark.parametrize("name", sorted(GBNF_CASES))
def test_gbnf_matches_reference(name):
    text, strings = GBNF_CASES[name]
    got, want = _parse(gbnf, text), _parse(jax_gbnf, text)
    assert got == want
    if got[0] == "error":
        return
    for s in strings:
        assert _walk(gbnf.GrammarValidator(got[1]), s) == \
            _walk(jax_gbnf.GrammarValidator(want[1]), s), s
    # compile_grammar caches; a copy advances on its own, as the
    # sampler's probes need
    rules = gbnf.compile_grammar(text)
    assert gbnf.compile_grammar(text) is rules
    if strings:
        v = gbnf.GrammarValidator(rules)
        c = v.copy()
        v.feed(strings[0])
        assert _walk(c, strings[-1]) == _walk(jax_gbnf.GrammarValidator(want[1]),
                                              strings[-1])


VALID = [
    '{"a": 1, "b": [true, false, null], "c": {"d": "e\\nf"}}',
    '[1, -2.5, 3e10, 0.1e-2, "x", {}]',
    '"hello \\u00e9 world"',
    'true', 'false', 'null', '0', '-0.5', '42', '[[[]]]',
    '{"k": "v with \\"quotes\\" and \\\\"}',
    '  [ 1 , 2 ]  ',
    '{}', '[]', '{"a":{}}',
]
INVALID = [
    '{a: 1}', "{'a': 1}", '[1,]', '{"a":}', '{"a" 1}', '01', '+1', '1.',
    '.5', '[1 2]', 'truth', 'nul!', '{"a": 1,}', ']', '}', '{"a"}',
    '"unterminated\n"', '1e', '--1', '{"a": 1} extra',
]


def _fuzz_docs(n: int) -> list[str]:
    """tests/test_json_constraint.py's random documents (its seed)."""
    rng = random.Random(7)

    def gen(depth=0):
        kind = rng.choice("onbsa" if depth < 3 else "nbs")
        if kind == "o":
            return {f"k{rng.randint(0, 9)}": gen(depth + 1)
                    for _ in range(rng.randint(0, 3))}
        if kind == "a":
            return [gen(depth + 1) for _ in range(rng.randint(0, 3))]
        if kind == "n":
            return rng.choice([0, -1, 3.5, 2e-3, 123456])
        if kind == "b":
            return rng.choice([True, False, None])
        return rng.choice(["", "x", 'quote"inside', "unié", "tab\tchar"])

    return [json.dumps(gen()) for _ in range(n)]


JSON_TEXTS = VALID + INVALID + _fuzz_docs(12) + ['{"a"x', '{"a": 1}x', "é", '"é']


@pytest.mark.parametrize("text", JSON_TEXTS)
def test_json_acceptor_matches_reference(text):
    assert _walk(json_constraint.JsonPrefixValidator(), text) == \
        _walk(jax_jc.JsonPrefixValidator(), text)
    assert json_constraint.prefix_ok(text) == jax_jc.prefix_ok(text)
    assert json_constraint.is_complete(text) == jax_jc.is_complete(text)


OBJ = {"type": "object",
       "properties": {"name": {"type": "string"},
                      "age": {"type": "integer"},
                      "tags": {"type": "array", "items": {"type": "string"}}},
       "required": ["name"]}
PTS = {"$defs": {"pt": {"type": "object",
                        "properties": {"x": {"type": "number"},
                                       "y": {"type": "number"}},
                        "required": ["x", "y"]}},
       "type": "array", "items": {"$ref": "#/$defs/pt"},
       "minItems": 1, "maxItems": 2}
# name → (schema, values) of tests/test_json_schema.py; a schema the
# converter refuses has no values
SCHEMA_CASES = {
    "object": (OBJ, [{"name": "ada"}, {"name": "ada", "age": 36},
                     {"name": "ada", "age": 36, "tags": ["x", "y"]},
                     {"name": "ada", "tags": []}, {"age": 36},
                     {"name": "ada", "age": "x"}, {"name": "ada", "extra": 1}]),
    "nested_refs": (PTS, [[{"x": 1, "y": -2.5}], [{"x": 1, "y": 2}, {"x": 0, "y": 0}],
                          [], [{"x": 1}], [{"x": 1, "y": 2}] * 3]),
    "enum": ({"enum": ["a", 1, None]}, [1, 2, "a", None]),
    "const": ({"const": {"k": [1]}}, [{"k": [1]}, {"k": [2]}]),
    "any_of": ({"anyOf": [{"type": "integer"}, {"type": "null"}]}, [None, 3, "x"]),
    "type_list": ({"type": ["string", "boolean"]}, [True, "s", 1]),
    "any": (True, [{"whatever": [1, "x", {"y": None}]}]),
    "engine_n": ({"type": "object", "properties": {"n": {"type": "integer"}},
                  "required": ["n"]}, [{"n": 3}, {"n": 1.5}]),
    "additional_true": ({"type": "object", "properties": {"a": True},
                         "additionalProperties": True}, []),
    "unroll": ({"type": "array", "maxItems": 1000}, []),
    "remote_ref": ({"$ref": "http://elsewhere"}, []),
}


def _convert(mod, schema):
    try:
        return "ok", mod.schema_to_gbnf(schema)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("name", sorted(SCHEMA_CASES))
def test_json_schema_matches_reference(name):
    schema, values = SCHEMA_CASES[name]
    got, want = _convert(json_schema, schema), _convert(jax_js, schema)
    assert got == want
    if got[0] == "error":
        return
    for value in values:
        text = json.dumps(value)
        assert _walk(gbnf.GrammarValidator(gbnf.compile_grammar(got[1])), text) == \
            _walk(jax_gbnf.GrammarValidator(jax_gbnf.compile_grammar(want[1])), text)
