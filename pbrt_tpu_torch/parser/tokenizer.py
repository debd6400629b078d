"""pbrt scene-file tokenizer (port of pbrt_tpu.parser.tokenizer, whole;
reference: src/core/parser.{h,cpp} Tokenizer).

The reference mmaps the file and scans bytes; here a single compiled regex
produces the token stream (quoted strings, brackets, atoms, with # comments
skipped), which is plenty fast for multi-MB geometry files.
"""

from __future__ import annotations

import re

_TOKEN_RE = re.compile(
    r'"(?:[^"\\]|\\.)*"'       # quoted string
    r'|#[^\n]*'                # comment
    r'|\[|\]'                  # brackets
    r'|[^\s"#\[\]]+'           # bare atom
)


def tokenize(text):
    """Yield tokens; quoted strings keep their quotes."""
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        if tok.startswith("#"):
            continue
        yield tok


def tokenize_file(path):
    with open(path, "r", errors="replace") as f:
        return tokenize(f.read())


class TokenStream:
    """Pushback-capable stream over (possibly nested via Include) files."""

    def __init__(self, tokens, path=""):
        self._stack = [iter(tokens)]
        self._pushback = []
        self.path = path

    def include(self, tokens):
        self._stack.append(iter(tokens))

    def next(self):
        if self._pushback:
            return self._pushback.pop()
        while self._stack:
            try:
                return next(self._stack[-1])
            except StopIteration:
                self._stack.pop()
        return None

    def push(self, tok):
        self._pushback.append(tok)

    def peek(self):
        t = self.next()
        if t is not None:
            self.push(t)
        return t


def unquote(tok):
    return tok[1:-1] if tok and tok.startswith('"') else tok


def is_quoted(tok):
    return tok is not None and tok.startswith('"')
