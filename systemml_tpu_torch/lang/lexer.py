# Copy of systemml_tpu/lang/lexer.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""DML lexer.

Token surface per the reference grammar (parser/dml/Dml.g4:182-219):
identifiers with optional `ns::` prefix and a closed set of dotted names
(as.scalar, lower.tri, ...), INT/DOUBLE with optional exponent and trailing
L, single/double-quoted strings with escapes, `$name`/`$1` command-line ids,
`#` line and `/* */` block comments, and the operator set including
`%*% %/% %% <- += && ||`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from systemml_tpu_torch.lang.ast import SourcePos


class DMLSyntaxError(Exception):
    def __init__(self, msg: str, pos: Optional[SourcePos] = None, source_name: str = "<script>"):
        self.pos = pos
        self.source_name = source_name
        loc = f" at {pos}" if pos else ""
        super().__init__(f"{source_name}{loc}: {msg}")


# token kinds
ID = "ID"
INT = "INT"
DOUBLE = "DOUBLE"
STRING = "STRING"
CLARG = "CLARG"  # $name / $1
OP = "OP"
KEYWORD = "KEYWORD"
EOF = "EOF"

KEYWORDS = {
    "if", "else", "while", "for", "parfor", "function", "return",
    "source", "setwd", "in", "as", "externalFunction", "implemented", "ifdef",
    "TRUE", "FALSE",
}

# dotted identifiers admitted verbatim (Dml.g4:185-186)
DOTTED_IDS = {
    "as.scalar", "as.matrix", "as.frame", "as.double", "as.integer",
    "as.logical", "index.return", "empty.return", "lower.tail",
    "lower.tri", "upper.tri",
}
_DOTTED_PREFIXES = {name.split(".")[0] for name in DOTTED_IDS}

# multi-char operators first (maximal munch)
OPERATORS = [
    "%*%", "%/%", "%%",
    "<-", "<=", ">=", "==", "!=", "&&", "||", "+=",
    "^", "*", "/", "+", "-", "<", ">", "!", "&", "|",
    "(", ")", "[", "]", "{", "}", ",", ";", ":", "=",
]

_ESCAPES = {"b": "\b", "t": "\t", "n": "\n", "f": "\f", "r": "\r",
            '"': '"', "'": "'", "\\": "\\"}


@dataclass
class Token:
    kind: str
    text: str
    pos: SourcePos
    value: object = None  # parsed value for INT/DOUBLE/STRING
    # True when a newline separates this token from the previous one. Used to
    # disambiguate `x = y` + newline + `[a,b] = f()` from indexing `y[a,b]`
    # (the reference resolves this via ANTLR full-context prediction).
    nl_before: bool = False

    def __repr__(self):
        return f"{self.kind}({self.text!r})"


class Lexer:
    def __init__(self, source: str, source_name: str = "<script>"):
        self.src = source
        self.name = source_name
        self.i = 0
        self.line = 1
        self.col = 1

    def _pos(self) -> SourcePos:
        return SourcePos(self.line, self.col)

    def _advance(self, n: int = 1):
        for _ in range(n):
            if self.i < len(self.src):
                if self.src[self.i] == "\n":
                    self.line += 1
                    self.col = 1
                else:
                    self.col += 1
                self.i += 1

    def _peek(self, off: int = 0) -> str:
        j = self.i + off
        return self.src[j] if j < len(self.src) else ""

    def tokens(self) -> List[Token]:
        out: List[Token] = []
        while True:
            tok = self._next()
            out.append(tok)
            if tok.kind == EOF:
                return out

    def _next(self) -> Token:
        nl = self._skip_ws_and_comments()
        if self.i >= len(self.src):
            return Token(EOF, "", self._pos(), nl_before=nl)
        c = self._peek()
        if c == '"' or c == "'":
            tok = self._string(c)
        elif c.isdigit() or (c == "." and self._peek(1).isdigit()):
            tok = self._number()
        elif c == "$":
            tok = self._clarg()
        elif c.isalpha():
            tok = self._identifier()
        else:
            tok = self._operator()
        tok.nl_before = nl
        return tok

    def _skip_ws_and_comments(self) -> bool:
        saw_nl = False
        while self.i < len(self.src):
            c = self._peek()
            if c in " \t\r\n":
                saw_nl = saw_nl or c == "\n"
                self._advance()
            elif c == "#":
                saw_nl = True  # line comment runs to end of line
                while self.i < len(self.src) and self._peek() != "\n":
                    self._advance()
            elif c == "/" and self._peek(1) == "*":
                pos = self._pos()
                self._advance(2)
                while self.i < len(self.src) and not (self._peek() == "*" and self._peek(1) == "/"):
                    saw_nl = saw_nl or self._peek() == "\n"
                    self._advance()
                if self.i >= len(self.src):
                    raise DMLSyntaxError("unterminated block comment", pos, self.name)
                self._advance(2)
            else:
                return saw_nl
        return saw_nl

    def _string(self, quote: str) -> Token:
        pos = self._pos()
        self._advance()
        chars = []
        while True:
            if self.i >= len(self.src):
                raise DMLSyntaxError("unterminated string literal", pos, self.name)
            c = self._peek()
            if c == "\\":
                esc = self._peek(1)
                if esc in _ESCAPES:
                    chars.append(_ESCAPES[esc])
                    self._advance(2)
                else:
                    chars.append(c)
                    self._advance()
            elif c == quote:
                self._advance()
                text = "".join(chars)
                return Token(STRING, text, pos, text)
            else:
                chars.append(c)
                self._advance()

    def _number(self) -> Token:
        pos = self._pos()
        start = self.i
        is_double = False
        while self._peek().isdigit():
            self._advance()
        if self._peek() == "." and self._peek(1) != ".":
            # avoid swallowing a dotted-id boundary; DML has no '..' though
            is_double = True
            self._advance()
            while self._peek().isdigit():
                self._advance()
        if self._peek() in "eE" and (self._peek(1).isdigit() or
                                     (self._peek(1) in "+-" and self._peek(2).isdigit())):
            is_double = True
            self._advance()
            if self._peek() in "+-":
                self._advance()
            while self._peek().isdigit():
                self._advance()
        text = self.src[start:self.i]
        if self._peek() in "lL":  # INT/DOUBLE trailing L (Dml.g4:201,203)
            self._advance()
        if is_double:
            return Token(DOUBLE, text, pos, float(text))
        return Token(INT, text, pos, int(text))

    def _clarg(self) -> Token:
        pos = self._pos()
        self._advance()
        start = self.i
        if self._peek().isdigit():
            while self._peek().isdigit():
                self._advance()
        elif self._peek().isalpha():
            while self._peek().isalnum() or self._peek() == "_":
                self._advance()
        else:
            raise DMLSyntaxError("invalid command-line parameter after '$'", pos, self.name)
        return Token(CLARG, self.src[start:self.i], pos)

    def _ident_part(self) -> str:
        start = self.i
        while self._peek().isalnum() or self._peek() == "_":
            self._advance()
        return self.src[start:self.i]

    def _identifier(self) -> Token:
        pos = self._pos()
        text = self._ident_part()
        # namespace-qualified id: ns::name is ONE token (Dml.g4:182)
        if self._peek() == ":" and self._peek(1) == ":":
            self._advance(2)
            if not self._peek().isalpha():
                raise DMLSyntaxError("expected identifier after '::'", pos, self.name)
            text = text + "::" + self._ident_part()
            return Token(ID, text, pos)
        # closed set of dotted ids (as.scalar etc., Dml.g4:185-186)
        if self._peek() == "." and text in _DOTTED_PREFIXES and self._peek(1).isalpha():
            save_i, save_line, save_col = self.i, self.line, self.col
            self._advance()
            dotted = text + "." + self._ident_part()
            if dotted in DOTTED_IDS:
                return Token(ID, dotted, pos)
            self.i, self.line, self.col = save_i, save_line, save_col
        if text in KEYWORDS:
            return Token(KEYWORD, text, pos)
        return Token(ID, text, pos)

    def _operator(self) -> Token:
        pos = self._pos()
        rest = self.src[self.i:self.i + 3]
        for op in OPERATORS:
            if rest.startswith(op):
                self._advance(len(op))
                return Token(OP, op, pos)
        raise DMLSyntaxError(f"unexpected character {self._peek()!r}", pos, self.name)


def tokenize(source: str, source_name: str = "<script>") -> List[Token]:
    return Lexer(source, source_name).tokens()
