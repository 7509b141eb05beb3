"""Host-side text utilities: the DrQA-style word tokenizer and answer
matching (the JAX package's ``utils/text.py``).

Answer strings are matched against passage text as normalized token
subsequences (the reference's ``mdr/retrieval/utils/utils.py:126-139``).

The JAX copy writes its tokenizer with the third-party ``regex`` package's
``\\p{L}\\p{N}\\p{M}`` / ``\\p{Z}\\p{C}`` classes.  The port does without it:
the stdlib ``re`` has no ``\\p{...}`` and its ``\\w`` leaves out combining
marks, so the two classes are built once from ``unicodedata.category``
as explicit code-point ranges.  The tokens are the same:
  * a run of letters, numbers and marks (L*, N*, M*) is one token;
  * any other character that is not a separator or control (Z*, C*) is a
    token alone.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import List, Sequence

from ..data.corpus import nfd_normalize as _normalize


def _ranges(major: str) -> str:
    """A character-class body of every code point whose general category
    starts with one of the letters in ``major``."""
    parts, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = (cp <= sys.maxunicode
                  and unicodedata.category(chr(cp))[0] in major)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            parts.append(f"\\U{start:08x}" if cp - 1 == start
                         else f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return "".join(parts)


@functools.lru_cache(maxsize=1)
def _pattern() -> "re.Pattern":
    return re.compile(f"([{_ranges('LNM')}]+)|([^{_ranges('ZC')}])")


class SimpleTokenizer:
    """Word tokenizer: alphanumeric runs (with marks) or single non-space
    characters; ``words`` gives the uncased view (DrQA semantics)."""

    def tokenize(self, text: str) -> List[str]:
        return [m.group() for m in _pattern().finditer(text)]

    def words(self, text: str, uncased: bool = True) -> List[str]:
        toks = self.tokenize(text)
        return [t.lower() for t in toks] if uncased else toks


def para_has_answer(answers: Sequence[str], para: str,
                    tokenizer: SimpleTokenizer) -> bool:
    """True iff any gold answer appears as a token subsequence of `para`
    (utils/utils.py:126-139)."""
    text = tokenizer.words(_normalize(para), uncased=True)
    for answer in answers:
        ans_toks = tokenizer.words(_normalize(answer), uncased=True)
        n = len(ans_toks)
        if n == 0:
            continue
        for i in range(0, len(text) - n + 1):
            if text[i:i + n] == ans_toks:
                return True
    return False
