"""Per-row token estimates of a payload column: the token-budget coalescer's
sizing signal.

Counterpart of ``arkflow_tpu/tpu/extract.py::payload_token_estimates``,
reading the port's ``BinaryColumn`` (values + offsets, Arrow's binary
layout) with numpy: one vectorized pass over the payload bytes, no per-row
Python.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import BinaryColumn

#: byte classes of the hash tokenizer's ``[a-z0-9]+|[^\sa-z0-9]`` split after
#: ``.lower()``: WORD bytes extend a token, SINGLE bytes are one token each,
#: the rest is whitespace
_TOK_WORD = np.zeros(256, np.bool_)
for _r in (range(ord("a"), ord("z") + 1), range(ord("A"), ord("Z") + 1),
           range(ord("0"), ord("9") + 1)):
    _TOK_WORD[list(_r)] = True
_TOK_SPACE = np.zeros(256, np.bool_)
_TOK_SPACE[[ord(c) for c in " \t\n\r\x0b\x0c"]] = True
_TOK_SINGLE = ~(_TOK_WORD | _TOK_SPACE)


def payload_token_estimates(col: BinaryColumn, *, token_bytes: Optional[float] = None,
                            max_tokens: Optional[int] = None) -> np.ndarray:
    """Per-row token-count estimates ([n] int64).

    Default mode equals the hash tokenizer's count exactly: word runs plus
    standalone punctuation bytes, plus 2 specials ([CLS]/[SEP]).
    ``token_bytes`` switches to ``ceil(len / token_bytes) + 2`` (subword
    tokenizers, whose splits do not follow whitespace). ``max_tokens`` clamps
    rows to the serving truncation width, so one huge payload cannot starve
    an emission's budget.
    """
    offsets = col.offsets
    n = len(col)
    if n == 0:
        return np.zeros(0, np.int64)
    starts = offsets[:-1]
    lens = (offsets[1:] - starts).astype(np.int64)
    if token_bytes is not None:
        est = np.ceil(lens / float(token_bytes)).astype(np.int64) + 2
    else:
        lo = int(starts[0])
        window = col.values[lo:int(offsets[-1])]
        word = _TOK_WORD[window]
        # a word-run start: a WORD byte not preceded by a WORD byte; a row's
        # first byte always starts a run (the byte before it is another row's)
        run_start = word.copy()
        run_start[1:] &= ~word[:-1]
        within = starts - lo
        inside = within[within < len(window)]
        run_start[inside] = word[inside]
        counts = run_start.astype(np.int64) + _TOK_SINGLE[window]
        cs = np.concatenate(([0], np.cumsum(counts)))
        ends = np.minimum(within + lens, len(window))
        est = cs[ends] - cs[np.minimum(within, len(window))] + 2
    est = np.maximum(est, 2)  # empty text still tokenizes to [CLS][SEP]
    if max_tokens is not None:
        est = np.minimum(est, int(max_tokens))
    return est
