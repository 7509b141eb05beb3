"""The seeded pool of pre-tokenized questions of the retrieval cells.

Lengths (with the two special tokens) are lognormal and clipped, as the
traffic file says, one multiset for every seed (drawn from a fixed seed,
then put in the run's order), so that seeds change the order of the work
and not its amount; ids are uniform over the vocabulary's non-special
range, what the hash tokenizer gives for random words (RoBERTa's BPE is
not in the repository, and tokenizing in the window would time a
stand-in).  The pool is a set of host arrays in the layout the program's
search entry takes: ``input_ids`` / ``attention_mask`` at ``max_q_len``
(``<s> x </s>``, pad 1) and the raw ids without specials with their
lengths, from which hop-2 inputs are assembled.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .corpus import fixed_lengths

CLS, SEP, PAD = 0, 2, 1


def question_pool(gen, n: int, max_q_len: int, lens: Dict, vocab: int,
                  device) -> Dict[str, np.ndarray]:
    spec = dict(lens, hi=min(lens["hi"], max_q_len))
    total = fixed_lengths(gen, n, spec).cpu().numpy()
    raw_len = total - 2
    width = max_q_len - 2
    raw = torch.randint(4, vocab - 1, (n, width), generator=gen,
                        device=device, dtype=torch.int32).cpu().numpy()
    col = np.arange(width)[None, :]
    raw = np.where(col < raw_len[:, None], raw, PAD).astype(np.int32)
    ids = np.full((n, max_q_len), PAD, np.int32)
    ids[:, 0] = CLS
    ids[:, 1:1 + width] = raw
    ids[np.arange(n), raw_len + 1] = SEP
    mask = (np.arange(max_q_len)[None, :] < total[:, None]).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "raw_ids": raw,
            "raw_lens": raw_len.astype(np.int32)}
