"""QA reader dataset: retrieval chains → fixed-shape reader features.

Re-design of mdr/qa/qa_dataset.py.  Sequence construction (qa_dataset.py:38-64):

  context = "yes no [SEP] " + " [SEP] ".join(
      title + " " + " ".join("[unused1] " + sent for sent in sents)
      for passage in chain)

so yes/no questions are answered by pointing at positions 0/1 of the context
(qa_dataset.py:324-329) and each sentence start is marked by `[unused1]`
whose hidden state feeds the supporting-fact head.  The whitespace-word →
wordpiece offset maps (char_to_word_offset / orig_to_tok_index /
tok_to_orig_index, qa_dataset.py:60-104) drive span supervision and answer
detokenization.

Differences from the reference (all static-shape driven):
  * answer-occurrence slots padded to `num_answer_slots` (starts/ends -1);
  * sentence-marker slots padded to `max_sents` with an explicit sent_mask
    (the reference overloads offset==0 as padding);
  * features are numpy, stacked by qa_collate.

A copy of the JAX package's ``data/qa_dataset.py`` (which imports no JAX)
over the port's ``data/tokenization.py``; tests/test_torch_reader.py holds
the two to bit-equal features.  An item's featurization is the span
``read_featurize`` of ``utils/profiling.py``.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.profiling import span
from .tokenization import _Base as Tokenizer


def _is_whitespace(c: str) -> bool:
    return c in " \t\r\n" or ord(c) == 0x202F


def prepare_context(passages: List[Dict], tokenizer: Tokenizer) -> Dict:
    """Chain → context string, whitespace words, offset maps, sent starts."""
    sep, marker = tokenizer.sep_token, tokenizer.marker_token
    parts = []
    for para in passages:
        sents = " ".join(f"{marker} {s.strip()}" for s in para["sents"])
        parts.append(f"{para['title'].strip()} {sents}")
    context = "yes no [SEP] " + " [SEP] ".join(parts)
    context = context.replace("[SEP]", sep)  # honor custom sep surface form

    doc_tokens: List[str] = []
    char_to_word: List[int] = []
    prev_ws = True
    for c in context:
        if _is_whitespace(c):
            prev_ws = True
        else:
            if prev_ws:
                doc_tokens.append(c)
            else:
                doc_tokens[-1] += c
            prev_ws = False
        char_to_word.append(len(doc_tokens) - 1)

    special = {sep, marker}
    sent_starts: List[int] = []
    orig_to_tok: List[int] = []
    tok_to_orig: List[int] = []
    all_doc_tokens: List[str] = []
    for i, token in enumerate(doc_tokens):
        orig_to_tok.append(len(all_doc_tokens))
        if token in special:
            if token == marker:
                sent_starts.append(len(all_doc_tokens))
            subs = [token]
        else:
            subs = tokenizer.subtokens(token) or [token]
        for s in subs:
            tok_to_orig.append(i)
            all_doc_tokens.append(s)
    return {
        "context": context,
        "doc_tokens": doc_tokens,
        "char_to_word_offset": char_to_word,
        "orig_to_tok_index": orig_to_tok,
        "tok_to_orig_index": tok_to_orig,
        "all_doc_tokens": all_doc_tokens,
        "sent_starts": sent_starts,
    }


def find_answer_spans(doc_tokens: List[str], answers: Sequence[str]) -> List:
    """All word-level occurrences of any gold answer (uncased, punctuation
    tolerant) — the match_answer_span/char-offset machinery of
    qa_dataset.py:332-352 collapsed to word space."""
    import string

    def norm(w):
        return w.lower().strip(string.punctuation)

    doc_norm = [norm(w) for w in doc_tokens]
    spans = []
    for ans in answers:
        toks = [norm(w) for w in ans.split() if norm(w)]
        if not toks:
            continue
        n = len(toks)
        for s in range(len(doc_norm) - n + 1):
            if doc_norm[s:s + n] == toks:
                spans.append((s, s + n - 1))
    return spans


class QAFeatureBuilder:
    """Turns one (question, chain) item into fixed-shape reader features."""

    def __init__(self, tokenizer: Tokenizer, max_seq_len: int = 512,
                 max_q_len: int = 64, num_answer_slots: int = 10,
                 max_sents: int = 40):
        self.tok = tokenizer
        self.max_seq_len = max_seq_len
        self.max_q_len = max_q_len
        self.num_answer_slots = num_answer_slots
        self.max_sents = max_sents

    def build(self, item: Dict, train: bool) -> Dict:
        tok = self.tok
        spec = tok.spec
        ctx = prepare_context(item["passages"], tok)
        q_sub = []
        for w in item["question"].split():
            q_sub.extend(tok.subtokens(w))
        q_sub = q_sub[: self.max_q_len]
        para_offset = len(q_sub) + 2  # [CLS] q [SEP]
        wp = ctx["all_doc_tokens"]
        max_doc = self.max_seq_len - para_offset - 1
        wp = wp[:max_doc]

        ids = ([spec.cls_id] + tok.convert_tokens_to_ids(q_sub)
               + [spec.sep_id] + tok.convert_tokens_to_ids(wp) + [spec.sep_id])
        L = self.max_seq_len
        input_ids = np.full(L, spec.pad_id, np.int32)
        input_ids[: len(ids)] = ids
        attention_mask = np.zeros(L, np.int32)
        attention_mask[: len(ids)] = 1
        token_type_ids = np.zeros(L, np.int32)
        # HF pair encoding keeps the [SEP] after the question in segment 0
        # (reference builds features with encode_plus, qa/qa_dataset.py:164)
        token_type_ids[para_offset: len(ids)] = 1
        paragraph_mask = np.zeros(L, np.int32)
        paragraph_mask[para_offset: len(ids) - 1] = 1

        # sentence markers
        sent_offsets = np.zeros(self.max_sents, np.int32)
        sent_mask = np.zeros(self.max_sents, np.int32)
        sent_labels = np.zeros(self.max_sents, np.int32)
        kept = [s for s in ctx["sent_starts"] if s < len(wp)][: self.max_sents]
        for j, s in enumerate(kept):
            sent_offsets[j] = s + para_offset
            sent_mask[j] = 1
            labels = item.get("sp_sent_labels")
            if labels and j < len(labels):
                sent_labels[j] = labels[j]

        feat = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
            "paragraph_mask": paragraph_mask,
            "sent_offsets": sent_offsets,
            "sent_mask": sent_mask,
            "label": np.int32(max(item.get("label", -1), -1)),
        }
        meta = {
            "qid": item.get("qid"),
            "passages": item["passages"],
            "gold_answer": item.get("gold_answer", []),
            "sp_gold": item.get("sp_gold", []),
            "para_offset": para_offset,
            "doc_tokens": ctx["doc_tokens"],
            "tok_to_orig_index": ctx["tok_to_orig_index"],
            "wp_tokens": wp,
        }

        if train:
            starts = np.full(self.num_answer_slots, -1, np.int32)
            ends = np.full(self.num_answer_slots, -1, np.int32)
            if item.get("ans_covered", 1):
                gold = item.get("gold_answer", [])
                slots = []
                if gold and gold[0] == "yes":
                    slots = [(para_offset, para_offset)]
                elif gold and gold[0] == "no":
                    slots = [(para_offset + 1, para_offset + 1)]
                else:
                    for (ws, we) in find_answer_spans(ctx["doc_tokens"], gold):
                        ts = ctx["orig_to_tok_index"][ws]
                        te = (ctx["orig_to_tok_index"][we + 1] - 1
                              if we + 1 < len(ctx["orig_to_tok_index"])
                              else len(ctx["all_doc_tokens"]) - 1)
                        if ts >= len(wp):
                            continue
                        slots.append((min(ts, len(wp) - 1) + para_offset,
                                      min(te, len(wp) - 1) + para_offset))
                for j, (s, e) in enumerate(slots[: self.num_answer_slots]):
                    starts[j], ends[j] = s, e
            feat["starts"] = starts
            feat["ends"] = ends
            feat["sent_labels"] = sent_labels
        return {"features": feat, "meta": meta}


class QADataset:
    """Reader dataset over retriever-output JSONL (train) or in-memory chains
    (eval), mirroring QADataset/QAEvalDataset (qa_dataset.py:108-300).

    Train rows: {"question", "_id", "answer", "sp": [{"title","sents",
    "sp_sent_ids"}...], "candidate_chains": [...], "type"}.
    """

    def __init__(self, tokenizer: Tokenizer, data, *, max_seq_len=512,
                 max_q_len=64, num_answer_slots=10, max_sents=40,
                 train=False):
        # negative capping/shuffling lives in QAGroupSampler (the
        # reference's MhopSampler), not here — the dataset holds ALL rows
        if isinstance(data, str):
            with open(data) as f:
                data = [json.loads(l) for l in f if l.strip()]
        self.train = train
        self.builder = QAFeatureBuilder(tokenizer, max_seq_len, max_q_len,
                                        num_answer_slots, max_sents)
        self.data: List[Dict] = []
        self.qid2gold = collections.defaultdict(list)
        self.qid2neg = collections.defaultdict(list)

        for item in data:
            q = item["question"]
            if q.endswith("?"):
                q = q[:-1]
            gold_answer = item.get("answer", [])
            sp_gold, sp_sent_labels = [], []
            sp_titles = None
            if "sp" in item and item["sp"] and isinstance(item["sp"][0], dict):
                for sp in item["sp"]:
                    for sid in sp.get("sp_sent_ids", []):
                        sp_gold.append([sp["title"], sid])
                    for idx in range(len(sp.get("sents", []))):
                        sp_sent_labels.append(int(idx in sp.get("sp_sent_ids", [])))
                sp_titles = set(p["title"] for p in item["sp"])
            elif train and "sp" in item and item["sp"]:
                # raw HotpotQA supporting_facts ([title, sent_id] pairs):
                # silently skipping would yield ZERO training rows, nan
                # losses, and checkpoints of untrained params
                raise ValueError(
                    "train-mode 'sp' entries must be passage dicts with "
                    "title/sents/sp_sent_ids — raw [title, sent_id] pairs "
                    "need `cli/prep add-sp-label` (the reference's "
                    "add_sp_label.sh) first")

            if train and sp_titles:
                self.data.append({
                    "question": q, "passages": item["sp"], "label": 1,
                    "qid": item["_id"], "gold_answer": gold_answer,
                    "sp_sent_labels": sp_sent_labels, "ans_covered": 1,
                    "sp_gold": sp_gold})
                self.qid2gold[item["_id"]].append(len(self.data) - 1)
                for chain in item.get("candidate_chains", []):
                    titles = [p["title"] for p in chain]
                    if set(titles) == sp_titles:
                        continue
                    covered = int(any(
                        self._covers_answer(p, gold_answer) for p in chain)) \
                        if item.get("type") == "bridge" else 0
                    self.data.append({
                        "question": q, "passages": chain, "label": 0,
                        "qid": item["_id"], "gold_answer": gold_answer,
                        "ans_covered": covered, "sp_gold": sp_gold})
                    self.qid2neg[item["_id"]].append(len(self.data) - 1)
            else:
                for chain in item.get("candidate_chains", []):
                    titles = [p["title"] for p in chain]
                    label = int(set(titles) == sp_titles) if sp_titles else -1
                    self.data.append({
                        "question": q, "passages": chain, "label": label,
                        "qid": item["_id"], "gold_answer": gold_answer,
                        "sp_gold": sp_gold})

    @staticmethod
    def _covers_answer(passage, answers) -> bool:
        text = " ".join(passage.get("sents", [passage.get("text", "")])).lower()
        return any(a.lower() in text for a in answers if a not in ("yes", "no"))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i: int) -> Dict:
        with span("read_featurize"):
            return self.builder.build(self.data[i], self.train)


class QAGroupSampler:
    """Gold + num_neg negatives of one question kept contiguous
    (MhopSampler, qa_dataset.py:391-422)."""

    def __init__(self, dataset: QADataset, neg_num: int = 5, seed: int = 0):
        self.ds = dataset
        self.neg_num = neg_num
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        """Rows per epoch, WITHOUT consuming RNG state (an epoch_indices
        call just for its length would silently shift every epoch's
        shuffle)."""
        return sum(len(gold) + min(self.neg_num, len(self.ds.qid2neg[qid]))
                   for qid, gold in self.ds.qid2gold.items())

    def epoch_indices(self) -> List[int]:
        qids = list(self.ds.qid2gold)
        self.rng.shuffle(qids)
        out = []
        for qid in qids:
            negs = list(self.ds.qid2neg[qid])
            self.rng.shuffle(negs)
            out.extend(self.ds.qid2gold[qid])
            out.extend(negs[: self.neg_num])
        return out


def qa_collate(samples: List[Dict]) -> Dict:
    feats = [s["features"] for s in samples]
    batch = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    meta = {k: [s["meta"][k] for s in samples] for k in samples[0]["meta"]}
    return {"net_inputs": batch, **meta}


def decode_answer(wp_tokens: List[str], doc_tokens: List[str],
                  tok_to_orig_index: List[int], start: int, end: int) -> str:
    """Wordpiece span → original text (train_qa.py:269-282).

    start/end are positions in wp_tokens (paragraph offset already removed).
    """
    if start < 0 or start >= len(wp_tokens):
        return ""
    end = min(max(end, start), len(wp_tokens) - 1)
    orig_s = tok_to_orig_index[start]
    orig_e = tok_to_orig_index[end]
    orig_text = " ".join(doc_tokens[orig_s: orig_e + 1])
    tok_text = " ".join(wp_tokens[start: end + 1])
    tok_text = tok_text.replace(" ##", "").replace("##", "").strip()
    tok_text = " ".join(tok_text.split())
    return get_final_text(tok_text, orig_text)


def get_final_text(pred_text: str, orig_text: str,
                   do_lower_case: bool = True) -> str:
    """SQuAD-style back-projection of a wordpiece span onto the original text
    (qa/utils.py:329-396).  Falls back to orig_text when alignment fails."""
    import string

    def strip_spaces(text):
        ns_chars, ns_to_s = [], []
        for i, c in enumerate(text):
            if c == " ":
                continue
            ns_to_s.append(i)
            ns_chars.append(c)
        return "".join(ns_chars), ns_to_s

    cmp_orig = orig_text.lower() if do_lower_case else orig_text
    start = cmp_orig.find(pred_text.lower() if do_lower_case else pred_text)
    if start == -1:
        ns_pred, _ = strip_spaces(pred_text.lower())
        ns_orig, ns_map = strip_spaces(cmp_orig)
        ns_start = ns_orig.find(ns_pred)
        if ns_start == -1:
            return orig_text
        s = ns_map[ns_start]
        e = ns_map[min(ns_start + len(ns_pred) - 1, len(ns_map) - 1)]
        return orig_text[s: e + 1]
    return orig_text[start: start + len(pred_text)]
