"""Reading: MDR's reader over retrieved chains, as ``cli/end2end`` and
``DemoPipeline.answer_batch`` compose it: per call, the questions' chains
go through the program's ``QADataset`` (host featurization, inside the
window) and ``eval/qa_eval.py::predict`` with
``train/qa.py::make_qa_predict_step`` (length-sorted reader batches at
64-multiple widths, the span decode on the card, answers and supporting
sentences decoded on the host, chains ranked at a fixed λ).  Calls follow
each other (closed loop).

The text is made from the seed: a pool of questions, each with its
chains of passages split into sentences on ". " (as ``retrieve_chains``
splits a corpus text), words from a synthetic vocabulary, one token each
under the hash tokenizer; passage lengths lognormal and clipped, one
multiset for every seed.

The benchmark's spans: ``featurize`` (host seconds in the dataset's
items, which ``predict`` builds as it batches) and ``predict`` (a
``record_function`` range around the whole call of ``predict``).  On the
calls the check samples, each batch's inputs, the reader's start and end
logits (a forward hook) and the predict step's outputs are kept.  Numbers
compared (the reference in float32 on the same weights, its own
features):

  * ``feature_diff``: entries of the reader's inputs that differ from the
    reference's features: exact, 0;
  * ``logit_err``: the largest |rank score - reference| and |span score -
    the reference's start + end logits at the program's span|;
  * ``sp_err``: the largest |supporting-sentence probability - the
    reference's|;
  * ``decode_miss``: chains whose decoded span is not the best span of the
    program's own start and end logits (end - start within
    ``max_ans_len``), or whose span score is not its logits' sum, beyond
    the rounding of a sum in the logits' precision: exact, 0;
  * ``answer_diff``: questions whose answer or supporting facts differ
    from the reference's decode of the program's own spans, scores and
    probabilities: exact, 0.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import roofline
from ..data.corpus import fixed_lengths
from ..data.weights import make_weights
from ..reference import qa as RQ
from ..reference.encoder import Encoder, exact_fp32
from .mhop import Stream, port_encoder_config, sub_seeds

NUMBERS = ("feature_diff", "logit_err", "sp_err", "decode_miss",
           "answer_diff")
KEYS = ("input_ids", "attention_mask", "token_type_ids", "paragraph_mask")


def make_text(gen: torch.Generator, rng: np.random.Generator, tr: Dict):
    """The seeded items: ``question`` text and ``chains`` (lists of
    {title, sents})."""
    n, vocab = tr["question_pool"], tr["words"]
    q_len = fixed_lengths(gen, n, tr["question_len"]).numpy()
    n_pass = n * tr["chains"] * tr["passages_per_chain"]
    p_len = fixed_lengths(gen, n_pass, tr["passage_len"]).numpy()

    def words(k):
        return " ".join(f"w{x}" for x in rng.integers(0, vocab, k))

    passages = []
    for total in p_len:
        sents, left = [], int(total)
        while left > 0:
            k = min(left, int(rng.integers(*tr["sentence_words"])))
            sents.append(words(k))
            left -= k
        text = ". ".join(sents) + "."
        passages.append({"title": words(int(rng.integers(1, 4))),
                         "sents": [x for x in text.split(". ") if x.strip()]})
    items, at = [], 0
    per = tr["passages_per_chain"]
    for i in range(n):
        chains = []
        for _ in range(tr["chains"]):
            chains.append(passages[at:at + per])
            at += per
        items.append({"question": words(int(q_len[i])) + "?",
                      "chains": chains})
    return items


class Featurize:
    """The dataset as ``predict`` reads it: each item's features are timed
    (the benchmark's ``featurize`` span), the order of the items it asks
    for and each item's token count are kept."""

    def __init__(self, ds, drv):
        self.ds, self.drv = ds, drv
        self.data = ds.data
        self.asked: List[int] = []
        self.lens: Dict[int, int] = {}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        t = time.perf_counter()
        out = self.ds[i]
        self.drv.featurize_s += time.perf_counter() - t
        self.asked.append(i)
        self.lens[i] = int(out["features"]["attention_mask"].sum())
        return out


class Driver:
    unit = "call"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.trace_steps = traffic["trace_steps"]
        self.attempted = self.failed = 0
        self.featurize_s = 0.0
        self.calls: List = []
        self.captured: List = []
        self.n_window = 0
        self.keep = False
        self.kept: List = []

    def setup(self):
        from multihop_dense_retrieval_tpu_torch.data.tokenization import \
            HashTokenizer
        from multihop_dense_retrieval_tpu_torch.models.reader import QAReader
        from multihop_dense_retrieval_tpu_torch.train.qa import \
            make_qa_predict_step

        cfg, tr, dev = self.cfg, self.tr, self.dev
        s_w, s_c, s_t = sub_seeds(self.seed, 3)
        self.weights = make_weights(cfg, s_w, dev)
        gen = torch.Generator()
        gen.manual_seed(s_c)
        self.items = make_text(gen, np.random.default_rng(s_c), tr)
        with torch.device(dev):
            self.model = QAReader(port_encoder_config(cfg), sp_pred=True)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.tok = HashTokenizer(vocab_size=cfg["vocab_size"],
                                 roberta_style=False)
        pred = make_qa_predict_step(self.model,
                                    max_ans_len=tr["max_ans_len"])

        def logits(_module, _inputs, out):
            if self.keep:
                self.logits = (out["start_logits"], out["end_logits"])

        self.model.register_forward_hook(logits)

        def step_fn(net):
            out = pred(net)
            if self.keep:
                self.kept.append(({k: net[k] for k in net}, out,
                                  self.logits))
            return out

        self.step_fn = step_fn
        self.stream = Stream(s_t, tr["question_pool"], tr["questions"])
        self.warm = Stream(s_t + 1, tr["question_pool"], tr["questions"])
        rng = np.random.default_rng(s_t + 2)
        self.check_at = set(rng.choice(tr["check_from"], tr["check_calls"],
                                       replace=False).tolist())

    def _call(self, rows, tag: str):
        from multihop_dense_retrieval_tpu_torch.data.qa_dataset import \
            QADataset
        from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict

        tr = self.tr
        data = [{"question": self.items[j]["question"], "_id": f"{tag}.{k}",
                 "answer": [], "candidate_chains": self.items[j]["chains"]}
                for k, j in enumerate(rows)]
        t = time.perf_counter()
        ds = QADataset(self.tok, data, max_seq_len=tr["max_seq_len"],
                       train=False)
        self.featurize_s += time.perf_counter() - t
        view = Featurize(ds, self)
        with record_function("predict"):
            res = predict(self.step_fn, view, batch_size=tr["reader_batch"],
                          sp_pred=True, lambdas=[tr["lambda"]],
                          length_sort=True, width_multiple=64)
        return ds, view, res

    def warmup(self):
        for i in range(self.tr["warmup_calls"]):
            self._call(self.warm.rows(i), f"w{i}")
        self.featurize_s = 0.0

    def step(self, i: int) -> int:
        rows = self.stream.rows(i)
        self.keep = i in self.check_at
        self.kept = []
        ds, view, res = self._call(rows, str(i))
        if self.keep:
            self.captured.append((i, rows, ds, view.asked, self.kept, res))
        self.keep = False
        self.calls.append((rows, res, list(view.lens.values())))
        return len(res["best"]["answers"])

    def window_done(self, n: int):
        self.n_window = n
        self.attempted = sum(len(c[0]) for c in self.calls[:n])
        self.failed = self.attempted - sum(len(c[1]["best"]["answers"])
                                           for c in self.calls[:n])
        self.window_featurize_s = self.featurize_s

    def readings(self, r):
        cfg = self.cfg
        h, f = cfg["hidden_size"], cfg["intermediate_size"]
        lens = [n for _, _, ls in self.calls[:self.n_window] for n in ls]
        head = 2 * h * h + 2 * h * 2 + 2 * h
        r.extra["flops"] = roofline.encoder_flops(
            lens, h, f, cfg["num_hidden_layers"], False, head=head)
        r.extra["featurize_s"] = self.window_featurize_s

    def check(self):
        captured = [c for c in self.captured if c[0] < self.n_window]
        del self.model, self.step_fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = Encoder(self.weights, self.cfg, device=self.dev)
        worst: Dict[str, float] = {}
        for _, rows, ds, asked, kept, res in captured:
            prog = program_outputs(ds, asked, kept, res, self.tr)
            for k, v in judge(self, ref, rows, prog).items():
                worst[k] = max(worst.get(k, 0.0), v)
        lim = self.tr["limits"]
        return [(k, worst.get(k, math.inf), lim[k]) for k in NUMBERS]


def program_outputs(ds, asked, kept, res, tr) -> Dict:
    """Per chain of the call (in the dataset's order): the reader's inputs
    and the predict step's outputs; per question: the answer and
    supporting facts."""
    b = tr["reader_batch"]
    chains = {}
    for n, (net, out, (ls, le)) in enumerate(kept):
        idx = asked[n * b:(n + 1) * b]
        host = {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in out.items()}
        eps = torch.finfo(ls.dtype).eps
        ls, le = ls.double().cpu().numpy(), le.double().cpu().numpy()
        for r, j in enumerate(idx):
            if j in chains:
                continue
            chains[j] = {"net": {k: np.asarray(net[k][r]) for k in net},
                         "rank": host["rank_score"][r],
                         "start": int(host["start_pos"][r]),
                         "end": int(host["end_pos"][r]),
                         "span": host["span_score"][r],
                         "sp": host["sp_prob"][r],
                         "logits": (ls[r], le[r], eps)}
    return {"chains": chains, "answers": res["best"]["answers"],
            "sp": res["best"]["sp"], "qid": [d["qid"] for d in ds.data]}


@torch.no_grad()
def _reference_scores(enc, feats, dev, step: int = 16) -> List[Dict]:
    """The reference reader over the features, in blocks of rows cut to
    their longest row."""
    out = []
    for s in range(0, len(feats), step):
        block = feats[s:s + step]
        w = max(int(f["attention_mask"].sum()) for f in block)
        t = {k: torch.from_numpy(np.stack([f[k] for f in block])).to(dev)
             for k in KEYS + ("sent_offsets",)}
        for k in KEYS:
            t[k] = t[k][:, :w]
        with exact_fp32():
            o = enc.read(t["input_ids"], t["attention_mask"],
                         t["token_type_ids"], t["paragraph_mask"],
                         t["sent_offsets"])
        for r in range(len(block)):
            out.append({k: v[r] for k, v in o.items()})
    return out


def decode_miss(got: Dict, max_ans_len: int) -> float:
    """1 where the chain's span (``start``, ``end``) is not the best of its
    own ``logits`` over 0 <= end - start <= ``max_ans_len``, or its
    ``span`` score not their sum, beyond the rounding of a sum in the
    logits' precision; else 0."""
    ls, le, eps = got["logits"]
    best, _, _ = RQ.best_span(torch.from_numpy(ls)[None],
                              torch.from_numpy(le)[None], max_ans_len)
    best = float(best[0])
    s, e = got["start"], got["end"]
    if not (0 <= s <= e < len(ls)) or e - s > max_ans_len:
        return 1.0
    pick = float(ls[s] + le[e])
    tol = eps * (abs(best) + abs(pick))
    return float(pick < best - tol or abs(float(got["span"]) - pick) > tol)


def judge(drv, ref, rows, prog) -> Dict[str, float]:
    """The compared numbers of one call (see the module docstring);
    ``prog`` is the program's or the control's (``control_outputs``)."""
    tr, cfg = drv.tr, drv.cfg
    tok = RQ.HashTokenizer(cfg["vocab_size"])
    feats, metas, qidx = [], [], []
    for q, j in enumerate(rows):
        it = drv.items[j]
        for chain in it["chains"]:
            f, m = RQ.features(tok, it["question"], chain, tr["max_seq_len"])
            feats.append(f)
            metas.append(m)
            qidx.append(q)
    if len(prog["chains"]) != len(feats):
        return {k: math.inf for k in NUMBERS}
    refs = _reference_scores(ref, feats, drv.dev)
    out = dict.fromkeys(NUMBERS, 0.0)
    lam, mal = tr["lambda"], tr["max_ans_len"]
    best_by_q: Dict[int, tuple] = {}
    for c, (f, m, rs) in enumerate(zip(feats, metas, refs)):
        got = prog["chains"][c]
        net = got["net"]
        w = net["input_ids"].shape[0]
        for k in KEYS:
            out["feature_diff"] += float((net[k] != f[k][:w]).sum())
        out["feature_diff"] += float(f["attention_mask"][w:].sum())
        for k in ("sent_offsets", "sent_mask"):
            out["feature_diff"] += float((net[k] != f[k]).sum())
        start, end = rs["start"].double(), rs["end"].double()
        s, e = got["start"], got["end"]
        if not (0 <= s <= e < len(start)) or e - s > mal:
            out["logit_err"] = math.inf
            continue
        out["decode_miss"] += decode_miss(got, mal)
        mine = float(start[s] + end[e])
        out["logit_err"] = max(out["logit_err"],
                               abs(float(got["rank"]) - float(rs["rank"])),
                               abs(float(got["span"]) - mine))
        sm = f["sent_mask"].astype(bool)
        sp_ref = torch.sigmoid(rs["sp"].double()).cpu().numpy()
        if sm.any():
            out["sp_err"] = max(out["sp_err"], float(
                np.abs(np.asarray(got["sp"])[sm] - sp_ref[sm]).max()))
        # the answer this chain gives, decoded by the reference
        q = qidx[c]
        text = RQ.answer_text(m, s, e)
        chain = drv.items[rows[q]]["chains"][c % tr["chains"]]
        probs = np.asarray(got["sp"])
        sp, si = [], 0
        for para in chain:
            for li in range(len(para["sents"])):
                if si < len(probs) and probs[si] >= 0.5:
                    sp.append([para["title"], li])
                si += 1
        score = lam * float(got["rank"]) + (1 - lam) * float(got["span"])
        if q not in best_by_q or score > best_by_q[q][0]:
            best_by_q[q] = (score, text, sp)
    for q in range(len(rows)):
        qid = prog["qid"][q * tr["chains"]]
        want = best_by_q.get(q)
        if want is None or prog["answers"].get(qid) != want[1] \
                or prog["sp"].get(qid) != want[2]:
            out["answer_diff"] += 1
    return out


@torch.no_grad()
def control_outputs(drv, enc, rows) -> Dict:
    """The reference reader at another precision (``enc``) in the
    program's place: its logits on the reference's features, decoded."""
    tr, cfg = drv.tr, drv.cfg
    tok = RQ.HashTokenizer(cfg["vocab_size"])
    feats, metas, qids = [], [], []
    for q, j in enumerate(rows):
        it = drv.items[j]
        for chain in it["chains"]:
            f, m = RQ.features(tok, it["question"], chain, tr["max_seq_len"])
            feats.append(f)
            metas.append(m)
            qids.append(f"c.{q}")
    outs = _reference_scores(enc, feats, drv.dev)
    chains, answers, sps = {}, {}, {}
    lam = tr["lambda"]
    best = {}
    for c, (f, m, o) in enumerate(zip(feats, metas, outs)):
        span, s, e = RQ.best_span(o["start"][None].double(),
                                  o["end"][None].double(), tr["max_ans_len"])
        sp = torch.sigmoid(torch.where(
            torch.from_numpy(f["sent_mask"]).bool().to(o["sp"].device),
            o["sp"].double(), -1e30)).cpu().numpy()
        chains[c] = {"net": {k: f[k][:max(64, -(-int(
            f["attention_mask"].sum()) // 64) * 64)] if k in KEYS else f[k]
            for k in KEYS + ("sent_offsets", "sent_mask")},
            "rank": float(o["rank"]), "start": int(s[0]), "end": int(e[0]),
            "span": float(span[0]), "sp": sp,
            "logits": (o["start"].double().cpu().numpy(),
                       o["end"].double().cpu().numpy(),
                       torch.finfo(torch.float32).eps)}
        q = c // tr["chains"]
        chain = drv.items[rows[q]]["chains"][c % tr["chains"]]
        pred_sp, si = [], 0
        for para in chain:
            for li in range(len(para["sents"])):
                if si < len(sp) and sp[si] >= 0.5:
                    pred_sp.append([para["title"], li])
                si += 1
        score = lam * chains[c]["rank"] + (1 - lam) * chains[c]["span"]
        if q not in best or score > best[q][0]:
            best[q] = (score, RQ.answer_text(m, int(s[0]), int(e[0])),
                       pred_sp)
    for q, (_, text, pred_sp) in best.items():
        answers[qids[q * tr["chains"]]] = text
        sps[qids[q * tr["chains"]]] = pred_sp
    return {"chains": chains, "answers": answers, "sp": sps, "qid": qids}
