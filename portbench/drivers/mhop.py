"""2-hop retrieval: ``BeamSearcher.search`` over the seeded corpus, batches
back to back (closed loop), as ``cli/eval_mhop_retrieval`` serves them.

Set-up draws the weights, measures the encoder's vector moment with the
reference encoder, draws the question pool, the token store and the
index, plants each pooled question's hop-1 and hop-2 rows, and hands the
arrays to the program's ``DenseIndex`` and ``BeamSearcher``.  The engine's
encoder entry is wrapped so that, on the batches the check samples, the
inputs and vectors of every encode (hop 1, then each hop-2 tile) are kept.

The check (after the window, the program freed) runs the reference on the
sampled batches: hop-1 vectors from the same token ids, the exact hop-1
search, the hop-2 inputs assembled from the token store at the program's
hop-1 ids (the reference follows the program's hop 1 there; hop 1 itself
is judged first), the hop-2 vectors, the exact hop-2 search and the best
chains.  Numbers compared:

  * ``input_diff``: entries of the hop-1 and hop-2 encoder inputs (ids,
    mask, tile widths) that differ from the reference's: exact, 0;
  * ``vec_err``: the largest |v - v_ref| / |v_ref| of a hop-1 or hop-2
    vector, v_ref the reference encoder's vector of the same input;
  * ``miss``: returned ids and scores that the exact search of the
    program's own vectors contradicts beyond the int8 search's rounding
    (``rounding``): a returned score off its row's product, or ranked
    scores below the exact ones, for hop 1 and for the chains (d1 + d2),
    where the search claims exactness (a plain scan, or a certified PCA
    query); exact, 0.  The reference follows the program's hop-1 ids and
    vectors here, each of them judged on its own first;
  * ``planted_miss``: questions whose planted hop-1 row is not among the
    program's hop-1 candidates, plus those whose planted chain (hop-1 row,
    then the hop-2 row planted along the vector of that row's q + p
    input) is not among the returned chains.  This holds the search to
    the answer key whether or not it certifies a PCA query; an
    uncertified PCA query may rightly miss, so the limit lies between
    what sound runs and a search that skips each query's best row read;
  * ``invalid``: results of the window with an id outside the corpus or a
    score that is not finite: exact, 0.

The queries the PCA search leaves uncertified on the sampled batches are
counted on standard error (``uncertified``), not compared.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..data import corpus as C
from ..data.questions import CLS, PAD, SEP, question_pool
from ..data.weights import make_weights
from ..harness import Clock
from ..reference.encoder import Encoder, exact_fp32
from ..reference.retrieval import exact_topk, longest_first, pair_inputs
from .. import roofline

SPEC = {"cls_id": CLS, "sep_id": SEP, "pad_id": PAD}


def sub_seeds(seed: int, n: int) -> List[int]:
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(
        n, dtype=np.uint64) % (1 << 62)]


class Stream:
    """Pool rows of batch i: the pool in a seeded order, round after
    round, ``batch`` rows a step."""

    def __init__(self, seed: int, n_pool: int, batch: int):
        self.seed, self.n, self.b = seed, n_pool, batch
        self._perm = {}

    def rows(self, i: int) -> np.ndarray:
        k = np.arange(i * self.b, (i + 1) * self.b)
        out = np.empty(self.b, np.int64)
        for rnd in np.unique(k // self.n):
            if rnd not in self._perm:
                rng = np.random.default_rng([self.seed, int(rnd)])
                self._perm = {rnd: rng.permutation(self.n)}
            sel = k // self.n == rnd
            out[sel] = self._perm[rnd][k[sel] % self.n]
        return out


class Capture:
    """The engine's encoder entry; while ``on``, keeps (ids, mask, out) of
    every call."""

    def __init__(self, fn):
        self.fn, self.on, self.calls = fn, False, []

    def __call__(self, ids, mask, tt=None):
        out = self.fn(ids, mask, tt)
        if self.on:
            self.calls.append((ids, mask, out))
        return out


def port_encoder_config(cfg: Dict):
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig

    return EncoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        pad_token_id=cfg["pad_token_id"],
        roberta_positions=cfg["position_style"] == "roberta",
        hidden_act=cfg["hidden_act"], dtype=cfg["dtype"],
        attention_scores_dtype=cfg["attention_scores_dtype"])


def load_retriever(cfg: Dict, weights: Dict, dev):
    """The program's retriever (the last layer computes the CLS position
    only, as the eval CLIs build it) holding ``weights``."""
    from multihop_dense_retrieval_tpu_torch.models.retriever import \
        MhopRetriever

    with torch.device(dev):
        model = MhopRetriever(port_encoder_config(cfg), cls_only=True)
    model.load_state_dict(weights)
    return model.eval()


def hop2_tiles(n_rows: int, width: int, buckets, fracs, keys: torch.Tensor):
    """(order, [(start, end, tile width)]) of the hop-2 rows: sorted by
    length (stable), split by ``fracs`` (the last tile takes the rest),
    each tile at its bucket width unless a row is longer; no buckets: one
    tile of every row in order at full width."""
    if not buckets:
        return torch.arange(n_rows, device=keys.device), [(0, n_rows, width)]
    order = torch.sort(keys, stable=True).indices
    sizes = [int(round(f * n_rows)) for f in fracs]
    sizes[-1] = n_rows - sum(sizes[:-1])
    ks = keys[order].tolist()
    tiles, s = [], 0
    for size, b in zip(sizes, buckets):
        e = s + size
        w = min(int(b), width)
        if w >= width or max(ks[s:e]) > w:
            w = width
        tiles.append((s, e, w))
        s = e
    return order, tiles


class Driver:
    unit = "batch"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 sizes: Dict = None):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, device
        self.corpus = dict(cfg["corpus"], **(sizes or {}))
        self.trace_steps = traffic["trace_steps"]
        self.attempted = self.failed = 0
        self.results: List = []
        self.captured: List = []
        self.n_window = 0

    # ---- set-up ------------------------------------------------------------

    def setup(self):
        self._make_inputs()
        self._make_program()
        tr = self.tr
        s_t = sub_seeds(self.seed, 3)[2]
        self.stream = Stream(s_t, tr["question_pool"], tr["batch_size"])
        self.warm = Stream(s_t + 1, tr["question_pool"], tr["batch_size"])
        rng = np.random.default_rng(s_t + 2)
        self.check_at = set(rng.choice(tr["check_from"], tr["check_batches"],
                                       replace=False).tolist())
        self.lens_host = self.text_lens.cpu().numpy()

    def _make_inputs(self):
        """Weights, question pool, token store and index, from the seed."""
        cfg, tr, cor, dev = self.cfg, self.tr, self.corpus, self.dev
        s_w, s_c, _ = sub_seeds(self.seed, 3)
        self.weights = make_weights(cfg, s_w, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(s_c)
        vocab = cfg["vocab_size"]
        ref = Encoder(self.weights, cfg, device=dev)
        Clock.log("weights")
        factor, rot = C.moment_factor(ref.retrieve, vocab, gen, dev,
                                      r=cor["pca_dims"])
        self.pool = question_pool(gen, tr["question_pool"], tr["max_q_len"],
                                  tr["question_len"], vocab, dev)
        n_pad, n_docs = cor["n_pad"], cor["n_docs"]
        self.text_ids, self.text_lens = C.token_store(
            gen, n_pad, cor["text_len"], vocab, cor["doc_len"], dev)
        self.text_lens[n_docs:] = 0
        Clock.log("moment, questions, token store")
        planted, vecs = self._plants(gen, ref)
        del ref
        Clock.log("planted vectors")
        self.index = C.make_index(gen, factor, rot, n_pad, n_docs,
                                  cor["pca_cand_rows"], planted, vecs, dev)
        Clock.log("index")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def _make_program(self):
        from multihop_dense_retrieval_tpu_torch.core.config import (
            SearchConfig, default_hop2_tiling)
        from multihop_dense_retrieval_tpu_torch.data.tokenization import \
            TokenizerSpec
        from multihop_dense_retrieval_tpu_torch.index.store import DenseIndex
        from multihop_dense_retrieval_tpu_torch.search.beam import \
            BeamSearcher

        cfg, tr, cor, dev = self.cfg, self.tr, self.corpus, self.dev
        n_rows = tr["batch_size"] * tr["beam_size_1"]
        buckets, fracs = default_hop2_tiling(n_rows, tr["max_q_sp_len"])
        self.search_cfg = SearchConfig(
            beam_size_1=tr["beam_size_1"], beam_size_2=tr["beam_size_2"],
            topk=tr["topk"], max_q_len=tr["max_q_len"],
            max_q_sp_len=tr["max_q_sp_len"], batch_size=tr["batch_size"],
            hop2_buckets=buckets, hop2_tile_fracs=fracs,
            use_pca=tr["use_pca"], pca_k_chunks=tr["pca_k_chunks"],
            pca_hops=tr["pca_hops"])
        self.model = load_retriever(cfg, self.weights, dev)
        self.capture = Capture(self.model.encode_seq)
        ix, vocab = self.index, cfg["vocab_size"]
        self.engine = BeamSearcher(
            encode_fn=self.capture,
            index=DenseIndex(vectors=ix["vectors"], n_docs=cor["n_docs"],
                             scales=ix["scales"], pca_rot=ix["pca_rot"],
                             pca_proj=ix["pca_proj"],
                             pca_bounds=ix["pca_bounds"],
                             pca_cand_rows=cor["pca_cand_rows"]),
            text_ids=self.text_ids, text_lens=self.text_lens,
            empty=torch.zeros(cor["n_pad"], dtype=torch.bool, device=dev),
            spec=TokenizerSpec(cls_id=CLS, sep_id=SEP, pad_id=PAD,
                               vocab_size=vocab, roberta_style=True,
                               mask_id=vocab - 1),
            config=self.search_cfg, device=dev)

    def _plants(self, gen, ref):
        """Rows to plant (hop 1 then hop 2 of every pooled question) and
        the reference vectors they answer."""
        p, dev, tr = self.pool, self.dev, self.tr
        n = len(p["raw_lens"])
        hop2 = tr.get("hops", 2) == 2
        rows = C.distinct_rows(gen, 2 * n if hop2 else n,
                               self.corpus["n_docs"], dev)
        self.planted = rows
        self.text_lens[rows] = C.fixed_lengths(
            gen, len(rows), self.corpus["doc_len"]).to(dev)
        ids = torch.from_numpy(p["input_ids"]).to(dev)
        mask = torch.from_numpy(p["attention_mask"]).to(dev)
        with torch.no_grad(), exact_fp32():
            q = _encode_sorted(ref.retrieve, ids, mask)
            if not hop2:
                return rows, q
            h1 = rows[:n]
            a_ids = torch.from_numpy(p["raw_ids"]).to(dev)
            a_lens = torch.from_numpy(p["raw_lens"]).to(dev)
            pid, pmask = pair_inputs(a_ids, a_lens, self.text_ids[h1],
                                     self.text_lens[h1], tr["max_q_sp_len"],
                                     SPEC)
            v2 = _encode_sorted(ref.retrieve, pid, pmask)
        return rows, torch.cat([q, v2])

    # ---- the timed path ----------------------------------------------------

    def _search(self, rows):
        p = self.pool
        q = {"input_ids": p["input_ids"][rows],
             "attention_mask": p["attention_mask"][rows]}
        return self.engine.search(q, p["raw_ids"][rows], p["raw_lens"][rows])

    def warmup(self):
        for i in range(self.tr["warmup_batches"]):
            self._search(self.warm.rows(i))

    def step(self, i: int) -> int:
        rows = self.stream.rows(i)
        keep = i in self.check_at
        self.capture.on = keep
        res = self._search(rows)
        self.capture.on = False
        if keep:
            self.captured.append((i, rows, self.capture.calls, res))
            self.capture.calls = []
        self.results.append((rows, res))
        return len(rows)

    def window_done(self, n: int):
        self.n_window = n
        window = self.results[:n]
        self.attempted = sum(len(r) for r, _ in window)
        nd = self.corpus["n_docs"]
        for _, res in window:
            bad = ((res["hop1_ids"] < 0) | (res["hop1_ids"] >= nd)
                   | (res["hop2_ids"] < 0) | (res["hop2_ids"] >= nd)
                   | ~np.isfinite(res["path_scores"])).any(axis=1)
            self.failed += int(bad.sum())

    # ---- readings ----------------------------------------------------------

    def _flops(self, rows, res) -> float:
        cfg, p = self.cfg, self.pool
        h, f, nl = (cfg["hidden_size"], cfg["intermediate_size"],
                    cfg["num_hidden_layers"])
        q_len = p["attention_mask"][rows].sum(1)
        beam = self.tr["beam_size_1"]
        la = torch.from_numpy(np.repeat(p["raw_lens"][rows], beam))
        lb = torch.from_numpy(self.lens_host[res["hop1_cand_ids"].reshape(-1)])
        ka, kb = longest_first(la, lb, self.tr["max_q_sp_len"] - 4)
        pair = (ka + kb + 4).numpy()
        return roofline.encoder_flops(np.concatenate([q_len, pair]), h, f,
                                      nl, True, head=2 * h * h)

    def readings(self, r):
        n = self.n_window
        r.extra["flops"] = sum(self._flops(rows, res)
                               for rows, res in self.results[:n])
        r.extra["encode_ranges"] = ["hop1_encode", "hop2_encode"]
        r.extra["mips_ranges"] = ["hop1_mips", "hop2_mips"]
        if r.trace is None:
            return
        least = 0.0
        for rows, res in self.results[n:n + r.trace_steps]:
            least += self._mips_work(res).least_s()
        r.extra["mips_least_s"] = least

    def _mips_work(self, res) -> roofline.Work:
        tr, cor = self.tr, self.corpus
        d = self.cfg["hidden_size"]
        b, nd = tr["batch_size"], cor["n_docs"]
        cand = cor["pca_cand_rows"]
        n_chunks = cor["n_pad"] // cand
        work = roofline.Work()
        for hop, k, nq in ((1, tr["beam_size_1"], b),
                           (2, tr["beam_size_2"], b * tr["beam_size_1"])):
            if self.engine._pca_on_hop(hop) and tr["use_pca"]:
                kc = max(1, min(tr["pca_k_chunks"], n_chunks - 1))
                ids = res["hop1_cand_ids"] if hop == 1 else res["hop2_ids"]
                read = max(kc, len(np.unique(ids.reshape(-1) // cand)))
                work = work.add(roofline.int8_pca_search(
                    nq, nd, d, cor["pca_dims"], k, kc, cand, read))
            else:
                work = work.add(roofline.int8_scan(nq, nd, d, k))
        return work

    # ---- the check ---------------------------------------------------------

    def check(self):
        captured = self.captured
        del self.engine, self.model, self.capture
        self.results = self.results[:self.n_window]
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = Encoder(self.weights, self.cfg, device=self.dev)
        worst: Dict[str, float] = {}
        for i, rows, calls, res in captured:
            if i >= self.n_window:
                continue
            prog = program_outputs(calls, res, self.dev)
            for k, v in judge(self, ref, rows, prog).items():
                worst[k] = max(worst.get(k, 0.0), v)
        self.info = {"uncertified": worst.get("uncertified", 0.0)}
        Clock.log(f"uncertified PCA queries on the sampled batches: "
                  f"{self.info['uncertified']:.0f}")
        lim = self.tr["limits"]
        out = [(k, worst.get(k, math.inf), lim[k]) for k in
               ("input_diff", "vec_err", "miss", "planted_miss")]
        out.append(("invalid", float(self.failed), 0.0))
        return out


def _encode_sorted(fn, ids, mask, step: int = 64):
    """``fn`` over rows grouped by length (each group cut to its longest
    row), returned in the rows' order."""
    lens = mask.sum(1)
    order = torch.argsort(lens)
    out = []
    for s in range(0, len(order), step):
        sel = order[s:s + step]
        w = int(lens[sel].max())
        out.append(fn(ids[sel, :w], mask[sel, :w]))
    vec = torch.cat(out)
    back = torch.empty_like(vec)
    back[order] = vec
    return back


def program_outputs(calls, res, dev) -> Dict:
    """The program's encodes and results of one batch, as ``judge`` reads
    them."""
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in res.items()}
    return {"hop1": calls[0], "tiles": calls[1:], "i1": t["hop1_cand_ids"],
            "d1": t["hop1_cand_scores"], "hop1_ids": t["hop1_ids"],
            "hop2_ids": t["hop2_ids"], "path": t["path_scores"],
            "cert1": t.get("pca_cert1"), "cert2": t.get("pca_cert2")}


def planted_rows(drv, rows_t, hop: int) -> torch.Tensor:
    """(B,) the row planted for each pooled question of the batch at
    ``hop`` (1 or 2)."""
    n = len(drv.pool["raw_lens"])
    return drv.planted[rows_t + (n if hop == 2 else 0)]


def _diff(got, want) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return float(want.numel())
    return float((got.long() != want.long()).sum())


def _rel(got, want) -> float:
    return float(((got.float() - want).norm(dim=1)
                  / want.norm(dim=1)).max())


def rounding(q: torch.Tensor, xmax: float) -> torch.Tensor:
    """(B,) bound on how far an int8 search's score of any row lies from
    the float32 product: the query's per-row int8 rounding (scale max|q| /
    127, to nearest) times the longest row, plus float32 summation."""
    q = q.float()
    scale = q.abs().amax(1, keepdim=True) / 127.0
    deq = torch.clamp(torch.round(q / scale), -127, 127) * scale
    return ((q - deq).norm(dim=1) * 1.001 + 1e-5 * q.norm(dim=1)) * xmax


def _misses(q, ids, returned, exact, certified, xmax):
    """Returned (ids, scores) of each query that are wrong beyond
    ``rounding``: a score off its row's float32 product, or (where the
    search claims exactness) the ranked scores below the exact ones."""
    tol = rounding(q, xmax)[:, None]
    s = torch.einsum("bd,bkd->bk", q.float(), ids)
    bad = (returned.float() - s).abs() > tol
    ranked = torch.sort(s, dim=1, descending=True).values
    low = (ranked < exact - 2 * tol) & certified[:, None]
    return float(bad.sum() + low.sum()), s


def _rows(ix, ids):
    x = ix["vectors"][ids.reshape(-1)].float()
    x = x * ix["scales"][ids.reshape(-1)].float()[:, None]
    return x.view(*ids.shape, -1)


@torch.no_grad()
def judge(drv, ref, rows, prog) -> Dict[str, float]:
    """The compared numbers of one batch (see the module docstring);
    ``prog`` is the program's (``program_outputs``) or the control's
    (``control_outputs``)."""
    tr, dev, p = drv.tr, drv.dev, drv.pool
    ix, nd = drv.index, drv.corpus["n_docs"]
    xmax = float(ix["pca_bounds"][3].max())
    rows_t = torch.from_numpy(rows).to(dev)
    ids = torch.from_numpy(p["input_ids"]).to(dev)[rows_t]
    mask = torch.from_numpy(p["attention_mask"]).to(dev)[rows_t]
    b, beam1, beam2 = len(rows), tr["beam_size_1"], tr["beam_size_2"]
    k = prog["hop1_ids"].shape[1]
    inf = {"vec_err": math.inf, "miss": math.inf, "planted_miss": math.inf}
    with exact_fp32():
        g_ids, g_mask, q1 = prog["hop1"]
        w = g_ids.shape[1]
        diff = _diff(g_ids, ids[:, :w]) + _diff(g_mask, mask[:, :w])
        if w < ids.shape[1]:
            diff += float(mask[:, w:].sum())
        vec_err = _rel(q1, _encode_sorted(ref.retrieve, ids, mask))

        # hop 1 against the exact search of the program's own vectors
        i1 = prog["i1"].long()
        h1, h2 = prog["hop1_ids"].long(), prog["hop2_ids"].long()
        if bool(((i1 < 0) | (i1 >= nd)).any() | ((h2 < 0) | (h2 >= nd)).any()):
            return dict(inf, input_diff=diff)
        p1, p2 = planted_rows(drv, rows_t, 1), planted_rows(drv, rows_t, 2)
        planted = float((~(i1 == p1[:, None]).any(1)).sum()
                        + (~((h1 == p1[:, None]) & (h2 == p2[:, None])
                             ).any(1)).sum())
        t1, _ = exact_topk(q1, ix["vectors"], ix["scales"], nd, beam1)
        cert1 = (torch.ones(b, dtype=torch.bool, device=dev)
                 if prog["cert1"] is None else prog["cert1"].bool())
        miss, _ = _misses(q1, _rows(ix, i1), prog["d1"], t1, cert1, xmax)

        # hop-2 inputs: the token store at the program's hop-1 ids
        a_ids = torch.from_numpy(p["raw_ids"]).to(dev)[rows_t]
        a_lens = torch.from_numpy(p["raw_lens"]).to(dev)[rows_t]
        flat = i1.reshape(-1)
        pid, pmask = pair_inputs(a_ids.repeat_interleave(beam1, 0),
                                 a_lens.repeat_interleave(beam1, 0),
                                 drv.text_ids[flat], drv.text_lens[flat],
                                 tr["max_q_sp_len"], SPEC)
        cfg = drv.search_cfg
        order, tiles = hop2_tiles(b * beam1, tr["max_q_sp_len"],
                                  cfg.hop2_buckets, cfg.hop2_tile_fracs,
                                  pmask.sum(1))
        if len(prog["tiles"]) != len(tiles):
            return dict(inf, input_diff=diff + float(pid.numel()),
                        planted_miss=planted)
        got = []
        for (s, e, w), (g_ids, g_mask, g_vec) in zip(tiles, prog["tiles"]):
            sel = order[s:e]
            diff += _diff(g_ids, pid[sel, :w]) + _diff(g_mask, pmask[sel, :w])
            got.append(g_vec)
        q2 = torch.empty((b * beam1, q1.shape[1]), device=dev)
        q2[order] = torch.cat(got).float()
        vec_err = max(vec_err, _rel(q2, _encode_sorted(ref.retrieve, pid,
                                                       pmask)))

        # chains against the exact hop-2 search of the program's vectors
        slot_hit = i1[:, None, :] == h1[:, :, None]
        if not bool(slot_hit.any(2).all()):
            return dict(inf, input_diff=diff, vec_err=vec_err,
                        planted_miss=planted)
        slot = slot_hit.float().argmax(2)
        t2, _ = exact_topk(q2, ix["vectors"], ix["scales"], nd, beam2)
        d1 = prog["d1"].float()
        paths = (d1[:, :, None] + t2.view(b, beam1, beam2)).reshape(b, -1)
        exact = torch.sort(paths, dim=1, descending=True).values[:, :k]
        r2 = (torch.arange(b, device=dev)[:, None] * beam1 + slot).reshape(-1)
        cert2 = (torch.ones(b, dtype=torch.bool, device=dev)
                 if prog["cert2"] is None else prog["cert2"].bool().all(1))
        uncertified = float((~cert1).sum()) + (
            0.0 if prog["cert2"] is None
            else float((~prog["cert2"].bool()).sum()))
        tol = rounding(q2, xmax).view(b, beam1).amax(1)
        s2 = torch.einsum("rd,rd->r", q2[r2], _rows(ix, h2.reshape(-1, 1))[:, 0]
                          ).view(b, k)
        path = torch.gather(d1, 1, slot) + s2
        bad = (prog["path"].float() - path).abs() > tol[:, None]
        ranked = torch.sort(path, dim=1, descending=True).values
        low = (ranked < exact - 2 * tol[:, None]) & cert2[:, None]
        miss += float(bad.sum() + low.sum())
    return {"input_diff": diff, "vec_err": vec_err, "miss": miss,
            "planted_miss": planted, "uncertified": uncertified}


@torch.no_grad()
def control_outputs(drv, enc, rows) -> Dict:
    """The reference at another precision (``enc``) in the program's
    place: its encodes, exact searches and best chains, in the layout of
    ``program_outputs``."""
    tr, dev, p = drv.tr, drv.dev, drv.pool
    ix, nd = drv.index, drv.corpus["n_docs"]
    rows_t = torch.from_numpy(rows).to(dev)
    ids = torch.from_numpy(p["input_ids"]).to(dev)[rows_t]
    mask = torch.from_numpy(p["attention_mask"]).to(dev)[rows_t]
    b, beam1, beam2 = len(rows), tr["beam_size_1"], tr["beam_size_2"]
    with exact_fp32():
        q = _encode_sorted(enc.retrieve, ids, mask)
        d1, i1 = exact_topk(q, ix["vectors"], ix["scales"], nd, beam1)
        a_ids = torch.from_numpy(p["raw_ids"]).to(dev)[rows_t]
        a_lens = torch.from_numpy(p["raw_lens"]).to(dev)[rows_t]
        flat = i1.reshape(-1)
        pid, pmask = pair_inputs(a_ids.repeat_interleave(beam1, 0),
                                 a_lens.repeat_interleave(beam1, 0),
                                 drv.text_ids[flat], drv.text_lens[flat],
                                 tr["max_q_sp_len"], SPEC)
        cfg = drv.search_cfg
        order, tiles = hop2_tiles(b * beam1, tr["max_q_sp_len"],
                                  cfg.hop2_buckets, cfg.hop2_tile_fracs,
                                  pmask.sum(1))
        v2 = _encode_sorted(enc.retrieve, pid, pmask)
        tile_out = [(pid[order[s:e], :w], pmask[order[s:e], :w],
                     v2[order[s:e]]) for s, e, w in tiles]
        d2, i2 = exact_topk(v2, ix["vectors"], ix["scales"], nd, beam2)
        paths = (d1[:, :, None] + d2.view(b, beam1, beam2)).reshape(b, -1)
        top, flat_pos = torch.sort(paths, dim=1, descending=True,
                                   stable=True)
        k = tr["topk"]
        top, flat_pos = top[:, :k], flat_pos[:, :k]
        hop1_ids = torch.gather(i1, 1, flat_pos // beam2)
        hop2_ids = torch.gather(i2.view(b, -1), 1, flat_pos)
    return {"hop1": (ids, mask, q), "tiles": tile_out, "i1": i1, "d1": d1,
            "hop1_ids": hop1_ids, "hop2_ids": hop2_ids, "path": top,
            "cert1": None, "cert2": None}
