"""Single-hop bulk retrieval: ``MhopRetriever.encode_seq`` then
``ops/mips.py::mips_topk`` as ``cli/eval_retrieval`` composes them (its
loop is inline in the CLI's ``main``), batches back to back, the top-k
ids brought to the host.  The benchmark's own ranges ``encode`` and
``mips`` wrap the two calls.

The corpus is the 2-hop cells' (``mhop.Driver``), with hop-1 rows planted
only.  Numbers compared (on the sampled batches, after the window):

  * ``vec_err``: the largest |v - v_ref| / |v_ref| of a query vector;
  * ``miss``: returned (id, score) pairs that the exact search of the
    program's own vectors contradicts beyond the int8 search's rounding
    (a score off its row's product, or ranked scores below the exact
    top-k): exact, 0;
  * ``planted_miss``: questions whose planted row is not among the
    returned ids: exact, 0;
  * ``invalid``: results of the window with an id outside the corpus or a
    score that is not finite: exact, 0.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import roofline
from ..reference.encoder import Encoder, exact_fp32
from ..reference.retrieval import exact_topk
from . import mhop


class Driver(mhop.Driver):
    def _make_program(self):
        self.model = mhop.load_retriever(self.cfg, self.weights, self.dev)
        self.capture = mhop.Capture(self.model.encode_seq)

    def _search(self, rows):
        from multihop_dense_retrieval_tpu_torch.ops.mips import mips_topk

        p, ix, dev = self.pool, self.index, self.dev
        with torch.inference_mode():
            ids = torch.from_numpy(p["input_ids"][rows]).to(dev)
            mask = torch.from_numpy(p["attention_mask"][rows]).to(dev)
            with record_function("encode"):
                vecs = self.capture(ids, mask)
            with record_function("mips"):
                vals, top = mips_topk(ix["vectors"], vecs.to(torch.float32),
                                      self.tr["topk"],
                                      chunk_rows=self.tr["chunk_rows"],
                                      n_valid=self.corpus["n_docs"],
                                      doc_scales=ix["scales"])
            return {"ids": top.cpu().numpy(), "vals": vals}

    def step(self, i: int) -> int:
        rows = self.stream.rows(i)
        keep = i in self.check_at
        self.capture.on = keep
        res = self._search(rows)
        self.capture.on = False
        if keep:
            vecs = self.capture.calls[0][2]
            self.capture.calls = []
            self.captured.append((i, rows, dict(res, vecs=vecs)))
        self.results.append((rows, {"ids": res["ids"]}))
        return len(rows)

    def window_done(self, n: int):
        self.n_window = n
        window = self.results[:n]
        self.attempted = sum(len(r) for r, _ in window)
        nd = self.corpus["n_docs"]
        for _, res in window:
            bad = ((res["ids"] < 0) | (res["ids"] >= nd)).any(axis=1)
            self.failed += int(bad.sum())

    def readings(self, r):
        cfg, p = self.cfg, self.pool
        h = cfg["hidden_size"]
        lens = np.concatenate([p["attention_mask"][rows].sum(1)
                               for rows, _ in self.results[:self.n_window]])
        r.extra["flops"] = roofline.encoder_flops(
            lens, h, cfg["intermediate_size"], cfg["num_hidden_layers"],
            True, head=2 * h * h)
        r.extra["encode_ranges"] = ["encode"]
        r.extra["mips_ranges"] = ["mips"]
        if r.trace is not None:
            tr, cor = self.tr, self.corpus
            one = roofline.int8_scan(tr["batch_size"], cor["n_docs"], h,
                                     tr["topk"])
            r.extra["mips_least_s"] = one.least_s() * r.trace_steps

    def check(self):
        captured = [c for c in self.captured if c[0] < self.n_window]
        del self.model, self.capture
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = Encoder(self.weights, self.cfg, device=self.dev)
        worst: Dict[str, float] = {}
        for _, rows, res in captured:
            for k, v in judge(self, ref, rows, res).items():
                worst[k] = max(worst.get(k, 0.0), v)
        lim = self.tr["limits"]
        out = [(k, worst.get(k, math.inf), lim[k]) for k in
               ("vec_err", "miss", "planted_miss")]
        out.append(("invalid", float(self.failed), 0.0))
        return out


@torch.no_grad()
def judge(drv, ref, rows, prog) -> Dict[str, float]:
    """``vec_err``, ``miss`` and ``planted_miss`` of one batch; ``prog``
    holds the program's (or the control's) ``vecs``, ``vals`` and
    ``ids``."""
    p, ix, dev = drv.pool, drv.index, drv.dev
    nd = drv.corpus["n_docs"]
    xmax = float(ix["pca_bounds"][3].max())
    ids = torch.from_numpy(p["input_ids"][rows]).to(dev)
    mask = torch.from_numpy(p["attention_mask"][rows]).to(dev)
    top = torch.as_tensor(prog["ids"], device=dev).long()
    with exact_fp32():
        q = prog["vecs"].float()
        vec_err = mhop._rel(q, mhop._encode_sorted(ref.retrieve, ids, mask))
        if bool(((top < 0) | (top >= nd)).any()):
            return {"vec_err": vec_err, "miss": math.inf,
                    "planted_miss": math.inf}
        p1 = mhop.planted_rows(drv, torch.from_numpy(rows).to(dev), 1)
        planted = float((~(top == p1[:, None]).any(1)).sum())
        exact, _ = exact_topk(q, ix["vectors"], ix["scales"], nd,
                              top.shape[1])
        every = torch.ones(len(rows), dtype=torch.bool, device=dev)
        miss, _ = mhop._misses(q, mhop._rows(ix, top), prog["vals"], exact,
                               every, xmax)
    return {"vec_err": vec_err, "miss": miss, "planted_miss": planted}


@torch.no_grad()
def control_outputs(drv, enc, rows) -> Dict:
    """The reference at another precision (``enc``) in the program's
    place: its vectors and their exact top-k."""
    p, ix, dev = drv.pool, drv.index, drv.dev
    ids = torch.from_numpy(p["input_ids"][rows]).to(dev)
    mask = torch.from_numpy(p["attention_mask"][rows]).to(dev)
    with exact_fp32():
        q = mhop._encode_sorted(enc.retrieve, ids, mask)
        vals, top = exact_topk(q, ix["vectors"], ix["scales"],
                               drv.corpus["n_docs"], drv.tr["topk"])
    return {"vecs": q, "vals": vals, "ids": top}
