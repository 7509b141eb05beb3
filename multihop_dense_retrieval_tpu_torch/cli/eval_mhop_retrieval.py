"""CLI: 2-hop beam-search retrieval eval on HotpotQA-format data.

The port of the JAX package's ``cli/eval_mhop_retrieval.py``: the same
flags, metrics block (Avg PR / P-EM / 1-Recall / Path Recall, overall and
per type) and candidate-chain JSONL dump, over the port's device engine
(``search/beam.py``) and the artifacts of either package's
``cli/encode_corpus`` (``index.npz``, ``tokens.npz``, ``id2doc.json``).
It runs on CUDA unless ``--device`` names another device.

``--unified`` serves variable-hop chains with a UnifiedRetriever: a chain
whose stop probability exceeds ``--stop-threshold`` is one passage, and
``--stop-skip P`` skips the hop-2 encode of the other candidates of a
question whose top pair reaches P(stop) >= P.  ``--hop2-prune-margin``
prunes hop-1 candidates far below their question's top-1.  ``--hnsw``
searches the native HNSW graph on the host (the encoder stays on the
device), building ``<index_dir>/index.hnsw`` once (M 32, ef_construction
200) and loading it afterwards, from either package.

``--index-shards N`` splits the index by rows into N shards
(``cli/common.index_mesh``: over the visible cards, or N shards on a named
device such as ``cpu``, and across processes under ``cli/pod``); each
shard searches its rows through the same kernels.  ``--no-pallas`` raises
NotImplementedError on CUDA (the JAX package's XLA tier has no CUDA
counterpart).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.eval_mhop_retrieval \\
      QAS.jsonl INDEX_DIR --tokenizer hash --model-name tiny \\
      --beam-size 4 --topk 4 [--save-path chains.jsonl]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..data.corpus import Corpus, TokenizedCorpus
from ..eval.retrieval_metrics import aggregate_metrics, chain_metrics
from ..index.hnsw import HNSWIndex
from ..index.store import DenseIndex
from ..ops.mips import NEG_INF
from ..search.beam import BeamSearcher, assemble_pair_inputs
from . import common


def load_searcher(index_dir, tok, model, cfg, device, mesh=None,
                  unified=False) -> BeamSearcher:
    """The engine over an index directory.  The token store stays uint16
    on the device and is widened after the per-beam gather.  ``mesh``:
    the index is sharded by rows over its ``index`` axis.  ``unified``:
    hop 2 runs through ``model.encode_qsp`` (the stop head)."""
    index = DenseIndex.load(os.path.join(index_dir, "index.npz"),
                            device=device, mesh=mesh)
    tc = TokenizedCorpus.load(os.path.join(index_dir, "tokens.npz"),
                              token_dtype=np.uint16)
    n_pad = index.vectors.shape[0]

    def padrows(x, fill):
        out = np.full((n_pad,) + x.shape[1:], fill, x.dtype)
        out[: x.shape[0]] = x
        return out

    return BeamSearcher(
        encode_fn=model.encode_seq,
        encode_qsp_fn=model.encode_qsp if unified else None, index=index,
        text_ids=padrows(tc.text_ids, tok.spec.pad_id),
        text_lens=padrows(tc.text_lens, 0),
        empty=padrows(tc.empty, False), spec=tok.spec, config=cfg,
        mesh=mesh, device=device)


def refuse_unported(args, device):
    """Raise on the options the port does not serve."""
    if args.no_pallas and device.type == "cuda":
        raise NotImplementedError(
            "--no-pallas asks for the JAX package's XLA tier, which has no "
            "CUDA counterpart: the port's kernels are its only CUDA path")


def _patch_missing(d, i):
    """HNSW returns id -1 where the graph holds fewer than k rows: map it
    to doc 0 with a NEG_INF score, so the slot can never win (a negative
    index would silently wrap to the last document)."""
    missing = i < 0
    return np.where(missing, NEG_INF, d), np.where(missing, 0, i)


class HnswBeamSearcher:
    """The host-graph 2-hop engine: the encoder runs on the device, the
    HNSW graph searches on the host (the reference's FAISS HNSW mode), with
    ``BeamSearcher.search``'s result contract.  Hop-2 rows pair the raw
    question ids with each candidate's text re-tokenized (300 ids), an
    empty text scoring NEG_INF at hop 1, as the JAX package's engine
    does."""

    def __init__(self, hnsw, encode, tok, corpus, cfg, ef_search, device):
        self.hnsw, self.encode, self.tok = hnsw, encode, tok
        self.corpus, self.config, self.ef = corpus, cfg, ef_search
        self.device = device

    def _vectors(self, inputs) -> np.ndarray:
        dev = self.device
        tt = inputs.get("token_type_ids")
        with torch.inference_mode():
            out = self.encode(torch.as_tensor(inputs["input_ids"]).to(dev),
                              torch.as_tensor(inputs["attention_mask"]
                                              ).to(dev),
                              None if tt is None
                              else torch.as_tensor(tt).to(dev))
        return out.float().cpu().numpy()

    def search(self, q_inputs, q_raw_ids, q_raw_lens):
        cfg = self.config
        beam1, beam2, topk = cfg.beam_size_1, cfg.beam_size_2, cfg.topk
        q_vec = self._vectors(q_inputs)
        d1, i1 = _patch_missing(*self.hnsw.search(q_vec, beam1, self.ef))
        bsz = q_vec.shape[0]
        doc_rows = []
        for b in range(bsz):
            for s in range(beam1):
                doc = self.corpus[int(i1[b, s])]
                text = doc["text"] if doc["text"].strip() else doc["title"]
                if not doc["text"].strip():
                    d1[b, s] = NEG_INF
                doc_rows.append(self.tok.raw_ids_padded(text, 300))
        qsp = assemble_pair_inputs(
            torch.from_numpy(np.repeat(q_raw_ids, beam1, axis=0)),
            torch.from_numpy(np.repeat(q_raw_lens, beam1, axis=0)),
            torch.from_numpy(np.stack([r[0] for r in doc_rows])),
            torch.from_numpy(np.array([r[1] for r in doc_rows])),
            cfg.max_q_sp_len, self.tok.spec)
        d2, i2 = _patch_missing(*self.hnsw.search(self._vectors(qsp), beam2,
                                                  self.ef))
        flat = (d1[:, :, None] + d2.reshape(bsz, beam1, beam2)
                ).reshape(bsz, -1)
        order = np.argsort(-flat, axis=1)[:, :topk]
        return {
            "path_scores": np.take_along_axis(flat, order, axis=1),
            "hop1_ids": np.take_along_axis(i1, order // beam2, axis=1),
            "hop2_ids": np.take_along_axis(i2.reshape(bsz, -1), order,
                                           axis=1),
            "hop1_cand_ids": i1,
            "hop1_cand_scores": d1,
        }


def hnsw_searcher(args, logger, tok, model, cfg, corpus, device):
    """The HNSW engine over ``args.index_dir``: its ``index.hnsw`` when it
    exists (either package's), else one built from ``index.npz`` (int8
    rows dequantized with their scales in fp32 on the host; M 32,
    ef_construction 200, as the JAX package builds it) and saved there."""
    path = os.path.join(args.index_dir, "index.hnsw")
    if os.path.exists(path):
        logger.info("loading HNSW index %s", path)
        hnsw = HNSWIndex.load(path)
    else:
        logger.info("building HNSW index from index.npz ...")
        dense = DenseIndex.load(os.path.join(args.index_dir, "index.npz"),
                                device="cpu")
        if dense.multi_vector > 1:
            raise ValueError(
                "--hnsw does not support multi-vector indexes: the graph "
                "returns row ids and the host path has no max-over-vectors "
                "doc merge; use the device engine")
        vecs = dense.vectors[: dense.n_docs].float().numpy()
        if dense.scales is not None:
            vecs *= dense.scales[: dense.n_docs, None].numpy()
        hnsw = HNSWIndex(vecs.shape[1], M=32, ef_construction=200)
        hnsw.add(vecs)
        hnsw.save(path)
        logger.info("built and saved %s (%d vectors)", path, len(hnsw))
    return HnswBeamSearcher(hnsw, model.encode_seq, tok, corpus, cfg,
                            args.ef_search, device)


def search_batches(searcher, tok, texts, bs, max_q_len, max_q_sp_len):
    """Yield (first row, search result) per batch of ``bs`` texts; a short
    last batch is padded with its last text.  Raw ids for hop-2 assembly
    are budgeted by max_q_sp_len (the pair encode's longest-first
    truncation decides)."""
    q_budget = max_q_sp_len - (4 if tok.spec.roberta_style else 3)
    for s in range(0, len(texts), bs):
        batch = texts[s:s + bs]
        padded = batch + [batch[-1]] * (bs - len(batch))
        q_inputs = tok.encode_batch_one(padded, max_q_len)
        raw = [tok.raw_ids_padded(q, q_budget) for q in padded]
        yield s, searcher.search(q_inputs, np.stack([r[0] for r in raw]),
                                 np.array([r[1] for r in raw]))


def count_certified(res, n):
    """(certified, total) MIPS queries of a result's first n rows."""
    hits = total = 0
    for key in ("pca_cert1", "pca_cert2"):
        if key in res:
            c = np.asarray(res[key][:n])
            hits += int(c.sum())
            total += c.size
    return hits, total


def log_metrics(logger, metrics):
    agg = aggregate_metrics(metrics)
    for scope, vals in agg.items():
        logger.info("[%s] n=%d  Avg PR: %.4f  Avg P-EM: %.4f  "
                    "Avg 1-Recall: %.4f  Path Recall: %.4f",
                    scope, vals["n"], vals["avg_pr"], vals["avg_p_em"],
                    vals["avg_1_recall"], vals["path_recall"])
    print(json.dumps(agg["overall"]))
    return agg


def write_jsonl(logger, path, outputs):
    if path and common.is_primary():
        with open(path, "w") as f:
            for o in outputs:
                f.write(json.dumps(o) + "\n")
        logger.info("wrote %d candidate chains to %s", len(outputs), path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("raw_data", help="eval JSONL: question/sp/type per line")
    p.add_argument("index_dir", help="output dir of cli.encode_corpus")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--topk", type=int, default=2)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--beam-size-2", type=int, default=None,
                   help="hop-2 beam (FEVER uses asymmetric beams); defaults "
                        "to --beam-size")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--max-q-len", type=int, default=70)
    p.add_argument("--max-q-sp-len", type=int, default=350)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--no-pallas", action="store_true")
    p.add_argument("--index-shards", type=int, default=1)
    p.add_argument("--hnsw", action="store_true",
                   help="host-side approximate search through the native "
                        "HNSW graph (the encoder stays on the device); "
                        "builds and caches <index_dir>/index.hnsw")
    p.add_argument("--ef-search", type=int, default=128)
    p.add_argument("--unified", action="store_true",
                   help="variable-hop serving with a UnifiedRetriever: the "
                        "stop head decides whether a chain is one passage")
    p.add_argument("--stop-threshold", type=float, default=0.5,
                   help="P(single-hop) above which a chain is emitted as one "
                        "passage (--unified only)")
    p.add_argument("--stop-skip", type=float, default=0.0,
                   help="device-side early stop (--unified only): questions "
                        "whose best hop-1 pair reaches this P(stop) skip the "
                        "hop-2 encode of their other candidates; 0 = off")
    p.add_argument("--pca", action="store_true",
                   help="PCA-prefiltered MIPS (index built with encode_corpus "
                        "--pca-dims); the certified fraction is reported")
    p.add_argument("--pca-k-chunks", type=int, default=8,
                   help="chunks rescanned per query")
    p.add_argument("--pca-hops", default="auto",
                   choices=["auto", "1", "2", "12"],
                   help="which hops use the prefilter; auto = hop 2 always, "
                        "hop 1 only without hop-2 buckets")
    common.add_hop2_tiling_args(p)
    p.add_argument("--save-path", default="")
    args = p.parse_args(argv)

    if args.stop_skip > 0 and not args.unified:
        p.error("--stop-skip needs --unified (the stop head lives on the "
                "UnifiedRetriever's q⊕p encoder)")
    if args.pca and args.hnsw:
        p.error("--pca is a device tier (not with --hnsw)")
    if args.hnsw and args.unified:
        p.error("--unified is not supported with --hnsw (the host HNSW "
                "engine has no stop-head path); use the device engine")

    device = resolve_device(args.device)
    refuse_unported(args, device)
    logger = common.setup_logging()
    tok = common.resolve_tokenizer(args.tokenizer)
    model = common.init_retriever(
        common.resolve_encoder_config(args.model_name), unified=args.unified,
        checkpoint=args.checkpoint, device=device)

    with open(args.raw_data) as f:
        ds_items = [json.loads(l) for l in f if l.strip()]

    h2b, h2f = common.resolve_hop2_tiling(
        args, args.batch_size * args.beam_size, args.max_q_sp_len)
    cfg = SearchConfig(beam_size_1=args.beam_size,
                       beam_size_2=args.beam_size_2 or args.beam_size,
                       topk=args.topk, max_q_len=args.max_q_len,
                       max_q_sp_len=args.max_q_sp_len,
                       chunk_rows=args.chunk_rows,
                       hop2_buckets=h2b, hop2_tile_fracs=h2f,
                       hop2_prune_margin=args.hop2_prune_margin,
                       use_pca=args.pca, pca_k_chunks=args.pca_k_chunks,
                       pca_hops=args.pca_hops,
                       stop_skip_threshold=args.stop_skip)
    corpus = Corpus.from_id2doc(os.path.join(args.index_dir, "id2doc.json"))
    if args.hnsw:
        searcher = hnsw_searcher(args, logger, tok, model, cfg, corpus,
                                 device)
    else:
        searcher = load_searcher(
            args.index_dir, tok, model, cfg, device,
            mesh=common.index_mesh(args.index_shards, device),
            unified=args.unified)

    metrics, outputs = [], []
    cert_hits = cert_total = 0
    qs = [r["question"][:-1] if r["question"].endswith("?")
          else r["question"] for r in ds_items]
    t0 = time.time()
    for s, res in search_batches(searcher, tok, qs, args.batch_size,
                                 args.max_q_len, args.max_q_sp_len):
        batch = ds_items[s:s + args.batch_size]
        hits, total = count_certified(res, len(batch))
        cert_hits, cert_total = cert_hits + hits, cert_total + total
        for i, row in enumerate(batch):
            # variable-hop: a chain whose stop head fires is one passage
            stops = [False] * len(res["hop1_ids"][i])
            if args.unified and "top_stop_probs" in res:
                stops = [p > args.stop_threshold
                         for p in res["top_stop_probs"][i]]
            chains = [[int(h1)] if stop else [int(h1), int(h2)]
                      for h1, h2, stop in zip(res["hop1_ids"][i],
                                              res["hop2_ids"][i], stops)]
            if "sp" in row:
                metrics.append(chain_metrics(
                    row["sp"], row.get("type", "single"),
                    [[corpus[d]["title"] for d in c] for c in chains],
                    [corpus[int(j)]["title"] for j in res["hop1_cand_ids"][i]]))
            out_row = {
                "_id": row.get("_id"),
                "question": row["question"],
                "candidate_chains": [[corpus[d] for d in c] for c in chains],
            }
            if args.unified and "top_stop_probs" in res:
                out_row["stop_probs"] = [float(p)
                                         for p in res["top_stop_probs"][i]]
            outputs.append(out_row)
    dt = time.time() - t0
    logger.info("searched %d questions in %.2fs (%.1f q/s)", len(ds_items),
                dt, len(ds_items) / dt)
    if cert_total:
        logger.info("pca exactness certificates: %.1f%% of MIPS queries "
                    "provably exact", 100.0 * cert_hits / cert_total)

    agg = log_metrics(logger, metrics) if metrics else None
    write_jsonl(logger, args.save_path, outputs)
    return agg, outputs


if __name__ == "__main__":
    main()
