"""CLI: 2-hop beam-search retrieval eval on HotpotQA-format data.

The port of the JAX package's ``cli/eval_mhop_retrieval.py``: the same
flags, metrics block (Avg PR / P-EM / 1-Recall / Path Recall, overall and
per type) and candidate-chain JSONL dump, over the port's device engine
(``search/beam.py``) and the artifacts of the JAX package's
``cli/encode_corpus`` (``index.npz``, ``tokens.npz``, ``id2doc.json``).
It runs on CUDA unless ``--device`` names another device.

Not ported yet (each raises NotImplementedError): ``--hnsw`` (ROADMAP item
13), ``--unified`` and ``--stop-skip`` (item 8), ``--index-shards > 1``
(item 12), a nonzero ``--hop2-prune-margin`` (item 8), and ``--no-pallas``
on CUDA (the JAX package's XLA tier has no CUDA counterpart).

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

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..data.corpus import Corpus, TokenizedCorpus
from ..eval.retrieval_metrics import aggregate_metrics, chain_metrics
from ..index.store import DenseIndex
from ..search.beam import BeamSearcher
from . import common


def load_searcher(index_dir, tok, model, cfg, device) -> BeamSearcher:
    """The engine over an index directory.  The token store stays uint16
    on the device and is widened after the per-beam gather."""
    index = DenseIndex.load(os.path.join(index_dir, "index.npz"),
                            device=device)
    tc = TokenizedCorpus.load(os.path.join(index_dir, "tokens.npz"),
                              token_dtype=np.uint16)
    n_pad = index.vectors.shape[0]

    def padrows(x, fill):
        out = np.full((n_pad,) + x.shape[1:], fill, x.dtype)
        out[: x.shape[0]] = x
        return out

    return BeamSearcher(
        encode_fn=model.encode_seq, index=index,
        text_ids=padrows(tc.text_ids, tok.spec.pad_id),
        text_lens=padrows(tc.text_lens, 0),
        empty=padrows(tc.empty, False), spec=tok.spec, config=cfg,
        device=device)


def refuse_unported(args, device):
    """Raise on the options the port does not serve yet."""
    for flag, on, item in (("--hnsw", getattr(args, "hnsw", False), 13),
                           ("--unified", getattr(args, "unified", False), 8),
                           ("--stop-skip", getattr(args, "stop_skip", 0) > 0,
                            8),
                           ("--index-shards", args.index_shards > 1, 12),
                           ("--hop2-prune-margin",
                            args.hop2_prune_margin != 0, 8)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP item {item})")
    if args.no_pallas and device.type == "cuda":
        raise NotImplementedError(
            "--no-pallas asks for the JAX package's XLA tier, which has no "
            "CUDA counterpart: the port's kernels are its only CUDA path")


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
    p.add_argument("--hnsw", action="store_true")
    p.add_argument("--ef-search", type=int, default=128)
    p.add_argument("--unified", action="store_true")
    p.add_argument("--stop-threshold", type=float, default=0.5)
    p.add_argument("--stop-skip", type=float, default=0.0)
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

    device = resolve_device(args.device)
    refuse_unported(args, device)
    logger = common.setup_logging()
    tok = common.resolve_tokenizer(args.tokenizer)
    model = common.init_retriever(
        common.resolve_encoder_config(args.model_name),
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
                       use_pca=args.pca, pca_k_chunks=args.pca_k_chunks,
                       pca_hops=args.pca_hops)
    corpus = Corpus.from_id2doc(os.path.join(args.index_dir, "id2doc.json"))
    searcher = load_searcher(args.index_dir, tok, model, cfg, device)

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
            pairs = list(zip(res["hop1_ids"][i], res["hop2_ids"][i]))
            if "sp" in row:
                metrics.append(chain_metrics(
                    row["sp"], row.get("type", "single"),
                    [[corpus[int(h1)]["title"], corpus[int(h2)]["title"]]
                     for h1, h2 in pairs],
                    [corpus[int(j)]["title"] for j in res["hop1_cand_ids"][i]]))
            outputs.append({
                "_id": row.get("_id"),
                "question": row["question"],
                "candidate_chains": [[corpus[int(h1)], corpus[int(h2)]]
                                     for h1, h2 in pairs],
            })
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
