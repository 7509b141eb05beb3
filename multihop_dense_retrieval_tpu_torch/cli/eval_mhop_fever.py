"""CLI: 2-hop retrieval over FEVER claims.

The port of the JAX package's ``cli/eval_mhop_fever.py``.  Differences
from ``cli/eval_mhop_retrieval`` (as in the reference script):
  * input rows are claims, ``{"id", "claim"}``, fed verbatim (no
    trailing-"?" strip);
  * separate --beam-size-1/--beam-size-2 (defaults 5/5; the published FEVER
    configurations use beam 1 of 1-2 with beam 2 of 10-20, which takes the
    two-phase exact search at hop 2);
  * FEVER defaults: max_q_len 45, max_q_sp_len 400, --pca-k-chunks 16;
  * the dump is keyed "id"/"claim" with candidate_chains as
    [(title, text), (title, text)] pairs, one JSON object per line.
Rows that carry an "sp" annotation also get the chain metrics.
It runs on CUDA unless ``--device`` names another device;
``--index-shards`` shards the index as in ``eval_mhop_retrieval``.
``--hop2-prune-margin`` prunes hop-1 candidates as there.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.eval_mhop_fever \\
      CLAIMS.jsonl INDEX_DIR --tokenizer hash --model-name tiny \\
      --beam-size-1 1 --beam-size-2 20 --topk 20 --save-path chains.jsonl
"""

import argparse
import json
import os
import time

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..data.corpus import Corpus
from ..eval.retrieval_metrics import chain_metrics
from . import common
from .eval_mhop_retrieval import (count_certified, load_searcher,
                                  log_metrics, refuse_unported,
                                  search_batches, write_jsonl)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("raw_data", help="FEVER claims JSONL: id/claim per line")
    p.add_argument("index_dir", help="output dir of cli.encode_corpus")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--topk", type=int, default=2)
    p.add_argument("--beam-size-1", type=int, default=5)
    p.add_argument("--beam-size-2", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--max-q-len", type=int, default=45)
    p.add_argument("--max-q-sp-len", type=int, default=400)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--no-pallas", action="store_true")
    p.add_argument("--index-shards", type=int, default=1)
    p.add_argument("--pca", action="store_true",
                   help="PCA-prefiltered MIPS (index built with --pca-dims); "
                        "certified fraction reported")
    p.add_argument("--pca-k-chunks", type=int, default=16,
                   help="higher default than the hotpot eval: FEVER's "
                        "asymmetric beams fetch large k per query")
    p.add_argument("--pca-hops", default="auto",
                   choices=["auto", "1", "2", "12"])
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
        args, args.batch_size * args.beam_size_1, args.max_q_sp_len)
    cfg = SearchConfig(beam_size_1=args.beam_size_1,
                       beam_size_2=args.beam_size_2,
                       topk=args.topk, max_q_len=args.max_q_len,
                       max_q_sp_len=args.max_q_sp_len,
                       chunk_rows=args.chunk_rows,
                       hop2_buckets=h2b, hop2_tile_fracs=h2f,
                       hop2_prune_margin=args.hop2_prune_margin,
                       use_pca=args.pca, pca_k_chunks=args.pca_k_chunks,
                       pca_hops=args.pca_hops)
    corpus = Corpus.from_id2doc(os.path.join(args.index_dir, "id2doc.json"))
    searcher = load_searcher(
        args.index_dir, tok, model, cfg, device,
        mesh=common.index_mesh(args.index_shards, device))

    metrics, outputs = [], []
    cert_hits = cert_total = 0
    t0 = time.time()
    for s, res in search_batches(searcher, tok,
                                 [r["claim"] for r in ds_items],
                                 args.batch_size, args.max_q_len,
                                 args.max_q_sp_len):
        batch = ds_items[s:s + args.batch_size]
        hits, total = count_certified(res, len(batch))
        cert_hits, cert_total = cert_hits + hits, cert_total + total
        for i, row in enumerate(batch):
            chains = [
                [(corpus[int(h1)]["title"], corpus[int(h1)]["text"]),
                 (corpus[int(h2)]["title"], corpus[int(h2)]["text"])]
                for h1, h2 in zip(res["hop1_ids"][i], res["hop2_ids"][i])]
            if "sp" in row:
                metrics.append(chain_metrics(
                    row["sp"], row.get("type", "multi"),
                    [[c[0][0], c[1][0]] for c in chains],
                    [corpus[int(j)]["title"] for j in res["hop1_cand_ids"][i]]))
            outputs.append({"id": row.get("id"), "claim": row["claim"],
                            "candidate_chains": chains})
    dt = time.time() - t0
    logger.info("searched %d claims in %.2fs (%.1f q/s)", len(ds_items), dt,
                len(ds_items) / dt)
    if cert_total:
        logger.info("pca exactness certificates: %.1f%% of MIPS queries "
                    "provably exact", 100.0 * cert_hits / cert_total)

    if metrics:
        log_metrics(logger, metrics)
    write_jsonl(logger, args.save_path, outputs)
    return outputs


if __name__ == "__main__":
    main()
