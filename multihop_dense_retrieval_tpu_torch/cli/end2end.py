"""CLI: the full question → answer pipeline.

The port of the JAX package's ``cli/end2end.py``: 2-hop beam retrieval
over an index directory (``cli/eval_mhop_retrieval.py``'s engine), then
the reader (chain ranking, span extraction, supporting facts) at the
fixed λ, then answer EM/F1 where gold answers are given.  It runs on CUDA
unless ``--device`` names another device, and prints one JSON line of
metrics.

``--unified`` retrieves with a UnifiedRetriever: a chain whose stop
probability exceeds ``--stop-threshold`` goes to the reader as one
passage (without ``--unified`` the threshold is ignored, as in JAX).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.end2end QAS.jsonl \\
      INDEX_DIR --tokenizer hash --retriever-model tiny --reader-model tiny
"""

import argparse
import json
import os
import time

import numpy as np

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..data.corpus import Corpus
from ..data.qa_dataset import QADataset
from ..eval.hotpot_metrics import exact_match_score, f1_score
from ..eval.qa_eval import predict
from ..train import qa as TQA
from . import common
from .eval_mhop_retrieval import load_searcher, search_batches


def retrieve_chains(searcher, tok, corpus, questions, batch_size, max_q_len,
                    stop_threshold=None):
    """2-hop beam search; per question, its candidate chains with
    sentence-split passages for the reader (a text is split on '. ' when
    the corpus has no sentence annotations).  A short last batch is padded
    with its last question.  ``stop_threshold`` (unified engines): a chain
    whose stop probability exceeds it is one passage."""
    qs = [q[:-1] if q.endswith("?") else q for q in questions]
    outs = []
    for s, res in search_batches(searcher, tok, qs, batch_size, max_q_len,
                                 searcher.config.max_q_sp_len):
        stops = (res["top_stop_probs"] if stop_threshold is not None
                 and "top_stop_probs" in res else None)
        for i in range(len(qs[s:s + batch_size])):
            chains = []
            for j, (h1, h2) in enumerate(zip(res["hop1_ids"][i],
                                             res["hop2_ids"][i])):
                doc_ids = ((int(h1),) if stops is not None
                           and float(stops[i][j]) > stop_threshold
                           else (int(h1), int(h2)))
                chain = []
                for doc_id in doc_ids:
                    d = corpus[doc_id]
                    sents = [x for x in d["text"].split(". ") if x.strip()] \
                        or [d["text"] or d["title"]]
                    chain.append({"title": d["title"], "sents": sents})
                chains.append(chain)
            outs.append(chains)
    return outs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("raw_data", help="questions JSONL (question[, answer, sp])")
    p.add_argument("index_dir")
    common.add_device_arg(p)
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--retriever-model", default="roberta-base")
    p.add_argument("--retriever-checkpoint", default="")
    p.add_argument("--reader-model", default="electra-large")
    p.add_argument("--reader-tokenizer", default="",
                   help="tokenizer for the reader (its vocabulary differs "
                        "from the retriever's); default: --tokenizer, "
                        "correct only for the hash test tokenizer")
    p.add_argument("--reader-checkpoint", default="")
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--max-q-len", type=int, default=70)
    p.add_argument("--max-q-sp-len", type=int, default=350)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--max-ans-len", type=int, default=30)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--lambda", dest="lam", type=float, default=0.8)
    common.add_reader_scores_args(p)
    common.add_rank_args(p)
    common.add_hop2_tiling_args(p)
    p.add_argument("--save-path", default="")
    p.add_argument("--unified", action="store_true",
                   help="UnifiedRetriever checkpoint: chains whose stop head "
                        "fires are read as one-passage chains")
    p.add_argument("--stop-threshold", type=float, default=0.5)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    logger = common.setup_logging()
    r_tok = common.resolve_tokenizer(args.tokenizer)
    r_model = common.init_retriever(
        common.resolve_encoder_config(args.retriever_model),
        unified=args.unified, checkpoint=args.retriever_checkpoint,
        device=device)
    h2b, h2f = common.resolve_hop2_tiling(
        args, args.batch_size * args.beam_size, args.max_q_sp_len)
    cfg = SearchConfig(beam_size_1=args.beam_size, beam_size_2=args.beam_size,
                       topk=args.topk, max_q_len=args.max_q_len,
                       max_q_sp_len=args.max_q_sp_len,
                       hop2_buckets=h2b, hop2_tile_fracs=h2f,
                       hop2_prune_margin=args.hop2_prune_margin,
                       chunk_rows=args.chunk_rows)
    searcher = load_searcher(args.index_dir, r_tok, r_model, cfg, device,
                             unified=args.unified)
    corpus = Corpus.from_id2doc(os.path.join(args.index_dir, "id2doc.json"))

    with open(args.raw_data) as f:
        items = [json.loads(l) for l in f if l.strip()]

    t0 = time.time()
    chains = retrieve_chains(searcher, r_tok, corpus,
                             [r["question"] for r in items],
                             args.batch_size, args.max_q_len,
                             stop_threshold=(args.stop_threshold
                                             if args.unified else None))
    t_retr = time.time() - t0
    logger.info("retrieval: %d questions in %.2fs (%.1f q/s)",
                len(items), t_retr, len(items) / t_retr)

    r_cfg, reader = common.init_reader(
        args.reader_model, args.reader_checkpoint, sp_pred=True,
        scores_dtype="bfloat16" if args.reader_bf16_scores else "float32",
        device=device)
    q_tok = common.resolve_reader_tokenizer(
        args.reader_tokenizer or args.tokenizer, r_cfg)
    rows = [{"question": r["question"], "_id": r.get("_id", str(i)),
             "answer": r.get("answer", []), "candidate_chains": chains[i]}
            for i, r in enumerate(items)]
    ds = QADataset(q_tok, rows, max_seq_len=args.max_seq_len, train=False)
    pred_step = TQA.make_qa_predict_step(reader, max_ans_len=args.max_ans_len)
    rank_step = TQA.make_qa_rank_step(reader) if args.rank_topm else None
    t1 = time.time()
    res = predict(pred_step, ds, batch_size=16, lambdas=[args.lam],
                  rank_step=rank_step, rank_topm=args.rank_topm,
                  rank_width=args.rank_width)
    t_read = time.time() - t1
    logger.info("reading: %.2fs", t_read)

    answers = res["best"]["answers"]
    ems, f1s = [], []
    for i, r in enumerate(items):
        qid = r.get("_id", str(i))
        if r.get("answer"):
            pred = answers.get(qid, "")
            ems.append(float(exact_match_score(pred, r["answer"][0])))
            f1s.append(f1_score(pred, r["answer"][0])[0])
    out = {"n": len(items),
           "retrieval_qps": len(items) / t_retr,
           "answer_em": float(np.mean(ems)) if ems else None,
           "answer_f1": float(np.mean(f1s)) if f1s else None}
    logger.info("end2end: %s", out)
    print(json.dumps(out))

    if args.save_path and common.is_primary():
        with open(args.save_path, "w") as f:
            for i, r in enumerate(items):
                qid = r.get("_id", str(i))
                f.write(json.dumps({"_id": qid, "question": r["question"],
                                    "pred_answer": answers.get(qid, ""),
                                    "pred_sp": res["best"]["sp"].get(qid, [])})
                        + "\n")
    return out


if __name__ == "__main__":
    main()
