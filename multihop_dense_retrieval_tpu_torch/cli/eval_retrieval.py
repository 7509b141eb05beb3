"""CLI: single-hop retrieval eval with answer-recall@k.

The port of the JAX package's ``cli/eval_retrieval.py`` (the reference's
scripts/eval/eval_retrieval.py): encode questions (or FEVER claims), take
the exact top-k over the index, then answer recall @ {1,5,10,20,50,100} by
token-subsequence matching in a thread pool of ``SimpleTokenizer``
matchers.  Rows that carry ``sp`` gold titles also get SP recall@k.  It
runs on CUDA unless ``--device`` names another device.

The search is ``ops/mips.py::mips_topk``: k < 8 scans with kernel 1 (int8)
or 2 (bf16); k >= 8 over rows that tile the chunk (``--chunk-rows``, then
``two_phase_chunk``) takes the two-phase search, kernels 7 + 4 (int8) or
6 + 5 (bf16).  A CUDA index whose rows do not tile raises for k > 8.
``--pca`` takes ``mips_topk_pca`` (kernel 3, then 4 or 5) and logs the
certified share.  The JAX CLI's ``pick_pca_step_rows`` is a TPU tiling
rule and has no counterpart here.  Multi-vector indexes fetch
``topk * m`` rows and collapse them to documents (``merge_multivector``).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.eval_retrieval \\
      QAS.jsonl INDEX_DIR --tokenizer hash --model-name tiny --topk 20 \\
      [--pca] [--save-path retrieved.jsonl] [--device cpu]
"""

import argparse
import concurrent.futures as cf
import json
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.corpus import Corpus
from ..index.store import DenseIndex
from ..ops.mips import merge_multivector, mips_topk, mips_topk_pca
from ..utils.text import SimpleTokenizer, para_has_answer
from . import common


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("raw_data",
                   help="eval JSONL: question (or FEVER claim)/answer per line")
    p.add_argument("index_dir")
    common.add_device_arg(p)
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-q-len", type=int, default=50)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--pca", action="store_true",
                   help="PCA-prefiltered MIPS (index built with --pca-dims); "
                        "certified fraction reported")
    p.add_argument("--pca-k-chunks", type=int, default=16)
    p.add_argument("--save-path", default="")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    logger = common.setup_logging()
    tok = common.resolve_tokenizer(args.tokenizer)
    model = common.init_retriever(
        common.resolve_encoder_config(args.model_name),
        checkpoint=args.checkpoint, device=device)
    index = DenseIndex.load(os.path.join(args.index_dir, "index.npz"),
                            device=device)
    corpus = Corpus.from_id2doc(os.path.join(args.index_dir, "id2doc.json"))

    with open(args.raw_data) as f:
        items = [json.loads(l) for l in f if l.strip()]

    if args.pca and index.pca_proj is None:
        p.error("--pca needs an index built with encode_corpus --pca-dims")
    use_pca = args.pca
    n_pad = index.vectors.shape[0]
    if use_pca and n_pad // index.pca_cand_rows < 2:
        # the engine's guard: a single candidate chunk leaves nothing
        # unselected for the certificate, and mips_topk_pca needs
        # k_chunks < chunks
        logger.info("--pca: index too small for the prefilter "
                    "(single candidate chunk); using exact search")
        use_pca = False
    # multi-vector indexes: fetch topk*m ROWS, collapse to topk DOCS
    mv = index.multi_vector
    k_rows = args.topk * mv

    all_ids = []
    cert_hits = cert_total = 0
    t0 = time.time()
    bs = args.batch_size
    with torch.inference_mode():
        for s in range(0, len(items), bs):
            batch = items[s:s + bs]
            pad = bs - len(batch)
            qs = [r.get("question", r.get("claim", "")) for r in batch]
            qs = [q[:-1] if q.endswith("?") else q for q in qs]
            enc = tok.encode_batch_one(qs + [qs[-1]] * pad, args.max_q_len)
            vecs = model.encode_seq(
                torch.from_numpy(enc["input_ids"]).to(device),
                torch.from_numpy(enc["attention_mask"]).to(device))
            if use_pca:
                cand = index.pca_cand_rows
                kc = max(1, min(args.pca_k_chunks, n_pad // cand - 1))
                vals, ids, cert = mips_topk_pca(
                    index.vectors, index.pca_proj, index.pca_rot,
                    index.pca_bounds, vecs.float(), k_rows, k_chunks=kc,
                    cand_rows=cand, n_valid=index.n_docs,
                    doc_scales=index.scales)
                c = cert[: len(batch)].cpu().numpy()
                cert_hits += int(c.sum())
                cert_total += c.size
            else:
                # int8 indexes: queries stay fp32 (the search quantizes
                # them itself) and the row scales ride along; casting the
                # queries to int8 would truncate them
                qdt = (torch.float32 if index.scales is not None
                       else index.vectors.dtype)
                vals, ids = mips_topk(index.vectors, vecs.to(qdt), k_rows,
                                      chunk_rows=args.chunk_rows,
                                      n_valid=index.n_docs,
                                      doc_scales=index.scales)
            if mv > 1:
                _, ids = merge_multivector(vals, ids, args.topk, mv)
            all_ids.append(ids[: len(batch)].cpu().numpy())
    all_ids = np.concatenate(all_ids)
    dt = time.time() - t0
    logger.info("retrieved %d questions in %.2fs (%.1f q/s)",
                len(items), dt, len(items) / dt)
    if cert_total:
        logger.info("pca exactness certificates: %.1f%% provably exact "
                    "top-%d", 100.0 * cert_hits / cert_total, args.topk)

    simple = SimpleTokenizer()
    ks = [k for k in (1, 5, 10, 20, 50, 100) if k <= args.topk]

    def recall_row(i):
        row = items[i]
        answers = row.get("answer", row.get("answers", []))
        if isinstance(answers, str):
            # a bare string would be matched character by character
            answers = [answers]
        sp = set(row.get("sp", []))
        hits, sp_hits = {}, {}
        found, sp_found = False, False
        for rank, doc_id in enumerate(all_ids[i]):
            doc = corpus[int(doc_id)]
            if not found and answers and para_has_answer(
                    answers, doc["title"] + " " + doc["text"], simple):
                found = True
                first = rank
            if not sp_found and sp and doc["title"] in sp:
                sp_found = True
                sp_first = rank
        for k in ks:
            hits[k] = int(found and first < k) if answers else None
            sp_hits[k] = int(sp_found and sp_first < k) if sp else None
        return hits, sp_hits

    with cf.ThreadPoolExecutor(args.num_workers) as pool:
        results = list(pool.map(recall_row, range(len(items))))

    out = {}
    for k in ks:
        ans = [r[0][k] for r in results if r[0][k] is not None]
        sps = [r[1][k] for r in results if r[1][k] is not None]
        if ans:
            out[f"answer_recall@{k}"] = float(np.mean(ans))
        if sps:
            out[f"sp_recall@{k}"] = float(np.mean(sps))
    out["qps"] = len(items) / dt
    logger.info("metrics: %s", out)
    print(json.dumps(out))

    if args.save_path and common.is_primary():
        with open(args.save_path, "w") as f:
            for i, row in enumerate(items):
                f.write(json.dumps({
                    "question": row.get("question", row.get("claim", "")),
                    "retrieved": [corpus[int(d)]["title"] for d in all_ids[i]],
                }) + "\n")
    return out


if __name__ == "__main__":
    main()
