"""CLI: golden-parity check against the reference's published numbers.

The port of the JAX package's ``cli/parity.py``; the retrieval block runs
the port's ``cli/eval_mhop_retrieval`` and the QA block the port's reader
through ``eval/qa_eval.py::predict``, on CUDA unless ``--device`` names
another device.

One command that takes the reference's released artifacts (README.md:38-45:
`models/q_encoder.pt`, `data/hotpot_index/wiki_index.npy`,
`data/hotpot_index/wiki_id2doc.json`, `data/hotpot/hotpot_qas_val.json`),
runs the beam-1/top-1 retrieval eval, and compares the metric block against
the table hard-coded from the reference README (README.md:74-92).  With the
optional reader artifacts (`qa_electra.pt` + a retrieved-chains predict
file) it also checks the QA block (README.md:118-129).

When artifacts are missing it reports exactly which, and exits 2 — this
environment has no network egress, so the download itself
(`scripts/download_hotpot.sh` upstream) must have happened elsewhere.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.parity --data-dir DATA \
      --tokenizer /path/to/roberta-base [--tol 0.01]

DATA layout (reference download layout; every path individually overridable):
  DATA/models/q_encoder.pt
  DATA/data/hotpot_index/wiki_index.npy
  DATA/data/hotpot_index/wiki_id2doc.json
  DATA/data/hotpot/hotpot_qas_val.json
  DATA/models/qa_electra.pt                      (optional, QA block)
  DATA/data/hotpot/dev_retrieval_top100_sp.json  (optional, QA block)
"""

import argparse
import json
import os
import sys

# Reference README.md:74-92 (beam-1 / top-1 retrieval on hotpot_qas_val).
EXPECTED_RETRIEVAL = {
    "overall": {"n": 7405,
                "avg_pr": 0.8428089128966915,
                "avg_p_em": 0.6592842673869007,
                "avg_1_recall": 0.7906819716407832,
                "path_recall": 0.6592842673869007},
    "comparison": {"n": 1487,
                   "avg_pr": 0.9932750504371217,
                   "avg_p_em": 0.9482178883658372,
                   "avg_1_recall": 0.9643577673167452,
                   "path_recall": 0.9482178883658372},
    "bridge": {"n": 5918,
               "avg_pr": 0.805001689760054,
               "avg_p_em": 0.5866846907739101,
               "avg_1_recall": 0.7470429199053734,
               "path_recall": 0.5866846907739101},
}

# Reference README.md:118-129 (ELECTRA-large reader at lambda 0.8 on the
# top-100 retrieved chains).
EXPECTED_QA = {
    "em": 0.6233625928426739,
    "f1": 0.7504594111976622,
    "sp_em": 0.5654287643484133,
    "sp_f1": 0.7942837708469039,
    "joint_em": 0.42052667116812964,
    "joint_f1": 0.6631669237532106,
}


def _artifact_paths(args):
    d = args.data_dir
    return {
        "checkpoint": args.checkpoint
        or os.path.join(d, "models", "q_encoder.pt"),
        "wiki_index": args.wiki_index
        or os.path.join(d, "data", "hotpot_index", "wiki_index.npy"),
        "id2doc": args.id2doc
        or os.path.join(d, "data", "hotpot_index", "wiki_id2doc.json"),
        "qas_val": args.qas_val
        or os.path.join(d, "data", "hotpot", "hotpot_qas_val.json"),
    }


def compare_block(got: dict, expected: dict, tol: float, label: str):
    """Returns a list of (metric, got, expected, ok) rows."""
    rows = []
    for key, exp in expected.items():
        g = got.get(key)
        if key == "n":
            ok = g == exp
        else:
            ok = g is not None and abs(g - exp) <= tol
        rows.append((f"{label}.{key}", g, exp, ok))
    return rows


def prepare_index_dir(paths, cache_dir, tokenizer, max_c_len, logger,
                      device=None):
    """Assemble an encode_corpus-style index dir from reference artifacts:
    wiki_index.npy → index.npz (bf16 chunk-aligned, built on ``device``),
    wiki_id2doc.json → tokens.npz (the on-device hop-2 token store) +
    id2doc.json."""
    import numpy as np

    from ..data.corpus import Corpus, TokenizedCorpus
    from ..index.store import DenseIndex

    os.makedirs(cache_dir, exist_ok=True)
    index_npz = os.path.join(cache_dir, "index.npz")
    tokens_npz = os.path.join(cache_dir, "tokens.npz")
    id2doc_json = os.path.join(cache_dir, "id2doc.json")

    # cache fingerprint: existence alone would silently reuse artifacts
    # built with a DIFFERENT tokenizer / budget / source files and score
    # hop-2 reranking against wrong tokens
    def _mtime(path):
        try:
            return os.path.getmtime(path)
        except OSError:
            return None

    spec = getattr(tokenizer, "spec", None)
    fingerprint = {
        "tokenizer": repr(spec) if spec is not None else type(tokenizer).__name__,
        "max_c_len": max_c_len,
        "wiki_index": [paths["wiki_index"], _mtime(paths["wiki_index"])],
        "id2doc": [paths["id2doc"], _mtime(paths["id2doc"])],
    }
    fp_path = os.path.join(cache_dir, "cache_fingerprint.json")
    stale = True
    if os.path.exists(fp_path):
        with open(fp_path) as f:
            stale = json.load(f) != fingerprint
    if stale:
        for f_ in (index_npz, tokens_npz, id2doc_json):
            if os.path.exists(f_):
                logger.info("cache fingerprint changed — rebuilding %s", f_)
                os.remove(f_)
        with open(fp_path, "w") as f:
            json.dump(fingerprint, f)

    if not os.path.exists(id2doc_json):
        logger.info("ingesting id2doc %s", paths["id2doc"])
        corpus = Corpus.from_id2doc(paths["id2doc"])
        corpus.save_id2doc(id2doc_json)
    else:
        corpus = Corpus.from_id2doc(id2doc_json)
    if not os.path.exists(tokens_npz):
        logger.info("tokenizing %d docs (cached to %s)", len(corpus),
                    tokens_npz)
        tc = TokenizedCorpus.build(corpus, tokenizer, max_text_len=max_c_len)
        tc.save(tokens_npz)
    if not os.path.exists(index_npz):
        logger.info("ingesting wiki_index %s", paths["wiki_index"])
        idx = DenseIndex.build(np.load(paths["wiki_index"], mmap_mode="r"),
                               dtype="bfloat16", device=device)
        idx.save(index_npz)
    return cache_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default="data",
                   help="root of the reference download layout")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--checkpoint", default="", help="q_encoder.pt override")
    p.add_argument("--wiki-index", default="", help="wiki_index.npy override")
    p.add_argument("--id2doc", default="", help="wiki_id2doc.json override")
    p.add_argument("--qas-val", default="",
                   help="hotpot_qas_val.json override")
    p.add_argument("--tokenizer", default="roberta-base",
                   help="LOCAL HF tokenizer path (no network egress)")
    p.add_argument("--cache-dir", default="",
                   help="where to cache the assembled index dir "
                        "(default <data-dir>/mdrt_parity_cache)")
    p.add_argument("--tol", type=float, default=0.01,
                   help="absolute metric tolerance (bf16 vs fp16 numerics + "
                        "tie-ordering differences)")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--max-c-len", type=int, default=300)
    p.add_argument("--qa-checkpoint", default="",
                   help="qa_electra.pt (optional QA parity block)")
    p.add_argument("--qa-predict-file", default="",
                   help="dev_retrieval_top100_sp.json (optional QA block)")
    p.add_argument("--qa-model", default="electra-large",
                   help="reader preset (tests use 'tiny')")
    p.add_argument("--qa-tokenizer", default="",
                   help="LOCAL tokenizer path for the READER (ELECTRA uses "
                        "wordpiece, not the retriever's roberta BPE); "
                        "defaults to --tokenizer, which is only correct for "
                        "the hash test tokenizer")
    args = p.parse_args(argv)

    from ..core.device import resolve_device
    from . import common

    logger = common.setup_logging()
    paths = _artifact_paths(args)
    missing = {k: v for k, v in paths.items() if not os.path.exists(v)}
    if missing:
        print("PARITY: cannot run — missing reference artifacts:")
        for k, v in missing.items():
            print(f"  {k:<12} expected at {v}")
        print("Fetch them with the reference's scripts/download_hotpot.sh "
              "(zero-egress environments must stage them manually), then "
              "re-run with --data-dir or per-artifact overrides.")
        sys.exit(2)

    device = resolve_device(args.device)
    cache = args.cache_dir or os.path.join(args.data_dir,
                                           "mdrt_parity_cache")
    tok = common.resolve_tokenizer(args.tokenizer)
    prepare_index_dir(paths, cache, tok, args.max_c_len, logger, device)

    from .eval_mhop_retrieval import main as eval_main

    agg, _ = eval_main([paths["qas_val"], cache, "--device", args.device,
                        "--tokenizer", args.tokenizer,
                        "--model-name", "roberta-base",
                        "--checkpoint", paths["checkpoint"],
                        "--beam-size", "1", "--topk", "1",
                        "--batch-size", str(args.batch_size)])
    if agg is None:
        print("PARITY: the eval produced no metrics — the qas file's rows "
              "carry no 'sp' annotations (is this hotpot_qas_val.json?).")
        sys.exit(2)

    rows = []
    for scope, block in EXPECTED_RETRIEVAL.items():
        rows += compare_block(agg.get(scope, {}), block, args.tol, scope)

    if args.qa_checkpoint and args.qa_predict_file:
        qa_metrics = run_qa_block(args, logger)
        rows += compare_block(qa_metrics, EXPECTED_QA, args.tol, "qa")
    elif args.qa_checkpoint or args.qa_predict_file:
        logger.info("QA block skipped: need BOTH --qa-checkpoint and "
                    "--qa-predict-file")

    ok_all = True
    print(f"{'metric':<28} {'got':>12} {'expected':>12}  status")
    for name, got, exp, ok in rows:
        ok_all &= ok
        g = "missing" if got is None else (
            f"{got:.4f}" if isinstance(got, float) else str(got))
        e = f"{exp:.4f}" if isinstance(exp, float) else str(exp)
        print(f"{name:<28} {g:>12} {e:>12}  {'OK' if ok else 'FAIL'}")
    print(json.dumps({"parity": "PASS" if ok_all else "FAIL",
                      "tol": args.tol}))
    if not ok_all:
        sys.exit(1)


def run_qa_block(args, logger):
    """Reader parity: score the reference's retrieved-chains file with the
    converted ELECTRA reader at the fixed serving lambda 0.8."""
    from ..data.qa_dataset import QADataset
    from ..eval.qa_eval import predict
    from ..train import qa as TQA
    from . import common

    qa_tok_spec = getattr(args, "qa_tokenizer", "") or args.tokenizer
    if qa_tok_spec == args.tokenizer and args.tokenizer != "hash":
        logger.warning("QA block tokenizing with the retriever tokenizer "
                       "(%s); pass --qa-tokenizer for the reader's own "
                       "(ELECTRA wordpiece) vocabulary", args.tokenizer)
    cfg, model = common.init_reader(args.qa_model, args.qa_checkpoint,
                                    sp_pred=True,
                                    device=getattr(args, "device", None))
    q_tok = common.resolve_reader_tokenizer(qa_tok_spec, cfg)
    rows = common.load_json_flex(args.qa_predict_file)
    ds = QADataset(q_tok, rows, max_seq_len=512, train=False)
    pred_step = TQA.make_qa_predict_step(model, max_ans_len=30)
    res = predict(pred_step, ds, batch_size=16, lambdas=[0.8])
    return {k: res["best"][k] for k in EXPECTED_QA if k in res["best"]}


if __name__ == "__main__":
    main()
