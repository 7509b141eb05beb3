"""CLI: bulk-encode a corpus into the dense index and the tokenized store.

The port of the JAX package's ``cli/encode_corpus.py``, writing the same
three artifacts, which both packages' eval CLIs read:
  <out>/index.npz      — DenseIndex (bf16, fp32 or int8; chunk-aligned)
  <out>/tokens.npz     — TokenizedCorpus (uint16 ids) for on-device hop 2
  <out>/id2doc.json    — row → {title, text}
It runs on CUDA unless ``--device`` names another device.  The encoder is
the ``--model-name`` preset; a caller that wants kernel 8 builds the
retriever from ``EncoderConfig(attention_impl="fused")`` and calls
``index.build.build_index`` (the CLI has no flag for it, as in JAX).
``--unified`` encodes passages with a UnifiedRetriever's ``encode_seq``
(for the variable-hop serving of ``eval_mhop_retrieval --unified``).
Each batch is split over ``--data-parallel`` devices (default: every
visible card for the bare ``cuda``; a named device such as ``cpu`` is
repeated).  Under ``cli/pod`` with more than one process, every process
encodes slice ``rank`` of ``world size`` slices, all meet at a barrier, and
rank 0 merges them (``index/shards.py``).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.encode_corpus \\
      CORPUS.jsonl OUT_DIR --tokenizer hash --model-name tiny \\
      [--checkpoint ckpt.pt] [--device cuda]
"""

import argparse
import os

import numpy as np
import torch

from ..core.device import resolve_device, world
from ..core.mesh import local_devices, make_mesh
from ..data.corpus import Corpus, TokenizedCorpus
from ..index import shards as sh
from ..index.build import encode_corpus
from ..index.store import DenseIndex
from ..models import MultiVectorCtxEncoder
from . import common


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("corpus", help="JSONL with {title, text} per line")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: the kernels' plain "
                        "versions)")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--max-c-len", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--index-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="int8 halves device memory against bf16 (per-row "
                        "symmetric scales)")
    p.add_argument("--max-docs", type=int, default=None)
    p.add_argument("--no-length-sort", action="store_true",
                   help="disable length-sorted bucketed encoding (exact "
                        "either way; sorting is the fast path)")
    p.add_argument("--pca-dims", type=int, default=None,
                   help="build a PCA prefilter of this rank alongside the "
                        "index (search with eval --pca)")
    p.add_argument("--pca-cand-rows", type=int, default=512,
                   help="candidate-chunk granularity of the prefilter "
                        "(multiple of 128, divides chunk-rows)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="devices on the data axis (default: every visible "
                        "card for the bare cuda, else 1)")
    p.add_argument("--multi-vector", type=int, default=1,
                   help=">1: encode each passage into N grouped index rows "
                        "(models/retriever.py::MultiVectorCtxEncoder); "
                        "search collapses rows to docs by max-over-vectors")
    p.add_argument("--mv-scheme", default="tokenwise",
                   choices=["tokenwise", "layerwise"])
    p.add_argument("--unified", action="store_true",
                   help="encode with a UnifiedRetriever checkpoint "
                        "(variable-hop serving, see eval --unified)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="split the corpus into N contiguous slices; this "
                        "invocation encodes one slice (see --shard-id) and "
                        "writes a shard artifact instead of the final index "
                        "(merge with --merge-only)")
    p.add_argument("--shard-id", type=int, default=None,
                   help="which slice to encode (default 0)")
    p.add_argument("--merge-only", action="store_true",
                   help="skip encoding; merge existing shard artifacts in "
                        "OUT_DIR into index.npz/tokens.npz/id2doc.json")
    p.add_argument("--keep-shards", action="store_true",
                   help="keep the per-shard artifacts after merging")
    p.add_argument("--export-npy", action="store_true",
                   help="also write wiki_index.npy, the reference's raw fp32 "
                        "embedding matrix (np.load + FAISS add there); "
                        "single-host only (not --num-shards)")
    args = p.parse_args(argv)
    if args.export_npy and (args.num_shards > 1 or args.merge_only):
        p.error("--export-npy requires the single-host encode path (each "
                "shard only holds its slice and merged artifacts are "
                "already quantized); re-encode without --num-shards/"
                "--merge-only to export")
    if args.export_npy and args.multi_vector > 1:
        p.error("--export-npy is the reference's one-row-per-doc FAISS "
                "format; a multi-vector matrix (N rows per doc) would "
                "silently misalign with id2doc.json there")

    device = resolve_device(args.device)
    logger = common.setup_logging(args.out_dir)
    build_kw = dict(chunk_rows=args.chunk_rows, dtype=args.index_dtype,
                    multi_vector=args.multi_vector, pca_dims=args.pca_dims,
                    pca_cand_rows=args.pca_cand_rows, device=device)
    if args.merge_only:
        index = sh.merge_shards(args.out_dir,
                                args.num_shards if args.num_shards > 1
                                else None,
                                keep_shards=args.keep_shards, **build_kw)
        logger.info("merged shards: index (%d docs, padded %d) in %s",
                    index.n_docs, index.vectors.shape[0], args.out_dir)
        return

    # pod mode: every process encodes its own slice on its own devices,
    # then rank 0 merges after a barrier
    rank, size = world()
    pod = size > 1
    num_shards = args.num_shards
    if pod and num_shards == 1:
        num_shards = size
    if args.export_npy and num_shards > 1:
        # pod auto-sharding resolves after argparse: fail as loudly here
        raise SystemExit(
            "--export-npy cannot run on the sharded (pod) encode path; "
            "encode on one process to export the reference matrix")
    shard_id = rank if args.shard_id is None else args.shard_id

    cfg = common.resolve_encoder_config(args.model_name)
    tok = common.resolve_tokenizer(args.tokenizer)
    model = common.init_retriever(cfg, unified=args.unified,
                                  checkpoint=args.checkpoint, device=device)

    logger.info("loading corpus %s", args.corpus)
    corpus = Corpus.from_jsonl(args.corpus, max_docs=args.max_docs)
    if num_shards > 1:
        lo, hi = sh.shard_bounds(len(corpus), num_shards, shard_id)
        logger.info("shard %d/%d: docs [%d, %d)", shard_id, num_shards,
                    lo, hi)
        corpus = Corpus(corpus.docs[lo:hi])
    logger.info("tokenizing %d docs", len(corpus))
    tc = TokenizedCorpus.build(corpus, tok, max_text_len=args.max_c_len)

    encode_fn = model.encode_seq
    if args.multi_vector > 1:
        # the multi-vector encoder shares the retriever's transformer stack
        # and projection head: corpus rows must live in the projected space
        # of the query vectors they are scored against
        mv_model = MultiVectorCtxEncoder(cfg, multi_vector=args.multi_vector,
                                         scheme=args.mv_scheme)
        mv_model.load_state_dict({
            k: v for k, v in model.state_dict().items()
            if k.startswith(("encoder.", "project."))})
        encode_fn = mv_model.to(device).eval()

    local = local_devices(device, args.data_parallel or 1)
    mesh = make_mesh(data=args.data_parallel or len(local), index=1,
                     devices=local)
    logger.info("encoding on %s", mesh)
    emb = encode_corpus(encode_fn, tc, tok.spec, max_c_len=args.max_c_len,
                        batch_size=args.batch_size, mesh=mesh, progress=True,
                        multi_vector=args.multi_vector,
                        length_sort=not args.no_length_sort)
    if num_shards > 1:
        sh.save_shard(args.out_dir, shard_id, num_shards, emb, tc, corpus)
        logger.info("wrote shard %d/%d (%d docs) to %s", shard_id,
                    num_shards, len(corpus), args.out_dir)
        if not pod:
            logger.info("encode the remaining shards, then run with "
                        "--merge-only to produce the final index")
            return
        torch.distributed.barrier()
        if rank == 0:
            index = sh.merge_shards(args.out_dir, num_shards,
                                    keep_shards=args.keep_shards, **build_kw)
            logger.info("merged %d shards: index (%d docs, padded %d)",
                        num_shards, index.n_docs, index.vectors.shape[0])
        return

    os.makedirs(args.out_dir, exist_ok=True)
    if args.export_npy:
        # raw fp32, unpadded, unquantized: what the reference's
        # np.load(index_path) + index.add(xb) expects
        np.save(os.path.join(args.out_dir, "wiki_index.npy"), emb)
        logger.info("wrote wiki_index.npy %s (reference FAISS format)",
                    emb.shape)
    index = DenseIndex.build(emb, **build_kw)
    index.save(os.path.join(args.out_dir, "index.npz"))
    tc.save(os.path.join(args.out_dir, "tokens.npz"))
    corpus.save_id2doc(os.path.join(args.out_dir, "id2doc.json"))
    logger.info("wrote index (%d docs, padded %d) to %s",
                index.n_docs, index.vectors.shape[0], args.out_dir)


if __name__ == "__main__":
    main()
