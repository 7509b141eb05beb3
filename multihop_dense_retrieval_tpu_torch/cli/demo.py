"""Interactive multi-hop QA demo, and the pipeline the HTTP server serves.

The port of the JAX package's ``cli/demo.py``: ``DemoPipeline`` holds the
retriever, the live 2-hop engine over an index directory, the host doc
table and the reader.  ``answer_batch`` runs one search and one reader
pass for a list of questions (the server's micro-batch), ``retrieve_batch``
the search alone, and ``add_document`` / ``delete_document`` update the
live engine.  Everything runs on CUDA unless ``--device`` names another
device.  ``--unified`` serves variable-hop chains: a chain whose stop
probability exceeds ``--stop-threshold`` is one passage.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.demo INDEX_DIR \\
      --tokenizer hash --retriever-model tiny --reader-model tiny \\
      [--question "..."]
"""

import argparse
import json
import time
import unicodedata

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..data.corpus import Corpus, TokenizedCorpus
from ..data.qa_dataset import QADataset
from ..eval.qa_eval import predict
from ..train import qa as TQA
from . import common
from .end2end import retrieve_chains
from .eval_mhop_retrieval import load_searcher


class DemoPipeline:
    def __init__(self, args):
        self.device = resolve_device(getattr(args, "device", None))
        self.r_tok = common.resolve_tokenizer(args.tokenizer)
        unified = getattr(args, "unified", False)
        self.stop_threshold = (getattr(args, "stop_threshold", 0.5)
                               if unified else None)
        r_model = common.init_retriever(
            common.resolve_encoder_config(args.retriever_model),
            unified=unified, checkpoint=args.retriever_checkpoint,
            device=self.device)
        # hop-2 rows per search = micro-batch x beam (the server pads to
        # max_batch; the REPL runs single questions)
        h2b, h2f = common.resolve_hop2_tiling(
            args, getattr(args, "max_batch", 1) * args.beam_size,
            args.max_q_sp_len)
        cfg = SearchConfig(beam_size_1=args.beam_size,
                           beam_size_2=args.beam_size, topk=args.topk,
                           max_q_len=args.max_q_len,
                           max_q_sp_len=args.max_q_sp_len,
                           chunk_rows=args.chunk_rows,
                           hop2_buckets=h2b, hop2_tile_fracs=h2f,
                           hop2_prune_margin=getattr(args, "hop2_prune_margin",
                                                     0.0),
                           use_pca=getattr(args, "pca", False),
                           pca_k_chunks=getattr(args, "pca_k_chunks", 8))
        self.searcher = load_searcher(args.index_dir, self.r_tok, r_model,
                                      cfg, self.device, unified=unified)
        self.corpus = Corpus.from_id2doc(f"{args.index_dir}/id2doc.json")
        r_cfg, self.reader = common.init_reader(
            args.reader_model, args.reader_checkpoint, sp_pred=True,
            scores_dtype=("bfloat16"
                          if getattr(args, "reader_bf16_scores", False)
                          else "float32"),
            device=self.device)
        # the reader's vocabulary differs from the retriever's (electra
        # wordpiece vs roberta BPE): --reader-tokenizer falls back to the
        # retriever flag only for the hash test tokenizer
        self.q_tok = common.resolve_reader_tokenizer(
            getattr(args, "reader_tokenizer", "") or args.tokenizer, r_cfg)
        self.pred_step = TQA.make_qa_predict_step(
            self.reader, max_ans_len=args.max_ans_len)
        self.rank_kw = {}
        if getattr(args, "rank_topm", 0):
            self.rank_kw = dict(
                rank_step=TQA.make_qa_rank_step(self.reader),
                rank_topm=args.rank_topm,
                rank_width=getattr(args, "rank_width", 128))
        self.max_c_len = getattr(args, "max_c_len", 300)
        self.args = args

    # ---- live corpus updates (serving) --------------------------------

    def encode_passage(self, title: str, text: str) -> np.ndarray:
        """(1, D) fp32 vector of one passage, title ⊕ text as the corpus
        encoder assembles it."""
        enc = self.r_tok.encode_batch_pair([(title, text)], self.max_c_len)
        dev = self.device
        tt = enc.get("token_type_ids")
        with torch.inference_mode():
            vec = self.searcher.encode_fn(
                torch.from_numpy(enc["input_ids"]).to(dev),
                torch.from_numpy(enc["attention_mask"]).to(dev),
                None if tt is None else torch.from_numpy(tt).to(dev))
        return vec.float().cpu().numpy()

    def add_document(self, title: str, text: str) -> int:
        """Add one document to the live engine (index + token store + host
        doc table), searchable by the next request.  Returns its doc id."""
        row = {"title": unicodedata.normalize("NFD", title.strip()),
               "text": text.strip()}
        nc = Corpus([row])
        width = int(self.searcher.text_ids.shape[1])
        ntc = TokenizedCorpus.build(nc, self.r_tok, max_text_len=width)
        vec = self.encode_passage(row["title"], nc.encode_text(0))
        ids = self.searcher.add_docs(vec, ntc.text_ids, ntc.text_lens,
                                     ntc.empty)
        self.corpus.docs.append(row)
        return ids[0]

    def delete_document(self, doc_id: int):
        """Swap-delete a document from the live engine; keeps the host doc
        table in the same order as the device store."""
        if not 0 <= doc_id < len(self.corpus.docs):
            raise IndexError(f"doc_id {doc_id} out of range")
        moved = self.searcher.delete_doc(doc_id)
        if moved is not None:
            self.corpus.docs[doc_id] = self.corpus.docs[moved]
        self.corpus.docs.pop()
        return moved

    def _chains(self, questions, pad_to):
        return retrieve_chains(self.searcher, self.r_tok, self.corpus,
                               questions, pad_to or len(questions),
                               self.args.max_q_len,
                               stop_threshold=self.stop_threshold)

    def answer_batch(self, questions, pad_to=None):
        """Answer a list of questions with one 2-hop search and one reader
        pass, the unit the server's micro-batcher feeds; ``pad_to`` fixes
        the search batch (a short batch is padded with its last question).
        Returns one result dict per question."""
        t0 = time.time()
        all_chains = self._chains(questions, pad_to)
        t1 = time.time()
        rows = [{"question": q, "_id": f"q{i}", "answer": [],
                 "candidate_chains": ch}
                for i, (q, ch) in enumerate(zip(questions, all_chains))]
        ds = QADataset(self.q_tok, rows, max_seq_len=self.args.max_seq_len,
                       train=False)
        n_chains = sum(len(c) for c in all_chains)
        res = predict(self.pred_step, ds,
                      batch_size=max(min(n_chains, 32), 1),
                      lambdas=[self.args.lam], **self.rank_kw)
        t2 = time.time()
        return [{
            "answer": res["best"]["answers"].get(f"q{i}", ""),
            "supporting": res["best"]["sp"].get(f"q{i}", []),
            "chains": [[p["title"] for p in c] for c in chains],
            "retrieval_s": t1 - t0,
            "reading_s": t2 - t1,
        } for i, chains in enumerate(all_chains)]

    def retrieve_batch(self, questions, pad_to=None):
        """Retrieval only: one 2-hop search, no reader (the /retrieve
        endpoint)."""
        t0 = time.time()
        all_chains = self._chains(questions, pad_to)
        dt = time.time() - t0
        return [{"chains": [[p["title"] for p in c] for c in chains],
                 "retrieval_s": dt}
                for chains in all_chains]

    def answer(self, question: str):
        return self.answer_batch([question])[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    common.add_pipeline_args(p)
    p.add_argument("--question", default="",
                   help="answer one question and exit (non-interactive)")
    args = p.parse_args(argv)

    pipe = DemoPipeline(args)
    if args.question:
        out = pipe.answer(args.question)
        print(json.dumps(out))
        return out

    print("multi-hop QA demo — type a question (empty line to quit)")
    while True:
        try:
            q = input("Q: ").strip()
        except EOFError:
            break
        if not q:
            break
        out = pipe.answer(q)
        print(f"A: {out['answer']}")
        print(f"   chains: {out['chains'][:3]}")
        print(f"   sp: {out['supporting']}")
        print(f"   ({out['retrieval_s']:.2f}s retrieve, "
              f"{out['reading_s']:.2f}s read)")


if __name__ == "__main__":
    main()
