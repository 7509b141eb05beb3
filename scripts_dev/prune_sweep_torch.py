"""Hop-2 candidate-pruning quality sweep on TRAINED retriever weights, on
the PyTorch port (the port's copy of scripts_dev/prune_sweep.py: the same
data, recipe, margins and result keys; it imports torch, numpy and the
port, nothing of JAX).

Trains a tiny-preset retriever with the port's stage-1 CLI
(cli/train_retriever) on synthetic multi-hop data, encodes the corpus
(cli/encode_corpus), then sweeps SearchConfig.hop2_prune_margin at beam 4
measuring:

  * chain_agreement — fraction of questions whose entire top-k chain
    list is IDENTICAL to the unpruned engine's (gold-free, so it stays
    sensitive where crowding pins the answer metrics near zero);
  * gold_hop1_expanded — gold doc in the hop-1 beam AND unpruned
    (pruning can only hurt quality through this quantity);
  * P-EM (both gold passages in the top-1 chain) and PR vs the unpruned
    engine;
  * the fraction of hop-2 rows pruned at each margin (the speed proxy).

Swept margins: the p25/p50/p75/p90 quantiles of the measured hop-1 gap
distribution, plus the engine's own `--hop2-prune-margin auto` rule
(hop2_prune_margin = -q, the per-batch q-quantile gap) at q 0.5 and 0.9.

The corpus: question keys draw from the first PRUNE_KEYDOCS docs (every
one of whose keys appears in a training question); the rest are filler-
only distractors that crowd the hop-1 score landscape.  Key tokens are
rejection-sampled so each gold key hashes to a unique HashTokenizer id
disjoint from the filler vocabulary.  The default eval set is the train
set (PRUNE_NEVAL=0): the sweep measures whether a margin CHANGES the
engine's output.  The data are byte-equal to the JAX script's for the
same sizes (seed 0).

    python scripts_dev/prune_sweep_torch.py                 # on the card
    PRUNE_DEVICE=cpu PRUNE_NDOCS=256 PRUNE_NTRAIN=16 \\
        python scripts_dev/prune_sweep_torch.py             # CPU smoke

Environment: PRUNE_NDOCS (65536), PRUNE_NTRAIN (512), PRUNE_NEVAL (0),
PRUNE_KEYDOCS (min(1024, docs)), PRUNE_EPOCHS (8), PRUNE_MODEL (mini),
PRUNE_REUSE (a previous run's work directory: sweep only), PRUNE_DEVICE
(cuda; without CUDA the script raises, it never runs on the CPU unless
asked), PRUNE_OUT (the result JSON; default
prune_sweep_torch_result.json in the temp directory).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORDS = [f"w{i}" for i in range(800)]
BEAM, TOPK, BATCH = 4, 4, 16
MAX_Q_LEN, MAX_Q_SP_LEN, RAW_Q_LEN = 24, 80, 76


def _text(rng, key=None, lo=15, hi=40):
    words = list(rng.choice(WORDS, size=rng.randint(lo, hi)))
    if key is not None:
        # plant the key twice, so the gold passage clears the crowd of
        # in-distribution filler docs
        words[rng.randint(0, 4)] = key
        words[len(words) // 2] = key
    return " ".join(words)


def gen_keys(n_key):
    """Collision-aware gold-pool doc keys for the hash tokenizer: every
    key hashes to a UNIQUE id disjoint from the filler WORDS."""
    from multihop_dense_retrieval_tpu_torch.data.tokenization import \
        HashTokenizer
    tok = HashTokenizer()
    taken = {tok._hash_id(w) for w in WORDS}
    keys, gold_ids, i = [], set(), 0
    while len(keys) < n_key:
        w = f"key{i}"
        i += 1
        h = tok._hash_id(w)
        if h in taken or h in gold_ids:
            continue
        gold_ids.add(h)
        keys.append(w)
    return keys


def make_data(work, rng, n_docs=256, n_train=128, n_eval=0, n_key_docs=0):
    """Multi-hop rows whose gold passages carry the question's key tokens,
    over a corpus of distractors; writes corpus.jsonl, mhop.jsonl and
    eval.jsonl into ``work``.  Keys are unique per doc.  When
    ``n_key_docs`` < n_docs, question keys draw only from the first
    n_key_docs docs and the rest are filler-only.  ``n_eval`` > 0 writes a
    separate eval set whose key pairs are disjoint from the training
    pairs.  Returns (paths, docs, eval rows)."""
    n_key_docs = n_key_docs or n_docs
    keys = gen_keys(n_key_docs)
    docs = []
    for i in range(n_docs):
        docs.append({"title": f"D{i}",
                     "text": _text(rng,
                                   key=keys[i] if i < n_key_docs else None)})

    # disjoint pairs: each key doc appears in at most one question and one
    # hop role, so the task is memorisation and the baseline answers
    perm = list(rng.permutation(n_key_docs))

    def make_rows(n_rows, qid_prefix, seen_pairs):
        rows = []
        while len(rows) < n_rows:
            if len(perm) < 2:
                raise SystemExit("need n_key_docs >= 2*(n_train+n_eval) "
                                 "for disjoint question pairs")
            a, b = int(perm.pop()), int(perm.pop())
            seen_pairs.add((a, b))
            i = len(rows)
            k1, k2 = keys[a], keys[b]
            negs = [dict(docs[j])
                    for j in rng.choice(n_docs, 4, replace=False)
                    if j not in (a, b)][:3]
            rows.append({
                "_id": f"{qid_prefix}{i}",
                "question": f"which fact links {k1} with {k2} ?",
                "type": "bridge" if i % 2 == 0 else "comparison",
                "pos_paras": [dict(docs[a]), dict(docs[b])],
                "neg_paras": negs or [dict(docs[(a + 1) % n_docs])],
                "bridge": docs[b]["title"],
                "sp": [docs[a]["title"], docs[b]["title"]],
                "answer": ["yes"],
            })
        return rows

    seen = set()
    rows = make_rows(n_train, "q", seen)
    eval_rows = make_rows(n_eval, "e", seen) if n_eval else rows
    paths = {}
    for name, data in [("corpus", docs), ("mhop", rows),
                       ("eval", eval_rows)]:
        paths[name] = os.path.join(work, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            for r in data:
                f.write(json.dumps(r) + "\n")
    return paths, docs, eval_rows


def _device(device=None):
    from multihop_dense_retrieval_tpu_torch.core.device import resolve_device
    return resolve_device(device or os.environ.get("PRUNE_DEVICE", "cuda"))


def main():
    # PRUNE_REUSE=<workdir>: rerun only the sweep against a previous run's
    # checkpoint and index (the data are regenerated from seed 0, so the
    # PRUNE_* sizes must match that run's)
    device = _device()
    reuse = os.environ.get("PRUNE_REUSE")
    work = reuse or tempfile.mkdtemp(prefix="mdrt_prune_")
    rng = np.random.RandomState(0)
    n_docs = int(os.environ.get("PRUNE_NDOCS", 65536))
    n_train = int(os.environ.get("PRUNE_NTRAIN", 512))
    n_eval = int(os.environ.get("PRUNE_NEVAL", 0))
    n_key = int(os.environ.get("PRUNE_KEYDOCS", 0)) or min(1024, n_docs)
    chunk = min(4096, n_docs)
    paths, docs, rows = make_data(work, rng, n_docs=n_docs, n_train=n_train,
                                  n_eval=n_eval, n_key_docs=n_key)

    stage1 = os.path.join(work, "stage1")
    index_dir = os.path.join(work, "index")
    if reuse:
        assert os.path.exists(os.path.join(stage1, "checkpoint_best.pt")), \
            f"PRUNE_REUSE={reuse} has no trained checkpoint"
        assert os.path.isdir(index_dir), \
            f"PRUNE_REUSE={reuse} has no encoded index"
        print(f"== reusing trained artifacts in {work}", flush=True)
    else:
        _train_and_encode(work, paths, stage1, index_dir, n_docs, device)

    sweep_args = (work, paths, docs, rows, stage1, index_dir, chunk,
                  n_docs, n_key, n_train)
    return _sweep(*sweep_args, device=device)


def _train_and_encode(work, paths, stage1, index_dir, n_docs, device):
    """The stage-1 recipe through cli/train_retriever, then the corpus
    through cli/encode_corpus.  Returns the trainer's result dict with
    the seconds of each stage (``train_s``, ``encode_s``)."""
    from multihop_dense_retrieval_tpu_torch.cli import (encode_corpus,
                                                        train_retriever)

    chunk = min(4096, n_docs)
    model_name = os.environ.get("PRUNE_MODEL", "mini")
    print("== stage-1 retriever training", flush=True)
    t0 = time.perf_counter()
    result, _ = train_retriever.main([
        "--train-file", paths["mhop"], "--predict-file", paths["eval"],
        "--output-dir", stage1, "--train-batch-size", "8",
        "--predict-batch-size", "8",
        "--num-epochs", os.environ.get("PRUNE_EPOCHS", "8"),
        "--learning-rate", "1e-3", "--tokenizer", "hash",
        "--model-name", model_name,
        "--max-q-len", "24", "--max-q-sp-len", "80",
        "--max-c-len", "64", "--device", str(device)])
    ckpt = os.path.join(stage1, "checkpoint_best.pt")
    t1 = time.perf_counter()
    print(f"== trained in {t1 - t0:.1f} s: {result}", flush=True)

    print("== corpus encode", flush=True)
    encode_corpus.main([paths["corpus"], index_dir, "--checkpoint", ckpt,
                        "--tokenizer", "hash", "--model-name", model_name,
                        "--batch-size", "64", "--chunk-rows", str(chunk),
                        "--max-c-len", "64", "--device", str(device)])
    t2 = time.perf_counter()
    print(f"== encoded in {t2 - t1:.1f} s", flush=True)
    return dict(result, train_s=t1 - t0, encode_s=t2 - t1)


def _sweep(work, paths, docs, rows, stage1, index_dir, chunk,
           n_docs, n_key, n_train, device=None):
    from multihop_dense_retrieval_tpu_torch.cli.common import (
        init_retriever, resolve_encoder_config, resolve_tokenizer)
    from multihop_dense_retrieval_tpu_torch.cli.eval_mhop_retrieval import \
        load_searcher
    from multihop_dense_retrieval_tpu_torch.core.config import SearchConfig
    from multihop_dense_retrieval_tpu_torch.ops.mips import NEG_INF

    device = _device(device)
    ckpt = os.path.join(stage1, "checkpoint_best.pt")
    model_name = os.environ.get("PRUNE_MODEL", "mini")
    tok = resolve_tokenizer("hash")
    enc_cfg = resolve_encoder_config(model_name)
    model = init_retriever(enc_cfg, checkpoint=ckpt, device=device)

    gold = {r["_id"]: set(r["sp"]) for r in rows}
    questions = [r["question"][:-1] if r["question"].endswith("?")
                 else r["question"] for r in rows]

    def batches(searcher):
        """(start, questions, search output) of each padded batch."""
        for s in range(0, len(rows), BATCH):
            qs = questions[s:s + BATCH]
            qs_p = qs + [qs[-1]] * (BATCH - len(qs))
            q_inputs = tok.encode_batch_one(qs_p, MAX_Q_LEN)
            raw = [tok.raw_ids_padded(q, RAW_Q_LEN) for q in qs_p]
            yield s, qs, searcher.search(q_inputs,
                                         np.stack([r[0] for r in raw]),
                                         np.array([r[1] for r in raw]))

    def run(margin, base=None):
        """Sweep one margin: chain_agreement with the margin-off engine,
        gold_hop1_expanded, p_em / pr and the pruned fraction."""
        cfg = SearchConfig(beam_size_1=BEAM, beam_size_2=BEAM, topk=TOPK,
                           max_q_len=MAX_Q_LEN, max_q_sp_len=MAX_Q_SP_LEN,
                           chunk_rows=chunk, hop2_buckets=(32, 48, 64, 80),
                           hop2_tile_fracs=(0.25, 0.375, 0.25, 0.125),
                           hop2_prune_margin=margin)
        searcher = load_searcher(index_dir, tok, model, cfg, device)
        pem = pr = agree = gold_exp = 0
        pruned = total = 0
        chains = []
        for s, qs, out in batches(searcher):
            d1 = out["hop1_cand_scores"][:len(qs)]
            if margin != 0:
                if margin > 0:
                    m_eff = margin
                else:
                    # host replica of the engine's auto rule
                    # (search/beam.py): the q-quantile of the batch's
                    # positive hop-1 gaps
                    qf = min(-margin, 1.0)
                    g_all = np.sort(
                        (out["hop1_cand_scores"].max(1, keepdims=True)
                         - out["hop1_cand_scores"]).reshape(-1))
                    m_eff = g_all[BATCH + int((g_all.size - BATCH - 1) * qf)]
                act = d1 >= d1.max(1, keepdims=True) - m_eff
                pruned += int((~act).sum())
                total += act.size
            else:
                act = np.ones_like(d1, bool)
                total += d1.size
            for i in range(len(qs)):
                r = rows[s + i]
                titles = {docs[int(out["hop1_ids"][i][0])]["title"],
                          docs[int(out["hop2_ids"][i][0])]["title"]}
                g = gold[r["_id"]]
                pem += titles == g
                any_hit = False
                for h1, h2, sc in zip(out["hop1_ids"][i], out["hop2_ids"][i],
                                      out["path_scores"][i]):
                    if sc <= NEG_INF / 2:
                        continue
                    if ({docs[int(h1)]["title"], docs[int(h2)]["title"]}
                            & g):
                        any_hit = True
                pr += any_hit
                cand_titles = [docs[int(c)]["title"]
                               for c in out["hop1_cand_ids"][i]]
                gold_exp += any(t in g and a
                                for t, a in zip(cand_titles, act[i]))
                chain = tuple(
                    (int(h1), int(h2))
                    for h1, h2, sc in zip(out["hop1_ids"][i],
                                          out["hop2_ids"][i],
                                          out["path_scores"][i])
                    if sc > NEG_INF / 2)
                chains.append(chain)
                if base is not None:
                    agree += chain == base["chains"][s + i]
        n = len(rows)
        r = {"p_em": round(pem / n, 4), "pr": round(pr / n, 4),
             "gold_hop1_expanded": round(gold_exp / n, 4),
             "pruned_frac": round(pruned / max(total, 1), 4),
             "chains": chains}
        if base is not None:
            r["chain_agreement"] = round(agree / n, 4)
        return r

    def pub(r):
        return {k: v for k, v in r.items() if k != "chains"}

    res = {"beam": BEAM, "n_questions": len(rows), "n_docs": n_docs,
           "n_key_docs": n_key, "n_train": n_train}
    base = run(0.0)
    res["margin_0_off"] = pub(base)
    print(f"== margin off: {pub(base)}", flush=True)
    if base["p_em"] < 0.5:
        print(f"NOTE: crowded baseline (p_em={base['p_em']}) — "
              "chain_agreement and gold_hop1_expanded carry the "
              "neutrality decision at this scale", flush=True)

    # data-driven margins: quantiles of the per-question (top1 - score)
    # gap distribution of the trained engine
    cfg0 = SearchConfig(beam_size_1=BEAM, beam_size_2=BEAM, topk=TOPK,
                        max_q_len=MAX_Q_LEN, max_q_sp_len=MAX_Q_SP_LEN,
                        chunk_rows=chunk)
    s0 = load_searcher(index_dir, tok, model, cfg0, device)
    gaps = []
    for _, qs, out in batches(s0):
        d1 = out["hop1_cand_scores"][:len(qs)]
        gaps.append((d1.max(1, keepdims=True) - d1).reshape(-1))
    gaps = np.concatenate(gaps)
    gaps = gaps[gaps > 0]
    for q_pct in (25, 50, 75, 90):
        margin = float(np.percentile(gaps, q_pct))
        r = pub(run(margin, base=base))
        res[f"margin_p{q_pct}_{margin:.3f}"] = r
        print(f"== margin p{q_pct} ({margin:.3f}): {r}", flush=True)

    # the engine's own auto rule (hop2_prune_margin = -q): a per-batch
    # q-quantile gap margin, what `--hop2-prune-margin auto[:Q]` serves
    for q in (0.5, 0.9):
        r = pub(run(-q, base=base))
        res[f"margin_auto_injit_q{q}"] = r
        print(f"== margin auto:{q} (per-batch quantile): {r}", flush=True)

    out = os.environ.get("PRUNE_OUT", os.path.join(
        tempfile.gettempdir(), "prune_sweep_torch_result.json"))
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"RESULT {json.dumps(res)}")
    return res


if __name__ == "__main__":
    main()
