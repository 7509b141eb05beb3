"""Trained-weights fidelity of the reader's speed knobs, on the PyTorch port
(the port's copy of scripts_dev/fidelity_trained.py: the same data,
recipe, matrix and result keys; it imports torch, numpy and the port,
nothing of JAX).

Trains a tiny-preset reader with the port's cli/train_qa on synthetic
questions whose discriminative evidence (key + answer sentence) sits at a
controlled token offset per group (FIDELITY_OFFSETS, 64..448), with a
near-miss negative (the question's key, no answer) and role-uninformative
passage titles, disjoint between train and eval.  A rank width w can only
rank chains whose evidence it sees, so a truncating rank pass should fail
for offset > w; the length-bucketed pass (rank_width=None, which never
truncates) must track the full read at every offset.

Measures, with the trained weights:
  * per-(rank_width, offset) answer agreement and chain-EM of the
    two-stage read (rank_topm=5) against the one-stage full read;
  * answer agreement of bf16 attention scores against fp32.

    python scripts_dev/fidelity_trained_torch.py             # on the card
    FIDELITY_DEVICE=cpu python scripts_dev/fidelity_trained_torch.py

Environment: FIDELITY_OFFSETS, FIDELITY_NQ (48 train questions an
offset), FIDELITY_NQ_EVAL (40 eval questions an offset), FIDELITY_MODEL
(mini), FIDELITY_EPOCHS (6), FIDELITY_WIDTHS (96,128,160,192,256),
FIDELITY_DEVICE (cuda; without CUDA the script raises, it never runs on
the CPU unless asked), FIDELITY_OUT (the result JSON; default
fidelity_torch_result.json in the temp directory).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORDS = [f"w{i}" for i in range(800)]
MAX_SEQ = 512
OFFSETS = tuple(int(x) for x in os.environ.get(
    "FIDELITY_OFFSETS", "64,128,192,256,320,384,448").split(","))


def _filler(rng, n):
    return list(rng.choice(WORDS, size=max(n, 0)))


def _chain(rng, titles, offset, key=None, ans=None):
    """Two passages whose combined token stream places the key+answer
    sentence at ~`offset` tokens into the assembled chain (the question
    and specials take the first ~16).  Passage one is filler sized so the
    evidence lands in passage two at the offset; both carry trailing
    filler, so truncation at w < offset hides the evidence but never the
    whole chain."""
    lead = max(offset - 16, 4)          # tokens before the evidence
    p1_len = lead // 2
    p2_lead = lead - p1_len
    sents1 = [" ".join(_filler(rng, p1_len)) + " ."]
    ev = []
    if key is not None:
        ev.append(key)
    if ans is not None:
        ev += ["valrec", ans]
    evidence_sent = " ".join(_filler(rng, 3) + ev + _filler(rng, 3)) + " ."
    sents2 = [" ".join(_filler(rng, p2_lead)) + " .",
              evidence_sent,
              " ".join(_filler(rng, 10)) + " ."]
    sp2 = [1] if (ans is not None or key is not None) else []
    return [
        {"title": titles[0], "sents": sents1, "sp_sent_ids": []},
        {"title": titles[1], "sents": sents2, "sp_sent_ids": sp2},
    ]


def make_qa_rows(rng, n_q, offset, qid_prefix="q", n_negs=8,
                 key_prefix=None, ans_shift=0):
    """Learnable QA rows: the question carries a key token; the gold
    chain plants `key valrec ans` at ~`offset` tokens; negatives carry
    other keys at the same offset, plus one near-miss negative carrying
    the question's key but no answer.  1 gold + 8 negatives = 9 chains,
    so rank_topm=5 filters.

    ``key_prefix`` decouples the key space from the qid space: eval rows
    reuse the train key space (fresh answers via ``ans_shift``, fresh
    filler and titles)."""
    rows = []
    title_seq = [0]
    key_prefix = key_prefix or qid_prefix

    def tt():
        # role-uninformative, train/eval-disjoint (qid_prefix), unique
        title_seq[0] += 1
        return f"ttl{qid_prefix}{title_seq[0]}.{rng.randint(0, 10**6)}"

    for i in range(n_q):
        key = f"key{key_prefix}{i}"
        ans = f"ans{(i + ans_shift) % 97}"
        gold = _chain(rng, (tt(), tt()), offset, key=key, ans=ans)
        negs = []
        # near-miss: right key, no valrec/answer
        negs.append(_chain(rng, (tt(), tt()), offset, key=key))
        for j in range(n_negs - 1):
            nk = f"key{key_prefix}{rng.randint(0, n_q)}x"
            negs.append(_chain(rng, (tt(), tt()), offset,
                               key=nk, ans=f"ans{rng.randint(0, 97)}"))
        rows.append({
            "_id": f"{qid_prefix}{offset}_{i}",
            "question": f"what is the value recorded for {key} ?",
            "answer": [ans], "type": "bridge",
            "sp": gold, "candidate_chains": [gold] + negs,
        })
    return rows


def write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def main():
    from multihop_dense_retrieval_tpu_torch.cli import train_qa
    from multihop_dense_retrieval_tpu_torch.cli.common import READER_PRESETS
    from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
    from multihop_dense_retrieval_tpu_torch.core.device import resolve_device
    from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
    from multihop_dense_retrieval_tpu_torch.data.qa_dataset import QADataset
    from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict
    from multihop_dense_retrieval_tpu_torch.models.reader import QAReader
    from multihop_dense_retrieval_tpu_torch.train import qa as TQA

    device = resolve_device(os.environ.get("FIDELITY_DEVICE", "cuda"))
    work = tempfile.mkdtemp(prefix="mdrt_fidelity_")
    rng = np.random.RandomState(0)
    # training offsets cover the whole range, so the reader learns to find
    # evidence anywhere, not just where the eval plants it
    n_train_per = int(os.environ.get("FIDELITY_NQ", 48))
    train_rows = []
    for off in OFFSETS:
        train_rows += make_qa_rows(rng, n_train_per, off, qid_prefix="t")
    rng.shuffle(train_rows)
    erng = np.random.RandomState(1)
    n_eval_per = int(os.environ.get("FIDELITY_NQ_EVAL", 40))
    assert n_eval_per <= n_train_per, (
        "eval keys reuse the train key space — need NQ_EVAL <= NQ")
    # eval: held-out questions over the train key space (key_prefix="t"),
    # shifted answers, fresh filler and titles
    eval_groups = {off: make_qa_rows(erng, n_eval_per, off, qid_prefix="e",
                                     key_prefix="t", ans_shift=13)
                   for off in OFFSETS}
    eval_rows = [r for rows in eval_groups.values() for r in rows]
    train_path = os.path.join(work, "train.jsonl")
    eval_path = os.path.join(work, "eval.jsonl")
    write_jsonl(train_path, train_rows)
    write_jsonl(eval_path, eval_rows)
    print(f"== {len(train_rows)} train / {len(eval_rows)} eval questions, "
          f"offsets {OFFSETS}", flush=True)

    print("== training reader (in-repo recipe)", flush=True)
    t0 = time.perf_counter()
    out_dir = os.path.join(work, "reader")
    model_name = os.environ.get("FIDELITY_MODEL", "mini")
    train_qa.main([
        "--train-file", train_path, "--predict-file", eval_path,
        "--output-dir", out_dir, "--tokenizer", "hash",
        "--model-name", model_name,
        "--batch-size", "8",
        "--predict-batch-size", "8",
        "--num-epochs", os.environ.get("FIDELITY_EPOCHS", "6"),
        "--learning-rate", "2e-3", "--max-seq-len", str(MAX_SEQ),
        "--max-q-len", "16", "--num-answer-slots", "4", "--max-sents", "8",
        "--neg-num", "4", "--max-ans-len", "4", "--warmup-ratio", "0.0",
        "--device", str(device)])
    t1 = time.perf_counter()
    print(f"== trained in {t1 - t0:.1f} s", flush=True)

    # the reader preset of cli/train_qa (vocab 50265), so the trained
    # checkpoint loads into this model
    tok = HashTokenizer(vocab_size=50265, roberta_style=False)
    preset = READER_PRESETS[model_name]
    weights = ckpt.restore_pytree(os.path.join(out_dir, "checkpoint_best.pt"))

    def reader(cfg):
        model = QAReader(cfg, sp_pred=True)
        model.load_state_dict(weights)
        return model.to(device).eval()

    model = reader(preset())
    pred_step = TQA.make_qa_predict_step(model, max_ans_len=4)
    rank_step = TQA.make_qa_rank_step(model)

    def per_group(run_fn):
        """Run a predict variant per offset group; returns
        {offset: (chain_em, answers, em)}."""
        out = {}
        for off, rows in eval_groups.items():
            ds = QADataset(tok, rows, max_seq_len=MAX_SEQ, max_q_len=16,
                           num_answer_slots=4, max_sents=8, train=False)
            r = run_fn(ds)
            out[off] = (r["chain_em"], r["best"]["answers"],
                        r["best"]["em"])
        return out

    res = {"n_questions": len(eval_rows), "offsets": list(OFFSETS),
           "n_per_offset": n_eval_per}
    base = per_group(lambda ds: predict(pred_step, ds, batch_size=8))
    res["one_stage"] = {str(o): {"chain_em": c, "em": em}
                        for o, (c, a, em) in base.items()}
    mean_chain_em = float(np.mean([c for c, _, _ in base.values()]))
    mean_em = float(np.mean([em for _, _, em in base.values()]))
    print(f"== one-stage: chain_em {mean_chain_em:.3f}, em {mean_em:.3f}",
          flush=True)
    assert mean_em >= 0.5, (
        f"reader did not train (answer em={mean_em}) — fidelity "
        "comparisons against it would be meaningless")
    assert mean_chain_em < 1.0, (
        "baseline chain-EM saturated at 1.0 — the harness has no "
        "discriminative power; harden the negatives")

    matrix = {}
    widths = [int(w) for w in os.environ.get(
        "FIDELITY_WIDTHS", "96,128,160,192,256").split(",")]
    for w in widths + [None]:
        tag = "bucketed" if w is None else f"w{w}"
        two = per_group(lambda ds, w=w: predict(
            pred_step, ds, batch_size=8, rank_step=rank_step,
            rank_topm=5, rank_width=w))
        row = {}
        for off in OFFSETS:
            b_ans, t_ans = base[off][1], two[off][1]
            agree = float(np.mean([t_ans[q] == b_ans[q] for q in b_ans]))
            row[str(off)] = {"agreement": round(agree, 4),
                             "chain_em": round(two[off][0], 4)}
        matrix[tag] = row
        mean_agree = float(np.mean(
            [row[str(o)]["agreement"] for o in OFFSETS]))
        print(f"== two-stage {tag}: "
              + " ".join(f"{o}:{row[str(o)]['agreement']:.2f}"
                         for o in OFFSETS)
              + f"  (mean {mean_agree:.3f})", flush=True)
    res["matrix"] = matrix

    # bf16 attention scores: the same trained weights
    pred_bf = TQA.make_qa_predict_step(
        reader(preset(attention_scores_dtype="bfloat16")), max_ans_len=4)
    bf = per_group(lambda ds: predict(pred_bf, ds, batch_size=8))
    res["bf16_scores"] = {
        str(o): round(float(np.mean(
            [bf[o][1][q] == base[o][1][q] for q in base[o][1]])), 4)
        for o in OFFSETS}
    print(f"== bf16 scores agreement: {res['bf16_scores']}", flush=True)
    print(f"== measured in {time.perf_counter() - t1:.1f} s", flush=True)

    out = os.environ.get("FIDELITY_OUT", os.path.join(
        tempfile.gettempdir(), "fidelity_torch_result.json"))
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"RESULT {json.dumps(res)}")
    return res


if __name__ == "__main__":
    main()
