"""scripts_dev/fidelity_trained_torch.py (the port's copy) against
scripts_dev/fidelity_trained.py (the JAX package's), both loaded from
scripts_dev/ with importlib, on the CPU.

  * ``make_qa_rows``: the same rows (as JSON bytes) for the same seed, for
    train rows and for eval rows over the train key space.
  * The measuring stage: both scripts' ``main`` at 2 offsets (64, 448), 8
    train and 8 eval questions an offset and rank widths 96 and 256 (and
    the length-bucketed pass), with the training step replaced by one set
    of weights: a seeded reader of the scripts' ``tiny`` preset
    (``FIDELITY_MODEL``; 2 x 32, the default mini is 4 x 64) initialised
    in JAX (kernels scaled by WIDEN, which spreads the random model's
    scores), written as the JAX trainer writes ``checkpoint_best`` and
    exported to the port's ``checkpoint_best.pt`` by the JAX
    ``cli/export_ckpt``.  The preset computes in fp32 in both packages,
    so the results dicts (the one-stage read, the matrix, bf16 against
    fp32 agreement) must be equal.  The two scripts check that their reader trained (answer EM >=
    0.5): random weights cannot pass that check, so both scripts are
    compiled here with ``optimize=1``, which drops their ``assert``
    statements and nothing else.
"""

import importlib.util
import json
import os
import shutil
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import export_ckpt as jexport
from multihop_dense_retrieval_tpu.cli import train_qa as jtrain_qa
from multihop_dense_retrieval_tpu.core import checkpoint as jckpt
from multihop_dense_retrieval_tpu_torch.cli import train_qa as ttrain_qa

ROOT = Path(__file__).resolve().parent.parent
OFFSETS, NQ, WIDEN, MODEL = (64, 448), 8, 4.0, "tiny"


def _load(name, optimize=0):
    path = ROOT / "scripts_dev" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(path.read_text(), str(path), "exec", optimize=optimize),
         mod.__dict__)
    return mod


JF = _load("fidelity_trained")
PF = _load("fidelity_trained_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: torch's CPU threads
    spin-wait at every parallel op, so with the suite's workers sharing
    the cores a multi-threaded op waits on descheduled threads
    (tests/test_torch_prune_sweep.py has the figures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("kw", [dict(qid_prefix="t"),
                                dict(qid_prefix="e", key_prefix="t",
                                     ans_shift=13)], ids=["train", "eval"])
def test_make_qa_rows_match_jax(offset, kw):
    rows = [mod.make_qa_rows(np.random.RandomState(3), NQ, offset, **kw)
            for mod in (JF, PF)]
    assert json.dumps(rows[0]) == json.dumps(rows[1])
    assert len(rows[1]) == NQ
    assert all(len(r["candidate_chains"]) == 9 for r in rows[1])


def _out_dir(argv):
    return argv[argv.index("--output-dir") + 1]


def test_measuring_stage_matches_jax(tmp_path, monkeypatch):
    _, _, params = jtrain_qa.init_reader(MODEL, "", True, seed=3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * WIDEN if "kernel" in jax.tree_util.keystr(path)
        else x, params)
    jckpt.save_pytree(str(tmp_path / "jax_reader"), params)
    jexport.main(["--checkpoint", str(tmp_path / "jax_reader"), "--arch",
                  "reader", "--out", str(tmp_path / "reader.pt")])

    def jax_weights(argv):
        jckpt.save_pytree(os.path.join(_out_dir(argv), "checkpoint_best"),
                          params)

    def port_weights(argv):
        os.makedirs(_out_dir(argv))
        shutil.copy(tmp_path / "reader.pt",
                    os.path.join(_out_dir(argv), "checkpoint_best.pt"))

    monkeypatch.setattr(jtrain_qa, "main", jax_weights)
    monkeypatch.setattr(ttrain_qa, "main", port_weights)
    works = iter([tmp_path / "jax", tmp_path / "port"])
    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda prefix="": str(next(works)))
    monkeypatch.setenv("FIDELITY_NQ", str(NQ))
    monkeypatch.setenv("FIDELITY_NQ_EVAL", str(NQ))
    monkeypatch.setenv("FIDELITY_WIDTHS", "96,256")
    monkeypatch.setenv("FIDELITY_MODEL", MODEL)
    monkeypatch.setenv("FIDELITY_DEVICE", "cpu")
    res = {}
    for name, mod in (("jax", JF), ("port", PF)):
        (tmp_path / name).mkdir()
        script = _load(mod.__name__, optimize=1)
        script.OFFSETS = OFFSETS
        monkeypatch.setenv("FIDELITY_OUT", str(tmp_path / f"{name}.json"))
        res[name] = script.main()
        assert json.loads((tmp_path / f"{name}.json").read_text()) == \
            res[name]
    for name in ("train", "eval"):
        assert (tmp_path / "jax" / f"{name}.jsonl").read_bytes() == \
            (tmp_path / "port" / f"{name}.jsonl").read_bytes()
    assert res["port"] == res["jax"]
    assert sorted(res["port"]["matrix"]) == ["bucketed", "w256", "w96"]
    ref = json.loads((ROOT / "docs" / "fidelity_r5.json").read_text())
    assert sorted(res["port"]) == sorted(ref)


@pytest.mark.parametrize("arch", ["reader", "retriever"])
def test_seeded_weights_draw_from_the_jax_initialisers(arch):
    """The port's seeded models (``cli/common.py``'s ``init_reader`` and
    ``init_retriever``, through ``models.reference_init_``) draw each
    parameter from the JAX package's initialiser (Flax's defaults), not
    PyTorch's: per tensor of the mini preset, mapped through the weight
    converters, the same zeros and ones, and every other tensor's std
    within 10% of the JAX init's (tensors of 1,000 entries or more)."""
    from multihop_dense_retrieval_tpu.cli import common as jcommon
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.models import (
        reader_state_dict_from_jax, retriever_state_dict_from_jax)

    if arch == "reader":
        _, _, jparams = jtrain_qa.init_reader("mini", "", True, seed=3)
        exp = reader_state_dict_from_jax(jax.device_get(jparams))
        got = common.init_reader("mini", seed=3, device="cpu")[1].state_dict()
    else:
        cfg = jcommon.resolve_encoder_config("mini", dtype="float32")
        _, jparams = jcommon.init_retriever(cfg, seed=3)
        exp = retriever_state_dict_from_jax(jax.device_get(jparams))
        got = common.init_retriever(common.resolve_encoder_config(
            "mini", dtype="float32"), seed=3, device="cpu").state_dict()
    assert set(exp) <= set(got)
    for name, e in exp.items():
        g = got[name].float()
        if not e.any() or bool((e == 1).all()):
            assert torch.equal(g, e.float()), name
        elif e.numel() >= 1000:
            ratio = g.std().item() / e.float().std().item()
            assert 0.9 <= ratio <= 1.1, (name, ratio)


def test_reader_training_tracks_jax_step_by_step(tmp_path, monkeypatch):
    """The fidelity script's training recipe (``cli/train_qa``: lr 2e-3,
    no warmup, batch 8, 4 negatives, 4 answer slots, 8 sentences) in both
    packages from one set of initial weights (a seeded ``tiny`` reader
    made by JAX, exported to ``.pt``, which both CLIs read with
    ``--checkpoint``), on the script's rows at offsets 64 and 128 (so 256
    tokens hold the chains), 8 questions each: the same loss at every
    step of an epoch (10 steps), each within 1e-4 relative of JAX's.
    fp32 rounding makes the two runs drift apart step by step, as two
    runs of either package on different hardware would, but no step may
    take a different update: the port trains as JAX does."""
    from multihop_dense_retrieval_tpu.train import qa as jqa
    from multihop_dense_retrieval_tpu_torch.train import qa as tqa

    rng = np.random.RandomState(0)
    offsets = (64, 128)
    rows = [r for off in offsets
            for r in PF.make_qa_rows(rng, NQ, off, qid_prefix="t")]
    rng.shuffle(rows)
    PF.write_jsonl(str(tmp_path / "train.jsonl"), rows)
    PF.write_jsonl(str(tmp_path / "eval.jsonl"), [
        r for off in offsets for r in PF.make_qa_rows(
            np.random.RandomState(1), 2, off, qid_prefix="e",
            key_prefix="t", ans_shift=13)])
    _, _, params = jtrain_qa.init_reader(MODEL, "", True, seed=3)
    jckpt.save_pytree(str(tmp_path / "init"), params)
    jexport.main(["--checkpoint", str(tmp_path / "init"), "--arch",
                  "reader", "--out", str(tmp_path / "init.pt")])
    argv = ["--train-file", str(tmp_path / "train.jsonl"),
            "--predict-file", str(tmp_path / "eval.jsonl"),
            "--checkpoint", str(tmp_path / "init.pt"),
            "--tokenizer", "hash", "--model-name", MODEL,
            "--batch-size", "8", "--predict-batch-size", "32",
            "--num-epochs", "1", "--learning-rate", "2e-3",
            "--max-seq-len", "256", "--max-q-len", "16",
            "--num-answer-slots", "4", "--max-sents", "8", "--neg-num", "4",
            "--max-ans-len", "4", "--warmup-ratio", "0.0"]
    losses = {}
    for name, qa, cli, extra in (("jax", jqa, jtrain_qa, []),
                                 ("port", tqa, ttrain_qa,
                                  ["--device", "cpu"])):
        make = qa.make_qa_train_step
        seen = losses[name] = []

        def recording(*a, make=make, seen=seen, **kw):
            step = make(*a, **kw)

            def run(state, batch):
                state, loss = step(state, batch)
                seen.append(float(loss))
                return state, loss

            return run

        monkeypatch.setattr(qa, "make_qa_train_step", recording)
        cli.main(argv + extra)
    assert len(losses["jax"]) == len(losses["port"]) == 10
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)


def test_two_stage_read_keeping_every_chain_is_the_one_stage_read():
    """``eval/qa_eval.py::predict``'s two-stage read with the
    length-bucketed rank pass (``rank_width=None``) and ``rank_topm=9``
    keeps all 9 chains of every fidelity question, so it must give the
    one-stage read's answers and chain EM exactly: a disagreement of the
    bucketed pass at ``rank_topm=5`` is then the ranker's, not predict's.
    A seeded ``tiny`` reader (kernels scaled by WIDEN) on the script's
    eval rows at 2 offsets, 4 questions each."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.data.qa_dataset import QADataset
    from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict
    from multihop_dense_retrieval_tpu_torch.train import qa as tqa

    cfg, model = common.init_reader(MODEL, seed=3, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2 and "embeddings" not in name:
                p.mul_(WIDEN)
    tok = common.resolve_reader_tokenizer("hash", cfg)
    rows = [r for off in OFFSETS for r in PF.make_qa_rows(
        np.random.RandomState(1), NQ // 2, off, qid_prefix="e",
        key_prefix="t", ans_shift=13)]
    ds = QADataset(tok, rows, max_seq_len=PF.MAX_SEQ, max_q_len=16,
                   num_answer_slots=4, max_sents=8, train=False)
    pred = tqa.make_qa_predict_step(model, max_ans_len=4)
    one = predict(pred, ds, batch_size=8)
    every = predict(pred, ds, batch_size=8,
                    rank_step=tqa.make_qa_rank_step(model), rank_topm=9,
                    rank_width=None)
    assert every["best"]["answers"] == one["best"]["answers"]
    assert every["chain_em"] == one["chain_em"]
    assert len(set(one["best"]["answers"].values())) > 1
