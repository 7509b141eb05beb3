"""Single-hop training and the grid launcher: the port's
``data/sp_datasets.py`` (``SPDataset``, ``NQMhopDataset``, ``sp_collate``)
against the JAX package's, bit for bit on the same rows and RNG states;
then the JAX package's tests of them and of ``cli/train_single`` and
``cli/launch``, ported (tests/test_components.py::test_sp_dataset and
test_nq_mhop_dataset_and_augmentation, tests/test_more_cli.py::
test_train_single_cli, test_train_single_separate_encoders_from_checkpoint
and test_launch_grid), on ``--device cpu``; with ``--data-parallel 2``
held to the JAX CLIs' runs from one ``--init-checkpoint``.  The single-hop
train steps themselves are held to JAX's in tests/test_torch_train.py and
tests/test_torch_train_parallel.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import launch as jlaunch
from multihop_dense_retrieval_tpu.cli import train_single as jtrain_single
from multihop_dense_retrieval_tpu.data import BatchLoader as JaxLoader
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxTok
from multihop_dense_retrieval_tpu.data import sp_datasets as jsp
from multihop_dense_retrieval_tpu_torch.cli import launch, train_single
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.data import BatchLoader, HashTokenizer
from multihop_dense_retrieval_tpu_torch.data import sp_datasets as tsp
from multihop_dense_retrieval_tpu_torch.models import NQRetriever
from multihop_dense_retrieval_tpu_torch.train import trainer as T
from tests import synth
from tests.test_torch_train_cli import (  # noqa: F401 (a fixture)
    _init_checkpoint, _jax_checkpoint, _vectors, fp32_tiny)


def _sp_rows(n=8):
    rows = [{"question": f"what is thing {i}?",
             "pos_paras": [{"title": f"P{i}", "text": f"thing {i} body text"},
                           {"title": f"Q{i}", "text": f"more on thing {i}"}],
             "neg_paras": [{"title": f"N{i}{j}", "text": f"unrelated {j}"}
                           for j in range(i % 3)]} for i in range(n)]
    rows.append({"question": "single pos para, no negatives",
                 "pos_para": {"title": "Ünïcode", "text": " spaced "}})
    return rows


def _fever_rows(n=6):
    return [{"claim": f"claim number {i} about things",
             "evidence": [[{"title": f"A{i}", "text": f"evi text {i}"},
                           {"title": f"B{i}", "text": f"second text {i}"}],
                          {"title": f"A{i}", "text": f"evi text {i}"}],
             "tfidf_neg": [{"title": f"N{i}", "text": "neg text"}] * (i % 2),
             "linked_neg": [{"title": f"L{i}", "text": "neg two"}]}
            for i in range(n)]


def _nq_rows(n=5):
    rows = [{"question": f"short q {i}",
             "pos_paras": [{"title": f"P{i}", "text": "pos body"}],
             "top_neg": [{"title": f"E{i}", "text": "wrong passage body"},
                         {"title": f"N{i}", "text": "negative body"},
                         {"title": f"M{i}", "text": ""}]}
            for i in range(n)]
    rows.append({"question": "dropped", "pos_paras": [], "top_neg": []})
    return rows


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _both(tmp_path, rows, cls, **kw):
    path = str(tmp_path / "rows.jsonl")
    synth.write_jsonl(path, rows)
    return (getattr(jsp, cls)(JaxTok(vocab_size=512), path, **kw),
            getattr(tsp, cls)(HashTokenizer(vocab_size=512), path, **kw))


@pytest.mark.parametrize("cls,rows,kw", [
    ("SPDataset", _sp_rows, dict(train=True)),
    ("SPDataset", _sp_rows, dict(train=False)),
    ("SPDataset", _fever_rows, dict(train=True, fever=True)),
    ("SPDataset", _fever_rows, dict(train=False, fever=True)),
    ("NQMhopDataset", _nq_rows, dict(train=True)),
    ("NQMhopDataset", _nq_rows, dict(train=False, augment=False)),
])
def test_sp_datasets_bit_equal_to_jax(tmp_path, cls, rows, kw):
    """Every item (the same RandomState draws: positive pick, negative
    shuffle, borrowed positives) and every loader batch through
    sp_collate, bit-equal to the JAX package's."""
    kw = dict(kw, max_q_len=12, max_c_len=24, seed=5)
    if cls == "NQMhopDataset":
        kw["max_q_sp_len"] = 32
    jds, tds = _both(tmp_path, rows(), cls, **kw)
    assert len(jds) == len(tds)
    for i in range(len(tds)):
        _same(tds.getitem_rng(i, np.random.RandomState(i)),
              jds.getitem_rng(i, np.random.RandomState(i)))
        _same(tds[i], jds[i])
    loaders = [L(ds, 4, shuffle=kw["train"], seed=7, collate=c, num_workers=2)
               for L, ds, c in ((JaxLoader, jds, jsp.sp_collate),
                                (BatchLoader, tds, tsp.sp_collate))]
    for _ in range(2):
        for jb, tb in zip(*loaders, strict=True):
            _same(tb, jb)


def test_sp_dataset(tmp_path):
    tok = HashTokenizer(vocab_size=512)
    rows = [{"question": "who did x?",
             "pos_paras": [{"title": "A", "text": "a text"}],
             "neg_paras": [{"title": "B", "text": "b text"}]},
            {"question": "who did y?",
             "pos_paras": [{"title": "C", "text": "c text"}],
             "neg_paras": []}]
    synth.write_jsonl(tmp_path / "sp.jsonl", rows)
    ds = tsp.SPDataset(tok, str(tmp_path / "sp.jsonl"), max_q_len=12,
                       max_c_len=16, train=True)
    batch = tsp.sp_collate([ds[0], ds[1]])
    assert batch["q_input_ids"].shape == (2, 12)
    assert batch["c_input_ids"].shape == (2, 16)
    # row 1 has no negatives: train mode borrows another sample's positive
    assert batch["neg_mask"][1].sum() > 0


def test_nq_mhop_dataset_and_augmentation(tmp_path):
    tok = HashTokenizer(vocab_size=512)
    rows = [{"question": f"short q {i}",
             "pos_paras": [{"title": f"P{i}", "text": "pos body"}],
             "top_neg": [{"title": f"E{i}", "text": "wrong passage body"},
                         {"title": f"N{i}", "text": "negative body"}]}
            for i in range(4)]
    rows.append({"question": "dropped", "pos_paras": [], "top_neg": []})
    synth.write_jsonl(tmp_path / "nq.jsonl", rows)
    ds = tsp.NQMhopDataset(tok, str(tmp_path / "nq.jsonl"), max_q_len=16,
                           max_q_sp_len=32, max_c_len=24)
    assert len(ds) == 4  # <2 top_neg dropped
    item = ds[0]
    # [MASK] augmentation: every non-special slot of q filled, full mask
    assert item["q_mask"].sum() == 16
    assert (item["q_input_ids"] == tok.spec.mask_id).sum() > 0
    # q_neg1 is a (question, error passage) pair
    assert item["q_neg1_input_ids"][0] == tok.spec.cls_id

    # full NQ train step over this batch
    batch = {k: torch.from_numpy(v) for k, v in
             tsp.sp_collate([ds[i] for i in range(4)]).items()}
    model = NQRetriever(EncoderConfig.tiny(vocab_size=512,
                                           max_position_embeddings=40),
                        fp32_params=True)
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(warmup_ratio=0.0), 10))
    state, loss = T.make_train_step(task="nq")(state, batch)
    assert np.isfinite(float(loss))


BASE = ["--tokenizer", "hash", "--model-name", "tiny", "--device", "cpu",
        "--train-batch-size", "4", "--predict-batch-size", "4",
        "--num-epochs", "1", "--learning-rate", "1e-4",
        "--max-q-len", "12", "--max-c-len", "24"]


def _sp_file(tmp_path):
    rows = [{"question": f"what is thing {i}?",
             "pos_paras": [{"title": f"P{i}", "text": f"thing {i} body text"}],
             "neg_paras": [{"title": f"N{i}", "text": "unrelated words"}]}
            for i in range(8)]
    synth.write_jsonl(tmp_path / "sp.jsonl", rows)
    p = str(tmp_path / "sp.jsonl")
    return ["--train-file", p, "--predict-file", p]


def test_train_single_cli(tmp_path):
    """The shared tower, then the token-queue momentum variant
    (MomentumRetriever parity): the queue holds the epoch's context rows."""
    files = _sp_file(tmp_path)
    res, trainer = train_single.main(files + BASE)
    assert res["best_mrr"] > 0
    assert trainer.state.step == 2 and trainer.state.model.shared

    res, trainer = train_single.main(files + BASE + ["--momentum",
                                                     "--queue-size", "8"])
    assert res["best_mrr"] > 0
    state = trainer.state
    assert isinstance(state, T.TokenQueueTrainState)
    assert state.queue_ids.shape == (8, 24) and state.queue_ptr == 0
    assert (state.queue_mask.sum(1) > 2).all()    # every slot overwritten


def test_train_single_fever_cli(tmp_path):
    synth.write_jsonl(tmp_path / "f.jsonl", _fever_rows(8))
    p = str(tmp_path / "f.jsonl")
    res, _ = train_single.main(["--train-file", p, "--predict-file", p,
                                "--fever"] + BASE)
    assert np.isfinite(res["final_loss"]) and res["best_mrr"] > 0


def test_train_single_separate_encoders_from_checkpoint(tmp_path):
    """--separate-encoders --init-checkpoint seeds BOTH towers from the
    one-tower checkpoint; at lr 0 both stay equal to it."""
    files = _sp_file(tmp_path)
    out = str(tmp_path / "stage1")
    res, _ = train_single.main(files + BASE + ["--output-dir", out])
    assert res["best_mrr"] > 0
    stage1 = f"{out}/checkpoint_best.pt"
    sd = ckpt.restore_pytree(stage1)
    assert sd and all(k.startswith(("encoder.", "project.")) for k in sd)

    res2, trainer = train_single.main(files + BASE + [
        "--separate-encoders", "--init-checkpoint", stage1])
    assert res2["best_mrr"] > 0
    model = trainer.state.model
    assert not model.shared
    out3 = str(tmp_path / "lr0")
    _, trainer = train_single.main(files + BASE + [
        "--separate-encoders", "--init-checkpoint", stage1,
        "--learning-rate", "0", "--output-dir", out3])
    got = trainer.state.model.state_dict()
    for key, val in sd.items():
        assert torch.equal(got[key], val), key
        tower = key.replace("encoder.", "encoder_q.", 1).replace(
            "project.", "project_q.", 1)
        assert torch.equal(got[tower], val), tower
    # the unshared checkpoint keeps both towers
    assert any(k.startswith("encoder_q.") for k in
               ckpt.restore_pytree(f"{out3}/checkpoint_last.pt"))


def _jax_argv(argv):
    """The port's argv without its --device (the JAX CLIs have none)."""
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


@pytest.mark.parametrize("momentum", [False, True])
def test_train_single_data_parallel_matches_jax_cli(tmp_path, fp32_tiny,
                                                    momentum):
    """tests/test_more_cli.py::test_train_single_cli's runs, with
    --data-parallel 2 from one --init-checkpoint (fp32 compute), shared
    and with --momentum (the token queue starts from [CLS][SEP] rows in
    both packages): the loss rel 1e-5 of the JAX CLI's run and of the
    port's single-device run, the same best MRR, checkpoints whose
    vectors agree within 1e-5; the token queue holds the global batches'
    rows."""
    argv = _sp_file(tmp_path) + BASE + [
        "--init-checkpoint", _init_checkpoint(tmp_path)] + (
        ["--momentum", "--queue-size", "8"] if momentum else [])
    jres = jtrain_single.main(_jax_argv(argv) + [
        "--data-parallel", "2", "--output-dir", str(tmp_path / "j")])
    res, trainer = train_single.main(argv + [
        "--data-parallel", "2", "--output-dir", str(tmp_path / "p")])
    one, single = train_single.main(argv + ["--output-dir",
                                            str(tmp_path / "one")])
    assert res["final_loss"] == pytest.approx(jres["final_loss"], rel=1e-5)
    assert res["final_loss"] == pytest.approx(one["final_loss"], rel=1e-5)
    assert res["best_mrr"] == pytest.approx(jres["best_mrr"], abs=1e-6)
    got = _vectors(ckpt.restore_pytree(str(tmp_path / "p/checkpoint_last.pt")))
    for ref in (_jax_checkpoint(str(tmp_path / "j/checkpoint_last")),
                ckpt.restore_pytree(str(tmp_path / "one/checkpoint_last.pt"))):
        np.testing.assert_allclose(got, _vectors(ref), rtol=0, atol=1e-5)
    if momentum:
        for name in ("queue_ids", "queue_mask", "queue_type"):
            assert torch.equal(getattr(trainer.state, name),
                               getattr(single.state, name))
        assert trainer.state.queue_ptr == single.state.queue_ptr == 0


def test_launch_data_parallel_matches_jax_cli(tmp_path, fp32_tiny):
    """tests/test_more_cli.py::test_launch_grid with --data-parallel 2
    (forwarded to each grid point's train_retriever) from one
    --init-checkpoint, fp32 compute: the same grid lines and best MRRs as
    the JAX launcher's, each point's checkpoint vectors within 1e-5."""
    rng = np.random.RandomState(2)
    docs = synth.make_corpus(rng, 24)
    synth.write_jsonl(tmp_path / "t.jsonl",
                      synth.make_mhop_rows(rng, docs, n_rows=8))
    argv = ["--grid-lr", "1e-4,1e-3", "--grid-warmup", "0.0",
            "--train-file", str(tmp_path / "t.jsonl"),
            "--predict-file", str(tmp_path / "t.jsonl"),
            "--init-checkpoint", _init_checkpoint(tmp_path),
            "--tokenizer", "hash", "--model-name", "tiny", "--device", "cpu",
            "--train-batch-size", "4", "--predict-batch-size", "4",
            "--num-epochs", "1", "--max-q-len", "12", "--max-q-sp-len", "32",
            "--max-c-len", "24", "--data-parallel", "2"]
    jbest = jlaunch.main(_jax_argv(argv) + ["--output-dir",
                                            str(tmp_path / "j")])
    best = launch.main(argv + ["--output-dir", str(tmp_path / "p")])
    lines = {}
    for tag in ("j", "p"):
        with open(tmp_path / tag / "sweep_results.jsonl") as f:
            lines[tag] = [json.loads(x) for x in f]
    assert [(r["lr"], r["warmup"], r["seed"]) for r in lines["p"]] == \
        [(r["lr"], r["warmup"], r["seed"]) for r in lines["j"]]
    for a, b in zip(lines["p"], lines["j"]):
        assert a["best_mrr"] == pytest.approx(b["best_mrr"], abs=1e-6)
        np.testing.assert_allclose(
            _vectors(ckpt.restore_pytree(f"{a['dir']}/checkpoint_last.pt")),
            _vectors(_jax_checkpoint(f"{b['dir']}/checkpoint_last")),
            rtol=0, atol=1e-5)
    assert best["lr"] == jbest["lr"]


def test_launch_grid(tmp_path):
    """Two grid points, each its own run directory and result line; a
    requeued launch skips both and gives the same argmax."""
    rng = np.random.RandomState(2)
    docs = synth.make_corpus(rng, 24)
    rows = synth.make_mhop_rows(rng, docs, n_rows=8)
    synth.write_jsonl(tmp_path / "t.jsonl", rows)
    argv = ["--grid-lr", "1e-4,1e-3", "--grid-warmup", "0.0",
            "--train-file", str(tmp_path / "t.jsonl"),
            "--predict-file", str(tmp_path / "t.jsonl"),
            "--output-dir", str(tmp_path / "sweep"),
            "--tokenizer", "hash", "--model-name", "tiny", "--device", "cpu",
            "--train-batch-size", "4", "--predict-batch-size", "4",
            "--num-epochs", "1", "--max-q-len", "12", "--max-q-sp-len", "32",
            "--max-c-len", "24"]
    best = launch.main(argv)
    assert best["best_mrr"] > 0
    with open(tmp_path / "sweep" / "sweep_results.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert [r["lr"] for r in lines] == [1e-4, 1e-3]
    for r in lines:
        assert os.path.isfile(os.path.join(r["dir"], "checkpoint_last.pt"))
    assert best == max(lines, key=lambda r: r["best_mrr"])

    # requeue after preemption: completed grid points are reused, not
    # re-run and re-appended
    best2 = launch.main(argv)
    assert best2["dir"] == best["dir"]
    with open(tmp_path / "sweep" / "sweep_results.jsonl") as f:
        assert len(f.readlines()) == 2
