"""The port's training CLIs, ``cli/train_retriever`` and
``cli/train_momentum``, on ``--device cpu``: the JAX package's
tests/test_variant_cli.py and tests/test_workflow.py, ported (stage 1 →
momentum from the stage-1 checkpoint → encode_corpus → eval_mhop_retrieval,
all through the port's CLIs); the checkpoints' reference layout, read by
both packages' ``init_retriever`` with equal vectors (fp32, atol 1e-5, as
tests/test_torch_encoder.py); ``--data-parallel 2`` held to the JAX CLI's
(tests/test_more_cli.py's cases run it) and to the port's single-device
run; and the flags that must raise.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import train_retriever as jtrain_retriever
from multihop_dense_retrieval_tpu_torch.cli import common
from multihop_dense_retrieval_tpu_torch.cli import (encode_corpus,
                                                    eval_mhop_retrieval,
                                                    train_momentum,
                                                    train_retriever)
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, retriever_state_dict_from_jax)
from tests import synth

# the JAX CLIs' flags; SMALL adds the port's --device cpu
COMMON = ["--tokenizer", "hash", "--model-name", "tiny",
          "--train-batch-size", "4", "--predict-batch-size", "4",
          "--num-epochs", "1", "--learning-rate", "1e-4",
          "--max-q-len", "12", "--max-q-sp-len", "32", "--max-c-len", "24"]
CPU = ["--device", "cpu"]
SMALL = COMMON + CPU


def _files(tmp_path, name="t.jsonl"):
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 32)
    rows = synth.make_mhop_rows(rng, docs, n_rows=8)
    synth.write_jsonl(tmp_path / name, rows)
    return str(tmp_path / name), docs, rows


def _same_vectors(ckpt_path, unified):
    """The checkpoint through both packages' init_retriever, fp32: equal
    vectors for the same ids."""
    rng = np.random.RandomState(1)
    ids = rng.randint(4, 500, size=(3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    jcfg = jcommon.resolve_encoder_config("tiny", dtype="float32")
    jmodel, jparams = jcommon.init_retriever(jcfg, unified=unified,
                                             checkpoint=ckpt_path)
    exp = np.asarray(jmodel.apply(jparams, jnp.asarray(ids),
                                  jnp.asarray(mask),
                                  method=jmodel.encode_seq), np.float32)
    model = common.init_retriever(
        common.resolve_encoder_config("tiny", dtype="float32"),
        unified=unified, checkpoint=ckpt_path, device="cpu")
    with torch.no_grad():
        got = model.encode_seq(torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    return model


def test_train_unified_cli(tmp_path):
    """--unified: the stop-head variant on a UnifiedDataset; its
    checkpoint is in the reference UnifiedRetriever layout (encoder_c.,
    stop., project.0/1) that both packages load."""
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 24)
    rows = synth.make_mhop_rows(rng, docs, n_rows=8)
    rows[1]["type"] = "single"
    rows[1]["pos_paras"] = rows[1]["pos_paras"][:1]
    synth.write_jsonl(tmp_path / "t.jsonl", rows)
    out = str(tmp_path / "u")
    res, _ = train_retriever.main([
        "--train-file", str(tmp_path / "t.jsonl"),
        "--predict-file", str(tmp_path / "t.jsonl"), "--unified",
        "--output-dir", out] + SMALL)
    assert res["best_mrr"] > 0
    sd = ckpt.restore_pytree(f"{out}/checkpoint_last.pt")
    assert "stop.weight" in sd and "project.0.weight" in sd
    assert all(k.startswith(("encoder_c.", "stop.", "project."))
               for k in sd)
    model = _same_vectors(f"{out}/checkpoint_last.pt", unified=True)
    assert model.use_projection and not model.stop_on_pooled


def test_train_momentum_fever_cli(tmp_path):
    rows = []
    for i in range(8):
        rows.append({
            "claim": f"claim number {i} about things",
            "evidence": [[{"title": f"A{i}", "text": f"evi text {i}"},
                          {"title": f"B{i}", "text": f"second text {i}"}]],
            "tfidf_neg": [{"title": f"N{i}", "text": "neg text"}],
            "linked_neg": [{"title": f"L{i}", "text": "neg two"}]})
    synth.write_jsonl(tmp_path / "fever_train.jsonl", rows)
    res, _ = train_momentum.main([
        "--train-file", str(tmp_path / "fever_train.jsonl"),
        "--predict-file", str(tmp_path / "fever_train.jsonl"),
        "--queue-size", "32"] + SMALL)
    assert np.isfinite(res["final_loss"])


def test_full_training_to_eval_workflow(tmp_path, capsys):
    """Stage 1 → stage-2 momentum from the stage-1 checkpoint → corpus
    encoding with the trained weights → 2-hop retrieval eval, all through
    the port's CLIs on the CPU.  Both stages' checkpoints load into the
    JAX package's init_retriever with the port's vectors."""
    train, docs, rows = _files(tmp_path, "train.jsonl")
    synth.write_jsonl(tmp_path / "corpus.jsonl",
                      [{"title": d["title"], "text": d["text"]}
                       for d in docs])
    out1 = str(tmp_path / "stage1")
    train_retriever.main(["--train-file", train, "--predict-file", train,
                          "--output-dir", out1] + SMALL)
    stage1 = os.path.join(out1, "checkpoint_best.pt")
    assert os.path.isfile(stage1)
    assert os.path.isfile(os.path.join(out1, "preempt", "trainer_state"))
    _same_vectors(stage1, unified=False)

    out2 = str(tmp_path / "stage2")
    res2, trainer = train_momentum.main([
        "--train-file", train, "--predict-file", train,
        "--init-checkpoint", stage1, "--queue-size", "32",
        "--output-dir", out2] + SMALL)
    assert np.isfinite(res2["final_loss"])
    stage2 = os.path.join(out2, "checkpoint_last.pt")
    # encoder_q only, in the stage-1 layout
    assert set(ckpt.restore_pytree(stage2)) == set(
        ckpt.restore_pytree(stage1))
    _same_vectors(stage2, unified=False)
    state = ckpt.restore_pytree(os.path.join(out2, "preempt",
                                             "trainer_state"))
    assert state["queue"].shape == (32, 32) and state["queue_ptr"] == 16
    # main hands back the trainer whose state it saved
    assert trainer.state.queue_ptr == 16
    assert torch.equal(trainer.state.queue.cpu(), state["queue"])

    idx_dir = str(tmp_path / "index")
    encode_corpus.main([str(tmp_path / "corpus.jsonl"), idx_dir,
                        "--checkpoint", stage2, "--batch-size", "8",
                        "--chunk-rows", "16", "--max-c-len", "24",
                        "--tokenizer", "hash", "--model-name", "tiny",
                        "--device", "cpu"])
    capsys.readouterr()
    eval_mhop_retrieval.main([train, idx_dir, "--checkpoint", stage2,
                              "--beam-size", "3", "--topk", "3",
                              "--batch-size", "4", "--chunk-rows", "16",
                              "--tokenizer", "hash", "--model-name", "tiny",
                              "--max-q-len", "12", "--max-q-sp-len", "32",
                              "--device", "cpu"])
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= agg["avg_p_em"] <= 1.0
    assert agg["n"] == len(rows)


@pytest.fixture
def fp32_tiny(monkeypatch):
    """The tiny preset computing in fp32 in both packages' CLIs (they
    compute in bf16, whose rounding would swamp the comparisons)."""
    for mod in (common, jcommon):
        tiny = mod.MODEL_PRESETS["tiny"]
        monkeypatch.setitem(mod.MODEL_PRESETS, "tiny",
                            lambda dtype=None, tiny=tiny: tiny(dtype="float32"))


def _init_checkpoint(tmp_path):
    """A seeded tiny retriever in the reference layout: the common start
    of the two packages' runs."""
    model = common.init_retriever(common.resolve_encoder_config("tiny"),
                                  seed=5, device="cpu")
    path = str(tmp_path / "init.pt")
    ckpt.save_pytree(path, model.state_dict())
    return path


def _vectors(sd):
    """A retriever state dict's vectors of fixed ragged rows (fp32)."""
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(4, 500, size=(4, 12)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    model = MhopRetriever(common.resolve_encoder_config("tiny",
                                                        dtype="float32"))
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.encode_seq(ids, mask).numpy()


def _jax_checkpoint(path):
    from multihop_dense_retrieval_tpu.core import checkpoint as jckpt

    return retriever_state_dict_from_jax(jckpt.restore_pytree(path))


def test_train_retriever_data_parallel_matches_jax_cli(tmp_path, caplog,
                                                       fp32_tiny):
    """--data-parallel 2 (on --device cpu: the CPU twice) from one
    --init-checkpoint, fp32 compute: the run's loss (the mean of its two steps, the
    second after the first's update) within rel 1e-5 of the JAX CLI's
    --data-parallel 2 run and of the port's single-device run, the same
    best MRR, and checkpoints whose vectors agree within 1e-5."""
    train, _, _ = _files(tmp_path)
    base = ["--train-file", train, "--predict-file", train,
            "--init-checkpoint", _init_checkpoint(tmp_path)] + COMMON
    jres = jtrain_retriever.main(base + ["--data-parallel", "2",
                                         "--output-dir", str(tmp_path / "j")])
    with caplog.at_level("INFO", logger="mdr_torch"):
        res, trainer = train_retriever.main(
            base + CPU + ["--data-parallel", "2", "--output-dir",
                          str(tmp_path / "p")])
    assert "training on Mesh({'data': 2, 'index': 1}" in caplog.text
    one, _ = train_retriever.main(base + CPU + ["--output-dir",
                                                str(tmp_path / "one")])
    assert trainer.state.step == 2
    assert res["final_loss"] == pytest.approx(jres["final_loss"], rel=1e-5)
    assert res["final_loss"] == pytest.approx(one["final_loss"], rel=1e-5)
    assert res["best_mrr"] == pytest.approx(jres["best_mrr"], abs=1e-6)
    assert res["best_mrr"] == one["best_mrr"]
    got = _vectors(ckpt.restore_pytree(str(tmp_path / "p/checkpoint_last.pt")))
    for ref in (_jax_checkpoint(str(tmp_path / "j/checkpoint_last")),
                ckpt.restore_pytree(str(tmp_path / "one/checkpoint_last.pt"))):
        np.testing.assert_allclose(got, _vectors(ref), rtol=0, atol=1e-5)


def test_train_momentum_data_parallel_matches_single_device(tmp_path,
                                                           fp32_tiny):
    """train_momentum --data-parallel 2 from a stage-1 checkpoint (fp32
    compute) against
    the port's single-device run (the JAX CLI draws its queue with
    jax.random, which torch cannot reproduce): the loss rel 1e-5, the
    global batch's key vectors enqueued in global order (atol 2e-5, the
    pointer equal), checkpoints whose vectors agree within 1e-5."""
    train, _, _ = _files(tmp_path)
    base = ["--train-file", train, "--predict-file", train,
            "--init-checkpoint", _init_checkpoint(tmp_path),
            "--queue-size", "24"] + COMMON + CPU
    res, tr = train_momentum.main(base + ["--data-parallel", "2",
                                          "--output-dir", str(tmp_path / "p")])
    one, tr1 = train_momentum.main(base + ["--output-dir",
                                           str(tmp_path / "one")])
    assert res["final_loss"] == pytest.approx(one["final_loss"], rel=1e-5)
    assert tr.state.queue_ptr == tr1.state.queue_ptr == 16
    torch.testing.assert_close(tr.state.queue, tr1.state.queue, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(
        _vectors(ckpt.restore_pytree(str(tmp_path / "p/checkpoint_last.pt"))),
        _vectors(ckpt.restore_pytree(str(tmp_path /
                                         "one/checkpoint_last.pt"))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["train_retriever", "train_momentum",
                                  "train_single", "launch"])
def test_trainer_clis_refuse_more_than_one_process(monkeypatch, tmp_path,
                                                   name):
    """Under cli/pod with two processes each loader would read the whole
    dataset: the trainers raise before reading anything."""
    import importlib

    monkeypatch.setattr(common, "world", lambda: (0, 2))
    main = importlib.import_module(
        f"multihop_dense_retrieval_tpu_torch.cli.{name}").main
    missing = str(tmp_path / "missing.jsonl")
    with pytest.raises(ValueError, match="duplicated data"):
        main(["--train-file", missing, "--predict-file", missing,
              "--tokenizer", "hash", "--model-name", "tiny"] + CPU)


def test_data_parallel_beyond_the_cards_raises(monkeypatch, tmp_path):
    """The bare --device cuda takes the visible cards: asking for more
    data entries than there are raises make_mesh's error (a named device,
    cuda:0 or cpu, repeats instead)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    missing = str(tmp_path / "missing.jsonl")
    with pytest.raises(ValueError, match="does not fit the 1 available"):
        train_retriever.main(["--train-file", missing, "--predict-file",
                              missing, "--data-parallel", "2"] + COMMON)
    mesh = common.train_mesh("cuda:0", 3)
    assert mesh.data_devices() == [torch.device("cuda", 0)] * 3


def test_unified_remat_raises(tmp_path):
    """The UnifiedRetriever has no remat: --unified --remat raises rather
    than train without it."""
    train, _, _ = _files(tmp_path)
    with pytest.raises(ValueError, match="remat"):
        train_retriever.main(["--train-file", train, "--predict-file", train,
                              "--unified", "--remat"] + SMALL)


@pytest.mark.parametrize("cli", [train_retriever, train_momentum])
def test_default_device_without_cuda_raises(monkeypatch, tmp_path, cli):
    """The training CLIs default to --device cuda: without CUDA they raise
    before reading anything, and never train on the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.jsonl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--train-file", missing, "--predict-file", missing,
                  "--tokenizer", "hash", "--model-name", "tiny"])


def _help_flags(pkg, name, capsys, options_only=False):
    """The flags a CLI's --help names (``options_only``: those of its
    option lines, not those its description mentions)."""
    import importlib

    main = importlib.import_module(f"{pkg}.cli.{name}").main
    with pytest.raises(SystemExit):
        main(["--help"])
    pattern = (r"^\s+(?:-\w, )?(--[a-z][a-z0-9-]*)" if options_only
               else r"--[a-z][a-z0-9-]*")
    return set(re.findall(pattern, capsys.readouterr().out, re.M))


@pytest.mark.parametrize("name", ["train_retriever", "train_momentum",
                                  "train_single", "train_qa", "launch"])
def test_flags_match_the_jax_clis(name, capsys):
    """The port's CLI has every flag of the JAX CLI, and --device (the
    launcher's own flags are the grid's; --device is one of the base
    train arguments it hands to train_retriever)."""
    port = _help_flags("multihop_dense_retrieval_tpu_torch", name, capsys)
    jax_flags = _help_flags("multihop_dense_retrieval_tpu", name, capsys)
    assert jax_flags <= port
    assert port - jax_flags == ({"--device"} if name != "launch" else set())
    assert "--queue-size" in port or name not in ("train_momentum",
                                                  "train_single")


def test_export_ckpt_flags_match_the_jax_cli(tmp_path, capsys):
    """export_ckpt has the JAX CLI's flags; its one difference is what
    --checkpoint takes: the port's .pt (the JAX CLI refuses one and reads
    orbax directories, which the port's refuses)."""
    from multihop_dense_retrieval_tpu.cli import export_ckpt as jexport_ckpt
    from multihop_dense_retrieval_tpu_torch.cli import export_ckpt

    flags = [_help_flags(pkg, "export_ckpt", capsys, options_only=True)
             for pkg in ("multihop_dense_retrieval_tpu_torch",
                         "multihop_dense_retrieval_tpu")]
    assert flags[0] == flags[1] == {"--help", "--checkpoint", "--arch",
                                    "--out"}
    model = common.init_retriever(common.resolve_encoder_config("tiny"),
                                  device="cpu")
    pt = str(tmp_path / "checkpoint_best.pt")
    ckpt.save_pytree(pt, model.state_dict())
    argv = ["--checkpoint", pt, "--arch", "mhop", "--out",
            str(tmp_path / "out.pt")]
    with pytest.raises(SystemExit, match="already a torch state dict"):
        jexport_ckpt.main(argv)
    assert "encoder.pooler.dense.weight" in export_ckpt.main(argv)
    os.makedirs(tmp_path / "orbax_dir")
    argv[1] = str(tmp_path / "orbax_dir")
    with pytest.raises(SystemExit, match="orbax"):
        export_ckpt.main(argv)
