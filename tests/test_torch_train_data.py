"""Training data and resume: the port's own copies of the JAX package's
``data/mhop_dataset.py``, ``data/unified_dataset.py`` and
``data/loader.py`` give bit-equal batches and ``valid`` masks for the same
files and seed over two epochs; then the JAX package's
tests/test_resume.py, ported (the full trainer state, the replayed data
order, the loader's RNG round trip, and the atomic ``.new`` / ``.old``
protocol of ``train/preemption.py`` over ``.pt`` files).  The mesh case
(``test_resume_on_device_mesh``) is in tests/test_torch_train_parallel.py.

Every comparison is exact: the datasets and the loader are numpy only.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.data import BatchLoader as JaxLoader
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxTok
from multihop_dense_retrieval_tpu.data import MhopDataset as JaxMhopDataset
from multihop_dense_retrieval_tpu.data import unified_dataset as jud
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.data import (
    BatchLoader, FeverDataset, FeverSampler, HashTokenizer, MhopDataset,
    UnifiedDataset)
from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
from multihop_dense_retrieval_tpu_torch.train.preemption import \
    PreemptionCheckpointer
from multihop_dense_retrieval_tpu_torch.train.trainer import RetrieverTrainer
from tests import synth

KW = dict(max_q_len=12, max_q_sp_len=32, max_c_len=24)


def _unified_rows(rng, docs, n):
    rows = synth.make_mhop_rows(rng, docs, n_rows=n)
    for i in (1, 4, 7):
        rows[i]["type"] = "single"
        rows[i]["pos_paras"] = rows[i]["pos_paras"][:1]
    rows[4]["neg_paras"] = []                     # a dummy c2 and negatives
    rows[7]["pos_paras"][0]["text"] += " ends here."
    return rows


def _fever_rows(n):
    rows = []
    for i in range(n):
        chain = [{"title": f"A{i}", "text": f"evi text {i}"},
                 {"title": f"Bé{i}", "text": f"second text {i}"}]
        rows.append({
            "claim": f"claim number {i} about things",
            "evidence": [[chain[0]], chain, chain[::-1]] if i % 3 else
                        [[chain[0]]],
            "tfidf_neg": [{"title": f"N{i}", "text": "neg text"}],
            "linked_neg": [{"title": f"L{j}", "text": f"neg two {j}"}
                           for j in range(i % 3 + 1)]})
    return rows


def _epochs(loader, n=2):
    return [[dict(b) for b in loader] for _ in range(n)]


def _assert_same_batches(got, exp):
    assert len(got) == len(exp) and all(len(g) == len(e)
                                        for g, e in zip(got, exp))
    for ge, ee in zip(got, exp):
        for g, e in zip(ge, ee):
            assert set(g) == set(e)
            for k in e:
                assert g[k].dtype == e[k].dtype, k
                np.testing.assert_array_equal(g[k], e[k], err_msg=k)


@pytest.mark.parametrize("kind", ["mhop", "unified", "fever"])
@pytest.mark.parametrize("train,workers", [(True, 1), (True, 3), (False, 1)])
def test_batches_bit_equal_to_jax_over_two_epochs(tmp_path, kind, train,
                                                  workers):
    """Same files, same seed: every array of every batch of two epochs,
    the shuffles, the per-sample negative draws and the eval loader's
    padded last batch with its ``valid`` mask."""
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 40)
    if kind == "fever":
        rows = _fever_rows(11)
        ports, jaxs = FeverDataset, jud.FeverDataset
    elif kind == "unified":
        rows = _unified_rows(rng, docs, 11)
        ports, jaxs = UnifiedDataset, jud.UnifiedDataset
    else:
        rows = synth.make_mhop_rows(rng, docs, n_rows=11)
        if train:                                # a row train drops
            rows[3]["neg_paras"] = rows[3]["neg_paras"][:1]
        ports, jaxs = MhopDataset, JaxMhopDataset
    path = str(tmp_path / "rows.jsonl")
    synth.write_jsonl(path, rows)
    for roberta in (True, False):
        port = ports(HashTokenizer(vocab_size=512, roberta_style=roberta),
                     path, train=train, seed=5, **KW)
        ref = jaxs(JaxTok(vocab_size=512, roberta_style=roberta), path,
                   train=train, seed=5, **KW)
        assert len(port) == len(ref) > 0
        got = _epochs(BatchLoader(port, 4, shuffle=train, seed=9,
                                  num_workers=workers))
        exp = _epochs(JaxLoader(ref, 4, shuffle=train, seed=9,
                                num_workers=workers))
        _assert_same_batches(got, exp)
        if not train:
            assert exp[0][-1]["valid"].sum() == (len(ref) % 4 or 4)
    if kind == "mhop" and train:
        assert len(port) == 10


def test_fever_sampler_matches_jax():
    for single, multi, ratio in ((range(10), range(10, 14), 2),
                                 (range(3), range(3, 9), 1)):
        a = FeverSampler(single, multi, ratio=ratio, seed=4)
        b = jud.FeverSampler(single, multi, ratio=ratio, seed=4)
        assert len(a) == len(b)
        for _ in range(3):
            ea, eb = a.epoch_indices(), b.epoch_indices()
            assert ea == eb and len(ea) == len(a)


def test_unified_stop_targets_and_fever_titles(tmp_path):
    rng = np.random.RandomState(1)
    docs = synth.make_corpus(rng, 24)
    synth.write_jsonl(tmp_path / "u.jsonl", _unified_rows(rng, docs, 8))
    ds = UnifiedDataset(HashTokenizer(vocab_size=512),
                        str(tmp_path / "u.jsonl"), **KW)
    stops = [int(ds[i]["stop_targets"]) for i in range(len(ds))]
    assert stops == [1, 0, 1, 1, 0, 1, 1, 0]
    synth.write_jsonl(tmp_path / "f.jsonl", _fever_rows(6))
    fd = FeverDataset(HashTokenizer(vocab_size=512),
                      str(tmp_path / "f.jsonl"), **KW)
    assert len(fd) == 4          # claims without a multi-title chain drop


# ---- resume (tests/test_resume.py, ported) ----------------------------------


def _setup(tmp_path, num_epochs):
    tok = HashTokenizer(vocab_size=512)
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 32)
    rows = synth.make_mhop_rows(rng, docs, n_rows=8)
    synth.write_jsonl(tmp_path / "t.jsonl", rows)
    ds = MhopDataset(tok, str(tmp_path / "t.jsonl"), train=True, **KW)
    ev = MhopDataset(tok, str(tmp_path / "t.jsonl"), **KW)
    torch.manual_seed(0)
    model = MhopRetriever(EncoderConfig.tiny(vocab_size=512,
                                             max_position_embeddings=48),
                          cls_only=True, fp32_params=True)
    tcfg = RetrieverTrainConfig(batch_size=4, num_epochs=num_epochs,
                                learning_rate=1e-4, warmup_ratio=0.0)
    return model, tcfg, \
        BatchLoader(ds, 4, shuffle=True, seed=1, num_workers=1), \
        BatchLoader(ev, 4, num_workers=1)


@pytest.mark.parametrize("momentum", [False, True])
def test_resume_after_interrupt_equals_uninterrupted(tmp_path, momentum):
    """One epoch, a new process that resumes for the second: the step,
    the epoch, best_mrr, and parameters, optimizer state, key encoder and
    queue bit-equal to an uninterrupted two-epoch run's."""
    def trainer(num_epochs, out, logs):
        model, tcfg, tl, el = _setup(tmp_path, num_epochs)
        if momentum:
            tcfg = dataclasses.replace(tcfg, momentum=True, queue_size=16)
        # the same schedule length for the interrupted and the whole run
        return RetrieverTrainer(model, tcfg, tl, el, total_steps=4,
                                output_dir=out, log_fn=logs.append)

    ref = trainer(2, str(tmp_path / "ref"), [])
    ref.run()
    t1 = trainer(1, str(tmp_path / "out"), [])
    t1.run()
    step_after_e0 = t1.state.step
    logs = []
    t2 = trainer(2, str(tmp_path / "out"), logs)
    res = t2.run()
    assert any("resumed from epoch 0" in line for line in logs)
    assert t2.state.step == 2 * step_after_e0 == ref.state.step
    assert res["best_mrr"] == ref.best_mrr
    a, b = t2.state.state_dict(), ref.state.state_dict()
    for k, v in b["params"].items():
        assert torch.equal(a["params"][k], v), k
    for pa, pb in zip(a["opt_state"]["adam"]["state"].values(),
                      b["opt_state"]["adam"]["state"].values()):
        for k in pb:
            assert torch.equal(pa[k], pb[k]), k
    assert a["opt_state"]["sched"] == b["opt_state"]["sched"]
    if momentum:
        assert torch.equal(a["queue"], b["queue"])
        assert a["queue_ptr"] == b["queue_ptr"]
        for k, v in b["params_k"].items():
            assert torch.equal(a["params_k"][k], v), k


def test_resume_replays_data_order(tmp_path):
    """The preemption sidecar carries the loader's RNG state: a resumed
    run sees the epoch-1 shuffle an uninterrupted run sees."""
    _, _, tl_ref, _ = _setup(tmp_path, num_epochs=2)
    list(tl_ref)
    out = str(tmp_path / "out")
    model, tcfg, tl, el = _setup(tmp_path, num_epochs=1)
    RetrieverTrainer(model, tcfg, tl, el, output_dir=out,
                     log_fn=lambda *_: None).run()
    model, tcfg2, tl2, el2 = _setup(tmp_path, num_epochs=2)
    RetrieverTrainer(model, tcfg2, tl2, el2, output_dir=out,
                     log_fn=lambda *_: None).run()
    list(tl_ref)
    # both loaders have consumed exactly two shuffles
    assert tl2.rng.randint(1 << 30) == tl_ref.rng.randint(1 << 30)
    meta = json.load(open(os.path.join(out, "preempt", "trainer_meta.json")))
    assert meta["epoch"] == 1 and meta["rng_state"]["alg"] == "MT19937"


def test_loader_rng_state_roundtrip():
    class _DS(list):
        pass

    ds = _DS(range(37))
    a = BatchLoader(ds, 5, shuffle=True, seed=3, num_workers=1,
                    collate=lambda x: {"v": np.asarray(x)})
    b = BatchLoader(ds, 5, shuffle=True, seed=999, num_workers=1,
                    collate=lambda x: {"v": np.asarray(x)})
    list(a)
    b.set_rng_state(json.loads(json.dumps(a.rng_state())))
    for x, y in zip([x["v"] for x in a], [x["v"] for x in b]):
        np.testing.assert_array_equal(x, y)


def test_save_keeps_previous_state_until_new_one_lands(tmp_path):
    """A kill during the state save never destroys the only resumable
    checkpoint: the save lands beside it and swaps by renames, with a
    .old fallback for a kill between them."""
    pc = PreemptionCheckpointer(str(tmp_path))
    s1 = {"w": torch.arange(4.0)}
    pc.save(s1, epoch=0, best_metric=0.1)
    s2 = {"w": torch.arange(4.0) + 10}
    pc.save(s2, epoch=1, best_metric=0.2)
    state, meta = pc.maybe_restore()
    assert torch.equal(state["w"], s2["w"]) and meta["epoch"] == 1
    assert not os.path.exists(str(tmp_path / "trainer_state.new"))
    assert not os.path.exists(str(tmp_path / "trainer_state.old"))
    # a kill between the two swap renames: restore falls back to .old
    os.rename(str(tmp_path / "trainer_state"),
              str(tmp_path / "trainer_state.old"))
    state, meta = pc.maybe_restore()
    assert state is not None and meta["epoch"] == 1
    assert torch.equal(state["w"], s2["w"])


def test_save_after_crash_between_renames_never_loses_state(tmp_path):
    """After a crash between the renames (state at .old), the next save
    must not remove .old before the promote; a present .new is complete
    and restorable."""
    pc = PreemptionCheckpointer(str(tmp_path))
    s2 = {"w": torch.arange(4.0) + 10}
    pc.save(s2, epoch=1, best_metric=0.2)
    os.rename(str(tmp_path / "trainer_state"),
              str(tmp_path / "trainer_state.old"))
    # the next save dies right after writing .new, before any promote
    s3 = {"w": torch.arange(4.0) + 20}
    ckpt.save_pytree(str(tmp_path / "trainer_state.new"), s3)
    state, _ = pc.maybe_restore()
    assert state is not None, "double crash lost the only checkpoint"
    assert torch.equal(state["w"], s2["w"])
    os.remove(str(tmp_path / "trainer_state.old"))
    state, _ = pc.maybe_restore()
    assert torch.equal(state["w"], s3["w"])
    s4 = {"w": torch.arange(4.0) + 30}
    pc.save(s4, epoch=2, best_metric=0.3)
    state, meta = pc.maybe_restore()
    assert torch.equal(state["w"], s4["w"]) and meta["epoch"] == 2
    assert not os.path.exists(str(tmp_path / "trainer_state.new"))
    assert not os.path.exists(str(tmp_path / "trainer_state.old"))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_files_round_trip(tmp_path):
    tree = {"a": torch.arange(3), "b": {"c": [torch.ones(2), 3]}, "d": 1.5}
    ckpt.save_pytree(str(tmp_path / "x" / "t.pt"), tree)
    got = ckpt.restore_pytree(str(tmp_path / "x" / "t.pt"))
    assert torch.equal(got["a"], tree["a"]) and got["d"] == 1.5
    assert torch.equal(got["b"]["c"][0], torch.ones(2))
    assert got["b"]["c"][1] == 3
    assert os.listdir(tmp_path / "x") == ["t.pt"]


def test_preempted_trainer_saves_and_stops(tmp_path):
    """A SIGTERM during an epoch: the epoch ends, the state is saved, the
    loop exits early, and a rerun resumes after that epoch."""
    import signal

    def run(step_hook=None):
        model, tcfg, tl, el = _setup(tmp_path, num_epochs=3)
        logs = []
        tr = RetrieverTrainer(model, tcfg, tl, el,
                              output_dir=str(tmp_path / "out"),
                              log_fn=logs.append)
        if step_hook:
            tr.train_step = step_hook(tr.train_step)
        prev = signal.getsignal(signal.SIGTERM)
        try:
            tr.run()
        finally:
            signal.signal(signal.SIGTERM, prev)
        return tr, logs, len(tl)

    def signalled(step):
        def wrapped(state, batch):
            os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch)
        return wrapped

    tr, logs, n = run(signalled)
    assert any("preemption signal" in line for line in logs)
    assert tr.state.step == n
    tr, logs, n = run()
    assert any("resumed from epoch 0" in line for line in logs)
    assert tr.state.step == 3 * n
