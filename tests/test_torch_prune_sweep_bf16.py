"""scripts_dev/prune_sweep_torch.py against the JAX package in bf16: the
set-up of tests/test_torch_prune_sweep.py (one JAX-made mini retriever, one
JAX ``encode_corpus`` directory) at the preset's own dtype and the
script's bf16 index.  The port's whole ``_sweep`` runs in bf16.  Each
package's hop 1 is also searched once (the sweep's margin-off
configuration) in bf16 and, over an fp32 index of the same weights, in
fp32: the port's bf16 error is held to JAX's own.
"""

import numpy as np
import pytest

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import encode_corpus as jencode
from multihop_dense_retrieval_tpu.cli import eval_mhop_retrieval as jeval
from multihop_dense_retrieval_tpu.core import config as jconfig
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import (
    eval_mhop_retrieval as teval)
from multihop_dense_retrieval_tpu_torch.core import config as tconfig
from multihop_dense_retrieval_tpu_torch.search import beam as tbeam
from tests.test_torch_prune_sweep import (  # noqa: F401 (a fixture)
    N_DOCS, N_TRAIN, PS, _sweeps, one_torch_thread)


def _hop1(side, tmp, index_dir, rows, dtype):
    """One package's hop-1 candidates (ids, scores as fp32) for the sweep's
    16 questions: its engine with the sweep's margin-off configuration,
    the mini preset at ``dtype``, over ``index_dir``."""
    common, config, ev = ((jcommon, jconfig, jeval) if side == "jax"
                          else (tcommon, tconfig, teval))
    tok = common.resolve_tokenizer("hash")
    cfg = config.SearchConfig(
        beam_size_1=PS.BEAM, beam_size_2=PS.BEAM, topk=PS.TOPK,
        max_q_len=PS.MAX_Q_LEN, max_q_sp_len=PS.MAX_Q_SP_LEN,
        chunk_rows=N_DOCS, hop2_buckets=(32, 48, 64, 80),
        hop2_tile_fracs=(0.25, 0.375, 0.25, 0.125),
        **({"use_pallas": False} if side == "jax" else {}))
    enc = common.resolve_encoder_config("mini", dtype=dtype)
    if side == "jax":
        model, params = common.init_retriever(
            enc, checkpoint=str(tmp / "stage1_jax" / "checkpoint_best"))
        searcher = ev.load_searcher(index_dir, tok, model, params, cfg)
    else:
        model = common.init_retriever(
            enc, checkpoint=str(tmp / "stage1_port" / "checkpoint_best.pt"),
            device="cpu")
        searcher = ev.load_searcher(index_dir, tok, model, cfg, "cpu")
    qs = [r["question"][:-1] if r["question"].endswith("?")
          else r["question"] for r in rows]
    assert len(qs) == PS.BATCH
    raw = [tok.raw_ids_padded(q, PS.RAW_Q_LEN) for q in qs]
    out = searcher.search(tok.encode_batch_one(qs, PS.MAX_Q_LEN),
                          np.stack([r[0] for r in raw]),
                          np.array([r[1] for r in raw]))
    return (np.asarray(out["hop1_cand_ids"]),
            np.asarray(out["hop1_cand_scores"]).astype(np.float32))


@pytest.fixture(scope="module")
def bf16_sweep(tmp_path_factory):
    """(the port's sweep results, the hop-1 candidates of each of its
    searches, {(package, dtype): hop-1 candidates of one search})."""
    tmp = tmp_path_factory.mktemp("sweep_bf16")
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        search = tbeam.BeamSearcher.search

        def recorded(self, *a, **kw):
            out = search(self, *a, **kw)
            seen.append((out["hop1_cand_ids"],
                         out["hop1_cand_scores"].astype(np.float32)))
            return out

        mp.setattr(tbeam.BeamSearcher, "search", recorded)
        _, pres, _, _ = _sweeps(tmp, "bfloat16", jax_sweep=False)
    (tmp / "rows").mkdir()
    rows = PS.make_data(str(tmp / "rows"), np.random.RandomState(0),
                        n_docs=N_DOCS, n_train=N_TRAIN)[2]
    with pytest.MonkeyPatch.context() as mp:
        mini = jcommon.MODEL_PRESETS["mini"]
        mp.setitem(jcommon.MODEL_PRESETS, "mini",
                   lambda dtype=None: mini(dtype="float32"))
        jencode.main([str(tmp / "port" / "corpus.jsonl"),
                      str(tmp / "index32"), "--checkpoint",
                      str(tmp / "stage1_jax" / "checkpoint_best"),
                      "--tokenizer", "hash", "--model-name", "mini",
                      "--batch-size", "64", "--chunk-rows", str(N_DOCS),
                      "--max-c-len", "64", "--index-dtype", "float32"])
    hop1 = {(side, dtype, index): _hop1(side, tmp, str(tmp / index), rows,
                                        dtype)
            for side in ("jax", "port")
            for dtype, index in (("bfloat16", "index"),
                                 ("bfloat16", "index32"),
                                 ("float32", "index32"))}
    return pres, seen, hop1


def _score_error(hop1, side, index):
    """(q, r) -> |the r-th best hop-1 score of the bf16 encoder over
    ``index`` - the r-th best of the fp32 encoder over the fp32 index|:
    the r-th best of a set of scores moves by at most the largest change
    of any score, so this is bf16's error whatever the ids."""
    return np.abs(hop1[(side, "bfloat16", index)][1]
                  - hop1[(side, "float32", "index32")][1])


def test_sweep_bf16_within_two_questions_of_jax(bf16_sweep):
    """bf16 (the preset's dtype, the script's bf16 index): the port's sweep
    runs its eight searches, each with the same hop 1 (the margins prune
    hop 2 only), the hop 1 of one bf16 search of the port's engine.  In
    fp32 the two packages' hop 1 is the same (ids equal, scores within
    1e-5 relative); in bf16 it differs between them, the random mini
    model's candidates lying 0.1-1 apart on scores of about 60, within
    the two encoders' bf16 rounding.  So the port's bf16 path is held to
    the size of JAX's own bf16 error, from the fp32 encoder over the fp32
    index: the mean and the largest distance of each package's r-th best
    hop-1 score from its r-th best fp32 one, over the 16 questions' top
    4, are within a factor of 2 of JAX's, once for the bf16 encoder over
    the fp32 index (the encoder's rounding alone) and once over the bf16
    index (the script's path, where the index's rounding dominates); a
    path that stayed in fp32 has no such error, a broken one far more.
    And at least 14 of the 16 questions (all but two) keep JAX's bf16
    top-1 id within the port's top 2."""
    pres, seen, hop1 = bf16_sweep
    assert len(seen) == 8
    ids, scores = hop1[("port", "bfloat16", "index")]
    for seen_ids, seen_scores in seen:
        assert np.array_equal(seen_ids[:N_TRAIN], ids)
        assert np.array_equal(seen_scores[:N_TRAIN], scores)
    exact = [hop1[(side, "float32", "index32")] for side in ("port", "jax")]
    assert np.array_equal(exact[0][0], exact[1][0])
    np.testing.assert_allclose(exact[0][1], exact[1][1], rtol=1e-5)
    for index in ("index32", "index"):
        jerr = _score_error(hop1, "jax", index)
        perr = _score_error(hop1, "port", index)
        assert 0.5 <= perr.mean() / jerr.mean() <= 2, \
            (index, perr.mean(), jerr.mean())
        assert 0.5 <= perr.max() / jerr.max() <= 2, \
            (index, perr.max(), jerr.max())
    jids = hop1[("jax", "bfloat16", "index")][0]
    kept = sum(int(jids[q, 0] in ids[q, :2]) for q in range(N_TRAIN))
    assert kept >= N_TRAIN - 2, kept
    margins = [k for k in pres if k.startswith("margin_")]
    assert len(margins) == 7
    for k in margins:
        assert 0 <= pres[k]["pruned_frac"] < 1, k
