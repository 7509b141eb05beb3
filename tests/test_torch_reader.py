"""Reader parity: the port's QAReader, QA features, span decoding,
predict and HotpotQA metrics against the JAX package's, on the synthetic
fixtures of tests/test_reader.py, with the same weights (carried by
``reader_state_dict_from_jax``).

Tolerances:
  * QAReader logits, rank and sp scores: fp32 atol 1e-5 (summation order);
    bf16 atol 0.1 with 99% within 0.03 (tests/test_torch_encoder.py's
    rule; the -1e30 masked logits compare exactly);
  * features, decode_spans (on the same fp32 logits, ties included),
    answers, supporting facts, chain EM and λ-sweep metrics of predict in
    fp32, and hotpot_metrics: equal.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxHashTokenizer
from multihop_dense_retrieval_tpu.data import qa_dataset as jqa
from multihop_dense_retrieval_tpu.eval import hotpot_metrics as jhm
from multihop_dense_retrieval_tpu.eval import qa_eval as jqe
from multihop_dense_retrieval_tpu.models import convert as jconvert
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.train import qa as JTQA
from multihop_dense_retrieval_tpu_torch.cli import common
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.data import qa_dataset as tqa
from multihop_dense_retrieval_tpu_torch.eval import hotpot_metrics as thm
from multihop_dense_retrieval_tpu_torch.eval import qa_eval as tqe
from multihop_dense_retrieval_tpu_torch.models import (
    QAReader, reader_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.train import qa as TQA
from tests.test_reader import _chain, _mini_qa_rows

READER_KW = dict(vocab_size=512, max_position_embeddings=128,
                 type_vocab_size=2, pad_token_id=0, roberta_positions=False)
WIDEN = 4.0


def _toks():
    return (JaxHashTokenizer(vocab_size=512, roberta_style=False),
            HashTokenizer(vocab_size=512, roberta_style=False))


def _datasets(rows=None, train=False, **kw):
    jt, tt = _toks()
    rows = _mini_qa_rows() if rows is None else rows
    kw = dict(dict(max_seq_len=96, max_q_len=12, num_answer_slots=4,
                   max_sents=8, train=train), **kw)
    return jqa.QADataset(jt, rows, **kw), tqa.QADataset(tt, rows, **kw)


def _readers(seed=0, widen=WIDEN, sp_pred=True, **cfg_kw):
    """(JAX reader, its params, the port's reader with the same weights);
    kernels scaled by ``widen`` to spread the random model's scores."""
    kw = dict(READER_KW, **cfg_kw)
    jds, _ = _datasets()
    batch = jqa.qa_collate([jds[i] for i in range(2)])["net_inputs"]
    jmodel = JaxReader(JaxEncoderConfig.tiny(**kw), sp_pred=sp_pred)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * widen if "kernel" in jax.tree_util.keystr(path)
        else x, params)
    model = QAReader(EncoderConfig.tiny(**kw), sp_pred=sp_pred)
    model.load_state_dict(reader_state_dict_from_jax(jax.device_get(params)))
    return jmodel, params, model.eval()


def _close(got, exp, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    else:
        err = np.abs(got - exp)
        assert err.max() < 0.1, err.max()
        assert np.mean(err < 0.03) >= 0.99, np.mean(err < 0.03)


@pytest.mark.parametrize("dtype,scores", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
@pytest.mark.parametrize("arch", [{}, dict(embedding_size=16,
                                           hidden_act="gelu_new")])
def test_reader_outputs_match_jax(dtype, scores, arch):
    jmodel, params, model = _readers(
        seed=1, widen=1.0, dtype=dtype, attention_scores_dtype=scores, **arch)
    jds, _ = _datasets()
    net = jqa.qa_collate([jds[i] for i in range(7)])["net_inputs"]
    exp = jmodel.apply(params, {k: jnp.asarray(v) for k, v in net.items()})
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in net.items()})
    for key in ("start_logits", "end_logits", "rank_score", "sp_score"):
        g, e = got[key].numpy(), np.asarray(exp[key])
        assert g.dtype == np.float32 and g.shape == e.shape, key
        masked = e <= -1e29
        np.testing.assert_array_equal(g[masked], e[masked])
        _close(g[~masked], e[~masked], dtype)


def test_reader_state_dict_is_the_reference_layout(tmp_path):
    """The converted names are the reference QAModel's: the JAX package's
    reader_ckpt_to_flax reads them back to the same tree, init_reader
    loads the .pt, a BERT reader's encoder.pooler.dense stands in for the
    top-level pooler, and sp.* is dropped for sp_pred=False."""
    jmodel, params, model = _readers(seed=2, embedding_size=16)
    sd = reader_state_dict_from_jax(jax.device_get(params))
    assert {"pooler.dense.weight", "qa_outputs.weight", "rank.weight",
            "sp.weight", "encoder.embeddings_project.weight"} <= set(sd)
    cfg = JaxEncoderConfig.tiny(**dict(READER_KW, embedding_size=16))
    back = jconvert.reader_ckpt_to_flax(
        {k: v.numpy() for k, v in sd.items()}, cfg)
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    back_flat = dict(jax.tree_util.tree_leaves_with_path({"params": back}))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]),
                                      np.asarray(leaf))

    path = str(tmp_path / "qa.pt")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    tiny = dict(common.READER_PRESETS)
    common.READER_PRESETS["tiny16"] = lambda **kw: EncoderConfig.tiny(
        **dict(READER_KW, embedding_size=16, **kw))
    try:
        _, loaded = common.init_reader("tiny16", path, device="cpu")
    finally:
        common.READER_PRESETS.clear()
        common.READER_PRESETS.update(tiny)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    bert = {("encoder." + k if k.startswith("pooler.") else k): v
            for k, v in sd.items()}
    m2 = QAReader(model.config)
    m2.load_state_dict(bert)
    assert torch.equal(m2.pooler.dense.weight, model.pooler.dense.weight)
    m3 = QAReader(model.config, sp_pred=False)
    m3.load_state_dict(sd)
    assert not hasattr(m3, "sp")


def test_decode_spans_bit_equal_with_ties():
    """Same fp32 logits in both: positions and scores equal, ties included
    (small integers make many spans tie; the first maximum wins)."""
    rng = np.random.RandomState(3)
    for B, L, max_len, hi in ((5, 16, 4, 3), (4, 40, 30, 2), (3, 9, 0, 5)):
        start = rng.randint(-hi, hi, (B, L)).astype(np.float32)
        end = rng.randint(-hi, hi, (B, L)).astype(np.float32)
        start[0] = end[0] = 1.0                      # every span ties
        start[1, :3] = -1e30                         # masked columns
        exp = JTQA.decode_spans(jnp.asarray(start), jnp.asarray(end), max_len)
        got = TQA.decode_spans(torch.from_numpy(start), torch.from_numpy(end),
                               max_len)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    real = rng.randn(6, 64).astype(np.float32)
    exp = JTQA.decode_spans(jnp.asarray(real), jnp.asarray(real[::-1]), 30)
    got = TQA.decode_spans(torch.from_numpy(real),
                           torch.from_numpy(np.ascontiguousarray(real[::-1])),
                           30)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _same_sample(t, j):
    assert set(t["features"]) == set(j["features"])
    for k, v in j["features"].items():
        np.testing.assert_array_equal(t["features"][k], v, err_msg=k)
    assert t["meta"] == j["meta"]


@pytest.mark.parametrize("train", [True, False])
def test_qa_features_bit_equal(train):
    jds, tds = _datasets(train=train)
    assert len(tds) == len(jds)
    assert tds.data == jds.data
    for i in range(len(jds)):
        _same_sample(tds[i], jds[i])
    jb = jqa.qa_collate([jds[i] for i in range(len(jds))])
    tb = tqa.qa_collate([tds[i] for i in range(len(tds))])
    for k, v in jb["net_inputs"].items():
        np.testing.assert_array_equal(tb["net_inputs"][k], v)
    if train:
        js = jqa.QAGroupSampler(jds, neg_num=2, seed=0)
        ts = tqa.QAGroupSampler(tds, neg_num=2, seed=0)
        assert ts.epoch_indices() == js.epoch_indices()


def test_feature_builder_and_helpers_bit_equal():
    jt, tt = _toks()
    assert tqa.prepare_context(_chain(), tt) == jqa.prepare_context(_chain(),
                                                                    jt)
    doc = "yes no [SEP] Alpha [unused1] the sky is blue . ".split()
    for ans in (["blue"], ["sky is blue"], ["absent"], ["yes"]):
        assert tqa.find_answer_spans(doc, ans) == \
            jqa.find_answer_spans(doc, ans)
    item = {"question": "what color is the sky", "passages": _chain(),
            "label": 1, "qid": "q0", "gold_answer": ["blue"],
            "sp_sent_labels": [1, 0, 0], "ans_covered": 1, "sp_gold": []}
    kw = dict(max_seq_len=40, max_q_len=6, num_answer_slots=4, max_sents=2)
    for train in (True, False):
        _same_sample(tqa.QAFeatureBuilder(tt, **kw).build(item, train=train),
                     jqa.QAFeatureBuilder(jt, **kw).build(item, train=train))
    words = "The Sky is BLUE , said Paris-born ALPHA".split()
    for s, e in ((0, 3), (2, 5), (4, 4), (6, 20), (-1, 2)):
        assert tqa.decode_answer(words, words, list(range(len(words))),
                                 s, e) == \
            jqa.decode_answer(words, words, list(range(len(words))), s, e)
    for pred, orig in (("sky is blue", "Sky is BLUE ,"),
                       ("paris-born", "Paris-born"), ("zzz", "abc")):
        assert tqa.get_final_text(pred, orig) == jqa.get_final_text(pred,
                                                                    orig)


def test_hotpot_metrics_equal():
    for pred, gold in (("Paris", "paris"), ("the blue sky", "blue sky"),
                       ("yes", "no"), ("a b c", "b c d"), ("", "x")):
        assert thm.exact_match_score(pred, gold) == \
            jhm.exact_match_score(pred, gold)
        assert thm.f1_score(pred, gold) == jhm.f1_score(pred, gold)
    sp_pred = [["A", 0], ["B", 1], ["C", 2]]
    sp_gold = [["A", 0], ["B", 2]]
    jm, tm_ = jhm.new_metrics(), thm.new_metrics()
    ja = jhm.update_answer(jm, "the sky", "sky")
    ta = thm.update_answer(tm_, "the sky", "sky")
    js = jhm.update_sp(jm, sp_pred, sp_gold)
    ts = thm.update_sp(tm_, sp_pred, sp_gold)
    assert (ta, ts) == (ja, js)
    jhm.joint_metrics(jm, *ja, *js)
    thm.joint_metrics(tm_, *ta, *ts)
    assert dict(tm_) == dict(jm)


def _jax_predict(jmodel, params, ds, **kw):
    pred = JTQA.make_qa_predict_step(jmodel, max_ans_len=8)
    rank = JTQA.make_qa_rank_step(jmodel) if kw.get("rank_topm") else None
    return jqe.predict(pred, params, ds, rank_step=rank, **kw)


def _port_predict(model, ds, **kw):
    pred = TQA.make_qa_predict_step(model, max_ans_len=8)
    rank = TQA.make_qa_rank_step(model) if kw.get("rank_topm") else None
    return tqe.predict(pred, ds, rank_step=rank, **kw)


def _same_predictions(got, exp):
    assert got["chain_em"] == exp["chain_em"]
    assert got["n_questions"] == exp["n_questions"]
    for key in ("answers", "sp", "selection_metric", "lambda"):
        assert got["best"][key] == exp["best"][key], key
    assert got["per_lambda"].keys() == exp["per_lambda"].keys()
    for lam, stats in exp["per_lambda"].items():
        assert got["per_lambda"][lam] == pytest.approx(stats, abs=1e-12)


def _many_rows(n=6):
    rows = _mini_qa_rows(n)
    rng = np.random.RandomState(4)
    for r in rows:                       # vary the chains' lengths
        for chain in r["candidate_chains"]:
            for p in chain:
                p["sents"] = p["sents"] + [
                    " ".join(f"w{rng.randint(300)}" for _ in range(
                        rng.randint(2, 9))) + " ."
                    for _ in range(rng.randint(0, 3))]
    return rows


@pytest.mark.parametrize("rank_kw", [
    dict(), dict(rank_topm=2, rank_width=64), dict(rank_topm=1,
                                                   rank_width=None),
    dict(rank_topm=10, rank_width=48)])
def test_predict_matches_jax(rank_kw):
    """One-stage and two-stage reads: the same answers, sp, chain EM and
    λ-sweep metrics as the JAX predict (fp32 reader, same weights)."""
    jmodel, params, model = _readers(seed=5)
    jds, tds = _datasets(_many_rows(), max_seq_len=128)
    kw = dict(batch_size=4, lambdas=[0.0, 0.3, 0.8, 1.0], **rank_kw)
    exp = _jax_predict(jmodel, params, jds, **kw)
    got = _port_predict(model, tds, **kw)
    _same_predictions(got, exp)
    if rank_kw.get("rank_topm"):
        jkeep, _ = jqe.rank_filter(JTQA.make_qa_rank_step(jmodel), params,
                                   jds, batch_size=4,
                                   topm=rank_kw["rank_topm"],
                                   rank_width=rank_kw["rank_width"])
        tkeep, cache = tqe.rank_filter(TQA.make_qa_rank_step(model), tds,
                                       batch_size=4,
                                       topm=rank_kw["rank_topm"],
                                       rank_width=rank_kw["rank_width"])
        assert tkeep == jkeep and sorted(cache) == tkeep
        per_q = collections.Counter(tds.data[i]["qid"] for i in tkeep)
        assert set(per_q.values()) == {min(rank_kw["rank_topm"], 4)}


def test_predict_width_bucketing_is_exact():
    """Length-sorted, 64-multiple-width batches give the answers and sp of
    the unsorted full-width read (pads are masked), as in JAX."""
    _, _, model = _readers(seed=6)
    _, tds = _datasets(_many_rows(), max_seq_len=128)
    plain = _port_predict(model, tds, batch_size=4, length_sort=False,
                          width_multiple=0)
    bucketed = _port_predict(model, tds, batch_size=3)
    assert plain["best"]["answers"] == bucketed["best"]["answers"]
    assert plain["best"]["sp"] == bucketed["best"]["sp"]


def test_predict_selection_without_sp_gold_matches_jax():
    rows = _mini_qa_rows()
    for r in rows:
        r["sp"] = []
    jmodel, params, model = _readers(seed=7)
    jds, tds = _datasets(rows)
    kw = dict(batch_size=4, lambdas=[0.0, 0.5, 1.0])
    got = _port_predict(model, tds, **kw)
    _same_predictions(got, _jax_predict(jmodel, params, jds, **kw))
    assert got["best"]["selection_metric"] == "f1"


def test_reader_presets_match_jax():
    from multihop_dense_retrieval_tpu.cli import train_qa

    assert set(common.READER_PRESETS) == set(train_qa.READER_PRESETS)
    for name, fn in common.READER_PRESETS.items():
        assert dataclasses.asdict(fn(attention_scores_dtype="bfloat16")) == \
            dataclasses.asdict(train_qa.READER_PRESETS[name](
                attention_scores_dtype="bfloat16")), name
    assert dataclasses.asdict(common.resolve_encoder_config("electra-large")) \
        == dataclasses.asdict(JaxEncoderConfig.electra_large())


def test_reader_hash_tokenizer_takes_the_reader_vocab():
    """The reader's hash tokenizer is sized to the reader's vocabulary:
    at electra-large (30522) every id is a row of its embedding table;
    at 50265 (the tiny reader) it is the JAX pipeline's tokenizer."""
    for name, vocab in (("electra-large", 30522), ("tiny", 50265)):
        cfg = common.READER_PRESETS[name]()
        tok = common.resolve_reader_tokenizer("hash", cfg)
        assert tok.spec.vocab_size == vocab and not tok.spec.roberta_style
        ids = tok.tokenize_ids(" ".join(f"w{i}" for i in range(5000)))
        assert max(ids) < cfg.vocab_size
    jt = JaxHashTokenizer(roberta_style=False)
    text = "which river runs through the capital ?"
    assert tok.encode_one(text, 16)["input_ids"].tolist() == \
        jt.encode_one(text, 16)["input_ids"].tolist()


def test_init_reader_makes_seeded_weights_on_the_device():
    cfg, a = common.init_reader("tiny", seed=3, device="cpu")
    _, b = common.init_reader("tiny", seed=3, device="cpu")
    assert cfg.dtype == "float32" and not a.training
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    _, c = common.init_reader("tiny", seed=4, device="cpu")
    assert not torch.equal(a.rank.weight, c.rank.weight)
    _, d = common.init_reader("tiny", scores_dtype="bfloat16", device="cpu")
    assert d.config.attention_scores_dtype == "bfloat16"
