"""Reader training parity: the port's ``train/qa.py::qa_loss`` and
``make_qa_train_step``, ``QAReader(fp32_params, remat)`` and
``cli/train_qa`` against the JAX package's, on the same numpy batches and
weights (carried across with ``models/convert.reader_state_dict_from_jax``);
then the JAX package's reader-training tests, ported
(tests/test_reader.py::test_qa_loss_matches_torch_oracle and
test_qa_train_and_predict_end_to_end, tests/test_e2e.py::test_train_qa_cli).

Tolerances:
  * ``qa_loss`` on the same fp32 outputs: rel 1e-6 (summation order), with
    rows whose answer is not covered and without the sp term; its input
    gradients rtol 1e-5, atol 1e-6; the torch oracle rel 1e-5, as the JAX
    test holds JAX to it.
  * 1 and 3 train steps of a tiny reader in fp32 compute: the loss rel
    1e-5; the first step's gradients (through Adam's first moments) to
    1e-7 + 1e-4 of each tensor's largest; parameters within
    ``chip_smoke.adam_bound`` (tests/test_torch_train.py states it).
  * one bf16-compute step over fp32 master weights, held to JAX's step
    run op by op in units of JAX's own bf16-vs-fp32 distance, as
    tests/test_torch_train.py::test_bf16_train_step_matches_jax does; an
    fp32 step, the control, fails both bounds.
  * a checkpoint that ``cli/train_qa`` writes, read by the JAX package's
    ``init_reader``: rank and span logits within 1e-5 (fp32) of the
    port's.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import train_qa as jtrain_qa
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.core.config import \
    RetrieverTrainConfig as JaxTrainConfig
from multihop_dense_retrieval_tpu.data import qa_dataset as jqa
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.train import qa as JTQA
from multihop_dense_retrieval_tpu.train import trainer as JT
from multihop_dense_retrieval_tpu_torch.cli import common, train_qa
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.data import qa_dataset as tqa
from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict
from multihop_dense_retrieval_tpu_torch.models import (
    QAReader, reader_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.train import qa as TQA
from multihop_dense_retrieval_tpu_torch.train import trainer as T
from tests import synth
from tests.test_e2e import _qa_rows
from tests.test_reader import _mini_qa_rows
from tests.test_torch_train import (LR, _capture_grads, _check_moments,
                                    _check_params, _rel)

READER_KW = dict(vocab_size=512, max_position_embeddings=128,
                 type_vocab_size=2, pad_token_id=0, roberta_positions=False)
DS_KW = dict(max_seq_len=96, max_q_len=12, num_answer_slots=4, max_sents=8)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# ---- the loss ---------------------------------------------------------------


def _loss_inputs(seed=0, B=5, L=24, A=3, S=6):
    """Random fp32 reader outputs and supervision: a row with no covered
    answer (all slots -1), a -1e30 paragraph-masked column, ragged
    sentence masks, gold and negative chains."""
    rng = np.random.RandomState(seed)
    start = rng.randn(B, L).astype(np.float32)
    end = rng.randn(B, L).astype(np.float32)
    start[:, 0] = end[:, 0] = -1e30
    outputs = {"start_logits": start, "end_logits": end,
               "rank_score": rng.randn(B, 1).astype(np.float32),
               "sp_score": rng.randn(B, S).astype(np.float32)}
    batch = {"label": np.array([1, 0, 1, 0, 1], np.int32)[:B],
             "starts": np.array([[2, 5, -1], [-1, -1, -1], [7, -1, -1],
                                 [3, 4, 5], [9, 9, 1]], np.int32)[:B],
             "ends": np.array([[2, 6, -1], [-1, -1, -1], [9, -1, -1],
                               [3, 4, 6], [11, 12, 3]], np.int32)[:B],
             "sent_labels": rng.randint(0, 2, (B, S)).astype(np.int32),
             "sent_mask": (rng.rand(B, S) > 0.3).astype(np.int32)}
    return outputs, batch


@pytest.mark.parametrize("sp_pred", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_qa_loss_matches_jax(sp_pred, seed):
    """The loss and its gradients with respect to the reader's outputs."""
    out, batch = _loss_inputs(seed)
    kw = dict(sp_weight=0.7, sp_pred=sp_pred)
    exp = float(JTQA.qa_loss(_j(out), _j(batch), **kw))
    got = float(TQA.qa_loss(_t(out), _t(batch), **kw))
    assert got == pytest.approx(exp, rel=1e-6)

    keys = ["start_logits", "end_logits", "rank_score", "sp_score"]
    jg = jax.grad(lambda o: JTQA.qa_loss(o, _j(batch), **kw))(_j(out))
    tt = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    TQA.qa_loss(tt, _t(batch), **kw).backward()
    for k in keys:
        g = tt[k].grad
        if g is None:              # the sp term is off: no gradient there
            assert not sp_pred and k == "sp_score"
            assert not np.any(np.asarray(jg[k]))
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_qa_loss_without_covered_answers_is_rank_and_sp_only():
    """Rows with no covered answer add nothing to the span term: a batch
    of them leaves the rank and sp terms alone, both ways."""
    out, batch = _loss_inputs(2)
    batch["starts"][:] = -1
    batch["ends"][:] = -1
    exp = float(JTQA.qa_loss(_j(out), _j(batch)))
    got = float(TQA.qa_loss(_t(out), _t(batch)))
    assert got == pytest.approx(exp, rel=1e-6)
    no_sp = float(TQA.qa_loss(_t(out), _t(batch), sp_pred=False))
    rank = torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(out["rank_score"]).reshape(-1),
        torch.from_numpy(batch["label"]).float(), reduction="sum")
    assert no_sp == pytest.approx(float(rank), rel=1e-6)


def test_qa_loss_matches_torch_oracle():
    """tests/test_reader.py's oracle (qa_model.py:73-101 with the masked sp
    weighting), held against the port."""
    import torch.nn.functional as F

    rng = np.random.RandomState(0)
    B, L, A, S = 4, 24, 3, 6
    start_logits = rng.randn(B, L).astype(np.float32)
    end_logits = rng.randn(B, L).astype(np.float32)
    rank = rng.randn(B, 1).astype(np.float32)
    sp_score = rng.randn(B, S).astype(np.float32)
    label = np.array([1, 0, 1, 0], np.int32)
    starts = np.array([[2, 5, -1], [-1, -1, -1], [7, -1, -1], [3, 4, 5]],
                      np.int32)
    ends = np.array([[2, 6, -1], [-1, -1, -1], [9, -1, -1], [3, 4, 6]],
                    np.int32)
    sent_labels = rng.randint(0, 2, (B, S)).astype(np.int32)
    sent_mask = (rng.rand(B, S) > 0.3).astype(np.int32)
    got = float(TQA.qa_loss(
        _t({"start_logits": start_logits, "end_logits": end_logits,
            "rank_score": rank, "sp_score": sp_score}),
        _t({"label": label, "starts": starts, "ends": ends,
            "sent_labels": sent_labels, "sent_mask": sent_mask}),
        sp_weight=0.05))

    t_start, t_end = torch.tensor(start_logits), torch.tensor(end_logits)
    ce = torch.nn.CrossEntropyLoss(ignore_index=-1, reduction="none")
    rank_loss = F.binary_cross_entropy_with_logits(
        torch.tensor(rank), torch.tensor(label).float().unsqueeze(1),
        reduction="sum")
    sl = [ce(t_start, torch.tensor(starts[:, j]).long()) for j in range(A)]
    el = [ce(t_end, torch.tensor(ends[:, j]).long()) for j in range(A)]
    loss_tensor = torch.stack(sl, 1) + torch.stack(el, 1)
    log_prob = (-loss_tensor).float().masked_fill(loss_tensor == 0,
                                                  float("-inf"))
    marginal = torch.exp(log_prob).sum(1)
    m = marginal[marginal.nonzero()]
    span_loss = -torch.log(m).sum() if len(m) else torch.tensor(0.0)
    sp_loss = F.binary_cross_entropy_with_logits(
        torch.tensor(sp_score), torch.tensor(sent_labels).float(),
        reduction="none")
    sp_loss = (sp_loss * torch.tensor(sent_mask)
               * torch.tensor(label).float().unsqueeze(1)).sum()
    expected = float(rank_loss + span_loss + 0.05 * sp_loss)
    assert got == pytest.approx(expected, rel=1e-5)


# ---- train steps against the JAX package ------------------------------------


def _train_batches(n=3, b=4):
    """``n`` collated train batches of ``b`` chains (gold and negative,
    covered and not) from tests/test_reader.py's rows, by the JAX
    featurizer (tests/test_torch_reader.py holds the port's bit-equal)."""
    from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxTok

    ds = jqa.QADataset(JaxTok(vocab_size=512, roberta_style=False),
                       _mini_qa_rows(), train=True, **DS_KW)
    return [jqa.qa_collate([ds[i] for i in range(s * b, (s + 1) * b)]
                           )["net_inputs"] for s in range(n)]


def _tcfg():
    return dict(learning_rate=LR, warmup_ratio=0.0)


@functools.lru_cache(maxsize=None)
def _jax_reader_params():
    jmodel = JaxReader(JaxEncoderConfig.tiny(**READER_KW), sp_pred=True)
    return jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                _j(_train_batches(1)[0]))


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """Three JAX reader train steps (fp32): the losses, the parameters after
    1 and 3 steps, the optimizer state after 1."""
    jmodel = JaxReader(JaxEncoderConfig.tiny(**READER_KW), sp_pred=True)
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    jstate = JT.TrainState.create(_jax_reader_params(), jtx)
    jstep = JTQA.make_qa_train_step(jmodel, jtx, sp_weight=0.5)
    losses, params, opt1 = [], {}, None
    for i, b in enumerate(_train_batches(), 1):
        jstate, loss = jstep(jstate, _j(b))
        losses.append(float(loss))
        params[i] = jax.device_get(jstate.params)
        if i == 1:
            opt1 = jax.device_get(jstate.opt_state)
    return losses, params, opt1


def _port_reader(dtype="float32", remat=False):
    model = QAReader(EncoderConfig.tiny(dtype=dtype, **READER_KW),
                     sp_pred=True, fp32_params=True, remat=remat)
    model.load_state_dict(reader_state_dict_from_jax(
        jax.device_get(_jax_reader_params())))
    return model.train()


@pytest.mark.parametrize("remat", [False, True])
def test_reader_train_steps_match_jax(remat):
    """One and three reader train steps (fp32 compute; remat recomputes,
    the same numbers) from the same weights and batches: the loss, the
    first step's gradients through Adam's first moments, parameters."""
    jlosses, jparams, jopt1 = _jax_steps()
    model = _port_reader(remat=remat)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    grads = _capture_grads(state)
    step = TQA.make_qa_train_step(sp_weight=0.5)
    worst = {}
    for i, b in enumerate(_train_batches(), 1):
        state, loss = step(state, _t(b))
        assert float(loss) == pytest.approx(jlosses[i - 1], rel=1e-5)
        if i == 1:
            _check_moments(state, jopt1, reader_state_dict_from_jax)
            g0 = {k: v.numpy() for k, v in grads[0].items()}
        if i in (1, 3):
            worst[i] = _check_params(model.state_dict(), jparams[i], g0,
                                     reader_state_dict_from_jax, i,
                                     1e-3 if i == 1 else 1e-2)
    assert state.step == 3
    print(f"worst parameter element after 1 / 3 steps: {worst[1]:.2e} / "
          f"{worst[3]:.2e} lr")


def _outputs(out, batch):
    """The reader's outputs as one dict of fp32 arrays, the span logits at
    the paragraph positions only (the others are -1e30 both ways)."""
    pmask = np.asarray(batch["paragraph_mask"]).astype(bool)
    res = {k: np.asarray(out[k], np.float32) for k in ("rank_score",
                                                       "sp_score")}
    for k in ("start_logits", "end_logits"):
        res[k] = np.asarray(out[k], np.float32)[pmask]
    return res


def _first_step(dtype, b, eager=False):
    """The first step's loss, outputs and gradients at compute ``dtype``,
    from the shared weights: {"jax"/"port": (loss, outputs, gradients)};
    ``eager`` runs JAX op by op (``jax.disable_jit``), rounding after every
    op as the port does."""
    jmodel = JaxReader(JaxEncoderConfig.tiny(dtype=dtype, **READER_KW),
                       sp_pred=True)

    def loss_fn(params):
        out = jmodel.apply(params, _j(b))
        return JTQA.qa_loss(out, _j(b), sp_weight=0.5), out

    with jax.disable_jit(eager):
        (jloss, jout), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(_jax_reader_params())
    model = _port_reader(dtype)
    with torch.no_grad():
        pout = {k: v.float().numpy() for k, v in model(_t(b)).items()}
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    grads = _capture_grads(state)
    state, loss = TQA.make_qa_train_step(sp_weight=0.5)(state, _t(b))
    return {"jax": (float(jloss), _outputs(jout, b),
                    {k: v.numpy() for k, v in reader_state_dict_from_jax(
                        jax.device_get(jg)).items()}),
            "port": (float(loss), _outputs(pout, b),
                     {k: v.numpy() for k, v in grads[0].items()})}


def test_bf16_reader_train_step_matches_jax():
    """bf16 compute over fp32 master weights, one reader step, held to
    JAX's own bf16 noise ``n`` (how far JAX's fp32 result lies from its
    bf16 result computed op by op), as the retriever's bf16 step test:
    the outputs (rank, sp and in-paragraph span logits) within 0.5 n, the
    gradients within 0.8 n, the loss rel 1.5e-3; the port's fp32 step,
    the control, reads about 1.0 n and fails both bounds."""
    b = _train_batches(1)[0]
    ref = _first_step("bfloat16", b, eager=True)
    jl, jo, jg = ref["jax"]
    pl, po, pg = ref["port"]
    fp = _first_step("float32", b)
    (_, jo32, jg32), (_, po32, pg32) = fp["jax"], fp["port"]
    noise_o, noise_g = _rel(jo32, jo), _rel(jg32, jg)
    read = {"outputs": _rel(po, jo) / noise_o,
            "gradients": _rel(pg, jg) / noise_g,
            "loss rel": abs(pl - jl) / abs(jl),
            "fp32 outputs (control)": _rel(po32, jo) / noise_o,
            "fp32 gradients (control)": _rel(pg32, jg) / noise_g}
    print("bf16 reader step, in units of JAX's bf16 noise:", read)
    assert noise_o > 1e-3 and noise_g > 1e-3, (noise_o, noise_g)
    assert read["outputs"] <= 0.5, read
    assert read["gradients"] <= 0.8, read
    assert read["loss rel"] <= 1.5e-3, read
    assert read["fp32 outputs (control)"] > 0.5, read
    assert read["fp32 gradients (control)"] > 0.8, read


def test_fused_attention_reader_cannot_be_trained():
    """Kernel 8 has no backward (nor has the JAX package's Pallas kernel):
    a reader on attention_impl="fused" is refused."""
    model = QAReader(EncoderConfig.tiny(attention_impl="fused", **READER_KW),
                     fp32_params=True)
    with pytest.raises(ValueError, match="fused"):
        T.TrainState.create(model, T.make_optimizer(
            RetrieverTrainConfig(), 10))


# ---- the JAX package's reader-training tests, ported ------------------------


def test_qa_train_and_predict_end_to_end():
    """tests/test_reader.py::test_qa_train_and_predict_end_to_end on the
    port: six steps lower the loss; predict answers every question, and
    the length-sorted, width-bucketed predict equals the fixed-width one."""
    tok = HashTokenizer(vocab_size=512, roberta_style=False)
    torch.manual_seed(0)
    model = QAReader(EncoderConfig.tiny(**READER_KW), sp_pred=True,
                     fp32_params=True)
    rows = _mini_qa_rows()
    train_ds = tqa.QADataset(tok, rows, train=True, **DS_KW)
    net = _t(tqa.qa_collate([train_ds[i] for i in range(4)])["net_inputs"])
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(learning_rate=1e-3, warmup_ratio=0.0), 20))
    step = TQA.make_qa_train_step()
    losses = []
    for _ in range(6):
        state, loss = step(state, net)
        losses.append(float(loss))
    assert losses[-1] < losses[0]

    model.eval()
    eval_ds = tqa.QADataset(tok, rows, train=False, **DS_KW)
    pred_step = TQA.make_qa_predict_step(model, max_ans_len=8)
    res = predict(pred_step, eval_ds, batch_size=4)
    assert res["n_questions"] == 3
    assert 0.0 <= res["chain_em"] <= 1.0
    assert set(res["best"]["answers"]) == {"q0", "q1", "q2"}
    assert all(isinstance(a, str) for a in res["best"]["answers"].values())
    plain = predict(pred_step, eval_ds, batch_size=4, length_sort=False,
                    width_multiple=0)
    bucketed = predict(pred_step, eval_ds, batch_size=2, length_sort=True,
                       width_multiple=16)
    assert plain["best"]["answers"] == bucketed["best"]["answers"]
    assert plain["best"]["sp"] == bucketed["best"]["sp"]
    for k in ("em", "f1", "sp_em", "sp_f1", "joint_em", "joint_f1"):
        assert abs(plain["best"][k] - bucketed["best"][k]) < 1e-9


CLI = ["--tokenizer", "hash", "--model-name", "tiny", "--device", "cpu",
       "--predict-batch-size", "4", "--max-seq-len", "96",
       "--max-q-len", "12", "--num-answer-slots", "4", "--max-sents", "8",
       "--max-ans-len", "8"]


@pytest.mark.parametrize("no_sp", [False, True])
def test_train_qa_cli(tmp_path, capsys, no_sp):
    """tests/test_e2e.py::test_train_qa_cli on the port's CLI (and with
    --no-sp): train two epochs, then --do-predict from checkpoint_best.pt.
    The checkpoint is a reference QAModel state dict (top-level
    pooler.dense, fp32), which the JAX package's init_reader reads: its
    rank and span logits lie within 1e-5 of the port's on the same batch."""
    qa = str(tmp_path / "qa.jsonl")
    synth.write_jsonl(qa, _qa_rows())
    sp = ["--no-sp"] if no_sp else []
    out = str(tmp_path / "out")
    res, state = train_qa.main(CLI + sp + [
        "--train-file", qa, "--predict-file", qa, "--output-dir", out,
        "--batch-size", "4", "--num-epochs", "2", "--learning-rate", "1e-3",
        "--neg-num", "3", "--warmup-ratio", "0.0"])
    assert res is not None and res["n_questions"] == 3
    assert state.step == 2 * (3 * 4 // 4)
    best = os.path.join(out, "checkpoint_best.pt")
    sd = ckpt.restore_pytree(best)
    assert "pooler.dense.weight" in sd and "encoder.pooler.dense.weight" \
        not in sd
    assert ("sp.weight" in sd) != no_sp
    assert all(v.dtype == torch.float32 for v in sd.values())
    capsys.readouterr()
    res2, none = train_qa.main(CLI + sp + [
        "--do-predict", "--predict-file", qa, "--checkpoint", best])
    assert none is None and res2["n_questions"] == 3
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["chain_em"] == res2["chain_em"]

    _, jmodel, jparams = jtrain_qa.init_reader("tiny", best, not no_sp)
    _, model = common.init_reader("tiny", best, not no_sp, device="cpu")
    jt = jqa.QADataset(jtrain_qa.common.resolve_tokenizer(
        "hash", roberta_style=False), qa, train=False, **DS_KW)
    net = jqa.qa_collate([jt[i] for i in range(6)])["net_inputs"]
    exp = jmodel.apply(jparams, _j(net))
    with torch.no_grad():
        got = model(_t(net))
    for key in ("rank_score", "start_logits", "end_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(exp[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_train_qa_zero_steps_raises(tmp_path):
    """An epoch with fewer sampled rows than the batch would run no
    optimizer step and save untrained weights: both packages raise."""
    qa = str(tmp_path / "qa.jsonl")
    synth.write_jsonl(qa, _qa_rows(1))
    with pytest.raises(ValueError, match="zero optimizer steps"):
        train_qa.main(CLI + ["--train-file", qa, "--predict-file", qa,
                             "--batch-size", "64"])


def test_train_qa_reads_no_orbax_directory(tmp_path):
    qa = str(tmp_path / "qa.jsonl")
    synth.write_jsonl(qa, _qa_rows(1))
    os.makedirs(tmp_path / "checkpoint_best")
    with pytest.raises(NotImplementedError, match="export_ckpt"):
        train_qa.main(CLI + ["--do-predict", "--predict-file", qa,
                             "--checkpoint", str(tmp_path / "checkpoint_best")])
