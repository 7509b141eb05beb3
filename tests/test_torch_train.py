"""Retriever training parity: the port's losses, optimizer, train states
and steps against the JAX package's ``train/losses.py`` and
``train/trainer.py``, on the same vectors, weights (carried across with
``models/convert.py``) and numpy batches; then the JAX trainer tests,
ported.

Tolerances:
  * losses on the same fp32 vectors: rel 1e-6 (summation order);
    reciprocal ranks, stop accuracies and queue pointers exactly equal;
    input gradients rtol 1e-5, atol 1e-6.
  * the optimizer: the learning rate at every update exactly optax's
    (both compute it in fp32); the clip rtol 1e-6 (the norm's summation
    order), exact where the norm is exact.
  * steps in fp32 compute (2 layers, hidden 64): the loss rel 1e-5;
    gradients atol 1e-6 + rtol 1e-4 of the tensor's largest gradient;
    parameters in units of the learning rate.  Adam's first update is
    lr·g / (|g| + eps), whose slope in g is eps / (|g| + eps)²: where the
    gradient is near zero (the attention key biases, exactly, by softmax
    shift invariance) the gradients' tolerance δ moves it by up to
    2·eps·δ / (|g| + eps)², and a sign flip by 2·lr.  Each element is
    held to that bound (capped at 2.5·lr a step) plus 1e-3·lr (1e-2·lr
    after three steps) plus two fp32 ulps of the parameter (where
    p + Δ rounds); the worst element whose gradient exceeds 1e-4 is
    reported in units of lr.
  * one bf16-compute step (fp32 master weights), against JAX's step
    run op by op, in units of JAX's own bf16-vs-fp32 distance: the
    vectors 0.5, the gradients 0.8, the loss rel 1.5e-3; an fp32
    step, the control, fails both bounds (test_bf16_train_step_matches_jax).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import adam_bound
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.core.config import \
    RetrieverTrainConfig as JaxTrainConfig
from multihop_dense_retrieval_tpu.data import BatchLoader as JaxLoader
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxTok
from multihop_dense_retrieval_tpu.data import MhopDataset as JaxMhopDataset
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxMhop
from multihop_dense_retrieval_tpu.models import SingleRetriever as JaxSingle
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.train import losses as jlosses
from multihop_dense_retrieval_tpu.train import trainer as JT
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.data import (BatchLoader,
                                                     HashTokenizer,
                                                     MhopDataset)
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, NQRetriever, QAReader, SingleRetriever, UnifiedRetriever,
    reader_state_dict_from_jax, retriever_state_dict_from_jax,
    unified_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.train import losses
from multihop_dense_retrieval_tpu_torch.train import trainer as T
from tests import synth

KW = dict(vocab_size=96, max_position_embeddings=40, hidden_size=64,
          num_heads=4, intermediate_size=128)
LR = 1e-3
VIEWS = ["q", "q_sp1", "c1", "c2", "neg_1", "neg_2"]
MHOP_WIDTHS = (("q", 12), ("q_sp", 20), ("c1", 16), ("c2", 16),
               ("neg1", 16), ("neg2", 16))


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# ---- losses -----------------------------------------------------------------


def _vectors(seed, B=6, h=16, extra=()):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(B, h).astype(np.float32) for k in VIEWS + list(extra)}


def _input_grads(jfn, tfn, out):
    """Gradients of a loss with respect to its input vectors, both ways."""
    names = sorted(out)
    jg = jax.grad(lambda d: jfn(d))(_j(out))
    tt = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    tfn(tt).backward()
    for k in names:
        if tt[k].grad is None:
            assert not np.any(np.asarray(jg[k])), k
            continue
        np.testing.assert_allclose(tt[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_queue", [False, True])
def test_mhop_loss_and_eval_match_jax(with_queue):
    out = _vectors(0)
    qu = (np.random.RandomState(1).randn(10, 16).astype(np.float32)
          if with_queue else None)
    jq = None if qu is None else jnp.asarray(qu)
    tq = None if qu is None else torch.from_numpy(qu)
    exp = float(jlosses.mhop_loss(_j(out), jq))
    assert float(losses.mhop_loss(_t(out), tq)) == pytest.approx(exp,
                                                                 rel=1e-6)
    _input_grads(lambda d: jlosses.mhop_loss(d, jq),
                 lambda d: losses.mhop_loss(d, tq), out)
    # ranks differ from row to row (ties would make a weak test)
    ev_j, ev_t = jlosses.mhop_eval(_j(out)), losses.mhop_eval(_t(out))
    assert len(np.unique(np.asarray(ev_j["rrs_1"]))) > 1
    for k in ev_j:
        np.testing.assert_array_equal(ev_t[k].numpy(), np.asarray(ev_j[k]))


def test_cross_entropy_reductions_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(5, 7).astype(np.float32) * 4
    logits[0, 3] = jlosses.NEG_INF
    targets = np.array([0, 6, 2, 3, 1], np.int32)
    for red in ("mean", "sum", "none"):
        exp = np.asarray(jlosses.cross_entropy(jnp.asarray(logits),
                                               jnp.asarray(targets), red))
        got = losses.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(targets), red).numpy()
        np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)


def test_unified_loss_and_eval_match_jax():
    out = _vectors(3, extra=())
    out["stop_logits"] = np.random.RandomState(4).randn(6, 2).astype(
        np.float32)
    stop = np.array([1, 0, 1, 1, 0, 1], np.int32)
    exp = float(jlosses.unified_loss(_j(out), jnp.asarray(stop)))
    got = float(losses.unified_loss(_t(out), torch.from_numpy(stop)))
    assert got == pytest.approx(exp, rel=1e-6)
    _input_grads(lambda d: jlosses.unified_loss(d, jnp.asarray(stop)),
                 lambda d: losses.unified_loss(d, torch.from_numpy(stop)),
                 out)
    ev_j = jlosses.unified_eval(_j(out), jnp.asarray(stop))
    ev_t = losses.unified_eval(_t(out), torch.from_numpy(stop))
    assert set(ev_j) == set(ev_t)
    assert 0 < float(ev_j["stop_acc"].mean()) < 1
    for k in ev_j:
        np.testing.assert_array_equal(ev_t[k].numpy(), np.asarray(ev_j[k]))


@pytest.mark.parametrize("with_queue", [False, True])
def test_single_loss_and_eval_match_jax(with_queue):
    rng = np.random.RandomState(5)
    out = {k: rng.randn(6, 16).astype(np.float32) for k in ("q", "c", "neg")}
    qc = rng.randn(9, 16).astype(np.float32) if with_queue else None
    jq = None if qc is None else jnp.asarray(qc)
    tq = None if qc is None else torch.from_numpy(qc)
    exp = float(jlosses.single_loss(_j(out), queue_c=jq))
    assert float(losses.single_loss(_t(out), queue_c=tq)) == pytest.approx(
        exp, rel=1e-6)
    _input_grads(lambda d: jlosses.single_loss(d, queue_c=jq),
                 lambda d: losses.single_loss(d, queue_c=tq), out)
    np.testing.assert_array_equal(
        losses.single_eval(_t(out))["rrs"].numpy(),
        np.asarray(jlosses.single_eval(_j(out))["rrs"]))


@pytest.mark.parametrize("dense,with_queue", [(False, False), (True, True)])
def test_nq_mhop_loss_matches_jax(dense, with_queue):
    rng = np.random.RandomState(6)
    names = ["q", "q_neg1", "c", "neg"] + (["dense_neg1", "dense_neg2"]
                                           if dense else [])
    out = {k: rng.randn(5, 16).astype(np.float32) for k in names}
    qu = rng.randn(7, 16).astype(np.float32) if with_queue else None
    jq = None if qu is None else jnp.asarray(qu)
    tq = None if qu is None else torch.from_numpy(qu)
    exp = float(jlosses.nq_mhop_loss(_j(out), queue=jq))
    assert float(losses.nq_mhop_loss(_t(out), queue=tq)) == pytest.approx(
        exp, rel=1e-6)
    _input_grads(lambda d: jlosses.nq_mhop_loss(d, queue=jq),
                 lambda d: losses.nq_mhop_loss(d, queue=tq), out)


@pytest.mark.parametrize("ptr,n", [(0, 3), (6, 5), (2, 12), (7, 8)])
def test_enqueue_wraps_and_keeps_last_rows_as_jax(ptr, n):
    """Wrap-around at the queue's end, and a batch larger than the queue
    (n = 12 > K = 8) keeps its last K rows."""
    rng = np.random.RandomState(ptr + n)
    queue = rng.randn(8, 4).astype(np.float32)
    emb = rng.randn(n, 4).astype(np.float32)
    jq, jp = jlosses.enqueue(jnp.asarray(queue), jnp.asarray(ptr, jnp.int32),
                             jnp.asarray(emb))
    tq, tp = losses.enqueue(torch.from_numpy(queue.copy()), ptr,
                            torch.from_numpy(emb))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tp == int(jp)


def test_momentum_update_matches_jax():
    rng = np.random.RandomState(7)
    pq = {k: rng.randn(3, 5).astype(np.float32) for k in "ab"}
    pk = {k: rng.randn(3, 5).astype(np.float32) for k in "ab"}
    exp = jlosses.momentum_update(_j(pq), _j(pk), 0.999)
    got = losses.momentum_update(_t(pq), {k: torch.from_numpy(v.copy())
                                          for k, v in pk.items()}, 0.999)
    for k in "ab":
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))


# ---- the optimizer ----------------------------------------------------------


@pytest.mark.parametrize("warmup_ratio", [0.0, 0.3])
def test_schedule_and_optimizer_lr_match_optax(warmup_ratio):
    """The learning rate at every update of a 10-step schedule equals
    optax's, through the optimizer's own param groups: lr 0 at the first
    update with a warmup, lr at the first update without one."""
    total = 10
    warm = int(total * warmup_ratio)
    jsched = JT.linear_warmup_schedule(LR, warm, total)
    psched = T.linear_warmup_schedule(LR, warm, total)
    for c in range(total + 2):
        assert np.float32(psched(c)) == np.float32(jsched(c)), c
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2))
    opt = T.make_optimizer(RetrieverTrainConfig(
        learning_rate=LR, warmup_ratio=warmup_ratio), total).init(model)
    seen = []
    for _ in range(total):
        seen.append([g["lr"] for g in opt.adam.param_groups])
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        assert opt.update()
    for c, lrs in enumerate(seen):
        assert lrs == [float(jsched(c))] * 2, c
    assert (seen[0][0] == 0.0) == (warm > 0)
    assert opt.count == total


@pytest.mark.parametrize("max_norm", [5.0001, 5.0, 4.9999])
def test_clip_at_the_boundary_matches_optax(max_norm):
    """Just below, at and above max_norm, on a gradient whose norm is 5
    exactly: optax leaves it alone below and rescales at and above."""
    g = np.array([[3.0, 4.0]], np.float32)
    clip = optax.clip_by_global_norm(max_norm)
    exp, _ = clip.update([jnp.asarray(g)], clip.init(None))
    got = [torch.from_numpy(g.copy())]
    norm = T.clip_by_global_norm(got, max_norm)
    assert float(norm) == 5.0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))


@pytest.mark.parametrize("scale", [0.5, 0.999, 1.001, 30.0])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(8)
    gs = [rng.randn(*s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs))
    gs = [g * np.float32(2.0 * scale / norm) for g in gs]
    clip = optax.clip_by_global_norm(2.0)
    exp, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(None))
    got = [torch.from_numpy(g.copy()) for g in gs]
    T.clip_by_global_norm(got, 2.0)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


def _names(sd):
    return {k for k, v in sd.items() if not float(v.reshape(-1)[0])}


def test_no_decay_set_maps_onto_jax_mask():
    """The port's no-decay parameters (every bias and LayerNorm parameter)
    are exactly the counterparts of JAX's ``_no_decay_mask`` set, through
    the weight converters, for the retriever, the unified retriever (with
    its pooler) and the reader; every parameter has a counterpart."""
    ids = jnp.ones((2, 16), jnp.int32)
    jcfg = JaxEncoderConfig.tiny(**KW)
    bert_kw = dict(KW, type_vocab_size=2, pad_token_id=0,
                   roberta_positions=False)
    cases = []
    m = JaxMhop(jcfg)
    cases.append((jax.eval_shape(lambda: m.init(
                      jax.random.PRNGKey(0), ids, ids, method=m.encode_seq)),
                  retriever_state_dict_from_jax,
                  MhopRetriever(EncoderConfig.tiny(**KW))))
    u = JaxUnified(jcfg, stop_on_pooled=True)
    cases.append((jax.eval_shape(lambda: u.init(
                      jax.random.PRNGKey(0), ids, ids, method=u.encode_qsp)),
                  unified_state_dict_from_jax,
                  UnifiedRetriever(EncoderConfig.tiny(**KW),
                                   stop_on_pooled=True)))
    r = JaxReader(JaxEncoderConfig.tiny(**bert_kw), sp_pred=True)
    cases.append((jax.eval_shape(lambda: r.init(jax.random.PRNGKey(0), {
        "input_ids": ids, "attention_mask": ids,
        "token_type_ids": jnp.zeros_like(ids), "paragraph_mask": ids,
        "sent_offsets": jnp.zeros((2, 4), jnp.int32)})),
        reader_state_dict_from_jax,
        QAReader(EncoderConfig.tiny(**bert_kw), sp_pred=True)))
    for params, convert, model in cases:
        mask = jax.tree_util.tree_map(
            lambda d, p: np.full(np.shape(p), d, np.float32),
            JT._no_decay_mask(params), params)
        mapped = convert(mask)
        assert set(mapped) == {n for n, _ in model.named_parameters()}
        skip = T.no_decay_names(model)
        assert skip == _names(mapped)
        assert any(n.endswith("LayerNorm.weight") for n in skip)
        assert any(n.endswith("word_embeddings.weight")
                   for n in set(mapped) - skip)


# ---- steps against the JAX package -----------------------------------------


def _mhop_batch(seed, b=4, widths=MHOP_WIDTHS):
    rng = np.random.RandomState(seed)
    out = {}
    for name, L in widths:
        lens = rng.randint(4, L + 1, size=b)
        mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
        ids = np.where(mask > 0, rng.randint(4, 96, size=(b, L)), 1)
        out[f"{name}_input_ids"] = ids.astype(np.int32)
        out[f"{name}_mask"] = mask
    return out


def _single_batch(seed, b=4, L=12, names=("q", "c", "neg")):
    rng = np.random.RandomState(seed)
    out = {}
    for name in names:
        lens = rng.randint(4, L + 1, size=b)
        mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
        out[f"{name}_input_ids"] = np.where(
            mask > 0, rng.randint(4, 96, size=(b, L)), 1).astype(np.int32)
        out[f"{name}_mask"] = mask
    return out


def _tcfg(**kw):
    d = dict(learning_rate=LR, warmup_ratio=0.0)
    d.update(kw)
    return d


def _capture_grads(state):
    """Record the gradients each optimizer update consumes."""
    seen = []
    update = state.opt.update

    def wrapped():
        seen.append({n: p.grad.clone() for n, p in
                     state.model.named_parameters() if p.grad is not None})
        return update()

    state.opt.update = wrapped
    return seen


def _allowed(g0, p, steps, tight):
    """Per-element bound on |Δparam| / lr (``chip_smoke.adam_bound``) for
    gradients held to 1e-6 + 1e-4 of the tensor's largest."""
    return adam_bound(g0, 1e-6 + 1e-4 * np.abs(g0).max(), p, LR,
                      RetrieverTrainConfig().adam_eps, tight, steps)


def _clipped(g0, max_norm=2.0):
    """The gradients Adam steps on: optax's global-norm clip."""
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in g0.values()))
    return {k: g * min(1.0, max_norm / norm) for k, g in g0.items()}


def _check_params(got_sd, jparams, g0, convert, steps, tight):
    """Parameters after ``steps`` updates, in units of LR, each element
    within ``_allowed`` of the clipped first gradients.  Returns the worst
    element in lr among those whose gradient exceeds 1e-4 (where the bound
    is ``tight``)."""
    g0 = _clipped(g0)
    exp = convert(jax.device_get(jparams))
    worst = 0.0
    for name, e in exp.items():
        diff = np.abs(got_sd[name].float().numpy() - e.numpy()) / LR
        bad = diff > _allowed(g0[name], e.numpy(), steps, tight)
        assert not bad.any(), (name, diff[bad].max(), g0[name][bad].min())
        worst = max(worst, diff[np.abs(g0[name]) > 1e-4].max(initial=0.0))
    return worst


def _init(model, *args):
    """Flax init, jitted: one compile instead of an op-by-op trace."""
    return jax.jit(model.init)(jax.random.PRNGKey(0), *args)


@functools.lru_cache(maxsize=None)
def _mhop_params():
    """The multi-hop retriever's initial weights (the same for every
    compute dtype and for remat: Flax keeps fp32 parameters)."""
    return _init(JaxMhop(JaxEncoderConfig.tiny(**KW), cls_only=True),
                 _j(_mhop_batch(0)))


def _jax_mhop(dtype, remat=False):
    model = JaxMhop(JaxEncoderConfig.tiny(dtype=dtype, **KW), cls_only=True,
                    remat=remat)
    return model, _mhop_params()


def _adam_mu(opt_state):
    """The first moments of the JAX optimizer state's Adam."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    return next(x for x in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=is_adam)
                if is_adam(x)).mu


def _check_moments(state, jopt_state, convert):
    """Adam's first moments, 0.1·(the clipped gradients) after one
    update: the gradients the two optimizers consumed, to the gradients'
    tolerance times 0.1."""
    exp = convert(jax.device_get(_adam_mu(jopt_state)))
    adam = state.opt.adam.state
    for name, p in state.model.named_parameters():
        e = exp[name].numpy()
        np.testing.assert_allclose(adam[p]["exp_avg"].numpy(), e, rtol=0,
                                   atol=1e-7 + 1e-4 * np.abs(e).max(),
                                   err_msg=name)


def _port_mhop(jparams, dtype, remat=False):
    model = MhopRetriever(EncoderConfig.tiny(dtype=dtype, **KW),
                          cls_only=True, fp32_params=True, remat=remat)
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(jparams)))
    return model


def test_train_state_steps_match_jax():
    """One and three TrainState steps (fp32 compute) from the same weights
    and batches: loss, the first step's gradients (through Adam's first
    moments), parameters."""
    jmodel, jparams = _jax_mhop("float32")
    batches = [_mhop_batch(s) for s in (1, 2, 3)]
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    jstate = JT.TrainState.create(jparams, jtx)
    jstep = JT.make_train_step(jmodel, jtx)

    model = _port_mhop(jparams, "float32")
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    grads = _capture_grads(state)
    step = T.make_train_step()
    worst = {}
    for i, b in enumerate(batches, 1):
        jstate, jloss = jstep(jstate, _j(b))
        state, loss = step(state, _t(b))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        if i == 1:
            _check_moments(state, jstate.opt_state,
                           retriever_state_dict_from_jax)
            g0 = {k: v.numpy() for k, v in grads[0].items()}
        if i in (1, 3):
            worst[i] = _check_params(model.state_dict(), jstate.params, g0,
                                     retriever_state_dict_from_jax, i,
                                     1e-3 if i == 1 else 1e-2)
    assert state.step == int(jstate.step) == 3
    print(f"worst parameter element after 1 / 3 steps: {worst[1]:.2e} / "
          f"{worst[3]:.2e} lr")


def _rel(a, b):
    """||a - b|| / ||b|| over all the arrays of two dicts with b's keys."""
    num = sum(np.sum((np.asarray(a[k], np.float64) - np.asarray(b[k])) ** 2)
              for k in b)
    return float(np.sqrt(num / sum(np.sum(np.asarray(b[k], np.float64) ** 2)
                                   for k in b)))


def _first_grads(dtype, b, eager=False):
    """The first step's loss, six view vectors and gradients at compute
    ``dtype``, from the shared weights: {"jax"/"port": (loss, vectors,
    gradients)}.  JAX's are those of its trainer's loss function
    (``make_train_step``'s ``loss_fn``); ``eager`` runs them op by op
    (``jax.disable_jit``), rounding to bf16 after every op as the port
    does, where jitted, XLA's fusions keep their intermediates in fp32.
    The port's are the gradients its train step hands the optimizer."""
    jmodel, jparams = _jax_mhop(dtype)

    def loss_fn(params):
        out = jmodel.apply(params, _j(b))
        return jlosses.mhop_loss(out), out

    with jax.disable_jit(eager):
        (jloss, jvecs), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jparams)
    model = _port_mhop(jparams, dtype)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        pvecs = {k: v.float().numpy() for k, v in model(_t(b)).items()}
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    grads = _capture_grads(state)
    state, loss = T.make_train_step()(state, _t(b))
    return {"jax": (float(jloss),
                    {k: np.asarray(v, np.float32) for k, v in jvecs.items()},
                    {k: v.numpy() for k, v in retriever_state_dict_from_jax(
                        jax.device_get(jg)).items()}),
            "port": (float(loss), pvecs,
                     {k: v.numpy() for k, v in grads[0].items()})}


def test_bf16_train_step_matches_jax():
    """bf16 compute over fp32 master weights, one step, held to JAX's own
    bf16 noise ``n``: how far JAX's fp32 result lies from its bf16 result
    computed op by op (``_first_grads(eager=True)``), the reference here.

    * The six views' vectors lie within 0.5 n of the reference's (they
      read 0.11 n here, at most 0.24 n over seeds 2-5).
    * The gradients lie within 0.8 n of the reference's (0.47 n; at most
      0.67 n over seeds 2-5), and within 2 n of the jitted JAX
      trainer's (0.94 n).
    * The loss agrees with the reference's to rel 1.5e-3 (bit-equal
      here; at most 7.3e-4 over seeds 2-5).
    * The control: the port's fp32 step reads 1.0 n on both the vectors
      and the gradients, and fails both bounds.

    Held to the jitted JAX trainer alone, bf16 could not be told from
    fp32: XLA's fusions round other values than an op-by-op encoder, the
    two bf16 errors are independent, and the port's fp32 gradients lie
    nearer the jitted bf16 ones than the port's bf16 gradients do.  The
    readings are printed.  All six views are 16 wide: op by op, JAX
    compiles each op once a shape."""
    b = _mhop_batch(1, widths=[(n, 16) for n, _ in MHOP_WIDTHS])
    ref = _first_grads("bfloat16", b, eager=True)
    jl, jv, jg = ref["jax"]
    pl, pv, pg = ref["port"]
    jit_g = _first_grads("bfloat16", b)["jax"][2]
    fp = _first_grads("float32", b)
    (_, jv32, jg32), (_, pv32, pg32) = fp["jax"], fp["port"]
    noise_v, noise_g = _rel(jv32, jv), _rel(jg32, jg)
    read = {"vectors": _rel(pv, jv) / noise_v,
            "gradients": _rel(pg, jg) / noise_g,
            "gradients vs jitted": _rel(pg, jit_g) / noise_g,
            "loss rel": abs(pl - jl) / abs(jl),
            "fp32 vectors (control)": _rel(pv32, jv) / noise_v,
            "fp32 gradients (control)": _rel(pg32, jg) / noise_g}
    print("bf16 step, in units of JAX's bf16 noise:", read)
    assert noise_v > 1e-3 and noise_g > 1e-3, (noise_v, noise_g)
    assert read["vectors"] <= 0.5, read
    assert read["gradients"] <= 0.8, read
    assert read["gradients vs jitted"] <= 2.0, read
    assert read["loss rel"] <= 1.5e-3, read
    assert read["fp32 vectors (control)"] > 0.5, read
    assert read["fp32 gradients (control)"] > 0.8, read


def test_momentum_steps_match_jax_with_injected_queue():
    """MomentumTrainState: the JAX queue injected as numpy; loss, the
    first step's (clipped) gradients through Adam's moments, parameters, the frozen key encoder, the
    enqueued key vectors and the pointer, after one and three steps."""
    jmodel, jparams = _jax_mhop("float32")
    batches = [_mhop_batch(s) for s in (4, 5, 6)]
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    jstate = JT.MomentumTrainState.create(jparams, jtx, queue_size=10,
                                          hidden=KW["hidden_size"], seed=3)
    jstep = JT.make_momentum_train_step(jmodel, jtx)
    model = _port_mhop(jparams, "float32")
    state = T.MomentumTrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10), queue_size=10,
        hidden=KW["hidden_size"], seed=3)
    state.queue = torch.from_numpy(np.array(jstate.queue))
    key0 = copy.deepcopy(state.model_k.state_dict())
    grads = _capture_grads(state)
    step = T.make_momentum_train_step()
    for i, b in enumerate(batches, 1):
        jstate, jloss = jstep(jstate, _j(b))
        state, loss = step(state, _t(b))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert state.queue_ptr == int(jstate.queue_ptr) == (8 * i) % 10
        np.testing.assert_allclose(state.queue.numpy(),
                                   np.asarray(jstate.queue), atol=2e-5)
        if i == 1:
            _check_moments(state, jstate.opt_state,
                           retriever_state_dict_from_jax)
            g0 = {k: v.numpy() for k, v in grads[0].items()}
        if i in (1, 3):
            _check_params(model.state_dict(), jstate.params, g0,
                          retriever_state_dict_from_jax, i,
                          1e-3 if i == 1 else 1e-2)
    for k, v in state.model_k.state_dict().items():
        assert torch.equal(v, key0[k]), k


def test_token_queue_steps_match_jax():
    """TokenQueueTrainState with a shared SingleRetriever: the queue's
    token rows bit-equal, loss and parameters after one and three steps."""
    jcfg = JaxEncoderConfig.tiny(**KW)
    jmodel = JaxSingle(jcfg, shared=True)
    batches = [_single_batch(s) for s in (7, 8, 9)]
    jparams = _init(jmodel, _j(batches[0]))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 20)
    jstate = JT.TokenQueueTrainState.create(jparams, jtx, queue_size=6,
                                            max_c_len=20, cls_id=0, sep_id=2)
    jstep = JT.make_single_momentum_train_step(jmodel, jtx)
    model = SingleRetriever(EncoderConfig.tiny(**KW), fp32_params=True)
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(jparams)))
    state = T.TokenQueueTrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 20), queue_size=6, max_c_len=20,
        cls_id=0, sep_id=2)
    grads = _capture_grads(state)
    step = T.make_single_momentum_train_step()
    for i, b in enumerate(batches, 1):
        jstate, jloss = jstep(jstate, _j(b))
        state, loss = step(state, _t(b))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        for name in ("queue_ids", "queue_mask", "queue_type"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)))
        assert state.queue_ptr == int(jstate.queue_ptr)
        if i == 1:
            _check_moments(state, jstate.opt_state,
                           retriever_state_dict_from_jax)
            g0 = {k: v.numpy() for k, v in grads[0].items()}
        if i in (1, 3):
            _check_params(model.state_dict(), jstate.params, g0,
                          retriever_state_dict_from_jax, i,
                          1e-3 if i == 1 else 1e-2)


@functools.lru_cache(maxsize=None)
def _jax_multisteps():
    """JAX's state after two micro-batches under optax.MultiSteps(2)."""
    jmodel, jparams = _jax_mhop("float32")
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg(
        gradient_accumulation=2)), 10)
    jstate = JT.TrainState.create(jparams, jtx)
    jstep = JT.make_train_step(jmodel, jtx)
    for seed in (10, 11):
        jstate, _ = jstep(jstate, _j(_mhop_batch(seed)))
    return jstate


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_accumulation_matches_jax_and_averaged_grads(remat):
    """k = 2: the parameters stay put after the first micro-batch; after
    the second they equal JAX's MultiSteps result and the port's own plain
    step on the averaged gradients."""
    micro = [_mhop_batch(s) for s in (10, 11)]
    jstate = _jax_multisteps()
    model = _port_mhop(_mhop_params(), "float32", remat=remat)
    plain = copy.deepcopy(model)
    sd0 = copy.deepcopy(model.state_dict())
    state = T.TrainState.create(model, T.make_optimizer(RetrieverTrainConfig(
        **_tcfg(gradient_accumulation=2)), 10))
    step = T.make_train_step()
    state, _ = step(state, _t(micro[0]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd0[k]), k
    assert state.opt.count == 0
    state, _ = step(state, _t(micro[1]))
    assert state.opt.count == 1 and state.step == 2

    grads = []
    for b in micro:
        plain.zero_grad()
        losses.mhop_loss(plain(_t(b))).backward()
        grads.append({n: p.grad.clone() for n, p in plain.named_parameters()})
    opt = T.make_optimizer(RetrieverTrainConfig(**_tcfg()), 10).init(plain)
    for n, p in plain.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2
    opt.update()
    g0 = _clipped({n: ((grads[0][n] + grads[1][n]) / 2).numpy()
                   for n in grads[0]})
    got = model.state_dict()
    _check_params(got, jstate.params, g0, retriever_state_dict_from_jax, 1,
                  1e-3)
    for n, p in plain.state_dict().items():
        diff = ((got[n] - p).abs() / LR).numpy()
        assert (diff <= _allowed(g0[n], p.numpy(), 1, 1e-3)).all(), n


def test_unified_step_matches_jax():
    """One UnifiedRetriever step (stop head, mixed stop targets): loss,
    the gradients through Adam's moments, parameters."""
    jmodel = JaxUnified(JaxEncoderConfig.tiny(**KW))
    b = _mhop_batch(12)
    b["stop_targets"] = np.array([1, 0, 1, 0], np.int32)
    jparams = _init(jmodel, _j(b))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg(unified=True)), 10)
    jstate, jloss = JT.make_train_step(jmodel, jtx, unified=True)(
        JT.TrainState.create(jparams, jtx), _j(b))
    model = UnifiedRetriever(EncoderConfig.tiny(**KW), cls_only=True,
                             fp32_params=True)
    model.load_state_dict(unified_state_dict_from_jax(
        jax.device_get(jparams)))
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg(unified=True)), 10))
    grads = _capture_grads(state)
    state, loss = T.make_train_step(unified=True)(state, _t(b))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _check_moments(state, jstate.opt_state, unified_state_dict_from_jax)
    _check_params(model.state_dict(), jstate.params,
                  {k: v.numpy() for k, v in grads[0].items()},
                  unified_state_dict_from_jax, 1, 1e-3)


def test_fused_attention_cannot_be_trained_in_either_package():
    """jax.grad through the JAX package's Pallas attention raises; the
    port's trainer refuses the fused encoder with a clear message."""
    from multihop_dense_retrieval_tpu.ops.fused_attention import \
        fused_attention

    r = np.random.RandomState(0)
    q, k, v = (jnp.asarray(r.randn(2, 8, 16), jnp.float32) for _ in range(3))
    m = jnp.ones((2, 8), jnp.int32)
    with pytest.raises(ValueError, match="reverse-mode"):
        jax.grad(lambda x: fused_attention(x, k, v, m, 2, interpret=True)
                 .sum())(q)
    model = MhopRetriever(EncoderConfig.tiny(attention_impl="fused", **KW),
                          fp32_params=True)
    tx = T.make_optimizer(RetrieverTrainConfig(), 10)
    with pytest.raises(ValueError, match="no backward"):
        T.TrainState.create(model, tx)
    with pytest.raises(ValueError, match="no backward"):
        T.MomentumTrainState.create(model, tx, queue_size=4, hidden=64)


# ---- the JAX package's trainer tests, ported -------------------------------


def _make_loaders(tmp_path, n_rows=16, bs=4):
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 64)
    rows = synth.make_mhop_rows(rng, docs, n_rows=n_rows)
    synth.write_jsonl(tmp_path / "train.jsonl", rows)
    synth.write_jsonl(tmp_path / "dev.jsonl", rows[:8])
    tok = HashTokenizer(vocab_size=512)
    kw = dict(max_q_len=16, max_q_sp_len=48, max_c_len=32)
    train_ds = MhopDataset(tok, str(tmp_path / "train.jsonl"), train=True,
                           **kw)
    eval_ds = MhopDataset(tok, str(tmp_path / "dev.jsonl"), **kw)
    return (BatchLoader(train_ds, bs, shuffle=True, seed=1, num_workers=1),
            BatchLoader(eval_ds, bs, shuffle=False, num_workers=1))


def _tiny_model(**kw):
    torch.manual_seed(0)
    cfg = EncoderConfig.tiny(vocab_size=512, max_position_embeddings=64)
    return MhopRetriever(cfg, cls_only=True, fp32_params=True, **kw)


def test_training_reduces_loss_and_saves_best(tmp_path):
    train_loader, eval_loader = _make_loaders(tmp_path)
    tcfg = RetrieverTrainConfig(batch_size=4, num_epochs=4,
                                learning_rate=1e-3, warmup_ratio=0.1)
    out_dir = str(tmp_path / "out")
    tr = T.RetrieverTrainer(_tiny_model(), tcfg, train_loader, eval_loader,
                            output_dir=out_dir, log_fn=lambda *_: None)
    first_losses = []
    orig_step = tr.train_step

    def wrapped(state, batch):
        state, loss = orig_step(state, batch)
        first_losses.append(float(loss))
        return state, loss

    tr.train_step = wrapped
    result = tr.run()
    assert np.mean(first_losses[-4:]) < np.mean(first_losses[:4])
    assert result["best_mrr"] > 0
    restored = ckpt.restore_pytree(f"{out_dir}/checkpoint_best.pt")
    assert set(restored) == set(tr.state.model.state_dict())
    last = ckpt.restore_pytree(f"{out_dir}/checkpoint_last.pt")
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(last[k], v), k


def test_momentum_step_queue_and_frozen_key_encoder(tmp_path):
    train_loader, _ = _make_loaders(tmp_path, n_rows=8, bs=4)
    model = _tiny_model()
    tx = T.make_optimizer(RetrieverTrainConfig(batch_size=4, momentum=True,
                                               queue_size=32,
                                               warmup_ratio=0.0), 10)
    state = T.MomentumTrainState.create(model, tx, queue_size=32,
                                        hidden=model.config.hidden_size)
    assert state.model_k is not state.model
    assert not any(p.requires_grad for p in state.model_k.parameters())
    batch = next(iter(train_loader))
    batch.pop("valid")
    q0 = state.queue.clone()
    k0 = copy.deepcopy(state.model_k.state_dict())
    p0 = copy.deepcopy(model.state_dict())
    tb = _t(batch)
    new_state, loss = T.make_momentum_train_step()(state, tb)
    assert np.isfinite(float(loss))
    # queue rows 0..7 replaced by the batch's c1;c2 key-encoder vectors
    assert new_state.queue_ptr == 8
    with torch.no_grad():
        expect = torch.cat([state.model_k.encode_seq(tb[f"{v}_input_ids"],
                                                     tb[f"{v}_mask"])
                            for v in ("c1", "c2")])
    assert torch.equal(new_state.queue[:8], expect)
    assert torch.equal(new_state.queue[8:], q0[8:])
    for k, v in new_state.model_k.state_dict().items():
        assert torch.equal(v, k0[k]), k
    assert any(not torch.equal(v, p0[k])
               for k, v in new_state.model.state_dict().items())


def test_momentum_queue_draws_from_its_own_seeded_generator():
    model = _tiny_model()
    tx = T.make_optimizer(RetrieverTrainConfig(), 10)
    a = T.MomentumTrainState.create(model, tx, queue_size=16, hidden=32,
                                    seed=5)
    b = T.MomentumTrainState.create(model, tx, queue_size=16, hidden=32,
                                    seed=5)
    c = T.MomentumTrainState.create(model, tx, queue_size=16, hidden=32,
                                    seed=6)
    assert torch.equal(a.queue, b.queue) and not torch.equal(a.queue, c.queue)
    assert a.queue.dtype == torch.float32 and a.queue.shape == (16, 32)


def test_ema_moves_the_key_encoder_only_when_enabled():
    model = _tiny_model()
    b = _t(_mhop_batch(13))
    results = {}
    for ema in (False, True):
        m = copy.deepcopy(model)
        state = T.MomentumTrainState.create(
            m, T.make_optimizer(RetrieverTrainConfig(warmup_ratio=0.0), 10),
            queue_size=8, hidden=32)
        k0 = copy.deepcopy(state.model_k.state_dict())
        T.make_momentum_train_step(enable_ema=ema, momentum_m=0.9)(state, b)
        results[ema] = (state, k0)
    state, k0 = results[False]
    assert all(torch.equal(v, k0[k])
               for k, v in state.model_k.state_dict().items())
    state, k0 = results[True]
    q = state.model.state_dict()
    for k, v in state.model_k.state_dict().items():
        torch.testing.assert_close(v, k0[k] * 0.9 + q[k] * (1 - 0.9),
                                   rtol=0, atol=1e-7)


def test_unified_train_step(tmp_path):
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 32)
    rows = synth.make_mhop_rows(rng, docs, n_rows=4)
    synth.write_jsonl(tmp_path / "t.jsonl", rows)
    ds = MhopDataset(HashTokenizer(vocab_size=512), str(tmp_path / "t.jsonl"),
                     max_q_len=16, max_q_sp_len=48, max_c_len=32)
    batch = next(iter(BatchLoader(ds, 4, num_workers=1)))
    batch.pop("valid")
    batch["stop_targets"] = np.array([1, 0, 1, 1], np.int32)
    torch.manual_seed(0)
    model = UnifiedRetriever(EncoderConfig.tiny(vocab_size=512,
                                                max_position_embeddings=64),
                             cls_only=True, fp32_params=True)
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(batch_size=4, unified=True), 10))
    new_state, loss = T.make_train_step(unified=True)(state, _t(batch))
    assert np.isfinite(float(loss))
    out = T.make_eval_step(unified=True)(new_state.model, _t(batch))
    assert out["stop_acc"].shape == (4,)


def test_gradient_accumulation(tmp_path):
    """k micro-batches: the parameters stay put until the k-th."""
    train_loader, _ = _make_loaders(tmp_path, n_rows=8, bs=4)
    model = _tiny_model()
    state = T.TrainState.create(model, T.make_optimizer(RetrieverTrainConfig(
        batch_size=4, gradient_accumulation=2, warmup_ratio=0.0,
        learning_rate=1e-3), 10))
    step = T.make_train_step()
    sd0 = copy.deepcopy(model.state_dict())
    it = iter(train_loader)
    b1, b2 = next(it), next(it)
    b1.pop("valid")
    b2.pop("valid")
    step(state, _t(b1))
    assert all(torch.equal(v, sd0[k]) for k, v in model.state_dict().items())
    step(state, _t(b2))
    assert any(not torch.equal(v, sd0[k])
               for k, v in model.state_dict().items())


def test_token_queue_momentum_step():
    """The token queue is re-encoded with the CURRENT encoder each step,
    the batch's context tokens enqueued after the update."""
    cfg = EncoderConfig.tiny(vocab_size=256, max_position_embeddings=40)
    torch.manual_seed(0)
    model = SingleRetriever(cfg, shared=True, fp32_params=True)
    b, lb, lq = 4, 12, 20

    def mk_batch(seed):
        r = np.random.RandomState(seed)
        out = {}
        for k in ("q", "c", "neg"):
            out[f"{k}_input_ids"] = torch.from_numpy(
                r.randint(5, 250, size=(b, lb)).astype(np.int32))
            out[f"{k}_mask"] = torch.ones((b, lb), dtype=torch.int32)
        return out

    batch = mk_batch(1)
    tx = T.make_optimizer(RetrieverTrainConfig(warmup_ratio=0.0,
                                               learning_rate=1e-3), 20)
    state = T.TokenQueueTrainState.create(model, tx, queue_size=8,
                                          max_c_len=lq, cls_id=0, sep_id=2)
    with torch.no_grad():
        queue_c = model.encode_ctx(state.queue_ids, state.queue_mask,
                                   state.queue_type)
        expected = float(losses.single_loss(model(batch), queue_c=queue_c))
    state1, loss1 = T.make_single_momentum_train_step()(state, batch)
    assert float(loss1) == expected
    assert state1.queue_ptr == b
    got = state1.queue_ids[:b].numpy()
    np.testing.assert_array_equal(got[:, :lb], batch["c_input_ids"].numpy())
    assert (got[:, lb:] == 0).all()
    assert (state1.queue_mask[:b, lb:] == 0).all()
    seen = [float(loss1)]
    step = T.make_single_momentum_train_step()
    for _ in range(5):
        state1, loss = step(state1, mk_batch(1))
        seen.append(float(loss))
    assert all(np.isfinite(seen)) and seen[-1] < seen[0]
    assert state1.queue_ptr == (b * 6) % 8


def test_nq_momentum_composition():
    """NQRetriever + MomentumTrainState + the nq momentum step: queries
    through the trained encoder, contexts through the frozen key encoder,
    queue negatives in the recovery loss, c vectors enqueued."""
    torch.manual_seed(0)
    model = NQRetriever(EncoderConfig.tiny(**KW), fp32_params=True)
    assert not hasattr(model, "project")
    state = T.MomentumTrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 20), queue_size=16,
        hidden=KW["hidden_size"])
    tb = _t(_single_batch(14, names=("q", "q_neg1", "c", "neg")))
    with torch.no_grad():
        ctx = {k: state.model_k.encode_seq(tb[f"{k}_input_ids"],
                                           tb[f"{k}_mask"])
               for k in ("c", "neg")}
        qs = {k: model.encode_seq(tb[f"{k}_input_ids"], tb[f"{k}_mask"])
              for k in ("q", "q_neg1")}
        expected = float(losses.nq_mhop_loss({**ctx, **qs},
                                             queue=state.queue))
    k0 = copy.deepcopy(state.model_k.state_dict())
    step = T.make_momentum_train_step(task="nq")
    state1, loss = step(state, tb)
    assert float(loss) == expected
    assert all(torch.equal(v, k0[k])
               for k, v in state1.model_k.state_dict().items())
    assert state1.queue_ptr == 4
    assert torch.equal(state1.queue[:4], ctx["c"])
    p1 = copy.deepcopy(state1.model.state_dict())
    state2, loss2 = step(state1, tb)
    assert np.isfinite(float(loss2))
    assert any(not torch.equal(v, p1[k])
               for k, v in state2.model.state_dict().items())


def test_remat_train_step_matches_plain():
    """--remat changes memory, not math: in eager PyTorch the recomputed
    layers give the same loss and parameters, bit for bit."""
    b = _t(_mhop_batch(15))
    results = []
    for remat in (False, True):
        model = _tiny_model(remat=remat)
        state = T.TrainState.create(model, T.make_optimizer(
            RetrieverTrainConfig(**_tcfg()), 10))
        state, loss = T.make_train_step()(state, b)
        results.append((float(loss), model.state_dict()))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


def test_evaluate_mrr_drops_padding_and_buckets_unified(tmp_path):
    """The ``valid`` mask drops the eval loader's padded rows (same MRR as
    JAX's evaluate_mrr on the same batches and weights), and the unified
    task averages mrr_2 over multi-hop rows only."""
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 32)
    rows = synth.make_mhop_rows(rng, docs, n_rows=6)
    synth.write_jsonl(tmp_path / "t.jsonl", rows)
    kw = dict(max_q_len=12, max_q_sp_len=20, max_c_len=16)
    jloader = JaxLoader(JaxMhopDataset(JaxTok(vocab_size=96),
                                       str(tmp_path / "t.jsonl"), **kw),
                        4, num_workers=1)
    loader = BatchLoader(MhopDataset(HashTokenizer(vocab_size=96),
                                     str(tmp_path / "t.jsonl"), **kw),
                         4, num_workers=1)
    jmodel, jparams = _jax_mhop("float32")
    exp = JT.evaluate_mrr(JT.make_eval_step(jmodel), jparams, jloader)
    got = T.evaluate_mrr(T.make_eval_step(), _port_mhop(jparams, "float32"),
                         loader)
    assert got == exp

    def fake_step(model, batch):
        n = batch["q_mask"].shape[0]
        return {"rrs_1": torch.full((n,), 0.5),
                "rrs_2": torch.tensor([1.0, 0.25, 1.0, 0.25])[:n],
                "is_mhop": torch.tensor([True, False, True, False])[:n],
                "stop_acc": torch.ones(n)}

    out = T.evaluate_mrr(fake_step, _port_mhop(jparams, "float32"), loader)
    assert out == {"mrr_1": 0.5, "mrr_2": 1.0, "mrr_avg": 0.75,
                   "stop_acc": 1.0}
