"""Data-parallel training: every train and eval step of the port with
``mesh=`` (``train/trainer.py::DataParallel``) against the JAX package's
step on a mesh of the same shape (conftest's 8 virtual CPU devices; the
port's mesh is ``[cpu] * 8``), and against the port's single-device step,
from the same weights (``models/convert.py``) and numpy batches; then the
JAX package's tests of it, ported (tests/test_trainer.py::
test_data_parallel_step_matches_single_device, tests/test_resume.py::
test_resume_on_device_mesh).

Tolerances (tests/test_torch_train.py states them): the loss rel 1e-5;
the gradients the update consumed within 1e-6 + 1e-4 of each tensor's
largest, against the single-device step's and, through Adam's first
moments, JAX's; parameters within ``chip_smoke.adam_bound`` in units of
the learning rate; queue pointers and enqueued token rows exactly equal,
enqueued vectors atol 2e-5; reciprocal ranks and MRRs exactly equal.  The
negative control, a step that scores each entry's in-batch negatives only
and averages the entries' gradients (what DDP does to a separable loss),
fails the same criteria.
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.core.config import \
    RetrieverTrainConfig as JaxTrainConfig
from multihop_dense_retrieval_tpu.core.mesh import make_mesh as jax_mesh
from multihop_dense_retrieval_tpu.data import BatchLoader as JaxLoader
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxTok
from multihop_dense_retrieval_tpu.data import MhopDataset as JaxMhopDataset
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxMhop
from multihop_dense_retrieval_tpu.models import NQRetriever as JaxNQ
from multihop_dense_retrieval_tpu.models import SingleRetriever as JaxSingle
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.train import qa as JTQA
from multihop_dense_retrieval_tpu.train import trainer as JT
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh
from multihop_dense_retrieval_tpu_torch.data import (BatchLoader,
                                                     HashTokenizer,
                                                     MhopDataset)
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, NQRetriever, QAReader, SingleRetriever, UnifiedRetriever,
    reader_state_dict_from_jax, retriever_state_dict_from_jax,
    unified_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.parallel import shard_params
from multihop_dense_retrieval_tpu_torch.train import losses
from multihop_dense_retrieval_tpu_torch.train import qa as TQA
from multihop_dense_retrieval_tpu_torch.train import trainer as T
from tests import synth
from tests.test_torch_train import (KW, LR, _allowed, _capture_grads,
                                    _check_moments, _check_params, _clipped,
                                    _init, _j, _mhop_batch, _single_batch, _t,
                                    _tcfg)
from tests.test_torch_train_qa import READER_KW, _train_batches

CPU = torch.device("cpu")
B = 8


def _meshes(n=B):
    return (jax_mesh(data=n, index=1),
            make_mesh(data=n, index=1, devices=[CPU] * n))


def _held(got, ref, g_got, g_ref, lr=LR, steps=1, tight=1e-3):
    """The port's data-parallel result against its single-device one:
    gradients within 1e-6 + 1e-4 of each tensor's largest, parameters
    within adam_bound (of the single step's clipped gradients)."""
    g0 = _clipped({k: v.numpy() for k, v in g_ref.items()})
    assert set(g_got) == set(g_ref)
    for k, g in g_ref.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        err = (g_got[k] - g).abs().max().item()
        assert err <= tol, (k, err, tol)
    for k, p in ref.items():
        diff = ((got[k] - p).abs() / lr).numpy()
        assert (diff <= _allowed(g0[k], p.numpy(), steps, tight)).all(), k


# ---- the train step, four tasks ---------------------------------------------


def _task_case(task):
    """(JAX model, port model, converter, batch) of a train task."""
    jcfg, cfg = JaxEncoderConfig.tiny(**KW), EncoderConfig.tiny(**KW)
    if task in ("mhop", "unified"):
        b = _mhop_batch(21, b=B)
        if task == "mhop":
            return (JaxMhop(jcfg, cls_only=True),
                    MhopRetriever(cfg, cls_only=True, fp32_params=True),
                    retriever_state_dict_from_jax, b)
        b["stop_targets"] = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.int32)
        return (JaxUnified(jcfg),
                UnifiedRetriever(cfg, cls_only=True, fp32_params=True),
                unified_state_dict_from_jax, b)
    if task == "single":
        return (JaxSingle(jcfg, shared=True),
                SingleRetriever(cfg, fp32_params=True),
                retriever_state_dict_from_jax, _single_batch(22, b=B))
    return (JaxNQ(jcfg), NQRetriever(cfg, fp32_params=True),
            retriever_state_dict_from_jax,
            _single_batch(23, b=B, names=("q", "q_neg1", "c", "neg")))


def _port_step(model, batch, make_step, state_of=None, steps=1, total=10,
               **tcfg):
    """``steps`` calls of ``make_step()`` over a fresh state of ``model``
    (the optimizer's schedule ``total`` steps long): (state, losses, the
    gradients of the first update)."""
    tx = T.make_optimizer(RetrieverTrainConfig(**_tcfg(**tcfg)), total)
    state = (state_of or T.TrainState.create)(model, tx)
    grads = _capture_grads(state)
    step = make_step()
    batches = batch if isinstance(batch, list) else [batch] * steps
    seen = []
    for b in batches:
        state, loss = step(state, _t(b))
        seen.append(float(loss))
    return state, seen, grads[0] if grads else None


@pytest.mark.parametrize("task", ["mhop", "unified", "single", "nq"])
def test_data_parallel_step_matches_jax_and_single(task):
    """One step on a data-8 mesh (one row an entry) equals JAX's step on
    its data-8 mesh and the port's single-device step."""
    jmodel, model, convert, b = _task_case(task)
    jparams = jax.device_get(_init(jmodel, _j(b)))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg(
        unified=task == "unified")), 10)
    jmesh, mesh = _meshes()
    jstate, jloss = JT.make_train_step(jmodel, jtx, task=task, mesh=jmesh)(
        JT.TrainState.create(jparams, jtx), _j(b))
    model.load_state_dict(convert(jparams))
    single = copy.deepcopy(model)
    kw = dict(unified=task == "unified")
    sd, (ld,), gd = _port_step(
        model, b, lambda: T.make_train_step(task=task, mesh=mesh), **kw)
    s1, (l1,), g1 = _port_step(
        single, b, lambda: T.make_train_step(task=task), **kw)
    assert ld == pytest.approx(float(jloss), rel=1e-5)
    assert ld == pytest.approx(l1, rel=1e-5)
    _check_moments(sd, jstate.opt_state, convert)
    _check_params(model.state_dict(), jstate.params,
                  {k: v.numpy() for k, v in gd.items()}, convert, 1, 1e-3)
    _held(model.state_dict(), single.state_dict(), gd, g1)


def _local_negatives_step(model, batch, n):
    """The negative control: each of ``n`` entries scores its own slice's
    in-batch negatives only, and the entries' gradients are averaged."""
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    grads = _capture_grads(state)
    rows = B // n
    parts = [{k: v[j * rows:(j + 1) * rows] for k, v in _t(batch).items()}
             for j in range(n)]
    loss = sum(losses.mhop_loss(model(p)) for p in parts) / n
    loss.backward()
    state.opt.update()
    return float(loss), grads[0]


@pytest.mark.parametrize("n", [2, 8])
def test_local_in_batch_negatives_fail_the_comparison(n):
    """The control: scoring each entry's negatives only (with averaged
    gradients) moves the loss far beyond rel 1e-5 and the gradients far
    beyond their tolerance, so the criteria above tell it from the
    data-parallel step."""
    b = _task_case("mhop")[3]
    torch.manual_seed(0)
    model = MhopRetriever(EncoderConfig.tiny(**KW), cls_only=True,
                          fp32_params=True)
    single = copy.deepcopy(model)
    _, (l1,), g1 = _port_step(single, b, T.make_train_step)
    lc, gc = _local_negatives_step(model, b, n)
    assert abs(lc - l1) > 100 * 1e-5 * abs(l1), (lc, l1)
    share = max((gc[k] - g).abs().max().item()
                / (1e-6 + 1e-4 * g.abs().max().item()) for k, g in g1.items())
    assert share > 10, share
    with pytest.raises(AssertionError):
        _held(model.state_dict(), single.state_dict(), gc, g1)


def _joined(grads, model):
    """Captured gradients under the unsharded names: each tensor-parallel
    linear's blocks joined."""
    from multihop_dense_retrieval_tpu_torch.parallel.sharding import \
        ShardedLinear

    out = dict(grads)
    for name, mod in model.named_modules():
        if isinstance(mod, ShardedLinear):
            for what, dim in (("weight", mod.dim), ("bias", 0)):
                keys = [k for k in list(out)
                        if k.startswith(f"{name}.{what}.")]
                if keys:
                    out[f"{name}.{what}"] = torch.cat(
                        [out.pop(k) for k in sorted(
                            keys, key=lambda k: int(k.rpartition(".")[2]))],
                        dim)
    return out


@pytest.mark.parametrize("tp", [False, True], ids=["dp", "dp_x_tp"])
def test_data_parallel_step_through_replica_copies(monkeypatch, tp):
    """Where an entry's devices are not the model's, it computes on a copy
    of its own: made once (with ``tp``, its blocks placed on the entry's
    index shards), set to the model before every use, its gradient summed
    into the model's, in entry order, and cleared.  Forced here on the CPU (the model reports
    another device), the step equals the one that runs every slice
    through the model itself, and the copies equal the model when they
    compute again."""
    torch.manual_seed(1)
    base = MhopRetriever(EncoderConfig.tiny(**KW), cls_only=True,
                         fp32_params=True)
    b = _mhop_batch(24, b=B)
    mesh = make_mesh(data=4, index=2 if tp else 1,
                     devices=[CPU] * (8 if tp else 4))
    ref, model = copy.deepcopy(base), copy.deepcopy(base)
    if tp:      # laid out before the optimizer, which then holds the blocks
        shard_params(ref, mesh)
        shard_params(model, mesh)
    sr, lr_, gr = _port_step(ref, b, lambda: T.make_train_step(
        mesh=mesh, tensor_parallel=tp), steps=2)
    layout = T._layout
    monkeypatch.setattr(T, "_layout", lambda m: (torch.device("cpu", 0),)
                        if m is model else layout(m))
    steps = []

    def make():
        steps.append(T.make_train_step(mesh=mesh, tensor_parallel=tp))
        return steps[-1]

    sc, lc, gc = _port_step(model, b, make, steps=2)
    assert lc == pytest.approx(lr_, rel=1e-6)
    got, exp = (T.reference_state_dict(m) for m in (model, ref))
    for k, v in exp.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=2 * LR)
    _held(got, exp, _joined(gc, model), _joined(gr, ref), steps=2,
          tight=1e-2)
    dp = steps[0].__closure__
    dp = next(c.cell_contents for c in dp
              if isinstance(c.cell_contents, T.DataParallel))
    twins = dp.replicas(model)
    assert len({id(t) for t in twins}) == 4
    assert not any(t is model for t in twins)
    for p, q in zip(model.parameters(), twins[0].parameters()):
        assert torch.equal(p, q) and q.grad is None


# ---- the momentum and token-queue steps -------------------------------------


@pytest.mark.parametrize("task", ["mhop", "nq"])
def test_data_parallel_momentum_steps_match_jax(task):
    """Two MomentumTrainState steps on data-8 meshes, the JAX queue
    injected: loss, the global batch's key vectors enqueued in global
    order (the pointer wraps at 20), parameters; and the port's
    single-device steps."""
    jmodel, model, convert, _ = _task_case(task)
    if task == "mhop":
        batches = [_mhop_batch(s, b=B) for s in (25, 26)]
    else:
        batches = [_single_batch(s, b=B, names=("q", "q_neg1", "c", "neg"))
                   for s in (25, 26)]
    jparams = jax.device_get(_init(jmodel, _j(batches[0])))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    jstate = JT.MomentumTrainState.create(jparams, jtx, queue_size=20,
                                          hidden=KW["hidden_size"], seed=3)
    queue0 = np.array(jstate.queue)
    jmesh, mesh = _meshes()
    jstep = JT.make_momentum_train_step(jmodel, jtx, mesh=jmesh, task=task)
    model.load_state_dict(convert(jparams))
    single = copy.deepcopy(model)

    def state_of(m, tx):
        st = T.MomentumTrainState.create(m, tx, queue_size=20,
                                         hidden=KW["hidden_size"], seed=3)
        st.queue = torch.from_numpy(queue0.copy())
        return st

    jl = []
    for b in batches:
        jstate, loss = jstep(jstate, _j(b))
        jl.append(float(loss))
    sd, ld, gd = _port_step(model, batches, lambda: T.make_momentum_train_step(
        task=task, mesh=mesh), state_of=state_of)
    s1, l1, g1 = _port_step(single, batches, lambda: T.make_momentum_train_step(
        task=task), state_of=state_of)
    per_step = 2 * B if task == "mhop" else B
    assert sd.queue_ptr == s1.queue_ptr == int(jstate.queue_ptr) == \
        (2 * per_step) % 20
    np.testing.assert_allclose(ld, jl, rtol=1e-5)
    np.testing.assert_allclose(ld, l1, rtol=1e-5)
    np.testing.assert_allclose(sd.queue.numpy(), np.asarray(jstate.queue),
                               atol=2e-5)
    np.testing.assert_allclose(sd.queue.numpy(), s1.queue.numpy(), atol=2e-5)
    _check_params(model.state_dict(), jstate.params,
                  {k: v.numpy() for k, v in gd.items()}, convert, 2, 1e-2)
    _held(model.state_dict(), single.state_dict(), gd, g1, steps=2,
          tight=1e-2)


def test_data_parallel_token_queue_steps_match_jax():
    """Two TokenQueueTrainState steps on data-8 meshes: the global batch's
    context token rows enqueued bit-equal to JAX's (the queue of 12
    wraps), loss, parameters; and the port's single-device steps."""
    jmodel, model, convert, _ = _task_case("single")
    batches = [_single_batch(s, b=B) for s in (27, 28)]
    jparams = jax.device_get(_init(jmodel, _j(batches[0])))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 20)
    jmesh, mesh = _meshes()
    jstate = JT.TokenQueueTrainState.create(jparams, jtx, queue_size=12,
                                            max_c_len=20, cls_id=0, sep_id=2)
    jstep = JT.make_single_momentum_train_step(jmodel, jtx, mesh=jmesh)
    jl = []
    for b in batches:
        jstate, loss = jstep(jstate, _j(b))
        jl.append(float(loss))
    model.load_state_dict(convert(jparams))
    single = copy.deepcopy(model)

    def state_of(m, tx):
        return T.TokenQueueTrainState.create(m, tx, queue_size=12,
                                             max_c_len=20, cls_id=0, sep_id=2)

    sd, ld, gd = _port_step(model, batches, lambda:
                            T.make_single_momentum_train_step(mesh=mesh),
                            state_of=state_of, total=20)
    s1, l1, g1 = _port_step(single, batches,
                            T.make_single_momentum_train_step,
                            state_of=state_of, total=20)
    np.testing.assert_allclose(ld, jl, rtol=1e-5)
    np.testing.assert_allclose(ld, l1, rtol=1e-5)
    for name in ("queue_ids", "queue_mask", "queue_type"):
        np.testing.assert_array_equal(getattr(sd, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
        assert torch.equal(getattr(sd, name), getattr(s1, name))
    assert sd.queue_ptr == int(jstate.queue_ptr) == (2 * B) % 12
    _check_params(model.state_dict(), jstate.params,
                  {k: v.numpy() for k, v in gd.items()}, convert, 2, 1e-2)
    _held(model.state_dict(), single.state_dict(), gd, g1, steps=2,
          tight=1e-2)


def test_data_parallel_gradient_accumulation_matches_jax():
    """MultiSteps(2) on data-8 meshes: the parameters stay put after the
    first micro-batch, and after the second equal JAX's (the running mean
    of the two summed-over-entries gradients)."""
    jmodel, model, convert, _ = _task_case("mhop")
    micro = [_mhop_batch(s, b=B) for s in (29, 30)]
    jparams = jax.device_get(_init(jmodel, _j(micro[0])))
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg(
        gradient_accumulation=2)), 10)
    jmesh, mesh = _meshes()
    jstep = JT.make_train_step(jmodel, jtx, mesh=jmesh)
    jstate = JT.TrainState.create(jparams, jtx)
    for b in micro:
        jstate, _ = jstep(jstate, _j(b))
    model.load_state_dict(convert(jparams))
    sd0 = copy.deepcopy(model.state_dict())
    state = T.TrainState.create(model, T.make_optimizer(RetrieverTrainConfig(
        **_tcfg(gradient_accumulation=2)), 10))
    grads = _capture_grads(state)
    step = T.make_train_step(mesh=mesh)
    state, _ = step(state, _t(micro[0]))
    assert all(torch.equal(v, sd0[k]) for k, v in model.state_dict().items())
    assert state.opt.count == 0
    state, _ = step(state, _t(micro[1]))
    assert state.opt.count == 1 and state.step == 2
    # the update stepped on the mean of the micro-batches' gradients
    _check_moments(state, jstate.opt_state, convert)
    _check_params(model.state_dict(), jstate.params,
                  {k: ((grads[0][k] + grads[1][k]) / 2).numpy()
                   for k in grads[0]}, convert, 1, 1e-3)


# ---- the eval steps ----------------------------------------------------------


def test_data_parallel_eval_steps_match_jax(tmp_path):
    """evaluate_mrr over a loader of 12 rows in batches of 8 (the last
    padded, its ``valid`` mask dropping 4 rows) with data-8 eval steps:
    the MRRs of JAX's data-8 eval step and of the port's single-device
    one, exactly; the momentum eval step's and the unified eval step's
    per-row outputs equal JAX's on data-8 meshes."""
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 40)
    synth.write_jsonl(tmp_path / "t.jsonl",
                      synth.make_mhop_rows(rng, docs, n_rows=12))
    kw = dict(max_q_len=12, max_q_sp_len=20, max_c_len=16)
    jloader = JaxLoader(JaxMhopDataset(JaxTok(vocab_size=96),
                                       str(tmp_path / "t.jsonl"), **kw),
                        B, num_workers=1)
    loader = BatchLoader(MhopDataset(HashTokenizer(vocab_size=96),
                                     str(tmp_path / "t.jsonl"), **kw),
                         B, num_workers=1)
    jmodel, model, convert, b = _task_case("mhop")
    jparams = jax.device_get(_init(jmodel, _j(b)))
    model.load_state_dict(convert(jparams))
    jmesh, mesh = _meshes()
    exp = JT.evaluate_mrr(JT.make_eval_step(jmodel, mesh=jmesh), jparams,
                          jloader)
    got = T.evaluate_mrr(T.make_eval_step(mesh=mesh), model, loader)
    assert got == exp
    assert got == T.evaluate_mrr(T.make_eval_step(), model, loader)

    key = copy.deepcopy(model)
    with torch.no_grad():
        for p in key.parameters():
            p.mul_(0.9)
    jkey = jax.tree_util.tree_map(lambda x: x * np.float32(0.9), jparams)
    jout = JT.make_momentum_eval_step(jmodel, mesh=jmesh)(jparams, jkey,
                                                          _j(b))
    out = T.make_momentum_eval_step(mesh=mesh)(model, key, _t(b))
    for k in jout:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))

    jmodel, model, convert, b = _task_case("unified")
    jparams = jax.device_get(_init(jmodel, _j(b)))
    model.load_state_dict(convert(jparams))
    jout = JT.make_eval_step(jmodel, unified=True, mesh=jmesh)(jparams, _j(b))
    out = T.make_eval_step(unified=True, mesh=mesh)(model, _t(b))
    assert set(out) == set(jout)
    for k in jout:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))


# ---- the reader's steps -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reader():
    jmodel = JaxReader(JaxEncoderConfig.tiny(**READER_KW), sp_pred=True)
    b = _train_batches(n=1, b=B)[0]
    return jmodel, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), _j(b))), b


def test_data_parallel_qa_steps_match_jax():
    """The reader's train step on data-8 meshes (qa_loss once on the
    gathered heads' outputs): loss, the gradients through Adam's moments,
    parameters, against JAX's and the port's single-device step; its rank
    and predict steps: scores within 1e-5, spans equal."""
    jmodel, jparams, b = _reader()
    jmesh, mesh = _meshes()
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    jstate, jloss = JTQA.make_qa_train_step(jmodel, jtx, sp_weight=0.5,
                                            mesh=jmesh)(
        JT.TrainState.create(jparams, jtx), _j(b))
    model = QAReader(EncoderConfig.tiny(**READER_KW), sp_pred=True,
                     fp32_params=True)
    model.load_state_dict(reader_state_dict_from_jax(jparams))
    single = copy.deepcopy(model)
    sd, (ld,), gd = _port_step(model, b, lambda: TQA.make_qa_train_step(
        sp_weight=0.5, mesh=mesh))
    s1, (l1,), g1 = _port_step(single, b, lambda: TQA.make_qa_train_step(
        sp_weight=0.5))
    assert ld == pytest.approx(float(jloss), rel=1e-5)
    assert ld == pytest.approx(l1, rel=1e-5)
    _check_moments(sd, jstate.opt_state, reader_state_dict_from_jax)
    _check_params(model.state_dict(), jstate.params,
                  {k: v.numpy() for k, v in gd.items()},
                  reader_state_dict_from_jax, 1, 1e-3)
    _held(model.state_dict(), single.state_dict(), gd, g1)

    model.load_state_dict(reader_state_dict_from_jax(jparams))
    model.eval()
    jrank = JTQA.make_qa_rank_step(jmodel, mesh=jmesh)(jparams, _j(b))
    rank = TQA.make_qa_rank_step(model, mesh=mesh)(b)
    np.testing.assert_allclose(rank.numpy(), np.asarray(jrank), rtol=0,
                               atol=1e-5)
    jpred = JTQA.make_qa_predict_step(jmodel, mesh=jmesh)(jparams, _j(b))
    pred = TQA.make_qa_predict_step(model, mesh=mesh)(b)
    plain = TQA.make_qa_predict_step(model)(b)
    assert set(pred) == set(jpred)
    for k in ("start_pos", "end_pos"):
        np.testing.assert_array_equal(pred[k].numpy(), np.asarray(jpred[k]))
        assert torch.equal(pred[k], plain[k])
    for k in ("rank_score", "span_score", "sp_prob"):
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(jpred[k]),
                                   rtol=0, atol=1e-5)


# ---- what raises, and resume --------------------------------------------------


def test_a_batch_that_does_not_split_raises_in_both_packages():
    """6 rows over a data-4 mesh: JAX's step raises, and so do the port's
    train, eval and reader steps."""
    jmodel, model, convert, b = _task_case("mhop")
    b6 = {k: v[:6] for k, v in b.items()}
    jparams = _init(jmodel, _j(b))
    jmesh, mesh = _meshes(4)
    jtx = JT.make_optimizer(JaxTrainConfig(**_tcfg()), 10)
    with pytest.raises(ValueError):
        JT.make_train_step(jmodel, jtx, mesh=jmesh)(
            JT.TrainState.create(jparams, jtx), _j(b6))
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(**_tcfg()), 10))
    with pytest.raises(ValueError, match="does not split over 4"):
        T.make_train_step(mesh=mesh)(state, _t(b6))
    with pytest.raises(ValueError, match="does not split over 4"):
        T.make_eval_step(mesh=mesh)(model, _t(b6))
    reader = QAReader(EncoderConfig.tiny(**READER_KW), sp_pred=True)
    qa6 = {k: v[:6] for k, v in _reader()[2].items()}
    with pytest.raises(ValueError, match="does not split over 4"):
        TQA.make_qa_predict_step(reader, mesh=mesh)(qa6)


def _loaders(tmp_path, num_epochs):
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 64)
    rows = synth.make_mhop_rows(rng, docs, n_rows=16)
    synth.write_jsonl(tmp_path / "train.jsonl", rows)
    synth.write_jsonl(tmp_path / "dev.jsonl", rows[:8])
    tok = HashTokenizer(vocab_size=512)
    kw = dict(max_q_len=16, max_q_sp_len=48, max_c_len=32)
    tl = BatchLoader(MhopDataset(tok, str(tmp_path / "train.jsonl"),
                                 train=True, **kw),
                     4, shuffle=True, seed=1, num_workers=1)
    el = BatchLoader(MhopDataset(tok, str(tmp_path / "dev.jsonl"), **kw), 4,
                     num_workers=1)
    torch.manual_seed(0)
    model = MhopRetriever(EncoderConfig.tiny(vocab_size=512,
                                             max_position_embeddings=64),
                          cls_only=True, fp32_params=True)
    cfg = RetrieverTrainConfig(batch_size=4, num_epochs=num_epochs,
                               learning_rate=1e-3)
    return model, cfg, tl, el


@pytest.mark.parametrize("momentum", [False, True])
def test_resume_on_device_mesh(tmp_path, momentum):
    """tests/test_resume.py::test_resume_on_device_mesh: a trainer on a
    data-2 mesh saves its state after epoch 0; a new one on the mesh
    resumes from it, and its second epoch equals that of an uninterrupted
    two-epoch run on the mesh (the same parameters and, momentum, queue)."""
    _, mesh = _meshes(2)
    out = str(tmp_path / "out")

    def trainer(epochs, out_dir, logs=None):
        model, cfg, tl, el = _loaders(tmp_path, epochs)
        if momentum:
            import dataclasses
            cfg = dataclasses.replace(cfg, momentum=True, queue_size=16)
        # one schedule length for the interrupted and the whole run
        return T.RetrieverTrainer(
            model, cfg, tl, el, total_steps=8, output_dir=out_dir, mesh=mesh,
            log_fn=(lambda *_: None) if logs is None else logs.append)

    trainer(1, out).run()
    logs = []
    t2 = trainer(2, out, logs)
    res = t2.run()
    assert any("resumed from epoch 0" in line for line in logs)
    assert res["best_mrr"] > 0
    whole = trainer(2, str(tmp_path / "whole"))
    whole.run()
    assert t2.state.step == whole.state.step == 8
    for k, v in whole.state.model.state_dict().items():
        assert torch.equal(t2.state.model.state_dict()[k], v), k
    if momentum:
        assert torch.equal(t2.state.queue, whole.state.queue)
