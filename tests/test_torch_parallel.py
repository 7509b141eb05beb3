"""Tensor parallelism: the port's ``parallel/sharding.py`` and the
encoder's tensor-parallel layer against the JAX package's
``parallel/sharding.py`` and its TP train step (tests/test_parallel.py,
ported), on ``[cpu] * n`` meshes (the JAX side on conftest's 8 virtual
CPU devices), from the same weights (``models/convert.py``).

Tolerances:
  * the split set: exactly the parameters JAX's rule shards, through the
    weight converters; shapes unchanged once joined, bit for bit.
  * the TP step on a (data 2, index 4) mesh (fp32 compute), against
    JAX's TP step and the port's unsharded step: JAX's own criteria (loss
    rel 1e-5; parameters rtol 2e-3, atol 2e-4; the attention key biases,
    whose true gradient is zero (softmax shift invariance), atol 2.5·lr,
    Adam's ±lr step on an ulp-sized gradient), and the key biases'
    gradient below 1e-6 of the largest.  Against the unsharded step also
    the stricter criteria of tests/test_torch_train.py: gradients within
    1e-6 + 1e-4 of each tensor's largest, parameters within
    ``chip_smoke.adam_bound``.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.core.config import \
    RetrieverTrainConfig as JaxTrainConfig
from multihop_dense_retrieval_tpu.core.mesh import make_mesh as jax_mesh
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxMhop
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.parallel import sharding as jsharding
from multihop_dense_retrieval_tpu.train import trainer as JT
from multihop_dense_retrieval_tpu_torch.core.config import (
    EncoderConfig, RetrieverTrainConfig)
from multihop_dense_retrieval_tpu_torch.core.mesh import Mesh, make_mesh
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, QAReader, UnifiedRetriever, reader_state_dict_from_jax,
    retriever_state_dict_from_jax, unified_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.parallel import (
    constrain_params, encoder_param_specs, shard_params)
from multihop_dense_retrieval_tpu_torch.parallel import sharding
from multihop_dense_retrieval_tpu_torch.train import trainer as T
from tests.test_torch_train import (LR, _allowed, _capture_grads, _clipped,
                                    _j, _mhop_batch, _t)

CPU = torch.device("cpu")
# tests/test_parallel.py's model and batch
TP_KW = dict(vocab_size=256, hidden_size=32, num_heads=4, intermediate_size=64,
             max_position_embeddings=40)


def _cpu_mesh(data, index):
    return make_mesh(data=data, index=index, devices=[CPU] * (data * index))


def _tp_batch():
    ids = np.random.RandomState(0).randint(5, 250, size=(8, 16)).astype(
        np.int32)
    batch = {}
    for k in ("q", "q_sp", "c1", "c2", "neg1", "neg2"):
        batch[f"{k}_input_ids"] = ids
        batch[f"{k}_mask"] = np.ones((8, 16), np.int32)
    return batch


# ---- the split set -----------------------------------------------------------


def _reader_inputs():
    ids = np.ones((2, 16), np.int32)
    return {"input_ids": ids, "attention_mask": ids,
            "token_type_ids": np.zeros_like(ids), "paragraph_mask": ids,
            "sent_offsets": np.zeros((2, 4), np.int32)}


def _spec_cases():
    kw = dict(TP_KW, vocab_size=96)
    ids = np.ones((2, 16), np.int32)
    bert = dict(kw, type_vocab_size=2, pad_token_id=0,
                roberta_positions=False)
    m = JaxMhop(JaxEncoderConfig.tiny(**kw))
    u = JaxUnified(JaxEncoderConfig.tiny(**kw), stop_on_pooled=True)
    r = JaxReader(JaxEncoderConfig.tiny(**bert), sp_pred=True)
    return [
        ("mhop", lambda: m.init(jax.random.PRNGKey(0), ids, ids,
                                method=m.encode_seq),
         retriever_state_dict_from_jax, MhopRetriever(EncoderConfig.tiny(**kw))),
        ("unified", lambda: u.init(jax.random.PRNGKey(0), ids, ids,
                                   method=u.encode_qsp),
         unified_state_dict_from_jax,
         UnifiedRetriever(EncoderConfig.tiny(**kw), stop_on_pooled=True)),
        ("reader", lambda: r.init(jax.random.PRNGKey(0), _j(_reader_inputs())),
         reader_state_dict_from_jax,
         QAReader(EncoderConfig.tiny(**bert), sp_pred=True)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["mhop", "unified", "reader"])
def test_spec_set_matches_jax_and_shapes_join_back(case):
    """The port's rule splits exactly the parameters JAX's
    ``encoder_param_specs`` shards over ``index`` (mapped through the
    weight converters), along the dim of the torch layout that JAX's
    split axis becomes; the blocks hold a quarter of their parameter
    each, and joined back (``gather_state_dict``) every parameter has its
    shape and its bits."""
    _, init, convert, model = _spec_cases()[case]
    params = jax.eval_shape(init)
    specs = jsharding.encoder_param_specs(params, jax_mesh(data=2, index=4))
    marks = jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, float("index" in str(s.spec)),
                             np.float32), specs, params)
    jax_split = {k for k, v in convert(marks).items() if v.numpy().all()}
    assert not any(v.numpy().any() and not v.numpy().all()
                   for v in convert(marks).values())
    mesh = _cpu_mesh(2, 4)
    port = encoder_param_specs(model, mesh)
    assert set(port) == {n for n, _ in model.named_parameters()}
    assert {k for k, d in port.items() if d is not None} == jax_split
    assert len(jax_split) == 10 * model.config.num_layers
    for name, dim in port.items():
        if name.endswith(("query.weight", "key.weight", "value.weight",
                          "intermediate.dense.weight")):
            assert dim == 0, name
        elif name.endswith("output.dense.weight"):
            assert dim == 1, name
    before = copy.deepcopy(model.state_dict())
    shard_params(model, mesh)
    blocks = dict(model.named_parameters())
    for name, dim in port.items():
        if dim is not None:
            base, _, last = name.rpartition(".")
            parts = [blocks[f"{base}.{last}.{s}"] for s in range(4)]
            assert all(p.shape[dim] * 4 == before[name].shape[dim]
                       for p in parts), name
            assert len({p.data_ptr() for p in parts}) == 4
    joined = sharding.gather_state_dict(model)
    assert list(joined) == list(before)
    for k, v in before.items():
        assert joined[k].shape == v.shape and torch.equal(joined[k], v), k


def test_shard_params_is_idempotent_through_constrain_params():
    """constrain_params leaves a model already in the mesh's layout as it
    is (the same parameter objects); shard_params refuses a split model;
    a model split over other devices than the mesh's raises."""
    model = MhopRetriever(EncoderConfig.tiny(**TP_KW))
    mesh = _cpu_mesh(1, 4)
    constrain_params(model, mesh)
    ids = [id(p) for p in model.parameters()]
    assert constrain_params(model, mesh) is model
    assert [id(p) for p in model.parameters()] == ids
    with pytest.raises(ValueError, match="already split"):
        shard_params(model, mesh)
    with pytest.raises(ValueError, match="other devices"):
        constrain_params(model, _cpu_mesh(1, 2))


@pytest.mark.parametrize("heads,inter,what", [(4, 64, "num_heads"),
                                              (6, 64, "intermediate_size")])
def test_shards_that_do_not_divide_raise(heads, inter, what):
    model = MhopRetriever(EncoderConfig.tiny(**dict(
        TP_KW, num_heads=heads, hidden_size=48, intermediate_size=inter)))
    with pytest.raises(ValueError, match=what):
        shard_params(model, _cpu_mesh(1, 3))
    with pytest.raises(ValueError, match=what):
        encoder_param_specs(model, _cpu_mesh(1, 3))


@pytest.mark.parametrize("ranks", [((0, 1, 0, 1),), ((0, 0, 1, 1), (1, 1, 0, 0)),
                                   ((0, 1, 1, 0),), ((0, 0, 1, 1), (0, 0, 2, 2))],
                         ids=["interleaved", "rank-order", "not-contiguous",
                              "other-peers"])
def test_tensor_parallel_layout_that_interleaves_ranks_raises(ranks):
    """A data row whose index shards interleave processes, or come out of
    rank order, or a process holding its shards beside other processes
    in another row: ``ValueError`` from the layout check, before any
    group or collective (no process group exists here)."""
    mesh = Mesh(devices=tuple((CPU,) * 4 for _ in ranks), ranks=ranks,
                rank=0)
    model = MhopRetriever(EncoderConfig.tiny(**TP_KW))
    with pytest.raises(ValueError, match="rank"):
        shard_params(model, mesh)
    with pytest.raises(ValueError, match="rank"):
        T.make_train_step(mesh=mesh, tensor_parallel=True)
    assert not torch.distributed.is_initialized()


# ---- the TP step ---------------------------------------------------------


def _jax_tp_init():
    """tests/test_parallel.py's model, batch and initial parameters."""
    model = JaxMhop(JaxEncoderConfig.tiny(**TP_KW))
    batch = _j(_tp_batch())
    return model, batch, model.init(jax.random.PRNGKey(0), batch)


def _jax_tp_steps(init=None):
    """JAX's base and TP steps (tests/test_parallel.py) from one init
    (``_jax_tp_init``'s)."""
    model, batch, params = init or _jax_tp_init()
    host = jax.device_get(params)       # the step donates its state
    tx = JT.make_optimizer(JaxTrainConfig(warmup_ratio=0.0, learning_rate=LR),
                           10)
    tp_step = JT.make_train_step(model, tx, mesh=jax_mesh(data=2, index=4),
                                 tensor_parallel=True)
    s1, loss1 = tp_step(JT.TrainState.create(params, tx), batch)
    return host, float(loss1), jax.device_get(s1.params)


def _assert_jax_criteria(got, exp):
    """tests/test_parallel.py's parameter criteria, on two state dicts."""
    for name, e in exp.items():
        is_key_bias = "key" in name and name.endswith("bias")
        np.testing.assert_allclose(got[name].numpy(), e.numpy(), rtol=2e-3,
                                   atol=2.5 * LR if is_key_bias else 2e-4,
                                   err_msg=name)


def _tp_run(base, batch, mesh):
    """One train step of a copy of ``base`` (laid out over ``mesh``'s index
    shards first, when given): (loss, reference state dict, the gradients
    the update consumed with the blocks joined)."""
    model = copy.deepcopy(base)
    if mesh is not None:
        shard_params(model, mesh)
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=LR), 10))
    grads = _capture_grads(state)
    state, loss = T.make_train_step(mesh=mesh, tensor_parallel=True)(
        state, _t(batch))
    blocks = {}
    for name, g in grads[0].items():
        head, _, last = name.rpartition(".")
        blocks.setdefault(head if last.isdigit() else name, []).append(g)
    dims = encoder_param_specs(base, _cpu_mesh(1, 1))
    return float(loss), T.reference_state_dict(model), {
        k: torch.cat(v, dims[k] or 0) for k, v in blocks.items()}


def test_tp_train_step_matches_jax_and_unsharded():
    """tests/test_parallel.py's case: one TP step on a (data 2, index 4)
    mesh equals JAX's TP step and the port's unsharded step from the same
    weights, by JAX's criteria; the key biases' gradient is ~0 (checked,
    not assumed).  The batch's six views are one and the same rows, which
    makes the loss ill-conditioned (scores tie): the gradients' tighter
    check runs on a ragged batch (next test)."""
    jparams, jloss, jtp = _jax_tp_steps()
    base = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    base.load_state_dict(retriever_state_dict_from_jax(jparams))
    lp, sd_plain, g_plain = _tp_run(base, _tp_batch(), None)
    lt, sd_tp, _ = _tp_run(base, _tp_batch(), _cpu_mesh(2, 4))
    assert lt == pytest.approx(jloss, rel=1e-5)
    assert lt == pytest.approx(lp, rel=1e-5)
    exp = retriever_state_dict_from_jax(jtp)
    assert set(sd_tp) == set(exp) == set(sd_plain)
    _assert_jax_criteria(sd_tp, exp)
    _assert_jax_criteria(sd_tp, sd_plain)
    gmax = max(g.abs().max().item() for g in g_plain.values())
    key_biases = [k for k in g_plain if ".key.bias" in k]
    assert len(key_biases) == base.config.num_layers
    for k in key_biases:
        assert g_plain[k].abs().max().item() < 1e-6 * max(gmax, 1.0), k


def test_tp_step_gradients_match_unsharded():
    """On a ragged batch of distinct views, the (data 2, index 4) TP step's
    gradients (blocks joined) lie within 1e-6 + 1e-4 of each tensor's
    largest of the unsharded step's, and its parameters within
    ``adam_bound``."""
    torch.manual_seed(0)
    base = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    batch = _mhop_batch(1, b=8)
    lp, sd_plain, g_plain = _tp_run(base, batch, None)
    lt, sd_tp, g_tp = _tp_run(base, batch, _cpu_mesh(2, 4))
    assert lt == pytest.approx(lp, rel=1e-5)
    assert set(g_tp) == set(g_plain)
    g0 = _clipped({k: v.numpy() for k, v in g_plain.items()})
    for k, g in g_plain.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        assert (g_tp[k] - g).abs().max().item() <= tol, k
        diff = ((sd_tp[k] - sd_plain[k]).abs() / LR).numpy()
        assert (diff <= _allowed(g0[k], sd_plain[k].numpy(), 1,
                                 1e-3)).all(), k


@pytest.fixture
def one_torch_thread():
    """The port's side on one intra-op thread (see
    tests/test_torch_prune_sweep.py::one_torch_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tp_bf16_loss_lies_from_the_unsharded_step_as_jax_s_does(
        one_torch_thread):
    """bf16 compute (fp32 master weights), the (data 2, index 4) TP step
    against the unsharded step, in each package from the same weights and
    ragged batches (4 seeds): the relative distance of the TP step's loss
    from its own package's unsharded loss.  The port adds each shard's
    bf16 partial product in fp32, then rounds once
    (``models/encoder.py::row_parallel``); XLA reduces the partials in the
    dot's dtype.  Either way the distance is bf16 rounding noise: the
    port's mean distance must stay within twice JAX's, and within twice
    the distance between the two packages' own unsharded bf16 losses
    (all three printed)."""
    kw = dict(TP_KW, dtype="bfloat16")
    jmodel = JaxMhop(JaxEncoderConfig.tiny(**kw))
    tx = JT.make_optimizer(JaxTrainConfig(warmup_ratio=0.0, learning_rate=LR),
                           10)
    plain_step = JT.make_train_step(jmodel, tx)
    tp_step = JT.make_train_step(jmodel, tx, mesh=jax_mesh(data=2, index=4),
                                 tensor_parallel=True)
    jax_d, port_d, across = [], [], []
    for seed in range(4):
        batch = _mhop_batch(seed, b=8)
        host = jax.device_get(jmodel.init(jax.random.PRNGKey(seed),
                                          _j(batch)))
        losses = [float(step(JT.TrainState.create(jax.device_put(host), tx),
                             _j(batch))[1])
                  for step in (plain_step, tp_step)]
        base = MhopRetriever(EncoderConfig.tiny(**kw), fp32_params=True)
        base.load_state_dict(retriever_state_dict_from_jax(host))
        lp, _, _ = _tp_run(base, batch, None)
        lt, _, _ = _tp_run(base, batch, _cpu_mesh(2, 4))
        assert np.isfinite([lp, lt] + losses).all()
        jax_d.append(abs(losses[1] - losses[0]) / abs(losses[0]))
        port_d.append(abs(lt - lp) / abs(lp))
        across.append(abs(lp - losses[0]) / abs(losses[0]))
    print(f"TP bf16 mean relative loss distance over 4 seeds: port "
          f"{np.mean(port_d):.4g}, JAX {np.mean(jax_d):.4g}; the packages' "
          f"unsharded losses {np.mean(across):.4g} apart")
    assert 0 < np.mean(port_d) <= 2 * np.mean(jax_d), (port_d, jax_d)
    assert np.mean(port_d) <= 2 * np.mean(across), (port_d, across)


def test_tp_model_reference_state_dict_is_bit_equal():
    """After a TP step, the model's reference layout (the checkpoint
    files' ``reference_state_dict``) joins the blocks back bit for bit,
    under the unsharded model's names and order, and strict-loads into an
    unsharded model whose vectors equal the TP model's."""
    torch.manual_seed(3)
    model = UnifiedRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    plain_names = list(T.reference_state_dict(model))
    mesh = _cpu_mesh(1, 4)
    b = _tp_batch()
    b["stop_targets"] = np.array([1, 0] * 4, np.int32)
    state = T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=LR), 10))
    state, _ = T.make_train_step(unified=True, mesh=mesh,
                                 tensor_parallel=True)(state, _t(b))
    assert any(isinstance(m, sharding.ShardedLinear) for m in model.modules())
    sd = T.reference_state_dict(model)
    assert list(sd) == plain_names
    joined = sharding.gather_state_dict(model)
    for name, mod in model.named_modules():
        if isinstance(mod, sharding.ShardedLinear):
            assert torch.equal(joined[f"{name}.weight"],
                               torch.cat(list(mod.weight), mod.dim))
    plain = UnifiedRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    plain.load_state_dict({k.replace("encoder_c.", "encoder.", 1): v
                           for k, v in joined.items()}, strict=True)
    with torch.no_grad():
        ids = torch.from_numpy(b["q_input_ids"])
        a = model.encode_seq(ids, torch.ones_like(ids))
        c = plain.encode_seq(ids, torch.ones_like(ids))
    torch.testing.assert_close(a, c, rtol=0, atol=1e-5)


def test_tp_optimizer_follows_the_layout_only_before_its_first_update():
    """The TP step lays an unsharded model out at its first call and its
    optimizer follows the new parameters; a state that has already
    stepped cannot follow a re-laid-out model."""
    model = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    tx = T.make_optimizer(RetrieverTrainConfig(warmup_ratio=0.0), 10)
    state = T.TrainState.create(model, tx)
    state, _ = T.make_train_step(mesh=_cpu_mesh(1, 2), tensor_parallel=True)(
        state, _t(_tp_batch()))
    assert all(p is q for p, q in zip(state.opt.params, model.parameters()))
    assert all(p in state.opt.adam.state for p in model.parameters())

    model = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    state = T.TrainState.create(model, tx)
    state, _ = T.make_train_step()(state, _t(_tp_batch()))
    with pytest.raises(ValueError, match="before its first update"):
        T.make_train_step(mesh=_cpu_mesh(1, 2), tensor_parallel=True)(
            state, _t(_tp_batch()))

