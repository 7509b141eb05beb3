"""UnifiedRetriever parity: the port's model against the JAX package's
after ``unified_state_dict_from_jax``, for every use_projection ×
stop_on_pooled pair, and a reference-layout UnifiedRetriever ``.pt``
(``encoder_c.``, ``stop.``, ``project.0/1``, ``encoder_c.pooler.dense``;
the JAX package's ``unified_flax_to_ckpt`` writes it) loaded by both
packages' ``init_retriever(unified=True)``, as
tests/test_encoder.py::test_unified_ckpt_reference_layout_parity specifies
the layout.

Tolerances: fp32 compute, vectors and stop logits atol 1e-5 (summation
order, as tests/test_torch_encoder.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.export import unified_flax_to_ckpt
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import (
    UnifiedRetriever, unified_state_dict_from_jax,
    unified_state_dict_from_reference)

KW = dict(vocab_size=96, max_position_embeddings=40)


def _inputs(seed=0, b=5, L=16):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, L + 1, size=b)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(4, 96, size=(b, L)), 1)
    return ids.astype(np.int32), mask


def _jax_model(use_projection, stop_on_pooled, seed=0):
    model = JaxUnified(JaxEncoderConfig.tiny(**KW),
                       use_projection=use_projection,
                       stop_on_pooled=stop_on_pooled)
    ids8 = jnp.ones((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids8, ids8,
                        method=model.encode_qsp)
    return model, params


def _jax_outputs(model, params, ids, mask):
    vec, logits = model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                              method=model.encode_qsp)
    seq = model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                      method=model.encode_seq)
    return (np.asarray(vec, np.float32), np.asarray(logits),
            np.asarray(seq, np.float32))


def _port_outputs(model, ids, mask):
    with torch.inference_mode():
        vec, logits = model.encode_qsp(torch.from_numpy(ids),
                                       torch.from_numpy(mask))
        seq = model.encode_seq(torch.from_numpy(ids), torch.from_numpy(mask))
        q = model.encode_q(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.equal(q, seq)
    return vec.numpy(), logits.numpy(), seq.numpy()


@pytest.mark.parametrize("stop_on_pooled", [False, True])
@pytest.mark.parametrize("use_projection", [True, False])
@pytest.mark.parametrize("cls_only", [False, True])
def test_unified_retriever_matches_jax(use_projection, stop_on_pooled,
                                       cls_only):
    jmodel, params = _jax_model(use_projection, stop_on_pooled)
    model = UnifiedRetriever(EncoderConfig.tiny(**KW),
                             use_projection=use_projection,
                             stop_on_pooled=stop_on_pooled, cls_only=cls_only)
    model.load_state_dict(unified_state_dict_from_jax(
        jax.device_get(params)))
    ids, mask = _inputs()
    exp = _jax_outputs(jmodel, params, ids, mask)
    got = _port_outputs(model.eval(), ids, mask)
    for g, e, what in zip(got, exp, ("vector", "stop logits", "encode_seq")):
        assert g.dtype == np.float32 and g.shape == e.shape, what
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-5, err_msg=what)
    np.testing.assert_array_equal(got[0], got[2])


@pytest.mark.parametrize("project", [True, False])
def test_reference_unified_checkpoint_loads_in_both_packages(project,
                                                             tmp_path):
    jmodel, params = _jax_model(True, True, seed=3)
    ref = unified_flax_to_ckpt(jax.device_get(params)["params"])
    assert "encoder_c.pooler.dense.weight" in ref and "stop.weight" in ref
    if not project:
        ref = {k: v for k, v in ref.items() if not k.startswith("project.")}
    path = str(tmp_path / "unified.pt")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in ref.items()}, path)

    jm, jp = jcommon.init_retriever(JaxEncoderConfig.tiny(**KW),
                                    unified=True, checkpoint=path)
    tm = tcommon.init_retriever(EncoderConfig.tiny(**KW), unified=True,
                                checkpoint=path, device="cpu")
    assert (tm.use_projection, tm.stop_on_pooled) == \
        (jm.use_projection, jm.stop_on_pooled) == (project, True)
    ids, mask = _inputs(seed=1)
    exp = _jax_outputs(jm, jp, ids, mask)
    got = _port_outputs(tm, ids, mask)
    for g, e, what in zip(got, exp, ("vector", "stop logits", "encode_seq")):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-5, err_msg=what)


def test_reference_layout_names_map_onto_the_port():
    """``encoder.`` as the transformer prefix works too, and the pooler
    under it feeds the stop head."""
    sd = {"encoder.embeddings.word_embeddings.weight": torch.zeros(4, 2),
          "encoder.pooler.dense.weight": torch.ones(2, 2),
          "encoder.pooler.dense.bias": torch.ones(2),
          "stop.weight": torch.ones(2, 2), "stop.bias": torch.zeros(2)}
    out, proj, pooled = unified_state_dict_from_reference(sd)
    assert (proj, pooled) == (False, True)
    assert sorted(out) == ["encoder.embeddings.word_embeddings.weight",
                           "pooler.bias", "pooler.weight", "stop_head.bias",
                           "stop_head.weight"]


def test_seeded_unified_weights_are_made_on_the_device(monkeypatch):
    """Without a checkpoint the unified weights come from the seed, made
    under the named device, the caller's RNG state left as it was."""
    made = []
    real = torch.nn.Linear.__init__

    def linear_init(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self.weight.device.type)

    monkeypatch.setattr(torch.nn.Linear, "__init__", linear_init)
    cfg = EncoderConfig.tiny(**KW)
    state = torch.random.get_rng_state()
    a = tcommon.init_retriever(cfg, unified=True, seed=4, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    b = tcommon.init_retriever(cfg, unified=True, seed=4, device="cpu")
    assert made and set(made) == {"cpu"}
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert not a.training and a.encoder.cls_only
