"""Encoder parity: the JAX MhopRetriever.encode_seq against the PyTorch
port after weight conversion, on the same ids and masks (numpy, seeded).

Tolerances:
  * fp32 compute: atol 1e-5 — the two frameworks sum matmul products and
    LayerNorm statistics in different orders; nothing else differs.
  * bf16 compute: the encoders round to bf16 (8 significant bits) after
    every op, and a one-ulp flip early in the stack propagates, so the
    final fp32 vectors (LayerNorm output, unit scale) are held to
    atol 0.1 with at least 99% of entries within 0.03.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxMhopRetriever
from multihop_dense_retrieval_tpu.models.export import retriever_flax_to_ckpt
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, retriever_state_dict_from_jax)


def _cfg_kwargs(dtype, scores, roberta):
    kw = dict(vocab_size=96, max_position_embeddings=40, dtype=dtype,
              attention_scores_dtype=scores)
    if not roberta:
        kw.update(roberta_positions=False, type_vocab_size=2, pad_token_id=0,
                  layer_norm_eps=1e-12)
    return kw


def _inputs(rng, b, L, pad_id, roberta):
    lens = rng.randint(3, L + 1, size=b)
    ids = rng.randint(4, 96, size=(b, L)).astype(np.int32)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, pad_id).astype(np.int32)
    tt = None
    if not roberta:
        tt = (np.arange(L)[None] >= (lens // 2)[:, None]).astype(np.int32) * mask
    return ids, mask, tt


def _jax_model(kw, seed):
    cfg = JaxEncoderConfig.tiny(**kw)
    model = JaxMhopRetriever(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)
    return model, params


def _jax_encode(model, params, ids, mask, tt):
    return np.asarray(model.apply(
        params, jnp.asarray(ids), jnp.asarray(mask),
        None if tt is None else jnp.asarray(tt), method=model.encode_seq),
        np.float32)


def _torch_encode(model, ids, mask, tt):
    with torch.no_grad():
        out = model.encode_seq(torch.from_numpy(ids), torch.from_numpy(mask),
                               None if tt is None else torch.from_numpy(tt))
    return out.numpy()


def _close(got, exp, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    else:
        err = np.abs(got - exp)
        assert err.max() < 0.1, err.max()
        assert np.mean(err < 0.03) >= 0.99, np.mean(err < 0.03)


@pytest.mark.parametrize("dtype,scores", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("roberta", [True, False])
@pytest.mark.parametrize("cls_only", [False, True])
def test_encode_seq_matches_jax(dtype, scores, roberta, cls_only):
    kw = _cfg_kwargs(dtype, scores, roberta)
    jmodel, params = _jax_model(kw, seed=3)
    rng = np.random.RandomState(11)
    cfg = EncoderConfig.tiny(**kw)
    ids, mask, tt = _inputs(rng, 6, 24, cfg.pad_token_id, roberta)
    exp = _jax_encode(jmodel, params, ids, mask, tt)

    model = MhopRetriever(cfg, cls_only=cls_only)
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(params)))
    got = _torch_encode(model, ids, mask, tt)
    assert got.dtype == np.float32 and got.shape == exp.shape
    _close(got, exp, dtype)


@pytest.mark.parametrize("dtype,scores", [("float32", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("cls_only", [False, True])
def test_flash_attention_impl_matches_jax(dtype, scores, cls_only):
    """attention_impl="flash": the JAX encoder takes its stock TPU kernel only
    on a TPU, and its xla path elsewhere; the port runs the xla path on
    every device.  Same weights (converted), same tolerances as above."""
    kw = dict(_cfg_kwargs(dtype, scores, True), attention_impl="flash")
    jmodel, params = _jax_model(kw, seed=9)
    cfg = EncoderConfig.tiny(**kw)
    ids, mask, tt = _inputs(np.random.RandomState(13), 5, 24,
                            cfg.pad_token_id, True)
    exp = _jax_encode(jmodel, params, ids, mask, tt)
    model = MhopRetriever(cfg, cls_only=cls_only)
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(params)))
    got = _torch_encode(model, ids, mask, tt)
    assert got.dtype == np.float32 and got.shape == exp.shape
    _close(got, exp, dtype)


def test_cls_only_is_bit_identical_to_full_last_layer():
    kw = _cfg_kwargs("float32", "float32", True)
    _, params = _jax_model(kw, seed=5)
    sd = retriever_state_dict_from_jax(jax.device_get(params))
    cfg = EncoderConfig.tiny(**kw)
    ids, mask, tt = _inputs(np.random.RandomState(2), 4, 16, 1, True)
    outs = []
    for cls_only in (False, True):
        m = MhopRetriever(cfg, cls_only=cls_only)
        m.load_state_dict(sd)
        outs.append(_torch_encode(m, ids, mask, tt))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6)


def test_reference_checkpoint_layout_loads_directly():
    """The JAX package's exporter emits the reference's strict key set
    (with a synthesized HF pooler); it loads into the port as it is."""
    kw = _cfg_kwargs("float32", "float32", True)
    jmodel, params = _jax_model(kw, seed=7)
    ckpt = retriever_flax_to_ckpt(jax.device_get(params)["params"])
    assert any(k.startswith("encoder.pooler.") for k in ckpt)
    model = MhopRetriever(EncoderConfig.tiny(**kw))
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in ckpt.items()}, strict=True)
    ids, mask, tt = _inputs(np.random.RandomState(4), 5, 20, 1, True)
    np.testing.assert_allclose(_torch_encode(model, ids, mask, tt),
                               _jax_encode(jmodel, params, ids, mask, tt),
                               rtol=0, atol=1e-5)


# ---- gelu_new, relu, embedding_size != hidden_size (ELECTRA) --------------


@pytest.mark.parametrize("dtype,scores", [("float32", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("act,emb_size", [("gelu_new", None), ("relu", None),
                                          ("gelu", 16), ("gelu_new", 24)])
@pytest.mark.parametrize("roberta", [True, False])
def test_activations_and_embeddings_project_match_jax(dtype, scores, act,
                                                      emb_size, roberta):
    """hidden_act gelu_new / relu and the embeddings_project dense against
    the JAX encoder, weights carried by convert; the tolerances above."""
    kw = dict(_cfg_kwargs(dtype, scores, roberta), hidden_act=act,
              embedding_size=emb_size)
    jmodel, params = _jax_model(kw, seed=21)
    cfg = EncoderConfig.tiny(**kw)
    ids, mask, tt = _inputs(np.random.RandomState(17), 6, 24,
                            cfg.pad_token_id, roberta)
    exp = _jax_encode(jmodel, params, ids, mask, tt)
    sd = retriever_state_dict_from_jax(jax.device_get(params))
    assert ("encoder.embeddings_project.weight" in sd) == (emb_size is not None)
    model = MhopRetriever(cfg)
    model.load_state_dict(sd)
    got = _torch_encode(model, ids, mask, tt)
    assert got.shape == exp.shape
    _close(got, exp, dtype)


def test_electra_large_preset_matches_jax():
    import dataclasses

    got = dataclasses.asdict(EncoderConfig.electra_large())
    exp = dataclasses.asdict(JaxEncoderConfig.electra_large())
    assert got == exp
    assert EncoderConfig.electra_large(dtype="float32").dtype == "float32"


def _hf_hidden(hf, ids, mask, tt):
    with torch.no_grad():
        return hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long(),
                  token_type_ids=None if tt is None
                  else torch.from_numpy(tt).long()).last_hidden_state.numpy()


def _port_hidden(cfg, sd, ids, mask, tt):
    from multihop_dense_retrieval_tpu_torch.models import TransformerEncoder

    enc = TransformerEncoder(cfg)
    enc.load_state_dict(sd)
    with torch.no_grad():
        return enc(torch.from_numpy(ids), torch.from_numpy(mask),
                   None if tt is None else torch.from_numpy(tt)).numpy()


def test_fp32_encoder_matches_transformers_roberta():
    """The port's fp32 encoder against a randomly initialised transformers
    RobertaModel built from a local config: every hidden state, atol 1e-5
    (HF's own pooler is ignored by the port)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.RobertaConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, layer_norm_eps=1e-5,
        pad_token_id=1, hidden_act="gelu")
    torch.manual_seed(0)
    hf = transformers.RobertaModel(hf_cfg).eval()
    cfg = EncoderConfig.tiny(**_cfg_kwargs("float32", "float32", True))
    ids, mask, tt = _inputs(np.random.RandomState(8), 5, 24, 1, True)
    np.testing.assert_allclose(_port_hidden(cfg, hf.state_dict(), ids, mask,
                                            tt),
                               _hf_hidden(hf, ids, mask, tt),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_fp32_encoder_matches_transformers_electra(act):
    """The port's fp32 encoder against a randomly initialised transformers
    ElectraModel whose embeddings (16) are narrower than its hidden size
    (32), so its embeddings_project runs; atol 1e-5."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ElectraConfig(
        vocab_size=96, embedding_size=16, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2, layer_norm_eps=1e-12,
        pad_token_id=0, hidden_act=act)
    torch.manual_seed(1)
    hf = transformers.ElectraModel(hf_cfg).eval()
    cfg = EncoderConfig.tiny(**dict(_cfg_kwargs("float32", "float32", False),
                                    embedding_size=16, hidden_act=act))
    ids, mask, tt = _inputs(np.random.RandomState(9), 5, 24, 0, False)
    np.testing.assert_allclose(_port_hidden(cfg, hf.state_dict(), ids, mask,
                                            tt),
                               _hf_hidden(hf, ids, mask, tt),
                               rtol=0, atol=1e-5)
