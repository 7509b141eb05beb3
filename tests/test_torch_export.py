"""Checkpoint export (the port's ``models/export.py`` and
``cli/export_ckpt.py``): tests/test_export.py ported, and each exporter
held to the JAX package's on the same parameters (Flax trees carried into
the port with ``models/convert.py``).

Every check here is exact: the exported key set and every value equal the
JAX exporter's bit for bit (both are transposes and renames of the same
fp32 numbers); a port model or checkpoint round-trips through export and a
strict load bit for bit; the one numerical check, an exported retriever in
``transformers.RobertaModel``, holds the vectors to 1e-4 as the JAX test
does.  The port's CLI reads the port's ``.pt`` files (a trainer's
``checkpoint_*.pt`` or the preemption state); an orbax directory raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import convert as jconvert
from multihop_dense_retrieval_tpu.models import export as jexport
from multihop_dense_retrieval_tpu.models.reader import QAReader as JaxReader
from multihop_dense_retrieval_tpu.models.retriever import \
    MhopRetriever as JaxMhop
from multihop_dense_retrieval_tpu.models.retriever import \
    UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu_torch.cli import export_ckpt
from multihop_dense_retrieval_tpu_torch.core import checkpoint as ckpt
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, QAReader, TransformerEncoder, UnifiedRetriever, convert,
    export)
from multihop_dense_retrieval_tpu_torch.train.trainer import \
    reference_state_dict

BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=40,
            type_vocab_size=1, pad_token_id=1, dtype="float32")
BERT = dict(type_vocab_size=2, pad_token_id=0, roberta_positions=False)
UNIFIED_VIEWS = ["q_input_ids", "q_mask", "q_sp_input_ids", "q_sp_mask",
                 "c1_input_ids", "c1_mask", "c2_input_ids", "c2_mask",
                 "neg1_input_ids", "neg1_mask", "neg2_input_ids", "neg2_mask"]


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    return JaxEncoderConfig(**kw), EncoderConfig(**kw)


def _same_as_jax(got, exp):
    """The port's export equals the JAX exporter's: key set, fp32, bits."""
    assert set(got) == set(exp)
    for k, e in exp.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(e),
                                      err_msg=k)


def _same_tree(a, b, path=""):
    assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _mhop_params(jcfg, seed=0):
    model = JaxMhop(jcfg)
    ids = jnp.ones((1, 8), jnp.int32)
    return jax.device_get(model.init(jax.random.PRNGKey(seed), ids, ids,
                                     method=model.encode_seq)["params"])


def _unified_params(jcfg, seed=1, **kw):
    ids = jnp.ones((1, 8), jnp.int32)
    return jax.device_get(JaxUnified(jcfg, **kw).init(
        jax.random.PRNGKey(seed), {k: ids for k in UNIFIED_VIEWS})["params"])


def _reader_params(jcfg, seed=3, sp_pred=True):
    dummy = {"input_ids": jnp.ones((1, 16), jnp.int32),
             "attention_mask": jnp.ones((1, 16), jnp.int32),
             "token_type_ids": jnp.zeros((1, 16), jnp.int32),
             "paragraph_mask": jnp.ones((1, 16), jnp.int32),
             "sent_offsets": jnp.zeros((1, 4), jnp.int32),
             "sent_mask": jnp.ones((1, 4), jnp.int32)}
    return jax.device_get(JaxReader(jcfg, sp_pred=sp_pred).init(
        jax.random.PRNGKey(seed), dummy)["params"])


def test_mhop_export_roundtrip_bit_exact():
    jcfg, cfg = _cfgs()
    params = _mhop_params(jcfg)
    model = MhopRetriever(cfg)
    model.load_state_dict(convert.retriever_state_dict_from_jax(params))
    sd = export.retriever_state_dict(model)
    _same_as_jax(sd, jexport.retriever_flax_to_ckpt(params))
    # the synthesized (reference-unused) pooler satisfies the strict load
    assert sd["encoder.pooler.dense.weight"].shape == (32, 32)
    assert not sd["encoder.pooler.dense.weight"].any()
    back = MhopRetriever(cfg)
    back.load_state_dict(sd)
    _same_state(back.state_dict(), model.state_dict())
    _same_tree(jconvert.retriever_ckpt_to_flax(
        {k: v.numpy() for k, v in sd.items()}, jcfg), params)


def test_mhop_export_strict_loads_and_matches_the_port():
    """The exported encoder strict-loads into transformers.RobertaModel,
    and the HF model with the exported head gives the port's vectors."""
    import transformers

    _, cfg = _cfgs()
    torch.manual_seed(0)
    model = MhopRetriever(cfg).eval()
    sd = export.retriever_state_dict(model)
    hf = transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=cfg.layer_norm_eps), add_pooling_layer=True)
    hf.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                        if k.startswith("encoder.")}, strict=True)
    hf.eval()
    lin = torch.nn.Linear(32, 32)
    ln = torch.nn.LayerNorm(32, eps=cfg.layer_norm_eps)
    lin.load_state_dict({"weight": sd["project.0.weight"],
                         "bias": sd["project.0.bias"]})
    ln.load_state_dict({"weight": sd["project.1.weight"],
                        "bias": sd["project.1.bias"]})
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 120, size=(3, 11)).astype(np.int64)
    mask = np.ones((3, 11), np.int64)
    mask[1, 7:] = 0
    ids[1, 7:] = cfg.pad_token_id
    with torch.no_grad():
        h = hf(input_ids=torch.tensor(ids),
               attention_mask=torch.tensor(mask)).last_hidden_state
        expected = ln(lin(h[:, 0])).numpy()
        got = model.encode_seq(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_projection", [True, False])
def test_unified_export_roundtrip_reference_layout(use_projection):
    """encoder_c. prefix + stop + the real pooler (+ project); the JAX
    exporter's dict, and the reference layout read back by both packages."""
    jcfg, cfg = _cfgs()
    params = _unified_params(jcfg, use_projection=use_projection,
                             stop_on_pooled=True)
    model = UnifiedRetriever(cfg, use_projection=use_projection,
                             stop_on_pooled=True)
    model.load_state_dict(convert.unified_state_dict_from_jax(params))
    sd = export.unified_state_dict(model)
    _same_as_jax(sd, jexport.unified_flax_to_ckpt(params))
    assert "encoder_c.embeddings.word_embeddings.weight" in sd
    assert "stop.weight" in sd
    assert ("project.0.weight" in sd) == use_projection
    # the trainer's own checkpoint names are the same, minus nothing
    assert set(sd) == set(reference_state_dict(model))
    port_sd, proj, pooled = convert.unified_state_dict_from_reference(sd)
    assert (proj, pooled) == (use_projection, True)
    back = UnifiedRetriever(cfg, use_projection=proj, stop_on_pooled=pooled)
    back.load_state_dict(port_sd)
    _same_state(back.state_dict(), model.state_dict())
    _same_tree(jconvert.unified_ckpt_to_flax(
        {k: v.numpy() for k, v in sd.items()}, jcfg), params)


def test_unified_export_refuses_stop_on_cls_trees():
    """The reference's stop head always reads the tanh pooler; a
    stop_on_pooled=False model has none, and both exporters refuse it."""
    jcfg, cfg = _cfgs(**BERT)
    params = _unified_params(jcfg, seed=2, use_projection=False,
                             stop_on_pooled=False)
    with pytest.raises(ValueError, match="stop_on_pooled"):
        jexport.unified_flax_to_ckpt(params)
    model = UnifiedRetriever(cfg, use_projection=False, stop_on_pooled=False)
    model.load_state_dict(convert.unified_state_dict_from_jax(params))
    with pytest.raises(ValueError, match="stop_on_pooled"):
        export.unified_state_dict(model)


@pytest.mark.parametrize("electra", [True, False])
@pytest.mark.parametrize("sp_pred", [True, False])
def test_reader_export_roundtrip(electra, sp_pred):
    jcfg, cfg = _cfgs(**BERT)
    params = _reader_params(jcfg, sp_pred=sp_pred)
    model = QAReader(cfg, sp_pred=sp_pred)
    model.load_state_dict(convert.reader_state_dict_from_jax(params))
    sd = export.reader_state_dict(model, electra=electra)
    _same_as_jax(sd, jexport.reader_flax_to_ckpt(params, electra=electra))
    if electra:
        assert "pooler.dense.weight" in sd           # reference BertPooler
        assert "encoder.pooler.dense.weight" not in sd
    else:
        assert "encoder.pooler.dense.weight" in sd   # HF pooler reused
        assert "pooler.dense.weight" not in sd
    assert ("sp.weight" in sd) == sp_pred
    back = QAReader(cfg, sp_pred=sp_pred)
    back.load_state_dict(sd)
    _same_state(back.state_dict(), model.state_dict())
    _same_tree(jconvert.reader_ckpt_to_flax(
        {k: v.numpy() for k, v in sd.items()}, jcfg, sp_pred=sp_pred),
        params)


def test_electra_small_embeddings_project_roundtrip():
    """ELECTRA-small/base style encoders (embedding_size != hidden_size, an
    extra embeddings_project dense) survive export and a strict load."""
    from multihop_dense_retrieval_tpu.models.encoder import \
        TransformerEncoder as JaxEncoder

    jcfg, cfg = _cfgs(embedding_size=16, **BERT)
    ids = jnp.ones((1, 8), jnp.int32)
    enc = jax.device_get(JaxEncoder(jcfg).init(jax.random.PRNGKey(5), ids,
                                               ids)["params"])
    params = _reader_params(jcfg)
    params["encoder"] = enc
    model = QAReader(cfg)
    model.load_state_dict(convert.reader_state_dict_from_jax(params))
    sd = export.reader_state_dict(model)
    _same_as_jax(sd, jexport.reader_flax_to_ckpt(params))
    assert "encoder.embeddings_project.weight" in sd
    assert sd["encoder.embeddings.word_embeddings.weight"].shape[1] == 16
    back = TransformerEncoder(cfg)
    back.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                          if k.startswith("encoder.")})
    _same_state(back.state_dict(), model.encoder.state_dict())


def test_export_casts_serving_weights_to_fp32():
    """A serving model keeps its dense weights in bf16; the export is fp32
    (the same values)."""
    _, cfg = _cfgs(dtype="bfloat16")
    model = MhopRetriever(cfg)
    w = model.encoder.encoder.layer[0].intermediate.dense.weight
    assert w.dtype == torch.bfloat16
    sd = export.retriever_state_dict(model)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert torch.equal(
        sd["encoder.encoder.layer.0.intermediate.dense.weight"], w.float())


def _run_cli(tmp_path, checkpoint, arch):
    out = str(tmp_path / f"{arch}.pt")
    export_ckpt.main(["--checkpoint", checkpoint, "--arch", arch,
                      "--out", out])
    assert os.path.exists(out)
    return torch.load(out, weights_only=True)


def test_export_cli_port_pt_to_reference_pt(tmp_path):
    """tests/test_export.py::test_export_cli_orbax_to_pt on the port: the
    CLI reads a trainer's checkpoint_*.pt and the preemption state file
    (its model parameters); the output equals the JAX exporter's on the
    same parameters and reads back into the JAX package bit for bit."""
    jcfg, cfg = _cfgs()
    params = _mhop_params(jcfg, seed=4)
    model = MhopRetriever(cfg)
    model.load_state_dict(convert.retriever_state_dict_from_jax(params))
    exp = jexport.retriever_flax_to_ckpt(params)
    best = str(tmp_path / "checkpoint_best.pt")
    ckpt.save_pytree(best, reference_state_dict(model))
    state = str(tmp_path / "preempt" / "trainer_state")
    ckpt.save_pytree(state, {"params": model.state_dict(),
                             "opt_state": {}, "step": 3})
    for path in (best, state):
        sd = _run_cli(tmp_path, path, "mhop")
        _same_as_jax(sd, exp)
        _same_tree(jconvert.retriever_ckpt_to_flax(
            jconvert.load_torch_state_dict(str(tmp_path / "mhop.pt")),
            jcfg), params)


def test_export_cli_unified_and_readers(tmp_path):
    """--arch unified from a trainer's reference-layout checkpoint and from
    the port-named preemption state; --arch reader / reader-bert from a
    reader checkpoint: each the JAX exporter's dict."""
    jcfg, cfg = _cfgs()
    params = _unified_params(jcfg, use_projection=True, stop_on_pooled=True)
    model = UnifiedRetriever(cfg, use_projection=True, stop_on_pooled=True)
    model.load_state_dict(convert.unified_state_dict_from_jax(params))
    best = str(tmp_path / "checkpoint_best.pt")
    ckpt.save_pytree(best, reference_state_dict(model))
    state = str(tmp_path / "trainer_state")
    ckpt.save_pytree(state, {"params": model.state_dict(), "opt_state": {},
                             "step": 1})
    for path in (best, state):
        _same_as_jax(_run_cli(tmp_path, path, "unified"),
                     jexport.unified_flax_to_ckpt(params))

    jcfg, cfg = _cfgs(**BERT)
    rparams = _reader_params(jcfg)
    reader = QAReader(cfg)
    reader.load_state_dict(convert.reader_state_dict_from_jax(rparams))
    rbest = str(tmp_path / "reader_best.pt")
    ckpt.save_pytree(rbest, export.reader_state_dict(reader))
    for arch, electra in (("reader", True), ("reader-bert", False)):
        _same_as_jax(_run_cli(tmp_path, rbest, arch),
                     jexport.reader_flax_to_ckpt(rparams, electra=electra))


def test_export_cli_refuses_an_orbax_directory(tmp_path):
    """Orbax directories are the JAX package's format: the port's CLI names
    the JAX exporter instead of reading one."""
    os.makedirs(tmp_path / "checkpoint_best")
    with pytest.raises(SystemExit,
                       match="multihop_dense_retrieval_tpu.cli.export_ckpt"):
        export_ckpt.main(["--checkpoint", str(tmp_path / "checkpoint_best"),
                          "--arch", "mhop", "--out",
                          str(tmp_path / "out.pt")])
