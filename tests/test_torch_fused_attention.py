"""Kernel 8 (fused attention) in the port against the JAX package.

``fused_attention_plain`` (what the wrapper runs for CPU tensors) against
the JAX ``fused_attention(..., interpret=True)`` at the shapes of
``tests/test_fused_attention.py`` plus a fully masked row, and the port's
``TransformerEncoder(attention_impl="fused")`` against JAX's with the same
weights (``models/convert.py``).  Inputs are seeded numpy.

Tolerances:
  * fp32: atol and rtol 1e-5; the two sum the score and value products and
    the softmax denominator in different orders, nothing else differs.
  * bf16 inputs: within 2 bf16 ulps of the JAX value elementwise; both
    round p and o to bf16 from fp32 values that differ by those sums'
    order, which can move a rounding by one step.

The JAX test ``test_explicit_block_b_must_divide_batch`` has no
counterpart: ``block_b`` sized the TPU kernel's VMEM batch block, and the
port's kernel has none.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models.encoder import \
    TransformerEncoder as JaxEncoder
from multihop_dense_retrieval_tpu.ops.fused_attention import \
    fused_attention as jax_fused_attention
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models.convert import \
    encoder_state_dict_from_jax
from multihop_dense_retrieval_tpu_torch.models.encoder import \
    TransformerEncoder
from multihop_dense_retrieval_tpu_torch.ops import mips

# the module (ops/__init__ exports a function of the same name)
fa = importlib.import_module(
    "multihop_dense_retrieval_tpu_torch.ops.fused_attention")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(1.0, e - 8)        # 2^(floor(log2|x|) - 7)


def _inputs(b, wq, w, nh, d, seed=0, masked_row=True):
    rng = np.random.RandomState(seed)
    h = nh * d
    q, k, v = (rng.randn(b, n, h).astype(np.float32) for n in (wq, w, w))
    lens = np.arange(b) % w + max(1, w // 2)
    mask = (np.arange(w)[None] < lens[:, None]).astype(np.int32)
    if masked_row:
        mask[-1] = 0                     # a fully masked row
    return q, k, v, mask


def _run_both(q, k, v, mask, nh, dtype, bb=0):
    jdt, tdt = DTYPES[dtype]
    exp = np.asarray(jax_fused_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(mask), nh,
        interpret=True, block_b=bb).astype(jnp.float32))
    got = fa.fused_attention_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(mask), nh)
    assert got.dtype == tdt
    return got.float().numpy(), exp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,wq,w,nh,d,bb", [
    (4, 24, 24, 4, 8, 0),    # square self-attention
    (4, 1, 24, 4, 8, 0),     # cls_only last layer (q_len=1)
    (8, 16, 16, 2, 8, 2),    # the JAX test's explicit batch block
    (3, 8, 8, 2, 8, 0),      # odd batch
    (2, 16, 16, 2, 64, 0),   # JAX's head-pair kernel (2*d == 128 lanes)
    (2, 1, 16, 4, 64, 0),    # head-pair kernel, q_len=1
])
def test_plain_matches_jax_kernel(dtype, b, wq, w, nh, d, bb):
    got, exp = _run_both(*_inputs(b, wq, w, nh, d), nh, dtype, bb)
    assert got.shape == exp.shape == (b, wq, nh * d)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(got - exp) <= 2 * _bf16_ulp(exp)).all()


def test_fully_masked_row_is_uniform_not_nan():
    """A row with no attendable key: JAX's softmax over s - 1e9 (scores
    that round to -1e9 alike) is uniform, so the output is the mean of v."""
    q, k, v, mask = _inputs(2, 8, 8, 2, 8)
    got, exp = _run_both(q, k, v, mask, 2, "float32")
    np.testing.assert_allclose(got[-1], exp[-1], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[-1], np.broadcast_to(
        v[-1].mean(0), got[-1].shape), atol=1e-5, rtol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(3, 8, 8, 2, 8))
    mips.reset_launch_counts()
    got = fa.fused_attention(q, k, v, mask, 2)
    assert torch.equal(got, fa.fused_attention_plain(q, k, v, mask, 2))
    assert mips.LAUNCHES["fused_attention"] == 0


def test_wrapper_on_cuda_launches_or_raises(monkeypatch):
    """For a CUDA tensor the wrapper goes to the kernel (here the build,
    which this host cannot do) or raises on a shape the kernel does not
    take; it never hands the call to the plain version."""
    from multihop_dense_retrieval_tpu_torch.ops import _build

    loads = []

    def no_build(name):
        loads.append(name)
        raise RuntimeError("no CUDA build here")

    monkeypatch.setattr(fa, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "load", no_build)
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(3, 8, 8, 2, 8))
    with pytest.raises(RuntimeError, match="no CUDA build"):
        fa.fused_attention(q, k, v, mask, 2)
    assert loads == ["fused_attention"]
    bad = [(q[..., :12], k[..., :12], v[..., :12], mask, 1, "head dim"),
           (q.double(), k.double(), v.double(), mask, 2, "dtype"),
           (q[:, :3], k, v, mask, 2, "Wq"),
           (q, k, v, mask[:, :4], 2, "mask"),
           (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
            mask.t(), 2, "contiguous")]
    for qq, kk, vv, mm, nh, what in bad:
        with pytest.raises(ValueError, match=what):
            fa.fused_attention(qq, kk, vv, mm, nh)
    assert loads == ["fused_attention"]
    assert mips.LAUNCHES["fused_attention"] == 0


def _encoder_pair(kw, cls_only, all_hiddens=False, seed=0):
    jcfg = JaxEncoderConfig.tiny(attention_impl="fused", **kw)
    jmodel = JaxEncoder(jcfg, cls_only=cls_only,
                        return_all_hiddens=all_hiddens)
    ids0 = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids0, ids0)
    model = TransformerEncoder(
        EncoderConfig.tiny(attention_impl="fused", **kw), cls_only=cls_only,
        return_all_hiddens=all_hiddens)
    sd = encoder_state_dict_from_jax(jax.device_get(params)["params"])
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()})
    return jmodel, params, model.eval()


def _ids(b, L, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, L + 1, size=b)
    lens[0] = L
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(4, 120, size=(b, L)), 1)
    return ids.astype(np.int32), mask


WIDTHS = {"tiny": {},                                   # d = 8
          "d64": dict(hidden_size=128, num_heads=2,     # JAX's paired kernel
                      intermediate_size=256)}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("cls_only", [False, True])
def test_fused_encoder_matches_jax(width, cls_only):
    jmodel, params, model = _encoder_pair(WIDTHS[width], cls_only)
    ids, mask = _ids(5, 20, seed=3)
    exp = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == exp.shape == (5, 1 if cls_only else 20,
                                      model.config.hidden_size)
    np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)


def test_fused_encoder_all_hiddens_match_jax():
    jmodel, params, model = _encoder_pair({}, cls_only=True,
                                          all_hiddens=True)
    ids, mask = _ids(4, 12, seed=4)
    exp = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(got) == len(exp) == model.config.num_layers + 1
    for g, e in zip(got, exp):     # the last layer runs in full
        assert g.shape == e.shape == (4, 12, model.config.hidden_size)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-5)


def test_fused_encoder_on_cpu_launches_nothing():
    _, _, model = _encoder_pair({}, cls_only=True)
    ids, mask = _ids(3, 10, seed=5)
    mips.reset_launch_counts()
    with torch.no_grad():
        model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert mips.LAUNCHES["fused_attention"] == 0


def test_unported_attention_impl_raises():
    with pytest.raises(NotImplementedError, match="sdpa"):
        TransformerEncoder(EncoderConfig.tiny(attention_impl="sdpa"))
