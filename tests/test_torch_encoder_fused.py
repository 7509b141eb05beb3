"""The encoder's one-pass elementwise chains (``ops/encoder_fused.py``,
kernels 9-11) on the CPU: each plain twin is the inline arithmetic the
encoder layer ran before, bit for bit; the layer's dispatch rule (gradients
on: the plain twins; ``gelu_new`` / ``relu``: the plain activation;
``attention_impl="fused"``: kernel 8); a CUDA tensor never falls back to a
twin; the wrappers' arguments to the kernels; and the engagement counters.
The kernels themselves run in ``tests/test_torch_kernels_cuda.py``."""

import math

import pytest
import torch
import torch.nn as nn

from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
from multihop_dense_retrieval_tpu_torch.models import encoder as enc
from multihop_dense_retrieval_tpu_torch.ops import _build, mips
from multihop_dense_retrieval_tpu_torch.ops import encoder_fused as ef
from multihop_dense_retrieval_tpu_torch.utils.profiling import recorder

DTYPES = [torch.float32, torch.bfloat16]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ln(h, g, eps=1e-5):
    ln = nn.LayerNorm(h, eps=eps)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(h, generator=g))
        ln.bias.copy_(0.1 * torch.randn(h, generator=g))
    return ln


def _mask(b, w, g):
    """Ragged lengths (pad columns masked out), the last row fully masked."""
    lens = torch.randint(1, w + 1, (b,), generator=g)
    mask = (torch.arange(w)[None] < lens[:, None]).int()
    mask[-1] = 0
    return mask


# ---- the inline arithmetic the encoder layer ran before the twins ---------


def _inline_dense_bias(y, bias):
    return y + bias.to(y.dtype)


def _inline_gelu(x):
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


def _inline_softmax(raw, attn_bias, d, scores_dtype):
    dt = raw.dtype
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(dt)
    scores = raw / scale
    if scores_dtype == "bfloat16":
        scores = scores + attn_bias.to(dt)
    else:
        scores = scores.float() + attn_bias
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    return (e / e.sum(-1, keepdim=True)).to(dt)


def _inline_layer_norm(x, ln):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
    return (xf - mean) * mul + ln.bias.float()


@pytest.mark.parametrize("hidden", [768, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_gelu_twin_is_the_inline_chain(dtype, hidden):
    g = _gen(hidden)
    y = (3 * torch.randn(37, 4 * hidden, generator=g)).to(dtype)
    bias = torch.randn(4 * hidden, generator=g).to(dtype)
    exp = _inline_gelu(_inline_dense_bias(y, bias))
    assert torch.equal(ef.bias_gelu_plain(y, bias), exp)
    assert torch.equal(ef.bias_gelu(y, bias), exp)        # CPU: the twin
    assert torch.equal(enc.gelu_exact(y), _inline_gelu(y))


@pytest.mark.parametrize("lq", ["L", 1])
@pytest.mark.parametrize("scores_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [768, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_softmax_twin_is_the_inline_chain(dtype, hidden, scores_dtype,
                                                 lq):
    g = _gen(hidden + len(scores_dtype))
    b, w, d = 3, 70, 64
    nh = hidden // d
    wq = w if lq == "L" else 1
    raw = (8 * torch.randn(b, nh, wq, w, generator=g)).to(dtype)
    attn_bias = torch.where(_mask(b, w, g)[:, None, None, :].bool(), 0.0,
                            enc.NEG_INF).to(torch.float32)
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype)
    exp = _inline_softmax(raw, attn_bias, d, scores_dtype)
    got = ef.masked_softmax_plain(raw, attn_bias, scale, scores_dtype)
    assert got.dtype == dtype and torch.equal(got, exp)
    assert torch.equal(ef.masked_softmax(raw, attn_bias, scale, scores_dtype),
                       exp)
    # the fully masked row is uniform over its W keys
    assert torch.allclose(got[-1].float(), torch.full_like(got[-1].float(),
                                                           1 / w), rtol=1e-2)


@pytest.mark.parametrize("lq", ["L", 1])
@pytest.mark.parametrize("hidden", [768, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_layer_norm_twin_is_the_inline_chain(dtype, hidden, lq):
    g = _gen(hidden + 7)
    b, w = 3, 40
    x = torch.randn(b, w, hidden, generator=g).to(dtype)
    res = x if lq == "L" else x[:, :1]                    # cls_only: strided
    y = torch.randn(res.shape, generator=g).to(dtype)
    bias = torch.randn(hidden, generator=g).to(dtype)
    ln = _ln(hidden, g, eps=1e-12 if hidden == 1024 else 1e-5)
    exp = _inline_layer_norm(res + _inline_dense_bias(y, bias), ln).to(dtype)
    got = ef.add_layer_norm_plain(y, bias, res, ln)
    assert got.dtype == dtype and torch.equal(got, exp)
    assert torch.equal(ef.add_layer_norm(y, bias, res, ln), exp)
    assert torch.equal(enc.layer_norm(x, ln), _inline_layer_norm(x, ln))


# ---- the encoder layer's dispatch rule -----------------------------------


def _spy(monkeypatch, calls):
    """Wrap the encoder's names for the wrappers (and kernel 8) so that each
    call is recorded and then made."""
    for name in ("bias_gelu", "masked_softmax", "add_layer_norm",
                 "fused_attention"):
        real = getattr(enc, name)

        def spy(*a, _name=name, _real=real):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a)

        monkeypatch.setattr(enc, name, spy)


@pytest.mark.parametrize("act,impl,grad,want", [
    ("gelu", "xla", True, {}),
    ("gelu", "xla", False, {"bias_gelu": 1, "masked_softmax": 1,
                            "add_layer_norm": 2}),
    ("gelu_new", "xla", False, {"masked_softmax": 1, "add_layer_norm": 2}),
    ("relu", "xla", False, {"masked_softmax": 1, "add_layer_norm": 2}),
    ("gelu", "fused", False, {"bias_gelu": 1, "fused_attention": 1,
                              "add_layer_norm": 2}),
    ("gelu", "fused", True, {"fused_attention": 1}),
])
@pytest.mark.parametrize("cls_only", [False, True])
def test_encoder_layer_dispatch(monkeypatch, act, impl, grad, want, cls_only):
    """Each layer call takes each wrapper the rule gives it, once a layer
    (add_layer_norm twice), cls_only's last layer too, and computes the
    same vectors as the plain composition (on the CPU every wrapper runs
    its twin, so bit for bit)."""
    cfg = EncoderConfig.tiny(hidden_act=act, attention_impl=impl,
                             dtype="bfloat16")
    torch.manual_seed(0)
    model = MhopRetriever(cfg, cls_only=cls_only).eval()
    g = _gen(1)
    ids = torch.randint(4, 120, (3, 17), generator=g)
    mask = _mask(3, 17, g)
    with torch.no_grad():
        plain = model.encode_seq(ids, mask)
    calls = {}
    _spy(monkeypatch, calls)
    with torch.set_grad_enabled(grad):
        got = model.encode_seq(ids, mask)
    assert calls == {k: n * cfg.num_layers for k, n in want.items()}
    assert torch.equal(got.detach(), plain)


# ---- a CUDA tensor never falls back ---------------------------------------


def _calls(y, bias, res, ln, raw, attn_bias, scale):
    return [("bias_gelu", lambda: ef.bias_gelu(y, bias)),
            ("masked_softmax",
             lambda: ef.masked_softmax(raw, attn_bias, scale, "float32")),
            ("add_layer_norm", lambda: ef.add_layer_norm(y, bias, res, ln))]


def _small(dtype=torch.bfloat16, h=64, w=10):
    g = _gen(3)
    y = torch.randn(2, w, h, generator=g).to(dtype)
    bias = torch.randn(h, generator=g).to(dtype)
    ln = _ln(h, g)
    raw = torch.randn(2, 2, w, w, generator=g).to(dtype)
    attn_bias = torch.where(_mask(2, w, g)[:, None, None, :].bool(), 0.0,
                            enc.NEG_INF).to(torch.float32)
    scale = torch.tensor(8.0).to(dtype)
    return y, bias, y.clone(), ln, raw, attn_bias, scale


def test_wrappers_on_cuda_build_or_raise(monkeypatch, tmp_path):
    """With the kernel library missing and no nvcc, a CUDA input raises
    from the build; the wrapper never returns its twin's result.  Inputs
    the kernels do not take raise before the build."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ef, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    args = _small()
    mips.reset_launch_counts()
    for name, call in _calls(*args):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
        assert mips.LAUNCHES[name] == 0
    y, bias, res, ln, raw, attn_bias, scale = args
    bad = [(lambda: ef.bias_gelu(y.double(), bias), "dtype"),
           (lambda: ef.bias_gelu(y.transpose(0, 1), bias), "contiguous"),
           (lambda: ef.bias_gelu(y, bias[:5]), "bias"),
           (lambda: ef.masked_softmax(raw[0], attn_bias, scale, "float32"),
            "contiguous"),
           (lambda: ef.masked_softmax(raw, attn_bias[:1], scale, "float32"),
            "attn_bias"),
           (lambda: ef.masked_softmax(torch.zeros(1, 1, 1, 600,
                                                  dtype=torch.bfloat16),
                                      attn_bias[:1, :, :, :1].expand(
                                          1, 1, 1, 600).contiguous(),
                                      scale, "float32"), "exceed"),
           (lambda: ef.add_layer_norm(y, bias, res[:, :1], ln), "res"),
           (lambda: ef.add_layer_norm(
               torch.zeros(2, 1040, dtype=torch.bfloat16),
               torch.zeros(1040, dtype=torch.bfloat16),
               torch.zeros(2, 1040, dtype=torch.bfloat16),
               nn.LayerNorm(1040)), "exceeds")]
    for call, what in bad:
        with pytest.raises(ValueError, match=what):
            call()


class _Lib:
    """Stands in for the loaded library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(ef, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ef, "_stream", lambda: 0)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    mips.reset_launch_counts()
    yield lib
    mips.reset_launch_counts()


@pytest.mark.parametrize("dtype,h,vec", [(torch.bfloat16, 768, 8),
                                         (torch.float32, 768, 4),
                                         (torch.bfloat16, 36, 1),
                                         (torch.float32, 1024, 4)])
@pytest.mark.parametrize("cls_only", [False, True])
def test_wrappers_pass_the_kernels_their_arguments(fake_card, dtype, h, vec,
                                                   cls_only):
    """Rows, widths, 16-byte packs where the width allows them, the
    residual's row stride (cls_only: x[:, :1] read in place, L * H apart),
    the rows that share a mask-bias row, the scale's fp32 reciprocal, the
    bf16-score flag, 1 / N and eps."""
    g = _gen(4)
    b, w, nh = 3, 20, 4
    x = torch.randn(b, w, h, generator=g).to(dtype)
    res = x[:, :1] if cls_only else x
    lq = res.shape[1]
    y = torch.randn(res.shape, generator=g).to(dtype)
    bias = torch.randn(h, generator=g).to(dtype)
    ln = _ln(h, g, eps=1e-12)
    scale = torch.tensor(math.sqrt(32), dtype=torch.float32).to(dtype)
    raw = torch.randn(b, nh, lq, w, generator=g).to(dtype)
    attn_bias = torch.zeros(b, 1, 1, w)
    ef.bias_gelu(y, bias)
    for sd in ("float32", "bfloat16"):
        ef.masked_softmax(raw, attn_bias, scale, sd)
    ef.add_layer_norm(y, bias, res, ln)
    code = mips._FLOAT_CODES[dtype]
    (f1, a1), (f2, a2), (f3, a3), (f4, a4) = fake_card.calls
    assert (f1, a1[:2], a1[5:7]) == ("bias_gelu", (code, vec), (b * lq, h))
    inv = torch.tensor(1.0) / scale.float()
    for f, a in ((f2, a2), (f3, a3)):
        assert f == "masked_softmax"
        assert a[0] == code and a[5:8] == (b * nh * lq, nh * lq, w)
        assert a[8] == float(inv)          # the fp32 reciprocal
    assert (a2[1], a3[1]) == (0, 1)
    assert f4 == "add_layer_norm" and a4[:2] == (code, vec)
    assert a4[5] == (w * h if cls_only else h)
    assert a4[9:11] == (b * lq, h) and a4[12] == 1e-12
    assert a4[11] == float(torch.tensor(1.0) / h)
    assert {k: mips.LAUNCHES[k] for k in ("bias_gelu", "masked_softmax",
                                          "add_layer_norm")} == {
        "bias_gelu": 1, "masked_softmax": 2, "add_layer_norm": 1}


def test_a_forward_launches_each_kernel_once_a_layer(fake_card):
    """A retriever forward with gradients off on the (stand-in) card:
    kernels 9 and 10 once a layer, kernel 11 twice a layer, cls_only's
    last layer included."""
    cfg = EncoderConfig.tiny(dtype="bfloat16", num_layers=3)
    torch.manual_seed(0)
    model = MhopRetriever(cfg, cls_only=True).eval()
    g = _gen(5)
    with torch.no_grad():
        model.encode_seq(torch.randint(4, 120, (2, 9), generator=g),
                         torch.ones(2, 9, dtype=torch.int32))
    names = [f for f, _ in fake_card.calls]
    assert names == ["masked_softmax", "add_layer_norm", "bias_gelu",
                     "add_layer_norm"] * 3


def test_score_scale_is_made_once_and_serves_autograd():
    """The scores' divisor is made once for each head size and dtype, and
    outside inference mode: a forward with gradients on after one under
    ``torch.inference_mode`` differentiates through it."""
    cfg = EncoderConfig.tiny(num_layers=2)
    torch.manual_seed(0)
    model = MhopRetriever(cfg)
    g = _gen(7)
    ids = torch.randint(4, 120, (2, 9), generator=g)
    mask = torch.ones(2, 9, dtype=torch.int32)
    enc._score_scale.cache_clear()
    with torch.inference_mode():
        model.encode_seq(ids, mask)
    model.encode_seq(ids, mask).sum().backward()
    assert enc._score_scale.cache_info().misses == 1
    assert model.encoder.encoder.layer[0].attention.self.query.weight.grad \
        is not None


# ---- engagement counters ---------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
def test_layer_counters_count_each_call_while_recording(grad):
    """One count a layer call while a recorder is on (on the CPU every
    layer is plain: the kernels did not run), nothing while none is."""
    cfg = EncoderConfig.tiny(num_layers=3)
    torch.manual_seed(0)
    model = MhopRetriever(cfg, cls_only=True).eval()
    g = _gen(6)
    ids = torch.randint(4, 120, (2, 9), generator=g)
    mask = torch.ones(2, 9, dtype=torch.int32)
    with torch.set_grad_enabled(grad):
        with recorder() as timers:
            model.encode_seq(ids, mask)
            model.encode_seq(ids, mask)
        model.encode_seq(ids, mask)
    assert dict(timers.counters) == {"encoder.layers_plain": 6}
