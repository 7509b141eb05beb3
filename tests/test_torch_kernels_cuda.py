"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path does not reach (ragged query tiles, every
k, masked tails, fp32 rows).  These need a GPU and skip without one; run
them there with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: the suite's conftest configures JAX, which the GPU host
lacks).

Tolerances: int8 results bit-equal; bf16/fp32 values to 1e-4 absolute
(fp32 sums in another order) with ids equal — the inputs are integers
scaled so that no two scores tie within that tolerance.
"""

import pytest
import torch

from multihop_dense_retrieval_tpu_torch.ops import mips

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("b,n,k,n_valid", [(1, 640, 1, None),
                                           (70, 5000, 3, 4321),
                                           (129, 20480, 7, 20000),
                                           (8, 300, 6, 4)])
def test_int8_scan_matches_plain(dev, b, n, k, n_valid):
    g = _gen(dev, b + n)
    idx = torch.randint(-127, 128, (n, 128), device=dev, generator=g,
                        dtype=torch.int8)
    idx[n // 2] = idx[1]
    dsc = torch.rand(n, device=dev, generator=g) + 0.01
    dsc[n // 2] = dsc[1]
    qi, qs = mips.quantize_rows(torch.randn(b, 128, device=dev, generator=g))
    kv, ki = mips.mips_scan_int8(qi, qs, idx, dsc, k, n_valid)
    pv, pi = mips.mips_scan_int8_plain(qi, qs, idx, dsc, k, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,k", [(5, 1000, 1), (64, 4096, 4), (100, 3000, 7)])
def test_float_scan_matches_plain(dev, dtype, b, n, k):
    g = _gen(dev, n)
    # small integers: bf16/fp32 products and sums are exact, so the
    # kernel and the plain version agree exactly whatever their order
    idx = torch.randint(-8, 9, (n, 64), device=dev, generator=g).to(dtype)
    q = torch.randint(-8, 9, (b, 64), device=dev, generator=g).float()
    kv, ki = mips.mips_scan(q, idx, k, n - 7)
    pv, pi = mips.mips_scan_plain(q, idx, k, n - 7)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("b,n,r,n_valid", [(3, 1024, 32, None),
                                           (70, 8192, 128, 8000)])
def test_pca_chunk_max_matches_plain(dev, b, n, r, n_valid):
    g = _gen(dev, b)
    proj = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    qp = torch.randn(b, r, device=dev, generator=g).to(torch.bfloat16)
    got = mips.pca_chunk_max(qp, proj, 512, n_valid)
    exp = mips.pca_chunk_max_plain(qp, proj, 512, n_valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,d,n_valid", [(5, 64, None), (33, 768, 3000)])
def test_pca_rescan_int8_matches_plain(dev, b, d, n_valid):
    g = _gen(dev, d)
    n, cand, kc = 4096, 128, 3
    idx = torch.randint(-127, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    dsc = torch.rand(n, device=dev, generator=g)
    qi, _ = mips.quantize_rows(torch.randn(b, d, device=dev, generator=g))
    ids = torch.randint(0, n // cand, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    got = mips.pca_rescan_int8(ids, qi, idx, dsc, cand, n_valid)
    exp = mips.pca_rescan_plain(ids, qi, idx, dsc, cand, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


def test_unported_cuda_paths_raise(dev):
    idx = torch.zeros(4096, 64, device=dev, dtype=torch.bfloat16)
    q = torch.zeros(4, 64, device=dev)
    with pytest.raises(NotImplementedError):
        mips.mips_topk(idx, q, 8)
    with pytest.raises(NotImplementedError):
        mips.mips_topk_pca(idx, torch.zeros(4096, 16, device=dev,
                                            dtype=torch.bfloat16),
                           torch.zeros(64, 16, device=dev),
                           torch.zeros(4, 8, device=dev), q, 1, k_chunks=2)


def test_mips_topk_pca_on_card_matches_cpu(dev):
    """The whole PCA tier (kernels 3 and 4 plus the torch glue) on the card
    against the same function on the CPU: certificates equal, and every
    certified query has the exact int8 scan's top row."""
    g = torch.Generator().manual_seed(5)
    n, d, r, cand, b = 8192, 64, 32, 128, 24
    basis = torch.linalg.qr(torch.randn(d, d, generator=g))[0][:, :8]
    emb = (torch.randn(n, 8, generator=g) * torch.linspace(3, 0.8, 8)
           ) @ basis.t() + 0.05 * torch.randn(n, d, generator=g)
    rot = torch.from_numpy(mips.train_pca_rotation(emb[:2048].numpy(), r))
    qi, sc = mips.quantize_rows(emb)
    proj, bounds = mips.build_pca_prefilter(emb.numpy(), rot.numpy(),
                                            cand_rows=cand,
                                            scales=sc.numpy())
    proj = torch.from_numpy(proj).to(torch.bfloat16)
    bounds = torch.from_numpy(bounds)
    q = emb[torch.randperm(n, generator=g)[:b]] \
        + 0.05 * torch.randn(b, d, generator=g)
    args = (qi, proj, rot, bounds, q)
    cpu = mips.mips_topk_pca(*args, 1, k_chunks=4, cand_rows=cand,
                             n_valid=n - 50, doc_scales=sc)
    gpu = mips.mips_topk_pca(*(a.to(dev) for a in args), 1, k_chunks=4,
                             cand_rows=cand, n_valid=n - 50,
                             doc_scales=sc.to(dev))
    exact = mips.mips_topk(qi, q, 1, n_valid=n - 50, doc_scales=sc)
    cert = gpu[2].cpu()
    assert torch.equal(cert, cpu[2]) and cert.float().mean() >= 0.5
    assert torch.equal(gpu[1].cpu()[cert], exact[1][cert])
    # (raw*dsc)*q_scale in the rescan vs (raw*q_scale)*dsc in the scan:
    # the two orders differ by at most an ulp
    torch.testing.assert_close(gpu[0].cpu()[cert], exact[0][cert],
                               rtol=1e-6, atol=0)
