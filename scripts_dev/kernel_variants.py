"""Where the H100 port's tensor-core kernels spend their time.

Builds variants of ``ops/csrc/fused_attention.cu``,
``ops/csrc/chunk_max_mma.cu``, ``ops/csrc/mips_scan_mma.cu`` and
``ops/csrc/mips_scan_i8.cu`` by text substitution, and times each against
the source as it stands, in one process on one card (CUDA events, best of
two runs of 20 launches).
Sections (all by default; name some on the command line to run those):

attention: kernel 8's tensor-core template at (B, W) =
(256, 300), (192, 350), (192, 40), (64, 514), 12 heads of 64, bf16:
  ieee    __fdiv_rn(e, l) in place of div_rn (the IEEE division with its
          per-call reciprocal and slow-path branch)
  mul     e * l (wrong: the cost of the division itself)
  noexp3  pass 3 without its expf (wrong: the cost of recomputing e)
  nop2    no pass 2 (wrong: the cost of the row sums)
each with 8 and 4 warps a block; variants whose output differs from the
tree's say so.
chunk: kernel 6 at B = 100, 200, 384 over a 262,144 x 768 bf16 index in
2048-row chunks, KS x STAGES in (32, 4), (64, 3), (64, 4).
scan: kernel 2 at (B, N, k) = (192, 1M, 1), (192, 1M, 8) and (100, 262,144,
2), D = 768: the tree, "raw" (the tensor-core sums returned without the
fp32 rescoring: its time, and its largest relative difference from the
plain scan beside the tree's), "nofold" (no top-k fold: the main loop
alone, wrong output) and query tiles of 64 and 128 in place of the plan's.
pca: kernel 3 at (B, N) = (192, 1M) and (200, 262,144), R = 128, 512-row
chunks: the plan (resident queries, several chunks a block), resident
queries one chunk a block, and the streamed template (kernel 6's) one
chunk a block (launch arguments of the tree).
int8: kernel 1 at (B, N, k) = (192, 1M, 1) and (192, 1M, 2), D = 768: the
tree and "nofold" (no top-k fold: the main loop alone, wrong output);
kernel 7 at (384, 1M, 768,
2048-row chunks): the plan (resident queries, 8 chunks a block), resident
queries one chunk a block, streamed queries one chunk a block, and
"nofold" (no max fold, wrong output).  Every variant that should be right
is held bit-equal to the plain twin.
rescan: kernels 5 and 4 on their tensor-core template (rescan_mma.cu)
against the SIMT template (two_phase.cu's rescan, the kernel both ran on
before) on the same inputs, in turns (simt, plan, plan, simt), at leg c1's
shape (bf16, B=200, 20 of 128 chunks of 2048 rows, D=768), c2's (bf16,
B=200, 16 of 512 chunks of 512), leg a's (int8, B=192, 8 of 2048 chunks of
512 over 1M rows) and leg d's (int8, B=384, 20 of 512 chunks of 2048),
these two once with distinct random chunks and once with every query's
first chunk the same (as the legs' planted rows make it), and a shape with
few chunks (bf16, B=200, 8 of 16 chunks of 2048, where the plan splits
rows); beside them the template with other row splits (one block a chunk,
512, 256 and 128 rows a block), query tiles of 32, 64 and 96 slots, one,
two and four blocks sharing a row range's query tiles, and "nostore" (the epilogue's stores off: what they cost, wrong output).  int8
held bit-equal to the plain twin, bf16 within 1e-3.
parent (with --parent DIR, an unpacked earlier commit whose kernels 2, 3
and 6 have the tree's entry points): DIR's mips_scan_mma.cu and
chunk_max_mma.cu, built against DIR's headers, against the tree's, in
turns (parent, tree, tree, parent), at kernel 2's record shape (192, 1M,
768, k=1), kernel 3's (192, 1M, R=128, 512-row chunks) and kernel 6's
(200, 262,144, 768, 2048-row chunks).

Needs a GPU and nvcc; run from the repository root:
    python3 scripts_dev/kernel_variants.py [attention] [chunk] [scan] [pca]
        [int8] [rescan] [parent --parent DIR]
"""

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from multihop_dense_retrieval_tpu_torch.ops import _build, mips  # noqa: E402

fa = importlib.import_module(
    "multihop_dense_retrieval_tpu_torch.ops.fused_attention")
NH, D, NF, CHUNK = 12, 768, 1 << 18, 2048
ATTN_SRC = (_build.CSRC / "fused_attention.cu").read_text()
CMAX_SRC = (_build.CSRC / "chunk_max_mma.cu").read_text()
SCAN_SRC = (_build.CSRC / "mips_scan_mma.cu").read_text()
I8_SCAN_SRC = (_build.CSRC / "mips_scan_i8.cu").read_text()
I8_CMAX_SRC = (_build.CSRC / "chunk_max_i8.cu").read_text()
RESCAN_SRC = (_build.CSRC / "rescan_mma.cu").read_text()
DIV = re.compile(r"div_rn\(expf\(([^()]*)\), (l[01]), r[01]\)")


def attention_variant(name):
    if name == "tree":
        return ATTN_SRC
    if name == "ieee":
        return DIV.sub(lambda m: f"__fdiv_rn(expf({m[1]}), {m[2]})", ATTN_SRC)
    if name == "mul":
        return DIV.sub(lambda m: f"__fmul_rn(expf({m[1]}), {m[2]})", ATTN_SRC)
    if name == "noexp3":
        return DIV.sub(lambda m: f"div_rn({m[1]}, {m[2]}, r{m[2][1]})",
                       ATTN_SRC)
    assert name == "nop2"
    return ATTN_SRC.replace("  if (live) {\n    for (int k0 = 0; k0 < nstrips",
                            "  if (false) {\n    for (int k0 = 0; k0 < nstrips")


def chunk_variant(ks, stages):
    src = re.sub(r"constexpr int KS = \d+;", f"constexpr int KS = {ks};",
                 CMAX_SRC)
    return re.sub(r"constexpr int STAGES = \d+;",
                  f"constexpr int STAGES = {stages};", src)


def scan_variant(name):
    if name == "tree":
        return SCAN_SRC
    if name == "raw":
        out = SCAN_SRC.replace("constexpr bool RESCORE = true;",
                               "constexpr bool RESCORE = false;")
    else:
        assert name == "nofold"
        out = SCAN_SRC.replace("if (ok) push<KMAX>(", "if (false) push<KMAX>(")
    assert out != SCAN_SRC, name
    return out


def nofold(src):
    """`src` with its per-tile fold (the one `if (ok)`) switched off (wrong
    output: the cost of the main loop alone)."""
    assert src.count("if (ok)") == 1
    return src.replace("if (ok)", "if (false)")


def build_all(sources, tmp):
    """{name: CDLL}, one nvcc per variant, all started together; a source
    is (text, entry point[, its header directory])."""
    procs = []
    for name, (src, entry, *inc) in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(tmp, f"lib{name}.so")
        hdrs = inc[0] if inc else str(_build.CSRC)
        procs.append((name, entry, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", hdrs, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, entry, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(lib)
        fn = getattr(libs[name], entry)
        fn.argtypes, fn.restype = _build.SIGNATURES[entry][entry]
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def best_ms(fn):
    return min(cs.cuda_ms(fn, 20) for _ in range(2))


ATTN_NAMES = ("tree", "ieee", "mul", "noexp3", "nop2")
CHUNK_CFGS = ((32, 4), (64, 3), (64, 4))
SCAN_NAMES = ("tree", "raw", "nofold")
SECTIONS = ("attention", "chunk", "scan", "pca", "int8", "rescan", "parent")


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", choices=SECTIONS)
    ap.add_argument("--parent", help="an unpacked earlier commit whose "
                    "kernels 2, 3 and 6 are timed beside the tree's")
    args = ap.parse_args()
    run = set(args.sections) or set(SECTIONS) - {"parent"}
    if args.parent:
        run.add("parent")
    assert "parent" not in run or args.parent, "parent needs --parent DIR"
    print(cs.nvidia_smi(), flush=True)
    sources = {}
    if "attention" in run:
        sources.update({f"attn_{n}": (attention_variant(n), "fused_attention")
                        for n in ATTN_NAMES})
    if "chunk" in run:
        sources.update({f"cmax_{ks}_{st}": (chunk_variant(ks, st),
                                            "chunk_max_mma")
                        for ks, st in CHUNK_CFGS})
    if "scan" in run:
        sources.update({f"scan_{n}": (scan_variant(n), "mips_scan_mma")
                        for n in SCAN_NAMES})
    if "pca" in run or "parent" in run:
        sources["cmax_tree"] = (CMAX_SRC, "chunk_max_mma")
    if "int8" in run:
        sources["i8scan_tree"] = (I8_SCAN_SRC, "mips_scan_i8")
        sources["i8scan_nofold"] = (nofold(I8_SCAN_SRC),
                                    "mips_scan_i8")
        sources["i8cmax_tree"] = (I8_CMAX_SRC, "chunk_max_i8")
        sources["i8cmax_nofold"] = (nofold(I8_CMAX_SRC),
                                    "chunk_max_i8")
    if "rescan" in run:
        sources["rescan_tree"] = (RESCAN_SRC, "rescan_mma")
        nostore = RESCAN_SRC.replace("if (j < active && my_slot[j][e] >= 0)",
                                     "if (false)")
        assert nostore != RESCAN_SRC
        sources["rescan_nostore"] = (nostore, "rescan_mma")
    if "parent" in run:
        csrc = os.path.join(args.parent,
                            "multihop_dense_retrieval_tpu_torch/ops/csrc")
        sources["scan_tree"] = (SCAN_SRC, "mips_scan_mma")
        for name, entry in (("scan", "mips_scan_mma"),
                            ("cmax", "chunk_max_mma")):
            with open(os.path.join(csrc, f"{entry}.cu")) as f:
                sources[f"{name}_parent"] = (f.read(), entry, csrc)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(sources, tmp)
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        if "attention" in run:
            time_attention(libs, dev, gen)
        if "chunk" in run:
            time_chunk_max(libs, dev, gen)
        if "scan" in run:
            time_scan(libs, dev, gen)
        if "pca" in run:
            time_pca(libs, dev, gen)
        if "int8" in run:
            time_int8(libs, dev, gen)
        if "rescan" in run:
            time_rescan(libs, dev, gen)
        if "parent" in run:
            time_parent(libs, dev, gen)
    return 0


def time_attention(libs, dev, gen):
    for b, w in ((256, 300), (192, 350), (192, 40), (64, 514)):
        q, k, v, mask = cs.attention_inputs(dev, gen, b, w, w,
                                            torch.bfloat16)
        mask = mask.to(torch.int32).contiguous()
        plan = fa.attention_plan(b, w, w, NH, D // NH, torch.bfloat16)

        def call(name, warps, out):
            rc = libs[f"attn_{name}"].fused_attention(
                1, warps, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr(), b, w, w, NH, D // NH, fa._scale(D // NH),
                plan["smem"], out.data_ptr(), stream())
            assert rc == 0, (name, rc)

        ref = torch.empty_like(q)
        call("tree", plan["warps"], ref)
        row = []
        for name in ATTN_NAMES:
            for warps in (8, 4):
                out = torch.empty_like(q)
                call(name, warps, out)
                torch.cuda.synchronize()
                same = "" if torch.equal(out, ref) else " (differs)"
                ms = best_ms(lambda: call(name, warps, out))
                row.append(f"{name}/{warps}w {ms:.4f}{same}")
        print(f"kernel 8 B={b} W={w} (plan: {plan['warps']} warps), ms: "
              + ", ".join(row), flush=True)


def time_chunk_max(libs, dev, gen):
    idx = torch.randn(NF, D, device=dev, generator=gen).to(torch.bfloat16)
    for b in (100, 200, 384):
        qb = torch.randn(b, D, device=dev, generator=gen).to(torch.bfloat16)
        plan = mips.chunk_max_plan(b, NF, D, CHUNK, torch.bfloat16,
                                   mips._sms(dev))
        qn = plan["q_tile"]
        assert not plan["q_resident"]
        ref = mips.chunk_max(qb, idx, CHUNK, NF - 1000)
        row = []
        for ks, st in CHUNK_CFGS:
            out = torch.empty(b, NF // CHUNK, device=dev)
            smem = st * (128 + qn) * (ks + 8) * 2 + 2 * qn * 4

            def call():
                rc = libs[f"cmax_{ks}_{st}"].chunk_max_mma(
                    qb.data_ptr(), idx.data_ptr(), b, NF, NF - 1000, D, CHUNK,
                    qn, smem, plan["per_block"], 0, out.data_ptr(), stream())
                assert rc == 0, (ks, st, rc)
            call()
            torch.cuda.synchronize()
            same = "" if torch.equal(out, ref) else " (differs)"
            row.append(f"KS={ks}/{st} stages {best_ms(call):.4f}{same}")
        print(f"kernel 6 B={b} (q_tile {qn}), ms: " + ", ".join(row),
              flush=True)


def time_scan(libs, dev, gen):
    n_big, sms = 1 << 20, mips._sms(dev)
    idx = torch.randn(n_big, D, device=dev, generator=gen).to(torch.bfloat16)
    for b, n, k in ((192, n_big, 1), (192, n_big, 8), (100, NF, 2)):
        qb = torch.randn(b, D, device=dev, generator=gen).to(torch.bfloat16)
        rows = idx[:n]
        pv, _ = mips.mips_scan_plain(qb, rows, k, n - 1000)
        plan = mips.scan_plan(b, n, D, torch.bfloat16, k, sms)
        kmax = plan["kmax"]
        runs = [(name, plan["q_tile"]) for name in SCAN_NAMES]
        runs += [("tree", t) for t in (128, 64)
                 if t < plan["q_tile"] and t <= mips._SCAN_QMAX[kmax]]
        row = []
        for name, q_tile in runs:
            rps, splits = mips._splits(n, sms // -(-b // q_tile))
            smem = 4 * (128 + q_tile) * 72 * 2 + 2 * q_tile * kmax * 8
            pv_ = torch.empty(b, splits, kmax, device=dev)
            pi_ = torch.empty(b, splits, kmax, device=dev, dtype=torch.int32)
            ov = torch.empty(b, k, device=dev)
            oi = torch.empty(b, k, device=dev, dtype=torch.int32)

            def call():
                rc = libs[f"scan_{name}"].mips_scan_mma(
                    qb.data_ptr(), rows.data_ptr(), b, n, n - 1000, D, k, kmax,
                    q_tile, rps, splits, smem, pv_.data_ptr(), pi_.data_ptr(),
                    ov.data_ptr(), oi.data_ptr(), stream())
                assert rc == 0, (name, q_tile, rc)
            call()
            torch.cuda.synchronize()
            rel = ((ov - pv).abs() / pv.abs()).max().item()
            row.append(f"{name}/q{q_tile} {best_ms(call):.4f} "
                       f"(max rel {rel:.3g})")
        print(f"kernel 2 B={b} N={n} k={k} (plan: q_tile {plan['q_tile']}, "
              f"{plan['splits']} splits), ms: " + ", ".join(row), flush=True)


def time_pca(libs, dev, gen):
    r, cand, n_big = 128, 512, 1 << 20
    proj = torch.randn(n_big, r, device=dev, generator=gen).to(torch.bfloat16)
    for b, n in ((192, n_big), (200, NF)):
        qp = torch.randn(b, r, device=dev, generator=gen).to(torch.bfloat16)
        rows = proj[:n]
        plan = mips.chunk_max_plan(b, n, r, cand, torch.bfloat16,
                                   mips._sms(dev))
        ref = mips.pca_chunk_max(qp, rows, cand, n - 1000)
        qn, row = plan["q_tile"], []
        for per_block, qres in ((plan["per_block"], 1), (1, 1), (1, 0)):
            smem = (4 * (128 + (0 if qres else qn)) * 72
                    + (qn * (r + 8) if qres else 0)) * 2 + 2 * qn * 4
            out = torch.empty(b, n // cand, device=dev)

            def call():
                rc = libs["cmax_tree"].chunk_max_mma(
                    qp.data_ptr(), rows.data_ptr(), b, n, n - 1000, r,
                    cand, qn, smem, per_block, qres, out.data_ptr(),
                    stream())
                assert rc == 0, (per_block, qres, rc)
            call()
            torch.cuda.synchronize()
            same = "" if torch.equal(out, ref) else " (differs)"
            row.append(f"{per_block} chunks a block/"
                       f"{'resident' if qres else 'streamed'} queries "
                       f"{best_ms(call):.4f}{same}")
        print(f"kernel 3 B={b} N={n} (plan: q_tile {qn}, {plan['per_block']} "
              f"chunks a block), ms: " + ", ".join(row), flush=True)


def time_int8(libs, dev, gen):
    n, sms = 1 << 20, mips._sms(dev)
    idx = torch.randint(-127, 128, (n, D), device=dev, generator=gen,
                        dtype=torch.int8)
    dsc = torch.rand(n, device=dev, generator=gen) * 0.02 + 1e-3
    nv = n - 1000
    for k in (1, 2):
        qi, qs = mips.quantize_rows(torch.randn(192, D, device=dev,
                                                generator=gen))
        pv, pi = mips.mips_scan_int8_plain(qi, qs, idx, dsc, k, nv)
        plan = mips.scan_plan(192, n, D, torch.int8, k, sms)
        kmax, qn, splits = plan["kmax"], plan["q_tile"], plan["splits"]
        row = []
        for name in ("tree", "nofold"):
            part_v = torch.empty(192, splits, kmax, device=dev)
            part_i = torch.empty(192, splits, kmax, device=dev,
                                 dtype=torch.int32)
            ov = torch.empty(192, k, device=dev)
            oi = torch.empty(192, k, device=dev, dtype=torch.int32)

            def call():
                rc = libs[f"i8scan_{name}"].mips_scan_i8(
                    qi.data_ptr(), qs.data_ptr(), idx.data_ptr(),
                    dsc.data_ptr(), 192, n, nv, D, k, kmax, qn,
                    plan["rows_per_split"], splits, plan["smem"],
                    part_v.data_ptr(), part_i.data_ptr(), ov.data_ptr(),
                    oi.data_ptr(), stream())
                assert rc == 0, (name, rc)
            call()
            torch.cuda.synchronize()
            same = torch.equal(ov, pv) and torch.equal(oi, pi)
            assert same or name == "nofold", name
            row.append(f"{name} {best_ms(call):.4f}"
                       f"{'' if same else ' (wrong)'}")
        print(f"kernel 1 B=192 N={n} k={k} (plan: q_tile {qn}, {splits} "
              f"splits), ms: " + ", ".join(row), flush=True)
    q8, _ = mips.quantize_rows(torch.randn(384, D, device=dev, generator=gen))
    ref = mips.chunk_max_plain(q8, idx, CHUNK, nv, dsc)
    plan = mips.chunk_max_plan(384, n, D, CHUNK, torch.int8, sms)
    qn, row = plan["q_tile"], []
    for name, per_block, res in (("tree", plan["per_block"], 1),
                                 ("tree", 1, 1), ("tree", 1, 0),
                                 ("nofold", plan["per_block"], 1)):
        out = torch.empty(384, n // CHUNK, device=dev)

        def call():
            rc = libs[f"i8cmax_{name}"].chunk_max_i8(
                q8.data_ptr(), idx.data_ptr(), dsc.data_ptr(), 384, n, nv, D,
                CHUNK, qn, mips._i8_smem(qn, D, bool(res), True), per_block,
                res, out.data_ptr(), stream())
            assert rc == 0, (name, per_block, res, rc)
        call()
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        assert same or name == "nofold", (name, per_block, res)
        row.append(f"{name}/{per_block} chunks a block/"
                   f"{'resident' if res else 'streamed'} {best_ms(call):.4f}"
                   f"{'' if same else ' (wrong)'}")
    print(f"kernel 7 B=384 N={n} C={CHUNK} (plan: q_tile {qn}, "
          f"{plan['per_block']} chunks a block), ms: " + ", ".join(row),
          flush=True)


def time_rescan(libs, dev, gen):
    sms, simt = mips._sms(dev), _build.load("two_phase")
    n8, nf = 1 << 20, NF
    idx8 = torch.randint(-127, 128, (n8, D), device=dev, generator=gen,
                         dtype=torch.int8)
    dsc = torch.rand(n8, device=dev, generator=gen) * 0.02 + 1e-3
    idxb = torch.randn(nf, D, device=dev, generator=gen).to(torch.bfloat16)
    cases = (("c1", idxb, None, 200, 2048, 20, False),
             ("c2", idxb, None, 200, 512, 16, False),
             ("leg a", idx8, dsc, 192, 512, 8, False),
             ("leg a, planted", idx8, dsc, 192, 512, 8, True),
             ("leg d", idx8, dsc, 384, 2048, 20, False),
             ("leg d, planted", idx8, dsc, 384, 2048, 20, True),
             ("few chunks", idxb[:1 << 15], None, 200, 2048, 8, False))
    for what, idx, sc, b, cand, kc, planted in cases:
        n, int8 = idx.shape[0], sc is not None
        q32 = torch.randn(b, D, device=dev, generator=gen)
        q = mips.quantize_rows(q32)[0] if int8 else q32.to(torch.bfloat16)
        ids = torch.stack([torch.randperm(n // cand, device=dev,
                                          generator=gen)[:kc]
                           for _ in range(b)]).to(torch.int32)
        if planted:
            ids[:, 0] = n // cand // 3
        nv = n - 1000
        ref = mips.rescan_plain(ids, q, idx, sc, cand, nv)
        plan = mips.rescan_plan(b, kc, n, cand, D, idx.dtype, sms)
        out = torch.empty(b, kc * cand, device=dev)
        code = 0 if int8 else 1

        def mma(q_tile, rows, groups=1, lib="rescan_tree"):
            return lambda: libs[lib].rescan_mma(
                code, ids.data_ptr(), q.data_ptr(), idx.data_ptr(),
                sc.data_ptr() if int8 else None, b, kc, n, nv, D, cand,
                q_tile, rows, -(-cand // rows), groups,
                mips._rescan_smem(q_tile, D * idx.element_size(), int8),
                out.data_ptr(), stream())

        def simt_call():
            return simt.rescan(code, ids.data_ptr(), q.data_ptr(),
                               idx.data_ptr(), sc.data_ptr() if int8 else None,
                               b, kc, D * idx.element_size() // 4, cand, nv,
                               out.data_ptr(), stream())

        def run(fn, must_match=True):
            out.fill_(float("nan"))
            assert fn() == 0
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = torch.equal(out, ref) if int8 else err <= 1e-3
            assert ok or not must_match, (what, err)
            return best_ms(fn), ok

        plan_call = mma(plan["q_tile"], plan["rows_per_split"],
                        plan["groups"])
        times = {"simt": [], "plan": []}
        for name in ("simt", "plan", "plan", "simt"):
            times[name].append(run(simt_call if name == "simt"
                                   else plan_call)[0])
        row = [f"simt {times['simt'][0]:.4f} / {times['simt'][1]:.4f}",
               f"plan {times['plan'][0]:.4f} / {times['plan'][1]:.4f}"]
        qt, rs, gs = plan["q_tile"], plan["rows_per_split"], plan["groups"]
        variants = [(f"{r}-row split", qt, r, gs)
                    for r in (cand, 512, 256, 128) if r <= cand]
        variants += [(f"q_tile {t}", t, rs, gs) for t in (32, 64, 96)
                     if mips._rescan_smem(t, D * idx.element_size(), int8)
                     <= mips.SMEM_LIMIT]
        variants += [(f"{g} tile groups", qt, rs, g) for g in (1, 2, 4)]
        variants += [(f"{g} tile groups, {r}-row split", qt, r, g)
                     for g, r in ((2, 512), (4, 512), (2, 256)) if r < cand]
        for label, q_tile, rows, groups in variants:
            if (q_tile, rows, groups) != (qt, rs, gs):
                row.append(f"{label} "
                           f"{run(mma(q_tile, rows, groups))[0]:.4f}")
        ms, _ = run(mma(qt, rs, gs, "rescan_nostore"), must_match=False)
        row.append(f"nostore {ms:.4f} (wrong)")
        print(f"kernel {4 if int8 else 5} at {what} (B={b}, C={cand}, "
              f"kc={kc}; plan: q_tile {qt}, {plan['splits']} x {rs} rows, "
              f"{gs} tile groups), ms: "
              + ", ".join(row), flush=True)


def time_parent(libs, dev, gen):
    n_big, sms = 1 << 20, mips._sms(dev)
    bf = torch.bfloat16

    def turns(what, calls, outs):
        times = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            times[name].append(best_ms(calls[name]))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                     outs["tree"]))
        print(f"{what}, ms in turns: parent {times['parent'][0]:.4f} / "
              f"{times['parent'][1]:.4f}, tree {times['tree'][0]:.4f} / "
              f"{times['tree'][1]:.4f}{'' if same else ' (outputs differ)'}",
              flush=True)

    idx = torch.randn(n_big, D, device=dev, generator=gen).to(bf)
    qb = torch.randn(192, D, device=dev, generator=gen).to(bf)
    plan = mips.scan_plan(192, n_big, D, bf, 1, sms)
    outs = {w: (torch.empty(192, plan["splits"], 1, device=dev),
                torch.empty(192, plan["splits"], 1, device=dev,
                            dtype=torch.int32),
                torch.empty(192, 1, device=dev),
                torch.empty(192, 1, device=dev, dtype=torch.int32))
            for w in ("parent", "tree")}

    def scan(w):
        return lambda: libs[f"scan_{w}"].mips_scan_mma(
            qb.data_ptr(), idx.data_ptr(), 192, n_big, n_big - 1000, D, 1, 1,
            plan["q_tile"], plan["rows_per_split"], plan["splits"],
            plan["smem"], *(t.data_ptr() for t in outs[w]), stream())
    turns("kernel 2 B=192 N=1M k=1", {w: scan(w) for w in outs},
          {w: outs[w][2:] for w in outs})

    def cmax(w, q, rows, d, chunk, plan, out):
        return lambda: libs[f"cmax_{w}"].chunk_max_mma(
            q.data_ptr(), rows.data_ptr(), q.shape[0], rows.shape[0],
            rows.shape[0] - 1000, d, chunk, plan["q_tile"], plan["smem"],
            plan["per_block"], int(plan["q_resident"]), out.data_ptr(),
            stream())
    proj = torch.randn(n_big, 128, device=dev, generator=gen).to(bf)
    qp = torch.randn(192, 128, device=dev, generator=gen).to(bf)
    plan = mips.chunk_max_plan(192, n_big, 128, 512, bf, sms)
    outs = {w: torch.empty(192, n_big // 512, device=dev)
            for w in ("parent", "tree")}
    turns("kernel 3 B=192 N=1M R=128",
          {w: cmax(w, qp, proj, 128, 512, plan, outs[w]) for w in outs},
          {w: [outs[w]] for w in outs})
    del proj
    q6 = torch.randn(200, D, device=dev, generator=gen).to(bf)
    rows = idx[:NF]
    plan = mips.chunk_max_plan(200, NF, D, CHUNK, bf, sms)
    outs = {w: torch.empty(200, NF // CHUNK, device=dev)
            for w in ("parent", "tree")}
    turns("kernel 6 B=200 N=262,144",
          {w: cmax(w, q6, rows, D, CHUNK, plan, outs[w]) for w in outs},
          {w: [outs[w]] for w in outs})


if __name__ == "__main__":
    sys.exit(main())
