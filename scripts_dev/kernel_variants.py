"""Where the H100 port's tensor-core kernels 2, 3, 6 and 8 spend their time.

Builds variants of ``ops/csrc/fused_attention.cu``,
``ops/csrc/chunk_max_mma.cu`` and ``ops/csrc/mips_scan_mma.cu`` by text
substitution, and times each against the source as it stands, in one
process on one card (CUDA events, best of two runs of 20 launches).
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
2048-row chunks, KS x STAGES in (32, 4), (64, 3), (64, 4); with --parent
DIR also DIR's own ops/csrc/chunk_max_mma.cu (an unpacked earlier commit
whose entry point takes no chunks_per_block or qres), timed in turns with
the tree (parent, tree, tree, parent).
scan: kernel 2 at (B, N, k) = (192, 1M, 1), (192, 1M, 8) and (100, 262,144,
2), D = 768: the tree, "raw" (the tensor-core sums returned without the
fp32 rescoring: its time, and its largest relative difference from the
plain scan beside the tree's), "nofold" (no top-k fold: the main loop
alone, wrong output) and query tiles of 64 and 128 in place of the plan's.
pca: kernel 3 at (B, N) = (192, 1M) and (200, 262,144), R = 128, 512-row
chunks: the plan (resident queries, several chunks a block), resident
queries one chunk a block, and the streamed template (kernel 6's) one
chunk a block (launch arguments of the tree).

Needs a GPU and nvcc; run from the repository root:
    python3 scripts_dev/kernel_variants.py [attention] [chunk] [scan] [pca]
        [--parent DIR]
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


# the entry point of kernel 6 before it took chunks_per_block and qres
PARENT_CMAX_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p]


def build_all(sources, tmp):
    """{name: CDLL}, one nvcc per variant, all started together."""
    procs = []
    for name, (src, entry) in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(tmp, f"lib{name}.so")
        procs.append((name, entry, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
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
        if name == "cmax_parent":
            fn.argtypes = PARENT_CMAX_ARGS
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def best_ms(fn):
    return min(cs.cuda_ms(fn, 20) for _ in range(2))


ATTN_NAMES = ("tree", "ieee", "mul", "noexp3", "nop2")
CHUNK_CFGS = ((32, 4), (64, 3), (64, 4))
SCAN_NAMES = ("tree", "raw", "nofold")
SECTIONS = ("attention", "chunk", "scan", "pca")


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", choices=SECTIONS)
    ap.add_argument("--parent", help="an unpacked earlier commit whose "
                    "kernel 6 is timed beside the tree's")
    args = ap.parse_args()
    run = set(args.sections) or set(SECTIONS)
    print(cs.nvidia_smi(), flush=True)
    sources = {}
    if "attention" in run:
        sources.update({f"attn_{n}": (attention_variant(n), "fused_attention")
                        for n in ATTN_NAMES})
    if "chunk" in run:
        sources.update({f"cmax_{ks}_{st}": (chunk_variant(ks, st),
                                            "chunk_max_mma")
                        for ks, st in CHUNK_CFGS})
        if args.parent:
            sources["cmax_parent"] = (open(os.path.join(
                args.parent, "multihop_dense_retrieval_tpu_torch/ops/csrc/"
                "chunk_max_mma.cu")).read(), "chunk_max_mma")
    if "scan" in run:
        sources.update({f"scan_{n}": (scan_variant(n), "mips_scan_mma")
                        for n in SCAN_NAMES})
    if "pca" in run:
        sources["cmax_tree"] = (CMAX_SRC, "chunk_max_mma")
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
        if "cmax_parent" in libs:
            smem = 4 * (128 + qn) * 72 * 2 + 2 * qn * 4
            outs = {n: torch.empty(b, NF // CHUNK, device=dev)
                    for n in ("parent", "tree")}
            calls = {
                "parent": lambda: libs["cmax_parent"].chunk_max_mma(
                    qb.data_ptr(), idx.data_ptr(), b, NF, NF - 1000, D, CHUNK,
                    qn, smem, outs["parent"].data_ptr(), stream()),
                "tree": lambda: libs["cmax_64_4"].chunk_max_mma(
                    qb.data_ptr(), idx.data_ptr(), b, NF, NF - 1000, D, CHUNK,
                    qn, smem, plan["per_block"], 0, outs["tree"].data_ptr(),
                    stream())}
            times = {"parent": [], "tree": []}
            for name in ("parent", "tree", "tree", "parent"):
                assert calls[name]() == 0, name
                times[name].append(best_ms(calls[name]))
            torch.cuda.synchronize()
            same = "" if torch.equal(outs["parent"], outs["tree"]) else \
                " (outputs differ)"
            row.append(f"parent {times['parent'][0]:.4f}/"
                       f"{times['parent'][1]:.4f}, tree in turns "
                       f"{times['tree'][0]:.4f}/{times['tree'][1]:.4f}{same}")
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


if __name__ == "__main__":
    sys.exit(main())
