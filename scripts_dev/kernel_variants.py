"""Where the H100 port's tensor-core kernels 6 and 8 spend their time.

Builds variants of ``ops/csrc/fused_attention.cu`` and
``ops/csrc/chunk_max_mma.cu`` by text substitution, and times each against
the source as it stands, in one process on one card (CUDA events, best of
two runs of 20 launches).  Kernel 8's tensor-core template at (B, W) =
(256, 300), (192, 350), (192, 40), (64, 514), 12 heads of 64, bf16:
  ieee    __fdiv_rn(e, l) in place of div_rn (the IEEE division with its
          per-call reciprocal and slow-path branch)
  mul     e * l (wrong: the cost of the division itself)
  noexp3  pass 3 without its expf (wrong: the cost of recomputing e)
  nop2    no pass 2 (wrong: the cost of the row sums)
each with 8 and 4 warps a block; variants whose output differs from the
tree's say so.  Kernel 6 at B = 100, 200, 384 over a 262,144 x 768 bf16
index in 2048-row chunks, KS x STAGES in (32, 4), (64, 3), (64, 4).

Needs a GPU and nvcc; run from the repository root:
    python3 scripts_dev/kernel_variants.py
"""

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
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def best_ms(fn):
    return min(cs.cuda_ms(fn, 20) for _ in range(2))


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    attn_names = ("tree", "ieee", "mul", "noexp3", "nop2")
    chunk_cfgs = ((32, 4), (64, 3), (64, 4))
    sources = {f"attn_{n}": (attention_variant(n), "fused_attention")
               for n in attn_names}
    sources.update({f"cmax_{ks}_{st}": (chunk_variant(ks, st),
                                        "chunk_max_mma")
                    for ks, st in chunk_cfgs})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(sources, tmp)
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)

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
            for name in attn_names:
                for warps in (8, 4):
                    out = torch.empty_like(q)
                    call(name, warps, out)
                    torch.cuda.synchronize()
                    same = "" if torch.equal(out, ref) else " (differs)"
                    ms = best_ms(lambda: call(name, warps, out))
                    row.append(f"{name}/{warps}w {ms:.4f}{same}")
            print(f"kernel 8 B={b} W={w} (plan: {plan['warps']} warps), ms: "
                  + ", ".join(row), flush=True)

        idx = torch.randn(NF, D, device=dev, generator=gen).to(torch.bfloat16)
        for b in (100, 200, 384):
            qb = torch.randn(b, D, device=dev, generator=gen).to(
                torch.bfloat16)
            qn = mips.chunk_max_plan(b, NF, D, CHUNK, torch.bfloat16)["q_tile"]
            ref = mips.chunk_max(qb, idx, CHUNK, NF - 1000)
            row = []
            for ks, st in chunk_cfgs:
                out = torch.empty(b, NF // CHUNK, device=dev)
                smem = st * (128 + qn) * (ks + 8) * 2 + 2 * qn * 4

                def call():
                    rc = libs[f"cmax_{ks}_{st}"].chunk_max_mma(
                        qb.data_ptr(), idx.data_ptr(), b, NF, NF - 1000, D,
                        CHUNK, qn, smem, out.data_ptr(), stream())
                    assert rc == 0, (ks, st, rc)
                call()
                torch.cuda.synchronize()
                same = "" if torch.equal(out, ref) else " (differs)"
                row.append(f"KS={ks}/{st} stages {best_ms(call):.4f}{same}")
            print(f"kernel 6 B={b} (q_tile {qn}), ms: " + ", ".join(row),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
