"""What the benchmark holds without running a cell: BENCHMARK.json keeps
to the contract's names and units, every name it gives has its file, the
harness and the reference load nothing of JAX, the reference nothing of
the program, and the roofline counts match hand counts."""

import ast
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import small
from portbench import roofline
from portbench.reference.retrieval import longest_first, pair_inputs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = small.ROOT / "portbench"


def test_benchmark_json_names_units_and_files():
    b = small.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (small.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        reports = {m["name"] for m in b["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   and m["moves"] in reports for m in b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        reporting = [w for w in m["workloads"] if w in
                     next(e for e in b["end_to_end"]
                          if e["name"] == m["moves"])["workloads"]]
        assert reporting == m["workloads"]
    assert len(json.dumps(b)) < 64 * 1024


def _top_levels(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(small.ROOT)) for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax(path):
    names = _top_levels(small.ROOT / path)
    assert not names & {"jax", "jaxlib", "flax",
                        "multihop_dense_retrieval_tpu"}, names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(small.ROOT)) for p in (BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert "multihop_dense_retrieval_tpu_torch" not in _top_levels(
        small.ROOT / path)


def test_loaded_modules_keep_off_jax_and_the_reference_off_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(small.ROOT)!r})\n"
        "import portbench.reference.encoder, portbench.reference.qa\n"
        "import portbench.reference.retrieval\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import portbench.harness, portbench.drivers.mhop\n"
        "import portbench.drivers.single, portbench.drivers.read\n"
        "import portbench.calibrate\n"
        "import multihop_dense_retrieval_tpu_torch.search.beam\n"
        "import multihop_dense_retrieval_tpu_torch.eval.qa_eval\n"
        "import multihop_dense_retrieval_tpu_torch.train.qa\n"
        "from portbench.harness import forbidden_modules\n"
        "print(ref)\n"
        "print(forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    ref, found = res.stdout.strip().splitlines()[-2:]
    assert "multihop_dense_retrieval_tpu_torch" not in ref
    assert "'jax'" not in ref
    assert found == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "multihop_dense_retrieval_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multihop_dense_retrieval_tpu.core", sys)
    assert harness.forbidden_modules() == ["multihop_dense_retrieval_tpu"]


# ---- the roofline --------------------------------------------------------------

def test_roofline_counts_by_hand():
    w = roofline.int8_scan(b=2, n=10, d=4, k=3)
    assert w.bytes == 10 * (4 + 4) + 2 * 4 * 4 + 2 * 3 * 8
    assert w.ops == {"int8": 2 * 2 * 10 * 4}
    p = roofline.int8_pca_search(b=2, n=1024, d=8, r=4, k=1, kc=2, cand=512,
                                 chunks_read=2)
    assert p.bytes == (1024 * 4 * 2 + 8 * 4 * 4 + 4 * 2 * 4
                       + 2 * 512 * 12 + 2 * 8 * 4 + 2 * 8)
    assert p.ops == {"bf16": 2 * 2 * 1024 * 4, "fp32": 2 * 2 * 8 * 4,
                     "int8": 2 * 2 * 2 * 512 * 8}
    # the full cell: bandwidth bound, 4.04 GB at 3.35 TB/s
    cell = roofline.int8_scan(192, 5233329, 768, 1)
    assert cell.least_s() == pytest.approx(5233329 * 772 / 3.35e12, rel=1e-3)
    both = w.add(p)
    assert both.bytes == w.bytes + p.bytes
    assert both.ops["int8"] == w.ops["int8"] + p.ops["int8"]


def test_encoder_flops_by_hand():
    h, f, n = 4, 8, 3
    full = 8 * n * h * h + 4 * n * h * f + 4 * n * n * h
    assert roofline.encoder_flops([n], h, f, 2, False) == 2 * full
    last = 4 * n * h * h + 4 * h * h + 4 * h * f + 4 * n * h
    assert roofline.encoder_flops([n, n], h, f, 2, True, head=5) == \
        2 * (full + last + 5)


# ---- the reference's pair input --------------------------------------------------

def test_pair_input_is_the_host_tokenizer_s_pair_encode():
    """The reference's q + p rows are the port's host tokenizer's
    ``encode_pair`` (longest-first truncation, RoBERTa's layout) of the
    same texts."""
    from multihop_dense_retrieval_tpu_torch.data.tokenization import \
        HashTokenizer

    tok = HashTokenizer()
    rng = np.random.default_rng(0)
    spec = {"cls_id": 0, "sep_id": 2, "pad_id": 1}
    for _ in range(40):
        qa, qb = int(rng.integers(1, 80)), int(rng.integers(0, 320))
        a = " ".join(f"q{x}" for x in rng.integers(0, 999, qa))
        b = " ".join(f"p{x}" for x in rng.integers(0, 999, qb))
        want = tok.encode_pair(a, b, 350)
        ta = torch.tensor([tok.tokenize_ids(a)])
        tb = torch.tensor([tok.tokenize_ids(b) or [0]]).to(torch.int16)
        ids, mask = pair_inputs(ta, torch.tensor([qa]), tb,
                                torch.tensor([qb]), 350, spec)
        assert ids[0].tolist() == want["input_ids"].tolist()
        assert mask[0].tolist() == want["attention_mask"].tolist()


def test_longest_first_is_token_by_token_truncation():
    for la in range(0, 30):
        for lb in range(0, 30):
            a, b = la, lb
            while a + b > 20:
                if a > b:
                    a -= 1
                else:
                    b -= 1
            ka, kb = longest_first(torch.tensor([la]), torch.tensor([lb]), 20)
            assert (int(ka), int(kb)) == (a, b)
