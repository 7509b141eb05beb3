"""The port stands alone: it imports no JAX, no Flax and nothing of the JAX
package (top-level module names compared exactly — the port's own name
starts with the JAX package's), nor the third-party ``regex`` package,
which the card host lacks; ``transformers`` and ``tqdm`` only lazily,
inside a function; and its entry points never fall back to the CPU on
their own: nor do its meshes, and its pod chooses its collective backend
once, from where its processes run."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = "multihop_dense_retrieval_tpu_torch"
JAX_PKG = "multihop_dense_retrieval_tpu"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "regex", JAX_PKG}
# importable only inside a function, behind options no card path takes
LAZY = {"transformers", "tqdm"}
SOURCES = sorted([str(p.relative_to(ROOT)) for p in (ROOT / PORT).rglob("*.py")]
                 + ["chip_smoke.py", "examples/quickstart_torch.py"])


def _port_modules():
    out = []
    for path in sorted((ROOT / PORT).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported_top_levels(nodes):
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    assert not _imported_top_levels(ast.walk(tree)) & FORBIDDEN
    assert not _imported_top_levels(tree.body) & LAZY


def test_every_module_imports_with_jax_blocked():
    code = f"""
import importlib, json, sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
for mod in {_port_modules()!r}:
    importlib.import_module(mod)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and
                m.split(".")[0] in {sorted(FORBIDDEN)!r})
print(json.dumps(loaded))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch,
                                                               tmp_path):
    from multihop_dense_retrieval_tpu_torch.core.config import SearchConfig
    from multihop_dense_retrieval_tpu_torch.core.device import resolve_device
    from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
    from multihop_dense_retrieval_tpu_torch.index import DenseIndex
    from multihop_dense_retrieval_tpu_torch.search import BeamSearcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseIndex.build(emb, chunk_rows=64)
    index = DenseIndex.build(emb, chunk_rows=64, device="cpu")
    index.save(str(tmp_path / "i.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseIndex.load(str(tmp_path / "i.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BeamSearcher(encode_fn=None, index=index,
                     text_ids=np.zeros((64, 4), np.int32),
                     text_lens=np.zeros(64, np.int32),
                     empty=np.zeros(64, bool),
                     spec=HashTokenizer(vocab_size=64).spec,
                     config=SearchConfig())


@pytest.mark.parametrize("cli", ["eval_mhop_retrieval", "eval_mhop_fever",
                                 "eval_retrieval"])
def test_cli_without_device_raises_when_cuda_is_absent(monkeypatch, tmp_path,
                                                       cli):
    """The CLIs default to --device cuda: without CUDA they raise before
    reading anything, and never run on the CPU on their own."""
    import importlib

    main = importlib.import_module(f"{PORT}.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([missing + ".jsonl", missing, "--tokenizer", "hash",
              "--model-name", "tiny"])


def test_numerics_policy_disables_tf32():
    import multihop_dense_retrieval_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA the smoke prints no result and exits non-zero, also
    from a directory that holds chip_smoke.py alone."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_model_inits_without_device_raise_when_cuda_is_absent(monkeypatch):
    """init_retriever and init_reader put their model on cuda unless the
    caller names a device: without CUDA they raise, and never leave the
    model on the CPU on their own."""
    from multihop_dense_retrieval_tpu_torch.cli import common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = common.resolve_encoder_config("tiny", dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.init_retriever(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.init_retriever(cfg, unified=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.init_reader("tiny")
    assert next(common.init_retriever(cfg, device="cpu").parameters()
                ).device.type == "cpu"
    assert next(common.init_retriever(cfg, unified=True, device="cpu")
                .parameters()).device.type == "cpu"
    _, reader = common.init_reader("tiny", device="cpu")
    assert next(reader.parameters()).device.type == "cpu"


@pytest.mark.parametrize("cli", ["end2end", "demo", "serve", "parity"])
def test_qa_cli_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                          tmp_path, cli):
    """The question-answering CLIs default to --device cuda: without CUDA
    they raise before reading the index, the questions or a checkpoint."""
    import importlib

    main = importlib.import_module(f"{PORT}.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    argv = {"end2end": [missing + ".jsonl", missing],
            "demo": [missing, "--question", "q"],
            "serve": [missing, "--port", "0"]}.get(cli)
    if cli == "parity":
        # the artifacts exist (empty files): the device is resolved next
        for rel in ("models/q_encoder.pt", "data/hotpot_index/wiki_index.npy",
                    "data/hotpot_index/wiki_id2doc.json",
                    "data/hotpot/hotpot_qas_val.json"):
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / rel).write_text("")
        argv = ["--data-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + ["--tokenizer", "hash"])


@pytest.mark.parametrize("cli", ["train_qa", "train_single", "launch"])
def test_training_cli_without_device_raises_when_cuda_is_absent(
        monkeypatch, tmp_path, cli):
    """The reader trainer, the single-hop trainer and the grid launcher
    (through train_retriever) default to --device cuda: without CUDA they
    raise before reading anything, and never train on the CPU on their
    own."""
    import importlib

    main = importlib.import_module(f"{PORT}.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.jsonl")
    argv = ["--predict-file", missing, "--tokenizer", "hash",
            "--model-name", "tiny"]
    if cli != "train_qa":
        argv += ["--train-file", missing]
    if cli == "launch":
        argv += ["--output-dir", str(tmp_path / "sweep")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_mesh_and_pod_never_fall_back(monkeypatch):
    """Without cards the default mesh, and --index-shards over the bare
    cuda, raise rather than put shards on the CPU.  Only core/mesh.py
    starts a process group, once, in init_pod, with no try/except around
    it: the collective backend is chosen from where the processes run and
    never switched after a failure."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.core import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="does not fit the 0"):
        mesh.make_mesh()
    with pytest.raises(ValueError, match="does not fit the 0"):
        common.index_mesh(2, "cuda")
    starters = [p for p in SOURCES if p.startswith(PORT) and any(
        call in (ROOT / p).read_text()
        for call in ("init_process_group", "new_group"))]
    assert starters == [f"{PORT}/core/mesh.py"]
    tree = ast.parse((ROOT / starters[0]).read_text())
    init = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "init_pod")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(init))
    calls = [n for n in ast.walk(init) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "init_process_group"]
    assert len(calls) == 1 and isinstance(calls[0].args[0], ast.Constant)
