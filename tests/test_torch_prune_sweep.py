"""scripts_dev/prune_sweep_torch.py (the port's copy) against
scripts_dev/prune_sweep.py (the JAX package's), both loaded from
scripts_dev/ with importlib, on the CPU.

  * ``gen_keys`` and ``make_data``: the same keys, and the same bytes in
    corpus.jsonl, mhop.jsonl and eval.jsonl, at 256 docs and 16 questions.
  * ``_sweep``: both sweeps read one set of weights and one index
    directory.  The weights are a seeded mini retriever initialised in
    JAX (kernels scaled by WIDEN, which spreads the random model's
    scores), written as the JAX trainer writes ``checkpoint_best`` and
    exported to the port's ``checkpoint_best.pt`` by the JAX
    ``cli/export_ckpt``; the index directory is the JAX
    ``cli/encode_corpus``'s, with the script's own arguments.
    - fp32: the mini preset computes in fp32 in both packages and the
      index is fp32, so the two results dicts must be equal.
    - bf16 (tests/test_torch_prune_sweep_bf16.py, a file of its own so
      that the two JAX sweeps can run on two test workers): the preset's
      own dtype and the script's bf16 index.
  The JAX engine runs on its XLA tier (``SearchConfig(use_pallas=False)``),
  the exact search that the JAX package's own tests hold its Pallas
  kernels to: in interpret mode the sweep's eight engines take about
  twice as long to compile.  Each JAX sweep runs once, in a module-scoped
  fixture.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import encode_corpus as jencode
from multihop_dense_retrieval_tpu.cli import export_ckpt as jexport
from multihop_dense_retrieval_tpu.core import checkpoint as jckpt
from multihop_dense_retrieval_tpu.core import config as jconfig
from multihop_dense_retrieval_tpu.search import beam as jbeam
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.ops.mips import NEG_INF
from multihop_dense_retrieval_tpu_torch.search import beam as tbeam

ROOT = Path(__file__).resolve().parent.parent
N_DOCS, N_TRAIN, WIDEN = 256, 16, 4.0


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts_dev" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _load("prune_sweep")
PS = _load("prune_sweep_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: torch's CPU threads
    spin-wait at every parallel op, so with the suite's workers sharing
    the cores a multi-threaded op waits on descheduled threads (the
    end-to-end case below took 156 s on a loaded host with 8 threads,
    5 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_key", [16, 256, 1024])
def test_gen_keys_match_jax(n_key):
    keys = PS.gen_keys(n_key)
    assert keys == JS.gen_keys(n_key) and len(set(keys)) == n_key


@pytest.mark.parametrize("n_eval,n_key", [(0, 0), (8, 64), (0, 40)])
def test_make_data_bytes_match_jax(tmp_path, n_eval, n_key):
    """The same seed and sizes write the same bytes (and return the same
    docs and eval rows), with eval = train and with a separate eval set
    over a pool of key docs."""
    out = {}
    for name, mod in (("jax", JS), ("port", PS)):
        work = tmp_path / name
        work.mkdir()
        out[name] = mod.make_data(str(work), np.random.RandomState(0),
                                  n_docs=N_DOCS, n_train=N_TRAIN,
                                  n_eval=n_eval, n_key_docs=n_key)
    (jp, jdocs, jrows), (pp, pdocs, prows) = out["jax"], out["port"]
    assert sorted(jp) == sorted(pp) == ["corpus", "eval", "mhop"]
    for key in jp:
        assert Path(jp[key]).read_bytes() == Path(pp[key]).read_bytes(), key
    assert jdocs == pdocs and jrows == prows
    assert len(prows) == (n_eval or N_TRAIN)


def test_make_data_refuses_too_few_key_docs(tmp_path):
    """Both refuse a key pool too small for disjoint question pairs."""
    for mod in (JS, PS):
        with pytest.raises(SystemExit, match="disjoint question pairs"):
            mod.make_data(str(tmp_path), np.random.RandomState(0),
                          n_docs=N_DOCS, n_train=N_TRAIN, n_key_docs=20)


def _chains(out):
    return [tuple((int(a), int(b)) for a, b, s in zip(h1, h2, sc)
                  if s > NEG_INF / 2)
            for h1, h2, sc in zip(np.asarray(out["hop1_ids"]),
                                  np.asarray(out["hop2_ids"]),
                                  np.asarray(out["path_scores"]))]


def _recorded(mp, cls):
    """Every search() result of ``cls`` while ``mp`` is active."""
    seen = []
    search = cls.search

    def recorded(self, *a, **kw):
        out = search(self, *a, **kw)
        seen.append(_chains(out))
        return out

    mp.setattr(cls, "search", recorded)
    return seen


def _sweeps(tmp, dtype, jax_sweep=True):
    """Both packages' sweeps over one JAX-made mini retriever and one JAX
    index directory: (JAX results, port results, the chains of every JAX
    search, those of every port search); without ``jax_sweep`` the port's
    alone (None and [] for JAX's)."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            for mod in (jcommon, tcommon):
                mini = mod.MODEL_PRESETS["mini"]
                mp.setitem(mod.MODEL_PRESETS, "mini",
                           lambda dtype=None, f=mini: f(dtype="float32"))
        mp.setattr(jconfig, "SearchConfig", functools.partial(
            jconfig.SearchConfig, use_pallas=False))
        sides = (("jax", JS), ("port", PS)) if jax_sweep else (("port", PS),)
        data = {}
        for name, mod in sides:
            (tmp / name).mkdir()
            data[name] = mod.make_data(str(tmp / name),
                                       np.random.RandomState(0),
                                       n_docs=N_DOCS, n_train=N_TRAIN)
        _, params = jcommon.init_retriever(
            jcommon.resolve_encoder_config("mini"), seed=3)
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: x * WIDEN if "kernel" in jax.tree_util.keystr(path)
            else x, params)
        jstage, pstage = tmp / "stage1_jax", tmp / "stage1_port"
        jckpt.save_pytree(str(jstage / "checkpoint_best"), params)
        pstage.mkdir()
        jexport.main(["--checkpoint", str(jstage / "checkpoint_best"),
                      "--arch", "mhop",
                      "--out", str(pstage / "checkpoint_best.pt")])
        index_dir = str(tmp / "index")
        jencode.main([data[sides[0][0]][0]["corpus"], index_dir,
                      "--checkpoint",
                      str(jstage / "checkpoint_best"), "--tokenizer", "hash",
                      "--model-name", "mini", "--batch-size", "64",
                      "--chunk-rows", str(N_DOCS), "--max-c-len", "64"]
                     + (["--index-dtype", "float32"]
                        if dtype == "float32" else []))
        seen = {"jax": _recorded(mp, jbeam.BeamSearcher),
                "port": _recorded(mp, tbeam.BeamSearcher)}
        res = {}
        for name, mod, stage, kw in (("jax", JS, jstage, {}),
                                     ("port", PS, pstage, {"device": "cpu"})):
            if name not in data:
                continue
            paths, docs, rows = data[name]
            mp.setenv("PRUNE_OUT", str(tmp / f"{name}.json"))
            res[name] = mod._sweep(str(tmp / name), paths, docs, rows,
                                   str(stage), index_dir, N_DOCS, N_DOCS,
                                   N_DOCS, N_TRAIN, **kw)
            assert json.loads((tmp / f"{name}.json").read_text()) == \
                res[name]
    return res.get("jax"), res["port"], seen["jax"], seen["port"]


@pytest.fixture(scope="module")
def fp32_sweeps(tmp_path_factory):
    return _sweeps(tmp_path_factory.mktemp("sweep_fp32"), "float32")


def test_sweep_matches_jax_in_fp32(fp32_sweeps):
    """Equal results dicts: every margin's key (its value printed to three
    decimals) and every fraction; and the same chains in every search."""
    jres, pres, jseen, pseen = fp32_sweeps
    assert pres == jres
    assert pseen == jseen and len(pseen) == 8
    margins = [k for k in pres if k.startswith("margin_")]
    assert len(margins) == 7
    assert 0 < pres["margin_auto_injit_q0.5"]["pruned_frac"] < 1


def _short(key):
    return key.rsplit("_", 1)[0] if key.startswith("margin_p") else key


def _shape(res):
    return {_short(k): sorted(v) if isinstance(v, dict) else None
            for k, v in res.items()}


def test_sweep_result_keys_are_the_jax_records(fp32_sweeps):
    """The port writes the keys of the JAX script's TPU record
    (docs/prune_sweep_r5.json), the margins' printed values aside."""
    ref = json.loads((ROOT / "docs" / "prune_sweep_r5.json").read_text())
    assert _shape(fp32_sweeps[1]) == _shape(ref)


def test_main_trains_encodes_and_sweeps_on_the_cpu(tmp_path, monkeypatch):
    """The port's main() end to end with PRUNE_DEVICE=cpu at 256 docs, 16
    questions and one epoch: cli/train_retriever writes
    checkpoint_best.pt, cli/encode_corpus the index, and the sweep its
    JSON; PRUNE_REUSE then reruns the sweep alone on those artifacts,
    with the same result."""
    monkeypatch.setattr(PS.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path))
    monkeypatch.setenv("PRUNE_DEVICE", "cpu")
    monkeypatch.setenv("PRUNE_NDOCS", str(N_DOCS))
    monkeypatch.setenv("PRUNE_NTRAIN", str(N_TRAIN))
    monkeypatch.setenv("PRUNE_EPOCHS", "1")
    monkeypatch.setenv("PRUNE_OUT", str(tmp_path / "out.json"))
    res = PS.main()
    assert (tmp_path / "stage1" / "checkpoint_best.pt").exists()
    assert json.loads((tmp_path / "out.json").read_text()) == res
    assert _shape(res) == _shape(json.loads(
        (ROOT / "docs" / "prune_sweep_r5.json").read_text()))
    monkeypatch.setenv("PRUNE_REUSE", str(tmp_path))
    assert PS.main() == res
