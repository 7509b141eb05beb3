"""The benchmark's cells at small sizes on the CPU: inputs repeat by seed,
the plain reference agrees with the port where both compute in float32,
the check passes a sound run and fails the control and the faults a cell
can have, and a configuration, traffic mix and metric can be added as
files alone."""

import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import small
from portbench import harness
from portbench.data import corpus as C
from portbench.data.weights import make_weights
from portbench.drivers import mhop, read, single
from portbench.reference.encoder import Encoder

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def _run(name, dtype="bfloat16", seconds=0.5, trace=False, patch=None,
         **traffic):
    wl, cfg, tr, args = small.cell(name, dtype, **traffic)
    if patch is not None:
        patch()
    return harness.run_cell(small.bench(), wl, SEED, seconds, trace,
                            time.perf_counter(), device="cpu",
                            driver_args=args, cfg=cfg, traffic=tr)


# ---- inputs ----------------------------------------------------------------

def test_weights_repeat_by_seed():
    _, cfg, _, _ = small.cell("mhop.beam1.b192")
    a, b = make_weights(cfg, 7, CPU), make_weights(cfg, 7, CPU)
    c = make_weights(cfg, 8, CPU)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["project.0.weight"], c["project.0.weight"])
    assert a["encoder.encoder.layer.0.attention.self.query.weight"].dtype \
        == torch.bfloat16
    assert a["project.0.weight"].dtype == torch.float32


@pytest.mark.parametrize("name", ["mhop.beam1.b192", "single.top100.b256"])
def test_retrieval_inputs_repeat_by_seed(name):
    wl, cfg, tr, args = small.cell(name)
    mod = single if tr["driver"] == "single" else mhop
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        d = mod.Driver(cfg, tr, seed, CPU, **args)
        d._make_inputs()
        runs.append(d)
    a, b, c = runs
    for key in ("vectors", "scales", "pca_proj", "pca_bounds"):
        assert torch.equal(a.index[key], b.index[key])
    assert torch.equal(a.text_ids, b.text_ids)
    assert torch.equal(a.text_lens, b.text_lens)
    for key in a.pool:
        assert np.array_equal(a.pool[key], b.pool[key])
    assert not torch.equal(a.index["vectors"], c.index["vectors"])
    # every seed sends the same question lengths, in its own order
    la = np.sort(a.pool["attention_mask"].sum(1))
    lc = np.sort(c.pool["attention_mask"].sum(1))
    assert np.array_equal(la, lc)


def test_reader_text_repeats_by_seed():
    gen = torch.Generator().manual_seed(5)
    _, _, tr, _ = small.cell("read.top5.q64")
    a = read.make_text(torch.Generator().manual_seed(5),
                       np.random.default_rng(5), tr)
    b = read.make_text(gen, np.random.default_rng(5), tr)
    assert a == b
    assert all(len(it["chains"]) == tr["chains"] for it in a)


def test_index_matches_the_port_s_prefilter_build():
    """The device-made PCA projections and certificate bounds are those the
    port's own build (``ops/mips.py::build_pca_prefilter``) gives for the
    same stored rows."""
    from multihop_dense_retrieval_tpu_torch.ops.mips import \
        build_pca_prefilter

    gen = torch.Generator().manual_seed(3)
    d, n = 64, 4096
    factor = torch.randn(d, d, generator=gen) * 0.1
    rot = torch.linalg.qr(torch.randn(d, 16, generator=gen))[0]
    planted = torch.tensor([5, 700])
    ix = C.make_index(gen, factor, rot, n, 4000, 512, planted,
                      torch.randn(2, d, generator=gen), CPU)
    deq = (ix["vectors"].double() * ix["scales"].double()[:, None]).numpy()
    proj, bounds = build_pca_prefilter(
        deq.astype(np.float32), rot.numpy(), cand_rows=512,
        scales=ix["scales"].numpy(), store_dtype="int8")
    assert torch.equal(ix["pca_proj"],
                       torch.from_numpy(proj).to(torch.bfloat16))
    np.testing.assert_allclose(ix["pca_bounds"].numpy(), bounds, rtol=2e-6)


# ---- the reference against the port -----------------------------------------

def test_reference_encoder_matches_the_port_in_fp32():
    _, cfg, _, _ = small.cell("mhop.beam1.b192", "float32")
    w = make_weights(cfg, 11, CPU)
    model = mhop.load_retriever(cfg, w, CPU)
    ids = torch.randint(4, 1000, (6, 20))
    mask = torch.ones_like(ids)
    mask[3, 12:] = 0
    ids[3, 12:] = 1
    with torch.no_grad():
        got = model.encode_seq(ids, mask)
    ref = Encoder(w, cfg).retrieve(ids, mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["mhop.beam1.b192", "mhop.beam5.b100",
                                  "single.top100.b256", "read.top5.q64"])
def test_sound_fp32_run_agrees_with_the_reference(name):
    out, checks = _run(name, "float32")
    got = {k: v for k, v, _ in checks}
    assert out["correct"], got
    for key in ("vec_err", "logit_err", "sp_err"):
        if key in got:
            assert got[key] < 1e-4, got
    for key in ("input_diff", "miss", "feature_diff", "decode_miss",
                "answer_diff"):
        if key in got:
            assert got[key] == 0, got


@pytest.mark.parametrize("name", ["mhop.beam1.b192", "single.top100.b256",
                                  "read.top5.q64"])
def test_fp8_control_reads_far_above_the_bf16_program(name):
    """The control (the reference in float8 products) departs from the
    float32 reference several times as far as the bf16 program does."""
    wl, cfg, tr, args = small.cell(name)
    mod = {"mhop": mhop, "single": single, "read": read}[tr["driver"]]
    d = mod.Driver(cfg, tr, SEED, CPU, **args)
    d.setup()
    d.warmup()
    for i in range(tr["check_from"]):
        d.step(i)
    d.window_done(tr["check_from"])
    prog = {k: v for k, v, _ in d.check()}
    ref = Encoder(d.weights, cfg)
    enc = Encoder(d.weights, cfg, precision="fp8")
    rows = d.captured[0][1]
    ctrl = mod.judge(d, ref, rows, mod.control_outputs(d, enc, rows))
    key = "logit_err" if name.startswith("read") else "vec_err"
    assert ctrl[key] > 3 * prog[key], (prog, ctrl)


# ---- faults the check must catch ---------------------------------------------

def _stale(driver_cls):
    """The timed path returns the previous step's results (its state left
    unchanged)."""
    orig = driver_cls._search
    last = {}

    def search(self, rows, *a):
        out = orig(self, rows, *a)
        prev = last.get(id(self))
        last[id(self)] = out
        return prev if prev is not None else out

    return search


def _halved(driver_cls):
    """Half of the batch left out: its results are the first half's."""
    orig = driver_cls._search

    def search(self, rows, *a):
        out = orig(self, rows, *a)
        h = len(rows) - len(rows) // 2
        cat = {np.ndarray: np.concatenate, torch.Tensor: torch.cat}
        return {k: cat[type(v)]([v[:h], v[:len(rows) - h]])
                if type(v) in cat and v.shape[:1] == (len(rows),) else v
                for k, v in out.items()}

    return search


def _altered(driver_cls):
    """One returned id altered where it is produced."""
    orig = driver_cls._search

    def search(self, rows, *a):
        out = dict(orig(self, rows, *a))
        key = "hop2_ids" if "hop2_ids" in out else "ids"
        v = out[key].copy()
        v[0, 0] = (v[0, 0] + 7919) % self.corpus["n_docs"]
        out[key] = v
        return out

    return search


@pytest.mark.parametrize("fault", [_stale, _halved, _altered])
@pytest.mark.parametrize("name", ["mhop.beam1.b192", "single.top100.b256"])
def test_retrieval_check_fails_a_broken_timed_path(name, fault, monkeypatch):
    cls = single.Driver if name.startswith("single") else mhop.Driver
    monkeypatch.setattr(cls, "_search", fault(cls))
    out, checks = _run(name, check_from=3, check_batches=2)
    assert not out["correct"], checks


def test_retrieval_check_fails_an_uncertified_hop_2_that_skips_its_best(
        monkeypatch):
    """The PCA search's hop 2 returns each query's second-best rows with
    their true scores and certifies none: the ranking is not checked for
    uncertified queries, so the planted answer key has to catch it."""
    from multihop_dense_retrieval_tpu_torch.search.beam import BeamSearcher

    orig = BeamSearcher._mips

    def mips(self, queries, k, pca=True):
        if not pca:
            return orig(self, queries, k, pca)
        vals, docs, _ = orig(self, queries, k + 1, pca)
        none = torch.zeros(len(queries), dtype=torch.bool,
                           device=queries.device)
        return vals[:, 1:], docs[:, 1:], none

    sound = {k: v for k, v, _ in _run("mhop.beam1.b192", check_from=3,
                                       check_batches=2)[1]}
    monkeypatch.setattr(BeamSearcher, "_mips", mips)
    out, checks = _run("mhop.beam1.b192", check_from=3, check_batches=2)
    got = {k: v for k, v, _ in checks}
    assert not out["correct"], checks
    assert got["planted_miss"] > sound["planted_miss"], (checks, sound)
    assert got["miss"] == 0 and got["input_diff"] == 0, checks


def test_reader_check_fails_a_decode_that_skips_the_best_span(monkeypatch):
    """The span decode on the card returns another span than the best,
    with that span's own score: the answers then follow the program's
    spans, so only the decode check can catch it."""
    from multihop_dense_retrieval_tpu_torch.train import qa as port_qa

    orig = port_qa.decode_spans

    def other_span(start_logits, end_logits, max_ans_len):
        s, e, _ = orig(start_logits, end_logits, max_ans_len)
        last = start_logits.shape[1] - 1
        e2 = torch.where(e > s, s, torch.clamp(e + 1, max=last))
        r = torch.arange(start_logits.shape[0], device=s.device)
        return s, e2, start_logits[r, s] + end_logits[r, e2]

    monkeypatch.setattr(port_qa, "decode_spans", other_span)
    out, checks = _run("read.top5.q64", check_from=3, check_calls=2)
    got = {k: v for k, v, _ in checks}
    assert not out["correct"] and got["decode_miss"] > 0, checks
    assert got["answer_diff"] == 0 and got["feature_diff"] == 0, checks


def _reader_fault(kind):
    orig = read.Driver._call

    def call(self, rows, tag):
        ds, view, res = orig(self, rows, tag)
        answers = dict(res["best"]["answers"])
        qids = sorted(answers)
        if kind == "altered":
            answers[qids[0]] = answers[qids[0]] + " w1"
        elif kind == "halved":
            for q in qids[len(qids) // 2:]:
                answers[q] = answers[qids[0]]
        elif kind == "stale":
            prev = getattr(self, "_prev_answers", None)
            self._prev_answers = dict(answers)
            if prev is not None:
                answers = dict(zip(qids, [prev[k] for k in sorted(prev)]))
        res = dict(res, best=dict(res["best"], answers=answers))
        return ds, view, res

    return call


@pytest.mark.parametrize("kind", ["altered", "halved", "stale"])
def test_reader_check_fails_a_broken_timed_path(kind, monkeypatch):
    monkeypatch.setattr(read.Driver, "_call", _reader_fault(kind))
    out, checks = _run("read.top5.q64", check_from=3, check_calls=2)
    assert not out["correct"], checks


# ---- the harness ----------------------------------------------------------------

def test_traced_run_reports_its_per_layer_metrics_on_the_cpu():
    out, _ = _run("single.top100.b256", trace=True)
    assert "breakdown" in out and out["device"]["window_s"] > 0
    assert "mfu.retrieve" in out["metrics"]
    assert list(out)[-1] == "check"


def test_a_cell_metric_and_mix_are_added_as_files_alone(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as new
    files in a copy of the benchmark, run without an edit to any file."""
    root = tmp_path / "tree"
    shutil.copytree(small.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = small.bench()
    cfg = json.loads((root / "portbench/configs/roberta-base.hotpot-5m.json"
                      ).read_text())
    cfg.update(name="tiny.extra", hidden_size=64, num_attention_heads=2,
               intermediate_size=128, num_hidden_layers=1)
    (root / "portbench/configs/tiny.extra.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/single.top100.b256.json"
                     ).read_text())
    tr.update(batch_size=8, topk=10, question_pool=32, warmup_batches=1,
              trace_steps=1, check_from=1, check_batches=1)
    (root / "portbench/traffic/single.extra.json").write_text(json.dumps(tr))
    (root / "portbench/metrics/batches_seen.py").write_text(
        "def read(r):\n    return float(len(r.window))\n")
    bench["workloads"].append({"name": "tiny.single", "config": "tiny.extra",
                               "traffic": "single.extra", "chips": 1,
                               "why": "throwaway"})
    bench["end_to_end"].append({"name": "batches_seen", "unit": "batches",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.single"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.insert(1, {str(small.ROOT)!r})\n"
        "from portbench import harness\n"
        f"bench = json.load(open({str(root / 'BENCHMARK.json')!r}))\n"
        "wl = bench['workloads'][-1]\n"
        "out, _ = harness.run_cell(bench, wl, 5, 0.2, False,"
        " time.perf_counter(), device='cpu',"
        " driver_args={'sizes': {'n_pad': 8192, 'n_docs': 8000,"
        " 'pca_dims': 16}})\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["batches_seen"]["value"] >= 1
    assert "setup_s" in out["metrics"]


def test_run_refuses_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(small.ROOT)}
    res = subprocess.run(
        [sys.executable, str(small.ROOT / "portbench/run.py"), "--workload",
         "mhop.beam1.b192", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """On a card: the first cell, briefly, at its full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, str(small.ROOT / "portbench/run.py"), "--workload",
         "mhop.beam1.b192", "--seed", "977", "--seconds", "3", "--trace",
         "0"], capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert not math.isnan(out["metrics"]["questions_per_s"]["value"])
