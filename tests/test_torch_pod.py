"""The port's pod runner (``cli/pod.py``) in real processes on the CPU:
the cases of tests/test_more_cli.py::test_pod_runner_single_process and
tests/test_pod_multiprocess.py (the encode and search workers).

Each process is ``python -m multihop_dense_retrieval_tpu_torch.cli.pod``
with a ``tcp://localhost`` rendezvous on a free port; they join one gloo
group (no process here has a card, so CUDA-tensor collectives would go
over gloo too).  Each process has its own ``communicate`` timeout.  The
results must equal the single-process runs of the same CLIs:
  * ``encode_corpus`` in 2 processes (one corpus slice each, a barrier,
    rank 0 merges) writes the index of a single-process ``--num-shards 2``
    encode and ``--merge-only``, bit for bit;
  * ``eval_mhop_retrieval --index-shards 4`` in 2 processes (2 shards
    each, the candidates gathered over gloo in rank order) writes the
    chains of the single-process 4-shard run and of the unsharded one,
    exact and ``--pca``;
  * ``sharded_mips_topk`` and ``sharded_mips_topk_pca`` over a 4-shard
    mesh across 2 processes (the worker below, run as this file) return
    the single-process 4-shard results bit for bit, certificates (the AND
    over shards of two processes) included, on planted rows that certify;
  * one data-parallel train step over a data-8 mesh of 2 processes x 4
    entries (the dp worker) equals the single-process data-8 step.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu_torch.cli import encode_corpus
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_retrieval
from multihop_dense_retrieval_tpu_torch.index.store import DenseIndex
from tests import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = "multihop_dense_retrieval_tpu_torch.cli.pod"
TIMEOUT = 300
RUN = ["--device", "cpu", "--tokenizer", "hash", "--model-name", "tiny"]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(n, entry_argv, command=("-m", POD)):
    """Run ``cli.pod <entry_argv>`` (or ``command``, given the same
    rendezvous flags) in n processes to completion; return their (stdout,
    stderr)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, *command, "--coordinator", f"localhost:{port}",
         "--num-processes", str(n), "--process-id", str(rank)] + entry_argv,
        env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"process failed:\n{out}\n{err[-3000:]}"
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _corpus(tmp_path, n_docs, seed):
    rng = np.random.RandomState(seed)
    docs = synth.make_corpus(rng, n_docs)
    path = str(tmp_path / "corpus.jsonl")
    synth.write_jsonl(path, [{"title": d["title"], "text": d["text"]}
                             for d in docs])
    return path, docs, rng


def test_pod_runner_single_process(tmp_path):
    """cli/pod in one process: it joins a one-process group, reports it,
    and runs the entry point (encode_corpus writes its index)."""
    corpus, _, _ = _corpus(tmp_path, 8, 0)
    out_dir = str(tmp_path / "out")
    (_, err), = _launch(1, ["encode_corpus", corpus, out_dir] + RUN + [
        "--batch-size", "8", "--chunk-rows", "16", "--max-c-len", "32"])
    assert os.path.exists(os.path.join(out_dir, "index.npz"))
    assert "process 0/1" in err and "over gloo" in err


def test_two_process_pod_encode_corpus_matches_single(tmp_path):
    """encode_corpus across 2 processes (auto slice per rank, barrier,
    rank-0 merge) gives the index of a single-process 2-slice encode and
    merge, bit for bit; only rank 0 writes the merged artifacts."""
    corpus, _, _ = _corpus(tmp_path, 24, 7)
    base = RUN + ["--batch-size", "8", "--chunk-rows", "16", "--max-c-len",
                  "32", "--no-length-sort"]
    pod_dir = str(tmp_path / "pod")
    outs = _launch(2, ["encode_corpus", corpus, pod_dir] + base)
    assert all("over gloo" in err for _, err in outs)
    single = str(tmp_path / "single")
    for sid in ("0", "1"):
        encode_corpus.main([corpus, single, "--num-shards", "2",
                            "--shard-id", sid] + base)
    encode_corpus.main([corpus, single, "--merge-only"] + base)
    a = DenseIndex.load(os.path.join(single, "index.npz"), device="cpu")
    b = DenseIndex.load(os.path.join(pod_dir, "index.npz"), device="cpu")
    assert a.n_docs == b.n_docs == 24
    assert torch.equal(a.vectors.view(torch.int16),
                       b.vectors.view(torch.int16))
    assert not [f for f in os.listdir(pod_dir) if "_shard" in f]
    with open(os.path.join(single, "id2doc.json")) as f, \
            open(os.path.join(pod_dir, "id2doc.json")) as g:
        assert json.load(f) == json.load(g)


def test_two_process_sharded_search_matches_single_process(tmp_path):
    """eval_mhop_retrieval --index-shards 4 across 2 processes (2 shards
    each) writes the chains of the single-process 4-shard run and of the
    unsharded run; with --pca, the 4-shard runs' dumps are equal and both
    processes log the same certified share."""
    corpus, docs, rng = _corpus(tmp_path, 1000, 3)
    synth.write_jsonl(tmp_path / "qas.jsonl",
                      synth.make_mhop_rows(rng, docs, n_rows=12))
    index_dir = str(tmp_path / "index")
    encode_corpus.main([corpus, index_dir] + RUN + [
        "--batch-size", "64", "--chunk-rows", "128", "--pca-dims", "16",
        "--pca-cand-rows", "128", "--max-c-len", "48", "--index-dtype",
        "int8"])
    base = [str(tmp_path / "qas.jsonl"), index_dir] + RUN + [
        "--chunk-rows", "128", "--beam-size", "3", "--topk", "3",
        "--batch-size", "4", "--max-q-len", "24", "--max-q-sp-len", "64"]
    for extra in ([], ["--pca", "--pca-k-chunks", "1"]):
        tag = "pca" if extra else "exact"
        pod_path = str(tmp_path / f"pod_{tag}.jsonl")
        outs = _launch(2, ["eval_mhop_retrieval"] + base + extra + [
            "--index-shards", "4", "--save-path", pod_path])
        one_path = str(tmp_path / f"one_{tag}.jsonl")
        eval_mhop_retrieval.main(base + extra + [
            "--index-shards", "4", "--save-path", one_path])
        plain_path = str(tmp_path / f"plain_{tag}.jsonl")
        eval_mhop_retrieval.main(base + extra + ["--save-path", plain_path])
        with open(pod_path) as f, open(one_path) as g:
            pod_rows = f.read()
            assert pod_rows == g.read()
        assert len(pod_rows.splitlines()) == 12
        if not extra:
            with open(plain_path) as f:
                assert pod_rows == f.read()
        else:
            certs = {line.split("certificates: ")[1] for _, err in outs
                     for line in err.splitlines() if "certificates" in line}
            assert len(certs) == 1, certs


def _planted(seed=11, n=4096, d=64, b=16):
    """Anisotropic rows whose tail 1,100 is padding (the last shard of 4
    all padding), PCA built over the valid rows, and queries planted near
    valid rows: most of them certify."""
    rng = np.random.RandomState(seed)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    z = rng.randn(n, 8) * np.linspace(3.0, 0.8, 8)
    emb = (z @ basis[:, :8].T + 0.05 * rng.randn(n, d)).astype(np.float32)
    n_valid = n - 1100
    emb[n_valid:] = 0.0
    q = emb[rng.choice(n_valid, b, replace=False)] \
        + 0.05 * rng.randn(b, d).astype(np.float32)
    index = DenseIndex.build(emb[:n_valid], chunk_rows=512, n_shards=4,
                             dtype="bfloat16", pca_dims=16,
                             pca_cand_rows=128, device="cpu")
    return index, torch.from_numpy(q)


def _mips_on(mesh):
    from multihop_dense_retrieval_tpu_torch.ops import mips as tm

    index, q = _planted()
    idx = index.shard(mesh)
    v, i = tm.sharded_mips_topk(idx.vectors, q, 5, mesh,
                                n_valid=index.n_docs)
    pv, pi, pc = tm.sharded_mips_topk_pca(
        idx.vectors, idx.pca_proj, idx.pca_rot, idx.pca_bounds, q, 3, mesh,
        k_chunks=3, cand_rows=128, n_valid=index.n_docs)
    return dict(v=v, i=i, pv=pv, pi=pi, pc=pc)


def _mips_worker(argv):
    """Join the pod, run both sharded searches over a 4-shard mesh of 2
    shards a process; rank 0 saves the results."""
    import argparse

    from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
    from multihop_dense_retrieval_tpu_torch.core.device import process_index

    p = argparse.ArgumentParser()
    for flag in ("--coordinator", "--num-processes", "--process-id", "out"):
        p.add_argument(flag)
    args = p.parse_args(argv)
    tmesh.init_pod(f"tcp://{args.coordinator}", int(args.num_processes),
                   int(args.process_id))
    mesh = tmesh.make_mesh(index=4, devices=tmesh.pod_devices(
        [torch.device("cpu")] * 2))
    assert mesh.spans_processes and len(mesh.local_shards()) == 2
    out = _mips_on(mesh)
    if process_index() == 0:
        np.savez(args.out, **{k: x.numpy() for k, x in out.items()})
    tmesh.close_pod()
    print("MIPS WORKER OK", flush=True)


def test_two_process_sharded_mips_matches_single_process(tmp_path):
    from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh

    out = str(tmp_path / "pod.npz")
    outs = _launch(2, [out], command=(os.path.abspath(__file__), "mips"))
    assert all("MIPS WORKER OK" in o for o, _ in outs)
    got = np.load(out)
    exp = _mips_on(tmesh.make_mesh(index=4, devices=[torch.device("cpu")] * 4))
    for key, val in exp.items():
        np.testing.assert_array_equal(got[key], val.numpy(), err_msg=key)
    assert got["pc"].mean() >= 0.5, got["pc"]


def _dp_batch(b=8):
    """The 8-row multi-hop train batch of both sides (numpy seeds; ragged
    masks, ids under the tiny vocabulary)."""
    rng = np.random.RandomState(0)
    out = {}
    for name, width in (("q", 12), ("q_sp", 24), ("c1", 16), ("c2", 16),
                        ("neg1", 16), ("neg2", 16)):
        lens = rng.randint(4, width + 1, size=b)
        mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
        ids = np.where(mask > 0, rng.randint(4, 500, size=(b, width)), 1)
        out[f"{name}_input_ids"] = ids.astype(np.int32)
        out[f"{name}_mask"] = mask
    return out


def _dp_state():
    """A seeded tiny retriever (fp32) and its TrainState."""
    from multihop_dense_retrieval_tpu_torch.core.config import (
        EncoderConfig, RetrieverTrainConfig)
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    torch.manual_seed(0)
    model = MhopRetriever(EncoderConfig.tiny(vocab_size=512,
                                             max_position_embeddings=64),
                          cls_only=True, fp32_params=True)
    return T.TrainState.create(model, T.make_optimizer(
        RetrieverTrainConfig(batch_size=8, num_epochs=1), 10))


def _dp_worker(argv):
    """tests/test_pod_multiprocess.py's dp worker: each of 2 processes
    holds 4 data entries of a data-8 mesh and its half of the global
    batch (host_local_batch_to_global), the state replicated
    (replicate_to_global); one train step; rank 0 saves the loss and the
    parameters."""
    import argparse

    from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    p = argparse.ArgumentParser()
    for flag in ("--coordinator", "--num-processes", "--process-id", "out"):
        p.add_argument(flag)
    args = p.parse_args(argv)
    rank = int(args.process_id)
    tmesh.init_pod(f"tcp://{args.coordinator}", int(args.num_processes),
                   rank)
    mesh = tmesh.make_mesh(data=8, index=1, devices=tmesh.pod_devices(
        [torch.device("cpu")] * 4))
    assert [i for i, _ in mesh.data_entries()] == list(range(4 * rank,
                                                             4 * rank + 4))
    local = {k: v[4 * rank:4 * rank + 4] for k, v in _dp_batch().items()}
    batch = tmesh.host_local_batch_to_global(local, mesh)
    state = tmesh.replicate_to_global(_dp_state(), mesh)
    state, loss = T.make_train_step(mesh=mesh)(state, batch)
    if rank == 0:
        np.savez(args.out, loss=loss.numpy(), **{
            k: v.numpy() for k, v in state.model.state_dict().items()})
    tmesh.close_pod()
    print("DP WORKER OK", flush=True)


def test_two_process_dp_step_matches_single_process(tmp_path):
    """tests/test_pod_multiprocess.py's case: one data-parallel step over
    a data-8 mesh of 2 processes x 4 CPU entries (the vectors gathered
    over gloo in rank order, the gradients summed over gloo) equals the
    same step on a single-process mesh of 8 CPU entries: the loss rel
    1e-6, every parameter rtol 1e-6 / atol 1e-7, JAX's criteria."""
    from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    out = str(tmp_path / "pod.npz")
    outs = _launch(2, [out], command=(os.path.abspath(__file__), "dp"))
    assert all("DP WORKER OK" in o for o, _ in outs)
    got = np.load(out)
    state = _dp_state()
    mesh = tmesh.make_mesh(data=8, index=1,
                           devices=[torch.device("cpu")] * 8)
    state, loss = T.make_train_step(mesh=mesh)(
        state, {k: torch.from_numpy(v) for k, v in _dp_batch().items()})
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-6)
    ref = state.model.state_dict()
    assert set(got.files) == set(ref) | {"loss"}
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


if __name__ == "__main__":
    workers = {"mips": _mips_worker, "dp": _dp_worker}
    if sys.argv[1] not in workers:
        raise SystemExit(f"unknown worker {sys.argv[1]}")
    workers[sys.argv[1]](sys.argv[2:])
