"""Tensor parallelism across processes: one TP train step over a (data,
index) mesh whose index axis spans real processes on the CPU (gloo, the
worker pattern of tests/test_torch_pod.py; this file, run as a script, is
the worker).

Two pods run once, for every test here:
  * 2 processes x 4 CPU entries, a (data 2, index 4) mesh: rank 0 holds
    shards 0-1 of both data rows, rank 1 shards 2-3, so the row-parallel
    sums and the column input's gradient cross the processes (the index
    group is both ranks) and the data group is each process alone.  From
    JAX's initial weights and tests/test_parallel.py's batch, the step
    must equal JAX's TP step at (2, 4) by tests/test_parallel.py's
    criteria (loss rel 1e-5, ``_assert_jax_criteria``) and the
    single-process port step on ``[cpu] * 8`` (loss rel 1e-6, every
    parameter rtol 1e-6 / atol 1e-7: tests/test_torch_pod.py's DP
    criteria).
  * 4 processes x 1 entry, a (data 2, index 2) mesh: ranks 0-1 hold data
    row 0, ranks 2-3 row 1, so both groups have two processes.  From
    seeded weights and a ragged batch, the step must equal the
    single-process (2, 2) step by the same criteria.

In both, every rank's replicated parameters after the step are bit-equal
to every other rank's, and ``reference_state_dict`` (the blocks gathered
over the index group) gives the unsplit layout bit for bit on every rank:
before the step the initial weights, after it one state dict on all ranks.
"""

import argparse
import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
# tests/test_torch_parallel.py's TP_KW
TP_KW = dict(vocab_size=256, hidden_size=32, num_heads=4, intermediate_size=64,
             max_position_embeddings=40)
# (processes, entries a process, data, index, shards a process a row)
PODS = {"2x4": (2, 4, 2, 4, 2), "4x1": (4, 1, 2, 2, 1)}


def _layout(entries, n_procs, data, index, per):
    """``entries`` (pod_devices' (rank, device), rank by rank) in the
    mesh's row-major order: each data row's shards in runs of ``per`` a
    process, the rows split evenly over the groups of processes."""
    by_rank = {}
    for e in entries:
        by_rank.setdefault(e[0], []).append(e)
    procs_per_row = index // per
    rows_per_group = data // (n_procs // procs_per_row)
    out = []
    for i in range(data):
        first = (i // rows_per_group) * procs_per_row
        out += [by_rank[first + s // per].pop(0) for s in range(index)]
    return out


def _tp_worker(argv):
    """Join the pod, lay the saved base model out over the mesh of
    ``PODS[pod]``, take one TP step on this process's rows (those of the
    data rows it touches, host_local_batch_to_global) from the replicated
    state (replicate_to_global), and save: the loss, whether the gathered
    reference layout equalled the base bit for bit before the step, the
    gathered layout after it and the local replicated parameters."""
    from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
    from multihop_dense_retrieval_tpu_torch.core.config import (
        EncoderConfig, RetrieverTrainConfig)
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    p = argparse.ArgumentParser()
    for flag in ("--coordinator", "--num-processes", "--process-id", "work",
                 "pod"):
        p.add_argument(flag)
    args = p.parse_args(argv)
    rank, n_procs = int(args.process_id), int(args.num_processes)
    _, k, data, index, per = PODS[args.pod]
    tmesh.init_pod(f"tcp://{args.coordinator}", n_procs, rank)
    entries = tmesh.pod_devices([torch.device("cpu")] * k)
    mesh = tmesh.make_mesh(data=data, index=index, devices=_layout(
        entries, n_procs, data, index, per))
    rows = [i for i, _ in mesh.data_entries(tensor_parallel=True)]
    base = torch.load(os.path.join(args.work, "base.pt"), weights_only=True)
    batch = dict(np.load(os.path.join(args.work, "batch.npz")))
    b = next(iter(batch.values())).shape[0] // data
    local = {key: np.concatenate([v[i * b:(i + 1) * b] for i in rows])
             for key, v in batch.items()}
    model = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    model.load_state_dict(base)
    shard_params(model, mesh)
    init = T.reference_state_dict(model)
    init_equal = list(init) == list(base) and all(
        torch.equal(init[key], v) for key, v in base.items())
    state = tmesh.replicate_to_global(T.TrainState.create(
        model, T.make_optimizer(RetrieverTrainConfig(
            warmup_ratio=0.0, learning_rate=LR), 10)), mesh)
    state, loss = T.make_train_step(mesh=mesh, tensor_parallel=True)(
        state, tmesh.host_local_batch_to_global(local, mesh))
    after = T.reference_state_dict(state.model)
    rep = {key: v for key, v in state.model.state_dict().items()
           if not key.rpartition(".")[2].isdigit()}
    np.savez(os.path.join(args.work, f"out_{rank}.npz"), loss=loss.numpy(),
             init_equal=init_equal,
             **{f"sd/{key}": v.numpy() for key, v in after.items()},
             **{f"rep/{key}": v.numpy() for key, v in rep.items()})
    tmesh.close_pod()
    print("TP WORKER OK", flush=True)


def _start(work, pod):
    from tests.test_torch_pod import _free_port

    n = PODS[pod][0]
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "tp", "--coordinator",
         f"localhost:{port}", "--num-processes", str(n), "--process-id",
         str(rank), str(work), pod],
        env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(n)]


def _finish(procs, timeout=300):
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0 and "TP WORKER OK" in out, \
                f"process failed:\n{out}\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _save_inputs(work, base, batch):
    os.makedirs(work, exist_ok=True)
    torch.save(base.state_dict(), os.path.join(work, "base.pt"))
    np.savez(os.path.join(work, "batch.npz"), **batch)


def _outputs(work, n):
    outs = []
    for rank in range(n):
        f = np.load(os.path.join(work, f"out_{rank}.npz"))
        outs.append({"loss": float(f["loss"]),
                     "init_equal": bool(f["init_equal"]),
                     "sd": {k[3:]: f[k] for k in f.files
                            if k.startswith("sd/")},
                     "rep": {k[4:]: f[k] for k in f.files
                             if k.startswith("rep/")}})
    return outs


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Both pods' results, each beside its single-process step (loss, the
    reference layout) and, for 2x4, JAX's (loss, parameters)."""
    import jax

    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.models import (
        MhopRetriever, retriever_state_dict_from_jax)
    from tests.test_torch_parallel import (_cpu_mesh, _jax_tp_init,
                                           _jax_tp_steps, _tp_batch, _tp_run)
    from tests.test_torch_train import _mhop_batch

    root = tmp_path_factory.mktemp("tp_pod")
    torch.manual_seed(0)
    ragged = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    init = _jax_tp_init()
    base = MhopRetriever(EncoderConfig.tiny(**TP_KW), fp32_params=True)
    base.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(init[2])))
    inputs = {"4x1": (ragged, _mhop_batch(1, b=8)), "2x4": (base, _tp_batch())}
    running = []
    for pod, (model, batch) in inputs.items():
        _save_inputs(root / pod, model, batch)
        running.append(_start(root / pod, pod))
    # JAX's step and the single-process steps while the pods run
    _, jloss, jtp = _jax_tp_steps(init)
    single = {}
    for pod, (model, batch) in inputs.items():
        _, _, data, index, _ = PODS[pod]
        single[pod] = _tp_run(model, batch, _cpu_mesh(data, index))[:2]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        list(ex.map(_finish, running))
    out = {pod: {"ranks": _outputs(root / pod, PODS[pod][0]),
                 "single": single[pod], "base": model.state_dict()}
           for pod, (model, _) in inputs.items()}
    out["2x4"]["jax"] = (jloss, retriever_state_dict_from_jax(jtp))
    return out


def test_two_process_tp_step_matches_jax(pods):
    """2 processes x 4 entries, (data 2, index 4), the index axis across
    the processes: JAX's TP step at (2, 4) by tests/test_parallel.py's
    criteria."""
    from tests.test_torch_parallel import _assert_jax_criteria

    got = pods["2x4"]["ranks"][0]
    jloss, exp = pods["2x4"]["jax"]
    assert got["loss"] == pytest.approx(jloss, rel=1e-5)
    assert set(got["sd"]) == set(exp)
    _assert_jax_criteria({k: torch.from_numpy(v)
                          for k, v in got["sd"].items()}, exp)


@pytest.mark.parametrize("pod", sorted(PODS))
def test_tp_step_across_processes_matches_single_process(pods, pod):
    """Each pod's step equals the single-process port step on a mesh of
    the same shape over ``[cpu] * n``: the loss rel 1e-6, every parameter
    rtol 1e-6 / atol 1e-7 (the DP pod test's criteria), on every rank."""
    loss, sd = pods[pod]["single"]
    for got in pods[pod]["ranks"]:
        assert got["loss"] == pytest.approx(loss, rel=1e-6)
        assert list(got["sd"]) == list(sd)
        for k, v in sd.items():
            np.testing.assert_allclose(got["sd"][k], v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("pod", sorted(PODS))
def test_tp_replicated_parameters_are_bit_equal_across_ranks(pods, pod):
    """Every replicated parameter (embeddings, LayerNorms, the
    row-parallel biases) comes out of the step the same on every rank,
    bit for bit: the column input's gradient is summed over the index
    group in one order on every process, and the data group's sums are
    the same everywhere."""
    ranks = pods[pod]["ranks"]
    first = ranks[0]["rep"]
    assert any("LayerNorm" in k for k in first)
    assert any(k.endswith("output.dense.bias") for k in first)
    for got in ranks[1:]:
        assert list(got["rep"]) == list(first)
        for k, v in first.items():
            assert np.array_equal(got["rep"][k], v), k


@pytest.mark.parametrize("pod", sorted(PODS))
def test_tp_gathered_state_dict_is_the_reference_layout_on_every_rank(pods, pod):
    """``reference_state_dict`` of a model split across processes (its
    blocks gathered over the index group) is the unsplit model's, bit for
    bit, on every rank before the step; after it every rank gets the same
    state dict, bit for bit, under the unsplit names."""
    ranks = pods[pod]["ranks"]
    base = pods[pod]["base"]
    assert all(got["init_equal"] for got in ranks)
    for got in ranks:
        assert list(got["sd"]) == list(base)
        for k, v in ranks[0]["sd"].items():
            assert got["sd"][k].shape == tuple(base[k].shape), k
            assert np.array_equal(got["sd"][k], v), k


if __name__ == "__main__":
    if sys.argv[1] != "tp":
        raise SystemExit(f"unknown worker {sys.argv[1]}")
    _tp_worker(sys.argv[2:])
