"""CLI: multi-process runner (the JAX package's ``cli/pod.py``).

Runs one process per host (or per card) joined into one
``torch.distributed`` group, then the named entry point.  A mesh built
afterwards spans every process (``core/mesh.py``), so ``--index-shards N``
of the eval CLIs shards the index over all of them, and ``encode_corpus``
encodes one slice of the corpus per process, meets at a barrier and merges
on rank 0.  Rank 0 writes the logs and outputs (``cli/common.is_primary``).

The group is gloo; CUDA-tensor collectives go over NCCL when no two
processes share a card, else through host copies over gloo
(``core.mesh.init_pod``, which logs the choice).

Usage: run the same command in every process.

  # with the rendezvous given, varying --process-id per process:
  python -m multihop_dense_retrieval_tpu_torch.cli.pod \\
      --coordinator host0:8476 --num-processes 2 --process-id 0 \\
      encode_corpus CORPUS.jsonl OUT_DIR --model-name roberta-base

  # under torchrun, which sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE:
  torchrun --nproc-per-node 2 -m multihop_dense_retrieval_tpu_torch.cli.pod \\
      --local-device-ids 0 eval_mhop_retrieval QAS.jsonl INDEX_DIR \\
      --index-shards 2

``--local-device-ids`` names the cards this process uses (it sets
``CUDA_VISIBLE_DEVICES`` before CUDA starts).  The retriever trainers
(``train_retriever``, ``train_momentum``, ``train_single``, ``launch``)
raise under more than one process: each process's loader reads the whole
dataset, so the processes would train on duplicated data (the JAX trainer
loop never hands a process its slice of a batch either).  Data-parallel
training runs in one process, ``--data-parallel`` over its cards; the
multi-process train step itself is a library path
(``core.mesh.host_local_batch_to_global`` + a step with ``mesh=``).
"""

import argparse
import importlib
import os
import sys

ENTRY_POINTS = [
    "train_retriever", "train_momentum", "train_single", "train_qa",
    "encode_corpus", "eval_mhop_retrieval", "eval_mhop_fever",
    "eval_retrieval", "eval_reranked", "end2end", "launch",
]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="join a torch.distributed group, then run a CLI")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port (omit under torchrun: "
                        "env:// reads its variables)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-device-ids", default=None,
                   help="comma-separated ids of the cards this process uses")
    p.add_argument("entry", choices=ENTRY_POINTS,
                   help="the CLI to run in every process")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="arguments forwarded to the entry point")
    args = p.parse_args(argv)
    if (args.coordinator is None) != (args.num_processes is None) or \
            (args.num_processes is None) != (args.process_id is None):
        p.error("--coordinator, --num-processes and --process-id go "
                "together (or none of them, under torchrun)")
    if args.local_device_ids is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = args.local_device_ids

    from ..core import mesh
    from ..core.device import world

    if args.coordinator is not None:
        backend = mesh.init_pod(f"tcp://{args.coordinator}",
                                args.num_processes, args.process_id)
    else:
        backend = mesh.init_pod("env://")
    rank, size = world()
    print(f"# pod: process {rank}/{size}, CUDA-tensor collectives over "
          f"{backend}", file=sys.stderr, flush=True)
    mod = importlib.import_module(
        f"multihop_dense_retrieval_tpu_torch.cli.{args.entry}")
    result = mod.main(args.rest)
    mesh.close_pod()
    return result


if __name__ == "__main__":
    main()
