"""chip_smoke.py's leg o alone: the port's data- and tensor-parallel
training (o1-o6) on the visible cards.  Where the host shows two or more,
every check also runs over cuda:0 and cuda:1 (the data entries' copy of
the model on cuda:1, the tensor-parallel blocks on two cards, NCCL
between the two processes of o5 and of o6), and the throughput lines
carry each card's peak memory.

Run on a GPU host from the repository root:
  python3 scripts_dev/parallel_training.py
"""

import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("parallel_training: CUDA is not available", file=sys.stderr)
        return 2
    from multihop_dense_retrieval_tpu_torch import (core, data, index,
                                                    models, search)
    from multihop_dense_retrieval_tpu_torch.ops import mips

    smi = chip_smoke.nvidia_smi()
    chip_smoke.say(f"cards: {torch.cuda.device_count()} visible; {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.run_parallel_training(
            (core.config, data, index, models, search), mips,
            torch.device("cuda", 0), smi, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
