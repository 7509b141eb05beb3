"""examples/quickstart_torch.py must stay runnable: the port's documented
tour of the whole pipeline (train -> momentum -> encode -> retrieve ->
read -> export), here with ``--device cpu`` (the kernels' plain
versions; the trainers' ``--data-parallel 2`` on the CPU twice).  Its assertions mirror tests/test_quickstart_example.py."""

import importlib.util
import os

import pytest
import torch


def _load():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(root, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_end_to_end(tmp_path):
    summary = _load().main(["--workdir", str(tmp_path), "--device", "cpu"])
    assert summary["end2end_n"] == 8
    assert summary["answer_em"] is not None
    assert os.path.exists(summary["exported_pt"])
    sd = torch.load(summary["exported_pt"], weights_only=True)
    assert sd and all(torch.isfinite(v).all() for v in sd.values()
                      if v.is_floating_point())
    assert summary["momentum_final_loss"] > 0
    # the JAX tour's --data-parallel 2 on the trainers: the CPU twice
    assert summary["train_mesh"] == \
        "Mesh({'data': 2, 'index': 1}, [['cpu'], ['cpu']])"
    # the exported .pt strict-loads into the serving retriever
    from multihop_dense_retrieval_tpu_torch.cli import common
    common.init_retriever(common.resolve_encoder_config("tiny"),
                          checkpoint=summary["exported_pt"], device="cpu")


def test_quickstart_torch_without_a_card_does_not_fall_back(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load().main(["--workdir", str(tmp_path)])
