"""Retriever training: the optimizer, the train states, the step functions
and the epoch loop (the JAX package's ``train/trainer.py``).

  * The optimizer is the JAX package's optax chain, algebra for algebra:
    a global-norm clip (optax's rule: ``(g / norm) * max_norm`` only when
    ``norm >= max_norm``), coupled weight decay on every parameter but
    biases and LayerNorm parameters, Adam (eps after the bias correction)
    and a linear warmup + linear decay schedule that gives lr 0 at the
    first update when there is a warmup.  ``gradient_accumulation = k``
    is ``optax.MultiSteps``: the running mean of k micro-batch gradients,
    one optimizer step per k calls, the schedule counting optimizer steps.
  * A train state holds the model, whose fp32 parameters are the master
    weights (the encoder computes in ``config.dtype``), the optimizer
    state and the step count.  ``MomentumTrainState`` adds the frozen key
    encoder (a deep copy, run under ``torch.no_grad``) and the (K, h)
    queue with its pointer; ``TokenQueueTrainState`` a queue of token
    rows that the current encoder re-encodes every step.
  * A step is a plain function ``step(state, batch) -> (state, loss)``
    that updates the state in place; the loss stays on the device.
  * ``mesh=`` on a step makes it data-parallel (``DataParallel``): each
    data entry encodes its slice of the batch, the vectors are gathered
    in data-axis order and the loss is computed once on the global batch
    (in-batch negatives stay global), so the step's math is the
    single-device step's at every scale; the gradient is that of the
    global loss, summed over the replicas in a fixed order before one
    clip and one update.  ``tensor_parallel=True`` on ``make_train_step``
    also splits the attention heads and the FFN over the index axis
    (``parallel/sharding.py``), across processes too.
  * ``RetrieverTrainer.run`` is the epoch loop: in-batch MRR after every
    epoch, ``checkpoint_last.pt`` / ``checkpoint_best.pt`` as state dicts
    in the reference layout (the serving CLIs' ``--checkpoint`` reads
    them), and a full-state save after every epoch for a preemption
    resume.

The encoder must run ``attention_impl="xla"`` (or ``"flash"``, the same
path): kernel 8 (``"fused"``) has no backward, and ``jax.grad`` through
the JAX package's Pallas kernel raises as well.
"""

from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.config import RetrieverTrainConfig
from ..core.mesh import (DATA_AXIS, Mesh, all_gather, all_reduce_sum,
                         gather_rows, on_device)
from ..models.export import unified_reference_names
from ..models.retriever import UnifiedRetriever
from ..parallel.sharding import (ShardedLinear, constrain_params,
                                 gather_state_dict)
from . import losses


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------


def no_decay_names(model: nn.Module):
    """Names of the parameters that get no weight decay: every bias and
    every LayerNorm parameter (the reference's no-decay group)."""
    out = set()
    for mod_name, mod in model.named_modules():
        # a tensor-parallel bias is a list of blocks named "bias"
        is_bias = mod_name.rpartition(".")[2] == "bias"
        for name, _ in mod.named_parameters(recurse=False):
            if name == "bias" or is_bias or isinstance(mod, nn.LayerNorm):
                out.add(f"{mod_name}.{name}" if mod_name else name)
    return out


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule(init, end, steps)(count)``, in fp32 as optax
    computes it."""
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return float(np.float32(init - end) * frac + np.float32(end))


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int
                           ) -> Callable[[int], float]:
    """count (optimizer updates so far) -> learning rate."""
    if warmup_steps <= 0:
        total = max(total_steps, 1)
        return lambda count: _linear(lr, 0.0, total, count)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, lr, warmup_steps, count)
        return _linear(lr, 0.0, decay, count - warmup_steps)

    return schedule


def _by_device(tensors) -> dict:
    """device → the indices of ``tensors`` on it, in order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, split=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place, without a host sync:
    every gradient becomes ``(g / norm) * max_norm`` when the global norm
    is >= ``max_norm`` and stays as it is below.  Gradients on several
    devices (tensor-parallel blocks): the per-tensor norms are reduced,
    in the gradients' order, on the first gradient's device.  ``split``
    = (mask, index group), where other processes hold some blocks: the
    squares of the gradients that ``mask`` marks (this process's blocks)
    are summed over the group, in rank order, and each of the others
    (replicated) is added once, so every process clips by the same norm.
    Returns the norm."""
    home = grads[0].device
    groups = _by_device(grads)
    norms = [None] * len(grads)
    for idx in groups.values():
        for i, n in zip(idx, torch._foreach_norm([grads[i] for i in idx])):
            norms[i] = n.to(home)
    if split is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        mask, group = split
        sq = torch.stack(norms) ** 2
        blocks = sq[torch.tensor(mask, device=home)].sum().reshape(1)
        total = sq[torch.tensor([not m for m in mask], device=home)].sum()
        for part in all_gather(blocks, 0, group):
            total = total + part
        norm = torch.sqrt(total)
    keep = norm < max_norm
    div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, max_norm)
    for dev, idx in groups.items():
        group = [grads[i] for i in idx]
        torch._foreach_div_(group, div.to(dev))
        torch._foreach_mul_(group, mul.to(dev))
    return norm


def _split(model: nn.Module, params) -> Optional[tuple]:
    """(which of ``params`` are blocks that other processes' blocks
    complete, the index group) of a model laid out across processes;
    None elsewhere."""
    mods = [m for m in model.modules()
            if isinstance(m, ShardedLinear) and m.group is not None]
    if not mods:
        return None
    blocks = {id(p) for m in mods for p in m.blocks()}
    return [id(p) in blocks for p in params], mods[0].group


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optimizer's hyperparameters (the optax chain, before ``init``)."""

    cfg: RetrieverTrainConfig
    total_steps: int

    @property
    def schedule(self) -> Callable[[int], float]:
        cfg = self.cfg
        return linear_warmup_schedule(
            cfg.learning_rate, int(self.total_steps * cfg.warmup_ratio),
            self.total_steps)

    def init(self, model: nn.Module) -> "OptState":
        return OptState(self, model)


class OptState:
    """Adam over a model's trainable parameters in two groups (coupled
    decay, no decay), the schedule as a ``LambdaLR`` stepped after every
    update, and the gradient accumulator."""

    def __init__(self, tx: Optimizer, model: nn.Module):
        self.tx = tx
        cfg = tx.cfg
        skip = no_decay_names(model)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        self.split = _split(model, self.params)
        groups = [{"params": [p for n, p in named if n not in skip],
                   "weight_decay": cfg.weight_decay},
                  {"params": [p for n, p in named if n in skip],
                   "weight_decay": 0.0}]
        # lr 1.0 times the schedule's value: the group's lr IS the schedule
        self.adam = torch.optim.Adam(groups, lr=1.0, betas=(0.9, 0.999),
                                     eps=cfg.adam_eps)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.adam, tx.schedule)
        self.max_grad_norm = cfg.max_grad_norm
        self.k = max(cfg.gradient_accumulation, 1)
        self.mini_step = 0
        self.acc = None

    @property
    def count(self) -> int:
        """Optimizer updates so far."""
        return self.sched.last_epoch

    def update(self) -> bool:
        """Consume the gradients in the parameters' ``.grad``; returns
        whether the parameters moved (False on a non-final micro-step)."""
        for p in self.params:
            if p.grad is None:        # a parameter the loss never reached
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.copy_(a + (g - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                self.adam.zero_grad(set_to_none=True)
                return False
            for g, a in zip(grads, self.acc):
                g.copy_(a)
                a.zero_()
        clip_by_global_norm(grads, self.max_grad_norm, self.split)
        self.adam.step()
        self.sched.step()
        self.adam.zero_grad(set_to_none=True)
        return True

    def follow(self, model: nn.Module) -> "OptState":
        """This optimizer state, or, where ``model``'s parameters are no
        longer the ones it holds (a tensor-parallel step lays the model out
        at its first call), a fresh one over them.  A state that has
        already stepped cannot follow: lay the model out first."""
        params = [p for p in model.parameters() if p.requires_grad]
        if len(params) == len(self.params) and all(
                p is q for p, q in zip(params, self.params)):
            return self
        if self.count or self.mini_step or self.adam.state:
            raise ValueError("the model's parameters changed after the "
                             "optimizer stepped: lay the model out "
                             "(parallel.shard_params) before its first "
                             "update")
        return OptState(self.tx, model)

    def to(self, device) -> "OptState":
        """Adam's moments and the accumulator moved to ``device``."""
        for st in self.adam.state.values():
            for k, v in st.items():
                if torch.is_tensor(v) and k != "step":
                    st[k] = v.to(device)
        if self.acc is not None:
            self.acc = [a.to(device) for a in self.acc]
        return self

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(),
                "sched": self.sched.state_dict(),
                "mini_step": self.mini_step,
                "acc": self.acc if self.acc is not None else []}

    def load_state_dict(self, sd: Dict):
        self.adam.load_state_dict(sd["adam"])
        self.sched.load_state_dict(sd["sched"])
        self.mini_step = int(sd["mini_step"])
        self.acc = [a.to(p.device) for a, p in zip(sd["acc"], self.params)] \
            or None


def make_optimizer(cfg: RetrieverTrainConfig, total_steps: int) -> Optimizer:
    return Optimizer(cfg, total_steps)


# --------------------------------------------------------------------------
# Train states
# --------------------------------------------------------------------------


def _check_trainable(model: nn.Module):
    if model.config.attention_impl == "fused":
        raise ValueError(
            "attention_impl='fused' cannot be trained: kernel 8 has no "
            "backward (the JAX package's Pallas kernel has none either, and "
            "jax.grad through it raises); train with attention_impl='xla'")


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class TrainState:
    """The model (its parameters are the trained state), the optimizer
    state and the step count."""

    def __init__(self, model: nn.Module, opt: OptState):
        self.model = model
        self.opt = opt
        self.step = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        _check_trainable(model)
        return cls(model, tx.init(model))

    def to(self, device) -> "TrainState":
        """The state moved to ``device``, in place (a pod's replicated
        state, ``core.mesh.replicate_to_global``)."""
        self.model.to(device)
        self.opt.to(device)
        return self

    def state_dict(self) -> Dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict):
        self.model.load_state_dict(sd["params"])
        self.opt.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def _frozen_copy(model: nn.Module) -> nn.Module:
    model_k = copy.deepcopy(model).eval()
    model_k.requires_grad_(False)
    return model_k


class MomentumTrainState(TrainState):
    """``model`` is encoder_q (trained); ``model_k`` is encoder_k (a frozen
    copy, or an EMA of encoder_q); ``queue`` the (K, h) memory bank.  The
    queue starts as N(0, 1) draws from a ``torch.Generator`` seeded with
    ``seed`` on the model's device (the JAX package draws it with
    ``jax.random``, which torch cannot reproduce)."""

    def __init__(self, model, opt, model_k, queue, queue_ptr=0):
        super().__init__(model, opt)
        self.model_k = model_k
        self.queue = queue
        self.queue_ptr = queue_ptr

    @classmethod
    def create(cls, model, tx, queue_size: int, hidden: int, seed: int = 0
               ) -> "MomentumTrainState":
        _check_trainable(model)
        dev = _device(model)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        queue = torch.randn((queue_size, hidden), generator=gen, device=dev,
                            dtype=torch.float32)
        return cls(model, tx.init(model), _frozen_copy(model), queue)

    def to(self, device) -> "MomentumTrainState":
        super().to(device)
        self.model_k.to(device)
        self.queue = self.queue.to(device)
        return self

    def state_dict(self) -> Dict:
        return dict(super().state_dict(), params_k=self.model_k.state_dict(),
                    queue=self.queue, queue_ptr=self.queue_ptr)

    def load_state_dict(self, sd: Dict):
        super().load_state_dict(sd)
        self.model_k.load_state_dict(sd["params_k"])
        self.queue.copy_(sd["queue"])
        self.queue_ptr = int(sd["queue_ptr"])


class TokenQueueTrainState(TrainState):
    """Single-hop momentum state: a memory bank of raw TOKEN rows that the
    CURRENT encoder re-encodes every step (the reference's
    MomentumRetriever), so its vectors never go stale.  Slots start as
    empty-but-valid ``[CLS][SEP]`` rows (an all-zero mask would be a
    softmax over nothing)."""

    def __init__(self, model, opt, queue_ids, queue_mask, queue_type,
                 queue_ptr=0):
        super().__init__(model, opt)
        self.queue_ids = queue_ids
        self.queue_mask = queue_mask
        self.queue_type = queue_type
        self.queue_ptr = queue_ptr

    @classmethod
    def create(cls, model, tx, queue_size: int, max_c_len: int,
               cls_id: int = 101, sep_id: int = 102
               ) -> "TokenQueueTrainState":
        _check_trainable(model)
        dev = _device(model)
        ids = torch.zeros((queue_size, max_c_len), dtype=torch.int32,
                          device=dev)
        ids[:, 0], ids[:, 1] = cls_id, sep_id
        mask = torch.zeros_like(ids)
        mask[:, :2] = 1
        return cls(model, tx.init(model), ids, mask, torch.zeros_like(ids))

    def to(self, device) -> "TokenQueueTrainState":
        super().to(device)
        for name in ("queue_ids", "queue_mask", "queue_type"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def state_dict(self) -> Dict:
        return dict(super().state_dict(), queue_ids=self.queue_ids,
                    queue_mask=self.queue_mask, queue_type=self.queue_type,
                    queue_ptr=self.queue_ptr)

    def load_state_dict(self, sd: Dict):
        super().load_state_dict(sd)
        for name in ("queue_ids", "queue_mask", "queue_type"):
            getattr(self, name).copy_(sd[name])
        self.queue_ptr = int(sd["queue_ptr"])


def _enqueue_tokens(state: TokenQueueTrainState, ids, mask, type_ids):
    """Write the batch's context token rows into the queue at its pointer
    (wrapping, as ``losses.enqueue``), cut or zero-padded to the queue's
    width.  A batch larger than the queue keeps its LAST K rows."""
    K, L = state.queue_ids.shape
    if ids.shape[0] > K:
        ids, mask, type_ids = ids[-K:], mask[-K:], type_ids[-K:]
    n, lb = ids.shape

    def fit(x):
        x = x.to(state.queue_ids.dtype)
        return x[:, :L] if lb >= L else nn.functional.pad(x, (0, L - lb))

    idx = (state.queue_ptr + torch.arange(n, device=ids.device)) % K
    state.queue_ids[idx] = fit(ids)
    state.queue_mask[idx] = fit(mask)
    state.queue_type[idx] = fit(type_ids)
    state.queue_ptr = (state.queue_ptr + n) % K
    return state


# --------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------


def to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def _layout(model: nn.Module) -> tuple:
    """The model's devices: its first parameter's, then those of its
    tensor-parallel blocks, if any."""
    home = _device(model)
    for mod in model.modules():
        if isinstance(mod, ShardedLinear):
            return (home,) + mod.devices
    return (home,)


def _placed_copy(model: nn.Module, layout: tuple) -> nn.Module:
    """A copy of ``model`` on ``layout``'s devices (``_layout``'s form)."""
    twin = copy.deepcopy(model).to(layout[0])
    with torch.no_grad():
        for mod in twin.modules():
            if isinstance(mod, ShardedLinear):
                split = [mod.weight] + ([mod.bias] if mod.dim == 0 else [])
                for s, dev in enumerate(layout[1:]):
                    for blocks in split:
                        blocks[s].data = blocks[s].data.to(dev)
    return twin


class DataParallel:
    """A step's spread over a mesh's data axis (the JAX steps'
    ``in_shardings=P("data")``).

    Each of this process's data entries (``Mesh.data_entries``) encodes
    its slice of the batch on a replica of the model; the outputs are
    gathered in data-axis order, across processes too
    (``core.mesh.gather_rows``), onto the model's device, where the loss
    is computed once on the global batch: in-batch negatives stay global.
    ``reduce_grads`` sums each replica's gradient of that loss into the
    model's, replica by replica in entry order, then over the processes
    (``core.mesh.all_reduce_sum``); one clip and one Adam update follow.

    The first entry on the model's own devices computes on the model
    itself; every other entry on a twin of its own (``replicas``): on the
    model's devices its parameters share the model's storage (a mesh of
    ``[cpu] * 8`` computes every slice with the one set of parameters, as
    the JAX tests' 8 virtual devices each compute with the same
    replicated parameters), elsewhere it is a copy made once and set to
    the model's parameters before every use, so it equals the model
    whenever it computes.  Each entry's gradient thus collects on its
    own before the entries' are added, in entry order.

    With ``tensor_parallel`` an entry is a whole data row, or this
    process's shards of it, its index shards holding the blocks
    (``parallel/sharding.py``); the rows are then gathered, and the
    gradients summed, over the data group only (``Mesh.axis_groups``: the
    processes that hold this process's shard positions), since the
    processes of one data row hold the same rows and the same replicated
    gradients."""

    def __init__(self, mesh: Mesh, tensor_parallel: bool = False):
        self.tp = tensor_parallel
        self.n_data = mesh.shape[DATA_AXIS]
        if tensor_parallel:
            self.entries = [(i, tuple(d for _, d in shards)) for i, shards
                            in mesh.data_entries(tensor_parallel=True)]
            self.group = mesh.axis_groups()[1]
            self.across = self.group.size > 1
        else:
            self.entries = mesh.data_entries()
            self.group = None
            self.across = len(self.entries) < self.n_data
        self._copies = weakref.WeakKeyDictionary()

    def split(self, batch: Dict) -> list:
        """The batch's rows cut into one equal slice per data entry, each
        on its entry's device.  A batch whose rows do not split raises."""
        rows = {torch.as_tensor(v).shape[0] for v in batch.values()}
        n = len(self.entries)
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"a batch of {sorted(rows)} rows does not split "
                             f"over {n} data entries (of {self.n_data} on "
                             f"the data axis)")
        part = next(iter(rows)) // n
        return [{k: torch.as_tensor(v)[j * part:(j + 1) * part].to(
                     devs[0], non_blocking=True) for k, v in batch.items()}
                for j, (_, devs) in enumerate(self.entries)]

    def replicas(self, model: nn.Module) -> list:
        """The replica of each entry: the model itself for the first
        entry on the model's own devices; for every other entry a twin of
        its own, made once: on the model's devices one whose parameters
        share the model's storage, elsewhere a copy set to the model
        before every use.  So each entry's gradient collects on its own,
        and ``reduce_grads`` adds the entries' in entry order."""
        own = _layout(model)
        twins = self._copies.setdefault(model, {})
        shapes = [p.shape for p in model.parameters()]
        out = []
        for j, (_, devs) in enumerate(self.entries):
            want = (devs[0],) + (devs if self.tp else ())
            if want == own and not any(m is model for m in out):
                out.append(model)
                continue
            twin = twins.get(j)
            if twin is None or [p.shape for p in twin.parameters()] != shapes:
                # never an inference tensor: an eval may make the twin
                with torch.inference_mode(False):
                    twin = twins[j] = _placed_copy(model, want)
            with torch.no_grad():
                for a, b in zip(twin.parameters(), model.parameters()):
                    if want == own:
                        a.data = b.data
                    else:
                        a.copy_(b, non_blocking=True)
            out.append(twin)
        return out

    def rows(self, tensors: Dict, home: torch.device) -> Dict:
        """Each entry's rows (a dict of tensors, None kept), joined in
        data-axis order on ``home``, then over the processes (of the data
        group, tensor-parallel)."""
        out = {}
        for k, v in tensors.items():
            if v is not None:
                v = torch.as_tensor(v).to(home)
                v = gather_rows(v, self.group) if self.across else v
            out[k] = v
        return out

    def forward(self, model: nn.Module, batch: Dict, fn: Callable) -> Dict:
        """``fn(replica, slice)`` -> a dict of per-row tensors (or None) on
        each entry, joined into the global batch's on the model's
        device."""
        outs = []
        for (_, devs), twin, part in zip(self.entries, self.replicas(model),
                                         self.split(batch)):
            with on_device(devs[0]):
                outs.append(fn(twin, part))
        home = _device(model)
        return self.rows({k: None if outs[0][k] is None else
                          torch.cat([o[k].to(home) for o in outs])
                          for k in outs[0]}, home)

    def reduce_grads(self, model: nn.Module):
        """The gradients of the global loss, summed into ``model``'s: its
        own, then each twin's in entry order, then over the processes (of
        the data group, tensor-parallel)."""
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:        # a parameter the loss never reached
                p.grad = torch.zeros_like(p)
        twins = self._copies.get(model, {})
        for j in sorted(twins):
            for p, q in zip(model.parameters(), twins[j].parameters()):
                if q.grad is not None:
                    p.grad += q.grad.to(p.device)
                    q.grad = None
        if self.across:
            all_reduce_sum([p.grad for p in params], self.group)


def _data_parallel(mesh: Optional[Mesh], tensor_parallel: bool = False
                   ) -> Optional[DataParallel]:
    return None if mesh is None else DataParallel(mesh, tensor_parallel)


def _outputs(dp: Optional[DataParallel], model: nn.Module, batch: Dict,
             fn: Callable = None) -> Dict:
    """``fn(model, batch)`` (default ``model(batch)``), over the data axis
    where there is one."""
    fn = fn or (lambda m, b: m(b))
    return fn(model, batch) if dp is None else dp.forward(model, batch, fn)


def _batch_rows(dp: Optional[DataParallel], batch: Dict, keys, model):
    """The global batch's ``keys`` (those present) on the model's
    device."""
    keys = {k: batch[k] for k in keys if k in batch}
    return keys if dp is None else dp.rows(keys, _device(model))


def _apply(state: TrainState, loss: torch.Tensor,
           dp: Optional[DataParallel] = None):
    loss.backward()
    if dp is not None:
        dp.reduce_grads(state.model)
    state.opt.update()
    state.step += 1
    return loss.detach()


def make_train_step(*, unified: bool = False, task: str = None,
                    mesh: Optional[Mesh] = None,
                    tensor_parallel: bool = False) -> Callable:
    """Returns ``step(state, batch) -> (state, loss)``.

    task: "mhop" (default) | "unified" | "single" (DPR) | "nq" (the
    error-recovery variants).  ``mesh``: the batch is split over the data
    axis (``DataParallel``); ``tensor_parallel`` also lays the model's
    attention heads and FFN out over the index axis at the first call
    (``parallel.constrain_params``): dp × tp in one step."""
    task = task or ("unified" if unified else "mhop")
    dp = _data_parallel(mesh, tensor_parallel)

    def loss_fn(outputs, batch):
        if task == "unified":
            return losses.unified_loss(outputs, batch["stop_targets"])
        if task == "single":
            return losses.single_loss(outputs)
        if task == "nq":
            return losses.nq_mhop_loss(outputs)
        return losses.mhop_loss(outputs)

    def step(state: TrainState, batch):
        if tensor_parallel and mesh is not None:
            constrain_params(state.model, mesh)
            state.opt = state.opt.follow(state.model)
        outputs = _outputs(dp, state.model, batch)
        rows = _batch_rows(dp, batch, ("stop_targets",), state.model)
        return state, _apply(state, loss_fn(outputs, rows), dp)

    return step


def _encode(model, batch, keys):
    return {name: model.encode_seq(batch[f"{pref}input_ids"],
                                   batch[f"{pref}mask"])
            for name, pref in keys}


def _views(dp, model, batch, keys):
    return _outputs(dp, model, batch, lambda m, b: _encode(m, b, keys))


_MHOP_Q = (("q", "q_"), ("q_sp1", "q_sp_"))
_MHOP_CTX = (("c1", "c1_"), ("c2", "c2_"), ("neg_1", "neg1_"),
            ("neg_2", "neg2_"))


def make_momentum_train_step(*, enable_ema: bool = False,
                             momentum_m: float = 0.999,
                             mesh: Optional[Mesh] = None,
                             task: str = "mhop") -> Callable:
    """Stage-2 memory-bank step.  The queue scores use the PRE-update
    queue; the batch's context vectors (from the key encoder) are enqueued
    after the optimizer step.  ``enable_ema=False`` matches the shipped
    reference (a frozen key encoder).  ``mesh``: both encoders' views are
    split over the data axis, and the GLOBAL batch's context vectors are
    enqueued, in global order, so every process holds the same queue.

    task="nq" is the BertNQMomentumRetriever composition: queries (q,
    q_neg1) through the trained encoder, contexts (c, neg) through the key
    encoder, queue negatives in the recovery loss; the model is then an
    NQRetriever."""
    dp = _data_parallel(mesh)
    if task == "nq":
        q_keys = [("q", "q_"), ("q_neg1", "q_neg1_")]
        ctx_keys = [("c", "c_"), ("neg", "neg_")]
        loss_of = losses.nq_mhop_loss
        def enqueue_of(ctx):
            return ctx["c"]
    else:
        q_keys, ctx_keys = _MHOP_Q, _MHOP_CTX
        loss_of = losses.mhop_loss
        def enqueue_of(ctx):
            return torch.cat([ctx["c1"], ctx["c2"]])

    def step(state: MomentumTrainState, batch):
        with torch.no_grad():
            ctx = _views(dp, state.model_k, batch, ctx_keys)
        outputs = dict(ctx)
        outputs.update(_views(dp, state.model, batch, q_keys))
        loss = _apply(state, loss_of(outputs, queue=state.queue), dp)
        state.queue, state.queue_ptr = losses.enqueue(
            state.queue, state.queue_ptr, enqueue_of(ctx))
        if enable_ema:
            losses.momentum_update(state.model, state.model_k, momentum_m)
        return state, loss

    return step


def make_single_momentum_train_step(mesh: Optional[Mesh] = None) -> Callable:
    """Single-hop momentum step: the token queue is re-encoded with the
    current encoder (no gradient; on the model's device, whole), its
    vectors are appended as extra negatives, and the batch's context
    TOKENS are enqueued after the update (``mesh``: the global batch's,
    in global order).  The model is a SingleRetriever."""
    dp = _data_parallel(mesh)

    def step(state: TokenQueueTrainState, batch):
        outputs = _outputs(dp, state.model, batch)
        with torch.no_grad():
            queue_c = state.model.encode_ctx(state.queue_ids, state.queue_mask,
                                             state.queue_type)
        loss = _apply(state, losses.single_loss(outputs, queue_c=queue_c), dp)
        rows = _batch_rows(dp, batch, ("c_input_ids", "c_mask", "c_type_ids"),
                           state.model)
        tt = rows.get("c_type_ids")
        if tt is None:
            tt = torch.zeros_like(rows["c_input_ids"])
        _enqueue_tokens(state, rows["c_input_ids"], rows["c_mask"], tt)
        return state, loss

    return step


def make_momentum_eval_step(mesh: Optional[Mesh] = None) -> Callable:
    """Momentum-stage eval: queries via encoder_q, contexts via encoder_k
    (the reference's eval-mode forward)."""
    dp = _data_parallel(mesh)

    @torch.no_grad()
    def step(model_q, model_k, batch):
        outputs = _views(dp, model_q, batch, _MHOP_Q)
        outputs.update(_views(dp, model_k, batch, _MHOP_CTX))
        return losses.mhop_eval(outputs)

    return step


def make_eval_step(*, unified: bool = False, task: str = None,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``step(model, batch)`` -> per-sample reciprocal ranks (of
    the global batch, with a ``mesh``)."""
    task = task or ("unified" if unified else "mhop")
    dp = _data_parallel(mesh)

    @torch.no_grad()
    def step(model, batch):
        outputs = _outputs(dp, model, batch)
        if task == "unified":
            rows = _batch_rows(dp, batch, ("stop_targets",), model)
            return losses.unified_eval(outputs, rows["stop_targets"])
        if task == "single":
            rrs = losses.single_eval(outputs)["rrs"]
            return {"rrs_1": rrs, "rrs_2": rrs}
        return losses.mhop_eval(outputs)

    return step


# --------------------------------------------------------------------------
# Loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EpochStats:
    train_loss: float
    mrr_1: float
    mrr_2: float

    @property
    def mrr_avg(self):
        return (self.mrr_1 + self.mrr_2) / 2


def evaluate_mrr(eval_step, model, loader) -> Dict[str, float]:
    """In-batch MRR over an eval loader.  The padded rows of the last
    batch (``valid`` False) are dropped.  Unified task: single-hop rows
    carry a random negative as their unused c2, so mrr_2 averages the
    multi-hop rows only (``is_mhop``); the stop head's accuracy is
    reported too."""
    dev = _device(model)
    rrs1, rrs2, stop_accs = [], [], []
    for batch in loader:
        valid = batch.pop("valid", None)
        out = {k: v.cpu().numpy()
               for k, v in eval_step(model, to_device(batch, dev)).items()}
        r1, r2 = out["rrs_1"], out["rrs_2"]
        mhop = out.get("is_mhop", np.ones_like(r1, bool))
        sacc = out.get("stop_acc")
        if valid is not None:
            r1, r2, mhop = r1[valid], r2[valid], mhop[valid]
            sacc = None if sacc is None else sacc[valid]
        rrs1.extend(r1.tolist())
        rrs2.extend(r2[mhop].tolist())
        if sacc is not None:
            stop_accs.extend(sacc.tolist())
    mrr_1 = float(np.mean(rrs1)) if rrs1 else 0.0
    mrr_2 = float(np.mean(rrs2)) if rrs2 else 0.0
    out = {"mrr_1": mrr_1, "mrr_2": mrr_2, "mrr_avg": (mrr_1 + mrr_2) / 2}
    if stop_accs:
        out["stop_acc"] = float(np.mean(stop_accs))
    return out


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference checkpoint's names, as
    ``cli/common.init_retriever`` (and the JAX package's) read them: the
    retriever's own names, except that a UnifiedRetriever keeps its
    transformer under ``encoder_c.``, its stop head as ``stop`` and its
    tanh pooler as ``encoder_c.pooler.dense``.  A tensor-parallel model's
    blocks are joined back into the reference layout, bit for bit; where
    other processes hold some of them, they are gathered over the index
    group, so every process of the group must call this."""
    sd = gather_state_dict(model)
    if not isinstance(model, UnifiedRetriever):
        return sd
    return unified_reference_names(sd)


class RetrieverTrainer:
    """Epoch loop with an eval after every epoch and best-checkpoint
    tracking; the steps are the functions above, this class sequences them
    and talks to the host (loader, logging, checkpoint files).

    With ``cfg.momentum`` this is the stage-2 memory-bank trainer: the
    state carries encoder_k and the queue, and only encoder_q is written
    to ``checkpoint_*.pt``.  The model trains on the device its
    parameters are on; with a ``mesh``, each batch is split over its data
    axis (``DataParallel``), and the model's device is the first data
    entry's."""

    def __init__(self, model: nn.Module, cfg: RetrieverTrainConfig,
                 train_loader, eval_loader, *,
                 total_steps: Optional[int] = None,
                 mesh: Optional[Mesh] = None,
                 output_dir: Optional[str] = None, log_fn=print,
                 hidden_size: Optional[int] = None, enable_ema: bool = False):
        from ..core import checkpoint as ckpt

        self.cfg = cfg
        self.mesh = mesh
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.output_dir = output_dir
        self.log = log_fn
        self._ckpt = ckpt
        self.device = _device(model)
        # optimizer steps, not micro-batches
        total = total_steps or (len(train_loader) * cfg.num_epochs
                                // max(cfg.gradient_accumulation, 1))
        self.tx = make_optimizer(cfg, total)
        if cfg.momentum and cfg.unified:
            raise ValueError("momentum training drives the mhop contrastive "
                             "loss; unified (stop-head) training has no "
                             "momentum variant — pick one (the reference "
                             "has no such combination either)")
        if cfg.momentum:
            hidden = hidden_size or model.config.hidden_size
            self.state = MomentumTrainState.create(
                model, self.tx, queue_size=cfg.queue_size, hidden=hidden,
                seed=cfg.seed)
            self.train_step = make_momentum_train_step(
                enable_ema=enable_ema, momentum_m=cfg.momentum_m, mesh=mesh)
            mstep = make_momentum_eval_step(mesh=mesh)
            self.eval_step = lambda model, batch: mstep(
                model, self.state.model_k, batch)
        else:
            self.state = TrainState.create(model, self.tx)
            self.train_step = make_train_step(unified=cfg.unified, mesh=mesh)
            self.eval_step = make_eval_step(unified=cfg.unified, mesh=mesh)
        self.best_mrr = 0.0

    def _save_model(self, name: str):
        self._ckpt.save_pytree(f"{self.output_dir}/{name}.pt",
                               reference_state_dict(self.state.model))

    def run(self, resume: bool = True) -> Dict[str, float]:
        writer = None
        checkpointer = None
        start_epoch = 0
        if self.output_dir:
            from ..utils.meters import MetricWriter
            from .preemption import PreemptionCheckpointer

            writer = MetricWriter(f"{self.output_dir}/tb")
            checkpointer = PreemptionCheckpointer(
                f"{self.output_dir}/preempt")
            try:
                checkpointer.install_signal_handler()
            except ValueError:
                pass  # not on the main thread (tests)
            if resume:
                state, meta = checkpointer.maybe_restore()
                if state is not None:
                    self.state.load_state_dict(state)
                    start_epoch = meta["epoch"] + 1
                    self.best_mrr = meta["best_metric"]
                    if meta.get("rng_state"):
                        # replay the data order an uninterrupted run sees
                        self.train_loader.set_rng_state(meta["rng_state"])
                    self.log(f"resumed from epoch {meta['epoch']} "
                             f"(best_mrr={self.best_mrr:.4f})")
        smoothed = None
        history = []
        # the scalars' x-axis continues across resumes
        step_no = start_epoch * len(self.train_loader)
        model = self.state.model
        for epoch in range(start_epoch, self.cfg.num_epochs):
            losses_seen = []
            model.train()
            for batch in self.train_loader:
                batch.pop("valid", None)
                self.state, loss = self.train_step(
                    self.state, to_device(batch, self.device))
                # keep the device tensor: a float() here would sync the
                # host into every step
                losses_seen.append(loss)
                step_no += 1
                if writer:
                    # the writer's path pays the one sync it needs
                    lval = float(loss)
                    smoothed = (lval if smoothed is None
                                else 0.99 * smoothed + 0.01 * lval)
                    writer.add_scalar("batch_train_loss", lval, step_no)
                    writer.add_scalar("smoothed_train_loss", smoothed, step_no)
            losses_seen = (torch.stack(losses_seen).float().cpu().tolist()
                           if losses_seen else [])
            model.eval()
            mrrs = evaluate_mrr(self.eval_step, model, self.eval_loader)
            stats = EpochStats(float(np.mean(losses_seen)),
                               mrrs["mrr_1"], mrrs["mrr_2"])
            history.append(stats)
            if writer:
                writer.add_scalar("dev_mrr", stats.mrr_avg, epoch)
            self.log(f"epoch {epoch}: loss={stats.train_loss:.4f} "
                     f"mrr1={stats.mrr_1:.4f} mrr2={stats.mrr_2:.4f}")
            if self.output_dir:
                self._save_model("checkpoint_last")
                if stats.mrr_avg > self.best_mrr:
                    self.best_mrr = stats.mrr_avg
                    self._save_model("checkpoint_best")
            else:
                self.best_mrr = max(self.best_mrr, stats.mrr_avg)
            if checkpointer:
                checkpointer.save(self.state.state_dict(), epoch=epoch,
                                  best_metric=self.best_mrr,
                                  rng_state=self.train_loader.rng_state())
                if checkpointer.preempted:
                    self.log("preemption signal received — state saved, "
                             "exiting for requeue")
                    break
        if writer:
            writer.close()
        return {"best_mrr": self.best_mrr,
                "final_loss": history[-1].train_loss if history else 0.0}
