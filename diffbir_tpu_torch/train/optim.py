"""AdamW over fp32 master copies, shared by the stage-1 and stage-2 steps.

Mixed precision: the modules keep their weights in the compute dtype (bf16
on the card) and the optimiser keeps fp32 masters of the trained
parameters. Gradients are taken to fp32, the masters updated in fp32 and
rounded back into the module after each update: the JAX package's
arithmetic (fp32 parameters cast at every use) without casts on the
forward path, and updates that bf16 would lose are kept.

Across processes (``parallel.DataParallel``) the fp32 gradients are reduced
over the data group before the update, and under ``train.fsdp`` each
process keeps the masters and moments of its shard of the leaves
``fsdp_dim`` shards, updates that, and all-gathers the rounded weights over
the data group. Under tensor parallelism (a grid with n_tensor > 1) a
parameter is this process's tensor slice (``parallel/tp.py``: ``tp_dim``,
``tp_splits``), and its master the slice's, data-sharded on top (JAX's
``fsdp_spec`` on its ``tp_spec``). ``grad_norm`` is the whole tree's;
``full_masters`` and ``state_dict`` are always the whole state, gathered
over both groups, so a checkpoint resumes with any process count and
layout.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..parallel import fsdp
from ..parallel.mesh import DataParallel
from ..parallel.tp import tp_local, tp_whole

MOMENTS = ("exp_avg", "exp_avg_sq")  # torch AdamW's per-parameter state shaped as it


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


class MasterAdamW:
    """AdamW over fp32 master copies of ``params`` (betas 0.9/0.999, eps
    1e-8, decoupled ``weight_decay`` on every leaf: optax.adamw's
    arithmetic), with gradient accumulation over ``accum_steps``
    micro-batches by a running mean (optax.MultiSteps). ``parallel`` reduces
    the gradients across processes and places the masters."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 accum_steps: int = 1, weight_decay: float = 0.0,
                 parallel: Optional[DataParallel] = None):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.params = list(params)
        self.parallel = parallel
        # each parameter's tensor slice: (dim, splits), or None where whole
        self.tp = [(p.tp_dim, p.tp_splits) if hasattr(p, "tp_dim") else None
                   for p in self.params]
        self.dims = [parallel.shard_dim(p.shape, None if t is None else t[0]) if parallel
                     else None for p, t in zip(self.params, self.tp)]
        self.masters = [self._shard(p.detach().to(torch.float32, copy=True), d)
                        for p, d in zip(self.params, self.dims)]
        self.optimizer = torch.optim.AdamW(self.masters, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        self.accum_steps = accum_steps
        self.micro_step = 0  # micro-batches accumulated since the last update
        self.updates = 0     # AdamW updates taken

    @property
    def _group(self):
        return self.parallel.group if self.parallel else None

    def _shard(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This process's data shard of its tensor slice ``full``."""
        return full if dim is None else fsdp.shard(full, dim, self._group)

    def _gather(self, part: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This process's tensor slice from the data shards ``part``."""
        return part if dim is None else fsdp.all_gather([part], [dim], self._group)[0]

    def _whole(self, part: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s whole tensor from this process's shard ``part``."""
        part = self._gather(part, self.dims[i])
        if self.tp[i] is None:
            return part
        return tp_whole(part, *self.tp[i], self.parallel.grid.tensor_group)

    def _local(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This process's shard of leaf ``i``'s whole tensor ``full``."""
        if self.tp[i] is not None:
            grid = self.parallel.grid
            full = tp_local(full, *self.tp[i], grid.tensor_index, grid.n_tensor)
        return self._shard(full, self.dims[i])

    @torch.no_grad()
    def gradients(self) -> List[torch.Tensor]:
        """This micro-batch's ``.grad`` of every parameter (None counts as
        zero) in fp32, reduced across the processes (a sharded leaf's to
        this process's shard); the ``.grad`` cleared."""
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) if p.grad is None
                 else p.grad.to(torch.float32) for p in self.params]
        for p in self.params:
            p.grad = None
        if self.parallel is not None:
            grads = self.parallel.reduce(grads, self.dims)
        return grads

    def reduce_metric(self, x: torch.Tensor) -> torch.Tensor:
        """A per-process metric reduced as the gradients are."""
        return x if self.parallel is None else self.parallel.reduce_metric(x)

    @torch.no_grad()
    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``gradients()``'s result over the whole tree
        (``optax.global_norm``): the squares of the data-sharded leaves
        summed over the data group, of the tensor slices over the tensor
        group; a replicated leaf counts once."""
        if all(d is None and t is None for d, t in zip(self.dims, self.tp)):
            return global_norm(grads)
        sq = torch.zeros(4, dtype=torch.float32, device=grads[0].device)
        for g, d, t in zip(grads, self.dims, self.tp):
            sq[(d is not None) + 2 * (t is not None)] += torch.linalg.vector_norm(
                g, dtype=torch.float32) ** 2
        grid = self.parallel.grid
        # [whole, data-sharded, tensor-sliced, both]
        for idx, group, n in (([1, 3], grid.data_group, grid.n_data),
                              ([2, 3], grid.tensor_group, grid.n_tensor)):
            if n > 1:
                part = sq[idx]
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
                sq[idx] = part
        return torch.sqrt(sq.sum())

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> bool:
        """Fold this micro-batch's gradients (``gradients()`` unless given)
        into the masters' mean gradient; on the last micro-batch of an
        accumulation, update the masters and copy them into the module.
        Returns whether the module's parameters changed."""
        if grads is None:
            grads = self.gradients()
        n = self.micro_step
        for m, g in zip(self.masters, grads):
            if n == 0:
                m.grad = g
            else:
                m.grad += (g - m.grad) / (n + 1)
        self.micro_step += 1
        if self.micro_step < self.accum_steps:
            return False
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.micro_step = 0
        self.updates += 1
        sharded = [i for i, d in enumerate(self.dims) if d is not None]
        for p, m, d in zip(self.params, self.masters, self.dims):
            if d is None:
                p.copy_(m.to(p.dtype))
        cast = [self.masters[i].to(self.params[i].dtype) for i in sharded]
        for bucket in fsdp.buckets(cast):  # the rounded weights, gathered bucket by bucket
            idx = [sharded[j] for j in bucket]
            wholes = fsdp.all_gather([cast[j] for j in bucket], [self.dims[i] for i in idx],
                                     self._group)
            for i, w in zip(idx, wholes):
                self.params[i].copy_(w)
        return True

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def full_masters(self) -> List[torch.Tensor]:
        """The whole fp32 masters (shards and tensor slices all-gathered:
        every process calls this together)."""
        return [self._whole(m, i) for i, m in enumerate(self.masters)]

    @torch.no_grad()
    def state_dict(self) -> Dict:
        """The whole optimiser state on the host (every process calls this
        together): the fp32 masters, torch's AdamW state dict with whole
        moments, the accumulation state."""
        opt = self.optimizer.state_dict()
        state = {i: {k: (self._whole(v, i) if k in MOMENTS else v).detach().cpu()
                     for k, v in st.items()} for i, st in opt["state"].items()}
        return {"masters": [m.detach().cpu() for m in self.full_masters()],
                "optimizer": {"state": state, "param_groups": opt["param_groups"]},
                "micro_step": self.micro_step, "updates": self.updates,
                "accum": [None if m.grad is None else self._whole(m.grad, i).detach().cpu()
                          for i, m in enumerate(self.masters)]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s result (of any process count and
        layout): the masters, this process's shards of them and of the
        moments, the module's parameters from the masters."""
        for i, (p, m, saved) in enumerate(zip(self.params, self.masters, state["masters"])):
            m.copy_(self._local(saved.to(m.device), i))
            p.copy_(self._gather(m.to(p.dtype), self.dims[i]))
        for i, (m, g) in enumerate(zip(self.masters, state["accum"])):
            m.grad = None if g is None else self._local(g.to(m.device), i)
        opt = state["optimizer"]
        local = {i: {k: self._local(v.to(self.masters[i].device), i) if k in MOMENTS else v
                     for k, v in st.items()} for i, st in opt["state"].items()}
        self.optimizer.load_state_dict({"state": local, "param_groups": opt["param_groups"]})
        self.micro_step, self.updates = state["micro_step"], state["updates"]
