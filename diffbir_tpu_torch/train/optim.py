"""AdamW over fp32 master copies, shared by the stage-1 and stage-2 steps.

Mixed precision: the modules keep their weights in the compute dtype (bf16
on the card) and the optimiser keeps fp32 masters of the trained
parameters. Gradients are taken to fp32, the masters updated in fp32 and
rounded back into the module after each update: the JAX package's
arithmetic (fp32 parameters cast at every use) without casts on the
forward path, and updates that bf16 would lose are kept.

Across processes (``parallel.DataParallel``) the fp32 gradients are reduced
before the update, and under ``train.fsdp`` each process keeps the masters
and moments of its shard of the leaves ``fsdp_dim`` shards, updates that,
and all-gathers the rounded weights. ``state_dict`` is always the whole
state, so a checkpoint resumes with any process count.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from ..parallel import fsdp
from ..parallel.mesh import DataParallel

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
        self.dims = [parallel.shard_dim(p.shape) if parallel else None for p in self.params]
        self.masters = [self._shard(p.detach().to(torch.float32, copy=True), d)
                        for p, d in zip(self.params, self.dims)]
        self.optimizer = torch.optim.AdamW(self.masters, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        self.accum_steps = accum_steps
        self.micro_step = 0  # micro-batches accumulated since the last update
        self.updates = 0     # AdamW updates taken

    @staticmethod
    def _shard(full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return full if dim is None else fsdp.shard(full, dim)

    @staticmethod
    def _gather(part: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return part if dim is None else fsdp.all_gather(part, dim)

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
        """The global norm of ``gradients()``'s result, shards included."""
        if not any(d is not None for d in self.dims):
            return global_norm(grads)
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
        sharded = sum((s for s, d in zip(sq, self.dims) if d is not None), torch.zeros_like(sq[0]))
        whole = sum((s for s, d in zip(sq, self.dims) if d is None), torch.zeros_like(sq[0]))
        return torch.sqrt(self.parallel.reduce_metric(sharded, mean=False) + whole)

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
        for p, m, d in zip(self.params, self.masters, self.dims):
            p.copy_(self._gather(m.to(p.dtype), d))
        return True

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def full_masters(self) -> List[torch.Tensor]:
        """The whole fp32 masters (shards all-gathered: every process
        calls this together)."""
        return [self._gather(m, d) for m, d in zip(self.masters, self.dims)]

    @torch.no_grad()
    def state_dict(self) -> Dict:
        """The whole optimiser state on the host (every process calls this
        together): the fp32 masters, torch's AdamW state dict with whole
        moments, the accumulation state."""
        opt = self.optimizer.state_dict()
        state = {i: {k: self._gather(v, self.dims[i] if k in MOMENTS else None).detach().cpu()
                     for k, v in st.items()} for i, st in opt["state"].items()}
        return {"masters": [self._gather(m, d).detach().cpu()
                            for m, d in zip(self.masters, self.dims)],
                "optimizer": {"state": state, "param_groups": opt["param_groups"]},
                "micro_step": self.micro_step, "updates": self.updates,
                "accum": [None if m.grad is None else self._gather(m.grad, d).detach().cpu()
                          for m, d in zip(self.masters, self.dims)]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s result (of any process count): the
        masters, this process's shards of them and of the moments, the
        module's parameters from the masters."""
        for p, m, d, saved in zip(self.params, self.masters, self.dims, state["masters"]):
            m.copy_(self._shard(saved.to(m.device), d))
            p.copy_(self._gather(m.to(p.dtype), d))
        for m, d, g in zip(self.masters, self.dims, state["accum"]):
            m.grad = None if g is None else self._shard(g.to(m.device), d)
        opt = state["optimizer"]
        local = {i: {k: self._shard(v, self.dims[i]) if k in MOMENTS else v
                     for k, v in st.items()} for i, st in opt["state"].items()}
        self.optimizer.load_state_dict({"state": local, "param_groups": opt["param_groups"]})
        self.micro_step, self.updates = state["micro_step"], state["updates"]
