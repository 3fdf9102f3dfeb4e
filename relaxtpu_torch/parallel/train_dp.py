"""The MLP head's training step, data-parallel over the batch and split
over fc1's input rows (counterpart of ``relaxtpu/parallel/train_dp.py``).

JAX writes this step with sharding constraints and lets XLA insert the
collectives.  Here each rank runs its part and the collectives are written
out:

- fc1's (35,203 x 256) kernel is split by input rows over the model axis.
  35,203 is odd, so the input dim is zero-padded up to a multiple of the
  model axis.  The pad is exact: the pad columns of x are zero, so the pad
  rows never reach the forward, get zero gradient and, at zero, zero decay,
  and stay zero.
- A rank multiplies its columns of x by its rows of fc1; the partial
  products are summed over the model group (``_SumOverModel``: forward an
  all-reduce, backward the identity, because every model rank already
  holds the whole upstream gradient; ``torch.distributed.nn.all_reduce``
  would sum in the backward too and multiply fc1's input gradient by the
  model axis).
- The head's outputs are gathered over the data group (``_GatherRows``:
  backward this rank's slice, not a reduce-scatter, since every rank
  computes the same loss), and the loss runs on the global batch: its rank
  term sums over every pair of the batch (``model/losses.py``), so a
  per-rank loss, as DDP would take, gives another step.
- Gradients are summed over the data group, not averaged as DDP does: each
  rank's backward already carries 1/B of the global mean.
- ``torch.optim.SGD(lr, momentum=0.9, weight_decay=wd)`` is optax's
  ``chain(add_decayed_weights(wd), sgd(lr, momentum=0.9))``: both start the
  momentum buffer at the first gradient.
- Dropout: every rank draws each mask for the global batch from the same
  generator, in ``Mlp.forward_train``'s order, and keeps its own rows, so
  the step equals the one-process ``forward_train`` with that generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from relaxtpu_torch.device import set_strict_f32
from relaxtpu_torch.model.losses import mae_and_rank_loss
from relaxtpu_torch.model.mlp import Mlp, flax_init_
from relaxtpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum
from relaxtpu_torch.parallel.mesh import Mesh


class _SumOverModel(torch.autograd.Function):
    """The sum of the partial fc1 products over the model group; the
    backward passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, group) -> torch.Tensor:
        return all_reduce_sum(partial.clone(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherRows(torch.autograd.Function):
    """Every data index's rows concatenated in data order; the backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, group, index: int) -> torch.Tensor:
        ctx.rows = (index * len(local), (index + 1) * len(local))
        return all_gather_rows(local, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


def _dropout_rows(x: torch.Tensor, rate: float, gen: torch.Generator | None, rows: tuple[int, int],
                  n_global: int) -> torch.Tensor:
    """``model.mlp._dropout`` on rows ``rows`` of a global batch of
    ``n_global``: the mask is drawn for the whole batch, so every rank's
    generator stays in step with the one-process run."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((n_global, *x.shape[1:]), generator=gen, device=x.device)[rows[0] : rows[1]] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DistributedMlpTrainStep:
    """One SGD step of the head on a global batch whose rows are split over
    the mesh's data axis and whose fc1 rows are split over its model axis.

    Call :meth:`init`, then :meth:`step` with this rank's chunk of every
    global batch: each data index passes the same number of rows (the
    global batch is their concatenation in data order), and the ranks of a
    model group pass the same chunk.  f32 with TF32 off, as the one-device
    trainer runs.  ``cfg`` stands in the JAX package's position and, as
    there, is not read."""

    def __init__(self, mesh: Mesh, input_dim: int, cfg=None, hidden: int = 256, drop_rate: float = 0.1,
                 use_bn: bool = False, l1_w: float = 0.6, rank_w: float = 1.0, lr: float = 0.1,
                 weight_decay: float = 0.005):
        if use_bn:
            # JAX's class keeps no batch_stats, and its step raises
            # ScopeCollectionNotFound on the first BatchNorm
            raise ValueError("use_bn=True: the distributed step has no BatchNorm statistics "
                             "(the JAX package's step raises on it too)")
        self.mesh = mesh
        self.input_dim, self.hidden, self.drop_rate = input_dim, hidden, drop_rate
        self.l1_w, self.rank_w, self.lr, self.weight_decay = l1_w, rank_w, lr, weight_decay
        n_model = mesh.shape["model"]
        self.padded_dim = input_dim + (-input_dim) % n_model
        block = self.padded_dim // n_model
        self.cols = (mesh.model_index * block, (mesh.model_index + 1) * block)
        self.model: Mlp | None = None
        self.opt: torch.optim.Optimizer | None = None
        if mesh.device.type == "cuda":
            set_strict_f32()

    def init(self, gen: torch.Generator | None = None, state: dict | None = None) -> None:
        """A head at the true input dim, as a one-device run would make it:
        ``state`` (an ``Mlp`` state dict, e.g. ``models.porters.mlp_from_jax``
        of JAX's params) or flax's init drawn from ``gen`` (the same seed on
        every rank).  fc1 is zero-padded to the padded dim and this rank
        keeps its block of input rows."""
        if state is None:
            state = flax_init_(Mlp(self.input_dim, self.hidden, use_bn=False), gen).state_dict()
        lo, hi = self.cols
        w1 = F.pad(state["fc1.weight"].detach(), (0, self.padded_dim - self.input_dim))
        model = Mlp(hi - lo, self.hidden, drop_rate=self.drop_rate, use_bn=False)
        model.load_state_dict({**state, "fc1.weight": w1[:, lo:hi]})
        self.model = model.to(self.mesh.device)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=self.lr, momentum=0.9,
                                   weight_decay=self.weight_decay)

    def _x_block(self, x) -> torch.Tensor:
        """This rank's columns of ``x`` (zero pad columns past the true
        dim), f32 on the mesh's device."""
        lo, hi = self.cols
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        x = x[:, lo : min(hi, self.input_dim)].to(self.mesh.device, torch.float32)
        return F.pad(x, (0, hi - lo - x.shape[1]))

    def step(self, x, y, gen: torch.Generator | None = None) -> torch.Tensor:
        """One step on this rank's chunk ``x`` (rows, the true input dim)
        and ``y`` -> the global batch's loss, on the device."""
        mesh, m = self.mesh, self.model
        xb = self._x_block(x)
        y = torch.as_tensor(y, dtype=torch.float32).reshape(-1).to(mesh.device)
        if len(y) != len(xb):
            raise ValueError(f"x has {len(xb)} rows, y {len(y)}")
        y_all = all_gather_rows(y, mesh.data_group)
        rows = (mesh.data_index * len(xb), (mesh.data_index + 1) * len(xb))
        h = _SumOverModel.apply(F.linear(xb, m.fc1.weight), mesh.model_group) + m.fc1.bias
        h = _dropout_rows(F.gelu(h), self.drop_rate, gen, rows, len(y_all))
        h = _dropout_rows(F.gelu(m.fc2(h)), self.drop_rate, gen, rows, len(y_all))
        out = _GatherRows.apply(m.fc3(h), mesh.data_group, mesh.data_index)
        loss = mae_and_rank_loss(out, y_all, self.l1_w, self.rank_w)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh.data_group is not None:  # one all-reduce for every gradient
            grads = [p.grad for p in m.parameters()]
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.data_group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        self.opt.step()
        return loss.detach()

    def state(self, keep_pad: bool = False) -> dict[str, torch.Tensor]:
        """The whole head as an ``Mlp`` state dict on every rank: fc1's
        blocks gathered over the model group, the pad rows cut off unless
        ``keep_pad``."""
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        w1 = all_gather_rows(sd["fc1.weight"].t(), self.mesh.model_group).t()
        sd["fc1.weight"] = w1 if keep_pad else w1[:, : self.input_dim].contiguous()
        return sd
