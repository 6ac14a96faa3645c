"""One-element-deep halo exchange and global reductions over a process group:
the port of `remhos_tpu.parallel.halo` (ParFiniteElementSpace::
ExchangeFaceNbrData and MPI_Allreduce in the reference, remhos_lo.cpp:55-58,
remhos.cpp:1812-1813).

`ShardComm` is one rank's view of a sharded run: its process group, its
coordinates in the shard grid (the outer device axis is the last mesh axis,
as in `sharded.shard_axes_spec`: rank = i_outer * n_inner + i_inner) and
the operations the sharded operators need:

- `exchange_slabs(top, bot, axis)`: (from_prev, from_next), the previous
  rank's `top` and the next rank's `bot` along one device axis, in one
  `dist.batch_isend_irecv`. On a non-periodic axis an edge rank neither
  sends nor receives across its physical edge (the JAX package sends round
  the ring and masks; the masked values are never read here). A peer that
  is the rank itself (a ring of one, or a periodic axis with one shard) is a
  local copy: `torch.distributed` refuses a send to oneself, where JAX's
  `ppermute` to self is a copy;
- `edge_masks(axis, periodic)`: (has_prev, has_next), Python booleans
  decided from the rank's coordinates;
- `all_min`, `all_max`, `all_sum`, `all_gather` (along dim 0).

Where the backend is gloo and the tensors are on the card (several ranks
sharing one card: NCCL refuses two ranks on one device), every
communication is staged through host memory explicitly; `staged_bytes`
counts the bytes copied each way, and the callers print it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class ShardComm:
    """One rank of a shard grid. `dev_shape` lists the device axes outer
    first (n of each); `group` is the process group (None: the default
    group) and must have prod(dev_shape) ranks."""

    def __init__(self, dev_shape, group=None):
        self.group = group
        self.dev_shape = tuple(int(n) for n in dev_shape)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.size != int(np.prod(self.dev_shape)):
            raise ValueError(
                f"a shard grid of {self.dev_shape} needs "
                f"{int(np.prod(self.dev_shape))} ranks, the process group "
                f"has {self.size}")
        self.coords = tuple(int(c) for c in np.unravel_index(
            self.rank, self.dev_shape))
        self.backend = dist.get_backend(group)
        self.staged_bytes = 0

    # -- the shard grid --------------------------------------------------
    def _global(self, r):
        """The default group's rank of this group's rank r."""
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _neighbour(self, axis, step):
        c = list(self.coords)
        c[axis] = (c[axis] + step) % self.dev_shape[axis]
        return int(np.ravel_multi_index(c, self.dev_shape))

    def edge_masks(self, axis: int, periodic: bool):
        """(has_prev, has_next) of this rank along device axis `axis`."""
        if periodic:
            return True, True
        i = self.coords[axis]
        return i > 0, i < self.dev_shape[axis] - 1

    # -- host staging on gloo --------------------------------------------
    def _staged(self, x):
        return self.backend == "gloo" and x.device.type == "cuda"

    def _out(self, x):
        """x as the backend takes it (a host copy under gloo on the card)."""
        if self._staged(x):
            self.staged_bytes += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _back(self, y, like):
        if y.device != like.device:
            self.staged_bytes += y.numel() * y.element_size()
            return y.to(like.device)
        return y

    # -- halo slabs --------------------------------------------------------
    def exchange_slabs(self, top, bot, axis: int, periodic: bool):
        """(from_prev, from_next) along device axis `axis`: the previous
        rank's `top` and the next rank's `bot`. A side without a neighbour
        (a physical edge of a non-periodic axis) comes back as zeros."""
        has_prev, has_next = self.edge_masks(axis, periodic)
        prev, nxt = self._neighbour(axis, -1), self._neighbour(axis, 1)
        top_w, bot_w = self._out(top.contiguous()), self._out(bot.contiguous())
        from_prev = torch.zeros_like(top_w)
        from_next = torch.zeros_like(bot_w)
        ops = []
        # tag 0 carries `top` forward, tag 1 `bot` backward; with two ranks
        # the same peer is prev and next, and the tags keep them apart
        if has_next:
            if nxt == self.rank:
                from_prev = top_w.clone()
            else:
                ops.append(dist.P2POp(dist.isend, top_w, self._global(nxt),
                                      self.group, tag=0))
        if has_prev and prev != self.rank:
            ops.append(dist.P2POp(dist.irecv, from_prev, self._global(prev),
                                  self.group, tag=0))
        if has_prev:
            if prev == self.rank:
                from_next = bot_w.clone()
            else:
                ops.append(dist.P2POp(dist.isend, bot_w, self._global(prev),
                                      self.group, tag=1))
        if has_next and nxt != self.rank:
            ops.append(dist.P2POp(dist.irecv, from_next, self._global(nxt),
                                  self.group, tag=1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(from_prev, top), self._back(from_next, bot)

    # -- global reductions -------------------------------------------------
    def _all_reduce(self, x, op):
        if self.size == 1:
            return x
        y = self._out(x).clone()
        dist.all_reduce(y, op=op, group=self.group)
        return self._back(y, x)

    def all_min(self, x):
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_max(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_sum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_gather(self, x):
        """The ranks' x concatenated along dim 0, in rank order."""
        if self.size == 1:
            return x
        xw = self._out(x.contiguous())
        parts = [torch.empty_like(xw) for _ in range(self.size)]
        dist.all_gather(parts, xw, group=self.group)
        return self._back(torch.cat(parts), x)

    def barrier(self):
        if self.size > 1:
            dist.barrier(group=self.group)
