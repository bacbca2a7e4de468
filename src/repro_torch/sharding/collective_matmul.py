"""Ring collective matmul (twin of ``repro/sharding/collective_matmul.py``):
overlap the tensor-parallel all-gather with the matmul it feeds.

Plain tensor parallelism computes ``y = all_gather(x) @ W``: the gather
finishes before the product starts.  The ring keeps ``x`` sharded by
columns, multiplies the shard it holds by the matching rows of ``W`` while
the next shard travels around the ring, so the traffic hides behind the
product:

  for step in 0..n-1:
      y += x_shard @ W[rows of the shard held at this step]
      x_shard <- the shard of the next rank

Each rank passes its own tensors, as a ``shard_map`` body does; the
shards move by ``torch.distributed.batch_isend_irecv``.  Forward only:
nothing in the JAX package differentiates the ring, so a call autograd
would record raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _check_no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "ring_allgather_matmul is forward only (nothing in the JAX "
            "package differentiates the ring); call it under "
            "torch.no_grad() or on tensors that do not require grad")


def ring_allgather_matmul_local(x_shard: torch.Tensor, w_full: torch.Tensor,
                                group=None) -> torch.Tensor:
    """This rank's body: ``x_shard`` [B, d_in / n] is the rank's columns of
    ``x``, ``w_full`` [d_in, d_out] the whole ``W``, ``group`` the ring's
    process group (``None``: a ring of this rank alone).  Returns ``x @
    W`` [B, d_out], accumulated in ``x``'s dtype as JAX's ``acc0``.

    At step ``s`` the shard held came from rank ``(me + s) % n``; it is
    multiplied by its rows of ``w_full`` while it travels on to rank ``me -
    1`` (JAX's ``perm=[(i, (i - 1) % n)]``) and the next one arrives from
    rank ``me + 1``.  Step ``s``'s send and receive are posted before its
    product and waited on after it.  The last step sends nothing: JAX's
    ``n``-th ``ppermute`` only brings every shard home, and its result is
    dropped.
    """
    _check_no_grad(x_shard, w_full)
    n, me = (1, 0) if group is None else (dist.get_world_size(group),
                                           dist.get_rank(group))
    chunk = x_shard.shape[-1]
    if w_full.shape[0] != n * chunk:
        raise ValueError(f"w has {w_full.shape[0]} rows; {n} shards of "
                         f"{chunk} columns need {n * chunk}")
    if n > 1:
        to = dist.get_global_rank(group, (me - 1) % n)
        frm = dist.get_global_rank(group, (me + 1) % n)
    acc = torch.zeros((x_shard.shape[0], w_full.shape[1]), dtype=x_shard.dtype,
                      device=x_shard.device)
    xs = x_shard.contiguous()
    for step in range(n):
        src = (me + step) % n
        reqs = ()
        if step < n - 1:
            nxt = torch.empty_like(xs)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, xs, to, group),
                dist.P2POp(dist.irecv, nxt, frm, group)])
        acc = acc + xs @ w_full[src * chunk:(src + 1) * chunk]
        for req in reqs:
            req.wait()
        if reqs:
            xs = nxt
    return acc


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                          axis: str = "model") -> torch.Tensor:
    """``y = x @ w`` with ``x``'s columns sharded over mesh axis ``axis``.
    ``x`` [B, d_in] is the same on every rank of the axis, as JAX's global
    array is; each rank takes its own ``d_in / n`` columns and gets ``y``
    [B, d_out] whole.  Raises ``ValueError`` where ``n`` does not divide
    ``d_in``."""
    from repro_torch.sharding.api import axis_sizes

    _check_no_grad(x, w)
    n = axis_sizes(mesh).get(axis, 1)
    d_in = x.shape[-1]
    if d_in % n:
        raise ValueError(f"d_in={d_in} is not divisible by the {n} ranks of "
                         f"mesh axis {axis!r}")
    if n == 1:
        return ring_allgather_matmul_local(x, w)
    chunk = d_in // n
    me = mesh.get_local_rank(axis)
    return ring_allgather_matmul_local(x[:, me * chunk:(me + 1) * chunk], w,
                                       group=mesh.get_group(axis))
