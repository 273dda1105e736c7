"""Plain PyTorch versions of ``voxel_pooling``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
import torch


def lift_splat_factorized_plain(depth: torch.Tensor, ctx: torch.Tensor,
                                flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                                n_cells: int) -> torch.Tensor:
    """Plain PyTorch version: an einsum over the rows rounded to float32,
    then one float32 ``index_add_`` of the M*D*fW rows into M*(n_cells+1)
    cells. The einsum computes in float32 (float64 for float64 inputs) and
    rounds its result to float32, where the JAX package's
    ``preferred_element_type=jnp.float32`` rounds it (also under x64)."""
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    masked = depth * zvalid.to(depth.dtype)
    ct = torch.promote_types(depth.dtype, torch.float32)
    a = torch.einsum('mdhw,mhwc->mdwc', masked.to(ct), ctx.to(ct)).float()   # [M,D,fW,C]
    seg = (flat_idx_xy.long()
           + (n_cells + 1) * torch.arange(m, device=depth.device)[:, None, None])
    out = torch.zeros(m * (n_cells + 1), c, dtype=torch.float32, device=depth.device)
    out.index_add_(0, seg.reshape(-1), a.reshape(m * d * fw, c))
    return out.to(ctx.dtype).reshape(m, n_cells + 1, c)[:, :n_cells]


def lift_splat_plain(depth: torch.Tensor, ctx: torch.Tensor, flat_idx: torch.Tensor,
                     n_cells: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`lift_splat`, the JAX package's steps
    camera by camera: the rows ``depth[d, p] * ctx[p, :]`` in the inputs'
    dtype (each product rounded to it), raised to float32 and
    ``index_add_``ed into ``n_cells + 1`` cells, the trash cell dropped,
    cast to ctx's dtype."""
    m, d, p = depth.shape
    c = ctx.shape[-1]
    outs = []
    for i in range(m):
        rows = (depth[i, :, :, None] * ctx[i, None]).reshape(d * p, c)
        acc = torch.zeros(n_cells + 1, c, dtype=torch.float32, device=depth.device)
        acc.index_add_(0, flat_idx[i].reshape(-1).long(), rows.float())
        outs.append(acc[:n_cells].to(ctx.dtype))
    return torch.stack(outs)


lift_splat_factorized = lift_splat_factorized_plain
lift_splat = lift_splat_plain
