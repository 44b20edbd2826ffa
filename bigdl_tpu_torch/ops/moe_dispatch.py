"""Ragged MoE dispatch: token-choices sorted by expert through B6.

Counterpart of ``bigdl_tpu/ops/pallas/moe_dispatch.py`` (``moe_mlp_ragged``).
Every (token, choice) pair is computed, and only the chosen experts' work
is done, with no host sync and no data-dependent shape:

1. The pairs are stably sorted by expert and copied into a buffer where
   each expert's group is padded up to ``TOKEN_TILE`` rows, so a tile
   belongs to one expert. The buffer height ``N*k + E*(T-1)`` rounded up
   to a tile is the static worst case; padding rows are zeros, and the
   tiles past the last expert region name expert E - 1 and hold no row.
2. ``ragged_expert_matmul`` (kernel B6, ``ops/cuda/moe_dispatch.py``)
   multiplies tile i by expert ``tile_expert[i]``'s weight; ``tile_rows``
   lets it skip the m-tiles that hold no real row.
3. Each pair's output row is weighted and the k rows of a token are
   summed in a fixed order (choice 0 first), through the inverse of the
   sort, instead of a scatter-add: for k = 2 this is the JAX package's
   bf16 scatter-add bit for bit, and it repeats from run to run.

Everything is tensor code on the input's device: a stable argsort, a
per-expert count, cumulative sums and a right-sided searchsorted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from bigdl_tpu_torch.ops.cuda.moe_dispatch import (TOKEN_TILE,
                                                   ragged_expert_matmul)
from bigdl_tpu_torch.ops.quant import QTensor


class RaggedRouting(NamedTuple):
    """Where each sorted token-choice lands in the tile-padded buffer."""
    order: torch.Tensor        # [N*k] pair index of each sorted row
    dest: torch.Tensor         # [N*k] buffer row of each sorted pair
    tile_expert: torch.Tensor  # [Np / T] int32 expert of each tile
    tile_rows: torch.Tensor    # [Np / T] int32 real rows of each tile
    np_: int                   # buffer height (static)


def ragged_routing(topi: torch.Tensor, num_experts: int,
                   t: int = TOKEN_TILE) -> RaggedRouting:
    """The sort and padding of ``moe_mlp_ragged`` for expert choices
    ``topi`` [N, k]; ``dest`` and ``tile_expert`` equal the JAX package's."""
    n, k = topi.shape
    dev = topi.device
    nk = n * k
    np_ = -(-(nk + num_experts * (t - 1)) // t) * t
    flat_e = topi.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount(length=E) as a comparison sum: torch.bincount reads its
    # input's max back to the host on CUDA
    counts = (flat_e[:, None] == torch.arange(num_experts, device=dev)).sum(0)
    padded = (counts + t - 1) // t * t                  # per-expert region
    region_end = torch.cumsum(padded, 0)
    starts = region_end - padded
    group_start = torch.cumsum(counts, 0) - counts      # in sorted order
    ranks = torch.arange(nk, device=dev) - group_start[sorted_e]
    dest = starts[sorted_e] + ranks
    # expert of each tile: the padded region holding its first row
    tile_first = torch.arange(np_ // t, device=dev) * t
    tile_expert = torch.searchsorted(region_end, tile_first, right=True)
    tile_expert = torch.clamp(tile_expert, max=num_experts - 1)
    # real rows are a prefix of each region; trailing tiles have none
    tile_rows = torch.clamp(starts[tile_expert] + counts[tile_expert]
                            - tile_first, 0, t)
    return RaggedRouting(order, dest, tile_expert.to(torch.int32),
                         tile_rows.to(torch.int32), np_)


Weight = Union[QTensor, torch.Tensor]


def moe_mlp_ragged(xf: torch.Tensor, topi: torch.Tensor, topw: torch.Tensor,
                   gate_w: Weight, up_w: Weight, down_w: Weight,
                   act: Callable[[torch.Tensor], torch.Tensor],
                   num_experts: int) -> torch.Tensor:
    """Exact sorted-dispatch MoE MLP. xf [N, D]; topi [N, k] expert ids;
    topw [N, k] f32 routing weights; gate/up [E, D, F] and down [E, F, D]
    stacks of a gated MLP, ``act(x @ gate) * (x @ up) @ down``. Returns
    [N, D] in xf.dtype."""
    n, k = topi.shape
    d = xf.shape[1]
    r = ragged_routing(topi, num_experts)
    flat_tok = torch.arange(n * k, device=xf.device) // k
    xbuf = xf.new_zeros((r.np_, d))
    xbuf.index_copy_(0, r.dest, xf.index_select(0, flat_tok[r.order]))

    def mm(a, w):
        return ragged_expert_matmul(a, w, r.tile_expert, r.tile_rows).to(
            xf.dtype)

    h = act(mm(xbuf, gate_w)) * mm(xbuf, up_w)
    y = mm(h, down_w)                                   # [Np, D]
    # buffer row of each (token, choice) pair in pair order
    pair_dest = torch.empty_like(r.dest)
    pair_dest[r.order] = r.dest
    contrib = y.index_select(0, pair_dest) \
        * topw.reshape(-1, 1).to(y.dtype)
    return contrib.reshape(n, k, d).sum(dim=1)
