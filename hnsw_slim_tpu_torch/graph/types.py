"""Flat-array graph containers (port of hnsw_slim_tpu/graph/types.py).

    nbr     int32[E_pad]        all nodes' neighbor ids, concatenated
    lvl_off int32[N, L_max+2]   level-l slice of node v is
                                nbr[lvl_off[v,l] : lvl_off[v,l+1]]
    level   int32[N]            element level (-1 on padding rows)

The arrays are torch tensors on the index's device; ``from_numpy`` builds
them from host arrays (e.g. the JAX package's ``.npz`` checkpoints).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChalGraph:
    """Pruned (Slim) hierarchical adjacency in flat arrays."""

    nbr: torch.Tensor  # int32[E_pad]
    lvl_off: torch.Tensor  # int32[N_pad, L_max+2]
    level: torch.Tensor  # int32[N_pad]
    entry: int
    max_level: int
    threshold_level: int
    cap0: int  # max level-0 degree
    cap: int  # max upper degree
    n_real: int = 0  # logical element count when node-padded (0 = unpadded)

    @classmethod
    def from_numpy(cls, nbr, lvl_off, level, *, entry, max_level,
                   threshold_level, cap0, cap, device, n_real=0):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        return cls(t(nbr), t(lvl_off), t(level), int(entry), int(max_level),
                   int(threshold_level), int(cap0), int(cap), int(n_real))

    @property
    def n(self) -> int:
        return self.n_real or self.level.shape[0]

    def chal_bytes(self) -> int:
        """Graph-only bytes in the reference's indexSize accounting: 16 B per
        node + a u16 offset per level + a u32 per neighbor id."""
        off = self.lvl_off.cpu().numpy()
        levels = self.level.cpu().numpy()
        real = levels >= 0
        total_nbrs = int((off[:, -1] - off[:, 0]).astype(np.int64).sum())
        return int(16 * int(real.sum()) + 2 * int(levels[real].sum())
                   + 4 * total_nbrs)


def pad_chal_nodes(chal: ChalGraph, multiple: int = 65536) -> ChalGraph:
    """Pad the node dimension to a multiple, so that serving arrays keep
    their size across updates. Padding rows: level -1 and saturated (empty)
    offset slices, unreachable by any traversal."""
    logical = chal.n
    n = chal.level.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return chal if chal.n_real else dataclasses.replace(chal, n_real=n)
    lvl_off = torch.cat([
        chal.lvl_off,
        chal.lvl_off[-1, -1].expand(n_pad - n, chal.lvl_off.shape[1])])
    level = torch.cat([
        chal.level, torch.full((n_pad - n,), -1, dtype=torch.int32,
                               device=chal.level.device)])
    return dataclasses.replace(chal, lvl_off=lvl_off, level=level,
                               n_real=logical)


@dataclasses.dataclass(frozen=True)
class LevelGraph:
    """Unpruned build-time HNSW adjacency: one dense padded array per level,
    adjs[l] int32[N, M_l] (-1 padded); rows matter for nodes with level >= l."""

    adjs: tuple  # tuple of int32[N_pad, M_l]
    level: torch.Tensor  # int32[N_pad]
    entry: int
    max_level: int
    n_real: int = 0

    @classmethod
    def from_numpy(cls, adjs, level, *, entry, max_level, device, n_real=0):
        return cls(
            tuple(torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=device) for a in adjs),
            torch.as_tensor(np.ascontiguousarray(level, np.int32),
                            device=device),
            int(entry), int(max_level), int(n_real),
        )

    @property
    def n(self) -> int:
        return self.n_real or self.level.shape[0]
