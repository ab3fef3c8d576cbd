"""FhtKac rotator (port of hnsw_slim_tpu/quant/rotator.py): random sign
flips and four rounds of the fast Hadamard transform.

The whole state is 4 * padded_dim flip bits; ``rotate`` is four rounds of
[sign flip -> FHT -> scale 1/sqrt(P)] on rows zero-padded to P, a power of
two >= 64. ``fht`` and ``_rotate`` are the plain PyTorch version;
``fht_rotate`` runs kernel Kη (csrc/fht_rotate.cu) on CUDA tensors. The
kernel keeps the plain version's butterfly order (h = 1, 2, .. P/2, one add
or subtract per element and stage), so both give the same bits.

``g_tables`` is the per-query part of the RaBitQ estimate that the same
source computes on the card: sum(q_rot) and the per-(query, centroid)
``g_add`` table, ||q - c||^2 in the difference form (L2) or -<q, c> (IP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda


def pad_dim(dim: int) -> int:
    p = 1
    while p < dim:
        p *= 2
    return max(p, 64)


def fht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Hadamard transform over the last axis (pow2)."""
    b, p = x.shape
    h = 1
    while h < p:
        x = x.reshape(b, p // (2 * h), 2, h)
        a0, a1 = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.stack([a0 + a1, a0 - a1], dim=2).reshape(b, p)
        h *= 2
    return x


def _rotate(x: torch.Tensor, signs: torch.Tensor, fac: float) -> torch.Tensor:
    """Plain PyTorch Kη: x f32[B, P] (already padded), signs f32[4, P]."""
    fac = torch.tensor(fac, dtype=torch.float32, device=x.device)
    for r in range(4):
        x = x * signs[r][None, :]
        x = fht(x) * fac
    return x


def fht_rotate(x: torch.Tensor, signs: torch.Tensor,
               fac: float) -> torch.Tensor:
    """Kη: f32[B, P] rotation of f32[B, D <= P] rows (zero padded), one warp
    per row. CPU tensors run ``_rotate``."""
    b, d = x.shape
    p = signs.shape[1]
    if not x.is_cuda:
        if d < p:
            x = torch.nn.functional.pad(x, (0, p - d))
        return _rotate(x, signs, fac)
    if d > p or p < 64 or p & (p - 1) or p > 4096:
        raise ValueError(f"fht_rotate: dim {d}, padded dim {p}")
    cuda.require(x, torch.float32, "x", (b, d))
    cuda.require(signs, torch.float32, "signs", (4, p))
    out = torch.empty((b, p), dtype=torch.float32, device=x.device)
    if b:
        cuda.launch("fht_rotate", x.data_ptr(), signs.data_ptr(), fac, b, d,
                    p, out.data_ptr())
    return out


def g_tables_plain(q_rot, centroids_rot, metric: str = "l2"):
    """(sumq f32[B], g_add f32[B, C]) in plain PyTorch."""
    from .estimator import centroid_g_tables

    return q_rot.sum(dim=1), centroid_g_tables(q_rot, centroids_rot, metric)[0]


def g_tables(q_rot, centroids_rot, metric: str = "l2"):
    """(sumq f32[B], g_add f32[B, C]) for a batch of rotated queries: the
    small kernel beside Kη on CUDA tensors, ``g_tables_plain`` on the CPU."""
    if not q_rot.is_cuda:
        return g_tables_plain(q_rot, centroids_rot, metric)
    b, p = q_rot.shape
    c = centroids_rot.shape[0]
    cuda.require(q_rot, torch.float32, "q_rot", (b, p))
    cuda.require(centroids_rot, torch.float32, "centroids_rot", (c, p))
    sumq = torch.empty((b,), dtype=torch.float32, device=q_rot.device)
    g_add = torch.empty((b, c), dtype=torch.float32, device=q_rot.device)
    if b:
        cuda.launch("fht_rotate", q_rot.data_ptr(), centroids_rot.data_ptr(),
                    b, c, p, int(metric == "ip"), sumq.data_ptr(),
                    g_add.data_ptr(), entry="g_tables", modes=("g_tables",))
    return sumq, g_add


class FhtKacRotator:
    def __init__(self, dim: int, seed: int = 0,
                 flip_bits: np.ndarray | None = None, device=None):
        self.dim = dim
        self.padded_dim = pad_dim(dim)
        self.device = cuda.resolve_device(device)
        if flip_bits is None:
            rng = np.random.default_rng(seed)
            flip_bits = rng.integers(
                0, 256, size=(4, self.padded_dim // 8), dtype=np.uint8
            )
        self.flip_bits = np.asarray(flip_bits, np.uint8)  # serialized state
        bits = np.unpackbits(self.flip_bits, axis=1, bitorder="little")
        self.signs = torch.as_tensor(
            (1.0 - 2.0 * bits[:, : self.padded_dim]).astype(np.float32),
            device=self.device)
        self.fac = float(np.float32(1.0 / np.sqrt(self.padded_dim)))

    def rotate(self, x) -> torch.Tensor:
        """f32[B, padded_dim] rotation of f32[B, dim] (a numpy array or a
        tensor; zero padded), on the rotator's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        if x.dim() == 1:
            x = x[None]
        return fht_rotate(x.contiguous(), self.signs, self.fac)

    def state(self) -> np.ndarray:
        return self.flip_bits

    @classmethod
    def from_state(cls, dim: int, flip_bits: np.ndarray,
                   device=None) -> "FhtKacRotator":
        return cls(dim, flip_bits=flip_bits, device=device)
