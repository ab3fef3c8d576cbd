"""Kξ's plain version (ops/distance.py sq_norms on CPU tensors) against the
JAX package's sq_norms on the same inputs, made from a seed with numpy:
fp32 and bfloat16 rows of 3, 100, 128 and 960 dims, empty and 1-D inputs.

Tolerance: 1e-6 relative. Both sum the same fp32 squares of positive
terms, in another order (XLA's reduction against torch's); a bfloat16 row
is widened to fp32 exactly by both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.ops import distance as jdist
from hnsw_slim_tpu_torch.ops import distance as tdist

torch.set_num_threads(1)


def _pair(x: np.ndarray, bf16: bool):
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [3, 100, 128, 960])
def test_sq_norms_match_jax(d, bf16):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((513, d)) * 2.5).astype(np.float32)
    jx, tx = _pair(x, bf16)
    got = tdist.sq_norms(tx)
    assert got.dtype == torch.float32 and got.shape == (513,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdist.sq_norms(jx)),
                               rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(0, 128), (128,), (0,), (4, 0),
                                   (2, 3, 17)])
def test_sq_norms_edge_shapes_match_jax(shape, bf16):
    """Empty batches, a 1-D row (a 0-d result), zero-width rows (zeros) and
    a leading batch of two dims all keep JAX's output shape and values."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x, bf16)
    want = np.asarray(jdist.sq_norms(jx))
    got = tdist.sq_norms(tx)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_sq_norms_plain_is_the_cpu_path():
    """On a CPU tensor sq_norms is sq_norms_plain: the same bits."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, 128)).astype(np.float32))
    assert torch.equal(tdist.sq_norms(x), tdist.sq_norms_plain(x))
    assert torch.equal(tdist.sq_norms(x), torch.sum(x * x, dim=-1))
