"""hnsw-slim-tpu on PyTorch + CUDA: the port of the JAX engine to one NVIDIA
Hopper card.

Module paths mirror the JAX package (``hnsw_slim_tpu``), which stays the
reference. Plain tensor code is PyTorch; the device programs with an
arithmetic body on the serving and build paths are hand-written CUDA
kernels under ``csrc/`` (see ``ops/cuda.py``). Every kernel wrapper runs its
plain PyTorch version when handed CPU tensors, and the kernel when handed
CUDA tensors. Entry points default to the CUDA card and raise without one;
pass ``device="cpu"`` to run on the CPU.

    from hnsw_slim_tpu_torch import (
        HnswConfig, SlimConfig, SearchConfig, QuantConfig,
        HnswIndex, HnswSlimIndex, HnswSlimZeroIndex, HnswSlimQIndex,
        BruteForceIndex, ShardedSlimIndex, SlimServer, SlimClient,
    )

The index classes and the HTTP server and client resolve lazily, so
importing the package loads no index or serving module. ``FlatUnionIndex``
lives in ``parallel/flat_union.py``.

``config.py``, ``utils/data.py``, ``utils/native.py``, ``utils/io.py``,
``eval/recall.py`` and ``tools.py`` are byte-equal copies of the JAX
package's jax-free modules (a test holds them equal), so the port never
imports the JAX package. ``python -m hnsw_slim_tpu_torch.strategy`` is the
benchmark CLI.
"""

from .config import HnswConfig, QuantConfig, SearchConfig, SlimConfig

__all__ = [
    "HnswConfig", "SlimConfig", "SearchConfig", "QuantConfig",
    "HnswIndex", "HnswSlimIndex", "HnswSlimZeroIndex", "HnswSlimQIndex",
    "BruteForceIndex", "ShardedSlimIndex", "SlimServer", "SlimClient",
]

# name -> (module, attribute), imported on first use
_LAZY = {
    "HnswIndex": (".index.hnsw", "HnswIndex"),
    "HnswSlimIndex": (".index.slim", "HnswSlimIndex"),
    "HnswSlimZeroIndex": (".index.slimzero", "HnswSlimZeroIndex"),
    "HnswSlimQIndex": (".index.slimq", "HnswSlimQIndex"),
    "BruteForceIndex": (".index.bruteforce", "BruteForceIndex"),
    "ShardedSlimIndex": (".parallel.sharded", "ShardedSlimIndex"),
    "SlimServer": (".serve.server", "SlimServer"),
    "SlimClient": (".serve.client", "SlimClient"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    module, attr = _LAZY[name]
    return getattr(importlib.import_module(module, __name__), attr)
