"""hnsw-slim-tpu on PyTorch + CUDA: the port of the JAX engine to one NVIDIA
Hopper card.

Module paths mirror the JAX package (``hnsw_slim_tpu``), which stays the
reference. Plain tensor code is PyTorch; the device programs with an
arithmetic body on the serving and build paths are hand-written CUDA
kernels under ``csrc/`` (see ``ops/cuda.py``). Every kernel wrapper runs its
plain PyTorch version when handed CPU tensors, and the kernel when handed
CUDA tensors. Entry points default to the CUDA card and raise without one;
pass ``device="cpu"`` to run on the CPU.

    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.index.slimzero import HnswSlimZeroIndex
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.index.bruteforce import BruteForceIndex

``config.py``, ``utils/data.py`` and ``utils/native.py`` are byte-equal
copies of the JAX package's jax-free modules (a test holds them equal), so
the port never imports the JAX package.
"""

from .config import HnswConfig, QuantConfig, SearchConfig, SlimConfig
from .index.slimq import HnswSlimQIndex

__all__ = ["HnswConfig", "SlimConfig", "SearchConfig", "QuantConfig",
           "HnswSlimQIndex"]
