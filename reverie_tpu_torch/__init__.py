"""reverie_tpu_torch -- the PyTorch / CUDA (H100) port of reverie_tpu.

The first slice runs the GF(2) prove -> verify main path: the AES-CTR mask
tape and the BLAKE3 chunk chaining values are hand-written CUDA kernels
(`csrc/`), the levelized executor and the hash tail are plain torch.  Proofs
are byte-identical to reverie_tpu's.  The circuit compiler, proof container,
Fiat-Shamir challenge and host crypto are shared with reverie_tpu (its
JAX-free modules); this package never imports jax.
"""

from .backend.host import TorchKKW
from .device import default_device

__all__ = ["TorchKKW", "default_device"]
