"""reverie_tpu_torch -- the PyTorch / CUDA (H100) port of reverie_tpu.

`TorchKKW` proves and verifies GF(2), Z_2^64 and B2A circuits on one CUDA
card, one proof at a time or in batches and pipelines (`prove_batch`,
`prove_batch_chunked`, `prove_many`, `verify_many`; `device_footprint`,
`pipeline_footprint` and `largest_batch` size a batch).  The AES-CTR mask
tapes and the BLAKE3 chunk chaining values are hand-written CUDA kernels
(`csrc/`), the levelized executor and the hash tail are plain torch.
Proofs are byte-identical to reverie_tpu's.

The package stands on its own: it imports neither jax nor reverie_tpu.  It
keeps its own copies of the circuit IR, compiler, builders and bincode
(`circuit/`), the proof container and Fiat-Shamir challenge (`proof/`), the
protocol parameters (`params.py`) and the host C crypto (`crypto/`,
`native/`).  Programs and proofs cross between the two packages as bytes:
`circuit.load_program(reverie_tpu.circuit.dumps_program(p))` and
`proof.Proof.from_bytes(p.to_bytes())`.

`tools/` holds the measurement probes (the ports of reverie_tpu's
`tools/r2_measure.py`, `r4_bwroof.py`, `r5_u8emit.py` and
`r4_extract_probe.py`) with their CUDA kernels.
"""

from .backend.host import TorchKKW, device_footprint, largest_batch, pipeline_footprint
from .device import default_device

__all__ = ["TorchKKW", "default_device", "device_footprint", "largest_batch",
           "pipeline_footprint"]
