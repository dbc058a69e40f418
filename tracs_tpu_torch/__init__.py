"""tracs_tpu_torch — the PyTorch/CUDA port of tracs_tpu.

It runs the ``distance`` stage (MSA -> packed bit-planes -> row-block sweep
-> threshold and COO -> transmission model -> CSV) on an NVIDIA H100, with
the split-decomposition gram (``csrc/split_gram.cu``) and the popcount
engine (``csrc/popcount_gram.cu``) as hand-written CUDA kernels and the
transmission model in float64 on the card, or on the CPU through the
kernels' plain PyTorch versions.  Every entry point takes an explicit
``device``; nothing here sets global state, and nothing imports jax or
tracs_tpu.  ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from tracs_tpu_torch.ops.packing import (  # noqa: E402
    PackedAlignment,
    from_reference,
    pack_fasta,
    pack_sequences,
)
from tracs_tpu_torch.ops.pairsnp import (  # noqa: E402
    pairsnp,
    pairsnp_stream,
    snp_distance_dense,
)

__all__ = [
    "PackedAlignment",
    "from_reference",
    "pack_fasta",
    "pack_sequences",
    "pairsnp",
    "pairsnp_stream",
    "snp_distance_dense",
    "__version__",
]
