"""tracs_tpu_torch — the PyTorch/CUDA port of tracs_tpu.

It runs reads to clusters on an NVIDIA H100: ``align`` (reference selection,
pileup parsing, the Dirichlet-multinomial model in float64 on the card),
``combine``, ``distance`` (MSA -> packed bit-planes -> row-block sweep ->
threshold and COO -> transmission model -> CSV, with the split-decomposition
gram ``csrc/split_gram.cu`` and the popcount engine ``csrc/popcount_gram.cu``
as hand-written CUDA kernels), ``cluster``, and ``pipe`` over all of them; or
on the CPU through the kernels' plain PyTorch versions.  ``distance`` and
``pipe`` also run as several processes, one card each, the all-pairs sweep
spread over a dp x sp mesh of them (parallel/).  Every entry point takes an
explicit ``device``; nothing here sets global state, and nothing imports jax
or tracs_tpu.
"""

__version__ = "0.1.0"

from tracs_tpu_torch.ops.packing import (  # noqa: E402
    PackedAlignment,
    from_reference,
    iupac_code_for_mask,
    pack_fasta,
    pack_sequences,
)
from tracs_tpu_torch.ops.pairsnp import (  # noqa: E402
    pairsnp,
    pairsnp_stream,
    snp_distance_dense,
)
from tracs_tpu_torch.models.transcluster import (  # noqa: E402
    calculate_trans_prob,
    lprob_k_given_N,
    trans_dist,
)
from tracs_tpu_torch.models.dirichlet import (  # noqa: E402
    calculate_posteriors,
    find_dirichlet_priors,
)

__all__ = [
    "PackedAlignment",
    "from_reference",
    "pack_fasta",
    "pack_sequences",
    "iupac_code_for_mask",
    "pairsnp",
    "pairsnp_stream",
    "snp_distance_dense",
    "lprob_k_given_N",
    "trans_dist",
    "calculate_trans_prob",
    "find_dirichlet_priors",
    "calculate_posteriors",
    "__version__",
]
