"""All-pairs SNP distances over a dp x sp process mesh (counterpart of
tracs_tpu/parallel/allpairs.py, on torch.distributed).

Every engine is the one-device split path (ops/pairsnp.py: the gram kernels
``split_gram`` and ``partial_gram``, then ``coo_extract``: the D/NN assembly,
the threshold and the COO compaction in one kernel) applied to one rank's
shard: samples split over ``dp``, packed words over ``sp``.  A rank uploads
only its shard, as the raw planes, and builds the N-exclusive planes and
the N mask on its device with ``split_layout``, as ``split_alignment`` does.
Word shards are ``pad_to(W, 8 * sp) / sp`` words, a multiple of the
kernels' word pitch.  The sp ranks hold partial grams of the same pairs,
which one ``psum`` adds; every value is an exact int32 sum, so every output equals the
one-device run bit for bit whatever the mesh's shape.

1. ``ShardedSweep``: a row block against the whole sample set.  The DB side
   is split as column slabs over dp and words over sp, uploaded once; each
   row block is uploaded by every rank (replicated over dp, its own word
   shard over sp).  A block is K1 on the shard, ``psum`` over sp, then
   every dp rank compacts its own column slab and one gather over dp brings
   all survivors to every rank, back in row-major order.  Used for
   rectangles, runs that resume past row 0 and runs over the ring's budget.
2. ``RingCoo``: the triangle ring for a self all-pairs run from row 0.  Each
   dp rank holds one stripe of samples; a travelling copy rotates around the
   dp ring for ``n_dp // 2 + 1`` steps, and each [B, B] block computed at
   step s goes back, transposed, to rank ``my - s``, so every pair of
   stripes meets once.  Then ``psum`` over sp, COO per stripe, and one
   gather brings every stripe's survivors to every rank.
3. ``sharded_snp_distance``: the ring's dense (D, NN) matrices on every rank.

SPMD: every rank of the mesh calls the same engine with the same arguments
and gets the same results.  Left out of the port (ROADMAP.md): the ring's
sticky capacity, survivor-density hint and overflow re-extract; the port's
compaction (``coo_extract``) sizes its output on the host from the block's
geometry (``coo_capacity``: every pair in range fits), so nothing overflows.
"""

from __future__ import annotations

import numpy as np
import torch

from tracs_tpu_torch.ops.kernels import (_as_words, coo_capacity, pad_planes, partial_gram,
                                         split_gram, split_layout)
from tracs_tpu_torch.ops.packing import PackedAlignment, compact_variant_columns
from tracs_tpu_torch.ops.pairsnp import (
    _extract_coo,
    _split_device,
    _split_pair,
    snp_distance_dense,
)
from tracs_tpu_torch.parallel import mesh as _mesh
from tracs_tpu_torch.parallel.mesh import all_gather_rows, pad_to, ppermute, psum
from tracs_tpu_torch.runtime.device import resolve_device

#: tracs_tpu's budget for the gram's chunk temporaries, kept so that
#: ``RingCoo.fits`` does tracs_tpu's arithmetic; here it stands for the
#: device's temporaries beside the ring's tensors (the correction gram's
#: chunks, the kernel's outputs, the filter's layout)
_CHUNK_BYTES_BUDGET = 5 << 30

#: device memory the ring may assume off the card: tracs_tpu's figure for a
#: TPU v5e (16 GB, less headroom), so that the CPU's decisions equal its
_DEVICE_HBM_BYTES = 14 << 30

#: on a CUDA card the ring may assume the card's memory less this much: the
#: CUDA context, the caching allocator's slack and the other processes that
#: may share the card
_CUDA_HEADROOM_BYTES = 8 << 30


def _dims(mesh) -> tuple[int, int]:
    """(dp, sp) of a DeviceMesh or of a (dp, sp) pair."""
    dp, sp = (int(x) for x in (mesh.shape if hasattr(mesh, "shape") else mesh))
    return dp, sp


def device_bytes(device=None) -> int:
    """Device memory the ring may plan with on ``device``."""
    if device is None or torch.device(device).type != "cuda":
        return _DEVICE_HBM_BYTES
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return total - _CUDA_HEADROOM_BYTES


class _Ranks:
    """This rank's place in a mesh: (dp, sp) sizes, its coordinates and the
    groups of its dp ring and its sp column."""

    def __init__(self, mesh):
        self.dp, self.sp = _dims(mesh)
        self.my_dp, self.my_sp = (int(c) for c in mesh.get_coordinate())
        self.dp_group = mesh.get_group("dp")
        self.sp_group = mesh.get_group("sp")


def _host_slice(arr: np.ndarray, r0: int, r1: int, rows: int, w0: int, w1: int) -> np.ndarray:
    """Rows [r0, r1) and words [w0, w1) of ``arr`` ([n, ..., W] words) as a
    fresh [rows, ..., w1 - w0] array, zero where the ranges pass the array."""
    out = np.zeros((rows, *arr.shape[1:-1], w1 - w0), dtype=arr.dtype)
    r1, we = min(r1, arr.shape[0]), min(w1, arr.shape[-1])
    if r1 > r0 and we > w0:
        out[: r1 - r0, ..., : we - w0] = arr[r0:r1, ..., w0:we]
    return out


class _Shard:
    """Rows [r0, r0 + rows) of a SplitAlignment and this rank's word shard,
    on ``device``: N-exclusive planes and N mask built there from the raw
    planes (``split_layout``), the partial-site words sliced from the
    layout's own on the device it was built on (at the card's word pitch,
    ``pad_planes``: zero words add nothing to the correction gram) and the
    N counts.  Rows past the alignment are zero and count no N."""

    def __init__(self, sa, r0: int, rows: int, ranks: _Ranks, device: torch.device):
        partial = _split_device(sa, sa.device)[2].cpu().numpy()
        W, Wp = sa.src.planes.shape[2], partial.shape[2]
        ws = pad_to(max(W, 1), 8 * ranks.sp) // ranks.sp
        wps = pad_to(max(Wp, 1), ranks.sp) // ranks.sp
        s = ranks.my_sp
        planes = _host_slice(sa.src.planes, r0, r0 + rows, rows, s * ws, (s + 1) * ws)
        self.ex, self.nm = split_layout(_as_words(planes).to(device))[:2]
        self.pt = pad_planes(torch.from_numpy(
            _host_slice(partial, r0, r0 + rows, rows, s * wps, (s + 1) * wps)).to(device))
        cnt = np.zeros(rows, dtype=np.int32)
        r1 = min(r0 + rows, sa.n_seqs)
        if r1 > r0:
            cnt[: r1 - r0] = sa.cnt_n[r0:r1]
        self.cnt = torch.from_numpy(cnt).to(device)


def _gather_coo(parts, ranks: _Ranks, device) -> list[np.ndarray]:
    """Every dp rank's survivors ([k, 4]: row, column, d, nn), in dp order."""
    return all_gather_rows(np.stack(parts, axis=1), ranks.dp_group, device)


class ShardedSweep:
    """Row blocks of ``sa`` against every row of ``sb`` on a mesh (the
    engine behind ``pairsnp_stream(..., mesh=...)`` for rectangles, resumed
    runs and runs over the ring's budget).  ``sa``/``sb`` share the partial
    gather axis (``ops.pairsnp._split_pair`` builds them so); the DB side's
    shard is uploaded once, here."""

    def __init__(self, sa, sb, mesh, device):
        if sa.length != sb.length:
            raise ValueError("alignments must share sequence length")
        self.sa, self.sb = sa, sb
        self.device = resolve_device(device)
        self.ranks = _Ranks(mesh)
        self.n_pad = pad_to(max(sb.n_seqs, 1), self.ranks.dp)
        self.bn = self.n_pad // self.ranks.dp
        self.c0 = self.ranks.my_dp * self.bn  # first global column of this slab
        self.partial = bool(sa.n_partial or sb.n_partial)
        self._db = _Shard(sb, self.c0, self.bn, self.ranks, self.device)

    def launch(self, r0: int, r1: int) -> dict:
        """The grams of rows [r0, r1) against this rank's column slab, int32
        [r1 - r0, bn] summed over the sp ranks (the correction gram inside
        g), with both sides' N counts: the keyword arguments of
        ``kernels.coo_extract`` (split mode) for the block."""
        row = _Shard(self.sa, r0, r1 - r0, self.ranks, self.device)
        g, gn = split_gram(row.ex, row.nm, 0, r1 - r0, 0, self._db.ex, self._db.nm)
        if self.partial:
            g += partial_gram(row.pt, self._db.pt)
        return {"mode": "split", "g": psum(g, self.ranks.sp_group),
                "gn": psum(gn, self.ranks.sp_group), "cnt_a": row.cnt, "cnt_b": self._db.cnt}

    def block(self, r0: int, r1: int, threshold: int, *, triangle: bool):
        """(rows_local, cols, dvals, nvals) of rows [r0, r1), as
        ``ops.pairsnp._extract_coo`` gives them on one device: each dp rank
        compacts its own slab (global columns, padded ones dropped), one
        gather brings every slab to every rank, and a stable sort on
        ``row * n + col`` restores row-major order."""
        mine = _extract_coo(self.launch(r0, r1), self.sa.length, threshold, r0,
                            self.sb.n_seqs, self.c0, triangle=triangle)
        coo = np.concatenate(_gather_coo(mine, self.ranks, self.device))
        order = np.argsort(coo[:, 0] * self.sb.n_seqs + coo[:, 1], kind="stable")
        return tuple(coo[order].T)


def _ring_grams(shard: _Shard, ranks: _Ranks, partial: bool):
    """(match-gram rows, N-gram rows), int32 [B, n_dp * B], of this rank's
    stripe against every stripe, summed over sp: the triangle schedule.

    Step s computes the block of stripes (my, my - s) against the travelling
    copy; the block goes back transposed to rank my - s, where it is the
    block (my - s, my).  For even n_dp the last step's partner column is the
    rank's own store ((my - half) = (my + half) mod n_dp), so no block goes
    back then.  Step 0 is the stripe against itself."""
    B = shard.ex.shape[0]
    n_dp, my = ranks.dp, ranks.my_dp
    dev = shard.ex.device
    m_rows = torch.zeros((B, n_dp * B), dtype=torch.int32, device=dev)
    n_rows = torch.zeros((B, n_dp * B), dtype=torch.int32, device=dev)
    half = n_dp // 2
    trav = [shard.ex, shard.nm] + ([shard.pt] if partial else [])
    for step in range(half + 1):
        if step == 0:
            g, gn = split_gram(shard.ex, shard.nm, 0, B, 0)
        else:
            g, gn = split_gram(shard.ex, shard.nm, 0, B, 0, trav[0], trav[1])
        if partial:
            g += partial_gram(shard.pt, trav[2])
        origin = (my - step) % n_dp
        m_rows[:, origin * B:(origin + 1) * B] = g
        n_rows[:, origin * B:(origin + 1) * B] = gn
        if step > 0 and (n_dp % 2 == 1 or step < half):
            g_t, gn_t = ppermute([g.T, gn.T], ranks.dp_group, -step)
            src = (my + step) % n_dp
            m_rows[:, src * B:(src + 1) * B] = g_t
            n_rows[:, src * B:(src + 1) * B] = gn_t
        if step < half:
            trav = ppermute(trav, ranks.dp_group, 1)
    return psum(m_rows, ranks.sp_group), psum(n_rows, ranks.sp_group)


def _ring_shard(sa, mesh, device):
    """(ranks, stripe rows B, this rank's stripe shard) of a ring over ``sa``."""
    ranks = _Ranks(mesh)
    B = pad_to(max(sa.n_seqs, 1), ranks.dp) // ranks.dp
    return ranks, B, _Shard(sa, ranks.my_dp * B, B, ranks, device)


class RingCoo:
    """The triangle ring for a self all-pairs run from row 0 (the engine
    behind ``pairsnp_stream(..., mesh=...)`` when ``fits`` holds).  The whole
    matrix is one pass: the device holds [B, n_pad] int32 stripes whatever
    the row block, and ``stripes`` yields once they are all computed, one
    dp stripe at a time in row order."""

    @staticmethod
    def stripe_bytes(n: int, mesh) -> int:
        """Peak per-rank bytes of the ring's own tensors, the largest over
        the ranks: the m and n gram rows, two [B, n_pad] int32, beside the
        larger of ``coo_extract``'s output (16 B for each pair it can keep
        from the rank's stripe, ``coo_capacity``) and a ring step's blocks
        (g, gn and the correction gram, three [B, B] int32; at dp >= 3 a
        step also sends its g, gn back and receives the partner's, six).
        tracs_tpu counts 16 B a stripe pair instead: its four stripes."""
        dp, _ = _dims(mesh)
        B = pad_to(max(n, 1), dp) // dp
        rows = 2 * B * (B * dp) * 4
        out = max(coo_capacity(B, B * dp, r * B, 0, n, True) for r in range(dp)) * 16
        step = (6 if dp >= 3 else 3) * B * B * 4
        return rows + max(out, step)

    @staticmethod
    def operand_bytes(n: int, mesh, n_words: int) -> int:
        """Per-rank bytes of the resident operands: the rank's stripe and the
        travelling copy, 5 word planes each, sharded over sp."""
        dp, sp = _dims(mesh)
        B = pad_to(max(n, 1), dp) // dp
        w_shard = pad_to(max(n_words, 1), 8 * sp) // sp
        return 2 * 5 * B * w_shard * 4

    @classmethod
    def fits(cls, n: int, mesh, n_words: int | None = None, device=None) -> bool:
        """Whether a ring at (n, mesh[, n_words]) stays inside the budgets:
        the stripes within ``RING_STRIPE_BYTES``, and with ``n_words`` the
        stripes, the operands and ``_CHUNK_BYTES_BUDGET`` within the
        device's memory (``device_bytes``).  Off the card the budgets are
        tracs_tpu's; the stripes are the port's own (``stripe_bytes``)."""
        stripes = cls.stripe_bytes(n, mesh)
        if stripes > _mesh.RING_STRIPE_BYTES:
            return False
        if n_words is not None:
            total = stripes + cls.operand_bytes(n, mesh, n_words) + _CHUNK_BYTES_BUDGET
            if total > device_bytes(device):
                return False
        return True

    def __init__(self, sa, mesh, threshold: int, device):
        self.sa = sa
        self.threshold = int(threshold)
        self.device = resolve_device(device)
        self.ranks, self.B, self._shard = _ring_shard(sa, mesh, self.device)
        cnt = np.zeros(self.B * self.ranks.dp, dtype=np.int32)
        cnt[: sa.n_seqs] = sa.cnt_n
        self._cnt_all = torch.from_numpy(cnt).to(self.device)

    def stripes(self):
        """Yield (r0, r1, rows_local, cols, dvals, nvals) per dp stripe in
        ascending row order: the contract of one row block of the
        one-device stream."""
        sa, ranks, B = self.sa, self.ranks, self.B
        m_rows, n_rows = _ring_grams(self._shard, ranks, bool(sa.n_partial))
        r0 = ranks.my_dp * B
        grams = {"mode": "split", "g": m_rows, "gn": n_rows, "cnt_a": self._shard.cnt,
                 "cnt_b": self._cnt_all}
        mine = _extract_coo(grams, sa.length, self.threshold, r0, sa.n_seqs, 0, triangle=True)
        del grams, m_rows, n_rows
        parts = _gather_coo(mine, ranks, self.device)
        for d, coo in enumerate(parts):
            r0 = d * B
            if r0 >= sa.n_seqs:
                break
            yield (r0, min(sa.n_seqs, r0 + B), *coo.T)


def sharded_snp_distance(packed: PackedAlignment, mesh=None, *, device,
                         compact: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (D, NN) int32 numpy matrices over a mesh by the triangle
    ring, identical on every rank and equal to ``snp_distance_dense`` bit
    for bit.  ``mesh`` None is every rank of the world as dp
    (``global_mesh()``), and one device without a process group.
    ``compact`` drops the alignment columns that cannot change a distance
    first (D unchanged, NN shifted by a scalar), which shrinks the sharded
    word axis and the ring's traffic."""
    device = resolve_device(device)
    if mesh is None:
        if not torch.distributed.is_initialized():
            return snp_distance_dense(packed, device=device, method="split")
        from tracs_tpu_torch.parallel.multihost import global_mesh

        mesh = global_mesh()
    nn_off = 0
    if compact:
        comp = compact_variant_columns(packed)
        if comp is not None:
            packed, nn_off = comp[0], comp[3]
    sa, _ = _split_pair(packed, None)
    n, L = sa.n_seqs, sa.length
    ranks, B, shard = _ring_shard(sa, mesh, device)
    m_rows, n_rows = _ring_grams(shard, ranks, bool(sa.n_partial))
    m = np.concatenate(all_gather_rows(m_rows.cpu().numpy(), ranks.dp_group, device))[:n, :n]
    gn = np.concatenate(all_gather_rows(n_rows.cpu().numpy(), ranks.dp_group, device))[:n, :n]
    cnt = sa.cnt_n[:, None] + sa.cnt_n[None, :]
    D = (L - (m + cnt)).astype(np.int32)
    NN = (L - cnt + gn + nn_off).astype(np.int32)
    return D, NN
