"""Runtime guard bits, the same bits and names as ``aosx.guards``.

The reference has no caps (unbounded std::vectors); the padded buffers and
banded passes have documented preconditions. Each stage ORs a bit into an
int32 guard mask when its precondition breaks, so a silently coarser or
truncated result is detected rather than trusted. The mask rides the World
and the per-tick metrics; `describe()` renders it for logs.
"""

from __future__ import annotations

GUARD_ROR_SPAN = 1        # sorted-sweep ROR block-span precondition violated
GUARD_SKEL_OVERFLOW = 2   # skeleton cells exceed max_skel_cells (dropped)
GUARD_CLUSTER_LEN = 4     # a cluster exceeds the banded exact-length block
GUARD_EDGE_COARSE = 8     # an edge sampled coarser than the reference
GUARD_PROX_PPN = 16       # a node had more than PPN proximity partners
GUARD_CROSS_DENSE = 32    # packed crossing overflowed -> dense fallback
GUARD_CCL_CELL_FALLBACK = 64  # run-level CCL overflowed -> cell-level path
GUARD_NONFINITE = 128     # NaN/Inf leaked into a published tick output
GUARD_RIDGE_COMPACT = 256  # ridge candidate compaction overflowed (fast mode)
GUARD_DEGREE_CAP = 512    # a node exceeded max_degree; CSR edges dropped
GUARD_CLUSTER_CAP = 1024  # skeleton components exceed max_clusters (dropped)
GUARD_PLAN_CAP = 2048     # published /plan filled max_plan (likely truncated)

_NAMES = {
    GUARD_ROR_SPAN: "ror_sorted_block_span",
    GUARD_SKEL_OVERFLOW: "skel_cells_overflow",
    GUARD_CLUSTER_LEN: "cluster_length_band_exceeded",
    GUARD_EDGE_COARSE: "edge_sampling_coarse",
    GUARD_PROX_PPN: "proximity_partners_capped",
    GUARD_CROSS_DENSE: "crossing_dense_fallback",
    GUARD_CCL_CELL_FALLBACK: "ccl_cell_level_fallback",
    GUARD_NONFINITE: "nonfinite_tick_output",
    GUARD_RIDGE_COMPACT: "ridge_candidate_compaction_overflow",
    GUARD_DEGREE_CAP: "astar_degree_capped",
    GUARD_CLUSTER_CAP: "cluster_count_capped",
    GUARD_PLAN_CAP: "plan_buffer_filled",
}


def describe(mask: int) -> list[str]:
    return [name for bit, name in _NAMES.items() if int(mask) & bit]
