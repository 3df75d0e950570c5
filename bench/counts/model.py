"""FLOPs of the COSTREAM GNN ensemble for one call, from its real rows (the ``mfu`` metrics).

Per member: every two-layer MLP costs ``2 fi h + h + 2 h fo + fo`` (products and bias adds; the
ReLU is not counted); every state summed into a message or the readout costs one add per element.
Stage 0 runs once per graph of ``work.stage0``, stages 1 to 3 and the readout once per answered
graph or candidate; stage 3 updates each operator once, at its own depth, from its parents.
Padding rows, trimmed layouts and levels with no operator cost nothing.
"""

OP_FEATURES, HW_FEATURES = 39, 4


def mlp(fi: int, h: int, fo: int) -> int:
    return 2 * fi * h + h + 2 * h * fo + fo


def flops(work) -> float:
    H, s0, r = work.hidden, work.stage0, work.rows
    ops, hws = int(r.n_ops.sum()), int(r.n_hw.sum())
    per_member = (
        int(s0.n_ops.sum()) * mlp(OP_FEATURES, H, H) + int(s0.n_hw.sum()) * mlp(HW_FEATURES, H, H)
        + ops * H + hws * mlp(2 * H, H, H)  # stage 1: hosts absorb their operators
        + ops * mlp(2 * H, H, H)  # stage 2: operators absorb their host
        + int(r.depth_rows[:, 1:].sum()) * mlp(2 * H, H, H) + int(r.depth_edges[:, 1:].sum()) * H  # stage 3
        + (ops + hws) * H + len(r.n_ops) * mlp(H, H, 1)  # readout
    )
    return float(work.members * per_member)
