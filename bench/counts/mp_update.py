"""Operations and bytes of each ``mp_update`` launch of an ``estimate`` call (the full-depth scan).

The scan runs one launch per depth d = 1..max_depth over the whole batch.  A launch reads the
state of every real operator row and writes it again (the kernel returns a new state), reads each
graph's real data-flow block, depth and mask, and reads the type bank's weights once; it computes
the update MLP and the parent sum for the operators at depth d only.  float32 throughout.
"""



def mlp(fi: int, h: int, fo: int) -> int:
    """A two-layer MLP's products and bias adds per row (as ``model.py`` counts them)."""
    return 2 * fi * h + h + 2 * h * fo + fo


N_TYPES = 5


def launches(work, max_depth: int = 8):
    """``[(flops, bytes)]``, one per launch, in launch order; ``[]`` for other entries."""
    if work.entry != "estimate":
        return []
    E, H, r = work.members, work.hidden, work.rows
    ops = int(r.n_ops.sum())
    graph_bytes = 4 * int((r.n_ops ** 2 + 2 * r.n_ops).sum())
    weight_bytes = 4 * E * N_TYPES * (2 * H * H + H + H * H + H)
    nbytes = 4 * E * H * 2 * ops + graph_bytes + weight_bytes
    out = []
    for d in range(1, max_depth + 1):
        f = E * (int(r.depth_rows[:, d].sum()) * mlp(2 * H, H, H) + int(r.depth_edges[:, d].sum()) * H)
        out.append((float(f), float(nbytes)))
    return out
