"""Operations and bytes of the ``mp_sweep`` launch of an ``estimate_many`` call.

One launch runs every stage-3 level of the call's merged batch: it reads the state of every real
operator row once and writes it once, reads each graph's real data-flow block, depth and mask and
the type bank's weights once, and computes the update MLP and the parent sum for every operator at
depth 1 or more.  float32 throughout.
"""



def mlp(fi: int, h: int, fo: int) -> int:
    """A two-layer MLP's products and bias adds per row (as ``model.py`` counts them)."""
    return 2 * fi * h + h + 2 * h * fo + fo


N_TYPES = 5


def launches(work):
    """``[(flops, bytes)]``, one per launch; ``[]`` for other entries."""
    if work.entry != "estimate_many":
        return []
    E, H, r = work.members, work.hidden, work.rows
    f = E * (int(r.depth_rows[:, 1:].sum()) * mlp(2 * H, H, H) + int(r.depth_edges[:, 1:].sum()) * H)
    nbytes = (4 * E * H * 2 * int(r.n_ops.sum()) + 4 * int((r.n_ops ** 2 + 2 * r.n_ops).sum())
              + 4 * E * N_TYPES * (2 * H * H + H + H * H + H))
    return [(float(f), float(nbytes))]
