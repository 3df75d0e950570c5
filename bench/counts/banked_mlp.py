"""Operations and bytes of each ``banked_mlp`` launch of a call.

The kernel runs one two-layer MLP (a bank of per-type MLPs, or one shared MLP) over a block of
rows.  Each launch is counted on the real rows it needs: its input rows read once (stage 0's
inputs are shared by every member and read once), its output rows written once, its weights read
once; padding rows and trimmed layouts cost nothing.  Every entry launches stage 0 (the operator
and host encoders), stage 1 (the host update) and stage 2 (the operator update); a ``score_many``
call also launches one per stage-3 depth level that its structures hold.  float32 throughout.
"""

OP_FEATURES, HW_FEATURES = 39, 4


def mlp(fi: int, h: int, fo: int) -> int:
    """A two-layer MLP's products and bias adds per row (as ``model.py`` counts them)."""
    return 2 * fi * h + h + 2 * h * fo + fo


N_TYPES = 5


def _launch(E, types, rows, fi, H, fo, shared_input=False):
    w = 4 * E * types * (fi * H + H + H * fo + fo)
    x = 4 * rows * fi * (1 if shared_input else E)
    y = 4 * E * rows * fo
    return float(E * rows * mlp(fi, H, fo)), float(w + x + y)


def launches(work):
    """``[(flops, bytes)]``, one per launch, in launch order."""
    E, H, s0, r = work.members, work.hidden, work.stage0, work.rows
    out = [
        _launch(E, N_TYPES, int(s0.n_ops.sum()), OP_FEATURES, H, H, shared_input=True),
        _launch(E, 1, int(s0.n_hw.sum()), HW_FEATURES, H, H, shared_input=True),
        _launch(E, 1, int(r.n_hw.sum()), 2 * H, H, H),
        _launch(E, N_TYPES, int(r.n_ops.sum()), 2 * H, H, H),
    ]
    if work.entry == "score_many":
        for d in range(1, s0.depth_rows.shape[1]):
            if s0.depth_rows[:, d].sum():
                out.append(_launch(E, N_TYPES, int(r.depth_rows[:, d].sum()), 2 * H, H, H))
    return out
