"""COSTREAM GNN in PyTorch: node-type encoders + the 3-stage message passing.

The port of ``repro/core/gnn.py`` (Algorithm 1 of the paper on the padded
dense ``JointGraph``):

  stage 0  h_v   = MLP_{T(v)}(x_v)                         (type-specific encoders)
  stage 1  OPS->HW   : hosts absorb the states of the operators placed on them
  stage 2  HW->OPS   : operators absorb the (updated) state of their host
  stage 3  SOURCES->OPS: states flow along the logical data flow in topological
                        order (depth-level steps with masked updates)
  readout  sum over all node states -> MLP_out -> prediction

One difference of form from the JAX package: the **member axis is explicit**.
Every engine function takes params whose leaves carry a leading member axis
``E`` (an ensemble, or several metrics' ensembles stacked) and node states of
shape ``(E, B, N, H)``, where the JAX package ran one member's forward under
``jax.vmap``.  Graph fields carry no member axis.  ``apply_gnn_batch`` and
``apply_gnn_placed`` keep the JAX package's single-member signatures.

``GNNConfig.use_pallas`` keeps its name and meaning (bundles carry it): it
routes the banked MLPs of stages 0-2 through ``kernels/banked_mlp`` and the
stage-3 walk over a ``StagePlan``'s levels through ``kernels/mp_update``
(one launch per level: the scan, the placed forward) or ``kernels/mp_sweep``
(a banding's whole table in one launch), exactly where the JAX package routes
them through its Pallas kernels; configs the kernels cannot fuse raise.
``False`` runs the same levels through the kernels' plain versions
(``mp_sweep_ref``), the plain PyTorch formulation of the JAX package's jnp
branch.  The Exp-7b ablation ``apply_gnn_traditional`` runs all its MLPs
through ``kernels/banked_mlp`` under ``use_pallas``.  The cross-query merged
engine (``apply_gnn_merged``) runs its aggregations through
``kernels/seg_gather`` whatever ``use_pallas`` says, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.features import HW_FEATURE_DIM, N_OP_TYPES, OP_FEATURE_DIM
from repro_torch.core.graph import (
    MAX_DEPTH,
    SLOT_RANGES,
    BatchBanding,
    JointGraph,
    QueryStatic,
)
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.seg_gather import ops as seg_ops


@dataclass(frozen=True)
class GNNConfig:
    hidden: int = 64
    enc_layers: int = 2
    update_layers: int = 2
    readout_layers: int = 2
    max_depth: int = MAX_DEPTH
    n_outputs: int = 1
    use_pallas: bool = False  # route the banked MLPs and stage 3 through the CUDA kernels


def init_gnn(gen: torch.Generator, cfg: GNNConfig) -> nn.Params:
    """One member's params, drawn from ``gen`` (glorot normal, zero bias)."""
    h = cfg.hidden

    def sizes(d_in: int, n_layers: int, d_out: int):
        return [d_in] + [h] * (n_layers - 1) + [d_out]

    return {
        "op_enc": nn.init_mlp_bank(gen, N_OP_TYPES, sizes(OP_FEATURE_DIM, cfg.enc_layers, h)),
        "hw_enc": nn.init_mlp(gen, sizes(HW_FEATURE_DIM, cfg.enc_layers, h)),
        "op_upd": nn.init_mlp_bank(gen, N_OP_TYPES, sizes(2 * h, cfg.update_layers, h)),
        "hw_upd": nn.init_mlp(gen, sizes(2 * h, cfg.update_layers, h)),
        "out": nn.init_mlp(gen, sizes(h, cfg.readout_layers, cfg.n_outputs)),
    }


def _n_members(params: nn.Params) -> int:
    return int(params["out"]["layers"][0]["w"].shape[0])


def _require_fusable(params: nn.Params, what: str) -> None:
    """``use_pallas`` must fail loudly, never silently run the plain path.

    The banked-MLP / mp-update kernels fuse exactly two layers; configs with
    a different depth cannot be routed through them.
    """
    n = len(params["layers"])
    if n != 2:
        raise NotImplementedError(
            f"GNNConfig.use_pallas=True but '{what}' has {n} layers; the CUDA "
            "kernels fuse exactly two (enc_layers=update_layers=2). Use a "
            "2-layer config or set use_pallas=False."
        )


def _apply_bank(params, x, cfg: GNNConfig, ranges=SLOT_RANGES):
    """Type-specific MLP over a slot layout; x (E, B, N, F), params (E, T, ...)."""
    if cfg.use_pallas:
        _require_fusable(params, "banked MLP (op_enc/op_upd)")
        return bank_ops.banked_mlp_slotted(params, x, ranges)
    return nn.apply_mlp_bank_slotted(params, x, ranges)


def _apply_shared(params, x, cfg: GNNConfig, what: str):
    """Shared (non-type-specific) MLP, e.g. hw_enc / hw_upd; x (E, B, N, F).

    Under ``use_pallas`` this runs through the banked-MLP kernel as a
    single-type bank whose one slot range spans all rows.
    """
    if cfg.use_pallas:
        _require_fusable(params, what)
        bank = {"layers": [{"w": l["w"][:, None], "b": l["b"][:, None]} for l in params["layers"]]}
        return bank_ops.banked_mlp_slotted(bank, x, ((0, 0, x.shape[-2]),))
    return nn.apply_mlp(params, x)


# ---------------------------------------------------------------------------
# The unified stage engine.
# ---------------------------------------------------------------------------


class StagePlan(NamedTuple):
    """Static description of the stage-3 data-flow walk: its levels, in order.

    Each entry of ``levels`` is ``(d, row_span | None, slot_ranges,
    parent_rows | None)`` with absolute row indices: the depth-``d`` step
    over the rows ``row_span`` (every row when None), whose ``slot_ranges``
    tile the span, aggregating parents among the first ``parent_rows`` rows
    (every row when None).  The full-depth scan is the plan whose levels are
    ``(d, None, ranges, None)`` for d = 1..``max_depth``; a banding's plan
    and the placed forward's plan are the levels they carry.

    ``fused`` sends the whole table to one ``mp_sweep`` launch under
    ``use_pallas``; otherwise each level is one ``mp_update`` launch.  The
    plain route walks the levels one by one either way.
    """

    levels: Tuple
    fused: bool = False


def _clip_ranges(ranges, start: int, stop: int):
    """Restrict slot ranges to [start, stop); result tiles the span exactly."""
    out = []
    for t, a, b in ranges:
        a2, b2 = max(a, start), min(b, stop)
        if a2 < b2:
            out.append((t, a2, b2))
    return tuple(out)


def _banded_plan(banding: BatchBanding, ranges=SLOT_RANGES, fused: bool = False) -> StagePlan:
    return StagePlan(
        tuple((d, span, _clip_ranges(ranges, *span), p) for d, span, p in banding.levels), fused
    )


def _dataflow_sweep(params, h, a_flow, op_depth, op_mask, cfg: GNNConfig, plan: StagePlan):
    """Stage 3: SOURCES->OPS along the data flow, one walk over ``plan.levels``.

    Under ``use_pallas`` a fused plan is one ``mp_sweep`` launch and any
    other plan one ``mp_update`` launch per level; the plain route is
    ``mp_sweep_ref``, the same levels one ``mp_update_ref`` step at a time.
    ``h`` is ``(E, B, N, H)``; ``a_flow`` is ``(B, N, N)`` or the shared
    ``(N, N)``; ``op_depth`` ``(B, N)`` or ``(N,)``; ``op_mask`` ``(B, N, 1)``
    or None when no row is padded.
    """
    mask_vec = (
        op_mask[..., 0]
        if op_mask is not None
        else torch.ones(op_depth.shape, dtype=torch.float32, device=h.device)
    )
    bank = params["op_upd"]
    if not cfg.use_pallas:
        return mp_sweep_ref(bank, h, a_flow, op_depth, mask_vec, plan.levels, apply_fn=nn.apply_mlp_bank_slotted)
    if plan.fused:
        # the whole table in ONE kernel launch (vs one per level)
        _require_fusable(bank, "op_upd (stage-3 mp_sweep)")
        return sweep_ops.mp_sweep(bank, h, a_flow, op_depth, mask_vec, plan.levels)
    _require_fusable(bank, "op_upd (stage-3 mp_update)")
    for d, span, level_ranges, parent_hi in plan.levels:
        h = mp_ops.mp_update(
            bank, h, a_flow, op_depth, mask_vec, d, level_ranges, row_span=span, parent_rows=parent_hi
        )
    return h


def _stages123(
    params: nn.Params,
    h_ops0: torch.Tensor,  # (E, B0, O, H), B0 = B, or 1 for a skeleton shared by the batch
    h_hw0: torch.Tensor,  # (E, B0, W, H)
    a_place: torch.Tensor,  # (B, O, W)
    a_flow: torch.Tensor,  # (B, O, O), or (O, O) shared
    op_depth: torch.Tensor,  # (B, O) or (O,) int32
    cfg: GNNConfig,
    *,
    ranges,  # slot ranges (type, start, stop) in THIS layout
    plan: StagePlan,
    op_mask: Optional[torch.Tensor] = None,  # (B?, O, 1), or None when no row is padded
    hw_mask: Optional[torch.Tensor] = None,  # (B?, W, 1), or None when no row is padded
) -> torch.Tensor:
    """Stages 1-3 + readout, the one core behind every forward -> (E, B, n_outputs).

    Stage-0 states with ``B0 = 1`` (the placed path's shared skeleton) are
    broadcast against the candidate batch only where a stage needs them.
    """
    E, B = h_ops0.shape[0], a_place.shape[0]

    # stage 1: OPS -> HW
    msg_hw = a_place.transpose(-1, -2) @ h_ops0  # (E, B, W, H)
    hw_in = torch.cat([h_hw0.expand(E, B, *h_hw0.shape[2:]), msg_hw], dim=-1)
    h_hw = _apply_shared(params["hw_upd"], hw_in, cfg, "hw_upd")
    if hw_mask is not None:
        h_hw = h_hw * hw_mask

    # stage 2: HW -> OPS
    msg_ops = a_place @ h_hw  # (E, B, O, H)
    ops_in = torch.cat([h_ops0.expand(E, B, *h_ops0.shape[2:]), msg_ops], dim=-1)
    h = _apply_bank(params["op_upd"], ops_in, cfg, ranges)
    if op_mask is not None:
        h = h * op_mask

    # stage 3: data-flow sweep per the plan
    h = _dataflow_sweep(params, h, a_flow, op_depth, op_mask, cfg, plan)

    # readout: rows are pre-masked, sum over the node axes
    pooled = h.sum(dim=-2) + h_hw.sum(dim=-2)
    return nn.apply_mlp(params["out"], pooled)


def _trim_rows(g: JointGraph, rows) -> JointGraph:
    """Gather ``rows`` (a tuple, or an int64 index tensor on the graph's
    device) out of the padded operator axis of a batched graph.

    The dropped rows hold no operator in any graph of the batch: their
    states are masked to zero before every reduction, so removing them
    changes no prediction.  Hardware rows stay untouched.
    """
    idx = rows if isinstance(rows, torch.Tensor) else nn.index_tensor(rows, g.op_x.device)
    return g._replace(
        op_x=g.op_x.index_select(1, idx),
        op_type=g.op_type.index_select(1, idx),
        op_mask=g.op_mask.index_select(1, idx),
        op_depth=g.op_depth.index_select(1, idx),
        a_flow=g.a_flow.index_select(1, idx).index_select(2, idx),
        a_place=g.a_place.index_select(1, idx),
    )


def _batch_forward(params, g: JointGraph, cfg: GNNConfig, banding: Optional[BatchBanding]):
    """Member-stacked forward of a graph batch -> (E, B, n_outputs).

    A single ``(N, .)`` graph gives ``(E, n_outputs)``.
    """
    single = g.op_x.ndim == 2
    if single:
        g = JointGraph(*[x.unsqueeze(0) for x in g])
    ranges = SLOT_RANGES
    if banding is not None and banding.rows is not None:
        g = _trim_rows(g, banding.rows)
        ranges = banding.ranges
    E = _n_members(params)
    op_mask = g.op_mask[..., None]
    hw_mask = g.hw_mask[..., None]
    h_ops0 = _apply_bank(params["op_enc"], g.op_x.expand(E, *g.op_x.shape), cfg, ranges) * op_mask
    h_hw0 = _apply_shared(params["hw_enc"], g.hw_x.expand(E, *g.hw_x.shape), cfg, "hw_enc") * hw_mask
    if banding is None:  # the full-depth scan: every level over every row
        plan = StagePlan(tuple((d, None, ranges, None) for d in range(1, cfg.max_depth + 1)))
    else:
        plan = _banded_plan(banding, ranges, fused=True)
    out = _stages123(
        params, h_ops0, h_hw0, g.a_place, g.a_flow, g.op_depth, cfg,
        ranges=ranges, plan=plan, op_mask=op_mask, hw_mask=hw_mask,
    )
    return out[:, 0] if single else out


def apply_gnn_batch(
    params: nn.Params,
    g: JointGraph,
    cfg: GNNConfig,
    banding: Optional[BatchBanding] = None,
) -> torch.Tensor:
    """One member's forward for a padded graph (batch) -> (..., n_outputs).

    ``banding=None`` runs the full ``max_depth`` scan.  A banding (from
    ``bucketing.batch_banding`` / ``exact_banding``) runs its levels as a
    fused plan: one ``mp_sweep`` launch for the whole table under
    ``use_pallas``; a banding with a row trim runs every stage on its
    trimmed layout.
    """
    return _batch_forward(nn.members(params), g, cfg, banding)[0]


def apply_gnn(
    params: nn.Params,
    g: JointGraph,
    cfg: GNNConfig,
    banding: Optional[BatchBanding] = None,
) -> torch.Tensor:
    """Forward pass for ONE graph -> (n_outputs,); same engine as the batch."""
    return apply_gnn_batch(params, g, cfg, banding)


def apply_gnn_stacked(
    params: nn.Params,
    g: JointGraph,
    cfg: GNNConfig,
    banding: Optional[BatchBanding] = None,
) -> torch.Tensor:
    """ONE forward for member-stacked params over a shared graph batch -> (E, B)."""
    return _batch_forward(params, g, cfg, banding)[..., 0]


def validate_merged_parents(a_flow, max_parents: int) -> None:
    """Raise when any row's data-flow in-degree exceeds ``max_parents``.

    The merged engine's parent tables keep only the top ``max_parents``
    entries of each ``a_flow`` column: a row with more parents would have
    them silently dropped and the stage-3 sums would be WRONG, not slow.
    Host-side: ``apply_gnn_merged`` calls it for CPU skeletons.
    """
    if isinstance(a_flow, torch.Tensor):
        a_flow = a_flow.detach().cpu().numpy()
    indeg = np.asarray(a_flow).sum(axis=-2)
    worst = int(indeg.max(initial=0))
    if worst > max_parents:
        loc = tuple(int(v) for v in np.argwhere(indeg > max_parents)[0])
        raise ValueError(
            f"merged cross-query engine: skeleton stack row {loc} has data-flow "
            f"in-degree {worst} > max_parents={max_parents}; the parent-table "
            "gather would silently drop parents and return wrong sums. Pass "
            "max_parents >= the stack's true maximum in-degree "
            "(a_flow.sum(axis=-2).max(), as serve.estimator derives it)."
        )


class MergedConstants(NamedTuple):
    """What ``apply_gnn_merged`` derives from the skeleton stack and its
    banding alone, whatever the rows: computed once per stack
    (``merged_constants``), read by every forward over it
    (``apply_gnn_merged_rows``)."""

    skels: JointGraph  # (S, N', .) the stack on the banding's trimmed layout
    rows: Optional[torch.Tensor]  # (N',) int64 padded row of each trimmed row, or None (no trim)
    ranges: Tuple  # type runs of the layout
    levels: Tuple  # per stage-3 level: (d, (start, stop), its type runs shifted to start at 0)
    pidx: torch.Tensor  # (S, N', P) int64: each row's parents
    pmask: torch.Tensor  # (S, N', P): 1 where a parent is real


def merged_constants(skels: JointGraph, banding: BatchBanding, max_parents: int = 2) -> MergedConstants:
    """The per-stack constants of ``apply_gnn_merged`` (its docstring has the
    arguments).  Index tensors reach the device here, through page-locked
    staging, so a forward over them (``apply_gnn_merged_rows``) copies
    nothing from the host."""
    if skels.a_flow.device.type == "cpu":
        validate_merged_parents(skels.a_flow, max_parents)
    ranges, rows = SLOT_RANGES, None
    if banding.rows is not None:
        rows = nn.index_tensor(banding.rows, skels.op_x.device)
        skels = _trim_rows(skels, rows)
        ranges = banding.ranges
    levels = tuple(
        (d, (s, e), tuple((t, a - s, b - s) for t, a, b in level_ranges))
        for d, (s, e), level_ranges, _ in _banded_plan(banding, ranges).levels
    )
    # static sparsity: parent tables per skeleton (columns of a_flow hold each
    # row's parents; a stable sort keeps the reference's parent order)
    flow_in = skels.a_flow.transpose(-1, -2)  # (S, N, N): [v, u] = u -> v
    pidx = torch.argsort(-flow_in, dim=-1, stable=True)[..., :max_parents]  # (S, N, P)
    pmask = torch.gather(flow_in, -1, pidx)  # (S, N, P) in {0, 1}
    return MergedConstants(skels, rows, ranges, levels, pidx, pmask)


def apply_gnn_merged_rows(
    params: nn.Params,
    consts: MergedConstants,
    skel_id: torch.Tensor,  # (B,) int: row -> skeleton
    a_place: torch.Tensor,  # (B, N, W) one-hot placement adjacency per row, padded layout
    cfg: GNNConfig,
) -> torch.Tensor:
    """``apply_gnn_merged``'s forward over one set of rows, from its stack's
    ``merged_constants`` -> ``(E, B)`` raw outputs.

    Only device work: no host copy and no host sync, so it can be captured
    into a CUDA graph.  Rows are independent of one another (no reduction
    crosses rows), so a row of skeleton 0 placed nowhere (``a_place`` all
    zeros) is a finite pad that changes no other row's output.
    """
    skels, ranges = consts.skels, consts.ranges
    if consts.rows is not None:
        a_place = a_place.index_select(1, consts.rows)
    n_hw = skels.hw_x.shape[-2]
    E = _n_members(params)

    # per row: its parent tables, its one host, its masks
    row_pidx = consts.pidx[skel_id]  # (B, N, P) int64
    row_pmask = consts.pmask[skel_id]  # (B, N, P)
    host = a_place.argmax(dim=-1)  # (B, N) int64
    placed = a_place.amax(dim=-1)[..., None]  # (B, N, 1): 0 for padded rows
    op_mask_s = skels.op_mask[..., None]  # (S, N, 1)
    hw_mask_b = skels.hw_mask[skel_id][..., None]  # (B, W, 1)
    op_mask_b = op_mask_s[skel_id]  # (B, N, 1)
    depth_b = skels.op_depth[skel_id]  # (B, N)

    # stage 0 on the S skeletons only, gathered out per candidate row
    h_ops_s = _apply_bank(params["op_enc"], skels.op_x.expand(E, *skels.op_x.shape), cfg, ranges) * op_mask_s
    h_hw_s = _apply_shared(params["hw_enc"], skels.hw_x.expand(E, *skels.hw_x.shape), cfg, "hw_enc")
    h_hw_s = h_hw_s * skels.hw_mask[..., None]
    h0 = h_ops_s[:, skel_id]  # (E, B, N, H)
    hw0 = h_hw_s[:, skel_id]  # (E, B, W, H)

    # stage 1: hosts absorb their operators (segment sum per row)
    msg_hw = seg_ops.segment_sum(h0 * placed, host, n_hw)  # (E, B, W, H)
    h_hw = _apply_shared(params["hw_upd"], torch.cat([hw0, msg_hw], dim=-1), cfg, "hw_upd") * hw_mask_b

    # stage 2: operators absorb their single host's state (gather, P = 1)
    msg_ops = seg_ops.gather_sum(h_hw, host[..., None], placed)
    h = _apply_bank(params["op_upd"], torch.cat([h0, msg_ops], dim=-1), cfg, ranges) * op_mask_b

    # stage 3: banded levels; parents gathered, never contracted.  ``h`` is
    # this function's own tensor, so each level writes its span in place.
    for d, (s, e), shifted in consts.levels:
        msg = seg_ops.gather_sum(h, row_pidx[:, s:e], row_pmask[:, s:e])
        z = torch.cat([h[..., s:e, :], msg], dim=-1)
        upd = _apply_bank(params["op_upd"], z, cfg, shifted)
        sel = ((depth_b[:, s:e] == d) & (op_mask_b[:, s:e, 0] > 0))[..., None]
        h[..., s:e, :] = torch.where(sel, upd, h[..., s:e, :])

    pooled = h.sum(dim=-2) + h_hw.sum(dim=-2)
    return nn.apply_mlp(params["out"], pooled)[..., 0]


def apply_gnn_merged(
    params: nn.Params,
    skels: JointGraph,  # (S, N, .) stacked skeletons (``a_place`` ignored)
    skel_id: torch.Tensor,  # (B,) int: row -> skeleton
    a_place: torch.Tensor,  # (B, N, W) one-hot placement adjacency per row
    cfg: GNNConfig,
    banding: BatchBanding,
    max_parents: int = 2,
) -> torch.Tensor:
    """ONE member-stacked forward over candidates of S DISTINCT structures.

    The cross-query serving engine: a merged drain's rows reference their
    structure through ``skel_id`` instead of materializing per-row skeleton
    copies, and the graph's sparsity is static (every operator has at most
    ``max_parents`` data-flow parents and exactly one host), so the
    aggregations become index ops:

      * stage 0 runs on the S skeletons only (every member reads the same
        input, at member stride 0) and is gathered per row;
      * stage 1 (OPS->HW) is a per-row ``segment_sum`` over each host's
        operators;
      * stage 2 (HW->OPS) is a ``gather_sum`` of each operator's one host
        state (P = 1, the placed flag as weight);
      * each stage-3 level is a ``gather_sum`` of the span rows'
        ``max_parents`` parent states (per-skeleton parent tables from
        ``a_flow``) and the banked update at the span.

    Numerically equal to ``apply_gnn_stacked`` on the expanded broadcast
    batch to float tolerance (same sums, another association).  The
    aggregations run through ``kernels/seg_gather`` whatever ``use_pallas``
    says; the banked MLPs follow ``use_pallas``.  ``banding`` must come from
    ``bucketing.exact_banding_cached`` over ``skels``.  The in-degree bound is
    checked here for CPU skeletons; on a GPU the check would wait for the
    device, so the caller owns the bound there: the estimator derives
    ``max_parents`` from its host stack's in-degrees.  Returns ``(E, B)`` raw
    outputs.  It is ``merged_constants`` (what the stack alone decides: the
    row trim, the parent tables, the levels) then ``apply_gnn_merged_rows``;
    a caller that runs many forwards over one stack keeps the constants.
    """
    return apply_gnn_merged_rows(params, merged_constants(skels, banding, max_parents), skel_id, a_place, cfg)


def apply_gnn_placed(
    params: nn.Params,
    skel: JointGraph,
    a_place: torch.Tensor,
    static: QueryStatic,
    cfg: GNNConfig,
) -> torch.Tensor:
    """Placement-batch forward: one query, ``(B, O, W)`` candidate placements.

    One member's params; returns ``(B, n_outputs)``.  It is
    ``apply_gnn_placed_stacked`` over the params as a stack of one member, at
    the skeleton's real host count and with no panels: stage 0 runs once on
    the skeleton, and every stage on the slots that hold an operator.
    Numerically the same as ``apply_gnn_batch`` on the broadcast batch, to
    float tolerance.
    """
    n_hw = int(skel.hw_mask.sum())
    return _placed_stacked(nn.members(params), skel, a_place, static, cfg, n_hw, 0)[0]


def _slot_type(slot: int) -> int:
    for t, start, stop in SLOT_RANGES:
        if start <= slot < stop:
            return t
    raise ValueError(f"slot {slot} outside SLOT_RANGES")


def _type_runs(order, offset: int = 0):
    """Maximal runs of equal node type over ``order`` as (type, start, stop)."""
    runs = []
    for i, s in enumerate(order):
        t = _slot_type(s)
        if runs and runs[-1][0] == t:
            runs[-1][2] = offset + i + 1
        else:
            runs.append([t, offset + i, offset + i + 1])
    return tuple(tuple(r) for r in runs)


def _trimmed_layout(static: QueryStatic):
    """Remap the padded slot layout to active slots only, ordered by (depth, slot).

    Depth-major order makes every stage-3 level one contiguous row span, so
    ``mp_update`` can restrict each depth step to the rows it updates
    (``row_span``); within a level, slot order keeps same-type operators
    adjacent.  Returns (order: slot ids, ranges: type runs over the whole
    order, updates: stage-3 updates remapped to row positions, levels: per
    nonempty depth level (d, (start, stop) row span, type runs inside the
    span, parent-row bound)).
    """
    depth_of = {s: 0 for s in static.active}
    for d, level in enumerate(static.updates, start=1):
        for s, _, _ in level:
            depth_of[s] = d
    order = sorted(static.active, key=lambda s: (depth_of[s], s))
    pos = {s: i for i, s in enumerate(order)}
    updates = tuple(
        tuple((pos[s], t, tuple(pos[p] for p in parents)) for s, t, parents in level)
        for level in static.updates
    )
    levels = []
    for d, level in enumerate(static.updates, start=1):
        if not level:
            continue
        rows = sorted(pos[s] for s, _, _ in level)
        if rows != list(range(rows[0], rows[-1] + 1)):
            raise ValueError(f"depth level {d} is not contiguous in the trimmed layout")
        span = (rows[0], rows[-1] + 1)
        # parents have strictly smaller depth, i.e. strictly earlier rows
        levels.append((d, span, _type_runs(order[span[0] : span[1]], offset=span[0]), span[0]))
    return tuple(order), _type_runs(order), updates, tuple(levels)


def apply_gnn_placed_stacked(
    params: nn.Params,
    skel: JointGraph,
    a_place: torch.Tensor,
    static: QueryStatic,
    cfg: GNNConfig,
    n_hw: int,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """ONE forward for a whole stack of ensembles -> ``(E, B)`` raw outputs.

    Every stage runs on the ``len(static.active)`` slots that hold an
    operator and the ``n_hw`` real hosts (slot trimming), and the candidate
    axis runs in ``chunk``-wide panels when ``B > chunk`` and ``chunk``
    divides ``B`` (``chunk=0`` disables; ``None`` reads the active
    ``DispatchPolicy``'s ``score_chunk``).  Stage 0 runs once for every
    member, with the shared skeleton input read at member stride 0.  Stage
    3 walks the query's depth levels, each at its row span.
    """
    return _placed_stacked(params, skel, a_place, static, cfg, n_hw, chunk)[..., 0]


def _placed_stacked(params, skel, a_place, static, cfg, n_hw, chunk):
    """``apply_gnn_placed_stacked`` with every output -> ``(E, B, n_outputs)``."""
    if chunk is None:
        from repro_torch.serve.policy import active_policy  # lazy: core never pulls serve at import

        chunk = active_policy().score_chunk
    order, ranges, _, levels = _trimmed_layout(static)
    idx = nn.index_tensor(order, skel.op_x.device)
    op_x = skel.op_x.index_select(0, idx)  # (n, F)
    hw_x = skel.hw_x[:n_hw]  # (n_hw, F_hw)
    a_flow = skel.a_flow.index_select(0, idx).index_select(1, idx)  # (n, n)
    op_depth = skel.op_depth.index_select(0, idx)  # (n,)
    a_place = a_place.index_select(1, idx)[:, :, :n_hw]  # (B, n, n_hw)
    B = a_place.shape[0]
    E = _n_members(params)
    plan = StagePlan(levels)

    # stage 0 is placement-invariant: once for all members, outside the panels
    h0_ops = _apply_bank(params["op_enc"], op_x.expand(E, 1, *op_x.shape), cfg, ranges)
    h0_hw = _apply_shared(params["hw_enc"], hw_x.expand(E, 1, *hw_x.shape), cfg, "hw_enc")

    def fwd(ap):
        return _stages123(params, h0_ops, h0_hw, ap, a_flow, op_depth, cfg, ranges=ranges, plan=plan)

    if chunk and B > chunk and B % chunk == 0:
        return torch.cat([fwd(a_place[i : i + chunk]) for i in range(0, B, chunk)], dim=1)
    return fwd(a_place)


# ---------------------------------------------------------------------------
# Exp 7b ablation: "traditional" message passing — every node is updated from
# all of its neighbors each round, regardless of node type and stage ordering.
# ---------------------------------------------------------------------------


def apply_gnn_traditional(
    params: nn.Params, g: JointGraph, cfg: GNNConfig, n_rounds: int = 3
) -> torch.Tensor:
    """Member-stacked traditional-MP forward -> ``(E, B, n_outputs)``.

    The port of ``repro/core/gnn.py:apply_gnn_traditional``: ``n_rounds``
    rounds in which every operator absorbs its data-flow neighbours (both
    directions, ``a_flow + a_flowᵀ``) and its host, and every host its
    operators, each through its update MLP, with the masks applied after
    every MLP; then sum pooling over the real rows and the readout.  The JAX
    package runs it per member and per graph under ``jax.vmap``; here the
    member axis ``E`` of ``params`` and the batch axis of ``g`` ride one call
    per MLP stage, so under ``use_pallas`` a forward is 2 + 2 ``n_rounds``
    ``banked_mlp`` launches whatever E and B are.  A single ``(N, .)`` graph
    gives ``(E, n_outputs)``.
    """
    single = g.op_x.ndim == 2
    if single:
        g = JointGraph(*[x.unsqueeze(0) for x in g])
    E = _n_members(params)
    op_mask = g.op_mask[..., None]  # (B, O, 1)
    hw_mask = g.hw_mask[..., None]  # (B, W, 1)

    h_o = _apply_bank(params["op_enc"], g.op_x.expand(E, *g.op_x.shape), cfg) * op_mask
    h_w = _apply_shared(params["hw_enc"], g.hw_x.expand(E, *g.hw_x.shape), cfg, "hw_enc") * hw_mask

    # symmetric adjacency: data flow (both directions) + placement (both ways)
    a_sym = g.a_flow + g.a_flow.transpose(-1, -2)  # (B, O, O)
    a_place_t = g.a_place.transpose(-1, -2)  # (B, W, O)
    for _ in range(n_rounds):
        msg_o = a_sym @ h_o + g.a_place @ h_w  # (E, B, O, H)
        msg_w = a_place_t @ h_o  # (E, B, W, H)
        h_o, h_w = (
            _apply_bank(params["op_upd"], torch.cat([h_o, msg_o], dim=-1), cfg) * op_mask,
            _apply_shared(params["hw_upd"], torch.cat([h_w, msg_w], dim=-1), cfg, "hw_upd") * hw_mask,
        )
    pooled = torch.sum(h_o * op_mask, dim=-2) + torch.sum(h_w * hw_mask, dim=-2)
    out = nn.apply_mlp(params["out"], pooled)
    return out[:, 0] if single else out
