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
stage-3 sweep through ``kernels/mp_update`` (``scan``, ``exact``) or
``kernels/mp_sweep`` (``sweep``), exactly where the JAX package routes them
through its Pallas kernels; configs the kernels cannot fuse raise.  ``False``
runs the plain PyTorch formulation of the JAX package's jnp branch.  The
cross-query merged engine (``apply_gnn_merged``) runs its aggregations
through ``kernels/seg_gather`` whatever ``use_pallas`` says, as in JAX.
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
from repro_torch.kernels.mp_update.ref import mp_update_ref
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
    """Static description of the stage-3 data-flow sweep.

    ``kind``:
      * ``"scan"``   — depths ``1..depth_max``, full row width, dynamic
        depth-select (generic batches without banding);
      * ``"sweep"``  — all of ``levels`` in one fused ``mp_sweep`` launch
        (the plain path runs the same levels one by one);
      * ``"banded"`` — unrolled over ``levels``; each level runs at its
        ``row_span`` with a ``parent_rows`` contraction bound;
      * ``"exact"``  — the placement-specialized sweep: the plain path
        unrolls ``updates`` (per level, the exact ``(row, type,
        parent_rows)`` tuples), the kernel path walks ``levels``.

    ``levels`` entries are ``(d, row_span | None, slot_ranges, parent_rows |
    None)`` with absolute row indices; ``slot_ranges`` must tile the span.
    """

    kind: str
    depth_max: int = 0
    levels: Tuple = ()
    updates: Tuple = ()


def _clip_ranges(ranges, start: int, stop: int):
    """Restrict slot ranges to [start, stop); result tiles the span exactly."""
    out = []
    for t, a, b in ranges:
        a2, b2 = max(a, start), min(b, stop)
        if a2 < b2:
            out.append((t, a2, b2))
    return tuple(out)


def _banded_plan(banding: BatchBanding, ranges=SLOT_RANGES, kind: str = "banded") -> StagePlan:
    return StagePlan(
        kind,
        levels=tuple(
            (d, span, _clip_ranges(ranges, *span), p) for d, span, p in banding.levels
        ),
    )


def _sweep_fusable(params: nn.Params) -> bool:
    """The fused sweep handles exactly 2-layer banks."""
    return len(params["op_upd"]["layers"]) == 2


def _bank_member(p: nn.Params, t: int) -> nn.Params:
    """One type's MLP out of a bank with a leading member axis: w (E, T, F, H)."""
    return {"layers": [{"w": l["w"][:, t], "b": l["b"][:, t]} for l in p["layers"]]}


def _dataflow_sweep(params, h, a_flow, op_depth, op_mask, cfg: GNNConfig, ranges, plan: StagePlan):
    """Stage 3: SOURCES->OPS along the data flow, per the plan.

    ``h`` is ``(E, B, N, H)``; ``a_flow`` is ``(B, N, N)`` or the shared
    ``(N, N)``; ``op_depth`` ``(B, N)`` or ``(N,)``; ``op_mask`` ``(B, N, 1)``
    or None when no row is padded.
    """
    mask_vec = (
        op_mask[..., 0]
        if op_mask is not None
        else torch.ones(op_depth.shape, dtype=torch.float32, device=h.device)
    )
    if plan.kind == "sweep":
        if cfg.use_pallas:
            # the whole banding table in ONE kernel launch (vs one per level)
            _require_fusable(params["op_upd"], "op_upd (stage-3 mp_sweep)")
            return sweep_ops.mp_sweep(params["op_upd"], h, a_flow, op_depth, mask_vec, plan.levels)
        return mp_sweep_ref(
            params["op_upd"], h, a_flow, op_depth, mask_vec, plan.levels, apply_fn=nn.apply_mlp_bank_slotted
        )
    if cfg.use_pallas:
        _require_fusable(params["op_upd"], "op_upd (stage-3 mp_update)")
        if plan.kind == "scan":
            for d in range(1, plan.depth_max + 1):
                h = mp_ops.mp_update(params["op_upd"], h, a_flow, op_depth, mask_vec, d, ranges)
            return h
        for d, span, level_ranges, parent_hi in plan.levels:
            h = mp_ops.mp_update(
                params["op_upd"], h, a_flow, op_depth, mask_vec, d, level_ranges,
                row_span=span, parent_rows=parent_hi,
            )
        return h

    if plan.kind == "scan":
        sel_mask = None if op_mask is None else op_mask[..., 0] > 0
        for d in range(1, plan.depth_max + 1):
            msg = a_flow.transpose(-1, -2) @ h  # msg[v] = sum over parents u
            upd = _apply_bank(params["op_upd"], torch.cat([h, msg], dim=-1), cfg, ranges)
            sel = op_depth == d
            if sel_mask is not None:
                sel = sel & sel_mask
            h = torch.where(sel[..., None], upd, h)
        return h
    if plan.kind == "banded":
        for d, span, level_ranges, parent_hi in plan.levels:
            h = mp_update_ref(
                params["op_upd"], h, a_flow, op_depth, mask_vec, d, level_ranges,
                row_span=span, parent_rows=parent_hi, apply_fn=nn.apply_mlp_bank_slotted,
            )
        return h
    if plan.kind != "exact":
        raise ValueError(f"unknown StagePlan kind {plan.kind!r}")
    for level in plan.updates:
        if not level:
            continue
        cols = [s for s, _, _ in level]
        news = []
        for s, t, parents in level:
            msg = sum(h[..., p, :] for p in parents[1:]) + h[..., parents[0], :]
            x = torch.cat([h[..., s, :], msg], dim=-1)  # (E, B, 2H)
            news.append(nn.apply_mlp(_bank_member(params["op_upd"], t), x))
        idx = nn.index_tensor(cols, h.device)
        h = h.index_copy(h.ndim - 2, idx, torch.stack(news, dim=-2))
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
    h = _dataflow_sweep(params, h, a_flow, op_depth, op_mask, cfg, ranges, plan)

    # readout: rows are pre-masked, sum over the node axes
    pooled = h.sum(dim=-2) + h_hw.sum(dim=-2)
    return nn.apply_mlp(params["out"], pooled)


def _trim_rows(g: JointGraph, rows: Tuple[int, ...]) -> JointGraph:
    """Gather ``rows`` out of the padded operator axis of a batched graph.

    The dropped rows hold no operator in any graph of the batch: their
    states are masked to zero before every reduction, so removing them
    changes no prediction.  Hardware rows stay untouched.
    """
    idx = nn.index_tensor(rows, g.op_x.device)
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
    plan = (
        StagePlan("scan", depth_max=cfg.max_depth)
        if banding is None
        else _banded_plan(banding, ranges, kind="sweep" if _sweep_fusable(params) else "banded")
    )
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
    ``bucketing.batch_banding`` / ``exact_banding``) selects the fused
    ``sweep`` plan: one ``mp_sweep`` call for the whole table (update banks
    that are not 2-layer take the per-level ``banded`` loop); a banding with
    a row trim runs every stage on its trimmed layout.
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
        ``max_parents`` parent states (per-skeleton parent tables, built once
        per forward from ``a_flow``) and the banked update at the span.

    Numerically equal to ``apply_gnn_stacked`` on the expanded broadcast
    batch to float tolerance (same sums, another association).  The
    aggregations run through ``kernels/seg_gather`` whatever ``use_pallas``
    says; the banked MLPs follow ``use_pallas``.  ``banding`` must come from
    ``bucketing.exact_banding_cached`` over ``skels``.  The in-degree bound is
    checked here for CPU skeletons; on a GPU the check would wait for the
    device, so the caller owns the bound there: the estimator derives
    ``max_parents`` from its host stack's in-degrees.  Returns ``(E, B)`` raw
    outputs.
    """
    if skels.a_flow.device.type == "cpu":
        validate_merged_parents(skels.a_flow, max_parents)
    ranges = SLOT_RANGES
    if banding.rows is not None:
        skels = _trim_rows(skels, banding.rows)
        a_place = a_place.index_select(1, nn.index_tensor(banding.rows, a_place.device))
        ranges = banding.ranges
    plan = _banded_plan(banding, ranges)
    n_hw = skels.hw_x.shape[-2]
    E = _n_members(params)

    # static sparsity, derived once per forward: parent tables per skeleton
    # (columns of a_flow hold each row's parents; a stable sort keeps the
    # reference's parent order) and one host per row
    flow_in = skels.a_flow.transpose(-1, -2)  # (S, N, N): [v, u] = u -> v
    pidx = torch.argsort(-flow_in, dim=-1, stable=True)[..., :max_parents]  # (S, N, P)
    pmask = torch.gather(flow_in, -1, pidx)  # (S, N, P) in {0, 1}
    row_pidx = pidx[skel_id]  # (B, N, P) int64
    row_pmask = pmask[skel_id]  # (B, N, P)
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
    for d, (s, e), level_ranges, _ in plan.levels:
        msg = seg_ops.gather_sum(h, row_pidx[:, s:e], row_pmask[:, s:e])
        z = torch.cat([h[..., s:e, :], msg], dim=-1)
        shifted = tuple((t, a - s, b - s) for t, a, b in level_ranges)
        upd = _apply_bank(params["op_upd"], z, cfg, shifted)
        sel = ((depth_b[:, s:e] == d) & (op_mask_b[:, s:e, 0] > 0))[..., None]
        h[..., s:e, :] = torch.where(sel, upd, h[..., s:e, :])

    pooled = h.sum(dim=-2) + h_hw.sum(dim=-2)
    return nn.apply_mlp(params["out"], pooled)[..., 0]


def apply_gnn_placed_members(
    params: nn.Params,
    skel: JointGraph,
    a_place: torch.Tensor,
    static: QueryStatic,
    cfg: GNNConfig,
) -> torch.Tensor:
    """``apply_gnn_placed`` for member-stacked params -> (E, B, n_outputs)."""
    E = _n_members(params)
    op_mask = skel.op_mask[:, None]  # (O, 1)
    hw_mask = skel.hw_mask[:, None]  # (W, 1)

    # stage 0: shared across candidates
    h_ops0 = _apply_bank(params["op_enc"], skel.op_x.expand(E, 1, *skel.op_x.shape), cfg) * op_mask
    h_hw0 = _apply_shared(params["hw_enc"], skel.hw_x.expand(E, 1, *skel.hw_x.shape), cfg, "hw_enc") * hw_mask

    # full padded layout: no contiguous spans available, full-width levels
    plan = StagePlan(
        "exact",
        levels=tuple(
            (d, None, SLOT_RANGES, None) for d, level in enumerate(static.updates, start=1) if level
        ),
        updates=static.updates,
    )
    return _stages123(
        params, h_ops0, h_hw0, a_place, skel.a_flow, skel.op_depth, cfg,
        ranges=SLOT_RANGES, plan=plan, op_mask=op_mask, hw_mask=hw_mask,
    )


def apply_gnn_placed(
    params: nn.Params,
    skel: JointGraph,
    a_place: torch.Tensor,
    static: QueryStatic,
    cfg: GNNConfig,
) -> torch.Tensor:
    """Placement-batch forward: one query, ``(B, O, W)`` candidate placements.

    Numerically the same as ``apply_gnn_batch`` on the broadcast batch, but
    stage 0 runs once on the unbatched skeleton, and stage 3 only touches the
    depth levels the query has (``static.updates``).  One member's params;
    returns ``(B, n_outputs)``.
    """
    return apply_gnn_placed_members(nn.members(params), skel, a_place, static, cfg)[0]


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
    member, with the shared skeleton input read at member stride 0.
    """
    if chunk is None:
        from repro_torch.serve.policy import active_policy  # lazy: core never pulls serve at import

        chunk = active_policy().score_chunk
    order, ranges, updates, levels = _trimmed_layout(static)
    idx = nn.index_tensor(order, skel.op_x.device)
    op_x = skel.op_x.index_select(0, idx)  # (n, F)
    hw_x = skel.hw_x[:n_hw]  # (n_hw, F_hw)
    a_flow = skel.a_flow.index_select(0, idx).index_select(1, idx)  # (n, n)
    op_depth = skel.op_depth.index_select(0, idx)  # (n,)
    a_place = a_place.index_select(1, idx)[:, :, :n_hw]  # (B, n, n_hw)
    B = a_place.shape[0]
    E = _n_members(params)
    plan = StagePlan("exact", levels=levels, updates=updates)

    # stage 0 is placement-invariant: once for all members, outside the panels
    h0_ops = _apply_bank(params["op_enc"], op_x.expand(E, 1, *op_x.shape), cfg, ranges)
    h0_hw = _apply_shared(params["hw_enc"], hw_x.expand(E, 1, *hw_x.shape), cfg, "hw_enc")

    def fwd(ap):
        return _stages123(
            params, h0_ops, h0_hw, ap, a_flow, op_depth, cfg, ranges=ranges, plan=plan
        )[..., 0]

    if chunk and B > chunk and B % chunk == 0:
        return torch.cat([fwd(a_place[i : i + chunk]) for i in range(0, B, chunk)], dim=1)
    return fwd(a_place)


def apply_gnn_traditional(*args, **kwargs):
    raise NotImplementedError(
        "apply_gnn_traditional (the Exp-7b ablation) is not ported yet: "
        "ROADMAP.md queue 1, item 8."
    )
