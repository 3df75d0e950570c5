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
stage-3 sweep through ``kernels/mp_update``, exactly where the JAX package
routes them through its Pallas kernels; configs the kernels cannot fuse
raise.  ``False`` runs the plain PyTorch formulation of the JAX package's
jnp branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.mp_update.ref import mp_update_ref


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
        (not ported yet: raises);
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
    if plan.kind == "sweep":
        raise NotImplementedError(
            "StagePlan('sweep') runs the fused mp_sweep kernel, which the port "
            "does not have yet (ROADMAP.md queue 2, item 1, with queue 1, item 3: "
            "the banded forward of estimate_many and training). Pass banding=None."
        )
    mask_vec = (
        op_mask[..., 0]
        if op_mask is not None
        else torch.ones(op_depth.shape, dtype=torch.float32, device=h.device)
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
        idx = torch.tensor(cols, device=h.device)
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
    idx = torch.tensor(rows, device=g.op_x.device)
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

    ``banding=None`` runs the full ``max_depth`` scan.  A banding selects the
    fused ``sweep`` plan, which raises until ``mp_sweep`` is ported (the
    ``banded`` fallback still serves update banks that are not 2-layer).
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


def apply_gnn_merged(*args, **kwargs):
    raise NotImplementedError(
        "apply_gnn_merged (the cross-query merged engine) is not ported yet: "
        "ROADMAP.md queue 1, item 6, with the seg_gather kernels of queue 2."
    )


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
    idx = torch.tensor(order, device=skel.op_x.device)
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
