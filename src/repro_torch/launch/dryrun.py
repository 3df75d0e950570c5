"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell, run the cell's step
(``make_train_step`` / ``make_prefill_step`` / ``make_serve_step``) once on
the production mesh -- 16x16 single-pod and 2x16x16 multi-pod, a
``DeviceMesh`` over a fake process group (``launch/mesh.py``) -- with the
parameters, optimizer state and inputs as DTensors on the ``meta`` device (no
allocation), placed by the port's ``ShardingRules``, and record per GPU:

  * ``memory``    -- the bytes of the arguments' and outputs' local shards,
    and the peak of the live local bytes that the step's ops create;
  * ``roofline``  -- FLOPs, bytes and collective bytes counted by
    ``roofline.Counter`` on each op's local shards, and the three terms with
    the H100's constants, the dominant one the bottleneck.

The JAX package lowers and compiles instead and reads XLA's analyses.  What
differs in form:

  * ``temp_size_in_bytes`` is the peak of the step's own live bytes (outputs
    included while they exist), not XLA's buffer assignment;
    ``generated_code_size_in_bytes`` has no counterpart and is 0.
  * XLA counts a ``while`` body once, so the JAX package re-lowers 1- and
    2-group variants and extrapolates per group.  The port's layer groups are
    a Python loop that runs, and is counted, every time: no delta correction.
  * The xLSTM blocks run a Python time loop, far too slow on DTensors at
    4,096 or 32,768 positions: a train or prefill cell of an xLSTM model is
    counted at ``TIME_LENGTHS`` positions and extrapolated linearly in the
    trip count (``delta_correction = {"axis": "time", ...}``); every cost of
    that model is linear in the sequence length.
  * The steps run under DTensor's ``implicit_replication``: the plain tensors
    that the model makes (RoPE angles, masks, positions) join the DTensors
    replicated.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import nn
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, cell_supported, get_config, get_shape, input_specs
from repro_torch.launch import artifacts
from repro_torch.launch.mesh import data_axes, make_production_mesh, n_chips
from repro_torch.launch.roofline import Counter, model_flops_estimate, terms_from_counter
from repro_torch.models import sharding_ctx
from repro_torch.models.params import NamedSharding, ShardingRules, abstract, count_params, placements, shardings
from repro_torch.models.steps import TrainStepConfig, make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.transformer import ModelConfig, model_cache_defs, model_defs
from repro_torch.training.optim import AdamState

# the two sequence lengths an xLSTM train or prefill cell is counted at
TIME_LENGTHS = (32, 64)


def active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: routed experts count at top_k/E)."""
    total = count_params(model_defs(cfg))
    if cfg.moe is None:
        return total
    # expert weights: 3 matrices per expert per MoE layer
    n_moe_layers = sum(k in ("moe", "mla_moe") for k in cfg.prefix) + cfg.n_groups * sum(
        k in ("moe", "mla_moe") for k in cfg.pattern
    ) + sum(k in ("moe", "mla_moe") for k in cfg.suffix)
    per_expert = 3 * cfg.d_model * cfg.moe.expert_ff
    routed = n_moe_layers * cfg.moe.n_experts * per_expert
    active_routed = n_moe_layers * cfg.moe.top_k * per_expert
    return total - routed + active_routed


def batch_sharding(spec_tree, mesh):
    """Shardings for the abstract input batch: batch dim over (pod, data)."""
    daxes = data_axes(mesh)
    ax = daxes if len(daxes) > 1 else daxes[0]
    size = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in daxes)

    def per_leaf(s):
        parts = [None] * s.ndim
        if s.ndim and s.shape[0] % size == 0:
            parts[0] = ax
        spec = tuple(parts)
        return NamedSharding(mesh, spec, placements(spec, mesh))

    return nn.tree_map(per_leaf, spec_tree)


def distribute(tree, sh_tree):
    """Each meta tensor of ``tree`` as a DTensor with its sharding's placements."""
    from torch.distributed.tensor import distribute_tensor

    return nn.tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements), tree, sh_tree)


def local_bytes(tree) -> int:
    """Bytes of rank 0's shard of every tensor of ``tree`` (a plain tensor whole)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        local = t.to_local() if isinstance(t, DTensor) else t
        return local.numel() * local.element_size()

    return int(sum(one(t) for t in nn.tree_leaves(tree) if isinstance(t, torch.Tensor)))


def train_state(params, tcfg: TrainStepConfig):
    """``make_train_step``'s state over ``params`` (DTensors on ``meta``):
    Adam's moments placed like the parameters, the step counters plain."""
    zeros = lambda p: torch.zeros_like(p, dtype=tcfg.moment_dtype)
    return {
        "params": params,
        "opt": AdamState(step=torch.zeros((), dtype=torch.int32, device="meta"),
                         mu=nn.tree_map(zeros, params), nu=nn.tree_map(zeros, params)),
        "step": torch.zeros((), dtype=torch.int32, device="meta"),
    }


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: ShardingRules, tcfg: TrainStepConfig):
    """(fn, args): the cell's step and its arguments as DTensors on ``mesh``."""
    specs_in = input_specs(cfg, shape)
    pdefs = model_defs(cfg)
    params = distribute(abstract(pdefs), shardings(pdefs, rules, mesh))

    if shape.kind == "train":
        train_step, _ = make_train_step(cfg, tcfg, device="meta")
        return train_step, (train_state(params, tcfg), distribute(specs_in, batch_sharding(specs_in, mesh)))

    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, device="meta")
        return prefill, (params, distribute(specs_in, batch_sharding(specs_in, mesh)))

    # decode: one token written at the cache's last position.  The port's
    # positions are host ints, so the step reads that int, not the scalar
    # argument (which stays in the arguments' bytes, as in the JAX package)
    serve = make_serve_step(cfg, device="meta")
    cdefs = model_cache_defs(cfg, shape.global_batch, shape.seq_len)
    cache = distribute(specs_in["cache"], shardings(cdefs, rules, mesh))
    tokens = distribute(specs_in["tokens"], batch_sharding(specs_in["tokens"], mesh))

    def decode(params, cache, tokens, cache_len):
        return serve(params, cache, tokens, shape.seq_len - 1)

    return decode, (params, cache, tokens, specs_in["cache_len"])


@functools.cache
def _register_missing_strategies() -> None:
    """Sharding strategies that DTensor lacks for ops the LM stack's backward
    runs: ``log_sigmoid_backward`` (the xLSTM gates), pointwise in its three
    tensors (on the meta device its ``buffer`` has the input's shape)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, self, buffer):
        return [([Replicate()], [Replicate(), Replicate(), Replicate()])] + [
            ([Shard(d)], [Shard(d), Shard(d), Shard(d)]) for d in range(self.ndim)]


def count_call(fn, args, mesh, seq_parallel: bool = False):
    """Run ``fn(*args)`` once under ``Counter``, with ``mesh`` installed for
    the activation constraints and DTensor's implicit replication on:
    (counter, argument bytes, output bytes), per GPU.  ``mesh=None`` with
    plain meta tensors counts the one-GPU step, the card's own code path."""
    from torch.distributed.tensor.experimental import implicit_replication

    _register_missing_strategies()
    arg_bytes = local_bytes(args)
    with sharding_ctx.use_mesh(mesh, seq_parallel=seq_parallel), implicit_replication(), Counter() as c:
        out = fn(*args)
    return c, arg_bytes, local_bytes(out)


def count_step(cfg, shape, mesh, rules, tcfg, seq_parallel=False):
    """One step of the cell under ``Counter`` (``count_call``)."""
    fn, args = build_cell(cfg, shape, mesh, rules, tcfg)
    return count_call(fn, args, mesh, seq_parallel)


def time_loop(cfg: ModelConfig) -> bool:
    """Whether the model runs a Python loop over the sequence (the xLSTM blocks)."""
    return bool((set(cfg.prefix) | set(cfg.pattern) | set(cfg.suffix)) & {"mlstm", "slstm"})


def extrapolate_in_time(count_at, seq_len: int):
    """The counts of a step whose time loop runs ``seq_len`` times, from
    ``count_at(n)`` -> (counter, argument bytes, output bytes) at the
    ``TIME_LENGTHS``, extrapolated linearly: (counter, output bytes, the
    ``delta_correction`` record)."""
    runs = [count_at(n) for n in TIME_LENGTHS]
    (c1, _, out_b), (c2, _, _) = runs
    n1, n2 = TIME_LENGTHS
    scale = (seq_len - n1) / (n2 - n1)

    def extrap(a, b):
        return a + (b - a) * scale

    c = Counter()
    c.flops, c.bytes, c.temp_peak = (extrap(getattr(c1, k), getattr(c2, k)) for k in ("flops", "bytes", "temp_peak"))
    c.coll = {k: extrap(c1.coll[k], c2.coll[k]) for k in c1.coll}
    c.coll_links = {k: extrap(c1.coll_links[k], c2.coll_links[k]) for k in c1.coll_links}
    c.kernels = {name: {k: extrap(c1.kernels[name][k], v) for k, v in per.items()} for name, per in c2.kernels.items()}
    meta = {"axis": "time", "lengths": list(TIME_LENGTHS), "seq_len": seq_len,
            "counted": [{"flops": r[0].flops, "bytes": r[0].bytes,
                         "coll": sum(v for k, v in r[0].coll.items() if k != "count"), "temp": r[0].temp_peak}
                        for r in runs]}
    return c, out_b, meta


def _counts(cfg, shape, mesh, rules, tcfg, seq_parallel):
    """(counter, argument bytes, output bytes, delta meta) of the cell,
    extrapolated in time for an xLSTM train or prefill cell."""
    if shape.kind == "decode" or not time_loop(cfg):
        c, args_b, out_b = count_step(cfg, shape, mesh, rules, tcfg, seq_parallel)
        return c, args_b, out_b, {"delta": False, "reason": "every layer group runs in a Python loop and is counted"}
    args_b = local_bytes(build_cell(cfg, shape, mesh, rules, tcfg)[1])  # the full-length arguments
    c, out_b, meta = extrapolate_in_time(
        lambda n: count_step(cfg, dataclasses.replace(shape, seq_len=n), mesh, rules, tcfg, seq_parallel),
        shape.seq_len)
    return c, args_b, out_b, meta


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    rules: Optional[ShardingRules] = None,
    save: bool = True,
    verbose: bool = True,
    tag: str = "",
    tcfg: Optional[TrainStepConfig] = None,
    mutate_cfg=None,  # ModelConfig -> ModelConfig (hillclimb variants)
    seq_parallel: bool = False,  # Megatron-SP activation sharding
) -> Dict[str, Any]:
    shape = get_shape(shape_name)
    ok, why = cell_supported(arch, shape)
    mesh_name = "multi" if multi_pod else "single"
    cell = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "skipped" if not ok else "pending",
    }
    if not ok:
        cell["skip_reason"] = why
        if verbose:
            print(f"[skip] {arch} x {shape_name} ({mesh_name}): {why}")
        return cell

    cfg = get_config(arch)
    if mutate_cfg is not None:
        cfg = mutate_cfg(cfg)
    rules = rules or ShardingRules()
    # big-model dry-runs keep Adam moments in bf16 (no fp32 master; DESIGN SS7)
    tcfg = tcfg or TrainStepConfig(
        moment_dtype=torch.bfloat16 if count_params(model_defs(cfg)) > 5e10 else torch.float32
    )

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        c, args_b, out_b, delta_meta = _counts(cfg, shape, mesh, rules, tcfg, seq_parallel)
        t_count = time.time() - t0
        mem_d = {
            "argument_size_in_bytes": int(args_b),
            "output_size_in_bytes": int(out_b),
            "temp_size_in_bytes": int(c.temp_peak),
            "generated_code_size_in_bytes": 0,  # nothing is compiled
        }
        n_active = active_params(cfg)
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            mf = model_flops_estimate(n_active, tokens, "train")
        elif shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            mf = model_flops_estimate(n_active, tokens, "fwd")
        else:
            tokens = shape.global_batch  # one new token per sequence
            mf = model_flops_estimate(n_active, tokens, "fwd")
        terms = terms_from_counter(c, mf)
        chips = n_chips(mesh)
        cell.update(
            {
                "status": "ok",
                "package": "repro_torch",
                "chips": chips,
                "n_params": count_params(model_defs(cfg)),
                "n_params_active": n_active,
                "count_s": round(t_count, 1),
                "memory": mem_d,
                "roofline": terms.as_dict(chips),
                "collective_links": terms.coll_links,
                "kernels": c.kernels,
                "delta_correction": delta_meta,
            }
        )
        if verbose:
            r = cell["roofline"]
            print(
                f"[ok] {arch} x {shape_name} ({mesh_name}{tag}): "
                f"Tc={r['t_compute_s']:.3e}s Tm={r['t_memory_s']:.3e}s "
                f"Tcoll={r['t_collective_s']:.3e}s -> {r['bottleneck']}; "
                f"temp/gpu={mem_d['temp_size_in_bytes']/1e9:.2f}GB "
                f"args/gpu={mem_d['argument_size_in_bytes']/1e9:.2f}GB "
                f"(count {t_count:.0f}s)",
                flush=True,
            )
    except Exception as e:
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERR] {arch} x {shape_name} ({mesh_name}): {cell['error']}", flush=True)

    if save:
        outdir = artifacts.path("dryrun", mesh_name + tag)
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(cell, f, indent=2, default=str)
    return cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                out = artifacts.path("dryrun", mesh_name, f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(out):
                    with open(out) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped") and prev.get("package") == "repro_torch":
                        print(f"[cached] {arch} x {shape} ({mesh_name})")
                        results.append(prev)
                        continue
                results.append(run_cell(arch, shape, mp))

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n=== dry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors ===")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
