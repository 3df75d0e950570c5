"""SPerf hillclimbing driver (port of ``repro/launch/hillclimb.py``):
hypothesis -> change -> re-count -> re-analyse.

The JAX package's three cells, variants and tags, counted by the port's dry
run (``launch/dryrun.py``) on H100 constants:

  A qwen3-8b x train_4k            (dense train)
  B deepseek-v2-236b x decode_32k  (MoE + MLA decode; the compressed cache)
  C recurrentgemma-2b x prefill_32k (the RG-LRU gates' collectives)

Each variant re-runs the dry-run cell with a tagged artifact.  The
hypotheses below are the JAX package's, stated for its partitioner; whether
each shows in the port's DTensor counts is read off the counts, not assumed.

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A,B,C]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch.dryrun import run_cell
from repro_torch.models.params import ShardingRules


def fmt(cell):
    if cell["status"] != "ok":
        return cell.get("error", cell["status"])
    r = cell["roofline"]
    return (
        f"Tc={r['t_compute_s']:.3f}s Tm={r['t_memory_s']:.3f}s "
        f"Tcoll={r['t_collective_s']:.3f}s -> {r['bottleneck']} "
        f"(frac={r['roofline_fraction']:.3f}, temp={cell['memory']['temp_size_in_bytes']/1e9:.1f}GB)"
    )


def cell_a():
    """qwen3-8b train_4k.

    H1: Megatron-style sequence parallelism (activations sharded over the
        model axis between blocks) divides the activation stream's traffic
        by 16.
    H2: remat='dots' (keep matmul outputs, recompute elementwise) trades
        +bytes for -flops; with SP the memory headroom allows it.
    """
    out = {}
    out["A1_seq_parallel"] = run_cell(
        "qwen3-8b", "train_4k", False, tag="_sp", seq_parallel=True
    )
    out["A2_sp_dots"] = run_cell(
        "qwen3-8b",
        "train_4k",
        False,
        tag="_sp_dots",
        seq_parallel=True,
        mutate_cfg=lambda c: dataclasses.replace(c, remat="dots"),
    )
    return out


def cell_b():
    """deepseek-v2-236b decode_32k: per-GPU arguments are dominated by the MLA
    compressed cache replicated over the model axis (only batch-sharded).

    H1: shard the cache sequence dim over 'model' (flash-decode style): the
        16x replication disappears; attention reduces over the sharded dim
        with one small collective per layer.
    """
    rules = ShardingRules().replace("act_seq", ("model", None))
    out = {}
    out["B1_kv_seq_shard"] = run_cell(
        "deepseek-v2-236b", "decode_32k", False, rules=rules, tag="_kvshard"
    )
    return out


def cell_c():
    """recurrentgemma-2b prefill_32k.

    H1: the dense (r x r) RG-LRU gate matmuls contract over the model-sharded
        channel dim -> an all-reduce of (B, S, r) fp32 per gate per layer.
        Griffin's block-diagonal gates (one block per head) make the
        contraction shard-local where the blocks align with the channel
        sharding, and those collectives vanish.
    H2: + sequence parallelism for the elementwise/norm traffic.
    """
    out = {}
    out["C1_blockdiag"] = run_cell(
        "recurrentgemma-2b",
        "prefill_32k",
        False,
        tag="_blockdiag",
        mutate_cfg=lambda c: dataclasses.replace(c, rg_blockdiag=True),
    )
    out["C2_blockdiag_sp"] = run_cell(
        "recurrentgemma-2b",
        "prefill_32k",
        False,
        tag="_blockdiag_sp",
        seq_parallel=True,
        mutate_cfg=lambda c: dataclasses.replace(c, rg_blockdiag=True),
    )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="A,B,C")
    args = ap.parse_args()
    results = {}
    if "A" in args.cell:
        results.update(cell_a())
    if "B" in args.cell:
        results.update(cell_b())
    if "C" in args.cell:
        results.update(cell_c())
    print("\n=== hillclimb results ===")
    for name, cell in results.items():
        print(f"{name}: {fmt(cell)}")


if __name__ == "__main__":
    main()
