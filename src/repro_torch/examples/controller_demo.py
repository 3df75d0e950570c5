"""Closed-loop demo: a query fleet survives drift and a node failure.

Builds the benchmark's weak edge cluster, places a small fleet with the
contention-aware greedy planner, then replays a seeded scenario (an x8
event-rate drift on two queries and the failure of the strongest host) with
a ``PlacementController`` watching fleet telemetry (docs/controller.md).
A do-nothing static run of the SAME scenario shows what the controller is
worth.  Uses the noise-free simulator oracle as the scorer, so the demo
needs no trained checkpoint; swap ``scorer=`` for ``estimator=`` to drive
it with a trained ``CostEstimator``.

    PYTHONPATH=src python -m repro_torch.examples.controller_demo [--smoke] [--device cpu]

The port of the JAX package's ``examples/controller_demo.py``: the same
flags, defaults and seeds, plus ``--device``.  The simulator scorer runs on
the host, so the device only has to exist (default: the CUDA card; ``cpu``
where there is none).  ``--smoke`` shrinks fleet/ticks to CI scale.
``main(argv)`` prints what the JAX script prints and returns it as a dict.
"""

import argparse

from repro_torch import nn
from repro_torch.control import FleetRuntime, PlacementController, SimulatorScorer, build_scenario, run_static


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny fleet/ticks for CI")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    nn.resolve_device(args.device, "controller_demo")
    n_queries = 4 if args.smoke else 6
    n_ticks = 12 if args.smoke else 20

    fleet, cluster, events = build_scenario(n_queries, n_ticks)
    print(f"fleet of {n_queries} queries on {cluster.n_nodes()} hosts; scenario:")
    for ev in events:
        if ev.kind == "join":
            tgt = f"node(cpu={ev.node.cpu:.0f})"
        elif ev.query is not None:
            tgt = f"query {ev.query}"
        else:
            tgt = f"host {ev.host}"
        print(f"  tick {ev.tick:2d}: {ev.kind} {tgt}"
              + (f" x{ev.factor}" if ev.kind.endswith("drift") else ""))

    ctl = PlacementController(
        FleetRuntime(fleet, cluster, events, seed=1),
        scorer=SimulatorScorer(),
        seed=0,
    )
    ticks = []
    print(f"\n{'tick':>4} {'fleet cost [ms]':>16}  events")
    for _ in range(n_ticks):
        rec = ctl.step()
        notes = [f"{a.kind}(q{a.query_id})" for a in rec.alarms]
        notes += [
            f"{d.action}(q{d.query_id}"
            + (f": {list(d.old)}->{list(d.new)}, {d.migration_mb:.3f}MB)" if d.action == "migrate" else ")")
            for d in rec.decisions
        ]
        ticks.append({"tick": rec.tick, "fleet_cost_ms": rec.fleet_cost_ms, "events": notes})
        print(f"{rec.tick:>4} {rec.fleet_cost_ms:>16.1f}  {' '.join(notes)}")

    rep = ctl.report()
    static = run_static(FleetRuntime(fleet, cluster, events, seed=1), n_ticks)
    print(f"\ncontroller: final {rep.final_cost_ms:10.1f} ms, "
          f"{rep.n_migrations} migrations ({rep.migrated_mb:.3f} MB), "
          f"replan p95 {rep.replan_p95_ms:.1f} ms over {rep.n_replans} rounds")
    print(f"static    : final {static.final_cost_ms:10.1f} ms, 0 migrations")
    ratio = static.final_cost_ms / max(rep.final_cost_ms, 1e-9)
    print(f"end-of-run fleet cost ratio (static/controller): {ratio:.1f}x")
    if ratio <= 1.0:
        raise SystemExit("controller failed to beat the static baseline")
    return {"queries": n_queries, "ticks": ticks, "final_cost_ms": rep.final_cost_ms,
            "migrations": rep.n_migrations, "migrated_mb": rep.migrated_mb, "replan_p95_ms": rep.replan_p95_ms,
            "replans": rep.n_replans, "static_final_cost_ms": static.final_cost_ms, "ratio": ratio}


if __name__ == "__main__":
    main()
