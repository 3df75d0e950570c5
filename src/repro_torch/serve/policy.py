"""``DispatchPolicy``: the serving dispatch tunables this port reads.

The port of the fields of ``repro/serve/policy.py`` that the estimator, the
placed forward, the banding cache and the placement optimizer read, with the
same defaults and validation.  The policy only moves performance knobs:
predictions never depend on it.  Host profiles and ``autotune`` are not
ported yet (ROADMAP.md queue 1, item 7), so ``active_policy()`` is the
built-in defaults; a ``CostEstimator`` takes its own policy as an argument.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DispatchPolicy:
    #: Candidate-panel width of the placed stacked forward
    #: (``gnn.apply_gnn_placed_stacked``).  0 disables chunking.
    score_chunk: int = 256
    #: Default candidate-sample size of ``PlacementOptimizer.optimize``.
    search_k: int = 64
    #: Elites mutated per hill-climb refinement round.
    refine_top: int = 8
    #: Stage-3 banding plans kept by ``core.bucketing``.
    banding_cache_size: int = 512
    #: Device-resident (query, cluster) skeleton entries of a ``CostEstimator``.
    skeleton_cache_size: int = 64
    #: Merged cross-query groups (device skeleton stacks) of ``score_many``.
    merged_group_cache_size: int = 32

    def validate(self) -> "DispatchPolicy":
        """Raise ``ValueError`` on an out-of-range field; return self."""

        def _positive(name: str, allow_zero: bool = False):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f"DispatchPolicy.{name} must be an int, got {v!r}")
            if v < 0 or (v == 0 and not allow_zero):
                raise ValueError(f"DispatchPolicy.{name} must be positive, got {v}")

        _positive("score_chunk", allow_zero=True)
        _positive("search_k")
        _positive("refine_top")
        _positive("banding_cache_size")
        _positive("skeleton_cache_size")
        _positive("merged_group_cache_size")
        return self


_DEFAULT = DispatchPolicy()


def active_policy() -> DispatchPolicy:
    """The policy read by module-level consumers (the built-in defaults)."""
    return _DEFAULT
