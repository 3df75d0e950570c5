"""How ``correct`` is decided: the program's answers against the plain reference's.

For every compared call, every answer (each metric of each graph or candidate) is held against
what the reference gives for the same item from the same inputs and weights.  One number,
``answer_err``, the largest over all compared answers of how far the reference's member outputs
would have to move to give the program's answer:

* a regression answer (throughput, processing and end-to-end latency: the mean over members of
  ``expm1(raw)``, clipped at 0): its gap from the reference's, over
  ``max(1, mean over members of |expm1(raw)|)`` (an absolute gap below 1, a relative one above);
* a classification answer (backpressure, success: the members' majority of ``logit > 0``): 0 where
  it agrees with the reference's vote, else the least shift of the reference's member logits that
  turns its vote into the program's;
* an answer that did not come back, came back at another length, is not finite or is not a vote:
  ``MISSING``.  So is a run that compared no call.

The limit sits between the readings of sound runs of the program and those of the control (the
reference in TF32 in the program's place), as ``PERF.md`` records them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from bench.reference.gnn import REGRESSION, vote

MISSING = 1e9
# Set from 48 sound runs (12 seeds in each of the 4 cells: at most 3.9e-6) and the control's
# 48 (at least 1.5e-3), on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 2.
LIMIT = 2e-4


class Comparison:
    """The running maximum of ``answer_err`` over the compared calls."""

    def __init__(self, metrics: Sequence[str], members: int):
        self.metrics = tuple(metrics)
        self.members = members
        self.err = 0.0
        self.calls = 0
        self.answers = 0

    def add(self, answers: Dict[str, np.ndarray], ref_raw: np.ndarray) -> None:
        """One call: ``answers`` metric -> (n,) from the program, ``ref_raw`` the reference's
        ``(E_total, n)`` member outputs for the same items, metrics stacked in order."""
        n = ref_raw.shape[1]
        self.calls += 1
        for k, m in enumerate(self.metrics):
            raw = ref_raw[k * self.members : (k + 1) * self.members].astype(np.float64)
            self.answers += n
            got = answers.get(m)
            got = None if got is None else np.asarray(got)
            if got is None or got.shape != (n,) or not np.isfinite(got).all():
                self.err = MISSING
                continue
            if m in REGRESSION:
                scale = np.maximum(1.0, np.abs(np.expm1(raw)).mean(axis=0))
                err = float((np.abs(got.astype(np.float64) - vote(raw, m)) / scale).max(initial=0.0))
            else:
                err = vote_flip_margin(raw, got)
            self.err = max(self.err, err)

    def value(self) -> float:
        return self.err if self.calls else MISSING

    def numbers(self) -> dict:
        return {"answer_err": {"value": self.value(), "limit": LIMIT}, "calls": self.calls, "answers": self.answers}

    def correct(self) -> bool:
        return self.value() <= LIMIT


def vote_flip_margin(raw: np.ndarray, got) -> float:
    """The largest least shift of the members' logits ``raw (E, n)`` that turns the reference's
    majority vote into ``got`` (0 where they agree; ``MISSING`` for a value that is no vote)."""
    E, got = raw.shape[0], np.asarray(got)
    if not np.isin(got, (0, 1)).all():
        return MISSING
    want = vote(raw, "success")
    worst = 0.0
    for j in np.flatnonzero(got.astype(np.int64) != want):
        col = raw[:, j]
        pos = col > 0.0
        if want[j] == 1:  # push positive members down until at most E // 2 stay positive
            k, cand = int(pos.sum()) - E // 2, np.sort(np.abs(col[pos]))
        else:  # lift non-positive members until more than E // 2 are positive
            k, cand = E // 2 + 1 - int(pos.sum()), np.sort(np.abs(col[~pos]))
        worst = max(worst, float(cand[k - 1]) if 0 < k <= cand.size else MISSING)
    return worst
