"""``correct`` comes out false under the control and under each fault a cell can have, with the run
driven whole on the CPU (the look for a card skipped) and the timed path broken underneath."""

import pytest
import torch

from bench_small import CELLS, run_small

from bench.harness.check import LIMIT, MISSING, Comparison, vote_flip_margin

ESTIMATE_CELLS = ("synthetic.estimate", "synthetic.estimate-many")


def _half_then_mean(raw_of_half, b):
    """The first half of a batch answered, the rest filled with the mean of those answers."""
    half = raw_of_half
    return torch.cat([half, half.mean(dim=1, keepdim=True).expand(half.shape[0], b - half.shape[1])], dim=1)


def _patch(monkeypatch, cell, fault):
    import repro_torch.serve.estimator as est

    if cell in ESTIMATE_CELLS:
        orig = est.forward_ensemble

        def forward(params, g, cfg, banding=None):
            b = int(g.op_x.shape[0])
            if fault == "half":
                half = type(g)(*[x[: max(1, b // 2)] for x in g])
                return _half_then_mean(orig(params, half, cfg, banding), b)
            raw = orig(params, g, cfg, banding).clone()
            raw[:, 0] += 0.5
            return raw

        monkeypatch.setattr(est, "forward_ensemble", forward)
        return
    orig = est.apply_gnn_merged

    def merged(params, skels, skel_id, a_place, cfg, banding, max_parents=2):
        b = int(skel_id.shape[0])
        if fault == "half":
            h = max(1, b // 2)
            return _half_then_mean(orig(params, skels, skel_id[:h], a_place[:h], cfg, banding, max_parents), b)
        raw = orig(params, skels, skel_id, a_place, cfg, banding, max_parents).clone()
        raw[:, 0] += 0.5
        return raw

    monkeypatch.setattr(est, "apply_gnn_merged", merged)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _patch(monkeypatch, cell, fault)
    out = run_small(cell)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in TF32 (on the CPU: operands rounded to TF32) in the program's place fails the
    limits that sound runs of the program hold."""
    out = run_small(cell, control=True)
    assert out["correct"] is True
    control = out["control"]["answer_err"]["value"]
    assert control > LIMIT and control > 10 * out["check"]["answer_err"]["value"], out


def test_the_vote_margin_by_hand():
    raw = torch.tensor([[0.5, -0.2, 0.01], [0.3, -0.4, -0.3], [-0.1, -0.6, 0.02]]).numpy()
    # reference votes: [1, 0, 1]
    assert vote_flip_margin(raw, [1, 0, 1]) == 0.0
    assert vote_flip_margin(raw, [0, 0, 1]) == pytest.approx(0.3)  # one of 0.5, 0.3 must cross 0
    assert vote_flip_margin(raw, [1, 1, 1]) == pytest.approx(0.4)  # -0.2 and -0.4 must both cross
    assert vote_flip_margin(raw, [1, 0, 0]) == pytest.approx(0.01)
    assert vote_flip_margin(raw, [1, 0, 2]) == MISSING


def test_a_missing_answer_is_not_correct():
    import numpy as np

    c = Comparison(["latency_p", "success"], 1)
    raw = np.zeros((2, 4), np.float32)
    assert c.value() == MISSING and not c.correct()  # no call compared
    c.add({"latency_p": np.zeros(4), "success": np.array([0, 0, 0, 0])}, raw)
    assert c.value() == 0.0 and c.correct()
    c.add({"latency_p": np.zeros(3), "success": np.array([0, 0, 0, 0])}, raw)
    assert c.value() == MISSING and not c.correct()
    c = Comparison(["latency_p"], 1)
    c.add({"latency_p": np.array([0.0, np.nan, 0.0, 0.0])}, raw[:1])
    assert c.value() == MISSING
