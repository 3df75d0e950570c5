"""The port's CUDA kernels and serving path on a card (``pytest -m gpu``).

Every test here needs a CUDA device and skips itself without one; the file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch.  Kernels are held against their plain PyTorch versions at the
main path's shapes (15 stacked members, hidden 64) at ``rtol=atol=1e-5``;
the estimator on the card against the same estimator on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import SLOT_RANGES
from repro_torch.core.model import ALL_METRICS, REGRESSION_METRICS, CostModelConfig, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.mp_update.ref import mp_update_ref
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.estimator import CostEstimator

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(gen, E, T, F, H, device):
    """Random member-stacked 2-layer bank with nonzero biases."""

    def r(*shape):
        return (0.2 * torch.randn(shape, generator=gen)).to(device)

    return {"layers": [{"w": r(E, T, F, H), "b": r(E, T, H)}, {"w": r(E, T, H, H), "b": r(E, T, H)}]}


@pytest.mark.gpu
@pytest.mark.parametrize(
    "F,T,N,B,shared",
    [(39, 5, 12, 1, True), (4, 1, 8, 1, True), (128, 5, 12, 1024, False), (128, 1, 8, 4096, False), (128, 5, 7, 3, False)],
)
def test_banked_mlp_kernel_matches_plain(cuda, F, T, N, B, shared):
    E, H = 15, 64
    gen = torch.Generator().manual_seed(F * 7 + N)
    p = _bank(gen, E, T, F, H, cuda)
    x = torch.randn((1 if shared else E, B, N, F), generator=gen).to(cuda).expand(E, B, N, F)
    if T == 1:
        ranges = ((0, 0, N),)
    else:
        ranges = SLOT_RANGES if N == 12 else ((2, 0, 1), (0, 1, 4), (4, 4, 7))
    before = bank_ops.banked_mlp_slotted.launches
    got = bank_ops.banked_mlp_slotted(p, x, ranges)
    torch.cuda.synchronize()
    assert bank_ops.banked_mlp_slotted.launches == before + 1
    torch.testing.assert_close(got, banked_mlp_slotted_ref(p, x, ranges), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("span", [None, (3, 7)])
def test_mp_update_kernel_matches_plain(cuda, shared, span):
    E, B, N, H = 15, 512, 12, 64
    gen = torch.Generator().manual_seed(3)
    p = _bank(gen, E, 5, 2 * H, H, cuda)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    lead = () if shared else (B,)
    a = (torch.rand(lead + (N, N), generator=gen) > 0.7).float()
    if span is not None:
        a[..., span[0]:, span[0] : span[1]] = 0.0
    depth = torch.randint(0, 4, lead + (N,), generator=gen, dtype=torch.int32)
    mask = (torch.rand(lead + (N,), generator=gen) > 0.2).float()
    a, depth, mask = a.to(cuda), depth.to(cuda), mask.to(cuda)
    ranges = SLOT_RANGES if span is None else ((1, 3, 7),)
    kw = {} if span is None else dict(row_span=span, parent_rows=span[0])
    for d in (1, 2, 3):
        got = mp_ops.mp_update(p, h, a, depth, mask, d, ranges, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, mp_update_ref(p, h, a, depth, mask, d, ranges, **kw), **TOL)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_other_dtypes(cuda):
    gen = torch.Generator().manual_seed(0)
    p = _bank(gen, 2, 5, 8, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        bank_ops.banked_mlp_slotted(p, torch.zeros((2, 1, 12, 8), device=cuda, dtype=torch.bfloat16), SLOT_RANGES)


@pytest.mark.gpu
def test_estimator_on_card_matches_cpu(cuda):
    cfg = GNNConfig(hidden=64, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg)), CostModelConfig(metric=m, gnn=cfg))
              for m in ALL_METRICS}
    gpu, cpu = CostEstimator(models), CostEstimator(models, device="cpu")
    workload = WorkloadGenerator(seed=3)
    traces = workload.corpus(64)
    q, c = workload.query(kind="three_way"), workload.cluster(6)
    a = sample_assignment_matrix(q, c, 100, np.random.default_rng(0))
    before = (bank_ops.banked_mlp_slotted.launches, mp_ops.mp_update.launches)
    for got, want in ((gpu.estimate(traces), cpu.estimate(traces)), (gpu.score(q, c, a), cpu.score(q, c, a))):
        for m in REGRESSION_METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
    after = (bank_ops.banked_mlp_slotted.launches, mp_ops.mp_update.launches)
    assert after[0] > before[0] and after[1] > before[1]
