"""The port's CUDA kernels and serving path on a card (``pytest -m gpu``).

Every test here needs a CUDA device and skips itself without one; the file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch.  Kernels are held against their plain PyTorch versions at the
main path's shapes (15 stacked members, hidden 64; the RG-LRU scan at
RecurrentGemma-2B's prefill and decode shapes) at ``rtol=atol=1e-5``; the
estimator and the reduced LM on the card against the same on the CPU.  Each
kernel's ``autograd.Function`` is held against autograd of the plain version
at the training shape (3 members, a batch of 512, hidden 64), and a cost
model under ``use_pallas=True`` against the plain path, the 3-stage engine
and the Exp-7b traditional forward both.  ``linear_scan``'s Function (whose
backward is the reversed scan on the kernel) is held against the plain
scan's VJP, and the data-parallel step on one NCCL rank against the
training loop's step.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch import nn, obs
from repro_torch.core import gnn
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import SLOT_RANGES, batch_graphs, build_graph, exact_banding, merge_graph_batches
from repro_torch.core.model import ALL_METRICS, REGRESSION_METRICS, CostModelConfig, forward_ensemble, init_cost_model
from repro_torch.training import batching, loop
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.mp_update.ref import mp_update_ref
from repro_torch.kernels.seg_gather import ops as seg_ops
from repro_torch.kernels.rglru import ops as scan_ops
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.kernels.seg_gather.ref import gather_sum_ref, segment_sum_ref
from repro_torch.models import blocks, params, steps, transformer
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.estimator import CostEstimator, _graph_forward

TOL = dict(rtol=1e-5, atol=1e-5)


def _launches(kernel: str) -> int:
    """Kernel launches so far in this process (``repro_torch.obs``'s ``<kernel>.launches``)."""
    return obs.counters().get(f"{kernel}.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(gen, E, T, F, H, device, H2=None, glorot=False):
    """Random member-stacked 2-layer bank (F -> H -> H2) with nonzero biases;
    weights at 0.2 x randn, or (glorot) at the model's own init scale."""
    H2 = H if H2 is None else H2

    def r(*shape, scale=0.2):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    def w(*shape):
        return r(*shape, scale=(2.0 / (shape[-2] + shape[-1])) ** 0.5 if glorot else 0.2)

    return {"layers": [{"w": w(E, T, F, H), "b": r(E, T, H)}, {"w": w(E, T, H, H2), "b": r(E, T, H2)}]}


@pytest.mark.gpu
@pytest.mark.parametrize(
    "F,T,N,B,shared,H1,H2,seed",
    [
        (39, 5, 12, 1, True, 64, 64, 285),  # op_enc: K padded 39 -> 40, a batch of one
        (4, 1, 8, 1, True, 64, 64, 36),  # hw_enc: K padded 4 -> 8
        (128, 5, 12, 1024, False, 64, 64, 908),  # op_upd
        (128, 1, 8, 4096, False, 64, 64, 904),  # hw_upd
        (128, 5, 7, 3, False, 64, 64, 903),  # 21 rows: ranges of 3, 9 and 9 rows
        (39, 5, 12, 37, True, 32, 32, 349),  # width 32, rows no multiple of 16
        (128, 5, 12, 333, False, 128, 128, 1164),  # width 128, 8 n-tiles a warp
        (64, 5, 12, 77, False, 128, 32, 620),  # H1 != H2
        (24, 1, 5, 13, True, 40, 56, 269),  # widths no multiple of 32: padded, unswizzled layouts
        (4, 5, 12, 1, False, 8, 16, 64),  # one n-tile, a batch of one
    ],
)
def test_banked_mlp_kernel_matches_plain(cuda, F, T, N, B, shared, H1, H2, seed):
    """Every row of every range within 1e-5 of the plain version (3xTF32
    tensor-core products), member stride 0 where shared, and two launches
    bitwise equal."""
    E = 15
    gen = torch.Generator().manual_seed(seed)
    p = _bank(gen, E, T, F, H1, cuda, H2)
    x = torch.randn((1 if shared else E, B, N, F), generator=gen).to(cuda).expand(E, B, N, F)
    if T == 1:
        ranges = ((0, 0, N),)
    else:
        ranges = SLOT_RANGES if N == 12 else ((2, 0, 1), (0, 1, 4), (4, 4, 7))
    before = _launches("banked_mlp_slotted")
    got = bank_ops.banked_mlp_slotted(p, x, ranges)
    again = bank_ops.banked_mlp_slotted(p, x, ranges)
    torch.cuda.synchronize()
    assert _launches("banked_mlp_slotted") == before + 2
    torch.testing.assert_close(got, banked_mlp_slotted_ref(p, x, ranges), **TOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_banked_mlp_kernel_refuses_other_widths(cuda):
    """The JAX kernels' envelope, layer widths 1 to 128: ragged widths (the
    wrapper runs the bank zero-padded to multiples of 8) and F = 256 at
    H1 = H2 = 128 (the 16-row tiles) within 1e-5 of the plain version, two
    launches bitwise equal; a layer wider than 128 still raises."""
    gen = torch.Generator().manual_seed(0)
    for F, H1, H2 in ((8, 12, 16), (8, 16, 20), (8, 128, 128), (39, 5, 3), (256, 128, 128), (256, 100, 128)):
        x = torch.randn((2, 33, 12, F), generator=gen).to(cuda)
        p = _bank(gen, 2, 5, F, H1, cuda, H2, glorot=True)
        before = _launches("banked_mlp_slotted")
        got = bank_ops.banked_mlp_slotted(p, x, SLOT_RANGES)
        again = bank_ops.banked_mlp_slotted(p, x, SLOT_RANGES)
        torch.cuda.synchronize()
        assert _launches("banked_mlp_slotted") == before + 2
        assert got.shape == (2, 33, 12, H2) and got.is_contiguous()
        torch.testing.assert_close(got, banked_mlp_slotted_ref(p, x, SLOT_RANGES), **TOL)
        assert torch.equal(got, again)
    x = torch.randn((2, 3, 12, 8), generator=gen).to(cuda)
    for H1, H2 in ((16, 136), (129, 16)):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            bank_ops.banked_mlp_slotted(_bank(gen, 2, 5, 8, H1, cuda, H2), x, SLOT_RANGES)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shared,span,B,H,H1,seed",
    [
        (False, None, 512, 64, 64, 3),
        (True, None, 512, 64, 64, 3),
        (False, (3, 7), 512, 64, 64, 3),
        (True, (3, 7), 512, 64, 64, 3),
        (False, None, 1, 64, 64, 68),  # a batch of one
        (False, None, 37, 32, 32, 72),  # width 32, graphs no multiple of a block's run
        (True, (3, 7), 203, 32, 48, 254),  # H1 != H, shared fields with a span
        (False, (0, 12), 300, 64, 32, 335),
    ],
)
def test_mp_update_kernel_matches_plain(cuda, shared, span, B, H, H1, seed):
    """Random a_flow over random depths, so a selected row is often a parent
    of another selected row: every message must read h before the step.
    Within 1e-5 of the plain version, and two launches bitwise equal."""
    E, N = 15, 12
    gen = torch.Generator().manual_seed(seed)
    p = _bank(gen, E, 5, 2 * H, H1, cuda, H)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    lead = () if shared else (B,)
    a = (torch.rand(lead + (N, N), generator=gen) > 0.7).float()
    if span is not None:
        a[..., span[0]:, span[0] : span[1]] = 0.0
    depth = torch.randint(0, 4, lead + (N,), generator=gen, dtype=torch.int32)
    mask = (torch.rand(lead + (N,), generator=gen) > 0.2).float()
    a, depth, mask = a.to(cuda), depth.to(cuda), mask.to(cuda)
    ranges = ((1, 3, 7),) if span == (3, 7) else SLOT_RANGES
    kw = {} if span is None else dict(row_span=span, parent_rows=span[0] if span[0] > 0 else N)
    for d in (1, 2, 3):
        got = mp_ops.mp_update(p, h, a, depth, mask, d, ranges, **kw)
        again = mp_ops.mp_update(p, h, a, depth, mask, d, ranges, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, mp_update_ref(p, h, a, depth, mask, d, ranges, **kw), **TOL)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shared,span,H,H1",
    [
        (False, None, 12, 20),  # ragged widths: the state and the bank zero-padded to 16 and 24
        (True, (3, 7), 100, 3),  # ragged widths, shared fields with a span
        (False, None, 128, 128),  # H = H1 = 128: the 16-row fp32 z tile
        (False, (0, 12), 3, 128),
    ],
)
def test_mp_update_kernel_widths(cuda, shared, span, H, H1):
    """The JAX kernels' envelope, widths 1 to 128: ragged widths run
    zero-padded to multiples of 8, and at H = H1 = 128 one type's weights
    (197.6 KB) leave room for a 16-row fp32 z tile only.  Weights at the
    model's init scale (glorot), as ``test_mp_sweep_kernel_widths`` holds the
    sweep: at 0.2 x randn and K = 256 the plain fp32 step is itself about
    TOL from an exact evaluation.  Within 1e-5 of the plain version, two
    launches bitwise equal."""
    E, B, N = 15, 70, 12
    gen = torch.Generator().manual_seed(H * 131 + H1)
    p = _bank(gen, E, 5, 2 * H, H1, cuda, H, glorot=True)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    lead = () if shared else (B,)
    a, depth, mask = _random_graphs(gen, B, N, cuda, lead=lead)
    if span is not None:
        a = a.clone()
        a[..., span[0]:, span[0] : span[1]] = 0.0
    ranges = ((1, 3, 7),) if span == (3, 7) else SLOT_RANGES
    kw = {} if span is None else dict(row_span=span, parent_rows=span[0] if span[0] > 0 else N)
    for d in (1, 2, 3):
        got = mp_ops.mp_update(p, h, a, depth, mask, d, ranges, **kw)
        again = mp_ops.mp_update(p, h, a, depth, mask, d, ranges, **kw)
        torch.cuda.synchronize()
        assert got.shape == h.shape and got.is_contiguous()
        torch.testing.assert_close(got, mp_update_ref(p, h, a, depth, mask, d, ranges, **kw), **TOL)
        assert torch.equal(got, again)


@pytest.mark.gpu
def test_mp_update_selected_parent_of_selected_row(cuda):
    """A chain 0 -> 1 -> 2 with rows 1 and 2 both at depth d: row 2's message
    must use row 1's h before the step, not its update."""
    E, B, N, H = 15, 40, 12, 64
    gen = torch.Generator().manual_seed(8)
    p = _bank(gen, E, 5, 2 * H, H, cuda)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    a = torch.zeros((B, N, N))
    a[:, 0, 1] = a[:, 1, 2] = a[:, 0, 2] = 1.0
    depth = torch.zeros((B, N), dtype=torch.int32)
    depth[:, 1:3] = 1
    mask = torch.ones((B, N))
    a, depth, mask = a.to(cuda), depth.to(cuda), mask.to(cuda)
    ranges = ((0, 0, 3), (1, 3, 12))
    got = mp_ops.mp_update(p, h, a, depth, mask, 1, ranges)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mp_update_ref(p, h, a, depth, mask, 1, ranges), **TOL)
    assert not torch.equal(got[:, :, 1], h[:, :, 1]) and torch.equal(got[:, :, 3:], h[:, :, 3:])


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_other_dtypes(cuda):
    gen = torch.Generator().manual_seed(0)
    p = _bank(gen, 2, 5, 8, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        bank_ops.banked_mlp_slotted(p, torch.zeros((2, 1, 12, 8), device=cuda, dtype=torch.bfloat16), SLOT_RANGES)


def _five_metric_models():
    """The five metrics' ensembles (3 members, hidden 64, through the kernels) at a fixed seed."""
    cfg = GNNConfig(hidden=64, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    return {m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg)), CostModelConfig(metric=m, gnn=cfg))
            for m in ALL_METRICS}


@pytest.mark.gpu
def test_estimator_on_card_matches_cpu(cuda):
    models = _five_metric_models()
    gpu, cpu = CostEstimator(models), CostEstimator(models, device="cpu")
    workload = WorkloadGenerator(seed=3)
    traces = workload.corpus(64)
    q, c = workload.query(kind="three_way"), workload.cluster(6)
    a = sample_assignment_matrix(q, c, 100, np.random.default_rng(0))
    before = (_launches("banked_mlp_slotted"), _launches("mp_update"))
    for got, want in ((gpu.estimate(traces), cpu.estimate(traces)), (gpu.score(q, c, a), cpu.score(q, c, a))):
        for m in REGRESSION_METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
    after = (_launches("banked_mlp_slotted"), _launches("mp_update"))
    assert after[0] > before[0] and after[1] > before[1]


def _corpus_sweep_inputs(n, device):
    """The trimmed exact-banding layout of an n-trace corpus batch."""
    traces = WorkloadGenerator(seed=0).corpus(n)
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    band = exact_banding(g)
    rows = np.asarray(band.rows)
    a = torch.from_numpy(np.ascontiguousarray(g.a_flow[:, rows][:, :, rows])).to(device)
    depth = torch.from_numpy(np.ascontiguousarray(g.op_depth[:, rows])).to(device)
    mask = torch.from_numpy(np.ascontiguousarray(g.op_mask[:, rows])).to(device)
    return a, depth, mask, gnn._banded_plan(band, band.ranges).levels


# Random graphs whose edges ignore depth (so a selected row is often a parent
# of another selected row of its level) under levels whose parent bound covers
# their own span.
_RANDOM_LEVELS = (
    (1, (0, 12), SLOT_RANGES, 12),
    (2, (3, 11), ((1, 3, 7), (3, 7, 9), (2, 9, 11)), 11),
    (3, (3, 12), ((1, 3, 7), (3, 7, 9), (2, 9, 11), (4, 11, 12)), 12),
)


def _random_graphs(gen, B, N, device, lead=None):
    lead = (B,) if lead is None else lead
    a = (torch.rand(lead + (N, N), generator=gen) > 0.6).float()
    depth = torch.randint(1, 4, lead + (N,), generator=gen, dtype=torch.int32)
    mask = (torch.rand(lead + (N,), generator=gen) > 0.2).float()
    return a.to(device), depth.to(device), mask.to(device)


def _sweep_matches_plain(p, h, a, depth, mask, levels):
    """One launch within 1e-5 of the plain version; a second one bitwise equal."""
    before = _launches("mp_sweep")
    got = sweep_ops.mp_sweep(p, h, a, depth, mask, levels)
    again = sweep_ops.mp_sweep(p, h, a, depth, mask, levels)
    torch.cuda.synchronize()
    assert _launches("mp_sweep") == before + 2
    torch.testing.assert_close(got, mp_sweep_ref(p, h, a, depth, mask, levels), **TOL)
    assert torch.equal(got, again)
    return got


def _tol_ratio(x, exact):
    """Largest |x - exact| in units of TOL's bound (atol + rtol x |exact|)."""
    return float(((x.double() - exact).abs() / (TOL["atol"] + TOL["rtol"] * exact.abs())).max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["corpus", "random", "corpus_glorot", "random_glorot"])
def test_mp_sweep_kernel_matches_plain(cuda, case):
    """The corpus's exact banding (parent_rows reaching into the span from
    level 3 on), and random graphs; two launches bitwise equal.  With weights
    at the model's init scale (glorot) the kernel is held within TOL of the
    plain version.  At 0.2 x randn the six chained levels are so
    ill-conditioned that the plain fp32 version is itself outside TOL of an
    fp64 evaluation (``test_torch_kernels.py::
    test_sweep_chain_conditioning_by_weight_scale``), so no other fp32 order
    of the sums could be held to TOL of it; there the kernel is held against
    the fp64 evaluation, at most twice as far from it as the plain version
    plus TOL."""
    E, H = 15, 64
    gen = torch.Generator().manual_seed(11)
    glorot = case.endswith("_glorot")
    p = _bank(gen, E, 5, 2 * H, H, cuda, glorot=glorot)
    if case.startswith("corpus"):
        a, depth, mask, levels = _corpus_sweep_inputs(512, cuda)
        assert any(lv[3] > lv[1][0] for lv in levels)
    else:
        a, depth, mask = _random_graphs(gen, 300, 12, cuda)
        levels = _RANDOM_LEVELS
    h = torch.randn((E, a.shape[0], a.shape[1], H), generator=gen).to(cuda)
    if glorot:
        _sweep_matches_plain(p, h, a, depth, mask, levels)
        return
    before = _launches("mp_sweep")
    got = sweep_ops.mp_sweep(p, h, a, depth, mask, levels)
    again = sweep_ops.mp_sweep(p, h, a, depth, mask, levels)
    torch.cuda.synchronize()
    assert _launches("mp_sweep") == before + 2
    assert torch.equal(got, again)
    p64 = {"layers": [{k: v.double() for k, v in layer.items()} for layer in p["layers"]]}
    exact = mp_sweep_ref(p64, h.double(), a.double(), depth, mask.double(), levels)
    kernel, plain = _tol_ratio(got, exact), _tol_ratio(mp_sweep_ref(p, h, a, depth, mask, levels), exact)
    print(f"mp_sweep {case}, 0.2 x randn: from fp64, kernel {kernel:.3f} x TOL, plain fp32 {plain:.3f} x TOL")
    assert kernel <= 2.0 * plain + 1.0, (kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("H,H1", [(8, 16), (24, 40), (64, 32), (96, 128), (128, 48), (128, 96)])
def test_mp_sweep_kernel_widths(cuda, H, H1):
    """Widths that are multiples of 8 up to 128, H1 != H among them, as far
    as one type's weights and a z tile fit in shared memory."""
    gen = torch.Generator().manual_seed(H + H1)
    p = _bank(gen, 4, 5, 2 * H, H1, cuda, H, glorot=True)
    a, depth, mask = _random_graphs(gen, 70, 12, cuda)
    h = torch.randn((4, 70, 12, H), generator=gen).to(cuda)
    _sweep_matches_plain(p, h, a, depth, mask, _RANDOM_LEVELS)


@pytest.mark.gpu
def test_mp_sweep_kernel_refuses_other_widths(cuda):
    """The JAX kernels' envelope, widths 1 to 128: ragged widths (the state
    and the bank zero-padded to multiples of 8) and H = H1 = 128, whose
    weights (197.6 KB) and split z tile (66.6 KB) pass a block's shared
    memory (the 16-row fp32 z tile), within 1e-5 of the plain version; a
    width above 128 still raises."""
    gen = torch.Generator().manual_seed(0)
    a, depth, mask = _random_graphs(gen, 70, 12, cuda)
    for H, H1 in ((12, 16), (16, 20), (128, 128), (100, 7), (3, 128)):
        h = torch.randn((3, 70, 12, H), generator=gen).to(cuda)
        got = _sweep_matches_plain(_bank(gen, 3, 5, 2 * H, H1, cuda, H, glorot=True), h, a, depth, mask,
                                   _RANDOM_LEVELS)
        assert got.shape == h.shape and got.is_contiguous()
    a, depth, mask = _random_graphs(gen, 3, 12, cuda)
    for H, H1 in ((16, 136), (136, 16)):
        h = torch.randn((2, 3, 12, H), generator=gen).to(cuda)
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            sweep_ops.mp_sweep(_bank(gen, 2, 5, 2 * H, H1, cuda, H), h, a, depth, mask, _RANDOM_LEVELS)


@pytest.mark.gpu
def test_mp_sweep_kernel_shared_skeleton_ragged_batch_empty_stages(cuda):
    """One (N, N) skeleton read at batch stride 0, a batch that is no multiple
    of a block's graphs, and a level whose ranges select rows in one block
    only (the rest of its stages empty)."""
    E, B, N, H = 15, 517, 12, 64
    gen = torch.Generator().manual_seed(5)
    p = _bank(gen, E, 5, 2 * H, H, cuda, glorot=True)
    a, depth, mask = _random_graphs(gen, B, N, cuda, lead=())
    mask_b = torch.ones((B, N), device=cuda)
    mask_b[1:, 9:] = 0.0  # level 3's ranges (9, 11) and (11, 12) select rows of graph 0 only
    levels = _RANDOM_LEVELS
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    _sweep_matches_plain(p, h, a, depth, mask, levels)
    got = _sweep_matches_plain(p, h, a, depth.expand(B, N).contiguous(), mask_b, levels)
    assert torch.equal(got[:, 1:, 9:], h[:, 1:, 9:])


@pytest.mark.gpu
def test_mp_sweep_selected_parent_of_selected_row(cuda):
    """A chain 0 -> 1 -> 2 with rows 1 and 2 both selected at one level: row
    2's message must use row 1's state before the level, not its update."""
    E, B, N, H = 15, 40, 12, 64
    gen = torch.Generator().manual_seed(8)
    p = _bank(gen, E, 5, 2 * H, H, cuda, glorot=True)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    a = torch.zeros((B, N, N))
    a[:, 0, 1] = a[:, 1, 2] = a[:, 0, 2] = a[:, 2, 5] = 1.0
    depth = torch.zeros((B, N), dtype=torch.int32)
    depth[:, 1:3] = 1
    depth[:, 5] = 2
    mask = torch.ones((B, N))
    a, depth, mask = a.to(cuda), depth.to(cuda), mask.to(cuda)
    levels = ((1, (0, 12), ((0, 0, 3), (1, 3, 12)), 12), (2, (3, 12), ((1, 3, 12),), 12))
    got = _sweep_matches_plain(p, h, a, depth, mask, levels)
    assert not torch.equal(got[:, :, 1], h[:, :, 1]) and torch.equal(got[:, :, 6:], h[:, :, 6:])


@pytest.mark.gpu
@pytest.mark.parametrize("P,column_slice", [(1, False), (2, True)])
def test_gather_sum_kernel_matches_plain(cuda, P, column_slice):
    E, B, N, H = 15, 1024, 11, 64
    gen = torch.Generator().manual_seed(P)
    h = torch.randn((E, B, N, H), generator=gen).to(cuda)
    idx = torch.randint(0, N, (B, N, P), generator=gen).to(cuda)
    w = (torch.rand((B, N, P), generator=gen) > 0.3).float().to(cuda)
    if column_slice:
        idx, w = idx[:, 3:10], w[:, 3:10]
        assert not idx.is_contiguous()
    got = seg_ops.gather_sum(h, idx, w)
    again = seg_ops.gather_sum(h, idx, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gather_sum_ref(h, idx, w), **TOL)
    assert torch.equal(got, again)  # no atomics: two runs are bitwise equal


@pytest.mark.gpu
def test_segment_sum_kernel_matches_plain(cuda):
    E, B, N, H, S = 15, 1024, 11, 64, 8
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((E, B, N, H), generator=gen).to(cuda)
    seg = torch.randint(0, S, (B, N), generator=gen).to(cuda)
    before = _launches("segment_sum")
    got = seg_ops.segment_sum(x, seg, S)
    again = seg_ops.segment_sum(x, seg, S)
    torch.cuda.synchronize()
    assert _launches("segment_sum") == before + 2
    torch.testing.assert_close(got, segment_sum_ref(x, seg, S), **TOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_cross_query_paths_on_card_match_cpu(cuda):
    """``estimate_many`` (one mp_sweep launch, no mp_update) and
    ``score_many`` (seg_gather launches, no mp_update / mp_sweep) on the
    card against the same estimator on the CPU."""
    models = _five_metric_models()
    gpu, cpu = CostEstimator(models), CostEstimator(models, device="cpu")
    workload = WorkloadGenerator(seed=3)
    traces = workload.corpus(96)
    batches = [traces[:40], traces[40:41], traces[41:]]
    counters = ("mp_update", "mp_sweep", "gather_sum", "segment_sum")
    before = [_launches(k) for k in counters]
    got, want = gpu.estimate_many(batches), cpu.estimate_many(batches)
    moved = [_launches(k) - b for k, b in zip(counters, before)]
    assert moved == [0, 1, 0, 0]
    reqs = []
    for i, kind in enumerate(("linear", "two_way", "three_way", "two_way")):
        q, c = workload.query(kind=kind, name=f"r{i}"), workload.cluster(4 + i)
        reqs.append((q, c, sample_assignment_matrix(q, c, 50, np.random.default_rng(i))))
    before = [_launches(k) for k in counters]
    got_s, want_s = gpu.score_many(reqs), cpu.score_many(reqs)
    moved = [_launches(k) - b for k, b in zip(counters, before)]
    assert moved[0] == moved[1] == 0 and moved[2] > 1 and moved[3] == 1
    for g_, w_ in zip(got + got_s, want + want_s):
        for m in REGRESSION_METRICS:
            np.testing.assert_allclose(g_[m], w_[m], rtol=1e-4, atol=1e-6, err_msg=m)


def _spin_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the current stream busy about ``ms`` milliseconds."""
    start, end, n = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), 10_000_000
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return int(n * ms / start.elapsed_time(end))


def _d2h_counts():
    return tuple(obs.counters().get(f"d2h.{k}", 0) for k in ("ready", "blocked"))


@pytest.mark.gpu
def test_deferred_readback_waits_for_its_own_call_only(cuda):
    """A deferred ``estimate``'s ``result()`` returns in well under a 200-ms spin queued on the
    stream after the call (its readback was queued at dispatch, right behind its own kernels)
    and equals a non-deferred call bit for bit.  A readback that landed before the finalize
    counts ``d2h.ready``; one held behind a spin queued ahead of the call, ``d2h.blocked``."""
    est = CostEstimator(_five_metric_models())
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in WorkloadGenerator(seed=3).corpus(256)])
    want = est.estimate(g)  # builds the kernels and fills the caches
    spin = _spin_cycles(200.0)
    torch.cuda.synchronize()
    pending = est.estimate(g, deferred=True)
    torch.cuda._sleep(spin)
    t = time.perf_counter()
    got = pending.result()
    waited = time.perf_counter() - t
    torch.cuda.synchronize()
    assert waited < 0.05, f"result() waited {waited * 1e3:.1f} ms behind a 200-ms spin queued after the call"
    assert got.keys() == want.keys()
    for m in want:
        assert np.array_equal(got[m], want[m]), m
    before = _d2h_counts()
    pending = est.estimate(g, deferred=True)
    torch.cuda.synchronize()
    pending.result()
    assert _d2h_counts() == (before[0] + 1, before[1])
    before = _d2h_counts()
    torch.cuda._sleep(spin)
    est.estimate(g, deferred=True).result()
    assert _d2h_counts() == (before[0], before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["estimate", "estimate_many", "score_many"])
def test_deferred_answers_survive_later_calls(cuda, entry):
    """Call 1's answers are unchanged after 10 more deferred calls on other inputs, two in flight
    (whose readbacks reuse the caching host allocator's page-locked blocks), and equal a
    non-deferred call on call 1's inputs made after them, bit for bit."""
    est = CostEstimator(_five_metric_models())
    work = WorkloadGenerator(seed=5)
    traces = work.corpus(352)
    pool = [batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces[i : i + 32]])
            for i in range(0, 352, 32)]
    structures = [(work.query(kind=k, name=f"s{i}"), work.cluster(3 + i)) for i, k in
                  enumerate(("linear", "two_way", "three_way", "linear"))]

    def call(i, deferred=True):
        if entry == "estimate":
            return est.estimate(pool[i], deferred=deferred)
        if entry == "estimate_many":
            return est.estimate_many([pool[i], pool[(i + 3) % 11]], deferred=deferred)
        rng = np.random.default_rng(i)
        return est.score_many([(q, c, sample_assignment_matrix(q, c, 40, rng)) for q, c in structures],
                              deferred=deferred)

    def parts(out):
        return [out] if isinstance(out, dict) else list(out)

    first = parts(call(0).result())
    kept = [{m: v.copy() for m, v in p.items()} for p in first]
    queue, later = [], []
    for i in range(1, 11):
        queue.append(call(i))
        if len(queue) == 2:
            later.append(parts(queue.pop(0).result()))
    later.append(parts(queue.pop(0).result()))
    assert any(not np.array_equal(p[m], k[m]) for out in later for p, k in zip(out, kept) for m in k)
    again = parts(call(0, deferred=False))
    for p, k, a in zip(first, kept, again):
        for m in k:
            assert np.array_equal(p[m], k[m]) and np.array_equal(a[m], k[m]), m


@pytest.mark.gpu
def test_estimate_many_staging_survives_queued_calls(cuda):
    """Three ``estimate_many`` calls on different batch sets of one size, queued behind a 100-ms
    spin (so no staging copy has run while the host stages the next call), then finished in
    order: each equals, bitwise, the same call through the parent's path (``merge_graph_batches``, then one
    ``graphs_to_device`` copy a chunk), so no staging buffer was written again before its copy
    ran.  Once warm, no ``h2d.stage`` had to create a page-locked block (``pinned_allocs`` 0)."""
    est = CostEstimator(_five_metric_models())
    metrics = tuple(est.models)
    traces = WorkloadGenerator(seed=28).corpus(8 * 96)
    pool = [batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces[i : i + 96]])
            for i in range(0, len(traces), 96)]
    sets = [pool[0:3], pool[3:6], [pool[6], pool[7], pool[0]]]  # equal sizes: one block size
    stacks = est._stacks_for(metrics)

    def merged_then_copied(s):
        sizes = [len(b.op_x) for b in s]
        chunks = est._graph_chunks(merge_graph_batches(s).graphs, None, True)
        return est._collect(stacks, est._launch(stacks, sum(sizes), None, chunks, _graph_forward), sizes)

    want = [merged_then_copied(s) for s in sets]
    spin = _spin_cycles(100.0)

    def queued():
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        pending = [est.estimate_many(s, deferred=True) for s in sets]
        return [p.result() for p in pending]

    queued()  # fills the caching host allocator
    with profile(activities=[ProfilerActivity.CPU]):
        got = queued()
    stages = [r.attrs for r in obs.records() if r.name == "h2d.stage"]
    assert len(stages) >= 3 and all(a["pinned_allocs"] == 0 for a in stages), stages
    for g_, w_ in zip(got, want):
        assert len(g_) == len(w_)
        for part, ref in zip(g_, w_):
            for m in metrics:
                assert np.array_equal(part[m], ref[m]), m


def _score_requests(seed: int, n: int, kinds=("linear", "two_way", "three_way", "two_way")):
    """Four (query, cluster, assignments) requests of ``n`` candidates each, one fixed structure mix."""
    work = WorkloadGenerator(seed=31)
    pairs = [(work.query(kind=k, name=f"g{i}"), work.cluster(4 + i)) for i, k in enumerate(kinds)]
    rng = np.random.default_rng(seed)
    return [(q, c, sample_assignment_matrix(q, c, n, rng)) for q, c in pairs]


def _graph_counts():
    return tuple(obs.counters().get(f"cache.graph.{k}", 0) for k in ("miss", "hit"))


def _same(got, want):
    return all(np.array_equal(g[m], w[m]) for g, w in zip(got, want) for m in w)


@pytest.mark.gpu
def test_merged_graph_replay_matches_eager_bitwise(cuda):
    """``score_many`` captures its merged forward on the first call of a structure mix and row
    bucket and replays it after: the replay's output equals the eager forward over the same
    static inputs (the padded shape) bit for bit, the answers of the capture call (eager) and of
    the replay equal, a replay counts the captured kernels' launches, and the ``gnn.forward``
    span says ``graph="hit"`` with the pad rows in ``rows3``."""
    est = CostEstimator(_five_metric_models())
    reqs = _score_requests(0, 50)
    kernels = ("banked_mlp_slotted", "gather_sum", "segment_sum")
    before = [_launches(k) for k in kernels]
    first = est.score_many(reqs)
    eager_launches = [_launches(k) - b for k, b in zip(kernels, before)]
    before = [_launches(k) for k in kernels]
    with profile(activities=[ProfilerActivity.CPU]):
        again = est.score_many(reqs)
    assert [_launches(k) - b for k, b in zip(kernels, before)] == eager_launches
    assert eager_launches[2] == 1 and eager_launches[1] > 1
    assert _same(again, first)
    fw = [r.attrs for r in obs.records() if r.name == "gnn.forward"]
    (group,) = est._merged_groups.values()
    (graph,) = group.graphs.values()
    assert graph.rows == 256 and [a["graph"] for a in fw] == ["hit"]
    assert fw[0]["rows3"] == 256 * sum(e - s for _, (s, e), _ in group.banding.levels)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = graph.forward()
        graph.graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.out, want)


@pytest.mark.gpu
def test_graph_cache_misses_once_per_group_and_bucket(cuda):
    """One ``cache.graph.miss`` per (structure mix, row bucket) on first sight, then only hits:
    two buckets of one mix (200 and 400 candidates: 256 and 512 rows) and a second mix."""
    est = CostEstimator(_five_metric_models())
    small, large = _score_requests(1, 50), _score_requests(2, 100)
    other = _score_requests(3, 50, kinds=("three_way", "linear", "linear", "three_way"))
    seen = []
    for reqs in (small, small, large, small, large, other, other, large):
        before = _graph_counts()
        est.score_many(reqs)
        seen.append(tuple(a - b for a, b in zip(_graph_counts(), before)))
    assert seen == [(1, 0), (0, 1), (1, 0), (0, 1), (0, 1), (1, 0), (0, 1), (0, 1)]
    assert sorted(g.rows for grp in est._merged_groups.values() for g in grp.graphs.values()) == [256, 256, 512]


@pytest.mark.gpu
def test_queued_score_many_calls_on_one_graph_read_their_own_answers(cuda):
    """Three deferred ``score_many`` calls on one graph (one mix, one bucket, other candidates),
    queued behind a 100-ms spin so none has run when the next stages its rows, then finished in
    order: each equals, bitwise, the same call made alone afterwards.  Stream order keeps each
    call's inputs behind the earlier replay and its readback ahead of the later one."""
    est = CostEstimator(_five_metric_models())
    calls = [_score_requests(10 + i, 50) for i in range(3)]
    est.score_many(calls[0])  # captures the graph
    spin = _spin_cycles(100.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    before = _graph_counts()
    pending = [est.score_many(reqs, deferred=True) for reqs in calls]
    got = [p.result() for p in pending]
    assert _graph_counts() == (before[0], before[1] + 3)
    want = [est.score_many(reqs) for reqs in calls]
    assert not _same(want[0], want[1]) and not _same(want[1], want[2])
    for g_, w_ in zip(got, want):
        assert _same(g_, w_)


@pytest.mark.gpu
def test_a_swapped_stacked_ensemble_is_never_replayed_by_an_old_graph(cuda):
    """Replacing the estimator's stacked ensemble (every weight x 1.25) changes ``score_many``'s
    answers: the graph is keyed on the stack it read, so the new stack misses and captures its own
    (the old one is dropped), and the answers equal, bitwise, those of a new estimator built over
    the scaled weights."""
    models = _five_metric_models()
    scaled = {m: (nn.tree_map(lambda t: t * 1.25, p), cfg) for m, (p, cfg) in models.items()}
    est, fresh = CostEstimator(models), CostEstimator(scaled)
    reqs = _score_requests(4, 50)
    metrics = tuple(models)
    est.score_many(reqs)
    old = est.score_many(reqs)
    (st,) = est._stacks_for(metrics)
    est._stacks[metrics] = (st._replace(params=nn.tree_map(lambda t: t * 1.25, st.params)),)
    before = _graph_counts()
    new = est.score_many(reqs)
    assert _graph_counts() == (before[0] + 1, before[1])
    again = est.score_many(reqs)
    assert _graph_counts() == (before[0] + 1, before[1] + 1)
    (group,) = est._merged_groups.values()
    (graph,) = group.graphs.values()
    assert graph.stacked is est._stacks[metrics][0]
    assert not _same(new, old)
    want = fresh.score_many(reqs)
    assert _same(new, want) and _same(again, want)


@pytest.mark.gpu
def test_a_failed_capture_runs_eager_and_is_counted(cuda, monkeypatch):
    """A capture that fails (``torch.cuda.graph`` raising a RuntimeError) counts
    ``cache.graph.failed`` once and leaves its mix and bucket eager: every call then runs the
    forward eagerly (``graph="eager"``, each launch counted once) with the answers of an estimator
    whose capture worked.  Running out of device memory in the capture is raised."""
    reqs = _score_requests(5, 50)
    want = CostEstimator(_five_metric_models()).score_many(reqs)

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    est = CostEstimator(_five_metric_models())
    failed = obs.counters().get("cache.graph.failed", 0)
    first = est.score_many(reqs)
    assert obs.counters().get("cache.graph.failed", 0) == failed + 1
    before = _graph_counts(), _launches("segment_sum")
    with profile(activities=[ProfilerActivity.CPU]):
        again = est.score_many(reqs)
    assert (_graph_counts(), _launches("segment_sum")) == (before[0], before[1] + 1)
    assert [r.attrs["graph"] for r in obs.records() if r.name == "gnn.forward"] == ["eager"]
    assert obs.counters().get("cache.graph.failed", 0) == failed + 1
    (group,) = est._merged_groups.values()
    (graph,) = group.graphs.values()
    assert graph.failed and graph.graph is None and graph.launches == {}
    assert _same(first, want) and _same(again, want)

    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch.cuda, "graph", out_of_memory)
    with pytest.raises(torch.OutOfMemoryError):
        CostEstimator(_five_metric_models()).score_many(reqs)
    assert obs.counters().get("cache.graph.failed", 0) == failed + 1


@pytest.mark.gpu
def test_parts_land_in_a_device_buffer(cuda):
    """``parts_to_device(..., into=)`` writes the joined parts into a ``device_buffer`` of their
    layout, whose views then hold them; a buffer of another layout is refused."""
    from repro_torch.serve import graphs

    sid, ap = np.arange(5, dtype=np.int64), np.random.default_rng(0).random((5, 3, 2)).astype(np.float32)
    buf, (sid_d, ap_d) = nn.device_buffer([(np.int64, (8,)), (np.float32, (8, 3, 2))], "cuda")
    _, out = nn.parts_to_device(graphs.padded_parts(sid, ap, 8), "cuda", into=buf)
    assert out[0].data_ptr() == sid_d.data_ptr() and out[1].data_ptr() == ap_d.data_ptr()
    assert np.array_equal(sid_d.cpu().numpy(), np.r_[sid, 0, 0, 0])
    assert np.array_equal(ap_d.cpu().numpy()[:5], ap) and not ap_d.cpu().numpy()[5:].any()
    small, _ = nn.device_buffer([(np.int64, (8,)), (np.float32, (7, 3, 2))], "cuda")
    with pytest.raises(ValueError, match="layout"):
        nn.parts_to_device(graphs.padded_parts(sid, ap, 8), "cuda", into=small)


def _graph_batch(seed: int, n: int):
    """``n`` placed synthetic graphs, one host ``JointGraph``."""
    traces = WorkloadGenerator(seed=seed).corpus(n)
    return batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])


def _first(g, n: int):
    """The first ``n`` graphs of a host batch."""
    return type(g)(*[np.asarray(x)[:n] for x in g])


@pytest.mark.gpu
def test_estimate_graph_replay_matches_eager_bitwise(cuda):
    """``estimate`` of a batch captures its full-depth scan on first sight and replays it after:
    the replay's output equals the eager forward over the same static inputs bit for bit, a
    second call's answers equal the first's (eager, then captured) bitwise, each call counts 8
    ``mp_update`` and 4 ``banked_mlp`` launches (five metrics in one stack, ``max_depth`` 8), and
    the ``gnn.forward`` span says ``graph="hit"`` with the pad graphs in ``rows3``."""
    est = CostEstimator(_five_metric_models())
    g = _graph_batch(40, 300)
    kernels = ("banked_mlp_slotted", "mp_update")
    before = [_launches(k) for k in kernels]
    first = est.estimate(g)
    assert [_launches(k) - b for k, b in zip(kernels, before)] == [4, 8]
    before = [_launches(k) for k in kernels]
    with profile(activities=[ProfilerActivity.CPU]):
        again = est.estimate(g)
    assert [_launches(k) - b for k, b in zip(kernels, before)] == [4, 8]
    assert _same([again], [first])
    fw = [r.attrs for r in obs.records() if r.name == "gnn.forward"]
    (graph,) = est._estimate_graphs.values()
    assert graph.rows == 512 and [a["graph"] for a in fw] == ["hit"]
    assert fw[0]["rows3"] == 8 * 512 * g.op_mask.shape[-1]
    torch.cuda.synchronize()
    with torch.no_grad():
        want = graph.forward()
        graph.graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.out, want)


@pytest.mark.gpu
def test_estimate_graph_cache_misses_once_per_stack_and_bucket(cuda, monkeypatch):
    """One ``cache.graph.miss`` per (stacked ensemble, row bucket) of ``estimate`` on first sight,
    then only hits: 200, 200, 400 and 4,096 graphs (buckets 256, 256, 512, 4,096), then each again;
    a single unbatched graph runs eagerly and opens no graph; the LRU keeps the graphs used last
    and a graph it dropped misses again."""
    from repro_torch.serve import estimator

    est = CostEstimator(_five_metric_models())
    pool = _graph_batch(41, 4096)
    seen = []
    for n in (200, 200, 400, 4096, 400, 200, 4096):
        before = _graph_counts()
        est.estimate(_first(pool, n))
        seen.append(tuple(a - b for a, b in zip(_graph_counts(), before)))
    assert seen == [(1, 0), (0, 1), (1, 0), (1, 0), (0, 1), (0, 1), (0, 1)]
    assert sorted(g.rows for g in est._estimate_graphs.values()) == [256, 512, 4096]
    before = _graph_counts()
    single = est.estimate(type(pool)(*[np.asarray(x)[0] for x in pool]))
    assert _graph_counts() == before and all(np.ndim(v) == 0 for v in single.values())
    monkeypatch.setattr(estimator, "ESTIMATE_GRAPHS", 2)
    est.estimate(_first(pool, 400))  # a hit; the LRU drops bucket 256, the least recently used
    assert sorted(g.rows for g in est._estimate_graphs.values()) == [512, 4096]
    before = _graph_counts()
    est.estimate(_first(pool, 200))
    assert _graph_counts() == (before[0] + 1, before[1])
    assert sorted(g.rows for g in est._estimate_graphs.values()) == [256, 512]


@pytest.mark.gpu
def test_queued_estimate_calls_on_one_graph_read_their_own_answers(cuda):
    """Three deferred ``estimate`` calls on one graph (one bucket, other graphs), queued behind a
    100-ms spin so none has run when the next stages its batch, then finished in order: each
    equals, bitwise, the same call made alone afterwards.  Stream order keeps each call's inputs
    behind the earlier replay and its readback ahead of the later one."""
    est = CostEstimator(_five_metric_models())
    batches = [_graph_batch(50 + i, 300) for i in range(3)]
    est.estimate(batches[0])  # captures the graph
    spin = _spin_cycles(100.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    before = _graph_counts()
    pending = [est.estimate(b, deferred=True) for b in batches]
    got = [p.result() for p in pending]
    assert _graph_counts() == (before[0], before[1] + 3)
    want = [est.estimate(b) for b in batches]
    assert not _same([want[0]], [want[1]]) and not _same([want[1]], [want[2]])
    for g_, w_ in zip(got, want):
        assert _same([g_], [w_])


@pytest.mark.gpu
def test_a_swapped_stacked_ensemble_is_never_replayed_by_an_old_estimate_graph(cuda):
    """Replacing the estimator's stacked ensemble (every weight x 1.25) changes ``estimate``'s
    answers: the new stack misses and captures its own graph (the old one is dropped), and the
    answers equal, bitwise, those of a new estimator built over the scaled weights."""
    models = _five_metric_models()
    scaled = {m: (nn.tree_map(lambda t: t * 1.25, p), cfg) for m, (p, cfg) in models.items()}
    est, fresh = CostEstimator(models), CostEstimator(scaled)
    g = _graph_batch(42, 300)
    metrics = tuple(models)
    est.estimate(g)
    old = est.estimate(g)
    (st,) = est._stacks_for(metrics)
    est._stacks[metrics] = (st._replace(params=nn.tree_map(lambda t: t * 1.25, st.params)),)
    before = _graph_counts()
    new = est.estimate(g)
    assert _graph_counts() == (before[0] + 1, before[1])
    again = est.estimate(g)
    assert _graph_counts() == (before[0] + 1, before[1] + 1)
    (graph,) = est._estimate_graphs.values()
    assert graph.stacked is est._stacks[metrics][0]
    assert not _same([new], [old])
    want = fresh.estimate(g)
    assert _same([new], [want]) and _same([again], [want])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,T,D,h0_slice,near_one",
    [
        pytest.param(4, 2048, 2560, False, False, id="4-2048-2560-False"),  # prefill
        pytest.param(4, 1, 2560, True, False, id="4-1-2560-True"),  # decode
        pytest.param(3, 37, 100, True, False, id="3-37-100-True"),  # ragged
        (2, 8192, 256, False, False),  # 32 rounds of chunks
        (2, 1000, 300, True, False),  # T no multiple of a round
        (4, 2048, 2560, True, True),  # RG-LRU-like a near 1
    ],
)
def test_linear_scan_kernel_matches_plain(cuda, B, T, D, h0_slice, near_one):
    """RecurrentGemma-2B's prefill and decode shapes, ragged ones, long ones;
    h0 as a slice of a stacked (groups, B, D) cache, read through its
    strides.  The kernel folds chunk maps into carries, so it agrees with the
    plain loop within 1e-5, not bitwise (bitwise up to 16 steps, one chunk);
    near 1, a and x are as ``apply_rglru`` makes them (half the channels
    within 1e-5 to 1e-1 of 1, x scaled by sqrt(1 - a^2)).  Two launches are
    bitwise equal."""
    gen = torch.Generator().manual_seed(T)
    a = torch.rand((B, T, D), generator=gen)
    b = torch.randn((B, T, D), generator=gen)
    if near_one:
        a[..., : D // 2] = 1.0 - 10.0 ** (-1.0 - 4.0 * torch.rand((B, T, D // 2), generator=gen))
        b = torch.sqrt(1.0 - a.double() ** 2).float() * b
    a, b = a.to(cuda), b.to(cuda)
    stacked = torch.randn((3, B, D + 5), generator=gen).to(cuda)
    h0 = stacked[1, :, 2 : D + 2] if h0_slice else stacked[1, :, :D].contiguous()
    assert h0.is_contiguous() != h0_slice
    before = _launches("linear_scan")
    got = scan_ops.linear_scan(a, b, h0)
    again = scan_ops.linear_scan(a, b, h0)
    torch.cuda.synchronize()
    assert _launches("linear_scan") == before + 2
    want = linear_scan_ref(a, b, h0)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    if T <= 16:  # one chunk: the plain loop's order exactly
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_linear_scan_wrapper_raises_on_other_dtypes(cuda):
    x = torch.zeros((2, 3, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        scan_ops.linear_scan(x, x, torch.zeros((2, 8), device=cuda, dtype=torch.bfloat16))
    assert scan_ops.linear_scan(x.float()[:, :0], x.float()[:, :0], torch.zeros((2, 8), device=cuda)).shape == (2, 0, 8)


@pytest.mark.gpu
def test_reduced_lm_on_card_matches_cpu(cuda):
    """The reduced recurrentgemma-2b in fp32 from the same weights: prefill
    into the cache and decode steps past the window, logits and caches; one
    linear_scan launch per RG-LRU layer per step."""
    cfg = reduced(get_config("recurrentgemma-2b"))
    cpu_p = params.materialize(torch.Generator().manual_seed(0), transformer.model_defs(cfg), torch.float32, "cpu")
    gpu_p = nn.to_device(cpu_p, cuda)
    caches = [params.materialize(None, transformer.model_cache_defs(cfg, 2, 24), torch.float32, d) for d in ("cpu", cuda)]
    step_cpu, step_gpu = steps.make_serve_step(cfg, device="cpu"), steps.make_serve_step(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    pos, n_rec = 0, sum(k == "rec" for k in cfg.pattern) * cfg.n_groups + sum(k == "rec" for k in cfg.suffix)
    for _ in range(7):
        before = _launches("linear_scan")
        want, caches[0], nxt = step_cpu(cpu_p, caches[0], toks, pos)
        got, caches[1], _ = step_gpu(gpu_p, caches[1], toks, pos)
        torch.cuda.synchronize()
        assert _launches("linear_scan") == before + n_rec == before + 6
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        nn.tree_map(lambda g, c: torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4), caches[1], caches[0])
        pos += toks.shape[1]
        toks = nxt.numpy()
    plain = steps.make_serve_step(dataclasses.replace(cfg, use_rglru_kernel=False))
    before = _launches("linear_scan")
    plain(gpu_p, caches[1], toks, pos)
    assert _launches("linear_scan") == before


# -- gradients: each kernel's autograd.Function at the training shape --------------


def _grad_case(name, device):
    """``(kernel fn, plain fn, inputs that require grad)`` at the training
    shape: 3 members, the 512 graphs of a corpus batch, hidden 64."""
    gen = torch.Generator().manual_seed(31)
    E, B, H = 3, 512, 64
    traces = WorkloadGenerator(seed=5).corpus(B)
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    a_flow, depth, mask = (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (g.a_flow, g.op_depth, g.op_mask))
    bank = _bank(gen, E, 5, 2 * H, H, device, glorot=True)
    weights = [t.requires_grad_() for layer in bank["layers"] for t in (layer["w"], layer["b"])]

    def layers(w1, b1, w2, b2):
        return {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device).requires_grad_()

    if name == "banked_mlp":
        return (lambda x, *w: bank_ops.banked_mlp_slotted(layers(*w), x, SLOT_RANGES),
                lambda x, *w: banked_mlp_slotted_ref(layers(*w), x, SLOT_RANGES), [randn(E, B, 12, 2 * H), *weights])
    if name in ("mp_update", "mp_update_shared"):
        a, d, m = (a_flow, depth, mask) if name == "mp_update" else (a_flow[7], depth[7], mask[7])
        return (lambda h, a, *w: mp_ops.mp_update(layers(*w), h, a, d, m, 2, SLOT_RANGES),
                lambda h, a, *w: mp_update_ref(layers(*w), h, a, d, m, 2, SLOT_RANGES),
                [randn(E, B, 12, H), a.clone().requires_grad_(), *weights])
    if name == "mp_sweep":
        a, d, m, levels = _corpus_sweep_inputs(B, device)
        return (lambda h, a, *w: sweep_ops.mp_sweep(layers(*w), h, a, d, m, levels),
                lambda h, a, *w: mp_sweep_ref(layers(*w), h, a, d, m, levels),
                [randn(E, B, a.shape[-1], H), a.clone().requires_grad_(), *weights])
    if name == "gather_sum":  # the merged engine's parent table: the two parents of each row
        flow_in = a_flow.transpose(-1, -2)
        idx = torch.argsort(-flow_in, dim=-1, stable=True)[..., :2]
        w = torch.gather(flow_in, -1, idx).clone().requires_grad_()
        return (lambda h, w: seg_ops.gather_sum(h, idx, w), lambda h, w: gather_sum_ref(h, idx, w), [randn(E, B, 12, H), w])
    host = torch.from_numpy(g.a_place).to(device).argmax(dim=-1)  # each operator's host
    return (lambda x: seg_ops.segment_sum(x, host, 8), lambda x: segment_sum_ref(x, host, 8), [randn(E, B, 12, H)])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["banked_mlp", "mp_update", "mp_update_shared", "mp_sweep", "gather_sum", "segment_sum"])
def test_kernel_autograd_matches_plain_autograd(cuda, name):
    """The kernel's ``autograd.Function`` gradients against autograd of the
    plain version at the same inputs and cotangent: bitwise equal (the
    backward IS the plain version's VJP), except ``gather_sum``'s, whose
    plain backward adds with atomics, within 1e-5."""
    kernel, plain, inputs = _grad_case(name, cuda)
    got_out = kernel(*inputs)
    assert got_out.grad_fn is not None
    cot = torch.randn(got_out.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    got = torch.autograd.grad(got_out, inputs, cot)
    want_out = plain(*inputs)
    want = torch.autograd.grad(want_out, inputs, cot)
    torch.testing.assert_close(got_out, want_out, **TOL)
    for a, b in zip(got, want):
        assert a.shape == b.shape and float(a.abs().max()) > 0
        if name == "gather_sum":
            torch.testing.assert_close(a, b, **TOL)
        else:
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_launch_outside_its_function_raises(cuda):
    """A launch whose result autograd cannot see, on an input that requires
    grad, raises instead of dropping the gradient."""
    kernel, plain, (x, w1, b1, w2, b2) = _grad_case("banked_mlp", cuda)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        bank_ops._launch(x, w1, b1, w2, b2, SLOT_RANGES)
    a = torch.rand((2, 9, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        scan_ops._launch(a, a, torch.zeros((2, 32), device=cuda))
    assert scan_ops.linear_scan(a, a, torch.zeros((2, 32), device=cuda)).grad_fn is not None
    with torch.no_grad():
        assert scan_ops.linear_scan(a, a, torch.zeros((2, 32), device=cuda)).shape == a.shape


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["latency_p", "success"])
def test_cost_model_gradient_through_kernels_matches_plain(cuda, metric):
    """The regression test of the gradient repair: under ``use_pallas=True``
    every parameter leaf of a cost model gets a non-zero gradient, each
    within rtol 1e-4 plus 1e-5 x its largest entry of the plain path's, on
    one exact-banded batch of 512 graphs (4 ``banked_mlp`` and 1 ``mp_sweep``
    launches)."""
    traces = WorkloadGenerator(seed=8).corpus(700)
    ds = batching.dataset_from_traces(traces, metric)
    ds, buckets = batching.bucket_dataset(ds, exact=True)
    g, y, band = next(iter(batching.bucketed_batches(ds, buckets, 512, rng=np.random.default_rng(0), device=cuda)))
    assert len(band.levels) >= 1
    cfg = CostModelConfig(metric=metric, gnn=GNNConfig(use_pallas=True))
    plain = CostModelConfig(metric=metric, gnn=GNNConfig(use_pallas=False))
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), cfg), cuda)
    before = (_launches("banked_mlp_slotted"), _launches("mp_sweep"))
    loss, grads = loop.loss_and_grads(params, g, y, cfg, band)
    assert (_launches("banked_mlp_slotted") - before[0], _launches("mp_sweep") - before[1]) == (4, 1)
    want_loss, want = loop.loss_and_grads(params, g, y, plain, band)
    torch.testing.assert_close(loss, want_loss, **TOL)
    for (path, a), (_, b) in zip(nn.tree_leaves_with_paths(grads), nn.tree_leaves_with_paths(want)):
        assert float(a.abs().max()) > 0, path
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()), msg=str(path))


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [12, 100, 128])
def test_cost_model_widths_through_kernels_match_plain(cuda, hidden):
    """A cost model at a hidden width that is no multiple of 8, or at the
    envelope's 128, under ``use_pallas=True``: the forward of 3 members over
    one exact-banded batch of 512 graphs (4 ``banked_mlp`` and 1 ``mp_sweep``
    launches) within 1e-5 of the plain path, and every gradient leaf within
    the bound of ``test_cost_model_gradient_through_kernels_matches_plain``."""
    traces = WorkloadGenerator(seed=8).corpus(700)
    ds, buckets = batching.bucket_dataset(batching.dataset_from_traces(traces, "latency_p"), exact=True)
    g, y, band = next(iter(batching.bucketed_batches(ds, buckets, 512, rng=np.random.default_rng(0), device=cuda)))
    cfg = CostModelConfig(metric="latency_p", gnn=GNNConfig(hidden=hidden, use_pallas=True))
    plain = CostModelConfig(metric="latency_p", gnn=GNNConfig(hidden=hidden, use_pallas=False))
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(hidden), cfg), cuda)
    before = (_launches("banked_mlp_slotted"), _launches("mp_sweep"))
    with torch.no_grad():
        got = forward_ensemble(params, g, cfg, band)
    assert (_launches("banked_mlp_slotted") - before[0], _launches("mp_sweep") - before[1]) == (4, 1)
    with torch.no_grad():
        torch.testing.assert_close(got, forward_ensemble(params, g, plain, band), **TOL)
    loss, grads = loop.loss_and_grads(params, g, y, cfg, band)
    want_loss, want = loop.loss_and_grads(params, g, y, plain, band)
    torch.testing.assert_close(loss, want_loss, **TOL)
    for (path, a), (_, b) in zip(nn.tree_leaves_with_paths(grads), nn.tree_leaves_with_paths(want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()), msg=str(path))


@pytest.mark.gpu
def test_extrap_run_on_card_matches_the_cpu(cuda):
    """The extrap run that ended at 1.98x its init loss on the card (ROADMAP
    queue 3): stronger-bandwidth ``success`` on the corpus of seed
    ``CORPUS_SEED + 424`` at ``chip_smoke.py``'s cut (400 traces, one epoch,
    batch 512, exact banding), trained through the kernels, against the same
    run on the CPU plain path from the same init and batch order.  Both end
    at about 1.98x their init loss (the premise, not the card, fails:
    ``test_torch_stages.py::test_one_extrap_epoch_does_not_lower_every_run``);
    their validation losses agree within 1e-3 relative (TRAJ_REL)."""
    from repro_torch.core.graph import batch_banding
    from repro_torch.core.model import ensemble_loss
    from repro_torch.launch import train as launch_train

    traces = WorkloadGenerator(launch_train.extrap_generator("stronger", "bandwidth"),
                               seed=launch_train.CORPUS_SEED + 424).corpus(400)
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(traces, "success"), seed=launch_train.SPLIT_SEED)
    cfg = CostModelConfig(metric="success", gnn=GNNConfig(use_pallas=True), n_ensemble=1)
    tcfg = loop.TrainConfig(epochs=1, batch_size=512, lr=1.5e-3, seed=0, exact_banding=True)
    before = (_launches("banked_mlp_slotted"), _launches("mp_sweep"))
    card = loop.train_cost_model(tr, va, cfg, tcfg, device=cuda)
    assert _launches("banked_mlp_slotted") - before[0] == 4 * (card.steps + 1)
    assert _launches("mp_sweep") - before[1] == card.steps + 1
    cpu = loop.train_cost_model(tr, va, cfg, tcfg, device="cpu")
    assert card.steps == cpu.steps == 31
    assert abs(card.best_val - cpu.best_val) <= 1e-3 * abs(cpu.best_val), (card.best_val, cpu.best_val)
    p0 = init_cost_model(torch.Generator().manual_seed(0), cfg)
    g, y = batching.batch_to_device(va.graphs, va.labels, "cpu")
    with torch.no_grad():
        at_init = float(ensemble_loss(p0, g, y, cfg, batch_banding(va.graphs)))
    print(f"extrap offset 424: init {at_init}, card {card.best_val} ({card.best_val / at_init}x), "
          f"cpu {cpu.best_val} ({cpu.best_val / at_init}x)")
    assert card.best_val > 1.5 * at_init and cpu.best_val > 1.5 * at_init


def _traditional_batch(metric, device, n=700, seed=8):
    """One exact-banded batch of 512 corpus graphs for ``metric``."""
    traces = WorkloadGenerator(seed=seed).corpus(n)
    ds, buckets = batching.bucket_dataset(batching.dataset_from_traces(traces, metric), exact=True)
    return next(iter(batching.bucketed_batches(ds, buckets, 512, rng=np.random.default_rng(0), device=device)))


@pytest.mark.gpu
def test_traditional_forward_through_kernels_matches_plain(cuda):
    """The Exp-7b forward of 3 members over 512 corpus graphs: 8
    ``banked_mlp`` launches and no other kernel, within 1e-5 of the plain
    path, two runs bitwise equal."""
    g, _, _ = _traditional_batch("latency_p", cuda)
    cfg = CostModelConfig(metric="latency_p", gnn=GNNConfig(use_pallas=True), traditional_mp=True)
    plain = dataclasses.replace(cfg, gnn=GNNConfig(use_pallas=False))
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), cfg), cuda)
    wrappers = ("banked_mlp_slotted", "mp_update", "mp_sweep", "gather_sum", "segment_sum")
    before = [_launches(w) for w in wrappers]
    with torch.no_grad():
        got = forward_ensemble(params, g, cfg)
        again = forward_ensemble(params, g, cfg)
        want = forward_ensemble(params, g, plain)
    assert [_launches(w) - b for w, b in zip(wrappers, before)] == [16, 0, 0, 0, 0]
    assert got.shape == (3, int(g.op_x.shape[0]))
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["latency_p", "success"])
def test_traditional_gradient_through_kernels_matches_plain(cuda, metric):
    """Every leaf of a traditional ensemble gets a non-zero gradient through
    the 8 ``banked_mlp`` launches, each within rtol 1e-4 plus 1e-5 x its
    largest entry of the plain path's (the bound of
    ``test_cost_model_gradient_through_kernels_matches_plain``)."""
    g, y, band = _traditional_batch(metric, cuda)
    cfg = CostModelConfig(metric=metric, gnn=GNNConfig(use_pallas=True), traditional_mp=True)
    plain = dataclasses.replace(cfg, gnn=GNNConfig(use_pallas=False))
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), cfg), cuda)
    before = (_launches("banked_mlp_slotted"), _launches("mp_sweep"))
    loss, grads = loop.loss_and_grads(params, g, y, cfg, band)
    assert (_launches("banked_mlp_slotted") - before[0], _launches("mp_sweep") - before[1]) == (8, 0)
    want_loss, want = loop.loss_and_grads(params, g, y, plain, band)
    torch.testing.assert_close(loss, want_loss, **TOL)
    for (path, a), (_, b) in zip(nn.tree_leaves_with_paths(grads), nn.tree_leaves_with_paths(want)):
        assert float(a.abs().max()) > 0, path
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()), msg=str(path))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D", [(2, 2048, 2560), (3, 37, 100), (2, 1, 64)])
def test_linear_scan_backward_matches_plain_vjp(cuda, B, T, D):
    """The ``autograd.Function``'s backward (the reversed scan on the kernel,
    two launches a forward and backward) against the VJP of the plain scan
    (``oracle_vjp`` of ``linear_scan_ref``), at the LM train step's shape and
    ragged ones, within 1e-5 x max|plain| (the scan's tolerance)."""
    from types import SimpleNamespace

    from repro_torch.kernels.common import oracle_vjp

    gen = torch.Generator().manual_seed(T)
    a = torch.rand((B, T, D), generator=gen).to(cuda).requires_grad_()
    b = torch.randn((B, T, D), generator=gen).to(cuda).requires_grad_()
    h0 = torch.randn((B, D), generator=gen).to(cuda).requires_grad_()
    g = torch.randn((B, T, D), generator=gen).to(cuda)
    before = _launches("linear_scan")
    h = scan_ops.linear_scan(a, b, h0)
    got = torch.autograd.grad(h, (a, b, h0), g)
    torch.cuda.synchronize()
    assert _launches("linear_scan") == before + 2
    want = oracle_vjp(SimpleNamespace(needs_input_grad=(True, True, True)), linear_scan_ref, g, a, b, h0)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * float(y.abs().max()))


@pytest.mark.gpu
def test_dp_step_on_one_nccl_rank_matches_train_step(cuda, tmp_path):
    """``make_dp_train_step`` on one NCCL rank (the all-reduce is the
    identity, the division by 1 exact) against ``training/loop.py``'s
    ``train_step`` on one exact-banded batch of 512 graphs: equal parameters."""
    import torch.distributed as dist

    from repro_torch.core.model import ensemble_loss
    from repro_torch.distributed import make_dp_train_step
    from repro_torch.training import optim
    from repro_torch.training.compression import ef_init

    traces = WorkloadGenerator(seed=8).corpus(700)
    ds, buckets = batching.bucket_dataset(batching.dataset_from_traces(traces, "latency_p"), exact=True)
    g, y, band = next(iter(batching.bucketed_batches(ds, buckets, 512, rng=np.random.default_rng(0), device=cuda)))
    cfg = CostModelConfig(metric="latency_p", gnn=GNNConfig(use_pallas=True))
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), cfg), cuda)
    opt = optim.adam(lr=1e-3, max_grad_norm=5.0)
    want, _, _, _ = loop.train_step(params, opt.init(params), ef_init(params), g, y, band, cfg, opt, loop.TrainConfig())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        step = make_dp_train_step(lambda p, batch: ensemble_loss(p, *batch, cfg, band), opt)
        state, _ = step({"params": params, "opt": opt.init(params), "step": 0}, (g, y), 0)
    finally:
        dist.destroy_process_group()
    for a, b in zip(nn.tree_leaves(state["params"]), nn.tree_leaves(want)):
        assert torch.equal(a, b)


# -- the MoE and MLA blocks (deepseek-v2, arctic) --------------------------------------


def _moe_case(case, device):
    """An fp32 MoE block (16 experts, top-4, d 256) and a 64-token input.
    ``overflow``: a bias feature and a router row that send every token's
    first choice to expert 0, which takes 20 of its 64 pairs (capacity
    max(4, int(1.25 * 4 * 64 / 16)) = 20)."""
    kw = {"plain": {}, "shared": dict(n_shared=2, shared_ff=384), "dense_residual": dict(dense_residual=True, dense_ff=512),
          "overflow": {}}[case]
    c = blocks.MoEConfig(n_experts=16, top_k=4, expert_ff=192, **kw)
    p = params.materialize(torch.Generator().manual_seed(40), blocks.moe_defs(256, c), torch.float32, "cpu")
    x = torch.randn((2, 64, 256), generator=torch.Generator().manual_seed(41))
    if case == "overflow":
        x[..., 0] = 1.0
        p["router"][0] = 0.0
        p["router"][0, 0] = 8.0
    return c, p, nn.to_device(p, device), x


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["plain", "shared", "dense_residual", "overflow"])
def test_moe_block_on_card_matches_cpu(cuda, case):
    """``apply_moe`` in fp32 on the card against the CPU from the same weights,
    at a prefill (S = 64) and a decode step (S = 1): the same (token, slot)
    pairs kept and dropped, outputs within 1e-5."""
    c, p_cpu, p_dev, x = _moe_case(case, cuda)
    for xs in (x, x[:, -1:]):
        _, e_cpu, pos_cpu, cap = blocks.moe_route(p_cpu, xs, c)
        _, e_dev, pos_dev, cap_dev = blocks.moe_route(p_dev, xs.to(cuda), c)
        assert cap == cap_dev and torch.equal(e_dev.cpu(), e_cpu)
        assert torch.equal((pos_dev < cap).cpu(), pos_cpu < cap)
        if case == "overflow" and xs.shape[1] == 64:
            assert int((pos_cpu >= cap).sum()) == 2 * (64 - cap)  # each sequence's tokens past 20 lose slot 0
        torch.testing.assert_close(blocks.apply_moe(p_dev, xs.to(cuda), c).cpu(), blocks.apply_moe(p_cpu, xs, c),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("keys", [96, 1100])
def test_mla_block_on_card_matches_cpu(cuda, keys):
    """``apply_mla`` in fp32 on the card against the CPU: uncached, a prefill
    into a ``keys``-position cache (the naive path, or the blocked one past
    1024 keys) and 4 decode steps; outputs and the ``ckv`` cache within 1e-5."""
    c = blocks.MLAConfig(d_model=256, n_heads=8, q_lora=96, kv_lora=64, d_nope=32, d_rope=16, d_v=32)
    p_cpu = params.materialize(torch.Generator().manual_seed(42), blocks.mla_defs(c), torch.float32, "cpu")
    p_dev = nn.to_device(p_cpu, cuda)
    gen = torch.Generator().manual_seed(43)
    n_prompt = keys - 8
    x = torch.randn((2, n_prompt, 256), generator=gen)
    pos = torch.arange(n_prompt)
    want, _ = blocks.apply_mla(p_cpu, x, c, positions=pos)
    got, _ = blocks.apply_mla(p_dev, x.to(cuda), c, positions=pos.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    caches = [{"ckv": torch.zeros((2, keys, 80), device=d)} for d in ("cpu", cuda)]
    start, xs = 0, x
    for _ in range(5):
        ps = torch.arange(start, start + xs.shape[1])
        want, caches[0] = blocks.apply_mla(p_cpu, xs, c, positions=ps, cache=caches[0], cache_len=start)
        got, caches[1] = blocks.apply_mla(p_dev, xs.to(cuda), c, positions=ps.to(cuda), cache=caches[1], cache_len=start)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(caches[1]["ckv"].cpu(), caches[0]["ckv"], rtol=1e-5, atol=1e-5)
        start += xs.shape[1]
        xs = torch.randn((2, 1, 256), generator=gen)
