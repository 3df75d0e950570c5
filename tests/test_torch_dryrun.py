"""The port's dry run and roofline (``repro_torch.launch.{mesh,roofline,dryrun,
hillclimb}``, ``configs.input_specs``) against the JAX package's.

The JAX side that needs devices (``repro.launch.dryrun`` sets ``XLA_FLAGS``
when imported) runs in a subprocess with 8 host devices; the port's full
reduced dry run runs in another, since a process holds one default
(``fake``) process group.  Tests here that build a mesh destroy their group.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import base as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import params as jparams
from repro.models import transformer as jtf
from repro_torch import configs, nn
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.models import params, transformer
from repro_torch.models.steps import TrainStepConfig, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
# the reduced cells' shapes, as the JAX package's small-mesh dry-run test cuts them
SMALL_SHAPES = {"train_4k": (128, 8, "train"), "decode_32k": (256, 8, "decode")}
SMALL_MESHES = {"single": ((4, 2), ("data", "model")), "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture
def fake_group():
    """Destroys the fake default group that a test's meshes made."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(code: str, env_extra=None) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, timeout=300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"stderr:\n{err[-4000:]}"
    return out


# JAX's side: active parameters of every architecture, and the argument bytes
# per device (NamedSharding.shard_shape of every leaf) of the reduced cells
_JAX_SIDE = """
    import json, math
    import jax
    import repro.configs.base as CB
    import repro.launch.dryrun as D
    from repro.configs import ARCHS, get_config, reduced
    from repro.models.params import ShardingRules
    from jax.sharding import NamedSharding

    shapes = {SHAPES}
    CB.SHAPES = tuple(CB.ShapeSpec(n, s, b, k) for n, (s, b, k) in shapes.items())
    out = {{"active": {{a: D.active_params(get_config(a)) for a in ARCHS}}, "args": {{}}}}
    for arch in ("internlm2-1.8b", "gemma2-2b"):
        for shape in shapes:
            for name, (shp, axes) in {MESHES}.items():
                mesh = jax.make_mesh(shp, axes)
                _, args, in_sh = D.build_cell(reduced(get_config(arch)), shape, mesh, ShardingRules(),
                                              D.TrainStepConfig())
                leaves = jax.tree_util.tree_leaves(args)
                shs = jax.tree_util.tree_leaves(in_sh, is_leaf=lambda x: isinstance(x, NamedSharding))
                assert len(leaves) == len(shs)
                out["args"][f"{{arch}}/{{shape}}/{{name}}"] = sum(
                    math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize for a, sh in zip(leaves, shs))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    """Both subprocesses, started with the module's first test so that they
    run beside the in-process tests: the JAX side and the port's reduced
    small-mesh dry run (``_PORT_SMALL_RUN``, its artifacts in a temporary
    root).  Killed at the module's end if still running."""
    procs = {"jax": _run(_JAX_SIDE.format(SHAPES=SMALL_SHAPES, MESHES=SMALL_MESHES),
                         {"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"}),
             "port": _run(_PORT_SMALL_RUN, {"REPRO_ARTIFACTS": str(tmp_path_factory.mktemp("artifacts"))})}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_leaves(tree):
    return [("/".join(_key(k) for k in path), tuple(s.shape), str(s.dtype))
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    leaves = nn.tree_leaves_with_paths(tree)
    assert all(t.is_meta for _, t in leaves)
    return [("/".join(p), tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in leaves]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_and_abstract_defs_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert sorted(_port_leaves(params.abstract(transformer.model_defs(cfg)))) == sorted(
        _jax_leaves(jparams.abstract(jtf.model_defs(jcfg))))
    for shape, jshape in zip(configs.SHAPES, jconfigs.SHAPES):
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert configs.cell_supported(arch, shape) == jconfigs.cell_supported(arch, jshape)
        if not configs.cell_supported(arch, shape)[0]:
            continue
        assert sorted(_port_leaves(configs.input_specs(cfg, shape))) == sorted(
            _jax_leaves(jconfigs.input_specs(jcfg, jshape))), (arch, shape.name)


def test_active_params_and_argument_bytes_match_jax(children, fake_group):
    want = json.loads(_result(children["jax"]).strip().splitlines()[-1])
    assert {a: dryrun.active_params(configs.get_config(a)) for a in configs.ARCHS} == want["active"]
    for arch in ("internlm2-1.8b", "gemma2-2b"):
        for shape, (seq, batch, kind) in SMALL_SHAPES.items():
            for name, (shp, axes) in SMALL_MESHES.items():
                m = mesh.make_mesh(shp, axes)
                _, args = dryrun.build_cell(configs.reduced(configs.get_config(arch)),
                                            configs.ShapeSpec(shape, seq, batch, kind), m, params.ShardingRules(),
                                            TrainStepConfig())
                assert dryrun.local_bytes(args) == want["args"][f"{arch}/{shape}/{name}"], (arch, shape, name)


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_roofline_terms_match_jax_with_its_constants(monkeypatch, n_chips):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", jmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", jmesh.HBM_BW)
    monkeypatch.setattr(roofline, "LINKS", {"nvlink": jmesh.ICI_BW, "network": jmesh.ICI_BW})
    cases = [(3.1e15, 2.2e12, 4.5e10, 1.0e18), (1.0e12, 5.0e13, 0.0, 2.0e15), (2.0e9, 1.0e8, 7.7e11, 0.0), (0, 0, 0, 0)]
    for flops, hbm, coll, mf in cases:
        breakdown = {"all-gather": int(coll), "count": 3}
        want = jroofline.RooflineTerms(flops, hbm, coll, breakdown, mf).as_dict(n_chips)
        got = roofline.RooflineTerms(flops, hbm, coll, breakdown, mf, coll_links={"network": coll}).as_dict(n_chips)
        assert got == want
    for kind in ("train", "fwd"):
        assert roofline.model_flops_estimate(123_456_789, 4096 * 256, kind) == jroofline.model_flops_estimate(
            123_456_789, 4096 * 256, kind)


def _dt(shape, m, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"), m, placements)


def test_counter_flops_on_one_gpu_equal_flop_counter_mode(fake_group):
    """A reduced train step's FLOPs counted on a (1, 1) mesh over meta
    DTensors equal ``FlopCounterMode``'s on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = configs.reduced(configs.get_config("internlm2-1.8b"))
    shape = configs.ShapeSpec("train_4k", 32, 4, "train")
    c, _, _ = dryrun.count_step(cfg, shape, mesh.make_mesh((1, 1), ("data", "model")), params.ShardingRules(),
                                TrainStepConfig())
    defs = transformer.model_defs(cfg)
    p = params.materialize(torch.Generator().manual_seed(0), defs, device="cpu")
    step, opt = make_train_step(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                           generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        step({"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32)}, {"tokens": tokens})
    assert c.flops == fc.get_total_flops() > 0
    assert c.coll["count"] == 0


def test_counter_counts_local_shards_and_partial_sums(fake_group):
    from torch.distributed.tensor import Partial, Replicate, Shard

    m = mesh.make_mesh((4, 2), ("data", "model"))
    M, K, N = 128, 64, 32
    x, w = _dt((M, K), m, [Shard(0), Replicate()]), _dt((K, N), m, [Replicate(), Shard(1)])
    with roofline.Counter() as c:
        y = x @ w
    assert c.flops == 2 * M * K * N / 8 and c.coll["count"] == 0
    assert tuple(y.placements) == (Shard(0), Shard(1))
    # contraction dimension sharded: each GPU does half the products, then DTensor all-reduces
    x, w = _dt((M, K), m, [Replicate(), Shard(1)]), _dt((K, N), m, [Replicate(), Shard(0)])
    with roofline.Counter() as c:
        y = x @ w
        assert c.flops == 2 * M * K * N / 2 and y.placements[1] == Partial()
        y.full_tensor()
    assert c.coll["all-reduce"] == M * N * 4 and c.coll["count"] == 1
    assert c.coll_links == {"nvlink": M * N * 4, "network": 0.0}  # ranks 0 and 1 share a node


def test_counter_bytes_gathers_views_and_live_memory():
    table = torch.empty((1000, 64), device="meta")
    idx = torch.empty((10,), dtype=torch.int64, device="meta")
    with roofline.Counter() as c:
        table[idx]
    assert c.bytes == 10 * 8 + 2 * 10 * 64 * 4  # the indices, the rows read and written: not the table
    row = torch.empty((1, 256), device="meta")
    with roofline.Counter() as c:
        row.expand(64, 256) * 2
    assert c.bytes == row.nbytes + 64 * row.nbytes  # an expanded input reads its storage once
    x = torch.empty((1024, 256), device="meta")  # 1 MiB
    with roofline.Counter() as c:
        x.view(256, 1024).t()
        a = x * 2
        del a
        b = x * 3
    assert c.bytes == 2 * 2 * x.nbytes and c.temp_peak == x.nbytes  # the view moved nothing; a was freed
    with roofline.Counter() as c:
        a = x * 2
        v = a[:10]
        del a
        b = x * 3  # noqa: F841
    assert c.temp_peak == 2 * x.nbytes  # the slice kept a's storage alive
    del v


def test_linear_scan_meta_branch_charges_the_kernel_count(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    B, T, D = 4, 16, 8
    a, b, h0 = (torch.empty(s, device="meta") for s in ((B, T, D), (B, T, D), (B, D)))
    with roofline.Counter() as c:
        h = linear_scan(a, b, h0)
    assert h.shape == (B, T, D) and h.is_meta
    flops, nbytes = 2 * B * T * D, 4 * (3 * B * T * D + B * D)
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert c.kernels == {"linear_scan": {"launches": 1, "flops": flops, "bytes": nbytes}}
    # a DTensor: local shapes, and a sequence-sharded input is gathered first
    m = mesh.make_mesh((4, 2), ("data", "model"))
    a, b = _dt((B, T, D), m, [Shard(0), Shard(2)]), _dt((B, T, D), m, [Shard(0), Shard(1)])
    h0 = _dt((B, D), m, [Shard(0), Shard(1)])
    with roofline.Counter() as c:
        h = linear_scan(a, b, h0)
    Bl, Dl = B // 4, D // 2
    assert tuple(h.placements) == (Shard(0), Shard(2))
    assert c.flops == 2 * Bl * T * Dl and c.kernels["linear_scan"]["launches"] == 1
    assert c.coll["all-gather"] > 0  # b's sequence shards gathered


def test_shard_local_einsum_matches_torch_einsum_on_one_rank(fake_group):
    """``sharding_ctx.einsum`` (the attention's contractions on DTensors) on a
    one-rank mesh, real CPU tensors: its value and both gradients equal
    ``torch.einsum``'s."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import sharding_ctx

    m = mesh.make_mesh((1, 1), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    for eq, sa, sb in (("bqkrd,bskd->bkrqs", (2, 3, 2, 2, 4), (2, 5, 2, 4)),
                       ("bkrqs,bskd->bqkrd", (2, 2, 2, 3, 5), (2, 5, 2, 4))):
        a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)
        da = DTensor.from_local(a.clone(), m, [Shard(0), Shard(2 if eq[2] == "k" else 1)]).requires_grad_()
        db = DTensor.from_local(b.clone(), m, [Shard(0), Replicate()]).requires_grad_()
        pa, pb = a.clone().requires_grad_(), b.clone().requires_grad_()
        got, want = sharding_ctx.einsum(eq, da, db), torch.einsum(eq, pa, pb)
        cot = torch.randn(want.shape, generator=g)
        got.backward(DTensor.from_local(cot, m, got.placements))
        want.backward(cot)
        torch.testing.assert_close(got.full_tensor(), want)
        torch.testing.assert_close(da.grad.full_tensor(), pa.grad)
        torch.testing.assert_close(db.grad.full_tensor(), pb.grad)


def test_collectives_only_on_a_mesh_of_more_than_one_gpu(fake_group):
    cfg = configs.reduced(configs.get_config("internlm2-1.8b"))
    shape = configs.ShapeSpec("prefill_32k", 64, 8, "prefill")
    for shp, want_coll in (((1, 1), False), ((4, 2), True)):
        c, _, _ = dryrun.count_step(cfg, shape, mesh.make_mesh(shp, ("data", "model")), params.ShardingRules(),
                                    TrainStepConfig())
        assert (c.coll["count"] > 0) == want_coll and c.flops > 0 and c.temp_peak > 0, shp


def test_links_follow_nodes_of_eight():
    assert mesh.link_bw(range(8)) == ("nvlink", mesh.NVLINK_BW)
    assert mesh.link_bw(range(16)) == ("network", mesh.NET_BW)  # a 16-wide model group spans two nodes
    assert mesh.link_bw(range(0, 256, 16)) == ("network", mesh.NET_BW)  # a data group strides across nodes
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)


_PORT_SMALL_RUN = """
    import json, os
    import repro_torch.configs.base as CB
    import repro_torch.launch.dryrun as D
    import repro_torch.launch.mesh as M
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import hillclimb

    D.make_production_mesh = lambda *, multi_pod=False: M.make_mesh(
        (2, 2, 2) if multi_pod else (4, 2), ("pod", "data", "model") if multi_pod else ("data", "model"))
    CB.SHAPES = (CB.ShapeSpec("train_4k", 128, 8, "train"), CB.ShapeSpec("prefill_32k", 256, 8, "prefill"),
                 CB.ShapeSpec("decode_32k", 256, 8, "decode"), CB.ShapeSpec("long_500k", 512, 1, "decode"))
    _orig = get_config
    D.get_config = lambda a: reduced(_orig(a))
    cells = [D.run_cell(a, s, False, verbose=False) for a, s in
             (("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "decode_32k"), ("xlstm-125m", "prefill_32k"))]
    # the 2x2x2 mesh: a batch of one (DTensor's redistribution search stalls on the reduced
    # configs' batches sharded over both pod and data: PERF.md, ROADMAP queue 3)
    cells.append(D.run_cell("recurrentgemma-2b", "long_500k", True, verbose=False))
    for name, cell in {**hillclimb.cell_a(), **hillclimb.cell_b(), **hillclimb.cell_c()}.items():
        cells.append(cell)
    for cell in cells:
        assert cell["status"] == "ok", (cell["arch"], cell["shape"], cell.get("traceback"))
        r = cell["roofline"]
        assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0 and r["collectives"]["count"] > 0, cell
    assert cells[2]["delta_correction"]["axis"] == "time" and cells[3]["chips"] == 8
    assert cells[3]["kernels"]["linear_scan"]["launches"] == 6
    print("DRYRUN-OK", len(cells), len(os.listdir(os.environ["REPRO_ARTIFACTS"] + "/dryrun")))
"""


def test_reduced_small_mesh_dry_run_and_hillclimb_end_ok(children):
    out = _result(children["port"], timeout=600)
    assert "DRYRUN-OK 9 7" in out, out
