"""The stages ``flat``, ``extrap``, ``ablations`` and ``finetune`` of the
port's ``launch/train.py`` against the JAX package's, on the CPU.

Each stage runs into a temporary artifact root with its corpora cut to a few
dozen traces and one epoch.  The port trains for real; the JAX stage driver
runs with its ``train_cost_model`` recorded and stubbed (its per-bucket jit
compiles take about 30 s a model; the loop itself is held against JAX in
``test_torch_baselines.py`` and ``test_torch_training.py``).  Compared: the
stored names and manifest records, each run's config, training settings and
training set (transforms applied), and every corpus, trace by trace.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core.model as jmodel
import repro.launch.artifacts as jartifacts
import repro.launch.train as jlaunch
import repro.training as jtraining
from repro_torch import nn
from repro_torch.core import gnn, model
from repro_torch.core.model import REGRESSION_METRICS
from repro_torch.launch import artifacts
from repro_torch.launch import train as launch_train
from repro_torch.serve.estimator import CostEstimator
from repro_torch.training import loop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's parallel workers share the machine's cores; restored
    after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_train_stub(calls):
    """Stands in for the JAX package's ``train_cost_model`` inside its stage
    driver (whose names, configs, datasets and stored records are what these
    tests compare; the loop itself is held against JAX above and in
    test_torch_training.py), recording each call."""

    def train(tr, va, cfg, train_cfg=jtraining.TrainConfig(), init_params=None):
        calls.append((tr, va, cfg, train_cfg, init_params is not None))
        params = init_params if init_params is not None else jmodel.init_cost_model(jax.random.PRNGKey(0), cfg)
        history = [{"epoch": 0, "train_loss": 1.0, "val_loss": 1.0, "seconds": 0.0}]
        return jtraining.TrainResult(params=params, history=history, best_val=1.0, steps=1)

    return train


def _recording(calls, fn):
    def train(tr, va, cfg, train_cfg=loop.TrainConfig(), init_params=None, device=None):
        calls.append((tr, va, cfg, train_cfg, init_params is not None))
        return fn(tr, va, cfg, train_cfg, init_params=init_params, device=device)

    return train


def _stored(root):
    """{kind/name: manifest extra} of every stored model, and the corpus names."""
    out = {}
    for kind in ("costream", "flat"):
        for name in sorted(os.listdir(os.path.join(root, kind))) if os.path.isdir(os.path.join(root, kind)) else []:
            with open(os.path.join(root, kind, name, "step_0000000000", "manifest.json")) as f:
                out[f"{kind}/{name}"] = json.load(f)["extra"]
    corpora = sorted(n.replace(".torch.pkl", "").replace(".pkl", "") for n in os.listdir(os.path.join(root, "corpus")))
    return out, corpora


def _same_traces(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.query.describe() == b.query.describe()
        assert a.placement.assignment == b.placement.assignment
        assert a.labels.as_dict() == b.labels.as_dict()
        assert [vars(n) for n in a.cluster.nodes] == [vars(n) for n in b.cluster.nodes]


@pytest.mark.parametrize("stage", ["flat", "extrap", "ablations", "finetune"])
def test_launch_train_stage_matches_jax(stage, tmp_path, monkeypatch):
    """Each stage on the CPU into a temporary artifact root, corpora cut to
    a few dozen traces, one epoch: the port trains for real, the JAX stage
    driver runs with its cost-model loop recorded, not run.  The stored
    names and records, each run's config, training settings and training
    set (transform applied), and every corpus equal the JAX package's; a
    rerun skips everything."""
    ours_root, theirs_root = str(tmp_path / "torch"), str(tmp_path / "jax")
    monkeypatch.setattr(artifacts, "ROOT", ours_root)
    monkeypatch.setattr(jartifacts, "ROOT", theirs_root)
    for mod in (launch_train, jlaunch):
        monkeypatch.setattr(mod, "MAIN_CORPUS", 24)
        monkeypatch.setattr(mod, "EXTRAP_CORPUS", 12)
        monkeypatch.setattr(mod, "FINETUNE_N", 20)
    ours_calls, theirs_calls = [], []
    monkeypatch.setattr(launch_train, "train_cost_model", _recording(ours_calls, loop.train_cost_model))
    monkeypatch.setattr(jlaunch, "train_cost_model", _jax_train_stub(theirs_calls))
    if stage == "finetune":  # both roots hold one main_throughput ensemble, trained by the port
        launch_train._train_one(launch_train.main_corpus(), "throughput", "main_throughput", 2, 1, device="cpu",
                                verbose=False)
        shutil.copytree(os.path.join(ours_root, "costream"), os.path.join(theirs_root, "costream"))
        os.remove(artifacts.path("corpus", "main.torch.pkl"))  # not the stage's own corpus
        ours_calls.clear()

    t_ours = launch_train.main(["--stage", stage, "--epochs", "1", "--extrap-epochs", "1", "--ablation-epochs", "1",
                                "--finetune-epochs", "1", "--device", "cpu"])
    assert t_ours is None
    getattr(jlaunch, f"stage_{stage}")(1)

    ours, ours_corpora = _stored(ours_root)
    theirs, theirs_corpora = _stored(theirs_root)
    assert sorted(ours) == sorted(theirs) and ours_corpora == theirs_corpora
    for name, extra in ours.items():
        want = theirs[name]
        assert set(extra) == set(want), name
        for k, v in want.items():
            if k == "gnn":
                assert {**v, "use_pallas": True} == extra[k], name  # the port trains through the kernels
            elif k not in ("best_val", "steps", "history", "seconds"):
                assert extra[k] == v, (name, k)
    assert len(ours_calls) == len(theirs_calls)
    for (tr, va, cfg, tcfg, warm), (jtr, jva, jcfg, jtcfg, jwarm) in zip(ours_calls, theirs_calls):
        assert (cfg.metric, cfg.n_ensemble, cfg.traditional_mp, warm) == (jcfg.metric, jcfg.n_ensemble,
                                                                         jcfg.traditional_mp, jwarm)
        assert cfg.gnn == gnn.GNNConfig(**{**jcfg.gnn.__dict__, "use_pallas": True})
        for f in ("epochs", "batch_size", "lr", "seed", "exact_banding", "weight_decay", "max_grad_norm"):
            assert getattr(tcfg, f) == getattr(jtcfg, f), f
        for x, y in zip(list(tr.graphs) + [tr.labels, va.labels], list(jtr.graphs) + [jtr.labels, jva.labels]):
            np.testing.assert_array_equal(x, y)
    for name in ours_corpora:
        with open(os.path.join(ours_root, "corpus", f"{name}.torch.pkl"), "rb") as f:
            mine = pickle.load(f)
        with open(os.path.join(theirs_root, "corpus", f"{name}.pkl"), "rb") as f:
            _same_traces(mine, pickle.load(f))

    if stage == "flat":
        assert sorted(ours) == [f"flat/flat_{m}" for m in sorted(model.ALL_METRICS)]
        params, cfg = artifacts.load_flat_model("flat_success")
        assert cfg.task == "classification" and all(torch.isfinite(t).all() for t in nn.tree_leaves(params))
    elif stage == "extrap":
        assert len(ours) == 8 * 5 and len(ours_corpora) == 8
        assert ours["costream/extrap_weaker_cpu_latency_p"]["direction"] == "weaker"
    elif stage == "ablations":
        assert {n for n, e in ours.items() if e["traditional_mp"]} == {
            f"costream/ablate_traditional_{m}" for m in REGRESSION_METRICS}
        params, cfg = artifacts.load_cost_model("ablate_traditional_latency_e")
        assert cfg.traditional_mp and cfg.gnn.use_pallas
        result = CostEstimator({"latency_e": (params, cfg)}, device="cpu").estimate(launch_train.main_corpus()[:5])
        assert np.isfinite(result["latency_e"]).all()
    else:
        assert ours["costream/finetune_throughput"]["finetuned_from"] == "main_throughput"
        assert ours_calls[0][3].batch_size == 256 and ours_calls[0][4]
    n_before = len(ours_calls)
    getattr(launch_train, f"stage_{stage}")(1, device="cpu")  # resumable: everything is stored
    assert len(ours_calls) == n_before and _stored(ours_root)[0].keys() == ours.keys()


def test_one_extrap_epoch_does_not_lower_every_run():
    """Why ``chip_smoke.py`` holds each extrap run against the same run on
    the CPU instead of against its validation loss at init: at its cut (400
    traces, one epoch, batch 512, exact banding) the plain path itself ends
    some runs above their loss at init.  Corpus seed ``CORPUS_SEED + 424``
    (``hash`` picks one of 1000 offsets per process) gives the stronger-
    bandwidth ``success`` run the card ended at 1.98x its init loss; the CPU
    plain path ends it there too (``test_torch_cuda.py::
    test_extrap_run_on_card_matches_the_cpu`` holds the card to it)."""
    from repro_torch.core.graph import batch_banding
    from repro_torch.dsps import WorkloadGenerator
    from repro_torch.training import batching

    traces = WorkloadGenerator(launch_train.extrap_generator("stronger", "bandwidth"),
                               seed=launch_train.CORPUS_SEED + 424).corpus(400)
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(traces, "success"), seed=launch_train.SPLIT_SEED)
    cfg = model.CostModelConfig(metric="success", gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=1)
    p0 = model.init_cost_model(torch.Generator().manual_seed(0), cfg)
    g, y = batching.batch_to_device(va.graphs, va.labels, "cpu")
    with torch.no_grad():
        at_init = float(model.ensemble_loss(p0, g, y, cfg, batch_banding(va.graphs)))
    res = loop.train_cost_model(tr, va, cfg, loop.TrainConfig(epochs=1, batch_size=512, lr=1.5e-3, seed=0,
                                                              exact_banding=True), device="cpu")
    assert res.steps == 31 and len(res.history) == 1
    assert res.best_val > 1.5 * at_init, (res.best_val, at_init)
