"""The port's runnable examples, the counterparts of the JAX package's
``examples/*.py``: each runs as ``python -m repro_torch.examples.<name>``
with the JAX script's flags plus ``--device`` (the CUDA card by default;
``--device cpu`` runs the plain PyTorch path), prints what the JAX script
prints, and its ``main(argv)`` returns the same as a dict.

- ``quickstart``: corpus, a latency model trained and bundled, predictions
  and a heterogeneous stream through ``PlacementService``;
- ``optimize_placement``: the paper's initial-placement use case against the
  heuristic, the simulator as ground truth;
- ``controller_demo``: the drift-and-failure fleet under the placement
  controller against a static fleet;
- ``serve_lm``: batched cached decode of a reduced LM;
- ``train_lm``: LM training with atomic checkpoints, an injected failure
  (exit 17) and the restart from the newest checkpoint.
"""
