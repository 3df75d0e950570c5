"""Training substrate in PyTorch: optimizers, data pipeline, the loop,
checkpointing, gradient compression and elastic re-sharding
(``training/elastic.py``) (the port of ``repro.training``)."""

from repro_torch.training.optim import (
    adam,
    adamw,
    sgd,
    apply_updates,
    cosine_schedule,
    constant_schedule,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.training.batching import (
    BucketSpec,
    GraphDataset,
    batches,
    bucket_dataset,
    bucketed_batches,
    dataset_from_traces,
    n_batches,
    prefetch,
    split_dataset,
    split_indices,
)
from repro_torch.training.checkpoint import save_checkpoint, restore_checkpoint, latest_step
from repro_torch.training.compression import (
    EFState,
    ef_init,
    topk_with_error_feedback,
    int8_quantize,
    int8_dequantize,
    int8_roundtrip,
)
from repro_torch.training.loop import (
    TrainConfig,
    TrainResult,
    train_cost_model,
    train_flat_model,
    predict_flat,
)

__all__ = [k for k in dir() if not k.startswith("_")]
