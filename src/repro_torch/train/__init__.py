"""Training substrate: optimizer, schedules, gradient compression,
checkpointing and the generic train step, as the JAX package's
``repro.train`` lays them out, on one device or across ranks (a
``Topology``: ``state_specs``, the cross-rank global norm, the
data-parallel ``compression.compressed_psum``, sharded checkpoints and
their elastic restore)."""

from repro_torch.train import compression
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (
    AdamWConfig,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
    state_specs,
)
from repro_torch.train.schedule import constant, warmup_cosine
from repro_torch.train.train_step import TrainConfig, build_train_step, init_train_state

__all__ = [
    "AdamWConfig", "init_state", "apply_updates", "global_norm",
    "clip_by_global_norm", "state_specs", "warmup_cosine", "constant",
    "TrainConfig", "build_train_step", "init_train_state",
    "Checkpointer", "compression",
]
