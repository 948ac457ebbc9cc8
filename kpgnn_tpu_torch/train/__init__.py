"""Training: config, loops, loaders, resident stores, k-fold splits,
checkpoints (counterpart of kpgnn_tpu/train).

JAX-only, not exported: ``TrainState`` and ``create_train_state`` (flax
state; here a ``torch.nn.Module`` and ``state.make_optimizer``'s
optimizer), ``make_train_step`` and ``make_eval_step`` (jit step
factories; here the eager ``loop.train_step`` and ``loop.eval_step``)."""
from .checkpoint import CheckpointSaver, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .ema import EMA
from .kfold import k_fold, k_fold_unstratified
from .loader import GraphLoader
from .loop import Trainer, evaluate, train_epoch
from .lr import ReduceLROnPlateau, StepDecay
from .resident import (BandedStore, DenseStore, build_banded_store,
                       build_dense_store, epoch_index_chunks,
                       gather_banded_batch, gather_batch,
                       make_parallel_resident_eval,
                       make_parallel_resident_train_epoch,
                       make_resident_eval, make_resident_train_epoch,
                       parallel_epoch_index_chunks, plan_banded_store_shapes)
from .state import count_parameters

__all__ = [
    "TrainConfig", "train_epoch", "evaluate", "Trainer",
    "ReduceLROnPlateau", "StepDecay", "GraphLoader",
    "DenseStore", "build_dense_store", "gather_batch",
    "BandedStore", "build_banded_store", "gather_banded_batch",
    "plan_banded_store_shapes",
    "epoch_index_chunks", "make_resident_train_epoch", "make_resident_eval",
    "parallel_epoch_index_chunks", "make_parallel_resident_train_epoch",
    "make_parallel_resident_eval",
    "k_fold", "k_fold_unstratified",
    "CheckpointSaver", "save_checkpoint", "load_checkpoint", "EMA",
]
