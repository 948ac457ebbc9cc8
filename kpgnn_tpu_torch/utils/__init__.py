"""Utilities: logging, meters, seeds, activation capture for parity,
profiling (counterpart of kpgnn_tpu/utils).

Not exported: ``timed`` (the JAX package's wall-clock block timer); the
port marks stretches of the program with ``profiling.span``, timed on
the profiler's clock."""
from .logging import get_logger, get_save_dir
from .meters import AverageMeter
from .parity import capture_activations, dump_activations
from .profiling import trace
from .seed import get_seed, seed_everything


def get_available_devices():
    """The CUDA devices, or the CPU where there is none (reference:
    train_utils.py:224-239)."""
    import torch

    n = torch.cuda.device_count()
    return ([torch.device(f"cuda:{i}") for i in range(n)] if n
            else [torch.device("cpu")])


__all__ = ["get_logger", "get_save_dir", "get_seed", "seed_everything",
           "AverageMeter", "get_available_devices", "trace",
           "capture_activations", "dump_activations"]
