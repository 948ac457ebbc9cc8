"""Run logging: file + console handlers and unique per-run save dirs
(counterpart of kpgnn_tpu/utils/logging.py)."""
from __future__ import annotations

import logging
import os


def get_save_dir(base_dir: str, name: str, id_max: int = 500) -> str:
    """A fresh ``<base_dir>/train/<name>-NN`` directory."""
    for uid in range(1, id_max):
        path = os.path.join(base_dir, "train", f"{name}-{uid:02d}")
        if not os.path.exists(path):
            os.makedirs(path)
            return path
    raise RuntimeError("Too many save directories with the same name")


def get_logger(log_dir: str, name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    logger.propagate = False

    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
    fh.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%m.%d.%y %H:%M:%S")
    fh.setFormatter(fmt)
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger
