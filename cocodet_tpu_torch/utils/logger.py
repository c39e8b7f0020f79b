"""Logging setup (cocodet_tpu/utils/logger.py): rank-0 console and
``<save_dir>/<filename>`` sinks on the ``cocodet_tpu_torch`` logger."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"

logger = logging.getLogger("cocodet_tpu_torch")


def setup_logger(save_dir: Optional[str] = None, rank: int = 0, filename: str = "log.txt",
                 mode: str = "a", level: int = logging.INFO) -> logging.Logger:
    """Install rank-0-only console + file handlers (ref logger.py:52-95)."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(level)
    logger.propagate = False
    if rank != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(console)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename), mode=mode)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger
