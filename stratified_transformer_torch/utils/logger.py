"""Console + file logger (the JAX package's ``utils/logger.py``; reference
``util/logger.py:29-85``)."""

from __future__ import annotations

import functools
import logging
import os
import sys


@functools.lru_cache()
def get_logger(output: str | None = None, name: str = "st_torch",
               rank: int = 0):
    """The logger ``name`` writing to stdout (rank 0) and, when ``output``
    is given, appending to ``output`` (a ``.txt`` / ``.log`` file) or to
    ``<output>/log.txt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s",
        datefmt="%m/%d %H:%M:%S")
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output is not None:
        filename = output if output.endswith(".txt") or output.endswith(
            ".log") else os.path.join(output, "log.txt")
        if rank > 0:
            filename = filename + f".rank{rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.StreamHandler(open(filename, "a"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
