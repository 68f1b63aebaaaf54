"""Logging + timing utilities (own copy of ``mmlspark_tpu.core.logging_utils``).

:func:`get_logger` configures one stream handler per named logger;
:func:`timed` measures a block's wall time and logs it. The obs-plane
spans and histograms of the JAX package are not part of this copy.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Iterator

LOG_LEVEL = "INFO"


def get_logger(name: str = "mmlspark_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(LOG_LEVEL)
        logger.propagate = False
    return logger


@contextmanager
def timed(label: str, logger: logging.Logger | None = None,
          rows: int | None = None) -> Iterator[dict]:
    """Context manager measuring wall time; yields a dict that receives
    ``elapsed_s`` on exit, and logs it at INFO when ``logger`` is given.
    Host clock only: device work still in flight at exit is not counted,
    so callers end the block with the work's result in hand."""
    record: dict = {"label": label}
    t0 = time.perf_counter()
    try:
        yield record
    finally:
        record["elapsed_s"] = time.perf_counter() - t0
        if logger is not None:
            extra = f" ({rows} rows)" if rows is not None else ""
            logger.info("%s took %.3fs%s", label, record["elapsed_s"], extra)
