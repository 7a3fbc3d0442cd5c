"""Logging shim with a loguru-like interface (copy of ``illico_tpu.utils.log``).

Exposes the loguru call surface (``logger.info``, ``logger.trace``...) over
the stdlib.  Set ``ILLICO_TPU_LOG=TRACE`` to see trace-level messages
(engine choice, tile widths, stage timings, memory estimates).
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_logger = logging.getLogger("illico_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("%(asctime)s | %(levelname)s | illico_tpu_torch | %(message)s")
    )
    _logger.addHandler(_handler)
    _logger.setLevel(os.environ.get("ILLICO_TPU_LOG", "WARNING").upper())
    _logger.propagate = False


class _Logger:
    def trace(self, msg, *args):
        _logger.log(TRACE, msg, *args)

    def debug(self, msg, *args):
        _logger.debug(msg, *args)

    def info(self, msg, *args):
        _logger.info(msg, *args)

    def warning(self, msg, *args):
        _logger.warning(msg, *args)

    def error(self, msg, *args):
        _logger.error(msg, *args)


logger = _Logger()
