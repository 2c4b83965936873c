"""Leveled logging for the port.

Copy of ``nextgenmap_tpu/utils/logging.py`` under the port's own root
logger, ``ngm-torch``: stdlib logging to stderr; fatal errors raise instead
of exiting so library users can handle them.
"""

from __future__ import annotations

import logging
import sys

ROOT = "ngm-torch"
_FORMAT = "[%(levelname).1s %(asctime)s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = ROOT) -> logging.Logger:
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger(ROOT)
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
