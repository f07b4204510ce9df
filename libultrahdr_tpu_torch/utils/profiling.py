"""Per-stage wall-clock timers and gated logging.

Port of ``libultrahdr_tpu/utils/profiling.py``.  Enable the timers with
UHDR_TPU_PROFILE=1 (they accumulate per stage name; read them with
stage_report()).  Enable the logs with UHDR_TPU_LOGS=1, the run-time analog
of the reference's UHDR_ENABLE_LOGS compile flag (ultrahdrcommon.h:34-118).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time

_ENABLED = os.environ.get("UHDR_TPU_PROFILE", "0") not in ("0", "")
_ACC: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
# stages are timed on the pipelined encode's join threads too
_LOCK = threading.Lock()

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("libultrahdr_tpu_torch")
        if os.environ.get("UHDR_TPU_LOGS", "0") not in ("0", ""):
            _logger.setLevel(logging.DEBUG)
            if not _logger.handlers:
                h = logging.StreamHandler()
                h.setFormatter(logging.Formatter(
                    "%(asctime)s %(name)s %(levelname)s %(message)s"))
                _logger.addHandler(h)
        else:
            _logger.addHandler(logging.NullHandler())
    return _logger


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage.  A no-op unless UHDR_TPU_PROFILE=1.

    Device work is asynchronous: a stage that only launches shows ~0, and
    the time lands in the stage that first waits for a result (a download,
    an event)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            acc = _ACC[name]
            acc[0] += 1
            acc[1] += dt
        get_logger().debug("stage %s: %.1f ms", name, dt * 1e3)


def stage_report() -> dict[str, tuple[int, float]]:
    """{stage: (calls, total seconds)} accumulated so far."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _ACC.items()}
