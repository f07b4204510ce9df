"""Utilities: observability (request spans, logging).

Port of ``libultrahdr_tpu/utils``.  The reference has no in-library
tracing; its tooling is a wall-clock Profiler in the demo app
(examples/ultrahdr_app.cpp:102-140) and ALOGx macros compiled out unless
UHDR_ENABLE_LOGS (lib/include/ultrahdr/ultrahdrcommon.h:34-118).  Here the
decode chain records `stage()` spans (decode, parse, Huffman, upload,
dispatch, wait, download), and the encode chain its own (encode, upload,
dispatch, wait, download, join, assemble), whenever they run under a
``torch.profiler`` session, on the profiler's clock; read them with
``profiling.spans()`` or summed with ``stage_report()``.  The logger is
gated by UHDR_TPU_LOGS.
"""

from .profiling import get_logger, stage, stage_report  # noqa: F401
