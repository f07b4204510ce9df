"""Utilities: observability (per-stage timers, logging).

Port of ``libultrahdr_tpu/utils``.  The reference has no in-library
tracing; its tooling is a wall-clock Profiler in the demo app
(examples/ultrahdr_app.cpp:102-140) and ALOGx macros compiled out unless
UHDR_ENABLE_LOGS (lib/include/ultrahdr/ultrahdrcommon.h:34-118).  Here the
analogs are run-time switches: `stage()` timers on the orchestration layer
(UHDR_TPU_PROFILE=1) and a std-logging logger gated by UHDR_TPU_LOGS.  For
kernel-level traces use torch.profiler.
"""

from .profiling import get_logger, stage, stage_report  # noqa: F401
