"""Structured logging + phase timers.

The reference's observability is stdout prose plus wall-clock phase
accumulators (SURVEY.md §5: StopClock, cputime/getPeakRSS at exit, the
search ``<out>.time`` file).  Here: Python logging with per-phase timers,
and an optional jax.profiler trace around the device compute.
"""

from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger("taxor_jax")


def setup_logging(verbose: bool = False) -> None:
    level = logging.DEBUG if verbose else logging.INFO
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[taxor %(levelname).1s %(asctime)s] "
                              "%(message)s", "%H:%M:%S")
        )
        logger.addHandler(h)
    logger.setLevel(level)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """jax.profiler trace wrapper; no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
