"""Soft process-wide deadline for long engine runs (counterpart:
openmvg_tpu/utils/deadline.py).

An absolute epoch deadline is set with set_deadline or published through
the OMT_DEADLINE_EPOCH environment variable (inherited by subprocesses).
Engines poll `past()` at round boundaries: past it they stop adding work,
run the cheapest consistent cleanup and return a partial but valid scene.
"""

import os
import time

_deadline = None


def set_deadline(epoch):
    """Set (or clear with None) the absolute time.time() deadline."""
    global _deadline
    _deadline = epoch


def get_deadline():
    if _deadline is not None:
        return _deadline
    v = os.environ.get("OMT_DEADLINE_EPOCH")
    try:
        return float(v) if v else None
    except ValueError:
        return None


def past(margin_s=0.0):
    """True when within margin_s of (or beyond) the deadline."""
    d = get_deadline()
    return d is not None and time.time() > d - margin_s


def remaining():
    """Seconds left, or None when no deadline is set."""
    d = get_deadline()
    return None if d is None else d - time.time()
