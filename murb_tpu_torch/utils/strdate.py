"""Physic-time formatting, parity with ``strDate`` (ref: src/murb/main.cpp:175-197).

A copy of ``murb_tpu/utils/strdate.py``, which cannot be imported without JAX.
"""
from __future__ import annotations


def str_date(timestamp: float) -> str:
    """Format seconds as ``...d ...h ...m ...s`` with the reference's widths."""
    days = int(timestamp // (24 * 60 * 60))
    rest = timestamp - days * 24 * 60 * 60
    hours = int(rest // (60 * 60))
    rest -= hours * 60 * 60
    minutes = int(rest // 60)
    rest -= minutes * 60
    return f"{days:4d}d {hours:4d}h {minutes:4d}m {rest:5.3f}s"
