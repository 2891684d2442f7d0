"""The verdict ``correct``: the numbers that a cell's kind compares
(``loops/<kind>.py``: ``numbers``), each held to its limit in
``limits/<cell>.json``."""

from __future__ import annotations

import math


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number finite and within its limit, and
    every number has one; ``checks`` maps each name to its value and
    limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = bool(numbers) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks
