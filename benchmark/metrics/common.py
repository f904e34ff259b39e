"""Arithmetic that more than one metric's reader shares."""
from __future__ import annotations


def span_mean(obs: dict, name: str):
    """Mean seconds of a benchmark span over the window's steps."""
    vals = obs.get("spans", {}).get(name)
    return sum(vals) / len(vals) if vals else None
