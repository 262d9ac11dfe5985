"""Median of the window's times to the first token (``ttft_p95_ms``'s
sample): steadier than its tail, and moved by the same joins."""
from harness.metrics import percentile


def read(run):
    return percentile(run.ttft_ms(), 50)
