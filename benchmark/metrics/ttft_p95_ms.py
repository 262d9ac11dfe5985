"""95th percentile over every request sent in the window (followed after
it) of the time from its scheduled send to the host holding its first
token."""
from harness.metrics import percentile


def read(run):
    return percentile(run.ttft_ms(), 95)
