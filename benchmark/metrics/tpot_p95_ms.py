"""95th percentile over the window's requests of two or more tokens of
(last token's time - first token's time) / (tokens - 1), host clock."""
from harness.metrics import percentile


def read(run):
    vals = [(r.last_t - r.first_t) * 1e3 / (r.seen - 1) for r in run.sent_in_window()
            if r.done_t is not None and r.seen >= 2]
    return percentile(vals, 95)
