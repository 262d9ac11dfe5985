"""The operations that the tokens delivered in the window needed (the
tower and prefill of each first token, a decode step of each later one,
attention over the positions each query sees; ``harness/work.py``), over
the window's seconds at the bf16 dense peak, in percent."""
from harness import work


def read(run):
    flops = sum(work.request_flops(run.vision, run.text, r.positions, r.at_start, r.at_stop)
                for r in run.records)
    if not flops:
        return None
    return 100.0 * flops / (run.window["seconds"] * run.peaks["bf16_flops_per_s"])
