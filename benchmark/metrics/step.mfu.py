"""The operations that the tokens delivered in the window needed (the
tower and prefill of each first token, a decode step of each later one,
attention over the positions each query sees: the architecture's
``request_flops``), over the window's seconds at the bf16 dense peak, in
percent."""


def read(run):
    config = run.cell.config
    flops = sum(run.arch.request_flops(config, r.positions, r.at_start, r.at_stop) for r in run.records)
    if not flops:
        return None
    return 100.0 * flops / (run.window["seconds"] * run.peaks["bf16_flops_per_s"])
