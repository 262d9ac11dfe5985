"""The int8 GEMV (``q8_gemv``) against its roofline in the traced window:
the weights and scales (with the rows in and out) of every decoder
projection and the lm_head of each decode step at n_slots + 1 rows, and
of each join's lm_head at its group batch, at the memory rate, over
those kernels' device time, in percent."""
from harness import work


def read(run):
    steps = run.traced_steps()
    if not steps:
        return None
    t, rows, chunk = run.text, run.engine["n_slots"] + 1, run.engine["chunk"]
    n_steps = chunk * len(steps)
    joins = [j for s in steps for j in s.joins]
    nbytes = n_steps * work.gemv_step_bytes(t, rows) + sum(work.lm_head_bytes(t, j[0]) for j in joins)
    return run.roofline(nbytes / run.peaks["hbm_bytes_per_s"], "q8_gemv")
