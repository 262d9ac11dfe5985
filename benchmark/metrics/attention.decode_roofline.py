"""Decode attention (``decode_attention``) against its roofline in the
traced window: for each decode step, the K and V of the positions each
occupied slot's query sees, with its q and output, at the memory rate,
over those kernels' device time, in percent."""
from harness import work


def read(run):
    steps = run.traced_steps()
    if not steps:
        return None
    c = run.engine["chunk"]
    keys = sum(c * n + c * (c + 1) // 2 for s in steps for n in s.lengths)
    queries = c * sum(len(s.lengths) for s in steps)
    nbytes = work.decode_attention_bytes(run.text, keys, queries)
    return run.roofline(nbytes / run.peaks["hbm_bytes_per_s"], "decode_attention")
