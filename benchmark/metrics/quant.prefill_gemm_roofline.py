"""The int8 GEMM (``q8_gemm``) against its roofline in the traced window:
for each join, the decoder projections over its real members' prompt
positions (pad rows excluded), the larger of their operations at the bf16
peak and their bytes at the memory rate, over those kernels' device
time, in percent."""
from harness import work


def read(run):
    joins = [j for s in run.traced_steps() for j in s.joins]
    rows = [run.join_rows(j) for j in joins]
    if not joins or any(r is None for r in rows):
        return None
    bound = work.sum_bound((work.gemm_join(run.text, r) for r in rows), run.peaks)
    return run.roofline(bound, "q8_gemm")
