"""Pad rows among the rows the window's join prefills ran, in percent:
100 x the sum over the window's joins (``StepLog.joins``, the engine's
``join_log``) of group batch less members, over the sum of group batches."""


def read(run):
    joins = [j for s in run.window_steps() for j in s.joins]
    rows = sum(g_b for g_b, _ in joins)
    if not rows:
        return None
    return 100.0 * sum(g_b - len(ids) for g_b, ids in joins) / rows
