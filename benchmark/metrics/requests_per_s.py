"""Requests completed in the window, over the window's seconds."""


def read(run):
    w = run.window
    done = sum(1 for r in run.records if r.done_t is not None and w["t0"] <= r.done_t <= w["t_stop"])
    return done / w["seconds"]
