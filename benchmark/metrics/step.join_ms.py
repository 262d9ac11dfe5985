"""Device milliseconds of one join (the tower, the padded prefill, the
insert into the slots), the mean over the joins of the traced window:
the device events between a step's token copy and the next chunk's first
decode attention (``Trace.join_segments``)."""


def read(run):
    if run.trace is None:
        return None
    segs = run.trace.join_segments()
    if not segs:
        return None
    return sum(sum(e.end - e.start for e in s) for s in segs) * 1e-6 / len(segs)
