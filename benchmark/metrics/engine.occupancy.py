"""Mean share of the engine's slots occupied at each chunk of the window
(``ContinuousBatcher.slot_req`` before each ``step()``), in percent."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return 100.0 * sum(s.occupied for s in steps) / (len(steps) * run.engine["n_slots"])
