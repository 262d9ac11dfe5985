"""Tokens the engine delivered to the host in the window, over the
window's seconds (host clock, whole steps)."""


def read(run):
    return run.counter("tokens") / run.window["seconds"]
