"""Mean of the engine's own time from ``submit()`` to the ``_fill_slots``
that takes the request into a join group (``Request.t_submit`` to
``t_taken``), in ms: the first term of the program's time to the first
token. Over the window's requests sent at least ``stamps.MARGIN_S`` before
its close (``stamps.requests``). None where the engine stamps neither."""
from harness import stamps


def read(run):
    return stamps.mean(stamps.request_ms(stamps.requests(run), "t_submit", "t_taken"))
