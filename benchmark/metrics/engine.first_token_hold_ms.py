"""Mean of the engine's own time from the end of the request's join (its
prefill and insert enqueued: ``Request.t_joined``) to the engine's thread
holding its first token (``t_first``), in ms: the wait for the device to
run what is queued before that token and for the next chunk's read, the
last term of the program's time to the first token. Over the window's
requests sent at least ``stamps.MARGIN_S`` before its close
(``stamps.requests``). None where the engine stamps neither."""
from harness import stamps


def read(run):
    return stamps.mean(stamps.request_ms(stamps.requests(run), "t_joined", "t_first"))
