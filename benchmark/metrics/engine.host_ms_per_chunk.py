"""Host milliseconds a chunk outside the wait for its tokens: the
engine's ``host_t`` ``step_total`` minus ``fetch``, over ``chunks_run``,
in the window."""


def read(run):
    chunks = run.counter("chunks")
    if not chunks:
        return None
    return 1e3 * (run.host_t("step_total") - run.host_t("fetch")) / chunks
