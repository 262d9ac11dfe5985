"""Set-up seconds on the host clock: from the process's start (before
torch is imported) to the window's opening. It holds the imports, the
kernel library's build or load, the weights, the port's quantization,
the engine, ``prepare()`` and the warm-up."""


def read(run):
    return run.setup_s
