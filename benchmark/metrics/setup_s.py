"""Process start to the window's start: imports, the kernels' library,
the stream, the system's set-up and the warm-up."""


def read(run):
    return run.setup_s
