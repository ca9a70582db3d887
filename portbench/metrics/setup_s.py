"""setup_s: seconds from process start to the window's start: imports,
the build of the kernels on a first run, weights made on the device,
warm-up (host clock)."""


def read(run):
    return run.setup_s
