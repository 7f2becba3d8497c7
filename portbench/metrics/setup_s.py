"""Seconds from the process's start to the window: importing torch and
the port, the CUDA context, building or loading the kernel library, the
inputs made on the card, and the warm-up over the pool."""


def read(run):
    return run.setup_s
