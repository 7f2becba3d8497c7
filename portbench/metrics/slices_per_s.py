"""Slices completed in the window over the window's seconds."""


def read(run):
    return run.slices / run.window.seconds if run.window.seconds > 0 \
        else None
