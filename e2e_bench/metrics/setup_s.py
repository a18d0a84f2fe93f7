"""Seconds from the process's start to the window's start."""


def read(run):
    return run.setup_s
