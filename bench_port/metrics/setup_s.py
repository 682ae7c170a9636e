"""Seconds from the process's start to the window's: imports, the kernel
libraries loaded (built on a checkout's first run), the molecules made and
collated, the weights made, the trainer built and its first steps."""


def read(ctx):
    return ctx["setup_s"]
