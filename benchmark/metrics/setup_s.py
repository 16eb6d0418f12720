"""``setup_s``: seconds from the run's start (the interpreter's first
line of ``run.py``) to the window's start: importing torch and the
program, writing and loading the scene, building or loading the kernels,
packing the tables and warming up every shape the window runs.  On
several cards, to rank 0's window."""

LAYER = "end to end"
MOVES = "setup_s"


def read(run, ctx):
    return ctx["setup_s"]
