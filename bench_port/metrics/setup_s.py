"""setup_s: process start to the window's start: the interpreter, torch and
the card's context, the port's import, the kernel library's load (its
build in a fresh checkout), the bank, the frame pool and the warm-up."""


def read(run):
    return run["setup_s"]
