"""setup_s: process start to the window's start (host clock): torch and
the port imported, the inputs generated, the index built on the card,
the warm-up map."""


def read(ctx):
    return ctx["setup_s"]
