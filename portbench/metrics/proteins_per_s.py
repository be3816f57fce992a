"""proteins_per_s: every protein of every map that finished in the
window, over the time from the window's start to the end of the last
map (host clock)."""


def read(ctx):
    return ctx["proteins"] / ctx["window_s"]
