"""setup.index_build_s: Index.build(..., sketch_device="cuda") in
set-up, from the FASTA read to the finished buckets (host clock, the
card synchronised)."""


def read(ctx):
    return ctx["index_build_s"]
