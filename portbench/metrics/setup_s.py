"""setup_s: seconds from the start of the process to the first timed
query: the corpus, the build, the kernels' first load (their nvcc build in
a checkout's first run), warming every shape of the traffic mix."""


def read(ctx):
    return ctx["setup_s"]
