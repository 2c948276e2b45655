"""index.bytes_per_posting: the bytes the built index holds on the card
over the postings the benchmark generated.  The bytes are the CUDA
allocator's count in the program's process before and after the build
(payloads, bitmaps and the decode layouts it stages; ``builds/hybrid.py``),
a counter and not a clock or a trace; the program's own count of its
payloads is in the result's ``notes`` beside it."""


def read(ctx):
    b = ctx["built"].get("index_bytes")
    return b / ctx["corpus"].n_postings if b else None
