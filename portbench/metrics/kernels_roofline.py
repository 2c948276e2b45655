"""kernels_roofline: the least bytes the traced slice's queries need any
implementation to move (``roofline.LeastBytes``: each query's shortest
list per part at its information-theoretic size, read once, and 4 bytes an
answer id, written once), over the card's HBM bandwidth times the
device's busy seconds in the slice, in %.  It cannot pass 100 %: no
implementation moves fewer bytes.  None where the card is not in
``peaks.json`` or the trace saw no device time."""

from portbench import roofline


def read(ctx):
    t = ctx["trace"]
    bw = roofline.peak(ctx["device_kind"], "hbm_bytes_per_s")
    if t is None or bw is None or t["busy_s"] <= 0 or not ctx["slice_sent"]:
        return None
    corpus = ctx["corpus"]
    least = roofline.LeastBytes(corpus.postings, corpus.n_docs,
                                ctx["cfg"]["n_parts"])
    need = sum(least.query(q, ctx["truth"][q].size) for q in ctx["slice_sent"])
    return 100.0 * need / (bw * t["busy_s"])
