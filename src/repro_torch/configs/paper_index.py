"""The storage autotuner's default cost table (``index.builder.CostModel``).

A copy of ``DEFAULT_COST_TABLE`` in ``src/repro/configs/paper_index.py``.
Those numbers were measured by the reference's ``benchmarks/bench_decode.py``
on its CPU container with the Pallas kernels in interpret mode: they are not
a measurement of any accelerator, and not of the card this port runs on.
The port keeps them so that ``codec_name="auto"`` makes exactly the
reference's choice for every list.  A table measured on the card would
replace them through ``build(..., cost_table=...)``.

It also registers the paper's own "architecture", ``paper-index``, as the
reference's module does.
"""

from repro_torch.configs.base import ArchSpec, register

SPEC = register(ArchSpec(
    arch_id="paper-index",
    family="index",
    config={"codec": "bp-d1", "B": 16, "n_docs": 1 << 22},
    shapes={
        "svs_batch": {"kind": "svs", "n_queries": 4096, "m": 4096,
                      "n": 1 << 20},
        "decode_bulk": {"kind": "decode_lists", "n_blocks": 8192},
    },
    source="Lemire, Boytsov, Kurz 2014 (this paper)",
))

DEFAULT_COST_TABLE = {
    "decode_ns_per_int": {
        "bp-d1": 13.4,
        "bp8-d1": 13.4,
        "fastpfor-d1": 15.3,
        "streamvbyte-d1": 20.9,
        "composite-d1": 19.7,
        "varint": 562.4,
    },
    # fixed per-decode overhead (ns/list); composite is derived from its
    # bp8-head + varint-tail parts (builder._decode_cost)
    "dispatch_ns_per_list": {
        "bp-d1": 245700.0,
        "bp8-d1": 215100.0,
        "fastpfor-d1": 253900.0,
        "streamvbyte-d1": 375600.0,
        "varint": 6100.0,
    },
    "gallop_ns_per_probe": 18.9,
    # ns per stored byte: the knob trading storage against decode speed
    "space_ns_per_byte": 2.0,
}
