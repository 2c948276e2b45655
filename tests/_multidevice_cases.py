"""Cases shared by the reference's 8-host-device run and the port's 8 gloo
processes in tests/test_torch_multidevice.py (numpy only: both sides
import it).

Every input is drawn here from a seed, so each side makes the same
arrays without waiting for the other.
"""

from __future__ import annotations

import numpy as np

# the expert-parallel MoE: tests/test_multidevice.py's case (cf 8.0), the
# same layer at cf 1.0 and 0.5 (at least 10 % of slots dropped), and E 16,
# top-4 on a 1×8 mesh
MOE_CASES = {
    "2x4-cf8": dict(mesh=(2, 4), B=4, S=8, d=32, ff=64, E=8, k=2, cf=8.0,
                    seed=0),
    "2x4-cf1": dict(mesh=(2, 4), B=4, S=32, d=32, ff=64, E=8, k=2, cf=1.0,
                    seed=1),
    "2x4-cf0.5": dict(mesh=(2, 4), B=4, S=32, d=32, ff=64, E=8, k=2,
                      cf=0.5, seed=2),
    "1x8-e16": dict(mesh=(1, 8), B=2, S=16, d=32, ff=64, E=16, k=4, cf=1.25,
                    seed=3),
}
DROPPING = ("2x4-cf1", "2x4-cf0.5")
GRAD_LEAVES = ("x", "router", "w_in", "w_gate", "w_out")

# the trees whose blocks are placed on the gloo 2×4 mesh: (name, arch,
# rule, preset), at the smoke widths
PLACED = (("granite-tp", "granite-moe-1b-a400m", "lm", "tp"),
          ("granite-fsdp", "granite-moe-1b-a400m", "lm", "fsdp"),
          ("internlm2-fsdp", "internlm2-1.8b", "lm", "fsdp"),
          ("sasrec", "sasrec", "recsys", None),
          ("din", "din", "recsys", None),
          ("graphsage", "graphsage-reddit", "gnn", None))

# the reference LM's stacked layer leaves, by the port's leaf name
_LM_GROUP = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
             "w_in": "mlp", "w_gate": "mlp", "w_out": "mlp"}


def moe_inputs(case: dict) -> dict:
    """float32 arrays: the router, the expert stacks, x and the weights w
    of the loss sum(out · w)."""
    rng = np.random.default_rng(case["seed"])
    d, ff, E = case["d"], case["ff"], case["E"]

    def normal(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"router": normal((d, E), d ** -0.5),
            "w_in": normal((E, d, ff), d ** -0.5),
            "w_gate": normal((E, d, ff), d ** -0.5),
            "w_out": normal((E, ff, d), ff ** -0.5),
            "x": normal((case["B"], case["S"], d)),
            "w": normal((case["B"], case["S"], d))}


def ref_path(port_path: str, rule: str) -> tuple[str, bool]:
    """The reference leaf of a port leaf, and whether it is stacked on a
    leading layer axis: for an LM ('lm' rule) 'layers/3/moe/w_in' →
    ('layers/moe/w_in', True); a recsys or GNN path is the same in both
    packages."""
    parts = port_path.split("/")
    if rule != "lm" or parts[0] != "layers":
        return port_path, False
    rest = parts[2:]
    if rest[0] == "moe":
        return "/".join(["layers", *rest]), True
    name = rest[0]
    group = _LM_GROUP.get(name)
    return "/".join(["layers", group, name] if group else ["layers", name]), \
        True


def fill(shape) -> np.ndarray:
    """A placed leaf's whole value: its flat index, as float32 (exact)."""
    n = int(np.prod(shape))
    return (np.arange(n) % (1 << 24)).astype(np.float32).reshape(shape)
