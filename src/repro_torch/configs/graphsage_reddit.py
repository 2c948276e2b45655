"""graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper].

Each shape cell carries its own graph: cora (full_graph_sm), reddit
(minibatch_lg; d_feat=602, 41 classes), ogbn-products (full-batch-large),
batched molecules.

Port of ``src/repro/configs/graphsage_reddit.py``."""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.gnn import GNNConfig

SPEC = register(ArchSpec(
    arch_id="graphsage-reddit",
    family="gnn",
    config=GNNConfig(
        name="graphsage-reddit", n_layers=2, d_hidden=128,
        aggregator="mean", sample_sizes=(25, 10), d_feat=602, n_classes=41),
    shapes={
        "full_graph_sm": {"kind": "full", "n_nodes": 2708, "n_edges": 10556,
                          "d_feat": 1433, "n_classes": 7},
        "minibatch_lg": {"kind": "minibatch", "n_nodes": 232965,
                         "n_edges": 114615892, "batch_nodes": 1024,
                         "fanout": (15, 10), "d_feat": 602, "n_classes": 41},
        "ogb_products": {"kind": "full", "n_nodes": 2449029,
                         "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
        "molecule": {"kind": "molecule", "n_nodes": 30, "n_edges": 64,
                     "batch": 128, "d_feat": 32, "n_classes": 1},
    },
    source="arXiv:1706.02216; paper",
))
