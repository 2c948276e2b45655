"""Shared recsys shape set (each of the 4 recsys archs × these 4 cells).

Port of ``src/repro/configs/recsys_shapes.py``."""

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "score", "batch": 512},
    "serve_bulk": {"kind": "score", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1048576, "top_k": 100},
}
