"""The port's data pipelines against the reference on the CPU: the graph
generators and the compressed CSR (``data/graph_data.py``), the LM token
stream and the compressed shuffle index (``data/lm_data.py``).

Every array must be equal (``np.array_equal``, dtypes too) for the same
seed; ``bits_per_edge`` equal to the reference's.  The one deliberate
difference: the codec's domain is values below 2**32, and row i's
neighbour v is coded as i * n_nodes + v, so from about 65,536 nodes on
the reference's stream wraps and its ``decompress`` returns wrong
neighbours, silently (pinned below at 70,000 nodes), where the port's
``compress`` raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

from repro.core import bitpack as RB
from repro.data import graph_data as RD
from repro.data import lm_data as RL
from repro_torch.core import bitpack as TB
from repro_torch.data import graph_data as TD
from repro_torch.data import lm_data as TL

pytestmark = pytest.mark.torch_port


def _equal_dicts(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n,deg,seed,d_feat,n_classes", [
    (1000, 6, 0, 16, 8), (2708, 4, 3, 1433, 7), (5000, 10, 0, 32, 8)])
def test_synthetic_graph_byte_equal(n, deg, seed, d_feat, n_classes):
    _equal_dicts(TD.synthetic_graph(n, deg, seed, d_feat, n_classes),
                 RD.synthetic_graph(n, deg, seed, d_feat, n_classes))


@pytest.mark.parametrize("g,n,e,d", [(8, 30, 64, 16), (128, 30, 64, 32)])
def test_molecule_batch_byte_equal(g, n, e, d):
    a = TD.molecule_batch(np.random.default_rng(7), g, n, e, d)
    b = RD.molecule_batch(np.random.default_rng(7), g, n, e, d)
    _equal_dicts(a, b)


@pytest.mark.parametrize("n,deg", [(5000, 10), (60000, 2)])
def test_compressed_csr_round_trip_and_bits(n, deg):
    g = TD.synthetic_graph(n, deg, seed=1)
    port = TD.CompressedCSR.compress(g["indptr"], g["indices"], n)
    ref = RD.CompressedCSR.compress(g["indptr"], g["indices"], n)
    got = port.decompress()
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), g["indices"])
    assert np.array_equal(got.numpy(), ref.decompress())
    assert port.bits_per_edge() == ref.bits_per_edge()
    assert np.array_equal(port.packed.flat_words.numpy().view(np.uint32),
                          np.asarray(ref.packed.flat_words).view(np.uint32))


def test_compressed_csr_refuses_past_the_codec_domain():
    """At 70,000 nodes the reference wraps (neighbours come back wrong);
    the port raises.  Unsorted rows are refused too."""
    g = TD.synthetic_graph(70000, 2, seed=1)
    ref = RD.CompressedCSR.compress(g["indptr"], g["indices"], 70000)
    assert not np.array_equal(ref.decompress(), g["indices"])
    with pytest.raises(ValueError, match="2\\*\\*32"):
        TD.CompressedCSR.compress(g["indptr"], g["indices"], 70000)
    with pytest.raises(ValueError, match="sorted"):
        TD.CompressedCSR.compress(np.array([0, 2, 2]), np.array([1, 0]), 2)


@pytest.mark.parametrize("vocab,seed", [(64, 0), (92544, 3)])
def test_token_stream_byte_equal(vocab, seed):
    a, b = TL.TokenStream(vocab, seed), RL.TokenStream(vocab, seed)
    for shape in ((4, 16), (2, 33)):
        _equal_dicts(a.batch(*shape), b.batch(*shape))


def test_shuffle_index_byte_equal():
    order, packed = TL.make_shuffle_index(5000, epoch=2, seed=1)
    r_order, r_packed = RL.make_shuffle_index(5000, epoch=2, seed=1)
    assert np.array_equal(order, r_order)
    assert np.array_equal(TB.decode_np(packed), RB.decode_np(r_packed))
    assert np.array_equal(TB.decode_np(packed), np.arange(5000))
    assert TB.bits_per_int(packed) == RB.bits_per_int(r_packed)
