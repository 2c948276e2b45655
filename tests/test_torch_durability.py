"""The port's durable mutable index (``repro_torch.index.durability``)
against the reference's, case for case with tests/test_durability.py: WAL
framing and torn tails, atomic snapshots and pruning, the crash matrix
over every registered crash point, chained crashes and the damaged-manifest
fallback, each recovered index answering as the reference's rebuild from
scratch (``builder.build`` + ``engine.query``).  Added: the on-disk format
is the reference's (the same WAL bytes, manifests, tombstone files and
segment contents for the same operations), and a directory written by
either package recovers in the other to the same answers."""

import json
import os
import struct

import numpy as np
import pytest

from repro.index import builder as r_builder
from repro.index import durability as r_durability
from repro.index import engine as r_engine
from repro.index import segments as r_segments
from repro.launch import faults as r_faults
from repro_torch.index import durability, segments
from repro_torch.launch import faults

pytestmark = [pytest.mark.torch_port, pytest.mark.segments,
              pytest.mark.faults]

V = 8
CODEC = "bp-d1"
B = 16
PROBES = [[t] for t in range(0, V, 2)] + [[0, 1], [2, 3], [1, 4, 5]]


def _base_model(n_docs=40, seed=3):
    rng = np.random.default_rng(seed)
    model = {d: set(map(int, rng.choice(V, size=2, replace=False)))
             for d in range(n_docs)}
    post = [np.asarray(sorted(d for d, ts in model.items() if t in ts),
                       dtype=np.int64) for t in range(V)]
    return model, post


def _boot(directory, injector=None, n_docs=40, pkg="port"):
    model, post = _base_model(n_docs)
    if pkg == "port":
        log = durability.DurableLog(directory, injector=injector)
        mi = segments.MutableIndex.from_postings(
            post, n_docs, codec_name=CODEC, B=B, n_parts=2, wal=log,
            device="cpu")
    else:
        log = r_durability.DurableLog(directory, injector=injector)
        mi = r_segments.MutableIndex.from_postings(
            post, n_docs, codec_name=CODEC, B=B, n_parts=2, wal=log)
    return mi, model


def _answers(mi, fuse=True):
    kw = {} if isinstance(mi, segments.MutableIndex) else {"backend": "jax"}
    return mi.execute_batch([list(q) for q in PROBES], fuse=fuse, **kw)


def _same(a, b):
    for g, w in zip(a, b):
        assert g.count == w.count
        assert np.array_equal(g.docs, w.docs)


def _assert_matches_model(mi, model, *, fuse=True):
    """The recovered index answers as the reference's rebuild of the
    model."""
    idx = r_builder.build(
        [np.asarray(sorted(d for d, ts in model.items() if t in ts),
                    dtype=np.int64) for t in range(V)],
        max(mi.next_doc_id, 1), codec_name=CODEC, B=B, n_parts=2)
    _same(_answers(mi, fuse), [r_engine.query(idx, list(q)) for q in PROBES])


def _drive(mi, model, injector=None, n=24):
    """tests/test_durability.py's scripted add/seal/delete/merge stream;
    the model records only acknowledged ops."""
    rng = np.random.default_rng(11)
    for i in range(n):
        terms = sorted(map(int, rng.choice(V, size=2, replace=False)))
        d = mi.add(terms)
        model[d] = set(terms)
        if i % 8 == 5:
            live = sorted(model)
            victim = live[i % len(live)]
            mi.delete(victim)
            del model[victim]
        if i % 7 == 6:
            mi.seal()
    hook = injector.merge_hook() if injector is not None else None
    mi.merge(hook=hook)


def _recover(directory, **kw):
    return segments.MutableIndex.recover(directory, device="cpu", **kw)


# --------------------------------------------------------------------------
# WAL framing
# --------------------------------------------------------------------------

RECS = [("add", {"terms": [1, 2]}), ("delete", {"doc": 7}),
        ("seal", {}), ("add", {"terms": [0]})]


def test_wal_append_read_roundtrip(tmp_path):
    paths = []
    for mod, sub in ((durability, "port"), (r_durability, "ref")):
        log = mod.DurableLog(str(tmp_path / sub))
        log.start_fresh()
        log._attach(0)
        for rtype, payload in RECS:
            log.append(rtype, payload)
        log.close()
        paths.append(log.wal_path(0))
    got, good, torn = durability.read_wal(paths[0])
    assert not torn and good == os.path.getsize(paths[0])
    assert got == RECS
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()              # the reference's bytes
    assert r_durability.read_wal(paths[0]) == durability.read_wal(paths[1])


@pytest.mark.parametrize("damage", ["short_header", "short_payload",
                                    "bad_magic", "bad_crc", "garbage"])
def test_wal_torn_tail_truncates_not_propagates(tmp_path, damage):
    log = durability.DurableLog(str(tmp_path))
    log.start_fresh()
    log._attach(0)
    recs = [("add", {"terms": [i]}) for i in range(5)]
    for rtype, payload in recs:
        log.append(rtype, payload)
    log.close()
    path = log.wal_path(0)
    clean = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        if damage == "short_header":
            f.write(b"WA\x01")
        elif damage == "short_payload":
            f.write(struct.pack("<2sBII", b"WA", 1, 100, 0) + b"{}")
        elif damage == "bad_magic":
            f.write(b"XX" + b"\x00" * 20)
        elif damage == "bad_crc":
            body = json.dumps({"terms": [9]}).encode()
            f.write(struct.pack("<2sBII", b"WA", 1, len(body), 12345) + body)
        else:
            f.write(np.random.default_rng(0).bytes(17))
    got, good, torn = durability.read_wal(path)
    assert torn and good == clean
    assert got == recs
    assert r_durability.read_wal(path) == (got, good, torn)


def test_start_fresh_refuses_nonempty_directory(tmp_path):
    log = durability.DurableLog(str(tmp_path))
    log.start_fresh()
    log.checkpoint({"config": {}, "segments": [], "mseg_base": 0,
                    "mseg_n_docs": 0, "mseg_postings": {}, "dead_ids": [],
                    "next_doc_id": 0, "vocab": 0, "counters": {}})
    log.close()
    with pytest.raises(durability.WalError):
        durability.DurableLog(str(tmp_path)).start_fresh()
    with pytest.raises(r_durability.WalError):   # the reference reads it too
        r_durability.DurableLog(str(tmp_path)).start_fresh()


# --------------------------------------------------------------------------
# snapshots: pruning + recovery on clean shutdown
# --------------------------------------------------------------------------

def test_clean_recover_is_byte_identical(tmp_path):
    mi, model = _boot(str(tmp_path))
    _drive(mi, model)
    rec = _recover(str(tmp_path))
    _assert_matches_model(rec, model)
    _same(_answers(mi), _answers(rec))
    c, rc = mi.counters(), rec.counters()
    for k in ("next_doc_id", "tombstones", "vocab", "n_seals", "n_merges"):
        assert rc[k] == c[k]


def test_recover_twice_is_idempotent(tmp_path):
    mi, model = _boot(str(tmp_path))
    _drive(mi, model, n=12)
    r1 = _recover(str(tmp_path))
    r2 = _recover(str(tmp_path))
    _same(_answers(r1), _answers(r2))
    assert r1.counters()["next_doc_id"] == r2.counters()["next_doc_id"]


def test_prune_keeps_bounded_epochs_and_referenced_segments(tmp_path):
    mi, model = _boot(str(tmp_path))
    for r in range(5):
        d = mi.add([r % V])
        model[d] = {r % V}
        mi.seal()
    seqs = durability.manifest_seqs(str(tmp_path))
    assert len(seqs) == 2
    man = durability._load_manifest(str(tmp_path), max(seqs))
    for entry in man["segments"]:
        assert os.path.exists(os.path.join(str(tmp_path), "segments",
                                           entry["file"]))
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".tmp")]
    _assert_matches_model(_recover(str(tmp_path)), model)


# --------------------------------------------------------------------------
# the crash matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("point", faults.CRASH_POINTS)
def test_crash_recover_differential(tmp_path, point):
    inj = faults.FaultInjector(seed=1)
    mi, model = _boot(str(tmp_path), injector=inj)
    inj.arm("crash", point, 1)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    assert inj.fired
    inj.disarm_all()
    _assert_matches_model(_recover(str(tmp_path)), model)


@pytest.mark.parametrize("point", faults.TEAR_POINTS)
def test_torn_record_recover_differential(tmp_path, point):
    inj = faults.FaultInjector(seed=2)
    mi, model = _boot(str(tmp_path), injector=inj)
    inj.arm("torn", point, 1)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    inj.disarm_all()
    wal = max(f for f in os.listdir(str(tmp_path)) if f.startswith("wal-"))
    _, good, torn = durability.read_wal(os.path.join(str(tmp_path), wal))
    assert torn
    _assert_matches_model(_recover(str(tmp_path)), model)


@pytest.mark.parametrize("fuse", [False, True])
def test_crash_recover_differential_backends(tmp_path, fuse):
    """The recovered state answers alike fused and unfused (the port's one
    backend; the reference's case also crosses jax × pallas)."""
    inj = faults.FaultInjector(seed=3)
    mi, model = _boot(str(tmp_path), injector=inj)
    inj.arm("crash", "wal.append.add", 3)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    inj.disarm_all()
    _assert_matches_model(_recover(str(tmp_path)), model, fuse=fuse)


def test_crash_recover_crash_chain(tmp_path):
    inj = faults.FaultInjector(seed=4)
    mi, model = _boot(str(tmp_path), injector=inj)
    inj.arm("crash", "wal.append.add", 4)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    inj.disarm_all()
    mi = _recover(str(tmp_path), injector=inj)
    inj.arm("crash", "snapshot.rename", 1)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    inj.disarm_all()
    rec = _recover(str(tmp_path))
    _assert_matches_model(rec, model)
    assert rec._wal_replayed >= 0


def test_damaged_manifest_falls_back_to_previous_epoch(tmp_path):
    mi, model = _boot(str(tmp_path))
    _drive(mi, model, n=16)
    seqs = durability.manifest_seqs(str(tmp_path))
    assert len(seqs) >= 2
    newest = os.path.join(str(tmp_path), f"manifest-{max(seqs)}.json")
    with open(newest, "w") as f:
        f.write("{ not json")
    _assert_matches_model(_recover(str(tmp_path)), model)


def test_recovered_index_keeps_serving_and_checkpointing(tmp_path):
    inj = faults.FaultInjector(seed=5)
    mi, model = _boot(str(tmp_path), injector=inj)
    inj.arm("crash", "merge.swap", 1)
    with pytest.raises(faults.InjectedCrash):
        _drive(mi, model, injector=inj)
    inj.disarm_all()
    mi = _recover(str(tmp_path))
    _drive(mi, model, n=10)
    _assert_matches_model(mi, model)
    _assert_matches_model(_recover(str(tmp_path)), model)


# --------------------------------------------------------------------------
# the on-disk format, and recovery across the two packages
# --------------------------------------------------------------------------

def _contents(directory: str) -> dict:
    """Every file of a durable directory by relative path: raw bytes for
    the WAL, manifests and tombstone files; the arrays of an .npz."""
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, directory)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k].tolist() for k in sorted(z.files)}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_directory_format_matches_reference(tmp_path):
    """The same operations write the same directory in both packages: the
    same file names, WAL and manifest bytes, tombstone files and segment
    and mutable-segment contents."""
    for pkg in ("port", "ref"):
        mi, model = _boot(str(tmp_path / pkg), pkg=pkg)
        _drive(mi, model)
        mi.add([1, 3])
        mi.delete(2)
        mi._wal.close()
    assert _contents(str(tmp_path / "port")) == _contents(str(tmp_path / "ref"))


@pytest.mark.parametrize("point", [None, "wal.append.add", "merge.swap",
                                   "snapshot.rename"])
def test_cross_package_recovery(tmp_path, point):
    """A WAL + snapshot directory written by the reference recovers in the
    port, and one written by the port recovers in the reference, each to
    answers equal to the other package's recovery and to the rebuild —
    after a clean stop or an injected crash."""
    models = {}
    for pkg, mod in (("ref", r_faults), ("port", faults)):
        inj = mod.FaultInjector(seed=1)
        mi, model = _boot(str(tmp_path / pkg), injector=inj, pkg=pkg)
        if point is None:
            _drive(mi, model, injector=inj)
            mi._wal.close()
        else:
            inj.arm("crash", point, 1)
            with pytest.raises(mod.InjectedCrash):
                _drive(mi, model, injector=inj)
        models[pkg] = model
    assert models["ref"] == models["port"]
    model = models["ref"]
    # reference → port, and port → reference
    port_of_ref = _recover(str(tmp_path / "ref"))
    ref_of_port = r_segments.MutableIndex.recover(str(tmp_path / "port"))
    _assert_matches_model(port_of_ref, model)
    _assert_matches_model(ref_of_port, model)
    _same(_answers(port_of_ref), _answers(ref_of_port))
    assert port_of_ref.counters() == ref_of_port.counters()
    assert port_of_ref._wal_replayed == ref_of_port._wal_replayed
