"""Durable lifecycle for the mutable segmented index.

Port of ``src/repro/index/durability.py``, line for line.  The on-disk
format is the reference's byte for byte: the WAL framing (``struct``
header, ``zlib`` CRC-32, compact JSON body), ``segments/seg-*.npz``,
``mseg-*.npz``, ``dead-*.npy`` and the JSON manifests with the same key
names, so a directory written by either package recovers in the other to
the same answers.  ``recover`` takes the port's ``device`` (None = the CUDA
card); the device is not part of the durable configuration.

``MutableIndex`` (segments.py) keeps every un-sealed add, every tombstone
and the whole segment composition in process memory — a crash loses all
of it.  This module gives the index a crash-safe on-disk lifecycle built
from two primitives, both chosen so that *no* crash instant can leave the
directory unrecoverable:

write-ahead log
    Every mutation (``add``/``delete``/``seal``) is appended to
    ``wal-<seq>.log`` *before* it is applied in memory.  Records are
    CRC-framed: an 11-byte header (magic ``WA``, record type, payload
    length, CRC-32 of the payload) followed by a compact-JSON payload.
    Replay stops at the first frame that is short, mis-magicked or fails
    its CRC — a torn trailing record is physically truncated on recovery
    and never propagated.  Because the append happens before the apply,
    a crash during the append itself loses only the mutation that was
    *in flight* (which the caller never saw complete), never one it did.

atomic snapshots
    ``checkpoint`` persists the full serving state using the
    tmp-then-rename + manifest-last discipline proven in
    ``src/repro/checkpoint/manager.py``: segment payload files, the mutable-segment
    image and the tombstone list are each written to a ``.tmp`` path and
    renamed before the manifest that references them is itself
    tmp-written and renamed.  The manifest rename is the commit point —
    before it the old manifest is intact, after it every referenced file
    already exists.  Sealed segments are persisted *once*, at creation
    (seal / bootstrap / merge), as their raw per-term local postings;
    ``builder.build`` is deterministic, so rebuilding a segment from its
    postings file yields byte-identical serving behaviour.

Checkpoints rotate the WAL: manifest ``seq`` names its WAL file, so a
recovered state is exactly (newest readable manifest) + (replay of every
WAL with ``seq >= manifest.seq``, in order) — the same replay order a
single-file log would have, but with the already-snapshotted prefix
skipped by construction.  ``recover`` falls back to the previous manifest
if the newest is damaged, exactly like ``CheckpointManager.restore``.

Every failure seam here is instrumented with ``launch.faults`` injection
points (``wal.append.*``, ``snapshot.write``, ``snapshot.rename``) so the
fault-matrix tests can crash at each one and assert the recovery
differential.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib

import numpy as np

from repro_torch.launch import faults as faults_lib


_MAGIC = b"WA"
_HDR = struct.Struct("<2sBII")          # magic, rtype, length, crc32
_MAX_RECORD = 1 << 24                   # frame-length sanity bound

_REC_TYPES = {"add": 1, "delete": 2, "seal": 3}
_REC_NAMES = {v: k for k, v in _REC_TYPES.items()}


class WalError(RuntimeError):
    """Misuse of the durable log (not a recoverable on-disk condition)."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes, sync: bool) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        if sync:
            fh.flush()
            os.fsync(fh.fileno())
    os.rename(tmp, path)


def read_wal(path: str) -> tuple[list[tuple[str, dict]], int, bool]:
    """Parse one WAL file.  Returns ``(records, good_bytes, torn)`` where
    ``good_bytes`` is the offset of the first byte past the last complete
    valid record and ``torn`` says whether trailing bytes past it exist
    (short frame, bad magic, bad CRC, or unparseable payload — all are
    truncation cases, never errors: a crash mid-append is expected)."""
    records: list[tuple[str, dict]] = []
    good = 0
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return records, good, good < size
            try:
                magic, rtype, length, crc = _HDR.unpack(hdr)
            except struct.error:
                return records, good, True
            if (magic != _MAGIC or rtype not in _REC_NAMES
                    or length > _MAX_RECORD):
                return records, good, True
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return records, good, True
            try:
                obj = json.loads(payload.decode())
            except (UnicodeDecodeError, json.JSONDecodeError):
                return records, good, True
            records.append((_REC_NAMES[rtype], obj))
            good += _HDR.size + length


class DurableLog:
    """One durable directory: ``wal-<seq>.log`` + ``manifest-<seq>.json``
    epochs plus a content-addressed-ish ``segments/`` store of raw
    per-term postings written once per sealed segment.

    A fresh index calls ``start_fresh`` (refusing a non-empty directory —
    that state belongs to ``MutableIndex.recover``); recovery re-attaches
    with ``_attach`` after replay.  ``sync=True`` adds fsync barriers for
    real kill-9 durability; tests drive crashes through the injector
    instead, so the default stays fast.
    """

    def __init__(self, directory: str, *, sync: bool = False,
                 injector: "faults_lib.FaultInjector | None" = None,
                 keep: int = 2):
        self.dir = directory
        self.segdir = os.path.join(directory, "segments")
        self.sync = sync
        self.injector = injector
        self.keep = max(keep, 1)
        self.seq = -1
        self._wal_f = None
        self._seg_counter: int | None = None
        self._pinned: set[str] = set()     # persisted but not yet in a manifest
        self._lock = threading.Lock()
        os.makedirs(self.segdir, exist_ok=True)

    # -- lifecycle ---------------------------------------------------------

    def start_fresh(self) -> None:
        if manifest_seqs(self.dir):
            raise WalError(
                f"{self.dir} already holds a durable index — "
                f"use MutableIndex.recover() instead of a fresh attach")
        self.seq = -1

    def _attach(self, seq: int) -> None:
        """Continue an existing directory at epoch ``seq`` (recovery path:
        the caller has already replayed and truncated the WAL tail)."""
        self.seq = seq
        self._open_wal(seq)

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None

    def _fire(self, point: str):
        if self.injector is not None:
            return self.injector.fire(point)
        return None

    def _open_wal(self, seq: int) -> None:
        if self._wal_f is not None:
            self._wal_f.close()
        self._wal_f = open(self.wal_path(seq), "ab")

    def wal_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal-{seq:08d}.log")

    def manifest_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"manifest-{seq:08d}.json")

    # -- the write-ahead log ----------------------------------------------

    def append(self, rtype: str, payload: dict) -> None:
        """Frame and append one record.  MUST be called before the
        mutation is applied in memory — that ordering is the entire
        durability argument for the un-sealed tail."""
        with self._lock:
            if self._wal_f is None:
                raise WalError("durable log has no open WAL epoch")
            body = json.dumps(payload, separators=(",", ":")).encode()
            frame = _HDR.pack(_MAGIC, _REC_TYPES[rtype], len(body),
                              zlib.crc32(body)) + body
            action = self._fire(f"wal.append.{rtype}")
            if action == "torn":
                # simulated mid-append power cut: a partial frame lands
                # on disk, then the "process" dies.  Recovery must
                # truncate this tail, never replay it.
                self._wal_f.write(frame[: len(frame)
                                        - max(1, len(frame) // 3)])
                self._wal_f.flush()
                raise faults_lib.InjectedCrash(
                    f"torn record at wal.append.{rtype}")
            self._wal_f.write(frame)
            self._wal_f.flush()
            if self.sync:
                os.fsync(self._wal_f.fileno())

    # -- segment store -----------------------------------------------------

    def _next_seg_number(self) -> int:
        if self._seg_counter is None:
            mx = -1
            for name in os.listdir(self.segdir):
                if name.startswith("seg-") and name.endswith(".npz"):
                    try:
                        mx = max(mx, int(name[4:-4]))
                    except ValueError:
                        pass
            self._seg_counter = mx + 1
        n = self._seg_counter
        self._seg_counter += 1
        return n

    def persist_segment(self, seg, postings) -> str:
        """Write one sealed segment's raw per-term local postings (written
        exactly once, at segment creation, while the postings are in
        hand).  Pinned against pruning until a manifest references it."""
        with self._lock:
            if seg.file is not None:
                return seg.file
            name = f"seg-{self._next_seg_number():08d}.npz"
            path = os.path.join(self.segdir, name)
            tmp = path + ".tmp"
            arrs = {f"t{t}": np.asarray(p, dtype=np.int64)
                    for t, p in enumerate(postings)}
            with open(tmp, "wb") as fh:
                np.savez_compressed(
                    fh, _meta=np.asarray([seg.doc_base, seg.doc_hi],
                                         dtype=np.int64), **arrs)
                if self.sync:
                    fh.flush()
                    os.fsync(fh.fileno())
            os.rename(tmp, path)
            seg.file = name
            self._pinned.add(name)
            return name

    @staticmethod
    def load_segment_postings(path: str) -> list[np.ndarray]:
        with np.load(path) as z:
            n_terms = sum(1 for k in z.files if k != "_meta")
            return [np.asarray(z[f"t{t}"], dtype=np.int64)
                    for t in range(n_terms)]

    # -- atomic snapshots --------------------------------------------------

    def checkpoint(self, state: dict) -> int:
        """Commit one full-state snapshot and open a fresh WAL epoch.

        ``state`` carries: ``config`` (MutableIndex constructor args),
        ``segments`` (base/hi/file entries, every file already persisted),
        ``mseg_base``/``mseg_n_docs``/``mseg_postings`` (the un-sealed
        write buffer — snapshotting it is what lets rotation discard the
        old WAL without losing post-seal adds), ``dead_ids``,
        ``next_doc_id``, ``vocab``, ``counters``.

        Write order is the atomicity argument: mutable-segment image,
        tombstone list, then the manifest (tmp-then-rename each).  The
        manifest rename is the commit point; a crash anywhere before it
        leaves the previous manifest authoritative and every new file an
        ignorable orphan."""
        with self._lock:
            self._fire("snapshot.write")
            seq = self.seq + 1

            mseg_name = f"mseg-{seq:08d}.npz"
            buf_path = os.path.join(self.dir, mseg_name)
            tmp = buf_path + ".tmp"
            arrs = {f"t{t}": np.asarray(lst, dtype=np.int64)
                    for t, lst in state["mseg_postings"].items()}
            with open(tmp, "wb") as fh:
                np.savez_compressed(
                    fh, _meta=np.asarray([state["mseg_base"],
                                          state["mseg_n_docs"]],
                                         dtype=np.int64), **arrs)
                if self.sync:
                    fh.flush()
                    os.fsync(fh.fileno())
            os.rename(tmp, buf_path)

            dead_name = f"dead-{seq:08d}.npy"
            buf = __import__("io").BytesIO()
            np.save(buf, np.asarray(state["dead_ids"], dtype=np.int64))
            _atomic_write(os.path.join(self.dir, dead_name),
                          buf.getvalue(), self.sync)

            manifest = {
                "seq": seq,
                "wal": f"wal-{seq:08d}.log",
                "config": state["config"],
                "segments": state["segments"],
                "mseg": {"base": int(state["mseg_base"]),
                         "n_docs": int(state["mseg_n_docs"]),
                         "file": mseg_name},
                "dead": dead_name,
                "next_doc_id": int(state["next_doc_id"]),
                "vocab": int(state["vocab"]),
                "counters": {k: int(v)
                             for k, v in state["counters"].items()},
            }
            final = self.manifest_path(seq)
            tmp = final + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh)
                if self.sync:
                    fh.flush()
                    os.fsync(fh.fileno())
            self._fire("snapshot.rename")
            os.rename(tmp, final)              # the commit point
            if self.sync:
                _fsync_dir(self.dir)

            self.seq = seq
            self._open_wal(seq)
            for ent in state["segments"]:
                self._pinned.discard(ent["file"])
            self._prune()
            return seq

    def _prune(self) -> None:
        seqs = manifest_seqs(self.dir)
        kept = set(seqs[-self.keep:])
        referenced: set[str] = set()
        seg_referenced: set[str] = set(self._pinned)
        for s in kept:
            try:
                with open(self.manifest_path(s)) as fh:
                    man = json.load(fh)
            except Exception:
                continue
            referenced.update((man["wal"], man["mseg"]["file"],
                               man["dead"], f"manifest-{s:08d}.json"))
            seg_referenced.update(e["file"] for e in man["segments"])
        referenced.add(f"wal-{self.seq:08d}.log")
        for name in os.listdir(self.dir):
            if name.endswith(".tmp") or (
                    name.startswith(("manifest-", "wal-", "mseg-", "dead-"))
                    and name not in referenced):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        for name in os.listdir(self.segdir):
            if name.endswith(".tmp") or (name.startswith("seg-")
                                         and name not in seg_referenced):
                try:
                    os.remove(os.path.join(self.segdir, name))
                except OSError:
                    pass


# --------------------------------------------------------------------------
# recovery
# --------------------------------------------------------------------------

def manifest_seqs(directory: str) -> list[int]:
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith("manifest-") and name.endswith(".json"):
                try:
                    out.append(int(name[9:-5]))
                except ValueError:
                    pass
    return sorted(out)


def _wal_seqs(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                out.append(int(name[4:-4]))
            except ValueError:
                pass
    return sorted(out)


def _load_manifest(directory: str, seq: int) -> dict:
    """Load and *validate* one manifest: every referenced file must exist
    (the manifest-last discipline makes that true for any renamed
    manifest, so a failure here means damage — fall back to the previous
    epoch, like ``CheckpointManager.restore``)."""
    with open(os.path.join(directory, f"manifest-{seq:08d}.json")) as fh:
        man = json.load(fh)
    for ent in man["segments"]:
        p = os.path.join(directory, "segments", ent["file"])
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    for name in (man["mseg"]["file"], man["dead"]):
        p = os.path.join(directory, name)
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    return man


def recover(directory: str, *, plan=None,
            injector: "faults_lib.FaultInjector | None" = None,
            sync: bool = False, keep: int = 2, device=None):
    """Rebuild a ``MutableIndex`` from a durable directory to a state
    byte-identical to the pre-crash index.

    Replay order: newest readable manifest → rebuild every sealed segment
    from its persisted raw postings (``builder.build`` is deterministic,
    so the rebuilt payloads serve identically) → restore the
    mutable-segment image, tombstones and counters → replay every WAL
    epoch with ``seq >= manifest.seq`` in order through the normal
    ``add``/``delete``/``seal`` paths (appends suppressed), truncating a
    torn tail → commit a fresh checkpoint so the next epoch starts from
    a compact snapshot.  ``device`` places the recovered segments and
    pools."""
    from repro_torch.index import segments as seg_lib

    seqs = manifest_seqs(directory)
    if not seqs:
        raise FileNotFoundError(f"no manifest in {directory}")
    man = None
    last_err: Exception | None = None
    for s in reversed(seqs):
        try:
            man = _load_manifest(directory, s)
            chosen = s
            break
        except Exception as e:             # damaged → previous epoch
            last_err = e
    if man is None:
        raise FileNotFoundError(
            f"no readable manifest in {directory}: {last_err}")

    cfg = dict(man["config"])
    mi = seg_lib.MutableIndex(plan=plan, device=device, **cfg)
    with mi._lock:
        segs = []
        for ent in man["segments"]:
            postings = DurableLog.load_segment_postings(
                os.path.join(directory, "segments", ent["file"]))
            seg = mi._build_segment(int(ent["base"]),
                                    int(ent["hi"]) - int(ent["base"]),
                                    postings)
            seg.file = ent["file"]
            segs.append(seg)

        mseg = seg_lib.MutableSegment(int(man["mseg"]["base"]))
        with np.load(os.path.join(directory, man["mseg"]["file"])) as z:
            for k in z.files:
                if k == "_meta":
                    continue
                a = z[k]
                if a.size:
                    mseg.postings[int(k[1:])] = [int(x) for x in a]
        mseg.n_docs = int(man["mseg"]["n_docs"])

        mi._vocab = int(man["vocab"])
        mi._next_id = int(man["next_doc_id"])
        mi._ensure_dead(mi._next_id + 1)
        dead = np.load(os.path.join(directory, man["dead"]))
        if dead.size:
            mi._dead[dead] = True
        mi._n_dead = int(dead.size)
        mi.n_seals = int(man["counters"]["n_seals"])
        mi.n_merges = int(man["counters"]["n_merges"])

        gen = mi._new_generation(segs, carry=None)
        mi._state = (gen, mseg)
        mi._gen_counter = max(mi._gen_counter,
                              int(man["counters"]["gen_counter"]))

    log = DurableLog(directory, sync=sync, injector=injector, keep=keep)
    mi._wal = log
    mi._wal_replaying = True
    n_replayed = 0
    try:
        for w in _wal_seqs(directory):
            if w < chosen:
                continue
            path = log.wal_path(w)
            records, good, torn = read_wal(path)
            if torn:
                with open(path, "r+b") as fh:   # truncate, never replay
                    fh.truncate(good)
            for rtype, payload in records:
                if rtype == "add":
                    mi.add(payload["terms"])
                elif rtype == "delete":
                    mi.delete(int(payload["doc"]))
                elif rtype == "seal":
                    mi.seal()
                n_replayed += 1
    finally:
        mi._wal_replaying = False

    all_seqs = set(manifest_seqs(directory)) | set(_wal_seqs(directory))
    log._attach(max(all_seqs))
    mi._wal_checkpoint()
    mi._wal_replayed = n_replayed
    return mi
