"""Incremental index mutation: upsert/delete deltas, tombstones, atomic
generations and compaction, byte for byte the JAX package's
`repro.index.update` on the formats both write soundly.

A delta touches only the affected shards:

  * upserts go to their nearest *existing* centroid with free capacity
    (the greedy next-nearest spill of `build_cluster_table`); only shards
    whose membership changed are re-packed (v1) or re-encoded against the
    existing PQ codebooks (v2, `pq_encode` on the device). Existing docs'
    vectors or codes are read back from the previous generation's shard
    files;
  * deletes set a per-slot **tombstone bitmap**, so a delete rewrites no
    shard bytes;
  * postings rows holding dropped docs (and rows gaining upserted terms)
    are re-sorted in impact order with `SparseIndex.build`'s comparator;
  * when a shard's upserts overflow their nearest clusters past a
    threshold, the shard is **re-clustered locally** by
    `core.kmeans.lloyd_refine` (host numpy) from its current centroids,
    and the neighbor graph is recomputed (`neighbor_graph`, the topk
    kernel on the card).

Commits are **atomic generations** (`write_index_delta`): new files are
staged under `<index_dir>/.stage-g<G>` with generation-suffixed names,
moved into place, the current manifest is archived to
`manifests/manifest.g<g>.json`, and the new manifest atomically replaces
`manifest.json`; `IndexReader.refresh()` and
`RetrievalEngine.reload_index()` let a live engine hop generations
between batches. `compact_index` folds tombstones and delta shards into a
clean single-generation layout equal, file for file, to `write_index` of
the same logical state (`apply_delta_to_index`).

Where the two packages part:

  * the card's `pq_encode` and `neighbor_graph` sum in another order than
    XLA on the CPU: an upsert's code may differ at a near-tie of its
    argmin, and after a re-cluster `neighbor_sims` (and its sha256 in the
    manifest) within float32 rounding, `neighbor_ids` at near-ties;
  * an int8 v1 index is refused (`IndexFormatError`): the JAX delta path
    packs upserted rows with no `block_scale` (every such record is
    written as zeros), and its compaction reads the stored int8 records
    back as floats under a new scale of 1.0.

Divergences from a from-scratch rebuild, as in the JAX package: the
centroids are the incrementally maintained ones; a posting entry cut
from a full row by an earlier build is not resurrected when a delete
frees room (`truncated_postings` counts the loss); a delta drops a v1
index's optional pq/ side artifacts (their per-doc codes would go
stale), while v2's code shards are re-encoded.
"""

import copy
import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.convert import index_from_numpy
from repro_torch.core import kmeans as km
from repro_torch.core import quant as quant_lib
from repro_torch.core.clusd import CluSDIndex
from repro_torch.core.sparse import SparseIndex
from repro_torch.device import resolve_device
from repro_torch.index import builder as builder_lib
from repro_torch.index import format as fmt
from repro_torch.index.reader import IndexReader
from repro_torch.obs import NOOP_TRACE


@dataclasses.dataclass
class IndexDelta:
    """One batch of corpus mutations.

    upsert_ids: (U,) int — ids < n_docs replace that document (its old
      vector/terms are dropped first); ids >= n_docs append and must form
      the contiguous range [n_docs, n_docs + n_new).
    upsert_embeddings: (U, dim) float32 vectors for the upserted docs.
    upsert_terms/weights: (U, T) int32 (-1 pad) / float32 sparse terms.
    delete_ids: (Dd,) int — must be live (not already deleted/unknown).
    format_version: None = apply to whatever format the target index has;
      an explicit version is validated against the index and a mismatch
      (e.g. a v2 delta against a v1 index) raises IndexFormatError.
    """

    upsert_ids: np.ndarray
    upsert_embeddings: np.ndarray
    upsert_terms: np.ndarray
    upsert_weights: np.ndarray
    delete_ids: np.ndarray
    format_version: int = None

    def __post_init__(self):
        self.upsert_ids = np.asarray(self.upsert_ids, np.int64).reshape(-1)
        self.upsert_embeddings = np.asarray(self.upsert_embeddings,
                                            np.float32)
        self.upsert_terms = np.asarray(self.upsert_terms, np.int32)
        self.upsert_weights = np.asarray(self.upsert_weights, np.float32)
        self.delete_ids = np.asarray(self.delete_ids, np.int64).reshape(-1)
        if self.upsert_embeddings.shape[0] != len(self.upsert_ids):
            raise ValueError("upsert_embeddings rows != upsert_ids")
        if self.upsert_terms.shape[:1] != (len(self.upsert_ids),) or \
                self.upsert_weights.shape != self.upsert_terms.shape:
            raise ValueError(
                f"upsert_terms {self.upsert_terms.shape} / upsert_weights "
                f"{self.upsert_weights.shape} must both be "
                f"({len(self.upsert_ids)}, T)")
        if len(np.unique(self.upsert_ids)) != len(self.upsert_ids):
            raise ValueError("duplicate upsert ids in one delta")

    @property
    def n_upserts(self):
        return int(len(self.upsert_ids))

    @property
    def n_deletes(self):
        return int(len(self.delete_ids))


# ---------------------------------------------------------------------------
# canonical delta policy (shared by the in-memory and on-disk paths)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _State:
    """Canonical (tombstone-free) logical index state on the host."""

    centroids: np.ndarray       # (N, dim) f32
    members: list               # per-cluster member id lists, slot order
    doc_cluster: np.ndarray     # (D,) i32, -1 = deleted
    pd: np.ndarray              # (V, P) padded postings (docs)
    pw: np.ndarray              # (V, P) padded postings (weights)
    neighbor_ids: np.ndarray    # (N, m) i32
    neighbor_sims: np.ndarray   # (N, m) f32
    cap: int

    @property
    def n_docs(self):
        return int(self.doc_cluster.shape[0])

    def cluster_docs(self):
        cd = np.full((len(self.members), self.cap), -1, np.int32)
        for c, mem in enumerate(self.members):
            cd[c, :len(mem)] = mem
        return cd


def canonical_members(cluster_docs, tombstones=None):
    """Per-cluster live member lists in slot order (tombstoned and padded
    slots dropped) — the canonical view both delta application and
    compaction operate on."""
    cd = np.asarray(cluster_docs)
    live = cd >= 0
    if tombstones is not None:
        live &= np.asarray(tombstones) == 0
    return [cd[c][live[c]].tolist() for c in range(cd.shape[0])]


def _update_postings(pd, pw, drop_ids, up_ids, up_terms, up_weights):
    """Remove dropped docs and add upserted docs' terms, re-sorting each
    touched row with the exact SparseIndex.build comparator (weight desc,
    doc id desc) and truncating to the padded width. Returns
    (pd, pw, n_truncated)."""
    pd, pw = pd.copy(), pw.copy()
    V, P = pd.shape
    adds = {}
    for i, d in enumerate(np.asarray(up_ids)):
        for t, w in zip(up_terms[i], up_weights[i]):
            if t >= 0 and w > 0:
                adds.setdefault(int(t), []).append((int(d), float(w)))
    touched = set(adds)
    dropmask = np.zeros(pd.shape, bool)
    if len(drop_ids):
        dropmask = np.isin(pd, np.asarray(sorted(set(map(int, drop_ids))),
                                          np.int64))
        touched.update(np.flatnonzero(dropmask.any(axis=1)).tolist())
    keepmask = (pd >= 0) & ~dropmask
    truncated = 0
    for t in sorted(touched):
        d = pd[t][keepmask[t]].astype(np.int64)
        w = pw[t][keepmask[t]].astype(np.float64)
        if t in adds:
            ad = np.asarray([x[0] for x in adds[t]], np.int64)
            aw = np.asarray([x[1] for x in adds[t]], np.float64)
            d, w = np.concatenate([d, ad]), np.concatenate([w, aw])
        # weight desc, ties doc-id desc == sorted(reverse=True) over
        # (w, d) tuples, i.e. exactly SparseIndex.build's impact order
        order = np.lexsort((-d, -w))[:P]
        truncated += max(0, len(d) - P)
        pd[t], pw[t] = -1, 0.0
        pd[t, :len(order)] = d[order]
        pw[t, :len(order)] = w[order]
    return pd, pw, truncated


def _apply_delta_state(state: _State, delta: IndexDelta, get_vec, ranges, *,
                       recluster_overflow=0.5, recluster_min_overflow=4,
                       lloyd_iters=4, device=None):
    """Apply `delta` to the canonical state in place. Deterministic on the
    host; a re-cluster's neighbor graph runs on `device`.

    get_vec(doc_ids) -> (n, dim) float32 — vectors for EXISTING docs
    (post-replacement), used only by local re-clustering. The on-disk path
    feeds it from the previous generation's shard files; the in-memory
    path from the merged embedding matrix.

    Returns a report dict; `rewrite_clusters` is the set whose member list
    changed by insertion or re-clustering (deletes alone never force a
    shard rewrite — they become tombstones)."""
    n_clusters, cap = len(state.members), state.cap
    shard_of = np.zeros(n_clusters, np.int64)
    for s, (lo, hi) in enumerate(ranges):
        shard_of[lo:hi] = s
    D0 = state.n_docs
    new_ids = np.sort(delta.upsert_ids[delta.upsert_ids >= D0])
    if len(new_ids) and not np.array_equal(
            new_ids, np.arange(D0, D0 + len(new_ids))):
        raise ValueError(f"appended ids must be contiguous from {D0}, "
                         f"got {new_ids.tolist()}")
    if np.any(delta.delete_ids >= D0) or np.any(delta.delete_ids < 0):
        raise ValueError("delete id out of range")

    # -- drops: deletes + the old rows of replaced docs -------------------
    replaced = [int(d) for d in delta.upsert_ids
                if d < D0 and state.doc_cluster[d] >= 0]
    drops = [int(d) for d in delta.delete_ids] + replaced
    if len(set(drops)) != len(drops):
        raise ValueError("a doc appears in both delete_ids and upsert_ids "
                         "(replace already implies delete)")
    delete_only_clusters = set()
    for d in delta.delete_ids:
        c = int(state.doc_cluster[d])
        if c < 0:
            raise ValueError(f"delete of non-live doc {int(d)}")
        state.members[c].remove(int(d))
        state.doc_cluster[d] = -1
        delete_only_clusters.add(c)
    for d in replaced:
        c = int(state.doc_cluster[d])
        state.members[c].remove(d)
        state.doc_cluster[d] = -1
        delete_only_clusters.add(c)
    if len(new_ids):
        state.doc_cluster = np.concatenate(
            [state.doc_cluster,
             np.full(len(new_ids), -1, np.int32)]).astype(np.int32)

    # -- inserts: nearest existing centroid with free capacity ------------
    rewrite_clusters = set()
    n_shards = len(ranges)
    overflow_by_shard = np.zeros(n_shards, np.int64)
    targeted_by_shard = np.zeros(n_shards, np.int64)
    n_overflow = 0
    if delta.n_upserts:
        X = delta.upsert_embeddings
        C = state.centroids
        d2 = (X * X).sum(1)[:, None] + (C * C).sum(1)[None] - 2.0 * X @ C.T
        pref = np.argsort(d2, axis=1, kind="stable")
        for i, d in enumerate(delta.upsert_ids):
            targeted_by_shard[shard_of[pref[i, 0]]] += 1
            for c in pref[i]:
                if len(state.members[c]) < cap:
                    state.members[c].append(int(d))
                    state.doc_cluster[d] = c
                    rewrite_clusters.add(int(c))
                    if c != pref[i, 0]:
                        n_overflow += 1
                        overflow_by_shard[shard_of[pref[i, 0]]] += 1
                    break
            else:
                raise RuntimeError("total index capacity exceeded — "
                                   "compact or rebuild with more clusters")

    # -- local re-clustering of overflowing shards -------------------------
    reclustered = []
    for s, (lo, hi) in enumerate(ranges):
        if targeted_by_shard[s] == 0:
            continue
        frac = overflow_by_shard[s] / targeted_by_shard[s]
        if (overflow_by_shard[s] < recluster_min_overflow
                or frac < recluster_overflow):
            continue
        docs = [d for c in range(lo, hi) for d in state.members[c]]
        if not docs:
            continue
        X = np.asarray(get_vec(np.asarray(docs, np.int64)), np.float32)
        C_new, assign = km.lloyd_refine(X, state.centroids[lo:hi],
                                        iters=lloyd_iters)
        table, assign = km.build_cluster_table(assign, hi - lo, cap, X, C_new)
        table = np.asarray(table)
        for j in range(hi - lo):
            mem = [docs[i] for i in table[j] if i >= 0]
            state.members[lo + j] = mem
            for d in mem:
                state.doc_cluster[d] = lo + j
        state.centroids[lo:hi] = C_new
        rewrite_clusters.update(range(lo, hi))
        reclustered.append(s)

    if reclustered:
        m = state.neighbor_ids.shape[1]
        nb_ids, nb_sims = km.neighbor_graph(
            torch.from_numpy(state.centroids).to(resolve_device(device)), m)
        state.neighbor_ids = nb_ids.cpu().numpy()
        state.neighbor_sims = nb_sims.cpu().numpy()

    # -- postings ----------------------------------------------------------
    state.pd, state.pw, truncated = _update_postings(
        state.pd, state.pw, drops, delta.upsert_ids, delta.upsert_terms,
        delta.upsert_weights)

    return {
        "n_upserts": delta.n_upserts,
        "n_deletes": delta.n_deletes,
        "n_replaced": len(replaced),
        "n_appended": int(len(new_ids)),
        "overflow_placements": int(n_overflow),
        "rewrite_clusters": rewrite_clusters,
        "delete_only_clusters": delete_only_clusters - rewrite_clusters,
        "reclustered_shards": reclustered,
        "truncated_postings_delta": int(truncated),
    }


# ---------------------------------------------------------------------------
# in-memory application (reference semantics + convenience API)
# ---------------------------------------------------------------------------

def apply_delta_to_index(cfg, index, embeddings, delta: IndexDelta, *,
                         n_shards, policy_vectors=None,
                         recluster_overflow=0.5, recluster_min_overflow=4,
                         lloyd_iters=4):
    """Apply a delta to an in-memory CluSDIndex (repro_torch, on any
    device) and its (D, dim) host embedding matrix.

    The reference of the delta semantics: the on-disk path
    (`write_index_delta` ... `compact_index`) produces the same files as
    `write_index(cfg, apply_delta_to_index(...))`. `n_shards` must match
    the target index's shard count (re-clustering decisions are per
    shard). `policy_vectors` optionally overrides the vectors
    re-clustering sees (e.g. PQ-decoded vectors, to mirror a v2 index
    that stores only codes). Upsert codes (`pq_encode`) and a
    re-cluster's neighbor graph run on the index's device. Returns
    (new_index on that device, new_embeddings, report).
    """
    dev = index.device
    D0 = int(index.doc_cluster.shape[0])
    new_ids = delta.upsert_ids[delta.upsert_ids >= D0]
    emb = np.asarray(embeddings, np.float32)
    emb_new = np.concatenate(
        [emb, np.zeros((len(new_ids), emb.shape[1]), np.float32)])
    emb_new[delta.upsert_ids] = delta.upsert_embeddings

    pv = emb_new if policy_vectors is None \
        else np.asarray(policy_vectors, np.float32)
    _np = builder_lib._np
    state = _State(
        centroids=_np(index.centroids).astype(np.float32),
        members=canonical_members(_np(index.cluster_docs)),
        doc_cluster=_np(index.doc_cluster).astype(np.int32),
        pd=_np(index.sparse_index.postings_docs).copy(),
        pw=_np(index.sparse_index.postings_weights).copy(),
        neighbor_ids=_np(index.neighbor_ids),
        neighbor_sims=_np(index.neighbor_sims),
        cap=int(index.cluster_docs.shape[1]))
    ranges = builder_lib.shard_ranges(len(state.members), n_shards)
    report = _apply_delta_state(
        state, delta, lambda ids: pv[ids], ranges,
        recluster_overflow=recluster_overflow,
        recluster_min_overflow=recluster_min_overflow,
        lloyd_iters=lloyd_iters, device=dev)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    sp = SparseIndex(t(state.pd), t(state.pw), state.n_docs,
                     int(getattr(index.sparse_index, "truncated_postings", 0))
                     + report["truncated_postings_delta"])
    quantizer = index.quantizer
    if quantizer is not None:
        # re-encode upserted rows against the EXISTING codebooks — delta
        # application never retrains PQ (that is a compact/rebuild decision)
        codes = _np(quantizer.codes)
        codes = np.concatenate(
            [codes, np.zeros((len(new_ids), codes.shape[1]), codes.dtype)])
        codes[delta.upsert_ids] = quant_lib.pq_encode(
            quantizer.codebooks, delta.upsert_embeddings,
            quantizer.rotation).cpu().numpy().astype(codes.dtype)
        quantizer = quant_lib.PQ(quantizer.codebooks, t(codes),
                                 quantizer.rotation, quantizer.nsub)
    new_index = CluSDIndex(
        centroids=t(state.centroids), cluster_docs=t(state.cluster_docs()),
        doc_cluster=t(state.doc_cluster), neighbor_ids=t(state.neighbor_ids),
        neighbor_sims=t(state.neighbor_sims), embeddings=None,
        sparse_index=sp, selector=index.selector, quantizer=quantizer,
        bin_ids=index.bin_ids)
    return new_index, emb_new, report


# ---------------------------------------------------------------------------
# on-disk sources: read existing vectors/codes back from shard files
# ---------------------------------------------------------------------------

class _ShardRecords:
    """Random access to the previous generation's per-cluster records
    ((cap, dim) float32 blocks for v1, bfloat16 widened exactly;
    (cap, nsub) uint8 codes for v2), located through the PRE-delta
    cluster_docs/doc_cluster snapshot. Reads whole cluster records and
    caches them, so repeated slot lookups within a cluster cost one
    read."""

    def __init__(self, index_dir, manifest):
        g = manifest["geometry"]
        self.is_pq = manifest["format_version"] == fmt.FORMAT_VERSION_PQ
        cap = int(g["cap"])
        self._bf16 = False
        if self.is_pq:
            shape, dtype = (cap, int(g["nsub"])), np.uint8
        else:
            shape, dtype = (cap, int(g["dim"])), fmt.record_dtype(
                g["block_dtype"])
            self._bf16 = fmt.resolve_block_dtype(g["block_dtype"]) \
                == "bfloat16"
        self.record_shape = shape
        self._lo, self._hi, self._mms = [], [], []
        for s in manifest["block_shards"]:
            lo, hi = int(s["cluster_lo"]), int(s["cluster_hi"])
            self._lo.append(lo)
            self._hi.append(hi)
            self._mms.append(np.memmap(
                os.path.join(index_dir, s["file"]), dtype=dtype, mode="r",
                shape=(hi - lo,) + shape))
        self._hi = np.asarray(self._hi, np.int64)
        self._cache = {}

    def cluster_record(self, c):
        rec = self._cache.get(c)
        if rec is None:
            s = int(np.searchsorted(self._hi, c, side="right"))
            rec = np.array(self._mms[s][c - self._lo[s]])
            if self._bf16:
                rec = fmt.bf16_bits_to_f32(rec)
            self._cache[c] = rec
        return rec


class _DeltaRowSource:
    """Row-indexable (D', width) view over the updated corpus: rows for
    upserted docs come from the delta; every other row is read back from
    the previous generation's shards. Exactly the interface
    `pack_blocks` / `_write_code_blocks` gather from."""

    def __init__(self, records: _ShardRecords, cd_old, doc_cluster_old,
                 delta_rows, n_docs, width, dtype):
        self._records = records
        self._cd_old = cd_old
        self._dc_old = doc_cluster_old
        self._delta = delta_rows                 # {doc id -> (width,) row}
        self.shape = (int(n_docs), int(width))
        self.dtype = np.dtype(dtype)
        self._slots = {}

    def _old_row(self, d):
        c = int(self._dc_old[d])
        slot = self._slots.get(d)
        if slot is None:
            slot = int(np.flatnonzero(self._cd_old[c] == d)[0])
            self._slots[d] = slot
        return self._records.cluster_record(c)[slot]

    def __getitem__(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.empty((len(ids), self.shape[1]), self.dtype)
        for i, d in enumerate(ids):
            row = self._delta.get(int(d))
            out[i] = self._old_row(int(d)) if row is None else row
        return out


class _ShapeOnly:
    """Stands in for the embedding matrix when only its shape is needed
    (v2 writes: codes are given, floats never touched)."""

    def __init__(self, shape):
        self.shape = tuple(int(x) for x in shape)


# ---------------------------------------------------------------------------
# write_index_delta: the incremental commit
# ---------------------------------------------------------------------------

def _load_padded_postings(reader: IndexReader, max_postings):
    """Current postings as padded (V, max_postings) host arrays — v1 stores
    them padded already; v2 CSR is re-expanded to the build-time width so
    truncation behaves identically to the in-memory reference."""
    if not reader.is_pq:
        return (np.asarray(reader.array("sparse_postings_docs")).copy(),
                np.asarray(reader.array("sparse_postings_weights")).copy())
    return builder_lib.postings_from_csr(
        reader.array("sparse_postings_data"),
        reader.array("sparse_postings_wdata"),
        reader.array("sparse_postings_indptr"), min_width=max_postings)


def _refuse_int8(index_dir, geom, what):
    """An int8 v1 index takes no delta and no compaction here: the JAX
    package's delta packs upserted rows with no `block_scale` and its
    compaction re-reads the stored int8 records as floats, so its files
    are corrupt and matching them is not an option. Raise before
    anything is written."""
    if fmt.resolve_block_dtype(geom["block_dtype"]) == "int8":
        raise fmt.IndexFormatError(
            f"{what} of the int8 v1 index at {index_dir} is refused: its "
            f"block_scale {geom.get('block_scale')} would be lost (the JAX "
            f"writer packs upserted rows with no scale, zeroing them, and "
            f"re-reads stored int8 records as floats under a scale of "
            f"1.0); rebuild the index from its float embeddings instead")


def write_index_delta(index_dir, delta: IndexDelta, *, verify="size",
                      recluster_overflow=0.5, recluster_min_overflow=4,
                      lloyd_iters=4, tracer=None, device=None):
    """Apply `delta` to the index at `index_dir` as a new atomic
    generation. Only shards whose cluster membership changed are
    rewritten; deletes become tombstones; the previous generation's files
    and manifest remain readable. v2 upserts are encoded (`pq_encode`)
    and a re-cluster's neighbor graph is computed on `device` (None: the
    CUDA card). Returns a report dict (generation, shards/bytes
    rewritten, ...). `tracer` (repro_torch.obs.Tracer) records one
    `write_index_delta` trace with a span per phase, bytes annotated.
    """
    dev = resolve_device(device)
    tr = tracer.trace("write_index_delta", n_upserts=delta.n_upserts,
                      n_deletes=len(delta.delete_ids)) \
        if tracer is not None else NOOP_TRACE
    t0 = time.perf_counter()
    sp_load = tr.span("load_state")
    manifest = fmt.load_manifest(index_dir)
    fmt.verify_files(index_dir, manifest, level=verify)
    fv = manifest["format_version"]
    if delta.format_version is not None and delta.format_version != fv:
        raise fmt.IndexFormatError(
            f"delta targets format v{delta.format_version} but the index "
            f"at {index_dir} is format v{fv}; re-create the delta for the "
            f"index's format (or compact/rebuild the index first)")
    reader = IndexReader(index_dir, manifest)
    cfg = reader.config()
    g = reader.generation
    G = g + 1
    geom = reader.geometry
    v2 = fv == fmt.FORMAT_VERSION_PQ
    if not v2:
        _refuse_int8(index_dir, geom, "a delta")
    dim, cap = int(geom["dim"]), int(geom["cap"])
    if delta.n_upserts and delta.upsert_embeddings.shape[1] != dim:
        raise ValueError(f"delta dim {delta.upsert_embeddings.shape[1]} "
                         f"!= index dim {dim}")

    # pre-delta snapshot (slot layout incl. tombstone holes, for locating
    # existing docs' bytes) + canonical state the policy operates on
    cd_old = np.asarray(reader.array("cluster_docs")).copy()
    tomb_old = reader.tombstones()
    if tomb_old is None:
        tomb_old = np.zeros(cd_old.shape, np.uint8)
    dc_old = np.asarray(reader.array("doc_cluster")).copy()
    pd, pw = _load_padded_postings(reader, cfg.max_postings)
    state = _State(
        centroids=np.asarray(reader.array("centroids"), np.float32).copy(),
        members=canonical_members(cd_old, tomb_old),
        doc_cluster=dc_old.copy(),
        pd=pd, pw=pw,
        neighbor_ids=np.asarray(reader.array("neighbor_ids")).copy(),
        neighbor_sims=np.asarray(reader.array("neighbor_sims")).copy(),
        cap=cap)
    ranges = [(int(s["cluster_lo"]), int(s["cluster_hi"]))
              for s in manifest["block_shards"]]

    records = _ShardRecords(index_dir, manifest)
    delta_vec = {int(d): delta.upsert_embeddings[i]
                 for i, d in enumerate(delta.upsert_ids)}
    if v2:
        codebooks = reader._pq_array("codebooks")
        rotation = reader._pq_array("rotation")
        if delta.n_upserts:
            delta_codes_arr = quant_lib.pq_encode(
                torch.from_numpy(np.array(codebooks, np.float32)).to(dev),
                delta.upsert_embeddings,
                None if rotation is None else torch.from_numpy(
                    np.array(rotation, np.float32)).to(dev)
            ).cpu().numpy().astype(np.uint8)
        else:
            delta_codes_arr = np.zeros((0, int(geom["nsub"])), np.uint8)
        delta_codes = {int(d): delta_codes_arr[i]
                       for i, d in enumerate(delta.upsert_ids)}
    sp_load.end()

    def get_vec(ids):
        """Policy vectors: what the index stores (exact floats for v1,
        PQ-decoded floats for v2) with delta rows overriding."""
        out = np.empty((len(ids), dim), np.float32)
        for i, d in enumerate(np.asarray(ids, np.int64)):
            row = delta_vec.get(int(d))
            if row is not None:
                out[i] = row
            elif v2:
                c = int(dc_old[d])
                slot = int(np.flatnonzero(cd_old[c] == d)[0])
                code = records.cluster_record(c)[slot]
                out[i] = quant_lib.decode_code_blocks(
                    codebooks, code[None, :], rotation)[0]
            else:
                c = int(dc_old[d])
                slot = int(np.flatnonzero(cd_old[c] == d)[0])
                out[i] = records.cluster_record(c)[slot]
        return out

    with tr.span("apply_delta"):
        report = _apply_delta_state(
            state, delta, get_vec, ranges,
            recluster_overflow=recluster_overflow,
            recluster_min_overflow=recluster_min_overflow,
            lloyd_iters=lloyd_iters, device=dev)

    # -- new stored layout -------------------------------------------------
    shard_of = np.zeros(cd_old.shape[0], np.int64)
    for s, (lo, hi) in enumerate(ranges):
        shard_of[lo:hi] = s
    rewrite_shards = sorted({int(shard_of[c])
                             for c in report["rewrite_clusters"]})
    rewrite_set = set(rewrite_shards)
    cd_new, tomb_new = cd_old.copy(), tomb_old.copy()
    canon = state.cluster_docs()
    for s in rewrite_shards:
        lo, hi = ranges[s]
        cd_new[lo:hi] = canon[lo:hi]
        tomb_new[lo:hi] = 0
    for d in [int(x) for x in delta.delete_ids] + [
            int(x) for x in delta.upsert_ids
            if x < len(dc_old) and dc_old[x] >= 0]:
        c = int(dc_old[d])
        if int(shard_of[c]) in rewrite_set:
            continue                      # shard rewritten canonically
        slot = int(np.flatnonzero(cd_old[c] == d)[0])
        tomb_new[c, slot] = 1

    # -- stage new artifact files -----------------------------------------
    stage = os.path.join(index_dir, f".stage-g{G}")
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(os.path.join(stage, "blocks"))
    staged = []                                   # relpaths written

    block_dtype = geom["block_dtype"]
    D_new = state.n_docs
    block_shards = [dict(s) for s in manifest["block_shards"]]
    bytes_rewritten = 0
    sp_stage = tr.span("stage_blocks", n_shards=len(rewrite_shards))
    for s in rewrite_shards:
        lo, hi = ranges[s]
        if v2:
            rel = os.path.join("blocks", f"shard_{s:05d}.g{G}.codes.bin")
            source = _DeltaRowSource(records, cd_old, dc_old, delta_codes,
                                     D_new, geom["nsub"], np.uint8)
            builder_lib._write_code_blocks(os.path.join(stage, rel), source,
                                           cd_new[lo:hi])
        else:
            rel = os.path.join("blocks", f"shard_{s:05d}.g{G}.bin")
            source = _DeltaRowSource(records, cd_old, dc_old, delta_vec,
                                     D_new, dim, np.float32)
            builder_lib._write_float_blocks(
                os.path.join(stage, rel), source, cd_new[lo:hi], block_dtype,
                builder_lib.DEFAULT_CHUNK_DOCS)
        block_shards[s]["file"] = rel
        bytes_rewritten += os.path.getsize(os.path.join(stage, rel))
        staged.append(rel)
    sp_stage.annotate(bytes_rewritten=int(bytes_rewritten)).end()

    sp_arrays = tr.span("stage_arrays")
    arrays = dict(manifest["arrays"])
    new_arrays = {
        "cluster_docs": cd_new,
        "doc_cluster": state.doc_cluster,
        "tombstones": tomb_new,
        "centroids": state.centroids,
        "neighbor_ids": state.neighbor_ids,
        "neighbor_sims": state.neighbor_sims,
    }
    if not report["reclustered_shards"]:
        for name in ("centroids", "neighbor_ids", "neighbor_sims"):
            new_arrays.pop(name)          # unchanged: carry by reference
    if v2:
        data, wdata, indptr = builder_lib.postings_csr(state.pd, state.pw)
        new_arrays.update(sparse_postings_data=data,
                          sparse_postings_wdata=wdata,
                          sparse_postings_indptr=indptr)
    else:
        new_arrays.update(sparse_postings_docs=state.pd,
                          sparse_postings_weights=state.pw)
    for name, arr in new_arrays.items():
        rel = f"{name}.g{G}.npy"
        np.save(os.path.join(stage, rel),
                np.asarray(arr, builder_lib._ARRAY_DTYPES[name]))
        arrays[name] = rel
        staged.append(rel)
    sp_arrays.end()

    # -- manifest for generation G ----------------------------------------
    new_manifest = copy.deepcopy(manifest)
    new_manifest["generation"] = G
    new_manifest["parent_generation"] = g
    new_manifest["arrays"] = arrays
    new_manifest["block_shards"] = block_shards
    new_manifest["geometry"] = dict(geom, n_docs=D_new)
    if not v2:
        new_manifest["pq"] = None         # v1 side PQ codes would be stale
    live_fill = np.where(tomb_new > 0, -1, cd_new)
    old_stats = manifest.get("stats", {})
    new_manifest["stats"] = dict(
        old_stats,
        cluster_fill=builder_lib._cluster_fill_stats(live_fill),
        truncated_postings=int(old_stats.get("truncated_postings", 0))
        + report["truncated_postings_delta"])

    files = {}
    referenced = set(arrays.values()) | {s["file"] for s in block_shards}
    if v2 and new_manifest.get("pq"):
        referenced |= set(new_manifest["pq"]["arrays"].values())
    lstm_dir = (new_manifest.get("lstm") or {}).get("dir")
    for rel, entry in manifest["files"].items():
        if rel in referenced or (lstm_dir and rel.startswith(lstm_dir + "/")):
            files[rel] = entry
    for rel in staged:
        full = os.path.join(stage, rel)
        files[rel] = {"bytes": os.path.getsize(full),
                      "sha256": fmt.file_sha256(full)}
    new_manifest["files"] = files
    new_manifest["total_bytes"] = sum(e["bytes"] for e in files.values())
    shard_bytes_total = sum(files[s["file"]]["bytes"] for s in block_shards)
    wall_s = time.perf_counter() - t0
    new_manifest["update_stats"] = {
        "n_upserts": report["n_upserts"],
        "n_deletes": report["n_deletes"],
        "n_replaced": report["n_replaced"],
        "n_appended": report["n_appended"],
        "overflow_placements": report["overflow_placements"],
        "shards_rewritten": rewrite_shards,
        "reclustered_shards": report["reclustered_shards"],
        "bytes_rewritten": int(bytes_rewritten),
        "shard_bytes_total": int(shard_bytes_total),
        "wall_s": round(wall_s, 3),
    }

    # -- commit: move staged files into place, archive, flip manifest ------
    with tr.span("commit"):
        fmt.commit_generation(index_dir, stage, staged, manifest,
                              new_manifest)
    tr.finish(generation=G, bytes_rewritten=int(bytes_rewritten))

    return {
        "generation": G,
        "parent_generation": g,
        "n_shards": len(ranges),
        "shards_rewritten": rewrite_shards,
        "reclustered_shards": report["reclustered_shards"],
        "n_upserts": report["n_upserts"],
        "n_deletes": report["n_deletes"],
        "n_replaced": report["n_replaced"],
        "n_appended": report["n_appended"],
        "overflow_placements": report["overflow_placements"],
        "bytes_rewritten": int(bytes_rewritten),
        "shard_bytes_total": int(shard_bytes_total),
        "bytes_rewritten_frac": round(
            bytes_rewritten / max(1, shard_bytes_total), 4),
        "truncated_postings_delta": report["truncated_postings_delta"],
        "wall_s": round(wall_s, 3),
    }


# ---------------------------------------------------------------------------
# compaction: fold generations back into a clean single-generation layout
# ---------------------------------------------------------------------------

def _suffix_rel(rel, G):
    """Generation-suffix an artifact relpath the way delta commits do:
    top-level and blocks/ files get `.g<G>` before their extension
    (`centroids.g3.npy`, `blocks/shard_00000.g3.codes.bin`); files under
    an artifact tree (lstm/, pq/) suffix the top-level directory
    (`lstm.g3/step_0/...`) so the whole tree moves as one namespace."""
    d, base = os.path.split(rel)
    if d in ("", "blocks"):
        stem, dot, ext = base.partition(".")
        return os.path.join(d, f"{stem}.g{G}.{ext}" if dot
                            else f"{stem}.g{G}")
    top, rest = rel.split(os.sep, 1)
    return os.path.join(f"{top}.g{G}", rest)


def _commit_compacted_in_place(index_dir, tmp_dir, manifest):
    """Fold a fully-written compacted layout (at `tmp_dir`) into the live
    `index_dir` with the same no-torn-state guarantee as delta commits:
    artifacts move in under fresh generation-suffixed names (never
    clobbering anything the current manifest references), the new
    manifest atomically replaces manifest.json, and only then are the
    old generations' files and the manifest history garbage-collected."""
    G = fmt.manifest_generation(manifest)
    mapping = {rel: _suffix_rel(rel, G) for rel in manifest["files"]}
    for rel, new_rel in mapping.items():
        dst = os.path.join(index_dir, new_rel)
        os.makedirs(os.path.dirname(dst) or index_dir, exist_ok=True)
        os.replace(os.path.join(tmp_dir, rel), dst)
    manifest["arrays"] = {k: mapping[v]
                          for k, v in manifest["arrays"].items()}
    manifest["block_shards"] = [dict(s, file=mapping[s["file"]])
                                for s in manifest["block_shards"]]
    if manifest.get("lstm"):
        manifest["lstm"] = dict(manifest["lstm"],
                                dir=f"{manifest['lstm']['dir']}.g{G}")
    if manifest.get("pq"):
        manifest["pq"] = dict(manifest["pq"],
                              arrays={k: mapping[v] for k, v in
                                      manifest["pq"]["arrays"].items()})
    manifest["files"] = {mapping[k]: v
                         for k, v in manifest["files"].items()}
    fmt.commit_manifest(index_dir, manifest)
    # post-flip GC: drop everything this generation doesn't reference
    # (old shards/arrays, archived manifests, crashed stage dirs). A
    # reader still holding a pre-compaction manifest loses its files
    # here — compaction is the one deliberately destructive operation.
    keep = set(manifest["files"]) | {fmt.MANIFEST_NAME}
    for dirpath, _, filenames in os.walk(index_dir, topdown=False):
        for name in filenames:
            full = os.path.join(dirpath, name)
            if os.path.relpath(full, index_dir) not in keep:
                os.remove(full)
        if dirpath != index_dir and not os.listdir(dirpath):
            os.rmdir(dirpath)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return manifest


def compact_index(index_dir, out_dir=None, *, chunk_docs=None, tracer=None,
                  device=None):
    """Rewrite the index's current logical state as a fresh layout:
    tombstones applied, member lists left-compacted, all shards repacked,
    manifest history dropped. In place by default — the compacted
    artifacts are staged to a sibling directory and committed through
    the same atomic manifest-replace protocol as deltas, so a racing
    reader always sees a valid generation — or to a fresh `out_dir`.

    Output invariant: the same files as `write_index` of the equivalent
    in-memory state. The state is loaded on `device` (None: the CUDA
    card), which does no computing here. `tracer` records one
    `compact_index` trace (load_state / rewrite / commit spans) and the
    rewrite's `write_index` trace.
    """
    dev = resolve_device(device)
    tr = tracer.trace("compact_index") if tracer is not None else NOOP_TRACE
    sp_load = tr.span("load_state")
    manifest = fmt.load_manifest(index_dir)
    reader = IndexReader(index_dir, manifest)
    geom = reader.geometry
    fv = manifest["format_version"]
    v2 = fv == fmt.FORMAT_VERSION_PQ
    if not v2:
        _refuse_int8(index_dir, geom, "a compaction")
    D, dim, cap = int(geom["n_docs"]), int(geom["dim"]), int(geom["cap"])
    cfg = dataclasses.replace(reader.config(), n_docs=D)

    members = canonical_members(np.asarray(reader.array("cluster_docs")),
                                reader.tombstones())
    cd = np.full((len(members), cap), -1, np.int32)
    for c, mem in enumerate(members):
        cd[c, :len(mem)] = mem
    pd, pw = _load_padded_postings(reader, cfg.max_postings)

    quantizer, embeddings = None, None
    if v2:
        quantizer = reader._quantizer_arrays()
        embeddings = _ShapeOnly((D, dim))
    else:
        records = _ShardRecords(index_dir, manifest)
        emb = np.zeros((D, dim), np.float32)
        masked = reader.masked_cluster_docs()
        for c in range(len(members)):
            live = masked[c] >= 0
            if live.any():
                emb[masked[c][live]] = records.cluster_record(c)[live]
        embeddings = emb

    index = index_from_numpy({
        "centroids": reader.array("centroids"), "cluster_docs": cd,
        "doc_cluster": reader.array("doc_cluster"),
        "neighbor_ids": reader.array("neighbor_ids"),
        "neighbor_sims": reader.array("neighbor_sims"),
        "bin_ids": reader.array("bin_ids"),
        "sparse_postings_docs": pd, "sparse_postings_weights": pw,
        "n_docs": D, "lstm_params": reader.lstm_params(),
        "quantizer": quantizer}, device=dev)
    index.sparse_index.truncated_postings = int(
        manifest.get("stats", {}).get("truncated_postings", 0))
    g = reader.generation
    sp_load.end()
    in_place = out_dir is None or \
        os.path.abspath(out_dir) == os.path.abspath(index_dir)
    target = index_dir + f".compact-g{g + 1}" if in_place else out_dir
    with tr.span("rewrite"):
        new_manifest = builder_lib.write_index(
            target, cfg, index, embeddings,
            n_shards=len(manifest["block_shards"]),
            block_dtype=geom["block_dtype"],
            format_version=fv, pq=index.quantizer,
            chunk_docs=chunk_docs or builder_lib.DEFAULT_CHUNK_DOCS,
            extra=manifest.get("extra"), generation=g + 1,
            parent_generation=g, tracer=tracer)
    if in_place:
        with tr.span("commit"):
            new_manifest = _commit_compacted_in_place(index_dir, target,
                                                      new_manifest)
    tr.finish(generation=g + 1,
              bytes_rewritten=int(new_manifest["total_bytes"]))
    return new_manifest
