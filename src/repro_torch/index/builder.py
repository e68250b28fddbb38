"""The build and write side of an index directory, as the JAX package's
`repro.index.builder` (the writer's files are byte for byte its own):

  * `build_index_offline(cfg, embeddings, ...)` — the streaming form of
    `core.clusd.build_index`: sharded Lloyd's k-means
    (`core.kmeans.kmeans_shards`, one embedding shard on the device at a
    time), the capacity-balanced cluster table, the neighbor graph, the
    sparse inverted index and the Stage-I bin table. `embeddings` may be
    an np.memmap larger than RAM: shards are lazy row-range views
    (`RowSlice`), overflow reassignment gathers in bounded chunks, and no
    step materializes the whole matrix.

  * `write_index(out_dir, cfg, index, embeddings, ...)` serializes a
    CluSDIndex into the versioned layout of index/format.py:
      format_version=1 — float block shards, per shard a raw (hi-lo, cap,
        dim) tensor in float32, bfloat16 or int8 (int8 stamps a global
        `block_scale` into the manifest geometry), packed `chunk_docs`
        rows at a time;
      format_version=2 — PQ code shards, per shard a raw (hi-lo, cap,
        nsub) uint8 tensor, the (nsub, 256, dsub) codebooks, and the
        sparse postings compacted to CSR. Without a PQ the writer trains
        one (`train_pq_stream`, `pq_nsub`).
    The LSTM selector goes to lstm/step_0 (repro_torch.checkpoint); the
    manifest lists every artifact's size and sha256. Everything is staged
    in `<out_dir>.tmp` and committed by rename.

Generations after the first are written by index/update.py.
"""

import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import bins as bins_lib
from repro_torch.core import kmeans as km
from repro_torch.core import quant as quant_lib
from repro_torch.core.clusd import CluSDIndex
from repro_torch.core.sparse import SparseIndex
from repro_torch.device import resolve_device
from repro_torch.index import format as fmt
from repro_torch.obs import NOOP_TRACE

_ARRAY_DTYPES = {
    "centroids": np.float32,
    "cluster_docs": np.int32,
    "doc_cluster": np.int32,
    "neighbor_ids": np.int32,
    "neighbor_sims": np.float32,
    "bin_ids": np.int32,
    "sparse_postings_docs": np.int32,
    "sparse_postings_weights": np.float32,
    # v2 compact (CSR) postings
    "sparse_postings_data": np.int32,
    "sparse_postings_wdata": np.float32,
    "sparse_postings_indptr": np.int64,
    "tombstones": np.uint8,
}

# embedding rows read per gather while packing blocks
DEFAULT_CHUNK_DOCS = 1 << 16


def _np(x):
    """numpy view of a host array or (any-device) tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RowSlice:
    """Lazy row-range view over any row-indexable (D, dim) matrix: nothing
    is read until the view is indexed or converted, and converting reads
    exactly the view's rows. It lets `embedding_shards` hand
    `kmeans_shards` a shard list over a corpus-sized np.memmap while one
    shard's rows at most are resident."""

    def __init__(self, source, lo, hi):
        self.source, self.lo, self.hi = source, int(lo), int(hi)
        self.shape = (self.hi - self.lo, int(source.shape[1]))
        self.dtype = np.dtype(getattr(source, "dtype", np.float32))

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            return self.source[self.lo + start:self.lo + stop:step]
        key = np.asarray(key)
        return self.source[self.lo + key]

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.source[self.lo:self.hi])
        out = out if dtype is None else out.astype(dtype, copy=False)
        # np.array() asks for a copy: a read-only memmap view is not one
        return out.copy() if copy else out


def shard_ranges(n_clusters, n_shards):
    """Even [lo, hi) cluster ranges; first shards absorb the remainder."""
    n_shards = max(1, min(n_shards, n_clusters))
    base, rem = divmod(n_clusters, n_shards)
    ranges, lo = [], 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def embedding_shards(embeddings, shard_docs):
    """Lazy row-range views over the (memmap-able) embedding matrix; rows
    are read only when a shard is consumed."""
    D = int(embeddings.shape[0])
    shard_docs = max(1, int(shard_docs))
    return [RowSlice(embeddings, lo, min(lo + shard_docs, D))
            for lo in range(0, D, shard_docs)]


def build_index_offline(cfg, embeddings, doc_terms, doc_weights, *,
                        shard_docs=None, kmeans_iters=15, init_idx=None,
                        generator=None, device=None, tracer=None):
    """Sharded offline build. `embeddings`: (D, dim) host array or
    np.memmap, clustered shard by shard (`kmeans_shards`; its init rows
    `init_idx`, else drawn with `generator`) and never on the device
    whole: the resident embedding rows are bounded by `shard_docs`.
    Returns a CluSDIndex on `device` (None: the CUDA card) with
    embeddings=None. `tracer` (repro_torch.obs.Tracer) records one
    `build_index` trace with a span per phase, as the JAX package's."""
    dev = resolve_device(device)
    D = int(embeddings.shape[0])
    shard_docs = shard_docs or min(D, 1 << 16)
    tr = tracer.trace("build_index", n_docs=D) if tracer is not None \
        else NOOP_TRACE
    shards = embedding_shards(embeddings, shard_docs)
    with tr.span("kmeans", n_shards=len(shards), iters=kmeans_iters):
        centroids, assign = km.kmeans_shards(
            shards, cfg.n_clusters, kmeans_iters, init_idx=init_idx,
            generator=generator, device=dev)
    with tr.span("cluster_table"):
        cluster_docs, doc_cluster = km.build_cluster_table(
            assign.cpu().numpy(), cfg.n_clusters, cfg.cluster_cap,
            embeddings, centroids.cpu().numpy(), chunk_rows=shard_docs)
    with tr.span("neighbor_graph"):
        m = min(cfg.n_neighbors, cfg.n_clusters - 1)
        nb_ids, nb_sims = km.neighbor_graph(centroids, m)
    with tr.span("sparse_index"):
        sp = SparseIndex.build(doc_terms, doc_weights, cfg.vocab,
                               cfg.max_postings, device=dev)
    tr.finish()
    return CluSDIndex(
        centroids=centroids,
        cluster_docs=torch.from_numpy(cluster_docs).to(dev),
        doc_cluster=torch.from_numpy(doc_cluster).to(dev),
        neighbor_ids=nb_ids, neighbor_sims=nb_sims, embeddings=None,
        sparse_index=sp,
        bin_ids=bins_lib.rank_bin_ids(cfg.bins, cfg.k_sparse, device=dev))


def pack_blocks(embeddings, cluster_docs, block_dtype="float32", scale=None):
    """The (n, cap, dim) cluster-block records of a doc table, in the
    shard's record dtype (bfloat16 as uint16 bits). Only member rows of
    `embeddings` are read. `scale` quantizes int8 records: rows / scale,
    rounded half to even, clipped to [-127, 127]."""
    name = fmt.resolve_block_dtype(block_dtype)
    cd = np.asarray(cluster_docs)
    dim = embeddings.shape[1]
    blocks = np.zeros(cd.shape + (dim,), fmt.record_dtype(name))
    mask = cd >= 0
    rows = np.asarray(embeddings[cd[mask]], np.float32)
    if name == "bfloat16":
        blocks[mask] = fmt.f32_to_bf16_bits(rows)
    elif name == "int8":
        if scale is None:
            raise ValueError("int8 blocks need a scale")
        info = np.iinfo(np.int8)
        rows = np.clip(np.round(rows / np.float32(scale)), info.min + 1,
                       info.max)
        blocks[mask] = rows.astype(np.int8)
    else:
        blocks[mask] = rows
    return blocks


def _write_float_blocks(path, embeddings, cd, block_dtype, chunk_docs,
                        scale=None):
    """Stream one shard's float block records to `path`, reading at most
    ~chunk_docs embedding rows per gather."""
    cap = cd.shape[1]
    group = max(1, int(chunk_docs) // max(1, cap))
    with open(path, "wb") as f:
        for lo in range(0, cd.shape[0], group):
            pack_blocks(embeddings, cd[lo:lo + group], block_dtype,
                        scale=scale).tofile(f)


def _block_scale(embeddings, chunk_docs):
    """Global int8 dequantization scale max|emb|/127, read in chunk_docs
    row reads."""
    amax = 0.0
    D = int(embeddings.shape[0])
    for lo in range(0, D, int(chunk_docs)):
        chunk = np.asarray(embeddings[lo:lo + int(chunk_docs)], np.float32)
        if chunk.size:
            amax = max(amax, float(np.abs(chunk).max()))
    return (amax / 127.0) if amax > 0 else 1.0


def _write_code_blocks(path, codes, cd):
    """One shard's (n, cap, nsub) uint8 code blocks; padded slots code 0
    (masked by cluster_docs at read time). codes: row-indexable (D, nsub)
    uint8 (an array, or the update path's row source)."""
    block = np.zeros(cd.shape + (codes.shape[1],), np.uint8)
    mask = cd >= 0
    block[mask] = codes[cd[mask]]
    block.tofile(path)


def postings_csr(postings_docs, postings_weights):
    """Padded (V, P) postings -> CSR (data, wdata, indptr); lossless."""
    pd = np.asarray(postings_docs)
    pw = np.asarray(postings_weights)
    valid = pd >= 0
    counts = valid.sum(axis=1)
    indptr = np.zeros(pd.shape[0] + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return pd[valid].astype(np.int32), pw[valid].astype(np.float32), indptr


def postings_from_csr(data, wdata, indptr, min_width=1):
    """Inverse of `postings_csr`: re-pad CSR postings into (V, P) arrays,
    P = max(min_width, longest row). The pad width never affects
    retrieval."""
    data = np.asarray(data)
    wdata = np.asarray(wdata)
    indptr = np.asarray(indptr)
    counts = np.diff(indptr)
    V = len(counts)
    P = int(max(min_width, counts.max() if V else 0, 1))
    pd = np.full((V, P), -1, np.int32)
    pw = np.zeros((V, P), np.float32)
    mask = np.arange(P)[None, :] < counts[:, None]
    pd[mask] = data
    pw[mask] = wdata
    return pd, pw


def _cluster_fill_stats(cluster_docs):
    fill = (np.asarray(cluster_docs) >= 0).sum(axis=1)
    return {"min": int(fill.min()), "max": int(fill.max()),
            "mean": round(float(fill.mean()), 2),
            "empty": int((fill == 0).sum())}


def _write_pq_arrays(tmp, pq_arrays, nsub, dtype=None):
    """Serialize PQ artifacts under pq/ and return their manifest entry."""
    os.makedirs(os.path.join(tmp, "pq"))
    pq_paths = {}
    for name, arr in pq_arrays.items():
        rel = os.path.join("pq", f"{name}.npy")
        arr = _np(arr) if dtype is None else _np(arr).astype(dtype)
        np.save(os.path.join(tmp, rel), arr)
        pq_paths[name] = rel
    return {"nsub": int(nsub), "arrays": pq_paths}


def selector_params(selector):
    """An LSTMSelector's weights as the JAX param dict {wx, wh, b, head_w,
    head_b} of numpy float32 arrays."""
    return {k: _np(p).astype(np.float32)
            for k, p in selector.named_parameters()}


def _index_pq(index, embeddings, pq, pq_nsub, chunk_docs):
    """The PQ of a v2 write: `pq`, else index.quantizer, else one trained
    here by `train_pq_stream` on the index's device, drawing from a
    torch.Generator seeded 0. The JAX writer trains with
    jax.random.key(0), whose draws no torch generator gives, so a PQ
    trained inside the two writers differs (codebooks and codes);
    a given PQ is written byte for byte as JAX writes it. Returns (pq,
    (D, nsub) uint8 codes)."""
    pq = pq if pq is not None else index.quantizer
    if pq is None:
        pq = quant_lib.train_pq_stream(
            embeddings, pq_nsub, chunk_docs=chunk_docs,
            generator=torch.Generator().manual_seed(0),
            device=index.device)
    codes = _np(pq.codes)
    if codes.shape[0] != index.n_docs:
        raise ValueError(f"PQ codes cover {codes.shape[0]} docs, "
                         f"index has {index.n_docs}")
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError("PQ codes out of uint8 range")
    return pq, codes.astype(np.uint8)


def write_index(out_dir, cfg, index, embeddings, *, n_shards=4,
                block_dtype="float32", extra=None,
                format_version=fmt.FORMAT_VERSION, pq=None, pq_nsub=8,
                chunk_docs=DEFAULT_CHUNK_DOCS, generation=0,
                parent_generation=None, tracer=None):
    """Serialize `index` (a repro_torch CluSDIndex, on any device) and its
    cluster blocks under `out_dir`; staged in `<out_dir>.tmp`, committed
    by rename. Returns the manifest.

    embeddings: the (D, dim) float32 host matrix (np.memmap is fine: reads
    are bounded by `chunk_docs` rows). format_version=2 writes PQ code
    shards from `pq`, else `index.quantizer`, else a PQ of `pq_nsub`
    subspaces trained here (see `_index_pq`). `extra` is caller metadata
    (e.g. the synthetic-corpus recipe). `generation` / `parent_generation`
    stamp the manifest for the update protocol (index/update.py): a
    fresh build is generation 0, `compact_index` writes old + 1.
    `tracer` (repro_torch.obs.Tracer) records one `write_index` trace,
    spans arrays, pq, block_shards, lstm and commit, as the JAX package's.
    """
    if format_version not in fmt.SUPPORTED_VERSIONS:
        raise ValueError(f"format_version {format_version} not in "
                         f"{fmt.SUPPORTED_VERSIONS}")
    tr = tracer.trace("write_index", generation=int(generation)) \
        if tracer is not None else NOOP_TRACE
    t0 = time.perf_counter()
    block_dtype = fmt.resolve_block_dtype(block_dtype)
    cd = _np(index.cluster_docs)
    n_clusters, cap = cd.shape
    dim = int(embeddings.shape[1])
    out_dir = os.path.abspath(out_dir)
    tmp = out_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "blocks"))

    v2 = format_version == fmt.FORMAT_VERSION_PQ
    sp_index = index.sparse_index
    arrays = {
        "centroids": index.centroids,
        "cluster_docs": cd,
        "doc_cluster": index.doc_cluster,
        "neighbor_ids": index.neighbor_ids,
        "neighbor_sims": index.neighbor_sims,
        "bin_ids": index.bin_ids,
    }
    if v2:
        data, wdata, indptr = postings_csr(_np(sp_index.postings_docs),
                                           _np(sp_index.postings_weights))
        arrays.update(sparse_postings_data=data, sparse_postings_wdata=wdata,
                      sparse_postings_indptr=indptr)
    else:
        arrays.update(sparse_postings_docs=sp_index.postings_docs,
                      sparse_postings_weights=sp_index.postings_weights)
    array_paths = {}
    with tr.span("arrays", n_arrays=len(arrays)):
        for name, arr in arrays.items():
            rel = f"{name}.npy"
            np.save(os.path.join(tmp, rel),
                    _np(arr).astype(_ARRAY_DTYPES[name], copy=False))
            array_paths[name] = rel

    pq_meta = None
    geometry = {"n_docs": index.n_docs, "dim": dim,
                "n_clusters": n_clusters, "cap": cap,
                "block_dtype": block_dtype}
    ranges = shard_ranges(n_clusters, n_shards)
    block_shards = []
    if v2:
        with tr.span("pq", nsub=int(pq_nsub)):
            the_pq, codes = _index_pq(index, embeddings, pq, pq_nsub,
                                      chunk_docs)
            geometry["nsub"] = int(the_pq.nsub)
            geometry["code_dtype"] = "uint8"
            pq_arrays = {"codebooks": the_pq.codebooks}
            if the_pq.rotation is not None:
                pq_arrays["rotation"] = the_pq.rotation
            pq_meta = _write_pq_arrays(tmp, pq_arrays, the_pq.nsub,
                                       dtype=np.float32)
        with tr.span("block_shards", n_shards=len(ranges)) as sp:
            for s, (lo, hi) in enumerate(ranges):
                rel = os.path.join("blocks", f"shard_{s:05d}.codes.bin")
                _write_code_blocks(os.path.join(tmp, rel), codes, cd[lo:hi])
                block_shards.append({"file": rel, "cluster_lo": lo,
                                     "cluster_hi": hi})
            sp.annotate(bytes=sum(
                os.path.getsize(os.path.join(tmp, b["file"]))
                for b in block_shards))
    else:
        scale = None
        if block_dtype == "int8":
            scale = _block_scale(embeddings, chunk_docs)
            geometry["block_scale"] = scale
        with tr.span("block_shards", n_shards=len(ranges)) as sp:
            for s, (lo, hi) in enumerate(ranges):
                rel = os.path.join("blocks", f"shard_{s:05d}.bin")
                _write_float_blocks(os.path.join(tmp, rel), embeddings,
                                    cd[lo:hi], block_dtype, chunk_docs,
                                    scale=scale)
                block_shards.append({"file": rel, "cluster_lo": lo,
                                     "cluster_hi": hi})
            sp.annotate(bytes=sum(
                os.path.getsize(os.path.join(tmp, b["file"]))
                for b in block_shards))
        # v1 carries the full PQ artifacts (codebooks + per-doc codes)
        # when the index has a quantizer
        if index.quantizer is not None:
            with tr.span("pq"):
                q = index.quantizer
                pq_arrays = {"codebooks": q.codebooks, "codes": q.codes}
                if q.rotation is not None:
                    pq_arrays["rotation"] = q.rotation
                pq_meta = _write_pq_arrays(tmp, pq_arrays, q.nsub)

    lstm_meta = None
    if index.selector is not None:
        with tr.span("lstm"):
            params = selector_params(index.selector)
            lstm_meta = {"dir": "lstm", "step": 0, "selector": "lstm",
                         "feat_dim": int(params["wx"].shape[0]),
                         "hidden": int(params["wh"].shape[0])}
            save_checkpoint(os.path.join(tmp, "lstm"), 0, params,
                            extra={k: lstm_meta[k]
                                   for k in ("selector", "feat_dim",
                                             "hidden")})

    files = fmt.scan_files(tmp)
    manifest = {
        "format_version": format_version,
        "kind": "clusd-index",
        "generation": int(generation),
        "parent_generation": None if parent_generation is None
        else int(parent_generation),
        "config": dataclasses.asdict(cfg),
        "geometry": geometry,
        "arrays": array_paths,
        "block_shards": block_shards,
        "lstm": lstm_meta,
        "pq": pq_meta,
        "stats": {
            "cluster_fill": _cluster_fill_stats(cd),
            "truncated_postings": int(getattr(sp_index,
                                              "truncated_postings", 0)),
            "pack_wall_s": round(time.perf_counter() - t0, 3),
        },
        "extra": extra or {},
        "files": files,
        "total_bytes": sum(e["bytes"] for e in files.values()),
    }
    with tr.span("commit"):
        fmt.write_manifest(tmp, manifest)
        # move any previous index aside first, so a crash in the window
        # never leaves out_dir without a readable index
        old = out_dir + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(out_dir):
            os.rename(out_dir, old)
        os.rename(tmp, out_dir)
        shutil.rmtree(old, ignore_errors=True)
    tr.finish(total_bytes=int(manifest["total_bytes"]))
    return manifest
