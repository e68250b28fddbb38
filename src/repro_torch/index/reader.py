"""IndexReader: open a built index directory (written by this package or
by the JAX package) and serve from it.

Opening is cheap: the manifest is validated (format version always; file
sizes by default; sha256 with verify="full"), per-index arrays are
np.load-ed with mmap_mode="r", and cluster blocks stay in their shard
files behind a sharded store. `load_index()` returns a CluSDIndex with
`embeddings=None` on the device; dense scoring reads only the selected
cluster blocks.

  format_version 1 — float block shards -> ShardedDiskStore ("dot" tail,
    kernel cluster_score)
  format_version 2 — PQ code shards -> ShardedPQStore (ADC tail, kernels
    adc_tables and adc_score_blocks); CSR postings re-padded at load

    reader = IndexReader.open("/path/to/index", verify="size")
    engine = reader.engine(max_batch=256)     # device=None: the CUDA card
    ids, scores = engine.retrieve(q_dense, q_terms, q_weights)
    engine.reload_index()                     # adopt a newer generation

`load_index()` also loads the index's quantizer, by default for v1 (its
pq/ codebooks and per-doc codes) and not for v2, as the JAX reader does:
`RetrievalEngine(*reader.load_index())` then serves a v1 directory from
the device PQStore (kernels adc_tables and adc_score_blocks), while
`engine()` and `open_store()` serve both formats through the sharded
stores (v2's host decode, `fetch_blocks`, gives float32 whatever the
manifest's block_dtype). `quantizer()` rebuilds a v2 index's per-doc
codes from its code shards, skipping tombstoned slots.
"""

import os

import numpy as np

from repro_torch.checkpoint import leaf_key, read_checkpoint
from repro_torch.configs import CluSDConfig
from repro_torch.convert import index_from_numpy, pq_from_numpy
from repro_torch.core.disk import IOStats
from repro_torch.index import format as fmt
from repro_torch.index.builder import postings_from_csr
from repro_torch.index.sharded import ShardedDiskStore, ShardedPQStore

LSTM_LEAVES = ("wx", "wh", "b", "head_w", "head_b")


class IndexReader:
    def __init__(self, index_dir, manifest):
        self.index_dir = os.path.abspath(index_dir)
        self.manifest = manifest
        self.geometry = manifest["geometry"]

    @classmethod
    def open(cls, index_dir, verify="size",
             supported=fmt.SUPPORTED_VERSIONS):
        """Validate and open. verify: "none" | "size" (default) | "full".
        `supported` narrows the format versions this reader accepts."""
        manifest = fmt.load_manifest(index_dir, supported=supported)
        fmt.verify_files(index_dir, manifest, level=verify)
        return cls(index_dir, manifest)

    @property
    def format_version(self):
        return self.manifest["format_version"]

    @property
    def is_pq(self):
        return self.format_version == fmt.FORMAT_VERSION_PQ

    @property
    def generation(self):
        """0 for a fresh build, +1 per committed delta or publish."""
        return fmt.manifest_generation(self.manifest)

    def refresh(self, verify="none"):
        """Re-read manifest.json and adopt a newer generation if one was
        committed since open. Returns True when the generation changed."""
        manifest = fmt.load_manifest(self.index_dir)
        if fmt.manifest_generation(manifest) == self.generation:
            return False
        fmt.verify_files(self.index_dir, manifest, level=verify)
        self.manifest = manifest
        self.geometry = manifest["geometry"]
        return True

    # -- raw artifacts ------------------------------------------------------

    def array(self, name):
        """Mmap a per-index array by logical name (no copy)."""
        rel = self.manifest["arrays"][name]
        return np.load(os.path.join(self.index_dir, rel), mmap_mode="r")

    def tombstones(self):
        """(n_clusters, cap) uint8 delete bitmap, or None."""
        if "tombstones" not in self.manifest["arrays"]:
            return None
        return np.asarray(self.array("tombstones"))

    def masked_cluster_docs(self):
        """cluster_docs with tombstoned slots masked to -1."""
        cd = np.asarray(self.array("cluster_docs"))
        tomb = self.tombstones()
        if tomb is None:
            return cd
        return np.where(tomb > 0, -1, cd)

    def config(self) -> CluSDConfig:
        d = dict(self.manifest["config"])
        d["bins"] = tuple(d["bins"])
        return CluSDConfig(**d)

    def selector_meta(self):
        """Selector-publish metadata, or None for a build's own selector."""
        return self.manifest.get("selector")

    def lstm_params(self):
        """{wx, wh, b, head_w, head_b} float32 numpy arrays from the
        manifest's LSTM checkpoint, or None."""
        meta = self.manifest["lstm"]
        if meta is None:
            return None
        leaves, _ = read_checkpoint(
            os.path.join(self.index_dir, meta["dir"]), meta["step"])
        missing = [k for k in LSTM_LEAVES if leaf_key(k) not in leaves]
        if missing:
            raise fmt.IndexFormatError(f"LSTM checkpoint misses {missing}")
        return {k: np.asarray(leaves[leaf_key(k)], np.float32)
                for k in LSTM_LEAVES}

    def _pq_array(self, name):
        rel = self.manifest["pq"]["arrays"].get(name)
        if rel is None:
            return None
        return np.load(os.path.join(self.index_dir, rel))

    def _doc_codes(self):
        """(n_docs, nsub) uint8 per-doc codes rebuilt from the v2 code
        shards (nsub bytes a doc); a tombstoned slot (a replaced doc's
        stale copy) is skipped."""
        g = self.geometry
        codes = np.zeros((g["n_docs"], g["nsub"]), np.uint8)
        cd = self.masked_cluster_docs()
        for s in self.manifest["block_shards"]:
            lo, hi = s["cluster_lo"], s["cluster_hi"]
            mm = np.memmap(os.path.join(self.index_dir, s["file"]),
                           dtype=np.uint8, mode="r",
                           shape=(hi - lo, g["cap"], g["nsub"]))
            local_cd = cd[lo:hi]
            mask = local_cd >= 0
            codes[local_cd[mask]] = mm[mask]
        return codes

    def _quantizer_arrays(self):
        """pq_from_numpy's keyword arguments (numpy), or None when the
        manifest has no PQ. v1 stores its per-doc codes under pq/; v2's
        are rebuilt from the code shards."""
        meta = self.manifest["pq"]
        if meta is None:
            return None
        codes = self._doc_codes().astype(np.int32) if self.is_pq \
            else self._pq_array("codes")
        return {"codebooks": self._pq_array("codebooks"), "codes": codes,
                "rotation": self._pq_array("rotation"),
                "nsub": meta["nsub"]}

    def quantizer(self, device=None):
        """The index's PQ (repro_torch.core.quant.PQ) on `device` (None:
        the CUDA card), or None when the manifest has none."""
        arrays = self._quantizer_arrays()
        return None if arrays is None else pq_from_numpy(**arrays,
                                                         device=device)

    # -- engine-level objects ----------------------------------------------

    def _sparse_arrays(self):
        """(postings_docs, postings_weights) padded; v2 re-pads its CSR."""
        if not self.is_pq:
            return (self.array("sparse_postings_docs"),
                    self.array("sparse_postings_weights"))
        return postings_from_csr(self.array("sparse_postings_data"),
                                 self.array("sparse_postings_wdata"),
                                 self.array("sparse_postings_indptr"))

    def load_index(self, load_quantizer=None, device=None):
        """(cfg, CluSDIndex) with embeddings=None, its tensors on `device`
        (None: the CUDA card); blocks stay on disk (serve through
        `open_store()` / `engine()`).

        load_quantizer: None (default) loads the PQ for v1 (it sits in
        pq/*.npy) and not for v2, where rebuilding the per-doc codes reads
        every code shard; True forces it (device-side ADC over a v2
        index), False skips it."""
        if load_quantizer is None:
            load_quantizer = not self.is_pq
        pd, pw = self._sparse_arrays()
        arrays = {name: self.array(name)
                  for name in ("centroids", "doc_cluster", "neighbor_ids",
                               "neighbor_sims", "bin_ids")}
        arrays.update(cluster_docs=self.masked_cluster_docs(),
                      sparse_postings_docs=pd, sparse_postings_weights=pw,
                      n_docs=self.geometry["n_docs"],
                      lstm_params=self.lstm_params(),
                      quantizer=self._quantizer_arrays() if load_quantizer
                      else None)
        return self.config(), index_from_numpy(arrays, device=device)

    def n_block_shards(self):
        return len(self.manifest["block_shards"])

    def open_store(self, cluster_docs=None, stats: IOStats = None,
                   shards=None):
        """Sharded store over the block shard files (mmap, read-only):
        ShardedDiskStore for v1, ShardedPQStore for v2. The generation's
        tombstones are handed to the store, which masks deleted slots.

        `shards`: optional shard indices (into the manifest's block_shards)
        to open a subset store over; fetching a cluster outside the
        subset raises."""
        g = self.geometry
        all_shards = self.manifest["block_shards"]
        if shards is None:
            shards = all_shards
        else:
            idx = sorted(set(int(s) for s in shards))
            if not idx or idx[0] < 0 or idx[-1] >= len(all_shards):
                raise ValueError(f"shard subset {idx} out of range for "
                                 f"{len(all_shards)} block shards")
            shards = [all_shards[i] for i in idx]
        paths = [os.path.join(self.index_dir, s["file"]) for s in shards]
        ranges = [(s["cluster_lo"], s["cluster_hi"]) for s in shards]
        tomb = self.tombstones()
        if cluster_docs is None:
            cluster_docs = self.array("cluster_docs")
        elif hasattr(cluster_docs, "detach"):
            cluster_docs = cluster_docs.detach().cpu().numpy()
        if self.is_pq:
            return ShardedPQStore(
                paths, ranges, g["cap"], self._pq_array("codebooks"),
                cluster_docs, rotation=self._pq_array("rotation"),
                out_dtype=g["block_dtype"], tombstones=tomb,
                stats=stats)
        return ShardedDiskStore(
            paths, ranges, g["cap"], g["dim"], cluster_docs,
            dtype=g["block_dtype"], block_scale=g.get("block_scale"),
            tombstones=tomb, stats=stats)

    def engine(self, cfg=None, index=None, device=None, **engine_kw):
        """RetrievalEngine serving this index through the sharded store on
        `device` (None: the CUDA card). The engine keeps this reader, so
        `engine.reload_index()` hot-swaps to a newer generation."""
        from repro_torch.engine.server import RetrievalEngine
        if index is None:
            loaded_cfg, index = self.load_index(device=device)
            cfg = cfg or loaded_cfg
        cfg = cfg if cfg is not None else self.config()
        store = self.open_store(cluster_docs=index.cluster_docs)
        return RetrievalEngine(cfg, index, store=store, reader=self,
                               device=device, **engine_kw)
