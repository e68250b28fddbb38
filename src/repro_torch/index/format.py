"""Versioned on-disk index layout, the read side and the manifest writers
(a copy of the JAX package's `repro.index.format`: the same constants,
schema, version negotiation and integrity checks, so either package
opens the other's directories).

A built index is one directory:

  <index_dir>/
    manifest.json                   # the single source of truth
    centroids.npy ...               # small per-index arrays
    blocks/shard_00000.bin ...      # v1 float blocks, raw (hi-lo, cap, dim)
    blocks/shard_00000.codes.bin    # v2 PQ codes, raw (hi-lo, cap, nsub) u8
    lstm/step_0/...                 # selector weights (repro_torch.checkpoint)
    pq/codebooks.npy ...            # PQ artifacts

format_version 1 holds float block shards, in float32, bfloat16 or int8
(`geometry.block_dtype`; int8 also needs `geometry.block_scale`, and a
record decodes as `record * block_scale`). format_version 2 holds PQ code
shards and CSR-compacted sparse postings. Generations: 0 for a fresh
build, +1 per committed delta or selector publish; older manifests are
archived under `manifests/manifest.g<g>.json`, and `arrays.tombstones`
marks deleted slots.

bfloat16 needs no ml_dtypes here: a bfloat16 record is read as uint16
(`record_dtype`) and widened by hand (`bf16_bits_to_f32`), and the writer
rounds float32 to bfloat16 bits to nearest even (`f32_to_bf16_bits`),
as ml_dtypes does.

Integrity levels (IndexReader.open(verify=...)):
  "none" — trust the manifest
  "size" — every listed file exists with the exact byte size (default)
  "full" — additionally sha256 every file
"""

import hashlib
import json
import os
import shutil

import numpy as np

FORMAT_VERSION = 1            # float block shards
FORMAT_VERSION_PQ = 2         # PQ code shards + CSR postings
SUPPORTED_VERSIONS = (FORMAT_VERSION, FORMAT_VERSION_PQ)
MANIFEST_NAME = "manifest.json"
MANIFEST_HISTORY_DIR = "manifests"
VERIFY_LEVELS = ("none", "size", "full")

# v1 float-shard record dtypes, and the numpy dtype each is stored as
BLOCK_DTYPES_V1 = ("float32", "bfloat16", "int8")
_RECORD_DTYPES = {"float32": np.float32, "bfloat16": np.uint16,
                  "int8": np.int8}


class IndexFormatError(ValueError):
    """Manifest missing/unreadable, wrong version, or malformed layout."""


class IndexChecksumError(IndexFormatError):
    """An artifact file is missing, truncated, or fails its checksum."""


def resolve_block_dtype(name):
    """geometry.block_dtype (a name or a numpy dtype) -> its canonical name
    in BLOCK_DTYPES_V1. An unknown dtype means an index newer than this
    reader: raise rather than misread raw shard bytes."""
    if not isinstance(name, str):
        name = np.dtype(name).name
    if name not in BLOCK_DTYPES_V1:
        raise IndexFormatError(
            f"block_dtype {name!r} unsupported (reader speaks "
            f"{BLOCK_DTYPES_V1}); upgrade the reader")
    return name


def record_dtype(name):
    """The numpy dtype a v1 shard record of `block_dtype` is stored as
    (bfloat16 records are read as raw uint16 bits)."""
    return np.dtype(_RECORD_DTYPES[resolve_block_dtype(name)])


def bf16_bits_to_f32(bits):
    """uint16 bfloat16 bit patterns -> float32 (exact: a bfloat16 is the
    high half of a float32)."""
    bits = np.asarray(bits, np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x):
    """float32 -> uint16 bfloat16 bits, rounded to nearest even (NaN stays
    a quiet NaN of the same sign), bit for bit what ml_dtypes gives."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    out = np.where(nan, (u >> 16) | 0x40, rounded)
    return out.astype(np.uint16)


def file_sha256(path, chunk_bytes=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def scan_files(root):
    """{relpath: {bytes, sha256}} over every file under `root` except the
    manifest itself. Called after all artifacts are written."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel == MANIFEST_NAME:
                continue
            out[rel] = {"bytes": os.path.getsize(full),
                        "sha256": file_sha256(full)}
    return out


def write_manifest(index_dir, manifest):
    with open(os.path.join(index_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def manifest_generation(manifest):
    """Generation of a parsed manifest; pre-generation manifests are 0."""
    return int(manifest.get("generation", 0))


def archive_manifest(index_dir, manifest):
    """Keep the CURRENT manifest as manifests/manifest.g<g>.json, so its
    generation stays readable after a newer one replaces manifest.json."""
    hist = os.path.join(index_dir, MANIFEST_HISTORY_DIR)
    os.makedirs(hist, exist_ok=True)
    path = os.path.join(hist,
                        f"manifest.g{manifest_generation(manifest)}.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return path


def commit_manifest(index_dir, manifest):
    """Atomically replace manifest.json (write to a temp file, fsync,
    os.replace): a racing reader sees the old or the new generation."""
    final = os.path.join(index_dir, MANIFEST_NAME)
    tmp = final + f".tmp-g{manifest_generation(manifest)}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def commit_generation(index_dir, stage, staged, old_manifest, new_manifest):
    """The one tail of every generation commit: move the staged files
    (relpaths `staged` under `stage`) into place under their
    generation-suffixed names, archive the current manifest, atomically
    flip manifest.json, and drop the stage directory."""
    for rel in staged:
        dst = os.path.join(index_dir, rel)
        os.makedirs(os.path.dirname(dst) or index_dir, exist_ok=True)
        os.replace(os.path.join(stage, rel), dst)
    archive_manifest(index_dir, old_manifest)
    commit_manifest(index_dir, new_manifest)
    shutil.rmtree(stage, ignore_errors=True)


def load_manifest(index_dir, supported=SUPPORTED_VERSIONS, generation=None):
    """Parse and version-check the manifest. `supported` restricts the
    format versions this reader speaks (`supported=(1,)` rejects v2).
    `generation=None` loads manifest.json; an int loads that archived
    generation from manifests/."""
    path = os.path.join(index_dir, MANIFEST_NAME)
    if generation is not None:
        current = load_manifest(index_dir, supported=supported)
        if manifest_generation(current) == int(generation):
            return current
        path = os.path.join(index_dir, MANIFEST_HISTORY_DIR,
                            f"manifest.g{int(generation)}.json")
        if not os.path.isfile(path):
            raise IndexFormatError(
                f"generation {generation} not found in {index_dir} "
                f"(current is {manifest_generation(current)}; older "
                f"generations are dropped by compaction)")
    if not os.path.isfile(path):
        raise IndexFormatError(f"no {MANIFEST_NAME} in {index_dir}")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise IndexFormatError(f"unreadable manifest in {index_dir}: {e}")
    version = manifest.get("format_version")
    if version not in supported:
        raise IndexFormatError(
            f"index format version {version!r} unsupported "
            f"(reader speaks {tuple(supported)}); rebuild the index or "
            f"upgrade the reader")
    if manifest.get("kind") != "clusd-index":
        raise IndexFormatError(
            f"not a clusd-index: kind={manifest.get('kind')!r}")
    return manifest


def verify_files(index_dir, manifest, level="size"):
    """Check every artifact listed in manifest['files'] at the given level.
    Raises IndexChecksumError naming the first bad file."""
    if level not in VERIFY_LEVELS:
        raise ValueError(f"verify level {level!r} not in {VERIFY_LEVELS}")
    if level == "none":
        return
    files = manifest.get("files") or {}
    if not files:
        raise IndexFormatError("manifest lists no artifact checksums "
                               "('files' missing/empty) — cannot verify")
    referenced = list(manifest.get("arrays", {}).values()) + \
        [s["file"] for s in manifest.get("block_shards", [])]
    for rel in referenced:
        if rel.replace("/", os.sep) not in files and rel not in files:
            raise IndexFormatError(f"artifact {rel} has no checksum entry")
    for rel, entry in files.items():
        full = os.path.join(index_dir, rel)
        if not os.path.isfile(full):
            raise IndexChecksumError(f"missing artifact: {rel}")
        size = os.path.getsize(full)
        if size != entry["bytes"]:
            raise IndexChecksumError(
                f"{rel}: size {size} != manifest {entry['bytes']} "
                f"(truncated?)")
        if level == "full" and file_sha256(full) != entry["sha256"]:
            raise IndexChecksumError(f"{rel}: sha256 mismatch (corrupted)")
