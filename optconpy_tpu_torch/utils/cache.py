"""Checkpoint/resume via npz artifacts keyed by config hash.

Counterpart of optconpy_tpu/utils/cache.py: expensive artifacts (the
per-timestep gains, inverse stacks) are cached on disk keyed by (config
hash, artifact name); a rerun of the same config loads the artifact
instead of recomputing it. Arrays live in one compressed npz per
artifact; scipy sparse matrices are stored as their CSR arrays.

Both packages hash a config the same way and default to the same
directory, so this package salts its filenames with "torch-v<version>":
neither package ever loads the other's artifacts.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np


def cache_root(cache_dir=None) -> Path:
    """cache_dir, else $OPTCONPY_TPU_CACHE, else ./data (read per call)."""
    return Path(
        cache_dir
        or os.environ.get("OPTCONPY_TPU_CACHE")
        or os.path.join(os.getcwd(), "data")
    )


def code_salt() -> str:
    """Package and version folded into every artifact filename: bump
    __version__ when numerics change and stale artifacts miss."""
    from .. import __version__

    return "torch-v" + __version__.replace(".", "_")


def _artifact_path(key: str, name: str, cache_dir) -> Path:
    return cache_root(cache_dir) / f"{key}-{code_salt()}__{name}.npz"


def save_arrays(key: str, name: str, arrays: dict, cache_dir=None) -> Path:
    """Atomically save a dict of numpy arrays."""
    path = _artifact_path(key, name, cache_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)  # atomic: partial writes never corrupt
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_arrays(key: str, name: str, cache_dir=None) -> dict | None:
    """Load a cached artifact, or None if absent."""
    path = _artifact_path(key, name, cache_dir)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_or_comp(key: str, name: str, compute, cache_dir=None) -> dict:
    """Return the cached artifact for (key, name), computing and saving
    it on a miss. compute: () -> dict[str, array-like]."""
    cached = load_arrays(key, name, cache_dir)
    if cached is not None:
        return cached
    arrays = {k: np.asarray(v) for k, v in compute().items()}
    save_arrays(key, name, arrays, cache_dir)
    return arrays


def save_csr(mat) -> dict:
    """Encode a scipy CSR matrix as plain arrays for npz storage."""
    m = mat.tocsr()
    return {
        "data": m.data,
        "indices": m.indices,
        "indptr": m.indptr,
        "shape": np.asarray(m.shape),
    }


def load_csr(arrays: dict):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (arrays["data"], arrays["indices"], arrays["indptr"]),
        shape=tuple(arrays["shape"]),
    )


def write_meta(key: str, meta: dict, cache_dir=None) -> Path:
    """Store the run's config JSON next to its artifacts."""
    d = cache_root(cache_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{key}__meta.json"
    path.write_text(json.dumps(meta, indent=2, sort_keys=True))
    return path
