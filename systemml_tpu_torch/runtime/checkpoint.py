"""Program-level checkpoint/resume: symbol-table snapshots.

Port of systemml_tpu/runtime/checkpoint.py: the same on-disk protocol
(a pointer file naming a data directory, arrays in one .npz), so a
snapshot written by either package loads in the other. Restored arrays
land on the configured device as torch tensors; the fault-injection site
of `commit_dir` waits for ROADMAP queue 1, distributed and elastic
(`fault_injection`).

The genuinely TPU-native subsystem the reference lacks (SURVEY §5): the
reference's "checkpoint" is only Spark RDD persistence injected before
loops (hops/rewrite/RewriteInjectSparkLoopCheckpointing.java +
CheckpointSPInstruction MEM_AND_DISK); if its main process dies, the run is
gone. Here a checkpoint is a durable snapshot of the live symbol table —
matrices, scalars — written atomically, so a long training loop can
resume after preemption (the normal failure mode on TPU pods):

    if (checkpointExists($ckpt)) {
      restore($ckpt)
    } else {
      i = 0; W = ...init...
    }
    while (i < maxiter) {
      ...update W...
      i = i + 1
      if (i %% 50 == 0) { checkpoint($ckpt) }
    }

Atomicity: snapshot data writes to a fresh `<path>.d-<nonce>` directory,
then a tiny POINTER FILE at `<path>` is atomically replaced
(os.replace) to name it — there is no instant at which `<path>` is
missing or names incomplete data, so a SIGKILL at ANY point leaves the
previous good snapshot loadable (preemption is the failure mode this
module exists to survive). Stale data dirs are removed after the
pointer moves. Arrays persist as one .npz; restore places them on the
current default device (sharded multi-host checkpointing via orbax is
the natural extension point — save/load are deliberately
pytree-shaped for it).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional, Tuple

_META = "snapshot.json"
_ARRAYS = "arrays.npz"


def _split(env: Dict[str, Any]) -> Tuple[Dict, Dict, Dict]:
    """(arrays, sparse, scalars) of the snapshot-able subset of a symbol
    table. Sparse matrices persist as their CSR components (never
    densified); compressed blocks snapshot dense (their dictionaries are
    derived state)."""
    import numpy as np

    import torch

    from systemml_tpu_torch.compress import is_compressed
    from systemml_tpu_torch.runtime.bufferpool import resolve
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    arrays: Dict[str, Any] = {}
    sparse: Dict[str, Any] = {}
    scalars: Dict[str, Any] = {}
    for name, v in env.items():
        if name.startswith("__"):
            continue
        v = resolve(v)
        if isinstance(v, SparseMatrix):
            sparse[name] = v
        elif is_compressed(v):
            arrays[name] = v.to_numpy()
        elif isinstance(v, torch.Tensor):
            arrays[name] = v.detach().cpu().numpy()
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            arrays[name] = np.asarray(v)
        elif isinstance(v, (bool, int, float, str)):
            scalars[name] = v
        # frames/lists/functions are not snapshotted (reference parity:
        # checkpoints cover numeric state)
    return arrays, sparse, scalars


def _data_dir(path: str) -> Optional[str]:
    """Directory the pointer file at `path` names, or None."""
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        d = f.read().strip()
    full = os.path.join(os.path.dirname(os.path.abspath(path)), d)
    return full if os.path.isfile(os.path.join(full, _META)) else None


def commit_dir(path: str, write) -> str:
    """Crash-atomic directory commit — the shared protocol under both
    the program-level snapshots here and, once ported, the elastic
    sharded-checkpoint manager. ``write(ddir)`` fills a
    fresh data directory (it must include a ``snapshot.json``); then
    the pointer file at `path` is atomically replaced to name it.
    There is no instant at which `path` is missing or names incomplete
    data, so a SIGKILL at ANY point leaves the previous good snapshot
    loadable. Returns the committed data-dir path."""
    base = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(base, exist_ok=True)
    dname = f"{os.path.basename(path)}.d-{uuid.uuid4().hex[:8]}"
    ddir = os.path.join(base, dname)
    os.makedirs(ddir)
    try:
        write(ddir)
        old = _data_dir(path)
        ptr_tmp = os.path.join(base, f".{dname}.ptr")
        with open(ptr_tmp, "w") as f:
            f.write(dname)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, path)          # the atomic commit point
    except BaseException:
        shutil.rmtree(ddir, ignore_errors=True)
        raise
    # sweep: only the dir we just superseded, plus orphans older than a
    # grace period.  Sweeping EVERY non-pointed dir would race a second
    # concurrent saver (its in-flight dir could be deleted before its
    # pointer commit, leaving the pointer dangling); age-gating keeps
    # in-flight dirs safe while still reclaiming dirs from killed saves.
    prefix = f"{os.path.basename(path)}.d-"
    grace = 3600.0  # seconds; killed-save orphans only, never in-flight
    now = time.time()
    for entry in os.listdir(base):
        if not entry.startswith(prefix) or entry == dname:
            continue
        p = os.path.join(base, entry)
        if entry == (old and os.path.basename(old)):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                if now - os.path.getmtime(p) > grace:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass
    return ddir


def save_snapshot(env: Dict[str, Any], path: str) -> None:
    """Write a crash-atomic snapshot; `path` becomes a pointer file."""
    import numpy as np

    arrays, sparse, scalars = _split(env)

    def write(ddir: str) -> None:
        payload = dict(arrays)
        sparse_meta = {}
        for name, sm in sparse.items():
            payload[f"__csr_ip__{name}"] = sm.indptr.cpu().numpy()
            payload[f"__csr_ix__{name}"] = sm.indices.cpu().numpy()
            payload[f"__csr_d__{name}"] = sm.data.detach().cpu().numpy()
            sparse_meta[name] = list(sm.shape)
        if payload:
            np.savez(os.path.join(ddir, _ARRAYS), **payload)
        with open(os.path.join(ddir, _META), "w") as f:
            json.dump({"version": 1, "scalars": scalars,
                       "array_names": sorted(arrays),
                       "sparse": sparse_meta}, f)

    commit_dir(path, write)


def snapshot_exists(path: str) -> bool:
    return _data_dir(path) is not None


def load_snapshot(path: str) -> Dict[str, Any]:
    """Load a snapshot into a plain {name: value} dict; arrays come back
    as tensors on the configured device."""
    import numpy as np
    import torch

    from systemml_tpu_torch.utils.config import get_config

    dev = torch.device(get_config().device)

    ddir = _data_dir(path)
    if ddir is None:
        raise FileNotFoundError(f"no snapshot at {path!r}")
    with open(os.path.join(ddir, _META)) as f:
        meta = json.load(f)
    out: Dict[str, Any] = dict(meta["scalars"])
    sparse_meta = meta.get("sparse", {})
    if meta["array_names"] or sparse_meta:
        from systemml_tpu_torch.runtime.sparse import SparseMatrix

        with np.load(os.path.join(ddir, _ARRAYS)) as z:
            for name in meta["array_names"]:
                out[name] = torch.from_numpy(np.array(z[name])).to(dev)
            for name, shape in sparse_meta.items():
                out[name] = SparseMatrix(
                    z[f"__csr_ip__{name}"], z[f"__csr_ix__{name}"],
                    torch.from_numpy(np.array(z[f"__csr_d__{name}"])).to(dev),
                    tuple(shape))
    return out
