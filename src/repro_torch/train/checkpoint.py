"""Atomic checkpointing with verified restore.

The PyTorch port of the reference's ``repro/train/checkpoint.py``, with
its files and names.  A checkpoint holds nested dicts of tensors (the
trainer passes its parameters in the reference's tree,
``models/convert.py::params_to_tree``), gathered to host numpy and written
as a flat npz keyed by tree path (``embed/tokens``, ``layers/attn/wq``
stacked (L, ...), ``m/...``, ``v/...``, ``step``), in the sorted key order
``jax.tree_util`` flattens dicts in, plus a JSON manifest and an
``integrity.json`` sidecar (byte length + sha256 of every payload file).
Non-native dtypes (bfloat16, fp8: npz cannot hold them) are stored as uint
views of the same width, their dtype recorded in the manifest.  A
checkpoint written by either package restores in the other.

The whole step dir is staged in a tmp dir and renamed into place, so a
crash mid-save never corrupts the latest checkpoint — and because the
sidecar is written *inside* the tmp dir before the rename, a step dir
either carries a complete, self-consistent integrity record or does not
exist.

``restore(step=None)`` verifies before trusting: it walks steps newest
first and restores the newest one whose sidecar checks out, so the
fault-tolerance layer (``run_with_restarts``) survives a checkpoint
corrupted mid-write by the very crash that triggered the restart.
Skipped steps are reported via ``warnings`` and recorded for the chaos
harness by :func:`latest_verified_step`.  Leaves are stored unsharded, so
a checkpoint restores under any shard layout.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faultpoints import fault_point
from repro_torch.kernels.local import is_dtensor

INTEGRITY_NAME = "integrity.json"

# Dtypes npz cannot hold, stored as uint views: the manifest's name of
# each and its torch dtype.
_VIEWED = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
           torch.float8_e5m2: "float8_e5m2"}
_VIEWED_BY_NAME = {name: dt for dt, name in _VIEWED.items()}
_UINT = {1: torch.uint8, 2: torch.uint16}


class CheckpointCorruptError(RuntimeError):
    """No usable checkpoint: the requested (or every) step fails integrity
    verification.  ``failures`` maps step -> reason."""

    def __init__(self, ckpt_dir: str, failures: Dict[int, str]):
        self.ckpt_dir = ckpt_dir
        self.failures = dict(failures)
        detail = "; ".join(f"step {s}: {r}"
                           for s, r in sorted(failures.items()))
        super().__init__(
            f"{ckpt_dir}: no checkpoint passed integrity verification "
            f"({detail or 'none present'})")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict in sorted key order, paths joined by
    "/" (``jax.tree_util``'s flattening of the same dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Flatten to npz-safe arrays; ``dtypes`` records the original dtype
    of each key stored as a uint view."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in _leaves(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype in _VIEWED:
            dtypes[key] = _VIEWED[t.dtype]
            t = t.view(_UINT[t.element_size()])
        arrays[key] = t.numpy()
    return arrays, dtypes


def _file_digest(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


def _has_dtensors(trees: Dict[str, Any]) -> bool:
    return any(is_dtensor(leaf) for tree in trees.values()
               for _, leaf in _leaves(tree))


def save(ckpt_dir: str, step: int, trees: Dict[str, Any],
         meta: Optional[Dict] = None, keep: int = 3) -> str:
    """trees: {"params": ..., "opt_state": ...}, nested dicts of tensors
    (or numpy arrays).  Returns the step dir.  Trees of DTensors (a
    sharded run) are saved whole, the same bytes as unsharded ones: every
    rank must call this, and rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if _has_dtensors(trees):
        # saved under a mesh: every rank gathers the full tensors (a
        # collective), rank 0 writes the reference's bytes, and the others
        # wait for it
        import torch.distributed as dist
        trees = {name: _unflatten(tree, {k: leaf.full_tensor()
                                         if is_dtensor(leaf) else leaf
                                         for k, leaf in _leaves(tree)})
                 for name, tree in trees.items()}
        if dist.get_rank() == 0:
            save(ckpt_dir, step, trees, meta, keep)
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        fault_point("ckpt.pre_write")
        all_dtypes: Dict[str, Dict[str, str]] = {}
        for name, tree in trees.items():
            arrays, dtypes = _flatten(tree)
            np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
            all_dtypes[name] = dtypes
        fault_point("ckpt.arrays_written")
        manifest = {"step": int(step), "trees": sorted(trees),
                    "dtypes": all_dtypes, "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        fault_point("ckpt.manifest_written")
        integrity = {}
        for fname in sorted(os.listdir(tmp)):
            digest, nbytes = _file_digest(os.path.join(tmp, fname))
            integrity[fname] = {"sha256": digest, "bytes": nbytes}
        with open(os.path.join(tmp, INTEGRITY_NAME), "w") as f:
            json.dump({"step": int(step), "files": integrity}, f)
        fault_point("ckpt.sidecar_written")
        if os.path.exists(final):
            # Never a delete-then-rename hole: the old step dir is moved
            # aside first, so a crash between the two renames demotes the
            # step (restore falls back) instead of losing old AND new.
            trash = tempfile.mkdtemp(dir=ckpt_dir, prefix=".gc_")
            os.rename(final, os.path.join(trash, "old"))
            os.rename(tmp, final)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, final)
        fault_point("ckpt.renamed")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # Residue of crashed saves: stale staging/trash dirs a hard kill left
    # behind.  They are invisible to latest_step/restore (no step_ prefix)
    # and reaped here, on the next successful save.
    for d in os.listdir(ckpt_dir):
        if d.startswith((".tmp_", ".gc_")):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d[len("step_"):]))
    return max(steps) if steps else None


def verify_step(ckpt_dir: str, step: int) -> Optional[str]:
    """Integrity-check one step dir against its sidecar.

    Returns None when intact, else the failure reason.  A legacy step dir
    without a sidecar (pre-integrity format) verifies by presence of its
    manifest alone — absence of evidence of corruption, accepted for
    back-compat."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    if not os.path.isdir(d):
        return "missing step dir"
    if not os.path.exists(os.path.join(d, "manifest.json")):
        return "missing manifest.json"
    sidecar = os.path.join(d, INTEGRITY_NAME)
    if not os.path.exists(sidecar):
        return None          # legacy checkpoint: no integrity record
    try:
        with open(sidecar) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable integrity sidecar: {e}"
    for fname, rec in sorted(doc.get("files", {}).items()):
        path = os.path.join(d, fname)
        if not os.path.exists(path):
            return f"{fname}: missing"
        size = os.path.getsize(path)
        if size != rec["bytes"]:
            return f"{fname}: length {size} != recorded {rec['bytes']}"
        digest, _ = _file_digest(path)
        if digest != rec["sha256"]:
            return f"{fname}: sha256 mismatch"
    return None


def latest_verified_step(ckpt_dir: str
                         ) -> Tuple[Optional[int], List[Dict[str, Any]]]:
    """Newest step that passes :func:`verify_step`, plus the record of
    newer steps that were skipped (``[{step, reason}, ...]`` — the
    fallback trail the chaos harness asserts on)."""
    if not os.path.isdir(ckpt_dir):
        return None, []
    steps = sorted((int(d[len("step_"):])
                    for d in os.listdir(ckpt_dir) if d.startswith("step_")),
                   reverse=True)
    skipped: List[Dict[str, Any]] = []
    for step in steps:
        reason = verify_step(ckpt_dir, step)
        if reason is None:
            return step, skipped
        skipped.append({"step": step, "reason": reason})
    return None, skipped


def _unflatten(template: Any, data: Dict[str, torch.Tensor],
               prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], data, f"{prefix}{k}/")
                for k in template}
    return data[prefix[:-1]]


def _torch_dtype(leaf: Any) -> torch.dtype:
    """The torch dtype of a template leaf (a tensor or a numpy array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, dtype=leaf.dtype)).dtype


def restore(ckpt_dir: str, templates: Dict[str, Any],
            step: Optional[int] = None,
            shardings: Optional[Dict[str, Any]] = None
            ) -> Tuple[int, Dict[str, Any]]:
    """Restore trees shaped like ``templates`` (nested dicts whose leaves
    give each shape and dtype; a template on the ``meta`` device costs no
    memory), as tensors on the host.  ``shardings`` (per tree, nested
    dicts matching the template whose leaves are ``(mesh, placements)``)
    restores those trees as DTensors: every rank reads the whole file
    and keeps its own shards — the elastic re-mesh path.

    With ``step=None`` the newest *verified* checkpoint is restored:
    steps failing integrity verification are skipped (warned about, and
    reported by :func:`latest_verified_step`) so a crash that tore the
    latest save falls back instead of failing the restart.  An explicitly
    requested step that fails verification raises
    :class:`CheckpointCorruptError` — the caller named a specific state
    and must not silently get another."""
    if step is not None:
        reason = verify_step(ckpt_dir, step)
        if reason is not None:
            raise CheckpointCorruptError(ckpt_dir, {step: reason})
    else:
        if latest_step(ckpt_dir) is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        step, skipped = latest_verified_step(ckpt_dir)
        if step is None:
            raise CheckpointCorruptError(
                ckpt_dir, {s["step"]: s["reason"] for s in skipped})
        if skipped:
            warnings.warn(
                f"{ckpt_dir}: fell back to verified step {step}; skipped "
                + ", ".join(f"step {s['step']} ({s['reason']})"
                            for s in skipped), RuntimeWarning)
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {}
    for name, template in templates.items():
        dtypes = manifest.get("dtypes", {}).get(name, {})
        data: Dict[str, torch.Tensor] = {}
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            files = set(z.files)
            for key, leaf in _leaves(template):
                if key not in files:
                    raise KeyError(f"{name}:{key} not in the checkpoint")
                t = torch.from_numpy(np.array(z[key]))
                if key in dtypes:
                    t = t.view(_VIEWED_BY_NAME[dtypes[key]])
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"{name}:{key} shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(leaf.shape)}")
                data[key] = t.to(_torch_dtype(leaf))
        if shardings and name in shardings:
            from repro_torch.sharding import distribute
            sh = dict(_leaves(shardings[name]))
            data = {k: distribute(t, sh[k]) for k, t in data.items()}
        out[name] = _unflatten(template, data)
    return step, out
