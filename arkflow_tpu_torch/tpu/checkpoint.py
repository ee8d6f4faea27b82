"""Model checkpoint save and restore, torch-native.

Counterpart of ``arkflow_tpu/tpu/checkpoint.py``, which wraps orbax; the
card's machine has no orbax, so the port keeps its own format:

- A checkpoint is a directory holding one ``torch.save`` of a flat
  ``{keystr: tensor}`` map (``params.pt``). The keys are the JAX package's
  ``keystr`` paths, e.g. ``['encoder']['layers']['wq']``; the tensors keep
  their dtypes and strides (the column-major int8 ``w_q`` stays so). It is
  read with ``torch.load(..., weights_only=True, map_location="cpu")``.
- Beside it lies ``<path>.digests.json``, the digest manifest, with the
  name and JSON layout of the JAX package's (one blake2b-128 per leaf,
  ``tpu/integrity.py``).

There is no orbax interchange: the port cannot read an orbax tree and the
JAX package cannot read a port checkpoint. What carries over is the
manifest: the same params give the same digests in both packages.

The discipline is the JAX package's:

- ``save`` is crash-atomic: the map is written and synced into a hidden
  temp sibling directory, which is renamed into place; an existing
  checkpoint is renamed aside first and deleted after. Stale siblings of
  crashed saves (any pid) are removed first. The manifest is dropped
  before the flip and written after it, so a crash leaves a tree without a
  manifest (restored unverified), never one with the wrong manifest.
- ``restore`` raises ``ConfigError`` for a missing path, an unreadable or
  truncated file, and a structure or shape mismatch, naming the offending
  leaves. With a manifest beside the tree (and ``verify``), the leaves as
  loaded are hashed against it, and a drift names the leaves. Each leaf is
  then laid out as the ``like`` leaf: its dtype and its strides (a leaf
  loaded so already is kept as loaded, not copied: a Llama-3-8B tree is
  16 GB).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.tpu.integrity import diff_digests, flatten, keystr, leaf_digests

#: digest-manifest sibling suffix (a file next to the checkpoint directory)
_MANIFEST_SUFFIX = ".digests.json"
#: the file inside a checkpoint directory
PARAMS_FILE = "params.pt"


def _manifest_path(p: Path) -> Path:
    return p.parent / f"{p.name}{_MANIFEST_SUFFIX}"


def _tmp_sibling(p: Path, tag: str) -> Path:
    """Hidden sibling on the same filesystem (a rename must not cross
    devices), pid-suffixed so savers to different paths never collide."""
    return p.parent / f".{p.name}.{tag}-{os.getpid()}"


def _clean_stale_siblings(p: Path) -> None:
    """Remove the temp and old siblings crashed saves of this path left."""
    for pattern in (f".{p.name}.tmp-*", f".{p.name}.old-*"):
        for stale in p.parent.glob(pattern):
            shutil.rmtree(stale, ignore_errors=True)
    for stale in p.parent.glob(f".{p.name}{_MANIFEST_SUFFIX}.tmp-*"):
        stale.unlink(missing_ok=True)


def save(path: str, params: dict) -> None:
    """Write ``params`` (a nested dict of tensors, on any device) to
    ``path`` atomically, with its digest manifest beside it."""
    p = Path(path).absolute()
    p.parent.mkdir(parents=True, exist_ok=True)
    _clean_stale_siblings(p)
    flat = {k: v.detach().cpu() for k, v in flatten(params).items()}
    digests = leaf_digests(flat)
    manifest = _manifest_path(p)
    manifest.unlink(missing_ok=True)
    tmp = _tmp_sibling(p, "tmp")
    tmp.mkdir()
    with open(tmp / PARAMS_FILE, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())
    if p.exists():
        old = _tmp_sibling(p, "old")
        if old.exists():
            shutil.rmtree(old)
        os.rename(p, old)
        os.rename(tmp, p)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, p)
    mtmp = manifest.parent / f".{manifest.name}.tmp-{os.getpid()}"
    mtmp.write_text(json.dumps({"digests": digests}, indent=0))
    os.rename(mtmp, manifest)


def _mismatch(saved: set, want: set) -> str:
    missing, extra = sorted(want - saved), sorted(saved - want)
    parts = []
    if missing:
        parts.append("model expects leaves the checkpoint lacks: "
                     f"{missing[:3]}{'...' if len(missing) > 3 else ''}")
    if extra:
        parts.append("checkpoint holds leaves the model lacks: "
                     f"{extra[:3]}{'...' if len(extra) > 3 else ''}")
    return "; ".join(parts)


def _unflatten_like(like: dict, flat: dict, path: tuple = ()) -> dict:
    out = {}
    for k, v in like.items():
        if isinstance(v, dict):
            out[k] = _unflatten_like(v, flat, (*path, k))
            continue
        saved = flat[keystr((*path, k))]
        if saved.dtype == v.dtype and saved.stride() == v.stride():
            out[k] = saved  # already laid out as the model's leaf
            continue
        leaf = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype)
        leaf.copy_(saved)
        out[k] = leaf
    return out


def restore(path: str, like_params: dict, *, verify: bool = True) -> dict:
    """Restore ``path`` into CPU tensors of the structure, shapes, dtypes
    and strides of ``like_params`` (tensors on any device, meta included:
    only their layout is read). Raises ``ConfigError`` (never a raw
    traceback) when the path is missing, the file is unreadable, the
    structure or a shape differs from the model's, or the leaves drift from
    the manifest."""
    p = Path(path).absolute()
    if not p.exists():
        raise ConfigError(f"checkpoint path {p} does not exist")
    try:
        flat = torch.load(p / PARAMS_FILE, weights_only=True, map_location="cpu")
        if not isinstance(flat, dict) or not all(isinstance(v, torch.Tensor)
                                                 for v in flat.values()):
            raise ValueError("not a map of tensors")
    except Exception as e:
        raise ConfigError(f"failed to restore checkpoint {p}: "
                          f"{type(e).__name__}: {e}") from e
    want = flatten(like_params)
    if set(flat) != set(want):
        raise ConfigError(f"failed to restore checkpoint {p}: {_mismatch(set(flat), set(want))}")
    shapes = [k for k in sorted(want) if tuple(flat[k].shape) != tuple(want[k].shape)]
    if shapes:
        raise ConfigError(
            f"failed to restore checkpoint {p}: leaf shapes differ from the model's: "
            + ", ".join(f"{k} {tuple(flat[k].shape)} vs {tuple(want[k].shape)}"
                        for k in shapes[:3]))
    manifest = _manifest_path(p)
    if verify and manifest.exists():
        try:
            digests = json.loads(manifest.read_text())["digests"]
        except Exception as e:
            raise ConfigError(
                f"checkpoint digest manifest {manifest} is unreadable "
                f"({type(e).__name__}: {e}); delete it to restore unverified") from e
        drifted = diff_digests(digests, leaf_digests(flat))
        if drifted:
            preview = drifted[:3] + (["..."] if len(drifted) > 3 else [])
            raise ConfigError(
                f"checkpoint {p} failed digest verification: {len(drifted)} leaves "
                f"drifted from the manifest: {preview}; the bytes on disk are not the "
                "bytes save() wrote (corrupt at rest), or a foreign writer overwrote it")
    return _unflatten_like(like_params, flat)
