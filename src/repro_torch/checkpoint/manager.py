"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic, checksummed, keep-k, async-capable, in the reference's on-disk
format, so each package restores the other's checkpoints.

Layout:  <dir>/step_<N>/
             manifest.json     keys, shapes, dtypes, the checksum
             arrays.npz.<c>    the flattened leaves (an ``np.savez``
                               archive, zstd-compressed when the optional
                               zstandard module imports, zlib otherwise;
                               the manifest records the codec)

A leaf's key is its tree path as the reference writes it (``jax.tree_util``
order: ``0/embed/table``, ``1/.m/embed/table``, ``1/.step`` for a
``(params, AdamWState)`` pair; ``repro_torch.tree``).  The checksum is the
sha256 of the uncompressed archive.  A save is written to
``step_<N>.tmp`` and then ``os.rename``d, so a crashed save never shadows
the previous good checkpoint.

bfloat16 leaves are written as the reference writes them (``np.savez``
keeps ml_dtypes' bfloat16 as 2-byte void described ``'<V2'``, the
manifest says ``"bfloat16"``: the same archive bytes) and read back by
the manifest's dtype: the reference's own ``restore`` cannot cast that
void back (ROADMAP C22), the port reads the bits as int16 and views them
as ``torch.bfloat16``.  No ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch
from numpy.lib import format as npformat

from repro_torch.tree import leaves_with_path, unflatten

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib compression
    zstandard = None

_SEP = "/"
_VOID2 = np.dtype("V2")


def _default_codec() -> str:
    return "zstd" if zstandard is not None else "zlib"


def _array_file(codec: str) -> str:
    return "arrays.npz." + ("zst" if codec == "zstd" else "zlib")


def _compress_bytes(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return zstandard.ZstdCompressor(level=3).compress(raw)
    if codec == "zlib":
        return zlib.compress(raw, 6)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress_bytes(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise IOError("checkpoint is zstd-compressed but the zstandard "
                          "module is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(t) -> tuple:
    """(numpy array of the leaf's bytes, manifest dtype)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_VOID2), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _savez(leaves: dict) -> bytes:
    """The archive ``np.savez`` writes for the reference's leaves: a zip64
    member ``<key>.npy`` a leaf, in order.  A bfloat16 leaf's header says
    ``'<V2'``, as numpy describes ml_dtypes' bfloat16, where a plain void
    array would say ``'|V2'``: the same bytes as the reference's."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, dt) in leaves.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dt == "bfloat16":
                    npformat.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": a.shape})
                    fid.write(np.ascontiguousarray(a).tobytes())
                else:
                    npformat.write_array(fid, np.asanyarray(a))
    return buf.getvalue()


def _flatten(tree) -> dict:
    """{key: (numpy array, manifest dtype)} in the reference's order; the
    copies off the card are made here, synchronously."""
    return {_key(path): _to_numpy(leaf)
            for path, leaf in leaves_with_path(tree)}


def _write(directory: str, step: int, leaves: dict, extra, keep: int,
           with_compressed: bool) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    raw = _savez(leaves)
    codec = _default_codec()
    comp = _compress_bytes(raw, codec)
    with open(os.path.join(tmp, _array_file(codec)), "wb") as f:
        f.write(comp)
    manifest = {"step": step,
                "codec": codec,
                "checksum": hashlib.sha256(raw).hexdigest(),
                "bytes_raw": len(raw)}
    if with_compressed:
        manifest["bytes_compressed"] = len(comp)
    manifest["keys"] = {k: {"shape": list(a.shape), "dtype": dt}
                        for k, (a, dt) in leaves.items()}
    manifest["extra"] = extra or {}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(directory, keep)
    return final


def save(directory: str, step: int, tree, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` as step ``step``; keep the newest ``keep`` steps.
    Returns the checkpoint's directory."""
    return _write(directory, step, _flatten(tree), extra, keep, True)


def save_async(directory: str, step: int, tree, extra=None,
               keep: int = 3) -> threading.Thread:
    """Off-critical-path save: the copies to host memory happen here
    (synchronously, so the values are those of this step), compression and
    IO on a worker thread, which is returned (join it before the next
    save)."""
    leaves = _flatten(tree)
    t = threading.Thread(target=_write,
                         args=(directory, step, leaves, extra, keep, False),
                         daemon=True)
    t.start()
    return t


def _cleanup(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor, read by its manifest dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore(directory: str, step: int, template=None, *, verify: bool = True):
    """Load step ``step``: (tree, manifest).  Without ``template`` the tree
    is ``{key: CPU tensor}``; with one (a tree of tensors, a
    ``ParamTree`` among them) every leaf of the template is read by its
    key, cast to the template leaf's dtype and placed on its device, and
    the template's structure comes back (a ``ParamTree`` as a new one, its
    leaves requiring grad as the template's do)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    codec = manifest.get("codec", "zstd")   # pre-codec checkpoints were zstd
    with open(os.path.join(path, _array_file(codec)), "rb") as f:
        raw = _decompress_bytes(f.read(), codec)
    if verify:
        digest = hashlib.sha256(raw).hexdigest()
        if digest != manifest["checksum"]:
            raise IOError(f"checkpoint {path} corrupt: checksum mismatch")
    with np.load(io.BytesIO(raw)) as arrs:
        stored = {k: _to_tensor(arrs[k], manifest["keys"][k]["dtype"])
                  for k in arrs.files}
    if template is None:
        return stored, manifest
    out = []
    for tpath, tleaf in leaves_with_path(template):
        key = _key(tpath)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        out.append(stored[key].to(device=tleaf.device, dtype=tleaf.dtype))
    return _rebuild(template, unflatten(template, out)), manifest


def _rebuild(template, tree):
    """``tree`` (plain dicts where the template has a ``ParamTree``) in the
    template's types."""
    from repro_torch.models.params import ParamTree
    if isinstance(template, ParamTree):
        new = ParamTree(tree)
        for (_, p), (_, q) in zip(leaves_with_path(template),
                                  leaves_with_path(new)):
            q.requires_grad_(p.requires_grad)
        return new
    if isinstance(template, dict):
        return {k: _rebuild(template[k], tree[k]) for k in tree}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(a, b) for a, b in zip(template,
                                                               tree)))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(a, b) for a, b in zip(template, tree))
    return tree
