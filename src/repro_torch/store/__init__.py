"""CameoStore: the physical block store under the CAMEO compressor (port
of ``repro/store``).

The modules are the port's own copy of the JAX package's numpy code, and
write the same bytes: for the same series, configuration and calls
(``append_series``, ``open_stream`` sessions, flush, close, ``mode="a"``
resume, the write-ahead journal) a file written here equals, byte for
byte, the one ``repro.store`` writes, and each package reads the other's
files.  The store meets the compressor at two points only:
``codec.compression_ratio_bytes`` calls the port's ``kept_points``, and
``blocks.reconstruct_block`` runs the port's ``_reconstruct`` on the
store's device (``CameoStore(..., device="cuda")``, the default; pass
``"cpu"`` for the plain path).  ``CompressResult`` fields arrive as torch
tensors and become numpy at the store's edge.

* ``store.codec``  — byte-true bitstream codecs (delta-of-delta kept-index
  packing, Gorilla/Chimp XOR value streams, optional zstd/zlib wrap) and
  the byte-true ``compression_ratio_bytes``; the control-bit scan is in
  ``store._scan``.
* ``store.blocks`` — chunked block format (v2-v4; v4 adds multivariate
  blocks); borders pinned on kept points; headers carry the Eq. 7 ACF
  sufficient statistics and pushdown metadata.
* ``store.store``  — append-oriented writer / random-access reader
  (``CameoStore``) with a decoded-block LRU; ``open_stream`` opens a
  :class:`StreamSession` (univariate or multivariate) that appends blocks
  as stream windows close and resumes bit-exactly from footer-stashed
  state.
* ``store.wal``    — per-store write-ahead journal (``<path>.wal``).
* ``store.query``  — pushdown aggregates (sum/mean/var/ACF) with
  deterministic error bounds.
* ``store.maintenance`` — compaction and cold-tier rewrites.

Exports resolve lazily (PEP 562): ``store.codec`` is plain numpy + stdlib
and imports no torch, while ``store.store`` / ``store.blocks`` need torch
for the bit-exact block reconstruction.

The free ``window_*`` re-exports are **deprecated**, as in the JAX
package (``repro_torch.store.query`` itself is the internal engine and
does not warn).
"""
import functools
import importlib
import warnings

_EXPORTS = {
    "CameoStore": "repro_torch.store.store",
    "StreamSession": "repro_torch.store.store",
    "WriteAheadLog": "repro_torch.store.wal",
    "chimp_stream_bits": "repro_torch.store.codec",
    "compression_ratio_bytes": "repro_torch.store.codec",
    "encode_series_payload": "repro_torch.store.codec",
    "gorilla_stream_bits": "repro_torch.store.codec",
}
# deprecated free-function query surface: kept working, but warns
_DEPRECATED_QUERY = ("window_acf", "window_mean", "window_sum", "window_var")
_SUBMODULES = ("blocks", "codec", "query", "store", "wal")


def _deprecated_query(name):
    fn = getattr(importlib.import_module("repro_torch.store.query"), name)

    @functools.wraps(fn)
    def shim(*args, **kwargs):
        warnings.warn(
            f"repro_torch.store.{name} is deprecated; use "
            f"repro_torch.store.query.{name}",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)

    return shim


def __getattr__(name):
    if name in _DEPRECATED_QUERY:
        return _deprecated_query(name)
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.store.{name}")
    raise AttributeError(
        f"module 'repro_torch.store' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_DEPRECATED_QUERY)
                  | set(_SUBMODULES))
