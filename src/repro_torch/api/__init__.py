"""``repro_torch.api`` — the unified dataset façade over the CAMEO stack,
on the card.

>>> import repro_torch.api as cameo
>>> ds = cameo.open("fleet.cameo", CameoConfig(eps=1e-3, lags=24))
>>> ds.write("sensor-1", x)                 # 1-D: univariate
>>> ds.write("rack-7", X)                   # [n, C]: multivariate (v4)
>>> with ds.stream("feed") as w:            # unbounded chunked ingest
...     w.push(chunk)
>>> s = ds.series("rack-7")
>>> s.mean(a, b)                            # ([C], [C]) value + bound
>>> s.acf(col=0)                            # one column's pushdown ACF
>>> ds.close()

``open(..., device="cpu")`` runs the plain path on the CPU; the default is
the card.  See :mod:`repro_torch.api.dataset` for the full contract.  The
legacy entry points (``TimeSeriesService.submit``/``ingest_stream``, the
free ``repro_torch.store.window_*`` functions, ``compress_windowed``) are
deprecated shims over the same internals.
"""
from repro_torch.api.dataset import (Dataset, DatasetView, Series,
                                     StreamWriter, open)

__all__ = ["Dataset", "DatasetView", "Series", "StreamWriter", "open"]
