"""``repro_torch.server`` — multi-tenant ingest server over one CAMEO store.

>>> from repro_torch.server import IngestServer, ServerConfig
>>> srv = IngestServer("fleet.cameo", CameoConfig(eps=1e-3, lags=24),
...                    ServerConfig(seal_block_len=512, max_sessions=8),
...                    device="cuda")
>>> srv.register_tenant("acme", eps=5e-3, max_points=10_000_000)
>>> with srv.session("turbine-1", tenant="acme") as sess:
...     sess.push(chunk)                       # journaled-before-ack
>>> srv.drain_compaction()                     # small blocks -> full size
>>> srv.view("acme").series("turbine-1").mean()
>>> srv.close()

Layers (each documented in its module):

* :mod:`.ingest_server` — session multiplexing, admission/backpressure,
  quotas, the WSGI ``/metrics`` hook;
* :mod:`.catalog` — tenant namespacing + config in the store footer;
* :mod:`.compaction` — background rewrite of small streamed blocks;
* :mod:`.tiers` — hot (pinned LRU) / warm (mmap) / cold (entropy-wrapped)
  block storage.
"""
from repro_torch.server.catalog import (DEFAULT_TENANT, TenantCatalog,
                                        tenant_sid)
from repro_torch.server.compaction import CompactionWorker
from repro_torch.server.ingest_server import (
    IngestServer,
    QuotaExceeded,
    ServerBusy,
    ServerConfig,
    ServerSession,
    ServerView,
)
from repro_torch.server.tiers import TierManager

__all__ = [
    "IngestServer", "ServerConfig", "ServerSession", "ServerView",
    "ServerBusy", "QuotaExceeded", "TenantCatalog", "TierManager",
    "CompactionWorker", "DEFAULT_TENANT", "tenant_sid",
]
