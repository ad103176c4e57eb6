"""Tenant catalog — the namespacing layer over the store footer.

Tenancy is a *naming* convention plus a small config table, both living
in the store footer so they share the store's durability story (two-
phase footer publish, WAL checkpoint rollback):

* a named tenant ``t`` owns the sid namespace ``"t/"`` — its series
  ``s`` is stored under the physical sid ``"t/s"``;
* the **default tenant** (the empty name) owns every sid that does not
  belong to a registered tenant's namespace, so legacy single-tenant
  stores (and the deprecated ``TimeSeriesService`` path) are exactly the
  default tenant's view and stay byte-identical;
* per-tenant config (ε override, point quota) lives in the footer's
  optional ``"tenants"`` key (``CameoStore._tenants``), written only
  when at least one tenant is registered — stores that never see the
  server layer keep byte-identical footers.

Tenant names must not contain ``"/"`` (it is the namespace separator)
and must be non-empty; series names are unrestricted — a ``"/"`` inside
a *series* name is legal but keeps the sid inside its tenant's
namespace only if the tenant is registered first (the default tenant's
``series_of`` excludes every registered prefix).
"""
from __future__ import annotations

from typing import Dict, List

DEFAULT_TENANT = ""


def tenant_sid(tenant: str, series: str) -> str:
    """Physical store sid of one tenant's series."""
    return series if tenant == DEFAULT_TENANT else f"{tenant}/{series}"


class TenantCatalog:
    """Registration + lookup over ``store._tenants`` (see module doc)."""

    def __init__(self, store):
        self._store = store

    def register(self, tenant: str, *, eps: float = None,
                 max_points: int = None) -> dict:
        """Register (or re-configure) a tenant.  ``eps`` overrides the
        server's compression budget for this tenant's streams;
        ``max_points`` caps its total ingested points (channel-expanded),
        enforced *before* a push is journaled/acked.  Re-registering
        merges: an omitted kwarg keeps its configured value, so updating
        ``eps`` never silently drops an existing quota."""
        if tenant == DEFAULT_TENANT:
            raise ValueError("the default tenant needs no registration")
        if "/" in tenant:
            raise ValueError(f"tenant name {tenant!r} must not contain '/'")
        cfg = dict(self._store._tenants.get(tenant, {}))
        if eps is not None:
            cfg["eps"] = float(eps)
        if max_points is not None:
            cfg["max_points"] = int(max_points)
        self._store._tenants[tenant] = cfg
        return cfg

    def config(self, tenant: str) -> dict:
        if tenant == DEFAULT_TENANT:
            return {}
        return dict(self._store._tenants[tenant])

    def tenants(self) -> List[str]:
        """Registered tenant names (the default tenant is implicit)."""
        return sorted(self._store._tenants)

    def is_registered(self, tenant: str) -> bool:
        return tenant == DEFAULT_TENANT or tenant in self._store._tenants

    def series_of(self, tenant: str) -> List[str]:
        """Series names owned by one tenant (namespace prefix stripped).
        The default tenant owns everything outside every registered
        namespace."""
        sids = self._store.series_ids()
        if tenant == DEFAULT_TENANT:
            prefixes = tuple(t + "/" for t in self._store._tenants)
            return [s for s in sids
                    if not prefixes or not s.startswith(prefixes)]
        if tenant not in self._store._tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        pre = tenant + "/"
        return [s[len(pre):] for s in sids if s.startswith(pre)]

    def usage(self, tenant: str) -> Dict[str, int]:
        """Points / kept / stored bytes over one tenant's series
        (channel-expanded, streaming series counting their committed
        prefix — the same conventions as ``ingest_totals``)."""
        out = dict(series=0, points=0, n_kept=0, stored_nbytes=0)
        for s in self.series_of(tenant):
            e = self._store.series_meta(tenant_sid(tenant, s))
            C = int(e.get("channels", 1))
            out["series"] += 1
            out["points"] += e["n"] * C
            out["n_kept"] += e["n_kept"] * C
            out["stored_nbytes"] += e["stored_nbytes"]
        return out
