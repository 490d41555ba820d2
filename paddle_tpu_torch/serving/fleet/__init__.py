"""The serving fleet of the port: KV page migration between engines.

:func:`~.disagg.migrate_request` moves one in-flight request, with its KV
pages, from one :class:`~..engine.ServingEngine` to another (falling back
to recompute-on-readmit when the target is full, and raising
:class:`~.disagg.MigrationFailed` when it can take the request neither
way); :func:`~.disagg.drain_active` moves every in-flight request off an
engine. Neither needs a router.

The rest of ``paddle_tpu/serving/fleet`` — the router, the engine
registry, the request ledger, fleet-wide page sharing, the remote
transport, the durable front door and the autoscaler — is not ported yet.
"""
from .disagg import MigrationFailed, migrate_request

__all__ = ["MigrationFailed", "migrate_request"]
