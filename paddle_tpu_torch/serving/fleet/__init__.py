"""The serving fleet of the port — N engines, one serving system.

The port of ``paddle_tpu/serving/fleet`` (host Python over the port's
engines, whose rounds run the hand-written kernels):

* :class:`FleetRouter` — one front end over N engines: session affinity,
  queue-depth-aware balancing, backpressure (:class:`FleetSaturated`),
  engine-loss re-dispatch, hedged stragglers, prefetch on an affinity
  spill, prefill/decode roles (:class:`LocalEngineHandle` for an
  in-process engine);
* fleet-wide prefix sharing through the TCPStore
  (:class:`PageShareClient`, :class:`SharedPrefixCache`: a head
  prefilled once per FLEET, its pages imported into other engines'
  pools);
* KV page migration between engines (:func:`migrate_request`,
  :class:`MigrationFailed`);
* store-backed registration and liveness (:class:`EngineRegistry`) and
  a store-RPC transport for engines in processes of their own
  (:func:`serve_over_store`, :class:`RemoteEngineHandle`);
* :class:`EngineAutoscaler` — the roster grows and shrinks against the
  router's SLO signals (warm spares, quarantine strikes, membership
  persisted through a store failover);
* the durable front door: :class:`RequestLedger` journals every request
  (client request ids are exactly-once keys), :class:`RouterLease`
  term-fences primary and shadow routers (:class:`RouterDeposedError`),
  and :mod:`.frontdoor` runs the pair as processes
  (:func:`serve_router`, :class:`RouterClient`).

    from paddle_tpu_torch.serving.fleet import FleetRouter
    router = FleetRouter()
    router.add_engine(engine_a, "e0")
    router.add_engine(engine_b, "e1")
    router.start()
    req = router.submit(prompt_ids, max_new_tokens=64)
    tokens = req.result(timeout=60)
"""
from .router import (  # noqa: F401
    FleetRequest, FleetRouter, FleetSaturated, LocalEngineHandle,
)
from .page_share import PageShareClient, SharedPrefixCache  # noqa: F401
from .disagg import MigrationFailed, migrate_request  # noqa: F401
from .registry import EngineRegistry  # noqa: F401
from .remote import RemoteEngineHandle, serve_over_store  # noqa: F401
from .autoscale import EngineAutoscaler  # noqa: F401
from .ledger import (  # noqa: F401
    RequestLedger, RouterDeposedError, RouterLease,
)
from .frontdoor import RouterClient, serve_router  # noqa: F401
