"""The control-plane store keyspace — ONE module owns every key spelling
(the port's copy of ``paddle_tpu/distributed/keyspace.py``; the strings
are the JAX package's, byte for byte, so a port worker and a JAX worker
agree on the wire).

Each family is a PROTOCOL — WAL
entries are claim-bracketed, ``__``-internal keys skip replication,
registry-scope keys ride it, coordinator leases are term-fenced — and a
drifted spelling in one caller silently splits the namespace in a way no
test on either side can see.  This module is now the single source of
truth.

Key strings are IDENTICAL to the pre-consolidation spellings — this is a
relocation, not a migration (a mixed-version fleet mid-rolling-restart
must agree on the wire bytes).

Families:

* ``__wal/...``    — FailoverStore write-ahead log + claim protocol
                     (``__``-internal: never itself replicated);
* ``__fence/...``  — epoch fence + promotion claims (``__``-internal);
* ``elastic/<job>/...``  — rendezvous registry, node records, coordinator
                     lease/term/state (registry scope: WAL-replicated);
* ``serving/<job>/...``  — serving fleet engine registry + store-RPC
                     submit/complete streams;
* ``pshare/<job>/...``   — cross-engine page-share payload/index/lease;
* ``rpc/...``      — distributed.rpc worker address book;
* ``dlinalg/<job>/...``  — distributed linear-algebra solver control
                     plane (panel exchange, solver progress, barriers —
                     registry scope: WAL-replicated so a promoted
                     standby still holds in-flight panels).

Leaf keys under a family prefix are built by the owning class via its
``_k``/prefix helper — those helpers must take their ROOT from here.
Per-incarnation state (flight-recorder signatures, gloo barrier seqs)
is NOT in this module: it derives from ``flight_recorder.store_scope()``
so failover rotation renames it wholesale.
"""
from __future__ import annotations

__all__ = [
    "WAL_SEQ", "WAL_ACKED", "FENCE_EPOCH",
    "wal_entry", "wal_claim", "wal_result", "wal_cursor", "fence_promo",
    "elastic_job", "elastic_node", "elastic_coord",
    "fleet_registry", "fleet_engine_rpc", "fleet_engine_stream",
    "fleet_quarantine", "fleet_autoscale", "fleet_ledger",
    "fleet_router", "page_share",
    "rpc_worker", "rpc_rank",
    "dlinalg_job", "dlinalg_panels", "dlinalg_solver",
]

# ---- FailoverStore WAL (``__``-internal: skips its own replication) -------

WAL_SEQ = "__wal/seq"          # monotonic append counter
WAL_ACKED = "__wal/acked"      # standby's applied-cursor


def wal_entry(seq):
    """One WAL entry payload (JSON op record)."""
    return f"__wal/{seq}"


def wal_claim(opid):
    """Exactly-once claim marker for a non-idempotent op."""
    return f"__wal/claim/{opid}"


def wal_result(opid):
    """Claimed op's recorded result ("?" = pre-apply marker)."""
    return f"__wal/result/{opid}"


def wal_cursor(idx):
    """Shipper ``idx``'s published acked-cursor on the primary (the
    writer's self-trim floor)."""
    return f"__wal/cursor/{idx}"


# ---- epoch fence ----------------------------------------------------------

FENCE_EPOCH = "__fence/epoch"  # store-lifetime fence counter


def fence_promo(old_epoch):
    """Idempotent promotion claim for bumping epoch ``old_epoch``."""
    return f"__fence/promo/e{old_epoch}"


# ---- elastic control plane (registry scope: rides the WAL) ----------------

def elastic_job(job):
    """Rendezvous registry root for one job (hosts/join log/roster)."""
    return f"elastic/{job}"


def elastic_node(job):
    """Node-level registry (agent records, round specs, quarantine)."""
    return f"elastic/{job}/node"


def elastic_coord(job):
    """Coordinator lease/term/state-checkpoint prefix."""
    return f"elastic/{job}/coord"


# ---- serving fleet --------------------------------------------------------

def fleet_registry(job):
    """Engine registry root (join log + heartbeat records)."""
    return f"serving/{job}"


def fleet_engine_rpc(job, engine_id):
    """Store-RPC prefix for one remote engine (in/out streams, stop,
    stats)."""
    return f"serving/{job}/eng/{engine_id}"


def fleet_engine_stream(job, engine_id):
    """Per-token stream prefix for one remote engine (``tok_seq``
    counter + ``tok/<n>`` batched token records): incremental tokens
    cross the store so a remote client's ``on_token``/TTFT is real
    instead of arriving with the batched completion."""
    return f"serving/{job}/eng/{engine_id}/stream"


def fleet_quarantine(job):
    """Serving-fleet quarantine ledger (JSON ``QuarantineList.to_dict``)
    — registry scope, so a struck-out engine stays excluded across a
    store failover exactly like a flaky NODE does on the training side
    (the unified membership)."""
    return f"serving/{job}/quarantine"


def fleet_autoscale(job):
    """Autoscaler state root (scale-event log + roster epoch) for one
    serving job — registry scope: rides the WAL like membership."""
    return f"serving/{job}/autoscale"


def fleet_ledger(job):
    """Durable request ledger root: ``seq`` counter +
    ``idx/<n>`` request-id join-log + ``req/<rid>`` lifecycle records
    (``accepted -> dispatched -> streaming -> terminal``). Registry
    scope on purpose — every record rides the FailoverStore WAL, so a
    promoted standby store still holds the exactly-once journal a
    shadow router reconstructs from."""
    return f"serving/{job}/ledger"


def fleet_router(job):
    """Serving front-door root: the router lease/term pair
    (``lease`` JSON + ``term`` fence counter — same primary/shadow
    protocol as ``elastic_coord``) plus the wire submission queue
    (``in_seq`` counter + ``in/<n>`` records carrying client-supplied
    request ids) and the ``stop`` key. Registry scope: a promoted
    standby still sees the queue tail and the deposed term."""
    return f"serving/{job}/router"


def page_share(job):
    """Cross-engine prefix-cache share (pg/idx/lease sub-keys)."""
    return f"pshare/{job}"


# ---- distributed.rpc address book -----------------------------------------

def rpc_worker(name):
    """Worker record: ``"<rank>,<ip>,<port>"``."""
    return f"rpc/worker/{name}"


def rpc_rank(rank):
    """rank -> worker-name indirection."""
    return f"rpc/rank/{rank}"


# ---- distributed linear algebra --------------------------------

def dlinalg_job(job):
    """Solver control-plane root for one dlinalg job (progress records,
    world roster). Registry scope: rides the FailoverStore WAL so a
    promoted standby still knows the last committed panel."""
    return f"dlinalg/{job}"


def dlinalg_panels(job):
    """Panel-exchange payload prefix (``StoreExchange._k`` appends
    ``i<incarnation>/s<sweep>/<phase>/<tag>`` leaves). Panels are
    immutable once published — re-publishing after a resume writes the
    identical bytes, so replay over a store failover is idempotent."""
    return f"dlinalg/{job}/panel"


def dlinalg_solver(job):
    """Solver synchronisation prefix (reduction scratch + barrier
    names, suffixed by incarnation/sweep so an elastic world change
    never meets a stale counter)."""
    return f"dlinalg/{job}/solver"
