"""Declared lock hierarchy for the whole port.

Every lock in the port belongs to a named CLASS of locks (all
per-connection send locks are one class, every queue's slot condition is
one class, ...).  The hierarchy assigns each class a rank; the invariant
is:

    A thread holding a lock of rank R may only acquire locks of rank
    strictly GREATER than R (same-rank re-acquisition is allowed only
    for classes in SAME_NAME_OK, where distinct instances nest strictly
    along the dataflow DAG and therefore cannot invert).

Ranks encode the real acquisition chains of the streaming hot path: a
``tensor_filter`` deadline flush pushes downstream while holding its
coalesce lock, so everything a downstream ``chain()`` can take — queue
slot conditions, collectpads, send locks, the buffer pool, the tracer,
the pipeline state condition — must rank above ``filter.coalesce``.

The classes and ranks are the JAX package's
(``nnstreamer_tpu/analysis/lockorder.py``): where both packages name a
lock class, they order every pair of classes the same way.  Sites of
the port with no JAX counterpart take an existing class: the shm
ring's wakeup table, the MQTT reader, the metrics endpoint's state and
the module registries are ``leaf``; the MQTT writer and the federation
publisher's socket are ``query.send``; the federation collector and
publisher tables are ``obs.federation``.

Creation sites register by name through
:func:`nnstreamer_tpu_torch.analysis.sanitizer.make_lock` /
``make_rlock`` / ``make_condition``; the port's lint
(:mod:`nnstreamer_tpu_torch.analysis.lint`) resolves the same names
statically from those calls, so the static checker and the runtime
sanitizer enforce one registry.  Adding a lock to the port means adding
(or reusing) a class here — an unranked name is itself a lint finding.
"""

from __future__ import annotations

from typing import Dict, Optional

#: name -> rank.  Lower rank = acquired earlier (outermost).  Gaps are
#: deliberate: new classes slot in without renumbering.
HIERARCHY: Dict[str, int] = {
    # scheduling layer -----------------------------------------------------
    "planner": 10,          # SegmentPlanner._lock (plan compile/invalidate)
    "element": 20,          # Element._lock (per-element state guard)
    "filter.coalesce": 30,  # tensor_filter micro-batch coalescer
    "filter.workers": 32,   # tensor_filter worker-pool condition
    "llm.engine": 34,       # tensor_llm pending-queue/session condition
    #                         (llm/element.py): the decode thread takes
    #                         session bookkeeping under it but NEVER
    #                         pushes downstream while holding it, and
    #                         chain() enqueues under it — so everything
    #                         a push can reach (queue slots, send locks,
    #                         tracer, pool) must rank above
    "llm.pool": 36,         # KVCachePool slot table (llm/pool.py); the
    #                         engine acquires it with llm.engine held
    # thread boundaries ----------------------------------------------------
    "queue.space": 40,      # Queue slot condition (bounded-buffer wait)
    "collectpads": 42,      # mux/merge N-pad sync engine
    "repo": 44,             # tensor_repo slot/caps table
    "shm.ring": 46,         # shm ring local wakeup condition
    # fleet tier -------------------------------------------------------------
    "fleet.autoscaler": 47,  # autoscaler cooldown/decision state; calls
    #                          into the pool, so below fleet.pool
    "fleet.pool": 48,       # worker-pool table; membership callbacks
    #                         call into the router, so below fleet.router
    "fleet.router": 49,     # router membership + routed-client table;
    #                         rebalance calls FailoverConnection
    #                         endpoint updates, so below query.client
    # query / transport layer ----------------------------------------------
    "query.registry": 50,   # server/broker connection registries
    "query.client": 52,     # FailoverConnection endpoint state
    "query.overload": 54,   # admission controller / shed policy /
    #                         token bucket state (query/overload.py;
    #                         may evaluate metric gauges, so it ranks
    #                         below obs.metrics)
    "query.send": 60,       # per-connection/stream send locks
    # observability / memory -----------------------------------------------
    "slo": 66,              # SLO evaluator window store + flight-recorder
    #                         ring (slo/): held while snapshotting the
    #                         registry and exporting the span ring, so it
    #                         ranks below tracer/obs.ring/obs.metrics
    "obs.timeseries": 67,   # time-series ring sample store + signal
    #                         state (obs/timeseries.py); may evaluate
    #                         registry snapshots, so below obs.metrics
    "obs.federation": 68,   # federation collector origin table
    #                         (obs/federation.py); merges local registry
    #                         snapshots, so below obs.metrics
    "tracer": 70,           # Tracer stats table
    "obs.ring": 72,         # SpanRing append/snapshot (obs/span.py)
    "analysis.ledger": 73,  # compile-ledger event/budget tables
    #                         (analysis/compileledger.py); exports the
    #                         nns_jit_compiles_total counter, which is
    #                         incremented OUTSIDE this lock, so it ranks
    #                         below obs.metrics
    "obs.metrics": 74,      # metrics registry + per-metric state
    #                         (obs/metrics.py; scrape snapshots under the
    #                         registry lock, then evaluates gauges
    #                         outside it)
    "pool": 80,             # TensorBufferPool free lists
    "lease": 85,            # BufferLease refcount
    "pipeline.state": 90,   # Pipeline error/EOS condition (post_error
    #                         is reachable from under most of the above)
    "leaf": 95,             # one-shot module registries (default pool,
    #                         server/broker tables, native loader, conf)
}

#: classes whose distinct INSTANCES may nest (always along the dataflow
#: DAG, upstream instance acquired first — a reverse edge would need a
#: dataflow cycle, which the static verifier rejects as an error).
SAME_NAME_OK = frozenset({
    "element", "filter.coalesce", "filter.workers", "queue.space",
    "collectpads", "repo", "shm.ring", "query.send", "lease",
    "pipeline.state",
})


def rank_of(name: str) -> Optional[int]:
    """Rank of a lock class, or None when unregistered (unregistered
    locks are exempt from ordering checks but reported by the lint)."""
    return HIERARCHY.get(name)


def check_order(held_name: str, acquiring_name: str) -> Optional[str]:
    """Return a violation description when acquiring ``acquiring_name``
    while holding ``held_name`` breaks the hierarchy, else None."""
    held = rank_of(held_name)
    acq = rank_of(acquiring_name)
    if held is None or acq is None:
        return None
    if held_name == acquiring_name:
        if held_name in SAME_NAME_OK:
            return None
        return (f"same-class nesting of {held_name!r} (rank {held}) is "
                "not declared instance-safe (SAME_NAME_OK)")
    if acq < held:
        return (f"acquired {acquiring_name!r} (rank {acq}) while holding "
                f"{held_name!r} (rank {held}); hierarchy requires "
                f"{acquiring_name!r} first")
    return None
