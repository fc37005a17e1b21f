"""repro_torch.serve — the persistent SSSP query service of the port
(the JAX package's ``repro.serve`` over the port's Solver).

The paper's self-stabilization guarantee turned into a serving loop:
one long-lived :class:`repro_torch.api.Solver`, a request
:class:`Router` that admits point-to-point and single-source queries
into batches (pad/timeout batching; a batch of misses is one
``solve_batch``, its frontier kernel launched once a superstep for
all lanes), a byte-budgeted LRU
:class:`SolutionCache`, an :class:`UpdateFeed` that applies streamed
edge insertions / weight changes to the live graph and keeps cached
answers fresh via self-stabilizing warm restarts (exact — improving
perturbations re-converge from the previous fixpoint in a few
supersteps), and a :class:`LandmarkIndex` hub tier serving
point-to-point estimates by triangle inequality with an ``exact=``
escalation path.

    from repro_torch.serve import Router, Query, SolutionCache, UpdateFeed
    from repro_torch.api import Solver

    solver = Solver("delta:5/sparse/fused")         # on the card
    router = Router(solver, g, cache=SolutionCache(byte_budget=1 << 28))
    ans = router.serve([Query(source=0, target=42)])[0]

    feed = UpdateFeed(g, solver, cache=router.cache)
    feed.apply(EdgeUpdate(src=3, dst=7, weight=0.5))   # warm refresh

Over a process backend (``Solver(..., ranks=init_ranks(...))``) every
rank builds the same objects; rank 0 then serves and every other rank
calls ``router.follow()``, which replays rank 0's calls until its
``router.close()`` (:mod:`repro_torch.serve.stream`).

Service CLI: ``python -m repro_torch.launch.serve``.
"""

from repro_torch.serve.cache import CacheKey, CacheStats, SolutionCache
from repro_torch.serve.landmarks import Estimate, LandmarkIndex, pick_landmarks
from repro_torch.serve.router import (
    Answer, Query, Router, RouterStats, Ticket, serve_latency_stats,
)
from repro_torch.serve.updates import (
    EdgeUpdate, FeedStats, UpdateFeed, UpdateResult,
)

__all__ = [
    "Answer",
    "CacheKey",
    "CacheStats",
    "EdgeUpdate",
    "Estimate",
    "FeedStats",
    "LandmarkIndex",
    "Query",
    "Router",
    "RouterStats",
    "SolutionCache",
    "Ticket",
    "UpdateFeed",
    "UpdateResult",
    "pick_landmarks",
    "serve_latency_stats",
]
