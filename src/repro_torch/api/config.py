"""One validated configuration object for the solver stack.

``SolverConfig`` folds the EAGM ordering hierarchy (paper §IV), the
candidate-exchange strategy and the iteration knobs into one frozen,
hashable value; ``hierarchy`` is the source of truth, and ``root`` /
``variant`` / ``chunk_size`` are construction conveniences excluded
from equality.

The spec grammar has two forms, with further ``/``-segments in any
order beside the exchange and a trailing partitioner::

    root[+variant][/exchange][/fused][/q[:dtype]][/adapt[:policy]][/trace][@partitioner]
    root[ > level:ordering]...[/exchange]...      (hierarchy grammar)

    "delta:5+threadq/a2a"
    "delta:5 > pod:dijkstra > chunk:delta:1 /sparse"
    "delta:5/sparse/fused"

``/fused`` selects the fused-superstep kernel (``relax_impl="fused"``);
``relax_impl="push"`` (the relax_push gather kernel) has no segment.
``/q[:dtype]`` (``bf16``, bare ``/q``; or ``u16``) quantizes the sparse
exchange's values, which the solver's repair loop makes exact;
``/adapt[:policy]`` (bare: ``rho``) runs the segment engine under a
:mod:`repro_torch.tune` policy that retunes Δ, the frontier cap and the
exchange between segments; ``/trace`` runs it under the static policy
to record every superstep (``Solution.trace``).  All of them solve at
any rank count, on the card or the CPU; ``solve_batch`` refuses them.
``config.name`` is identical to the JAX package's for every spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.eagm import DEFAULT_CHUNK, Hierarchy, make_hierarchy
from repro_torch.core.engine import EXCHANGE_MODES, RELAX_IMPLS, EngineConfig
from repro_torch.core.frontier import PAYLOAD_MODES
from repro_torch.core.ordering import suggest
from repro_torch.core.processing import ProcessingFn
from repro_torch.graph.partition import canonical_partitioner
from repro_torch.tune.policies import canonical_policy

EXCHANGES = EXCHANGE_MODES

@dataclasses.dataclass(frozen=True)
class SolverConfig:
    root: str = dataclasses.field(default="delta:5", compare=False)
    variant: str = dataclasses.field(default="buffer", compare=False)
    exchange: str = "a2a"
    chunk_size: int = dataclasses.field(default=DEFAULT_CHUNK, compare=False)
    max_iters: int = 10**9
    collect_metrics: bool = True
    frontier_cap: Optional[int] = None  # sparse-path row capacity F
    relax_impl: str = "ref"             # 'ref' | 'push' | 'fused'
    payload: str = "exact"              # 'exact' | 'bf16' | 'u16'
    hierarchy: Optional[Hierarchy] = None
    partition: str = "block"
    adapt: Optional[str] = None
    adapt_window: int = 4
    trace: bool = False

    def __post_init__(self):
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive: {self.chunk_size}")
        if self.hierarchy is None:
            object.__setattr__(
                self, "hierarchy",
                make_hierarchy(self.root, self.variant, self.chunk_size),
            )
        else:
            h = self.hierarchy
            if isinstance(h, str):
                h = Hierarchy.from_spec(h, chunk_size=self.chunk_size)
            elif not isinstance(h, Hierarchy):
                h = Hierarchy(tuple(h))
            object.__setattr__(self, "hierarchy", h)
            object.__setattr__(self, "root", h.root.spec)
            object.__setattr__(self, "variant", h.variant or "hierarchy")
        if self.exchange not in EXCHANGES:
            raise ValueError(
                f"exchange must be one of {EXCHANGES}, got {self.exchange!r}"
                f"{suggest(str(self.exchange), EXCHANGES)}"
            )
        if self.max_iters <= 0:
            raise ValueError(f"max_iters must be positive: {self.max_iters}")
        if self.frontier_cap is not None and self.frontier_cap <= 0:
            raise ValueError(f"frontier_cap must be positive: {self.frontier_cap}")
        if self.relax_impl not in RELAX_IMPLS:
            raise ValueError(
                f"relax_impl must be one of {RELAX_IMPLS}, "
                f"got {self.relax_impl!r}"
                f"{suggest(str(self.relax_impl), RELAX_IMPLS)}"
            )
        if self.payload not in PAYLOAD_MODES:
            raise ValueError(
                f"payload must be one of {PAYLOAD_MODES}, "
                f"got {self.payload!r}{suggest(str(self.payload), PAYLOAD_MODES)}"
            )
        if self.payload != "exact" and self.adapt is not None:
            raise ValueError(
                "quantized payloads (/q:...) do not compose with the "
                "adaptive controller (/adapt); pick one"
            )
        if self.payload != "exact" and self.trace:
            raise ValueError(
                "quantized payloads (/q:...) do not compose with the "
                "flight recorder (/trace); trace the exact spec instead"
            )
        object.__setattr__(
            self, "partition", canonical_partitioner(self.partition)
        )
        if self.adapt_window <= 0:
            raise ValueError(f"adapt_window must be positive: {self.adapt_window}")
        if self.adapt is not None:
            object.__setattr__(self, "adapt", canonical_policy(self.adapt))

    @classmethod
    def from_spec(cls, spec: str, **overrides) -> "SolverConfig":
        """Parse either grammar; keyword overrides win over parsed
        fields.  Malformed specs raise with the spec quoted."""
        rest = str(spec).strip()
        if not rest:
            raise ValueError(f"empty solver spec {spec!r}")
        if "@" in rest:
            rest, partition = rest.rsplit("@", 1)
            rest, partition = rest.strip(), partition.strip()
            if not partition:
                raise ValueError(f"empty partition segment in spec {spec!r}")
            if not rest:
                raise ValueError(f"empty ordering segment in spec {spec!r}")
            overrides.setdefault("partition", partition)
        if "/" in rest:
            head, *segs = [s.strip() for s in rest.split("/")]
            if not head:
                raise ValueError(f"empty ordering segment in spec {spec!r}")
            seen = set()
            for seg in segs:
                if not seg:
                    raise ValueError(f"empty exchange segment in spec {spec!r}")
                kind = seg.split(":", 1)[0].strip()
                slot = "exchange" if kind in EXCHANGES else kind
                if slot in ("fused", "q", "trace", "adapt", "exchange"):
                    if slot in seen:
                        what = "payload" if slot == "q" else slot
                        raise ValueError(
                            f"duplicate {what} segment in spec {spec!r}"
                        )
                    seen.add(slot)
                if kind in ("fused", "trace") and ":" in seg:
                    raise ValueError(
                        f"{kind} segment takes no argument in spec "
                        f"{spec!r}; use '/{kind}'"
                    )
                if kind == "fused":
                    overrides.setdefault("relax_impl", "fused")
                elif kind == "trace":
                    overrides.setdefault("trace", True)
                elif kind == "q":
                    payload = seg.split(":", 1)[1].strip() if ":" in seg \
                        else "bf16"
                    if not payload:
                        raise ValueError(
                            f"empty payload dtype in spec {spec!r}; use "
                            "'/q' (= '/q:bf16') or '/q:<dtype>' with "
                            f"dtype in {PAYLOAD_MODES[1:]}"
                        )
                    overrides.setdefault("payload", payload)
                elif kind == "adapt":
                    policy = seg.split(":", 1)[1].strip() if ":" in seg \
                        else "rho"
                    if not policy:
                        raise ValueError(
                            f"empty adapt policy in spec {spec!r}; use "
                            "'/adapt' (= '/adapt:rho') or "
                            "'/adapt:<policy>'"
                        )
                    overrides.setdefault("adapt", policy)
                elif kind in EXCHANGES:
                    overrides.setdefault("exchange", seg)
                else:
                    choices = tuple(EXCHANGES) + ("fused", "q", "adapt", "trace")
                    raise ValueError(
                        f"unknown spec segment {seg!r} in {spec!r}: "
                        f"expected an exchange mode {EXCHANGES}, "
                        "'fused', 'q[:dtype]', 'adapt[:policy]' or "
                        f"'trace'{suggest(kind, choices)}"
                    )
            rest = head
        if ">" in rest or rest.lower().startswith("global:"):
            chunk = overrides.get("chunk_size", DEFAULT_CHUNK)
            return cls(
                hierarchy=Hierarchy.from_spec(rest, chunk_size=chunk),
                **overrides,
            )
        if "+" in rest:
            rest, variant = rest.split("+", 1)
            rest, variant = rest.strip(), variant.strip()
            if not variant:
                raise ValueError(f"empty variant segment in spec {spec!r}")
            overrides.setdefault("variant", variant)
        if not rest:
            raise ValueError(f"empty root segment in spec {spec!r}")
        return cls(root=rest, **overrides)

    @property
    def name(self) -> str:
        """Round-trippable spec: ``from_spec(cfg.name) == cfg``."""
        base = f"{self.hierarchy.name}/{self.exchange}"
        if self.relax_impl == "fused":
            base += "/fused"
        if self.payload != "exact":
            base += f"/q:{self.payload}"
        if self.adapt is not None:
            base += f"/adapt:{self.adapt}"
        if self.trace:
            base += "/trace"
        if self.partition != "block":
            base += f"@{self.partition}"
        return base

    def lint(
        self,
        *,
        shape: Optional[dict] = None,
        mesh_axes=("data",),
        processing: str = "sssp",
    ) -> list:
        """Parse-time cross-checks on this config (exchange ×
        frontier_cap × partitioner × hierarchy interactions); returns a
        list of ``repro_torch.analyze.findings.Finding``.  Pure spec
        arithmetic: runs nothing.  ``shape`` (optional, ``dict(n_local,
        rows, width, n_parts)``) enables the capacity rules; see
        ``repro_torch.analyze.spec_check``."""
        from repro_torch.analyze.spec_check import check_config

        return check_config(
            self, shape=shape, mesh_axes=mesh_axes, processing=processing
        )

    def engine_config(self, processing: ProcessingFn) -> EngineConfig:
        return EngineConfig(
            policy=self.hierarchy,
            processing=processing,
            exchange=self.exchange,
            max_iters=self.max_iters,
            collect_metrics=self.collect_metrics,
            frontier_cap=self.frontier_cap,
            relax_impl=self.relax_impl,
            payload=self.payload,
            adapt_window=(
                self.adapt_window
                if (self.adapt is not None or self.trace) else 0
            ),
        )


def as_config(c: Union[str, SolverConfig, None]) -> SolverConfig:
    if c is None:
        return SolverConfig()
    if isinstance(c, str):
        return SolverConfig.from_spec(c)
    if isinstance(c, SolverConfig):
        return c
    raise TypeError(f"cannot interpret {c!r} as a SolverConfig")
