"""Self-stabilization contract verifier for processing functions.

The engine's correctness argument (paper §II-III) needs the processing
function to be a *self-stabilizing kernel*: the per-vertex combine
must be an idempotent, commutative, selective reduction whose order
agrees with ``better``; relaxation must be inflationary (a candidate
never improves on the state that generated it — min-plus semiring
non-negativity) and monotone; ``worst`` must be the top element (the
reduce identity); and a source's initial value must strictly improve
``worst`` (else the source never becomes pending).  Any function
satisfying these laws can be wrapped by ANY ordering hierarchy and
still converge to the same fixpoint — that is the family theorem this
verifier machine-checks.

Two mechanisms, per Devismes et al.'s observation that stabilization
properties are precise, checkable predicates:

* **Exhaustive small-domain evaluation** — the laws are universally
  quantified over states × weights; we evaluate them over the closure
  of the function's own reachable states (source values + worst,
  closed under ``edge_update``/``reduce`` to depth 2) so there are no
  vacuous passes and no false positives from unreachable states.
  Laws are evaluated on f32 torch scalars.  Violations carry the
  witness input.
* **Inspection by op recording** — ``edge_update``/``better``/``reduce``
  run on f32 scalar tensors under the port's op recorder
  (``roofline/ops.py``: a ``TorchDispatchMode`` beside a
  ``TorchFunctionMode``), the counterpart of the JAX package's jaxpr
  inspection, and are checked for float64 results (``trace-f64``), host
  reads or writes into an input (``trace-impure``) and failing on f32
  tensors (``trace-fails``) — hazards evaluation can't see.

``verify_registered`` enumerates :func:`repro_torch.api.problem
.registered_processing` — the registration seam every new family
member passes through, so the gate checks them all.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analyze.findings import Finding
from repro_torch.core.processing import ProcessingFn
from repro_torch.roofline.ops import OpRecorder

#: edge weights the laws are quantified over: the min-plus semiring
#: assumes non-negative weights; +inf is the ELL padding weight every
#: real relaxation sweep feeds through ``edge_update``.
DEFAULT_WEIGHTS = (0.0, 0.25, 1.0, 3.0, float("inf"))

#: sample source vertices for ``initial_value``
SAMPLE_VERTICES = (0, 1, 5)

@dataclasses.dataclass(frozen=True)
class ContractViolation:
    """One broken law, with the witness input that exhibits it."""

    processing: str
    law: str
    witness: tuple
    detail: str

    def __str__(self) -> str:
        return (
            f"{self.processing}: law {self.law!r} violated at witness "
            f"{self.witness}: {self.detail}"
        )

    def to_finding(self) -> Finding:
        return Finding(
            pass_name="contract",
            rule=self.law,
            severity="error",
            subject=self.processing,
            message=self.detail,
            witness=repr(self.witness),
        )


def _f32(x: float) -> np.float32:
    return np.float32(x)


def _t32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _eval(fn, *args) -> float:
    """Evaluate a torch scalar callable on f32 scalar tensors."""
    out = fn(*(_t32(a) for a in args))
    return float(out)


def _better(p: ProcessingFn, a: float, b: float) -> bool:
    return bool(p.better(_t32(a), _t32(b)))


def _reduce2(p: ProcessingFn, a: float, b: float) -> float:
    return _eval(p.reduce, a, b)


def _reduce_array2(p: ProcessingFn, a: float, b: float) -> float:
    out = p.reduce_array(torch.tensor([a, b], dtype=torch.float32), 0)
    return float(out)


def reachable_domain(
    p: ProcessingFn,
    weights: Sequence[float] = DEFAULT_WEIGHTS,
    depth: int = 2,
    cap: int = 48,
) -> tuple:
    """States the laws are quantified over: the function's own source
    values and ``worst``, closed under ``edge_update`` (all weights)
    and pairwise ``reduce`` to ``depth``.  Quantifying over *reachable*
    states keeps the check sound without false alarms on states the
    engine can never hold."""
    dom = {float(_f32(p.worst))}
    for v in SAMPLE_VERTICES:
        dom.add(float(_f32(p.initial_value(v))))
    for _ in range(depth):
        new = set()
        for s in dom:
            for w in weights:
                c = _eval(p.edge_update, s, w)
                if not np.isnan(c):
                    new.add(float(_f32(c)))
        for a, b in itertools.combinations(sorted(dom), 2):
            new.add(float(_f32(_reduce2(p, a, b))))
        dom |= new
        if len(dom) > cap:
            break
    # keep the domain small enough that O(n^3) transitivity stays cheap
    return tuple(sorted(dom, key=lambda x: (np.isnan(x), x))[:cap])


# --------------------------------------------------------------------
# the laws
# --------------------------------------------------------------------


def _check_order_laws(p: ProcessingFn, dom, out: list) -> None:
    """``better`` must be a strict order (irreflexive, asymmetric,
    transitive) — otherwise 'pending' is not well-defined."""
    for a in dom:
        if _better(p, a, a):
            out.append(ContractViolation(
                p.name, "better-irreflexive", (a,),
                f"better({a}, {a}) is True — a state must not strictly "
                "improve itself (pending detection would never drain)",
            ))
    for a, b in itertools.permutations(dom, 2):
        if _better(p, a, b) and _better(p, b, a):
            out.append(ContractViolation(
                p.name, "better-asymmetric", (a, b),
                f"better({a}, {b}) and better({b}, {a}) both hold — "
                "the state order is not antisymmetric",
            ))
    for a, b, c in itertools.permutations(dom, 3):
        if (_better(p, a, b) and _better(p, b, c)
                and not _better(p, a, c)):
            out.append(ContractViolation(
                p.name, "better-transitive", (a, b, c),
                f"better({a},{b}) and better({b},{c}) but not "
                f"better({a},{c})",
            ))


def _check_reduce_laws(p: ProcessingFn, dom, out: list) -> None:
    """The combine must be an idempotent commutative selection that
    agrees with ``better`` — the algebraic core that makes the
    scatter-combine atomic-free and the kernel self-stabilizing."""
    for a in dom:
        r = _reduce2(p, a, a)
        if r != a and not (np.isnan(r) and np.isnan(a)):
            out.append(ContractViolation(
                p.name, "reduce-idempotent", (a,),
                f"reduce({a}, {a}) = {r} != {a} — re-delivering a "
                "duplicate workitem changes state, so the lock-free "
                "exchange is unsafe",
            ))
    for a, b in itertools.combinations(dom, 2):
        ab, ba = _reduce2(p, a, b), _reduce2(p, b, a)
        if ab != ba and not (np.isnan(ab) and np.isnan(ba)):
            out.append(ContractViolation(
                p.name, "reduce-commutative", (a, b),
                f"reduce({a},{b}) = {ab} but reduce({b},{a}) = {ba} — "
                "arrival order would change the result",
            ))
        if ab not in (a, b) and not np.isnan(ab):
            out.append(ContractViolation(
                p.name, "reduce-selective", (a, b),
                f"reduce({a},{b}) = {ab}, which is neither input — the "
                "combine must select, not mix (mixing breaks the "
                "monotone convergence argument)",
            ))
        else:
            want = a if _better(p, a, b) else b
            if ab != want:
                out.append(ContractViolation(
                    p.name, "reduce-monotone", (a, b),
                    f"reduce({a},{b}) = {ab} but better() says {want} "
                    "wins — the combine is not monotone non-increasing "
                    "w.r.t. the state order",
                ))
    for a, b, c in itertools.combinations(dom, 3):
        lhs = _reduce2(p, a, _reduce2(p, b, c))
        rhs = _reduce2(p, _reduce2(p, a, b), c)
        if lhs != rhs and not (np.isnan(lhs) and np.isnan(rhs)):
            out.append(ContractViolation(
                p.name, "reduce-associative", (a, b, c),
                f"reduce is not associative: {lhs} != {rhs} — "
                "pre-combining per pod/rank would change the result",
            ))
    # reduce_array (the engine's vectorized path) must agree with the
    # pairwise reduce — ProcessingFn.reduce_array dispatches on
    # `reduce is torch.minimum`, so a custom reduce silently gets max
    for a, b in itertools.combinations(dom, 2):
        arr, red = _reduce_array2(p, a, b), _reduce2(p, a, b)
        if arr != red and not (np.isnan(arr) and np.isnan(red)):
            out.append(ContractViolation(
                p.name, "reduce-array-consistent", (a, b),
                f"reduce_array([{a},{b}]) = {arr} but reduce({a},{b}) "
                f"= {red} — the dense sweep and the exchange combine "
                "disagree",
            ))
            break  # one witness suffices; this repeats for every pair


def _check_top_laws(p: ProcessingFn, dom, out: list) -> None:
    """``worst`` must be the reduce identity and the top of the state
    order — it is the 'no candidate' element every buffer is filled
    with."""
    worst = float(_f32(p.worst))
    for a in dom:
        r = _reduce2(p, a, worst)
        if r != a and not (np.isnan(r) and np.isnan(a)):
            out.append(ContractViolation(
                p.name, "worst-identity", (a,),
                f"reduce({a}, worst={worst}) = {r} != {a} — worst is "
                "not the reduce identity, so padded slots corrupt "
                "real candidates",
            ))
        if _better(p, worst, a):
            out.append(ContractViolation(
                p.name, "worst-top", (a,),
                f"better(worst={worst}, {a}) — worst must be the top "
                "element (no state is improved by 'no candidate')",
            ))


def _check_relax_laws(
    p: ProcessingFn, dom, weights, out: list
) -> None:
    """Relaxation must be inflationary (a candidate never improves on
    its source state — min-plus non-negativity) and monotone in the
    source state; together with the reduce laws this is exactly what
    makes the chaotic fixpoint order-independent."""
    for s in dom:
        for w in weights:
            c = _eval(p.edge_update, s, w)
            if np.isnan(c):
                continue
            if _better(p, c, s):
                out.append(ContractViolation(
                    p.name, "relax-inflationary", (s, w),
                    f"edge_update({s}, {w}) = {c} strictly improves "
                    "its own source state — relaxation must be "
                    "inflationary under the min-plus semiring or the "
                    "fixpoint is unbounded",
                ))
    for s1, s2 in itertools.permutations(dom, 2):
        if not _better(p, s1, s2):
            continue
        for w in weights:
            c1 = _eval(p.edge_update, s1, w)
            c2 = _eval(p.edge_update, s2, w)
            if np.isnan(c1) or np.isnan(c2):
                continue
            if _better(p, c2, c1):
                out.append(ContractViolation(
                    p.name, "relax-monotone", (s1, s2, w),
                    f"better({s1},{s2}) but edge_update({s2},{w})={c2} "
                    f"improves edge_update({s1},{w})={c1} — a worse "
                    "source must not generate a better candidate "
                    "(monotonicity of the kernel)",
                ))


def _check_source_laws(p: ProcessingFn, out: list) -> None:
    worst = float(_f32(p.worst))
    for v in SAMPLE_VERTICES:
        init = float(_f32(p.initial_value(v)))
        if init != worst and not _better(p, init, worst):
            out.append(ContractViolation(
                p.name, "source-init-improving", (v, init),
                f"initial_value({v}) = {init} does not improve "
                f"worst = {worst} — the source would never become "
                "pending and the solve would return immediately",
            ))


def _check_trace_laws(p: ProcessingFn, out: list) -> None:
    """Inspection by op recording: run the three callables on f32 scalar
    tensors under the op recorder and flag float64 results, host reads
    and writes into an input — hazards that concrete evaluation at f32
    can't exhibit."""
    calls = {
        "edge_update": p.edge_update,
        "better": p.better,
        "reduce": p.reduce,
    }
    for name, fn in calls.items():
        args = (_t32(1.0), _t32(2.0))
        ptrs = {a.untyped_storage().data_ptr() for a in args}
        try:
            with OpRecorder() as rec:
                fn(*args)
        except Exception as e:  # noqa: BLE001 — diagnostic, not control
            out.append(ContractViolation(
                p.name, "trace-fails", (name,),
                f"{name} does not run on f32 scalar tensors: {e}",
            ))
            continue
        if rec.host_reads:
            out.append(ContractViolation(
                p.name, "trace-impure", (name,),
                f"{name} reads a value back to the host "
                f"({rec.host_reads[0]!r}) — processing functions must be "
                "pure device code (a host read in the hot loop serializes "
                "every superstep on the host)",
            ))
        elif rec.writes & ptrs:
            out.append(ContractViolation(
                p.name, "trace-impure", (name,),
                f"{name} writes into its input — processing functions "
                "must be pure (the engine reuses its state tensors)",
            ))
        for r in rec.records:
            wide = [dt for dt in r.out_dtypes if dt == torch.float64]
            if wide:
                out.append(ContractViolation(
                    p.name, "trace-f64", (name,),
                    f"{name} promotes f32 inputs to {wide[0]} (via "
                    f"{r.op}) — a float64 constant is widening the state "
                    "dtype; the engine state is f32",
                ))
                break


# --------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------


def verify_processing(
    p: ProcessingFn,
    weights: Sequence[float] = DEFAULT_WEIGHTS,
    max_violations: int = 64,
) -> list:
    """Check every contract law; returns [ContractViolation] (empty =
    the function is a self-stabilizing kernel on its reachable
    domain)."""
    out: list = []
    dom = reachable_domain(p, weights)
    _check_order_laws(p, dom, out)
    _check_reduce_laws(p, dom, out)
    _check_top_laws(p, dom, out)
    _check_relax_laws(p, dom, weights, out)
    _check_source_laws(p, out)
    _check_trace_laws(p, out)
    # a broken law tends to fire on many witnesses; keep a few per law
    # (diagnostics want one, tests may want corroboration) and cap the
    # total
    per_law: dict = {}
    seen: set = set()
    uniq: list = []
    for v in out:
        k = (v.law, v.witness)
        if k in seen or per_law.get(v.law, 0) >= 3:
            continue
        seen.add(k)
        per_law[v.law] = per_law.get(v.law, 0) + 1
        uniq.append(v)
        if len(uniq) >= max_violations:
            break
    return uniq


def verify_registered(
    weights: Sequence[float] = DEFAULT_WEIGHTS,
    registry: Optional[Iterable[ProcessingFn]] = None,
) -> dict:
    """Verify every registered processing function (the
    ``register_processing`` seam); returns {name: [violations]}."""
    if registry is None:
        from repro_torch.api.problem import registered_processing

        fns: Iterable[ProcessingFn] = registered_processing().values()
    else:
        fns = registry
    return {p.name: verify_processing(p, weights) for p in fns}


def contract_findings(results: dict) -> list:
    """Flatten ``verify_registered`` output into Findings."""
    return [
        v.to_finding() for vs in results.values() for v in vs
    ]
