"""Parse-time spec cross-checks + the collective-plan explainer (the
port's copy of the JAX package's ``analyze/spec_check.py``: the same
rules, findings and text for every spec).

``Hierarchy`` validates its own structure (root at GLOBAL, strict
nesting, TopK local-only) at construction; this module extends that
validation *across* the config: exchange mode × frontier_cap ×
partitioner × hierarchy interactions that are individually legal but
jointly useless or hazardous.  Pure spec arithmetic — nothing here
traces or compiles.

``explain_config`` prints the per-superstep collective plan a spec
implies (which collective realizes each annotation, what the exchange
moves, how many synchronization rounds a superstep costs) using the
same closed-form word counts the facade's exact byte accounting uses
(``api/solver.py::exchange_words``) — so ``launch/analyze --explain`` can
answer "what will this spec do on the wire" without building an
engine.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.analyze.findings import Finding
from repro_torch.api.config import SolverConfig, as_config
from repro_torch.core.eagm import LEVEL_SCOPE, LOCAL_LEVELS
from repro_torch.core.frontier import frontier_caps, payload_plane_words
from repro_torch.core.ordering import DeltaStepping, TopK

#: partitioners whose vertex->rank boundaries depend on the graph's
#: degree structure, so a streamed update can change the layout
GRAPH_DEPENDENT_PARTITIONERS = ("ebal", "degree")


def check_config(
    config: Union[str, SolverConfig],
    *,
    shape: Optional[dict] = None,
    mesh_axes: Sequence[str] = ("data",),
    processing: str = "sssp",
) -> list:
    """Cross-check one spec point; returns [Finding].

    ``shape`` (optional) is ``dict(n_local, rows, width, n_parts)`` —
    when given, capacity rules that need concrete sizes run too.
    ``mesh_axes`` are the launch mesh's axis names (pod-scope rules).
    """
    cfg = as_config(config)
    subject = cfg.name
    out: list = []
    hier = cfg.hierarchy
    sparse = cfg.exchange in ("sparse", "auto")

    if cfg.frontier_cap is not None and not sparse:
        out.append(Finding(
            "spec", "frontier-cap-dense", "warn", subject,
            f"frontier_cap={cfg.frontier_cap} has no effect with the "
            f"dense {cfg.exchange!r} exchange — set /sparse or /auto, "
            "or drop the cap",
        ))

    # kernel relax impls (pallas/fused) silently keep the 'ref' path in
    # configurations the kernel doesn't cover; for the fused kernel
    # that silent escape gets its own rule id so CI can gate on it
    kern = cfg.relax_impl != "ref"
    fused = cfg.relax_impl.startswith("fused")

    if kern and not sparse:
        out.append(Finding(
            "spec",
            "fused-kernel-escape" if fused else "relax-impl-dense",
            "warn", subject,
            f"relax_impl={cfg.relax_impl!r} only drives the sparse "
            f"push path; the dense {cfg.exchange!r} exchange never "
            "invokes it",
        ))

    if kern and processing != "sssp":
        out.append(Finding(
            "spec",
            "fused-kernel-escape" if fused else "relax-impl-processing",
            "warn", subject,
            f"relax_impl={cfg.relax_impl!r} is wired for min-plus "
            f"sssp only; processing {processing!r} silently falls "
            "back to 'ref'",
        ))

    if kern and hier.needs_level:
        out.append(Finding(
            "spec",
            "fused-kernel-escape" if fused else "relax-impl-kla",
            "warn", subject,
            f"relax_impl={cfg.relax_impl!r} does not carry the KLA "
            "level attribute; a level-bearing hierarchy "
            f"({hier.name}) silently falls back to 'ref'",
        ))

    if cfg.payload != "exact" and not sparse:
        out.append(Finding(
            "spec", "payload-quantized-dense", "warn", subject,
            f"payload={cfg.payload!r} only compresses the sparse "
            f"exchange; the dense {cfg.exchange!r} exchange moves "
            "exact f32 planes — /q buys nothing without /sparse or "
            "/auto",
        ))

    if cfg.payload != "exact":
        from repro_torch.api.problem import get_processing

        if not get_processing(processing).is_min:
            out.append(Finding(
                "spec", "payload-processing", "error", subject,
                f"quantized payload {cfg.payload!r} requires a "
                "min-reduce semiring (round-up errors must be "
                f"inflationary); processing {processing!r} is not — "
                "EngineConfig refuses this combination at build time",
            ))

    if hier.at("pod") is not None and "pod" not in mesh_axes:
        out.append(Finding(
            "spec", "pod-scope-flat-mesh", "info", subject,
            "hierarchy annotates the pod level but the mesh "
            f"{tuple(mesh_axes)} has no 'pod' axis — the pod scope "
            "spans every axis, i.e. it degenerates to a second "
            "global decision (more synchronization than the spec "
            "reads as)",
        ))

    chunk = hier.at("chunk")
    if (
        isinstance(chunk, TopK)
        and sparse
        and cfg.frontier_cap is not None
        and chunk.drain > cfg.frontier_cap
    ):
        out.append(Finding(
            "spec", "topk-exceeds-frontier-cap", "warn", subject,
            f"chunk drains top-{chunk.drain} but frontier_cap="
            f"{cfg.frontier_cap} < {chunk.drain} — every full drain "
            "overflows the sparse compaction and falls back dense, "
            "so the cap buys nothing",
        ))

    if cfg.partition in GRAPH_DEPENDENT_PARTITIONERS:
        out.append(Finding(
            "spec", "partition-layout-drift", "info", subject,
            f"partitioner {cfg.partition!r} derives rank boundaries "
            "from the degree structure; streamed graph updates can "
            "move them, and resolve() then refuses the warm restart "
            "(cold-solve fallback) — use 'block' for update-heavy "
            "serving",
        ))

    if cfg.adapt is not None:
        from repro_torch.tune.policies import policy_traits

        traits = policy_traits(cfg.adapt)
        root_delta = isinstance(hier.root, DeltaStepping)
        if sparse and not traits["grows_cap"]:
            out.append(Finding(
                "spec", "adapt-no-cap-growth", "warn", subject,
                f"adapt policy {cfg.adapt!r} never grows frontier_cap, "
                "so a sparse overflow falls back dense every superstep "
                "anyway — use '/adapt:rho' for rho-stepping cap growth "
                "or drop the controller",
            ))
        if not root_delta and not sparse:
            out.append(Finding(
                "spec", "adapt-nothing-to-tune", "warn", subject,
                f"nothing for the controller to tune: root "
                f"{hier.root.spec!r} has no delta bucket width and the "
                f"dense {cfg.exchange!r} exchange has no frontier_cap "
                "or sparse/dense choice — the /adapt segment only "
                "adds per-segment host synchronization",
            ))
        if isinstance(chunk, TopK):
            out.append(Finding(
                "spec", "adapt-topk-drain", "warn", subject,
                f"chunk top-{chunk.drain} drain already rate-limits "
                "per-superstep work device-locally; retuning delta "
                "around it shifts classes the drain then re-truncates "
                "— controller decisions will look ineffective",
            ))

    if cfg.trace:
        out.append(Finding(
            "spec", "trace-no-batch", "warn", subject,
            "/trace solves are unbatchable: the batched engine "
            "publishes no per-lane superstep windows, so "
            "solve_batch (and any Router flush of more than one "
            "distinct source) rejects this spec — trace queries one "
            "at a time, or drop /trace for serving",
        ))
        if cfg.adapt is not None:
            out.append(Finding(
                "spec", "trace-adapt-composition", "warn", subject,
                f"/trace composed with /adapt:{cfg.adapt}: one "
                "segmentation serves both (the recorder taps the "
                "controller's windows), but the flight record then "
                "reflects the RETUNED schedule — per-superstep rows/"
                "bytes will not match a static solve of this spec's "
                "tunables; trace without /adapt for the static record",
            ))
        if not cfg.collect_metrics:
            out.append(Finding(
                "spec", "trace-forces-metrics", "info", subject,
                "collect_metrics=False with /trace: the segment "
                "engine always collects per-superstep counters for "
                "the windows, so the traced WorkMetrics gains the "
                "work terms (and one collective round per superstep) "
                "an untraced collect_metrics=False solve omits — "
                "metrics bit-identity holds only with "
                "collect_metrics=True",
            ))

    if shape is not None:
        nl, R = int(shape["n_local"]), int(shape["rows"])
        W, Pn = int(shape["width"]), int(shape["n_parts"])
        use_level = hier.needs_level
        nplanes = 2 if use_level else 1
        if sparse:
            row_cap, slot_cap = frontier_caps(
                R, W, nl, Pn, cfg.frontier_cap
            )
            if cfg.frontier_cap is not None and cfg.frontier_cap > R:
                out.append(Finding(
                    "spec", "frontier-cap-exceeds-rows", "warn",
                    subject,
                    f"frontier_cap={cfg.frontier_cap} exceeds the "
                    f"{R} ELL rows per rank — clamped to {row_cap}; "
                    "the spec overstates its capacity",
                ))
            pwords = payload_plane_words(slot_cap, use_level, cfg.payload)
            if pwords >= nplanes * nl:
                out.append(Finding(
                    "spec", "sparse-cannot-pay", "info", subject,
                    f"at this shape the sparse payload "
                    f"({pwords} words/segment) never beats the "
                    f"dense reduce-scatter ({nplanes}x{nl} words) — "
                    "'auto' resolves dense at trace time; '/sparse' "
                    "pays the compaction for nothing",
                ))
    return out


def check_grid(
    specs: Sequence[str],
    *,
    shape: Optional[dict] = None,
    mesh_axes: Sequence[str] = ("data",),
) -> dict:
    """``check_config`` over many spec strings: {spec: [Finding]}."""
    return {
        s: check_config(s, shape=shape, mesh_axes=mesh_axes)
        for s in specs
    }


def explain_config(
    config: Union[str, SolverConfig],
    *,
    shape: Optional[dict] = None,
    mesh_axes: Sequence[str] = ("data",),
) -> str:
    """The collective plan a spec implies, one superstep at a time —
    no engine build, no compile."""
    cfg = as_config(config)
    hier = cfg.hierarchy
    use_level = hier.needs_level
    nplanes = 2 if use_level else 1
    lines = [f"spec {cfg.name!r} — per-superstep plan:"]

    lines.append("  ordering decisions (outermost first):")
    for lvl, o in hier.annotations:
        if lvl in LOCAL_LEVELS and isinstance(o, TopK):
            scope = f"device-local top-{o.drain} drain (no collective)"
        elif lvl in LOCAL_LEVELS:
            scope = "device-local minimal class (no collective)"
        elif lvl == "pod" and "pod" not in mesh_axes:
            scope = (f"{LEVEL_SCOPE[lvl]} — NOTE: mesh "
                     f"{tuple(mesh_axes)} has no pod axis, this spans "
                     "all ranks")
        else:
            scope = LEVEL_SCOPE[lvl]
        lines.append(f"    {lvl:7s} {o.spec:16s} {scope}")

    lines.append("  candidate exchange:")
    if shape is not None:
        nl, Pn = int(shape["n_local"]), int(shape["n_parts"])
        R, W = int(shape["rows"]), int(shape["width"])
        dense_words = (Pn - 1) * nl * nplanes
        if cfg.exchange == "pmin":
            lines.append(
                f"    pmin    dense all-reduce combine, "
                f"~{2 * dense_words} words/device/superstep "
                f"(2x the reduce-scatter)"
            )
        elif cfg.exchange == "a2a":
            lines.append(
                f"    a2a     all_to_all transpose + local combine, "
                f"{dense_words} words/device/superstep "
                f"({nplanes} plane{'s' if nplanes > 1 else ''})"
            )
        else:
            row_cap, slot_cap = frontier_caps(
                R, W, nl, Pn, cfg.frontier_cap
            )
            pwords = payload_plane_words(slot_cap, use_level, cfg.payload)
            sparse_words = (Pn - 1) * pwords
            enc = "(idx,val)" if cfg.payload == "exact" else (
                f"(u32 idx, {cfg.payload} Δ)"
            )
            lines.append(
                f"    {cfg.exchange:7s} {enc} all_to_all, "
                f"{sparse_words} words/device on sparse supersteps "
                f"(row_cap={row_cap}, slot_cap={slot_cap}, "
                f"{pwords} words/segment); dense fallback moves "
                f"{dense_words} words"
            )
            if cfg.payload != "exact":
                exact_words = (Pn - 1) * payload_plane_words(
                    slot_cap, use_level, "exact"
                )
                lines.append(
                    f"            quantized payload: {sparse_words} vs "
                    f"{exact_words} exact words — round-up-only codes, "
                    "final state repaired exact by the facade"
                )
            if pwords >= nplanes * nl:
                lines.append(
                    "            NOTE: sparse cannot pay at this "
                    "shape — resolves dense"
                )
    else:
        desc = {
            "pmin": "dense all-reduce combine (paper-faithful, 2x "
                    "reduce-scatter bytes)",
            "a2a": "all_to_all transpose + local combine "
                   "(min-reduce-scatter)",
            "sparse": "frontier-compacted (idx,val) all_to_all, dense "
                      "fallback on capacity overflow",
            "auto": "sparse while the carried pending count is small, "
                    "dense otherwise",
        }[cfg.exchange]
        lines.append(f"    {cfg.exchange:7s} {desc}")

    if cfg.adapt is not None:
        from repro_torch.tune.policies import policy_traits

        traits = policy_traits(cfg.adapt)
        knobs = [
            k for k, on in (
                ("delta", traits["retunes_delta"]
                 and isinstance(hier.root, DeltaStepping)),
                ("frontier_cap", traits["grows_cap"]
                 and cfg.exchange in ("sparse", "auto")),
                ("sparse/dense choice",
                 cfg.exchange in ("sparse", "auto")),
            ) if on
        ]
        lines.append(
            f"  controller: adapt:{cfg.adapt} every "
            f"{cfg.adapt_window} supersteps "
            f"(tunes {', '.join(knobs) if knobs else 'nothing'}; "
            "delta/exchange retunes are dynamic scalars, only a "
            "never-seen frontier_cap retraces)"
        )

    if cfg.trace:
        lines.append(
            f"  recorder: /trace runs {cfg.adapt_window}-superstep "
            "segments purely to publish per-superstep windows "
            "(pending/eligible/rows/bytes) — bit-identical state and "
            "metrics, SolveTrace on Solution.trace"
        )

    rounds = (3 if cfg.collect_metrics else 2) + (
        1 if cfg.exchange in ("sparse", "auto") else 0
    )
    pod_extra = sum(
        1 for lvl, _ in hier.annotations if lvl in ("pod",)
    )
    lines.append(
        f"  synchronization: {rounds + pod_extra} collective rounds "
        f"per superstep ({'with' if cfg.collect_metrics else 'without'}"
        " work metrics; termination psum included)"
    )
    lines.append(f"  partitioner: {cfg.partition} "
                 f"(relabeling only — no effect on the traced program)")
    return "\n".join(lines)
