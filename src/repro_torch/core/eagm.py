"""Extended AGM (paper §IV): spatial hierarchies with annotated
orderings.

:class:`Hierarchy` is an ordered list of ``(level, Ordering)``
annotations over ``LEVELS``, outermost first; the GLOBAL annotation is
the AGM root, and each further annotation refines eligibility within
the selection above it at its scope:

    global  min over every rank (the AGM root decision)
    pod     min over the ranks of one pod: the ranks that share an index
            on the mesh's ``pod`` axis (``launch/mesh.py::RankMesh``);
            every rank on a mesh without one
    device  rank-local reduction
    chunk   rank-local; a TopK annotation drains the B smallest items

The paper's variants are presets: ``buffer`` (root only), ``nodeq``
(Dijkstra at POD), ``numaq`` (Dijkstra at DEVICE) and ``threadq``
(TopK(B) at CHUNK).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.ordering import (
    Dijkstra,
    Ordering,
    TopK,
    make_ordering,
    needs_level,
    suggest,
)

# spatial levels, outermost to innermost
LEVELS = ("global", "pod", "device", "chunk")

#: levels whose decision is rank-local (no cross-rank reduction)
LOCAL_LEVELS = ("device", "chunk")

# paper variant name -> spatial level carrying the sub-root annotation
VARIANT_LEVEL = {
    "buffer": None,
    "nodeq": "pod",
    "numaq": "device",
    "threadq": "chunk",
}

DEFAULT_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """An EAGM: ``(level, Ordering)`` annotations, GLOBAL first.

    Validation enforces the EAGM extension condition's structural form:
    one GLOBAL annotation in first position, levels strictly outermost
    → innermost, TopK only at the local levels.
    """

    annotations: Tuple[Tuple[str, Ordering], ...]

    def __post_init__(self):
        annos = tuple(
            (lvl, o) if not isinstance(o, str) else (lvl, make_ordering(o))
            for lvl, o in self.annotations
        )
        object.__setattr__(self, "annotations", annos)
        if not annos:
            raise ValueError("Hierarchy needs at least the root annotation")
        for lvl, o in annos:
            if lvl not in LEVELS:
                raise ValueError(
                    f"bad spatial level {lvl!r} — must be one of "
                    f"{list(LEVELS)}{suggest(str(lvl), LEVELS)}"
                )
        if annos[0][0] != "global":
            raise ValueError(
                "the first annotation must sit at the 'global' level — it "
                "is the AGM root ordering whose equivalence classes the "
                f"EAGM must preserve (got {annos[0][0]!r})"
            )
        order = [LEVELS.index(lvl) for lvl, _ in annos]
        if any(b <= a for a, b in zip(order, order[1:])):
            raise ValueError(
                "annotations must nest one per level, outermost to "
                f"innermost {list(LEVELS)}; got levels "
                f"{[lvl for lvl, _ in annos]}"
            )
        for lvl, o in annos:
            if isinstance(o, TopK) and lvl not in LOCAL_LEVELS:
                raise ValueError(
                    f"TopK is a device-local drain and cannot annotate "
                    f"{lvl!r} — use it at one of {list(LOCAL_LEVELS)}, or "
                    "annotate this level with a class ordering"
                )

    @property
    def root(self) -> Ordering:
        return self.annotations[0][1]

    @property
    def sub(self) -> Tuple[Tuple[str, Ordering], ...]:
        return self.annotations[1:]

    @property
    def needs_level(self) -> bool:
        """True iff any annotation reads the KLA level attribute."""
        return any(needs_level(o) for _, o in self.annotations)

    def at(self, level: str) -> Optional[Ordering]:
        for lvl, o in self.annotations:
            if lvl == level:
                return o
        return None

    @classmethod
    def from_spec(
        cls, spec: str, chunk_size: int = DEFAULT_CHUNK
    ) -> "Hierarchy":
        """Parse ``>``-separated annotations, outermost first
        (``"delta:5 > pod:dijkstra > chunk:delta:1"``); the legacy
        ``root+variant`` preset form is also accepted.  ``chunk_size``
        is B for a bare ``chunk:topk``."""
        s = str(spec).strip()
        if "+" in s and ">" not in s:
            root, variant = s.split("+", 1)
            root, variant = root.strip(), variant.strip()
            if not root or not variant:
                raise ValueError(
                    f"empty {'variant' if root else 'root'} segment in "
                    f"spec {spec!r}"
                )
            return make_hierarchy(root, variant, chunk_size)
        segments = [seg.strip() for seg in str(spec).split(">")]
        if any(not seg for seg in segments):
            raise ValueError(
                f"empty annotation segment in hierarchy spec {spec!r}"
            )
        annos = []
        for i, seg in enumerate(segments):
            head = seg.split(":", 1)[0].strip().lower()
            if head in LEVELS:
                if ":" not in seg:
                    raise ValueError(
                        f"annotation {seg!r} in {spec!r} names level "
                        f"{head!r} but no ordering (expected "
                        "'level:ordering')"
                    )
                lvl, rest = seg.split(":", 1)
                lvl, rest = lvl.strip().lower(), rest.strip()
            elif i == 0:
                lvl, rest = "global", seg
            else:
                raise ValueError(
                    f"annotation {seg!r} in hierarchy spec {spec!r} must "
                    f"be 'level:ordering' with level in {list(LEVELS)}"
                    f"{suggest(head, LEVELS)}"
                )
            ordering = (
                TopK(chunk_size) if rest.lower() == "topk"
                else make_ordering(rest)
            )
            annos.append((lvl, ordering))
        return cls(tuple(annos))

    @property
    def spec(self) -> str:
        """Canonical grammar-v2 string; ``from_spec(h.spec) == h``."""
        parts = [self.root.spec]
        parts += [f"{lvl}:{o.spec}" for lvl, o in self.sub]
        return " > ".join(parts)

    @property
    def variant(self) -> Optional[str]:
        """The paper preset this hierarchy realizes, or None."""
        for variant in VARIANT_LEVEL:
            if self == make_hierarchy(self.root, variant,
                                      chunk_size=self._preset_chunk()):
                return variant
        return None

    def _preset_chunk(self) -> int:
        o = self.at("chunk")
        return o.drain if isinstance(o, TopK) else DEFAULT_CHUNK

    @property
    def name(self) -> str:
        v = self.variant
        if v is not None and self._preset_chunk() == DEFAULT_CHUNK:
            return f"{self.root.spec}+{v}"
        return self.spec


def make_hierarchy(
    root: Union[str, Ordering],
    variant: str = "buffer",
    chunk_size: int = DEFAULT_CHUNK,
) -> Hierarchy:
    """The paper's Fig. 4 presets: ``make_hierarchy('delta:5', 'threadq')``."""
    if variant not in VARIANT_LEVEL:
        raise ValueError(
            f"variant must be one of {sorted(VARIANT_LEVEL)}, got "
            f"{variant!r}{suggest(str(variant), VARIANT_LEVEL)}"
        )
    if isinstance(root, str):
        root = make_ordering(root)
    annos = [("global", root)]
    lvl = VARIANT_LEVEL[variant]
    if lvl == "chunk":
        annos.append(("chunk", TopK(chunk_size)))
    elif lvl is not None:
        annos.append((lvl, Dijkstra()))
    return Hierarchy(tuple(annos))


def as_hierarchy(h) -> Hierarchy:
    """Coerce a Hierarchy | spec string."""
    if isinstance(h, Hierarchy):
        return h
    if isinstance(h, str):
        return Hierarchy.from_spec(h)
    raise TypeError(f"cannot interpret {h!r} as a Hierarchy")


def paper_variant_specs(deltas=(3.0, 5.0, 7.0), ks=(1, 2, 3)) -> list:
    """The paper's evaluation grid as ``root+variant`` spec strings:
    {Δ-stepping, KLA, Chaotic} × {buffer, threadq, nodeq, numaq}
    (Figures 5-7), plus the Dijkstra AGM baseline."""
    roots = (
        [f"delta:{d:g}" for d in deltas]
        + [f"kla:{k}" for k in ks]
        + ["chaotic"]
    )
    specs = [
        f"{root}+{variant}"
        for root in roots
        for variant in ("buffer", "threadq", "nodeq", "numaq")
    ]
    specs.append("dijkstra+buffer")
    return specs
